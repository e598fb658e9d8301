"""Accounting of a sharded step's collective traffic (port of
``tpufluid.parallel.comm_audit``).

The JAX package reads the collectives out of the step's jaxpr. The port's
mesh (``parallel.shard.Mesh``) notes each collective it makes while a
recording is open, once per call with its per-shard operand, as a jaxpr
holds it; ``audit_step`` runs one step under a recording. A step that
replays a CUDA graph notes again what its capture noted
(``graphs.Graph``), so a replay audits as the eager step. The
far-mover packet is noted as conditional on every step, whether its gate
opens or not, as JAX counts the ``lax.cond`` branch it traced.

This pins the per-step traffic of the row-band design
(``resident_comm_formula``) to the code: a change that adds traffic
fails the test that holds the audit to the formula.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CollectiveOp:
    primitive: str
    shape: tuple
    dtype: str
    nbytes: int
    conditional: bool  # gated (may not run every step): the far packet


def audit_step(fn, *example_args) -> dict:
    """Run the sharded step ``fn`` (of ``make_sharded_resident_step``) once
    on ``example_args`` and account its collectives.

    Returns a dict with:
      ppermute_bytes_total        sum over all unconditional ppermutes
      ppermute_bytes_per_dir      total / 2 (each boundary exchange is a
                                  matched pair of shifts, one each way)
      ppermute_bytes_conditional  gated ppermutes (none in this design)
      all_gather_bytes_conditional  far-mover packets (gated)
      all_gather_bytes_unconditional
      psum_scalars                number of unconditional psum operands
      ops                         the raw CollectiveOp list

    ``fn`` must run exactly one step: a collective made once per step of
    a loop would be counted once per trip, so more or fewer steps raise.
    """
    mesh = getattr(fn, "mesh", None)
    if mesh is None:
        raise ValueError("audit_step needs a sharded step (its .mesh notes "
                         "the transfers)")
    with mesh.recording() as rec:
        fn(*example_args)
    if rec.steps != 1:
        raise ValueError(f"audit_step only supports single-step functions: "
                         f"the call ran {rec.steps} steps")
    ops = rec.ops
    pp = [o for o in ops if o.primitive == "ppermute" and not o.conditional]
    pp_cond = [o for o in ops if o.primitive == "ppermute" and o.conditional]
    ag = [o for o in ops if o.primitive == "all_gather"]
    psums = [o for o in ops if o.primitive == "psum" and not o.conditional]
    total = sum(o.nbytes for o in pp)
    return dict(
        ppermute_bytes_total=total,
        ppermute_bytes_per_dir=total // 2,
        ppermute_bytes_conditional=sum(o.nbytes for o in pp_cond),
        all_gather_bytes_conditional=sum(
            o.nbytes for o in ag if o.conditional),
        all_gather_bytes_unconditional=sum(
            o.nbytes for o in ag if not o.conditional),
        psum_scalars=len(psums),
        ops=ops,
    )


def resident_comm_formula(spec) -> dict:
    """The documented per-direction volume of the row-band resident step
    (``shard.py`` phases 2 and 4): one packed boundary row plus a two-row
    (pos, vel) halo, 3 rows x 4 f32 fields of [K, Gxp], plus the i32[Gxp]
    boundary cell-count row and the i32[2] halo occupancy."""
    from ..ops import resident as residentops
    k = spec.settings.cell_capacity
    gxp = residentops._gxp(spec.settings)
    field_row = k * gxp * 4
    return dict(
        payload_bytes_per_dir=3 * 4 * field_row,
        occupancy_bytes_per_dir=gxp * 4 + 2 * 4,
        bytes_per_dir=3 * 4 * field_row + gxp * 4 + 2 * 4,
        far_packet_bytes=spec.far_capacity * 5 * 4,
    )
