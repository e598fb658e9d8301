"""PyTorch port, the row-band sharded step's far-mover pass without its
host gate, and the sharded steps' one-program form, on the CPU.

On a CUDA device the port's row-band step launches its far-mover pass
(csrc/far_sharded.cu: a collect per band, the packets' all_gather, an
insert per band) every step, and the kernels read the gate, the psum of
the bands' far-mover counts, on the device; the JAX step branches on it
with ``lax.cond``. That rests on three facts held here:

* the pass run whatever the count (its plain version: what
  ``make_sharded_resident_step`` runs on the CPU) gives the JAX step's
  result, synced one step against ``tpufluid.parallel.shard``'s on the
  conftest mesh: the slot layout, ``occ_row``, ``lost``, ``tick`` and
  ``n_valid`` bitwise, positions and velocities within BASELINE.md's
  per-step bounds (|dpos| <= 4.8e-7, |dvel| <= 3.8e-5, relative where the
  value exceeds 1); and bitwise the step that skips the pass when the
  count read on the host is 0 (``make_plain_sharded_resident_step``);
* the band's rebin (with its row shift) counts, row by row, exactly the
  slots the collect selects: the kernel's packet offsets are its prefix
  sums;
* the post-merge ``occ_row`` is its band's ``occ_row_of``, merged edge
  rows included, so the kernel raising it to each inserted slot + 1 gives
  the plain version's ``occ_row_of`` of the result.

The one-program form (a CUDA graph a call) is held to the eager step on
the card; here its plumbing (static copies in, clones out, the mesh's
notes per replay, a swapped field) runs with a stand-in graph that
re-runs the captured Python on replay.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.ops import resident as jresident
from tpufluid.parallel import shard as jshard
from tpufluid.state import ParticleState as JParticleState

import tpufluid_torch as tt
from tpufluid_torch import graphs, interop
from tpufluid_torch.ops import far_sharded, resident
from tpufluid_torch.ops.fused import SENTINEL_HALF
from tpufluid_torch.parallel import (
    build_resident_spec, build_shard_spec, comm_audit, init_sharded,
    make_eager_sharded_resident_step, make_eager_sharded_step, make_mesh,
    make_plain_sharded_resident_step, make_resident_mesh,
    make_sharded_resident_step, make_sharded_step, shard,
    shard_grid_state, unshard_grid_state)

from graph_stand_in import stand_in_graphs  # noqa: F401 (a fixture)
from test_torch_shard_jax import (
    POS_TOL, VEL_TOL, _far_mover_scene, _jax_sharded, _settings, _within)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
GRID_FIELDS = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick", "lost")


def _scene(name):
    """64 particles (``_far_mover_scene``): "movers" as it is (two far
    movers, one across several bands); "none" with the two at cloud
    speed (no slot moves more than a cell); "over" with twelve floor
    particles flung up eight cells in band 0, past a far capacity of 8."""
    pos, vel = _far_mover_scene()
    if name == "none":
        vel[:2] = (0.0, 1.0)
    if name == "over":
        vel[2:14] = (0.0, 200.0)
    return pos, vel


def _grid(name, s):
    pos, vel = _scene(name)
    st = tt.init_state(s, CPU)
    st = dataclasses.replace(st, position=torch.from_numpy(pos),
                             predicted=torch.from_numpy(pos),
                             velocity=torch.from_numpy(vel))
    return resident.from_particles(st, s)


@pytest.mark.parametrize("d,name", [(2, "none"), (2, "movers"),
                                    (8, "movers"), (2, "over")])
def test_ungated_far_pass_step_matches_jax(d, name):
    """One synced step of the step driven by the ungated far pass against
    JAX's sharded step, and bitwise against the host-gated plain step."""
    ts = _settings(n=64)
    js = tpufluid.SimSettings(**dataclasses.asdict(ts))
    pos, vel = _scene(name)
    jpos, jvel = jnp.asarray(pos), jnp.asarray(vel)
    jstate = JParticleState(
        position=jpos, predicted=jpos, velocity=jvel, density=jnp.ones(64),
        cell=jnp.zeros(64, jnp.uint32), tick=jnp.zeros((), jnp.uint32))
    cap = 8 if name == "over" else None
    jspec = jshard.build_resident_spec(js, d, far_capacity=cap)
    jmesh = jshard.make_resident_mesh(jspec)
    jgs = _jax_sharded(jresident.from_particles(jstate, js), jspec, jmesh)
    jp = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    jout, jstats = jshard.make_sharded_resident_step(jspec, mesh=jmesh)(
        jgs, jp)

    spec = build_resident_spec(ts, d, far_capacity=cap)
    mesh = make_resident_mesh(spec, [CPU] * d)
    tgs = shard_grid_state(interop.grid_state_from_numpy(jgs, CPU), spec,
                           mesh)
    tp = interop.tick_params_from_numpy(jp, CPU)
    tout, tstats = make_sharded_resident_step(spec, mesh)(tgs, tp)
    pout, pstats = make_plain_sharded_resident_step(spec, mesh)(tgs, tp)
    got, plain = unshard_grid_state(tout), unshard_grid_state(pout)
    for f in GRID_FIELDS:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
    assert torch.equal(tstats["n_valid"], pstats["n_valid"])

    assert (_stages(spec, mesh, tgs, tp)[4] == 0) == (name == "none")
    np.testing.assert_array_equal(tstats["n_valid"].numpy(),
                                  np.asarray(jstats["n_valid"]))
    assert int(tout.lost) == int(jout.lost)
    assert (int(tout.lost) > 0) == (name == "over")
    assert int(tout.tick) == int(jout.tick)
    np.testing.assert_array_equal(got.occ_row.numpy(),
                                  np.asarray(jout.occ_row))
    live = np.asarray(jout.pos_x) < float(SENTINEL_HALF)
    np.testing.assert_array_equal(got.pos_x.numpy() < SENTINEL_HALF, live)
    for f, bound in (("pos_x", POS_TOL), ("pos_y", POS_TOL),
                     ("vel_x", VEL_TOL), ("vel_y", VEL_TOL)):
        _within(getattr(got, f).numpy(), np.asarray(getattr(jout, f)),
                bound, live, f)


def _stages(spec, mesh, sgs, params):
    """The row-band step's stages 1-3 on the CPU: the rebins, the
    post-merge bands, the psum'd far count, the packets and the bands
    after the far pass's plain version."""
    shifts = shard.band_shifts(spec, mesh)
    dts = [params.delta] * spec.n_devices
    reb, band4, occ_band, n_lost = shard.rebin_and_merge(
        mesh, sgs.bands, dts, shifts, spec.settings)
    total = sum(int(r[5].sum()) for r in reb)
    rloc = spec.rows_per_dev
    packed = [far_sharded.far_collect(
        b.pos_x, b.pos_y, b.vel_x, b.vel_y, b.occ_row, reb[d][5][1:rloc + 1],
        torch.tensor([total], dtype=torch.int32), params.delta,
        spec.settings, d * rloc, spec.far_capacity)
        for d, b in enumerate(sgs.bands)]
    allp = torch.cat([p for p, _ in packed])
    after = [far_sharded.far_insert(
        band4[d], occ_band[d], n_lost[d], allp,
        torch.tensor([total], dtype=torch.int32), packed[d][1],
        params.delta, spec.settings, d * rloc)
        for d in range(spec.n_devices)]
    return reb, band4, occ_band, n_lost, total, packed, after


@pytest.mark.parametrize("d", [2, 4, 8])
def test_band_rebin_far_count_is_the_collect_predicate(d):
    """Over three steps of the 2,048-particle scene with seeded fast
    movers (crossing bands) and one with none, every band's rebin counts
    per row exactly the slots the collect selects (``far_mask``), its pad
    rows none; the packet holds them in flat slot order, the rest zero."""
    s = _settings(n=2048)
    spec = build_resident_spec(s, d)
    mesh = make_resident_mesh(spec, [CPU] * d)
    params = tt.TickParams.default(CPU, gravity=(0.0, -9.8))
    step = make_sharded_resident_step(spec, mesh)
    st = tt.init_state(s, CPU)
    g = torch.Generator().manual_seed(13)
    vel = torch.randn(st.velocity.shape, generator=g) * 2.0
    vel[::61] *= 80.0
    st = dataclasses.replace(st, velocity=vel)
    seen = 0
    for moving in (False, True):
        sgs = shard_grid_state(
            resident.from_particles(st if moving else tt.init_state(s, CPU),
                                    s), spec, mesh)
        for _ in range(3):
            reb, _, _, _, total, packed, _ = _stages(spec, mesh, sgs, params)
            for b, (band, r, (packet, pk_drop)) in enumerate(
                    zip(sgs.bands, reb, packed)):
                rloc = spec.rows_per_dev
                far = far_sharded.far_mask(
                    band.pos_x, band.pos_y, band.vel_x, band.vel_y,
                    params.delta, s, b * rloc)
                assert torch.equal(far.sum(dim=(1, 2)).to(torch.int32),
                                   r[5][1:rloc + 1])
                assert int(r[5][0]) == int(r[5][rloc + 1]) == 0
                n = int(far.sum())
                want = torch.stack([band.pos_x[far], band.pos_y[far],
                                    band.vel_x[far], band.vel_y[far]], 1)
                m = min(n, spec.far_capacity)
                assert torch.equal(packet[:m, :4], want[:m])
                assert bool((packet[:m, 4] == 1.0).all())
                assert bool((packet[m:] == 0.0).all())
                assert int(pk_drop) == max(n - spec.far_capacity, 0)
            seen += total
            sgs = step(sgs, params)[0]
        assert (seen > 0) == moving


@pytest.mark.parametrize("d", [2, 4])
def test_post_merge_occ_row_is_occ_row_of(d):
    """The post-merge occ_row equals occ_row_of of the post-merge band at
    every row (the merged edge rows included), and after the insert the
    plain version's occ_row_of equals that occ_row raised by each
    inserted cell's new count (what the kernel's atomicMax gives). With
    no far mover the insert hands back the post-merge band and lost."""
    s = _settings(n=2048)
    spec = build_resident_spec(s, d, far_capacity=16)
    mesh = make_resident_mesh(spec, [CPU] * d)
    params = tt.TickParams.default(CPU, gravity=(0.0, -9.8))
    st = tt.init_state(s, CPU)
    g = torch.Generator().manual_seed(17)
    vel = torch.randn(st.velocity.shape, generator=g) * 2.0
    vel[::37] *= 90.0
    inserted = 0
    for moving in (False, True):
        stv = dataclasses.replace(st, velocity=vel) if moving else st
        sgs = shard_grid_state(resident.from_particles(stv, s), spec, mesh)
        _, band4, occ_band, n_lost, total, _, after = _stages(
            spec, mesh, sgs, params)
        assert (total > 0) == moving
        for b in range(d):
            assert torch.equal(occ_band[b], resident.occ_row_of(band4[b][0]))
            g4, occ, lost = after[b]
            assert torch.equal(occ, resident.occ_row_of(g4[0]))
            changed = (g4[0] != band4[b][0]).any(dim=1)  # [rloc, Gxp]
            counts = (g4[0] < SENTINEL_HALF).sum(dim=1).to(torch.int32)
            raised = torch.maximum(
                occ_band[b], torch.where(changed, counts, 0).amax(dim=1))
            assert torch.equal(raised, occ)
            inserted += int(changed.sum())
            if not moving:
                for x, y in zip(g4, band4[b]):
                    assert torch.equal(x, y)
                assert torch.equal(lost, n_lost[b])
    assert inserted > 0


def test_graphed_row_band_step_plumbing(stand_in_graphs):
    """The graphed row-band step on D = 2 (stand-in graph) against its
    eager twin over 4 steps, the field swapped after 2: bitwise; the
    result never a static buffer; one capture; the audit of a replayed
    call one step's traffic, the formula's."""
    s = _settings(n=2048, texture_size=(72, 72))
    spec = build_resident_spec(s, 2)
    mesh = make_resident_mesh(spec, [CPU] * 2)
    params = tt.TickParams.default(CPU, gravity=(0.0, -9.8))
    g = torch.Generator().manual_seed(5)
    fields = [torch.rand((72, 72, 2), generator=g) - 0.5 for _ in range(2)]
    kstep = make_sharded_resident_step(spec, mesh, has_force_field=True)
    estep = make_eager_sharded_resident_step(spec, mesh,
                                             has_force_field=True)
    assert kstep.graphed and not estep.graphed
    n0 = len(graphs.CAPTURES)
    sgs = shard_grid_state(_grid("movers", s), spec, mesh)
    for i in range(4):
        field = fields[i // 2]
        a, ast = kstep(sgs, params, field)
        b, bst = estep(sgs, params, field)
        ag, bg = unshard_grid_state(a), unshard_grid_state(b)
        for f in GRID_FIELDS:
            assert torch.equal(getattr(ag, f), getattr(bg, f)), (i, f)
        assert torch.equal(ast["n_valid"], bst["n_valid"])
        sgs = a
    assert len(graphs.CAPTURES) == n0 + 1
    kept = [t.clone() for t in graphs.flatten(a)[0]]
    kstep(shard_grid_state(_grid("none", s), spec, mesh), params, fields[0])
    for x, y in zip(graphs.flatten(a)[0], kept):  # not a static buffer
        assert torch.equal(x, y)
    audit = comm_audit.audit_step(kstep, sgs, params, fields[1])
    model = comm_audit.resident_comm_formula(spec)
    assert audit["ppermute_bytes_per_dir"] == model["bytes_per_dir"]
    assert audit["all_gather_bytes_conditional"] == model["far_packet_bytes"]


@pytest.mark.parametrize("mode", ["grid", "dense", "pallas"])
def test_graphed_slab_step_plumbing(stand_in_graphs, mode):
    """The graphed slab step on D = 2 (stand-in graph) with debug stats and
    a field swapped after 2 steps, against its eager twin: bitwise, and
    the audit of a replayed call the eager step's."""
    s = tt.SimSettings(particle_count=512, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(4.0, 8.0),
                       cell_capacity=8, texture_size=(72, 72))
    spec = build_shard_spec(s, 2)
    mesh = make_mesh(spec, [CPU] * 2)
    params = tt.TickParams.default(CPU, gravity=(0.0, -9.8))
    g = torch.Generator().manual_seed(6)
    fields = [torch.rand((72, 72, 2), generator=g) - 0.5 for _ in range(2)]
    kw = dict(neighbor_mode=mode, debug=True, has_force_field=True)
    kstep = make_sharded_step(spec, mesh, **kw)
    estep = make_eager_sharded_step(spec, mesh, **kw)
    assert kstep.graphed and not estep.graphed
    a = b = init_sharded(spec, mesh)
    for i in range(4):
        a, ast = kstep(a, params, fields[i // 2])
        b, bst = estep(b, params, fields[i // 2])
        for x, y in zip(a.slabs, b.slabs):
            for f in ("position", "velocity", "valid", "tick"):
                assert torch.equal(getattr(x, f), getattr(y, f)), (i, f)
        assert ast.keys() == bst.keys()
        for k in ast:
            assert torch.equal(ast[k], bst[k]), (i, k)
    want = comm_audit.audit_step(estep, b, params, fields[1])
    got = comm_audit.audit_step(kstep, a, params, fields[1])
    assert got["ppermute_bytes_per_dir"] == want["ppermute_bytes_per_dir"]
    assert [o.shape for o in got["ops"]] == [o.shape for o in want["ops"]]


def test_graphable_meshes_and_tree():
    """Only a mesh of one CUDA device is captured (several cards and the
    CPU run eagerly); a tensor tree flattens and rebuilds itself."""
    cuda = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert graphs.graphable(*shard.Mesh([cuda[0]] * 4).devices)
    assert not graphs.graphable(*shard.Mesh(cuda).devices)
    assert not graphs.graphable(*shard.Mesh([CPU] * 2).devices)
    gs = resident.init_grid_state(_settings(n=64), CPU)
    tree = ((gs, gs), tt.TickParams.default(CPU), None,
            dict(n=torch.arange(3)))
    flat, spec = graphs.flatten(tree)
    assert len(flat) == 2 * 7 + len(dataclasses.fields(tree[1])) + 1
    back = graphs.unflatten(spec, flat)
    assert graphs.flatten(back) == (flat, spec)
    assert back[0][1].pos_x is gs.pos_x and back[2] is None
