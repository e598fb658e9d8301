"""PyTorch port, the NaN-provenance tools (utils.debugging) against the JAX
package on the CPU.

``checked_step`` is held to JAX's ``checkify`` verdict (clean or not) and
names the stage; ``diagnose_resident_step``'s report is held to JAX's:
the stages and keys, the integers and ``finite`` exactly, the float
maxima within rtol 1e-5 (one step of f32 physics on two backends,
BASELINE.md's per-step bounds).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.ops import resident as jresident
from tpufluid.utils import debugging as jdebugging

import tpufluid_torch as tt
from tpufluid_torch import interop
from tpufluid_torch.ops import resident as tresident
from tpufluid_torch.utils.debugging import (
    StageError, checked_step, diagnose_resident_step)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAGES = ["input", "rebin", "density", "forces"]


def _jsettings():
    # tests/test_debugging.py's small domain
    return tpufluid.SimSettings(particle_count=64, particle_spacing=0.1,
                                smoothing_radius=0.2, size=(3.2, 3.2),
                                cell_capacity=8)


def _poisoned(state, nan_at=0):
    pos = state.position.clone()
    pos[nan_at, 0] = float("nan")
    return dataclasses.replace(state, position=pos, predicted=pos.clone())


@pytest.mark.parametrize("mode", ["dense", "grid"])
def test_checked_step_clean_and_nan_input_match_jax(mode):
    js = _jsettings()
    ts = interop.settings_from(js)
    tstep = checked_step(ts, neighbor_mode=mode)
    state = tt.init_state(ts, "cpu")
    err, out = tstep(state, tt.TickParams.default("cpu"))
    err.throw()  # a no-op
    assert err.get() is None and err == StageError(None, mode)
    assert torch.isfinite(out.position).all()
    # the same step, unchecked, gives the same state
    plain = tt.make_step(ts, neighbor_mode=mode)(
        state, tt.TickParams.default("cpu"))
    assert torch.equal(out.position, plain.position)

    err, _ = tstep(_poisoned(state), tt.TickParams.default("cpu"))
    assert err.stage == "input"
    with pytest.raises(FloatingPointError, match="'input'"):
        err.throw()

    if mode == "dense":  # JAX's checkify verdicts on the same two states
        jstep = jdebugging.checked_step(js, neighbor_mode=mode)
        jstate = tpufluid.init_state(js)
        jerr, _ = jstep(jstate, tpufluid.TickParams.default())
        assert jerr.get() is None
        bad = jstate.position.at[0, 0].set(jnp.nan)
        jerr, _ = jstep(dataclasses.replace(jstate, position=bad,
                                            predicted=bad),
                        tpufluid.TickParams.default())
        assert jerr.get() is not None


@pytest.mark.parametrize("field,stage", [
    ("mass", "density"),
    ("pressure_constant", "forces"),
    ("damping_factor", "integrate"),
])
def test_checked_step_locates_a_nan_mid_step(field, stage):
    """A NaN tunable first shows in the stage that reads it: mass in the
    density, the pressure constant in the forces, the damping in the wall
    bounce of the integration (every particle is sent through the
    floor)."""
    ts = interop.settings_from(_jsettings())
    state = tt.init_state(ts, "cpu")
    vel = state.velocity.clone()
    vel[:, 1] = -300.0  # every particle reaches the floor in one step
    state = dataclasses.replace(state, velocity=vel)
    params = tt.TickParams.default("cpu", **{field: float("nan")})
    for mode in ("dense", "grid", "naive", "pallas"):
        err, _ = checked_step(ts, neighbor_mode=mode)(state, params)
        assert err.stage == stage, (mode, err.stage)
        with pytest.raises(FloatingPointError, match=stage):
            err.throw()


def _poison_live(gs):
    """vel_x = inf in a live slot (empty slots are masked out)."""
    live = np.argwhere(tresident.valid_mask(gs).numpy())
    y, k, x = map(int, live[len(live) // 2])
    vx = gs.vel_x.clone()
    vx[y, k, x] = float("inf")
    return dataclasses.replace(gs, vel_x=vx)


def test_diagnose_resident_step_clean_and_poisoned():
    ts = interop.settings_from(_jsettings())
    gs = tresident.init_grid_state(ts, "cpu")
    params = tt.TickParams.default("cpu")
    rep = diagnose_resident_step(gs, params, ts)
    assert list(rep) == STAGES
    assert all(v["finite"] for v in rep.values())
    assert rep["rebin"]["over"] == 0 and rep["rebin"]["far"] == 0
    assert rep["input"]["live"] == rep["forces"]["live"] == 64
    assert rep["density"]["rho_max"] > 0.0

    bad = diagnose_resident_step(_poison_live(gs), params, ts)
    assert list(bad) == STAGES
    assert not bad["input"]["finite"]

    # with an obstacle field: the forces stage takes the cell samples
    field = torch.zeros(tuple(ts.texture_size[::-1]) + (2,))
    field[..., 0] = 3.0
    ff = diagnose_resident_step(gs, params, ts, forcefield=field)
    assert ff["forces"]["finite"]
    assert ff["forces"]["speed_max"] != rep["forces"]["speed_max"]


def _compare_reports(got, want):
    assert list(got) == list(want)
    for stage in want:
        assert set(got[stage]) == set(want[stage]), stage
        for key, w in want[stage].items():
            g = got[stage][key]
            if isinstance(w, float):
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           err_msg=f"{stage}.{key}")
            else:
                assert g == w, (stage, key, g, w)


def test_diagnose_resident_step_matches_jax(monkeypatch):
    """Both reports against JAX's, in one test so that the JAX package's
    interpret-mode trace is paid once: the clean spawn lattice, then a live
    ``vel_x`` poisoned with inf (``input`` not finite, and every count and
    maximum of the later stages as JAX reports them). The JAX kernels run
    one row per program (the same outputs; a third of the interpret-mode
    compile time)."""
    monkeypatch.setattr(jresident, "rows_per_program", lambda s: 1)
    js = _jsettings()
    ts = interop.settings_from(js)
    jgs = jresident.init_grid_state(js)
    tgs = interop.grid_state_from_numpy(jgs, "cpu")
    jp, tp = tpufluid.TickParams.default(), tt.TickParams.default("cpu")
    got = diagnose_resident_step(tgs, tp, ts)
    assert all(v["finite"] for v in got.values())
    _compare_reports(got, jdebugging.diagnose_resident_step(jgs, jp, js))

    tgs = _poison_live(tgs)
    jgs = dataclasses.replace(jgs, vel_x=jnp.asarray(tgs.vel_x.numpy()))
    got = diagnose_resident_step(tgs, tp, ts)
    assert not got["input"]["finite"]
    _compare_reports(got, jdebugging.diagnose_resident_step(jgs, jp, js))
