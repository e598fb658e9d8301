"""The plain reference against the port's CPU step and frame, at a small
scene, and its comparison against a state rounded to bfloat16 (CPU)."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import inputs
from benchmark.reference import check, compare, render, sph

HERE = Path(__file__).resolve().parents[1]
LIMITS = json.loads((HERE / "limits" / "sph1m-frames.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(n=1024, cols=32, size=(4.35, 4.35)):
    cfg = json.loads((HERE / "configs" / "sph-1m.json").read_text())
    cfg["domain"].update(particle_count=n, spawn_columns=cols,
                         size=list(size))
    return cfg


def _app(cfg, engine, seed=3):
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.params import SimSettings
    from benchmark.run import hand_state

    d = cfg["domain"]
    app = FluidApp(SimSettings(particle_count=d["particle_count"],
                               size=tuple(d["size"]),
                               spawn_columns=d["spawn_columns"],
                               cell_capacity=16),
                   device="cpu", neighbor_mode=engine)
    pos, vel = inputs.jittered(cfg, seed, "cpu")
    assert hand_state(app, pos, vel) == 0.0
    return app


def _states(app, n_steps):
    from benchmark.run import check_state, held_state

    out = [check_state(held_state(app))]
    for _ in range(n_steps):
        app.run(1)
        out.append(check_state(held_state(app)))
    return out


def test_pairs_within_is_every_pair():
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand((300, 2), generator=g, dtype=torch.float64) - 0.5) * 3
    i, j = sph.pairs_within(pts, 0.4, (3.0, 3.0), with_self=False,
                            block=1000)
    d = torch.cdist(pts, pts)
    want = {(a, b) for a, b in (d < 0.4).nonzero().tolist() if a != b}
    assert set(zip(i.tolist(), j.tolist())) == want


@pytest.mark.parametrize("engine", ["resident", "dense"])
def test_reference_holds_the_ports_cpu_steps(engine):
    cfg = _config()
    app = _app(cfg, engine)
    app.run(40)  # past the first steps' fast rearrangement
    gaps = check.step_gaps(_states(app, 3), sph.physics(cfg))
    # float32 against float64: a few ulps of |x| <= 2.2 and of the
    # velocity increment
    assert gaps["pos_gap"] < 1e-5, gaps
    assert gaps["vel_gap"] < 1e-3, gaps
    assert gaps["pos_gap"] < LIMITS["pos_gap"]
    assert gaps["vel_gap"] < LIMITS["vel_gap"]


def test_reference_frame_holds_the_ports_cpu_frame():
    from benchmark.run import held_state, particles

    cfg = _config()
    app = _app(cfg, "resident")
    frames = app.iter_frames(3, 192, 108)
    for frame in frames:
        pos, vel, _, _ = particles(held_state(app))
        ref = render.frame(pos, vel, tuple(cfg["domain"]["size"]),
                           cfg["domain"]["smoothing_radius"], 192, 108)
        assert compare.frame_gap(torch.from_numpy(frame), ref) <= 1
        assert ref.float().mean() > 10  # the fluid is in view


def test_bfloat16_state_fails_the_comparison():
    cfg = _config()
    app = _app(cfg, "resident")
    app.run(40)
    states = _states(app, 1)
    rounded = [(p.to(torch.bfloat16).float(), v.to(torch.bfloat16).float(),
                t, sl) for p, v, t, sl in states]
    ph = sph.physics(cfg)
    gaps = check.step_gaps([states[0], rounded[1]], ph)
    # one number over its limit fails the run
    assert (gaps["pos_gap"] > LIMITS["pos_gap"]
            or gaps["vel_gap"] > LIMITS["vel_gap"]), gaps


def test_bfloat16_control_fails_the_limits():
    cfg = _config()
    app = _app(cfg, "resident")
    app.run(40)
    states = _states(app, 2)
    from benchmark.run import held_state, particles

    kept = [(None, particles(held_state(app))[:2])]
    mix = dict(width=192, height=108)
    ctl = check.control_gaps(states, kept, cfg, mix)
    assert ctl["pos_gap"] > LIMITS["pos_gap"], ctl
    assert ctl["frame_gap"] > LIMITS["frame_gap"], ctl
