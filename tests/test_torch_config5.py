"""PyTorch port, config 5's derived 4M/8-card estimate
(``tpufluid_torch.bench.config5_model``, ``--config5-model``) and the
headline run's parity refresh, held against the JAX harness (the repo-root
``bench.py``) on the CPU.

The band's time is stubbed to the same value in both harnesses (the real
one is the card's, chip_smoke.py phase 26), so every field the two records
share must be equal, and the port's estimate must be its formula under the
port's own link figures. The audited step at scene_4m runs on the card
only: here the 4M bytes are held through the formula against JAX's traced
step, and the port's measured bytes against JAX's on a small 8-shard
spec.
"""

import dataclasses
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpufluid
from tpufluid import models as jmodels
from tpufluid.ops import resident as jresident
from tpufluid.parallel import build_resident_spec as jbuild_resident_spec

from tpufluid_torch import SimSettings, bench
from tpufluid_torch.models import scenes
from tpufluid_torch.ops import resident
from tpufluid_torch.parallel import build_resident_spec, comm_audit



def _load_jax_bench():
    """The JAX harness (the repo-root ``bench.py``), loaded by its path
    under its own name, whatever directory pytest runs from; loading it
    imports no JAX until a function runs."""
    name = "tpufluid_jax_bench"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(__file__).resolve().parents[1] / "bench.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


jbench = _load_jax_bench()

CPU = torch.device("cpu")
BYTES_4M = 397_320
BAND_MS = 0.5
BAND_LOST_3 = 65
# the record's fields that do not depend on the link figures or the card
SHARED = ("particles", "devices", "band_particles", "band_rows", "k", "gxp",
          "measured_band_ms_per_step", "halo_factor", "measured_comm_bytes")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jspec_4m():
    return jbuild_resident_spec(jmodels.scene_4m().settings, 8)


@pytest.fixture(scope="module")
def jbytes_4m(jspec_4m):
    """JAX's per-direction bytes of its sharded step at scene_4m, traced
    over an abstract 8-device mesh."""
    return jbench._measured_comm_bytes_per_dir(jspec_4m)


def _small_settings():
    """tests/test_shard.py's comm-volume scene: 512 particles, 8 x 8."""
    return SimSettings(particle_count=512, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(8.0, 8.0), cell_capacity=8)


def _stub_band(monkeypatch, module, seen):
    """``module.bench_step`` records the band scene's settings and returns
    BAND_MS ms a step."""
    def fake(scene, **kw):
        seen.append((scene.name, scene.settings, kw))
        return dict(ms_per_step=BAND_MS)
    monkeypatch.setattr(module, "bench_step", fake)


def _stub_port_bytes(monkeypatch):
    """The port's audited bytes through the formula (its real run is
    test_measured_comm_bytes_match_jax_small_spec and the card's)."""
    monkeypatch.setattr(
        bench, "_measured_comm_bytes_per_dir",
        lambda spec, device: comm_audit.resident_comm_formula(
            spec)["bytes_per_dir"])


def test_spec_4m_matches_jax(jspec_4m):
    spec = build_resident_spec(scenes.scene_4m(CPU).settings, 8)
    assert (spec.n_devices, spec.rows_per_dev, spec.gy_pad,
            spec.far_capacity) == (8, 131, 1048, 8192)
    assert (spec.settings.cell_capacity,
            resident._gxp(spec.settings)) == (8, 1024)
    assert dataclasses.asdict(spec.settings) == dataclasses.asdict(
        jspec_4m.settings)
    for f in ("n_devices", "rows_per_dev", "gy_pad", "far_capacity"):
        assert getattr(spec, f) == getattr(jspec_4m, f), f
    assert resident._gxp(spec.settings) == jresident._gxp(jspec_4m.settings)


def test_comm_formula_4m_matches_jax_trace(jbytes_4m):
    spec = build_resident_spec(scenes.scene_4m(CPU).settings, 8)
    model = comm_audit.resident_comm_formula(spec)
    assert (model["payload_bytes_per_dir"],
            model["occupancy_bytes_per_dir"]) == (393_216, 4_104)
    assert model["bytes_per_dir"] == jbytes_4m == BYTES_4M


def test_measured_comm_bytes_match_jax_small_spec():
    ts = _small_settings()
    spec = build_resident_spec(ts, 8)
    jspec = jbuild_resident_spec(
        tpufluid.SimSettings(**dataclasses.asdict(ts)), 8)
    got = bench._measured_comm_bytes_per_dir(spec, CPU)
    assert got == jbench._measured_comm_bytes_per_dir(jspec)
    assert got == comm_audit.resident_comm_formula(spec)["bytes_per_dir"]


def test_band_grid_matches_jax():
    """One shard's band: JAX's settings, and the same [132, 8, 1024] grid
    at init, bitwise, with nothing lost where the lattice overhangs the
    band's height."""
    spec, band = bench.config5_band(CPU)
    assert band.name == "config5-band"
    assert dataclasses.asdict(band.settings) == dict(
        particle_count=524_288, particle_spacing=0.1, smoothing_radius=0.2,
        size=(204.35, (131 - 2) * 0.2), texture_size=(1024, 1024),
        cell_capacity=8, spawn_columns=2016)
    gs = resident.init_grid_state(band.settings, CPU)
    jgs = jresident.init_grid_state(
        tpufluid.SimSettings(**dataclasses.asdict(band.settings)))
    assert tuple(gs.pos_x.shape) == (132, 8, 1024)
    assert int(gs.lost) == int(jgs.lost) == 0
    for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row"):
        np.testing.assert_array_equal(getattr(gs, f).numpy(),
                                      np.asarray(getattr(jgs, f)), f)


def test_band_steps_lose_what_jax_loses():
    """The band's first 3 steps, each from JAX's state: occupancy, layout,
    tick and lost bitwise, floats within the resident tolerances (pos
    4.8e-7, vel 3.8e-5 relative). The lattice's overhang, clamped into the
    band's edge rows at init, packs cells there past K=8 in the third step:
    both lose the same 65 particles (chip_smoke.py holds the card's kernel
    steps to that count)."""
    jax = pytest.importorskip("jax")
    from tpufluid_torch import interop

    _, band = bench.config5_band(CPU)
    js = tpufluid.SimSettings(**dataclasses.asdict(band.settings))
    jp = tpufluid.TickParams.default()
    tp = interop.tick_params_from_numpy(jp, "cpu")
    jstep = jresident.make_grid_step(js)
    tstep = resident.make_grid_step(band.settings)
    jgs = jresident.init_grid_state(js)
    lost = []
    for i in range(3):
        tgs = tstep(interop.grid_state_from_numpy(jgs, "cpu"), tp)
        jgs = jax.block_until_ready(jstep(jgs, jp))
        for f in ("occ_row", "tick", "lost"):
            np.testing.assert_array_equal(getattr(tgs, f).numpy(),
                                          np.asarray(getattr(jgs, f)),
                                          f"step {i} {f}")
        live = np.asarray(jresident.valid_mask(jgs))
        np.testing.assert_array_equal(resident.valid_mask(tgs).numpy(), live,
                                      f"step {i} layout")
        for f, tol in (("pos_x", 4.8e-7), ("pos_y", 4.8e-7),
                       ("vel_x", 3.8e-5), ("vel_y", 3.8e-5)):
            got = getattr(tgs, f).numpy()[live]
            want = np.asarray(getattr(jgs, f))[live]
            err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
            assert err.max() <= tol, f"step {i} {f}: {err.max()} > {tol}"
        lost.append(int(jgs.lost))
    assert lost == [0, 0, BAND_LOST_3]


def test_config5_model_matches_jax(monkeypatch, jbytes_4m):
    seen, jseen = [], []
    _stub_band(monkeypatch, bench, seen)
    _stub_band(monkeypatch, jbench, jseen)
    _stub_port_bytes(monkeypatch)
    monkeypatch.setattr(jbench, "_measured_comm_bytes_per_dir",
                        lambda spec: jbytes_4m)
    out, jout = io.StringIO(), io.StringIO()
    rec = bench.config5_model(out=out, device="cpu")
    jrec = jbench.config5_model(out=jout)

    (name, settings, kw), = seen
    (jname, jsettings, jkw), = jseen
    assert name == jname == "config5-band"
    assert dataclasses.asdict(settings) == dataclasses.asdict(jsettings)
    assert kw == jkw == dict(warmup=2, iters=10)
    assert json.loads(out.getvalue()) == json.loads(
        json.dumps(rec, default=float))
    for key in SHARED:
        assert rec[key] == jrec[key], key
    assert rec["measured_comm_bytes"] == BYTES_4M
    assert (rec["band_rows"], rec["halo_factor"]) == (131, round(135 / 131, 4))
    assert rec["config"] == "config5-derived-4M-h100x8"
    assert rec["device"] == "cpu"
    assert (rec["assumed_link_oneway_GBps"],
            rec["assumed_phase_latency_us"]) == (450.0, 5.0)
    t_comm = BYTES_4M / 450e9 + 3 * 5e-6
    t_step = BAND_MS * 1e-3 * 135 / 131 + t_comm
    assert rec["modeled_comm_ms_per_step"] == pytest.approx(
        t_comm * 1e3, rel=1e-12)
    assert rec["est_ms_per_step"] == pytest.approx(t_step * 1e3, rel=1e-12)
    assert rec["est_particle_steps_per_sec"] == pytest.approx(
        4_194_304 / t_step, rel=1e-12)
    assert set(jrec) - set(rec) == {"assumed_ici_oneway_GBps"}
    assert "TPU" not in rec["note"] and "v5e" not in rec["note"]


def test_main_config5_model_prints_one_line(monkeypatch, capsys):
    _stub_band(monkeypatch, bench, [])
    _stub_port_bytes(monkeypatch)
    assert bench.main(["--config5-model", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["config"] == "config5-derived-4M-h100x8"
    assert rec["measured_comm_bytes"] == BYTES_4M


def _stub_headline(monkeypatch, calls, parity=True):
    """``run_parity`` records its call and prints a report line (which the
    headline run must send to stderr); ``bench_step`` records the
    headline's burst and returns a fixed rate (the real headline runs 3,360
    scene_1m steps: the card's)."""
    def fake_parity(**kw):
        calls.append(("run_parity", kw))
        print("PARITY-REPORT")
        if isinstance(parity, Exception):
            raise parity
        return parity

    def fake_step(scene, **kw):
        calls.append(("bench_step", scene.name, kw))
        return dict(particle_steps_per_sec=1.0e9,
                    particle_steps_per_sec_sigma=1.0e6,
                    particle_steps_per_sec_samples=[1.0e9] * 5,
                    device="cpu")
    monkeypatch.setattr(bench, "run_parity", fake_parity)
    monkeypatch.setattr(bench, "bench_step", fake_step)


@pytest.mark.parametrize("parity", [True, False])
def test_headline_refreshes_parity_before_its_line(monkeypatch, capsys,
                                                   parity):
    """The headline's bursts, then the parity refresh (so that nothing it
    leaves can move the rate), then the one line."""
    calls = []
    _stub_headline(monkeypatch, calls, parity)
    assert bench.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert [c[0] for c in calls] == ["bench_step", "run_parity"]
    assert calls[0][1] == "sph-1m"
    assert calls[0][2]["burst"] == 120 and calls[0][2]["repeats"] == 5
    assert calls[1] == ("run_parity", dict(steps_short=10, steps_long=120,
                                           n=16384, device="cpu"))
    assert "PARITY-REPORT" in captured.err
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "particle_steps_per_sec_1M"
    assert rec["parity_ok"] is parity and rec["device"] == "cpu"


def test_headline_parity_failure_raises(monkeypatch, capsys):
    calls = []
    _stub_headline(monkeypatch, calls, RuntimeError("parity broke"))
    with pytest.raises(RuntimeError, match="parity broke"):
        bench.main(["--device", "cpu"])
    assert [c[0] for c in calls] == ["bench_step", "run_parity"]
    assert capsys.readouterr().out == ""


def test_all_runs_no_parity(monkeypatch, capsys):
    calls = []
    _stub_headline(monkeypatch, calls)
    ladder = []
    monkeypatch.setattr(bench, "run_configs",
                        lambda which, **kw: ladder.append((which, kw)))
    assert bench.main(["--all", "--device", "cpu"]) == 0
    (which, kw), = ladder
    assert which is None and (kw["mode"], kw["device"]) == ("resident", "cpu")
    assert [c[0] for c in calls] == ["bench_step"]
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["parity_ok"] is None
