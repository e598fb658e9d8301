"""The harness on the CPU: ``BENCHMARK.json`` against the contract's
rules, every cell's files found by name, a dummy cell added from new files
alone, the window arithmetic, the run on a machine without a card, and the
modules a run loads. ``test_cells_on_card`` runs each cell briefly on the
card (``-m cuda``) and skips without one."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_names_units_and_keys():
    names = []
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in SPEC[group]:
            assert set(e) == keys, e
            names.append(e["name"])
            assert NAME.match(e["name"]), e["name"]
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for group in ("end_to_end", "per_layer"):
        for m in SPEC[group]:
            names.append(m["name"])
            assert NAME.match(m["name"]), m["name"]
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(names) == len(set(names))
    assert [m["name"] for m in SPEC["end_to_end"]].count("setup_s") == 1
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_cell_resolves_by_name():
    for w in SPEC["workloads"]:
        cfg = run.load_config(SPEC, w["config"])
        entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
        assert entry["file"].startswith("benchmark/")
        assert cfg["name"] == w["config"]
        assert cfg["reduced"] == entry["reduced"]
        mix = run.load_json("traffic", w["traffic"])
        assert mix["loop"] in run.LOOPS
        limits = run.load_json("limits", w["name"])
        assert set(limits) >= {"start_gap", "tick_gap", "lost", "nonfinite",
                               "outside", "pos_gap", "vel_gap"}
        for m in run.metrics_of(SPEC, "per_layer", w["name"]):
            assert callable(run.reader(m["name"]))
        e2e = [m["name"] for m in run.metrics_of(SPEC, "end_to_end",
                                                 w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_of(SPEC, "per_layer", w["name"])


def test_each_layer_metric_moves_a_metric_its_cells_report():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
        for cell in m["workloads"]:
            assert cell in CELLS
            e2e = [x["name"] for x in run.metrics_of(SPEC, "end_to_end",
                                                      cell)]
            assert m["moves"] in e2e, (m["name"], cell)


def test_window_arithmetic_counts_every_frame_and_the_stall():
    lat = [0.007] * 99 + [0.5]  # one stall of half a second
    seconds = sum(lat)
    s = run.window_stats(seconds, 100, 1600, 1000, lat)
    assert s["frame_ms"] == pytest.approx(seconds / 100 * 1e3)
    assert s["frame_ms"] > 11.9  # the stall is in the mean
    assert s["particle_steps_per_s"] == pytest.approx(1000 * 1600 / seconds)
    # 95th of 100: between the 95th and 96th values, both 7 ms
    assert s["frame_ms_p95"] == pytest.approx(7.0)
    lat = [0.007] * 90 + [0.5] * 10  # a tenth of the frames stall
    s = run.window_stats(sum(lat), 100, 1600, 1000, lat)
    assert s["frame_ms_p95"] == pytest.approx(500.0)
    s = run.window_stats(2.0, 3, 300, 10, None)
    assert set(s) == {"particle_steps_per_s"}
    assert s["particle_steps_per_s"] == pytest.approx(1500.0)


def test_no_card_exits_nonzero_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(2**31 + 5),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_script_without_the_program_exits_nonzero(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def _tiny_tree(tmp_path: Path, extra_cell: bool = False) -> Path:
    """A copy of the benchmark whose configurations are cut to a few
    thousand particles, and with ``extra_cell`` a dummy cell, its
    configuration, traffic, limits and metric added as new files."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    spec = json.loads(json.dumps(SPEC))
    for name, upd, args in (
            ("sph-1m", dict(particle_count=1024, spawn_columns=32,
                            size=[4.35, 4.35]), None),
            ("ref-default-100k", dict(particle_count=1000, size=[5.3, 5.3]),
             ["--particles", "1000", "--size", "5.3", "5.3"])):
        p = b / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["domain"].update(upd)
        if args:
            c["app"]["args"] = args
        p.write_text(json.dumps(c))
    for p in (b / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        d["warmup_calls"] = min(d["warmup_calls"], 1)
        d["steps_per_call"] = 4
        d["trace"]["calls"] = 1
        d.update(width=96, height=54)
        p.write_text(json.dumps(d))
    if extra_cell:
        c = json.loads((b / "configs" / "sph-1m.json").read_text())
        c["name"] = "dummy-cfg"
        (b / "configs" / "dummy-cfg.json").write_text(json.dumps(c))
        (b / "traffic" / "dummy-mix.json").write_text(json.dumps(dict(
            loop="run", engine="grid", steps_per_call=2, warmup_calls=1,
            trace=dict(calls=1), check_steps=1)))
        (b / "limits" / "dummy-cell.json").write_text(
            (b / "limits" / "sph1m-steps.json").read_text())
        (b / "layer_metrics" / "dummy_steps.py").write_text(
            "def read(t):\n    return float(t.steps)\n")
        spec["configs"].append(dict(name="dummy-cfg", source="test",
                                    file="benchmark/configs/dummy-cfg.json",
                                    reduced=[], why="test"))
        spec["workloads"].append(dict(name="dummy-cell", config="dummy-cfg",
                                      traffic="dummy-mix", chips=1,
                                      why="test"))
        spec["per_layer"].append(dict(
            name="dummy_steps", unit="steps", better="higher",
            source="program_counter", layer="App shell (app.py)",
            moves="particle_steps_per_s", workloads=["dummy-cell"]))
        for m in spec["end_to_end"]:
            if m["name"] == "particle_steps_per_s":
                m["workloads"].append("dummy-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def test_dummy_cell_from_new_files_alone(tmp_path):
    root = _tiny_tree(tmp_path, extra_cell=True)
    spec = run.load_spec(root)
    wl = run.workload(spec, "dummy-cell")
    res = run.run_cell(spec, wl, 2**31 + 77, 0.2, True, device="cpu",
                       here=root / "benchmark", root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_steps"]["value"] == 2.0
    res = run.run_cell(spec, wl, 2**31 + 77, 0.2, False, device="cpu",
                       here=root / "benchmark", root=root)
    assert set(res["metrics"]) == {"particle_steps_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_on_the_cpu_at_a_small_size(tmp_path, cell):
    root = _tiny_tree(tmp_path)
    spec = run.load_spec(root)
    res = run.run_cell(spec, run.workload(spec, cell), 2**31 + 3, 0.2,
                       False, device="cpu", here=root / "benchmark",
                       root=root)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in run.metrics_of(spec, "end_to_end", cell)}
    assert set(res["metrics"]) == want
    # the same seed gives the same inputs
    from benchmark import inputs

    cfg = run.load_config(spec, run.workload(spec, cell)["config"], root)
    a = inputs.jittered(cfg, 2**31 + 3, "cpu")[0]
    b = inputs.jittered(cfg, 2**31 + 3, "cpu")[0]
    c = inputs.jittered(cfg, 2**31 + 4, "cpu")[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float((a - torch.from_numpy(inputs.lattice(
        cfg["domain"]["particle_count"], 0.1,
        cfg["domain"]["spawn_columns"]))).abs().max()) <= 0.01


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = _tiny_tree(tmp_path)
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from benchmark import run\n"
        f"root = Path({str(root)!r})\n"
        "spec = run.load_spec(root)\n"
        "res = run.run_cell(spec, run.workload(spec, 'sph1m-frames'), 9,"
        " 0.2, True, device='cpu', here=root / 'benchmark', root=root)\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.check, benchmark.roofline\n"
            "import benchmark.inputs, benchmark.trace\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'tpufluid_torch', 'tpufluid', 'jax'}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cells_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = run.run_cell(SPEC, run.workload(SPEC, cell), 2**31 + 11, 2.0,
                       False)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


def test_trace_arithmetic_on_a_synthetic_slice():
    """The readers on a hand-made slice: 10 ms window, two steps, device
    operations overlapping and apart, runtime calls in and out of spans."""
    from benchmark.trace import DeviceOp, HostCall, Trace

    k = lambda name, s, e, launch="cudaGraphLaunch", span="app.run": \
        DeviceOp(name, "kernel", s, e, span, launch)
    ops = [k("forces_kernel<0>", 0.000, 0.002), k("density_kernel", 0.0015,
                                                     0.003),
           k("forces_kernel<0>", 0.005, 0.007),
           DeviceOp("Memcpy DtoH", "memcpy", 0.008, 0.009, "app.run",
                    "cudaMemcpyAsync"),
           k("fill", 0.0095, 0.0120, "cudaLaunchKernel", None)]
    calls = [HostCall("cudaGraphLaunch", 0.0, 0.0001, "app.run"),
             HostCall("cudaGraphLaunch_v10000", 0.004, 0.0041, "app.run"),
             HostCall("cudaStreamSynchronize", 0.0081, 0.0091, "app.run"),
             HostCall("cudaMemcpyAsync", 0.008, 0.0081, "app.run"),
             HostCall("cudaDeviceSynchronize", 0.0092, 0.0099, None)]
    spans = [HostCall("app.run", 0.0, 0.0091, None)]
    t = Trace(window=(0.0, 0.010), device_ops=ops, host_calls=calls,
              spans=spans, engine="dense", steps=2)
    # union: [0, 3] + [5, 7] + [8, 9] + [9.5, 10] ms (clipped)
    assert t.busy_s() == pytest.approx(0.0065)
    assert run.reader("device_idle_share.steps")(t) == pytest.approx(0.35)
    assert run.reader("device_idle_share.frames")(t) is None
    assert run.reader("busy_ms_per_step.dense")(t) == pytest.approx(3.0)
    assert run.reader("busy_ms_per_step.resident")(t) is None
    assert run.reader("launches_per_step.dense")(t) == pytest.approx(1.5)
    assert run.reader("graph_launches_per_step")(t) == pytest.approx(1.0)
    assert run.reader("host_syncs_per_kstep")(t) == pytest.approx(500.0)
    assert run.reader("forces_integrate_roofline")(t) is None  # no states
    # gaps 3-5 and 7-8 ms inside the span alone, 9-9.5 ms in the sync
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"app.run": 0.003,
                                  "cudaStreamSynchronize": 0.0005})
    top = dict(t.device_top())
    assert top["forces_kernel<0>"] == pytest.approx(0.004)
    assert len(t.kernels("forces_integrate")) == 2
    assert len(t.kernels("density")) == 1
