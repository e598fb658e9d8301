"""PyTorch port, the bench harness (``tpufluid_torch.bench``) and the
CLI's ``bench`` command on the CPU, at tiny sizes: each entry point runs
and returns finite numbers named by their device; nothing writes a file
unless given a path. Times here are the CPU's and stand for nothing: the
card's come from ``chip_smoke.py``."""

import json
import math
import os

import pytest
import torch

from tpufluid_torch import SimSettings, TickParams, bench, cli
from tpufluid_torch.models import scenes

CPU = torch.device("cpu")


def scene_4k():
    """dam_break_4k's particles and box at K=8: the dense passes' plain
    versions run K x 9 small PyTorch calls a step on the CPU."""
    return scenes.Scene(
        name="dam-break-4k-k8",
        settings=SimSettings(particle_count=4096, particle_spacing=0.1,
                             smoothing_radius=0.2, size=(16.0, 16.0),
                             cell_capacity=8),
        params=TickParams.default(CPU, gravity=(0.0, -9.8)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["resident", "pallas"])
def test_bench_step(mode):
    r = bench.bench_step(scene_4k(), warmup=0, iters=1, burst=1,
                         neighbor_mode=mode, repeats=2)
    assert r["particles"] == 4096 and r["mode"] == mode
    assert r["device"] == "cpu"
    for k in ("ms_per_step", "particle_steps_per_sec",
              "particle_steps_per_sec_sigma"):
        assert math.isfinite(r[k]) and r[k] >= 0, k
    assert len(r["particle_steps_per_sec_samples"]) == 2


def test_bench_frame():
    ms = bench.bench_frame(scene_4k(), width=96, height=54, warmup=0,
                           iters=1)
    assert math.isfinite(ms) and ms > 0


def test_cli_bench_parses_and_refuses():
    args = cli.parser().parse_args(["bench", "--config", "4", "--device",
                                    "cpu"])
    assert (args.cmd, args.config, args.device) == ("bench", 4, "cpu")
    assert cli.parser().parse_args(["bench"]).config is None
    for bad in ("0", "6"):
        with pytest.raises(SystemExit):
            cli.parser().parse_args(["bench", "--config", bad])


def test_cli_bench_config5_on_cpu(capsys):
    """Config 5 needs two cards: on the CPU the CLI prints the skipped
    record, as the JAX harness does on one device."""
    assert cli.main(["bench", "--config", "5", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"config5_sharded": {
        "skipped": "needs multi-device, have 1"}}


def test_run_parity_writes_no_file(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ok = bench.run_parity(steps_short=1, steps_long=2, n=256, size=4.0,
                          device="cpu")
    assert ok is True
    assert os.listdir(tmp_path) == []
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "engine_parity" and rec["ok"]
    assert rec["device"] == "cpu" and len(rec["checks"]) == 8
    path = tmp_path / "parity.json"
    bench._write(str(path), "parity", rec)
    assert json.loads(path.read_text())["parity"]["ok"]


def test_bench_sharded_dense_on_cpu_shards():
    r = bench.bench_sharded(mode="dense", n=4096, iters=1,
                            devices=["cpu"] * 2)
    assert r["config"] == "sharded-2dev-dense" and r["devices"] == 2
    assert r["device"] == ["cpu", "cpu"]
    assert math.isfinite(r["ms_per_step"]) and r["ms_per_step"] > 0


def test_cross_backend_parity_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs it")
    assert bench.run_cross_backend_parity(steps=1) is None
    assert "skipped" in json.loads(capsys.readouterr().out)
