"""The check against a broken program (CPU): each cell's run, driven from
its inputs to its result past the harness's look for a card, at a small
size, with a fault planted in the timed path, reads ``correct`` false.
Faults: a step that returns its state unchanged; half of the particles
left out of the step; one particle's answer altered where the step makes
it; one pixel of a frame altered where the frame is made. (No cell spans
chips, so no exchange between chips can be left out.)"""

import dataclasses

import pytest
import torch

from benchmark import run
from benchmark.tests.test_bench_harness import _tiny_tree


@pytest.fixture(autouse=True)
def _fresh_steps():
    """One torch thread, and no step built before the fault is planted."""
    from tpufluid_torch import graphs, step
    from tpufluid_torch.ops import resident

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for cache in (resident._STEP_CACHE, step._MULTI_STEP_CACHE,
                  graphs._RUNNERS):
        cache.clear()
    yield
    for cache in (resident._STEP_CACHE, step._MULTI_STEP_CACHE,
                  graphs._RUNNERS):
        cache.clear()
    torch.set_num_threads(n)


def _resident_fault(kind):
    from tpufluid_torch.ops import resident

    orig = resident.GridStep.advance

    def advance(self, gs, params, ff_cells, out=None):
        if kind == "unchanged":
            return gs
        new = orig(self, gs, params, ff_cells)
        if kind == "half":  # the lower half of the rows is not stepped
            h = gs.pos_x.shape[0] // 2
            f = {n: torch.cat([getattr(gs, n)[:h], getattr(new, n)[h:]])
                 for n in ("pos_x", "pos_y", "vel_x", "vel_y")}
            return dataclasses.replace(
                new, **f, occ_row=resident.occ_row_of(f["pos_x"]))
        live = (new.pos_x < 5e8).reshape(-1).nonzero()[0, 0]
        px = new.pos_x.clone()
        px.view(-1)[live] += 0.05  # one particle's answer altered
        return dataclasses.replace(new, pos_x=px)

    return resident.GridStep, "advance", advance


def _dense_fault(kind):
    from tpufluid_torch import step

    orig = step._integrate

    def integrate(position, velocity, *a, **kw):
        if kind == "unchanged":
            return position, velocity
        pos, vel = orig(position, velocity, *a, **kw)
        if kind == "half":
            h = pos.shape[0] // 2
            return (torch.cat([position[:h], pos[h:]]),
                    torch.cat([velocity[:h], vel[h:]]))
        pos = pos.clone()
        pos[0, 0] += 0.05
        return pos, vel

    return step, "_integrate", integrate


def _frame_fault():
    from tpufluid_torch.ops import render_grid

    orig = render_grid.render_metaball_grid

    def render(*a, **kw):
        out = orig(*a, **kw).clone()
        h, w = out.shape[:2]
        out[h // 2, w // 2, 2] = 1.0 - out[h // 2, w // 2, 2]
        return out

    return render_grid, "render_metaball_grid", render


def _run(tmp_path, cell):
    root = _tiny_tree(tmp_path)
    spec = run.load_spec(root)
    return run.run_cell(spec, run.workload(spec, cell), 2**31 + 21, 0.2,
                        False, device="cpu", here=root / "benchmark",
                        root=root)


CELLS = {"sph1m-steps": "resident", "ref100k-dense-steps": "dense",
         "sph1m-frames": "resident", "ref100k-resident-steps": "resident"}


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_a_broken_step_reads_incorrect(tmp_path, monkeypatch, cell, kind):
    make = _resident_fault if CELLS[cell] == "resident" else _dense_fault
    monkeypatch.setattr(*make(kind))
    res = _run(tmp_path, cell)
    assert res["correct"] is False, res["checks"]


def test_an_altered_frame_reads_incorrect(tmp_path, monkeypatch):
    monkeypatch.setattr(*_frame_fault())
    res = _run(tmp_path, "sph1m-frames")
    assert res["correct"] is False
    value, limit = res["checks"]["frame_gap"]
    assert value > limit


def test_the_sound_program_reads_correct(tmp_path):
    res = _run(tmp_path, "sph1m-frames")
    assert res["correct"], res["checks"]
