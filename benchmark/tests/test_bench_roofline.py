"""The roofline's counts on a hand-built slot grid (CPU)."""

import pytest
import torch

from benchmark import roofline

S = 1.0e9  # an empty slot's position


def _grid():
    """[3 rows, K=4, 3 cols] with occupancies
    row 0: 1 0 2 / row 1: 0 4 0 / row 2: 3 0 1; occ_row = 2, 4, 3."""
    occ = [[1, 0, 2], [0, 4, 0], [3, 0, 1]]
    px = torch.full((3, 4, 3), S)
    for y in range(3):
        for x in range(3):
            px[y, :occ[y][x], x] = 0.5
    return px, torch.tensor([2, 4, 3], dtype=torch.int32), occ


def test_live_and_stencil_pairs():
    px, _, occ = _grid()
    assert roofline.live_per_cell(px).tolist() == [[float(c) for c in r]
                                                  for r in occ]
    # each target cell's live count times the live count of its 3 x 3
    # neighbourhood (cells outside the grid hold none)
    want = 0
    for y in range(3):
        for x in range(3):
            box = sum(occ[yy][xx] for yy in range(max(0, y - 1), min(3, y + 2))
                      for xx in range(max(0, x - 1), min(3, x + 2)))
            want += occ[y][x] * box
    assert want == 1 * 5 + 2 * 6 + 4 * 11 + 3 * 7 + 1 * 5
    assert roofline.stencil_pairs(px) == want


def test_grid_bytes_reads_below_occupancy_writes_whole():
    px, occ_row, _ = _grid()
    # inputs: (2 + 4 + 3) slots a column x 3 columns x 4 bytes per field
    assert roofline.grid_bytes(px, occ_row, 1, 0) == 9 * 3 * 4
    assert roofline.grid_bytes(px, occ_row, 0, 1) == 3 * 4 * 3 * 4
    # occupancy above K counts K
    big = torch.tensor([9, 9, 9], dtype=torch.int32)
    assert roofline.grid_bytes(px, big, 1, 0) == 3 * 4 * 3 * 4


@pytest.mark.parametrize("kernel,units", [("rebin", 11),
                                          ("density", 87),
                                          ("forces_integrate", 87)])
def test_work_of_each_kernel(kernel, units):
    px, occ_row, _ = _grid()
    n_in, n_out = roofline.IO[kernel]
    n_bytes, n_ops = roofline.work(kernel, px, occ_row)
    assert n_ops == roofline.OPS[kernel] * units
    assert n_bytes == n_in * 9 * 3 * 4 + n_out * 36 * 4


def test_least_ms_takes_the_larger_bound():
    ms, by = roofline.least_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = roofline.least_ms(1.0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_counts_are_the_card_scripts():
    """The copy keeps chip_smoke.py's counts and peaks."""
    import ast
    from pathlib import Path

    src = (Path(__file__).resolve().parents[2] / "chip_smoke.py").read_text()
    consts = {}
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                names = ([e.id for e in t.elts] if isinstance(t, ast.Tuple)
                         else [getattr(t, "id", None)])
                try:
                    vals = ast.literal_eval(node.value)
                except ValueError:
                    continue
                vals = vals if isinstance(t, ast.Tuple) else [vals]
                consts.update(zip(names, vals))
    assert consts["PEAK_BYTES"] == roofline.PEAK_BYTES
    assert consts["PEAK_F32"] == roofline.PEAK_F32
    for k, v in roofline.OPS.items():
        assert consts["OPS"][k] == v
