"""PyTorch port, the graphed bursts' plumbing on the CPU.

On a CUDA device ``make_grid_multi_step`` and ``make_multi_step`` replay
one CUDA graph of their step a step (``tpufluid_torch.graphs``), bitwise
their eager twins; the card tests hold them so. Here a stand-in graph
(``graph_stand_in.py``) re-runs the captured Python on replay, so the rest
of the path runs: the runner cache (one capture a step, the runners of a
step rebuilt at another cell capacity dropped), the static copies in and
the clones out (freed when dropped, with no collector run), and the state
the per-step body writes back between replays. Imports no JAX.
"""

import dataclasses
import gc
import weakref

import pytest
import torch

import tpufluid_torch as tt
from tpufluid_torch import graphs
from tpufluid_torch.ops import resident
from tpufluid_torch.step import make_eager_multi_step

from graph_stand_in import stand_in_graphs  # noqa: F401 (a fixture)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(k=8):
    return tt.SimSettings(particle_count=512, particle_spacing=0.1,
                          smoothing_radius=0.2, size=(4.0, 8.0),
                          cell_capacity=k, texture_size=(72, 72))


def _fields():
    g = torch.Generator().manual_seed(7)
    return [torch.rand((72, 72, 2), generator=g) - 0.5 for _ in range(2)]


def _params():
    return tt.TickParams.default(CPU, gravity=(0.0, -9.8))


def _graph(key_of):
    """The one cached runner whose key ``key_of`` picks, and its graph."""
    hits = [(k, g) for k, (_, g) in graphs._RUNNERS.items() if key_of(k)]
    assert len(hits) == 1
    return hits[0]


def _not_static(tree, graph):
    """No tensor of ``tree`` shares storage with the graph's buffers."""
    held = {t.untyped_storage().data_ptr()
            for t in graph.static + list(graph._outs)}
    for t in graphs.flatten(tree)[0]:
        assert t.untyped_storage().data_ptr() not in held


@pytest.mark.parametrize("obstacles", [False, True])
def test_graphed_grid_burst_matches_eager(stand_in_graphs, obstacles):
    """The resident burst (stand-in graph), two bursts of 3 from the
    spawn lattice under gravity, a field swapped between them: bitwise
    its eager twin; one capture, none in the second burst; the result
    never a static buffer."""
    s = _settings()
    kw = dict(has_force_field=obstacles)
    run = resident.make_grid_multi_step(s, 3, **kw)
    eager = resident.make_eager_grid_multi_step(s, 3, **kw)
    fields = [(f,) if obstacles else () for f in _fields()]
    a = b = resident.init_grid_state(s, CPU)
    n0 = len(graphs.CAPTURES)
    for i in range(2):
        a = run(a, _params(), *fields[i])
        b = eager(b, _params(), *fields[i])
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                (i, f.name)
        assert len(graphs.CAPTURES) == n0 + 1
    assert int(a.tick) == 6
    _, graph = _graph(lambda k: True)
    _not_static(a, graph)
    kept = [t.clone() for t in graphs.flatten(a)[0]]
    run(resident.init_grid_state(s, CPU), _params(), *fields[0])
    for x, y in zip(graphs.flatten(a)[0], kept):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["dense", "grid"])
def test_graphed_step_burst_matches_eager(stand_in_graphs, mode):
    """A per-step engine's burst (stand-in graph), two bursts of 3 with an
    obstacle field swapped between them: bitwise its eager twin (the
    position, velocity and tick the body writes back carry the steps);
    one capture, none in the second burst; the result never a static
    buffer."""
    s = _settings()
    kw = dict(neighbor_mode=mode, has_force_field=True)
    run = tt.make_multi_step(s, 3, **kw)
    eager = make_eager_multi_step(s, 3, **kw)
    fields = _fields()
    a = b = tt.init_state(s, CPU)
    n0 = len(graphs.CAPTURES)
    for i in range(2):
        a = run(a, _params(), fields[i])
        b = eager(b, _params(), fields[i])
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                (i, f.name)
        assert len(graphs.CAPTURES) == n0 + 1
    assert int(a.tick) == 6
    _, graph = _graph(lambda k: True)
    _not_static(a, graph)


@pytest.mark.parametrize("engine", ["resident", "dense"])
def test_step_at_another_k_drops_its_runner(stand_in_graphs, engine):
    """A step rebuilt at another cell capacity captures its own graph and
    drops the old K's; the step at the first K captures again."""
    def burst(k):
        s = _settings(k)
        if engine == "resident":
            resident.make_grid_multi_step(s, 2)(
                resident.init_grid_state(s, CPU), _params())
        else:
            tt.make_multi_step(s, 2, neighbor_mode=engine)(
                tt.init_state(s, CPU), _params())

    def ks():
        return sorted(k[0].cell_capacity for k in graphs._RUNNERS)

    n0 = len(graphs.CAPTURES)
    burst(8)
    burst(8)
    assert ks() == [8] and len(graphs.CAPTURES) == n0 + 1
    burst(16)
    assert ks() == [16] and len(graphs.CAPTURES) == n0 + 2
    burst(8)
    assert ks() == [8] and len(graphs.CAPTURES) == n0 + 3


@pytest.mark.parametrize("engine", ["resident", "dense"])
def test_replayed_result_is_freed_when_dropped(stand_in_graphs, engine):
    """A replayed burst's result goes as soon as its caller drops it: no
    reference cycle keeps a burst's clones alive until the collector runs
    (on the card they would pile up device memory)."""
    s = _settings()
    if engine == "resident":
        run = resident.make_grid_multi_step(s, 3)
        state = resident.init_grid_state(s, CPU)
    else:
        run = tt.make_multi_step(s, 3, neighbor_mode=engine)
        state = tt.init_state(s, CPU)
    state = run(state, _params())  # captures
    gc.collect()
    gc.disable()
    try:
        out = run(state, _params())
        held = [weakref.ref(t) for t in graphs.flatten(out)[0]]
        del out
        assert all(w() is None for w in held)
    finally:
        gc.enable()
