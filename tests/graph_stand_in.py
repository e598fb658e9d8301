"""A stand-in for the CUDA graph of ``tpufluid_torch.graphs.Graph``, so
that the graphed paths' plumbing (the runner cache, static copies in,
clones out, the mesh's notes per replay, the launch counts) runs on the
CPU. Imports no JAX. A test takes the fixture by importing it:

    from graph_stand_in import stand_in_graphs
"""

import pytest

from tpufluid_torch import graphs
from tpufluid_torch.parallel import shard


class StandInGraph(graphs.Graph):
    """``graphs.Graph`` with the CUDA graph stood in for: the capture runs
    the body once, and a replay runs it again with the mesh's notes muted
    (a CUDA graph replays kernels, not the Python that noted them)."""

    muted = False

    def _capture(self, run, device, what):
        self._run = run
        run()
        self.capture_s = self.instantiate_s = 0.0
        self.nodes = None

    def replay(self, n):
        StandInGraph.muted = True
        try:
            for _ in range(n):
                self._run()
        finally:
            StandInGraph.muted = False


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Every call graphed (``graphs.graphable``) through ``StandInGraph``,
    with no side stream; the step bursts' runner cache empty before and
    after."""
    note, begin = shard.Mesh.note, shard.Mesh.begin_step
    monkeypatch.setattr(graphs, "Graph", StandInGraph)
    monkeypatch.setattr(graphs, "on_side_stream", lambda fn, dev: fn())
    monkeypatch.setattr(graphs, "graphable", lambda *devices: True)
    monkeypatch.setattr(shard.Mesh, "note", lambda self, *a, **k: (
        None if StandInGraph.muted else note(self, *a, **k)))
    monkeypatch.setattr(shard.Mesh, "begin_step", lambda self: (
        None if StandInGraph.muted else begin(self)))
    graphs._RUNNERS.clear()
    yield
    graphs._RUNNERS.clear()
