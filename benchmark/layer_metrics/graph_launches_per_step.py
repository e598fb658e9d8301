"""CUDA graph launches (``cudaGraphLaunch`` runtime calls) inside the
harness's ``app.run`` spans, over the slice's steps."""

from benchmark.trace import GRAPH_LAUNCH


def read(t):
    if t.frames or not t.steps:
        return None
    n = t.host_count(GRAPH_LAUNCH, "app.run")
    return n / t.steps if n else None
