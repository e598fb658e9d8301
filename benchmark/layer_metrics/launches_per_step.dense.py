"""Kernels a step of the dense engine: kernels launched inside the
harness's ``app.run`` spans (a graph replay's kernels each count), over the
slice's steps."""


def read(t):
    if t.engine != "dense" or not t.steps:
        return None
    n = sum(1 for op in t.device_ops
            if op.kind == "kernel" and op.span == "app.run")
    return n / t.steps if n else None
