"""Device ms a frame of the render: the union of the kernels launched in
the harness's ``frame`` spans by anything but a graph replay (the steps
replay their graph; the frame's coarse fields, resample and shading are
launched one by one; the loss audit adds one small reduction every 16
frames), over the slice's frames."""

from benchmark.trace import GRAPH_LAUNCH


def read(t):
    if not t.frames:
        return None
    busy = t.busy_s(lambda op: op.kind == "kernel" and op.span == "frame"
                    and op.launch is not None
                    and op.launch.split("_v")[0] not in GRAPH_LAUNCH)
    return busy / t.frames * 1e3 if busy > 0 else None
