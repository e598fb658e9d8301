"""Device ms a step of the resident engine: the union of the device
operations launched inside the harness's ``app.run`` spans, over the
slice's steps."""


def read(t):
    if t.engine != "resident" or t.frames or not t.steps:
        return None
    busy = t.busy_s(lambda op: op.span == "app.run")
    return busy / t.steps * 1e3 if busy > 0 else None
