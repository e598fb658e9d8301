"""Runtime calls that wait for the device (``trace.SYNC_CALLS``) inside
the harness's ``app.run`` spans, per 1000 steps of the slice."""

from benchmark.trace import SYNC_CALLS


def read(t):
    if t.frames or not t.steps or not t.host_calls:
        return None
    return t.host_count(SYNC_CALLS, "app.run") / t.steps * 1e3
