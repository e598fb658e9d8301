"""Share of the traced slice of a run loop in which no operation (kernel,
memcpy, memset) ran on the device: 1 - the union of their intervals over
the slice, which ends once the device has drained."""


def read(t):
    if t.frames or not t.steps or not t.device_ops or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s() / t.window_s
