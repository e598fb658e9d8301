"""Share of the traced slice of the frames loop in which no operation
(kernel, memcpy, memset) ran on the device."""


def read(t):
    if not t.frames or not t.device_ops or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s() / t.window_s
