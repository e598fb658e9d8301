"""Host ms a frame in the program's span ``tpufluid_torch.readback``
(``FluidApp.iter_frames``: the u8 frame's ``.cpu().numpy()``, which waits
for the frame's queued ticks and render, then copies), over the slice's
frames. None for a program without the span."""


def read(t):
    if not t.frames:
        return None
    try:
        from tpufluid_torch.utils.profiling import record
    except ImportError:
        return None
    spans = [s for s in record().spans if s.name == "tpufluid_torch.readback"]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6 / t.frames
