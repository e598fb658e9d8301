"""Host ms a frame in the program's span ``tpufluid_torch.run`` opened
inside a ``tpufluid_torch.frame`` (``FluidApp.iter_frames``: the frame's
16 ticks dispatched, and the loss audit every 16th frame), over the
slice's frames. None for a program without the spans."""


def read(t):
    if not t.frames:
        return None
    try:
        from tpufluid_torch.utils.profiling import record
    except ImportError:
        return None
    spans = record().spans
    runs = [s for s in spans if s.name == "tpufluid_torch.run"
            and s.parent >= 0
            and spans[s.parent].name == "tpufluid_torch.frame"]
    if not runs:
        return None
    return sum(s.end_ns - s.start_ns for s in runs) * 1e-6 / t.frames
