"""Host ms a step in the program's span ``tpufluid_torch.burst``
(``FluidApp.run``: each burst's call, its copy-in, graph replays and
clone-out, or its eager loop), over the slice's steps. None in a frames
slice and for a program without the span."""


def read(t):
    if t.frames or not t.steps:
        return None
    try:
        from tpufluid_torch.utils.profiling import record
    except ImportError:
        return None
    spans = [s for s in record().spans if s.name == "tpufluid_torch.burst"]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6 / t.steps
