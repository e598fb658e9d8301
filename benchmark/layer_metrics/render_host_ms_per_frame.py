"""Host ms a frame in the program's span ``tpufluid_torch.render``
(``FluidApp.iter_frames``: ``render_frame`` and ``to_rgba8``, the Python
that issues the frame's render), over the slice's frames. None for a
program without the span."""


def read(t):
    if not t.frames:
        return None
    try:
        from tpufluid_torch.utils.profiling import record
    except ImportError:
        return None
    spans = [s for s in record().spans if s.name == "tpufluid_torch.render"]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6 / t.frames
