"""The program's counter ``device_allocs`` of its ``tpufluid_torch.run``
spans (the rise of the CUDA caching allocator's ``num_device_alloc``, the
``cudaMalloc`` calls it made, across each call of ``FluidApp.run``), per
1000 steps of the slice. None in a frames slice, off a CUDA device and for
a program without the counter."""


def read(t):
    if t.frames or not t.steps:
        return None
    try:
        from tpufluid_torch.utils.profiling import record
    except ImportError:
        return None
    counts = [s.counts["device_allocs"] for s in record().spans
              if s.name == "tpufluid_torch.run"
              and "device_allocs" in s.counts]
    if not counts:
        return None
    return sum(counts) / t.steps * 1e3
