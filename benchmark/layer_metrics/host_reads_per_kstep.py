"""The program's counter ``host_reads`` (each device-to-host read it
makes: the loss audit's and the capacity check's scalars, the ``state``
setter's loss, a frame's readback), per 1000 steps of the slice: the
inside twin of ``host_syncs_per_kstep``. None in a frames slice and for a
program without the span ``tpufluid_torch.run``."""


def read(t):
    if t.frames or not t.steps:
        return None
    try:
        from tpufluid_torch.utils.profiling import record
    except ImportError:
        return None
    rec = record()
    if not any(s.name == "tpufluid_torch.run" for s in rec.spans):
        return None
    return rec.counts.get("host_reads", 0) / t.steps * 1e3
