"""density's share of its roofline, in %: the least time of one launch's
work (``roofline.work`` on the slice's grid states) over the mean time of
a launch of ``density_kernel`` (csrc/density.cu) in the slice."""

from benchmark import roofline


def read(t):
    launches, work = t.kernels("density"), t.work("density")
    if not launches or work is None:
        return None
    ms = sum(op.end - op.start for op in launches) / len(launches) * 1e3
    least, _ = roofline.least_ms(*work)
    return 100.0 * least / ms
