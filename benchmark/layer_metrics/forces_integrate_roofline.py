"""forces_integrate's share of its roofline, in %: the least time of one
launch's work (``roofline.work`` on the slice's grid states, the bound of
``roofline.least_ms``) over the mean time of a launch of the kernel
(``forces_kernel``, csrc/forces.cu) in the slice."""

from benchmark import roofline


def read(t):
    launches = t.kernels("forces_integrate")
    work = t.work("forces_integrate")
    if not launches or work is None:
        return None
    ms = sum(op.end - op.start for op in launches) / len(launches) * 1e3
    least, _ = roofline.least_ms(*work)
    return 100.0 * least / ms
