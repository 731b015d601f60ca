"""B2's share of its roofline in a request: the least time of the fused stages' forward
(work/lmu_fwd.py) over the summed trace time of lmu_fwd_kernel, one a fused stage."""

from harness.roofline import kernel_share

KIND = 'serve'
FUNCTION = 'lmu_fwd'
KERNELS = ('lmu_fwd_kernel',)


def read(w):
    return kernel_share(w, FUNCTION, KERNELS)
