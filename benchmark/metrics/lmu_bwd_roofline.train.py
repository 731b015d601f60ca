"""B3's share of its roofline in a train step: the least time of the fused stages'
backward, without recompute (work/lmu_bwd.py), over the summed trace time of
lmu_bwd_kernel and lmu_reduce_kernel, one lmu_bwd_kernel a fused stage."""

from harness.roofline import kernel_share

KIND = 'train'
FUNCTION = 'lmu_bwd'
KERNELS = ('lmu_bwd_kernel', 'lmu_reduce_kernel')


def read(w):
    return kernel_share(w, FUNCTION, KERNELS)
