"""B1's share of its roofline in a train step: the least time of the rolled correlation's
own work at the step's six scales (work/corr.py) over the summed trace time of
corr_fwd_kernel and corr_reduce_kernel, one corr_fwd_kernel a scale."""

from harness.roofline import kernel_share

KIND = 'train'
FUNCTION = 'corr'
KERNELS = ('corr_fwd_kernel', 'corr_reduce_kernel')


def read(w):
    return kernel_share(w, FUNCTION, KERNELS)
