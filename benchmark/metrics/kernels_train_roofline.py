"""kernels_train_roofline: the least times of the port's own kernel launches
in the traced training window over those kernels' device time, in %."""
from benchmark.readers import kernels_roofline


def read(run):
    return kernels_roofline(run, 'train')
