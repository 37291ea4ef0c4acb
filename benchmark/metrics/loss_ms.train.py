"""loss_ms.train: host ms per traced training step inside the port's `gpe.loss`
span: the composed loss, its quality metrics included."""
from benchmark.spans import host_ms


def read(run):
    return host_ms(run, 'train', 'gpe.loss')
