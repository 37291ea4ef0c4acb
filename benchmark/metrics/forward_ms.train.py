"""forward_ms.train: host ms per traced training step inside the port's
`gpe.forward` span: the step's start through the forward (padding, placement,
sampling, the lr, zero_grad)."""
from benchmark.spans import host_ms


def read(run):
    return host_ms(run, 'train', 'gpe.forward')
