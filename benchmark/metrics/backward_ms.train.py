"""backward_ms.train: host ms per traced training step inside the port's
`gpe.backward` span: autograd's backward (and under a mesh the gradient sum)."""
from benchmark.spans import host_ms


def read(run):
    return host_ms(run, 'train', 'gpe.backward')
