"""optimizer_ms.train: host ms per traced training step inside the port's
`gpe.optimizer` span: the optimizer's step."""
from benchmark.spans import host_ms


def read(run):
    return host_ms(run, 'train', 'gpe.optimizer')
