"""plain_ops_ms.train: device ms per traced training step of every operation
that is not one of the port's own kernels (PyTorch's GEMMs, elementwise passes,
reductions, copies, Adam)."""


def read(run):
    if run.kind != 'train' or run.iterations == 0:
        return None
    _, other_ns = run.own_and_other_ns()
    return other_ns / 1e6 / run.iterations if other_ns else None
