"""dispatch_ms.serve: host ms per traced serving batch inside the port's
`gpe.serve` span (the pipeline call of `build_serving_fn`'s serve)."""
from benchmark.spans import host_ms


def read(run):
    return host_ms(run, 'serve', 'gpe.serve')
