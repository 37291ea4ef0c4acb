"""launches_per_batch.serve: the port's kernel launches (its launch
counters, every family of kernels/) per traced batch."""


def read(run):
    if run.kind != 'serve' or run.iterations == 0:
        return None
    total = sum(sum(launches.values()) for launches in run.counters.values())
    return total / run.iterations if total else None
