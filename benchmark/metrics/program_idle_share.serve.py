"""program_idle_share.serve: `device_idle_share.serve` times the share of the
traced window's device-idle ns inside the port's `gpe.serve` spans, in %; the
rest is idle time outside the program (send, copy-back, synchronize)."""
from benchmark.spans import program_idle_share


def read(run):
    return program_idle_share(run, 'serve', 'gpe.serve')
