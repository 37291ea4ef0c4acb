"""program_idle_share.train: `device_idle_share.train` times the share of the
traced window's device-idle ns inside the port's `gpe.train_step` spans, in
%; the rest is idle time outside the program."""
from benchmark.spans import program_idle_share


def read(run):
    return program_idle_share(run, 'train', 'gpe.train_step')
