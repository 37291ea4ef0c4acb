"""device_idle_share.train: share of the measured training window with no device
operation running, in % (busy time per step from the trace)."""
from benchmark.readers import idle_share


def read(run):
    return idle_share(run, 'train')
