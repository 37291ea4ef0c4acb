"""device_idle_share.serve: share of the measured serving window with no device
operation running, in % (busy time per batch from the trace)."""
from benchmark.readers import idle_share


def read(run):
    return idle_share(run, 'serve')
