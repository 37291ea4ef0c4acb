"""serve_mfu: the served forward's counted operations over the chip's bf16 peak
in the measured (untraced) window, in % (yardstick.model_operations)."""
from benchmark.readers import model_share_of_peak


def read(run):
    return model_share_of_peak(run, 'serve')
