"""train_mfu: the training step's counted operations (forward and backward)
over the chip's bf16 peak in the measured (untraced) window, in %."""
from benchmark.readers import model_share_of_peak


def read(run):
    return model_share_of_peak(run, 'train')
