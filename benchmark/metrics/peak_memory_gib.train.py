"""peak_memory_gib.train: torch.cuda.max_memory_allocated() over the measured
training window (its statistics reset at the window's start), in GiB."""


def read(run):
    if run.kind != 'train' or not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
