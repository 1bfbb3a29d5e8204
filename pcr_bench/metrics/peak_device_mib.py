"""The card's peak of allocated memory over set-up and window (MiB), from
``torch.cuda.max_memory_allocated`` after a reset at process start."""


def read(run):
    return run.peak_bytes / 2**20 if run.peak_bytes else None
