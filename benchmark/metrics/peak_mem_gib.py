"""Peak device memory of the traced window, GiB: the largest
torch.cuda.max_memory_allocated over the cards after a reset that follows
the warm-up."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
