"""``torch.cuda.max_memory_reserved()`` over set-up and window, in GiB,
read before the reference runs."""


def read(run):
    return run.peak_bytes / 2 ** 30
