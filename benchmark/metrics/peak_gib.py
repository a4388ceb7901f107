"""peak_gib (GiB): torch.cuda.max_memory_allocated() over the window,
reset at its start: the resident likelihood and whatever the jobs add."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
