"""peak_mem_gib (program counter): torch.cuda.max_memory_allocated() over
the warm-up and the window, read before the comparison runs."""


def read(run):
    if run.peak_alloc_bytes is None:
        return None
    return run.peak_alloc_bytes / 2**30
