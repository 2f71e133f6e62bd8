"""peak_mem_gib (GiB): the allocator's peak over the window's steps
(``torch.cuda.max_memory_allocated``; the trainer resets it before each
step, so the window's peak is the largest step's)."""


def read(run):
    return run.peak_bytes / 2**30
