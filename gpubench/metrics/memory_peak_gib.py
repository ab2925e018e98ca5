"""memory_peak_gib: the run's peak of device memory held by tensors
(``torch.cuda.max_memory_allocated``, the caching allocator's counter,
set-up and window together), in GiB.  The capacity tier's promise is
the two planes plus at most 1 GiB.  No reading without a card."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / (1 << 30)
