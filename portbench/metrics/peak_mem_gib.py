"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the
window (reset at its start), less the bytes of the outputs the check
keeps, in GiB: the data the requests cycle over and the program's own
working set of the requests in flight."""


def read(reading):
    if not reading.memory_peak_bytes:
        return None
    return (reading.memory_peak_bytes - reading.kept_bytes) / 2 ** 30
