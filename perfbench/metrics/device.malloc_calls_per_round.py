"""The caching allocator's ``cudaMalloc`` + ``cudaFree`` calls a round, each
a device sync: the ``mallocs`` counter of the program's ``exec/chunk``
spans, summed over the traced chunks."""

from pb import tracer


def read(tr):
    return tracer.chunk_count_per_round(tr, "mallocs")
