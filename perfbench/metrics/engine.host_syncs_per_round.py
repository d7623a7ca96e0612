"""Host synchronisations a round: the ``syncs`` counter of the program's
``exec/chunk`` spans (PyTorch's sync-debug mode, counted while the tracer
is installed), summed over the traced chunks.  A chunk's own host sync
counts: a healthy chunk of 4 rounds reads 0.25 a round."""

from pb import tracer


def read(tr):
    return tracer.chunk_count_per_round(tr, "syncs")
