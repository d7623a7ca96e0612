"""Launches of the split-TF32 GEMM kernel a round: the ``split_gemms``
counter of the program's ``exec/chunk`` spans (the wrapper's
``kernels/gemm.split_gemm.launches``), summed over the traced chunks.  One
launch is one float32 product with a weight for all clients: 4 local steps x
(29 forward + 58 backward) = 348 a round in the stablelm cell.  A program
without the counter gives nothing."""

from pb import tracer


def read(tr):
    return tracer.chunk_count_per_round(tr, "split_gemms")
