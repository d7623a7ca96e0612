"""Kernels 5 and 5b (attention's forward and backward) against their
bound: for each launch the larger of its operations at 495 TFLOP/s and its
bytes at 3.35 TB/s, summed over the traced rounds, over their summed
device time (the backward's delta pre-pass included)."""

FRAGMENTS = ("flash_",)


def read(tr):
    dev = tr.kernel_s(FRAGMENTS)
    if dev == 0.0 or "flash_bound_s_per_round" not in tr.costs:
        return None
    return 100.0 * tr.costs["flash_bound_s_per_round"] * tr.rounds / dev
