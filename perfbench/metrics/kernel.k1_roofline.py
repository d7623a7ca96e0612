"""Kernel 1 (the fused local update and L1 prox) against its bytes
bound: five client-wide planes a local step (z_hat, gradient, correction
read; z_hat, z written) at 3.35 TB/s, over the device time of its
launches in the traced rounds."""

FRAGMENTS = ("fused_leaves_kernel", "fused_prox_kernel")


def read(tr):
    dev = tr.kernel_s(FRAGMENTS)
    if dev == 0.0:
        return None
    return 100.0 * tr.costs["k1_bound_s_per_round"] * tr.rounds / dev
