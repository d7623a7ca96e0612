"""Device milliseconds a round of the uplink compressor's kernels: the
k-th magnitude's selection (``torch.topk``'s kernels) and kernel 2's
threshold select, by the kernel-name fragments the program's on-card
smoke test uses.  The plane's flatten copies are not counted: by name
they cannot be told from the model's other concatenations."""

FRAGMENTS = ("topk", "TopK", "sort", "Sort", "threshold_select_kernel")


def read(tr):
    ms = tr.kernel_s(FRAGMENTS)
    if ms == 0.0 or not tr.rounds:
        return None
    return 1e3 * ms / tr.rounds
