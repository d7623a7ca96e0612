"""The share of the traced window in which no operation ran on the
device: one less the union of the kernels' intervals over the window."""


def read(tr):
    busy = tr.busy_s()
    if busy == 0.0:
        return None
    return 100.0 * (1.0 - busy / tr.window_s)
