"""Device milliseconds a round of the local update: the device intervals
of the program's ``local/update`` spans (the gradients' cast, kernel 1, the
gradient and loss sums; one a local step)."""

from pb import tracer

NAMES = ("local/update",)


def read(tr):
    return tracer.device_ms_per_round(tr, NAMES)
