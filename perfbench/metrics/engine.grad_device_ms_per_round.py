"""Device milliseconds a round of the model step: the device intervals of
the program's ``local/grad`` spans (the clients' ``vmap(grad)`` call, one
a local step), on the program's tracer clock."""

from pb import tracer

NAMES = ("local/grad",)


def read(tr):
    return tracer.device_ms_per_round(tr, NAMES)
