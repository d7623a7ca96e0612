"""Device milliseconds a round of communication and the commit: the
device intervals of the program's ``exec/compress``, ``exec/server`` and
``exec/broadcast`` spans (the uplink's compressor, the server half, the
downlink)."""

from pb import tracer

NAMES = ("exec/compress", "exec/server", "exec/broadcast")


def read(tr):
    return tracer.device_ms_per_round(tr, NAMES)
