"""The whole step's share of the chip's peak: the model's operations over
the traced rounds (``costs_of``: 6 N per token plus causal attention for a
transformer, convolutions and dense layers for the CNN; no recomputation),
over the traced window, against dense TF32 (495 TFLOP/s), the fastest rate
an H100 multiplies float32 operands at."""

from pb import costs


def read(tr):
    if tr.busy_s() == 0.0:
        return None
    flops = tr.costs["model_flops_per_round"] * tr.rounds
    return 100.0 * flops / tr.window_s / costs.TF32_FLOPS
