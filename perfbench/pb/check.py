"""The comparison that decides ``correct``: the program's checked rounds
(round 1, then one chunk) against the reference's, by up to three
numbers, each with its limit from the cell's traffic file.

  * ``loss_gap``: the largest relative gap of a round's train loss, over
    the first ``loss_rounds`` rounds (the traffic's, else all);
  * ``grad1_gap``: the first round's gradient, by the worst leaf: the gap
    between the program's norm of the leaf and the reference's, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger (some gradients are all but zero);
  * ``dx_gap``: the change of ``x_bar`` after the checked rounds, by the
    worst leaf in the same way.  A leaf whose reference gradient is under a
    thousandth of the median leaf's moves by round-off alone and is left
    out (none is, in either configuration).

A cell compares the numbers its traffic file gives limits for.  A number
that is not finite fails its limit.
"""
from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad1_gap", "dx_gap")
MOVED = 1e-3  # a leaf moves if its reference gradient reaches this x median


def leaf_gap(got: dict, ref: dict, keys=None) -> float:
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in ref)
    worst = 0.0
    for k in keys:
        gap = abs(got[k] - ref[k]) / max(ref[k], med)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def loss_gaps(got: dict, ref: dict) -> list:
    """The relative gap of each round's train loss."""
    return [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(got["loss"], ref["loss"])]


def gaps(got: dict, ref: dict, loss_rounds=None) -> dict:
    """The three numbers of ``got`` (the program's readings, or a
    control's) against ``ref``."""
    loss = max(loss_gaps(got, ref)[:loss_rounds])
    med = statistics.median(ref["grad1"].values())
    moved = [k for k, g in ref["grad1"].items() if g >= MOVED * med]
    return {"loss_gap": loss,
            "grad1_gap": leaf_gap(got["grad1"], ref["grad1"]),
            "dx_gap": leaf_gap(got["dx"], ref["dx"], moved)}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES
           if k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
