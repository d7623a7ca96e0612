"""Roofline terms that need no compiled program: the card's peak rates, the
multi-process runtime's wire model and the model-FLOP yardstick.

The counterpart of :mod:`repro.roofline.analysis` for one card:

  * hardware constants -- the peak rates a per-step lower bound divides
    by;
  * the wire term (:class:`WireModel`, :func:`uplink_nbytes`,
    :func:`chunk_times`, :func:`crossover_ratio`) -- the worker -> server
    uplink of :mod:`repro_torch.fed.runtime`, plain float arithmetic, so it
    equals the reference's bitwise;
  * the useful-work yardstick (:func:`analytic_param_counts`,
    :func:`model_flops_for`) -- 6 N D for training, 2 N D for inference,
    from a params structure of ``meta`` tensors
    (:func:`abstract_params`), so a full-width model costs no memory.

The reference's other half reads XLA's compiled artifacts (``analyze``,
``RooflineReport``, ``cost_analysis_dict``, ``parse_collectives``); it comes
with the dry-run slice (ROADMAP.md, Queue 1), whose PyTorch counterpart
counts FLOPs with ``torch.utils.flop_counter`` on fake tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 80GB HBM3 (SXM, 700 W), spec-sheet peaks, not measured: dense
# bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12


# ---------------------------------------------------------------------------
# analytic model FLOPs (the "useful work" yardstick)
# ---------------------------------------------------------------------------


def abstract_params(cfg):
    """The params structure of ``cfg`` as ``meta`` tensors: shapes and
    dtypes only (the counterpart of ``jax.eval_shape`` on ``init_model``)."""
    import torch

    from repro_torch.device import eval_shape
    from repro_torch.models import transformer as T

    return eval_shape(lambda: T.init_model(torch.Generator(), cfg))


def analytic_param_counts(cfg, params_struct) -> tuple[int, int]:
    """(total_params, active_params): active discounts inactive MoE
    experts."""
    from repro_torch.utils.tree import tree_leaves

    total = sum(int(l.numel()) for l in tree_leaves(params_struct))
    if cfg.moe is None:
        return total, total
    E, K, F = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert
    per_expert = 3 * cfg.d_model * F
    n_moe_layers = sum(
        1 for _ in range(cfg.n_periods)
    ) * len(cfg.block_pattern) if cfg.mlp_kind == "moe" else 0
    inactive = n_moe_layers * (E - K) * per_expert
    return total, total - inactive


def model_flops_for(cfg, shape, params_struct, tau: int = 1) -> float:
    """6*N_active*D for training (D = tokens incl. tau local steps);
    2*N_active*D for prefill; 2*N_active*B for one decode step."""
    total, active = analytic_param_counts(cfg, params_struct)
    # the embedding table lookup is a gather (~0 matmul flops); the tied
    # unembed matmul IS counted via the table, which slightly overcounts for
    # tied models -- the reference's documented approximation
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len * tau
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch  # decode: one token per request


# ---------------------------------------------------------------------------
# wire term: the uplink bandwidth bound for the multi-process runtime
# ---------------------------------------------------------------------------
#
# The multi-process runtime (repro_torch.fed.runtime) adds a time term no
# compiler sees: the worker->server uplink crossing a real socket.  Per
# engine chunk the worker ships `rounds_per_chunk` server messages (plus its
# committed server fields), and either
#
#     blocking:    t_chunk ~ compute_s + wire_s        (send on compute thread)
#     overlapped:  t_chunk ~ max(compute_s, wire_s)    (send on sender thread)
#
# so overlap hides min(compute_s, wire_s) of the wire time.  The design
# point is the comm/compute crossover: the compression ratio r* at which
# wire_s == compute_s.  Below r* the overlapped runtime is compute bound
# (the wire is free); above it the wire is the roofline however the send is
# scheduled.

WIRE_BW = 1e9        # bytes/s -- ~10GbE payload rate; override per deployment
WIRE_LATENCY = 50e-6  # seconds per frame (syscall + ACK round-trip floor)

# sparse wire encoding ships (index, value) pairs per surviving entry
# (repro_torch.comm.wire pack_plane), so r of the entries cost r*(1 +
# idx/val) of the dense bytes -- clamped at 1.0 by the codec's dense
# fallback.
SPARSE_INDEX_OVERHEAD = 1.0  # idx_itemsize / val_itemsize (i64 idx, f64 vals)


@dataclasses.dataclass
class WireModel:
    """Analytic time model for one uplink frame over the runtime socket."""

    bw: float = WIRE_BW
    latency_s: float = WIRE_LATENCY

    def seconds(self, nbytes: float) -> float:
        return self.latency_s + float(nbytes) / self.bw


def uplink_nbytes(dense_nbytes: float, ratio: float, *,
                  encoding: str = "sparse",
                  index_overhead: float = SPARSE_INDEX_OVERHEAD) -> float:
    """Predicted payload bytes for one message at compression ``ratio``.

    ``dense_nbytes`` is the raw message size (n_clients * d * itemsize for
    a plane chunk row).  ``sparse`` models top-k/rand-k (index+value pairs,
    dense fallback clamp); ``palette`` models the quantizer (codes shrink
    with ratio = bits/bitwidth, plus the per-row table folded into the
    clamp); ``dense`` ignores ratio.
    """
    if encoding == "dense":
        return float(dense_nbytes)
    if encoding == "sparse":
        return float(dense_nbytes) * min(1.0, ratio * (1.0 + index_overhead))
    if encoding == "palette":
        return float(dense_nbytes) * min(1.0, ratio)
    raise ValueError(f"unknown wire encoding {encoding!r}")


def chunk_times(compute_s: float, wire_s: float) -> dict:
    """Per-chunk wall-time predictions for the three runtime modes, plus
    the fraction of the blocking-mode send overhead that overlap hides."""
    blocking = compute_s + wire_s
    overlapped = max(compute_s, wire_s)
    hidden = ((blocking - overlapped) / wire_s) if wire_s > 0 else 1.0
    return {"single": compute_s, "blocking": blocking,
            "overlapped": overlapped, "hidden_fraction": hidden}


def crossover_ratio(compute_s: float, dense_nbytes: float,
                    model: Optional[WireModel] = None, *,
                    encoding: str = "sparse",
                    index_overhead: float = SPARSE_INDEX_OVERHEAD) -> float:
    """The compression ratio r* where uplink wire time equals compute time.

    For r < r* the overlapped runtime is compute bound; for r > r* it is
    wire bound.  Returns +inf when even the dense message transfers faster
    than the chunk computes (the wire never becomes the roofline).
    """
    model = model or WireModel()
    budget_bytes = (compute_s - model.latency_s) * model.bw
    if budget_bytes <= 0:
        return 0.0
    if budget_bytes >= uplink_nbytes(dense_nbytes, 1.0, encoding=encoding,
                                     index_overhead=index_overhead):
        return float("inf")
    if encoding == "sparse":
        return (budget_bytes / dense_nbytes) / (1.0 + index_overhead)
    if encoding == "palette":
        return budget_bytes / dense_nbytes
    return float("inf")  # dense: ratio has no effect; handled by clamp above
