"""Roofline analysis of the port's traced steps, the card's peak rates, the
multi-process runtime's wire model and the model-FLOP yardstick.

The counterpart of :mod:`repro.roofline.analysis`.  Per (arch x shape x
mesh) three per-step time lower bounds:

    compute term    = FLOPs_per_device / peak_FLOPs_per_card
    memory term     = bytes_per_device / HBM_bandwidth_per_card
    collective term = collective_bytes_per_device / link_bandwidth

The reference reads them from XLA's compiled program (``cost_analysis()``
and the partitioned HLO text).  Here the step is *traced*: it runs once on
fake tensors (no memory, no arithmetic) over a fake-world mesh
(:func:`repro_torch.launch.mesh.fake_world`) under :class:`CostMode`, a
dispatch mode that sees every op each device runs on its local shards:

  * FLOPs -- ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention) over the local shapes: per device, as the reference's;
  * bytes accessed -- each op's local input and output bytes, counted once
    an op.  This is an UNFUSED count (XLA counts fused regions once), so it
    is larger than the reference's (ROADMAP.md, Queue 3);
  * collectives -- every functional collective (``_c10d_functional``) a
    device issues, with its result bytes and group size, which
    :func:`parse_collectives` turns into bytes moved with the reference's
    ring model;
  * memory -- the live bytes of the local tensors the step allocates
    (``args`` in, ``out`` out, ``temp`` the peak of the others), in place
    of XLA's ``memory_analysis()``.

:class:`RooflineReport`, :func:`analyze`, :func:`cost_analysis_dict` and
:func:`parse_collectives` keep the reference's names and fields over a
:class:`TracedStep` in place of XLA's ``compiled``.  The other halves:
hardware constants, the wire term (:class:`WireModel` ...) and the
useful-work yardstick (:func:`model_flops_for`).
"""
from __future__ import annotations

import dataclasses
import json
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 80GB HBM3 (SXM, 700 W), spec-sheet peaks, not measured: dense
# bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# NVLink 4 on the same card, spec sheet, not measured (one card cannot
# measure a link): 900 GB/s bidirectional per GPU, 450 GB/s each way
LINK_BW = 450e9


# ---------------------------------------------------------------------------
# the traced step: FLOPs, bytes, collectives and memory per device
# ---------------------------------------------------------------------------

# functional collectives -> the reference's HLO op names
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_NOT_WORK = ("wait_tensor",)


def _group_size(args, kwargs) -> int:
    """The group size of a functional collective: its ``group_size``
    argument, or the size of the group its ``group_name`` names."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
    for a in args[1:]:
        if isinstance(a, int) and not isinstance(a, bool):
            return a
    raise ValueError("a collective without a group size or a named group")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts what each device runs on its local shards: FLOPs, bytes
    accessed, collectives and live memory (see the module docstring).

    Ops on DTensors are handed back (``NotImplemented``) so that
    DTensor lowers them to local ops and collectives first, which this mode
    then counts; views move no bytes and are skipped."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        # > 0 while DTensor infers an op's global output shape by running it
        # on global-shape fakes: that is metadata, not device work
        self.suspended = 0
        self.flops = 0
        self.bytes = 0
        self.collectives: list = []  # (op, result_bytes, group_size)
        self.live = 0
        self.peak = 0

    def _freed(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                n = _nbytes(t)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._freed, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.suspended:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional"):
            if name not in _NOT_WORK:
                op = _COLLECTIVES.get(name, name)
                rb = sum(_nbytes(t) for t in torch.utils._pytree.tree_leaves(
                    out) if isinstance(t, torch.Tensor))
                self.collectives.append((op, rb, _group_size(args, kwargs)))
                self._track(out)
            return out
        if ns == "prim" or func.is_view:
            return out
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs,
                                                  out_val=out))
        seen: set = set()
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                self.bytes += _nbytes(t)
        if not func._schema.is_mutable:
            self._track(out)
        return out


@dataclasses.dataclass
class TracedStep:
    """What one traced step costs a device: the counterpart of the
    reference's ``compiled`` for :func:`analyze`."""

    flops: float
    bytes: float
    collectives: list
    memory: dict
    replicated_ops: dict = dataclasses.field(default_factory=dict)

    def cost_analysis(self) -> dict:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes)}

    def memory_analysis(self) -> dict:
        return dict(self.memory)


def _tree_local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += _nbytes(t)
    return total


def trace_step(fn, *args, modes=()) -> tuple:
    """Run ``fn(*args)`` once under :class:`CostMode` (outermost) and
    ``modes`` (innermost last); returns ``(out, TracedStep)``.  The args
    are fake or ``meta`` tensors (DTensors of them), so nothing is
    allocated and nothing computes."""
    import contextlib

    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    cm = CostMode()
    infer = ShardingPropagator._propagate_tensor_meta_non_cached

    def shape_only(self, op_schema):
        cm.suspended += 1
        try:
            return infer(self, op_schema)
        finally:
            cm.suspended -= 1

    with contextlib.ExitStack() as stack:
        ShardingPropagator._propagate_tensor_meta_non_cached = shape_only
        stack.callback(setattr, ShardingPropagator,
                       "_propagate_tensor_meta_non_cached", infer)
        stack.enter_context(cm)
        for m in modes:
            stack.enter_context(m)
        out = fn(*args)
    arg_bytes = _tree_local_bytes(args)
    out_bytes = _tree_local_bytes(out)
    return out, TracedStep(
        flops=cm.flops, bytes=cm.bytes, collectives=list(cm.collectives),
        memory={"args": arg_bytes / 1e9, "out": out_bytes / 1e9,
                "temp": max(cm.peak - out_bytes, 0) / 1e9, "alias": 0.0})


def parse_collectives(records):
    """``[(op, result_bytes, group_size, est_moved_bytes_per_device)]`` from
    a traced step's collective records (``(op, result_bytes, group_size)``)
    with the reference's ring-algorithm estimates."""
    out = []
    for op, rb, g in records:
        ring = (g - 1) / g if g > 1 else 0.0
        if op == "all-reduce":
            moved = 2 * rb * ring
        elif op == "all-gather":
            moved = rb * ring
        elif op == "reduce-scatter":
            moved = rb * (g - 1)
        elif op == "all-to-all":
            moved = rb * ring
        else:  # collective-permute, and any other collective
            moved = rb
        out.append((op, rb, g, moved))
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    step_kind: str
    n_chips: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # 6*N_active*D (or 2*N*D for inference) GLOBAL
    useful_ratio: float  # model_flops / (flops_per_dev * n_chips)
    memory_per_dev_gb: dict
    collective_breakdown: dict
    n_collectives: int
    note: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def summary(self) -> str:
        return (
            f"{self.arch:>20s} {self.shape:>12s} {self.mesh:>6s} | "
            f"comp {self.compute_s*1e3:9.3f}ms  mem {self.memory_s*1e3:9.3f}ms  "
            f"coll {self.collective_s*1e3:9.3f}ms -> {self.dominant:10s} | "
            f"useful {self.useful_ratio:6.1%} | "
            f"temp {self.memory_per_dev_gb.get('temp', 0):6.2f}GB/dev"
        )


def cost_analysis_dict(compiled) -> dict:
    """``{"flops", "bytes accessed"}`` per device of a traced step."""
    ca = compiled.cost_analysis() or {}
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return ca


def analyze(compiled, *, arch: str, shape: str, mesh_name: str, n_chips: int,
            step_kind: str, model_flops: float,
            note: str = "") -> RooflineReport:
    ca = cost_analysis_dict(compiled)
    flops = float(ca.get("flops", 0.0))
    byts = float(ca.get("bytes accessed", 0.0))
    colls = parse_collectives(compiled.collectives)
    coll_bytes = sum(c[3] for c in colls)
    breakdown: dict[str, float] = {}
    for op, rb, g, moved in colls:
        breakdown[op] = breakdown.get(op, 0.0) + moved

    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = coll_bytes / LINK_BW
    dominant = max(
        [("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)],
        key=lambda kv: kv[1],
    )[0]
    total_flops = flops * n_chips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, step_kind=step_kind,
        n_chips=n_chips, flops_per_dev=flops, bytes_per_dev=byts,
        coll_bytes_per_dev=coll_bytes, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant, model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
        memory_per_dev_gb=compiled.memory_analysis(),
        collective_breakdown=breakdown,
        n_collectives=len(colls),
        note=note,
    )


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
