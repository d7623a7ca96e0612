"""Staleness-adaptive compression: a per-client uplink ratio policy.

The counterpart of :mod:`repro.comm.schedule`.  :class:`RatioSchedule` maps
a client's report age to a top-k keep ratio (``constant``, ``linear`` in the
age, or an explicit ``bucketed`` table).  :class:`ScheduledTopK` threads it
through magnitude top-k with the usual error-feedback stream:
``compress(..., ages=)`` takes the per-client ``last_age`` ledger the
asynchrony stage keeps (``None``: age zero for every client, the
synchronous path), each row keeps its own count -- per-row thresholds for
the threshold-select kernel -- and ``scheduled_bytes`` reports what each
client's transmission costs at its age.  A constant schedule is bitwise the
fixed-ratio
:class:`~repro_torch.comm.transport.TopK`: the keep count comes from the
same ``_k_of`` rounding and the same threshold select keeps the survivors
untouched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.comm.transport import (_TRANSPORTS, Transport,
                                        _check_granularity, _global_dims,
                                        _k_of, _leaf_elements, _map_leaves)
from repro_torch.core import plane as pln
from repro_torch.kernels import ops as kops
from repro_torch.utils import tree as tu

SCHEDULE_KINDS = ("constant", "linear", "bucketed")


@dataclass(frozen=True)
class RatioSchedule:
    """Per-client keep-ratio as a function of observed report age.

    ratio   : the base (age-0) keep ratio; also the hard upper bound.
    kind    : "constant" | "linear" | "bucketed".
    slope   : (linear) ratio lost per round of age.
    floor   : (linear) lower clamp on the ratio.
    buckets : (bucketed) explicit ratio per age bucket; ``buckets[-1]`` is
              the overflow bucket for ages beyond the table.
    """

    ratio: float = 0.1
    kind: str = "constant"
    slope: float = 0.0
    floor: float = 0.02
    buckets: Tuple[float, ...] = ()

    def validate(self) -> None:
        if self.kind not in SCHEDULE_KINDS:
            raise ValueError(f"schedule kind must be one of {SCHEDULE_KINDS},"
                             f" got {self.kind!r}")
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"base ratio must be in (0, 1], got {self.ratio}")
        if self.kind == "linear":
            if self.slope < 0:
                raise ValueError(f"slope must be >= 0, got {self.slope}")
            if not 0.0 < self.floor <= self.ratio:
                raise ValueError(
                    f"floor must be in (0, ratio={self.ratio}], got "
                    f"{self.floor}")
        if self.kind == "bucketed":
            if not self.buckets:
                raise ValueError("bucketed schedule needs a non-empty "
                                 "buckets table")
            for b in self.buckets:
                if not 0.0 < b <= self.ratio:
                    raise ValueError(
                        f"bucket ratios must be in (0, ratio={self.ratio}] "
                        f"(the schedule only hardens), got {b}")

    @property
    def is_constant(self) -> bool:
        return (self.kind == "constant"
                or (self.kind == "linear" and self.slope == 0.0))

    def keep_counts(self, ages: torch.Tensor, d: int) -> torch.Tensor:
        """Per-client kept coordinates (int32) for a flattened dimension
        ``d``.  Constant and bucketed schedules quantize each table ratio
        through the Python-side ``_k_of``, as a fixed transport does; the
        linear one rounds ``ratio - slope*age`` in float32, as the
        reference does."""
        if self.is_constant:
            return torch.full(tuple(ages.shape), _k_of(self.ratio, d),
                              dtype=torch.int32, device=ages.device)
        if self.kind == "bucketed":
            table = torch.tensor([_k_of(r, d) for r in self.buckets],
                                 dtype=torch.int32, device=ages.device)
            ix = torch.clamp(ages.long(), 0, len(self.buckets) - 1)
            return table[ix]
        r = torch.clamp(self.ratio - self.slope * ages.to(torch.float32),
                        self.floor, self.ratio)
        return torch.clamp(torch.round(r * d).to(torch.int32), 1, d)


def as_schedule(policy, ratio: float = 0.1) -> RatioSchedule:
    """Coerce None / a kind name / RatioSchedule to a validated policy."""
    if policy is None:
        policy = RatioSchedule(ratio=ratio)
    elif isinstance(policy, str):
        policy = RatioSchedule(ratio=ratio, kind=policy,
                               slope=0.25 * ratio if policy == "linear"
                               else 0.0,
                               buckets=(ratio, 0.5 * ratio, 0.25 * ratio)
                               if policy == "bucketed" else ())
    if not isinstance(policy, RatioSchedule):
        raise ValueError(f"ratio schedule must be None, a kind name or a "
                         f"RatioSchedule, got {type(policy).__name__}")
    policy.validate()
    return policy


def _rowwise_select(flat, k):
    """Keep the ``k[i]`` largest-magnitude entries of row ``i``.

    The k-th magnitude comes from a descending sort, which equals
    ``torch.topk``'s k-th value, and the select is the threshold-select
    kernel -- so with a uniform ``k`` this is bitwise the fixed TopK.  (The
    reference gates its kernel on tiled planes; the port's kernel takes any
    ``(n, d)`` plane, so leaves and planes both go through it.)
    """
    order = torch.sort(torch.abs(flat), dim=1, descending=True).values
    kth = torch.gather(order, 1, (k.long() - 1)[:, None])[:, 0]
    return kops.plane_threshold_select(flat, kth)


@dataclass(frozen=True)
class ScheduledTopK(Transport):
    """Magnitude top-k whose keep ratio follows a :class:`RatioSchedule`.

    ``ages`` (int, rounds, per client) is the staleness signal; ``None``
    means age zero for every client, which yields the base ratio.  Error
    feedback is threaded exactly as in
    :class:`~repro_torch.comm.transport.TopK`: what the schedule drops
    returns at the client's next transmission.
    """

    schedule: RatioSchedule = RatioSchedule()
    error_feedback: bool = True
    granularity: str = "leaf"
    name: str = "topk_sched"
    wire_encoding: str = "sparse"
    scheduled = True  # compress takes the ages (a class constant, no field)

    def __post_init__(self):
        _check_granularity(self.granularity)
        self.schedule.validate()

    @property
    def ratio(self) -> float:
        """Base (age-0) keep ratio -- what fixed-path byte accounting sees."""
        return self.schedule.ratio

    # -- compression -------------------------------------------------------

    def _keep_counts(self, ages, n: int, d: int, device) -> torch.Tensor:
        if ages is None:
            ages = torch.zeros((n,), dtype=torch.int32, device=device)
        return self.schedule.keep_counts(ages.to(torch.int32), d)

    def compress(self, comm_state, msg, draws=None, ages=None):
        target = tu.tree_add(comm_state, msg) if self.error_feedback else msg
        msg_hat = self.apply(target, draws, ages=ages)
        new_state = (tu.tree_sub(target, msg_hat)
                     if self.error_feedback else ())
        return msg_hat, new_state

    def apply(self, msg, draws=None, ages=None):
        if self.granularity == "global":
            spec = pln.SegmentSpec.from_tree(msg, batch_dims=1)
            return pln.unflatten(
                spec, self.apply_flat(pln.flatten(spec, msg), draws, spec,
                                      ages=ages))
        return self.apply_leaf(msg, draws, ages=ages)

    def apply_leaf(self, msg, draws=None, ages=None):
        def one(x):
            flat = x.reshape(x.shape[0], -1)
            k = self._keep_counts(ages, flat.shape[0], flat.shape[1],
                                  flat.device)
            return _rowwise_select(flat, k).reshape(x.shape)

        return _map_leaves(one, msg)

    def apply_flat(self, flat, draws, spec, ages=None):
        # the k-th magnitude over the padded plane equals the k-th over the
        # valid region (padding is zero and k <= d)
        k = self._keep_counts(ages, flat.shape[0], spec.d, flat.device)
        return _rowwise_select(flat, k)

    # -- flat-plane surface (EngineConfig(plane=True)) ---------------------

    def apply_plane(self, flat, draws, spec, ages=None):
        if self.granularity == "global":
            return self.apply_flat(flat, draws, spec, ages=ages)
        return pln.flatten(spec, self.apply_leaf(pln.unflatten(spec, flat),
                                                 draws, ages=ages))

    def compress_plane(self, comm_state, flat, draws, spec, ages=None):
        target = comm_state + flat if self.error_feedback else flat
        hat = self.apply_plane(target, draws, spec, ages=ages)
        new_state = (target - hat) if self.error_feedback else comm_state
        return hat, new_state

    # -- byte accounting ---------------------------------------------------

    def uplink_bytes(self, msg_template) -> int:
        """Base-ratio (age-0) bytes per client per round: the schedule only
        hardens with age, so this is the per-round upper bound."""
        if self.granularity == "global":
            d, itemsize = _global_dims(msg_template)
            return _k_of(self.ratio, d) * (itemsize + 4)
        return sum(_k_of(self.ratio, _leaf_elements(l))
                   * (l.dtype.itemsize + 4)
                   for l in tu.tree_leaves(msg_template))

    def _bytes_at(self, ages, sizes, itemsize: int) -> torch.Tensor:
        ages = ages.to(torch.int32)
        total = torch.zeros(tuple(ages.shape), dtype=torch.float32,
                            device=ages.device)
        for d in sizes:
            total = total + (self.schedule.keep_counts(ages, d)
                             * (itemsize + 4)).to(torch.float32)
        return total

    def scheduled_bytes(self, msg_template, ages) -> torch.Tensor:
        """Per-client realized wire bytes at the given ages (float32) --
        what the async step emits per commit, so the measured uplink
        traffic follows the schedule, not the static upper bound."""
        if self.granularity == "global":
            d, itemsize = _global_dims(msg_template)
            return self._bytes_at(ages, (d,), itemsize)
        total = torch.zeros(tuple(ages.shape), dtype=torch.float32,
                            device=ages.device)
        for l in tu.tree_leaves(msg_template):
            total = total + self._bytes_at(ages, (_leaf_elements(l),),
                                           l.dtype.itemsize)
        return total

    def scheduled_bytes_flat(self, spec, ages) -> torch.Tensor:
        """:meth:`scheduled_bytes` from a plane
        :class:`~repro_torch.core.plane.SegmentSpec` (the segment sizes
        recover the per-leaf accounting)."""
        itemsize = spec.dtype.itemsize
        if self.granularity == "global":
            return self._bytes_at(ages, (spec.d,), itemsize)
        return self._bytes_at(ages, spec.sizes, itemsize)


def scheduled_transport(transport) -> Optional[ScheduledTopK]:
    """The :class:`ScheduledTopK` behind a transport (unwrapping a
    :class:`~repro_torch.comm.transport.PlaneTransport`), or ``None``."""
    inner = getattr(transport, "inner", transport)
    return inner if isinstance(inner, ScheduledTopK) else None


# by-name construction: get_transport("topk_sched", schedule=RatioSchedule(..))
_TRANSPORTS["topk_sched"] = ScheduledTopK
