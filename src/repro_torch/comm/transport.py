"""Uplink compressors behind one ``Transport`` interface.

The counterpart of :mod:`repro.comm.transport`.  A *transport* decides what
crosses the network when a client sends its per-round uplink message (the
pytree produced by an algorithm's ``make_local_fn``; every leaf carries a
leading client axis).  Messages are *innovations*, so zeroing or coarsening
coordinates degrades gracefully.  The engine compresses the message between
the local and server halves of a round when the UplinkComm stage is active
(``EngineConfig(transport=...)``).

  * :class:`Dense`    -- identity (the paper's full d-vector per round);
  * :class:`TopK`     -- magnitude top-k per client (a biased contraction);
  * :class:`RandK`    -- uniform random-k with the d/k rescaling (unbiased);
  * :class:`Quantize` -- per-client stochastic uniform quantization to
    ``2^bits - 1`` levels (unbiased given the scale).

Compressing transports carry **error feedback**: ``m_hat = C(e + m)``,
``e' = e + m - m_hat``, so ``sum_t m_hat_t = sum_t m_t - e_T`` exactly.

**Granularity.**  ``"leaf"`` compresses each ``(n_clients, d_leaf)`` leaf
on its own; ``"global"`` flattens the client's whole message onto one plane
(:mod:`repro_torch.core.plane`) and compresses it as a single d-vector.
Both go through the same two kernels on CUDA tensors
(:mod:`repro_torch.kernels.plane_ops`): the threshold select after
``torch.topk`` finds each row's k-th magnitude (the reference takes it from
``lax.top_k`` outside its Pallas kernel), and the quantizer.  On CPU tensors
the kernels' plain versions run, which equal the reference bitwise.

**Randomness.**  The reference threads a ``jax.random`` key; the port takes
an explicit *draw source* instead: an object with ``uniform(shape, dtype,
device)`` and ``permutation(n, device)`` (and, for the clocks of
:mod:`repro_torch.sched`, ``normal(shape, dtype, device)`` and
``bernoulli(p, shape, device)``), consumed in a fixed order (leaves
in ``jax.tree_util`` order, then rows in order).  :class:`GeneratorDraws`
is backed by a seeded ``torch.Generator``; :class:`ReplayDraws` replays a
recorded list of arrays (the tests replay the reference's ``jax.random``
draws through it).  ``stochastic = False`` transports draw nothing and take
``draws=None``.

``uplink_bytes`` reports the per-client wire cost of one message.  Message
templates are tensors of the message's shapes and dtypes on any device
(``meta`` tensors cost nothing), standing in for the reference's
``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import plane as pln
from repro_torch.kernels import ops as kops
from repro_torch.utils import tree as tu

Message = Any  # pytree whose leaves have a leading client axis

GRANULARITIES = ("leaf", "global")


# ---------------------------------------------------------------------------
# draw sources
# ---------------------------------------------------------------------------


class GeneratorDraws:
    """Draws from a ``torch.Generator`` seeded with ``seed`` that lives on
    ``device``; each draw is moved to the device it is asked for.  A
    generator on the CPU gives the same numbers whatever device consumes
    them, which is how a run on the card is held against a run on the
    CPU."""

    def __init__(self, seed: int, device="cpu"):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, shape, dtype, device) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, dtype=dtype,
                       device=self.device)
        return u.to(device)

    def permutation(self, n: int, device) -> torch.Tensor:
        p = torch.randperm(int(n), generator=self.generator,
                           device=self.device)
        return p.to(device)

    def normal(self, shape, dtype, device) -> torch.Tensor:
        z = torch.randn(tuple(shape), generator=self.generator, dtype=dtype,
                        device=self.device)
        return z.to(device)

    def bernoulli(self, p: float, shape, device) -> torch.Tensor:
        """Boolean draws, True with probability ``p`` (a float32 uniform
        below ``p``, as ``jax.random.bernoulli`` draws them)."""
        return self.uniform(shape, torch.float32, device) < p

    def gumbel(self, shape, dtype, device) -> torch.Tensor:
        """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform on
        ``[tiny, 1)``, as ``jax.random.gumbel`` draws them."""
        u = torch.rand(tuple(shape), generator=self.generator, dtype=dtype,
                       device=self.device)
        u.clamp_min_(torch.finfo(dtype).tiny)
        return (-torch.log(-torch.log(u))).to(device)


class ReplayDraws:
    """Replays a recorded sequence of draws (numpy arrays or tensors) in
    order; raises when a draw's shape does not match or the record runs
    out."""

    def __init__(self, draws):
        self._draws = list(draws)
        self._next = 0

    def _pop(self, shape):
        if self._next >= len(self._draws):
            raise ValueError(f"replay exhausted after {self._next} draws")
        x = self._draws[self._next]
        if tuple(np.shape(x)) != tuple(shape):
            raise ValueError(f"replayed draw {self._next} has shape "
                             f"{tuple(np.shape(x))}, expected {tuple(shape)}")
        self._next += 1
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.array(x))

    @property
    def remaining(self) -> int:
        return len(self._draws) - self._next

    def uniform(self, shape, dtype, device) -> torch.Tensor:
        return self._pop(shape).to(device=device, dtype=dtype)

    def permutation(self, n: int, device) -> torch.Tensor:
        return self._pop((int(n),)).to(device=device, dtype=torch.int64)

    def normal(self, shape, dtype, device) -> torch.Tensor:
        return self._pop(shape).to(device=device, dtype=dtype)

    def bernoulli(self, p: float, shape, device) -> torch.Tensor:
        return self._pop(shape).to(device=device, dtype=torch.bool)

    def gumbel(self, shape, dtype, device) -> torch.Tensor:
        return self._pop(shape).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _k_of(ratio: float, d: int) -> int:
    """Coordinates kept per client for one flattened leaf of size d (Python's
    ``round``, ties to even, as the reference)."""
    return max(1, min(d, int(round(ratio * d))))


def _leaf_elements(leaf) -> int:
    """Elements per client: the leaf's size without its client axis."""
    n = 1
    for s in tuple(leaf.shape)[1:]:
        n *= int(s)
    return n


def message_elements_per_client(msg_template) -> int:
    """Uplink coordinates per client per round (sums over message leaves)."""
    return sum(_leaf_elements(l) for l in tu.tree_leaves(msg_template))


def _global_dims(msg_template) -> tuple[int, int]:
    """(total d per client, itemsize) of a message compressed globally; the
    message must hold one dtype (one contiguous plane)."""
    leaves = tu.tree_leaves(msg_template)
    dtypes = {l.dtype for l in leaves}
    if len(dtypes) != 1:
        raise ValueError(
            "granularity='global' compresses one contiguous plane and "
            f"needs a single-dtype message; got {sorted(map(str, dtypes))}")
    return (sum(_leaf_elements(l) for l in leaves), dtypes.pop().itemsize)


def _check_granularity(granularity: str) -> None:
    if granularity not in GRANULARITIES:
        raise ValueError(f"granularity must be one of {GRANULARITIES}, got "
                         f"{granularity!r}")


def _kth_magnitude(mag, k: int):
    """(rows,) k-th largest value of each row of ``mag`` (``lax.top_k``'s
    k-th value in the reference)."""
    return torch.topk(mag, k, dim=1).values[:, -1]


def _map_leaves(fn, msg):
    """``fn(leaf)`` over the leaves in ``jax.tree_util`` order (the order
    draws are consumed in), rebuilt into ``msg``'s structure."""
    leaves, spec = tu.tree_flatten(msg)
    return tu.tree_unflatten(spec, [fn(l) for l in leaves])


def _rowmask(flat, idx):
    """A (n, d) 0/1 mask in ``flat``'s dtype with ones at ``idx`` (n, k)."""
    mask = torch.zeros_like(flat)
    return mask.scatter_(1, idx, 1)


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class Transport:
    """Interface: ``init_state`` -> per-run compressor state (error-feedback
    residuals, or ``()``), ``compress`` -> (what the server receives, next
    compressor state).  ``draws`` is a draw source; deterministic transports
    (``stochastic = False``) ignore it."""

    name: str = "base"
    error_feedback: bool = False
    stochastic: bool = False
    # natural wire re-encoding of this transport's output:
    # "dense" | "sparse" | "palette"
    wire_encoding: str = "dense"
    granularity: str = "leaf"

    def init_state(self, msg_template):
        if not self.error_feedback:
            return ()
        return tu.tree_map(
            lambda l: torch.zeros(tuple(l.shape), dtype=l.dtype,
                                  device=l.device), msg_template)

    def compress(self, comm_state, msg: Message, draws=None):
        target = tu.tree_add(comm_state, msg) if self.error_feedback else msg
        msg_hat = self.apply(target, draws)
        new_state = (tu.tree_sub(target, msg_hat)
                     if self.error_feedback else ())
        return msg_hat, new_state

    def apply(self, msg: Message, draws=None) -> Message:
        if self.granularity == "global":
            spec = pln.SegmentSpec.from_tree(msg, batch_dims=1)
            return pln.unflatten(
                spec, self.apply_flat(pln.flatten(spec, msg), draws, spec))
        return self.apply_leaf(msg, draws)

    def apply_leaf(self, msg: Message, draws=None) -> Message:
        """The per-(client, leaf) compression."""
        raise NotImplementedError

    def apply_flat(self, flat, draws, spec: pln.SegmentSpec):
        """Global compression of the (n_clients, d_pad) plane (valid region
        ``spec.d``; the zero padding must stay zero)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no global-granularity form")

    # -- the flat-plane surface (EngineConfig(plane=True)) -----------------

    def apply_plane(self, flat, draws, spec: pln.SegmentSpec):
        """``apply`` on a (n_clients, d_pad) plane.  Global granularity runs
        directly on the plane; leaf granularity routes through pytree views,
        so it is bitwise the per-leaf path."""
        if self.granularity == "global":
            return self.apply_flat(flat, draws, spec)
        return pln.flatten(spec, self.apply_leaf(pln.unflatten(spec, flat),
                                                 draws))

    def compress_plane(self, comm_state, flat, draws,
                       spec: pln.SegmentSpec):
        """``compress`` with a flat (n_clients, d_pad) error-feedback buffer
        -- one residual for the whole message."""
        target = comm_state + flat if self.error_feedback else flat
        hat = self.apply_plane(target, draws, spec)
        new_state = (target - hat) if self.error_feedback else comm_state
        return hat, new_state

    def select_clients(self, mask, new_state, old_state):
        """Advance the compressor state only for the clients in ``mask``:
        error feedback must not advance for a client that did not transmit
        this round, or the telescoping identity breaks."""
        if not self.error_feedback:
            return new_state
        return tu.tree_map(
            lambda n, o: torch.where(
                mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, o),
            new_state, old_state)

    def uplink_bytes(self, msg_template) -> int:
        """Bytes on the wire per client per round for this message."""
        raise NotImplementedError


@dataclass(frozen=True)
class Dense(Transport):
    """Identity transport: the full message is sent (ratio 1.0)."""

    name: str = "dense"
    error_feedback: bool = False

    def apply(self, msg, draws=None):
        return msg

    def apply_plane(self, flat, draws, spec):
        return flat

    def uplink_bytes(self, msg_template):
        return sum(_leaf_elements(l) * l.dtype.itemsize
                   for l in tu.tree_leaves(msg_template))


@dataclass(frozen=True)
class TopK(Transport):
    """Keep the ``ratio`` fraction of largest-magnitude coordinates per
    client -- per leaf (``granularity="leaf"``) or over the client's whole
    message (``"global"``).  Ties at the k-th magnitude are all kept.
    ``ratio=1.0`` is exactly the identity."""

    ratio: float = 0.1
    error_feedback: bool = True
    granularity: str = "leaf"
    name: str = "topk"
    wire_encoding: str = "sparse"

    def __post_init__(self):
        _check_granularity(self.granularity)

    def apply_leaf(self, msg, draws=None):
        def one(x):
            flat = x.reshape(x.shape[0], -1)
            k = _k_of(self.ratio, flat.shape[1])
            if k >= flat.shape[1]:
                return x
            kth = _kth_magnitude(torch.abs(flat), k)
            return kops.plane_threshold_select(flat, kth).reshape(x.shape)

        return _map_leaves(one, msg)

    def apply_flat(self, flat, draws, spec):
        k = _k_of(self.ratio, spec.d)
        if k >= spec.d:
            return flat
        # the k-th magnitude over the padded plane equals the k-th over the
        # valid region (padding is zero and k <= d), so no masking is needed
        # and selected padding zeros stay zero
        kth = _kth_magnitude(torch.abs(flat), k)
        return kops.plane_threshold_select(flat, kth)

    def uplink_bytes(self, msg_template):
        if self.granularity == "global":
            d, itemsize = _global_dims(msg_template)
            return _k_of(self.ratio, d) * (itemsize + 4)  # value + int32 idx
        return sum(_k_of(self.ratio, _leaf_elements(l))
                   * (l.dtype.itemsize + 4)
                   for l in tu.tree_leaves(msg_template))


@dataclass(frozen=True)
class RandK(Transport):
    """Keep ``ratio * d`` uniformly random coordinates per client (per leaf,
    or over the whole message), rescaled by d/k so that E[C(x)] = x.  Each
    row draws one permutation of its d coordinates and keeps the first
    k."""

    ratio: float = 0.1
    error_feedback: bool = True
    rescale: bool = True
    granularity: str = "leaf"
    name: str = "randk"
    stochastic: bool = True
    wire_encoding: str = "sparse"

    def __post_init__(self):
        _check_granularity(self.granularity)

    def _masked(self, flat, d: int, k: int, draws):
        """``flat`` (n, width >= d) times a mask of k coordinates per row
        drawn over the first d, times the rescale."""
        idx = torch.stack([draws.permutation(d, flat.device)[:k]
                           for _ in range(flat.shape[0])])
        scale = torch.tensor(d / k if self.rescale else 1.0,
                             dtype=flat.dtype, device=flat.device)
        return flat * _rowmask(flat, idx) * scale

    def apply_leaf(self, msg, draws=None):
        def one(x):
            flat = x.reshape(x.shape[0], -1)
            d = flat.shape[1]
            k = _k_of(self.ratio, d)
            if k >= d:
                return x
            return self._masked(flat, d, k, draws).reshape(x.shape)

        return _map_leaves(one, msg)

    def apply_flat(self, flat, draws, spec):
        k = _k_of(self.ratio, spec.d)
        if k >= spec.d:
            return flat
        # indices drawn over the valid region only: padding stays zero
        return self._masked(flat, spec.d, k, draws)

    def uplink_bytes(self, msg_template):
        # indices are derivable from a shared seed: values only
        if self.granularity == "global":
            d, itemsize = _global_dims(msg_template)
            return _k_of(self.ratio, d) * itemsize
        return sum(_k_of(self.ratio, _leaf_elements(l)) * l.dtype.itemsize
                   for l in tu.tree_leaves(msg_template))


@dataclass(frozen=True)
class Quantize(Transport):
    """Per-client stochastic uniform quantization to ``2^bits - 1`` levels,
    scaled by the per-(client, leaf) -- or, globally, per-client -- max
    magnitude.  Unbiased given the scale."""

    bits: int = 8
    error_feedback: bool = True
    granularity: str = "leaf"
    name: str = "quantize"
    stochastic: bool = True
    wire_encoding: str = "palette"

    def __post_init__(self):
        _check_granularity(self.granularity)

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1

    def _quantize(self, flat, draws):
        s = torch.amax(torch.abs(flat), dim=1)
        u = draws.uniform(flat.shape, flat.dtype, flat.device)
        return kops.plane_quantize(flat, u, s, self.levels)

    def apply_leaf(self, msg, draws=None):
        return _map_leaves(
            lambda x: self._quantize(x.reshape(x.shape[0], -1),
                                     draws).reshape(x.shape), msg)

    def apply_flat(self, flat, draws, spec):
        # ONE scale per client: the padding zeros never win the max, and
        # quantize(0) == 0 keeps the padded tail zero
        return self._quantize(flat, draws)

    def uplink_bytes(self, msg_template):
        if self.granularity == "global":
            d, itemsize = _global_dims(msg_template)
            # packed signed levels for the whole d-vector + ONE fp scale
            return -(-d * (self.bits + 1) // 8) + itemsize
        # signed levels: bits for the magnitude plus a sign bit per
        # coordinate, plus the per-leaf fp scale
        return sum(-(-_leaf_elements(l) * (self.bits + 1) // 8)
                   + l.dtype.itemsize for l in tu.tree_leaves(msg_template))


@dataclass(frozen=True)
class DownlinkCompressor:
    """Server-side compression of the broadcast (downlink) innovation.

    Any :class:`Transport` compresses the delta between the server's new
    state and the shadow ``seen`` the clients hold:

        m_r        = x_{r+1} - seen_r
        seen_{r+1} = x_{r+1} - (m_r - C(m_r))

    The shadow is the error-feedback state (``x - seen`` is the standing
    residual), written subtractively so that ``C = id`` reproduces the true
    state bitwise.  Leaves are lifted to a leading axis of one ("one
    sender"), so the per-client transports -- and their kernels, with one
    row -- serve the broadcast; ``downlink_bytes`` is the per-receiver wire
    cost of one broadcast.
    """

    transport: Transport
    name: str = "downlink"

    def _lift(self, tree):
        return tu.tree_map(lambda l: l[None], tree)

    def init_state(self, server_fields):
        """``server_fields``: the broadcast server state (e.g. the
        'server'-role fields of an algorithm's state)."""
        return {"seen": self._lift(tu.tree_map(torch.as_tensor,
                                               server_fields))}

    def broadcast(self, dl_state, server_fields, draws=None):
        """Compress ``server_fields - seen``; returns (what the clients now
        hold, next downlink state)."""
        new = self._lift(server_fields)
        innov = tu.tree_sub(new, dl_state["seen"])
        innov_hat = self.transport.apply(innov, draws)
        seen = tu.tree_sub(new, tu.tree_sub(innov, innov_hat))
        visible = tu.tree_map(lambda l: l[0], seen)
        return visible, {"seen": seen}

    def downlink_bytes(self, server_template) -> int:
        """Bytes on the wire per receiver for one broadcast."""
        spec = tu.tree_map(
            lambda l: torch.empty((1,) + tuple(l.shape), dtype=l.dtype,
                                  device="meta"), server_template)
        return self.transport.uplink_bytes(spec)


def broadcast_elements(server_template) -> int:
    """Coordinates per receiver of one broadcast pytree."""
    total = 0
    for l in tu.tree_leaves(server_template):
        n = 1
        for s in tuple(l.shape):
            n *= int(s)
        total += n
    return total


@dataclass(frozen=True)
class PlaneTransport:
    """Adapter running any :class:`Transport` on ``(n_clients, d_pad)``
    planes with a *flat* error-feedback buffer (``EngineConfig(plane=True)``):
    one residual plane instead of a pytree of per-leaf residuals, and
    global-granularity transports never build the pytree view at all.
    """

    inner: Transport
    spec: pln.SegmentSpec

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def error_feedback(self) -> bool:
        return self.inner.error_feedback

    @property
    def stochastic(self) -> bool:
        return self.inner.stochastic

    @property
    def wire_encoding(self) -> str:
        return self.inner.wire_encoding

    @property
    def scheduled(self) -> bool:
        """True when the wrapped transport follows a staleness-adaptive
        ratio schedule (its ``compress`` takes the per-client ages)."""
        return getattr(self.inner, "scheduled", False)

    def init_state(self, flat_template):
        if not self.inner.error_feedback:
            return ()
        return torch.zeros(tuple(flat_template.shape),
                           dtype=flat_template.dtype,
                           device=flat_template.device)

    def compress(self, comm_state, flat, draws=None, ages=None):
        if ages is not None:
            return self.inner.compress_plane(comm_state, flat, draws,
                                             self.spec, ages=ages)
        return self.inner.compress_plane(comm_state, flat, draws, self.spec)

    def scheduled_bytes(self, msg_template, ages):
        """Per-client realized bytes under the wrapped ratio schedule; the
        plane spec stands in for the pytree template."""
        return self.inner.scheduled_bytes_flat(self.spec, ages)

    def select_clients(self, mask, new_state, old_state):
        """Per-client-row advance guard on the flat residual."""
        if not self.inner.error_feedback:
            return new_state
        return torch.where(mask[:, None], new_state, old_state)

    def uplink_bytes(self, msg_template) -> int:
        return self.inner.uplink_bytes(msg_template)


_TRANSPORTS = {"dense": Dense, "topk": TopK, "randk": RandK,
               "quantize": Quantize}


def get_transport(name: str, **kwargs) -> Transport:
    """Build a transport by name ('dense', 'topk', 'randk', 'quantize',
    'topk_sched')."""
    try:
        cls = _TRANSPORTS[name]
    except KeyError:
        raise ValueError(
            f"unknown transport {name!r}; available: {sorted(_TRANSPORTS)}")
    return cls(**kwargs)


def uplink_message_spec(algorithm, grad_fn, state, batch):
    """``meta`` tensors of the shapes and dtypes of an algorithm's uplink
    message: a shape-only pass of the local half on ``state`` and ``batch``
    (:func:`repro_torch.device.eval_shape`, the counterpart of the
    reference's ``jax.eval_shape``)."""
    from repro_torch.device import eval_shape

    msg, _ = eval_shape(algorithm.make_local_fn(grad_fn), state, batch)
    return msg
