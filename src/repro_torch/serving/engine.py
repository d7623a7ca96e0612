"""Batched serving engine: decode segments + continuous batching.

The port of :mod:`repro.serving.engine`.  Serves the post-proximal global
model produced by federated training (the deployable artifact of
Algorithm 1).  Two decode surfaces:

  * :meth:`ServingEngine.generate` -- the whole decode is one segment: a
    Python loop of :func:`~repro_torch.models.transformer.decode_step`
    whose tokens and logprobs stay on the device and cross to the host
    once at the end (the reference's jitted ``lax.scan``; a CUDA-graph
    capture of the segment is later work).
  * :meth:`ServingEngine.serve` -- continuous batching: a fixed pool of
    batch slots decodes in ``segment``-token segments; between segments
    finished requests leave and queued requests are admitted into free
    slots (single-request prefill spliced into the pooled cache at the
    slot's row, per-slot cache lengths), and with a
    :class:`~repro_torch.serving.snapshot.SnapshotStore` attached the
    served params hot-swap to the latest published snapshot.

The reference's ``generate_loop`` (its per-token baseline for the jitted
scan) is not ported: here :meth:`ServingEngine.generate` is that loop.

A vision model's prompts carry their image patches: :meth:`generate` takes
them as ``extra_inputs`` (``{"patches": (B, S_img, frontend_dim)}``), as
the reference's.  :meth:`serve` takes token prompts alone, as the
reference's, so it refuses a model with a front end (where the reference
would fail on the missing key); an encoder-only model (hubert) has no
decode step and the engine refuses it at construction.

Prefill runs the prompt through the flash-attention kernel on the card
(``kernels/ops.gqa_flash_attention``: every attention layer, one launch
each).  Caches are written in place: decode steps write their slot, and a
spliced prefill is copied into its row of the pooled cache.

Sampling: greedy is ``argmax``; ``temperature > 0`` is ``argmax(logits / T
+ g)`` with standard Gumbel noise ``g`` -- how ``jax.random.categorical``
samples.  The noise comes from a draw source (``gumbel(shape, dtype,
device)``): by default a :class:`~repro_torch.comm.GeneratorDraws` on the
CPU seeded with ``seed`` (``seed + request id`` per request in
:meth:`serve`), so the card and the CPU sample alike, or a
:class:`~repro_torch.comm.ReplayDraws` holding the reference's draws.  The
draws follow the reference's key stream: one for the first token, then one
per decode step.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.interop import params_to_torch
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as _trace
from repro_torch.serving.snapshot import SnapshotStore
from repro_torch.utils import tree as tu

#: edge histogram for serving latencies (seconds); the final bin is
#: overflow, so p99 readings stay bounded for anything under ~30 s
LATENCY_EDGES_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: edge histogram for snapshot age at read (seconds)
AGE_EDGES_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0,
               60.0)


@dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, n_new)
    logprobs: np.ndarray  # (B, n_new)


@dataclass
class Request:
    """One serving request for :meth:`ServingEngine.serve`."""

    id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32


@dataclass
class RequestResult:
    id: int
    tokens: np.ndarray
    logprobs: np.ndarray
    snapshot_version: int = 0   # snapshot version the request was admitted on
    admitted_at: float = 0.0
    finished_at: float = 0.0


@dataclass
class _Slot:
    """Host-side state of one occupied batch slot."""

    req: Request
    admitted_at: float
    snapshot_version: int
    draws: object = None
    produced: int = 0
    toks: List[np.ndarray] = field(default_factory=list)
    lps: List[np.ndarray] = field(default_factory=list)


def _default_draws(seed: int):
    from repro_torch.comm import GeneratorDraws

    return GeneratorDraws(seed)


class ServingEngine:
    """Serves ``params`` (a params tree of :func:`T.init_model`'s layout on
    ``device``) or the snapshots published into ``snapshots``.

    ``device`` is where caches and tokens live: ``cuda`` unless the caller
    passes another one; without a GPU it raises instead of running on the
    CPU quietly.
    """

    def __init__(self, cfg: T.ArchConfig, params, max_len: int = 4096,
                 snapshots: Optional[SnapshotStore] = None,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 device=None):
        if not cfg.decode_supported:
            raise ValueError(f"{cfg.name} is encoder-only; nothing to decode")
        if params is None and snapshots is None:
            raise ValueError("need initial params or a SnapshotStore")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.snapshots = snapshots
        self.metrics = metrics or obs_metrics.MetricsRegistry()
        self._m_requests = self.metrics.counter("serve/requests")
        self._m_tokens = self.metrics.counter("serve/tokens")
        self._m_tok_lat = self.metrics.histogram(
            "serve/token_latency_s", edges=list(LATENCY_EDGES_S))
        self._m_snap_age = self.metrics.histogram(
            "serve/snapshot_age_s", edges=list(AGE_EDGES_S))
        self._snap_version = 0

    # -- snapshot hot-swap -------------------------------------------------

    def refresh(self, timeout: Optional[float] = None):
        """Adopt the snapshot store's latest params if newer than what we
        serve; returns the params in use.  With no store this is a no-op.
        Readers never block publishers: this is one atomic ``latest()``
        read (plus an optional wait for the FIRST snapshot when the engine
        was constructed without params)."""
        if self.snapshots is None:
            return self.params
        snap = self.snapshots.latest()
        if snap is None and self.params is None:
            snap = self.snapshots.wait_for(1, timeout)
            if snap is None:
                raise TimeoutError("no serving snapshot published yet")
        if snap is not None and snap.version > self._snap_version:
            self.params = snap.value
            self._snap_version = snap.version
            self._m_snap_age.observe(snap.age())
            _trace.instant("serve/hot_swap", "serve", version=snap.version,
                           round=snap.round)
        return self.params

    @property
    def snapshot_version(self) -> int:
        """Version of the snapshot currently served (0 = ctor params)."""
        return self._snap_version

    # -- one-shot batched generation --------------------------------------

    def _batch(self, prompts, extra_inputs=None) -> dict:
        """The prefill batch: the prompts' tokens (int32) and
        ``extra_inputs`` (arrays or tensors; bfloat16 numpy arrays bitwise)
        on the engine's device."""
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                           device=self.device)}
        for k, v in (extra_inputs or {}).items():
            batch[k] = (v.to(self.device) if isinstance(v, torch.Tensor)
                        else params_to_torch(v, self.device))
        return batch

    def _prefill(self, params, batch):
        # last_only: only the final position is sampled from, and the norm
        # and unembed act per position, so its logits are those of the full
        # prefill's last position without the (B, S, vocab) float32 logits
        # (4.7 GB at S = 4,608 for gemma2-9b); the reference engine
        # prefills in full and samples logits[:, -1]
        return T.prefill(params, self.cfg, batch, max_len=self.max_len,
                         last_only=True)

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 extra_inputs: Optional[dict] = None,
                 draws=None) -> GenerationResult:
        """prompts: (B, S) int32.  ``extra_inputs`` carries VLM patches
        etc.  The decode is one segment; a single host sync at the end.
        ``draws``: the Gumbel draw source for ``temperature > 0`` (default:
        seeded with ``seed``)."""
        params = self.refresh()
        batch = self._batch(prompts, extra_inputs)
        if draws is None and temperature > 0.0:
            draws = _default_draws(seed)
        with _trace.span("serve/prefill", "serve",
                         batch=int(batch["tokens"].shape[0])):
            logits, caches, cache_len = self._prefill(params, batch)
        tok = self._sample(logits[:, -1], temperature, draws)
        with _trace.span("serve/decode_scan", "serve",
                         steps=int(max_new_tokens)):
            _, _, _, toks, lps = self._segment(
                params, caches, tok, cache_len, max_new_tokens, temperature,
                [draws])
            toks, lps = toks.cpu().numpy(), lps.cpu().numpy()  # ONE sync
        self._m_tokens.add(toks.size)
        return GenerationResult(tokens=toks, logprobs=lps)

    # -- continuous batching ----------------------------------------------

    def serve(self, requests: Sequence[Request], slots: int = 4,
              segment: int = 8, temperature: float = 0.0, seed: int = 0,
              draws_for: Optional[Callable[[int], object]] = None
              ) -> List[RequestResult]:
        """Drive ``requests`` through a fixed pool of ``slots`` batch
        slots, decoding in ``segment``-token segments.

        Between segments: finished requests retire, queued requests are
        admitted into free slots (their single-request prefill spliced
        into the pooled cache), and -- with a snapshot store attached --
        the served params hot-swap to the latest snapshot.  Greedy
        per-request trajectories equal the sequential :meth:`generate`
        trajectories (decode math is independent across batch rows).
        ``draws_for(request_id)`` gives each request's Gumbel draw source
        for ``temperature > 0`` (default: seeded with ``seed + id``).
        """
        if slots < 1 or segment < 1:
            raise ValueError("slots and segment must be >= 1")
        if self.cfg.frontend is not None:
            raise ValueError(
                f"{self.cfg.name}: serve takes token prompts only, and its "
                f"{self.cfg.frontend} front end needs its inputs with each "
                f"prompt: use generate(..., extra_inputs=...)")
        if draws_for is None:
            draws_for = lambda rid: _default_draws(seed + rid)  # noqa: E731
        params = self.refresh()
        caches = T.init_cache(self.cfg, slots, self.max_len, self.device)
        cache_len = torch.zeros((slots,), dtype=torch.int32,
                                device=self.device)
        tok = torch.zeros((slots, 1), dtype=torch.int32, device=self.device)
        pending = deque(requests)
        active: List[Optional[_Slot]] = [None] * slots
        results: List[RequestResult] = []

        while pending or any(s is not None for s in active):
            params = self.refresh()
            for j in range(slots):
                if active[j] is not None or not pending:
                    continue
                req = pending.popleft()
                with _trace.span("serve/admit", "serve", slot=j,
                                 request=req.id,
                                 prompt_len=int(np.size(req.prompt))):
                    draws = draws_for(req.id) if temperature > 0.0 else None
                    logits, c1, cl1 = self._prefill(
                        params, self._batch(np.asarray(req.prompt)[None, :]))
                    first = self._sample(logits[:, -1], temperature, draws)
                    _splice_caches(caches, c1, j)
                    del c1
                    cache_len[j] = cl1
                    tok[j] = first[0]
                active[j] = _Slot(req=req, admitted_at=time.perf_counter(),
                                  snapshot_version=self._snap_version,
                                  draws=draws)
            with _trace.span("serve/segment", "serve", steps=segment,
                             occupied=sum(s is not None for s in active)):
                caches, tok, cache_len, toks_d, lps_d = self._segment(
                    params, caches, tok, cache_len, segment, temperature,
                    [s.draws if s is not None else None for s in active],
                    per_slot=True)
                toks_np = toks_d.cpu().numpy()  # the segment's ONE host sync
                lps_np = lps_d.cpu().numpy()
            t1 = time.perf_counter()
            for j, s in enumerate(active):
                if s is None:
                    continue
                take = min(segment, s.req.max_new_tokens - s.produced)
                s.toks.append(toks_np[j, :take])
                s.lps.append(lps_np[j, :take])
                s.produced += take
                self._m_tokens.add(take)
                # request-relative completion latency of each token that
                # became host-visible at this segment boundary
                self._m_tok_lat.observe(
                    np.full(take, t1 - s.admitted_at), n=1)
                if s.produced >= s.req.max_new_tokens:
                    results.append(RequestResult(
                        id=s.req.id,
                        tokens=np.concatenate(s.toks),
                        logprobs=np.concatenate(s.lps),
                        snapshot_version=s.snapshot_version,
                        admitted_at=s.admitted_at, finished_at=t1))
                    self._m_requests.add(1)
                    _trace.instant("serve/finish", "serve",
                                   request=s.req.id, tokens=s.produced)
                    active[j] = None
        results.sort(key=lambda r: r.id)
        return results

    # -- internals ---------------------------------------------------------

    def _segment(self, params, caches, tok, cache_len, n_steps: int,
                 temperature: float, draws: list, per_slot: bool = False):
        """``n_steps`` decode steps; returns (caches, tok, cache_len, toks
        (B, n_steps), logprobs (B, n_steps)), all on the device.  ``draws``
        holds one draw source for the whole batch, or (``per_slot``) one per
        batch row (``None`` for an empty slot, which decodes greedily: its
        tokens are discarded)."""
        toks, lps = [], []
        for _ in range(n_steps):
            logits_t, caches = T.decode_step(params, self.cfg, caches, tok,
                                             cache_len)
            lg = logits_t[:, 0]
            lp_all = torch.log_softmax(lg.float(), dim=-1)
            if per_slot:
                nxt = self._sample_rows(lg, temperature, draws)
            else:
                nxt = self._sample(lg, temperature, draws[0])
            lps.append(torch.gather(lp_all, -1, nxt.long())[:, 0])
            toks.append(tok[:, 0])
            tok = nxt
            cache_len = cache_len + 1
        return (caches, tok, cache_len, torch.stack(toks, 1),
                torch.stack(lps, 1))

    @staticmethod
    def _sample(logits, temperature, draws):
        """(B, V) logits -> (B, 1) int32 tokens."""
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        scaled = logits.float() / temperature
        g = draws.gumbel(tuple(scaled.shape), torch.float32, scaled.device)
        return torch.argmax(g + scaled, dim=-1)[:, None].to(torch.int32)

    @staticmethod
    def _sample_rows(logits, temperature, draws):
        """Per-slot sampling: row ``j`` draws from ``draws[j]``."""
        if temperature <= 0.0:
            return ServingEngine._sample(logits, temperature, None)
        scaled = logits.float() / temperature
        noise = torch.zeros_like(scaled)
        for j, d in enumerate(draws):
            if d is not None:
                noise[j] = d.gumbel((scaled.shape[1],), torch.float32,
                                    scaled.device)
        return torch.argmax(noise + scaled, dim=-1)[:, None].to(torch.int32)


def _splice_caches(dst, src, slot):
    """Install a single-request prefill cache (batch 1) into row ``slot``
    of the pooled cache, in place; returns ``dst``.  Batch is axis 0 for
    prefix/suffix cache entries and axis 1 for the stacked periodic blocks
    (leading ``n_periods``)."""
    tu.tree_map(lambda d, s: d[slot].copy_(s[0]), dst["prefix"],
                src["prefix"])
    tu.tree_map(lambda d, s: d[slot].copy_(s[0]), dst["suffix"],
                src["suffix"])
    tu.tree_map(lambda d, s: d[:, slot].copy_(s[:, 0]), dst["stack"],
                src["stack"])
    return dst
