"""Chunk-aware batch suppliers for the round engine.

The counterpart of :mod:`repro.exec.suppliers`:

  * :class:`BatchSupplier` -- ``sample_round(r, rng)`` plus
    ``sample_chunk(start, n_rounds, rng)`` returning the whole chunk with a
    leading rounds axis (default: per-round sampling + stack);
  * :class:`CallableSupplier` -- adapter for a plain ``fn(round_idx, rng)``;
  * :class:`ArraySupplier` -- vectorized i.i.d. minibatch sampling from
    per-client example arrays.  With ``device_cache=True`` the arrays live on
    the device and the gather happens there; full-batch rounds are served
    as ``expand`` views of the cache, never copied.  With ``prefetch=True``
    the minibatch chunk path is double-buffered: after serving chunk
    ``[start, start+n)`` a staging thread prepares ``[start+n, start+2n)``
    while the engine runs the current one.  On the card the host gather
    lands in pinned memory and is copied on a side stream (with
    ``device_cache`` the gather itself runs there); the chunk is handed
    over with the current stream made to wait on the copy's event.

rng contract: :class:`ArraySupplier` derives a fresh generator per round from
``(seed, round_idx)``, so trajectories do not depend on ``chunk_rounds``, and
prefetching, which draws the same per-round generators ahead of time, cannot
change them.

``client_ids`` (an int64 array of global client ids, passed by the engine's
cohort-resident mode) restricts a draw to those clients' data.  A supplier
that cannot serve per-id draws does not accept the keyword, and the engine
checks :func:`supports_client_ids` before a strict sub-cohort passes it.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import trace as _trace
from repro_torch.utils import tree as tu

Batch = Any


def _stack_batches(per_round: list) -> Batch:
    """Stack per-round batch pytrees along a new leading axis (tensor leaves
    stay tensors on their device; numpy leaves stack on the host)."""

    def stack(*xs):
        if any(isinstance(x, torch.Tensor) for x in xs):
            return torch.stack([torch.as_tensor(x) for x in xs])
        return np.stack([np.asarray(x) for x in xs])

    return tu.tree_map(stack, *per_round)


class BatchSupplier:
    """Protocol: per-round sampling plus an optional vectorized chunk path."""

    def sample_round(self, round_idx: int, rng: np.random.Generator, *,
                     client_ids=None) -> Batch:
        """One round's batches ``(n_clients, tau, ...)`` (leading axis
        ``len(client_ids)`` when ids are given)."""
        raise NotImplementedError

    def sample_chunk(self, start_round: int, n_rounds: int,
                     rng: np.random.Generator, *, client_ids=None) -> Batch:
        """Batches for ``n_rounds`` rounds, leaves gaining a leading rounds
        axis.  Default: per-round sampling + stack."""
        kw = {} if client_ids is None else {"client_ids": client_ids}
        return _stack_batches([self.sample_round(start_round + i, rng, **kw)
                               for i in range(n_rounds)])


def _accepts_client_ids(fn) -> bool:
    import inspect

    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "client_ids" or p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params)


class CallableSupplier(BatchSupplier):
    """Adapter giving a plain ``fn(round_idx, rng)`` the supplier surface; a
    callable that accepts a ``client_ids`` keyword serves per-id draws."""

    def __init__(self, fn):
        self.fn = fn
        self.accepts_client_ids = _accepts_client_ids(fn)

    def sample_round(self, round_idx, rng, *, client_ids=None):
        if client_ids is not None:
            return self.fn(round_idx, rng, client_ids=client_ids)
        return self.fn(round_idx, rng)


def supports_client_ids(supplier) -> bool:
    """Whether a supplier serves per-id batch draws: declared by an
    ``accepts_client_ids`` attribute, or both ``sample_round`` and
    ``sample_chunk`` accept the keyword."""
    explicit = getattr(supplier, "accepts_client_ids", None)
    if explicit is not None:
        return bool(explicit)
    return (_accepts_client_ids(supplier.sample_round)
            and _accepts_client_ids(supplier.sample_chunk))


def as_supplier(supplier) -> BatchSupplier:
    """Coerce a callable or BatchSupplier to the supplier protocol."""
    if isinstance(supplier, BatchSupplier):
        return supplier
    if callable(supplier):
        return CallableSupplier(supplier)
    raise TypeError(f"not a batch supplier: {type(supplier).__name__}")


def has_chunk_path(supplier: BatchSupplier) -> bool:
    """Whether ``supplier`` overrides the default per-round ``sample_chunk``."""
    return type(supplier).sample_chunk is not BatchSupplier.sample_chunk


class ArraySupplier(BatchSupplier):
    """Vectorized i.i.d. minibatch supplier over per-client example arrays.

    ``arrays`` maps batch keys to arrays of shape ``(n_clients, n_examples,
    ...)``; every round draws, per client and local step, ``batch_size``
    examples with replacement.  ``batch_size=None`` is full-batch mode:
    every local step sees all examples, through an ``expand`` view.

    ``device_cache=True`` copies the arrays to ``device`` (``cuda`` unless
    given) once, and every batch is gathered or viewed there.

    ``prefetch=True`` stages the next minibatch chunk ahead (see the module
    docstring) for ``device`` (``cuda`` unless given; ``"cpu"`` stages the
    host gather only).  A chunk is served from the stage when it is the one
    staged, else gathered at once; either way the numbers are the same.
    :meth:`close` ends the staging thread.
    """

    def __init__(self, arrays: Mapping[str, np.ndarray], tau: int,
                 batch_size: Optional[int], *, seed: int = 0,
                 device_cache: bool = False, prefetch: bool = False,
                 device=None):
        arrays = dict(arrays)
        if not arrays:
            raise ValueError("ArraySupplier needs at least one array")
        shapes = {k: tuple(v.shape[:2]) for k, v in arrays.items()}
        if len(set(shapes.values())) != 1:
            raise ValueError(f"arrays disagree on (n_clients, n_examples): "
                             f"{shapes}")
        self.n_clients, self.n_examples = next(iter(shapes.values()))
        self.tau = tau
        self.batch_size = batch_size
        self.seed = seed
        self.device_cache = device_cache
        self.prefetch = prefetch
        self._stage_device = None  # the cache's and the staged chunks' device
        if device_cache or prefetch:
            self._stage_device = resolve_device(device)
        if device_cache:
            self._arrays = {k: torch.as_tensor(v, device=self._stage_device)
                            for k, v in arrays.items()}
        else:
            self._arrays = arrays
        self._executor = None  # the staging thread, made at the 1st prefetch
        self._side = None      # its CUDA stream
        self._pending = None   # (start_round, n_rounds, future)

    @classmethod
    def from_dataset(cls, data, tau: int, batch_size: Optional[int], *,
                     seed: int = 0, device_cache: bool = False,
                     prefetch: bool = False, device=None):
        """Supplier over a :class:`repro_torch.data.synthetic.FederatedDataset`
        producing the engine's standard ``{"a": ..., "y": ...}`` batches."""
        return cls({"a": data.features, "y": data.labels}, tau, batch_size,
                   seed=seed, device_cache=device_cache, prefetch=prefetch,
                   device=device)

    def close(self) -> None:
        """End the staging thread (a pending chunk is waited for and
        dropped); the supplier keeps serving chunks without prefetch."""
        if self._executor is not None:
            if self._pending is not None:
                self._pending[2].result()
            self._executor.shutdown(wait=True)
        self._executor, self._pending, self.prefetch = None, None, False

    def _round_idx(self, r: int, client_ids=None) -> np.ndarray:
        # the draw is always the full (n_clients, ...) stream, subset AFTER:
        # a client's minibatch stream depends only on (seed, round), never
        # on which other clients share its cohort
        rng = np.random.default_rng((self.seed, r))
        idx = rng.integers(0, self.n_examples,
                           size=(self.n_clients, self.tau, self.batch_size))
        return idx if client_ids is None else idx[np.asarray(client_ids)]

    def _gather(self, idx: np.ndarray, client_ids=None) -> Batch:
        # idx: (..., clients, tau, b); result leaves (..., clients, tau, b,
        # *example_shape) -- one fancy-gather per array
        rows = (np.arange(self.n_clients) if client_ids is None
                else np.asarray(client_ids))
        cidx = rows.reshape((1,) * (idx.ndim - 3) + (len(rows), 1, 1))
        if self.device_cache:
            dev = next(iter(self._arrays.values())).device
            cidx = torch.as_tensor(cidx, device=dev)
            idx = torch.as_tensor(idx, device=dev)
        return {k: v[cidx, idx] for k, v in self._arrays.items()}

    def _full_batch(self, lead: tuple, client_ids=None) -> Batch:
        def one(v):
            if client_ids is not None:
                ids = np.asarray(client_ids)
                if isinstance(v, torch.Tensor):
                    ids = torch.as_tensor(ids, device=v.device)
                v = v[ids]  # copy: the cohort's rows
            shape = lead + (v.shape[0], self.tau) + tuple(v.shape[1:])
            src = v[:, None] if not lead else v[None, :, None]
            if isinstance(v, torch.Tensor):
                return src.expand(shape)
            return np.broadcast_to(src, shape)

        return {k: one(v) for k, v in self._arrays.items()}

    def sample_round(self, round_idx, rng=None, *, client_ids=None):
        if self.batch_size is None:
            return self._full_batch((), client_ids)
        return self._gather(self._round_idx(round_idx, client_ids),
                            client_ids)

    def _chunk(self, start_round, n_rounds, client_ids=None):
        with _trace.span("supplier/stage", "supplier",
                         start_round=int(start_round),
                         rounds=int(n_rounds)):
            idx = np.stack([self._round_idx(start_round + i, client_ids)
                            for i in range(n_rounds)])
            return self._gather(idx, client_ids)

    def _stage(self, start_round, n_rounds):
        """The staging thread's work: one chunk, and on the card the event
        that marks its copy (or device gather) done on the side stream."""
        dev = self._stage_device
        if dev.type != "cuda":
            return self._chunk(start_round, n_rounds), None
        with torch.cuda.device(dev), torch.cuda.stream(self._side):
            if self.device_cache:
                chunk = self._chunk(start_round, n_rounds)
            else:
                chunk = {k: torch.from_numpy(np.ascontiguousarray(v))
                         .pin_memory().to(dev, non_blocking=True)
                         for k, v in self._chunk(start_round,
                                                 n_rounds).items()}
            done = torch.cuda.Event()
            done.record(self._side)
        return chunk, done

    def _take(self, staged):
        """Hand a staged chunk to the caller's stream: it waits on the
        chunk's event, and the allocator learns the chunk is used there."""
        chunk, done = staged
        if done is not None:
            current = torch.cuda.current_stream(self._stage_device)
            current.wait_event(done)
            for t in chunk.values():
                t.record_stream(current)
        return chunk

    def sample_chunk(self, start_round, n_rounds, rng=None, *,
                     client_ids=None):
        if self.batch_size is None:
            return self._full_batch((n_rounds,), client_ids)
        if client_ids is not None or not self.prefetch:
            # per-id draws bypass the double buffer: the next chunk's
            # cohort ids are not known yet
            return self._chunk(start_round, n_rounds, client_ids)
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="supplier-prefetch")
            if self._stage_device.type == "cuda":
                self._side = torch.cuda.Stream(self._stage_device)
        if (self._pending is not None
                and self._pending[:2] == (start_round, n_rounds)):
            with _trace.span("supplier/wait", "supplier",
                             start_round=int(start_round)):
                chunk = self._take(self._pending[2].result())
        else:
            # cold start, or the caller jumped (a remainder chunk): stage
            # this one now and re-prime
            if self._pending is not None:
                self._pending[2].result()
            chunk = self._take(self._stage(start_round, n_rounds))
        nxt = start_round + n_rounds
        self._pending = (nxt, n_rounds,
                         self._executor.submit(self._stage, nxt, n_rounds))
        return chunk
