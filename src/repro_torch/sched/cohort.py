"""Cohort-resident client state: large populations, cohort-wide working sets.

The counterpart of :mod:`repro.sched.cohort`.  Participation sparsity
becomes memory sparsity:

  * :class:`CohortSpec` -- the sampling law: population size, cohort width,
    seed.  ``sample(round_idx)`` draws the cohort's global client ids for
    the chunk starting at ``round_idx`` with numpy, exactly as the reference
    does (so both packages pick the same ids); ``cohort == population`` is
    the identity, which makes the cohort mode the dense engine bitwise.
  * :class:`PopulationStore` -- the host-resident population state in numpy
    rows, materialized lazily on first touch (an untouched client costs one
    int32 slot-map entry).  ``save``/``load`` go through
    :mod:`repro_torch.checkpoint.ckpt`, the reference's npz layout, so a
    store saved by one package loads in the other.
  * :class:`ResidentCohort` -- the engine-facing gather/scatter between the
    store and the fixed-width working set on the engine's device.

Gather and scatter round-trips are bitwise (tensor <-> numpy copies keep
the bits).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.utils import tree as tu


@dataclass(frozen=True)
class CohortSpec:
    """Sampling law of the participating cohort.

    population : total number of clients (global ids are ``[0, population)``)
    cohort     : fixed working-set width per chunk
    seed       : seed of the per-chunk id draws
    """

    population: int
    cohort: int
    seed: int = 0

    def validate(self) -> None:
        if self.population < 1:
            raise ValueError(
                f"population must be >= 1, got {self.population}")
        if not 1 <= self.cohort <= self.population:
            raise ValueError(
                f"cohort must be in [1, population={self.population}], got "
                f"{self.cohort} (the cohort is the participating subset of "
                "the population)")

    @property
    def is_full(self) -> bool:
        """Whether the cohort is the whole population (``sample`` is the
        identity and the engine is the dense one, bitwise)."""
        return self.cohort == self.population

    def sample(self, round_idx: int) -> np.ndarray:
        """Global ids of the cohort for the chunk starting at ``round_idx``
        -- sorted, unique, deterministic in ``(seed, round_idx)``."""
        if self.is_full:
            return np.arange(self.population, dtype=np.int64)
        rng = np.random.default_rng((self.seed, int(round_idx)))
        ids = rng.choice(self.population, size=self.cohort, replace=False)
        return np.sort(ids).astype(np.int64)


def _template(shape, dtype) -> np.ndarray:
    return np.broadcast_to(np.zeros((), dtype), shape)


# ---------------------------------------------------------------------------
# the population store
# ---------------------------------------------------------------------------


class _Entry:
    """One named per-client state family: a pytree row template (defaults)
    plus per-leaf ``(capacity, *row_shape)`` storage over touched rows."""

    def __init__(self, defaults: List[np.ndarray], treedef):
        self.defaults = defaults
        self.treedef = treedef
        self.storage: List[np.ndarray] = [
            np.empty((0,) + d.shape, d.dtype) for d in defaults]

    def grow(self, capacity: int) -> None:
        for i, (d, s) in enumerate(zip(self.defaults, self.storage)):
            if s.shape[0] >= capacity:
                continue
            new = np.empty((capacity,) + d.shape, d.dtype)
            new[:s.shape[0]] = s
            new[s.shape[0]:] = d  # new slots start at the default row
            self.storage[i] = new

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.storage)


class PopulationStore:
    """Host-resident, lazily materialized per-client state rows (numpy).

    ``add_entry`` registers a named state family from its default row (one
    client's pytree, no client axis); ``gather`` pulls rows for a batch of
    global ids into a dense ``(len(ids), ...)`` pytree (untouched ids read
    the default row); ``scatter`` writes rows back, materializing first-touch
    ids.  All entries share one slot map, so a client's rows stay aligned.
    """

    def __init__(self, population: int):
        if population < 1:
            raise ValueError(f"population must be >= 1, got {population}")
        self.population = population
        self._slot = np.full((population,), -1, np.int32)
        self._entries: Dict[str, _Entry] = {}
        self._n_used = 0
        self._capacity = 0

    def add_entry(self, name: str, default_row: Any) -> None:
        if name in self._entries:
            raise ValueError(f"store entry {name!r} already registered")
        leaves, treedef = tu.tree_flatten(default_row)
        entry = _Entry([np.asarray(l) for l in leaves], treedef)
        entry.grow(self._capacity)
        self._entries[name] = entry

    @property
    def entry_names(self):
        return tuple(self._entries)

    def default_row(self, name: str) -> Any:
        e = self._entries[name]
        return tu.tree_unflatten(e.treedef, list(e.defaults))

    def gather(self, name: str, ids: np.ndarray) -> Any:
        """Rows ``ids`` of entry ``name`` as a ``(len(ids), ...)`` pytree of
        numpy arrays; untouched ids read the default row."""
        e = self._entries[name]
        ids = np.asarray(ids)
        slots = self._slot[ids]
        touched = slots >= 0
        out = []
        for d, s in zip(e.defaults, e.storage):
            buf = np.empty((len(ids),) + d.shape, d.dtype)
            buf[...] = d
            if touched.any():
                buf[touched] = s[slots[touched]]
            out.append(buf)
        return tu.tree_unflatten(e.treedef, out)

    def scatter(self, name: str, ids: np.ndarray, rows: Any) -> None:
        """Write ``rows`` (leading axis ``len(ids)``) into entry ``name``,
        materializing first-touch ids across every entry."""
        e = self._entries[name]
        ids = np.asarray(ids)
        self._ensure_slots(ids)
        slots = self._slot[ids]
        leaves, treedef = tu.tree_flatten(rows)
        if treedef != e.treedef:
            raise ValueError(f"rows for entry {name!r} have another "
                             "structure than its default row")
        for s, leaf in zip(e.storage, leaves):
            s[slots] = np.asarray(leaf)

    def _ensure_slots(self, ids: np.ndarray) -> None:
        fresh = ids[self._slot[ids] < 0]
        if fresh.size == 0:
            return
        fresh = np.unique(fresh)
        need = self._n_used + fresh.size
        if need > self._capacity:
            self._capacity = max(2 * self._capacity, need, 16)
            for e in self._entries.values():
                e.grow(self._capacity)
        self._slot[fresh] = np.arange(self._n_used, need, dtype=np.int32)
        self._n_used = need

    @property
    def touched(self) -> int:
        """Clients with materialized rows."""
        return self._n_used

    @property
    def nbytes(self) -> int:
        """Host bytes held: row storage (allocated capacity) + the
        O(population) int32 slot map."""
        return self._slot.nbytes + sum(e.nbytes
                                       for e in self._entries.values())

    def _touched_ids(self) -> np.ndarray:
        return np.nonzero(self._slot >= 0)[0].astype(np.int64)

    def save(self, path, metadata: Optional[dict] = None) -> None:
        """Persist the materialized rows (only what was touched) in the
        reference's npz layout."""
        ids = self._touched_ids()
        order = self._slot[ids]
        tree = {"__ids__": ids}
        for name, e in self._entries.items():
            tree[name] = tu.tree_unflatten(e.treedef,
                                           [s[order] for s in e.storage])
        meta = {"population": self.population, "touched": int(ids.size)}
        meta.update(metadata or {})
        ckpt.save(tree, path, metadata=meta)

    def load(self, path) -> dict:
        """Restore rows saved by :meth:`save` (by either package) into this
        store; entries must be registered with matching templates.  Returns
        the checkpoint metadata; existing rows are replaced."""
        meta = ckpt.metadata(path)
        if meta.get("population") != self.population:
            raise ValueError(
                f"population store checkpoint holds population="
                f"{meta.get('population')}, this store has "
                f"{self.population}")
        n = int(meta["touched"])
        # layout-only templates: zero-stride views, nothing allocated
        like = {"__ids__": _template((n,), np.int64)}
        for name, e in self._entries.items():
            like[name] = tu.tree_unflatten(e.treedef, [
                _template((n,) + d.shape, d.dtype) for d in e.defaults])
        tree = ckpt.restore(path, like)
        self._slot[:] = -1
        self._n_used = 0
        ids = tree["__ids__"]
        for name in self._entries:
            self.scatter(name, ids, tree[name])
        return meta


def sched_client_axes(sched) -> Dict[str, Optional[int]]:
    """Per-field client axis of an async scheduler state (``None`` = global,
    not per-client): the one-slot buffer is client-major, the queued buffer
    stacks a leading queue-depth axis."""
    from repro_torch.sched.aggregator import QueueState

    queued = isinstance(sched, QueueState)
    axes: Dict[str, Optional[int]] = {
        "pending_msg": 1 if queued else 0,
        "pending_aux": 1 if queued else 0,
        "resid": 0, "last_synced": 0, "last_age": 0,
        "deliver_time": 1 if queued else 0,
        "slot_filled": 1, "need_refresh": 0,
        "vtime": None, "round_idx": None,
    }
    return {f: axes[f] for f in sched._fields}


class ResidentCohort:
    """Sampling + gather/scatter between the :class:`PopulationStore` and
    the fixed-width working set on ``device``.

    Each registered entry is a pytree whose leaves carry a client axis (an
    int for the whole tree, or a ``{field: axis}`` dict over a dict tree);
    rows live in the store with the client axis first.  Registration takes
    the default row from index 0 of the initial working set -- federated
    per-client init is client-uniform.
    """

    def __init__(self, spec: CohortSpec, store: Optional[PopulationStore] =
                 None, device="cpu"):
        spec.validate()
        self.spec = spec
        self.store = (store if store is not None
                      else PopulationStore(spec.population))
        self.device = torch.device(device)
        self.current_ids: Optional[np.ndarray] = None
        self._axes: Dict[str, Any] = {}

    def sample(self, round_idx: int) -> np.ndarray:
        return self.spec.sample(round_idx)

    def _axes_tree(self, name: str, tree):
        axes = self._axes[name]
        if isinstance(axes, int):
            return tu.tree_map(lambda _: axes, tree)
        return {f: tu.tree_map(lambda _, a=axes[f]: a, sub)
                for f, sub in tree.items()}

    def register(self, name: str, working, client_axes) -> None:
        """Register a per-client working slice (``client_axes``: int, or
        ``{field: axis}`` for dict trees)."""
        self._axes[name] = client_axes
        axes = self._axes_tree(name, working)
        default = tu.tree_map(
            lambda l, a: np.take(l.detach().cpu().numpy(), 0, axis=a),
            working, axes)
        self.store.add_entry(name, default)

    def gather(self, name: str, ids: np.ndarray):
        """Rows ``ids`` as a working slice on the device (client axis back
        at its declared position)."""
        rows = self.store.gather(name, ids)
        axes = self._axes_tree(name, rows)
        return tu.tree_map(
            lambda l, a: torch.from_numpy(
                np.ascontiguousarray(np.moveaxis(l, 0, a))).to(self.device),
            rows, axes)

    def scatter(self, name: str, ids: np.ndarray, working) -> None:
        """Persist a working slice back to the store under ``ids``."""
        axes = self._axes_tree(name, working)
        rows = tu.tree_map(
            lambda l, a: np.moveaxis(l.detach().cpu().numpy(), a, 0),
            working, axes)
        self.store.scatter(name, ids, rows)
