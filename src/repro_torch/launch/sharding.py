"""Logical-axis -> mesh-axis sharding rules, on ``DTensor`` placements.

The counterpart of :mod:`repro.launch.sharding`.  Model and init code name
every tensor dimension with a *logical* axis (:mod:`repro_torch.models.axes`);
this module resolves those names to mesh partition specs under a rule table,
with:

  * preference lists  -- a logical axis may try several mesh axes
    (``expert: ["model"]`` fits deepseek's 256 experts but fails
    divisibility for grok's 8, falling through to tensor-parallel experts);
  * priorities        -- dims are assigned in priority order, so kv_heads
    claims 'model' before cache_seq does;
  * divisibility + no-reuse constraints enforced automatically.

:func:`spec_for` and the rule tables are the reference's, verbatim: pure
Python over the mesh's axis sizes, so the port's specs equal the
reference's entry for entry.  A spec is a :class:`PartitionSpec` (a tuple
with one entry per tensor dim: ``None``, a mesh axis name, or a tuple of
names sharding one dim over several mesh axes, major first) and maps onto
``DTensor`` placements (:func:`placements`): each mesh dim gets
``Shard(tensor_dim)`` or ``Replicate()``.

The two federated placement plans, as in the reference:

  Plan A (client-per-datagroup) -- archs that fit 16-way sharded:
      server model x_bar: fully sharded over (data, model) [FSDP+TP];
      per-client state (c, z_hat, z): client axis -> 'data', params ->
      'model'.  Broadcasting x_bar to the clients is an all-gather over
      'data' (the FL downlink); the clients' messages cross 'data' to the
      server (the FL uplink).

  Plan B (fully-sharded / pod-per-client) -- 26B/314B/671B archs: every
      federated tensor sharded over (data, model); the client axis maps to
      'pod' on the multi-pod mesh (one client = one pod) and has size 1 on
      a single pod.

The sharded engine constructors at the bottom build a
:class:`repro_torch.exec.RoundEngine` with its placement stage on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

from repro_torch.launch.mesh import mesh_shape
from repro_torch.utils import tree as tu

Rule = tuple[Sequence, int]  # (mesh-axis preference list, priority)


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (one dim over several mesh axes)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axis_size(mesh, entry) -> int | None:
    shape = mesh_shape(mesh)
    names = entry if isinstance(entry, tuple) else (entry,)
    size = 1
    for n in names:
        if n not in shape:
            return None
        size *= shape[n]
    return size


def spec_for(shape, logical_axes, rules: Mapping[str, Rule],
             mesh) -> PartitionSpec:
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    order = sorted(
        range(len(shape)),
        key=lambda i: rules.get(logical_axes[i], ((), 99))[1],
    )
    used: set = set()
    assign: dict[int, Any] = {}
    for i in order:
        prefs, _ = rules.get(logical_axes[i], ((), 99))
        for entry in prefs:
            names = entry if isinstance(entry, tuple) else (entry,)
            if any(n in used for n in names):
                continue
            sz = _axis_size(mesh, entry)
            if sz is None or sz == 1:
                continue
            if shape[i] % sz != 0:
                continue
            assign[i] = entry
            used.update(names)
            break
    return PartitionSpec(*[assign.get(i) for i in range(len(shape))])


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec: where a tensor of a given rank lives
    (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def placements(spec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: mesh dim ``k``
    gets ``Shard(i)`` when tensor dim ``i``'s entry names it, else
    ``Replicate()``.  An entry naming several mesh axes shards its dim over
    each, in mesh order (major first, as the reference's)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {names}")
        for k in idx:
            out[k] = Shard(i)
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def _map_specs(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over ``tree`` with ``spec_tree`` matched leaf for
    leaf (its tuples of axis names are leaves, not containers)."""
    if _is_spec(spec_tree):
        return fn(tree, spec_tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], spec_tree[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_map_specs(fn, t, s) for t, s in zip(tree, spec_tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(
            out)
    return fn(tree, spec_tree)


def tree_shardings(tree, spec_tree, rules, mesh):
    """NamedShardings for a params/cache tree given its logical-spec tree."""
    return _map_specs(
        lambda x, ax: NamedSharding(mesh, spec_for(tuple(x.shape), ax, rules,
                                                   mesh)),
        tree, spec_tree)


# ---------------------------------------------------------------------------
# rule tables (the reference's, verbatim)
# ---------------------------------------------------------------------------

_COMMON_PARAMS: dict[str, Rule] = {
    # heavy sharded axes (priority asc = assigned first)
    "vocab": (["model", "data"], 0),
    "expert": (["model", "data"], 0),
    "mlp": (["model", "data"], 1),
    "expert_mlp": (["model", "data"], 1),
    "heads": (["model", "data"], 1),
    "rnn": (["model", "data"], 1),
    "kv_heads": (["model", "data"], 2),
    "kv_lora": (["model", "data"], 2),
    "embed": (["data"], 3),  # FSDP axis
    # never sharded
    "head_dim": ((), 9), "qk_dim": ((), 9), "v_dim": ((), 9),
    "state": ((), 9), "conv": ((), 9), "layers": ((), 9), "none": ((), 9),
}


def server_param_rules(plan: str) -> dict[str, Rule]:
    """x_bar / deployed params: fully sharded in both plans."""
    return dict(_COMMON_PARAMS)


def client_state_rules(plan: str) -> dict[str, Rule]:
    """Per-client federated tensors (c, z_hat, z, grad accumulators)."""
    r = dict(_COMMON_PARAMS)
    if plan == "A":
        # client axis claims 'data' (and 'pod' too on the multi-pod mesh);
        # inner dims then only get 'model'
        r["client"] = ([("pod", "data"), "data"], 0)
    else:
        r["client"] = (["pod"], 0)
    return r


def batch_rules(plan: str) -> dict[str, Rule]:
    if plan == "A":
        return {
            "client": ([("pod", "data"), "data"], 0),
            "batch": ((), 5), "seq": ((), 9), "tau": ((), 9), "none": ((), 9),
        }
    if plan == "A_dp":
        # shard the per-client batch over 'model' too, so the inner step is
        # batch-parallel (params all-gathered per layer) instead of
        # tensor-parallel (activations all-reduced per layer)
        return {
            "client": ([("pod", "data"), "data"], 0),
            "batch": (["model"], 1), "seq": ((), 9), "tau": ((), 9),
            "none": ((), 9),
        }
    return {
        "client": (["pod"], 0),
        "batch": (["data"], 1), "seq": ((), 9), "tau": ((), 9), "none": ((), 9),
    }


def serving_param_rules() -> dict[str, Rule]:
    return dict(_COMMON_PARAMS)


def cache_rules() -> dict[str, Rule]:
    return {
        "batch": ([("pod", "data"), "data"], 0),
        "kv_heads": (["model"], 2),
        "heads": (["model"], 2),
        "kv_lora": ((), 9),
        "cache_seq": ([("pod", "data", "model"), ("data", "model"), "model"], 5),
        "rnn": (["model"], 3),
        "state": ((), 9), "head_dim": ((), 9), "layers": ((), 9), "none": ((), 9),
    }


def request_rules() -> dict[str, Rule]:
    return {"batch": ([("pod", "data"), "data"], 0), "seq": ((), 9),
            "none": ((), 9)}


STATE_ROLES = ("server", "client", "scalar")


def fed_state_shardings_from_roles(mesh, roles: Mapping[str, str], state,
                                   param_specs, plan: str):
    """Shardings for ANY algorithm's federated state from its declared roles.

    ``roles`` maps each field of the (NamedTuple) state to a placement role
    (:meth:`repro_torch.core.baselines.FedAlgorithm.state_roles`):

      * ``server`` -- params-shaped field, sharded like the global model;
      * ``client`` -- params-shaped field with a leading client axis; the
        client axis claims the mesh data/pod axis per ``plan``;
      * ``scalar`` -- replicated (round counters and other bookkeeping).

    ``state`` may hold real, fake or ``meta`` tensors.
    """
    fields = getattr(state, "_fields", None)
    if fields is None:
        raise TypeError(
            f"state must be a NamedTuple of fields, got {type(state).__name__}")
    missing = [f for f in fields if f not in roles]
    if missing:
        raise ValueError(f"state_roles is missing fields {missing} of "
                         f"{type(state).__name__}")
    scalar = NamedSharding(mesh, PartitionSpec())
    client_specs = _map_specs(lambda _, ax: ("client",) + ax, param_specs,
                              param_specs)

    def one(role, sub):
        if role == "server":
            return tree_shardings(sub, param_specs,
                                  server_param_rules(plan), mesh)
        if role == "client":
            return tree_shardings(sub, client_specs,
                                  client_state_rules(plan), mesh)
        if role == "scalar":
            return tu.tree_map(lambda _: scalar, sub)
        raise ValueError(f"unknown state role {role!r}; expected one of "
                         f"{STATE_ROLES}")

    return type(state)(**{f: one(roles[f], getattr(state, f))
                          for f in fields})


def carry_slice_shardings(mesh, tree, plan: str, n_clients: int,
                          client_axis=0):
    """Mesh placement for one of the engine's stage-state slices (error
    feedback, the async report buffer or queue, the downlink shadow).

    The message-shaped ones are client-axis trees (``(n_clients, d)`` per
    message leaf, or ``(queue_depth, n_clients, d)`` for the queued
    buffer), so they get the client placement ``client_state_rules`` gives
    client-role state fields; everything else replicates.  Under the flat
    layout (``EngineConfig(plane=True)``) each message-shaped slice is one
    ``(n_clients, d_pad)`` plane: one spec per slice.

    ``client_axis`` names which leaf axis carries clients (0 for
    message-shaped trees, 1 for queue-stacked buffers, ``None`` to
    replicate the whole slice), declared by the caller
    (:class:`repro_torch.exec.stages.Placement`), never guessed from
    shapes.  Leaves whose declared axis is not ``n_clients`` long
    replicate.
    """
    prefs, _ = client_state_rules(plan)["client"]

    def one(leaf):
        shape = tuple(leaf.shape)
        if (client_axis is not None and len(shape) > client_axis
                and shape[client_axis] == n_clients):
            for entry in prefs:
                sz = _axis_size(mesh, entry)
                if sz is not None and sz > 1 and n_clients % sz == 0:
                    parts: list = [None] * len(shape)
                    parts[client_axis] = entry
                    return NamedSharding(mesh, PartitionSpec(*parts))
        return NamedSharding(mesh, PartitionSpec(*[None] * len(shape)))

    return tu.tree_map(one, tree)


def fed_state_shardings(mesh, param_tree, param_specs, plan: str,
                        n_clients: int):
    """Shardings for a DProxState(x_bar, c, round): a thin wrapper over
    :func:`fed_state_shardings_from_roles`."""
    from repro_torch.core.algorithm import DProxState

    c_tree = tu.tree_map(
        lambda x: torch.empty((n_clients,) + tuple(x.shape), dtype=x.dtype,
                              device="meta"), param_tree)
    state = DProxState(x_bar=param_tree, c=c_tree,
                       round=torch.empty((), dtype=torch.int32,
                                         device="meta"))
    return fed_state_shardings_from_roles(
        mesh, {"x_bar": "server", "c": "client", "round": "scalar"},
        state, param_specs, plan)


def batch_shardings(mesh, batches, plan: str, *, chunk_axis: bool = False):
    """Shardings for fed-round batches: leaves (client, tau, b, ...).

    ``chunk_axis=True`` handles chunked batches, whose leaves carry an extra
    leading (rounds-per-chunk) axis that is never sharded.
    """
    rules = batch_rules(plan)
    lead = ("none",) if chunk_axis else ()

    def one(x):
        axes = lead + ("client", "tau", "batch")
        axes = axes + ("seq",) * (x.ndim - len(axes))
        return NamedSharding(mesh, spec_for(tuple(x.shape), axes, rules,
                                            mesh))

    return tu.tree_map(one, batches)


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_block(shape, sharding: NamedSharding) -> tuple:
    """(local shape, offset) of this rank's block of a tensor of ``shape``
    under ``sharding``.  Specs only shard dims their mesh axes divide, so
    every block has the same shape; a dim over several mesh axes is split
    major axis first.  Plain integers: no tensor op, so it holds under
    fake-tensor mode too."""
    names = tuple(sharding.mesh.mesh_dim_names)
    sizes = mesh_shape(sharding.mesh)
    coord = sharding.mesh.get_coordinate()
    local, offset = list(shape), [0] * len(shape)
    for i, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        index, count = 0, 1
        for n in (entry if isinstance(entry, tuple) else (entry,)):
            index = index * sizes[n] + coord[names.index(n)]
            count *= sizes[n]
        if shape[i] % count:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"evenly over {entry!r}")
        local[i] = shape[i] // count
        offset[i] = index * local[i]
    return tuple(local), tuple(offset)


def local_chunk(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``sharding``: a
    slice, no communication (every rank holds ``x``)."""
    shape, offset = local_block(tuple(x.shape), sharding)
    return x[tuple(slice(o, o + s) for o, s in zip(offset, shape))]


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(stride))


def place(x: torch.Tensor, sharding: NamedSharding):
    """The ``DTensor`` of the full tensor ``x`` (the same on every rank)
    under ``sharding``: each rank keeps its block, with no communication."""
    from torch.distributed.tensor import DTensor

    local = local_chunk(x, sharding).contiguous()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=x.shape,
                              stride=_contiguous_stride(x.shape))


def place_abstract(x: torch.Tensor, sharding: NamedSharding):
    """A ``DTensor`` of ``x``'s shape and dtype under ``sharding`` whose
    local block is made in ``x``'s fake or meta mode: nothing is
    allocated (the dry run's placed arguments)."""
    from torch.distributed.tensor import DTensor

    shape, _ = local_block(tuple(x.shape), sharding)
    local = torch.empty(shape, dtype=x.dtype, device=x.device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=x.shape,
                              stride=_contiguous_stride(x.shape))


def place_tree(tree, shardings):
    """:func:`place` over a tree with a matching tree of shardings."""
    return tu.tree_map(place, tree, shardings)


def gather(x):
    """The full tensor of a ``DTensor`` (an all-gather over its sharded
    mesh dims); anything else is returned as it is."""
    return x.full_tensor() if _is_dtensor(x) else x


def gather_tree(tree):
    return tu.tree_map(gather, tree)


def shard_fed_state(mesh, state, param_specs, plan: str):
    """Place a DProxState on ``mesh``; returns (placed_state, shardings)."""
    n_clients = tu.tree_leaves(state.c)[0].shape[0]
    sh = fed_state_shardings(mesh, state.x_bar, param_specs, plan, n_clients)
    return place_tree(state, sh), sh


# ---------------------------------------------------------------------------
# sharded engine construction
# ---------------------------------------------------------------------------


def make_sharded_algorithm_engine(mesh, algorithm, grad_fn, param_specs,
                                  plan: str, n_clients: int,
                                  *, chunk_rounds: int = 1, device=None):
    """A RoundEngine with its placement stage on ``mesh`` for ANY algorithm
    declaring ``state_roles`` (all of :mod:`repro_torch.core.baselines`
    do).  ``device`` is the engine's (``cuda`` unless given)."""
    from repro_torch.exec import EngineConfig, RoundEngine

    return RoundEngine(
        algorithm, grad_fn, n_clients,
        EngineConfig(chunk_rounds=chunk_rounds,
                     mesh=mesh, param_specs=param_specs, plan=plan),
        device=device)


def make_sharded_engine(mesh, fed_cfg, reg, grad_fn, param_specs,
                        plan: str, n_clients: int, *, chunk_rounds: int = 1,
                        device=None):
    """A placed RoundEngine for Algorithm 1 on ``mesh``."""
    from repro_torch.fed.simulator import DProxAlgorithm

    return make_sharded_algorithm_engine(
        mesh, DProxAlgorithm(reg, fed_cfg), grad_fn, param_specs, plan,
        n_clients, chunk_rounds=chunk_rounds, device=device)


def make_sharded_round_fn(mesh, fed_cfg, reg, grad_fn, param_specs,
                          plan: str, n_clients: int, params_template,
                          *, device=None):
    """``(step, state_shardings)``: ``step(state, batches)`` runs one placed
    round through the engine."""
    engine = make_sharded_engine(mesh, fed_cfg, reg, grad_fn, param_specs,
                                 plan, n_clients, device=device)
    state_sh = fed_state_shardings(mesh, params_template, param_specs,
                                   plan, n_clients)
    engine.set_state_shardings(state_sh)
    return engine.step, state_sh
