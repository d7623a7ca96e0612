"""Expert-parallel MoE dispatch with EXPLICIT all-to-alls.

The counterpart of :mod:`repro.models.moe_ep`.  The placed scatter/gather
dispatch of :func:`repro_torch.models.layers.moe` leaves the communication
to whatever the placement gives; this module implements the schedule a MoE
system wants, by hand:

  tokens divided over the mesh axis ``axis``, experts divided over the same
  axis; each rank routes its local tokens, packs per-destination-rank send
  buffers, ``all_to_all_single``\\s the activations to the experts' owners,
  runs its local experts as batched products, and all-to-alls the results
  back.  Traffic per token: 2 x d (one round trip), the textbook
  expert-parallel schedule -- no activation is ever replicated.

Every scatter is rank-local; the two all-to-alls are functional collectives
(``torch.distributed._functional_collectives``), so a traced step (the dry
run's :class:`repro_torch.roofline.analysis.CostMode`) and
``CommDebugMode`` see them.  Constraints, as the reference's: E % n_shards
== 0 and T % n_shards == 0.
"""
from __future__ import annotations

from repro_torch.models import layers as L
from repro_torch.models.layers import MoECfg


def _all_reduce_mean(t, mesh, axes):
    """The mean of ``t`` over the mesh axes ``axes`` (one all-reduce each)."""
    import torch.distributed._functional_collectives as funcol

    size = 1
    for a in axes:
        n = mesh[a].size()
        if n > 1:
            t = funcol.all_reduce(t, "sum", mesh[a])
        size *= n
    return t / size


def _local_moe_shard(x_loc, router, w_gate, w_up, w_down, *, cfg: MoECfg,
                     act: str, mesh, axis: str, n_shards: int, token_axes):
    """One rank's part: ``x_loc`` (T_loc, d) local tokens, ``router``
    (d, E) replicated, ``w_*`` (E_loc, ...) the rank's experts."""
    import torch
    import torch.distributed._functional_collectives as funcol

    T_loc, d = x_loc.shape
    E = router.shape[-1]
    E_loc = E // n_shards
    K = cfg.top_k
    # per-(source, expert) capacity: expected T_loc*K/E, padded
    C = max(int(T_loc * K / E * cfg.capacity_factor), 1)

    probs, gate_vals, expert_idx = L.moe_route({"router": router}, cfg,
                                               x_loc)
    flat_e = expert_idx.reshape(-1)  # (T_loc*K,)
    dest = flat_e // E_loc  # destination rank
    e_local = flat_e % E_loc  # expert index on that rank

    # slot within the per-(dest, expert) send buffer, in token order;
    # buffers are organised by EXPERT so the receiver runs direct batched
    # expert products
    onehot = (flat_e[:, None] == torch.arange(E, device=x_loc.device)).long()
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = slot < C
    slot_c = torch.where(keep, slot, torch.zeros_like(slot))
    tok = torch.arange(T_loc, device=x_loc.device).repeat_interleave(K)
    contrib = torch.where(keep[:, None], x_loc[tok],
                          torch.zeros((), dtype=x_loc.dtype,
                                      device=x_loc.device))
    send = x_loc.new_zeros((n_shards, E_loc, C, d)).index_put(
        (dest, e_local, slot_c), contrib, accumulate=True)

    # ---- the explicit all-to-all round trip -------------------------------
    group = mesh[axis]
    recv = funcol.all_to_all_single(send.reshape(n_shards, -1), None, None,
                                    group)
    # recv: (n_src, E_loc, C, d) -> (E_loc, n_src*C, d)
    xe = recv.reshape(n_shards, E_loc, C, d).transpose(0, 1).reshape(
        E_loc, n_shards * C, d)

    # ---- local expert compute: batched products ---------------------------
    out_e = L.moe_experts({"w_gate": w_gate, "w_up": w_up,
                           "w_down": w_down}, xe, act)

    # ---- return trip ------------------------------------------------------
    out_back = out_e.reshape(E_loc, n_shards, C, d).transpose(0, 1)
    back = funcol.all_to_all_single(out_back.reshape(n_shards, -1), None,
                                    None, group)

    # combine at the source: back[dest, e_local, slot] is global expert
    # dest * E_loc + e_local, so the (E, C, d) view serves moe_combine
    out = L.moe_combine(back.reshape(E, C, d), flat_e, slot_c, keep,
                        gate_vals)

    frac = (expert_idx[..., None] == torch.arange(E, device=x_loc.device)
            ).float().sum(1).mean(0) / K
    imp = probs.mean(0)
    # aux needs the global mean over every axis that divides the tokens
    frac = _all_reduce_mean(frac, mesh, token_axes)
    imp = _all_reduce_mean(imp, mesh, token_axes)
    aux = E * torch.sum(frac * imp)
    return out.to(x_loc.dtype), aux


def _local(t, mesh, placements):
    """This rank's block of ``t``: a ``DTensor``'s local tensor, or the
    block of a full tensor under ``placements`` (a slice)."""
    from repro_torch.launch import sharding as shd

    if shd._is_dtensor(t):
        if tuple(t.placements) != tuple(placements):
            t = t.redistribute(mesh, placements)
        return t.to_local()
    spec = [None] * t.ndim
    for name, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            e = spec[p.dim]
            spec[p.dim] = name if e is None else (
                (e if isinstance(e, tuple) else (e,)) + (name,))
    return shd.local_chunk(t, shd.NamedSharding(mesh, shd.PartitionSpec(
        *spec)))


def moe_expert_parallel(p, cfg: MoECfg, x, mesh, *, act: str = "swiglu",
                        axis: str = "model", token_axes=None):
    """x: (T, d) tokens divided over ``token_axes`` (default: just
    ``axis``; pass ("data", "model") to also batch-parallelise over
    'data'); expert weights in ``p`` divided over their leading expert dim
    on ``axis``; router replicated.  ``x`` and the weights may be
    ``DTensor``\\s so placed or full tensors (each rank takes its block).
    The all-to-alls run within each ``axis`` group.

    Returns (out, aux): ``out`` the (T, d) ``DTensor`` divided as ``x``,
    ``aux`` the load-balance loss (replicated).  Shared experts
    (deepseek) are NOT handled here: callers add them as a dense MLP
    outside."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import sharding as shd

    n_shards = mesh[axis].size()
    E = cfg.num_experts
    assert E % n_shards == 0, (E, n_shards)
    token_axes = (axis,) if token_axes is None else tuple(token_axes)
    names = tuple(mesh.mesh_dim_names)
    tok_pl = tuple(Shard(0) if n in token_axes else Replicate()
                   for n in names)
    exp_pl = tuple(Shard(0) if n == axis else Replicate() for n in names)
    rep_pl = tuple(Replicate() for _ in names)
    out, aux = _local_moe_shard(
        _local(x, mesh, tok_pl), _local(p["router"], mesh, rep_pl),
        _local(p["w_gate"], mesh, exp_pl), _local(p["w_up"], mesh, exp_pl),
        _local(p["w_down"], mesh, exp_pl), cfg=cfg, act=act, mesh=mesh,
        axis=axis, n_shards=n_shards, token_axes=token_axes)
    out = DTensor.from_local(out, mesh, tok_pl, run_check=False,
                             shape=tuple(x.shape),
                             stride=shd._contiguous_stride(tuple(x.shape)))
    return out, aux
