"""Multi-pod dry run: prove the distribution config is coherent, and derive
loop-corrected roofline costs.

The counterpart of :mod:`repro.launch.dryrun`.  For every (architecture x
input shape x mesh) combination this driver

  1. opens a fake world of 512 ranks in this process
     (:func:`repro_torch.launch.mesh.fake_world`) and builds the production
     mesh over it,
  2. builds the step (federated train round / prefill / one-token decode)
     with its arguments placed by the logical-axis rules of
     :mod:`repro_torch.launch.sharding` -- DTensors of fake local
     blocks, so nothing is allocated,
  3. traces the step once as one device runs it
     (:func:`repro_torch.roofline.analysis.trace_step`): a placement that
     does not divide, or an op no placement carries, fails HERE, which is
     the point,
  4. records the device's FLOPs, bytes, collectives and memory,
  5. derives the loop-corrected costs from PROBE traces, as the reference.

How each step is placed (the device's program):

  * train -- the client axis and the per-client batch are split
    explicitly over the axes their rules give them: each device runs
    Algorithm 1's local steps for its client on its part of the batch, on
    the sub-mesh of the axes left, where ``DTensor`` carries the
    tensor-parallel ('model') placement of the params.  The broadcast of
    x_bar is a redistribute to replicated over the explicit axes (the FL
    downlink's all-gather), the batch-parallel gradient an all-reduce over
    the batch axes, and the client mean an all-reduce over the client axes
    (the FL uplink), all explicit.
  * prefill / decode -- the request batch is split explicitly over the
    axes the request rules give it; the params (and the caches' model
    dims) are all-gathered over the mesh and each device runs its
    requests on plain local tensors.  ``DTensor``'s op strategies do not
    carry the serving path's in-place cache writes and sharded-head
    reshapes on fake tensors, so these steps run data-parallel: their
    FLOPs are the model-replicated ones (ROADMAP.md, Queue 3).

An op that ``DTensor`` cannot place is run on replicated inputs
(:class:`ReplicateFallback`): the redistribute's all-gathers show in the
report, as GSPMD's replicate-then-repartition shows in the reference's,
and the report names the op (``replicated_ops``).

Probes: XLA counts a ``while`` body once, so the reference fits the
exactly-linear model

    cost(P, tau) = A0 + A1*P + tau*(B + C*P)        (train)
    cost(P)      = A  + C*P                          (prefill/decode)

on small probes (P periods in {2, 3}, tau in {1, 2}) and evaluates it at
the real (P, tau).  An eager trace counts loops in full, so the probes
reproduce the direct count exactly (tests/test_torch_dryrun.py checks
it); they are kept so the reports are made the same way.

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, shape_supported
from repro_torch.core import algorithm as A
from repro_torch.core.algorithm import DProxConfig, DProxState
from repro_torch.core.prox import L1
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.models import axes as model_axes
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as roof
from repro_torch.utils import tree as tu

DEFAULT_TAU = 4
WORLD = 512


def clients_for(plan: str, multi_pod: bool) -> int:
    if plan == "A":
        return 32 if multi_pod else 16
    return 2 if multi_pod else 1


def abstract_model(cfg):
    """(params as ``meta`` tensors, their logical-axis specs)."""
    return roof.abstract_params(cfg), model_axes.param_specs(cfg)


def abstract_cache(cfg, batch, max_len):
    """(caches as ``meta`` tensors, their logical-axis specs)."""
    from repro_torch.device import eval_shape

    caches = eval_shape(lambda: T.init_cache(cfg, batch, max_len, "cpu"))
    return caches, model_axes.cache_specs(cfg)


def probe_cfg(cfg, n_periods: int):
    """Same arch, reduced to ``n_periods`` periods of its block pattern."""
    n_layers = (len(cfg.prefix_blocks) + len(cfg.suffix_blocks)
                + len(cfg.block_pattern) * n_periods)
    return cfg.with_overrides(n_layers=n_layers)


def _microbatched_grad_fn(cfg, n_micro: int):
    """Gradient accumulation over n_micro chunks of the local batch -- the
    production memory-control knob for the large plan-B archs."""
    base = T.make_grad_fn(cfg)
    if n_micro <= 1:
        return base

    def fn(params, batch):
        def split(x):
            b = x.shape[0]
            assert b % n_micro == 0, (b, n_micro)
            return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

        mb = tu.tree_map(split, batch)
        loss_sum, gsum = None, None
        for i in range(n_micro):
            loss, g = base(params, tu.tree_map(lambda x: x[i], mb))
            g = tu.tree_map(lambda t: t.to(torch.float32), g)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            gsum = g if gsum is None else tu.tree_map(torch.add, gsum, g)
        return loss_sum / n_micro, tu.tree_map(lambda g: g / n_micro, gsum)

    return fn


# ---------------------------------------------------------------------------
# explicit axes: a device's program on the sub-mesh of the other axes
# ---------------------------------------------------------------------------


class ReplicateFallback(TorchDispatchMode):
    """Runs a ``DTensor`` op that has no sharding strategy (or whose
    strategy fails) on replicated inputs: the all-gathers of the
    redistribute are what the device pays, and ``ops`` counts each op so
    the report names it.  An in-place op first tries its other inputs laid
    out as its target."""

    def __init__(self):
        super().__init__()
        self.ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except Exception:  # noqa: BLE001 -- no strategy: replicate below
            pass
        self.ops[str(func)] = self.ops.get(str(func), 0) + 1

        def rep(x):
            if isinstance(x, DTensor):
                return x.redistribute(x.device_mesh,
                                      [Replicate()] * x.device_mesh.ndim)
            return x

        if func._schema.is_mutable and isinstance(args[0], DTensor):
            dst = args[0]

            def like(x):
                if isinstance(x, DTensor) and x is not dst:
                    return x.redistribute(dst.device_mesh, dst.placements)
                return x

            try:
                a, k = tu.tree_map(like, (args, kwargs))
                return func(*a, **k)
            except Exception:  # noqa: BLE001 -- fall through to replicate
                a, k = tu.tree_map(rep, (args, kwargs))
                func(*a, **k)
                return dst
        a, k = tu.tree_map(rep, (args, kwargs))
        return func(*a, **k)


def lead_axes(mesh, prefs, n: int) -> tuple:
    """The mesh axes a leading dim of size ``n`` takes under the preference
    list ``prefs`` (the first entry that divides it), or ``()``."""
    for entry in prefs:
        sz = shd._axis_size(mesh, entry)
        if sz is not None and sz > 1 and n % sz == 0:
            return entry if isinstance(entry, tuple) else (entry,)
    return ()


@dataclasses.dataclass(frozen=True)
class Split:
    """A mesh split into explicit axes ``axes`` (dims divided over them by
    hand: the clients, the per-client batch) and the sub-mesh of the
    others, where ``DTensor`` places the rest."""

    mesh: object
    axes: tuple

    @property
    def names(self) -> tuple:
        return tuple(self.mesh.mesh_dim_names)

    @property
    def rest(self) -> tuple:
        return tuple(n for n in self.names if n not in self.axes)

    @property
    def sub(self):
        rest = self.rest
        return self.mesh[rest] if len(rest) > 1 else self.mesh[rest[0]]

    def size(self, axes) -> int:
        shape = mesh_lib.mesh_shape(self.mesh)
        out = 1
        for n in axes:
            out *= shape[n]
        return out

    def view(self, x, lead=()):
        """This device's part of the full-mesh ``DTensor`` ``x`` as a
        sub-mesh ``DTensor`` (a plain tensor when no axis is left): dim 0
        stays divided over the explicit axes in ``lead`` (already placed
        so); every other explicit axis is replicated first (an
        all-gather)."""
        from torch.distributed.tensor import DTensor, Replicate

        pl = list(x.placements)
        want = [Replicate() if n in self.axes and n not in lead else p
                for n, p in zip(self.names, pl)]
        if want != pl:
            x = x.redistribute(self.mesh, want)
        if not self.rest:
            return x.to_local()
        sub_pl = [p for n, p in zip(self.names, want) if n not in self.axes]
        shape = list(x.shape)
        if lead:
            shape[0] //= self.size(lead)
        return DTensor.from_local(x.to_local(), self.sub, sub_pl,
                                  run_check=False, shape=tuple(shape),
                                  stride=shd._contiguous_stride(shape))

    def lift(self, y, lead=()):
        """The full-mesh ``DTensor`` of the sub-mesh (or plain) ``y``: dim 0
        divided over the explicit axes in ``lead``, replicated over the
        other explicit axes."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        sub = iter(y.placements if self.rest else ())
        pl = [(Shard(0) if n in lead else Replicate()) if n in self.axes
              else next(sub) for n in self.names]
        local = y.to_local() if self.rest else y
        shape = list(y.shape)
        if lead:
            shape[0] *= self.size(lead)
        return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=tuple(shape),
                                  stride=shd._contiguous_stride(shape))

    def all_reduce(self, y, axes):
        """The sum of the sub-mesh (or plain) ``y`` over the explicit axes
        ``axes`` (one all-reduce a mesh axis), as ``y`` was."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        if not axes:
            return y
        sub = iter(y.placements if self.rest else ())
        pl = [(Partial() if n in axes else Replicate()) if n in self.axes
              else next(sub) for n in self.names]
        local = y.to_local() if self.rest else y
        full = DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=y.shape, stride=y.stride())
        full = full.redistribute(self.mesh, [
            Replicate() if n in axes else p
            for n, p in zip(self.names, pl)])
        return self.view(full)


def _gathered(x, lead_dims=(), keep_axes=None):
    """This device's plain local tensor of the full-mesh ``DTensor`` ``x``
    with every dim gathered but ``lead_dims`` (the request batch; with
    ``keep_axes``, only over those mesh axes)."""
    from torch.distributed.tensor import Replicate, Shard

    names = x.device_mesh.mesh_dim_names
    keep = [p if isinstance(p, Shard) and p.dim in lead_dims
            and (keep_axes is None or n in keep_axes)
            else Replicate() for n, p in zip(names, x.placements)]
    if keep != list(x.placements):
        x = x.redistribute(x.device_mesh, keep)
    return x.to_local()


# ---------------------------------------------------------------------------
# step builders: (fn, arg_structs, in_shardings, out_shardings, donate)
# ---------------------------------------------------------------------------


def _placed_round(fcfg, reg, grad_fn, mesh, plan, n_clients, b_local,
                  batch_plan, state_sh):
    """Algorithm 1's round as one device runs it on ``mesh`` (see the
    module docstring): the local steps of the device's clients on its part
    of their batches, the batch-parallel gradient as an all-reduce over the
    batch axes, the client mean as an all-reduce over the client axes.
    The production meshes give every device one client (16 or 32 clients
    over 'data' or ('pod', 'data') in plan A, 1 or 2 over 'pod' in plan B),
    so the clients are a loop here: no ``vmap`` over a placed axis."""
    client_ax = lead_axes(mesh, shd.client_state_rules(plan)["client"][0],
                          n_clients)
    batch_ax = tuple(a for a in lead_axes(
        mesh, shd.batch_rules(batch_plan)["batch"][0], b_local)
        if a not in client_ax)
    split = Split(mesh, client_ax + batch_ax)
    n_batch = split.size(batch_ax)

    def local_batches(x):
        return _gathered(x, (0, 2), keep_axes=split.axes)

    def round_fn(state, batches):
        x_bar = tu.tree_map(split.view, state.x_bar)
        c = tu.tree_map(lambda x: split.view(x, lead=client_ax), state.c)
        b = tu.tree_map(local_batches, batches)
        n_loc = tu.tree_leaves(b)[0].shape[0]
        p = reg.prox(x_bar, fcfg.eta_tilde)
        msgs, avg_grads, loss = [], [], 0.0
        for i in range(n_loc):
            c_i = tu.tree_map(lambda x: x[i], c)
            z_hat, z, gsum = p, p, None
            for t in range(fcfg.tau):
                batch_t = tu.tree_map(lambda x: x[i, t], b)
                loss_t, g = grad_fn(z, batch_t)
                g = tu.tree_map(
                    lambda gg, zh: (split.all_reduce(gg, batch_ax)
                                    / n_batch).to(zh.dtype), g, z_hat)
                loss = loss + loss_t
                z_hat, z = A._step(reg, fcfg.eta, fcfg.prox_param(t), z_hat,
                                   g, c_i, batch_dims=0)
                gsum = g if gsum is None else tu.tree_add(gsum, g)
            msgs.append(tu.tree_map(lambda zh, pp: zh - pp, z_hat, p))
            avg_grads.append(tu.tree_scale(gsum, 1.0 / fcfg.tau))
        msg_sum = msgs[0]
        for m in msgs[1:]:
            msg_sum = tu.tree_add(msg_sum, m)
        mean = tu.tree_map(
            lambda m: split.all_reduce(m, client_ax) / n_clients, msg_sum)
        x_next = tu.tree_map(lambda pp, md: pp + fcfg.eta_g * md, p, mean)
        scale = 1.0 / (fcfg.eta_g * fcfg.eta * fcfg.tau)
        c_next = tu.tree_map(
            lambda pp, xn, *ags: torch.stack([scale * (pp - xn) - ag
                                              for ag in ags]),
            p, x_next, *avg_grads)
        new = DProxState(
            x_bar=tu.tree_map(lambda y, s: split.lift(y).redistribute(
                mesh, s.placements), x_next, state_sh.x_bar),
            c=tu.tree_map(lambda y, s: split.lift(y, client_ax).redistribute(
                mesh, s.placements), c_next, state_sh.c),
            round=state.round + 1)
        return new, {"train_loss": loss}

    return round_fn


def build_train(cfg, shape, mesh, multi_pod, tau=DEFAULT_TAU, micro=None,
                unroll_round=False, inner_dp=False, embed_fix=False):
    """embed_fix: shard the embedding table as (vocab replicated, embed over
    'model') instead of (vocab over 'model', embed over 'data').
    ``unroll_round`` is accepted for the reference's callers: an eager
    trace is always unrolled."""
    n_clients = clients_for(cfg.fed_plan, multi_pod)
    b_local = shape.global_batch // n_clients
    if micro is None:
        micro = 8 if cfg.fed_plan == "B" else 1
        while b_local % micro:
            micro //= 2
    params_s, specs = abstract_model(cfg)
    fcfg = DProxConfig(tau=tau, eta=1e-3,
                       eta_g=max(1.5, (n_clients / 8) ** 0.5))
    reg = L1(lam=1e-5)
    grad_fn = _microbatched_grad_fn(cfg, micro)

    state_s = DProxState(
        x_bar=params_s,
        c=tu.tree_map(lambda x: torch.empty((n_clients,) + tuple(x.shape),
                                            dtype=x.dtype, device="meta"),
                      params_s),
        round=torch.empty((), dtype=torch.int32, device="meta"))
    batches_s = sp.train_batches(cfg, shape, n_clients, tau, abstract=True)
    state_sh = shd.fed_state_shardings(mesh, params_s, specs, cfg.fed_plan,
                                       n_clients)
    if embed_fix:
        xb, cc = dict(state_sh.x_bar), dict(state_sh.c)
        xb["embed"] = shd.NamedSharding(mesh, shd.PartitionSpec(None,
                                                                "model"))
        cc["embed"] = shd.NamedSharding(mesh, shd.PartitionSpec(None, None,
                                                                "model"))
        state_sh = DProxState(x_bar=xb, c=cc, round=state_sh.round)
    batch_plan = "A_dp" if (inner_dp and cfg.fed_plan == "A") else cfg.fed_plan
    batch_sh = shd.batch_shardings(mesh, batches_s, batch_plan)
    fn = _placed_round(fcfg, reg, grad_fn, mesh, cfg.fed_plan, n_clients,
                       b_local, batch_plan, state_sh)
    return fn, (state_s, batches_s), (state_sh, batch_sh), (state_sh,
                                                            None), (0,)


def _request_lead(x, sharding):
    """The dims of a request-batch leaf whose sharding divides them over
    the request axes (kept local; everything else is gathered)."""
    return tuple(i for i, e in enumerate(sharding.spec) if e is not None
                 and "model" not in (e if isinstance(e, tuple) else (e,)))


def build_prefill(cfg, shape, mesh, multi_pod, last_only=False,
                  replicate_embed=False):
    """last_only: emit only the final-position logits (what a serving
    engine samples from).  replicate_embed: hold the embedding table
    replicated."""
    params_s, specs = abstract_model(cfg)
    batch_s = sp.prefill_batch(cfg, shape, abstract=True)
    param_sh = shd.tree_shardings(params_s, specs, shd.serving_param_rules(),
                                  mesh)
    if replicate_embed:
        param_sh = dict(param_sh)
        param_sh["embed"] = shd.NamedSharding(mesh, shd.PartitionSpec(
            None, None))
    rrules = shd.request_rules()

    def one(x):
        axes = ("batch",) + ("seq",) * (x.ndim - 1)
        return shd.NamedSharding(mesh, shd.spec_for(tuple(x.shape), axes,
                                                    rrules, mesh))

    batch_sh = tu.tree_map(one, batch_s)

    def fn(params, batch):
        p = tu.tree_map(_gathered, params)
        b = tu.tree_map(lambda x, s: _gathered(x, _request_lead(x, s)),
                        batch, batch_sh)
        return T.prefill(p, cfg, b, max_len=shape.seq_len,
                         last_only=last_only)

    return fn, (params_s, batch_s), (param_sh, batch_sh), None, ()


def build_decode(cfg, shape, mesh, multi_pod):
    lcfg = cfg.long_context_variant() if shape.name == "long_500k" else cfg
    params_s, specs = abstract_model(lcfg)
    caches_s, cache_specs = abstract_cache(lcfg, shape.global_batch,
                                           shape.seq_len)
    param_sh = shd.tree_shardings(params_s, specs, shd.serving_param_rules(),
                                  mesh)
    cache_sh = shd.tree_shardings(caches_s, cache_specs, shd.cache_rules(),
                                  mesh)
    tok_s = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                        device="meta")
    tok_sh = shd.NamedSharding(
        mesh, shd.spec_for(tuple(tok_s.shape), ("batch", "none"),
                           shd.request_rules(), mesh))
    len_s = torch.empty((), dtype=torch.int32, device="meta")
    len_sh = shd.NamedSharding(mesh, shd.PartitionSpec())

    def fn(params, caches, token, cache_len):
        p = tu.tree_map(_gathered, params)
        cs = shd._map_specs(
            lambda x, ax: _gathered(x, tuple(
                i for i, a in enumerate(ax) if a == "batch")),
            caches, cache_specs)
        tok = _gathered(token, (0,))
        return T.decode_step(p, lcfg, cs, tok, cache_len.to_local())

    return (fn, (params_s, caches_s, tok_s, len_s),
            (param_sh, cache_sh, tok_sh, len_sh), (None, cache_sh), (1,))


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


def _fake(x):
    return torch.empty(tuple(x.shape), dtype=x.dtype)


def _compile(builder, cfg, shape, mesh, multi_pod, **kw):
    """Trace one placed step on fake tensors: the counterpart of the
    reference's ``jit(...).lower(...).compile()``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    fn, args, in_sh, _out_sh, _donate = builder(cfg, shape, mesh, multi_pod,
                                                **kw)
    fallback = ReplicateFallback()
    with FakeTensorMode():
        placed = [tu.tree_map(lambda x, s: shd.place_abstract(_fake(x), s),
                              a, s) for a, s in zip(args, in_sh)]
        _, traced = roof.trace_step(
            fn, *placed, modes=(fallback, implicit_replication()))
    traced.replicated_ops = dict(fallback.ops)
    return traced


def _costs(compiled):
    ca = roof.cost_analysis_dict(compiled)
    coll = sum(c[3] for c in roof.parse_collectives(compiled.collectives))
    return (float(ca.get("flops", 0.0)),
            float(ca.get("bytes accessed", 0.0)), coll)


def probe_costs(arch_cfg, shape, mesh, multi_pod, tau, builders):
    """Loop-corrected (flops, bytes, coll_bytes) per device at the REAL
    (n_periods, tau) via the linear probe model of the module docstring."""
    kind = shape.kind
    P_real = arch_cfg.n_periods
    builder = builders[kind]
    if kind == "train":
        f = {}
        for (P, t) in [(2, 1), (3, 1), (2, 2), (3, 2)]:
            c = _compile(builder, probe_cfg(arch_cfg, P), shape, mesh,
                         multi_pod, tau=t, micro=1, unroll_round=True)
            f[(P, t)] = _costs(c)

        def fit(i):
            f21, f31, f22, f32 = (f[(2, 1)][i], f[(3, 1)][i], f[(2, 2)][i],
                                  f[(3, 2)][i])
            C = (f32 - f22) - (f31 - f21)       # per-period-per-step
            A1 = (f31 - f21) - C                # per-period fixed
            B = (f22 - f21) - 2 * C             # per-step fixed
            A0 = f21 - 2 * A1 - (B + 2 * C)     # round fixed
            return A0 + A1 * P_real + tau * (B + C * P_real)

        return tuple(max(fit(i), 0.0) for i in range(3))
    f2 = _costs(_compile(builder, probe_cfg(arch_cfg, 2), shape, mesh,
                         multi_pod))
    f3 = _costs(_compile(builder, probe_cfg(arch_cfg, 3), shape, mesh,
                         multi_pod))

    def fit(i):
        C = f3[i] - f2[i]
        A_ = f2[i] - 2 * C
        return A_ + C * P_real

    return tuple(max(fit(i), 0.0) for i in range(3))


def _mesh(multi_pod: bool):
    """The production mesh over the fake world (opened on first use)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        mesh_lib.fake_world(WORLD)
    return mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")


def run_one(arch: str, shape_name: str, mesh_name: str, tau: int = DEFAULT_TAU,
            outdir: str = "experiments/dryrun_torch", builders=None,
            note: str = "", cfg_override=None, probes: bool = True):
    """Trace one combination; returns (status, report_or_reason)."""
    shape = SHAPES[shape_name]
    cfg = cfg_override if cfg_override is not None else registry.get(arch)
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return "skip", why
    builders = builders or BUILDERS
    multi_pod = mesh_name == "multi"
    mesh = _mesh(multi_pod)
    n_chips = mesh.size()

    kw = {"tau": tau} if shape.kind == "train" else {}
    t0 = time.perf_counter()
    compiled = _compile(builders[shape.kind], cfg, shape, mesh, multi_pod,
                        **kw)
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    if probes:
        flops, byts, coll = probe_costs(cfg, shape, mesh, multi_pod, tau,
                                        builders)
    else:
        flops, byts, coll = _costs(compiled)
    t_probe = time.perf_counter() - t0

    lcfg = cfg.long_context_variant() if shape.name == "long_500k" else cfg
    params_s, _ = abstract_model(lcfg)
    mf = roof.model_flops_for(cfg, shape, params_s,
                              tau=tau if shape.kind == "train" else 1)
    rep = roof.analyze(
        compiled, arch=arch, shape=shape_name, mesh_name=mesh_name,
        n_chips=n_chips, step_kind=shape.kind, model_flops=mf, note=note)
    rep = dataclasses.replace(
        rep,
        flops_per_dev=flops, bytes_per_dev=byts, coll_bytes_per_dev=coll,
        compute_s=flops / roof.PEAK_FLOPS, memory_s=byts / roof.HBM_BW,
        collective_s=coll / roof.LINK_BW,
        useful_ratio=(mf / (flops * n_chips)) if flops else 0.0,
    )
    rep = dataclasses.replace(
        rep,
        dominant=max([("compute", rep.compute_s), ("memory", rep.memory_s),
                      ("collective", rep.collective_s)],
                     key=lambda kv: kv[1])[0])

    rep_d = json.loads(rep.to_json())
    rep_d["timing"] = {"compile": t_compile, "probes": t_probe}
    rep_d["memory_analysis_raw"] = str(compiled.memory_analysis())
    rep_d["replicated_ops"] = compiled.replicated_ops
    path = pathlib.Path(outdir)
    path.mkdir(parents=True, exist_ok=True)
    suffix = f"_{note}" if note else ""
    (path / f"{arch}_{shape_name}_{mesh_name}{suffix}.json").write_text(
        json.dumps(rep_d, indent=1))
    return "ok", rep


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Trace every (arch x shape x mesh) step on a fake "
                    "512-rank world and write its roofline report.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--tau", type=int, default=DEFAULT_TAU)
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip cost probes (placement validation only)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    archs = registry.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_skip = n_fail = 0
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                tag = f"{arch} x {shape} x {mesh_name}"
                try:
                    status, out = run_one(arch, shape, mesh_name,
                                          tau=args.tau, outdir=args.outdir,
                                          probes=not args.no_probes)
                except Exception:  # noqa: BLE001 -- reported, run goes on
                    n_fail += 1
                    print(f"FAIL {tag}\n{traceback.format_exc()}", flush=True)
                    continue
                if status == "skip":
                    n_skip += 1
                    print(f"SKIP {tag}: {out}", flush=True)
                else:
                    n_ok += 1
                    print(f"OK   {out.summary()}", flush=True)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skip, {n_fail} fail "
          f"({time.perf_counter() - t0:.1f} s)")
    mesh_lib.close_world()
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
