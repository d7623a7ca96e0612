"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), entry for entry, with no process
group: both read only the mesh's axis sizes, so a stand-in mesh serves
(tests/test_infra.py's ``FakeMesh``).

  * ``spec_for`` over random logical axes and shapes (a property);
  * every arch's FULL-SIZE params (the port's ``abstract_params`` with
    :mod:`repro_torch.models.axes` against the reference's
    ``jax.eval_shape`` of ``init_model`` and its specs) and decode caches,
    on the single and multi production shapes, for plans A, A_dp and B:
    server params, per-client state, round batches and caches;
  * the mapping of specs onto DTensor placements and local blocks on a
    fake 512-rank world (a subprocess: the world is global to its
    process).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _hypo import given, settings
from _hypo import strategies as st

ROOT = Path(__file__).resolve().parents[1]
SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
ARCHS = ["stablelm_1_6b", "internvl2_26b", "recurrentgemma_9b",
         "mistral_nemo_12b", "mamba2_130m", "phi3_medium_14b",
         "grok_1_314b", "gemma2_9b", "deepseek_v3_671b", "hubert_xlarge"]


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _is_spec(x):
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


@given(seed=st.integers(0, 10_000))
@settings(max_examples=40, deadline=None)
def test_spec_for_is_the_references(seed):
    from repro.launch import sharding as R

    from repro_torch.launch import sharding as S

    rng = np.random.default_rng(seed)
    pool = list(R._COMMON_PARAMS) + ["client", "batch", "cache_seq", "seq"]
    tables = [R._COMMON_PARAMS, R.client_state_rules("A"),
              R.client_state_rules("B"), R.batch_rules("A"),
              R.batch_rules("A_dp"), R.batch_rules("B"), R.cache_rules(),
              R.request_rules()]
    ports = [S._COMMON_PARAMS, S.client_state_rules("A"),
             S.client_state_rules("B"), S.batch_rules("A"),
             S.batch_rules("A_dp"), S.batch_rules("B"), S.cache_rules(),
             S.request_rules()]
    for shape_ in (SINGLE, MULTI, {"data": 2, "model": 2}):
        mesh = FakeMesh(shape_)
        for _ in range(8):
            ndim = int(rng.integers(1, 5))
            axes = tuple(str(rng.choice(pool)) for _ in range(ndim))
            shape = tuple(int(rng.choice([1, 2, 8, 16, 32, 64, 100352, 7,
                                          24, 128, 256]))
                          for _ in range(ndim))
            for rt, pt in zip(tables, ports):
                assert tuple(S.spec_for(shape, axes, pt, mesh)) == tuple(
                    R.spec_for(shape, axes, rt, mesh)), (shape, axes)


def test_rule_tables_are_the_references():
    from repro.launch import sharding as R

    from repro_torch.launch import sharding as S

    assert S._COMMON_PARAMS == R._COMMON_PARAMS
    for plan in ("A", "A_dp", "B"):
        assert S.server_param_rules(plan) == R.server_param_rules(plan)
        assert S.client_state_rules(plan) == R.client_state_rules(plan)
        assert S.batch_rules(plan) == R.batch_rules(plan)
    assert S.serving_param_rules() == R.serving_param_rules()
    assert S.cache_rules() == R.cache_rules()
    assert S.request_rules() == R.request_rules()
    assert S.STATE_ROLES == R.STATE_ROLES


def _ref_model(arch):
    import jax

    from repro.configs import registry as jreg
    from repro.models import transformer as RT

    cap = {}

    def f(key):
        p, s = RT.init_model(key, jreg.get(arch))
        cap["s"] = s
        return p

    return jax.eval_shape(f, jax.random.PRNGKey(0)), cap["s"]


def _ref_specs(tree, specs, rules, mesh):
    """The reference's spec per leaf (its ``tree_shardings`` without the
    NamedSharding, which needs a real mesh), in JAX's leaf order."""
    import jax

    from repro.launch import sharding as R

    leaves = jax.tree_util.tree_leaves(tree)
    axes = jax.tree_util.tree_leaves(specs, is_leaf=_is_spec)
    return [tuple(R.spec_for(tuple(x.shape), ax, rules, mesh))
            for x, ax in zip(leaves, axes)]


def _port_specs(tree, specs, rules, mesh):
    from repro_torch.launch import sharding as S
    from repro_torch.utils import tree as tu

    sh = S.tree_shardings(tree, specs, rules, mesh)
    return [tuple(s.spec) for s in tu.tree_leaves(tu.canonical(sh))]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_batch_and_cache_specs_are_the_references(arch):
    import jax

    from repro.configs import registry as jreg
    from repro.configs.base import SHAPES as JSHAPES
    from repro.launch import dryrun as JD
    from repro.launch import sharding as R
    from repro.launch import specs as jspecs
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import sharding as S
    from repro_torch.launch import specs as sp
    from repro_torch.models import axes
    from repro_torch.roofline.analysis import abstract_params
    from repro_torch.utils import tree as tu
    import torch
    import torch.utils._pytree as pytree

    cfg = registry.get(arch)
    jcfg = jreg.get(arch)
    assert cfg.fed_plan == jcfg.fed_plan
    params = abstract_params(cfg)
    pspecs = axes.param_specs(cfg)
    jparams, jspecs_ = _ref_model(arch)
    # the spec trees themselves, leaf for leaf
    assert jax.tree_util.tree_leaves(jspecs_, is_leaf=_is_spec) == \
        pytree.tree_leaves(tu.canonical(pspecs), is_leaf=_is_spec)
    for shape_, multi in ((SINGLE, False), (MULTI, True)):
        mesh = FakeMesh(shape_)
        assert _port_specs(params, pspecs, S.server_param_rules("A"),
                           mesh) == _ref_specs(
            jparams, jspecs_, R.server_param_rules("A"), mesh)
        for plan in ("A", "A_dp", "B"):
            n = D.clients_for(plan if plan != "A_dp" else "A", multi)
            assert n == JD.clients_for(plan if plan != "A_dp" else "A",
                                       multi)
            cl = tu.tree_map(lambda x: torch.empty(
                (n,) + tuple(x.shape), dtype=x.dtype, device="meta"), params)
            jcl = jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct((n,) + x.shape, x.dtype),
                jparams)
            cspec = S._map_specs(lambda _, a: ("client",) + a, pspecs,
                                 pspecs)
            jcspec = jax.tree_util.tree_map(lambda a: ("client",) + a,
                                            jspecs_, is_leaf=_is_spec)
            assert _port_specs(cl, cspec, S.client_state_rules(plan),
                               mesh) == _ref_specs(
                jcl, jcspec, R.client_state_rules(plan), mesh)
            shape = SHAPES["train_4k"]
            b = sp.train_batches(cfg, shape, n, 4, abstract=True)
            jb = jspecs.train_batches(jcfg, JSHAPES["train_4k"], n, 4,
                                      abstract=True)
            got = [tuple(s.spec) for s in tu.tree_leaves(tu.canonical(
                S.batch_shardings(mesh, b, plan)))]
            exp = [tuple(R.spec_for(
                x.shape, ("client", "tau", "batch")
                + ("seq",) * (len(x.shape) - 3), R.batch_rules(plan), mesh))
                for x in jax.tree_util.tree_leaves(jb)]
            assert got == exp
        if cfg.decode_supported:
            dshape = SHAPES["decode_32k"]
            caches, cspecs = D.abstract_cache(cfg, dshape.global_batch,
                                              dshape.seq_len)
            jcaches, jcspecs = JD.abstract_cache(
                jcfg, dshape.global_batch, dshape.seq_len)
            assert _port_specs(caches, cspecs, S.cache_rules(), mesh) == \
                _ref_specs(jcaches, jcspecs, R.cache_rules(), mesh)
    # specs.py's abstract branch: meta leaves of the reference's shapes
    if cfg.decode_supported:
        _, dc, tok, cl = sp.decode_inputs(cfg, SHAPES["decode_32k"],
                                          abstract=True)
        _, jdc, jtok, jcl = jspecs.decode_inputs(
            jcfg, JSHAPES["decode_32k"], abstract=True)
        assert [tuple(x.shape) for x in tu.tree_leaves(tu.canonical(dc))] \
            == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jdc)]
        assert all(x.device.type == "meta" for x in tu.tree_leaves(dc))
        assert tuple(tok.shape) == tuple(jtok.shape) and cl.ndim == 0
    pb = sp.prefill_batch(cfg, SHAPES["prefill_32k"], abstract=True)
    jpb = jspecs.prefill_batch(jcfg, JSHAPES["prefill_32k"], abstract=True)
    assert [tuple(x.shape) for x in tu.tree_leaves(tu.canonical(pb))] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jpb)]


def test_carry_slices_take_the_client_axis_as_spec_for_does():
    from repro_torch.launch import sharding as S

    import torch

    for shape_ in (SINGLE, MULTI, {"data": 2, "model": 2}):
        mesh = FakeMesh(shape_)
        for n in (1, 2, 8, 16, 30, 32):
            for plan in ("A", "B"):
                exp = S.spec_for((n, 7), ("client", "none"),
                                 S.client_state_rules(plan), mesh)
                plane = torch.empty((n, 7), device="meta")
                queued = torch.empty((3, n, 7), device="meta")
                got = S.carry_slice_shardings(mesh, plane, plan, n)
                assert tuple(got.spec) == tuple(exp)
                q = S.carry_slice_shardings(mesh, queued, plan, n,
                                            client_axis=1)
                assert tuple(q.spec) == (None,) + tuple(exp)
                key = S.carry_slice_shardings(mesh, plane, plan, n,
                                              client_axis=None)
                assert tuple(key.spec) == (None, None)


FAKE_WORLD = r'''
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S

M.fake_world(512, rank=RANK)
mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
spec = S.PartitionSpec(("pod", "data"), "model", None)
sh = S.NamedSharding(mesh, spec)
assert sh.placements == (Shard(0), Shard(0), Shard(1))
shape = (64, 48, 5)
local, offset = S.local_block(shape, sh)
exp_local, exp_off = compute_local_shape_and_global_offset(
    shape, mesh, sh.placements)
assert local == tuple(exp_local) and offset == tuple(exp_off), (
    local, offset, exp_local, exp_off)
x = torch.arange(64 * 48 * 5, dtype=torch.float32).reshape(shape)
d = S.place(x, sh)
assert d.shape == x.shape and tuple(d.to_local().shape) == local
assert torch.equal(d.to_local(), S.local_chunk(x, sh))
try:
    S.placements(S.PartitionSpec(("data", "pod")), mesh)
    raise SystemExit("out-of-order axes accepted")
except ValueError:
    pass
single = M.make_mesh((16, 16), ("data", "model"), "cpu")
rep = S.NamedSharding(single, S.PartitionSpec(None, None))
assert rep.placements == (Replicate(), Replicate())
M.close_world()
print("FAKE_WORLD_OK", RANK)
'''


@pytest.mark.parametrize("rank", [0, 37, 511])
def test_placements_and_local_blocks_on_a_fake_world(rank):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-c", FAKE_WORLD.replace("RANK", str(rank))],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"FAKE_WORLD_OK {rank}" in run.stdout
