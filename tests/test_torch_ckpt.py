"""The port's checkpoints against the JAX reference's (repro_torch.checkpoint
vs repro.checkpoint): one npz layout, so a checkpoint written by either
package restores in the other, bitwise -- float32, float64, bfloat16 (f32
on disk, "bfloat16" in the manifest) and integer leaves, under the hostile
dict keys of tests/test_ckpt.py, and a whole engine state.  Restore checks
the manifest's dtype against the template (no silent casts), takes meta
tensors as templates and puts tensors on the device asked for; ``save`` is
atomic.  The hostile-key grid is a plain parametrization: no test here
takes a function-scoped fixture under ``@given``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import ckpt

HOSTILE_KEYS = ["plain", "a/b", "a/b/c", "tr/ailing/", "/leading",
                "back\\slash", "mix\\/ed", "\\", "//", "w|c", "  spaced  ",
                "__manifest", "__manifest__x", "0", "None"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int32": (torch.int32, jnp.int32)}


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _bits(x) -> tuple:
    """(dtype name, shape, raw bytes) of a tensor or array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[t.element_size()]
        return (str(t.dtype).removeprefix("torch."), tuple(t.shape),
                t.view(ints).numpy().tobytes())
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _leaves(tree) -> list:
    return [_bits(x) for x in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]


def _pair(dt: str, shape=(3, 4), seed=0):
    """One leaf in both packages' forms, the same bits."""
    x = np.random.default_rng(seed).standard_normal(shape) * 4
    tdt, jdt = DTYPES[dt]
    j = np.asarray(jnp.asarray(x).astype(jdt))
    if dt == "bfloat16":
        t = torch.from_numpy(j.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(j.copy())
    return t, j


def _hostile_tree(k1, k2, nest, kind):
    """tests/test_ckpt.py's hostile tree, as tensors (kind "torch") or as
    the reference's arrays (kind "jax")."""
    one = (lambda v: torch.tensor(v, dtype=torch.float64)) if kind == \
        "torch" else (lambda v: jnp.asarray(v, jnp.float64))
    inner = {k2: one([0.0, 1.0, 2.0])} if nest else one([0.0, 1.0, 2.0])
    if nest and k1 == k2:
        return {k1: inner}
    return {k1: inner, k2 + "_sibling": one([1.0, 1.0])}


@pytest.mark.parametrize("nest", [False, True])
@pytest.mark.parametrize("k1,k2", [
    (HOSTILE_KEYS[i], HOSTILE_KEYS[(3 * i + 1) % len(HOSTILE_KEYS)])
    for i in range(len(HOSTILE_KEYS))] + [("a/b", "a/b")])
def test_hostile_keys_cross_package(tmp_path, k1, k2, nest):
    tt, jt = _hostile_tree(k1, k2, nest, "torch"), _hostile_tree(
        k1, k2, nest, "jax")
    ckpt.save(tt, tmp_path / "t.npz")
    jckpt.save(jt, tmp_path / "j.npz")
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    out = jckpt.restore(tmp_path / "t.npz",
                        like=jax.tree_util.tree_map(jnp.zeros_like, jt))
    assert _leaves(out) == _leaves(jt)
    back = ckpt.restore(tmp_path / "j.npz",
                        like=jax.tree_util.tree_map(
                            lambda x: torch.empty_like(x, device="meta"),
                            tt), device="cpu")
    assert _leaves(back) == _leaves(tt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_dtypes_cross_package_bitwise(tmp_path, dt):
    t, j = _pair(dt)
    tt = {"w": t, "step": torch.tensor(3, dtype=torch.int64)}
    jt = {"w": j, "step": np.asarray(3, np.int64)}
    ckpt.save(tt, tmp_path / "t.npz", metadata={"round": 4})
    jckpt.save(jt, tmp_path / "j.npz", metadata={"round": 4})
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        for k in a.files:
            if k != ckpt.MANIFEST_KEY:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()
        assert str(a[ckpt.MANIFEST_KEY]) == str(b[ckpt.MANIFEST_KEY])
    assert ckpt.metadata(tmp_path / "j.npz") == {"round": 4}
    # the port restores the reference's file, the reference the port's
    like = {"w": torch.empty(t.shape, dtype=t.dtype, device="meta"),
            "step": torch.empty((), dtype=torch.int64, device="meta")}
    got = ckpt.restore(tmp_path / "j.npz", like, device="cpu")
    assert _bits(got["w"]) == _bits(t) and got["w"].device.type == "cpu"
    jlike = {"w": jax.ShapeDtypeStruct(j.shape, j.dtype),
             "step": jax.ShapeDtypeStruct((), jnp.int64)}
    jgot = jckpt.restore(tmp_path / "t.npz", jlike)
    assert _bits(jgot["w"]) == _bits(j)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_dtype_mismatch_is_refused(tmp_path, dt):
    t, _ = _pair(dt)
    ckpt.save({"w": t}, tmp_path / "d.npz")
    wrong = torch.float32 if t.dtype != torch.float32 else torch.float64
    with pytest.raises(ValueError, match="refuses to silently cast"):
        ckpt.restore(tmp_path / "d.npz",
                     {"w": torch.empty(t.shape, dtype=wrong, device="meta")},
                     device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path / "d.npz",
                     {"w": torch.empty(9, dtype=t.dtype)})


def test_bf16_is_f32_on_disk_and_restores_losslessly(tmp_path):
    t, _ = _pair("bfloat16", (64,))
    ckpt.save({"w": t}, tmp_path / "bf.npz")
    with np.load(tmp_path / "bf.npz", allow_pickle=False) as z:
        assert z["w"].dtype == np.float32
    out = ckpt.restore(tmp_path / "bf.npz", {"w": t})
    assert out["w"].dtype == torch.bfloat16 and _bits(out["w"]) == _bits(t)


def test_numpy_templates_restore_numpy(tmp_path):
    tree = {"ids": np.arange(5, dtype=np.int64),
            "rows": [np.ones((5, 2), np.float32)]}
    ckpt.save(tree, tmp_path / "n.npz")
    like = {"ids": np.broadcast_to(np.zeros((), np.int64), (5,)),
            "rows": [np.empty((5, 2), np.float32)]}
    out = ckpt.restore(tmp_path / "n.npz", like)
    assert isinstance(out["ids"], np.ndarray)
    assert _leaves(out) == _leaves(tree)


def test_meta_template_defaults_to_the_card(tmp_path, monkeypatch):
    ckpt.save({"w": torch.ones(2)}, tmp_path / "m.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(tmp_path / "m.npz",
                     {"w": torch.empty(2, device="meta")})


def test_slash_key_does_not_alias_nested_path(tmp_path):
    flat = {"a/b": torch.full((2,), 1.0)}
    nested = {"a": {"b": torch.full((2,), 2.0)}}
    ckpt.save(flat, tmp_path / "f.npz")
    ckpt.save(nested, tmp_path / "n.npz")
    assert _leaves(ckpt.restore(tmp_path / "f.npz", flat)) == _leaves(flat)
    with pytest.raises(KeyError):
        ckpt.restore(tmp_path / "f.npz", like=nested)
    with pytest.raises(KeyError):
        ckpt.restore(tmp_path / "n.npz", like=flat)


def test_collisions_and_the_reserved_key_raise(tmp_path):
    class K:
        def __init__(self, tag):
            self.tag = tag

        def __hash__(self):
            return hash(self.tag)

        def __eq__(self, other):
            return isinstance(other, K) and self.tag == other.tag

        def __lt__(self, other):
            return self.tag < other.tag

        def __str__(self):
            return "same"

    with pytest.raises(ValueError, match="same npz key"):
        ckpt._flatten_with_paths({"a": {K(1): torch.ones(2),
                                        K(2): torch.zeros(2)}})
    with pytest.raises(ValueError, match="reserved"):
        ckpt.save({ckpt.MANIFEST_KEY: torch.ones(2)}, tmp_path / "m.npz")


def test_paths_are_the_references(tmp_path):
    """Named-tuple fields by name, sequences by index, None an empty
    subtree: the same npz keys as the reference's tree paths."""
    from repro.core.algorithm import DProxState as JState
    from repro_torch.core.algorithm import DProxState

    t = DProxState(x_bar={"w": torch.ones(3), "b": torch.zeros(())},
                   c=[torch.ones(2, 3), None],
                   round=torch.tensor(2, dtype=torch.int32))
    j = JState(x_bar={"w": jnp.ones(3), "b": jnp.zeros(())},
               c=[jnp.ones((2, 3)), None], round=jnp.asarray(2, jnp.int32))
    assert list(ckpt._flatten_with_paths(t)) == list(
        jckpt._flatten_with_paths(j)[0])


def test_engine_state_cross_package(tmp_path):
    """A whole DProxState after a few rounds of the port's engine restores
    bitwise into the reference's template, and back."""
    from repro.core.algorithm import DProxState as JState
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.core.prox import L1
    from repro_torch.exec import ArraySupplier, EngineConfig, RoundEngine
    from repro_torch.fed.simulator import DProxAlgorithm
    from repro_torch.models import logreg

    rng = np.random.default_rng(0)
    n, d = 4, 6
    data = {"a": rng.standard_normal((n, 10, d)),
            "y": (rng.random((n, 10)) > 0.5).astype(np.float64)}
    alg = DProxAlgorithm(L1(lam=0.01), DProxConfig(tau=2, eta=0.05,
                                                   eta_g=2.0))
    eng = RoundEngine(alg, logreg.make_grad_fn(), n,
                      EngineConfig(chunk_rounds=2), device="cpu")
    state = eng.init({"w": torch.zeros(d, dtype=torch.float64),
                      "b": torch.zeros((), dtype=torch.float64)})
    state, _ = eng.run(state, ArraySupplier(data, 2, 4, seed=1), rounds=4)
    ckpt.save(state, tmp_path / "s.npz", metadata={"round": 4})
    jlike = JState(
        x_bar={"w": jax.ShapeDtypeStruct((d,), jnp.float64),
               "b": jax.ShapeDtypeStruct((), jnp.float64)},
        c={"w": jax.ShapeDtypeStruct((n, d), jnp.float64),
           "b": jax.ShapeDtypeStruct((n,), jnp.float64)},
        round=jax.ShapeDtypeStruct((), jnp.int32))
    jstate = jckpt.restore(tmp_path / "s.npz", jlike)
    assert _leaves(jstate) == _leaves(state)
    jckpt.save(jstate, tmp_path / "j.npz")
    back = ckpt.restore(tmp_path / "j.npz", state)
    assert type(back) is type(state) and _leaves(back) == _leaves(state)
    assert jckpt.metadata(tmp_path / "s.npz") == {"round": 4}


def test_save_failure_leaves_no_tmp_file(tmp_path, monkeypatch):
    p = tmp_path / "fail.npz"
    with pytest.raises(TypeError):
        ckpt.save({"ok": torch.ones(2)}, p, metadata={"f": lambda: 0})

    def boom(*a, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(ckpt.np, "savez", boom)
    with pytest.raises(OSError):
        ckpt.save({"ok": torch.ones(2)}, p)
    monkeypatch.undo()
    assert not p.exists()
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    ckpt.save({"ok": torch.ones(2)}, p)
    assert p.exists()
