"""The benchmark's plain reference against the program on the CPU, on the
benchmark's own weights: the transformer at the program's stablelm smoke
sizes, the CNN at its full size on a tiny batch; loss and every gradient
leaf.  And the TF32 control's rounding."""
import _pbpath  # noqa: F401
import numpy as np
import pytest
import torch

from families import cnn as fam_cnn
from families import transformer as fam_lm
from pb import program, spec
from reference import precision as P

SEEDS = (0, 2**31 + 5)


def _lm_cfg():
    cfg = dict(spec.cell("stablelm-1.6b.dprox-dense").config)
    cfg.update(_pbpath.TINY_LM)
    return cfg


def _compare(port_fn, ref_fn, params, batch, loss_tol, grad_tol):
    loss_p, grads_p = port_fn(params, batch)
    loss_r, grads_r = ref_fn(program.flat(params), batch)
    assert abs(float(loss_p) - float(loss_r)) <= loss_tol * abs(float(loss_r))
    gp = program.flat(grads_p)
    assert set(gp) == set(grads_r)
    for k, g in grads_r.items():
        err = float((gp[k] - g).abs().max())
        assert err <= grad_tol * max(float(g.abs().max()), 1e-30), k


@pytest.mark.parametrize("seed", SEEDS)
def test_transformer_reference_is_the_program(seed):
    cfg = _lm_cfg()
    params = fam_lm.init_params(cfg, seed, "cpu")
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg["vocab"], size=(3, 24)), dtype=torch.int32)
    _compare(fam_lm.port_grad_fn(cfg), fam_lm.reference_loss_and_grad(
        cfg, "exact"), params, {"tokens": tokens}, 1e-6, 1e-4)


@pytest.mark.parametrize("seed", SEEDS)
def test_cnn_reference_is_the_program(seed):
    cfg = _pbpath.load("fig4-cnn.dprox-t10").config
    params = fam_cnn.init_params(cfg, seed, "cpu")
    rng = np.random.default_rng(seed)
    batch = {"x": torch.as_tensor(rng.uniform(size=(4, 28, 28, 1)),
                                  dtype=torch.float32),
             "y": torch.as_tensor(rng.integers(0, 10, size=4))}
    _compare(fam_cnn.port_grad_fn(cfg), fam_cnn.reference_loss_and_grad(
        cfg, "exact"), params, batch, 1e-6, 1e-4)


def test_weights_follow_the_program_layout():
    """The benchmark's weights have the program's leaves, shapes and
    scales (its ``init_model`` / ``init_params``)."""
    from repro_torch.models import cnn
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import AttnCfg

    cfg = _lm_cfg()
    arch = T.ArchConfig(name="x", family="dense", n_layers=cfg["n_layers"],
                        d_model=cfg["d_model"], d_ff=cfg["d_ff"],
                        vocab=cfg["vocab"],
                        attn=AttnCfg(num_heads=4, num_kv_heads=4,
                                     head_dim=32),
                        param_dtype=torch.float32)
    ours = program.flat(fam_lm.init_params(cfg, 3, "cpu"))
    theirs = program.flat(T.init_model(torch.Generator().manual_seed(3),
                                       arch))
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        assert abs(float(ours[k].std()) - float(theirs[k].std())) \
            <= 0.1 * float(theirs[k].std()) + 1e-6, k
    c_ours = fam_cnn.init_params(_pbpath.load("fig4-cnn.dprox-t10").config, 3,
                                 "cpu")
    c_theirs = cnn.init_params(3, device="cpu")
    assert list(c_ours) == list(c_theirs)
    assert all(c_ours[k].shape == c_theirs[k].shape for k in c_ours)


def test_weights_come_from_the_seed():
    cfg = _pbpath.load("fig4-cnn.dprox-t10").config
    a = fam_cnn.init_params(cfg, 7, "cpu")
    b = fam_cnn.init_params(cfg, 7, "cpu")
    c = fam_cnn.init_params(cfg, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1_w"], c["fc1_w"])


@pytest.mark.parametrize("x", [1.0, -1.0, 1 + 2**-11, 1 + 2**-12, 1 + 3 * 2**-12,
                               -(1 + 3 * 2**-12), 3.14159265, 0.0])
def test_round_tf32(x):
    """10 mantissa bits, to nearest, ties away from zero."""
    got = float(P.round_tf32(torch.tensor([x], dtype=torch.float32))[0])
    m, e = np.frexp(np.float32(x))
    want = float(np.ldexp(np.sign(m) * np.floor(abs(m) * 2**11 + 0.5) / 2**11,
                          e))
    assert got == want


@pytest.mark.parametrize("key,value", [
    ("norm", "layernorm"), ("rotary_fraction", 0.25), ("qkv_bias", True),
    ("tie_embeddings", False), ("param_dtype", "bfloat16"), ("tf32", True)])
def test_transformer_architecture_it_cannot_build_is_refused(key, value):
    """A configuration key that states what neither the program's model nor
    the reference computes is refused by both, not ignored."""
    cfg = _lm_cfg()
    cfg[key] = value
    with pytest.raises(ValueError, match=key):
        fam_lm.port_grad_fn(cfg)
    with pytest.raises(ValueError, match=key):
        fam_lm.reference_loss_and_grad(cfg, "exact")


@pytest.mark.parametrize("key,value", [("param_dtype", "float64"),
                                       ("tf32", True)])
def test_cnn_architecture_it_cannot_build_is_refused(key, value):
    cfg = dict(_pbpath.load("fig4-cnn.dprox-t10").config)
    cfg[key] = value
    with pytest.raises(ValueError, match=key):
        fam_cnn.port_grad_fn(cfg)
    with pytest.raises(ValueError, match=key):
        fam_cnn.reference_loss_and_grad(cfg, "exact")
