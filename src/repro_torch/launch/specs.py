"""Input construction for every (architecture x input shape) combination:
the real-array half of :mod:`repro.launch.specs`.

  train    -> federated round batches: leaves (n_clients, tau, b_local, ...)
  prefill  -> a request batch {tokens / patches+tokens / features+targets}
  decode   -> (cfg, caches, token, cache_len): ONE new token against a
              cache of ``shape.seq_len`` tokens

The arrays are drawn from ``numpy.random.default_rng(seed)`` in the
reference's order, so they are the reference's bit for bit: token ids as
int32; audio features and VLM patches as bfloat16 from the float64
normals (rounded through float32, as the reference's ``jnp.asarray``);
the audio mask as float32 0/1.  With ``abstract=True`` the leaves are
``meta`` tensors of the same shapes and dtypes instead, made with no data
and no draws: what the multi-pod dry run
(:mod:`repro_torch.launch.dryrun`) places and traces, as the reference's
``jax.ShapeDtypeStruct`` leaves.  Unlike the reference's, ``abstract``
defaults to ``False`` (real arrays), the port's behaviour before it had a
dry run.

Modality stubs, as the reference's: audio features are precomputed
conv-extractor frames, VLM patches precomputed InternViT embeddings; both
enter through the trainable projector in the model.  Every function takes
a ``device`` (default ``cuda``: :func:`repro_torch.device.resolve_device`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.utils import tree as tu


def _leaf(shape, dtype, rng, device, kind="tokens", vocab=None):
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if kind == "tokens":
        arr = rng.integers(0, vocab, size=shape)
    elif kind == "float":
        # float64 -> float32 -> bfloat16, as jnp.asarray(f64, bfloat16)
        arr = rng.normal(size=shape).astype(np.float32)
    elif kind == "mask":
        arr = rng.uniform(size=shape) < 0.08
    else:
        raise ValueError(kind)
    return torch.from_numpy(np.asarray(arr)).to(device=device, dtype=dtype)


def _example(cfg, batch, seq, rng, device):
    """One forward-pass batch for arch family ``cfg``."""
    if cfg.frontend == "audio":
        return {
            "features": _leaf((batch, seq, cfg.frontend_dim), torch.bfloat16,
                              rng, device, "float"),
            "targets": _leaf((batch, seq), torch.int32, rng, device,
                             "tokens", cfg.vocab),
            "mask": _leaf((batch, seq), torch.float32, rng, device, "mask"),
        }
    if cfg.frontend == "vision":
        s_img = max(seq // 4, 1)  # 25% image patches, 75% text
        return {
            "patches": _leaf((batch, s_img, cfg.frontend_dim),
                             torch.bfloat16, rng, device, "float"),
            "tokens": _leaf((batch, seq - s_img), torch.int32, rng, device,
                            "tokens", cfg.vocab),
        }
    return {"tokens": _leaf((batch, seq), torch.int32, rng, device, "tokens",
                            cfg.vocab)}


def _device(device, abstract: bool) -> torch.device:
    return torch.device("meta") if abstract else resolve_device(device)


def example(cfg, batch: int, seq: int, seed: int = 0, device=None, *,
            abstract: bool = False):
    """One forward-pass batch of ``batch`` x ``seq`` positions (the
    reference's ``_example`` with ``np.random.default_rng(seed)``)."""
    return _example(cfg, batch, seq, np.random.default_rng(seed),
                    _device(device, abstract))


def train_batches(cfg, shape: InputShape, n_clients: int, tau: int, seed=0,
                  device=None, *, abstract: bool = False):
    """Federated-round batches: (n_clients, tau, b_local, ...) leaves, one
    example batch broadcast over clients and local steps (views, as the
    reference's ``broadcast_to``)."""
    assert shape.global_batch % n_clients == 0, (
        f"global_batch {shape.global_batch} not divisible by {n_clients} "
        f"clients")
    ex = example(cfg, shape.global_batch // n_clients, shape.seq_len, seed,
                 device, abstract=abstract)
    return tu.tree_map(lambda x: x.expand((n_clients, tau) + tuple(x.shape)),
                       ex)


def prefill_batch(cfg, shape: InputShape, seed=0, device=None, *,
                  abstract: bool = False):
    return example(cfg, shape.global_batch, shape.seq_len, seed, device,
                   abstract=abstract)


def decode_inputs(cfg, shape: InputShape, seed=0, device=None, *,
                  abstract: bool = False):
    """(cfg, caches, token, cache_len) for one decode step: the config the
    shape runs (the long-context variant for ``long_500k``), zeroed caches
    of ``seq_len`` entries, a (B, 1) token and ``cache_len = seq_len - 1``
    (the tokens before the new one).  With ``abstract`` the caches come
    from a shape-only pass of ``init_cache``
    (:func:`repro_torch.device.eval_shape`)."""
    dev = _device(device, abstract)
    lcfg = cfg.long_context_variant() if shape.name == "long_500k" else cfg
    B = shape.global_batch
    if abstract:
        from repro_torch.device import eval_shape

        caches = eval_shape(lambda: T.init_cache(lcfg, B, shape.seq_len,
                                                 "cpu"))
    else:
        caches = T.init_cache(lcfg, B, shape.seq_len, dev)
    rng = np.random.default_rng(seed)
    token = _leaf((B, 1), torch.int32, rng, dev, "tokens", cfg.vocab)
    cache_len = torch.full((), shape.seq_len - 1, dtype=torch.int32,
                           device=dev)
    return lcfg, caches, token, cache_len
