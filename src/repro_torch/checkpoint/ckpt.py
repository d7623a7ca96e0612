"""Tree checkpointing: npz payload + json tree manifest.

The counterpart of :mod:`repro.checkpoint.ckpt`, in the same npz layout, so
a checkpoint written by either package restores in the other, bitwise.
Saves any tree of tensors or arrays (model params, a full ``DProxState``
including the per-client correction terms, the cohort population store)
with a dtype/shape manifest so restore can verify against a template.
Atomic write (tmp + rename; the tmp file is unlinked on any failure
mid-write).

Leaf keys are the escaped tree paths joined with ``"/"``, in
``jax.tree_util`` order and naming: dict keys sorted (a key's path
component is ``str(key)``), named-tuple fields by name, list and tuple
entries by index, ``None`` an empty subtree.  Each path component
backslash-escapes ``"\\"`` and ``"/"`` first, so a dict key that *contains*
a slash cannot silently overwrite a different leaf.  The manifest rides
under the reserved ``__manifest__`` entry; a leaf whose own path escapes to
that name is rejected loudly.

npz speaks only numpy dtypes: a bfloat16 leaf (a tensor here, an
``ml_dtypes`` array in the reference) is widened to float32 on disk --
losslessly -- and the manifest records ``"bfloat16"``.  Restore verifies
the *manifest* dtype against the template instead of casting whatever is on
disk, so a bf16 template round-trips bitwise while an f32 template against
a bf16 checkpoint is a loud mismatch.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.comm.wire import _numpy_dtype, dtype_name, torch_dtype

MANIFEST_KEY = "__manifest__"


def _escape(component: str) -> str:
    """Escape one path component so joining with "/" is unambiguous: the
    escape char itself first, then the separator."""
    return component.replace("\\", "\\\\").replace("/", "\\/")


def _children(tree):
    """``(path components, children, rebuild)`` of a container node in
    ``jax.tree_util`` order, ``None`` for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ([str(k) for k in keys], [tree[k] for k in keys],
                lambda ch: dict(zip(keys, ch)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (list(tree._fields), list(tree),
                lambda ch, t=type(tree): t(*ch))
    if isinstance(tree, (list, tuple)):
        return ([str(i) for i in range(len(tree))], list(tree),
                lambda ch, t=type(tree): t(ch))
    return None


def _map_with_paths(fn, tree, prefix=()):
    """Rebuild ``tree`` with every leaf replaced by ``fn(key, leaf)``, leaves
    visited in ``jax.tree_util`` order (``key``: the escaped path)."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn("/".join(_escape(c) for c in prefix), tree)
    names, children, rebuild = node
    return rebuild([_map_with_paths(fn, c, prefix + (n,))
                    for n, c in zip(names, children)])


def _flatten_with_paths(tree) -> dict:
    """Map escaped-path key -> leaf (leaves as they are)."""
    out: dict = {}

    def add(key, leaf):
        if key == MANIFEST_KEY:
            raise ValueError(
                f"leaf path {key!r} collides with the reserved npz manifest "
                "entry; rename that key")
        if key in out:
            raise ValueError(
                f"two tree paths flatten to the same npz key {key!r}; "
                "saving would silently drop one leaf")
        out[key] = leaf

    _map_with_paths(add, tree)
    return out


def _host(leaf) -> tuple:
    """(storable numpy array, manifest dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = dtype_name(t.dtype)
        if _numpy_dtype(name) is None:
            # bf16 / f8: widened to f32 on disk, losslessly
            return t.to(torch.float32).numpy(), name
        return t.numpy(), name
    v = np.asarray(leaf)
    name = str(v.dtype)
    if _numpy_dtype(name) is None:  # an ml_dtypes array (bf16, f8)
        return v.astype(np.float32), name
    return v, name


def save(tree: Any, path: str | os.PathLike,
         metadata: Optional[dict] = None) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = {k: _host(v) for k, v in _flatten_with_paths(tree).items()}
    f = tempfile.NamedTemporaryFile(dir=path.parent, suffix=".tmp",
                                    delete=False)
    tmp = f.name
    try:
        with f:
            manifest = {
                "leaves": {k: {"shape": list(v.shape), "dtype": name}
                           for k, (v, name) in leaves.items()},
                "metadata": metadata or {},
            }
            np.savez(f, **{MANIFEST_KEY: json.dumps(manifest)},
                     **{k: v for k, (v, _) in leaves.items()})
        os.replace(tmp, path)
    except BaseException:
        # anything between tmp creation and the rename (a non-storable
        # leaf mid-savez, unserializable metadata, ENOSPC) must not leak
        # the tmp file
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def restore(path: str | os.PathLike, like: Any, device=None) -> Any:
    """Restore into the structure of ``like`` (manifest dtype and shape
    verified against the template; no silent casts).

    ``like`` leaves may be tensors -- ``meta`` tensors included -- or numpy
    arrays, or anything with a numpy ``.shape``/``.dtype``; only their
    layout is read.  A tensor leaf restores as a tensor on ``device`` (by
    default the template's own device; a meta template's default is
    ``cuda``, as every entry point of the port); any other leaf restores as
    a numpy array.
    """
    from repro_torch.device import resolve_device

    _flatten_with_paths(like)  # the template's keys must be storable too
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z[MANIFEST_KEY]))["leaves"]

        def one(k, template):
            if k not in z:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            if k not in manifest:
                raise KeyError(f"checkpoint manifest missing leaf {k!r}")
            shape = tuple(int(s) for s in template.shape)
            name = dtype_name(template.dtype)
            if manifest[k]["dtype"] != name:
                raise ValueError(
                    f"{k}: template dtype {name} != checkpointed dtype "
                    f"{manifest[k]['dtype']} (restore refuses to silently "
                    "cast; pass a template in the dtype the checkpoint was "
                    "saved with, or convert explicitly after restoring)")
            arr = z[k]
            if list(arr.shape) != list(shape):
                raise ValueError(
                    f"{k}: checkpoint shape {tuple(arr.shape)} != template "
                    f"{shape}")
            if not isinstance(template, torch.Tensor):
                return arr.astype(np.dtype(template.dtype))
            # the on-disk array may be the widened form (bf16 stored as
            # f32): the manifest check above makes the cast back exact
            t = torch.from_numpy(arr).to(torch_dtype(name))
            dev = device if device is not None else (
                template.device if template.device.type != "meta" else None)
            return t.to(resolve_device(dev))

        return _map_with_paths(one, like)


def metadata(path: str | os.PathLike) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z[MANIFEST_KEY]))["metadata"]
