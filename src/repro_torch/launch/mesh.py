"""Device meshes over ``torch.distributed``: the counterpart of
:mod:`repro.launch.mesh`.

The reference's production meshes are TPU v5e pods (16 x 16 chips a pod, 2
pods for the multi-pod dry run); here a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with the reference's axis
names and shapes, over whatever process group is open:

  * :func:`fake_world` -- the dry run's world: ``world_size`` placeholder
    ranks in ONE process, through PyTorch's ``FakeProcessGroup`` (no
    communication happens; collectives return uninitialised buffers, which
    fake tensors never read).  The counterpart of the reference's
    ``--xla_force_host_platform_device_count=512``.
  * :func:`real_world` -- a one-rank real group (``nccl`` on the card,
    ``gloo`` on the CPU) over an in-process ``HashStore``: one H100 is one
    NCCL rank.
  * multi-rank worlds are opened by their launcher
    (``torch.distributed.init_process_group`` with an explicit address,
    rank and world size), as the multi-rank CPU tests do under ``gloo``.

A default process group is global to the process, so a program that opens
the fake world owns its process (the dry run does; the tests run it in a
subprocess).  Importing this module touches no process group:
``make_production_mesh`` and ``make_debug_mesh`` are functions, as in the
reference.  Meshes default to device type ``cuda``; pass ``"cpu"`` to build
one over CPU ranks.
"""
from __future__ import annotations

import torch

_FAKE_BACKEND = "repro_fake"


def _create_fake_pg(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup

    create = getattr(FakeProcessGroup, "_create_internal", None)
    if create is not None:
        return create(common_opts.group_rank, common_opts.group_size,
                      backend_opts)
    return FakeProcessGroup(common_opts.group_rank, common_opts.group_size)


def _register_fake_backend() -> None:
    import torch.distributed as dist

    if _FAKE_BACKEND in dist.Backend.backend_list:
        return
    dist.Backend.register_backend(_FAKE_BACKEND, _create_fake_pg,
                                  extended_api=True,
                                  devices=["cpu", "cuda"])


def fake_world(world_size: int, rank: int = 0) -> None:
    """Open a ``world_size``-rank fake default group in this process (the
    view of rank ``rank``).  Raises if a default group is already open."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a default process group is already open in this "
                           "process; the fake world needs a process of its "
                           "own")
    _register_fake_backend()
    dist.init_process_group(_FAKE_BACKEND, rank=rank, world_size=world_size,
                            store=dist.HashStore())


def real_world(device_type: str = "cuda") -> None:
    """Open a one-rank real default group: ``nccl`` for ``cuda`` (which
    needs a card: without one this raises), ``gloo`` for ``cpu``."""
    import torch.distributed as dist

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' to open a gloo group")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already open in this "
                           "process")
    backend = "nccl" if device_type == "cuda" else "gloo"
    kw = {}
    if device_type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, rank=0, world_size=1,
                            store=dist.HashStore(), **kw)


def close_world() -> None:
    """Destroy the default group, if one is open."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A :class:`DeviceMesh` of ``shape`` named ``axes`` over the open
    default group (the counterpart of ``make_mesh_compat``).  A ``cuda``
    mesh without a card raises rather than falling back to the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' to build a mesh over CPU "
                           "ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(n_devices: int | None = None, model: int = 2,
                    device_type: str = "cuda"):
    """A small ("data", "model") mesh over the open world's ranks (or
    ``n_devices`` of them)."""
    import torch.distributed as dist

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' to build a mesh over CPU "
                           "ranks")
    n = n_devices or dist.get_world_size()
    assert n % model == 0, (n, model)
    return make_mesh((n // model, model), ("data", "model"), device_type)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a :class:`DeviceMesh`, or of anything with a
    mapping ``shape`` (the reference's ``Mesh.shape``; the tests' stand-in
    meshes)."""
    shape = mesh.shape
    if hasattr(shape, "keys"):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))
