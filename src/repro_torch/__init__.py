"""repro_torch: the PyTorch + CUDA port of :mod:`repro`.

A second package beside the JAX reference.  It keeps ``repro``'s layout and
names, so each counterpart is easy to find, and never imports ``jax`` or
anything of ``repro`` (it carries its own copies of the numpy-only modules).

Ported so far: the paper's Fig. 2 main path -- sparse logistic regression
with an L1 regularizer, run by Algorithm 1 (DProx) through the round engine
-- with the fused local-update + L1-prox step as a hand-written CUDA kernel
for Hopper (``kernels/csrc/fused_prox.cu``); and the compressed uplink
(``repro_torch.comm``: top-k, rand-k and quantization with error feedback,
per leaf or over the whole flat plane, and the compressed downlink) through
the engine's communication stages, with global top-k's threshold select and
the stochastic quantizer as CUDA kernels (``kernels/csrc/plane_ops.cu``);
and simulated asynchrony and cohort-resident client state
(``repro_torch.sched`` through the engine's Asynchrony and Cohort stages),
with the buffered commit's client-axis sum on the flat plane as a CUDA
kernel (``weighted_commit`` in ``kernels/csrc/plane_ops.cu``); the paper's
experiments in full: the six baselines (``repro_torch.core.baselines``),
the Fig. 4 CNN (``repro_torch.models.cnn``) on the procedural MNIST split
(``repro_torch.data.mnist_like``), the literal protocol form of Algorithm 1
and every regularizer of the reference; and the single-chip tooling: the
autotuner of the engine's configuration (``repro_torch.tune``) and the
roofline's wire model and model-FLOP yardstick
(``repro_torch.roofline.analysis``); and the mesh: device meshes and the
sharding rules on ``torch.distributed`` DTensors (``repro_torch.launch``),
the engine's placement stage, the multi-pod dry run with the roofline's
traced half and the expert-parallel MoE (``repro_torch.models.moe_ep``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU present they raise instead of carrying on quietly on the CPU.
"""
from repro_torch.device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
