"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Sources live in ``csrc/`` and are built on first use by :mod:`._build`.
"""
