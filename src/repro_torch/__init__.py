"""PyTorch/CUDA port of the TPP tiered-KV serving stack.

The package mirrors the JAX package ``repro`` module by module
(``core/``, ``kernels/``, ``models/``, ``serving/``, ``configs/``,
``launch/``) and is held against it by ``tests/test_torch_*.py``.  It
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the hand-written Hopper
kernel (``kernels/csrc/*.cu``) or raises.
"""
