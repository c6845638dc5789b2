"""Spira on PyTorch + CUDA: the port of ``repro`` for NVIDIA Hopper.

Layout mirrors the JAX package (``core/``, ``kernels/``, ``models/``,
``serve/``, ``obs/``, ``data/``) module for module; the hand-written CUDA
kernels live in ``csrc/`` and are built on first use by
``kernels._build``. Nothing here imports ``jax`` or ``repro``.

The reference contract is IEEE fp32 (``repro.core.dataflow``), so TF32 is
switched off for matmuls and cuDNN when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
