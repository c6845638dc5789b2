"""Spira on PyTorch + CUDA: the port of ``repro`` for NVIDIA Hopper.

Layout mirrors the JAX package (``core/``, ``kernels/``, ``models/``,
``serve/``, ``obs/``, ``data/``) module for module; the hand-written CUDA
kernels live in ``csrc/`` and are built on first use by
``kernels._build``. Nothing here imports ``jax`` or ``repro``.

The reference contract is IEEE fp32 (``repro.core.dataflow``), so TF32 is
switched off for torch's own matmuls and cuDNN when the package is
imported, and stays off. Those switches govern ``torch.matmul`` and
cuDNN, not the port's kernels: the fp32 OS kernel
(``csrc/spconv_gather_gemm.cu``) runs 3xTF32 on the tensor cores, which
keeps fp32-class accuracy (``chip_smoke.py`` holds it against float64),
never plain TF32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
