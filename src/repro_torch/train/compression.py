"""Gradient compression for the data-parallel all-reduce (torch port of
``repro.train.compression``).

int8 block-quantization with error feedback: each gradient is flattened,
padded to blocks of ``BLOCK`` values, scaled per block by max|x| / 127,
rounded half to even (``torch.round``, as ``jnp.round``) and clipped to
int8; the dequantized value replaces the gradient and the quantization
error is carried to the next step (error feedback keeps convergence
unbiased in expectation). On one card there is no all-reduce to shrink:
the port keeps the option so that a compressed step computes what the
reference's does, codes included.
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 1024


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes ``[n_blocks, BLOCK]``, fp32 scales ``[n_blocks, 1]``)."""
    flat = g.float().reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = flat.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(flat / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def compress_tree(grads: dict, residual: dict | None):
    """Quantize every leaf of a nested dict with error feedback. Returns
    (dequantized tree in the gradients' dtypes, new fp32 residual)."""
    if residual is None:
        residual = _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)
    newg, newr = {}, {}
    for k, g in grads.items():
        if isinstance(g, dict):
            newg[k], newr[k] = compress_tree(g, residual[k])
            continue
        gf = g.float() + residual[k]
        q, s = quantize(gf)
        deq = dequantize(q, s, g.shape, torch.float32)
        newg[k], newr[k] = deq.to(g.dtype), gf - deq
    return newg, newr


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
