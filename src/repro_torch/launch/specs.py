"""Input stand-ins for every (arch × shape) dry-run cell.

The port of ``repro/launch/specs.py``: the exact batches the lowered step
is called with, as tensors on the ``meta`` device (shapes and dtypes,
nothing allocated), each placed on the mesh by the reference's batch rule
(``dist.sharding.batch_spec``: the batch dim over ``("pod", "data")``
when it divides, else over ``"pod"``, else replicated), with its
embed-prefix handling (pixtral's image prefix, musicgen's frame inputs).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import configs
from ..configs.shapes import ShapeSpec
from ..dist.sharding import NamedSharding, batch_spec, distribute
from ..models.common import ModelConfig


def _meta(shape, dtype, mesh) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device="meta")
    return distribute(t, NamedSharding(mesh, batch_spec(mesh, shape[0])))


def train_input_specs(arch: str, cfg: ModelConfig, shape: ShapeSpec,
                      mesh) -> dict:
    B, S = shape.global_batch, shape.seq_len
    pre = configs.embed_prefix_len(arch, S)
    batch = {}
    if cfg.embedding_inputs:
        batch["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16, mesh)
        batch["labels"] = _meta((B, S), torch.int32, mesh)
        return batch
    if pre:
        batch["embeds"] = _meta((B, pre, cfg.d_model), torch.bfloat16, mesh)
    batch["tokens"] = _meta((B, S - pre), torch.int32, mesh)
    batch["labels"] = _meta((B, S - pre), torch.int32, mesh)
    return batch


def decode_input_specs(arch: str, cfg: ModelConfig, shape: ShapeSpec,
                       mesh) -> Tuple[dict, torch.Tensor]:
    """(token batch, pos scalar) for ``decode_step``."""
    B = shape.global_batch
    if cfg.embedding_inputs:
        batch = {"embeds": _meta((B, 1, cfg.d_model), torch.bfloat16, mesh)}
    else:
        batch = {"tokens": _meta((B, 1), torch.int32, mesh)}
    return batch, torch.zeros((), dtype=torch.int32, device="meta")
