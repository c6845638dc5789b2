"""Architecture registry: --arch <id> resolution + per-arch input specs."""
from __future__ import annotations

from . import (gemma_7b, internlm2_20b, jamba_1_5_large_398b, kimi_k2_1t_a32b,
               mistral_nemo_12b, musicgen_medium, pixtral_12b,
               qwen3_moe_30b_a3b, xlstm_350m, yi_9b)
from .shapes import SHAPES, ShapeSpec, applicable

_MODULES = [qwen3_moe_30b_a3b, kimi_k2_1t_a32b, internlm2_20b, yi_9b,
            gemma_7b, mistral_nemo_12b, pixtral_12b, jamba_1_5_large_398b,
            musicgen_medium, xlstm_350m]

ARCHS = {m.ARCH: m for m in _MODULES}


def get_config(arch: str, smoke: bool = False):
    m = ARCHS[arch]
    return m.smoke_config() if smoke else m.config()


def embed_prefix_len(arch: str, seq_len: int) -> int:
    """Length of the stub-embedding prefix for multimodal archs."""
    if arch.startswith("pixtral"):
        return int(seq_len * pixtral_12b.IMG_PREFIX_FRAC)
    return 0
