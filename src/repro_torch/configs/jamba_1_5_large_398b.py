"""jamba-1.5-large-398b — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave.

Structure: 9 super-blocks of 8 sub-layers — 1 attention + 7 mamba, with MoE
on every other FFN (4 MoE + 4 dense per block), following the Jamba paper's
period-8 layout. [arXiv:2403.19887]"""
from ..models.common import ModelConfig, SuperBlock

ARCH = "jamba-1.5-large-398b"


def _blocks():
    out = []
    for i in range(8):
        kind = "attn" if i == 4 else "mamba"      # attention mid-block (paper)
        ffn = "moe" if i % 2 == 0 else "dense"
        out.append((kind, ffn))
    return tuple(out)


def config():
    return ModelConfig(
        name=ARCH, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
        d_ff=24576, vocab=65536,
        superblocks=(SuperBlock(blocks=_blocks(), repeat=9),),
        n_experts=16, top_k=2, d_ff_expert=24576,
        mamba_d_state=16, mamba_expand=2, mamba_conv=4,
        rope_theta=1e6, subquadratic=True)


def smoke_config():
    return ModelConfig(
        name=ARCH + "-smoke", d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, vocab=512,
        superblocks=(SuperBlock(blocks=_blocks(), repeat=1),),
        n_experts=4, top_k=2, d_ff_expert=96, capacity_factor=2.0,
        mamba_d_state=8, subquadratic=True, dtype="float32")
