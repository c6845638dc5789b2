"""kimi-k2-1t-a32b — 61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert,
vocab=163840, MoE 384 experts top-8 (+1 shared). Trillion-param MoE.
[arXiv:2501.kimi2 per assignment; unverified]"""
from ..models.common import moe_lm

ARCH = "kimi-k2-1t-a32b"


def config():
    return moe_lm(ARCH, n_layers=61, d_model=7168, n_heads=64, n_kv=8,
                  d_ff_expert=2048, vocab=163840, n_experts=384, top_k=8,
                  head_dim=128, rope_theta=1e6, n_shared_experts=1)


def smoke_config():
    return moe_lm(ARCH + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                  d_ff_expert=48, vocab=512, n_experts=12, top_k=3,
                  head_dim=16, n_shared_experts=1, capacity_factor=2.0,
                  dtype="float32")
