"""qwen3-moe-30b-a3b — 48L d_model=2048 32H (GQA kv=4) d_ff=768/expert,
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]"""
from ..models.common import moe_lm

ARCH = "qwen3-moe-30b-a3b"


def config():
    return moe_lm(ARCH, n_layers=48, d_model=2048, n_heads=32, n_kv=4,
                  d_ff_expert=768, vocab=151936, n_experts=128, top_k=8,
                  head_dim=128, rope_theta=1e6)


def smoke_config():
    return moe_lm(ARCH + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                  d_ff_expert=48, vocab=512, n_experts=8, top_k=2,
                  head_dim=16, capacity_factor=2.0, dtype="float32")
