"""gemma-7b — 28L d_model=3072 16H (GQA kv=16 = MHA) d_ff=24576 vocab=256000,
GeGLU, head_dim=256, tied embeddings. [arXiv:2403.08295]"""
from ..models.common import dense_lm

ARCH = "gemma-7b"


def config():
    return dense_lm(ARCH, n_layers=28, d_model=3072, n_heads=16, n_kv=16,
                    d_ff=24576, vocab=256000, head_dim=256, act="gelu",
                    rope_theta=1e4, tie_embeddings=True)


def smoke_config():
    return dense_lm(ARCH + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
                    d_ff=128, vocab=512, head_dim=32, act="gelu",
                    tie_embeddings=True, dtype="float32")
