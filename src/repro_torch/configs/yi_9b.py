"""yi-9b — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
(llama-arch GQA). [arXiv:2403.04652]"""
from ..models.common import dense_lm

ARCH = "yi-9b"


def config():
    return dense_lm(ARCH, n_layers=48, d_model=4096, n_heads=32, n_kv=4,
                    d_ff=11008, vocab=64000, head_dim=128, rope_theta=1e4)


def smoke_config():
    return dense_lm(ARCH + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                    d_ff=96, vocab=512, head_dim=16, dtype="float32")
