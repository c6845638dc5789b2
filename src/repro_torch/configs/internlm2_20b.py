"""internlm2-20b — 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
[arXiv:2403.17297]"""
from ..models.common import dense_lm

ARCH = "internlm2-20b"


def config():
    return dense_lm(ARCH, n_layers=48, d_model=6144, n_heads=48, n_kv=8,
                    d_ff=16384, vocab=92544, head_dim=128, rope_theta=1e6)


def smoke_config():
    return dense_lm(ARCH + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                    d_ff=128, vocab=512, head_dim=16, dtype="float32")
