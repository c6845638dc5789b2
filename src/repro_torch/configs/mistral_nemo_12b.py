"""mistral-nemo-12b — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407]"""
from ..models.common import dense_lm

ARCH = "mistral-nemo-12b"


def config():
    return dense_lm(ARCH, n_layers=40, d_model=5120, n_heads=32, n_kv=8,
                    d_ff=14336, vocab=131072, head_dim=128, rope_theta=1e6)


def smoke_config():
    return dense_lm(ARCH + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                    d_ff=96, vocab=512, head_dim=16, dtype="float32")
