"""pixtral-12b — mistral-nemo-12b backbone + Pixtral-ViT frontend.

Per the task spec, the vision frontend is a STUB: ``input_specs`` supplies
precomputed patch embeddings [B, S_img, d_model] as the sequence prefix; the
backbone (40L d_model=5120 32H kv=8 d_ff=14336 vocab=131072) is exercised in
full. [hf:mistralai/Pixtral-12B-2409; unverified]"""
from ..models.common import dense_lm

ARCH = "pixtral-12b"
IMG_PREFIX_FRAC = 0.25   # fraction of the sequence that is image patches


def config():
    return dense_lm(ARCH, n_layers=40, d_model=5120, n_heads=32, n_kv=8,
                    d_ff=14336, vocab=131072, head_dim=128, rope_theta=1e6)


def smoke_config():
    return dense_lm(ARCH + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                    d_ff=96, vocab=512, head_dim=16, dtype="float32")
