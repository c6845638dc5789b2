"""musicgen-medium — 48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048;
decoder-only over EnCodec tokens. The EnCodec frontend is a STUB per the
task spec: ``input_specs`` supplies precomputed frame embeddings and the
model predicts codebook tokens (vocab 2048). [arXiv:2306.05284]"""
from ..models.common import dense_lm

ARCH = "musicgen-medium"


def config():
    return dense_lm(ARCH, n_layers=48, d_model=1536, n_heads=24, n_kv=24,
                    d_ff=6144, vocab=2048, head_dim=64, rope_theta=1e4,
                    embedding_inputs=True)


def smoke_config():
    return dense_lm(ARCH + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
                    d_ff=128, vocab=256, head_dim=16, embedding_inputs=True,
                    dtype="float32")
