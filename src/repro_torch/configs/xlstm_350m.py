"""xlstm-350m — 24L d_model=1024 4H, sLSTM + mLSTM blocks (xLSTM[7:1]:
3 super-blocks of 7 mLSTM + 1 sLSTM), vocab=50304, no separate FFN
(projection factor 2 inside the blocks). [arXiv:2405.04517; unverified]"""
from ..models.common import ModelConfig, SuperBlock

ARCH = "xlstm-350m"


def _blocks():
    return tuple([("mlstm", "none")] * 7 + [("slstm", "none")])


def config():
    return ModelConfig(
        name=ARCH, d_model=1024, n_heads=4, n_kv=4, head_dim=256,
        d_ff=0, vocab=50304,
        superblocks=(SuperBlock(blocks=_blocks(), repeat=3),),
        lstm_proj_factor=2.0, subquadratic=True, tie_embeddings=True)


def smoke_config():
    return ModelConfig(
        name=ARCH + "-smoke", d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=0, vocab=256,
        superblocks=(SuperBlock(blocks=(("mlstm", "none"), ("slstm", "none")),
                                repeat=2),),
        lstm_proj_factor=2.0, subquadratic=True, tie_embeddings=True,
        dtype="float32")
