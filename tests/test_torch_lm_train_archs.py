"""The port's LM loss and gradients against the JAX package for the
architectures beyond the dense ones: qwen3-moe and kimi-k2 (MoE FFNs, the
router's gradient through the gates) and xlstm (mLSTM and sLSTM), at
their fp32 smoke configs, with the gates of
``tests/test_torch_lm_train.py`` (whose helpers this file imports);
``remat=True`` bitwise equal to ``remat=False`` for each. jamba, whose
reference takes longest to compile, has its own file
(``tests/test_torch_lm_train_jamba.py``) so that no file runs long."""
import pytest

from test_torch_lm_train import (check_loss_and_gradients,
                                 check_remat_is_bitwise)

ARCHS = ["kimi-k2-1t-a32b", "qwen3-moe-30b-a3b", "xlstm-350m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_leaf_gradient(arch):
    check_loss_and_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise(arch):
    check_remat_is_bitwise(arch)
