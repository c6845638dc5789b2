"""The port's LM loss and gradients against the JAX package for jamba
(Mamba blocks, attention, dense and MoE FFNs) at its fp32 smoke config,
with the gates of ``tests/test_torch_lm_train.py`` (whose helpers this
file imports; the port's sequential Mamba scan rounds in another order
than the reference's associative scan, which the float64 calibration
there covers); ``remat=True`` bitwise equal to ``remat=False``."""
from test_torch_lm_train import (check_loss_and_gradients,
                                 check_remat_is_bitwise)

ARCH = "jamba-1.5-large-398b"


def test_loss_and_every_leaf_gradient():
    check_loss_and_gradients(ARCH)


def test_remat_is_bitwise():
    check_remat_is_bitwise(ARCH)
