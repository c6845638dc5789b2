"""The whole call's share of the card's peak: the useful operations of the
window (2 pairs Cin Cout per convolution, and the head) from the
reference's kernel maps, over window seconds x 495 TFLOP/s (dense TF32, the
fastest rate that takes fp32 operands). The window is the traced run's, on
the host's clock: the profiler's host overhead is in it."""
from perfbench.metrics import _device


def read(ctx):
    return _device.mfu(ctx) if ctx.kind == "closed" else None
