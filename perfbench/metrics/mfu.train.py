"""The whole step's share of the card's peak: the useful operations of the
window (the forward, dF of every layer but the first, dW of every layer,
the head three times) from the reference's kernel maps, over window
seconds x 495 TFLOP/s (dense TF32, the fastest rate on fp32 operands). The
window is the traced run's, on the host's clock: the profiler's host
overhead is in it, and an eager step launches thousands of kernels."""
from perfbench.metrics import _device


def read(ctx):
    return _device.mfu(ctx) if ctx.kind == "train" else None
