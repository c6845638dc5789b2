"""Shared arithmetic of the per-layer readers over a traced window."""
from perfbench.lib import stats, work
from perfbench.lib.trace import from_csrc, is_copy

PLAN = ("superwindow_kernel", "window_kernel", "repair_kernel")
OS = ("os_mma_kernel",)
WS = ("ws_pack_kernel", "ws_rank_kernel", "ws_sweep_kernel")
DW = ("dw_pack_kernel", "dw_mma_kernel", "dw_combine_kernel")


def seconds(ctx, names=None, where=None) -> float:
    """Device seconds of the operations whose short name contains one of
    ``names`` (or for which ``where(name)`` holds)."""
    tot = 0
    for n, s, e in ctx.trace.ops:
        if (names and any(k in n for k in names)) or (where and where(n)):
            tot += e - s
    return tot / 1e9


def roofline(ctx, family, names):
    """Percent of the bound: the family's least time over its measured
    device time; None where the window ran no such launch."""
    if ctx.trace is None or ctx.peak is None or not ctx.work.get(family):
        return None
    t = seconds(ctx, names)
    if t <= 0:
        return None
    return 100.0 * work.bound_seconds(ctx.work[family], ctx.peak) / t


def mfu(ctx):
    """Useful operations of the window over window x peak, in percent; the
    window on the host's clock."""
    if ctx.peak is None or not ctx.work.get("model"):
        return None
    return 100.0 * work.total_ops(ctx.work["model"]) / (
        ctx.window_s * ctx.peak["flops"])


def torch_ops(ctx):
    """Device seconds of everything not built from the program's CUDA
    sources: PyTorch's kernels, library GEMMs, copies and sets."""
    return seconds(ctx, where=lambda n: is_copy(n) or not from_csrc(n))


def busy(ctx) -> float:
    return stats.covered((s, e) for _, s, e in ctx.trace.ops) / 1e9


def idle_share(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - busy(ctx) / ctx.trace.seconds)
