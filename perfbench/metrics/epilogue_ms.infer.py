"""Device ms per call of the fused epilogue's kernels (``csrc/segsum.cu``):
the chunk offsets, the moments' chunk partials of every row policy
(``chunk_partials<ReluRows>``, ``chunk_partials<ZRows>``), their combine
and every apply variant (``relu_bn_apply``, ``bn_relu_apply``,
``bn_apply``, ``bn_add_relu_apply``). An inference window launches no
segment sum of its own, so its ``chunk_offsets`` and ``combine_partials``
are the epilogue's."""
from perfbench.lib.trace import from_csrc
from perfbench.metrics import _device

PARTS = ("chunk_offsets", "ReluRows>", "ZRows>", "combine_partials",
         "_apply<")


def _epilogue(name: str) -> bool:
    return from_csrc(name) and any(p in name for p in PARTS)


def read(ctx):
    if ctx.trace is None or ctx.kind != "closed" or not ctx.calls:
        return None
    t = _device.seconds(ctx, where=_epilogue)
    return 1e3 * t / ctx.calls if t > 0 else None
