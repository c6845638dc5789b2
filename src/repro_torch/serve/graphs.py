"""CUDA-graph capture for the serving paths: the session's one graph per
(bucket, escalation) key and the LM engine's decode step
(``serve.session``, ``serve.engine``).

:func:`capture` runs the body on a side stream first (the warm-up: the
kernel library's build, shared-memory attributes, cuBLAS handles and
workspaces and every device constant the body reads are made there, never
inside the capture), then captures it on that stream with
``capture_error_mode="thread_local"``, so that other threads (the serving
engine's watchdog and pack-ahead worker) may call the CUDA runtime
meanwhile. While a capture is open, destroying another graph invalidates
it; so cyclic garbage, which may hold an abandoned session's graphs, is
collected before the capture and the collector is off during it, and a
graph whose capture failed is reset at once, before anything else can
start a capture.
"""
from __future__ import annotations

import gc
from typing import Callable, Tuple

import torch

# runs of the body on the side stream before the capture: one makes
# everything a capture may not make
WARMUP_RUNS = 1


def capture(body: Callable[[], tuple], device: torch.device, *, pool=None
            ) -> Tuple["torch.cuda.CUDAGraph", tuple]:
    """Warm up and capture ``body`` on ``device``; returns the graph and
    the outputs of the captured run (the graph's own memory, rewritten by
    every replay). ``pool`` is the memory pool to share (a graph's
    ``pool()``), None for a new one. A failure raises: there is no eager
    fallback."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_RUNS):
            body()
    torch.cuda.current_stream(device).wait_stream(side)
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            outputs = body()
    except BaseException:
        graph.reset()
        raise
    finally:
        if collecting:
            gc.enable()
    return graph, outputs
