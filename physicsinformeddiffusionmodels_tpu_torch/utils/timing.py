"""Device time of a call on the card, for the profilers and ``chip_smoke.py``."""

from __future__ import annotations

import contextlib

import torch

# a context around every timed replay: ``chip_smoke.py`` sets it to pause its
# background work while the card is timed
QUIET = contextlib.nullcontext


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` calls captured in one
    CUDA graph and replayed, so host work between launches is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: build, cuDNN, cuBLAS
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with QUIET():
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps
