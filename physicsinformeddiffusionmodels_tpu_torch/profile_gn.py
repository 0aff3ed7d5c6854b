"""GroupNorm-FiLM-SiLU variants at the Darcy level-0 shape, on the card
(port of ``scripts/profile_gn.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.profile_gn

B=64, N=4096, C=32, G=8, bf16, with inputs drawn as the JAX script draws
them, from a fixed seed (x standard normal; gamma 1, beta 0; scale and
shift normal x 0.1, all rounded to bf16; the port's kernels take the
parameters as fp32). Device time per
call from replaying ``REPS`` calls captured in one CUDA graph, for:
  * K2's forward on bf16 (the script's "pallas current"),
  * its plain PyTorch version (the script's "plain XLA"),
  * K5, the lane-packed kernel with the affine and FiLM folded in, at its
    plan (``k5_plan``) and at every other cluster size K5_CLUSTERS, with the
    plan's shared memory a block and the clusters the card holds at once.
Beside each time: GB/s effective, the script's own figure of 2 B N C 2
bytes (x read and written once, bf16) over the time; max |K5 - K2| of
one call each on the same input; and the kernel nodes and all nodes of a
CUDA graph of one K5 call (one and one: the FiLM fold inside the kernel).
The script's ``bk`` sweep sets the TPU kernel's rows per grid step, a VMEM
block size with no counterpart here.
No options; the last line is one JSON object.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess

import torch

from physicsinformeddiffusionmodels_tpu_torch.ops import _build
from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import (
    group_norm_film_silu,
    group_norm_film_silu_packed,
    group_norm_film_silu_plain,
    k5_max_clusters,
    k5_plan,
)
from physicsinformeddiffusionmodels_tpu_torch.utils.timing import graph_ms

B, N, C, G = 64, 4096, 32, 8
REPS = 50  # as the JAX script's timing loop
BYTES = 2 * B * N * C * 2
K5_CLUSTERS = (1, 2, 4, 8)  # k = 1 holds 192 KB of a row's 256 KB: the re-read mode


def inputs(dev: torch.device) -> tuple:
    """x [B, N, C] bf16 and gamma, beta [C], scale, shift [B, C] (bf16
    values, held in fp32), from seed 0."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(B, N, C, generator=gen).bfloat16()
    scale = (torch.randn(B, C, generator=gen).bfloat16() * 0.1).float()
    shift = (torch.randn(B, C, generator=gen).bfloat16() * 0.1).float()
    return tuple(t.to(dev) for t in (x, torch.ones(C), torch.zeros(C), scale, shift))


def graph_nodes_a_call(fn) -> tuple[int, int]:
    """(kernel nodes, all nodes) of a CUDA graph of one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    kernels = ctypes.c_int()
    nodes = _build.library().pidm_graph_nodes(graph.raw_cuda_graph(), ctypes.byref(kernels))
    _build.check(max(0, -nodes), "cudaGraphGetNodes")
    return kernels.value, nodes


def profile(dev: torch.device, clusters=K5_CLUSTERS) -> dict:
    """One call of K5 and of K2 on the same input (their max |difference|),
    K5's plan and kernels a call, then each variant's device time (K5 also
    at each of ``clusters`` but its plan's)."""
    args = inputs(dev)
    plan = k5_plan(B, N, C, G)
    with torch.no_grad():
        k5 = group_norm_film_silu_packed(*args, groups=G)
        k2 = group_norm_film_silu(*args, groups=G)
        torch.cuda.synchronize()
        out = {"device": torch.cuda.get_device_name(0), "shape": [B, N, C], "groups": G,
               "k5_vs_k2_max_abs_diff": (k5.float() - k2.float()).abs().max().item(),
               "max_abs_out": k2.float().abs().max().item(),
               "k5_plan": {**plan._asdict(), "clusters_at_once": k5_max_clusters(plan)},
               "k5_graph_kernel_and_all_nodes": graph_nodes_a_call(
                   lambda: group_norm_film_silu_packed(*args, groups=G))}
        variants = [("k2_fwd", group_norm_film_silu), ("plain", group_norm_film_silu_plain),
                    ("k5", group_norm_film_silu_packed)]
        variants += [(f"k5_k{k}", functools.partial(group_norm_film_silu_packed,
                                                    plan=k5_plan(B, N, C, G, k)))
                     for k in clusters if k != plan.k]
        for name, fn in variants:
            ms = graph_ms(lambda: fn(*args, groups=G), reps=REPS)
            out[f"{name}_ms"] = ms
            out[f"{name}_gb_per_s"] = BYTES / (ms * 1e-3) / 1e9
    return out


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    r = profile(torch.device("cuda"))
    for name in [k[:-3] for k in r if k.endswith("_ms")]:
        print(f"{name:8s} {r[f'{name}_ms'] * 1e3:9.1f} us  ({r[f'{name}_gb_per_s']:6.0f} GB/s "
              "effective)", flush=True)
    print(f"K5 plan {r['k5_plan']}, CUDA graph of one call: kernel nodes, all nodes "
          f"{r['k5_graph_kernel_and_all_nodes']}", flush=True)
    print(f"K5 max |diff| vs K2: {r['k5_vs_k2_max_abs_diff']:.3e} (max |out| "
          f"{r['max_abs_out']:.3e})", flush=True)
    print(json.dumps({**r, "card": smi}))


if __name__ == "__main__":
    main()
