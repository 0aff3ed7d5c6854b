"""What holds K2 (GroupNorm-FiLM-SiLU, forward and backward) back, on the card.

    python -m physicsinformeddiffusionmodels_tpu_torch.profile_k2

At B=64 and each distinct (N, C) of the Darcy UNet's 38 K2 calls, fp32 and
bf16 x, forward and backward: the device ms of a call (CUDA-graph replay)
with the plan the port takes (``ops/group_norm.py`` ``_plan``) and with k =
1, 2, 4, 8, 16 blocks a row (each holding what fits of its slice, the rest
re-read), beside the clusters of each plan that the card holds at once
(cudaOccupancyMaxActiveClusters: fewer than the 64 rows means a second wave
of clusters) and the time of ``x * 2``, one elementwise PyTorch call that
reads x and writes a tensor of its size (the card's streaming rate at that
size, no statistics). Prints the card's name and power limit, one JSON line
per (dtype, pass, shape), then the plan's times summed over the 38 calls.
No options.
"""

from __future__ import annotations

import json
import subprocess

import torch

from physicsinformeddiffusionmodels_tpu_torch.ops import group_norm as gn
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact
from physicsinformeddiffusionmodels_tpu_torch.utils.timing import graph_ms

B = 64
# distinct (N, C) of one UNet(dim=32) pass at 64x64 and how many K2 calls take it
CALLS = {(4096, 32): 10, (1024, 64): 4, (256, 128): 4, (64, 256): 8, (64, 128): 4,
         (256, 64): 4, (1024, 32): 4}
KS = (1, 2, 4, 8, 16)


def profile(dev: torch.device) -> list[dict]:
    gen = torch.Generator().manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        elt = 2 if bf16 else 4
        for (n, c), calls in CALLS.items():
            x = (torch.randn(B, n, c, generator=gen) * 2.0 + 0.5).to(dev, dtype)
            gamma, beta = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            scale = (torch.randn(B, c, generator=gen) * 0.1).to(dev)
            shift = (torch.randn(B, c, generator=gen) * 0.1).to(dev)
            dy = torch.randn(x.shape, generator=gen).to(dev, dtype)
            args = (x, gamma, beta, scale, shift)
            stats = gn.launch_forward(*args)[1]
            streaming = graph_ms(lambda: x * 2.0)
            for backward in (False, True):
                def run(plan):
                    if backward:
                        return graph_ms(lambda: gn.launch_backward(dy, *args, stats, plan=plan),
                                        reps=10)
                    return graph_ms(lambda: gn.launch_forward(*args, plan=plan))

                plan = gn._plan(B, n, c, 8, bf16, True, backward)
                by_k = {}
                for k in KS:
                    if k <= n:
                        p = gn.k2_plan_of(k, n, c, elt, backward)
                        by_k[k] = {"ms": run(p), "clusters_at_once": gn.max_clusters(
                            p, bf16, True, backward), "re_read": p.reread}
                rows.append({"dtype": str(dtype).split(".")[1], "pass": "bwd" if backward else "fwd",
                             "n": n, "c": c, "calls": calls,
                             "plan": {"k": plan.k, "tokens": plan.tokens,
                                      "resident": plan.resident, "smem": plan.smem},
                             "ms": run(plan), "by_k": by_k, "x_times_2_ms": streaming})
                print(json.dumps(rows[-1]), flush=True)
            del x, dy, stats
    return rows


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    set_fp32_exact()
    rows = profile(torch.device("cuda"))
    totals = {}
    for r in rows:
        key = f"{r['dtype']} {r['pass']}"
        totals[key] = totals.get(key, 0.0) + r["calls"] * r["ms"]
    print(json.dumps({"ms_at_the_38_calls": totals, "card": smi}))


if __name__ == "__main__":
    main()
