"""Trace the large-batch search on the card: device time by kernel.

    PYTHONPATH=<tree>/src python tools/search_trace.py --tag NAME

Builds the smoke's index (``make_clustered``, n = 2^20 x 128, seed 0, the
default ``ANNConfig``), then for fp32 and int8 residency in each visited
mode runs one warm search of the first 10,240 queries, traces a second
with ``torch.profiler`` and times ``--repeats`` more on the host clock
(each ending in a synchronize).  Prints the card (``nvidia-smi``'s name
and power limit), then one JSON line a search: those latencies, the
traced wall ms, device busy ms, the device ms of the search hop's
kernels (``csrc/l2dist.cu``'s row bodies, ``csrc/visited.cu``'s filter)
and of ``csrc/topk.cu``, and the costliest device ops.  To compare two trees' kernels, run it against each in one
call, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import (HOP_KERNELS, TOPK_KERNELS, card_name,  # noqa: E402
                        device_time, kernel_us)

from repro_torch.ann import Index  # noqa: E402
from repro_torch.configs.base import ANNConfig  # noqa: E402
from repro_torch.data.synthetic import make_clustered  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=10240)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(card_name(), flush=True)
    ds = make_clustered(n=args.n, d=128, n_queries=args.queries, k_gt=10,
                        seed=0, device=dev)
    cfg = ANNConfig()
    graph = Index.build(ds.X, cfg, device=dev).graph
    Q = ds.Q[:args.queries]
    for quant in ("none", "int8"):
        for visited in ("none", "hash"):
            idx = Index(ds.X, dataclasses.replace(
                cfg, visited_filter=visited, quantization=quant),
                graph=graph, device=dev)
            idx.search(Q)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                idx.search(Q)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            busy_us, top, per = device_time(prof, n_top=5)
            latency_ms = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                idx.search(Q)
                torch.cuda.synchronize()
                latency_ms.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps(dict(
                tag=args.tag, quantization=quant, visited=visited,
                B=args.queries, latency_ms=latency_ms, wall_ms=wall_ms,
                device_busy_ms=busy_us / 1e3,
                hop_ms={k: kernel_us(per, (k,)) / 1e3 for k in HOP_KERNELS},
                topk_ms=kernel_us(per, TOPK_KERNELS) / 1e3,
                top_ms=[(k[:60], v) for k, v in top])), flush=True)
            del idx
    return 0


if __name__ == "__main__":
    sys.exit(main())
