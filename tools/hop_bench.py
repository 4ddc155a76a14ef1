"""Time the search hop's kernels on the card at the smoke's shapes, with
the wrapper's host cost apart from the kernel.

    PYTHONPATH=<tree>/src python tools/hop_bench.py --tag NAME

For ``gather_distances`` (fp32 and int8 codes) and ``visited_filter`` at
the hop shapes of ``chip_smoke.py``'s phase 2 (and the int8 seeds), one
JSON line a shape with:

* ``ms``: back-to-back calls between two CUDA events, the least of 3 means
  of 20 calls (how the smoke takes the gather's ``ms``; the filter's is
  one mean of 20);
* ``device_ms``: the same calls queued behind a sleep of the card, so the
  kernels run back to back (the smoke's ``device_ms``);
* ``host_us``: the host's time to issue one call (``perf_counter`` over
  20 calls, no synchronize), the least of 3;
* ``alone_ms``: one call between two events after a synchronize, the
  least of 20: a lone launch, as a host-paced loop sees it.

Inputs are seeded like the smoke's: 2^20 x 128 normal rows (int8 codes
from ``quantize_rows``), uniform ids, 5% out of range, 90% unmasked; the
visited tables are filled by three calls first.  It uses only the port's
public kernels (``gather_distances``, ``visited_table``,
``visited_filter``), so it runs against any tree of the port: run it
against two in one call, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import card_name, cuda_ms  # noqa: E402

from repro_torch.ann.quantize import quantize_rows  # noqa: E402
from repro_torch.configs.base import ANNConfig  # noqa: E402
from repro_torch.core import hotpath as HP  # noqa: E402
from repro_torch.kernels import l2dist, visited  # noqa: E402


def timings(fn) -> dict:
    ms = cuda_ms(fn, 20, repeats=3)
    device_ms = cuda_ms(fn, 20, repeats=3, ahead=True)
    host = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host = min(host, (time.perf_counter() - t0) / 20 * 1e6)
        torch.cuda.synchronize()
    alone = float("inf")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(20):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        alone = min(alone, start.elapsed_time(end))
    return dict(ms=ms, device_ms=device_ms, host_us=host, alone_ms=alone)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=10240)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(card_name(), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, d, B = args.n, 128, args.queries
    cfg = ANNConfig()
    small = 32 * cfg.small_t0
    X = torch.randn((n, d), generator=gen, device=dev)
    codes, scales = quantize_rows(X)

    def line(kernel, shape, fn):
        print(json.dumps(dict(tag=args.tag, kernel=kernel, shape=shape,
                              **timings(fn))), flush=True)

    for name, S, C in (("hop small", small, cfg.max_degree),
                       ("hop large", B, cfg.max_degree),
                       ("seeds large", B, cfg.large_n_seeds)):
        idx = torch.randint(0, n, (S, C), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[torch.rand((S, C), generator=gen, device=dev) < 0.05] = n
        mask = torch.rand((S, C), generator=gen, device=dev) < 0.9
        Q = torch.randn((S, 1, d), generator=gen, device=dev)
        if name != "seeds large":
            line("gather_distances", name,
                 lambda: l2dist.gather_distances(Q, X, idx, mask))
        line("gather_distances_int8", name,
             lambda: l2dist.gather_distances(Q, codes, idx, mask,
                                             scales=scales))
    for name, rows, bound in (
            ("small", small, cfg.small_hops * cfg.max_degree + 1),
            ("large", B, cfg.large_n_seeds
             + cfg.large_hops * cfg.max_degree)):
        table = HP.visited_table(rows, bound, device=dev)
        M = cfg.max_degree

        def lanes():
            ids = torch.randint(0, 1 << 20, (rows, M), generator=gen,
                                device=dev, dtype=torch.int32)
            ids[:, M // 2:] = ids[:, :M - M // 2]
            return ids, torch.rand((rows, M), generator=gen,
                                   device=dev) < 0.8

        for _ in range(3):
            visited.visited_filter(table, *lanes())
        ids, valid = lanes()
        line("visited_filter", name,
             lambda: visited.visited_filter(table, ids, valid))
    return 0


if __name__ == "__main__":
    sys.exit(main())
