"""Time the packed SpMM's two routes (``csrc/segment_matmul.cu``) on the
card at the smoke's two shapes, A B B A in one process.

    PYTHONPATH=src python tools/spmm_bench.py --tag NAME

At GraphSAGE's first layer on Reddit over the whole graph (232,965 rows of
15 neighbours) and at minibatch_lg's first layer (16,384 rows of 10), both
over the 232,965 x 602 feature table through W [602, 128], mean, 10% of
the lanes sentinels (``chip_smoke.py``'s phase 9 inputs): one JSON line
each for the forced routes in the order fused, transform, transform,
fused, then the transform route's two kernels alone (the projection
beside ``torch.matmul(feat, w)`` with TF32 off, and the gather over Y).
Each line has ``ms``, ``device_ms``, ``host_us`` and ``alone_ms`` as
``tools/hop_bench.py`` defines them (``device_ms``: the calls queued
behind a sleep of the card) and the card's SM clock and power draw while
they ran, as ``tools/scan_bench.py`` samples them; the first line of the
output is the card's name and power limit, and each shape's line says
which route ``segment_matmul.path`` picks.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import (GNN_FANOUT, GNN_FEAT, GNN_HIDDEN,  # noqa: E402
                        GNN_MINIBATCH, GNN_NODES, card_name, spmm_case)
from hop_bench import timings  # noqa: E402
from scan_bench import Clocks  # noqa: E402

from repro_torch.kernels import segment_matmul as sm  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # the library yardstick
    print(card_name(), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    feat = torch.randn((GNN_NODES, GNN_FEAT), generator=gen, device=dev)
    w = torch.randn((GNN_FEAT, GNN_HIDDEN), generator=gen,
                    device=dev) * GNN_FEAT ** -0.5

    def line(shape, what, fn, **extra):
        with Clocks() as clk:
            row = timings(fn)
        print(json.dumps(dict(tag=args.tag, shape=shape, what=what, **extra,
                              **row, **clk.summary())), flush=True)

    for shape, (N, M) in (("graphsage", (GNN_NODES, GNN_FANOUT)),
                          ("minibatch_lg", GNN_MINIBATCH)):
        nbrs = spmm_case(N, M, dev, gen)
        route = sm.path(N, M, GNN_NODES, GNN_FEAT, GNN_HIDDEN)
        for via in ("fused", "transform", "transform", "fused"):
            line(shape, via, lambda: sm.packed_spmm(
                nbrs, feat, w, combine="mean", via=via), N=N, M=M,
                path=route)
        y = sm.project(feat, w)
        line(shape, "gather", lambda: sm.gather_rows(nbrs, y,
                                                     combine="mean"))
        del nbrs, y
    line("all rows", "project", lambda: sm.project(feat, w))
    line("all rows", "torch.matmul", lambda: torch.matmul(feat, w))
    return 0


if __name__ == "__main__":
    sys.exit(main())
