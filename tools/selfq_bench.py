"""Time the self-query body of ``gather_distances`` (the diversify tiles,
[S, K, K] from S tiles of K gathered rows) on the card.

    PYTHONPATH=<tree>/src python tools/selfq_bench.py --tag NAME

Prints the card (``nvidia-smi``'s name and power limit), then one JSON line
a shape: the kernel's ms (CUDA events, the least of 5 means of 20 calls)
and the library call's (``X[idx]`` + ``torch.bmm``, TF32 off).  Rows are
seeded normal floats, 2^20 of them at d = 128 (a build's tile size) and
2^18 at d = 960.  To compare two trees' kernels, run it against each in
one call, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.kernels import l2dist

SHAPES = ((2048, 64, 128), (2048, 32, 128), (512, 128, 128),
          (256, 64, 960), (256, 128, 960))


def cuda_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for S, K, d in SHAPES:
        N = 1 << 20 if d <= 128 else 1 << 18
        X = torch.randn((N, d), generator=gen, device="cuda")
        idx = torch.randint(0, N, (S, K), generator=gen, device="cuda",
                            dtype=torch.int32)
        mask = torch.rand((S, K), generator=gen, device="cuda") < 0.9

        def kern():
            return l2dist.gather_distances(None, X, idx, mask, self_q=True)

        def library():
            V = X[idx.long()]
            return torch.bmm(V, V.transpose(1, 2))

        print(json.dumps(dict(tag=args.tag, S=S, K=K, d=d, ms=cuda_ms(kern),
                              library_ms=cuda_ms(library))), flush=True)
        del X


if __name__ == "__main__":
    main()
