"""Time the distance tiles of ``csrc/block.cu`` on the card at the smoke's
shapes, with the wrapper's host cost apart from the kernel.

    PYTHONPATH=<tree>/src python tools/scan_bench.py --tag NAME

For ``block_distances`` (fp32 rows and int8 codes) at the three block
shapes of ``chip_smoke.py``'s phase 2 (the delta scan at B = 32 and
B = 10240 over 16,384 slots, and the general [2048, 1, 32]), and for
``distance_matrix`` at the exact k-NN's [1024, 2^20] fp32 (phase 9), one
JSON line a shape with ``ms``, ``device_ms``, ``host_us`` and ``alone_ms``
as ``tools/hop_bench.py`` defines them (``device_ms``: the calls queued
behind a sleep of the card, the kernels back to back), and the card's SM
clock and power draw while they ran (``sm_mhz_min``/``max``,
``power_w_max``: the exact k-NN's matrix runs the card into its power
limit, and its times move with the clock).

Inputs are seeded like the smoke's: normal rows, d = 128, int8 codes from
``quantize_rows``, 90% of the slots unmasked.  It uses only the port's
public kernels (``block_distances``, ``distance_matrix``), so it runs
against any tree of the port: run it against two in one call, in the order
A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import STREAM_ADDS, card_name  # noqa: E402
from hop_bench import timings  # noqa: E402

from repro_torch.ann.quantize import quantize_rows  # noqa: E402
from repro_torch.kernels import block  # noqa: E402


class Clocks:
    """``nvidia-smi`` sampled every 100 ms while the block runs: the
    card's SM clock (MHz) and power draw (W), which fall and rise against
    its power limit under a long run of tensor-core tiles."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        self.samples = []
        for line in out.splitlines():
            try:
                mhz, watts = (float(v) for v in line.split(","))
            except ValueError:   # a cut last line, or "[N/A]"
                continue
            self.samples.append((mhz, watts))

    def summary(self) -> dict:
        """The extremes of the samples (None where the block ended before
        the first sample)."""
        if not self.samples:
            return dict(sm_mhz_min=None, sm_mhz_max=None, power_w_max=None)
        mhz = [m for m, _ in self.samples]
        return dict(sm_mhz_min=min(mhz), sm_mhz_max=max(mhz),
                    power_w_max=max(w for _, w in self.samples))


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
    d = 128

    def line(kernel, shape, fn):
        with Clocks() as clk:
            row = timings(fn)
        print(json.dumps(dict(tag=args.tag, kernel=kernel, shape=shape,
                              **row, **clk.summary())), flush=True)

    for name, S, Kq, C in (("scan B=32", 1, 32, STREAM_ADDS),
                           (f"scan B={args.queries}", 1, args.queries,
                            STREAM_ADDS),
                           ("general", 2048, 1, 32)):
        Q = torch.randn((S, Kq, d), generator=gen, device=dev)
        V = torch.randn((S * C, d), generator=gen, device=dev)
        codes, sc = quantize_rows(V)
        V, codes, sc = (V.reshape(S, C, d), codes.reshape(S, C, d),
                        sc.reshape(S, C))
        mask = torch.rand((S, C), generator=gen, device=dev) < 0.9
        line("block_distances", name,
             lambda: block.block_distances(Q, V, mask))
        line("block_distances_int8", name,
             lambda: block.block_distances(Q, codes, mask, sc))
        del Q, V, codes, sc, mask
    X = torch.randn((args.n, d), generator=gen, device=dev)
    Q = torch.randn((1024, d), generator=gen, device=dev)
    line("distance_matrix", f"exact k-NN [1024, {args.n}]",
         lambda: block.distance_matrix(Q, X))
    return 0


if __name__ == "__main__":
    sys.exit(main())
