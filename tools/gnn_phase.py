"""Phase 16 of ``chip_smoke.py`` (the graph family) alone on one card:
build the kernels, then run ``chip_smoke.gnn_phase``.  Its ``[gnn]``
lines are the smoke's; the results go to ``chiprun_out/gnn_phase.json``.

    PYTHONPATH=src python tools/gnn_phase.py

In a fresh process the profiler's trace holds every kernel of the
traced forward, which the full smoke's late traces can lose.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gnn_phase: no CUDA device", file=sys.stderr)
        return 2
    CS.log(CS.card_name())
    t0 = time.perf_counter()
    _build.build_all()
    _build.library("segment_matmul")
    CS.log(f"[build] {time.perf_counter() - t0:.1f} s")
    out, launches, rows = CS.gnn_phase(CS.card())
    for r in rows:
        CS.log_kernel("packed_spmm", r)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "gnn_phase.json"), "w") as f:
        json.dump(dict(results=out, launches=launches, spmm=rows), f,
                  indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
