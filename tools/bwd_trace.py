"""One call of each training backward kernel at its main path's shape,
under ``torch.profiler`` in a fresh process: every launch of the call
with its device ms, in launch order, then the call's total.

* ``embedding_bag_bwd``: Wide & Deep's first bag field at ``train_batch``
  (``chip_smoke.py`` phase 18 (b)): a [10^7, 32] float32 table, the ids of
  ``CTRStream(seed=0)``'s first batch (B = 65,536 x 10), mean, dout from
  a seeded normal.
* ``packed_spmm_bwd``: a GraphSAGE layer at ``minibatch_lg`` (phase 18
  (a)): the sampled subgraph's neighbour matrix ``fanout_neighbors(1024,
  (15, 10))`` (N = Nf = 169,984, M = 15), h [N, 128], W [128, 128] and
  dout [N, 128] from a seeded normal, mean; a call with no plan (it builds
  its own) and, where the module has ``SpmmPlan``, a call on a plan built
  before the trace (the plan's share of a step is one build for both
  layers).

    PYTHONPATH=src python tools/bwd_trace.py [--device cpu]

Each call runs once untraced first (the build, the caching allocator),
then once traced.  Prints one ``[breakdown]`` line a call and, last, one
JSON object with every launch.  Runs against any tree whose kernels have
these entry points (an older one unpacked under the gitignored
``parent/``: ``PYTHONPATH=parent/src``).
"""
import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402


def launches(prof) -> list:
    """[(kernel name, device ms)] of the trace's device events, in the
    order they ran."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    dev.sort(key=lambda e: float(e["ts"]))
    return [(short(e["name"]), float(e.get("dur", 0)) / 1e3) for e in dev]


def short(name: str) -> str:
    """A kernel's name without its namespace, arguments and most of its
    template arguments."""
    if "namespace)::" in name:
        name = name.split("namespace)::", 1)[1]
    name = name.split("(", 1)[0]
    return name if len(name) <= 60 else name[:57] + "..."


def traced_call(fn, sync) -> tuple:
    """Wall ms and launches of one call of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, launches(prof)


def line(label: str, wall: float, ls: list) -> str:
    total = sum(ms for _, ms in ls)
    return (f"[breakdown] {label}: {len(ls)} launches, device {total:.4f} ms"
            f", wall {wall:.3f} ms; " + "; ".join(
                f"{n} {ms:.4f}" for n, ms in ls))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import CTRStream
    from repro_torch.data.sampler import fanout_neighbors
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import segment_matmul as SM

    dev = torch.device(args.device or "cuda")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    out = {"device": torch.cuda.get_device_name(0) if cuda else str(dev),
           "card": CS.card_name() if cuda else None, "calls": {}}

    cfg = get_arch("wide-deep")
    field = cfg.multi_hot_fields[0]
    V, E = cfg.vocab_sizes[field], cfg.embed_dim
    batch = next(CTRStream(cfg, CS.FAMILY_BAG_BATCH, seed=0))
    ids = torch.from_numpy(batch["bags"][:, 0].copy()).to(dev)
    B, bag = ids.shape
    dout = torch.randn((B, E), generator=gen, device=dev)
    label = (f"embedding_bag_bwd [{V}, {E}] fp32, B={B} x {bag}, mean "
             "(CTRStream seed 0)")
    wall, ls = traced_call(lambda: EB.embedding_bag_bwd(ids, dout, V), sync)
    print(line(label, wall, ls), flush=True)
    out["calls"][label] = dict(wall_ms=wall, launches=ls)
    del dout
    if cuda:
        torch.cuda.empty_cache()

    nbrs = torch.from_numpy(fanout_neighbors(CS.GNN_BATCH_NODES,
                                             CS.GNN_FANOUTS)).to(dev)
    N, M = nbrs.shape
    d = f = CS.GNN_HIDDEN
    h = torch.randn((N, d), generator=gen, device=dev)
    w = torch.randn((d, f), generator=gen, device=dev) / d ** 0.5
    dout = torch.randn((N, f), generator=gen, device=dev)
    shape = f"N=Nf={N} M={M} [{N}, {d}] @ [{d}, {f}] mean"
    calls = {f"packed_spmm_bwd {shape}, its own plan":
             lambda: SM.packed_spmm_bwd(nbrs, h, w, dout, combine="mean")}
    if hasattr(SM, "SpmmPlan"):
        plan = SM.SpmmPlan(nbrs, N)
        plan.build()
        calls[f"packed_spmm_bwd {shape}, a plan built before"] = (
            lambda: SM.packed_spmm_bwd(nbrs, h, w, dout, combine="mean",
                                       plan=plan))
        calls[f"SpmmPlan.build {shape}"] = (
            lambda: SM.SpmmPlan(nbrs, N).build())
    for label, fn in calls.items():
        wall, ls = traced_call(fn, sync)
        print(line(label, wall, ls), flush=True)
        out["calls"][label] = dict(wall_ms=wall, launches=ls)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
