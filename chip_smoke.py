#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: n = 2**20, d = 128

Phases, each printing its own lines:

1. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (distances within 1e-5 * (qn + vn),
   rank merge and visited filter exactly), with the kernel's, the plain
   version's and a library call's times and the bound;
3. the main path: ``make_clustered`` at SIFT1M scale, ``Index.build`` with
   the default config (per-stage seconds);
4. ``Index.search`` at B = 10 (small regime) and B = 10240 (large regime),
   with ``visited_filter="none"`` and then ``"hash"`` on the same graph:
   latency, QPS and recall@10 against the on-card brute force; every
   kernel's launch counter must have moved during phases 3-4;
5. parity: the same graph and queries with ``kernel_backend="torch"`` —
   recall within 0.01 and ids equal on >= 98% of entries;
6. a ``torch.profiler`` trace of one build and of each search: the
   device's busy share of the wall time and the costliest device ops;
   and the k-NN recall of ``nn_descent`` on 2000 sampled nodes.

The line before the last is the JSON list of kernels; the last line is the
``ok`` JSON.  Any failure raises; without a CUDA device, or without the
``src/repro_torch`` package beside this file, it exits non-zero and prints
no result.  The run also writes ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
ROUTE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def chunked(fn, S: int, rows: int):
    """Run ``fn(lo, hi)`` over row chunks and concatenate each output."""
    import torch

    outs = [fn(lo, min(S, lo + rows)) for lo in range(0, S, rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(p) for p in zip(*outs))
    return torch.cat(outs)


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------

def card():
    import torch

    return torch.device("cuda", 0)


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check_gather(X, xn, name, S, Kq, C, self_q, gen):
    import torch

    from repro_torch.kernels import l2dist

    dev = X.device
    N, d = X.shape
    idx = torch.randint(0, N, (S, C), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[torch.rand((S, C), generator=gen, device=dev) < 0.05] = N
    mask = torch.rand((S, C), generator=gen, device=dev) < 0.9
    Q = None if self_q else torch.randn((S, Kq, d), generator=gen,
                                        device=dev)
    rows = max(1, (1 << 31) // (C * d * 4))

    def kern():
        return l2dist.gather_distances(Q, X, idx, mask, self_q=self_q)

    def plain(lo=0, hi=S):
        return l2dist.gather_distances_plain(
            None if self_q else Q[lo:hi], X, idx[lo:hi], mask[lo:hi],
            self_q=self_q)

    def library(lo=0, hi=S):
        V = X[idx[lo:hi].long().clamp(0, N - 1)]
        Q3 = V if self_q else Q[lo:hi]
        return torch.bmm(Q3, V.transpose(1, 2))

    out = kern()
    ref = chunked(plain, S, rows)
    torch.cuda.synchronize()
    valid = (idx < N) & mask
    vn = xn[idx.long().clamp(0, N - 1)]                             # [S, C]
    qn = vn if self_q else (Q.double() ** 2).sum(2)                 # [S, Kq]
    tol = 1e-5 * (qn[:, :, None] + vn[:, None, :])
    err = (out.double() - ref.double()).abs()
    err = torch.where(valid[:, None, :], err, torch.zeros_like(err))
    bad = int((err > tol).sum())
    masked_ok = bool((out[~valid[:, None, :].expand_as(out)] == 3.4e38).all())
    if bad or not masked_ok or not torch.isfinite(out[valid[:, None, :]
                                                      .expand_as(out)]).all():
        raise AssertionError(f"gather_distances {name}: {bad} entries over "
                             f"1e-5*(qn+vn), masked lanes INF={masked_ok}")
    it = 3 if S * C > 1 << 24 else 20
    ms = cuda_ms(kern, it)
    plain_ms = cuda_ms(lambda: chunked(plain, S, rows), max(1, it // 3))
    lib_ms = cuda_ms(lambda: chunked(library, S, rows), max(1, it // 3))
    n_valid = int(valid.sum())
    kq = C if self_q else Kq
    gathered = (S * C if self_q else n_valid) * d * 4
    nbytes = gathered + (0 if self_q else S * Kq * d * 4) + S * C * 5 \
        + S * kq * C * 4
    flops = 2 * S * kq * C * d + 2 * S * C * d + (0 if self_q else
                                                  2 * S * Kq * d)
    b_ms, b_by = bound(nbytes, flops)
    return dict(shape=name, S=S, Kq=kq, C=C, d=d, max_abs_err=float(
        err.max()), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by)


def check_rank_merge(name, R, W, keep, dev, gen):
    import torch

    from repro_torch.kernels import topk

    d = torch.randint(0, 64, (R, W), generator=gen, device=dev).float() * 0.5
    d[torch.rand((R, W), generator=gen, device=dev) < 0.05] = -0.0
    d[torch.rand((R, W), generator=gen, device=dev) < 0.05] = 3.4e38
    ids = torch.randint(0, 1 << 20, (R, W), generator=gen, device=dev,
                        dtype=torch.int32)
    mask = torch.rand((R, W), generator=gen, device=dev) < 0.9
    rows = max(1, (1 << 27) // W)

    def kern():
        return topk.rank_merge(d, ids, mask, keep=keep)

    def plain(lo=0, hi=R):
        return topk.rank_merge_plain(d[lo:hi], ids[lo:hi], mask[lo:hi],
                                     keep=keep)

    od, oi = kern()
    rd, ri = chunked(plain, R, rows)
    torch.cuda.synchronize()
    # exact: same ids, same values (lanes that tie on (dist, id) while one
    # holds -0.0 and the other +0.0 may trade places: one key, two zeros)
    if not (bool((od == rd).all()) and torch.equal(oi, ri)):
        raise AssertionError(f"rank_merge {name}: kernel != plain")
    it = 3 if R * W > 1 << 24 else 20
    ms = cuda_ms(kern, it)
    plain_ms = cuda_ms(lambda: chunked(plain, R, rows), max(1, it // 3))
    lib_ms = cuda_ms(lambda: torch.sort(d, dim=1, stable=True),
                     max(1, it // 3))
    Wp = 1 << max(W - 1, 0).bit_length()
    L = Wp.bit_length() - 1
    b_ms, b_by = bound(R * W * 9 + R * keep * 8, R * (Wp // 2) * L * (L + 1)
                       // 2)
    return dict(shape=name, R=R, W=W, keep=keep, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def check_visited(name, B, bound_ins, M, dev, gen):
    import torch

    from repro_torch.core import hotpath as HP
    from repro_torch.kernels import visited

    table = HP.visited_table(B, bound_ins, device=dev)
    W = table.shape[1]

    def lanes():
        ids = torch.randint(0, 1 << 20, (B, M), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[:, M // 2:] = ids[:, :M - M // 2]      # repeats within a call
        return ids, torch.rand((B, M), generator=gen, device=dev) < 0.8

    for _ in range(3):  # partly filled tables, so lanes also hit
        visited.visited_filter_plain(table, *lanes())
    ids, valid = lanes()
    tk, fk = visited.visited_filter(table.clone(), ids, valid)
    tp, fp = visited.visited_filter_plain(table.clone(), ids, valid)
    torch.cuda.synchronize()
    if not (torch.equal(tk, tp) and torch.equal(fk, fp)):
        raise AssertionError(f"visited_filter {name}: kernel != plain")
    work = table.clone()
    ms = cuda_ms(lambda: visited.visited_filter(work, ids, valid), 20)
    plain_ms = cuda_ms(lambda: visited.visited_filter_plain(work, ids, valid),
                       3)
    n_valid, n_fresh = int(valid.sum()), int(fp.sum())
    b_ms, b_by = bound(B * M * 6 + n_valid * W * 4 + n_fresh * 4,
                       n_valid * W)
    return dict(shape=name, B=B, W=W, S=table.shape[2], M=M, max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


# --------------------------------------------------------------------------
# phase 6: where the device time goes, and the k-NN graph's quality
# --------------------------------------------------------------------------

def device_time(prof, n_top: int = 6):
    """(busy microseconds, [(name, ms)] of the costliest device ops) from
    the profiler's trace: kernels, copies and memsets, one stream."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    per: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            per[e["name"]] = per.get(e["name"], 0.0) + float(e.get("dur", 0))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:n_top]
    return sum(per.values()), [(k, v / 1e3) for k, v in top]


def profile_run(ds, index, cfg, n_queries, dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ann import Index, build_graph
    from repro_torch.core import metrics as M
    from repro_torch.core.knn_build import nn_descent

    out: dict = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build_graph(ds.X, cfg, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, top = device_time(prof)
    out["build"] = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                        busy_share=busy / wall_us, top_ms=top)
    log(f"[profile] build: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.1%}); top "
        + "; ".join(f"{k[:48]} {t:.2f} ms" for k, t in top))
    for visited in ("none", "hash"):
        idx_v = Index(ds.X, dataclasses.replace(cfg, visited_filter=visited),
                      graph=index.graph, device=dev)
        for B in (10, n_queries):
            idx_v.search(ds.Q[:B])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                idx_v.search(ds.Q[:B])
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy, top = device_time(prof)
            key = f"{visited}_B{B}"
            out[key] = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                            busy_share=busy / wall_us, top_ms=top)
            log(f"[profile] visited={visited} B={B}: wall "
                f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
                f"({busy / wall_us:.1%}); top "
                + "; ".join(f"{k[:48]} {t:.2f} ms" for k, t in top))
    X = torch.as_tensor(ds.X, device=dev)
    n, k = X.shape[0], cfg.k_graph
    knn, _ = nn_descent(X, k)
    rows = torch.randperm(n, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(1))[:2000]
    dist = M.pairwise(X[rows], X, cfg.metric)
    dist[torch.arange(len(rows), device=dev), rows] = float("inf")
    exact = torch.topk(dist, k, dim=1, largest=False).indices
    hits = (knn[rows].long()[:, :, None] == exact[:, None, :]).any(2)
    out["knn_recall_sample"] = float(hits.float().mean())
    log(f"[profile] nn_descent k={k} recall on 2000 sampled nodes: "
        f"{out['knn_recall_sample']:.4f}")
    return out


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=10240)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.ann import Index
    from repro_torch.configs.base import ANNConfig
    from repro_torch.data.synthetic import make_clustered, recall_at_k
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = card()
    record: dict = {}

    # ---- phase 1: card + build ------------------------------------------
    name_limit = card_name()
    log(name_limit)
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    record["kernel_build_s"] = time.perf_counter() - t0
    log(f"[build] {len(_build.SOURCES)} CUDA sources (sm_90a, nvcc in "
        f"parallel): {record['kernel_build_s']:.3f} s")

    # ---- phase 2: kernels vs plain versions at the main path's shapes ----
    n, d = args.n, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    Xr = torch.randn((n, d), generator=gen, device=dev)
    xn = (Xr.double() ** 2).sum(1)
    cfg = ANNConfig()
    small_S = 32 * cfg.small_t0          # B = 10 pads to bucket 32
    shapes = {"gather_distances": [], "rank_merge": [], "visited_filter": []}
    for args_g in (("hop small", small_S, 1, cfg.max_degree, False),
                   ("hop large", args.queries, 1, cfg.max_degree, False),
                   ("nn_descent init", n, 1, cfg.k_graph, False),
                   ("nn_descent cand", n, 1,
                    cfg.k_graph + cfg.k_graph * 8, False),
                   ("relaxed_gd self-q", 2048, None, cfg.k_graph, True),
                   ("soft_gd self-q", 2048, None, 2 * cfg.k_graph, True)):
        shapes["gather_distances"].append(check_gather(Xr, xn, *args_g,
                                                       gen=gen))
    B_l = args.queries
    for args_r in (("small R_temp", small_S, cfg.hop_width, 32),
                   ("small final t0 merge", 32, cfg.small_t0 * 32, 10),
                   ("large seeds", B_l, cfg.large_n_seeds, cfg.large_n_seeds),
                   ("large R merge", B_l, cfg.large_ef + cfg.max_degree,
                    cfg.large_ef),
                   ("large C seeds", B_l * cfg.queue_segments,
                    cfg.segment_size + cfg.large_n_seeds, cfg.segment_size),
                   ("large C merge", B_l * cfg.queue_segments,
                    cfg.segment_size + cfg.max_degree, cfg.segment_size),
                   ("nn_descent merge", n, cfg.k_graph * 10, cfg.k_graph)):
        shapes["rank_merge"].append(check_rank_merge(*args_r, dev=dev,
                                                     gen=gen))
    for args_v in (("small", small_S, cfg.small_hops * cfg.max_degree + 1,
                    cfg.max_degree),
                   ("large", B_l, cfg.large_n_seeds
                    + cfg.large_hops * cfg.max_degree, cfg.max_degree)):
        shapes["visited_filter"].append(check_visited(*args_v, dev=dev,
                                                      gen=gen))
    for kname, rows in shapes.items():
        for r in rows:
            log(f"[kernel] {kname} {r['shape']}: ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} library_ms="
                f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"max_abs_err={r['max_abs_err']:.3g} ok")
    log("[kernels] " + ", ".join(
        f"{k} ({len(v)} shapes)" for k, v in shapes.items())
        + f": route {ROUTE}, each matches its plain version")
    del Xr, xn
    torch.cuda.empty_cache()

    # ---- phase 3: the main path — build -----------------------------------
    t0 = time.perf_counter()
    ds = make_clustered(n=n, d=d, n_queries=args.queries, k_gt=10, seed=0,
                        device=dev)
    record["data_s"] = time.perf_counter() - t0
    log(f"[data] make_clustered n={n} d={d} queries={args.queries} "
        f"(ground truth on the card): {record['data_s']:.2f} s")
    K.reset_launch_counts()
    steps: dict = {}

    def counted(label, fn):
        before = K.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = K.launch_counts()
        steps[label] = {k: after[k] - before[k] for k in after}
        return out

    t0 = time.perf_counter()
    index = counted("build", lambda: Index.build(ds.X, cfg, device=dev))
    record["build_s"] = time.perf_counter() - t0
    record["build_stage_s"] = dict(index.build_seconds)
    log(f"[build] Index.build n={n}: {record['build_s']:.2f} s; stages "
        + " ".join(f"{k}={v:.2f}s" for k, v in index.build_seconds.items())
        + f"; avg degree {index.graph.avg_degree():.2f}")

    # ---- phase 4: searches in both regimes, both visited modes ------------
    graph = index.graph
    results: dict = {}
    for visited in ("none", "hash"):
        idx_v = index if visited == "none" else Index(
            ds.X, dataclasses.replace(cfg, visited_filter=visited),
            graph=graph, device=dev)
        for B in (10, args.queries):
            Q = ds.Q[:B]
            regime = idx_v.regime(B)
            counted(f"warm {visited} B={B}", lambda: idx_v.search(Q))
            t0 = time.perf_counter()
            ids, dists = counted(f"search {visited} B={B}",
                                 lambda: idx_v.search(Q))
            dt = time.perf_counter() - t0
            if ids.shape != (B, 10) or not np.isfinite(dists).all() \
                    or not ((ids >= 0) & (ids < n)).all():
                raise AssertionError(f"bad search output ({visited}, B={B})")
            if any(len(set(r)) != len(r) for r in ids.tolist()):
                raise AssertionError(f"duplicate ids ({visited}, B={B})")
            rec = recall_at_k(ids, ds.gt[:B], 10)
            results[(visited, B)] = (ids, rec)
            record[f"search_{visited}_{B}"] = dict(
                regime=regime, latency_ms=dt * 1e3, qps=B / dt,
                recall_at_10=rec)
            log(f"[search] visited={visited} B={B} regime={regime}: "
                f"latency={dt * 1e3:.2f} ms qps={B / dt:.1f} "
                f"recall@10={rec:.4f}")
    launches = {k: sum(s[k] for s in steps.values())
                for k in K.launch_counts()}
    log("[launches] main path " + json.dumps(launches) + " by step "
        + json.dumps(steps))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # ---- phase 5: parity with the plain PyTorch path on the card ----------
    for visited in ("none", "hash"):
        ref = Index(ds.X, dataclasses.replace(
            cfg, visited_filter=visited, kernel_backend="torch"),
            graph=graph, device=dev)
        for B in (10, args.queries):
            ids_t, _ = ref.search(ds.Q[:B])
            ids_k, rec_k = results[(visited, B)]
            rec_t = recall_at_k(ids_t, ds.gt[:B], 10)
            agree = float((ids_t == ids_k).mean())
            record[f"parity_{visited}_{B}"] = dict(
                recall_cuda=rec_k, recall_torch=rec_t, id_agreement=agree)
            log(f"[parity] visited={visited} B={B}: recall cuda={rec_k:.4f} "
                f"torch={rec_t:.4f} ids equal {agree:.4%}")
            if abs(rec_k - rec_t) > 0.01 or agree < 0.98:
                raise AssertionError("kernel path and plain path disagree")

    # ---- phase 6: where the device time goes ------------------------------
    record["profile"] = profile_run(ds, index, cfg, args.queries, dev)

    # ---- summary -----------------------------------------------------------
    meta = {
        "gather_distances": ("src/repro_torch/kernels/csrc/l2dist.cu",
                             "src/repro/kernels/l2dist.py:401",
                             "nn_descent cand"),
        "rank_merge": ("src/repro_torch/kernels/csrc/topk.cu",
                       "src/repro/kernels/topk.py:103", "nn_descent merge"),
        "visited_filter": ("src/repro_torch/kernels/csrc/visited.cu",
                           "src/repro/kernels/visited.py:102", "large"),
    }
    kernels = []
    for kname, (source, replaces, main_shape) in meta.items():
        main = next(r for r in shapes[kname] if r["shape"] == main_shape)
        kernels.append(dict(
            name=kname, route=ROUTE, source=source, replaces=replaces,
            launches=launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in shapes[kname]),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main_shape,
            shapes=shapes[kname]))
    record.update(card=name_limit, n=n, d=d, kernels=kernels,
                  launches_by_step=steps,
                  total_s=time.perf_counter() - t_start)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"[total] {record['total_s']:.1f} s")
    log(json.dumps({"kernels": [{k: v for k, v in kern.items()
                                 if k != "shapes"} for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
