#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: n = 2**20, d = 128

Phases, each printing its own lines:

1. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print the build time, the registers and spills of the
   top-k, attention, self-query, int8 row, visited-filter,
   distance-matrix and embedding-bag bodies, and the HMMA count of each
   tensor-core body
   (``cuobjdump -sass``; one without HMMA fails the run);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (distances within 1e-5 * (qn + vn),
   rank merge and visited filter exactly, the filter also on a 16-bucket
   table where lanes collide and drop), with the kernel's (for the
   gather and the filter also with the calls queued ahead), the plain
   version's and a library call's times and the bound (for the
   tensor-core tiles also at the tensor-core rate and for the products
   they issue); then relaxed GD's keep mask and soft GD's occlusion
   factors of one 2,048-node tile through the self-query kernel and
   through the plain version, equal on >= 99% of entries;
3. the main path: ``make_clustered`` at SIFT1M scale, ``Index.build`` with
   the default config (per-stage seconds);
4. ``Index.search`` at B = 10 (small regime) and B = 10240 (large regime),
   with ``visited_filter="none"`` and then ``"hash"`` on the same graph:
   latency, QPS and recall@10 against the on-card brute force; every
   kernel's launch counter must have moved during phases 3-4;
5. parity: the same graph and queries with ``kernel_backend="torch"`` —
   recall within 0.01 and ids equal on >= 98% of entries;
7. int8 residency: ``quantization="int8"`` on phase 3's graph, B = 10 and
   10240 in both visited modes, recall@10 beside phase 4's fp32 recall and
   parity with the plain path as in phase 5;
8. streaming on the fp32 index: 16,384 adds (``make_clustered``'s centres,
   fresh noise), 1% of the base and 1,024 of the added ids deleted; B = 10
   and 10240 searched and held to an on-card brute force over the
   effective corpus and to the plain path; 1,024 added rows must find
   themselves at rank 1; one B = 10240 search of an int8 index with the
   same mutations, and one more after a 16,385th add doubles its delta to
   32,768 slots (its pre-selection, 40 of 32,768, takes the top-k's
   selection at twice the width); then ``compact()`` and a search of the
   new generation;
6. a ``torch.profiler`` trace of one build, of each search and of the
   int8 large search in both visited modes: the device's busy share of
   the wall time, the device time of the top-k and of the search hop's
   kernels and the costliest device ops;
   and the k-NN recall of ``nn_descent`` on 2000 sampled nodes;
9. the kernel API (``repro_torch.kernels.ops``): each of its five kernels
   against its plain version at full size (distances within
   1e-5 * (qn + xn), sorts exactly, embedding bags within 1e-6 * the
   bag's sum of |rows|, SpMM within 1e-5 * (|agg| @ |W|), attention
   within 1e-5 * (P @ |V|) of the float32 oracle plus one bf16 rounding)
   with its times and bound (the bags on both routes of
   ``embedding_bag.path``, the vector route bit for bit against the lane
   route, each route's device time and achieved GB/s); then, with every
   counter at 0, the API's
   path: the exact k-NN of phase 3's first 1,024 queries against the
   whole corpus through ``ops.distance_matrix`` + ``ops.bitonic_topk``
   (recall@10 >= 0.999 against the ground truth), wide_deep's bag field
   (10,000,000 x 32, bag 10, B = 512 and 65,536) through
   ``ops.embedding_bag``, GraphSAGE's first layer on Reddit over the
   whole graph and minibatch_lg's first layer (16,384 targets, 10
   neighbours) through ``ops.packed_spmm`` (its "transform" and "fused"
   routes, each also forced at both shapes) and one OLMo-1B attention
   layer (4,096 tokens,
   16 heads of 128, bf16, the "tile" body) and one decode step over
   32,768 keys (the "split" body) through ``ops.flash_attention``.
   Attention also reports SDPA's own err/tol on the same inputs, both
   bodies at 1-64 query rows a KV head (``[threshold]`` lines).  The bf16
   bodies: wide_deep's bags of a bf16 table and GraphSAGE's layer on bf16
   features (both routes), each against its plain version on the widened
   inputs within the float32 contract plus one rounding of the output
   (2^-8 * |out|), with its times and its bound at bf16's bytes, then
   once each on the counted path (1 and 2 launches);
10. serving, on phase 3's graph: for fp32 and int8, both visited modes,
   B = 10 and 10240, and the stream search with phase 8's live delta, the
   engine's replayed CUDA graph against an eager call of the same search
   on the card (bit for bit), the median untraced latency of 10 eager
   calls and of 10 replays, the busy share of one traced replay, and the
   bytes of the engine's graph pool; a same-shape compaction that must
   capture nothing (its first replays equal an eager search of the new
   generation) and a shape-changing one that must recapture;
   ``Index.warmup`` and ``Index.serve()`` answering 256 single submits
   from 8 threads (dispatches, coalescing, recall@10 against the same rows
   as one batch); ``regime_calibration="probe"``'s fitted split, and B =
   10 with phase 8's live delta in both regimes.
11. the locality-packed layout, on phase 3's graph: the port's
   ``locality_order`` and ``apply_layout`` (seconds, ``span_stats`` of
   both orders), the large hop's ``gather_distances`` and
   ``gather_distances_int8`` on the same neighbour rows in either order
   (device ms, each distance the same bits); then, with every counter at
   0, the packed index served for fp32 and int8, both visited modes, B =
   10 and 10240 (replay against eager as in phase 10, and ids and dists
   bit for bit against phase 10's unpacked replays, or >= 99.9% of ids
   equal and a finding), a stream (phase 8's mutations: no deleted id
   returned, bit for bit against phase 10's unpacked stream replays, every
   live added row at rank 1), a same-shape packed ``compact()`` at 2**17
   rows (graphs kept, perm copied in, first replays equal an eager search
   of the new generation), and ``Index.save`` / ``Index.load`` of the
   packed int8 index with a live stream (seconds, bytes, the loaded
   index's replays bit for bit); every ANN kernel body must launch.
12. the sharded index, on phase 3's corpus, with every counter at 0:
   ``Index.build(..., mesh=make_mesh((4, 2), ("data", "model")))`` (the
   seconds of each stage of each shard); on its shards fp32 and int8, both
   visited modes, B = 10 and 10240: each replay equal to an eager call bit
   for bit, recall@10 beside phase 4's and 7's single index, the median
   of 10 replays, the graph pool's bytes, and the same shards on the
   plain path (recall within 0.01, ids equal on >= 98%); a (1, 2) grid
   over phase 3's own graph answering as phase 10's single-plane replays
   bit for bit; ``db_bf16=True`` (recall beside fp32); phase 8's
   mutations on the grid (no deleted id, every live added row at rank 1,
   recall against a brute force over the effective corpus), then
   ``compact()`` and a search of the new generation; ``Index.save`` /
   ``Index.load(mesh=)`` of the packed int8 grid index with a live stream
   (shard-major, seconds and bytes, replays bit for bit); the router:
   ``"sharded:4"`` against a (4, 1) grid bit for bit, ``"replicated:2"``
   against its donor, 256 single submits from 8 threads (no retry, no
   lost future).  Every ANN kernel body and ``gather_distances_bf16``
   must launch; the bf16 body is then held to its plain version at the
   large hop's [10240, 1, 32] and the seeds' [10240, 1, 128].
13. the pod (``serve/pod.py``) and the serving drivers, with every
   counter at 0: (a) a 1-rank NCCL pod over phase 3's graph, both visited
   modes, B = 10 and 10240, bit for bit against phase 10's single-plane
   replays (medians of 10 replays beside phase 10's); (b) two ranks on
   the one card over gloo (spawned), each building 2 of the 4 shards of
   2^18 rows, saving the pod artifact (rank 0 writes) and loading it
   back: fp32 / int8 x none / hash at B = 10 and 10240, each replay equal
   to its eager call, both ranks alike and bit for bit the (4, 1) grid
   over the same shards (the artifact loaded in this process), a stream
   round (no deleted id, bit for bit the grid's), the 2-rank reload bit
   for bit, seconds for build, save and load and medians of 10 replays;
   (c) ``python -m repro_torch.launch.serve --n 2**20 --d 128 --router
   replicated:2 --kill-replica 1`` (``lost_futures=0``, weighted recall
   within 0.01 of an index built in this process on the same corpus and
   batches) and the six ``examples/torch/`` scripts at their CI sizes,
   all subprocesses started together, each exiting 0 with its OK line.
   Every ANN kernel body must launch in (a) and the ranks.
14. the language models' serving path (``models/transformer.py``), with
   the ANN state released and every counter at 0: four drills one after
   another, each freed before the next, weights from ``init_params`` with
   a seeded generator on the card, tokens from ``LMStream(seed=0)``: (a)
   ``olmo_1b`` at full size, B = 4, a 2,048-token prompt and 32 decode
   steps; (b) ``gemma3_27b`` at full width cut to 18 layers (three 5:1
   periods; the card's memory cuts it), B = 2, prompt 2,048, 16 steps;
   (c) ``starcoder2_7b`` at full size, B = 1, prompt 4,608 (past its
   4,096 window), 8 steps; (d) ``olmoe_1b_7b`` at full size, B = 4,
   prompt 512, 8 steps.
   Each first holds ``flash_attention`` to its plain version at the
   drill's own shapes (a prefill layer and a decode step at q_offset P
   over the P + steps cache, every window of the drill, on unit-normal
   q/k/v and on a layer's own) within the attention contract; this is
   the gate a wrong kernel fails.  Then ``prefill`` and teacher-forced
   ``decode_step``s on the hand
   kernel (``flash_attention`` one tile launch a layer in the prefill,
   split + combine a layer a step, by the counter), on the plain path
   (``kernel_backend="torch"``) in bf16 and in float32 (TF32 off), the
   reference: ``err_kernel <= 2 * err_plain`` over the prefill's last
   logits and every step's; the same gate shown two planted faults (a
   dropped scale, a dropped window; reported, not gated); the greedy
   tokens' agreement (not gated); prefill and decode medians (CUDA
   events) beside their bounds, flash_attention's device time in a
   traced prefill and step, and the peak device memory (``[lm]`` lines);
   at (a)'s shapes flash_attention's prefill layer and decode step are
   timed beside SDPA on the same inputs.
15. Wide & Deep's serving path (``models/recsys.py``), with the LM state
   released and every counter at 0: ``wide_deep`` at full size (49.36 M
   rows of 32 in fp32, weights from ``init_params`` with a seeded
   generator on the card), batches from ``CTRStream(seed=0)``.  Each bag
   field's ``embedding_bag`` at the drill's own ids against its plain
   version (the bag contract; bit equality reported; at the bulk batch
   both routes timed beside ``F.embedding_bag``); ``serve_step`` at
   ``RECSYS_SHAPES``' B = 512 and 262,144 on the kernel path (4 launches
   a step, by the counter) and on ``kernel_backend="torch"`` with the
   same weights, within 1e-6 on the probabilities; medians of 20 steps
   (CUDA events), ``embedding_bag``'s share of a traced step's device
   time, the step's bound and the peak memory; ``retrieval_step`` over
   10^6 item vectors (the top-100 equal to the plain path's) and its
   median (``[recsys]`` lines).
16. the graph family (``models/gnn.py``, ``models/mace.py``), with the
   recsys state released and every counter at 0, weights from
   ``init_params`` with a seeded generator on the card and every
   zero-init leaf drawn too: (a) ``graphsage_reddit`` at ``minibatch_lg``'s
   full size: the host graph ``make_community_graph`` (232,965 nodes,
   114,615,892 edges, d_feat 602, 41 classes), ``SampledStream`` (1,024
   seeds, fanout (15, 10), seed 0) drawing 3 batches of N = 169,984 with
   their [N, 15] neighbour matrix; each forward on the kernel path
   (``packed_spmm`` twice, once a layer, by the counter; its repeat bit
   for bit) and on ``kernel_backend="torch"`` (within 1e-5 of the largest
   |logit|); batch 0 also against the float64 run of the edge list on the
   CPU (``err_card <= 2 * err_cpu32 + 4e-6 * scale``), which a planted
   ``combine="sum"`` must fail; ``packed_spmm`` alone at the path's two
   call shapes against its plain version (the SpMM contract); the
   sampling ms, the copy to the card, the median of 20 forwards (CUDA
   events), a traced forward's device time and ``packed_spmm``'s share,
   the bound and the peak memory; (b) ``gin_tu`` and ``gatedgcn`` at
   ``molecule`` and the three GNNs at ``full_graph_sm`` (the edge list),
   each against the float64 run; (c) ``mace`` at ``molecule``: the
   float64 gate, a proper rotation and a translation on the card within
   1e-5 of the largest |energy|, the median forward and the peak memory
   (``[gnn]`` lines).
17. LM training (``models/transformer.py`` ``loss_fn``, ``optim/``,
   ``train/``), with phase 16's state released: (a) the hand-written
   backward of attention (``flash_attention_bwd``) alone on unit-normal
   inputs at OLMo-1B's layer [4, 2048, 16 x 128] causal (bf16 and
   float32), gemma3-27b's local layer (32 q heads over 16, window 1,024)
   and starcoder2-7b's G = 9, against the float64 autograd of
   ``attention_ref``: each of dq, dk, dv within twice the float32 plain
   version's largest error plus 2^-8 * |g| for a bf16 output; a planted
   fault (dq without its scale) must fail that; how it splits P and dS;
   its ms (beside the earlier FFMA design's), bound, plain ms and SDPA's
   backward; (b) ``olmo_1b`` at full width (16 layers, B = 4 x
   2,048, bf16, remat, AdamW as the launcher sets it): the gradient
   tree's and each token's loss's global relative error against the
   float32 plain run within twice the bf16 plain path's (its launches
   counted apart); 12 steps through ``Trainer.run`` (the mean loss of the
   last 3 below the first), the median step by CUDA events, tokens/s, the
   bound and the peak memory, with every counter at 0 just before them
   and read just after (flash_attention and flash_attention_bwd 2L
   launches a step each); a traced step in a fresh process (``tools/train_trace.py``):
   the busy share and the two attention kernels' shares; (c) a
   checkpoint round trip at full width cut to 2 layers (6 steps, save,
   restore, 6 steps == 12 steps bit for bit), the launcher on
   ``kimi-k2-1t-a32b --reduced`` and ``examples/torch/train_lm.py`` as
   subprocesses (``[train]`` lines).
18. training of the graph, MACE and Wide & Deep families, with phase
   17's state released: (a) ``graphsage_reddit`` at ``minibatch_lg`` and
   (b) ``wide_deep`` at B = 65,536 on the hand-written backward kernels
   of ``packed_spmm`` and ``embedding_bag``, each with its gradient gate,
   a planted fault, the kernel alone at its path's shape against its
   plain version, 12 steps and a traced step; one call of each backward
   at its path's shape traced in a fresh process, launch by launch
   (``tools/bwd_trace.py``); (c) GIN, GatedGCN and MACE (forces); (d) the
   launcher's resume (``[family]`` lines).

``Index.search`` replays the engine's CUDA graphs (the first call of a
shape captures: one eager run, then the capture), so phases 3-4, 7 and 8
search through replays.  Each of them starts with every launch counter at
0 and reads the counters at its end: an eager warm-up counts its
launches, a capture none, and a replay those its capture recorded.  Each
of the six ANN kernel bodies must have launched in them, and again in
phase 11's packed path, phase 12's sharded one (with the bf16 body) and
phase 13's pod.  Phase 9's path must launch each of its five, attention
and SpMM exactly as often as their routes launch kernels, phase 14's
flash_attention as its bodies launch, phase 15's embedding_bag once
a bag field a step, phase 16's packed_spmm once a GraphSAGE layer, and
phase 17's flash_attention twice a layer a training step (the forward and
remat's recomputation) and flash_attention_bwd twice a layer (its two
passes), and phase 18's packed_spmm once and packed_spmm_bwd 4 times a
GraphSAGE layer a step, plus one plan a batch that both layers share,
and embedding_bag and embedding_bag_bwd once a bag field a step.

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
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
# mma.sync's own ceiling on the H100 (tools/mma_sync_bench.cu, PERF.md §6):
# the rate the products of a 3xTF32 or bf16 mma.sync tile are issued at
MMA_SYNC_TF32_OPS_PER_S = 313e12
MMA_SYNC_BF16_OPS_PER_S = 625e12
DIVERSIFY_AGREEMENT = 0.99    # phase 2: keep / occlusion entries equal
ROUTE = "cuda"
STREAM_ADDS = 16384           # phase 8's added rows (delta capacity 16384)
STREAM_DELETED_ADDS = 1024    # ... of which deleted again
# the six kernel bodies of the ANN path (phases 3-4, 7 and 8)
ANN_BODIES = ("gather_distances", "gather_distances_int8", "rank_merge",
              "visited_filter", "block_distances", "block_distances_int8")
# phase 9, the kernel API, at shapes of the reference's own configurations
# (src/repro/configs/base.py and graphsage_reddit.py)
API_BODIES = ("distance_matrix", "bitonic_sort", "embedding_bag",
              "packed_spmm", "flash_attention")
KNN_QUERIES = 1024            # exact k-NN: phase 3's first 1,024 queries
MESH_SHAPE = (4, 2)           # phase 12's grid: DB shards x query columns
LAYOUT_PIPE = ("knn", "diversify", "bridges", "layout")
# phases 10-13: untraced calls a latency median (a grid's B = 10240
# replays take 0.4-0.8 s each, so the count is paid in the time limit)
SERVE_REPEATS = 10
# phase 12's replays a median: cut from 10 when phase 18 joined, the
# first cut PERF.md section 4 names
MESH_REPEATS = 3
TOPK_KERNELS = ("warp_topk_kernel", "select_kernel", "cta_sort_kernel")
# the search hop's kernels (csrc/l2dist.cu's row bodies, csrc/visited.cu)
HOP_KERNELS = ("gather_rowq_kernel", "gather_row8_kernel",
               "visited_filter_kernel")
BAG_ROWS, BAG_DIM, BAG_SIZE = 10_000_000, 32, 10   # wide_deep's bag fields
BAG_BATCHES = (512, 65536)    # RECSYS_SHAPES serve_p99, train_batch
GNN_NODES, GNN_FANOUT = 232_965, 15   # GNN_SHAPES minibatch_lg (Reddit)
GNN_FEAT, GNN_HIDDEN = 602, 128       # d_feat; graphsage_reddit d_hidden
GNN_SENTINEL_SHARE = 0.1      # neighbour lanes set to the sentinel Nf
# minibatch_lg's first layer: its 1,024 seeds and their 15,360 sampled
# neighbours, 10 neighbours each, over the whole table
GNN_MINIBATCH = (16_384, 10)
# attention at OLMo-1B's width (16 heads of 128, no GQA) and gemma3-27b's
# local layers (32 q heads over 16 KV heads of 128, window 1,024), at
# LM_SHAPES' 4,096-token training length and 32,768-token decode
LM_SEQ, LM_DECODE_KV, LM_DECODE_BATCH = 4096, 32768, 8
OLMO_HEADS, HEAD_DIM = 16, 128
GEMMA_HEADS, GEMMA_KV_HEADS, GEMMA_WINDOW = 32, 16, 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def log_kernel(kname: str, r: dict, extra: str = "") -> None:
    """One ``[kernel]`` line: a kernel at one shape against its plain
    version, with its times and bound (and, for the top-k, its path and
    ``torch.topk``'s time)."""
    lib = r["library_ms"]
    if r.get("path"):
        extra = f" path={r['path']}" + extra
    if r.get("torch_topk_ms") is not None:
        extra += f" (torch.topk {r['torch_topk_ms']:.4f} ms)"
    if r.get("device_ms") is not None:
        extra += (f"; device_ms={r['device_ms']:.4f} (the calls queued "
                  f"ahead: the kernel without its wrapper's host cost)")
    if r.get("probe_sector_bytes") is not None:
        extra += (f"; {r['fresh']} lanes fresh, {r['drops']} dropped"
                  f"; a probe reads {r['probe_sector_bytes']} B of sectors "
                  f"for {r['probe_bytes']} B of ways (the bytes bound "
                  f"counts {r['probe_bytes']}; the reference's [B, W, S] "
                  f"layout: {r['way_major_sector_bytes']} B)")
    if r.get("issued_bound_ms") is not None:
        rate = "bf16" if r.get("dtype") == "bfloat16" else "TF32"
        tol = r["err_over_tol"]    # packed_spmm's: one a route, in extra
        if not isinstance(tol, dict):
            extra += f" err/tol={tol:.3f};"
        extra += (f" bound at the {rate} "
                  f"tensor-core rate or bytes; at the fp32 rate "
                  f"{r['fp32_rate_bound_ms']:.4f} ms, the products issued "
                  f"at mma.sync's ceiling {r['issued_bound_ms']:.4f} ms")
    log(f"[kernel] {kname} {r['shape']}: ms={r['ms']:.4f} "
        f"plain_ms={r['plain_ms']:.4f} library_ms="
        f"{lib if lib is None else round(lib, 4)} "
        f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
        f"max_abs_err={r['max_abs_err']:.3g} ok{extra}")


def cuda_ms(fn, iters: int = 10, warmup: int = 1, repeats: int = 1,
            ahead: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls; with
    ``repeats``, the least of that many such means (a call shorter than
    its host cost times the host, whose hiccups this sets aside).  With
    ``ahead``, the card first sleeps (``torch.cuda._sleep``, ~1 ms a
    10 calls) while the host queues every call, so that a call shorter
    than its host cost times the device alone."""
    import torch

    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(200_000 * iters)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def bound(nbytes: float, ops: float, rate: float = FP32_OPS_PER_S) -> tuple:
    """The least ms for the bytes at 3.35 TB/s and the operations at
    ``rate``, and which of the two binds."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / rate * 1e3
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


def check_gather(X, xn, name, S, Kq, C, self_q, gen, quant=None,
                 bf16=False):
    """``quant`` = (codes, scales) checks the int8 body on X's codes;
    ``bf16`` the bf16 row body on ``X`` (bf16 rows; ``xn`` their norms)."""
    import torch

    from repro_torch.kernels import l2dist

    dev = X.device
    N, d = X.shape
    Xs, sc = (X, None) if quant is None else quant
    idx = torch.randint(0, N, (S, C), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[torch.rand((S, C), generator=gen, device=dev) < 0.05] = N
    mask = torch.rand((S, C), generator=gen, device=dev) < 0.9
    Q = None if self_q else torch.randn((S, Kq, d), generator=gen,
                                        device=dev)
    rows = max(1, (1 << 31) // (C * d * 4))

    def kern():
        return l2dist.gather_distances(Q, Xs, idx, mask, self_q=self_q,
                                       scales=sc)

    def plain(lo=0, hi=S):
        return l2dist.gather_distances_plain(
            None if self_q else Q[lo:hi], Xs, idx[lo:hi], mask[lo:hi],
            self_q=self_q, scales=sc)

    def library(lo=0, hi=S):
        ic = idx[lo:hi].long().clamp(0, N - 1)
        V = X[ic].float() if sc is None else \
            Xs[ic].float() * sc[ic][:, :, None]
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
    it, reps = (3, 1) if S * C > 1 << 24 else (20, 3)   # reps: see cuda_ms
    ms = cuda_ms(kern, it, repeats=reps)
    device_ms = cuda_ms(kern, it, repeats=reps, ahead=True)
    plain_ms = cuda_ms(lambda: chunked(plain, S, rows), max(1, it // 3))
    lib_ms = cuda_ms(lambda: chunked(library, S, rows), max(1, it // 3),
                     repeats=reps)
    n_valid = int(valid.sum())
    kq = C if self_q else Kq
    # self-query tiles read every row; the row kernel skips masked lanes
    lanes = S * C if self_q else n_valid
    # int8: codes + scale; bf16: 2 bytes an element
    row_bytes = d + 4 if sc is not None else d * (2 if bf16 else 4)
    nbytes = lanes * row_bytes + (0 if self_q else S * Kq * d * 4) \
        + S * C * 5 + S * kq * C * 4
    flops = 2 * lanes * kq * d + 2 * lanes * d + (0 if self_q else
                                                  2 * S * Kq * d)
    row = dict(shape=name, S=S, Kq=kq, C=C, d=d, max_abs_err=float(
        err.max()), err_over_tol=float((err / tol).max()), ms=ms,
        device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms)
    if self_q:   # the tile's products run on tensor cores in 3xTF32
        row.update(tensor_bounds(nbytes, flops, 2 * lanes * kq * d, False))
    else:
        row.update(zip(("bound_ms", "bound_by"), bound(nbytes, flops)))
    return row


def tensor_bounds(nbytes, flops, products, bf16) -> dict:
    """The bounds of a tensor-core distance tile: ``bound_ms``, all its
    operations at the tensor-core rate of its input (bf16 989, TF32 495
    TFLOP/s) or the bytes; as named extras, the same at the fp32 rate (the
    bound of the earlier FFMA design) and the products it issues (3x in
    3xTF32, 1x in bf16) at mma.sync's measured ceiling."""
    rate = BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S
    issued = (products, MMA_SYNC_BF16_OPS_PER_S) if bf16 else (
        3 * products, MMA_SYNC_TF32_OPS_PER_S)
    b_ms, b_by = bound(nbytes, flops, rate)
    return dict(bound_ms=b_ms, bound_by=b_by,
                fp32_rate_bound_ms=bound(nbytes, flops)[0],
                issued_bound_ms=bound(nbytes, *issued)[0])


def check_diversify(dev, cfg, gen, n: int = 1 << 20) -> dict:
    """Relaxed GD's keep mask and soft GD's occlusion factors of one
    2,048-node tile, computed with the self-query kernel and with the
    plain version (``backend="torch"``) from the same lists: the exact
    ``2 k_graph``-NN of the tile's nodes (self left out) in n x 128
    make_clustered-like rows (64 centres, noise 0.15), the last 8 lanes of
    each soft-GD list the sentinel n (appended lists end so), the first
    ``k_graph`` for relaxed GD.  Near ties may flip; returns the share of
    equal entries of each."""
    import torch

    from repro_torch.core import diversify
    from repro_torch.kernels import block

    d, T, K = 128, 2048, cfg.k_graph
    centres = torch.randn((64, d), generator=gen, device=dev)
    X = centres[torch.randint(0, 64, (n,), generator=gen, device=dev)] \
        + 0.15 * torch.randn((n, d), generator=gen, device=dev)
    lists = []
    for lo in range(0, T, 256):
        D = block.distance_matrix_plain(X[lo:lo + 256], X)
        D[torch.arange(256, device=dev), lo + torch.arange(256, device=dev)] \
            = float("inf")
        lists.append(torch.topk(D, 2 * K, dim=1, largest=False))
        del D
    dists = torch.cat([v for v, _ in lists])
    ids = torch.cat([i for _, i in lists]).int()
    soft_ids, soft_d = ids.clone(), dists.clone()
    soft_ids[:, -8:], soft_d[:, -8:] = n, 3.4e38
    out = {}
    for name, fn, args, kw in (
            ("relaxed_gd keep", diversify.relaxed_gd_tile,
             (ids[:, :K].contiguous(), dists[:, :K].contiguous()),
             dict(alpha=cfg.alpha)),
            ("soft_gd occlusion factors", diversify.occlusion_factors_tile,
             (soft_ids, soft_d), {})):
        kern = fn(X, *args, metric="l2", **kw)
        plain = fn(X, *args, metric="l2", backend="torch", **kw)
        out[name] = float((kern == plain).float().mean())
    return out


def check_block(name, S, Kq, C, d, quant, dev, gen):
    """The block on the tensor-core tile (fp32, or int8 codes with
    ``quant``) against its plain version at a scan or general shape."""
    import torch

    from repro_torch.ann.quantize import quantize_rows
    from repro_torch.kernels import block

    Q = torch.randn((S, Kq, d), generator=gen, device=dev)
    V = torch.randn((S * C, d), generator=gen, device=dev)
    sc = None
    if quant:
        V, sc = quantize_rows(V)
        sc = sc.reshape(S, C)
    V = V.reshape(S, C, d)
    mask = torch.rand((S, C), generator=gen, device=dev) < 0.9
    Vf = V.double() if sc is None else V.double() * sc.double()[:, :, None]

    def kern():
        return block.block_distances(Q, V, mask, sc)

    def plain():
        return block.block_distances_plain(Q, V, mask, sc)

    def gemm():
        Vd = V if sc is None else V.float() * sc[:, :, None]
        return torch.matmul(Q, Vd.transpose(1, 2))

    def library():  # torch.matmul, TF32 off, + the epilogue in PyTorch
        Vd = V if sc is None else V.float() * sc[:, :, None]
        dots = torch.matmul(Q, Vd.transpose(1, 2))
        qn = (Q * Q).sum(2)
        vn = (Vd * Vd).sum(2)
        return (qn[:, :, None] + vn[:, None, :] - 2.0 * dots).masked_fill_(
            ~mask[:, None, :], 3.4e38)

    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    tol = 1e-5 * ((Q.double() ** 2).sum(2)[:, :, None]
                  + (Vf ** 2).sum(2)[:, None, :])
    m3 = mask[:, None, :].expand_as(out)
    err = torch.where(m3, (out.double() - ref.double()).abs(),
                      torch.zeros_like(tol))
    bad = int((err > tol).sum())
    if bad or not torch.equal(out == 3.4e38, ~m3) \
            or not torch.isfinite(out[m3]).all():
        raise AssertionError(f"block_distances {name} (int8={quant}): "
                             f"{bad} entries over 1e-5*(qn+vn)")
    ratio = float((err / tol).max())
    del ref, tol
    it = 3 if S * Kq * C > 1 << 26 else 20
    ms = cuda_ms(kern, it)
    device_ms = cuda_ms(kern, 2 * it, repeats=3, ahead=True)
    plain_ms = cuda_ms(plain, max(1, it // 3))
    lib_ms = cuda_ms(library, max(1, it // 3))
    gemm_ms = cuda_ms(gemm, max(1, it // 3))
    itemsize = 1 if quant else 4
    nbytes = S * Kq * d * 4 + S * C * d * itemsize + S * C * (
        5 if quant else 1) + S * Kq * C * 4
    flops = 2 * S * Kq * C * d + 2 * S * (Kq + C) * d + (
        S * C * d if quant else 0)
    return dict(shape=name, S=S, Kq=Kq, C=C, d=d, max_abs_err=float(
        err.max()), err_over_tol=ratio, ms=ms, device_ms=device_ms,
        plain_ms=plain_ms, library_ms=lib_ms, library_gemm_only_ms=gemm_ms,
        **tensor_bounds(nbytes, flops, 2 * S * Kq * C * d, False))


def topk_ops(W: int, keep: int) -> float:
    """The least compares a row needs: one a lane to select a prefix,
    W log2 W to sort the whole row."""
    return W * max(1, W.bit_length() - 1) if keep == W else W


def topk_path(R: int, W: int, keep: int) -> str:
    """The path ``kernels/topk.py`` takes, with its launches."""
    from repro_torch.kernels import topk

    p = topk.path(W, keep)
    if p == "chunks":
        return "chunks"
    return p + "(" + "+".join(L.body for L in topk.plan(R, W, keep)) + ")"


def selection_ms(dists, ids, keep, it, mask=None):
    """``torch.topk`` as a yardstick of a top-k (tie order aside): the
    masked ``where``, the selection and the gather of ids."""
    import torch

    def run():
        d = dists if mask is None else torch.where(
            mask, dists, torch.full_like(dists, 3.4e38))
        v, j = torch.topk(d, keep, dim=1, largest=False)
        return v, ids.gather(1, j)

    return cuda_ms(run, it, repeats=3)


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
    # the kernel and its yardsticks: the least of 3 means, each over 3
    # calls (large shapes) or 20
    it = 3 if R * W > 1 << 24 else 20
    ms = cuda_ms(kern, it, repeats=3)
    plain_ms = cuda_ms(lambda: chunked(plain, R, rows), max(1, it // 3))
    lib_ms = cuda_ms(lambda: torch.sort(d, dim=1, stable=True), it,
                     repeats=3)
    # a second yardstick on wide rows, whose tie order is not (dist, id)
    topk_ms = selection_ms(d, ids, keep, it, mask) \
        if W >= 1024 and keep < W else None
    b_ms, b_by = bound(R * W * 9 + R * keep * 8, R * topk_ops(W, keep))
    return dict(shape=name, R=R, W=W, keep=keep, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, torch_topk_ms=topk_ms,
                path=topk_path(R, W, keep))


def check_visited(name, B, bound_ins, M, dev, gen, n_buckets=None):
    """The filter against its plain version, bit for bit (table and fresh
    lanes), on a table that three calls have partly filled.  The table is
    ``visited_table``'s for ``bound_ins`` insertions, or, with
    ``n_buckets``, one of that many buckets (``visited_table`` never sizes
    below 64): 32 lanes a call on 16 buckets collide, fill buckets and
    drop."""
    import torch

    from repro_torch.core import hotpath as HP
    from repro_torch.kernels import visited

    table = HP.visited_table(B, bound_ins, device=dev) if n_buckets is None \
        else torch.full((B, n_buckets, 8), visited.VF_EMPTY,
                        dtype=torch.int32, device=dev)
    S, W = table.shape[1:]

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
    held = (tp.gather(1, visited.hash_bucket(ids, visited.shift_for(S))
                      [:, :, None].expand(B, M, W)) == ids[:, :, None]).any(2)
    n_drops = int((valid & ~fp & ~held).sum())
    work = table.clone()
    ms = cuda_ms(lambda: visited.visited_filter(work, ids, valid), 20)
    device_ms = cuda_ms(lambda: visited.visited_filter(work, ids, valid), 20,
                        repeats=3, ahead=True)
    plain_ms = cuda_ms(lambda: visited.visited_filter_plain(work, ids, valid),
                       3)
    n_valid, n_fresh = int(valid.sum()), int(fp.sum())
    b_ms, b_by = bound(B * M * 6 + n_valid * W * 4 + n_fresh * 4,
                       n_valid * W)
    # a probe reads its bucket's ways: contiguous here, S words apart in
    # the reference's layout (a 32-byte sector each)
    sector = 32
    return dict(shape=name, B=B, W=W, S=S, M=M, max_abs_err=0.0, ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, fresh=n_fresh, drops=n_drops,
                probe_bytes=W * 4,
                probe_sector_bytes=-(-W * 4 // sector) * sector,
                way_major_sector_bytes=W * sector)


# --------------------------------------------------------------------------
# phase 9: the kernel API (kernels/ops.py), each kernel against its plain
# version
# --------------------------------------------------------------------------

def check_distance_matrix(name, Q, X, metric="l2"):
    """``ops.distance_matrix`` against its plain version; returns the row
    of numbers and the kernel's output."""
    import torch

    from repro_torch.kernels import block, ops

    B, d = Q.shape
    N = X.shape[0]

    def kern():
        return ops.distance_matrix(Q, X, metric=metric)

    def plain():
        return block.distance_matrix_plain(Q, X, metric=metric)

    def library():  # torch.matmul, TF32 off, + the epilogue in PyTorch
        Qf, Xf = Q.float(), X.float()
        dots = torch.matmul(Qf, Xf.T)
        if metric != "l2":
            return -dots
        return (Qf * Qf).sum(1)[:, None] + (Xf * Xf).sum(1) - 2.0 * dots

    out = kern()
    ref = plain()
    torch.cuda.synchronize()
    xn = (X.double() ** 2).sum(1)
    qn = (Q.double() ** 2).sum(1)
    err_max, ratio, bad = 0.0, 0.0, 0
    for lo in range(0, B, 64):     # the float64 check in row chunks
        err = (out[lo:lo + 64].double() - ref[lo:lo + 64].double()).abs()
        tol = 1e-5 * (qn[lo:lo + 64, None] + xn)
        bad += int((err > tol).sum())
        err_max = max(err_max, float(err.max()))
        ratio = max(ratio, float((err / tol).max()))
    if bad or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"distance_matrix {name}: {bad} entries over "
                             "1e-5*(qn+xn)")
    del ref
    big = B * N > 1 << 26
    it, reps = (3, 1) if big else (20, 3)   # reps: see cuda_ms
    ms = cuda_ms(kern, it, repeats=reps)
    plain_ms = cuda_ms(plain, max(1, it // 3))
    lib_ms = cuda_ms(library, max(1, it // 3), repeats=reps)
    isz = Q.element_size()
    nbytes = (B + N) * d * isz + B * N * 4
    flops = 2 * B * N * d + (2 * (B + N) * d if metric == "l2" else 0)
    return dict(shape=name, B=B, N=N, d=d, dtype=str(Q.dtype).replace(
        "torch.", ""), max_abs_err=err_max, err_over_tol=ratio, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, **tensor_bounds(
            nbytes, flops, 2 * B * N * d, Q.dtype == torch.bfloat16)), out


def check_sort(name, dists, ids, keep):
    """``ops.bitonic_sort`` (keep = W) or ``ops.bitonic_topk`` against its
    plain version, exactly: the same ids and the same values."""
    import torch

    from repro_torch.kernels import ops, ref

    R, W = dists.shape
    rows = max(1, (1 << 27) // W)

    def kern():
        if keep == W:
            return ops.bitonic_sort(dists, ids)
        return ops.bitonic_topk(dists, ids, keep)

    def plain(lo=0, hi=R):
        return ref.topk_ref(dists[lo:hi], ids[lo:hi], keep)

    od, oi = kern()
    rd, ri = chunked(plain, R, rows)
    torch.cuda.synchronize()
    if not (bool((od == rd).all()) and torch.equal(oi, ri)):
        raise AssertionError(f"bitonic_sort {name}: kernel != plain")
    del od, oi, rd, ri
    it = 3 if R * W > 1 << 24 else 20     # as in check_rank_merge
    ms = cuda_ms(kern, it, repeats=3)
    plain_ms = cuda_ms(lambda: chunked(plain, R, rows), max(1, it // 3))
    lib_ms = cuda_ms(lambda: torch.sort(dists, dim=1, stable=True), it,
                     repeats=3)
    # a second, informational yardstick for a top-k: a selection, whose
    # order among tied distances is not the (dist, id) order
    topk_ms = (selection_ms(dists, ids, keep, it) if keep < W else None)
    b_ms, b_by = bound(R * W * 8 + R * keep * 8, R * topk_ops(W, keep))
    return dict(shape=name, R=R, W=W, keep=keep, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, torch_topk_ms=topk_ms,
                path=topk_path(R, W, keep))


def sort_case(R, W, dev, gen):
    """Distances with repeats, -0.0 beside +0.0, and repeated ids."""
    import torch

    d = torch.randint(0, 64, (R, W), generator=gen, device=dev).float() * 0.5
    d[torch.rand((R, W), generator=gen, device=dev) < 0.05] = -0.0
    ids = torch.randint(0, 1 << 20, (R, W), generator=gen, device=dev,
                        dtype=torch.int32)
    return d, ids


def check_embedding_bag(name, table, ids, combine="mean"):
    """``ops.embedding_bag`` (the route ``embedding_bag.path`` picks) and
    both forced routes: the vector route bit for bit against the lane
    route (the earlier design, a warp a bag), and
    each against the plain version on the widened table, within 1e-6 *
    the bag's sum of |rows| (plus one rounding of the output, 2^-8 *
    |out|, for a bf16 table); whether they equal the plain version on the
    table itself bit for bit is reported.  Times: ``ms`` back to back,
    each route's ``device_ms`` (the calls queued ahead), the plain
    version's and ``F.embedding_bag``'s; the bound at the table's own
    bytes an element (each distinct row once), and each route's achieved
    GB/s over the bound's bytes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag, ops

    B, bag = ids.shape
    E = table.shape[1]
    bf16 = table.dtype == torch.bfloat16
    route = embedding_bag.path(table, ids)

    def kern():
        return ops.embedding_bag(table, ids, combine=combine)

    def via(r):
        return lambda: embedding_bag.embedding_bag(table, ids,
                                                   combine=combine, via=r)

    def plain():
        return embedding_bag.embedding_bag_plain(table, ids, combine=combine)

    ids64 = ids.long()

    def library():
        return F.embedding_bag(ids64, table, mode=combine)

    out = kern()
    outs = {r: via(r)() for r in embedding_bag.ROUTES
            if r == "lane" or route == "vector"}
    # the plain version on the widened table, in float32
    ref = embedding_bag.embedding_bag_plain(table.float(), ids,
                                            combine=combine)
    same = plain()
    torch.cuda.synchronize()
    scale = table[ids64].float().abs().sum(1) / (
        bag if combine == "mean" else 1)
    tol = 1e-6 * scale + (2.0 ** -8 * ref.abs() if bf16 else 0.0)
    err = max(float((o.float() - ref).abs().max()) for o in outs.values())
    for r, o in outs.items():
        if o.dtype != table.dtype or bool(
                ((o.float() - ref).abs() > tol).any()) or not bool(
                torch.isfinite(o).all()):
            raise AssertionError(f"embedding_bag {name} ({r} route): over "
                                 "1e-6*sum|rows|" + (" + 2^-8|out|" if bf16
                                                     else ""))
    if not torch.equal(out, outs[route]) or not all(
            torch.equal(o, outs["lane"]) for o in outs.values()):
        raise AssertionError(f"embedding_bag {name}: the routes differ "
                             "(the vector route must equal the lane route "
                             "bit for bit)")
    ms = cuda_ms(kern, 20)
    route_ms = {r: cuda_ms(via(r), 20, repeats=3, ahead=True) for r in outs}
    plain_ms = cuda_ms(plain, 5)
    lib_ms = cuda_ms(library, 5)
    rows = int(torch.unique(ids).numel())   # the rows this batch needs
    el = table.element_size()
    nbytes = rows * E * el + B * bag * 4 + B * E * el
    b_ms, b_by = bound(nbytes, B * bag * E)
    return dict(shape=name, V=table.shape[0], E=E, B=B, bag=bag,
                combine=combine, dtype=str(table.dtype).replace("torch.", ""),
                path=route, group=embedding_bag.group(E, table.dtype),
                max_abs_err=err, ms=ms, device_ms=route_ms[route],
                route_device_ms=route_ms,
                route_gb_per_s={r: nbytes / t / 1e6
                                for r, t in route_ms.items()},
                bit_equal_plain=bool(torch.equal(out, same)),
                distinct_rows=rows, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def bag_extra(r: dict) -> str:
    """The route details of a ``[kernel] embedding_bag`` line."""
    return (f" (a group of {r['group']} lanes a bag); device_ms "
            + ", ".join(f"{k}={v:.4f}" for k, v in
                        r["route_device_ms"].items())
            + " (lane: the earlier design); achieved "
            + ", ".join(f"{k} {v:.0f} GB/s" for k, v in
                        r["route_gb_per_s"].items())
            + " of 3350"
            + ("; vector == lane bit for bit" if "vector" in
               r["route_device_ms"] else "")
            + f"; == the plain version bit for bit: {r['bit_equal_plain']};"
            f" {r['distinct_rows']} "
            "distinct rows")


def check_spmm(name, nbrs, feat, w, combine="mean"):
    """``ops.packed_spmm`` (the route ``segment_matmul.path`` picks) and
    both forced routes against the plain version on the widened inputs,
    each within 1e-5 * (|agg| @ |W|) (plus one rounding of the output,
    2^-8 * |out|, for bf16 feat); every time but ``ms`` is ``device_ms`` (the
    calls queued ahead).  No single PyTorch call computes this function
    (a gather, a masked mean, a product), so library_ms is None; the
    transform route's projection is timed beside ``torch.matmul`` (TF32
    off), and its gather alone.  ``bound_ms`` is the function's (its
    inputs read once, its operations at the rate of the route's product:
    TF32 tensor cores for "transform", fp32 for "fused"; the rows with
    no valid lane, whose output is 0, cost no operations).  Each route's
    floor and HBM-traffic estimate come from ``segment_matmul.route_costs``
    over the valid lanes: the floor reads each distinct row of feat or Y
    once, the estimate every valid lane's row from HBM (no L2 hits), which
    a gather can beat.  Rows of bf16 feat count 2 bytes an element, and
    so does a bf16 output."""
    import torch

    from repro_torch.kernels import ops, segment_matmul as sm

    N, M = nbrs.shape
    Nf, d = feat.shape
    f = w.shape[1]
    route = sm.path(N, M, Nf, d, f)
    bf16 = feat.dtype == torch.bfloat16
    el = feat.element_size()

    def kern():
        return ops.packed_spmm(nbrs, feat, w, combine=combine)

    def plain():
        return sm.packed_spmm_plain(nbrs, feat, w, combine=combine)

    agg = sm.aggregate(nbrs, feat, combine=combine)
    ref = agg @ w.float()      # the plain version's float32 result
    tol = 1e-5 * (agg.abs() @ w.float().abs())
    if bf16:
        tol += 2.0 ** -8 * ref.abs()
    del agg
    err_max, ratio = 0.0, {}
    for via in sm.ROUTES:
        out = sm.packed_spmm(nbrs, feat, w, combine=combine, via=via)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs()
        if out.dtype != feat.dtype or bool((err > tol).any()) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"packed_spmm {name} via {via}: over "
                                 "1e-5*(|agg|@|W|)"
                                 + (" + 2^-8|out|" if bf16 else ""))
        err_max = max(err_max, float(err.max()))
        ratio[via] = float((err / tol.clamp_min(1e-30)).max())
        del out, err
    del ref, tol
    ms = cuda_ms(kern, 5)
    dev_ms = {via: cuda_ms(lambda: sm.packed_spmm(
        nbrs, feat, w, combine=combine, via=via), 5, repeats=2, ahead=True)
        for via in sm.ROUTES}
    y = sm.project(feat, w, out_dtype=torch.float32)
    project_ms = cuda_ms(lambda: sm.project(feat, w,
                                            out_dtype=torch.float32), 5,
                         repeats=2, ahead=True)
    feat_f = feat.float()      # the library's product on the widened rows
    matmul_ms = cuda_ms(lambda: torch.matmul(feat_f, w.float()), 5,
                        repeats=2, ahead=True)
    del feat_f
    gather_ms = cuda_ms(lambda: sm.gather_rows(nbrs, y, combine=combine),
                        5, repeats=2, ahead=True)
    del y
    plain_ms = cuda_ms(plain, 2)
    valid = nbrs < Nf
    n_valid = int(valid.sum())
    rows = int(torch.unique(nbrs[valid]).numel())
    filled = int(valid.any(1).sum())   # a row with no lane is 0: no work
    nbytes = (N * M * 4 + rows * d * el + d * f * w.element_size()
              + N * f * el)
    flops = 2 * filled * d * f + n_valid * d \
        + (filled * d if combine == "mean" else 0)
    if route == "transform":   # the product on tensor cores in 3xTF32
        bounds = tensor_bounds(nbytes, flops, 2 * Nf * d * f, False)
    else:
        bounds = dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops)))
    floor = sm.route_costs(N, M, Nf, d, f, lanes=n_valid, rows=rows,
                           elem=el)
    traffic = sm.route_costs(N, M, Nf, d, f, lanes=n_valid, elem=el)
    return dict(shape=name, path=route, N=N, M=M, Nf=Nf, d=d, f=f,
                dtype=str(feat.dtype).replace("torch.", ""),
                combine=combine, valid_lanes=n_valid, max_abs_err=err_max,
                err_over_tol=ratio, ms=ms, device_ms=dev_ms[route],
                fused_device_ms=dev_ms["fused"],
                transform_device_ms=dev_ms["transform"],
                project_device_ms=project_ms,
                library_matmul_device_ms=matmul_ms,
                gather_device_ms=gather_ms, plain_ms=plain_ms,
                library_ms=None, **bounds,
                gathered_bytes=n_valid * d * el,
                fused_floor_ms=sm.modelled_ms(floor["fused"]),
                fused_traffic_ms=sm.modelled_ms(traffic["fused"]),
                project_floor_ms=sm.modelled_ms(floor["transform"][:1]),
                gather_floor_ms=sm.modelled_ms(floor["transform"][1:]),
                gather_traffic_ms=sm.modelled_ms(traffic["transform"][1:]),
                transform_floor_ms=sm.modelled_ms(floor["transform"]))


def spmm_case(N, M, dev, gen):
    """GraphSAGE's neighbour lists: N rows of M ids uniform over the
    GNN_NODES nodes, GNN_SENTINEL_SHARE of the lanes the sentinel."""
    import torch

    nbrs = torch.randint(0, GNN_NODES, (N, M), generator=gen, device=dev,
                         dtype=torch.int32)
    nbrs[torch.rand(nbrs.shape, generator=gen, device=dev)
         < GNN_SENTINEL_SHARE] = GNN_NODES
    return nbrs


def visible_pairs(Sq, Skv, window, q_offset) -> int:
    """The (query, key) pairs the causal / window mask lets through."""
    total = 0
    for i in range(Sq):
        p = q_offset + i
        lo = max(0, p - window + 1) if window > 0 else 0
        total += max(0, min(p, Skv - 1) - lo + 1)
    return total


def sdpa(q, k, v, window, q_offset):
    """PyTorch's fused attention on the same inputs (the yardstick, never
    called by the port): the causal flag where the mask is the plain
    causal one, an explicit boolean mask otherwise."""
    import torch
    import torch.nn.functional as F

    Sq, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if window <= 0 and q_offset == 0 and Sq == Skv:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=gqa)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                          enable_gqa=gqa)


def attention_err_over_tol(out, want, weight):
    """The largest |out - want| / tol of the contract: 1e-5 * (P @ |V|),
    plus one rounding of the output (2^-8 * |out|) for bfloat16."""
    import torch

    tol = 1e-5 * weight
    if out.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * want.abs()
    return float(((out.float() - want).abs() / tol.clamp_min(1e-30)).max())


def check_attention(name, q, k, v, window=0, q_offset=0):
    """``ops.flash_attention`` against its plain version, the float32
    oracle ``ref.attention_ref`` on the widened inputs, within the contract
    (:func:`attention_err_over_tol` <= 1); the SDPA yardstick's own
    err/tol on the same inputs beside it.  Bound: the products at the
    tensor-core rate of the input type (bf16 989, TF32 495 TFLOP/s) or the
    bytes; as named extras, the same at the fp32 rate (the bound of the
    earlier FFMA design) and the products the tile path issues (1.5x in
    bf16, 3x in 3xTF32)."""
    import torch

    from repro_torch.kernels import flash_attention, ops, ref

    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kw = dict(window=window, q_offset=q_offset)
    body = flash_attention.path(B, Sq, Skv, H, KV, hd, q.dtype)

    def kern():
        return ops.flash_attention(q, k, v, **kw)

    def plain():
        return ref.attention_ref(q.float(), k.float(), v.float(), **kw)

    def library():
        return sdpa(q, k, v, window, q_offset)

    out = kern()
    want = plain()
    weight = ref.attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    torch.cuda.synchronize()
    ratio = attention_err_over_tol(out, want, weight)
    if not ratio <= 1.0 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"flash_attention {name}: err/tol {ratio}, "
                             "over 1e-5*(P@|V|)")
    err_max = float((out.float() - want).abs().max())
    lib_ratio = attention_err_over_tol(
        library().transpose(1, 2), want, weight)
    del out, want, weight
    torch.cuda.empty_cache()
    ms = cuda_ms(kern, 10, repeats=3)
    plain_ms = cuda_ms(plain, 2)
    lib_ms = cuda_ms(library, 10, repeats=3)
    pairs = visible_pairs(Sq, Skv, window, q_offset)
    flops = 4 * hd * pairs * B * H          # q.k and p.v, 2 ops per MAC
    nbytes = (2 * B * Sq * H + 2 * B * Skv * KV) * hd * q.element_size()
    bf16 = q.dtype == torch.bfloat16
    rate = BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S
    b_ms, b_by = bound(nbytes, flops, rate)
    issued = flops * (1.5 if bf16 else 3.0) if body == "tile" else flops
    return dict(shape=name, path=body, B=B, Sq=Sq, Skv=Skv, H=H, KV=KV,
                hd=hd, window=window, q_offset=q_offset,
                dtype=str(q.dtype).replace("torch.", ""),
                max_abs_err=err_max, err_over_tol=ratio,
                sdpa_err_over_tol=lib_ratio, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                fp32_rate_bound_ms=bound(nbytes, flops)[0],
                issued_products_bound_ms=bound(
                    nbytes, issued, rate if body == "tile"
                    else FP32_OPS_PER_S)[0])


def attention_threshold(dev, gen) -> list:
    """Both bodies of ``flash_attention`` at decode-like shapes with a
    growing number of query rows a KV head (Sq * G): 8 sequences, 16
    heads of 128 (G = 1) over 32,768 keys of cache, bf16.  Where the split
    path stops winning sets ``flash_attention.SPLIT_ROWS``."""
    import torch

    from repro_torch.kernels import flash_attention

    rows = []
    for Sq in (1, 2, 4, 8, 16, 32, 64):
        case = attention_case(LM_DECODE_BATCH, Sq, LM_DECODE_KV, OLMO_HEADS,
                              OLMO_HEADS, HEAD_DIM, torch.bfloat16, dev, gen)
        kw = dict(q_offset=LM_DECODE_KV - Sq)
        t = {via: cuda_ms(lambda: flash_attention.flash_attention(
            *case, via=via, **kw), 5, repeats=2) for via in ("tile", "split")}
        rows.append(dict(rows=Sq, tile_ms=t["tile"], split_ms=t["split"],
                         path=flash_attention.path(
                             LM_DECODE_BATCH, Sq, LM_DECODE_KV, OLMO_HEADS,
                             OLMO_HEADS, HEAD_DIM, torch.bfloat16)))
        log(f"[threshold] flash_attention {Sq} query rows a KV head over "
            f"{LM_DECODE_KV} keys (8 x 16 heads of 128, bf16): tile "
            f"{t['tile']:.4f} ms, split {t['split']:.4f} ms; path "
            f"{rows[-1]['path']}")
        del case
    return rows


def _flash_body(kind, t, hd, nq, vl) -> str:
    name = f"{kind}_{'bf16' if t != 'f' else 'f32'}"
    if hd:
        name += f"_hd{hd}"
    if nq:
        name += f"_nq{nq}" if vl == "1" else "_scalar"
    return name


# the tensor-core kernels of each source, as their cuobjdump symbols
# start, and the name kernels/<module>.py's BODIES give each
SASS_BODIES = {
    "flash_attention": (r"(tile|split|combine)_kernelI(13__nv_bfloat16|f)"
                        r"(?:Li(\d+)E)?(?:Li(\d+)E)?(?:Lb([01])E)?",
                        _flash_body),
    "l2dist": (r"gather_selfq_kernelILi(\d+)ELb([01])ELb([01])E",
               lambda nt, vec, one: f"selfq_nt{nt}"
               + ("" if vec == "1" else "_scalar")
               + ("" if one == "1" else "_streamed")),
    "block": (r"dm_kernelI(13__nv_bfloat16|f)Lb([01])ELb([01])E",
              lambda t, vec, i8: "dm_" + ("i8" if i8 == "1" else "f32"
                                          if t == "f" else "bf16")
              + ("" if vec == "1" else "_scalar")),
    "segment_matmul": (r"project_kernelILi(\d+)ELi(\d+)E",
                       lambda a, w: f"project_a{a}_w{w}"),
    "flash_attention_bwd": (r"(dq|dkv)_kernelI(13__nv_bfloat16|f)Li(\d+)E",
                            lambda p, t, d: f"{p}_"
                            + ("f32" if t == "f" else "bf16") + f"_hd{d}"),
}


def sass_hmma() -> dict:
    """HMMA (tensor-core) instructions in each compiled body of
    ``csrc/flash_attention.cu``, of ``csrc/l2dist.cu``'s self-query tile,
    of ``csrc/block.cu``'s tile (float32, bf16, int8 codes), of
    ``csrc/segment_matmul.cu``'s projection and of
    ``csrc/flash_attention_bwd.cu``'s two passes, from ``cuobjdump -sass``
    where the toolkit has it (else an empty dict):
    ``{source: {body: count}}``."""
    import re

    from repro_torch.kernels import _build

    out: dict = {}
    for source, (pattern, body) in SASS_BODIES.items():
        kernels = _build.hmma_counts(source)
        if kernels is None:
            return {}
        counts = out[source] = {}
        for kernel, n in kernels.items():
            m = re.search(pattern, kernel)
            if m:
                counts[body(*m.groups())] = n
    return out


def attention_case(B, Sq, Skv, H, KV, hd, dtype, dev, gen):
    import torch

    return [torch.randn((B, S, h, hd), generator=gen, device=dev).to(dtype)
            for S, h in ((Sq, H), (Skv, KV), (Skv, KV))]


def api_phase(ds, n, d, dev, gen) -> tuple:
    """Phase 9: each kernel of the kernel API against its plain version at
    full size, then the API's path with every counter reset: the exact
    k-NN of phase 3's first queries through ``ops.distance_matrix`` and
    ``ops.bitonic_topk`` (recall@10 against the ground truth), wide_deep's
    bag field through ``ops.embedding_bag``, GraphSAGE's first layer over
    the whole graph and minibatch_lg's through ``ops.packed_spmm``, and
    an attention prefill and decode step through
    ``ops.flash_attention``."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.data.synthetic import recall_at_k
    from repro_torch.kernels import ops, segment_matmul

    torch.backends.cuda.matmul.allow_tf32 = False   # the library yardstick
    shapes = {k: [] for k in API_BODIES}
    for B, N, dt in ((256, 8192, torch.float32), (256, 8192, torch.bfloat16)):
        Q = torch.randn((B, d), generator=gen, device=dev).to(dt)
        X = torch.randn((N, d), generator=gen, device=dev).to(dt)
        row, _ = check_distance_matrix(
            f"[{B}, {N}] x {d} {str(dt).replace('torch.', '')}", Q, X)
        shapes["distance_matrix"].append(row)
    nq = min(KNN_QUERIES, ds.Q.shape[0])
    Qk = torch.as_tensor(ds.Q[:nq], device=dev)
    Xk = torch.as_tensor(ds.X, device=dev)
    knn_shape = f"exact k-NN [{nq}, {n}] x {d}"
    row, D = check_distance_matrix(knn_shape, Qk, Xk)
    shapes["distance_matrix"].append(row)
    ids_all = torch.arange(n, dtype=torch.int32,
                           device=dev).expand(nq, n).contiguous()
    topk_shape = f"top-10 of [{nq}, {n}]"
    shapes["bitonic_sort"].append(check_sort(topk_shape, D, ids_all, 10))
    del D
    torch.cuda.empty_cache()
    for name, R, W, keep in (("sort [2048, 64]", 2048, 64, 64),
                             ("top-10 of [10240, 1024]", 10240, 1024, 10),
                             ("sort [64, 16384]", 64, 16384, 16384)):
        shapes["bitonic_sort"].append(check_sort(name, *sort_case(
            R, W, dev, gen), keep))
    table = torch.randn((BAG_ROWS, BAG_DIM), generator=gen, device=dev)
    bag_ids = {B: torch.randint(0, BAG_ROWS, (B, BAG_SIZE), generator=gen,
                                device=dev, dtype=torch.int32)
               for B in BAG_BATCHES}
    for B, ids in bag_ids.items():
        shapes["embedding_bag"].append(check_embedding_bag(
            f"[{BAG_ROWS}, {BAG_DIM}] bag {BAG_SIZE} mean B={B}", table, ids))
    feat = torch.randn((GNN_NODES, GNN_FEAT), generator=gen, device=dev)
    w = torch.randn((GNN_FEAT, GNN_HIDDEN), generator=gen,
                    device=dev) * GNN_FEAT ** -0.5
    nbrs = spmm_case(GNN_NODES, GNN_FANOUT, dev, gen)
    nbrs_mb = spmm_case(*GNN_MINIBATCH, dev, gen)
    spmm_shape = (f"N={GNN_NODES} M={GNN_FANOUT} [{GNN_NODES}, {GNN_FEAT}] "
                  f"@ [{GNN_FEAT}, {GNN_HIDDEN}] mean")
    minibatch_shape = (f"minibatch_lg N={GNN_MINIBATCH[0]} "
                       f"M={GNN_MINIBATCH[1]} [{GNN_NODES}, {GNN_FEAT}] @ "
                       f"[{GNN_FEAT}, {GNN_HIDDEN}] mean")
    for name, lists in ((spmm_shape, nbrs), (minibatch_shape, nbrs_mb)):
        shapes["packed_spmm"].append(check_spmm(name, lists, feat, w))
    # the bf16 bodies: wide_deep's bags of a bf16 table, GraphSAGE's layer
    # on bf16 features (W float32, widened as the reference widens it)
    table_b, feat_b = table.bfloat16(), feat.bfloat16()
    bag_bf16_shape = (f"[{BAG_ROWS}, {BAG_DIM}] bf16 bag {BAG_SIZE} mean "
                      f"B={BAG_BATCHES[-1]}")
    spmm_bf16_shape = spmm_shape + " bf16"
    shapes["embedding_bag_bf16"] = [check_embedding_bag(
        bag_bf16_shape, table_b, bag_ids[BAG_BATCHES[-1]])]
    shapes["packed_spmm_bf16"] = [check_spmm(spmm_bf16_shape, nbrs, feat_b,
                                             w)]
    bf16 = torch.bfloat16
    attn_shape = (f"olmo_1b prefill [1, {LM_SEQ}, {OLMO_HEADS}, {HEAD_DIM}]"
                  " causal bf16")
    decode_shape = (f"olmo_1b decode [{LM_DECODE_BATCH}, 1, {OLMO_HEADS}, "
                    f"{HEAD_DIM}] over {LM_DECODE_KV} keys bf16")
    lm = attention_case(1, LM_SEQ, LM_SEQ, OLMO_HEADS, OLMO_HEADS, HEAD_DIM,
                        bf16, dev, gen)
    shapes["flash_attention"].append(check_attention(attn_shape, *lm))
    for name, (B, Sq, Skv, H, KV, dt), window, q_offset in (
            (f"olmo_1b prefill [1, {LM_SEQ // 2}, {OLMO_HEADS}, {HEAD_DIM}] "
             "causal fp32", (1, LM_SEQ // 2, LM_SEQ // 2, OLMO_HEADS,
                             OLMO_HEADS, torch.float32), 0, 0),
            (f"gemma3_27b local [1, {LM_SEQ}, {GEMMA_HEADS}/"
             f"{GEMMA_KV_HEADS}, {HEAD_DIM}] window {GEMMA_WINDOW} bf16",
             (1, LM_SEQ, LM_SEQ, GEMMA_HEADS, GEMMA_KV_HEADS, bf16),
             GEMMA_WINDOW, 0),
            (decode_shape, (LM_DECODE_BATCH, 1, LM_DECODE_KV, OLMO_HEADS,
                            OLMO_HEADS, bf16), 0, LM_DECODE_KV - 1),
            (f"gemma3_27b global decode [{LM_DECODE_BATCH}, 1, "
             f"{GEMMA_HEADS}/{GEMMA_KV_HEADS}, {HEAD_DIM}] over "
             f"{LM_DECODE_KV} keys bf16",
             (LM_DECODE_BATCH, 1, LM_DECODE_KV, GEMMA_HEADS, GEMMA_KV_HEADS,
              bf16), 0, LM_DECODE_KV - 1)):
        case = attention_case(B, Sq, Skv, H, KV, HEAD_DIM, dt, dev, gen)
        shapes["flash_attention"].append(check_attention(
            name, *case, window=window, q_offset=q_offset))
        if name == decode_shape:
            decode = case
        del case
    threshold = attention_threshold(dev, gen)
    for kname, rows in shapes.items():
        for r in rows:
            extra = ""
            if kname.startswith("packed_spmm"):
                tol = r["err_over_tol"]
                extra = (f" err/tol fused={tol['fused']:.3f} transform="
                         f"{tol['transform']:.3f}; device_ms fused="
                         f"{r['fused_device_ms']:.4f} transform="
                         f"{r['transform_device_ms']:.4f} (projection "
                         f"{r['project_device_ms']:.4f}, torch.matmul TF32 "
                         f"off {r['library_matmul_device_ms']:.4f}; gather "
                         f"{r['gather_device_ms']:.4f}); floors (each "
                         f"distinct row once): fused "
                         f"{r['fused_floor_ms']:.4f} ms, transform "
                         f"{r['transform_floor_ms']:.4f} ms (projection "
                         f"{r['project_floor_ms']:.4f}, gather "
                         f"{r['gather_floor_ms']:.4f}); HBM traffic with "
                         f"no L2 hits: fused {r['fused_traffic_ms']:.4f} ms"
                         f" ({r['gathered_bytes'] / 1e9:.2f} GB of valid "
                         f"lanes' rows), transform gather "
                         f"{r['gather_traffic_ms']:.4f} ms; no single "
                         "PyTorch call computes it")
            elif kname.startswith("embedding_bag"):
                extra = bag_extra(r)
            elif kname == "flash_attention":
                rate = "bf16" if r["dtype"] == "bfloat16" else "TF32"
                extra = (f" err/tol={r['err_over_tol']:.3f} (SDPA's "
                         f"{r['sdpa_err_over_tol']:.3f}); bound at the "
                         f"{rate} tensor-core rate or bytes; at the "
                         f"fp32 rate {r['fp32_rate_bound_ms']:.4f} ms, the "
                         f"products issued {r['issued_products_bound_ms']:.4f}"
                         " ms")
            log_kernel(kname, r, extra)

    # the kernel API's path, counted
    out: dict = {}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    D = ops.distance_matrix(Qk, Xk)
    _, top = ops.bitonic_topk(D, ids_all, 10)
    torch.cuda.synchronize()
    out["knn_s"] = time.perf_counter() - t0
    del D
    found = top.cpu().numpy()
    if found.shape != (nq, 10) or not ((found >= 0) & (found < n)).all():
        raise AssertionError("exact k-NN: bad ids")
    out["knn_recall_at_10"] = rec = recall_at_k(found, ds.gt[:nq], 10)
    log(f"[api] exact k-NN of {nq} queries over {n} rows through "
        f"ops.distance_matrix + ops.bitonic_topk: {out['knn_s'] * 1e3:.2f} "
        f"ms, recall@10={rec:.4f} (make_clustered's ground truth)")
    if rec < 0.999:
        raise AssertionError(f"exact k-NN recall@10 {rec} < 0.999")
    for B, ids in bag_ids.items():
        t0 = time.perf_counter()
        emb = ops.embedding_bag(table, ids, combine="mean")
        torch.cuda.synchronize()
        out[f"embedding_bag_{B}_ms"] = (time.perf_counter() - t0) * 1e3
        if emb.shape != (B, BAG_DIM) or not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"embedding_bag B={B}: bad output")
    bf16_launches = {}
    before = K.launch_counts()
    emb = ops.embedding_bag(table_b, bag_ids[BAG_BATCHES[-1]])
    torch.cuda.synchronize()
    bf16_launches["embedding_bag_bf16"] = \
        K.launch_counts()["embedding_bag"] - before["embedding_bag"]
    if emb.dtype != torch.bfloat16 or not bool(torch.isfinite(emb).all()):
        raise AssertionError("embedding_bag bf16: bad output")
    spmm_launches = 0
    for label, lists, x in (("graphsage", nbrs, feat),
                            ("minibatch", nbrs_mb, feat),
                            ("graphsage_bf16", nbrs, feat_b)):
        n0 = K.launch_counts()["packed_spmm"]
        t0 = time.perf_counter()
        h = ops.packed_spmm(lists, x, w, combine="mean")
        torch.cuda.synchronize()
        out[f"packed_spmm_{label}_ms"] = (time.perf_counter() - t0) * 1e3
        if h.shape != (lists.shape[0], GNN_HIDDEN) or h.dtype != x.dtype \
                or not bool(torch.isfinite(h).all()):
            raise AssertionError(f"packed_spmm {label}: bad output")
        route = segment_matmul.path(*lists.shape, GNN_NODES, GNN_FEAT,
                                    GNN_HIDDEN)
        out[f"packed_spmm_{label}_path"] = route
        spmm_launches += 2 if route == "transform" else 1
        if x is feat_b:
            bf16_launches["packed_spmm_bf16"] = \
                K.launch_counts()["packed_spmm"] - n0
        del h
    for label, case, kw in (("prefill", lm, {}),
                            ("decode", decode,
                             dict(q_offset=LM_DECODE_KV - 1))):
        t0 = time.perf_counter()
        att = ops.flash_attention(*case, **kw)
        torch.cuda.synchronize()
        out[f"flash_attention_{label}_ms"] = (time.perf_counter() - t0) * 1e3
        if att.shape != case[0].shape or not bool(
                torch.isfinite(att).all()):
            raise AssertionError(f"flash_attention {label}: bad output")
        del att
    del lm, decode
    log("[api] embedding_bag B=" + ", B=".join(
        f"{B}: {out[f'embedding_bag_{B}_ms']:.3f} ms" for B in BAG_BATCHES)
        + f"; packed_spmm GraphSAGE ({out['packed_spmm_graphsage_path']}): "
        f"{out['packed_spmm_graphsage_ms']:.3f} ms, minibatch_lg "
        f"({out['packed_spmm_minibatch_path']}): "
        f"{out['packed_spmm_minibatch_ms']:.3f} ms, GraphSAGE bf16 "
        f"({out['packed_spmm_graphsage_bf16_path']}): "
        f"{out['packed_spmm_graphsage_bf16_ms']:.3f} ms; flash_attention "
        f"olmo_1b prefill (tile): {out['flash_attention_prefill_ms']:.3f} ms,"
        f" decode (split): {out['flash_attention_decode_ms']:.3f} ms (host "
        "clock)")
    launches = K.launch_counts()
    log("[launches] phase 9 " + json.dumps(launches))
    missing = [k for k in API_BODIES if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the kernel API's "
                             f"path: {missing}")
    if launches["packed_spmm"] != spmm_launches:
        raise AssertionError(f"packed_spmm: its routes launch "
                             f"{spmm_launches} kernels, counted "
                             f"{launches['packed_spmm']}")
    if launches["flash_attention"] != 3:
        raise AssertionError("flash_attention: a prefill (tile, 1 launch) "
                             "and a decode step (split, 2) launched "
                             f"{launches['flash_attention']} times")
    if bf16_launches != {"embedding_bag_bf16": 1, "packed_spmm_bf16": 2}:
        raise AssertionError(f"the bf16 bodies' launches {bf16_launches}: "
                             "a bag (1) and GraphSAGE's transform route (2)")
    out["flash_attention_threshold"] = threshold
    main = dict(distance_matrix=knn_shape, bitonic_sort=topk_shape,
                embedding_bag=f"[{BAG_ROWS}, {BAG_DIM}] bag {BAG_SIZE} mean "
                              f"B={BAG_BATCHES[-1]}",
                packed_spmm=spmm_shape, flash_attention=attn_shape,
                embedding_bag_bf16=bag_bf16_shape,
                packed_spmm_bf16=spmm_bf16_shape)
    # the fp32 bodies' launches: the counters also took the bf16 calls
    launches["embedding_bag"] -= bf16_launches["embedding_bag_bf16"]
    launches["packed_spmm"] -= bf16_launches["packed_spmm_bf16"]
    return (shapes, main, {**{k: launches[k] for k in API_BODIES},
                           **bf16_launches}, out)


# --------------------------------------------------------------------------
# phase 8: streaming mutability
# --------------------------------------------------------------------------

def stream_mutations(n: int, d: int):
    """Phase 8's mutations: (centres, the added rows V, the deleted base
    ids, the deleted added ids, the dead mask over n + adds, the old id of
    each effective-corpus row)."""
    import numpy as np

    n_add, n_del_add = STREAM_ADDS, STREAM_DELETED_ADDS
    # make_clustered's rows: its 64 centres (seed 0), fresh noise
    centers = np.random.default_rng(0).normal(size=(64, d)) \
        .astype(np.float32)
    rng = np.random.default_rng(12345)
    V = (centers[rng.integers(0, 64, n_add)] + 0.15 * rng.normal(
        size=(n_add, d)).astype(np.float32)).astype(np.float32)
    rng = np.random.default_rng(54321)
    del_base = rng.choice(n, round(0.01 * n), replace=False)
    del_add = n + rng.choice(n_add, n_del_add, replace=False)
    dead = np.zeros(n + n_add, bool)
    dead[del_base] = dead[del_add] = True
    return centers, V, del_base, del_add, dead, np.flatnonzero(~dead)


def stream_phase(ds, cfg, graph, n, d, n_queries, dev, counted,
                 check_ids) -> dict:
    """Adds, deletes, searches and a compaction on the fp32 index (plus one
    search of an int8 index with the same mutations), each held to the
    plain path and to a brute force over the effective corpus."""
    import numpy as np
    import torch

    from repro_torch.ann import Index
    from repro_torch.data.synthetic import brute_force_gt, recall_at_k

    n_add, n_del_add = STREAM_ADDS, STREAM_DELETED_ADDS
    centers, V, del_base, del_add, dead, old_ids = stream_mutations(n, d)
    n_del_base = len(del_base)
    X_eff = np.concatenate([ds.X, V])[old_ids]
    t0 = time.perf_counter()
    gt_eff = brute_force_gt(X_eff, ds.Q, 10, cfg.metric, device=dev)
    gt_old = old_ids[gt_eff]
    out: dict = dict(n_add=n_add, n_del_base=n_del_base,
                     n_del_add=n_del_add,
                     gt_s=time.perf_counter() - t0)

    def mutate(index):
        t0 = time.perf_counter()
        new = index.add(V)
        index.delete(del_base)
        index.delete(del_add)
        torch.cuda.synchronize()
        if not np.array_equal(new, n + np.arange(n_add)):
            raise AssertionError("added rows got unexpected ids")
        return time.perf_counter() - t0

    def check_stream(ids, dists, B, what, n_ids=n + n_add):
        ok = ((ids >= 0) & (ids < n_ids)) | (ids == -1)
        if ids.shape != (B, 10) or not ok.all() \
                or not np.isfinite(dists).all():
            raise AssertionError(f"bad stream output ({what})")
        # (the int8 index's 16,385th add, id n + n_add, is never deleted)
        if dead[ids[(ids >= 0) & (ids < dead.size)]].any():
            raise AssertionError(f"a deleted id was returned ({what})")
        if any(len(set(r)) != len(r) for r in ids.tolist()):
            raise AssertionError(f"duplicate ids ({what})")

    def parity(ids, ref, Q, gt, what):
        ids_t, _ = ref.search(Q)
        rec, rec_t = recall_at_k(ids, gt, 10), recall_at_k(ids_t, gt, 10)
        agree = float((ids_t == ids).mean())
        if abs(rec - rec_t) > 0.01 or agree < 0.98:
            raise AssertionError(f"{what}: kernel path and plain path "
                                 "disagree")
        return rec, rec_t, agree

    index = Index(ds.X, cfg, graph=graph, device=dev)
    ref = Index(ds.X, dataclasses.replace(cfg, kernel_backend="torch"),
                graph=graph, device=dev)
    out["mutate_s"] = mutate(index)
    mutate(ref)
    if index.n_active != n + n_add - n_del_base - n_del_add:
        raise AssertionError(f"n_active {index.n_active}")
    log(f"[stream] added {n_add}, deleted {n_del_base} base + {n_del_add} "
        f"added ids in {out['mutate_s']:.3f} s; n_active={index.n_active}; "
        f"effective-corpus ground truth {out['gt_s']:.2f} s")
    for B in (10, n_queries):
        Q = ds.Q[:B]
        counted(f"stream warm B={B}", lambda: index.search(Q))
        t0 = time.perf_counter()
        ids, dists = counted(f"stream search B={B}", lambda: index.search(Q))
        dt = time.perf_counter() - t0
        check_stream(ids, dists, B, f"B={B}")
        rec, rec_t, agree = parity(ids, ref, Q, gt_old[:B], f"stream B={B}")
        out[f"search_{B}"] = dict(regime=index.regime(B), latency_ms=dt * 1e3,
                                  qps=B / dt, recall_at_10=rec,
                                  recall_torch=rec_t, id_agreement=agree)
        log(f"[stream] B={B} regime={index.regime(B)}: latency="
            f"{dt * 1e3:.2f} ms qps={B / dt:.1f} recall@10={rec:.4f} "
            f"(effective-corpus brute force); plain path recall "
            f"{rec_t:.4f}, ids equal {agree:.4%}")

    out["profile"] = traced(f"stream search B={n_queries}",
                            lambda: index.search(ds.Q[:n_queries]))
    live_new = np.flatnonzero(~dead[n:])
    slots = np.random.default_rng(7).choice(live_new, 1024, replace=False)
    ids, _ = counted("stream self-queries",
                     lambda: index.search(V[slots]))
    hits = int((ids[:, 0] == n + slots).sum())
    out["self_rank1"] = hits
    log(f"[stream] {hits} of 1024 added rows found themselves at rank 1")
    if hits != 1024:
        raise AssertionError("an added row missed itself at rank 1")

    cfg8 = dataclasses.replace(cfg, quantization="int8")
    idx8 = Index(ds.X, cfg8, graph=graph, device=dev)
    ref8 = Index(ds.X, dataclasses.replace(cfg8, kernel_backend="torch"),
                 graph=graph, device=dev)
    mutate(idx8)
    mutate(ref8)
    Q = ds.Q[:n_queries]
    counted("stream int8 warm", lambda: idx8.search(Q))
    t0 = time.perf_counter()
    ids, dists = counted("stream int8 search", lambda: idx8.search(Q))
    dt = time.perf_counter() - t0
    check_stream(ids, dists, n_queries, "int8")
    rec, rec_t, agree = parity(ids, ref8, Q, gt_old[:n_queries],
                               "stream int8")
    out[f"int8_search_{n_queries}"] = dict(
        regime=idx8.regime(n_queries), latency_ms=dt * 1e3,
        qps=n_queries / dt, recall_at_10=rec, recall_torch=rec_t,
        id_agreement=agree)
    log(f"[stream] int8 B={n_queries}: latency={dt * 1e3:.2f} ms "
        f"recall@10={rec:.4f}; plain path recall {rec_t:.4f}, ids equal "
        f"{agree:.4%}")
    # a 16,385th add doubles the delta to 32,768 slots: the int8 scan's
    # pre-selection then selects 40 of 32,768 lanes
    rng = np.random.default_rng(6789)
    extra = (centers[rng.integers(0, 64, 1)] + 0.15 * rng.normal(
        size=(1, d)).astype(np.float32)).astype(np.float32)
    for ix in (idx8, ref8):
        if ix.add(extra).tolist() != [n + n_add]:
            raise AssertionError("the 16,385th add got an unexpected id")
    cap = idx8.engine.stream.delta.cap
    counted("stream int8 warm, wide delta", lambda: idx8.search(Q))
    t0 = time.perf_counter()
    ids, dists = counted("stream int8 search, wide delta",
                         lambda: idx8.search(Q))
    dt = time.perf_counter() - t0
    check_stream(ids, dists, n_queries, "int8, wide delta", n + n_add + 1)
    rec, rec_t, agree = parity(ids, ref8, Q, gt_old[:n_queries],
                               "stream int8, wide delta")
    out[f"int8_search_{n_queries}_cap{cap}"] = dict(
        delta_cap=cap, latency_ms=dt * 1e3, recall_at_10=rec,
        recall_torch=rec_t, id_agreement=agree)
    log(f"[stream] int8 B={n_queries}, delta capacity {cap}: latency="
        f"{dt * 1e3:.2f} ms recall@10={rec:.4f}; plain path recall "
        f"{rec_t:.4f}, ids equal {agree:.4%}")
    if cap != 2 * n_add:
        raise AssertionError(f"delta capacity {cap} after {n_add + 1} adds")
    del idx8, ref8, ref

    t0 = time.perf_counter()
    id_map = counted("compact", index.compact)
    out["compact_s"] = time.perf_counter() - t0
    want = n + n_add - n_del_base - n_del_add
    if index.generation != 1 or index.n_active != want \
            or not np.array_equal(id_map[old_ids], np.arange(want)) \
            or (id_map[dead] != -1).any():
        raise AssertionError("compaction: wrong generation, n_active or "
                             "id_map")
    log(f"[stream] compact(): {out['compact_s']:.2f} s; generation="
        f"{index.generation} n_active={index.n_active}")
    for B in (10, n_queries):
        Q = ds.Q[:B]
        t0 = time.perf_counter()
        ids, dists = counted(f"compacted search B={B}",
                             lambda: index.search(Q))
        dt = time.perf_counter() - t0
        check_ids(ids, dists, B, want, f"compacted B={B}")
        rec = recall_at_k(ids, gt_eff[:B], 10)
        out[f"compacted_search_{B}"] = dict(
            regime=index.regime(B), latency_ms=dt * 1e3, recall_at_10=rec)
        log(f"[stream] compacted B={B} regime={index.regime(B)}: latency="
            f"{dt * 1e3:.2f} ms (new shapes: the call captures its graph) "
            f"recall@10={rec:.4f}")
    return out


# --------------------------------------------------------------------------
# phase 10: serving — the engine's CUDA graphs, compaction, the queue and
# the calibrated regime split
# --------------------------------------------------------------------------

def median_ms(fn, n: int = SERVE_REPEATS) -> float:
    """Median host-clock milliseconds of ``n`` calls of ``fn``, each of
    which ends by reading its answer back (so the card is synchronised)."""
    import statistics

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def replay_vs_eager(index, Qh, label: str, *, stream: bool = False,
                    answers: dict | None = None) -> dict:
    """One batch through the engine (a replay of its captured graph) and
    through an eager call of the same search on the card, as the port
    searched before the engine captured: bit for bit equal, and the
    median untraced latency of each, a trace of one replay.  ``answers``
    keeps the replay's (ids, dists) under ``label``."""
    import numpy as np
    import torch

    plane, eng = index.plane, index.engine
    B = Qh.shape[0]
    kind, bucket = index.regime(B), eng.bucket_for(B)
    search = plane.search_stream if stream else plane.search

    def eager():
        Qp = np.pad(Qh, ((0, bucket - B), (0, 0)), mode="edge")
        ids, dists = search(kind, torch.from_numpy(Qp).to(plane.device), 10)
        return ids[:B].cpu().numpy(), dists[:B].cpu().numpy()

    before = eng.stats.compiles
    t0 = time.perf_counter()
    index.search(Qh)                        # eager warm-up + capture
    capture_s = time.perf_counter() - t0
    if eng.stats.compiles != before + 1:
        raise AssertionError(f"{label}: no graph captured")
    ids_r, d_r = index.search(Qh)
    ids_e, d_e = eager()
    if not (np.array_equal(ids_r, ids_e) and np.array_equal(d_r, d_e)):
        raise AssertionError(f"{label}: replay and eager call differ")
    if answers is not None:
        answers[label] = (ids_r, d_r)
    eager_ms = median_ms(eager)
    replay_ms = median_ms(lambda: index.search(Qh))
    prof = traced(f"{label} replay", lambda: index.search(Qh))
    out = dict(regime=kind, bucket=bucket, capture_s=capture_s,
               eager_ms=eager_ms, replay_ms=replay_ms,
               busy_share=prof["busy_share"],
               device_busy_ms=prof["device_busy_ms"], hop_ms=prof["hop_ms"],
               wall_ms_traced=prof["wall_ms"], bitwise_equal=True)
    log(f"[serve] {label} regime={kind} bucket={bucket}: replay == eager "
        f"bit for bit; median of {SERVE_REPEATS} untraced: eager "
        f"{eager_ms:.3f} ms, replay {replay_ms:.3f} ms "
        f"({eager_ms / replay_ms:.2f}x); capture {capture_s:.3f} s; traced "
        f"replay busy {prof['device_busy_ms']:.2f} ms "
        f"({prof['busy_share']:.1%})")
    return out


def serve_phase(ds, cfg, graph, n, d, n_queries, dev,
                answers: dict | None = None) -> dict:
    """Phase 10 on phase 3's graph: replays against eager calls, graph
    reuse across compactions, the micro-batching queue and the probe
    calibration with phase 8's live delta.  ``answers`` keeps each
    replay's (ids, dists) for phase 11."""
    import threading

    import numpy as np
    import torch

    from repro_torch.ann import Index, regime_for
    from repro_torch.data.synthetic import brute_force_gt, recall_at_k

    out: dict = {}
    # ---- replay against eager: fp32 / int8, none / hash, B = 10 / 10240
    for quant in ("none", "int8"):
        for visited in ("none", "hash"):
            index = Index(ds.X, dataclasses.replace(
                cfg, visited_filter=visited, quantization=quant),
                graph=graph, device=dev)
            for B in (10, n_queries):
                label = f"{quant} {visited} B={B}"
                out[label] = replay_vs_eager(index, ds.Q[:B], label,
                                             answers=answers)
            out[f"{quant} {visited} pool_bytes"] = pool = \
                index.plane.graph_pool_bytes()
            log(f"[serve] {quant} {visited}: graph pool "
                f"{pool / 2**20:.1f} MiB for "
                f"{len(index.engine._compiled)} graphs")
            del index
    _, V, del_base, del_add, dead, old_ids = stream_mutations(n, d)

    def mutate(index):
        index.add(V)
        index.delete(del_base)
        index.delete(del_add)

    index = Index(ds.X, cfg, graph=graph, device=dev)
    mutate(index)
    for B in (10, n_queries):
        label = f"stream none B={B}"
        out[label] = replay_vs_eager(index, ds.Q[:B], label, stream=True,
                                     answers=answers)
    out["stream pool_bytes"] = pool = index.plane.graph_pool_bytes()
    log(f"[serve] stream: graph pool {pool / 2**20:.1f} MiB")
    del index
    torch.cuda.empty_cache()

    # ---- compaction: same shapes keep the graphs; new shapes recapture
    index = Index(ds.X, cfg, graph=graph, device=dev)
    Qs = {B: ds.Q[:B] for B in (10, n_queries)}
    for Q in Qs.values():
        index.search(Q)                       # frozen graphs
    m = min(1024, len(del_base))
    index.add(V[:m])
    index.delete(del_base[:m])                # same shapes after compact
    for Q in Qs.values():
        index.search(Q)                       # stream graphs
    entries, compiles = len(index.engine._compiled), index.stats.compiles
    t0 = time.perf_counter()
    index.compact()
    compact_s = time.perf_counter() - t0
    first = {B: index.search(Q) for B, Q in Qs.items()}
    if index.stats.compiles != compiles \
            or len(index.engine._compiled) != entries:
        raise AssertionError("a same-shape compaction captured anew")
    fresh = Index(index.X, cfg, graph=index.graph, device=dev).plane
    for B, Q in Qs.items():
        kind, bucket = index.regime(B), index.engine.bucket_for(B)
        Qp = np.pad(Q, ((0, bucket - B), (0, 0)), mode="edge")
        want = [t[:B].cpu().numpy() for t in fresh.search(
            kind, torch.from_numpy(Qp).to(dev), 10)]
        if not (np.array_equal(first[B][0], want[0])
                and np.array_equal(first[B][1], want[1])):
            raise AssertionError(f"B={B}: the first replay after a "
                                 "compaction differs from an eager search")
    del fresh
    index.add(V[m:m + 1])                     # n + 1 rows: new shapes
    t0 = time.perf_counter()
    index.compact()
    compact2_s = time.perf_counter() - t0
    pruned = len(index.engine._compiled)
    for Q in Qs.values():
        index.search(Q)
    recaptured = index.stats.compiles - compiles
    if pruned != 0 or recaptured != 2:
        raise AssertionError(f"shape-changing compaction: {pruned} entries "
                             f"kept, {recaptured} graphs captured")
    out["compaction"] = dict(same_shape_s=compact_s, graphs_kept=entries,
                             new_shape_s=compact2_s, recaptured=recaptured)
    log(f"[serve] same-shape compaction ({m} adds, {m} base deletes): "
        f"{compact_s:.2f} s, {entries} graphs kept, 0 captured, first "
        f"replays == eager search of the new generation; a shape-changing "
        f"one ({compact2_s:.2f} s): entries pruned, {recaptured} captured")
    del index
    torch.cuda.empty_cache()

    # ---- the queue: 256 single submits from 8 threads
    index = Index(ds.X, cfg, graph=graph, device=dev)
    t0 = time.perf_counter()
    warmed = index.warmup()
    warm_s = time.perf_counter() - t0
    n_q, n_threads = 256, 8
    results: dict = {}

    def worker(t, mb):
        rows = range(t, n_q, n_threads)
        futs = [(r, mb.submit(ds.Q[r])) for r in rows]
        for r, f in futs:
            results[r] = f.result(timeout=300)[0]

    t0 = time.perf_counter()
    with index.serve() as mb:
        threads = [threading.Thread(target=worker, args=(t, mb))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    queue_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or len(results) != n_q:
        raise AssertionError("the queue left submits unanswered")
    q_ids = np.stack([results[r] for r in range(n_q)])
    batch_ids, _ = index.search(ds.Q[:n_q])
    snap = mb.stats.snapshot()
    rec_vs_batch = recall_at_k(q_ids, batch_ids, 10)
    out["queue"] = dict(
        warmup_graphs=warmed, warmup_s=warm_s, seconds=queue_s,
        n_dispatches=snap["n_dispatches"],
        mean_coalesced=snap["mean_coalesced"],
        recall_vs_batch=rec_vs_batch,
        recall_at_10=recall_at_k(q_ids, ds.gt[:n_q], 10),
        batch_recall_at_10=recall_at_k(batch_ids, ds.gt[:n_q], 10),
        compiles_after_warmup=index.stats.compiles - warmed)
    log(f"[serve] warmup captured {warmed} graphs in {warm_s:.2f} s; queue: "
        f"{n_q} single submits from {n_threads} threads in {queue_s:.3f} s, "
        f"n_dispatches={snap['n_dispatches']} mean_coalesced="
        f"{snap['mean_coalesced']:.2f}; recall@10 against the same rows "
        f"searched as one batch {rec_vs_batch:.4f} (queue "
        f"{out['queue']['recall_at_10']:.4f}, batch "
        f"{out['queue']['batch_recall_at_10']:.4f} against the ground truth)")
    if out["queue"]["compiles_after_warmup"] != 0:
        raise AssertionError("the queue captured a graph warmup did not")
    del index
    torch.cuda.empty_cache()

    # ---- calibration, and B = 10 with phase 8's live delta
    t0 = time.perf_counter()
    index = Index(ds.X, dataclasses.replace(cfg, regime_calibration="probe"),
                  graph=graph, device=dev)
    cal = index.calibration
    out["calibration"] = dict(cal.to_manifest(),
                              seconds=time.perf_counter() - t0)
    log(f"[calibrate] threshold={cal.threshold:.2f} crossover_batch="
        f"{cal.crossover_batch:.2f} degenerate={cal.degenerate} "
        f"cores={cal.cores} a={cal.a:.3f} probes (batch, s): "
        + json.dumps(cal.to_manifest()["probes"])
        + f" ({out['calibration']['seconds']:.2f} s)")
    mutate(index)
    B, Q = 10, ds.Q[:10]
    X_eff = np.concatenate([ds.X, V])[old_ids]
    gt = old_ids[brute_force_gt(X_eff, Q, 10, cfg.metric, device=dev)]
    bucket = index.engine.bucket_for(B)
    Qd = torch.from_numpy(np.pad(Q, ((0, bucket - B), (0, 0)),
                                 mode="edge")).to(dev)
    regimes = {}
    for kind in ("small", "large"):
        exe = index.plane.compile_stream(kind, bucket, 10)

        def call():
            ids, dists = exe(Qd)
            return ids[:B].cpu().numpy(), dists[:B].cpu().numpy()

        ids, _ = call()
        regimes[kind] = dict(ms=median_ms(call),
                             recall_at_10=recall_at_k(ids, gt, 10))
    n_delta = index.engine._n_delta()
    out["live_delta_B10"] = dict(
        n_delta=n_delta, regime=index.regime(B),
        static_regime=regime_for(cfg, B, n_delta=n_delta), **regimes)
    log(f"[calibrate] B=10 with a {n_delta}-row live delta takes the "
        f"{index.regime(B)} regime under the fitted threshold (the static "
        f"one: {out['live_delta_B10']['static_regime']}); median of "
        f"{SERVE_REPEATS} replays: "
        + ", ".join(f"{k} {v['ms']:.3f} ms (recall@10 {v['recall_at_10']:.4f})"
                    for k, v in regimes.items()))
    del index
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 11: the locality-packed layout and the versioned artifact
# --------------------------------------------------------------------------

def hop_layout_bench(X, Xp, quant, quant_p, graph, packed, perm, inv, Q,
                     gen) -> dict:
    """The large hop's gathers on the same neighbour rows in either order:
    node ``u``'s row of the unpacked graph against node ``inv[u]``'s row
    of the packed one (the same neighbours, packed ids), ``u`` drawn at
    random a query.  Each distance must be the same bits in either order;
    the device ms of each, timed unpacked, packed, packed, unpacked."""
    import torch

    from repro_torch.kernels import l2dist

    N = X.shape[0]
    B = Q.shape[0]
    u = torch.randint(0, N, (B,), generator=gen, device=X.device)
    idx_u = graph.neighbors[u].contiguous()
    idx_p = packed.neighbors[inv[u].long()].contiguous()
    ext_p = torch.where(idx_p < N, perm[idx_p.long().clamp(max=N - 1)],
                        idx_p)
    o_u = torch.argsort(idx_u, dim=1, stable=True)
    o_p = torch.argsort(ext_p, dim=1, stable=True)
    if not torch.equal(idx_u.gather(1, o_u), ext_p.gather(1, o_p)):
        raise AssertionError("the packed rows hold other neighbours")
    Q3 = Q[:, None, :].contiguous()
    out = {}
    for name, (Xu, Xq, sc_u, sc_p) in (
            ("gather_distances", (X, Xp, None, None)),
            ("gather_distances_int8", (quant[0], quant_p[0], quant[1],
                                       quant_p[1]))):
        def call_u():
            return l2dist.gather_distances(Q3, Xu, idx_u, idx_u < N,
                                           scales=sc_u)

        def call_p():
            return l2dist.gather_distances(Q3, Xq, idx_p, idx_p < N,
                                           scales=sc_p)

        du = call_u()[:, 0].gather(1, o_u)
        dp = call_p()[:, 0].gather(1, o_p)
        same = bool(torch.equal(du.view(torch.int32), dp.view(torch.int32)))
        times = {"u": [], "p": []}
        for tag in ("u", "p", "p", "u"):
            times[tag].append(cuda_ms(call_u if tag == "u" else call_p, 20,
                                      repeats=3, ahead=True))
        out[name] = dict(device_ms_unpacked=min(times["u"]),
                         device_ms_packed=min(times["p"]),
                         bitwise_equal=same)
        log(f"[layout] {name} hop large [{B}, 1, {idx_u.shape[1]}]: "
            f"device_ms unpacked {min(times['u']):.4f}, packed "
            f"{min(times['p']):.4f} (least of 2 each, timed u p p u); each "
            f"(query, row) distance the same bits in either order: {same}")
    out["hop_groups_coalesced"] = {
        "unpacked": span_share(idx_u, N), "packed": span_share(idx_p, N)}
    return out


def span_share(idx, n: int, G: int = 8) -> float:
    """The share of a gather's aligned G-lane groups that are one run of
    consecutive rows below ``n`` (``span_stats``' rule, for rows drawn
    from an n-row graph)."""
    import torch

    g3 = idx.long().reshape(idx.shape[0], -1, G)
    run = g3 == g3[:, :, :1] + torch.arange(G, device=idx.device)
    return float((run.all(2) & (g3 < n).all(2)).float().mean())


def equal_share(a, b, label: str, what: str, finding: str) -> dict:
    """Two (ids, dists) answers: bit for bit, or at least 99.9% of ids
    equal (then a finding that names ``finding``, or, where every
    distance is the same bits, the tie order)."""
    import numpy as np

    ids_eq = float((a[0] == b[0]).mean())
    d_eq = float((a[1].view(np.uint32) == b[1].view(np.uint32)).mean())
    if ids_eq == 1.0 and d_eq == 1.0:
        log(f"[layout] {label}: == {what} bit for bit")
    else:
        why = finding if d_eq < 1.0 else (
            "every distance the same bits: only ids at equal distances "
            "differ, which R (and the base top-k a stream merges) orders "
            "by internal id through rank_merge; the fp32 large search "
            "returns R's prefix with no merge on external ids")
        log(f"[layout] FINDING {label}: not bit for bit against {what}: "
            f"ids equal {ids_eq:.6%}, dists {d_eq:.6%} ({why})")
        if ids_eq < 0.999:
            raise AssertionError(f"{label}: ids equal {ids_eq:.4%} of "
                                 f"{what}'s, under 99.9%")
    return dict(ids_equal=ids_eq, dists_equal=d_eq)


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def layout_phase(ds, cfg, graph, n, d, n_queries, dev, answers,
                 serve) -> tuple:
    """Phase 11 on phase 3's graph: the port's locality_order and
    apply_layout, the hop's gathers in either order, the packed index
    served (bit for bit against phase 10's unpacked replays), streamed,
    compacted (at 2**17) and saved and loaded.  Returns (record, the
    launches of the packed path's run)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.ann import Index
    from repro_torch.ann import layout as L
    from repro_torch.ann.convert import graph_from_numpy
    from repro_torch.ann.quantize import quantize_rows
    from repro_torch.data.synthetic import recall_at_k

    out: dict = {}
    cfg_p = dataclasses.replace(
        cfg, build_pipeline=tuple(cfg.build_pipeline) + ("layout",))
    # ---- the layout of phase 3's graph, on the host
    t0 = time.perf_counter()
    nb, lam, deg, hubs = (t.cpu().numpy() for t in (
        graph.neighbors, graph.lambdas, graph.degrees, graph.hubs))
    fetch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    perm = L.locality_order(nb, starts=hubs)
    order_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, nb2, lam2, deg2, hubs2 = L.apply_layout(perm, ds.X, nb, lam, deg,
                                               hubs)
    apply_s = time.perf_counter() - t0
    packed = graph_from_numpy(nb2, lam2, deg2, hubs2, perm, device=dev)
    stats = {"unpacked": L.span_stats(nb), "packed": L.span_stats(nb2)}
    out.update(fetch_s=fetch_s, locality_order_s=order_s,
               apply_layout_s=apply_s, span_stats=stats)
    log(f"[layout] n={n}: locality_order {order_s:.2f} s, apply_layout "
        f"{apply_s:.2f} s (the graph to the host {fetch_s:.2f} s)")
    for tag, st in stats.items():
        log(f"[layout] span_stats {tag}: group {st['group']}, rows a copy "
            f"{st['rows_per_copy']:.4f}, groups coalesced "
            f"{st['frac_coalesced']:.4%} ({st['n_coalesced']} of "
            f"{st['n_groups']})")
    del nb, lam, deg, nb2, lam2, deg2

    # ---- the large hop's gathers, packed against unpacked
    X = torch.as_tensor(ds.X, device=dev)
    p_dev = packed.perm.long()
    inv = torch.empty_like(p_dev).scatter_(
        0, p_dev, torch.arange(n, device=dev))
    Xp = X[p_dev]
    quant = quantize_rows(X)
    quant_p = (quant[0][p_dev], quant[1][p_dev])
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    out["hop"] = hop = hop_layout_bench(
        X, Xp, quant, quant_p, graph, packed, packed.perm, inv,
        torch.as_tensor(ds.Q[:n_queries], device=dev), gen)
    log("[layout] the hop's rows, aligned groups of 8 lanes that are one "
        "run of rows: " + ", ".join(
            f"{tag} {v:.4%}" for tag, v in hop["hop_groups_coalesced"]
            .items()))
    lane_kernels = [k for k in ("gather_distances", "gather_distances_int8")
                    if not hop[k]["bitwise_equal"]]
    finding = ("per-pair distances differ by lane position in "
               + ", ".join(lane_kernels) if lane_kernels else
               "no kernel's per-pair distance moved: the hops' rank_merge "
               "orders equal distances by internal id")
    del X, Xp, quant, quant_p, inv
    torch.cuda.empty_cache()

    # ---- the packed path, with every counter at 0
    K.reset_launch_counts()
    served: dict = {}
    for quant_mode in ("none", "int8"):
        for visited in ("none", "hash"):
            index = Index(ds.X, dataclasses.replace(
                cfg_p, visited_filter=visited, quantization=quant_mode),
                graph=packed, device=dev)
            for B in (10, n_queries):
                label = f"{quant_mode} {visited} B={B}"
                served[label] = r = replay_vs_eager(
                    index, ds.Q[:B], "packed " + label, answers=answers)
                r.update(equal_share(answers["packed " + label],
                                     answers[label], "packed " + label,
                                     "phase 10's unpacked replay", finding))
                if B == n_queries:
                    hop = "gather_row8_kernel" if quant_mode == "int8" \
                        else "gather_rowq_kernel"
                    log(f"[layout] {label}: traced replay busy "
                        f"{r['device_busy_ms']:.2f} ms packed, "
                        f"{serve[label]['device_busy_ms']:.2f} ms unpacked"
                        f" (phase 10), {hop} {r['hop_ms'][hop]:.2f} / "
                        f"{serve[label]['hop_ms'][hop]:.2f} ms; median "
                        f"replay {r['replay_ms']:.3f} ms packed, "
                        f"{serve[label]['replay_ms']:.3f} ms unpacked")
            del index
            torch.cuda.empty_cache()
    out["serve"] = served

    # ---- a stream on the packed fp32 index (phase 8's mutations)
    _, V, del_base, del_add, dead, _ = stream_mutations(n, d)
    index = Index(ds.X, cfg_p, graph=packed, device=dev)
    new = index.add(V)
    index.delete(del_base)
    index.delete(del_add)
    stream = {}
    for B in (10, n_queries):
        label = f"stream none B={B}"
        stream[label] = r = replay_vs_eager(
            index, ds.Q[:B], "packed " + label, stream=True,
            answers=answers)
        r.update(equal_share(answers["packed " + label], answers[label],
                             "packed " + label,
                             "phase 10's unpacked replay", finding))
        ids = answers["packed " + label][0]
        if dead[ids[(ids >= 0) & (ids < dead.size)]].any():
            raise AssertionError(f"packed {label}: a deleted id returned")
    live = np.flatnonzero(~dead[n:])
    first = []
    for lo in range(0, len(live), n_queries):   # one captured bucket
        rows = live[lo:lo + n_queries]
        Qv = V[np.pad(rows, (0, n_queries - len(rows)), mode="edge")]
        first.append(index.search(Qv)[0][:len(rows), 0])
    found = float((np.concatenate(first) == new[live]).mean())
    stream["live_adds_at_rank_1"] = found
    log(f"[layout] packed stream: {len(new)} adds, {len(del_base)} base "
        f"and {len(del_add)} added ids deleted; no deleted id returned; "
        f"live added rows found at rank 1: {found:.4%}")
    if found != 1.0:
        raise AssertionError("a live added row missed rank 1 on the "
                             "packed index")
    out["stream"] = stream
    del index
    torch.cuda.empty_cache()

    # ---- a packed compaction, at 2**17 rows (same shapes: graphs kept)
    n_c = min(n, 1 << 17)
    Xc = ds.X[:n_c]
    t0 = time.perf_counter()
    index = Index.build(Xc, cfg_p, device=dev)
    build_c_s = time.perf_counter() - t0
    Qc = {B: ds.Q[:B] for B in (10, n_queries)}
    for Q in Qc.values():
        index.search(Q)
    m = 1024
    gone = np.arange(0, n_c, n_c // m)[:m]
    index.delete(gone)
    added = index.add(V[:m])
    for Q in Qc.values():
        index.search(Q)
    entries, compiles = len(index.engine._compiled), index.stats.compiles
    perm_buf = index.graph.perm
    t0 = time.perf_counter()
    id_map = index.compact()
    compact_s = time.perf_counter() - t0
    if index.stats.compiles != compiles or index.graph.perm is not perm_buf \
            or len(index.engine._compiled) != entries:
        raise AssertionError("a same-shape packed compaction captured anew")
    if (id_map[gone] != -1).any() or index.graph.perm is None:
        raise AssertionError("packed compaction: id_map or perm wrong")
    fresh = Index(index.X, cfg_p, graph=index.graph, device=dev,
                  packed=True).plane
    for B, Q in Qc.items():
        got = index.search(Q)
        kind, bucket = index.regime(B), index.engine.bucket_for(B)
        Qp = np.pad(Q, ((0, bucket - B), (0, 0)), mode="edge")
        want = [t[:B].cpu().numpy() for t in fresh.search(
            kind, torch.from_numpy(Qp).to(dev), 10)]
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError(f"packed compaction B={B}: the first "
                                 "replay differs from an eager search")
    if not (id_map[added] == n_c - m + np.arange(m)).all():
        raise AssertionError("packed compaction: added rows renumbered "
                             "out of order")
    out["compaction"] = dict(n=n_c, build_s=build_c_s,
                             build_stage_s=dict(index.build_seconds),
                             compact_s=compact_s, graphs_kept=entries)
    log(f"[layout] packed compaction at n={n_c}: build {build_c_s:.2f} s ("
        + " ".join(f"{k}={v:.2f}s" for k, v in index.build_seconds.items())
        + f"); {m} deletes + {m} adds compacted in {compact_s:.2f} s "
        f"(rebuild and layout), {entries} graphs kept, perm copied into "
        "its buffer; first replays == eager search of the new generation; "
        "id_map external")
    del index, fresh
    torch.cuda.empty_cache()

    # ---- save and load the packed int8 index with a live stream
    index = Index(ds.X, dataclasses.replace(cfg_p, quantization="int8"),
                  graph=packed, device=dev)
    index.add(V)
    index.delete(del_base)
    index.delete(del_add)
    for B in (10, n_queries):
        index.search(ds.Q[:B])                # capture
    before = {B: index.search(ds.Q[:B]) for B in (10, n_queries)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(path)
        del index
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded = Index.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    for B, (ids, dists) in before.items():
        for _ in range(2):                    # capture, then a replay
            got = loaded.search(ds.Q[:B])
        if not (np.array_equal(got[0], ids)
                and np.array_equal(got[1], dists)):
            raise AssertionError(f"loaded index B={B}: replays differ from "
                                 "the saved index's")
    rec = recall_at_k(before[10][0], ds.gt[:10], 10)
    out["artifact"] = dict(save_s=save_s, load_s=load_s, bytes=nbytes,
                           stream_count=loaded.engine.stream.delta.count)
    log(f"[layout] artifact (packed int8, live stream of "
        f"{loaded.engine.stream.delta.count} adds): save {save_s:.2f} s, "
        f"load {load_s:.2f} s, {nbytes} bytes ({nbytes / 2**20:.1f} MiB); "
        f"the loaded index's replays == the saved index's bit for bit "
        f"(B=10 recall@10 {rec:.4f})")
    del loaded
    torch.cuda.empty_cache()
    return out, K.launch_counts()


# --------------------------------------------------------------------------
# phase 12: the sharded index — the mesh plane, bf16 rows, the shard-major
# artifact and the router
# --------------------------------------------------------------------------

def check_bf16_body(ds, cfg, n_queries, dev, gen) -> list:
    """The bf16 row body against its plain version at the large hop's
    shape [B, 1, 32] and the seeds' [B, 1, 128], on the corpus in bf16,
    within 1e-5 * (qn + xn) of its upcast rows."""
    import torch

    Xb = torch.from_numpy(ds.X).to(dev).to(torch.bfloat16)
    xn = (Xb.double() ** 2).sum(1)
    rows = [check_gather(Xb, xn, name, n_queries, 1, C, False, gen,
                         bf16=True)
            for name, C in (("hop large", cfg.max_degree),
                            ("seeds large", cfg.large_n_seeds))]
    del Xb, xn
    return rows


def mesh_search(index, Qh, label: str, single_recall, gt, ref=None,
                repeats: int = MESH_REPEATS) -> tuple:
    """One batch through a mesh index: the first search captures its
    graph, the next replays it, equal to an eager call of the same search
    bit for bit; its recall beside the single index's, the median of
    ``repeats`` replays and, with ``ref`` (the same sub-indexes on the
    plain path), recall within 0.01 and ids equal on >= 98%."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import recall_at_k

    plane, eng = index.plane, index.engine
    B = Qh.shape[0]
    kind, bucket = index.regime(B), eng.bucket_for(B)
    Qd = torch.from_numpy(np.pad(Qh, ((0, bucket - B), (0, 0)),
                                 mode="edge")).to(plane.device)
    stream = plane.stream_active
    t0 = time.perf_counter()
    index.search(Qh)                        # eager warm-up + capture
    capture_s = time.perf_counter() - t0
    ids, dists = index.search(Qh)
    search = plane.search_stream if stream else plane.search
    want = [t[:B].cpu().numpy() for t in search(kind, Qd, 10)]
    if not (np.array_equal(ids, want[0]) and np.array_equal(dists, want[1])):
        raise AssertionError(f"{label}: replay and eager call differ")
    rec = recall_at_k(ids, gt, 10)
    r = dict(regime=kind, bucket=bucket, capture_s=capture_s,
             recall_at_10=rec, single_recall=single_recall,
             replay_ms=median_ms(lambda: index.search(Qh), repeats),
             replay_equals_eager=True)
    extra = ""
    if ref is not None:
        ids_t = ref.plane.search(kind, Qd, 10)[0][:B].cpu().numpy()
        r.update(recall_torch=recall_at_k(ids_t, gt, 10),
                 id_agreement=float((ids_t == ids).mean()))
        extra = (f"; plain path recall {r['recall_torch']:.4f}, ids equal "
                 f"{r['id_agreement']:.4%}")
        if abs(rec - r["recall_torch"]) > 0.01 or r["id_agreement"] < 0.98:
            raise AssertionError(f"{label}: kernel path and plain path "
                                 "disagree")
    log(f"[mesh] {label} regime={kind} bucket={bucket}: replay == eager "
        f"bit for bit; recall@10 {rec:.4f} (single index "
        + ("-" if single_recall is None else f"{single_recall:.4f}")
        + f"); median of {repeats} replays {r['replay_ms']:.3f} ms; capture "
        f"{capture_s:.3f} s{extra}")
    return r, ids, dists


def mesh_phase(ds, cfg, graph, n, d, n_queries, dev, answers,
               record) -> tuple:
    """Phase 12 on phase 3's corpus, with every counter at 0: the (4, 2)
    grid's build and searches, the model axis against phase 10's replays,
    db_bf16, a stream and its compaction, the shard-major artifact and the
    router.  Returns (results, the phase's launch counts)."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.ann import Index
    from repro_torch.core import distributed as D
    from repro_torch.data.synthetic import brute_force_gt, recall_at_k
    from repro_torch.serve.plane import MeshPlane, shard_layout

    out: dict = {"seconds": {}}
    clock = [None, time.perf_counter()]

    def step(tag):
        """Close the running step's wall seconds, open ``tag``'s."""
        now = time.perf_counter()
        if clock[0] is not None:
            out["seconds"][clock[0]] = now - clock[1]
        clock[:] = [tag, now]

    K.reset_launch_counts()
    names = ("data", "model")
    mesh = D.make_mesh(MESH_SHAPE, names, device=dev)

    # ---- (a) the build, then fp32 / int8 x none / hash on its shards
    step("a")
    t0 = time.perf_counter()
    base = Index.build(ds.X, cfg, mesh=mesh)
    build_s = time.perf_counter() - t0
    out["build_s"], out["build_stage_s"] = build_s, base.build_seconds
    log(f"[mesh] Index.build on a {MESH_SHAPE} grid ({D.n_db_shards(mesh)} "
        f"DB shards of {n // D.n_db_shards(mesh)} rows, "
        f"{D.n_query_shards(mesh)} query columns): {build_s:.2f} s; "
        + "; ".join(f"{s}: " + " ".join(f"{k}={v:.2f}s" for k, v in t.items())
                    for s, t in base.build_seconds.items()))
    g = base.graph
    parts = (base.X, g.neighbors, g.lambdas, g.degrees, g.hubs)

    def on_mesh(knobs, m=mesh, p=None):
        c = dataclasses.replace(cfg, **knobs)
        return Index(None, c, plane=MeshPlane(None, c, m,
                                              parts=p or parts))

    Qs = {B: ds.Q[:B] for B in (10, n_queries)}
    gts = {B: ds.gt[:B] for B in Qs}
    searches: dict = {}
    for quant in ("none", "int8"):
        for visited in ("none", "hash"):
            knobs = dict(quantization=quant, visited_filter=visited)
            index = base if knobs == dict(quantization="none",
                                          visited_filter="none") \
                else on_mesh(knobs)
            ref = on_mesh(dict(knobs, kernel_backend="torch"))
            for B, Q in Qs.items():
                label = f"{quant} {visited} B={B}"
                single = record.get(
                    f"search_{visited}_{B}" if quant == "none"
                    else f"int8_{visited}_{B}", {}).get("recall_at_10")
                searches[label], _, _ = mesh_search(index, Q, label, single,
                                                    gts[B], ref=ref)
            pool = index.plane.graph_pool_bytes()
            searches[f"{quant} {visited} pool_bytes"] = pool
            log(f"[mesh] {quant} {visited}: graph pool {pool / 2**20:.1f} "
                f"MiB for {len(index.engine._compiled)} graphs of "
                f"{int(np.prod(MESH_SHAPE))} cells each")
            del ref
            if index is not base:
                del index
            torch.cuda.empty_cache()
    out["searches"] = searches

    # ---- (b) the model axis is invisible: (1, 2) over phase 3's graph
    step("b")
    X_dev = torch.from_numpy(ds.X).to(dev)
    one = (X_dev, graph.neighbors, graph.lambdas, graph.degrees, graph.hubs)
    invisible = {}
    for visited in ("none", "hash"):
        index = on_mesh(dict(visited_filter=visited),
                        D.make_mesh((1, 2), names, device=dev), one)
        for B, Q in Qs.items():
            label = f"none {visited} B={B}"
            index.search(Q)                    # capture
            got = index.search(Q)
            want = answers[label]
            same = bool(np.array_equal(got[0], want[0])
                        and np.array_equal(got[1], want[1]))
            invisible[label] = same
            log(f"[mesh] (1, 2) grid over phase 3's graph, {label}: "
                + ("== phase 10's single-plane replay bit for bit" if same
                   else "DIFFERS from phase 10's single-plane replay"))
            if not same:
                raise AssertionError(f"(1, 2) grid {label}: the model axis "
                                     "is visible")
        del index
        torch.cuda.empty_cache()
    out["model_axis_invisible"] = invisible
    del one, X_dev

    # ---- (c) db_bf16 on the (4, 2) grid
    step("c")
    index = on_mesh(dict(db_bf16=True))
    bf16 = {}
    for B, Q in Qs.items():
        label = f"bf16 none B={B}"
        bf16[label], _, _ = mesh_search(
            index, Q, label, searches[f"none none B={B}"]["recall_at_10"],
            gts[B])
    out["bf16"] = bf16
    del index
    torch.cuda.empty_cache()

    # ---- (d) a stream on the grid: phase 8's mutations, then compact()
    step("d")
    _, V, del_base, del_add, dead, old_ids = mesh_mutations(n, d)

    def mutate(index):
        new = index.add(V)
        index.delete(del_base)
        index.delete(del_add)
        return new

    index = on_mesh({})
    new = mutate(index)
    X_eff = np.concatenate([ds.X, V])[old_ids]
    stream = {}
    for B, Q in Qs.items():
        label = f"stream none B={B}"
        gt = old_ids[brute_force_gt(X_eff, Q, 10, cfg.metric, device=dev)]
        stream[label], ids, _ = mesh_search(index, Q, label, None, gt)
        if dead[ids[(ids >= 0) & (ids < dead.size)]].any():
            raise AssertionError(f"mesh {label}: a deleted id returned")
    live = np.flatnonzero(~dead[n:])
    first = []
    for lo in range(0, len(live), n_queries):   # one captured bucket
        rows = live[lo:lo + n_queries]
        Qv = V[np.pad(rows, (0, n_queries - len(rows)), mode="edge")]
        first.append(index.search(Qv)[0][:len(rows), 0])
    found = float((np.concatenate(first) == new[live]).mean())
    stream["live_adds_at_rank_1"] = found
    log(f"[mesh] stream: {len(new)} adds, {len(del_base)} base and "
        f"{len(del_add)} added ids deleted; no deleted id returned; live "
        f"added rows found at rank 1: {found:.4%}")
    if found != 1.0:
        raise AssertionError("a live added row missed rank 1 on the mesh")
    t0 = time.perf_counter()
    id_map = index.compact()
    compact_s = time.perf_counter() - t0
    if (id_map[np.flatnonzero(dead)] != -1).any() \
            or not (id_map[old_ids] == np.arange(len(old_ids))).all():
        raise AssertionError("mesh compaction: id_map wrong")
    Q = ds.Q[:n_queries]
    ids, dists = index.search(Q)
    gt = brute_force_gt(X_eff, Q, 10, cfg.metric, device=dev)
    if not ((ids >= 0) & (ids < len(old_ids))).all() \
            or not np.isfinite(dists).all():
        raise AssertionError("mesh compaction: bad answers")
    stream["compaction"] = dict(
        seconds=compact_s, n=len(old_ids),
        recall_at_10=recall_at_k(ids, gt, 10),
        build_stage_s=index.plane.build_seconds)
    log(f"[mesh] compact() on the grid: {len(old_ids)} rows rebuilt over "
        f"{D.n_db_shards(mesh)} shards in {compact_s:.2f} s; B={n_queries} "
        f"of the new generation recall@10 "
        f"{stream['compaction']['recall_at_10']:.4f} against a brute force "
        "over the effective corpus")
    out["stream"] = stream
    del index
    torch.cuda.empty_cache()

    # ---- (e) the shard-major artifact: packed int8 with a live stream
    step("e")
    t0 = time.perf_counter()
    packed, layout_s = shard_layout(parts[0], parts[1:], D.n_db_shards(mesh))
    pack_s = time.perf_counter() - t0
    index = on_mesh(dict(quantization="int8", build_pipeline=LAYOUT_PIPE),
                    p=packed)
    mutate(index)
    for Q in Qs.values():
        index.search(Q)                        # capture
    before = {B: index.search(Q) for B, Q in Qs.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(path)
        del index
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded = Index.load(path, mesh=mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    for B, (ids, dists) in before.items():
        for _ in range(2):                    # capture, then a replay
            got = loaded.search(Qs[B])
        if not (np.array_equal(got[0], ids)
                and np.array_equal(got[1], dists)):
            raise AssertionError(f"loaded mesh index B={B}: replays differ "
                                 "from the saved index's")
        if dead[ids[(ids >= 0) & (ids < dead.size)]].any():
            raise AssertionError(f"loaded mesh index B={B}: a deleted id "
                                 "returned")
    out["artifact"] = dict(layout_s=layout_s, pack_s=pack_s, save_s=save_s,
                           load_s=load_s, bytes=nbytes)
    log(f"[mesh] shard-major artifact (packed int8, "
        f"{D.n_db_shards(mesh)} shards, a live stream of "
        f"{loaded.engine.stream.delta.count} adds): per-shard layout "
        + " ".join(f"{t:.2f}s" for t in layout_s)
        + f"; save {save_s:.2f} s, load {load_s:.2f} s, {nbytes} bytes "
        f"({nbytes / 2**20:.1f} MiB); the loaded index's replays == the "
        "saved index's bit for bit")
    del loaded, packed
    torch.cuda.empty_cache()

    # ---- (f) the router: sharded against a (4, 1) grid, replicated
    step("f")
    router: dict = {}
    single = Index(ds.X, cfg, graph=graph, device=dev)
    t0 = time.perf_counter()
    with single.serve(router=f"sharded:{D.n_db_shards(mesh)}") as r:
        router["sharded_build_s"] = time.perf_counter() - t0
        grid = on_mesh({}, D.make_mesh((D.n_db_shards(mesh), 1), names,
                                       device=dev))
        for B, Q in Qs.items():
            got, want = routed(r, Q), grid.search(Q)
            if not (np.array_equal(got[0], want[0])
                    and np.array_equal(got[1], want[1])):
                raise AssertionError(f"sharded router B={B} differs from "
                                     "the grid")
        del grid
    log(f"[router] sharded:{D.n_db_shards(mesh)} (its shard engines built "
        f"in {router['sharded_build_s']:.2f} s) == a "
        f"({D.n_db_shards(mesh)}, 1) grid over the same shards bit for bit "
        f"at B = " + " and ".join(str(B) for B in Qs))
    del single
    torch.cuda.empty_cache()
    base.warmup()
    n_q, n_threads = 256, 8
    results: dict = {}

    def worker(t, rt):
        futs = [(i, rt.submit(ds.Q[i])) for i in range(t, n_q, n_threads)]
        for i, f in futs:
            results[i] = f.result(timeout=300)[0]

    with base.serve(router="replicated:2") as r:
        for B, Q in Qs.items():
            got, want = routed(r, Q), base.search(Q)
            if not (np.array_equal(got[0], want[0])
                    and np.array_equal(got[1], want[1])):
                raise AssertionError(f"replicated router B={B} differs "
                                     "from its donor")
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(t, r))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        router["submits_s"] = time.perf_counter() - t0
        snap = r.snapshot()
    rt = snap["router"]
    if any(t.is_alive() for t in threads) or len(results) != n_q \
            or rt["retries"] or rt["lost_futures"]:
        raise AssertionError(f"router: {len(results)} of {n_q} answered, "
                             f"retries {rt['retries']}, lost "
                             f"{rt['lost_futures']}")
    q_ids = np.stack([results[i] for i in range(n_q)])
    router.update(rt, recall_at_10=recall_at_k(q_ids, ds.gt[:n_q], 10),
                  compiles=snap["aggregate"]["compiles"])
    log(f"[router] replicated:2 over the {MESH_SHAPE} grid == its donor bit "
        f"for bit; {n_q} single submits from {n_threads} threads in "
        f"{router['submits_s']:.3f} s: {rt['n_requests']} requests, "
        f"{rt['n_dispatches']} dispatches, retries {rt['retries']}, lost "
        f"futures {rt['lost_futures']}, graphs captured by the replicas "
        f"{router['compiles']}, recall@10 {router['recall_at_10']:.4f}")
    out["router"] = router
    del base
    torch.cuda.empty_cache()
    step(None)
    log("[mesh] phase 12 seconds by step (a build and searches, b the "
        "model axis, c bf16, d stream and compaction, e artifact, f "
        "router): " + json.dumps({k: round(v, 2)
                                 for k, v in out["seconds"].items()}))
    return out, K.launch_counts()


def routed(r, Q):
    """``r.query(Q)``; on a failure, each endpoint's last error is logged
    before the failure is raised again."""
    try:
        return r.query(Q, timeout=600)
    except Exception:
        log("[router] endpoint errors: " + json.dumps(
            {k: v["last_error"] for k, v in r.snapshot()["replicas"].items()}))
        raise


def mesh_mutations(n: int, d: int):
    """Phase 8's mutations, with as many fewer base deletes (0-3) as make
    the effective corpus split evenly over the grid's DB shards (so it
    compacts on the grid)."""
    import numpy as np

    centers, V, del_base, del_add, _, _ = stream_mutations(n, d)
    shards = MESH_SHAPE[0]
    n_eff = n - len(del_base) + len(V) - len(del_add)
    del_base = del_base[:len(del_base) - (-n_eff) % shards]
    dead = np.zeros(n + len(V), bool)
    dead[del_base] = dead[del_add] = True
    return centers, V, del_base, del_add, dead, np.flatnonzero(~dead)


# --------------------------------------------------------------------------
# phase 13: the pod (serve/pod.py over torch.distributed) and the serving
# drivers (the launcher and the six examples)
# --------------------------------------------------------------------------

POD_SHARDS = 4                # (b): phase 12's 4 DB shards, 2 a rank
POD_RANKS = 2
POD_TIMEOUT = 600             # seconds the two ranks may take in all
POD_VARIANTS = (("fp32 none", {}), ("fp32 hash", {"visited_filter": "hash"}),
                ("int8 none", {"quantization": "int8"}))
# (c): the examples at their CI sizes (scripts/ci.sh); ann_serving and
# recsys_retrieval (100,000 item vectors) at their own defaults
EXAMPLES = {"quickstart": ({"REPRO_QUICKSTART_N": "4000"}, "quickstart OK"),
            "ann_serving": ({}, "ann_serving OK"),
            "streaming_ingest": ({"REPRO_STREAMING_N": "3000"},
                                 "streaming_ingest OK"),
            "distributed_search": ({}, "distributed_search OK"),
            "pod_serving": ({"REPRO_POD_N": "3000"}, "pod serving demo OK"),
            "recsys_retrieval": ({}, "recsys_retrieval OK")}
DRIVER_TIMEOUT = 600


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def pod_mutations(n: int, d: int):
    """(b)'s stream round: 2,048 rows like the corpus added, 512 base ids
    and every 8th added id deleted."""
    import numpy as np

    rng = np.random.default_rng(23)
    V = rng.normal(size=(2048, d)).astype(np.float32)
    return V, rng.choice(n, 512, replace=False), np.arange(0, 2048, 8)


def pod_rank(rank: int, tmp: str, port: int, n_queries: int,
             device: str) -> None:
    """(b)'s rank body (a spawned process): join the gloo pod, build this
    rank's 2 of the 4 shards, save the artifact SPMD and load it back,
    then serve fp32 / int8 x none / hash at B = 10 and ``n_queries``
    (replay against eager, medians of 10 replays) and a stream round;
    the answers, seconds and launch counts go to ``tmp``.  ``device``
    is the card (a CPU rehearsal passes "cpu")."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.ann import Index
    from repro_torch.configs.base import ANNConfig
    from repro_torch.core import distributed as D
    from repro_torch.serve import pod

    pod.init_pod(f"tcp://localhost:{port}", world_size=POD_RANKS, rank=rank,
                 backend="gloo", device=device)
    X = np.load(os.path.join(tmp, "X.npy"))
    Q = np.load(os.path.join(tmp, "Q.npy"))
    cfg = ANNConfig()
    mesh = D.make_mesh((POD_SHARDS,), ("data",), device=device)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" \
        else (lambda: None)
    K.reset_launch_counts()
    rec: dict = {"seconds": {}, "replay_ms": {}}
    answers: dict = {}
    t0 = time.perf_counter()
    base = Index(None, cfg, plane=pod.PodPlane(X, cfg, mesh))
    sync()
    rec["seconds"]["build"] = time.perf_counter() - t0
    path = os.path.join(tmp, "pod_ix")
    t0 = time.perf_counter()
    base.save(path)
    rec["seconds"]["save"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = Index.load(path, mesh=mesh)
    sync()
    rec["seconds"]["load"] = time.perf_counter() - t0
    rec["loaded_plane"] = loaded.plane.name
    plane = base.plane
    local = (plane.X, plane.graph.neighbors, plane.graph.lambdas,
             plane.graph.degrees, plane._ops[4])
    for name, knobs in POD_VARIANTS:
        c = dataclasses.replace(cfg, **knobs)
        index = base if not knobs else Index(
            None, c, plane=pod.PodPlane(None, c, mesh, parts=local,
                                        local=True))
        for B in (10, n_queries):
            label = f"{name} B={B}"
            kind, bucket = index.regime(B), index.engine.bucket_for(B)
            index.search(Q[:B])                   # eager warm-up + capture
            before = index.stats.compiles
            ids, dists = index.search(Q[:B])
            if index.stats.compiles != before:
                raise AssertionError(f"pod {label}: a repeated bucket "
                                     "captured")
            Qp = torch.from_numpy(np.pad(Q[:B], ((0, bucket - B), (0, 0)),
                                         mode="edge")).to(plane.device)
            eager = index.plane.search(kind, Qp, 10)
            if not (np.array_equal(ids, eager[0][:B].cpu().numpy())
                    and np.array_equal(dists, eager[1][:B].cpu().numpy())):
                raise AssertionError(f"pod rank {rank} {label}: replay and "
                                     "eager call differ")
            rec["replay_ms"][label] = median_ms(lambda: index.search(Q[:B]))
            answers[f"{label} ids"], answers[f"{label} dists"] = ids, dists
            if name == "fp32 none":
                got = loaded.search(Q[:B])
                if not (np.array_equal(got[0], ids)
                        and np.array_equal(got[1], dists)):
                    raise AssertionError(f"pod rank {rank} {label}: the "
                                         "reloaded pod answers otherwise")
        if index is not base:
            del index
            torch.cuda.empty_cache()
    del loaded
    V, del_base, del_add = pod_mutations(X.shape[0], X.shape[1])
    for name, knobs in (("fp32 none", {}), ("int8 none",
                                            {"quantization": "int8"})):
        c = dataclasses.replace(cfg, **knobs)
        index = base if not knobs else Index(
            None, c, plane=pod.PodPlane(None, c, mesh, parts=local,
                                        local=True))
        new = index.add(V)
        index.delete(del_base)
        index.delete(new[del_add])
        for B in ((10, n_queries) if name == "fp32 none" else (10,)):
            label = f"stream {name} B={B}"
            index.search(Q[:B])                   # capture
            ids, dists = index.search(Q[:B])
            answers[f"{label} ids"], answers[f"{label} dists"] = ids, dists
    rec["launches"] = K.launch_counts()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **answers)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    pod.close_pod()


def run_pod_ranks(tmp: str, n_queries: int, device: str) -> None:
    """Spawn the two ranks and wait for both, within ``POD_TIMEOUT``; a
    rank that fails, or a pod that hangs, fails the phase."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(pod_rank,
                             args=(tmp, free_port(), n_queries, device),
                             nprocs=POD_RANKS, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + POD_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise AssertionError(f"the pod's ranks took over "
                                     f"{POD_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def start_drivers(n: int, d: int, tmp: str, dev) -> dict:
    """(c): the launcher's chaos drill at full size and the six examples
    at their CI sizes, each a subprocess, all started together, on the
    card (a CPU rehearsal passes ``--device cpu``).  A thread a driver
    waits for its exit: :func:`finish_drivers` collects them."""
    import threading

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    where = [] if dev.type == "cuda" else ["--device", "cpu"]
    cmds = {"launcher": ([sys.executable, "-m", "repro_torch.launch.serve",
                          "--n", str(n), "--d", str(d), "--router",
                          "replicated:2", "--kill-replica", "1",
                          "--health-interval", "0.2", *where], env)}
    for name, (knobs, _) in EXAMPLES.items():
        cmds[name] = ([sys.executable, os.path.join(
            HERE, "examples", "torch", f"{name}.py"), *where],
            dict(env, **knobs))
    started = time.perf_counter()
    runs = {"procs": {}, "threads": [], "out": {}, "started": started}

    def wait(name, p):
        text = p.communicate()[0]
        runs["out"][name] = (p.returncode, text,
                             time.perf_counter() - started)

    for name, (cmd, cmd_env) in cmds.items():
        p = runs["procs"][name] = subprocess.Popen(
            cmd, cwd=tmp, env=cmd_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        t = threading.Thread(target=wait, args=(name, p), daemon=True)
        t.start()
        runs["threads"].append(t)
    return runs


def stop_drivers(runs: dict) -> None:
    for p in runs["procs"].values():
        p.kill()


def finish_drivers(runs: dict) -> dict:
    """Each driver's (exit code, output, seconds from the start to its
    exit), waiting at most ``DRIVER_TIMEOUT`` seconds from the start; the
    ones still running then are killed and fail the phase."""
    for t in runs["threads"]:
        t.join(timeout=max(1.0, DRIVER_TIMEOUT
                           - (time.perf_counter() - runs["started"])))
    stop_drivers(runs)
    late = [name for name in runs["procs"] if name not in runs["out"]]
    if late:
        raise AssertionError(f"drivers still running after "
                             f"{DRIVER_TIMEOUT} s: {late}")
    return runs["out"]


def pod_phase(ds, cfg, graph, n, d, n_queries, dev, answers,
              record) -> tuple:
    """Phase 13: (a) a 1-rank NCCL pod over phase 3's graph against phase
    10's single-plane replays; (b) two ranks on the card over gloo, each
    with 2 of phase 12's 4 shards of 2^18 rows, against the (4, 1) grid
    over the same shards, and the pod artifact; (c) the launcher's chaos
    drill at full size and the six examples.  Returns (results, the
    launches of the pod's path: (a)'s and both ranks')."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.ann import Index
    from repro_torch.configs.base import ANNConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.synthetic import make_clustered, recall_at_k
    from repro_torch.serve import pod
    from repro_torch.serve.plane import MeshPlane

    out: dict = {"seconds": {}}
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    # ---- (a) a 1-rank NCCL pod over phase 3's graph
    t0 = time.perf_counter()
    K.reset_launch_counts()
    pod.init_pod(f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                 device=dev)                        # NCCL on the card
    backend = torch.distributed.get_backend()
    X_dev = torch.from_numpy(ds.X).to(dev)
    parts = (X_dev, graph.neighbors, graph.lambdas, graph.degrees,
             graph.hubs)
    one = {}
    for visited in ("none", "hash"):
        c = dataclasses.replace(cfg, visited_filter=visited)
        index = Index(None, c, plane=pod.PodPlane(None, c, parts=parts))
        for B in (10, n_queries):
            label = f"none {visited} B={B}"
            Q = ds.Q[:B]
            index.search(Q)                       # capture
            got = index.search(Q)
            want = answers[label]
            if not (np.array_equal(got[0], want[0])
                    and np.array_equal(got[1], want[1])):
                raise AssertionError(f"1-rank {backend} pod {label}: "
                                     "differs from phase 10's single-plane "
                                     "replay")
            one[label] = dict(
                replay_ms=median_ms(lambda: index.search(Q)),
                single_replay_ms=record["serve"][label]["replay_ms"])
            log(f"[pod] 1-rank {backend} pod over phase 3's graph, {label}: "
                f"== phase 10's single-plane replay bit for bit; median of "
                f"{SERVE_REPEATS} replays {one[label]['replay_ms']:.3f} ms "
                f"(phase 10's single plane "
                f"{one[label]['single_replay_ms']:.3f} ms)")
        del index
    del X_dev, parts
    launches = K.launch_counts()
    pod.close_pod()
    torch.cuda.empty_cache()
    out["one_rank_nccl"] = one
    out["seconds"]["a"] = time.perf_counter() - t0

    # ---- (b) two ranks on the one card over gloo, 2 of 4 shards each
    t0 = time.perf_counter()
    np.save(os.path.join(tmp, "X.npy"), ds.X)
    np.save(os.path.join(tmp, "Q.npy"), ds.Q[:n_queries])
    run_pod_ranks(tmp, n_queries, str(dev))
    out["seconds"]["b ranks"] = time.perf_counter() - t0
    ranks = []
    for r in range(POD_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            rec = json.load(f)
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            rec["answers"] = {k: z[k] for k in z.files}
        ranks.append(rec)
        for k, v in rec["launches"].items():
            launches[k] += v
    a0, a1 = ranks[0]["answers"], ranks[1]["answers"]
    if a0.keys() != a1.keys() or any(a0[k].tobytes() != a1[k].tobytes()
                                     for k in a0):
        raise AssertionError("the pod's ranks answered differently")
    path = os.path.join(tmp, "pod_ix")
    man = json.load(open(os.path.join(path, "manifest.json")))
    if man["plane"] != "pod" or man["topology"]["n_processes"] != POD_RANKS \
            or man["topology"]["n_db_shards"] != POD_SHARDS \
            or any(rec["loaded_plane"] != "pod" for rec in ranks):
        raise AssertionError(f"pod artifact: {man['topology']}")
    mesh = D.make_mesh((POD_SHARDS, 1), ("data", "model"), device=dev)
    grid = Index.load(path, mesh=mesh)
    gp = grid.plane
    gparts = (gp.X, gp.graph.neighbors, gp.graph.lambdas, gp.graph.degrees,
              gp._ops[4])
    grid_ms = {}
    for B in (10, n_queries):                # timed alone, before (c)
        grid.search(ds.Q[:B])                     # capture
        grid_ms[f"fp32 none B={B}"] = median_ms(
            lambda: grid.search(ds.Q[:B]))
    # (c)'s drivers start now and run beside the untimed comparisons
    drivers_run = start_drivers(n, d, tmp, dev)
    try:
        for name, knobs in POD_VARIANTS:
            c = dataclasses.replace(cfg, **knobs)
            index = grid if not knobs else Index(
                None, c, plane=MeshPlane(None, c, mesh, parts=gparts))
            for B in (10, n_queries):
                label = f"{name} B={B}"
                index.search(ds.Q[:B])                # capture
                ids, dists = index.search(ds.Q[:B])
                if not (np.array_equal(a0[f"{label} ids"], ids)
                        and np.array_equal(a0[f"{label} dists"], dists)):
                    raise AssertionError(f"pod {label}: differs from the "
                                         f"({POD_SHARDS}, 1) grid")
            if index is not grid:
                del index
                torch.cuda.empty_cache()
        V, del_base, del_add = pod_mutations(n, d)
        for name, knobs in (("fp32 none", {}), ("int8 none",
                                                {"quantization": "int8"})):
            c = dataclasses.replace(cfg, **knobs)
            index = grid if not knobs else Index(
                None, c, plane=MeshPlane(None, c, mesh, parts=gparts))
            new = index.add(V)
            index.delete(del_base)
            index.delete(new[del_add])
            dead = np.concatenate([del_base, new[del_add]])
            for B in ((10, n_queries) if name == "fp32 none" else (10,)):
                label = f"stream {name} B={B}"
                ids, dists = index.search(ds.Q[:B])
                if not (np.array_equal(a0[f"{label} ids"], ids)
                        and np.array_equal(a0[f"{label} dists"], dists)):
                    raise AssertionError(f"pod {label}: differs from the grid")
                if np.isin(ids, dead).any():
                    raise AssertionError(f"pod {label}: a deleted id returned")
            if index is not grid:
                del index
        del grid, gp, gparts
        torch.cuda.empty_cache()
        out["two_ranks"] = dict(
            seconds=[rec["seconds"] for rec in ranks],
            replay_ms=[rec["replay_ms"] for rec in ranks],
            grid_replay_ms=grid_ms,
            recall={lbl: recall_at_k(a0[f"{lbl} ids"],
                                     ds.gt[:a0[f"{lbl} ids"].shape[0]], 10)
                    for lbl in (f"{nm} B={B}" for nm, _ in POD_VARIANTS
                                for B in (10, n_queries))})
        for r, rec in enumerate(ranks):
            log(f"[pod] rank {r} of {POD_RANKS} (gloo, one card): build "
                f"{rec['seconds']['build']:.2f} s ({POD_SHARDS // POD_RANKS} "
                f"shards of {n // POD_SHARDS} rows), save "
                f"{rec['seconds']['save']:.2f} s, load "
                f"{rec['seconds']['load']:.2f} s; each replay == its eager "
                f"call bit for bit; median of {SERVE_REPEATS} replays, ms: "
                + ", ".join(f"{k} {v:.3f}"
                            for k, v in rec["replay_ms"].items()))
        log(f"[pod] both ranks answer alike, and == the ({POD_SHARDS}, 1) "
            "grid over the same shards bit for bit: " + ", ".join(
                f"{k} recall@10 {v:.4f}" for k, v in
                out["two_ranks"]["recall"].items())
            + f"; stream rounds (fp32 B = 10 and {n_queries}, int8 B = 10) "
            "too, no deleted id; the artifact's manifest names the pod "
            f"({POD_RANKS} processes), the 2-rank reload answers bit for bit; "
            f"the grid's median replays (one process): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in grid_ms.items()))
        out["seconds"]["b"] = time.perf_counter() - t0

        # ---- (c) the launcher at full size and the six examples (started
        # above)
        t0 = time.perf_counter()
        # the launcher's corpus and batches, served by an index in this
        # process: its recall is the launcher's yardstick
        lds = make_clustered(n=n, d=d, n_queries=512, n_clusters=64,
                             noise=0.6, device=dev)
        index = Index.build(lds.X, ANNConfig(), device=dev)
        rng = np.random.default_rng(0)
        hits = total = 0
        for _ in range(20):
            B = int(rng.choice([1, 4, 16, 64, 256]))
            sel = rng.integers(0, len(lds.Q), B)
            ids = index.search(lds.Q[sel])[0]
            hits += recall_at_k(ids, lds.gt[sel], 10) * B
            total += B
        want_recall = hits / total
        del index, lds
    except BaseException:
        stop_drivers(drivers_run)         # stop every driver on a failure
        raise
    runs = finish_drivers(drivers_run)
    out["seconds"]["c"] = time.perf_counter() - t0
    drivers = {}
    for name, (rc, text, secs) in runs.items():
        lines = text.rstrip().splitlines()
        with open(os.path.join(HERE, "chiprun_out", f"smoke_{name}.log"),
                  "w") as f:
            f.write(text)
        drivers[name] = dict(rc=rc, seconds=secs, last=lines[-1:])
        if rc != 0:
            raise AssertionError(f"{name} exited {rc}: " + "\n".join(
                lines[-20:]))
    final = [ln for ln in runs["launcher"][1].splitlines()
             if ln.startswith("[router] ")]
    got_recall = float(final[-2].rsplit("weighted recall ", 1)[1])
    if "lost_futures=0" not in final[-1] \
            or abs(got_recall - want_recall) > 0.01:
        raise AssertionError(f"launcher: {final[-2:]} (recall of this "
                             f"process's index {want_recall:.4f})")
    drivers["launcher"].update(recall=got_recall, index_recall=want_recall,
                               final=final[-2:])
    log(f"[drivers] python -m repro_torch.launch.serve --n {n} --d {d} "
        "--router replicated:2 --kill-replica 1: exit 0 in "
        f"{runs['launcher'][2]:.1f} s; " + final[-1][len("[router] "):]
        + f"; weighted recall@10 {got_recall:.4f} (the same corpus and "
        f"batches in this process: {want_recall:.4f}; phase 4's B = "
        f"{n_queries} recall "
        f"{record[f'search_none_{n_queries}']['recall_at_10']:.4f} is on "
        "phase 3's corpus, noise 0.15 against the launcher's 0.6)")
    for name, (knobs, ok) in EXAMPLES.items():
        if drivers[name]["last"] != [ok]:
            raise AssertionError(f"{name}: last line {drivers[name]['last']}")
        log(f"[drivers] examples/torch/{name}.py "
            + " ".join(f"{k}={v}" for k, v in knobs.items())
            + f": exit 0 in {drivers[name]['seconds']:.1f} s, '{ok}'")
    out["drivers"] = drivers
    tmp_dir.cleanup()
    out["seconds"]["total"] = time.perf_counter() - t_phase
    log("[pod] phase 13 seconds by part (a 1-rank NCCL pod, b two ranks "
        "and the grid, c drivers after b, which they overlap): " + json.dumps(
            {k: round(v, 2) for k, v in out["seconds"].items()}))
    return out, launches


# --------------------------------------------------------------------------
# phase 14: the language models' serving path (models/transformer.py)
# --------------------------------------------------------------------------

# (label, arch, layers or None for full depth, sequences, prompt, decode
# steps): widths are the configs' own, random weights from a seeded
# generator; each prompt runs past its arch's windows.  gemma3's 62
# layers are 108 GB in fp32: 18 (three 5:1 periods, ~54 GiB with the bf16
# copies) fit the card beside the runs
LM_DRILLS = (("a", "olmo-1b", None, 4, 2048, 32),
             ("b", "gemma3-27b", 18, 2, 2048, 16),
             ("c", "starcoder2-7b", None, 1, 4608, 8),
             ("d", "olmoe-1b-7b", None, 4, 512, 8))
FLASH_KERNELS = ("tile_kernel", "split_kernel", "combine_kernel")


def lm_serve(model, cfg, toks, P: int, steps: int, backend: str) -> dict:
    """Prefill ``toks[:, :P]``, then ``steps`` teacher-forced decode steps
    (token ``P + j`` at position ``P + j``) into a cache of ``P + steps``
    slots.  Returns the float32 logits of the prefill's last position and
    of each step ([steps + 1, B, V]), flash_attention's launches in the
    prefill and in each step (by the counter), and the CUDA-event ms of
    the prefill alone and of each step (the first from after the cache's
    set-up, each later one from the end of the one before)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import transformer as T

    def fa():
        return K.launch_counts()["flash_attention"]

    B = toks.shape[0]
    pre_ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    n0 = fa()
    pre_ev[0].record()
    last, pre = T.prefill(model, cfg, toks[:, :P], kernel_backend=backend)
    pre_ev[1].record()
    launches = [fa() - n0]
    cache = T.init_cache(cfg, B, P + steps, device=toks.device)
    for name, kv in pre.items():
        for t in ("k", "v"):
            cache[name][t][:, :P] = kv[t]
    del pre
    logits = [last.float()]
    ev[0].record()
    for j in range(steps):
        n0 = fa()
        x, cache = T.decode_step(model, cfg, cache, toks[:, P + j], P + j,
                                 kernel_backend=backend)
        ev[j + 1].record()
        launches.append(fa() - n0)
        logits.append(x.float())
    torch.cuda.synchronize()
    return dict(logits=torch.stack(logits), launches=launches,
                prefill_ms=pre_ev[0].elapsed_time(pre_ev[1]),
                step_ms=[ev[j].elapsed_time(ev[j + 1])
                         for j in range(steps)])


def lm_bounds(cfg, B: int, P: int, steps: int) -> dict:
    """The least ms of a prefill and of a mean decode step on the card,
    counting only the work the served function needs.  Prefill: the
    products (2 a weight a token through every layer's projections and
    FFN (MoE: its top-k and shared experts), the head for the last
    position only, which is all prefill returns; 4 hd a visible (query,
    key) pair a head for attention) at 989 TFLOP/s bf16.  Step: the bf16
    bytes of the matmul weights it reads (MoE: the shared experts, the
    router and at most min(E, B k) routed experts, the most B tokens can
    reach) and of the K and V cache up to the step's position, at 3.35
    TB/s.  The head over every prompt position and the capacity dispatch
    through all E experts are work of the port, not of the bound."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, L, V = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.vocab
    attn = d * hd * (2 * H + 2 * KV)
    if cfg.moe:
        m = cfg.moe
        expert = 3 * d * m.d_expert
        ffn_active = expert * (m.top_k + m.n_shared) + d * m.n_experts
        ffn_step = expert * (min(m.n_experts, B * m.top_k) + m.n_shared) \
            + d * m.n_experts
    else:
        ffn_active = ffn_step = (3 if cfg.gated_ffn else 2) * d * cfg.d_ff
    from repro_torch.models import transformer as T

    windows = T.layer_windows(cfg)
    pairs = sum(visible_pairs(P, P, int(w), 0) for w in windows)
    flops = 2 * B * P * L * (attn + ffn_active) + 2 * B * d * V \
        + 4 * hd * H * B * pairs
    pos = P + (steps - 1) / 2          # the mean step's position
    cache = sum(2 * B * min(pos + 1, int(w) if w > 0 else pos + 1) * KV
                * hd * 2 for w in windows)
    weights = 2 * (L * (attn + ffn_step) + d * V)
    return dict(prefill_tflop=flops / 1e12,
                prefill_bound_ms=flops / BF16_OPS_PER_S * 1e3,
                step_weight_gb=weights / 1e9, step_cache_gb=cache / 1e9,
                step_bound_ms=(weights + cache) / HBM_BYTES_PER_S * 1e3)


def lm_attention_checks(label, model, cfg, toks, P: int, steps: int,
                        gen, timed: bool = False) -> list:
    """``flash_attention`` at the drill's own shapes, each held to its
    plain version (``ref.attention_ref`` in float32) by
    :func:`check_attention`'s contract (:func:`attention_err_over_tol`
    <= 1): for every distinct window of the drill's layers, one prefill
    layer (the P-token prompt, q_offset 0) and one decode step (q_offset P
    over the P + steps slots of the cache), on unit-normal bf16 q/k/v
    (the cache's slots past P hold noise that the causal bound must drop)
    and on the q/k/v of the first layer with that window, computed from
    the prompt's embeddings (its cache past P zero, as served).  With
    ``timed``, each unit-normal case is also timed (CUDA events, the
    least of 3 means of 10 calls) beside SDPA on the same inputs and the
    plain version (a mean of 2 calls, widening included).  The
    launches are comparisons, recorded and not counted."""
    import torch

    from repro_torch.kernels import _build, flash_attention as FA, ref
    from repro_torch.models import transformer as T

    B, S, bf = toks.shape[0], P + steps, torch.bfloat16
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    windows = [int(w) for w in T.layer_windows(cfg)]
    W = model.weights(bf)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=toks.device).to(bf)

    rows = []
    with torch.no_grad(), _build.recording():
        x = W["embed"][toks[:, :P + 1].long()]
        positions = torch.arange(P + 1, device=toks.device)[None, :]
        for w in sorted(set(windows)):
            li = windows.index(w)
            qr, kr, vr = T._qkv(cfg, W["layers"][li], x, positions)
            kc = torch.zeros((B, S, KV, hd), dtype=bf, device=toks.device)
            vc = torch.zeros_like(kc)
            kc[:, :P + 1], vc[:, :P + 1] = kr, vr
            cases = (
                ("unit normal", "prefill", rnd(B, P, H, hd),
                 rnd(B, P, KV, hd), rnd(B, P, KV, hd), 0),
                ("unit normal", "decode", rnd(B, 1, H, hd),
                 rnd(B, S, KV, hd), rnd(B, S, KV, hd), P),
                (f"layer {li}", "prefill", qr[:, :P], kr[:, :P], vr[:, :P],
                 0),
                (f"layer {li}", "decode", qr[:, P:], kc, vc, P))
            for inputs, kind, q, k, v, off in cases:
                q, k, v = (t.contiguous() for t in (q, k, v))
                kw = dict(window=max(w, 0), q_offset=off)
                out = FA.flash_attention(q, k, v, **kw)
                qf, kf, vf = q.float(), k.float(), v.float()
                want = ref.attention_ref(qf, kf, vf, **kw)
                weight = ref.attention_ref(qf, kf, vf.abs(), **kw)
                ratio = attention_err_over_tol(out, want, weight)
                rows.append(dict(
                    window=w, inputs=inputs, kind=kind, Sq=q.shape[1],
                    Skv=k.shape[1], q_offset=off, err_over_tol=ratio,
                    body=FA.path(B, q.shape[1], k.shape[1], H, KV, hd, bf),
                    finite=bool(torch.isfinite(out).all())))
                if timed and inputs == "unit normal":
                    rows[-1]["ms"] = cuda_ms(
                        lambda: FA.flash_attention(q, k, v, **kw), 10,
                        repeats=3)
                    rows[-1]["sdpa_ms"] = cuda_ms(
                        lambda: sdpa(q, k, v, w, off), 10, repeats=3)
                    rows[-1]["plain_ms"] = cuda_ms(
                        lambda: ref.attention_ref(q.float(), k.float(),
                                                  v.float(), **kw), 2)
                del out, want, weight, qf, kf, vf
            del qr, kr, vr, kc, vc
        del x
    torch.cuda.empty_cache()
    log(f"[lm] ({label}) flash_attention at the drill's shapes (G = "
        f"{H // KV}) against its plain version, err/tol of 1e-5*(P@|V|) + "
        "2^-8*|out|: " + "; ".join(
            f"window {r['window']} {r['kind']} {r['Sq']}x{r['Skv']} at "
            f"q_offset {r['q_offset']} ({r['body']}), {r['inputs']}: "
            f"{r['err_over_tol']:.3f}" for r in rows))
    for r in rows:
        if "ms" in r:
            log(f"[lm] ({label}) flash_attention {r['kind']} {r['Sq']}x"
                f"{r['Skv']} at q_offset {r['q_offset']} ({r['body']}), "
                f"B={B}, {H} heads over {KV} of {hd}, bf16: {r['ms']:.4f} ms;"
                f" SDPA on the same inputs {r['sdpa_ms']:.4f} ms; the plain "
                f"version {r['plain_ms']:.4f} ms")
    bad = [r for r in rows if not (r["err_over_tol"] <= 1.0 and r["finite"])]
    if bad:
        raise AssertionError(f"[lm] ({label}) flash_attention over its "
                             f"tolerance at the drill's shapes: {bad}")
    return rows


def lm_planted_faults(label, model, cfg, toks, P: int, steps: int,
                      ref_logits, err_plain: float) -> dict:
    """The model-level gate against two planted faults: the kernel path
    served again with flash_attention's inputs altered as a faulty kernel
    would treat them, q times sqrt(hd) (the 1/sqrt(hd) scale dropped)
    and, where a layer has a window, window 0 (the window dropped).  The
    kernel itself is unchanged.  Reported, not gated: whether
    ``err_kernel <= 2 * err_plain`` would let each fault through.  The
    launches are recorded, not counted."""
    import types

    from repro_torch.kernels import _build, flash_attention as FA
    from repro_torch.models import transformer as T

    hd = cfg.resolved_head_dim
    faults = {"no scale": lambda q, k, v, **kw: FA.flash_attention(
        q * hd ** 0.5, k, v, **kw)}
    if any(int(w) > 0 for w in T.layer_windows(cfg)):
        faults["no window"] = lambda q, k, v, window=0, q_offset=0: \
            FA.flash_attention(q, k, v, q_offset=q_offset)
    found = {}
    try:
        for name, fn in faults.items():
            T._fa = types.SimpleNamespace(flash_attention=fn)
            with _build.recording():
                logits = lm_serve(model, cfg, toks, P, steps, "auto")["logits"]
            err = float((logits - ref_logits).abs().max())
            found[name] = dict(err_kernel=err, over_err_plain=err / err_plain,
                               gate_rejects=not err <= 2 * err_plain)
            del logits
    finally:
        T._fa = FA
    log(f"[lm] ({label}) planted faults against the model gate (2x "
        f"err_plain {err_plain:.4g}; not gated): " + "; ".join(
            f"{k}: err {v['err_kernel']:.4g} ({v['over_err_plain']:.2f}x), "
            + ("rejected" if v["gate_rejects"] else "let through")
            for k, v in found.items()))
    return found


def lm_phase(dev) -> tuple:
    """Phase 14, with every counter at 0: for each of :data:`LM_DRILLS`,
    one after another, each freed before the next: the model from
    ``init_params`` on the card,
    ``LMStream`` tokens, a prefill and teacher-forced decode steps on the
    hand kernel (``flash_attention``: one tile launch a layer in the
    prefill, split + combine a layer at each step, by the counters), on
    the plain path (``kernel_backend="torch"``) in bf16 and on the plain
    path in float32 (TF32 off), the reference; ``err_kernel <= 2 *
    err_plain`` against it.  Before the runs, flash_attention is held to
    its plain version at the drill's own shapes
    (:func:`lm_attention_checks`), the gate that a wrong kernel cannot
    pass; after them, the model gate is shown two planted faults
    (:func:`lm_planted_faults`).  Times (CUDA events; medians), the device time
    of flash_attention in a traced prefill and step, the bounds and the
    peak memory.  Returns (results, the phase's launch counts)."""
    import dataclasses as dc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMStream
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params, param_bytes

    torch.backends.cuda.matmul.allow_tf32 = False   # the float32 reference
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    for label, arch, layers, B, P, steps in LM_DRILLS:
        t0 = time.perf_counter()
        cfg = get_arch(arch)
        cut = ""
        if layers is not None and layers < cfg.n_layers:
            cut = f", cut from {cfg.n_layers} to {layers} layers"
            cfg = dc.replace(cfg, n_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = T.Transformer(cfg, init_params(T.schema(cfg), gen, dev))
        toks_np = next(LMStream(cfg.vocab, P + steps, B, seed=0))["tokens"]
        toks = torch.as_tensor(toks_np[:, :P + steps], device=dev)
        log(f"[lm] ({label}) {arch}: {cfg.n_layers} layers{cut}, d "
            f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
            f"{cfg.resolved_head_dim}, vocab {cfg.vocab}, "
            f"{param_bytes(T.schema(cfg)) / 1e9:.2f} GB of fp32 weights; "
            f"B={B}, prompt {P}, {steps} decode steps "
            f"(LMStream seed 0)")
        attn_checks = lm_attention_checks(label, model, cfg, toks, P, steps,
                                          gen, timed=label == "a")
        cfg32 = dc.replace(cfg, compute_dtype="float32")
        ref = lm_serve(model, cfg32, toks, P, steps, "torch")["logits"]
        plain = lm_serve(model, cfg, toks, P, steps, "torch")
        kern = lm_serve(model, cfg, toks, P, steps, "auto")
        err_kernel = float((kern["logits"] - ref).abs().max())
        err_plain = float((plain["logits"] - ref).abs().max())
        agree = float((kern["logits"].argmax(-1)
                       == plain["logits"].argmax(-1)).float().mean())
        finite = bool(torch.isfinite(kern["logits"]).all())
        faults = lm_planted_faults(label, model, cfg, toks, P, steps, ref,
                                   err_plain)
        del ref
        L = cfg.n_layers
        if kern["launches"] != [L] + [2 * L] * steps or any(
                plain["launches"]):
            raise AssertionError(
                f"[lm] ({label}) flash_attention launches "
                f"{kern['launches']} (plain path {plain['launches']}): "
                f"want {L} in the prefill (tile) and {2 * L} a step "
                "(split + combine), none on the plain path")
        # timing: two more prefills beside the run's, the run's steps
        pre_ms = [kern["prefill_ms"]] + [
            lm_serve(model, cfg, toks, P, 0, "auto")["prefill_ms"]
            for _ in range(2)]
        prefill_ms = float(np.median(pre_ms))
        step_ms = float(np.median(kern["step_ms"]))
        # one traced prefill and decode step: flash_attention's share
        cache = T.init_cache(cfg, B, P + 1, device=dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, pre = T.prefill(model, cfg, toks[:, :P])
            torch.cuda.synchronize()
        busy_p, top_p, per_p = device_time(prof, 4)
        for name, kv in pre.items():
            for t in ("k", "v"):
                cache[name][t][:, :P] = kv[t]
        del pre
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            T.decode_step(model, cfg, cache, toks[:, P], P)
            torch.cuda.synchronize()
        busy_s, top_s, per_s = device_time(prof, 4)
        del cache
        fa_p = kernel_us(per_p, FLASH_KERNELS) / 1e3
        fa_s = kernel_us(per_s, FLASH_KERNELS) / 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        b = lm_bounds(cfg, B, P, steps)
        r = dict(arch=arch, n_layers=cfg.n_layers, cut=cut.lstrip(", "),
                 B=B, prompt=P, steps=steps, err_kernel=err_kernel,
                 err_plain=err_plain, greedy_agreement=agree,
                 prefill_ms=prefill_ms, prefill_runs_ms=pre_ms,
                 prompt_tokens_per_s=B * P / prefill_ms * 1e3,
                 step_ms=step_ms, decode_tokens_per_s=B / step_ms * 1e3,
                 traced_prefill_busy_ms=busy_p / 1e3,
                 traced_prefill_flash_ms=fa_p,
                 traced_step_busy_ms=busy_s / 1e3,
                 traced_step_flash_ms=fa_s, top_prefill=top_p,
                 top_step=top_s, peak_gib=peak,
                 launches_prefill=kern["launches"][0],
                 launches_step=kern["launches"][1], **b,
                 attention_checks=attn_checks, planted_faults=faults,
                 seconds=time.perf_counter() - t0)
        results[label] = r
        log(f"[lm] ({label}) {arch}: logits against the float32 plain "
            f"run: err_kernel={r['err_kernel']:.4g} err_plain (bf16 plain "
            f"path)={r['err_plain']:.4g} (limit 2x); greedy tokens of the "
            f"kernel path equal the plain path's on {agree:.2%} (not "
            f"gated); flash_attention launches {L} in the prefill, "
            f"{2 * L} a step")
        log(f"[lm] ({label}) {arch}: prefill {prefill_ms:.3f} ms (median "
            f"of 3; {r['prompt_tokens_per_s']:.0f} prompt tokens/s; bound "
            f"{b['prefill_bound_ms']:.3f} ms for {b['prefill_tflop']:.2f} "
            f"TFLOP at 989 TFLOP/s), decode {step_ms:.3f} ms a step (median"
            f" of {steps}; {r['decode_tokens_per_s']:.0f} tokens/s; bound "
            f"{b['step_bound_ms']:.3f} ms for {b['step_weight_gb']:.2f} GB"
            f" of bf16 weights and {b['step_cache_gb']:.3f} GB of cache); "
            f"traced: prefill device {busy_p / 1e3:.3f} ms, flash_attention"
            f" {fa_p:.3f} ms ({fa_p / max(busy_p / 1e3, 1e-9):.1%}); step "
            f"device {busy_s / 1e3:.3f} ms, flash_attention {fa_s:.3f} ms "
            f"({fa_s / max(busy_s / 1e3, 1e-9):.1%}); peak "
            f"{peak:.2f} GiB; {r['seconds']:.1f} s")
        log(f"[lm] ({label}) costliest device ops: prefill "
            + "; ".join(f"{k[:60]} {t:.3f} ms" for k, t in top_p)
            + " | step " + "; ".join(f"{k[:60]} {t:.3f} ms"
                                     for k, t in top_s))
        if not finite:
            raise AssertionError(f"[lm] ({label}) non-finite logits")
        if not r["err_kernel"] <= 2 * r["err_plain"]:
            raise AssertionError(
                f"[lm] ({label}) err_kernel {r['err_kernel']} over twice "
                f"err_plain {r['err_plain']}")
        del model, kern, plain
        torch.cuda.empty_cache()
    launches = K.launch_counts()
    results["seconds"] = time.perf_counter() - t_phase
    log(f"[lm] phase 14: {results['seconds']:.1f} s")
    log("[launches] phase 14 " + json.dumps(launches))
    if launches["flash_attention"] <= 0:
        raise AssertionError("flash_attention never launched on the LM path")
    return results, launches


# --------------------------------------------------------------------------
# phase 15: Wide & Deep's serving path (models/recsys.py) at full size
# --------------------------------------------------------------------------

# RECSYS_SHAPES serve_p99 and serve_bulk; retrieval_cand's candidates
RECSYS_BATCHES = (512, 262_144)
RECSYS_CANDIDATES = 1_000_000
RECSYS_REPEATS = 20           # steps a median
BAG_KERNELS = ("bag_vector_kernel", "bag_lane_kernel")


def recsys_bounds(cfg, batch: dict) -> dict:
    """The least ms of a serve step on the card for this batch: the bytes
    it must move (each distinct row of every field's table once, the
    wide buckets it reads, the MLP's weights, the batch in and the
    probabilities out) at 3.35 TB/s, and the MLP's and the head's
    products at the fp32 rate (the model serves in float32), the larger
    of the two."""
    import numpy as np
    import torch

    from repro_torch.models import recsys as R

    B = batch["dense"].shape[0]
    E = cfg.embed_dim
    rows = 0
    multi = list(cfg.multi_hot_fields)
    for i in range(cfg.n_sparse):
        ids = batch["bags"][:, multi.index(i)] if i in multi \
            else batch["sparse_ids"][:, i]
        rows += int(np.unique(ids).size)
    dims = (cfg.n_sparse * E + cfg.n_dense,) + tuple(cfg.mlp) + (1,)
    weights = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    flops = 2 * B * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    buckets = int(torch.unique(R.wide_indices(
        cfg, torch.from_numpy(batch["sparse_ids"]))).numel())
    inputs = sum(batch[k].nbytes for k in ("sparse_ids", "bags", "dense"))
    nbytes = rows * E * 4 + weights * 4 + buckets * 4 + inputs + B * 4
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / FP32_OPS_PER_S * 1e3
    return dict(distinct_rows=rows, wide_buckets=buckets, bytes=nbytes,
                flops=flops,
                bytes_ms=t_b, ops_ms=t_o, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def event_median_ms(fn, n: int = RECSYS_REPEATS) -> float:
    """Median of ``n`` calls of ``fn``, each timed by CUDA events."""
    import statistics

    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    ev[0].record()
    for j in range(n):
        fn()
        ev[j + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[j].elapsed_time(ev[j + 1])
                             for j in range(n))


def recsys_bag_checks(model, cfg, batches: dict, dev) -> list:
    """Each bag field's ``embedding_bag`` at the drill's own (skewed) ids,
    at every batch, against its plain version within the bag contract
    (1e-6 * the bag's sum of |rows|), bit equality reported; at the bulk
    batch also timed (the calls queued ahead), both routes, beside
    ``F.embedding_bag`` and the bound of its distinct rows.  The launches
    are comparisons, recorded and not counted."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, embedding_bag as EB

    rows = []
    with _build.recording():
        for B, batch in batches.items():
            bags = batch["bags"].transpose(0, 1).contiguous()
            for f, field in enumerate(cfg.multi_hot_fields):
                table = model.tables[f"field_{field}"].detach()
                ids = bags[f]
                out = EB.embedding_bag(table, ids)
                want = EB.embedding_bag_plain(table, ids)
                scale = table[ids.long()].abs().sum(1) / cfg.bag_size
                ok = bool(((out - want).abs() <= 1e-6 * scale).all()) \
                    and bool(torch.isfinite(out).all())
                r = dict(B=B, field=field, V=table.shape[0],
                         route=EB.path(table, ids), ok=ok,
                         bit_equal=bool(torch.equal(out, want)),
                         max_abs_err=float((out - want).abs().max()))
                if B == RECSYS_BATCHES[-1]:
                    ids64 = ids.long()
                    r["device_ms"] = {v: cuda_ms(
                        lambda v=v: EB.embedding_bag(table, ids, via=v),
                        20, repeats=3, ahead=True) for v in EB.ROUTES}
                    r["library_ms"] = cuda_ms(
                        lambda: F.embedding_bag(ids64, table, mode="mean"),
                        5)
                    n = int(torch.unique(ids).numel())
                    nbytes = (n + B) * cfg.embed_dim * 4 + ids.numel() * 4
                    r["distinct_rows"] = n
                    r["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                    r["gb_per_s"] = nbytes / r["device_ms"][r["route"]] / 1e6
                rows.append(r)
                del out, want, scale
    for r in rows:
        timing = ""
        if "device_ms" in r:
            timing = (f"; device_ms vector={r['device_ms']['vector']:.4f} "
                      f"lane={r['device_ms']['lane']:.4f}, F.embedding_bag "
                      f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f}"
                      f" ms (bytes: {r['distinct_rows']} distinct rows of "
                      f"{r['B'] * cfg.bag_size}), {r['gb_per_s']:.0f} GB/s")
        log(f"[recsys] embedding_bag field {r['field']} [{r['V']}, "
            f"{cfg.embed_dim}] bag {cfg.bag_size} mean B={r['B']} at the "
            f"drill's ids ({r['route']}): max_abs_err={r['max_abs_err']:.3g}"
            f" within 1e-6*sum|rows|: {r['ok']}; bit for bit the plain "
            f"version: {r['bit_equal']}{timing}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"[recsys] embedding_bag over its tolerance at "
                             f"the drill's ids: {bad}")
    return rows


def recsys_phase(dev) -> tuple:
    """Phase 15, with the LM state freed and every counter at 0:
    ``wide_deep`` at full size (49.36 M rows of 32, fp32; weights from
    ``init_params`` with a seeded generator on the card), batches from
    ``CTRStream(cfg, B, seed=0)``.  First each bag field's kernel at the
    drill's ids against its plain version (:func:`recsys_bag_checks`);
    then ``serve_step`` at B = 512 and 262,144 on the kernel path (4
    launches a step, by the counter) and on ``kernel_backend="torch"``
    with the same weights, within 1e-6 on the probabilities; medians of
    20 steps (CUDA events), ``embedding_bag``'s share of a traced step's
    device time, the step's bound and the peak memory; then
    ``retrieval_step`` over 10^6 item vectors (ids equal to the plain
    path's).  Returns (results, the phase's launch counts)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import CTRStream
    from repro_torch.kernels import _build, embedding_bag as EB
    from repro_torch.models import recsys as R
    from repro_torch.models.module import init_params, param_bytes

    torch.backends.cuda.matmul.allow_tf32 = False    # the model is fp32
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("wide-deep")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = R.WideDeep(cfg, init_params(R.schema(cfg), gen, dev))
    host = {B: next(CTRStream(cfg, B, seed=0)) for B in RECSYS_BATCHES}
    batches = {B: R.batch_to(b, dev) for B, b in host.items()}
    torch.cuda.synchronize()
    out = dict(setup_s=time.perf_counter() - t0,
               weight_gb=param_bytes(R.schema(cfg)) / 1e9,
               table_rows=sum(cfg.vocab_sizes))
    log(f"[recsys] wide_deep: {cfg.n_sparse} fields of {cfg.embed_dim} "
        f"({out['table_rows']} rows), bag fields {cfg.multi_hot_fields} of "
        f"{cfg.bag_size}, MLP {cfg.mlp}, {cfg.wide_hash_buckets} wide "
        f"buckets: {out['weight_gb']:.2f} GB of fp32 weights; set-up "
        f"(init_params on the card, CTRStream seed 0 at B = "
        f"{', '.join(map(str, RECSYS_BATCHES))}) {out['setup_s']:.1f} s")
    out["bag_checks"] = recsys_bag_checks(model, cfg, batches, dev)
    n_bags = len(cfg.multi_hot_fields)
    steps = {}
    for B, batch in batches.items():
        n0 = K.launch_counts()["embedding_bag"]
        probs = R.serve_step(model, cfg, batch)
        torch.cuda.synchronize()
        launched = K.launch_counts()["embedding_bag"] - n0
        plain = R.serve_step(model, cfg, batch, kernel_backend="torch")
        err = float((probs - plain).abs().max())
        good = probs.shape == (B,) and bool(torch.isfinite(probs).all()) \
            and bool(((probs >= 0) & (probs <= 1)).all())
        if launched != n_bags or not good or not err <= 1e-6:
            raise AssertionError(
                f"[recsys] serve_step B={B}: embedding_bag launched "
                f"{launched} (want {n_bags}), probabilities valid {good}, "
                f"max |kernel - plain| {err} (limit 1e-6)")
        ms = event_median_ms(lambda: R.serve_step(model, cfg, batch))
        plain_ms = event_median_ms(lambda: R.serve_step(
            model, cfg, batch, kernel_backend="torch"))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            R.serve_step(model, cfg, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, top, per = device_time(prof, 5)
        bag_ms = kernel_us(per, BAG_KERNELS) / 1e3
        # the step's bags again, timed alone by CUDA events (the
        # trace can drop kernels: a share from either)
        bags = batch["bags"].transpose(0, 1).contiguous()
        with _build.recording():
            bag_event_ms = sum(cuda_ms(
                lambda f=f: EB.embedding_bag(
                    model.tables[f"field_{f}"].detach(), bags[j]), 10,
                repeats=3, ahead=True)
                for j, f in enumerate(cfg.multi_hot_fields))
        del bags
        b = recsys_bounds(cfg, host[B])
        steps[B] = r = dict(
            launches=launched, err_vs_plain=err, bit_equal_plain=bool(
                torch.equal(probs, plain)), ms=ms, plain_ms=plain_ms,
            rows_per_s=B / ms * 1e3, traced_wall_ms=wall,
            traced_busy_ms=busy / 1e3, bag_ms=bag_ms,
            bag_share=bag_ms / max(busy / 1e3, 1e-9),
            bag_event_ms=bag_event_ms,
            bag_event_share=bag_event_ms / max(busy / 1e3, 1e-9), top_ms=top,
            **b)
        del probs, plain
        log(f"[recsys] serve_step B={B}: embedding_bag launched {launched} "
            f"times (one a bag field); max |kernel - plain path| {err:.3g} "
            f"(limit 1e-6; bit for bit: {r['bit_equal_plain']}); median of "
            f"{RECSYS_REPEATS} {ms:.3f} ms ({r['rows_per_s']:.0f} rows/s; "
            f"plain path {plain_ms:.3f} ms); bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}: {b['bytes'] / 1e6:.1f} MB at 3.35 TB/s = "
            f"{b['bytes_ms']:.4f} ms, {b['distinct_rows']} distinct rows; "
            f"{b['flops'] / 1e9:.2f} GFLOP at 67 TFLOP/s = "
            f"{b['ops_ms']:.4f} ms); traced: wall {wall:.3f} ms, device "
            f"{busy / 1e3:.3f} ms, embedding_bag {bag_ms:.4f} ms "
            f"({r['bag_share']:.1%}"
            + ("" if bag_ms > 0 else ": the trace holds no embedding_bag "
               f"kernel, though the counter saw {launched} launches")
            + f"); the step's {n_bags} bags timed alone "
            f"{bag_event_ms:.4f} ms "
            f"({r['bag_event_share']:.1%} of the traced device time); "
            "costliest "
            + "; ".join(f"{k[:50]} {t:.3f} ms" for k, t in top))
    out["serve"] = steps
    # retrieval: one user against 10^6 item vectors
    items = torch.randn((RECSYS_CANDIDATES, R.RETRIEVAL_DIM), generator=gen,
                        device=dev)
    one = {k: v[:1] for k, v in batches[RECSYS_BATCHES[0]].items()}
    query = dict(one, item_vectors=items)
    ids, top = R.retrieval_step(model, cfg, query)
    ids_p, top_p = R.retrieval_step(model, cfg, query,
                                    kernel_backend="torch")
    found = ids.cpu().numpy()
    if found.shape != (100,) or len(set(found.tolist())) != 100 or not (
            (found >= 0) & (found < RECSYS_CANDIDATES)).all() \
            or not torch.equal(ids, ids_p) or not torch.equal(top, top_p) \
            or not bool((top[:-1] >= top[1:]).all()):
        raise AssertionError("[recsys] retrieval_step: bad top-100, or "
                             "unlike the plain path's")
    ms = event_median_ms(lambda: R.retrieval_step(model, cfg, query))
    nbytes = items.numel() * 4
    out["retrieval"] = dict(ms=ms, candidates=RECSYS_CANDIDATES,
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    log(f"[recsys] retrieval_step over {RECSYS_CANDIDATES} item vectors of "
        f"{R.RETRIEVAL_DIM}: the top-100 equal to the plain path's; median "
        f"of {RECSYS_REPEATS} {ms:.3f} ms (bound "
        f"{out['retrieval']['bound_ms']:.4f} ms: the item vectors' bytes)")
    del items, query, model, batches
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    launches = K.launch_counts()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[recsys] phase 15: {out['seconds']:.1f} s, peak device memory "
        f"{out['peak_gib']:.2f} GiB")
    log("[launches] phase 15 " + json.dumps(launches))
    if launches["embedding_bag"] <= 0:
        raise AssertionError("embedding_bag never launched on the recsys "
                             "path")
    return out, launches


# --------------------------------------------------------------------------
# phase 16: the graph family (models/gnn.py, models/mace.py)
# --------------------------------------------------------------------------

# GNN_SHAPES minibatch_lg (Reddit): the host graph's edges, its classes
# (GNN_N_CLASSES), the sampler's seeds and fanout (the reference's step
# samples with the shape's fanout, not the config's sample_sizes)
GNN_EDGES, GNN_CLASSES = 114_615_892, 41
GNN_BATCH_NODES, GNN_FANOUTS = 1024, (15, 10)
GNN_BATCHES = 3               # sampled batches driven through the model
GNN_REPEATS = 20              # forwards a median
# the float64 gates: err_card <= 2 * err_cpu32 + GNN_EPS * scale, scale
# the largest |output| of the float64 run
GNN_EPS = 4e-6
GNN_PLAIN_TOL = 1e-5          # kernel path against the card's plain path
MACE_ROTATION_TOL = 1e-5      # |E(x Q^T + t) - E(x)| <= tol * max |E(x)|
SPMM_KERNELS = ("spmm_kernel", "project_kernel", "gather_kernel")
KEPT: dict = {}               # host state a later phase reuses


def init_all(schema, gen, dev):
    """``init_params`` on the card from ``gen``, then every zero-init leaf
    (biases, LN scales, GIN's eps, MACE's readout head) drawn at std 0.1,
    so that each leaf moves the output the gates read."""
    import torch

    from repro_torch.models.module import init_params, leaves, std

    tree = init_params(schema, gen, dev)
    for path, spec in leaves(schema):
        node = tree
        *parents, name = path.split(".")
        for key in parents:
            node = node[key]
        if std(spec) == 0:
            node[name] = 0.1 * torch.randn(spec.shape, generator=gen,
                                           device=dev)
    return tree


def moved(tree, device, float_dtype=None):
    """A copy of a nested dict of tensors on ``device``, its floating
    tensors in ``float_dtype`` (if given)."""
    if isinstance(tree, dict):
        return {k: moved(v, device, float_dtype) for k, v in tree.items()}
    t = tree.detach().to(device)
    if float_dtype is not None and t.is_floating_point():
        t = t.to(float_dtype)
    return t


def gate64(card, cpu32, ref64) -> dict:
    """The float64 gate: the card's output no further from the float64 run
    on the CPU than twice the CPU's float32 run, plus GNN_EPS times the
    float64 run's largest |output|."""
    import torch

    scale = float(ref64.abs().max())
    err = float((card.cpu().double() - ref64).abs().max())
    err32 = float((cpu32.double() - ref64).abs().max())
    limit = 2 * err32 + GNN_EPS * scale
    return dict(err_card=err, err_cpu32=err32, scale=scale, limit=limit,
                ok=bool(torch.isfinite(card).all()) and err <= limit)


def gate_text(g: dict) -> str:
    return (f"max |card - float64| {g['err_card']:.3g} (CPU float32 "
            f"{g['err_cpu32']:.3g}; limit 2 x that + {GNN_EPS:g} x scale "
            f"{g['scale']:.4g} = {g['limit']:.3g}): "
            + ("ok" if g["ok"] else "FAILED"))


def cpu_runs(make, tree, batch: dict):
    """The model ``make(tree)`` on the CPU in float32 and in float64 (TF32
    plays no part there) on ``batch`` (tensors on the CPU): (float32
    output, float64 output).  The float64 run drops ``"neighbors"``: the
    packed_spmm route aggregates in float32, the edge list in the
    batch's dtype."""
    import torch

    cpu = torch.device("cpu")
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items() if k != "neighbors"}
    return (make(moved(tree, cpu))(batch),
            make(moved(tree, cpu, torch.float64))(b64))


def sage_bounds(cfg, batch: dict, n_classes: int) -> dict:
    """The least ms of a GraphSAGE forward on this batch: its inputs (the
    features, the neighbour matrix, the weights) read once and the logits
    written once at 3.35 TB/s, and its products at the fp32 rate: the
    encoder, each layer's self product over every node and neighbour
    product over the rows with a child (the others are 0), the lanes'
    adds, the decoder; the larger of the two."""
    import numpy as np

    N, F = batch["node_feat"].shape
    nbrs = batch["neighbors"]
    d, L = cfg.d_hidden, cfg.n_layers
    lanes = int((nbrs < N).sum())
    rows = int((nbrs < N).any(1).sum())
    weights = F * d + d + L * (2 * d * d + d) + d * n_classes + n_classes
    nbytes = batch["node_feat"].nbytes + nbrs.nbytes + 4 * weights \
        + 4 * N * n_classes
    flops = 2 * N * F * d + L * (2 * N * d * d + 2 * rows * d * d
                                 + lanes * d) + 2 * N * d * n_classes
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / FP32_OPS_PER_S * 1e3
    return dict(bytes=int(nbytes), flops=int(flops), rows_with_children=rows,
                lanes=lanes, bytes_ms=t_b, ops_ms=t_o, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                mean_lanes=float(np.mean(nbrs < N)))


def layer_inputs(model, cfg, batch) -> list:
    """(neighbors, h, w_nbr) of each ``packed_spmm`` call of one forward,
    read as the forward makes them (its launches recorded, not
    counted)."""
    from repro_torch.kernels import _build
    from repro_torch.models import gnn as G

    calls = []
    real = G._sm.packed_spmm

    def spy(nbrs, h, w, **kw):
        calls.append((nbrs, h, w))
        return real(nbrs, h, w, **kw)

    G._sm.packed_spmm = spy
    try:
        with _build.recording():
            G.forward(model, cfg, batch)
    finally:
        G._sm.packed_spmm = real
    return calls


def sage_drill(dev, gen) -> tuple:
    """(a): ``graphsage_reddit`` at ``minibatch_lg``, full size.  Returns
    (results, packed_spmm's rows at the path's call shapes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import make_community_graph
    from repro_torch.data.sampler import SampledStream
    from repro_torch.kernels import _build
    from repro_torch.models import gnn as G

    cfg = get_arch("graphsage-reddit")
    out: dict = {}
    t0 = time.perf_counter()
    graph = make_community_graph(GNN_NODES, GNN_EDGES, GNN_FEAT,
                                 n_classes=GNN_CLASSES, seed=0)
    out["graph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = SampledStream(graph, GNN_BATCH_NODES, GNN_FANOUTS, seed=0)
    out["csr_s"] = time.perf_counter() - t0
    log(f"[gnn] (a) host graph make_community_graph({GNN_NODES} nodes, "
        f"{GNN_EDGES} edges, d_feat {GNN_FEAT}, {GNN_CLASSES} classes): "
        f"{out['graph_s']:.1f} s ({graph['node_feat'].nbytes / 1e6:.0f} MB "
        f"of features, {(graph['edge_src'].nbytes + graph['edge_dst'].nbytes) / 1e6:.0f}"
        f" MB of edges); the sampler's CSR {out['csr_s']:.1f} s")
    schema = G.schema(cfg, GNN_FEAT, GNN_CLASSES)
    tree = init_all(schema, gen, dev)
    model = G.GNN(cfg, tree)
    n_layers = cfg.n_layers
    rows, spmm_rows = [], []
    for j in range(GNN_BATCHES):
        t0 = time.perf_counter()
        host = next(stream)
        sample_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = G.batch_to(host, dev)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) * 1e3
        N, M = batch["neighbors"].shape
        n0 = K.launch_counts()["packed_spmm"]
        logits = G.forward(model, cfg, batch)
        torch.cuda.synchronize()
        launched = K.launch_counts()["packed_spmm"] - n0
        again = G.forward(model, cfg, batch)
        torch.cuda.synchronize()
        launched_again = K.launch_counts()["packed_spmm"] - n0 - launched
        with _build.recording():
            plain = G.forward(model, cfg, batch, kernel_backend="torch")
        scale = float(plain.abs().max())
        r = dict(batch=j, N=N, M=M, E=int(batch["edge_src"].shape[0]),
                 sample_ms=sample_ms, h2d_ms=h2d_ms, launches=launched,
                 bit_equal_repeat=bool(torch.equal(logits, again)),
                 err_vs_plain=float((logits - plain).abs().max()),
                 plain_scale=scale,
                 shape_ok=tuple(logits.shape) == (N, GNN_CLASSES))
        r["plain_ok"] = r["err_vs_plain"] <= GNN_PLAIN_TOL * scale
        if j == 0:
            out32, out64 = cpu_runs(lambda t: G.GNN(cfg, t), tree,
                                    G.batch_to(host, "cpu"))
            r["kernel_vs_float64"] = gate64(logits, out32, out64)
            r["plain_vs_float64"] = gate64(plain, out32, out64)
            with _build.recording():   # the planted fault: sum, not mean
                wrong = G.forward(model, dataclasses.replace(
                    cfg, aggregator="sum"), batch)
            r["planted_sum"] = gate64(wrong, out32, out64)
            del wrong, out32, out64
            for i, (nbrs, h, w) in enumerate(layer_inputs(model, cfg,
                                                          batch)):
                name = (f"graphsage minibatch_lg layer {i}: N={N} M={M} "
                        f"[{h.shape[0]}, {h.shape[1]}] @ [{w.shape[0]}, "
                        f"{w.shape[1]}] mean")
                with _build.recording():
                    spmm_rows.append(check_spmm(name, nbrs, h, w))
            r["bounds"] = sage_bounds(cfg, host, GNN_CLASSES)
        rows.append(r)
        del plain, again
        log(f"[gnn] (a) graphsage_reddit minibatch_lg batch {j}: N={N} "
            f"(M={M}), E={r['E']}; sampling {sample_ms:.1f} ms, host to "
            f"device {h2d_ms:.1f} ms; packed_spmm launched {launched} "
            f"times a forward (want {n_layers}), {launched_again} on the "
            f"repeat; the repeat bit for bit: {r['bit_equal_repeat']}; "
            f"max |kernel - plain path| {r['err_vs_plain']:.3g} (limit "
            f"{GNN_PLAIN_TOL:g} x {scale:.4g})")
        if j == 0:
            log("[gnn] (a) batch 0, the CPU's float64 run of the edge list "
                "as the reference: kernel path "
                + gate_text(r["kernel_vs_float64"]) + "; plain path on the "
                "card " + gate_text(r["plain_vs_float64"]))
            log("[gnn] (a) planted fault, combine=\"sum\" in place of "
                "\"mean\": " + gate_text(r["planted_sum"])
                + (" -- the gate fails it, as it must"
                   if not r["planted_sum"]["ok"] else ""))
            for s in spmm_rows:
                log_kernel("packed_spmm", s)
        bad = [k for k, ok in (
            ("launches", launched == n_layers
             and launched_again == n_layers),
            ("repeat", r["bit_equal_repeat"]), ("shape", r["shape_ok"]),
            ("plain", r["plain_ok"]),
            ("float64", j > 0 or (r["kernel_vs_float64"]["ok"]
                                  and r["plain_vs_float64"]["ok"])),
            ("planted", j > 0 or not r["planted_sum"]["ok"])) if not ok]
        if bad:
            raise AssertionError(f"[gnn] (a) batch {j} failed: {bad} {r}")
        if j < GNN_BATCHES - 1:
            del batch, logits
    # timing on the last batch, resident on the card (launches recorded)
    with _build.recording():
        ms = event_median_ms(lambda: G.forward(model, cfg, batch),
                             GNN_REPEATS)
        plain_ms = event_median_ms(lambda: G.forward(
            model, cfg, batch, kernel_backend="torch"), GNN_REPEATS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            G.forward(model, cfg, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    busy, top, per = device_time(prof, 6)
    spmm_ms = kernel_us(per, SPMM_KERNELS) / 1e3
    alone_ms = sum(s["device_ms"] for s in spmm_rows)
    # without the kernel in the trace: the calls timed alone, over the
    # traced device time, or over the median forward without a trace
    share = (spmm_ms or alone_ms) / (busy / 1e3 if busy > 0 else ms)
    b = rows[0]["bounds"]
    out.update(batches=rows, ms=ms, plain_ms=plain_ms,
               nodes_per_s=rows[-1]["N"] / ms * 1e3, traced_wall_ms=wall,
               traced_busy_ms=busy / 1e3, spmm_traced_ms=spmm_ms,
               spmm_alone_ms=alone_ms, spmm_share=share, top_ms=top,
               **{f"bound_{k}": v for k, v in b.items()})
    log(f"[gnn] (a) forward at minibatch_lg (N={rows[-1]['N']}), median of "
        f"{GNN_REPEATS} {ms:.3f} ms ({out['nodes_per_s']:.0f} nodes/s; "
        f"plain path {plain_ms:.3f} ms); bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}: {b['bytes'] / 1e6:.1f} MB at 3.35 TB/s = "
        f"{b['bytes_ms']:.4f} ms; {b['flops'] / 1e9:.2f} GFLOP at 67 "
        f"TFLOP/s = {b['ops_ms']:.4f} ms; {b['rows_with_children']} rows "
        f"with a child, {b['lanes']} lanes); traced: wall {wall:.3f} ms, "
        f"device {busy / 1e3:.3f} ms, packed_spmm {spmm_ms:.4f} ms "
        + (f"({share:.1%} of the device time)" if spmm_ms > 0 else
           f"(the {len(spmm_rows)} calls timed alone {alone_ms:.4f} ms: "
           f"{share:.1%} of the "
           + ("traced device time)" if busy > 0 else "median forward)"))
        + "; costliest "
        + "; ".join(f"{k[:50]} {t:.3f} ms" for k, t in top))
    if spmm_ms <= 0:
        log("[gnn] FINDING: the trace holds no packed_spmm kernel"
            + ("" if busy > 0 else " and no device event")
            + " though the counter saw its launches; the share above is "
            "from the kernel timed alone")
    # phase 18 trains on the same graph and sampler (the host's CSR of
    # Reddit's 114.6 M edges is built once)
    KEPT["sage_stream"] = stream
    del model, batch, logits, graph, stream
    return out, spmm_rows


def small_gnn_drills(dev, gen) -> dict:
    """(b): ``gin_tu`` and ``gatedgcn`` at ``molecule`` (128 graphs of 30
    nodes and 64 edges, d_feat 16, 8 classes, mean-pooled) and all three
    GNNs at ``full_graph_sm`` (2,708 nodes, 10,556 edges, d_feat 1,433,
    16 classes: the edge list), each against the float64 run on the CPU
    (:func:`gate64`), with the median forward ms."""
    import torch

    from repro_torch.configs import GNN_N_CLASSES, GNN_SHAPES, get_arch
    from repro_torch.data.graphs import (make_community_graph,
                                         molecule_batch_for_gnn)
    from repro_torch.models import gnn as G

    mol, full = GNN_SHAPES["molecule"].dims, GNN_SHAPES["full_graph_sm"].dims
    graphs = {
        "molecule": molecule_batch_for_gnn(
            mol["batch"], mol["n_nodes"], mol["n_edges"],
            n_classes=GNN_N_CLASSES["molecule"], seed=0),
        "full_graph_sm": make_community_graph(
            full["n_nodes"], full["n_edges"], full["d_feat"],
            n_classes=GNN_N_CLASSES["full_graph_sm"], seed=0)}
    out = {}
    for arch, shape in (("gin-tu", "molecule"), ("gatedgcn", "molecule"),
                        ("gin-tu", "full_graph_sm"),
                        ("gatedgcn", "full_graph_sm"),
                        ("graphsage-reddit", "full_graph_sm")):
        cfg = get_arch(arch)
        host = graphs[shape]
        d_feat, n_classes = host["node_feat"].shape[1], GNN_N_CLASSES[shape]
        tree = init_all(G.schema(cfg, d_feat, n_classes), gen, dev)
        model = G.GNN(cfg, tree)
        batch = G.batch_to(host, dev)
        logits = model(batch)
        out32, out64 = cpu_runs(lambda t: G.GNN(cfg, t), tree,
                                G.batch_to(host, "cpu"))
        g = gate64(logits, out32, out64)
        ms = event_median_ms(lambda: model(batch), GNN_REPEATS)
        out[f"{arch} {shape}"] = r = dict(
            gate=g, ms=ms, logits=list(logits.shape), layers=cfg.n_layers,
            d_hidden=cfg.d_hidden)
        log(f"[gnn] (b) {arch} ({cfg.n_layers} layers, d {cfg.d_hidden}) at "
            f"{shape} (logits {r['logits']}): " + gate_text(g)
            + f"; median of {GNN_REPEATS} forwards {ms:.3f} ms")
        if not g["ok"]:
            raise AssertionError(f"[gnn] (b) {arch} at {shape}: {g}")
    return out


def mace_drill(dev, gen) -> dict:
    """(c): ``mace`` at ``molecule`` (128 molecules of 30 atoms, 64 edges
    each: N = 3,840, E = 8,192), the energies against the float64 run on
    the CPU (:func:`gate64`); a random proper rotation and a translation
    on the card within MACE_ROTATION_TOL; the median forward ms and the
    peak memory."""
    import numpy as np
    import torch

    from repro_torch.configs import GNN_SHAPES, get_arch
    from repro_torch.data.graphs import make_molecules
    from repro_torch.models import mace as MC
    from repro_torch.models.module import batch_to

    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("mace")
    dims = GNN_SHAPES["molecule"].dims
    host = make_molecules(dims["batch"], dims["n_nodes"], dims["n_edges"],
                          seed=0)
    tree = init_all(MC.schema(cfg), gen, dev)
    model = MC.MACE(cfg, tree)

    batch = batch_to(host, dev)
    energies = model(batch)
    out32, out64 = cpu_runs(lambda t: MC.MACE(cfg, t), tree,
                            batch_to(host, "cpu"))
    g = gate64(energies, out32, out64)
    Q, _ = np.linalg.qr(np.random.default_rng(16).normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    moved_pos = (host["positions"] @ Q.T + [10.0, -3.0, 7.0]).astype(
        np.float32)
    rotated = model(dict(batch, positions=torch.from_numpy(moved_pos).to(
        dev)))
    scale = float(energies.abs().max())
    rot_err = float((rotated - energies).abs().max())
    rot_ok = rot_err <= MACE_ROTATION_TOL * scale
    ms = event_median_ms(lambda: model(batch), GNN_REPEATS)
    out = dict(gate=g, rotation_err=rot_err, rotation_scale=scale,
               rotation_ok=rot_ok, ms=ms, N=int(batch["positions"].shape[0]),
               E=int(batch["edge_src"].shape[0]),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"[gnn] (c) mace (C {cfg.d_hidden}, l_max {cfg.l_max}, nu "
        f"{cfg.correlation_order}, {cfg.n_rbf} rbf, {cfg.n_layers} layers) "
        f"at molecule, N={out['N']} E={out['E']}: energies "
        + gate_text(g) + f"; a proper rotation and a translation on the "
        f"card move them by {rot_err:.3g} (limit {MACE_ROTATION_TOL:g} x "
        f"{scale:.4g}): " + ("ok" if rot_ok else "FAILED")
        + f"; median of {GNN_REPEATS} forwards {ms:.3f} ms; peak device "
        f"memory {out['peak_gib']:.2f} GiB")
    if not (g["ok"] and rot_ok):
        raise AssertionError(f"[gnn] (c) mace failed: {out}")
    return out


def gnn_phase(dev) -> tuple:
    """Phase 16, with the recsys state freed and every counter at 0: (a)
    GraphSAGE at minibatch_lg's full size on ``packed_spmm``, (b) GIN and
    GatedGCN at molecule and the three GNNs at full_graph_sm, (c) MACE at
    molecule.  Returns (results, the phase's launch counts, packed_spmm's
    rows at the path's call shapes)."""
    import torch

    from repro_torch import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False    # the models are fp32
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    K.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out, spmm_rows = sage_drill(dev, gen)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    out["small"] = small_gnn_drills(dev, gen)
    out["mace"] = mace_drill(dev, gen)
    torch.cuda.empty_cache()
    launches = K.launch_counts()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[gnn] phase 16: {out['seconds']:.1f} s, peak device memory of "
        f"(a) {out['peak_gib']:.2f} GiB")
    log("[launches] phase 16 " + json.dumps(launches))
    # two forwards a batch (and its repeat), one launch a layer of two
    want = GNN_BATCHES * 2 * 2
    if launches["packed_spmm"] != want:
        raise AssertionError(f"packed_spmm launched {launches['packed_spmm']}"
                             f" times on the GraphSAGE path, want {want}")
    return out, launches, spmm_rows


# --------------------------------------------------------------------------
# phase 17: LM training (models/transformer.py loss_fn, optim/, train/) on
# flash_attention forward and its hand-written backward
# --------------------------------------------------------------------------

TRAIN_ARCH = "olmo-1b"
TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 12
TRAIN_CKPT_LAYERS, TRAIN_CKPT_STEPS = 2, 6
TRAIN_TIMEOUT = 300           # seconds a subprocess of the phase may take
BWD_KERNELS = ("dq_kernel", "dkv_kernel")   # its two passes in a trace
# the earlier FFMA design of the backward at the drill's layer, bf16 and
# float32 (ms; an H100 80GB HBM3 at its 700 W limit), beside this run's
BWD_FFMA_MS = {"bfloat16": 19.2747, "float32": 19.0711}
# the backward kernel alone, on unit-normal q, k, v and dout: (label, B,
# S, H, KV, hd, window, dtypes, timed): the drill's layer; gemma3-27b's
# local layer (32 q heads over 16 KV heads, window 1,024); starcoder2-7b's
# G = 9 (36 over 4) under its 4,096 window
BWD_CASES = (("olmo_1b layer", 4, 2048, 16, 16, 128, 0,
              ("bfloat16", "float32"), True),
             ("gemma3_27b local", 2, 2048, 32, 16, 128, 1024,
              ("bfloat16",), False),
             ("starcoder2_7b G=9", 1, 2048, 36, 4, 128, 4096,
              ("bfloat16",), False))


def bwd_over_tol(got, ref64, err_plain: float) -> float:
    """The largest (|got - ref| - 2^-8 |ref| for a bf16 output) / (2
    err_plain) over the elements: <= 1 is the backward's contract (twice
    the float32 plain version's largest error against the float64
    oracle, plus one rounding of a bf16 output)."""
    import torch

    excess = (got.double() - ref64).abs()
    if got.dtype == torch.bfloat16:
        excess = excess - 2.0 ** -8 * ref64.abs()
    return float(excess.max()) / (2 * err_plain)


def sdpa_bwd(q, k, v, dout, window):
    """SDPA's backward on the same inputs, the yardstick (never called by
    the port): a closure taking ``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` (causal flag, or a boolean mask for
    a window shorter than the sequence)."""
    import torch

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with torch.enable_grad():
        out = sdpa(qt.transpose(1, 2), kt.transpose(1, 2),
                   vt.transpose(1, 2), window if window < q.shape[1] else 0,
                   0)
    do = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), do,
                                       retain_graph=True)


def check_attention_bwd(label, B, S, H, KV, hd, window, dtype, timed, dev,
                        gen) -> dict:
    """(a): ``flash_attention_bwd`` on unit-normal inputs against the
    float64 autograd of ``ref.attention_ref`` (the oracle) within
    :func:`bwd_over_tol`, beside its plain version in float32; a planted
    fault (dq without its 1/sqrt(hd) scale) must fail the same contract.
    With ``timed``: the kernel's ms, the plain version's and SDPA's
    backward's.  The launches are comparisons, recorded and not counted."""
    import torch

    from repro_torch.kernels import _build, flash_attention as FA, ref

    dt = getattr(torch, dtype)
    q, dout = (torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt)
               for _ in range(2))
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dt)
            for _ in range(2))
    kw = dict(window=window)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    out64 = ref.attention_ref(*leaves, **kw)
    ref64 = torch.autograd.grad(out64, leaves, dout.double())
    del out64, leaves
    plain = FA.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                         dout.float(), **kw)
    err_plain = [float((p.double() - r).abs().max())
                 for p, r in zip(plain, ref64)]
    with _build.recording():
        kern = FA.flash_attention_bwd(q, k, v, dout, **kw)
    torch.cuda.synchronize()
    fault = (kern[0].float() * hd ** 0.5).to(dt)
    ratios = [bwd_over_tol(g, r, e) for g, r, e in zip(kern, ref64,
                                                        err_plain)]
    fault_ratio = bwd_over_tol(fault, ref64[0], err_plain[0])
    r = dict(shape=f"{label} [{B}, {S}, {H} over {KV} x {hd}] "
             f"{'window ' + str(window) if window else 'causal'} {dtype}",
             dtype=dtype, err_plain=err_plain,
             err_over_tol=ratios,
             fault_err_over_tol=fault_ratio,
             finite=all(bool(torch.isfinite(g).all()) for g in kern),
             max_abs_err=max(float((g.float() - p).abs().max())
                             for g, p in zip(kern, plain)))
    del ref64, plain, kern, fault
    torch.cuda.empty_cache()
    pairs = visible_pairs(S, S, window, 0) * B * H
    flops = 10 * hd * pairs
    nbytes = (3 * B * S * H + 4 * B * S * KV) * hd * q.element_size()
    bf16 = dt == torch.bfloat16
    r["bound_ms"], r["bound_by"] = bound(
        nbytes, flops, BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S)
    r["gflop"] = flops / 1e9
    r["ms"] = r["plain_ms"] = r["library_ms"] = None
    if timed:
        with _build.recording():
            r["ms"] = cuda_ms(lambda: FA.flash_attention_bwd(q, k, v, dout,
                                                             **kw), 3)
        r["plain_ms"] = cuda_ms(lambda: FA.flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), dout.float(), **kw), 1)
        r["library_ms"] = cuda_ms(sdpa_bwd(q, k, v, dout, window), 5)
        torch.cuda.empty_cache()
    return r


def token_nll(params, cfg, tokens, backend: str):
    """Each token's loss, logsumexp(logits) - the gold logit in float32,
    from one forward without gradients (its launches recorded, not
    counted)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T

    with torch.no_grad(), _build.recording():
        logits, _ = T.train_forward(params, cfg, tokens[:, :-1],
                                    kernel_backend=backend)
        logits = logits.float()
        gold = torch.gather(logits, -1, tokens[:, 1:, None].long())[..., 0]
        return torch.logsumexp(logits, -1) - gold


def train_bounds(cfg, B: int, S: int) -> dict:
    """The least ms of a training step on the card: 8 operations a token
    for each parameter of the checkpointed layers (forward, backward and
    remat's second forward of the products), 6 for each of the head's V d
    (outside the layers, so not recomputed), none for the embedding (a
    gather), plus attention's 4 hd (forward, twice) and 10 hd (backward)
    a visible pair, at 989 TFLOP/s bf16."""
    from repro_torch.models import transformer as T

    hd, H = cfg.resolved_head_dim, cfg.n_heads
    pairs = sum(visible_pairs(S, S, int(w), 0)
                for w in T.layer_windows(cfg)) * B * H
    vd = cfg.vocab * cfg.d_model
    layers = cfg.n_active_params() - vd * (1 if cfg.tie_embeddings else 2)
    flops = (8 * layers + 6 * vd) * B * S + (2 * 4 + 10) * hd * pairs
    return dict(step_tflop=flops / 1e12,
                step_bound_ms=flops / BF16_OPS_PER_S * 1e3)


def train_gate(cfg, params, batch) -> dict:
    """(b)'s gate: the loss and the gradient tree at the same weights and
    batch on the kernel path, on ``kernel_backend="torch"`` in bf16 and on
    the float32 plain reference (TF32 off).  Errors against the reference:
    the global relative error of the gradient tree, and of each token's
    loss (the mean, one scalar, is reported beside it: a sum of signed
    errors can cancel by chance).  Returns the errors and the kernel
    run's launches."""
    import dataclasses as dc

    import torch

    from repro_torch import kernels as K
    from repro_torch.models import transformer as T
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.train.trainer import _grads_of

    cfg32 = dc.replace(cfg, compute_dtype="float32")
    toks = batch["tokens"]

    def grads(c, backend):
        g, m = _grads_of(lambda p, b: T.loss_fn(p, c, b,
                                                kernel_backend=backend),
                         params, batch)
        return tree_leaves(g), float(m["loss"])

    g32, l32 = grads(cfg32, "torch")
    nll32 = token_nll(params, cfg32, toks, "torch")
    norm = sum(float(x.double().square().sum()) for x in g32) ** 0.5
    out = {"loss_ref": l32}
    for name, c, backend in (("plain", cfg, "torch"), ("kernel", cfg,
                                                        "auto")):
        n0 = K.launch_counts()
        g, loss = grads(c, backend)
        torch.cuda.synchronize()
        n1 = K.launch_counts()
        out[f"launches_{name}"] = {k: n1[k] - n0[k] for k in n1}
        out[f"grad_err_{name}"] = sum(
            float((a.double() - b.double()).square().sum())
            for a, b in zip(g, g32)) ** 0.5 / norm
        out[f"finite_{name}"] = all(bool(torch.isfinite(x).all()) for x in g)
        del g
        nll = token_nll(params, c, toks, backend)
        out[f"token_err_{name}"] = float((nll - nll32).norm() / nll32.norm())
        out[f"loss_err_{name}"] = abs(loss - l32)
        del nll
    del g32, nll32
    torch.cuda.empty_cache()
    return out


def start_train_trace(dev):
    """The traced step in a fresh process (``tools/train_trace.py``; the
    smoke's late traces lose device events), started early: it imports
    on the host, then waits for :func:`finish_train_trace` before it
    touches the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    where = [] if dev.type == "cuda" else ["--device", "cpu"]
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "tools", "train_trace.py"),
         "--wait", *where], env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_train_trace(p) -> dict:
    """Let the traced step run; its output goes to
    ``chiprun_out/smoke_train_trace.log``.  Returns its JSON line."""
    try:
        out, err = p.communicate("go\n", timeout=TRAIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        raise
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "smoke_train_trace.log"), "w") as f:
        f.write(out + err)
    if p.returncode != 0:
        raise AssertionError(f"[train] the traced step exited "
                             f"{p.returncode}: {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def start_train_drivers(tmp: str, dev) -> dict:
    """(c)'s entry points, each a subprocess on the card (a CPU rehearsal
    passes ``--device cpu``), started together: the launcher on
    ``kimi-k2-1t-a32b --reduced`` (Adafactor) and
    ``examples/torch/train_lm.py`` at a CI size."""
    import threading

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    where = [] if dev.type == "cuda" else ["--device", "cpu"]
    cmds = {
        "launch.train": [sys.executable, "-m", "repro_torch.launch.train",
                         "--arch", "kimi-k2-1t-a32b", "--reduced",
                         "--steps", "3", "--batch", "4", "--seq", "64",
                         "--ckpt-dir", os.path.join(tmp, "launch"), *where],
        "train_lm": [sys.executable, os.path.join(HERE, "examples", "torch",
                                                  "train_lm.py"),
                     "--steps", "2", "--d-model", "64", "--layers", "2",
                     "--seq", "64", "--batch", "8",
                     "--ckpt", os.path.join(tmp, "example"), *where]}
    runs = {"procs": {}, "threads": [], "out": {},
            "started": time.perf_counter()}

    def wait(name, p):
        text = p.communicate()[0]
        runs["out"][name] = (p.returncode, text,
                             time.perf_counter() - runs["started"])

    for name, cmd in cmds.items():
        p = runs["procs"][name] = subprocess.Popen(
            cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        t = threading.Thread(target=wait, args=(name, p), daemon=True)
        t.start()
        runs["threads"].append(t)
    return runs


def checkpoint_drill(dev, tmp: str) -> dict:
    """(c): ``olmo_1b`` at full width cut to 2 layers, B = 4 x 2,048: 12
    uninterrupted steps, against 6 steps, a save, a restore into a fresh
    ``Trainer``'s state and 6 more; every parameter and optimizer leaf
    bit for bit.  Save and load seconds (host clock, the files in the
    page cache) and bytes."""
    import dataclasses as dc
    import itertools

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMStream
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import OptimizerConfig
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = dc.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_CKPT_LAYERS)
    n = TRAIN_CKPT_STEPS

    def trainer(steps):
        return Trainer(
            schema=T.schema(cfg), loss_fn=lambda p, b: T.loss_fn(p, cfg, b),
            opt_cfg=OptimizerConfig(lr=3e-4, warmup_steps=5,
                                    total_steps=2 * n),
            train_cfg=TrainConfig(steps=steps, log_every=0, ckpt_every=0),
            device=dev)

    def data(skip=0):
        return itertools.islice(LMStream(cfg.vocab, TRAIN_SEQ, TRAIN_B,
                                         seed=0), skip, None)

    full, _ = trainer(2 * n).run(data())
    full = [x.clone() for x in tree_leaves(full)]
    torch.cuda.empty_cache()
    half, _ = trainer(n).run(data())
    d = os.path.join(tmp, "ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(half, n, d)
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(d)
    del half
    torch.cuda.empty_cache()
    tr = trainer(n)
    t0 = time.perf_counter()
    state, step = ckpt.restore(d, tr.init_state())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resumed, _ = tr.run(data(skip=n), state=state)
    equal = step == n and all(
        torch.equal(a, b) for a, b in zip(full, tree_leaves(resumed)))
    del full, resumed, state
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, steps=2 * n, save_s=save_s,
                load_s=load_s, bytes=nbytes, bitwise_equal=equal)


def train_phase(dev) -> tuple:
    """Phase 17, with phase 16's state released: (a) the backward kernel
    alone at the drill's layer (bf16 and float32), gemma3-27b's local
    layer and starcoder2-7b's G = 9 against the float64 oracle, and a
    planted fault; (b) ``olmo_1b`` at full width (16 layers, B = 4 x
    2,048, bf16, remat, AdamW as the launcher sets it; weights from
    ``init_params`` with a seeded generator on the card): the gate over
    the gradient tree and each token's loss against the float32 plain
    run (its launches counted apart), then 12 steps through
    ``Trainer.run`` (loss falling, median step by CUDA events, peak
    memory) with every counter at 0 just before them and read just
    after, then a traced step in a fresh process; (c) the 2-layer checkpoint round trip, the launcher and the
    example.  Returns (results, the main path's launch counts, the
    backward kernel's rows)."""
    import itertools
    import statistics
    import tempfile

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMStream
    from repro_torch.models import transformer as T
    from repro_torch.models.module import batch_to, param_bytes
    from repro_torch.optim.api import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False   # the float32 reference
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out: dict = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # (a) the backward kernel alone
    rows = []
    for label, B, S, H, KV, hd, window, dtypes, timed in BWD_CASES:
        for dtype in dtypes:
            rows.append(check_attention_bwd(label, B, S, H, KV, hd, window,
                                            dtype, timed, dev, gen))
    for r in rows:
        extra = ""
        if r["ms"] is not None:
            extra = (f"; ms={r['ms']:.4f} (the FFMA design "
                     f"{BWD_FFMA_MS[r['dtype']]:.2f}) plain_ms="
                     f"{r['plain_ms']:.4f} SDPA backward "
                     f"{r['library_ms']:.4f} ms")
        split = ("P and dS in 3 bf16 pieces"
                 if r["dtype"] == "bfloat16" else
                 "each operand in 3 TF32 pieces, 6 products")
        log(f"[train] (a) flash_attention_bwd {r['shape']}, {split}: "
            f"err/tol of dq, dk, dv "
            + ", ".join(f"{x:.3f}" for x in r["err_over_tol"])
            + " (the float32 plain version's largest errors against the "
            "float64 oracle " + ", ".join(f"{x:.3g}" for x in r["err_plain"])
            + f"); planted fault (dq without its scale) {r['fault_err_over_tol']:.3g}"
            + (" rejected" if r["fault_err_over_tol"] > 1 else " LET THROUGH")
            + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['gflop']:.1f} GFLOP){extra}")
    bad = [r["shape"] for r in rows
           if not (max(r["err_over_tol"]) <= 1 and r["finite"])]
    missed = [r["shape"] for r in rows if not r["fault_err_over_tol"] > 1]
    if bad or missed:
        raise AssertionError(f"[train] (a) backward kernel over its "
                             f"contract: {bad}; planted fault let through: "
                             f"{missed}")
    out["bwd"] = rows
    out["a_s"] = time.perf_counter() - t_phase

    # (b) the full-width training step
    t0 = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    opt_cfg = OptimizerConfig(
        name="adafactor" if cfg.name.startswith("kimi") else "adamw",
        lr=3e-4, warmup_steps=max(5, TRAIN_STEPS // 20),
        total_steps=TRAIN_STEPS)
    tr = Trainer(schema=T.schema(cfg),
                 loss_fn=lambda p, b: T.loss_fn(p, cfg, b), opt_cfg=opt_cfg,
                 train_cfg=TrainConfig(steps=TRAIN_STEPS, log_every=1,
                                       ckpt_every=0), device=dev)
    torch.cuda.reset_peak_memory_stats()
    state = tr.init_state()
    stream = LMStream(cfg.vocab, TRAIN_SEQ, TRAIN_B, seed=0)
    first = next(stream)
    log(f"[train] (b) {TRAIN_ARCH}: {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, "
        f"vocab {cfg.vocab}, {cfg.n_params() / 1e9:.3f} B parameters "
        f"({param_bytes(T.schema(cfg)) / 1e9:.2f} GB fp32); B={TRAIN_B} x "
        f"{TRAIN_SEQ} tokens (LMStream seed 0), compute "
        f"{cfg.compute_dtype}, remat {cfg.remat}, {opt_cfg.name} lr "
        f"{opt_cfg.lr} warmup {opt_cfg.warmup_steps}")
    gate = train_gate(cfg, state["params"], batch_to(first, dev))
    out["gate"] = gate
    L = cfg.n_layers
    losses, ev = [], []

    def on_metrics(i, m):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)
        losses.append(m["loss"])

    tracer = start_train_trace(dev)
    try:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        ev.append(start)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        tr.run(itertools.chain([first], stream), state=state,
               on_metrics=on_metrics)
        torch.cuda.synchronize()
    except BaseException:
        tracer.kill()
        raise
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = [ev[j].elapsed_time(ev[j + 1]) for j in range(len(ev) - 1)]
    del state, tr
    torch.cuda.empty_cache()
    median = statistics.median(step_ms[1:])
    b = train_bounds(cfg, TRAIN_B, TRAIN_SEQ)
    tail = sum(losses[-3:]) / 3
    out.update(losses=losses, step_ms=step_ms, median_step_ms=median,
               tokens_per_s=TRAIN_B * TRAIN_SEQ / median * 1e3, peak_gib=peak,
               launches=launches, b_s=time.perf_counter() - t0, **b)
    log(f"[train] (b) gate against the float32 plain run (TF32 off): "
        f"gradient tree's global relative error kernel "
        f"{gate['grad_err_kernel']:.4g}, bf16 plain {gate['grad_err_plain']:.4g}"
        f" (limit 2x); each token's loss kernel {gate['token_err_kernel']:.4g}, "
        f"plain {gate['token_err_plain']:.4g} (limit 2x); the mean loss "
        f"{gate['loss_ref']:.6f}, off by {gate['loss_err_kernel']:.3g} / "
        f"{gate['loss_err_plain']:.3g} (kernel / plain; reported)")
    log(f"[train] (b) {TRAIN_STEPS} steps: loss " + " ".join(
        f"{x:.4f}" for x in losses) + f"; mean of the last 3 {tail:.4f} "
        f"against the first {losses[0]:.4f}")
    log(f"[train] (b) step {median:.2f} ms (median of steps 2-{TRAIN_STEPS}"
        f", CUDA events; first {step_ms[0]:.2f} ms), "
        f"{out['tokens_per_s']:.0f} tokens/s; bound {b['step_bound_ms']:.2f}"
        f" ms ({b['step_tflop']:.2f} TFLOP at 989 TFLOP/s); peak device "
        f"memory {peak:.2f} GiB")
    log(f"[launches] phase 17 (the {TRAIN_STEPS} steps) "
        + json.dumps(launches))
    want = TRAIN_STEPS * 2 * L
    fails = []
    if not (gate["finite_kernel"]
            and gate["grad_err_kernel"] <= 2 * gate["grad_err_plain"]
            and gate["token_err_kernel"] <= 2 * gate["token_err_plain"]):
        fails.append(f"gate {gate}")
    if gate["launches_kernel"]["flash_attention"] != 2 * L \
            or gate["launches_kernel"]["flash_attention_bwd"] != 2 * L \
            or any(gate["launches_plain"].values()):
        fails.append(f"a step's launches {gate['launches_kernel']} (plain "
                     f"{gate['launches_plain']}), want {2 * L} each")
    if launches["flash_attention"] != want \
            or launches["flash_attention_bwd"] != want:
        fails.append(f"launches {launches}, want {want} of each")
    if not tail < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if fails:
        tracer.kill()
        raise AssertionError("[train] (b) " + "; ".join(fails))

    trace = finish_train_trace(tracer)
    out["trace"] = trace
    log(f"[train] (b) a traced step in a fresh process: wall "
        f"{trace['wall_ms']:.2f} ms, device busy {trace['busy_ms']:.2f} ms "
        f"({trace['busy_share']:.1%}); flash_attention (tile) "
        f"{trace['flash_ms']:.2f} ms ({trace['flash_share']:.1%} of the "
        f"device time), flash_attention_bwd {trace['bwd_ms']:.2f} ms "
        f"({trace['bwd_share']:.1%}); costliest device ops: "
        + "; ".join(f"{k[:60]} {t:.2f} ms" for k, t in trace["top"]))

    # (c) checkpoint and the entry points
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        runs = start_train_drivers(tmp, dev)
        try:
            rt = checkpoint_drill(dev, tmp)
        finally:
            for t in runs["threads"]:
                t.join(timeout=TRAIN_TIMEOUT)
            for p in runs["procs"].values():
                if p.poll() is None:
                    p.kill()
    out["checkpoint"] = rt
    out["drivers"] = {k: dict(rc=rc, s=s) for k, (rc, _, s) in
                      runs["out"].items()}
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for name, (rc, text, _) in runs["out"].items():
        with open(os.path.join(out_dir, f"smoke_{name}.log"), "w") as f:
            f.write(text)
    out["c_s"] = time.perf_counter() - t0
    log(f"[train] (c) checkpoint round trip, {rt['layers']} layers at full "
        f"width: 6 steps, save ({rt['save_s']:.2f} s, {rt['bytes'] / 1e9:.2f}"
        f" GB), restore into a fresh Trainer ({rt['load_s']:.2f} s), 6 steps"
        + (" == 12 uninterrupted steps bit for bit" if rt["bitwise_equal"]
           else " DIFFER from 12 uninterrupted steps"))
    for name, (rc, text, s) in runs["out"].items():
        last = [x for x in text.strip().splitlines() if x][-1:] or [""]
        log(f"[train] (c) {name}: exit {rc} after {s:.1f} s; {last[0]}")
    fails = [n for n in ("launch.train", "train_lm")
             if runs["out"].get(n, (1,))[0] != 0]
    if not rt["bitwise_equal"] or fails:
        raise AssertionError(f"[train] (c) resume bit for bit "
                             f"{rt['bitwise_equal']}; failed: {fails}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase 17: {out['seconds']:.1f} s ((a) {out['a_s']:.1f}, "
        f"(b) {out['b_s']:.1f} + the trace, (c) {out['c_s']:.1f})")
    return out, launches, rows


# --------------------------------------------------------------------------
# phase 18: training of the graph, MACE and Wide & Deep families, on the
# hand-written backward kernels of packed_spmm and embedding_bag
# --------------------------------------------------------------------------

FAMILY_STEPS = 12             # (a) and (b): AdamW steps, as the launcher
SMALL_STEPS = 6               # (c): steps of each small drill
FAMILY_BAG_BATCH = 65_536     # RECSYS_SHAPES train_batch
SPMM_BWD_TOL = 1e-5           # of |terms| (the card tests' contract)
BAG_BWD_TOL = 1e-6            # of |terms| (the bag contract)
# plus float32's smallest normal: a gradient's terms can be subnormal,
# where a division's rounding is absolute (2^-150), not relative
TINY = 2.0 ** -126
# the float64 forces: |F(x Q^T + t) - F(x) Q^T| / max |F|.  Float32
# forces are held to the float64 run at every position instead: at
# molecule's close pairs they reach 3e4, and float32 positions moved by
# t = (10, -3, 7) round 3.5x coarser.  The 1/r of those pairs amplifies
# float64's rounding too: 7.1e-10 to 1.5e-9 measured (PR 29)
MACE_FORCE_ROTATION_TOL = 1e-8
# the float32 forces' gate is pooled over x and 3 rotated and moved
# positions: one position's largest error is set by a few close pairs
# and one float32 run's rounding of them (the CPU's own ranges 1.4-4.6
# over the positions and trees of PR 29's runs), so one draw's
# card-over-CPU ratio is not stable
MACE_FORCE_DRAWS = 4
MACE_FORCE_SHIFTS = ((10.0, -3.0, 7.0), (-6.0, 4.0, 2.0), (3.0, 8.0, -5.0))


def tree_err(got, ref) -> float:
    """The global relative error of a gradient tree: ||got - ref|| /
    ||ref|| over every leaf (float64 sums)."""
    from repro_torch.optim.tree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(ref)
    num = sum(float((x.double() - y.double().to(x.device)).square().sum())
              for x, y in zip(a, b))
    den = sum(float(y.double().square().sum()) for y in b)
    return (num / den) ** 0.5


def family_opt(steps: int):
    """AdamW at lr 1e-3, warmup 5, as the launcher trains these
    families."""
    from repro_torch.optim.api import OptimizerConfig, make_optimizer

    return make_optimizer(OptimizerConfig(lr=1e-3, warmup_steps=5,
                                          total_steps=steps))


def timed_steps(step, params, opt_state, batches) -> tuple:
    """Run ``step`` over ``batches`` (an iterator of (batch on the card,
    host ms to sample, host ms to copy)); each step timed by CUDA events
    around the step alone.  Returns (losses, step ms, sample ms, copy
    ms)."""
    import torch

    losses, ms, sample, copy = [], [], [], []
    for batch, s_ms, c_ms in batches:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        params, opt_state, m = step(params, opt_state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        sample.append(s_ms)
        copy.append(c_ms)
    return losses, ms, sample, copy


def host_batches(stream, dev, n: int):
    """``n`` batches drawn from ``stream`` and copied to ``dev``, with the
    host ms of each draw and copy."""
    import torch

    from repro_torch.models.module import batch_to

    for _ in range(n):
        t0 = time.perf_counter()
        host = next(stream)
        s_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = batch_to(host, dev)
        torch.cuda.synchronize()
        yield batch, s_ms, (time.perf_counter() - t0) * 1e3


# the kernels of the two backward kernels' grouping, sum and zeros
# (lane_groups.cuh), and packed_spmm_bwd's own: the plan's compaction,
# dW, and segment_matmul.cu's copy of the active rows (its projection
# and gather are SPMM_KERNELS[1:])
BWD_GROUP_KERNELS = ("radix_totals", "radix_onesweep", "scan_top",
                     "runs_count", "runs_write", "group_sum_vec",
                     "group_sum_scalar", "zero_unread")
SPMM_BWD_KERNELS = BWD_GROUP_KERNELS + ("compact_count", "compact_write",
                                        "copy_rows_kernel",
                                        "dw_partial_kernel",
                                        "dw_reduce_kernel")


def traced_step(step, params, opt_state, batch, kernels: dict) -> dict:
    """One more step under ``torch.profiler`` (after the counted ones):
    wall ms, device busy ms and share, the device ms of each named group
    of kernels, the costliest device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, top, per = device_time(prof, 6)
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / wall_us,
                kernel_ms={k: kernel_us(per, names) / 1e3
                           for k, names in kernels.items()}, top=top)


def trace_text(t: dict) -> str:
    return (f"a traced step: wall {t['wall_ms']:.2f} ms, device busy "
            f"{t['busy_ms']:.2f} ms ({t['busy_share']:.1%}); "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in t["kernel_ms"].items())
            + "; costliest " + "; ".join(f"{k[:50]} {v:.3f} ms"
                                         for k, v in t["top"])
            + ("" if t["busy_ms"] > 0 else
               " FINDING: the trace holds no device event"))


def loss_fell(losses) -> bool:
    return sum(losses[-3:]) / 3 < losses[0]


def spmm_bwd_library(nbrs, feat, w, dout, combine):
    """The same function as ``packed_spmm_bwd`` in PyTorch library calls,
    the lane index precomputed: ``index_add_`` for agg and dfeat,
    ``torch.matmul`` for ``dout @ w^T`` and ``agg^T @ dout``."""
    import torch

    Nf = feat.shape[0]
    ok = nbrs < Nf
    N, M = nbrs.shape
    lanes = torch.arange(N, device=nbrs.device)[:, None].expand(N, M)[ok]
    rows = nbrs.long().clamp(min=0)[ok]
    cnt = torch.clamp(ok.sum(1, keepdim=True), min=1).float()

    def run():
        agg = torch.zeros((N, feat.shape[1]), device=feat.device)
        agg.index_add_(0, lanes, feat[rows])
        g = dout @ w.T
        if combine == "mean":
            agg = agg / cnt
            g = g / cnt
        dfeat = torch.zeros_like(feat).index_add_(0, rows, g[lanes])
        return dfeat, agg.T @ dout

    return run


def check_spmm_bwd(name, nbrs, feat, w, dout, combine="mean") -> dict:
    """``packed_spmm_bwd`` at a path's shape against its plain version
    (within SPMM_BWD_TOL of |terms|, a repeat bit for bit), timed beside
    the plain version and :func:`spmm_bwd_library`: ``ms`` a call that
    builds its own plan, ``plan_ms`` a call on a plan built before (a
    step's layer: both layers share the batch's plan); the bound: G's rows
    read once a lane, dfeat written once and the ids read (bytes), dW's
    operations over the rows with a child at the TF32 rate."""
    import torch

    from repro_torch.kernels import _build, segment_matmul as SM

    with _build.recording():
        got = SM.packed_spmm_bwd(nbrs, feat, w, dout, combine=combine)
        again = SM.packed_spmm_bwd(nbrs, feat, w, dout, combine=combine)
        want = SM.packed_spmm_bwd_plain(nbrs, feat, w, dout, combine=combine)
        tol = SM.packed_spmm_bwd_plain(nbrs, feat.abs(), w.abs(), dout.abs(),
                                       combine=combine)
        torch.cuda.synchronize()
        ratio = max(float(((g - p).abs() / (SPMM_BWD_TOL * t + TINY)).max())
                    for g, p, t in zip(got, want, tol))
        err = max(float((g - p).abs().max()) for g, p in zip(got, want))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again, want, tol
        ms = cuda_ms(lambda: SM.packed_spmm_bwd(nbrs, feat, w, dout,
                                                combine=combine), 10)
        plan = SM.SpmmPlan(nbrs, feat.shape[0]).build()
        plan_ms = cuda_ms(lambda: SM.packed_spmm_bwd(
            nbrs, feat, w, dout, combine=combine, plan=plan), 10)
        del plan
        plain_ms = cuda_ms(lambda: SM.packed_spmm_bwd_plain(
            nbrs, feat, w, dout, combine=combine), 3)
        lib_ms = cuda_ms(spmm_bwd_library(nbrs, feat, w, dout, combine), 10)
    (N, M), (Nf, d), f = nbrs.shape, feat.shape, w.shape[1]
    ok = nbrs < Nf
    lanes, rows = int(ok.sum()), int(ok.any(1).sum())
    nbytes = lanes * 4 * d + Nf * 4 * d + N * M * 4
    b_ms, b_by = bound(nbytes, 2 * rows * d * f, TF32_OPS_PER_S)
    if not (ratio <= 1 and bitwise
            and all(bool(torch.isfinite(g).all()) for g in got)):
        raise AssertionError(f"packed_spmm_bwd {name}: err/tol {ratio}, "
                             f"repeat bit for bit {bitwise}")
    return dict(shape=name, max_abs_err=err, err_over_tol=ratio,
                bit_equal_repeat=bitwise, ms=ms, plan_ms=plan_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, lanes=lanes, rows_with_children=rows,
                bytes=nbytes)


def check_bag_bwd(name, ids, dout, V, combine="mean") -> dict:
    """``embedding_bag_bwd`` at the path's shape against its plain version
    in float64 (within BAG_BWD_TOL of |terms|, a repeat bit for bit),
    timed beside the plain version and autograd's backward of
    ``F.embedding_bag``; the bound: dtable written once, dout and the ids
    read once (bytes), one add a lookup's element at the fp32 rate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, embedding_bag as EB

    B, bag = ids.shape
    E = dout.shape[1]
    with _build.recording():
        got = EB.embedding_bag_bwd(ids, dout, V, combine=combine)
        again = EB.embedding_bag_bwd(ids, dout, V, combine=combine)
        bitwise = bool(torch.equal(got, again))
        del again
        want = EB.embedding_bag_bwd_plain(ids, dout.double(), V,
                                          combine=combine)
        err = float((got.double() - want).abs().max())
        want -= got.double()
        diff = want.abs_()
        del want
        tol = EB.embedding_bag_bwd_plain(ids, dout.abs(), V, combine=combine)
        ratio = float((diff / (BAG_BWD_TOL * tol.double() + TINY)).max())
        read = torch.zeros(V, dtype=torch.bool, device=ids.device)
        read[ids.long().clamp(0, V - 1).flatten()] = True
        zeros_ok = bool((got[~read] == 0).all())
        del read
        del diff, tol
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: EB.embedding_bag_bwd(ids, dout, V,
                                                  combine=combine), 5)
        plain_ms = cuda_ms(lambda: EB.embedding_bag_bwd_plain(
            ids, dout, V, combine=combine), 2)
        leaf = torch.zeros((V, E), device=dout.device, requires_grad=True)
        out = F.embedding_bag(ids.long(), leaf, mode=combine)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out, leaf, dout,
                                                     retain_graph=True), 5)
        del out, leaf, got
        torch.cuda.empty_cache()
    distinct = int(torch.unique(ids).numel())
    nbytes = V * E * 4 + B * E * 4 + B * bag * 4
    b_ms, b_by = bound(nbytes, B * bag * E)
    if not (ratio <= 1 and bitwise and zeros_ok):
        raise AssertionError(f"embedding_bag_bwd {name}: err/tol {ratio}, "
                             f"repeat bit for bit {bitwise}, unread rows "
                             f"zero {zeros_ok}")
    return dict(shape=name, max_abs_err=err, err_over_tol=ratio,
                bit_equal_repeat=bitwise, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                distinct_rows=distinct, bytes=nbytes)


def sage_train_drill(dev, gen) -> tuple:
    """(a): ``graphsage_reddit`` at ``minibatch_lg``, nothing cut: phase
    16's Reddit graph and sampler, fp32, TF32 off; the gradient gate on
    the first batch (the kernel path's gradient tree against a float64
    run of the edge list on the card, beside the float32 plain path; the
    backward without the mean's 1/c_i planted; a repeat bit for bit);
    then FAMILY_STEPS AdamW steps on that batch with every counter at 0
    just before and read just after; the host's sampling and copy of
    GNN_BATCHES batches.  Returns (results, launches, packed_spmm_bwd's
    rows at the path's shapes)."""
    import statistics

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import make_community_graph
    from repro_torch.data.sampler import SampledStream
    from repro_torch.kernels import _build, segment_matmul as SM
    from repro_torch.models import gnn as G
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.train.trainer import _grads_of, make_train_step

    cfg = get_arch("graphsage-reddit")
    stream = KEPT.pop("sage_stream", None)
    if stream is None:
        stream = SampledStream(make_community_graph(
            GNN_NODES, GNN_EDGES, GNN_FEAT, n_classes=GNN_CLASSES, seed=0),
            GNN_BATCH_NODES, GNN_FANOUTS, seed=0)
    tree = init_all(G.schema(cfg, GNN_FEAT, GNN_CLASSES), gen, dev)
    loss = lambda p, b: G.loss_fn(p, cfg, b)   # noqa: E731
    batch, s_ms, c_ms = next(host_batches(stream, dev, 1))
    s_ms, c_ms = [s_ms], [c_ms]
    N, M = batch["neighbors"].shape
    out: dict = dict(N=N, M=M, E=int(batch["edge_src"].shape[0]))

    # the gate, on the first batch (comparisons: recorded, not counted)
    with _build.recording():
        g_k, _ = _grads_of(loss, tree, batch)
        g_k2, _ = _grads_of(loss, tree, batch)
    bitwise = all(torch.equal(a, b) for a, b in zip(tree_leaves(g_k),
                                                    tree_leaves(g_k2)))
    del g_k2
    with _build.recording():
        g_p, _ = _grads_of(lambda p, b: G.loss_fn(
            p, cfg, b, kernel_backend="torch"), tree, batch)
        b64 = {k: v.double() if v.is_floating_point() else v
               for k, v in batch.items() if k != "neighbors"}
        g_64, _ = _grads_of(loss, moved(tree, dev, torch.float64), b64)
        del b64
        real = SM.packed_spmm_bwd
        SM.packed_spmm_bwd = lambda *a, **kw: real(*a, **dict(
            kw, combine="sum"))
        try:
            g_f, _ = _grads_of(loss, tree, batch)
        finally:
            SM.packed_spmm_bwd = real
    err_k, err_p, err_f = (tree_err(g, g_64) for g in (g_k, g_p, g_f))
    limit = 2 * err_p + GNN_EPS
    gate = dict(err_kernel=err_k, err_plain32=err_p, limit=limit,
                planted_err=err_f, ok=err_k <= limit,
                planted_rejected=err_f > limit, bit_equal_repeat=bitwise)
    del g_k, g_p, g_64, g_f
    torch.cuda.empty_cache()

    # the backward kernel alone at each layer's shape, on this batch
    rows = []
    for i, (nbrs, h, w) in enumerate(layer_inputs(G.GNN(cfg, tree), cfg,
                                                  batch)):
        dout = torch.randn((N, w.shape[1]), generator=gen, device=dev)
        rows.append(check_spmm_bwd(
            f"graphsage minibatch_lg layer {i}: N=Nf={N} M={M} "
            f"[{h.shape[0]}, {h.shape[1]}] @ [{w.shape[0]}, {w.shape[1]}] "
            "mean", nbrs, h.detach(), w.detach(), dout))

    # the host's sampling and copy of further batches
    for _, s2, c2 in host_batches(stream, dev, GNN_BATCHES - 1):
        s_ms, c_ms = s_ms + [s2], c_ms + [c2]

    # the steps, on batch 0 (as the launcher repeats its graph: the loss
    # falls by descent, not by a batch that happens to be easier)
    opt = family_opt(FAMILY_STEPS)
    step = make_train_step(loss, opt)
    params = tree
    opt_state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, ms, _, _ = timed_steps(step, params, opt_state,
                                   ((batch, 0.0, 0.0)
                                    for _ in range(FAMILY_STEPS)))
    torch.cuda.synchronize()
    launches = K.launch_counts()
    median = statistics.median(ms[1:])
    out.update(gate=gate, losses=losses, step_ms=ms, median_step_ms=median,
               nodes_per_s=N / median * 1e3, sample_ms=s_ms, copy_ms=c_ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    out["trace"] = traced_step(step, params, opt_state, batch, {
        "packed_spmm": SPMM_KERNELS[:1],
        "packed_spmm_bwd": SPMM_BWD_KERNELS + SPMM_KERNELS[1:]})
    del params, opt_state, tree, stream, batch
    torch.cuda.empty_cache()
    return out, launches, rows


def wide_deep_train_drill(dev, gen) -> tuple:
    """(b): ``wide_deep`` at ``train_batch`` (B = 65,536) as published:
    49.36 M rows of 32, fp32, TF32 off, ``CTRStream(seed=0)``.  The gate
    on the first batch: each bag field's dtable on the kernel path
    against its plain version in float64 on the same dout (the bag
    contract), the kernel path's repeat bit for bit on the bag tables;
    then FAMILY_STEPS AdamW steps with every counter at 0 just before and
    read just after.  Returns (results, launches, embedding_bag_bwd's
    row at the path's shape)."""
    import statistics

    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import CTRStream
    from repro_torch.kernels import _build, embedding_bag as EB
    from repro_torch.models import recsys as R
    from repro_torch.models.module import init_params, param_bytes
    from repro_torch.train.trainer import _grads_of, make_train_step

    cfg = get_arch("wide-deep")
    nbytes = param_bytes(R.schema(cfg))
    log(f"[family] (b) wide_deep: {sum(cfg.vocab_sizes)} rows of "
        f"{cfg.embed_dim} in {cfg.n_sparse} tables ({nbytes / 1e9:.2f} GB "
        f"fp32), bag fields {list(cfg.multi_hot_fields)} of "
        f"{cfg.bag_size}; reckoned: parameters {nbytes / 1e9:.2f} GB, dense "
        f"gradients {nbytes / 1e9:.2f}, AdamW state {2 * nbytes / 1e9:.2f}, "
        f"and one more copy of parameters and state during the update "
        f"{3 * nbytes / 1e9:.2f}: {7 * nbytes / 2 ** 30:.1f} GiB before "
        "activations")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(R.schema(cfg), gen, dev)
    loss = lambda p, b: R.loss_fn(p, cfg, b)   # noqa: E731
    stream = CTRStream(cfg, FAMILY_BAG_BATCH, seed=0)
    batch, s_ms, c_ms = next(host_batches(stream, dev, 1))
    multi = list(cfg.multi_hot_fields)

    # the gate: the kernel path's bag gradients, twice, and the dout each
    # backward launch saw
    seen = []
    real = EB.embedding_bag_bwd

    def spy(ids, dout, V, **kw):
        seen.append((ids, dout))
        return real(ids, dout, V, **kw)

    EB.embedding_bag_bwd = spy
    try:
        with _build.recording():
            g1, _ = _grads_of(loss, params, batch)
            bags1 = [g1["tables"][f"field_{i}"] for i in multi]
            del g1
            g2, _ = _grads_of(loss, params, batch)
            bags2 = [g2["tables"][f"field_{i}"] for i in multi]
            del g2
    finally:
        EB.embedding_bag_bwd = real
    bitwise = all(torch.equal(a, b) for a, b in zip(bags1, bags2))
    del bags2
    torch.cuda.empty_cache()
    # autograd runs the fields' backward in its own order: pair each with
    # its field by the ids it saw
    fields = []
    for j, i in enumerate(multi):
        ids, dout = next((a, b) for a, b in seen
                         if torch.equal(a, batch["bags"][:, j]))
        want = EB.embedding_bag_bwd_plain(ids, dout.double(),
                                          cfg.vocab_sizes[i])
        want -= bags1[j].double()
        diff = want.abs_()
        del want
        tol = BAG_BWD_TOL * EB.embedding_bag_bwd_plain(
            ids, dout.abs(), cfg.vocab_sizes[i]).double() + TINY
        fields.append(float((diff / tol).max()))
        del diff, tol
        torch.cuda.empty_cache()
    bag_row = check_bag_bwd(
        f"wide_deep bag field {multi[0]}: [{cfg.vocab_sizes[multi[0]]}, "
        f"{cfg.embed_dim}] fp32, B={FAMILY_BAG_BATCH} x {cfg.bag_size}, "
        "mean (CTRStream seed 0)", *next(
            (a, b) for a, b in seen if torch.equal(a, batch["bags"][:, 0])),
        cfg.vocab_sizes[multi[0]])
    del bags1, seen
    torch.cuda.empty_cache()
    gate = dict(field_err_over_tol=fields, bit_equal_repeat=bitwise,
                ok=max(fields) <= 1 and bitwise)

    # the steps
    opt = family_opt(FAMILY_STEPS)
    step = make_train_step(loss, opt)
    opt_state = opt.init(params)
    K.reset_launch_counts()
    losses, ms, sample, copy = timed_steps(
        step, params, opt_state, host_batches(stream, dev, FAMILY_STEPS))
    torch.cuda.synchronize()
    launches = K.launch_counts()
    median = statistics.median(ms[1:])
    trace = traced_step(step, params, opt_state, batch, {
        "embedding_bag": BAG_KERNELS,
        "embedding_bag_bwd": BWD_GROUP_KERNELS})
    out = dict(gate=gate, losses=losses, step_ms=ms, median_step_ms=median,
               trace=trace,
               rows_per_s=FAMILY_BAG_BATCH / median * 1e3,
               sample_ms=[s_ms] + sample, copy_ms=[c_ms] + copy,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               param_gb=nbytes / 1e9, launches=launches,
               bag_fields=len(multi))
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return out, launches, bag_row


def mace_forces(model_tree, cfg, batch):
    """-dE/dpositions of the summed energies (no graph kept)."""
    import torch

    from repro_torch.models import mace as MC

    with torch.enable_grad():
        pos = batch["positions"].detach().requires_grad_()
        e = MC.forward(model_tree, cfg, dict(batch, positions=pos)).sum()
        return -torch.autograd.grad(e, pos)[0]


def pooled_gate(gates: list) -> dict:
    """:func:`gate64` over several draws: the card's and the CPU float32
    run's largest errors each taken over every draw, the limit from those
    and the largest scale."""
    import math

    err = max(g["err_card"] for g in gates)
    err32 = max(g["err_cpu32"] for g in gates)
    scale = max(g["scale"] for g in gates)
    limit = 2 * err32 + GNN_EPS * scale
    return dict(err_card=err, err_cpu32=err32, scale=scale, limit=limit,
                ok=all(math.isfinite(g["err_card"]) for g in gates)
                and err <= limit)


def mace_force_gate(tree, cfg, host: dict, dev) -> dict:
    """MACE's forces ``-dE/dx`` on the card against a float64 run on the
    card, :func:`gate64` pooled over MACE_FORCE_DRAWS positions (x, then
    x Q^T + t for seeded proper rotations Q and the shifts
    MACE_FORCE_SHIFTS; float32 positions, the float64 run on the same
    values), the float32 yardstick on the CPU; and the float64 forces
    rotate with the molecule, F(x Q^T + t) = F(x) Q^T, x moved in
    float64."""
    import numpy as np
    import torch

    from repro_torch.models.module import batch_to

    batch, cpu = batch_to(host, dev), batch_to(host, "cpu")
    tree32, tree64 = moved(tree, "cpu"), moved(tree, dev, torch.float64)

    def forces64(pos):
        return mace_forces(tree64, cfg, {
            k: v.double() if v.is_floating_point() else v
            for k, v in dict(batch, positions=pos.to(dev)).items()}).cpu()

    x = host["positions"]
    rng = np.random.default_rng(16)
    draws, rot_errs, f0 = [], [], None
    for k in range(MACE_FORCE_DRAWS):
        if k == 0:
            pos = x
        else:
            Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            if np.linalg.det(Q) < 0:
                Q[:, 0] *= -1
            t = MACE_FORCE_SHIFTS[(k - 1) % len(MACE_FORCE_SHIFTS)]
            pos = (x @ Q.T + t).astype(np.float32)
        p = torch.from_numpy(pos)
        ref = forces64(p)
        draws.append(gate64(
            mace_forces(tree, cfg, dict(batch, positions=p.to(dev))),
            mace_forces(tree32, cfg, dict(cpu, positions=p)), ref))
        if k == 0:
            f0 = ref
        else:
            f_rot = forces64(torch.from_numpy(x.astype(np.float64) @ Q.T + t))
            rot_errs.append(float(
                (f_rot - f0 @ torch.from_numpy(Q.T)).abs().max()))
    gate = pooled_gate(draws)
    scale = float(f0.abs().max())
    rot_err = max(rot_errs)
    rot_ok = rot_err <= MACE_FORCE_ROTATION_TOL * scale
    log("[family] (c) mace forces -dE/dx on the card against a float64 "
        f"run at x and {MACE_FORCE_DRAWS - 1} rotated and moved "
        "positions x Q^T + t: max |card - float64| (CPU float32) a draw "
        + ", ".join(f"{g['err_card']:.3g} ({g['err_cpu32']:.3g})"
                    for g in draws)
        + "; pooled " + gate_text(gate) + "; the float64 forces rotate "
        f"with the molecule, max |F(x Q^T + t) - F(x) Q^T| {rot_err:.3g} "
        f"(limit {MACE_FORCE_ROTATION_TOL:g} x {scale:.4g}): "
        + ("ok" if rot_ok else "FAILED"))
    return dict(gate=gate, draws=draws, rotation_err64=rot_err,
                rotation_scale=scale, rotation_ok=rot_ok)


def small_train_drills(dev, gen) -> dict:
    """(c): ``gin_tu`` and ``gatedgcn`` at ``molecule`` and
    ``full_graph_sm``, ``mace`` at ``molecule`` with forces (targets drawn
    from a seeded numpy generator), SMALL_STEPS AdamW steps each, the loss
    falling; MACE's forces on the card against a float64 run (on the card;
    the float32 yardstick on the CPU, :func:`gate64`) at x and rotated and
    moved; the float64 forces rotate with the molecule.  Edge lists: no
    kernel launches."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import GNN_N_CLASSES, GNN_SHAPES, get_arch
    from repro_torch.data.graphs import (make_community_graph,
                                         make_molecules,
                                         molecule_batch_for_gnn)
    from repro_torch.models import gnn as G
    from repro_torch.models import mace as MC
    from repro_torch.models.module import batch_to
    from repro_torch.train.trainer import make_train_step

    mol, full = GNN_SHAPES["molecule"].dims, GNN_SHAPES["full_graph_sm"].dims
    graphs = {
        "molecule": molecule_batch_for_gnn(
            mol["batch"], mol["n_nodes"], mol["n_edges"],
            n_classes=GNN_N_CLASSES["molecule"], seed=0),
        "full_graph_sm": make_community_graph(
            full["n_nodes"], full["n_edges"], full["d_feat"],
            n_classes=GNN_N_CLASSES["full_graph_sm"], seed=0)}
    out = {}

    def train(label, schema, loss, batch):
        tree = init_all(schema, gen, dev)
        opt = family_opt(SMALL_STEPS)
        step = make_train_step(loss, opt)
        batches = ((batch, 0.0, 0.0) for _ in range(SMALL_STEPS))
        losses, ms, _, _ = timed_steps(step, tree, opt.init(tree), batches)
        r = out[label] = dict(losses=losses, step_ms=ms,
                              median_step_ms=statistics.median(ms[1:]),
                              fell=loss_fell(losses))
        log(f"[family] (c) {label}: {SMALL_STEPS} steps, loss "
            + " ".join(f"{x:.4f}" for x in losses)
            + f" ({'falls' if r['fell'] else 'DOES NOT FALL'}); step "
            f"{r['median_step_ms']:.2f} ms")
        return tree

    for arch, shape in (("gin-tu", "molecule"), ("gatedgcn", "molecule"),
                        ("gin-tu", "full_graph_sm"),
                        ("gatedgcn", "full_graph_sm")):
        cfg = get_arch(arch)
        host = graphs[shape]
        train(f"{arch} {shape}", G.schema(cfg, host["node_feat"].shape[1],
                                          GNN_N_CLASSES[shape]),
              lambda p, b, c=cfg: G.loss_fn(p, c, b), batch_to(host, dev))
    cfg = get_arch("mace")
    host = make_molecules(mol["batch"], mol["n_nodes"], mol["n_edges"],
                          seed=0)
    host["forces"] = np.random.default_rng(18).normal(
        size=host["positions"].shape).astype(np.float32)
    batch = batch_to(host, dev)
    tree = train("mace molecule, forces", MC.schema(cfg),
                 lambda p, b: MC.loss_fn(p, cfg, b), batch)
    out["mace forces"] = mace_force_gate(tree, cfg, host, dev)
    return out


def resume_drivers(tmp: str, dev) -> dict:
    """(d): ``launch/train.py --arch graphsage-reddit --reduced`` and
    ``--arch wide-deep --reduced``: 20 steps (checkpoints at 10 and 20),
    then a restart from the step-10 checkpoint alone with ``--resume``;
    its step-20 checkpoint against the uninterrupted one, file for file.
    The launcher's ``main`` runs in this process (its output captured), on
    the card (``--device cpu`` in a CPU rehearsal)."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from repro_torch.launch import train as launcher

    where = [] if dev.type == "cuda" else ["--device", "cpu"]

    def run(arch: str, d: str, resume: bool) -> tuple:
        argv, text = sys.argv, io.StringIO()
        sys.argv = ["train", "--arch", arch, "--reduced", "--steps", "20",
                    "--ckpt-dir", d, *where] + (["--resume"] if resume
                                                else [])
        rc = 0
        try:
            with contextlib.redirect_stdout(text):
                launcher.main()
        except (Exception, SystemExit) as e:   # the drill reports it
            rc = 1
            text.write(f"\n{type(e).__name__}: {e}")
        finally:
            sys.argv = argv
        return rc, text.getvalue()

    out = {}
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for arch in ("graphsage-reddit", "wide-deep"):
        pa, pb = (os.path.join(tmp, arch, x) for x in "ab")
        first = run(arch, pa, False)
        if os.path.isdir(os.path.join(pa, "step_00000010")):
            shutil.copytree(os.path.join(pa, "step_00000010"),
                            os.path.join(pb, "step_00000010"))
            with open(os.path.join(pb, "latest"), "w") as f:
                f.write("step_00000010")
        second = run(arch, pb, True)
        sa, sb = (os.path.join(x, "step_00000020") for x in (pa, pb))
        equal = os.path.isdir(sa) and os.path.isdir(sb) and sorted(
            os.listdir(sa)) == sorted(os.listdir(sb)) and all(
            np.array_equal(np.load(os.path.join(sa, n)),
                           np.load(os.path.join(sb, n)))
            for n in os.listdir(sa) if n.endswith(".npy"))
        out[arch] = dict(rc=(first[0], second[0]),
                         resumed="resumed from step 10" in second[1],
                         bitwise_equal=equal,
                         last=[x for x in second[1].strip().splitlines()
                               if x][-1:])
        with open(os.path.join(out_dir, f"smoke_resume_{arch}.log"),
                  "w") as f:
            f.write(first[1] + "\n---- --resume ----\n" + second[1])
    return out


def bwd_breakdown(dev) -> dict:
    """One call of each backward kernel at its path's shape, traced launch
    by launch in a fresh process (``tools/bwd_trace.py``; the smoke's late
    traces lose device events): its ``[breakdown]`` lines, its output in
    ``chiprun_out/smoke_bwd_trace.log``.  Returns its JSON line."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    where = [] if dev.type == "cuda" else ["--device", "cpu"]
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "tools", "bwd_trace.py"),
         *where], env=env, capture_output=True, text=True,
        timeout=TRAIN_TIMEOUT)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "smoke_bwd_trace.log"), "w") as f:
        f.write(p.stdout + p.stderr)
    if p.returncode != 0:
        raise AssertionError(f"[family] tools/bwd_trace.py exited "
                             f"{p.returncode}: {p.stderr[-2000:]}")
    lines = p.stdout.strip().splitlines()
    for line in lines:
        if line.startswith("[breakdown]"):
            log("[family] " + line)
    return json.loads(lines[-1])


def family_phase(dev) -> tuple:
    """Phase 18, with phase 17's state released: (a) GraphSAGE at
    minibatch_lg and (b) Wide & Deep at B = 65,536, both at published
    width, training on the backward kernels of packed_spmm and
    embedding_bag (launches counted), each with its gradient gate; (c)
    GIN and GatedGCN at molecule and full_graph_sm, MACE at molecule
    with forces; (d) the launcher's resume.  Returns (results, the main
    paths' launch counts, {kernel: rows})."""
    import tempfile

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False    # the models are fp32
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    out: dict = {}
    fails = []

    t0 = time.perf_counter()
    a, a_launches, spmm_rows = sage_train_drill(dev, gen)
    out["sage"] = a
    g = a["gate"]
    log(f"[family] (a) graphsage_reddit minibatch_lg: N={a['N']} M={a['M']}"
        f" E={a['E']}; the gate on batch 0 against a float64 run of the "
        f"edge list on the card: gradient tree's global relative error "
        f"kernel {g['err_kernel']:.4g}, float32 plain path "
        f"{g['err_plain32']:.4g} (limit 2x + {GNN_EPS:g} = "
        f"{g['limit']:.4g}): " + ("ok" if g["ok"] else "FAILED")
        + f"; planted fault (the backward without the mean's 1/c_i) "
        f"{g['planted_err']:.4g}: "
        + ("rejected" if g["planted_rejected"] else "LET THROUGH")
        + f"; a repeat bit for bit: {g['bit_equal_repeat']}")
    for r in spmm_rows:
        log_kernel("packed_spmm_bwd", r, f" err/tol={r['err_over_tol']:.3f}"
                   f"; ms a call that builds its own plan, "
                   f"plan_ms={r['plan_ms']:.4f} on the batch's plan; "
                   f"{r['rows_with_children']} rows with a child, "
                   f"{r['lanes']} lanes; library = index_add_ + "
                   "torch.matmul")
    log(f"[family] (a) {FAMILY_STEPS} steps (AdamW lr 1e-3, warmup 5): "
        "loss " + " ".join(f"{x:.4f}" for x in a["losses"])
        + f"; step {a['median_step_ms']:.3f} ms (median of steps 2-"
        f"{FAMILY_STEPS}, CUDA events around the step; first "
        f"{a['step_ms'][0]:.3f}), {a['nodes_per_s']:.0f} nodes/s; sampling "
        f"{min(a['sample_ms']):.1f}-{max(a['sample_ms']):.1f} ms and copy "
        f"{min(a['copy_ms']):.1f}-{max(a['copy_ms']):.1f} ms a batch (host);"
        f" peak device memory {a['peak_gib']:.2f} GiB")
    log("[family] (a) " + trace_text(a["trace"]))
    log(f"[launches] phase 18 (a) (the {FAMILY_STEPS} steps) "
        + json.dumps(a_launches))
    # a step: 4 entries a layer's backward and the batch's one plan
    want = dict(packed_spmm=2 * FAMILY_STEPS, packed_spmm_bwd=9 * FAMILY_STEPS)
    if not (g["ok"] and g["planted_rejected"] and g["bit_equal_repeat"]):
        fails.append(f"(a) gate {g}")
    if any(a_launches[k] != v for k, v in want.items()):
        fails.append(f"(a) launches {a_launches}, want {want}")
    if not loss_fell(a["losses"]):
        fails.append(f"(a) loss did not fall: {a['losses']}")
    out["a_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    b, b_launches, bag_row = wide_deep_train_drill(dev, gen)
    out["wide_deep"] = b
    g = b["gate"]
    log(f"[family] (b) wide_deep train_batch B={FAMILY_BAG_BATCH}: each bag "
        f"field's dtable against its plain version in float64 on the same "
        f"dout, err/tol (1e-6 x sum |terms| + 2^-126) "
        + ", ".join(f"{x:.3f}" for x in g["field_err_over_tol"])
        + f"; the bag tables' repeat bit for bit: {g['bit_equal_repeat']}")
    log_kernel("embedding_bag_bwd", bag_row,
               f" err/tol={bag_row['err_over_tol']:.3f}; "
               f"{bag_row['distinct_rows']} distinct rows; library = "
               "autograd of F.embedding_bag (its backward alone)")
    log(f"[family] (b) {FAMILY_STEPS} steps: loss " + " ".join(
        f"{x:.4f}" for x in b["losses"]) + f"; step "
        f"{b['median_step_ms']:.2f} ms (median of steps 2-{FAMILY_STEPS}; "
        f"first {b['step_ms'][0]:.2f}), {b['rows_per_s']:.0f} rows/s; "
        f"CTRStream {min(b['sample_ms']):.1f}-{max(b['sample_ms']):.1f} ms"
        f" and copy {min(b['copy_ms']):.1f}-{max(b['copy_ms']):.1f} ms a "
        f"batch (host); peak device memory {b['peak_gib']:.2f} GiB")
    log("[family] (b) " + trace_text(b["trace"]))
    log(f"[launches] phase 18 (b) (the {FAMILY_STEPS} steps) "
        + json.dumps(b_launches))
    want = dict(embedding_bag=b["bag_fields"] * FAMILY_STEPS,
                embedding_bag_bwd=b["bag_fields"] * FAMILY_STEPS)
    if not g["ok"]:
        fails.append(f"(b) gate {g}")
    if any(b_launches[k] != v for k, v in want.items()):
        fails.append(f"(b) launches {b_launches}, want {want}")
    if not loss_fell(b["losses"]):
        fails.append(f"(b) loss did not fall: {b['losses']}")
    out["b_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["breakdown"] = bwd_breakdown(dev)
    out["breakdown_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["small"] = small = small_train_drills(dev, gen)
    for k, r in small.items():
        if "fell" in r and not r["fell"]:
            fails.append(f"(c) {k}: loss did not fall")
    f = small["mace forces"]
    if not (f["gate"]["ok"] and f["rotation_ok"]):
        fails.append(f"(c) mace forces {f}")
    out["c_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out["resume"] = res = resume_drivers(tmp, dev)
    for a_, r in res.items():
        log(f"[family] (d) launch/train.py --arch {a_} --reduced: exit "
            f"{r['rc'][0]}, then --resume from step 10 exit {r['rc'][1]} "
            f"(resumed: {r['resumed']}); step 20's checkpoint "
            + ("equals the uninterrupted run's bit for bit"
               if r["bitwise_equal"] else "DIFFERS from the uninterrupted "
               "run's") + f"; {r['last'][0] if r['last'] else ''}")
        if r["rc"] != (0, 0) or not (r["resumed"] and r["bitwise_equal"]):
            fails.append(f"(d) {a_}: {r}")
    out["d_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[family] phase 18: {out['seconds']:.1f} s ((a) {out['a_s']:.1f}, "
        f"(b) {out['b_s']:.1f}, the breakdown {out['breakdown_s']:.1f}, "
        f"(c) {out['c_s']:.1f}, (d) {out['d_s']:.1f})")
    if fails:
        raise AssertionError("[family] " + "; ".join(fails))
    launches = {k: a_launches[k] + b_launches[k] for k in a_launches}
    return out, launches, {"packed_spmm_bwd": spmm_rows,
                           "embedding_bag_bwd": [bag_row]}


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
    return sum(per.values()), [(k, v / 1e3) for k, v in top], per


def kernel_us(per: dict, names) -> float:
    """Device us of the kernels ``names`` (their template instances too)
    in ``device_time``'s per-kernel map, wherever they rank: the trace
    names them ``...namespace)::<name><`` or ``(``."""
    return sum(v for k, v in per.items() if any(
        f"namespace)::{t}{c}" in k for t in names for c in "<("))


def traced(label: str, fn) -> dict:
    """One synchronised call of ``fn`` under ``torch.profiler``: wall ms,
    device busy ms and share, the costliest device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, top, per = device_time(prof)
    topk_us = kernel_us(per, TOPK_KERNELS)
    hop_ms = {k: kernel_us(per, (k,)) / 1e3 for k in HOP_KERNELS}
    tile_ms = kernel_us(per, ("dm_kernel",)) / 1e3
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.1%}); topk.cu "
        f"{topk_us / 1e3:.2f} ms; search hop "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in hop_ms.items())
        + f"; block.cu tile (the delta scan) {tile_ms:.2f} ms; top "
        + "; ".join(f"{k[:48]} {t:.2f} ms" for k, t in top))
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                busy_share=busy / wall_us, topk_ms=topk_us / 1e3,
                hop_ms=hop_ms, tile_ms=tile_ms, top_ms=top)


def profile_run(ds, index, cfg, n_queries, dev) -> dict:
    import torch

    from repro_torch.ann import Index, build_graph
    from repro_torch.core import metrics as M
    from repro_torch.core.knn_build import nn_descent

    out = {"build": traced("build", lambda: build_graph(ds.X, cfg,
                                                         device=dev))}
    for visited in ("none", "hash"):
        idx_v = Index(ds.X, dataclasses.replace(cfg, visited_filter=visited),
                      graph=index.graph, device=dev)
        for B in (10, n_queries):
            Q = ds.Q[:B]
            idx_v.search(Q)
            torch.cuda.synchronize()
            out[f"{visited}_B{B}"] = traced(f"visited={visited} B={B}",
                                            lambda: idx_v.search(Q))
    Q = ds.Q[:n_queries]
    for visited in ("none", "hash"):   # int8 residency, the large regime
        idx_v = Index(ds.X, dataclasses.replace(
            cfg, visited_filter=visited, quantization="int8"),
            graph=index.graph, device=dev)
        idx_v.search(Q)
        torch.cuda.synchronize()
        out[f"int8_{visited}_B{n_queries}"] = traced(
            f"int8 visited={visited} B={n_queries}", lambda: idx_v.search(Q))
    del idx_v
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
    if args.n & (args.n - 1):
        ap.error("--n must be a power of two (phase 9 sorts rows of n lanes)")

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
    from repro_torch.ann.quantize import quantize_rows
    from repro_torch.configs.base import ANNConfig
    from repro_torch.data.synthetic import make_clustered, recall_at_k
    from repro_torch.kernels import (_build, block, embedding_bag,
                                     flash_attention, l2dist,
                                     segment_matmul, topk, visited)

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
    record["topk_bodies"] = topk.body_attributes()
    log("[build] topk.cu kernels (registers, spilled bytes) a thread: "
        + json.dumps(record["topk_bodies"]))
    record["flash_attention_bodies"] = flash_attention.body_attributes()
    log("[build] flash_attention.cu kernels (registers, spilled bytes) a "
        "thread: " + json.dumps(record["flash_attention_bodies"]))
    record["flash_attention_bwd_bodies"] = \
        flash_attention.bwd_body_attributes()
    log("[build] flash_attention_bwd.cu kernels (registers, spilled bytes) "
        "a thread: " + json.dumps(record["flash_attention_bwd_bodies"]))
    record["l2dist_bodies"] = l2dist.body_attributes()
    log("[build] l2dist.cu self-query and int8 row kernels (registers, "
        "spilled bytes) a thread: " + json.dumps(record["l2dist_bodies"]))
    record["visited_bodies"] = visited.body_attributes()
    log("[build] visited.cu kernels (registers, spilled bytes) a thread: "
        + json.dumps(record["visited_bodies"]))
    record["block_bodies"] = block.body_attributes()
    log("[build] block.cu tile kernels, the block's and the matrix's "
        "(registers, spilled bytes) a thread: "
        + json.dumps(record["block_bodies"]))
    record["bag_bodies"] = embedding_bag.body_attributes()
    log("[build] embedding_bag.cu kernels, the lane body and the vector "
        "body at each group width (registers, spilled bytes) a thread: "
        + json.dumps(record["bag_bodies"]))
    record["spmm_bodies"] = segment_matmul.body_attributes()
    log("[build] segment_matmul.cu kernels, fused, projection, gather and "
        "the copy of listed rows (registers, spilled bytes) a thread: "
        + json.dumps(record["spmm_bodies"]))
    record["bwd_group_bodies"] = {
        "segment_matmul_bwd": segment_matmul.bwd_body_attributes(),
        "embedding_bag_bwd": embedding_bag.bwd_body_attributes()}
    log("[build] segment_matmul_bwd.cu and embedding_bag_bwd.cu kernels, "
        "the grouping, the sums, the zeros and dW (registers, spilled "
        "bytes) a thread: " + json.dumps(record["bwd_group_bodies"]))
    record["sass_hmma"] = sass = sass_hmma()
    for source, counts in sass.items():
        log(f"[sass] HMMA instructions a {source}.cu kernel (cuobjdump "
            f"-sass): " + json.dumps(counts))
    if not sass:
        log("[sass] cuobjdump not found")
    else:   # every tensor-core body holds HMMA
        want = {"flash_attention": [b for b in flash_attention.BODIES
                                    if b.startswith("tile_")],
                "l2dist": l2dist.SELFQ_BODIES, "block": block.DM_BODIES,
                "segment_matmul": segment_matmul.PROJECT_BODIES,
                "flash_attention_bwd": flash_attention.BWD_BODIES}
        idle = [f"{src}:{b}" for src, bodies in want.items()
                for b in bodies if sass[src].get(b, 0) == 0]
        if idle:
            raise AssertionError(f"tensor-core bodies without HMMA: {idle}")

    # ---- phase 2: kernels vs plain versions at the main path's shapes ----
    n, d = args.n, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    Xr = torch.randn((n, d), generator=gen, device=dev)
    xn = (Xr.double() ** 2).sum(1)
    cfg = ANNConfig()
    small_S = 32 * cfg.small_t0          # B = 10 pads to bucket 32
    shapes = {"gather_distances": [], "gather_distances_int8": [],
              "rank_merge": [], "visited_filter": [], "block_distances": [],
              "block_distances_int8": []}
    for args_g in (("hop small", small_S, 1, cfg.max_degree, False),
                   ("hop large", args.queries, 1, cfg.max_degree, False),
                   ("nn_descent init", n, 1, cfg.k_graph, False),
                   ("nn_descent cand", n, 1,
                    cfg.k_graph + cfg.k_graph * 8, False),
                   ("relaxed_gd self-q", 2048, None, cfg.k_graph, True),
                   ("soft_gd self-q", 2048, None, 2 * cfg.k_graph, True)):
        shapes["gather_distances"].append(check_gather(Xr, xn, *args_g,
                                                       gen=gen))
    record["diversify_agreement"] = agree = check_diversify(dev, cfg, gen)
    log("[diversify] one 2048-node tile, kernel against backend=\"torch\": "
        + ", ".join(f"{k} equal {v:.4%}" for k, v in agree.items())
        + f" (limit {DIVERSIFY_AGREEMENT:.0%})")
    if min(agree.values()) < DIVERSIFY_AGREEMENT:
        raise AssertionError(f"diversify decisions disagree: {agree}")
    B_l = args.queries
    quant = quantize_rows(Xr)
    xn8 = ((quant[0].double() * quant[1].double()[:, None]) ** 2).sum(1)
    for args_g in (("hop small", small_S, 1, cfg.max_degree, False),
                   ("hop large", B_l, 1, cfg.max_degree, False),
                   ("seeds large", B_l, 1, cfg.large_n_seeds, False)):
        shapes["gather_distances_int8"].append(check_gather(
            Xr, xn8, *args_g, gen=gen, quant=quant))
    del quant, xn8
    cap = STREAM_ADDS            # the delta capacity of phase 8's adds
    for args_b in (("scan B=32", 1, 32, cap, d),
                   (f"scan B={B_l}", 1, B_l, cap, d),
                   ("general", 2048, 1, 32, d)):
        for q8 in (False, True):
            shapes["block_distances" + ("_int8" if q8 else "")].append(
                check_block(*args_b, quant=q8, dev=dev, gen=gen))
    for args_r in (("small R_temp", small_S, cfg.hop_width, 32),
                   ("small final t0 merge", 32, cfg.small_t0 * 32, 10),
                   ("large seeds", B_l, cfg.large_n_seeds, cfg.large_n_seeds),
                   ("large R merge", B_l, cfg.large_ef + cfg.max_degree,
                    cfg.large_ef),
                   ("large C seeds", B_l * cfg.queue_segments,
                    cfg.segment_size + cfg.large_n_seeds, cfg.segment_size),
                   ("large C merge", B_l * cfg.queue_segments,
                    cfg.segment_size + cfg.max_degree, cfg.segment_size),
                   ("nn_descent merge", n, cfg.k_graph * 10, cfg.k_graph),
                   ("stream int8 delta", B_l, STREAM_ADDS,
                    cfg.rerank_mult * 10),
                   ("stream int8 delta, 32768 slots", B_l, 2 * STREAM_ADDS,
                    cfg.rerank_mult * 10)):
        shapes["rank_merge"].append(check_rank_merge(*args_r, dev=dev,
                                                     gen=gen))
    for args_v in (("small", small_S, cfg.small_hops * cfg.max_degree + 1,
                    cfg.max_degree),
                   ("large", B_l, cfg.large_n_seeds
                    + cfg.large_hops * cfg.max_degree, cfg.max_degree)):
        shapes["visited_filter"].append(check_visited(*args_v, dev=dev,
                                                      gen=gen))
    shapes["visited_filter"].append(check_visited(
        "collisions, 16 buckets", B_l, 0, cfg.max_degree, dev=dev, gen=gen,
        n_buckets=16))
    for kname, rows in shapes.items():
        for r in rows:
            log_kernel(kname, r)
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
    phase_launches: dict = {}
    # the top-k's launches by kernel and shape, per counted step (the
    # wrapper's counters stay one count per launch)
    topk_shapes: dict = {}
    step = [None]
    launch = topk._launch

    def tallied(L, dists, *args):
        # a capture records launches, it runs none: the step's eager
        # warm-up is its search's tally
        if step[0] is not None \
                and not torch.cuda.is_current_stream_capturing():
            key = f"{L.body} [{dists.shape[0]}, {L.W}] -> {L.keep}"
            tally = topk_shapes.setdefault(step[0], {})
            tally[key] = tally.get(key, 0) + 1
        return launch(L, dists, *args)

    topk._launch = tallied

    def counted(label, fn):
        before = K.launch_counts()
        step[0] = label
        out = fn()
        step[0] = None
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

    def check_ids(ids, dists, B, n_ids, what):
        """k finite answers per query, ids in [0, n_ids), no repeats."""
        if ids.shape != (B, 10) or not np.isfinite(dists).all() \
                or not ((ids >= 0) & (ids < n_ids)).all():
            raise AssertionError(f"bad search output ({what})")
        if any(len(set(r)) != len(r) for r in ids.tolist()):
            raise AssertionError(f"duplicate ids ({what})")

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
            check_ids(ids, dists, B, n, f"{visited} B={B}")
            rec = recall_at_k(ids, ds.gt[:B], 10)
            results[(visited, B)] = (ids, rec)
            record[f"search_{visited}_{B}"] = dict(
                regime=regime, latency_ms=dt * 1e3, qps=B / dt,
                recall_at_10=rec)
            log(f"[search] visited={visited} B={B} regime={regime}: "
                f"latency={dt * 1e3:.2f} ms qps={B / dt:.1f} "
                f"recall@10={rec:.4f}")
    phase_launches["3-4"] = K.launch_counts()
    log("[launches] phases 3-4 " + json.dumps(phase_launches["3-4"])
        + " by step " + json.dumps(steps))
    for label in ("build", "warm none B=10", "warm hash B=10",
                  f"warm none B={args.queries}",
                  f"warm hash B={args.queries}"):
        log(f"[topk] {label}: launches by kernel and shape "
            + json.dumps(topk_shapes.get(label, {})))

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

    # ---- phase 7: int8 residency on phase 3's graph ------------------------
    K.reset_launch_counts()
    for visited in ("none", "hash"):
        cfg8 = dataclasses.replace(cfg, visited_filter=visited,
                                   quantization="int8")
        idx8 = Index(ds.X, cfg8, graph=graph, device=dev)
        ref8 = Index(ds.X, dataclasses.replace(cfg8, kernel_backend="torch"),
                     graph=graph, device=dev)
        for B in (10, args.queries):
            Q = ds.Q[:B]
            counted(f"int8 warm {visited} B={B}", lambda: idx8.search(Q))
            t0 = time.perf_counter()
            ids, dists = counted(f"int8 search {visited} B={B}",
                                 lambda: idx8.search(Q))
            dt = time.perf_counter() - t0
            check_ids(ids, dists, B, n, f"int8 {visited} B={B}")
            rec = recall_at_k(ids, ds.gt[:B], 10)
            ids_t, _ = ref8.search(Q)
            rec_t = recall_at_k(ids_t, ds.gt[:B], 10)
            agree = float((ids_t == ids).mean())
            rec32 = record[f"search_{visited}_{B}"]["recall_at_10"]
            record[f"int8_{visited}_{B}"] = dict(
                regime=idx8.regime(B), latency_ms=dt * 1e3, qps=B / dt,
                recall_at_10=rec, recall_fp32=rec32, recall_torch=rec_t,
                id_agreement=agree)
            log(f"[int8] visited={visited} B={B} regime={idx8.regime(B)}: "
                f"latency={dt * 1e3:.2f} ms qps={B / dt:.1f} recall@10="
                f"{rec:.4f} (fp32 {rec32:.4f}); plain path recall "
                f"{rec_t:.4f}, ids equal {agree:.4%}")
            if abs(rec - rec_t) > 0.01 or agree < 0.98:
                raise AssertionError("int8: kernel path and plain path "
                                     "disagree")
        del idx8, ref8
    phase_launches["7"] = K.launch_counts()
    log("[launches] phase 7 " + json.dumps(phase_launches["7"]))

    # ---- phase 8: streaming add / delete / search / compact ---------------
    K.reset_launch_counts()
    record["stream"] = stream_phase(ds, cfg, graph, n, d, args.queries, dev,
                                    counted, check_ids)
    phase_launches["8"] = K.launch_counts()
    log("[launches] phase 8 " + json.dumps(phase_launches["8"]))
    for label in ("stream int8 warm", "stream int8 warm, wide delta"):
        log(f"[topk] {label}: launches by kernel and shape "
            + json.dumps(topk_shapes.get(label, {})))
    launches = {k: sum(p[k] for p in phase_launches.values())
                for k in ANN_BODIES}
    log("[launches] phases 3-4, 7, 8 " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # ---- phase 6: where the device time goes ------------------------------
    record["profile"] = profile_run(ds, index, cfg, args.queries, dev)
    del index, idx_v, results, ref
    torch.cuda.empty_cache()

    # ---- phase 10: serving ------------------------------------------------
    answers: dict = {}
    record["serve"] = serve_phase(ds, cfg, graph, n, d, args.queries, dev,
                                  answers=answers)
    torch.cuda.empty_cache()

    # ---- phase 11: the locality-packed layout and the artifact ------------
    record["layout"], phase_launches["11"] = layout_phase(
        ds, cfg, graph, n, d, args.queries, dev, answers, record["serve"])
    log("[launches] phase 11 " + json.dumps(phase_launches["11"]))
    missing = [k for k in ANN_BODIES if phase_launches["11"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the packed path: "
                             f"{missing}")
    for k in ANN_BODIES:
        launches[k] += phase_launches["11"][k]

    # ---- phase 12: the sharded index -------------------------------------
    record["mesh"], phase_launches["12"] = mesh_phase(
        ds, cfg, graph, n, d, args.queries, dev, answers, record)
    log("[launches] phase 12 " + json.dumps(phase_launches["12"]))
    mesh_bodies = ANN_BODIES + ("gather_distances_bf16",)
    missing = [k for k in mesh_bodies if phase_launches["12"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the sharded path: "
                             f"{missing}")
    for k in mesh_bodies:
        launches[k] = launches.get(k, 0) + phase_launches["12"][k]

    # ---- phase 13: the pod and the serving drivers ------------------------
    record["pod"], phase_launches["13"] = pod_phase(
        ds, cfg, graph, n, d, args.queries, dev, answers, record)
    log("[launches] phase 13 (the 1-rank pod and both ranks) "
        + json.dumps(phase_launches["13"]))
    missing = [k for k in ANN_BODIES if phase_launches["13"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the pod's path: "
                             f"{missing}")
    for k in ANN_BODIES:
        launches[k] += phase_launches["13"][k]
    del graph, answers
    torch.cuda.empty_cache()
    # the bf16 body against its plain version (after the path's counts)
    shapes["gather_distances_bf16"] = check_bf16_body(ds, cfg, args.queries,
                                                      dev, gen)
    for r in shapes["gather_distances_bf16"]:
        log_kernel("gather_distances_bf16", r)

    # ---- phase 9: the kernel API ------------------------------------------
    api_shapes, api_main, api_launches, record["api"] = api_phase(
        ds, n, d, dev, gen)
    shapes.update(api_shapes)
    launches.update(api_launches)
    phase_launches["9"] = api_launches
    del ds
    torch.cuda.empty_cache()

    # ---- phase 14: the language models' serving path ----------------------
    log(f"[lm] device memory before phase 14 (the ANN state released): "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    record["lm"], phase_launches["14"] = lm_phase(dev)
    launches["flash_attention"] += phase_launches["14"]["flash_attention"]

    # ---- phase 15: Wide & Deep's serving path ------------------------------
    log(f"[recsys] device memory before phase 15 (the LM state released): "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    record["recsys"], phase_launches["15"] = recsys_phase(dev)
    launches["embedding_bag"] += phase_launches["15"]["embedding_bag"]

    # ---- phase 16: the graph family -----------------------------------------
    log(f"[gnn] device memory before phase 16 (the recsys state released): "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    record["gnn"], phase_launches["16"], gnn_spmm = gnn_phase(dev)
    launches["packed_spmm"] += phase_launches["16"]["packed_spmm"]
    shapes["packed_spmm"] = gnn_spmm + shapes["packed_spmm"]

    # ---- phase 17: LM training -----------------------------------------------
    log(f"[train] device memory before phase 17 (the graph state released): "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    record["train"], phase_launches["17"], shapes["flash_attention_bwd"] = \
        train_phase(dev)
    launches["flash_attention"] += phase_launches["17"]["flash_attention"]
    launches["flash_attention_bwd"] = \
        phase_launches["17"]["flash_attention_bwd"]

    # ---- phase 18: training of the graph, MACE and Wide & Deep families ----
    log(f"[family] device memory before phase 18 (the LM training state "
        f"released): {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        "allocated")
    record["family"], phase_launches["18"], bwd_rows = family_phase(dev)
    shapes.update(bwd_rows)
    for k in ("packed_spmm", "embedding_bag"):
        launches[k] += phase_launches["18"][k]
    for k in ("packed_spmm_bwd", "embedding_bag_bwd"):
        launches[k] = phase_launches["18"][k]

    # ---- summary -----------------------------------------------------------
    meta = {
        "gather_distances": ("src/repro_torch/kernels/csrc/l2dist.cu",
                             "src/repro/kernels/l2dist.py:401",
                             "nn_descent cand"),
        "gather_distances_int8": ("src/repro_torch/kernels/csrc/l2dist.cu",
                                  "src/repro/kernels/l2dist.py:384",
                                  "hop large"),
        "gather_distances_bf16": ("src/repro_torch/kernels/csrc/l2dist.cu",
                                  "src/repro/kernels/l2dist.py:401",
                                  "hop large"),
        "rank_merge": ("src/repro_torch/kernels/csrc/topk.cu",
                       "src/repro/kernels/topk.py:103", "nn_descent merge"),
        "visited_filter": ("src/repro_torch/kernels/csrc/visited.cu",
                           "src/repro/kernels/visited.py:102", "large"),
        "block_distances": ("src/repro_torch/kernels/csrc/block.cu",
                            "src/repro/kernels/l2dist.py:163",
                            f"scan B={args.queries}"),
        "block_distances_int8": ("src/repro_torch/kernels/csrc/block.cu",
                                 "src/repro/kernels/l2dist.py:114",
                                 f"scan B={args.queries}"),
        "distance_matrix": ("src/repro_torch/kernels/csrc/block.cu",
                            "src/repro/kernels/l2dist.py:42",
                            api_main["distance_matrix"]),
        "bitonic_sort": ("src/repro_torch/kernels/csrc/topk.cu",
                         "src/repro/kernels/topk.py:75",
                         api_main["bitonic_sort"]),
        "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:45",
                          api_main["embedding_bag"]),
        "packed_spmm": ("src/repro_torch/kernels/csrc/segment_matmul.cu",
                        "src/repro/kernels/segment_matmul.py:51",
                        gnn_spmm[0]["shape"]),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:71",
                            api_main["flash_attention"]),
        "embedding_bag_bf16": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                               "src/repro/kernels/embedding_bag.py:45",
                               api_main["embedding_bag_bf16"]),
        "packed_spmm_bf16": ("src/repro_torch/kernels/csrc/segment_matmul.cu",
                             "src/repro/kernels/segment_matmul.py:51",
                             api_main["packed_spmm_bf16"]),
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "no TPU kernel: the gradient of src/repro/models/layers.py:86 "
            "(chunked_attention), which the reference takes by autodiff",
            shapes["flash_attention_bwd"][0]["shape"]),
        "packed_spmm_bwd": (
            "src/repro_torch/kernels/csrc/segment_matmul_bwd.cu",
            "no TPU kernel: the gradient of src/repro/kernels/ops.py:66 "
            "(packed_spmm's plain path), which the reference takes by "
            "autodiff", shapes["packed_spmm_bwd"][0]["shape"]),
        "embedding_bag_bwd": (
            "src/repro_torch/kernels/csrc/embedding_bag_bwd.cu",
            "no TPU kernel: the gradient of src/repro/models/recsys.py:55 "
            "(embedding_bag), which the reference takes by autodiff",
            shapes["embedding_bag_bwd"][0]["shape"]),
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
                  launches_by_step=steps, launches_by_phase=phase_launches,
                  topk_launches_by_step=topk_shapes,
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
