"""End-to-end serving driver on the card: build a TSDG index once through
the `repro_torch.ann.Index` facade, then serve a mixed stream of small and
large query batches (regime dispatch is the paper's §4 threshold,
`repro_torch.ann.dispatch`).

Shows the serving layer above the paper: the engine's cache of one CUDA
graph per (regime, bucket) (steady state replays, never captures),
warmup, save/load (a restart skips the rebuild; the graphs are captured
again, since a CUDA graph has no serialized form), the stats
(per-regime percentiles, bucket hit rate), and the micro-batching queue
with the QoS bypass lane for bulk submits.

  PYTHONPATH=src python examples/torch/ann_serving.py [--device cpu]

``REPRO_SERVING_N`` shrinks the corpus (default 20,000).
"""
import argparse
import os
import tempfile
import threading
import time

import numpy as np

from repro_torch.ann import Index
from repro_torch.configs.base import ANNConfig
from repro_torch.data.synthetic import make_clustered, recall_at_k

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device)")
dev = ap.parse_args().device

ds = make_clustered(n=int(os.environ.get("REPRO_SERVING_N", 20000)), d=32,
                    n_queries=512, n_clusters=64, noise=0.6)

t0 = time.perf_counter()
index = Index.build(ds.X, ANNConfig(), k=10, device=dev)
print(f"index built in {time.perf_counter() - t0:.1f}s "
      f"(avg degree {index.graph.avg_degree():.1f}, on {index.device})")

t0 = time.perf_counter()
n = index.warmup()
print(f"warmup: {n} cache entries (regime x bucket x k; CUDA graphs on "
      f"the card) in {time.perf_counter() - t0:.1f}s — steady state "
      "never captures")

rng = np.random.default_rng(0)
recalls = []
for step in range(20):
    B = int(rng.choice([1, 2, 8, 32, 256]))       # bursty traffic
    sel = rng.integers(0, len(ds.Q), B)
    ids, dists = index.search(ds.Q[sel])
    r = recall_at_k(ids, ds.gt[sel], 10)
    recalls.append((r, B))
    print(f"batch={B:4d} regime={index.regime(B):5s} "
          f"bucket={index.engine.bucket_for(B):4d} recall@10={r:.3f}")

s = index.stats
avg = sum(r * b for r, b in recalls) / sum(b for _, b in recalls)
print(f"\nserved {s.n_queries} queries in {s.n_batches} batches "
      f"({s.small_batches} small / {s.large_batches} large), "
      f"{s.qps:.0f} QPS steady-state, weighted recall@10 {avg:.3f}")
print(f"compiles={s.compiles} bucket_hit_rate={s.bucket_hit_rate:.2f} "
      f"padded_queries={s.padded_queries}")
assert s.compiles == n, "steady state must not make cache entries"
for regime in ("small", "large"):
    p = s.per_regime[regime].percentiles()
    print(f"{regime:5s} latency ms: " + " ".join(
        f"{k}={v * 1e3:.1f}" for k, v in p.items()))

# --- restart without the rebuild ---------------------------------------
with tempfile.TemporaryDirectory() as td:
    t0 = time.perf_counter()
    index.save(f"{td}/ix")
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    restarted = Index.load(f"{td}/ix", device=dev)
    print(f"\nsave {t_save:.1f}s / load {time.perf_counter() - t0:.1f}s — "
          f"restart primed {restarted.stats.aot_primed} executables (the "
          "rebuild is skipped; the graphs are captured again)")
    ids2, _ = restarted.search(ds.Q[:8])
    assert np.array_equal(ids2, index.search(ds.Q[:8])[0]), \
        "a loaded index must answer as the saved one"
    print(f"restarted: first batch made {restarted.stats.compiles} cache "
          "entry, answers equal the saved index's")

# --- async micro-batching: concurrent single-query callers ----------------
print("\nmicro-batching queue: 64 concurrent single-query callers "
      "+ one bulk job on the bypass lane")
hits = []
with index.serve(max_wait_ms=5.0, max_batch=64) as mb:
    bulk_fut = mb.submit(ds.Q[:256])  # >= max_batch -> QoS bypass lane

    def caller(i):
        ids, _ = mb.submit(ds.Q[i]).result(timeout=120)
        hits.append(recall_at_k(ids[None], ds.gt[i:i + 1], 10))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(64)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bulk_fut.result(timeout=300)
    dt = time.perf_counter() - t0
q = mb.stats.snapshot()
print(f"{q['n_requests']} requests -> {q['n_dispatches']} device dispatches "
      f"(mean coalesced {q['mean_coalesced']:.1f}, bypass={q['bypass']}), "
      f"{dt * 1e3:.0f} ms total, recall@10 {np.mean(hits):.3f}")
assert len(hits) == 64 and q["bypass"] == 1
print("ann_serving OK")
