"""Quickstart: the `repro_torch.ann.Index` facade end to end, on the card.

Build a TSDG index, search it under both batch regimes (dispatch is
automatic), persist it — graph and config — then reload and serve
without rebuilding.  The engine caches one CUDA graph per (regime,
bucket); a graph binds device addresses and has no serialized form, so
the reloaded index captures its graphs again on first use (the
reference's artifact also restores its compiled executables).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.ann import Index
from repro_torch.configs.base import ANNConfig
from repro_torch.data.synthetic import make_clustered, recall_at_k

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device)")
dev = ap.parse_args().device

# 1. data (swap in your own [N, d] float32 matrix; REPRO_QUICKSTART_N
#    shrinks the corpus for a smoke run)
ds = make_clustered(n=int(os.environ.get("REPRO_QUICKSTART_N", 20000)),
                    d=32, n_queries=100, n_clusters=64, noise=0.6)

# 2. build — staged pipeline (knn -> diversify -> bridges, paper §3);
#    defaults come from ANNConfig, any knob is a dataclasses.replace away
index = Index.build(ds.X, k=10, device=dev)
print(index)

# 3. search — one call, both regimes: the paper's §4 threshold routes a
#    small batch to Algorithm 1 (t0 parallel greedy searches) and a large
#    one to Algorithm 2 (batched best-first), behind the same API
ids, dists = index.search(ds.Q[:10])
print(f"B=10  -> {index.regime(10)}-batch procedure, "
      f"recall@10={recall_at_k(ids, ds.gt[:10], 10):.3f}")
ids, dists = index.search(ds.Q)
print(f"B=100 -> {index.regime(100)}-batch procedure, "
      f"recall@10={recall_at_k(ids, ds.gt, 10):.3f}")

# 4. persist: the versioned artifact = packed graph + config + fingerprint
with tempfile.TemporaryDirectory() as td:
    index.warmup()                       # capture the serving ladder once
    index.save(f"{td}/tsdg")

    # 5. a "restarted process": the load answers bit for bit without a
    #    rebuild; its cache entries are made again as batches arrive
    loaded = Index.load(f"{td}/tsdg", device=dev)
    ids2, _ = loaded.search(ds.Q)
    s = loaded.stats
    identical = bool((ids == ids2).all())
    print(f"reloaded: identical={identical} compiles={s.compiles} "
          f"aot_primed={s.aot_primed} (the graphs are captured again: "
          "none is stored)")
    assert identical, "a loaded index must answer as the saved one"

    # 6. serve concurrent callers through the micro-batching queue (QoS:
    #    bulk submits >= max_batch take the bypass lane, never blocking
    #    latency traffic)
    with loaded.serve(max_wait_ms=2.0, max_batch=64) as mb:
        futs = [mb.submit(q) for q in ds.Q[:32]]         # singles coalesce
        bulk = mb.submit(ds.Q)                           # bypass lane
        ids1, _ = futs[0].result()
        bulk.result()
        q = mb.stats.snapshot()
        print(f"queue: {q['n_dispatches']} dispatches, "
              f"bypass={q['bypass']}")
    assert q["bypass"] == 1

# 7. compressed residency: score int8 codes in-kernel, then re-rank the
#    top rerank_mult*k survivors against the exact fp32 rows
qcfg = dataclasses.replace(ANNConfig(), quantization="int8")
qindex = Index.build(ds.X, qcfg, k=10, device=dev)
qids, _ = qindex.search(ds.Q)
print(f"int8+rerank -> recall@10={recall_at_k(qids, ds.gt, 10):.3f}")
print("quickstart OK")
