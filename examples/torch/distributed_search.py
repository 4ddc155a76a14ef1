"""Sharded TSDG through the `repro_torch.ann.Index` facade: the shard
grid is an *execution plane*, so the four verbs are the same as on one
device —

    Index.build(X, cfg, mesh=mesh)   one independent sub-index per DB shard
    index.search(Q)                  both regimes, every cell, one merge
    index.save(dir)                  the shard-major artifact
    Index.load(dir, mesh=mesh)       no rebuild

The grid is the reference example's (4, 2): the database cut 4 ways
(``data``), queries and search populations over 2 columns (``model``).
In the port it is a logical grid on one card
(:mod:`repro_torch.core.distributed`): each (shard, column) cell is a
search on the card's stream, and one search is one CUDA graph.  A graph
has no serialized form, so the restored index captures its graphs
again.

  PYTHONPATH=src python examples/torch/distributed_search.py [--device cpu]

``REPRO_DISTRIBUTED_N`` shrinks the corpus (default 8,192; a multiple of
4).
"""
import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.ann import Index
from repro_torch.configs.base import ANNConfig
from repro_torch.core.distributed import make_mesh
from repro_torch.data.synthetic import make_clustered, recall_at_k

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device)")
dev = ap.parse_args().device

mesh = make_mesh((4, 2), ("data", "model"), device=dev)
print(f"mesh: {dict(zip(mesh.axis_names, mesh.shape))} on {mesh.device}")

ds = make_clustered(n=int(os.environ.get("REPRO_DISTRIBUTED_N", 8192)),
                    d=32, n_queries=64, n_clusters=64, noise=0.6)
cfg = dataclasses.replace(ANNConfig(), k_graph=16, max_degree=24,
                          bridge_hubs=64, serve_buckets=(8, 64))

t0 = time.perf_counter()
index = Index.build(ds.X, cfg, k=10, mesh=mesh)
print(f"sharded build (4 independent sub-indexes): "
      f"{time.perf_counter() - t0:.1f}s")

for Bq in (64, 4):  # large then small — dispatch is automatic
    t0 = time.perf_counter()
    ids, dists = index.search(ds.Q[:Bq])
    r = recall_at_k(np.asarray(ids), ds.gt[:Bq], 10)
    print(f"{index.regime(Bq)}-batch (B={Bq}): recall@10={r:.3f} "
          f"({time.perf_counter() - t0:.1f}s incl. capture)")

s = index.stats
print(f"engine: {s.n_batches} batches, compiles={s.compiles} "
      f"({s.small_batches} small / {s.large_batches} large)")

# --- sharded save -> load round trip: no rebuild ----------------------------
index.warmup()           # every (regime, bucket) entry
td = tempfile.mkdtemp(prefix="repro_torch_mesh_demo_")
try:
    t0 = time.perf_counter()
    index.save(td)
    print(f"shard-major artifact written in {time.perf_counter() - t0:.1f}s "
          f"(arrays/<i>.npz per DB shard)")
    t0 = time.perf_counter()
    restored = Index.load(td, mesh=mesh)
    ids2, _ = restored.search(ds.Q[:64])
    same = bool(np.array_equal(ids2, index.search(ds.Q[:64])[0]))
    print(f"restored + first query in {time.perf_counter() - t0:.1f}s: "
          f"plane={restored.plane.name} compiles={restored.stats.compiles} "
          f"(captured again) aot_primed={restored.stats.aot_primed} "
          f"(bitwise match: {same})")
    assert same
finally:
    shutil.rmtree(td, ignore_errors=True)
print("distributed_search OK")
