"""Streaming ingest on the card: a mutable index without a rebuild per
change.

Build once, then keep serving while the corpus evolves: `add` appends to
a brute-force delta shard scanned in every search, `delete` tombstones
rows in place, and `compact` folds delta and base into a new generation
that the serving plane swaps in — copied into the same buffers when the
shapes hold, so every captured CUDA graph keeps serving and nothing is
captured again.

  PYTHONPATH=src python examples/torch/streaming_ingest.py [--device cpu]
"""
import argparse
import os

import numpy as np

from repro_torch.ann import Index
from repro_torch.data.synthetic import make_clustered

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device)")
dev = ap.parse_args().device

# 1. build a frozen index and warm the serving ladder
ds = make_clustered(n=int(os.environ.get("REPRO_STREAMING_N", 8000)),
                    d=32, n_queries=64, n_clusters=32, noise=0.6)
index = Index.build(ds.X, k=10, device=dev)
index.search(ds.Q[:8]); index.search(ds.Q)       # capture both regimes
print(f"built n={ds.X.shape[0]}  generation={index.generation}  "
      f"compiles={index.stats.compiles}")

# 2. ingest — new vectors are searchable AT ONCE (scored brute-force in
#    the delta shard, merged with the graph candidates in the search)
fresh = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
new_ids = index.add(fresh)
ids, dists = index.search(fresh)
hits = int((ids[:, 0] == new_ids).sum())
print(f"added {len(new_ids)} -> ids {new_ids.tolist()}; "
      f"self-search hits={hits}/4 "
      f"(top-1 dist max {float(dists[:, 0].max()):.2e})")
assert hits == 4

# 3. delete — tombstoned rows vanish from results at once (the keep-mask
#    rides into the in-kernel candidate filter, base or delta rows)
pool = [int(i) for i in ids[:, 1:].ravel() if 0 <= int(i) < len(ds.X)]
pool = list(dict.fromkeys(pool))                 # distinct base neighbors
victims = pool[:4]
index.delete(victims)
ids, _ = index.search(fresh)
gone = not np.isin(victims, ids).any()
print(f"deleted {victims}; still returned={not gone}  "
      f"n_active={index.n_active}")
assert gone

# 4. serve through the micro-batching queue while mutating — the
#    generation state swaps between micro-batches, in-flight futures all
#    resolve
with index.serve(max_wait_ms=1.0) as mb:
    futs = [mb.submit(q) for q in ds.Q[:16]]
    index.add(fresh[:2] + 0.01)                  # mutate under live traffic
    index.delete(pool[4:6])
    assert all(f.result()[0].shape == (10,) for f in futs)

# 5. compact — rebuild delta + base into generation 1.  Net adds equal net
#    deletes here, so the new generation has the old shapes: it is copied
#    into the plane's buffers and every captured graph keeps serving
before = index.stats.compiles
id_map = index.compact()
ids, _ = index.search(ds.Q)                      # the captured large shape
print(f"compacted -> generation={index.generation}  "
      f"n={index.n_active}  remapped_deleted={int((id_map < 0).sum())}  "
      f"swap_compiles={index.stats.compiles - before}")
assert index.stats.compiles == before, "same-shape swap must stay cached"
print("streaming_ingest OK")
