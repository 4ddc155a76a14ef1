"""Pod-scale serving demo on the card: a request router fronting a set of
replica endpoints, all in one process.

Builds a TSDG index once, warms it (captures its CUDA graphs), then stands
up an N-replica *replicated* router where every replica shares the
donor's plane and graphs (`replicate_engine` / `ANNEngine(cache_from=)`),
so the replicas serve with aggregated ``compiles=0`` beyond the donor's
warmup.  A mixed query stream runs against the router; halfway through,
one replica is killed to show the failover path: the dead replica's
in-flight and later requests retry on a healthy peer (zero lost futures),
the health prober ejects it within one probe interval, and after revival
it is readmitted.

A *sharded* router over the same corpus (two half-corpus engines, answers
merged with `merge_shard_results`) then answers the same queries — bit
for bit as a 2-DB-shard mesh plane over the whole corpus (the router's
host-side merge is the grid's merge).

Knobs: ``REPRO_POD_N`` (corpus size, default 8000), ``REPRO_POD_REPLICAS``
(replica count, default 2).

  PYTHONPATH=src python examples/torch/pod_serving.py [--device cpu]
"""
import argparse
import os
import time

import numpy as np

from repro_torch.ann import Index
from repro_torch.configs.base import ANNConfig
from repro_torch.core.distributed import make_mesh
from repro_torch.data.synthetic import make_clustered, recall_at_k
from repro_torch.serve.router import (Router, RouterConfig, replicate_engine,
                                      shard_engines)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device)")
dev = ap.parse_args().device

N = int(os.environ.get("REPRO_POD_N", "8000"))
R = int(os.environ.get("REPRO_POD_REPLICAS", "2"))

ds = make_clustered(n=N, d=32, n_queries=256, n_clusters=32, noise=0.6)
cfg = ANNConfig()
thresh = 8.0 * cfg.small_t0          # static regime split: B<32 small

t0 = time.perf_counter()
index = Index.build(ds.X, cfg, k=10, threshold=thresh, device=dev)
index.warmup()
print(f"index built + warmed in {time.perf_counter() - t0:.1f}s "
      f"(compiles={index.stats.compiles}, on {index.device})")

# --- replicated router: QPS scaling + failover ----------------------------

rc = RouterConfig(mode="replicated", replicas=R, policy="least_loaded",
                  health_interval_s=0.2, max_retries=2, backoff_s=0.01)
router = Router(replicate_engine(index.engine, R), rc)
print(f"\n[replicated] {R} replicas sharing one plane and its graphs, "
      f"health probe every {rc.health_interval_s}s")

rng = np.random.default_rng(0)
futures, kill_at = [], 15
for i in range(30):
    if i == kill_at:
        router.endpoints[0].kill()   # simulate a replica crash mid-stream
        print(f"  !! killed replica r0 at request {i} "
              f"(in-flight + future requests fail over to peers)")
    B = int(rng.choice([1, 4, 8, 64]))
    sel = rng.integers(0, len(ds.Q), B)
    futures.append((sel, router.submit(ds.Q[sel])))

recs = [recall_at_k(np.asarray(f.result(timeout=300)[0]), ds.gt[sel], 10)
        for sel, f in futures]
snap = router.snapshot()
agg, rt = snap["aggregate"], snap["router"]
print(f"  30/30 requests answered, mean recall@10 "
      f"{sum(recs) / len(recs):.3f}")
print(f"  lost_futures={rt['lost_futures']} retries={rt['retries']} "
      f"ejects={rt['ejects']} compiles={agg['compiles']} "
      f"(shared graphs: none captured beyond the donor's warmup)")
assert rt["lost_futures"] == 0

router.endpoints[0].revive()
deadline = time.time() + 10.0
while time.time() < deadline and snap["router"]["readmits"] < 1:
    time.sleep(0.1)
    snap = router.snapshot()
print(f"  r0 revived -> readmitted after "
      f"{rc.readmit_probes} clean probes "
      f"(readmits={snap['router']['readmits']}, "
      f"probes={snap['router']['probes']})")
router.close()

# --- sharded router: capacity scaling, bitwise the grid's cut -------------

print("\n[sharded] 2 half-corpus engines, host-side merge")
sc = RouterConfig(mode="sharded", replicas=2, health_interval_s=0.0)
shards = shard_engines(ds.X, cfg, shards=2, k=10, threshold=thresh,
                       device=dev)
srouter = Router(shards, sc)
ids, dists = srouter.query(ds.Q[:64])
mesh_ix = Index.build(ds.X, cfg, k=10,
                      mesh=make_mesh((2,), ("data",), device=dev),
                      threshold=thresh)
ref_ids, ref_dists = mesh_ix.search(ds.Q[:64])
same = np.array_equal(np.asarray(ids), np.asarray(ref_ids)) \
    and np.array_equal(np.asarray(dists), np.asarray(ref_dists))
print(f"  64-query batch: bitwise == 2-DB-shard mesh plane: {same}")
assert same
srouter.close()
print("\npod serving demo OK")
