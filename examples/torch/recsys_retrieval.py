"""TSDG x wide&deep: candidate retrieval for the `retrieval_cand` shape, on
the card.

Scores one user against a candidate corpus two ways:
  (a) exact brute force: `models.recsys.retrieval_step`, one GEMM + top-100;
  (b) the paper's TSDG index over the item vectors (inner-product metric),
      through the `repro_torch.ann.Index` facade, with its recall@100
      against (a).
The user vector comes from Wide & Deep's user tower, whose bag fields run
on the hand-written `embedding_bag` kernel on the card.

  PYTHONPATH=src python examples/torch/recsys_retrieval.py [--device cpu]

``REPRO_RECSYS_N`` sets the number of item vectors (default 100,000).
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.ann import Index
from repro_torch.configs import get_arch, get_reduced
from repro_torch.data.recsys import CTRStream
from repro_torch.device import resolve_device
from repro_torch.models import recsys as R
from repro_torch.models.module import init_params

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device)")
dev = resolve_device(ap.parse_args().device)
N_ITEMS = int(os.environ.get("REPRO_RECSYS_N", 100_000))
K = 100

# --- user tower ------------------------------------------------------------
cfg = get_reduced("wide-deep")
gen = torch.Generator(device=dev).manual_seed(0)
model = R.WideDeep(cfg, init_params(R.schema(cfg), gen, dev))
batch = R.batch_to({k: v[:1] for k, v in next(CTRStream(cfg, 4)).items()},
                   dev)
deep, _ = R.user_tower(model, cfg, batch)
user_vec = (deep @ model.retrieval_proj).cpu().numpy()        # [1, 64]

# --- item corpus -----------------------------------------------------------
# clustered like real item embeddings (i.i.d.-gaussian corpora have no
# neighborhood structure: the known ANN worst case, LID ~ d)
rng = np.random.default_rng(0)
centers = rng.normal(size=(256, R.RETRIEVAL_DIM)).astype(np.float32)
items = (centers[rng.integers(0, 256, N_ITEMS)]
         + 0.5 * rng.normal(size=(N_ITEMS, R.RETRIEVAL_DIM))
         ).astype(np.float32)
items_t = torch.as_tensor(items, device=dev)

# (a) exact: one GEMM + top-100 (the model's retrieval head)
R.retrieval_step(model, cfg, dict(batch, item_vectors=items_t))  # warm-up
t0 = time.perf_counter()
top_exact, _ = R.retrieval_step(model, cfg, dict(batch,
                                                 item_vectors=items_t))
top_exact = top_exact.cpu().numpy()
t_exact = time.perf_counter() - t0
print(f"brute force over {N_ITEMS} items: {t_exact * 1e3:.1f} ms")

# (b) TSDG index on inner-product metric (small_t0=64 as the reference's
# example; a B=1 retrieval batch always takes the small regime)
ann_cfg = dataclasses.replace(get_arch("tsdg-paper"), metric="ip",
                              k_graph=24, max_degree=32, small_t0=64,
                              small_hops=8)
t0 = time.perf_counter()
index = Index.build(items, ann_cfg, k=K, device=dev)
print(f"TSDG build: {time.perf_counter() - t0:.1f} s (one-off, amortized "
      "over the query stream; index.save() persists it across restarts)")

index.search(user_vec)                                   # capture, warm-up
t0 = time.perf_counter()
ids, dists = index.search(user_vec)
t_ann = time.perf_counter() - t0
overlap = len(set(ids[0].tolist()) & set(top_exact.tolist()))
print(f"TSDG search ({index.regime(1)} regime): {t_ann * 1e3:.1f} ms, "
      f"recall@{K} vs exact: {overlap / K:.2f}")
assert ids.shape == (1, K) and len(set(ids[0].tolist())) == K
assert ((ids >= 0) & (ids < N_ITEMS)).all()
print("recsys_retrieval OK")
