"""Synthetic CTR data with a planted linear signal (learnable): the port's
copy of the reference's ``data/recsys.py`` (numpy only), so one seed
gives the same batches bit for bit in either package."""
from __future__ import annotations

import numpy as np


class CTRStream:
    def __init__(self, cfg, batch: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        # hidden per-field value weights (hash-bucketed to bound memory)
        self.hbuckets = 4096
        self.hidden = self.rng.normal(
            size=(cfg.n_sparse, self.hbuckets)).astype(np.float32) * 0.5
        self.dense_w = self.rng.normal(size=cfg.n_dense).astype(np.float32)

    def _ids(self, vocab, size):
        # zipf-ish: squared uniform concentrates mass on small ids
        u = self.rng.random(size)
        return np.minimum((u * u * vocab).astype(np.int64), vocab - 1)

    def __next__(self):
        cfg, B = self.cfg, self.batch
        sparse = np.stack([self._ids(v, B) for v in cfg.vocab_sizes],
                          axis=1)
        bags = np.stack(
            [self._ids(cfg.vocab_sizes[f], (B, cfg.bag_size))
             for f in cfg.multi_hot_fields], axis=1)
        dense = self.rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
        logit = dense @ self.dense_w
        for i in range(cfg.n_sparse):
            logit += self.hidden[i, sparse[:, i] % self.hbuckets]
        labels = (self.rng.random(B)
                  < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
        return {
            "sparse_ids": sparse.astype(np.int32),
            "bags": bags.astype(np.int32),
            "dense": dense,
            "labels": labels,
        }

    def __iter__(self):
        return self
