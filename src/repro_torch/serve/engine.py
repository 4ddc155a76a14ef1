"""In-process serving, query path (the reference's
``serve/engine.py::ANNEngine.query``): regime dispatch, the shape-bucket
ladder with edge padding, and the serving counters.  Execution is eager;
the compile cache, staging and streaming come in later slices."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.ann.dispatch import regime_for
from repro_torch.configs.base import ANNConfig
from repro_torch.serve.plane import SMALL_WIDTH, SingleDevicePlane


@dataclasses.dataclass
class ServeStats:
    n_queries: int = 0              # all queries answered
    n_batches: int = 0
    small_batches: int = 0
    large_batches: int = 0
    padded_queries: int = 0         # rows added by bucketing

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class ANNEngine:
    """Build once (or take a graph), answer batches of queries."""

    def __init__(self, X, cfg: ANNConfig | None = None, *, k: int = 10,
                 graph=None, device=None):
        self.cfg = cfg or ANNConfig()
        self.k = k
        self.stats = ServeStats()
        self.buckets = tuple(sorted(self.cfg.serve_buckets))
        self.plane = SingleDevicePlane(X, self.cfg, graph=graph,
                                       device=device)

    @property
    def X(self):
        return self.plane.X

    @property
    def graph(self):
        return self.plane.graph

    @property
    def backend(self) -> str:
        return self.plane.backend

    @property
    def device(self) -> torch.device:
        return self.plane.device

    def regime(self, batch: int) -> str:
        return regime_for(self.cfg, batch)

    def bucket_for(self, batch: int) -> int:
        """Smallest ladder bucket >= batch; beyond the ladder, the next
        multiple of the largest bucket.  No ladder -> the raw batch."""
        if not self.buckets:
            return batch
        bucket = next((b for b in self.buckets if b >= batch), None)
        if bucket is None:
            top = self.buckets[-1]
            bucket = -(-batch // top) * top
        return bucket

    def _validate_k(self, k, kind: str) -> int:
        if k is None:
            k = self.k
        if not isinstance(k, int) or isinstance(k, bool) or k <= 0:
            raise ValueError(f"k must be a positive int, got {k!r}")
        if kind == "large" and k > self.cfg.large_ef:
            raise ValueError(
                f"k={k} exceeds large-batch ranking size ef="
                f"{self.cfg.large_ef}; raise cfg.large_ef or lower k")
        if kind == "small" and k > self.cfg.small_t0 * SMALL_WIDTH:
            raise ValueError(
                f"k={k} exceeds small-batch candidate pool t0*width="
                f"{self.cfg.small_t0 * SMALL_WIDTH}; raise cfg.small_t0 "
                "or lower k")
        return k

    def query(self, Q, *, k: int | None = None):
        """Answer a batch: (ids [B, k], dists [B, k]) numpy arrays."""
        Q = torch.as_tensor(Q)
        if Q.dtype.is_complex or Q.dtype == torch.bool:
            raise ValueError(f"Q must be numeric (float/int), got {Q.dtype}")
        Q = Q.to(device=self.device, dtype=torch.float32)
        d = self.X.shape[1]
        if Q.dim() != 2 or Q.shape[1] != d:
            raise ValueError(f"Q must be [B, {d}], got {tuple(Q.shape)}")
        B = Q.shape[0]
        if B == 0:
            raise ValueError("empty query batch")
        kind = self.regime(B)
        k = self._validate_k(k, kind)
        bucket = self.bucket_for(B)
        if bucket > B:  # edge padding: replicate the last row
            Q = torch.cat([Q, Q[-1:].expand(bucket - B, d)], dim=0)
        ids, dists = self.plane.search(kind, Q.contiguous(), k)
        st = self.stats
        st.n_queries += B
        st.n_batches += 1
        st.padded_queries += bucket - B
        if kind == "small":
            st.small_batches += 1
        else:
            st.large_batches += 1
        return ids[:B].cpu().numpy(), dists[:B].cpu().numpy()
