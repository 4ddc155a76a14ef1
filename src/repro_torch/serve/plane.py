"""The single-device execution plane: the database and the packed graph
resident on one device, and the search procedure + arguments for each
regime (the reference's ``serve/plane.py::SingleDevicePlane``, query path
only: no compile cache, no streaming, no staging — PyTorch runs eagerly)."""
from __future__ import annotations

import torch

from repro_torch.ann.pipeline import build_graph
from repro_torch.core import hotpath
from repro_torch.core.diversify import PackedGraph
from repro_torch.core.search_large import _large_batch_search
from repro_torch.core.search_small import _small_batch_search
from repro_torch.device import resolve_device

# small_batch_search's ranking width: the per-query candidate pool is
# t0 * width entries
SMALL_WIDTH = 32


class SingleDevicePlane:
    """Database + graph on one device."""

    def __init__(self, X, cfg, *, graph: PackedGraph | None = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = hotpath.resolve_backend(
            getattr(cfg, "kernel_backend", "auto"), self.device)
        self.X = torch.as_tensor(X).to(device=self.device,
                                       dtype=torch.float32).contiguous()
        if graph is None:
            graph = build_graph(self.X, cfg, device=self.device)
        if graph.device != self.device:
            raise ValueError(f"graph on {graph.device}, plane on "
                             f"{self.device}")
        self.graph = graph

    def _search_args(self, kind: str, k: int):
        """(procedure, keyword arguments) for one regime at one k."""
        cfg = self.cfg
        visited = getattr(cfg, "visited_filter", "none")
        if kind == "small":
            kwargs = dict(k=k, t0=cfg.small_t0, hops=cfg.small_hops,
                          hop_width=cfg.hop_width, n_seeds=cfg.n_seeds,
                          lambda_limit=10, metric=cfg.metric,
                          visited=visited, backend=self.backend)
            return _small_batch_search, kwargs
        kwargs = dict(k=k, ef=cfg.large_ef, hops=cfg.large_hops,
                      lambda_limit=5, metric=cfg.metric,
                      n_seeds=getattr(cfg, "large_n_seeds", cfg.n_seeds),
                      m_seg=cfg.queue_segments, seg=cfg.segment_size,
                      mv_seg=cfg.visited_segments, delta=cfg.delta,
                      visited=visited, backend=self.backend)
        return _large_batch_search, kwargs

    def search(self, kind: str, Q: torch.Tensor, k: int):
        """Run one regime's procedure on a (padded) query batch on the
        plane's device -> (ids [B, k] int32, dists [B, k])."""
        fn, kwargs = self._search_args(kind, k)
        return fn(self.X, self.graph, Q, **kwargs)
