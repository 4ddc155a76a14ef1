"""The single-device execution plane: the database and the packed graph
resident on one device, and the search procedure + arguments for each
regime (the reference's ``serve/plane.py::SingleDevicePlane``).  PyTorch
runs eagerly: there is no compile cache and no staging yet.

A quantized plane (``cfg.quantization="int8"``) holds per-row int8 codes
and scales beside the fp32 rows, made at install (or carried in with
``quant=``); searches score the codes and re-rank exactly against the fp32
rows.  A mutable index attaches stream operands with :meth:`set_stream`
(the tombstone mask and the delta shard, quantized too on a quantized
plane) and searches through :meth:`search_stream`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ann.pipeline import build_graph
from repro_torch.ann.quantize import quantize_rows
from repro_torch.core import hotpath
from repro_torch.core.diversify import PackedGraph
from repro_torch.core.distributed import PAD_ID, merge_topk
from repro_torch.core.search_large import _large_batch_search
from repro_torch.core.search_small import _small_batch_search
from repro_torch.device import resolve_device

# small_batch_search's ranking width: the per-query candidate pool is
# t0 * width entries
SMALL_WIDTH = 32


class SingleDevicePlane:
    """Database + graph (+ int8 codes, + stream operands) on one device."""

    def __init__(self, X, cfg, *, graph: PackedGraph | None = None,
                 quant: tuple | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = hotpath.resolve_backend(
            getattr(cfg, "kernel_backend", "auto"), self.device)
        X = self._put(X, torch.float32)
        if graph is None:
            graph = build_graph(X, cfg, device=self.device)
        self._install(X, graph, quant=quant)

    @property
    def quantized(self) -> bool:
        return getattr(self.cfg, "quantization", "none") == "int8"

    def _put(self, A, dtype):
        if isinstance(A, np.ndarray) and not A.flags.writeable:
            A = A.copy()  # np.asarray of a JAX array: torch wants it writable
        return torch.as_tensor(A).to(device=self.device,
                                     dtype=dtype).contiguous()

    def _install(self, X, graph, *, quant=None) -> None:
        """Swap in a generation (clears the stream operands)."""
        if graph.device != self.device:
            raise ValueError(f"graph on {graph.device}, plane on "
                             f"{self.device}")
        self.X = X
        self.graph = graph
        self.codes = self.scales = None
        if self.quantized:
            if quant is None:  # build / compaction; a loaded index passes it
                quant = quantize_rows(X)
            self.codes = self._put(quant[0], torch.int8)
            self.scales = self._put(quant[1], torch.float32)
            if self.codes.shape != X.shape \
                    or self.scales.shape != X.shape[:1]:
                raise ValueError(
                    f"quant= codes {tuple(self.codes.shape)} / scales "
                    f"{tuple(self.scales.shape)} do not match X "
                    f"{tuple(X.shape)}")
        self.stream = None

    # -- generations & streaming -------------------------------------------

    def rebind(self, X, graph) -> None:
        """Swap to a new generation's corpus + graph (compaction); clears
        the stream operands and re-quantizes on a quantized plane."""
        self._install(self._put(X, torch.float32), graph)

    def set_stream(self, alive, delta_X, delta_alive) -> None:
        """Attach / refresh the stream operands: ``alive`` [N] bool (the
        base tombstone mask), ``delta_X`` [cap, d] float32, ``delta_alive``
        [cap] bool.  A quantized plane adds the delta's int8 codes and
        scales (delta_X stays fp32 for the exact re-rank)."""
        stream = (self._put(alive, torch.bool),
                  self._put(delta_X, torch.float32),
                  self._put(delta_alive, torch.bool))
        if self.quantized:
            stream = stream + quantize_rows(stream[1])
        self.stream = stream

    def clear_stream(self) -> None:
        self.stream = None

    @property
    def stream_active(self) -> bool:
        return self.stream is not None

    # -- searches -----------------------------------------------------------

    def _search_args(self, kind: str, k: int):
        """(procedure, keyword arguments) for one regime at one k."""
        cfg = self.cfg
        visited = getattr(cfg, "visited_filter", "none")
        if kind == "small":
            kwargs = dict(k=k, t0=cfg.small_t0, hops=cfg.small_hops,
                          hop_width=cfg.hop_width, n_seeds=cfg.n_seeds,
                          lambda_limit=10, metric=cfg.metric,
                          visited=visited, backend=self.backend)
            fn = _small_batch_search
        else:
            kwargs = dict(k=k, ef=cfg.large_ef, hops=cfg.large_hops,
                          lambda_limit=5, metric=cfg.metric,
                          n_seeds=getattr(cfg, "large_n_seeds", cfg.n_seeds),
                          m_seg=cfg.queue_segments, seg=cfg.segment_size,
                          mv_seg=cfg.visited_segments, delta=cfg.delta,
                          visited=visited, backend=self.backend)
            fn = _large_batch_search
        if self.quantized:
            kwargs.update(codes=self.codes, scales=self.scales,
                          rerank_mult=getattr(cfg, "rerank_mult", 4))
        return fn, kwargs

    def search(self, kind: str, Q: torch.Tensor, k: int):
        """Run one regime's procedure on a (padded) query batch on the
        plane's device -> (ids [B, k] int32, dists [B, k])."""
        fn, kwargs = self._search_args(kind, k)
        return fn(self.X, self.graph, Q, **kwargs)

    def search_stream(self, kind: str, Q: torch.Tensor, k: int):
        """The mutable index's search: the base graph search with the
        tombstone mask in its keep-masks, a brute-force scan of the delta
        shard, and one ``merge_topk``.  Delta rows answer at ids
        ``N + slot``; rows with fewer than k live candidates pad with
        (-1, INF).  On a quantized plane the delta scan scores the int8
        codes, keeps the best ``rerank_mult * k`` slots and re-scores them
        against the fp32 delta rows."""
        if self.stream is None:
            raise RuntimeError(
                "no stream state attached (set_stream() installs the "
                "tombstone mask + delta shard before search_stream)")
        fn, kwargs = self._search_args(kind, k)
        alive, dX, dal = self.stream[:3]
        N, INF = self.X.shape[0], hotpath.INF
        metric, backend = self.cfg.metric, self.backend
        bids, bd = fn(self.X, self.graph, Q, alive=alive, **kwargs)
        valid = (bids < N) & (bd < INF)
        pool_i = torch.where(valid, bids, torch.full_like(bids, PAD_ID))
        pool_d = torch.where(valid, bd, torch.full_like(bd, INF))
        cap = dX.shape[0]
        slots = torch.arange(cap, dtype=torch.int32, device=self.device)
        if self.quantized:
            dcodes, dscales = self.stream[3:]
            dd = hotpath.scan_distances(Q, dcodes, metric=metric, mask=dal,
                                        backend=backend, scales=dscales)
            r = min(getattr(self.cfg, "rerank_mult", 4) * k, cap)
            # dead / unfilled lanes are already INF from the masked scan
            sd, ss = hotpath.rank_merge(dd, slots.expand_as(dd), keep=r,
                                        backend=backend)
            ed = hotpath.neighbor_distances(Q, dX, ss, metric=metric,
                                            mask=sd < INF, backend=backend)
            d_ids = torch.where(ed < INF, N + ss,
                                torch.full_like(ss, PAD_ID))
        else:
            ed = hotpath.scan_distances(Q, dX, metric=metric, mask=dal,
                                        backend=backend)
            d_ids = torch.where(dal, N + slots,
                                torch.full_like(slots, PAD_ID)) \
                .expand_as(ed)
        return merge_topk(torch.cat([pool_i, d_ids], dim=1),
                          torch.cat([pool_d, ed], dim=1), k)
