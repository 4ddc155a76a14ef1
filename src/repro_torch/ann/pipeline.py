"""Staged, pluggable index-build pipeline (knn -> diversify -> bridges).

:func:`build_graph` runs the named stages of ``cfg.build_pipeline`` over a
shared :class:`BuildState` and returns the
:class:`~repro_torch.core.diversify.PackedGraph`:

  * ``"knn"``       — NN-expansion k-NN graph (skipped when the caller
    supplies ``knn_ids``/``knn_dists``);
  * ``"diversify"`` — relaxed GD -> symmetrize -> soft GD, λ-sorted and
    truncated to ``max_degree``;
  * ``"bridges"``   — hub cross-links (no-op when ``cfg.bridge_hubs == 0``);
  * ``"layout"``    — the locality-packed order (:mod:`repro_torch.ann.
    layout`): relabel the graph so neighbours sit in adjacent rows, and
    return the permutation as ``PackedGraph.perm``.

A stage is ``fn(state) -> None`` mutating the state; :func:`register_stage`
adds more by name.
"""
from __future__ import annotations

import dataclasses
import difflib
import time

import torch

from repro_torch.core import metrics as M
from repro_torch.core.diversify import (PackedGraph, add_bridges,
                                        append_reverse, relaxed_gd, soft_gd)
from repro_torch.core.hotpath import resolve_backend
from repro_torch.core.knn_build import nn_descent
from repro_torch.device import resolve_device


@dataclasses.dataclass
class BuildState:
    """Mutable scratch shared by the stages of one build (``X`` is
    metric-preprocessed and on the build's device)."""

    X: torch.Tensor
    cfg: object
    tile: int = 2048
    backend: str = "auto"
    knn_ids: torch.Tensor | None = None
    knn_dists: torch.Tensor | None = None
    neighbors: torch.Tensor | None = None
    lambdas: torch.Tensor | None = None
    degrees: torch.Tensor | None = None
    hubs: torch.Tensor | None = None
    perm: torch.Tensor | None = None


_STAGES: dict = {}


def register_stage(name: str, fn=None):
    """Register a build stage; usable directly or as a decorator."""
    if fn is None:
        def deco(f):
            _STAGES[name] = f
            return f
        return deco
    _STAGES[name] = fn
    return fn


def build_stages() -> tuple:
    return tuple(sorted(_STAGES))


def get_stage(name: str):
    try:
        return _STAGES[name]
    except KeyError:
        close = difflib.get_close_matches(name, _STAGES, n=3, cutoff=0.5)
        hint = f"; did you mean {', '.join(close)}?" if close else ""
        raise KeyError(f"unknown build stage {name!r}{hint}; "
                       f"registered: {build_stages()}") from None


@register_stage("knn")
def _stage_knn(s: BuildState) -> None:
    if s.knn_ids is None:
        s.knn_ids, s.knn_dists = nn_descent(
            s.X, s.cfg.k_graph, metric=s.cfg.metric, backend=s.backend)


@register_stage("diversify")
def _stage_diversify(s: BuildState) -> None:
    cfg = s.cfg
    keep = relaxed_gd(s.X, s.knn_ids, s.knn_dists, alpha=cfg.alpha,
                      metric=cfg.metric, tile=s.tile, backend=s.backend)
    adj_ids, adj_d = append_reverse(s.X, s.knn_ids, s.knn_dists, keep,
                                    rev_cap=cfg.k_graph, metric=cfg.metric,
                                    backend=s.backend)
    s.neighbors, s.lambdas, s.degrees = soft_gd(
        s.X, adj_ids, adj_d, lambda0=cfg.lambda0,
        max_degree=cfg.max_degree, metric=cfg.metric, tile=s.tile,
        backend=s.backend)


@register_stage("bridges")
def _stage_bridges(s: BuildState) -> None:
    cfg = s.cfg
    n_hubs = getattr(cfg, "bridge_hubs", 0)
    if not n_hubs:
        return
    N = s.X.shape[0]
    n_hubs = min(n_hubs, N // 4)
    hub_k = min(getattr(cfg, "bridge_k", 8), cfg.max_degree // 2)
    s.neighbors, s.lambdas, s.hubs = add_bridges(
        s.X, s.neighbors, s.lambdas, n_hubs=n_hubs, hub_k=hub_k,
        metric=cfg.metric)
    s.degrees = (s.neighbors < N).sum(dim=1, dtype=torch.int32)


@register_stage("layout")
def _stage_layout(s: BuildState) -> None:
    """Locality-packed layout: re-number the nodes so a node's neighbours
    hold adjacent ids.  Host-side numpy — the traversal is sequential and
    runs once per build."""
    import numpy as np

    from repro_torch.ann import layout as L

    if s.neighbors is None:
        raise ValueError("'layout' must come after a graph-producing stage "
                         "(e.g. 'diversify')")
    dev = s.neighbors.device
    nbrs = s.neighbors.cpu().numpy()
    hubs = None if s.hubs is None else s.hubs.cpu().numpy()
    perm = L.locality_order(nbrs, starts=hubs)
    X2, nb2, lam2, deg2, hubs2 = L.apply_layout(
        perm, s.X.cpu().numpy(), nbrs, s.lambdas.cpu().numpy(),
        s.degrees.cpu().numpy(), hubs)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    s.X, s.neighbors, s.lambdas, s.degrees = (put(X2), put(nb2), put(lam2),
                                              put(deg2))
    s.hubs = None if hubs2 is None else put(hubs2)
    s.perm = put(perm)


def build_graph(X, cfg, *, stages=None, tile: int = 2048, knn_ids=None,
                knn_dists=None, device=None,
                timings: dict | None = None) -> PackedGraph:
    """Run the staged build pipeline and return the packed graph.

    ``X`` (numpy or tensor) moves to ``device`` (default: the CUDA device;
    ``device="cpu"`` runs the plain path).  ``timings``, when given, is
    filled with each stage's wall seconds (the device synchronised at each
    stage boundary)."""
    dev = resolve_device(device)
    names = tuple(stages if stages is not None
                  else getattr(cfg, "build_pipeline",
                               ("knn", "diversify", "bridges")))
    fns = [(n, get_stage(n)) for n in names]  # resolve before any compute
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32).contiguous()
    state = BuildState(
        X=M.preprocess(X, cfg.metric), cfg=cfg, tile=tile,
        backend=resolve_backend(getattr(cfg, "kernel_backend", "auto"), dev),
        knn_ids=knn_ids, knn_dists=knn_dists)
    for name, fn in fns:
        t0 = time.perf_counter()
        fn(state)
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings[name] = time.perf_counter() - t0
    if state.neighbors is None:
        raise ValueError(
            f"build pipeline {names} produced no graph — it must include a "
            "stage that sets state.neighbors/lambdas/degrees "
            "(e.g. 'diversify')")
    return PackedGraph(neighbors=state.neighbors, lambdas=state.lambdas,
                       degrees=state.degrees, hubs=state.hubs,
                       perm=state.perm)
