"""GraphSAGE fanout neighbor sampler (the `minibatch_lg` substrate): the
port's copy of the reference's ``data/sampler.py`` (numpy only), so one
seed gives the same subgraphs bit for bit in either package.

Host-side CSR + with-replacement layered sampling, producing *fixed-shape*
subgraph batches (padded/self-looped).  The CSR's stable sort runs as
two radix passes (``graphs.stable_argsort``), the same order.  The port
adds
:func:`fanout_neighbors`, the subgraph's edges as a fixed-degree
neighbour matrix (the layout the ``packed_spmm`` kernel reads), and
:class:`SampledStream` puts it in each batch under ``"neighbors"``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.graphs import stable_argsort


class NeighborSampler:
    def __init__(self, edge_src: np.ndarray, edge_dst: np.ndarray,
                 n_nodes: int):
        order = stable_argsort(edge_dst)
        self.nbr = edge_src[order]  # neighbors grouped by dst
        counts = np.bincount(edge_dst, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.n_nodes = n_nodes

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> np.ndarray:
        """[B] -> [B, fanout] sampled in-neighbors (self-loop when isolated)."""
        starts = self.offsets[nodes]
        degs = self.offsets[nodes + 1] - starts
        r = rng.integers(0, 2 ** 31, size=(len(nodes), fanout))
        idx = starts[:, None] + r % np.maximum(degs, 1)[:, None]
        out = self.nbr[np.minimum(idx, len(self.nbr) - 1)]
        return np.where(degs[:, None] > 0, out, nodes[:, None])

    def sample_subgraph(self, seeds: np.ndarray, fanouts,
                        rng: np.random.Generator):
        """Layered fanout sample -> packed local subgraph (fixed shapes).

        Nodes: [seeds | layer-1 samples | layer-2 samples | ...] with
        duplicates kept (fixed shapes); edges point sampled->parent.
        """
        layers = [seeds.astype(np.int64)]
        src_l, dst_l = [], []
        base = 0
        for f in fanouts:
            parents = layers[-1]
            nbrs = self.sample_neighbors(parents, f, rng)     # [P, f]
            child_base = base + len(parents)
            src = (child_base
                   + np.arange(parents.size * f)).astype(np.int64)
            dst = (base + np.repeat(np.arange(parents.size), f)).astype(
                np.int64)
            src_l.append(src)
            dst_l.append(dst)
            layers.append(nbrs.reshape(-1))
            base = child_base
        nodes = np.concatenate(layers)
        seed_mask = np.zeros(len(nodes), bool)
        seed_mask[: len(seeds)] = True
        return {
            "node_ids": nodes.astype(np.int64),
            "edge_src": np.concatenate(src_l).astype(np.int32),
            "edge_dst": np.concatenate(dst_l).astype(np.int32),
            "seed_mask": seed_mask,
        }


def subgraph_sizes(batch_nodes: int, fanouts) -> tuple:
    """(n_sub_nodes, n_sub_edges) for fixed-shape compilation."""
    n, e, layer = batch_nodes, 0, batch_nodes
    for f in fanouts:
        e += layer * f
        layer *= f
        n += layer
    return n, e


def fanout_neighbors(batch_nodes: int, fanouts, edge_mask=None) -> np.ndarray:
    """The edges of a :meth:`NeighborSampler.sample_subgraph` subgraph as
    an [N, max(fanouts)] int32 neighbour matrix: row i holds, in edge
    order, the ``edge_src`` of the edges whose ``edge_dst`` is i.

    The subgraph's layout depends only on (batch_nodes, fanouts): node p
    of layer l (of P_l nodes from ``base_l``) has its f_l children at
    ``base_l + P_l + p * f_l + [0, f_l)``, and its edges at the same
    offsets from the layer's first edge.  Lanes past a row's f_l, the
    last layer's rows and the edges that ``edge_mask`` [E] clears hold the
    sentinel N, which names no node."""
    n, e = subgraph_sizes(batch_nodes, fanouts)
    if edge_mask is not None and len(edge_mask) != e:
        raise ValueError(f"edge_mask has {len(edge_mask)} edges, the "
                         f"subgraph {e}")
    out = np.full((n, max(fanouts, default=0)), n, np.int32)
    base, first_edge, layer = 0, 0, batch_nodes
    for f in fanouts:
        kids = base + layer + np.arange(layer * f).reshape(layer, f)
        if edge_mask is not None:
            kids = np.where(np.asarray(edge_mask[first_edge:first_edge
                                                 + layer * f],
                                       bool).reshape(layer, f), kids, n)
        out[base:base + layer, :f] = kids
        base, first_edge, layer = base + layer, first_edge + layer * f, \
            layer * f
    return out


class SampledStream:
    """Iterator of device-ready minibatches over a big host graph: the
    reference's batches, plus ``"neighbors"``, the subgraph's
    :func:`fanout_neighbors` (the same for every batch)."""

    def __init__(self, graph: dict, batch_nodes: int, fanouts,
                 seed: int = 0):
        self.g = graph
        self.sampler = NeighborSampler(graph["edge_src"], graph["edge_dst"],
                                       graph["node_feat"].shape[0])
        self.batch_nodes = batch_nodes
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)
        self.neighbors = fanout_neighbors(batch_nodes, self.fanouts)

    def __iter__(self):
        return self

    def __next__(self):
        n = self.g["node_feat"].shape[0]
        seeds = self.rng.integers(0, n, size=self.batch_nodes)
        sub = self.sampler.sample_subgraph(seeds, self.fanouts, self.rng)
        ids = sub["node_ids"]
        return {
            "node_feat": self.g["node_feat"][ids],
            "edge_src": sub["edge_src"],
            "edge_dst": sub["edge_dst"],
            "edge_mask": np.ones(len(sub["edge_src"]), bool),
            "node_mask": np.ones(len(ids), bool),
            "labels": self.g["labels"][ids],
            "seed_mask": sub["seed_mask"],
            "neighbors": self.neighbors,
        }
