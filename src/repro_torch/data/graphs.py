"""Synthetic graph datasets matching the assigned GNN shape specs: the
port's copy of the reference's ``data/graphs.py`` (numpy only), so one
seed gives the same graphs bit for bit in either package.
``make_community_graph`` groups the intra-community edges with one
stable sort where the reference scans every edge once a community: the
same draws in the same order, about twice as fast at Reddit's 114.6 M
edges."""
from __future__ import annotations

import numpy as np


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for non-negative integer keys
    below 2^32, as two stable passes over 16-bit digits (numpy sorts
    16-bit keys by radix, in linear time; its stable sort of wider keys
    is a merge sort)."""
    keys = np.asarray(keys)
    if keys.size and (keys.min() < 0 or keys.max() >= 2 ** 32):
        raise ValueError("keys must lie in [0, 2^32)")
    low = np.argsort((keys & 0xFFFF).astype(np.uint16), kind="stable")
    high = np.argsort((keys[low] >> 16).astype(np.uint16), kind="stable")
    return low[high]


def make_community_graph(n_nodes: int, n_edges: int, d_feat: int,
                         n_classes: int = 16, p_intra: float = 0.9,
                         seed: int = 0):
    """SBM-ish node-classification graph: label = community (learnable)."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_classes, size=n_nodes)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feat = centers[comm] + 0.8 * rng.normal(size=(n_nodes, d_feat)) \
        .astype(np.float32)
    src = rng.integers(0, n_nodes, size=n_edges)
    intra = rng.random(n_edges) < p_intra
    # intra edges: pick a random node of the same community via shuffled index
    by_comm = [np.flatnonzero(comm == c) for c in range(n_classes)]
    dst = rng.integers(0, n_nodes, size=n_edges)
    # the intra edges grouped by their source's community, each group in
    # edge order (one stable sort, where the reference scans all edges
    # once a community): the same draws, in the same order
    edges = np.flatnonzero(intra)
    owner = comm[src[edges]]
    edges = edges[stable_argsort(owner)]
    bounds = np.concatenate([[0], np.cumsum(np.bincount(
        owner, minlength=n_classes))])
    for c in range(n_classes):
        m = edges[bounds[c]:bounds[c + 1]]
        if len(m) and len(by_comm[c]):
            dst[m] = rng.choice(by_comm[c], size=len(m))
    return {
        "node_feat": feat.astype(np.float32),
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
        "node_mask": np.ones(n_nodes, bool),
        "edge_mask": np.ones(n_edges, bool),
        "labels": comm.astype(np.int32),
    }


def neighbor_matrix(edge_src: np.ndarray, edge_dst: np.ndarray,
                    n_nodes: int, edge_mask=None) -> np.ndarray:
    """The edges as a fixed-degree [n_nodes, max in-degree] int32
    neighbour matrix (the port's, for ``packed_spmm``): row i holds, in
    edge order, the ``edge_src`` of the edges whose ``edge_dst`` is i,
    then the sentinel ``n_nodes``.  Edges that ``edge_mask`` clears are
    left out.  GraphSAGE's mean or sum over it is the edge list's."""
    keep = np.ones(len(edge_src), bool) if edge_mask is None \
        else np.asarray(edge_mask, bool)
    src = np.asarray(edge_src)[keep]
    dst = np.asarray(edge_dst)[keep].astype(np.int64)
    order = np.argsort(dst, kind="stable")
    deg = np.bincount(dst, minlength=n_nodes)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(len(order)) - start[dst[order]]
    out = np.full((n_nodes, max(int(deg.max(initial=0)), 1)), n_nodes,
                  np.int32)
    out[dst[order], slot] = src[order]
    return out


def make_molecules(batch: int, n_nodes: int, n_edges: int,
                   n_species: int = 10, r_cut: float = 5.0, seed: int = 0,
                   with_forces: bool = False):
    """Batched point-cloud molecules; energy = softened LJ pair sum
    (a real geometric target so MACE training reduces loss)."""
    rng = np.random.default_rng(seed)
    G, Nn, Ne = batch, n_nodes, n_edges
    pos = rng.uniform(0, 4.0, size=(G, Nn, 3)).astype(np.float32)
    species = rng.integers(0, n_species, size=(G, Nn)).astype(np.int32)
    # per-graph radius-ish edges: take Ne closest pairs
    src = np.zeros((G, Ne), np.int32)
    dst = np.zeros((G, Ne), np.int32)
    emask = np.zeros((G, Ne), bool)
    energy = np.zeros((G,), np.float32)
    for g in range(G):
        diff = pos[g][:, None] - pos[g][None, :]
        dist = np.sqrt((diff ** 2).sum(-1) + 1e-12)
        iu = np.triu_indices(Nn, k=1)
        order = np.argsort(dist[iu])
        take = order[: Ne // 2]
        s, d = iu[0][take], iu[1][take]
        both_s = np.concatenate([s, d])[:Ne]
        both_d = np.concatenate([d, s])[:Ne]
        src[g, : len(both_s)] = both_s
        dst[g, : len(both_d)] = both_d
        emask[g, : len(both_s)] = True
        r = dist[s, d]
        r6 = (1.2 / np.maximum(r, 0.7)) ** 6
        energy[g] = np.sum(r6 * r6 - 2 * r6).astype(np.float32)
    # flatten to one packed batch
    offs = (np.arange(G) * Nn)[:, None]
    batch_out = {
        "positions": pos.reshape(G * Nn, 3),
        "species": species.reshape(-1),
        "edge_src": (src + offs).reshape(-1).astype(np.int32),
        "edge_dst": (dst + offs).reshape(-1).astype(np.int32),
        "edge_mask": emask.reshape(-1),
        "node_mask": np.ones(G * Nn, bool),
        "graph_ids": np.repeat(np.arange(G, dtype=np.int32), Nn),
        # standardized energies (O(1) regression target)
        "energies": ((energy - energy.mean())
                     / max(energy.std(), 1e-6)).astype(np.float32),
    }
    return batch_out


def molecule_batch_for_gnn(batch: int, n_nodes: int, n_edges: int,
                           d_feat: int = 16, n_classes: int = 8,
                           seed: int = 0):
    """Graph-classification variant for GIN/GatedGCN molecule cells."""
    rng = np.random.default_rng(seed)
    G = batch
    mol = make_molecules(batch, n_nodes, n_edges, seed=seed)
    feat = rng.normal(size=(G * n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=G).astype(np.int32)
    return {
        "node_feat": feat,
        "edge_src": mol["edge_src"], "edge_dst": mol["edge_dst"],
        "edge_mask": mol["edge_mask"], "node_mask": mol["node_mask"],
        "graph_ids": mol["graph_ids"],
        "labels": labels,
    }
