"""The grouping of a gather's lanes by the row they read
(``repro_torch.kernels.lane_groups``), shared by the two training backward
kernels, and its plumbing through GraphSAGE, on the CPU.

* ``lane_groups_plain`` against numpy's stable argsort on the cases the
  card tests hold the kernels to (uniform, Zipf-skewed, one hot row in
  every row of lanes, one row read by more than 2^16 lanes, every lane
  invalid, no lane at all, rows far more than lanes, one row, rows that
  need 31 bits): every integer equal.
* ``SpmmPlan`` on CPU tensors: its integers are the plain version's, and
  ``packed_spmm_bwd`` ignores it.
* ``models/gnn.py``: one plan a forward, handed to both GraphSAGE layers,
  made for the batch's neighbour matrix over h's rows; none on the plain
  route; the logits and gradients unchanged by it.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.kernels import segment_matmul as SM
from repro_torch.kernels.lane_groups import lane_groups_plain
from repro_torch.models import gnn as G
from repro_torch.models import module
from repro_torch.optim.tree import tree_leaves
from repro_torch.train.trainer import _grads_of

torch.set_num_threads(1)


def _targets(case: str):
    """(targets [N, M] int64 numpy, -1 for a lane that reads none, and
    the rows R)."""
    rng = np.random.default_rng([30, CASES.index(case)])
    if case == "uniform":
        return rng.integers(-1, 1000, size=(300, 7)), 1000
    if case == "zipf":
        return np.minimum(rng.zipf(1.3, size=(500, 10)) - 1, 4999), 5000
    if case == "hot":
        t = rng.integers(0, 64, size=(400, 10))
        t[:, 0] = 5
        return t, 64
    if case == "past_2^16":
        t = np.full((9000, 8), 3)
        t[::7, 2] = 11
        return t, 20
    if case == "all_invalid":
        return np.full((300, 7), -1), 90
    if case == "no_lanes":
        return np.zeros((50, 0), np.int64), 10
    if case == "no_rows":
        return np.zeros((0, 15), np.int64), 10
    if case == "rows_far_above_lanes":
        return rng.integers(0, 10 ** 7, size=(100, 15)), 10 ** 7
    if case == "one_row":
        return np.where(rng.random((200, 5)) < 0.8, 0, -1), 1
    if case == "31_bits":
        R = 2 ** 31 - 1
        t = rng.integers(0, R, size=(256, 9))
        t[::5, 1] = R - 1
        return t, R
    raise ValueError(case)


CASES = ["uniform", "zipf", "hot", "past_2^16", "all_invalid", "no_lanes",
         "no_rows", "rows_far_above_lanes", "one_row", "31_bits"]


def _numpy_groups(t):
    flat = t.reshape(-1)
    valid = np.flatnonzero(flat >= 0)
    order = np.argsort(flat[valid], kind="stable")
    lanes = valid[order]
    rows, first, per = np.unique(flat[lanes], return_index=True,
                                 return_counts=True)
    counts = (t >= 0).sum(1)
    return {"lanes": lanes, "rows": rows,
            "starts": np.append(first, len(lanes)),
            "counts": counts, "active": np.flatnonzero(counts > 0)}


@pytest.mark.parametrize("case", CASES)
def test_lane_groups_plain_matches_numpy(case):
    t, R = _targets(case)
    got = lane_groups_plain(torch.from_numpy(t), R)
    want = _numpy_groups(t)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.int64, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert int(got["starts"][-1]) == len(got["lanes"])
    # each row's lanes in lane order
    for lo, hi in zip(got["starts"][:-1].tolist(),
                      got["starts"][1:].tolist()):
        assert bool((got["lanes"][lo + 1:hi] > got["lanes"][lo:hi - 1])
                    .all())


def test_lane_groups_plain_rejects():
    with pytest.raises(ValueError, match="below"):
        lane_groups_plain(torch.tensor([[0, 5]]), 5)
    with pytest.raises(ValueError, match=r"\[N, M\]"):
        lane_groups_plain(torch.tensor([0, 1]), 5)


def test_spmm_plan_on_the_cpu():
    """The plan's integers on CPU tensors are the plain version's over the
    neighbour matrix's targets (ids >= Nf read none, a negative id reads
    row 0); nothing is built; ``packed_spmm_bwd`` ignores a plan."""
    rng = np.random.default_rng(30)
    N, M, Nf = 40, 6, 30
    nbrs = torch.from_numpy(rng.integers(-2, Nf + 8, size=(N, M))
                            .astype(np.int32))
    plan = SM.SpmmPlan(nbrs, Nf)
    assert plan.build() is plan and plan.groups is None
    t = np.where(nbrs.numpy() < Nf, np.maximum(nbrs.numpy(), 0), -1)
    got = plan.integers()
    for k, v in _numpy_groups(t).items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert plan.matches(nbrs, Nf) and not plan.matches(nbrs, Nf + 1)
    assert not plan.matches(nbrs.clone(), Nf)
    feat = torch.from_numpy(rng.normal(size=(Nf, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    for combine in ("mean", "sum"):
        with_plan = SM.packed_spmm_bwd(nbrs, feat, w, dout, combine=combine,
                                       plan=plan)
        without = SM.packed_spmm_bwd(nbrs, feat, w, dout, combine=combine)
        assert all(torch.equal(a, b) for a, b in zip(with_plan, without))


def _sage():
    """A reduced GraphSAGE (mean) and a sampled batch with its neighbour
    matrix (fanout (4, 3) from 8 seeds), in float32."""
    from repro_torch.data.sampler import fanout_neighbors, subgraph_sizes

    cfg = C.get_reduced("graphsage-reddit")
    d_feat, n_classes = 12, 5
    model = G.GNN(cfg, module.init_params(
        G.schema(cfg, d_feat, n_classes), torch.Generator().manual_seed(0),
        device=torch.device("cpu")))
    rng = np.random.default_rng(31)
    n, e = subgraph_sizes(8, (4, 3))
    nbrs = fanout_neighbors(8, (4, 3))
    src = nbrs[nbrs < n]
    dst = np.repeat(np.arange(n), (nbrs < n).sum(1))
    batch = {"node_feat": rng.normal(size=(n, d_feat)).astype(np.float32),
             "edge_src": src.astype(np.int32),
             "edge_dst": dst.astype(np.int32),
             "labels": rng.integers(0, n_classes, size=n).astype(np.int32),
             "neighbors": nbrs}
    assert len(src) == e
    return cfg, model, G.batch_to(batch, torch.device("cpu"))


def test_gnn_forward_hands_one_plan_to_every_layer(monkeypatch):
    """With the kernel route taken (``use_kernel`` made true on the CPU),
    ``forward`` makes one ``SpmmPlan`` of the batch's neighbour matrix over
    h's rows and hands it to each layer's ``packed_spmm``; the logits and
    the gradients equal those of the plain route (which makes none) bit for
    bit, since a plan changes nothing on CPU tensors."""
    cfg, model, batch = _sage()
    seen = []
    real = G._sm.packed_spmm

    def spy(nbrs, h, w, **kw):
        seen.append(kw.get("plan"))
        return real(nbrs, h, w, **kw)

    monkeypatch.setattr(G._sm, "packed_spmm", spy)
    monkeypatch.setattr(G, "use_kernel",
                        lambda backend, device: backend != "torch")
    g, m = _grads_of(lambda p, b: G.loss_fn(p, cfg, b), model.tree(), batch)
    assert len(seen) == cfg.n_layers and seen[0] is not None
    assert all(p is seen[0] for p in seen)
    plan = seen[0]
    assert plan.neighbors is batch["neighbors"]
    assert plan.num_rows == batch["node_feat"].shape[0]
    seen.clear()
    g_p, m_p = _grads_of(lambda p, b: G.loss_fn(p, cfg, b,
                                                kernel_backend="torch"),
                         model.tree(), batch)
    assert seen == []
    assert torch.equal(m["loss"], m_p["loss"])
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g), tree_leaves(g_p)))
