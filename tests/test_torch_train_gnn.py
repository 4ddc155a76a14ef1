"""Training of the graph family on the port (``models/gnn.py`` and
``models/mace.py`` ``loss_fn``, ``kernels/segment_matmul.py``'s gradient,
the launcher's ``gnn`` branch) against the JAX reference, on the CPU.

The reference's weights (``init_params`` with ``jax.random.key(0)``, the
zero-init leaves drawn from numpy so that each moves the loss) and the
same numpy graphs go through both packages, at reduced widths and a few
hundred nodes.  The oracles are ``jax.value_and_grad(loss_fn)`` and
``make_train_step``, each under ``jax.jit`` without a mesh.  Tolerances
(float32 on both sides, sums in different orders):

* the loss within 1e-5 relative, ``acc`` exactly;
* each gradient leaf within 1e-4 of that leaf's largest |g| (MACE's
  forces are a second derivative: 1e-3);
* ``packed_spmm_bwd_plain``: dfeat and dw within 1e-5 of the sum of the
  terms' magnitudes (|dout| @ |w^T| summed over a row's lanes, |agg|^T @
  |dout|), against autograd and against ``jax.grad`` of the reference's
  ``ops.packed_spmm(use_pallas=False)``;
* a train step's parameters: AdamW's first update is +-lr wherever
  g != 0, so an element whose reference gradient lies inside the
  gradient tolerance may step the other way: those within 2 lr, the rest
  within 1e-5 of the leaf's largest |p|; AdamW's state carried from the
  reference (``convert.opt_state_from_reference``) has the port's
  layout, and the port's m within 1e-4 and v within 3e-4 of the leaf's
  largest (v squares the gradient's error).
"""
import dataclasses
import io
import os
import shutil
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ops as jops
from repro.models import gnn as JG
from repro.models import mace as JMC
from repro.models import module as jmodule
from repro.optim import api as japi
from repro.train import trainer as jtrainer
from repro_torch import configs as C
from repro_torch.data import graphs as DG
from repro_torch.data import sampler as S
from repro_torch.kernels import segment_matmul as SM
from repro_torch.launch import train as launch
from repro_torch.models import convert
from repro_torch.models import gnn as G
from repro_torch.models import mace as MC
from repro_torch.models.module import leaves
from repro_torch.optim import api as tapi
from repro_torch.optim.tree import tree_map
from repro_torch.train import trainer as ttrainer

torch.set_num_threads(1)
D_FEAT, N_CLASSES = 12, 5


def _cfgs(arch, **knobs):
    return (dataclasses.replace(jbase.get_reduced(arch), **knobs),
            dataclasses.replace(C.get_reduced(arch), **knobs))


def _ref_params(sch, seed=29):
    """The reference's weights as numpy arrays, each zero-init leaf drawn
    from numpy (N(0, 0.1^2))."""
    params = jax.tree.map(np.asarray, jmodule.init_params(
        sch, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten(params)
    specs = jax.tree_util.tree_flatten(sch, is_leaf=jmodule.is_param_spec)[0]
    flat = [(0.1 * rng.normal(size=a.shape)).astype(np.float32)
            if s.init == "zeros" else a for a, s in zip(flat, specs)]
    return jax.tree_util.tree_unflatten(treedef, flat)


def _ttree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "neighbors"}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close_tree(got, want, tol):
    want = dict(leaves(jax.tree.map(np.asarray, want)))
    got = dict(leaves(got))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape, path
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (path, err, np.abs(w).max())


def _check_loss(jloss, jcfg, tloss, tree, batch, tol=1e-4, metric="acc"):
    """loss_fn's value, a metric and the gradient tree of both packages."""
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, jcfg, b), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), _jbatch(batch))
    g, tm = ttrainer._grads_of(tloss, _ttree(tree), _tbatch(batch))
    assert abs(float(tm["loss"]) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(tm[metric]) - float(jm[metric])) <= \
        1e-5 * max(1.0, abs(float(jm[metric])))
    _close_tree(g, jg, tol)


def _community():
    return DG.make_community_graph(200, 800, D_FEAT, n_classes=N_CLASSES,
                                   seed=0)


def _sampled():
    return next(S.SampledStream(_community(), 8, (3, 2), seed=0))


# ----------------------------------------------------------------------
# packed_spmm's gradient
# ----------------------------------------------------------------------

def _spmm_case(rng, N, M, Nf, d, f, *, empty_rows=0, sentinel=0.3,
               negative=False, repeat=False):
    """neighbors with sentinel lanes (id Nf and above), ``empty_rows``
    rows of sentinels only, optionally a negative id and one id repeated
    in a row and across rows."""
    nbrs = rng.integers(0, Nf, size=(N, M)).astype(np.int32)
    nbrs[rng.random((N, M)) < sentinel] = Nf + rng.integers(0, 3)
    nbrs[:empty_rows] = Nf
    if repeat:
        nbrs[empty_rows:, 0] = 1
        nbrs[empty_rows:, -1] = 1
    if negative and N > empty_rows:
        nbrs[empty_rows, 0] = -1
    feat = rng.normal(size=(Nf, d)).astype(np.float32)
    w = rng.normal(size=(d, f)).astype(np.float32)
    dout = rng.normal(size=(N, f)).astype(np.float32)
    return nbrs, feat, w, dout


def _spmm_bounds(nbrs, feat, w, dout, combine):
    """|terms| of dfeat and dw: the tolerances' scales."""
    t = [torch.from_numpy(np.abs(a)) if a.dtype != np.int32
         else torch.from_numpy(a) for a in (nbrs, feat, w, dout)]
    return SM.packed_spmm_bwd_plain(t[0], t[1], t[2], t[3], combine=combine)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("N,M,Nf,kw", [
    (7, 4, 5, dict(empty_rows=2, repeat=True)),      # Nf below N
    (6, 3, 30, dict(empty_rows=6)),                  # every row empty
    (9, 5, 20, dict(negative=True, repeat=True)),    # Nf above N
    (1, 1, 1, dict(sentinel=0.0))])
def test_packed_spmm_bwd_plain_matches_autograd_and_reference(combine, N, M,
                                                              Nf, kw):
    rng = np.random.default_rng([N, M, Nf])
    nbrs, feat, w, dout = _spmm_case(rng, N, M, Nf, 6, 4, **kw)
    tn = torch.from_numpy(nbrs)
    tf = torch.from_numpy(feat).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = SM.packed_spmm(tn, tf, tw, combine=combine)
    auto = torch.autograd.grad(out, (tf, tw), torch.from_numpy(dout))
    dfeat, dw = SM.packed_spmm_bwd_plain(tn, tf.detach(), tw.detach(),
                                         torch.from_numpy(dout),
                                         combine=combine)
    _, vjp = jax.vjp(lambda a, b: jops.packed_spmm(
        jnp.asarray(nbrs), a, b, combine=combine, use_pallas=False),
        jnp.asarray(feat), jnp.asarray(w))
    jf, jw = (np.asarray(x) for x in vjp(jnp.asarray(dout)))
    bf, bw = _spmm_bounds(nbrs, feat, w, dout, combine)
    for got, a, j, b in ((dfeat, auto[0], jf, bf), (dw, auto[1], jw, bw)):
        tol = 1e-5 * b.numpy() + 1e-30
        assert np.all(np.abs(got.numpy() - a.numpy()) <= tol)
        assert np.all(np.abs(got.numpy() - j) <= tol)
    # rows no valid lane reads get exact zeros
    read = np.zeros(Nf, bool)
    read[np.clip(nbrs[nbrs < Nf], 0, None)] = True
    assert np.all(dfeat.numpy()[~read] == 0)


def test_packed_spmm_bwd_cpu_wrapper_and_need():
    """On the CPU the wrapper is the plain version; an unasked gradient is
    None; no launch is counted."""
    from repro_torch import kernels as K

    rng = np.random.default_rng(1)
    nbrs, feat, w, dout = (torch.from_numpy(a) for a in
                           _spmm_case(rng, 5, 3, 4, 3, 2))
    n0 = K.launch_counts()["packed_spmm_bwd"]
    dfeat, dw = SM.packed_spmm_bwd(nbrs, feat, w, dout, combine="mean",
                                   need_w=False)
    assert dw is None
    assert torch.equal(dfeat, SM.packed_spmm_bwd_plain(
        nbrs, feat, w, dout, combine="mean")[0])
    assert K.launch_counts()["packed_spmm_bwd"] == n0
    with pytest.raises(ValueError):
        SM.packed_spmm_bwd_plain(nbrs, feat, w, dout, combine="max")


# ----------------------------------------------------------------------
# loss_fn against jax.value_and_grad
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,data,knobs", [
    ("gin-tu", "molecules", {}),                       # graph_ids
    ("gatedgcn", "community", {}),                     # node_mask
    ("graphsage-reddit", "sampled_edges", {}),         # seed_mask
    ("graphsage-reddit", "sampled", {}),               # neighbors, mean
    ("graphsage-reddit", "sampled", {"aggregator": "sum"})])
def test_gnn_loss_and_grads_match_reference(arch, data, knobs):
    jcfg, tcfg = _cfgs(arch, **knobs)
    batch = {"molecules": lambda: DG.molecule_batch_for_gnn(
        3, 8, 20, d_feat=D_FEAT, n_classes=N_CLASSES),
        "community": _community, "sampled": _sampled,
        "sampled_edges": lambda: {k: v for k, v in _sampled().items()
                                  if k != "neighbors"}}[data]()
    assert ("neighbors" in batch) == (data == "sampled")
    tree = _ref_params(JG.schema(jcfg, D_FEAT, N_CLASSES))
    _check_loss(JG.loss_fn, jcfg, lambda p, b: G.loss_fn(p, tcfg, b), tree,
                batch)


def _molecule_batch(forces: bool):
    batch = DG.make_molecules(2, 6, 12, seed=3)
    if forces:
        batch["forces"] = np.random.default_rng(4).normal(
            size=batch["positions"].shape).astype(np.float32)
    return batch


@pytest.mark.parametrize("forces", [False, True])
def test_mace_loss_and_grads_match_reference(forces):
    jcfg, tcfg = _cfgs("mace")
    tree = _ref_params(JMC.schema(jcfg))
    batch = _molecule_batch(forces)
    _check_loss(JMC.loss_fn, jcfg, lambda p, b: MC.loss_fn(p, tcfg, b), tree,
                batch, tol=1e-3 if forces else 1e-4, metric="energy_mae")
    if forces:
        _, jm = jax.jit(lambda p, b: JMC.loss_fn(p, jcfg, b))(
            jax.tree.map(jnp.asarray, tree), _jbatch(batch))
        _, tm = MC.loss_fn(_ttree(tree), tcfg, _tbatch(batch))
        assert abs(float(tm["force_mse"].detach()) - float(
            jm["force_mse"])) <= 1e-4 * abs(float(jm["force_mse"]))


# ----------------------------------------------------------------------
# one train step against the reference's jitted make_train_step
# ----------------------------------------------------------------------

def _check_step(jloss, tloss, tree, batch, lr=1e-3):
    kw = dict(lr=lr, schedule="constant")
    jopt = japi.make_optimizer(japi.OptimizerConfig(**kw))
    jp = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(jtrainer.make_train_step(jloss, jopt))
    jp1, js1, jm = jstep(jp, jopt.init(jp), _jbatch(batch))
    _, jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, _jbatch(batch))
    topt = tapi.make_optimizer(tapi.OptimizerConfig(**kw))
    tp = _ttree(tree)
    step = ttrainer.make_train_step(tloss, topt)
    tp, ts, tm = step(tp, topt.init(tp), _tbatch(batch))
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    jg = dict(leaves(jax.tree.map(np.asarray, jg)))
    want = dict(leaves(jax.tree.map(np.asarray, jp1)))
    for path, p in leaves(tp):
        w, gref = want[path], jg[path]
        flip = np.abs(gref) <= 1e-4 * np.abs(gref).max()
        diff = np.abs(p.numpy() - w)
        assert diff[flip].max(initial=0.0) <= 2 * lr, path
        assert diff[~flip].max(initial=0.0) <= 1e-5 * np.abs(w).max(), path
    # the reference's AdamW state carried into the port's layout
    carried = convert.opt_state_from_reference(
        jax.tree.map(np.asarray, js1), device="cpu")
    assert int(carried["count"]) == int(ts["count"]) == 1
    for key, tol in (("m", 1e-4), ("v", 3e-4)):
        assert [k for k, _ in leaves(carried[key])] == \
            [k for k, _ in leaves(ts[key])]
        _close_tree(ts[key], jax.tree.map(np.asarray, js1[key]), tol)


@pytest.mark.parametrize("family", ["graphsage", "mace"])
def test_train_step_matches_reference(family):
    if family == "mace":
        jcfg, tcfg = _cfgs("mace")
        tree = _ref_params(JMC.schema(jcfg))
        _check_step(lambda p, b: JMC.loss_fn(p, jcfg, b),
                    lambda p, b: MC.loss_fn(p, tcfg, b), tree,
                    _molecule_batch(False))
        return
    jcfg, tcfg = _cfgs("graphsage-reddit")
    tree = _ref_params(JG.schema(jcfg, D_FEAT, N_CLASSES))
    _check_step(lambda p, b: JG.loss_fn(p, jcfg, b),
                lambda p, b: G.loss_fn(p, tcfg, b), tree, _sampled())


# ----------------------------------------------------------------------
# the launcher's gnn branch
# ----------------------------------------------------------------------

def run_launcher(monkeypatch, *args) -> str:
    """``python -m repro_torch.launch.train ARGS --reduced --device cpu``
    in this process; returns what it printed."""
    monkeypatch.setattr(sys, "argv", ["train", *args, "--reduced",
                                      "--device", "cpu"])
    out = io.StringIO()
    with redirect_stdout(out):
        launch.main()
    return out.getvalue()


def check_resume(monkeypatch, tmp_path, arch: str):
    """20 steps (checkpoints at 10 and 20), against a restart from the
    step-10 checkpoint alone with ``--resume``: its step-20 checkpoint
    equals the uninterrupted one file for file."""
    a, b = tmp_path / "a", tmp_path / "b"
    out = run_launcher(monkeypatch, "--arch", arch, "--steps", "20",
                       "--ckpt-dir", str(a))
    assert "[train] loss" in out
    b.mkdir()
    shutil.copytree(a / "step_00000010", b / "step_00000010")
    (b / "latest").write_text("step_00000010")
    out = run_launcher(monkeypatch, "--arch", arch, "--steps", "20",
                       "--ckpt-dir", str(b), "--resume")
    assert "resumed from step 10" in out and "step    10 " in out
    names = sorted(os.listdir(a / "step_00000020"))
    assert names == sorted(os.listdir(b / "step_00000020"))
    for n in names:
        if n.endswith(".npy"):
            assert np.array_equal(np.load(a / "step_00000020" / n),
                                  np.load(b / "step_00000020" / n)), n


def test_neighbor_matrix_holds_the_edge_list():
    """The launcher's GraphSAGE batch: the community graph's neighbour
    matrix (masked edges left out, sentinel past each row's degree) gives
    the edge list's logits on the kernel route's plain version."""
    jcfg, tcfg = _cfgs("graphsage-reddit")
    graph = _community()
    graph["edge_mask"][::5] = False
    nbrs = DG.neighbor_matrix(graph["edge_src"], graph["edge_dst"], 200,
                              graph["edge_mask"])
    deg = np.bincount(graph["edge_dst"][graph["edge_mask"]], minlength=200)
    assert nbrs.shape == (200, deg.max())
    assert np.array_equal((nbrs < 200).sum(1), deg)
    tree = _ttree(_ref_params(JG.schema(jcfg, D_FEAT, N_CLASSES)))
    b = _tbatch(graph)
    edges = G.forward(tree, tcfg, b)
    packed = G.forward(tree, tcfg, dict(b, neighbors=torch.from_numpy(nbrs)))
    assert torch.allclose(packed, edges, rtol=0,
                          atol=1e-5 * float(edges.abs().max()))


def test_launcher_gnn_trains_and_resumes(monkeypatch, tmp_path):
    check_resume(monkeypatch, tmp_path, "graphsage-reddit")
    out = run_launcher(monkeypatch, "--arch", "mace", "--steps", "2",
                       "--ckpt-dir", str(tmp_path / "m"))
    assert "family=gnn" in out and "energy_mae=" in out
