"""The port's Wide & Deep (``repro_torch.models.recsys``, ``configs``,
``data/recsys.py``, ``convert.recsys_params_from_reference``) against the
JAX reference, on the CPU.

The reference's weights (``init_params`` with ``jax.random.key(0)`` on
the reduced config; the wide table, zeros at init, drawn from numpy so
that the hashes matter) are carried into the port, and the same numpy
batches go through both.  Integers are equal exactly: the batches, the
wide branch's hash buckets, the retrieval ids off ties.  Floats (both
sides compute in float32 and sum in different orders):

* bags within 1e-6 * the bag's sum of |rows| (the kernel contract);
* the deep activations within 1e-5 of their largest |entry|, the wide
  logit within 1e-5 of its largest sum of |terms|;
* logits within 1e-7 * the forward's absolute scale (the same network on
  |x| and |W|, the scale its rounding errors grow with; fp32's unit
  roundoff is 6e-8), and probabilities within 1e-6 plus sigmoid'(z)
  times that: three float32 products in another order move a logit by a
  few ulps of the terms it cancels, which moves the probability by more
  than 1e-6 where the logit is near 0;
* retrieval scores within 1e-5 of the largest |score|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data.recsys import CTRStream as JCTRStream
from repro.models import module as jmodule
from repro.models import recsys as JR
from repro_torch import configs as C
from repro_torch.configs import base as tbase
from repro_torch.data.recsys import CTRStream
from repro_torch.models import convert, module
from repro_torch.models import recsys as R

torch.set_num_threads(1)
CPU = torch.device("cpu")
B = 256


@pytest.fixture(scope="module")
def ref_params():
    """The reference's reduced weights as numpy arrays, with a wide table
    drawn from numpy."""
    cfg = jbase.get_reduced("wide-deep")
    params = jax.tree.map(np.asarray, jmodule.init_params(
        JR.schema(cfg), jax.random.key(0)))
    params["wide"] = np.random.default_rng(25).normal(
        size=params["wide"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def model(ref_params):
    return convert.recsys_params_from_reference(
        ref_params, C.get_reduced("wide-deep"), device=CPU)


def _cfgs():
    return jbase.get_reduced("wide-deep"), C.get_reduced("wide-deep")


def _batch(cfg, n, seed=3):
    return next(CTRStream(cfg, n, seed=seed))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ----------------------------------------------------------------------
# configs and data
# ----------------------------------------------------------------------

def test_configs_equal_reference():
    for getter in ("get_arch", "get_reduced"):
        got = getattr(C, getter)("wide-deep")
        want = getattr(jbase, getter)("wide-deep")
        assert dataclasses.asdict(got) == dataclasses.asdict(want), getter
    cfg = C.get_arch("wide-deep")
    assert sum(cfg.vocab_sizes) == 49_360_000
    got = {k: (s.kind, s.dims) for k, s in tbase.shapes_for(cfg).items()}
    want = {k: (s.kind, s.dims)
            for k, s in jbase.shapes_for(jbase.get_arch("wide-deep")).items()}
    assert got == want
    assert got == {k: (s.kind, s.dims)
                   for k, s in tbase.RECSYS_SHAPES.items()}


@pytest.mark.parametrize("arch", ["gin-tu", "gatedgcn", "mace",
                                  "graphsage-reddit"])
def test_graph_archs_resolve_to_the_reference(arch):
    """The graph family, once unported, resolves to the reference's
    configs and shapes."""
    for getter in ("get_arch", "get_reduced"):
        got = getattr(C, getter)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            getattr(jbase, getter)(arch)), getter
    assert {k: (s.kind, s.dims) for k, s in C.shapes_for(
        C.get_arch(arch)).items()} == {k: (s.kind, s.dims) for k, s in
                                       jbase.GNN_SHAPES.items()}


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_ctr_stream_equals_reference(full, seed):
    """Bit for bit, batch after batch, at the reduced and the full-size
    vocabularies (ids up to 10^7 - 1)."""
    cfg = C.get_arch("wide-deep") if full else C.get_reduced("wide-deep")
    jcfg = jbase.get_arch("wide-deep") if full \
        else jbase.get_reduced("wide-deep")
    got, want = CTRStream(cfg, 64, seed=seed), JCTRStream(jcfg, 64,
                                                          seed=seed)
    for _ in range(2):
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("full", [False, True])
def test_schema_equals_reference(full):
    """The same leaves in the same order, with the same shapes, axes,
    initializers and standard deviations."""
    cfg = C.get_arch("wide-deep") if full else C.get_reduced("wide-deep")
    jcfg = jbase.get_arch("wide-deep") if full \
        else jbase.get_reduced("wide-deep")
    got = list(module.leaves(R.schema(cfg)))
    want = jax.tree_util.tree_flatten_with_path(
        JR.schema(jcfg), is_leaf=jmodule.is_param_spec)[0]
    assert [p for p, _ in got] == [
        ".".join(k.key for k in path) for path, _ in want]
    for (path, s), (_, w) in zip(got, want):
        assert (s.shape, s.logical_axes, s.init, s.scale) == (
            w.shape, w.logical_axes, w.init, w.scale), path
        std = {"zeros": 0.0, "ones": 0.0, "normal": w.scale,
               "embed": w.scale}[w.init]
        assert module.std(s) == std, path
    assert R.RETRIEVAL_DIM == JR.RETRIEVAL_DIM


def test_init_params_draws_each_leaf_at_its_std():
    cfg = C.get_reduced("wide-deep")
    gen = torch.Generator().manual_seed(0)
    tree = module.init_params(R.schema(cfg), gen, device=CPU)
    for path, spec in module.leaves(R.schema(cfg)):
        t = dict(module.leaves(tree))[path]
        assert tuple(t.shape) == spec.shape and t.dtype == torch.float32
        if module.std(spec) == 0:
            assert not t.any(), path
        elif t.numel() >= 1000:
            assert abs(float(t.std()) / module.std(spec) - 1) < 0.1, path


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

def _ref_wide_indices(cfg, sparse):
    """The reference's wide buckets, through its own ``_hash``, in the
    order of its ``user_tower``."""
    sparse = jnp.asarray(sparse)
    idx = [JR._hash(sparse[:, i] + np.int32(7919 * i), 13 * i + 1,
                    cfg.wide_hash_buckets) for i in range(cfg.n_sparse)]
    nc = min(8, cfg.n_sparse)
    for i in range(nc):
        for j in range(i + 1, nc):
            idx.append(JR._hash(sparse[:, i] * np.int32(31) + sparse[:, j],
                                97 * (i * nc + j) + 3, cfg.wide_hash_buckets))
    return np.asarray(jnp.stack(idx, axis=1))


@pytest.mark.parametrize("full", [False, True])
def test_wide_hash_equals_reference(full):
    """Exactly, through uint32 wrap-around: CTRStream's ids, each field's
    largest id, and at full size ids near 10^7, whose crosses
    sparse_i * 31 + sparse_j of the first 8 fields reach 3.2e8."""
    cfg = C.get_arch("wide-deep") if full else C.get_reduced("wide-deep")
    jcfg = jbase.get_arch("wide-deep") if full \
        else jbase.get_reduced("wide-deep")
    sparse = _batch(cfg, 512)["sparse_ids"]
    top = np.asarray(cfg.vocab_sizes, np.int64) - 1
    sparse[0] = top
    sparse[1] = 0
    sparse[2:34] = top - np.arange(32)[:, None]
    got = R.wide_indices(cfg, torch.from_numpy(sparse)).numpy()
    want = _ref_wide_indices(jcfg, sparse)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    # the hash alone over the whole int32 range, negatives included
    x = np.random.default_rng(1).integers(-2 ** 31, 2 ** 31, 4096,
                                          dtype=np.int64).astype(np.int32)
    x[:4] = (-2 ** 31, -1, 0, 2 ** 31 - 1)
    for a, buckets in ((1, 1_000_000), (6114, 1000), (2 ** 32 - 1, 7)):
        assert np.array_equal(
            R._hash(torch.from_numpy(x), a, buckets).numpy(),
            np.asarray(JR._hash(jnp.asarray(x), a, buckets)))


@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_bags_match_reference(model, combine):
    """The model's bags (the kernel's plain version on the CPU) against the
    reference's take + jnp.mean, within 1e-6 * the bag's sum of |rows|."""
    jcfg, cfg = _cfgs()
    batch = _batch(cfg, B)
    table = model.tables["field_0"].detach()
    ids = torch.from_numpy(batch["bags"][:, 0]).contiguous()
    got = R.embedding_bag(table, ids, combine=combine).numpy()
    want = np.asarray(JR.embedding_bag(jnp.asarray(table.numpy()),
                                       jnp.asarray(ids.numpy()),
                                       combine=combine))
    rows = np.abs(table.numpy()[ids.numpy()]).sum(1)
    scale = rows / (cfg.bag_size if combine == "mean" else 1)
    assert (np.abs(got - want) <= 1e-6 * scale).all()


def test_user_tower_matches_reference(model, ref_params):
    jcfg, cfg = _cfgs()
    batch = _batch(cfg, B)
    deep, wide = R.user_tower(model, cfg, R.batch_to(batch, CPU))
    jdeep, jwide = jax.jit(lambda p, b: JR.user_tower(p, jcfg, b))(
        ref_params, _jb(batch))
    jdeep, jwide = np.asarray(jdeep), np.asarray(jwide)
    assert deep.shape == jdeep.shape and wide.shape == jwide.shape
    assert np.abs(deep.numpy() - jdeep).max() <= 1e-5 * np.abs(jdeep).max()
    widx = _ref_wide_indices(jcfg, batch["sparse_ids"])
    terms = np.abs(ref_params["wide"][widx, 0]).sum(1)
    assert (np.abs(wide.numpy() - jwide) <= 1e-5 * terms.max()).all()


def _abs_forward(params, cfg, batch):
    """The forward on |inputs| and |weights| (float64): the scale a
    logit's rounding errors grow with."""
    tree = {g: {k: torch.from_numpy(np.abs(v)).double()
                for k, v in params[g].items()} for g in ("tables", "mlp")}
    for name in ("wide", "head", "retrieval_proj"):
        tree[name] = torch.from_numpy(np.abs(params[name])).double()
    tb = R.batch_to(batch, CPU)
    tb["dense"] = tb["dense"].abs().double()
    return R.forward(tree, cfg, tb, kernel_backend="torch").numpy()


@pytest.mark.parametrize("seed", [3, 4])
def test_serve_step_matches_reference(model, ref_params, seed):
    """Logits within 1e-7 * the forward's absolute scale; probabilities
    within 1e-6 + sigmoid'(z) times that (see the module note)."""
    jcfg, cfg = _cfgs()
    batch = _batch(cfg, B, seed)
    tb = R.batch_to(batch, CPU)
    logit = R.forward(model, cfg, tb).numpy()
    prob = R.serve_step(model, cfg, tb).numpy()
    jlogit = np.asarray(jax.jit(lambda p, b: JR.forward(p, jcfg, b))(
        ref_params, _jb(batch)))
    jprob = np.asarray(jax.jit(lambda p, b: JR.serve_step(p, jcfg, b))(
        ref_params, _jb(batch)))
    assert prob.shape == jprob.shape == (B,) and prob.dtype == np.float32
    tol_z = 1e-7 * _abs_forward(ref_params, cfg, batch)
    assert (np.abs(logit - jlogit) <= tol_z).all()
    slope = jprob * (1 - jprob)
    assert (np.abs(prob - jprob) <= 1e-6 + slope * tol_z).all()
    # a module call is forward()
    assert np.array_equal(model(tb).numpy(), logit)


def test_retrieval_step_matches_reference(model, ref_params):
    """The top-100 of 20,000 item vectors: ids equal wherever the
    reference's score stands more than the tolerance from its neighbours
    (ties may swap), scores within 1e-5 of the largest |score|."""
    jcfg, cfg = _cfgs()
    batch = {k: v[:1] for k, v in _batch(cfg, 4).items()}
    items = np.random.default_rng(2).normal(
        size=(20_000, R.RETRIEVAL_DIM)).astype(np.float32)
    ids, top = R.retrieval_step(model, cfg, dict(
        R.batch_to(batch, CPU), item_vectors=torch.from_numpy(items)))
    jb = dict(_jb(batch), item_vectors=jnp.asarray(items))
    jids, jtop = jax.jit(lambda p, b: JR.retrieval_step(p, jcfg, b))(
        ref_params, jb)
    jids, jtop = np.asarray(jids), np.asarray(jtop)
    deep, _ = JR.user_tower(ref_params, jcfg, jb)
    scores = np.asarray(deep @ ref_params["retrieval_proj"] @ items.T)[0]
    tol = 1e-5 * np.abs(scores).max()
    assert ids.dtype == torch.int32 and ids.shape == (100,)
    assert np.abs(top.numpy() - jtop).max() <= tol
    ladder = np.concatenate([[np.inf], jtop, [np.sort(scores)[-101]]])
    apart = (ladder[:-2] - ladder[1:-1] > tol) & (
        ladder[1:-1] - ladder[2:] > tol)
    assert apart.mean() > 0.9
    assert np.array_equal(ids.numpy()[apart], jids[apart])


def test_convert_checks_leaves_and_shapes(ref_params):
    cfg = C.get_reduced("wide-deep")
    tree = dict(ref_params, mlp=dict(ref_params["mlp"]))
    del tree["mlp"]["b1"]
    with pytest.raises(ValueError, match="missing"):
        convert.recsys_params_from_reference(tree, cfg, device=CPU)
    tree = dict(ref_params, head=np.zeros((3, 1), np.float32))
    with pytest.raises(ValueError, match="head: shape"):
        convert.recsys_params_from_reference(tree, cfg, device=CPU)


def test_kernel_backend_cuda_on_the_cpu_raises(model):
    cfg = C.get_reduced("wide-deep")
    tb = R.batch_to(_batch(cfg, 8), CPU)
    with pytest.raises(ValueError, match="needs CUDA"):
        R.serve_step(model, cfg, tb, kernel_backend="cuda")
    with pytest.raises(ValueError, match="must be one of"):
        R.serve_step(model, cfg, tb, kernel_backend="pallas")
