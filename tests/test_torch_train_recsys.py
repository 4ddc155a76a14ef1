"""Training of Wide & Deep on the port (``models/recsys.py`` ``loss_fn``,
``kernels/embedding_bag.py``'s gradient, the launcher's ``recsys``
branch) against the JAX reference, on the CPU.

The reference's weights (``init_params`` with ``jax.random.key(0)``, the
zero-init wide table and biases drawn from numpy) and the same
``CTRStream`` batches go through both packages at the reduced config.
The oracles are ``jax.value_and_grad(loss_fn)`` and ``make_train_step``,
each under ``jax.jit`` without a mesh.  Tolerances (float32 on both
sides, sums in different orders):

* the loss within 1e-5 relative, ``acc`` exactly;
* each gradient leaf within 1e-4 of that leaf's largest |g|;
* ``embedding_bag_bwd_plain`` within 1e-6 of the sum of its terms'
  magnitudes (the bag contract), against autograd of the plain forward
  and against ``jax.vjp`` of the reference's ``models/recsys.
  embedding_bag``;
* a train step as in ``test_torch_train_gnn.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import recsys as JR
from repro_torch import configs as C
from repro_torch.data.recsys import CTRStream
from repro_torch.kernels import embedding_bag as EB
from repro_torch.models import recsys as R

from test_torch_train_gnn import (_check_loss, _check_step, _ref_params,
                                  check_resume)

torch.set_num_threads(1)


def _cfgs():
    return jbase.get_reduced("wide-deep"), C.get_reduced("wide-deep")


def _bag_case(rng, V, B, bag, E, *, hot=False, clamp=False):
    ids = rng.integers(0, V, size=(B, bag)).astype(np.int32)
    if hot:                      # one id in every bag, twice in the first
        ids[:, 0] = 3 % V
        ids[0, -1] = 3 % V
    if clamp:                    # ids outside [0, V): the kernel clamps
        ids[0, 0], ids[-1, -1] = -2, V + 5
    dout = rng.normal(size=(B, E)).astype(np.float32)
    return ids, dout


@pytest.mark.parametrize("combine", ["mean", "sum"])
@pytest.mark.parametrize("V,B,bag,E,kw", [
    (50, 7, 4, 8, dict(hot=True)), (6, 20, 10, 5, {}), (1000, 3, 1, 3, {}),
    (9, 5, 40, 4, dict(hot=True))])
def test_embedding_bag_bwd_plain_matches_autograd_and_reference(
        combine, V, B, bag, E, kw):
    rng = np.random.default_rng([V, B, bag, E])
    ids, dout = _bag_case(rng, V, B, bag, E, **kw)
    table = torch.from_numpy(rng.normal(size=(V, E)).astype(
        np.float32)).requires_grad_()
    out = EB.embedding_bag(table, torch.from_numpy(ids), combine=combine)
    auto, = torch.autograd.grad(out, table, torch.from_numpy(dout))
    got = EB.embedding_bag_bwd_plain(torch.from_numpy(ids),
                                     torch.from_numpy(dout), V,
                                     combine=combine)
    _, vjp = jax.vjp(lambda t: JR.embedding_bag(t, jnp.asarray(ids),
                                                combine=combine),
                     jnp.asarray(table.detach().numpy()))
    want, = vjp(jnp.asarray(dout))
    scale = EB.embedding_bag_bwd_plain(torch.from_numpy(ids),
                                       torch.from_numpy(np.abs(dout)), V,
                                       combine=combine).numpy()
    for other in (auto.numpy(), np.asarray(want)):
        assert np.all(np.abs(got.numpy() - other) <= 1e-6 * scale)
    assert got.shape == (V, E) and got.dtype == torch.float32
    unread = np.setdiff1d(np.arange(V), ids)
    assert np.all(got.numpy()[unread] == 0)


def test_embedding_bag_bwd_clamps_as_the_forward():
    """Ids outside [0, V) read (and take the gradient of) the clamped row,
    as the kernel's forward clamps them; the CPU wrapper is the plain
    version and counts no launch."""
    from repro_torch import kernels as K

    rng = np.random.default_rng(7)
    ids, dout = _bag_case(rng, 11, 6, 3, 4, clamp=True)
    table = torch.zeros((11, 4), requires_grad=True)
    out = EB.embedding_bag(table, torch.from_numpy(ids))
    auto, = torch.autograd.grad(out, table, torch.from_numpy(dout))
    n0 = K.launch_counts()["embedding_bag_bwd"]
    got = EB.embedding_bag_bwd(torch.from_numpy(ids), torch.from_numpy(dout),
                               11)
    assert K.launch_counts()["embedding_bag_bwd"] == n0
    assert torch.allclose(got, auto, rtol=0, atol=1e-6)
    assert got[0].abs().sum() > 0 and got[10].abs().sum() > 0
    with pytest.raises(ValueError):
        EB.embedding_bag_bwd_plain(torch.from_numpy(ids),
                                   torch.from_numpy(dout), 11, combine="max")


def _batch(tcfg, seed=0):
    return next(CTRStream(tcfg, 64, seed=seed))


def test_wide_deep_loss_and_grads_match_reference():
    jcfg, tcfg = _cfgs()
    tree = _ref_params(JR.schema(jcfg))
    _check_loss(JR.loss_fn, jcfg, lambda p, b: R.loss_fn(p, tcfg, b), tree,
                _batch(tcfg))


def test_train_step_matches_reference():
    jcfg, tcfg = _cfgs()
    tree = _ref_params(JR.schema(jcfg))
    _check_step(lambda p, b: JR.loss_fn(p, jcfg, b),
                lambda p, b: R.loss_fn(p, tcfg, b), tree, _batch(tcfg, 1))


def test_launcher_recsys_trains_and_resumes(monkeypatch, tmp_path):
    """A new ``CTRStream`` batch every step: the resumed run skips the
    batches the restored steps consumed, so it equals the uninterrupted
    one."""
    check_resume(monkeypatch, tmp_path, "wide-deep")


def test_wide_deep_module_stays_frozen():
    """The serving module's parameters need no gradient (``_param(...,
    requires_grad=False)``), so serving saves nothing for a backward;
    the trainer differentiates the nested tree."""
    _, tcfg = _cfgs()
    from repro_torch.models.module import init_params

    tree = init_params(R.schema(tcfg), torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    model = R.WideDeep(tcfg, tree)
    assert not any(p.requires_grad for p in model.parameters())
    out = R.forward(model, tcfg, R.batch_to(_batch(tcfg), "cpu"))
    assert out.grad_fn is None
    assert dataclasses.asdict(tcfg)["multi_hot_fields"] == (0,)
