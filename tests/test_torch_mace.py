"""The port's MACE (``repro_torch.models.mace``, ``utils/so3.py``,
``convert.mace_params_from_reference``) against the JAX reference, on the
CPU.

The reference's weights (``init_params`` with ``jax.random.key(0)``; the
zero-init leaves, the readout's ``w2`` and the radial MLP's ``b1`` (at
init the reference's energies are exactly 0), drawn from numpy) are
carried into the port, and the same numpy molecules go through both.
The coupling coefficients are the reference's numpy code, so they are
equal bit for bit; the spherical harmonics are the same polynomials, so
equal bit for bit in float64.  Energies (both sides in float32, summed in
different orders) within 1e-5 of the largest |energy|; the port's
energies under proper rotations and a translation within 1e-5 of the
largest |energy| (the reference's own test allows 1e-3; 1.3e-6 measured
at the full config).  A reflection is a symmetry of the reduced model
only: the model couples irreps without tracking parity (at l_max 2 the
(1, 1, 1) path is a cross product, even under a reflection that makes
an l = 1 vector odd), so with a non-zero readout the full config's
energies move by about 1% under one, in both packages (the reference's
reflection test passes because its readout starts at zero).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import graphs as JDG
from repro.models import mace as JM
from repro.models import module as jmodule
from repro.utils import so3 as jso3
from repro_torch import configs as C
from repro_torch.data import graphs as DG
from repro_torch.models import convert, module
from repro_torch.models import mace as M
from repro_torch.utils import so3

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-5


def _cfgs(full, **knobs):
    get = "get_arch" if full else "get_reduced"
    return (dataclasses.replace(getattr(jbase, get)("mace"), **knobs),
            dataclasses.replace(getattr(C, get)("mace"), **knobs))


def _ref_params(jcfg, seed=26):
    """The reference's weights as numpy arrays, each zero-init leaf drawn
    from numpy (N(0, 0.3^2))."""
    sch = JM.schema(jcfg)
    params = jax.tree.map(np.asarray, jmodule.init_params(
        sch, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten(params)
    specs = jax.tree_util.tree_flatten(sch, is_leaf=jmodule.is_param_spec)[0]
    flat = [(0.3 * rng.normal(size=a.shape)).astype(np.float32)
            if s.init == "zeros" else a for a, s in zip(flat, specs)]
    return jax.tree_util.tree_unflatten(treedef, flat)


def _molecules(n_edges=16, seed=1):
    """4 molecules of 8 atoms; 60 edges a molecule leave 4 of them
    masked (only 28 pairs)."""
    return DG.make_molecules(4, 8, n_edges, seed=seed)


def _batch(mol):
    return {k: torch.from_numpy(np.array(v)) for k, v in mol.items()}


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# ----------------------------------------------------------------------
# SO(3)
# ----------------------------------------------------------------------

def test_coupling_coefficients_equal_reference():
    for l1 in range(4):
        for l2 in range(4):
            for l3 in range(abs(l1 - l2), min(3, l1 + l2) + 1):
                got, want = so3.real_cg(l1, l2, l3), jso3.real_cg(l1, l2, l3)
                assert got.dtype == np.float64
                assert np.array_equal(got, want), (l1, l2, l3)
        assert np.array_equal(so3.real_basis_matrix(l1),
                              jso3.real_basis_matrix(l1))
        assert so3.irrep_slices(l1) == jso3.irrep_slices(l1)
    assert so3.cg_complex(2, 1, 1, -1, 2, 0) == \
        jso3.cg_complex(2, 1, 1, -1, 2, 0)
    for l_max in range(4):
        assert M.allowed_paths(l_max) == JM.allowed_paths(l_max)
        assert M.n_irrep_dims(l_max) == JM.n_irrep_dims(l_max)
    assert len(M.allowed_paths(2)) == 15


@pytest.mark.parametrize("l_max", [0, 1, 2, 3])
def test_spherical_harmonics_equal_reference(l_max):
    v = np.random.default_rng(l_max).normal(size=(64, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    want = jso3.spherical_harmonics(v, l_max)
    got = so3.spherical_harmonics(torch.from_numpy(v), l_max)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
    v32 = v.astype(np.float32)
    want32 = np.asarray(jso3.spherical_harmonics(jnp.asarray(v32), l_max))
    got32 = so3.spherical_harmonics(torch.from_numpy(v32), l_max).numpy()
    assert got32.dtype == np.float32
    assert np.abs(got32 - want32).max() <= 1e-6


def test_bessel_basis_matches_reference():
    r = np.linspace(0.0, 6.0, 97).astype(np.float32)
    want = np.asarray(JM.bessel_basis(jnp.asarray(r), 8, 5.0))
    got = M.bessel_basis(torch.from_numpy(r), 8, 5.0).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("full", [False, True])
def test_schema_equals_reference(full):
    jcfg, tcfg = _cfgs(full)
    got = list(module.leaves(M.schema(tcfg)))
    want = jax.tree_util.tree_flatten_with_path(
        JM.schema(jcfg), is_leaf=jmodule.is_param_spec)[0]
    assert [p for p, _ in got] == [
        ".".join(k.key for k in path) for path, _ in want]
    for (path, s), (_, w) in zip(got, want):
        assert (s.shape, s.logical_axes, s.init, s.scale) == (
            w.shape, w.logical_axes, w.init, w.scale), path


# ----------------------------------------------------------------------
# energies
# ----------------------------------------------------------------------

CASES = [(False, {}), (False, {"l_max": 2, "correlation_order": 3}),
         (True, {"d_hidden": 16}), (True, {})]


@pytest.mark.parametrize("n_edges", [16, 60])
@pytest.mark.parametrize("full,knobs", CASES)
def test_energies_match_reference(full, knobs, n_edges):
    """The reduced model (l_max 1, ν 2), reduced widths at l_max 2 and ν
    3, and the full config (15 paths) at C = 16 and at its own C = 128,
    with and without masked edges; and with a node masked out."""
    jcfg, tcfg = _cfgs(full, **knobs)
    params = _ref_params(jcfg)
    mol = _molecules(n_edges)
    mol["node_mask"][[3, 17]] = False
    want = np.asarray(JM.forward(params, jcfg,
                                 {k: jnp.asarray(v) for k, v in mol.items()}))
    model = convert.mace_params_from_reference(params, tcfg, device=CPU)
    got = M.forward(model, tcfg, _batch(mol)).numpy()
    assert np.isfinite(want).all() and np.abs(want).min() > 0
    _close(got, want)
    assert np.array_equal(model(_batch(mol)).numpy(), got)


def _rotation(seed, proper=True):
    Q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if (np.linalg.det(Q) > 0) != proper:
        Q[:, 0] *= -1
    return Q


@pytest.mark.parametrize("full", [False, True])
def test_energies_invariant_under_rotation_and_translation(full):
    """SE(3) invariance of the port itself: random proper rotations and a
    translation leave every energy within 1e-5 of the largest |energy|;
    the reduced model (l_max 1) also under a reflection."""
    jcfg, tcfg = _cfgs(full)
    model = convert.mace_params_from_reference(_ref_params(jcfg), tcfg,
                                               device=CPU)
    mol = _molecules(60)
    e0 = model(_batch(mol)).numpy()
    for seed, proper in ((1, True), (2, True), (3, full)):
        Q = _rotation(seed, proper)
        moved = dict(mol, positions=(mol["positions"] @ Q.T
                                     + [10.0, -3.0, 7.0]).astype(np.float32))
        _close(model(_batch(moved)).numpy(), e0)


def test_init_params_mace_module_runs():
    cfg = C.get_reduced("mace")
    model = M.MACE(cfg, module.init_params(
        M.schema(cfg), torch.Generator().manual_seed(0), device=CPU))
    assert sorted(n for n, _ in model.named_parameters()) == \
        [p for p, _ in module.leaves(M.schema(cfg))]
    e = model(_batch(_molecules()))
    assert e.shape == (4,) and bool((e == 0).all())   # w2 starts at 0


def test_convert_checks_leaves_and_shapes():
    jcfg, tcfg = _cfgs(False)
    params = _ref_params(jcfg)
    tree = dict(params, readout=dict(params["readout"]))
    del tree["readout"]["w2"]
    with pytest.raises(ValueError, match="missing"):
        convert.mace_params_from_reference(tree, tcfg, device=CPU)
    tree = dict(params, w_corr=np.zeros((1, 2, 8), np.float32))
    with pytest.raises(ValueError, match="w_corr: shape"):
        convert.mace_params_from_reference(tree, tcfg, device=CPU)
