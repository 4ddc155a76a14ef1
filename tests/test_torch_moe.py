"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's (``repro.models.moe``), on the CPU.

The same numpy inputs go through both.  The routing integers are equal
exactly: each token's experts (``top_e``, ties toward the lower index as
``jax.lax.top_k`` breaks them), the dispatch order, each slot's rank in
its expert and the capacity ``keep``.  Floats: in float32 within 1e-5 of
the output's scale (both sum in float32 in different orders); in bfloat16
the reference test's ``atol=5e-2, rtol=1e-3``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _case(rng, T, d, E, f, ties=False):
    s = 1.0 / np.sqrt(d)
    p = {"router": rng.normal(size=(d, E)) * s,
         "w_gate": rng.normal(size=(E, d, f)) * s,
         "w_up": rng.normal(size=(E, d, f)) * s,
         "w_down": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    if ties:   # equal router columns: equal probabilities to break
        p["router"][:, 3] = p["router"][:, 1]
        p["router"][:, E - 1] = p["router"][:, 0]
        p["router"][:, 2] = 0.0
        p["router"][:, 5 % E] = 0.0
    x = rng.normal(size=(T, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _routing_j(x, p, cfg, C):
    _, probs = jmoe.router_probs(x, p["router"])
    top_p, top_e = jax.lax.top_k(probs, cfg.top_k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    _, (sorted_t, se, rank, w), counts = jmoe._dispatch_group(
        x, top_e, top_p, cfg.n_experts, cfg.top_k, C)
    return [np.asarray(a) for a in (top_e, sorted_t, se, rank, counts, w)]


def _routing_t(x, p, cfg, C):
    _, probs = moe.router_probs(x, p["router"])
    top_p, top_e = moe.top_k(probs, cfg.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    _, (sorted_t, se, rank, w), counts = moe._dispatch_group(
        x, top_e, top_p, cfg.n_experts, cfg.top_k, C)
    return [a.numpy() for a in (top_e, sorted_t, se, rank, counts, w)]


@pytest.mark.parametrize("T,E,K,cf,ties", [
    (24, 8, 2, 8.0, False),     # nothing dropped
    (64, 4, 2, 0.25, False),    # capacity drops tokens
    (40, 8, 3, 1.25, True),     # equal probabilities: the tie order
    (48, 16, 4, 0.5, True)])
def test_routing_integers_equal_reference(rng, T, E, K, cf, ties):
    d, f = 12, 16
    p, x = _case(rng, T, d, E, f, ties)
    cfg = MoEConfig(n_experts=E, top_k=K, d_expert=f, capacity_factor=cf)
    jcfg = JMoEConfig(n_experts=E, top_k=K, d_expert=f, capacity_factor=cf)
    C = moe.capacity(T, cfg)
    assert C == jmoe.capacity(T, jcfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = _routing_j(jnp.asarray(x), jp, jcfg, C)
    got = _routing_t(torch.from_numpy(x), tp, cfg, C)
    for name, g, w in zip(("top_e", "sorted_t", "se", "rank", "counts"),
                          got, want):
        assert np.array_equal(g, w), name
    keep = got[2] < E
    assert np.array_equal(keep, want[3] < C)
    if cf < 1:
        assert not keep.all()
    np.testing.assert_allclose(got[5], want[5], rtol=1e-6, atol=1e-7)
    if ties:   # the ties were there to break
        _, probs = moe.router_probs(torch.from_numpy(x), tp["router"])
        srt = torch.sort(probs, -1, descending=True).values
        assert bool((srt[:, :K + 1].diff(dim=-1) == 0).any())


@pytest.mark.parametrize("cf,groups", [(8.0, 1), (0.5, 1), (1.25, 4)])
def test_moe_ffn_matches_reference(rng, cf, groups):
    """``y`` and the three aux values in float32 within 1e-5 of their
    scale, with drops and with group-local dispatch."""
    T, d, E, K, f = 64, 16, 8, 2, 24
    p, x = _case(rng, T, d, E, f)
    cfg = MoEConfig(E, K, f, capacity_factor=cf, dispatch_groups=groups)
    jcfg = JMoEConfig(E, K, f, capacity_factor=cf, dispatch_groups=groups)
    want, jaux = jax.jit(lambda a, b: jmoe.moe_ffn(a, b, jcfg))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    got, aux = moe.moe_ffn(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           cfg)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == (T, d)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert set(aux) == set(jaux)
    for name, v in jaux.items():
        assert float(aux[name]) == pytest.approx(float(v), rel=1e-5,
                                                 abs=1e-7), name
    if cf < 1:
        assert float(aux["dropped_fraction"]) > 0


def test_moe_ffn_bf16_matches_reference(rng):
    """bfloat16 tokens and weights (the model's compute dtype): the router
    widens both to float32, so the routing is equal; the expert products
    round to bfloat16 on both sides."""
    T, d, E, K, f = 48, 16, 8, 2, 24
    p, x = _case(rng, T, d, E, f)
    cfg = MoEConfig(E, K, f)
    jcfg = JMoEConfig(E, K, f)
    want, _ = jax.jit(lambda a, b: jmoe.moe_ffn(a, b, jcfg))(
        jnp.asarray(x).astype(jnp.bfloat16),
        {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()})
    got, _ = moe.moe_ffn(torch.from_numpy(x).bfloat16(),
                         {k: torch.from_numpy(v).bfloat16()
                          for k, v in p.items()}, cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=5e-2, rtol=1e-3)


def test_capacity_matches_reference():
    for T in (1, 4, 7, 64, 513, 2048, 8192):
        for E, K, cf in ((8, 2, 1.25), (64, 8, 1.25), (384, 8, 1.0),
                         (4, 2, 0.25)):
            a = MoEConfig(E, K, 16, capacity_factor=cf)
            b = JMoEConfig(E, K, 16, capacity_factor=cf)
            assert moe.capacity(T, a) == jmoe.capacity(T, b)
    assert dataclasses.asdict(MoEConfig(8, 2, 16)) == \
        dataclasses.asdict(JMoEConfig(8, 2, 16))
