"""The port's language models (``repro_torch.models``, ``configs``,
``data/lm.py``) against the JAX reference, on the CPU.

The reference's weights (``init_params`` with ``jax.random.key(0)``) are
carried into the port by ``convert.params_from_reference``, and the same
numpy tokens go through both.  The reference's calls are jitted once per
arch and dtype.  Tolerances:

* ``compute_dtype="float32"``: every logit and cache entry within
  1e-4 of the largest |logit| (|k|, |v|) of the reference: both sides
  compute in float32 and sum in different orders;
* bfloat16: the reference's own ``atol=5e-2, rtol=1e-3``
  (``tests/test_transformer.py``): the two round to bfloat16 at the same
  places but sum in different orders, so a rounding can land one step
  apart;
* the layers as each test states.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data.lm import LMStream as JLMStream
from repro.models import layers as JL
from repro.models import module as jmodule
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.configs import base as tbase
from repro_torch.data.lm import LMStream
from repro_torch.models import convert, layers as L, module
from repro_torch.models import transformer as T

torch.set_num_threads(1)

ARCHS = ("olmo-1b", "starcoder2-7b", "gemma3-27b", "olmoe-1b-7b",
         "kimi-k2-1t-a32b")
PROMPT, STEPS = 36, 4     # past starcoder2's 32 and gemma3's 16 windows


@pytest.fixture
def rng():
    return np.random.default_rng(24)


@functools.cache
def _reference_params(arch: str):
    """The reference's weights for the reduced arch, as numpy arrays."""
    cfg = jbase.get_reduced(arch)
    params = jmodule.init_params(JT.schema(cfg), jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _cfgs(arch: str, dtype: str):
    jcfg = dataclasses.replace(jbase.get_reduced(arch), compute_dtype=dtype)
    tcfg = dataclasses.replace(C.get_reduced(arch), compute_dtype=dtype)
    return jcfg, tcfg


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x,
                      np.float32) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, scale=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        scale = np.abs(want).max() if scale is None else scale
        assert np.abs(got - want).max() <= 1e-4 * scale
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-3)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_path_matches_reference(arch, dtype, rng):
    """``forward`` (all logits), ``prefill`` (its last logits and every
    layer's k and v) and ``STEPS`` ``decode_step``s into a cache padded
    past the prompt, teacher-forced, on weights carried from the
    reference."""
    jcfg, tcfg = _cfgs(arch, dtype)
    tree = _reference_params(arch)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = convert.params_from_reference(tree, tcfg, device="cpu")
    toks = rng.integers(0, tcfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)
    prompt = toks[:, :PROMPT]

    want_all, (want_last, want_cache) = jax.jit(
        lambda p, t: (JT.forward(p, jcfg, t)[0], JT.prefill(p, jcfg, t)))(
            jparams, jnp.asarray(prompt))
    got_all, _ = T.forward(model, tcfg, torch.from_numpy(prompt))
    _close(got_all, want_all, dtype)
    scale = np.abs(_np(want_all)).max()
    got_last, got_cache = T.prefill(model, tcfg, torch.from_numpy(prompt))
    _close(got_last, want_last, dtype, scale)
    assert set(got_cache) == set(want_cache)
    for name, kv in want_cache.items():
        for t in ("k", "v"):
            assert got_cache[name][t].dtype == getattr(torch, dtype)
            _close(got_cache[name][t], kv[t], dtype)

    pad = ((0, 0), (0, STEPS), (0, 0), (0, 0))
    jcache = {k: {t: jnp.pad(v[t], pad) for t in v}
              for k, v in want_cache.items()}
    tcache = T.init_cache(tcfg, 2, PROMPT + STEPS, device="cpu")
    for name, kv in got_cache.items():
        for t in ("k", "v"):
            tcache[name][t][:, :PROMPT] = kv[t]
    jdecode = jax.jit(lambda p, c, tok, pos: JT.decode_step(p, jcfg, c, tok,
                                                            pos))
    for pos in range(PROMPT, PROMPT + STEPS):
        want, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, pos]),
                               jnp.int32(pos))
        got, tcache = T.decode_step(model, tcfg, tcache,
                                    torch.from_numpy(toks[:, pos]), pos)
        assert got.dtype == getattr(torch, dtype) and got.shape == (
            2, tcfg.vocab)
        _close(got, want, dtype, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_carry_maps_every_leaf_bitwise(arch):
    """Every reference leaf lands in exactly one port parameter per layer,
    bit for bit, under the reference's name; none is left unset."""
    cfg = C.get_reduced(arch)
    tree = _reference_params(arch)
    model = convert.params_from_reference(tree, cfg, device="cpu")
    params = dict(model.named_parameters())
    seen = set()
    for path, a in module.leaves(tree):
        if path.startswith("blocks."):
            for i in range(cfg.n_layers):
                name = f"blocks.{i}.{path[len('blocks.'):]}"
                assert np.array_equal(params[name].numpy(), a[i])
                seen.add(name)
        else:
            assert np.array_equal(params[path].numpy(), a)
            seen.add(path)
    assert seen == set(params)
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_reference(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_reference(
            {k: v for k, v in tree.items() if k != "embed"}, cfg,
            device="cpu")


def test_kernel_backend_is_checked():
    cfg = C.get_reduced("olmo-1b")
    model = convert.params_from_reference(_reference_params("olmo-1b"), cfg,
                                          device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA"):
        T.forward(model, cfg, toks, kernel_backend="cuda")
    with pytest.raises(ValueError, match="kernel_backend"):
        T.prefill(model, cfg, toks, kernel_backend="pallas")
    a, _ = T.forward(model, cfg, toks, kernel_backend="torch")
    b, _ = model(toks)
    assert torch.equal(a, b)


def test_layer_windows_match_reference():
    for arch in ARCHS:
        for jc, tc in ((jbase.get_reduced(arch), C.get_reduced(arch)),
                       (jbase.get_arch(arch), C.get_arch(arch))):
            assert np.array_equal(T.layer_windows(tc), JT.layer_windows(jc))


# ----------------------------------------------------------------------
# configs, data, parameters
# ----------------------------------------------------------------------

def test_configs_match_reference():
    """Field for field, parameter counts and the shapes."""
    for arch in ARCHS:
        for jc, tc in ((jbase.get_arch(arch), C.get_arch(arch)),
                       (jbase.get_reduced(arch), C.get_reduced(arch))):
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
            assert tc.resolved_head_dim == jc.resolved_head_dim
            assert tc.n_params() == jc.n_params()
            assert tc.n_active_params() == jc.n_active_params()
            assert module.param_count(T.schema(tc)) == \
                jmodule.param_count(JT.schema(jc))
            assert module.param_bytes(T.schema(tc)) == \
                jmodule.param_bytes(JT.schema(jc))
        assert {k: dataclasses.asdict(v)
                for k, v in C.shapes_for(C.get_arch(arch)).items()} == \
            {k: dataclasses.asdict(v) for k, v in jbase.LM_SHAPES.items()}
    assert [f.name for f in dataclasses.fields(tbase.TransformerConfig)] == \
        [f.name for f in dataclasses.fields(jbase.TransformerConfig)]
    assert dataclasses.asdict(tbase.MoEConfig(8, 2, 16)) == \
        dataclasses.asdict(jbase.MoEConfig(8, 2, 16))
    assert C.list_archs() == jbase.list_archs()
    assert C.get_arch("tsdg-paper") == tbase.ANNConfig()
    for arch in C.list_archs():     # every arch of the reference resolves
        assert dataclasses.asdict(C.get_arch(arch)) == \
            dataclasses.asdict(jbase.get_arch(arch))
    assert C.get_arch("wide_deep") == C.get_arch("wide-deep")
    with pytest.raises(KeyError, match="did you mean"):
        C.get_arch("olmo-1c")


@pytest.mark.parametrize("seed,micro", [(0, 1), (3, 2)])
def test_lm_stream_matches_reference_bitwise(seed, micro):
    a, b = LMStream(97, 33, 4, micro, seed), JLMStream(97, 33, 4, micro, seed)
    for _ in range(3):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_init_params_follows_the_reference_rule():
    """Each leaf's std by the reference's rule (``fan_in`` over
    ``prod(shape[:-1])`` for a stacked leaf, the layer axis included):
    the sample std within 3% of it, zeros exactly zero; the port's
    ``std`` equals the rule computed from the reference's specs."""
    cfg = dataclasses.replace(C.get_reduced("kimi-k2-1t-a32b"), d_model=128,
                              n_layers=3, vocab=512)
    jcfg = dataclasses.replace(jbase.get_reduced("kimi-k2-1t-a32b"),
                               d_model=128, n_layers=3, vocab=512)
    gen = torch.Generator()
    gen.manual_seed(0)
    tree = module.init_params(T.schema(cfg), gen, device="cpu")
    flat = dict(module.leaves(tree))
    jspecs = dict(jax.tree_util.tree_flatten_with_path(
        JT.schema(jcfg), is_leaf=jmodule.is_param_spec)[0])
    jspecs = {".".join(k.key for k in path): s for path, s in jspecs.items()}
    assert set(jspecs) == set(flat)
    for path, spec in module.leaves(T.schema(cfg)):
        js = jspecs[path]
        assert spec.shape == js.shape and spec.init == js.init
        assert flat[path].shape == spec.shape
        x = flat[path].double()
        if js.init == "zeros":
            assert not flat[path].any()
            continue
        shape = js.shape
        fan_in = shape[0] if len(shape) <= 2 else int(np.prod(shape[:-1]))
        want = js.scale / np.sqrt(fan_in) if js.init == "fan_in" \
            else js.scale
        assert module.std(spec) == pytest.approx(want, rel=1e-12)
        assert float(x.std()) == pytest.approx(want, rel=0.03), path


def test_device_none_needs_a_card(monkeypatch):
    """``device=None`` means CUDA: without a card it raises, never runs on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = C.get_reduced("olmo-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.init_params(T.schema(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_reference(_reference_params("olmo-1b"), cfg)


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------

def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope_match_reference(rng, dtype):
    """In float32 within 1e-6 relative; in bfloat16 within one rounding
    of the output (2^-7 relative: each side rounds once)."""
    x = rng.normal(size=(2, 5, 3, 16)) * 3
    scale = rng.normal(size=(16,)) * 0.1
    pos = rng.integers(0, 5000, size=(2, 5))
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    for got, want in (
            (L.rms_norm(_t(x, dtype), _t(scale)),
             JL.rms_norm(_j(x, dtype), _j(scale))),
            (L.rms_norm(_t(x, dtype)), JL.rms_norm(_j(x, dtype))),
            (L.nonparametric_ln(_t(x, dtype)),
             JL.nonparametric_ln(_j(x, dtype))),
            (L.apply_rope(_t(x, dtype), torch.from_numpy(pos), 10000.0),
             JL.apply_rope(_j(x, dtype), jnp.asarray(pos), 10000.0))):
        assert got.dtype == getattr(torch, dtype)
        g, w = _np(got), _np(want)
        assert (np.abs(g - w) <= tol * np.abs(w) + 1e-5).all()
    assert L.make_norm(C.get_reduced("olmo-1b"))(_t(x)).shape == x.shape


def _attn_inputs(rng, B, Sq, Skv, H, KV, hd, dtype):
    return [rng.normal(size=(B, S, h, hd)).astype(np.float32)
            for S, h in ((Sq, H), (Skv, KV), (Skv, KV))]


def _attn_close(got, want, dtype):
    """float32: 1e-5 absolute on outputs of unit scale; bfloat16: one
    rounding of the output apart (2^-7 relative) plus 1e-2: p is rounded
    to bfloat16 on both sides, at scores that may differ by a step."""
    g, w = _np(got), _np(want)
    if dtype == "float32":
        assert np.abs(g - w).max() <= 1e-5
    else:
        assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-2).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,q_offset,kv_valid", [
    (0, 0, None), (24, 0, None), (0, 10, 50), (7, 30, 45)])
def test_chunked_attention_matches_reference(rng, dtype, window, q_offset,
                                             kv_valid):
    """Small chunks (16 query rows, 24 keys) so that the running softmax
    crosses chunks, with GQA (6 heads over 2), a window, an offset and a
    valid prefix of the keys."""
    q, k, v = _attn_inputs(rng, 2, 40, 60, 6, 2, 8, dtype)
    kw = dict(window=window, q_offset=q_offset, chunk_q=16, chunk_kv=24)
    got = L.chunked_attention(*(_t(a, dtype) for a in (q, k, v)),
                              kv_valid=kv_valid, **kw)
    want = jax.jit(functools.partial(JL.chunked_attention, kv_valid=kv_valid,
                                     **kw))(*(_j(a, dtype) for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype)
    _attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,q_offset", [(20, 0), (9, 17)])
def test_windowed_chunked_attention_matches_reference(rng, dtype, window,
                                                      q_offset):
    q, k, v = _attn_inputs(rng, 1, 50, 50 + q_offset, 4, 2, 8, dtype)
    if q_offset:   # a chunk of a longer prefill: the query rows' own keys
        q = q[:, :50 - q_offset]
    kw = dict(window=window, q_offset=q_offset, chunk_q=16, chunk_kv=16)
    got = L.windowed_chunked_attention(*(_t(a, dtype) for a in (q, k, v)),
                                       **kw)
    want = JL.windowed_chunked_attention(*(_j(a, dtype) for a in (q, k, v)),
                                         **kw)
    _attn_close(got, want, dtype)
    with pytest.raises(ValueError, match="window"):
        L.windowed_chunked_attention(_t(q), _t(k), _t(v), window=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,ring", [(0, False), (5, False), (0, True),
                                         (6, True)])
def test_decode_attention_matches_reference(rng, dtype, window, ring):
    """One token at per-row positions over a cache; ``slot_pos`` a ring
    buffer's positions (-1 for empty slots)."""
    B, S = 3, 12
    q, k, v = _attn_inputs(rng, B, 1, S, 4, 1, 16, dtype)
    pos = np.array([4, 11, 20])
    slot_pos = None
    if ring:
        slot_pos = np.stack([np.where(np.arange(S) <= p, np.arange(S), -1)
                             if p < S else (np.arange(S) + p - S + 1)
                             for p in pos]).astype(np.int32)
    got = L.decode_attention(
        *(_t(a, dtype) for a in (q, k, v)), pos=torch.from_numpy(pos),
        slot_pos=None if slot_pos is None else torch.from_numpy(slot_pos),
        window=window)
    want = JL.decode_attention(
        *(_j(a, dtype) for a in (q, k, v)), pos=jnp.asarray(pos),
        slot_pos=None if slot_pos is None else jnp.asarray(slot_pos),
        window=window)
    _attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_reference(rng, dtype):
    x, wg, wu = (rng.normal(size=s) * 0.3 for s in ((2, 3, 16), (16, 24),
                                                     (16, 24)))
    wd = rng.normal(size=(24, 16)) * 0.3
    got = L.swiglu(*(_t(a, dtype) for a in (x, wg, wu, wd)))
    want = JL.swiglu(*(_j(a, dtype) for a in (x, wg, wu, wd)))
    g, w = _np(got), _np(want)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(w) + 2e-2
    assert (np.abs(g - w) <= tol).all()
