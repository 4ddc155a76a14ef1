"""The port's optimizers (``repro_torch.optim``) and the per-tensor int8
quantizer against the JAX reference, on the CPU.

The same numpy trees (in the reference's stacked layout: ``blocks.*``
[L, ...], norm scales [L, d] included) go through both packages; each
reference update is jitted once per configuration.  Tolerances:

* schedules: within 1 ulp of float32 at 1.0, the schedules' peak
  (``cos`` may round one step apart between XLA and PyTorch, and
  ``1 + cos`` near 0 keeps that step at the scale of 1.0);
* clipping and the optimizers: within 1e-6 of each leaf's largest |x|
  (the same float32 operations in the same order; the reductions of the
  norm and of Adafactor's row and column means sum in another order);
* quantization: the int8 codes equal exactly; the error buffer within
  1e-7 (one float32 rounding of values below 1);
* ``compressed_psum`` over two gloo ranks (threads of this process): each
  rank's sum and error bit for bit against the reference body's
  arithmetic in numpy.  The test process has one JAX host device, so the
  reference's ``shard_map`` cannot run here; equal outputs mean equal
  int32 sums, since the output is the sum times the shared scale.
"""
import dataclasses
import datetime
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ann import quantize as jq
from repro.optim import adafactor as jaf
from repro.optim import adamw as jaw
from repro.optim import api as japi
from repro.optim import clip as jclip
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro_torch.ann import quantize as tq
from repro_torch.models import convert
from repro_torch.optim import adafactor as taf
from repro_torch.optim import adamw as taw
from repro_torch.optim import api as tapi
from repro_torch.optim import clip as tclip
from repro_torch.optim import compression as tcomp
from repro_torch.optim import schedules as tsched
from repro_torch.optim.tree import tree_leaves, tree_map

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(27)


def _tree(rng, scale=1.0):
    """A small parameter-like tree: stacked matrices, a stacked norm scale
    [L, d], a 3-axis expert leaf, a vector."""
    r = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {"blocks": {"ln1": r(3, 8), "wq": r(3, 8, 2, 4),
                       "moe": {"w_up": r(3, 4, 8, 6)}},
            "embed": r(16, 8), "final_ln": r(8)}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_tree(got, want, rel):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30)


# ----------------------------------------------------------------------
# schedules and clipping
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["constant", "warmup_cosine",
                                  "warmup_linear"])
def test_schedules_match_reference(name):
    kw = {} if name == "constant" else dict(warmup_steps=7, total_steps=33)
    steps = np.arange(41, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: getattr(jsched, name)(s, **kw))(
        jnp.asarray(steps)))
    got = getattr(tsched, name)(torch.from_numpy(steps), **kw).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert np.abs(got - want).max() <= np.spacing(np.float32(1.0))
    for s in (0, 5, 40):       # a scalar count, as the optimizer passes it
        one = getattr(tsched, name)(torch.tensor(s, dtype=torch.int32), **kw)
        assert one.dim() == 0 and float(one) == got[s]


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_matches_reference(rng, max_norm):
    tree = _tree(rng)
    want, wnorm = jax.jit(lambda t: jclip.clip_by_global_norm(t, max_norm))(
        jax.tree.map(jnp.asarray, tree))
    got, norm = tclip.clip_by_global_norm(_torch(tree), max_norm)
    assert abs(float(norm) - float(wnorm)) <= 1e-6 * float(wnorm)
    _close_tree(got, want, 1e-6)
    assert float(tclip.global_norm(_torch(tree))) == float(norm)


# ----------------------------------------------------------------------
# the optimizers
# ----------------------------------------------------------------------

def _updates(rng, n=3):
    return [_tree(rng, 10.0 ** -i) for i in range(n)]


def _run_both(jmod, jcfg, tmod, tcfg, params, grads, scales):
    jstep = jax.jit(lambda g, s, p, sc: jmod.update(jcfg, g, s, p, sc))
    jp = jax.tree.map(jnp.asarray, params)
    js = jmod.init(jcfg, jp)
    tp = _torch(params)
    ts = tmod.init(tcfg, tp)
    for g, sc in zip(grads, scales):
        jp, js = jstep(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(sc))
        tp, ts = tmod.update(tcfg, _torch(g), ts, tp, lr_scale=sc)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(rng, state_dtype):
    """Three updates from identical gradients (stacked [L, d] scales are
    decayed: ndim >= 2 on the reference's layout)."""
    jcfg = jaw.AdamWConfig(lr=1e-2, state_dtype=getattr(jnp, state_dtype))
    tcfg = taw.AdamWConfig(lr=1e-2, state_dtype=getattr(torch, state_dtype))
    params = _tree(rng)
    (jp, js), (tp, ts) = _run_both(jaw, jcfg, taw, tcfg, params,
                                   _updates(rng), [1.0, 0.5, 0.25])
    _close_tree(tp, jp, 1e-6)
    for k in ("m", "v"):
        assert tree_leaves(ts[k])[0].dtype == getattr(torch, state_dtype)
        _close_tree(ts[k], js[k], 1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    assert ts["count"].dtype == torch.int32


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_adafactor_matches_reference(rng, momentum):
    """Factored leaves (two or more axes, over the last two) and the
    unfactored vector; momentum kept in bf16."""
    jcfg = jaf.AdafactorConfig(lr=1e-2, momentum=momentum, weight_decay=0.1)
    tcfg = taf.AdafactorConfig(lr=1e-2, momentum=momentum, weight_decay=0.1)
    params = _tree(rng)
    (jp, js), (tp, ts) = _run_both(jaf, jcfg, taf, tcfg, params,
                                   _updates(rng), [1.0, 1.0, 0.5])
    _close_tree(tp, jp, 1e-6)
    _close_tree(ts["slots"], js["slots"], 1e-6)
    assert set(ts["slots"]["embed"]) == set(js["slots"]["embed"])
    assert int(ts["count"]) == 3


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_facade_continues_reference_state(rng, name):
    """Two reference steps through ``make_optimizer`` (warmup-cosine: step
    0's scale is 0), the state carried by ``convert.opt_state_from_
    reference``, then a third step in both packages."""
    kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = japi.make_optimizer(japi.OptimizerConfig(**kw))
    topt = tapi.make_optimizer(tapi.OptimizerConfig(**kw))
    params = _tree(rng)
    grads = _updates(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    jstep = jax.jit(jopt.update)
    for g in grads[:2]:
        jp, js = jstep(jax.tree.map(jnp.asarray, g), js, jp)
    tp = _torch(jax.tree.map(np.asarray, jp))
    ts = convert.opt_state_from_reference(jax.tree.map(np.asarray, js),
                                          device="cpu")
    assert float(topt.lr_scale(ts["count"])) == float(
        jopt.lr_scale(js["count"]))
    jp, js = jstep(jax.tree.map(jnp.asarray, grads[2]), js, jp)
    tp, ts = topt.update(_torch(grads[2]), ts, tp)
    _close_tree(tp, jp, 1e-6)
    slots = ("m", "v") if name == "adamw" else ("slots",)
    for k in slots:
        _close_tree(ts[k], js[k], 1e-6)
    assert int(ts["count"]) == 3


class _SqrtFault:
    """``torch`` as an optimizer module sees it, but its ``sqrt`` raises on
    the ``at``-th call: a fault part-way through the tree's leaves."""

    def __init__(self, at):
        self.at, self.calls = at, 0

    def __getattr__(self, name):
        return getattr(torch, name)

    def sqrt(self, x):
        self.calls += 1
        if self.calls == self.at:
            raise RuntimeError("injected fault")
        return torch.sqrt(x)


@pytest.mark.parametrize("name,state_dtype,at", [("adamw", "float32", 3),
                                                 ("adamw", "bfloat16", 3),
                                                 ("adafactor", "float32", 6)])
def test_update_failing_part_way_writes_nothing(rng, monkeypatch, name,
                                                state_dtype, at):
    """An error raised inside the update after some leaves' new values
    are computed (two of AdamW's, one of Adafactor's, whose leaf takes
    four square roots) leaves the parameters and the state as they were,
    bit for bit; the update run again then equals one that never
    failed."""
    cfg = tapi.OptimizerConfig(name=name, lr=1e-2, schedule="constant",
                               state_dtype=state_dtype, momentum=0.9)
    opt = tapi.make_optimizer(cfg)
    params, grads = _torch(_tree(rng)), _torch(_tree(rng))
    state = opt.init(params)
    opt.update(grads, state, params)
    grads = _torch(_tree(rng))
    params_before = tree_map(torch.clone, params)
    state_before = tree_map(torch.clone, state)
    module = taw if name == "adamw" else taf
    monkeypatch.setattr(module, "torch", _SqrtFault(at))
    with pytest.raises(RuntimeError, match="injected fault"):
        opt.update(grads, state, params)
    monkeypatch.undo()
    for a, b in zip(tree_leaves(params), tree_leaves(params_before)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(state), tree_leaves(state_before)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    opt.update(grads, state, params)
    opt.update(grads, state_before, params_before)
    for a, b in zip(tree_leaves({"p": params, "s": state}),
                    tree_leaves({"p": params_before, "s": state_before})):
        assert torch.equal(a, b)


def test_step_zero_scale_is_zero(rng):
    """The schedule reads the count before the update: warmup's first
    step moves nothing but the decay, which is scaled by lr too."""
    opt = tapi.make_optimizer(tapi.OptimizerConfig(warmup_steps=4))
    params = _torch(_tree(rng))
    before = tree_map(torch.clone, params)
    state = opt.init(params)
    opt.update(_torch(_tree(rng)), state, params)
    for a, b in zip(tree_leaves(params), tree_leaves(before)):
        assert torch.equal(a, b)
    assert int(state["count"]) == 1


# ----------------------------------------------------------------------
# compression
# ----------------------------------------------------------------------

def test_quantize_codes_equal_reference(rng):
    x = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    x[0, 0] = 0.5 * np.abs(x).max() / 127 * 255     # lands on .5 steps
    jqv, jscale = jq.quantize(jnp.asarray(x))
    q, scale = tq.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(tq.dequantize(q, scale).numpy(),
                                  np.asarray(jq.dequantize(jqv, jscale)))


def test_compress_with_feedback_matches_reference(rng):
    g = rng.standard_normal((40, 24)).astype(np.float32)
    e = (rng.standard_normal((40, 24)) * 1e-2).astype(np.float32)
    jqv, jscale, jerr = jcomp.compress_with_feedback(jnp.asarray(g),
                                                     jnp.asarray(e))
    q, scale, err = tcomp.compress_with_feedback(torch.from_numpy(g),
                                                 torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    assert np.abs(err.numpy() - np.asarray(jerr)).max() <= 1e-7
    zeros = tcomp.init_error_state(_torch(_tree(rng)))
    ref = jcomp.init_error_state(jax.tree.map(jnp.asarray, _tree(rng)))
    for a, b in zip(tree_leaves(zeros), jax.tree.leaves(ref)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert not a.any()


def _psum_numpy(grads, errors):
    """The reference body's arithmetic (``compressed_psum``'s ``leaf``)
    over the ranks, in numpy float32."""
    corrected = [g.astype(np.float32) + e for g, e in zip(grads, errors)]
    top = np.float32(max(np.abs(c).max() for c in corrected))
    scale = top / np.float32(127.0) + np.float32(1e-12)
    qs = [np.clip(np.round(c / scale), -127, 127).astype(np.int8)
          for c in corrected]
    acc = sum(q.astype(np.int32) for q in qs)
    out = acc.astype(np.float32) * scale
    return out, [c - q.astype(np.float32) * scale
                 for c, q in zip(corrected, qs)]


def test_compressed_psum_over_two_gloo_ranks(rng):
    trees = [_tree(rng), _tree(rng)]
    errs = [tree_map(lambda a: (a * 1e-3).astype(np.float32), _tree(rng))
            for _ in range(2)]
    store = dist.HashStore()
    got, failed = {}, []

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("psum", store), r, 2,
                                       datetime.timedelta(seconds=60))
            got[r] = tcomp.compressed_psum(_torch(trees[r]), _torch(errs[r]),
                                           group=pg)
        except Exception as e:  # noqa: BLE001 - reported below
            failed.append(repr(e))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not failed and not any(t.is_alive() for t in threads)
    flat = [jax.tree.leaves(t) for t in trees]
    flat_e = [jax.tree.leaves(t) for t in errs]
    for i in range(len(flat[0])):
        want, want_e = _psum_numpy([f[i] for f in flat],
                                   [f[i] for f in flat_e])
        for r in range(2):
            np.testing.assert_array_equal(tree_leaves(got[r][0])[i].numpy(),
                                          want)
            np.testing.assert_array_equal(tree_leaves(got[r][1])[i].numpy(),
                                          want_e[r])


def test_compressed_psum_one_rank_matches_reference(rng):
    """One rank (pmax and psum over a single shard are the identity): the
    reference's ``compressed_psum`` under ``shard_map`` on a one-device
    mesh against the port's over a one-rank gloo group, each leaf's sum
    and error within two float32 steps of its largest |g + e|: XLA may
    round the scale one step apart (a step of max / 127, times q <= 127)
    and fuses ``corrected - q * scale`` into one rounding."""
    from jax.sharding import Mesh, PartitionSpec as P

    tree, err = _tree(rng), tree_map(lambda a: (a * 1e-3).astype(np.float32),
                                     _tree(rng))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    f = jax.jit(jax.shard_map(
        lambda g, e: jcomp.compressed_psum(g, e, "data"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P())))
    out, new_e = f(jax.tree.map(jnp.asarray, tree),
                   jax.tree.map(jnp.asarray, err))
    pg = dist.ProcessGroupGloo(dist.PrefixStore("one", dist.HashStore()), 0,
                               1, datetime.timedelta(seconds=60))
    got, got_e = tcomp.compressed_psum(_torch(tree), _torch(err), group=pg)
    for a, ea, b, eb, c, ec in zip(
            jax.tree.leaves(tree), jax.tree.leaves(err),
            jax.tree.leaves(out), jax.tree.leaves(new_e),
            tree_leaves(got), tree_leaves(got_e)):
        step = 2 * np.spacing(np.abs(a + ea).max())
        assert np.abs(c.numpy() - np.asarray(b)).max() <= step
        assert np.abs(ec.numpy() - np.asarray(eb)).max() <= step


def test_opt_state_from_reference_checks_its_input():
    with pytest.raises(ValueError):
        convert.opt_state_from_reference({"m": {}, "count": np.int32(0)},
                                          device="cpu")


def test_dataclass_fields_match_reference():
    """Every field and default of the reference's configs."""
    for jc, tc in ((japi.OptimizerConfig, tapi.OptimizerConfig),):
        jf = {f.name: f.default for f in dataclasses.fields(jc)}
        tf = {f.name: f.default for f in dataclasses.fields(tc)}
        assert jf == tf
    for jc, tc in ((jaw.AdamWConfig, taw.AdamWConfig),
                   (jaf.AdafactorConfig, taf.AdafactorConfig)):
        jf = {f.name for f in dataclasses.fields(jc)}
        assert jf == {f.name for f in dataclasses.fields(tc)}
