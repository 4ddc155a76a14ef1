"""LM training on the port (``models/transformer.py`` ``loss_fn``,
``kernels/flash_attention.py``'s gradient, ``train/``, the launcher)
against the JAX reference, on the CPU.

The reference's weights (``init_params`` with ``jax.random.key(0)``) and
the same numpy tokens go through both packages; each reference call is
jitted once per arch and dtype.  The oracles are ``jax.value_and_grad(
loss_fn)`` and ``make_train_step`` without a mesh: the reference's
``Trainer.run`` fails on this JAX (``tests/test_trainer_checkpoint.py``).
Tolerances:

* ``compute_dtype="float32"``: the loss within 1e-5 relative, each
  gradient leaf within 1e-4 of that leaf's largest |g| (float32 on both
  sides, sums in different orders);
* bfloat16: the reference's own ``atol=5e-2, rtol=1e-3``
  (``tests/test_torch_lm.py``);
* attention's gradient: float32 within 1e-5 of the largest |g| of each
  of dq, dk, dv; bf16 inputs ``atol=5e-2, rtol=1e-3`` (the reference
  rounds P to bf16 before P @ V, the port's oracle does not);
* a train step's parameters: AdamW's first update is +-lr wherever
  g != 0, so an element whose reference gradient lies inside the
  gradient tolerance may step the other way: those within 2 lr, the
  rest within 1e-5 of the leaf's largest |p|.
"""
import dataclasses
import functools
import os
import subprocess
import sys

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
from repro.optim import api as japi
from repro.train import trainer as jtrainer
from repro_torch import configs as C
from repro_torch.data.lm import LMStream
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer as T
from repro_torch.models.module import leaves
from repro_torch.optim import adamw
from repro_torch.optim import api as tapi
from repro_torch.optim.tree import tree_leaves, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer as ttrainer

torch.set_num_threads(1)

ARCHS = ("olmo-1b", "starcoder2-7b", "gemma3-27b", "olmoe-1b-7b",
         "kimi-k2-1t-a32b")
SEQ = 40          # past starcoder2's 32 and gemma3's 16 windows
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def _reference_params(arch: str):
    cfg = jbase.get_reduced(arch)
    params = jmodule.init_params(JT.schema(cfg), jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _cfgs(arch: str, dtype: str, **kw):
    return (dataclasses.replace(jbase.get_reduced(arch), compute_dtype=dtype,
                                **kw),
            dataclasses.replace(C.get_reduced(arch), compute_dtype=dtype,
                                **kw))


def _ttree(tree):
    """The reference's numpy tree as the port's nested dict of tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, rel=1e-4):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        assert np.abs(got - want).max() <= rel * max(np.abs(want).max(),
                                                     1e-30)
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-3)


def _grads(cfg, tree, toks, **kw):
    """(gradient tree, metrics) of the port's ``loss_fn``."""
    return ttrainer._grads_of(
        lambda p, b: T.loss_fn(p, cfg, b, **kw), _ttree(tree),
        {"tokens": torch.from_numpy(toks)})


# ----------------------------------------------------------------------
# the loss and its gradient
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    tree = _reference_params(arch)
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab, (2, SEQ + 1)).astype(np.int32)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    grads, metrics = _grads(tcfg, tree, toks)
    for k in ("loss", "nll", "moe_loss"):
        if dtype == "float32":
            assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5 * max(
                abs(float(jm[k])), 1e-30)
        else:
            _close(metrics[k], jm[k], dtype)
    if dtype == "float32":
        assert float(metrics["acc"]) == float(jm["acc"])
    assert metrics["loss"].dtype == torch.float32
    want = dict(leaves(jax.tree.map(np.asarray, jg)))
    got = dict(leaves(grads))
    assert set(got) == set(want)
    for path, g in got.items():
        assert g.dtype == torch.float32
        _close(g, want[path], dtype)


@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b"])
def test_remat_gives_equal_grads(arch):
    """Each layer under ``torch.utils.checkpoint`` recomputes the same
    arithmetic: the gradients equal the ones without it, bit for bit."""
    tree = _reference_params(arch)
    toks = np.random.default_rng(6).integers(
        0, jbase.get_reduced(arch).vocab, (2, SEQ + 1)).astype(np.int32)
    on = _grads(_cfgs(arch, "bfloat16", remat=True)[1], tree, toks)[0]
    off = _grads(_cfgs(arch, "bfloat16", remat=False)[1], tree, toks)[0]
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# attention's gradient
# ----------------------------------------------------------------------

# (B, Sq, Skv, H, KV, hd, window, q_offset)
ATTN_CASES = {
    "causal": (2, 40, 40, 4, 4, 16, 0, 0),
    "window": (2, 40, 40, 4, 4, 16, 8, 0),
    "gqa": (1, 33, 33, 6, 2, 8, 0, 0),
    "q_offset": (2, 24, 40, 4, 2, 16, 0, 16),
    "window gqa q_offset": (1, 20, 44, 6, 3, 8, 12, 24),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_grad_matches_reference(case, dtype):
    """``flash_attention``'s gradient on the CPU (``attention_ref`` under
    autograd) and the backward kernel's plain version against
    ``jax.grad`` of the reference's ``chunked_attention`` (chunks of 16)
    and, with a window, ``windowed_chunked_attention``."""
    B, Sq, Skv, H, KV, hd, window, off = ATTN_CASES[case]
    rng = np.random.default_rng(7)
    q, dout = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
            for _ in range(2))
    jdt = getattr(jnp, dtype)

    def ref(fn):
        def f(q, k, v):
            return jnp.sum(fn(q, k, v).astype(jnp.float32)
                           * jnp.asarray(dout))
        return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
            *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))

    wants = [ref(lambda q, k, v: JL.chunked_attention(
        q, k, v, window=window, q_offset=off, chunk_q=16, chunk_kv=16))]
    if window:
        wants.append(ref(lambda q, k, v: JL.windowed_chunked_attention(
            q, k, v, window=window, q_offset=off, chunk_q=16,
            chunk_kv=16)))
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = FA.flash_attention(qt, kt, vt, window=window, q_offset=off)
    auto = torch.autograd.grad(out, (qt, kt, vt),
                               torch.from_numpy(dout).to(tdt))
    plain = FA.flash_attention_bwd_plain(
        qt.detach(), kt.detach(), vt.detach(), torch.from_numpy(dout).to(tdt),
        window=window, q_offset=off)
    for want in wants:
        for got in (auto, plain):
            for g, w in zip(got, want):
                assert g.dtype == tdt
                _close(g, w, dtype, rel=1e-5)


def test_attention_bwd_plain_matches_autograd_in_float64():
    """The plain backward's arithmetic (lse, O in the working type, D, dS)
    is the exact gradient: in float64 it equals autograd of
    ``attention_ref`` to 1e-12."""
    rng = np.random.default_rng(8)
    q, dout = (torch.from_numpy(rng.standard_normal((2, 30, 6, 16)))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 50, 2, 16)))
            for _ in range(2))
    for window, off in ((0, 20), (9, 20)):
        qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
        out = FA.flash_attention(qa, ka, va, window=window, q_offset=off)
        auto = torch.autograd.grad(out, (qa, ka, va), dout)
        plain = FA.flash_attention_bwd(q, k, v, dout, window=window,
                                       q_offset=off)
        for a, b in zip(auto, plain):
            assert b.dtype == torch.float64
            assert (a - b).abs().max() <= 1e-12 * a.abs().max()


# ----------------------------------------------------------------------
# one train step
# ----------------------------------------------------------------------

def _step_setup(micro: int):
    jcfg, tcfg = _cfgs("olmo-1b", "float32")
    tree = _reference_params("olmo-1b")
    toks = np.random.default_rng(9).integers(
        0, tcfg.vocab, (4, 33)).astype(np.int32)
    if micro > 1:
        toks = toks.reshape(micro, 4 // micro, 33)
    return jcfg, tcfg, tree, toks


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    """``make_train_step`` (AdamW, constant lr 1e-3, clip 1.0) against the
    reference's jitted one: the metrics, the gradients the step takes
    (the reference's through ``value_and_grad``) and the parameters
    after the step."""
    jcfg, tcfg, tree, toks = _step_setup(micro)
    lr = 1e-3
    kw = dict(lr=lr, schedule="constant")
    jopt = japi.make_optimizer(japi.OptimizerConfig(**kw))
    jp = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(jtrainer.make_train_step(
        lambda p, b: JT.loss_fn(p, jcfg, b), jopt, microbatches=micro))
    jp1, _, jm = jstep(jp, jopt.init(jp), {"tokens": jnp.asarray(toks)})
    flat = toks.reshape(-1, 33)
    _, jg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, jcfg, b),
                                       has_aux=True))(
        jp, {"tokens": jnp.asarray(flat)})
    jg = dict(leaves(jax.tree.map(np.asarray, jg)))

    topt = tapi.make_optimizer(tapi.OptimizerConfig(**kw))
    tp = _ttree(tree)
    step = ttrainer.make_train_step(lambda p, b: T.loss_fn(p, tcfg, b), topt,
                                    microbatches=micro)
    tp, ts, tm = step(tp, topt.init(tp), {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "nll", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    g, _ = _grads(tcfg, tree, flat)
    for path, gl in leaves(g):
        _close(gl, jg[path], "float32")
    want = dict(leaves(jax.tree.map(np.asarray, jp1)))
    for path, p in leaves(tp):
        w, gref = want[path], jg[path]
        flip = np.abs(gref) <= 1e-4 * np.abs(gref).max()
        diff = np.abs(p.numpy() - w)
        assert diff[flip].max(initial=0.0) <= 2 * lr
        assert diff[~flip].max(initial=0.0) <= 1e-5 * np.abs(w).max()
    assert int(ts["count"]) == 1


def test_grad_accumulation_equivalence():
    """The reference's test on the port: microbatches=2 over the same
    tokens == one full batch step."""
    _, tcfg, tree, toks = _step_setup(1)
    opt = tapi.make_optimizer(tapi.OptimizerConfig(lr=1e-3,
                                                   schedule="constant"))
    loss_fn = lambda p, b: T.loss_fn(p, tcfg, b)  # noqa: E731
    outs = []
    for micro, t in ((1, toks), (2, toks.reshape(2, 2, 33))):
        p = _ttree(tree)
        step = ttrainer.make_train_step(loss_fn, opt, microbatches=micro)
        p, _, m = step(p, opt.init(p), {"tokens": torch.from_numpy(t)})
        outs.append((p, m))
    (p1, m1), (p2, m2) = outs
    np.testing.assert_allclose(float(m1["nll"]), float(m2["nll"]), rtol=1e-4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


# ----------------------------------------------------------------------
# the trainer and checkpoints
# ----------------------------------------------------------------------

def _trainer(tmp, steps=12, ckpt_every=6, loss_fn=None):
    cfg = C.get_reduced("olmo-1b")
    return cfg, ttrainer.Trainer(
        schema=T.schema(cfg),
        loss_fn=loss_fn or (lambda p, b: T.loss_fn(p, cfg, b)),
        opt_cfg=tapi.OptimizerConfig(lr=1e-3, warmup_steps=3, total_steps=12),
        train_cfg=ttrainer.TrainConfig(steps=steps, log_every=4,
                                       ckpt_every=ckpt_every,
                                       ckpt_dir=str(tmp), ckpt_async=False),
        device="cpu")


def _data(cfg, skip=0):
    """The reference test's stream at 2 sequences of 32 where it takes 8:
    the plain attention pads each to its 512 x 1,024 chunk on the CPU."""
    it = iter(LMStream(cfg.vocab, 32, 2, seed=0))
    for _ in range(skip):
        next(it)
    return it


def test_lm_stream_equals_reference():
    a, b = LMStream(256, 32, 8, seed=0), JLMStream(256, 32, 8, seed=0)
    for _ in range(2):
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])


def test_loss_decreases(tmp_path):
    cfg, tr = _trainer(tmp_path / "ckpt", steps=16)
    state, hist = tr.run(_data(cfg))
    assert hist[-1][1]["loss"] < hist[0][1]["loss"]
    assert [s for s, _ in hist] == [0, 4, 8, 12]
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 12


def test_resume_equals_uninterrupted_run(tmp_path):
    """12 steps, against 6 steps, a checkpoint and a restart that restores
    it into a fresh ``Trainer`` and runs 6 more: bit for bit."""
    cfg, tr = _trainer(tmp_path / "a", steps=12, ckpt_every=0)
    full, _ = tr.run(_data(cfg))
    cfg, tr = _trainer(tmp_path / "b", steps=6)
    tr.run(_data(cfg))
    assert ckpt.latest_step(str(tmp_path / "b")) == 6
    cfg, tr2 = _trainer(tmp_path / "b", steps=6)
    resumed, hist = tr2.run(_data(cfg, skip=6), resume=True)
    assert [s for s, _ in hist] == [8]
    assert ckpt.latest_step(str(tmp_path / "b")) == 12
    for a, b in zip(tree_leaves(full), tree_leaves(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_failed_step_is_retried_from_unchanged_params(tmp_path):
    cfg = C.get_reduced("olmo-1b")
    calls = []

    def flaky(p, b):
        calls.append(1)
        if len(calls) == 3:      # the second step's first attempt
            raise RuntimeError("injected fault")
        return T.loss_fn(p, cfg, b)

    _, tr = _trainer(tmp_path / "a", steps=4, ckpt_every=0)
    clean, _ = tr.run(_data(cfg))
    _, tr = _trainer(tmp_path / "b", steps=4, ckpt_every=0, loss_fn=flaky)
    retried, _ = tr.run(_data(cfg))
    assert len(calls) == 5
    for a, b in zip(tree_leaves(clean), tree_leaves(retried)):
        assert torch.equal(a, b)


def test_step_failing_inside_the_update_is_retried_from_unchanged_params(
        tmp_path, monkeypatch):
    """The second step's first attempt raises inside AdamW's update, after
    two leaves' new values are computed: the retried run equals a clean
    one bit for bit (the update writes nothing until every leaf is
    computed)."""
    cfg, tr = _trainer(tmp_path / "a", steps=4, ckpt_every=0)
    clean, _ = tr.run(_data(cfg))
    n = len(tree_leaves(clean["params"]))
    calls = []

    class Faulty:
        def __getattr__(self, name):
            return getattr(torch, name)

        def sqrt(self, x):
            calls.append(1)
            if len(calls) == n + 3:
                raise RuntimeError("injected fault")
            return torch.sqrt(x)

    monkeypatch.setattr(adamw, "torch", Faulty())
    _, tr = _trainer(tmp_path / "b", steps=4, ckpt_every=0)
    retried, _ = tr.run(_data(cfg))
    assert len(calls) == 4 * n + 3
    for a, b in zip(tree_leaves(clean), tree_leaves(retried)):
        assert torch.equal(a, b)


def test_serving_weights_follow_a_train_step():
    """``Transformer.weights`` keeps its bf16 copies only until the tree
    it views changes in place: after one train step, ``prefill`` equals a
    fresh model built from the updated tree, bit for bit."""
    cfg = C.get_reduced("olmo-1b")
    tree = _ttree(_reference_params("olmo-1b"))
    model = T.Transformer(cfg, tree)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    before, _ = T.prefill(model, cfg, toks)
    opt = tapi.make_optimizer(tapi.OptimizerConfig(lr=1e-2,
                                                   schedule="constant"))
    step = ttrainer.make_train_step(lambda p, b: T.loss_fn(p, cfg, b), opt)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (4, 17)).astype(np.int32))}
    step(tree, opt.init(tree), batch)
    after, cache = T.prefill(model, cfg, toks)
    fresh = T.Transformer(cfg, tree_map(torch.clone, tree))
    want, want_cache = T.prefill(fresh, cfg, toks)
    assert not torch.equal(after, before)
    assert torch.equal(after, want)
    for name in want_cache:
        for t in ("k", "v"):
            assert torch.equal(cache[name][t], want_cache[name][t])


def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4),
                        "b": torch.ones(4, dtype=torch.bfloat16)},
             "opt": {"count": torch.tensor(7, dtype=torch.int32)}}
    d = str(tmp_path / "rt")
    ckpt.save(state, 5, d)
    restored, step = ckpt.restore(d, state)
    assert step == 5
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async_and_latest(tmp_path):
    d = str(tmp_path / "as")
    x = torch.ones(8)
    t = ckpt.save({"x": x}, 1, d, async_save=True)
    x.add_(1.0)             # the snapshot was taken before save returned
    t.join()
    ckpt.save({"x": x}, 2, d)
    assert ckpt.latest_step(d) == 2
    first, step = ckpt.restore(d, {"x": x}, step=1)
    assert step == 1 and torch.equal(first["x"], torch.ones(8))
    _, step = ckpt.restore(d, {"x": x})
    assert step == 2


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "mm")
    ckpt.save({"x": torch.ones(4)}, 1, d)
    with pytest.raises(ValueError):
        ckpt.restore(d, {"x": torch.ones(5)})
    with pytest.raises(KeyError):
        ckpt.restore(d, {"y": torch.ones(4)})


def test_atomic_publish_no_partial(tmp_path):
    """A tmp-dir from a dead save must not be visible as a checkpoint."""
    d = str(tmp_path / "at")
    os.makedirs(os.path.join(d, "tmp-99"))
    assert ckpt.latest_step(d) is None
    ckpt.save({"x": torch.ones(2)}, 1, d)
    assert ckpt.latest_step(d) == 1


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = C.get_reduced("olmo-1b")
    with pytest.raises(RuntimeError):
        ttrainer.Trainer(schema=T.schema(cfg), loss_fn=None,
                         opt_cfg=tapi.OptimizerConfig(),
                         train_cfg=ttrainer.TrainConfig())


# ----------------------------------------------------------------------
# the launcher and the example
# ----------------------------------------------------------------------

def test_launcher_and_example_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu`` (AdamW
    and, for kimi, Adafactor) and ``examples/torch/train_lm.py`` exit 0
    with their loss lines; the ANN system exits non-zero, naming the
    quickstart (the graph families train: ``test_torch_train_gnn.py``).
    All four start together, one thread each."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
            "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16"]
    cmds = {
        "olmo": base + ["--arch", "olmo-1b", "--ckpt-dir",
                        str(tmp_path / "a")],
        "kimi": base + ["--arch", "kimi-k2-1t-a32b", "--ckpt-dir",
                        str(tmp_path / "b")],
        "ann": base + ["--arch", "tsdg-paper"],
        "example": [sys.executable,
                    os.path.join(ROOT, "examples", "torch", "train_lm.py"),
                    "--steps", "2", "--d-model", "16", "--layers", "1",
                    "--seq", "16", "--batch", "4", "--device", "cpu",
                    "--ckpt", str(tmp_path / "c")],
    }
    procs = {k: subprocess.Popen(c, env=env, cwd=str(tmp_path),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, c in cmds.items()}
    outs = {}
    for k, p in procs.items():
        outs[k] = p.communicate(timeout=300)[0]
    for k in ("olmo", "kimi"):
        assert procs[k].returncode == 0, outs[k]
        assert "[train] loss" in outs[k]
    assert "optimizer=adafactor" in outs["kimi"]
    assert "optimizer=adamw" in outs["olmo"]
    assert procs["example"].returncode == 0 and "done: loss" in \
        outs["example"], outs["example"]
    assert procs["ann"].returncode != 0 and "quickstart" in outs["ann"]
