"""Whether the attention kernels cause the loss to jump in
``chip_smoke.py``'s phase 17 (b): the same full-width ``olmo_1b`` run
(16 layers, B = 4 x 2,048, bf16, remat, AdamW as the launcher sets it,
weights from ``init_params`` seeded on the card, ``LMStream(seed=0)``),
twice from the same seed: on the kernel path and on
``kernel_backend="torch"`` (bf16, the plain attention), each step's loss
side by side.  On the kernel path, phase 17's gradient gate
(:func:`chip_smoke.train_gate`: the gradient tree and each token's loss,
the kernel path and the bf16 plain path against the float32 plain run)
runs again at the weights after ``--gate-step`` updates, on that step's
batch, where the softmax has moved away from the uniform one of the
initial weights.  Prints ``[spike]`` lines and one JSON object as its last
line.

    PYTHONPATH=src python tools/train_spike.py [--steps 12] [--gate-step 7]
"""
import argparse
import dataclasses
import itertools
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402


def run(backend: str, steps: int, gate_step: int, device):
    """(each step's loss, the gate at ``gate_step`` or None) of ``steps``
    steps on ``backend``; the gate runs on the kernel path only."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMStream
    from repro_torch.models import transformer as T
    from repro_torch.models.module import batch_to
    from repro_torch.optim.api import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_arch(CS.TRAIN_ARCH)
    tr = Trainer(schema=T.schema(cfg),
                 loss_fn=lambda p, b: T.loss_fn(p, cfg, b,
                                                kernel_backend=backend),
                 opt_cfg=OptimizerConfig(lr=3e-4,
                                         warmup_steps=max(5, steps // 20),
                                         total_steps=steps),
                 train_cfg=TrainConfig(steps=gate_step, log_every=1,
                                       ckpt_every=0), device=device)
    losses = []
    stream = LMStream(cfg.vocab, CS.TRAIN_SEQ, CS.TRAIN_B, seed=0)
    state, _ = tr.run(stream, on_metrics=lambda i, m: losses.append(
        m["loss"]))
    batch = next(stream)
    gate = None
    if backend == "auto":
        gate = CS.train_gate(cfg, state["params"], batch_to(batch, tr.device))
    tr.cfg = dataclasses.replace(tr.cfg, steps=steps - gate_step)
    tr.run(itertools.chain([batch], stream), state=state,
           on_metrics=lambda i, m: losses.append(m["loss"]))
    del state, tr
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return losses, gate


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=CS.TRAIN_STEPS)
    ap.add_argument("--gate-step", type=int, default=7,
                    help="updates before the second gate (the loss jumps at "
                         "step 7 of phase 17's run, counted from 0)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False   # the float32 reference
    torch.backends.cudnn.allow_tf32 = False
    kern, gate = run("auto", args.steps, args.gate_step, args.device)
    plain, _ = run("torch", args.steps, args.gate_step, args.device)
    for i, (a, b) in enumerate(zip(kern, plain)):
        print(f"[spike] step {i}: loss kernel path {a:.4f}, bf16 plain "
              f"path {b:.4f}")
    print(f"[spike] gate after {args.gate_step} updates: gradient tree's "
          f"global relative error kernel {gate['grad_err_kernel']:.4g}, "
          f"bf16 plain {gate['grad_err_plain']:.4g} (limit 2x); each "
          f"token's loss kernel {gate['token_err_kernel']:.4g}, plain "
          f"{gate['token_err_plain']:.4g} (limit 2x); launches "
          f"{gate['launches_kernel']['flash_attention']} / "
          f"{gate['launches_kernel']['flash_attention_bwd']}")
    ok = (gate["finite_kernel"]
          and gate["grad_err_kernel"] <= 2 * gate["grad_err_plain"]
          and gate["token_err_kernel"] <= 2 * gate["token_err_plain"])
    print(json.dumps(dict(ok=ok, gate_step=args.gate_step,
                          losses_kernel=kern, losses_plain=plain, gate=gate)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
