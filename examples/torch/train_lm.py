"""Train a small LM end to end with the port's trainer, on the card:
gradient accumulation, warmup-cosine, checkpointing and resume, attention
forward and backward on the hand-written kernels.

  PYTHONPATH=src python examples/torch/train_lm.py [--steps 200] \
      [--d-model 128] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import TransformerConfig
from repro_torch.data.lm import LMStream
from repro_torch.models import transformer as T
from repro_torch.optim.api import OptimizerConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_lm_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    cfg = TransformerConfig(
        name="demo-lm", n_layers=args.layers, d_model=args.d_model,
        n_heads=4, n_kv_heads=2, d_ff=4 * args.d_model, vocab=2048)
    print(f"model: {cfg.n_params() / 1e6:.1f}M params")

    trainer = Trainer(
        schema=T.schema(cfg),
        loss_fn=lambda p, b: T.loss_fn(p, cfg, b),
        opt_cfg=OptimizerConfig(lr=3e-3, warmup_steps=20,
                                total_steps=args.steps),
        train_cfg=TrainConfig(steps=args.steps, log_every=20, ckpt_every=50,
                              ckpt_dir=args.ckpt, microbatches=2),
        device=args.device)
    data = iter(LMStream(cfg.vocab, args.seq, args.batch, microbatches=2))
    _, hist = trainer.run(
        data, resume=args.resume,
        on_metrics=lambda s, m: print(
            f"step {s:4d} loss {m['loss']:.3f} acc {m['acc']:.3f} "
            f"gnorm {m['grad_norm']:.2f}"))
    print(f"done: loss {hist[0][1]['loss']:.3f} -> {hist[-1][1]['loss']:.3f}")


if __name__ == "__main__":
    main()
