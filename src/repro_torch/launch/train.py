"""Training launcher (the reference's ``repro.launch.train``, on the
port).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      [--reduced] [--steps 50] [--batch 8] [--seq 128] [--microbatches 1] \
      [--ckpt-dir DIR] [--resume] [--device cpu]

Trains a language model (``olmo-1b``, ``starcoder2-7b``, ``gemma3-27b``,
``olmoe-1b-7b``, ``kimi-k2-1t-a32b``) as the reference sets it up:
``LMStream`` batches, AdamW (Adafactor for ``kimi*``) at lr 3e-4 with
warmup ``max(5, steps // 20)`` into a cosine decay, checkpoints every
``max(10, steps // 4)`` steps, restart with ``--resume``.  It runs on the
card (``--device cpu`` runs the plain PyTorch path on the CPU instead);
on the card attention runs forward and backward on the hand-written
kernels.  One device: the reference's ``--mesh-data`` / ``--mesh-model``
and its TPU ``XLA_FLAGS`` belong to the parallelism slice.  The graph,
MACE and Wide & Deep families are not trained by the port yet: they
exit non-zero, naming ``ROADMAP.md``'s next slice.
"""
import argparse
import os
import tempfile

NOT_YET = ("the port trains the language models only; training of the "
           "graph, MACE and Wide & Deep families is the next slice of "
           "ROADMAP.md (queue A item 15)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.optim.api import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    if cfg.family != "lm":
        if cfg.family in ("gnn", "recsys"):
            raise SystemExit(f"--arch {args.arch} (family {cfg.family}): "
                             + NOT_YET)
        raise SystemExit(f"--arch {args.arch}: use "
                         "examples/torch/quickstart.py for the ANN system")

    from repro_torch.data.lm import LMStream
    from repro_torch.models import transformer as T

    trainer = Trainer(
        schema=T.schema(cfg), loss_fn=lambda p, b: T.loss_fn(p, cfg, b),
        opt_cfg=OptimizerConfig(
            name="adafactor" if cfg.name.startswith("kimi") else "adamw",
            lr=3e-4, warmup_steps=max(5, args.steps // 20),
            total_steps=args.steps),
        train_cfg=TrainConfig(steps=args.steps, log_every=10,
                              ckpt_every=max(10, args.steps // 4),
                              ckpt_dir=args.ckpt_dir,
                              microbatches=args.microbatches),
        device=args.device)
    print(f"[train] arch={cfg.name} family={cfg.family} "
          f"device={trainer.device} optimizer={trainer.opt_cfg.name} "
          f"params={cfg.n_params() / 1e6:.1f}M")
    data = iter(LMStream(cfg.vocab, args.seq, args.batch,
                         microbatches=args.microbatches))
    _, hist = trainer.run(
        data, resume=args.resume,
        on_metrics=lambda s, m: print(
            f"step {s:5d} " + " ".join(f"{k}={v:.4f}"
                                       for k, v in m.items())))
    if hist:
        print(f"[train] loss {hist[0][1]['loss']:.3f} -> "
              f"{hist[-1][1]['loss']:.3f}")


if __name__ == "__main__":
    main()
