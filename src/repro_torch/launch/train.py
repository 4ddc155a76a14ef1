"""Training launcher (the reference's ``repro.launch.train``, on the
port).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      [--reduced] [--steps 50] [--batch 8] [--seq 128] [--microbatches 1] \
      [--ckpt-dir DIR] [--resume] [--device cpu]

Trains each family as the reference sets it up:

* a language model (``olmo-1b``, ``starcoder2-7b``, ``gemma3-27b``,
  ``olmoe-1b-7b``, ``kimi-k2-1t-a32b``): ``LMStream`` batches, AdamW
  (Adafactor for ``kimi*``) at lr 3e-4 with warmup ``max(5, steps //
  20)`` into a cosine decay;
* a graph model (``gin-tu``, ``gatedgcn``, ``graphsage-reddit``):
  ``make_community_graph(2000, 12000, 32, n_classes=8)``, the same batch
  every step (GraphSAGE also with its ``neighbor_matrix``, so that its
  mean runs on ``packed_spmm`` and its gradient on ``packed_spmm_bwd``,
  which sum without atomics: a resumed run is bit for bit the
  uninterrupted one on the card); ``mace``: ``make_molecules(16, 12, 32)``,
  repeated; AdamW at lr 1e-3, warmup 5;
* Wide & Deep (``wide-deep``): ``CTRStream(cfg, max(batch, 64))``, a new
  batch a step; AdamW at lr 1e-3, warmup 5.

Checkpoints every ``max(10, steps // 4)`` steps; ``--resume`` restores
the latest and runs ``--steps`` more, skipping the batches the restored
steps consumed, so a resumed run continues the stream where it stopped.
It runs on the card (``--device cpu`` runs the plain PyTorch path on the
CPU instead); on the card attention runs forward and backward on the
hand-written kernels, and so do Wide & Deep's bag fields
(``embedding_bag``) and GraphSAGE's neighbour mean where a batch carries
``"neighbors"`` (``packed_spmm``: the launcher gives GraphSAGE's
community graph its neighbour matrix, the same edges).  One device: the reference's ``--mesh-data`` /
``--mesh-model`` and its TPU ``XLA_FLAGS`` belong to the parallelism
slice.
"""
import argparse
import itertools
import os
import tempfile


def repeat(batch):
    """The same batch for ever (the reference's ``_repeat``)."""
    while True:
        yield batch


def family_setup(cfg, args):
    """(schema, loss_fn(params, batch), data iterator, OptimizerConfig) of
    ``cfg``'s family, as the reference's launcher sets them up (see the
    module note); raises ``SystemExit`` for the ANN system."""
    from repro_torch.optim.api import OptimizerConfig

    if cfg.family == "lm":
        from repro_torch.data.lm import LMStream
        from repro_torch.models import transformer as T

        return (T.schema(cfg), lambda p, b: T.loss_fn(p, cfg, b),
                iter(LMStream(cfg.vocab, args.seq, args.batch,
                              microbatches=args.microbatches)),
                OptimizerConfig(
                    name="adafactor" if cfg.name.startswith("kimi")
                    else "adamw", lr=3e-4,
                    warmup_steps=max(5, args.steps // 20),
                    total_steps=args.steps))
    opt = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps)
    if cfg.family == "gnn":
        from repro_torch.data import graphs as DG
        from repro_torch.models import gnn as G
        from repro_torch.models import mace as MC

        if cfg.kind == "mace":
            return (MC.schema(cfg), lambda p, b: MC.loss_fn(p, cfg, b),
                    repeat(DG.make_molecules(16, 12, 32)), opt)
        graph = DG.make_community_graph(2000, 12000, 32, n_classes=8)
        if G.kernel_route(cfg, {"neighbors": None}):
            graph["neighbors"] = DG.neighbor_matrix(
                graph["edge_src"], graph["edge_dst"], 2000,
                graph["edge_mask"])
        return (G.schema(cfg, 32, 8), lambda p, b: G.loss_fn(p, cfg, b),
                repeat(graph), opt)
    if cfg.family == "recsys":
        from repro_torch.data.recsys import CTRStream
        from repro_torch.models import recsys as R

        return (R.schema(cfg), lambda p, b: R.loss_fn(p, cfg, b),
                CTRStream(cfg, max(args.batch, 64)), opt)
    raise SystemExit(f"--arch {cfg.name}: use examples/torch/quickstart.py "
                     "for the ANN system")


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
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    schema, loss_fn, data, opt = family_setup(cfg, args)
    trainer = Trainer(
        schema=schema, loss_fn=loss_fn, opt_cfg=opt,
        train_cfg=TrainConfig(steps=args.steps, log_every=10,
                              ckpt_every=max(10, args.steps // 4),
                              ckpt_dir=args.ckpt_dir,
                              microbatches=args.microbatches),
        device=args.device)
    n_params = getattr(cfg, "n_params", None)
    print(f"[train] arch={cfg.name} family={cfg.family} "
          f"device={trainer.device} optimizer={trainer.opt_cfg.name}"
          + (f" params={n_params() / 1e6:.1f}M" if n_params else ""))
    done = ckpt.latest_step(args.ckpt_dir) if args.resume else None
    if done:
        data = itertools.islice(data, done, None)
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
