"""The traced training step of ``chip_smoke.py``'s phase 17, in a fresh
process: ``olmo_1b`` at full width (16 layers, B = 4 x 2,048, bf16, remat,
AdamW as the launcher sets it, weights from ``init_params`` seeded on the
card), an untraced step, then one under ``torch.profiler``.  Prints the
step's wall ms, the device's busy ms and share, the device ms and share
of ``flash_attention``'s tile body and of the backward kernel's two
passes, and the costliest device ops, as one JSON object on its last
line.

    PYTHONPATH=src python tools/train_trace.py [--device cpu] [--wait]

``--wait`` reads one line from standard input after the imports and
before anything touches the device (the smoke starts the process while
its own steps run).

In a fresh process the profiler's trace keeps every kernel, which the full
smoke's late traces can lose.
"""
import argparse
import itertools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--wait", action="store_true",
                    help="read a line from stdin before using the device")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMStream
    from repro_torch.models import transformer as T
    from repro_torch.models.module import batch_to
    from repro_torch.optim.api import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    if args.wait:
        sys.stdin.readline()
    cfg = get_arch(CS.TRAIN_ARCH)
    tr = Trainer(schema=T.schema(cfg),
                 loss_fn=lambda p, b: T.loss_fn(p, cfg, b),
                 opt_cfg=OptimizerConfig(lr=3e-4, warmup_steps=5,
                                         total_steps=CS.TRAIN_STEPS),
                 train_cfg=TrainConfig(steps=1, log_every=0, ckpt_every=0),
                 device=args.device)
    cuda = tr.device.type == "cuda"
    stream = LMStream(cfg.vocab, CS.TRAIN_SEQ, CS.TRAIN_B, seed=0)
    state, _ = tr.run(itertools.islice(stream, 1))
    batch = batch_to(next(stream), tr.device)
    step = tr.compiled_step()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state["params"], state["opt_state"], batch)
        if cuda:
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, top, per = CS.device_time(prof, 6)
    flash = CS.kernel_us(per, ("tile_kernel",))
    bwd = CS.kernel_us(per, CS.BWD_KERNELS)
    share = (lambda x: x / busy) if busy > 0 else (lambda x: 0.0)
    print(json.dumps(dict(
        wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, busy_share=busy / wall_us,
        flash_ms=flash / 1e3, flash_share=share(flash), bwd_ms=bwd / 1e3,
        bwd_share=share(bwd), top=top, device=str(tr.device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
