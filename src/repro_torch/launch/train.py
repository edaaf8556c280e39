"""Training launcher (the JAX package's ``repro.launch.train``).

Trains an arch's config, cast to float32, with seeded random weights on
one device: the card by default, or ``--device cpu`` for the plain path.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 50 --batch 16 --seq 64 --ckpt /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import registry
from ..data.pipeline import TokenPipeline
from ..device import resolve
from ..distributed import compression
from ..distributed.fault import TrainController
from ..models import model as model_lib
from ..train import checkpoint as ckpt_lib
from ..train import loop as loop_lib
from ..train import optimizer as opt_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=registry.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = (registry.smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    cfg = dataclasses.replace(cfg, dtype="float32")
    print(f"[train] {cfg.name}: ~{cfg.total_params/1e6:.1f}M params, "
          f"device {dev}")

    params = model_lib.init_params(cfg, seed=0, device=dev)
    ocfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=10,
                               total_steps=args.steps)
    opt = opt_lib.init(params)
    step = loop_lib.make_train_step(cfg, ocfg,
                                    compress_grads=args.compress_grads,
                                    microbatches=args.microbatches)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0)

    def batch_fn(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(i).items()}

    start = 0
    error = compression.init_error(params) if args.compress_grads else None

    if args.ckpt and args.resume:
        # (the controller is used for resume here; the explicit loop below
        #  drives stepping so the compressed-grads signature also works)
        ctl = TrainController(step_fn=None, batch_fn=batch_fn,
                              ckpt_dir=args.ckpt, ckpt_every=25)
        resumed = ctl.resume(model_lib.abstract_params(cfg),
                             opt_lib.abstract_init(params), dev)
        if resumed:
            params, opt, start = resumed
            print(f"[train] resumed at step {start}")

    t0 = time.time()
    m = {}
    for i in range(start, args.steps):
        if args.compress_grads:
            params, opt, error, m = step(params, opt, batch_fn(i), error)
        else:
            params, opt, m = step(params, opt, batch_fn(i))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"  step {i:5d}  loss={float(m['loss']):.4f}  "
                  f"gnorm={float(m['grad_norm']):.2f}  "
                  f"lr={float(m['lr']):.2e}  "
                  f"{(time.time()-t0)/(i-start+1):.2f}s/step")
        if args.ckpt and (i + 1) % 25 == 0:
            ckpt_lib.save(args.ckpt, i + 1, {"params": params, "opt": opt})
    print("[train] done")
    return params, opt, m


if __name__ == "__main__":
    main()
