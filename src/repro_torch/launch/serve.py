"""Serving launcher: the RedN-style decode engine with isolation+failover.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b

Runs the arch's smoke config (any of ``configs.registry.ARCHS``) with
seeded random weights on the card.  An encoder-decoder arch's slots read
s_max encoder positions (``ServeEngine.enc_lengths``), as the JAX path's
``decode_step(enc_lengths=)`` does.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import registry
from ..models import model as model_lib
from ..serve import ServeEngine


def main(argv=None, device=None) -> ServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=registry.ARCHS)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--crash-host", action="store_true",
                    help="kill the host driver mid-run (§5.6)")
    args = ap.parse_args(argv)

    cfg = registry.smoke_config(args.arch)
    params = model_lib.init_params(cfg, seed=0, device=device)
    eng = ServeEngine(cfg, params, s_max=128, n_slots=args.slots,
                      device=device)
    rng = np.random.RandomState(0)
    for s in range(args.slots):
        eng.add_request(s, int(rng.randint(0, eng.n_clients)),
                        int(rng.randint(1, cfg.vocab_size)))
    for i in range(args.steps):
        eng.step()
        if args.crash_host and i == args.steps // 2:
            eng.crash_host_driver()
            print(f"[serve] host driver crashed at step {i}; "
                  f"device serving continues")
    print(f"[serve] {eng.stats}")
    return eng


if __name__ == "__main__":
    main()
