"""Training entry point (port of ``repro.launch.train``): AdamW steps of
``training.train`` on the synthetic Zipf-Markov stream, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --steps 20 --batch 2 --seq 2048

``--reduced`` trains the smoke-scale config in fp32; without it the
published config in its own dtype.  ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale config in fp32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import DataConfig
    from repro_torch.training import TrainConfig, train

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(dtype="float32")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup=max(5, args.steps // 20),
                       ckpt_dir=args.ckpt_dir,
                       grad_compress_bits=args.grad_compress_bits,
                       log_every=max(1, args.steps // 20))

    def log(step, metrics):
        print(f"step {step:5d}  loss {metrics['loss']:.4f}  "
              f"ce {metrics['ce']:.4f}  gnorm {metrics['grad_norm']:.2f}")

    res = train(cfg, dcfg, tcfg, seed=args.seed, hooks=log,
                device=args.device)
    print(f"done: {res.final_step} steps in {res.wall_time:.1f}s "
          f"(resumed_from={res.resumed_from})")


if __name__ == "__main__":
    main()
