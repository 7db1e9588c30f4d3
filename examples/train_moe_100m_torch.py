"""End-to-end training on the port: a ~100M-parameter granite-style MoE
for a few hundred steps on the synthetic pipeline, with checkpoints and
resume (a rerun with the same ``--ckpt-dir`` resumes from its last
checkpoint).

It trains on ``cuda`` (the ``streamed_moe`` kernel in the forward) unless
``--device cpu`` is given; asking for ``cuda`` where there is none raises.
Run as a script it fails unless the last logged loss is below the first,
a claim about a run of many steps: over a few steps on a small batch the
batch-to-batch noise can outweigh the progress.

  PYTHONPATH=src python examples/train_moe_100m_torch.py [--steps 300]
  PYTHONPATH=src python examples/train_moe_100m_torch.py --device cpu \\
      --steps 3 --batch 2 --seq 32
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device
from repro_torch.training import TrainConfig, train


def build_100m_config():
    """granite-family MoE scaled to ~100M params (same 32e/top-8 shape)."""
    base = get_config("granite-moe-1b-a400m")
    cfg = base.replace(
        name="granite-moe-100m", num_layers=6, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=256, vocab_size=8192,
        dtype="float32",
        moe=MoEConfig(num_experts=16, top_k=4, d_expert=256, impl="capacity"))
    print(f"config: {cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"active={cfg.active_param_count()/1e6:.1f}M")
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_100m_config()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=17)
    tcfg = TrainConfig(lr=1e-3, total_steps=args.steps,
                       warmup=args.steps // 10, ckpt_dir=args.ckpt_dir,
                       ckpt_every=max(50, args.steps // 4),
                       log_every=max(1, args.steps // 30))

    def log(step, m):
        print(f"step {step:5d}  loss {m['loss']:.4f}  ce {m['ce']:.4f}  "
              f"aux {m['aux']:.3f}  gnorm {m['grad_norm']:.2f}")

    res = train(cfg, dcfg, tcfg, seed=0, hooks=log, device=device)
    first, last = res.losses[0][1], res.losses[-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} over {res.final_step} steps "
          f"({res.wall_time:.0f}s; resumed_from={res.resumed_from}; "
          f"checkpoints in {args.ckpt_dir})")
    return res


if __name__ == "__main__":
    losses = main().losses
    if not losses[-1][1] < losses[0][1]:
        raise AssertionError("training must improve the loss")
