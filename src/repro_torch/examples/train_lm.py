"""End-to-end training driver: train a LM on the synthetic pipeline with
checkpointing; it resumes if interrupted (kill it mid-run and run it again).

Port of the JAX package's ``examples/train_lm.py``:

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 120] [--arch qwen3-1.7b]
        [--scale reduced|full] [--device cpu]

'reduced' trains the smoke-scale config (CPU-friendly); 'full' the real
config (on the card).
"""
import argparse
import os
import tempfile

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.ft.resilience import run_training
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_NAMES)
    ap.add_argument("--scale", default="reduced", choices=("reduced", "full"))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=(args.scale == "reduced"))
    tc = TrainConfig(opt=AdamWConfig(lr_peak=3e-3, warmup_steps=10,
                                     total_steps=args.steps), loss_chunk=64)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                    n_patches=cfg.n_patches if cfg.frontend == "vision" else 0,
                    d_model=cfg.d_model,
                    n_frames=cfg.n_frames if cfg.encoder_layers else 0)

    _, losses = run_training(
        init_state_fn=lambda: init_train_state(cfg, tc, 0, device=args.device),
        train_step=make_train_step(cfg, tc),
        batch_fn=lambda s: synthetic_batch(dc, s, device=args.device),
        n_steps=args.steps,
        ckpt=CheckpointManager(args.ckpt_dir, save_interval=20, keep=2),
        log_every=10,
    )
    if losses:
        print(f"\ntrained {args.arch} ({args.scale}) for {args.steps} steps: "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
