"""Serving example: batched prefill and greedy decode with a KV cache, on a
reduced config of one of the ten architectures, with random weights.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch granite-3-8b] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import model_defs
from repro_torch.models.params import init_params
from repro_torch.serve.lm import ServeConfig, generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    params = init_params(model_defs(cfg), seed=0, device=args.device)
    rs = np.random.default_rng(1)
    batch = {"tokens": rs.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = (rs.standard_normal((args.batch, cfg.n_patches, cfg.d_model))
                            * 0.02).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = (rs.standard_normal((args.batch, cfg.n_frames, cfg.d_model))
                           * 0.1).astype(np.float32)

    out = generate(params, batch, cfg, ServeConfig(max_seq=args.prompt_len + args.new_tokens),
                   n_new_tokens=args.new_tokens, device=args.device)
    print(f"arch={cfg.name} batch={args.batch}")
    for b in range(args.batch):
        print(f"  request {b}: {out[b].tolist()}")


if __name__ == "__main__":
    main()
