"""Serving example: batched prefill and greedy decode with a KV cache, on a
config of one of the ten architectures (reduced unless ``--scale full``),
with random weights; alone, or on a ``data`` × ``model`` mesh.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch granite-3-8b] [--device cpu]
    # tensor-parallel over two GPUs (NCCL), one rank a process:
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.examples.serve_lm \\
        --arch qwen3-1.7b --scale full --mesh 1x2
    # two gloo ranks sharing one card, or two CPU ranks (--device cpu):
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.examples.serve_lm \\
        --arch qwen3-1.7b --mesh 1x2 --backend gloo

On a mesh every rank draws the whole parameters, keeps its blocks
(``convert.lm_params_block``) and calls ``generate`` with the whole prompt
batch; rank 0 prints the tokens and whether they equal the unsharded
``generate`` run on its own device.  Only the attention + MLP families run
on a mesh (MoE, Mamba, RWKV and whisper raise NotImplementedError).
"""
import argparse
import os

import numpy as np

from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import model_defs
from repro_torch.models.params import init_params
from repro_torch.serve.lm import ServeConfig, generate


def _mesh(shape: str, backend, device):
    """make_mesh over ``shape`` (data x model); with ``backend='gloo'`` the
    torchrun group is joined as gloo first, so that ranks can share a card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, parse_mesh_shape

    if backend == "gloo" and not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                                              "1")) > 1:
        dist.init_process_group("gloo", init_method="env://")
    return make_mesh(parse_mesh_shape(shape), ("data", "model"), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_NAMES)
    ap.add_argument("--scale", default="reduced", choices=("reduced", "full"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a data x model mesh (e.g. 1x2) of the torchrun ranks")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's process group: NCCL on cuda and gloo on cpu unless "
                         "given; gloo lets several ranks share one card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.scale == "reduced")
    rs = np.random.default_rng(1)
    batch = {"tokens": rs.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = (rs.standard_normal((args.batch, cfg.n_patches, cfg.d_model))
                            * 0.02).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = (rs.standard_normal((args.batch, cfg.n_frames, cfg.d_model))
                           * 0.1).astype(np.float32)
    sc = ServeConfig(max_seq=args.prompt_len + args.new_tokens)

    if args.mesh is None:
        params = init_params(model_defs(cfg), seed=0, device=args.device)
        out = generate(params, batch, cfg, sc, n_new_tokens=args.new_tokens, device=args.device)
        print(f"arch={cfg.name} batch={args.batch}")
    else:
        import torch.distributed as dist

        mesh = _mesh(args.mesh, args.backend, args.device)
        whole = init_params(model_defs(cfg), seed=0, device=mesh.device)
        params = convert.lm_params_block(whole, cfg, mesh.shape, mesh.coords)
        if mesh.rank:
            del whole
        out = generate(params, batch, cfg, sc, n_new_tokens=args.new_tokens, mesh=mesh)
        if mesh.rank == 0:
            same = np.array_equal(out, generate(whole, batch, cfg, sc, args.new_tokens,
                                                device=mesh.device))
            print(f"arch={cfg.name} batch={args.batch} on a {args.mesh} {mesh.backend} mesh "
                  f"({mesh.device}); tokens == the unsharded generate(): {same}")
        dist.destroy_process_group()
        if mesh.rank:
            return
    for b in range(args.batch):
        print(f"  request {b}: {out[b].tolist()}")


if __name__ == "__main__":
    main()
