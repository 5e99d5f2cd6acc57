"""One HA-SSA iteration of a G-set instance on a ``data`` × ``model`` mesh,
each rank running its block of the fused step, held against the unsharded
step.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.examples.mesh_step \
        --mesh 2x2 [--problem G11] [--trials 8] [--tau 10] [--device cpu]

The mesh spans every rank ``torchrun`` starts (NCCL on the GPUs, gloo with
``--device cpu``); without ``torchrun`` the mesh is one rank.  Each rank
cuts its block of the whole state and couplings
(``convert.iteration_state_block``), runs ``make_iteration_step`` on it,
and rank 0 joins the blocks (``convert.iteration_state_join``) and compares
them with the unsharded step run on its own device.
"""
import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core import gset
from repro_torch.core.distributed import make_iteration_step
from repro_torch.core.engine import BIG_ENERGY
from repro_torch.core.rng import xorshift_init, xorshift_next_bits
from repro_torch.core.ssa import SSAHyperParams
from repro_torch.launch.mesh import make_mesh, parse_mesh_shape


def start_state(seed: int, T: int, N: int, device):
    """The state anneal() starts from: lanes seeded, one draw taken as m."""
    rng, r0 = xorshift_next_bits(xorshift_init(seed, (T, N), device=device))
    m = r0.to(torch.float32)
    return (rng, m, torch.where(m > 0, 0, -1).to(torch.int32),
            torch.full((T,), BIG_ENERGY, dtype=torch.int32, device=device), r0.to(torch.int8))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="1x1", help="data x model, e.g. 2x2")
    ap.add_argument("--problem", default="G11")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    mesh = make_mesh(parse_mesh_shape(args.mesh), ("data", "model"), device=args.device)
    problem = gset.load(args.problem)
    model = problem.to_ising()
    hp = SSAHyperParams(n_trials=args.trials, m_shot=1, tau=args.tau, i0_min=1, i0_max=32)
    state = start_state(args.seed, hp.n_trials, model.n, mesh.device)
    J = torch.from_numpy(model.dense_J()).to(mesh.device, torch.float32)
    h = torch.from_numpy(np.asarray(model.h, np.int32)).to(mesh.device)
    block, operands = convert.iteration_state_block(state, (J, h), mesh)
    t0 = time.perf_counter()
    out = [t.cpu() for t in make_iteration_step(hp, mesh)(*block, *operands)]
    secs = time.perf_counter() - t0
    blocks = [None] * mesh.size
    dist.gather_object(out, blocks if mesh.rank == 0 else None, dst=0)
    if mesh.rank == 0:
        whole = convert.iteration_state_join(blocks, mesh, state)
        want = make_iteration_step(hp)(*state, J, h)
        same = all(torch.equal(a, b.cpu()) for a, b in zip(whole, want))
        cut = problem.cut_value(whole[4].numpy())
        print(f"{args.problem} on a {args.mesh} {mesh.backend} mesh ({mesh.device}): one "
              f"iteration in {secs:.3f}s on rank 0; best cut {int(cut.max())}; joined blocks "
              f"== the unsharded step: {same}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
