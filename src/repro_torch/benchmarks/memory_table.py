"""The paper's Table IV: trajectory memory of SSA (Eq. 5) against HA-SSA
(Eq. 6), with equal cut values, analytic and measured (the port of the JAX
repo's ``benchmarks/memory_table.py``).

    python -m repro_torch.benchmarks.memory_table [--backend auto] [--device cpu]

Table II's hyper-parameters (N = 800, I0 1→32: 6 plateaus, τ = 100,
m_shot = 150): SSA 0.48 Mb an iteration (72 Mb a trial) against HA-SSA's
0.08 Mb (12 Mb) → 6×.  The measured rows size the buffers a reduced run
(G11, 2 trials, 2 iterations, ``record='traj'``) really holds: its
trajectory planes, the device bytes the two runs left and their peaks,
the live engine state in the dense and packed layouts,
J's bytes (float32 against packed bitplanes, and float32 against
bfloat16), and one rank's bytes under spin sharding at P = 1.  On the card
the live-byte and peak rows read the CUDA caching allocator
(``memory.measure_live_bytes``, ``torch.cuda.max_memory_allocated``); on
the CPU they print "not measured".
Exits 1 when the measured HA-SSA/SSA ratio falls more than 15% below the
analytic one.
"""
from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from repro_torch.core import gset, memory
from repro_torch.core.config import SolverConfig
from repro_torch.core.engine import bucket_n, make_backend, make_batched_backend
from repro_torch.core.ssa import SSAHyperParams, anneal
from repro_torch.kernels.bitplane import adjacency_weight_bits, packed_j_nbytes

from .common import emit

# The measured ratio may fall at most this far below the analytic model.
RATIO_TOLERANCE = 0.15


def _live(build, device):
    """(result, live device bytes it left, peak device bytes while it ran)
    on the card; (result, None, None) on the CPU, where there is no
    allocator to read."""
    if torch.device(device).type != "cuda":
        return build(), None, None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = memory.live_device_bytes(device)
    out, left = memory.measure_live_bytes(build, device)
    return out, left, torch.cuda.max_memory_allocated(device) - before


def run(csv_prefix: str = "table4_memory", backend: str = "sparse", device=None):
    device = "cuda" if device is None else device
    hp = SSAHyperParams()  # Table II
    n = 800
    m_ssa = memory.ssa_bits_per_iteration(n, hp)
    m_ha = memory.hassa_bits_per_iteration(n, hp)
    ratio = memory.memory_ratio(hp)
    emit(f"{csv_prefix}/ssa_bits_per_iter", 0.0, f"{m_ssa}")
    emit(f"{csv_prefix}/hassa_bits_per_iter", 0.0, f"{m_ha}")
    emit(f"{csv_prefix}/ssa_Mb_per_iter", 0.0, f"{m_ssa/1e6:.2f}")
    emit(f"{csv_prefix}/hassa_Mb_per_iter", 0.0, f"{m_ha/1e6:.2f}")
    emit(f"{csv_prefix}/ratio", 0.0, f"{ratio}x")
    emit(f"{csv_prefix}/ssa_Mb_per_trial", 0.0,
         f"{memory.bits_per_trial(n, hp, hardware_aware=False)/1e6:.0f}")
    emit(f"{csv_prefix}/hassa_Mb_per_trial", 0.0,
         f"{memory.bits_per_trial(n, hp, hardware_aware=True)/1e6:.0f}")

    # The service pads N to its power-of-two shape bucket, so each stored
    # bitplane carries dead pad bits: reported beside Eq. (5)/(6).
    for n_i in (800, 1024, 2000):
        emit(f"{csv_prefix}/bucket_n{n_i}", 0.0, f"{bucket_n(n_i)}")
        emit(f"{csv_prefix}/pad_overhead_bits_per_iter_n{n_i}", 0.0,
             f"{memory.padding_overhead_bits_per_iteration(n_i, hp)}")
        emit(f"{csv_prefix}/pad_overhead_pct_n{n_i}", 0.0,
             f"{100*memory.padding_overhead_fraction(n_i):.1f}")

    # The reduced run: the trajectory buffers are the memory model.
    g = gset.load("G11")
    hp_small = SSAHyperParams(n_trials=2, m_shot=2)
    cfg = SolverConfig(backend=backend, noise="threefry")  # anneal()'s default noise
    r_ha, ha_bytes, ha_peak = _live(lambda: anneal(
        g, hp_small, seed=0, storage="i0max", record="traj", config=cfg, device=device), device)
    r_ssa, ssa_bytes, ssa_peak = _live(lambda: anneal(
        g, hp_small, seed=0, storage="all", record="traj", config=cfg, device=device), device)
    emit(f"{csv_prefix}/structural_ratio", 0.0,
         f"{r_ssa.stored_bits_per_iter // r_ha.stored_bits_per_iter}x")
    emit(f"{csv_prefix}/equal_best_cut", 0.0,
         str(int(r_ha.overall_best_cut) == int(r_ssa.overall_best_cut)))

    # Measured: the trajectory planes each storage policy held (32-bit
    # words, so ×8 = bits with the word padding), per iteration and trial.
    per_run = hp_small.m_shot * hp_small.n_trials
    meas_ssa_bits = 8 * r_ssa.traj.nbytes // per_run
    meas_ha_bits = 8 * r_ha.traj.nbytes // per_run
    measured_ratio = meas_ssa_bits / meas_ha_bits
    emit(f"{csv_prefix}/measured_ssa_bits_per_iter", 0.0, f"{meas_ssa_bits}")
    emit(f"{csv_prefix}/measured_hassa_bits_per_iter", 0.0, f"{meas_ha_bits}")
    emit(f"{csv_prefix}/measured_ratio", 0.0, f"{measured_ratio:.2f}x")
    emit(f"{csv_prefix}/analytic_ratio", 0.0, f"{ratio}x")
    for name, b in (("ssa", ssa_bytes), ("hassa", ha_bytes)):
        emit(f"{csv_prefix}/measured_live_bytes_{name}_run", 0.0,
             "not measured" if b is None else f"{b}")
    # The card's peak while each run held its trajectory planes (J and the
    # engine state included): what the run needed, not what it left.
    for name, b in (("ssa", ssa_peak), ("hassa", ha_peak)):
        emit(f"{csv_prefix}/measured_peak_bytes_{name}_run", 0.0,
             "not measured" if b is None else f"{b}")

    # The live engine state between plateau launches, dense against packed.
    model = g.to_ising()

    def state_bytes(layout):
        bk = make_backend("sparse", model, n_trials=hp_small.n_trials, noise="xorshift",
                          storage_layout=layout, device=device)
        return memory.tree_device_bytes(bk.init_state(0))

    dense_state, packed_state = state_bytes("dense"), state_bytes("packed")
    emit(f"{csv_prefix}/measured_state_bytes_dense", 0.0, f"{dense_state}")
    emit(f"{csv_prefix}/measured_state_bytes_packed", 0.0, f"{packed_state}")
    emit(f"{csv_prefix}/state_bytes_ratio", 0.0, f"{dense_state / packed_state:.2f}x")

    # J's residency: the float32 matrix against the popcount datapath's
    # sign/magnitude bitplanes, beside the codec's analytic size.
    jb = adjacency_weight_bits(model.n, model.nbr_idx, model.nbr_w)
    bk_dense = make_backend("dense", model, n_trials=hp_small.n_trials, noise="xorshift",
                            field_mode="dense", j_mode="dense", device=device)
    bk_pc = make_backend("dense", model, n_trials=hp_small.n_trials, noise="xorshift",
                         field_mode="popcount", device=device)
    dense_j = memory.tree_device_bytes(bk_dense.J)
    pj = bk_pc.packed_j
    packed_j = memory.tree_device_bytes((pj.sign, pj.mags, pj.base))
    emit(f"{csv_prefix}/j_bits", 0.0, f"{jb}")
    emit(f"{csv_prefix}/analytic_packed_j_bytes", 0.0, f"{packed_j_nbytes(model.n, jb)}")
    emit(f"{csv_prefix}/measured_j_bytes_dense", 0.0, f"{dense_j}")
    emit(f"{csv_prefix}/measured_j_bytes_packed", 0.0, f"{packed_j}")
    emit(f"{csv_prefix}/j_bytes_ratio", 0.0, f"{dense_j / packed_j:.2f}x")

    # J held in bfloat16 (j_dtype) on the backend that holds one: half the
    # bytes, the same fields (every ±1 weight is exact in bfloat16).
    j_backend = "dense" if backend == "sparse" else backend
    j_bytes = {}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        bk = make_backend(j_backend, model, n_trials=hp_small.n_trials, noise="xorshift",
                          field_mode="dense", j_dtype=dt, device=device)
        j_bytes[label] = memory.tree_device_bytes(bk.J)
        emit(f"{csv_prefix}/measured_j_bytes_{label}", 0.0, f"{j_bytes[label]}")
    emit(f"{csv_prefix}/j_bytes_f32_over_bf16", 0.0,
         f"{j_bytes['f32'] / j_bytes['bf16']:.2f}x")

    # One rank's residency under spin sharding, at P = 1 (a one-rank group):
    # the unsharded footprint, the figure that falls about linearly in P.
    from repro_torch.sharding import spin_mesh

    created = not dist.is_initialized()
    mesh = spin_mesh(1, device=device)
    try:
        bk_sh = make_batched_backend("dense", n_bucket=1024, n_trials=hp_small.n_trials,
                                     noise="xorshift", partition="spin", mesh=mesh)
        prob_sh = bk_sh.stack([model])
        st_sh = bk_sh.init_state(prob_sh, bk_sh.init_noise([0], [model.n]))
        per = memory.per_device_bytes((prob_sh, st_sh), mesh)
        busiest = memory.max_device_bytes((prob_sh, st_sh), mesh)
    finally:
        if created:
            dist.destroy_process_group()
    total_sh = sum(per.values())
    emit(f"{csv_prefix}/spinshard_devices", 0.0, f"{mesh.size}")
    emit(f"{csv_prefix}/spinshard_total_bytes", 0.0, f"{total_sh}")
    emit(f"{csv_prefix}/spinshard_max_device_bytes", 0.0, f"{busiest}")
    emit(f"{csv_prefix}/spinshard_balance", 0.0,
         f"{total_sh / (busiest * mesh.size):.2f}" if busiest else "n/a")

    ok = measured_ratio >= (1.0 - RATIO_TOLERANCE) * ratio
    emit(f"{csv_prefix}/measured_vs_analytic_ok", 0.0, str(ok))
    return {
        "ratio": ratio,
        "m_ssa": m_ssa,
        "m_ha": m_ha,
        "measured_ratio": measured_ratio,
        "measured_ok": ok,
        "live_bytes": (ssa_bytes, ha_bytes),
        "peak_bytes": (ssa_peak, ha_peak),
        "j_bytes": j_bytes,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="sparse",
                    choices=("sparse", "dense", "cuda", "auto"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    out = run(backend=args.backend, device=args.device)
    if not out["measured_ok"]:
        print(f"FAIL: measured HA-SSA/SSA ratio {out['measured_ratio']:.2f} fell more than "
              f"15% below the analytic model ({out['ratio']})", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
