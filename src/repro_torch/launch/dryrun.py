"""The LM's dry-run: lower every (architecture × train/prefill/decode
cell) on the production meshes and extract the roofline terms on the H100
(port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out experiments/dryrun

Each cell is traced on rank 0 of an abstract 16 × 16 (``single``) or 2 ×
16 × 16 (``pod``) mesh (:mod:`repro_torch.launch.lowering`): nothing is
allocated and no card is needed.  A JSON record per cell is written to
``--out`` with the reference's keys; the TPU's ``fits_hbm_16g`` becomes
``fits_hbm_80g``, the H100's 80 GB, and ``t_compile_s`` is null (the trace
is the lowering: nothing is compiled).  The roofline terms come from the
analysis lowering on the single-pod mesh.  A cell that does not apply
(long_500k on a full-attention arch) is skipped with the reference's
reason; the families that do not run on a mesh yet (MoE, Mamba, RWKV,
whisper) raise NotImplementedError citing ROADMAP.md queue 1, steps
10.2–10.4, recorded as an error.  A train cell traces one train step —
forward, backward, the gradient sums and the ZeRO-1 AdamW update — and
its ``useful_flops_ratio`` is 6·N·D over the traced FLOPs.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import ARCH_NAMES, SHAPES, applicable, get_config
from ..sharding import abstract_mesh
from . import hlo_analysis as H
from . import lowering as LOW

__all__ = ["run_cell", "main"]

HBM_BYTES = 80e9  # one H100's device memory


def _mesh(kind: str):
    if kind == "pod":
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, verbose: bool = True,
             analysis: bool = True):
    """Lower one cell; returns its JSON-able record.

    Two lowerings, as the reference's: the deployment program (the
    configs' chunks: its peak estimate is the capacity proof) and, with
    ``analysis``, the analysis program (chunks of the whole sequence: the
    FLOPs, bytes and collective bytes of the roofline terms).  The mesh
    runs DEFAULT_RULES, the reference's ``"baseline"`` rules."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "rules": "baseline",
           "kind": shape.kind}
    ok, reason = applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_kind}] SKIP: {reason}")
        return rec

    mesh = _mesh(mesh_kind)
    n_chips = mesh.size
    low = LOW.cell_lowering(cfg, shape, mesh)
    peak = float(low.peak_bytes)
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_kind}] lower {low.seconds:.1f}s; per device: "
              f"args {low.argument_bytes} B, peak estimate {peak:.0f} B")
    raw = H.roofline(low, n_chips)
    rec.update(
        status="ok",
        n_chips=n_chips,
        t_lower_s=low.seconds,
        t_compile_s=None,
        argument_bytes_per_device=low.argument_bytes,
        peak_bytes_per_device=peak,
        fits_hbm_80g=bool(peak < HBM_BYTES),
        raw_hlo_flops_per_device=raw.flops,
        raw_hlo_coll_bytes_per_device=raw.coll_bytes,
    )
    total_p, active_p = LOW.count_params(cfg)
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = H.model_flops(active_p, n_tokens, shape.kind)
    rec.update(params_total=total_p, params_active=active_p, n_tokens=n_tokens, model_flops=mf)

    if analysis:
        t0 = time.time()
        ac = LOW.analysis_costs(cfg, shape, mesh)
        rec["t_analysis_s"] = time.time() - t0
        rep = H.RooflineReport(
            flops=ac["flops"], hbm_bytes=ac["hbm_bytes"], coll_bytes=ac["coll_bytes"],
            coll_breakdown=ac["coll_breakdown"], n_chips=n_chips,
            peak_memory_per_device=peak, flops_f32=ac["flops_f32"],
            coll_ranks=ac["coll_ranks"])
        rec.update(**rep.asdict())
        rec["useful_flops_ratio"] = mf / (rep.flops * n_chips) if rep.flops else None
        if verbose:
            print(f"  roofline (extrapolated, per device, H100): compute "
                  f"{rep.t_compute * 1e3:.2f} ms | memory {rep.t_memory * 1e3:.2f} ms | "
                  f"collective {rep.t_collective * 1e3:.2f} ms ({rep.link}) → "
                  f"{rep.dominant}-bound; MODEL/traced flops "
                  f"{rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}; "
                  f"peak {peak / 1e9:.2f} GB/device")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "pod", "both"), default="single")
    ap.add_argument("--all", action="store_true", help="every (arch × shape)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = ("single", "pod") if args.mesh == "both" else (args.mesh,)
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for a, s, m in cells:
        try:
            # the roofline is the single pod's; the pod pass shows "pod" shards
            rec = run_cell(a, s, m, verbose=not args.quiet, analysis=(m == "single"))
        except Exception as e:  # recorded, and the run fails
            traceback.print_exc()
            rec = {"arch": a, "shape": s, "mesh": m, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        with open(os.path.join(args.out, f"{a}__{s}__{m}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"\n{len(cells)} cells, {failures} failures → {args.out}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
