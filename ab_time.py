"""Time kernels and cells of two checkouts of this repository on one card, in
turns (other, this, this, other), each turn in a fresh process that imports
only its own checkout's port.

    python3 ab_time.py OTHER_CHECKOUT [CASE ...]    # needs one CUDA GPU and nvcc

OTHER_CHECKOUT is a directory holding another commit of the repository
(``git archive <commit> | tar -x -C DIR``, DIR git-ignored), for example the
parent of a change.  CASEs (all of them when none is named):

* kernels, the mean device time in ms of 10 calls issued from Python
  between CUDA events after a warm-up (``chip_smoke._time_ms``): ``k1`` and
  ``k4`` at the production shape (K2000 width: R = 100, N = 2000, one
  τ = 100 plateau), ``k1-ring-8`` at SSQA's (96 trials in rings of 8, J⊥
  4, one τ = 100 plateau), each of the three also with a bfloat16 J
  (``k1-bf16``, ``k4-bf16``, ``k1-ring-8-bf16``), ``k2`` at the popcount path's (R = 100, nb = 1, one
  Table II iteration, C = 600), ``k2-ring-8`` and ``k2-ring-16`` at SSQA's
  (96 trials in rings of 8 or 16, the J⊥ 0→4 ramp);
* cells, the walls in s of three ``anneal()`` calls, set-up included, after
  a warm-up call, as ``chip_smoke.py`` runs them on the K2000 twin at Table
  II's widths with 10 iterations: ``production-cell`` (K1),
  ``popcount-cell`` (``field_mode='popcount'``, K2) and
  ``ssqa-popcount-cell`` (SSQA's 96 trials in rings of 8, K2's ring mode).

Each turn builds its checkout's kernels and makes its inputs with that
checkout's own ``chip_smoke.py`` helpers from one seed, so both sides see
the same data.  The card's name and power limit come first, then one JSON
line per turn.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, PLATEAU_C, CHAIN_C = 2000, 100, 600


def _k1(ring=0, dtype="float32"):
    def case(cs, torch, dev):
        from repro_torch.kernels.ssa_update import ssa_plateau_packed_batched

        x = cs._plateau_inputs(torch.Generator().manual_seed(5 if ring else 1),
                               96 if ring else 100, N, dev, getattr(torch, dtype))
        kw = dict(jperp=4, n_replicas=ring) if ring else {}
        return lambda: ssa_plateau_packed_batched(**x, i0=32, n_cycles=PLATEAU_C, n_rnd=2, **kw)
    return case


def _k4(dtype="float32"):
    def case(cs, torch, dev):
        from repro_torch.kernels.ssa_update import ssa_plateau_batched

        x = cs._pregen_inputs(torch.Generator().manual_seed(4), 1, 100, N, PLATEAU_C, dev,
                              getattr(torch, dtype))
        return lambda: ssa_plateau_batched(**x, i0=32, n_rnd=2)
    return case


def _k2(ring):
    def case(cs, torch, dev):
        import numpy as np

        from repro_torch.kernels.ssa_update import ssa_plateau_popcount_batched

        x = cs._popcount_inputs(np.random.default_rng(2), 1, 96 if ring else 100, N, 1,
                                CHAIN_C, dev)
        kw = dict(n_rnd=2)
        if ring:
            i0, fold, jperp = cs._ssqa_chain(CHAIN_C)
            x.update(i0_sched=torch.tensor(i0, device=dev),
                     fold_sched=torch.tensor(fold, device=dev))
            kw.update(jperp_sched=torch.tensor(jperp, device=dev), n_replicas=ring)
        return lambda: ssa_plateau_popcount_batched(**x, **kw)
    return case


def _cell(field_mode, ssqa=False):
    def case(cs, torch, dev):
        from repro_torch.core import gset
        from repro_torch.core.config import SolverConfig
        from repro_torch.core.ssa import SSAHyperParams, anneal
        from repro_torch.core.ssqa import SSQAHyperParams

        widths = dict(m_shot=cs.M_SHOT_PRODUCTION, tau=100, i0_min=1, i0_max=32)
        hp = (SSQAHyperParams(n_trials=cs.SSQA_TRIALS, n_replicas=cs.SSQA_RING,
                              jperp_max=cs.SSQA_JPERP_MAX, **widths) if ssqa
              else SSAHyperParams(n_trials=100, **widths))
        kw = dict(config=SolverConfig(backend="cuda", field_mode=field_mode, noise="xorshift"),
                  seed=0, record="best", track_energy=False, device="cuda")
        p = gset.load("K2000")
        anneal(p, dataclasses.replace(hp, m_shot=1), **kw)  # warm-up
        walls = []
        for _ in range(3):
            t0 = time.time()
            anneal(p, hp, **kw)
            torch.cuda.synchronize()
            walls.append(round(time.time() - t0, 3))
        return walls
    return case


KERNELS = {"k1": _k1(), "k1-bf16": _k1(dtype="bfloat16"), "k1-ring-8": _k1(8),
           "k1-ring-8-bf16": _k1(8, "bfloat16"), "k4": _k4(), "k4-bf16": _k4("bfloat16"),
           "k2": _k2(0), "k2-ring-8": _k2(8), "k2-ring-16": _k2(16)}
CELLS = {"production-cell": _cell("dense"), "popcount-cell": _cell("popcount"),
         "ssqa-popcount-cell": _cell("popcount", ssqa=True)}


def time_checkout(tree: Path, cases) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("ab_time: no CUDA device")
    _build.build()
    dev = torch.device("cuda")
    out = {}
    for name in cases:
        if name in KERNELS:
            out[name] = chip_smoke._time_ms(KERNELS[name](chip_smoke, torch, dev), reps=10)
        else:
            out[name] = CELLS[name](chip_smoke, torch, dev)
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--time":
        print(json.dumps(time_checkout(Path(sys.argv[2]).resolve(), sys.argv[3:])))
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        sys.exit(__doc__)
    other = Path(sys.argv[1]).resolve()
    cases = sys.argv[2:] or [*KERNELS, *CELLS]
    unknown = [c for c in cases if c not in KERNELS and c not in CELLS]
    if unknown:
        sys.exit(f"ab_time: unknown cases {unknown}; known: {[*KERNELS, *CELLS]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        run = subprocess.run([sys.executable, __file__, "--time", str(tree), *cases],
                             capture_output=True, text=True)
        if run.returncode:
            sys.exit(f"ab_time: the {label} checkout ({tree}) failed:\n{run.stdout}{run.stderr}")
        print(f"[{label}] {tree}: {run.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
