"""Chip smoke test of the PyTorch/CUDA port: builds the CUDA kernels from the
sources in this checkout, holds each against its plain PyTorch version on
the card, drives ``repro_torch.core.ssa.anneal`` and
``repro_torch.core.ssqa.anneal_ssqa`` at K2000 width,
``repro_torch.serve.AnnealService.solve`` at B > 1 and
``repro_torch.serve.StreamingAnnealService`` (with chunk checkpoints)
through the kernels, the problem families (QUBO, MIS, coloring, partition)
through K1 and K2, and the SA, PT and PT-SSA baselines, and prints what it
measured.

    python3 chip_smoke.py          # needs one CUDA GPU and nvcc

Phases (any failure raises and exits non-zero):
  1. card: name and power limit (nvidia-smi); the four kernels built;
  2. K3 ``local_field`` == its plain version, exactly, at the K2000 shape,
     ragged ones and with J tiles of one to four byte planes mixed; kernel,
     plain, torch.addmm (TF32 off) times, issued from Python as the trace
     path issues K3 and, beside them, device times by CUDA graph; the bound
     (bytes, beside the int8 MMA time); K3's time under each K split;
  3. K1 ``ssa_plateau_packed`` == its plain version, all five outputs
     exactly, at K2000 and G11 widths, eligible and not, ragged shapes (a
     ragged last group of 8 trials, N % 4 != 0, N above 2048, R below one
     group) and a tied-energy shape; the cluster size and block count of
     the timed launch; kernel and plain times and the bound; K1's time at
     each cluster size (the outputs must not change) and with a bfloat16 J;
  4. threefry: a (C, T, N) = (100, 100, 2000) pregen draw on the card, its
     time, and its first cycles == the same draw on the CPU;
  5. K4 ``ssa_plateau`` == its plain version, all four outputs exactly, at
     K2000 and G11 widths, eligible and not, ragged shapes, a bfloat16 J,
     a tied-energy shape and B = 2; kernel and plain times and the bound,
     the cluster size and block count, K4's time at each cluster size and
     with a bfloat16 J;
  6. production path: anneal(K2000, 100 trials, tau=100, I0 1→32,
     backend='cuda', record='best', track_energy=False) — K1 launched
     m_shot × steps times, K3 and K4 never; best_H == the dense backend's;
     the host set-up time of anneal();
  7. trace path: the same with track_energy=True — K3 launched, K1 and K4
     not; energy traces and best_H == the dense backend's;
  8. threefry pregen path: the production call with noise='threefry' — K4
     launched m_shot × steps times, K1 and K3 never; best_H and best_m ==
     the dense backend's with threefry on the card;
  9. xorshift pregen path: noise_mode='pregen' — K4 only, best_H and best_m
     == the streamed K1 run of phase 6;
 10. memory at K2000, measured and not asserted: the per-plateau state plus
     noise buffer of the pregen (dense layout) and streamed (packed layout)
     datapaths, and the peak device memory of one anneal() call of each;
 11. K2 ``ssa_plateau_popcount`` == its plain version, all five outputs
     exactly, at K2000 width over one Table II iteration (R=100, C=600),
     G11 width, a ragged N with 3 magnitude planes, a tied-energy shape
     with every state folded, I0 and fold changing mid-chain, B = 2, R = 3
     (below one group of 8), N = 4100 with 3 planes (the streamed-plane
     variant), forced cluster sizes 1 (streamed) and 16, N = 70001 in
     clusters of 1 (streamed, near its limit) and N = 120000 (the spin
     words in global memory too; random planes); each line names the
     cluster size, block count and block variant; kernel and plain times
     and the bound; ``[K2 sweep]``: K2's time at each cluster size up to Nw
     (the outputs must not change), and at B = 2 and 4 (26 and 52 groups);
 12. popcount path: anneal(K2000 and G11, field_mode='popcount') — K2
     launched m_shot times (one per iteration's chain), K1, K3 and K4
     never; best_H and best_m == the K1 run with the same seed; no dense J
     held, and at K2000 the call's peak device memory below the f32 J's
     bytes;
 13. K1's SSQA ring mode == its plain version, all five outputs exactly, at
     K2000 width with 96 trials: rings of 8 (C=100, J⊥=4), 2 and 16, B = 2,
     and at cluster sizes 1 and the largest; the cluster size and block
     count of each launch; kernel and plain times at rings of 8 and the
     bound, kernel times at rings of 2 and 16 and at smaller clusters;
 14. K2's SSQA ring mode == its plain version at K2000 width, 96 trials,
     rings of 8, one Table II iteration (C=600) with the ssqa_schedule J⊥
     ramp, rings of 16, B = 2, forced cluster sizes 1 and 16, and N =
     30000 in rings of 32 (spin words in global memory); each line names
     the cluster size, block count and block variant; kernel and plain
     times and the bound, kernel times at rings of 2 and 16; ``[K2 ring
     sweep]``: the time at each cluster size, rings of 8 and 16;
 15. SSQA path: anneal_ssqa(K2000, 96 trials, rings of 8, J⊥max 4, tau=100,
     I0 1→32) on cuda (dense field), cuda (popcount) and the dense backend
     on the card — equal best_H and best_m; K1 launched 10 times classical
     (the J⊥ = 0 plateau) and 50 times in ring mode, K2 10 times in ring
     mode, K4 never; with threefry (m_shot=2) K1 and K2 never, K4 only on
     the J⊥ = 0 plateaus and K3 for the others, equal to the dense backend;
 16. BENCH_ssqa.json reproduced: hp='auto' on the K2000 twin resolves to its
     hyper-parameters, and seeds 0–2 give its cycles_to_target for SSA and
     SSQA (energy traces through K3 on the cuda backend);
 17. torch.profiler over one production and one xorshift-pregen anneal()
     at K2000, measured and not asserted: K1's and K4's share of the
     device time and the device's idle share of the call (``[profile]``);
 18. service (K1, B = 4): AnnealService(backend='cuda', packed layout,
     chunks of 5 shots) solves the G11, G12, G13 and King1 twins (seeds
     0-3: one group of B = 4 at bucket 1024) and the K2000 twin (seed 4:
     B = 1 at bucket 2048) at Table II's widths, m_shot 10 — K1 launched
     2 × 10 × 6 = 120 times, nothing else; every response 'ok', no event,
     equal to anneal() of its unpadded instance; a second solve hits the
     program cache twice and builds nothing; torch.profiler over a third
     (``[profile] service K1 solve()``: the device's idle share, K1's share
     of device time); with noise_mode='pregen' K4 120 times and the same
     results;
 19. service popcount (K2, B = 4): the same batch with field_mode='auto' —
     K2 launched 10 times per group, phase 18's results;
 20. service SSQA (B = 4): the four N = 800 twins at the SSQA cell's widths
     on the dense field (K1: 60, 50 of them in ring mode) and popcount (K2's
     ring mode: 10), each equal to anneal_ssqa of its instance;
 21. service tiled: the G77 twin (14383 → 16384) on the dense backend
     (tiled J, no launch; peak device bytes beside a dense J's 1 GiB) and
     on K2 at N = 16384 (one launch), τ = 10, I0 1→4, one shot — equal to
     each other and to anneal() of the unpadded instance;
 22. service fallback: an injected compile fault on the cuda group of
     bucket 1024 — its four responses 'fallback' with one cuda → dense
     event and phase 18's results, K2000 'ok' on K1 (60 launches);
 23. stream K1: StreamingAnnealService(tables of 4 slots; cuda, packed
     layout, one shot a quantum, driven on this thread with
     run_until_idle()) serves the four twins at seeds 0 and 1 and K2000 at
     seeds 4 and 5, every other one with a target_cut from its own
     one-shot trace at chunk 3 (they retire early, their slots backfill):
     every response 'ok' and equal to AnnealService.solve of the same
     request (best_cut, best_m, best energies, chunk trace); K1 launched
     stream_quanta × 6 times, nothing else; wall s, quanta, backfills,
     occupancy, ms per seat and per splice, peak device bytes; the same
     stream under torch.profiler (``[profile] stream K1``);
 24. the same requests with field_mode='auto' (K2: stream_quanta
     launches), and the four N = 800 twins at the SSQA cell's widths on the
     dense field (K1: quanta × 6, quanta × 5 in ring mode) and popcount
     (K2's ring mode: quanta), each equal to its one-shot solve;
 25. checkpoints: phase 18's batch killed at chunk 1 and resumed by a fresh
     service (its responses, a 'resume' at chunk 2 on the bucket-1024
     group, K1 60 for the K2000 group alone, the directory purged); phase
     23's stream killed after a table's third quantum and resumed lane by
     lane (phase 23's responses); a one-shot solo checkpoint of K2000
     resumed into a stream at chunk 2; save ms and a K2000 lane's bytes;
 26. open-loop traffic (``repro_torch.benchmarks.serve_stream``): 24
     requests over the five twins in bursts of 4 at twice the probed
     capacity, on the stream's background thread with finite result
     timeouts — every streamed trace a bit-exact prefix of its calibration
     trace, K1 = quanta × 6; p50/p99, goodput, occupancy, shed and late
     counts measured;
 27. problem families through anneal() (Table II widths, m_shot 10):
     make_demo's QUBO (2000 spins, 5-bit weights, |h| ~10^3) and partition
     (2000 spins, 13-bit weights) on K1 — 60 launches each —, MIS (2000
     spins, 2 magnitude planes) and coloring (2100 spins, 4 planes) with
     field_mode='popcount' on K2 — 10 launches each; each equal (spins,
     energies, decoded solution) to the dense backend on the card; nb, the
     K2 variant, wall, set-up and peak device bytes printed;
 28. the four encodings through one AnnealService.solve (field_mode='auto':
     QUBO, MIS and partition share bucket 2048 and resolve to K1, coloring
     runs K2 at bucket 4096) and one stream of them — every response's
     solution, objective and feasibility equal to phase 27's run;
 29. SA: anneal_sa on the K2000 twin, 100 trials — the card equal to the
     CPU at 2,000 cycles; Table II's 90,000 cycles on the card (no kernel;
     wall and the host key chain timed); ``[convergence]``: cycles and wall
     for HA-SSA to reach SA's final cut and for SA to reach HA-SSA's
     6000-cycle cut (measured, not gated);
 30. PT (cut 90,000 → 20,000 cycles) and PT-SSA on the dense backend (cut
     60 → 5 rounds) on the K2000 twin, the card equal to the CPU; one
     AnnealService.solve of an SA and a PT-SSA group on the dense backend
     and an SA group on the cuda backend — no kernel launched (K1–K4
     counters unchanged), equal to the CPU solve — and a PT-SSA request
     rejected at admission by the cuda service;
 31. the card line again, the kernels line (each kernel's service launches
     in ``service_launches``, its stream launches in ``stream_launches``,
     its launches per family of phase 27 in ``family_launches``); 32. the
     contract line (last).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA
# cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Dense int8 tensor-core operations (the same data sheet).
PEAK_INT8_OPS = 1979e12
# 32-bit population counts: 16 per SM per clock, and 32-bit integer adds: 64
# (NVIDIA CUDA C++ documentation, arithmetic instruction throughput, compute
# capability 9.0), 132 SMs, 1.98 GHz boost clock.
PEAK_POPC = 16 * 132 * 1.98e9
PEAK_INT32 = 64 * 132 * 1.98e9

M_SHOT_PRODUCTION = 10
M_SHOT_TRACE = 2
# SSQA at K2000: SSQAHyperParams' defaults (96 trials, rings of 8, J⊥max 4).
SSQA_TRIALS, SSQA_RING, SSQA_JPERP_MAX = 96, 8, 4


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_time_ms(fn, calls: int = 100, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph and replayed, so a call of a few microseconds is timed without
    the host's cost of issuing it from Python."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture: builds, attributes, caches
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(graph.replay, reps) / calls


def _bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(out)
    return out


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.time()
    _build.build()
    print(f"[build] {_build.SOURCES} built for sm_90a in {time.time() - t0:.1f}s")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")


def _spins(gen, shape, device):
    return (torch.randint(0, 2, shape, generator=gen) * 2 - 1).to(device)


def _coupling(gen, n, dtype, device):
    J = torch.randint(-1, 2, (n, n), generator=gen)
    J = torch.triu(J, 1)
    return (J + J.T).to(dtype).to(device)


def _mixed_plane_coupling(gen, n, dtype, device):
    """A J whose 64 x 128 tiles need one, two, three and four byte planes in
    K3 (|J| <= 127, < 2^15, < 2^23, any), inside its exactness contract: no
    column's sum of |J| reaches 2^24."""
    J = torch.randint(-1, 2, (n, n), generator=gen)
    two = J[64:128, 128:256]
    two[...] = torch.randint(-4096, 4097, two.shape, generator=gen)
    for c in range(256, min(384, n)):
        J[192 + c % 64, c] = int(torch.randint(-(2**20), 2**20, (1,), generator=gen))
    if n > 500:
        J[300, 500] = 9_000_001
    return J.to(dtype).to(device)


def phase_k3(dev):
    from repro_torch.kernels import ssa_update
    from repro_torch.kernels.ref import local_field_ref

    gen = torch.Generator().manual_seed(3)
    err = 0
    f32, bf16 = torch.float32, torch.bfloat16
    for R, N, dtype, mixed in ((100, 2000, f32, False), (100, 2000, bf16, False),
                               (13, 1000, f32, False), (7, 97, f32, False),
                               (100, 2000, f32, True), (13, 1000, f32, True),
                               (33, 417, f32, True), (130, 600, f32, True)):
        m = _spins(gen, (R, N), dev).to(torch.float32)
        h = torch.randint(-3, 4, (N,), generator=gen, dtype=torch.int32).to(dev)
        J = (_mixed_plane_coupling if mixed else _coupling)(gen, N, dtype, dev)
        got = ssa_update.local_field(m, h, J)
        want = local_field_ref(m, h, J)
        torch.cuda.synchronize()
        e = _max_abs_err(got, want)
        print(f"[K3] R={R} N={N} J={dtype} planes={'1-4 mixed' if mixed else 1}: "
              f"max_abs_err={e}")
        if e:
            _fail(f"K3 local_field differs from its plain version at R={R} N={N} {dtype} "
                  f"mixed={mixed}")
        err = max(err, e)
    # Timing at the main path's shape: R=100 trials, K2000 width, f32 J.
    R, N = 100, 2000
    m = _spins(gen, (R, N), dev).to(torch.float32)
    h = torch.zeros(N, dtype=torch.int32, device=dev)
    J = _coupling(gen, N, torch.float32, dev)
    hf = h.to(torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False  # the library call in full float32
    # The kernels line's times: 50 calls issued from Python back to back,
    # between CUDA events, as the trace path issues K3 once per cycle.
    ms = _time_ms(lambda: ssa_update.local_field(m, h, J), reps=50)
    plain_ms = _time_ms(lambda: local_field_ref(m, h, J), reps=50)
    lib_ms = _time_ms(lambda: torch.addmm(hf, m, J), reps=50)
    # Beside them, device time alone: 100 calls captured in a CUDA graph and
    # replayed, without the host's cost of issuing each call.
    graph = [_graph_time_ms(f) for f in (lambda: ssa_update.local_field(m, h, J),
                                         lambda: local_field_ref(m, h, J),
                                         lambda: torch.addmm(hf, m, J))]
    # One s8 byte plane at K2000 (|J| <= 1): 2·R·N² int8 tensor-core operations.
    n_bytes, n_ops = 4 * (R * N + N * N + N + R * N), 2 * R * N * N
    bound, by = _bound_ms(n_bytes, n_ops, PEAK_INT8_OPS)
    print(f"[K3] R={R} N={N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.addmm (TF32 off) {lib_ms:.4f} ms (issued from Python), bound "
          f"{bound:.4f} ms ({by}; bytes {n_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms, int8 MMA "
          f"{n_ops / PEAK_INT8_OPS * 1e3:.4f} ms)")
    print(f"[K3] R={R} N={N} device time (CUDA graph): kernel {graph[0]:.4f} ms, plain "
          f"{graph[1]:.4f} ms, torch.addmm (TF32 off) {graph[2]:.4f} ms")
    print(f"[K3] no slower than torch.addmm in this run: {ms <= lib_ms} (issued from Python), "
          f"{graph[0] <= graph[2]} (CUDA graph)")
    _k3_sweep(m, h, J)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)


def _k3_sweep(m, h, J):
    """K3 at the main path's shape under each K split (blocks per cluster;
    the output must not change), device time by CUDA graph: a split whose
    clusters do not all fit on the card at once runs in two waves."""
    from repro_torch.kernels import ssa_update

    want = ssa_update.local_field(m, h, J)
    for ks in (1, 2, 4, 6, 7, 8):
        if not torch.equal(ssa_update._local_field(m, h, J, splits=ks), want):
            _fail(f"K3 output depends on the K split ({ks})")
        t = _graph_time_ms(lambda: ssa_update._local_field(m, h, J, splits=ks))
        print(f"[K3 sweep] {ks} K splits: {t:.4f} ms")


def _plateau_inputs(gen, R, N, dev, dtype=torch.float32, flat=False):
    """Random plateau inputs; ``flat`` zeroes J and h so every energy ties
    and only keeping the first minimum matches."""
    from repro_torch.core.rng import xorshift_init
    from repro_torch.kernels.bitplane import pack_spins

    m = _spins(gen, (1, R, N), dev)
    bm = _spins(gen, (1, R, N), dev)
    return dict(
        m_packed=pack_spins(m),
        itanh=torch.randint(-8, 8, (1, R, N), generator=gen, dtype=torch.int32).to(dev),
        J=_coupling(gen, N, dtype, dev)[None] * (not flat),
        h=torch.randint(-2, 3, (1, N), generator=gen, dtype=torch.int32).to(dev) * (not flat),
        rng=xorshift_init(int(torch.randint(0, 2**31, (1,), generator=gen)), (R, N), dev)[None],
        best_H=torch.full((1, R), 2**30, dtype=torch.int32, device=dev),
        best_m_packed=pack_spins(bm),
    )


def phase_k1(dev):
    from repro_torch.kernels import ssa_update
    from repro_torch.kernels.ref import ssa_plateau_packed_ref

    gen = torch.Generator().manual_seed(1)
    names = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")
    err = 0
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(100, 2000, 100, True, f32, False), (100, 2000, 100, False, f32, False),
             (100, 800, 100, True, f32, False), (100, 800, 100, False, f32, False),
             (13, 1001, 17, True, f32, False), (13, 1001, 17, False, f32, False),
             (5, 2000, 9, True, bf16, False), (13, 1001, 17, True, f32, True),
             (3, 2101, 9, True, f32, False), (13, 4100, 3, True, bf16, False)]
    for R, N, C, elig, dtype, flat in cases:
        x = _plateau_inputs(gen, R, N, dev, dtype, flat)
        kw = dict(i0=32 if elig else 4, n_cycles=C, n_rnd=2, eligible=elig)
        got = ssa_update.ssa_plateau_packed_batched(**x, **kw)
        want = ssa_plateau_packed_ref(**x, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            e = _max_abs_err(g, w)
            if e:
                _fail(f"K1 {name} differs from its plain version at "
                      f"R={R} N={N} C={C} eligible={elig} {dtype}")
            err = max(err, e)
        print(f"[K1] R={R} N={N} C={C} eligible={elig} J={dtype} flat={flat}: "
              "all five outputs equal")
    # Timing at the main path's shape: K2000, 100 trials, one tau=100 plateau.
    R, N, C = 100, 2000, 100
    x = _plateau_inputs(gen, R, N, dev)
    kw = dict(i0=32, n_cycles=C, n_rnd=2, eligible=True)
    k1 = ssa_update.ssa_plateau_packed_batched
    ms = _time_ms(lambda: k1(**x, **kw), reps=5)
    launched = k1.last_cluster
    plain_ms = _time_ms(lambda: ssa_plateau_packed_ref(**x, **kw), reps=3)
    nw = (N + 31) // 32
    state_bytes = 4 * (R * nw + R * N + 4 * R * N + R + R * nw)
    bound, by = _bound_ms(4 * N * N + 4 * N + 2 * state_bytes, 2 * R * N * N * (C + 1))
    print(f"[K1] R={R} N={N} C={C}: cluster size {launched[0]} (chosen), {launched[1]} "
          f"blocks: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by})")
    _cluster_sweep("K1", k1, x, kw)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def _cluster_sweep(name, wrapper, x, kw):
    """K1 or K4 (``wrapper``) at the main path's shape forced to each cluster
    size up to the word count (the outputs must not change), and with a
    bfloat16 J at the chosen size: where its time goes.  Timed as the
    kernels line's time is, calls issued from Python between CUDA events."""
    from repro_torch.kernels import ssa_update

    want = wrapper(**x, **kw)
    for cs in ssa_update._word_sizes(x["itanh"].shape[-1]):
        if not all(torch.equal(a, b) for a, b in zip(wrapper(**x, **kw, cluster_size=cs), want)):
            _fail(f"{name} output depends on the cluster size ({cs})")
        t = _time_ms(lambda: wrapper(**x, **kw, cluster_size=cs), reps=5)
        print(f"[{name} sweep] cluster size {cs} (forced), {wrapper.last_cluster[1]} blocks: "
              f"{t:.3f} ms")
    xb = dict(x, J=x["J"].to(torch.bfloat16))
    t = _time_ms(lambda: wrapper(**xb, **kw), reps=5)
    print(f"[{name} sweep] bfloat16 J: cluster size {wrapper.last_cluster[0]} (chosen), "
          f"{wrapper.last_cluster[1]} blocks: {t:.3f} ms")


def phase_threefry(dev):
    """One pregen plateau's threefry draw at K2000 width, timed; its first
    cycles must equal the same draw made on the CPU."""
    from repro_torch.core.rng import threefry_key, threefry_noise_cycles

    C, T, N = 100, 100, 2000
    key = threefry_key(2000)
    _, noise = threefry_noise_cycles(key, C, (T, N), dev)
    _, cpu = threefry_noise_cycles(key, 3, (T, N), "cpu")
    torch.cuda.synchronize()
    if not torch.equal(noise[:3].cpu(), cpu):
        _fail("threefry draw on the card differs from the CPU draw")
    plus = (noise == 1).float().mean().item()
    if tuple(noise.shape) != (C, T, N) or not 0.49 < plus < 0.51:
        _fail(f"threefry draw malformed: shape {tuple(noise.shape)}, share of +1 {plus}")
    ms = _time_ms(lambda: threefry_noise_cycles(key, C, (T, N), dev), reps=5)
    print(f"[threefry] (C, T, N)=({C}, {T}, {N}) pregen draw: {ms:.3f} ms "
          f"({C * T * N / ms / 1e6:.3f} G draws/s); share of +1 {plus:.5f}; "
          "first 3 cycles == CPU draw")
    return ms


def _pregen_inputs(gen, B, R, N, C, dev, dtype=torch.float32, flat=False):
    """Random K4 inputs; ``flat`` zeroes J and h (every energy ties)."""
    return dict(
        m=_spins(gen, (B, R, N), dev).to(torch.float32),
        itanh=torch.randint(-8, 8, (B, R, N), generator=gen, dtype=torch.int32).to(dev),
        J=torch.stack([_coupling(gen, N, dtype, dev) for _ in range(B)]) * (not flat),
        h=torch.randint(-2, 3, (B, N), generator=gen, dtype=torch.int32).to(dev) * (not flat),
        noise=_spins(gen, (B, C, R, N), dev).to(torch.int8),
        best_H=torch.full((B, R), 2**30, dtype=torch.int32, device=dev),
        best_m=_spins(gen, (B, R, N), dev).to(torch.int8),
    )


def phase_k4(dev):
    from repro_torch.kernels import ssa_update
    from repro_torch.kernels.ref import ssa_plateau_ref

    gen = torch.Generator().manual_seed(4)
    names = ("m", "itanh", "best_H", "best_m")
    err = 0
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(1, 100, 2000, 100, True, f32, False), (1, 100, 2000, 100, False, f32, False),
             (1, 100, 800, 100, True, f32, False), (1, 100, 800, 100, False, f32, False),
             (1, 13, 1001, 17, True, f32, False), (1, 13, 1001, 17, False, f32, False),
             (1, 5, 2000, 9, True, bf16, False), (1, 13, 1001, 17, True, f32, True),
             (2, 7, 1001, 9, True, f32, False), (1, 3, 2101, 9, True, f32, False),
             (1, 13, 4100, 3, True, bf16, False), (1, 100, 2000, 0, True, f32, False)]
    for B, R, N, C, elig, dtype, flat in cases:
        x = _pregen_inputs(gen, B, R, N, C, dev, dtype, flat)
        kw = dict(i0=32 if elig else 4, n_rnd=2, eligible=elig)
        got = ssa_update.ssa_plateau_batched(**x, **kw)
        want = ssa_plateau_ref(**x, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            e = _max_abs_err(g, w)
            if e or g.dtype != w.dtype:
                _fail(f"K4 {name} differs from its plain version at "
                      f"B={B} R={R} N={N} C={C} eligible={elig} {dtype} flat={flat}")
            err = max(err, e)
        print(f"[K4] B={B} R={R} N={N} C={C} eligible={elig} J={dtype} flat={flat}: "
              "all four outputs equal")
    # Timing at the main path's shape: K2000, 100 trials, one tau=100 plateau.
    R, N, C = 100, 2000, 100
    x = _pregen_inputs(gen, 1, R, N, C, dev)
    kw = dict(i0=32, n_rnd=2, eligible=True)
    k4 = ssa_update.ssa_plateau_batched
    ms = _time_ms(lambda: k4(**x, **kw), reps=5)
    launched = k4.last_cluster
    plain_ms = _time_ms(lambda: ssa_plateau_ref(**x, **kw), reps=3)
    state_bytes = 4 * R * N + 4 * R * N + 4 * R + R * N  # m, itanh, best_H, best_m
    bound, by = _bound_ms(4 * N * N + 4 * N + 2 * state_bytes + C * R * N,
                          2 * R * N * N * (C + 1))
    print(f"[K4] R={R} N={N} C={C}: cluster size {launched[0]} (chosen), {launched[1]} "
          f"blocks: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by})")
    _cluster_sweep("K4", k4, x, kw)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def _reset_counts():
    from repro_torch.kernels import ssa_update

    ssa_update.local_field.launches = 0
    ssa_update.ssa_plateau_packed_batched.launches = 0
    ssa_update.ssa_plateau_packed_batched.ring_launches = 0
    ssa_update.ssa_plateau_batched.launches = 0
    ssa_update.ssa_plateau_popcount_batched.launches = 0
    ssa_update.ssa_plateau_popcount_batched.ring_launches = 0


def _counts():
    """Launches of (K1, K3, K4, K2, K1 in ring mode, K2 in ring mode) since
    the last reset; the K1 and K2 counts include their ring-mode launches."""
    from repro_torch.kernels import ssa_update

    return (ssa_update.ssa_plateau_packed_batched.launches,
            ssa_update.local_field.launches,
            ssa_update.ssa_plateau_batched.launches,
            ssa_update.ssa_plateau_popcount_batched.launches,
            ssa_update.ssa_plateau_packed_batched.ring_launches,
            ssa_update.ssa_plateau_popcount_batched.ring_launches)


def _anneal_run(problem, hp, cfg, track_energy, dense_ref=True):
    """The cuda run (timed, counted, its peak device memory measured) and,
    with ``dense_ref``, the dense-backend run with the same noise on the
    card, which it must equal.  Returns (result, wall s, launches, peak
    device bytes, the backend the timed call built, host set-up s)."""
    import numpy as np

    from repro_torch.core import ssa
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.engine import make_backend, normalize_problem
    from repro_torch.core.ssa import anneal

    kw = dict(seed=0, record="best", track_energy=track_energy, device="cuda")
    anneal(problem, dataclasses.replace(hp, m_shot=1), config=cfg, **kw)  # warm-up
    t0 = time.time()
    _, model = normalize_problem(problem)
    make_backend(config=cfg, model=model, n_trials=hp.n_trials, device="cuda",
                 n_replicas=getattr(hp, "n_replicas", 0)).init_state(0)
    torch.cuda.synchronize()
    setup = time.time() - t0
    print(f"[set-up] model, couplings and noise state of anneal(): {setup:.3f}s")
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    built = []

    def recording(*a, **k):
        built.append(make_backend(*a, **k))
        return built[-1]

    ssa.make_backend = recording
    _reset_counts()
    t0 = time.time()
    try:
        r = anneal(problem, hp, config=cfg, **kw)
        torch.cuda.synchronize()
    finally:
        ssa.make_backend = make_backend
    wall = time.time() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() - live
    if dense_ref:
        ref = anneal(problem, hp, config=SolverConfig(backend="dense", noise=cfg.noise), **kw)
        if not np.array_equal(r.best_energy, ref.best_energy):
            _fail(f"anneal best_H differs between cuda and dense backends ({cfg})")
        if not np.array_equal(r.best_m, ref.best_m):
            _fail(f"anneal best_m differs between cuda and dense backends ({cfg})")
        if track_energy and not (np.array_equal(r.energy_min, ref.energy_min)
                                 and np.array_equal(r.energy_mean, ref.energy_mean)):
            _fail("anneal energy traces differ between the cuda and dense backends")
    return r, wall, counts, peak, built[0], setup


def phase_anneal(path: str, streamed=None):
    """One main path of anneal() at K2000 width; returns (result, launches
    of (K1, K3, K4, K2), peak device bytes of the call, wall s)."""
    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.ssa import SSAHyperParams

    p = gset.load("K2000")
    track_energy = path == "trace"
    m_shot = M_SHOT_TRACE if track_energy else M_SHOT_PRODUCTION
    hp = SSAHyperParams(n_trials=100, m_shot=m_shot, tau=100, i0_min=1, i0_max=32)
    cfg = {
        "production": SolverConfig(backend="cuda", noise="xorshift"),
        "trace": SolverConfig(backend="cuda", noise="xorshift"),
        "threefry-pregen": SolverConfig(backend="cuda", noise="threefry"),
        "xorshift-pregen": SolverConfig(backend="cuda", noise="xorshift",
                                        noise_mode="pregen"),
    }[path]
    r, wall, (k1, k3, k4, k2, k1_ring, k2_ring), peak, _, _ = _anneal_run(
        p, hp, cfg, track_energy, dense_ref=streamed is None)
    rate = hp.total_cycles * hp.n_trials * p.n / wall
    print(f"[{path}] {p.name} N={p.n} trials={hp.n_trials} m_shot={m_shot} "
          f"steps={hp.steps} tau={hp.tau}: best cut {r.overall_best_cut}, "
          f"wall {wall:.3f}s, {rate:.4e} spin-cycles/s; "
          f"K1 launches {k1}, K3 launches {k3}, K4 launches {k4}, K2 launches {k2}; "
          f"peak device memory of the call {peak} B")
    if not (np.all(np.isfinite(r.best_cut)) and r.best_m.shape == (hp.n_trials, p.n)
            and set(np.unique(r.best_m)) <= {-1, 1}):
        _fail("anneal returned malformed results")
    cut = p.cut_value(r.best_m)
    if not np.array_equal(cut, r.best_cut):
        _fail("best_cut does not match the cut of best_m")
    plateaus = hp.m_shot * hp.steps
    if k2 or k1_ring or k2_ring:
        _fail(f"{path} path launched K2 {k2} times, ring modes of K1/K2 {k1_ring}/{k2_ring}")
    if path == "trace":
        if k3 == 0 or k1 != 0 or k4 != 0:
            _fail(f"trace path: expected K3 > 0, K1 == K4 == 0, got {k1, k3, k4}")
        if r.energy_min.shape != (hp.total_cycles,):
            _fail("energy trace has the wrong length")
    elif path == "production":
        if (k1, k3, k4) != (plateaus, 0, 0):
            _fail(f"production path: expected (K1, K3, K4) == ({plateaus}, 0, 0), "
                  f"got {k1, k3, k4}")
    elif (k1, k3, k4) != (0, 0, plateaus):
        _fail(f"{path} path: expected (K1, K3, K4) == (0, 0, {plateaus}), got {k1, k3, k4}")
    if streamed is not None and not (np.array_equal(r.best_energy, streamed.best_energy)
                                     and np.array_equal(r.best_m, streamed.best_m)):
        _fail("xorshift pregen (K4) differs from the streamed K1 run")
    return r, (k1, k3, k4, k2), peak, wall


def phase_memory():
    """Per-plateau state plus noise buffer of each datapath at K2000, the
    way benchmarks/timing.py reckons them: the pregen baseline in the dense
    layout with its (C, T, N) int8 buffer, the streamed kernel in the
    packed layout with none."""
    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.engine import make_backend
    from repro_torch.core.memory import tree_device_bytes

    model = gset.load("K2000").to_ising()
    T, tau = 100, 100
    out = {}
    for mode, layout in (("pregen", "dense"), ("streamed", "packed")):
        cfg = SolverConfig(backend="cuda", noise="xorshift", noise_mode=mode,
                           storage_layout=layout)
        bk = make_backend(config=cfg, model=model, n_trials=T, device="cuda")
        state = bk.init_state(0)
        state_bytes = tree_device_bytes(state)
        noise_bytes = 0
        if mode == "pregen":
            _, noise = bk._pregen_noise(bk.init_state(0).noise_state, tau)
            noise_bytes = tree_device_bytes(noise)
        out[mode] = state_bytes + noise_bytes
        print(f"[memory] {mode} ({layout} layout): state {state_bytes} B + noise buffer "
              f"{noise_bytes} B = {out[mode]} B ({out[mode] / (T * model.n):.3f} B per "
              "(trial, spin))")
    print(f"[memory] pregen / streamed: {out['pregen'] / out['streamed']:.4f}x")
    return out


def _random_planes(rs, B, N, dev):
    """Bitplanes of B couplings too wide for a dense J on the host: a random
    sign plane and one magnitude plane (about one coupling in 16), drawn on
    the card from a seed of ``rs``, tail bits 0, and base = -Σ_j |J_ij|, so
    the field is h + m·J of J_ij = ±mags_ij.  J is not symmetric, but its
    couplings come in pairs of neighbouring columns, so every row's Σ_j
    |J_ij| is even and the energy stays an integer, as a symmetric J's."""
    from repro_torch.kernels.bitplane import PackedJ, packed_words, popcount_u32

    nw = packed_words(N)
    gen = torch.Generator(device=dev).manual_seed(int(rs.integers(2**31)))
    mask = torch.full((nw,), -1, dtype=torch.int32, device=dev)
    if N % 32:
        mask[-1] = (1 << (N % 32 & ~1)) - 1  # whole pairs of columns only

    def words():
        return torch.randint(-2**31, 2**31, (B, N, nw), generator=gen, dtype=torch.int32,
                             device=dev)

    sign = words() & mask
    pairs = words() & words() & words() & words() & 0x55555555 & mask
    mags = (pairs | pairs << 1)[:, None]
    base = -popcount_u32(mags[:, 0]).sum(-1, dtype=torch.int32)
    return PackedJ(sign, mags, base)


def _popcount_inputs(rs, B, R, N, w_max, C, dev, sched="hassa", flat=False):
    """Random K2 inputs from a numpy generator: B symmetric couplings in
    [-w_max, w_max] packed to one plane count (``w_max`` 0: the random
    planes of :func:`_random_planes`, for widths no dense J fits), their
    planes in K2's layout as the cuda backend holds them; ``flat`` zeroes J
    and h (every energy ties); ``sched`` 'hassa' tiles the Table II chain
    (I0 1→32, τ = 100) to C cycles, 'random' draws I0 and fold per cycle,
    'all' folds every state."""
    import numpy as np

    from repro_torch.core.engine import plateau_cycle_schedules, schedule_plateaus, tile_plateaus
    from repro_torch.core.rng import xorshift_init
    from repro_torch.core.ssa import SSAHyperParams
    from repro_torch.kernels.bitplane import PackedJ, pack_couplings, pack_spins
    from repro_torch.kernels.ssa_update import popcount_planes

    nb = max(1, w_max.bit_length())
    pjs = []
    for _ in range(B if w_max else 0):
        J = np.triu(rs.integers(-w_max, w_max + 1, (N, N)), 1) * (not flat)
        pjs.append(pack_couplings(J + J.T, nb, device=dev))
    planes = PackedJ(*(torch.stack(a) for a in zip(*pjs))) if w_max else _random_planes(
        rs, B, N, dev)
    if sched == "hassa":
        plateaus = schedule_plateaus(SSAHyperParams(tau=100, i0_min=1, i0_max=32).schedule())
        i0, fold, _ = plateau_cycle_schedules(tile_plateaus(plateaus, C))
    else:
        i0 = rs.integers(1, 33, C).astype(np.int32)
        fold = (rs.integers(0, 2, C + 1) if sched == "random"
                else np.ones(C + 1, np.int64)).astype(np.int32)
    spins = torch.from_numpy(rs.choice([-1, 1], (2, B, R, N)).astype(np.int8)).to(dev)
    i32 = functools.partial(torch.tensor, dtype=torch.int32, device=dev)
    sign, mags, base = popcount_planes(planes)
    return dict(
        m_packed=pack_spins(spins[0]),
        itanh=i32(rs.integers(-8, 8, (B, R, N))),
        sign=sign,
        mags=mags,
        base=base,
        h=i32(rs.integers(-2, 3, (B, N)) * (not flat)),
        rng=torch.stack([xorshift_init(int(rs.integers(2**31)), (R, N), dev)
                         for _ in range(B)]),
        i0_sched=i32(i0),
        fold_sched=i32(fold),
        best_H=torch.full((B, R), 2**30, dtype=torch.int32, device=dev),
        best_m_packed=pack_spins(spins[1]),
    )


def _k2_launch(k2, forced=None) -> str:
    """The cluster size, block count and block variant of K2's last launch,
    as the phase 11 and 14 lines print them: planes resident, streamed, or
    streamed with the spin words in global memory."""
    cs, blocks, variant = k2.last_cluster
    what = {"resident": "planes resident", "streamed": "planes streamed",
            "global": "planes and spin words in global memory"}[variant]
    return f"cluster size {cs} ({'forced' if forced else 'chosen'}), {blocks} blocks, {what}"


def _k2_check(k2, ref, x, kw, what, cs=None) -> int:
    """K2 (either mode) at cluster size ``cs`` (None: the wrapper's choice)
    against its plain version on the same inputs; the largest error (0)."""
    names = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")
    want = ref(**x, **kw)
    got = k2(**x, **kw, cluster_size=cs)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(names, got, want):
        e = _max_abs_err(g, w)
        if e or g.dtype != w.dtype or g.shape != w.shape:
            _fail(f"{what}: {name} differs from its plain version ({_k2_launch(k2, cs)})")
        err = max(err, e)
    return err


def _k2_sweep(name, k2, x, kw):
    """K2 (either mode) at the main path's shape forced to each cluster size
    up to the word count: the outputs must not change.  Timed as the
    kernels line's time is, calls issued from Python between CUDA events."""
    from repro_torch.kernels import ssa_update

    want = k2(**x, **kw)
    print(f"[{name} sweep] the rule's choice: {_k2_launch(k2)}")
    for cs in ssa_update._word_sizes(x["itanh"].shape[-1]):
        if not all(torch.equal(a, b) for a, b in zip(k2(**x, **kw, cluster_size=cs), want)):
            _fail(f"{name} output depends on the cluster size ({cs})")
        t = _time_ms(lambda: k2(**x, **kw, cluster_size=cs), reps=3)
        print(f"[{name} sweep] {_k2_launch(k2, cs)}: {t:.4f} ms")


def phase_k2(dev):
    import numpy as np

    from repro_torch.kernels import ssa_update
    from repro_torch.kernels.ref import ssa_plateau_popcount_ref

    k2 = ssa_update.ssa_plateau_popcount_batched
    rs = np.random.default_rng(2)
    err = 0
    cs_max = ssa_update.CLUSTER_SIZES[-1]
    cases = [(1, 100, 2000, 1, 600, "hassa", False, None),
             (1, 100, 800, 1, 600, "hassa", False, None),
             (1, 13, 37, 7, 50, "random", False, None), (1, 13, 1001, 1, 17, "all", True, None),
             (1, 7, 800, 1, 40, "random", False, None), (2, 7, 1001, 3, 9, "random", False, None),
             (1, 3, 2000, 1, 30, "random", False, None), (1, 13, 4100, 7, 5, "random", False, None),
             (1, 100, 2000, 1, 60, "random", False, 1),
             (1, 100, 2000, 1, 60, "random", False, cs_max),
             (1, 2, 120000, 0, 3, "random", False, None),
             (1, 3, 70001, 0, 2, "all", False, 1)]
    for B, R, N, w_max, C, sched, flat, cs in cases:
        x = _popcount_inputs(rs, B, R, N, w_max, C, dev, sched, flat)
        what = f"K2 at B={B} R={R} N={N} w_max={w_max} C={C} sched={sched} flat={flat}"
        # The planes in K2's layout (the backend's), then as packed (the
        # wrapper lays them out for the launch).
        err = max(err, _k2_check(k2, ssa_plateau_popcount_ref, x, dict(n_rnd=2),
                                 what + " planes laid out", cs))
        launched = _k2_launch(k2, cs)
        x.update(sign=x["sign"].contiguous(), mags=x["mags"].contiguous())
        err = max(err, _k2_check(k2, ssa_plateau_popcount_ref, x, dict(n_rnd=2),
                                 what + " planes packed", cs))
        print(f"[K2] B={B} R={R} N={N} nb={x['mags'].shape[1]} C={C} sched={sched} "
              f"flat={flat}: {launched}: all five outputs equal, planes laid out and packed")
    # Timing at the main path's shape: K2000, 100 trials, one Table II
    # iteration (6 plateaus of tau = 100) per launch, planes laid out as the
    # backend holds them.
    R, N, C = 100, 2000, 600
    x = _popcount_inputs(rs, 1, R, N, 1, C, dev)
    run = functools.partial(k2, **x, n_rnd=2)
    ms = _time_ms(run, reps=10)
    launched = _k2_launch(k2)
    plain_ms = _time_ms(lambda: ssa_plateau_popcount_ref(**x, n_rnd=2), reps=2)
    nb, nw = x["mags"].shape[1], x["sign"].shape[-1]
    fields = C + int(x["fold_sched"][-1].item() > 0)  # the epilogue field only when folded
    state_bytes = 4 * (R * nw + R * N + 4 * R * N + R + R * nw)
    n_bytes = 4 * (1 + nb) * N * nw + 8 * N + 4 * (2 * C + 1) + 2 * state_bytes
    bound, by = _bound_ms(n_bytes, R * N * nw * nb * fields, PEAK_POPC)
    print(f"[K2] R={R} N={N} nb={nb} C={C}: {launched}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}; {R * N * nw * nb * fields:.4e} "
          "popcounts)")
    fits = {}
    for cs in ssa_update.CLUSTER_SIZES:
        v = ssa_update.popcount_variant(lambda v: ssa_update._popcount_smem(N, nb, 0, cs, v))
        fits[f"{cs} ({v})"] = ssa_update._max_clusters(
            dev, "popcount", "repro_popcount_max_clusters", N, 0, nb, cs,
            ssa_update.POPCOUNT_VARIANTS.index(v))
    print(f"[K2] N={N}: clusters the card runs at once, by size: {fits}")
    _k2_sweep("K2", k2, x, dict(n_rnd=2))
    # B problems' groups together: the rule's choice against every size.
    for B in (2, 4):
        _k2_sweep(f"K2 B={B}", k2, _popcount_inputs(rs, B, R, N, 1, C, dev), dict(n_rnd=2))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def phase_popcount_anneal(name: str, k1_run=None, peak_below_j=False) -> int:
    """anneal(field_mode='popcount') on a G-set twin at the paper's
    configuration: K2 once per iteration and nothing else, the K1 run's
    answer, and no dense J (no float tensor of N² elements) held by the
    backend the call built.  With ``peak_below_j`` the call's peak device
    memory must also stay below the bytes of the f32 J.  That holds at
    K2000 (16 MB J against ~12 MB), not at G11: there the noise lanes' input
    and output copies (2 × 1.28 MB for 100 trials) alone reach the 2.56 MB
    J.  Returns K2's launches."""
    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.memory import tree_device_bytes
    from repro_torch.core.ssa import SSAHyperParams, anneal

    p = gset.load(name)
    hp = SSAHyperParams(n_trials=100, m_shot=M_SHOT_PRODUCTION, tau=100, i0_min=1, i0_max=32)
    cfg = SolverConfig(backend="cuda", field_mode="popcount", noise="xorshift")
    r, wall, counts, peak, bk, _ = _anneal_run(p, hp, cfg, track_energy=False,
                                               dense_ref=False)
    rate = hp.total_cycles * hp.n_trials * p.n / wall
    pj_bytes = tree_device_bytes(bk.packed_j)
    j_bytes = 4 * p.n * p.n
    print(f"[popcount] {p.name} N={p.n} trials={hp.n_trials} m_shot={hp.m_shot} "
          f"steps={hp.steps} tau={hp.tau}: best cut {r.overall_best_cut}, wall {wall:.3f}s, "
          f"{rate:.4e} spin-cycles/s; (K1, K3, K4, K2, K1 ring, K2 ring) launches {counts}; "
          f"peak device memory of the call {peak} B; packed couplings {pj_bytes} B "
          f"(f32 J would be {j_bytes} B)")
    if counts != (0, 0, 0, hp.m_shot, 0, 0):
        _fail(f"popcount path: expected (K1, K3, K4, K2, K1 ring, K2 ring) == "
              f"(0, 0, 0, {hp.m_shot}, 0, 0), got {counts}")
    dense = [k for k, v in vars(bk).items() if torch.is_tensor(v) and v.is_floating_point()
             and v.numel() >= p.n * p.n]
    if hasattr(bk, "J") or dense or (peak_below_j and peak >= j_bytes):
        _fail(f"popcount path holds a dense J (peak {peak} B, f32 J {j_bytes} B)")
    if k1_run is None:
        k1_run = anneal(p, hp, config=SolverConfig(backend="cuda", noise="xorshift"), seed=0,
                        record="best", track_energy=False, device="cuda")
    if not (np.array_equal(r.best_energy, k1_run.best_energy)
            and np.array_equal(r.best_m, k1_run.best_m)):
        _fail(f"popcount anneal() on {p.name} differs from the K1 run with the same seed")
    if not np.array_equal(p.cut_value(r.best_m), r.best_cut):
        _fail("best_cut does not match the cut of best_m")
    return counts[3]


def phase_k1_ring(dev):
    """K1's SSQA ring mode against its plain version at K2000 width, at the
    cluster size the wrapper chooses and forced to 1 and to the largest."""
    from repro_torch.kernels import ssa_update
    from repro_torch.kernels.ref import ssa_plateau_packed_ref

    k1 = ssa_update.ssa_plateau_packed_batched
    gen = torch.Generator().manual_seed(5)
    names = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")
    err = 0
    cs_max = ssa_update.CLUSTER_SIZES[-1]
    cases = [(1, SSQA_TRIALS, 2000, 100, SSQA_RING, True, None),
             (1, SSQA_TRIALS, 2000, 100, SSQA_RING, False, None),
             (1, SSQA_TRIALS, 2000, 20, SSQA_RING, True, 1),
             (1, SSQA_TRIALS, 2000, 20, SSQA_RING, True, cs_max),
             (1, SSQA_TRIALS, 2000, 20, 2, True, None), (1, SSQA_TRIALS, 2000, 20, 16, True, None),
             (2, 32, 1001, 9, 16, True, 1), (2, 32, 1001, 9, 16, True, cs_max),
             (2, 12, 1001, 9, 4, True, None)]
    for B, R, N, C, nr, elig, cs in cases:
        x = _plateau_inputs(gen, R, N, dev)
        if B > 1:
            y = _plateau_inputs(gen, R, N, dev)
            x = {k: torch.cat([x[k], y[k]]) for k in x}
        kw = dict(i0=32, n_cycles=C, n_rnd=2, eligible=elig, jperp=SSQA_JPERP_MAX,
                  n_replicas=nr)
        got = k1(**x, **kw, cluster_size=cs)
        want = ssa_plateau_packed_ref(**x, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            e = _max_abs_err(g, w)
            if e:
                _fail(f"K1 ring mode {name} differs from its plain version at "
                      f"B={B} R={R} N={N} C={C} ring={nr} eligible={elig} cluster={cs}")
            err = max(err, e)
        launched_cs, ctas = k1.last_cluster
        print(f"[K1 ring] B={B} R={R} N={N} C={C} ring={nr} J⊥={SSQA_JPERP_MAX} "
              f"eligible={elig} cluster size {launched_cs} ({'forced' if cs else 'chosen'}), "
              f"{ctas} blocks: all five outputs equal")
    # Timing at the SSQA path's shape: K2000, 96 trials in rings of 8, tau=100.
    R, N, C = SSQA_TRIALS, 2000, 100
    x = _plateau_inputs(gen, R, N, dev)
    kw = dict(i0=32, n_cycles=C, n_rnd=2, eligible=True, jperp=SSQA_JPERP_MAX,
              n_replicas=SSQA_RING)
    ms = _time_ms(lambda: k1(**x, **kw), reps=5)
    launched = k1.last_cluster
    plain_ms = _time_ms(lambda: ssa_plateau_packed_ref(**x, **kw), reps=3)
    nw = (N + 31) // 32
    state_bytes = 4 * (R * nw + R * N + 4 * R * N + R + R * nw)
    n_ops = 2 * R * N * N * (C + 1) + 2 * R * N * C  # the field, and the coupling's adds
    bound, by = _bound_ms(4 * N * N + 4 * N + 2 * state_bytes, n_ops)
    print(f"[K1 ring] R={R} N={N} C={C} ring={SSQA_RING}: cluster size {launched[0]}, "
          f"{launched[1]} blocks: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound:.4f} ms ({by})")
    fits = {cs: ssa_update._max_clusters(dev, "plateau", "repro_plateau_max_clusters",
                                         N, SSQA_RING, cs, 0)
            for cs in ssa_update.CLUSTER_SIZES}
    print(f"[K1 ring] N={N} ring={SSQA_RING}: clusters the card runs at once, by size: {fits}")
    # Other ring sizes and cluster sizes on the same inputs, and a bfloat16 J
    # (half the bytes streamed from L2).
    for nr, cs, dtype in ((2, None, "f32"), (16, None, "f32"), (SSQA_RING, 1, "f32"),
                          (SSQA_RING, 4, "f32"), (SSQA_RING, None, "bf16")):
        xd = dict(x, J=x["J"].to(torch.bfloat16)) if dtype == "bf16" else x
        kw_nr = dict(kw, n_replicas=nr)
        t = _time_ms(lambda: k1(**xd, **kw_nr, cluster_size=cs), reps=3)
        print(f"[K1 ring] R={R} N={N} C={C} ring={nr} J={dtype}: cluster size "
              f"{k1.last_cluster[0]} ({'forced' if cs else 'chosen'}), "
              f"{k1.last_cluster[1]} blocks: kernel {t:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def _ssqa_chain(C, tau=100):
    """(i0, fold, jperp) of the SSQA schedule (I0 1→32, J⊥ 0→4) tiled to C
    cycles."""
    from repro_torch.core.engine import plateau_cycle_schedules, schedule_plateaus, tile_plateaus
    from repro_torch.core.ssqa import SSQAHyperParams

    hp = SSQAHyperParams(n_trials=SSQA_TRIALS, n_replicas=SSQA_RING, tau=tau,
                         jperp_max=SSQA_JPERP_MAX)
    return plateau_cycle_schedules(tile_plateaus(schedule_plateaus(hp.schedule()), C))


def phase_k2_ring(dev):
    """K2's SSQA ring mode against its plain version at K2000 width, at the
    cluster size the wrapper chooses and forced to 1 and to the largest."""
    import numpy as np

    from repro_torch.kernels import ssa_update
    from repro_torch.kernels.ref import ssa_plateau_popcount_ref

    k2 = ssa_update.ssa_plateau_popcount_batched
    rs = np.random.default_rng(6)
    err = 0
    cs_max = ssa_update.CLUSTER_SIZES[-1]
    for B, R, N, w_max, C, tau, nr, cs in (
            (1, SSQA_TRIALS, 2000, 1, 600, 100, SSQA_RING, None), (2, 16, 1001, 3, 60, 10, 8, None),
            (1, SSQA_TRIALS, 2000, 1, 60, 10, 16, None), (1, 32, 2000, 1, 30, 10, 32, None),
            (1, SSQA_TRIALS, 2000, 1, 60, 10, SSQA_RING, 1),
            (1, SSQA_TRIALS, 2000, 1, 60, 10, SSQA_RING, cs_max),
            (1, 16, 2000, 1, 60, 10, 16, 1), (1, 16, 2000, 1, 60, 10, 16, cs_max),
            (1, 32, 30000, 0, 3, 1, 32, None)):
        x = _popcount_inputs(rs, B, R, N, w_max, C, dev)
        i0, fold, jperp = _ssqa_chain(C, tau)
        x.update(i0_sched=torch.tensor(i0, device=dev), fold_sched=torch.tensor(fold, device=dev))
        kw = dict(n_rnd=2, jperp_sched=torch.tensor(jperp, device=dev), n_replicas=nr)
        err = max(err, _k2_check(k2, ssa_plateau_popcount_ref, x, kw,
                                 f"K2 ring mode at B={B} R={R} N={N} w_max={w_max} C={C} "
                                 f"ring={nr}", cs))
        print(f"[K2 ring] B={B} R={R} N={N} nb={x['mags'].shape[1]} C={C} ring={nr} "
              f"J⊥ ramp {jperp.min()}→{jperp.max()}: {_k2_launch(k2, cs)}: all five outputs "
              "equal")
    # Timing at the SSQA path's shape: K2000, 96 trials in rings of 8, one
    # Table II iteration per launch.
    R, N, C = SSQA_TRIALS, 2000, 600
    x = _popcount_inputs(rs, 1, R, N, 1, C, dev)
    i0, fold, jperp = _ssqa_chain(C)
    x.update(i0_sched=torch.tensor(i0, device=dev), fold_sched=torch.tensor(fold, device=dev))
    kw = dict(n_rnd=2, jperp_sched=torch.tensor(jperp, device=dev), n_replicas=SSQA_RING)
    ms = _time_ms(lambda: k2(**x, **kw), reps=5)
    launched = _k2_launch(k2)
    plain_ms = _time_ms(lambda: ssa_plateau_popcount_ref(**x, **kw), reps=1)
    nb, nw = x["mags"].shape[1], x["sign"].shape[-1]
    fields = C + int(fold[-1] > 0)
    state_bytes = 4 * (R * nw + R * N + 4 * R * N + R + R * nw)
    n_bytes = 4 * (1 + nb) * N * nw + 8 * N + 4 * (3 * C + 1) + 2 * state_bytes
    popc, adds = R * N * nw * nb * fields, 2 * R * N * C
    t_ops = (popc / PEAK_POPC + adds / PEAK_INT32) * 1e3
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"[K2 ring] R={R} N={N} nb={nb} C={C} ring={SSQA_RING}: {launched}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}; {popc:.4e} "
          f"popcounts, {adds:.4e} coupling adds)")
    for nr in (2, 16):
        kw_nr = dict(kw, n_replicas=nr)
        t = _time_ms(lambda: k2(**x, **kw_nr), reps=3)
        print(f"[K2 ring] R={R} N={N} nb={nb} C={C} ring={nr}: {_k2_launch(k2)}: kernel "
              f"{t:.4f} ms")
    for nr in (SSQA_RING, 16):
        _k2_sweep(f"K2 ring {nr}", k2, x, dict(kw, n_replicas=nr))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def phase_ssqa_anneal():
    """anneal_ssqa on K2000 at SSQAHyperParams' widths: the cuda backend with
    the dense field (K1: classical on the J⊥ = 0 plateau, ring mode on the
    rest) and with popcount (K2 in ring mode, one chain per iteration), both
    equal to the dense backend on the card; then threefry, whose coupled
    plateaus take the cycle loop over K3.  Returns the launches of K1 and K2
    in ring mode of the two main runs."""
    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.engine import schedule_plateaus
    from repro_torch.core.ssqa import SSQAHyperParams

    p = gset.load("K2000")
    hp = SSQAHyperParams(n_trials=SSQA_TRIALS, n_replicas=SSQA_RING, jperp_max=SSQA_JPERP_MAX,
                         m_shot=M_SHOT_PRODUCTION, tau=100, i0_min=1, i0_max=32)
    coupled = hp.m_shot * sum(1 for pl in schedule_plateaus(hp.schedule()) if pl.jperp)
    results = {}
    for name, cfg, dense_ref in (
            ("dense field", SolverConfig(backend="cuda", noise="xorshift"), True),
            ("popcount", SolverConfig(backend="cuda", noise="xorshift", field_mode="popcount"),
             False)):
        r, wall, counts, peak, _, _ = _anneal_run(p, hp, cfg, track_energy=False,
                                                  dense_ref=dense_ref)
        results[name] = (r, counts)
        rate = hp.total_cycles * hp.n_trials * p.n / wall
        print(f"[ssqa {name}] {p.name} N={p.n} trials={hp.n_trials} ring={hp.n_replicas} "
              f"J⊥max={hp.jperp_max} m_shot={hp.m_shot} steps={hp.steps} tau={hp.tau}: "
              f"best cut {r.overall_best_cut}, wall {wall:.3f}s, {rate:.4e} spin-cycles/s; "
              f"(K1, K3, K4, K2, K1 ring, K2 ring) launches {counts}; "
              f"peak device memory of the call {peak} B")
        if not np.array_equal(p.cut_value(r.best_m), r.best_cut):
            _fail(f"ssqa {name}: best_cut does not match the cut of best_m")
    (rd, cd), (rp, cp) = results["dense field"], results["popcount"]
    plateaus = hp.m_shot * hp.steps
    if cd != (plateaus, 0, 0, 0, coupled, 0):
        _fail(f"ssqa dense field: expected (K1, K3, K4, K2, K1 ring, K2 ring) == "
              f"({plateaus}, 0, 0, 0, {coupled}, 0), got {cd}")
    if cp != (0, 0, 0, hp.m_shot, 0, hp.m_shot):
        _fail(f"ssqa popcount: expected (K1, K3, K4, K2, K1 ring, K2 ring) == "
              f"(0, 0, 0, {hp.m_shot}, 0, {hp.m_shot}), got {cp}")
    if not (np.array_equal(rd.best_energy, rp.best_energy)
            and np.array_equal(rd.best_m, rp.best_m)):
        _fail("ssqa: popcount (K2 ring) differs from the dense field (K1 ring)")
    hp2 = dataclasses.replace(hp, m_shot=M_SHOT_TRACE)
    r, wall, counts, _, _, _ = _anneal_run(p, hp2,
                                           SolverConfig(backend="cuda", noise="threefry"),
                                           track_energy=False)
    print(f"[ssqa threefry] m_shot={hp2.m_shot}: best cut {r.overall_best_cut}, "
          f"wall {wall:.3f}s; (K1, K3, K4, K2, K1 ring, K2 ring) launches {counts}")
    k1, k3, k4, k2, _, _ = counts
    if k1 or k2 or k3 == 0 or k4 != hp2.m_shot:
        _fail(f"ssqa threefry: expected K1 == K2 == 0, K3 > 0 and K4 == {hp2.m_shot} "
              f"(the J⊥ = 0 plateaus), got {counts}")
    return cd[4], cp[5]


def phase_bench_ssqa():
    """BENCH_ssqa.json reproduced: hp='auto' on the K2000 twin resolves to
    the recorded hyper-parameters, and each seed's cycles to the target cut
    (the best-so-far cut per cycle of anneal(track_energy=True), as
    benchmarks/pt_compare.py computes it) equal the recorded ones."""
    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.autotune import resolve_hyperparams
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.ssa import SSAHyperParams, anneal
    from repro_torch.core.ssqa import SSQAHyperParams

    bench = json.loads((Path(__file__).resolve().parent / "BENCH_ssqa.json").read_text())
    p = gset.complete_graph(2000, seed=2000, name="K2000")
    budget = dict(n_trials=16, m_shot=2)
    hps = {"ssa": resolve_hyperparams("auto", p, base=SSAHyperParams(**budget))[0],
           "ssqa": resolve_hyperparams("auto", p, base=SSQAHyperParams(**budget),
                                       algo="ssqa")[0]}
    for algo, hp in hps.items():
        if repr(hp) != bench[algo]["hp"]:
            _fail(f"hp='auto' on K2000 resolves to {hp!r}, BENCH_ssqa.json has "
                  f"{bench[algo]['hp']}")
    cfg = SolverConfig(backend="cuda", noise="xorshift")
    t0 = time.time()
    for row in bench["seeds"]:
        trace = {}
        for algo, hp in hps.items():
            r = anneal(p, hp, seed=row["seed"], config=cfg, track_energy=True, device="cuda")
            trace[algo] = (p.w_total - np.minimum.accumulate(r.energy_min)) // 2
        target = int(bench["target_frac"] * min(int(t[-1]) for t in trace.values()))
        got = {a: (int(t[-1]), int(np.argmax(t >= target)) + 1) for a, t in trace.items()}
        want = {a: (row[a]["final_cut"], row[a]["cycles_to_target"]) for a in trace}
        print(f"[bench_ssqa] seed {row['seed']}: target {target} (recorded "
              f"{row['target_cut']}); (final cut, cycles to target) {got}, recorded {want}")
        if target != row["target_cut"] or got != want:
            _fail(f"BENCH_ssqa.json seed {row['seed']} not reproduced")
    print(f"[bench_ssqa] hp, targets, final cuts and cycles_to_target of all three seeds "
          f"equal BENCH_ssqa.json ({time.time() - t0:.1f}s)")


def _device_busy_us(events) -> float:
    """The union of the intervals of ``events`` (chrome-trace ``ts``/``dur``,
    microseconds): the time the device was busy."""
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def _profile_call(run, what: str, label: str, kernel: str) -> str:
    """One call of ``run`` timed unprofiled, then once under torch.profiler:
    its span on the host, the device's busy time (the union of its kernels,
    copies and fills) and idle share, and ``kernel``'s launches and share
    of the device time.  Measured, not asserted."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(what):
            run()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        trace = Path(d) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    span = [e["dur"] for e in events if e.get("ph") == "X" and e.get("name") == what
            and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not span or not device:
        return f"{what}: not measured (no device activity in the trace)"
    total = sum(e["dur"] for e in device)
    k_us = sum(e["dur"] for e in device if e["cat"] == "kernel" and kernel in e["name"])
    n_k = sum(1 for e in device if e["cat"] == "kernel" and kernel in e["name"])
    busy = _device_busy_us(device)
    return (f"{what}: unprofiled wall {wall * 1e3:.3f} ms; profiled span "
            f"{span[0] / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
            f"{1 - busy / span[0]:.4f}; {label} {n_k} launches, {k_us / 1e3:.3f} ms, "
            f"{k_us / total:.4f} of device time")


def phase_profile():
    """torch.profiler over one production and one xorshift-pregen anneal()
    at K2000 (after the warm-ups of phases 6 and 9), measured and not
    asserted (:func:`_profile_call`); the same call is timed once
    unprofiled just before, so the profiler's own host cost shows beside
    its span."""
    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.ssa import SSAHyperParams, anneal

    p = gset.load("K2000")
    hp = SSAHyperParams(n_trials=100, m_shot=M_SHOT_PRODUCTION, tau=100, i0_min=1, i0_max=32)
    parts = []
    for path, cfg, label, kernel in (
            ("production", SolverConfig(backend="cuda", noise="xorshift"), "K1",
             "plateau_kernel"),
            ("xorshift-pregen", SolverConfig(backend="cuda", noise="xorshift",
                                             noise_mode="pregen"), "K4",
             "plateau_pregen_kernel")):
        run = functools.partial(anneal, p, hp, config=cfg, seed=0, record="best",
                                track_energy=False, device="cuda")
        parts.append(_profile_call(run, f"{path} anneal()", label, kernel))
    print("[profile] " + "; ".join(parts))


# ---------------------------------------------------------------------------
# The one-shot service (AnnealService.solve) at B > 1
# ---------------------------------------------------------------------------
# Table II's widths; only m_shot is cut, to 10.
SERVICE_TWINS = ("G11", "G12", "G13", "King1")


def _service_hp(ssqa=False):
    from repro_torch.core.ssa import SSAHyperParams
    from repro_torch.core.ssqa import SSQAHyperParams

    if ssqa:  # the SSQA cell's widths: 96 trials, rings of 8, J⊥ 0 → 4
        return SSQAHyperParams(n_trials=SSQA_TRIALS, n_replicas=SSQA_RING,
                               jperp_max=SSQA_JPERP_MAX, m_shot=M_SHOT_PRODUCTION, tau=100,
                               i0_min=1, i0_max=32, n_rnd=2)
    return SSAHyperParams(n_trials=100, m_shot=M_SHOT_PRODUCTION, tau=100, i0_min=1,
                          i0_max=32, n_rnd=2)


def _service_solve(svc, reqs, what):
    """One timed, counted solve: (responses, wall s, launches of (K1, K3,
    K4, K2, K1 ring, K2 ring), peak device bytes of the call)."""
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.time()
    resp = svc.solve(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() - live
    print(f"[{what}] {len(reqs)} requests in groups of "
          f"{sorted({(r.bucket, r.batch) for r in resp})} (bucket, B): wall {wall:.3f}s; "
          f"(K1, K3, K4, K2, K1 ring, K2 ring) launches {counts}; peak device memory of the "
          f"call {peak} B; statuses {[r.status for r in resp]}")
    return resp, wall, counts, peak


def _check_service(what, resp, refs, problems, status="ok"):
    """Every response has ``status``, no event unless it is a fallback, a
    well-formed result, and the best energy and spins of its reference."""
    import numpy as np

    for r, ref, p in zip(resp, refs, problems):
        if r.status != status:
            _fail(f"{what}: {p.name} came back {r.status!r} (expected {status!r}); "
                  f"events {[(e.kind, e.detail) for e in r.events]}")
        if status == "ok" and r.events:
            _fail(f"{what}: {p.name} carries events {[e.kind for e in r.events]}")
        res = r.result
        if not (res.best_m.shape == ref.best_m.shape == (r.request.hp.n_trials, p.n)
                and set(np.unique(res.best_m)) <= {-1, 1}
                and np.array_equal(p.cut_value(res.best_m), res.best_cut)):
            _fail(f"{what}: {p.name}: malformed result")
        if not (np.array_equal(res.best_energy, ref.best_energy)
                and np.array_equal(res.best_m, ref.best_m)):
            _fail(f"{what}: {p.name} differs from its single-problem run")


def _expect(what, counts, want):
    if tuple(counts) != tuple(want):
        _fail(f"{what}: expected (K1, K3, K4, K2, K1 ring, K2 ring) launches {want}, "
              f"got {counts}")


def phase_service():
    """Service phases 1 and 1b: the G11, G12, G13 and King1 twins (seeds
    0-3, one group of B = 4 at bucket 1024) and the K2000 twin (seed 4, B =
    1 at bucket 2048) through AnnealService(backend='cuda', packed layout,
    chunks of 5 shots): K1 once per plateau for each group, each response
    equal to anneal() of its unpadded instance on the card; a second solve
    hits the program cache twice and builds nothing.  Then the same batch
    with noise_mode='pregen': K4 once per plateau, the same results.
    Returns (responses, launches of K1 and of K4)."""
    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.ssa import anneal
    from repro_torch.serve import AnnealRequest, AnnealService

    hp = _service_hp()
    problems = [gset.load(n) for n in SERVICE_TWINS] + [gset.load("K2000")]
    reqs = [AnnealRequest(problem=p, hp=hp, seed=s) for s, p in enumerate(problems)]
    refs = [anneal(p, hp, seed=s, track_energy=False, device="cuda",
                   config=SolverConfig(backend="cuda", noise="xorshift"))
            for s, p in enumerate(problems)]
    k1_per = 2 * hp.m_shot * hp.steps  # two groups
    svc = AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                        chunk_shots=5)
    resp, wall, counts, _ = _service_solve(svc, reqs, "service K1")
    _expect("service K1", counts, (k1_per, 0, 0, 0, 0, 0))
    _check_service("service K1", resp, refs, problems)
    if sorted({(r.bucket, r.batch) for r in resp}) != [(1024, 4), (2048, 1)]:
        _fail("service K1: expected one group of 4 at bucket 1024 and one of 1 at 2048")
    rate = sum(hp.total_cycles * hp.n_trials * p.n for p in problems) / wall
    print(f"[service K1] {rate:.4e} aggregate spin-cycles/s (live spins); chunk traces "
          f"{[list(map(int, r.chunk_best_cut)) for r in resp]}")
    misses, hits = svc.stats["program_cache_misses"], svc.stats["program_cache_hits"]
    resp2, wall2, counts2, _ = _service_solve(svc, reqs, "service K1, second solve")
    new_hits = svc.stats["program_cache_hits"] - hits
    new_builds = svc.stats["program_cache_misses"] - misses
    print(f"[service K1, second solve] program cache hits {new_hits}, new builds {new_builds}")
    if (new_hits, new_builds) != (2, 0):
        _fail(f"second solve: expected 2 cache hits and no build, got {new_hits, new_builds}")
    _expect("service K1, second solve", counts2, (k1_per, 0, 0, 0, 0, 0))
    _check_service("service K1, second solve", resp2, refs, problems)
    print("[profile] " + _profile_call(functools.partial(svc.solve, reqs), "service K1 solve()",
                                       "K1", "plateau_kernel"))
    pre = AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                        chunk_shots=5, backend_opts={"noise_mode": "pregen"})
    resp4, _, counts4, _ = _service_solve(pre, reqs, "service K4 (xorshift pregen)")
    _expect("service K4", counts4, (0, 0, k1_per, 0, 0, 0))
    _check_service("service K4", resp4, refs, problems)
    return problems, reqs, resp, counts[0], counts4[2]


def phase_service_popcount(problems, reqs, k1_resp):
    """Service phase 2: the same batch with field_mode='auto' (±1 weights:
    popcount): K2 once per iteration's chain for each group, the results of
    phase 1."""
    from repro_torch.serve import AnnealService

    svc = AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                        chunk_shots=5, backend_opts={"field_mode": "auto"})
    resp, _, counts, _ = _service_solve(svc, reqs, "service K2")
    m_shot = reqs[0].hp.m_shot
    _expect("service K2", counts, (0, 0, 0, 2 * m_shot, 0, 0))
    _check_service("service K2", resp, [r.result for r in k1_resp], problems)
    return counts[3]


def phase_service_ssqa():
    """Service phase 3: the four N = 800 twins at the SSQA cell's widths,
    one group of B = 4, on the dense field (K1: classical on the J⊥ = 0
    plateau, ring mode on the others) and on popcount (K2's ring mode, one
    chain per iteration).  The plain witness is the same batch on
    AnnealService(backend='dense'), plain PyTorch on the card at the same B
    = 4 and bucket: it launches no kernel, and each of the two kernel
    solves must equal it bit for bit, as each response must equal
    anneal_ssqa of its instance.  Returns the ring-mode launches of K1 and
    K2."""
    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.engine import schedule_plateaus
    from repro_torch.core.ssqa import anneal_ssqa
    from repro_torch.serve import AnnealRequest, AnnealService

    hp = _service_hp(ssqa=True)
    problems = [gset.load(n) for n in SERVICE_TWINS]
    reqs = [AnnealRequest(problem=p, hp=hp, seed=s, algo="ssqa") for s, p in enumerate(problems)]
    refs = [anneal_ssqa(p, hp, seed=s, track_energy=False, device="cuda",
                        config=SolverConfig(backend="cuda", noise="xorshift"))
            for s, p in enumerate(problems)]
    plain = AnnealService(backend="dense", noise="xorshift", storage_layout="packed",
                          chunk_shots=5)
    witness, _, counts, _ = _service_solve(plain, reqs, "service SSQA plain witness (dense)")
    _expect("service SSQA plain witness", counts, (0, 0, 0, 0, 0, 0))
    _check_service("service SSQA plain witness", witness, refs, problems)
    coupled = hp.m_shot * sum(1 for pl in schedule_plateaus(hp.schedule()) if pl.jperp)
    ring = {}
    for name, opts, want in (
            ("dense field", {}, (hp.m_shot * hp.steps, 0, 0, 0, coupled, 0)),
            ("popcount", {"field_mode": "popcount"}, (0, 0, 0, hp.m_shot, 0, hp.m_shot))):
        svc = AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                            chunk_shots=5, backend_opts=opts)
        resp, _, counts, _ = _service_solve(svc, reqs, f"service SSQA {name}")
        _expect(f"service SSQA {name}", counts, want)
        _check_service(f"service SSQA {name}", resp, refs, problems)
        _check_service(f"service SSQA {name} against the plain witness", resp,
                       [w.result for w in witness], problems)
        if [list(r.chunk_best_cut) for r in resp] != [list(w.chunk_best_cut) for w in witness]:
            _fail(f"service SSQA {name}: chunk traces differ from the plain witness")
        ring[name] = counts
    print("[service SSQA] K1's and K2's ring modes at B = 4, bucket 1024 equal the plain "
          "dense backend bit for bit (best energies, spins, chunk traces)")
    return ring["dense field"][4], ring["popcount"][5]


def phase_service_tiled():
    """Service phase 4: the G77 twin (14383 spins, bucket 16384) on the
    dense backend (j_mode 'auto' → tiled J: no J on the card) and on the
    cuda backend with popcount (K2 at N = 16384), at a short schedule (τ =
    10, I0 1 → 4, one shot); the two equal each other and anneal() of the
    unpadded instance (K2).  Prints the dense path's peak device bytes
    beside the 1 GiB a dense J would take.  Returns K2's launches."""
    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.ssa import SSAHyperParams, anneal
    from repro_torch.serve import AnnealRequest, AnnealService

    hp = SSAHyperParams(n_trials=100, m_shot=1, tau=10, i0_min=1, i0_max=4, n_rnd=2)
    p = gset.load("G77")
    reqs = [AnnealRequest(problem=p, hp=hp, seed=0)]
    ref = anneal(p, hp, seed=0, track_energy=False, device="cuda",
                 config=SolverConfig(backend="cuda", noise="xorshift", field_mode="popcount"))
    dense = AnnealService(backend="dense", noise="xorshift", storage_layout="packed")
    resp, wall, counts, peak = _service_solve(dense, reqs, "service tiled J (dense backend)")
    (bk, _, _), = dense._programs.values()
    if bk.j_mode != "tiled" or resp[0].bucket != 16384:
        _fail(f"service tiled: expected j_mode 'tiled' at bucket 16384, got {bk.j_mode!r} "
              f"at {resp[0].bucket}")
    _expect("service tiled J", counts, (0, 0, 0, 0, 0, 0))
    _check_service("service tiled J", resp, [ref], [p])
    j_bytes = 4 * 16384 * 16384
    print(f"[service tiled J] {p.name} N={p.n} → 16384: wall {wall:.3f}s; peak device memory "
          f"of the call {peak} B, against {j_bytes} B for a dense float32 J "
          f"({peak / j_bytes:.4f}x)")
    if peak >= j_bytes:
        _fail("service tiled: the dense path's peak reaches a dense J's bytes")
    pc = AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                       backend_opts={"field_mode": "popcount"})
    resp2, _, counts2, peak2 = _service_solve(pc, reqs, "service tiled K2 (N = 16384)")
    _expect("service tiled K2", counts2, (0, 0, 0, hp.m_shot, 0, 0))
    _check_service("service tiled K2", resp2, [resp[0].result], [p])
    print(f"[service tiled K2] last launch (cluster size, blocks, variant) "
          f"{_k2_last()}; peak device memory of the call {peak2} B")
    return counts2[3]


def _k2_last():
    from repro_torch.kernels import ssa_update

    return ssa_update.ssa_plateau_popcount_batched.last_cluster


def phase_service_fallback(problems, reqs, k1_resp):
    """Service phase 5: an injected compile fault on the cuda group of
    bucket 1024 walks the chain to the dense backend: the four twins come
    back 'fallback' with one cuda → dense event and phase 1's results; the
    K2000 group stays on K1, 'ok'."""
    from repro_torch.ft.faults import FaultInjector
    from repro_torch.serve import AnnealService

    inj = FaultInjector()
    inj.arm("compile", backend="cuda", bucket=1024)
    svc = AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                        chunk_shots=5, faults=inj)
    resp, _, counts, _ = _service_solve(svc, reqs, "service fallback")
    hp = reqs[0].hp
    _expect("service fallback", counts, (hp.m_shot * hp.steps, 0, 0, 0, 0, 0))
    refs = [r.result for r in k1_resp]
    _check_service("service fallback", resp[:4], refs[:4], problems[:4], status="fallback")
    _check_service("service fallback", resp[4:], refs[4:], problems[4:])
    for r in resp[:4]:
        hops = [(e.detail["from"], e.detail["to"]) for e in r.events if e.kind == "fallback"]
        if hops != [("cuda", "dense")] or len(r.events) != 1:
            _fail(f"service fallback: expected one cuda → dense event, got "
                  f"{[(e.kind, e.detail) for e in r.events]}")
    print(f"[service fallback] events {[e.kind for e in resp[0].events]}: "
          f"{resp[0].events[0].detail['error']}")


# ---------------------------------------------------------------------------
# The streaming service (StreamingAnnealService) and chunk checkpoints
# ---------------------------------------------------------------------------
STREAM_SLOTS = 4
# Phase 23's requests: the four twins at seeds 0 and 1 (bucket 1024) and the
# K2000 twin at seeds 4 and 5 (bucket 2048); every other one carries a
# target_cut from its own one-shot chunk trace, at this chunk.
STREAM_TARGET_CHUNK = 3


def _stream_problems():
    from repro_torch.core import gset

    names = [(n, s) for s in (0, 1) for n in SERVICE_TWINS] + [("K2000", 4), ("K2000", 5)]
    loaded = {n: gset.load(n) for n in dict(names)}
    return [loaded[n] for n, _ in names], [s for _, s in names]


def _stream_service(**kw):
    """Table II widths on the cuda backend, packed layout, chunks of one
    shot (the stream's scheduling quantum is one iteration)."""
    from repro_torch.serve import AnnealService

    return AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                         chunk_shots=1, **kw)


def _same_lane(got, want) -> bool:
    import numpy as np

    return (got.result is not None and want.result is not None
            and np.array_equal(got.result.best_cut, want.result.best_cut)
            and np.array_equal(got.result.best_m, want.result.best_m)
            and np.array_equal(got.result.best_energy, want.result.best_energy)
            and np.array_equal(got.chunk_best_cut, want.chunk_best_cut))


def _check_stream(what, resp, refs, problems, status="ok"):
    """Every streamed response has ``status`` and a well-formed result equal
    to its one-shot solve bit for bit: best_cut, best_m, best energies and
    the chunk trace."""
    import numpy as np

    for r, ref, p in zip(resp, refs, problems):
        if r.status != status:
            _fail(f"{what}: {p.name} (seed {r.request.seed}) came back {r.status!r}; "
                  f"events {[(e.kind, e.detail) for e in r.events]}")
        res = r.result
        if not (res.best_m.shape == (r.request.hp.n_trials, p.n)
                and set(np.unique(res.best_m)) <= {-1, 1}
                and np.array_equal(p.cut_value(res.best_m), res.best_cut)):
            _fail(f"{what}: {p.name}: malformed result")
        if not _same_lane(r, ref):
            _fail(f"{what}: {p.name} (seed {r.request.seed}) differs from its one-shot solve "
                  f"(traces {list(r.chunk_best_cut)} / {list(ref.chunk_best_cut)})")


class _SeatTimer:
    """Times each seat (host stack, lane init, splice) and each splice of a
    stream, the device synchronised around both: measurement only."""

    def __init__(self, ss):
        from repro_torch.serve import stream

        self.seat_s, self.splice_s, self._mod = [], [], stream
        self._splice, seat = stream.splice_slot, ss._seat

        def timed(fn, out):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
                return r
            return run

        ss._seat = timed(seat, self.seat_s)
        stream.splice_slot = timed(self._splice, self.splice_s)

    def close(self):
        self._mod.splice_slot = self._splice

    def line(self) -> str:
        if not self.seat_s:
            return "no seat"
        per = [s * 1e3 for s in self.seat_s]
        spl = [s * 1e3 for s in self.splice_s]
        return (f"{len(per)} seats, ms per seat mean {sum(per) / len(per):.3f} (min "
                f"{min(per):.3f}, max {max(per):.3f}); {len(spl)} splices, ms per splice mean "
                f"{sum(spl) / max(1, len(spl)):.3f}")


def _stream_run(ss, reqs, what):
    """Submit ``reqs`` and drive the stream on this thread until idle (a
    fault raises here instead of hanging a waiting ticket): (responses,
    wall s, launches, peak device bytes, the stream counters' increase)."""
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timer = _SeatTimer(ss)
    q0 = dict(ss.stream_stats())
    _reset_counts()
    t0 = time.time()
    try:
        tickets = [ss.submit(r) for r in reqs]
        ss.run_until_idle()
        torch.cuda.synchronize()
    finally:
        timer.close()
    wall = time.time() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() - live
    resp = [t.result(timeout=0) for t in tickets]
    st = ss.stream_stats()
    d = {k: st.get(k, 0) - q0.get(k, 0)
         for k in ("stream_quanta", "stream_backfills", "stream_live_lane_chunks",
                   "stream_slot_chunks", "stream_tables_created", "stream_retired_target",
                   "stream_retired_budget", "stream_resumes")}
    occ = d["stream_live_lane_chunks"] / max(1, d["stream_slot_chunks"])
    print(f"[{what}] {len(reqs)} requests, tables of {ss.policy.slots_per_table} slots: wall "
          f"{wall:.3f}s; quanta {d['stream_quanta']}, backfills {d['stream_backfills']}, "
          f"tables {d['stream_tables_created']}, retired target/budget "
          f"{d['stream_retired_target']}/{d['stream_retired_budget']}, occupancy "
          f"{occ:.4f} ({d['stream_live_lane_chunks']}/{d['stream_slot_chunks']} lane chunks); "
          f"(K1, K3, K4, K2, K1 ring, K2 ring) launches {counts}; peak device memory of the "
          f"call {peak} B; {timer.line()}; statuses {sorted({r.status for r in resp})}")
    return resp, wall, counts, peak, d


def _stream_reqs(problems, seeds, hp, traces=None):
    """Phase 23's requests; with ``traces``, every other one targets its own
    one-shot best cut at STREAM_TARGET_CHUNK."""
    from repro_torch.serve import AnnealRequest

    return [AnnealRequest(problem=p, hp=hp, seed=s,
                          target_cut=(int(traces[i][STREAM_TARGET_CHUNK - 1])
                                      if traces is not None and i % 2 == 0 else None))
            for i, (p, s) in enumerate(zip(problems, seeds))]


def phase_stream():
    """Stream phase 1 (K1): phase 23's ten requests through
    StreamingAnnealService(tables of 4 slots) on the cuda backend, packed
    layout, one shot a quantum, driven on this thread.  The half with a
    target retire early and their slots backfill.  Every response 'ok' and
    equal to AnnealService.solve of the same request, bit for bit; K1
    launched stream_quanta × plateaus per chunk, nothing else.  Then the
    same stream again under torch.profiler (measured, not asserted).
    Returns (problems, requests, stream responses, K1 launches)."""
    from repro_torch.serve import StreamingAnnealService, StreamPolicy

    hp = _service_hp()
    problems, seeds = _stream_problems()
    cal = _stream_service().solve(_stream_reqs(problems, seeds, hp))
    traces = [list(map(int, r.chunk_best_cut)) for r in cal]
    reqs = _stream_reqs(problems, seeds, hp, traces)
    refs = _stream_service().solve(reqs)
    if not any(r.chunks_run < r.chunks_total for r in refs):
        _fail("stream K1: no targeted request stopped early in its one-shot solve")
    ss = StreamingAnnealService(service=_stream_service(),
                                policy=StreamPolicy(slots_per_table=STREAM_SLOTS))
    resp, wall, counts, peak, d = _stream_run(ss, reqs, "stream K1")
    _check_stream("stream K1", resp, refs, problems)
    per_chunk = hp.steps  # one shot a quantum: one K1 launch per plateau
    _expect("stream K1", counts, (d["stream_quanta"] * per_chunk, 0, 0, 0, 0, 0))
    if d["stream_retired_target"] == 0 or d["stream_backfills"] <= STREAM_SLOTS:
        _fail(f"stream K1: expected early retirements and backfills, got {d}")
    print(f"[stream K1] chunks run {[r.chunks_run for r in resp]}; targets "
          f"{[r.request.target_cut for r in resp]}; one-shot traces {traces}")
    again = StreamingAnnealService(service=_stream_service(),
                                   policy=StreamPolicy(slots_per_table=STREAM_SLOTS))

    def run():
        tickets = [again.submit(r) for r in reqs]
        again.run_until_idle()
        return tickets

    print("[profile] " + _profile_call(run, "stream K1 run_until_idle()", "K1", "plateau_kernel"))
    return problems, reqs, resp, counts[0]


def phase_stream_k2_and_rings(problems, reqs):
    """Stream phase 2: phase 23's requests with field_mode='auto' (K2, one
    launch a quantum), and the four N = 800 twins at the SSQA cell's widths
    on the dense field (K1 and its ring mode) and on popcount (K2's ring
    mode); each response equal to its one-shot solve with the same options.
    Returns the stream launches of K2, K1's ring mode and K2's ring mode."""
    from repro_torch.core import gset
    from repro_torch.core.engine import schedule_plateaus
    from repro_torch.serve import AnnealRequest, StreamingAnnealService, StreamPolicy

    pol = StreamPolicy(slots_per_table=STREAM_SLOTS)
    opts = {"field_mode": "auto"}
    refs = _stream_service(backend_opts=opts).solve(reqs)
    ss = StreamingAnnealService(service=_stream_service(backend_opts=opts), policy=pol)
    resp, _, counts, _, d = _stream_run(ss, reqs, "stream K2")
    _check_stream("stream K2", resp, refs, problems)
    _expect("stream K2", counts, (0, 0, 0, d["stream_quanta"], 0, 0))
    k2 = counts[3]

    hp = _service_hp(ssqa=True)
    twins = [gset.load(n) for n in SERVICE_TWINS]
    sreqs = [AnnealRequest(problem=p, hp=hp, seed=s, algo="ssqa") for s, p in enumerate(twins)]
    coupled = sum(1 for pl in schedule_plateaus(hp.schedule()) if pl.jperp)
    ring = {}
    for name, o in (("dense field", {}), ("popcount", {"field_mode": "popcount"})):
        srefs = _stream_service(backend_opts=o).solve(sreqs)
        ss = StreamingAnnealService(service=_stream_service(backend_opts=o), policy=pol)
        resp, _, counts, _, d = _stream_run(ss, sreqs, f"stream SSQA {name}")
        _check_stream(f"stream SSQA {name}", resp, srefs, twins)
        q = d["stream_quanta"]
        want = ((q * hp.steps, 0, 0, 0, q * coupled, 0) if not o else (0, 0, 0, q, 0, q))
        _expect(f"stream SSQA {name}", counts, want)
        ring[name] = counts
    return k2, ring["dense field"][4], ring["popcount"][5]


class _SaveTimer:
    """Times every checkpoint write (host copy, npz, sidecar): measurement
    only."""

    def __init__(self):
        from repro_torch.checkpoint import ckpt

        self.s, self._mod, self._save = [], ckpt, ckpt.save

        def timed(*a, **k):
            t0 = time.perf_counter()
            r = self._save(*a, **k)
            self.s.append(time.perf_counter() - t0)
            return r

        ckpt.save = timed

    def close(self):
        self._mod.save = self._save

    def line(self) -> str:
        ms = [x * 1e3 for x in self.s]
        return (f"{len(ms)} saves, ms per save mean {sum(ms) / max(1, len(ms)):.3f}"
                + (f" (min {min(ms):.3f}, max {max(ms):.3f})" if ms else ""))


def _lane_bytes(directory, n_bucket) -> int:
    """Bytes of the newest checkpoint under ``directory`` whose lanes span
    ``n_bucket`` spins, or 0."""
    import numpy as np

    size = 0
    for path in sorted(Path(directory).rglob("ckpt_*.npz")):
        with np.load(path) as z:
            key = [k for k in z.files if k.startswith("noise_state")][0]
            if z[key].shape[0] == 1 and z[key].shape[-1] == n_bucket:
                size = path.stat().st_size
    return size


def _killed(fn, what):
    from repro_torch.ft.faults import InjectedKill

    try:
        fn()
    except InjectedKill as e:
        print(f"[{what}] killed as armed: {e}")
        return
    _fail(f"{what}: the armed kill did not fire")


def phase_checkpoints(svc_problems, svc_reqs, svc_resp, problems, reqs, stream_resp):
    """Checkpoint phase: (1) phase 18's one-shot batch with checkpoints on,
    killed at its chunk 1, resumed by a fresh service: phase 18's
    responses, a 'resume' event at chunk 2 on the killed group, the
    directory purged; (2) phase 23's stream, killed after a table's third
    quantum, resumed by a fresh stream: each lane from its own checkpoint,
    phase 23's responses; (3) a one-shot solo checkpoint of phase 23's last
    request (K2000, seed 5) resumed into a stream.  Prints a K2000 lane
    checkpoint's bytes and the time of a save."""
    import os
    import tempfile

    from repro_torch.ft.faults import FaultInjector
    from repro_torch.serve import (
        AnnealService,
        ResiliencePolicy,
        StreamingAnnealService,
        StreamPolicy,
    )

    pol_s = StreamPolicy(slots_per_table=STREAM_SLOTS)
    with tempfile.TemporaryDirectory() as root:
        d1 = os.path.join(root, "oneshot")
        pol = ResiliencePolicy(checkpoint_dir=d1)
        inj = FaultInjector()
        inj.arm("kill", chunk=1)
        mk = functools.partial(AnnealService, backend="cuda", noise="xorshift",
                               storage_layout="packed", chunk_shots=5, resilience=pol)
        timer = _SaveTimer()
        try:
            _killed(lambda: mk(faults=inj).solve(svc_reqs), "checkpoint one-shot")
        finally:
            timer.close()
        print(f"[checkpoint one-shot] {timer.line()} (a group of B = 4 at bucket 1024)")
        resp, _, counts, _ = _service_solve(mk(), svc_reqs, "checkpoint one-shot resumed")
        hp = svc_reqs[0].hp
        _expect("checkpoint one-shot resumed", counts, (hp.m_shot * hp.steps, 0, 0, 0, 0, 0))
        for r, ref, p in zip(resp, svc_resp, svc_problems):
            if not _same_lane(r, ref):
                _fail(f"checkpoint one-shot: {p.name} differs from phase 18's response")
        resumes = [(r.bucket, e.detail["chunk"]) for r in resp for e in r.events
                   if e.kind == "resume"]
        if sorted(set(resumes)) != [(1024, 2)] or len(resumes) != 4:
            _fail(f"checkpoint one-shot: expected the bucket-1024 group's resume at chunk 2, "
                  f"got {resumes}")
        if os.listdir(d1):
            _fail("checkpoint one-shot: the checkpoints were not purged")

        d2 = os.path.join(root, "stream")
        pol = ResiliencePolicy(checkpoint_dir=d2)
        inj = FaultInjector()
        inj.arm("kill", chunk=2)
        killed = StreamingAnnealService(service=_stream_service(resilience=pol, faults=inj),
                                        policy=pol_s)
        timer = _SaveTimer()
        try:
            for r in reqs:
                killed.submit(r)
            _killed(killed.run_until_idle, "checkpoint stream")
        finally:
            timer.close()
        in_flight = sorted((t.slots[i].ticket.seq, t.slots[i].chunks_done)
                           for t in killed._tables.values() for i in range(len(t.slots))
                           if t.slots[i] is not None and t.slots[i].chunks_done)
        lane_bytes = _lane_bytes(d2, 2048)
        print(f"[checkpoint stream] {timer.line()} (one lane each); lanes in flight at the "
              f"kill (request, chunks done) {in_flight}; a K2000 lane checkpoint {lane_bytes} B")
        ss = StreamingAnnealService(service=_stream_service(resilience=pol), policy=pol_s)
        resp, _, _, _, d = _stream_run(ss, reqs, "checkpoint stream resumed")
        _check_stream("checkpoint stream resumed", resp, stream_resp, problems)
        resumed = sorted((t.request.seed, e.detail["chunk"]) for t in resp for e in t.events
                         if e.kind == "resume")
        print(f"[checkpoint stream resumed] resumes {d['stream_resumes']} (seed, chunk) "
              f"{resumed}")
        if not resumed or d["stream_resumes"] != len(resumed):
            _fail("checkpoint stream: no lane resumed from its checkpoint")
        if os.listdir(d2):
            _fail("checkpoint stream: the checkpoints were not purged")

        d3 = os.path.join(root, "solo")
        pol = ResiliencePolicy(checkpoint_dir=d3)
        inj = FaultInjector()
        inj.arm("kill", chunk=1)
        req, ref, p = reqs[-1], stream_resp[-1], problems[-1]
        timer = _SaveTimer()
        try:
            _killed(lambda: _stream_service(resilience=pol, faults=inj).solve([req]),
                    "checkpoint solo")
        finally:
            timer.close()
        solo_bytes = _lane_bytes(d3, 2048)
        print(f"[checkpoint solo] {p.name} seed {req.seed}: {timer.line()}; its checkpoint "
              f"{solo_bytes} B")
        ss = StreamingAnnealService(service=_stream_service(resilience=pol), policy=pol_s)
        resp, _, _, _, _ = _stream_run(ss, [req], "checkpoint solo into the stream")
        _check_stream("checkpoint solo into the stream", resp, [ref], [p])
        got = [(e.kind, e.detail["chunk"]) for e in resp[0].events if e.kind == "resume"]
        if got != [("resume", 2)] or os.listdir(d3):
            _fail(f"checkpoint solo: expected one resume at chunk 2 and a purge, got {got}")


def phase_stream_traffic():
    """Open-loop traffic (repro_torch.benchmarks.serve_stream): the five
    twins' calibration traces, a compound-Poisson trace of 24 requests in
    bursts of 4 at twice the capacity probe_stream_capacity measures,
    replayed on the stream's background thread with finite result timeouts.
    Asserted: every non-shed streamed trace is a bit-exact prefix of its
    calibration trace, and K1 launched quanta × plateaus per chunk.
    Measured: latency, goodput, occupancy, shed and late counts."""
    from repro_torch.benchmarks import serve_stream as bench
    from repro_torch.core import gset

    hp = _service_hp()
    problems = [gset.load(n) for n in SERVICE_TWINS + ("K2000",)]
    kw = dict(device="cuda", storage_layout="packed", chunk_shots=1)
    t0 = time.time()
    entries = bench.calibrate(problems, hp, "cuda", **kw)
    trace = bench.make_trace(entries, hp, 24, seed=0)
    s_stream, lane_p50, lane_max = bench.probe_stream_capacity(trace, "cuda", STREAM_SLOTS, **kw)
    deadline_s = max(2.0 * lane_max, 0.25)
    rate = 2.0 / max(s_stream, 1e-6)
    arrivals = bench.poisson_arrivals(24, rate, 0, burst=STREAM_SLOTS)
    print(f"[stream traffic] capacity probe {s_stream:.4f} s a request (lane p50 "
          f"{lane_p50:.4f} s, max {lane_max:.4f} s); offered 2x = {rate:.4f} requests/s; "
          f"deadline {deadline_s:.4f} s; set-up {time.time() - t0:.1f}s")
    _reset_counts()
    records, stats = bench.run_stream(trace, arrivals, deadline_s, "cuda", STREAM_SLOTS,
                                      result_timeout_s=300.0, **kw)
    torch.cuda.synchronize()
    counts = _counts()
    bad = bench.check_prefix_determinism(records)
    sc = bench.score(records, deadline_s)
    shed = sum(1 for r in records if r.get("resp") is not None and r["resp"].status == "shed")
    print(f"[stream traffic] {len(records)} requests: p50 {sc['p50_s']} s, p99 {sc['p99_s']} s, "
          f"goodput {sc['goodput_cycles_per_s']:.4e} spin-cycles/s over {sc['makespan_s']:.3f} s, "
          f"on time {sc['on_time']}, late {sc['late']}, shed {shed}, dropped {sc['dropped']}; "
          f"occupancy {stats['occupancy']:.4f}; quanta {stats['stream_quanta']}; "
          f"(K1, K3, K4, K2, K1 ring, K2 ring) launches {counts}; prefix mismatches {bad}")
    if bad:
        _fail(f"stream traffic: {bad} streamed traces are not prefixes of their calibration "
              "traces")
    _expect("stream traffic", counts, (stats["stream_quanta"] * hp.steps, 0, 0, 0, 0, 0))

# ---------------------------------------------------------------------------
# Phases 27-30: the problem families, SA, PT and PT-SSA
# ---------------------------------------------------------------------------
# (kind, spins, field mode of anneal()): make_demo at K2000 scale, seed 0.
# QUBO (5-bit weights, |h| ~10^3) and partition (13-bit weights) take the
# dense field (K1), MIS (2 magnitude planes) and coloring (2100 spins, 4
# planes) the popcount chain (K2).
FAMILIES = (("qubo", 2000, "dense"), ("partition", 2000, "dense"),
            ("mis", 2000, "popcount"), ("coloring", 2100, "popcount"))
# SA at Table II's 90,000 cycles on the card; its CPU bit-identity check and
# the service groups run a cut of it.  PT and PT-SSA are cut to fit the
# run's time: PT 90,000 → 20,000 cycles, PT-SSA 60 → 5 rounds of 100.
SA_CYCLES, SA_CHECK_CYCLES = 90_000, 2_000
PT_CYCLES, PTSSA_ROUNDS = 20_000, 5


def _counters_zero(what, counts):
    if any(counts):
        _fail(f"{what}: launched a kernel: (K1, K3, K4, K2, K1 ring, K2 ring) = {counts}")


def phase_families():
    """Phase 27: each family's make_demo instance at K2000 scale through
    anneal() on the card at Table II's widths — QUBO and partition on K1
    (m_shot × steps launches), MIS and coloring with field_mode='popcount'
    on K2 (m_shot launches) — each equal (spins, energies, hence the
    decoded solution) to the port's dense backend on the card.  Returns
    {kind: (encoding, result, launches)}."""
    import numpy as np

    from repro_torch.core.config import SolverConfig
    from repro_torch.core.engine import model_weight_bits
    from repro_torch.kernels import ssa_update
    from repro_torch.problems import make_demo

    hp = _service_hp()
    out = {}
    for kind, n, field in FAMILIES:
        t0 = time.time()
        enc = make_demo(kind, n=n, seed=0)
        encode = time.time() - t0
        model = enc.model
        cfg = SolverConfig(backend="cuda", noise="xorshift",
                           field_mode="popcount" if field == "popcount" else "auto")
        r, wall, counts, peak, _, setup = _anneal_run(enc, hp, cfg, track_energy=False)
        sol, obj, feas = enc.best_feasible(r.best_m)
        k2 = (_k2_launch(ssa_update.ssa_plateau_popcount_batched) if field == "popcount"
              else "no K2 launch")
        print(f"[family {kind}] N={model.n} max degree {model.max_degree} "
              f"|h|max={int(np.abs(model.h).max())} |J|max={int(np.abs(model.nbr_w).max())} "
              f"nb={model_weight_bits(model)} field={field}: objective {obj}, feasible {feas}, "
              f"best energy {int(r.best_energy.min())}; wall {wall:.3f}s, set-up {setup:.3f}s "
              f"(encode {encode:.3f}s), peak device memory of the call {peak} B; "
              f"(K1, K3, K4, K2, K1 ring, K2 ring) launches {counts}; K2: {k2}")
        want = ((hp.m_shot * hp.steps, 0, 0, 0, 0, 0) if field == "dense"
                else (0, 0, 0, hp.m_shot, 0, 0))
        _expect(f"family {kind}", counts, want)
        if r.best_m.shape != (hp.n_trials, model.n) or not set(np.unique(r.best_m)) <= {-1, 1}:
            _fail(f"family {kind}: malformed result")
        out[kind] = (enc, r, counts[0] if field == "dense" else counts[3])
    return out


def _same_decoded(what, resp, enc, ref):
    """A response of an encoded problem: the reference run's spins and
    energies, and the solution, objective and feasibility decoded from
    them."""
    import numpy as np

    sol, obj, feas = enc.best_feasible(ref.best_m)
    if resp.status != "ok" or resp.result is None:
        _fail(f"{what}: {enc.kind} came back {resp.status!r}")
    if not (np.array_equal(resp.result.best_energy, ref.best_energy)
            and np.array_equal(resp.result.best_m, ref.best_m)):
        _fail(f"{what}: {enc.kind} differs from its single-problem run")
    if (resp.objective, resp.feasible) != (obj, feas) or not np.array_equal(
            np.asarray(resp.solution), np.asarray(sol)):
        _fail(f"{what}: {enc.kind}'s solution, objective or feasibility differs")


def phase_families_service(fam):
    """Phase 28: one AnnealService.solve of the four encodings
    (field_mode='auto', packed layout, chunks of 5 shots) — QUBO, MIS and
    partition share bucket 2048, whose 13-bit partition weights resolve the
    group to the dense field (K1), and coloring runs alone at bucket 4096
    on K2 — then one stream of them (one table per stream key); every
    response equals phase 27's run of its instance, decoded solution
    included.  Returns the launches of K1 and K2 in the solve and the
    stream."""
    from repro_torch.serve import AnnealRequest, AnnealService, StreamingAnnealService, StreamPolicy

    hp = _service_hp()
    kinds = [k for k, _, _ in FAMILIES]
    reqs = [AnnealRequest(problem=fam[k][0], hp=hp, seed=0) for k in kinds]

    def service():
        return AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                             chunk_shots=5, backend_opts={"field_mode": "auto"})

    resp, wall, counts, peak = _service_solve(service(), reqs, "family service")
    _expect("family service", counts, (hp.m_shot * hp.steps, 0, 0, hp.m_shot, 0, 0))
    for k, r in zip(kinds, resp):
        _same_decoded("family service", r, fam[k][0], fam[k][1])
        print(f"[family service] {k}: bucket {r.bucket}, batch {r.batch}, objective "
              f"{r.objective}, feasible {r.feasible}")
    ss = StreamingAnnealService(service=service(),
                                policy=StreamPolicy(slots_per_table=STREAM_SLOTS))
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    tickets = [ss.submit(r) for r in reqs]
    ss.run_until_idle()
    torch.cuda.synchronize()
    swall = time.time() - t0
    scounts = _counts()
    st = ss.stream_stats()
    print(f"[family stream] {len(reqs)} requests: wall {swall:.3f}s, quanta "
          f"{st['stream_quanta']}, tables {st['stream_tables_created']}; (K1, K3, K4, K2, "
          f"K1 ring, K2 ring) launches {scounts}")
    if scounts[1] or scounts[2] or scounts[4] or scounts[5] or not (scounts[0] and scounts[3]):
        _fail(f"family stream: expected K1 and K2 launches only, got {scounts}")
    for k, t in zip(kinds, tickets):
        _same_decoded("family stream", t.result(timeout=0), fam[k][0], fam[k][1])
    return counts[0], counts[3], scounts[0], scounts[3]


def phase_sa(production_wall):
    """Phase 29: anneal_sa on the K2000 twin with 100 trials — on the card
    equal to the port's CPU run at SA_CHECK_CYCLES; at Table II's 90,000
    cycles on the card (no kernel launched; the host key chain timed); and
    the paper's convergence comparison against HA-SSA, measured, not
    gated."""
    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.sa import SAHyperParams, _key_chain, anneal_sa
    from repro_torch.serve import AnnealRequest, AnnealService

    p = gset.load("K2000")
    small = SAHyperParams(n_trials=100, n_cycles=SA_CHECK_CYCLES)
    t0 = time.time()
    got = anneal_sa(p, small, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_small = time.time() - t0
    t0 = time.time()
    want = anneal_sa(p, small, seed=0, device="cpu")
    t_cpu = time.time() - t0
    if not (np.array_equal(got.best_energy, want.best_energy)
            and np.array_equal(got.best_m, want.best_m)
            and np.array_equal(got.energy_min, want.energy_min)
            and np.array_equal(got.energy_mean.view(np.int32), want.energy_mean.view(np.int32))):
        _fail("sa: the card's run differs from the CPU run")
    print(f"[sa check] K2000, 100 trials, {SA_CHECK_CYCLES} cycles: card == CPU (best energy, "
          f"spins, traces); card {t_small:.3f}s, CPU {t_cpu:.3f}s")
    t0 = time.time()
    _key_chain(np.zeros((1, 2), np.int64), SA_CYCLES)
    t_chain = time.time() - t0
    hp = SAHyperParams(n_trials=100, n_cycles=SA_CYCLES)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    r = anneal_sa(p, hp, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    _counters_zero("sa", _counts())
    if not np.array_equal(p.cut_value(r.best_m), r.best_cut):
        _fail("sa: best_cut does not match the cut of best_m")
    best = (p.w_total - np.minimum.accumulate(r.energy_min)) // 2   # best-so-far cut per cycle
    print(f"[sa] K2000, 100 trials, {SA_CYCLES} cycles (T 10 → 1e-7): best cut "
          f"{r.overall_best_cut}, mean {r.mean_best_cut:.1f}; wall {wall:.3f}s "
          f"({hp.n_cycles * hp.n_trials * p.n / wall:.4e} spin-cycles/s), host key chain "
          f"{t_chain:.3f}s; no kernel launched")
    # HA-SSA's best after each iteration: the service's per-chunk trace with
    # one shot a chunk (the production path's hyper-parameters and seed).
    ha_hp = _service_hp()
    (ha,) = AnnealService(backend="cuda", noise="xorshift", chunk_shots=1).solve(
        [AnnealRequest(problem=p, hp=ha_hp, seed=0)])
    ha_trace = np.asarray(ha.chunk_best_cut)
    sa_final, ha_final = int(best[-1]), int(ha_trace[-1])
    it = np.nonzero(ha_trace >= sa_final)[0]
    c_sa = np.nonzero(best >= ha_final)[0]
    per_it = ha_hp.cycles_per_iter
    ha_txt = (f"HA-SSA reaches SA's final cut {sa_final} after {(it[0] + 1) * per_it} cycles "
              f"(iteration {it[0] + 1}; ~{production_wall * (it[0] + 1) / ha_hp.m_shot:.3f}s "
              f"at the production path's wall)" if len(it)
              else f"HA-SSA does not reach SA's final cut {sa_final} in "
                   f"{ha_hp.total_cycles} cycles")
    sa_txt = (f"SA reaches HA-SSA's {ha_hp.total_cycles}-cycle cut {ha_final} after "
              f"{c_sa[0] + 1} cycles (~{wall * (c_sa[0] + 1) / SA_CYCLES:.3f}s)" if len(c_sa)
              else f"SA does not reach HA-SSA's {ha_hp.total_cycles}-cycle cut {ha_final} "
                   f"in {SA_CYCLES} cycles ({wall:.3f}s)")
    print(f"[convergence] K2000, 100 trials: {ha_txt}; {sa_txt}")
    return wall


def phase_pt():
    """Phase 30: anneal_pt and anneal_pt_ssa (dense backend) on the K2000
    twin, on the card equal to the port's CPU run; then one
    AnnealService.solve of an SA group and a PT-SSA group on the dense
    backend and an SA group on the cuda backend — no kernel launched, equal
    to the same solve on the CPU — and a PT-SSA request rejected at
    admission by the cuda service."""
    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.pt import PTHyperParams, PTSSAHyperParams, anneal_pt, anneal_pt_ssa
    from repro_torch.core.sa import SAHyperParams
    from repro_torch.serve import AdmissionError, AnnealRequest, AnnealService

    p = gset.load("K2000")
    hp = PTHyperParams(n_replicas=8, n_cycles=PT_CYCLES, swap_interval=100)
    ps = PTSSAHyperParams(n_replicas=8, n_rounds=PTSSA_ROUNDS, tau=100)
    runs = (("pt", lambda d: anneal_pt(p, hp, seed=0, device=d)),
            ("pt-ssa dense", lambda d: anneal_pt_ssa(p, ps, seed=0, backend="dense", device=d)))
    for name, run in runs:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.time()
        got = run("cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        _counters_zero(name, _counts())
        t0 = time.time()
        want = run("cpu")
        t_cpu = time.time() - t0
        if not (np.array_equal(got.best_energy, want.best_energy)
                and np.array_equal(got.best_m, want.best_m)
                and (got.energy_min is None
                     or np.array_equal(got.energy_min, want.energy_min))):
            _fail(f"{name}: the card's run differs from the CPU run")
        cycles = hp.n_cycles if name == "pt" else ps.total_cycles
        print(f"[{name}] K2000, 8 replicas, {cycles} cycles: best cut "
              f"{int(np.max(got.best_cut))}; card {wall:.3f}s == CPU ({t_cpu:.3f}s); "
              f"no kernel launched")
    reqs = [AnnealRequest(problem=p, hp=SAHyperParams(n_trials=100, n_cycles=SA_CHECK_CYCLES),
                          seed=0),
            AnnealRequest(problem=p, hp=ps, seed=0)]
    resp, wall, counts, _ = _service_solve(AnnealService(backend="dense", noise="xorshift"),
                                           reqs, "service SA + PT-SSA, dense")
    _counters_zero("service SA + PT-SSA", counts)
    cpu = AnnealService(backend="dense", noise="xorshift", device="cpu").solve(reqs)
    (sa_cuda,), _, counts_cuda, _ = _service_solve(
        AnnealService(backend="cuda", noise="xorshift"), reqs[:1], "service SA, cuda")
    _counters_zero("service SA on the cuda backend", counts_cuda)
    for what, r, w in (("SA", resp[0], cpu[0]), ("PT-SSA", resp[1], cpu[1]),
                       ("SA on cuda", sa_cuda, cpu[0])):
        if r.status != "ok" or not (np.array_equal(r.result.best_energy, w.result.best_energy)
                                    and np.array_equal(r.result.best_m, w.result.best_m)):
            _fail(f"service {what}: differs from the CPU solve (status {r.status!r})")
    try:
        AnnealService(backend="cuda", noise="xorshift").solve(reqs[1:])
    except AdmissionError as e:
        print(f"[service PT-SSA, cuda] rejected at admission: {e}")
    else:
        _fail("service: a PT-SSA request on backend='cuda' was not rejected")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.kernels.ssa_update  # noqa: F401 — fails alone, before any output
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: exact f32
    dev = torch.device("cuda")
    card = phase_card()
    phase_build()
    k3 = phase_k3(dev)
    k1 = phase_k1(dev)
    phase_threefry(dev)
    k4 = phase_k4(dev)
    streamed, (k1_launches, _, _, _), streamed_peak, streamed_wall = phase_anneal("production")
    _, (_, k3_launches, _, _), _, _ = phase_anneal("trace")
    _, (_, _, k4_launches, _), _, _ = phase_anneal("threefry-pregen")
    _, _, pregen_peak, _ = phase_anneal("xorshift-pregen", streamed=streamed)
    print(f"[memory] peak device memory of one anneal() call, xorshift: pregen "
          f"{pregen_peak} B, streamed {streamed_peak} B")
    phase_memory()
    k2 = phase_k2(dev)
    k2_launches = phase_popcount_anneal("K2000", k1_run=streamed, peak_below_j=True)
    phase_popcount_anneal("G11")
    k1_ring = phase_k1_ring(dev)
    k2_ring = phase_k2_ring(dev)
    k1_ring_launches, k2_ring_launches = phase_ssqa_anneal()
    phase_bench_ssqa()
    phase_profile()
    problems, reqs, k1_resp, k1_service, k4_service = phase_service()
    k2_service = phase_service_popcount(problems, reqs, k1_resp)
    k1_ring_service, k2_ring_service = phase_service_ssqa()
    k2_tiled_service = phase_service_tiled()
    phase_service_fallback(problems, reqs, k1_resp)
    s_problems, s_reqs, s_resp, k1_stream = phase_stream()
    k2_stream, k1_ring_stream, k2_ring_stream = phase_stream_k2_and_rings(s_problems, s_reqs)
    phase_checkpoints(problems, reqs, k1_resp, s_problems, s_reqs, s_resp)
    phase_stream_traffic()
    fam = phase_families()
    k1_fam_service, k2_fam_service, k1_fam_stream, k2_fam_stream = phase_families_service(fam)
    phase_sa(streamed_wall)
    phase_pt()
    k1_fam = {k: fam[k][2] for k, _, field in FAMILIES if field == "dense"}
    k2_fam = {k: fam[k][2] for k, _, field in FAMILIES if field == "popcount"}
    kernels = [
        dict(name="ssa_plateau_packed (K1)", route="cuda",
             source="src/repro_torch/kernels/csrc/plateau.cu",
             replaces="src/repro/kernels/ssa_update.py:329",
             launches=k1_launches,
             service_launches={"service K1": k1_service, "service families": k1_fam_service},
             stream_launches={"stream K1": k1_stream, "stream families": k1_fam_stream},
             family_launches=k1_fam, **k1),
        dict(name="local_field (K3)", route="cuda",
             source="src/repro_torch/kernels/csrc/field.cu",
             replaces="src/repro/kernels/ssa_update.py:90",
             launches=k3_launches, service_launches={}, stream_launches={},
             family_launches={}, **k3),
        dict(name="ssa_plateau (K4)", route="cuda",
             source="src/repro_torch/kernels/csrc/plateau_pregen.cu",
             replaces="src/repro/kernels/ssa_update.py:150",
             launches=k4_launches, service_launches={"service K4": k4_service},
             stream_launches={}, family_launches={}, **k4),
        dict(name="ssa_plateau_popcount (K2)", route="cuda",
             source="src/repro_torch/kernels/csrc/popcount.cu",
             replaces="src/repro/kernels/ssa_update.py:668",
             launches=k2_launches,
             service_launches={"service K2": k2_service,
                               "service tiled K2": k2_tiled_service,
                               "service families": k2_fam_service},
             stream_launches={"stream K2": k2_stream, "stream families": k2_fam_stream},
             family_launches=k2_fam, **k2),
        dict(name="ssa_plateau_packed ring mode (K1, SSQA)", route="cuda",
             source="src/repro_torch/kernels/csrc/plateau.cu",
             replaces="src/repro/kernels/ssa_update.py:329",
             launches=k1_ring_launches,
             service_launches={"service SSQA dense field": k1_ring_service},
             stream_launches={"stream SSQA dense field": k1_ring_stream},
             family_launches={}, **k1_ring),
        dict(name="ssa_plateau_popcount ring mode (K2, SSQA)", route="cuda",
             source="src/repro_torch/kernels/csrc/popcount.cu",
             replaces="src/repro/kernels/ssa_update.py:668",
             launches=k2_ring_launches,
             service_launches={"service SSQA popcount": k2_ring_service},
             stream_launches={"stream SSQA popcount": k2_ring_stream},
             family_launches={}, **k2_ring),
    ]
    print(card)  # again, so that it stands in the last lines of the output
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
