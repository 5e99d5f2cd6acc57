"""Chip smoke test of the PyTorch/CUDA port: builds the CUDA kernels from the
sources in this checkout, holds each against its plain PyTorch version on
the card, drives ``repro_torch.core.ssa.anneal`` and
``repro_torch.core.ssqa.anneal_ssqa`` at K2000 width,
``repro_torch.serve.AnnealService.solve`` at B > 1 and
``repro_torch.serve.StreamingAnnealService`` (with chunk checkpoints)
through the kernels, the problem families (QUBO, MIS, coloring, partition)
through K1 and K2, the SA, PT and PT-SSA baselines, spin sharding over
``torch.distributed`` ranks (the plain loops: no kernel on that path), J in
each of seven dtypes and SSQA rings above 32 replicas, the LM
substrate's serving and training paths (qwen3-1.7b at full width; no
kernel on either) and the fused iteration steps of
``repro_torch.core.distributed`` (no kernel either), alone and on a
``data`` × ``model`` mesh with their dry-run lowerings, the LM served and
trained on such a mesh with its dry-run (no kernel), and prints what it
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
     variant), forced cluster sizes 1 (streamed) and 16, N = 74601 in
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
     CPU at 2,000 cycles; 20,000 cycles on the card (cut from Table II's
     90,000; no kernel; wall and the host key chain timed);
     ``[convergence]``: cycles and wall
     for HA-SSA to reach SA's final cut and for SA to reach HA-SSA's
     6000-cycle cut (measured, not gated);
 30. PT (cut 90,000 → 20,000 cycles) and PT-SSA on the dense backend (cut
     60 → 5 rounds) on the K2000 twin, the card equal to the CPU; one
     AnnealService.solve of an SA and a PT-SSA group on the dense backend
     and an SA group on the cuda backend — no kernel launched (K1–K4
     counters unchanged), equal to the CPU solve — and a PT-SSA request
     rejected at admission by the cuda service;
 31. spin sharding (``partition='spin'``) on a one-rank NCCL mesh:
     anneal(K2000, 100 trials, tau=100, I0 1→32, m_shot 1) with the
     popcount field in the packed layout equal to the K2 run, and with the
     tiled float32 field in the dense layout equal to the production K1
     run, neither launching K1–K4; wall, ms per cycle, collectives per
     cycle and peak device bytes printed;
 32. the spin service: a 40,000-spin toroidal instance (bucket 65,536)
     rejected by the problem-partitioned service and answered 'ok' by the
     spin service, equal to the batched dense backend (tiled J) at the same
     bucket; killed at chunk 2 and resumed, bit-identical; one K2000
     request through the stream under spin equal to its one-shot spin
     solve (and to phase 31's K2 run); wall, J's row-shard bytes and peak
     device bytes printed;
 33. two gloo ranks sharing the card (subprocesses) rerun phase 31's
     popcount run, shards of 1000 spins (not whole words), equal to it;
     the busiest rank's resident bytes at bucket 4096 for P = 1 and 2,
     measured, not asserted (the ranks share the SMs: no speed is read);
 34. backend='auto': the crossover sweep behind ``engine.MIN_RESIDENT_N``
     (``benchmarks/crossover.py``: dense against cuda through anneal() and
     a B = 4 service solve, n = 16 … 2048, measured, the derived threshold
     printed beside the constant); 'auto' at K2000 launches K1 m_shot ×
     steps times and equals phase 6, below the threshold it launches
     nothing and equals the dense backend;
 35. j_dtype: K1, K1's ring mode, K3 and K4 with J in each of bfloat16,
     float16, int8, uint8, int16 and int32 (``J_DTYPES``: weights the
     dtype rounds, or 13-bit weights int8 and uint8 wrap), each equal to
     its plain version, timed with their bounds; production, trace and
     xorshift pregen anneal(K2000) with a bfloat16 J (K1, K3, K4 only),
     equal to phases 6/7 and to the dense backend's bfloat16 run, the
     production peak device bytes below phase 6's; partition's 13-bit J on
     K1, equal to the dense backend's bfloat16 run; the service K1 group,
     equal to phase 18 — peak device bytes beside the float32 runs'; then
     an int8 J: production (peak below the bfloat16 run's), trace (K3),
     xorshift pregen (K4) and anneal_ssqa (K1 ring), each equal to the
     dense backend's int8 run; partition with int16 (equal to float32) and
     int8 (wrapped, equal to the dense int8 run); the service K1 group;
 36. the paper: Table IV (``benchmarks/memory_table.py``, its 15% gate
     enforced), Fig. 7/9 and 8/10 on G11–G13 and Fig. 12 on G11
     (``convergence``, ``histograms``, ``equal_temp``) at 100 trials on
     backend='auto', cut to 3,000 cycles (Fig. 7–10) and 6,000 (Fig. 12);
 37. rings above 32 replicas (``[ring > 32]``): K1's and K2's ring modes
     equal to their plain versions, all five outputs, at K2000 width
     (K1: C = 100; K2: one Table II chain, C = 600) for 128 trials in rings
     of 64 and in one of 128, 100 in one ring of 100 and 66 in rings of 33,
     K1 at N = 16384 in rings of 64 (C = 4: the ring's words in global
     memory) and K2 at N = 30000 in one ring of 64 (planes and words in
     global memory) — each line with its cluster size, blocks, where the
     words live, kernel and plain times and the bound; anneal_ssqa(K2000,
     128 trials in rings of 64, m_shot 2) on the cuda backend with the
     dense field (K1's ring mode) and popcount (K2's), each equal to the
     dense backend; the same request to AnnealService(backend='auto'),
     equal to it;
 38. PT-SSA under 'auto' (``[pt-ssa auto]``): a request at bucket 64 on
     the card, no launch, equal to the dense service's run;
 39. the LM substrate's serving path (``[lm …]``; none of the six kernels
     is on it, and none launches): qwen3-1.7b at full width (28 layers,
     d_model 2048, vocab 151,936; random weights from ``init_params``)
     through ``repro_torch.serve.lm.generate`` — 4 prompts of 128 tokens,
     32 new tokens, greedy twice (equal tokens) and at temperature 1.0;
     every logit finite; each greedy token the argmax of the teacher-forced
     ``forward`` wherever the margin clears the tolerance; prefill ms, ms
     per decode step, tokens/s and peak device bytes (measured, not
     asserted); the same model cut to 2 layers, card against the CPU run of
     the port; each of the ten reduced configs' prefill, decode and
     generate, card against CPU;
 40. the LM substrate's training path (``[lm train …]``; none of the six
     kernels is on it, and none launches): qwen3-1.7b at full width
     (``remat="full"``) through ``repro_torch.launch.train.train`` — 4
     AdamW steps of 8 × 512 tokens, no checkpoint: each step's ce_loss,
     grad_norm and lr finite, opt.step 4, ms a step after the first,
     tokens/s, peak device bytes and init (measured, not asserted) beside
     the bound; the same widths cut to 2 layers (B = 2, S = 16) and each of
     the ten reduced configs (phase 39's requests, labels the next token):
     one step's loss and gradients on the card against the port's CPU run,
     and ``adamw_update`` of the card's gradients on both devices;
     determinism and resume on the card (tests/test_ft.py's config: two
     20-step runs equal, a run killed at step 13 and resumed from step 10
     equal to them) and 30 steps lowering the loss by more than 0.4;
 41. step 8's fused iteration steps (``[iteration step …]``;
     ``core/distributed.py``, no kernel: the K1–K4 counters must stay 0):
     (a) Table II at K2000 (100 trials, τ = 100, I0 1→32, m_shot 10)
     through ``make_iteration_step`` from the state anneal() seeds — final
     best_H and best_m equal to phase 6's K1 run; ms an iteration issued
     from Python and with the step captured once in a CUDA graph and
     replayed (its outputs equal to the issued run's; a capture that fails
     is printed and not measured), peak device bytes, the bound; (b) the
     JAX package's single lowering cell, N = 2000, T = 4096, one
     iteration, the same numbers, best_m's energy equal to best_H; (c)
     its batched cell, B = 8, T = 512, N = 2048 (eight 4-regular
     tori, seeds 0–7; τ cut to 50: at 100 the popcount form takes ~33 s),
     one iteration of ``make_batched_iteration_step`` in each of the
     dense, packed, tiled (tile_n 512) and popcount forms — all
     equal per problem in every leaf, problem 0 equal to the single step —
     ms and peak device bytes per form;
 42. the iteration steps on a ``data`` × ``model`` mesh (``[mesh step …]``,
     ``[mesh lowering …]``; no kernel): (a) phase 41's K2000 chain through
     ``make_iteration_step`` on a one-rank 1 × 1 NCCL mesh
     (``launch.mesh.make_mesh``, blocks cut and joined by
     ``convert.iteration_state_block`` / ``_join``) — every leaf equal to
     phase 41's mesh=None run; ms an iteration issued from Python, the
     collectives an iteration, peak device bytes; (b) two gloo ranks
     sharing the card as meshes of 1 × 2 and 2 × 1, one iteration of the
     single step and of the batched step in four forms (B = 2 complete
     graphs of 2000 spins, 100 trials), joined and equal to mesh=None in
     every leaf; (c) ``anneal_step_lowering`` (N = 2000, T = 4096) and
     ``batched_anneal_step_lowering`` (B = 8, T = 512, N = 2048, four forms)
     at abstract 16 × 16 and 2 × 16 × 16 meshes, traced on fake tensors in
     worker processes while (b) runs: per device the argument bytes, the
     peak estimate, FLOPs, collective bytes by kind and the roofline terms
     of ``launch/hlo_analysis.py`` on the H100 with the dominant one; (d)
     the lowering at 1 × 1 of phase 41's cells (a) and (b): its compute
     term at 67 TFLOP/s equal to phase 41's bound within 0.1%, its peak
     estimate beside phase 41's measured peak;
 43. the LM served on a ``data`` × ``model`` mesh (``[lm mesh …]``; no
     kernel): (a) qwen3-1.7b at full width through ``generate()`` (4 × 128
     + LM_MESH_NEW) on a one-rank 1 × 1 NCCL mesh — the greedy tokens equal
     to mesh=None's, prefill and decode logits within LM_STEPS_DEEP bf16
     steps; (b) two
     gloo ranks sharing the card as 1 × 2 (model-parallel), each holding
     its half of the split weights (``convert.lm_params_block``): prefill
     and LM_MESH_STEPS decode steps fed mesh=None's greedy tokens within
     LM_STEPS_DEEP bf16 steps of mesh=None's logits, ``generate()``'s
     tokens equal to mesh=None's up to a near tie; ms a decode step,
     collectives a step, peak device bytes per rank; (c) the serving
     dry-run (``launch.dryrun.run_cell``) of qwen3-1.7b at prefill_32k and
     decode_32k on the abstract 16 × 16 and 2 × 16 × 16 meshes, traced in
     worker processes while (a) and (b) run: per device the argument bytes, the
     peak estimate, FLOPs, collective bytes and the three H100 roofline
     terms;
 44. the LM trained on a ``data`` × ``model`` mesh (``[lm train mesh …]``;
     no kernel): (a) phase 40's 4 AdamW steps of qwen3-1.7b at full width
     (8 × 512, remat "full", seed 0) through ``make_train_step(mesh=)`` on a
     one-rank 1 × 1 NCCL mesh — each step's ce_loss, grad_norm and lr equal
     to phase 40's and every final parameter and moment leaf equal to
     phase 40's bit for bit (digests of the bits taken on the card); ms a
     step beside phase 40's, the collectives a step, peak device bytes;
     (b) two gloo ranks sharing the card as 1 × 2 and 2 × 1, qwen3-1.7b's
     widths cut to 2 layers, B = 4, S = 128, each rank holding its blocks
     (``convert.train_state_block``): its gradient blocks within GRAD_STEPS
     bf16 steps of the mesh=None run's on the card, its ZeRO-1 update of
     the joined gradients equal to mesh=None's bit for bit (the clip not
     acting), at 2 × 1 half the moment bytes of every leaf ZeRO-1 cuts; ms
     a step, collectives by kind and peak bytes per rank; (c) the train
     dry-run (``launch.dryrun.run_cell``) of qwen3-1.7b at train_4k on the
     abstract 16 × 16 and 2 × 16 × 16 meshes: per device the argument
     bytes, the peak estimate, FLOPs, collective bytes by kind, the three
     H100 terms with the dominant one and ``useful_flops_ratio``.  The
     dry-run traces of phases 43 and 44 start before phase 39, in two
     worker processes;
 45. the card line again, the kernels line (each kernel's service launches
     in ``service_launches``, its stream launches in ``stream_launches``,
     its launches per family of phase 27 in ``family_launches``, those of
     phases 34–36 in ``auto_launches``, ``j_dtype_launches`` and
     ``paper_launches``, its bfloat16-J row in ``bf16``, its rows by J
     dtype in ``j_dtypes`` and, for the ring modes, its rows by ring in
     ``rings``: ring size, cluster size, blocks, where the words live,
     times, bound and the launches of phase 37's run); 46. the contract
     line (last).
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
# Dense bfloat16 tensor-core operations (the same data sheet).
PEAK_BF16_FLOPS = 989e12
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
    each = ", ".join(f"{k} {v:.1f}s" for k, v in _build.build_seconds.items())
    print(f"[build] {_build.SOURCES} built for sm_90a in {time.time() - t0:.1f}s ({each})")
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


def _plateau_inputs(gen, R, N, dev, dtype=torch.float32, flat=False, J=None):
    """Random plateau inputs; ``flat`` zeroes J and h so every energy ties
    and only keeping the first minimum matches; ``J`` (N, N) replaces the
    random ±1 coupling."""
    from repro_torch.core.rng import xorshift_init
    from repro_torch.kernels.bitplane import pack_spins

    m = _spins(gen, (1, R, N), dev)
    bm = _spins(gen, (1, R, N), dev)
    return dict(
        m_packed=pack_spins(m),
        itanh=torch.randint(-8, 8, (1, R, N), generator=gen, dtype=torch.int32).to(dev),
        J=(_coupling(gen, N, dtype, dev) if J is None else J)[None] * (not flat),
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
             (1, 3, 74601, 0, 2, "all", False, 1)]
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
                                         N, SSQA_RING, cs, 0, 0)  # float32 J, words shared
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
    Returns (problems, requests, responses, launches of K1 and of K4, the
    first solve's peak device bytes)."""
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
    resp, wall, counts, peak = _service_solve(svc, reqs, "service K1")
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
    return problems, reqs, resp, counts[0], counts4[2], peak


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
            key = [k for k in z.files if k.lstrip(".").startswith("noise_state")][0]
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
# SA, PT and PT-SSA are cut to fit the run's time: SA and PT from Table II's
# 90,000 to 20,000 cycles, PT-SSA 60 → 5 rounds of 100.  The CPU bit-identity
# check of SA and the service groups run 2,000 cycles.
SA_CYCLES, SA_CHECK_CYCLES = 20_000, 2_000
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
    equal to the port's CPU run at SA_CHECK_CYCLES; at SA_CYCLES cycles
    (cut from Table II's 90,000) on the card (no kernel launched; the host
    key chain timed); and the paper's convergence comparison against
    HA-SSA, measured, not gated."""
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


# ---------------------------------------------------------------------------
# Phases 31-33: spin sharding (partition='spin'), no kernel on its path
# ---------------------------------------------------------------------------
# Table II's widths at K2000 with m_shot cut to 1 (600 cycles); the 40,000-spin
# row of the JAX repo's benchmarks/scale.py.
SPIN_HP = dict(n_trials=100, m_shot=1, tau=100, i0_min=1, i0_max=32)
BIG_N, BIG_HP = 40_000, dict(n_trials=2, m_shot=4, tau=4, i0_min=1, i0_max=4)


def _spin_cfg(mesh, field, layout, spin=True):
    from repro_torch.core.config import SolverConfig

    kw = dict(partition="spin", mesh=mesh) if spin else {}
    return SolverConfig(backend="cuda", noise="xorshift", field_mode=field,
                        storage_layout=layout, **kw)


def _spin_anneal(p, hp, cfg, what):
    """One spin-sharded anneal() on the card: (result, wall s, collectives,
    peak device bytes), K1–K4 never launched."""
    from repro_torch import sharding
    from repro_torch.core.ssa import anneal

    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    sharding.reset_collective_counts()
    t0 = time.time()
    r = anneal(p, hp, seed=0, track_energy=False, config=cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    _counters_zero(what, _counts())
    return r, wall, dict(sharding.collective_counts), torch.cuda.max_memory_allocated() - live


def _same_result(what, got, want):
    import numpy as np

    if not (np.array_equal(got.best_energy, want.best_energy)
            and np.array_equal(got.best_m, want.best_m)):
        _fail(f"{what}: differs from its reference run")


def phase_spin_anneal(mesh):
    """Phase 31: K2000 at Table II's widths (m_shot 1) spin-sharded over a
    one-rank NCCL mesh, popcount (packed) against K2 and tiled (dense)
    against K1; returns the popcount run's result."""
    from repro_torch.core import gset
    from repro_torch.core.ssa import SSAHyperParams, anneal

    p = gset.load("K2000")
    hp = SSAHyperParams(**SPIN_HP)
    cycles = hp.total_cycles
    anneal(p, dataclasses.replace(hp, tau=2), seed=0, track_energy=False, device="cuda",
           config=_spin_cfg(mesh, "popcount", "packed"))  # warm-up: the communicator
    out = {}
    for field, layout, kernel, want in (("popcount", "packed", "K2", (0, 0, 0, 1, 0, 0)),
                                        ("dense", "dense", "K1", (hp.steps, 0, 0, 0, 0, 0))):
        _reset_counts()
        ref = anneal(p, hp, seed=0, track_energy=False, device="cuda",
                     config=_spin_cfg(mesh, field if field == "popcount" else "auto",
                                      "packed", spin=False))
        _expect(f"spin reference {kernel}", _counts(), want)
        r, wall, coll, peak = _spin_anneal(p, hp, _spin_cfg(mesh, field, layout),
                                           f"spin anneal {field}")
        _same_result(f"spin anneal {field} vs {kernel}", r, ref)
        style = "popcount" if field == "popcount" else "tiled"
        print(f"[spin anneal] K2000 {style} field, {layout} layout, P=1 ({mesh.backend}): "
              f"== the {kernel} run (best_H, best_m); best cut {r.overall_best_cut}; wall "
              f"{wall:.3f}s, {wall / cycles * 1e3:.3f} ms per cycle, collectives per cycle "
              f"{sum(coll.values()) / cycles:.3f} ({coll}), peak device memory {peak} B; "
              f"no K1-K4 launch")
        out[field] = r
    return out["popcount"]


def phase_spin_service(mesh, k2_run):
    """Phase 32: the 40,000-spin instance through the problem-partitioned
    service (rejected) and the spin service (tiled J, equal to the batched
    dense backend driven directly); a kill at chunk 2 and a resume; one
    K2000 request through the stream under spin."""
    import tempfile

    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.engine import make_batched_backend, schedule_plateaus
    from repro_torch.core.memory import tree_device_bytes
    from repro_torch.core.ssa import SSAHyperParams
    from repro_torch.ft.faults import FaultInjector, InjectedKill
    from repro_torch.serve import (AdmissionError, AnnealRequest, AnnealService,
                                   ResiliencePolicy, StreamingAnnealService)

    big = gset.toroidal_grid(BIG_N, seed=5, name="bigN")
    hp = SSAHyperParams(**BIG_HP)
    req = AnnealRequest(problem=big, hp=hp, seed=1)
    try:
        AnnealService(backend="dense", noise="xorshift").solve([req])
    except AdmissionError as e:
        print(f"[spin service] problem-partitioned service rejects N={big.n}: {e}")
    else:
        _fail("spin service: the problem-partitioned service admitted a 40,000-spin instance")

    def spin_service(**kw):
        return AnnealService(backend="dense", noise="xorshift", partition="spin", mesh=mesh,
                             backend_opts={"field_mode": "dense"}, **kw)

    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.time()
    (resp,) = spin_service().solve([req])
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - live
    _counters_zero("spin service", _counts())
    if resp.status != "ok" or resp.events:
        _fail(f"spin service: {resp.status!r}, events {resp.events}")
    model = big.to_ising()
    nb = resp.bucket
    ref_bk = make_batched_backend("dense", n_bucket=nb, n_trials=hp.n_trials, noise="xorshift",
                                  j_mode="tiled", device="cuda")
    prob = ref_bk.stack([model])
    st = ref_bk.init_state(prob, ref_bk.init_noise([1], [model.n]))
    st = ref_bk.run_shots(prob, st, schedule_plateaus(hp.schedule("hassa"), "i0max"), hp.m_shot)
    bh, bm = (t.cpu().numpy() for t in ref_bk.finalize(st))
    if not (np.array_equal(resp.result.best_energy, bh[0])
            and np.array_equal(resp.result.best_m, bm[0, :, :model.n])):
        _fail("spin service: differs from the batched dense backend (tiled J)")
    shard = make_batched_backend("dense", n_bucket=nb, n_trials=hp.n_trials, noise="xorshift",
                                 partition="spin", mesh=mesh, field_mode="dense")
    shard_bytes = tree_device_bytes(shard.stack([model]))
    print(f"[spin service] N={big.n} bucket {nb}, {hp.n_trials} trials, m_shot {hp.m_shot}, "
          f"tau {hp.tau}: 'ok', == the batched dense backend (tiled J); best cut "
          f"{resp.result.overall_best_cut}; wall {wall:.3f}s, J's row shard (adjacency rows "
          f"and h) {shard_bytes} B, peak device memory {peak} B")
    with tempfile.TemporaryDirectory() as tmp:
        pol = ResiliencePolicy(checkpoint_dir=tmp)
        inj = FaultInjector()
        inj.arm("kill", chunk=2)
        try:
            spin_service(resilience=pol, faults=inj).solve([req])
        except InjectedKill:
            pass
        else:
            _fail("spin service: the kill at chunk 2 did not fire")
        t0 = time.time()
        (res,) = spin_service(resilience=pol).solve([req])
        torch.cuda.synchronize()
        t_res = time.time() - t0
    if [e.kind for e in res.events] != ["resume"]:
        _fail(f"spin service: resume events {res.events}")
    _same_result("spin service kill/resume", res.result, resp.result)
    print(f"[spin service] killed at chunk 2 and resumed: bit-identical ({t_res:.3f}s)")

    p = gset.load("K2000")
    k_req = AnnealRequest(problem=p, hp=SSAHyperParams(**SPIN_HP), seed=0)
    svc = AnnealService(backend="cuda", noise="xorshift", partition="spin", mesh=mesh,
                        storage_layout="packed", backend_opts={"field_mode": "auto"})
    _reset_counts()
    (one,) = svc.solve([k_req])
    ss = StreamingAnnealService(service=svc)
    t = ss.submit(k_req)
    t0 = time.time()
    ss.run_until_idle()
    torch.cuda.synchronize()
    s_wall = time.time() - t0
    _counters_zero("spin stream", _counts())
    got = t.result(timeout=0)
    _same_result("spin stream vs one-shot spin solve", got.result, one.result)
    _same_result("spin one-shot solve vs the K2 run", one.result, k2_run)
    print(f"[spin stream] K2000 under spin (popcount, packed): == its one-shot spin solve "
          f"== phase 31's K2 run; stream wall {s_wall:.3f}s, quanta "
          f"{ss.stats['stream_quanta']}; no K1-K4 launch")


def _spin_worker(rank: int, world: int, store: str, ref_path: str):
    """Phase 33's ranks: gloo over a file rendezvous, sharing the card."""
    import numpy as np
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import gset
    from repro_torch.core.engine import make_batched_backend
    from repro_torch.core.memory import max_device_bytes
    from repro_torch.core.ssa import SSAHyperParams, anneal
    from repro_torch.sharding import spin_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    mesh = spin_mesh(device="cuda")
    p = gset.load("K2000")
    hp = SSAHyperParams(**SPIN_HP)
    ref = np.load(ref_path)
    t0 = time.time()
    r = anneal(p, hp, seed=0, track_energy=False, device="cuda",
               config=_spin_cfg(mesh, "popcount", "packed"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    if not (np.array_equal(r.best_energy, ref["bh"]) and np.array_equal(r.best_m, ref["bm"])):
        raise SystemExit(f"rank {rank}: the P={world} run differs from phase 31's")
    bk = make_batched_backend("dense", n_bucket=4096, n_trials=hp.n_trials, noise="xorshift",
                              partition="spin", mesh=mesh)
    prob = bk.stack([p.to_ising()])
    st = bk.init_state(prob, bk.init_noise([0], [p.n]))
    busiest = max_device_bytes((prob, st), mesh)
    if rank == 0:
        print(f"SPIN_P{world} shard {-(-p.n // world)} spins, wall {wall:.3f}s, "
              f"busiest {busiest}", flush=True)
    dist.destroy_process_group()


def phase_spin_p2(mesh, k2_run):
    """Phase 33: two gloo ranks sharing the card rerun phase 31's popcount
    run; the busiest rank's bytes at bucket 4096 for P = 1 (this process)
    and P = 2, measured, not asserted."""
    import tempfile

    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.engine import make_batched_backend
    from repro_torch.core.memory import max_device_bytes

    p = gset.load("K2000")
    bk = make_batched_backend("dense", n_bucket=4096, n_trials=SPIN_HP["n_trials"],
                              noise="xorshift", partition="spin", mesh=mesh)
    prob = bk.stack([p.to_ising()])
    st = bk.init_state(prob, bk.init_noise([0], [p.n]))
    busiest1 = max_device_bytes((prob, st), mesh)
    del bk, prob, st
    with tempfile.TemporaryDirectory() as tmp:
        ref = str(Path(tmp) / "ref.npz")
        np.savez(ref, bh=k2_run.best_energy, bm=k2_run.best_m)
        store = str(Path(tmp) / "store")
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--spin-rank",
                                   str(r), "2", store, ref], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            outs = [pr.communicate(timeout=300) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        wall = time.time() - t0
    for r, (pr, (_, err)) in enumerate(zip(procs, outs)):
        if pr.returncode:
            _fail(f"spin P=2: rank {r} exited {pr.returncode}: {err[-1500:]}")
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith("SPIN_P2"))
    print(f"[spin P=2] two gloo ranks sharing the card (shards not whole words): == phase "
          f"31's popcount run; {line[len('SPIN_P2 '):]} B at bucket 4096 (P=1: {busiest1} B); "
          f"processes {wall:.3f}s; the ranks share the SMs, so no speed is read")


# ---------------------------------------------------------------------------
# backend='auto', j_dtype and the paper's figures
# ---------------------------------------------------------------------------
# The figures run at Table II's widths (100 trials) and are cut in cycles
# only: Fig. 7/9 and 8/10 from m_shot 150 to 5 (3,000 cycles), Fig. 12's
# 15,000-cycle window to 6,000.
PAPER_M_SHOT, PAPER_WINDOW = 5, 6_000


def _counted(fn):
    """(fn(), launches of (K1, K3, K4, K2, K1 ring, K2 ring) it made): the
    counters set to 0 just before the call and read just after."""
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _counts()


def _same(what, got, want, traces=False):
    import numpy as np

    keys = ("best_energy", "best_m") + (("energy_mean", "energy_min") if traces else ())
    for k in keys:
        if not np.array_equal(getattr(got, k), getattr(want, k)):
            _fail(f"{what}: {k} differs")


def phase_auto(streamed):
    """Phase 34: the crossover sweep behind MIN_RESIDENT_N
    (``benchmarks/crossover.py``: the dense backend against the cuda one,
    anneal() and a B = 4 service solve at Table II widths, m_shot 1, n = 16
    … 2048; measured, the derived threshold printed beside the constant,
    not gated), then backend='auto' on K2000 — K1 m_shot × steps times,
    equal to phase 6's 'cuda' run — and below the threshold — no launch,
    equal to the dense backend.  Returns the K2000 run's K1 launches."""
    from repro_torch.benchmarks import crossover
    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.engine import MIN_RESIDENT_N
    from repro_torch.core.ssa import anneal

    t0 = time.time()
    sweep = crossover.run(repeats=2)
    for row in sweep["rows"]:
        print(f"[auto] crossover n={row['n']} (service bucket {row['bucket']}): anneal() dense "
              f"{row['anneal_dense_s']:.4f}s, cuda {row['anneal_cuda_s']:.4f}s; service B=4 "
              f"dense {row['service_dense_s']:.4f}s, cuda {row['service_cuda_s']:.4f}s")
    print(f"[auto] derived threshold {sweep['threshold']}, MIN_RESIDENT_N {MIN_RESIDENT_N} "
          f"(the sweep took {time.time() - t0:.1f}s)")
    hp = _service_hp()
    auto = SolverConfig(backend="auto", noise="xorshift")
    t0 = time.time()
    r, counts = _counted(lambda: anneal(gset.load("K2000"), hp, seed=0, track_energy=False,
                                        config=auto, device="cuda"))
    print(f"[auto] K2000: wall {time.time() - t0:.3f}s, (K1, K3, K4, K2, K1 ring, K2 ring) "
          f"launches {counts}")
    _expect("auto K2000", counts, (hp.m_shot * hp.steps, 0, 0, 0, 0, 0))
    _same("auto K2000 against phase 6's cuda run", r, streamed)
    k1_auto = counts[0]
    small = gset.toroidal_grid(max(4, MIN_RESIDENT_N // 2), seed=3)
    r, counts = _counted(lambda: anneal(small, hp, seed=0, config=auto, device="cuda"))
    ref = anneal(small, hp, seed=0, config=SolverConfig(backend="dense", noise="xorshift"),
                 device="cuda")
    print(f"[auto] N={small.n} (below {MIN_RESIDENT_N}): launches {counts}, best cut "
          f"{r.overall_best_cut} == the dense backend's")
    _counters_zero(f"auto N={small.n}", counts)
    _same(f"auto N={small.n} against the dense backend", r, ref, traces=True)
    return k1_auto


def _wide_coupling(gen, n, dtype, device):
    """A symmetric J with weights up to ±5000, most of which bfloat16
    rounds (to multiples of 16 or 32): the kernels must read the rounded
    J as it is."""
    J = torch.triu(torch.randint(-5000, 5001, (n, n), generator=gen), 1)
    return (J + J.T).to(dtype).to(device)


# The J dtypes beside float32 (j_dtype), each with K1, K1's ring mode, K3
# and K4 instantiations; the integer ones take the partition family's
# 13-bit weights, which int8 and uint8 wrap.
J_DTYPES = ("bfloat16", "float16", "int8", "uint8", "int16", "int32")


def _dtype_coupling(gen, n, dtype, device):
    """A symmetric J in ``dtype`` the way the host holds it: weights up to
    ±5000 for the float types (bfloat16 rounds most of them, float16 those
    above 2048), 13-bit weights (±4095) for the integer types, wrapped by
    int8 and uint8 as the host's conversion wraps them."""
    if dtype.is_floating_point:
        return _wide_coupling(gen, n, dtype, device)
    J = torch.triu(torch.randint(-4095, 4096, (n, n), generator=gen), 1)
    return (J + J.T).to(dtype).to(device)


def _jdtype_kernels(dev, dtype):
    """K1, K1's ring mode, K3 and K4 with J in ``dtype`` at the main path's
    shapes, on weights the dtype rounds or wraps (_dtype_coupling; K3 also
    on J tiles of one to four byte planes where the dtype holds them): each
    equal to its plain version; kernel and plain times and the bound, with
    J's bytes at the dtype's width."""
    from repro_torch.kernels import ssa_update
    from repro_torch.kernels.ref import local_field_ref, ssa_plateau_packed_ref, ssa_plateau_ref

    name_of = str(dtype).replace("torch.", "")
    gen = torch.Generator().manual_seed(27)
    R, N, C = 100, 2000, 100
    nw = (N + 31) // 32
    jb = torch.empty((), dtype=dtype).element_size() * N * N  # J's bytes
    out = {}

    def check(name, got, want):
        err = max(_max_abs_err(g, w) for g, w in zip(got, want))
        if err:
            _fail(f"{name} with a {name_of} J differs from its plain version")
        return err

    # K3: the dtype's weights, then (where it holds them) tiles of one to
    # four byte planes.
    m = _spins(gen, (R, N), dev).to(torch.float32)
    h = torch.randint(-3, 4, (N,), generator=gen, dtype=torch.int32).to(dev)
    Js = [_dtype_coupling(gen, N, dtype, dev)]
    if dtype in (torch.bfloat16, torch.int32):
        Js.append(_mixed_plane_coupling(gen, N, dtype, dev))
    err = 0
    for J in Js:
        err = max(err, check("K3", [ssa_update.local_field(m, h, J)], [local_field_ref(m, h, J)]))
    J = _coupling(gen, N, dtype, dev)
    ms = _time_ms(lambda: ssa_update.local_field(m, h, J), reps=50)
    plain = _time_ms(lambda: local_field_ref(m, h, J), reps=50)
    graph = _graph_time_ms(lambda: ssa_update.local_field(m, h, J))
    bound, by = _bound_ms(4 * R * N + jb + 4 * N + 4 * R * N, 2 * R * N * N, PEAK_INT8_OPS)
    out["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                     graph_ms=graph)
    # K1, classical and ring mode.
    k1 = ssa_update.ssa_plateau_packed_batched
    for name, R_, kw in (("K1", R, {}),
                         ("K1 ring", SSQA_TRIALS, dict(jperp=SSQA_JPERP_MAX,
                                                       n_replicas=SSQA_RING))):
        x = _plateau_inputs(gen, R_, N, dev, dtype)
        xw = dict(x, J=_dtype_coupling(gen, N, dtype, dev)[None])
        kw = dict(i0=32, n_cycles=C, n_rnd=2, eligible=True, **kw)
        err = check(name, k1(**xw, **kw), ssa_plateau_packed_ref(**xw, **kw))
        ms = _time_ms(lambda: k1(**x, **kw), reps=5)
        plain = _time_ms(lambda: ssa_plateau_packed_ref(**x, **kw), reps=3)
        sb = 4 * (R_ * nw + R_ * N + 4 * R_ * N + R_ + R_ * nw)
        n_ops = 2 * R_ * N * N * (C + 1) + (2 * R_ * N * C if kw.get("n_replicas") else 0)
        bound, by = _bound_ms(jb + 4 * N + 2 * sb, n_ops)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
    # K4.
    k4 = ssa_update.ssa_plateau_batched
    x = _pregen_inputs(gen, 1, R, N, C, dev, dtype)
    xw = dict(x, J=_dtype_coupling(gen, N, dtype, dev)[None])
    kw = dict(i0=32, n_rnd=2, eligible=True)
    err = check("K4", k4(**xw, **kw), ssa_plateau_ref(**xw, **kw))
    ms = _time_ms(lambda: k4(**x, **kw), reps=5)
    plain = _time_ms(lambda: ssa_plateau_ref(**x, **kw), reps=3)
    sb = 4 * R * N + 4 * R * N + 4 * R + R * N
    bound, by = _bound_ms(jb + 4 * N + 2 * sb + C * R * N, 2 * R * N * N * (C + 1))
    out["K4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
    for name, row in out.items():
        extra = f", device time by CUDA graph {row['graph_ms']:.4f} ms" if "graph_ms" in row else ""
        print(f"[j_dtype] {name}, {name_of} J, main path's shape: kernel {row['ms']:.4f} ms"
              f"{extra}, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); equal to its plain version (max_abs_err 0)")
    return out


def _peak_run(fn):
    """(fn(), wall s, launches, peak device bytes of the call)."""
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out, counts = _counted(fn)
    return out, time.time() - t0, counts, torch.cuda.max_memory_allocated() - live


def phase_j_dtype(dev, streamed, streamed_peak, trace_peak, problems, reqs, k1_resp,
                  service_peak):
    """Phase 35: J held in a narrower dtype (``j_dtype``).  K1, K1's ring
    mode, K3 and K4 against their plain versions with J in each of
    J_DTYPES, on weights the dtype rounds or wraps, timed at the main
    path's shapes with their bounds.  A bfloat16 J: the production
    anneal(K2000) — K1 m_shot × steps times, equal to phase 6's float32 run
    and to the dense backend's bfloat16 run, its peak device bytes below
    phase 6's; the trace path (K3 only, traces equal to the dense backend's
    bfloat16 run) and xorshift pregen (K4 only, equal to phase 6);
    partition's 13-bit weights, which bfloat16 rounds, on K1 — equal to the
    dense backend's bfloat16 run; and the service K1 group (phase 18's
    requests) — equal to phase 18's responses.  An int8 J: the production
    anneal(K2000), equal to phase 6 and to the dense backend's int8 run, its
    peak below the bfloat16 run's; the trace path (K3), xorshift pregen
    (K4) and anneal_ssqa (K1's ring mode) at m_shot 2, each equal to the
    dense backend's int8 run; partition's weights on K1 with int16 (equal
    to the float32 run: int16 holds them) and int8 (wrapped: equal to the
    dense backend's int8 run); the service K1 group, equal to phase 18.
    Peak device bytes are printed beside the float32 runs'.  Returns
    (kernel rows by dtype, launches by kernel)."""
    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.ssa import anneal
    from repro_torch.core.ssqa import anneal_ssqa
    from repro_torch.problems import make_demo
    from repro_torch.serve import AnnealService

    rows = {name: _jdtype_kernels(dev, getattr(torch, name)) for name in J_DTYPES}
    hp = _service_hp()
    plateaus = hp.m_shot * hp.steps
    p = gset.load("K2000")

    def cfg(backend, dtype=torch.bfloat16, **kw):
        return SolverConfig(backend=backend, noise="xorshift", backend_opts={"j_dtype": dtype},
                            **kw)

    def run(problem, c, h=hp, track=False):
        return _peak_run(lambda: anneal(problem, h, seed=0, track_energy=track, config=c,
                                        device="cuda"))

    anneal(p, dataclasses.replace(hp, m_shot=1), seed=0, track_energy=False,
           config=cfg("cuda"), device="cuda")  # warm-up: the bfloat16 shapes' queries
    r, wall, counts, peak = run(p, cfg("cuda"))
    print(f"[j_dtype] production K2000, bfloat16 J: wall {wall:.3f}s, launches {counts}, peak "
          f"device memory of the call {peak} B (float32 J, phase 6: {streamed_peak} B)")
    _expect("j_dtype production", counts, (plateaus, 0, 0, 0, 0, 0))
    _same("j_dtype production against phase 6's float32 run", r, streamed)
    _same("j_dtype production against the dense backend", r,
          anneal(p, hp, seed=0, track_energy=False, config=cfg("dense"), device="cuda"))
    if not peak < streamed_peak:
        _fail(f"j_dtype: peak device bytes {peak} not below the float32 run's {streamed_peak}")
    bf16_peak = peak
    launches = {"K1": {"j_dtype production": counts[0]}}

    h2 = dataclasses.replace(hp, m_shot=M_SHOT_TRACE)
    r, wall, counts, peak = run(p, cfg("cuda"), h2, track=True)
    print(f"[j_dtype] trace path K2000, bfloat16 J: wall {wall:.3f}s, launches {counts}, peak "
          f"{peak} B (float32 J, phase 7: {trace_peak} B)")
    if counts[1] == 0 or counts[0] or counts[2]:
        _fail(f"j_dtype trace path: expected K3 only, got {counts}")
    _same("j_dtype trace path against the dense backend", r,
          anneal(p, h2, seed=0, config=cfg("dense"), device="cuda"), traces=True)
    launches["K3"] = {"j_dtype trace": counts[1]}

    r, wall, counts, peak = run(p, cfg("cuda", noise_mode="pregen"))
    print(f"[j_dtype] xorshift pregen K2000, bfloat16 J: wall {wall:.3f}s, launches {counts}, "
          f"peak {peak} B")
    _expect("j_dtype pregen", counts, (0, 0, plateaus, 0, 0, 0))
    _same("j_dtype pregen against phase 6's run", r, streamed)
    launches["K4"] = {"j_dtype xorshift pregen": counts[2]}

    enc = make_demo("partition", n=2000, seed=0)
    f32, _, _, peak32 = run(enc, SolverConfig(backend="cuda", noise="xorshift"))
    r, wall, counts, peak = run(enc, cfg("cuda"))
    ref = anneal(enc, hp, seed=0, track_energy=False, config=cfg("dense"), device="cuda")
    rounded = not (f32.best_energy == r.best_energy).all()
    print(f"[j_dtype] partition (13-bit J, {enc.model.n} spins), bfloat16 J on K1: wall "
          f"{wall:.3f}s, launches {counts}, peak {peak} B (float32 J: {peak32} B); best energy "
          f"{int(r.best_energy.min())} (float32 J: {int(f32.best_energy.min())}; the rounding "
          f"changed the run: {rounded}) == the dense backend's bfloat16 run")
    _expect("j_dtype partition", counts, (plateaus, 0, 0, 0, 0, 0))
    _same("j_dtype partition against the dense backend", r, ref)
    launches["K1"]["j_dtype partition"] = counts[0]

    svc = AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                        chunk_shots=5, backend_opts={"j_dtype": torch.bfloat16})
    resp, wall, counts, peak = _service_solve(svc, reqs, "j_dtype service K1 (bfloat16 J)")
    print(f"[j_dtype] service K1, bfloat16 J: peak {peak} B (float32 J, phase 18: "
          f"{service_peak} B)")
    _expect("j_dtype service K1", counts, (2 * plateaus, 0, 0, 0, 0, 0))
    _check_service("j_dtype service K1", resp, [x.result for x in k1_resp], problems)
    launches["K1"]["j_dtype service K1"] = counts[0]

    # An int8 J: K2000's ±1 weights are exact in it.
    i8 = torch.int8
    anneal(p, dataclasses.replace(hp, m_shot=1), seed=0, track_energy=False,
           config=cfg("cuda", i8), device="cuda")  # warm-up: the int8 shapes' queries
    r, wall, counts, peak = run(p, cfg("cuda", i8))
    print(f"[j_dtype] production K2000, int8 J: wall {wall:.3f}s, launches {counts}, peak "
          f"device memory of the call {peak} B (float32 J, phase 6: {streamed_peak} B; "
          f"bfloat16 J: {bf16_peak} B)")
    _expect("int8 production", counts, (plateaus, 0, 0, 0, 0, 0))
    _same("int8 production against phase 6's float32 run", r, streamed)
    _same("int8 production against the dense backend", r,
          anneal(p, hp, seed=0, track_energy=False, config=cfg("dense", i8), device="cuda"))
    if not peak < bf16_peak:
        _fail(f"j_dtype: the int8 run's peak {peak} B is not below the bfloat16 run's "
              f"{bf16_peak} B")
    launches["K1"]["int8 production"] = counts[0]
    r, wall, counts, _ = run(p, cfg("cuda", i8), h2, track=True)
    print(f"[j_dtype] trace path K2000, int8 J: wall {wall:.3f}s, launches {counts}")
    if counts[1] == 0 or counts[0] or counts[2]:
        _fail(f"int8 trace path: expected K3 only, got {counts}")
    _same("int8 trace path against the dense backend", r,
          anneal(p, h2, seed=0, config=cfg("dense", i8), device="cuda"), traces=True)
    launches["K3"]["int8 trace"] = counts[1]
    r, wall, counts, _ = run(p, cfg("cuda", i8, noise_mode="pregen"), h2)
    print(f"[j_dtype] xorshift pregen K2000, int8 J: wall {wall:.3f}s, launches {counts}")
    _expect("int8 pregen", counts, (0, 0, h2.m_shot * h2.steps, 0, 0, 0))
    _same("int8 pregen against the dense backend", r,
          anneal(p, h2, seed=0, track_energy=False, config=cfg("dense", i8), device="cuda"))
    launches["K4"]["int8 xorshift pregen"] = counts[2]
    sq = dataclasses.replace(_service_hp(ssqa=True), m_shot=M_SHOT_TRACE)
    r, wall, counts, _ = _peak_run(lambda: anneal_ssqa(p, sq, seed=0, track_energy=False,
                                                       config=cfg("cuda", i8), device="cuda"))
    print(f"[j_dtype] anneal_ssqa K2000 (rings of {sq.n_replicas}), int8 J: wall {wall:.3f}s, "
          f"launches {counts}")
    if counts[4] == 0 or counts[1] or counts[2] or counts[3]:
        _fail(f"int8 ssqa: expected K1 and K1's ring mode only, got {counts}")
    _same("int8 ssqa against the dense backend", r,
          anneal_ssqa(p, sq, seed=0, track_energy=False, config=cfg("dense", i8),
                      device="cuda"))
    launches["K1 ring"] = {"int8 ssqa": counts[4]}

    r16, wall, counts, _ = run(enc, cfg("cuda", torch.int16))
    print(f"[j_dtype] partition, int16 J on K1: wall {wall:.3f}s, launches {counts}; best "
          f"energy {int(r16.best_energy.min())} == the float32 run's")
    _expect("int16 partition", counts, (plateaus, 0, 0, 0, 0, 0))
    _same("int16 partition against the float32 run", r16, f32)
    launches["K1"]["int16 partition"] = counts[0]
    r, wall, counts, peak = run(enc, cfg("cuda", i8))
    ref = anneal(enc, hp, seed=0, track_energy=False, config=cfg("dense", i8), device="cuda")
    print(f"[j_dtype] partition, int8 J (13-bit weights wrapped) on K1: wall {wall:.3f}s, "
          f"launches {counts}, peak {peak} B; best energy {int(r.best_energy.min())} (float32 "
          f"J: {int(f32.best_energy.min())}) == the dense backend's int8 run")
    _expect("int8 partition", counts, (plateaus, 0, 0, 0, 0, 0))
    _same("int8 partition against the dense backend", r, ref)
    launches["K1"]["int8 partition"] = counts[0]

    svc = AnnealService(backend="cuda", noise="xorshift", storage_layout="packed",
                        chunk_shots=5, backend_opts={"j_dtype": i8})
    resp, wall, counts, peak = _service_solve(svc, reqs, "j_dtype service K1 (int8 J)")
    print(f"[j_dtype] service K1, int8 J: peak {peak} B (float32 J, phase 18: "
          f"{service_peak} B)")
    _expect("int8 service K1", counts, (2 * plateaus, 0, 0, 0, 0, 0))
    _check_service("int8 service K1", resp, [x.result for x in k1_resp], problems)
    launches["K1"]["int8 service K1"] = counts[0]
    return rows, launches


# ---------------------------------------------------------------------------
# Rings above 32 replicas, and PT-SSA under backend='auto'
# ---------------------------------------------------------------------------
# (trials, replicas per ring) at K2000 width through K1's and K2's ring modes.
BIG_RINGS = ((128, 64), (128, 128), (100, 100), (66, 33))
BIG_RING_TRIALS, BIG_RING = 128, 64  # the main path's rings


def _timed_once(fn):
    """(fn(), its device time in ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _same_outputs(what, got, want) -> int:
    names = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")
    for name, g, w in zip(names, got, want):
        if _max_abs_err(g, w) or g.dtype != w.dtype or g.shape != w.shape:
            _fail(f"{what}: {name} differs from its plain version")
    return 0


def _device_coupling(seed, n, dev):
    """A symmetric ±1 float32 J drawn on the card (too large to draw on the
    host quickly)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    J = torch.triu(torch.randint(-1, 2, (n, n), generator=gen, device=dev, dtype=torch.int8), 1)
    return (J + J.T).to(torch.float32)


def _big_ring_kernels(dev):
    """K1's and K2's ring modes above 32 replicas against their plain
    versions, all five outputs exactly: at K2000 width for each of
    BIG_RINGS (K1: C = 100, J⊥ 4; K2: one Table II chain, C = 600, with the
    SSQA J⊥ ramp), K1 at N = 16384 in rings of 64 (C = 4: the ring's words
    in global memory) and K2 at N = 30000 in one ring of 64 (C = 3: planes
    and words in global memory).  Each line gives the cluster size, block
    count, where the words live, kernel and plain times and the bound.
    Returns {"K1 ring": {label: row}, "K2 ring": {label: row}}."""
    import numpy as np

    from repro_torch.kernels import ssa_update
    from repro_torch.kernels.ref import ssa_plateau_packed_ref, ssa_plateau_popcount_ref

    k1 = ssa_update.ssa_plateau_packed_batched
    k2 = ssa_update.ssa_plateau_popcount_batched
    gen = torch.Generator().manual_seed(28)
    rs = np.random.default_rng(28)
    rows = {"K1 ring": {}, "K2 ring": {}}
    for T, nr, N, C in [(T, nr, 2000, 100) for T, nr in BIG_RINGS] + [(128, 64, 16384, 4)]:
        J = _device_coupling(int(rs.integers(2**31)), N, dev) if N > 4096 else None
        x = _plateau_inputs(gen, T, N, dev, J=J)
        kw = dict(i0=32, n_cycles=C, n_rnd=2, eligible=True, jperp=SSQA_JPERP_MAX,
                  n_replicas=nr)
        what = f"K1 ring mode, {T} trials in rings of {nr}, N={N}, C={C}"
        want, plain = _timed_once(lambda: ssa_plateau_packed_ref(**x, **kw))
        err = _same_outputs(what, k1(**x, **kw), want)
        cs, blocks = k1.last_cluster
        variant = k1.last_ring_variant
        ms = _time_ms(lambda: k1(**x, **kw), reps=3)
        nw = (N + 31) // 32
        sb = 4 * (T * nw + T * N + 4 * T * N + T + T * nw)
        bound, by = _bound_ms(4 * N * N + 4 * N + 2 * sb,
                              2 * T * N * N * (C + 1) + 2 * T * N * C)
        label = f"{T} trials, rings of {nr}, N={N}, C={C}"
        rows["K1 ring"][label] = dict(ring=nr, trials=T, N=N, cluster_size=cs, blocks=blocks,
                                      words=variant, max_abs_err=err, ms=ms, plain_ms=plain,
                                      bound_ms=bound, bound_by=by)
        print(f"[ring > 32] K1 ring, {label}: cluster size {cs}, {blocks} blocks, words in "
              f"{variant} memory: kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
              f"{bound:.4f} ms ({by}); all five outputs equal")
        del x, J, want
        torch.cuda.empty_cache()
    for T, nr, N, w_max, C in [(T, nr, 2000, 1, 600) for T, nr in BIG_RINGS] + [
            (64, 64, 30000, 0, 3)]:  # one ring: the plain version's popcounts take ~15 GB
        x = _popcount_inputs(rs, 1, T, N, w_max, C, dev)
        i0, fold, jperp = _ssqa_chain(C, 100 if C >= 100 else 1)
        x.update(i0_sched=torch.tensor(i0, device=dev), fold_sched=torch.tensor(fold, device=dev))
        kw = dict(n_rnd=2, jperp_sched=torch.tensor(jperp, device=dev), n_replicas=nr)
        what = f"K2 ring mode, {T} trials in rings of {nr}, N={N}, C={C}"
        want, plain = _timed_once(lambda: ssa_plateau_popcount_ref(**x, **kw))
        err = _same_outputs(what, k2(**x, **kw), want)
        launched = _k2_launch(k2)
        cs, blocks, variant = k2.last_cluster
        ms = _time_ms(lambda: k2(**x, **kw), reps=3)
        nb, nw = x["mags"].shape[1], x["sign"].shape[-1]
        fields = C + int(fold[-1] > 0)
        sb = 4 * (T * nw + T * N + 4 * T * N + T + T * nw)
        n_bytes = 4 * (1 + nb) * N * nw + 8 * N + 4 * (3 * C + 1) + 2 * sb
        popc, adds = T * N * nw * nb * fields, 2 * T * N * C
        t_ops = (popc / PEAK_POPC + adds / PEAK_INT32) * 1e3
        t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        label = f"{T} trials, rings of {nr}, N={N}, C={C}"
        rows["K2 ring"][label] = dict(ring=nr, trials=T, N=N, cluster_size=cs, blocks=blocks,
                                      variant=variant, max_abs_err=err, ms=ms, plain_ms=plain,
                                      bound_ms=bound, bound_by=by)
        print(f"[ring > 32] K2 ring, {label}: {launched}: kernel {ms:.3f} ms, plain "
              f"{plain:.3f} ms, bound {bound:.4f} ms ({by}); all five outputs equal")
        del x, want
        torch.cuda.empty_cache()
    return rows


def phase_big_rings(dev):
    """Phase 37: rings above 32 replicas.  The kernels (_big_ring_kernels);
    then anneal_ssqa(K2000, BIG_RING_TRIALS trials in rings of BIG_RING, J⊥max
    4, τ 100, I0 1→32, m_shot 2) on the cuda backend with the dense field —
    K1's ring mode — and with popcount — K2's ring mode —, each equal to
    the dense backend's run on the card; and one such request to
    AnnealService(backend='auto') (bucket 2048: cuda), equal to its one-shot
    run.  Returns (kernel rows, launches of the K1 and K2 ring-mode runs,
    the service's ring launches)."""
    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.ssqa import anneal_ssqa
    from repro_torch.serve import AnnealRequest, AnnealService

    rows = _big_ring_kernels(dev)
    p = gset.load("K2000")
    hp = dataclasses.replace(_service_hp(ssqa=True), n_trials=BIG_RING_TRIALS,
                             n_replicas=BIG_RING, m_shot=M_SHOT_TRACE)
    ref = anneal_ssqa(p, hp, seed=0, track_energy=False,
                      config=SolverConfig(backend="dense", noise="xorshift"), device="cuda")
    launched = {}
    for name, cfg in (("dense field", SolverConfig(backend="cuda", noise="xorshift")),
                      ("popcount", SolverConfig(backend="cuda", noise="xorshift",
                                                field_mode="popcount"))):
        anneal_ssqa(p, dataclasses.replace(hp, m_shot=1), seed=0, track_energy=False,
                    config=cfg, device="cuda")  # warm-up: the shapes' queries
        t0 = time.time()
        r, counts = _counted(lambda: anneal_ssqa(p, hp, seed=0, track_energy=False, config=cfg,
                                                 device="cuda"))
        print(f"[ring > 32] anneal_ssqa {p.name}, {hp.n_trials} trials in rings of "
              f"{hp.n_replicas}, m_shot {hp.m_shot}, {name}: best cut {r.overall_best_cut}, "
              f"wall {time.time() - t0:.3f}s, (K1, K3, K4, K2, K1 ring, K2 ring) launches "
              f"{counts} == the dense backend's run")
        ring = counts[4] if name == "dense field" else counts[5]
        if ring == 0 or counts[1] or counts[2]:
            _fail(f"ring > 32 anneal_ssqa {name}: expected ring-mode launches, got {counts}")
        _same(f"ring > 32 anneal_ssqa {name} against the dense backend", r, ref)
        launched[name] = ring
    svc = AnnealService(backend="auto", noise="xorshift", chunk_shots=1)
    resp, wall, counts, _ = _service_solve(svc, [AnnealRequest(problem=p, hp=hp, seed=0)],
                                           f"ring > 32 service auto, rings of {BIG_RING}")
    if counts[4] == 0:
        _fail(f"ring > 32 service: expected K1's ring mode, got {counts}")
    _check_service("ring > 32 service auto", resp, [ref], [p])
    return rows, launched, counts[4]


def phase_ptssa_auto():
    """Phase 38: a PT-SSA request to AnnealService(backend='auto') at
    bucket 64 on the card, which no kernel runs (its group takes the dense
    backend, as the reference's 'auto' does below 256 spins): status 'ok',
    no launch, equal to the dense service's run."""
    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.pt import PTSSAHyperParams
    from repro_torch.serve import AnnealRequest, AnnealService

    p = gset.toroidal_grid(36, seed=0)
    req = [AnnealRequest(problem=p, hp=PTSSAHyperParams(n_replicas=4, n_rounds=4, tau=10),
                         seed=0)]
    want = AnnealService(backend="dense", min_bucket=16).solve(req)
    resp, counts = _counted(lambda: AnnealService(backend="auto", min_bucket=16).solve(req))
    print(f"[pt-ssa auto] {p.name} (bucket {resp[0].bucket}): status {resp[0].status}, best "
          f"energies {resp[0].result.best_energy.tolist()}, launches {counts} == the dense "
          "service's run")
    _counters_zero("pt-ssa auto", counts)
    got, ref = resp[0], want[0]
    if got.status != "ok" or got.bucket != 64 or not (
            np.array_equal(got.result.best_energy, ref.result.best_energy)
            and np.array_equal(got.result.best_m, ref.result.best_m)):
        _fail(f"pt-ssa auto: differs from the dense service's run (status {got.status!r}, "
              f"bucket {got.bucket})")


def phase_paper():
    """Phase 36: the paper's Table IV, Fig. 7/9, Fig. 8/10 and Fig. 12
    through the port's benchmark modules on the card, ``backend='auto'``
    (the CUDA kernels at N = 800: K1, or K3 where traces are kept), 100
    trials, cut in cycles only (PAPER_M_SHOT, PAPER_WINDOW).  Table IV's
    gate is enforced (the measured HA-SSA/SSA ratio at most 15% below the
    analytic 6×); the figures' rows are printed, their traces checked for
    shape and finiteness, the cycles to target measured, not gated.
    Returns the launches of each module, by kernel."""
    import numpy as np

    from repro_torch.benchmarks import convergence, equal_temp, histograms, memory_table

    t0 = time.time()
    mt, c_mt = _counted(lambda: memory_table.run(backend="auto", device="cuda"))
    print(f"[paper] Table IV: measured HA-SSA/SSA ratio {mt['measured_ratio']:.2f}x (analytic "
          f"{mt['ratio']}x); device bytes the reduced runs left: SSA {mt['live_bytes'][0]} B, "
          f"HA-SSA {mt['live_bytes'][1]} B, their peaks: SSA {mt['peak_bytes'][0]} B, HA-SSA "
          f"{mt['peak_bytes'][1]} B; J at N=800 {mt['j_bytes']['f32']} B float32, "
          f"{mt['j_bytes']['bf16']} B bfloat16; launches {c_mt}; {time.time() - t0:.1f}s")
    if not mt["measured_ok"]:
        _fail(f"memory_table: measured ratio {mt['measured_ratio']:.2f} fell more than 15% "
              f"below the analytic {mt['ratio']}")
    twins = SERVICE_TWINS[:3]
    t0 = time.time()
    conv, c_conv = _counted(lambda: convergence.run(problems=twins, trials=100,
                                                    m_shot=PAPER_M_SHOT, backend="auto",
                                                    device="cuda"))
    for name, row in conv.items():
        cycles = row["ha"].hp.total_cycles
        for r in (row["ha"], row["ssa"], row["sa"]):
            if r.energy_mean.shape != (cycles,) or not np.all(np.isfinite(r.energy_mean)):
                _fail(f"convergence {name}: malformed energy trace")
        print(f"[paper] Fig. 7/9 {name}: cycles to 96% of HA-SSA's best mean energy: HA-SSA "
              f"{row['c_ha']}, SA {row['c_sa']} (of {cycles}; {row['speedup']:.1f}x); best cut "
              f"HA-SSA {row['ha'].overall_best_cut}, SSA {row['ssa'].overall_best_cut}, SA "
              f"{row['sa'].overall_best_cut}; wall HA-SSA {row['t_ha'] / 1e6:.3f}s, SSA "
              f"{row['t_ssa'] / 1e6:.3f}s, SA {row['t_sa'] / 1e6:.3f}s")
    print(f"[paper] Fig. 7/9: launches {c_conv}; {time.time() - t0:.1f}s")
    t0 = time.time()
    hist, c_hist = _counted(lambda: histograms.run(problems=twins, trials=100,
                                                   m_shot=PAPER_M_SHOT, backend="auto",
                                                   device="cuda"))
    for name, (ha, ssa, sa) in hist.items():
        print(f"[paper] Fig. 8/10 {name}: histogram {np.histogram(ha.best_cut, bins=8)[0]}, "
              f"best/mean cut HA-SSA {ha.overall_best_cut}/{ha.mean_best_cut:.1f}, SSA "
              f"{ssa.overall_best_cut}/{ssa.mean_best_cut:.1f}, SA "
              f"{sa.overall_best_cut}/{sa.mean_best_cut:.1f}")
    print(f"[paper] Fig. 8/10: launches {c_hist}; {time.time() - t0:.1f}s")
    t0 = time.time()
    eq, c_eq = _counted(lambda: equal_temp.run(trials=100, window=PAPER_WINDOW, backend="auto",
                                               device="cuda"))
    if eq["ha"].energy_mean.shape != (PAPER_WINDOW,):
        _fail("equal_temp: malformed energy trace")
    print(f"[paper] Fig. 12 G11, {PAPER_WINDOW} cycles: HA-SSA within 2% of its best mean "
          f"energy at cycle {eq['cycles_to_98pct']}; mean cut HA-SSA "
          f"{eq['ha'].mean_best_cut:.1f}, SA at equal temperature {eq['sa'].mean_best_cut:.1f}; "
          f"launches {c_eq}; {time.time() - t0:.1f}s")
    if c_conv[1] == 0 or c_hist[0] == 0 or c_eq[1] == 0:
        _fail(f"paper: expected K3 on the traced figures and K1 on Fig. 8/10, got "
              f"{c_conv}, {c_hist}, {c_eq}")
    names = ("Table IV", "Fig. 7/9", "Fig. 8/10", "Fig. 12")
    counts = (c_mt, c_conv, c_hist, c_eq)
    return {k: {n: c[i] for n, c in zip(names, counts) if c[i]}
            for k, i in (("K1", 0), ("K3", 1), ("K4", 2))}


# ---------------------------------------------------------------------------
# Phase 39: the LM substrate's serving path (none of the six kernels)
# ---------------------------------------------------------------------------
# qwen3-1.7b at full width; the serving cell: 4 prompts of 128 tokens, 32 new
# tokens each (greedy and at temperature 1.0), seed 0.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "qwen3-1.7b", 4, 128, 32
LM_PARAMS = 2_031_739_904
# Tolerances in bfloat16 steps (2^-8 of the logits' largest magnitude): the
# card's bf16 GEMMs (cuBLAS, possibly split-K with reduced-precision
# reductions) and the CPU's sum in other orders, so each bf16 rounding of a
# layer may land one ulp (two steps) away; a 2-layer or reduced model holds
# a handful of such roundings per layer.
LM_STEPS_SHALLOW = 8
LM_STEPS_JAMBA = 16  # 8 layers, a residual stream of ~10^4 (one ulp 32-64)
# The full 28-layer model, cached decode against the teacher-forced forward
# (GEMMs of M = 4 rows against M = 640 on the card, other reduction orders):
# 28 layers of such steps, bounded by 16 (the prediction in PERF.md).  A
# greedy token must be the teacher-forced argmax wherever the top-2 margin
# exceeds that bound: a swap there would need the two top logits to move
# apart by more than it, where the measured differences are a few hundredths.
LM_STEPS_DEEP = 16


def _lm_tol(steps, logits) -> float:
    return steps * 2.0 ** -8 * float(logits.abs().max())


def _lm_greedy(params, batch, cfg, n_new, max_seq):
    """Greedy prefill + decode as ``generate`` runs it, keeping each step's
    logits ((B, n_new, V) float32) and timing the steps on the card:
    (tokens (B, n_new) int32, logits, prefill ms, decode ms per step)."""
    from repro_torch.serve import lm

    prefill_step = lm.make_prefill_step(cfg, max_seq=max_seq)
    decode = lm.make_decode_step(cfg)
    dev = params["final_norm"]["scale"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, caches = prefill_step(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0
    token = torch.argmax(logits, -1).to(torch.int32)
    toks, steps = [token], [logits]
    S = batch["tokens"].shape[1]
    t0 = time.perf_counter()
    for i in range(n_new - 1):
        logits, caches = decode(params, caches, token, S + i)
        token = torch.argmax(logits, -1).to(torch.int32)
        toks.append(token)
        steps.append(logits)
    sync()
    t_decode = (time.perf_counter() - t0) / max(n_new - 1, 1)
    return (torch.stack(toks, 1).cpu().numpy(), torch.stack(steps, 1).float(),
            t_prefill * 1e3, t_decode * 1e3)


def _lm_teacher_forced(params, batch, cfg, tokens):
    """The port's logits over prompt + ``tokens`` by one full forward."""
    from repro_torch.models import forward
    from repro_torch.models.transformer import lm_head_logits

    dev = params["final_norm"]["scale"].device
    full = dict(batch, tokens=torch.cat(
        [batch["tokens"], torch.from_numpy(tokens).to(dev)], dim=1))
    h, _ = forward(params, full, cfg)
    return lm_head_logits(params, h, cfg)


def _lm_margin_agree(what, got, want, logits, tol) -> int:
    """Greedy tokens ``got`` equal ``want`` (the run whose logits (B, n, V)
    are ``logits``) at every step up to a row's first difference, and a
    difference comes only where the top-2 margin there is at most 2·tol —
    where a logit difference within ``tol`` can swap the top two (both runs
    had the same inputs up to that step); returns the tokens compared."""
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    compared = 0
    for b in range(got.shape[0]):
        for i in range(got.shape[1]):
            if got[b, i] == want[b, i]:
                compared += 1
                continue
            if margin[b, i] > 2 * tol:
                _fail(f"{what}: row {b} step {i}: token {got[b, i]} != {want[b, i]} at a "
                      f"top-2 margin {margin[b, i]:.4f} > 2·tol {2 * tol:.4f}")
            break
    return compared


def _lm_batch(cfg, B, S, seed, dev):
    import numpy as np

    rs = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rs.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(
            (rs.standard_normal((B, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(
            (rs.standard_normal((B, cfg.n_frames, cfg.d_model)) * 0.1).astype(np.float32))
    return {k: v.to(dev) for k, v in batch.items()}


def _lm_card_vs_cpu(what, params, cfg, batch, n_new, max_seq, steps):
    """prefill + decode logits and greedy tokens of ``params`` on the card
    against the same parameters' CPU run; returns (max |Δ| logits, tol,
    tokens compared)."""
    from repro_torch.models.params import tree_map
    from repro_torch.serve import lm

    cpu = tree_map(lambda t: t.cpu(), params)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    tok_c, lg_c, _, _ = _lm_greedy(cpu, cpu_batch, cfg, n_new, max_seq)
    tok_g, lg_g, _, _ = _lm_greedy(params, batch, cfg, n_new, max_seq)
    if not bool(torch.isfinite(lg_g).all()):
        _fail(f"{what}: a logit on the card is not finite")
    # the card's decode from the CPU's tokens: the same inputs at every step
    from repro_torch.models import decode_step, prefill

    logits, caches = prefill(params, batch, cfg, max_seq=max_seq)
    rows = [logits]
    S = batch["tokens"].shape[1]
    for i in range(n_new - 1):
        logits, caches = decode_step(params, caches,
                                     torch.from_numpy(tok_c[:, i]).to(logits.device), S + i, cfg)
        rows.append(logits)
    lg_same = torch.stack(rows, 1).float().cpu()
    tol = _lm_tol(steps, lg_c)
    err = float((lg_same - lg_c).abs().max())
    compared = _lm_margin_agree(what, tok_g, tok_c, lg_c, tol)
    gen = lm.generate(params, batch, cfg, lm.ServeConfig(max_seq=max_seq), n_new)
    if not (gen == tok_g).all():
        _fail(f"{what}: generate() on the card differs from its own greedy steps")
    return err, tol, compared


def phase_lm(card: str):
    """Phase 39: ``repro_torch.serve.lm.generate`` on qwen3-1.7b at full
    width, the 2-layer cut against the CPU, and the ten reduced configs
    against the CPU.  The LM path runs none of the six kernels: the
    counters must stay 0."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params, param_shapes, tree_map, tree_paths
    from repro_torch.serve import lm

    dev = torch.device("cuda")
    cfg = configs.get_config(LM_ARCH)
    n_params = sum(t.numel() for _, t in tree_paths(param_shapes(model_defs(cfg))))
    if (cfg.n_layers, cfg.d_model, cfg.vocab, n_params) != (28, 2048, 151936, LM_PARAMS):
        _fail(f"lm: {LM_ARCH} is not the full-width config ({cfg}, {n_params} parameters)")
    max_seq = LM_PROMPT + LM_NEW
    failures = []
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(model_defs(cfg), seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    batch = _lm_batch(cfg, LM_BATCH, LM_PROMPT, 0, dev)
    sc = lm.ServeConfig(max_seq=max_seq)
    t0 = time.perf_counter()
    out1 = lm.generate(params, batch, cfg, sc, LM_NEW)  # the first call: warm-up
    t_first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out2 = lm.generate(params, batch, cfg, sc, LM_NEW)
    t_gen = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not np.array_equal(out1, out2):
        failures.append("two greedy generate() runs differ")
    hot = lm.generate(params, batch, cfg, lm.ServeConfig(max_seq=max_seq, temperature=1.0),
                      LM_NEW, seed=0)
    if hot.shape != (LM_BATCH, LM_NEW) or hot.min() < 0 or hot.max() >= cfg.vocab:
        failures.append(f"temperature 1.0 tokens out of range: {hot.shape}")
    tok, lg_steps, _, _ = _lm_greedy(params, batch, cfg, LM_NEW, max_seq)
    _, _, ms_prefill, ms_decode = _lm_greedy(params, batch, cfg, LM_NEW, max_seq)
    if not np.array_equal(tok, out2):
        failures.append("generate() differs from its own greedy steps")
    if not bool(torch.isfinite(lg_steps).all()):
        failures.append("a prefill or decode logit is not finite")
    full = _lm_teacher_forced(params, batch, cfg, out2)[:, LM_PROMPT - 1: max_seq - 1].float()
    if not bool(torch.isfinite(full).all()):
        failures.append("a teacher-forced logit is not finite")
    tol = _lm_tol(LM_STEPS_DEEP, full)
    err_tf = float((lg_steps - full).abs().max())
    top2 = torch.topk(full, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    clear = margin > tol
    agree = (torch.from_numpy(out2).to(dev) == full.argmax(-1)) | ~clear
    counts = _counts()
    print(f"[lm qwen3-1.7b] full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{n_params} float32 parameters ({n_params * 4} B), init {t_init:.3f}s on {card}")
    print(f"[lm qwen3-1.7b] generate(): {LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_NEW} new, "
          f"greedy: wall {t_gen:.3f}s (first call {t_first:.3f}s), "
          f"{LM_BATCH * LM_NEW / t_gen:.1f} tokens/s; prefill {ms_prefill:.3f} ms, decode "
          f"{ms_decode:.3f} ms a step; peak device bytes {peak}; two greedy runs "
          f"{'equal' if np.array_equal(out1, out2) else 'DIFFER'}; temperature 1.0 row 0 "
          f"{hot[0, :8].tolist()}…; launches {counts}")
    print(f"[lm qwen3-1.7b] decode against the teacher-forced forward: max |Δlogit| "
          f"{err_tf:.4f} (tol {tol:.4f} = {LM_STEPS_DEEP} bf16 steps of {float(full.abs().max()):.3f}"
          f"); greedy == argmax at {int(clear.sum())} of {clear.numel()} steps whose margin > "
          f"tol, {int((~agree).sum())} disagree")
    if err_tf > tol:
        failures.append(f"decode vs teacher-forced |Δ| {err_tf} > {tol}")
    if not bool(agree.all()):
        failures.append("a greedy token is not the teacher-forced argmax at a clear margin")
    if not bool(clear.any()):
        failures.append("no step's top-2 margin clears the tolerance: nothing compared")
    del params, full, lg_steps
    torch.cuda.empty_cache()

    # the same model cut to 2 layers, on the card and on the CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = init_params(model_defs(cfg2), seed=0, device=dev)
    batch2 = _lm_batch(cfg2, 2, 16, 1, dev)
    err2, tol2, n2 = _lm_card_vs_cpu("lm 2-layer", params2, cfg2, batch2, 4, 20,
                                     LM_STEPS_SHALLOW)
    print(f"[lm qwen3-1.7b 2 layers] card vs CPU: prefill + 3 decode steps max |Δlogit| "
          f"{err2:.4f} (tol {tol2:.4f} = {LM_STEPS_SHALLOW} bf16 steps); greedy tokens "
          f"equal at {n2} of 8 steps (up to a near tie)")
    if err2 > tol2:
        failures.append(f"2-layer card vs CPU |Δ| {err2} > {tol2}")
    del params2
    torch.cuda.empty_cache()

    # the ten reduced configs, parameters drawn on the CPU and copied over
    rows = []
    for arch in configs.ARCH_NAMES:
        rc = configs.get_config(arch, reduced=True)
        p = tree_map(lambda t: t.to(dev), init_params(model_defs(rc), seed=0, device="cpu"))
        S = 7 if rc.encoder_layers else 8
        b = _lm_batch(rc, 2, S, 2, dev)
        steps = LM_STEPS_JAMBA if arch.startswith("jamba") else LM_STEPS_SHALLOW
        err, tol_r, n = _lm_card_vs_cpu(f"lm reduced {arch}", p, rc, b, 6, S + 6, steps)
        rows.append(f"{arch} {err:.4f}/{tol_r:.4f} ({n}/12)")
        if err > tol_r:
            failures.append(f"reduced {arch} card vs CPU |Δ| {err} > {tol_r}")
    counts = _counts()
    print(f"[lm reduced] card vs CPU, prefill + decode + generate, max |Δlogit|/tol (tokens "
          f"equal, of 12, up to a near tie): {'; '.join(rows)}; launches {counts}")
    print(f"[lm] the LM path runs none of the six kernels: (K1, K3, K4, K2, K1 ring, K2 ring) "
          f"= {counts}")
    _counters_zero("lm", counts)
    if failures:
        _fail("lm: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# Phase 40: the LM substrate's training path (none of the six kernels)
# ---------------------------------------------------------------------------
# qwen3-1.7b at full width through the launcher: 4 AdamW steps of 8 × 512
# tokens, remat 'full' (the config's), no checkpoint inside the 4 steps.
TRAIN_ARGV = ("--arch", "qwen3-1.7b", "--scale", "full", "--batch", "8", "--seq", "512",
              "--steps", "4", "--ckpt-every", "1000", "--device", "cuda")
TRAIN_TOKENS = 8 * 512
# Tolerances, card against the port's CPU run on the same parameters and
# batch: the loss within 1 bfloat16 step of its own size (2^-8 of it); each
# gradient leaf within 16 steps of its largest magnitude (the forward's and
# the backward's bf16 roundings, each possibly one ulp apart where cuBLAS
# and the CPU sum in other orders; 8 in the CPU tests against the JAX
# package), jamba 32 (a residual stream of ~10^4, 32 against JAX on the
# CPU).  adamw_update on the card's gradients, both sides: the global norm
# sums in another order on each device, so every new value within 4 float32
# ulps of its leaf's largest magnitude (0 where the two norms are equal).
TRAIN_LOSS_STEPS = 1
TRAIN_GRAD_STEPS, TRAIN_GRAD_STEPS_JAMBA = 16, 32
TRAIN_ADAMW_ULPS = 4
# The reference tests' tiny configs (tests/test_ft.py, tests/
# test_train_substrate.py) for the determinism, resume and loss checks.
FT_MODEL = dict(name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                d_ff=64, vocab=53, remat="none")
SUBSTRATE_MODEL = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, vocab=97, remat="none")


def _grad_steps(got, want):
    """(worst leaf's |Δ| in bf16 steps of its max |want|, that leaf) of two
    gradient trees."""
    from repro_torch.models.params import tree_paths

    ref = dict(tree_paths(want))
    worst, at = 0.0, ""
    for path, g in tree_paths(got):
        w = ref[path].float().cpu()
        d = float((g.float().cpu() - w).abs().max())
        steps = d / (2.0 ** -8 * max(float(w.abs().max()), 1e-30))
        if steps > worst:
            worst, at = steps, "/".join(path)
    return worst, at


def _adamw_ulps(got, want):
    """Worst leaf's max |Δ| in float32 ulps of its max |want| (2^-23 each)."""
    from repro_torch.models.params import tree_paths

    ref = dict(tree_paths(want))
    worst = 0.0
    for path, x in tree_paths(got):
        w = ref[path].float().cpu()
        d = float((x.float().cpu() - w).abs().max())
        worst = max(worst, d / (2.0 ** -23 * max(float(w.abs().max()), 1e-30)))
    return worst


def _train_card_vs_cpu(what, cfg, params_cpu, batch_cpu, grad_steps):
    """One train step's loss and gradients on the card against the port's
    CPU run of the same parameters and batch, then ``adamw_update`` of the
    card's gradients on both devices; returns a report line, failing on a
    tolerance."""
    from repro_torch.models.params import tree_map
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train import TrainConfig, grad_with_aux, make_loss_fn
    from repro_torch.train.step import deterministic_algorithms

    dev = torch.device("cuda")
    tc = TrainConfig(opt=AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=40))
    loss_fn = make_loss_fn(cfg, tc)
    params = tree_map(lambda t: t.to(dev), params_cpu)
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}
    t0 = time.perf_counter()
    with deterministic_algorithms():
        g_card, m_card = grad_with_aux(loss_fn, params, batch)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        g_cpu, m_cpu = grad_with_aux(loss_fn, params_cpu, batch_cpu)
    t_cpu = time.perf_counter() - t0 - t_card
    loss_c, loss_h = float(m_card["ce_loss"]), float(m_cpu["ce_loss"])
    if not all(bool(torch.isfinite(g).all()) for g in _leaves(g_card)):
        _fail(f"{what}: a gradient on the card is not finite")
    loss_steps = abs(loss_c - loss_h) / (2.0 ** -8 * abs(loss_h))
    gsteps, gleaf = _grad_steps(g_card, g_cpu)
    if loss_steps > TRAIN_LOSS_STEPS or gsteps > grad_steps:
        _fail(f"{what}: card vs CPU loss {loss_c} / {loss_h} ({loss_steps:.3f} steps, tol "
              f"{TRAIN_LOSS_STEPS}); worst gradient leaf {gleaf} {gsteps:.2f} steps (tol "
              f"{grad_steps})")
    # adamw_update with the card's gradients on both sides
    t0 = time.perf_counter()
    opt = adamw_init(params_cpu, tc.opt)
    p_h, o_h, am_h = adamw_update(params_cpu, tree_map(lambda t: t.cpu(), g_card), opt, tc.opt)
    t_adamw_cpu = time.perf_counter() - t0
    p_c, o_c, am_c = adamw_update(params, g_card, adamw_init(params, tc.opt), tc.opt)
    same_norm = float(am_c["grad_norm"]) == float(am_h["grad_norm"])
    ulps = max(_adamw_ulps(p_c, p_h), _adamw_ulps(o_c.mu, o_h.mu), _adamw_ulps(o_c.nu, o_h.nu))
    if ulps > (0 if same_norm else TRAIN_ADAMW_ULPS) or float(am_c["lr"]) != float(am_h["lr"]):
        _fail(f"{what}: adamw_update card vs CPU {ulps:.2f} ulps of the leaf's scale (norms "
              f"{float(am_c['grad_norm'])} / {float(am_h['grad_norm'])}), lr "
              f"{float(am_c['lr'])} / {float(am_h['lr'])}")
    return (f"loss {loss_c:.6f} vs {loss_h:.6f} ({loss_steps:.3f} steps); worst gradient leaf "
            f"{gsteps:.2f} steps ({gleaf}); adamw {ulps:.2f} ulps (norm "
            f"{'equal' if same_norm else 'differs'}); grads card {t_card:.2f}s, CPU "
            f"{t_cpu:.2f}s, CPU adamw {t_adamw_cpu:.2f}s")


def _leaves(tree):
    from repro_torch.models.params import tree_paths

    return [t for _, t in tree_paths(tree)]


def _digest(t: torch.Tensor):
    """Two integers of a tensor's bits, taken on its device in slices: the
    sum of its 32-bit words and their sum weighted by position mod 65521
    (int64, wrapping: the same whatever the order of the sum)."""
    words = t.detach().contiguous().view(torch.int32).reshape(-1)
    total = weighted = 0
    for lo in range(0, words.numel(), 1 << 26):
        w = words[lo: lo + (1 << 26)].to(torch.int64)
        pos = (torch.arange(lo, lo + w.numel(), device=w.device, dtype=torch.int64) % 65521) + 1
        total += int(w.sum())
        weighted += int((w * pos).sum())
    return total, weighted


def _state_digests(state) -> dict:
    """Each leaf's :func:`_digest` of a TrainState's parameters and moments."""
    from repro_torch.models.params import tree_paths

    return {(field,) + path: _digest(t) for field, tree in (
        ("params", state.params), ("mu", state.opt.mu), ("nu", state.opt.nu))
        for path, t in tree_paths(tree)}


def _train_runs(tmp: str):
    """Determinism and resume on the card (tests/test_ft.py's run): two
    uninterrupted 20-step runs, and a run killed at step 13 and resumed
    from its step-10 checkpoint; returns (losses, resumed losses, the two
    final states equal)."""
    from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.ft import SimulatedFailure, run_training
    from repro_torch.models import ModelConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = ModelConfig(**FT_MODEL)
    tc = TrainConfig(opt=AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=40), loss_chunk=8)
    dc = DataConfig(vocab=53, seq_len=16, global_batch=4, seed=0)

    def kw(name):
        return dict(init_state_fn=lambda: init_train_state(cfg, tc, 0, device="cuda"),
                    train_step=make_train_step(cfg, tc),
                    batch_fn=lambda s: synthetic_batch(dc, s, device="cuda"),
                    ckpt=CheckpointManager(f"{tmp}/{name}", save_interval=5, keep=2,
                                           async_save=False))

    s1, ref = run_training(n_steps=20, **kw("ref"))
    s2, again = run_training(n_steps=20, **kw("again"))
    try:
        run_training(n_steps=20, fail_at_step=13, **kw("killed"))
        _fail("lm train resume: the run did not fail at step 13")
    except SimulatedFailure:
        pass
    if latest_step(f"{tmp}/killed") != 10:
        _fail(f"lm train resume: latest checkpoint {latest_step(f'{tmp}/killed')}, not 10")
    s3, resumed = run_training(n_steps=20, **kw("killed"))
    same = all(torch.equal(a, b) for a, b in zip(_leaves(s1.params), _leaves(s3.params)))
    same_again = all(torch.equal(a, b) for a, b in zip(_leaves(s1.params), _leaves(s2.params)))
    return ref, again, resumed, same, same_again


def _train_falls():
    """tests/test_train_substrate.py::test_loss_decreases_over_training on
    the card: 30 steps; returns the losses."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import ModelConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = ModelConfig(**SUBSTRATE_MODEL)
    tc = TrainConfig(opt=AdamWConfig(lr_peak=1e-2, warmup_steps=5, total_steps=50),
                     loss_chunk=16)
    dc = DataConfig(vocab=97, seq_len=32, global_batch=8, seed=0)
    state = init_train_state(cfg, tc, 0, device="cuda")
    step = make_train_step(cfg, tc)
    losses = []
    for s in range(30):
        state, m = step(state, synthetic_batch(dc, s, device="cuda"))
        losses.append(float(m["ce_loss"]))
    if int(state.opt.step) != 30:
        _fail(f"lm train: opt.step {int(state.opt.step)} after 30 steps")
    return losses


def phase_lm_train(card: str):
    """Phase 40: the LM substrate's training path — qwen3-1.7b at full width
    through ``repro_torch.launch.train``, the 2-layer cut and the ten
    reduced configs card against CPU, determinism, kill-and-resume and a
    falling loss.  The path runs none of the six kernels: the counters must
    stay 0."""
    import math
    import os
    import tempfile

    from repro_torch import configs
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params, param_shapes, tree_paths

    torch.cuda.empty_cache()
    _reset_counts()
    cfg = configs.get_config("qwen3-1.7b")
    n_params = sum(t.numel() for _, t in tree_paths(param_shapes(model_defs(cfg))))
    if (cfg.n_layers, cfg.d_model, cfg.vocab, n_params, cfg.remat) != (
            28, 2048, 151936, LM_PARAMS, "full"):
        _fail(f"lm train: qwen3-1.7b is not the full-width config ({cfg})")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = launch_train.train(list(TRAIN_ARGV) + ["--ckpt-dir", f"{tmp}/full"], log_every=0)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        saved = os.listdir(f"{tmp}/full") if os.path.isdir(f"{tmp}/full") else []
    hist = run.history
    steps_ms = [h["wall_s"] * 1e3 for h in hist]
    ms = sum(steps_ms[1:]) / max(len(steps_ms) - 1, 1)
    flops = 8 * n_params * TRAIN_TOKENS       # (6 + 2 for remat) × N × tokens
    adamw_bytes = 7 * 4 * n_params           # read p, g, m, v; write p, m, v (float32)
    bound = max(flops / PEAK_BF16_FLOPS, adamw_bytes / PEAK_HBM_BYTES) * 1e3
    by = "operations" if flops / PEAK_BF16_FLOPS >= adamw_bytes / PEAK_HBM_BYTES else "bytes"
    counts = _counts()
    rows = "; ".join(f"step {h['step']}: ce_loss {h['ce_loss']:.4f} grad_norm "
                     f"{h['grad_norm']:.4f} lr {h['lr']:.6g} ({h['wall_s'] * 1e3:.1f} ms)"
                     for h in hist)
    print(f"[lm train qwen3-1.7b] full width via launch.train: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {n_params} float32 parameters, remat "
          f"{cfg.remat}; {len(hist)} AdamW steps of 8 x 512 tokens on {card}: {rows}")
    print(f"[lm train qwen3-1.7b] opt.step {int(run.state.opt.step)}; init {run.init_s:.3f}s on "
          f"the card; {ms:.3f} ms a step after the first ({TRAIN_TOKENS / ms * 1e3:.1f} "
          f"tokens/s; first step {steps_ms[0]:.1f} ms; wall {wall:.3f}s); peak device bytes "
          f"{peak}; bound {bound:.3f} ms ({by}: {flops:.4g} bf16 FLOPs at 989 TFLOP/s, "
          f"AdamW {adamw_bytes} B at 3.35 TB/s); checkpoints written {len(saved)}; "
          f"launches {counts}")
    finite = all(math.isfinite(h[k]) for h in hist for k in ("ce_loss", "grad_norm", "lr"))
    if len(hist) != 4 or int(run.state.opt.step) != 4 or not finite or saved:
        _fail(f"lm train qwen3-1.7b: {len(hist)} steps, opt.step {int(run.state.opt.step)}, "
              f"finite {finite}, checkpoints {saved}")
    # where a step's time goes: the loss and gradients, then AdamW, each
    # timed alone on the run's final state and a fifth batch
    from repro_torch.optim import adamw_update
    from repro_torch.train import TrainConfig, grad_with_aux, make_loss_fn
    from repro_torch.train.step import deterministic_algorithms

    batch = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8), 4,
                            device="cuda")
    tc = TrainConfig(loss_chunk=512)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with deterministic_algorithms():
        grads, _ = grad_with_aux(make_loss_fn(cfg, tc), run.state.params, batch)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = adamw_update(run.state.params, grads, run.state.opt, tc.opt)
    torch.cuda.synchronize()
    t_adamw = time.perf_counter() - t0
    print(f"[lm train qwen3-1.7b] one step's parts, each alone: loss and gradients "
          f"{t_grad * 1e3:.1f} ms, adamw_update {t_adamw * 1e3:.1f} ms")
    full = dict(history=hist, ms=ms, digests=_state_digests(run.state))
    del run, grads, out
    torch.cuda.empty_cache()

    # the same widths cut to 2 layers: one step, card against CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = init_params(model_defs(cfg2), seed=0, device="cpu")
    dc2 = DataConfig(vocab=cfg2.vocab, seq_len=16, global_batch=2, seed=0)
    b_cpu = synthetic_batch(dc2, 0, device="cpu")
    b_card = synthetic_batch(dc2, 0, device="cuda")
    if not all(torch.equal(b_cpu[k], b_card[k].cpu()) for k in b_cpu):
        _fail("lm train: synthetic_batch on the card differs from the CPU's")
    line = _train_card_vs_cpu("lm train 2-layer", cfg2, p2, b_cpu, TRAIN_GRAD_STEPS)
    print(f"[lm train qwen3-1.7b 2 layers] B=2 S=16, card vs CPU: {line}")
    del p2
    torch.cuda.empty_cache()

    # the ten reduced configs on phase 39's requests, labels the next token
    rows = []
    for arch in configs.ARCH_NAMES:
        rc = configs.get_config(arch, reduced=True)
        S = 7 if rc.encoder_layers else 8
        b = {k: v.cpu() for k, v in _lm_batch(rc, 2, S, 2, "cpu").items()}
        lab = torch.full_like(b["tokens"], -1)
        lab[:, :-1] = b["tokens"][:, 1:]
        b["labels"] = lab
        steps = TRAIN_GRAD_STEPS_JAMBA if arch.startswith("jamba") else TRAIN_GRAD_STEPS
        p = init_params(model_defs(rc), seed=0, device="cpu")
        rows.append(f"{arch}: " + _train_card_vs_cpu(f"lm train reduced {arch}", rc, p, b, steps))
    print(f"[lm train reduced] one step each, card vs CPU: {' | '.join(rows)}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref, again, resumed, same, same_again = _train_runs(tmp)
    falls = _train_falls()
    t_ft = time.perf_counter() - t0
    counts = _counts()
    print(f"[lm train ft] tests/test_ft.py's config on the card: two 20-step runs "
          f"{'equal' if ref == again and same_again else 'DIFFER'}; killed at step 13, resumed "
          f"from step 10: steps 11-20 {'equal' if resumed == ref[10:20] else 'DIFFER'} to the "
          f"uninterrupted run's, final parameters {'equal' if same else 'DIFFER'}; 30 steps "
          f"(test_train_substrate's config): loss {falls[0]:.4f} → {falls[-1]:.4f} "
          f"(fall {falls[0] - falls[-1]:.4f}, > 0.4 asked); {t_ft:.1f}s; launches {counts}")
    if ref != again or not same_again:
        _fail("lm train: two uninterrupted runs differ on the card")
    if resumed != ref[10:20] or not same:
        _fail("lm train: the resumed run differs from the uninterrupted one")
    if not falls[-1] < falls[0] - 0.4:
        _fail(f"lm train: the loss fell {falls[0] - falls[-1]} in 30 steps, not more than 0.4")
    print(f"[lm train] the LM training path runs none of the six kernels: (K1, K3, K4, K2, "
          f"K1 ring, K2 ring) = {counts}")
    _counters_zero("lm train", counts)
    return full


# The iteration steps' cells beyond Table II's: the JAX package's lowering
# defaults, anneal_step_lowering's single cell (N = 2000, T = 4096) and
# batched_anneal_step_lowering's (B = 8 problems, T = 512, N = 2048).
STEP_TRIALS = 4096
STEP_BATCH, STEP_BATCH_TRIALS, STEP_BATCH_N = 8, 512, 2048
# (storage_layout, j_mode, field_mode) of the batched cell, dense first.
STEP_FORMS = (("dense", "dense", "dense"), ("packed", "dense", "dense"),
              ("dense", "tiled", "dense"), ("dense", "dense", "popcount"))
# τ of the batched cell, cut from Table II's 100: at 100 its popcount form
# takes ~33 s an iteration on an H100 (PERF.md §6).
STEP_BATCH_TAU = 50


def _seeded_state(seeds, T, N, dev):
    """The iteration steps' start, as ``init_state`` seeds anneal(): lanes
    seeded, one draw taken as m; one problem's (4, T, N) lanes or, for a
    list of seeds, a batch's (4, B, T, N)."""
    from repro_torch.core.engine import BIG_ENERGY
    from repro_torch.core.rng import xorshift_init, xorshift_next_bits

    batched = isinstance(seeds, (list, tuple))
    lanes = torch.stack([xorshift_init(s, (T, N), device=dev) for s in seeds], dim=1) \
        if batched else xorshift_init(seeds, (T, N), device=dev)
    rng, r0 = xorshift_next_bits(lanes)
    m = r0.to(torch.float32)
    return (rng, m, torch.where(m > 0, 0, -1).to(torch.int32),
            torch.full(m.shape[:-1], BIG_ENERGY, dtype=torch.int32, device=dev), r0.to(torch.int8))


def _step_issued(step, state, problem, iters: int):
    """``iters`` iterations issued from Python: (final state, ms an
    iteration, peak device bytes: the operands and state it was given plus
    the most it allocated on top of what was live before)."""
    held = sum(t.numel() * t.element_size() for t in (*state, *problem))
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(*state, *problem)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    return state, ms, held + torch.cuda.max_memory_allocated() - live


def _step_graphed(what, step, state, problem, iters: int, want):
    """The step captured once in a CUDA graph that writes its outputs back
    into its state buffers, replayed ``iters`` times from ``state``: its ms
    an iteration, by CUDA events, and its outputs equal to the issued
    run's ``want``.  A measurement: a capture that fails is printed and
    skipped."""
    bufs = [t.clone() for t in state]
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(*bufs, *problem)  # warm-up outside the capture; the step mutates nothing
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step(*bufs, *problem)
            for b, o in zip(bufs, out):
                b.copy_(o)
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"[iteration step] {what}: CUDA graph capture failed, not measured: {e}")
        return None
    del out
    ms = _time_ms(graph.replay, iters, warmup=0)
    if not all(torch.equal(b, w) for b, w in zip(bufs, want)):
        _fail(f"iteration step {what}: the CUDA graph's replays differ from the issued run")
    del graph
    return ms


def _graph_txt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f} ms"


def _step_bound_ms(hp, B, N):
    """One iteration's float32 operations (a dense contraction of 2·B·T·N²
    a cycle and one epilogue per eligible plateau: 601 at Table II's
    schedule) against its bytes (state in and out, J read once), by the
    larger."""
    from repro_torch.core.engine import schedule_plateaus

    T = hp.n_trials
    contractions = sum(p.length + p.eligible for p in schedule_plateaus(hp.schedule("hassa")))
    state_bytes = T * N * (16 + 4 + 4 + 1)  # lanes, m, itanh, best_m
    return _bound_ms(B * (4 * N * N + 2 * state_bytes), contractions * 2 * B * T * N * N)


def _check_best(what, best_H, best_m, J, h):
    """best_m is ±1 and its energy, on the card, is best_H."""
    from repro_torch.core.engine import energy_from_field
    from repro_torch.core.ising import local_fields_dense

    H = energy_from_field(best_m, local_fields_dense(best_m, h, J), h)
    if not (torch.equal(best_m.abs(), torch.ones_like(best_m)) and torch.equal(H, best_H)):
        _fail(f"iteration step {what}: best_m's energy is not best_H")


def phase_iteration_step(card: str, production):
    """Phase 41: step 8's fused iteration steps (``core/distributed.py``, no
    kernel): (a) Table II at K2000 through ``make_iteration_step``, equal to
    phase 6's K1 run; (b) the single lowering cell, T = 4096; (c) the batched
    lowering cell in four forms, all equal per problem and problem 0 equal
    to the single step.  The K1–K4 counters must stay 0."""
    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.distributed import make_batched_iteration_step, make_iteration_step
    from repro_torch.core.engine import pack_spins, unpack_spins
    from repro_torch.core.ssa import SSAHyperParams
    from repro_torch.kernels.bitplane import adjacency_weight_bits, pack_couplings_from_adjacency

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    _reset_counts()
    # (a) Table II at K2000.
    p = gset.load("K2000")
    model = p.to_ising()
    N, T = model.n, 100
    hp = SSAHyperParams(n_trials=T, m_shot=M_SHOT_PRODUCTION, tau=100, i0_min=1, i0_max=32)
    J = torch.from_numpy(model.dense_J()).to(dev, torch.float32)
    h = torch.from_numpy(np.asarray(model.h, np.int32)).to(dev)
    step = make_iteration_step(hp)
    state0 = _seeded_state(0, T, N, dev)
    step(*state0, J, h)  # warm-up
    st, ms, peak = _step_issued(step, state0, (J, h), hp.m_shot)
    if not (np.array_equal(st[3].cpu().numpy(), production.best_energy)
            and np.array_equal(st[4].cpu().numpy(), production.best_m)):
        _fail("iteration step K2000: best_H/best_m differ from phase 6's K1 run")
    graph_ms = _step_graphed("K2000", step, state0, (J, h), hp.m_shot, st)
    bound, by = _step_bound_ms(hp, 1, N)
    k2000 = dict(state=st, ms=ms, peak=peak)
    print(f"[iteration step] K2000 N={N} T={T} tau={hp.tau} I0 1->32, {hp.m_shot} iterations "
          f"== phase 6's K1 run: {ms:.3f} ms an iteration issued from Python, "
          f"{_graph_txt(graph_ms)} by CUDA graph; "
          f"bound {bound:.3f} ms ({by}); peak device bytes {peak}  ({card})")
    # (b) The single lowering cell: K2000's J, T = 4096, one iteration.
    T = STEP_TRIALS
    hp = dataclasses.replace(hp, n_trials=T, m_shot=1)
    step = make_iteration_step(hp)
    state0 = _seeded_state(0, T, N, dev)
    st, ms, peak = _step_issued(step, state0, (J, h), 1)
    _check_best("T=4096", st[3], st[4], J, h)
    graph_ms = _step_graphed("T=4096", step, state0, (J, h), 1, st)
    bound, by = _step_bound_ms(hp, 1, N)
    k2000["peak_T4096"] = peak
    print(f"[iteration step] single cell N={N} T={T}, one iteration: {ms:.3f} ms issued, "
          f"{_graph_txt(graph_ms)} by CUDA graph; "
          f"bound {bound:.3f} ms ({by}); peak device bytes {peak}  ({card})")
    del J, h, st, state0
    torch.cuda.empty_cache()
    # (c) The batched lowering cell: eight 4-regular tori, four forms.
    B, T, N = STEP_BATCH, STEP_BATCH_TRIALS, STEP_BATCH_N
    hp_b = SSAHyperParams(n_trials=T, m_shot=1, tau=STEP_BATCH_TAU, i0_min=1, i0_max=32)
    models = [gset.toroidal_grid(N, seed=s).to_ising() for s in range(B)]
    h = torch.from_numpy(np.stack([m.h for m in models]).astype(np.int32)).to(dev)
    nb = max(adjacency_weight_bits(m.n, m.nbr_idx, m.nbr_w) for m in models)
    state0 = _seeded_state(list(range(B)), T, N, dev)
    cut = "" if STEP_BATCH_TAU == 100 else f" (tau cut 100 -> {STEP_BATCH_TAU} for this cell)"
    dense_J = torch.from_numpy(np.stack([m.dense_J() for m in models])).to(dev, torch.float32)
    pjs = [pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w, n_bits=nb, device=dev)
           for m in models]
    operands = {
        "dense": (dense_J,),
        "tiled": tuple(torch.from_numpy(np.stack([getattr(m, k) for m in models])).to(
            dev, torch.int32) for k in ("nbr_idx", "nbr_w")),
        "popcount": tuple(torch.stack([getattr(pj, k) for pj in pjs])
                          for k in ("sign", "mags", "base")),
    }
    results = {}
    for layout, j_mode, field_mode in STEP_FORMS:
        state = state0
        if layout == "packed":
            state = (state0[0], pack_spins(state0[1]), state0[2], state0[3],
                     pack_spins(state0[4]))
        step = make_batched_iteration_step(hp_b, storage_layout=layout, j_mode=j_mode,
                                           field_mode=field_mode)
        problem = operands["popcount" if field_mode == "popcount" else j_mode]
        st, ms, peak = _step_issued(step, state, (*problem, h), 1)
        if layout == "packed":
            st = (st[0], unpack_spins(st[1], N).to(torch.float32), st[2], st[3],
                  unpack_spins(st[4], N))
        form = f"{layout}/{j_mode}/{field_mode}" + (f" nb={nb}" if field_mode == "popcount" else "")
        print(f"[iteration step] batched cell B={B} T={T} N={N} {form}, one iteration{cut}: "
              f"{ms:.3f} ms issued; peak device bytes {peak}  ({card})")
        results[form] = st
    ref = results[next(iter(results))]
    for form, st in results.items():
        if not all(torch.equal(a, b) for a, b in zip(st, ref)):
            _fail(f"iteration step batched cell: {form} differs from the dense form")
    _check_best("batched cell", ref[3], ref[4], dense_J, h[:, None])
    single = make_iteration_step(hp_b)(state0[0][:, 0], *(x[0] for x in state0[1:]),
                                       dense_J[0], h[0])
    if not all(torch.equal(a, b) for a, b in zip(single, (ref[0][:, 0], *(x[0] for x in ref[1:])))):
        _fail("iteration step batched cell: problem 0 differs from the single step")
    bound, by = _step_bound_ms(hp_b, B, N)
    print(f"[iteration step] batched cell: the {len(results)} forms equal per problem in every "
          f"leaf, problem 0 == the single step; dense bound {bound:.3f} ms ({by})")
    counts = _counts()
    print(f"[iteration step] (K1, K3, K4, K2, K1 ring, K2 ring) = {counts}")
    _counters_zero("iteration step", counts)
    return k2000


# ---------------------------------------------------------------------------
# Phase 42: the iteration steps on a data × model mesh
# ---------------------------------------------------------------------------
MESH_AXES = ("data", "model")
# (b)'s meshes, over two gloo ranks sharing the card.
MESH_P2_SHAPES = ((1, 2), (2, 1))
# (c)'s production meshes, and the worker processes that trace the lowerings.
MESH_PRODUCTION = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")))
MESH_LOWER_WORKERS = 6


def _table2(T: int, m_shot: int = 1) -> dict:
    return dict(n_trials=T, m_shot=m_shot, tau=100, i0_min=1, i0_max=32)


def _mesh_p2_cases(dev):
    """(b)'s cases, one iteration at (a)'s shapes: (name, batched, form,
    state, operands) for the single step on K2000 and the batched step in
    each of phase 41's four forms on B = 2 complete graphs of 2000 spins
    (K2000 and a second seed: equal degrees, so the adjacency stacks)."""
    import numpy as np

    from repro_torch.core import gset
    from repro_torch.core.engine import pack_spins
    from repro_torch.kernels.bitplane import adjacency_weight_bits, pack_couplings_from_adjacency

    models = [gset.load("K2000").to_ising(), gset.complete_graph(2000, seed=1).to_ising()]
    N, T = 2000, 100
    h = torch.from_numpy(np.stack([m.h for m in models]).astype(np.int32)).to(dev)
    dense_J = torch.from_numpy(np.stack([m.dense_J() for m in models])).to(dev, torch.float32)
    cases = [("single", False, {}, _seeded_state(0, T, N, dev), (dense_J[0], h[0]))]
    nb = max(adjacency_weight_bits(m.n, m.nbr_idx, m.nbr_w) for m in models)
    pjs = [pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w, n_bits=nb, device=dev)
           for m in models]
    operands = {
        "dense": (dense_J,),
        "tiled": tuple(torch.from_numpy(np.stack([getattr(m, k) for m in models])).to(
            dev, torch.int32) for k in ("nbr_idx", "nbr_w")),
        "popcount": tuple(torch.stack([getattr(pj, k) for pj in pjs])
                          for k in ("sign", "mags", "base")),
    }
    state0 = _seeded_state([0, 1], T, N, dev)
    for layout, j_mode, field_mode in STEP_FORMS:
        state = state0
        if layout == "packed":
            state = (state0[0], pack_spins(state0[1]), state0[2], state0[3],
                     pack_spins(state0[4]))
        form = dict(storage_layout=layout, j_mode=j_mode, field_mode=field_mode)
        problem = operands["popcount" if field_mode == "popcount" else j_mode]
        cases.append((f"{layout}/{j_mode}/{field_mode}", True, form, state, (*problem, h)))
    return cases


def _mesh_step_fn(batched, form, mesh):
    from repro_torch.core.distributed import make_batched_iteration_step, make_iteration_step
    from repro_torch.core.ssa import SSAHyperParams

    hp = SSAHyperParams(**_table2(100))
    if batched:
        return make_batched_iteration_step(hp, mesh, **form)
    return make_iteration_step(hp, mesh)


def _mesh_worker(rank: int, world: int, store: str, out_path: str):
    """Phase 42 (b)'s ranks: gloo over a file rendezvous, sharing the card;
    each case's blocks after one iteration on each mesh, saved for the
    parent to join."""
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import convert
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    cases = _mesh_p2_cases(torch.device("cuda"))
    out = {}
    t0 = time.time()
    for shape in MESH_P2_SHAPES:
        mesh = make_mesh(shape, MESH_AXES)
        for name, batched, form, state, problem in cases:
            st, prob = convert.iteration_state_block(state, problem, mesh, batched=batched,
                                                     **form)
            out[shape, name] = [t.cpu() for t in _mesh_step_fn(batched, form, mesh)(*st, *prob)]
    torch.cuda.synchronize()
    torch.save(out, out_path.format(rank=rank))
    if rank == 0:
        print(f"MESH_P2 {time.time() - t0:.3f}", flush=True)
    dist.destroy_process_group()


def _lower_cell(what: str, mesh_shape, axes, form, shape_kw: dict, hp_kw: dict) -> dict:
    """One lowering traced in a worker process: per device its argument
    bytes, peak estimate, FLOPs, collective bytes by kind and roofline
    terms on the H100 (and the compute term at PEAK_F32_FLOPS, phase 41's
    bound's rate)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.distributed import anneal_step_lowering, batched_anneal_step_lowering
    from repro_torch.core.ssa import SSAHyperParams
    from repro_torch.launch.hlo_analysis import HW, collective_bytes, roofline
    from repro_torch.sharding import abstract_mesh

    mesh = abstract_mesh(mesh_shape, axes)
    hp = SSAHyperParams(**hp_kw)
    t0 = time.perf_counter()
    if form is None:
        low = anneal_step_lowering(mesh, hp=hp, **shape_kw)
    else:
        low = batched_anneal_step_lowering(mesh, hp=hp, **form, **shape_kw)
    secs = time.perf_counter() - t0
    rep = roofline(low)
    return dict(what=what, mesh="x".join(map(str, mesh_shape)), seconds=secs,
                args=low.argument_bytes, peak=low.peak_bytes, flops=low.flops,
                coll={k: v for k, v in collective_bytes(low).items() if v},
                n_coll=len(low.collectives), n_ops=len(low.ops), report=rep.asdict(),
                t_compute_67=roofline(low, hw=HW(peak_flops_f32=PEAK_F32_FLOPS)).t_compute)


def _lower_cells():
    """(c)'s lowerings at the production meshes, then (d)'s at 1 × 1."""
    cells = []
    for shape, axes in MESH_PRODUCTION:
        cells.append(("single N=2000 T=4096", shape, axes, None, {}, _table2(4096)))
        for layout, j_mode, field_mode in STEP_FORMS:
            cells.append((f"batched B=8 T=512 N=2048 {layout}/{j_mode}/{field_mode}", shape,
                          axes, dict(storage_layout=layout, j_mode=j_mode,
                                     field_mode=field_mode), {}, _table2(512)))
    for T in (100, STEP_TRIALS):
        cells.append((f"phase 41 cell N=2000 T={T}", (1, 1), MESH_AXES, None,
                      dict(n_spins=2000, n_trials=T), _table2(T)))
    # The popcount and tiled traces are the longest: start them first.
    return sorted(cells, key=lambda c: c[3] is None or c[3]["j_mode"] == "dense"
                  and c[3]["field_mode"] == "dense")


def phase_mesh_step(card: str, production, it41):
    """Phase 42: the iteration steps on a data × model mesh (no kernel; the
    K1–K4 counters must stay 0).  (a) K2000 on a one-rank 1 × 1 NCCL mesh
    == phase 41's mesh=None run; (b) two gloo ranks as 1 × 2 and 2 × 1 ==
    mesh=None; (c) the lowerings at the production meshes; (d) at 1 × 1,
    the compute term against phase 41's bound."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    import numpy as np

    from repro_torch import convert, sharding
    from repro_torch.core import gset
    from repro_torch.core.distributed import make_iteration_step
    from repro_torch.core.ssa import SSAHyperParams
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    _reset_counts()
    # (a) phase 41's K2000 chain on a one-rank NCCL mesh.
    model = gset.load("K2000").to_ising()
    N, T = model.n, 100
    hp = SSAHyperParams(**_table2(T, M_SHOT_PRODUCTION))
    mesh = make_mesh((1, 1), MESH_AXES)
    state0 = _seeded_state(0, T, N, dev)
    J = torch.from_numpy(model.dense_J()).to(dev, torch.float32)
    h = torch.from_numpy(np.asarray(model.h, np.int32)).to(dev)
    st, prob = convert.iteration_state_block(state0, (J, h), mesh)
    del J
    step = make_iteration_step(hp, mesh)
    step(*st, *prob)  # warm-up
    sharding.reset_collective_counts()
    st, ms, peak = _step_issued(step, st, prob, hp.m_shot)
    colls = {k: v // hp.m_shot for k, v in sorted(sharding.collective_counts.items())}
    whole = convert.iteration_state_join([st], mesh, state0)
    if not all(torch.equal(a, b) for a, b in zip(whole, it41["state"])):
        _fail("mesh step (a): the 1 x 1 mesh's leaves differ from phase 41's mesh=None run")
    if not (np.array_equal(whole[3].cpu().numpy(), production.best_energy)
            and np.array_equal(whole[4].cpu().numpy(), production.best_m)):
        _fail("mesh step (a): best_H/best_m differ from phase 6's K1 run")
    print(f"[mesh step] (a) K2000 N={N} T={T} tau={hp.tau} I0 1->32, {hp.m_shot} iterations on a "
          f"one-rank 1 x 1 {mesh.backend} mesh: == phase 41's mesh=None run in every leaf "
          f"(== phase 6's K1 run); {ms:.3f} ms an iteration issued from Python (phase 41: "
          f"{it41['ms']:.3f}); collectives an iteration {colls}; peak device bytes {peak} "
          f"(phase 41: {it41['peak']})  ({card})")
    del st, prob, whole, step, state0
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    # (b) two gloo ranks sharing the card, while (c) and (d) trace in workers.
    cells = _lower_cells()
    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ProcessPoolExecutor(
            MESH_LOWER_WORKERS, mp_context=spawn) as pool:
        futures = [pool.submit(_lower_cell, *cell) for cell in cells]
        cases = _mesh_p2_cases(dev)
        refs = {name: [t.cpu() for t in _mesh_step_fn(batched, form, None)(*state, *problem)]
                for name, batched, form, state, problem in cases}
        out_path = str(Path(tmp) / "rank{rank}.pt")
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
                                   str(r), "2", str(Path(tmp) / "store"), out_path],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [pr.communicate(timeout=600) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        wall = time.time() - t0
        for r, (pr, (_, err)) in enumerate(zip(procs, outs)):
            if pr.returncode:
                _fail(f"mesh step (b): rank {r} exited {pr.returncode}: {err[-1500:]}")
        blocks = [torch.load(out_path.format(rank=r)) for r in range(2)]
        results = [f.result() for f in futures]
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith("MESH_P2"))
    for shape in MESH_P2_SHAPES:
        for name, batched, form, *_ in cases:
            joined = convert.iteration_state_join(
                [b[shape, name] for b in blocks], sharding.abstract_mesh(shape, MESH_AXES),
                refs[name], batched=batched, **form)
            if not all(torch.equal(a, b) for a, b in zip(joined, refs[name])):
                _fail(f"mesh step (b): {name} on the {shape} mesh differs from mesh=None")
    print(f"[mesh step] (b) two gloo ranks sharing the card, meshes "
          f"{' and '.join('x'.join(map(str, s)) for s in MESH_P2_SHAPES)}, one iteration "
          f"(N=2000, T=100; B=2): the single step and the batched "
          f"{', '.join(c[0] for c in cases[1:])} == mesh=None in every leaf; ranks "
          f"{line.split()[1]} s of steps, processes {wall:.3f} s; the ranks share the SMs "
          f"and the lowerings' workers the cores, so no speed is read")
    # (c) the production meshes.
    for r in results:
        if r["mesh"] == "1x1":
            continue
        rep = r["report"]
        print(f"[mesh lowering] {r['mesh']} {r['what']}, per device: args {r['args']} B, peak "
              f"estimate {r['peak']} B, {r['flops']:.4g} FLOPs, collective bytes {r['coll']} "
              f"({r['n_coll']} collectives); H100 terms compute {rep['t_compute_s'] * 1e3:.3f} "
              f"ms, memory {rep['t_memory_s'] * 1e3:.3f} ms, collective "
              f"{rep['t_collective_s'] * 1e3:.3f} ms ({rep['coll_link']}): "
              f"{rep['dominant']}-bound ({r['n_ops']} ops traced in {r['seconds']:.1f} s)")
    # (d) phase 41's cells at 1 x 1: the compute term against phase 41's bound.
    for r, (T, measured) in zip([r for r in results if r["mesh"] == "1x1"],
                                ((100, it41["peak"]), (STEP_TRIALS, it41["peak_T4096"]))):
        bound, by = _step_bound_ms(SSAHyperParams(**_table2(T)), 1, 2000)
        term = r["t_compute_67"] * 1e3
        if by != "operations" or abs(term - bound) > 1e-3 * bound:
            _fail(f"mesh lowering (d) T={T}: compute term {term:.4f} ms != phase 41's bound "
                  f"{bound:.4f} ms ({by})")
        print(f"[mesh lowering] (d) 1x1 {r['what']}: compute term {term:.3f} ms at 67 TFLOP/s "
              f"== phase 41's bound {bound:.3f} ms (ratio {term / bound:.6f}); peak estimate "
              f"{r['peak']} B against phase 41's measured {measured} B (ratio "
              f"{r['peak'] / measured:.3f})  ({card})")
    counts = _counts()
    print(f"[mesh step] (K1, K3, K4, K2, K1 ring, K2 ring) = {counts}")
    _counters_zero("mesh step", counts)


# ---------------------------------------------------------------------------
# Phase 43: the LM served on a data × model mesh (no kernel)
# ---------------------------------------------------------------------------
# (a) and (b): the new tokens of generate() and the decode steps fed
# mesh=None's greedy tokens (a prompt of LM_PROMPT: max_seq 136 is cut by
# sequence on model = 2, so (b)'s decode is flash-decode and its prefill's
# caches go through an all-to-all).
LM_MESH_NEW = 8
LM_MESH_STEPS = LM_MESH_NEW - 1
LM_MESH_CELLS = (("prefill_32k", "single"), ("prefill_32k", "pod"), ("decode_32k", "single"),
                 ("decode_32k", "pod"))


def _lm_steps(params, batch, cfg, tokens, max_seq, mesh=None):
    """(prefill logits, decode logits fed ``tokens`` step by step, ms a
    decode step, collectives a decode step): float32 logits on the CPU."""
    from repro_torch import sharding
    from repro_torch.models import decode_step, prefill

    logits, caches = prefill(params, batch, cfg, mesh=mesh, max_seq=max_seq)
    S = batch["tokens"].shape[1]
    rows = []
    torch.cuda.synchronize()
    sharding.reset_collective_counts()
    t0 = time.perf_counter()
    for i in range(tokens.shape[1]):
        lg, caches = decode_step(params, caches, tokens[:, i], S + i, cfg, mesh=mesh,
                                 max_seq=max_seq)
        rows.append(lg.float().cpu())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / tokens.shape[1]
    colls = {k: v / tokens.shape[1] for k, v in sorted(sharding.collective_counts.items())}
    return logits.float().cpu(), torch.stack(rows, 1), ms, colls


def _lm_mesh_worker(rank: int, world: int, store: str, ref_path: str, out_path: str):
    """Phase 43 (b)'s ranks: gloo over a file rendezvous, sharing the card;
    each holds its blocks of qwen3-1.7b's parameters and runs prefill,
    the decode steps fed mesh=None's tokens, and generate()."""
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import configs, convert
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params, tree_paths
    from repro_torch.serve import lm

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    mesh = make_mesh((1, world), MESH_AXES)
    dev = mesh.device
    ref = torch.load(ref_path)
    cfg = configs.get_config(LM_ARCH)
    whole = init_params(model_defs(cfg), seed=0, device=dev)
    params = convert.lm_params_block(whole, cfg, mesh.shape, mesh.coords)
    del whole
    torch.cuda.empty_cache()
    held = sum(t.numel() * t.element_size() for _, t in tree_paths(params))
    batch = {k: v.to(dev) for k, v in ref["batch"].items()}
    max_seq = LM_PROMPT + LM_MESH_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = dict(zip(("prefill", "decode", "ms", "colls"), _lm_steps(
        params, batch, cfg, ref["tokens"][:, :LM_MESH_STEPS].to(dev), max_seq, mesh)))
    out["tokens"] = torch.from_numpy(lm.generate(params, batch, cfg,
                                                 lm.ServeConfig(max_seq=max_seq), LM_MESH_NEW,
                                                 mesh=mesh))
    out.update(peak=torch.cuda.max_memory_allocated(), held=held, seconds=time.time() - t0)
    torch.save(out, out_path.format(rank=rank))
    dist.destroy_process_group()


def _lm_lower_cell(shape_name: str, mesh_kind: str) -> dict:
    """One serving dry-run cell traced in a worker process."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.dryrun import run_cell

    return run_cell(LM_ARCH, shape_name, mesh_kind, verbose=False, analysis=True)


def phase_lm_mesh(card: str, traces=None):
    """Phase 43: qwen3-1.7b served on a data × model mesh (no kernel; the
    K1–K4 counters must stay 0).  (a) a one-rank 1 × 1 NCCL mesh ==
    mesh=None; (b) two gloo ranks sharing the card as 1 × 2 within
    LM_STEPS_DEEP bf16 steps; (c) the serving dry-run at the production
    meshes (``traces``: futures of :func:`_lm_lower_cell` started before
    phase 39; traced here in worker processes while (a) and (b) run when
    None)."""
    import concurrent.futures
    import contextlib
    import multiprocessing
    import tempfile

    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params, tree_paths
    from repro_torch.serve import lm

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    _reset_counts()
    cfg = configs.get_config(LM_ARCH)
    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp, (
            contextlib.nullcontext() if traces else concurrent.futures.ProcessPoolExecutor(
                len(LM_MESH_CELLS), mp_context=spawn)) as pool:
        # (c) first: its traces run on the host's cores while (a) and (b) run
        futures = traces or [pool.submit(_lm_lower_cell, *cell) for cell in LM_MESH_CELLS]
        params = init_params(model_defs(cfg), seed=0, device=dev)
        batch = _lm_batch(cfg, LM_BATCH, LM_PROMPT, 0, dev)
        # (a) a one-rank NCCL mesh against mesh=None; mesh=None's run is (b)'s reference
        max_seq = LM_PROMPT + LM_MESH_NEW
        sc = lm.ServeConfig(max_seq=max_seq)
        ref_tokens = lm.generate(params, batch, cfg, sc, LM_MESH_NEW)
        mesh = make_mesh((1, 1), MESH_AXES)
        got = lm.generate(params, batch, cfg, sc, LM_MESH_NEW, mesh=mesh)
        toks = torch.from_numpy(ref_tokens[:, :LM_MESH_STEPS]).to(dev)
        ref_pre, ref_dec, ms_ref, _ = _lm_steps(params, batch, cfg, toks, max_seq)
        pre_m, dec_m, ms_m, colls_m = _lm_steps(params, batch, cfg, toks, max_seq, mesh)
        tol_a = _lm_tol(LM_STEPS_DEEP, ref_dec)
        err_a = max(float((pre_m - ref_pre).abs().max()), float((dec_m - ref_dec).abs().max()))
        print(f"[lm mesh] (a) {LM_ARCH} full width, generate() {LM_BATCH} x {LM_PROMPT} + "
              f"{LM_MESH_NEW} greedy on a one-rank 1 x 1 {mesh.backend} mesh: tokens "
              f"{'==' if np.array_equal(got, ref_tokens) else '!='} mesh=None's; prefill + "
              f"{LM_MESH_STEPS} decode steps max |Δlogit| {err_a:.4f} (tol {tol_a:.4f} = "
              f"{LM_STEPS_DEEP} bf16 steps); {ms_m:.3f} ms a decode step (mesh=None "
              f"{ms_ref:.3f}); collectives a step {colls_m}  ({card})")
        if not np.array_equal(got, ref_tokens):
            _fail("lm mesh (a): the 1 x 1 mesh's greedy tokens differ from mesh=None's")
        if err_a > tol_a:
            _fail(f"lm mesh (a): |Δlogit| {err_a} > {tol_a}")
        torch.distributed.destroy_process_group()
        whole_bytes = sum(t.numel() * t.element_size() for _, t in tree_paths(params))
        del params, pre_m, dec_m
        torch.cuda.empty_cache()
        # (b) two gloo ranks sharing the card
        ref_path = str(Path(tmp) / "ref.pt")
        torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                    "tokens": torch.from_numpy(ref_tokens)}, ref_path)
        out_path = str(Path(tmp) / "rank{rank}.pt")
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--lm-mesh-rank", str(r), "2", str(Path(tmp) / "store"),
                                   ref_path, out_path],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [pr.communicate(timeout=600) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        wall = time.time() - t0
        for r, (pr, (_, err)) in enumerate(zip(procs, outs)):
            if pr.returncode:
                _fail(f"lm mesh (b): rank {r} exited {pr.returncode}: {err[-1500:]}")
        ranks = [torch.load(out_path.format(rank=r)) for r in range(2)]
        for o in ranks:
            o["tokens"] = o["tokens"].numpy()
        records = [f.result() for f in futures]
    tol_b = _lm_tol(LM_STEPS_DEEP, ref_dec)
    errs = [max(float((o["prefill"] - ref_pre).abs().max()),
                float((o["decode"] - ref_dec).abs().max())) for o in ranks]
    for r, o in enumerate(ranks):
        if errs[r] > tol_b:
            _fail(f"lm mesh (b): rank {r}'s logits |Δ| {errs[r]} > {tol_b}")
        if not np.array_equal(o["tokens"], ranks[0]["tokens"]):
            _fail("lm mesh (b): the ranks' tokens differ")
    all_logits = torch.cat([ref_pre[:, None], ref_dec], 1)
    compared = _lm_margin_agree("lm mesh (b)", ranks[0]["tokens"], ref_tokens, all_logits,
                                _lm_tol(LM_STEPS_DEEP, all_logits))
    r0 = ranks[0]
    print(f"[lm mesh] (b) two gloo ranks sharing the card as 1 x 2: each holds "
          f"{r0['held']} B of parameters ({r0['held'] / whole_bytes:.3f} of {whole_bytes}); "
          f"prefill + {LM_MESH_STEPS} decode steps fed mesh=None's tokens max |Δlogit| "
          f"{max(errs):.4f} (tol {tol_b:.4f} = {LM_STEPS_DEEP} bf16 steps); generate() "
          f"{LM_MESH_NEW} new tokens == mesh=None's at {compared} of {ref_tokens.size} (up to "
          f"a near tie); {r0['ms']:.3f} ms a decode step (mesh=None {ms_ref:.3f}); collectives "
          f"a step {r0['colls']}; peak device bytes per rank "
          f"{[o['peak'] for o in ranks]}; ranks {max(o['seconds'] for o in ranks):.3f} s, "
          f"processes {wall:.3f} s  ({card})")
    for rec in records:
        if rec["status"] != "ok":
            _fail(f"lm mesh (c): {rec}")
        coll = {k: v for k, v in rec["coll_breakdown"].items() if v and k != "total"}
        print(f"[lm mesh lowering] {LM_ARCH} {rec['shape']} {rec['mesh']} ({rec['n_chips']} "
              f"ranks), per device: args {rec['argument_bytes_per_device']} B, peak estimate "
              f"{rec['peak_bytes_per_device']:.0f} B (fits 80 GB: {rec['fits_hbm_80g']}), "
              f"{rec['flops_per_device']:.4g} FLOPs, collective bytes {coll}; H100 terms compute "
              f"{rec['t_compute_s'] * 1e3:.3f} ms, memory {rec['t_memory_s'] * 1e3:.3f} ms, "
              f"collective {rec['t_collective_s'] * 1e3:.3f} ms ({rec['coll_link']}): "
              f"{rec['dominant']}-bound (traced in {rec['t_lower_s']:.1f} + "
              f"{rec['t_analysis_s']:.1f} s)")
    counts = _counts()
    print(f"[lm mesh] (K1, K3, K4, K2, K1 ring, K2 ring) = {counts}")
    _counters_zero("lm mesh", counts)


# ---------------------------------------------------------------------------
# Phase 44: the LM trained on a data × model mesh (none of the six kernels)
# ---------------------------------------------------------------------------
# (b)'s cut: qwen3-1.7b's full widths at 2 layers, B = 4, S = 128 (one loss
# chunk), phase 40's AdamW schedule with a clip that does not act (the
# update is then bit for bit mesh=None's); the gradients' tolerance is the
# CPU tests' GRAD_STEPS (tests/test_torch_train.py).
LM_TRAIN_MESH_B, LM_TRAIN_MESH_S, LM_TRAIN_MESH_LAYERS = 4, 128, 2
LM_TRAIN_MESH_SHAPES = ((1, 2), (2, 1))
GRAD_STEPS = 8
LM_TRAIN_CELLS = (("train_4k", "single"), ("train_4k", "pod"))
LM_TRACE_WORKERS = 2


def _lm_train_mesh_worker(rank: int, world: int, store: str, out_path: str):
    """Phase 44 (b)'s ranks: gloo over a file rendezvous, sharing the card.
    On each mesh a rank cuts its blocks of the whole 2-layer state
    (``convert.train_state_block``), runs one step — the gradients, then
    the ZeRO-1 update, timed together — and checks on the card what it
    holds: its gradient blocks against the mesh=None run's, its update of
    them against mesh=None's update of the joined gradients."""
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import configs, convert, sharding
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params, param_pspecs, tree_map, tree_paths
    from repro_torch.optim import AdamWConfig, OptState, adamw_init, adamw_update
    from repro_torch.train import TrainConfig, TrainState, make_grad_fn

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    cfg = dataclasses.replace(configs.get_config(LM_ARCH), n_layers=LM_TRAIN_MESH_LAYERS)
    tc = TrainConfig(opt=AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=40,
                                     clip_norm=1e9), loss_chunk=LM_TRAIN_MESH_S)
    dc = DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_MESH_S, global_batch=LM_TRAIN_MESH_B)
    out = {}
    for shape in LM_TRAIN_MESH_SHAPES:
        mesh = make_mesh(shape, MESH_AXES)
        dev = mesh.device
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        pspecs = param_pspecs(model_defs(cfg), mesh)
        params = init_params(model_defs(cfg), 0, dev)
        zeros = tree_map(lambda p: torch.zeros((), device=dev).expand(p.shape), params)
        whole = TrainState(params, OptState(torch.zeros((), dtype=torch.int32, device=dev),
                                            zeros, zeros))  # the moments' zeros unallocated
        sb = convert.train_state_block(whole, cfg, mesh.shape, mesh.coords)
        batch = synthetic_batch(dc, 0, device=dev)
        bb = convert.lm_batch_block(batch, mesh.shape, mesh.coords)
        gn, mn = make_grad_fn(cfg, tc)(params, batch)  # mesh=None on the whole state
        # one step on the mesh: its gradients, then its ZeRO-1 update
        torch.cuda.synchronize(dev)
        sharding.reset_collective_counts()
        t1 = time.perf_counter()
        grads, metrics = make_grad_fn(cfg, tc, mesh)(sb.params, bb)
        pm, om, am = adamw_update(sb.params, grads, sb.opt, tc.opt, mesh=mesh,
                                  param_specs=pspecs)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t1) * 1e3
        colls = dict(sharding.collective_counts)
        steps, leaf = _grad_steps(grads, convert.lm_params_block(gn, cfg, mesh.shape,
                                                                 mesh.coords))
        loss = (float(metrics["ce_loss"]), float(mn["ce_loss"]))
        del gn
        # mesh=None's update of the joined gradients, cut as this rank holds it
        joined = tree_map(lambda g, sp: sharding.unshard(mesh, g, sp), grads, pspecs)
        pn, on, _ = adamw_update(params, joined, adamw_init(params, tc.opt), tc.opt)
        want = convert.train_state_block(TrainState(pn, on), cfg, mesh.shape, mesh.coords)
        del joined, pn, on, whole, params, zeros
        same = all(torch.equal(a, b) for a, b in zip(
            _leaves(pm) + _leaves(om.mu) + _leaves(om.nu),
            _leaves(want.params) + _leaves(want.opt.mu) + _leaves(want.opt.nu)))
        del pm, om, want, grads
        # ZeRO-1: the moment bytes this rank holds of each leaf that data cuts
        held = whole_b = 0
        for (path, m), (_, p) in zip(tree_paths(sb.opt.mu), tree_paths(sb.params)):
            if m.shape != p.shape:
                held += m.numel() * m.element_size()
                whole_b += p.numel() * 4
        out["x".join(map(str, shape))] = dict(
            steps=steps, leaf=leaf, loss=loss, same=same, tokens=float(metrics["tokens"]),
            grad_norm=float(am["grad_norm"]), zero1_share=held / whole_b if whole_b else None,
            ms=ms, colls=colls, peak=torch.cuda.max_memory_allocated(dev),
            seconds=time.time() - t0)
        del sb
        torch.cuda.empty_cache()
    torch.save(out, out_path.format(rank=rank))
    dist.destroy_process_group()


def _lm_train_one_rank(card: str, full: dict):
    """(a): phase 40's run on a one-rank 1 × 1 NCCL mesh, step by step."""
    from repro_torch import configs, convert, sharding
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import init_train_state, make_train_step

    cfg = configs.get_config(LM_ARCH)
    args = launch_train.parse_args(list(TRAIN_ARGV))
    tc, dc = launch_train.run_configs(args, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((1, 1), MESH_AXES)
    state = init_train_state(cfg, tc, 0, mesh=mesh)
    step = make_train_step(cfg, tc, mesh=mesh)
    hist, colls = [], []
    for s in range(args.steps):
        batch = convert.lm_batch_block(synthetic_batch(dc, s, device=mesh.device), mesh.shape,
                                       mesh.coords)
        torch.cuda.synchronize()
        sharding.reset_collective_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        row = {k: float(m[k]) for k in ("ce_loss", "grad_norm", "lr")}
        torch.cuda.synchronize()
        row["ms"] = (time.perf_counter() - t0) * 1e3
        hist.append(row)
        colls.append(dict(sharding.collective_counts))
    peak = torch.cuda.max_memory_allocated()
    digests = _state_digests(state)
    del state
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    same_metrics = all(h[k] == f[k] for h, f in zip(hist, full["history"])
                       for k in ("ce_loss", "grad_norm", "lr")) and len(hist) == len(
        full["history"])
    differ = [k for k in digests if digests[k] != full["digests"][k]]
    ms = sum(h["ms"] for h in hist[1:]) / max(len(hist) - 1, 1)
    rows = "; ".join(f"step {i + 1}: ce_loss {h['ce_loss']:.4f} grad_norm {h['grad_norm']:.4f} "
                     f"lr {h['lr']:.6g} ({h['ms']:.1f} ms)" for i, h in enumerate(hist))
    print(f"[lm train mesh] (a) {LM_ARCH} full width, phase 40's {len(hist)} AdamW steps of 8 x "
          f"512 on a one-rank 1 x 1 {mesh.backend} mesh: {rows}; ce_loss, grad_norm and lr "
          f"{'==' if same_metrics else '!='} phase 40's at every step; final parameters, mu "
          f"and nu {'==' if not differ else '!='} phase 40's in all {len(digests)} leaves "
          f"(bit digests on the card); {ms:.3f} ms a step after the first (phase 40 "
          f"{full['ms']:.3f}); collectives a step {colls[-1]}; peak device bytes {peak}  "
          f"({card})")
    if not same_metrics:
        _fail(f"lm train mesh (a): metrics differ from phase 40's: {hist} / {full['history']}")
    if differ:
        _fail(f"lm train mesh (a): leaves differ from phase 40's: {differ[:5]}")


def _lm_train_mesh_ranks(card: str):
    """(b): two gloo ranks sharing the card, at 1 × 2 and 2 × 1."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out_path = str(Path(tmp) / "rank{rank}.pt")
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--lm-train-mesh-rank", str(r), "2", str(Path(tmp) / "store"),
                                   out_path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(2)]
        try:
            outs = [pr.communicate(timeout=600) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        wall = time.time() - t0
        for r, (pr, (_, err)) in enumerate(zip(procs, outs)):
            if pr.returncode:
                _fail(f"lm train mesh (b): rank {r} exited {pr.returncode}: {err[-1500:]}")
        ranks = [torch.load(out_path.format(rank=r)) for r in range(2)]
    for shape in LM_TRAIN_MESH_SHAPES:
        key = "x".join(map(str, shape))
        rs = [o[key] for o in ranks]
        steps = max(r["steps"] for r in rs)
        share = [r["zero1_share"] for r in rs]
        print(f"[lm train mesh] (b) two gloo ranks sharing the card as {shape[0]} x {shape[1]}, "
              f"{LM_ARCH} widths at {LM_TRAIN_MESH_LAYERS} layers, B={LM_TRAIN_MESH_B} "
              f"S={LM_TRAIN_MESH_S}: gradient blocks within {steps:.3f} bf16 steps of mesh=None's "
              f"on the card (tol {GRAD_STEPS}; worst leaf {rs[0]['leaf']}); ce_loss "
              f"{rs[0]['loss'][0]:.6f} vs mesh=None {rs[0]['loss'][1]:.6f}; ZeRO-1 adamw_update "
              f"of the joined gradients {'==' if all(r['same'] for r in rs) else '!='} "
              f"mesh=None's bit for bit (clip not acting: grad_norm {rs[0]['grad_norm']:.4f}); "
              f"moment bytes held of the data-cut leaves {share}; ms a step per rank "
              f"{[round(r['ms'], 3) for r in rs]}; collectives a step {rs[0]['colls']}; peak "
              f"device bytes per rank {[r['peak'] for r in rs]}; ranks "
              f"{max(r['seconds'] for r in rs):.1f} s, processes {wall:.1f} s  ({card})")
        if steps > GRAD_STEPS:
            _fail(f"lm train mesh (b) {shape}: gradients {steps} bf16 steps from mesh=None's")
        if not all(r["same"] for r in rs):
            _fail(f"lm train mesh (b) {shape}: the ZeRO-1 update differs from mesh=None's")
        if shape[0] == 2 and any(abs(x - 0.5) > 1e-12 for x in share):
            _fail(f"lm train mesh (b) {shape}: ranks hold {share} of the moment bytes, not 0.5")


def _lm_train_records(records):
    for rec in records:
        if rec["status"] != "ok" or not 0.01 < rec["useful_flops_ratio"] < 100:
            _fail(f"lm train mesh (c): {rec}")
        coll = {k: v for k, v in rec["coll_breakdown"].items() if v and k != "total"}
        print(f"[lm train mesh lowering] {LM_ARCH} {rec['shape']} {rec['mesh']} "
              f"({rec['n_chips']} ranks), per device: args {rec['argument_bytes_per_device']} B, "
              f"peak estimate {rec['peak_bytes_per_device']:.0f} B (fits 80 GB: "
              f"{rec['fits_hbm_80g']}), {rec['flops_per_device']:.4g} FLOPs, collective bytes "
              f"{coll}; H100 terms compute {rec['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{rec['t_memory_s'] * 1e3:.3f} ms, collective {rec['t_collective_s'] * 1e3:.3f} ms "
              f"({rec['coll_link']}): {rec['dominant']}-bound; useful_flops_ratio "
              f"{rec['useful_flops_ratio']:.4f} (traced in {rec['t_lower_s']:.1f} + "
              f"{rec['t_analysis_s']:.1f} s)")


def phase_lm_train_mesh(card: str, full: dict, traces=None):
    """Phase 44: qwen3-1.7b trained on a data × model mesh (no kernel; the
    K1–K4 counters must stay 0).  (a) phase 40's run on a one-rank 1 × 1
    NCCL mesh == phase 40 bit for bit; (b) two gloo ranks sharing the card
    as 1 × 2 and 2 × 1; (c) the train dry-run at the production meshes
    (``traces``: futures of :func:`_lm_lower_cell` started before phase
    39; traced here in worker processes when None)."""
    import concurrent.futures
    import multiprocessing

    _reset_counts()
    pool = None
    if traces is None:
        pool = concurrent.futures.ProcessPoolExecutor(
            len(LM_TRAIN_CELLS), mp_context=multiprocessing.get_context("spawn"))
        traces = [pool.submit(_lm_lower_cell, *cell) for cell in LM_TRAIN_CELLS]
    try:
        _lm_train_one_rank(card, full)
        _lm_train_mesh_ranks(card)
        records = [f.result() for f in traces]
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    _lm_train_records(records)
    counts = _counts()
    print(f"[lm train mesh] (K1, K3, K4, K2, K1 ring, K2 ring) = {counts}")
    _counters_zero("lm train mesh", counts)


def _time_phases() -> None:
    """Print each phase's wall seconds, and the script's seconds so far, to
    stderr as it ends (stdout keeps its lines): where the time limit goes."""
    t0 = time.perf_counter()
    g = globals()
    for name, fn in list(g.items()):
        if not (name.startswith("phase_") and callable(fn)):
            continue

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                now = time.perf_counter()
                print(f"[time] {_name} {now - t:.1f} s (at {now - t0:.1f} s)", file=sys.stderr,
                      flush=True)

        g[name] = functools.wraps(fn)(timed)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--spin-rank":
        return _spin_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        return _mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--lm-mesh-rank":
        return _lm_mesh_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    if len(sys.argv) > 1 and sys.argv[1] == "--lm-train-mesh-rank":
        return _lm_train_mesh_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.kernels.ssa_update  # noqa: F401 — fails alone, before any output
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: exact f32
    dev = torch.device("cuda")
    _time_phases()
    card = phase_card()
    phase_build()
    k3 = phase_k3(dev)
    k1 = phase_k1(dev)
    phase_threefry(dev)
    k4 = phase_k4(dev)
    streamed, (k1_launches, _, _, _), streamed_peak, streamed_wall = phase_anneal("production")
    _, (_, k3_launches, _, _), trace_peak, _ = phase_anneal("trace")
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
    problems, reqs, k1_resp, k1_service, k4_service, service_peak = phase_service()
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
    from repro_torch.sharding import spin_mesh

    mesh = spin_mesh(1)  # one-rank NCCL group
    k2_run = phase_spin_anneal(mesh)
    phase_spin_service(mesh, k2_run)
    phase_spin_p2(mesh, k2_run)
    torch.distributed.destroy_process_group()
    k1_auto = phase_auto(streamed)
    jd_rows, jd_launches = phase_j_dtype(dev, streamed, streamed_peak, trace_peak, problems,
                                         reqs, k1_resp, service_peak)
    paper = phase_paper()
    ring_rows, ring_launches, ring_service = phase_big_rings(dev)
    phase_ptssa_auto()
    # The LM dry-run traces of phases 43 and 44 (~2 minutes on two of the
    # host's cores) run while phases 39-41 keep the card busy.
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            LM_TRACE_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        traces = [pool.submit(_lm_lower_cell, *cell) for cell in LM_MESH_CELLS + LM_TRAIN_CELLS]
        try:
            phase_lm(card)
            full40 = phase_lm_train(card)
            it41 = phase_iteration_step(card, streamed)
            phase_mesh_step(card, streamed, it41)
            phase_lm_mesh(card, traces[:len(LM_MESH_CELLS)])
            phase_lm_train_mesh(card, full40, traces[len(LM_MESH_CELLS):])
        finally:
            for f in traces:
                f.cancel()

    def dtypes(kernel):  # a kernel's rows by J dtype
        return {name: jd_rows[name][kernel] for name in J_DTYPES}

    def rings(kernel, launches):  # a ring mode's rows by ring, those of the main path counted
        return {label: dict(row, launches=launches if (row["trials"], row["ring"], row["N"]) == (
            BIG_RING_TRIALS, BIG_RING, 2000) else 0) for label, row in ring_rows[kernel].items()}

    k1_fam = {k: fam[k][2] for k, _, field in FAMILIES if field == "dense"}
    k2_fam = {k: fam[k][2] for k, _, field in FAMILIES if field == "popcount"}
    kernels = [
        dict(name="ssa_plateau_packed (K1)", route="cuda",
             source="src/repro_torch/kernels/csrc/plateau.cu",
             replaces="src/repro/kernels/ssa_update.py:329",
             launches=k1_launches,
             service_launches={"service K1": k1_service, "service families": k1_fam_service},
             stream_launches={"stream K1": k1_stream, "stream families": k1_fam_stream},
             family_launches=k1_fam, auto_launches={"auto K2000": k1_auto},
             j_dtype_launches=jd_launches["K1"], paper_launches=paper["K1"],
             bf16=jd_rows["bfloat16"]["K1"], j_dtypes=dtypes("K1"), **k1),
        dict(name="local_field (K3)", route="cuda",
             source="src/repro_torch/kernels/csrc/field.cu",
             replaces="src/repro/kernels/ssa_update.py:90",
             launches=k3_launches, service_launches={}, stream_launches={},
             family_launches={}, auto_launches={}, j_dtype_launches=jd_launches["K3"],
             paper_launches=paper["K3"], bf16=jd_rows["bfloat16"]["K3"],
             j_dtypes=dtypes("K3"), **k3),
        dict(name="ssa_plateau (K4)", route="cuda",
             source="src/repro_torch/kernels/csrc/plateau_pregen.cu",
             replaces="src/repro/kernels/ssa_update.py:150",
             launches=k4_launches, service_launches={"service K4": k4_service},
             stream_launches={}, family_launches={}, auto_launches={},
             j_dtype_launches=jd_launches["K4"], paper_launches=paper["K4"],
             bf16=jd_rows["bfloat16"]["K4"], j_dtypes=dtypes("K4"), **k4),
        dict(name="ssa_plateau_popcount (K2)", route="cuda",
             source="src/repro_torch/kernels/csrc/popcount.cu",
             replaces="src/repro/kernels/ssa_update.py:668",
             launches=k2_launches,
             service_launches={"service K2": k2_service,
                               "service tiled K2": k2_tiled_service,
                               "service families": k2_fam_service},
             stream_launches={"stream K2": k2_stream, "stream families": k2_fam_stream},
             family_launches=k2_fam, auto_launches={}, j_dtype_launches={},
             paper_launches={}, **k2),
        dict(name="ssa_plateau_packed ring mode (K1, SSQA)", route="cuda",
             source="src/repro_torch/kernels/csrc/plateau.cu",
             replaces="src/repro/kernels/ssa_update.py:329",
             launches=k1_ring_launches,
             service_launches={"service SSQA dense field": k1_ring_service,
                               f"service auto, rings of {BIG_RING}": ring_service},
             stream_launches={"stream SSQA dense field": k1_ring_stream},
             family_launches={}, auto_launches={}, j_dtype_launches=jd_launches["K1 ring"],
             paper_launches={}, bf16=jd_rows["bfloat16"]["K1 ring"],
             j_dtypes=dtypes("K1 ring"), rings=rings("K1 ring", ring_launches["dense field"]),
             **k1_ring),
        dict(name="ssa_plateau_popcount ring mode (K2, SSQA)", route="cuda",
             source="src/repro_torch/kernels/csrc/popcount.cu",
             replaces="src/repro/kernels/ssa_update.py:668",
             launches=k2_ring_launches,
             service_launches={"service SSQA popcount": k2_ring_service},
             stream_launches={"stream SSQA popcount": k2_ring_stream},
             family_launches={}, auto_launches={}, j_dtype_launches={}, paper_launches={},
             rings=rings("K2 ring", ring_launches["popcount"]), **k2_ring),
    ]
    print(card)  # again, so that it stands in the last lines of the output
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
