"""The port's ``AnnealService`` against the JAX package's, on the CPU.

Mirrors ``tests/test_anneal_service.py``, ``tests/test_ssqa_service.py``
and the tests of ``tests/test_chaos.py`` that need no checkpoints: the same
requests, from the same seeds, through the JAX service (its pallas backend
in interpret mode) and the port's (its cuda backend as the kernels' plain
versions).  Results, chunk traces, statuses and event kinds must be equal,
bit for bit; with xorshift noise each response must also equal the port's
unpadded single-problem ``anneal()`` / ``anneal_ssqa()``.  Inputs that are
not ported raise NotImplementedError naming their ROADMAP.md step.
"""
import dataclasses
import functools
import gc
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core.ssqa import SSQAHyperParams as JSSQA  # noqa: E402
from repro.ft import faults as jfaults  # noqa: E402
from repro.serve import AnnealRequest as JRequest  # noqa: E402
from repro.serve import AnnealService as JService  # noqa: E402
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ising import IsingModel  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams, anneal  # noqa: E402
from repro_torch.core.ssqa import SSQAHyperParams, anneal_ssqa  # noqa: E402
from repro_torch.ft.faults import (  # noqa: E402
    FaultInjector,
    InjectedCompileFailure,
    InjectedKill,
    InjectedOOM,
    chaos_schedule,
)
from repro_torch.kernels._build import KernelBuildError  # noqa: E402
from repro_torch.kernels.ssa_update import KernelLaunchError  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    AnnealRequest,
    AnnealService,
    ResiliencePolicy,
    family_for,
    registered_algos,
)
from repro_torch.serve.resilience import classify_fault, fallback_step  # noqa: E402

HP = dict(n_trials=3, m_shot=4, tau=4, i0_min=1, i0_max=8)
HP_CHAOS = dict(HP, m_shot=6)
SSQA = dict(n_trials=8, n_replicas=4, m_shot=3, tau=4, i0_min=1, i0_max=8)
# (port backend, JAX backend)
BACKENDS = [("sparse", "sparse"), ("dense", "dense"), ("cuda", "pallas")]
JAX_NAME = dict(BACKENDS)


def _svc(backend, **kw):
    return AnnealService(backend=backend, min_bucket=16, device="cpu", **kw)


def _jsvc(backend, **kw):
    return JService(backend=JAX_NAME.get(backend, backend), min_bucket=16, **kw)


def _mixed(g):
    """Sizes spanning two buckets (min_bucket=16 → 64, 128)."""
    return [g.toroidal_grid(36, seed=1, name="t36"), g.king_graph(49, seed=2, name="k49"),
            g.toroidal_grid(64, seed=3, name="t64"), g.toroidal_grid(100, seed=4, name="t100")]


def _chaos_problems(g):
    return [g.toroidal_grid(36, seed=0, name="t36"), g.king_graph(36, seed=3, name="k36")]


def _ssqa_problems(g):
    return [g.toroidal_grid(50, seed=17, name="t50"), g.king_graph(49, seed=3, name="k49")]


def _requests(kind, jax=False, **kw):
    """The request list of one mirrored test family, for either package."""
    g = jgset if jax else gset
    Req = JRequest if jax else AnnealRequest
    if kind == "mixed":
        hp = (JHP if jax else SSAHyperParams)(**HP)
        return [Req(problem=p, hp=hp, seed=10 + i, **kw) for i, p in enumerate(_mixed(g))]
    if kind == "chaos":
        hp = (JHP if jax else SSAHyperParams)(**HP_CHAOS)
        return [Req(problem=p, hp=hp, seed=i + 1, **kw)
                for i, p in enumerate(_chaos_problems(g))]
    hp = (JSSQA if jax else SSQAHyperParams)(**SSQA)
    return [Req(problem=p, hp=hp, seed=7 + 2 * i, algo="ssqa", **kw)
            for i, p in enumerate(_ssqa_problems(g))]


@functools.lru_cache(maxsize=None)
def _jax_solve(kind, backend):
    return _jsvc(backend).solve(_requests(kind, jax=True))


def _assert_bit_identical(got, want):
    """Result and trace equality (as the JAX package's chaos tests hold it)."""
    np.testing.assert_array_equal(got.result.best_energy, np.asarray(want.result.best_energy))
    np.testing.assert_array_equal(got.result.best_m, np.asarray(want.result.best_m))
    np.testing.assert_array_equal(got.chunk_best_cut, np.asarray(want.chunk_best_cut))


def _assert_same(got, want):
    np.testing.assert_array_equal(got.result.best_energy, np.asarray(want.result.best_energy))
    np.testing.assert_array_equal(got.result.best_m, np.asarray(want.result.best_m))
    np.testing.assert_array_equal(got.result.best_cut, np.asarray(want.result.best_cut))
    np.testing.assert_array_equal(got.chunk_best_cut, np.asarray(want.chunk_best_cut))
    assert (got.status, got.chunks_run, got.chunks_total, got.bucket, got.batch) == (
        want.status, want.chunks_run, want.chunks_total, want.bucket, want.batch)
    assert [e.kind for e in got.events] == [e.kind for e in want.events]


# ---------------------------------------------------------------------------
# tests/test_anneal_service.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_mixed_batch_matches_jax_and_unpadded_runs(backend):
    svc = _svc(backend)
    responses = svc.solve(_requests("mixed"))
    for i, (p, resp, want) in enumerate(zip(_mixed(gset), responses,
                                            _jax_solve("mixed", backend))):
        _assert_same(resp, want)
        ref = anneal(p, SSAHyperParams(**HP), seed=10 + i, track_energy=False,
                     config=SolverConfig(noise="xorshift"), device="cpu")
        np.testing.assert_array_equal(ref.best_energy, resp.result.best_energy)
        np.testing.assert_array_equal(ref.best_m, resp.result.best_m)
        assert resp.result.best_m.shape == (HP["n_trials"], p.n)
        assert resp.bucket == engine.bucket_n(p.n, 16)
    assert svc.stats["traces_chunk"] == 2 and len(svc._programs) == 2


@pytest.mark.parametrize("seed", [11, 4242])
def test_padding_invariance(seed):
    p = gset.king_graph(36, seed=seed % 7)
    model = p.to_ising()
    nb = engine.bucket_n(model.n, 16)
    assert nb > model.n
    ref = anneal(p, SSAHyperParams(**HP), seed=seed, track_energy=False,
                 config=SolverConfig(noise="xorshift"), device="cpu")
    for backend, _ in BACKENDS:
        resp = _svc(backend).solve([AnnealRequest(problem=p, hp=SSAHyperParams(**HP),
                                                  seed=seed)])[0]
        np.testing.assert_array_equal(ref.best_cut, resp.result.best_cut)
        np.testing.assert_array_equal(ref.best_m, resp.result.best_m)


def test_same_bucket_batch_builds_program_once():
    mk = lambda g, Req, hp: [Req(problem=g.toroidal_grid(36, seed=s, name=f"g{s}"),  # noqa: E731
                                 hp=hp, seed=s) for s in range(4)]
    svc = _svc("sparse")
    got = svc.solve(mk(gset, AnnealRequest, SSAHyperParams(**HP)))
    jsvc = _jsvc("sparse")
    want = jsvc.solve(mk(jgset, JRequest, JHP(**HP)))
    for a, b in zip(got, want):
        _assert_same(a, b)
    for key in ("traces_chunk", "traces_init", "program_cache_misses", "groups", "chunks_run"):
        assert svc.stats[key] == jsvc.stats[key], key
    assert svc.stats["traces_chunk"] == svc.stats["program_cache_misses"] == 1
    (bk, _, _), = svc._programs.values()
    assert isinstance(bk, engine.BatchedSparseBackend)


def test_program_reused_across_solve_calls():
    svc = _svc("cuda")
    for s in range(3):
        svc.solve([AnnealRequest(problem=gset.toroidal_grid(36, seed=s),
                                 hp=SSAHyperParams(**HP), seed=s)])
    assert svc.stats["traces_chunk"] == 1 and svc.stats["program_cache_hits"] == 2


def test_chunk_reports_and_early_stop_match_jax():
    hp = dict(HP, m_shot=10)
    svc, jsvc = _svc("sparse"), _jsvc("sparse")
    events, jevents = [], []
    resp = svc.solve([AnnealRequest(problem=gset.toroidal_grid(36, seed=1),
                                    hp=SSAHyperParams(**hp), seed=0, target_cut=1)],
                     progress=events.append)[0]
    want = jsvc.solve([JRequest(problem=jgset.toroidal_grid(36, seed=1), hp=JHP(**hp),
                                seed=0, target_cut=1)], progress=jevents.append)[0]
    _assert_same(resp, want)
    assert resp.chunks_run < resp.chunks_total
    assert [(e.chunk, e.best_cut) for e in events] == [(e.chunk, e.best_cut) for e in jevents]
    trace = resp.chunk_best_cut
    assert all(a <= b for a, b in zip(trace, trace[1:]))
    assert trace[-1] == resp.result.overall_best_cut
    assert svc.stats["early_stops"] == jsvc.stats["early_stops"] == 1


def test_untargeted_requests_run_to_completion():
    resp = _svc("sparse").solve([AnnealRequest(problem=gset.toroidal_grid(36, seed=1),
                                               hp=SSAHyperParams(**HP), seed=0)])[0]
    assert resp.chunks_run == resp.chunks_total == HP["m_shot"]


def test_chunked_equals_unchunked():
    p, hp = gset.toroidal_grid(36, seed=5), SSAHyperParams(**dict(HP, m_shot=6))
    r1 = _svc("cuda", chunk_shots=1).solve([AnnealRequest(problem=p, hp=hp, seed=3)])[0]
    r3 = _svc("cuda", chunk_shots=3).solve([AnnealRequest(problem=p, hp=hp, seed=3)])[0]
    np.testing.assert_array_equal(r1.result.best_energy, r3.result.best_energy)
    np.testing.assert_array_equal(r1.result.best_m, r3.result.best_m)
    assert r1.chunks_run == 6 and r3.chunks_run == 2
    np.testing.assert_array_equal(r1.chunk_best_cut[2::3], r3.chunk_best_cut)


def test_empty_batch_returns_empty():
    svc = _svc("sparse")
    assert svc.solve([]) == []
    assert svc.stats["requests"] == 0 and len(svc._programs) == 0


def test_duplicate_and_aliased_requests():
    p, hp = gset.toroidal_grid(36, seed=1), SSAHyperParams(**HP)
    req = AnnealRequest(problem=p, hp=hp, seed=7)
    solo = _svc("sparse").solve([req])[0]
    rs = _svc("sparse").solve([req, req, AnnealRequest(problem=p, hp=hp, seed=8), req])
    assert len(rs) == 4
    for r in (rs[0], rs[1], rs[3]):
        np.testing.assert_array_equal(r.result.best_energy, solo.result.best_energy)
        np.testing.assert_array_equal(r.result.best_m, solo.result.best_m)
    assert all(r.status == "ok" for r in rs)


def test_program_cache_lru_eviction_releases_the_backend():
    """A capacity-1 cache evicts the cold program, counts the eviction,
    drops its backend (and so the backend's device tensors) and rebuilds it,
    bit-identically, when the evicted bucket returns."""
    p_small, p_large = gset.toroidal_grid(36, seed=1), gset.toroidal_grid(100, seed=2)
    hp = SSAHyperParams(**HP)
    base = _svc("cuda", backend_opts={"field_mode": "popcount"}).solve(
        [AnnealRequest(problem=p_small, hp=hp, seed=1)])[0]
    svc = _svc("cuda", backend_opts={"field_mode": "popcount"}, max_cached_executables=1)
    svc.solve([AnnealRequest(problem=p_small, hp=hp, seed=1)])
    bk_small = svc._programs.values()[0][0]
    assert bk_small._schedules  # the chain schedules it holds on the device
    ref = weakref.ref(bk_small)
    del bk_small
    svc.solve([AnnealRequest(problem=p_large, hp=hp, seed=2)])
    gc.collect()
    assert ref() is None
    info = svc.cache_info()
    assert info["capacity"] == 1 and info["programs"] == 1 and info["evictions"] == 1
    before = svc.stats["traces_chunk"]
    r = svc.solve([AnnealRequest(problem=p_small, hp=hp, seed=1)])[0]
    assert svc.stats["traces_chunk"] == before + 1 and svc.cache_info()["evictions"] == 2
    np.testing.assert_array_equal(r.result.best_energy, base.result.best_energy)
    np.testing.assert_array_equal(r.result.best_m, base.result.best_m)
    with pytest.raises(ValueError):
        _svc("sparse", max_cached_executables=0)


def test_concurrent_solves_share_the_cache_safely():
    """Four threads solving same-bucket requests on one service: each
    result equals its sequential run and the cache holds one program."""
    import threading

    reqs = [AnnealRequest(problem=gset.toroidal_grid(36, seed=s), hp=SSAHyperParams(**HP),
                          seed=s) for s in range(4)]
    base = [_svc("cuda").solve([r])[0] for r in reqs]
    svc = _svc("cuda")
    svc.solve([reqs[0]])  # build the program, so the threads race on reusing it
    results, errors = [None] * 4, []
    gate = threading.Barrier(4)

    def worker(i):
        try:
            gate.wait(timeout=30)
            results[i] = svc.solve([reqs[i]])[0]
        except Exception as e:  # pragma: no cover - surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for r, b in zip(results, base):
        assert r is not None and r.status == "ok"
        _assert_bit_identical(r, b)
    info = svc.cache_info()
    assert info["programs"] == 1 and info["evictions"] == 0


# ---------------------------------------------------------------------------
# tests/test_ssqa_service.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_ssqa_service_matches_jax_and_anneal_ssqa(backend):
    responses = _svc(backend).solve(_requests("ssqa"))
    for i, (p, resp, want) in enumerate(zip(_ssqa_problems(gset), responses,
                                            _jax_solve("ssqa", backend))):
        _assert_same(resp, want)
        ref = anneal_ssqa(p, SSQAHyperParams(**SSQA), seed=7 + 2 * i, track_energy=False,
                          config=SolverConfig(), device="cpu")
        np.testing.assert_array_equal(ref.best_energy, resp.result.best_energy)
        np.testing.assert_array_equal(ref.best_m, resp.result.best_m)


def test_mixed_ssa_ssqa_batch_does_not_share_groups():
    p, jp = _ssqa_problems(gset)[0], _ssqa_problems(jgset)[0]
    hp_ssa = dict(n_trials=8, m_shot=3, tau=4, i0_min=1, i0_max=8)
    svc, jsvc = _svc("sparse"), _jsvc("sparse")
    k_ssa = svc._group_key(AnnealRequest(problem=p, hp=SSAHyperParams(**hp_ssa), seed=7), 64)
    k_ssqa = svc._group_key(AnnealRequest(problem=p, hp=SSQAHyperParams(**SSQA), seed=7), 64)
    assert k_ssa[0] == "ssa" and k_ssqa[0] == "ssqa" and k_ssa != k_ssqa
    # The batching keys are the JAX package's.
    assert k_ssa == jsvc._group_key(JRequest(problem=jp, hp=JHP(**hp_ssa), seed=7), 64)
    assert k_ssqa == jsvc._group_key(JRequest(problem=jp, hp=JSSQA(**SSQA), seed=7), 64)
    rs = svc.solve([AnnealRequest(problem=p, hp=SSAHyperParams(**hp_ssa), seed=7),
                    AnnealRequest(problem=p, hp=SSQAHyperParams(**SSQA), seed=7, algo="ssqa")])
    assert all(r.status == "ok" and r.result is not None for r in rs)
    assert svc.stats["groups"] == 2


def test_per_request_config_redirects_backend():
    """A sparse service serves an SSQA group on the cuda popcount surface
    (K2's ring mode, plain) through the request's SolverConfig, bit-identically."""
    svc = _svc("sparse")
    ref = svc.solve(_requests("ssqa"))
    cfg = SolverConfig(backend="cuda", field_mode="popcount", noise_mode="streamed",
                       backend_opts={"j_bits": 2})
    got = svc.solve(_requests("ssqa", config=cfg))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a.result.best_energy, b.result.best_energy)
        np.testing.assert_array_equal(a.result.best_m, b.result.best_m)
    assert any("'cuda'" in k for k in svc.cache_info()["keys"])


def test_per_request_config_noise_and_layout_must_match_service():
    svc = _svc("sparse")
    with pytest.raises(AdmissionError, match="noise"):
        svc.solve(_requests("ssqa", config=SolverConfig(noise="threefry")))
    with pytest.raises(AdmissionError, match="storage_layout"):
        svc.solve(_requests("ssqa", config=SolverConfig(storage_layout="packed")))


def test_registry_families():
    """The JAX package's four families (SA and PT-SSA since their port)."""
    from repro.serve.registry import registered_algos as jax_algos

    assert set(registered_algos()) == {"ssa", "sa", "ptssa", "ssqa"} == set(jax_algos())
    assert family_for(SSQAHyperParams(**SSQA)).name == "ssqa"
    assert family_for(SSAHyperParams(n_trials=4)).name == "ssa"
    assert family_for(SSQAHyperParams(**SSQA), algo="ssqa").name == "ssqa"


def test_registry_rejects_mismatch_and_unknown():
    hp = SSQAHyperParams(**SSQA)
    with pytest.raises(AdmissionError, match="does not match"):
        family_for(hp, algo="ssa")
    with pytest.raises(AdmissionError, match="does not match"):
        family_for(SSAHyperParams(n_trials=4), algo="ssqa")
    with pytest.raises(AdmissionError, match="unknown algo"):
        family_for(hp, algo="quantum")
    with pytest.raises(AdmissionError, match="does not match"):
        _svc("sparse").solve([AnnealRequest(problem=_ssqa_problems(gset)[0], hp=hp,
                                            seed=7, algo="ssa")])


def test_ssqa_cuda_noise_rules_fire_even_with_validation_off():
    p, hp = _ssqa_problems(gset)[0], SSQAHyperParams(**SSQA)
    off = ResiliencePolicy(validate_admission=False)
    with pytest.raises(AdmissionError, match="xorshift"):
        _svc("cuda", noise="threefry", resilience=off).solve(
            [AnnealRequest(problem=p, hp=hp, seed=7)])
    with pytest.raises(AdmissionError, match="streamed"):
        _svc("cuda", backend_opts={"noise_mode": "pregen"}, resilience=off).solve(
            [AnnealRequest(problem=p, hp=hp, seed=7)])


# ---------------------------------------------------------------------------
# tests/test_chaos.py, the tests without checkpoints
# ---------------------------------------------------------------------------
def _port_baseline(backend):
    return _svc(backend).solve(_requests("chaos"))


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_chaos_baselines_match_jax(backend):
    for got, want in zip(_port_baseline(backend), _jax_solve("chaos", backend)):
        _assert_same(got, want)


def _faulted(backend, arm, jax=False, **kw):
    """Solve the chaos requests with the faults ``arm`` arms, on either
    package (the JAX injector names the cuda backend 'pallas')."""
    inj = (jfaults.FaultInjector if jax else FaultInjector)()
    for point, match in arm:
        if jax and match.get("backend") == "cuda":
            match = dict(match, backend="pallas")
        inj.arm(point, **match)
    if jax:
        from repro.serve import ResiliencePolicy as JPolicy

        if "resilience" in kw:
            kw["resilience"] = JPolicy(**dataclasses.asdict(kw["resilience"]))
        return _jsvc(backend, faults=inj, **kw), _requests("chaos", jax=True)
    return _svc(backend, faults=inj, **kw), _requests("chaos")


def _hops(resp):
    return [(e.detail["from"], e.detail["to"]) for e in resp.events if e.kind == "fallback"]


def test_cuda_compile_failure_falls_back():
    svc, reqs = _faulted("cuda", [("compile", dict(backend="cuda"))])
    resp = svc.solve(reqs)
    jsvc, jreqs = _faulted("cuda", [("compile", dict(backend="cuda"))], jax=True)
    jresp = jsvc.solve(jreqs)
    for base, r, w in zip(_port_baseline("cuda"), resp, jresp):
        assert r.status == "fallback"
        _assert_same(r, w)
        np.testing.assert_array_equal(r.result.best_m, base.result.best_m)
    assert _hops(resp[0]) == [("cuda", "dense")]
    assert svc.stats["fallback_compile"] == jsvc.stats["fallback_compile"] == 1


def test_full_chain_cuda_dense_sparse():
    arm = [("compile", dict(backend="cuda")), ("compile", dict(backend="dense"))]
    svc, reqs = _faulted("cuda", arm)
    resp = svc.solve(reqs)
    jresp = _faulted("cuda", arm, jax=True)[0].solve(_requests("chaos", jax=True))
    assert _hops(resp[0]) == [("cuda", "dense"), ("dense", "sparse")]
    for base, r, w in zip(_port_baseline("cuda"), resp, jresp):
        assert r.status == "fallback"
        _assert_same(r, w)
        np.testing.assert_array_equal(r.result.best_m, base.result.best_m)


def test_terminal_backend_failure_propagates():
    svc, reqs = _faulted("sparse", [("compile", dict(backend="sparse"))])
    with pytest.raises(InjectedCompileFailure):
        svc.solve(reqs)


def test_fallback_disabled_propagates():
    svc, reqs = _faulted("cuda", [("compile", dict(backend="cuda"))],
                         resilience=ResiliencePolicy(fallback=False))
    with pytest.raises(InjectedCompileFailure):
        svc.solve(reqs)


@pytest.mark.parametrize("exc", [KernelBuildError("nvcc failed"),
                                 KernelLaunchError("launch failed"),
                                 torch.cuda.OutOfMemoryError("CUDA out of memory")],
                         ids=["build", "launch", "oom"])
def test_real_cuda_kernel_fault_propagates(monkeypatch, exc):
    """Only injected faults walk the chain from the cuda backend: a kernel
    that does not build, launch or fit raises, and no plain backend serves
    the group in its place."""
    def fail(*_a, **_k):
        raise exc

    monkeypatch.setattr(engine.BatchedCudaBackend, "run_shots", fail)
    svc = _svc("cuda")
    with pytest.raises(type(exc)):
        svc.solve(_requests("chaos"))
    assert svc.stats["fallback_compile"] == svc.stats["fallback_oom"] == 0


def test_dense_oom_downgrades_to_tiled():
    arm = [("oom", dict(backend="dense", j_mode="dense"))]
    svc, reqs = _faulted("dense", arm)
    resp = svc.solve(reqs)
    jresp = _faulted("dense", arm, jax=True)[0].solve(_requests("chaos", jax=True))
    ev = [e for e in resp[0].events if e.kind == "fallback"]
    assert ev[0].detail["fault"] == "oom" and ev[0].detail["to"] == "dense"
    assert ev[0].detail["to_opts"]["j_mode"] == "tiled"
    for base, r, w in zip(_port_baseline("dense"), resp, jresp):
        assert r.status == "fallback"
        _assert_same(r, w)
        np.testing.assert_array_equal(r.result.best_m, base.result.best_m)
    tiled = [bk for bk, _, _ in svc._programs.values() if bk.j_mode == "tiled"]
    assert len(tiled) == 1 and isinstance(tiled[0], engine.BatchedDenseBackend)


def test_fallback_drops_incompatible_backend_opts():
    """cuda-only options (noise_mode) do not leak into the dense fallback."""
    svc, reqs = _faulted("cuda", [("compile", dict(backend="cuda"))],
                         backend_opts={"noise_mode": "streamed"})
    resp = svc.solve(reqs)
    assert all(r.status == "fallback" for r in resp)
    ev = [e for e in resp[0].events if e.kind == "fallback"][0]
    assert ev.detail["from_opts"] == {"noise_mode": "streamed"}
    assert "noise_mode" not in ev.detail["to_opts"]


def test_nan_burst_quarantines_without_poisoning_batchmates():
    arm = [("nan", dict(chunk=1, slots=(1,)))]
    svc, reqs = _faulted("sparse", arm)
    resp = svc.solve(reqs)
    jresp = _faulted("sparse", arm, jax=True)[0].solve(_requests("chaos", jax=True))
    assert resp[0].status == "ok"
    _assert_bit_identical(resp[0], _port_baseline("sparse")[0])
    assert resp[1].status == "quarantined" and resp[1].result is not None
    assert [e.kind for e in resp[1].events][:2] == ["quarantine", "retry"]
    retry = [e for e in resp[1].events if e.kind == "retry"][0]
    assert retry.detail["i0_max"] == [e for e in jresp[1].events
                                      if e.kind == "retry"][0].detail["i0_max"]
    for r, w in zip(resp, jresp):  # the re-autotuned retry is the JAX package's too
        _assert_same(r, w)
    assert svc.stats["nonfinite_detected"] == 1 and svc.stats["quarantine_recoveries"] == 1


def test_quarantine_retries_exhausted_returns_failed():
    inj = FaultInjector()
    inj.arm("nan", count=100)
    svc = _svc("sparse", faults=inj,
               resilience=ResiliencePolicy(max_retries=2, backoff_base_s=0.0))
    resp = svc.solve([_requests("chaos")[0]])
    assert resp[0].status == "failed" and resp[0].result is None
    assert [e.kind for e in resp[0].events].count("retry") == 2
    assert svc.stats["quarantine_failures"] == 1


def test_deadline_returns_best_so_far():
    resp = _svc("cuda").solve(_requests("chaos", deadline_s=1e-9))
    jresp = _jsvc("cuda").solve(_requests("chaos", jax=True, deadline_s=1e-9))
    for base, r, w in zip(_port_baseline("cuda"), resp, jresp):
        assert r.status == "deadline" and r.result is not None
        assert r.chunks_run < r.chunks_total
        _assert_same(r, w)
        np.testing.assert_array_equal(r.chunk_best_cut, base.chunk_best_cut[:len(r.chunk_best_cut)])


def test_deadline_only_affects_expired_requests():
    reqs = _requests("chaos")
    reqs[1] = dataclasses.replace(reqs[1], deadline_s=1e-9)
    resp = _svc("sparse").solve(reqs)
    assert resp[0].status == "ok" and resp[0].chunks_run == resp[0].chunks_total
    _assert_bit_identical(resp[0], _port_baseline("sparse")[0])
    assert resp[1].status == "deadline"
    assert len(resp[1].chunk_best_cut) < resp[1].chunks_total


def test_admission_rejects_bad_requests():
    svc = _svc("sparse")
    good = _requests("chaos")[0]
    nan_model = IsingModel(n=3, h=np.zeros(3, np.int32), nbr_idx=np.zeros((3, 1), np.int32),
                           nbr_w=np.full((3, 1), np.nan))
    with pytest.raises(AdmissionError, match="finite"):
        svc.solve([good, AnnealRequest(problem=nan_model, hp=good.hp)])
    empty = IsingModel(n=0, h=np.zeros(0, np.int32), nbr_idx=np.zeros((0, 1), np.int32),
                       nbr_w=np.zeros((0, 1), np.int32))
    with pytest.raises(AdmissionError, match="n"):
        svc.solve([AnnealRequest(problem=empty, hp=good.hp)])
    with pytest.raises(AdmissionError, match="deadline"):
        svc.solve([dataclasses.replace(good, deadline_s=-1.0)])
    with pytest.raises(AdmissionError, match="cannot interpret"):
        svc.solve([AnnealRequest(problem="G11", hp=good.hp)])
    huge = gset.toroidal_grid(engine.MAX_UNSHARDED_SPINS + 100, seed=0).to_ising()
    with pytest.raises(AdmissionError, match="step 8"):
        svc.solve([AnnealRequest(problem=huge, hp=good.hp)])
    assert len(svc._programs) == 0 and svc.stats["admission_rejects"] == 4


def test_chaos_schedule_deterministic_and_as_jax():
    a, b = chaos_schedule(17), chaos_schedule(17)
    assert [(s.point, s.match, s.slots) for s in a.specs] == \
           [(s.point, s.match, s.slots) for s in b.specs]
    assert [(s.point, s.match) for s in chaos_schedule(18).specs] != \
           [(s.point, s.match) for s in a.specs]
    for seed in range(6):
        name = {"pallas": "cuda"}
        want = [(s.point, {k: name.get(v, v) for k, v in s.match.items()}, s.slots)
                for s in jfaults.chaos_schedule(seed).specs]
        assert [(s.point, s.match, s.slots) for s in chaos_schedule(seed).specs] == want


@pytest.mark.parametrize("seed", range(4))
def test_chaos_schedule_survival(seed):
    """Seeded fault mixes on the cuda backend: every request is served (a
    kill escapes, and a fresh service then solves the batch), and every
    result not quarantined equals the fault-free run."""
    try:
        resp = _svc("cuda", faults=chaos_schedule(seed)).solve(_requests("chaos"))
    except InjectedKill:
        resp = _svc("cuda").solve(_requests("chaos"))
    assert len(resp) == 2
    for base, r in zip(_port_baseline("cuda"), resp):
        if r.status == "quarantined":
            assert r.result is not None
        else:
            np.testing.assert_array_equal(r.result.best_m, base.result.best_m)
            np.testing.assert_array_equal(r.chunk_best_cut, base.chunk_best_cut)


# ---------------------------------------------------------------------------
# Fault taxonomy and the fallback chain
# ---------------------------------------------------------------------------
def test_classify_fault():
    assert classify_fault(torch.cuda.OutOfMemoryError("CUDA out of memory"), "dense") == "oom"
    assert classify_fault(MemoryError(), "sparse") == "oom"
    assert classify_fault(InjectedOOM("injected"), "cuda") == "oom"
    assert classify_fault(InjectedCompileFailure("injected"), "cuda") == "compile"
    # A real fault of the kernels' backend raises: no plain backend serves
    # in place of a kernel that does not build, launch or fit.
    assert classify_fault(KernelBuildError("nvcc failed"), "cuda") is None
    assert classify_fault(KernelLaunchError("launch failed"), "cuda") is None
    assert classify_fault(torch.cuda.OutOfMemoryError("CUDA out of memory"), "cuda") is None
    assert classify_fault(RuntimeError("CUDA error: out of memory"), "cuda") is None
    assert classify_fault(KernelLaunchError("launch failed"), "dense") is None
    assert classify_fault(RuntimeError("a bug"), "cuda") is None
    assert classify_fault(InjectedKill("kill"), "cuda") is None
    assert classify_fault(AdmissionError("bad"), "cuda") is None


def test_fallback_step_chain():
    assert fallback_step("cuda", {"noise_mode": "streamed", "field_mode": "popcount",
                                  "j_bits": 1}, "compile", 64) == (
        "dense", {"field_mode": "popcount", "j_bits": 1})
    assert fallback_step("dense", {"tile_n": 32}, "oom", 64) == (
        "dense", {"tile_n": 32, "j_mode": "tiled"})
    assert fallback_step("dense", {}, "oom", 8192) == ("sparse", {})
    assert fallback_step("dense", {"n_replicas": 4}, "compile", 64) == (
        "sparse", {"n_replicas": 4})
    assert fallback_step("sparse", {}, "compile", 64) is None


# ---------------------------------------------------------------------------
# Inputs that are not ported, and inputs of the families that now are
# ---------------------------------------------------------------------------
class _NoModel:
    """Neither a problem nor an encoding: nothing to anneal."""

    model = None


# The SA and PT-SSA families and problem encodings are served since their
# port (tests/test_torch_sa_pt.py, tests/test_torch_problems.py); what still
# raises for them is what the JAX package rejects: an ``algo`` that
# contradicts the hp type, and an input without an Ising model.
@pytest.mark.parametrize("make,err,match", [
    (lambda: _svc("sparse").solve([AnnealRequest(
        problem=gset.toroidal_grid(16, seed=0), hp=SSAHyperParams(n_trials=2), algo="sa")]),
     AdmissionError, "algo='sa' does not match"),
    (lambda: family_for(SSAHyperParams(), algo="ptssa"), AdmissionError,
     "algo='ptssa' does not match"),
    (lambda: _svc("sparse").solve([AnnealRequest(problem=_NoModel(), hp=SSAHyperParams())]),
     AdmissionError, "cannot interpret"),
    (lambda: _svc("sparse", partition="spin"), NotImplementedError, "ROADMAP.md queue 1 step 8"),
    (lambda: _svc("sparse", partition="auto"), NotImplementedError, "ROADMAP.md queue 1 step 8"),
    (lambda: _svc("auto"), NotImplementedError, "ROADMAP.md queue 1 step 3"),
], ids=["algo-sa", "algo-ptssa", "problem-encoding", "partition-spin", "partition-auto",
        "backend-auto"])
def test_not_ported_inputs_raise(make, err, match):
    with pytest.raises(err, match=match):
        make()


@pytest.mark.parametrize("flag,item", [(["--problem-kind", "qubo"], "qubo")])
def test_launcher_not_ported_flags_raise(flag, item, capsys):
    """--problem-kind runs since the problem frontend's port: it prints one
    line per demo instance with its decoded objective, and the same lines
    as the JAX launcher (wall times aside)."""
    from repro.launch import anneal as jlaunch
    from repro_torch.launch import anneal as launch

    args = [*flag, "--count", "2", "--trials", "4", "--m-shot", "2", "--tau", "10"]
    launch.main(["--device", "cpu", *args])
    got = capsys.readouterr().out.splitlines()
    sys_argv = sys.argv
    sys.argv = ["anneal", *args]
    try:
        jlaunch.main()
    finally:
        sys.argv = sys_argv
    want = capsys.readouterr().out.splitlines()
    assert len(got) == 3 and got[:2] == want[-3:-1]
    assert all("objective=" in line and "feasible=True" in line for line in got[:2])
    assert got[2].startswith(f"2 × {item} in ")


def test_launcher_service_mode(capsys):
    """A comma list goes through the service: per-chunk progress lines, one
    line per problem, and the batch summary — the JAX launcher's lines."""
    from repro_torch.launch import anneal as launch

    launch.main(["--problem", "G11,King1", "--trials", "2", "--m-shot", "2", "--tau", "2",
                 "--i0-max", "4", "--backend", "cuda", "--device", "cpu", "--chunk-shots", "1",
                 "--target-cut", "100000"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[chunk 1/2 bucket=1024] best cut: G11-like=")
    assert out[2].startswith("G11-like: best cut ") and "[bucket=1024 batch=2 chunks=2/2]" in out[2]
    assert out[3].startswith("King1: best cut ")
    assert out[-1].startswith("batch of 2 in ") and "1 compiled program(s)" in out[-1]
