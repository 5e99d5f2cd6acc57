"""The port's ``StreamingAnnealService`` against the JAX package's, on the
CPU.

Mirrors ``tests/test_stream_service.py``.  The load-bearing property is
live-lane bit-identity: a request served through a slot table — seated
mid-stream into a slot another request just left — returns the
``best_cut``, spins and chunk trace of the port's one-shot
``AnnealService.solve`` of it, and of the JAX package's stream for the same
submissions, on the sparse, dense and cuda (the kernels' plain versions;
the JAX package's pallas in interpret mode) backends.  Around it: priority
order, shed, the seated deadline, queue backpressure, target-cut
retirement, per-slot kill/resume (interchangeable with one-shot solo
checkpoints), the counters and the background thread.  Beyond the
reference: a cuda → dense downgrade in the middle of the stream carries
the engine state bit-exactly (every batched backend keeps one state
layout), a real kernel fault raises out of ``pump()``, and the launcher's
``--stream`` and ``--checkpoint-dir`` modes run.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.serve import AnnealRequest as JRequest  # noqa: E402
from repro.serve import StreamingAnnealService as JStream  # noqa: E402
from repro.serve import StreamPolicy as JPolicy  # noqa: E402
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams  # noqa: E402
from repro_torch.core.ssqa import SSQAHyperParams  # noqa: E402
from repro_torch.ft.faults import FaultInjector, InjectedCompileFailure, InjectedKill  # noqa: E402
from repro_torch.kernels._build import KernelBuildError  # noqa: E402
from repro_torch.kernels.ssa_update import KernelLaunchError  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    AnnealRequest,
    AnnealService,
    QueueFullError,
    ResiliencePolicy,
    StreamingAnnealService,
    StreamPolicy,
    registry,
)

HP = dict(n_trials=3, m_shot=4, tau=4, i0_min=1, i0_max=8)
# (port backend, JAX backend)
BACKENDS = [("sparse", "sparse"), ("dense", "dense"), ("cuda", "pallas")]
JAX_NAME = dict(BACKENDS)
PORT = [b for b, _ in BACKENDS]


def _requests(k=6, jax=False, **kw):
    g, Req, Hp = (jgset, JRequest, JHP) if jax else (gset, AnnealRequest, SSAHyperParams)
    return [Req(problem=g.toroidal_grid(36, seed=s, name=f"t{s}"), hp=Hp(**HP), seed=s, **kw)
            for s in range(k)]


def _svc(backend, **kw):
    return AnnealService(backend=backend, min_bucket=16, device="cpu", **kw)


def _stream(backend, slots=2, service=None, **pol):
    return StreamingAnnealService(service=service or _svc(backend),
                                  policy=StreamPolicy(slots_per_table=slots, **pol))


@functools.lru_cache(maxsize=None)
def _baselines(backend):
    """One-shot solo solves: the bit-identity reference."""
    svc = _svc(backend)
    return tuple(svc.solve([r])[0] for r in _requests())


@functools.lru_cache(maxsize=None)
def _jax_stream(backend, slots=2):
    ss = JStream(backend=JAX_NAME[backend], min_bucket=16,
                 policy=JPolicy(slots_per_table=slots))
    tickets = [ss.submit(r) for r in _requests(jax=True)]
    ss.run_until_idle()
    return [t.result(timeout=0) for t in tickets], ss.stream_stats()


def _assert_lane_identical(resp, base):
    np.testing.assert_array_equal(resp.result.best_cut, np.asarray(base.result.best_cut))
    np.testing.assert_array_equal(resp.result.best_m, np.asarray(base.result.best_m))
    np.testing.assert_array_equal(resp.result.best_energy, np.asarray(base.result.best_energy))
    np.testing.assert_array_equal(resp.chunk_best_cut, np.asarray(base.chunk_best_cut))


def _assert_as_jax(resp, want):
    _assert_lane_identical(resp, want)
    assert (resp.status, resp.chunks_run, resp.chunks_total, resp.bucket, resp.batch) == (
        want.status, want.chunks_run, want.chunks_total, want.bucket, want.batch)
    assert [e.kind for e in resp.events] == [e.kind for e in want.events]


class _Pkg:
    """One package's stream API — the port (on the CPU) or the JAX package —
    so a scenario runs the same submissions through both."""

    def __init__(self, jax):
        self.jax = jax
        if jax:
            from repro.ft.faults import FaultInjector as Inj
            from repro.ft.faults import InjectedKill as Kill
            from repro.serve import AnnealService as Svc
            from repro.serve import ResiliencePolicy as Res
            from repro.serve import QueueFullError as Full

            self.Stream, self.Policy, self.Req, self.Hp, self.g = (
                JStream, JPolicy, JRequest, JHP, jgset)
        else:
            Inj, Kill, Svc, Res, Full = (FaultInjector, InjectedKill, AnnealService,
                                         ResiliencePolicy, QueueFullError)
            self.Stream, self.Policy, self.Req, self.Hp, self.g = (
                StreamingAnnealService, StreamPolicy, AnnealRequest, SSAHyperParams, gset)
        self.Injector, self.Kill, self.Svc, self.Res, self.Full = Inj, Kill, Svc, Res, Full

    def svc(self, backend, **kw):
        if self.jax:
            return self.Svc(backend=JAX_NAME[backend], min_bucket=16, **kw)
        return self.Svc(backend=backend, min_bucket=16, device="cpu", **kw)

    def stream(self, backend, slots=2, service=None, **pol):
        return self.Stream(service=service or self.svc(backend),
                           policy=self.Policy(slots_per_table=slots, **pol))

    def requests(self, k=6, **kw):
        return [self.Req(problem=self.g.toroidal_grid(36, seed=s, name=f"t{s}"),
                         hp=self.Hp(**HP), seed=s, **kw) for s in range(k)]

    def request(self, seed, **kw):
        return self.Req(problem=self.g.toroidal_grid(36, seed=seed), hp=self.Hp(**HP),
                        seed=seed, **kw)


PKGS = (_Pkg(False), _Pkg(True))


def _stream_counters(ss):
    return {k: v for k, v in ss.stream_stats().items() if k.startswith("stream_")}


# ---------------------------------------------------------------------------
# Live-lane bit-identity across slot backfill (the acceptance property)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", PORT)
def test_stream_bit_identical_across_backfill(backend):
    """6 requests through a 2-slot table = 3 backfill generations; every
    lane equals its one-shot solo solve and the JAX stream's lane."""
    ss = _stream(backend)
    tickets = [ss.submit(r) for r in _requests()]
    ss.run_until_idle()
    jresp, jstats = _jax_stream(backend)
    for t, base, want in zip(tickets, _baselines(backend), jresp):
        resp = t.result(timeout=0)
        assert resp.status == "ok"
        _assert_lane_identical(resp, base)
        _assert_as_jax(resp, want)
    st = ss.stream_stats()
    assert st["stream_backfills"] == 6          # every seat is a splice
    assert st["stream_tables_created"] == 1     # one bucket, one table
    assert st["stream_completed"] == 6
    assert 0.0 < st["occupancy"] <= 1.0
    assert {k: v for k, v in st.items() if k.startswith("stream_")} == \
           {k: v for k, v in jstats.items() if k.startswith("stream_")}


@pytest.mark.parametrize("backend", PORT)
def test_stream_ssqa_bit_identical(backend):
    """SSQA requests key their own table (the ring depth in the options)
    and equal their one-shot solo solves; on cuda the plain ring modes."""
    hp = SSQAHyperParams(n_trials=8, n_replicas=4, m_shot=3, tau=4, i0_min=1, i0_max=8)
    reqs = [AnnealRequest(problem=gset.toroidal_grid(50, seed=17 + s), hp=hp, seed=7 + s,
                          algo="ssqa") for s in range(3)]
    svc = _svc(backend)
    base = [svc.solve([r])[0] for r in reqs]
    ss = _stream(backend)
    tickets = [ss.submit(r) for r in reqs]
    ss.run_until_idle()
    for t, b in zip(tickets, base):
        _assert_lane_identical(t.result(timeout=0), b)
    assert ss.stats["stream_tables_created"] == 1


def test_target_cut_retires_early_and_backfills():
    """A target-stopped lane frees its slot at the chunk boundary and the
    next queued request takes it; both report what the one-shot path and
    the JAX stream report (chunks_run, trace prefix, result)."""
    def reqs(jax):
        g, Req, Hp = (jgset, JRequest, JHP) if jax else (gset, AnnealRequest, SSAHyperParams)
        return [Req(problem=g.toroidal_grid(36, seed=0), hp=Hp(**dict(HP, m_shot=10)), seed=0,
                    target_cut=1)] + _requests(2, jax=jax)

    solo = _svc("sparse")
    base = [solo.solve([r])[0] for r in reqs(False)]
    assert base[0].chunks_run < base[0].chunks_total  # the target fired
    ss = _stream("sparse", slots=1)
    tickets = [ss.submit(r) for r in reqs(False)]
    ss.run_until_idle()
    js = JStream(backend="sparse", min_bucket=16, policy=JPolicy(slots_per_table=1))
    jt = [js.submit(r) for r in reqs(True)]
    js.run_until_idle()
    for t, b, w in zip(tickets, base, jt):
        resp = t.result(timeout=0)
        assert resp.chunks_run == b.chunks_run
        _assert_lane_identical(resp, b)
        _assert_as_jax(resp, w.result(timeout=0))
    st = ss.stream_stats()
    assert st["stream_retired_target"] == 1
    assert st["stream_retired_budget"] == 2


# ---------------------------------------------------------------------------
# Scheduling
# ---------------------------------------------------------------------------
def test_interactive_preempts_batch_in_queue():
    """With a 1-wide table, the interactive request submitted last is
    seated first: the priority class outranks FIFO order.  The seat order
    and every response are the JAX stream's."""
    out = []
    for pkg in PKGS:
        reqs = pkg.requests(4)
        ss = pkg.stream("sparse", slots=1, max_tables=1)
        tickets = [ss.submit(r) for r in reqs[:3]]
        tickets.append(ss.submit(reqs[3], priority="interactive"))
        ss.run_until_idle()
        batch, inter = tickets[:3], tickets[3]
        assert inter.t_seated < min(t.t_seated for t in batch)
        assert all(t.result(timeout=0).status == "ok" for t in tickets)
        assert inter.result(timeout=0).queued_s is not None
        out.append(([t.seq for t in sorted(tickets, key=lambda t: t.t_seated)],
                    [t.result(timeout=0) for t in tickets]))
    (order, resp), (jorder, jresp) = out
    assert order == jorder == [3, 0, 1, 2]
    for a, b, base in zip(resp, jresp, _baselines("sparse")):
        _assert_as_jax(a, b)
        _assert_lane_identical(a, base)
    with pytest.raises(ValueError, match="priority"):
        _stream("sparse").submit(_requests(1)[0], priority="urgent")


def test_aging_and_deadline_order():
    """A batch request older than aging_s ranks as interactive; within a
    class, earlier deadlines first, then FIFO."""
    ss = _stream("sparse", slots=1, aging_s=0.0)
    a = ss.submit(_requests(1)[0])
    b = ss.submit(_requests(2)[1], priority="interactive")
    c = ss.submit(dataclasses.replace(_requests(3)[2], deadline_s=1e6))
    now = a.submit_t + 1.0
    order = sorted([a, b, c], key=lambda t: ss._rank(t, now))
    assert order == [c, a, b]  # aged batch = interactive rank; c's deadline first


def test_expired_queued_request_is_shed():
    """A queued request whose deadline already passed is dropped before any
    device work: status='shed', no result, counted — as in the JAX stream."""
    out = []
    for pkg in PKGS:
        ss = pkg.stream("sparse", slots=1)
        ok_t = ss.submit(pkg.request(0))
        doomed = ss.submit(pkg.request(9, deadline_s=1e-6))
        ss.run_until_idle()
        out.append((ok_t.result(timeout=0), doomed.result(timeout=0), _stream_counters(ss)))
    (ok, resp, st), (jok, jresp, jst) = out
    assert resp.status == jresp.status == "shed" and resp.result is None
    assert resp.chunks_run == 0
    assert [e.kind for e in resp.events] == [e.kind for e in jresp.events] == ["shed"]
    _assert_as_jax(ok, jok)
    _assert_lane_identical(ok, _baselines("sparse")[0])
    assert st == jst and st["stream_shed"] == 1


def test_seated_deadline_freezes_at_chunk_boundary():
    """With shedding off, an expired deadline still seats and is frozen at
    its first chunk boundary: best-so-far, status='deadline', the one-shot
    run's first chunk and the JAX stream's response (its pallas backend)."""
    out = []
    for pkg in PKGS:
        ss = pkg.stream("cuda", slots=1, shed_expired=False)
        t = ss.submit(pkg.request(0, deadline_s=1e-6))
        ss.run_until_idle()
        out.append((t.result(timeout=0), ss.stats["deadline_expirations"]))
    (resp, n), (jresp, jn) = out
    assert resp.status == "deadline"
    assert resp.chunks_run == 1 < resp.chunks_total
    assert resp.result is not None  # best-so-far, not dropped
    _assert_as_jax(resp, jresp)
    np.testing.assert_array_equal(resp.chunk_best_cut, _baselines("cuda")[0].chunk_best_cut[:1])
    assert n == jn == 1


@pytest.mark.parametrize("bound", ["depth", "cost"])
def test_queue_full_backpressure(bound):
    cost = float(SSAHyperParams(**HP).total_cycles) * HP["n_trials"] * 36  # spin-cycles
    pol = dict(max_queue=1) if bound == "depth" else dict(max_queue_cost=1.5 * cost)
    counters = []
    for pkg in PKGS:
        ss = pkg.stream("sparse", slots=1, **pol)
        first = ss.submit(pkg.request(0))
        assert first.cost == cost
        with pytest.raises(pkg.Full):
            ss.submit(pkg.request(5))
        counters.append(_stream_counters(ss))
    assert counters[0] == counters[1] and counters[0]["stream_rejected_queue_full"] == 1
    assert issubclass(QueueFullError, AdmissionError)


def test_stream_policy_validation():
    with pytest.raises(ValueError, match="power of two"):
        StreamPolicy(slots_per_table=3)
    with pytest.raises(ValueError, match=">= 1"):
        StreamPolicy(max_tables=0)
    with pytest.raises(ValueError, match="either"):
        StreamingAnnealService(service=_svc("sparse"), backend="sparse")


def test_mixed_buckets_open_tables_and_drop_idle_ones():
    """Two buckets open two tables.  With max_tables=1 the second bucket's
    request waits: idle tables are dropped only after seating, so the
    first run_until_idle() returns with it still queued, and a second one
    serves it.  Both packages give the same responses, events and
    counters, and each response equals its one-shot solve."""
    base = [_svc("cuda").solve([r])[0] for r in (
        AnnealRequest(problem=gset.toroidal_grid(36, seed=1), hp=SSAHyperParams(**HP), seed=1),
        AnnealRequest(problem=gset.toroidal_grid(100, seed=2), hp=SSAHyperParams(**HP),
                      seed=2))]
    for max_tables, created, queued in ((4, 2, 0), (1, 2, 1)):
        out = []
        for pkg in PKGS:
            reqs = [pkg.Req(problem=pkg.g.toroidal_grid(n, seed=s), hp=pkg.Hp(**HP), seed=s)
                    for n, s in ((36, 1), (100, 2))]
            ss = pkg.stream("cuda", max_tables=max_tables)
            tickets = [ss.submit(r) for r in reqs]
            ss.run_until_idle()
            first = ss.stream_stats()
            assert first["queued"] == queued and first["tables"] <= max_tables
            ss.run_until_idle()
            out.append(([t.result(timeout=0) for t in tickets], first, ss.stream_stats()))
        (got, first, st), (want, jfirst, jst) = out
        for r, w, b in zip(got, want, base):
            _assert_as_jax(r, w)
            _assert_lane_identical(r, b)
        assert first == jfirst and st == jst
        assert st["stream_tables_created"] == created and st["queued"] == 0


# ---------------------------------------------------------------------------
# Per-slot checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", PORT)
def test_stream_kill_resumes_per_slot_bit_identical(backend, tmp_path):
    """Kill the stream after its second quantum; a fresh stream resumes
    each surviving lane from its own checkpoint, bit-identically — the
    responses, events and counters of the JAX stream killed the same way."""
    out = []
    for pkg in PKGS:
        d = tmp_path / ("jax" if pkg.jax else "port")
        pol = pkg.Res(checkpoint_dir=str(d))
        inj = pkg.Injector()
        inj.arm("kill", chunk=1)
        ss = pkg.stream(backend, service=pkg.svc(backend, resilience=pol, faults=inj))
        reqs = pkg.requests(2)
        for r in reqs:
            ss.submit(r)
        with pytest.raises(pkg.Kill):
            ss.run_until_idle()
        assert len(os.listdir(d)) == 2  # one directory per lane survived
        ss2 = pkg.stream(backend, service=pkg.svc(backend, resilience=pol))
        tickets = [ss2.submit(r) for r in reqs]
        ss2.run_until_idle()
        out.append(([t.result(timeout=0) for t in tickets], _stream_counters(ss2)))
        assert os.listdir(d) == []  # purged on success
    (resp, st), (jresp, jst) = out
    for r, w, base in zip(resp, jresp, _baselines(backend)[:2]):
        _assert_lane_identical(r, base)
        _assert_as_jax(r, w)
        resumes = [e for e in r.events if e.kind == "resume"]
        assert resumes and resumes[0].detail["chunk"] == 2  # killed after 2
    assert st == jst and st["stream_resumes"] == 2


@pytest.mark.parametrize("backend", PORT)
def test_oneshot_checkpoint_resumes_into_stream(backend, tmp_path):
    """Slot checkpoints share the solo-group fingerprint: an interrupted
    one-shot solve's checkpoint resumes inside a stream slot, and the answer
    still equals the uninterrupted one-shot run and the JAX stream's."""
    out = []
    for pkg in PKGS:
        d = tmp_path / ("jax" if pkg.jax else "port")
        pol = pkg.Res(checkpoint_dir=str(d))
        inj = pkg.Injector()
        inj.arm("kill", chunk=1)
        req = pkg.requests(1)[0]
        with pytest.raises(pkg.Kill):
            pkg.svc(backend, resilience=pol, faults=inj).solve([req])
        ss = pkg.stream(backend, service=pkg.svc(backend, resilience=pol))
        t = ss.submit(req)
        ss.run_until_idle()
        out.append(t.result(timeout=0))
        assert os.listdir(d) == []
    resp, jresp = out
    assert [(e.kind, e.detail["chunk"]) for e in resp.events if e.kind == "resume"] == [
        ("resume", 2)]
    _assert_lane_identical(resp, _baselines(backend)[0])
    _assert_as_jax(resp, jresp)


def test_checkpoint_at_budget_finishes_without_device_work(tmp_path):
    """A lane whose checkpoint already holds its whole budget finishes at
    its seat: no quantum runs."""
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path), cleanup_on_success=False)
    req = _requests(1)[0]
    _svc("sparse", resilience=pol).solve([req])
    ss = _stream("sparse", service=_svc("sparse", resilience=pol))
    t = ss.submit(req)
    ss.run_until_idle()
    resp = t.result(timeout=0)
    _assert_lane_identical(resp, _baselines("sparse")[0])
    assert ss.stats["stream_quanta"] == 0 and ss.stats["stream_retired_budget"] == 1


def test_corrupted_slot_checkpoint_rejected(tmp_path):
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path))
    inj = FaultInjector()
    inj.arm("kill", chunk=1)
    req = _requests(1)[0]
    ss = _stream("dense", service=_svc("dense", resilience=pol, faults=inj))
    ss.submit(req)
    with pytest.raises(InjectedKill):
        ss.run_until_idle()
    for root, _dirs, files in os.walk(tmp_path):
        for fn in files:
            if fn.endswith(".npz"):
                path = os.path.join(root, fn)
                with np.load(path) as z:
                    flat = {k: (np.zeros_like(z[k]) if "noise_state" in k else z[k])
                            for k in z.files}
                with open(path, "wb") as f:
                    np.savez(f, **flat)
    ss2 = _stream("dense", service=_svc("dense", resilience=pol))
    t = ss2.submit(req)
    ss2.run_until_idle()
    resp = t.result(timeout=0)
    kinds = [e.kind for e in resp.events]
    assert "checkpoint_rejected" in kinds and "resume" not in kinds
    _assert_lane_identical(resp, _baselines("dense")[0])


# ---------------------------------------------------------------------------
# Faults: the fallback chain carries the state; real kernel faults raise
# ---------------------------------------------------------------------------
CUDA_MODES = [({}, "K1"), ({"noise_mode": "pregen"}, "K4"), ({"field_mode": "popcount"}, "K2")]


@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("opts", [m for m, _ in CUDA_MODES], ids=[n for _, n in CUDA_MODES])
def test_cuda_state_layout_equals_dense(opts, layout):
    """Every cuda datapath (K1, K4, K2) carries the dense backend's state
    tree: the same type, leaf types, dtypes and shapes, in both storage
    layouts; so a downgrade needs no conversion.  Only strides differ (the
    scan steps the lanes through a transposed view), which no consumer of
    the state depends on."""
    states = {}
    for name, kw in (("cuda", opts), ("dense", {"field_mode": opts.get("field_mode", "dense")})):
        bk = engine.make_batched_backend(name, n_bucket=64, n_trials=3, noise="xorshift",
                                         storage_layout=layout, device="cpu", **kw)
        models = [gset.toroidal_grid(36, seed=s).to_ising() for s in range(2)]
        prob = bk.stack(models)
        st = bk.init_state(prob, bk.init_noise([0, 1], [36, 36]))
        plateaus = engine.schedule_plateaus(SSAHyperParams(**HP).schedule("hassa"), "i0max")
        states[name] = bk.run_shots(prob, st, plateaus, 1)
    a, b = states["cuda"], states["dense"]
    assert type(a) is type(b)
    for x, y in zip(a, b):
        assert type(x) is type(y) and (x.dtype, x.shape) == (y.dtype, y.shape)
        assert torch.equal(x, y)  # and the same values, bit for bit


@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("opts", [m for m, _ in CUDA_MODES], ids=[n for _, n in CUDA_MODES])
def test_downgrade_mid_stream_carries_state(monkeypatch, opts, layout):
    """An injected compile fault on the cuda table's third quantum walks it
    to the dense backend with the engine state carried: every lane, seated
    before or after the downgrade, equals its uninterrupted one-shot solve
    on cuda, with status 'fallback'."""
    real = engine.BatchedCudaBackend.run_shots
    calls = {"n": 0}

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise InjectedCompileFailure("injected compile failure (quantum 3)")
        return real(self, *a, **k)

    monkeypatch.setattr(engine.BatchedCudaBackend, "run_shots", flaky)
    svc = _svc("cuda", storage_layout=layout, backend_opts=dict(opts))
    ss = _stream("cuda", service=svc)
    tickets = [ss.submit(r) for r in _requests(4)]
    ss.run_until_idle()
    monkeypatch.setattr(engine.BatchedCudaBackend, "run_shots", real)
    base = _svc("cuda", storage_layout=layout, backend_opts=dict(opts)).solve(_requests(4))
    for t, b in zip(tickets, base):
        resp = t.result(timeout=0)
        assert resp.status == "fallback"
        _assert_lane_identical(resp, b)
        hops = [(e.detail["from"], e.detail["to"]) for e in resp.events if e.kind == "fallback"]
        assert hops == [("cuda", "dense")]
    assert ss.stats["fallback_compile"] == 1


def test_build_time_fault_walks_the_chain():
    """An injected compile fault while the table is built downgrades it
    before any seat; every lane equals its cuda one-shot solve."""
    inj = FaultInjector()
    inj.arm("compile", backend="cuda")
    ss = _stream("cuda", service=_svc("cuda", faults=inj))
    tickets = [ss.submit(r) for r in _requests(3)]
    ss.run_until_idle()
    for t, b in zip(tickets, _baselines("cuda")):
        resp = t.result(timeout=0)
        assert resp.status == "fallback"
        _assert_lane_identical(resp, b)
    assert ss.stats["fallback_compile"] == 1 and ss.stats["stream_tables_created"] == 1


def test_terminal_fault_propagates_from_pump():
    inj = FaultInjector()
    inj.arm("compile", backend="sparse")
    ss = _stream("sparse", service=_svc("sparse", faults=inj))
    ss.submit(_requests(1)[0])
    with pytest.raises(InjectedCompileFailure):
        ss.pump()


@pytest.mark.parametrize("where", ["quantum", "table build"])
@pytest.mark.parametrize("exc", [KernelBuildError("nvcc failed"),
                                 KernelLaunchError("launch failed"),
                                 torch.cuda.OutOfMemoryError("CUDA out of memory")],
                         ids=["build", "launch", "oom"])
def test_real_cuda_kernel_fault_propagates(monkeypatch, exc, where):
    """Only injected faults walk the chain from the cuda backend: a kernel
    that does not build, launch or fit raises out of pump(), and no plain
    backend serves the stream in its place."""
    def fail(*_a, **_k):
        raise exc

    monkeypatch.setattr(engine.BatchedCudaBackend,
                        "run_shots" if where == "quantum" else "init_state", fail)
    ss = _stream("cuda")
    ss.submit(_requests(1)[0])
    with pytest.raises(type(exc)):
        ss.run_until_idle()
    assert ss.stats["fallback_compile"] == ss.stats["fallback_oom"] == 0


def test_nan_quarantine_requeues_the_lane_only():
    """A NaN burst on one slot retires only that lane (requeued with a
    re-autotuned I0 clamp); its tablemate stays bit-exact, and both equal
    the JAX stream's responses (the retry's I0 clamp too)."""
    out = []
    for pkg in PKGS:
        inj = pkg.Injector()
        inj.arm("nan", chunk=1, slots=(1,))
        ss = pkg.stream("sparse", service=pkg.svc("sparse", faults=inj))
        tickets = [ss.submit(r) for r in pkg.requests(2)]
        ss.run_until_idle()
        out.append(([t.result(timeout=0) for t in tickets], _stream_counters(ss),
                    tickets[1].retries))
    ((a, b), st, retries), (jresp, jst, jretries) = out
    assert a.status == "ok"
    _assert_lane_identical(a, _baselines("sparse")[0])
    assert b.result is not None and ["quarantine", "retry"] == [
        e.kind for e in b.events if e.kind in ("quarantine", "retry")]
    for r, w in zip((a, b), jresp):
        _assert_as_jax(r, w)
    retry = [e.detail["i0_max"] for e in b.events if e.kind == "retry"]
    assert retry == [e.detail["i0_max"] for e in jresp[1].events if e.kind == "retry"]
    assert st == jst and st["stream_quarantines"] == 1 and retries == jretries == 1


def test_quarantine_retries_exhausted():
    out = []
    for pkg in PKGS:
        inj = pkg.Injector()
        inj.arm("nan", count=100)
        ss = pkg.stream("sparse", slots=1, service=pkg.svc(
            "sparse", faults=inj, resilience=pkg.Res(max_retries=1)))
        t = ss.submit(pkg.request(0))
        ss.run_until_idle()
        out.append((t.result(timeout=0), _stream_counters(ss), ss.stats["quarantine_failures"]))
    (resp, st, n), (jresp, jst, jn) = out
    assert resp.status == jresp.status == "failed" and resp.result is None
    assert [e.kind for e in resp.events] == [e.kind for e in jresp.events]
    assert st == jst and st["stream_retries_exhausted"] == 1 and n == jn == 1


# ---------------------------------------------------------------------------
# Observability and driving
# ---------------------------------------------------------------------------
def test_stream_stats_counters_consistent():
    out = []
    for pkg in PKGS:
        ss = pkg.stream("sparse")
        tickets = [ss.submit(r) for r in pkg.requests(3)]
        progress = []
        ss.run_until_idle(progress.append)
        out.append((ss, tickets, progress))
    (ss, tickets, progress), (jss, _, jprogress) = out
    st = ss.stream_stats()
    assert st == jss.stream_stats()
    assert [(p.bucket, p.chunk, p.request_indices, p.best_cut) for p in progress] == \
           [(p.bucket, p.chunk, p.request_indices, p.best_cut) for p in jprogress]
    assert st["queued"] == 0 and st["live_slots"] == 0
    assert st["stream_submitted"] == 3 == st["stream_completed"]
    assert st["stream_seated"] == 3
    assert st["stream_live_lane_chunks"] <= st["stream_slot_chunks"]
    # 3 lanes x 4 chunks of real work, whatever the empty slots ran
    assert st["stream_live_lane_chunks"] == 3 * 4
    assert len(progress) == st["stream_quanta"]
    assert sum(len(p.request_indices) for p in progress) == 3 * 4
    for t in tickets:
        r = t.result(timeout=0)
        assert r.lane_wall_s is not None and r.queued_s is not None
        assert [e.kind for e in r.events] == ["seat", "retire"]


def test_background_thread_drives_stream():
    ss = _stream("cuda")
    ss.start(poll_s=0.001)
    try:
        tickets = [ss.submit(r) for r in _requests(2)]
        for t, base, want in zip(tickets, _baselines("cuda"), _jax_stream("cuda")[0]):
            resp = t.result(timeout=120.0)
            assert resp.status == "ok"
            _assert_lane_identical(resp, base)
            _assert_lane_identical(resp, want)
    finally:
        ss.stop()
    assert not ss._thread or not ss._thread.is_alive()
    with pytest.raises(TimeoutError):
        ss.submit(_requests(1)[0]).result(timeout=0.01)


def test_concurrent_submitters_with_background_loop():
    """Four threads submit while the background loop seats and runs them,
    the interpreter switching threads as often as it can: every ticket
    completes, bit-identically, and no counter loses an update."""
    import sys
    import threading

    reqs = _requests()
    ss = _stream("sparse")
    tickets, errors = [], []
    gate = threading.Barrier(4)

    def submitter(i):
        try:
            gate.wait(timeout=30)
            for r in reqs[i::4]:
                tickets.append((r.seed, ss.submit(r)))
        except Exception as e:  # pragma: no cover - surfaced by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ss.start(poll_s=0.0005)
        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        for seed, t in tickets:
            _assert_lane_identical(t.result(timeout=120.0), _baselines("sparse")[seed])
    finally:
        sys.setswitchinterval(old)
        ss.stop()
    assert not ss._thread.is_alive()
    st = ss.stream_stats()
    assert len(tickets) == 6 == st["stream_submitted"] == st["stream_completed"]
    assert st["stream_seated"] == 6 and st["queued"] == 0


def test_non_ssa_requests_rejected(monkeypatch):
    """SA and PT-SSA requests, and any registered family that does not run
    the plateau program, are rejected at the front door, as in the JAX
    package: they are served by AnnealService.solve."""
    from repro_torch.core.pt import PTSSAHyperParams
    from repro_torch.core.sa import SAHyperParams

    ss = _stream("sparse")
    for hp in (SAHyperParams(n_trials=2, n_cycles=8), PTSSAHyperParams(n_replicas=2)):
        with pytest.raises(AdmissionError, match="plateau-family"):
            ss.submit(AnnealRequest(problem=gset.toroidal_grid(36, seed=0), hp=hp))

    @dataclasses.dataclass(frozen=True)
    class OtherHP(SSAHyperParams):
        pass

    fam = registry.AlgoFamily("other", OtherHP, "_solve_other_group", lambda r, h, nb: ())
    monkeypatch.setitem(registry._REGISTRY, "other", fam)
    with pytest.raises(AdmissionError, match="plateau-family"):
        ss.submit(AnnealRequest(problem=gset.toroidal_grid(36, seed=0), hp=OtherHP(n_trials=2)))
    assert ss.stats["stream_submitted"] == 0


def test_not_ported_stream_inputs_raise():
    """An unknown partition raises (spin sharding is served since its port:
    tests/test_torch_spinshard.py); an object that is neither a problem nor
    carries a model is rejected at admission (problem encodings are served:
    tests/test_torch_problems.py)."""
    with pytest.raises(ValueError, match="unknown partition"):
        StreamingAnnealService(backend="sparse", partition="bogus", device="cpu")

    class NoModel:
        model = None

    with pytest.raises(AdmissionError):
        _stream("sparse").submit(AnnealRequest(problem=NoModel(), hp=SSAHyperParams()))
    with pytest.raises(AdmissionError):
        _stream("sparse").submit(AnnealRequest(problem="G11", hp=SSAHyperParams()))


def test_stream_hp_auto_resolves_at_submit():
    req = AnnealRequest(problem=gset.toroidal_grid(36, seed=3), hp="auto",
                        auto_base=SSAHyperParams(**HP), seed=3)
    ss = _stream("sparse")
    t = ss.submit(req)
    assert not isinstance(t.request.hp, str) and t.autotune is not None
    ss.run_until_idle()
    resp = t.result(timeout=0)
    base = _svc("sparse").solve([req])[0]
    _assert_lane_identical(resp, base)
    assert resp.request.hp == base.request.hp and ss.stats["autotuned"] == 1


# ---------------------------------------------------------------------------
# The launcher and the traffic benchmark
# ---------------------------------------------------------------------------
def test_launcher_stream_mode(capsys):
    """--stream prints one line per problem and the stream summary; the best
    cuts equal the service mode's (same seeds)."""
    from repro_torch.launch import anneal as launch

    flags = ["--problem", "G11,King1", "--trials", "2", "--m-shot", "2", "--tau", "2",
             "--i0-max", "4", "--backend", "cuda", "--device", "cpu"]
    launch.main(flags + ["--stream", "--stream-slots", "2", "--priority", "interactive"])
    out = capsys.readouterr().out.splitlines()
    launch.main(flags)
    svc_out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("G11-like: best cut ") and "[chunks=2/2" in out[0]
    assert out[1].startswith("King1: best cut ") and out[1].endswith("status=ok")
    assert out[-1].startswith("stream of 2 in ") and "tables=2" in out[-1]
    cuts = [line.split("best cut ")[1].split()[0] for line in out[:2]]
    assert cuts == [line.split("best cut ")[1].split()[0] for line in svc_out
                    if ": best cut " in line and not line.startswith("[")]


def test_launcher_checkpoint_dir(capsys, tmp_path):
    """--checkpoint-dir runs the service with checkpoints on (one problem
    too) and leaves nothing behind on success."""
    from repro_torch.launch import anneal as launch

    flags = ["--problem", "G11", "--trials", "2", "--m-shot", "2", "--tau", "2", "--i0-max",
             "4", "--backend", "dense", "--device", "cpu"]
    launch.main(flags + ["--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    launch.main(flags + ["--service"])
    ref = capsys.readouterr().out.splitlines()
    assert out[-2] == ref[-2] and out[-2].startswith("G11-like: best cut ")
    assert os.listdir(tmp_path) == []


def test_serve_stream_trace_model_matches_jax():
    """The traffic benchmark's arrivals and request trace are the JAX
    benchmark's for the same calibration traces and seeds."""
    jbench = pytest.importorskip("benchmarks.serve_stream")
    from repro_torch.benchmarks import serve_stream as bench

    np.testing.assert_array_equal(bench.poisson_arrivals(24, 3.0, 0, burst=4),
                                  jbench.poisson_arrivals(24, 3.0, 0, burst=4))
    traces = [[5, 7, 7, 9, 9, 9, 10, 10], [3, 3, 4, 8, 8, 8, 8, 9]]
    hp, jhp = SSAHyperParams(**dict(HP, m_shot=8)), JHP(**dict(HP, m_shot=8))
    got = bench.make_trace([{"problem": gset.toroidal_grid(36, seed=s), "seed": s, "trace": t}
                            for s, t in enumerate(traces)], hp, 12, seed=3)
    want = jbench.make_trace([{"problem": jgset.toroidal_grid(36, seed=s), "seed": s,
                               "trace": t} for s, t in enumerate(traces)], jhp, 12, seed=3)
    for a, b in zip(got, want):
        assert (a["req"].target_cut, a["req"].seed, a["chunks_needed"], a["work"],
                a["priority"]) == (b["req"].target_cut, b["req"].seed, b["chunks_needed"],
                                   b["work"], b["priority"])


def test_serve_stream_replay_is_a_bit_exact_prefix():
    """The traffic benchmark on the CPU: calibration, an open-loop replay on
    the background thread and the drain baseline; every streamed trace is a
    prefix of its calibration trace, and the scores are well formed."""
    from repro_torch.benchmarks import serve_stream as bench

    problems = [gset.toroidal_grid(36, seed=s, name=f"t{s}") for s in range(3)]
    hp = SSAHyperParams(**dict(HP, m_shot=6))
    kw = {"device": "cpu"}
    entries = bench.calibrate(problems, hp, "cuda", **kw)
    trace = bench.make_trace(entries, hp, 8, seed=0)
    s_stream, p50, lane_max = bench.probe_stream_capacity(trace, "cuda", 2, **kw)
    assert s_stream > 0 and 0 < p50 <= lane_max
    arrivals = bench.poisson_arrivals(8, 2.0 / s_stream, 0, burst=2)
    deadline = max(2 * lane_max, 0.25)
    recs, stats = bench.run_stream(trace, arrivals, deadline, "cuda", 2,
                                   result_timeout_s=120.0, **kw)
    assert bench.check_prefix_determinism(recs) == 0
    assert all(r["resp"].status in ("ok", "deadline", "shed") for r in recs)
    assert 0 < stats["occupancy"] <= 1 and stats["stream_completed"] >= 8
    drec, dstats = bench.run_drain(trace, arrivals, "cuda", 2, **kw)
    s, d = bench.score(recs, deadline), bench.score(drec, deadline)
    assert s["completed"] + s["dropped"] == 8 == d["completed"] + d["dropped"]
    assert 0 < dstats["occupancy"] <= 1


def test_chaos_benchmark_smoke(tmp_path):
    """The chaos benchmark's smoke run passes every gate on the CPU."""
    from repro_torch.benchmarks import chaos

    rep = chaos.run(smoke=True, json_path=str(tmp_path / "chaos.json"), device="cpu")
    assert rep["ok"], rep["failures"]
    assert set(rep["scenarios"]) == {"kill_resume_sparse", "kill_resume_dense",
                                     "kill_resume_cuda", "compile_fallback", "oom_tiled",
                                     "nan_quarantine", "deadline", "chaos_schedules"}
    assert (tmp_path / "chaos.json").exists()
