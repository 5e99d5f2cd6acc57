"""``backend='auto'`` of the port against the JAX package's, on the CPU.

``backend='auto'`` resolves by the port's own ``engine.MIN_RESIDENT_N``
(measured on the H100), the JAX package's by its 256 (tuned on the TPU): on
either side of the port's threshold the two runs may resolve to different
backends, and every backend gives the same numbers, so the port's 'auto'
run must equal the JAX package's 'auto' run bit for bit — best_H, best
spins, itanh and the xorshift lanes — through ``make_backend``,
``make_batched_backend``, ``anneal()``, a service solve whose buckets
straddle the threshold, the stream, a spin shard and the launcher.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SolverConfig as JSolverConfig  # noqa: E402
from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core import ssqa as jssqa  # noqa: E402
from repro.serve import AnnealRequest as JRequest  # noqa: E402
from repro.serve import AnnealService as JService  # noqa: E402
from repro.serve import StreamingAnnealService as JStream  # noqa: E402
from repro.serve import StreamPolicy as JPolicy  # noqa: E402
from repro.serve import resilience as jres  # noqa: E402
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams, anneal  # noqa: E402
from repro_torch.core.ssqa import SSQAHyperParams  # noqa: E402
from repro_torch.serve import AnnealRequest, AnnealService  # noqa: E402
from repro_torch.serve import StreamingAnnealService, StreamPolicy  # noqa: E402
from repro_torch.serve import resilience  # noqa: E402

HP = dict(n_trials=3, m_shot=2, tau=4, i0_min=1, i0_max=8)
MIN_N = engine.MIN_RESIDENT_N
# Spin counts on either side of the port's threshold: just below it, and it.
SIDES = {"below": MIN_N - 4, "at": MIN_N}


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _assert_state_equal(got, want):
    """Engine states field by field; words and lanes as 32-bit patterns."""
    assert type(got).__name__ == type(want).__name__
    for field, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=field)


def _assert_result_equal(got, want, traces=True):
    for k in ("best_energy", "best_m", "best_cut") + (("energy_mean", "energy_min")
                                                        if traces else ()):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# backend='auto'
# ---------------------------------------------------------------------------
def test_resolve_backend_rule():
    assert engine.resolve_backend("auto", MIN_N - 1) == "dense"
    assert engine.resolve_backend("auto", MIN_N) == "cuda"
    for name in ("sparse", "dense", "cuda"):
        assert engine.resolve_backend(name, 1) == name == engine.resolve_backend(name, 10**6)
    # The JAX package's rule has the same shape, at its own threshold.
    assert jengine.resolve_backend("auto", jengine.MIN_RESIDENT_N) == "pallas"
    assert jengine.resolve_backend("auto", jengine.MIN_RESIDENT_N - 1) == "dense"


@pytest.mark.parametrize("side", list(SIDES))
def test_auto_backend_state_matches_jax(side):
    """make_backend('auto') and a plateau chain: itanh, lanes, spins and the
    running best equal the JAX package's 'auto' backend."""
    n = SIDES[side]
    model, jmodel = (g.toroidal_grid(n, seed=7).to_ising() for g in (gset, jgset))
    bk = engine.make_backend("auto", model, n_trials=3, noise="xorshift", device="cpu")
    jbk = jengine.make_backend("auto", jmodel, n_trials=3, noise="xorshift")
    assert bk.name == ("cuda" if side == "at" else "dense")
    plateaus = engine.schedule_plateaus(SSAHyperParams(**HP).schedule(), "i0max")
    st, _, _ = engine.run_schedule(bk, plateaus, bk.init_state(3))
    jst, _, _ = jengine.run_schedule(jbk, plateaus, jbk.init_state(3))
    _assert_state_equal(st, jst)


@pytest.mark.parametrize("side", list(SIDES))
def test_auto_anneal_matches_jax(side):
    n = SIDES[side]
    got = anneal(gset.toroidal_grid(n, seed=5), SSAHyperParams(**HP), seed=2, device="cpu",
                 config=SolverConfig(backend="auto", noise="xorshift"))
    want = janneal(jgset.toroidal_grid(n, seed=5), JHP(**HP), seed=2,
                   config=JSolverConfig(backend="auto", noise="xorshift"))
    _assert_result_equal(got, want)


@pytest.mark.parametrize("side", list(SIDES))
def test_auto_batched_matches_jax(side):
    nb = SIDES[side]
    sizes = (nb, nb - 4)
    bk = engine.make_batched_backend("auto", n_bucket=nb, n_trials=3, noise="xorshift",
                                     device="cpu")
    jbk = jengine.make_batched_backend("auto", n_bucket=nb, n_trials=3, noise="xorshift")
    assert bk.name == ("cuda" if side == "at" else "dense")
    prob = bk.stack([gset.toroidal_grid(s, seed=s).to_ising() for s in sizes])
    jprob = jbk.stack([jgset.toroidal_grid(s, seed=s).to_ising() for s in sizes])
    st = bk.init_state(prob, bk.init_noise((1, 2), sizes))
    jst = jbk.init_state(jprob, jbk.init_noise((1, 2), sizes))
    plateaus = engine.schedule_plateaus(SSAHyperParams(**HP).schedule(), "i0max")
    _assert_state_equal(bk.run_shots(prob, st, plateaus, 2),
                        jbk.run_shots(jprob, jst, plateaus, 2))


def _straddling(jax):
    """Requests in a bucket below the port's threshold (min_bucket 8) and in
    one at or above it: each resolves to another backend in the port."""
    g, Req, Hp = (jgset, JRequest, JHP) if jax else (gset, AnnealRequest, SSAHyperParams)
    sizes = (MIN_N // 2, MIN_N // 2 - 2, 2 * MIN_N)
    return [Req(problem=g.toroidal_grid(n, seed=s), hp=Hp(**HP), seed=s)
            for s, n in enumerate(sizes)]


def test_auto_service_straddles_the_threshold():
    svc = AnnealService(backend="auto", noise="xorshift", min_bucket=8, device="cpu")
    got = svc.solve(_straddling(False))
    want = JService(backend="auto", noise="xorshift", min_bucket=8).solve(_straddling(True))
    for g, w in zip(got, want):
        _assert_result_equal(g.result, w.result, traces=False)
        np.testing.assert_array_equal(g.chunk_best_cut, np.asarray(w.chunk_best_cut))
        assert (g.status, g.bucket, g.batch) == (w.status, w.bucket, w.batch)
    # The program cache's keys carry (kind, backend, ..., bucket, ...).
    resolved = {k[4]: k[1] for k in svc._programs}
    assert resolved == {engine.bucket_n(MIN_N // 2, 8): "dense",
                        engine.bucket_n(2 * MIN_N, 8): "cuda"}


def test_auto_filters_the_union_of_options():
    """An 'auto' caller passes the options of both backends; each bucket
    keeps those of the backend chosen (noise_mode on cuda, j_mode on
    dense), as the JAX service does."""
    opts = {"noise_mode": "pregen", "j_mode": "dense", "j_dtype": torch.bfloat16}
    svc = AnnealService(backend="auto", noise="xorshift", min_bucket=8, backend_opts=opts,
                        device="cpu")
    got = svc.solve(_straddling(False))
    jopts = {"noise_mode": "pregen", "j_mode": "dense", "j_dtype": jnp.bfloat16}
    want = JService(backend="auto", noise="xorshift", min_bucket=8,
                    backend_opts=jopts).solve(_straddling(True))
    for g, w in zip(got, want):
        _assert_result_equal(g.result, w.result, traces=False)
    keys = {k[4]: dict(k[2]) for k in svc._programs}
    assert set(keys[engine.bucket_n(MIN_N // 2, 8)]) == {"j_mode", "j_dtype"}
    assert set(keys[engine.bucket_n(2 * MIN_N, 8)]) == {"noise_mode", "j_dtype"}
    assert set(resilience.filter_backend_opts("cuda", opts)) == set(
        jres.filter_backend_opts("pallas", jopts))


def test_auto_stream_matches_jax():
    ss = StreamingAnnealService(service=AnnealService(backend="auto", noise="xorshift",
                                                      min_bucket=8, device="cpu"),
                                policy=StreamPolicy(slots_per_table=2))
    tickets = [ss.submit(r) for r in _straddling(False)]
    ss.run_until_idle()
    js = JStream(backend="auto", noise="xorshift", min_bucket=8,
                 policy=JPolicy(slots_per_table=2))
    jtickets = [js.submit(r) for r in _straddling(True)]
    js.run_until_idle()
    for t, jt in zip(tickets, jtickets):
        g, w = t.result(timeout=0), jt.result(timeout=0)
        _assert_result_equal(g.result, w.result, traces=False)
        np.testing.assert_array_equal(g.chunk_best_cut, np.asarray(w.chunk_best_cut))
    assert {t.backend for t in ss._tables.values()} == {"dense", "cuda"}


def test_auto_spin_shard_matches_jax():
    """A spin shard's base backend 'auto' resolves over its bucket."""
    from repro.sharding import spin_mesh as jspin_mesh
    from repro_torch.sharding import spin_mesh

    nb = 2 * MIN_N
    model, jmodel = (g.toroidal_grid(nb - 4, seed=9).to_ising() for g in (gset, jgset))
    bk = engine.make_batched_backend("auto", n_bucket=nb, n_trials=3, noise="xorshift",
                                     partition="spin", mesh=spin_mesh(1, device="cpu"))
    jbk = jengine.make_batched_backend("auto", n_bucket=nb, n_trials=3, noise="xorshift",
                                       partition="spin", mesh=jspin_mesh(1))
    assert bk.base_backend == "cuda"
    prob, jprob = bk.stack([model]), jbk.stack([jmodel])
    st = bk.init_state(prob, bk.init_noise([4], [model.n]))
    jst = jbk.init_state(jprob, jbk.init_noise([4], [jmodel.n]))
    plateaus = engine.schedule_plateaus(SSAHyperParams(**HP).schedule(), "i0max")
    bh, bm = bk.finalize(bk.run_shots(prob, st, plateaus, 2))
    jbh, jbm = jbk.finalize(jbk.run_shots(jprob, jst, plateaus, 2))
    np.testing.assert_array_equal(bh.numpy(), np.asarray(jbh))
    np.testing.assert_array_equal(bm.numpy()[..., :model.n], np.asarray(jbm)[..., :model.n])


def test_auto_ssqa_above_max_ring_raises():
    """Rings above 32 replicas (the ring modes' former limit) at the
    threshold: 'auto' and 'cuda' run K1's ring mode there (no traces) and
    equal the JAX package's pallas run, and the service's 'auto' group of
    the same request equals it too; nothing raises."""
    hp = SSQAHyperParams(n_trials=64, n_replicas=64, m_shot=1, tau=2, i0_max=4)
    jhp = jssqa.SSQAHyperParams(n_trials=64, n_replicas=64, m_shot=1, tau=2, i0_max=4)
    p, jp = gset.toroidal_grid(MIN_N, seed=0), jgset.toroidal_grid(MIN_N, seed=0)
    want = jssqa.anneal_ssqa(jp, jhp, seed=0, track_energy=False,
                             config=JSolverConfig(backend="pallas", noise="xorshift"))
    for backend in ("cuda", "auto"):
        got = anneal(p, hp, device="cpu", track_energy=False,
                     config=SolverConfig(backend=backend, noise="xorshift"))
        _assert_result_equal(got, want, traces=False)
    resp = AnnealService(backend="auto", noise="xorshift", device="cpu").solve(
        [AnnealRequest(problem=p, hp=hp, seed=0)])
    assert resp[0].status == "ok"
    _assert_result_equal(resp[0].result, want, traces=False)


@pytest.mark.parametrize("n", [36, 100], ids=["bucket64", "bucket128"])
def test_auto_service_ptssa_group_matches_jax(n):
    """A PT-SSA request to AnnealService(backend='auto'): its group takes the
    dense backend (no kernel runs a per-replica I0), the JAX package's
    'auto' below 256 spins, at buckets 64 and 128 alike; both answer equal.
    An explicit 'cuda' still rejects it, as the JAX package's 'pallas'
    does."""
    from repro.core.pt import PTSSAHyperParams as JPTSSA
    from repro_torch.core.pt import PTSSAHyperParams
    from repro_torch.serve import AdmissionError

    kw = dict(n_replicas=4, n_rounds=4, tau=10)
    want = JService(backend="auto", min_bucket=16).solve(
        [JRequest(problem=jgset.toroidal_grid(n, seed=0), hp=JPTSSA(**kw), seed=0)])
    req = [AnnealRequest(problem=gset.toroidal_grid(n, seed=0), hp=PTSSAHyperParams(**kw),
                         seed=0)]
    got = AnnealService(backend="auto", min_bucket=16, device="cpu").solve(req)
    assert got[0].status == want[0].status == "ok"
    assert got[0].bucket == want[0].bucket == {36: 64, 100: 128}[n]
    assert engine.resolve_backend("auto", got[0].bucket) == "cuda"
    _assert_result_equal(got[0].result, want[0].result, traces=False)
    with pytest.raises(AdmissionError, match="per-replica I0"):
        AnnealService(backend="cuda", min_bucket=16, device="cpu").solve(req)


def test_auto_anneal_pt_ssa_matches_jax():
    """anneal_pt_ssa(backend='auto') takes the dense backend at any size (the
    JAX package's 'auto' is dense below 256 spins); both answer equal."""
    from repro.core.pt import PTSSAHyperParams as JPTSSA
    from repro.core.pt import anneal_pt_ssa as janneal_pt_ssa
    from repro_torch.core.pt import PTSSAHyperParams, anneal_pt_ssa

    kw = dict(n_replicas=4, n_rounds=3, tau=6)
    want = janneal_pt_ssa(jgset.toroidal_grid(36, seed=0), JPTSSA(**kw), seed=2, backend="auto")
    got = anneal_pt_ssa(gset.toroidal_grid(36, seed=0), PTSSAHyperParams(**kw), seed=2,
                        backend="auto", device="cpu")
    _assert_result_equal(got, want, traces=False)


def test_launcher_backend_auto_matches_jax(capsys, monkeypatch):
    from repro.launch import anneal as jlaunch
    from repro_torch.launch import anneal as launch

    flags = ["--problem", "G11", "--trials", "2", "--m-shot", "1", "--tau", "3", "--i0-max",
             "4", "--seed", "3", "--backend", "auto"]
    launch.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["anneal"] + flags)
    jlaunch.main()
    want = capsys.readouterr().out.splitlines()

    def lines(out):  # wall times aside
        return [x.split("(")[0] if x.startswith("best cut") else x
                for x in out if not x.startswith("G11")]

    assert lines(got) == lines(want) and len(got) == 3
    assert "backend=auto" in got[0]
