"""SSQA in the port against the JAX package: the J⊥ schedule, the ring
coupling, the ring modes of K1 and K2 (their plain versions against the
Pallas kernels in interpret mode), ``anneal_ssqa`` on every port backend,
the cycle loop of the pregen datapaths, validation and autotune.

Small sizes (a 48-spin complete graph, a 16×16 torus, 8 trials, rings of 2
and 4, τ ≤ 10, two iterations), inputs from numpy seeds.  The bar is
bit-identity: best_H, best_m, the energy traces, Itanh and the lanes equal
the JAX package's.  The per-cycle mean energy is an f32 mean of 8 integer
energies, exact in both frameworks, so it is compared exactly too.
"""
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import SolverConfig as JSolverConfig  # noqa: E402
from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.core import autotune as jautotune  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core import ssqa as jssqa  # noqa: E402
from repro.core.ising import IsingModel as JIsingModel  # noqa: E402
from repro.kernels import bitplane as jbitplane  # noqa: E402
from repro.kernels import ssa_update as jssa  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import autotune, engine, gset, schedule, ssa  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ising import IsingModel  # noqa: E402
from repro_torch.core.ssqa import SSQAHyperParams, anneal_ssqa  # noqa: E402
from repro_torch.kernels import ops, ssa_update  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUTS = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")

# (problem, ring size): a complete graph with rings of 2 (the doubled edge)
# and a torus with rings of 4.
PROBLEMS = {
    "K-like48": (lambda g: g.complete_graph(48, seed=5), 2),
    "torus256": (lambda g: g.toroidal_grid(256, seed=3), 4),
}
HP = dict(n_trials=8, m_shot=2, tau=5, i0_max=8, jperp_max=3)


def _hp(problem, cls):
    return cls(**HP, n_replicas=PROBLEMS[problem][1])


def _as_np(g, w):
    """A port output as numpy, words viewed as the JAX side's uint32."""
    w = np.asarray(w)
    return (g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()), w


# ---------------------------------------------------------------------------
# The schedule and the plateau program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i0_min,i0_max,tau,beta,jperp_max", [
    (1, 256, 1, 1, 4),    # 9 plateaus: 4·s/8 hits 0.5 and 2.5, rounded half to even
    (1, 32, 100, 1, 4),   # Table II with the default ramp
    (1, 8, 4, 1, 3),
    (2, 64, 7, 2, 5),     # beta_shift 2
    (4, 4, 3, 1, 6),      # one plateau: J⊥ = jperp_max throughout
    (1, 16, 2, 1, 0),     # no coupling, but still an SSQA schedule
])
def test_ssqa_schedule_and_signature_match_jax(i0_min, i0_max, tau, beta, jperp_max):
    got = schedule.ssqa_schedule(i0_min, i0_max, tau, beta, jperp_max=jperp_max)
    want = jschedule.ssqa_schedule(i0_min, i0_max, tau, beta, jperp_max=jperp_max)
    for a in ("i0_per_cycle", "store_mask", "jperp_per_cycle"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a), err_msg=a)
        assert getattr(got, a).dtype == getattr(want, a).dtype
    assert (got.tau, got.steps) == (want.tau, want.steps)
    assert got.signature() == want.signature()
    classical = schedule.hassa_schedule(i0_min, i0_max, tau, beta)
    assert classical.jperp_per_cycle is None
    assert classical.signature() == jschedule.hassa_schedule(i0_min, i0_max, tau,
                                                             beta).signature()
    assert got.signature() != classical.signature()


def test_ssqa_ramp_rounds_half_to_even():
    ramp = schedule.ssqa_schedule(1, 256, 1, jperp_max=4).jperp_per_cycle
    assert ramp.tolist() == [0, 0, 1, 2, 2, 2, 3, 4, 4]


@pytest.mark.parametrize("storage", ["i0max", "all"])
def test_plateau_program_carries_jperp_like_jax(storage):
    sched = SSQAHyperParams(n_trials=8, n_replicas=4, tau=3, i0_max=16).schedule()
    jsched = jssqa.SSQAHyperParams(n_trials=8, n_replicas=4, tau=3, i0_max=16).schedule()
    got = engine.schedule_plateaus(sched, storage)
    want = jengine.schedule_plateaus(jsched, storage)
    assert [dataclasses.astuple(p) for p in got] == [dataclasses.astuple(p) for p in want]
    assert got[0].jperp == 0 and got[-1].jperp == 4
    for c in (7, 15, 22):
        tiled = engine.tile_plateaus(got, c)
        jtiled = jengine.tile_plateaus(want, c)
        assert [dataclasses.astuple(p) for p in tiled] == [dataclasses.astuple(p) for p in jtiled]
        for a, b in zip(engine.plateau_cycle_schedules(tiled),
                        jengine.plateau_cycle_schedules(jtiled)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32


def test_plateaus_split_where_only_jperp_changes():
    sched = dataclasses.replace(schedule.hassa_schedule(4, 4, 6),
                                jperp_per_cycle=np.asarray([0, 0, 1, 1, 1, 2], np.int32))
    got = engine.schedule_plateaus(sched)
    assert [(p.i0, p.length, p.eligible, p.jperp) for p in got] == [
        (4, 2, True, 0), (4, 3, True, 1), (4, 1, True, 2)]


@pytest.mark.parametrize("r", [2, 4, 8])
def test_replica_coupling_matches_jax(r):
    rs = np.random.default_rng(r)
    m = rs.choice(np.asarray([-1, 1], np.int8), size=(3, 2 * r, 11))
    want = np.asarray(jengine.replica_coupling(jnp.asarray(m), r))
    got = engine.replica_coupling(torch.from_numpy(m), r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if r == 2:  # the one neighbour counts from both sides
        np.testing.assert_array_equal(got.numpy()[:, 0], 2 * m[:, 1].astype(np.int32))


# ---------------------------------------------------------------------------
# The ring modes' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
def _k1_case(b, r, n, seed):
    rs = np.random.default_rng(seed)
    J = np.triu(rs.integers(-3, 4, size=(b, n, n)), 1)
    J = (J + J.transpose(0, 2, 1)).astype(np.float32)
    spins = rs.choice([-1, 1], size=(2, b, r, n)).astype(np.int8)
    best_H = np.full((b, r), 2**30, np.int32)
    best_H[:, 0] = -10**6  # a trial whose best cannot improve keeps its words
    return dict(
        m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(spins[0]))),
        itanh=rs.integers(-6, 6, size=(b, r, n)).astype(np.int32), J=J,
        h=rs.integers(-2, 3, size=(b, n)).astype(np.int32),
        rng=np.stack([np.asarray(jrng.xorshift_init(seed + k, (r, n))) for k in range(b)]),
        best_H=best_H,
        best_m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(spins[1]))))


def _torch_case(case):
    return {k: (torch.from_numpy(v) if v.dtype == np.float32 else convert._as_i32(v, "cpu"))
            for k, v in case.items()}


K1_ORDER = ("m_packed", "itanh", "J", "h", "rng")


@pytest.mark.parametrize("b,r,n,c,nr", [(1, 8, 40, 6, 4), (1, 4, 33, 5, 2),
                                        (2, 6, 36, 4, 3), (1, 8, 70, 3, 8)])
@pytest.mark.parametrize("eligible", [True, False])
@pytest.mark.parametrize("jperp", [0, 3])
def test_k1_ring_plain_matches_pallas(b, r, n, c, nr, eligible, jperp):
    case = _k1_case(b, r, n, seed=b + r + n + c)
    kw = dict(n_cycles=c, n_rnd=2, eligible=eligible)
    want = jssa.ssa_plateau_packed_batched(
        *(jnp.asarray(case[k]) for k in K1_ORDER), jnp.int32(8),
        jnp.asarray(case["best_H"]), jnp.asarray(case["best_m_packed"]),
        block_r=nr, jperp=jperp, n_replicas=nr, **kw)
    got = ssa_update.ssa_plateau_packed_batched(**_torch_case(case), i0=8, jperp=jperp,
                                                n_replicas=nr, **kw)
    for name, g, w in zip(OUTS, got, want):
        np.testing.assert_array_equal(*_as_np(g, w), err_msg=name)
    if jperp == 0:  # the ring mode without coupling is the classical plateau
        classical = ssa_update.ssa_plateau_packed_batched(**_torch_case(case), i0=8, **kw)
        for name, g, w in zip(OUTS, got, classical):
            assert torch.equal(g, w), name
    if b == 1:
        one = ssa_update.ssa_plateau_packed(**{k: v[0] for k, v in _torch_case(case).items()},
                                            i0=8, jperp=jperp, n_replicas=nr, **kw)
        for g, w in zip(one, got):
            assert torch.equal(g, w[0])


def _k2_case(b, r, n, c, seed):
    rs = np.random.default_rng(seed)
    pjs = []
    for _ in range(b):
        J = np.triu(rs.integers(-1, 2, size=(n, n)), 1)
        pjs.append(jbitplane.pack_couplings((J + J.T).astype(np.float32), 1))
    case = _k1_case(b, r, n, seed)
    del case["J"]
    case.update(sign=np.stack([np.asarray(p.sign) for p in pjs]),
                mags=np.stack([np.asarray(p.mags) for p in pjs]),
                base=np.stack([np.asarray(p.base) for p in pjs]))
    sched = SSQAHyperParams(n_trials=8, n_replicas=4, tau=2, i0_max=16, jperp_max=5).schedule()
    chain = engine.tile_plateaus(engine.schedule_plateaus(sched), c)
    i0, fold, jperp = engine.plateau_cycle_schedules(chain)
    case.update(i0_sched=i0, fold_sched=fold)
    return case, jperp


K2_ORDER = ("m_packed", "itanh", "sign", "mags", "base", "h", "rng", "i0_sched",
            "fold_sched", "best_H", "best_m_packed")


@pytest.mark.parametrize("b,r,n,c,nr", [(1, 8, 40, 9, 4), (2, 4, 33, 10, 2),
                                        (1, 6, 64, 7, 3), (2, 8, 50, 12, 8)])
def test_k2_ring_plain_matches_pallas(b, r, n, c, nr):
    case, jperp = _k2_case(b, r, n, c, seed=b * 100 + n + c)
    assert jperp.any() and not jperp.all()  # a ramp that starts at 0
    want = jssa.ssa_plateau_popcount_batched(
        *(jnp.asarray(case[k]) for k in K2_ORDER), n_rnd=2, block_r=nr,
        jperp_sched=jnp.asarray(jperp), n_replicas=nr)
    tc = _torch_case(case)
    got = ssa_update.ssa_plateau_popcount_batched(
        *(tc[k] for k in K2_ORDER), n_rnd=2, jperp_sched=torch.from_numpy(jperp),
        n_replicas=nr)
    for name, g, w in zip(OUTS, got, want):
        np.testing.assert_array_equal(*_as_np(g, w), err_msg=name)
    if b == 1:
        one = ssa_update.ssa_plateau_popcount(
            *(tc[k][0] if tc[k].dim() > 1 else tc[k] for k in K2_ORDER), n_rnd=2,
            jperp_sched=torch.from_numpy(jperp), n_replicas=nr)
        for g, w in zip(one, got):
            assert torch.equal(g, w[0])


# ---------------------------------------------------------------------------
# anneal_ssqa on every port backend against the JAX package
# ---------------------------------------------------------------------------
# Port backend → the JAX backend it is held against: the scan backends
# against JAX's dense scan, the cuda backend against the pallas kernels.
PORT_BACKENDS = {
    "sparse": ("sparse", "auto", ("dense", "dense")),
    "dense": ("dense", "dense", ("dense", "dense")),
    "cuda": ("cuda", "dense", ("pallas", "dense")),
    "cuda-popcount": ("cuda", "popcount", ("pallas", "popcount")),
}


@functools.lru_cache(maxsize=None)
def _jax_ssqa(problem, backend, field_mode, layout, track_energy, noise="xorshift"):
    p = PROBLEMS[problem][0](jgset)
    return jssqa.anneal_ssqa(
        p, _hp(problem, jssqa.SSQAHyperParams), seed=1, track_energy=track_energy,
        config=JSolverConfig(backend=backend, noise=noise, field_mode=field_mode,
                             storage_layout=layout))


def _assert_same(got, want, track_energy):
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)
    np.testing.assert_array_equal(got.best_cut, want.best_cut)
    if track_energy:
        np.testing.assert_array_equal(got.energy_min, want.energy_min)
        np.testing.assert_array_equal(got.energy_mean, want.energy_mean)
    else:
        assert got.energy_min is None and want.energy_min is None


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("backend", sorted(PORT_BACKENDS))
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("track_energy", [False, True])
def test_anneal_ssqa_matches_jax(problem, backend, layout, track_energy):
    bk, field_mode, jax_side = PORT_BACKENDS[backend]
    got = anneal_ssqa(
        PROBLEMS[problem][0](gset), _hp(problem, SSQAHyperParams), seed=1,
        track_energy=track_energy, device="cpu",
        config=SolverConfig(backend=bk, noise="xorshift", field_mode=field_mode,
                            storage_layout=layout))
    _assert_same(got, _jax_ssqa(problem, *jax_side, layout, track_energy), track_energy)
    assert isinstance(got.hp, SSQAHyperParams)


def test_ssqa_differs_from_ssa():
    """The coupling changes the dynamics (SSQA is not SSA renamed)."""
    p = PROBLEMS["torus256"][0](gset)
    cfg = SolverConfig(backend="sparse", noise="xorshift")
    q = anneal_ssqa(p, _hp("torus256", SSQAHyperParams), seed=1, device="cpu", config=cfg)
    c = ssa.anneal(p, ssa.SSAHyperParams(**{k: v for k, v in HP.items() if k != "jperp_max"}),
                   seed=1, device="cpu", config=cfg)
    assert not np.array_equal(q.best_m, c.best_m)


# ---------------------------------------------------------------------------
# The J⊥ = 0 plateau and the dispatch of the cuda backend
# ---------------------------------------------------------------------------
def _record(monkeypatch, name):
    """Record the keyword arguments of each call of ``ssa_update.<name>``."""
    calls, fn = [], getattr(ssa_update, name)

    def wrapped(*a, **k):
        calls.append(k)
        return fn(*a, **k)

    monkeypatch.setattr(ssa_update, name, wrapped)
    return calls


@pytest.mark.parametrize("backend", ["sparse", "cuda"])
def test_jperp_zero_plateau_equals_classical(backend):
    """A backend with rings runs a J⊥ = 0 plateau as the classical one."""
    model = PROBLEMS["torus256"][0](gset).to_ising()
    kw = dict(n_trials=8, n_rnd=2, noise="xorshift", device="cpu")
    ring = engine.make_backend(backend, model, n_replicas=4, **kw)
    classical = engine.make_backend(backend, model, **kw)
    outs = []
    for bk in (ring, classical):
        st, _, _ = bk.run_plateau(bk.init_state(3), 4, length=6, eligible=True, jperp=0)
        outs.append(st)
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


def test_cuda_k1_ring_mode_only_where_jperp(monkeypatch):
    """K1 gets n_replicas only for plateaus with J⊥ ≠ 0: the first plateau
    of every SSQA schedule runs the classical kernel."""
    calls = _record(monkeypatch, "ssa_plateau_packed_batched")
    hp = _hp("torus256", SSQAHyperParams)
    anneal_ssqa(PROBLEMS["torus256"][0](gset), hp, seed=1, track_energy=False, device="cpu",
                config=SolverConfig(backend="cuda", noise="xorshift"))
    plateaus = engine.schedule_plateaus(hp.schedule())
    want = [(p.jperp, hp.n_replicas if p.jperp else 0) for p in plateaus] * hp.m_shot
    assert [(c["jperp"], c["n_replicas"]) for c in calls] == want
    assert want[0] == (0, 0)


def test_cuda_k2_ring_mode_per_chain(monkeypatch):
    """Popcount: one chain per iteration, in ring mode with the J⊥ ramp."""
    calls = _record(monkeypatch, "ssa_plateau_popcount_batched")
    hp = _hp("torus256", SSQAHyperParams)
    anneal_ssqa(PROBLEMS["torus256"][0](gset), hp, seed=1, track_energy=False, device="cpu",
                config=SolverConfig(backend="cuda", noise="xorshift", field_mode="popcount"))
    assert len(calls) == hp.m_shot
    jp = hp.schedule().jperp_per_cycle
    for c in calls:
        assert c["n_replicas"] == hp.n_replicas
        np.testing.assert_array_equal(c["jperp_sched"].numpy(), jp)


@pytest.mark.parametrize("noise,noise_mode", [("threefry", "auto"), ("xorshift", "pregen")])
def test_pregen_ssqa_takes_the_cycle_loop(monkeypatch, noise, noise_mode):
    """K4 has no ring mode: on the pregen datapaths only the J⊥ = 0 plateau
    runs K4; the others run the cycle loop over K3.  The answers equal the
    JAX package's (threefry: its pallas pregen path; xorshift pregen: its
    streamed one, which gives the same answers)."""
    k4 = _record(monkeypatch, "ssa_plateau_batched")
    k1 = _record(monkeypatch, "ssa_plateau_packed_batched")
    fields = []
    real = ops.local_field
    monkeypatch.setattr(ops, "local_field", lambda *a: fields.append(1) or real(*a))
    problem = "K-like48"
    hp = _hp(problem, SSQAHyperParams)
    got = anneal_ssqa(PROBLEMS[problem][0](gset), hp, seed=1, track_energy=False, device="cpu",
                      config=SolverConfig(backend="cuda", noise=noise, noise_mode=noise_mode))
    plateaus = engine.schedule_plateaus(hp.schedule())
    coupled = sum(p.length + 1 for p in plateaus if p.jperp and p.eligible)
    coupled += sum(p.length for p in plateaus if p.jperp and not p.eligible)
    assert (len(k4), len(k1)) == (hp.m_shot * sum(not p.jperp for p in plateaus), 0)
    assert len(fields) == hp.m_shot * coupled
    want = _jax_ssqa(problem, "pallas", "dense", "dense", False, noise=noise)
    _assert_same(got, want, False)


# ---------------------------------------------------------------------------
# Validation, as in the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(n_replicas=1), dict(n_trials=10, n_replicas=4),
                                dict(jperp_max=-1)])
def test_hp_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jssqa.SSQAHyperParams(**kw)
    with pytest.raises(ValueError) as got:
        SSQAHyperParams(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_replicas", [1, 3])
def test_backend_rejects_bad_ring_like_jax(n_replicas):
    model = gset.toroidal_grid(16, seed=0).to_ising()
    jmodel = jgset.toroidal_grid(16, seed=0).to_ising()
    with pytest.raises(ValueError) as want:
        jengine.SparseBackend(jmodel, n_trials=8, noise="xorshift", n_replicas=n_replicas)
    for backend in ("sparse", "dense", "cuda"):
        with pytest.raises(ValueError) as got:
            engine.make_backend(backend, model, n_trials=8, noise="xorshift", device="cpu",
                                n_replicas=n_replicas)
        assert str(got.value) == str(want.value)


def test_n_replicas_option_reaches_the_backend_like_jax():
    """``backend_opts`` n_replicas (refused before SSQA was ported) builds a
    ring backend, as the JAX package's SolverConfig does."""
    opts = (("n_replicas", 4),)
    cfg, jcfg = SolverConfig(backend_opts=opts), JSolverConfig(backend_opts=opts)
    assert cfg.engine_opts() == jcfg.engine_opts()
    model = gset.toroidal_grid(16, seed=0).to_ising()
    for backend in ("sparse", "dense", "cuda"):
        bk = engine.make_backend(config=dataclasses.replace(cfg, backend=backend, noise="xorshift"),
                                 model=model, n_trials=8, device="cpu")
        assert bk.n_replicas == 4


def test_wrappers_reject_bad_rings():
    """A ring that does not divide the trials raises in both packages; a
    ring of any size that does (33 here, above the 32 replicas of one word)
    runs, equal to the JAX package's."""
    np_case = _k1_case(1, 8, 40, seed=2)
    with pytest.raises(ValueError, match="not divisible"):
        ssa_update.ssa_plateau_packed_batched(**_torch_case(np_case), i0=4, n_cycles=2,
                                              jperp=1, n_replicas=3)
    with pytest.raises(ValueError, match="not divisible"):
        jssa.ssa_plateau_packed_batched(
            *(jnp.asarray(np_case[k]) for k in K1_ORDER), jnp.int32(4),
            jnp.asarray(np_case["best_H"]), jnp.asarray(np_case["best_m_packed"]),
            n_cycles=2, block_r=3, jperp=1, n_replicas=3)
    big = _k1_case(1, 66, 8, seed=3)
    kw = dict(n_cycles=2, n_rnd=2, eligible=True)
    want = jssa.ssa_plateau_packed_batched(
        *(jnp.asarray(big[k]) for k in K1_ORDER), jnp.int32(4), jnp.asarray(big["best_H"]),
        jnp.asarray(big["best_m_packed"]), block_r=33, jperp=1, n_replicas=33, **kw)
    got = ssa_update.ssa_plateau_packed_batched(**_torch_case(big), i0=4, jperp=1,
                                                n_replicas=33, **kw)
    for name, g, w in zip(OUTS, got, want):
        np.testing.assert_array_equal(*_as_np(g, w), err_msg=name)


# ---------------------------------------------------------------------------
# Autotune and hp='auto'
# ---------------------------------------------------------------------------
def _same_report(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_autotune_g11_gives_table_ii():
    model, jmodel = gset.load("G11").to_ising(), jgset.load("G11").to_ising()
    np.testing.assert_array_equal(autotune.sample_local_fields(model, 16, seed=4),
                                  jautotune.sample_local_fields(jmodel, 16, seed=4))
    for base, jbase in ((ssa.SSAHyperParams(), JHP()),
                        (SSQAHyperParams(), jssqa.SSQAHyperParams())):
        hp, rep = autotune.autotune_hyperparams(model, base)
        jhp, jrep = jautotune.autotune_hyperparams(jmodel, jbase)
        assert repr(hp) == repr(jhp)
        _same_report(rep, jrep)
        assert (hp.n_rnd, hp.i0_min, hp.i0_max, hp.tau) == (2, 1, 32, 100)
    assert (hp.n_replicas, hp.jperp_max) == (8, 4)


def test_autotune_k2000_gives_bench_ssqa_hp():
    """BENCH_ssqa.json's hyper-parameters, resolved as benchmarks/pt_compare.py
    resolves them: 'auto' on K2000 with 16 trials and 2 iterations."""
    bench = json.loads((ROOT / "BENCH_ssqa.json").read_text())
    p = gset.complete_graph(2000, seed=2000, name="K2000")
    budget = dict(n_trials=16, m_shot=2)
    hp_ssa, _ = autotune.resolve_hyperparams("auto", p, base=ssa.SSAHyperParams(**budget))
    hp_ssqa, _ = autotune.resolve_hyperparams("auto", p, base=SSQAHyperParams(**budget),
                                              algo="ssqa")
    assert repr(hp_ssa) == bench["ssa"]["hp"]
    assert repr(hp_ssqa) == bench["ssqa"]["hp"]


def test_autotune_integer_weights_match_jax():
    rs = np.random.default_rng(11)
    n = 60
    edges = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n)
                        if rs.random() < 0.2], np.int32)
    w = rs.integers(-9, 10, len(edges)).astype(np.int32)
    h = rs.integers(-4, 5, n).astype(np.int32)
    model = IsingModel.from_edges(n, edges, w, h=h)
    jmodel = JIsingModel.from_edges(n, edges, w, h=h)
    for base, jbase in ((ssa.SSAHyperParams(tau=40), JHP(tau=40)),
                        (SSQAHyperParams(n_trials=24), jssqa.SSQAHyperParams(n_trials=24))):
        for seed in (0, 5):
            hp, rep = autotune.autotune_hyperparams(model, base, n_samples=32, seed=seed)
            jhp, jrep = jautotune.autotune_hyperparams(jmodel, jbase, n_samples=32, seed=seed)
            assert repr(hp) == repr(jhp)
            _same_report(rep, jrep)
    assert hp.i0_max > 32 and hp.n_rnd > 2  # the integer weights moved the knobs
    assert repr(autotune.resolve_hyperparams(base, model)) == repr((base, None))
    with pytest.raises(ValueError, match="unknown hyperparameter mode"):
        autotune.resolve_hyperparams("fast", model)


@pytest.mark.parametrize("algo", ["ssa", "ssqa"])
def test_hp_auto_through_anneal_matches_jax(algo):
    p, jp = gset.toroidal_grid(64, seed=2), jgset.toroidal_grid(64, seed=2)
    cfg = dict(backend="sparse", noise="xorshift")
    if algo == "ssa":
        got = ssa.anneal(p, "auto", seed=2, device="cpu", config=SolverConfig(**cfg),
                         auto_base=ssa.SSAHyperParams(n_trials=4, m_shot=1, tau=4))
        want = janneal(jp, "auto", seed=2, config=JSolverConfig(**cfg),
                       auto_base=JHP(n_trials=4, m_shot=1, tau=4))
    else:
        got = repro_torch.anneal_ssqa(
            p, "auto", seed=2, device="cpu", config=SolverConfig(**cfg),
            auto_base=SSQAHyperParams(n_trials=4, n_replicas=2, m_shot=1, tau=4))
        want = jssqa.anneal_ssqa(
            jp, "auto", seed=2, config=JSolverConfig(**cfg),
            auto_base=jssqa.SSQAHyperParams(n_trials=4, n_replicas=2, m_shot=1, tau=4))
    assert repr(got.hp) == repr(want.hp)
    _assert_same(got, want, True)


def test_anneal_ssqa_rejects_classical_hp():
    with pytest.raises(TypeError, match="SSQAHyperParams"):
        anneal_ssqa(gset.toroidal_grid(16, seed=0), ssa.SSAHyperParams(n_trials=2),
                    device="cpu")


def test_launcher_algo_ssqa_matches_jax(capsys):
    from repro_torch.launch import anneal as launcher

    launcher.main(["--problem", "G11", "--algo", "ssqa", "--trials", "8", "--replicas", "4",
                   "--jperp-max", "3", "--m-shot", "1", "--tau", "4", "--i0-max", "8",
                   "--backend", "cuda", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(SSQA); R=4 jperp_max=3" in out
    want = jssqa.anneal_ssqa(
        jgset.load("G11"), jssqa.SSQAHyperParams(n_trials=8, n_replicas=4, jperp_max=3,
                                                 m_shot=1, tau=4, i0_max=8),
        seed=0, config=JSolverConfig(backend="dense", noise="xorshift"))
    assert f"best cut {want.overall_best_cut} " in out
