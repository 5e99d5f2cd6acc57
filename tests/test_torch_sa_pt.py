"""The port's SA, PT and PT-SSA baselines against the JAX package's, on the
CPU.

Mirrors ``tests/test_core_baselines.py`` (with
``test_hassa_converges_faster_than_sa``) and the SA/PT-SSA parts of the
service tests.  The tolerance is bit-identity: the port draws
``jax.random``'s numbers (``split``, ``uniform``, ``randint``,
``bernoulli``; held here against jax itself) and takes XLA's float32
logarithm (``xla_log``, held exhaustively over every value of
``uniform(minval=1e-12)``), so every Metropolis and swap decision, and
hence every best energy, spin and trace, equals the JAX package's.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.pt as jpt  # noqa: E402
import repro.core.sa as jsa  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core.rng import Xorshift128 as JXorshift  # noqa: E402
from repro.core.schedule import sa_temperature_ladder as jladder  # noqa: E402
from repro.ft.faults import FaultInjector as JInjector  # noqa: E402
from repro.problems import make_demo as jdemo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gset  # noqa: E402
from repro_torch.core import pt as tpt  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core import sa as tsa  # noqa: E402
from repro_torch.core.engine import pad_model  # noqa: E402
from repro_torch.core.ising import fig4_example  # noqa: E402
from repro_torch.core.schedule import sa_temperature_ladder  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams, anneal  # noqa: E402
from repro_torch.core.xla_math import xla_log  # noqa: E402
from repro_torch.ft.faults import FaultInjector, InjectedKill  # noqa: E402
from repro_torch.problems import make_demo  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    AnnealRequest,
    AnnealService,
    ResiliencePolicy,
)

SEEDS = (0, 7, 123456, 2**31 - 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run cycle loops of tiny tensors: one intra-op thread is
    faster for them and keeps six test workers from oversubscribing the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _np(k):
    return np.asarray(k).astype(np.int64)


# ---------------------------------------------------------------------------
# jax.random, as jax 0.9 draws it with partitionable threefry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split_equal_jax(seed):
    assert rng.PRNGKey(seed) == tuple(int(x) for x in _np(_jkey(seed)))
    for num in (2, 3, 5, 101):
        want = _np(jax.random.split(_jkey(seed), num))
        np.testing.assert_array_equal(np.asarray(rng.split(rng.PRNGKey(seed), num)), want)
        jkeys = jax.random.split(_jkey(seed), 4)
        want = _np(jax.vmap(lambda k: jax.random.split(k, num))(jkeys))
        np.testing.assert_array_equal(rng.split_keys(_np(jkeys), num), want)
        np.testing.assert_array_equal(rng.split_keys(torch.from_numpy(_np(jkeys)), num).numpy(),
                                      want)


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (2, 3, 4)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_equal_jax(seed, shape):
    k, tk = _jkey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(rng.random_bits(tk, shape).numpy(),
                                  _np(jax.random.bits(k, shape)))
    for lo, hi in ((0.0, 1.0), (1e-12, 1.0), (-3.0, 5.0)):
        got = rng.uniform(tk, shape, minval=lo, maxval=hi).numpy()
        want = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for p in (0.5, 0.3):
        np.testing.assert_array_equal(rng.bernoulli(tk, p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(k, p, shape)))


@pytest.mark.parametrize("maxval", [1, 2, 7, 100, 2000, 65536, 65537, 2**31 - 1])
def test_randint_equals_jax(maxval):
    for seed in SEEDS:
        got = rng.randint(rng.PRNGKey(seed), (64,), 0, maxval).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jax.random.randint(_jkey(seed), (64,), 0, maxval)))
    got = rng.randint(rng.PRNGKey(3), (8,), 5, 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.randint(_jkey(3), (8,), 5, 5)))


def test_randint_batched_keys_and_per_problem_maxval():
    """The service's draw: one key and one live spin count per problem."""
    keys = jax.random.split(_jkey(11), 5)
    nl = np.asarray([5, 64, 1, 800, 33])
    want = jax.vmap(lambda k, m: jax.random.randint(k, (9,), 0, m))(keys, jnp.asarray(nl))
    got = rng.randint(_np(keys), (9,), 0, torch.from_numpy(nl)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_xorshift128_class_equals_jax():
    got, want = rng.Xorshift128(5, (3, 7), device="cpu"), JXorshift(5, (3, 7))
    for _ in range(4):
        np.testing.assert_array_equal(got.next_bits().numpy(), np.asarray(want.next_bits()))
    np.testing.assert_array_equal(got.state.numpy().view(np.uint32), np.asarray(want.state))


def test_xla_log_exhaustive_over_uniform_values():
    """Every value uniform(minval=1e-12) can take: 2^23 float32s.  0 of them
    may differ from jnp.log (torch.log differs on some)."""
    k = np.arange(1 << 23, dtype=np.int32)
    f = (k | 0x3F800000).view(np.float32) - np.float32(1.0)
    u = np.maximum(np.float32(1e-12), f + np.float32(1e-12)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(u)).view(np.int32)
    got = xla_log(torch.from_numpy(u)).numpy().view(np.int32)
    assert int((got != want).sum()) == 0
    assert int((torch.log(torch.from_numpy(u)).numpy().view(np.int32) != want).sum()) > 0


def test_xla_log_on_random_floats():
    u = np.random.default_rng(0).uniform(1e-6, 100.0, 200_000).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(u)).view(np.int32)
    np.testing.assert_array_equal(xla_log(torch.from_numpy(u)).numpy().view(np.int32), want)


@pytest.mark.parametrize("args", [(10.0, 1e-7, 90_000), (10.0, 1e-7, 1), (1.0, 0.5, 7)])
def test_sa_temperature_ladder_equals_jax(args):
    np.testing.assert_array_equal(sa_temperature_ladder(*args), jladder(*args))


# ---------------------------------------------------------------------------
# SA
# ---------------------------------------------------------------------------
def _pair(make):
    return make(gset), make(jgset)


PROBLEMS = {
    "torus": lambda g: g.toroidal_grid(64, seed=1),
    "complete": lambda g: g.complete_graph(40, seed=2),
    "fig4": lambda g: (fig4_example() if g is gset else __import__(
        "repro.core.ising", fromlist=["x"]).fig4_example()),
}


def _assert_result(got, want):
    np.testing.assert_array_equal(got.best_energy, np.asarray(want.best_energy))
    np.testing.assert_array_equal(got.best_m, np.asarray(want.best_m))
    np.testing.assert_array_equal(got.best_cut, np.asarray(want.best_cut))


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_anneal_sa_equals_jax(name, track):
    t, j = _pair(PROBLEMS[name])
    got = tsa.anneal_sa(t, tsa.SAHyperParams(n_trials=5, n_cycles=1500), seed=3,
                        track_energy=track, device="cpu")
    want = jsa.anneal_sa(j, jsa.SAHyperParams(n_trials=5, n_cycles=1500), seed=3,
                         track_energy=track)
    _assert_result(got, want)
    if track:
        np.testing.assert_array_equal(got.energy_mean.view(np.int32),
                                      np.asarray(want.energy_mean).view(np.int32))
        np.testing.assert_array_equal(got.energy_min, np.asarray(want.energy_min))
    else:
        assert got.energy_mean is None and got.energy_min is None


@pytest.mark.parametrize("kind", ["qubo", "mis", "coloring", "partition"])
def test_anneal_sa_on_encodings_equals_jax(kind):
    """h ≠ 0 and multi-bit weights (the // 2 of the energy in int32)."""
    got = tsa.anneal_sa(make_demo(kind, seed=1), tsa.SAHyperParams(n_trials=4, n_cycles=800),
                        seed=2, device="cpu")
    want = jsa.anneal_sa(jdemo(kind, seed=1), jsa.SAHyperParams(n_trials=4, n_cycles=800),
                         seed=2)
    _assert_result(got, want)
    np.testing.assert_array_equal(got.energy_min, np.asarray(want.energy_min))


def test_anneal_sa_custom_temperatures_equals_jax():
    temps = np.tile(np.repeat(1.0 / np.array([1, 2, 4, 8], np.float32), 50), 3)
    t, j = _pair(PROBLEMS["torus"])
    got = tsa.anneal_sa(t, tsa.SAHyperParams(n_trials=3, n_cycles=600), seed=1,
                        temperatures=temps, device="cpu")
    want = jsa.anneal_sa(j, jsa.SAHyperParams(n_trials=3, n_cycles=600), seed=1,
                         temperatures=temps)
    _assert_result(got, want)


def test_sa_cycles_chunked_with_n_live_equals_unchunked_and_jax():
    """A bucket-padded model, proposals restricted to its live spins: three
    chunks of the ladder equal one pass, and the JAX package's sa_cycles."""
    t, j = _pair(PROBLEMS["torus"])
    tm = pad_model(t.to_ising(), 128)
    jm = __import__("repro.core.engine", fromlist=["x"]).pad_model(j.to_ising(), 128)
    temps = sa_temperature_ladder(10.0, 1e-3, 900)
    h, idx, w = tm.device_arrays("cpu")
    carry = tsa.sa_init(h, idx, w, rng.PRNGKey(9), n_trials=4)
    one, tr1 = tsa.sa_cycles(h, idx, w, carry, temps, n_live=t.n, track_energy=True)
    ch = carry
    for c in range(3):
        ch, _ = tsa.sa_cycles(h, idx, w, ch, temps[c * 300:(c + 1) * 300], n_live=t.n)
    jh, ji, jw = jm.device_arrays()
    jc = jsa.sa_init(jh, ji, jw, _jkey(9), n_trials=4)
    jone, jtr = jax.jit(lambda c: jsa.sa_cycles(jh, ji, jw, c, jnp.asarray(temps), n_live=t.n,
                                                track_energy=True))(jc)
    for a, b, want in zip(one[1:], ch[1:], jone[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    assert one[0] == ch[0] == tuple(int(x) for x in _np(jone[0]))
    np.testing.assert_array_equal(tr1[1].numpy(), np.asarray(jtr[1]))
    assert not one[1][:, t.n:].ne(carry[1][:, t.n:]).any()  # padded spins never flip


def test_sa_carry_converter_starts_both_packages_from_one_state():
    t, j = _pair(PROBLEMS["complete"])
    rs = np.random.default_rng(4)
    m = np.where(rs.random((3, t.n)) < 0.5, 1, -1).astype(np.int32)
    jh, ji, jw = j.to_ising().device_arrays()
    H = np.asarray(jsa._sa_energy(jh, ji, jw, jnp.asarray(m)))
    key = np.asarray([17, 4242], np.uint32)
    temps = sa_temperature_ladder(5.0, 0.1, 200)
    carry = convert.sa_carry_from_arrays(key, m, H, H, m)
    h, idx, w = t.to_ising().device_arrays("cpu")
    got, _ = tsa.sa_cycles(h, idx, w, carry, temps)
    want, _ = jsa.sa_cycles(jh, ji, jw, (jnp.asarray(key), jnp.asarray(m), jnp.asarray(H),
                                         jnp.asarray(H), jnp.asarray(m)), jnp.asarray(temps))
    for a, b in zip(convert.sa_carry_to_arrays(got), want):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# PT and PT-SSA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("name", ["torus", "complete"])
def test_anneal_pt_equals_jax(name, track):
    t, j = _pair(PROBLEMS[name])
    hp = dict(n_replicas=6, n_cycles=1200, swap_interval=40)
    got = tpt.anneal_pt(t, tpt.PTHyperParams(**hp), seed=3, track_energy=track, device="cpu")
    want = jpt.anneal_pt(j, jpt.PTHyperParams(**hp), seed=3, track_energy=track)
    assert got.best_energy == want.best_energy and got.best_cut == want.best_cut
    np.testing.assert_array_equal(got.best_m, np.asarray(want.best_m))
    if track:
        np.testing.assert_array_equal(got.energy_min, np.asarray(want.energy_min))


@pytest.mark.parametrize("noise", ["xorshift", "threefry"])
@pytest.mark.parametrize("backend", ["sparse", "dense"])
def test_anneal_pt_ssa_equals_jax(backend, noise):
    t, j = _pair(PROBLEMS["torus"])
    hp = dict(n_replicas=6, n_rounds=7, tau=20)
    got = tpt.anneal_pt_ssa(t, tpt.PTSSAHyperParams(**hp), seed=5, backend=backend,
                            noise=noise, device="cpu")
    want = jpt.anneal_pt_ssa(j, jpt.PTSSAHyperParams(**hp), seed=5, backend=backend,
                             noise=noise)
    _assert_result(got, want)


@pytest.mark.parametrize("backend", ["sparse", "dense"])
def test_pt_ssa_rounds_equals_jax_on_an_encoding(backend):
    """pt_ssa_rounds itself, on a model with h ≠ 0 and 5-bit weights, and
    the PT-SSA hyper-parameters' ladder."""
    from repro.core.engine import make_backend as jmake
    from repro_torch.core.engine import make_backend as tmake

    hp_kw = dict(n_replicas=5, n_rounds=4, tau=15, i0_max=64, beta_scale=0.1)
    thp, jhp = tpt.PTSSAHyperParams(**hp_kw), jpt.PTSSAHyperParams(**hp_kw)
    np.testing.assert_array_equal(thp.ladder(), jhp.ladder())
    assert thp.total_cycles == jhp.total_cycles
    tm, jm = make_demo("qubo", seed=2).model, jdemo("qubo", seed=2).model
    tb = tmake(backend, tm, n_trials=5, noise="xorshift", device="cpu")
    jb = jmake(backend, jm, n_trials=5, noise="xorshift")
    keys = rng.split(rng.PRNGKey(77), 4)
    par = np.arange(4) % 2
    st = tpt.pt_ssa_rounds(tb._field, tb._noise_step, tb.h, thp, tb.init_state(1), keys, par)
    js = jax.jit(lambda s: jpt.pt_ssa_rounds(jb._field, jb._noise_step,
                                             jnp.asarray(jm.h, jnp.int32), jhp, s,
                                             jnp.asarray(np.asarray(keys, np.uint32)),
                                             jnp.asarray(par, jnp.int32)))(jb.init_state(1))
    np.testing.assert_array_equal(st.m.numpy(), np.asarray(js.m))
    np.testing.assert_array_equal(st.itanh.numpy(), np.asarray(js.itanh))
    np.testing.assert_array_equal(st.best_H.numpy(), np.asarray(js.best_H))


def test_pt_ssa_rejects_cuda():
    with pytest.raises(ValueError, match="per-replica I0"):
        tpt.anneal_pt_ssa(gset.toroidal_grid(16, seed=0), backend="cuda", device="cpu")


def test_pt_swap_perm_exchanges_pairs():
    def ref(do_swap, R):
        perm = list(range(R))
        for k, s in enumerate(do_swap):
            if s:
                perm[k], perm[k + 1] = perm[k + 1], perm[k]
        return perm

    R = 6
    for bits in range(1 << (R - 1)):
        do_swap = [(bits >> k) & 1 == 1 for k in range(R - 1)]
        if any(do_swap[k] and do_swap[k + 1] for k in range(R - 2)):
            continue
        got = tpt._swap_perm(torch.tensor(do_swap), R).tolist()
        assert got == ref(do_swap, R) == list(np.asarray(jpt._swap_perm(jnp.asarray(do_swap),
                                                                         R)))


# ---------------------------------------------------------------------------
# The baselines' claims (test_core_baselines.py)
# ---------------------------------------------------------------------------
def test_sa_and_pt_solve_fig4():
    p = fig4_example()
    assert tsa.anneal_sa(p, tsa.SAHyperParams(n_trials=8, n_cycles=2000), seed=0,
                         device="cpu").overall_best_cut == 3
    assert tpt.anneal_pt(p, tpt.PTHyperParams(n_replicas=4, n_cycles=2000, swap_interval=50),
                         seed=0, device="cpu").best_cut == 3


def test_sa_energy_decreases_and_best_tracks_min():
    r = tsa.anneal_sa(gset.load("G11"), tsa.SAHyperParams(n_trials=4, n_cycles=5000), seed=1,
                      device="cpu")
    assert r.energy_mean.shape == (5000,)
    assert r.energy_mean[-100:].mean() < r.energy_mean[:100].mean()
    r = tsa.anneal_sa(gset.toroidal_grid(64, seed=2), tsa.SAHyperParams(n_trials=4,
                                                                        n_cycles=3000),
                      seed=3, device="cpu")
    assert r.best_energy.min() <= r.energy_min.min()


def test_hassa_converges_faster_than_sa():
    """Sec. V-A: at an equal budget of 6000 cycles HA-SSA reaches a much
    better cut than SA (the reference's test, on the port)."""
    g = gset.load("G11")
    r_ha = anneal(g, SSAHyperParams(n_trials=8, m_shot=10), seed=0, track_energy=False,
                  device="cpu")
    r_sa = tsa.anneal_sa(g, tsa.SAHyperParams(n_trials=8, n_cycles=6000), seed=0,
                         track_energy=False, device="cpu")
    assert r_ha.mean_best_cut > r_sa.mean_best_cut + 20
    assert r_ha.overall_best_cut > r_sa.overall_best_cut


def test_pt_beats_plain_sa_on_quality_budget():
    g = gset.load("G11")
    r_pt = tpt.anneal_pt(g, tpt.PTHyperParams(n_replicas=8, n_cycles=8000), seed=0,
                         device="cpu")
    r_sa = tsa.anneal_sa(g, tsa.SAHyperParams(n_trials=8, n_cycles=8000), seed=0,
                         device="cpu", track_energy=False)
    assert r_pt.best_cut >= r_sa.overall_best_cut - 20


def test_fig12_equal_temperature_control():
    g = gset.load("G11")
    r_ha = anneal(g, SSAHyperParams(n_trials=4, m_shot=5), seed=0, total_cycles=3000,
                  device="cpu")
    temps = np.tile(np.repeat(1.0 / np.array([1, 2, 4, 8, 16, 32], np.float32), 100), 5)
    r_sa = tsa.anneal_sa(g, tsa.SAHyperParams(n_trials=4, n_cycles=3000), seed=0,
                         temperatures=temps, device="cpu")
    assert r_ha.mean_best_cut > r_sa.mean_best_cut


# ---------------------------------------------------------------------------
# The service's SA and PT-SSA groups
# ---------------------------------------------------------------------------
def _svc_requests(Req, g, sa, pt, seeds=(0, 1, 2)):
    out = []
    for s in seeds:
        p = g.toroidal_grid(36 + 28 * (s % 2), seed=s, name=f"t{s}")
        out.append(Req(problem=p, hp=sa.SAHyperParams(n_trials=3, n_cycles=400), seed=s))
        out.append(Req(problem=p, hp=pt.PTSSAHyperParams(n_replicas=4, n_rounds=4, tau=10),
                       seed=s))
    return out


def _assert_response(got, want):
    _assert_result(got.result, want.result)
    np.testing.assert_array_equal(got.chunk_best_cut, np.asarray(want.chunk_best_cut))
    assert (got.status, got.chunks_run, got.chunks_total, got.bucket, got.batch) == (
        want.status, want.chunks_run, want.chunks_total, want.bucket, want.batch)
    assert [e.kind for e in got.events] == [e.kind for e in want.events]


@pytest.mark.parametrize("noise", ["xorshift", "threefry"])
@pytest.mark.parametrize("backend", ["sparse", "dense"])
def test_service_sa_and_ptssa_groups_equal_jax(backend, noise):
    got = AnnealService(backend=backend, noise=noise, chunk_shots=2, min_bucket=16,
                        device="cpu").solve(_svc_requests(AnnealRequest, gset, tsa, tpt))
    want = jserve.AnnealService(backend=backend, noise=noise, chunk_shots=2,
                                min_bucket=16).solve(_svc_requests(jserve.AnnealRequest,
                                                                   jgset, jsa, jpt))
    for g, w in zip(got, want):
        _assert_response(g, w)
        assert type(g.result).__name__ == type(w.result).__name__


def test_service_sa_and_ptssa_equal_single_problem_drivers():
    """At N = bucket (the SA start is drawn over the padded width, as in the
    JAX package, so only there it equals anneal_sa's) both families equal
    their single-problem drivers."""
    p = gset.toroidal_grid(64, seed=4)
    reqs = [AnnealRequest(problem=p, hp=tsa.SAHyperParams(n_trials=3, n_cycles=400), seed=4),
            AnnealRequest(problem=p, hp=tpt.PTSSAHyperParams(n_replicas=4, n_rounds=4, tau=10),
                          seed=4)]
    sa_r, pt_r = AnnealService(backend="dense", min_bucket=16, device="cpu").solve(reqs)
    _assert_result(sa_r.result, tsa.anneal_sa(p, reqs[0].hp, seed=4, track_energy=False,
                                              device="cpu"))
    _assert_result(pt_r.result, tpt.anneal_pt_ssa(p, reqs[1].hp, seed=4, backend="dense",
                                                  device="cpu"))


def test_service_sa_target_cut_stops_early_as_jax():
    out = []
    for Svc, Req, g, sa in ((AnnealService, AnnealRequest, gset, tsa),
                            (jserve.AnnealService, jserve.AnnealRequest, jgset, jsa)):
        kw = dict(device="cpu") if Svc is AnnealService else {}
        reqs = [Req(problem=g.toroidal_grid(36, seed=s), seed=s, target_cut=30 + 6 * s,
                    hp=sa.SAHyperParams(n_trials=3, n_cycles=800)) for s in range(3)]
        out.append(Svc(backend="sparse", min_bucket=16, **kw).solve(reqs))
    for g, w in zip(*out):
        _assert_response(g, w)
    assert any(r.chunks_run < r.chunks_total for r in out[0])


@pytest.mark.parametrize("killed", ["sa", "ptssa"])
@pytest.mark.parametrize("noise", ["xorshift", "threefry"])
def test_service_sa_and_ptssa_kill_resume_equal_jax(noise, killed, tmp_path):
    """One group killed after its chunk 1, then the batch solved again with
    the same checkpoint root: PT-SSA resumes from its checkpoint; an SA
    carry has no xorshift lanes, so under xorshift the reference rejects
    its checkpoint and reruns the group, and the port does the same.
    Results and events equal the JAX package's, and the uninterrupted
    solve's."""
    out = {}
    for name in ("port", "jax"):
        port = name == "port"
        Svc, Req, g, sa, pt, Inj, Pol = (
            (AnnealService, AnnealRequest, gset, tsa, tpt, FaultInjector, ResiliencePolicy)
            if port else (jserve.AnnealService, jserve.AnnealRequest, jgset, jsa, jpt,
                          JInjector, jserve.ResiliencePolicy))
        kw = dict(device="cpu") if port else {}
        d = str(tmp_path / name)
        inj = Inj()
        inj.arm("kill", chunk=1, kind=killed)
        reqs = _svc_requests(Req, g, sa, pt, seeds=(0, 1))
        with pytest.raises(Exception, match="injected process kill"):
            Svc(backend="sparse", noise=noise, min_bucket=16, resilience=Pol(checkpoint_dir=d),
                faults=inj, **kw).solve(reqs)
        assert os.listdir(d)
        out[name] = (Svc(backend="sparse", noise=noise, min_bucket=16,
                         resilience=Pol(checkpoint_dir=d), **kw).solve(reqs),
                     Svc(backend="sparse", noise=noise, min_bucket=16, **kw).solve(reqs))
        assert os.listdir(d) == []
    (got, base), (want, _) = out["port"], out["jax"]
    for g_, w, b in zip(got, want, base):
        _assert_response(g_, w)
        _assert_result(g_.result, b.result)
        assert [(e.kind, e.detail.get("chunk")) for e in g_.events] == \
               [(e.kind, e.detail.get("chunk")) for e in w.events]
    kinds = {type(r.result).__name__: [e.kind for e in r.events] for r in got}
    if killed == "ptssa":
        assert kinds == {"PTSSAResult": ["resume"], "SAResult": []}
    else:
        sa_ev = ["checkpoint_rejected"] if noise == "xorshift" else ["resume"]
        assert kinds == {"PTSSAResult": [], "SAResult": sa_ev}


def test_service_ptssa_rejected_on_cuda():
    reqs = [AnnealRequest(problem=gset.toroidal_grid(36, seed=0),
                          hp=tpt.PTSSAHyperParams(n_replicas=2, n_rounds=2, tau=4))]
    with pytest.raises(AdmissionError, match="per-replica I0"):
        AnnealService(backend="cuda", device="cpu").solve(reqs)
    from repro_torch.core.config import SolverConfig

    cfg_req = [dataclasses.replace(reqs[0], config=SolverConfig(backend="cuda"))]
    with pytest.raises(ValueError, match="per-replica I0"):
        AnnealService(backend="sparse", device="cpu").solve(cfg_req)


def test_service_sa_group_on_cuda_service_runs_no_fallback():
    """An SA group on a cuda service runs the Metropolis core (no kernel)
    and its faults do not walk the fallback chain."""
    svc = AnnealService(backend="cuda", min_bucket=16, device="cpu")
    req = AnnealRequest(problem=gset.toroidal_grid(36, seed=0),
                        hp=tsa.SAHyperParams(n_trials=2, n_cycles=80), seed=0)
    (r,) = svc.solve([req])
    assert r.status == "ok" and not r.events
    inj = FaultInjector()
    inj.arm("compile")
    svc = AnnealService(backend="cuda", min_bucket=16, device="cpu", faults=inj)
    with pytest.raises(Exception, match="compile"):
        svc.solve([req])
    assert svc.stats["fallback_compile"] == 0


def test_registry_has_the_four_families():
    from repro_torch.serve.registry import family_for, registered_algos

    assert sorted(registered_algos()) == ["ptssa", "sa", "ssa", "ssqa"]
    assert family_for(tsa.SAHyperParams()).name == "sa"
    assert family_for(tpt.PTSSAHyperParams(), algo="ptssa").name == "ptssa"
    with pytest.raises(AdmissionError, match="does not match"):
        family_for(tsa.SAHyperParams(), algo="ptssa")


def test_kill_escapes_as_injected_kill(tmp_path):
    inj = FaultInjector()
    inj.arm("kill", chunk=0)
    req = AnnealRequest(problem=gset.toroidal_grid(36, seed=0),
                        hp=tsa.SAHyperParams(n_trials=2, n_cycles=80), seed=0)
    with pytest.raises(InjectedKill):
        AnnealService(backend="sparse", min_bucket=16, device="cpu", faults=inj,
                      resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path))).solve([req])


@pytest.mark.parametrize("n_trials", [5, 7, 100])
def test_engine_energy_mean_bit_identical(n_trials):
    """The SSA engine's per-cycle mean energy takes jnp.mean's float32 as
    XLA computes it (the sum times 1/T), so the traces are bit-identical
    too, as SA's are."""
    hp = dict(n_trials=n_trials, m_shot=2, tau=10)
    got = anneal(gset.toroidal_grid(64, seed=1), SSAHyperParams(**hp), seed=1, device="cpu")
    want = janneal(jgset.toroidal_grid(64, seed=1),
                   __import__("repro.core", fromlist=["x"]).SSAHyperParams(**hp), seed=1)
    np.testing.assert_array_equal(got.energy_mean.view(np.int32),
                                  np.asarray(want.energy_mean).view(np.int32))
    np.testing.assert_array_equal(got.energy_min, np.asarray(want.energy_min))
