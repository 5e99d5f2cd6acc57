"""The port's problem frontend against the JAX package's, on the CPU.

Mirrors ``tests/test_problem_frontend.py``, ``tests/test_problems.py`` and
``tests/test_placement.py``.  The tolerance is bit-identity: every family's
encoding (model arrays, offset, instance data), decode, verify, objective
and ``best_feasible`` equal the JAX package's on the same instance, and an
encoded problem annealed through the port — ``anneal()``, the service on
every port backend, the stream, the launcher's ``--problem-kind`` — gives
the JAX package's spins, energies and decoded solution.  The JAX package's
own round trip is infeasible at ``coloring, seed=1`` (ROADMAP.md queue 3):
there the port is held to the reference's output, not to feasibility.
"""
import itertools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.ising as jising  # noqa: E402
import repro.core.placement as jplace  # noqa: E402
import repro.core.problems as jprob  # noqa: E402
import repro.problems as jpb  # noqa: E402
import repro_torch.core.ising as tising  # noqa: E402
import repro_torch.core.placement as tplace  # noqa: E402
import repro_torch.core.problems as tprob  # noqa: E402
import repro_torch.problems as tpb  # noqa: E402
from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.serve import AnnealRequest as JRequest  # noqa: E402
from repro.serve import AnnealService as JService  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams, anneal  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AnnealRequest,
    AnnealService,
    StreamingAnnealService,
    StreamPolicy,
)

KINDS = sorted(tpb.FAMILIES)
SMOKE = dict(n_trials=8, m_shot=3)
SEEDS = (0, 1, 2)
# (port backend, JAX backend)
BACKENDS = [("sparse", "sparse"), ("dense", "dense"), ("cuda", "pallas")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run cycle loops of tiny tensors: one intra-op thread is
    faster for them and keeps six test workers from oversubscribing the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_equal(a, b):
    assert a.n == b.n and a.name == b.name
    for f in ("h", "nbr_idx", "nbr_w"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _fields(enc):
    """The dataclass fields of an encoding besides its model."""
    import dataclasses

    return {f.name: getattr(enc, f.name) for f in dataclasses.fields(enc) if f.name != "model"}


def _enc_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    _model_equal(got.model, want.model)
    gf, wf = _fields(got), _fields(want)
    assert gf.keys() == wf.keys()
    for k in gf:
        np.testing.assert_array_equal(np.asarray(gf[k]), np.asarray(wf[k]))


def _sol_equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _spins(seed, t, n):
    return np.where(np.random.default_rng(seed).random((t, n)) < 0.5, 1, -1).astype(np.int8)


def _all_energies(model, n):
    bits = np.arange(2**n, dtype=np.int64)
    m = (2 * ((bits[:, None] >> np.arange(n)) & 1) - 1).astype(np.int32)
    h, idx, w = model.device_arrays("cpu")
    return tising.ising_energy(torch.from_numpy(m), h, idx, w).numpy(), m


# ---------------------------------------------------------------------------
# Encodings, decode, verify, objective: equal to the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_make_demo_equals_jax(kind, seed):
    _enc_equal(tpb.make_demo(kind, seed=seed), jpb.make_demo(kind, seed=seed))


@pytest.mark.parametrize("kind,n", [("qubo", 2000), ("mis", 2000), ("coloring", 2100),
                                    ("partition", 2000)])
def test_make_demo_at_k2000_scale_equals_jax(kind, n):
    """The chip run's widths: 2000 spins (coloring: 700 vertices × 3
    colours); h ≠ 0 and multi-bit weights throughout."""
    got, want = tpb.make_demo(kind, n=n, seed=0), jpb.make_demo(kind, n=n, seed=0)
    _enc_equal(got, want)
    assert got.model.n == (2100 if kind == "coloring" else 2000)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_verify_objective_equal_jax(kind):
    t, j = tpb.make_demo(kind, seed=3), jpb.make_demo(kind, seed=3)
    ms = _spins(7, 16, t.model.n)
    for m in ms:
        ts, js = t.decode(m), j.decode(m)
        _sol_equal(ts, js)
        assert t.verify(ts) == j.verify(js)
        if t.verify(ts):
            assert t.objective(ts) == j.objective(js) and t.score(ts) == j.score(js)
    (ts, to, tf), (js, jo, jf) = t.best_feasible(ms), j.best_feasible(ms)
    _sol_equal(ts, js)
    assert (to, tf) == (jo, jf)
    np.testing.assert_array_equal(tpb.spins_to_bits(ms), jpb.spins_to_bits(ms))


@pytest.mark.parametrize("kind", KINDS)
def test_encoding_from_fields_round_trip(kind):
    """convert.encoding_from_fields rebuilds the port's encoding from the
    JAX package's numpy fields."""
    j = jpb.make_demo(kind, seed=4)
    m = j.model
    got = convert.encoding_from_fields(
        dict(n=m.n, h=m.h, nbr_idx=m.nbr_idx, nbr_w=m.nbr_w, name=m.name), **_fields(j))
    _enc_equal(got, j)
    _enc_equal(got, tpb.make_demo(kind, seed=4))


def test_qubo_energy_identity():
    enc = tpb.qubo_problem(np.random.default_rng(0).integers(-4, 5, size=(8, 8)))
    H, ms = _all_energies(enc.model, 8)
    for e, m in zip(H, ms):
        assert 4 * enc.objective(enc.decode(m)) == int(e) + enc.offset


def test_mis_energy_identity_and_optimum():
    edges = np.array([(v, (v + 1) % 5) for v in range(5)])
    enc = tpb.mis_problem(5, edges, penalty=2)
    H, ms = _all_energies(enc.model, 5)
    for e, m in zip(H, ms):
        sel = (m > 0).astype(np.int64)
        conflicts = int((sel[edges[:, 0]] & sel[edges[:, 1]]).sum())
        assert 4 * (enc.penalty * conflicts - int(sel.sum())) == int(e) + enc.offset
    best = enc.decode(ms[int(H.argmin())])
    assert enc.verify(best) and enc.objective(best) == 2


def test_coloring_energy_identity_and_ground_state_is_proper():
    enc = tpb.ring_coloring(4, 2)
    H, ms = _all_energies(enc.model, 8)
    for e, m in zip(H, ms):
        x = (m.reshape(4, 2) > 0).astype(np.int64)
        violations = int(((x.sum(axis=1) - 1) ** 2).sum())
        same = sum(int((x[u] * x[v]).sum()) for u, v in enc.edges)
        assert 4 * (3 * violations + same) == int(e) + enc.offset
    best = enc.decode(ms[int(H.argmin())])
    assert enc.verify(best) and enc.objective(best) == 0


def test_partition_energy_identity():
    enc = tpb.partition_problem([3, 1, 4, 1, 5, 9, 2, 6])
    H, ms = _all_energies(enc.model, 8)
    for e, m in zip(H, ms):
        assert enc.objective(enc.decode(m)) ** 2 == int(e) + enc.offset


def test_mis_decode_repairs_to_independence():
    enc = tpb.mis_problem(6, np.array([(v, (v + 1) % 6) for v in range(6)]))
    sel = enc.decode(np.ones(6, dtype=np.int8))
    assert enc.verify(sel) and not enc.verify(np.ones(6, dtype=bool))
    np.testing.assert_array_equal(sel, enc.decode(np.ones(6, dtype=np.int8)))


def test_coloring_decode_is_total_and_repairs():
    enc = tpb.ring_coloring(6, 3)
    colors = enc.decode(-np.ones(18, dtype=np.int8))
    assert colors.shape == (6,) and enc.verify(colors)
    bad = np.zeros(6, dtype=np.int64)
    assert not enc.verify(bad) and enc.objective(bad) == 6


def test_best_feasible_picks_best_and_qubo_shape_guard():
    enc = tpb.partition_problem([2, 2, 4])
    sol, obj, feas = enc.best_feasible(np.array([[1, 1, 1], [1, 1, -1]], dtype=np.int8))
    assert feas and obj == 0 and np.array_equal(sol, [1, 1, -1])
    q = tpb.qubo_problem(np.eye(3, dtype=int))
    assert q.verify(np.array([1, 0, 1])) and not q.verify(np.array([1, 0]))


# ---------------------------------------------------------------------------
# core/ising.py: from_dense, edge_list, fig4_example
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", (0, 1))
def test_from_dense_and_edge_list_equal_jax(seed):
    rng = np.random.default_rng(seed)
    J = rng.integers(-5, 6, size=(30, 30)) * (rng.random((30, 30)) < 0.3)
    J = np.triu(J, 1)
    J = J + J.T
    h = rng.integers(-9, 10, size=30)
    got, want = tising.IsingModel.from_dense(J, h=h), jising.IsingModel.from_dense(J, h=h)
    _model_equal(got, want)
    for a, b in zip(got.edge_list(), want.edge_list()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.dense_J(), J)


@pytest.mark.parametrize("J,msg", [
    (np.array([[0, 1], [2, 0]]), "symmetric"),
    (np.array([[1, 0], [0, 0]]), "diagonal"),
    (np.array([[0.0, np.nan], [np.nan, 0.0]]), "finite"),
])
def test_from_dense_rejects(J, msg):
    with pytest.raises(ValueError, match=msg):
        tising.IsingModel.from_dense(J)


def test_fig4_example_equals_jax():
    got, want = tising.fig4_example(), jising.fig4_example()
    assert (got.n, got.name, got.best_known, got.w_total) == (
        want.n, want.name, want.best_known, want.w_total)
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.weights, want.weights)
    _model_equal(got.to_ising(), want.to_ising())


# ---------------------------------------------------------------------------
# Encoded problems through anneal(), the service, the stream, the launcher
# ---------------------------------------------------------------------------
def _assert_result_equal(got, want):
    np.testing.assert_array_equal(got.best_energy, np.asarray(want.best_energy))
    np.testing.assert_array_equal(got.best_m, np.asarray(want.best_m))
    np.testing.assert_array_equal(got.best_cut, np.asarray(want.best_cut))


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("kind", KINDS)
def test_family_round_trips_through_anneal(kind, seed):
    """hp='auto' from the same base, xorshift noise: the port's spins and
    decoded solution equal the JAX package's.  Feasible in both, except
    coloring at seed 1, where the reference is not (ROADMAP.md queue 3)."""
    t, j = tpb.make_demo(kind, seed=seed), jpb.make_demo(kind, seed=seed)
    got = anneal(t, "auto", seed=seed, track_energy=False, auto_base=SSAHyperParams(**SMOKE),
                 config=SolverConfig(noise="xorshift"), device="cpu")
    want = janneal(j, "auto", seed=seed, track_energy=False, noise="xorshift",
                   auto_base=JHP(**SMOKE))
    _assert_result_equal(got, want)
    (ts, to, tf), (js, jo, jf) = t.best_feasible(got.best_m), j.best_feasible(want.best_m)
    _sol_equal(ts, js)
    assert (to, tf) == (jo, jf)
    if (kind, seed) != ("coloring", 1):
        assert tf and to is not None


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_property_pinned_seeds(kind):
    """The reference's hypothesis round trip, at the seed it fails on and two
    more: the port's decoded outcome equals the JAX package's."""
    base = dict(n_trials=8, m_shot=2)
    for seed in (1, 17, 4242):
        t, j = tpb.make_demo(kind, seed=seed), jpb.make_demo(kind, seed=seed)
        got = anneal(t, "auto", seed=seed, track_energy=False,
                     auto_base=SSAHyperParams(**base), config=SolverConfig(noise="xorshift"),
                     device="cpu")
        want = janneal(j, "auto", seed=seed, track_energy=False, noise="xorshift",
                       auto_base=JHP(**base))
        _assert_result_equal(got, want)
        (ts, to, tf), (js, jo, jf) = t.best_feasible(got.best_m), j.best_feasible(want.best_m)
        _sol_equal(ts, js)
        assert (to, tf) == (jo, jf)


def _family_requests(Req, pb, Hp, backend_seed=0):
    base = Hp(n_trials=4, m_shot=2)
    return [Req(problem=pb.make_demo(k, seed=backend_seed), hp="auto", seed=backend_seed,
                auto_base=base) for k in KINDS]


@pytest.mark.parametrize("backend,jbackend", BACKENDS)
def test_families_through_service_all_backends(backend, jbackend):
    """Every family through AnnealService, field_mode='auto' where the
    backend has one: the responses (spins, energies, solution, objective,
    feasibility, the autotune report) equal the JAX service's."""
    opts = {} if backend == "sparse" else {"field_mode": "auto"}
    got = AnnealService(backend=backend, device="cpu", backend_opts=opts).solve(
        _family_requests(AnnealRequest, tpb, SSAHyperParams))
    want = JService(backend=jbackend, backend_opts=opts).solve(
        _family_requests(JRequest, jpb, JHP))
    for g, w in zip(got, want):
        _assert_result_equal(g.result, w.result)
        _sol_equal(g.solution, w.solution)
        assert (g.objective, g.feasible, g.status, g.bucket, g.batch) == (
            w.objective, w.feasible, w.status, w.bucket, w.batch)
        assert g.feasible and g.autotune is not None
        assert g.request.hp.n_rnd == g.autotune.n_rnd == w.autotune.n_rnd


@pytest.mark.parametrize("backend", ("sparse", "cuda"))
def test_families_through_stream_equal_one_shot(backend):
    """The stream serves encodings: each response's solution, objective and
    feasibility equal the one-shot solve of the same request."""
    opts = {} if backend == "sparse" else {"field_mode": "auto"}
    reqs = _family_requests(AnnealRequest, tpb, SSAHyperParams)
    one = AnnealService(backend=backend, device="cpu", backend_opts=opts)
    base = [one.solve([r])[0] for r in reqs]
    ss = StreamingAnnealService(service=AnnealService(backend=backend, device="cpu",
                                                      backend_opts=opts),
                                policy=StreamPolicy(slots_per_table=2))
    tickets = [ss.submit(r) for r in reqs]
    ss.run_until_idle()
    for t, b in zip(tickets, base):
        r = t.result(timeout=0)
        _assert_result_equal(r.result, b.result)
        _sol_equal(r.solution, b.solution)
        assert (r.objective, r.feasible) == (b.objective, b.feasible)


@pytest.mark.parametrize("kind", KINDS)
def test_launcher_problem_kind_equals_jax(kind, capsys):
    from repro.launch import anneal as jlaunch
    from repro_torch.launch import anneal as launch

    args = ["--problem-kind", kind, "--count", "2", "--trials", "4", "--m-shot", "2",
            "--tau", "10", "--seed", "3"]
    launch.main(["--device", "cpu", *args])
    got = capsys.readouterr().out.splitlines()
    argv, sys.argv = sys.argv, ["anneal", *args]
    try:
        jlaunch.main()
    finally:
        sys.argv = argv
    want = capsys.readouterr().out.splitlines()
    assert got[:2] == want[-3:-1] and "objective=" in got[0]


# ---------------------------------------------------------------------------
# core/problems.py: TSP, partition, GI (paper Sec. VI-B)
# ---------------------------------------------------------------------------
def _line_tsp(pts, **kw):
    dist = np.abs(np.asarray(pts)[:, None] - np.asarray(pts)[None, :])
    return tprob.tsp_problem(dist, **kw), jprob.tsp_problem(dist, **kw)


def test_tsp_encode_decode_equal_jax():
    t, j = _line_tsp([0, 2, 3, 7], penalty=14)
    _model_equal(t.model, j.model)
    assert (t.n_cities, t.offset, t.penalty) == (j.n_cities, j.offset, j.penalty)
    for m in _spins(5, 64, t.model.n):
        tt, jt = tprob.decode_tsp(t, m), jprob.decode_tsp(j, m)
        _sol_equal(tt, jt)
        if tt is not None:
            assert tprob.tsp_tour_length(t, tt) == jprob.tsp_tour_length(j, jt)
    perm = np.eye(4, dtype=np.int64)[[2, 0, 3, 1]]
    m = 2 * perm.reshape(-1) - 1
    _sol_equal(tprob.decode_tsp(t, m), jprob.decode_tsp(j, m))


def test_partition_and_gi_encode_decode_equal_jax():
    values = np.random.default_rng(1).integers(1, 10, size=12)
    (tm, tv), (jm, jv) = tprob.partition_problem(values), jprob.partition_problem(values)
    _model_equal(tm, jm)
    np.testing.assert_array_equal(tv, jv)
    for m in _spins(2, 16, 12):
        assert tprob.decode_partition(values, m) == jprob.decode_partition(values, m)
    A1 = np.zeros((4, 4), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 0)]:
        A1[a, b] = A1[b, a] = 1
    inv = np.argsort([1, 3, 0, 2])
    A2 = A1[np.ix_(inv, inv)]
    (tm, to), (jm, jo) = tprob.gi_problem(A1, A2), jprob.gi_problem(A1, A2)
    _model_equal(tm, jm)
    assert to == jo
    for m in _spins(3, 64, 16):
        _sol_equal(tprob.decode_gi(4, m), jprob.decode_gi(4, m))
    hp_t, hp_j = tprob.suggest_hyperparams(tm, 16, 15), jprob.suggest_hyperparams(jm, 16, 15)
    assert repr(hp_t) == repr(hp_j)


def test_qubo_to_ising_exact_over_all_assignments():
    Q = np.random.default_rng(0).integers(-3, 4, size=(6, 6))
    model, offset = tprob.qubo_to_ising(Q)
    H, ms = _all_energies(model, 6)
    for e, m in zip(H, ms):
        x = (m > 0).astype(np.int64)
        assert 4 * int(x @ Q @ x) == int(e) + offset


def test_partition_solved_by_hassa_as_jax():
    values = np.random.default_rng(1).integers(1, 10, size=12)
    model, _ = tprob.partition_problem(values)
    hp = tprob.suggest_hyperparams(model, n_trials=8, m_shot=10)
    r = anneal(model, hp, seed=0, track_energy=False, device="cpu")
    jmodel, _ = jprob.partition_problem(values)
    _assert_result_equal(r, janneal(jmodel, jprob.suggest_hyperparams(jmodel, 8, 10), seed=0,
                                    track_energy=False))
    resid = min(tprob.decode_partition(values, r.best_m[t]) for t in range(hp.n_trials))
    best = min(tprob.decode_partition(values, 2 * np.array(x) - 1)
               for x in itertools.product([0, 1], repeat=12))
    assert resid == best


def test_tsp_ground_state_is_shortest_tour():
    t, _ = _line_tsp([0, 1, 2, 5])
    H, ms = _all_energies(t.model, 16)
    tour = tprob.decode_tsp(t, ms[int(H.argmin())])
    assert tour is not None and tprob.tsp_tour_length(t, tour) == 10


def test_tsp_and_gi_solved_by_hassa_as_jax():
    t, j = _line_tsp([0, 2, 3, 7], penalty=14)
    hp = tprob.suggest_hyperparams(t.model, n_trials=16, m_shot=20)
    r = anneal(t.model, hp, seed=3, track_energy=False, device="cpu")
    _assert_result_equal(r, janneal(j.model, jprob.suggest_hyperparams(j.model, 16, 20),
                                    seed=3, track_energy=False))
    tours = [tprob.decode_tsp(t, r.best_m[k]) for k in range(hp.n_trials)]
    assert min(tprob.tsp_tour_length(t, x) for x in tours if x is not None) == 14
    A1 = np.zeros((4, 4), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 0)]:
        A1[a, b] = A1[b, a] = 1
    inv = np.argsort([1, 3, 0, 2])
    A2 = A1[np.ix_(inv, inv)]
    model, _ = tprob.gi_problem(A1, A2)
    r = anneal(model, tprob.suggest_hyperparams(model, 16, 15), seed=1, track_energy=False,
               device="cpu")
    jmodel, _ = jprob.gi_problem(A1, A2)
    _assert_result_equal(r, janneal(jmodel, jprob.suggest_hyperparams(jmodel, 16, 15), seed=1,
                                    track_energy=False))
    found = False
    for k in range(16):
        mapping = tprob.decode_gi(4, r.best_m[k])
        if mapping is not None:
            P = np.zeros((4, 4), dtype=int)
            P[np.arange(4), mapping] = 1
            found = found or bool(np.array_equal(P.T @ A1 @ P, A2))
    assert found


# ---------------------------------------------------------------------------
# core/placement.py
# ---------------------------------------------------------------------------
def _clique_routing(E=16, K=4, T=500, seed=0):
    rng = np.random.default_rng(seed)
    cliques = np.arange(E).reshape(E // 4, 4)
    routing = np.zeros((T, K), dtype=np.int64)
    for t in range(T):
        routing[t] = cliques[rng.integers(0, E // 4)][:K]
    return routing


def test_coactivation_stats_and_placement_ising_equal_jax():
    coact, load = tplace.coactivation_stats(_clique_routing(), 16)
    jc, jl = jplace.coactivation_stats(_clique_routing(), 16)
    np.testing.assert_array_equal(coact, jc)
    np.testing.assert_array_equal(load, jl)
    model = tplace.placement_ising(coact, load)
    _model_equal(model, jplace.placement_ising(jc, jl))
    J = model.dense_J()
    assert np.array_equal(J, J.T) and np.all(np.diag(J) == 0) and J.dtype == np.int32


@pytest.mark.parametrize("E,devices,seed", [(16, 4, 0), (32, 8, 1)])
def test_expert_placement_equals_jax(E, devices, seed):
    coact, load = tplace.coactivation_stats(_clique_routing(E=E, T=300, seed=seed), E)
    got = tplace.expert_placement(coact, load, n_devices=devices, seed=seed, device="cpu")
    want = jplace.expert_placement(coact, load, n_devices=devices, seed=seed)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert (got.cost, got.baseline_cost) == (want.cost, want.baseline_cost)
    assert set(np.unique(got.assignment)) <= set(range(devices))
    if E == 16:
        assert got.cost <= got.baseline_cost and got.improvement > 0.2


def test_placement_power_of_two_and_traffic_cost():
    coact, load = tplace.coactivation_stats(_clique_routing(), 16)
    with pytest.raises(AssertionError):
        tplace.expert_placement(coact, load, n_devices=3, device="cpu")
    coact, load = tplace.coactivation_stats(_clique_routing(E=8, T=200), 8)
    good, bad = np.asarray([0, 0, 0, 0, 1, 1, 1, 1]), np.asarray([0, 1, 0, 1, 0, 1, 0, 1])
    assert tplace.traffic_cost(good, coact, load) < tplace.traffic_cost(bad, coact, load)
    assert tplace.traffic_cost(bad, coact, load) == jplace.traffic_cost(bad, coact, load)


def test_ising_energy_matches_jax_with_bias():
    """The energies the identities above rest on equal the JAX package's
    for h ≠ 0 and multi-bit weights."""
    enc = tpb.make_demo("qubo", seed=2)
    m = _spins(9, 6, enc.model.n).astype(np.int32)
    h, idx, w = enc.model.device_arrays("cpu")
    got = tising.ising_energy(torch.from_numpy(m), h, idx, w).numpy()
    jh, ji, jw = jpb.make_demo("qubo", seed=2).model.device_arrays()
    np.testing.assert_array_equal(got, np.asarray(jising.ising_energy(jnp.asarray(m), jh, ji, jw)))
