"""The port's foundations against the JAX package, bit for bit.

The same inputs, made from numpy seeds, go through ``repro`` (JAX) and
``repro_torch``: xorshift lanes and noise, the spin codec, the Ising model
construction and field/energy math, the G-set generators, the schedules and the
memory model.  Every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gset as jgset  # noqa: E402
from repro.core import ising as jising  # noqa: E402
from repro.core import memory as jmemory  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core.ssa import SSAHyperParams as JHP  # noqa: E402
from repro.kernels import bitplane as jbitplane  # noqa: E402
from repro_torch.core import gset, ising, memory, rng, schedule  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams  # noqa: E402
from repro_torch.kernels import bitplane  # noqa: E402


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed,lanes", [(0, (8, 100)), (123, (3, 37)), (2**31 - 1, (5,))])
def test_xorshift_init_matches_jax(seed, lanes):
    np.testing.assert_array_equal(
        _u32(rng.xorshift_init(seed, lanes)), np.asarray(jrng.xorshift_init(seed, lanes))
    )


def test_xorshift_stream_matches_jax_over_many_steps():
    st_t = rng.xorshift_init(7, (8, 100))
    st_j = jrng.xorshift_init(7, (8, 100))
    for _ in range(200):
        st_t, r_t = rng.xorshift_next_bits(st_t)
        st_j, r_j = jrng.xorshift_next_bits(st_j)
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(_u32(st_t), np.asarray(st_j))
    assert r_t.dtype == torch.int32


def test_xorshift_lanes_ok():
    st = rng.xorshift_init(1, (2, 3))
    assert rng.xorshift_lanes_ok(st)
    bad = st.clone()
    bad[:, 1, 2] = 0
    assert not rng.xorshift_lanes_ok(bad)
    assert not rng.xorshift_lanes_ok(st[:3])


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 64, 97, 160])
def test_pack_unpack_match_jax_on_tail_widths(n):
    m = np.random.default_rng(n).choice([-1, 1], size=(3, n)).astype(np.int8)
    words = bitplane.pack_spins(torch.from_numpy(m))
    np.testing.assert_array_equal(_u32(words), np.asarray(jbitplane.pack_spins(jnp.asarray(m))))
    assert words.shape == (3, bitplane.packed_words(n))
    tail = n % 32
    if tail:
        assert np.all(_u32(words)[:, -1] >> np.uint32(tail) == 0)
    np.testing.assert_array_equal(bitplane.unpack_spins(words, n).numpy(), m)
    assert bitplane.packed_nbytes(n) == jbitplane.packed_nbytes(n)


def _graphs():
    rs = np.random.default_rng(4)
    e = rs.integers(0, 30, size=(80, 2))
    e = e[e[:, 0] != e[:, 1]]
    w = rs.integers(-5, 6, size=len(e))
    w[w == 0] = 1
    return [
        ("complete40", 40, *(lambda p: (p.edges, -p.weights))(jgset.complete_graph(40, seed=1)), None),
        ("torus64", 64, *(lambda p: (p.edges, -p.weights))(jgset.toroidal_grid(64, seed=2)), None),
        ("king64", 64, *(lambda p: (p.edges, -p.weights))(jgset.king_graph(64, seed=3)), None),
        ("random30", 30, e, w, rs.integers(-3, 4, size=30)),
    ]


@pytest.mark.parametrize("case", _graphs(), ids=lambda c: c[0])
def test_from_edges_slots_and_dense_J_match_jax(case):
    _, n, edges, weights, h = case
    mt = ising.IsingModel.from_edges(n, edges, weights, h=h)
    mj = jising.IsingModel.from_edges(n, edges, weights, h=h)
    for a in ("h", "nbr_idx", "nbr_w"):
        np.testing.assert_array_equal(getattr(mt, a), getattr(mj, a))
    np.testing.assert_array_equal(mt.dense_J(), mj.dense_J())


@pytest.mark.parametrize("case", _graphs(), ids=lambda c: c[0])
def test_fields_and_energy_match_jax(case):
    _, n, edges, weights, h = case
    mt = ising.IsingModel.from_edges(n, edges, weights, h=h)
    mj = jising.IsingModel.from_edges(n, edges, weights, h=h)
    m = np.random.default_rng(n).choice([-1, 1], size=(5, n)).astype(np.int32)
    ht, it, wt = mt.device_arrays("cpu")
    hj, ij, wj = mj.device_arrays()
    tm = torch.from_numpy(m)
    want = np.asarray(jising.local_fields_sparse(jnp.asarray(m), hj, ij, wj))
    np.testing.assert_array_equal(ising.local_fields_sparse(tm, ht, it, wt).numpy(), want)
    Jt = torch.as_tensor(mt.dense_J(), dtype=torch.float32)
    np.testing.assert_array_equal(ising.local_fields_dense(tm, ht, Jt).numpy(), want)
    np.testing.assert_array_equal(
        ising.ising_energy(tm, ht, it, wt).numpy(),
        np.asarray(jising.ising_energy(jnp.asarray(m), hj, ij, wj)),
    )


@pytest.mark.parametrize("name", ["G11", "G12", "G13", "King1", "K2000"])
def test_gset_twins_match_jax(name):
    pt, pj = gset.load(name), jgset.load(name)
    assert (pt.n, pt.name, pt.best_known, pt.w_total) == (pj.n, pj.name, pj.best_known, pj.w_total)
    np.testing.assert_array_equal(pt.edges, pj.edges)
    np.testing.assert_array_equal(pt.weights, pj.weights)


def test_maxcut_cut_value_and_energy_match_jax():
    pt, pj = gset.load("G11"), jgset.load("G11")
    m = np.random.default_rng(0).choice([-1, 1], size=(4, pt.n)).astype(np.int32)
    np.testing.assert_array_equal(pt.cut_value(m), np.asarray(pj.cut_value(jnp.asarray(m))))
    mt = pt.to_ising()
    ht, it, wt = mt.device_arrays("cpu")
    H = ising.ising_energy(torch.from_numpy(m), ht, it, wt).numpy()
    np.testing.assert_array_equal(pt.cut_from_energy(H), pt.cut_value(m))


@pytest.mark.parametrize("i0_min,i0_max,tau,beta", [(1, 32, 100, 1), (1, 4, 3, 1), (2, 64, 7, 2), (3, 40, 5, 1)])
def test_schedules_and_signature_match_jax(i0_min, i0_max, tau, beta):
    assert schedule.n_temp_steps(i0_min, i0_max, beta) == jschedule.n_temp_steps(i0_min, i0_max, beta)
    for st, sj in (
        (schedule.hassa_schedule(i0_min, i0_max, tau, beta),
         jschedule.hassa_schedule(i0_min, i0_max, tau, beta)),
        (schedule.ssa_schedule(i0_min, i0_max, tau, 2.0 ** -beta),
         jschedule.ssa_schedule(i0_min, i0_max, tau, 2.0 ** -beta)),
    ):
        np.testing.assert_array_equal(st.i0_per_cycle, sj.i0_per_cycle)
        np.testing.assert_array_equal(st.store_mask, sj.store_mask)
        assert (st.tau, st.steps, st.cycles_per_iter) == (sj.tau, sj.steps, sj.cycles_per_iter)
        assert st.signature() == sj.signature()


def test_memory_model_matches_jax():
    for kw in ({}, {"i0_max": 64, "tau": 50}, {"beta_shift": 2, "i0_max": 256}):
        hp, jhp = SSAHyperParams(**kw), JHP(**kw)
        assert memory.ssa_bits_per_iteration(800, hp) == jmemory.ssa_bits_per_iteration(800, jhp)
        assert memory.hassa_bits_per_iteration(800, hp) == jmemory.hassa_bits_per_iteration(800, jhp)
        assert memory.memory_ratio(hp) == jmemory.memory_ratio(jhp)
        assert (hp.steps, hp.total_cycles) == (jhp.steps, jhp.total_cycles)


def test_validate_model_accepts_built_models_and_rejects_malformed_ones():
    from repro.core.engine import validate_model as jvalidate
    from repro_torch.core.engine import validate_model

    good = gset.load("G11").to_ising()
    validate_model(good)
    bad_models = [
        ising.IsingModel(n=0, h=np.zeros(0, np.int32), nbr_idx=np.zeros((0, 1), np.int32),
                         nbr_w=np.zeros((0, 1), np.int32)),
        ising.IsingModel(n=3, h=np.zeros(2, np.int32), nbr_idx=np.zeros((3, 1), np.int32),
                         nbr_w=np.zeros((3, 1), np.int32)),
        ising.IsingModel(n=3, h=np.zeros(3, np.int32), nbr_idx=np.full((3, 1), 5, np.int32),
                         nbr_w=np.zeros((3, 1), np.int32)),
        ising.IsingModel(n=3, h=np.zeros(3, np.int32), nbr_idx=np.zeros((3, 2), np.int32),
                         nbr_w=np.zeros((3, 1), np.int32)),
    ]
    for bad in bad_models:
        with pytest.raises(ValueError):
            validate_model(bad)
        with pytest.raises(ValueError):
            jvalidate(jising.IsingModel(bad.n, bad.h, bad.nbr_idx, bad.nbr_w))
