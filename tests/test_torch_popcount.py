"""The port's XNOR-popcount path against the JAX package's, on the CPU.

Mirrors ``tests/test_popcount.py`` from the same numpy seeds: the coupling
codec, the exact-integer field, the field-mode resolvers, the plain version
of the plateau-chain kernel K2 against the Pallas kernel in interpret mode,
and ``anneal(field_mode='popcount')`` end to end against the JAX package's
``pallas``/``dense`` popcount runs and the port's sparse backend.  All of
it is integer arithmetic, so the bar is bit-identity: no tolerance.  The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""
import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import SolverConfig as JSolverConfig  # noqa: E402
from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.core.ising import local_fields_popcount as jfields_popcount  # noqa: E402
from repro.kernels import bitplane as jbitplane  # noqa: E402
from repro.kernels import ssa_update as jssa  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core import ssa as tssa  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ising import local_fields_dense, local_fields_popcount  # noqa: E402
from repro_torch.kernels import bitplane, ssa_update  # noqa: E402

HP = dict(n_trials=3, m_shot=2, tau=4, i0_min=1, i0_max=8)
OUTS = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")


def _torus(g):
    # 50 spins: a ragged bitplane tail, ±1 weights (1 plane).
    return g.toroidal_grid(50, seed=17)


def _king(g):
    # 49 spins, king's-graph topology re-weighted to ±1..±3: 2 planes.
    p = g.king_graph(49, seed=3)
    rs = np.random.default_rng(11)
    w = rs.integers(1, 4, len(p.edges)) * np.sign(p.weights)
    return type(p)(n=p.n, edges=p.edges, weights=w.astype(np.int64), name="King49w3")


PROBLEMS = {"torus50": _torus, "king49w3": _king}


def _i32(a):
    return convert._as_i32(np.asarray(a), "cpu")


def _symmetric(rs, n, w_max):
    J = np.triu(rs.integers(-w_max, w_max + 1, (n, n)), 1)
    return J + J.T


# ---------------------------------------------------------------------------
# popcount_u32 and the coupling codec
# ---------------------------------------------------------------------------
def test_popcount_u32_counts_bits():
    rs = np.random.default_rng(0)
    words = rs.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    words[::2] |= np.uint32(0x80000000)  # half the words have bit 31 set
    words[:5] = [0, 1, 0xFFFFFFFF, 0x80000001, 0xDEADBEEF]
    got = bitplane.popcount_u32(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    want = np.unpackbits(words.view(np.uint8).reshape(-1, 4), axis=-1).sum(-1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_popcount_u32_rejects_other_dtypes():
    with pytest.raises(TypeError):
        bitplane.popcount_u32(torch.tensor([1, 2], dtype=torch.int64))


@pytest.mark.parametrize("n,w_max,seed", [(1, 1, 0), (31, 1, 1), (32, 3, 2), (33, 7, 3),
                                          (70, 5, 4), (100, 1, 5)])
def test_pack_couplings_matches_jax(n, w_max, seed):
    J = _symmetric(np.random.default_rng(seed), n, w_max)
    got = bitplane.pack_couplings(J)
    want = jbitplane.pack_couplings(J.astype(np.float32))
    assert got.n_bits == want.n_bits and got.n_words == want.n_words
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.asarray(w).dtype), np.asarray(w))


def test_pack_couplings_rejects_non_integer():
    with pytest.raises(ValueError, match="integer"):
        bitplane.pack_couplings(np.asarray([[0.0, 0.5], [0.5, 0.0]], np.float32))


def test_pack_couplings_forced_bits_too_small():
    with pytest.raises(ValueError, match="bitplanes"):
        bitplane.pack_couplings(np.asarray([[0, 5], [5, 0]]), n_bits=1)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_pack_from_adjacency_equals_pack_couplings(problem):
    m = PROBLEMS[problem](gset).to_ising()
    a = bitplane.pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w)
    d = bitplane.pack_couplings(m.dense_J())
    jm = PROBLEMS[problem](jgset).to_ising()
    j = jbitplane.pack_couplings_from_adjacency(jm.n, jm.nbr_idx, jm.nbr_w)
    for x, y, z in zip(a, d, j):
        assert torch.equal(x, y)
        np.testing.assert_array_equal(x.numpy().view(np.asarray(z).dtype), np.asarray(z))
    jb = bitplane.adjacency_weight_bits(m.n, m.nbr_idx, m.nbr_w)
    assert a.n_bits == jb == {"torus50": 1, "king49w3": 2}[problem]
    nbytes = sum(t.numel() * t.element_size() for t in a)
    assert nbytes == bitplane.packed_j_nbytes(m.n, jb) == jbitplane.packed_j_nbytes(m.n, jb)


def test_packed_j_from_arrays_round_trip():
    m = _king(jgset).to_ising()
    jpj = jbitplane.pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w)
    pj = convert.packed_j_from_arrays(*(np.asarray(a) for a in jpj))
    want = bitplane.pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w)
    for g, w in zip(pj, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The exact-integer field
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,w_max,seed", [(1, 1, 10), (7, 7, 11), (32, 2, 12), (33, 1, 13),
                                          (50, 3, 14), (70, 7, 15)])
def test_popcount_fields_exact_integer(n, w_max, seed):
    """Random symmetric integer graphs over every tail width and 1–3
    magnitude planes: the popcount field equals the int64 matmul, the
    port's dense field and the JAX package's popcount field."""
    rs = np.random.default_rng(seed)
    J = _symmetric(rs, n, w_max)
    h = rs.integers(-3, 4, n).astype(np.int32)
    spins = (rs.integers(0, 2, (2, n)) * 2 - 1).astype(np.int8)
    m = torch.from_numpy(spins)
    got = local_fields_popcount(bitplane.pack_spins(m), torch.from_numpy(h),
                                bitplane.pack_couplings(J))
    assert got.dtype == torch.int32
    want = h.astype(np.int64) + spins.astype(np.int64) @ J.T
    np.testing.assert_array_equal(got.numpy(), want)
    dense = local_fields_dense(m, torch.from_numpy(h), torch.as_tensor(J, dtype=torch.float32))
    assert torch.equal(got, dense)
    jgot = jfields_popcount(jbitplane.pack_spins(jnp.asarray(spins)), jnp.asarray(h),
                            jbitplane.pack_couplings(J.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


@pytest.mark.parametrize("tile_n", [1, 16, 48, 49])
def test_popcount_fields_tiled_equals_untiled(tile_n):
    m = _king(gset).to_ising()
    pj = bitplane.pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w)
    rs = np.random.default_rng(0)
    mw = bitplane.pack_spins(torch.from_numpy((rs.integers(0, 2, (3, m.n)) * 2 - 1)))
    h = torch.from_numpy(m.h)
    assert torch.equal(local_fields_popcount(mw, h, pj),
                       local_fields_popcount(mw, h, pj, tile_n=tile_n))


def test_popcount_field_path_has_no_float_values():
    """Every tensor the popcount field makes is an integer or bool tensor
    (recorded op by op): the contraction never unpacks to floats."""
    from torch.overrides import TorchFunctionMode

    class Dtypes(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.seen.add(t.dtype)
            return out

    m = _king(gset).to_ising()
    pj = bitplane.pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w)
    mw = bitplane.pack_spins(torch.ones((3, m.n), dtype=torch.int8))
    h = torch.from_numpy(m.h)
    rec = Dtypes()
    with rec:
        for tile in (None, 16):
            out = local_fields_popcount(mw, h, pj, tile_n=tile)
    assert out.dtype == torch.int32
    assert torch.int32 in rec.seen
    assert not [d for d in rec.seen if d.is_floating_point or d.is_complex], rec.seen


# ---------------------------------------------------------------------------
# Resolvers and schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_model_weight_bits_matches_jax(problem):
    got = engine.model_weight_bits(PROBLEMS[problem](gset).to_ising())
    assert got == jengine.model_weight_bits(PROBLEMS[problem](jgset).to_ising())
    assert got == {"torus50": 1, "king49w3": 2}[problem]


@pytest.mark.parametrize("mode,bits", [("auto", 1), ("auto", 4), ("auto", 5), ("dense", 1),
                                       ("popcount", 9)])
def test_resolve_field_mode_by_weight_depth(mode, bits):
    got = engine.resolve_field_mode(mode, bits)
    assert got == jengine.resolve_field_mode(mode, bits)
    auto_dense = mode == "auto" and bits > engine.POPCOUNT_AUTO_MAX_BITS
    assert got == ("dense" if mode == "dense" or auto_dense else "popcount")


def test_resolve_field_mode_rejects_unknown():
    with pytest.raises(ValueError):
        engine.resolve_field_mode("xnor", 1)


@pytest.mark.parametrize("storage", ["i0max", "all"])
def test_plateau_cycle_schedules_match_jax(storage):
    hp = tssa.SSAHyperParams(**HP)
    chain = engine.tile_plateaus(engine.schedule_plateaus(hp.schedule(), storage), 27)
    i0, fold, jperp = engine.plateau_cycle_schedules(chain)
    jhp = JHP(**HP)
    jchain = jengine.tile_plateaus(jengine.schedule_plateaus(jhp.schedule("hassa"), storage),
                                   27)
    ji0, jfold, jjperp = jengine.plateau_cycle_schedules(jchain)
    assert i0.dtype == fold.dtype == jperp.dtype == np.int32
    np.testing.assert_array_equal(i0, ji0)
    np.testing.assert_array_equal(fold, jfold)
    np.testing.assert_array_equal(jperp, jjperp)
    assert len(fold) == len(i0) + 1 == 28 and fold[0] == 0 and not jperp.any()
    with pytest.raises(ValueError):
        engine.plateau_cycle_schedules(())


# ---------------------------------------------------------------------------
# K2's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
def _chain_case(b, r, n, c, w_max, seed, sched):
    rs = np.random.default_rng(seed)
    Js = [_symmetric(rs, n, w_max).astype(np.float32) for _ in range(b)]
    nb = max(1, w_max.bit_length())  # one plane count for the whole stack
    pjs = [jbitplane.pack_couplings(J, nb) for J in Js]
    case = dict(
        m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(rs.choice([-1, 1], (b, r, n))))),
        itanh=rs.integers(-6, 6, (b, r, n)).astype(np.int32),
        sign=np.stack([np.asarray(p.sign) for p in pjs]),
        mags=np.stack([np.asarray(p.mags) for p in pjs]),
        base=np.stack([np.asarray(p.base) for p in pjs]),
        h=rs.integers(-3, 4, (b, n)).astype(np.int32),
        rng=np.stack([np.asarray(jrng.xorshift_init(seed + k, (r, n))) for k in range(b)]),
        best_H=np.full((b, r), 2**30, np.int32),
        best_m_packed=np.asarray(jbitplane.pack_spins(
            jnp.asarray(rs.choice([-1, 1], (b, r, n))))),
    )
    case["best_H"][:, 0] = -10**6  # a trial whose best cannot improve keeps its words
    if sched == "hassa":
        chain = engine.schedule_plateaus(tssa.SSAHyperParams(**HP).schedule(), "i0max")
        i0, fold, _ = engine.plateau_cycle_schedules(engine.tile_plateaus(chain, c))
    else:  # I0 and fold changing at random mid-chain
        i0 = rs.integers(0, 9, c).astype(np.int32)
        fold = rs.integers(0, 2, c + 1).astype(np.int32)
    case.update(i0_sched=i0, fold_sched=fold)
    return case


@pytest.mark.parametrize("b,r,n,c,w_max,sched", [
    (1, 3, 37, 9, 7, "random"),      # ragged N, nb = 3
    (1, 5, 50, 16, 1, "hassa"),      # the torus width, one plane
    (2, 3, 33, 7, 3, "random"),      # B = 2, nb = 2
    (1, 4, 64, 12, 2, "hassa"),      # whole words, a chain across plateaus
    (1, 2, 40, 1, 1, "random"),      # C = 1: one update, then the epilogue fold
])
def test_popcount_chain_plain_matches_pallas(b, r, n, c, w_max, sched):
    case = _chain_case(b, r, n, c, w_max, seed=n + c, sched=sched)
    args = [case[k] for k in ("m_packed", "itanh", "sign", "mags", "base", "h", "rng",
                              "i0_sched", "fold_sched", "best_H", "best_m_packed")]
    want = jssa.ssa_plateau_popcount_batched(*(jnp.asarray(a) for a in args), n_rnd=2)
    got = ssa_update.ssa_plateau_popcount_batched(*(_i32(a) for a in args), n_rnd=2)
    for name, g, w in zip(OUTS, got, want):
        w = np.asarray(w)
        g = g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=name)  # whole words, tail bits too
    if b == 1:
        one = ssa_update.ssa_plateau_popcount(*(_i32(a[0]) if a.ndim > 1 else _i32(a)
                                                for a in args), n_rnd=2)
        for g, w in zip(one, got):
            assert torch.equal(g, w[0])


def test_popcount_chain_rejects_ssqa():
    """A J⊥ schedule without a ring size raises, as in the JAX package."""
    case = _chain_case(1, 2, 40, 3, 1, seed=1, sched="random")
    args = [_i32(case[k]) for k in ("m_packed", "itanh", "sign", "mags", "base", "h", "rng",
                                    "i0_sched", "fold_sched", "best_H", "best_m_packed")]
    jperp = torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_replicas == 0"):
        ssa_update.ssa_plateau_popcount_batched(*args, jperp_sched=jperp)
    with pytest.raises(ValueError, match="n_replicas == 0"):
        jssa.ssa_plateau_popcount_batched(
            *(jnp.asarray(case[k]) for k in ("m_packed", "itanh", "sign", "mags", "base", "h",
                                             "rng", "i0_sched", "fold_sched", "best_H",
                                             "best_m_packed")),
            jperp_sched=jnp.ones(3, jnp.int32))


# ---------------------------------------------------------------------------
# The engine: one K2 call per chain, chains equal to chained plateaus
# ---------------------------------------------------------------------------
def _cuda_popcount(model, layout="dense", **kw):
    return engine.make_backend("cuda", model, n_trials=2, n_rnd=2, noise="xorshift",
                               device="cpu", field_mode="popcount", storage_layout=layout,
                               **kw)


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_popcount_run_plateaus_equals_chained_run_plateau(layout):
    bk = _cuda_popcount(_king(gset).to_ising(), layout)
    plateaus = engine.schedule_plateaus(tssa.SSAHyperParams(**HP).schedule(), "i0max")
    assert len(plateaus) > 1
    st0 = bk.init_state(0)
    whole = bk.run_plateaus(st0, plateaus)
    chained = st0
    for p in plateaus:
        chained, _, _ = bk.run_plateau(chained, p.i0, length=p.length, eligible=p.eligible)
    for a, b in zip(whole, chained):
        assert torch.equal(a, b)


def test_popcount_chain_is_one_kernel_call(monkeypatch):
    """A chain makes one call of the K2 wrapper.  On CPU tensors the
    wrapper runs the plain version, so its ``launches`` count stays put;
    the calls are counted by a spy here, the launches on the card by
    chip_smoke.py."""
    calls = []
    real = ssa_update.ssa_plateau_popcount_batched

    def spy(*a, **k):
        calls.append(a[7].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(ssa_update, "ssa_plateau_popcount_batched", spy)
    bk = _cuda_popcount(_torus(gset).to_ising())
    hp = tssa.SSAHyperParams(**HP)
    plateaus = engine.schedule_plateaus(hp.schedule(), "i0max")
    before = real.launches
    st = bk.init_state(0)
    for _ in range(3):
        st, _, _ = engine.run_schedule(bk, plateaus, st, record="best")
    assert calls == [hp.cycles_per_iter] * 3
    assert real.launches == before
    assert len(bk._schedules) == 1  # the chain's schedules were built once


# ---------------------------------------------------------------------------
# anneal() end to end
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_run(problem, backend, layout, record="best", track_energy=False, noise="xorshift"):
    return janneal(PROBLEMS[problem](jgset), JHP(**HP), seed=3, record=record,
                   track_energy=track_energy,
                   config=JSolverConfig(backend=backend, noise=noise, storage_layout=layout,
                                        field_mode="popcount"))


def _port_run(problem, backend, layout, record="best", track_energy=False, noise="xorshift",
              field_mode="popcount"):
    return tssa.anneal(PROBLEMS[problem](gset), tssa.SSAHyperParams(**HP), seed=3,
                       record=record, track_energy=track_energy, device="cpu",
                       config=SolverConfig(backend=backend, noise=noise,
                                           storage_layout=layout, field_mode=field_mode))


def _assert_same(got, want, track_energy=False):
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_cut, want.best_cut)
    np.testing.assert_array_equal(got.best_m, want.best_m)
    if want.traj is not None:
        np.testing.assert_array_equal(got.traj, want.traj)
    if track_energy:
        np.testing.assert_array_equal(got.energy_min, want.energy_min)
        np.testing.assert_allclose(got.energy_mean, want.energy_mean, rtol=1e-6, atol=0)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("backend", ["cuda", "dense"])
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_popcount_anneal_matches_jax_and_sparse(problem, backend, layout):
    got = _port_run(problem, backend, layout)
    _assert_same(got, _jax_run(problem, "pallas", layout))
    _assert_same(got, _port_run(problem, "sparse", layout, field_mode="auto"))


@pytest.mark.parametrize("record,track_energy", [("best", True), ("traj", False)])
def test_popcount_anneal_per_cycle_outputs_match_jax(record, track_energy):
    """Per-cycle outputs run the cycle loop over the plain popcount field;
    ``energy_mean`` is an f32 mean held to rtol 1e-6, as in
    tests/test_torch_anneal.py."""
    got = _port_run("torus50", "cuda", "packed", record, track_energy)
    _assert_same(got, _jax_run("torus50", "pallas", "packed", record, track_energy),
                 track_energy)


def test_dense_popcount_with_threefry_matches_jax():
    got = _port_run("king49w3", "dense", "dense", noise="threefry")
    _assert_same(got, _jax_run("king49w3", "dense", "dense", noise="threefry"))


@pytest.mark.parametrize("kw", [dict(noise="threefry"),
                                dict(noise="xorshift", noise_mode="pregen"),
                                dict(noise="threefry", field_mode="auto")],
                         ids=lambda v: str(v))
def test_cuda_popcount_requires_streamed_noise(kw):
    m = _torus(gset).to_ising()
    kw = dict(dict(field_mode="popcount"), **kw)
    with pytest.raises(ValueError, match="streamed"):
        engine.make_backend("cuda", m, n_trials=2, device="cpu", **kw)
    with pytest.raises(ValueError, match="streamed"):
        jengine.make_backend("pallas", _torus(jgset).to_ising(), n_trials=2, **kw)


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_popcount_backend_holds_no_dense_j(backend):
    bk = engine.make_backend(backend, _torus(gset).to_ising(), n_trials=2, noise="xorshift",
                             device="cpu", field_mode="auto")
    assert bk.field_mode == "popcount" and not hasattr(bk, "J")
    assert isinstance(bk.packed_j, bitplane.PackedJ)


def test_cuda_popcount_planes_are_in_kernel_layout():
    """The cuda backend holds its planes [Nw][N] (same shapes, same words),
    so the K2 wrapper's transpose of the B=1 slice is the backend's memory
    itself: no launch copies the planes."""
    m = _torus(gset).to_ising()
    pj = _cuda_popcount(m).packed_j
    plain = bitplane.pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w)
    for got, want, dims in ((pj.sign, plain.sign, (1, 2)), (pj.mags, plain.mags, (2, 3))):
        assert torch.equal(got, want)
        t = got[None].transpose(*dims)
        assert t.is_contiguous() and t.contiguous().data_ptr() == got.data_ptr()
    assert torch.equal(pj.base, plain.base)


def test_dense_popcount_above_tiled_threshold_runs_row_tiled():
    """Above TILED_J_THRESHOLD the dense backend under popcount needs no J
    (the unported slab path is not asked for) and row-tiles its field."""
    model = gset.toroidal_grid(engine.TILED_J_THRESHOLD + 4, seed=0).to_ising()
    bk = engine.make_backend("dense", model, n_trials=2, noise="xorshift", device="cpu",
                             field_mode="popcount")
    assert bk.j_mode == "tiled" and bk._pc_tile == engine.POPCOUNT_TILE_N == 512
    assert not hasattr(bk, "J")
    spins = (torch.randint(0, 2, (2, model.n), generator=torch.Generator().manual_seed(0))
             * 2 - 1).to(torch.int8)
    tiled = bk._field(spins)
    whole = local_fields_popcount(bitplane.pack_spins(spins), bk.h, bk.packed_j)
    assert torch.equal(tiled, whole)
    st, _, _ = bk.run_plateau(bk.init_state(1), 4, length=2, eligible=True)
    assert bk.finalize(st)[1].shape == (2, model.n)


def test_engine_opts_forward_popcount_not_auto():
    assert SolverConfig(backend="cuda", field_mode="popcount").engine_opts()["field_mode"] \
        == "popcount"
    assert "field_mode" not in SolverConfig(backend="cuda").engine_opts()
    assert "field_mode" not in SolverConfig(backend="sparse", field_mode="popcount").engine_opts()


def test_launcher_field_mode_popcount_matches_jax(capsys, monkeypatch):
    from repro.launch import anneal as jlauncher
    from repro_torch.launch import anneal as launcher

    flags = ["--problem", "G11", "--trials", "2", "--m-shot", "1", "--tau", "3",
             "--i0-max", "4", "--noise", "xorshift", "--field-mode", "popcount", "--seed", "5"]
    launcher.main(flags + ["--backend", "cuda", "--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["anneal"] + flags + ["--backend", "pallas"])
    jlauncher.main()
    want = capsys.readouterr().out

    def result(out):
        line = next(x for x in out.splitlines() if x.startswith("best cut"))
        return line.split("(")[0]

    assert result(got) == result(want)
