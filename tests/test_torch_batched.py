"""The port's bucketing and batched backends against the JAX package's, on
the CPU.

Bucketing (``next_pow2``, ``bucket_n``, ``pad_model``, ``pad_degree``,
``padded_noise_init``) and the slot primitives (``extract_slot``,
``splice_slot``) are held against the JAX package's.  Each batched backend
— sparse, dense (dense J, tiled J, popcount) and cuda (K1, its ring mode,
K4 under xorshift pregen and threefry, K2 and its ring mode, all as their
plain versions on the CPU) — runs three mixed-size models stacked in one
bucket, from the same seeds as the JAX package's ``Batched*Backend`` (the
pallas one in interpret mode), and must equal it bit for bit after
``init_state`` and after ``run_shots``.  With xorshift noise each problem's
live lanes must also equal the port's unpadded single-problem ``anneal()``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jengine  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core.ssqa import SSQAHyperParams as JSSQA  # noqa: E402
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core import ssa as tssa  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ising import local_fields_popcount  # noqa: E402
from repro_torch.core.ssqa import SSQAHyperParams  # noqa: E402
from repro_torch.kernels import ssa_update  # noqa: E402
from repro_torch.kernels.bitplane import PackedJ, pack_spins  # noqa: E402

HP = dict(n_trials=8, m_shot=2, tau=3, i0_min=1, i0_max=4)
SSQA = dict(HP, n_replicas=4, jperp_max=2)
NB = 64
SEEDS = (3, 4, 5)


def _problems(g):
    """Three sizes in the 64 bucket: ±1 torus, ±1 king, a complete graph."""
    return [g.toroidal_grid(36, seed=1), g.king_graph(49, seed=2), g.complete_graph(20, seed=3)]


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_state_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for field, a, b in zip(got._fields, got, want):
        a, b = _to_np(a), np.asarray(b)
        if field == "noise_state" and a.dtype == np.int64:  # threefry keys
            a = a.astype(np.uint32)
        # Words and lanes: the same 32-bit patterns, int32 or uint32.
        a, b = (x.view(np.uint32) if x.dtype == np.int32 else x for x in (a, b))
        np.testing.assert_array_equal(a, b, err_msg=field)


# (port backend, JAX backend, options, noise, layout, ssqa)
CASES = [
    ("sparse", "sparse", {}, "xorshift", "dense", False),
    ("sparse", "sparse", {}, "threefry", "packed", False),
    ("sparse", "sparse", {}, "xorshift", "packed", True),
    ("dense", "dense", {}, "xorshift", "packed", False),
    ("dense", "dense", {}, "threefry", "dense", False),
    ("dense", "dense", {"j_mode": "tiled", "tile_n": 24}, "xorshift", "dense", False),
    ("dense", "dense", {"field_mode": "popcount"}, "xorshift", "packed", False),
    ("dense", "dense", {"field_mode": "popcount"}, "xorshift", "dense", True),
    ("cuda", "pallas", {}, "xorshift", "dense", False),
    ("cuda", "pallas", {}, "xorshift", "packed", False),
    ("cuda", "pallas", {}, "xorshift", "packed", True),
    ("cuda", "pallas", {"noise_mode": "pregen"}, "xorshift", "dense", False),
    ("cuda", "pallas", {}, "threefry", "packed", False),
    ("cuda", "pallas", {"field_mode": "popcount"}, "xorshift", "dense", False),
    ("cuda", "pallas", {"field_mode": "popcount"}, "xorshift", "packed", True),
]


def _case_id(c):
    bk, _, opts, noise, layout, ssqa = c
    kind = {"j_mode": "tiled", "noise_mode": "pregen"}
    extra = [kind.get(k, v) for k, v in opts.items() if k != "tile_n"]
    return "-".join([bk, *extra, noise, layout] + (["ssqa"] if ssqa else []))


def _jssa_hp():
    from repro.core import SSAHyperParams

    return SSAHyperParams(**HP)


@functools.lru_cache(maxsize=None)
def _jax_run(case_id):
    _, jb, opts, noise, layout, ssqa = next(c for c in CASES if _case_id(c) == case_id)
    hp = JSSQA(**SSQA) if ssqa else _jssa_hp()
    opts = dict(opts)
    if ssqa:
        opts["n_replicas"] = hp.n_replicas
        if jb == "pallas":
            opts["noise_mode"] = "streamed"
    bk = jengine.make_batched_backend(jb, n_bucket=NB, n_trials=hp.n_trials, noise=noise,
                                      storage_layout=layout, **opts)
    probs = _problems(jgset)
    prob = bk.stack([p.to_ising() for p in probs])
    st0 = bk.init_state(prob, bk.init_noise(SEEDS, [p.n for p in probs]))
    plateaus = jengine.schedule_plateaus(hp.schedule(), "i0max")
    st = bk.run_shots(prob, st0, plateaus, hp.m_shot)
    return st0, st, bk.finalize(st)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_batched_backend_matches_jax(case):
    backend, _, opts, noise, layout, ssqa = case
    hp = SSQAHyperParams(**SSQA) if ssqa else tssa.SSAHyperParams(**HP)
    kw = dict(opts, n_replicas=hp.n_replicas) if ssqa else dict(opts)
    bk = engine.make_batched_backend(backend, n_bucket=NB, n_trials=hp.n_trials, noise=noise,
                                     storage_layout=layout, device="cpu", **kw)
    probs = _problems(gset)
    prob = bk.stack([p.to_ising() for p in probs])
    st0 = bk.init_state(prob, bk.init_noise(SEEDS, [p.n for p in probs]))
    plateaus = engine.schedule_plateaus(hp.schedule(), "i0max")
    st = bk.run_shots(prob, st0, plateaus, hp.m_shot)
    want0, want, (wbh, wbm) = _jax_run(_case_id(case))
    _assert_state_equal(st0, want0)
    _assert_state_equal(st, want)
    bh, bm = bk.finalize(st)
    np.testing.assert_array_equal(bh.numpy(), np.asarray(wbh))
    np.testing.assert_array_equal(bm.numpy(), np.asarray(wbm))
    if noise != "xorshift":
        return
    # Padding invariance: the live lanes equal the unpadded single problem.
    cfg = SolverConfig(backend=backend, noise=noise, storage_layout=layout,
                       **{k: v for k, v in opts.items() if k in ("field_mode", "j_mode")})
    for b, (p, seed) in enumerate(zip(probs, SEEDS)):
        ref = tssa.anneal(p, hp, seed=seed, track_energy=False, config=cfg, device="cpu")
        np.testing.assert_array_equal(bh[b].numpy(), ref.best_energy)
        np.testing.assert_array_equal(bm[b, :, :p.n].numpy(), ref.best_m)


def test_batched_run_plateau_matches_jax():
    """One plateau at a time (the streaming path) equals the JAX package's,
    on K1 and on K2's single-plateau chain."""
    from repro.core import SSAHyperParams as JHP

    for backend, jb, opts in (("cuda", "pallas", {}),
                              ("cuda", "pallas", {"field_mode": "popcount"})):
        bk = engine.make_batched_backend(backend, n_bucket=NB, n_trials=4, noise="xorshift",
                                         device="cpu", **opts)
        jbk = jengine.make_batched_backend(jb, n_bucket=NB, n_trials=4, noise="xorshift", **opts)
        probs, jprobs = _problems(gset), _problems(jgset)
        prob, jprob = bk.stack([p.to_ising() for p in probs]), jbk.stack(
            [p.to_ising() for p in jprobs])
        st = bk.init_state(prob, bk.init_noise(SEEDS, [p.n for p in probs]))
        jst = jbk.init_state(jprob, jbk.init_noise(SEEDS, [p.n for p in jprobs]))
        for p in engine.schedule_plateaus(tssa.SSAHyperParams(**HP).schedule(), "i0max"):
            st = bk.run_plateau(prob, st, p.i0, length=p.length, eligible=p.eligible)
            jst = jbk.run_plateau(jprob, jst, p.i0, length=p.length, eligible=p.eligible)
        _assert_state_equal(st, jst)
        assert JHP(**HP).schedule().signature() == tssa.SSAHyperParams(**HP).schedule().signature()


# ---------------------------------------------------------------------------
# Bucketing and padding
# ---------------------------------------------------------------------------
def test_bucket_n_and_next_pow2_match_jax():
    for n in (1, 2, 3, 10, 63, 64, 65, 800, 1024, 1025, 14383, 20000):
        assert engine.next_pow2(n) == jengine.next_pow2(n)
        for mb in (1, 16, 64):
            assert engine.bucket_n(n, mb) == jengine.bucket_n(n, mb)
    assert engine.bucket_n(800) == 1024 and engine.bucket_n(14383) == 16384
    with pytest.raises(ValueError):
        engine.bucket_n(0)


@pytest.mark.parametrize("n_bucket", [49, 64, 128])
def test_pad_model_and_degree_match_jax(n_bucket):
    got = engine.pad_model(gset.king_graph(49, seed=2).to_ising(), n_bucket)
    want = jengine.pad_model(jgset.king_graph(49, seed=2).to_ising(), n_bucket)
    assert got.n == want.n == n_bucket and got.name == want.name
    for k in ("h", "nbr_idx", "nbr_w"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)))
    got_d = engine.pad_degree(got, 11)
    want_d = jengine.pad_degree(want, 11)
    for k in ("h", "nbr_idx", "nbr_w"):
        np.testing.assert_array_equal(getattr(got_d, k), np.asarray(getattr(want_d, k)))
    with pytest.raises(ValueError):
        engine.pad_model(got, n_bucket - 1) if n_bucket > 49 else engine.pad_model(got, 48)
    with pytest.raises(ValueError):
        engine.pad_degree(got_d, 3)


@pytest.mark.parametrize("noise", ["xorshift", "threefry"])
@pytest.mark.parametrize("n_live,n_bucket", [(36, 64), (64, 64)])
def test_padded_noise_init_matches_jax(noise, n_live, n_bucket):
    got = engine.padded_noise_init(noise, 7, 5, n_live, n_bucket, device="cpu")
    want = np.asarray(jengine.padded_noise_init(noise, 7, 5, n_live, n_bucket))
    if noise == "xorshift":
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(
            got[..., :n_live].numpy(), engine.xorshift_init(7, (5, n_live)).numpy())
    else:
        np.testing.assert_array_equal(np.asarray(got, np.uint32), want)


def test_pad_lanes_field_is_zero_in_every_field_mode():
    """Pad rows self-index with weight 0: dense J, tiled J, the popcount
    planes and the sparse gather all give a field of exactly 0 there."""
    rs = np.random.default_rng(1)
    probs = [p.to_ising() for p in _problems(gset)]
    m = torch.from_numpy(rs.choice([-1, 1], (3, 4, NB)).astype(np.int8))
    fields = []
    for backend, opts in (("sparse", {}), ("dense", {}), ("dense", {"j_mode": "tiled"}),
                          ("dense", {"field_mode": "popcount", "j_bits": 2})):
        bk = engine.make_batched_backend(backend, n_bucket=NB, n_trials=4, device="cpu", **opts)
        fields.append(bk._field(bk.stack(probs), m))
    for f in fields:
        assert torch.equal(f, fields[0])
        for b, p in enumerate(probs):
            assert not f[b, :, p.n:].any()
    # K2's plane layout (popcount_planes) of the stacked padded planes.
    bk = engine.make_batched_backend("cuda", n_bucket=NB, n_trials=4, device="cpu",
                                     field_mode="popcount", j_bits=2)
    prob = bk.stack(probs)
    assert prob["mags"].shape == (3, 2, NB, 2)
    pj = PackedJ(prob["sign"][:, None], prob["mags"][:, None], prob["base"][:, None])
    assert torch.equal(local_fields_popcount(pack_spins(m), prob["h"][:, None], pj), fields[0])


# ---------------------------------------------------------------------------
# Slot primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("noise", ["xorshift", "threefry"])
def test_extract_and_splice_slot(noise):
    bk = engine.make_batched_backend("sparse", n_bucket=NB, n_trials=4, noise=noise,
                                     storage_layout="packed", device="cpu")
    jbk = jengine.make_batched_backend("sparse", n_bucket=NB, n_trials=4, noise=noise,
                                       storage_layout="packed")
    probs, jprobs = _problems(gset), _problems(jgset)
    st = bk.init_state(bk.stack([p.to_ising() for p in probs]),
                       bk.init_noise(SEEDS, [p.n for p in probs]))
    jst = jbk.init_state(jbk.stack([p.to_ising() for p in jprobs]),
                         jbk.init_noise(SEEDS, [p.n for p in jprobs]))
    one = engine.extract_slot(st, 1)
    _assert_state_equal(one, jengine.extract_slot(jst, 1))
    assert one.m_packed.shape[0] == 1
    # Splicing lane 1 into lane 0 changes lane 0 only, as in the JAX package.
    spliced = engine.splice_slot(st, 0, one)
    _assert_state_equal(spliced, jengine.splice_slot(jst, 0, jengine.extract_slot(jst, 1)))
    _assert_state_equal(engine.extract_slot(spliced, 0), engine.extract_slot(st, 1))
    _assert_state_equal(engine.extract_slot(spliced, 2), engine.extract_slot(st, 2))
    _assert_state_equal(engine.extract_slot(st, 0), jengine.extract_slot(jst, 0))  # st untouched
    prob = bk.stack([p.to_ising() for p in probs])
    sub = engine.extract_slot(prob, 2)
    assert set(sub) == {"h", "nbr_idx", "nbr_w"} and sub["h"].shape == (1, NB)


# ---------------------------------------------------------------------------
# Construction rules and options that are not ported
# ---------------------------------------------------------------------------
def test_batched_cuda_needs_streamed_noise_for_k2_and_rings():
    with pytest.raises(ValueError, match="streamed"):
        engine.make_batched_backend("cuda", n_bucket=NB, n_trials=4, noise="threefry",
                                    device="cpu", field_mode="popcount")
    with pytest.raises(ValueError, match="SSQA"):
        engine.make_batched_backend("cuda", n_bucket=NB, n_trials=4, noise="xorshift",
                                    noise_mode="pregen", n_replicas=2, device="cpu")
    bk = engine.make_batched_backend("cuda", n_bucket=NB, n_trials=4, noise="xorshift",
                                     noise_mode="pregen", device="cpu")
    with pytest.raises(ValueError, match="streamed"):
        bk._plateau({}, None, engine.Plateau(4, 2, True, 1))


# Spin sharding and backend='auto' are ported since: partition='spin' builds
# the spin-sharded backend (a one-rank mesh), 'auto' without a mesh of
# several ranks stays problem-partitioned, and backend='auto' resolves over
# the bucket by the port's MIN_RESIDENT_N (ids kept).
@pytest.mark.parametrize("kw,item", [
    (dict(backend="auto"), "cuda" if NB >= engine.MIN_RESIDENT_N else "dense"),
    (dict(partition="spin"), "spinshard"),
    (dict(partition="auto"), "sparse"),
], ids=["{'backend': 'auto'}-step 3", "{'partition': 'spin'}-step 8",
        "{'partition': 'auto'}-step 8"])
def test_make_batched_backend_not_ported(kw, item):
    bk = engine.make_batched_backend(n_bucket=NB, n_trials=2, device="cpu", **kw)
    assert bk.name == item


def test_make_batched_backend_config_and_errors():
    cfg = SolverConfig(backend="cuda", field_mode="popcount", storage_layout="packed",
                       backend_opts={"j_bits": 2})
    bk = engine.make_batched_backend(config=cfg, n_bucket=NB, n_trials=4, device="cpu")
    assert isinstance(bk, engine.BatchedCudaBackend)
    assert (bk.field_mode, bk.j_bits, bk.storage_layout, bk.noise) == (
        "popcount", 2, "packed", "xorshift")
    assert engine.make_batched_backend(n_bucket=NB, n_trials=2, device="cpu").name == "sparse"
    with pytest.raises(ValueError, match="unknown batched backend"):
        engine.make_batched_backend("pallas", n_bucket=NB, n_trials=2, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        engine.make_batched_backend(n_bucket=NB, n_trials=6, n_replicas=4, device="cpu")
    assert set(engine.BATCHED_BACKENDS) == {"sparse", "dense", "cuda"}


def test_batched_dense_tiles_above_threshold():
    bk = engine.make_batched_backend("dense", n_bucket=8192, n_trials=2, device="cpu")
    assert bk.j_mode == "tiled"
    big = gset.toroidal_grid(4200, seed=0).to_ising()
    prob = bk.stack([big])
    assert "J" not in prob and prob["nbr_idx"].shape == (1, 8192, 4)


@pytest.mark.parametrize("opts", [{}, {"noise_mode": "pregen"}, {"field_mode": "popcount"}],
                         ids=["k1", "k4", "k2"])
def test_batched_launch_counters_on_cpu(opts):
    """On CPU tensors the wrappers run their plain versions: no launch."""
    wrappers = (ssa_update.ssa_plateau_packed_batched, ssa_update.ssa_plateau_batched,
                ssa_update.ssa_plateau_popcount_batched)
    before = [w.launches for w in wrappers]
    bk = engine.make_batched_backend("cuda", n_bucket=NB, n_trials=4, device="cpu", **opts)
    probs = _problems(gset)
    prob = bk.stack([p.to_ising() for p in probs])
    st = bk.init_state(prob, bk.init_noise(SEEDS, [p.n for p in probs]))
    bk.run_shots(prob, st, engine.schedule_plateaus(tssa.SSAHyperParams(**HP).schedule()), 1)
    assert [w.launches for w in wrappers] == before
