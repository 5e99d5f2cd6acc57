"""The port's kernel modules against the JAX package's Pallas kernels.

On CPU tensors the wrappers of ``repro_torch.kernels.ssa_update`` run their
plain versions; those are held bit for bit against the Pallas kernels run
in interpret mode, as ``tests/test_kernels.py`` runs them.  The CUDA
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.  K4's plain version is also held against the
JAX package's own plain version, ``repro.kernels.ref.ssa_plateau_ref``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import rng as jrng  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.kernels import bitplane as jbitplane  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssa_update as jssa  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.core.engine import EngineState, PackedEngineState  # noqa: E402
from repro_torch.kernels import ops, ssa_update  # noqa: E402

OUTS = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")


def _coupling(rs, n):
    J = np.triu(rs.integers(-3, 4, size=(n, n)), 1)
    return J + J.T


@pytest.mark.parametrize("r,n", [(1, 16), (3, 36), (9, 100), (17, 160)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_field_plain_matches_pallas(r, n, dtype):
    rs = np.random.default_rng(r * 1000 + n)
    J = _coupling(rs, n)
    h = rs.integers(-4, 5, size=(n,)).astype(np.int32)
    m = rs.choice([-1.0, 1.0], size=(r, n)).astype(np.float32)
    want = jssa.local_field(jnp.asarray(m), jnp.asarray(h), jnp.asarray(J, getattr(jnp, dtype)),
                            block_r=4, block_n=32, block_k=32)
    Jt = torch.as_tensor(J, dtype=getattr(torch, dtype))
    for mt in (torch.from_numpy(m), torch.from_numpy(m.astype(np.int8))):
        got = ops.local_field(mt, torch.from_numpy(h), Jt)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _contract_coupling(rs, n, kind):
    """Integer J over K3's exactness contract (every |J| and every partial
    sum of m @ J below 2^24): the ranges the CUDA kernel's byte planes must
    hold (one s8 plane up to 127, two up to 2^15, three up to 2^23)."""
    if kind == "mixed":  # tiles of one, two and three planes in one J
        J = rs.integers(-1, 2, size=(n, n))
        J[64:128, 128:256] = rs.integers(-4096, 4097, size=(64, 128))
        for c in range(256, n):
            J[192 + c % 64, c] = rs.integers(-(2**20), 2**20)
        return J
    if kind == "bf16":  # large integers a bfloat16 holds: 8 significant bits
        return rs.integers(-255, 256, size=(n, n)) * 2 ** rs.integers(0, 9, size=(n, n))
    return rs.integers(-kind, kind + 1, size=(n, n))


@pytest.mark.parametrize("r,n,kind,dtype", [
    (5, 64, 127, "float32"),          # one s8 plane
    (16, 128, 127, "bfloat16"),
    (13, 1000, 2**13, "float32"),     # two planes, ragged R and N
    (9, 200, "bf16", "bfloat16"),
    (7, 97, 2**13, "float32"),
    (3, 16, 2**20 - 1, "float32"),    # three planes
    (17, 33, 2**15, "float32"),
    (11, 300, "mixed", "float32"),    # planes mixed between tiles
    (6, 128, "bf16", "bfloat16"),     # bfloat16 J with large integers
])
def test_local_field_plain_matches_pallas_over_contract(r, n, kind, dtype):
    rs = np.random.default_rng(n + r)
    J = _contract_coupling(rs, n, kind)
    h = rs.integers(-4, 5, size=(n,)).astype(np.int32)
    m = rs.choice([-1.0, 1.0], size=(r, n)).astype(np.float32)
    assert (np.abs(J).sum(axis=0) + 4 < 2**24).all()  # inside the contract
    want = jssa.local_field(jnp.asarray(m), jnp.asarray(h),
                            jnp.asarray(J.astype(np.float32), getattr(jnp, dtype)),
                            block_r=8, block_n=128, block_k=128)
    got = ssa_update.local_field(torch.from_numpy(m), torch.from_numpy(h),
                                 torch.as_tensor(J.astype(np.float32),
                                                 dtype=getattr(torch, dtype)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = m.astype(np.int64) @ J.astype(np.int64) + h
    np.testing.assert_array_equal(got.numpy(), exact)


def _plateau_case(r, n, seed, flat=False):
    """Random plateau inputs; ``flat`` zeroes J and h, so every state has
    H = 0 and only keeping the first minimum (strict <) gives JAX's best."""
    rs = np.random.default_rng(seed)
    J = _coupling(rs, n).astype(np.float32) * (not flat)
    h = rs.integers(-2, 3, size=(n,)).astype(np.int32) * (not flat)
    m = rs.choice([-1, 1], size=(r, n)).astype(np.int8)
    bm = rs.choice([-1, 1], size=(r, n)).astype(np.int8)
    itanh = rs.integers(-6, 6, size=(r, n)).astype(np.int32)
    lanes = np.asarray(jrng.xorshift_init(seed, (r, n)))
    best_H = np.full((r,), 2**30, np.int32)
    best_H[0] = -10**6  # a trial whose best cannot improve keeps its words
    return dict(J=J, h=h, m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(m))),
                itanh=itanh, rng=lanes, best_H=best_H,
                best_m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(bm))))


def _torch_args(case):
    f = convert._as_i32
    return dict(m_packed=f(case["m_packed"], "cpu"), itanh=f(case["itanh"], "cpu"),
                J=torch.from_numpy(case["J"]), h=f(case["h"], "cpu"),
                rng=f(case["rng"], "cpu"), best_H=f(case["best_H"], "cpu"),
                best_m_packed=f(case["best_m_packed"], "cpu"))


@pytest.mark.parametrize("r,n,c,flat", [(4, 36, 5, False), (9, 100, 7, False),
                                         (3, 160, 3, False), (2, 33, 12, False),
                                         (3, 40, 6, True)])
@pytest.mark.parametrize("eligible", [True, False])
def test_plateau_plain_matches_pallas(r, n, c, flat, eligible):
    case = _plateau_case(r, n, seed=r + n + c, flat=flat)
    i0 = 4
    want = jssa.ssa_plateau_packed(
        *(jnp.asarray(case[k]) for k in ("m_packed", "itanh", "J", "h", "rng")),
        jnp.int32(i0), jnp.asarray(case["best_H"]), jnp.asarray(case["best_m_packed"]),
        n_cycles=c, n_rnd=2, eligible=eligible, block_r=8,
    )
    before = ssa_update.ssa_plateau_packed_batched.launches
    got = ssa_update.ssa_plateau_packed(**_torch_args(case), i0=i0, n_cycles=c,
                                        n_rnd=2, eligible=eligible)
    assert ssa_update.ssa_plateau_packed_batched.launches == before  # plain path
    for name, g, w in zip(OUTS, got, want):
        w = np.asarray(w)
        g = g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_plateau_batched_equals_per_problem():
    cases = [_plateau_case(3, 40, seed=s) for s in (1, 2)]
    args = [_torch_args(c) for c in cases]
    stacked = {k: torch.stack([a[k] for a in args]) for k in args[0]}
    outs = ssa_update.ssa_plateau_packed_batched(**stacked, i0=2, n_cycles=6, eligible=True)
    for b, a in enumerate(args):
        single = ssa_update.ssa_plateau_packed(**a, i0=2, n_cycles=6, eligible=True)
        for name, o, s in zip(OUTS, outs, single):
            assert torch.equal(o[b], s), name


def test_wrappers_reject_mixed_devices():
    x = torch.zeros((2, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="different devices"):
        ssa_update.local_field(x, torch.zeros(4, dtype=torch.int32, device="meta"),
                               torch.zeros((4, 4)))


def test_convert_round_trips_engine_states():
    case = _plateau_case(3, 37, seed=9)
    m = np.asarray(jbitplane.unpack_spins(jnp.asarray(case["m_packed"]), 37))
    for packed in (False, True):
        spins = (case["m_packed"], case["best_m_packed"]) if packed else (m, m)
        st = convert.engine_state_from_arrays(case["rng"], spins[0], case["itanh"],
                                              case["best_H"], spins[1], packed=packed)
        assert isinstance(st, PackedEngineState if packed else EngineState)
        back = convert.engine_state_to_arrays(st)
        for a, b in zip(back, (case["rng"], spins[0], case["itanh"], case["best_H"], spins[1])):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# ---------------------------------------------------------------------------
# K4: the pregenerated-noise plateau
# ---------------------------------------------------------------------------
K4_OUTS = ("m", "itanh", "best_H", "best_m")


def _pregen_case(b, r, n, c, seed, flat=False):
    """Random (B, ...) inputs of K4; ``flat`` zeroes J and h, so every
    state ties at H = 0 and only the first minimum (strict <) matches."""
    rs = np.random.default_rng(seed)
    best_H = np.full((b, r), 2**30, np.int32)
    best_H[:, 0] = -10**6  # a trial whose best cannot improve keeps its spins
    return dict(
        m=rs.choice([-1.0, 1.0], size=(b, r, n)).astype(np.float32),
        itanh=rs.integers(-6, 6, size=(b, r, n)).astype(np.int32),
        J=np.stack([_coupling(rs, n) for _ in range(b)]).astype(np.float32) * (not flat),
        h=rs.integers(-2, 3, size=(b, n)).astype(np.int32) * (not flat),
        noise=rs.choice([-1, 1], size=(b, c, r, n)).astype(np.int8),
        best_H=best_H,
        best_m=rs.choice([-1, 1], size=(b, r, n)).astype(np.int8),
    )


@pytest.mark.parametrize("b,r,n,c,flat,dtype", [
    (1, 4, 36, 5, False, "float32"),
    (1, 9, 100, 7, False, "float32"),
    (1, 3, 161, 3, False, "bfloat16"),
    (1, 5, 40, 6, True, "float32"),
    (2, 3, 33, 4, False, "float32"),
    (1, 13, 101, 2, False, "float32"),
])
@pytest.mark.parametrize("eligible", [True, False])
def test_pregen_plateau_plain_matches_pallas_and_ref(b, r, n, c, flat, dtype, eligible):
    case = _pregen_case(b, r, n, c, seed=b + r + n + c, flat=flat)
    i0 = 4
    jx = {k: jnp.asarray(v) for k, v in case.items()}
    jx["J"] = jx["J"].astype(getattr(jnp, dtype))
    want = jssa.ssa_plateau_batched(
        jx["m"], jx["itanh"], jx["J"], jx["h"], jx["noise"], jnp.int32(i0),
        jx["best_H"], jx["best_m"], n_rnd=2, eligible=eligible, block_r=8,
    )
    args = {k: torch.from_numpy(v) for k, v in case.items()}
    args["J"] = args["J"].to(getattr(torch, dtype))
    before = ssa_update.ssa_plateau_batched.launches
    got = ssa_update.ssa_plateau_batched(**args, i0=i0, n_rnd=2, eligible=eligible)
    assert ssa_update.ssa_plateau_batched.launches == before  # plain path
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.int32, torch.int8]
    for name, g, w in zip(K4_OUTS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for k in range(b):  # the JAX package's own plain version, per problem
        ref = jref.ssa_plateau_ref(*(jx[key][k] for key in ("m", "itanh", "J", "h", "noise")),
                                   i0, jx["best_H"][k], jx["best_m"][k],
                                   n_rnd=2, eligible=eligible)
        for name, g, w in zip(K4_OUTS, got, ref):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w), err_msg=name)


def test_pregen_plateau_b1_slice_equals_batched():
    case = {k: torch.from_numpy(v) for k, v in _pregen_case(2, 3, 40, 5, seed=4).items()}
    outs = ssa_update.ssa_plateau_batched(**case, i0=2, eligible=True)
    for k in range(2):
        single = ssa_update.ssa_plateau(**{key: v[k] for key, v in case.items()},
                                        i0=2, eligible=True)
        for name, o, s in zip(K4_OUTS, outs, single):
            assert torch.equal(o[k], s), name


@pytest.mark.parametrize("storage", ["i0max", "all"])
def test_anneal_resident_matches_jax(storage):
    rs = np.random.default_rng(11)
    n = 48
    J = _coupling(rs, n).astype(np.float32)
    h = rs.integers(-2, 3, size=(n,)).astype(np.int32)
    kw = dict(m_shot=2, n_trials=5, n_rnd=2, storage=storage, seed=3)
    want = jops.anneal_resident(jnp.asarray(J), jnp.asarray(h),
                                jschedule.hassa_schedule(1, 8, 4, 1), block_r=8, **kw)
    before = ssa_update.ssa_plateau_batched.launches
    got = ops.anneal_resident(torch.from_numpy(J), torch.from_numpy(h),
                              schedule.hassa_schedule(1, 8, 4, 1), **kw)
    assert ssa_update.ssa_plateau_batched.launches == before  # plain path on the CPU
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
