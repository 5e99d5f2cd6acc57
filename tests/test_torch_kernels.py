"""The port's kernel modules against the JAX package's Pallas kernels.

On CPU tensors the wrappers of ``repro_torch.kernels.ssa_update`` run their
plain versions; those are held bit for bit against the Pallas kernels run
in interpret mode, as ``tests/test_kernels.py`` runs them.  The CUDA
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import rng as jrng  # noqa: E402
from repro.kernels import bitplane as jbitplane  # noqa: E402
from repro.kernels import ssa_update as jssa  # noqa: E402
from repro_torch import convert  # noqa: E402
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
