"""The port's tiled J against the JAX package's, on the CPU.

``local_fields_tiled`` streams (tile_n, N) float32 slabs scattered from the
padded adjacency and never holds (N, N).  From the same numpy seeds it must
equal the JAX package's ``local_fields_tiled`` and the port's dense field,
bit for bit (integer-valued float32, below 2^24): square and rectangular
(R rows ≠ N columns), with a ``tile_n`` that does not divide R, and with a
leading problem axis.  ``DenseBackend(j_mode='tiled')`` through ``anneal()``
must equal the JAX package's tiled dense backend.  ``j_dtype`` and
``double_buffer``, the JAX dense backend's other options, are taken.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import SolverConfig as JSolverConfig  # noqa: E402
from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core.ising import local_fields_tiled as jfields_tiled  # noqa: E402
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core import ssa as tssa  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ising import local_fields_dense, local_fields_tiled  # noqa: E402

HP = dict(n_trials=4, m_shot=2, tau=3, i0_min=1, i0_max=8)


def _adjacency(rs, n_rows, n_cols, deg):
    """Random padded adjacency of R rows into N columns, weights in ±1..±3
    and some zero-weight (padding) slots, with an h."""
    idx = rs.integers(0, n_cols, size=(n_rows, deg)).astype(np.int32)
    w = (rs.integers(1, 4, size=(n_rows, deg)) * rs.choice([-1, 1], (n_rows, deg)))
    w = np.where(rs.random((n_rows, deg)) < 0.2, 0, w).astype(np.int32)
    h = rs.integers(-3, 4, size=n_rows).astype(np.int32)
    return h, idx, w


# (R rows, N columns, degree, tile_n, trials): square, ragged last slab, one
# slab larger than R, rectangular (a row shard against all spins).
SHAPES = [(40, 40, 5, 16, 3), (40, 40, 5, 40, 2), (37, 37, 4, 64, 4),
          (24, 40, 6, 7, 3), (50, 33, 3, 9, 5)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "R{}xN{}-d{}-tile{}-T{}".format(*s))
def test_tiled_field_matches_jax_and_dense(shape):
    R, N, D, tile_n, T = shape
    rs = np.random.default_rng(R * 1000 + N + tile_n)
    h, idx, w = _adjacency(rs, R, N, D)
    m = rs.choice([-1, 1], size=(T, N)).astype(np.int32)
    got = local_fields_tiled(torch.from_numpy(m), torch.from_numpy(h), torch.from_numpy(idx),
                             torch.from_numpy(w), tile_n=tile_n)
    want = jfields_tiled(jnp.asarray(m), jnp.asarray(h), jnp.asarray(idx), jnp.asarray(w),
                         tile_n=tile_n)
    assert got.dtype == torch.int32 and got.shape == (T, R)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The dense J of the same (rectangular) adjacency: rows R, columns N.
    J = np.zeros((R, N), np.int64)
    np.add.at(J, (np.repeat(np.arange(R), D), idx.reshape(-1)), w.reshape(-1))
    dense = local_fields_dense(torch.from_numpy(m), torch.from_numpy(h),
                               torch.from_numpy(J.T.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), dense.numpy())


def test_tiled_field_with_a_problem_axis():
    """Stacked adjacency (B, R, D) against spins (B, T, N): each problem's
    rows against its own spins, as the batched dense backend calls it."""
    rs = np.random.default_rng(5)
    B, N, D, T = 3, 36, 4, 4
    adj = [_adjacency(rs, N, N, D) for _ in range(B)]
    m = rs.choice([-1, 1], size=(B, T, N)).astype(np.int32)
    got = local_fields_tiled(
        torch.from_numpy(m), torch.from_numpy(np.stack([a[0] for a in adj]))[:, None],
        torch.from_numpy(np.stack([a[1] for a in adj])),
        torch.from_numpy(np.stack([a[2] for a in adj])), tile_n=10)
    for b, (h, idx, w) in enumerate(adj):
        want = jfields_tiled(jnp.asarray(m[b]), jnp.asarray(h), jnp.asarray(idx),
                             jnp.asarray(w), tile_n=10)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_tiled_field_rejects_empty_tiles():
    h, idx, w = _adjacency(np.random.default_rng(0), 8, 8, 2)
    with pytest.raises(ValueError, match="tile_n"):
        local_fields_tiled(torch.ones(2, 8), torch.from_numpy(h), torch.from_numpy(idx),
                           torch.from_numpy(w), tile_n=0)


@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("track_energy", [False, True])
def test_dense_backend_tiled_matches_jax(layout, track_energy):
    """``anneal()`` on the dense backend with tiled J (a ragged tile) equals
    the JAX package's tiled dense backend: best_H, best_m and the traces."""
    want = janneal(jgset.king_graph(49, seed=2), JHP(**HP), seed=3, track_energy=track_energy,
                   config=JSolverConfig(backend="dense", j_mode="tiled", noise="xorshift",
                                        storage_layout=layout, backend_opts={"tile_n": 20}))
    got = tssa.anneal(gset.king_graph(49, seed=2), tssa.SSAHyperParams(**HP), seed=3,
                      track_energy=track_energy, device="cpu",
                      config=SolverConfig(backend="dense", j_mode="tiled", noise="xorshift",
                                          storage_layout=layout, backend_opts={"tile_n": 20}))
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)
    if track_energy:
        np.testing.assert_array_equal(got.energy_min, want.energy_min)
        np.testing.assert_allclose(got.energy_mean, want.energy_mean, rtol=1e-6, atol=0)


def test_tiled_backend_holds_no_j_and_equals_dense():
    model = gset.toroidal_grid(64, seed=4).to_ising()
    tiled = engine.make_backend("dense", model, n_trials=3, device="cpu", noise="xorshift",
                                j_mode="tiled", tile_n=24)
    dense = engine.make_backend("dense", model, n_trials=3, device="cpu", noise="xorshift",
                                j_mode="dense")
    assert tiled.j_mode == "tiled" and not hasattr(tiled, "J") and tiled.tile_n == 24
    st_t = st_d = None
    for bk in (tiled, dense):
        st, _, _ = bk.run_plateau(bk.init_state(2), 4, length=5, eligible=True)
        st_t, st_d = (st, st_d) if bk is tiled else (st_t, st)
    for a, b in zip(st_t, st_d):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(j_dtype=torch.bfloat16), dict(double_buffer=True)],
                         ids=["j_dtype", "double_buffer"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_unported_dense_options_raise(kw, batched):
    """Both options are ported (they once raised): double_buffer builds each
    tiled slab ahead of the product, j_dtype is the held J's dtype; each
    case checks that the backend takes its option."""
    if batched:
        build = lambda: engine.make_batched_backend(  # noqa: E731
            "dense", n_bucket=64, n_trials=2, device="cpu", **kw)
    else:
        model = gset.toroidal_grid(16, seed=0).to_ising()
        build = lambda: engine.make_backend("dense", model, n_trials=2,  # noqa: E731
                                            device="cpu", **kw)
    bk = build()
    if "double_buffer" in kw:
        assert bk.double_buffer
    else:
        assert bk.j_dtype == torch.bfloat16 if batched else bk.J.dtype == torch.bfloat16


def test_j_mode_tiled_config_and_signature():
    """j_mode='tiled' is a ported option now, and SolverConfig's signature
    equals the JAX package's for the same options."""
    for kw in (dict(), dict(backend="dense", j_mode="tiled"),
               dict(backend="dense", field_mode="popcount", backend_opts={"tile_n": 64}),
               dict(noise="threefry", storage_layout="packed")):
        cfg = SolverConfig(**kw)
        assert cfg.signature() == JSolverConfig(**kw).signature()
        assert cfg.opts_dict() == dict(cfg.backend_opts)
    cfg = SolverConfig(backend="dense", j_mode="tiled")
    assert cfg.engine_opts()["j_mode"] == "tiled"
    assert cfg.replace(j_mode="dense").j_mode == "dense"
    assert cfg.replace(j_mode="dense").signature() != cfg.signature()
