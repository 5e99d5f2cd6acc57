"""``j_dtype`` of the port against the JAX package's, on the CPU.

``j_dtype=torch.bfloat16`` against the JAX package's ``jnp.bfloat16``: J is
rounded to nearest even and held so; the fields are float32 m @ float32(J).
On ±1 weights (exact in bfloat16) and on number partitioning's weights (up
to 4606 at 24 numbers, which bfloat16 rounds), through the dense and cuda
backends (the cuda backend's K1, K3 and K4 as their plain versions), single
and batched, with the trace path and threefry pregen, the service and the
stream, and the fallback chain that carries it.  The tolerance everywhere
is bit-identity.  The other dtypes the JAX package runs (float16, int8,
uint8, int16, int32) go through the dense and the cuda backend alike, and
through K1, K1's ring mode, K3 and K4 (their plain versions).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SolverConfig as JSolverConfig  # noqa: E402
from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.problems import make_demo as jmake_demo  # noqa: E402
from repro.serve import AnnealRequest as JRequest  # noqa: E402
from repro.serve import AnnealService as JService  # noqa: E402
from repro.serve import resilience as jres  # noqa: E402
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams, anneal  # noqa: E402
from repro_torch.problems import make_demo  # noqa: E402
from repro_torch.serve import AnnealRequest, AnnealService  # noqa: E402
from repro_torch.serve import StreamingAnnealService, StreamPolicy  # noqa: E402
from repro_torch.serve import resilience  # noqa: E402

HP = dict(n_trials=3, m_shot=2, tau=4, i0_min=1, i0_max=8)
JBACKEND = {"dense": "dense", "cuda": "pallas"}


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
# j_dtype
# ---------------------------------------------------------------------------
def _weights(kind, g_or_make):
    if kind == "pm1":
        return g_or_make.toroidal_grid(36, seed=4).to_ising()
    return g_or_make("partition", n=24, seed=0).model


def _model(kind, jax=False):
    return _weights(kind, (jgset if kind == "pm1" else jmake_demo) if jax
                    else (gset if kind == "pm1" else make_demo))


# (port backend, noise, track_energy): K1, K1 with the trace path (K3), K4
# under threefry pregen, and the dense backend with each.
SINGLE = [("dense", "xorshift", False), ("dense", "threefry", True),
          ("cuda", "xorshift", False), ("cuda", "xorshift", True), ("cuda", "threefry", False)]


@functools.lru_cache(maxsize=None)
def _jax_single(kind, backend, noise, track_energy, dtype="bfloat16"):
    return janneal(_model(kind, jax=True), JHP(**HP), seed=1, track_energy=track_energy,
                   config=JSolverConfig(backend=JBACKEND[backend], noise=noise,
                                        backend_opts={"j_dtype": getattr(jnp, dtype)}))


@pytest.mark.parametrize("kind", ["pm1", "partition"])
@pytest.mark.parametrize("backend,noise,track_energy", SINGLE,
                         ids=lambda v: str(v) if not isinstance(v, bool) else
                         ("trace" if v else "best"))
def test_j_dtype_bfloat16_anneal_matches_jax(kind, backend, noise, track_energy):
    got = anneal(_model(kind), SSAHyperParams(**HP), seed=1, track_energy=track_energy,
                 device="cpu", config=SolverConfig(
                     backend=backend, noise=noise, backend_opts={"j_dtype": torch.bfloat16}))
    _assert_result_equal(got, _jax_single(kind, backend, noise, track_energy),
                         traces=track_energy)


def test_j_dtype_bfloat16_rounds_partition_weights():
    """Partition's J is not exact in bfloat16: the held J is the rounded one
    (the JAX package's rounding), and it anneals to other energies than the
    float32 J."""
    model = _model("partition")
    bk = engine.make_backend("cuda", model, n_trials=3, noise="xorshift", device="cpu",
                             j_dtype=torch.bfloat16)
    jbk = jengine.make_backend("pallas", _model("partition", jax=True), n_trials=3,
                               noise="xorshift", j_dtype=jnp.bfloat16)
    assert bk.J.dtype == torch.bfloat16
    np.testing.assert_array_equal(bk.J.float().numpy(), np.asarray(jbk.J, np.float32))
    assert not np.array_equal(bk.J.float().numpy(), model.dense_J())
    hp = SSAHyperParams(**HP)
    cfg = dict(backend="cuda", noise="xorshift")
    f32 = anneal(model, hp, seed=1, device="cpu", config=SolverConfig(**cfg))
    bf16 = anneal(model, hp, seed=1, device="cpu", config=SolverConfig(
        **cfg, backend_opts={"j_dtype": torch.bfloat16}))
    assert not np.array_equal(f32.best_energy, bf16.best_energy)


@pytest.mark.parametrize("kind", ["pm1", "partition"])
@pytest.mark.parametrize("backend,opts", [("dense", {}), ("cuda", {}),
                                          ("cuda", {"noise_mode": "pregen"})],
                         ids=["dense", "cuda-K1", "cuda-K4"])
def test_j_dtype_bfloat16_batched_matches_jax(kind, backend, opts):
    models = [_model(kind), gset.toroidal_grid(20, seed=2).to_ising()]
    jmodels = [_model(kind, jax=True), jgset.toroidal_grid(20, seed=2).to_ising()]
    nb = 64
    bk = engine.make_batched_backend(backend, n_bucket=nb, n_trials=3, noise="xorshift",
                                     device="cpu", j_dtype=torch.bfloat16, **opts)
    jbk = jengine.make_batched_backend(JBACKEND[backend], n_bucket=nb, n_trials=3,
                                       noise="xorshift", j_dtype=jnp.bfloat16, **opts)
    prob, jprob = bk.stack(models), jbk.stack(jmodels)
    assert prob["J"].dtype == torch.bfloat16
    np.testing.assert_array_equal(prob["J"].float().numpy(), np.asarray(jprob["J"], np.float32))
    sizes = [m.n for m in models]
    st = bk.init_state(prob, bk.init_noise((5, 6), sizes))
    jst = jbk.init_state(jprob, jbk.init_noise((5, 6), sizes))
    plateaus = engine.schedule_plateaus(SSAHyperParams(**HP).schedule(), "i0max")
    _assert_state_equal(bk.run_shots(prob, st, plateaus, 2),
                        jbk.run_shots(jprob, jst, plateaus, 2))


def _jdtype_requests(jax):
    Req, Hp = (JRequest, JHP) if jax else (AnnealRequest, SSAHyperParams)
    return [Req(problem=_model("partition", jax), hp=Hp(**HP), seed=0),
            Req(problem=_model("pm1", jax), hp=Hp(**HP), seed=1)]


@functools.lru_cache(maxsize=None)
def _jax_jdtype_service():
    return JService(backend="dense", noise="xorshift", min_bucket=16,
                    backend_opts={"j_dtype": jnp.bfloat16}).solve(_jdtype_requests(True))


def test_j_dtype_bfloat16_service_and_stream_match_jax():
    """The service's stacked J and a stream's slot tables and seats hold J
    in bfloat16; both equal the JAX service with a jnp.bfloat16 J."""
    opts = {"j_dtype": torch.bfloat16}
    svc = AnnealService(backend="cuda", noise="xorshift", min_bucket=16, backend_opts=opts,
                        device="cpu")
    want = _jax_jdtype_service()
    for g, w in zip(svc.solve(_jdtype_requests(False)), want):
        _assert_result_equal(g.result, w.result, traces=False)
    ss = StreamingAnnealService(service=AnnealService(
        backend="cuda", noise="xorshift", min_bucket=16, backend_opts=opts, device="cpu"),
        policy=StreamPolicy(slots_per_table=1))
    tickets = [ss.submit(r) for r in _jdtype_requests(False)]
    ss.run_until_idle()
    for t, w in zip(tickets, want):
        _assert_result_equal(t.result(timeout=0).result, w.result, traces=False)


def test_fallback_chain_carries_j_dtype():
    """cuda → dense keeps j_dtype (as the JAX package's pallas → dense);
    dense J → tiled J keeps it too, and the tiled field ignores it."""
    opts = {"j_dtype": torch.bfloat16, "noise_mode": "streamed", "field_mode": "dense"}
    jopts = dict(opts, j_dtype=jnp.bfloat16)
    got = resilience.fallback_step("cuda", opts, "compile", 64)
    want = jres.fallback_step("pallas", jopts, "compile", 64)
    assert got[0] == want[0] == "dense" and set(got[1]) == set(want[1])
    assert got[1]["j_dtype"] is torch.bfloat16
    got = resilience.fallback_step("dense", got[1], "oom", 64)
    want = jres.fallback_step("dense", want[1], "oom", 64)
    assert got[0] == want[0] == "dense" and got[1] == {**got[1], "j_mode": "tiled"}
    assert set(got[1]) == set(want[1]) and got[1]["j_dtype"] is torch.bfloat16
    bk = engine.make_batched_backend("dense", n_bucket=64, n_trials=2, device="cpu", **got[1])
    assert bk.j_mode == "tiled"


# The dtypes beside float32 and bfloat16; the integer ones wrap (int8,
# uint8) or hold (int16, int32) partition's 13-bit weights.
OTHER_DTYPES = ["float16", "int8", "uint8", "int16", "int32"]


@pytest.mark.parametrize("dtype", OTHER_DTYPES)
def test_j_dtype_other_dtypes_on_dense_match_jax(dtype):
    """The dense and the cuda backend take every dtype the JAX package runs
    (J rounded or wrapped into it as jnp.asarray does); 'cuda' and 'auto'
    (cuda at 24 spins: K1, and K3 for the final fold) equal the JAX
    package's pallas run, and the dense backend its dense run.  With a
    uint8 J the JAX package's K3 wrapper casts the spins to uint8 (-1 to
    255, src/repro/kernels/ssa_update.py:124), so its pallas run differs
    from its own dense one; the port's K3 reads the spins as ±1 and every
    port backend equals the JAX dense run there."""
    model = _model("partition")
    cfg = dict(noise="xorshift", backend_opts={"j_dtype": getattr(torch, dtype)})
    got = anneal(model, SSAHyperParams(**HP), seed=1, device="cpu", track_energy=False,
                 config=SolverConfig(backend="dense", **cfg))
    dense = _jax_single("partition", "dense", "xorshift", False, dtype)
    _assert_result_equal(got, dense, traces=False)
    want = dense if dtype == "uint8" else _jax_single("partition", "cuda", "xorshift", False,
                                                      dtype)
    assert engine.resolve_backend("auto", model.n) == "cuda"
    for backend in ("cuda", "auto"):
        got = anneal(model, SSAHyperParams(**HP), seed=1, device="cpu", track_energy=False,
                     config=SolverConfig(backend=backend, **cfg))
        _assert_result_equal(got, want, traces=False)
    bk = engine.make_batched_backend("cuda", n_bucket=32, n_trials=2, device="cpu",
                                     j_dtype=getattr(torch, dtype))
    assert bk.j_dtype == getattr(torch, dtype)


def _dtype_j(rs, n, dtype):
    """Partition-like 13-bit symmetric weights (±4095) in ``dtype``, rounded
    or wrapped as the hosts of both packages hold them, and the same J as
    the JAX side's array."""
    J = np.triu(rs.integers(-4095, 4096, size=(n, n)), 1)
    J = J + J.T
    Jt = torch.from_numpy(J).to(getattr(torch, dtype))
    Jj = jnp.asarray(J, getattr(jnp, dtype))
    np.testing.assert_array_equal(Jt.float().numpy(), np.asarray(Jj, np.float32))
    return Jt, Jj


@pytest.mark.parametrize("dtype", OTHER_DTYPES)
def test_j_dtype_kernel_wrappers_match_jax(dtype):
    """K3, K1, K1's ring mode and K4 with J in each dtype (the wrappers' plain
    versions on the CPU) against the JAX wrappers in interpret mode with
    the same J.  K3 with a uint8 J is held against the JAX package's plain
    field (``repro.kernels.ref.local_field_ref``): its Pallas wrapper casts
    the spins to uint8 (see above)."""
    from repro.kernels import bitplane as jbitplane
    from repro.kernels import ref as jref
    from repro.kernels import ssa_update as jssa
    from repro_torch.core.rng import xorshift_init
    from repro_torch.kernels import ssa_update

    rs = np.random.default_rng(OTHER_DTYPES.index(dtype))
    r, n, c = 8, 40, 3
    Jt, Jj = _dtype_j(rs, n, dtype)
    m = rs.choice([-1.0, 1.0], size=(r, n)).astype(np.float32)
    h = rs.integers(-3, 4, size=n).astype(np.int32)
    # K3
    got = ssa_update.local_field(torch.from_numpy(m), torch.from_numpy(h), Jt)
    jfield = jref.local_field_ref if dtype == "uint8" else jssa.local_field
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfield(jnp.asarray(m),
                                                                 jnp.asarray(h), Jj)))
    # K1, classical and ring mode (rings of 4)
    spins = rs.choice([-1, 1], size=(2, 1, r, n)).astype(np.int8)
    case = dict(m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(spins[0]))),
                itanh=rs.integers(-6, 6, size=(1, r, n)).astype(np.int32),
                h=h[None], rng=np.asarray(xorshift_init(5, (r, n), "cpu"))[None],
                best_H=np.full((1, r), 2**30, np.int32),
                best_m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(spins[1]))))
    tc = {k: torch.from_numpy(v.view(np.int32).copy() if v.dtype == np.uint32 else v)
          for k, v in case.items()}
    for kw in (dict(), dict(jperp=3, n_replicas=4)):
        want = jssa.ssa_plateau_packed_batched(
            jnp.asarray(case["m_packed"]), jnp.asarray(case["itanh"]), Jj[None],
            jnp.asarray(case["h"]), jnp.asarray(case["rng"]), jnp.int32(8),
            jnp.asarray(case["best_H"]), jnp.asarray(case["best_m_packed"]), n_cycles=c,
            n_rnd=2, eligible=True, block_r=kw.get("n_replicas", 8), **kw)
        got = ssa_update.ssa_plateau_packed_batched(**tc, J=Jt[None], i0=8, n_cycles=c,
                                                    n_rnd=2, eligible=True, **kw)
        for name, g, w in zip(("m_packed", "itanh", "rng", "best_H", "best_m_packed"),
                              got, want):
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{kw} {name}")
    # K4
    k4 = dict(m=spins[0].astype(np.float32), itanh=case["itanh"], h=case["h"],
              noise=rs.choice([-1, 1], size=(1, c, r, n)).astype(np.int8),
              best_H=case["best_H"], best_m=spins[1])
    want = jssa.ssa_plateau_batched(
        jnp.asarray(k4["m"]), jnp.asarray(k4["itanh"]), Jj[None], jnp.asarray(k4["h"]),
        jnp.asarray(k4["noise"]), jnp.int32(8), jnp.asarray(k4["best_H"]),
        jnp.asarray(k4["best_m"]), n_rnd=2, eligible=True, block_r=8)
    got = ssa_update.ssa_plateau_batched(**{k: torch.from_numpy(v) for k, v in k4.items()},
                                         J=Jt[None], i0=8, n_rnd=2, eligible=True)
    for name, g, w in zip(("m", "itanh", "best_H", "best_m"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_j_dtype_keeps_the_exactness_contract():
    """Rounding may raise a weight: a J whose bfloat16 rows reach 2^24 is
    refused (the float32 fields would no longer be exact), the float32 J
    of the same model is taken."""
    from repro_torch.core.ising import IsingModel

    w = (1 << 23) - 1  # rounds up to 2^23 in bfloat16
    J = np.zeros((3, 3), np.int64)
    J[0, 1] = J[1, 0] = J[0, 2] = J[2, 0] = -w
    model = IsingModel.from_dense(J)
    engine.make_backend("dense", model, n_trials=1, device="cpu")
    for backend in ("dense", "cuda"):
        with pytest.raises(ValueError, match="float32-exact"):
            engine.make_backend(backend, model, n_trials=1, device="cpu",
                                j_dtype=torch.bfloat16)


def test_popcount_and_tiled_ignore_j_dtype():
    model = gset.toroidal_grid(36, seed=1).to_ising()
    bk = engine.make_backend("cuda", model, n_trials=2, device="cpu", noise="xorshift",
                             field_mode="popcount", j_dtype=torch.float16)
    assert not hasattr(bk, "J")
    bk = engine.make_batched_backend("dense", n_bucket=64, n_trials=2, device="cpu",
                                     j_mode="tiled", j_dtype=torch.float16)
    assert bk.j_dtype == torch.float32


def test_j_dtype_64_bit_is_held_in_32_bits():
    """A 64-bit j_dtype is held in 32 bits, as jax holds it with its 64-bit
    types off; float64 therefore runs on the cuda backend too."""
    model = _model("partition")
    got = anneal(model, SSAHyperParams(**HP), seed=1, device="cpu", track_energy=False,
                 config=SolverConfig(backend="cuda", noise="xorshift",
                                     backend_opts={"j_dtype": torch.float64}))
    _assert_result_equal(got, _jax_single("partition", "dense", "xorshift", False, "float64"),
                         traces=False)
    bk = engine.make_backend("dense", model, n_trials=2, device="cpu", j_dtype=torch.int64)
    assert bk.J.dtype == torch.int32

