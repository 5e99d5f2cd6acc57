"""``j_dtype`` of the port against the JAX package's, on the CPU.

``j_dtype=torch.bfloat16`` against the JAX package's ``jnp.bfloat16``: J is
rounded to nearest even and held so; the fields are float32 m @ float32(J).
On ±1 weights (exact in bfloat16) and on number partitioning's weights (up
to 4606 at 24 numbers, which bfloat16 rounds), through the dense and cuda
backends (the cuda backend's K1, K3 and K4 as their plain versions), single
and batched, with the trace path and threefry pregen, the service and the
stream, and the fallback chain that carries it.  The tolerance everywhere
is bit-identity.  The dense backend takes the other dtypes the JAX
package's dense backend runs; the cuda backend raises ValueError for them.
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


@pytest.mark.parametrize("dtype", ["float16", "int8", "int16"])
def test_j_dtype_other_dtypes_on_dense_match_jax(dtype):
    """The dense backend takes every dtype the JAX package's dense backend
    runs (rounded or wrapped into it as jnp.asarray does); the cuda backend
    raises ValueError naming the dtypes its kernels take."""
    model = _model("partition")
    got = anneal(model, SSAHyperParams(**HP), seed=1, device="cpu", track_energy=False,
                 config=SolverConfig(backend="dense", noise="xorshift",
                                     backend_opts={"j_dtype": getattr(torch, dtype)}))
    _assert_result_equal(got, _jax_single("partition", "dense", "xorshift", False, dtype),
                         traces=False)
    with pytest.raises(ValueError, match="torch.float32, torch.bfloat16"):
        engine.make_backend("cuda", model, n_trials=2, device="cpu",
                            j_dtype=getattr(torch, dtype))
    with pytest.raises(ValueError, match="torch.float32, torch.bfloat16"):
        engine.make_batched_backend("cuda", n_bucket=32, n_trials=2, device="cpu",
                                    j_dtype=getattr(torch, dtype))


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

