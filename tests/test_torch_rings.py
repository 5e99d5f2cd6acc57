"""SSQA rings above 32 replicas in the port against the JAX package, on the
CPU.

A Trotter ring may hold any number of replicas that divides the trials, in
the JAX package and in the port alike.  Here: the ring modes of K1 and K2
(their plain versions, which the wrappers run on CPU tensors) against the
Pallas kernels in interpret mode at rings of 33, 64 and one ring of 100;
``anneal_ssqa`` on the cuda backend with 128 trials in rings of 64 under
both field modes against the JAX package's pallas backend; and the same
request through ``AnnealService(backend='auto')`` against the JAX
package's service.  Small sizes (N of 40-64), inputs from numpy seeds; the
tolerance is bit-identity (integer arithmetic throughout).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import SolverConfig as JSolverConfig  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.core import ssqa as jssqa  # noqa: E402
from repro.kernels import bitplane as jbitplane  # noqa: E402
from repro.kernels import ssa_update as jssa  # noqa: E402
from repro.serve import AnnealRequest as JRequest  # noqa: E402
from repro.serve import AnnealService as JService  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ssqa import SSQAHyperParams, anneal_ssqa  # noqa: E402
from repro_torch.kernels import ssa_update  # noqa: E402
from repro_torch.serve import AnnealRequest, AnnealService  # noqa: E402

OUTS = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")
K1_ORDER = ("m_packed", "itanh", "J", "h", "rng")
K2_ORDER = ("m_packed", "itanh", "sign", "mags", "base", "h", "rng", "i0_sched",
            "fold_sched", "best_H", "best_m_packed")
# (trials, replicas per ring, spins): two rings of 33 (a second word of one
# replica), two of 64 (two whole words), one of 100 (a ragged fourth word
# and a ragged last pass of 4).
RINGS = [(66, 33, 40), (128, 64, 48), (100, 100, 64)]


def _as_np(g, w):
    """A port output as numpy, words viewed as the JAX side's uint32."""
    w = np.asarray(w)
    return (g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()), w


def _torch_case(case):
    return {k: (torch.from_numpy(v) if v.dtype == np.float32 else convert._as_i32(v, "cpu"))
            for k, v in case.items()}


def _k1_case(r, n, seed):
    rs = np.random.default_rng(seed)
    J = np.triu(rs.integers(-3, 4, size=(1, n, n)), 1)
    J = (J + J.transpose(0, 2, 1)).astype(np.float32)
    spins = rs.choice([-1, 1], size=(2, 1, r, n)).astype(np.int8)
    best_H = np.full((1, r), 2**30, np.int32)
    best_H[:, 0] = -10**6  # a trial whose best cannot improve keeps its words
    return dict(
        m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(spins[0]))),
        itanh=rs.integers(-6, 6, size=(1, r, n)).astype(np.int32), J=J,
        h=rs.integers(-2, 3, size=(1, n)).astype(np.int32),
        rng=np.asarray(jrng.xorshift_init(seed, (r, n)))[None],
        best_H=best_H,
        best_m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(spins[1]))))


@pytest.mark.parametrize("r,nr,n", RINGS, ids=lambda v: str(v))
def test_k1_ring_above_32_replicas_matches_pallas(r, nr, n):
    case = _k1_case(r, n, seed=r + n)
    kw = dict(n_cycles=3, n_rnd=2, eligible=True)
    want = jssa.ssa_plateau_packed_batched(
        *(jnp.asarray(case[k]) for k in K1_ORDER), jnp.int32(8),
        jnp.asarray(case["best_H"]), jnp.asarray(case["best_m_packed"]),
        block_r=nr, jperp=3, n_replicas=nr, **kw)
    got = ssa_update.ssa_plateau_packed_batched(**_torch_case(case), i0=8, jperp=3,
                                                n_replicas=nr, **kw)
    for name, g, w in zip(OUTS, got, want):
        np.testing.assert_array_equal(*_as_np(g, w), err_msg=name)


@pytest.mark.parametrize("r,nr,n", RINGS, ids=lambda v: str(v))
def test_k2_ring_above_32_replicas_matches_pallas(r, nr, n):
    case = _k1_case(r, n, seed=7 * r + n)
    J = case.pop("J")[0]
    pj = jbitplane.pack_couplings(J, 2)  # weights up to 3: two magnitude planes
    case.update(sign=np.asarray(pj.sign)[None], mags=np.asarray(pj.mags)[None],
                base=np.asarray(pj.base)[None])
    sched = SSQAHyperParams(n_trials=r, n_replicas=nr, tau=2, i0_max=16,
                            jperp_max=5).schedule()
    i0, fold, jperp = engine.plateau_cycle_schedules(
        engine.tile_plateaus(engine.schedule_plateaus(sched), 8))
    assert jperp.any() and not jperp.all()  # a ramp that starts at 0
    case.update(i0_sched=i0, fold_sched=fold)
    want = jssa.ssa_plateau_popcount_batched(
        *(jnp.asarray(case[k]) for k in K2_ORDER), n_rnd=2, block_r=nr,
        jperp_sched=jnp.asarray(jperp), n_replicas=nr)
    tc = _torch_case(case)
    got = ssa_update.ssa_plateau_popcount_batched(
        *(tc[k] for k in K2_ORDER), n_rnd=2, jperp_sched=torch.from_numpy(jperp),
        n_replicas=nr)
    for name, g, w in zip(OUTS, got, want):
        np.testing.assert_array_equal(*_as_np(g, w), err_msg=name)


# ---------------------------------------------------------------------------
# anneal_ssqa and the service: 128 trials in rings of 64 on a 64-spin torus
# ---------------------------------------------------------------------------
HP = dict(n_trials=128, n_replicas=64, m_shot=1, tau=3, i0_max=4)


@functools.lru_cache(maxsize=None)
def _jax_ssqa(field_mode):
    return jssqa.anneal_ssqa(jgset.toroidal_grid(64, seed=0), jssqa.SSQAHyperParams(**HP),
                             seed=1, track_energy=False,
                             config=JSolverConfig(backend="pallas", noise="xorshift",
                                                  field_mode=field_mode))


def _assert_same(got, want):
    for k in ("best_energy", "best_m", "best_cut"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize("field_mode", ["dense", "popcount"])
@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_anneal_ssqa_rings_of_64_match_jax(backend, field_mode):
    """'cuda', and 'auto' (cuda at 64 spins), run the ring modes of K1 and
    K2 at rings of 64; both equal the JAX package's pallas run."""
    assert engine.resolve_backend(backend, 64) == "cuda"
    got = anneal_ssqa(gset.toroidal_grid(64, seed=0), SSQAHyperParams(**HP), seed=1,
                      track_energy=False, device="cpu",
                      config=SolverConfig(backend=backend, noise="xorshift",
                                          field_mode=field_mode))
    _assert_same(got, _jax_ssqa(field_mode))


def test_service_auto_rings_of_64_matches_jax():
    """The request through AnnealService(backend='auto') — the port's
    bucket 64 runs K1's ring mode, the JAX package's the dense backend —
    equals the JAX service's response and the one-shot run."""
    want = JService(backend="auto", noise="xorshift", min_bucket=16).solve(
        [JRequest(problem=jgset.toroidal_grid(64, seed=0), hp=jssqa.SSQAHyperParams(**HP),
                  seed=1)])
    assert jengine.resolve_backend("auto", 64) == "dense"
    got = AnnealService(backend="auto", noise="xorshift", min_bucket=16, device="cpu").solve(
        [AnnealRequest(problem=gset.toroidal_grid(64, seed=0), hp=SSQAHyperParams(**HP),
                       seed=1)])
    assert got[0].status == want[0].status == "ok" and got[0].bucket == 64
    _assert_same(got[0].result, want[0].result)
    _assert_same(got[0].result, _jax_ssqa("dense"))
