"""The pregenerated-noise datapath of ``anneal()`` against the JAX package.

Threefry noise runs the pregen datapath on the resident backends: the
JAX package's ``pallas`` (kernel K4 in interpret mode) against the port's
``cuda`` (K4's plain version on the CPU), and the scan backends
dense/sparse against their counterparts — both storage layouts, ``record``
best and traj, ``track_energy`` on and off.  best_H, best_m, the trajectory
planes and the per-cycle minimum energy must be bit-identical;
``energy_mean`` is an f32 mean whose summation order differs between the
frameworks and is held to rtol 1e-6, as in ``tests/test_torch_anneal.py``.

Xorshift noise with ``noise_mode='pregen'`` must equal the streamed run in
both packages.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SolverConfig as JSolverConfig  # noqa: E402
from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core import memory as jmemory  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine, gset, memory  # noqa: E402
from repro_torch.core import ssa as tssa  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.kernels import ssa_update  # noqa: E402

HP = dict(n_trials=5, m_shot=2, tau=5, i0_min=1, i0_max=4)
PROBLEMS = {
    "K-like96": lambda g: g.complete_graph(96, seed=5),
    "G11-like128": lambda g: g.toroidal_grid(128, seed=3),
}
PORT_BACKEND = {"pallas": "cuda", "dense": "dense", "sparse": "sparse"}
RECORDS = [("best", False), ("best", True), ("traj", False)]


@functools.lru_cache(maxsize=None)
def _jax_run(problem, backend, layout, record, track_energy, noise="threefry",
             noise_mode="auto"):
    return janneal(
        PROBLEMS[problem](jgset), JHP(**HP), seed=2, record=record,
        track_energy=track_energy,
        config=JSolverConfig(backend=backend, noise=noise, noise_mode=noise_mode,
                             storage_layout=layout),
    )


def _port_run(problem, backend, layout, record, track_energy, noise="threefry",
              noise_mode="auto"):
    return tssa.anneal(
        PROBLEMS[problem](gset), tssa.SSAHyperParams(**HP), seed=2, record=record,
        track_energy=track_energy, device="cpu",
        config=SolverConfig(backend=backend, noise=noise, noise_mode=noise_mode,
                            storage_layout=layout),
    )


def _assert_same(got, want, track_energy):
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)
    np.testing.assert_array_equal(got.best_cut, want.best_cut)
    if want.traj is None:
        assert got.traj is None
    else:
        np.testing.assert_array_equal(got.traj, want.traj)
    if track_energy:
        np.testing.assert_array_equal(got.energy_min, want.energy_min)
        np.testing.assert_allclose(got.energy_mean, want.energy_mean, rtol=1e-6, atol=0)
    else:
        assert got.energy_min is None and got.energy_mean is None


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("jax_backend", sorted(PORT_BACKEND))
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("record,track_energy", RECORDS)
def test_anneal_threefry_matches_jax(problem, jax_backend, layout, record, track_energy):
    got = _port_run(problem, PORT_BACKEND[jax_backend], layout, record, track_energy)
    want = _jax_run(problem, jax_backend, layout, record, track_energy)
    _assert_same(got, want, track_energy)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_xorshift_pregen_equals_streamed(problem, layout):
    """Opt-in xorshift pregen (K4) == streamed (K1), in both packages."""
    runs = {mode: _port_run(problem, "cuda", layout, "best", False, "xorshift", mode)
            for mode in ("pregen", "streamed")}
    _assert_same(runs["pregen"], runs["streamed"], False)
    for mode in ("pregen", "streamed"):
        want = _jax_run(problem, "pallas", layout, "best", False, "xorshift", mode)
        _assert_same(runs[mode], want, False)


def test_noise_mode_resolution_matches_jax():
    for noise in ("xorshift", "threefry"):
        for mode in ("auto", "streamed", "pregen"):
            try:
                want = jengine.resolve_noise_mode(mode, noise)
            except ValueError:
                with pytest.raises(ValueError, match="requires noise='xorshift'"):
                    engine.resolve_noise_mode(mode, noise)
            else:
                assert engine.resolve_noise_mode(mode, noise) == want


def test_cuda_backend_pregen_on_cpu_launches_nothing():
    counters = (ssa_update.ssa_plateau_batched, ssa_update.ssa_plateau_packed_batched,
                ssa_update.local_field)
    before = [f.launches for f in counters]
    _port_run("K-like96", "cuda", "packed", "best", False)
    _port_run("K-like96", "cuda", "dense", "best", False, "xorshift", "pregen")
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("noise", ["xorshift", "threefry"])
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_state_bytes_match_jax(noise, layout):
    """tree_device_bytes of an engine state == the JAX package's, apart
    from the threefry key (two uint32 words there, host ints here)."""
    kw = dict(n_trials=6, noise=noise, storage_layout=layout)
    jbk = jengine.make_backend("dense", PROBLEMS["K-like96"](jgset).to_ising(), **kw)
    bk = engine.make_backend("dense", PROBLEMS["K-like96"](gset).to_ising(), device="cpu", **kw)
    want = jmemory.tree_device_bytes(jbk.init_state(0))
    got = memory.tree_device_bytes(bk.init_state(0))
    assert got == want - (8 if noise == "threefry" else 0)
    _, noise_buf = engine.CudaBackend(
        PROBLEMS["K-like96"](gset).to_ising(), device="cpu", **kw,
    )._pregen_noise(bk.init_state(0).noise_state, 7)
    assert memory.tree_device_bytes({"noise": [noise_buf]}) == 7 * 6 * 96


def test_measured_bytes_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        memory.live_device_bytes()


def test_convert_round_trips_threefry_state():
    bk = engine.make_backend("sparse", PROBLEMS["G11-like128"](gset).to_ising(),
                             n_trials=3, device="cpu")
    st = bk.init_state(2**31 + 9)
    arrays = convert.engine_state_to_arrays(st)
    assert arrays[0].dtype == np.uint32 and arrays[0].shape == (2,)
    back = convert.engine_state_from_arrays(*arrays)
    assert back.noise_state == st.noise_state
    for a, b in zip(back[1:], st[1:]):
        assert torch.equal(a, b)
