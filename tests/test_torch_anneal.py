"""``repro_torch.core.ssa.anneal`` against ``repro.core.ssa.anneal``, end to end.

Small G11-like and K-like instances, the same seed and schedule, xorshift
noise.  The JAX side runs ``backend='pallas'`` (its kernels in interpret
mode); the port runs each of its backends on the CPU — 'cuda' there runs
the kernels' plain versions.  best_H, best_m, the trajectory planes and the
per-cycle minimum energy must be bit-identical.  The per-cycle mean energy
is an f32 mean of 100-trial-or-fewer integer energies whose sum may pass
2^24, so the two frameworks' summation orders may round it differently in
the last bits: it is held to rtol 1e-6 (a few f32 ulps) and no looser.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SolverConfig as JSolverConfig  # noqa: E402
from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro_torch.core import gset  # noqa: E402
from repro_torch.core import ssa as tssa  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine import make_backend, resolve_device  # noqa: E402
from repro_torch.kernels import ssa_update  # noqa: E402

HP = dict(n_trials=5, m_shot=2, tau=5, i0_min=1, i0_max=4)
PROBLEMS = {
    "K-like96": lambda g: g.complete_graph(96, seed=5),
    "G11-like128": lambda g: g.toroidal_grid(128, seed=3),
}


@functools.lru_cache(maxsize=None)
def _jax_run(problem, layout, record, track_energy, storage="i0max",
             schedule_kind="hassa", total_cycles=None):
    return janneal(
        PROBLEMS[problem](jgset), JHP(**HP), seed=1, storage=storage, record=record,
        track_energy=track_energy, schedule_kind=schedule_kind,
        total_cycles=total_cycles,
        config=JSolverConfig(backend="pallas", noise="xorshift", storage_layout=layout),
    )


def _port_run(problem, backend, layout, record, track_energy, **kw):
    return tssa.anneal(
        PROBLEMS[problem](gset), tssa.SSAHyperParams(**HP), seed=1, record=record,
        track_energy=track_energy, device="cpu",
        config=SolverConfig(backend=backend, noise="xorshift", storage_layout=layout), **kw,
    )


def _assert_same(got, want, track_energy):
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)
    np.testing.assert_array_equal(got.best_cut, want.best_cut)
    assert got.stored_bits_per_iter == want.stored_bits_per_iter
    if want.traj is None:
        assert got.traj is None
    else:
        assert got.traj.dtype == np.uint32
        np.testing.assert_array_equal(got.traj, want.traj)
    if track_energy:
        np.testing.assert_array_equal(got.energy_min, want.energy_min)
        np.testing.assert_allclose(got.energy_mean, want.energy_mean, rtol=1e-6, atol=0)
    else:
        assert got.energy_min is None and got.energy_mean is None


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("backend", ["cuda", "dense", "sparse"])
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("record,track_energy", [("best", False), ("best", True), ("traj", False)])
def test_anneal_matches_jax_pallas(problem, backend, layout, record, track_energy):
    got = _port_run(problem, backend, layout, record, track_energy)
    _assert_same(got, _jax_run(problem, layout, record, track_energy), track_energy)


@pytest.mark.parametrize("kw", [
    dict(storage="all", schedule_kind="ssa"),
    dict(total_cycles=27),
], ids=["ssa-storage-all", "total-cycles"])
@pytest.mark.parametrize("track_energy", [False, True])
def test_anneal_variants_match_jax(kw, track_energy):
    want = _jax_run("G11-like128", "dense", "best", track_energy, **kw)
    got = _port_run("G11-like128", "cuda", "dense", "best", track_energy, **kw)
    _assert_same(got, want, track_energy)


def test_cuda_backend_plateau_paths_on_cpu_launch_nothing():
    k1 = ssa_update.ssa_plateau_packed_batched.launches
    k3 = ssa_update.local_field.launches
    k4 = ssa_update.ssa_plateau_batched.launches
    _port_run("K-like96", "cuda", "dense", "best", True)
    _port_run("K-like96", "cuda", "packed", "traj", False)
    assert (ssa_update.ssa_plateau_packed_batched.launches, ssa_update.local_field.launches,
            ssa_update.ssa_plateau_batched.launches) == (k1, k3, k4)


def test_solve_maxcut_and_cut_consistency():
    p = gset.toroidal_grid(64, seed=1)
    r = tssa.solve_maxcut(p, tssa.SSAHyperParams(n_trials=3, m_shot=1, tau=4, i0_max=4),
                          config=SolverConfig(backend="dense"), device="cpu")
    np.testing.assert_array_equal(p.cut_value(r.best_m), r.best_cut)
    assert r.overall_best_cut == int(r.best_cut.max())


# ---------------------------------------------------------------------------
# Options that were once outside the ported slice raised NotImplementedError
# naming the ROADMAP item they waited for.  Spin sharding (partition='spin'/
# 'auto'), double_buffer and backend='auto' are ported since: their cases
# (ids kept) check that the option is taken.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(partition="spin"),
    dict(partition="auto"),
    dict(backend="auto"),
], ids=["{'partition': 'spin'}-step 8", "{'partition': 'auto'}-step 8",
        "{'backend': 'auto'}-step 3"])
def test_out_of_slice_config_raises(kw):
    cfg = SolverConfig(**kw)
    assert all(getattr(cfg, k) == v for k, v in kw.items())


@pytest.mark.parametrize("backend,kw,check", [
    ("dense", dict(double_buffer=True), lambda bk: bk.double_buffer),
    # 16 spins: at the port's MIN_RESIDENT_N (measured on the H100) or above.
    ("auto", {}, lambda bk: bk.name == ("cuda" if 16 >= engine.MIN_RESIDENT_N else "dense")),
], ids=["dense-{'double_buffer': True}-step 2", "auto-{}-step 3"])
def test_out_of_slice_backend_options_raise(backend, kw, check):
    model = gset.toroidal_grid(16, seed=0).to_ising()
    assert check(make_backend(backend, model, n_trials=2, device="cpu", **kw))


# field_mode='popcount' (and 'auto', which picks it for ±1 weights) is ported:
# the dense backend takes any noise, the cuda backend (K2) streamed xorshift
# only — threefry, anneal()'s default, raises there, as in the JAX package.
@pytest.mark.parametrize("kw", [dict(field_mode="popcount")], ids=lambda v: str(v))
def test_ported_field_mode_config_runs(kw):
    cfg = SolverConfig(**kw)
    r = tssa.anneal(gset.toroidal_grid(16, seed=0),
                    tssa.SSAHyperParams(n_trials=2, m_shot=1, tau=3, i0_max=4),
                    config=cfg, device="cpu")
    assert cfg.field_mode == "popcount" and r.best_m.shape == (2, 16)


@pytest.mark.parametrize("backend,kw", [
    ("cuda", dict(field_mode="popcount", noise="xorshift")),
    ("cuda", dict(field_mode="auto")),
    ("dense", dict(field_mode="popcount")),
], ids=lambda v: str(v))
def test_ported_field_mode_backend_options(backend, kw):
    model = gset.toroidal_grid(16, seed=0).to_ising()
    if kw.get("noise") is None and backend == "cuda":
        with pytest.raises(ValueError, match="streamed"):
            make_backend(backend, model, n_trials=2, device="cpu", **kw)
        return
    bk = make_backend(backend, model, n_trials=2, device="cpu", **kw)
    assert bk.field_mode == "popcount" and not hasattr(bk, "J")
    st, _, _ = bk.run_plateau(bk.init_state(1), 4, length=3, eligible=True)
    assert bk.finalize(st)[1].shape == (2, 16)


# threefry noise and the pregen datapath (K4) are ported: accepted and run.
@pytest.mark.parametrize("kw", [
    dict(noise="threefry"),
    dict(noise_mode="pregen"),
    dict(backend="cuda", noise="threefry"),
    dict(backend="cuda", noise="threefry", noise_mode="pregen"),
    dict(backend="cuda", noise="xorshift", noise_mode="pregen"),
    dict(backend="dense", noise="threefry"),
], ids=lambda v: str(v))
def test_ported_noise_config_runs(kw):
    cfg = SolverConfig(**kw)
    r = tssa.anneal(gset.toroidal_grid(16, seed=0),
                    tssa.SSAHyperParams(n_trials=2, m_shot=1, tau=3, i0_max=4),
                    config=cfg, device="cpu")
    assert r.best_m.shape == (2, 16)


@pytest.mark.parametrize("backend,kw", [
    ("cuda", dict(noise="threefry")),
    ("dense", dict(noise="threefry")),
    ("cuda", dict(noise_mode="pregen")),
    ("cuda", dict(noise="xorshift", noise_mode="pregen")),
], ids=lambda v: str(v))
def test_ported_noise_backend_options_run(backend, kw):
    model = gset.toroidal_grid(16, seed=0).to_ising()
    bk = make_backend(backend, model, n_trials=2, device="cpu", **kw)
    assert bk.noise == kw.get("noise", "threefry")
    if backend == "cuda":
        assert bk.noise_mode == "pregen"
    st, _, _ = bk.run_plateau(bk.init_state(1), 4, length=3, eligible=True)
    assert bk.finalize(st)[1].shape == (2, 16)


def test_threefry_streamed_raises():
    with pytest.raises(ValueError, match="requires the xorshift"):
        SolverConfig(noise="threefry", noise_mode="streamed")
    model = gset.toroidal_grid(16, seed=0).to_ising()
    with pytest.raises(ValueError, match="requires noise='xorshift'"):
        make_backend("cuda", model, n_trials=2, device="cpu", noise="threefry",
                     noise_mode="streamed")


def test_dense_j_above_threshold_raises():
    """Above TILED_J_THRESHOLD spins j_mode='auto' streams J slabs and holds
    no (N, N) J; the tiled field ignores ``j_dtype``, as the JAX package's
    does (it once raised, before j_dtype was ported)."""
    model = gset.toroidal_grid(4100, seed=0).to_ising()
    bk = make_backend("dense", model, n_trials=1, device="cpu")
    assert bk.j_mode == "tiled" and not hasattr(bk, "J")
    bk = make_backend("dense", model, n_trials=1, device="cpu", j_dtype=torch.bfloat16)
    assert bk.j_mode == "tiled" and not hasattr(bk, "J")


def test_anneal_hp_auto_and_ssqa_raise():
    """``anneal(p, 'auto')`` and ``anneal(p, SSQAHyperParams(...))`` run on
    the CPU (they raised before SSQA and autotune were ported) and equal
    the JAX package's, with its default config (sparse, threefry)."""
    from repro.core.ssqa import SSQAHyperParams as JSSQA
    from repro_torch.core.ssqa import SSQAHyperParams

    p, jp = gset.toroidal_grid(16, seed=0), jgset.toroidal_grid(16, seed=0)
    base = dict(n_trials=4, m_shot=1, tau=4)
    got = tssa.anneal(p, "auto", device="cpu", auto_base=tssa.SSAHyperParams(**base))
    want = janneal(jp, "auto", auto_base=JHP(**base))
    assert repr(got.hp) == repr(want.hp)
    _assert_same(got, want, True)
    hp = dict(base, i0_max=8, n_replicas=2, jperp_max=2)
    got = tssa.anneal(p, SSQAHyperParams(**hp), device="cpu")
    want = janneal(jp, JSSQA(**hp))
    _assert_same(got, want, True)


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        tssa.anneal(gset.toroidal_grid(16, seed=0), tssa.SSAHyperParams(n_trials=2, m_shot=1, tau=2))


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import anneal as launcher

    launcher.main(["--problem", "G11", "--trials", "2", "--m-shot", "1", "--tau", "3",
                   "--i0-max", "4", "--backend", "cuda", "--device", "cpu",
                   "--track-energy", "--storage-layout", "packed"])
    out = capsys.readouterr().out
    assert "best cut" in out and "3× saving" in out
