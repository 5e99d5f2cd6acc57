"""Spin sharding of the port (``partition='spin'``) against the JAX package's.

Mirrors ``tests/test_spinshard.py`` at its size (``toroidal_grid(64,
seed=17)``, 3 trials, m_shot 2, τ 3, I0 1→4): the same requests from the
same seeds through the JAX package's spin-sharded backends on a one-device
mesh and the port's on a one-rank gloo group, on the CPU.  The tolerance is
bit-identity: best energies, spins, energy traces, chunk traces.

P > 1 runs in one consolidated test: the parent computes the JAX
package's results and writes them to an ``.npz``, then spawns 2, 4 and 8
gloo ranks joined through a ``file://`` rendezvous, which import only
``repro_torch`` and must reproduce them — word-aligned shards (P = 2) and
shards that are not (P = 8, Ns = 8) — plus a killed and resumed service
solve at P = 4 and the residency drop at bucket 4096.  The one-rank NCCL
run on the card, equal to its K2 run, is in ``tests/test_torch_cuda.py``
(card tests import no JAX).
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import anneal as janneal  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core.engine import bucket_n as jbucket_n  # noqa: E402
from repro.core.engine import make_batched_backend as jmake_batched  # noqa: E402
from repro.core.engine import padded_noise_init_slice as jslice  # noqa: E402
from repro.core.engine import resolve_partition as jresolve_partition  # noqa: E402
from repro.core.engine import schedule_plateaus as jschedule_plateaus  # noqa: E402
from repro.core.ssqa import SSQAHyperParams as JSSQA  # noqa: E402
from repro.core.ssqa import anneal_ssqa as janneal_ssqa  # noqa: E402
from repro.serve import AnnealRequest as JRequest  # noqa: E402
from repro.serve import AnnealService as JService  # noqa: E402
from repro.serve.resilience import filter_backend_opts as jfilter  # noqa: E402
from repro.serve.resilience import group_fingerprint as jfingerprint  # noqa: E402
from repro.sharding import mesh_fingerprint as jmesh_fp  # noqa: E402
from repro.sharding import spin_mesh as jspin_mesh  # noqa: E402
from repro_torch.core import engine, gset, memory  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ising import local_fields_tiled  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams, anneal  # noqa: E402
from repro_torch.core.ssqa import SSQAHyperParams, anneal_ssqa  # noqa: E402
from repro_torch.ft.faults import FaultInjector, InjectedKill  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    AnnealRequest,
    AnnealService,
    ResiliencePolicy,
    StreamingAnnealService,
)
from repro_torch.serve.resilience import filter_backend_opts, group_fingerprint  # noqa: E402
from repro_torch.sharding import mesh_fingerprint, spin_mesh  # noqa: E402

HP = dict(n_trials=3, m_shot=2, tau=3, i0_min=1, i0_max=4)
HP_KILL = dict(n_trials=3, m_shot=6, tau=4, i0_min=1, i0_max=8)
# (base backend, options): the JAX package's three field arithmetics and the
# tiled float32 slab stream, which 'auto' (popcount for ±1 weights) skips.
CASES = [("sparse", {}), ("dense", {}), ("dense", {"field_mode": "popcount"}),
         ("dense", {"field_mode": "dense"})]
CASE_IDS = ["sparse", "dense-auto", "popcount", "tiled"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _twin():
    return gset.toroidal_grid(64, seed=17)


def _mesh():
    return spin_mesh(1, device="cpu")


def _jax_run(base, opts, layout, model, nb, seed=11):
    """The JAX package's spin-sharded batched run on a one-device mesh."""
    hp = JHP(**HP)
    plats = jschedule_plateaus(hp.schedule("hassa"), "i0max")
    bk = jmake_batched(base, n_bucket=nb, n_trials=hp.n_trials, noise="xorshift",
                       storage_layout=layout, partition="spin", mesh=jspin_mesh(1), **opts)
    problem = bk.stack([model])
    st = bk.init_state(problem, bk.init_noise([seed], [model.n]))
    st = jax.jit(lambda s: bk.run_shots(problem, s, plats, hp.m_shot))(st)
    bh, bm = bk.finalize(st)
    return np.asarray(bh), np.asarray(bm)[..., :model.n]


def _torch_run(bk, model, seed=11):
    hp = SSAHyperParams(**HP)
    plats = engine.schedule_plateaus(hp.schedule("hassa"), "i0max")
    problem = bk.stack([model])
    st = bk.init_state(problem, bk.init_noise([seed], [model.n]))
    bh, bm = bk.finalize(bk.run_shots(problem, st, plats, hp.m_shot))
    return bh.numpy(), bm.numpy()[..., :model.n]


# ---------------------------------------------------------------------------
# The mesh, partition resolution, configuration
# ---------------------------------------------------------------------------
def test_spin_mesh_and_fingerprint():
    mesh = _mesh()
    assert mesh.axis_names == ("model",) and mesh.size == 1 and mesh.backend == "gloo"
    assert mesh_fingerprint(mesh) == jmesh_fp(jspin_mesh(1))
    assert mesh_fingerprint(None) == jmesh_fp(None) == ()
    with pytest.raises(ValueError, match="1 <= n <= 1 ranks, got 2"):
        spin_mesh(2, device="cpu")


def test_spin_mesh_refuses_gloo_group_on_card(monkeypatch):
    """A running one-rank gloo group is no spin mesh on the card, which is a
    one-rank NCCL group there: the error names the remedy."""
    _mesh()  # the one-rank gloo group runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="destroy_process_group"):
        spin_mesh(1, device="cuda")


@pytest.mark.parametrize("partition,n,mesh", [
    ("problem", 1 << 20, True), ("spin", 64, True), ("auto", 1 << 20, True),
    ("auto", 1 << 20, False), ("auto", 64, False)])
def test_resolve_partition_rules(partition, n, mesh):
    got = engine.resolve_partition(partition, n, _mesh() if mesh else None)
    assert got == jresolve_partition(partition, n, jspin_mesh(1) if mesh else None)
    with pytest.raises(ValueError):
        engine.resolve_partition("bogus", 64, _mesh())


def test_solver_config_signature_with_mesh():
    from repro.core.config import SolverConfig as JConfig

    for kw in (dict(partition="spin"), dict(partition="auto", backend="dense"),
               dict(partition="spin", field_mode="popcount", storage_layout="packed")):
        port = SolverConfig(mesh=_mesh(), **kw)
        ref = JConfig(mesh=jspin_mesh(1), **kw)
        assert port.signature() == ref.signature()
        assert port.signature() != SolverConfig(**kw).signature()
    hoisted = SolverConfig(backend_opts={"partition": "spin", "mesh": None, "tile_n": 16})
    assert hoisted.partition == "spin" and hoisted.opts_dict() == {"tile_n": 16}


def test_spinshard_requires_xorshift():
    with pytest.raises(ValueError, match="xorshift"):
        engine.make_batched_backend("dense", n_bucket=64, n_trials=2, noise="threefry",
                                    partition="spin", mesh=_mesh())
    with pytest.raises(ValueError, match="xorshift"):
        engine.make_backend("dense", _twin().to_ising(), n_trials=2, noise="threefry",
                            partition="spin", mesh=_mesh())


# ---------------------------------------------------------------------------
# Shard-local lane seeding and double-buffered tiled fields
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lo,hi", [(0, 16), (16, 48), (48, 64), (0, 64)])
def test_padded_noise_init_slice_matches_full(lo, hi):
    full = engine.padded_noise_init("xorshift", 9, 3, 50, 64, "cpu").numpy().view(np.uint32)
    sl = engine.padded_noise_init_slice(9, 3, 50, 64, lo, hi)
    np.testing.assert_array_equal(full[..., lo:hi], sl)
    np.testing.assert_array_equal(sl, jslice(9, 3, 50, 64, lo, hi))


@pytest.mark.parametrize("tile_n", [16, 20, 64])
def test_double_buffer_tiled_fields_bit_identical(tile_n):
    from repro.core.ising import local_fields_tiled as jtiled

    model = _twin().to_ising()
    m = np.random.default_rng(0).choice(np.array([-1, 1], np.int8), size=(3, model.n))
    h, idx, w = model.device_arrays("cpu")
    db = local_fields_tiled(torch.as_tensor(m), h, idx, w, tile_n=tile_n, double_buffer=True)
    ref = jtiled(m, model.h, model.nbr_idx, model.nbr_w, tile_n=tile_n, double_buffer=True)
    np.testing.assert_array_equal(db.numpy(), np.asarray(ref))
    plain = local_fields_tiled(torch.as_tensor(m), h, idx, w, tile_n=tile_n)
    assert torch.equal(db, plain)


def test_double_buffer_dense_backend_bit_identical():
    opts = {"j_mode": "tiled", "tile_n": 16, "double_buffer": True}
    ref = janneal(jgset.toroidal_grid(64, seed=17), JHP(**HP), seed=2, backend="dense",
                  noise="xorshift", backend_opts=opts)
    got = anneal(_twin(), SSAHyperParams(**HP), seed=2, device="cpu",
                 config=SolverConfig(backend="dense", noise="xorshift", j_mode="tiled",
                                     backend_opts={"tile_n": 16, "double_buffer": True}))
    np.testing.assert_array_equal(ref.best_energy, got.best_energy)
    np.testing.assert_array_equal(ref.best_m, got.best_m)


# ---------------------------------------------------------------------------
# Sharded port == sharded JAX package at P = 1: every field arithmetic in
# both storage layouts, the driver, SSQA, the service and the stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("base,opts", CASES, ids=CASE_IDS)
def test_sharded_matches_jax_1rank(base, opts, layout):
    model = _twin().to_ising()
    nb = jbucket_n(model.n, 64)
    want = _jax_run(base, opts, layout, jgset.toroidal_grid(64, seed=17).to_ising(), nb)
    bk = engine.make_batched_backend(base, n_bucket=nb, n_trials=HP["n_trials"],
                                     noise="xorshift", storage_layout=layout,
                                     partition="spin", mesh=_mesh(), device="cpu", **opts)
    assert bk.name == "spinshard"
    got = _torch_run(bk, model)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])


def test_sharded_anneal_driver_matches_jax():
    ref = janneal(jgset.toroidal_grid(64, seed=17), JHP(**HP), seed=5, backend="sparse",
                  noise="xorshift", track_energy=True,
                  backend_opts={"partition": "spin", "mesh": jspin_mesh(1)})
    got = anneal(_twin(), SSAHyperParams(**HP), seed=5, track_energy=True, device="cpu",
                 config=SolverConfig(backend="sparse", noise="xorshift", partition="spin",
                                     mesh=_mesh()))
    for k in ("best_energy", "best_m", "energy_mean", "energy_min", "best_cut"):
        np.testing.assert_array_equal(getattr(ref, k), getattr(got, k))
    with pytest.raises(NotImplementedError, match="record='traj'"):
        anneal(_twin(), SSAHyperParams(**HP), record="traj", device="cpu",
               config=SolverConfig(noise="xorshift", partition="spin", mesh=_mesh()))


@pytest.mark.parametrize("base", ["dense", "cuda"])
def test_ssqa_under_spin_matches_jax(base):
    hp = dict(n_trials=8, n_replicas=4, m_shot=2, tau=3, i0_min=1, i0_max=4, jperp_max=2)
    ref = janneal_ssqa(jgset.toroidal_grid(64, seed=17), JSSQA(**hp), seed=3,
                       backend="dense", noise="xorshift",
                       backend_opts={"partition": "spin", "mesh": jspin_mesh(1)})
    got = anneal_ssqa(_twin(), SSQAHyperParams(**hp), seed=3, device="cpu",
                      config=SolverConfig(backend=base, noise="xorshift", partition="spin",
                                          mesh=_mesh()))
    np.testing.assert_array_equal(ref.best_energy, got.best_energy)
    np.testing.assert_array_equal(ref.best_m, got.best_m)


def test_sharded_service_matches_jax():
    jreq = [JRequest(problem=jgset.toroidal_grid(64, seed=17), hp=JHP(**HP), seed=4)]
    want = JService(backend="dense", min_bucket=64, partition="spin",
                    mesh=jspin_mesh(1)).solve(jreq)[0]
    svc = AnnealService(backend="dense", min_bucket=64, partition="spin", mesh=_mesh())
    got = svc.solve([AnnealRequest(problem=_twin(), hp=SSAHyperParams(**HP), seed=4)])[0]
    plain = AnnealService(backend="dense", min_bucket=64, device="cpu").solve(
        [AnnealRequest(problem=_twin(), hp=SSAHyperParams(**HP), seed=4)])[0]
    for r in (got, plain):
        np.testing.assert_array_equal(want.result.best_energy, r.result.best_energy)
        np.testing.assert_array_equal(want.result.best_m, r.result.best_m)
        np.testing.assert_array_equal(want.chunk_best_cut, r.chunk_best_cut)
    assert got.status == "ok"
    key = next(iter(svc._programs))
    assert key[-2:] == ("spin", mesh_fingerprint(_mesh()))


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_sharded_kill_resume_bit_identical(layout, tmp_path):
    def solve(**kw):
        svc = AnnealService(backend="dense", min_bucket=64, partition="spin", mesh=_mesh(),
                            storage_layout=layout, **kw)
        return svc.solve([AnnealRequest(problem=_twin(), hp=SSAHyperParams(**HP_KILL),
                                        seed=4)])[0]

    base = solve()
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path))
    inj = FaultInjector()
    inj.arm("kill", chunk=2)
    with pytest.raises(InjectedKill):
        solve(resilience=pol, faults=inj)
    resumed = solve(resilience=pol)
    assert [e.kind for e in resumed.events] == ["resume"]
    np.testing.assert_array_equal(base.result.best_energy, resumed.result.best_energy)
    np.testing.assert_array_equal(base.result.best_m, resumed.result.best_m)
    assert not any(tmp_path.iterdir())  # purged on success


def test_checkpoint_gathers_only_when_due(tmp_path):
    """A spin group gathers its shards (and waits for its ranks) only at the
    chunks the checkpoint interval saves; its ranks agree on the step."""
    from repro_torch import sharding
    from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step
    from repro_torch.serve.anneal_service import agreed_latest_step, save_checkpoint

    bk = engine.make_batched_backend("dense", n_bucket=64, n_trials=3, noise="xorshift",
                                     partition="spin", mesh=_mesh(), device="cpu")
    problem = bk.stack([_twin().to_ising()])
    st = bk.init_state(problem, bk.init_noise([4], [64]))
    ckpt = CheckpointManager(str(tmp_path / "g"), save_interval=2, async_save=False)
    sharding.reset_collective_counts()
    save_checkpoint(ckpt, bk, 1, st, {"traces": [[]]})
    assert not sharding.collective_counts and latest_step(ckpt.directory) is None
    assert agreed_latest_step(ckpt.directory, bk) == (None, False)
    save_checkpoint(ckpt, bk, 2, st, {"traces": [[]]})
    assert sharding.collective_counts["all_gather"] > 0
    assert agreed_latest_step(ckpt.directory, bk) == (2, False)


def test_stream_under_spin_matches_one_shot():
    req = AnnealRequest(problem=_twin(), hp=SSAHyperParams(**HP), seed=4)
    svc = AnnealService(backend="sparse", min_bucket=64, partition="spin", mesh=_mesh())
    want = svc.solve([req])[0]
    ss = StreamingAnnealService(service=svc)
    t = ss.submit(req)
    ss.run_until_idle()
    got = t.result(timeout=0)
    assert got.status == "ok"
    np.testing.assert_array_equal(want.result.best_energy, got.result.best_energy)
    np.testing.assert_array_equal(want.result.best_m, got.result.best_m)
    assert ss._stream_key(t)[0][10:12] == ("spin", mesh_fingerprint(_mesh()))


# ---------------------------------------------------------------------------
# Admission: giant instances pass only when they route to the spin path
# ---------------------------------------------------------------------------
def _big_request():
    big = gset.toroidal_grid(engine.MAX_UNSHARDED_SPINS + 1232, seed=5, name="big")
    return AnnealRequest(problem=big, hp=SSAHyperParams(**HP), seed=1)


def test_giant_instance_rejected_unsharded():
    with pytest.raises(AdmissionError, match="partition='spin'"):
        AnnealService(backend="sparse", device="cpu").solve([_big_request()])


def test_giant_instance_admitted_with_spin_partition():
    svc = AnnealService(backend="sparse", partition="spin", mesh=_mesh())
    req = _big_request()
    _, model = engine.normalize_problem(req.problem)
    svc._admit(0, req, model)  # must not raise


@pytest.mark.parametrize("kind,want", [("sa", "problem"), ("ptssa", "problem"),
                                       ("ssa", "spin"), ("ssqa", "spin")])
def test_sa_and_ptssa_never_route_to_spin(kind, want):
    svc = AnnealService(partition="spin", mesh=_mesh())
    ref = JService(partition="spin", mesh=jspin_mesh(1))
    assert svc.partition_for(kind, 1 << 16) == ref.partition_for(kind, 1 << 16) == want


# ---------------------------------------------------------------------------
# Resilience plumbing: the spin keyset and checkpoint fingerprints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["sparse", "dense"])
def test_filter_backend_opts_spin_keyset(backend):
    opts = {"block_r": 8, "field_mode": "auto", "double_buffer": True, "noise_mode": "pregen",
            "n_replicas": 2, "bogus": 1}
    assert filter_backend_opts(backend, opts) == jfilter(backend, opts)
    spin = filter_backend_opts(backend, opts, partition="spin")
    assert spin == jfilter(backend, opts, partition="spin")
    assert spin == {k: v for k, v in opts.items() if k != "bogus"}


def test_group_fingerprint_keys_on_partition_and_mesh():
    model = _twin().to_ising()
    jmodel = jgset.toroidal_grid(64, seed=17).to_ising()
    items = [(0, AnnealRequest(problem=_twin(), hp=SSAHyperParams(**HP), seed=1), None, model)]
    jitems = [(0, JRequest(problem=jgset.toroidal_grid(64, seed=17), hp=JHP(**HP), seed=1),
               None, jmodel)]
    base = group_fingerprint("ssa", 64, "dense", "dense", "xorshift", 1, items)
    spin = group_fingerprint("ssa", 64, "dense", "dense", "xorshift", 1, items,
                             partition="spin", mesh_fp=mesh_fingerprint(_mesh()))
    assert base != spin
    assert spin == jfingerprint("ssa", 64, "dense", "dense", "xorshift", 1, jitems,
                                partition="spin", mesh_fp=jmesh_fp(jspin_mesh(1)))


def test_per_device_bytes_accounting():
    tree = {"host": np.zeros(16, np.int32), "dev": torch.zeros(8, dtype=torch.int8)}
    per = memory.per_device_bytes(tree)
    assert per == {"host": 64, "cpu:0": 8}
    assert memory.max_device_bytes(tree) == 64
    assert memory.per_device_bytes(tree, _mesh()) == {"host": 64, "cpu:0": 8}


def test_launcher_partition_spin(capsys):
    """--partition spin prints the unsharded run's best-cut line; a single
    process asked for two ranks names torchrun."""
    from repro_torch.launch import anneal as launch

    args = ["--problem", "G11", "--trials", "4", "--m-shot", "2", "--tau", "10",
            "--backend", "dense", "--device", "cpu"]
    launch.main(args)
    plain = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("best cut")]
    launch.main(args + ["--partition", "spin"])
    spin = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("best cut")]
    assert plain[0].split("(")[0] == spin[0].split("(")[0]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        launch.main(args + ["--partition", "spin", "--mesh-shape", "2"])


# ---------------------------------------------------------------------------
# P = 2, 4, 8: gloo ranks in subprocesses, held against the JAX package
# ---------------------------------------------------------------------------
RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys, tempfile
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, ref_path, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                            sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world)
    from repro_torch.core import gset, memory
    from repro_torch.core.engine import make_batched_backend, schedule_plateaus
    from repro_torch.core.ssa import SSAHyperParams
    from repro_torch.ft.faults import FaultInjector, InjectedKill
    from repro_torch.serve import (AnnealRequest, AnnealService, ResiliencePolicy,
                                   StreamingAnnealService)
    from repro_torch.sharding import spin_mesh

    ref = np.load(ref_path)
    cases = json.loads(str(ref["cases"]))
    hp = SSAHyperParams(**json.loads(str(ref["hp"])))
    model = gset.toroidal_grid(64, seed=17).to_ising()
    plats = schedule_plateaus(hp.schedule("hassa"), "i0max")
    mesh = spin_mesh(device="cpu")
    assert mesh.size == world and mesh.rank == rank
    for i, (base, opts, layout) in enumerate(cases):
        bk = make_batched_backend(base, n_bucket=64, n_trials=hp.n_trials, noise="xorshift",
                                  storage_layout=layout, partition="spin", mesh=mesh, **opts)
        assert bk.n_shard == 64 // world and bk._words_shardable == (64 // world % 32 == 0)
        problem = bk.stack([model])
        st = bk.init_state(problem, bk.init_noise([11], [model.n]))
        bh, bm = bk.finalize(bk.run_shots(problem, st, plats, hp.m_shot))
        assert np.array_equal(bh.numpy(), ref[f"bh{i}"]), (world, base, opts, layout)
        assert np.array_equal(bm.numpy()[..., :64], ref[f"bm{i}"]), (world, base, opts, layout)
    out = {"bit_identity": True}

    if world == 4:  # a service solve killed at chunk 2 and resumed
        hp_k = SSAHyperParams(**json.loads(str(ref["hp_kill"])))
        reqs = [AnnealRequest(problem=gset.toroidal_grid(64, seed=17), hp=hp_k, seed=4)]
        svc = lambda **kw: AnnealService(backend="dense", min_bucket=64, partition="spin",
                                         mesh=mesh, **kw)
        pol = ResiliencePolicy(checkpoint_dir=os.path.join(out_dir, "ckpt"))
        inj = FaultInjector(); inj.arm("kill", chunk=2)
        try:
            svc(resilience=pol, faults=inj).solve(reqs)
            raise SystemExit("kill did not fire")
        except InjectedKill:
            pass
        resumed = svc(resilience=pol).solve(reqs)[0]
        assert [e.kind for e in resumed.events] == ["resume"], resumed.events
        assert np.array_equal(resumed.result.best_energy, ref["kill_bh"])
        assert np.array_equal(resumed.result.best_m, ref["kill_bm"])
        ss = StreamingAnnealService(service=svc())
        t = ss.submit(AnnealRequest(problem=gset.toroidal_grid(64, seed=17), hp=hp_k, seed=4,
                                    deadline_s=3600.0))
        ss.run_until_idle()
        assert np.array_equal(t.result(timeout=0).result.best_m, ref["kill_bm"])
        out["kill_resume"] = True

    if world == 2:  # ranks that do not share the checkpoint directory
        hp_k = SSAHyperParams(**json.loads(str(ref["hp_kill"])))
        reqs = [AnnealRequest(problem=gset.toroidal_grid(64, seed=17), hp=hp_k, seed=4)]
        svc = lambda **kw: AnnealService(backend="dense", min_bucket=64, partition="spin",
                                         mesh=mesh, **kw)
        pol = ResiliencePolicy(checkpoint_dir=os.path.join(out_dir, f"split{rank}"))
        inj = FaultInjector(); inj.arm("kill", chunk=2)
        try:
            svc(resilience=pol, faults=inj).solve(reqs)
            raise SystemExit("kill did not fire")
        except InjectedKill:
            pass
        fresh = svc(resilience=pol).solve(reqs)[0]
        assert [(e.kind, e.detail.get("reason")) for e in fresh.events] == [
            ("checkpoint_rejected", "the ranks see different checkpoints")], fresh.events
        assert np.array_equal(fresh.result.best_energy, ref["kill_bh"])
        assert np.array_equal(fresh.result.best_m, ref["kill_bm"])
        out["split_dirs"] = True

    if world == 8:  # residency at bucket 4096
        bk = make_batched_backend("dense", n_bucket=4096, n_trials=2, noise="xorshift",
                                  partition="spin", mesh=mesh)
        prob = bk.stack([model])
        st = bk.init_state(prob, bk.init_noise([0], [model.n]))
        out["busiest"] = memory.max_device_bytes((prob, st), mesh)
    if rank == 0:
        with open(os.path.join(out_dir, f"P{world}.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
""")


def _spawn(world: int, ref_path: str, out_dir: str, timeout: float):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    store = os.path.join(out_dir, f"store{world}")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(world), store,
                               ref_path, out_dir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"P={world} rank {r}:\n{err[-3000:]}"


def test_multirank_subprocess():
    model = jgset.toroidal_grid(64, seed=17).to_ising()
    cases = [(base, opts, layout) for base, opts in CASES for layout in ("dense", "packed")]
    ref = {"cases": json.dumps(cases), "hp": json.dumps(HP), "hp_kill": json.dumps(HP_KILL)}
    for i, (base, opts, layout) in enumerate(cases):
        ref[f"bh{i}"], ref[f"bm{i}"] = _jax_run(base, opts, layout, model, 64)
    jreq = [JRequest(problem=jgset.toroidal_grid(64, seed=17), hp=JHP(**HP_KILL), seed=4)]
    want = JService(backend="dense", min_bucket=64, partition="spin",
                    mesh=jspin_mesh(1)).solve(jreq)[0]
    ref["kill_bh"], ref["kill_bm"] = want.result.best_energy, want.result.best_m
    with tempfile.TemporaryDirectory() as out_dir:
        ref_path = os.path.join(out_dir, "ref.npz")
        np.savez(ref_path, **ref)
        for world in (2, 4, 8):
            _spawn(world, ref_path, out_dir, timeout=120)
        res = {w: json.load(open(os.path.join(out_dir, f"P{w}.json"))) for w in (2, 4, 8)}
    assert all(r["bit_identity"] for r in res.values()) and res[4]["kill_resume"]
    assert res[2]["split_dirs"]
    bk = engine.make_batched_backend("dense", n_bucket=4096, n_trials=2, noise="xorshift",
                                     partition="spin", mesh=_mesh(), device="cpu")
    prob = bk.stack([_twin().to_ising()])
    st = bk.init_state(prob, bk.init_noise([0], [64]))
    ratio = memory.max_device_bytes((prob, st), _mesh()) / res[8]["busiest"]
    assert ratio >= 4.0, (ratio, res[8])


def test_scale_benchmark_smoke(tmp_path):
    """The weak-scaling benchmark at P = 1 and 2 gloo ranks: its rows hold
    bit-identity, the residency drop and the 40,000-spin row."""
    from repro_torch.benchmarks import scale

    report = scale.run([1, 2], smoke=True, device="cpu", json_path=str(tmp_path / "s.json"),
                       timeout=120)
    assert report["dist_backend"] == "gloo"
    assert all(all(r["bit_identity"].values()) for r in report["weak_scaling"])
    assert report["weak_scaling"][1]["residency_drop"] > 1.5
    big = report["largest_n"]
    assert big["n"] == 40000 and big["single_device_rejected"] and big["status"] == "ok"
