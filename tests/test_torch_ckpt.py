"""The port's checkpoints and the one-shot service's kill/resume, against
the JAX package, on the CPU.

Mirrors ``tests/test_ft.py``'s checkpoint tests (atomic writes, keep-last-k
and GC, a consistent async save) on the port's state trees, and
``tests/test_chaos.py``'s checkpoint tests: a solve killed at a chunk
boundary and resumed by a fresh service returns the uninterrupted run's
results bit for bit — the JAX package's too — on the sparse, dense and
cuda (plain) backends, and a checkpoint with zeroed xorshift lanes is
rejected and the group rerun.  ``group_fingerprint`` gives the JAX
package's digest for equal requests.  The card's side (a CUDA lane's
checkpoint restored onto the card) is in ``tests/test_torch_stream_cuda.py``,
which imports no JAX.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core.ssqa import SSQAHyperParams as JSSQA  # noqa: E402
from repro.serve import AnnealRequest as JRequest  # noqa: E402
from repro.serve import AnnealService as JService  # noqa: E402
from repro.serve import ResiliencePolicy as JPolicy  # noqa: E402
from repro.serve.resilience import group_fingerprint as jfingerprint  # noqa: E402
from repro_torch.checkpoint.ckpt import (  # noqa: E402
    CheckpointManager,
    latest_step,
    purge,
    restore,
    save,
    save_async,
)
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.rng import xorshift_lanes_ok  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams  # noqa: E402
from repro_torch.core.ssqa import SSQAHyperParams  # noqa: E402
from repro_torch.ft.faults import FaultInjector, InjectedKill  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AnnealRequest,
    AnnealService,
    ResiliencePolicy,
    group_fingerprint,
)

HP = dict(n_trials=3, m_shot=6, tau=4, i0_min=1, i0_max=8)
# (port backend, JAX backend)
BACKENDS = [("sparse", "sparse"), ("dense", "dense"), ("cuda", "pallas")]
JAX_NAME = dict(BACKENDS)


def _problems(g):
    return (g.toroidal_grid(36, seed=0, name="t36"), g.king_graph(36, seed=3, name="k36"))


def _requests(jax=False, **kw):
    g, Req, Hp = (jgset, JRequest, JHP) if jax else (gset, AnnealRequest, SSAHyperParams)
    return [Req(problem=p, hp=Hp(**HP), seed=i + 1, **kw) for i, p in enumerate(_problems(g))]


def _svc(backend, **kw):
    return AnnealService(backend=backend, min_bucket=16, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jax_baseline(backend):
    return JService(backend=JAX_NAME[backend], min_bucket=16).solve(_requests(jax=True))


@functools.lru_cache(maxsize=None)
def _baseline(backend):
    return _svc(backend).solve(_requests())


def _assert_bit_identical(got, want):
    np.testing.assert_array_equal(got.result.best_energy, np.asarray(want.result.best_energy))
    np.testing.assert_array_equal(got.result.best_m, np.asarray(want.result.best_m))
    np.testing.assert_array_equal(got.chunk_best_cut, np.asarray(want.chunk_best_cut))


def _engine_state(layout, noise, B=2):
    """A batched engine state after one iteration (its real leaf types)."""
    bk = engine.make_batched_backend("cuda", n_bucket=64, n_trials=3, noise=noise,
                                     storage_layout=layout, device="cpu")
    models = [gset.toroidal_grid(36, seed=s).to_ising() for s in range(B)]
    prob = bk.stack(models)
    st = bk.init_state(prob, bk.init_noise(list(range(B)), [36] * B))
    plateaus = engine.schedule_plateaus(SSAHyperParams(**HP).schedule("hassa"), "i0max")
    return bk.run_shots(prob, st, plateaus, 1)


def _assert_same_tree(got, want):
    assert type(got) is type(want)
    for a, b in zip(got, want):
        assert type(a) is type(b)
        if isinstance(b, torch.Tensor):
            assert (a.dtype, a.device, a.shape) == (b.dtype, b.device, b.shape)
            assert torch.equal(a, b)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The checkpoint module (tests/test_ft.py)
# ---------------------------------------------------------------------------
def test_checkpoint_atomic_and_gc(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones((2, 2))}}
    for s in (5, 10, 15, 20):
        save(d, s, tree, meta={"x": s})
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]  # no temp file left
    mgr = CheckpointManager(d, save_interval=5, keep=2, async_save=False)
    mgr._gc()
    steps = sorted(int(f.split("_")[1].split(".")[0]) for f in os.listdir(d)
                   if f.endswith(".npz"))
    assert steps == [15, 20] and latest_step(d) == 20
    got, meta = restore(d, tree)
    assert meta == {"x": 20, "step": 20}
    assert torch.equal(got["a"], torch.arange(4.0)) and got["b"]["c"].shape == (2, 2)
    got10, meta10 = restore(d, tree, step=15)
    assert meta10["step"] == 15


def test_async_save_consistent(tmp_path):
    """The host copy is taken before the writer thread starts: an in-place
    write to the source right after ``maybe_save`` never reaches the file."""
    d = str(tmp_path)
    mgr = CheckpointManager(d, save_interval=1, keep=3, async_save=True)
    w = torch.arange(8.0)
    key = np.array([[1, 2]], np.int64)
    tree = {"w": w, "key": key}
    assert mgr.maybe_save(1, tree)
    w.mul_(-1)
    key[0, 0] = 99
    mgr.wait()
    got, meta = restore(d, {"w": torch.zeros(8), "key": np.zeros((1, 2), np.int64)})
    assert torch.equal(got["w"], torch.arange(8.0)) and got["key"].tolist() == [[1, 2]]
    assert meta["step"] == 1
    thread = save_async(d, 2, tree, meta={"traces": [[1]]})
    thread.join()
    assert latest_step(d) == 2


def test_maybe_save_interval_and_keep(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, save_interval=2, keep=1, async_save=False)
    saved = [mgr.maybe_save(s, {"x": torch.tensor([s])}) for s in range(1, 6)]
    assert saved == [False, True, False, True, False]
    assert sorted(os.listdir(d)) == ["ckpt_00000004.json", "ckpt_00000004.npz"]
    mgr.purge()
    assert not os.path.exists(d)


@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("noise", ["xorshift", "threefry"])
def test_restore_engine_state_onto_template(tmp_path, layout, noise):
    """An EngineState / PackedEngineState round-trips leaf for leaf: each
    leaf back on the template's device and dtype (tensors) or dtype (the
    threefry keys, a numpy int64 array)."""
    st = _engine_state(layout, noise)
    assert isinstance(st, engine.PackedEngineState if layout == "packed" else engine.EngineState)
    save(str(tmp_path), 3, st, meta={"traces": [[1, 2], [3, 4]]})
    template = _engine_state(layout, noise, B=2)._replace(
        best_H=torch.zeros_like(st.best_H))
    got, meta = restore(str(tmp_path), template)
    _assert_same_tree(got, st)
    assert meta["traces"] == [[1, 2], [3, 4]]


def test_restore_python_scalar_and_none_leaves(tmp_path):
    """The single-problem threefry key is a tuple of Python ints; None leaves
    stay None."""
    tree = {"key": (7, 11), "none": None, "arr": (torch.ones(2, dtype=torch.int8),)}
    save(str(tmp_path), 1, tree)
    got, _ = restore(str(tmp_path), {"key": (0, 0), "none": None,
                                     "arr": (torch.zeros(2, dtype=torch.int8),)})
    assert got["key"] == (7, 11) and type(got["key"][0]) is int and got["none"] is None
    assert got["arr"][0].dtype == torch.int8 and got["arr"][0].tolist() == [1, 1]


def test_restore_missing_leaf_and_no_checkpoint(tmp_path):
    save(str(tmp_path), 1, {"a": torch.ones(1)})
    with pytest.raises(KeyError, match="missing leaf b"):
        restore(str(tmp_path), {"a": torch.ones(1), "b": torch.ones(1)})
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "empty"), {"a": torch.ones(1)})
    assert latest_step(str(tmp_path / "empty")) is None


def test_purge_leaves_other_files(tmp_path):
    d = tmp_path / "g"
    save(str(d), 1, {"a": torch.ones(1)})
    (d / "notes.txt").write_text("keep")
    purge(str(d))
    assert os.listdir(d) == ["notes.txt"]
    purge(str(tmp_path / "absent"))  # no directory: nothing to do


# ---------------------------------------------------------------------------
# The policy fields and the fingerprint
# ---------------------------------------------------------------------------
def test_policy_fields_are_jax_packages():
    assert dataclasses.asdict(ResiliencePolicy()) == dataclasses.asdict(JPolicy())
    pol = ResiliencePolicy(checkpoint_dir="ckpt", checkpoint_interval=3, keep_checkpoints=1,
                           cleanup_on_success=False)
    assert pol.checkpoint_dir == "ckpt"  # no longer raises
    assert dataclasses.asdict(pol) == dataclasses.asdict(JPolicy(**dataclasses.asdict(pol)))


def _items(jax, hp, **kw):
    g = jgset if jax else gset
    Req = JRequest if jax else AnnealRequest
    out = []
    for i, p in enumerate(_problems(g)):
        req = Req(problem=p, hp=hp, seed=i + 1, **kw)
        out.append((i, req, p, p.to_ising()))
    return out


@pytest.mark.parametrize("backend", ["sparse", "dense"])
@pytest.mark.parametrize("case", ["ssa", "ssa-target-config", "ssqa"])
def test_group_fingerprint_equals_jax(backend, case):
    if case == "ssqa":
        kw = dict(n_trials=8, n_replicas=4, m_shot=3, tau=4, i0_min=1, i0_max=8)
        hp, jhp, extra, jextra = SSQAHyperParams(**kw), JSSQA(**kw), {"algo": "ssqa"}, {
            "algo": "ssqa"}
    else:
        hp, jhp, extra, jextra = SSAHyperParams(**HP), JHP(**HP), {}, {}
    if case == "ssa-target-config":
        from repro.core import SolverConfig as JConfig

        extra = {"target_cut": 40, "config": SolverConfig(backend=backend)}
        jextra = {"target_cut": 40, "config": JConfig(backend=backend)}
    args = ("ssa" if case != "ssqa" else "ssqa", 64, backend, "packed", "xorshift", 2)
    got = group_fingerprint(*args, _items(False, hp, **extra))
    want = jfingerprint(*args, _items(True, jhp, **jextra))
    assert got == want and len(got) == 20


def test_group_fingerprint_keys_backend_chunk_and_problem():
    items = _items(False, SSAHyperParams(**HP))
    base = group_fingerprint("ssa", 64, "cuda", "dense", "xorshift", 1, items)
    assert base != jfingerprint("ssa", 64, "pallas", "dense", "xorshift", 1,
                                _items(True, JHP(**HP)))  # the backend name is hashed
    assert base != group_fingerprint("ssa", 64, "dense", "dense", "xorshift", 1, items)
    assert base != group_fingerprint("ssa", 64, "cuda", "dense", "xorshift", 2, items)
    assert base != group_fingerprint("ssa", 64, "cuda", "dense", "xorshift", 1, items[:1])
    assert base == group_fingerprint("ssa", 64, "cuda", "dense", "xorshift", 1, items)


# ---------------------------------------------------------------------------
# One-shot kill/resume (tests/test_chaos.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_kill_mid_solve_resumes_bit_identical(backend, tmp_path):
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path))
    inj = FaultInjector()
    inj.arm("kill", chunk=2)
    with pytest.raises(InjectedKill):  # the kill escapes like a real death
        _svc(backend, resilience=pol, faults=inj).solve(_requests())
    assert os.listdir(tmp_path)  # the checkpoints survived the "crash"
    (group,) = os.listdir(tmp_path)
    assert latest_step(str(tmp_path / group)) == 3

    resumed = _svc(backend, resilience=pol).solve(_requests())  # a "new process"
    for base, want, r in zip(_baseline(backend), _jax_baseline(backend), resumed):
        _assert_bit_identical(r, base)
        _assert_bit_identical(r, want)
        assert r.status == "ok" and [e.kind for e in r.events] == ["resume"]
    assert resumed[0].events[0].detail["chunk"] == 3  # killed after chunk 2
    assert os.listdir(tmp_path) == []  # purged after success


def test_kill_resume_events_match_jax(tmp_path):
    """The JAX service, killed and resumed the same way, reports the same
    statuses, chunks and event kinds."""
    out = {}
    for name, mk, reqs, kill in (
            ("port", lambda **kw: _svc("sparse", **kw), _requests, FaultInjector),
            ("jax", lambda **kw: JService(backend="sparse", min_bucket=16, **kw),
             lambda: _requests(jax=True), None)):
        d = str(tmp_path / name)
        Pol = ResiliencePolicy if name == "port" else JPolicy
        if kill is None:
            from repro.ft.faults import FaultInjector as kill
        inj = kill()
        inj.arm("kill", chunk=4)
        with pytest.raises(Exception, match="injected process kill"):
            mk(resilience=Pol(checkpoint_dir=d), faults=inj).solve(reqs())
        out[name] = mk(resilience=Pol(checkpoint_dir=d)).solve(reqs())
    for a, b in zip(out["port"], out["jax"]):
        _assert_bit_identical(a, b)
        assert (a.status, a.chunks_run, a.chunks_total) == (b.status, b.chunks_run,
                                                            b.chunks_total)
        assert [(e.kind, e.detail["chunk"]) for e in a.events] == \
               [(e.kind, e.detail["chunk"]) for e in b.events]


def test_corrupted_checkpoint_rejected_and_rerun(tmp_path):
    """Zeroed xorshift lanes in a restored checkpoint (the generator's fixed
    point) are detected; the service runs the group from scratch."""
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path))
    inj = FaultInjector()
    inj.arm("kill", chunk=2)
    with pytest.raises(InjectedKill):
        _svc("sparse", resilience=pol, faults=inj).solve(_requests())
    for root, _dirs, files in os.walk(tmp_path):
        for fn in files:
            if not fn.endswith(".npz"):
                continue
            path = os.path.join(root, fn)
            with np.load(path) as z:
                flat = {k: z[k] for k in z.files}
            for k in flat:
                if "noise_state" in k:
                    flat[k] = np.zeros_like(flat[k])
                    assert not xorshift_lanes_ok(flat[k], axis=1)
            with open(path, "wb") as f:
                np.savez(f, **flat)
    resumed = _svc("sparse", resilience=pol).solve(_requests())
    kinds = [e.kind for e in resumed[0].events]
    assert "checkpoint_rejected" in kinds and "resume" not in kinds
    for base, r in zip(_baseline("sparse"), resumed):
        _assert_bit_identical(r, base)  # a fresh run, still right


def test_checkpoint_with_wrong_trace_count_rejected(tmp_path):
    """A checkpoint whose traces do not match the group is not resumed."""
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path))
    inj = FaultInjector()
    inj.arm("kill", chunk=1)
    with pytest.raises(InjectedKill):
        _svc("dense", resilience=pol, faults=inj).solve(_requests())
    (group,) = os.listdir(tmp_path)
    side = tmp_path / group / "ckpt_00000002.json"
    meta = json.loads(side.read_text())
    side.write_text(json.dumps(dict(meta, traces=meta["traces"][:1])))
    resumed = _svc("dense", resilience=pol).solve(_requests())
    assert [e.kind for e in resumed[0].events] == ["checkpoint_rejected"]
    for base, r in zip(_baseline("dense"), resumed):
        _assert_bit_identical(r, base)


def test_checkpoint_interval_keep_and_no_cleanup(tmp_path):
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path), checkpoint_interval=2,
                           keep_checkpoints=1, cleanup_on_success=False)
    resp = _svc("cuda", resilience=pol).solve(_requests())
    (group,) = os.listdir(tmp_path)
    assert sorted(os.listdir(tmp_path / group)) == ["ckpt_00000006.json", "ckpt_00000006.npz"]
    # A later identical solve resumes at the end: no chunk runs again.
    again = _svc("cuda", resilience=pol).solve(_requests())
    for a, b in zip(resp, again):
        _assert_bit_identical(a, b)
        assert [(e.kind, e.detail["chunk"]) for e in b.events] == [("resume", 6)]


def test_resume_after_fallback_uses_the_downgraded_fingerprint(tmp_path):
    """A group that walked cuda → dense checkpoints under the dense
    fingerprint, and resumes there after a kill."""
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path))
    inj = FaultInjector()
    inj.arm("compile", backend="cuda")
    inj.arm("kill", chunk=3)
    with pytest.raises(InjectedKill):
        _svc("cuda", resilience=pol, faults=inj).solve(_requests())
    inj2 = FaultInjector()
    inj2.arm("compile", backend="cuda")
    resumed = _svc("cuda", resilience=pol, faults=inj2).solve(_requests())
    for base, r in zip(_baseline("cuda"), resumed):
        _assert_bit_identical(r, base)
        assert r.status == "fallback" and [e.kind for e in r.events] == ["fallback", "resume"]
