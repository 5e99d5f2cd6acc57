"""The streaming service and chunk checkpoints on the card.

The CUDA kernels have no CPU or interpret mode, so these tests are marked
``cuda`` and skip on a host without a GPU.  They hold the stream's slot
tables on the card — K1, K4, K2 and the ring modes launched once per
quantum for every slot — against the one-shot service's plain versions on
the CPU, bit for bit, and a checkpoint of a CUDA lane restored onto the
card.  On the GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_stream_cuda.py

This file imports no JAX: the GPU host runs the port alone.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import engine, gset  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams  # noqa: E402
from repro_torch.core.ssqa import SSQAHyperParams  # noqa: E402
from repro_torch.ft.faults import FaultInjector, InjectedCompileFailure, InjectedKill  # noqa: E402
from repro_torch.kernels import ssa_update  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AnnealRequest,
    AnnealService,
    ResiliencePolicy,
    StreamingAnnealService,
    StreamPolicy,
)

HP = dict(n_trials=12, m_shot=4, tau=6, i0_min=1, i0_max=8)
SSQA = dict(n_trials=16, n_replicas=8, m_shot=3, tau=4, i0_min=1, i0_max=8)
MODES = {"K1": {}, "K4": {"noise_mode": "pregen"}, "K2": {"field_mode": "popcount"}}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: exact f32
    return torch.device("cuda")


def _requests(ssqa=False):
    """Five requests over two buckets (64 and 128) and two degrees."""
    problems = [gset.toroidal_grid(36, seed=s, name=f"t{s}") for s in range(3)] + [
        gset.king_graph(49, seed=3, name="k49"), gset.toroidal_grid(100, seed=4, name="t100")]
    if ssqa:
        return [AnnealRequest(problem=p, hp=SSQAHyperParams(**SSQA), seed=7 + s, algo="ssqa")
                for s, p in enumerate(problems)]
    return [AnnealRequest(problem=p, hp=SSAHyperParams(**HP), seed=s,
                          target_cut=(40 if s == 1 else None))
            for s, p in enumerate(problems)]


@functools.lru_cache(maxsize=None)
def _plain(ssqa=False, **opts):
    """The one-shot service's plain versions on the CPU: the reference."""
    return AnnealService(backend="cuda", min_bucket=16, device="cpu",
                         backend_opts=dict(opts)).solve(_requests(ssqa))


def _same(got, want):
    np.testing.assert_array_equal(got.result.best_cut, want.result.best_cut)
    np.testing.assert_array_equal(got.result.best_m, want.result.best_m)
    np.testing.assert_array_equal(got.result.best_energy, want.result.best_energy)
    np.testing.assert_array_equal(got.chunk_best_cut, want.chunk_best_cut)


def _reset():
    for f in (ssa_update.ssa_plateau_packed_batched, ssa_update.ssa_plateau_batched,
              ssa_update.ssa_plateau_popcount_batched, ssa_update.local_field):
        f.launches = 0
        if hasattr(f, "ring_launches"):
            f.ring_launches = 0


def _svc(layout="packed", **kw):
    return AnnealService(backend="cuda", min_bucket=16, storage_layout=layout, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stream_on_card_equals_plain(cuda_device, mode, layout):
    """Tables of 2 slots on the card (backfills, an early target): every
    lane equals the CPU plain one-shot solve, and the mode's kernel is
    launched once per plateau (K1, K4) or chain (K2) per quantum."""
    opts = MODES[mode]
    ss = StreamingAnnealService(service=_svc(layout, backend_opts=dict(opts)),
                                policy=StreamPolicy(slots_per_table=2))
    _reset()
    tickets = [ss.submit(r) for r in _requests()]
    ss.run_until_idle()
    for t, want in zip(tickets, _plain(**opts)):
        assert t.result(timeout=0).status == "ok"
        _same(t.result(timeout=0), want)
    q = ss.stats["stream_quanta"]
    steps = SSAHyperParams(**HP).steps
    got = {"K1": ssa_update.ssa_plateau_packed_batched.launches,
           "K4": ssa_update.ssa_plateau_batched.launches,
           "K2": ssa_update.ssa_plateau_popcount_batched.launches}
    want = {k: 0 for k in got}
    want[mode] = q if mode == "K2" else q * steps
    assert got == want and ss.stats["stream_backfills"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{}, {"field_mode": "popcount"}], ids=["K1 ring", "K2 ring"])
def test_stream_ssqa_on_card_equals_plain(cuda_device, opts):
    ss = StreamingAnnealService(service=_svc(backend_opts=dict(opts)),
                                policy=StreamPolicy(slots_per_table=2))
    _reset()
    tickets = [ss.submit(r) for r in _requests(ssqa=True)]
    ss.run_until_idle()
    for t, want in zip(tickets, _plain(True, **opts)):
        _same(t.result(timeout=0), want)
    ring = (ssa_update.ssa_plateau_popcount_batched if opts
            else ssa_update.ssa_plateau_packed_batched).ring_launches
    assert ring > 0


@pytest.mark.cuda
def test_stream_kill_resume_on_card(cuda_device, tmp_path):
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path))
    inj = FaultInjector()
    inj.arm("kill", chunk=1)
    ss = StreamingAnnealService(service=_svc(resilience=pol, faults=inj),
                                policy=StreamPolicy(slots_per_table=2))
    for r in _requests():
        ss.submit(r)
    with pytest.raises(InjectedKill):
        ss.run_until_idle()
    ss2 = StreamingAnnealService(service=_svc(resilience=pol),
                                 policy=StreamPolicy(slots_per_table=2))
    tickets = [ss2.submit(r) for r in _requests()]
    ss2.run_until_idle()
    for t, want in zip(tickets, _plain()):
        _same(t.result(timeout=0), want)
    assert ss2.stats["stream_resumes"] >= 1 and os.listdir(tmp_path) == []


@pytest.mark.cuda
def test_stream_downgrade_on_card_carries_state(cuda_device, monkeypatch):
    """An injected compile fault on the card's second quantum moves the
    table to the dense backend on the card, the state carried: every lane
    still equals the plain one-shot solve."""
    real = engine.BatchedCudaBackend.run_shots
    calls = {"n": 0}

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise InjectedCompileFailure("injected compile failure (quantum 2)")
        return real(self, *a, **k)

    monkeypatch.setattr(engine.BatchedCudaBackend, "run_shots", flaky)
    ss = StreamingAnnealService(service=_svc(), policy=StreamPolicy(slots_per_table=2))
    tickets = [ss.submit(r) for r in _requests()]
    ss.run_until_idle()
    for t, want in zip(tickets, _plain()):
        _same(t.result(timeout=0), want)
    assert ss.stats["fallback_compile"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{}, {"field_mode": "popcount"}], ids=["K1", "K2"])
def test_cuda_lane_checkpoint_restores_onto_the_card(cuda_device, tmp_path, opts):
    """A one-shot solve on the card, killed after its second chunk: its
    checkpoint restores onto the card (every leaf a CUDA tensor of the
    template's dtype), and a fresh service resumes it to the plain run's
    answers."""
    reqs = _requests()[:3]  # one group: bucket 64, degree 4
    pol = ResiliencePolicy(checkpoint_dir=str(tmp_path))
    inj = FaultInjector()
    inj.arm("kill", chunk=1)
    with pytest.raises(InjectedKill):
        _svc(backend_opts=dict(opts), resilience=pol, faults=inj).solve(reqs)
    (group,) = os.listdir(tmp_path)
    bk = engine.make_batched_backend("cuda", n_bucket=64, n_trials=HP["n_trials"],
                                     storage_layout="packed", device=cuda_device,
                                     **({"field_mode": "popcount"} if opts else {}))
    prob = bk.stack([r.problem.to_ising() for r in reqs] + [reqs[0].problem.to_ising()])
    template = bk.init_state(prob, bk.init_noise([0, 1, 2, 0], [36] * 4))
    st, meta = ckpt.restore(str(tmp_path / group), template)
    assert meta["step"] == 2 and len(meta["traces"]) == 3
    for a, b in zip(st, template):
        assert a.device.type == "cuda" and a.dtype == b.dtype and a.shape == b.shape
    resumed = _svc(backend_opts=dict(opts), resilience=pol).solve(reqs)
    for got, want in zip(resumed, _plain(**opts)[:3]):
        _same(got, want)
        assert [e.kind for e in got.events] == ["resume"]
