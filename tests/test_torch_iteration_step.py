"""The port's fused HA-SSA iteration steps against the JAX package's, on the CPU.

``repro_torch.core.distributed.make_iteration_step`` and
``make_batched_iteration_step`` run one whole I0min→I0max iteration as a
function of the state tuple.  From the same numpy seeds they must equal the
JAX package's jitted steps bit for bit, in every leaf (lanes included), in
every form: the single step, and the batched step with the dense J, packed
spin words, the tiled adjacency and the XNOR-popcount planes.  The single
step must equal the port's ``anneal()`` at the same seed, the batched step
the single step per problem, and every batched form the dense one.  The
cycle loop must take one field contraction per cycle, plus one epilogue per
eligible plateau; the state conversion must round-trip.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.kernels import bitplane as jbitplane  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed, engine, gset  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams, anneal  # noqa: E402

SMALL = dict(n_trials=4, tau=5, i0_min=1, i0_max=8)


def _leaves_equal(got, want, what=""):
    """Every leaf equal, value and dtype (port leaves through
    ``iteration_state_to_arrays``)."""
    got = convert.iteration_state_to_arrays(got)
    for k, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.dtype == b.dtype, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {k}")


def _jax_init(seeds, T, N, batched):
    """The reference tests' start: lanes seeded, one draw taken as m."""
    out = []
    for s in seeds:
        rng, r0 = jrng.xorshift_next_bits(jrng.xorshift_init(s, (T, N)))
        m = r0.astype(jnp.float32)
        out.append((rng, m, jnp.where(m > 0, 0, -1).astype(jnp.int32),
                    jnp.full((T,), 2**30, jnp.int32), m.astype(jnp.int8)))
    if not batched:
        return tuple(np.asarray(x) for x in out[0])
    return (np.stack([np.asarray(o[0]) for o in out], axis=1),
            *(np.stack([np.asarray(o[k]) for o in out]) for k in range(1, 5)))


def _packed_state(st):
    """The JAX package's packed-layout state of a dense-layout one."""
    rng, m, it, bh, bm = st
    return (rng, np.asarray(jbitplane.pack_spins(jnp.asarray(m.astype(np.int8)))), it, bh,
            np.asarray(jbitplane.pack_spins(jnp.asarray(bm))))


def _models(problems):
    """(JAX models, the port's models from the same arrays)."""
    jm = [p.to_ising() for p in problems]
    return jm, [convert.ising_from_arrays(m.n, m.h, m.nbr_idx, m.nbr_w) for m in jm]


def _operands(jmodels, models, j_mode, field_mode, n_bits=None):
    """(the JAX step's problem operands, the port's), built by each package
    from its own models."""
    h = np.stack([np.asarray(m.h, np.int32) for m in jmodels])
    th = torch.from_numpy(np.stack([np.asarray(m.h, np.int32) for m in models]))
    if field_mode == "popcount":
        jp = [jbitplane.pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w, n_bits=n_bits)
              for m in jmodels]
        planes = [np.stack([np.asarray(getattr(p, k)) for p in jp])
                  for k in ("sign", "mags", "base")]
        return (*planes, h), (*convert.packed_j_from_arrays(*planes), th)
    if j_mode == "tiled":
        adj = [np.stack([np.asarray(getattr(m, k), np.int32) for m in jmodels])
               for k in ("nbr_idx", "nbr_w")]
        tadj = [torch.from_numpy(np.stack([getattr(m, k) for m in models])).to(torch.int32)
                for k in ("nbr_idx", "nbr_w")]
        return (*adj, h), (*tadj, th)
    J = np.stack([m.dense_J().astype(np.float32) for m in jmodels])
    tJ = torch.from_numpy(np.stack([m.dense_J() for m in models])).to(torch.float32)
    return (J, h), (tJ, th)


def _run_both(jstep, step, jstate, jprob, prob, iters, packed=False):
    """``iters`` iterations of the JAX step and of the port's from the same
    arrays; each iteration's states must be equal.  Returns both."""
    st = convert.iteration_state_from_arrays(*jstate, packed=packed, device="cpu")
    for k in range(iters):
        jstate = tuple(np.asarray(x) for x in jstep(*jstate, *jprob))
        st = step(*st, *prob)
        _leaves_equal(st, jstate, f"iteration {k}")
    return st, jstate


# ---------------------------------------------------------------------------
# The single step
# ---------------------------------------------------------------------------
def test_single_step_matches_jax_and_anneal():
    """After m_shot iterations: equal to the JAX step in every leaf, and
    best_H / best_m equal to anneal(storage='i0max', record='best',
    noise='xorshift', backend='dense') at the same seed."""
    hp_kw = dict(SMALL, m_shot=3)
    p = gset.king_graph(36, seed=5)
    (jm,), (tm,) = _models([jgset.king_graph(36, seed=5)])
    T, N = hp_kw["n_trials"], tm.n
    jstate = _jax_init([9], T, N, batched=False)
    J = jnp.asarray(jm.dense_J(), jnp.float32)
    jh = jnp.asarray(jm.h, jnp.int32)
    st, _ = _run_both(jax.jit(jdist.make_iteration_step(JHP(**hp_kw))),
                      distributed.make_iteration_step(SSAHyperParams(**hp_kw)), jstate,
                      (J, jh), (torch.from_numpy(tm.dense_J()).float(),
                                torch.from_numpy(np.asarray(tm.h, np.int32))),
                      hp_kw["m_shot"])
    r = anneal(p, SSAHyperParams(**hp_kw), seed=9, storage="i0max", record="best",
               track_energy=False, config=SolverConfig(backend="dense", noise="xorshift"),
               device="cpu")
    np.testing.assert_array_equal(st[3].numpy(), r.best_energy)
    np.testing.assert_array_equal(st[4].numpy(), r.best_m)


def test_single_step_improves_over_iterations():
    """G11 at Table II's schedule: best_H never rises over iterations, and
    best_m's cut is (w_total − best_H) / 2; every iteration equals JAX's."""
    hp_kw = dict(n_trials=4, m_shot=1)
    g = gset.load("G11")
    (jm,), (tm,) = _models([jgset.load("G11")])
    jstep = jax.jit(jdist.make_iteration_step(JHP(**hp_kw)))
    step = distributed.make_iteration_step(SSAHyperParams(**hp_kw))
    jstate = _jax_init([0], 4, tm.n, batched=False)
    jprob = (jnp.asarray(jm.dense_J(), jnp.float32), jnp.asarray(jm.h, jnp.int32))
    prob = (torch.from_numpy(tm.dense_J()).float(), torch.from_numpy(np.asarray(tm.h, np.int32)))
    st, jstate = _run_both(jstep, step, jstate, jprob, prob, 1)
    first = st[3].clone()
    st, _ = _run_both(jstep, step, jstate, jprob, prob, 2)
    assert torch.all(st[3] <= first)
    np.testing.assert_array_equal(g.cut_value(st[4].numpy()), (g.w_total - st[3].numpy()) // 2)


# ---------------------------------------------------------------------------
# The batched step
# ---------------------------------------------------------------------------
def test_batched_step_matches_per_problem_single_steps():
    """B stacked problems through the batched step == B single steps, and
    both == the JAX package's."""
    hp_kw = dict(SMALL, m_shot=2)
    jmodels, models = _models([jgset.king_graph(36, seed=5), jgset.toroidal_grid(36, seed=7)])
    T, N, B = hp_kw["n_trials"], 36, len(models)
    jstate = _jax_init([20 + i for i in range(B)], T, N, batched=True)
    jprob, prob = _operands(jmodels, models, "dense", "dense")
    stB, _ = _run_both(jax.jit(jdist.make_batched_iteration_step(JHP(**hp_kw))),
                       distributed.make_batched_iteration_step(SSAHyperParams(**hp_kw)),
                       jstate, jprob, prob, hp_kw["m_shot"])
    step1 = distributed.make_iteration_step(SSAHyperParams(**hp_kw))
    for i in range(B):
        st = convert.iteration_state_from_arrays(jstate[0][:, i], *(x[i] for x in jstate[1:]),
                                                 device="cpu")
        for _ in range(hp_kw["m_shot"]):
            st = step1(*st, prob[0][i], prob[1][i])
        for k, (a, b) in enumerate(zip(st, stB)):
            np.testing.assert_array_equal(a.numpy(), (b[:, i] if k == 0 else b[i]).numpy(),
                                          err_msg=f"problem {i} leaf {k}")


# (storage_layout, j_mode, field_mode): every form the reference runs.
FORMS = [("dense", "dense", "dense"), ("packed", "dense", "dense"),
         ("dense", "tiled", "dense"), ("packed", "tiled", "dense"),
         ("dense", "dense", "popcount"), ("packed", "dense", "popcount"),
         ("dense", "tiled", "popcount")]


def _form_run(form, iters=2):
    """One form of both packages on the two 4-regular tori (equal degree,
    so the adjacency stacks), popcount with two magnitude planes; returns
    the port's final state unpacked to int8 spins."""
    layout, j_mode, field_mode = form
    hp_kw = dict(SMALL, n_trials=3, m_shot=iters)
    jmodels, models = _models([jgset.toroidal_grid(36, seed=5), jgset.toroidal_grid(36, seed=7)])
    assert max(jbitplane.adjacency_weight_bits(m.n, m.nbr_idx, m.nbr_w) for m in jmodels) <= 2
    jstate = _jax_init([20, 21], hp_kw["n_trials"], 36, batched=True)
    if layout == "packed":
        jstate = _packed_state(jstate)
    jprob, prob = _operands(jmodels, models, j_mode, field_mode, n_bits=2)
    opts = dict(storage_layout=layout, j_mode=j_mode, tile_n=16, field_mode=field_mode)
    st, _ = _run_both(jax.jit(jdist.make_batched_iteration_step(JHP(**hp_kw), **opts)),
                      distributed.make_batched_iteration_step(SSAHyperParams(**hp_kw), **opts),
                      jstate, jprob, prob, iters, packed=layout == "packed")
    if layout == "packed":
        st = (st[0], engine.unpack_spins(st[1], 36).float(), st[2], st[3],
              engine.unpack_spins(st[4], 36))
    return st


@pytest.mark.parametrize("form", FORMS, ids=lambda f: "-".join(f))
def test_batched_form_matches_jax_and_dense(form):
    """Each form equals the same form of the JAX step in every leaf, and
    (packed words unpacked) the port's dense form."""
    got = _form_run(form)
    want = _form_run(FORMS[0])
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{form} leaf {k}")


# ---------------------------------------------------------------------------
# Arguments
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,message", [
    (dict(storage_layout="bits"), "unknown storage_layout 'bits'"),
    (dict(j_mode="sparse"), "unknown j_mode 'sparse'"),
    (dict(field_mode="auto"), "unknown field_mode 'auto'"),
])
def test_batched_step_rejects_unknown_modes(kw, message):
    for make in (jdist.make_batched_iteration_step, distributed.make_batched_iteration_step):
        with pytest.raises(ValueError, match=message):
            make(SSAHyperParams(**SMALL), **kw)


@pytest.mark.parametrize("make", [distributed.make_iteration_step,
                                  distributed.make_batched_iteration_step],
                         ids=["single", "batched"])
def test_mesh_raises_not_implemented(make):
    """The steps take a data × model mesh now (tests/test_torch_mesh_step.py):
    a mesh builds a step, and only an object that is no mesh raises."""
    from repro_torch.sharding import abstract_mesh

    assert callable(make(SSAHyperParams(**SMALL), mesh=abstract_mesh((1, 1), ("data", "model"))))
    with pytest.raises(TypeError, match="mesh must be"):
        make(SSAHyperParams(**SMALL), mesh=object())


def test_exports():
    assert {"make_iteration_step", "make_batched_iteration_step",
            "SPIN_AXIS"} <= set(distributed.__all__)
    assert distributed.SPIN_AXIS == jdist.SPIN_AXIS == "model"


# ---------------------------------------------------------------------------
# One contraction per cycle
# ---------------------------------------------------------------------------
_MM = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default}
_GATHER = {torch.ops.aten.index.Tensor, torch.ops.aten.gather.default}


class _CountOps(TorchDispatchMode):
    """Counts the matrix products and the gathers dispatched under it."""

    def __init__(self):
        super().__init__()
        self.mm = self.gather = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in _MM
        self.gather += func in _GATHER
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("eligible,track_energy", [(False, False), (True, False),
                                                   (False, True), (True, True)])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_plateau_has_one_contraction_per_cycle(kind, eligible, track_energy):
    """One plateau of C cycles: C contractions, plus one epilogue for the
    final state when it is eligible or energies are tracked; the dense loop
    runs no gather and the sparse loop no matrix product."""
    model = gset.toroidal_grid(64, seed=17).to_ising()
    bk = engine.make_backend(kind, model, n_trials=4, noise="xorshift", device="cpu")
    state = bk.init_state(0)
    length = 16
    with _CountOps() as ops:
        bk.run_plateau(state, 8, length=length, eligible=eligible, track_energy=track_energy)
    want = length + (eligible or track_energy)
    assert (ops.mm, ops.gather) == ((want, 0) if kind == "dense" else (0, want))


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_iteration_step_contractions(batched):
    """One whole step: the sum of its plateaus' lengths, plus one epilogue
    for each eligible plateau (one, at I0max, under HA-SSA)."""
    hp = SSAHyperParams(**SMALL)
    plateaus = engine.schedule_plateaus(hp.schedule("hassa"), "i0max")
    assert sum(p.eligible for p in plateaus) == 1
    want = sum(p.length for p in plateaus) + 1
    jmodels, models = _models([jgset.toroidal_grid(36, seed=5)] * (2 if batched else 1))
    jstate = _jax_init([3] * len(models), hp.n_trials, 36, batched=batched)
    st = convert.iteration_state_from_arrays(*jstate, device="cpu")
    _, (J, h) = _operands(jmodels, models, "dense", "dense")
    if batched:
        step = distributed.make_batched_iteration_step(hp)
    else:
        step, J, h = distributed.make_iteration_step(hp), J[0], h[0]
    with _CountOps() as ops:
        step(*st, J, h)
    assert (ops.mm, ops.gather) == (want, 0)


# ---------------------------------------------------------------------------
# The state's conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_iteration_state_round_trip(batched, packed):
    """The JAX step's arrays → the port's tensors → arrays, unchanged in
    value and dtype; lanes and words are int32 tensors of the same bits."""
    arrays = _jax_init([1, 2] if batched else [1], 3, 40, batched=batched)
    if packed:
        arrays = _packed_state(arrays)
    st = convert.iteration_state_from_arrays(*arrays, packed=packed, device="cpu")
    assert st[0].dtype == torch.int32
    assert st[1].dtype == (torch.int32 if packed else torch.float32)
    assert st[4].dtype == (torch.int32 if packed else torch.int8)
    back = convert.iteration_state_to_arrays(st)
    for a, b in zip(back, arrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
