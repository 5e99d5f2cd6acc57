"""The port's iteration steps on a ``data`` × ``model`` mesh, their dry-run
lowerings and the H100 roofline report, against the JAX package, on the CPU.

``repro_torch.core.distributed.make_iteration_step`` and
``make_batched_iteration_step`` take a mesh of gloo ranks
(``repro_torch.launch.mesh.make_mesh``); each rank passes its block of
every argument (``convert.iteration_state_block``) and gets its block back.
Joined (``convert.iteration_state_join``), the blocks must equal the JAX
package's steps at ``mesh=None`` in every leaf, lanes included, bit for
bit, on meshes of 1 × 1, 1 × 2, 2 × 1 and 2 × 2 ranks, with an N that
``model`` does not divide and a T (single step) or B (batched) that
``data`` does not divide.  The ranks run in subprocesses joined through a
``file://`` rendezvous; the JAX package runs in this process.

``anneal_step_lowering`` and ``batched_anneal_step_lowering`` trace one
rank on fake tensors: their arguments' shapes, dtypes and placements must
be the JAX package's lowered ones, their FLOPs the closed form, and the
popcount and tiled forms must hold no dense J and issue no collective in
the cycle loop.  ``launch/hlo_analysis.py`` keeps the JAX package's report
on the H100's constants.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.core import SSAHyperParams as JHP  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.kernels import bitplane as jbitplane  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.sharding import mesh_fingerprint as jmesh_fp  # noqa: E402
from repro_torch import convert, sharding  # noqa: E402
from repro_torch.core import distributed, engine, gset  # noqa: E402
from repro_torch.core.lowering import ArgInfo, lower  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
HP = dict(n_trials=3, m_shot=2, tau=3, i0_min=1, i0_max=8)
AXES = ("data", "model")
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]

# name, batched, form, the problems' (generator, N, seeds), T.  N = 35 is
# divided by no model axis of 2 and T = 3, B = 3 by no data axis of 2;
# N = 64 gives blocks of whole 32-bit words on a model axis of 2.
CASES = [
    ("single-35", False, {}, ("king", 35, (5,)), 3),
    ("single-64", False, {}, ("torus", 64, (6,)), 4),
    ("dense", True, {}, ("torus", 35, (5, 6, 7)), 3),
    ("dense-64", True, {}, ("torus", 64, (5, 6)), 4),
    ("packed", True, dict(storage_layout="packed"), ("torus", 35, (5, 6, 7)), 3),
    ("packed-64", True, dict(storage_layout="packed"), ("torus", 64, (5, 6)), 4),
    ("tiled", True, dict(j_mode="tiled"), ("torus", 35, (5, 6, 7)), 3),
    ("popcount", True, dict(field_mode="popcount"), ("torus", 35, (5, 6, 7)), 3),
    ("packed-popcount", True, dict(storage_layout="packed", field_mode="popcount"),
     ("torus", 35, (5, 6, 7)), 3),
]


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


def _case_arrays(case):
    """(the JAX step's state, its operands, the port's operands), from the
    same numpy arrays; h is drawn nonzero so that its blocks matter."""
    name, batched, form, (kind, N, seeds), T = case
    make = jgset.king_graph if kind == "king" else jgset.toroidal_grid
    models = [make(N, seed=s).to_ising() for s in seeds]
    h = np.random.default_rng(len(name)).integers(-2, 3, (len(seeds), N)).astype(np.int32)
    state = _jax_init([20 + s for s in seeds], T, N, batched)
    if form.get("storage_layout") == "packed":
        rng, m, it, bh, bm = state
        state = (rng, np.asarray(jbitplane.pack_spins(jnp.asarray(m.astype(np.int8)))), it, bh,
                 np.asarray(jbitplane.pack_spins(jnp.asarray(bm))))
    if form.get("field_mode") == "popcount":
        jp = [jbitplane.pack_couplings_from_adjacency(m.n, m.nbr_idx, m.nbr_w, n_bits=2)
              for m in models]
        planes = [np.stack([np.asarray(getattr(p, k)) for p in jp])
                  for k in ("sign", "mags", "base")]
        return state, (*planes, h), (*convert.packed_j_from_arrays(*planes), torch.from_numpy(h))
    if form.get("j_mode") == "tiled":
        adj = [np.stack([np.asarray(getattr(m, k), np.int32) for m in models])
               for k in ("nbr_idx", "nbr_w")]
        return state, (*adj, h), (*(torch.from_numpy(a) for a in adj), torch.from_numpy(h))
    J = np.stack([m.dense_J().astype(np.float32) for m in models])
    if not batched:
        J, h = J[0], h[0]
    return state, (J, h), (torch.from_numpy(J), torch.from_numpy(h))


@functools.lru_cache(maxsize=None)
def _jax_results():
    """name → (the start, the port's operands, the JAX step's state after
    HP's m_shot iterations at mesh=None)."""
    out = {}
    for case in CASES:
        name, batched, form = case[:3]
        state, jprob, tprob = _case_arrays(case)
        make = jdist.make_batched_iteration_step if batched else jdist.make_iteration_step
        kw = dict(form, tile_n=16) if batched else {}
        jstep = jax.jit(make(JHP(**HP), **kw))
        st = state
        for _ in range(HP["m_shot"]):
            st = tuple(np.asarray(x) for x in jstep(*st, *jprob))
        out[name] = (state, tprob, st)
    return out


RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, shape = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    in_path, out_path = sys.argv[5], sys.argv[6]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    from repro_torch import convert
    from repro_torch.core import distributed
    from repro_torch.core.ssa import SSAHyperParams
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(json.loads(shape), ("data", "model"), device="cpu")
    ref = np.load(in_path)
    hp = SSAHyperParams(**json.loads(str(ref["hp"])))
    out = {}
    for name, batched, form, n_prob in json.loads(str(ref["cases"])):
        packed = form.get("storage_layout") == "packed"
        state = convert.iteration_state_from_arrays(*(ref[f"{name}/s{k}"] for k in range(5)),
                                                    packed=packed, device="cpu")
        problem = tuple(torch.from_numpy(ref[f"{name}/p{k}"]) for k in range(n_prob))
        st, prob = convert.iteration_state_block(state, problem, mesh, batched=batched, **form)
        if batched:
            step = distributed.make_batched_iteration_step(hp, mesh, tile_n=16, **form)
        else:
            step = distributed.make_iteration_step(hp, mesh)
        for _ in range(hp.m_shot):
            st = step(*st, *prob)
        out[name] = st
    torch.save(out, out_path.format(rank=rank))
    dist.destroy_process_group()
""")


@functools.lru_cache(maxsize=None)
def _mesh_blocks(shape):
    """Every case on the gloo ranks of a ``shape`` mesh: each rank's
    blocks, name → state block."""
    world = math.prod(shape)
    ref = {"hp": json.dumps(HP),
           "cases": json.dumps([(c[0], c[1], c[2], len(_jax_results()[c[0]][1])) for c in CASES])}
    for name, (state, tprob, _) in _jax_results().items():
        ref.update({f"{name}/s{k}": a for k, a in enumerate(state)})
        ref.update({f"{name}/p{k}": t.numpy() for k, t in enumerate(tprob)})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "in.npz")
        np.savez(in_path, **ref)
        out_path = os.path.join(tmp, "rank{rank}.pt")
        procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
                                   os.path.join(tmp, "store"), json.dumps(shape), in_path,
                                   out_path], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"mesh {shape} rank {r}:\n{err[-3000:]}"
        return [torch.load(out_path.format(rank=r)) for r in range(world)]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_step_matches_jax(shape, case):
    """The joined blocks equal the JAX package's mesh=None step after two
    iterations, every leaf, value and dtype."""
    _, batched, form, *_ = next(c for c in CASES if c[0] == case)
    want = _jax_results()[case][2]
    st = convert.iteration_state_join([b[case] for b in _mesh_blocks(shape)],
                                      sharding.abstract_mesh(shape, AXES), want,
                                      batched=batched, **form)
    got = convert.iteration_state_to_arrays(st)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, (case, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{shape} {case} leaf {k}")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_blocks_round_trip(name):
    """Cutting every rank's blocks of a 2 × 2 mesh and joining them gives
    the whole state back; a block of an odd dim is ceil(dim / 2) long."""
    case = next(c for c in CASES if c[0] == name)
    state, tprob, _ = _jax_results()[name]
    batched, form = case[1], case[2]
    packed = form.get("storage_layout") == "packed"
    st = convert.iteration_state_from_arrays(*state, packed=packed, device="cpu")
    mesh = sharding.abstract_mesh((2, 2), AXES)
    blocks = [convert.iteration_state_block(st, tprob, dataclasses.replace(mesh, rank=r),
                                            batched=batched, **form)[0] for r in range(4)]
    back = convert.iteration_state_join(blocks, mesh, st, batched=batched, **form)
    for a, b in zip(back, st):
        assert torch.equal(a, b)
    specs = distributed.iteration_specs(batched, **form)
    for (leaf_name, spec), blk, whole in zip(specs, blocks[0], st):
        want = tuple(-(-n // (2 if a else 1)) for n, a in zip(whole.shape, spec))
        assert tuple(blk.shape) == want, (leaf_name, blk.shape, want)


def test_join_rejects_differing_replicas():
    """Ranks holding a replica of a block (here best_H on the two model
    ranks of a data row) must agree."""
    state, tprob, _ = _jax_results()["single-35"]
    st = convert.iteration_state_from_arrays(*state, device="cpu")
    mesh = sharding.abstract_mesh((1, 2), AXES)
    blocks = [list(convert.iteration_state_block(st, tprob, dataclasses.replace(mesh, rank=r))[0])
              for r in range(2)]
    blocks[1][3] = blocks[1][3] + 1
    with pytest.raises(ValueError, match="best_H: rank 1's replica"):
        convert.iteration_state_join(blocks, mesh, st)


# ---------------------------------------------------------------------------
# The meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("build,need", [
    (lambda m: m.make_production_mesh(), 256),
    (lambda m: m.make_production_mesh(multi_pod=True), 512),
    (lambda m: m.make_shrunken_mesh(), 128),
    (lambda m: m.make_mesh((2, 2), AXES), 4),
])
def test_mesh_builders_raise_on_too_few_ranks(build, need):
    """One process asked for a pod: ValueError naming the count needed and
    the count running, in both packages."""
    have_j = len(jax.devices())
    if need > have_j:
        with pytest.raises(ValueError) as jerr:
            build(jmesh)
        assert f"{need} devices" in str(jerr.value) and f"only {have_j} exist" in str(jerr.value)
    with pytest.raises(ValueError) as err:
        build(tmesh)
    assert f"needs {need} ranks" in str(err.value) and "only 1 exist" in str(err.value)


def test_one_rank_mesh_on_the_cpu():
    """make_mesh((1, 1)) without a process group makes a one-rank gloo group:
    rank 0 at (0, 0), both axes in the default group; its fingerprint is the
    JAX package's of a 1 × 1 mesh; a meshed step on it equals the JAX
    package's mesh=None step."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    try:
        mesh = tmesh.make_mesh((1, 1), AXES, device="cpu")
        assert (mesh.coords, mesh.backend, mesh.groups) == ((0, 0), "gloo", (None, None))
        jm = JMesh(np.array(jax.devices()[:1]).reshape(1, 1), AXES)
        assert sharding.mesh_fingerprint(mesh) == jmesh_fp(jm)
        state, tprob, want = _jax_results()["single-35"]
        st = convert.iteration_state_from_arrays(*state, device="cpu")
        step = distributed.make_iteration_step(SSAHyperParams(**HP), mesh)
        sharding.reset_collective_counts()
        for _ in range(HP["m_shot"]):
            st = step(*st, *tprob)
        assert sharding.collective_counts["all_gather"] > 0
        for a, b in zip(convert.iteration_state_to_arrays(st), want):
            np.testing.assert_array_equal(a, b)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def test_mesh_step_example_on_two_gloo_ranks():
    """examples/mesh_step.py under torchrun: G11's blocks on a 1 × 2 mesh of
    gloo ranks, joined by rank 0, equal the unsharded step."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2",
                          "-m", "repro_torch.examples.mesh_step", "--mesh", "1x2", "--device",
                          "cpu", "--trials", "4", "--tau", "2"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "G11 on a 1x2 gloo mesh" in out.stdout
    assert "joined blocks == the unsharded step: True" in out.stdout


def test_mesh_helpers():
    """abstract_mesh, mesh_axis_size over a tuple, mesh_axis_rank and the
    abstract mesh's refusal to issue a collective."""
    pod = sharding.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert pod.shape == {"pod": 2, "data": 16, "model": 16} and pod.size == 512
    assert sharding.mesh_axis_size(pod, ("pod", "data")) == 32
    assert sharding.mesh_axis_size(pod, None) == sharding.mesh_axis_size(pod, "x") == 1
    assert sharding.mesh_axis_rank(dataclasses.replace(pod, rank=16 * 16 + 18), "data") == 1
    assert sharding.mesh_axis_rank(dataclasses.replace(pod, rank=16 * 16 + 18), "model") == 2
    assert sharding.mesh_fingerprint(pod) == ((("pod", 2), ("data", 16), ("model", 16)),
                                              tuple(range(512)))
    with pytest.raises(RuntimeError, match="abstract mesh issues no collective"):
        sharding.all_gather_last(pod, torch.zeros(2, 4), "model")
    with pytest.raises(ValueError, match="rank != axes"):
        sharding.abstract_mesh((2, 2), ("data",))



# ---------------------------------------------------------------------------
# The lowerings
# ---------------------------------------------------------------------------
LOWER_FORMS = [None, {}, dict(storage_layout="packed"), dict(j_mode="tiled"),
               dict(field_mode="popcount"), dict(storage_layout="packed", j_mode="tiled"),
               dict(storage_layout="packed", field_mode="popcount")]
SMALL_HP = dict(n_trials=4, m_shot=1, tau=2, i0_min=1, i0_max=4)


def _form_id(form):
    return "single" if form is None else "-".join(form.values()) or "dense"


def _lowerings(form, mesh_shape, jmesh_1x1=None, **shape):
    """The port's lowering at an abstract mesh of ``mesh_shape`` and, with
    a 1 × 1 JAX mesh, the JAX package's."""
    mesh = sharding.abstract_mesh(mesh_shape, ("pod",) * (len(mesh_shape) - 2) + AXES)
    if form is None:
        port = distributed.anneal_step_lowering(mesh, hp=SSAHyperParams(**SMALL_HP), **shape)
        ref = jmesh_1x1 and jdist.anneal_step_lowering(jmesh_1x1, hp=JHP(**SMALL_HP), **shape)
    else:
        port = distributed.batched_anneal_step_lowering(
            mesh, hp=SSAHyperParams(**SMALL_HP), tile_n=16, j_bits=2, **form, **shape)
        ref = jmesh_1x1 and jdist.batched_anneal_step_lowering(
            jmesh_1x1, hp=JHP(**SMALL_HP), tile_n=16, j_bits=2, **form, **shape)
    return port, ref


@pytest.mark.parametrize("form", LOWER_FORMS, ids=_form_id)
def test_lowering_args_match_reference(form):
    """Each argument's global shape and dtype equal the JAX package's
    lowered ``args_info`` (its uint32 lanes and words are the port's int32
    of the same bits), its placement the JAX package's ``in_shardings``,
    and its per-device shape on an abstract 16 × 16 mesh the shard shape of
    that spec (ceil on a dim its axis does not divide)."""
    jm = JMesh(np.array(jax.devices()[:1]).reshape(1, 1), AXES)
    shape = dict(n_spins=70, n_trials=6) if form is None else dict(n_problems=3, n_spins=70,
                                                                   n_trials=6)
    port, ref = _lowerings(form, (16, 16), jm, **shape)
    ref_args = jax.tree.leaves(ref.args_info)
    specs = ref.compile().input_shardings[0]
    assert len(port.args_info) == len(ref_args) == len(specs)
    for arg, ra, sh in zip(port.args_info, ref_args, specs):
        rdt = np.dtype(ra.dtype)
        want_dt = {np.dtype(np.uint32): torch.int32}.get(rdt, getattr(torch, rdt.name))
        assert (arg.shape, arg.dtype) == (tuple(ra.shape), want_dt), arg.name
        spec = tuple(sh.spec) + (None,) * (len(arg.shape) - len(sh.spec))
        assert arg.spec == spec, (arg.name, arg.spec, spec)
        want_local = tuple(-(-n // (16 if a else 1)) for n, a in zip(arg.shape, spec))
        assert arg.local_shape == want_local, arg.name
    assert port.argument_bytes == sum(a.local_bytes for a in port.args_info)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (16, 16), (2, 16, 16), (3, 7)],
                         ids=lambda s: "x".join(map(str, s)))
def test_single_lowering_flops_closed_form(mesh_shape):
    """The dense single step's FLOPs: contractions · 2 · (T/d) · (N/p) · N,
    the blocks ceil'd, at the JAX package's default shapes (N = 2000, T =
    4096) and a short schedule; the collectives: one gather of the block's
    spins a contraction (int8: 2000/16 = 125 is not whole words) and one
    energy all-reduce a fold."""
    hp = SSAHyperParams(**dict(SMALL_HP, n_trials=4096))
    mesh = sharding.abstract_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):])
    low = distributed.anneal_step_lowering(mesh, hp=hp)
    plateaus = engine.schedule_plateaus(hp.schedule("hassa"), "i0max")
    contractions = sum(p.length + p.eligible for p in plateaus)
    folds = sum(p.length for p in plateaus if p.eligible)  # cycles 1.., and the epilogue
    d, p = mesh.shape["data"], mesh.shape["model"]
    T_loc, N_loc = -(-4096 // d), -(-2000 // p)
    assert low.flops == contractions * 2 * T_loc * N_loc * 2000
    assert low.flops_by_dtype == {torch.float32: low.flops}
    gathers = [c for c in low.collectives if c.kind == "all-gather"]
    reduces = [c for c in low.collectives if c.kind == "all-reduce"]
    assert len(gathers) == contractions and len(reduces) == folds
    assert all(c.axis == "model" and c.ranks == p for c in low.collectives)
    assert gathers[0].bytes == T_loc * N_loc * p  # int8 spins: no block is whole words
    rep = hlo_analysis.roofline(low)
    assert rep.n_chips == math.prod(mesh_shape)
    assert rep.t_compute == pytest.approx(low.flops / hlo_analysis.HW().peak_flops_f32)


def test_production_single_step_is_collective_bound():
    """At 16 × 16, Table II's schedule: ~7.7e10 FLOPs a device an iteration
    against a 16-rank gather every cycle over InfiniBand."""
    low = distributed.anneal_step_lowering(sharding.abstract_mesh((16, 16), AXES),
                                           hp=SSAHyperParams(n_trials=4096, tau=8))
    rep = hlo_analysis.roofline(low)
    assert rep.link == "infiniband" and rep.dominant == "collective"


def test_popcount_lowering_holds_no_dense_j():
    """Under popcount no (B, N, N) float32 tensor appears in the trace (in
    the arguments or any op's output), and int32 words do — at 1 × 1 and
    16 × 16 (the counterpart of the JAX package's popcount lowering test)."""
    B, N = 2, 64
    for mesh_shape in ((1, 1), (16, 16)):
        low, _ = _lowerings(dict(field_mode="popcount"), mesh_shape, n_problems=B, n_spins=N,
                            n_trials=2)
        shapes = [(s, dt) for op in low.ops for s, dt in zip(op.shapes, op.dtypes)]
        shapes += [(a.local_shape, a.dtype) for a in low.args_info]
        assert not any(dt == torch.float32 and s[-2:] == (N, N) for s, dt in shapes)
        assert any(dt == torch.int32 and s[-1] == N // 32 for s, dt in shapes)
        assert f"{B}x{N}x{N}xf32" not in low.as_text()
    dense, _ = _lowerings({}, (1, 1), n_problems=B, n_spins=N, n_trials=2)
    assert f"{B}x{N}x{N}xf32" in dense.as_text()


@pytest.mark.parametrize("form", [dict(j_mode="tiled"), dict(field_mode="popcount")],
                         ids=_form_id)
def test_replicated_forms_have_no_collective_in_the_loop(form):
    """The tiled and popcount forms gather the model-sharded leaves once on
    entry: their collectives do not grow with the cycles, and none sits
    between the first and the last field contraction; the dense form's grow
    one a cycle."""
    counts = {}
    for tau in (2, 5):
        hp = SSAHyperParams(**dict(SMALL_HP, tau=tau))
        mesh = sharding.abstract_mesh((2, 2), AXES)
        low = distributed.batched_anneal_step_lowering(mesh, n_problems=2, n_spins=64,
                                                       n_trials=4, hp=hp, tile_n=16, **form)
        dense = distributed.batched_anneal_step_lowering(mesh, n_problems=2, n_spins=64,
                                                         n_trials=4, hp=hp)
        counts[tau] = (len(low.collectives), len(dense.collectives))
        field = [i for i, op in enumerate(low.ops)
                 if op.flops or "bitwise_xor" in op.op or "bitwise_not" in op.op]
        assert not [c for c in low.collectives if field[0] < c.index <= field[-1]]
    assert counts[2][0] == counts[5][0] == 4  # rng, m, itanh, best_m on entry
    assert counts[5][1] > counts[2][1]


# ---------------------------------------------------------------------------
# hlo_analysis
# ---------------------------------------------------------------------------
def test_roofline_terms_and_dominance_on_the_h100():
    hw = hlo_analysis.HW()
    assert (hw.peak_flops, hw.peak_flops_f32, hw.hbm_bw, hw.link_bw, hw.ib_bw) == (
        989.4e12, 66.9e12, 3.35e12, 450e9, 50e9)
    r = hlo_analysis.RooflineReport(
        flops=989.4e12,          # exactly 1 s of bfloat16 compute
        hbm_bytes=3.35e12 * 2,   # 2 s of memory
        coll_bytes=450e9 * 0.5,  # 0.5 s of NVLink collective
        coll_breakdown={}, n_chips=256, peak_memory_per_device=1e9, coll_ranks=8)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 2.0) < 1e-9
    assert abs(r.t_collective - 0.5) < 1e-9 and r.link == "nvlink"
    assert r.dominant == "memory" and r.bound_time == 2.0
    over = hlo_analysis.RooflineReport(flops=66.9e12, hbm_bytes=0, coll_bytes=50e9 * 3,
                                       coll_breakdown={}, n_chips=256,
                                       peak_memory_per_device=None, flops_f32=66.9e12,
                                       coll_ranks=16)
    assert over.link == "infiniband" and abs(over.t_collective - 3.0) < 1e-9
    assert abs(over.t_compute - 1.0) < 1e-9 and over.dominant == "collective"
    assert set(over.asdict()) >= set(jhlo.RooflineReport(1, 1, 1, {}, 1, None).asdict())


def test_model_flops_and_shape_bytes_match_reference():
    for args in ((1e9, 1e6, "train"), (1e9, 128, "decode"), (3.5e8, 7, "prefill")):
        assert hlo_analysis.model_flops(*args) == jhlo.model_flops(*args)
    for name in jhlo._DTYPE_BYTES:
        for dims in ("", "7", "128,256", "2,3,5"):
            assert hlo_analysis.shape_bytes(name, dims) == jhlo.shape_bytes(name, dims)
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"), (torch.int8, "s8"),
                     (torch.uint8, "u8"), (torch.int64, "s64"), (torch.float16, "f16")):
        assert hlo_analysis.shape_bytes(dt, "4,8") == jhlo.shape_bytes(name, "4,8")


@pytest.mark.parametrize("track_energy", [False, True])
def test_plateau_cycle_has_one_contraction(track_energy):
    """One plateau of C cycles traced on the dense backend holds C + 1
    matrix products (one a cycle, one epilogue) and no gather; on the
    sparse backend C + 1 gathers and no product (the counterpart of the
    JAX package's HLO count)."""
    model = gset.toroidal_grid(64, seed=17).to_ising()
    C = 16
    for kind in ("dense", "sparse"):
        bk = engine.make_backend(kind, model, n_trials=4, noise="xorshift", device="cpu")
        st = bk.init_state(0)
        args = [ArgInfo(f"s{k}", tuple(t.shape), t.dtype, (None,) * t.dim(), tuple(t.shape))
                for k, t in enumerate(st)]
        low = lower(lambda mesh, bk=bk: lambda *leaves: bk.run_plateau(
            engine.EngineState(*leaves), 8, length=C, eligible=True,
            track_energy=track_energy)[0], args, sharding.abstract_mesh((1,), ("model",)))
        mm = hlo_analysis.count_ops(low, "mm")
        gathers = hlo_analysis.count_ops(low, "gather") + hlo_analysis.count_ops(low, "index")
        assert (mm, gathers) == ((C + 1, 0) if kind == "dense" else (0, C + 1)), kind
    assert hlo_analysis.count_ops(low, "aten.mm.default") == hlo_analysis.count_ops(low, "mm")
    assert hlo_analysis.count_ops(low, "bmm") == 0


def test_collective_bytes_by_kind():
    low = distributed.anneal_step_lowering(sharding.abstract_mesh((2, 2), AXES), n_spins=64,
                                           n_trials=4, hp=SSAHyperParams(**SMALL_HP))
    out = hlo_analysis.collective_bytes(low)
    assert out["all-gather"] == sum(c.bytes for c in low.collectives if c.kind == "all-gather")
    assert out["all-reduce"] == sum(c.bytes for c in low.collectives if c.kind == "all-reduce")
    assert out["total"] == out["all-gather"] + out["all-reduce"] > 0
    assert out["reduce-scatter"] == out["all-to-all"] == out["collective-permute"] == 0
    assert set(out) == set(jhlo.collective_bytes(""))
