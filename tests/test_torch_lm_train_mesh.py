"""The LM trained on a ``data`` × ``model`` (and ``pod`` × ``data`` ×
``model``) mesh of gloo ranks against the JAX package's ``mesh=None``
training step and the port's own, on the CPU.

Each rank (a subprocess, joined through a ``file://`` rendezvous) builds
``launch.mesh.make_mesh``'s grid, cuts its blocks of a whole train state
and batch (``convert.train_state_block``, ``lm_batch_block``) and runs
``make_grad_fn`` (the gradients a step hands to AdamW) and one
``make_train_step``; then the whole ``mesh=None`` step on the whole
parameters and batch.  The reduced configs of the five attention + MLP
architectures run, with test_torch_lm_mesh.py's two GQA shapes (one KV
head; 6 q heads over 3 KV heads), B = 4, S = 8 (two loss chunks of 4),
on meshes 1 × 2, 2 × 1, 2 × 2 and 2 × 1 × 2 (``pod`` × ``data`` ×
``model``), each once plainly and once with 2 microbatches and bfloat16
``param_compute_dtype``.

Against the JAX package (``make_loss_fn`` + ``jax.grad`` and
``adamw_update``, ``strict_jit``), test_torch_train.py's tolerances:

* ``ce_loss`` within 1 bfloat16 step of its size, ``tokens`` equal;
* each joined gradient leaf within ``GRAD_STEPS`` (8) bfloat16 steps of
  its largest magnitude;
* after one step the joined moments within the gradients' tolerance
  (``mu`` = 0.1·g: 8 steps of its largest magnitude; ``nu`` = 0.05·g²: 16)
  and the parameters within 2·lr of the reference's (Adam's first step
  moves each weight by lr·sign(g) + lr·wd·p, so a gradient near 0 whose
  sign differs moves it 2·lr apart).

Against the port's own ``mesh=None`` run, each rank running it on the
whole parameters and batch: ``tokens``, ``lr`` and ``step`` are equal bit
for bit on every mesh.  A second ``make_train_step`` on the mesh with the
clip off gives, on every rank, mesh=None's ``adamw_update`` of the mesh's
own gradients (gathered whole, then cut as the rank holds the state) bit
for bit: the update is elementwise, and ZeRO-1 only splits it.  Nothing
else is asserted bit for bit:

* the loss: the vocab-parallel log-sum-exp sums each rank's columns, then
  the ranks, and the data sum adds the ranks' float32 sums; and the
  forward pass's row-parallel products (float32 partials summed over
  ``model``, rounded once) land on the neighbouring bfloat16 value where
  the whole bfloat16 product rounds the other way — rarely (one element of
  phi-3-vision's hidden states, layer 1): within ``LOSS_REL`` of its size
  (measured 9.0e-6, phi-3-vision with ``model`` = 2; 0 for five of the
  seven cases on 1 × 2);
* the gradients, each leaf within ``MESH_NONE_GRAD_STEPS`` bfloat16 steps
  of its largest magnitude: where ``model`` cuts, each rank's bfloat16
  partial of the activations' gradient is summed over ``model`` in float32
  and rounded once, against one bfloat16 product over all heads (measured
  4.81, granite-3-8b on 1 × 2); where ``data`` alone cuts, the per-rank
  gradients of half the batch are summed in float32 and rounded once, and
  with bfloat16 ``param_compute_dtype`` each half is already rounded to
  bfloat16, two roundings against one (measured 1.79, qwen3-32b on 2 × 1).

ZeRO-1: ``adamw_update`` on each mesh, fed the blocks of the ``mesh=None``
gradients, equals ``mesh=None``'s parameters, ``mu`` and ``nu`` bit for
bit while the clip does not act.  When it acts the global norm sums each
leaf's blocks, then the ranks, a float32 ulp or two from ``mesh=None``'s
whole-leaf sums, and the clip scale with it: the parameters and ``mu``
within 4 float32 ulps of each leaf's largest magnitude, ``nu`` (quadratic
in the clipped gradient, the scale's difference doubled) within 8.
Measured, the worst rank's (params, mu, nu) in ulps: 0 on 2 × 1 and for
qwen3-1.7b, granite-3-8b, mistral-large-123b, phi-3-vision-4.2b and
qwen3-h6-kv3 on every mesh (the sums land on the same float32); qwen3-32b
(0.782, 1.557, 2.675) on 1 × 2 and 2 × 1 × 2, (0.782, 1.681, 2.675) on
2 × 2; qwen3-kv1 (0.705, 2.478, 3.995) on 1 × 2 and 2 × 1 × 2, (0.705,
2.478, 4.35) on 2 × 2.  Each rank's moment block has ``zero1_spec``'s
shape, half the bytes at ``data`` = 2 of every leaf with a free dim that
2 divides.

On 1 × 2, ``launch.train`` with its mesh preset replaced by the ranks'
mesh trains, resumes from its joined checkpoint, and its losses are the
``mesh=None`` launcher's within 1 bfloat16 step.  On 2 × 2:
``run_training`` (``remat="full"``: each group recomputed in
the backward pass, its collectives issued again) killed at step 3 of 5
and resumed equals the uninterrupted run bit for bit; its checkpoint holds
the joined state, which restores at ``mesh=None`` in the port and through
the JAX package's ``checkpoint.ckpt.restore``; ``remesh`` of the 2 × 2
blocks onto a 1 × 2 mesh equals the joined state cut for 1 × 2.
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
from torch_lm_common import (  # noqa: E402
    BF16_STEP,
    assert_bf16_close,
    batch_arrays,
    jx,
    np_params,
    port_cfg,
    strict_jit,
    to_np,
)

from repro import configs as JC  # noqa: E402
from repro.checkpoint import ckpt as JCK  # noqa: E402
from repro.models import model_defs as j_defs  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt as TCK  # noqa: E402
from repro_torch.models.params import tree_paths  # noqa: E402
from repro_torch.optim.adamw import zero1_spec  # noqa: E402
from repro_torch.sharding import abstract_mesh, logical_to_spec  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
GRAD_STEPS = 8
MESH_NONE_GRAD_STEPS = {"model": 6, "data": 2.5}
LOSS_REL = 2.0 ** -14
B, S = 4, 8
OPT = dict(lr_peak=1e-2, warmup_steps=2, total_steps=20)
LR1 = 5e-3  # the schedule's rate at step 1
CASES = {
    "qwen3-1.7b": ("qwen3-1.7b", {}),
    "qwen3-32b": ("qwen3-32b", {}),
    "granite-3-8b": ("granite-3-8b", {}),
    "mistral-large-123b": ("mistral-large-123b", {}),
    "phi-3-vision-4.2b": ("phi-3-vision-4.2b", {}),
    "qwen3-kv1": ("qwen3-1.7b", dict(n_kv_heads=1)),
    "qwen3-h6-kv3": ("qwen3-1.7b", dict(n_heads=6, n_kv_heads=3)),
}
VARIANTS = {"plain": {}, "micro2-bf16": dict(microbatches=2, param_compute_dtype="bfloat16")}
MESHES = [(1, 2), (2, 1), (2, 2), (2, 1, 2)]
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
RESUME_CFG = dict(remat="full")


def _cfg(case):
    arch, kw = CASES[case]
    return dataclasses.replace(JC.get_config(arch, reduced=True), **kw)


def _batch(cfg):
    """A request batch (seed 1) with the next token as label, the last
    position masked."""
    b = batch_arrays(cfg, B, S, 1)
    labels = np.full_like(b["tokens"], -1)
    labels[:, :-1] = b["tokens"][:, 1:]
    b["labels"] = labels
    return b


def _jtc(variant):
    kw = dict(VARIANTS[variant])
    if "param_compute_dtype" in kw:
        kw["param_compute_dtype"] = jnp.bfloat16
    return JS.TrainConfig(opt=JA.AdamWConfig(**OPT), loss_chunk=4, **kw)


@functools.lru_cache(maxsize=None)
def _reference(case, variant):
    """The JAX package's mesh=None step: (params, batch, grads, metrics,
    new params, new mu, new nu), numpy."""
    cfg = _cfg(case)
    arrays, batch = np_params(j_defs(cfg), 0), _batch(cfg)
    jtc = _jtc(variant)
    loss = JS.make_loss_fn(cfg, jtc)

    def step(p, b):
        pc = p if jtc.param_compute_dtype is None else jax.tree_util.tree_map(
            lambda a: a.astype(jtc.param_compute_dtype), p)
        if jtc.microbatches > 1:
            g, m = JS._microbatch_grads(loss, pc, b, jtc.microbatches, jtc.grad_accum_dtype)
        else:
            g, m = jax.grad(loss, has_aux=True)(pc, b)
        new_p, new_opt, om = JA.adamw_update(p, g, JA.adamw_init(p, jtc.opt), jtc.opt)
        return g, {**m, **om}, new_p, new_opt.mu, new_opt.nu

    out = strict_jit(step)(jx(arrays), jx(batch))
    return (arrays, batch) + tuple(jax.tree_util.tree_map(to_np, o) for o in out)


RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, in_path, out_path, ck_dir = (int(sys.argv[1]), int(sys.argv[2]),
        sys.argv[3], sys.argv[4], sys.argv[5], sys.argv[6])
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    from repro_torch import convert, sharding
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.ft import SimulatedFailure, remesh, run_training
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ModelConfig, model_defs
    from repro_torch.models.params import param_pspecs, tree_map, tree_paths
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train import (TrainConfig, TrainState, init_train_state, make_grad_fn,
                                   make_train_step, train_state_shardings)

    def same(a, b):
        a, b = dict(tree_paths(a)), dict(tree_paths(b))
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    def same_state(a, b):
        return (int(a.opt.step) == int(b.opt.step) and same(a.params, b.params)
                and same(a.opt.mu, b.opt.mu) and same(a.opt.nu, b.opt.nu))

    def grad_steps(got, want):
        # max |delta| in bfloat16 steps (2^-8) of each leaf's largest magnitude
        want = dict(tree_paths(want))
        return max(float((g.float() - want[p].float()).abs().max()) / (2.0 ** -8 * max(
            float(want[p].float().abs().max()), 1e-30)) for p, g in tree_paths(got))

    def worst_ulps(got, want):
        # max |delta| in float32 ulps of each leaf's largest magnitude
        want = dict(tree_paths(want))
        return max(float((g - want[p]).abs().max()) / (2.0 ** -23 * max(
            float(want[p].abs().max()), 1e-30)) for p, g in tree_paths(got))

    ref = np.load(in_path, allow_pickle=True)
    opt_kw = json.loads(str(ref["opt"]))
    out = {}
    for shape in json.loads(str(ref["meshes"])):
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        if np.prod(shape) != world:
            continue
        mesh = make_mesh(shape, axes, device="cpu")
        # the collectives' backward passes, on each axis of the mesh
        grads_ok = {}
        for a in axes:
            n, i = sharding.mesh_axis_size(mesh, a), sharding.axis_index(mesh, a)
            x = torch.arange(3.0, requires_grad=True)
            (sharding.copy_to(mesh, x, a) * (i + 1)).sum().backward()
            copy = torch.equal(x.grad, torch.full((3,), n * (n + 1) / 2))
            x = torch.full((3,), i + 1.0, requires_grad=True)
            y = sharding.reduce_from(mesh, x, a)
            (2 * y).sum().backward()
            reduce = torch.equal(y.detach(), torch.full((3,), n * (n + 1) / 2)) and torch.equal(
                x.grad, torch.full((3,), 2.0))
            x = torch.full((2,), float(i), requires_grad=True)
            y = sharding.gather_from(mesh, x, 0, a)
            (y * torch.arange(2.0 * n)).sum().backward()
            gather = torch.equal(y.detach(), torch.arange(n).repeat_interleave(2).float()) and (
                torch.equal(x.grad, torch.arange(2.0 * n)[2 * i: 2 * i + 2]))
            grads_ok[a] = dict(copy_to=copy, reduce_from=reduce, gather_from=gather)
        out[f"{'x'.join(map(str, shape))}/autograd"] = grads_ok
        for key, cfg_d, variant in json.loads(str(ref["runs"])):
            cfg = ModelConfig(**{k: tuple(map(tuple, v)) if k == "block" else v
                                 for k, v in cfg_d.items()})
            kw = dict(variant)
            if kw.get("param_compute_dtype"):
                kw["param_compute_dtype"] = torch.bfloat16
            tc = TrainConfig(opt=AdamWConfig(**opt_kw), loss_chunk=4, **kw)
            params = convert.lm_params_from_arrays(ref[f"{key}/params"].item(), "cpu")
            batch = {k: torch.from_numpy(v) for k, v in ref[f"{key}/batch"].item().items()}
            state = TrainState(params, adamw_init(params, tc.opt))
            sb = convert.train_state_block(state, cfg, mesh.shape, mesh.coords)
            bb = convert.lm_batch_block(batch, mesh.shape, mesh.coords)
            grads, metrics = make_grad_fn(cfg, tc, mesh)(sb.params, bb)
            sharding.reset_collective_counts()
            new, nmetrics = make_train_step(cfg, tc, mesh)(sb, bb)
            colls = dict(sharding.collective_counts)
            # with the clip off, the step's state against mesh=None's AdamW of the mesh's
            # own gradients, joined, cut as this rank holds it
            tcn = dataclasses.replace(tc, opt=dataclasses.replace(tc.opt, clip_norm=1e9))
            newc, _ = make_train_step(cfg, tcn, mesh)(sb, bb)
            pspecs = param_pspecs(model_defs(cfg), mesh)
            joined = tree_map(lambda g, s: sharding.unshard(mesh, g, s), grads, pspecs)
            pj, oj, _ = adamw_update(params, joined, adamw_init(params, tcn.opt), tcn.opt)
            own_update = same_state(newc, convert.train_state_block(TrainState(pj, oj), cfg,
                                                                   mesh.shape, mesh.coords))
            # mesh=None on the whole parameters and batch
            gn, mn = make_grad_fn(cfg, tc)(params, batch)
            newn, nmn = make_train_step(cfg, tc)(state, batch)
            gcut = convert.lm_params_block(gn, cfg, mesh.shape, mesh.coords)
            exact = dict(tokens=torch.equal(nmetrics["tokens"], nmn["tokens"]),
                         lr=torch.equal(nmetrics["lr"], nmn["lr"]))
            res = dict(grads=grads, metrics={k: v for k, v in nmetrics.items()},
                       state=new, colls=colls, exact=exact, grad_steps=grad_steps(grads, gcut),
                       loss_none=nmn["ce_loss"], own_update=own_update)
            if not variant:
                # ZeRO-1: adamw_update on the mesh of the mesh=None gradients' blocks
                z = {}
                for clip in (1e9, 1.0):
                    oc = AdamWConfig(**opt_kw, clip_norm=clip)
                    pn, on, _ = adamw_update(params, gn, adamw_init(params, oc), oc)
                    mopt = adamw_init(sb.params, oc, mesh=mesh, param_specs=pspecs)
                    pm, om, _ = adamw_update(sb.params, gcut, mopt, oc, mesh=mesh,
                                             param_specs=pspecs)
                    want = convert.train_state_block(TrainState(pn, on), cfg, mesh.shape,
                                                     mesh.coords)
                    got = TrainState(pm, om)
                    z[clip] = dict(exact=same_state(got, want), ulps=dict(
                        params=worst_ulps(pm, want.params), mu=worst_ulps(om.mu, want.opt.mu),
                        nu=worst_ulps(om.nu, want.opt.nu)))
                z["mu_shapes"] = {"/".join(p): tuple(t.shape) for p, t in tree_paths(mopt.mu)}
                res["zero1"] = z
            out[f"{'x'.join(map(str, shape))}/{key}/{variant and 'v' or 'plain'}"] = res
        if tuple(shape) == (1, 2):
            # the launcher's mesh path, its production preset replaced by this mesh
            from repro_torch.launch import train as launch_train
            launch_train.build_mesh = lambda kind, device=None: make_mesh(shape, axes,
                                                                          device=device)
            argv = ["--arch", "qwen3-1.7b", "--batch", "4", "--seq", "8", "--device", "cpu",
                    "--mesh", "single", "--ckpt-every", "2", "--ckpt-dir", f"{ck_dir}/launcher"]
            first = launch_train.train(argv + ["--steps", "3"], log_every=0)
            more = launch_train.train(argv + ["--steps", "4"], log_every=0)
            out["launcher"] = dict(losses=first.losses, resumed=more.losses,
                                   step=int(more.state.opt.step))
        if tuple(shape) == (2, 2):
            # run_training killed and resumed, its checkpoint, remesh onto 1 x 2
            cfg_d = json.loads(str(ref["resume_cfg"]))
            cfg = ModelConfig(**{k: tuple(map(tuple, v)) if k == "block" else v
                                 for k, v in cfg_d.items()})
            tc = TrainConfig(opt=AdamWConfig(**opt_kw), loss_chunk=4)
            dc = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=4, seed=0)
            shardings = train_state_shardings(cfg, tc, mesh)

            def kw(name, every):
                return dict(
                    init_state_fn=lambda: init_train_state(cfg, tc, 0, mesh=mesh),
                    train_step=make_train_step(cfg, tc, mesh),
                    batch_fn=lambda s: convert.lm_batch_block(
                        synthetic_batch(dc, s, device="cpu"), mesh.shape, mesh.coords),
                    ckpt=CheckpointManager(f"{ck_dir}/{name}", save_interval=every, keep=2,
                                           async_save=False, shardings=shardings))

            s1, l1 = run_training(n_steps=5, **kw("ref", 1))
            try:
                run_training(n_steps=5, fail_at_step=3, **kw("killed", 2))
                killed = False
            except SimulatedFailure:
                killed = True
            s2, l2 = run_training(n_steps=5, **kw("killed", 2))
            new_mesh = dataclasses.replace(sharding.abstract_mesh((1, 2), ("data", "model")),
                                           rank=rank % 2)
            moved = remesh(s1, lambda t: train_state_shardings(cfg, tc, new_mesh),
                           src=shardings)
            out["resume"] = dict(state=s1, losses=l1, resumed=l2, killed=killed,
                                 same=same_state(s1, s2), moved=moved)
    torch.save(out, out_path.format(rank=rank))
    dist.destroy_process_group()
""")


def _run_dict(cfg):
    return {k: v for k, v in dataclasses.asdict(port_cfg(cfg)).items()}


@functools.lru_cache(maxsize=None)
def _mesh_results(world):
    """Every case and variant on the gloo ranks of each mesh of ``world``
    ranks (and, at 4, the resume run): rank → {key: outputs}, and the
    checkpoint directory."""
    ref, runs = {}, []
    for case in CASES:
        for variant in VARIANTS:
            arrays, batch, *_ = _reference(case, variant)
            ref[f"{case}/params"] = np.array(arrays, dtype=object)
            ref[f"{case}/batch"] = np.array(batch, dtype=object)
            runs.append((case, _run_dict(_cfg(case)), VARIANTS[variant]))
    ref["runs"] = json.dumps(runs)
    ref["meshes"] = json.dumps([m for m in MESHES if math.prod(m) == world])
    ref["opt"] = json.dumps(OPT)
    ref["resume_cfg"] = json.dumps(_run_dict(dataclasses.replace(_cfg("qwen3-1.7b"),
                                                                 **RESUME_CFG)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    tmp = tempfile.mkdtemp(prefix="lm_train_mesh_")
    in_path = os.path.join(tmp, "in.npz")
    np.savez(in_path, **ref)
    out_path = os.path.join(tmp, "rank{rank}.pt")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
                               os.path.join(tmp, "store"), in_path, out_path,
                               os.path.join(tmp, "ckpt")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{world} ranks, rank {r}:\n{err[-3000:]}"
    return [torch.load(out_path.format(rank=r), weights_only=False) for r in range(world)], tmp


MESH_PARAM = pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))


def _blocks(shape, case, variant):
    world = math.prod(shape)
    ranks, _ = _mesh_results(world)
    key = f"{'x'.join(map(str, shape))}/{case}/{'v' if VARIANTS[variant] else 'plain'}"
    return [r[key] for r in ranks]


def _mesh_shape(shape):
    return dict(zip(AXES[len(shape)], shape))


def _jpaths(tree) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _steps(got, want) -> float:
    """max |Δ| over the leaves in bf16 steps of each leaf's largest magnitude."""
    want = dict(tree_paths(want))
    return max(float((g.float() - want[p].float()).abs().max())
               / (BF16_STEP * max(float(want[p].float().abs().max()), 1e-30))
               for p, g in tree_paths(got))


@MESH_PARAM
def test_collectives_pass_gradients(shape):
    """copy_to's backward sums the cotangents over the axis, reduce_from's
    is the identity, gather_from's takes this rank's slice: on every axis
    of every mesh, every rank."""
    ranks, _ = _mesh_results(math.prod(shape))
    for r in ranks:
        for axis, ok in r[f"{'x'.join(map(str, shape))}/autograd"].items():
            assert all(ok.values()), (shape, axis, ok)


CASE_PARAM = pytest.mark.parametrize("case,variant", [(c, v) for c in CASES for v in VARIANTS],
                                     ids=[f"{c}-{v}" for c in CASES for v in VARIANTS])


@CASE_PARAM
@MESH_PARAM
def test_train_step_on_a_mesh_matches_jax(shape, case, variant):
    """Every rank's loss and tokens, the joined gradients and the joined
    state after one step against the reference's mesh=None step."""
    _, _, jg, jm, jp, jmu, jnu = _reference(case, variant)
    blocks = _blocks(shape, case, variant)
    cfg, ms = port_cfg(_cfg(case)), _mesh_shape(shape)
    for rank, out in enumerate(blocks):
        m = out["metrics"]
        assert abs(float(m["ce_loss"]) - float(jm["ce_loss"])) <= BF16_STEP * abs(
            float(jm["ce_loss"])), (rank, float(m["ce_loss"]), float(jm["ce_loss"]))
        assert float(m["tokens"]) == float(jm["tokens"])
        assert int(m["step"]) == 1 and float(m["lr"]) == float(jm["lr"]) == float(np.float32(LR1))
    grads = convert.lm_params_join([o["grads"] for o in blocks], cfg, ms)
    want = _jpaths(jg)
    for path, g in tree_paths(grads):
        assert_bf16_close(g, want[path], GRAD_STEPS, f"{shape} {case} {variant} grad {path}")
    state = convert.train_state_join([o["state"] for o in blocks], cfg, ms)
    assert int(state.opt.step) == 1
    for got, ref, steps in ((state.opt.mu, jmu, GRAD_STEPS), (state.opt.nu, jnu, 2 * GRAD_STEPS)):
        want = _jpaths(ref)
        for path, t in tree_paths(got):
            assert_bf16_close(t, want[path], steps, f"{shape} {case} moment {path}")
    want = _jpaths(jp)
    for path, t in tree_paths(state.params):
        err = float(np.abs(t.numpy() - want[path]).max())
        assert err <= 2 * LR1 * (1 + 1e-3), (shape, case, path, err)


@CASE_PARAM
@MESH_PARAM
def test_train_step_on_a_mesh_against_mesh_none(shape, case, variant):
    """The port's mesh=None step on the whole parameters and batch: tokens,
    lr and step equal; the loss and the gradients within the distances
    the module's docstring gives; with the clip off, the step's new state
    equals mesh=None's adamw_update of the mesh's own joined gradients bit
    for bit; no all-to-all."""
    blocks = _blocks(shape, case, variant)
    cut = "model" if shape[-1] > 1 else "data"
    for out in blocks:
        assert out["exact"]["tokens"] and out["exact"]["lr"], out["exact"]
        assert out["own_update"], (shape, case, variant)
        assert int(out["metrics"]["step"]) == 1
        loss, want = float(out["metrics"]["ce_loss"]), float(out["loss_none"])
        assert abs(loss - want) <= LOSS_REL * abs(want), (loss, want)
        assert out["grad_steps"] <= MESH_NONE_GRAD_STEPS[cut], out["grad_steps"]
    colls = blocks[0]["colls"]
    assert colls.get("all_reduce", 0) > 0 and "all_to_all" not in colls, colls
    # one ZeRO-1 gather a leaf: each has a free dim that data divides
    assert colls.get("all_gather", 0) == len(list(tree_paths(blocks[0]["grads"]))), colls


@MESH_PARAM
@pytest.mark.parametrize("case", list(CASES))
def test_zero1_adamw_on_a_mesh_equals_mesh_none(shape, case):
    """adamw_update on the mesh of the mesh=None gradients: bit for bit
    while the clip does not act; when it acts the parameters and mu within
    4 float32 ulps, nu within 8 (the readings are in the module's
    docstring); each rank's moment blocks have zero1_spec's shape."""
    blocks = _blocks(shape, case, "plain")
    cfg = port_cfg(_cfg(case))
    m = abstract_mesh(shape, AXES[len(shape)])
    from repro_torch.models import model_defs

    defs = dict(tree_paths(model_defs(cfg)))
    for out in blocks:
        z = out["zero1"]
        assert z[1e9]["exact"], (shape, case, z[1e9])
        u = z[1.0]["ulps"]
        assert u["params"] <= 4 and u["mu"] <= 4 and u["nu"] <= 8, (shape, case, u)
        for path, got in z["mu_shapes"].items():
            d = defs[tuple(path.split("/"))]
            spec = zero1_spec(logical_to_spec(m, d.shape, d.axes), d.shape, m)
            spec = tuple(spec) + (None,) * (len(d.shape) - len(spec))
            want = tuple(n // math.prod(m.shape[a] for a in ((e,) if isinstance(e, str) else
                                                             e or ()))
                         for n, e in zip(d.shape, spec))
            assert got == want, (path, got, want)
            if m.shape.get("data") == 2 and any(e is None and n % 2 == 0 for n, e in zip(
                    d.shape, tuple(logical_to_spec(m, d.shape, d.axes))
                    + (None,) * len(d.shape))):
                assert math.prod(got) * 2 * math.prod(
                    m.shape[e] for e in logical_to_spec(m, d.shape, d.axes) if e) == math.prod(
                    d.shape), (path, got)


def test_launcher_trains_on_a_mesh(tmp_path):
    """launch.train's mesh path on 1 × 2 (its preset replaced by the ranks'
    mesh): every rank's losses equal and within 1 bfloat16 step of the
    mesh=None launcher's; a run to step 4 resumes from its step-2
    checkpoint (the joined state)."""
    from repro_torch.launch import train as launch_train

    ranks, _ = _mesh_results(2)
    runs = [r["launcher"] for r in ranks]
    assert runs[0]["losses"] == runs[1]["losses"] and len(runs[0]["losses"]) == 3
    assert runs[0]["step"] == 4 and len(runs[0]["resumed"]) == 2
    want = launch_train.train(["--arch", "qwen3-1.7b", "--batch", "4", "--seq", "8",
                               "--device", "cpu", "--steps", "3", "--ckpt-dir",
                               str(tmp_path)], log_every=0).losses
    for got, w in zip(runs[0]["losses"], want):
        assert abs(got - w) <= BF16_STEP * abs(w), (runs[0]["losses"], want)


def test_resume_checkpoint_and_remesh_on_2x2():
    ranks, tmp = _mesh_results(4)
    cfg = port_cfg(dataclasses.replace(_cfg("qwen3-1.7b"), **RESUME_CFG))
    ms = _mesh_shape((2, 2))
    res = [r["resume"] for r in ranks]
    for r in res:
        assert r["killed"] and r["same"], (r["killed"], r["same"])
        assert r["resumed"] == r["losses"][2:] and len(r["losses"]) == 5
    joined = convert.train_state_join([r["state"] for r in res], cfg, ms)
    assert int(joined.opt.step) == 5
    tc = TS.TrainConfig(loss_chunk=4)
    # the checkpoint of step 5 restores at mesh=None in the port ...
    got, meta = TCK.restore(os.path.join(tmp, "ckpt", "ref"),
                            TS.init_train_state(cfg, tc, 0, device="cpu"))
    assert meta["step"] == 5

    def same(a, b):
        a, b = dict(tree_paths(a)), dict(tree_paths(b))
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    assert int(got.opt.step) == 5 and same(got.params, joined.params)
    assert same(got.opt.mu, joined.opt.mu) and same(got.opt.nu, joined.opt.nu)
    # ... and in the JAX package
    jcfg = dataclasses.replace(_cfg("qwen3-1.7b"), **RESUME_CFG)
    jtemplate = JS.TrainState(
        params=jax.tree_util.tree_map(np.zeros_like, np_params(j_defs(jcfg), 0)),
        opt=JA.OptState(step=np.int32(0),
                        mu=jax.tree_util.tree_map(np.zeros_like, np_params(j_defs(jcfg), 0)),
                        nu=jax.tree_util.tree_map(np.zeros_like, np_params(j_defs(jcfg), 0))))
    jgot, jmeta = JCK.restore(os.path.join(tmp, "ckpt", "ref"), jtemplate)
    assert jmeta["step"] == 5 and int(jgot.opt.step) == 5
    for field, want in (("params", joined.params), ("mu", joined.opt.mu), ("nu", joined.opt.nu)):
        tree = jgot.params if field == "params" else getattr(jgot.opt, field)
        wp = dict(tree_paths(want))
        for path, a in _jpaths(tree).items():
            np.testing.assert_array_equal(a, wp[path].numpy())
    # remesh of the 2 x 2 blocks onto 1 x 2 equals the joined state cut for 1 x 2
    for rank, r in enumerate(res):
        want = convert.train_state_block(joined, cfg, {"data": 1, "model": 2}, (0, rank % 2))
        assert int(r["moved"].opt.step) == 5
        assert same(r["moved"].params, want.params)
        assert same(r["moved"].opt.mu, want.opt.mu) and same(r["moved"].opt.nu, want.opt.nu)
