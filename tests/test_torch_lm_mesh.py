"""The LM served on a ``data`` × ``model`` mesh of gloo ranks against the
JAX package's ``mesh=None`` run, on the CPU.

Each rank (a subprocess, joined through a ``file://`` rendezvous) builds
``launch.mesh.make_mesh``'s grid, cuts its blocks of the parameters and
the prompt batch (``convert.lm_params_block``, ``lm_batch_block``) and
runs ``prefill``, one ``decode_step`` and greedy ``generate`` (which takes
the whole batch) on them.  The reduced configs of the five attention + MLP
architectures run, with two more qwen3 shapes for the GQA maps: one KV
head (so ``model`` = 2 leaves the KV heads whole while it splits the q
heads) and 6 q heads over 3 KV heads (a rank's q heads read KV heads 0,
0, 1 and 1, 2, 2).  Meshes 1 × 2, 2 × 1 and 2 × 2; a prompt of 7 tokens
(``model`` does not divide it) and two runs: an odd batch of 3 with 4 new
tokens (``max_seq`` 11: the caches cut by KV heads, the batch whole on
``data``) and a batch of 4 with 5 (``max_seq`` 12: the caches cut by
sequence, flash-decode, the batch cut over ``data``).

Tolerances, each in bfloat16 steps of the output's scale
(``assert_bf16_close``): 4 for the logits and the caches, the model tests'
(test_torch_lm_models.py), the port's mesh=None program's distance from
the reference (the mesh's row-parallel products are the float32 products
of the bfloat16 operands summed over ``model`` and rounded once, as one
bfloat16 product is).  Greedy tokens agree with the reference's up to a
row's first difference, which may fall only where the top-2 margin is
within the logits' tolerance (test_torch_lm_serve.py's rule).

Against the port's own ``mesh=None`` run (each rank runs it on the whole
parameters and its batch rows) the mesh is exact: the logits, the caches
(cut as the rank's are) and the greedy tokens equal it bit for bit.
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
    StrictJax,
    assert_bf16_close,
    batch_arrays,
    jx,
    np_params,
    strict_jit,
    to_np,
    top2_margin,
)

import repro.serve.lm as jlm  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import model_defs as j_defs  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch import convert, sharding  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.models import ModelConfig, forward  # noqa: E402
from repro_torch.models.params import tree_paths  # noqa: E402
from repro_torch.models.transformer import lm_head_logits  # noqa: E402
from repro_torch.serve import lm  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
STEPS = 4
S = 7
RUNS = {"odd-batch": (3, 4), "seq-cut": (4, 5)}  # name: (B, new tokens)
CASES = {
    "qwen3-1.7b": ("qwen3-1.7b", {}),
    "qwen3-32b": ("qwen3-32b", {}),
    "granite-3-8b": ("granite-3-8b", {}),
    "mistral-large-123b": ("mistral-large-123b", {}),
    "phi-3-vision-4.2b": ("phi-3-vision-4.2b", {}),
    "qwen3-kv1": ("qwen3-1.7b", dict(n_kv_heads=1)),
    "qwen3-h6-kv3": ("qwen3-1.7b", dict(n_heads=6, n_kv_heads=3)),
}
MESHES = [(1, 2), (2, 1), (2, 2)]


def _cfg(case):
    arch, kw = CASES[case]
    return dataclasses.replace(JC.get_config(arch, reduced=True), **kw)


@functools.lru_cache(maxsize=None)
def _reference(case, run):
    """The JAX package's mesh=None run: (params, batch, prefill logits and
    caches, decode logits and caches, greedy tokens), numpy."""
    cfg = _cfg(case)
    B, n_new = RUNS[run]
    arrays = np_params(j_defs(cfg), 0)
    batch = batch_arrays(cfg, B, S, 1)
    p = jx(arrays)
    logits, caches = strict_jit(lambda p, b: j_prefill(p, b, cfg, max_seq=S + n_new))(
        p, jx(batch))
    dlogits, dcaches = strict_jit(lambda p, c, t: j_decode(p, c, t, jnp.int32(S), cfg))(
        p, caches, jnp.asarray(batch["tokens"][:, 0]))
    real = jlm.jax
    jlm.jax = StrictJax()
    try:
        tokens = jlm.generate(p, jx(batch), cfg, jlm.ServeConfig(max_seq=S + n_new), n_new)
    finally:
        jlm.jax = real
    npt = lambda tree: jax.tree_util.tree_map(to_np, tree)  # noqa: E731
    return (arrays, batch, to_np(logits), npt(caches), to_np(dlogits), npt(dcaches),
            np.asarray(tokens))


RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, shape, in_path, out_path = (int(sys.argv[1]), int(sys.argv[2]),
        sys.argv[3], json.loads(sys.argv[4]), sys.argv[5], sys.argv[6])
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    from repro_torch import convert, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ModelConfig, decode_step, prefill
    from repro_torch.models.params import tree_paths
    from repro_torch.serve.lm import ServeConfig, generate

    def same(a, b):
        a, b = dict(tree_paths(a)), dict(tree_paths(b))
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    ref = np.load(in_path, allow_pickle=True)
    out = {}
    for key, cfg_d, n_new in json.loads(str(ref["runs"])):
        cfg = ModelConfig(**{k: tuple(map(tuple, v)) if k == "block" else v
                             for k, v in cfg_d.items()})
        params = convert.lm_params_from_arrays(ref[f"{key}/params"].item(), "cpu")
        batch = {k: torch.from_numpy(v) for k, v in ref[f"{key}/batch"].item().items()}
        max_seq = batch["tokens"].shape[1] + n_new
        pb = convert.lm_params_block(params, cfg, mesh.shape, mesh.coords)
        bb = convert.lm_batch_block(batch, mesh.shape, mesh.coords)
        sharding.reset_collective_counts()
        logits, caches = prefill(pb, bb, cfg, mesh=mesh, max_seq=max_seq)
        dlogits, dcaches = decode_step(pb, caches, bb["tokens"][:, 0],
                                       batch["tokens"].shape[1], cfg, mesh=mesh,
                                       max_seq=max_seq)
        colls = dict(sharding.collective_counts)
        tokens = generate(pb, batch, cfg, ServeConfig(max_seq=max_seq), n_new, mesh=mesh)
        # mesh=None on the whole parameters and this rank's rows; its caches
        # cut over model as this rank's are (the rows are already this rank's)
        nlogits, ncaches = prefill(params, bb, cfg, max_seq=max_seq)
        ndlogits, ndcaches = decode_step(params, ncaches, bb["tokens"][:, 0],
                                         batch["tokens"].shape[1], cfg)
        rows_whole = {"data": 1, "model": mesh.shape["model"]}
        cut = lambda c: convert.lm_caches_block(c, cfg, rows_whole, (0, mesh.coords[1]))
        exact = dict(logits=torch.equal(logits, nlogits), dlogits=torch.equal(dlogits, ndlogits),
                     caches=same(caches, cut(ncaches)), dcaches=same(dcaches, cut(ndcaches)),
                     tokens=np.array_equal(tokens, generate(params, batch, cfg, ServeConfig(
                         max_seq=max_seq), n_new, device="cpu")))
        out[key] = dict(logits=logits, caches=caches, dlogits=dlogits, dcaches=dcaches,
                        tokens=torch.from_numpy(tokens), colls=colls, exact=exact)
    torch.save(out, out_path.format(rank=rank))
    dist.destroy_process_group()
""")


@functools.lru_cache(maxsize=None)
def _mesh_results(shape):
    """Every case and run on the gloo ranks of a ``shape`` mesh: each
    rank's outputs, key → dict."""
    world = math.prod(shape)
    ref, runs = {}, []
    for case in CASES:
        for run, (B, n_new) in RUNS.items():
            arrays, batch, *_ = _reference(case, run)
            key = f"{case}/{run}"
            ref[f"{key}/params"] = np.array(arrays, dtype=object)
            ref[f"{key}/batch"] = np.array(batch, dtype=object)
            runs.append((key, dataclasses.asdict(_cfg(case)), n_new))
    ref["runs"] = json.dumps(runs)
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
            outs = [p.communicate(timeout=240) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"mesh {shape} rank {r}:\n{err[-3000:]}"
        return [torch.load(out_path.format(rank=r)) for r in range(world)]


def _rows(shape, rank, B):
    """The batch rows rank ``rank`` of a ``shape`` mesh holds."""
    mesh = dataclasses.replace(sharding.abstract_mesh(shape, ("data", "model")), rank=rank)
    spec = sharding.logical_to_spec(mesh, (B,), ("batch",))
    n = B // sharding.mesh_axis_size(mesh, spec[0] if spec else None)
    lo = sharding.axis_index(mesh, spec[0] if spec else None) * n
    return slice(lo, lo + n)


CASE_PARAM = pytest.mark.parametrize("case,run", [(c, r) for c in CASES for r in RUNS],
                                     ids=[f"{c}-{r}" for c in CASES for r in RUNS])
MESH_PARAM = pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))


@CASE_PARAM
@MESH_PARAM
def test_prefill_on_a_mesh_matches_jax(shape, case, run):
    """Every rank's logits (its batch rows, the whole vocabulary) and the
    joined caches (in decode's placement) against the reference's."""
    B, n_new = RUNS[run]
    _, _, logits, caches, *_ = _reference(case, run)
    blocks = [r[f"{case}/{run}"] for r in _mesh_results(shape)]
    for rank, out in enumerate(blocks):
        assert_bf16_close(out["logits"], logits[_rows(shape, rank, B)], STEPS,
                          f"{case} {run} {shape} rank {rank} prefill logits")
        assert out["exact"]["logits"] and out["exact"]["caches"], (rank, out["exact"])
    cfg = _cfg(case)
    joined = convert.lm_caches_join([o["caches"] for o in blocks], cfg, B, S + n_new,
                                    dict(zip(("data", "model"), shape)))
    want = dict(tree_paths(caches))
    for path, c in tree_paths(joined):
        assert_bf16_close(c, want[path], STEPS, f"{case} {run} {shape} cache {'/'.join(path)}")


@CASE_PARAM
@MESH_PARAM
def test_decode_on_a_mesh_matches_jax(shape, case, run):
    """One decode step at position 7 from the mesh's own prefill caches:
    every rank's logits and the joined caches against the reference's
    step from its caches; the ranks issue the collectives of the
    placement (no all-to-all where the caches are cut by KV heads)."""
    B, n_new = RUNS[run]
    _, _, _, _, dlogits, dcaches, _ = _reference(case, run)
    blocks = [r[f"{case}/{run}"] for r in _mesh_results(shape)]
    for rank, out in enumerate(blocks):
        assert_bf16_close(out["dlogits"], dlogits[_rows(shape, rank, B)], STEPS,
                          f"{case} {run} {shape} rank {rank} decode logits")
        assert out["exact"]["dlogits"] and out["exact"]["dcaches"], (rank, out["exact"])
    joined = convert.lm_caches_join([o["dcaches"] for o in blocks], _cfg(case), B, S + n_new,
                                    dict(zip(("data", "model"), shape)))
    want = dict(tree_paths(dcaches))
    for path, c in tree_paths(joined):
        assert_bf16_close(c, want[path], STEPS, f"{case} {run} {shape} decoded {'/'.join(path)}")
    colls = blocks[0]["colls"]
    if shape[1] == 1:
        assert colls == {}, colls  # nothing is cut over a one-rank model axis
    else:
        assert colls.get("all_reduce", 0) > 0
        seq_cut = (S + n_new) % shape[1] == 0
        kv_cut = _cfg(case).n_kv_heads % shape[1] == 0
        assert ("all_to_all" in colls) == (seq_cut and kv_cut), colls


@CASE_PARAM
@MESH_PARAM
def test_greedy_generate_on_a_mesh_matches_jax(shape, case, run):
    """Every rank returns the whole batch's tokens, the same on each, equal
    to the reference's up to a near tie."""
    _, _, logits, *_, tokens = _reference(case, run)
    blocks = [r[f"{case}/{run}"] for r in _mesh_results(shape)]
    got = blocks[0]["tokens"].numpy()
    assert got.shape == tokens.shape and got.dtype == np.int32
    for out in blocks[1:]:
        np.testing.assert_array_equal(out["tokens"].numpy(), got)
    assert all(out["exact"]["tokens"] for out in blocks)  # the port's mesh=None tokens
    # equal up to a row's first difference, which needs a near tie there in
    # the teacher-forced logits over prompt + the mesh's tokens
    arrays, batch, *_ = _reference(case, run)
    tcfg = ModelConfig(**dataclasses.asdict(_cfg(case)))
    tp = convert.lm_params_from_arrays(arrays, "cpu")
    toks = np.concatenate([batch["tokens"], got], axis=1)
    h, _ = forward(tp, {**{k: torch.from_numpy(v) for k, v in batch.items()},
                        "tokens": torch.from_numpy(toks)}, tcfg)
    tf = lm_head_logits(tp, h, tcfg).numpy()[:, S - 1: S - 1 + got.shape[1]]
    tol = STEPS * BF16_STEP * float(np.abs(tf).max())
    margins = top2_margin(tf)
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != tokens[b])[0]
        if diff.size:
            assert margins[b, diff[0]] <= tol, (case, run, shape, b, got[b], tokens[b])


def test_gumbel_rows_on_a_mesh():
    """A rank's rows of the temperature sampler draw the rows of the whole
    batch's gumbel noise: the same tokens as the whole batch's draw."""
    logits = torch.from_numpy(
        (np.random.default_rng(3).standard_normal((6, 500)) * 2).astype(np.float32))
    key = rng.split(rng.PRNGKey(11))[1]
    whole = lm._sample(logits, key, 0.8)
    for lo, n in ((0, 3), (3, 3), (2, 1)):
        part = lm._sample(logits[lo: lo + n], key, 0.8, rows=(lo, 6))
        assert torch.equal(part, whole[lo: lo + n])


def test_unported_mesh_paths_raise():
    """Rules other than DEFAULT_RULES, the MoE, Mamba, RWKV and encoder
    families (their serving and train cells too) on a mesh raise citing
    step 10; decode on a mesh needs max_seq; a mesh must be a
    sharding.Mesh or AbstractMesh."""
    from repro_torch import configs as TC
    from repro_torch.configs import SHAPES
    from repro_torch.launch import lowering as LOW
    from repro_torch.models import decode_step, model_defs, prefill
    from repro_torch.models.params import init_params

    mesh = sharding.abstract_mesh((1, 2), ("data", "model"))
    cfg = TC.get_config("qwen3-1.7b", reduced=True)
    params = init_params(model_defs(cfg), 0, "cpu")
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32)}
    for rules in (sharding.SERVE_WEIGHT_STATIONARY_RULES, sharding.TRAIN_FSDP_SP_RULES):
        with pytest.raises(NotImplementedError, match="step 10"):
            prefill(params, batch, cfg, mesh=mesh, rules=rules)
        with pytest.raises(NotImplementedError, match="step 10"):
            lm.generate(params, batch, cfg, lm.ServeConfig(max_seq=8), 2, mesh=mesh, rules=rules)
    for arch in ("olmoe-1b-7b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "rwkv6-3b",
                 "whisper-tiny"):
        acfg = TC.get_config(arch, reduced=True)
        with pytest.raises(NotImplementedError, match="step 10"):
            decode_step({}, {}, torch.zeros(2, dtype=torch.int32), 0, acfg, mesh=mesh,
                        max_seq=8)
        with pytest.raises(NotImplementedError, match="step 10"):
            LOW.decode_lowering(TC.get_config(arch), SHAPES["decode_32k"], mesh)
    for arch in ("olmoe-1b-7b", "rwkv6-3b", "whisper-tiny"):
        with pytest.raises(NotImplementedError, match="step 10"):
            LOW.cell_lowering(TC.get_config(arch), SHAPES["train_4k"], mesh)
    with pytest.raises(ValueError, match="max_seq"):
        decode_step(params, {}, torch.zeros(2, dtype=torch.int32), 0, cfg, mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        prefill(params, batch, cfg, mesh=object())
    with pytest.raises(ValueError, match="rank's block"):
        prefill(params, batch, cfg, mesh=mesh)  # whole parameters, not a block


def test_one_rank_mesh_equals_mesh_none():
    """make_mesh((1, 1)) in this process (a one-rank gloo group): generate
    on it gives the port's mesh=None tokens, and nothing is cut."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    arrays, batch, *_ = _reference("qwen3-1.7b", "odd-batch")
    tcfg = ModelConfig(**dataclasses.asdict(_cfg("qwen3-1.7b")))
    params = convert.lm_params_from_arrays(arrays, "cpu")
    started = not dist.is_initialized()
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        sc = lm.ServeConfig(max_seq=S + 4)
        sharding.reset_collective_counts()
        got = lm.generate(params, batch, tcfg, sc, 4, mesh=mesh)
        assert dict(sharding.collective_counts) == {}
        np.testing.assert_array_equal(got, lm.generate(params, batch, tcfg, sc, 4, device="cpu"))
        with pytest.raises(ValueError, match="differs from the mesh"):
            lm.generate(params, batch, tcfg, sc, 4, mesh=mesh, device="meta")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def test_serve_lm_example_on_two_gloo_ranks():
    """examples/serve_lm.py under torchrun on a 1 × 2 mesh of CPU ranks:
    rank 0's tokens equal the unsharded generate()."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "repro_torch.examples.serve_lm",
                          "--arch", "qwen3-1.7b", "--mesh", "1x2", "--device", "cpu",
                          "--prompt-len", "6", "--new-tokens", "4"], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "on a 1x2 gloo mesh" in out.stdout
    assert "tokens == the unsharded generate(): True" in out.stdout
    assert out.stdout.count("request ") == 4
