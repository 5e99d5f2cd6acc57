"""The LM's logical-axis specs in the port (``repro_torch.sharding``,
``models.params``, ``optim.adamw.zero1_spec``, ``configs.shapes``,
``launch.lowering``) against the JAX package's, on the CPU.

Every spec is compared exactly — the port's tuple against the entries of
the reference's ``PartitionSpec`` — for all ten architectures at full
width, under DEFAULT_RULES and both presets, on the production meshes
(16 × 16, 2 × 16 × 16), the shrunken 8 × 16 and the small 1 × 2, 2 × 1 and
2 × 2, each built with the reference's own ``abstract_mesh`` and the
port's of the same shape.  Then the blocks: ``convert.lm_params_block`` /
``lm_caches_block`` cut each leaf as its spec says, and the joins put them
back.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro import sharding as JS  # noqa: E402
from repro.launch import lowering as JLOW  # noqa: E402
from repro.models import cache_defs as j_cache_defs  # noqa: E402
from repro.models import model_defs as j_model_defs  # noqa: E402
from repro.models.params import ParamDef as JParamDef  # noqa: E402
from repro.models.params import param_pspecs as j_param_pspecs  # noqa: E402
from repro.optim.adamw import zero1_spec as j_zero1_spec  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert, sharding  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.core.lowering import block_shape  # noqa: E402
from repro_torch.launch import lowering as TLOW  # noqa: E402
from repro_torch.models import cache_defs, model_defs  # noqa: E402
from repro_torch.models.params import (init_params, param_pspecs, param_shardings,  # noqa: E402
                                       tree_map, tree_paths)
from repro_torch.optim.adamw import zero1_spec  # noqa: E402

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((8, 16), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 1), ("data", "model")), ((2, 2), ("data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
RULES = {"default": (sharding.DEFAULT_RULES, JS.DEFAULT_RULES),
         "serve_ws": (sharding.SERVE_WEIGHT_STATIONARY_RULES, JS.SERVE_WEIGHT_STATIONARY_RULES),
         "train_fsdp_sp": (sharding.TRAIN_FSDP_SP_RULES, JS.TRAIN_FSDP_SP_RULES)}


def _meshes(i):
    shape, axes = MESHES[i]
    return sharding.abstract_mesh(shape, axes), JS.abstract_mesh(shape, axes)


def _jpaths(tree):
    """{path: leaf} of a JAX tree of ParamDefs or specs (dict keys)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JParamDef, jax.sharding.PartitionSpec)))[0]
    return {tuple(str(k.key) for k in path): leaf for path, leaf in leaves}


def test_rule_presets_mirror_jax():
    for port, ref in RULES.values():
        assert port.rules == ref.rules


@pytest.mark.parametrize("case", [
    ((64, 4096), ("batch", "seq")),
    ((3, 4096), ("batch", "seq")),
    ((6, 16, 64), ("batch", "heads", "d_head")),
    ((32, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", "d_head")),
    ((32, 32770, 8, 128), ("batch", "kv_seq", "kv_heads", "d_head")),
    ((4, 1000, 16, 128), ("batch", "kv_seq", "kv_heads", "d_head")),
    ((151936, 2048), ("vocab", "d_model")),
    ((49155, 4096), ("vocab", "d_model")),
    ((4096, 2, 12800), ("d_model", None, "d_ff")),
    ((7,), (None,)),
    ((), ()),
])
@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_logical_to_spec_matches_jax(mesh, rules, case):
    """Divisibility-aware, each mesh axis at most once, trimmed from the
    right: the reference's spec, entry for entry."""
    tm, jm = _meshes(mesh)
    shape, axes = case
    port, ref = RULES[rules]
    got = sharding.logical_to_spec(tm, shape, axes, port)
    assert got == tuple(JS.logical_to_spec(jm, shape, axes, ref))
    assert sharding.named_sharding(tm, shape, axes, port).spec == got


def test_logical_to_spec_rejects_a_rank_mismatch():
    with pytest.raises(ValueError, match="rank"):
        sharding.logical_to_spec(sharding.abstract_mesh((2, 2), ("data", "model")), (4, 4),
                                 ("batch",))


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_param_and_zero1_specs_match_jax(arch, mesh, rules):
    """param_pspecs of every leaf, and its ZeRO-1 moments' spec, at full
    width; param_shardings carries the same specs."""
    tm, jm = _meshes(mesh)
    port, ref = RULES[rules]
    defs = model_defs(TC.get_config(arch))
    want = _jpaths(j_param_pspecs(j_model_defs(JC.get_config(arch)), jm, ref))
    got = dict(tree_paths(param_pspecs(defs, tm, port)))
    shards = dict(tree_paths(param_shardings(defs, tm, port)))
    shapes = dict(tree_paths(defs))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert spec == tuple(want[path]), path
        assert shards[path].spec == spec
        d = shapes[path]
        assert zero1_spec(spec, d.shape, tm) == tuple(j_zero1_spec(want[path], d.shape, jm)), path


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_cache_and_input_specs_match_jax(arch, mesh):
    """Each cell's caches (decode cells: ``cache_defs`` at its batch and
    length) and inputs (the three ``*_input_specs``, shapes and dtypes,
    placed by ``batch_shardings``) equal the reference's."""
    tm, jm = _meshes(mesh)
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    for name, cell in TC.SHAPES.items():
        jcell = JC.SHAPES[name]
        for fn in ("train_input_specs", "prefill_input_specs", "decode_input_specs"):
            got, want = getattr(tshapes, fn)(cfg, cell), getattr(JC.shapes, fn)(jcfg, jcell)
            assert set(got) == set(want), (fn, name)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (fn, name, k)
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype), (fn, name, k)
            if fn == "decode_input_specs":
                continue  # token and pos: decode_args places them (test_torch_lm_dryrun)
            shard = TLOW.batch_shardings(tm, got)
            for k, w in want.items():
                jspec = JS.logical_to_spec(jm, w.shape, ("batch",) + (None,) * (len(w.shape) - 1))
                assert shard[k].spec == tuple(jspec), (fn, name, k)
        if cell.kind != "decode":
            continue
        want = _jpaths(j_param_pspecs(j_cache_defs(jcfg, cell.global_batch, cell.seq_len), jm))
        got = dict(tree_paths(param_pspecs(cache_defs(cfg, cell.global_batch, cell.seq_len), tm)))
        assert {p: tuple(s) for p, s in want.items()} == got, name


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_count_params_matches_jax(arch):
    assert TLOW.count_params(TC.get_config(arch)) == JLOW.count_params(JC.get_config(arch))


def _block(shape, spec, mesh):
    return block_shape(shape, tuple(spec) + (None,) * (len(shape) - len(spec)), mesh)


def test_named_sharding_block_shape():
    mesh = sharding.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    ns = sharding.named_sharding(mesh, (64, 32768, 8, 128),
                                 ("batch", "kv_seq", "kv_heads", "d_head"))
    assert ns.spec == (("pod", "data"), "model")
    assert _block((64, 32768, 8, 128), ns.spec, mesh) == (2, 2048, 8, 128)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
BLOCK_MESHES = [((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
                ((2, 2, 2), ("pod", "data", "model"))]


@pytest.mark.parametrize("mesh_i", range(len(BLOCK_MESHES)),
                         ids=["x".join(map(str, s)) for s, _ in BLOCK_MESHES])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-3-8b", "phi-3-vision-4.2b"])
def test_blocks_cut_by_spec_and_join_back(arch, mesh_i):
    """Each rank's block of every parameter and cache leaf is the slice its
    spec gives (ranks row-major over the mesh); joining every rank's blocks
    gives the whole trees back.  Batch 4 and 10 positions: the cache is cut
    by sequence on model = 2; the batch over data (and pod)."""
    shape, axes = BLOCK_MESHES[mesh_i]
    cfg = TC.get_config(arch, reduced=True)
    mesh = sharding.abstract_mesh(shape, axes)
    params = init_params(model_defs(cfg), 0, "cpu")
    gen = torch.Generator().manual_seed(1)
    caches = tree_map(lambda d: torch.randn(d.shape, generator=gen).to(d.dtype),
                      cache_defs(cfg, 4, 10))
    ranks = [dataclasses.replace(mesh, rank=r) for r in range(mesh.size)]
    pblocks = [convert.lm_params_block(params, cfg, mesh.shape, m.coords) for m in ranks]
    cblocks = [convert.lm_caches_block(caches, cfg, mesh.shape, m.coords) for m in ranks]
    specs = dict(tree_paths(param_pspecs(model_defs(cfg), mesh)))
    for path, whole in tree_paths(params):
        blk = dict(tree_paths(pblocks[-1]))[path]
        want = _block(whole.shape, specs[path], mesh)
        assert tuple(blk.shape) == want, path
    k = caches["decoder"]["l0"]["mixer"]["k"]
    last = ranks[-1].coords
    n_b = 4 // sharding.mesh_axis_size(mesh, ("pod", "data"))
    n_s = 10 // mesh.shape["model"]
    b0 = sharding.axis_index(ranks[-1], ("pod", "data")) * n_b
    assert torch.equal(cblocks[-1]["decoder"]["l0"]["mixer"]["k"],
                       k[:, b0: b0 + n_b, last[-1] * n_s: (last[-1] + 1) * n_s])
    for path, t in tree_paths(convert.lm_params_join(pblocks, cfg, mesh.shape)):
        assert torch.equal(t, dict(tree_paths(params))[path]), path
    joined = convert.lm_caches_join(cblocks, cfg, 4, 10, mesh.shape)
    for path, t in tree_paths(joined):
        assert torch.equal(t, dict(tree_paths(caches))[path]), path
    batch = {"tokens": torch.arange(4 * 3).reshape(4, 3)}
    rows = convert.lm_batch_block(batch, mesh.shape, last)["tokens"]
    assert torch.equal(rows, batch["tokens"][b0: b0 + n_b])


def test_join_rejects_differing_replicas():
    cfg = TC.get_config("qwen3-1.7b", reduced=True)
    mesh = sharding.abstract_mesh((1, 2), ("data", "model"))
    params = init_params(model_defs(cfg), 0, "cpu")
    blocks = [convert.lm_params_block(params, cfg, mesh.shape, (0, r)) for r in range(2)]
    blocks[1]["final_norm"]["scale"] = blocks[1]["final_norm"]["scale"] + 1
    with pytest.raises(ValueError, match="final_norm/scale: rank 1's replica"):
        convert.lm_params_join(blocks, cfg, mesh.shape)
