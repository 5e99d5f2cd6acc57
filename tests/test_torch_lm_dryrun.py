"""The LM's serving dry-run in the port (``repro_torch.launch.lowering``,
``launch.dryrun``) against the JAX package's, on the CPU; the train cells
are tests/test_torch_lm_train_dryrun.py's, with this file's reference
script.

The placements: every argument of the port's prefill and decode
lowerings has the global shape, dtype and placement of the reference's
compiled input (``compiled.input_shardings``) for the same cell.  The
reference runs in a subprocess with 8 forced CPU devices, on meshes it
builds with ``axis_types=(AxisType.Auto,) * k``: the installed jax's
``jax.make_mesh`` gives Explicit axes, on which the reference's
``constrain`` fails (the cause of ``tests/test_dryrun_integration.py``'s
two known failures), and nothing in the JAX package changes for this.

Then the port's own numbers: the depth extrapolation equals a trace of
the whole depth; the decode lowering at the production 16 × 16 issues the
collectives its placement needs; ``run_cell`` writes the reference's
record keys for qwen3-1.7b at prefill_32k and decode_32k on both meshes
and skips granite-3-8b's long_500k with the reference's reason.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.launch import lowering as JLOW  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.configs.shapes import ShapeCell  # noqa: E402
from repro_torch.core.lowering import lower  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import lowering as LOW  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ARCHS = ["qwen3-1.7b", "qwen3-32b", "granite-3-8b", "mistral-large-123b", "phi-3-vision-4.2b"]
PLACEMENT_MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
                    ((2, 2, 2), ("pod", "data", "model"))]
CELLS = [(a, s, i) for a in ARCHS for s in ("prefill_32k", "decode_32k")
         for i in range(len(PLACEMENT_MESHES))]

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    import jax
    from jax.sharding import AxisType
    from repro.configs import SHAPES, get_config
    from repro.launch import lowering as L

    out = {}
    for arch, shape_name, mesh_shape, axes in json.loads(sys.argv[1]):
        mesh = jax.make_mesh(tuple(mesh_shape), tuple(axes),
                             axis_types=(AxisType.Auto,) * len(axes))
        lowered = L.cell_lowering(get_config(arch), SHAPES[shape_name], mesh)
        shards = jax.tree_util.tree_leaves(lowered.compile().input_shardings[0])
        leaves = jax.tree_util.tree_flatten_with_path(lowered.args_info[0])[0]
        assert len(leaves) == len(shards)
        names = {"train": [None, "batch"], "prefill": ["params", "batch"],
                 "decode": ["params", "caches", "token", "pos"]}[SHAPES[shape_name].kind]
        key = lambda k: str(getattr(k, "key", getattr(k, "name", None)))
        out["|".join([arch, shape_name, "x".join(map(str, mesh_shape))])] = [
            ["/".join([n for n in [names[path[0].idx]] if n] + [key(k) for k in path[1:]]),
             list(info.shape), str(info.dtype),
             [list(e) if isinstance(e, tuple) else e for e in sh.spec]]
            for (path, info), sh in zip(leaves, shards)]
    print(json.dumps(out))
""")


def reference_placements(cells):
    """The reference's compiled input placements of ``cells`` ((arch, shape
    name, index into PLACEMENT_MESHES)), from one subprocess."""
    cells = [(a, s, *PLACEMENT_MESHES[i]) for a, s, i in cells]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(cells)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


@functools.lru_cache(maxsize=None)
def _reference_placements():
    return reference_placements(CELLS)


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def check_placements(arch, shape_name, mesh_i, want):
    """Global shape, dtype and placement of every argument of the port's
    lowering, by name, against the reference's (``want``); each rank's
    block is the shard shape of its placement."""
    mesh_shape, axes = PLACEMENT_MESHES[mesh_i]
    mesh = sharding.abstract_mesh(mesh_shape, axes)
    cell = TC.SHAPES[shape_name]
    fn = {"train": LOW.train_args, "prefill": LOW.prefill_args,
          "decode": LOW.decode_args}[cell.kind]
    got = {a.name: a for a in fn(TC.get_config(arch), cell, mesh)}
    assert set(got) == {w[0] for w in want}
    for name, shape, dtype, spec in want:
        a = got[name]
        assert a.shape == tuple(shape), name
        assert str(a.dtype).split(".")[-1] == dtype, name
        spec = _spec(spec) + (None,) * (len(shape) - len(spec))
        assert a.spec == spec, (name, a.spec, spec)
        assert a.local_shape == tuple(d // sharding.mesh_axis_size(mesh, e)
                                      for d, e in zip(shape, spec)), name


def cell_key(arch, shape_name, mesh_i):
    return "|".join([arch, shape_name, "x".join(map(str, PLACEMENT_MESHES[mesh_i][0]))])


@pytest.mark.parametrize("arch,shape_name,mesh_i", CELLS,
                         ids=[f"{a}-{s}-{'x'.join(map(str, PLACEMENT_MESHES[i][0]))}"
                              for a, s, i in CELLS])
def test_lowered_args_match_reference_placements(arch, shape_name, mesh_i):
    check_placements(arch, shape_name, mesh_i,
                     _reference_placements()[cell_key(arch, shape_name, mesh_i)])


def test_production_placements_of_qwen3():
    """At model = 16 qwen3-1.7b's 16 q heads are cut and its 8 KV heads
    whole; the decode caches are cut by sequence (32768 / 16), the batch
    over data; the vocabulary (151,936) over model; at model = 2 the KV
    heads are cut too."""
    cfg = TC.get_config("qwen3-1.7b")
    mesh = sharding.abstract_mesh((16, 16), ("data", "model"))
    args = {a.name: a for a in LOW.decode_args(cfg, TC.SHAPES["decode_32k"], mesh)}
    assert args["params/decoder/l0/mixer/wq"].spec == (None, None, "model", None)
    assert args["params/decoder/l0/mixer/wk"].spec == (None,) * 4
    assert args["params/embed/tok"].spec == ("model", None)
    assert args["caches/decoder/l0/mixer/k"].spec == (None, "data", "model", None, None)
    assert args["caches/decoder/l0/mixer/k"].local_shape == (28, 8, 2048, 8, 128)
    small = {a.name: a for a in LOW.decode_args(cfg, TC.SHAPES["decode_32k"],
                                                 sharding.abstract_mesh((1, 2),
                                                                        ("data", "model")))}
    assert small["params/decoder/l0/mixer/wk"].spec == (None, None, "model", None)


def test_analysis_config_matches_jax():
    for arch in ARCHS:
        for shape_name in ("prefill_32k", "decode_32k"):
            for g in (1, 2):
                got = LOW.analysis_config(TC.get_config(arch), TC.SHAPES[shape_name], g)
                want = JLOW.analysis_config(JC.get_config(arch), JC.SHAPES[shape_name], g)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_depth_extrapolation_equals_the_whole_trace(kind):
    """The lowering at 5 groups, extrapolated from traces at 2 and 3, has
    the FLOPs, bytes, peak, ops and collectives of a trace of all 5; its
    arguments are the lowering's own *_args."""
    cfg = dataclasses.replace(TC.get_config("qwen3-1.7b", reduced=True), n_layers=5)
    cell = ShapeCell("cell", 48, 4, kind)
    mesh = sharding.abstract_mesh((2, 2), ("data", "model"))
    low = LOW.cell_lowering(cfg, cell, mesh)
    fn = LOW.prefill_args if kind == "prefill" else LOW.decode_args
    args = fn(cfg, cell, mesh)
    assert low.args_info == args
    assert low.argument_bytes == sum(a.local_bytes for a in args)

    def build(m):
        def run(*blocks):
            tree = LOW._trees(args, blocks)
            if kind == "prefill":
                return T.prefill(tree["params"], tree["batch"], cfg, mesh=m, max_seq=48)
            return T.decode_step(tree["params"], tree["caches"], tree["token"], 0, cfg,
                                 mesh=m, max_seq=48)
        return run

    whole = lower(build, args, mesh)
    assert (low.flops, low.bytes_accessed, low.peak_bytes, low.n_ops) == (
        whole.flops, whole.bytes_accessed, whole.peak_bytes, len(whole.ops))
    assert low.flops_by_dtype == whole.flops_by_dtype
    assert sorted((c.kind, c.shape) for c in low.collectives) == sorted(
        (c.kind, c.shape) for c in whole.collectives)
    assert H.roofline(low).asdict() == H.roofline(whole).asdict()


def test_production_decode_collectives():
    """qwen3-1.7b at decode_32k on 16 × 16, rank 0: per layer the q heads
    gathered, flash-decode's max, sum and values all-reduced, wo and the
    MLP's down projection all-reduced; then the embedding all-reduced and
    the logits gathered; all over the 16 model ranks (InfiniBand)."""
    cfg = TC.get_config("qwen3-1.7b")
    low = LOW.decode_lowering(cfg, TC.SHAPES["decode_32k"],
                              sharding.abstract_mesh((16, 16), ("data", "model")))
    kinds = [c.kind for c in low.collectives]
    assert kinds.count("all-gather") == 28 + 1 and kinds.count("all-reduce") == 28 * 5 + 1
    assert all(c.axis == "model" and c.ranks == 16 for c in low.collectives)
    rep = H.roofline(low)
    assert rep.link == "infiniband" and rep.n_chips == 256
    # the logits: 8 rows of the whole vocabulary, float32, gathered once
    assert [c.shape for c in low.collectives if c.kind == "all-gather"].count(
        (8, 1, 151936)) == 1


@functools.lru_cache(maxsize=None)
def _records():
    return {(s, m): dryrun.run_cell("qwen3-1.7b", s, m, verbose=False, analysis=(m == "single"))
            for s in ("prefill_32k", "decode_32k") for m in ("single", "pod")}


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("mesh_kind", ["single", "pod"])
def test_run_cell_records(shape_name, mesh_kind):
    rec = _records()[shape_name, mesh_kind]
    assert rec["status"] == "ok" and rec["kind"] == shape_name.split("_")[0]
    assert rec["n_chips"] == (256 if mesh_kind == "single" else 512)
    for key in ("t_lower_s", "t_compile_s", "peak_bytes_per_device", "fits_hbm_80g",
                "raw_hlo_flops_per_device", "raw_hlo_coll_bytes_per_device", "params_total",
                "params_active", "n_tokens", "model_flops"):
        assert key in rec, key
    assert "fits_hbm_16g" not in rec and rec["t_compile_s"] is None
    assert rec["params_total"] == rec["params_active"] == 2_031_739_904
    assert rec["fits_hbm_80g"] and 0 < rec["argument_bytes_per_device"] < rec[
        "peak_bytes_per_device"]
    if mesh_kind == "single":
        for key in ("flops_per_device", "hbm_bytes_per_device", "coll_bytes_per_device",
                    "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                    "useful_flops_ratio", "t_analysis_s"):
            assert key in rec, key
        assert rec["coll_link"] == "infiniband"
    json.dumps(rec)


def test_long_500k_is_skipped_with_the_reference_reason():
    rec = dryrun.run_cell("granite-3-8b", "long_500k", "single", verbose=False)
    ok, reason = JC.applicable(JC.get_config("granite-3-8b"), JC.SHAPES["long_500k"])
    assert not ok
    assert rec == {"arch": "granite-3-8b", "shape": "long_500k", "mesh": "single",
                   "rules": "baseline", "kind": "decode", "status": "skipped", "reason": reason}


def test_dryrun_main_writes_a_record_per_cell(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--mesh", "both",
                     "--out", str(tmp_path), "--quiet"])
    assert done.value.code == 0
    for m in ("single", "pod"):
        rec = json.loads((tmp_path / f"qwen3-1.7b__decode_32k__{m}.json").read_text())
        assert rec["status"] == "ok" and rec["mesh"] == m
    assert "2 cells, 0 failures" in capsys.readouterr().out
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "olmoe-1b-7b", "--shape", "decode_32k", "--out", str(tmp_path),
                     "--quiet"])
    assert done.value.code == 1
    rec = json.loads((tmp_path / "olmoe-1b-7b__decode_32k__single.json").read_text())
    assert rec["status"] == "error" and "step 10" in rec["error"]
