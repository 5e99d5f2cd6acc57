"""The LM's train dry-run in the port (``launch.lowering.train_lowering``,
``launch.dryrun.run_cell`` of a train cell) against the JAX package's, on
the CPU (the serving cells are tests/test_torch_lm_dryrun.py's, whose
reference script this file runs for the train cells).

The placements: every argument of the port's train lowering — the
parameters, ``opt/step``, the ZeRO-1 moments and the batch — has the
global shape, dtype and placement of the reference's compiled input
(``compiled.input_shardings`` of its ``train_lowering``, on Auto-axis
meshes in a subprocess) for the five attention + MLP archs at train_4k on
the three placement meshes.

Then the port's own numbers: the depth extrapolation of a train step
(forward, backward, the gradient sums and the ZeRO-1 update; on a 4 × 2
mesh, whose ``data`` divides neither traced depth) equals a trace of the
whole depth, and ``run_cell("qwen3-1.7b", "train_4k", ...)`` writes the
reference's record keys on both meshes, the single pod's with the checks
of the reference's own failing
``tests/test_dryrun_integration.py::test_train_cell_single_pod_with_analysis``.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_dryrun import (  # noqa: E402
    ARCHS,
    PLACEMENT_MESHES,
    cell_key,
    check_placements,
    reference_placements,
)

from repro_torch import configs as TC  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.configs.shapes import ShapeCell  # noqa: E402
from repro_torch.core.lowering import lower  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import lowering as LOW  # noqa: E402

CELLS = [(a, "train_4k", i) for a in ARCHS for i in range(len(PLACEMENT_MESHES))]


@functools.lru_cache(maxsize=None)
def _reference_placements():
    return reference_placements(CELLS)


@pytest.mark.parametrize("arch,shape_name,mesh_i", CELLS,
                         ids=[f"{a}-{'x'.join(map(str, PLACEMENT_MESHES[i][0]))}"
                              for a, _, i in CELLS])
def test_train_args_match_reference_placements(arch, shape_name, mesh_i):
    check_placements(arch, shape_name, mesh_i,
                     _reference_placements()[cell_key(arch, shape_name, mesh_i)])


def test_train_depth_extrapolation_equals_the_whole_trace():
    """A train step (remat "full": each group recomputed in the backward
    pass) at 5 groups, extrapolated from traces at 2 and 3, has the FLOPs,
    bytes, peak, ops and collectives of a trace of all 5, the gradient
    sums and ZeRO-1 gathers of the stacked leaves at their whole depth."""
    from repro_torch.models import model_defs
    from repro_torch.models.params import param_pspecs
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.step import TrainConfig, TrainState, make_train_step

    cfg = dataclasses.replace(TC.get_config("qwen3-1.7b", reduced=True), n_layers=5,
                              remat="full")
    cell = ShapeCell("cell", 16, 8, "train")
    mesh = sharding.abstract_mesh((4, 2), ("data", "model"))
    low = LOW.cell_lowering(cfg, cell, mesh)
    args = LOW.train_args(cfg, cell, mesh)
    assert low.args_info == args and low.kind == "train"

    def build(m):
        step = make_train_step(cfg, TrainConfig(), mesh=m,
                               param_specs=param_pspecs(model_defs(cfg), m))

        def run(*blocks):
            tree = LOW._trees(args, blocks)
            return step(TrainState(tree["params"], OptState(0, tree["opt"]["mu"],
                                                            tree["opt"]["nu"])), tree["batch"])
        return run

    whole = lower(build, args, mesh)
    assert (low.flops, low.bytes_accessed, low.peak_bytes, low.n_ops) == (
        whole.flops, whole.bytes_accessed, whole.peak_bytes, len(whole.ops))
    assert sorted((c.kind, c.axis, c.shape) for c in low.collectives) == sorted(
        (c.kind, c.axis, c.shape) for c in whole.collectives)
    kinds = {(c.kind, c.axis) for c in whole.collectives}
    assert kinds == {("all-reduce", "model"), ("all-reduce", "data"), ("all-gather", "data")}
    assert H.roofline(low).asdict() == H.roofline(whole).asdict()


@functools.lru_cache(maxsize=None)
def _record(mesh_kind):
    return dryrun.run_cell("qwen3-1.7b", "train_4k", mesh_kind, verbose=False,
                           analysis=(mesh_kind == "single"))


@pytest.mark.parametrize("mesh_kind", ["single", "pod"])
def test_train_cell_record(mesh_kind):
    """The reference's record keys; on the single pod the checks of its
    failing test_train_cell_single_pod_with_analysis: status "ok", 256
    chips, a positive peak, positive terms, 0.01 < useful_flops_ratio <
    100 (6·N·D over the traced FLOPs)."""
    rec = _record(mesh_kind)
    assert rec["status"] == "ok" and rec["kind"] == "train"
    assert rec["n_chips"] == (256 if mesh_kind == "single" else 512)
    assert rec["fits_hbm_80g"] and 0 < rec["argument_bytes_per_device"] < rec[
        "peak_bytes_per_device"]
    assert rec["params_total"] == rec["params_active"] == 2_031_739_904
    assert rec["model_flops"] == 6 * rec["params_active"] * 256 * 4096
    if mesh_kind == "single":
        assert rec["t_compute_s"] > 0 and rec["t_memory_s"] > 0 and rec["t_collective_s"] > 0
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert 0.01 < rec["useful_flops_ratio"] < 100
