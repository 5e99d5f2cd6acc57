"""The LM port's fault tolerance and launchers (``repro_torch.ft.resilience``,
``launch.train``, ``examples.train_lm``) on the CPU, against the JAX
package where the two compute the same thing.

* ``run_training``: a run killed after step 13 and resumed from its step-10
  checkpoint gives the uninterrupted run's losses and final state bit for
  bit (the reference's own test, in the port); the port's loss trajectory
  against the JAX package's from the same parameters: step 1 within 1
  bfloat16 step of its size, steps 2–20 within 10% (measured ≤ 6.2%: at
  step 1 Adam moves every weight by about ±lr, so a gradient near 0 whose
  sign differs between the packages moves that weight by 2·lr, and the
  runs drift apart from there);
* ``StragglerMonitor``: the reference's cases, each against the JAX
  monitor on the same records;
* ``remesh``: a state moved to a device, values equal; onto a mesh's
  NamedShardings it needs the blocks' own placement (the re-sharding
  itself runs on gloo ranks in tests/test_torch_lm_train_mesh.py);
* the launcher: ``--mesh none`` trains, the production meshes started as
  one process raise naming the ranks they need, ``--placement ssa``
  anneals the JAX launcher's placement.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch_lm_common import BF16_STEP, jx, np_params, strict_jit  # noqa: E402

from repro.data import pipeline as JD  # noqa: E402
from repro.ft import resilience as JR  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import model_defs as j_defs  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.ft import SimulatedFailure, StragglerMonitor, remesh, run_training  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models.params import tree_paths  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import (  # noqa: E402
    TrainConfig,
    TrainState,
    init_train_state,
    make_train_step,
)

CFG = dict(name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16, d_ff=64,
           vocab=53, remat="none")
OPT = dict(lr_peak=1e-2, warmup_steps=2, total_steps=40)
DC = dict(vocab=53, seq_len=16, global_batch=4, seed=0)
TRAJ_TOL = 0.10


def _setup(directory, save_interval=5, async_save=False):
    cfg = ModelConfig(**CFG)
    tc = TrainConfig(opt=AdamWConfig(**OPT), loss_chunk=8)
    ckpt = CheckpointManager(str(directory), save_interval=save_interval, keep=2,
                             async_save=async_save)
    return dict(init_state_fn=lambda: init_train_state(cfg, tc, 0, device="cpu"),
                train_step=make_train_step(cfg, tc),
                batch_fn=lambda s: synthetic_batch(DataConfig(**DC), s, device="cpu"),
                ckpt=ckpt)


def _same_state(a: TrainState, b: TrainState) -> bool:
    return (int(a.opt.step) == int(b.opt.step)
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_paths(a.params),
                                                                tree_paths(b.params)))
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_paths(a.opt.nu),
                                                                tree_paths(b.opt.nu))))


@pytest.mark.parametrize("async_save", [False, True])
def test_restart_resumes_bit_exact(tmp_path, async_save):
    """Kill training after step 13 (its step-10 checkpoint written);
    resuming replays steps 10–20 as the uninterrupted run had them."""
    ref_state, ref = run_training(n_steps=20, **_setup(tmp_path / "ref", async_save=async_save))
    kw = _setup(tmp_path / "ckpt", async_save=async_save)
    with pytest.raises(SimulatedFailure):
        run_training(n_steps=20, fail_at_step=13, **kw)
    kw["ckpt"].wait()
    assert latest_step(str(tmp_path / "ckpt")) == 10
    state, resumed = run_training(n_steps=20, **kw)
    assert resumed == ref[10:20]
    assert _same_state(state, ref_state)
    # and a second uninterrupted run gives the same bits
    _, again = run_training(n_steps=20, **_setup(tmp_path / "again", async_save=async_save))
    assert again == ref


def test_run_training_history_and_checkpoint_snapshot(tmp_path):
    """``history`` gets one record a step; a checkpoint is the state as it
    was at its step, whatever the run does to its tensors afterwards."""
    kw = _setup(tmp_path / "ck", save_interval=2)
    history = []
    state, losses = run_training(n_steps=4, history=history, **kw)
    assert [h["step"] for h in history] == [1, 2, 3, 4]
    assert [h["ce_loss"] for h in history] == losses
    assert all(h["wall_s"] >= h["issue_s"] >= 0 and h["lr"] >= 0 for h in history)
    template = _setup(tmp_path / "unused")["init_state_fn"]()
    saved, meta = kw["ckpt"].restore_latest(template)
    assert meta["step"] == 4 and meta["data_step"] == 4
    assert _same_state(saved, state)
    for _, t in tree_paths(state.params):
        t.add_(1.0)  # a later in-place write by the caller
    again, _ = kw["ckpt"].restore_latest(template)
    assert _same_state(again, saved)


def test_loss_trajectory_tracks_jax(tmp_path):
    """20 steps of tests/test_ft.py's run in both packages from the same
    parameters and batches."""
    jcfg = JModelConfig(**CFG)
    arrays = np_params(j_defs(jcfg), 0)
    jtc = JS.TrainConfig(opt=JA.AdamWConfig(**OPT), loss_chunk=8)
    jstate = JS.TrainState(jx(arrays), JA.adamw_init(jx(arrays), jtc.opt))
    jstep = strict_jit(JS.make_train_step(jcfg, jtc))
    zeros = jax.tree_util.tree_map(np.zeros_like, arrays)
    kw = _setup(tmp_path / "ck", save_interval=100)
    kw["init_state_fn"] = lambda: convert.train_state_from_arrays(arrays, 0, zeros, zeros)
    _, losses = run_training(n_steps=20, **kw)
    want = []
    for s in range(20):
        jstate, m = jstep(jstate, JD.synthetic_batch(JD.DataConfig(**DC), s))
        want.append(float(m["ce_loss"]))
    assert abs(losses[0] - want[0]) <= BF16_STEP * want[0]
    rel = np.abs(np.array(losses) - np.array(want)) / np.array(want)
    assert rel.max() <= TRAJ_TOL, rel
    assert losses[-1] < losses[0] and want[-1] < want[0]


STRAGGLER_CASES = {
    # (n_hosts, monitor kwargs, records as (host, time) lists, flagged)
    "slow-host": (8, dict(threshold=1.5, warmup_steps=3),
                  [(h, 1.0 if h != 5 else 3.0) for _ in range(10) for h in range(8)], [5]),
    "uniform": (4, {}, [(h, 1.0 + 0.01 * h) for _ in range(10) for h in range(4)], []),
    "single-host": (1, dict(threshold=1.5, warmup_steps=3),
                    [(0, t) for t in (0.1, 5.0, 0.1, 40.0, 0.1)], []),
    "warmup-boundary-before": (3, dict(threshold=1.5, warmup_steps=3),
                               [(h, 1.0) for _ in range(3) for h in (0, 1)]
                               + [(2, 50.0)] * 2, []),
    "warmup-boundary-after": (3, dict(threshold=1.5, warmup_steps=3),
                              [(h, 1.0) for _ in range(3) for h in (0, 1)]
                              + [(2, 50.0)] * 3, [2]),
    "no-ready-hosts": (4, dict(warmup_steps=5), [(h, 1.0) for h in range(4)], []),
}


@pytest.mark.parametrize("case", sorted(STRAGGLER_CASES))
def test_straggler_monitor_matches_jax(case):
    n, kw, records, flagged = STRAGGLER_CASES[case]
    mon, jmon = StragglerMonitor(n_hosts=n, **kw), JR.StragglerMonitor(n_hosts=n, **kw)
    for host, t in records:
        mon.record(host, t)
        jmon.record(host, t)
    assert mon.stragglers() == jmon.stragglers() == flagged
    np.testing.assert_array_equal(mon._ema, jmon._ema)


def test_remesh_to_a_device():
    state = init_train_state(ModelConfig(**CFG), TrainConfig(), 0, device="cpu")
    moved = remesh(state, lambda tree: jax.tree_util.tree_map(
        lambda _: torch.device("cpu"), tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert isinstance(moved, TrainState)
    assert _same_state(moved, state)
    # a leaf already on its device is the same tensor
    assert moved.params["embed"]["tok"] is state.params["embed"]["tok"]
    by_name = remesh(state.params, lambda tree: jax.tree_util.tree_map(lambda _: "cpu", tree))
    assert all(t.device.type == "cpu" for _, t in tree_paths(by_name))
    with pytest.raises(TypeError, match="neither a device nor a NamedSharding"):
        remesh(state.params, lambda tree: jax.tree_util.tree_map(lambda _: object(), tree))
    from repro_torch.sharding import NamedSharding, abstract_mesh

    onto = NamedSharding(abstract_mesh((1, 2), ("data", "model")), ())
    with pytest.raises(ValueError, match="needs src"):
        remesh(state.params, lambda tree: jax.tree_util.tree_map(lambda _: onto, tree))


# ---------------------------------------------------------------------------
# launch/train.py and examples/train_lm.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", ["single", "pod", "shrunken"])
def test_launcher_meshes_raise(mesh, tmp_path):
    """The production meshes need 256, 512 and 128 ranks (torchrun): one
    process raises, naming both counts."""
    need = {"single": 256, "pod": 512, "shrunken": 128}[mesh]
    with pytest.raises(ValueError, match=f"needs {need} ranks but only 1 exist"):
        launch_train.train(["--mesh", mesh, "--device", "cpu", "--steps", "1",
                            "--ckpt-dir", str(tmp_path)])


def test_launcher_trains_on_one_device(tmp_path, capsys):
    argv = ["--arch", "granite-3-8b", "--steps", "6", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    run = launch_train.main(argv)
    assert len(run.losses) == 6 and int(run.state.opt.step) == 6
    assert [h["step"] for h in run.history] == list(range(1, 7))
    assert run.init_s > 0 and run.stragglers == []
    assert "done: loss" in capsys.readouterr().out
    assert latest_step(str(tmp_path)) == 6
    # a second run finds the last checkpoint and has nothing left to do
    again = launch_train.train(argv)
    assert again.losses == [] and again.init_s > 0 and int(again.state.opt.step) == 6
    # and one with more steps resumes from it, the data replayed from step 6
    more = launch_train.train(argv[:2] + ["--steps", "8"] + argv[4:])
    assert len(more.losses) == 2 and int(more.state.opt.step) == 8


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-1.7b"])
def test_launcher_placement_matches_jax(arch, capsys):
    """--placement ssa anneals the expert placement with the port's
    core/placement.py: the JAX launcher's assignment and lines; an arch
    without experts is skipped."""
    from repro.configs import get_config as j_get_config
    from repro.launch.train import maybe_ssa_placement as j_placement
    from repro_torch.configs import get_config

    got = launch_train.maybe_ssa_placement(get_config(arch, reduced=True), device="cpu")
    ours = capsys.readouterr().out
    want = j_placement(j_get_config(arch, reduced=True))
    theirs = capsys.readouterr().out
    assert ours == theirs
    if want is None:
        assert got is None and "has no experts" in ours
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_example_train_lm_runs_and_resumes(tmp_path, capsys):
    from repro_torch.examples import train_lm

    argv = ["--steps", "20", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    losses = train_lm.main(argv)
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert "trained qwen3-1.7b (reduced) for 20 steps" in capsys.readouterr().out
    assert latest_step(str(tmp_path)) == 20
    assert train_lm.main(argv) == []  # resumed at step 20: nothing to run
