"""The LM port's models (``repro_torch.models.transformer``, ``configs``)
against the JAX package's on the CPU: all ten architectures, reduced, through
``forward``, ``prefill`` and one ``decode_step`` on the same numpy-drawn
parameters (carried across by ``convert.lm_params_from_arrays``) and
requests; the caches' structure against ``cache_defs``; the two
cache-padding cases where the reference's shape match pads the wrong
leaves, in the port only.

Tolerance: 4 bfloat16 steps of the output's scale (2^-8 of max|ref| each,
``assert_bf16_close``).  The port rounds where the reference rounds, so a
difference is float32 summation order or a transcendental's last ulp
sending a bfloat16 rounding to its neighbour (one ulp, two steps); a
2-layer reduced model carries such a step through a few more roundings.
jamba gets 8: it has 8 layers (1 attention, 7 Mamba), and its residual
stream reaches ~10^4 (the reduced init's Mamba outputs), where one
bfloat16 ulp is 32-64, before the final norm scales it back.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_lm_common import (  # noqa: E402
    assert_bf16_close,
    batch_arrays,
    jx,
    np_params,
    strict_jit,
    to_np,
)

from repro import configs as JC  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import model_defs as j_defs  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import LM, cache_defs, decode_step, forward, model_defs, prefill  # noqa: E402
from repro_torch.models.params import param_shapes, tree_map, tree_paths  # noqa: E402
from repro_torch.models.transformer import lm_head_logits  # noqa: E402

B, MAX_SEQ = 2, 12


def _steps(arch):
    return 8 if arch.startswith("jamba") else 4


def _seq(cfg):
    # whisper's cross K/V length is n_frames = 8: a prompt of 8 hits the
    # reference's padding quirk (see test_whisper_prompt_of_n_frames_...)
    return 7 if cfg.encoder_layers else 8


@functools.lru_cache(maxsize=None)
def _case(arch):
    """(JAX cfg, port cfg, JAX params, port params, numpy batch) of a
    reduced arch, parameters from seed 0."""
    cfg = JC.get_config(arch, reduced=True)
    tcfg = TC.get_config(arch, reduced=True)
    arrays = np_params(j_defs(cfg), 0)
    return (cfg, tcfg, jx(arrays), convert.lm_params_from_arrays(arrays, "cpu"),
            batch_arrays(cfg, B, _seq(cfg), 1))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch):
    cfg, _, p, _, batch = _case(arch)
    return strict_jit(lambda p, b: j_prefill(p, b, cfg, max_seq=MAX_SEQ))(p, jx(batch))


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_config_matches_jax(arch):
    for reduced in (False, True):
        want = dataclasses.asdict(JC.get_config(arch, reduced=reduced))
        assert dataclasses.asdict(TC.get_config(arch, reduced=reduced)) == want
    assert TC.ARCH_NAMES == JC.ARCH_NAMES and TC.ANNEAL_PROBLEMS == JC.ANNEAL_PROBLEMS
    for name, cell in JC.SHAPES.items():
        assert dataclasses.asdict(TC.SHAPES[name]) == dataclasses.asdict(cell)
        full = TC.get_config(arch)
        assert TC.applicable(full, TC.SHAPES[name]) == JC.applicable(
            JC.get_config(arch), cell)


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_forward_matches_jax(arch):
    cfg, tcfg, p, tp, batch = _case(arch)
    h, aux = strict_jit(lambda p, b: j_forward(p, b, cfg))(p, jx(batch))
    th, taux = forward(tp, _tb(batch), tcfg)
    assert th.dtype == torch.bfloat16
    assert_bf16_close(th, h, _steps(arch), f"{arch} forward")
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_prefill_matches_jax(arch):
    cfg, tcfg, p, tp, batch = _case(arch)
    logits, caches = _jax_prefill(arch)
    tlogits, tcaches = prefill(tp, _tb(batch), tcfg, max_seq=MAX_SEQ)
    assert tlogits.dtype == torch.float32 and tuple(tlogits.shape) == (B, cfg.vocab)
    assert_bf16_close(tlogits, logits, _steps(arch), f"{arch} prefill logits")
    want = dict(tree_paths(jax.tree_util.tree_map(to_np, caches)))
    got = dict(tree_paths(tcaches))
    assert set(got) == set(want)
    for path, c in got.items():
        assert_bf16_close(c, want[path], _steps(arch), f"{arch} cache {'/'.join(path)}")


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_decode_step_matches_jax(arch):
    """One decode step from the JAX package's own prefill caches, carried
    across by ``convert.lm_caches_from_arrays``."""
    cfg, tcfg, p, tp, batch = _case(arch)
    _, caches = _jax_prefill(arch)
    token = batch["tokens"][:, 0]
    S = _seq(cfg)
    logits, new = strict_jit(lambda p, c, t: j_decode(p, c, t, jnp.int32(S), cfg))(
        p, caches, jnp.asarray(token))
    tcaches = convert.lm_caches_from_arrays(jax.tree_util.tree_map(np.asarray, caches))
    assert all(t.dtype == (torch.bfloat16 if c.dtype == jnp.bfloat16 else torch.float32)
               for (_, t), (_, c) in zip(tree_paths(tcaches), tree_paths(caches)))
    tlogits, tnew = decode_step(tp, tcaches, torch.from_numpy(token), S, tcfg)
    assert_bf16_close(tlogits, logits, _steps(arch), f"{arch} decode logits")
    want = dict(tree_paths(jax.tree_util.tree_map(to_np, new)))
    for path, c in tree_paths(tnew):
        assert_bf16_close(c, want[path], _steps(arch), f"{arch} decoded cache {'/'.join(path)}")
    # the caches passed in are not written
    for (_, before), (_, after) in zip(
            tree_paths(convert.lm_caches_from_arrays(jax.tree_util.tree_map(np.asarray,
                                                                            caches))),
            tree_paths(tcaches)):
        assert torch.equal(before, after)


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_cache_defs_mirror_the_prefill_caches(arch):
    """cache_defs gives the caches' tree, shapes and dtypes, as the
    reference's does for its own prefill."""
    _, tcfg, _, tp, batch = _case(arch)
    _, caches = prefill(tp, _tb(batch), tcfg, max_seq=MAX_SEQ)
    spec = param_shapes(cache_defs(tcfg, B, MAX_SEQ))
    live = {p: (tuple(t.shape), t.dtype) for p, t in tree_paths(caches)}
    assert live == {p: (tuple(t.shape), t.dtype) for p, t in tree_paths(spec)}
    jcfg = JC.get_config(arch, reduced=True)
    from repro.models import cache_defs as j_cache_defs
    from repro.models.params import param_shapes as j_param_shapes

    jspec = j_param_shapes(j_cache_defs(jcfg, B, MAX_SEQ))
    jpaths = {tuple(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(jspec)[0]}
    assert jpaths == {p: s for p, (s, _) in live.items()}


def test_lm_module_holds_the_tree_by_dotted_paths():
    _, tcfg, _, tp, batch = _case("olmoe-1b-7b")
    lm = LM(tcfg, tp)
    keys = sorted(lm.state_dict())
    assert keys == sorted("params." + ".".join(p) for p, _ in tree_paths(tp))
    assert not any(p.requires_grad for p in lm.parameters())
    for (_, a), (_, b) in zip(tree_paths(lm.tree()), tree_paths(tp)):
        assert a.data_ptr() == b.data_ptr()
    want, _ = prefill(tp, _tb(batch), tcfg, max_seq=MAX_SEQ)
    got, caches = lm.prefill(_tb(batch), max_seq=MAX_SEQ)
    assert torch.equal(got, want)
    h, _ = lm(_tb(batch))
    assert torch.equal(h, forward(tp, _tb(batch), tcfg)[0])
    logits, _ = lm.decode_step(caches, torch.from_numpy(batch["tokens"][:, 0]), 8)
    assert logits.shape == (B, tcfg.vocab)
    init = LM.init(tcfg, seed=1, device="cpu")
    assert sorted(init.state_dict()) == keys


def test_a_mesh_or_a_short_max_seq_raises():
    """Training's forward and prefill on a mesh raise citing step 10 for a
    family that is not attention + MLP only (10.2–10.4) and under a rule
    table other than DEFAULT_RULES (10.5); an attention + MLP forward on a
    mesh takes the rank's blocks, not the whole parameters."""
    from repro_torch.sharding import TRAIN_FSDP_SP_RULES, abstract_mesh

    _, tcfg, _, tp, batch = _case("granite-3-8b")
    mesh = abstract_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="rank's block"):
        forward(tp, _tb(batch), tcfg, mesh=mesh)
    with pytest.raises(NotImplementedError, match="step 10"):
        forward(tp, _tb(batch), tcfg, mesh=mesh, rules=TRAIN_FSDP_SP_RULES)
    for arch in ("olmoe-1b-7b", "jamba-1.5-large-398b", "rwkv6-3b", "whisper-tiny"):
        _, acfg, _, ap, abatch = _case(arch)
        with pytest.raises(NotImplementedError, match="step 10"):
            prefill(ap, _tb(abatch), acfg, mesh=mesh, max_seq=MAX_SEQ)
        with pytest.raises(NotImplementedError, match="step 10"):
            forward(ap, _tb(abatch), acfg, mesh=mesh)
    with pytest.raises(ValueError, match="shorter than the prompt"):
        prefill(tp, _tb(batch), tcfg, max_seq=4)


def _teacher_forced(tp, tcfg, batch, tokens):
    """The port's logits over ``tokens`` by one full forward (B, S, V)."""
    b = dict(_tb(batch), tokens=torch.from_numpy(tokens))
    h, _ = forward(tp, b, tcfg)
    return lm_head_logits(tp, h, tcfg)


def test_rwkv_prompt_as_long_as_the_head_count_decodes():
    """rwkv6-3b reduced has H = 4 heads; its WKV state is (G, B, H, D, D).
    The reference pads every rank-5 cache leaf whose axis 2 equals the
    prompt length, so a 4-token prompt pads the state to (…, 16, …) and
    its decode_step raises.  The port pads only self-attention K/V: the
    prompt decodes, and each step's logits equal the teacher-forced
    forward's at that position."""
    _, tcfg, _, tp, _ = _case("rwkv6-3b")
    assert tcfg.d_model // tcfg.rwkv_head_dim == 4
    batch = batch_arrays(tcfg, B, 4, 2)
    logits, caches = prefill(tp, _tb(batch), tcfg, max_seq=MAX_SEQ)
    assert tuple(caches["decoder"]["l0"]["mixer"]["wkv"].shape) == (2, B, 4, 16, 16)
    toks = batch["tokens"]
    steps = [logits]
    for i in range(3):
        nxt = np.asarray(torch.argmax(steps[-1], -1), np.int32)
        toks = np.concatenate([toks, nxt[:, None]], axis=1)
        lg, caches = decode_step(tp, caches, torch.from_numpy(nxt), 4 + i, tcfg)
        steps.append(lg)
    full = _teacher_forced(tp, tcfg, batch, toks)
    for i, lg in enumerate(steps):
        # a recurrence run token by token against the same run over the
        # whole sequence: the same roundings in another grouping
        assert_bf16_close(lg, full[:, 3 + i], 4, f"rwkv step {i}")


def test_whisper_prompt_of_n_frames_decodes_its_teacher_forced_logits():
    """whisper-tiny reduced has n_frames = 8.  With a prompt of 8 tokens the
    reference pads the cross-attention K/V (axis 2 = 8 = the prompt
    length) with zeros, and decode attends to them (its logits then differ
    from the teacher-forced forward by up to 2.79).  The port leaves the
    cross K/V alone: decode equals the teacher-forced logits."""
    _, tcfg, _, tp, _ = _case("whisper-tiny")
    assert tcfg.n_frames == 8
    batch = batch_arrays(tcfg, B, 8, 3)
    logits, caches = prefill(tp, _tb(batch), tcfg, max_seq=MAX_SEQ)
    assert tuple(caches["decoder"]["l0"]["cross"]["k"].shape)[2] == 8
    nxt = np.asarray(torch.argmax(logits, -1), np.int32)
    lg, _ = decode_step(tp, caches, torch.from_numpy(nxt), 8, tcfg)
    full = _teacher_forced(tp, tcfg, batch,
                           np.concatenate([batch["tokens"], nxt[:, None]], axis=1))
    assert_bf16_close(logits, full[:, 7], 4, "whisper prefill")
    assert_bf16_close(lg, full[:, 8], 4, "whisper decode at S = n_frames")


def test_models_run_from_init_params():
    """Every reduced arch from the port's own init: finite logits and caches
    of the declared shapes."""
    for arch in TC.ARCH_NAMES:
        tcfg = TC.get_config(arch, reduced=True)
        tp = LM.init(tcfg, seed=0, device="cpu").tree()
        batch = batch_arrays(tcfg, B, _seq(tcfg), 4)
        logits, caches = prefill(tp, _tb(batch), tcfg, max_seq=MAX_SEQ)
        lg, _ = decode_step(tp, caches, torch.from_numpy(batch["tokens"][:, 0]),
                            _seq(tcfg), tcfg)
        assert bool(torch.isfinite(logits).all() and torch.isfinite(lg).all()), arch
        assert tree_map(lambda t: tuple(t.shape), caches) == tree_map(
            lambda t: tuple(t.shape), param_shapes(cache_defs(tcfg, B, MAX_SEQ))), arch


def test_model_defs_match_jax():
    for arch in TC.ARCH_NAMES:
        jd = j_defs(JC.get_config(arch, reduced=True))
        td = model_defs(TC.get_config(arch, reduced=True))
        jleaves = {tuple(str(getattr(k, "key", k)) for k in path): (d.shape, d.axes, d.init,
                                                                    d.scale)
                   for path, d in jax.tree_util.tree_flatten_with_path(
                       jd, is_leaf=lambda x: hasattr(x, "axes"))[0]}
        tleaves = {p: (d.shape, d.axes, d.init, d.scale) for p, d in tree_paths(td)}
        assert tleaves == jleaves, arch
