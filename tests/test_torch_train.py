"""The LM port's training path (``repro_torch.core.rng``'s ``fold_in`` and
``normal``, ``data``, ``optim``, ``train``, ``convert``'s train-state
helpers) against the JAX package on the CPU.

Tolerances:

* integer draws, tokens and labels, ``normal`` and ``erf_inv``: bit for
  bit (``normal`` and ``log1p``/``erf_inv`` over every value the uniform
  draw can take);
* ``cosine_schedule``: float32, equal on most steps, and within 2^-22 of
  ``lr_peak`` (its ``cos`` is float64 rounded to float32, XLA's its own:
  one ulp apart on a few steps in a thousand, which ``1 + cos`` keeps);
* ``adamw_update`` on identical gradients: bit for bit while the clip does
  not act (norm <= clip_norm) and with bfloat16 gradients (the clipped
  gradient rounds to bfloat16); with float32 gradients clipped, within 4
  float32 ulps of each leaf's largest magnitude (the global norm sums
  each leaf in torch's order, XLA in its own: up to 4 ulps apart);
* the loss within 1 bfloat16 step of its own size (2^-8 of it), each
  gradient leaf within 8 bfloat16 steps of its largest magnitude (the
  backward passes round bfloat16 cotangents in other places than XLA's
  transpose; measured at most 5.5, whisper's encoder norm bias), jamba 32
  (measured 25.7: 7 Mamba layers carry a residual stream of ~10^4, where
  one bfloat16 ulp is 32–64, and a difference of half a step at layer 0
  grows through them; ``test_layer_gradients_match_jax`` holds each of its
  layers alone within 8).

Parameters come from numpy (``torch_lm_common.np_params``), so both
packages start from the same arrays; the reference runs compiled with
excess precision off (``strict_jit``).
"""
import dataclasses
import functools

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
)

from repro import configs as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import model_defs as j_defs  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rng, xla_math  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models.params import tree_map, tree_paths  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

F32_ULP = 2.0 ** -23
GRAD_STEPS = 8
GRAD_STEPS_JAMBA = 32
FAMILIES = ("qwen3-1.7b", "olmoe-1b-7b", "jamba-1.5-large-398b", "rwkv6-3b",
            "whisper-tiny", "phi-3-vision-4.2b")
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
            d_ff=128, vocab=97, remat="none")


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _ulps(a, b) -> int:
    d = _bits(a).astype(np.int64) - _bits(b).astype(np.int64)
    return int(np.abs(d).max()) if d.size else 0


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _jpaths(tree) -> dict:
    """{path: numpy leaf} of a JAX dict tree."""
    return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _uniform_draws() -> np.ndarray:
    """Every value of ``jax.random.uniform(key, minval=nextafter(-1, 0),
    maxval=1)``: the 2^23 mantissas of [1, 2), minus 1, times 2, plus lo."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    f = (np.arange(2 ** 23, dtype=np.uint32) | np.uint32(0x3F800000)).view(np.float32) - 1
    return np.maximum(lo, f * np.float32(2.0) + lo).astype(np.float32)


# ---------------------------------------------------------------------------
# core/rng.py: fold_in, normal (and xla_math's log1p, erf_inv)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,data", [(0, 0), (3, 7), (42, 2 ** 31 + 5), (2 ** 32 - 1, 123)])
def test_fold_in_matches_jax(seed, data):
    want = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed), data)))
    assert rng.fold_in(rng.PRNGKey(seed), data) == tuple(int(w) for w in want)


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 4, 33)])
def test_normal_matches_jax_bit_for_bit(shape):
    for seed in (0, 9):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
        want = np.asarray(jax.random.normal(key, shape))
        got = rng.normal(rng.fold_in(rng.PRNGKey(seed), 4), shape, device="cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fn", ["log1p", "erf_inv"])
def test_erf_inv_and_log1p_over_every_uniform_draw(fn):
    """xla_erf_inv (and the log1p of −u² inside it) equal XLA's CPU result
    on every value that normal's uniform draw can take."""
    u = _uniform_draws()
    if fn == "log1p":
        want = np.asarray(jax.jit(lambda x: jnp.log1p(-x * x))(u))
        got = xla_math.xla_log1p(torch.from_numpy(u) * -torch.from_numpy(u))
    else:
        from jax._src.lax.special import erf_inv

        want = np.asarray(jax.jit(erf_inv)(u))
        got = xla_math.xla_erf_inv(torch.from_numpy(u))
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# data/pipeline.py
# ---------------------------------------------------------------------------
DATA_CASES = {
    "text": dict(vocab=97, seq_len=16, global_batch=4, seed=3),
    "vision": dict(vocab=151936, seq_len=12, global_batch=2, seed=1, n_patches=5, d_model=16),
    "frames": dict(vocab=53, seq_len=8, global_batch=3, seed=0, n_frames=6, d_model=8),
}


@pytest.mark.parametrize("case", sorted(DATA_CASES))
@pytest.mark.parametrize("step", [0, 7, 2 ** 31 + 5])
def test_synthetic_batch_matches_jax(case, step):
    kw = DATA_CASES[case]
    want = JD.synthetic_batch(JD.DataConfig(**kw), step)
    got = TD.synthetic_batch(TD.DataConfig(**kw), step, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy().view(np.int32), w.view(np.int32))


def test_data_deterministic_resumable_and_shifted():
    dc = TD.DataConfig(vocab=97, seq_len=16, global_batch=4, seed=3)
    a, b = (TD.synthetic_batch(dc, 7, device="cpu") for _ in range(2))
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], TD.synthetic_batch(dc, 8, device="cpu")["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_host_slice_and_batch_spec_match_jax(case):
    kw = dict(DATA_CASES[case], global_batch=8)
    batch = TD.synthetic_batch(TD.DataConfig(**kw), 0, device="cpu")
    jbatch = JD.synthetic_batch(JD.DataConfig(**kw), 0)
    for i in range(4):
        got, want = TD.host_slice(batch, i, 4), JD.host_slice(jbatch, i, 4)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    glued = torch.cat([TD.host_slice(batch, i, 4)["tokens"] for i in range(4)])
    assert torch.equal(glued, batch["tokens"])
    spec, jspec = TD.batch_spec(TD.DataConfig(**kw)), JD.batch_spec(JD.DataConfig(**kw))
    assert sorted(spec) == sorted(jspec)
    for k, s in spec.items():
        assert s.device.type == "meta"
        assert tuple(s.shape) == tuple(jspec[k].shape) == tuple(batch[k].shape)
        assert s.dtype == batch[k].dtype
        assert np.dtype(str(s.dtype).split(".")[-1]) == jspec[k].dtype


# ---------------------------------------------------------------------------
# optim/adamw.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", [dict(lr_peak=1.0, warmup_steps=10, total_steps=100),
                                 dict(lr_peak=3e-3, warmup_steps=100, total_steps=10_000),
                                 dict(lr_peak=1e-2, warmup_steps=0, total_steps=7)])
def test_cosine_schedule_matches_jax(opt):
    jc, tc = JA.AdamWConfig(**opt), TA.AdamWConfig(**opt)
    steps = np.arange(0, opt["total_steps"] + 3, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: JA.cosine_schedule(jc, s))(steps))
    got = TA.cosine_schedule(tc, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    # cos(π·prog) one ulp apart at most (2^-24 at |cos| <= 1), which 1 + cos
    # keeps where it cancels, times 0.5·lr_peak, and the last rounding
    np.testing.assert_array_less(np.abs(got.numpy() - want), 2.0 ** -22 * opt["lr_peak"])
    assert np.mean(_bits(got) == _bits(want)) >= 0.75
    # the reference test's shape: 0 at 0, the peak at the end of warm-up,
    # falling to 0 at the end
    lrs = [float(TA.cosine_schedule(tc, s)) for s in range(opt["total_steps"] + 1)]
    peak = max(opt["warmup_steps"], 1)
    assert lrs[0] == 0.0
    if opt["warmup_steps"]:  # without warm-up the decay starts at step 1
        assert abs(lrs[peak] - opt["lr_peak"]) < 1e-6 * opt["lr_peak"]
    assert lrs[-1] < 1e-6 * opt["lr_peak"]
    assert all(a >= b - 1e-9 for a, b in zip(lrs[peak:], lrs[peak + 1:]))


def _grad_tree(rs, scale, dtype=np.float32):
    return {"b": (rs.standard_normal((37, 5)) * scale).astype(dtype),
            "a": (rs.standard_normal((1000,)) * scale).astype(dtype),
            "c": {"z": (rs.standard_normal((3, 3)) * scale).astype(dtype),
                  "y": (rs.standard_normal((64,)) * scale).astype(dtype)}}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_norm", [0.5, 3.0, 100.0])
def test_global_norm_and_clip_match_jax(seed, max_norm):
    tree = _grad_tree(np.random.default_rng(seed), 10.0)
    jt = jx(tree)
    tt = tree_map(torch.from_numpy, tree)
    want, wnorm = JA.clip_by_global_norm(jt, max_norm)
    got, norm = TA.clip_by_global_norm(tt, max_norm)
    assert _ulps(norm, wnorm) <= 4
    assert _ulps(TA.global_norm(tt), JA.global_norm(jt)) <= 4
    assert float(TA.global_norm(got)) <= max_norm * 1.001
    wp = _jpaths(want)
    for path, g in tree_paths(got):
        assert g.dtype == torch.float32
        scale = float(np.abs(wp[path]).max())
        assert np.abs(g.numpy() - wp[path]).max() <= 4 * F32_ULP * scale
    if float(norm) <= max_norm:  # no-op under the limit
        for (_, g), (_, t) in zip(tree_paths(got), tree_paths(tt)):
            assert torch.equal(g, t)


def test_global_norm_sums_the_leaves_in_sorted_key_order():
    tree = {"b": torch.ones(1), "a": {"z": torch.zeros(1), "c": torch.full((1,), 2.0)}}
    leaves = TA.tree_leaves(tree)
    assert [float(x) for x in leaves] == [2.0, 0.0, 1.0]


def _run_adamw(opt_kw, grads_dtype, gscale, n_steps=6):
    """(worst ulps of p, m, v over the steps; worst ulps in units of each
    leaf's max |x|; lr ulps), each step fed the JAX state on both sides."""
    jc, tc = JA.AdamWConfig(**opt_kw), TA.AdamWConfig(**opt_kw)
    rs = np.random.default_rng(0)
    params = _grad_tree(rs, 1.0)
    jp = jx(params)
    jo = JA.adamw_init(jp, jc)
    upd = strict_jit(lambda p, g, o: JA.adamw_update(p, g, o, jc))
    worst, worst_scaled, lr_ulps = 0, 0.0, 0
    for _ in range(n_steps):
        g = _grad_tree(rs, gscale)
        if grads_dtype == "bfloat16":
            jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
            tg = convert.lm_params_from_arrays(_np(jg))
        else:
            jg, tg = jx(g), tree_map(torch.from_numpy, g)
        tp = convert.lm_params_from_arrays(_np(jp))
        topt = convert.train_state_from_arrays(_np(jp), jo.step, _np(jo.mu), _np(jo.nu)).opt
        jp2, jo2, jm = upd(jp, jg, jo)
        tp2, to2, tm = TA.adamw_update(tp, tg, topt, tc)
        assert int(to2.step) == int(jo2.step) and to2.step.dtype == torch.int32
        for want, got in ((jp2, tp2), (jo2.mu, to2.mu), (jo2.nu, to2.nu)):
            wp = _jpaths(want)
            for path, t in tree_paths(got):
                worst = max(worst, _ulps(t, wp[path]))
                scale = max(float(np.abs(wp[path]).max()), 1e-30)
                worst_scaled = max(worst_scaled,
                                   float(np.abs(t.numpy() - wp[path]).max()) / (F32_ULP * scale))
        lr_ulps = max(lr_ulps, _ulps(tm["lr"], jm["lr"]))
        assert _ulps(tm["grad_norm"], jm["grad_norm"]) <= 4
        jp, jo = jp2, jo2
    # the inputs were not written
    return worst, worst_scaled, lr_ulps


@pytest.mark.parametrize("case", ["unclipped", "clipped-bf16"])
def test_adamw_update_matches_jax_bit_for_bit(case):
    opt = dict(lr_peak=3e-3, warmup_steps=3, total_steps=20)
    if case == "unclipped":
        worst, _, lr_ulps = _run_adamw(dict(opt, clip_norm=1e9), "float32", 1e-3)
    else:
        worst, _, lr_ulps = _run_adamw(dict(opt, clip_norm=1.0), "bfloat16", 1.0)
    assert (worst, lr_ulps) == (0, 0)


def test_adamw_update_clipped_float32_within_ulps():
    _, worst_scaled, lr_ulps = _run_adamw(
        dict(lr_peak=3e-3, warmup_steps=3, total_steps=20, clip_norm=1.0), "float32", 1.0)
    assert lr_ulps == 0
    assert worst_scaled <= 4


def test_adamw_update_is_pure_and_moves_toward_minimum():
    cfg = TA.AdamWConfig(lr_peak=0.5, warmup_steps=0, total_steps=100, weight_decay=0.0,
                         clip_norm=100.0, zero1=False)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = TA.adamw_init(params, cfg)
    before = params["w"].clone()
    new, new_opt, _ = TA.adamw_update(params, {"w": 2 * params["w"]}, opt, cfg)
    assert torch.equal(params["w"], before) and int(opt.step) == 0
    assert float(opt.mu["w"].abs().sum()) == 0.0
    for _ in range(100):
        params, opt, _ = TA.adamw_update(params, {"w": 2 * params["w"]}, opt, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_a_mesh_raises_in_the_optimizer():
    """On a mesh the optimizer needs the parameters' placements (a
    ValueError without them); adamw_init makes the ZeRO-1 moment blocks
    (a (4, 6) leaf cut over model on dim 0: (2, 3) moments, data on dim 1),
    and adamw_update, which all-gathers over data, raises on an abstract
    mesh, which issues no collective.  tests/test_torch_lm_train_mesh.py
    holds the update on running meshes to mesh=None's."""
    from repro_torch.sharding import abstract_mesh

    p = {"w": torch.zeros(2, 6)}  # this rank's block of a (4, 6) leaf
    specs = {"w": ("model",)}
    mesh = abstract_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="param_specs"):
        TA.adamw_init(p, TA.AdamWConfig(), mesh=mesh)
    opt = TA.adamw_init(p, TA.AdamWConfig(), mesh=mesh, param_specs=specs)
    assert tuple(opt.mu["w"].shape) == tuple(opt.nu["w"].shape) == (2, 3)
    with pytest.raises(ValueError, match="param_specs"):
        TA.adamw_update(p, p, opt, TA.AdamWConfig(), mesh=mesh)
    with pytest.raises(RuntimeError, match="abstract mesh issues no collective"):
        TA.adamw_update(p, p, opt, TA.AdamWConfig(), mesh=mesh, param_specs=specs)
    assert TA.zero1_spec(("model",), (4, 6), mesh) == ("model", "data")


# ---------------------------------------------------------------------------
# train/step.py: the loss
# ---------------------------------------------------------------------------
def _tiny_params(cfg_kw=TINY, seed=0):
    jcfg = JModelConfig(**cfg_kw)
    arrays = np_params(j_defs(jcfg), seed)
    return jcfg, ModelConfig(**cfg_kw), jx(arrays), convert.lm_params_from_arrays(arrays)


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_loss_equals_unchunked_and_jax(chunk):
    from repro_torch.models.transformer import lm_head_logits

    jcfg, tcfg, jp, tp = _tiny_params()
    rs = np.random.default_rng(0)
    hidden = (rs.standard_normal((2, 16, 64)) * 0.1).astype(np.float32)
    labels = rs.integers(0, 97, (2, 16)).astype(np.int32)
    tot, cnt = TS.chunked_ce_loss(tp, torch.from_numpy(hidden), torch.from_numpy(labels), tcfg,
                                  chunk=chunk)
    logits = lm_head_logits(tp, torch.from_numpy(hidden), tcfg)
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, torch.from_numpy(labels).long()[..., None])[..., 0]
    np.testing.assert_allclose(float(tot), float(torch.sum(lse - ll)), rtol=1e-5)
    assert float(cnt) == 32
    jtot, jcnt = strict_jit(lambda p, h, lab: JS.chunked_ce_loss(p, h, lab, jcfg, chunk=chunk))(
        jp, hidden, labels)
    assert abs(float(tot) - float(jtot)) <= BF16_STEP * abs(float(jtot))
    assert float(jcnt) == float(cnt)


def test_masked_labels_excluded():
    _, tcfg, _, tp = _tiny_params()
    labels = torch.tensor([[-1, -1, 3, 4, 5, -1, 7, 8]], dtype=torch.int32)
    tot, cnt = TS.chunked_ce_loss(tp, torch.zeros((1, 8, 64)), labels, tcfg, chunk=8)
    assert float(cnt) == 5
    # each unmasked position of a zero hidden state costs log V
    np.testing.assert_allclose(float(tot), 5 * np.log(97), rtol=1e-6)


def test_chunked_loss_keeps_one_chunk_of_logits_live():
    """Under autograd the loss saves no (B, chunk, V) logits for the
    backward pass: each chunk is recomputed."""
    _, tcfg, _, tp = _tiny_params()
    hidden = torch.randn(2, 16, 64, requires_grad=True)
    labels = torch.randint(0, 97, (2, 16), dtype=torch.int32)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tot, _ = TS.chunked_ce_loss(tp, hidden, labels, tcfg, chunk=4)
    assert not any(len(s) == 3 and s[-1] == 97 for s in saved), saved
    tot.backward()
    assert hidden.grad is not None and bool(torch.isfinite(hidden.grad).all())


# ---------------------------------------------------------------------------
# train/step.py: loss and gradients against jax.grad, per family
# ---------------------------------------------------------------------------
def _family_batch(cfg, seq):
    """PR 29's forward-test request (seed 1) with the next token as label
    (the last position masked)."""
    b = batch_arrays(cfg, 2, seq, 1)
    labels = np.full_like(b["tokens"], -1)
    labels[:, :-1] = b["tokens"][:, 1:]
    b["labels"] = labels
    return b


@functools.lru_cache(maxsize=None)
def _family(arch):
    cfg = JC.get_config(arch, reduced=True)
    arrays = np_params(j_defs(cfg), 0)
    batch = _family_batch(cfg, 7 if cfg.encoder_layers else 8)
    return cfg, port_cfg(cfg), arrays, batch


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_grads_close(got, want, steps, what):
    wp = _jpaths(want)
    assert set(wp) == {p for p, _ in tree_paths(got)}
    for path, g in tree_paths(got):
        assert_bf16_close(g, wp[path], steps, f"{what} grad {'/'.join(path)}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    cfg, tcfg, arrays, batch = _family(arch)
    jtc, ttc = JS.TrainConfig(loss_chunk=4), TS.TrainConfig(loss_chunk=4)
    jg, jm = strict_jit(lambda p, b: jax.grad(JS.make_loss_fn(cfg, jtc), has_aux=True)(p, b))(
        jx(arrays), jx(batch))
    tg, tm = TS.grad_with_aux(TS.make_loss_fn(tcfg, ttc), convert.lm_params_from_arrays(arrays),
                              _tb(batch))
    for k in ("ce_loss", "aux_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= BF16_STEP * abs(float(jm[k])), k
    assert float(tm["tokens"]) == float(jm["tokens"])
    if cfg.frontend == "vision":  # the patch prefix carries no target
        assert float(tm["tokens"]) == 2 * (batch["tokens"].shape[1] - cfg.n_patches - 1)
    steps = GRAD_STEPS_JAMBA if arch.startswith("jamba") else GRAD_STEPS
    _assert_grads_close(tg, jg, steps, arch)


LAYERS = [("qwen3-1.7b", 0, "attn"), ("olmoe-1b-7b", 0, "moe"),
          ("jamba-1.5-large-398b", 1, "mamba"), ("jamba-1.5-large-398b", 1, "moe"),
          ("rwkv6-3b", 0, "rwkv"), ("whisper-tiny", 0, "gelu")]


@pytest.mark.parametrize("arch,li,part", LAYERS)
def test_layer_gradients_match_jax(arch, li, part):
    """One mixer or FFN alone, the same bfloat16 input and output cotangent
    on both sides: the VJP of each layer kind (jamba's Mamba and MoE
    layers included) within 8 bfloat16 steps."""
    from repro.models import layers as JL
    from repro.models import mamba as JMB
    from repro.models import moe as JMO
    from repro.models import rwkv as JRW
    from repro_torch.models import layers as TL
    from repro_torch.models import mamba as TMB
    from repro_torch.models import moe as TMO
    from repro_torch.models import rwkv as TRW

    cfg, tcfg, arrays, _ = _family(arch)
    key = "mixer" if part in ("attn", "mamba", "rwkv") else "ffn"
    lp = jax.tree_util.tree_map(lambda a: a[0], arrays["decoder"][f"l{li}"][key])
    rs = np.random.default_rng(3)
    x = jnp.asarray(rs.standard_normal((2, 8, cfg.d_model)), jnp.bfloat16)
    ct = jnp.asarray(rs.standard_normal((2, 8, cfg.d_model)), jnp.bfloat16)

    def jfn(p, x):
        if part == "attn":
            return JL.attention(p, x, cfg, mesh=None, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)[0]
        if part == "mamba":
            return JMB.mamba(p, x, cfg, mesh=None)[0]
        if part == "rwkv":
            return JRW.rwkv_time_mix(p, x, cfg, mesh=None)[0]
        if part == "moe":
            return JMO.moe_ffn(p, x, cfg, mesh=None, seq_chunk=cfg.moe_seq_chunk)[0]
        return JL.mlp(p, x, cfg, mesh=None)

    def tfn(p, x):
        if part == "attn":
            return TL.attention(p, x, tcfg, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)[0]
        if part == "mamba":
            return TMB.mamba(p, x, tcfg)[0]
        if part == "rwkv":
            return TRW.rwkv_time_mix(p, x, tcfg)[0]
        if part == "moe":
            return TMO.moe_ffn(p, x, tcfg, seq_chunk=cfg.moe_seq_chunk)[0]
        return TL.mlp(p, x, tcfg)

    def jrun(p, x, c):
        y, vjp = jax.vjp(jfn, p, x)
        return (y,) + vjp(c)

    y, jgp, jgx = strict_jit(jrun)(jx(lp), x, ct)
    tp = tree_map(lambda t: t.requires_grad_(True), convert.lm_params_from_arrays(_np(lp)))
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16().requires_grad_(True)
    ty = tfn(tp, tx)
    assert_bf16_close(ty, y, 4, f"{arch} {part} output")
    leaves = [t for _, t in tree_paths(tp)]
    tct = torch.from_numpy(np.asarray(ct.astype(jnp.float32))).bfloat16()
    grads = torch.autograd.grad(ty, leaves + [tx], tct, allow_unused=True)
    assert_bf16_close(grads[-1], jgx, GRAD_STEPS, f"{arch} {part} input grad")
    wp = _jpaths(jgp)
    for (path, t), g in zip(tree_paths(tp), grads[:-1]):
        g = torch.zeros_like(t) if g is None else g
        assert_bf16_close(g, wp[path], GRAD_STEPS, f"{arch} {part} grad {'/'.join(path)}")


# ---------------------------------------------------------------------------
# train/step.py: make_train_step's options
# ---------------------------------------------------------------------------
def _step_pair(tc_kw, cfg_kw=TINY, n_micro=1, seq=16, batch=8):
    """(JAX metrics, JAX grads, port metrics, port grads) of one step's
    gradients with TrainConfig(**tc_kw), the same params and batch."""
    jcfg, tcfg, jp, tp = _tiny_params(cfg_kw)
    jtc = JS.TrainConfig(**{k: (jnp.bfloat16 if v is torch.bfloat16 else v)
                            for k, v in tc_kw.items()})
    ttc = TS.TrainConfig(**tc_kw)
    dk = dict(vocab=cfg_kw["vocab"], seq_len=seq, global_batch=batch, seed=0)
    jb = JD.synthetic_batch(JD.DataConfig(**dk), 0)
    tb = TD.synthetic_batch(TD.DataConfig(**dk), 0, device="cpu")
    jl, tl = JS.make_loss_fn(jcfg, jtc), TS.make_loss_fn(tcfg, ttc)
    cdt = tc_kw.get("param_compute_dtype")
    if cdt is not None:
        jp = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), jp)
        tp = tree_map(lambda p: p.to(cdt), tp)
    if n_micro > 1:
        jg, jm = strict_jit(lambda p, b: JS._microbatch_grads(
            jl, p, b, n_micro, jtc.grad_accum_dtype))(jp, jb)
        tg, tm = TS._microbatch_grads(tl, tp, tb, n_micro, ttc.grad_accum_dtype)
    else:
        jg, jm = strict_jit(lambda p, b: jax.grad(jl, has_aux=True)(p, b))(jp, jb)
        tg, tm = TS.grad_with_aux(tl, tp, tb)
    return jm, jg, tm, tg


@pytest.mark.parametrize("case", ["microbatches-4", "grad-accum-bf16", "param-compute-bf16"])
def test_train_step_options_match_jax(case):
    tc = dict(loss_chunk=16)
    n_micro = 1
    if case == "microbatches-4":
        tc, n_micro = dict(tc, microbatches=4), 4
    elif case == "grad-accum-bf16":
        tc, n_micro = dict(tc, microbatches=2, grad_accum_dtype=torch.bfloat16), 2
    else:
        tc = dict(tc, param_compute_dtype=torch.bfloat16)
    jm, jg, tm, tg = _step_pair(tc, n_micro=n_micro)
    want_dtype = torch.bfloat16 if case != "microbatches-4" else torch.float32
    assert all(g.dtype == want_dtype for _, g in tree_paths(tg))
    for k in ("ce_loss", "tokens"):
        assert abs(float(tm[k]) - float(jm[k])) <= BF16_STEP * abs(float(jm[k])), k
    _assert_grads_close(tg, jg, GRAD_STEPS, case)


def test_microbatches_match_single_shot():
    _, _, t1, _ = _step_pair(dict(loss_chunk=16))
    _, _, t4, _ = _step_pair(dict(loss_chunk=16, microbatches=4), n_micro=4)
    assert abs(float(t1["ce_loss"]) - float(t4["ce_loss"])) < 0.02
    assert float(t1["tokens"]) == float(t4["tokens"])


def test_param_compute_dtype_clips_in_bfloat16():
    """With bfloat16 compute the gradients are bfloat16 and the clip rounds
    back to bfloat16 (the reference's adamw.py:62): the port's clipped
    gradients equal the JAX package's on the same bfloat16 gradients, and
    a full train step keeps float32 master weights."""
    _, jg, _, tg = _step_pair(dict(loss_chunk=16, param_compute_dtype=torch.bfloat16))
    jc, jn = JA.clip_by_global_norm(jg, 1.0)
    tc, tn = TA.clip_by_global_norm(convert.lm_params_from_arrays(_np(jg)), 1.0)
    assert _ulps(tn, jn) <= 4
    wp = _jpaths(jc)
    for path, g in tree_paths(tc):
        # the norms a few float32 ulps apart: an element can round to the
        # neighbouring bfloat16 value
        assert g.dtype == torch.bfloat16
        want = wp[path].astype(np.float32)
        np.testing.assert_array_less(np.abs(g.float().numpy() - want),
                                     BF16_STEP * np.abs(want) + 1e-30)
        assert np.mean(g.float().numpy() == want) > 0.99
    assert len(list(tree_paths(tg))) == len(wp)
    tcfg = ModelConfig(**TINY)
    ttc = TS.TrainConfig(loss_chunk=16, param_compute_dtype=torch.bfloat16)
    state = TS.init_train_state(tcfg, ttc, 0, device="cpu")
    batch = TD.synthetic_batch(TD.DataConfig(vocab=97, seq_len=16, global_batch=4), 0,
                               device="cpu")
    new, m = TS.make_train_step(tcfg, ttc)(state, batch)
    assert all(p.dtype == torch.float32 for _, p in tree_paths(new.params))
    assert int(new.opt.step) == 1 and np.isfinite(float(m["ce_loss"]))


REMAT = dict(name="t", n_layers=4, d_model=32, n_heads=2, n_kv_heads=2, d_head=16, d_ff=64,
             vocab=53, remat="full")


@pytest.mark.parametrize("variant", ["remat-none", "remat_block-2", "remat_block-4",
                                     "unrolled"])
def test_remat_changes_no_value(variant):
    """remat 'full' (each group checkpointed) against 'none', and
    remat_block 1 against 2 and 4: the same loss, gradients and new state,
    bit for bit."""
    base = ModelConfig(**REMAT)
    other = {"remat-none": dataclasses.replace(base, remat="none"),
             "remat_block-2": dataclasses.replace(base, remat_block=2),
             "remat_block-4": dataclasses.replace(base, remat_block=4),
             "unrolled": dataclasses.replace(base, scan_layers=False)}[variant]
    tc = TS.TrainConfig(opt=TA.AdamWConfig(), loss_chunk=16)
    batch = TD.synthetic_batch(TD.DataConfig(vocab=53, seq_len=16, global_batch=4), 0,
                               device="cpu")
    outs = []
    for cfg in (base, other):
        state = TS.init_train_state(cfg, tc, 0, device="cpu")
        outs.append(TS.make_train_step(cfg, tc)(state, batch))
    (s1, m1), (s2, m2) = outs
    assert float(m1["ce_loss"]) == float(m2["ce_loss"])
    assert float(m1["grad_norm"]) == float(m2["grad_norm"])
    for (_, a), (_, b) in zip(tree_paths(s1.params), tree_paths(s2.params)):
        assert torch.equal(a, b)


def test_remat_checkpoints_each_group():
    """Under remat 'full' the backward pass recomputes each group: the
    forward saves only the groups' inputs and the loss's chunk inputs, far
    fewer tensors than without remat."""
    cfg = ModelConfig(**REMAT)
    tc = TS.TrainConfig(loss_chunk=16)
    batch = TD.synthetic_batch(TD.DataConfig(vocab=53, seq_len=16, global_batch=4), 0,
                               device="cpu")
    counts = []
    for c in (cfg, dataclasses.replace(cfg, remat="none")):
        params = tree_map(lambda t: t.requires_grad_(True),
                          TS.init_train_state(c, tc, 0, device="cpu").params)
        n = [0]

        def pack(t, n=n):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            TS.make_loss_fn(c, tc)(params, batch)
        counts.append(n[0])
    assert counts[0] * 4 < counts[1], counts
    with pytest.raises(ValueError, match="remat_block"):
        params = TS.init_train_state(cfg, tc, 0, device="cpu").params
        TS.make_loss_fn(dataclasses.replace(cfg, remat_block=3), tc)(params, batch)


def test_train_step_matches_jax_and_the_loss_falls():
    """test_train_substrate.py's run in the port: the first step's metrics
    against the JAX package's from the same parameters, then 30 steps
    lower the loss by more than 0.4."""
    jcfg, tcfg, jp, tp = _tiny_params()
    opt = dict(lr_peak=1e-2, warmup_steps=5, total_steps=50)
    jtc = JS.TrainConfig(opt=JA.AdamWConfig(**opt), loss_chunk=16)
    ttc = TS.TrainConfig(opt=TA.AdamWConfig(**opt), loss_chunk=16)
    dk = dict(vocab=97, seq_len=32, global_batch=8, seed=0)
    zeros = jax.tree_util.tree_map(np.zeros_like, _np(jp))
    state = convert.train_state_from_arrays(_np(jp), 0, zeros, zeros)
    _, jm = strict_jit(JS.make_train_step(jcfg, jtc))(
        JS.TrainState(jp, JA.adamw_init(jp, jtc.opt)), JD.synthetic_batch(JD.DataConfig(**dk), 0))
    step = TS.make_train_step(tcfg, ttc)
    losses = []
    for s in range(30):
        state, m = step(state, TD.synthetic_batch(TD.DataConfig(**dk), s, device="cpu"))
        if s == 0:
            want = float(jm["ce_loss"])
            assert abs(float(m["ce_loss"]) - want) <= BF16_STEP * want
            assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 8 * BF16_STEP * float(
                jm["grad_norm"])
            assert float(m["lr"]) == float(jm["lr"]) and int(m["step"]) == int(jm["step"]) == 1
            assert set(m) == set(jm)
        losses.append(float(m["ce_loss"]))
    assert losses[-1] < losses[0] - 0.4
    assert int(state.opt.step) == 30


def test_train_step_leaves_its_inputs_and_raises_on_a_mesh():
    cfg = ModelConfig(**TINY)
    tc = TS.TrainConfig(loss_chunk=16)
    state = TS.init_train_state(cfg, tc, 0, device="cpu")
    before = [t.clone() for _, t in tree_paths(state.params)]
    batch = TD.synthetic_batch(TD.DataConfig(vocab=97, seq_len=16, global_batch=4), 0,
                               device="cpu")
    new, _ = TS.make_train_step(cfg, tc)(state, batch)
    assert all(torch.equal(a, b) for a, (_, b) in zip(before, tree_paths(state.params)))
    assert int(state.opt.step) == 0 and int(new.opt.step) == 1
    assert not any(t.requires_grad for _, t in tree_paths(new.params))
    assert not torch.are_deterministic_algorithms_enabled()
    # on a mesh: the MoE, Mamba, RWKV and encoder families (step 10.2-10.4)
    # and the rule tables other than DEFAULT_RULES (10.5) still raise
    from repro_torch import configs
    from repro_torch.sharding import TRAIN_FSDP_SP_RULES, abstract_mesh

    mesh = abstract_mesh((1, 2), ("data", "model"))
    for arch in ("olmoe-1b-7b", "jamba-1.5-large-398b", "rwkv6-3b", "whisper-tiny"):
        with pytest.raises(NotImplementedError, match="step 10"):
            TS.make_train_step(configs.get_config(arch, reduced=True), tc, mesh=mesh)
    with pytest.raises(NotImplementedError, match="step 10"):
        TS.make_train_step(cfg, tc, mesh=mesh, rules=TRAIN_FSDP_SP_RULES)


# ---------------------------------------------------------------------------
# convert.py: train states across packages
# ---------------------------------------------------------------------------
def test_train_state_round_trip_through_the_reference():
    jcfg = JModelConfig(**TINY)
    jtc = JS.TrainConfig(loss_chunk=16)
    js = JS.init_train_state(jcfg, jtc, jax.random.PRNGKey(0))
    js, _ = jax.jit(JS.make_train_step(jcfg, jtc))(
        js, JD.synthetic_batch(JD.DataConfig(vocab=97, seq_len=16, global_batch=4), 0))
    arrays = (_np(js.params), np.asarray(js.opt.step), _np(js.opt.mu), _np(js.opt.nu))
    ts = convert.train_state_from_arrays(*arrays, device="cpu")
    assert isinstance(ts, TS.TrainState) and int(ts.opt.step) == 1
    back = convert.train_state_to_arrays(ts)
    assert back[1] == np.int32(1) and back[1].dtype == np.int32
    for got, want in ((back[0], arrays[0]), (back[2], arrays[2]), (back[3], arrays[3])):
        wp = _jpaths(want)
        gp = dict(tree_paths(got))
        assert set(gp) == set(wp)
        for path, a in gp.items():
            assert a.dtype == wp[path].dtype
            np.testing.assert_array_equal(a, wp[path])
    rebuilt = JS.TrainState(jx(back[0]), JA.OptState(jnp.int32(back[1]), jx(back[2]), jx(back[3])))
    assert jax.tree_util.tree_structure(rebuilt) == jax.tree_util.tree_structure(js)
    # the port continues training from the reference's state
    cfg = ModelConfig(**TINY)
    new, m = TS.make_train_step(cfg, TS.TrainConfig(loss_chunk=16))(
        ts, TD.synthetic_batch(TD.DataConfig(vocab=97, seq_len=16, global_batch=4), 1,
                               device="cpu"))
    assert int(new.opt.step) == 2 and np.isfinite(float(m["ce_loss"]))
