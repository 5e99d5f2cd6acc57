"""The LM port's layers (``repro_torch.models``: layers, moe, mamba, rwkv,
params) against the JAX package's on the CPU, on the same numpy-drawn
inputs and parameters.

Tolerances are bfloat16 steps of the output's scale (2^-8 of max|ref|,
``assert_bf16_close``): the port rounds to bfloat16 where the reference
does, so what is left is float32 summation order (matmuls, means) and the
last ulp of a transcendental, each able to send one bfloat16 rounding to
the neighbouring value, one ulp = up to two steps away.  MoE routing on
the same float32 probabilities is compared exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_lm_common import (  # noqa: E402
    assert_bf16_close,
    bf16,
    jx,
    np_params,
    port_cfg,
    strict_jit,
    to_np,
)

from repro.configs import get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.sharding import DEFAULT_RULES as J_RULES  # noqa: E402
from repro_torch import convert, sharding  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402


def _both(defs, seed):
    """(JAX params, port params) of the same numpy draw."""
    arrays = np_params(defs, seed)
    return jx(arrays), convert.lm_params_from_arrays(arrays, "cpu")


def _cfgs(arch, **kw):
    cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    return cfg, port_cfg(cfg)


def _x(rs, shape, scale=1.0):
    return bf16(rs.standard_normal(shape) * scale)


# ---------------------------------------------------------------------------
# Norms, RoPE, activations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_norms_match_jax(kind, dtype):
    rs = np.random.default_rng(0)
    x = rs.standard_normal((3, 7, 48)) * 2 + 0.5
    p = {"scale": rs.standard_normal(48).astype(np.float32),
         "bias": rs.standard_normal(48).astype(np.float32)}
    if dtype == "bfloat16":
        xj, xt = bf16(x)
    else:
        xj, xt = jnp.asarray(x, jnp.float32), torch.tensor(x, dtype=torch.float32)
    want = JL.apply_norm(jx(p), xj, kind)
    got = TL.apply_norm(convert.lm_params_from_arrays(p), xt, kind)
    assert got.dtype == xt.dtype
    # bfloat16: one rounding of float32 results that agree to their last
    # bits, at most one ulp apart; float32: the mean's and rsqrt's last bits
    assert_bf16_close(got, want, 2, f"{kind} {dtype}")


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rs = np.random.default_rng(1)
    xj, xt = _x(rs, (2, 40, 4, 32), 3.0)
    pos = rs.integers(0, 200, (2, 40))
    want = JL.rope(xj, jnp.asarray(pos, jnp.int32), theta)
    got = TL.rope(xt, torch.tensor(pos), theta)
    # the angle pos·freq in float32: freq's and cos/sin's last ulps can send
    # the output's one bfloat16 rounding to the neighbouring value
    assert_bf16_close(got, want, 2, "rope")


@pytest.mark.parametrize("act", ["silu", "gelu", "sigmoid"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_activations_match_jax(act, dtype):
    """jax.nn's silu, gelu (tanh form) and sigmoid: bit-identical in
    bfloat16, where XLA rounds every op of the expansion as the port does;
    in float32 within the last ulps of exp and tanh (an absolute floor of
    1e-6 where gelu's terms cancel near 0)."""
    rs = np.random.default_rng(2)
    x = rs.standard_normal(20000) * 4
    if dtype == "bfloat16":
        xj, xt = bf16(x)
    else:
        xj, xt = jnp.asarray(x, jnp.float32), torch.tensor(x, dtype=torch.float32)
    jf = {"silu": jax.nn.silu, "gelu": jax.nn.gelu, "sigmoid": jax.nn.sigmoid}[act]
    tf = {"silu": TL.silu, "gelu": TL.gelu, "sigmoid": TL.logistic}[act]
    want, got = to_np(jf(xj)), to_np(tf(xt))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _plain_attention(q, k, v, causal):
    """Unchunked softmax attention with GQA, float32 throughout."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kk = k.float().repeat_interleave(G, dim=2)
    vv = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / np.sqrt(D)
    if causal:
        s = s.masked_fill(~torch.ones(S, k.shape[1], dtype=torch.bool).tril(), -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,q_chunk,kv_chunk", [(16, 4, 4), (16, 16, 8), (10, 4, 3), (7, 16, 16)])
def test_flash_matches_unchunked_softmax_and_jax(causal, S, q_chunk, kv_chunk):
    rs = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = (_x(rs, (2, S, 4, 16), 2.0), _x(rs, (2, S, 2, 16), 2.0),
                                    _x(rs, (2, S, 2, 16)))
    got = TL._flash(qt, kt, vt, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    # against the plain softmax: p·v takes p rounded to bfloat16 (as the
    # reference does), a relative error of up to 2^-8 per term, then the
    # bfloat16 output: two steps
    assert_bf16_close(got, _plain_attention(qt, kt, vt, causal), 2, "flash vs plain")
    want = JL._flash(qj, kj, vj, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                     mesh=None, rules=J_RULES)
    assert_bf16_close(got, want, 2, "flash vs jax")  # one rounding, one ulp


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-tiny", "olmoe-1b-7b"])
def test_attention_and_decode_match_jax(arch):
    """Full attention (qk-norm, RoPE, GQA where the arch has them), then one
    decode step into a cache of 12 positions, and whisper-style
    cross-attention decode."""
    cfg, tcfg = _cfgs(arch)
    pj, pt = _both(JL.attn_defs(cfg), 4)
    rs = np.random.default_rng(5)
    xj, xt = _x(rs, (2, 9, cfg.d_model))
    yj, cj = strict_jit(lambda p, x: JL.attention(p, x, cfg, q_chunk=4, kv_chunk=4))(pj, xj)
    yt, ct = TL.attention(pt, xt, tcfg, q_chunk=4, kv_chunk=4)
    assert_bf16_close(yt, yj, 2, "attention y")
    for n in ("k", "v"):
        assert_bf16_close(ct[n], cj[n], 2, f"attention cache {n}")

    pad = ((0, 0), (0, 3), (0, 0), (0, 0))
    cache_j = {n: jnp.pad(cj[n], pad) for n in ("k", "v")}
    cache_t = convert.lm_caches_from_arrays({n: to_np(cache_j[n]) for n in ("k", "v")})
    cache_t = {n: c.bfloat16() for n, c in cache_t.items()}
    dj, dt = _x(rs, (2, 1, cfg.d_model))
    for cross in (False, True):
        want, wc = strict_jit(lambda p, x, c: JL.attention_decode(
            p, x, c, jnp.int32(9), cfg, cross=cross))(pj, dj, cache_j)
        got, gc = TL.attention_decode(pt, dt, cache_t, 9, tcfg, cross=cross)
        assert_bf16_close(got, want, 2, f"attention_decode cross={cross}")
        for n in ("k", "v"):
            assert_bf16_close(gc[n], wc[n], 2, f"decode cache {n} cross={cross}")
        assert torch.equal(cache_t["k"][:, 9], torch.zeros_like(cache_t["k"][:, 9]))


def test_attention_decode_outside_the_cache_raises():
    cfg, tcfg = _cfgs("granite-3-8b")
    _, pt = _both(JL.attn_defs(cfg), 0)
    cache = {n: torch.zeros((1, 4, cfg.n_kv_heads, cfg.d_head), dtype=torch.bfloat16)
             for n in ("k", "v")}
    with pytest.raises(IndexError, match="outside a cache of 4"):
        TL.attention_decode(pt, torch.zeros((1, 1, cfg.d_model)), cache, 4, tcfg)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu_sq"])
def test_mlp_matches_jax(act):
    cfg, tcfg = _cfgs("granite-3-8b", act=act)
    pj, pt = _both(JL.mlp_defs(cfg), 6)
    xj, xt = _x(np.random.default_rng(7), (2, 11, cfg.d_model))
    want = strict_jit(lambda p, x: JL.mlp(p, x, cfg))(pj, xj)
    # two bfloat16 products and the activation's rounded ops: one step
    # of float32 summation order in each product
    assert_bf16_close(TL.mlp(pt, xt, tcfg), want, 2, f"mlp {act}")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _probs(rs, shape, ties=False):
    logits = rs.standard_normal(shape).astype(np.float32)
    if ties:  # exact ties: the first maximal index wins in both packages
        logits[..., 3] = logits[..., 1]
        logits[..., 5] = logits.max(-1)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("cap", [1, 3, 40])
@pytest.mark.parametrize("ties", [False, True])
def test_moe_routing_is_bit_identical(k, cap, ties):
    """_top_k_mask, _dispatch_combine and _dispatch_gather on the same
    float32 probabilities: the same experts, positions, keeps and gates,
    exactly (cap 1 and 3 drop tokens)."""
    probs = _probs(np.random.default_rng(10 * k + cap), (3, 20, 8), ties)
    pj, pt = jnp.asarray(probs), torch.from_numpy(probs)
    gj, ohj = JM._top_k_mask(pj, k)
    gt, oht = TM._top_k_mask(pt, k)
    np.testing.assert_array_equal(to_np(gt), to_np(gj))
    np.testing.assert_array_equal(to_np(oht), to_np(ohj))
    cj, aj = JM._dispatch_combine(pj, k, cap)
    ct, at = TM._dispatch_combine(pt, k, cap)
    np.testing.assert_array_equal(to_np(ct), to_np(cj))
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)  # float32 means
    want = JM._dispatch_gather(pj, k, cap)
    got = TM._dispatch_gather(pt, k, cap)
    for name, g, w in zip(("e_idx", "pos", "gates", "keep"), got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-6)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch,S", [("olmoe-1b-7b", 1), ("olmoe-1b-7b", 16),
                                    ("moonshot-v1-16b-a3b", 32), ("jamba-1.5-large-398b", 48)])
def test_moe_ffn_matches_jax(impl, arch, S):
    """S = 1 folds the batch into one token group (decode); S = 32 and 48
    with seq_chunk 16 run two and three groups, a capacity per group."""
    cfg, tcfg = _cfgs(arch, moe_impl=impl)
    pj, pt = _both(JM.moe_defs(cfg), 11)
    xj, xt = _x(np.random.default_rng(12), (3, S, cfg.d_model))
    yj, aj = strict_jit(lambda p, x: JM.moe_ffn(p, x, cfg, seq_chunk=16))(pj, xj)
    yt, at = TM.moe_ffn(pt, xt, tcfg, seq_chunk=16)
    # routing equal (float32 router logits agree to their last bits; no
    # near-tie at these draws flips an expert), then the expert MLP's
    # bfloat16 products and the gate-weighted sum: two steps
    assert_bf16_close(yt, yj, 2, f"moe_ffn {impl}")
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


def test_moe_impls_agree_in_the_port():
    cfg, tcfg = _cfgs("olmoe-1b-7b")
    _, pt = _both(JM.moe_defs(cfg), 13)
    x = _x(np.random.default_rng(14), (2, 16, cfg.d_model))[1]
    ye, ae = TM.moe_ffn(pt, x, tcfg)
    yg, ag = TM.moe_ffn(pt, x, dataclasses.replace(tcfg, moe_impl="gather"))
    assert float(ae) == float(ag)
    # the einsum form sums the k gated outputs in its product, the gather
    # form rounds each gated output to bfloat16 first: one ulp apart
    assert_bf16_close(yg, ye, 2, "gather vs einsum")


# ---------------------------------------------------------------------------
# Mamba, RWKV
# ---------------------------------------------------------------------------
def _mamba_params(cfg, seed):
    arrays = np_params(JMB.mamba_defs(cfg), seed)
    # a spread of decays (the init's a_log = 0 gives every channel A = -1)
    arrays["a_log"] = (np.random.default_rng(seed).standard_normal(arrays["a_log"].shape)
                       * 0.5).astype(np.float32)
    return jx(arrays), convert.lm_params_from_arrays(arrays)


def test_mamba_and_decode_match_jax():
    cfg, tcfg = _cfgs("jamba-1.5-large-398b")
    pj, pt = _mamba_params(cfg, 15)
    rs = np.random.default_rng(16)
    xj, xt = _x(rs, (2, 9, cfg.d_model))
    yj, cj = strict_jit(lambda p, x: JMB.mamba(p, x, cfg))(pj, xj)
    yt, ct = TMB.mamba(pt, xt, tcfg)
    # bfloat16 projections around a float32 recurrence; the float32 state
    # agrees to float32 summation order
    assert_bf16_close(yt, yj, 2, "mamba y")
    assert_bf16_close(ct["conv"], cj["conv"], 0, "mamba conv cache")
    np.testing.assert_allclose(to_np(ct["ssm"]), to_np(cj["ssm"]), rtol=1e-4, atol=1e-4)
    dj, dt = _x(rs, (2, 1, cfg.d_model))
    for _ in range(2):
        yj, cj = strict_jit(lambda p, x, c: JMB.mamba_decode(p, x, c, cfg))(pj, dj, cj)
        yt, ct = TMB.mamba_decode(pt, dt, ct, tcfg)
        assert_bf16_close(yt, yj, 2, "mamba_decode y")
        np.testing.assert_allclose(to_np(ct["ssm"]), to_np(cj["ssm"]), rtol=1e-4, atol=1e-4)
    init = TMB.mamba_init_cache(tcfg, 3)
    ref = JMB.mamba_init_cache(cfg, 3)
    assert {n: tuple(t.shape) for n, t in init.items()} == {n: r.shape for n, r in ref.items()}


def test_rwkv_time_and_channel_mix_match_jax():
    cfg, tcfg = _cfgs("rwkv6-3b")
    arrays = np_params({"t": JR.rwkv_defs(cfg), "c": JR.rwkv_channel_defs(cfg)}, 17)
    rs = np.random.default_rng(18)
    # data-dependent decay and bonus away from the init's constants
    arrays["t"]["w0"] = (rs.standard_normal(arrays["t"]["w0"].shape) * 0.5).astype(np.float32)
    arrays["t"]["u_bonus"] = rs.standard_normal(arrays["t"]["u_bonus"].shape).astype(np.float32)
    pj, pt = jx(arrays), convert.lm_params_from_arrays(arrays)
    xj, xt = _x(rs, (2, 9, cfg.d_model))
    yj, cj = strict_jit(lambda p, x: JR.rwkv_time_mix(p, x, cfg))(pj["t"], xj)
    yt, ct = TR.rwkv_time_mix(pt["t"], xt, tcfg)
    assert_bf16_close(yt, yj, 2, "time mix y")
    np.testing.assert_allclose(to_np(ct["wkv"]), to_np(cj["wkv"]), rtol=1e-4, atol=1e-5)
    assert_bf16_close(ct["shift"], cj["shift"], 0, "time mix shift")
    zj, zc = strict_jit(lambda p, x: JR.rwkv_channel_mix(p, x, cfg))(pj["c"], xj)
    zt, zct = TR.rwkv_channel_mix(pt["c"], xt, tcfg)
    assert_bf16_close(zt, zj, 2, "channel mix y")
    dj, dt = _x(rs, (2, 1, cfg.d_model))
    yj, cj = strict_jit(lambda p, x, c: JR.rwkv_time_mix_decode(p, x, c, cfg))(pj["t"], dj, cj)
    yt, ct = TR.rwkv_time_mix_decode(pt["t"], dt, ct, tcfg)
    assert_bf16_close(yt, yj, 2, "time mix decode y")
    np.testing.assert_allclose(to_np(ct["wkv"]), to_np(cj["wkv"]), rtol=1e-4, atol=1e-5)
    zj, _ = strict_jit(lambda p, x, c: JR.rwkv_channel_mix_decode(p, x, c, cfg))(pj["c"], dj, zc)
    zt, _ = TR.rwkv_channel_mix_decode(pt["c"], dt, zct, tcfg)
    assert_bf16_close(zt, zj, 2, "channel mix decode y")
    init = TR.rwkv_init_cache(tcfg, 2)
    ref = JR.rwkv_init_cache(cfg, 2)
    assert jax.tree_util.tree_map(lambda r: r.shape, ref) == TP.tree_map(
        lambda t: tuple(t.shape), init)


# ---------------------------------------------------------------------------
# Parameters and sharding rules
# ---------------------------------------------------------------------------
def test_init_params_is_deterministic_per_seed_and_path():
    from repro_torch.models import model_defs

    tcfg = port_cfg(get_config("olmoe-1b-7b", reduced=True))
    defs = model_defs(tcfg)
    a = TP.init_params(defs, 3, "cpu")
    b = TP.init_params(defs, 3, "cpu")
    c = TP.init_params(defs, 4, "cpu")
    paths = [p for p, _ in TP.tree_paths(defs)]
    for (path, x), (_, y), (_, z), (_, d) in zip(TP.tree_paths(a), TP.tree_paths(b),
                                                 TP.tree_paths(c), TP.tree_paths(defs)):
        assert tuple(x.shape) == d.shape and x.dtype == d.dtype
        assert torch.equal(x, y), path
        if d.init == "zeros":
            assert not x.any()
        elif d.init == "ones":
            assert bool((x == 1).all())
        else:
            assert not torch.equal(x, z), path
            std = d.scale if d.scale is not None else (
                1.0 if d.init == "embed" else 1 / np.sqrt(d.shape[-2] if len(d.shape) > 1
                                                          else d.shape[-1]))
            if x.numel() >= 4096:  # the sample std within 10% of the rule's
                assert abs(float(x.std()) / std - 1) < 0.1, path
    # leaves of equal shape draw different numbers (seeded by their paths)
    wq = a["decoder"]["l0"]["mixer"]["wq"]
    assert not torch.equal(wq, a["decoder"]["l0"]["mixer"]["wo"].reshape(wq.shape))
    assert len(set(paths)) == len(paths)


def test_param_shapes_are_meta_tensors():
    from repro_torch.configs import get_config as port_config
    from repro_torch.models import model_defs

    shapes = TP.param_shapes(model_defs(port_config("qwen3-1.7b")))
    leaves = [t for _, t in TP.tree_paths(shapes)]
    assert all(t.device.type == "meta" for t in leaves)
    # qwen3-1.7b at full width: 2,031,739,904 float32 parameters
    assert sum(t.numel() for t in leaves) == 2_031_739_904


def test_sharding_rules_mirror_jax_and_a_mesh_raises():
    assert sharding.DEFAULT_RULES.rules == J_RULES.rules
    r = sharding.DEFAULT_RULES.replace(seq="model", d_model=("data",))
    jr = J_RULES.replace(seq="model", d_model=("data",))
    assert r.rules == jr.rules and r.lookup("seq") == "model" and r.lookup(None) is None
    x = torch.ones(2)
    assert sharding.constrain(x, None, ("batch",)) is x
    # On a mesh constrain moves nothing (the per-rank program places its
    # blocks itself); the paths still unported raise citing step 10: rule
    # tables other than DEFAULT_RULES, and the MoE, Mamba and RWKV layers.
    mesh = sharding.abstract_mesh((1, 2), ("data", "model"))
    assert sharding.constrain(x, mesh, ("batch",)) is x
    with pytest.raises(NotImplementedError, match="step 10"):
        sharding.constrain(x, mesh, ("batch",), sharding.TRAIN_FSDP_SP_RULES)
    cfg, tcfg = _cfgs("granite-3-8b")
    _, pt = _both(JL.mlp_defs(cfg), 0)
    with pytest.raises(NotImplementedError, match="step 10"):
        TL.mlp(pt, torch.zeros((1, 2, cfg.d_model)), tcfg, mesh=mesh,
               rules=sharding.SERVE_WEIGHT_STATIONARY_RULES)
    for arch, fn, defs, args in [
            ("olmoe-1b-7b", TM.moe_ffn, JM.moe_defs, ()),
            ("jamba-1.5-large-398b", TMB.mamba, JMB.mamba_defs, ()),
            ("rwkv6-3b", TR.rwkv_time_mix, JR.rwkv_defs, ()),
            ("rwkv6-3b", TR.rwkv_channel_mix, JR.rwkv_channel_defs, ())]:
        cfg, tcfg = _cfgs(arch)
        _, pt = _both(defs(cfg), 0)
        with pytest.raises(NotImplementedError, match="step 10"):
            fn(pt, torch.zeros((1, 2, cfg.d_model)), tcfg, *args, mesh=mesh)
