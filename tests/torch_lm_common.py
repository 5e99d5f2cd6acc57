"""Shared helpers of the LM port tests (``test_torch_lm_*.py``): parameters
drawn with numpy from a seed and handed to both packages, the JAX
reference compiled with XLA's excess precision off, and tolerances in
bfloat16 steps.

Why excess precision off: with its default ``xla_allow_excess_precision``
XLA's CPU compiler drops the bfloat16 rounding between a bfloat16 op and a
following cast to float32 inside a compiled program (``einsum(bf16,
bf16).astype(float32)`` comes out unrounded), so the reference's numbers
depend on what it fuses.  With the option off a compiled program rounds
where ``jnp`` says, as the reference run op by op does; that is the
semantics the port reproduces.  The reference's own code is unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.params import ParamDef

STRICT = {"xla_allow_excess_precision": False}
# One bfloat16 rounding moves a value by at most 2^-8 of its magnitude, so
# two roundings of nearly equal values that land on neighbouring bfloat16
# numbers (one ulp apart) differ by up to two such steps.
BF16_STEP = 2.0 ** -8


def np_params(defs, seed: int):
    """A parameter tree for ``defs`` (the JAX package's ParamDefs) drawn with
    numpy from ``seed``, with the reference's init rules: the same arrays
    in every interpreter run (the reference's ``init_params`` keys each
    leaf by ``hash()`` of its path, which changes between runs)."""
    rs = np.random.default_rng(seed)

    def one(d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
        if d.init == "embed":
            std = d.scale if d.scale is not None else 1.0
        return (rs.standard_normal(d.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map(one, defs, is_leaf=lambda x: isinstance(x, ParamDef))


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_np(x) -> np.ndarray:
    """float32 numpy of a JAX array or a torch tensor (bfloat16 exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16(a):
    """(JAX array, torch tensor) of the same bfloat16 values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def strict_jit(fn):
    """``jax.jit(fn)`` compiled with excess precision off, one executable
    per argument signature."""
    jitted = jax.jit(fn)
    cache = {}

    def call(*args):
        key = jax.tree_util.tree_structure(args), tuple(
            (np.shape(a), jnp.result_type(a)) for a in jax.tree_util.tree_leaves(args))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(compiler_options=STRICT)
        return cache[key](*args)

    return call


class StrictJax:
    """The ``jax`` module with :func:`strict_jit` as ``jit``: patched into
    ``repro.serve.lm`` so that the reference's ``generate`` runs as written,
    its steps compiled with excess precision off."""

    @staticmethod
    def jit(fn, **kw):
        assert not kw, kw
        return strict_jit(fn)

    def __getattr__(self, name):
        return getattr(jax, name)


def assert_bf16_close(got, want, steps: float, what: str):
    """|got − want| ≤ steps · 2^-8 · max|want|: ``steps`` bfloat16 roundings
    of the output's scale."""
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.all(np.isfinite(g)), what
    tol = steps * BF16_STEP * max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max()) if g.size else 0.0
    assert err <= tol, f"{what}: max |Δ| {err} > {tol} ({steps} bf16 steps of the scale)"


def batch_arrays(cfg, B: int, S: int, seed: int):
    """A numpy request batch for ``cfg``: tokens, and the frontend stubs'
    patches or frames where the arch has them."""
    rs = np.random.default_rng(seed)
    batch = {"tokens": rs.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = (rs.standard_normal((B, cfg.n_patches, cfg.d_model)) * 0.02
                            ).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = (rs.standard_normal((B, cfg.n_frames, cfg.d_model)) * 0.1
                           ).astype(np.float32)
    return batch


def port_cfg(cfg):
    """The port's ModelConfig with the same fields as a JAX one."""
    from repro_torch.models import ModelConfig

    return ModelConfig(**dataclasses.asdict(cfg))


def top2_margin(logits: np.ndarray) -> np.ndarray:
    """Top-1 minus top-2 logit along the last axis."""
    s = np.sort(logits, axis=-1)
    return s[..., -1] - s[..., -2]
