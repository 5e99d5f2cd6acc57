"""The LM port's serving path (``repro_torch.serve.lm``) against the JAX
package's ``repro.serve.lm`` on the CPU: greedy ``generate`` for the four
architectures of ``tests/test_serve.py``, the temperature sampler bit for
bit against ``jax.random.categorical``, and the port's greedy decode
against its own teacher-forced forward; and the ``serve_lm`` example.

The reference's ``generate`` runs as written, its jitted steps compiled
with XLA's excess precision off (``StrictJax``; see torch_lm_common).
Tokens are compared exactly: two runs agree at every step up to a row's
first difference, which may come only where the top-2 logit margin is
within the logits' tolerance, 4 bfloat16 steps of their scale (8 for
jamba), the model tests' (test_torch_lm_models.py): a near tie may go
either way.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_lm_common import (  # noqa: E402
    BF16_STEP,
    StrictJax,
    batch_arrays,
    jx,
    np_params,
    top2_margin,
)

import repro.serve.lm as jlm  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import model_defs as j_defs  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.models import forward, model_defs  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.transformer import lm_head_logits  # noqa: E402
from repro_torch.serve import lm  # noqa: E402

SERVE_ARCHS = ["granite-3-8b", "olmoe-1b-7b", "rwkv6-3b", "jamba-1.5-large-398b"]
B, S, N_NEW, MAX_SEQ = 2, 8, 6, 24


@pytest.fixture
def strict_reference(monkeypatch):
    monkeypatch.setattr(jlm, "jax", StrictJax())


def _case(arch, seed=0):
    cfg = JC.get_config(arch, reduced=True)
    arrays = np_params(j_defs(cfg), seed)
    return (cfg, TC.get_config(arch, reduced=True), jx(arrays),
            convert.lm_params_from_arrays(arrays, "cpu"), batch_arrays(cfg, B, S, 1))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _tol(arch, logits):
    return (8 if arch.startswith("jamba") else 4) * BF16_STEP * float(np.abs(logits).max())


def _teacher_forced(tp, tcfg, batch, out):
    """The port's logits over prompt + generated tokens, one full forward."""
    toks = np.concatenate([batch["tokens"], out], axis=1)
    h, _ = forward(tp, dict(_tb(batch), tokens=torch.from_numpy(toks)), tcfg)
    return lm_head_logits(tp, h, tcfg).numpy()


def _assert_tokens_agree(got, want, logits, tol, what):
    """Equal tokens at every step up to a row's first difference, and a
    difference only where the top-2 margin of ``logits`` (the teacher-forced
    logits over prompt + ``got``, (B, S + n, V)) at that step is at most
    ``tol``: both runs had the same inputs up to there, and a near tie may
    go either way."""
    n = got.shape[1]
    margins = top2_margin(logits[:, S - 1: S - 1 + n])
    compared = 0
    for b in range(got.shape[0]):
        for i in range(n):
            if got[b, i] != want[b, i]:
                assert margins[b, i] <= tol, (
                    f"{what}: row {b} step {i}: {got[b].tolist()} != {want[b].tolist()} at a "
                    f"margin {margins[b, i]} > {tol}")
                break
            compared += 1
    assert compared >= got.size // 2, f"{what}: the runs part after {compared} tokens"


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_greedy_generate_matches_jax(arch, strict_reference):
    cfg, tcfg, p, tp, batch = _case(arch)
    sc = jlm.ServeConfig(max_seq=MAX_SEQ)
    want = jlm.generate(p, jx(batch), cfg, sc, n_new_tokens=N_NEW, seed=0)
    got = lm.generate(tp, batch, tcfg, lm.ServeConfig(max_seq=MAX_SEQ), N_NEW, device="cpu")
    assert got.shape == (B, N_NEW) and got.dtype == np.int32
    logits = _teacher_forced(tp, tcfg, batch, got)
    _assert_tokens_agree(got, np.asarray(want), logits, _tol(arch, logits), arch)
    # greedy is deterministic
    again = lm.generate(tp, batch, tcfg, lm.ServeConfig(max_seq=MAX_SEQ), N_NEW, device="cpu")
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-1.7b", "rwkv6-3b", "whisper-tiny",
                                  "phi-3-vision-4.2b"])
def test_greedy_decode_matches_its_teacher_forced_forward(arch):
    """Each greedy token is the argmax of the teacher-forced forward over
    prompt + output at its position, wherever the margin there exceeds the
    tolerance (the KV/SSM cache path against the full-sequence path).  The
    MoE archs are left out: their expert capacity grows with the token
    group (the prompt, the prompt + output, the batch at decode), so which
    tokens are dropped differs between the two paths by design, in the
    reference as here."""
    _, tcfg, _, tp, batch = _case(arch)
    batch = batch_arrays(tcfg, B, 7 if tcfg.encoder_layers else S, 1)
    n = 4
    out = lm.generate(tp, batch, tcfg, lm.ServeConfig(max_seq=16), n, device="cpu")
    s = batch["tokens"].shape[1]
    logits = _teacher_forced(tp, tcfg, batch, out)
    pred = logits[:, s - 1: s - 1 + n].argmax(-1)
    margins = top2_margin(logits[:, s - 1: s - 1 + n])
    tol = _tol(arch, logits)
    clear = margins > tol
    assert clear.any(), arch
    np.testing.assert_array_equal(out[clear], pred[clear], err_msg=arch)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sampler_is_bit_identical_to_jax_categorical(temperature):
    """On the same float32 logits and key chain the port's gumbel draws equal
    jax.random.gumbel's bit for bit and its tokens equal
    jax.random.categorical's, at every step of the chain."""
    logits = (np.random.default_rng(5).standard_normal((4, 1000)) * 3).astype(np.float32)
    key_j, key_t = jax.random.PRNGKey(7), rng.PRNGKey(7)
    for _ in range(8):
        key_j, kj = jax.random.split(key_j)
        key_t, kt = rng.split(key_t)
        assert tuple(int(w) for w in np.asarray(kj)) == kt
        want = np.asarray(jax.random.gumbel(kj, logits.shape, jnp.float32))
        np.testing.assert_array_equal(lm._gumbel(kt, logits.shape, "cpu").numpy(), want)
        tok_j = jlm._sample(jnp.asarray(logits), kj, temperature)
        tok_t = lm._sample(torch.from_numpy(logits), kt, temperature)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    greedy = lm._sample(torch.from_numpy(logits), kt, 0.0).numpy()
    np.testing.assert_array_equal(greedy, np.asarray(jlm._sample(jnp.asarray(logits), kj, 0.0)))


def test_temperature_generate_matches_jax(strict_reference):
    """generate at temperature 1.0 draws the reference's tokens: the same
    key chain, gumbel noise and (to their last bits) logits."""
    cfg, tcfg, p, tp, batch = _case("granite-3-8b")
    want = jlm.generate(p, jx(batch), cfg, jlm.ServeConfig(max_seq=MAX_SEQ, temperature=1.0),
                        n_new_tokens=N_NEW, seed=3)
    got = lm.generate(tp, batch, tcfg, lm.ServeConfig(max_seq=MAX_SEQ, temperature=1.0),
                      N_NEW, seed=3, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_temperature_sampling_varies_with_the_seed():
    _, tcfg, _, tp, batch = _case("granite-3-8b")
    sc = lm.ServeConfig(max_seq=MAX_SEQ, temperature=1.0)
    outs = {tuple(lm.generate(tp, batch, tcfg, sc, N_NEW, seed=s, device="cpu")[0])
            for s in range(4)}
    assert len(outs) > 1
    assert all(0 <= t < tcfg.vocab for o in outs for t in o)


def test_generate_checks_max_seq_and_device():
    _, tcfg, _, tp, batch = _case("granite-3-8b")
    with pytest.raises(ValueError, match="exceed max_seq 10"):
        lm.generate(tp, batch, tcfg, lm.ServeConfig(max_seq=10), 3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm.generate(tp, batch, tcfg, lm.ServeConfig(max_seq=MAX_SEQ), 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(model_defs(tcfg), 0)


def test_serve_lm_example_runs_on_the_cpu(capsys):
    serve_lm.main(["--arch", "olmoe-1b-7b", "--batch", "2", "--prompt-len", "8",
                   "--new-tokens", "5", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=olmoe-reduced batch=2"
    rows = [json.loads(line.split(": ", 1)[1]) for line in out[1:]]
    assert len(rows) == 2 and all(len(r) == 5 for r in rows)
