"""The port's threefry noise against ``jax.random``, and ``anneal()``'s
default noise against the JAX package's.

``repro_torch.core.rng`` reproduces ``jax.random`` as the installed jax
runs it (partitionable threefry, 64-bit types off): keys, splits and ±1
draws must be bit-identical over a chain of splits, for seeds below and
above 2^31 and 2^32 and a negative one.  ``anneal()`` without a config
runs threefry in both packages, so its results must be bit-identical too
(``energy_mean`` at rtol 1e-6, as in ``tests/test_torch_anneal.py``: an f32
mean whose summation order differs between the frameworks).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import gset as jgset  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.core import ssa as jssa  # noqa: E402
from repro_torch.core import gset, rng  # noqa: E402
from repro_torch.core import ssa as tssa  # noqa: E402

SEEDS = [0, 42, 2**31 + 5, 2**32 + 7, -3]


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("shape", [(3, 37), (8, 800), (100, 2000)], ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_chain_matches_jax_random(seed, shape):
    jkey, key = jax.random.PRNGKey(seed), rng.threefry_key(seed)
    assert key == _key(jkey)
    for _ in range(5):
        jkey, jsub = jax.random.split(jkey)
        key, sub = rng.threefry_split(key)
        assert (key, sub) == (_key(jkey), _key(jsub))
        got = rng.threefry_noise(sub, shape)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(jrng.threefry_noise(jsub, shape)))


@pytest.mark.parametrize("chunk", [1 << 22, 700], ids=["one-pass", "chunked"])
def test_threefry_noise_cycles_matches_split_chain(monkeypatch, chunk):
    monkeypatch.setattr(rng, "_DRAW_CHUNK", chunk)
    shape, c = (7, 97), 6
    jkey, want = jax.random.PRNGKey(11), []
    for _ in range(c):
        jkey, jsub = jax.random.split(jkey)
        want.append(np.asarray(jrng.threefry_noise(jsub, shape)))
    key, got = rng.threefry_noise_cycles(rng.threefry_key(11), c, shape)
    assert key == _key(jkey)
    assert got.dtype == torch.int8 and tuple(got.shape) == (c,) + shape
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_threefry2x32_on_words_matches_scalars():
    k0, k1 = 0x12345678, 0x9ABCDEF0
    x1 = torch.tensor([0, 1, 2**32 - 1], dtype=torch.int64)
    b0, b1 = rng.threefry2x32(k0, k1, torch.zeros_like(x1), x1)
    for i, x in enumerate(x1.tolist()):
        assert (int(b0[i]), int(b1[i])) == rng.threefry2x32(k0, k1, 0, x)


@pytest.mark.parametrize("name", ["G11", "K2000"])
def test_default_noise_matches_jax_anneal(name):
    """Without a config both packages run threefry on the sparse backend."""
    kw = dict(n_trials=4, m_shot=1, tau=3, i0_max=4)
    want = jssa.anneal(jgset.load(name), jssa.SSAHyperParams(**kw), seed=7)
    got = tssa.anneal(gset.load(name), tssa.SSAHyperParams(**kw), seed=7, device="cpu")
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)
    np.testing.assert_array_equal(got.best_cut, want.best_cut)
    np.testing.assert_array_equal(got.energy_min, want.energy_min)
    np.testing.assert_allclose(got.energy_mean, want.energy_mean, rtol=1e-6, atol=0)


def test_launcher_threefry_matches_jax_launcher(capsys, monkeypatch):
    from repro.launch import anneal as jlauncher
    from repro_torch.launch import anneal as launcher

    flags = ["--problem", "G11", "--trials", "3", "--m-shot", "1", "--tau", "4",
             "--i0-max", "4", "--noise", "threefry", "--seed", "5"]
    pattern = re.compile(r"best cut \S+  avg \S+  best energy \S+")
    monkeypatch.setattr("sys.argv", ["anneal"] + flags + ["--backend", "pallas"])
    jlauncher.main()
    want = pattern.search(capsys.readouterr().out).group(0)
    for mode in ("auto", "pregen"):
        launcher.main(flags + ["--backend", "cuda", "--device", "cpu", "--noise-mode", mode])
        out = capsys.readouterr().out
        assert "noise=threefry" in out
        assert pattern.search(out).group(0) == want
