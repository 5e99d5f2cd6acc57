"""Test-session bootstrap.

Provides a minimal, dependency-free stand-in for ``hypothesis`` when the
real package is not installed (this container ships a pinned environment
with no network access).  The stub implements the tiny subset these tests
use — ``@given`` with ``integers`` / ``sampled_from`` / ``floats``
strategies and a no-op ``settings`` — by deterministic pseudo-random
example draws, so the property tests still execute many concrete examples
instead of being skipped wholesale.

If the real hypothesis is importable it is used untouched.
"""
from __future__ import annotations

import random
import sys
import types

_DEFAULT_EXAMPLES = 25


def _install_hypothesis_stub() -> None:
    try:
        import hypothesis  # noqa: F401

        return
    except ImportError:
        pass

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example(self, rng):
            return self._draw(rng)

    def integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def sampled_from(options):
        options = list(options)
        return _Strategy(lambda rng: options[rng.randrange(len(options))])

    def floats(min_value=0.0, max_value=1.0, allow_nan=False, allow_infinity=False,
               width=64):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    def just(value):
        return _Strategy(lambda rng: value)

    class settings:  # noqa: N801 - mimic hypothesis' decorator class
        def __init__(self, max_examples=_DEFAULT_EXAMPLES, deadline=None, **_kw):
            self.max_examples = max_examples

        def __call__(self, fn):
            fn._stub_max_examples = self.max_examples
            return fn

    def given(*strategies, **kw_strategies):
        def decorate(fn):
            # NOTE: no functools.wraps — pytest must see a zero-arg
            # signature, not the strategy parameters (they'd be treated
            # as fixtures).
            def wrapper(*args, **kwargs):
                max_examples = getattr(fn, "_stub_max_examples", _DEFAULT_EXAMPLES)
                # Cap the stub's example count: these are smoke-level draws,
                # the real hypothesis explores far more when available.
                n = min(max_examples, _DEFAULT_EXAMPLES)
                rng = random.Random(f"{fn.__module__}.{fn.__qualname__}")
                for i in range(n):
                    ex_args = tuple(s.example(rng) for s in strategies)
                    ex_kw = {k: s.example(rng) for k, s in kw_strategies.items()}
                    try:
                        fn(*args, *ex_args, **{**kwargs, **ex_kw})
                    except Exception as e:  # pragma: no cover - failure path
                        raise AssertionError(
                            f"stub-hypothesis falsifying example "
                            f"(draw {i}): args={ex_args} kwargs={ex_kw}"
                        ) from e

            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.hypothesis_stub = True
            return wrapper

        return decorate

    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = integers
    st_mod.sampled_from = sampled_from
    st_mod.floats = floats
    st_mod.booleans = booleans
    st_mod.just = just

    hyp_mod = types.ModuleType("hypothesis")
    hyp_mod.given = given
    hyp_mod.settings = settings
    hyp_mod.strategies = st_mod
    hyp_mod.__stub__ = True

    sys.modules["hypothesis"] = hyp_mod
    sys.modules["hypothesis.strategies"] = st_mod


_install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skipped on a host without one"
    )
