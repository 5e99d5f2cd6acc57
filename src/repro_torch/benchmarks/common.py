"""The benchmarks' row format (the port's copy of the JAX repo's
``benchmarks.common.emit``): every benchmark prints ``name,us_per_call,derived``
rows, ``derived`` carrying the quantity the row is about."""
from __future__ import annotations


def emit(name: str, us_per_call: float, derived) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")
