"""G-set benchmark instances and their generated twins (port of ``repro.core.gset``).

The paper evaluates on G11, G12, G13 (800 vertices, toroidal 4-regular,
±1 weights), King1 (800 vertices, king's graph, ±1) and K2000 (complete,
±1).  :func:`load` reads a real G-set file under ``data/gset/<name>`` when
one is present, and otherwise generates the twin from the same numpy seed
as the JAX package, so both packages see the same graph byte for byte.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .ising import MaxCutProblem

__all__ = [
    "load",
    "parse_gset_text",
    "toroidal_grid",
    "king_graph",
    "complete_graph",
    "GSET_DIR",
]

GSET_DIR = os.environ.get(
    "REPRO_GSET_DIR", os.path.join(os.path.dirname(__file__), "..", "..", "..", "data", "gset")
)

_BEST_KNOWN = {"G11": 564, "G12": 556, "G13": 582}


def parse_gset_text(text: str, name: str = "gset") -> MaxCutProblem:
    """Parse the standard G-set format: 'n m' header, then 'i j w' (1-indexed)."""
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    n, m = map(int, lines[0].split()[:2])
    edges = np.zeros((m, 2), dtype=np.int64)
    weights = np.zeros(m, dtype=np.int64)
    for k, ln in enumerate(lines[1 : m + 1]):
        i, j, w = map(int, ln.split()[:3])
        edges[k] = (i - 1, j - 1)
        weights[k] = w
    return MaxCutProblem(
        n=n, edges=edges, weights=weights, name=name, best_known=_BEST_KNOWN.get(name)
    )


def _torus_coords(n: int) -> Tuple[int, int]:
    """Pick a near-square (rows, cols) factorization for an n-vertex torus."""
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def toroidal_grid(n: int = 800, seed: int = 11, name: str = "toroidal") -> MaxCutProblem:
    """4-regular 2-D torus with ±1 uniform weights (G11/G12/G13 family)."""
    rows, cols = _torus_coords(n)
    rng = np.random.default_rng(seed)
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            edges.append((v, r * cols + (c + 1) % cols))          # right
            edges.append((v, ((r + 1) % rows) * cols + c))        # down
    edges = np.asarray(edges, dtype=np.int64)
    weights = rng.choice(np.array([-1, 1], dtype=np.int64), size=len(edges))
    return MaxCutProblem(n=n, edges=edges, weights=weights, name=name)


def king_graph(n: int = 800, seed: int = 1, name: str = "King1") -> MaxCutProblem:
    """8-neighbour king's graph on a torus, ±1 uniform weights (King1 family)."""
    rows, cols = _torus_coords(n)
    rng = np.random.default_rng(seed)
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            rn, cn = (r + 1) % rows, (c + 1) % cols
            cp = (c - 1) % cols
            edges.append((v, r * cols + cn))    # E
            edges.append((v, rn * cols + c))    # S
            edges.append((v, rn * cols + cn))   # SE
            edges.append((v, rn * cols + cp))   # SW
    edges = np.asarray(edges, dtype=np.int64)
    weights = rng.choice(np.array([-1, 1], dtype=np.int64), size=len(edges))
    return MaxCutProblem(n=n, edges=edges, weights=weights, name=name)


def complete_graph(n: int = 2000, seed: int = 2000, name: str = "K-like") -> MaxCutProblem:
    """Fully-connected ±1 instance (K2000 family)."""
    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(n, k=1)
    edges = np.stack([ii, jj], axis=1)
    weights = rng.choice(np.array([-1, 1], dtype=np.int64), size=len(edges))
    return MaxCutProblem(n=n, edges=edges, weights=weights, name=name)


_GENERATORS = {
    "G11": lambda: toroidal_grid(800, seed=11, name="G11-like"),
    "G12": lambda: toroidal_grid(800, seed=12, name="G12-like"),
    "G13": lambda: toroidal_grid(800, seed=13, name="G13-like"),
    "King1": lambda: king_graph(800, seed=1, name="King1"),
    "K2000": lambda: complete_graph(2000, seed=2000, name="K2000-like"),
    # Large-N G-set twins: the sparse backend runs them; a dense (N, N) J
    # would be 0.8–1.6 GB.
    "G77": lambda: toroidal_grid(14383, seed=77, name="G77-like"),
    "G81": lambda: toroidal_grid(20000, seed=81, name="G81-like"),
}


def load(name: str, gset_dir: Optional[str] = None) -> MaxCutProblem:
    """Load a benchmark instance: real file if available, else generated twin."""
    d = gset_dir or GSET_DIR
    path = os.path.join(d, name)
    if os.path.exists(path):
        with open(path) as f:
            return parse_gset_text(f.read(), name=name)
    if name in _GENERATORS:
        return _GENERATORS[name]()
    raise KeyError(f"unknown instance {name!r}; known: {sorted(_GENERATORS)}")
