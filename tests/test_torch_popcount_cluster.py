"""K2 (``ssa_plateau_popcount_batched``) as thread-block clusters: the choice
of the cluster size, the choice of the block variant (what a block keeps in
shared memory), and the forced ``cluster_size=``.

``popcount_cluster_size`` and ``popcount_variant`` are pure Python: the
occupancy query, the residency of a size and a block's bytes come in as
functions (on the card, the kernel's own entries), so their rules are held
here on the CPU; a forced size is checked on every device and leaves the
result equal to the Pallas kernel's (interpret mode).  The block sizes of
the kernel's layout and the CUDA kernels, at every size the rule can
return and on every variant, are held by ``tests/test_torch_cuda.py`` on
the card.
"""
import itertools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import rng as jrng  # noqa: E402
from repro.kernels import bitplane as jbitplane  # noqa: E402
from repro.kernels import ssa_update as jssa  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import _build, ssa_update  # noqa: E402
from repro_torch.kernels.bitplane import packed_words  # noqa: E402
from repro_torch.kernels.ssa_update import popcount_cluster_size  # noqa: E402

H100_SMS = 132
OUTS = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")
K2_ORDER = ("m_packed", "itanh", "sign", "mags", "base", "h", "rng", "i0_sched",
            "fold_sched", "best_H", "best_m_packed")

# (R, B, N, SMs, n_replicas): classical groups and rings of every width the
# ring mode takes.
GRID = [(r, b, n, sms, nr) for r, b, n, sms in itertools.product(
            (1, 3, 8, 13, 96, 100, 128), (1, 2, 3), (16, 37, 100, 800, 2000, 4100), (16, 66, 132))
        for nr in (0, 1, 2, 8, 16, 32) if nr == 0 or r % nr == 0]


def _occupancy(sms, max_cs):
    """A card's occupancy query that runs clusters of up to ``max_cs``
    blocks, as many as its ``sms`` SMs hold, and no larger ones."""
    return lambda cs: sms // cs if cs <= max_cs else 0


def _units(r, nr):
    return r // nr if nr else ssa_update.plateau_groups(r)


@pytest.mark.parametrize("max_cs", [8, 16])
def test_popcount_cluster_size_respects_units_words_and_occupancy(max_cs):
    """Groups × B in the classical mode, rings × B in the ring mode: the
    largest size with every block on an SM, at most Nw, that the card runs
    at once."""
    allowed = (1, 2, 4, 8, 16)[:4 + (max_cs == 16)]
    for r, b, n, sms, nr in GRID:
        units = _units(r, nr) * b
        cs = popcount_cluster_size(r, b, n, sms, _occupancy(sms, max_cs), nr)
        assert cs in allowed, (r, b, n, sms, nr, cs)
        assert cs <= packed_words(n), (r, b, n, sms, nr, cs)
        assert cs == 1 or units * cs <= sms, (r, b, n, sms, nr, cs)
        bigger = [c for c in allowed if c > cs]
        assert all(units * c > sms or c > packed_words(n) for c in bigger)


def test_popcount_cluster_size_is_the_one_rule():
    """The classical mode sizes as K1's classical kernel and K4 do (groups of
    PLATEAU_GROUP), the ring mode as K1's ring mode (one cluster per ring)."""
    for r, b, n, sms, nr in GRID:
        occ = _occupancy(sms, 16)
        if nr:
            want = ssa_update.ring_cluster_size(r // nr, b, n, sms, occ)
        else:
            want = ssa_update.plateau_cluster_size(r, b, n, sms, occ)
        assert popcount_cluster_size(r, b, n, sms, occ, nr) == want


@pytest.mark.parametrize("r,b,n,nr,max_cs,want", [
    (100, 1, 2000, 0, 16, 8),   # K2000's 100 trials: 13 groups, 104 blocks
    (100, 1, 2000, 0, 8, 8),
    (100, 1, 800, 0, 16, 8),    # G11: 13 groups of 25 words
    (96, 1, 2000, 8, 16, 8),    # SSQA: 96 trials in rings of 8, 96 blocks
    (96, 1, 2000, 16, 16, 16),  # rings of 16: 6 clusters of 16
    (16, 1, 2000, 16, 16, 16),  # autotune's K2000 choice: one ring of 16
    (16, 1, 2000, 16, 8, 8),    # ... on a card without the non-portable 16
    (96, 1, 2000, 2, 16, 2),    # 48 rings of 2
    (100, 2, 2000, 0, 16, 4),   # B = 2: 26 groups
    (3, 1, 2000, 0, 16, 16),    # below one group: one ragged cluster
    (3, 1, 40, 0, 16, 2),       # two words: two blocks at most
    (8, 1, 16, 8, 16, 1),       # one word
    (1000, 1, 2000, 0, 16, 1),  # 125 groups fill the card alone
])
def test_popcount_cluster_size_examples(r, b, n, nr, max_cs, want):
    assert popcount_cluster_size(r, b, n, H100_SMS, _occupancy(H100_SMS, max_cs), nr) == want
    if max_cs == 16:  # no occupancy query: only the SM and word counts limit it
        assert popcount_cluster_size(r, b, n, H100_SMS, n_replicas=nr) == want


def test_popcount_cluster_size_waits_for_no_second_wave():
    """A size whose clusters do not all run at once is passed over for the
    next smaller one that does."""
    fits = {16: 0, 8: 12, 4: 33, 2: 66, 1: 132}.__getitem__
    assert popcount_cluster_size(100, 1, 2000, H100_SMS, fits) == 4  # 13 groups
    assert popcount_cluster_size(96, 1, 2000, H100_SMS, fits, 8) == 8  # 12 rings
    assert popcount_cluster_size(16, 1, 2000, H100_SMS, fits, 16) == 8  # 16 does not fit


# (R, B, N, n_replicas, smallest resident size, want): the sizes the
# kernel's layout holds resident on an H100 at nb = 1 (K2000: 8 and 16 for
# groups and rings of up to 8, 16 for rings of 16 and 32; G11: 2 and up).
@pytest.mark.parametrize("r,b,n,nr,res_from,want", [
    (100, 1, 2000, 0, 8, 8),     # K2000: 13 groups of 8 in one wave
    (100, 2, 2000, 0, 8, 8),     # 26 groups: two waves of 8, not 4 streamed
    (100, 4, 2000, 0, 8, 8),     # 52 groups: four waves of 8, not 2 streamed
    (1000, 1, 2000, 0, 8, 8),    # 125 groups
    (96, 1, 2000, 8, 8, 8),      # SSQA: 12 rings of 8
    (96, 1, 2000, 16, 16, 16),   # 6 rings of 16
    (16, 1, 2000, 16, 16, 16),   # autotune's one ring of 16
    (32, 1, 2000, 32, 16, 16),   # one ring of 32
    (96, 1, 2000, 2, 8, 8),      # 48 rings of 2: three waves of 8
    (100, 1, 800, 0, 2, 8),      # G11
    (100, 4, 800, 0, 2, 2),      # G11, 52 groups: 2 in one wave
    (13, 1, 4100, 0, None, 16),  # nothing resident: the one-wave rule
    (100, 2, 2000, 0, None, 4),
])
def test_popcount_cluster_size_prefers_resident_sizes(r, b, n, nr, res_from, want):
    """Sizes whose blocks are resident come first: the largest of them in
    one wave, else the smallest (the fewest waves); where none is, the
    one-wave rule."""
    resident = (lambda cs: False) if res_from is None else (lambda cs: cs >= res_from)
    occ = _occupancy(H100_SMS, 16)
    assert popcount_cluster_size(r, b, n, H100_SMS, occ, nr, resident) == want


def test_popcount_cluster_size_skips_resident_sizes_the_card_cannot_run():
    """A resident size with no cluster on the card (the occupancy query says
    0) is never chosen."""
    fits = {16: 0, 8: 0, 4: 33, 2: 66, 1: 132}.__getitem__
    assert popcount_cluster_size(100, 2, 2000, H100_SMS, fits, 0, lambda cs: cs >= 8) == 4
    assert popcount_cluster_size(100, 2, 2000, H100_SMS, fits, 0, lambda cs: cs >= 4) == 4
    assert popcount_cluster_size(100, 4, 2000, H100_SMS, fits, 0, lambda cs: cs >= 4) == 4


FIXED = 13568  # the fixed part of a block at K2000, bytes (no variant is smaller)


@pytest.mark.parametrize("resident,streamed,want", [
    (187840, 17920, "resident"),               # K2000 in clusters of 8
    (300000, 17920, "streamed"),               # ... of 4
    (ssa_update._MAX_SMEM, 17920, "resident"),  # exactly full
    (ssa_update._MAX_SMEM + 1, ssa_update._MAX_SMEM, "streamed"),
    (10**9, ssa_update._MAX_SMEM + 1, "global"),  # the words alone do not fit
    (10**10, 10**9, "global"),                 # far beyond any shared memory
])
def test_popcount_variant_takes_the_first_that_fits(resident, streamed, want):
    sizes = dict(resident=resident, streamed=streamed, **{"global": FIXED})
    assert ssa_update.popcount_variant(sizes.__getitem__) == want


def test_popcount_variant_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="no K2 block variant"):
        ssa_update.popcount_variant(lambda v: ssa_update._MAX_SMEM + 1)


def test_popcount_variants_follow_the_kernels_order():
    """The wrapper passes a variant to the kernel as its index: the names'
    order is that of csrc/popcount.cu's Variant."""
    text = (_build.CSRC / "popcount.cu").read_text()
    enum = re.search(r"enum Variant : int \{(.*?)\};", text, re.S).group(1)
    values = dict(re.findall(r"^\s*(\w+) = (\d+),", enum, re.M))
    assert [values[v.upper()] for v in ssa_update.POPCOUNT_VARIANTS] == ["0", "1", "2"]


def _chain_case(b, r, n, c, seed):
    rs = np.random.default_rng(seed)
    pjs = []
    for _ in range(b):
        J = np.triu(rs.integers(-3, 4, size=(n, n)), 1)
        pjs.append(jbitplane.pack_couplings((J + J.T).astype(np.float32), 2))
    case = dict(
        m_packed=np.asarray(jbitplane.pack_spins(jnp.asarray(rs.choice([-1, 1], (b, r, n))))),
        itanh=rs.integers(-6, 6, (b, r, n)).astype(np.int32),
        sign=np.stack([np.asarray(p.sign) for p in pjs]),
        mags=np.stack([np.asarray(p.mags) for p in pjs]),
        base=np.stack([np.asarray(p.base) for p in pjs]),
        h=rs.integers(-3, 4, (b, n)).astype(np.int32),
        rng=np.stack([np.asarray(jrng.xorshift_init(seed + k, (r, n))) for k in range(b)]),
        i0_sched=rs.integers(1, 9, c).astype(np.int32),
        fold_sched=rs.integers(0, 2, c + 1).astype(np.int32),
        best_H=np.full((b, r), 2**30, np.int32),
        best_m_packed=np.asarray(jbitplane.pack_spins(
            jnp.asarray(rs.choice([-1, 1], (b, r, n))))),
    )
    jperp = rs.integers(0, 5, c).astype(np.int32)
    return case, jperp


def _i32(a):
    return convert._as_i32(np.asarray(a), "cpu")


@pytest.mark.parametrize("mode", ["classical", "ring"])
@pytest.mark.parametrize("cluster_size,n", [(3, 100), (32, 2000), (0, 100), (16, 64),
                                            (4, 64), (-1, 100)])
def test_forced_popcount_cluster_size_is_checked(mode, cluster_size, n):
    """A forced size must be one the kernels take and at most the word count
    of N, as on the card; the check runs on the CPU too."""
    case, jperp = _chain_case(1, 8, n, 2, seed=n)
    kw = dict(jperp_sched=torch.from_numpy(jperp), n_replicas=4) if mode == "ring" else {}
    with pytest.raises(ValueError, match="cluster_size"):
        ssa_update.ssa_plateau_popcount_batched(*(_i32(case[k]) for k in K2_ORDER),
                                                cluster_size=cluster_size, **kw)


@pytest.mark.parametrize("mode", ["classical", "ring"])
def test_popcount_on_the_cpu_needs_no_library(mode, monkeypatch):
    """Sizes, variants and occupancy are the card's: on the CPU the wrapper
    runs the plain version without loading (or building) a kernel."""
    def no_library(name):
        raise AssertionError(f"library {name} loaded on the CPU")

    monkeypatch.setattr(_build, "library", no_library)
    case, jperp = _chain_case(1, 8, 100, 3, seed=5)
    kw = dict(jperp_sched=torch.from_numpy(jperp), n_replicas=4) if mode == "ring" else {}
    for cs in (None, 2):
        out = ssa_update.ssa_plateau_popcount_batched(*(_i32(case[k]) for k in K2_ORDER),
                                                      cluster_size=cs, **kw)
        assert len(out) == len(OUTS)


@pytest.mark.parametrize("mode", ["classical", "ring"])
@pytest.mark.parametrize("cluster_size", [None, 1, 2, 4])
def test_forced_popcount_cluster_size_leaves_the_result_alone(mode, cluster_size):
    """On the CPU a valid forced size runs the plain version, equal to the
    Pallas kernel's result (interpret mode): 13 trials (a ragged last
    group) or rings of 4, N = 100 (4 words, a ragged last word), 2
    magnitude planes."""
    r, nr = (13, 0) if mode == "classical" else (8, 4)
    case, jperp = _chain_case(1, r, 100, 6, seed=7 + r)
    jkw, kw = {}, {}
    if nr:
        jkw = dict(block_r=nr, jperp_sched=jnp.asarray(jperp), n_replicas=nr)
        kw = dict(jperp_sched=torch.from_numpy(jperp), n_replicas=nr)
    want = jssa.ssa_plateau_popcount_batched(*(jnp.asarray(case[k]) for k in K2_ORDER),
                                             n_rnd=2, **jkw)
    got = ssa_update.ssa_plateau_popcount_batched(*(_i32(case[k]) for k in K2_ORDER), n_rnd=2,
                                                  cluster_size=cluster_size, **kw)
    for name, g, w in zip(OUTS, got, want):
        w = np.asarray(w)
        g = g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=name)
