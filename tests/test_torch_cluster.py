"""K1 (classical and ring mode), K4 and K3 as thread-block clusters: the
choice of the cluster size.

``plateau_cluster_size``, ``ring_cluster_size`` and ``_k3_splits`` are pure
Python (the occupancy query comes in as a function), so their rule is held
here on the CPU; the kernels themselves are held against their plain
versions at every size the rule can return by ``tests/test_torch_cuda.py``
on the card.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssa_update  # noqa: E402
from repro_torch.kernels.bitplane import packed_words  # noqa: E402
from repro_torch.kernels.ssa_update import plateau_cluster_size, ring_cluster_size  # noqa: E402

H100_SMS = 132

GRID = list(itertools.product((1, 2, 6, 12, 16, 33, 66, 132, 200), (1, 2, 3),
                              (8, 33, 64, 100, 257, 1001, 2000), (16, 66, 132)))


def _occupancy(sms, max_cs):
    """A card's occupancy query that runs clusters of up to ``max_cs``
    blocks, as many as its ``sms`` SMs hold, and no larger ones."""
    return lambda cs: sms // cs if cs <= max_cs else 0


@pytest.mark.parametrize("max_cs", [8, 16])
def test_cluster_size_respects_sm_count_words_and_sizes(max_cs):
    allowed = (1, 2, 4, 8, 16)[:4 + (max_cs == 16)]
    assert ssa_update.CLUSTER_SIZES == (1, 2, 4, 8, 16)
    for n_rings, b, n, sms in GRID:
        cs = ring_cluster_size(n_rings, b, n, sms, _occupancy(sms, max_cs))
        assert cs in allowed, (n_rings, b, n, sms, cs)
        assert cs <= packed_words(n), (n_rings, b, n, sms, cs)
        assert cs == 1 or n_rings * b * cs <= sms, (n_rings, b, n, sms, cs)
        # ... and it is the largest size that does.
        bigger = [c for c in allowed if c > cs]
        assert all(n_rings * b * c > sms or c > packed_words(n) for c in bigger)


def test_cluster_size_is_deterministic():
    first = [ring_cluster_size(*case) for case in GRID]
    assert first == [ring_cluster_size(*case) for case in GRID]


@pytest.mark.parametrize("n_rings,b", [(132, 1), (67, 1), (100, 1), (34, 2), (45, 3)])
def test_cluster_size_is_one_for_rings_that_fill_the_card(n_rings, b):
    assert ring_cluster_size(n_rings, b, 2000, H100_SMS) == 1
    assert ring_cluster_size(n_rings, b, 2000, H100_SMS, _occupancy(H100_SMS, 8)) == 1


@pytest.mark.parametrize("n_rings,b,n,max_cs,want", [
    (12, 1, 2000, 8, 8),     # SSQA at K2000: 96 trials in rings of 8 → 96 blocks
    (12, 1, 2000, 16, 8),    # 12 × 16 > 132
    (6, 1, 2000, 16, 16),    # 96 trials in rings of 16
    (1, 1, 2000, 16, 16),    # autotune's K2000 choice: one ring of 16
    (1, 1, 2000, 8, 8),
    (24, 1, 2000, 8, 4),
    (1, 1, 40, 8, 2),        # two words: two blocks at most
    (1, 1, 16, 16, 1),       # one word
    (2, 2, 1001, 16, 16),
])
def test_cluster_size_examples(n_rings, b, n, max_cs, want):
    assert ring_cluster_size(n_rings, b, n, H100_SMS, _occupancy(H100_SMS, max_cs)) == want
    if max_cs == 16:  # no occupancy query: only the SM and word counts limit it
        assert ring_cluster_size(n_rings, b, n, H100_SMS) == want


def test_cluster_size_waits_for_no_second_wave():
    """A size whose clusters do not all run at once is passed over for the
    next smaller one that does."""
    fits = {16: 0, 8: 11, 4: 30, 2: 66, 1: 132}.__getitem__
    assert ring_cluster_size(12, 1, 2000, H100_SMS, fits) == 4
    assert ring_cluster_size(11, 1, 2000, H100_SMS, fits) == 8
    assert ring_cluster_size(1, 1, 2000, H100_SMS, fits) == 8


@pytest.mark.parametrize("r,n,fits,want", [
    (100, 2000, 15, 6),       # 16 column tiles; clusters of 7 and 8 do not all fit
    (100, 2000, 16, 8),       # 16 × 8 = 128 blocks <= 132 SMs
    (130, 2000, 16, 4),       # 32 tiles: 4 K splits fill 128 SMs
    (13, 100, 16, 2),         # one tile, two k stages: at most two splits
    (100, 20000, 16, 1),      # 157 tiles fill the card alone
])
def test_k3_splits(r, n, fits, want):
    """K3's K splits by the same rule: 1 to MAX_KS blocks per cluster, one
    k stage each at least, every block on an SM, every cluster at once (a
    card that runs 132 // ks clusters of up to 6 blocks and ``fits`` of 7
    or 8)."""
    assert ssa_update._K3_MAX_SPLITS == 8
    occupancy = lambda ks: H100_SMS // ks if ks <= 6 else fits  # noqa: E731
    assert ssa_update._k3_splits(r, n, H100_SMS, occupancy) == want


def _ring_args(r, n):
    g = torch.Generator().manual_seed(r + n)
    nw = packed_words(n)
    return dict(
        m_packed=torch.randint(-2**31, 2**31 - 1, (1, r, nw), generator=g, dtype=torch.int32),
        itanh=torch.zeros((1, r, n), dtype=torch.int32),
        J=torch.zeros((1, n, n)), h=torch.zeros((1, n), dtype=torch.int32),
        rng=torch.ones((1, 4, r, n), dtype=torch.int32),
        best_H=torch.zeros((1, r), dtype=torch.int32),
        best_m_packed=torch.zeros((1, r, nw), dtype=torch.int32),
    )


@pytest.mark.parametrize("cluster_size,n", [(3, 100), (32, 2000), (0, 100), (16, 64), (4, 64)])
def test_forced_cluster_size_is_checked(cluster_size, n):
    """A forced size must be one the kernel takes and at most the ring's
    word count, as the card would need; the check runs on the CPU too."""
    with pytest.raises(ValueError, match="cluster_size"):
        ssa_update.ssa_plateau_packed_batched(**_ring_args(8, n), i0=4, n_cycles=2,
                                              n_replicas=4, cluster_size=cluster_size)


@pytest.mark.parametrize("cluster_size", [None, 1, 2, 8])
def test_forced_cluster_size_leaves_the_result_alone(cluster_size):
    args = _ring_args(8, 300)
    kw = dict(i0=4, n_cycles=3, n_replicas=4, jperp=2)
    want = ssa_update.ssa_plateau_packed_batched(**args, **kw)
    got = ssa_update.ssa_plateau_packed_batched(**args, **kw, cluster_size=cluster_size)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,r,cs", [(2000, 8, 8), (2000, 16, 16), (2000, 32, 1), (4096, 32, 1)])
def test_ring_block_fits_shared_memory(n, r, cs):
    """The ring-mode block at the widths the port runs fits one SM's
    shared memory; its work area is KC signs of RING_G replicas."""
    assert ssa_update._WORK_BYTES == 4 * 2048 * 8
    assert ssa_update._ring_smem(n, r, cs) <= ssa_update._MAX_SMEM


# ---------------------------------------------------------------------------
# K1's classical kernel and K4: a cluster per group of PLATEAU_GROUP trials
# ---------------------------------------------------------------------------
PLATEAU_GRID = list(itertools.product((1, 3, 8, 13, 96, 100, 200, 1000), (1, 2, 3),
                                      (16, 36, 70, 257, 1001, 2000, 4100), (16, 66, 132)))


@pytest.mark.parametrize("r,groups", [(0, 0), (1, 1), (3, 1), (8, 1), (9, 2), (13, 2),
                                      (96, 12), (100, 13)])
def test_plateau_groups(r, groups):
    assert ssa_update.PLATEAU_GROUP == 8
    assert ssa_update.plateau_groups(r) == groups


@pytest.mark.parametrize("max_cs", [8, 16])
def test_plateau_cluster_size_respects_groups_words_and_occupancy(max_cs):
    allowed = (1, 2, 4, 8, 16)[:4 + (max_cs == 16)]
    for r, b, n, sms in PLATEAU_GRID:
        groups = ssa_update.plateau_groups(r) * b
        cs = plateau_cluster_size(r, b, n, sms, _occupancy(sms, max_cs))
        assert cs in allowed, (r, b, n, sms, cs)
        assert cs <= packed_words(n), (r, b, n, sms, cs)
        assert cs == 1 or groups * cs <= sms, (r, b, n, sms, cs)
        # ... and it is the largest size that does: the rule of the ring mode
        # over the groups of all B problems.
        bigger = [c for c in allowed if c > cs]
        assert all(groups * c > sms or c > packed_words(n) for c in bigger)
        assert cs == ring_cluster_size(ssa_update.plateau_groups(r), b, n, sms,
                                       _occupancy(sms, max_cs))


@pytest.mark.parametrize("r,b,n,max_cs,want", [
    (100, 1, 2000, 16, 8),   # K2000's 100 trials: 13 groups, 104 blocks
    (100, 1, 2000, 8, 8),
    (96, 1, 2000, 16, 8),    # SSQA's J⊥ = 0 plateau: 12 groups, 96 blocks
    (100, 2, 2000, 16, 4),   # 26 groups
    (3, 1, 2000, 16, 16),    # one ragged group
    (3, 1, 2000, 8, 8),
    (13, 1, 1001, 16, 16),   # two groups, the last of 5 trials
    (4, 1, 36, 16, 2),       # two words: two blocks at most
    (5, 1, 70, 16, 2),       # three words
    (8, 1, 16, 16, 1),       # one word
    (1000, 1, 2000, 16, 1),  # 125 groups fill the card alone
])
def test_plateau_cluster_size_examples(r, b, n, max_cs, want):
    assert plateau_cluster_size(r, b, n, H100_SMS, _occupancy(H100_SMS, max_cs)) == want
    if max_cs == 16:  # no occupancy query: only the SM and word counts limit it
        assert plateau_cluster_size(r, b, n, H100_SMS) == want


def test_plateau_cluster_size_waits_for_no_second_wave():
    """Sixteen clusters of 8 that do not all fit are passed over for 4."""
    fits = {16: 0, 8: 12, 4: 33, 2: 66, 1: 132}.__getitem__
    assert plateau_cluster_size(100, 1, 2000, H100_SMS, fits) == 4
    assert plateau_cluster_size(96, 1, 2000, H100_SMS, fits) == 8


def _plateau_args(r, n):
    args = _ring_args(r, n)
    args["itanh"] = torch.randint(-4, 4, (1, r, n), dtype=torch.int32,
                                  generator=torch.Generator().manual_seed(n))
    return args


def _pregen_args(r, n, c=3):
    g = torch.Generator().manual_seed(r + n)
    spins = torch.randint(0, 2, (2, 1, r, n), generator=g) * 2 - 1
    return dict(m=spins[0].float(), itanh=torch.zeros((1, r, n), dtype=torch.int32),
                J=torch.zeros((1, n, n)), h=torch.zeros((1, n), dtype=torch.int32),
                noise=(torch.randint(0, 2, (1, c, r, n), generator=g) * 2 - 1).to(torch.int8),
                best_H=torch.zeros((1, r), dtype=torch.int32), best_m=spins[1].to(torch.int8))


@pytest.mark.parametrize("kernel", ["K1", "K4"])
@pytest.mark.parametrize("cluster_size,n", [(3, 100), (32, 2000), (0, 100), (16, 64), (4, 64)])
def test_forced_plateau_cluster_size_is_checked(kernel, cluster_size, n):
    """K1's classical kernel and K4 take a forced size by the same rule as
    the ring mode, checked on the CPU too."""
    with pytest.raises(ValueError, match="cluster_size"):
        if kernel == "K1":
            ssa_update.ssa_plateau_packed_batched(**_plateau_args(8, n), i0=4, n_cycles=2,
                                                  cluster_size=cluster_size)
        else:
            ssa_update.ssa_plateau_batched(**_pregen_args(8, n), i0=4, cluster_size=cluster_size)


@pytest.mark.parametrize("kernel", ["K1", "K4"])
@pytest.mark.parametrize("cluster_size", [None, 1, 2, 8])
def test_forced_plateau_cluster_size_leaves_the_result_alone(kernel, cluster_size):
    if kernel == "K1":
        run, args, kw = ssa_update.ssa_plateau_packed_batched, _plateau_args(13, 300), \
            dict(i0=4, n_cycles=3)
    else:
        run, args, kw = ssa_update.ssa_plateau_batched, _pregen_args(13, 300), dict(i0=4)
    want = run(**args, **kw)
    got = run(**args, **kw, cluster_size=cluster_size)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plateau_block_fits_shared_memory_where_the_old_one_did():
    """The wrappers' limit on N does not shrink: every N whose old block (2
    trials, each [N] spins double-buffered as floats, K1 with its best
    words) fitted, fits a cluster block at every size, and more."""
    old_k1 = lambda n: 2 * 4 * (2 * n + packed_words(n))  # noqa: E731
    old_k4 = lambda n: 2 * 4 * 2 * n  # noqa: E731
    n_k1 = max(n for n in range(1, 20000) if old_k1(n) <= ssa_update._MAX_SMEM)
    n_k4 = max(n for n in range(1, 20000) if old_k4(n) <= ssa_update._MAX_SMEM)
    assert (n_k1, n_k4) == (14304, 14528)
    for cs in ssa_update.CLUSTER_SIZES:
        assert ssa_update._plateau_smem(n_k1, cs, best_words=True) <= ssa_update._MAX_SMEM
        assert ssa_update._plateau_smem(n_k4, cs, best_words=False) <= ssa_update._MAX_SMEM
    assert ssa_update._plateau_smem(18000, 1, best_words=True) <= ssa_update._MAX_SMEM
    assert ssa_update._plateau_smem(20000, 1, best_words=False) <= ssa_update._MAX_SMEM
    # The work area, the group's words double-buffered, K1's best words.
    assert ssa_update._plateau_smem(2000, 8, True) == 4 * 2048 * 8 + 4 * (2 * 2000 + 8 * 8)
    assert ssa_update._plateau_smem(2000, 8, False) == 4 * 2048 * 8 + 4 * 2 * 2000
