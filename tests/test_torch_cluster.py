"""K1's ring mode and K3 as thread-block clusters: the choice of the cluster
size.

``ring_cluster_size`` and ``_k3_splits`` are pure Python (the occupancy
query comes in as a function), so their rule is held here on the CPU; the
kernels themselves are held against their plain versions at every size the
rule can return by ``tests/test_torch_cuda.py`` on the card.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssa_update  # noqa: E402
from repro_torch.kernels.bitplane import packed_words  # noqa: E402
from repro_torch.kernels.ssa_update import ring_cluster_size  # noqa: E402

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
    assert ssa_update.RING_CLUSTER_SIZES == (1, 2, 4, 8, 16)
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
    shared memory; its work area is RING_KC signs of RING_G replicas."""
    assert ssa_update._RING_WORK_BYTES == 4 * 2048 * 8
    assert ssa_update._ring_smem(n, r, cs) <= ssa_update._MAX_SMEM
