"""The CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU or interpret mode, so these tests are marked
``cuda`` and skip on a host without a GPU.  On the GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the GPU host runs the port alone.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gset  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.config import SolverConfig  # noqa: E402
from repro_torch.core.rng import xorshift_init  # noqa: E402
from repro_torch.core.ssa import SSAHyperParams, anneal  # noqa: E402
from repro_torch.kernels import ssa_update  # noqa: E402
from repro_torch.kernels.bitplane import (  # noqa: E402
    PackedJ,
    pack_couplings,
    pack_spins,
    packed_words,
    popcount_u32,
)
from repro_torch.kernels.ref import (  # noqa: E402
    local_field_ref,
    ssa_plateau_packed_ref,
    ssa_plateau_popcount_ref,
    ssa_plateau_ref,
)

OUTS = ("m_packed", "itanh", "rng", "best_H", "best_m_packed")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: exact f32
    return torch.device("cuda")


def _coupling(rs, n):
    J = np.triu(rs.integers(-3, 4, size=(n, n)), 1)
    return J + J.T


def _mixed_plane_coupling(rs, n):
    """J whose 64 x 128 tiles need one, two, three and four byte planes in
    K3 (|J| <= 127, < 2^15, < 2^23, any), inside the exactness contract."""
    J = rs.integers(-1, 2, size=(n, n))
    two = J[64:128, 128:256]
    two[...] = rs.integers(-4096, 4097, size=two.shape)
    for c in range(256, min(384, n)):
        J[192 + c % 64, c] = rs.integers(-(2**20), 2**20)
    if n > 500:
        J[300, 500] = 9_000_001
    return J


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(1, 16), (13, 100), (33, 257), (100, 2000), (130, 600)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("planes", ["one", "mixed"])
def test_local_field_kernel_matches_plain(cuda_device, r, n, dtype, planes):
    """K3, R not a multiple of 16 and N not of 32, with J of one byte plane
    and with tiles of one to four planes mixed in one J."""
    rs = np.random.default_rng(n)
    m = torch.as_tensor(rs.choice([-1.0, 1.0], size=(r, n)), dtype=torch.float32, device=cuda_device)
    h = torch.as_tensor(rs.integers(-4, 5, size=(n,)), dtype=torch.int32, device=cuda_device)
    J = _coupling(rs, n) if planes == "one" else _mixed_plane_coupling(rs, n)
    J = torch.as_tensor(J, dtype=getattr(torch, dtype), device=cuda_device)
    before = ssa_update.local_field.launches
    got = ssa_update.local_field(m, h, J)
    assert ssa_update.local_field.launches == before + 1
    assert torch.equal(got, local_field_ref(m, h, J))


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(13, 100), (33, 257), (100, 2000)])
@pytest.mark.parametrize("dtype", ["float16", "int8", "uint8", "int16", "int32"])
def test_local_field_kernel_j_dtypes_match_plain(cuda_device, r, n, dtype):
    """K3 with J in the other dtypes: 13-bit weights, rounded (float16) or
    wrapped (int8, uint8) on the host as the backends hold them, so the
    byte planes run from one (int8) to two (uint8 above 127, int16)."""
    rs = np.random.default_rng(n + 7)
    m = torch.as_tensor(rs.choice([-1.0, 1.0], size=(r, n)), dtype=torch.float32, device=cuda_device)
    h = torch.as_tensor(rs.integers(-4, 5, size=(n,)), dtype=torch.int32, device=cuda_device)
    J = np.triu(rs.integers(-4095, 4096, size=(n, n)), 1)
    J = torch.from_numpy(J + J.T).to(getattr(torch, dtype)).to(cuda_device)
    before = ssa_update.local_field.launches
    got = ssa_update.local_field(m, h, J)
    assert ssa_update.local_field.launches == before + 1
    assert torch.equal(got, local_field_ref(m, h, J))


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(100, 2000), (130, 600)])
def test_local_field_kernel_k_split_leaves_the_result_alone(cuda_device, r, n):
    """K3 forced to every K split, 1 to MAX_KS blocks per cluster."""
    rs = np.random.default_rng(n + 1)
    m = torch.as_tensor(rs.choice([-1.0, 1.0], size=(r, n)), dtype=torch.float32, device=cuda_device)
    h = torch.as_tensor(rs.integers(-4, 5, size=(n,)), dtype=torch.int32, device=cuda_device)
    J = torch.as_tensor(_mixed_plane_coupling(rs, n), dtype=torch.float32, device=cuda_device)
    want = local_field_ref(m, h, J)
    for ks in range(1, ssa_update._K3_MAX_SPLITS + 1):
        assert torch.equal(ssa_update._local_field(m, h, J, splits=ks), want), ks


def _plateau_args(b, r, n, seed, flat, device):
    rs = np.random.default_rng(seed)
    J = torch.as_tensor(np.stack([_coupling(rs, n) * (not flat) for _ in range(b)]),
                        dtype=torch.float32)
    h = torch.as_tensor(rs.integers(-2, 3, size=(b, n)) * (not flat), dtype=torch.int32)
    spins = torch.as_tensor(rs.choice([-1, 1], size=(2, b, r, n)), dtype=torch.int8)
    best_H = torch.full((b, r), 2**30, dtype=torch.int32)
    best_H[:, 0] = -10**6
    args = dict(m_packed=pack_spins(spins[0]),
                itanh=torch.as_tensor(rs.integers(-6, 6, size=(b, r, n)), dtype=torch.int32),
                J=J, h=h, rng=xorshift_init(seed, (b, r, n)).movedim(0, 1).contiguous(),
                best_H=best_H, best_m_packed=pack_spins(spins[1]))
    return {k: v.to(device) for k, v in args.items()}


# Shapes at the cluster loop's edges (csrc/plateau_cycle.cuh), shared by
# K1's classical kernel and K4: (b, r, n, c, flat, cluster size or None for
# the wrapper's choice, J dtype).  Ragged last groups of 8 trials (R = 13,
# 100) and R below one group (3, 4, 5); N above the sign table's 2048 rows;
# N % 4 != 0 (one scalar load per column: 70, 1001, 2101); small N whose
# word count caps the cluster size (36: 2 words, 70: 3); B = 2; a bfloat16
# J; tied energies (flat); and every forced cluster size up to Nw.
PLATEAU_EDGES = [
    (1, 4, 36, 5, False, None, "float32"), (1, 9, 100, 7, False, None, "float32"),
    (2, 3, 1001, 3, False, None, "float32"), (1, 5, 70, 6, True, None, "float32"),
    (1, 100, 2000, 4, False, None, "float32"), (1, 13, 1001, 7, False, None, "float32"),
    (1, 100, 2000, 3, False, None, "bfloat16"), (2, 13, 1001, 5, False, None, "bfloat16"),
    (1, 3, 2100, 2, False, None, "float32"), (1, 13, 2101, 2, False, 2, "float32"),
    (1, 9, 4100, 1, False, None, "bfloat16"), (1, 4, 36, 5, False, 2, "float32"),
    (1, 5, 70, 6, False, 2, "float32"), (1, 13, 1001, 5, True, 4, "float32"),
] + [(2, 13, 1001, 5, False, cs, "float32")  # every cluster size, a ragged last word
     for cs in (1, 2, 4, 8, 16)] + [(1, 100, 2000, 2, False, cs, "float32") for cs in (1, 16)] + [
    # the other J dtypes (csrc/jtype.cuh): 4-, 8- and 16-byte vector loads, and scalar ones
    (1, 100, 2000, 3, False, None, "float16"), (1, 100, 2000, 3, False, None, "int8"),
    (2, 13, 1001, 3, False, None, "uint8"), (1, 9, 4100, 1, False, None, "int16"),
    (1, 13, 2101, 2, False, None, "int32"), (1, 13, 1001, 3, False, None, "int8"),
]


def _check_last_cluster(wrapper, b, r, cs):
    launched_cs, blocks = wrapper.last_cluster
    assert cs is None or launched_cs == cs
    assert blocks == b * ssa_update.plateau_groups(r) * launched_cs


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,n,c,flat,cs,dtype", PLATEAU_EDGES)
@pytest.mark.parametrize("eligible", [True, False])
def test_plateau_kernel_matches_plain(cuda_device, b, r, n, c, flat, cs, dtype, eligible):
    """K1's classical kernel, a cluster per group of 8 trials."""
    args = _plateau_args(b, r, n, seed=n + c, flat=flat, device=cuda_device)
    args["J"] = args["J"].to(getattr(torch, dtype))
    k1 = ssa_update.ssa_plateau_packed_batched
    before = (k1.launches, k1.ring_launches)
    got = k1(**args, i0=4, n_cycles=c, eligible=eligible, cluster_size=cs)
    assert (k1.launches, k1.ring_launches) == (before[0] + 1, before[1])
    _check_last_cluster(k1, b, r, cs)
    want = ssa_plateau_packed_ref(**args, i0=4, n_cycles=c, eligible=eligible)
    for name, g, w in zip(OUTS, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("record,track_energy", [("best", False), ("best", True), ("traj", False)])
def test_anneal_cuda_matches_dense_on_card(cuda_device, layout, record, track_energy):
    p = gset.complete_graph(300, seed=7)
    hp = SSAHyperParams(n_trials=7, m_shot=2, tau=6, i0_max=8)
    runs = [anneal(p, hp, seed=3, record=record, track_energy=track_energy, device="cuda",
                   config=SolverConfig(backend=bk, noise="xorshift", storage_layout=layout))
            for bk in ("cuda", "dense")]
    got, want = runs
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)
    if record == "traj":
        np.testing.assert_array_equal(got.traj, want.traj)
    if track_energy:
        np.testing.assert_array_equal(got.energy_min, want.energy_min)
        np.testing.assert_array_equal(got.energy_mean, want.energy_mean)


def _pregen_args(b, r, n, c, seed, flat, dtype, device):
    rs = np.random.default_rng(seed)
    best_H = torch.full((b, r), 2**30, dtype=torch.int32)
    best_H[:, 0] = -10**6
    args = dict(
        m=torch.as_tensor(rs.choice([-1.0, 1.0], size=(b, r, n)), dtype=torch.float32),
        itanh=torch.as_tensor(rs.integers(-6, 6, size=(b, r, n)), dtype=torch.int32),
        J=torch.as_tensor(np.stack([_coupling(rs, n) * (not flat) for _ in range(b)]),
                          dtype=getattr(torch, dtype)),
        h=torch.as_tensor(rs.integers(-2, 3, size=(b, n)) * (not flat), dtype=torch.int32),
        noise=torch.as_tensor(rs.choice([-1, 1], size=(b, c, r, n)), dtype=torch.int8),
        best_H=best_H,
        best_m=torch.as_tensor(rs.choice([-1, 1], size=(b, r, n)), dtype=torch.int8),
    )
    return {k: v.to(device) for k, v in args.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,n,c,flat,cs,dtype", [
    (1, 4, 36, 5, False, None, "float32"), (1, 13, 1001, 7, False, None, "float32"),
    (2, 3, 1001, 3, False, None, "float32"), (1, 5, 70, 6, True, None, "float32"),
    (1, 9, 257, 4, False, None, "bfloat16"), (1, 100, 2000, 4, False, None, "float32"),
    (1, 3, 40, 0, False, None, "float32"),   # C = 0: the fold of the initial state only
    (1, 100, 2000, 0, False, None, "float32"),
] + PLATEAU_EDGES[6:])
@pytest.mark.parametrize("eligible", [True, False])
def test_pregen_plateau_kernel_matches_plain(cuda_device, b, r, n, c, flat, cs, dtype,
                                             eligible):
    """K4, on K1's cluster loop, at the same edges."""
    args = _pregen_args(b, r, n, c, seed=n + c, flat=flat, dtype=dtype, device=cuda_device)
    before = ssa_update.ssa_plateau_batched.launches
    got = ssa_update.ssa_plateau_batched(**args, i0=4, eligible=eligible, cluster_size=cs)
    assert ssa_update.ssa_plateau_batched.launches == before + 1
    _check_last_cluster(ssa_update.ssa_plateau_batched, b, r, cs)
    want = ssa_plateau_ref(**args, i0=4, eligible=eligible)
    for name, g, w in zip(("m", "itanh", "best_H", "best_m"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("noise", ["threefry", "xorshift"])
def test_anneal_pregen_matches_dense_on_card(cuda_device, layout, noise):
    p = gset.complete_graph(300, seed=7)
    hp = SSAHyperParams(n_trials=7, m_shot=2, tau=6, i0_max=8)
    before = (ssa_update.ssa_plateau_batched.launches,
              ssa_update.ssa_plateau_packed_batched.launches)
    got = anneal(p, hp, seed=3, track_energy=False, device="cuda",
                 config=SolverConfig(backend="cuda", noise=noise, noise_mode="pregen",
                                     storage_layout=layout))
    after = (ssa_update.ssa_plateau_batched.launches,
             ssa_update.ssa_plateau_packed_batched.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (hp.m_shot * hp.steps, 0)
    want = anneal(p, hp, seed=3, track_energy=False, device="cuda",
                  config=SolverConfig(backend="dense", noise=noise, storage_layout=layout))
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)


def _random_planes(rs, b, n, device):
    """Bitplanes too wide for a dense J on the host, drawn on the card: a
    random sign plane, one magnitude plane (about one coupling in 16), tail
    bits 0, base = -Σ_j |J_ij| (J_ij = ±mags_ij, not symmetric; couplings
    in pairs of neighbouring columns, so every row's Σ_j |J_ij| is even and
    the energy an integer, as a symmetric J's)."""
    nw = packed_words(n)
    gen = torch.Generator(device=device).manual_seed(int(rs.integers(2**31)))
    mask = torch.full((nw,), -1, dtype=torch.int32, device=device)
    if n % 32:
        mask[-1] = (1 << (n % 32 & ~1)) - 1  # whole pairs of columns only

    def words():
        return torch.randint(-2**31, 2**31, (b, n, nw), generator=gen, dtype=torch.int32,
                             device=device)

    pairs = words() & words() & words() & words() & 0x55555555 & mask
    mags = (pairs | pairs << 1)[:, None]
    return [PackedJ(words()[k] & mask, mags[k], -popcount_u32(mags[k, 0]).sum(
        -1, dtype=torch.int32)) for k in range(b)]


def _popcount_args(b, r, n, w_max, c, sched, flat, seed, device):
    """K2 inputs: couplings in [-w_max, w_max] (``w_max`` 0: the random
    planes of :func:`_random_planes`, drawn on the card)."""
    rs = np.random.default_rng(seed)
    nb = max(1, w_max.bit_length())
    pjs = []
    for _ in range(b if w_max else 0):
        J = np.triu(rs.integers(-w_max, w_max + 1, (n, n)), 1) * (not flat)
        pjs.append(pack_couplings(J + J.T, nb))
    if not w_max:
        pjs = _random_planes(rs, b, n, device)
    if sched == "hassa":  # Table II: I0 1→32, tau = 100, tiled to c cycles
        chain = engine.schedule_plateaus(SSAHyperParams(tau=100).schedule())
        i0, fold, _ = engine.plateau_cycle_schedules(engine.tile_plateaus(chain, c))
    else:
        i0 = rs.integers(1, 33, c)
        fold = rs.integers(0, 2, c + 1) if sched == "random" else np.ones(c + 1)
    spins = torch.as_tensor(rs.choice([-1, 1], size=(2, b, r, n)), dtype=torch.int8)
    best_H = torch.full((b, r), 2**30, dtype=torch.int32)
    best_H[:, 0] = -10**6
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)  # noqa: E731
    args = dict(m_packed=pack_spins(spins[0]), itanh=i32(rs.integers(-8, 8, (b, r, n))),
                sign=torch.stack([p.sign for p in pjs]), mags=torch.stack([p.mags for p in pjs]),
                base=torch.stack([p.base for p in pjs]),
                h=i32(rs.integers(-2, 3, (b, n)) * (not flat)),
                rng=xorshift_init(seed, (b, r, n)).movedim(0, 1).contiguous(),
                i0_sched=i32(i0), fold_sched=i32(fold), best_H=best_H,
                best_m_packed=pack_spins(spins[1]))
    return {k: v.to(device) for k, v in args.items()}


def _popcount_variant(n, nb, nr, cs):
    return ssa_update.popcount_variant(lambda v: ssa_update._popcount_smem(n, nb, nr, cs, v))


def _check_popcount_launch(b, r, n, nb, cs, nr=0):
    """K2's last launch: the forced cluster size or the rule's (from the
    kernel's own layout and occupancy query), its block count, and the
    block variant that the kernel's layout fits."""
    launched_cs, blocks, variant = ssa_update.ssa_plateau_popcount_batched.last_cluster
    units = r // nr if nr else ssa_update.plateau_groups(r)
    if cs is None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count

        def fits(c):
            return ssa_update._max_clusters(
                torch.device("cuda"), "popcount", "repro_popcount_max_clusters", n, nr, nb, c,
                ssa_update.POPCOUNT_VARIANTS.index(_popcount_variant(n, nb, nr, c)))

        assert launched_cs == ssa_update.popcount_cluster_size(
            r, b, n, sms, fits, nr, lambda c: _popcount_variant(n, nb, nr, c) == "resident")
    else:
        assert launched_cs == cs
    assert blocks == b * units * launched_cs
    assert variant == _popcount_variant(n, nb, nr, launched_cs)


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,n,w_max,c,sched,flat,cs", [
    (1, 100, 2000, 1, 600, "hassa", False, None),   # K2000, one Table II iteration
    (1, 100, 800, 1, 600, "hassa", False, None),    # G11 width
    (1, 13, 37, 7, 50, "random", False, None),      # ragged N, 3 magnitude planes
    (1, 13, 1001, 1, 17, "all", True, None),        # tied energies, every state folded
    (1, 7, 800, 1, 40, "random", False, None),      # I0 and fold changing mid-chain
    (2, 7, 1001, 3, 9, "random", False, None),      # B = 2, 2 planes
    (1, 3, 2000, 1, 30, "random", False, None),     # below one group of 8
    (1, 13, 4100, 7, 6, "random", False, None),     # streamed planes: 4 planes of 129 words
    (2, 100, 2000, 1, 20, "random", False, None),   # B = 2: 26 groups
] + [(1, 100, 2000, 1, 40, "random", False, cs)     # every cluster size, a ragged last group
     for cs in (1, 2, 4, 8, 16)] + [
    (1, 13, 1001, 1, 30, "all", True, 16),          # tied energies across 16 blocks
    (1, 13, 37, 7, 20, "random", False, 2),         # two words over two blocks
    (1, 3, 70001, 0, 2, "all", False, 1),           # streamed near its limit, random planes
    (1, 2, 120000, 0, 3, "random", False, None),    # the spin words in global memory too
    (2, 2, 75000, 0, 2, "random", False, 16),       # ... in clusters of 16, B = 2
])
def test_popcount_chain_kernel_matches_plain(cuda_device, b, r, n, w_max, c, sched, flat, cs):
    """K2's classical kernel: a cluster per group of 8 trials at the rule's
    size and forced ones, planes resident where they fit and streamed where
    they do not."""
    args = _popcount_args(b, r, n, w_max, c, sched, flat, seed=n + c, device=cuda_device)
    want = ssa_plateau_popcount_ref(**args, n_rnd=2)
    # The planes as packed, then in K2's layout (the cuda backend's).
    laid_out = ssa_update.popcount_planes(PackedJ(args["sign"], args["mags"], args["base"]))
    for x in (args, dict(args, sign=laid_out.sign, mags=laid_out.mags)):
        before = ssa_update.ssa_plateau_popcount_batched.launches
        got = ssa_update.ssa_plateau_popcount_batched(**x, n_rnd=2, cluster_size=cs)
        assert ssa_update.ssa_plateau_popcount_batched.launches == before + 1
        _check_popcount_launch(b, r, n, args["mags"].shape[1], cs)
        for name, g, w in zip(OUTS, got, want):
            assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb,nr,cs,want", [
    (2000, 1, 0, 8, "resident"),    # K2000 in clusters of 8: 129 KB of planes
    (2000, 1, 0, 16, "resident"),
    (2000, 1, 0, 4, "streamed"),    # 258 KB of planes alone
    (2000, 1, 0, 1, "streamed"),
    (800, 1, 0, 2, "resident"),     # G11
    (2000, 1, 16, 16, "resident"),  # rings of 16, one per cluster of 16
    (2000, 1, 16, 8, "resident"),   # the per-trial arrays sized by the ring's 16
    (2000, 1, 64, 16, "streamed"),  # rings of 64: 164 KB of state alone
    (2000, 1, 32, 16, "resident"),
    (4100, 3, 0, 16, "streamed"),   # 4 planes of 129 words
    (37, 3, 0, 1, "resident"),
    (20000, 3, 0, 1, "streamed"),   # G81's width, every size
    (20000, 3, 16, 1, "streamed"),
    (74624, 1, 0, 1, "streamed"),   # the group's words at the limit
    (74625, 1, 0, 1, "global"),
    (120000, 1, 0, 16, "global"),
    (30000, 1, 32, 16, "global"),
    (30000, 1, 64, 16, "global"),
])
def test_popcount_variant_by_size(cuda_device, n, nb, nr, cs, want):
    """The block variant that the kernel's layout (repro_popcount_smem)
    fits: planes resident at K2000 in clusters of 8 and more, streamed in
    clusters of 4 and less and at N = 4100 with 3 planes, the spin words in
    global memory where even they do not fit."""
    assert _popcount_variant(n, nb, nr, cs) == want
    assert ssa_update._popcount_smem(n, nb, nr, cs, want) <= ssa_update._MAX_SMEM


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,nr,want", [
    (1, 100, 0, 8),   # K2000's 13 groups: 104 blocks
    (2, 100, 0, 8),   # 26 groups: two waves of resident clusters
    (1, 96, 8, 8),    # SSQA: 12 rings of 8
    (1, 96, 16, 16),  # 6 rings of 16
    (1, 16, 16, 16),  # autotune's one ring of 16
])
def test_popcount_chosen_cluster_size_on_card(cuda_device, b, r, nr, want):
    args = _popcount_args(b, r, 2000, 1, 2, "random", False, seed=r + nr, device=cuda_device)
    kw = {}
    if nr:
        kw = dict(jperp_sched=torch.ones(2, dtype=torch.int32, device=cuda_device),
                  n_replicas=nr)
    ssa_update.ssa_plateau_popcount_batched(**args, n_rnd=2, **kw)
    assert ssa_update.ssa_plateau_popcount_batched.last_cluster == (
        want, b * (r // nr if nr else ssa_update.plateau_groups(r)) * want, "resident")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_anneal_popcount_matches_k1_on_card(cuda_device, layout):
    p = gset.complete_graph(300, seed=7)
    hp = SSAHyperParams(n_trials=7, m_shot=2, tau=6, i0_max=8)
    before = (ssa_update.ssa_plateau_popcount_batched.launches,
              ssa_update.ssa_plateau_packed_batched.launches)
    got = anneal(p, hp, seed=3, track_energy=False, device="cuda",
                 config=SolverConfig(backend="cuda", noise="xorshift", field_mode="popcount",
                                     storage_layout=layout))
    after = (ssa_update.ssa_plateau_popcount_batched.launches,
             ssa_update.ssa_plateau_packed_batched.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (hp.m_shot, 0)
    want = anneal(p, hp, seed=3, track_energy=False, device="cuda",
                  config=SolverConfig(backend="cuda", noise="xorshift", storage_layout=layout))
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)


# ---------------------------------------------------------------------------
# The problem families' inputs: h != 0 and multi-bit weights
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("n,w_max,h_max", [
    (600, 16, 1037),      # QUBO-like: 5-bit weights, |h| up to ~10^3
    (2000, 16, 1037),     # ... at K2000 width
    (2000, 5000, 0),      # partition-like: 13-bit weights on a dense J
    (1001, 4095, 60000),  # 12-bit weights and a large h, ragged N
])
@pytest.mark.parametrize("eligible", [True, False])
def test_plateau_kernel_large_h_and_multibit_weights(cuda_device, n, w_max, h_max, eligible):
    """K1 where the families take it: the f32 J stays exact below 2^24."""
    args = _plateau_args(1, 100 if n == 2000 else 13, n, seed=n + w_max, flat=False,
                         device=cuda_device)
    rs = np.random.default_rng(w_max)
    J = np.triu(rs.integers(-w_max, w_max + 1, size=(n, n)), 1)
    args["J"] = torch.as_tensor((J + J.T)[None], dtype=torch.float32, device=cuda_device)
    args["h"] = torch.as_tensor(rs.integers(-h_max, h_max + 1, size=(1, n)),
                                dtype=torch.int32, device=cuda_device)
    assert int(args["h"].abs().max()) + int(args["J"].abs().sum(-1).max()) < 2**24
    k1 = ssa_update.ssa_plateau_packed_batched
    got = k1(**args, i0=32, n_cycles=7, eligible=eligible)
    want = ssa_plateau_packed_ref(**args, i0=32, n_cycles=7, eligible=eligible)
    for name, g, w in zip(OUTS, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,n,w_max,h_max,c", [
    (1, 100, 2000, 3, 560, 600),   # MIS-like: nb = 2, one Table II iteration
    (1, 13, 2100, 15, 17, 200),    # coloring-like: nb = 4, 2100 spins
    (2, 13, 1001, 3, 300, 50),     # nb = 2, B = 2, ragged N
    (1, 7, 4096, 15, 40, 20),      # nb = 4 at the coloring bucket's width
])
def test_popcount_kernel_multibit_with_bias(cuda_device, b, r, n, w_max, h_max, c):
    """K2 where the families take it: 2 and 4 magnitude planes, h != 0."""
    args = _popcount_args(b, r, n, w_max, c, "hassa", False, seed=n + c, device=cuda_device)
    rs = np.random.default_rng(n)
    args["h"] = torch.as_tensor(rs.integers(-h_max, h_max + 1, size=(b, n)),
                                dtype=torch.int32, device=cuda_device)
    assert args["mags"].shape[1] == w_max.bit_length()
    want = ssa_plateau_popcount_ref(**args, n_rnd=2)
    laid_out = ssa_update.popcount_planes(PackedJ(args["sign"], args["mags"], args["base"]))
    got = ssa_update.ssa_plateau_popcount_batched(**dict(args, sign=laid_out.sign,
                                                         mags=laid_out.mags), n_rnd=2)
    _check_popcount_launch(b, r, n, args["mags"].shape[1], None)
    for name, g, w in zip(OUTS, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind,field_mode,kernel", [
    ("qubo", "dense", "K1"), ("partition", "dense", "K1"),
    ("mis", "popcount", "K2"), ("coloring", "popcount", "K2"),
])
def test_anneal_families_on_card_match_dense(cuda_device, kind, field_mode, kernel):
    """Encoded problems through anneal() on K1 and K2 equal the dense
    backend on the card, with one launch per plateau (K1) or chain (K2)."""
    from repro_torch.problems import make_demo

    enc = make_demo(kind, n=300, seed=1)
    hp = SSAHyperParams(n_trials=9, m_shot=2, tau=10, i0_max=8)
    k1, k2 = ssa_update.ssa_plateau_packed_batched, ssa_update.ssa_plateau_popcount_batched
    before = (k1.launches, k2.launches)
    got = anneal(enc, hp, seed=2, track_energy=False, device="cuda",
                 config=SolverConfig(backend="cuda", noise="xorshift", field_mode=field_mode))
    grown = (k1.launches - before[0], k2.launches - before[1])
    assert grown == ((hp.m_shot * hp.steps, 0) if kernel == "K1" else (0, hp.m_shot))
    want = anneal(enc, hp, seed=2, track_energy=False, device="cuda",
                  config=SolverConfig(backend="dense", noise="xorshift"))
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)


@pytest.mark.cuda
def test_sa_and_ptssa_on_card_launch_no_kernel_and_match_cpu(cuda_device):
    from repro_torch.core.pt import PTSSAHyperParams, anneal_pt_ssa
    from repro_torch.core.sa import SAHyperParams, anneal_sa

    p = gset.complete_graph(300, seed=3)
    counters = (ssa_update.ssa_plateau_packed_batched, ssa_update.ssa_plateau_batched,
                ssa_update.ssa_plateau_popcount_batched, ssa_update.local_field)
    before = [k.launches for k in counters]
    for run in (lambda d: anneal_sa(p, SAHyperParams(n_trials=10, n_cycles=500), seed=1,
                                    device=d),
                lambda d: anneal_pt_ssa(p, PTSSAHyperParams(n_rounds=3, tau=20), seed=1,
                                        backend="dense", device=d)):
        got, want = run("cuda"), run("cpu")
        np.testing.assert_array_equal(got.best_energy, want.best_energy)
        np.testing.assert_array_equal(got.best_m, want.best_m)
    assert [k.launches for k in counters] == before


# ---------------------------------------------------------------------------
# SSQA: the ring modes of K1 and K2 against their plain versions
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("b,r,n,c,nr,flat,cs,dtype", [
    (1, 8, 36, 5, 4, False, None, "float32"), (1, 6, 100, 7, 2, False, None, "float32"),
    (2, 9, 1001, 3, 3, False, None, "float32"), (1, 10, 70, 6, 5, True, None, "float32"),
    (1, 32, 257, 4, 16, False, None, "float32"), (1, 32, 64, 3, 32, False, None, "float32"),
    (1, 96, 2000, 4, 8, False, None, "float32"), (1, 96, 2000, 4, 8, False, None, "bfloat16"),
    (2, 32, 1001, 5, 8, False, 8, "bfloat16"),
    # N above the sign table's 2048 k, in several column tiles of a block
    (1, 8, 2100, 2, 4, False, 1, "float32"), (1, 8, 2101, 2, 8, False, 2, "float32"),
    (1, 8, 4100, 1, 8, False, None, "bfloat16"),
] + [(2, 32, 1001, 5, nr, False, cs, "float32")  # every cluster size, a ragged last word
     for nr in (2, 8, 16) for cs in (1, 2, 4, 8, 16)] + [
    # rings above 32 replicas: two words, a ragged word, one ring; the words
    # in global memory (N = 6000, rings of 128); other J dtypes
    (1, 128, 2000, 3, 64, False, None, "float32"), (1, 66, 1001, 3, 33, False, None, "int8"),
    (1, 100, 2000, 2, 100, False, 4, "float16"), (2, 64, 1001, 2, 64, False, 2, "uint8"),
    (1, 128, 6000, 1, 128, False, None, "float32"), (1, 96, 2000, 3, 8, False, None, "int16"),
    (1, 96, 2000, 3, 8, False, None, "int32"),
])
@pytest.mark.parametrize("eligible", [True, False])
def test_plateau_ring_kernel_matches_plain(cuda_device, b, r, n, c, nr, flat, cs, dtype,
                                           eligible):
    """K1's ring mode: N % 4 == 0 reads four neighbouring columns of J per
    load, other N one; J in each of the seven dtypes; rings of any size,
    their words in shared memory or, where they do not fit, in global
    memory (``ring_variant``)."""
    args = _plateau_args(b, r, n, seed=n + c + nr, flat=flat, device=cuda_device)
    args["J"] = args["J"].to(getattr(torch, dtype))
    kw = dict(i0=8, n_cycles=c, eligible=eligible, jperp=3, n_replicas=nr)
    before = (ssa_update.ssa_plateau_packed_batched.launches,
              ssa_update.ssa_plateau_packed_batched.ring_launches)
    got = ssa_update.ssa_plateau_packed_batched(**args, **kw, cluster_size=cs)
    assert (ssa_update.ssa_plateau_packed_batched.launches,
            ssa_update.ssa_plateau_packed_batched.ring_launches) == (before[0] + 1,
                                                                     before[1] + 1)
    launched_cs, blocks = ssa_update.ssa_plateau_packed_batched.last_cluster
    assert cs is None or launched_cs == cs
    assert blocks == b * (r // nr) * launched_cs
    assert (ssa_update.ssa_plateau_packed_batched.last_ring_variant
            == ssa_update.ring_variant(n, nr, launched_cs))
    want = ssa_plateau_packed_ref(**args, **kw)
    for name, g, w in zip(OUTS, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,n,w_max,c,nr,cs", [
    (1, 8, 37, 7, 30, 4, None), (1, 6, 100, 1, 40, 2, None), (2, 9, 1001, 3, 9, 3, None),
    (1, 32, 800, 1, 20, 16, None), (1, 32, 64, 1, 12, 32, None), (1, 96, 2000, 1, 60, 8, None),
    (1, 96, 2000, 1, 30, 16, None),   # rings of 16: two passes a cycle
    (1, 100, 2000, 1, 20, 10, None),  # rings of 10: a ragged second pass
    (1, 100, 2000, 1, 20, 4, None),   # 25 rings of 4: streamed planes
    (1, 3, 2000, 1, 20, 3, None),     # one ring below a group of 8
    (1, 32, 2000, 1, 12, 32, 8),      # rings of 32 in clusters of 8: streamed
    (2, 16, 4100, 7, 6, 8, None),     # streamed planes: 4 planes of 129 words
    (1, 32, 30000, 0, 3, 32, None),   # the spin words in global memory too
] + [(1, 96, 2000, 1, 20, nr, cs)    # every cluster size at rings of 8 and 16
     for nr in (8, 16) for cs in (1, 2, 4, 8, 16)] + [
    # rings above 32 replicas
    (1, 128, 2000, 1, 12, 64, None), (1, 100, 2000, 1, 12, 100, None),
    (1, 66, 1001, 3, 9, 33, None), (1, 64, 30000, 0, 3, 64, None), (1, 64, 2000, 1, 12, 64, 1),
])
def test_popcount_ring_kernel_matches_plain(cuda_device, b, r, n, w_max, c, nr, cs):
    args = _popcount_args(b, r, n, w_max, c, "random", False, seed=n + c + nr,
                          device=cuda_device)
    jperp = torch.as_tensor(np.random.default_rng(c).integers(0, 6, c), dtype=torch.int32,
                            device=cuda_device)
    laid_out = ssa_update.popcount_planes(PackedJ(args["sign"], args["mags"], args["base"]))
    want = ssa_plateau_popcount_ref(**args, n_rnd=2, jperp_sched=jperp, n_replicas=nr)
    for x in (args, dict(args, sign=laid_out.sign, mags=laid_out.mags)):
        before = ssa_update.ssa_plateau_popcount_batched.ring_launches
        got = ssa_update.ssa_plateau_popcount_batched(**x, n_rnd=2, jperp_sched=jperp,
                                                      n_replicas=nr, cluster_size=cs)
        assert ssa_update.ssa_plateau_popcount_batched.ring_launches == before + 1
        _check_popcount_launch(b, r, n, args["mags"].shape[1], cs, nr)
        for name, g, w in zip(OUTS, got, want):
            assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("field_mode", ["dense", "popcount"])
def test_anneal_ssqa_matches_dense_on_card(cuda_device, layout, field_mode):
    from repro_torch.core.ssqa import SSQAHyperParams, anneal_ssqa

    p = gset.complete_graph(300, seed=7)
    hp = SSQAHyperParams(n_trials=8, n_replicas=4, m_shot=2, tau=6, i0_max=8, jperp_max=3)
    k1, k2 = ssa_update.ssa_plateau_packed_batched, ssa_update.ssa_plateau_popcount_batched
    before = (k1.launches, k1.ring_launches, k2.launches, k2.ring_launches)
    got = anneal_ssqa(p, hp, seed=3, track_energy=False, device="cuda",
                      config=SolverConfig(backend="cuda", noise="xorshift",
                                          field_mode=field_mode, storage_layout=layout))
    after = (k1.launches, k1.ring_launches, k2.launches, k2.ring_launches)
    ring_plateaus = hp.m_shot * (hp.steps - 1)  # every plateau but the J⊥ = 0 one
    counts = tuple(a - b for a, b in zip(after, before))
    if field_mode == "dense":
        assert counts == (hp.m_shot * hp.steps, ring_plateaus, 0, 0)
    else:
        assert counts == (0, 0, hp.m_shot, hp.m_shot)
    want = anneal_ssqa(p, hp, seed=3, track_energy=False, device="cuda",
                       config=SolverConfig(backend="dense", noise="xorshift",
                                           storage_layout=layout))
    np.testing.assert_array_equal(got.best_energy, want.best_energy)
    np.testing.assert_array_equal(got.best_m, want.best_m)


# ---------------------------------------------------------------------------
# The batched cuda backend and the service at B > 1
# ---------------------------------------------------------------------------
_BATCHED = {"k1": {}, "k4": {"noise_mode": "pregen"}, "k2": {"field_mode": "popcount"},
            "k1-ring": {"n_replicas": 4}, "k2-ring": {"field_mode": "popcount", "n_replicas": 4}}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(_BATCHED))
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_batched_cuda_backend_matches_its_plain_version(cuda_device, path, layout):
    """BatchedCudaBackend at B = 4 (mixed sizes in one bucket) on the card
    equals the same backend on the CPU, where the wrappers run the plain
    versions, and launches each kernel once per plateau (K1, K4) or per
    iteration's chain (K2) for all four problems."""
    from repro_torch.core.ssqa import SSQAHyperParams

    opts = dict(_BATCHED[path])
    nr = opts.get("n_replicas", 0)
    hp = (SSQAHyperParams(n_trials=8, n_replicas=nr, m_shot=2, tau=5, i0_max=8, jperp_max=2)
          if nr else SSAHyperParams(n_trials=7, m_shot=2, tau=5, i0_max=8))
    probs = [gset.toroidal_grid(200, seed=1), gset.king_graph(196, seed=2),
             gset.complete_graph(150, seed=3), gset.toroidal_grid(256, seed=4)]
    plateaus = engine.schedule_plateaus(hp.schedule(), "i0max")
    out = {}
    for dev in ("cpu", "cuda"):
        bk = engine.make_batched_backend("cuda", n_bucket=256, n_trials=hp.n_trials,
                                         noise="xorshift", storage_layout=layout, device=dev,
                                         **opts)
        prob = bk.stack([p.to_ising() for p in probs])
        st = bk.init_state(prob, bk.init_noise([0, 1, 2, 3], [p.n for p in probs]))
        before = (ssa_update.ssa_plateau_packed_batched.launches,
                  ssa_update.ssa_plateau_batched.launches,
                  ssa_update.ssa_plateau_popcount_batched.launches)
        st = bk.run_shots(prob, st, plateaus, hp.m_shot)
        out[dev] = [t.cpu() for t in bk.finalize(st)]
        launched = (ssa_update.ssa_plateau_packed_batched.launches - before[0],
                    ssa_update.ssa_plateau_batched.launches - before[1],
                    ssa_update.ssa_plateau_popcount_batched.launches - before[2])
    k = hp.m_shot * len(plateaus)
    assert launched == {"k1": (k, 0, 0), "k1-ring": (k, 0, 0), "k4": (0, k, 0),
                        "k2": (0, 0, hp.m_shot), "k2-ring": (0, 0, hp.m_shot)}[path]
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{}, {"field_mode": "auto"}, {"noise_mode": "pregen"}],
                         ids=["k1", "k2", "k4"])
def test_service_matches_per_request_anneal_on_card(cuda_device, opts):
    from repro_torch.serve import AnnealRequest, AnnealService

    probs = [gset.toroidal_grid(200, seed=1), gset.king_graph(196, seed=2),
             gset.toroidal_grid(250, seed=3)]
    hp = SSAHyperParams(n_trials=9, m_shot=4, tau=5, i0_max=8)
    svc = AnnealService(backend="cuda", min_bucket=16, chunk_shots=2, backend_opts=opts)
    resp = svc.solve([AnnealRequest(problem=p, hp=hp, seed=s) for s, p in enumerate(probs)])
    cfg = SolverConfig(backend="cuda", noise="xorshift",
                       noise_mode=opts.get("noise_mode", "auto"),
                       field_mode=opts.get("field_mode", "auto"))
    for s, (p, r) in enumerate(zip(probs, resp)):
        assert r.status == "ok" and not r.events and r.batch == 3 and r.bucket == 256
        ref = anneal(p, hp, seed=s, track_energy=False, config=cfg, device="cuda")
        np.testing.assert_array_equal(r.result.best_energy, ref.best_energy)
        np.testing.assert_array_equal(r.result.best_m, ref.best_m)


# ---------------------------------------------------------------------------
# On the card: a one-rank NCCL spin run equals the K2 run (no kernel launch)
# ---------------------------------------------------------------------------
CUDA_SCRIPT = textwrap.dedent("""
    import numpy as np, torch
    from repro_torch.core import gset
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.ssa import SSAHyperParams, anneal
    from repro_torch.kernels import ssa_update
    from repro_torch.sharding import spin_mesh
    mesh = spin_mesh(1)
    assert mesh.backend == "nccl"
    p = gset.load("K2000")
    hp = SSAHyperParams(n_trials=16, m_shot=1, tau=20, i0_min=1, i0_max=32)
    ref = anneal(p, hp, seed=0, track_energy=False, config=SolverConfig(
        backend="cuda", noise="xorshift", field_mode="popcount"))
    k2 = ssa_update.ssa_plateau_popcount_batched.launches
    got = anneal(p, hp, seed=0, track_energy=False, config=SolverConfig(
        backend="cuda", noise="xorshift", field_mode="popcount", partition="spin", mesh=mesh))
    assert ssa_update.ssa_plateau_popcount_batched.launches == k2
    assert np.array_equal(ref.best_energy, got.best_energy)
    assert np.array_equal(ref.best_m, got.best_m)
    torch.distributed.destroy_process_group()
    print("NCCL_OK")
""")


@pytest.mark.cuda
def test_nccl_one_rank_spin_equals_k2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (an NCCL group runs on the card)")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", CUDA_SCRIPT], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0 and "NCCL_OK" in proc.stdout, proc.stderr[-3000:]
