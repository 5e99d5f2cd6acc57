// Shared by the SSQA ring-mode kernels: ring_kernel (K1, plateau.cu) and
// popcount_ring_kernel (K2, popcount.cu).
//
// A ring may hold any number of replicas R that divides the trials, as in
// the JAX package.  Both ring modes run a ring as one thread-block cluster.
// K1 keeps the ring's spins of one column as ceil(R / 32) words (bit t of
// word w = replica 32w + t); K2 keeps the ring's words [Nw][R rounded up to
// 8].  Both keep each replica's running best, flags and energy shares in
// arrays of R entries in dynamic shared memory, so a block's shared memory
// grows with R; where a ring's words do not fit it, they go to global memory
// (one copy per cluster), chosen by size in ssa_update.py.
#pragma once

// Replicas accumulated per pass over J (K1) or over the planes (K2): a
// ring takes ceil(R / RING_G) passes per cycle, and each thread keeps
// RING_G accumulators.  A pass never straddles two of K1's words.
constexpr int RING_G = 8;
static_assert(32 % RING_G == 0, "a pass lies inside one 32-replica word");
