// Shared by the SSQA ring-mode kernels: ring_kernel (K1, plateau.cu) and
// popcount_ring_kernel (K2, popcount.cu).
#pragma once

// The most replicas one ring may hold.  Both ring modes run a ring as one
// thread-block cluster.  K1 keeps the ring's spins of one column as the
// bits of one 32-bit word in every block of the cluster; K2 keeps the
// ring's words [Nw][R] in every block, and both exchange each replica's
// energy share in a [parity][cluster size][MAX_RING] array.  The Python
// wrappers read this line (ssa_update.MAX_RING) and validate every call
// against it; the C entry points keep only a guard.
constexpr int MAX_RING = 32;

// Replicas accumulated per pass over J (K1) or over the planes (K2): a
// ring takes ceil(R / RING_G) passes per cycle, and each thread keeps
// RING_G accumulators.
constexpr int RING_G = 8;
