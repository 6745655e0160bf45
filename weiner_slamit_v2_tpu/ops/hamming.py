"""Hamming distance on packed 256-bit descriptors (XOR + popcount).

JAX replacement for ``ORBmatcher::DescriptorDistance``
(jni/ORB_SLAM2/src/ORBmatcher.cc:1651-1667, the classic parallel-bit-count).
With XLA's ``population_count`` the full N1 x N2 distance matrix is one
fused elementwise+reduce program, which replaces every scalar
brute-force loop in the reference matcher.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INVALID_DIST = 10_000  # larger than any possible 256-bit distance


def hamming_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise distance of equally-shaped packed descriptors (..., 8)."""
    x = jax.lax.population_count(jnp.bitwise_xor(a, b))
    return jnp.sum(x, axis=-1).astype(jnp.int32)


def distance_matrix(d1: jnp.ndarray, d2: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distances.

    d1: (N1, 8) uint32, d2: (N2, 8) uint32 -> (N1, N2) int32 in [0, 256].
    """
    x = jnp.bitwise_xor(d1[:, None, :], d2[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def masked_distance_matrix(
    d1: jnp.ndarray,
    d2: jnp.ndarray,
    valid1: jnp.ndarray,
    valid2: jnp.ndarray,
    pair_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Distance matrix with invalid rows/cols/pairs forced to INVALID_DIST."""
    dist = distance_matrix(d1, d2)
    mask = valid1[:, None] & valid2[None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    return jnp.where(mask, dist, INVALID_DIST)


def _packed_min(dist: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(argmin, min) along axis 1 via a single packed min-reduction.

    Packing ``value * n + index`` into one int32 makes the row reduction a
    single plain min instead of a variadic (value, index) reduce. Distances are
    bounded by INVALID_DIST (10_000), so value*n+idx < 2^31 for n up to 2^17.
    Ties break toward the smaller column index, same as argmin/top_k.
    """
    n2 = dist.shape[1]
    idx = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    code = dist.astype(jnp.int32) * n2 + idx
    m = jnp.min(code, axis=1)
    return m % n2, m // n2


def mutual_best(dist: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mutual nearest-neighbor matches from a distance matrix.

    Returns (match_idx (N1,) int32 — index into axis 1 or -1, best_dist (N1,)).
    Mirrors the mutual-best check in SearchForInitialization
    (jni/ORB_SLAM2/src/ORBmatcher.cc:497-506).
    """
    fwd, best = _packed_min(dist)
    bwd, _ = _packed_min(dist.T)
    n1 = dist.shape[0]
    rows = jnp.arange(n1)
    mutual = bwd[fwd] == rows
    ok = mutual & (best < INVALID_DIST)
    return jnp.where(ok, fwd, -1), best


def best_and_second(
    dist: jnp.ndarray, axis: int = 1
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(best_idx, best_dist, second_dist) along an axis — the inputs of the
    reference's ratio tests (e.g. ORBmatcher.cc:500: best < ratio * second)."""
    if axis == 0:
        dist = dist.T
    n2 = dist.shape[1]
    best_i, best = _packed_min(dist)
    cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    masked = jnp.where(
        cols == best_i[:, None], jnp.int32(INVALID_DIST + 1), dist.astype(jnp.int32)
    )
    _, second = _packed_min(masked)
    return best_i, best, second
