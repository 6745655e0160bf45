"""Keypoint patch extraction + in-patch sampling as batched matmuls.

Instead of a 2-D advanced-indexing gather ``image[yy, xx]`` of (N, 31, 31)
pixels, patch access is split into dense steps:

1. **Row gather**: ``image[yy]`` pulls whole contiguous rows.
2. **Column select as a one-hot matmul**: selecting columns ``x0+d`` from the
   gathered rows is a batched (P, W) @ (W, P) contraction with a one-hot
   matrix.
3. **In-patch rotated sampling** (for steered BRIEF) is two more tiny one-hot
   contractions against the (P, P) patch — never touching the full image.

This replaces the reference's scalar per-pixel loops in ``IC_Angle`` and
``computeOrbDescriptor`` (jni/ORB_SLAM2/src/ORBextractor.cc:82-152) with
three matmuls; the same trick is the backbone of both keypoint orientation
and descriptor extraction (see ops/orb.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def extract_patches(image: jnp.ndarray, xy: jnp.ndarray, half: int) -> jnp.ndarray:
    """Gather square patches around integer keypoint coords.

    image: (H, W); xy: (N, 2) float (x, y). Returns (N, 2*half+1, 2*half+1).
    Coordinates are clamped to the image; callers enforce the edge margin so
    clamping never occurs for valid keypoints (EDGE_MARGIN=19 > half=15).
    """
    h, w = image.shape
    x0 = jnp.round(xy[:, 0]).astype(jnp.int32)
    y0 = jnp.round(xy[:, 1]).astype(jnp.int32)
    d = jnp.arange(-half, half + 1, dtype=jnp.int32)

    yy = jnp.clip(y0[:, None] + d[None, :], 0, h - 1)          # (N, P)
    rows = image[yy]                                            # (N, P, W)
    cols = jnp.clip(x0[:, None] + d[None, :], 0, w - 1)         # (N, P)
    onehot = (
        cols[:, None, :] == jnp.arange(w, dtype=jnp.int32)[None, :, None]
    ).astype(image.dtype)                                       # (N, W, P)
    # patches[n, r, c] = rows[n, r, cols[n, c]]
    return jax.lax.dot_general(
        rows,
        onehot,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )


def sample_in_patch(
    patches: jnp.ndarray, sx: jnp.ndarray, sy: jnp.ndarray
) -> jnp.ndarray:
    """Sample per-keypoint integer offsets inside extracted patches.

    patches: (N, P, P) with patch center at (half, half);
    sx, sy: (N, S) int32 offsets relative to the center, |offset| <= half.
    Returns (N, S) sampled values: patches[n, half+sy, half+sx].
    """
    n, p, _ = patches.shape
    half = (p - 1) // 2
    ar = jnp.arange(p, dtype=jnp.int32)
    ry = jnp.clip(sy + half, 0, p - 1)                          # (N, S)
    rx = jnp.clip(sx + half, 0, p - 1)
    row_onehot = (ry[:, :, None] == ar[None, None, :]).astype(patches.dtype)
    # rowvals[n, s, c] = patches[n, ry[n, s], c]
    rowvals = jax.lax.dot_general(
        row_onehot,
        patches,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )                                                           # (N, S, P)
    col_mask = rx[:, :, None] == ar[None, None, :]
    return jnp.sum(jnp.where(col_mask, rowvals, 0.0), axis=2)   # (N, S)
