"""Spatially-uniform keypoint selection: per-cell top-k + budgeted global pick.

JAX replacement for ``ORBextractor::DistributeOctTree``
(jni/ORB_SLAM2/src/ORBextractor.cc:494-776). The reference builds a sequential
quadtree that splits nodes until there are ~nfeatures of them, keeping the
best-response corner per node — a pointer-chasing loop with no dense array
form. The array-parallel equivalent of its spatial-uniformity goal:

1. partition the image into fixed cells;
2. take the top-k responses per cell (vectorized ``top_k`` over cells);
3. order candidates by (per-cell rank, response) and keep the global budget —
   every cell contributes its best corner before any cell contributes its
   second, which is exactly the uniformity the quadtree converges to.

The dual FAST threshold (20 with per-cell fallback to 7 —
ORBextractor.cc:827-833) is folded in by boosting the priority of responses
above the high threshold, so high-threshold corners always win within a cell
but weak cells still contribute their best low-threshold corner.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Priority bonus separating "passes high threshold" candidates from fallback
# candidates; larger than any FAST score (scores are bounded by 255).
_HIGH_BONUS = 1024.0
# Rank penalty separating per-cell ranks in the global pick; larger than any
# single-candidate priority (score + bonus < 2048).
_RANK_PENALTY = 4096.0


def select_keypoints(
    score: jnp.ndarray,
    budget: int,
    cell_size: int = 32,
    per_cell_cap: int = 4,
    high_threshold: float = 20.0,
    low_threshold: float = 7.0,
    margin: int = 19,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Select up to `budget` keypoints from a dense response map.

    Args:
      score: (H, W) response map (0 = not a corner), typically NMS'd FAST.
      budget: number of keypoints to return (static).
      cell_size: spatial uniformity granularity (ref: 30px cells and ~1 kp
        per quadtree node; ORBextractor.cc:784).
      per_cell_cap: max keypoints a single cell may contribute.
      high_threshold / low_threshold: FAST dual thresholds (20/7).
      margin: exclusion border in px (EDGE_THRESHOLD=19,
        ORBextractor.cc:79 — descriptor pattern must stay inside).

    Returns:
      xy: (budget, 2) float32 keypoint coords (x, y) in this image's frame.
      resp: (budget,) float32 responses.
      valid: (budget,) bool.
    """
    h, w = score.shape
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    inside = (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)
    score = jnp.where(inside & (score > low_threshold), score, 0.0)

    # Pad to a whole number of cells (padding scores are 0 = invalid).
    ncy = -(-h // cell_size)
    ncx = -(-w // cell_size)
    padded = jnp.zeros((ncy * cell_size, ncx * cell_size), dtype=score.dtype)
    padded = padded.at[:h, :w].set(score)

    cells = padded.reshape(ncy, cell_size, ncx, cell_size)
    cells = cells.transpose(0, 2, 1, 3).reshape(ncy * ncx, cell_size * cell_size)

    # Within-cell priority: high-threshold corners dominate low-threshold ones.
    prio = jnp.where(cells > high_threshold, cells + _HIGH_BONUS, cells)
    k = min(per_cell_cap, cell_size * cell_size)
    cell_vals, cell_idx = jax.lax.top_k(prio, k)  # (ncells, k)

    # Decode flat in-cell index -> global (y, x).
    cy = jnp.arange(ncy * ncx) // ncx
    cx = jnp.arange(ncy * ncx) % ncx
    in_y = cell_idx // cell_size
    in_x = cell_idx % cell_size
    gy = cy[:, None] * cell_size + in_y
    gx = cx[:, None] * cell_size + in_x

    # Global pick: all rank-0 candidates first, then rank-1, ... with response
    # as the tie-break inside a rank class.
    rank = jnp.broadcast_to(jnp.arange(k)[None, :], cell_vals.shape)
    global_prio = jnp.where(
        cell_vals > 0.0, cell_vals - rank.astype(cell_vals.dtype) * _RANK_PENALTY,
        -jnp.inf,
    )
    flat_prio = global_prio.reshape(-1)
    flat_y = gy.reshape(-1)
    flat_x = gx.reshape(-1)

    # budget can exceed the candidate pool on tiny images: pad with -inf
    if flat_prio.shape[0] < budget:
        pad = budget - flat_prio.shape[0]
        flat_prio = jnp.concatenate([flat_prio, jnp.full(pad, -jnp.inf)])
        flat_y = jnp.concatenate([flat_y, jnp.zeros(pad, flat_y.dtype)])
        flat_x = jnp.concatenate([flat_x, jnp.zeros(pad, flat_x.dtype)])
    top_vals, top_idx = jax.lax.top_k(flat_prio, budget)
    sel_y = flat_y[top_idx]
    sel_x = flat_x[top_idx]
    valid = jnp.isfinite(top_vals)
    resp = jnp.where(
        valid,
        padded[sel_y, sel_x],
        0.0,
    )
    xy = jnp.stack([sel_x.astype(jnp.float32), sel_y.astype(jnp.float32)], axis=-1)
    return xy, resp, valid
