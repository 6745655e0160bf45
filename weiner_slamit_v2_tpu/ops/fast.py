"""FAST-16 corner detection as dense vectorized array ops.

JAX replacement for the reference's per-cell OpenCV ``cv::FAST``
calls (jni/ORB_SLAM2/src/ORBextractor.cc:778-873, ComputeKeyPointsOctTree).
Instead of scalar pixel loops, the detector computes the full corner-response
map with 16 shifted copies of the image, takes windowed min/max over the
circular ring, scores with the exact max-threshold definition, and applies
3x3 non-max suppression — all dense, batched, and jit-compiled; XLA fuses the
shifted reads and the arc chain into a few elementwise loops.

The dual-threshold behavior (th=20, retry th=7 in empty cells —
ORBextractor.cc:827-833) is reproduced downstream in the per-cell selection
(see ops/topk_grid.py) using the fact that the FAST *score* equals the
maximum threshold at which a pixel remains a corner: detect once at the low
threshold and prefer score>high per cell.
"""

from __future__ import annotations

import jax.numpy as jnp

# Bresenham circle of radius 3: 16 (dy, dx) offsets in clockwise order
# (the standard FAST-16 ring).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # contiguous arc length for FAST-9/16 (OpenCV default)


def _ring(image: jnp.ndarray) -> jnp.ndarray:
    """Stack the 16 ring neighbors: (16, H, W) via rolled copies."""
    return jnp.stack(
        [jnp.roll(image, shift=(-dy, -dx), axis=(0, 1)) for dy, dx in _CIRCLE]
    )


def _arc_min(diffs: jnp.ndarray) -> jnp.ndarray:
    """max over the 16 arc windows of (min over the 9-long window).

    diffs: (16, H, W). Returns (H, W): the best (largest) over all contiguous
    9-arcs of the smallest difference in the arc — i.e. the exact max
    threshold at which the arc survives (OpenCV's FAST score semantics).
    """
    # windowed min of length 9 along the circular axis 0 via log-step mins
    m3 = jnp.minimum(jnp.minimum(diffs, jnp.roll(diffs, -1, 0)), jnp.roll(diffs, -2, 0))
    m9 = jnp.minimum(jnp.minimum(m3, jnp.roll(m3, -3, 0)), jnp.roll(m3, -6, 0))
    return jnp.max(m9, axis=0)


def fast_score(image: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST-9/16 response map.

    Returns (H, W) float32: 0 where not a corner at `threshold`, else the
    max-threshold score (strictly > threshold). Border of 3 px is zero.
    """
    ring = _ring(image)
    center = image[None]
    # score = max over arcs of (min |diff| in arc); a pixel is a FAST corner
    # at threshold t exactly when score > t, so one dense score map serves
    # both the detection test and the dual-threshold cell selection.
    score_bright = _arc_min(ring - center)   # > t iff a bright arc exists at t
    score_dark = _arc_min(center - ring)
    score = jnp.maximum(score_bright, score_dark)
    is_corner = score > threshold

    h, w = image.shape
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)

    return jnp.where(is_corner & interior, score, 0.0)


def nms_3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression: keep strict local maxima (ties broken toward
    the top-left pixel to avoid double detections on plateaus)."""
    # strict > against earlier-in-raster-order neighbors, >= against later
    # ones, so exactly one pixel survives on score plateaus.
    prev = [
        jnp.roll(score, shift=(-dy, -dx), axis=(0, 1))
        for dy, dx in ((-1, -1), (-1, 0), (-1, 1), (0, -1))
    ]
    nxt = [
        jnp.roll(score, shift=(-dy, -dx), axis=(0, 1))
        for dy, dx in ((0, 1), (1, -1), (1, 0), (1, 1))
    ]
    keep = (score > 0)
    for p in prev:
        keep &= score > p
    for n in nxt:
        keep &= score >= n
    return jnp.where(keep, score, 0.0)


def fast_score_nms(image: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST score map followed by 3x3 NMS: the per-level detector of the
    extractor (nonzero exactly at the kept corners, valued by their score)."""
    return nms_3x3(fast_score(image, threshold))
