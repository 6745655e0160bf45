"""Plain numpy references for the per-pixel and per-pair stages.

Written independently of the JAX code they check (explicit slicing instead
of rolled copies, a byte-table popcount instead of ``population_count``), so
that the tests and ``chip_smoke.py`` can hold the compiled device programs
to them: ``fast9_nms`` for ``ops.fast.fast_score_nms`` and
``windowed_best2`` for ``frontend.matcher.windowed_best2``.
"""

from __future__ import annotations

import numpy as np

from .fast import _CIRCLE

INVALID_DIST = 10_000

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def fast9_nms(image: np.ndarray, threshold: float) -> np.ndarray:
    """FAST-9/16 score (the largest threshold at which a 9-long contiguous
    arc of the 16-pixel ring is all brighter or all darker than the centre)
    where it exceeds `threshold`, 0 elsewhere and on the 3-px border; then
    3x3 non-max suppression that keeps a pixel strictly above its earlier
    raster neighbours and at least equal to its later ones."""
    img = np.asarray(image, np.float32)
    h, w = img.shape
    c = img[3 : h - 3, 3 : w - 3]
    ring = np.stack(
        [img[3 + dy : h - 3 + dy, 3 + dx : w - 3 + dx] for dy, dx in _CIRCLE]
    )
    score = np.zeros_like(c)
    for diffs in (ring - c, c - ring):
        for start in range(16):
            arc = diffs[[(start + k) % 16 for k in range(9)]].min(axis=0)
            score = np.maximum(score, arc)
    full = np.zeros_like(img)
    full[3 : h - 3, 3 : w - 3] = np.where(score > threshold, score, 0.0)

    pad = np.pad(full, 1)
    keep = full > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            keep &= (full > nb) if (dy, dx) < (0, 0) else (full >= nb)
    return np.where(keep, full, 0.0).astype(np.float32)


def hamming_matrix(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """All-pairs Hamming distances of packed (N, 8) uint32 descriptors."""
    b1 = np.ascontiguousarray(d1, np.uint32).view(np.uint8)
    b2 = np.ascontiguousarray(d2, np.uint32).view(np.uint8)
    return _POPCOUNT8[b1[:, None, :] ^ b2[None, :, :]].sum(axis=-1)


def windowed_best2(
    desc1, desc2, valid1, valid2, pred_xy, xy2, window, oct_lo, oct_hi,
    octave2, chi2_w, chi2_th,
):
    """Brute-force (best_idx, best_dist, second_dist) over the gated columns;
    see ``frontend.matcher.windowed_best2`` for the gates. Ties in the best
    distance go to the lowest column index."""
    pred_xy = np.asarray(pred_xy, np.float32)
    xy2 = np.asarray(xy2, np.float32)
    du = xy2[None, :, 0] - pred_xy[:, None, 0]
    dv = xy2[None, :, 1] - pred_xy[:, None, 1]
    win = np.asarray(window, np.float32)[:, None]
    gate = (np.abs(du) < win) & (np.abs(dv) < win)
    o2 = np.asarray(octave2)[None, :]
    gate &= (o2 >= np.asarray(oct_lo)[:, None]) & (o2 <= np.asarray(oct_hi)[:, None])
    gate &= np.asarray(valid1)[:, None] & np.asarray(valid2)[None, :]
    chi2 = (du * du + dv * dv) * np.asarray(chi2_w, np.float32)[None, :]
    gate &= chi2 <= np.float32(chi2_th)
    dist = np.where(gate, hamming_matrix(desc1, desc2), INVALID_DIST)
    best_idx = dist.argmin(axis=1)
    rows = np.arange(dist.shape[0])
    best = dist[rows, best_idx]
    rest = dist.copy()
    rest[rows, best_idx] = INVALID_DIST + 1
    second = np.minimum(rest.min(axis=1), INVALID_DIST)
    return best_idx, best, second
