"""Descriptor matching as masked batched reductions.

JAX replacement for ``ORBmatcher``
(jni/ORB_SLAM2/src/ORBmatcher.cc). Every reference routine is a scalar loop
over keypoints with a grid lookup (Frame::GetFeaturesInArea); here each
becomes one masked N1 x N2 Hamming matrix + argmin/ratio/rotation-histogram
reductions. The 64x48 feature grid is not needed: the full masked distance
matrix (1024^2 x 8 uint32 XORs) is one elementwise+reduce program into which
XLA fuses the window masks.

Thresholds follow the reference exactly: TH_LOW=50, TH_HIGH=100,
HISTO_LENGTH=30, per-call-site NN ratios (SURVEY.md Appendix A, Matching).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import hamming
from ..ops.hamming import INVALID_DIST

TH_LOW = 50       # ORBmatcher.cc:37
TH_HIGH = 100     # ORBmatcher.cc:38
HISTO_LENGTH = 30  # ORBmatcher.cc:39


def rotation_consistency_mask(
    angle1: jnp.ndarray,
    angle2_matched: jnp.ndarray,
    match_valid: jnp.ndarray,
    n_bins: int = HISTO_LENGTH,
) -> jnp.ndarray:
    """Keep only matches whose rotation offset falls in the 3 dominant bins.

    Mirrors ComputeThreeMaxima + the bin filter
    (jni/ORB_SLAM2/src/ORBmatcher.cc:1605-1646 and call sites): bins 2 and 3
    are kept only if >= 0.1x the max bin.
    """
    two_pi = 2.0 * jnp.pi
    rot = jnp.mod(angle1 - angle2_matched, two_pi)  # [0, 2pi)
    bins = jnp.clip((rot * n_bins / two_pi).astype(jnp.int32), 0, n_bins - 1)
    counts = jnp.zeros(n_bins, dtype=jnp.int32).at[bins].add(
        match_valid.astype(jnp.int32)
    )
    order = jnp.argsort(-counts)
    top3 = order[:3]
    c1 = counts[top3[0]]
    keep_bins = jnp.stack(
        [
            top3[0],
            jnp.where(counts[top3[1]] >= 0.1 * c1, top3[1], -1),
            jnp.where(counts[top3[2]] >= 0.1 * c1, top3[2], -1),
        ]
    )
    in_top = (
        (bins == keep_bins[0]) | (bins == keep_bins[1]) | (bins == keep_bins[2])
    )
    return match_valid & in_top


def match_with_window(
    desc1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid1: jnp.ndarray,
    valid2: jnp.ndarray,
    pred_xy: jnp.ndarray,
    xy2: jnp.ndarray,
    window: jnp.ndarray | float,
    max_dist: int = TH_LOW,
    nn_ratio: float = 0.9,
    octave2: jnp.ndarray | None = None,
    octave_lo: jnp.ndarray | None = None,
    octave_hi: jnp.ndarray | None = None,
    mutual: bool = False,
    angle1: jnp.ndarray | None = None,
    angle2: jnp.ndarray | None = None,
    histo_bins: int = HISTO_LENGTH,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Generic windowed matcher: for each row i of set 1 find the best column
    j of set 2 with |xy2[j] - pred_xy[i]|_inf < window[i].

    This one routine, parameterized, covers the reference's four
    SearchByProjection overloads and SearchForInitialization — they differ
    only in where `pred_xy` comes from, the window size, octave gates, ratio,
    and whether mutual-best/rotation checks apply.

    Returns (match_idx (N1,) int32 into set 2 or -1, match_dist (N1,) int32).
    """
    n1 = desc1.shape[0]
    window = jnp.broadcast_to(jnp.asarray(window, dtype=jnp.float32), (n1,))

    dxy = jnp.abs(xy2[None, :, :] - pred_xy[:, None, :])  # (N1, N2, 2)
    in_window = (
        (dxy[..., 0] < window[:, None]) & (dxy[..., 1] < window[:, None])
    )

    pair_mask = in_window
    if octave2 is not None:
        o2 = octave2[None, :]
        if octave_lo is not None:
            pair_mask = pair_mask & (o2 >= octave_lo[:, None])
        if octave_hi is not None:
            pair_mask = pair_mask & (o2 <= octave_hi[:, None])

    dist = hamming.masked_distance_matrix(
        desc1, desc2, valid1, valid2, pair_mask
    )
    idx, best, second = hamming.best_and_second(dist)

    ok = best <= max_dist
    # ratio applies only when a second candidate exists (reference applies it
    # whenever bestDist2 is finite; INVALID second means a lone candidate).
    has_second = second < INVALID_DIST
    ok = ok & (
        ~has_second | (best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32))
    )

    if mutual:
        bwd = jnp.argmin(dist, axis=0)
        ok = ok & (bwd[idx] == jnp.arange(n1))

    if angle1 is not None and angle2 is not None:
        ok = rotation_consistency_mask(angle1, angle2[idx], ok, n_bins=histo_bins)

    # de-duplicate columns: if two rows matched the same column, keep the
    # closer one (the reference overwrites by distance in Fuse/SearchByProj).
    ok = ok & _column_unique_best(idx, best, ok, desc2.shape[0])

    return jnp.where(ok, idx, -1), best


def _column_unique_best(
    idx: jnp.ndarray, best: jnp.ndarray, ok: jnp.ndarray, n2: int
) -> jnp.ndarray:
    """True for rows that are the (unique) minimum-distance claimant of their
    matched column."""
    big = INVALID_DIST
    d = jnp.where(ok, best, big)
    col_min = jnp.full((n2,), big, dtype=d.dtype).at[idx].min(d)
    is_min = d == col_min[idx]
    # break exact ties by lowest row index
    rows = jnp.arange(idx.shape[0])
    row_claim = jnp.where(is_min & ok, rows, jnp.iinfo(jnp.int32).max)
    col_row = jnp.full((n2,), jnp.iinfo(jnp.int32).max, dtype=jnp.int32).at[idx].min(
        row_claim
    )
    return ok & is_min & (col_row[idx] == rows)


def windowed_best2(
    desc1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid1: jnp.ndarray,
    valid2: jnp.ndarray,
    pred_xy: jnp.ndarray,
    xy2: jnp.ndarray,
    window: jnp.ndarray,
    oct_lo: jnp.ndarray,
    oct_hi: jnp.ndarray,
    octave2: jnp.ndarray,
    chi2_w: jnp.ndarray,
    chi2_th: float,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gated best/second-best search of ORBmatcher::Fuse
    (src/ORBmatcher.cc:888-975): for each row i of set 1, the columns j of
    set 2 inside the box |xy2[j] - pred_xy[i]|_inf < window[i], with
    octave2[j] in [oct_lo[i], oct_hi[i]] and
    |xy2[j] - pred_xy[i]|^2 * chi2_w[j] <= chi2_th (zero weights disable
    that gate).

    Returns (best_idx, best_dist, second_dist), each (N1,) int32;
    best_dist == INVALID_DIST means no gated candidate.
    """
    du = xy2[None, :, 0] - pred_xy[:, 0, None]
    dv = xy2[None, :, 1] - pred_xy[:, 1, None]
    pair = (jnp.abs(du) < window[:, None]) & (jnp.abs(dv) < window[:, None])
    pair = pair & (octave2[None, :] >= oct_lo[:, None]) & (
        octave2[None, :] <= oct_hi[:, None]
    )
    pair = pair & ((du * du + dv * dv) * chi2_w[None, :] <= chi2_th)
    dist = hamming.masked_distance_matrix(desc1, desc2, valid1, valid2, pair)
    return hamming.best_and_second(dist)


def search_for_initialization(
    feats1,
    feats2,
    window: float = 100.0,
    nn_ratio: float = 0.9,
    check_rotation: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Wide-window mutual-best matching for the monocular initializer.

    Mirrors SearchForInitialization (jni/ORB_SLAM2/src/ORBmatcher.cc:409-524):
    window search around frame-1 keypoints, TH_LOW gate, ratio test, mutual
    best, rotation-histogram filter.

    Deviation from the reference: all octaves participate (the reference
    restricts to level 0 — ORBmatcher.cc:439 — but compensates with a 2x
    feature budget during initialization, Tracking.cc:162; with our fixed
    per-frame budget the multi-level pool provides the same match count).
    """
    return match_with_window(
        feats1.desc,
        feats2.desc,
        feats1.valid,
        feats2.valid,
        pred_xy=feats1.xy_und,
        xy2=feats2.xy_und,
        window=window,
        max_dist=TH_LOW,
        nn_ratio=nn_ratio,
        mutual=True,
        angle1=feats1.angle if check_rotation else None,
        angle2=feats2.angle if check_rotation else None,
    )


def match_by_descriptor(
    desc1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid1: jnp.ndarray,
    valid2: jnp.ndarray,
    max_dist: int | jnp.ndarray = TH_LOW,
    nn_ratio: float | jnp.ndarray = 0.75,
    angle1: jnp.ndarray | None = None,
    angle2: jnp.ndarray | None = None,
    histo_bins: int = HISTO_LENGTH,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unwindowed brute-force matching with ratio test (the array equivalent
    of SearchByBoW's within-vocabulary-node brute force — as one dense
    program the full matrix replaces the node bucketing). The optional angle pair
    enables the rotation-histogram consistency filter the reference applies
    in SearchByBoW (mbCheckOrientation, ORBmatcher.cc:161-292)."""
    dist = hamming.masked_distance_matrix(desc1, desc2, valid1, valid2)
    idx, best, second = hamming.best_and_second(dist)
    ok = (best <= max_dist) & (
        best.astype(jnp.float32) < nn_ratio * jnp.where(
            second < INVALID_DIST, second, INVALID_DIST
        ).astype(jnp.float32)
    )
    if angle1 is not None and angle2 is not None:
        ok = rotation_consistency_mask(angle1, angle2[idx], ok, n_bins=histo_bins)
    ok = ok & _column_unique_best(idx, best, ok, desc2.shape[0])
    return jnp.where(ok, idx, -1), best
