"""Rectified stereo matching: row-banded Hamming search + SAD subpixel.

JAX replacement for ``Frame::ComputeStereoMatches``
(jni/ORB_SLAM2/src/Frame.cc:591-763): the reference builds per-row candidate
tables and searches each left keypoint serially (Hamming best in a row band,
then an 11-px SAD slide with parabola subpixel refinement). Here the whole
frame is matched at once: one masked (N_l x N_r) Hamming matrix with row-band
and disparity-range gates, then a batched patch-gather SAD refinement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import hamming

TH_HIGH = 100  # descriptor gate (ORBmatcher::TH_HIGH, used at Frame.cc:637)
SAD_WIN = 5    # half-window of the 11x11 SAD block (Frame.cc:684: w=5)
SAD_RANGE = 5  # disparity slide +-L (Frame.cc:690: L=5)


def match_stereo(
    left_feats,
    right_feats,
    left_img: jnp.ndarray,
    right_img: jnp.ndarray,
    baseline_fx: jnp.ndarray,
    min_z_depth: jnp.ndarray,
    scale_factors: jnp.ndarray,
    n_levels: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Compute per-left-keypoint disparity/depth.

    Args:
      left_feats / right_feats: FrameFeatures of the rectified pair.
      left_img / right_img: (H, W) level-0 images for SAD refinement.
      baseline_fx: bf = baseline * fx ("Camera.bf").
      min_z_depth: minimum depth = baseline (Frame.cc:610: minZ = mb).
      scale_factors: per-octave scales (row-band width scales with octave).

    Returns (depth (N_l,), u_right (N_l,)): -1 where unmatched — the same
    convention as Frame::mvDepth / mvuRight.
    """
    xl = left_feats.xy[:, 0]
    yl = left_feats.xy[:, 1]
    xr = right_feats.xy[:, 0]
    yr = right_feats.xy[:, 1]

    # row band: |y_l - y_r| <= 2 * scale of the right keypoint's octave
    # (Frame.cc:617-627 builds rows over +-2*sigma)
    r_oct = jnp.clip(right_feats.octave, 0, n_levels - 1)
    band = 2.0 * scale_factors[r_oct]
    row_ok = jnp.abs(yl[:, None] - yr[None, :]) <= band[None, :]

    # disparity range: minD=0, maxD = bf/minZ (Frame.cc:608-610)
    max_d = baseline_fx / jnp.maximum(min_z_depth, 1e-6)
    disp = xl[:, None] - xr[None, :]
    disp_ok = (disp >= -3.0) & (disp <= max_d)

    # octave gate: matching keypoints within +-1 level (Frame.cc:650)
    l_oct = left_feats.octave
    oct_ok = jnp.abs(l_oct[:, None] - right_feats.octave[None, :]) <= 1

    dist = hamming.masked_distance_matrix(
        left_feats.desc,
        right_feats.desc,
        left_feats.valid,
        right_feats.valid,
        row_ok & disp_ok & oct_ok,
    )
    best_idx = jnp.argmin(dist, axis=1)
    best = dist[jnp.arange(dist.shape[0]), best_idx]
    matched = best < TH_HIGH

    # --- SAD subpixel refinement around the matched right keypoint --------
    # (Frame.cc:666-731): slide an 11x11 block over +-5 px and fit a parabola
    # through the best three correlations.
    H, W = left_img.shape
    scale = scale_factors[jnp.clip(l_oct, 0, n_levels - 1)]
    xr0 = xr[best_idx]

    d = jnp.arange(-SAD_WIN, SAD_WIN + 1)
    yy = jnp.clip(
        jnp.round(yl).astype(jnp.int32)[:, None, None] + d[None, :, None], 0, H - 1
    )
    xx_l = jnp.clip(
        jnp.round(xl).astype(jnp.int32)[:, None, None] + d[None, None, :], 0, W - 1
    )
    patch_l = left_img[yy, xx_l]  # (N, 11, 11)
    patch_l = patch_l - patch_l[:, SAD_WIN : SAD_WIN + 1, SAD_WIN : SAD_WIN + 1]

    def sad_at(offset):
        xx_r = jnp.clip(
            jnp.round(xr0).astype(jnp.int32)[:, None, None]
            + offset
            + d[None, None, :],
            0,
            W - 1,
        )
        patch_r = right_img[yy, xx_r]
        patch_r = patch_r - patch_r[:, SAD_WIN : SAD_WIN + 1, SAD_WIN : SAD_WIN + 1]
        return jnp.sum(jnp.abs(patch_l - patch_r), axis=(1, 2))

    sads = jnp.stack(
        [sad_at(o) for o in range(-SAD_RANGE, SAD_RANGE + 1)], axis=1
    )  # (N, 11)
    best_o = jnp.argmin(sads, axis=1)
    # parabola through (best-1, best, best+1)
    o_c = jnp.clip(best_o, 1, 2 * SAD_RANGE - 1)
    s_m = sads[jnp.arange(sads.shape[0]), o_c - 1]
    s_0 = sads[jnp.arange(sads.shape[0]), o_c]
    s_p = sads[jnp.arange(sads.shape[0]), o_c + 1]
    denom = jnp.maximum(s_m + s_p - 2.0 * s_0, 1e-6)
    delta = 0.5 * (s_m - s_p) / denom
    delta = jnp.clip(delta, -1.0, 1.0)  # reject out-of-window minima (Frame.cc:717)

    u_r = xr0 + (o_c.astype(jnp.float32) - SAD_RANGE) + delta
    disparity = xl - u_r
    ok = matched & (disparity > 0.0) & (disparity < baseline_fx / jnp.maximum(min_z_depth, 1e-6))
    # disparity <= 0 with tiny positive epsilon: ref snaps to 0.01 (Frame.cc:744)
    depth = jnp.where(ok, baseline_fx / jnp.maximum(disparity, 1e-3), -1.0)
    u_right = jnp.where(ok, u_r, -1.0)
    return depth, u_right


def depth_from_depthmap(
    feats, depth_map: jnp.ndarray
) -> jnp.ndarray:
    """Per-keypoint depth from an RGB-D depth image
    (Frame::ComputeStereoFromRGBD, src/Frame.cc:766-787): nearest-pixel
    lookup at the (distorted) keypoint location."""
    H, W = depth_map.shape
    x = jnp.clip(jnp.round(feats.xy[:, 0]).astype(jnp.int32), 0, W - 1)
    y = jnp.clip(jnp.round(feats.xy[:, 1]).astype(jnp.int32), 0, H - 1)
    d = depth_map[y, x]
    return jnp.where(feats.valid & (d > 0), d, -1.0)
