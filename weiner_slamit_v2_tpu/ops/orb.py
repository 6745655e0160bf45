"""Keypoint orientation + rotated BRIEF-256 descriptors as batched matmuls.

JAX replacement for ``IC_Angle`` (intensity-centroid orientation,
jni/ORB_SLAM2/src/ORBextractor.cc:82-109) and ``computeOrbDescriptor``
(rotated 256-pair comparisons, ORBextractor.cc:113-152). The reference walks
patch pixels in scalar loops per keypoint; here all keypoints of a level are
processed at once through the row-gather + one-hot-matmul patch machinery in
ops/patches.py, and the
rotated BRIEF samples are read from the already-extracted (31, 31) patch —
the full image is touched exactly once per keypoint.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import pattern as pat
from .patches import extract_patches, sample_in_patch


def orientations(image: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation per keypoint, radians in (-pi, pi].

    Computed on the (unblurred) pyramid image like the reference
    (ORBextractor.cc:1100-1110 computes orientation before the blur).
    """
    mask, xs, ys = pat.orientation_disc()
    patches = extract_patches(image, xy, pat.HALF_PATCH)
    m = jnp.asarray(mask)
    m10 = jnp.sum(patches * m * jnp.asarray(xs), axis=(1, 2))
    m01 = jnp.sum(patches * m * jnp.asarray(ys), axis=(1, 2))
    return jnp.arctan2(m01, m10)


def brief_descriptors(
    blurred: jnp.ndarray,
    xy: jnp.ndarray,
    angle: jnp.ndarray,
    patches: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Rotated BRIEF-256 descriptors packed as (N, 8) uint32.

    blurred: (H, W) Gaussian-blurred level image (the reference blurs before
    describing, ORBextractor.cc:1117). xy: (N, 2) level coords. angle: (N,).
    patches: optional pre-extracted (N, 31, 31) patches of `blurred` at `xy`
    (pass to reuse one extraction across callers).

    The pattern points lie inside the radius-(HALF_PATCH-1) disc (see
    ops/pattern.py), so every rotated sample stays inside the 31x31 patch.
    """
    if patches is None:
        patches = extract_patches(blurred, xy, pat.HALF_PATCH)
    p = jnp.asarray(pat.brief_pattern().reshape(-1, 2), dtype=jnp.float32)  # (512, 2)
    ca = jnp.cos(angle)[:, None]
    sa = jnp.sin(angle)[:, None]
    # steered pattern: x' = x cos - y sin ; y' = x sin + y cos
    px, py = p[None, :, 0], p[None, :, 1]
    sx = jnp.round(px * ca - py * sa).astype(jnp.int32)  # (N, 512)
    sy = jnp.round(px * sa + py * ca).astype(jnp.int32)
    samples = sample_in_patch(patches, sx, sy)           # (N, 512)
    t0 = samples[:, 0::2]
    t1 = samples[:, 1::2]
    bits = (t0 < t1).astype(jnp.uint32)  # (N, 256)
    bits = bits.reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)
