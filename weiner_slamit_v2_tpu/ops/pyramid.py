"""Image pyramid + Gaussian blur as XLA array ops.

JAX replacement for ``ORBextractor::ComputePyramid``
(jni/ORB_SLAM2/src/ORBextractor.cc:1138-1168 — per-level ``cv::resize``
bilinear chain) and the 7x7 sigma=2 Gaussian blur applied before descriptor
extraction (jni/ORB_SLAM2/src/ORBextractor.cc:1117).

Level shapes are static (computed from the config at trace time), so the
whole pyramid is one fused XLA program per level; levels are unrolled.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> list[tuple[int, int]]:
    """Static (H, W) per pyramid level, matching the reference's rounding
    (ORBextractor.cc:1147: cvRound(w/scale))."""
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor**lvl
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level scale (level coords * scale -> level-0 coords)."""
    return np.asarray([scale_factor**l for l in range(n_levels)], dtype=np.float32)


def build_pyramid(
    image: jnp.ndarray, n_levels: int = 8, scale_factor: float = 1.2
) -> list[jnp.ndarray]:
    """Build the bilinear pyramid. image: (H, W) float32. Returns one array
    per level (static shapes). Resizes from the previous level like the
    reference (chained 1/1.2 resizes, not direct-from-level-0)."""
    h, w = image.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [image]
    for lvl in range(1, n_levels):
        prev = levels[-1]
        levels.append(
            jax.image.resize(prev, shapes[lvl], method="linear", antialias=False)
        )
    return levels


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> tuple[float, ...]:
    half = ksize // 2
    xs = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    k /= k.sum()
    return tuple(float(v) for v in k)


def gaussian_blur(image: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with reflect-101 border (OpenCV's default
    BORDER_REFLECT_101, as used at ORBextractor.cc:1117). image: (H, W)."""
    k = jnp.asarray(_gaussian_kernel_1d(ksize, sigma), dtype=image.dtype)
    half = ksize // 2
    padded = jnp.pad(image, ((half, half), (half, half)), mode="reflect")
    # Horizontal then vertical pass as shifted adds (XLA fuses these into a
    # single conv-like loop; avoids conv layout overhead for tiny kernels).
    rows = jnp.zeros_like(padded[:, half:-half])
    for i in range(ksize):
        rows = rows + k[i] * padded[:, i : i + image.shape[1]]
    out = jnp.zeros_like(image)
    for i in range(ksize):
        out = out + k[i] * rows[i : i + image.shape[0], :]
    return out
