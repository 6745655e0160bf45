"""ORB feature extraction: pyramid -> FAST -> select -> orient -> describe.

JAX replacement for ``ORBextractor::operator()``
(jni/ORB_SLAM2/src/ORBextractor.cc:1064-1136). The reference runs serial
per-pixel loops per level; here each level is a fused dense array program and
the per-level feature budgets follow the same geometric split as the
reference ctor (ORBextractor.cc:444-455).

Everything is jit-compiled once per image shape; the output is a fixed-size
``FrameFeatures`` struct (padded + masked), which is what XLA's static-shape
model needs (SURVEY.md §7 hard part (b)).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..config import OrbConfig
from ..ops import fast, orb, pyramid, topk_grid
from ..ops.fast_triton import fast_score_nms_triton
from ..ops.pattern import EDGE_MARGIN
from ..utils import struct


@struct.dataclass
class FrameFeatures:
    """Fixed-size per-frame feature set (the array analogue of the keypoint
    vectors in Frame — jni/ORB_SLAM2/include/Frame.h)."""

    xy: jnp.ndarray        # (N, 2) float32 keypoint coords, level-0 pixels (raw)
    xy_und: jnp.ndarray    # (N, 2) float32 undistorted (rectified) coords
    response: jnp.ndarray  # (N,) float32 FAST response
    angle: jnp.ndarray     # (N,) float32 orientation, radians
    octave: jnp.ndarray    # (N,) int32 pyramid level
    desc: jnp.ndarray      # (N, 8) uint32 packed 256-bit descriptors
    valid: jnp.ndarray     # (N,) bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def detect_level(image: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST score + 3x3 NMS of one pyramid level: the Triton kernels where
    the program is compiled for an NVIDIA GPU, the XLA form elsewhere (the
    two agree bit for bit)."""
    return jax.lax.platform_dependent(
        image,
        cuda=functools.partial(fast_score_nms_triton, threshold=threshold),
        default=functools.partial(fast.fast_score_nms, threshold=threshold),
    )


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """Geometric per-level budgets, remainder to the coarsest level
    (mirrors ORBextractor.cc:444-455)."""
    inv = 1.0 / scale_factor
    total = (1.0 - inv**n_levels) / (1.0 - inv)
    per0 = n_features / total
    budgets = [int(round(per0 * inv**l)) for l in range(n_levels - 1)]
    budgets.append(max(n_features - sum(budgets), 0))
    return budgets


class OrbExtractor:
    """Stateless extractor; precomputes static per-level metadata."""

    def __init__(self, cfg: OrbConfig, image_hw: tuple[int, int]):
        self.cfg = cfg
        self.image_hw = image_hw
        self.budgets = level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
        self.scales = pyramid.scale_factors(cfg.n_levels, cfg.scale_factor)
        self.sigma2 = (self.scales**2).astype(np.float32)
        self.inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        self.n_total = sum(self.budgets)
        self._extract = jax.jit(self._extract_impl)

    def __call__(self, image: jnp.ndarray) -> FrameFeatures:
        """image: (H, W) float32 grayscale in [0, 255]."""
        return self._extract(image)

    def _extract_impl(self, image: jnp.ndarray) -> FrameFeatures:
        cfg = self.cfg
        # accept uint8 camera frames: the host->device image transfer is
        # the biggest per-frame byte stream (0.3 MB u8 vs 1.2 MB f32 at
        # 640x480); all compute is f32 on device
        image = image.astype(jnp.float32)
        levels = pyramid.build_pyramid(image, cfg.n_levels, cfg.scale_factor)

        xs, resps, angles, octaves, descs, valids = [], [], [], [], [], []
        for lvl, img in enumerate(levels):
            budget = self.budgets[lvl]
            if budget == 0:
                continue
            score = detect_level(img, cfg.fast_min_threshold)
            xy, resp, valid = topk_grid.select_keypoints(
                score,
                budget=budget,
                cell_size=cfg.cell_size,
                high_threshold=cfg.fast_threshold,
                low_threshold=cfg.fast_min_threshold,
                margin=EDGE_MARGIN,
            )
            ang = orb.orientations(img, xy)
            blurred = pyramid.gaussian_blur(img)
            desc = orb.brief_descriptors(blurred, xy, ang)

            scale = float(self.scales[lvl])
            xs.append(xy * scale)
            resps.append(resp)
            angles.append(ang)
            octaves.append(jnp.full((budget,), lvl, dtype=jnp.int32))
            descs.append(desc)
            valids.append(valid)

        xy = jnp.concatenate(xs, axis=0)
        features = FrameFeatures(
            xy=xy,
            xy_und=xy,  # caller applies undistortion (geometry.camera)
            response=jnp.concatenate(resps),
            angle=jnp.concatenate(angles),
            octave=jnp.concatenate(octaves),
            desc=jnp.concatenate(descs),
            valid=jnp.concatenate(valids),
        )
        return features


@functools.lru_cache(maxsize=8)
def get_extractor(cfg: OrbConfig, image_hw: tuple[int, int]) -> OrbExtractor:
    return OrbExtractor(cfg, image_hw)
