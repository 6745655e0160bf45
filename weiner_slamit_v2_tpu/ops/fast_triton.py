"""FAST-9/16 score + 3x3 NMS as Pallas kernels for NVIDIA GPUs (Triton route).

The XLA form of the detector (ops/fast.py) compiles to about 14 small
kernels per pyramid level on the GPU (110 for the 8 levels of a 640x480
frame: 298 µs of device time on an H100, against 71 µs for these kernels).
Here each level takes two launches:

* ``_score_kernel``: one program per (BH, BW) output tile reads the tile's
  16 ring neighbours and centre with masked loads (the 3-px halo comes from
  the neighbouring tiles through the cache; out-of-image pixels read 0),
  evaluates both arc chains in registers and writes the thresholded,
  border-masked score;
* ``_nms_kernel``: the same tiling over the score map, 8 masked neighbour
  loads, writes the suppressed map.

The arithmetic is the reference's exactly (subtractions, min and max only),
so the result equals ``fast.fast_score_nms`` bit for bit; tests run both
kernels in interpret mode against it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .fast import _CIRCLE

BLOCK_H = 16
BLOCK_W = 64
NUM_WARPS = 4

_NMS_PREV = ((-1, -1), (-1, 0), (-1, 1), (0, -1))  # strictly greater
_NMS_NEXT = ((0, 1), (1, -1), (1, 0), (1, 1))      # greater or equal


def _tile():
    r = pl.program_id(0) * BLOCK_H + jnp.arange(BLOCK_H)
    c = pl.program_id(1) * BLOCK_W + jnp.arange(BLOCK_W)
    return r[:, None], c[None, :]


def _load(ref, r, c, h, w):
    inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
    return plgpu.load(ref.at[r, c], mask=inside, other=0.0)


def _arc_score(diffs):
    """max over the 16 circular 9-arcs of the min inside the arc."""
    best = None
    for start in range(16):
        m = diffs[start]
        for k in range(1, 9):
            m = jnp.minimum(m, diffs[(start + k) % 16])
        best = m if best is None else jnp.maximum(best, m)
    return best


def _score_kernel(img_ref, out_ref, *, threshold):
    h, w = img_ref.shape
    r, c = _tile()
    center = _load(img_ref, r, c, h, w)
    ring = [_load(img_ref, r + dy, c + dx, h, w) for dy, dx in _CIRCLE]
    score = jnp.maximum(
        _arc_score([p - center for p in ring]),
        _arc_score([center - p for p in ring]),
    )
    interior = (r >= 3) & (r < h - 3) & (c >= 3) & (c < w - 3)
    score = jnp.where(interior & (score > threshold), score, 0.0)
    plgpu.store(out_ref.at[r, c], score, mask=(r < h) & (c < w))


def _nms_kernel(score_ref, out_ref):
    h, w = score_ref.shape
    r, c = _tile()
    s = _load(score_ref, r, c, h, w)
    keep = s > 0.0
    for dy, dx in _NMS_PREV:
        keep = keep & (s > _load(score_ref, r + dy, c + dx, h, w))
    for dy, dx in _NMS_NEXT:
        keep = keep & (s >= _load(score_ref, r + dy, c + dx, h, w))
    plgpu.store(
        out_ref.at[r, c], jnp.where(keep, s, 0.0), mask=(r < h) & (c < w)
    )


@functools.partial(jax.jit, static_argnames=("threshold", "interpret"))
def fast_score_nms_triton(
    image: jnp.ndarray, threshold: float, interpret: bool = False
) -> jnp.ndarray:
    """Same contract as ``fast.fast_score_nms``: (H, W) float32 image ->
    (H, W) float32 map, nonzero exactly at the kept corners."""
    image = image.astype(jnp.float32)
    h, w = image.shape
    grid = (pl.cdiv(h, BLOCK_H), pl.cdiv(w, BLOCK_W))

    def call(kernel, name):
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((h, w), jnp.float32),
            grid=grid,
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
            interpret=interpret,
            name=name,
        )

    score = call(
        functools.partial(_score_kernel, threshold=float(threshold)),
        "fast_score",
    )(image)
    return call(_nms_kernel, "fast_nms")(score)
