"""PoseNet-style human keypoint head (parity feature).

Replaces the reference's TFLite PoseNet integration
(jni/ORB_SLAM2/src/Posenet.cc — a C-API reimplementation of the Kotlin
PoseNet library, run on every monocular frame at Frame ctor time,
src/Frame.cc:222-232). Same interface contract:

* input 1x257x257x3 float in [-1, 1] (Posenet.cc:139-192, initInputArray);
* outputs: heatmaps (9, 9, 17), offsets (9, 9, 34), forward/backward
  displacements (9, 9, 32) (Posenet.cc:202-373, initOutputMap);
* single-pose decoding: per-keypoint heatmap argmax + offset refinement +
  sigmoid confidence (Posenet.cc:499-637, estimateSinglePose).

The reference loads pretrained MobileNet weights from posenet_model.tflite —
a file that does not ship with the repo and cannot be fetched here, so this
module provides the architecture + decoder with random initialization; any
MobileNetV1-PoseNet checkpoint can be loaded into `params` once available.

The network is plain ``lax`` convolutions over a nested params dict
``{"params": {"Conv_0": {"kernel", "bias"}, "_DepthwiseSeparable_0":
{"Conv_0", "Conv_1"}, ...}}`` (kernels HWIO, activations NHWC).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

INPUT_SIZE = 257
OUTPUT_STRIDE = 32
N_KEYPOINTS = 17

BODY_PARTS = (
    "NOSE", "LEFT_EYE", "RIGHT_EYE", "LEFT_EAR", "RIGHT_EAR",
    "LEFT_SHOULDER", "RIGHT_SHOULDER", "LEFT_ELBOW", "RIGHT_ELBOW",
    "LEFT_WRIST", "RIGHT_WRIST", "LEFT_HIP", "RIGHT_HIP", "LEFT_KNEE",
    "RIGHT_KNEE", "LEFT_ANKLE", "RIGHT_ANKLE",
)  # include/Posenet.h:15-35 (BodyPart enum order)

STEM_FEATURES = 24
# (features, stride) of the depthwise-separable blocks; the last stride-2
# block reaches 9x9 at input 257
BLOCKS = (
    (48, 2), (96, 2), (96, 1), (192, 2), (192, 1), (384, 1), (384, 2),
)
HEADS = (N_KEYPOINTS, 2 * N_KEYPOINTS, 32, 32)  # heatmaps, offsets, fwd, bwd


def _conv(p, x, stride=1, groups=1):
    y = jax.lax.conv_general_dilated(
        x, p["kernel"], (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
    )
    return y + p["bias"]


class PoseNet:
    """MobileNetV1-0.75-ish backbone + the four PoseNet heads."""

    def apply(self, params: Any, x: jnp.ndarray):
        """x: (B, 257, 257, 3) in [-1, 1] -> (heatmaps, offsets, disp_fwd,
        disp_bwd), each (B, 9, 9, C)."""
        p = params["params"]
        x = jax.nn.relu(_conv(p["Conv_0"], x, stride=2))
        for i, (_, stride) in enumerate(BLOCKS):
            b = p[f"_DepthwiseSeparable_{i}"]
            x = jax.nn.relu(
                _conv(b["Conv_0"], x, stride=stride, groups=x.shape[-1])
            )
            x = jax.nn.relu(_conv(b["Conv_1"], x))
        return tuple(_conv(p[f"Conv_{1 + h}"], x) for h in range(len(HEADS)))


def init_params(key: jnp.ndarray) -> Any:
    """Random params: LeCun-normal kernels, zero biases."""
    init = jax.nn.initializers.lecun_normal()
    keys = iter(jax.random.split(key, 1 + 2 * len(BLOCKS) + len(HEADS)))

    def conv(kh, cin, cout):
        return {
            "kernel": init(next(keys), (kh, kh, cin, cout), jnp.float32),
            "bias": jnp.zeros((cout,), jnp.float32),
        }

    p = {"Conv_0": conv(3, 3, STEM_FEATURES)}
    ch = STEM_FEATURES
    for i, (feats, _) in enumerate(BLOCKS):
        p[f"_DepthwiseSeparable_{i}"] = {
            "Conv_0": conv(3, 1, ch), "Conv_1": conv(1, ch, feats),
        }
        ch = feats
    for h, feats in enumerate(HEADS):
        p[f"Conv_{1 + h}"] = conv(1, ch, feats)
    return {"params": p}


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def save_params(path: str, params: Any) -> None:
    """Write a params pytree to .npz (keys are '/'-joined paths). The
    counterpart of the reference's posenet_model.tflite artifact
    (src/Posenet.cc:30-42) in this framework's native format."""
    import numpy as np

    flat = _flatten(params)
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_params(path: str) -> Any:
    """Load a params pytree saved by save_params (or any externally trained
    checkpoint exported to the same layout). Validates against the
    architecture's shapes so a wrong file fails loudly at load time."""
    import numpy as np

    with np.load(path) as z:
        flat = {k: jnp.asarray(z[k]) for k in z.files}
    params = _unflatten(flat)
    ref = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0)))
    ref_flat = jax.tree_util.tree_leaves_with_path(ref)
    got_flat = jax.tree_util.tree_leaves_with_path(params)
    if len(ref_flat) != len(got_flat):
        raise ValueError(
            f"posenet params mismatch: {len(got_flat)} arrays, "
            f"expected {len(ref_flat)}"
        )
    for (kp_r, leaf_r), (kp_g, leaf_g) in zip(ref_flat, got_flat):
        if kp_r != kp_g or leaf_r.shape != leaf_g.shape:
            raise ValueError(
                f"posenet param {jax.tree_util.keystr(kp_g)}: shape "
                f"{leaf_g.shape}, expected {jax.tree_util.keystr(kp_r)} "
                f"{leaf_r.shape}"
            )
    return params


@jax.jit
def estimate_single_pose(params: Any, image_rgb: jnp.ndarray):
    """Decode one person's 17 keypoints from a (257, 257, 3) image in
    [0, 255]. Returns (positions (17, 2) in input pixels as (x, y),
    scores (17,)) — the Person struct of the reference
    (Posenet.cc:499-637)."""
    x = image_rgb[None] / 127.5 - 1.0
    heatmaps, offsets, _, _ = PoseNet().apply(params, x)
    hm = heatmaps[0]       # (9, 9, 17)
    off = offsets[0]       # (9, 9, 34)
    g = hm.shape[0]

    flat = hm.reshape(-1, N_KEYPOINTS)
    best = jnp.argmax(flat, axis=0)            # (17,)
    by = best // g
    bx = best % g
    scores = jax.nn.sigmoid(flat[best, jnp.arange(N_KEYPOINTS)])

    # offset layout: first 17 channels y, next 17 x (Posenet.cc:560-590)
    oy = off[by, bx, jnp.arange(N_KEYPOINTS)]
    ox = off[by, bx, jnp.arange(N_KEYPOINTS) + N_KEYPOINTS]
    yy = by.astype(jnp.float32) / (g - 1) * INPUT_SIZE + oy
    xx = bx.astype(jnp.float32) / (g - 1) * INPUT_SIZE + ox
    return jnp.stack([xx, yy], axis=1), scores


def person_keypoints_for_frame(
    params: Any,
    image_gray: jnp.ndarray,
    score_threshold: float = 0.7,
):
    """Frame-ctor parity helper (src/Frame.cc:222-334): resize to 257x257,
    run the pose head, return keypoints above the confidence threshold
    scaled back to frame coordinates."""
    H, W = image_gray.shape
    rgb = jnp.repeat(image_gray[..., None], 3, axis=-1)
    small = jax.image.resize(rgb, (INPUT_SIZE, INPUT_SIZE, 3), "linear")
    pos, scores = estimate_single_pose(params, small)
    scale = jnp.asarray([W / INPUT_SIZE, H / INPUT_SIZE])
    return pos * scale[None, :], scores, scores > score_threshold
