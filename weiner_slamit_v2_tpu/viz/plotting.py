"""Offline trajectory & map visualization (matplotlib -> PNG).

Replaces the reference's live GLES viewer (Viewer/MapDrawer/FrameDrawer —
jni/ORB_SLAM2/src/MapDrawer.cc:75-282 draws map points as blue/red GL_POINTS
and keyframes as line frusta). An accelerator host has no camera or
screen; the equivalent product surface is offline plots of the same content.
"""

from __future__ import annotations

import numpy as np


def plot_trajectory(
    path: str,
    est_Twc: np.ndarray,
    gt_Twc: np.ndarray | None = None,
    title: str = "trajectory",
) -> None:
    """Top-down (x, z) trajectory plot, optionally against ground truth."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    p = np.asarray(est_Twc)[:, :3, 3]
    ax.plot(p[:, 0], p[:, 2], "-", lw=1.2, label="estimate")
    if gt_Twc is not None:
        g = np.asarray(gt_Twc)[:, :3, 3]
        ax.plot(g[:, 0], g[:, 2], "--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_map(path: str, slam_map, title: str = "map") -> None:
    """Map points (dots) + keyframe positions (triangles), top-down —
    the offline analogue of MapDrawer::DrawMapPoints/DrawKeyFrames."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    mp = np.asarray(slam_map.mp_pos)[np.asarray(slam_map.mp_valid)]
    ax.scatter(mp[:, 0], mp[:, 2], s=1, alpha=0.4, label="map points")
    kv = np.asarray(slam_map.kf_valid)
    Twc = np.linalg.inv(np.asarray(slam_map.kf_pose)[kv])
    ax.plot(
        Twc[:, 0, 3], Twc[:, 2, 3], "^-", ms=4, lw=0.8, color="tab:red",
        label="keyframes",
    )
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_frame_features(path: str, image: np.ndarray, feats, title="frame") -> None:
    """Keypoint overlay — the offline FrameDrawer::DrawFrame."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(np.asarray(image), cmap="gray")
    xy = np.asarray(feats.xy)[np.asarray(feats.valid)]
    ax.scatter(xy[:, 0], xy[:, 1], s=6, facecolors="none", edgecolors="lime", lw=0.6)
    ax.set_title(f"{title}: {len(xy)} keypoints")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
