"""Covisibility graph & local-window queries as dense matrix ops.

JAX replacement for ``KeyFrame::UpdateConnections`` and friends
(jni/ORB_SLAM2/src/KeyFrame.cc:296-386): the reference maintains mutable
adjacency maps per keyframe under mutexes; here the covisibility weight
matrix is *derived* on demand from the observation relation with one
indicator matmul, so it can never be stale and needs no locks.
"""

from __future__ import annotations

import jax.numpy as jnp

from .types import SlamMap, observation_indicator

MIN_COVIS_WEIGHT = 15   # edge threshold (KeyFrame.cc:337-383)


def covisibility_matrix(m: SlamMap) -> jnp.ndarray:
    """(K, K) int32 — number of map points shared by each keyframe pair.

    W = I @ I^T over the (K, M) observation indicator, diagonal zeroed,
    invalid keyframes masked out.
    """
    ind = observation_indicator(m) & m.mp_valid[None, :]
    indf = ind.astype(jnp.float32)
    W = (indf @ indf.T).astype(jnp.int32)
    K = W.shape[0]
    W = W * (1 - jnp.eye(K, dtype=jnp.int32))
    vv = m.kf_valid
    return jnp.where(vv[:, None] & vv[None, :], W, 0)
