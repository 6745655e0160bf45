"""Sim(3) similarity-transform operations in tangent space.

JAX replacement for g2o's ``Sim3`` type used by the reference for loop
closing (jni/Thirdparty/g2o/g2o/types/sim3.h, used by
jni/ORB_SLAM2/src/Optimizer.cc:781-1044 and src/Sim3Solver.cc).

Representation: a Sim3 is stored as a dict-free flat 8-tuple packed in a single
array would be awkward; instead we keep (R, t, s) triples as a 4x4 matrix with
the rotation block scaled, i.e. ``S = [[s*R, t], [0, 1]]`` — the standard
homogeneous form. Helpers extract (R, t, s) when needed. Tangent vectors are
7-vectors ``[upsilon, omega, sigma]`` (translation, rotation, log-scale),
matching g2o's ordering.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import se3

_EPS = 1e-8


def from_rts(R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Assemble a 4x4 Sim3 matrix from rotation, translation, scale."""
    s = jnp.asarray(s)
    sR = s[..., None, None] * R
    return se3.from_rt(sR, t)


def scale_of(S: jnp.ndarray) -> jnp.ndarray:
    """Recover scale as the norm of the first rotation row (batched)."""
    return jnp.linalg.norm(S[..., 0, :3], axis=-1)


def rot_of(S: jnp.ndarray) -> jnp.ndarray:
    return S[..., :3, :3] / scale_of(S)[..., None, None]


def trans_of(S: jnp.ndarray) -> jnp.ndarray:
    return S[..., :3, 3]


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def from_se3(T: jnp.ndarray) -> jnp.ndarray:
    """Promote an SE3 to a Sim3 with scale 1 (same matrix)."""
    return T


def to_se3(S: jnp.ndarray) -> jnp.ndarray:
    """Project a Sim3 back to SE3: divide translation by scale, drop scale.

    Matches the recovery used after essential-graph optimization
    (jni/ORB_SLAM2/src/Optimizer.cc:1003-1012: ``Tiw = [R, t/s; 0, 1]``).
    """
    s = scale_of(S)
    R = rot_of(S)
    t = trans_of(S) / s[..., None]
    return se3.from_rt(R, t)


def inv(S: jnp.ndarray) -> jnp.ndarray:
    s = scale_of(S)
    R = rot_of(S)
    t = trans_of(S)
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t)
    return from_rts(Rt, t_inv, s_inv)


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return A @ B


def apply(S: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Transform points: s*R@X + t (batched)."""
    return jnp.einsum("...ij,...j->...i", S[..., :3, :3], X) + S[..., :3, 3]



def _W(omega: jnp.ndarray, sigma: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """The 3x3 matrix W with t = W @ upsilon in the Sim(3) exponential.

    W = A*I + B*hat(omega) + C*hat(omega)^2 (Strasdat's closed form), with
    series fallbacks for small theta and small sigma so the expression is
    differentiable and jit-safe everywhere.
    """
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = se3.hat(omega)
    K2 = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)

    small_sig = jnp.abs(sigma) < 1e-5
    small_th = theta < 1e-4
    sig_safe = jnp.where(small_sig, 1.0, sigma)
    theta_safe = jnp.where(small_th, 1.0, theta)
    theta2_safe = jnp.where(small_th, 1.0, theta2)

    A = jnp.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig_safe)

    denom = sigma * sigma + theta2
    denom_safe = jnp.where(denom < _EPS, 1.0, denom)
    s_cos = s * jnp.cos(theta_safe)
    s_sin = s * jnp.sin(theta_safe)
    B_gen = (sigma * s_sin + (1.0 - s_cos) * theta_safe) / (theta_safe * denom_safe)
    C_gen = (A - ((s_cos - 1.0) * sigma + s_sin * theta_safe) / denom_safe) / theta2_safe

    # theta -> 0 limits (exact in sigma), then sigma -> 0 limits of those.
    sig3_safe = sig_safe * sig_safe * sig_safe
    B_lim = jnp.where(
        small_sig, 0.5 + sigma / 3.0, (sigma * s + 1.0 - s) / (sig_safe * sig_safe)
    )
    C_lim = jnp.where(
        small_sig,
        1.0 / 6.0 + sigma / 8.0,
        (s - 1.0 - sigma * s + sigma * sigma * s / 2.0) / sig3_safe,
    )

    B = jnp.where(small_th, B_lim, B_gen)
    C = jnp.where(small_th, C_lim, C_gen)
    return A[..., None, None] * eye + B[..., None, None] * K + C[..., None, None] * K2


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Sim(3) exponential of 7-vector [upsilon, omega, sigma] (batched).

    Closed form from Strasdat's thesis (the same formulation g2o implements).
    """
    upsilon = xi[..., :3]
    omega = xi[..., 3:6]
    sigma = xi[..., 6]
    s = jnp.exp(sigma)
    R = se3.so3_exp(omega)
    W = _W(omega, sigma, s)
    t = jnp.einsum("...ij,...j->...i", W, upsilon)
    return from_rts(R, t, s)


def log(S: jnp.ndarray) -> jnp.ndarray:
    """Sim(3) logarithm -> 7-vector [upsilon, omega, sigma] (batched)."""
    s = scale_of(S)
    R = rot_of(S)
    t = trans_of(S)
    sigma = jnp.log(s)
    omega = se3.so3_log(R)
    W = _W(omega, sigma, s)
    upsilon = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([upsilon, omega, sigma[..., None]], axis=-1)


def retract(S: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative manifold update: exp(xi) @ S (g2o convention)."""
    return exp(xi) @ S
