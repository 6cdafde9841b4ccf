"""SO(3)/SE(3) Lie-group operations as pure jax functions.

Replaces the reference's Sophus templates (/root/reference/Thirdparty/sophus/
sophus/{so3,se3}.hpp) with a functional, batch-friendly formulation: rotations
are stored as 3x3 matrices (matmul-friendly), tangent vectors follow
the Sophus convention ``xi = [upsilon (trans), omega (rot)]``.

All functions are written for unbatched inputs and are `vmap`-safe; the
small-angle branches use `jnp.where` on Taylor expansions so they are
jit/grad-safe with no data-dependent control flow.
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w):
    """so(3) hat operator: [3] -> [3,3] skew-symmetric matrix."""
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy]),
        jnp.stack([wz, z, -wx]),
        jnp.stack([-wy, wx, z]),
    ])


def _sin_over_x(x2):
    """sin(x)/x given x^2, Taylor-safe at 0."""
    x = jnp.sqrt(jnp.maximum(x2, 0.0))
    small = x2 < _EPS
    return jnp.where(small, 1.0 - x2 / 6.0, jnp.sin(x) / jnp.where(small, 1.0, x))


def _one_minus_cos_over_x2(x2):
    """(1-cos(x))/x^2 given x^2, Taylor-safe at 0."""
    x = jnp.sqrt(jnp.maximum(x2, 0.0))
    small = x2 < _EPS
    return jnp.where(small, 0.5 - x2 / 24.0,
                     (1.0 - jnp.cos(x)) / jnp.where(small, 1.0, x2))


def _x_minus_sin_over_x3(x2):
    """(x-sin(x))/x^3 given x^2, Taylor-safe at 0."""
    x = jnp.sqrt(jnp.maximum(x2, 0.0))
    small = x2 < _EPS
    return jnp.where(small, 1.0 / 6.0 - x2 / 120.0,
                     (x - jnp.sin(x)) / jnp.where(small, 1.0, x2 * x))


def so3_exp(w):
    """Rodrigues' formula: axis-angle [3] -> rotation matrix [3,3]."""
    theta2 = jnp.dot(w, w)
    W = hat(w)
    A = _sin_over_x(theta2)
    B = _one_minus_cos_over_x2(theta2)
    return jnp.eye(3, dtype=w.dtype) + A * W + B * (W @ W)


def so3_log(R):
    """Rotation matrix [3,3] -> axis-angle [3]. Safe for angles < pi - eps."""
    cos_t = jnp.clip((jnp.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # vee of antisymmetric part
    v = 0.5 * jnp.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    theta2 = theta * theta
    # theta / sin(theta), Taylor-safe; near pi fall back to eigen-ish recovery
    s = _sin_over_x(theta2)
    w_generic = v / jnp.maximum(s, 1e-12)
    # near pi: |sin| small but angle large — use diagonal-based axis recovery
    near_pi = cos_t < -1.0 + 1e-5
    axis_sq = jnp.clip(0.5 * (jnp.diag(R) + 1.0), 0.0, 1.0)
    axis = jnp.sqrt(axis_sq)
    # fix signs from off-diagonals (pick the largest axis component as +)
    k = jnp.argmax(axis_sq)
    signs = jnp.sign(jnp.where(
        k == 0, jnp.stack([axis[0], R[0, 1], R[0, 2]]),
        jnp.where(k == 1, jnp.stack([R[0, 1], axis[1], R[1, 2]]),
                  jnp.stack([R[0, 2], R[1, 2], axis[2]]))))
    signs = jnp.where(signs == 0, 1.0, signs)
    w_pi = theta * axis * signs
    return jnp.where(near_pi, w_pi, w_generic)


def so3_log_safe(R, tiny=1e-12):
    """Autodiff-friendly SO(3) log for |theta| < pi - eps.

    The arccos-based `so3_log` has an infinite derivative at the identity
    (d/dx arccos at x=1), which poisons forward-mode Jacobians of residuals
    that vanish at the optimum (pose-graph edges). This version uses
    theta = atan2(||vee||, (tr-1)/2) with a smoothed norm — exact away from
    0/pi and with well-behaved gradients at the identity.
    """
    v = 0.5 * jnp.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]])
    c = jnp.clip((jnp.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    s = jnp.sqrt(jnp.sum(v * v) + tiny)
    theta = jnp.arctan2(s, c)
    return v * (theta / s)


def so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3): exp((w+dw)^) ~= exp((J_l dw)^) exp(w^)."""
    theta2 = jnp.dot(w, w)
    W = hat(w)
    B = _one_minus_cos_over_x2(theta2)
    C = _x_minus_sin_over_x3(theta2)
    return jnp.eye(3, dtype=w.dtype) + B * W + C * (W @ W)


def so3_right_jacobian(w):
    """Right Jacobian J_r of SO(3) = J_l(-w). Used by IMU preintegration
    (reference: src/IMU/IMUPreintegrator.h:91-151)."""
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w):
    theta2 = jnp.dot(w, w)
    W = hat(w)
    x = jnp.sqrt(jnp.maximum(theta2, 0.0))
    small = theta2 < _EPS
    # 1/x^2 - (1+cos x)/(2 x sin x), Taylor: 1/12 + x^2/720
    denom = 2.0 * x * jnp.sin(x)
    coef = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0,
                     1.0 / jnp.where(small, 1.0, theta2)
                     - (1.0 + jnp.cos(x)) / jnp.where(small, 1.0, denom))
    return jnp.eye(3, dtype=w.dtype) + 0.5 * W + coef * (W @ W)


def se3_exp(xi):
    """se(3) tangent [6] = [upsilon, omega] -> (R [3,3], t [3])."""
    u, w = xi[:3], xi[3:]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    return R, V @ u


def se3_log(R, t):
    """(R, t) -> tangent [6] = [upsilon, omega]."""
    w = so3_log(R)
    Vinv = _left_jacobian_inv(w)
    return jnp.concatenate([Vinv @ t, w])


def _left_jacobian_inv(w):
    theta2 = jnp.dot(w, w)
    W = hat(w)
    x = jnp.sqrt(jnp.maximum(theta2, 0.0))
    small = theta2 < _EPS
    half = 0.5 * x
    # 1/x^2 * (1 - (x/2) cot(x/2)) ; Taylor 1/12 + x^2/720
    cot_term = half * jnp.cos(half) / jnp.where(small, 1.0, jnp.sin(half))
    coef = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0,
                     (1.0 - cot_term) / jnp.where(small, 1.0, theta2))
    return jnp.eye(3, dtype=w.dtype) - 0.5 * W + coef * (W @ W)


def se3_mul(Ra, ta, Rb, tb):
    """Compose: (Ra,ta) * (Rb,tb)."""
    return Ra @ Rb, Ra @ tb + ta


def se3_inv(R, t):
    Rt = R.T
    return Rt, -(Rt @ t)


def se3_apply(R, t, X):
    """Apply transform to points X [..., 3] -> [..., 3]."""
    return X @ R.T + t


def se3_matrix(R, t):
    """(R,t) -> homogeneous 4x4."""
    T = jnp.eye(4, dtype=R.dtype)
    T = T.at[:3, :3].set(R).at[:3, 3].set(t)
    return T


# ---------------------------------------------------------------------------
# Quaternion helpers (storage / trajectory IO; TUM format is [x y z qx qy qz qw])

def rotmat_to_quat(R):
    """[3,3] -> quaternion [w, x, y, z] (unit norm). Shepperd's method, branch-
    free via picking the max-stability case with where()."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 1e-12)) * 0.5
    q0 = jnp.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                    (m10 - m01) / (4 * qw0)])
    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 0.5
    q1 = jnp.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                    (m02 + m20) / (4 * qx1)])
    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-12)) * 0.5
    q2 = jnp.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                    (m12 + m21) / (4 * qy2)])
    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-12)) * 0.5
    q3 = jnp.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                    (m12 + m21) / (4 * qz3), qz3])
    # choose by largest pivot
    pivots = jnp.stack([tr, m00, m11, m22])
    k = jnp.argmax(pivots)
    q = jnp.where(k == 0, q0, jnp.where(k == 1, q1, jnp.where(k == 2, q2, q3)))
    return q / jnp.linalg.norm(q)


def quat_to_rotmat(q):
    """quaternion [w,x,y,z] -> [3,3]."""
    q = q / jnp.linalg.norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])
