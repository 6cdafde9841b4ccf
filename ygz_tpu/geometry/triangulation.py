"""Batched two-view triangulation (linear DLT).

Replaces the per-point SVD loops of the reference (Initializer::Triangulate,
/root/reference/src/Initializer.cc, and LocalMapping::CreateNewMapPoints
src/LocalMapping.cc:978-1217) with one batched op: the 4x4 normal equations
A^T A are built for all points at once and solved with a batched symmetric
eigendecomposition (smallest eigenvector), which maps well to XLA.
"""
from __future__ import annotations

import jax.numpy as jnp


def triangulate_dlt(P1, P2, uv1, uv2):
    """Batched DLT triangulation.

    Args:
      P1, P2: [3,4] projection matrices (pixel or normalized coords).
      uv1, uv2: [N,2] matched image points in the same coordinate system.
    Returns:
      X: [N,3] triangulated points (homogeneous-normalized).
    """
    # rows of A per point: u*P[2] - P[0]; v*P[2] - P[1]  (for both views)
    def rows(P, uv):
        a = uv[:, 0:1] * P[2][None, :] - P[0][None, :]
        b = uv[:, 1:2] * P[2][None, :] - P[1][None, :]
        return a, b

    a1, b1 = rows(P1, uv1)
    a2, b2 = rows(P2, uv2)
    A = jnp.stack([a1, b1, a2, b2], axis=1)  # [N,4,4]
    AtA = jnp.einsum("nij,nik->njk", A, A)   # [N,4,4] symmetric
    # smallest eigenvector of AtA = homogeneous solution
    _, vecs = jnp.linalg.eigh(AtA)
    Xh = vecs[..., 0]  # [N,4] eigenvector of smallest eigenvalue
    w = Xh[:, 3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return Xh[:, :3] / w[:, None]


def triangulation_checks(R1, t1, R2, t2, X, uv1, uv2, fx, fy, cx, cy,
                         sigma2=1.0, reproj_chi2=4.0, min_parallax_cos=0.99998):
    """Cheirality + reprojection + parallax gates, batched.

    Mirrors Initializer::CheckRT (src/Initializer.cc) semantics: positive
    depth in both views, reprojection chi2 below `reproj_chi2 * sigma2` px^2
    in both views, and parallax angle above threshold.

    (R_i, t_i) map world -> camera i. Returns (good_mask [N] bool,
    cos_parallax [N]).
    """
    Xc1 = X @ R1.T + t1
    Xc2 = X @ R2.T + t2
    z1, z2 = Xc1[:, 2], Xc2[:, 2]

    def reproj_err2(Xc, uv):
        zi = 1.0 / jnp.where(jnp.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        u = fx * Xc[:, 0] * zi + cx
        v = fy * Xc[:, 1] * zi + cy
        du = u - uv[:, 0]
        dv = v - uv[:, 1]
        return du * du + dv * dv

    e1 = reproj_err2(Xc1, uv1)
    e2 = reproj_err2(Xc2, uv2)

    # parallax between the two viewing rays
    O1 = -R1.T @ t1
    O2 = -R2.T @ t2
    r1 = X - O1[None, :]
    r2 = X - O2[None, :]
    n1 = jnp.linalg.norm(r1, axis=1)
    n2 = jnp.linalg.norm(r2, axis=1)
    cosp = jnp.sum(r1 * r2, axis=1) / jnp.maximum(n1 * n2, 1e-12)

    good = ((z1 > 0.0) & (z2 > 0.0)
            & (e1 < reproj_chi2 * sigma2) & (e2 < reproj_chi2 * sigma2)
            & (cosp < min_parallax_cos) & jnp.isfinite(X).all(axis=1))
    return good, cosp
