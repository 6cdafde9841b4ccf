"""Robust PnP for relocalization: batched linear-PnP RANSAC + GN polish.

Replaces the reference's EPnP+RANSAC (/root/reference/src/PnPsolver.cc,
used only by relocalization, src/Tracking.cc:1826-1978). Batched design:
instead of EPnP's control-point machinery iterated sequentially, ALL RANSAC
hypotheses are solved simultaneously — each 6-point sample through the DLT
(12x12 normal-equations eigenvector), rotations re-orthonormalized by SVD —
then every hypothesis is scored against every correspondence in one
broadcast, and the winner is polished by the batched pose GN
(backend.optim.pose_optimization).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .optim import pose_optimization, CHI2_MONO


class PnPResult(NamedTuple):
    ok: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


def _dlt_pose(X, uvn):
    """Linear PnP from k>=6 points: X [k,3] world, uvn [k,2] NORMALIZED image
    coords. Returns (R [3,3], t [3])."""
    k = X.shape[0]
    zeros = jnp.zeros((k, 4), X.dtype)
    Xh = jnp.concatenate([X, jnp.ones((k, 1), X.dtype)], axis=1)
    r1 = jnp.concatenate([Xh, zeros, -uvn[:, 0:1] * Xh], axis=1)
    r2 = jnp.concatenate([zeros, Xh, -uvn[:, 1:2] * Xh], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # [2k,12]
    AtA = A.T @ A
    _, V = jnp.linalg.eigh(AtA)
    p = V[:, 0].reshape(3, 4)
    Rraw = p[:, :3]
    # orthonormalize + resolve scale/sign (points must be in front)
    U, S, Vt = jnp.linalg.svd(Rraw)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], X.dtype).at[2].set(det))
    R = U @ D @ Vt
    scale = jnp.sum(S) / 3.0 * det  # signed mean singular value
    t = p[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    # flip if median depth negative
    z = X @ R.T[:, 2] + t[2]
    flip = jnp.sum(jnp.sign(z)) < 0
    R = jnp.where(flip, -R, R)
    t = jnp.where(flip, -t, t)
    # restore proper rotation if flipped (det -R = -det R for 3x3)
    U2, _, Vt2 = jnp.linalg.svd(R)
    det2 = jnp.linalg.det(U2 @ Vt2)
    D2 = jnp.diag(jnp.array([1.0, 1.0, 1.0], X.dtype).at[2].set(det2))
    R = U2 @ D2 @ Vt2
    return R, t


def _kabsch(Xw, Xc):
    """Rigid transform (R, t) with Xc ~= R @ Xw + t (least squares)."""
    cw = Xw.mean(axis=0)
    cc = Xc.mean(axis=0)
    H = (Xw - cw).T @ (Xc - cc)
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(Vt.T @ U.T)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], Xw.dtype).at[2].set(det))
    R = Vt.T @ D @ U.T
    t = cc - R @ cw
    return R, t


_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _epnp_pose(X, uvn):
    """Control-point EPnP from s>=4 points (the reference PnPsolver's
    algorithm, /root/reference/src/PnPsolver.cc — choose_control_points
    :?, compute_barycentric_coordinates, fill_M, nullspace betas cases
    N=1/N=2 + Gauss-Newton on the betas), fully traceable so RANSAC can
    vmap it over hundreds of minimal samples at once.

    X [s,3] world points, uvn [s,2] normalized image coords."""
    s = X.shape[0]
    dtype = X.dtype
    # ---- control points: centroid + PCA axes --------------------------
    c0 = X.mean(axis=0)
    A = X - c0
    w, E = jnp.linalg.eigh(A.T @ A / s)          # ascending
    sig = jnp.sqrt(jnp.clip(w, 1e-10))
    Cw = jnp.concatenate([c0[None], c0[None] + sig[:, None] * E.T], axis=0)
    # ---- barycentric coordinates --------------------------------------
    Cmat = jnp.concatenate([Cw.T, jnp.ones((1, 4), dtype)], axis=0)  # [4,4]
    # ridge keeps near-planar samples solvable (the 4th axis degenerates)
    Cinv = jnp.linalg.inv(Cmat + 1e-8 * jnp.eye(4, dtype=dtype))
    Xh = jnp.concatenate([X, jnp.ones((s, 1), dtype)], axis=1)       # [s,4]
    alph = Xh @ Cinv.T                                               # [s,4]
    # ---- M matrix + nullspace -----------------------------------------
    u, v = uvn[:, 0], uvn[:, 1]
    one = jnp.ones_like(u)
    zero = jnp.zeros_like(u)
    M1 = jnp.einsum("sj,sk->sjk", alph, jnp.stack([one, zero, -u], 1))
    M2 = jnp.einsum("sj,sk->sjk", alph, jnp.stack([zero, one, -v], 1))
    M = jnp.concatenate([M1.reshape(s, 12), M2.reshape(s, 12)], axis=0)
    _, V = jnp.linalg.eigh(M.T @ M)
    v1 = V[:, 0].reshape(4, 3)
    v2 = V[:, 1].reshape(4, 3)
    # ---- betas from the 6 pairwise control-point distances ------------
    ia = jnp.array([a for a, b in _PAIRS])
    ib = jnp.array([b for a, b in _PAIRS])
    dw2 = jnp.sum((Cw[ia] - Cw[ib]) ** 2, axis=1)         # [6]
    dv1 = v1[ia] - v1[ib]                                  # [6,3]
    dv2 = v2[ia] - v2[ib]

    def refine_betas(b1, b2, iters=5):
        """GN on (b1,b2): minimize sum_k (||b1 dv1 + b2 dv2||^2 - dw2)^2."""
        def body(_, bb):
            b1, b2 = bb
            d = b1 * dv1 + b2 * dv2
            r = jnp.sum(d * d, axis=1) - dw2               # [6]
            J = jnp.stack([2.0 * jnp.sum(d * dv1, axis=1),
                           2.0 * jnp.sum(d * dv2, axis=1)], axis=1)
            H = J.T @ J + 1e-9 * jnp.eye(2, dtype=dtype)
            g = J.T @ r
            db = jnp.linalg.solve(H, g)
            return b1 - db[0], b2 - db[1]
        return jax.lax.fori_loop(0, iters, body, (b1, b2))

    # case N=1 closed form (PnPsolver::compute_betas_approx_1 analog)
    b1_c1 = (jnp.sum(jnp.sqrt(jnp.sum(dv1 * dv1, axis=1) * dw2))
             / jnp.maximum(jnp.sum(dv1 * dv1), 1e-12))
    b1_c1, b2_c1 = refine_betas(b1_c1, jnp.zeros((), dtype))
    # case N=2: least squares on (b11, b12, b22)
    L = jnp.stack([jnp.sum(dv1 * dv1, axis=1),
                   2.0 * jnp.sum(dv1 * dv2, axis=1),
                   jnp.sum(dv2 * dv2, axis=1)], axis=1)    # [6,3]
    bb, _, _, _ = jnp.linalg.lstsq(L, dw2)
    b1_c2 = jnp.sqrt(jnp.abs(bb[0]))
    b2_c2 = (jnp.sqrt(jnp.abs(bb[2]))
             * jnp.sign(bb[1]) * jnp.sign(bb[0]))
    b1_c2, b2_c2 = refine_betas(b1_c2, b2_c2)

    def pose_from_betas(b1, b2):
        Cc = b1 * v1 + b2 * v2                             # [4,3]
        Xc = alph @ Cc                                     # [s,3]
        # cheirality: the nullspace sign is arbitrary
        flip = jnp.sum(jnp.sign(Xc[:, 2])) < 0
        Xc = jnp.where(flip, -Xc, Xc)
        R, t = _kabsch(X, Xc)
        Xp = X @ R.T + t
        zi = 1.0 / jnp.maximum(Xp[:, 2], 1e-6)
        err = jnp.sum((Xp[:, 0] * zi - u) ** 2 + (Xp[:, 1] * zi - v) ** 2)
        return R, t, err

    R1, t1, e1 = pose_from_betas(b1_c1, b2_c1)
    R2, t2, e2 = pose_from_betas(b1_c2, b2_c2)
    better2 = e2 < e1
    R = jnp.where(better2, R2, R1)
    t = jnp.where(better2, t2, t1)
    return R, t, jnp.minimum(e1, e2)


def _epnp_planar(X, uvn):
    """3-control-point EPnP for (near-)planar samples: centroid + the two
    in-plane principal axes, 9-dim nullspace. The 4-point general variant
    degenerates there (its barycentric inversion loses the out-of-plane
    axis). Returns (R, t, sample reprojection error)."""
    s = X.shape[0]
    dtype = X.dtype
    c0 = X.mean(axis=0)
    A = X - c0
    w, E = jnp.linalg.eigh(A.T @ A / s)          # ascending
    sig = jnp.sqrt(jnp.clip(w, 1e-10))
    # two LARGEST axes (in-plane)
    Cw = jnp.concatenate([c0[None],
                          c0[None] + sig[2] * E.T[2][None],
                          c0[None] + sig[1] * E.T[1][None]], axis=0)  # [3,3]
    Cmat = jnp.concatenate([Cw.T, jnp.ones((1, 3), dtype)], axis=0)  # [4,3]
    Xh = jnp.concatenate([X, jnp.ones((s, 1), dtype)], axis=1)       # [s,4]
    alph, _, _, _ = jnp.linalg.lstsq(Cmat, Xh.T)                     # [3,s]
    alph = alph.T                                                    # [s,3]
    u, v = uvn[:, 0], uvn[:, 1]
    one = jnp.ones_like(u)
    zero = jnp.zeros_like(u)
    M1 = jnp.einsum("sj,sk->sjk", alph, jnp.stack([one, zero, -u], 1))
    M2 = jnp.einsum("sj,sk->sjk", alph, jnp.stack([zero, one, -v], 1))
    M = jnp.concatenate([M1.reshape(s, 9), M2.reshape(s, 9)], axis=0)
    _, V = jnp.linalg.eigh(M.T @ M)
    v1 = V[:, 0].reshape(3, 3)
    v2 = V[:, 1].reshape(3, 3)
    ia = jnp.array([0, 0, 1])
    ib = jnp.array([1, 2, 2])
    dw2 = jnp.sum((Cw[ia] - Cw[ib]) ** 2, axis=1)
    dv1 = v1[ia] - v1[ib]
    dv2 = v2[ia] - v2[ib]

    def refine(b1, b2, iters=5):
        def body(_, bb):
            b1, b2 = bb
            d = b1 * dv1 + b2 * dv2
            r = jnp.sum(d * d, axis=1) - dw2
            J = jnp.stack([2.0 * jnp.sum(d * dv1, axis=1),
                           2.0 * jnp.sum(d * dv2, axis=1)], axis=1)
            H = J.T @ J + 1e-9 * jnp.eye(2, dtype=dtype)
            db = jnp.linalg.solve(H, J.T @ r)
            return b1 - db[0], b2 - db[1]
        return jax.lax.fori_loop(0, iters, body, (b1, b2))

    b1a = (jnp.sum(jnp.sqrt(jnp.sum(dv1 * dv1, axis=1) * dw2))
           / jnp.maximum(jnp.sum(dv1 * dv1), 1e-12))
    b1a, b2a = refine(b1a, jnp.zeros((), dtype))
    L = jnp.stack([jnp.sum(dv1 * dv1, axis=1),
                   2.0 * jnp.sum(dv1 * dv2, axis=1),
                   jnp.sum(dv2 * dv2, axis=1)], axis=1)
    bb, _, _, _ = jnp.linalg.lstsq(L, dw2)
    b1b = jnp.sqrt(jnp.abs(bb[0]))
    b2b = jnp.sqrt(jnp.abs(bb[2])) * jnp.sign(bb[1]) * jnp.sign(bb[0])
    b1b, b2b = refine(b1b, b2b)

    def pose_from(b1, b2):
        Cc = b1 * v1 + b2 * v2
        Xc = alph @ Cc
        flip = jnp.sum(jnp.sign(Xc[:, 2])) < 0
        Xc = jnp.where(flip, -Xc, Xc)
        R, t = _kabsch(X, Xc)
        Xp = X @ R.T + t
        zi = 1.0 / jnp.maximum(Xp[:, 2], 1e-6)
        err = jnp.sum((Xp[:, 0] * zi - u) ** 2 + (Xp[:, 1] * zi - v) ** 2)
        return R, t, err

    Ra, ta, ea = pose_from(b1a, b2a)
    Rb, tb, eb = pose_from(b1b, b2b)
    bbetter = eb < ea
    return (jnp.where(bbetter, Rb, Ra), jnp.where(bbetter, tb, ta),
            jnp.minimum(ea, eb))


def _epnp_best(X, uvn):
    """General + planar EPnP, winner by sample reprojection error — no
    data-dependent branching, so RANSAC vmaps it."""
    R4, t4, e4 = _epnp_pose(X, uvn)
    R3, t3, e3 = _epnp_planar(X, uvn)
    use3 = e3 < e4
    return jnp.where(use3, R3, R4), jnp.where(use3, t3, t4)


def pnp_ransac(X, uv, valid, intr, key, num_iters: int = 300,
               min_inliers: int = 10, chi2: float = CHI2_MONO,
               inv_sigma2=None, min_set: int = 4):
    """Full robust PnP. X [N,3] world points, uv [N,2] pixel obs.

    Follows the reference's relocalization parameters
    (SetRansacParameters(0.99, 10, 300, 4, 0.5, 5.991),
    src/Tracking.cc:1872): EPnP on 4-point minimal sets (min_set=4); the
    6-point linear DLT remains available with min_set>=6."""
    fx, fy, cx, cy = intr
    N = X.shape[0]
    if inv_sigma2 is None:
        inv_sigma2 = jnp.ones(N)
    uvn = jnp.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)

    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    keys = jax.random.split(key, num_iters)
    idx = jax.vmap(lambda k: jax.random.choice(
        k, N, shape=(min_set,), replace=False, p=probs))(keys)
    solver = _epnp_best if min_set < 6 else _dlt_pose
    Rs, ts = jax.vmap(lambda i: solver(X[i], uvn[i]))(idx)

    def count(R, t):
        Xc = X @ R.T + t
        zi = 1.0 / jnp.maximum(Xc[:, 2], 1e-6)
        u = fx * Xc[:, 0] * zi + cx
        v = fy * Xc[:, 1] * zi + cy
        e2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
        inl = valid & (e2 < chi2) & (Xc[:, 2] > 0)
        return jnp.sum(inl), inl

    counts, _ = jax.vmap(count)(Rs, ts)
    best = jnp.argmax(counts)
    res = pose_optimization(X, uv, inv_sigma2, valid, Rs[best], ts[best],
                            intr, chi2_th=chi2)
    return PnPResult(ok=res.n_inliers >= min_inliers, R=res.R, t=res.t,
                     inliers=res.inliers, n_inliers=res.n_inliers)
