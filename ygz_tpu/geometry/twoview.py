"""Two-view relative geometry: batched H/F RANSAC + motion recovery.

Batched re-design of the reference monocular initializer
(/root/reference/src/Initializer.cc, include/Initializer.h:23-162): instead of
200 sequential RANSAC iterations with per-iteration 8-point solves, ALL sample
sets are solved simultaneously (vmapped 9x9 eigen-solves), all models are
scored against all matches in one broadcasted pass, and the 4 (F) / 8 (H)
motion hypotheses are cheirality-checked as one batched triangulation.

Scoring constants follow the reference: sigma=1.0, chi2 gates 5.991 (H) and
3.841 (F) with score contribution (5.991 - chi2) per direction
(Initializer::CheckHomography / CheckFundamental), model selection by
S_H/(S_H+S_F) > 0.40, acceptance via CheckRT-style counting.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .triangulation import triangulate_dlt, triangulation_checks

CHI2_H = 5.991
CHI2_F = 3.841
TH_SCORE = 5.991


def normalize_points(pts, mask):
    """Hartley normalization with mean-absolute-deviation scaling (the scheme
    the reference uses in Initializer::Normalize). Returns (pts_n, T [3,3])."""
    w = mask.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.abs(pts - mean) * w[:, None]
    mdev = jnp.sum(d, axis=0) / n
    s = 1.0 / jnp.maximum(mdev, 1e-8)
    pts_n = (pts - mean) * s[None, :]
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                  dtype=pts.dtype)
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return pts_n, T


def _nullvec9(A):
    """Smallest right singular vector of A [m,9] via eigh of A^T A."""
    AtA = A.T @ A
    _, V = jnp.linalg.eigh(AtA)
    return V[:, 0]


def fit_homography(p1, p2):
    """DLT homography from k>=4 correspondences [k,2] -> H [3,3] (p2 ~ H p1)."""
    k = p1.shape[0]
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros(k, dtype=p1.dtype)
    o = jnp.ones(k, dtype=p1.dtype)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)
    h = _nullvec9(A)
    return h.reshape(3, 3)


def fit_fundamental(p1, p2):
    """8-point fundamental matrix from k>=8 correspondences, rank-2 enforced."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    o = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o],
                  axis=1)
    f = _nullvec9(A)
    F = f.reshape(3, 3)
    U, s, Vt = jnp.linalg.svd(F)
    s = s.at[2].set(0.0)
    return (U * s[None, :]) @ Vt


def score_homography(H, p1, p2, mask, sigma2=1.0):
    """Symmetric-transfer chi2 score; returns (score, inliers [N] bool)."""
    Hinv = jnp.linalg.inv(H)

    def transfer(M, a):
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], axis=1)
        b = ah @ M.T
        w = jnp.where(jnp.abs(b[:, 2:3]) < 1e-12, 1e-12, b[:, 2:3])
        return b[:, :2] / w

    e21 = jnp.sum((p1 - transfer(Hinv, p2)) ** 2, axis=1) / sigma2
    e12 = jnp.sum((p2 - transfer(H, p1)) ** 2, axis=1) / sigma2
    in1 = e21 < CHI2_H
    in2 = e12 < CHI2_H
    sc = (jnp.where(in1, CHI2_H - e21, 0.0) + jnp.where(in2, CHI2_H - e12, 0.0))
    inl = in1 & in2 & mask
    return jnp.sum(sc * mask), inl


def score_fundamental(F, p1, p2, mask, sigma2=1.0):
    """Epipolar-distance chi2 score; returns (score, inliers)."""
    o = jnp.ones_like(p1[:, :1])
    p1h = jnp.concatenate([p1, o], axis=1)
    p2h = jnp.concatenate([p2, o], axis=1)
    l2 = p1h @ F.T      # epipolar line in image 2
    l1 = p2h @ F        # epipolar line in image 1
    d2 = jnp.sum(p2h * l2, axis=1) ** 2 / jnp.maximum(
        l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12) / sigma2
    d1 = jnp.sum(p1h * l1, axis=1) ** 2 / jnp.maximum(
        l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12) / sigma2
    in1 = d1 < CHI2_F
    in2 = d2 < CHI2_F
    sc = (jnp.where(in1, TH_SCORE - d1, 0.0) + jnp.where(in2, TH_SCORE - d2, 0.0))
    inl = in1 & in2 & mask
    return jnp.sum(sc * mask), inl


def _ransac(fit_fn, score_fn, p1, p2, mask, key, num_iters, sample_size,
            denorm):
    """Fully batched RANSAC: vmapped model fits + broadcast scoring.

    Points are Hartley-normalized once globally (like the reference, which
    normalizes the full match set before RANSAC); `denorm(Mn, T1, T2)` maps a
    model fit in normalized coords back to pixel coords for scoring.
    """
    n = p1.shape[0]
    p1n, T1 = normalize_points(p1, mask)
    p2n, T2 = normalize_points(p2, mask)
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    keys = jax.random.split(key, num_iters)
    idx = jax.vmap(lambda k: jax.random.choice(
        k, n, shape=(sample_size,), replace=False, p=probs))(keys)  # [S,k]
    s1 = p1n[idx]  # [S,k,2]
    s2 = p2n[idx]

    models_n = jax.vmap(fit_fn)(s1, s2)  # [S,3,3] in normalized coords
    models = jax.vmap(lambda M: denorm(M, T1, T2))(models_n)
    scores, inls = jax.vmap(lambda M: score_fn(M, p1, p2, mask))(models)
    best = jnp.argmax(scores)
    return models[best], scores[best], inls[best]


def _denorm_h(Hn, T1, T2):
    """p2n ~ Hn p1n with pin = Ti pi  =>  H = T2^-1 Hn T1."""
    return jnp.linalg.inv(T2) @ Hn @ T1


def _denorm_f(Fn, T1, T2):
    """p2n^T Fn p1n = 0  =>  F = T2^T Fn T1."""
    return T2.T @ Fn @ T1


def _motion_hypotheses_from_F(F, K):
    """E = K^T F K -> 4 (R,t) hypotheses [4,3,3], [4,3]."""
    E = K.T @ F @ K
    U, _, Vt = jnp.linalg.svd(E)
    # ensure proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                  dtype=F.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _motion_hypotheses_from_H(H, K):
    """Faugeras decomposition of A = K^-1 H K -> 8 (R,t) hypotheses."""
    Kinv = jnp.linalg.inv(K)
    A = Kinv @ H @ K
    U, d, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(V)
    d1, d2, d3 = d[0], d[1], d[2]

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.array([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.array([1.0, -1.0, 1.0, -1.0]) * aux3

    def case_dprime_pos(x1, x3):
        st = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) \
            / jnp.maximum((d1 + d3) * d2, 1e-12)
        ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
        eps = x1 * x3  # sign(e1)*sign(e3): x1 = e1*aux1, x3 = e3*aux3
        sgn = jnp.sign(jnp.where(eps == 0, 1.0, eps))
        Rp = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        Rp = Rp.at[0, 0].set(ct).at[2, 2].set(ct)
        Rp = Rp.at[0, 2].set(-sgn * st).at[2, 0].set(sgn * st)
        tp = jnp.stack([x1, 0.0 * x1, -x3]) * (d1 - d3)
        R = s * (U @ Rp @ Vt)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    def case_dprime_neg(x1, x3):
        sp = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) \
            / jnp.maximum((d1 - d3) * d2, 1e-12)
        cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
        eps = x1 * x3
        sgn = jnp.sign(jnp.where(eps == 0, 1.0, eps))
        Rp = jnp.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
        Rp = Rp.at[0, 0].set(cp).at[2, 2].set(-cp)
        Rp = Rp.at[0, 2].set(sgn * sp).at[2, 0].set(sgn * sp)
        tp = jnp.stack([x1, 0.0 * x1, x3]) * (d1 + d3)
        R = s * (U @ Rp @ Vt)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs_p, ts_p = jax.vmap(case_dprime_pos)(x1s, x3s)
    Rs_n, ts_n = jax.vmap(case_dprime_neg)(x1s, x3s)
    return jnp.concatenate([Rs_p, Rs_n]), jnp.concatenate([ts_p, ts_n])


class TwoViewResult(NamedTuple):
    ok: jnp.ndarray          # scalar bool
    used_h: jnp.ndarray      # scalar bool
    R: jnp.ndarray           # [3,3] world(cam1)->cam2
    t: jnp.ndarray           # [3]
    points: jnp.ndarray      # [N,3] triangulated (in cam1 frame)
    good: jnp.ndarray        # [N] bool triangulation-valid mask
    inliers: jnp.ndarray     # [N] bool model inliers
    n_good: jnp.ndarray      # scalar int


def two_view_reconstruct(p1, p2, mask, K, key, num_iters=200,
                         min_triangulated=50, min_parallax_cos=0.99966):
    """Full monocular two-view bootstrapping, jittable end to end.

    Args:
      p1, p2: [N,2] matched (undistorted) pixel coords in frames 1, 2.
      mask:   [N] bool valid-match mask.
      K:      [3,3] intrinsics.
    Returns TwoViewResult; `ok` is the acceptance decision (host reads one
    scalar). Points are triangulated with cam1 as the world frame.
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    H, sh, inl_h = _ransac(fit_homography, score_homography, p1, p2, mask, key,
                           num_iters, 8, _denorm_h)
    F, sf, inl_f = _ransac(fit_fundamental, score_fundamental, p1, p2, mask,
                           jax.random.fold_in(key, 1), num_iters, 8, _denorm_f)
    rh = sh / jnp.maximum(sh + sf, 1e-12)
    use_h = rh > 0.40

    Rh, th_ = _motion_hypotheses_from_H(H, K)
    Rf, tf_ = _motion_hypotheses_from_F(F, K)
    Rs = jnp.concatenate([Rh, Rf])        # [12,3,3]
    ts = jnp.concatenate([th_, tf_])      # [12,3]
    # hypothesis i active only for the chosen model family
    hyp_active = jnp.concatenate([jnp.repeat(use_h, 8),
                                  jnp.repeat(~use_h, 4)])
    inliers = jnp.where(use_h, inl_h, inl_f)

    I3 = jnp.eye(3, dtype=p1.dtype)
    z3 = jnp.zeros(3, dtype=p1.dtype)
    P1 = K @ jnp.concatenate([I3, z3[:, None]], axis=1)

    def check(R, t):
        P2 = K @ jnp.concatenate([R, t[:, None]], axis=1)
        X = triangulate_dlt(P1, P2, p1, p2)
        good, cosp = triangulation_checks(
            I3, z3, R, t, X, p1, p2, fx, fy, cx, cy,
            sigma2=1.0, reproj_chi2=4.0, min_parallax_cos=0.99999999)
        good = good & inliers
        # parallax of the 50th-best point (reference takes the 50th-smallest
        # cos among good ones); approximate with a masked sort.
        cp = jnp.where(good, cosp, 1.0)
        cp_sorted = jnp.sort(cp)
        k = jnp.minimum(49, jnp.maximum(jnp.sum(good) - 1, 0))
        parallax_cos = cp_sorted[k]
        return jnp.sum(good), parallax_cos, X, good

    ngood, pcos, Xs, goods = jax.vmap(check)(Rs, ts)
    ngood = jnp.where(hyp_active, ngood, -1)
    best = jnp.argmax(ngood)
    nbest = ngood[best]
    nsecond = jnp.max(jnp.where(jnp.arange(12) == best, -1, ngood))
    n_inl = jnp.sum(inliers)

    ok = ((nbest >= min_triangulated)
          & (nbest.astype(jnp.float32) > 0.8 * n_inl.astype(jnp.float32))
          & (nsecond.astype(jnp.float32) < 0.75 * nbest.astype(jnp.float32))
          & (pcos[best] < min_parallax_cos))

    return TwoViewResult(ok=ok, used_h=use_h, R=Rs[best], t=ts[best],
                         points=Xs[best], good=goods[best], inliers=inliers,
                         n_good=nbest)
