"""Batched Gauss-Newton / Levenberg-Marquardt optimizers for SLAM.

This is the batched replacement for the reference's g2o stack
(/root/reference/Thirdparty/g2o + src/Optimizer.cc): instead of a sparse
pointer graph with CHOLMOD, problems are fixed-capacity arrays of residual
blocks. Landmarks are eliminated with a dense-block Schur complement
(H_pp - H_pl H_ll^-1 H_lp), which maps onto batched 3x3 inverses + einsums;
the reduced camera system (6P x 6P, P <= ~32 for local BA) is solved
densely.

Ported behaviors (constants from SURVEY.md §A):
  * PoseOptimization: 4 rounds x 10 iterations, chi2 gate 5.991 (mono),
    Huber delta = sqrt(5.991), robust kernel dropped in the last rounds
    (Optimizer::PoseOptimization src/Optimizer.cc:1656-1843).
  * LocalBundleAdjustment: 5 iterations, outlier drop at chi2 5.991, then
    10 more (src/Optimizer.cc:1844-2156).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.lie import se3_exp, se3_mul

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _reproj_residual_jac(R, t, X, uv, fx, fy, cx, cy):
    """Residual + Jacobians for one (pose, point, obs) triple — built to be
    vmapped over observations.

    Pose perturbation is LEFT-multiplicative: T <- exp(dxi) * T, so
    dXc/dxi = [I | -Xc^]; dXc/dXw = R.
    Returns r [2], A [2,6] (pose), B [2,3] (point), z (depth).
    """
    Xc = R @ X + t
    x, y, z = Xc[0], Xc[1], Xc[2]
    zc = jnp.maximum(z, 1e-6)
    zi = 1.0 / zc
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    r = jnp.stack([u - uv[0], v - uv[1]])
    dpi = jnp.stack([
        jnp.stack([fx * zi, 0.0 * zi, -fx * x * zi * zi]),
        jnp.stack([0.0 * zi, fy * zi, -fy * y * zi * zi]),
    ])
    Xhat = jnp.stack([
        jnp.stack([0.0 * z, -z, y]),
        jnp.stack([z, 0.0 * z, -x]),
        jnp.stack([-y, x, 0.0 * z]),
    ])
    A = jnp.concatenate([dpi, -(dpi @ Xhat)], axis=1)  # [2,6]
    B = dpi @ R                                        # [2,3]
    return r, A, B, z


_vmapped_rj = jax.vmap(_reproj_residual_jac,
                       in_axes=(0, 0, 0, 0, None, None, None, None))


def _reproj_residual_jac3(R, t, X, uv, ur, bf, fx, fy, cx, cy):
    """Stereo-capable residual: rows (u, v, u_r) with u_r = u - bf/z (the
    reference's 3-D stereo edge, src/Optimizer.cc:1579,1738). Observations
    with ur < 0 are monocular: the third row is zeroed so they contribute
    exactly the 2-D residual."""
    Xc = R @ X + t
    x, y, z = Xc[0], Xc[1], Xc[2]
    zc = jnp.maximum(z, 1e-6)
    zi = 1.0 / zc
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    has = (ur >= 0).astype(jnp.float32)
    r = jnp.stack([u - uv[0], v - uv[1], has * (u - bf * zi - ur)])
    row_u = jnp.stack([fx * zi, 0.0 * zi, -fx * x * zi * zi])
    row_v = jnp.stack([0.0 * zi, fy * zi, -fy * y * zi * zi])
    row_r = (row_u + jnp.stack([0.0 * zi, 0.0 * zi, bf * zi * zi])) * has
    dpi = jnp.stack([row_u, row_v, row_r])               # [3,3] d(r)/d(Xc)
    Xhat = jnp.stack([
        jnp.stack([0.0 * z, -z, y]),
        jnp.stack([z, 0.0 * z, -x]),
        jnp.stack([-y, x, 0.0 * z]),
    ])
    A = jnp.concatenate([dpi, -(dpi @ Xhat)], axis=1)    # [3,6]
    B = dpi @ R                                          # [3,3]
    return r, A, B, z


_vmapped_rj3 = jax.vmap(_reproj_residual_jac3,
                        in_axes=(0, 0, 0, 0, 0, None, None, None, None, None))


def _huber_weight(chi2, delta2):
    """Huber IRLS weight as a function of the squared error (chi2)."""
    return jnp.where(chi2 <= delta2, 1.0,
                     jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))


# ---- robust-cost library (reference include/RobustCost.h:11-151) ---------
# The reference ships Unit/Huber/Tukey/t-dist weight functions and
# Unit/t-dist/MAD/Normal scale estimators for its NLLS solver; its production
# call sites all use Huber, which remains the default throughout this
# backend. The others are provided (batched) for parity and tuning.

TUKEY_B2 = 4.6851 ** 2        # RobustCost.h TukeyWeightFunction default
TDIST_DOF = 5.0               # t-distribution degrees of freedom


def tukey_weight(chi2, b2=TUKEY_B2):
    """Tukey biweight: (1 - chi2/b^2)^2 inside, 0 outside (hard rejection)."""
    x = 1.0 - chi2 / b2
    return jnp.where(chi2 <= b2, x * x, 0.0)


def tdist_weight(chi2, dof=TDIST_DOF):
    """Student-t IRLS weight: (dof+1) / (dof + chi2)."""
    return (dof + 1.0) / (dof + chi2)


def mad_scale(res, valid):
    """Median-absolute-deviation scale: 1.4826 * median(|r - median(r)|)
    over valid entries (RobustCost.h MADScaleEstimator)."""
    big = jnp.float32(1e30)
    r = jnp.where(valid, res, big)
    n = jnp.maximum(valid.sum(), 1)
    med_idx = (n - 1) // 2
    med = jnp.sort(r)[med_idx]
    ad = jnp.where(valid, jnp.abs(res - med), big)
    mad = jnp.sort(ad)[med_idx]
    return 1.4826 * mad


def normal_scale(res, valid):
    """Standard deviation of the valid residuals (NormalDistributionScale)."""
    w = valid.astype(res.dtype)
    n = jnp.maximum(w.sum(), 1.0)
    mu = (res * w).sum() / n
    return jnp.sqrt(((res - mu) ** 2 * w).sum() / n)


def tdist_scale(res, valid, dof=TDIST_DOF, iters: int = 10):
    """t-distribution scale by fixed-point iteration
    (RobustCost.h TDistributionScaleEstimator), batched over all residuals."""
    w = valid.astype(res.dtype)
    n = jnp.maximum(w.sum(), 1.0)
    r2 = res * res

    def body(_, s2):
        lam = (dof + 1.0) / (dof + r2 / jnp.maximum(s2, 1e-12))
        return (lam * r2 * w).sum() / n

    s2 = jax.lax.fori_loop(0, iters, body, jnp.asarray(1.0, res.dtype))
    return jnp.sqrt(s2)


def robust_weight(chi2, kind: str = "huber", delta2=CHI2_MONO):
    """Dispatch IRLS weight by kernel name ('unit'|'huber'|'tukey'|'tdist').
    `kind` must be static under jit."""
    if kind == "unit":
        return jnp.ones_like(chi2)
    if kind == "huber":
        return _huber_weight(chi2, delta2)
    if kind == "tukey":
        return tukey_weight(chi2, delta2 if delta2 else TUKEY_B2)
    if kind == "tdist":
        return tdist_weight(chi2)
    raise ValueError(f"unknown robust kernel: {kind}")


def solve_preconditioned(H, b):
    """Solve H x = b with Jacobi (diagonal) preconditioning.

    SLAM normal equations mix pixel-scale and focal-length-scale entries
    (H entries span ~1e0..1e10); a raw float32 solve loses the weakly
    conditioned directions (z-translation for fronto-parallel scenes) and
    Gauss-Newton stalls. Symmetric Jacobi scaling keeps the solve accurate in
    float32 — the accelerator-friendly alternative to double precision.
    """
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(H), 1e-12))
    Hs = H / (d[:, None] * d[None, :])
    y = jnp.linalg.solve(Hs, b / d)
    return y / d


class PoseOptResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray   # [N] bool
    n_inliers: jnp.ndarray
    chi2: jnp.ndarray      # [N] final per-obs chi2


@functools.partial(jax.jit, static_argnames=("rounds", "iters_per_round"))
def pose_optimization(X, uv, inv_sigma2, valid, R0, t0, intr,
                      rounds: int = 4, iters_per_round: int = 10,
                      chi2_th: float = CHI2_MONO, ur=None, bf=0.0):
    """Pose-only batched GN with staged outlier gating.

    X: [N,3] world points; uv: [N,2] observations; inv_sigma2: [N] per-octave
    information; valid: [N]; (R0,t0): initial world->cam pose.
    ur: optional [N] right-image u coordinate (stereo/RGB-D observations;
    -1 = mono). Stereo rows gate at chi2 7.815, mono at `chi2_th` (reference
    PoseOptimization mono/stereo edge split, src/Optimizer.cc:1656-1843).
    """
    fx, fy, cx, cy = intr
    N = X.shape[0]
    if ur is None:
        ur = jnp.full((N,), -1.0, jnp.float32)
    # per-observation gates: stereo 3-D edges use the 3-DoF chi2 threshold
    th_obs = jnp.where(ur >= 0, CHI2_STEREO * chi2_th / CHI2_MONO, chi2_th)
    delta2 = th_obs  # Huber delta^2 = chi2 threshold (reference: sqrt(5.991))

    def chi2_of(R, t, inl):
        r, _, _, z = _vmapped_rj3(jnp.broadcast_to(R, (N, 3, 3)),
                                  jnp.broadcast_to(t, (N, 3)), X, uv, ur,
                                  bf, fx, fy, cx, cy)
        c2 = jnp.sum(r * r, axis=1) * inv_sigma2
        return c2, z

    def gn_round(R, t, inliers, use_huber):
        def body(_, state):
            R, t = state
            r, A, _, z = _vmapped_rj3(jnp.broadcast_to(R, (N, 3, 3)),
                                      jnp.broadcast_to(t, (N, 3)), X, uv, ur,
                                      bf, fx, fy, cx, cy)
            c2 = jnp.sum(r * r, axis=1) * inv_sigma2
            w = inv_sigma2 * inliers.astype(jnp.float32) * (z > 0.0)
            if use_huber:
                w = w * _huber_weight(c2, delta2)
            H = jnp.einsum("nai,na,naj->ij", A, w[:, None] * jnp.ones_like(r), A)
            b = jnp.einsum("nai,na->i", A, w[:, None] * r)
            H = H + 1e-8 * jnp.trace(H) / 6.0 * jnp.eye(6)
            d = -solve_preconditioned(H, b)
            Rd, td = se3_exp(d)
            return se3_mul(Rd, td, R, t)

        return jax.lax.fori_loop(0, iters_per_round, body, (R, t))

    R, t = R0, t0
    inliers = valid
    for rd in range(rounds):
        use_huber = rd < rounds - 2  # last two rounds: plain LSQ on inliers
        R, t = gn_round(R, t, inliers, use_huber)
        c2, z = chi2_of(R, t, inliers)
        inliers = valid & (c2 < th_obs) & (z > 0.0)

    c2, _ = chi2_of(R, t, inliers)
    return PoseOptResult(R=R, t=t, inliers=inliers,
                         n_inliers=jnp.sum(inliers), chi2=c2)


class BAResult(NamedTuple):
    kf_R: jnp.ndarray      # [P,3,3]
    kf_t: jnp.ndarray      # [P,3]
    points: jnp.ndarray    # [L,3]
    obs_inlier: jnp.ndarray  # [O] bool
    total_chi2: jnp.ndarray


def _build_normal_eqs(kf_R, kf_t, points, obs_p, obs_l, obs_uv, w, intr):
    fx, fy, cx, cy = intr
    r, A, B, z = _vmapped_rj(kf_R[obs_p], kf_t[obs_p], points[obs_l], obs_uv,
                             fx, fy, cx, cy)
    w = w * (z > 0.0)
    wr = w[:, None] * r
    return r, A, B, wr, w


@functools.partial(jax.jit, static_argnames=("n_poses", "n_points", "phases"))
def local_bundle_adjustment(kf_R, kf_t, fixed, points, pt_valid,
                            obs_p, obs_l, obs_uv, obs_inv_sigma2, obs_valid,
                            intr, n_poses: int, n_points: int,
                            phases=(5, 10), chi2_th: float = CHI2_MONO,
                            damping: float = 1e-3, obs_ur=None, bf=0.0):
    """Local BA: joint poses+points GN with Schur complement.

    kf_R/kf_t: [P,..] poses (world->cam); fixed: [P] bool (True = anchor).
    points: [L,3]; obs_*: [O] observation table (pose idx, point idx, pixel,
    information, validity). obs_ur: optional [O] right-image u (stereo 3-D
    edges at chi2 7.815, -1 = mono — reference src/Optimizer.cc:1579,1738).
    phases: iteration counts; between phases observations with chi2 > th are
    dropped (reference 5 + 10, src/Optimizer.cc:2031-2068).
    """
    fx, fy, cx, cy = intr
    P, L = n_poses, n_points
    O = obs_p.shape[0]
    if obs_ur is None:
        obs_ur = jnp.full((O,), -1.0, jnp.float32)
    th_obs = jnp.where(obs_ur >= 0, CHI2_STEREO * chi2_th / CHI2_MONO,
                       chi2_th)
    delta2 = th_obs
    free = (~fixed).astype(jnp.float32)

    def chi2_all(kf_R, kf_t, points):
        r, _, _, z = _vmapped_rj3(kf_R[obs_p], kf_t[obs_p], points[obs_l],
                                  obs_uv, obs_ur, bf, fx, fy, cx, cy)
        return jnp.sum(r * r, axis=1) * obs_inv_sigma2, z

    def one_iter(state, _):
        kf_R, kf_t, points, inlier, lam = state
        r, A, B, z = _vmapped_rj3(kf_R[obs_p], kf_t[obs_p], points[obs_l],
                                  obs_uv, obs_ur, bf, fx, fy, cx, cy)
        c2 = jnp.sum(r * r, axis=1) * obs_inv_sigma2
        w = (obs_inv_sigma2 * inlier.astype(jnp.float32) * (z > 0.0)
             * _huber_weight(c2, delta2))

        # block accumulations
        Aw = A * w[:, None, None]
        U = jax.ops.segment_sum(jnp.einsum("nai,naj->nij", Aw, A), obs_p, P)
        V = jax.ops.segment_sum(jnp.einsum("nai,naj->nij", B * w[:, None, None], B),
                                obs_l, L)
        Wb = jnp.einsum("nai,naj->nij", Aw, B)            # [O,6,3]
        bp = -jax.ops.segment_sum(jnp.einsum("nai,na->ni", Aw, r), obs_p, P)
        bl = -jax.ops.segment_sum(
            jnp.einsum("nai,na->ni", B * w[:, None, None], r), obs_l, L)

        # damping (LM)
        V = V + lam * jnp.eye(3)[None]
        Vinv = jnp.linalg.inv(V)

        # scatter W into the dense [L,P,6,3] coupling tensor
        M = jax.ops.segment_sum(Wb, obs_l * P + obs_p, L * P)
        M = M.reshape(L, P, 6, 3)

        # Schur complement S = U_blockdiag - M Vinv M^T (pose-pose coupling)
        T_ = jnp.einsum("lpik,lkm->lpim", M, Vinv)          # [L,P,6,3]
        S_off = jnp.einsum("lpim,lqjm->piqj", T_, M)        # [P,6,P,6]
        S = -S_off
        diag = jnp.arange(P)
        S = S.at[diag, :, diag, :].add(U + lam * jnp.eye(6)[None])
        g = bp - jnp.einsum("lpim,lm->pi", T_, bl)          # [P,6]

        # gauge/fixed poses: zero their rows/cols, identity diagonal
        fm = free[:, None]  # [P,1]
        S = S * fm[:, :, None, None] * fm[None, None, :, :]
        S = S.at[diag, :, diag, :].add(
            (1.0 - free)[:, None, None] * jnp.eye(6)[None])
        g = g * fm

        Sd = S.reshape(P * 6, P * 6)
        dp = solve_preconditioned(Sd, g.reshape(P * 6)).reshape(P, 6)
        dp = dp * fm

        # back-substitute landmarks
        rhs = bl - jnp.einsum("lpim,pi->lm", M, dp)
        dl = jnp.einsum("lij,lj->li", Vinv, rhs)
        dl = dl * pt_valid[:, None]

        # candidate update
        def upd_pose(Rp, tp, d):
            Rd, td = se3_exp(d)
            return se3_mul(Rd, td, Rp, tp)

        newR, newt = jax.vmap(upd_pose)(kf_R, kf_t, dp)
        newpts = points + dl

        old_c2, _ = chi2_all(kf_R, kf_t, points)
        new_c2, _ = chi2_all(newR, newt, newpts)
        wsel = inlier.astype(jnp.float32)
        accept = jnp.sum(new_c2 * wsel) < jnp.sum(old_c2 * wsel)
        kf_R = jnp.where(accept, newR, kf_R)
        kf_t = jnp.where(accept, newt, kf_t)
        points = jnp.where(accept, newpts, points)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-6, 1e3)
        return (kf_R, kf_t, points, inlier, lam), None

    inlier = obs_valid & pt_valid[obs_l]
    lam = jnp.array(damping, jnp.float32)
    for it_count in phases:
        (kf_R, kf_t, points, inlier, lam), _ = jax.lax.scan(
            one_iter, (kf_R, kf_t, points, inlier, lam), None, length=it_count)
        c2, z = chi2_all(kf_R, kf_t, points)
        inlier = inlier & (c2 < th_obs) & (z > 0.0)

    c2, _ = chi2_all(kf_R, kf_t, points)
    total = jnp.sum(jnp.where(inlier, c2, 0.0))
    return BAResult(kf_R=kf_R, kf_t=kf_t, points=points, obs_inlier=inlier,
                    total_chi2=total)
