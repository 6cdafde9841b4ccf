"""Batched inverse-compositional patch alignment (Align2D) + affine warps.

Batched re-design of the reference's per-point 8x8 KLT
(/root/reference/src/Align.cc:8-104: 3-parameter du,dv,dmean alignment, fixed
Hessian from the reference patch, <=10 iterations, 0.03 px convergence) and
the affine patch warp used by direct matching
(ORBmatcher::GetWarpAffineMatrix/WarpAffine src/ORBmatcher.cc:1525-1571).
Instead of one point at a time, ALL candidate map points are aligned
simultaneously: patches live in a [N, P, P] tensor, the 3x3 Hessians are
inverted in closed form, and the iteration loop is a lax.fori_loop over fused
gather + FMA work — one kernel launch for the whole local map.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .image import sample_bilinear

PATCH = 8          # aligned patch side (reference WarpPatchSize=8)
HALF = PATCH / 2.0


def _grid_offsets(size: int):
    """Symmetric subpixel patch grid: size offsets centred on 0."""
    o = jnp.arange(size, dtype=jnp.float32) - (size - 1) / 2.0
    oy, ox = jnp.meshgrid(o, o, indexing="ij")
    return ox, oy  # [size,size]


def sample_patches(img, uv, size: int):
    """Bilinear patches [N,size,size] centred at uv [N,2] (subpixel).

    Shared-fraction gather: every sample in the patch sits on the same
    integer grid shifted by one common subpixel fraction, so the whole
    patch is a bilinear blend of ONE (size+1)^2 integer-aligned gather
    instead of 4*size^2 per-sample corner gathers.
    Results are bit-identical to per-sample bilinear for patches whose
    (size+1)^2 support is in-bounds; callers mask boundary points (as they
    already must — the old per-sample clamp distorted them too)."""
    H, W = img.shape
    o0 = -(size - 1) / 2.0                  # first grid offset
    x = jnp.clip(uv[:, 0], 0.0, W - 1.001) + o0
    y = jnp.clip(uv[:, 1], 0.0, H - 1.001) + o0
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None, None]
    fy = (y - y0)[:, None, None]
    xi = jnp.clip(x0.astype(jnp.int32), 0, W - size - 1)
    yi = jnp.clip(y0.astype(jnp.int32), 0, H - size - 1)
    r = jnp.arange(size + 1)
    idx = ((yi[:, None, None] + r[None, :, None]) * W
           + xi[:, None, None] + r[None, None, :])
    g = jnp.take(img.reshape(-1), idx)      # [N,size+1,size+1]
    top = (1.0 - fx) * g[:, :-1, :-1] + fx * g[:, :-1, 1:]
    bot = (1.0 - fx) * g[:, 1:, :-1] + fx * g[:, 1:, 1:]
    return (1.0 - fy) * top + fy * bot


def warp_affine_patches(ref_img, uv_ref, A_ref_cur, size: int):
    """Ref patches resampled through an affine warp so they look like the
    current frame: patch[n,i,j] = ref(uv_ref[n] + A_ref_cur[n] @ o_ij)."""
    ox, oy = _grid_offsets(size)
    o = jnp.stack([ox, oy], axis=-1)                          # [s,s,2]
    warped = jnp.einsum("nab,ijb->nija", A_ref_cur, o)        # [N,s,s,2]
    pts = warped + uv_ref[:, None, None, :]
    return sample_bilinear(ref_img, pts)


def affine_warp_matrix(X_ref, uv_ref, fx, fy, cx, cy, R_cr, t_cr, fx_c, fy_c,
                       cx_c, cy_c, d=5.0):
    """A_cur_ref [N,2,2]: first-order map from ref-pixel offsets to cur-pixel
    offsets, by finite differences at the point's depth (the scheme of
    ORBmatcher::GetWarpAffineMatrix). All per-point quantities batched.

    X_ref: [N,3] points in the REF camera frame; uv_ref [N,2] their pixels
    (ref level-0); R_cr/t_cr: ref->cur transform.
    """
    z = X_ref[:, 2:3]

    def backproject(duv):
        xn = jnp.stack([(uv_ref[:, 0] + duv[0] - cx) / fx,
                        (uv_ref[:, 1] + duv[1] - cy) / fy], axis=-1)
        # keep the same depth as the centre point
        return jnp.concatenate([xn * z, z], axis=-1)

    # NOTE: uv here must be in "ideal" (undistorted) pixel coords; the direct
    # path always runs on undistorted pyramids.
    def project_cur(Xr):
        Xc = Xr @ R_cr.T + t_cr
        zi = 1.0 / jnp.maximum(Xc[:, 2:3], 1e-6)
        return jnp.concatenate([fx_c * Xc[:, 0:1] * zi + cx_c,
                                fy_c * Xc[:, 1:2] * zi + cy_c], axis=-1)

    c = project_cur(backproject(jnp.array([0.0, 0.0])))
    du = project_cur(backproject(jnp.array([d, 0.0])))
    dv = project_cur(backproject(jnp.array([0.0, d])))
    A = jnp.stack([(du - c) / d, (dv - c) / d], axis=-1)  # columns
    return A  # [N,2,2] maps ref offsets -> cur offsets


def best_search_level(A_cur_ref, max_level: int):
    """Pyramid level where the warped patch's area is ~1 px^2 per pixel
    (ORBmatcher::GetBestSearchLevel include/ORBmatcher.h:226-238)."""
    det = jnp.abs(jnp.linalg.det(A_cur_ref))
    lvl = jnp.ceil(0.5 * jnp.log2(jnp.maximum(det, 1e-6)))
    return jnp.clip(lvl, 0, max_level).astype(jnp.int32)


def _patch_jacobian(ref_border):
    """From bordered ref patches [N,P+2,P+2]: J [N,P*P,3] = [dx,dy,1] and the
    inverse 3x3 Hessian (fixed across iterations — inverse compositional)."""
    inner = ref_border[:, 1:-1, 1:-1]
    dx = 0.5 * (ref_border[:, 1:-1, 2:] - ref_border[:, 1:-1, :-2])
    dy = 0.5 * (ref_border[:, 2:, 1:-1] - ref_border[:, :-2, 1:-1])
    n = ref_border.shape[0]
    P = inner.shape[1]
    J = jnp.stack([dx.reshape(n, P * P), dy.reshape(n, P * P),
                   jnp.ones((n, P * P), ref_border.dtype)], axis=-1)
    H = jnp.einsum("nki,nkj->nij", J, J)
    # regularize tiny bit for textureless patches; they won't converge anyway
    H = H + 1e-4 * jnp.eye(3, dtype=H.dtype)[None]
    return inner, J, jnp.linalg.inv(H)


@functools.partial(jax.jit, static_argnames=("iters",))
def align2d(cur_img, ref_border, uv_init, valid, iters: int = 10,
            eps: float = 0.03):
    """Batched 3-DoF (du, dv, dmean) inverse-compositional KLT.

    Args:
      cur_img: [H,W] current image (one pyramid level).
      ref_border: [N, P+2, P+2] reference patches WITH 1-px border, already
        warped to the current frame's appearance (see warp_affine_patches).
      uv_init: [N,2] starting positions in cur_img coords.
      valid: [N] bool.
    Returns:
      uv [N,2] refined, converged [N] bool, mean_diff [N].
    """
    ref, J, Hinv = _patch_jacobian(ref_border)
    n, P, _ = ref.shape
    ref_flat = ref.reshape(n, P * P)
    H_img, W_img = cur_img.shape

    def body(_, state):
        uv, mean, conv = state
        cur = sample_patches(cur_img, uv, P).reshape(n, P * P)
        r = cur - (ref_flat + mean[:, None])
        g = jnp.einsum("nki,nk->ni", J, r)          # [N,3]
        delta = jnp.einsum("nij,nj->ni", Hinv, g)   # [N,3]
        # inverse-compositional: the warp increment is subtracted, but the
        # mean-brightness term is a ref-side model parameter (r ~= J_uv d_uv
        # + d_mean), so it accumulates positively
        step_uv = delta[:, :2]
        new_uv = uv - step_uv
        new_mean = mean + delta[:, 2]
        done = jnp.sum(step_uv * step_uv, axis=1) < eps * eps
        upd = ~conv  # only move points that have not converged
        uv = jnp.where(upd[:, None], new_uv, uv)
        mean = jnp.where(upd, new_mean, mean)
        return uv, mean, conv | done

    uv0 = uv_init.astype(jnp.float32)
    state = (uv0, jnp.zeros(n, jnp.float32), jnp.zeros(n, bool))
    uv, mean, conv = jax.lax.fori_loop(0, iters, body, state)

    inb = ((uv[:, 0] > HALF + 1) & (uv[:, 0] < W_img - HALF - 2)
           & (uv[:, 1] > HALF + 1) & (uv[:, 1] < H_img - HALF - 2))
    ok = valid & conv & inb
    return uv, ok, mean


@functools.partial(jax.jit, static_argnames=("iters",))
def align2d_stacked(stack, ref_border, uv_init, valid, row_off, w_l, h_l,
                    iters: int = 10, eps: float = 0.03):
    """align2d where every point aligns at its OWN pyramid level inside a
    stacked [SH, W0] pyramid buffer (ops.image.stack_pyramid layout).

    A per-level python loop runs the KLT over ALL N points at ALL L levels
    and masks afterwards — L x the gather volume for the same answer. Here
    each point's level is just a row offset into the stack, so one sweep
    covers the whole local map.

    Args:
      stack: [SH, W0] stacked pyramid.
      ref_border: [N, P+2, P+2] warped reference patches with 1-px border.
      uv_init: [N, 2] starting positions in LEVEL-LOCAL coords.
      valid / row_off / w_l / h_l: [N] level row offset and (W_l, H_l)
        extents of each point's level.
    Returns (uv [N,2] level-local refined, ok [N], mean_diff [N]).
    """
    ref, J, Hinv = _patch_jacobian(ref_border)
    n, P, _ = ref.shape
    ref_flat = ref.reshape(n, P * P)
    off = jnp.stack([jnp.zeros(n, jnp.float32),
                     row_off.astype(jnp.float32)], axis=-1)

    def body(_, state):
        uv, mean, conv = state
        cur = sample_patches(stack, uv + off, P).reshape(n, P * P)
        r = cur - (ref_flat + mean[:, None])
        g = jnp.einsum("nki,nk->ni", J, r)
        delta = jnp.einsum("nij,nj->ni", Hinv, g)
        step_uv = delta[:, :2]
        new_uv = uv - step_uv
        new_mean = mean + delta[:, 2]
        done = jnp.sum(step_uv * step_uv, axis=1) < eps * eps
        upd = ~conv
        uv = jnp.where(upd[:, None], new_uv, uv)
        mean = jnp.where(upd, new_mean, mean)
        return uv, mean, conv | done

    state = (uv_init.astype(jnp.float32), jnp.zeros(n, jnp.float32),
             jnp.zeros(n, bool))
    uv, mean, conv = jax.lax.fori_loop(0, iters, body, state)
    wf = w_l.astype(jnp.float32)
    hf = h_l.astype(jnp.float32)
    inb = ((uv[:, 0] > HALF + 1) & (uv[:, 0] < wf - HALF - 2)
           & (uv[:, 1] > HALF + 1) & (uv[:, 1] < hf - HALF - 2))
    ok = valid & conv & inb
    return uv, ok, mean
