"""Direct local-map tracking: warp stored ref patches + batched KLT + pose GN.

Batched re-design of the reference direct tracking path
(Tracking::TrackLocalMapDirect /root/reference/src/Tracking.cc:2191,
SearchLocalPointsDirect :2258, ORBmatcher::FindDirectProjection
src/ORBmatcher.cc:1573-1602): every cached map point carries a stored
reference patch (see backend/mapstate.py); one jitted megafunction projects
all points, computes per-point affine warps and search levels, aligns all
patches with the batched Align2D, and runs the staged pose-only GN — a single
device round-trip per frame instead of hundreds of per-point host loops.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..backend.mapstate import REF_PATCH
from ..backend.optim import pose_optimization
from ..ops.align import _grid_offsets
from ..ops.image import in_bounds, as_levels

WARP_BORDER = 10  # warped patch side = 8 + 2 border


class DirectTrackResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    tracked: jnp.ndarray    # [N] bool: aligned + pose-opt inlier
    aligned: jnp.ndarray    # [N] bool: KLT converged
    visible: jnp.ndarray    # [N] bool: in predicted frustum
    uv: jnp.ndarray         # [N,2] refined level-0 coords
    level: jnp.ndarray      # [N] search level used
    n_inliers: jnp.ndarray


def _inv2x2(A):
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = jnp.where(jnp.abs(det) < 1e-8, 1e-8, det)
    inv = jnp.stack([
        jnp.stack([A[..., 1, 1], -A[..., 0, 1]], -1),
        jnp.stack([-A[..., 1, 0], A[..., 0, 0]], -1),
    ], -2)
    return inv / det[..., None, None]


def _warp_setup(cur_pyr, R_pred, t_pred, pt_xyz, pt_valid, pt_patch,
                pt_ref_uv, pt_ref_level, pt_ref_R, pt_ref_t, intr,
                n_levels: int):
    """Shared front half of direct tracking: project with the predicted
    pose, compute per-point affine warps cur<-ref, pick search levels, and
    warp the stored reference patches. Returns (visible, lvl, warped,
    warp_ok)."""
    fx, fy, cx, cy = intr
    h0, w0 = cur_pyr[0].shape

    # ---- project with predicted pose --------------------------------------
    Xc = pt_xyz @ R_pred.T + t_pred
    z = Xc[:, 2]
    zi = 1.0 / jnp.maximum(z, 1e-6)
    uv_pred = jnp.stack([fx * Xc[:, 0] * zi + cx, fy * Xc[:, 1] * zi + cy], -1)
    visible = pt_valid & (z > 0.1) & in_bounds(uv_pred, w0, h0, border=20)

    # ---- per-point affine warp cur<-ref (finite differences, d=5 px) ------
    # point in its reference camera frame
    X_ref = jnp.einsum("nij,nj->ni", pt_ref_R, pt_xyz) + pt_ref_t
    z_ref = jnp.maximum(X_ref[:, 2], 1e-6)
    Rwr = pt_ref_R.transpose(0, 2, 1)          # ref cam -> world

    def ref_pix_to_cur(duv):
        xn = jnp.stack([(pt_ref_uv[:, 0] + duv[0] - cx) / fx,
                        (pt_ref_uv[:, 1] + duv[1] - cy) / fy], -1)
        Xr = jnp.concatenate([xn * z_ref[:, None], z_ref[:, None]], -1)
        Xw = jnp.einsum("nij,nj->ni", Rwr, Xr - pt_ref_t)
        Xc2 = Xw @ R_pred.T + t_pred
        zi2 = 1.0 / jnp.maximum(Xc2[:, 2], 1e-6)
        return jnp.stack([fx * Xc2[:, 0] * zi2 + cx,
                          fy * Xc2[:, 1] * zi2 + cy], -1)

    d = 5.0
    c0 = ref_pix_to_cur(jnp.array([0.0, 0.0]))
    cu = ref_pix_to_cur(jnp.array([d, 0.0]))
    cv = ref_pix_to_cur(jnp.array([0.0, d]))
    A_cur_ref = jnp.stack([(cu - c0) / d, (cv - c0) / d], -1)  # [N,2,2]

    # ---- search level + warped ref patches --------------------------------
    det = jnp.abs(A_cur_ref[:, 0, 0] * A_cur_ref[:, 1, 1]
                  - A_cur_ref[:, 0, 1] * A_cur_ref[:, 1, 0])
    lvl = jnp.clip(jnp.ceil(0.5 * jnp.log2(jnp.maximum(det, 1e-6))),
                   0, n_levels - 1).astype(jnp.int32)

    A_ref_cur = _inv2x2(A_cur_ref)
    ox, oy = _grid_offsets(WARP_BORDER)                     # [10,10]
    o = jnp.stack([ox, oy], -1)                             # [10,10,2]
    # cur-level offsets -> level-0 -> ref-pixel offsets -> stored-patch coords
    scale_c = (2.0 ** lvl)                                  # [N]
    ref_scale = 2.0 ** pt_ref_level.astype(jnp.float32)
    off_ref = jnp.einsum("nab,ijb->nija", A_ref_cur, o)     # ref level-0 units
    off_patch = off_ref * (scale_c / ref_scale)[:, None, None, None]
    centre = (REF_PATCH - 1) / 2.0
    coords = off_patch + centre
    # Bilinear resampling of each point's OWN stored patch as two small
    # batched matmuls (hat-function weights) instead of 4 gathered
    # elements per output pixel: exact same interpolation, with no
    # gathers. Whether matmul or gather is the faster shape on a GPU is
    # unmeasured.
    N = pt_patch.shape[0]
    K = WARP_BORDER * WARP_BORDER
    rr = jnp.arange(REF_PATCH, dtype=jnp.float32)
    cxs = jnp.clip(coords[..., 0], 0.0, REF_PATCH - 1.001).reshape(N, K)
    cys = jnp.clip(coords[..., 1], 0.0, REF_PATCH - 1.001).reshape(N, K)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(cxs[..., None] - rr))  # [N,K,20]
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(cys[..., None] - rr))  # [N,K,20]
    tmp = jnp.einsum("nkr,nrc->nkc", wy, pt_patch)
    warped = jnp.einsum("nkc,nkc->nk", tmp, wx).reshape(
        N, WARP_BORDER, WARP_BORDER)
    # reject points whose warp leaves the stored patch
    inside = ((coords[..., 0] > 0.5) & (coords[..., 0] < REF_PATCH - 1.5)
              & (coords[..., 1] > 0.5) & (coords[..., 1] < REF_PATCH - 1.5))
    warp_ok = inside.all(axis=(1, 2))
    return visible, lvl, warped, warp_ok


def _make_align_all(cur_pyr, pt_xyz, pt_valid, warped, warp_ok, lvl, intr,
                    n_levels: int):
    """Closure aligning ALL points at their own search level against a pose
    (R_c, t_c): project, ONE stacked-pyramid batched KLT, merge.

    Each point's search level is a row offset into the stacked pyramid, so
    a single align2d_stacked sweep replaces the former per-level loop that
    ran the KLT over all N points at all L levels (L x the gather volume).
    Returns (uv, ok)."""
    from ..ops.align import align2d_stacked
    from ..ops.image import stack_pyramid, stack_rows

    fx, fy, cx, cy = intr
    N = pt_xyz.shape[0]
    h0, w0 = cur_pyr[0].shape
    stack = stack_pyramid(cur_pyr)
    offs, _ = stack_rows(h0, w0, n_levels)
    shapes = [lv.shape for lv in cur_pyr]
    row_off = jnp.asarray(offs, jnp.int32)[lvl]
    h_l = jnp.asarray([s[0] for s in shapes], jnp.int32)[lvl]
    w_l = jnp.asarray([s[1] for s in shapes], jnp.int32)[lvl]
    scale = (0.5 ** lvl.astype(jnp.float32))[:, None]

    def align_all(R_c, t_c):
        Xc2 = pt_xyz @ R_c.T + t_c
        zi2 = 1.0 / jnp.maximum(Xc2[:, 2], 1e-6)
        uvp = jnp.stack([fx * Xc2[:, 0] * zi2 + cx,
                         fy * Xc2[:, 1] * zi2 + cy], -1)
        vis = pt_valid & (Xc2[:, 2] > 0.1) & in_bounds(uvp, w0, h0, border=20)
        sel = vis & warp_ok
        uv_l = (uvp + 0.5) * scale - 0.5
        uv_ref, ok, _ = align2d_stacked(stack, warped, uv_l, sel,
                                        row_off, w_l, h_l, iters=10)
        uv0 = (uv_ref + 0.5) / scale - 0.5
        uv_out = jnp.where((sel & ok)[:, None], uv0, 0.0)
        return uv_out, sel & ok

    return align_all


@functools.partial(jax.jit, static_argnames=("n_levels",))
def track_local_map_direct(cur_pyr, R_pred, t_pred,
                           pt_xyz, pt_valid, pt_patch, pt_ref_uv,
                           pt_ref_level, pt_ref_R, pt_ref_t,
                           intr, n_levels: int = 4):
    """Track cached map points directly into the current frame.

    All pt_* arrays are [N,...] gathers of the map's cached points.
    Returns refined pose + per-point bookkeeping masks.
    """
    visible, lvl, warped, warp_ok = _warp_setup(
        cur_pyr, R_pred, t_pred, pt_xyz, pt_valid, pt_patch, pt_ref_uv,
        pt_ref_level, pt_ref_R, pt_ref_t, intr, n_levels)

    # ---- batched KLT + pose GN, two passes --------------------------------
    # Pass 2 re-projects with the pass-1 pose and re-aligns the points that
    # failed (their prediction was outside the KLT basin) — the reference
    # achieves the same recovery by re-searching the local map after pose
    # optimization (SearchLocalPoints + second PoseOptimization).
    inv_sigma2 = 0.25 ** lvl.astype(jnp.float32)
    align_all = _make_align_all(cur_pyr, pt_xyz, pt_valid, warped, warp_ok,
                                lvl, intr, n_levels)
    uv_out, ok_out = align_all(R_pred, t_pred)
    res = pose_optimization(pt_xyz, uv_out, inv_sigma2, ok_out,
                            R_pred, t_pred, intr)
    uv2, ok2 = align_all(res.R, res.t)
    # keep pass-1 positions where both passes converged (they agree to
    # sub-pixel); pass 2 contributes the recovered points
    uv_out = jnp.where(ok_out[:, None], uv_out, uv2)
    ok_out = ok_out | ok2
    res = pose_optimization(pt_xyz, uv_out, inv_sigma2, ok_out,
                            res.R, res.t, intr)
    tracked = res.inliers
    return DirectTrackResult(R=res.R, t=res.t, tracked=tracked,
                             aligned=ok_out, visible=visible, uv=uv_out,
                             level=lvl, n_inliers=res.n_inliers)


def refine_matches_core(cur_pyr, R_cur, t_cur,
                        pt_xyz, pt_valid, pt_patch, pt_ref_uv,
                        pt_ref_level, pt_ref_R, pt_ref_t,
                        intr, n_levels: int = 4):
    """Traceable body of refine_matches_direct — also composed into the
    fused multi-partner triangulation program (mapping.triangulate_multi)."""
    cur_pyr = as_levels(cur_pyr, n_levels)
    visible, lvl, warped, warp_ok = _warp_setup(
        cur_pyr, R_cur, t_cur, pt_xyz, pt_valid, pt_patch, pt_ref_uv,
        pt_ref_level, pt_ref_R, pt_ref_t, intr, n_levels)
    align_all = _make_align_all(cur_pyr, pt_xyz, pt_valid, warped, warp_ok,
                                lvl, intr, n_levels)
    uv, ok = align_all(R_cur, t_cur)
    return uv, ok & visible


@functools.partial(jax.jit, static_argnames=("n_levels",))
def refine_matches_direct(cur_pyr, R_cur, t_cur,
                          pt_xyz, pt_valid, pt_patch, pt_ref_uv,
                          pt_ref_level, pt_ref_R, pt_ref_t,
                          intr, n_levels: int = 4):
    """Single-pass subpixel re-match against a KNOWN pose: warp stored ref
    patches + one batched KLT sweep, NO pose optimization. This is the
    dedicated small program the mapping tail's triangulation refinement
    needs (VERDICT r3 #3) — the full track_local_map_direct runs two align
    passes + two staged pose-GN solves it would throw away. `cur_pyr` may
    be a level tuple or a stacked [SH,W] buffer.

    Returns (uv [N,2] refined level-0 pixels in cur, ok [N] bool)."""
    return refine_matches_core(cur_pyr, R_cur, t_cur, pt_xyz, pt_valid,
                               pt_patch, pt_ref_uv, pt_ref_level, pt_ref_R,
                               pt_ref_t, intr, n_levels)


def capture_ref_patches_core(pyr, uv0, level, n_levels: int = 4):
    """Traceable body of capture_ref_patches (pyr: tuple or stacked).

    Samples every feature's patch at its own octave in ONE stacked-pyramid
    gather (per-point level row offsets) instead of sampling all M points
    at all L levels and masking — L x less gather volume."""
    from ..ops.align import sample_patches
    from ..ops.image import stack_pyramid, stack_rows

    pyr = as_levels(pyr, n_levels)
    h0, w0 = pyr[0].shape
    stack = stack_pyramid(pyr)
    offs, _ = stack_rows(h0, w0, n_levels)
    row_off = jnp.asarray(offs, jnp.float32)[level]
    s = 0.5 ** level.astype(jnp.float32)
    uv_l = (uv0 + 0.5) * s[:, None] - 0.5
    uv_stack = uv_l + jnp.stack([jnp.zeros_like(row_off), row_off], -1)
    return sample_patches(stack, uv_stack, REF_PATCH)


@functools.partial(jax.jit, static_argnames=("n_levels",))
def capture_ref_patches(pyr, uv0, level, n_levels: int = 4):
    """Sample REF_PATCH x REF_PATCH patches around features at their octave.

    uv0 [M,2] level-0 coords; level [M]. `pyr` may be a level tuple or a
    stacked [SH,W] buffer. Returns [M,REF_PATCH,REF_PATCH].
    """
    return capture_ref_patches_core(pyr, uv0, level, n_levels)
