"""Sparse inverse-compositional image alignment (SVO-style direct tracking).

Batched re-design of the reference SparseImgAlign
(/root/reference/src/SparseImageAlign.cc: per-level Gauss-Newton on SE3 over
4x4 patches around the previous frame's map points, Jacobians precomputed once
per level in the reference frame :57-128, bilinear residuals :130-231, 6x6
solve :233-238, update T <- T*exp(-x) :240-244; 10 iters/level, levels
coarse->fine, patch_halfsize=2 include/SparseImageAlign.h:20-22).

Here the whole point set is one tensor: patch sampling is a batched gather,
the Hessian is one einsum, and the iteration is a lax.fori_loop — the full
multi-level alignment compiles to a single XLA computation with no host sync.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from ..backend.optim import solve_preconditioned
from ..geometry.lie import se3_exp, se3_mul
from ..ops.align import sample_patches
from ..ops.image import in_bounds

PATCH_HALF = 2      # 4x4 patches like the reference
PATCH = 2 * PATCH_HALF


class SparseAlignResult(NamedTuple):
    R: jnp.ndarray        # [3,3] cur <- ref
    t: jnp.ndarray        # [3]
    n_meas: jnp.ndarray   # scalar int: points contributing at finest level
    mean_res: jnp.ndarray # mean |residual| at convergence (intensity units)


def _level_uv(uv, scale):
    """Level-0 pixel coords -> level-l coords (pixel-centre aligned)."""
    return (uv + 0.5) * scale - 0.5


@functools.partial(jax.jit, static_argnames=("levels", "iters"))
def sparse_image_align(ref_pyr, cur_pyr, uv0, X_ref, valid, intr,
                       R_init, t_init, levels: Sequence[int] = (3, 2, 1),
                       iters: int = 10):
    """Estimate T_cur_ref by direct alignment.

    Args:
      ref_pyr, cur_pyr: tuples of [H_l, W_l] float32 pyramid levels.
      uv0: [N,2] feature pixels in the ref frame (level-0, undistorted).
      X_ref: [N,3] corresponding 3-D points in the REF camera frame.
      valid: [N] bool.
      intr: (fx, fy, cx, cy) at level 0.
      R_init, t_init: initial guess for T_cur_ref.
      levels: pyramid levels coarse->fine (reference uses nlevels-1 .. 1,
        never level 0, src/Tracking.cc:284).
    """
    fx, fy, cx, cy = intr
    R, t = R_init, t_init
    n_meas = jnp.array(0, jnp.int32)
    mean_res = jnp.array(0.0, jnp.float32)

    for lvl in levels:
        scale = 0.5 ** lvl
        ref_img = ref_pyr[lvl]
        cur_img = cur_pyr[lvl]
        h, w = cur_img.shape
        fxl, fyl = fx * scale, fy * scale
        cxl = (cx + 0.5) * scale - 0.5
        cyl = (cy + 0.5) * scale - 0.5
        uv_l = _level_uv(uv0, scale)

        # --- precompute reference patches + fixed IC Jacobians ------------
        ref_border = sample_patches(ref_img, uv_l, PATCH + 2)  # [N,6,6]
        ref_patch = ref_border[:, 1:-1, 1:-1]
        gx = 0.5 * (ref_border[:, 1:-1, 2:] - ref_border[:, 1:-1, :-2])
        gy = 0.5 * (ref_border[:, 2:, 1:-1] - ref_border[:, :-2, 1:-1])

        x, y, z = X_ref[:, 0], X_ref[:, 1], X_ref[:, 2]
        zi = 1.0 / jnp.maximum(z, 1e-6)
        zi2 = zi * zi
        # d(pi_l)/dX [N,2,3]
        dpi = jnp.stack([
            jnp.stack([fxl * zi, jnp.zeros_like(zi), -fxl * x * zi2], -1),
            jnp.stack([jnp.zeros_like(zi), fyl * zi, -fyl * y * zi2], -1),
        ], axis=1)
        # dX/dxi for xi=[trans, rot]: [I | -X^] -> [N,3,6]
        zero = jnp.zeros_like(x)
        Xhat = jnp.stack([
            jnp.stack([zero, -z, y], -1),
            jnp.stack([z, zero, -x], -1),
            jnp.stack([-y, x, zero], -1),
        ], axis=1)
        dX = jnp.concatenate([jnp.broadcast_to(jnp.eye(3, dtype=uv0.dtype),
                                               Xhat.shape), -Xhat], axis=2)
        Jp = jnp.einsum("nab,nbc->nac", dpi, dX)  # [N,2,6]

        npts = uv0.shape[0]
        J = (gx.reshape(npts, -1)[..., None] * Jp[:, None, 0, :]
             + gy.reshape(npts, -1)[..., None] * Jp[:, None, 1, :])  # [N,16,6]

        ref_ok = valid & (z > 0.1) & in_bounds(
            jnp.stack([uv_l[:, 0], uv_l[:, 1]], -1), w, h,
            border=PATCH_HALF + 1)
        ref_flat = ref_patch.reshape(npts, -1)

        # --- Gauss-Newton iterations --------------------------------------
        def project(Rc, tc):
            Xc = X_ref @ Rc.T + tc
            ziC = 1.0 / jnp.maximum(Xc[:, 2], 1e-6)
            u = fxl * Xc[:, 0] * ziC + cxl
            v = fyl * Xc[:, 1] * ziC + cyl
            return jnp.stack([u, v], -1), Xc[:, 2] > 0.1

        def body(_, state):
            Rc, tc = state
            uv_c, front = project(Rc, tc)
            vis = ref_ok & front & in_bounds(uv_c, w, h, border=PATCH_HALF + 1)
            cur = sample_patches(cur_img, uv_c, PATCH).reshape(npts, -1)
            r = cur - ref_flat                                 # [N,16]
            wmask = vis.astype(jnp.float32)[:, None]
            # Huber weight on per-pixel residuals (k = 10 intensity levels)
            k = 10.0
            wh = jnp.minimum(1.0, k / jnp.maximum(jnp.abs(r), 1e-6))
            wr = wmask * wh
            H = jnp.einsum("nki,nk,nkj->ij", J, wr, J)
            b = jnp.einsum("nki,nk->i", J, wr * r)
            H = H + 1e-6 * jnp.trace(H) / 6.0 * jnp.eye(6, dtype=H.dtype)
            delta = solve_preconditioned(H, b)
            # T <- T * exp(-delta) (inverse compositional, reference :240-244)
            Rd, td = se3_exp(-delta)
            Rn, tn = se3_mul(Rc, tc, Rd, td)
            return Rn, tn

        R, t = jax.lax.fori_loop(0, iters, body, (R, t))

        # diagnostics at the finest processed level
        uv_c, front = project(R, t)
        vis = ref_ok & front & in_bounds(uv_c, w, h, border=PATCH_HALF + 1)
        cur = sample_patches(cur_img, uv_c, PATCH).reshape(npts, -1)
        res = jnp.abs(cur - ref_flat).mean(axis=1)
        n_meas = jnp.sum(vis)
        mean_res = jnp.sum(jnp.where(vis, res, 0.0)) / jnp.maximum(n_meas, 1)

    return SparseAlignResult(R=R, t=t, n_meas=n_meas, mean_res=mean_res)
