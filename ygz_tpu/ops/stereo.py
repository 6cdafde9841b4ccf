"""Batched stereo matching for rectified pairs.

Replaces Frame::ComputeStereoMatches (/root/reference/src/Frame.cc:509-682:
per-feature row-table candidate search + descriptor gate + 11x11 SAD with
subpixel parabola). Batched formulation: every feature's left patch is correlated
against its full disparity strip from the right image in one tensor op —
[N, D] SAD surfaces -> argmin + parabola refinement, no per-feature loops.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .image import sample_bilinear

PATCH = 11          # SAD window (reference: 11x11)
HALF = PATCH // 2


@functools.partial(jax.jit, static_argnames=("max_disp",))
def stereo_match_features(imgL, imgR, uv, valid, max_disp: int = 96,
                          min_disp: float = 0.5, uniq_ratio: float = 0.9):
    """Per-feature subpixel disparity by dense SAD over the epipolar row.

    Args:
      imgL/imgR: rectified [H,W] images.
      uv: [N,2] LEFT-image feature positions (level-0).
      valid: [N] bool.
    Returns (disp [N] float32, ok [N] bool): disparity uL - uR >= 0.
    """
    H, W = imgL.shape
    N = uv.shape[0]

    oy, ox = jnp.meshgrid(jnp.arange(-HALF, HALF + 1, dtype=jnp.float32),
                          jnp.arange(-HALF, HALF + 1, dtype=jnp.float32),
                          indexing="ij")

    # left patches [N, P, P]
    ptsL = jnp.stack([uv[:, None, None, 0] + ox[None],
                      uv[:, None, None, 1] + oy[None]], -1)
    patchL = sample_bilinear(imgL, ptsL)

    # right candidate windows for each disparity d in [0, max_disp): [N, D, P, P]
    d_range = jnp.arange(max_disp, dtype=jnp.float32)
    ur = uv[:, None, 0] - d_range[None, :]                     # [N,D]
    xR = ur[:, :, None, None] + ox[None, None]                  # [N,D,P,P]
    yR = jnp.broadcast_to(uv[:, 1][:, None, None, None]
                          + oy[None, None], xR.shape)
    ptsR = jnp.stack([xR, yR], -1)
    patchR = sample_bilinear(imgR, ptsR)                        # [N,D,P,P]

    # zero-mean SAD: subtracting per-patch means makes the cost invariant
    # to gain/offset differences between the two cameras (the reference's
    # raw SAD relies on its descriptor pre-gate for this; our full-strip
    # search needs the photometric invariance in the cost itself —
    # round-2 stereo degraded 4x under photometric nuisance, ATE_r02.md)
    muL = patchL.mean(axis=(1, 2), keepdims=True)
    muR = patchR.mean(axis=(2, 3), keepdims=True)
    sad = jnp.abs((patchR - muR) - (patchL - muL)[:, None]).sum(axis=(2, 3))
    # penalize out-of-image candidates
    inb = (ur - HALF >= 0)
    sad = jnp.where(inb, sad, 1e9)

    best = jnp.argmin(sad, axis=1)
    bmin = jnp.min(sad, axis=1)
    # uniqueness: best must beat the best-outside-a-±2 window by ratio
    D = max_disp
    idx = jnp.arange(D)[None, :]
    masked = jnp.where(jnp.abs(idx - best[:, None]) <= 2, 1e9, sad)
    second = jnp.min(masked, axis=1)
    uniq = bmin < uniq_ratio * second

    # subpixel parabola on (best-1, best, best+1)
    bm1 = jnp.clip(best - 1, 0, D - 1)
    bp1 = jnp.clip(best + 1, 0, D - 1)
    n_idx = jnp.arange(N)
    s0 = sad[n_idx, bm1]
    s1 = sad[n_idx, best]
    s2 = sad[n_idx, bp1]
    denom = s0 + s2 - 2.0 * s1
    delta = jnp.where(jnp.abs(denom) > 1e-6,
                      0.5 * (s0 - s2) / jnp.maximum(denom, 1e-6), 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    disp = best.astype(jnp.float32) + delta

    ok = (valid & uniq & (disp >= min_disp) & (disp < max_disp - 1)
          & (bmin < 1e8)
          & (uv[:, 1] > HALF) & (uv[:, 1] < H - HALF - 1)
          & (uv[:, 0] > HALF) & (uv[:, 0] < W - HALF - 1))

    # median-distance outlier cut (reference Frame::ComputeStereoMatches
    # epilogue, src/Frame.cc:650-680: sort best SADs, reject those above
    # 1.5*1.4*median) — kills occluded/repetitive-texture false matches
    # whose SAD is an outlier relative to the frame's match population
    big = jnp.float32(1e9)
    costs = jnp.where(ok, bmin, big)
    k = jnp.maximum(ok.sum(), 1)
    med = jnp.sort(costs)[(k - 1) // 2]
    ok = ok & (bmin <= 1.5 * 1.4 * med)
    return disp, ok
