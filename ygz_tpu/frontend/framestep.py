"""Fused per-frame tracking step: ONE device dispatch per frame, FEW buffers.

The reference's per-frame hot path (Tracking::Track /root/reference/src/
Tracking.cc:399-738 — pyramid build, sparse image alignment, direct local-map
tracking, velocity update) runs here as a single jitted computation over
device-resident carry state. The host uploads one image, dispatches one
program, and reads back one small result struct.

Buffer packing (round 4): every argument/result BUFFER of a dispatch is a
separate host<->device transfer, so the layout keeps them few. The
round-3 layout moved ~35 buffers per microbatch; this one moves 6:

  in:  imgs [B,H,W] u8 | carry.pyr [SH,W] | carry.state [24] |
       carry.pts [cap,6] | cache [cap,419] | pred [13]
  out: carry' (3 buffers) | outs [B, N_SCALARS+5*cap] | pyrs [B,SH,W]

The pyramid is stored STACKED: level l occupies rows row_off[l] :
row_off[l]+H_l, columns 0:W_l (width padded with zeros to W). Static
slicing unstacks it for free inside a trace.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..backend.mapstate import REF_PATCH
from ..ops.image import (build_pyramid, remap, pyramid_shapes,  # noqa: F401
                         stack_rows, stack_pyramid, unstack_pyramid)
from .sparse_align import sparse_image_align
from .direct_tracker import track_local_map_direct

# packed direct-tracking cache row: xyz 3 | valid 1 | patch P*P | ref_uv 2 |
# ref_level 1 | ref_R 9 | ref_t 3
CACHE_COLS = 3 + 1 + REF_PATCH * REF_PATCH + 2 + 1 + 9 + 3


class FrameCarry(NamedTuple):
    pyr: jnp.ndarray      # [SH, W] stacked prev-frame pyramid (f32)
    state: jnp.ndarray    # [24] f32: R 9 | t 3 | Rv 9 | tv 3
    pts: jnp.ndarray      # [cap, 6] f32: uv 2 | Xc 3 | valid 1


class FrameOut(NamedTuple):
    R: jnp.ndarray        # [3,3] tracked pose (direct local-map result)
    t: jnp.ndarray
    R_pred: jnp.ndarray   # prediction fed to the direct tracker (for
    t_pred: jnp.ndarray   # host-side fallbacks when tracking fails)
    align_ok: jnp.ndarray  # bool: sparse alignment accepted
    align_n: jnp.ndarray   # int: points measured at finest align level
    align_res: jnp.ndarray
    n_align_in: jnp.ndarray
    n_inliers: jnp.ndarray
    tracked: jnp.ndarray  # [cap] bool (aligned + pose-opt inlier)
    visible: jnp.ndarray  # [cap] bool (in predicted frustum)
    uv: jnp.ndarray       # [cap,2] refined level-0 pixels
    level: jnp.ndarray    # [cap] search level


# pyramid stack/unstack helpers live in ops.image (pyramid_shapes,
# stack_rows, stack_pyramid, unstack_pyramid — re-exported above for
# compatibility)


# --------------------------------------------------------------- cache pack
def pack_cache_np(xyz, valid, patch, ref_uv, ref_level, ref_R, ref_t):
    """Host-side packing of the direct-tracking cache into ONE [cap,
    CACHE_COLS] f32 upload buffer."""
    cap = xyz.shape[0]
    out = np.empty((cap, CACHE_COLS), np.float32)
    o = 0
    for a, w in ((xyz, 3), (valid.reshape(cap, 1), 1),
                 (patch.reshape(cap, -1), REF_PATCH * REF_PATCH),
                 (ref_uv, 2), (ref_level.reshape(cap, 1), 1),
                 (ref_R.reshape(cap, 9), 9), (ref_t, 3)):
        out[:, o: o + w] = np.asarray(a, np.float32).reshape(cap, w)
        o += w
    return out


def unpack_cache(cache):
    """Packed [cap, CACHE_COLS] -> the 7 arrays track_local_map_direct
    takes (traceable; static slices)."""
    cap = cache.shape[0]
    o = 0

    def take(w):
        nonlocal o
        v = cache[:, o: o + w]
        o += w
        return v

    xyz = take(3)
    valid = take(1)[:, 0] > 0.5
    patch = take(REF_PATCH * REF_PATCH).reshape(cap, REF_PATCH, REF_PATCH)
    ref_uv = take(2)
    ref_level = take(1)[:, 0].astype(jnp.int32)
    ref_R = take(9).reshape(cap, 3, 3)
    ref_t = take(3)
    return xyz, valid, patch, ref_uv, ref_level, ref_R, ref_t


def pack_pred_np(R_pred=None, t_pred=None, use: bool = False):
    """[13] f32 prediction vector: R 9 | t 3 | use 1."""
    v = np.zeros(13, np.float32)
    if R_pred is not None:
        v[:9] = np.asarray(R_pred, np.float32).ravel()
        v[9:12] = np.asarray(t_pred, np.float32)
    else:
        v[:9] = np.eye(3, dtype=np.float32).ravel()
    v[12] = 1.0 if use else 0.0
    return v


def _state_pack(R, t, Rv, tv):
    return jnp.concatenate([jnp.reshape(R, (9,)), jnp.reshape(t, (3,)),
                            jnp.reshape(Rv, (9,)), jnp.reshape(tv, (3,))])


def _state_unpack(s):
    return (s[:9].reshape(3, 3), s[9:12], s[12:21].reshape(3, 3), s[21:24])


# ------------------------------------------------------------------ core step
def _frame_core(img, carry: FrameCarry, cache, pred, remap_grid, intr,
                n_levels: int, scale_factor: float, min_align: int,
                align_iters: int):
    """Traceable body shared by frame_step (one frame per dispatch) and
    frame_step_batch (lax.scan over a frame microbatch)."""
    img = img.astype(jnp.float32)
    if remap_grid is not None:
        img = remap(img, remap_grid[0], remap_grid[1])
    pyr = build_pyramid(img, n_levels, scale_factor)
    prev_pyr = unstack_pyramid(carry.pyr, n_levels, scale_factor,
                               height=img.shape[0])
    R_prev, t_prev, Rv, tv = _state_unpack(carry.state)
    uv_prev = carry.pts[:, 0:2]
    Xc_prev = carry.pts[:, 2:5]
    valid_prev = carry.pts[:, 5] > 0.5
    pred_R = pred[:9].reshape(3, 3)
    pred_t = pred[9:12]
    use_pred = pred[12] > 0.5
    cache_arrays = unpack_cache(cache)

    # ---- pose prediction -------------------------------------------------
    # velocity model (reference Tracking::TrackWithMotionModel seed) or the
    # subclass's external prediction (PredictNavStateByIMU)
    R_mm = Rv @ R_prev
    t_mm = Rv @ t_prev + tv
    R_mm = jnp.where(use_pred, pred_R, R_mm)
    t_mm = jnp.where(use_pred, pred_t, t_mm)

    # ---- sparse image alignment from the last frame ----------------------
    # seeded from identity relative pose (see tracker.py rationale: seeding
    # with the velocity couples extrapolated error into the measurement loop)
    n_align_in = valid_prev.sum()
    ares = sparse_image_align(
        prev_pyr, pyr, uv_prev, Xc_prev, valid_prev, intr,
        jnp.eye(3), jnp.zeros(3),
        levels=tuple(range(n_levels - 1, 0, -1)), iters=align_iters)
    align_ok = (n_align_in >= min_align) & (ares.n_meas >= min_align)
    R_al = ares.R @ R_prev
    t_al = ares.R @ t_prev + ares.t
    R_pred = jnp.where(align_ok, R_al, R_mm)
    t_pred = jnp.where(align_ok, t_al, t_mm)

    # ---- direct local-map tracking ---------------------------------------
    dres = track_local_map_direct(pyr, R_pred, t_pred, *cache_arrays, intr,
                                  n_levels=n_levels)
    R_new, t_new = dres.R, dres.t

    # ---- velocity update + next-frame alignment points -------------------
    Rv_new = R_new @ R_prev.T
    tv_new = t_new - Rv_new @ t_prev
    cache_xyz = cache_arrays[0]
    Xc = cache_xyz @ R_new.T + t_new
    valid_next = dres.tracked & (Xc[:, 2] > 0.1)

    pyr_stack = stack_pyramid(pyr)
    new_carry = FrameCarry(
        pyr=pyr_stack,
        state=_state_pack(R_new, t_new, Rv_new, tv_new),
        pts=jnp.concatenate(
            [dres.uv, Xc, valid_next[:, None].astype(jnp.float32)], axis=1))
    out = FrameOut(R=R_new, t=t_new, R_pred=R_pred, t_pred=t_pred,
                   align_ok=align_ok, align_n=ares.n_meas,
                   align_res=ares.mean_res, n_align_in=n_align_in,
                   n_inliers=dres.n_inliers, tracked=dres.tracked,
                   visible=dres.visible, uv=dres.uv, level=dres.level)
    return new_carry, out, pyr_stack


N_SCALARS = 29  # R 9 + t 3 + R_pred 9 + t_pred 3 + 5 scalar diagnostics


def _pack_out(out: FrameOut):
    """Flatten a FrameOut into ONE float32 vector so the host readback is a
    single buffer (= a single device->host transfer) instead of 13."""
    f32 = jnp.float32
    scalars = jnp.concatenate([
        out.R.reshape(-1), out.t, out.R_pred.reshape(-1), out.t_pred,
        jnp.stack([out.align_ok.astype(f32), out.align_n.astype(f32),
                   out.align_res.astype(f32), out.n_align_in.astype(f32),
                   out.n_inliers.astype(f32)])])
    return jnp.concatenate([
        scalars, out.tracked.astype(f32), out.visible.astype(f32),
        out.uv.reshape(-1), out.level.astype(f32)])


def unpack_out(vec, cap: int) -> FrameOut:
    """Host-side inverse of _pack_out (vec is a [N_SCALARS+5*cap] numpy
    array)."""
    s = vec[:N_SCALARS]
    R = s[0:9].reshape(3, 3)
    t = s[9:12]
    R_pred = s[12:21].reshape(3, 3)
    t_pred = s[21:24]
    o = N_SCALARS
    tracked = vec[o: o + cap] > 0.5
    o += cap
    visible = vec[o: o + cap] > 0.5
    o += cap
    uv = vec[o: o + 2 * cap].reshape(cap, 2)
    o += 2 * cap
    level = vec[o: o + cap].astype(np.int32)
    return FrameOut(R=R, t=t, R_pred=R_pred, t_pred=t_pred,
                    align_ok=s[24] > 0.5, align_n=s[25], align_res=s[26],
                    n_align_in=s[27], n_inliers=s[28],
                    tracked=tracked, visible=visible, uv=uv, level=level)


@functools.partial(
    jax.jit,
    static_argnames=("intr", "n_levels", "scale_factor", "min_align",
                     "align_iters"))
def frame_step(img, carry: FrameCarry, cache, pred, remap_grid, intr,
               n_levels: int = 4, scale_factor: float = 2.0,
               min_align: int = 30, align_iters: int = 10):
    """One tracked frame, fully on device.

    Args:
      img: [H,W] new frame (uint8 or float32; cast internally).
      carry: FrameCarry from the previous frame (3 packed buffers).
      cache: [cap, CACHE_COLS] packed direct-tracking cache snapshot
        (pack_cache_np).
      pred: [13] f32 external pose prediction (pack_pred_np) — IMU
        propagation in the mono-VI tracker; use flag 0 selects the
        on-device velocity model.
      remap_grid: [2,H,W] stacked undistortion remap or None.
      intr: (fx, fy, cx, cy) — static.
    Returns (new_carry, packed_out [N_SCALARS+5*cap] f32 — one readback
    buffer; decode with unpack_out).
    """
    new_carry, out, _ = _frame_core(img, carry, cache, pred, remap_grid,
                                    intr, n_levels, scale_factor,
                                    min_align, align_iters)
    return new_carry, _pack_out(out)


@functools.partial(
    jax.jit,
    static_argnames=("intr", "n_levels", "scale_factor", "min_align",
                     "align_iters"))
def frame_step_batch(imgs, carry: FrameCarry, cache, remap_grid, intr,
                     n_levels: int = 4, scale_factor: float = 2.0,
                     min_align: int = 30, align_iters: int = 10):
    """Track a MICROBATCH of B consecutive frames in one dispatch.

    Amortizes the host<->device dispatch cost: a lax.scan chains B frame
    steps device-side, so a whole batch costs one image upload ([B,H,W]),
    one execute, and one readback ([B, N_SCALARS+5*cap] packed) — and every
    argument/result is a single packed buffer (6 in / 5 out). The
    device carry chains exactly as in the per-frame path; keyframe/mapping
    effects are applied by the host after the batch readback, i.e. they lag
    up to B-1 frames — the same lag the reference's asynchronous
    LocalMapping thread exhibits (/root/reference/src/System.cc:221-222).

    Returns (new_carry, packed_outs [B, N_SCALARS+5*cap], pyrs [B, SH, W]
    stacked pyramids, device-resident; the host slices single frames out
    only at keyframes)."""
    no_pred = jnp.concatenate([jnp.eye(3).reshape(9), jnp.zeros(4)])

    def body(c, img):
        c2, out, pyr_stack = _frame_core(
            img, c, cache, no_pred, remap_grid, intr, n_levels,
            scale_factor, min_align, align_iters)
        return c2, (_pack_out(out), pyr_stack)

    new_carry, (outs, pyrs) = jax.lax.scan(body, carry, imgs)
    return new_carry, outs, pyrs


@functools.partial(jax.jit, static_argnames=("n_levels", "scale_factor"))
def _stack_jit(pyr, n_levels: int, scale_factor: float):
    return stack_pyramid(pyr)


@functools.partial(jax.jit, static_argnames=("n_levels", "scale_factor"))
def build_pyramid_dispatch(img, remap_grid, n_levels: int,
                           scale_factor: float = 2.0):
    """Pyramid build (+ optional [2,H,W] undistort remap) as ONE dispatch
    returning the level tuple — the host's init/reloc/keyframe paths."""
    img = img.astype(jnp.float32)
    if remap_grid is not None:
        img = remap(img, remap_grid[0], remap_grid[1])
    return build_pyramid(img, n_levels, scale_factor)


@functools.partial(jax.jit, static_argnames=("n_levels", "scale_factor"))
def build_pyramid_stacked(img, remap_grid, n_levels: int,
                          scale_factor: float = 2.0):
    """Pyramid build (+ optional undistort) as ONE dispatch returning the
    SINGLE-BUFFER stacked form — one device buffer instead of n_levels, so
    downstream stacked-aware consumers (extractor, patch capture, carry
    rebuild) never pay per-level transfers or eager slices."""
    img = img.astype(jnp.float32)
    if remap_grid is not None:
        img = remap(img, remap_grid[0], remap_grid[1])
    return stack_pyramid(build_pyramid(img, n_levels, scale_factor))


def make_carry(pyr, R, t, uv, Xc, valid, Rv=None, tv=None) -> FrameCarry:
    """Host-side carry construction (after init, relocalization, or a
    fallback recovery — the rare paths where the host rewrites tracking
    state). `pyr` is either a tuple of levels (stacked here, one dispatch)
    or an already-stacked [SH, W] array."""
    if Rv is None:
        Rv = np.eye(3, dtype=np.float32)
    if tv is None:
        tv = np.zeros(3, np.float32)
    if isinstance(pyr, (tuple, list)):
        n_levels = len(pyr)
        pyr = _stack_jit(tuple(jnp.asarray(p) for p in pyr), n_levels, 2.0)
    state = np.concatenate([
        np.asarray(R, np.float32).ravel(), np.asarray(t, np.float32),
        np.asarray(Rv, np.float32).ravel(), np.asarray(tv, np.float32)])
    pts = np.concatenate(
        [np.asarray(uv, np.float32), np.asarray(Xc, np.float32),
         np.asarray(valid, np.float32).reshape(-1, 1)], axis=1)
    return FrameCarry(pyr=jnp.asarray(pyr), state=jnp.asarray(state),
                      pts=jnp.asarray(pts))
