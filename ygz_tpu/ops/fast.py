"""FAST-10 corner detection + corner scores + NMS + Shi-Tomasi, full-image.

Batched replacement for the vendored libfast SSE2/NEON kernels
(/root/reference/Thirdparty/fast/include/fast/fast.h:20-31:
fast_corner_detect_10[_sse2], fast_corner_score_10, fast_nonmax_3x3) and the
Shi-Tomasi score in src/ORBextractor.cc:1152-1187. Instead of per-pixel
branchy scans, the 16 Bresenham-circle taps become 16 shifted copies of the
image and the arc-contiguity test becomes a reduction — one fused elementwise
pipeline over the whole image that XLA fuses.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 — (dx, dy), clockwise from (0,-3) like the
# classic FAST ordering (order only matters for contiguity, which is circular).
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 10  # FAST-10


def _shift(img, dx, dy):
    """img shifted so out[y,x] = img[y+dy, x+dx] (border garbage is masked by
    the 3-px frame below)."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))


@functools.partial(jax.jit, static_argnames=("threshold",))
def fast_score_map(img, threshold: float = 20.0):
    """FAST-10 corner response over the full image.

    Returns score [H,W] float32: 0 where not a corner; otherwise the arc
    strength max(min over best bright arc of (I_tap - I - t),
                 min over best dark arc of (I - I_tap - t)) + t,
    i.e. comparable to the classic "max threshold for which this is still a
    corner" score. A 3-px border is zeroed.
    """
    H, W = img.shape
    taps = jnp.stack([_shift(img, dx, dy) for dx, dy in CIRCLE])  # [16,H,W]
    diff = taps - img[None, :, :]

    bright = diff - threshold          # >0 where tap significantly brighter
    dark = (-diff) - threshold         # >0 where tap significantly darker

    def arc_strength(x):
        # For each of 16 circular start positions, the min over the ARC-length
        # run; corner strength = max over starts. Computed with a wrapped
        # stack: ext[j] = x[(j) mod 16], j in [0, 16+ARC).
        ext = jnp.concatenate([x, x[: ARC - 1]], axis=0)  # [16+ARC-1,H,W]
        # windowed min via ARC shifted minima
        m = ext[:16]
        for j in range(1, ARC):
            m = jnp.minimum(m, ext[j: j + 16])
        return jnp.max(m, axis=0)  # [H,W]

    sb = arc_strength(bright)
    sd = arc_strength(dark)
    strength = jnp.maximum(sb, sd)
    score = jnp.where(strength > 0.0, strength + threshold, 0.0)

    # zero the 3-px frame (wrapped shifts are invalid there)
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    frame = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return jnp.where(frame, score, 0.0)


def fast_score_map_ref(img, threshold: float = 20.0):
    """Plain numpy FAST-10 score, written independently of fast_score_map:
    the score is the largest contrast v over any 10-tap arc — v = min(arc)
    - I for a bright arc, I - max(arc) for a dark one — kept where v > t.
    Equal to fast_score_map bit for bit on integer-valued images and
    thresholds (only min/max and exact subtractions)."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    c = img[3: H - 3, 3: W - 3]
    ring = np.stack([img[3 + dy: H - 3 + dy, 3 + dx: W - 3 + dx]
                     for dx, dy in CIRCLE])
    ring = np.concatenate([ring, ring[: ARC - 1]])
    lo = np.stack([ring[s: s + ARC].min(0) for s in range(16)]).max(0)
    hi = np.stack([ring[s: s + ARC].max(0) for s in range(16)]).min(0)
    v = np.maximum(lo - c, c - hi)
    out = np.zeros_like(img)
    out[3: H - 3, 3: W - 3] = np.where(v > threshold, v, 0.0)
    return out


def nonmax_3x3(score):
    """Keep only 3x3-neighbourhood maxima (ties broken towards keeping)."""
    neigh = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neigh = jnp.maximum(neigh, _shift(score, dx, dy))
    return jnp.where(score >= neigh, score, 0.0)


@functools.partial(jax.jit, static_argnames=("half_box",))
def shi_tomasi_map(img, half_box: int = 4):
    """Shi-Tomasi (min eigenvalue of the structure tensor) over a
    (2*half_box)^2 box, full image — the reference computes this per-keypoint
    (src/ORBextractor.cc:1152-1187); computing the full map is one fused
    elementwise pass and lets grid selection rank directly."""
    dx = 0.5 * (_shift(img, 1, 0) - _shift(img, -1, 0))
    dy = 0.5 * (_shift(img, 0, 1) - _shift(img, 0, -1))
    dxx = dx * dx
    dyy = dy * dy
    dxy = dx * dy

    def box(x):
        # separable box filter of width 2*half_box using cumulative sums
        k = 2 * half_box
        c = jnp.cumsum(x, axis=0)
        c = jnp.pad(c, ((1, 0), (0, 0)))
        rows = c[k:, :] - c[:-k, :]
        rows = jnp.pad(rows, ((half_box, k - half_box), (0, 0)), mode="edge")
        c2 = jnp.cumsum(rows, axis=1)
        c2 = jnp.pad(c2, ((0, 0), (1, 0)))
        out = c2[:, k:] - c2[:, :-k]
        return jnp.pad(out, ((0, 0), (half_box, k - half_box)), mode="edge")

    sxx = box(dxx)
    syy = box(dyy)
    sxy = box(dxy)
    n = float((2 * half_box) ** 2)
    tr = (sxx + syy) / (2 * n)
    det = jnp.sqrt(jnp.maximum(((sxx - syy) / (2 * n)) ** 2 + (sxy / n) ** 2, 0.0))
    return tr - det  # min eigenvalue
