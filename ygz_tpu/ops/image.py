"""Core image ops: bilinear sampling, remap, blur, gradients, pyramid.

Batched replacement for the reference's per-frame OpenCV image path
(Frame::ComputeImagePyramid /root/reference/src/Frame.cc:773-814 — pyramid +
undistort remap; ORBextractor::ComputePyramid src/ORBextractor.cc:1129).
Everything is a pure jnp function over [H,W] float32 images so the whole
per-frame front-end fuses into a few XLA computations.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def sample_bilinear(img, uv):
    """Bilinearly sample img [H,W] at uv [...,2] (x,y pixel coords).

    Coordinates are clamped to the valid interpolation domain; callers that
    need out-of-bounds detection should mask separately with `in_bounds`.
    Returns [...] samples.
    """
    H, W = img.shape
    x = jnp.clip(uv[..., 0], 0.0, W - 1.001)
    y = jnp.clip(uv[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11))


def in_bounds(uv, w, h, border=0.0):
    return ((uv[..., 0] >= border) & (uv[..., 0] < w - 1 - border)
            & (uv[..., 1] >= border) & (uv[..., 1] < h - 1 - border))


def remap(img, map_u, map_v):
    """cv::remap equivalent: out[y,x] = bilinear(img, map_u[y,x], map_v[y,x])."""
    return sample_bilinear(img, jnp.stack([map_u, map_v], axis=-1))


@functools.partial(jax.jit, static_argnums=(1,))
def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur (reference blurs 7x7 sigma=2 before BRIEF,
    src/ORBextractor.cc:1010)."""
    r = ksize // 2
    x = jnp.arange(-r, r + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / jnp.sum(k)
    # reflect-pad then two 1-D convs via conv_general_dilated
    img4 = img[None, None, :, :]
    kh = k[None, None, None, :]
    kv = k[None, None, :, None]
    pad = [(0, 0), (r, r)]
    out = jax.lax.conv_general_dilated(
        jnp.pad(img4, [(0, 0), (0, 0), (0, 0), (r, r)], mode="edge"),
        kh, (1, 1), [(0, 0), (0, 0)])
    out = jax.lax.conv_general_dilated(
        jnp.pad(out, [(0, 0), (0, 0), (r, r), (0, 0)], mode="edge"),
        kv, (1, 1), [(0, 0), (0, 0)])
    del pad
    return out[0, 0]


def gradients(img):
    """Central-difference gradients (dx, dy), edges clamped."""
    dx = 0.5 * (jnp.roll(img, -1, axis=1) - jnp.roll(img, 1, axis=1))
    dy = 0.5 * (jnp.roll(img, -1, axis=0) - jnp.roll(img, 1, axis=0))
    dx = dx.at[:, 0].set(0.0).at[:, -1].set(0.0)
    dy = dy.at[0, :].set(0.0).at[-1, :].set(0.0)
    return dx, dy


def halfsample(img):
    """2x2 average downsample (exact bilinear 0.5x for even dims)."""
    H, W = img.shape
    H2, W2 = H // 2, W // 2
    v = img[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2)
    return v.mean(axis=(1, 3))


def resize_bilinear(img, out_h: int, out_w: int):
    return jax.image.resize(img, (out_h, out_w), method="bilinear")


def build_pyramid(img, num_levels: int, scale_factor: float = 2.0):
    """Image pyramid as a tuple of [H_l, W_l] arrays (static shapes).

    scale_factor=2.0 matches the reference EuRoC config
    (Examples/Monocular/EuRoC.yaml nLevels=4 scaleFactor=2.0); arbitrary
    factors go through jax.image.resize.
    """
    levels = [img]
    cur = img
    for lvl in range(1, num_levels):
        if scale_factor == 2.0:
            cur = halfsample(cur)
        else:
            s = scale_factor ** lvl
            cur = resize_bilinear(img, int(round(img.shape[0] / s)),
                                  int(round(img.shape[1] / s)))
        levels.append(cur)
    return tuple(levels)


def pyramid_scales(num_levels: int, scale_factor: float = 2.0):
    return [scale_factor ** l for l in range(num_levels)]


# --------------------------------------------------------- stacked pyramids
# A pyramid moves between host and device as ONE [SH, W0] buffer: level l
# occupies rows row_off[l] : row_off[l]+H_l, columns 0:W_l (width padded
# with zeros to W0). Static slicing unstacks it for free inside a trace, so
# jitted consumers accept either representation (`as_levels`), and the host
# never pays one transfer per level.

def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float = 2.0):
    """Per-level (H_l, W_l) shapes matching build_pyramid."""
    shapes = [(h, w)]
    for lvl in range(1, n_levels):
        if scale_factor == 2.0:
            ph, pw = shapes[-1]
            shapes.append((ph // 2, pw // 2))
        else:
            s = scale_factor ** lvl
            shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


def stack_rows(h: int, w: int, n_levels: int, scale_factor: float = 2.0):
    """(row_offsets, total_rows) of the stacked pyramid layout."""
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    offs, acc = [], 0
    for (ph, _pw) in shapes:
        offs.append(acc)
        acc += ph
    return offs, acc


def stack_pyramid(pyr):
    """Tuple of [H_l, W_l] levels -> one [SH, W0] stacked buffer
    (traceable)."""
    w0 = pyr[0].shape[1]
    rows = []
    for lvl in pyr:
        ph, pw = lvl.shape
        if pw < w0:
            lvl = jnp.pad(lvl, ((0, 0), (0, w0 - pw)))
        rows.append(lvl)
    return jnp.concatenate(rows, axis=0)


def unstack_pyramid(stack, n_levels: int, scale_factor: float = 2.0,
                    height: int | None = None):
    """Stacked [SH, W0] -> tuple of [H_l, W_l] levels (static slices)."""
    w0 = stack.shape[1]
    if height is None:
        # recover H from the level-shape table by search (exact for the
        # shapes we build)
        for h in range(1, stack.shape[0] + 1):
            offs, total = stack_rows(h, w0, n_levels, scale_factor)
            if total == stack.shape[0]:
                height = h
                break
        else:
            raise ValueError(f"cannot infer level heights from SH="
                             f"{stack.shape[0]}")
    shapes = pyramid_shapes(height, w0, n_levels, scale_factor)
    offs, total = stack_rows(height, w0, n_levels, scale_factor)
    assert total == stack.shape[0], (total, stack.shape)
    return tuple(stack[o: o + ph, :pw]
                 for (o, (ph, pw)) in zip(offs, shapes))


def as_levels(pyr, n_levels: int, scale_factor: float = 2.0,
              height: int | None = None):
    """Accept a pyramid as EITHER a tuple of levels or a stacked [SH, W0]
    array; return the tuple form. Free at trace time (static slices), so
    jitted consumers call this on entry and the host can keep pyramids in
    their single-buffer form."""
    if isinstance(pyr, (tuple, list)):
        return tuple(pyr)
    return unstack_pyramid(pyr, n_levels, scale_factor, height)


def level0(pyr, height: int):
    """The level-0 image from either pyramid representation."""
    if isinstance(pyr, (tuple, list)):
        return pyr[0]
    return pyr[:height]


def extract_patches(img, uv, half: int):
    """Gather square patches of side (2*half+1) centered at integer-rounded
    uv [N,2]. Returns [N, 2h+1, 2h+1]; centers are clamped so patches stay
    in-image (callers mask by border)."""
    H, W = img.shape
    size = 2 * half + 1
    cx = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), half, W - half - 1)
    cy = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), half, H - half - 1)

    def one(cx_i, cy_i):
        return jax.lax.dynamic_slice(img, (cy_i - half, cx_i - half),
                                     (size, size))

    return jax.vmap(one)(cx, cy)
