"""Grid-based keypoint selection with occupancy masking (DSO-style).

Replaces ORBextractor::ComputeKeyPointsDSOSingleLevel
(/root/reference/src/ORBextractor.cc:1275-1386): adaptive-grid FAST selection
with <=3 corners per cell, a 20-px border, and an occupancy mask around
already-tracked points. The batched formulation is fully static-shaped: the score
map is tiled into cells, a per-cell top-k picks candidates, and a global top-k
fills a fixed keypoint capacity with a validity mask (no dynamic compaction).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def stamp_occupancy(h: int, w: int, uv, valid, radius: int):
    """Boolean [h,w] map, True within `radius` (Chebyshev) of any valid uv."""
    x = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, h - 1)
    occ = jnp.zeros((h, w), jnp.float32)
    occ = occ.at[y, x].max(valid.astype(jnp.float32))
    if radius > 0:
        k = 2 * radius + 1
        occ = jax.lax.reduce_window(
            occ, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME")
    return occ > 0.5


@functools.partial(jax.jit,
                   static_argnames=("cell", "max_per_cell", "max_kp", "border"))
def select_grid_topk(score, cell: int, max_per_cell: int, max_kp: int,
                     border: int = 20, occupancy=None, min_score: float = 0.0):
    """Pick up to `max_kp` keypoints: <= max_per_cell strongest per grid cell,
    then strongest overall.

    Args:
      score: [H,W] response map (already NMS'd if desired).
      occupancy: optional [H,W] bool, True = suppressed.
    Returns:
      uv [max_kp,2] float32, kp_score [max_kp], valid [max_kp] bool.
    """
    H, W = score.shape
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    ok = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    if occupancy is not None:
        ok = ok & (~occupancy)
    s = jnp.where(ok & (score > min_score), score, -1.0)

    gh = (H + cell - 1) // cell
    gw = (W + cell - 1) // cell
    pad_h = gh * cell - H
    pad_w = gw * cell - W
    s = jnp.pad(s, ((0, pad_h), (0, pad_w)), constant_values=-1.0)
    cells = s.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3)
    cells = cells.reshape(gh * gw, cell * cell)

    top_s, top_i = jax.lax.top_k(cells, max_per_cell)  # [C,m]
    # reconstruct coordinates
    ci = jnp.arange(gh * gw)[:, None]
    cy = (ci // gw) * cell + top_i // cell
    cx = (ci % gw) * cell + top_i % cell

    flat_s = top_s.reshape(-1)
    flat_x = cx.reshape(-1).astype(jnp.float32)
    flat_y = cy.reshape(-1).astype(jnp.float32)

    k = min(max_kp, flat_s.shape[0])
    best_s, best_i = jax.lax.top_k(flat_s, k)
    uv = jnp.stack([flat_x[best_i], flat_y[best_i]], axis=1)
    valid = best_s > 0.0
    if k < max_kp:
        uv = jnp.pad(uv, ((0, max_kp - k), (0, 0)))
        best_s = jnp.pad(best_s, (0, max_kp - k))
        valid = jnp.pad(valid, (0, max_kp - k))
    return uv, best_s, valid


def cell_size_for_budget(h: int, w: int, n_features: int) -> int:
    """Initial DSO grid size ~ sqrt(H*W/n) (src/ORBextractor.cc:1295),
    clamped to [8, 64]. Static (host) computation."""
    import math
    g = int(math.sqrt(h * w / max(n_features, 1)))
    return max(8, min(64, g))


def select_octree(score, max_kp: int, border: int = 20, occupancy=None,
                  min_score: float = 0.0, levels: int = 3):
    """Quadtree-style adaptive keypoint distribution
    (reference ORBextractor::DistributeOctTree, src/ORBextractor.cc:479-720).

    The reference recursively splits cells while nodes < N and keeps the best
    corner per leaf — guaranteeing spatial coverage while concentrating the
    budget where texture exists. The static-shaped XLA formulation runs the
    per-cell-best selection at `levels` dyadic cell sizes coarse->fine:
    every coarse cell's best corner is kept unconditionally (coverage = the
    early quadtree levels), then finer levels fill the remaining budget by
    score (= the deeper splits in textured regions), with already-picked
    pixels suppressed via the occupancy map between levels.

    Returns (uv [max_kp,2], score [max_kp], valid [max_kp]).
    """
    H, W = score.shape
    c_fine = cell_size_for_budget(H, W, max_kp)
    uvs, scs, vals = [], [], []
    occ = occupancy
    for li in range(levels):
        cell = c_fine * (2 ** (levels - 1 - li))
        n_cells = ((H + cell - 1) // cell) * ((W + cell - 1) // cell)
        uv, s, v = select_grid_topk(score, cell=cell, max_per_cell=1,
                                    max_kp=min(max_kp, n_cells),
                                    border=border, occupancy=occ,
                                    min_score=min_score)
        # coarser levels outrank any finer score: every covered region
        # keeps its best corner (the reference keeps the best per leaf
        # regardless of global ranking)
        prio = jnp.where(v, s + (levels - 1 - li) * 1e6, -1.0)
        uvs.append(uv)
        scs.append(s)
        vals.append(prio)
        occ2 = stamp_occupancy(H, W, uv, v, radius=1)
        occ = occ2 if occ is None else (occ | occ2)
    uv = jnp.concatenate(uvs)
    s = jnp.concatenate(scs)
    prio = jnp.concatenate(vals)
    top_p, top_i = jax.lax.top_k(prio, max_kp)
    return uv[top_i], s[top_i], top_p > 0.0
