"""Multi-level ORB feature extraction as one fused, batched pipeline.

Batched replacement for ORBextractor (/root/reference/src/ORBextractor.cc):
per pyramid level — FAST score map -> 3x3 NMS -> grid-capped top-k selection
(the DSO-style selector semantics of ComputeKeyPointsDSOSingleLevel
:1275-1386) -> IC-angle -> steered BRIEF on the blurred level — all compiled
into a single jitted function with fixed per-level keypoint budgets
(geometric in 1/scaleFactor like the reference :434-445).

Keypoint uv is reported in LEVEL-0 pixel coordinates; `level` records the
source octave (scale = scale_factor**level).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from ..ops import fast, select, orb
from ..ops.image import gaussian_blur, as_levels


class Features(NamedTuple):
    uv: jnp.ndarray      # [M,2] level-0 coords
    level: jnp.ndarray   # [M] int32 octave
    angle: jnp.ndarray   # [M] radians
    score: jnp.ndarray   # [M]
    desc: jnp.ndarray    # [M,256] uint8 bits
    valid: jnp.ndarray   # [M] bool


def level_budgets(n_features: int, n_levels: int, scale_factor: float):
    """Per-level keypoint budgets, geometric in 1/scale_factor (reference
    ORBextractor ctor src/ORBextractor.cc:434-445)."""
    inv = 1.0 / scale_factor
    w = [inv ** l for l in range(n_levels)]
    s = sum(w)
    b = [max(16, int(round(n_features * wi / s))) for wi in w]
    return b


class OrbExtractor:
    """Holds static config; __call__ is jit-compiled once per image shape."""

    def __init__(self, n_features: int = 512, n_levels: int = 4,
                 scale_factor: float = 2.0, fast_th: float = 20.0,
                 fast_th_min: float = 7.0, cell: int = 16,
                 max_per_cell: int = 3, border: int = 20,
                 mode: str = "grid"):
        # mode: 'grid' = DSO-style adaptive grid (the reference's direct-path
        # selector, ComputeKeyPointsDSOSingleLevel); 'octree' = quadtree-
        # style distribution (DistributeOctTree, the reference's
        # ORBSLAM_KEYPOINT mode for keyframes/reloc)
        self.n_features = n_features
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.fast_th = fast_th
        self.fast_th_min = fast_th_min
        self.cell = cell
        self.max_per_cell = max_per_cell
        self.border = border
        assert mode in ("grid", "octree"), mode
        self.mode = mode
        self.budgets = level_budgets(n_features, n_levels, scale_factor)
        self.total = sum(self.budgets)
        self._jit = jax.jit(self._extract)

    def _extract_level(self, img, budget, border, occupancy=None):
        score = fast.fast_score_map(img, self.fast_th)
        score_lo = fast.fast_score_map(img, self.fast_th_min)
        # fall back to the low threshold where the high one found nothing in
        # a cell — approximated by blending: prefer high-th corners by adding
        # a large bonus so they rank first (reference retries per cell with
        # th=7, src/ORBextractor.cc:1315-1330)
        merged = jnp.where(score > 0, score + 1000.0, score_lo)
        merged = fast.nonmax_3x3(merged)
        if self.mode == "octree":
            uv, s, valid = select.select_octree(
                merged, max_kp=budget, border=border, occupancy=occupancy)
        else:
            uv, s, valid = select.select_grid_topk(
                merged, cell=self.cell, max_per_cell=self.max_per_cell,
                max_kp=budget, border=border, occupancy=occupancy)
        ang = orb.ic_angles(img, uv, valid)
        blurred = gaussian_blur(img, 7, 2.0)
        desc = orb.brief_descriptors(blurred, uv, ang, valid)
        return uv, s, valid, ang, desc

    def _extract(self, pyramid, occupancy):
        pyramid = as_levels(pyramid, self.n_levels, self.scale_factor)
        outs = []
        for lvl in range(self.n_levels):
            img = pyramid[lvl]
            scale = self.scale_factor ** lvl
            occ = occupancy[lvl] if occupancy is not None else None
            # border shrinks with level so level-0 coverage stays constant
            border = max(8, int(round(self.border / scale)))
            uv, s, valid, ang, desc = self._extract_level(
                img, self.budgets[lvl], border, occ)
            uv0 = (uv + 0.5) * scale - 0.5
            outs.append((uv0, jnp.full(uv.shape[0], lvl, jnp.int32), ang, s,
                         desc, valid))
        uv = jnp.concatenate([o[0] for o in outs])
        level = jnp.concatenate([o[1] for o in outs])
        ang = jnp.concatenate([o[2] for o in outs])
        s = jnp.concatenate([o[3] for o in outs])
        desc = jnp.concatenate([o[4] for o in outs])
        valid = jnp.concatenate([o[5] for o in outs])
        return Features(uv=uv, level=level, angle=ang, score=s, desc=desc,
                        valid=valid)

    def _extract_kf(self, pyramid, uv0, level, valid):
        """Traceable fused keyframe extraction: descriptors/angles at the
        tracked positions (deferred extraction, the reference recomputes
        descriptors for direct-tracked keypoints at keyframe time,
        src/ORBextractor.cc:1031-1127) + occupancy stamping around them +
        fresh features in the unoccupied area — ONE program where the
        round-4 host path dispatched describe_at + n_levels occupancy
        stamps + the extractor separately (~6 device launches per KF)."""
        pyramid = as_levels(pyramid, self.n_levels, self.scale_factor)
        ang, desc = describe_at_core(pyramid, uv0, level, valid,
                                     self.n_levels, self.scale_factor)
        occ = []
        for l in range(self.n_levels):
            s = 0.5 ** l
            h, w = pyramid[l].shape
            uv_l = (uv0 + 0.5) * s - 0.5
            occ.append(select.stamp_occupancy(
                h, w, uv_l, valid, radius=max(4, int(8 * s))))
        feats = self._extract(pyramid, tuple(occ))
        return ang, desc, feats

    def extract_keyframe(self, pyramid, uv0, level, valid):
        """Fused keyframe extraction (see _extract_kf). `pyramid` may be a
        level tuple or a stacked [SH,W] buffer. Returns (angle [M], desc
        [M,256], Features)."""
        if not hasattr(self, "_jit_kf"):
            self._jit_kf = jax.jit(self._extract_kf)
        if isinstance(pyramid, (tuple, list)):
            pyramid = tuple(pyramid)
        return self._jit_kf(pyramid, jnp.asarray(uv0), jnp.asarray(level),
                            jnp.asarray(valid))

    def __call__(self, pyramid, occupancy=None) -> Features:
        if isinstance(pyramid, (tuple, list)):
            pyramid = tuple(pyramid)
        return self._jit(pyramid,
                         tuple(occupancy) if occupancy is not None else None)


def describe_at_core(pyramid, uv0, level, valid, n_levels: int,
                     scale_factor: float):
    """Traceable body of describe_at."""
    pyramid = as_levels(pyramid, n_levels, scale_factor)
    M = uv0.shape[0]
    angle = jnp.zeros(M, jnp.float32)
    desc = jnp.zeros((M, 256), jnp.uint8)
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        sel = valid & (level == lvl)
        uv_l = (uv0 + 0.5) * s - 0.5
        img = pyramid[lvl]
        ang_l = orb.ic_angles(img, uv_l, sel)
        blurred = gaussian_blur(img, 7, 2.0)
        desc_l = orb.brief_descriptors(blurred, uv_l, ang_l, sel)
        angle = jnp.where(sel, ang_l, angle)
        desc = jnp.where(sel[:, None], desc_l, desc)
    return angle, desc


@functools.partial(jax.jit, static_argnames=("n_levels", "scale_factor"))
def describe_at(pyramid, uv0, level, valid, n_levels: int = 4,
                scale_factor: float = 2.0):
    """Compute IC-angle + BRIEF for EXISTING keypoint positions (the analog of
    the reference recomputing descriptors for direct-tracked keypoints at
    keyframe time, src/ORBextractor.cc:1031-1127).

    uv0 [M,2] level-0 coords, level [M] octave; `pyramid` may be a level
    tuple or a stacked [SH,W] buffer. Returns (angle [M], desc [M,256]).
    """
    return describe_at_core(pyramid, uv0, level, valid, n_levels,
                            scale_factor)
