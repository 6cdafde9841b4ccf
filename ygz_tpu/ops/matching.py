"""Descriptor matching: Hamming distances as a matmul + gated NN search.

Replaces ORBmatcher's scalar popcount loops (/root/reference/src/
ORBmatcher.cc — DescriptorDistance :1507, SearchFor* throughout) with one
batched formulation: with descriptors as ±1 vectors, the Hamming distance is
(256 - <d1, d2>)/2, so one [N1,256]x[256,N2] matmul scores every pair at
once. Window/area gating becomes an additive mask on the distance
matrix; the rotation-consistency histogram (HISTO_LENGTH=30, keep top-3 bins,
ComputeThreeMaxima :1471) is a batched histogram.

Constants follow the reference: TH_HIGH=100, TH_LOW=50 (src/ORBmatcher.cc:36).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
N_BITS = 256
BIG = 1e9


def hamming_matrix(bits1, bits2, valid1=None, valid2=None):
    """[N1,256] x [N2,256] 0/1 descriptors -> [N1,N2] float32 Hamming.

    Invalid rows/cols get distance BIG.
    """
    s1 = bits1.astype(jnp.float32) * 2.0 - 1.0
    s2 = bits2.astype(jnp.float32) * 2.0 - 1.0
    dot = jax.lax.dot_general(s1, s2, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    d = 0.5 * (N_BITS - dot)
    if valid1 is not None:
        d = jnp.where(valid1[:, None], d, BIG)
    if valid2 is not None:
        d = jnp.where(valid2[None, :], d, BIG)
    return d


def hamming_matrix_ref(bits1, bits2):
    """Plain numpy Hamming matrix by popcount of packed XORs: [N1,256] x
    [N2,256] 0/1 -> [N1,N2] float32. The reference for hamming_matrix."""
    p1 = np.packbits(np.asarray(bits1, np.uint8), axis=1)
    p2 = np.packbits(np.asarray(bits2, np.uint8), axis=1)
    pop = np.array([bin(i).count("1") for i in range(256)], np.int32)
    x = p1[:, None, :] ^ p2[None, :, :]
    return pop[x].sum(-1).astype(np.float32)


def nn_match(dist, max_dist=TH_LOW, ratio=1.0):
    """Row-wise nearest neighbour with Lowe ratio test.

    Best and second-best come from argmin and a masked min, not
    lax.top_k: on XLA:GPU (jax 0.9.0) a program that takes top_k of both
    `dist` and `dist.T` (the mutual check) gets wrong indices for the
    second one, which broke map-point triangulation on the GPU. Ties
    resolve to the lowest index, as top_k's did.

    Returns (idx [N1] int32 — match in set 2 or -1, ok [N1] bool).
    """
    idx = jnp.argmin(dist, axis=1).astype(jnp.int32)
    best = jnp.min(dist, axis=1)
    cols = jnp.arange(dist.shape[1], dtype=jnp.int32)
    second = jnp.min(jnp.where(cols[None, :] == idx[:, None], jnp.inf, dist),
                     axis=1)
    ok = (best <= max_dist) & (best <= ratio * second)
    return jnp.where(ok, idx, -1), ok


def mutual_filter(idx12, idx21):
    """Keep only mutual matches: idx21[idx12[i]] == i."""
    n1 = idx12.shape[0]
    back = jnp.where(idx12 >= 0, idx21[jnp.clip(idx12, 0, idx21.shape[0] - 1)],
                     -2)
    ok = back == jnp.arange(n1)
    return jnp.where(ok, idx12, -1), ok


def window_gate(uv1, uv2, radius):
    """Additive BIG penalty outside a search window: pairs (i,j) allowed only
    if |uv2[j] - uv1_pred[i]| < radius (Chebyshev). Returns [N1,N2] penalty."""
    d = jnp.abs(uv1[:, None, :] - uv2[None, :, :])
    inside = (d[..., 0] < radius) & (d[..., 1] < radius)
    return jnp.where(inside, 0.0, BIG)


def rotation_consistency(ang1, ang2, idx, ok):
    """ORB-SLAM rotation-histogram filter: histogram dtheta over 30 bins,
    keep matches in the top-3 bins. Returns refined ok mask."""
    a2 = ang2[jnp.clip(idx, 0, ang2.shape[0] - 1)]
    rot = (ang1 - a2) * (180.0 / jnp.pi)
    rot = jnp.where(rot < 0, rot + 360.0, rot)
    bin_w = 360.0 / HISTO_LENGTH
    b = jnp.clip((rot / bin_w).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    counts = jnp.zeros(HISTO_LENGTH, jnp.int32).at[b].add(ok.astype(jnp.int32))
    top3 = jax.lax.top_k(counts, 3)[0]
    # bins kept: count >= max(0.1*max, third-largest) — reference keeps the 3
    # largest bins (dropping a bin if < 0.1 * max count)
    thresh = jnp.maximum(top3[2], (0.1 * top3[0]).astype(jnp.int32))
    keep_bin = counts >= jnp.maximum(thresh, 1)
    return ok & keep_bin[b]


@functools.partial(jax.jit, static_argnames=("radius", "max_dist", "ratio",
                                             "mutual"))
def match_with_windows(bits1, valid1, bits2, valid2, uv_pred1=None, uv2=None,
                       radius=None, max_dist=TH_LOW, ratio=0.9,
                       ang1=None, ang2=None, mutual=False,
                       groups1=None, groups2=None):
    """One-stop batched matcher used by the tracking front-end.

    Jitted with the gate parameters static: the eager form ran ~10-15
    op-by-op device dispatches per call; jitted it is one.

    Mirrors ORBmatcher::SearchByProjection semantics: optional window gate
    around predicted positions, Hamming NN + ratio, optional rotation
    histogram, optional mutual-consistency check.

    groups1/groups2: optional per-feature FeatureVector node ids — when
    given, candidate pairs are gated to the SAME vocabulary-tree group (the
    reference's node-level SearchByBoW iteration over DBoW2 FeatureVectors,
    src/ORBmatcher.cc:155-263; here a batched additive penalty). Features
    with group -1 (unquantized) match freely.
    """
    d = hamming_matrix(bits1, bits2, valid1, valid2)
    if radius is not None:
        d = d + window_gate(uv_pred1, uv2, radius)
    if groups1 is not None and groups2 is not None:
        same = ((groups1[:, None] == groups2[None, :])
                | (groups1[:, None] < 0) | (groups2[None, :] < 0))
        d = d + jnp.where(same, 0.0, BIG)
    idx, ok = nn_match(d, max_dist=max_dist, ratio=ratio)
    if ang1 is not None and ang2 is not None:
        ok = rotation_consistency(ang1, ang2, idx, ok)
        idx = jnp.where(ok, idx, -1)
    if mutual:
        idx21, _ = nn_match(d.T, max_dist=max_dist, ratio=ratio)
        idx, mok = mutual_filter(idx, idx21)
        ok = ok & mok
    return idx, ok


@functools.partial(jax.jit,
                   static_argnames=("radius", "max_dist", "ratio", "mutual"))
def match_with_windows_batch(bits1, valid1, bits2, valid2, uv1, uv2,
                             radius: float, max_dist: float = TH_LOW,
                             ratio: float = 0.9, mutual: bool = True):
    """match_with_windows vmapped over a leading target axis: T independent
    window-gated matches in ONE dispatch (the mapping tail's fuse stage ran
    one dispatch per target keyframe in round 4 — VERDICT r5 #2).

    Arrays carry a leading [T] axis; the target-side args (bits2/valid2/
    uv2) may instead be length-T tuples of per-target arrays (e.g. the
    mapper's device-resident per-KF feature mirrors) — they are stacked
    in-trace, costing nothing extra. Returns (idx [T,N1], ok [T,N1])."""
    if isinstance(bits2, (tuple, list)):
        bits2 = jnp.stack(bits2)
        valid2 = jnp.stack(valid2)
        uv2 = jnp.stack(uv2)

    def one(b1, v1, b2, v2, u1, u2):
        return match_with_windows(b1, v1, b2, v2, uv_pred1=u1, uv2=u2,
                                  radius=radius, max_dist=max_dist,
                                  ratio=ratio, mutual=mutual)

    return jax.vmap(one)(bits1, valid1, bits2, valid2, uv1, uv2)


@jax.jit
def distinctive_descriptors_packed(packed_stack, valid):
    """distinctive_descriptors on a bit-PACKED stack [N,B,32] u8
    (np.packbits layout, MSB first): unpacks in-trace, so the upload is
    8x smaller and the whole update is one dispatch instead of a chain of
    eager ops."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (packed_stack[..., :, None] >> shifts) & jnp.uint8(1)
    stack = bits.reshape(packed_stack.shape[:-1] + (N_BITS,))
    return distinctive_descriptors(stack, valid)


def distinctive_descriptors(desc_stack, valid):
    """Min-median-Hamming representative descriptor per point.

    desc_stack [N,B,256] 0/1, valid [N,B] — up to B observed descriptors per
    map point. Returns (best [N] int32 index into B, desc [N,256]): the
    descriptor whose median distance to the other observations is smallest
    (reference MapPoint::ComputeDistinctiveDescriptors,
    src/MapPoint.cc:211-289, scalar loops -> one batched einsum here).
    """
    s = desc_stack.astype(jnp.float32) * 2.0 - 1.0
    dot = jnp.einsum("nib,njb->nij", s, s)
    d = 0.5 * (N_BITS - dot)                                  # [N,B,B]
    pair_ok = valid[:, None, :] & valid[:, :, None]
    d = jnp.where(pair_ok, d, BIG)
    # masked median over j: sort each row; the median of k valid entries
    # (incl. self-distance 0) sits at index (k-1)//2 of the sorted row
    ds = jnp.sort(d, axis=-1)
    k = valid.sum(-1)[:, None]                                # [N,1]
    mid = jnp.clip((k - 1) // 2, 0, d.shape[-1] - 1)
    med = jnp.take_along_axis(ds, mid[..., None], axis=-1)[..., 0]  # [N,B]
    med = jnp.where(valid, med, BIG)
    best = jnp.argmin(med, axis=-1).astype(jnp.int32)
    desc = jnp.take_along_axis(
        desc_stack, best[:, None, None].astype(jnp.int32), axis=1)[:, 0]
    return best, desc
