"""fast_score_map and hamming_matrix against their plain numpy references:
exactly equal on integer-valued inputs (the same references chip_smoke.py
holds the GPU to)."""
import numpy as np
import jax.numpy as jnp
import pytest

from ygz_tpu.ops.fast import fast_score_map, fast_score_map_ref
from ygz_tpu.ops.matching import hamming_matrix, hamming_matrix_ref


@pytest.mark.parametrize("shape,threshold", [((480, 752), 20.0),
                                             ((101, 137), 15.0)])
def test_fast_score_map_matches_numpy(shape, threshold):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape).astype(np.float32)
    got = np.asarray(fast_score_map(jnp.asarray(img), threshold))
    ref = fast_score_map_ref(img, threshold)
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).sum() > 100   # the image really produces corners


def test_hamming_matrix_matches_popcount():
    rng = np.random.default_rng(0)
    b1 = rng.integers(0, 2, (96, 256)).astype(np.uint8)
    b2 = rng.integers(0, 2, (80, 256)).astype(np.uint8)
    got = np.asarray(hamming_matrix(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_array_equal(got, hamming_matrix_ref(b1, b2))


def _nn_ref(d, max_dist, ratio):
    """Row-wise nearest neighbour + ratio test in numpy (lowest index on
    ties)."""
    idx = np.argmin(d, axis=1)
    best = d[np.arange(len(d)), idx]
    rest = d.copy()
    rest[np.arange(len(d)), idx] = np.inf
    ok = (best <= max_dist) & (best <= ratio * rest.min(1))
    return np.where(ok, idx, -1), ok


@pytest.mark.parametrize("ties", [False, True])
def test_nn_match_both_directions_match_numpy(ties):
    """nn_match on a distance matrix and on its transpose inside ONE
    program (the mutual check's shape), against numpy."""
    import jax
    from ygz_tpu.ops.matching import nn_match

    rng = np.random.default_rng(7)
    d = rng.integers(0, 120, (200, 150)).astype(np.float32)
    if ties:
        d[:, 1::2] = d[:, ::2][:, : d[:, 1::2].shape[1]]   # equal pairs
        d[:20, :] = 0.0                                     # all-tied rows
    d[rng.random(d.shape) < 0.5] = 1e9

    @jax.jit
    def both(x):
        return nn_match(x, 50, 0.8), nn_match(x.T, 50, 0.8)

    (i12, ok12), (i21, ok21) = jax.tree.map(np.asarray, both(d))
    for got_i, got_ok, m in ((i12, ok12, d), (i21, ok21, d.T)):
        want_i, want_ok = _nn_ref(m, 50, 0.8)
        np.testing.assert_array_equal(got_ok, want_ok)
        np.testing.assert_array_equal(got_i, want_i)
