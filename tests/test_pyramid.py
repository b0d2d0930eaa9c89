"""Pyramid-form partition maxima (ops/pyramid.py): parity with the
child-table reductions.  This is the ROADMAP #1 prototype — every level is a
regular 2x2x2 max-pool over a power-of-two embedding, the array-idiomatic
replacement for ragged segment reductions."""

import numpy as np
import pytest

from sperr_tpu.codec import speck_wave as sw
from sperr_tpu.ops import pyramid as pyr_mod

DYADIC = [(8, 8, 8), (16, 16, 16), (9, 9, 9), (12, 10, 14), (17, 19, 23)]


def _case(dims, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(dims))
    mags = np.zeros(n, dtype=np.uint64)
    idx = rng.choice(n, max(1, n // 10), replace=False)
    mags[idx] = rng.integers(1, 100000, size=idx.size)
    return sw.msbp1(mags)


@pytest.mark.parametrize("dims", DYADIC)
def test_node_max_matches_child_table(dims):
    pmsb = _case(dims)
    tree = sw.build_tree(dims)
    want = sw.compute_node_max(tree, pmsb)
    got = pyr_mod.node_max_pyramid(pyr_mod.Pyramid(dims), pmsb, tree)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dims", DYADIC)
def test_exposure_matches_tree(dims):
    pmsb = _case(dims, seed=1)
    num_bp = int(pmsb.max())
    tree = sw.build_tree(dims)
    node_max = sw.compute_node_max(tree, pmsb)
    node_s = np.where(node_max > 0, num_bp - node_max, sw._NEVER).astype(np.int32)
    e_want = np.full(int(np.prod(dims)), sw._NEVER, dtype=np.int32)
    e_want[tree.px_linear] = node_s[tree.px_parent]
    e_got = pyr_mod.exposure_pyramid(pyr_mod.Pyramid(dims), pmsb, num_bp)
    np.testing.assert_array_equal(e_got, e_want)


def test_packet_dims_rejected():
    dims = (64, 64, 21)  # wavelet-packet init
    tree = sw.build_tree(dims)
    pmsb = _case(dims)
    with pytest.raises(ValueError):
        pyr_mod.node_max_pyramid(pyr_mod.Pyramid(dims), pmsb, tree)
