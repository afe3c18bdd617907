"""Incremental merge-scan kernel vs its NumPy twin and the XLA twin.

The Triton kernel runs in interpret mode on CPU (conftest forces the CPU
backend). With
continuous random distances every minimum is unique, so tie-break sources
are irrelevant and all implementations must agree exactly wherever their
semantics coincide:

- no CF prior: incremental == XLA twin == NumPy twin (exact merge lists)
- with CF prior: incremental == NumPy twin (the kernel keeps the
  REFERENCE's stale CF row-minima — tree_builder.cpp:2483-2510 — while the
  XLA twin refreshes them every step, a documented deviation)
- negative threshold: no pair is ever mutual -> the fallback-sym path runs
  every step
- several tie-hash seeds: the kernel's in-kernel hash must match the
  host twin's for every pair
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from relate_tpu.ops.merge_scan_inc import (merge_scan_incremental,
                                           merge_scan_inc_host)
from relate_tpu.core.topology_device import _merge_scan
from relate_tpu.core.treebuilder import tree_from_merges


def _rand(N, seed, scale=100.0):
    rng = np.random.default_rng(seed)
    d = rng.random((N, N)).astype(np.float32) * scale
    np.fill_diagonal(d, 0)
    return d


@pytest.mark.parametrize("threshold", [1e-6, 5.0])
@pytest.mark.parametrize("N", [40, 37])
def test_inc_matches_xla_no_cf(threshold, N):
    d = _rand(N, 0)
    dcf = np.zeros_like(d)
    cis_i, cjs_i, _ = merge_scan_incremental(
        jnp.asarray(d), jnp.asarray(dcf), False, threshold, 1e-6, 7,
        interpret=True)
    cis_x, cjs_x, _ = _merge_scan(
        jnp.asarray(d), jnp.asarray(dcf), jnp.bool_(False),
        jnp.float32(threshold), jnp.float32(1e-6), jax.random.PRNGKey(7))
    assert np.array_equal(np.asarray(cis_i), np.asarray(cis_x))
    assert np.array_equal(np.asarray(cjs_i), np.asarray(cjs_x))


@pytest.mark.parametrize("use_cf", [False, True])
@pytest.mark.parametrize("seed", [8, 64])
def test_inc_matches_host_twin(use_cf, seed):
    N = 40
    d = _rand(N, 3)
    dcf = _rand(N, 4, scale=10.0)
    thr, thrcf = 2.0, 0.5
    cis_i, cjs_i, _ = merge_scan_incremental(
        jnp.asarray(d), jnp.asarray(dcf), use_cf, thr, thrcf, seed,
        interpret=True)
    cis_h, cjs_h = merge_scan_inc_host(d, dcf, use_cf, thr, thrcf, seed)
    assert np.array_equal(np.asarray(cis_i), cis_h)
    assert np.array_equal(np.asarray(cjs_i), cjs_h)


def test_inc_fallback_path():
    """threshold = -1 makes the mutual band empty every step -> the
    fallback (global symmetrized argmin) drives the whole scan."""
    N = 32
    d = _rand(N, 5)
    dcf = np.zeros_like(d)
    cis_i, cjs_i, _ = merge_scan_incremental(
        jnp.asarray(d), jnp.asarray(dcf), False, -1.0, 1e-6, 2,
        interpret=True)
    cis_h, cjs_h = merge_scan_inc_host(d, dcf, False, -1.0, 1e-6, 2)
    assert np.array_equal(np.asarray(cis_i), cis_h)
    assert np.array_equal(np.asarray(cjs_i), cjs_h)
    # and the fallback agrees with the XLA twin too (unique sym minima)
    cis_x, cjs_x, _ = _merge_scan(
        jnp.asarray(d), jnp.asarray(dcf), jnp.bool_(False),
        jnp.float32(-1.0), jnp.float32(1e-6), jax.random.PRNGKey(2))
    assert np.array_equal(np.asarray(cis_i), np.asarray(cis_x))


def test_inc_valid_tree():
    """Merge lists must always form a valid binary tree."""
    N = 48
    d = _rand(N, 9)
    cis, cjs, clades = merge_scan_incremental(
        jnp.asarray(d), jnp.asarray(np.zeros_like(d)), False, 1.0, 1e-6, 1,
        interpret=True)
    tr = tree_from_merges(np.asarray(cis), np.asarray(cjs), N)
    # every node except the root has a parent; clades partition correctly
    assert (tr.parent[:-1] >= N).all()
    cl = np.asarray(clades)
    assert cl[-1].sum() == N                       # root clade = all leaves
    assert (cl.sum(axis=1) >= 2).all()
