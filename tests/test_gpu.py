"""The Pallas kernels compiled for a GPU (no interpret mode) against their
plain references. Skipped on the CPU; ``python chip_smoke.py`` runs the
same comparisons at full width on the card."""
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("use_cf", [False, True])
def test_merge_kernel_bit_exact_on_gpu(gpu, use_cf):
    from relate_tpu.core.treebuilder import thresholds
    from relate_tpu.ops.merge_scan_inc import (merge_scan_inc_host,
                                               merge_scan_incremental)
    N = 300
    rng = np.random.default_rng(1)
    X = rng.random((N, N), dtype=np.float32) * 100
    d = ((X + X.T) / 2 + rng.random((N, N), dtype=np.float32))
    np.fill_diagonal(d, 0)
    dcf = (rng.random((N, N)) < 0.5).astype(np.float32) * 6.9
    thr, thrcf = thresholds(0.001)
    cis, cjs, _ = merge_scan_incremental(jnp.asarray(d), jnp.asarray(dcf),
                                         use_cf, thr, thrcf, 3)
    cis_h, cjs_h = merge_scan_inc_host(d, dcf, use_cf, thr, thrcf, 3)
    assert np.array_equal(np.asarray(cis), cis_h)
    assert np.array_equal(np.asarray(cjs), cjs_h)


def test_painter_kernels_match_scan_on_gpu(gpu):
    from relate_tpu.core import painting
    rng = np.random.default_rng(2)
    N, L = 300, 400
    G = (rng.random((L, N)) < 0.1).astype(np.uint8)
    r = rng.random(L) * 1e-3
    model = painting.PaintingModel(N=N, theta=0.001)
    bounds = np.array([0, 200, L])
    p_s = painting.Painter(G, r, model, use_kernel=False)
    p_k = painting.Painter(G, r, model)
    assert p_k.use_kernel
    cps_s = p_s.paint_stepping_stones(bounds)
    cps_k = p_k.paint_stepping_stones(bounds)
    for cs, ck in zip(cps_s, cps_k):
        np.testing.assert_allclose(ck.alpha, cs.alpha, rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(ck.beta, cs.beta, rtol=1e-5, atol=1e-30)
    out_s, out_k = p_s.repaint(cps_s[1]), p_k.repaint(cps_k[1])
    topo_s, topo_k = np.asarray(out_s.topology), np.asarray(out_k.topology)
    for b in range(N):
        d = out_s.plan.D[b]
        np.testing.assert_allclose(topo_k[:d, b], topo_s[:d, b], rtol=1e-5,
                                   atol=1e-30)
