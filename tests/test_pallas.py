"""Pallas kernels (Triton route) vs their plain twins, in interpret mode on
the CPU, plus the CPU-side rules around them: the merge-scan dispatch by N,
the paint kernels' power-of-two lane blocks and the device planner."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from relate_tpu.core import topology_device
from relate_tpu.ops import paint_kernels


@pytest.mark.parametrize("N,backend,expect", [
    (8, "gpu", True), (5008, "gpu", True), (8, "cpu", False),
    (5008, "cpu", False)])
def test_merge_dispatch_by_n(N, backend, expect, monkeypatch):
    """A GPU's section builder merges with the incremental kernel at every
    N; every other backend uses the XLA twin."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    topology_device._KERNEL_CACHE.clear()
    topology_device.make_section_kernel(0.001, N, 64, 1)
    (key,) = topology_device._KERNEL_CACHE
    topology_device._KERNEL_CACHE.clear()
    assert key[1] == N and key[4] is expect


def test_section_kernel_cache_keys_on_merge_path():
    """Kernel and XLA merge paths compile distinct section programs."""
    a = topology_device.make_section_kernel(0.001, 8, 64, 1,
                                            use_kernel=False)
    b = topology_device.make_section_kernel(0.001, 8, 64, 1,
                                            use_kernel=True, interpret=True)
    assert a is not b
    assert a is topology_device.make_section_kernel(0.001, 8, 64, 1,
                                                    use_kernel=False)


@pytest.mark.parametrize("n,np_", [(8, 16), (5008, 8192)])
def test_paint_lane_block_is_pow2(n, np_):
    assert paint_kernels.pow2_lanes(n) == np_


# ---------------------------------------------------------------------------
# Painting kernels (ops/paint_kernels.py) vs the lax.scan twin
# ---------------------------------------------------------------------------

def _paint_fixture(seed=3, N=8, L=64):
    from relate_tpu.core import painting
    rng = np.random.default_rng(seed)
    G = (rng.random((L, N)) < 0.3).astype(np.uint8)
    r = rng.random(L) * 0.05
    model = painting.PaintingModel(N=N, theta=0.001)
    return painting, G, r, model


def _scan_reference(painting, G, r, model, plan):
    L, N = G.shape
    alpha0 = painting.initial_alpha(G, model, 0, np.arange(N, dtype=np.int32))
    beta_end = np.ones((N, N), np.float32)
    painter = painting.Painter(G, r, model, use_kernel=False)
    dev = painter._plan_dev(plan)
    a_all, lss = painter._run_fwd(plan, alpha0, dev)
    out = painter._run_bwd(plan, a_all, lss, beta_end, dev)
    args = tuple(jnp.asarray(x) for x in (
        G, plan.idx, plan.seqk, plan.pfac, plan.nxt, plan.D, plan.targets))
    return (alpha0, beta_end, args,
            tuple(np.asarray(x) for x in (a_all, lss) + tuple(out)))


def test_paint_pallas_kernels_match_scan():
    """fwd/bwd Pallas kernels (interpret) == the lax.scan twins on all
    valid rows; backward padding rows are zero by contract."""
    painting, G, r, model = _paint_fixture()
    plan = painting.build_target_plan(G, r, model, 0, G.shape[0] - 1)
    alpha0, beta_end, args, ref = _scan_reference(painting, G, r, model,
                                                  plan)
    a_all, lss, topo_s, lstot_s, _, _ = ref
    al_k, ls_k = paint_kernels.paint_fwd(
        *args, jnp.asarray(alpha0), theta=model.theta, interpret=True)
    topo_k, lstot_k = paint_kernels.paint_bwd(
        *args, jnp.asarray(beta_end), al_k, ls_k, theta=model.theta,
        interpret=True)
    al_k, ls_k = np.asarray(al_k), np.asarray(ls_k)
    topo_k, lstot_k = np.asarray(topo_k), np.asarray(lstot_k)
    for b in range(G.shape[1]):
        d = plan.D[b]
        np.testing.assert_allclose(al_k[:d, b], a_all[:d, b],
                                   rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(ls_k[:d, b], lss[:d, b],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(topo_k[:d, b], topo_s[:d, b],
                                   rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(lstot_k[:d, b], lstot_s[:d, b],
                                   rtol=1e-5, atol=1e-4)
        assert (topo_k[d:, b] == 0).all() and (lstot_k[d:, b] == 0).all()


@pytest.mark.parametrize("N", [8, 12])
def test_paint_capture_kernels_match_scan(N):
    """The stepping-stone capture kernels emit exactly the scan twins' row
    ``want[b]``; N=12 leaves 4 masked lanes in the 16-lane block."""
    painting, G, r, model = _paint_fixture(seed=7, N=N, L=80)
    plan = painting.build_target_plan(G, r, model, 0, G.shape[0] - 1)
    alpha0, beta_end, args, ref = _scan_reference(painting, G, r, model,
                                                  plan)
    a_all, _, _, _, beta_all, lsb_all = ref
    bidx = np.arange(N)
    want = (plan.D // 2).astype(np.int32)
    acap, _ = paint_kernels.paint_fwd_capture(
        *args, jnp.asarray(want), jnp.asarray(alpha0), theta=model.theta,
        interpret=True)
    bcap, lbcap = paint_kernels.paint_bwd_capture(
        *args, jnp.asarray(want), jnp.asarray(beta_end), theta=model.theta,
        interpret=True)
    np.testing.assert_allclose(np.asarray(acap), a_all[want, bidx],
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(np.asarray(bcap), beta_all[want, bidx],
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(np.asarray(lbcap), lsb_all[want, bidx],
                               rtol=1e-5, atol=1e-5)


def test_painter_kernel_path_matches_scan():
    """Painter with the kernels (stones over three windows, device slabs,
    device planner, repaint) == the scan-twin Painter."""
    from relate_tpu.core import painting
    rng = np.random.default_rng(2)
    N, L = 10, 240
    G = (rng.random((L, N)) < 0.3).astype(np.uint8)
    r = rng.random(L) * 1e-3
    model = painting.PaintingModel(N=N, theta=0.001)
    bounds = np.array([0, 80, 160, L])
    p_s = painting.Painter(G, r, model, use_kernel=False)
    p_k = painting.Painter(G, r, model, use_kernel=True, interpret=True)
    cps_s = p_s.paint_stepping_stones(bounds)
    cps_k = p_k.paint_stepping_stones(bounds)
    for cs, ck in zip(cps_s, cps_k):
        np.testing.assert_allclose(ck.alpha, cs.alpha, rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(ck.beta, cs.beta, rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(ck.ls_alpha, cs.ls_alpha, rtol=1e-5)
        np.testing.assert_allclose(ck.ls_beta, cs.ls_beta, rtol=1e-5)
    out_s = p_s.repaint(cps_s[1])
    out_k = p_k.repaint(cps_k[1])
    np.testing.assert_array_equal(np.asarray(out_k.plan.idx)[:, 0],
                                  out_s.plan.idx[:, 0])
    topo_s, topo_k = np.asarray(out_s.topology), np.asarray(out_k.topology)
    for b in range(N):
        d = out_s.plan.D[b]
        np.testing.assert_allclose(topo_k[:d, b], topo_s[:d, b], rtol=1e-5,
                                   atol=1e-30)


def test_device_planner_matches_host_plan():
    """make_device_planner == build_target_plan (idx/seqk/D exactly,
    pfac/nxt within two-float f32 tolerance)."""
    from relate_tpu.core import painting
    painting_mod, G, r, model = _paint_fixture(seed=11, N=8, L=200)
    L, N = G.shape
    targets = np.arange(N, dtype=np.int32)
    plan = painting_mod.build_target_plan(G, r, model, 0, L - 1, targets)
    planner = painting_mod.make_device_planner(model)
    S = np.zeros(L + 1); np.cumsum(r, out=S[1:])
    S_hi = S.astype(np.float32)
    S_lo = (S - S_hi.astype(np.float64)).astype(np.float32)
    Dmax = int(plan.D.max())
    fin = np.full(N, r[L - 1], np.float32)
    GT = jnp.asarray(np.ascontiguousarray(G.T))
    idx_d, seqk_d, D_d, pfac_d, nxt_d = planner(
        GT, jnp.asarray(S_hi), jnp.asarray(S_lo),
        jnp.asarray(targets), jnp.zeros(N, jnp.int32),
        jnp.full(N, L - 1, jnp.int32), jnp.asarray(fin), Dmax=Dmax)
    assert np.array_equal(np.asarray(idx_d), plan.idx)
    assert np.array_equal(np.asarray(seqk_d), plan.seqk)
    assert np.array_equal(np.asarray(D_d), plan.D)
    np.testing.assert_allclose(np.asarray(pfac_d), plan.pfac, rtol=2e-5,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(nxt_d), plan.nxt, rtol=1e-5,
                               atol=1e-6)
