"""Pallas kernels (Triton route) for the Li & Stephens painting sweeps.

Semantics twin of the ``lax.scan`` kernels in ``core/painting.py``
(behavioral reference ``include/src/fast_painting.cpp``). The scan advances
the whole (B, N) target x source state one derived-site step per while-loop
iteration, gathers a panel row per target per step and writes the state
back to device memory every step. Here each target haplotype is one
program: its (N,) alpha or beta row, logscale and Kahan term stay in
registers for the whole sweep, the panel row of each step is loaded
directly (the mismatch indicator is computed in-kernel, never
materialized), and only the output rows are written.

Layout: every array is target-major, matching the public ``(Dmax, B, N)``
posterior, so no transposes are needed. Plan arrays are ``(B, Dmax)`` (step
j of target b at ``[b, j]``); state rows are ``(B, N)``. The source axis is
held as one power-of-two block of Np >= N lanes with masked loads and
stores; lanes past N and the target's own column are zero (``kmask``).

- forward rows j >= D[b] repeat the last valid row (as the scan twin);
  backward/posterior rows j >= D[b] are ZERO (consumers never read them).
- logscales accumulate with Kahan compensation (the reference carries them
  in double; plain f32 accumulation drifts ~1e-2 over ~5k steps).
- the backward transition into row j reads interval j+1 and the posterior
  row keeps the PRE-rescale beta: the reference's quirks, as in the scan.
- capture variants (the stepping-stone passes) emit only the row
  ``want[b]`` of each target instead of the (Dmax, B, N) stream.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

LOWER_RESCALE = np.float32(1e-10)
UPPER_RESCALE = np.float32(1e10)


def pow2_lanes(n: int) -> int:
    """Power-of-two register block covering n sources (Triton blocks are
    powers of two; lanes >= n are masked)."""
    return max(16, 1 << (int(n) - 1).bit_length())


def _num_warps(Np: int) -> int:
    return max(1, min(8, Np // 256))


def _row_tools(b, n, Np, G_ref, idx_ref, seqk_ref, tgt_ref):
    lane = jax.lax.broadcasted_iota(jnp.int32, (Np,), 0)
    inb = lane < n
    kmask = jnp.where(inb & (lane != tgt_ref[b]), np.float32(1.0),
                      np.float32(0.0))

    def mism(j):
        """Target allele derived where the source is ancestral."""
        g = plgpu.load(G_ref.at[idx_ref[b, j], pl.ds(0, Np)], mask=inb,
                       other=0)
        return seqk_ref[b, j].astype(jnp.int32) > g.astype(jnp.int32)

    def load(ref, *idx):
        return plgpu.load(ref.at[idx + (pl.ds(0, Np),)], mask=inb,
                          other=0.0)

    def store(ref, v, *idx):
        plgpu.store(ref.at[idx + (pl.ds(0, Np),)], v, mask=inb)

    return kmask, mism, load, store


def _rescale(v, s):
    """Dynamic rescale into [1e-10, 1e10]: (v', log correction, s_eff)."""
    cond = (s < LOWER_RESCALE) | (s > UPPER_RESCALE)
    safe = jnp.where(s > 0, s, np.float32(1.0))
    return (jnp.where(cond, v / safe, v),
            jnp.where(cond, jnp.log(safe), np.float32(0.0)),
            jnp.where(cond, np.float32(1.0), s))


def _fwd_kernel(G_ref, idx_ref, seqk_ref, pfac_ref, nxt_ref, D_ref, tgt_ref,
                *rest, theta, n, Np, Dmax, capture):
    """Forward sweep of one target (fast_painting.cpp:264-378):
    alpha' = (alpha + pfac[j-1]*sum(alpha)) * (1 + theta_ratio*mismatch)."""
    if capture:
        want_ref, a0_ref, acap_ref, lscap_ref = rest
    else:
        a0_ref, al_ref, ls_ref = rest
    b = pl.program_id(0)
    kmask, mism, load, store = _row_tools(b, n, Np, G_ref, idx_ref,
                                          seqk_ref, tgt_ref)
    theta_ratio = np.float32(theta / (1.0 - theta) - 1.0)
    want = want_ref[b] if capture else None

    def emit(j, alpha, ls):
        if capture:
            @pl.when(j == want)
            def _():
                store(acap_ref, alpha, b)
                lscap_ref[b] = ls
        else:
            store(al_ref, alpha, j, b)
            ls_ref[j, b] = ls

    alpha0 = load(a0_ref, b) * kmask
    zero = jnp.float32(0.0)
    emit(jnp.int32(0), alpha0, zero)

    def step(j, c):
        alpha, ls, comp, asum_eff = c
        em = np.float32(1.0) + theta_ratio * mism(j).astype(jnp.float32)
        rx = asum_eff * pfac_ref[b, j - 1]
        alpha = (alpha + rx) * em * kmask
        alpha, logcorr, asum_eff = _rescale(alpha, jnp.sum(alpha))
        y = (nxt_ref[b, j - 1] + logcorr) - comp
        t = ls + y
        comp = (t - ls) - y
        emit(j, alpha, t)
        return alpha, t, comp, asum_eff

    alpha, ls, _, _ = jax.lax.fori_loop(
        1, D_ref[b], step, (alpha0, zero, zero, jnp.sum(alpha0)))
    if not capture:
        def hold(j, c):
            emit(j, alpha, ls)
            return c
        jax.lax.fori_loop(D_ref[b], Dmax, hold, 0)


def _bwd_kernel(G_ref, idx_ref, seqk_ref, pfac_ref, nxt_ref, D_ref, tgt_ref,
                *rest, theta, n, Np, Dmax, capture):
    """Backward sweep of one target fused with the posterior
    (fast_painting.cpp:396-470, 950-1092), rows D-1 down to 0."""
    if capture:
        want_ref, be_ref, bcap_ref, lscap_ref = rest
    else:
        be_ref, al_ref, lsf_ref, topo_ref, lstot_ref = rest
    b = pl.program_id(0)
    kmask, mism, load, store = _row_tools(b, n, Np, G_ref, idx_ref,
                                          seqk_ref, tgt_ref)
    th = np.float32(theta)
    nth = np.float32(1.0 - theta)
    theta_ratio = np.float32(theta / (1.0 - theta) - 1.0)
    want = want_ref[b] if capture else None
    D = D_ref[b]

    def emit(j, beta_pre, beta_post, pls):
        if capture:
            @pl.when(j == want)
            def _():
                store(bcap_ref, beta_post, b)
                lscap_ref[b] = pls
        else:
            # posterior row: alpha * PRE-rescale beta, as the reference
            store(topo_ref, load(al_ref, j, b) * beta_pre, j, b)
            lstot_ref[j, b] = lsf_ref[j, b] + pls

    beta0 = load(be_ref, b) * kmask
    m0 = mism(D - 1)
    zero = jnp.float32(0.0)
    emit(D - 1, beta0, beta0, zero)

    def step(u, c):
        beta, pls, comp, bsum_eff, m_next = c
        j = D - 2 - u
        dnext = m_next.astype(jnp.float32)
        rx = bsum_eff * pfac_ref[b, j + 1]
        b1 = rx / nth
        bt = rx / th - b1
        beta_new = ((beta + dnext * bt + b1)
                    * (np.float32(1.0) + theta_ratio * dnext) * kmask)
        m_j = mism(j)
        bsum = jnp.sum(jnp.where(m_j, th, nth) * beta_new)
        beta_fin, logcorr, bsum_eff = _rescale(beta_new, bsum)
        y = (nxt_ref[b, j + 1] + logcorr) - comp
        p = pls + y
        comp = (p - pls) - y
        emit(j, beta_new, beta_fin, p)
        return beta_fin, p, comp, bsum_eff, m_j

    bsum0 = jnp.sum(jnp.where(m0, th, nth) * beta0)
    jax.lax.fori_loop(0, D - 1, step, (beta0, zero, zero, bsum0, m0))
    if not capture:
        zrow = jnp.zeros_like(beta0)

        def clear(j, c):
            store(topo_ref, zrow, j, b)
            lstot_ref[j, b] = zero
            return c
        jax.lax.fori_loop(D, Dmax, clear, 0)


def _call(body, args, out_shape, *, theta, n, Dmax, capture, name,
          interpret, aliases=None):
    B = args[1].shape[0]
    Np = pow2_lanes(n)
    return pl.pallas_call(
        functools.partial(body, theta=theta, n=n, Np=Np, Dmax=Dmax,
                          capture=capture),
        out_shape=out_shape,
        grid=(B,),
        input_output_aliases=aliases or {},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(Np),
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(*args)


def _shapes(idx, n):
    B, Dmax = idx.shape
    return (jax.ShapeDtypeStruct((Dmax, B, n), jnp.float32),
            jax.ShapeDtypeStruct((Dmax, B), jnp.float32))


@functools.partial(jax.jit, static_argnames=("theta", "interpret"))
def paint_fwd(G, idx, seqk, pfac, nxt, D, tgt, alpha0, *, theta,
              interpret=False):
    """Forward sweep. G (L, N) u8 panel; idx/seqk/pfac/nxt (B, Dmax) plan
    (idx rows into G); D, tgt (B,) i32; alpha0 (B, N) f32.
    Returns alphas (Dmax, B, N) f32 (post-rescale rows), lss (Dmax, B)."""
    n = alpha0.shape[1]
    return _call(_fwd_kernel,
                 (G, idx, seqk, pfac, nxt, D, tgt, alpha0), _shapes(idx, n),
                 theta=theta, n=n, Dmax=idx.shape[1], capture=False,
                 name="paint_fwd", interpret=interpret)


@functools.partial(jax.jit, static_argnames=("theta", "interpret"))
def paint_bwd(G, idx, seqk, pfac, nxt, D, tgt, beta_end, alphas, lsf, *,
              theta, interpret=False):
    """Backward + posterior sweep over the forward outputs. Returns topo
    (Dmax, B, N) f32 (zeros on rows >= D[b]), lstot (Dmax, B). The
    posterior is written over the alphas buffer (each row is read before
    it is overwritten)."""
    n = beta_end.shape[1]
    return _call(_bwd_kernel,
                 (G, idx, seqk, pfac, nxt, D, tgt, beta_end, alphas, lsf),
                 _shapes(idx, n), theta=theta, n=n, Dmax=idx.shape[1],
                 capture=False, name="paint_bwd", interpret=interpret,
                 aliases={8: 0})


@functools.partial(jax.jit, static_argnames=("theta", "interpret"))
def paint_posterior(G, idx, seqk, pfac, nxt, D, tgt, alpha0, beta_end, *,
                    theta, interpret=False):
    """RePaintSection: forward then backward+posterior in one program, so
    the posterior reuses the forward rows' buffer."""
    alphas, lsf = paint_fwd(G, idx, seqk, pfac, nxt, D, tgt, alpha0,
                            theta=theta, interpret=interpret)
    return paint_bwd(G, idx, seqk, pfac, nxt, D, tgt, beta_end, alphas, lsf,
                     theta=theta, interpret=interpret)


def _cap_shapes(idx, n):
    B = idx.shape[0]
    return (jax.ShapeDtypeStruct((B, n), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.float32))


@functools.partial(jax.jit, static_argnames=("theta", "interpret"))
def paint_fwd_capture(G, idx, seqk, pfac, nxt, D, tgt, want, alpha0, *,
                      theta, interpret=False):
    """Forward sweep keeping only row ``want[b]`` of each target:
    (acap (B, N) f32, lscap (B,) f32)."""
    n = alpha0.shape[1]
    return _call(_fwd_kernel,
                 (G, idx, seqk, pfac, nxt, D, tgt, want, alpha0),
                 _cap_shapes(idx, n), theta=theta, n=n, Dmax=idx.shape[1],
                 capture=True, name="paint_fwd_capture", interpret=interpret)


@functools.partial(jax.jit, static_argnames=("theta", "interpret"))
def paint_bwd_capture(G, idx, seqk, pfac, nxt, D, tgt, want, beta_end, *,
                      theta, interpret=False):
    """Backward sweep keeping the POST-rescale beta row ``want[b]`` and the
    backward-only logscale there (the stepping-stone checkpoint,
    fast_painting.cpp:587-601). Needs no forward outputs."""
    n = beta_end.shape[1]
    return _call(_bwd_kernel,
                 (G, idx, seqk, pfac, nxt, D, tgt, want, beta_end),
                 _cap_shapes(idx, n), theta=theta, n=n, Dmax=idx.shape[1],
                 capture=True, name="paint_bwd_capture", interpret=interpret)
