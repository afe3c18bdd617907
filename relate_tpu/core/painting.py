"""Li & Stephens chromosome-painting HMM on the device.

Behavioral reference: ``include/src/fast_painting.cpp`` (PaintSteppingStones
:17-618, RePaintSection :620-1092). This is a from-scratch JAX design, not a
port: the per-haplotype sequential C++ loops become a single batched
``lax.scan`` over *derived-site steps*, with all target haplotypes advanced in
lockstep and emission rows gathered from a device-resident genotype panel.

Model recap (per target haplotype k):
- The chain runs only over k's *derived* sites (plus the first and last SNP of
  the range); recombination over skipped sites is folded into one transition
  with probability ``p_j = 1 - exp(-sum r)`` capped at 0.99
  (fast_painting.cpp:118-121).
- Emission at a derived step multiplies sources that do NOT carry the derived
  allele by ``theta/(1-theta)``; the common ``(1-theta)`` factor per step is
  absorbed into a running logscale (the ``nor_x_theta`` trick,
  fast_painting.cpp:112-121,291).
- alpha/beta are dynamically rescaled into [1e-10, 1e10]
  (fast_painting.hpp:28-29).
- Quirks replicated for parity: the backward transition into step j uses the
  interval factor of step j+1 (the reference decrements its r-prob iterator
  *after* using it, fast_painting.cpp:553-556,1063-1066), and a posterior row
  at which a backward rescale triggers stores the pre-rescale beta while its
  logscale includes the rescale correction (fast_painting.cpp:1033-1061);
  both cancel in the row-min-normalized distance matrix.

Memory model: the full posterior for one window is materialized at once —
windows are sized upstream so that ``sum_k D_k * (N+1)`` floats fit the budget
(same model as data.cpp:219-229), so this tensor is bounded by device memory
by design.

Two implementations share these semantics: the ``lax.scan`` twins below
(any backend; the CPU tests' reference) and the Pallas kernels of
``ops/paint_kernels.py`` (the GPU path), which the device planner
(:func:`make_device_planner`) feeds.
Stepping-stone checkpoints between windows are the scan-level analog of
activation checkpointing / remat.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LOWER_RESCALE = 1e-10
UPPER_RESCALE = 1e10
P_CAP = 0.99


@dataclass(frozen=True)
class PaintingModel:
    """Scalar painting parameters (data.cpp:81, fast_painting.hpp:26-39)."""
    N: int
    theta: float = 0.001

    @property
    def ntheta(self) -> float:
        return 1.0 - self.theta

    @property
    def theta_ratio(self) -> float:
        # emission trick multiplier: em = 1 + theta_ratio * mismatch
        return self.theta / (1.0 - self.theta) - 1.0

    @property
    def prior_theta(self) -> float:
        return self.theta / (self.N - 1.0) - self.ntheta / (self.N - 1.0)

    @property
    def prior_ntheta(self) -> float:
        return self.ntheta / (self.N - 1.0)

    @property
    def log_ntheta(self) -> float:
        return float(np.log(self.ntheta))


class TargetPlan(NamedTuple):
    """Host-precomputed, padded per-target derived-site step arrays.

    ``idx[b, j]`` is the absolute SNP index (into the chunk) of target b's
    j-th step; padded steps repeat the final site and have zero transition.
    """
    targets: np.ndarray       # (B,) target haplotype ids
    idx: np.ndarray           # (B, Dmax) int32 site index per step
    seqk: np.ndarray          # (B, Dmax) uint8 target allele at that site
    pfac: np.ndarray          # (B, Dmax) f32 p/((1-p)(N-1)) per interval
    nxt: np.ndarray           # (B, Dmax) f32 -raw + log(1-theta) per interval
    D: np.ndarray             # (B,) int32 true number of steps
    kmask: np.ndarray         # (B, N) f32: 0.0 at target's own column else 1.0

    @property
    def Dmax(self) -> int:
        return self.idx.shape[1]


def build_target_plan(G: np.ndarray, r: np.ndarray, model: PaintingModel,
                      first_arr, last_arr,
                      targets: Optional[np.ndarray] = None,
                      final_raw: Optional[np.ndarray] = None) -> TargetPlan:
    """Vectorized host precompute of derived-site steps, replicating
    fast_painting.cpp:640-716. ``first_arr``/``last_arr`` may be scalars or
    per-target arrays (stepping-stone boundaries differ per target).

    Derived steps of target k = {first} u {l in (first,last): G[l,k]=1} u
    {last}. Interval j accumulates r over [idx_j, idx_{j+1}); the final
    interval is r[last] alone.
    """
    L, N = G.shape
    if targets is None:
        targets = np.arange(N, dtype=np.int32)
    targets = np.asarray(targets, dtype=np.int32)
    B = len(targets)
    first_arr = np.broadcast_to(np.asarray(first_arr, dtype=np.int64), (B,))
    last_arr = np.broadcast_to(np.asarray(last_arr, dtype=np.int64), (B,))

    S = np.zeros(L + 1, dtype=np.float64)
    np.cumsum(r, out=S[1:])

    # Vectorized ragged derived-site extraction (no per-target Python loop):
    # one nonzero over the masked (B, L) panel slice, scattered into a padded
    # (B, Dmax) index matrix via per-row ranks.
    pos = np.arange(L, dtype=np.int64)[None, :]
    inner_mask = ((G.T[targets] != 0)
                  & (pos > first_arr[:, None]) & (pos < last_arr[:, None]))
    rows, cols = np.nonzero(inner_mask)
    counts = np.bincount(rows, minlength=B).astype(np.int64)
    starts = np.zeros(B, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    D = (counts + 2).astype(np.int32)
    Dmax = int(D.max())
    idx = np.broadcast_to(last_arr[:, None], (B, Dmax)).copy()
    idx[:, 0] = first_arr
    if len(rows):
        rank = np.arange(len(rows), dtype=np.int64) - starts[rows]
        idx[rows, rank + 1] = cols

    col = np.arange(Dmax, dtype=np.int64)[None, :]
    bidx = np.arange(B)[:, None]
    nxt_pos = np.minimum(col + 1, D[:, None].astype(np.int64) - 1)
    raw = S[idx[bidx, nxt_pos]] - S[idx]
    # interval past the range end: r[last] alone for a plain repaint
    # (the reference's "technicality", fast_painting.cpp:711-712), or an
    # explicit override (checkpoint chaining extends it to the next
    # derived site beyond the window, matching the full-pass intervals).
    fin = (r[last_arr] if final_raw is None
           else np.asarray(final_raw, dtype=np.float64))
    raw = np.where(col == D[:, None] - 1, fin[:, None], raw)
    raw = np.where(col >= D[:, None], 0.0, raw)

    p = 1.0 - np.exp(-raw)
    capped = p > P_CAP
    p = np.where(capped, P_CAP, p)
    nxt = np.where(capped, np.log(0.01) + model.log_ntheta,
                   -raw + model.log_ntheta)
    pfac = p / ((1.0 - p) * (model.N - 1.0))
    pad = np.arange(Dmax)[None, :] >= D[:, None]
    pfac = np.where(pad, 0.0, pfac)
    nxt = np.where(pad, 0.0, nxt)

    seqk = G[idx, targets[:, None]].astype(np.uint8)
    kmask = np.ones((B, N), dtype=np.float32)
    kmask[np.arange(B), targets] = 0.0
    return TargetPlan(targets=targets, idx=idx.astype(np.int32), seqk=seqk,
                      pfac=pfac.astype(np.float32), nxt=nxt.astype(np.float32),
                      D=D, kmask=kmask)


def initial_alpha(G: np.ndarray, model: PaintingModel, first: int,
                  targets: np.ndarray) -> np.ndarray:
    """Prior-times-emission alpha at the first chromosome site
    (fast_painting.cpp:205-230)."""
    row = G[first]
    seqk = G[first, targets]
    derived = (seqk[:, None] > row[None, :]).astype(np.float32)
    alpha0 = derived * model.prior_theta + model.prior_ntheta
    alpha0[np.arange(len(targets)), targets] = 0.0
    return alpha0.astype(np.float32)


def normalizing_constant(model: PaintingModel, num_steps) -> np.ndarray:
    """log(N-1) - D*log(1-theta) (fast_painting.cpp:399), per target."""
    return np.asarray(np.log(model.N - 1.0)
                      - np.asarray(num_steps) * model.log_ntheta,
                      dtype=np.float32)


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------

def _rescale(vec, s):
    """Dynamic rescale into [1e-10, 1e10]; returns (vec', logcorr, s_eff)."""
    cond = (s < LOWER_RESCALE) | (s > UPPER_RESCALE)
    safe = jnp.where(s > 0, s, 1.0)
    vec2 = jnp.where(cond[:, None], vec / safe[:, None], vec)
    logcorr = jnp.where(cond, jnp.log(safe), 0.0)
    s_eff = jnp.where(cond, 1.0, s)
    return vec2, logcorr, s_eff


def make_painting_kernels(model: PaintingModel):
    """Jitted forward / backward+posterior scan kernels for this model.

    Scalars are closed over as compile-time constants; the jit cache is keyed
    by shapes only.
    """
    theta = jnp.float32(model.theta)
    ntheta = jnp.float32(model.ntheta)
    theta_ratio = jnp.float32(model.theta_ratio)

    def fwd(G, idx, seqk, pfac, nxt, D, kmask, alpha0):
        """Forward pass from a checkpoint alpha row.

        Emitted logscales are *relative* to the checkpoint's logscale: the
        large absolute base is chained in float64 on the host
        (fast_painting.cpp accumulates prev_logscale in double; carrying a
        small relative value keeps float32 accurate on the device).
        Returns (alphas (Dmax,B,N), ls_rel (Dmax,B))."""
        B, Dmax = idx.shape
        ls0 = jnp.zeros((B,), jnp.float32)
        alpha0 = alpha0 * kmask
        asum0 = alpha0.sum(axis=1)
        step_valid = (jnp.arange(1, Dmax)[:, None] < D[None, :])

        def step(carry, xs):
            alpha, ls, asum_eff = carry
            t_idx, t_seqk, t_pfac_prev, t_nxt_prev, t_valid = xs
            rx = asum_eff * t_pfac_prev
            grow = G[t_idx]                                   # (B, N) gather
            mism = (t_seqk[:, None] > grow).astype(jnp.float32)
            em = 1.0 + theta_ratio * mism
            alpha_new = (alpha + rx[:, None]) * em * kmask
            ls_new = ls + t_nxt_prev
            asum = alpha_new.sum(axis=1)
            alpha_new, logcorr, asum_eff_new = _rescale(alpha_new, asum)
            ls_new = ls_new + logcorr
            v = t_valid
            alpha_new = jnp.where(v[:, None], alpha_new, alpha)
            ls_new = jnp.where(v, ls_new, ls)
            asum_eff_new = jnp.where(v, asum_eff_new, asum_eff)
            return (alpha_new, ls_new, asum_eff_new), (alpha_new, ls_new)

        xs = (idx[:, 1:].T, seqk[:, 1:].T, pfac[:, :-1].T, nxt[:, :-1].T,
              step_valid)
        _, (alphas, lss) = jax.lax.scan(step, (alpha0, ls0, asum0), xs)
        alphas = jnp.concatenate([alpha0[None], alphas], axis=0)
        lss = jnp.concatenate([ls0[None], lss], axis=0)
        return alphas, lss

    def bwd(G, ridx, rseqk, rpfac_next, rnxt, D, kmask,
            arev, lsf_rev, beta_end):
        """Backward pass in reversed step order (u=0 is step j=D-1), fused
        with the posterior computation.

        Returns (topo_rev (Dmax,B,N), lstot_rev (Dmax,B),
                 beta_rev (Dmax,B,N), lsb_rev (Dmax,B)) where beta rows are
        post-rescale and lsb is the backward-only logscale (for checkpoint
        extraction), while topo rows keep the reference's pre-rescale quirk.
        """
        B, Dmax = ridx.shape
        ls_beta = jnp.zeros((ridx.shape[0],), jnp.float32)
        beta0 = beta_end * kmask
        grow0 = G[ridx[:, 0]]
        w0 = jnp.where(rseqk[:, 0][:, None] > grow0, theta, ntheta)
        bsum0 = (w0 * beta0).sum(axis=1)
        topo0 = arev[0] * beta0
        lstot0 = lsf_rev[0] + ls_beta
        step_valid = (jnp.arange(1, Dmax)[:, None] < D[None, :])

        def step(carry, xs):
            beta, prev_ls, bsum_eff = carry
            (u_idx, u_seqk, u_pfac_next, u_nxt, u_valid,
             prev_idx, prev_seqk, a_row, lsf_row) = xs
            rx = bsum_eff * u_pfac_next
            grow_next = G[prev_idx]
            dnext = (prev_seqk[:, None] > grow_next).astype(jnp.float32)
            b1 = rx / ntheta
            bt = rx / theta - b1
            em_next = 1.0 + theta_ratio * dnext
            beta_new = (beta + dnext * bt[:, None] + b1[:, None]) * em_next
            beta_new = beta_new * kmask
            prev_ls_new = prev_ls + u_nxt
            ls_row = lsf_row + prev_ls_new
            grow = G[u_idx]
            w = jnp.where(u_seqk[:, None] > grow, theta, ntheta)
            bsum = (w * beta_new).sum(axis=1)
            topo = a_row * beta_new      # pre-rescale, as in the reference
            beta_new, logcorr, bsum_eff_new = _rescale(beta_new, bsum)
            prev_ls_new = prev_ls_new + logcorr
            ls_row = ls_row + logcorr    # reference adds the correction here
            v = u_valid
            beta_new = jnp.where(v[:, None], beta_new, beta)
            prev_ls_new = jnp.where(v, prev_ls_new, prev_ls)
            bsum_eff_new = jnp.where(v, bsum_eff_new, bsum_eff)
            return ((beta_new, prev_ls_new, bsum_eff_new),
                    (topo, ls_row, beta_new, prev_ls_new))

        xs = (ridx[:, 1:].T, rseqk[:, 1:].T, rpfac_next[:, 1:].T,
              rnxt[:, 1:].T, step_valid,
              ridx[:, :-1].T, rseqk[:, :-1].T, arev[1:], lsf_rev[1:])
        _, (topos, lss, betas, lsbs) = jax.lax.scan(
            step, (beta0, ls_beta, bsum0), xs)
        topo_rev = jnp.concatenate([topo0[None], topos], axis=0)
        lstot_rev = jnp.concatenate([lstot0[None], lss], axis=0)
        beta_rev = jnp.concatenate([beta0[None], betas], axis=0)
        lsb_rev = jnp.concatenate([ls_beta[None], lsbs], axis=0)
        return topo_rev, lstot_rev, beta_rev, lsb_rev

    def bwd_full(G, idx, seqk, pfac, nxt, D, kmask, a_all, lsf, beta_end):
        """Backward pass + posterior with all step reversals computed on
        device (one upload of the forward plan serves both passes)."""
        B, Dmax = idx.shape
        u = jnp.arange(Dmax)[None, :]
        j = D[:, None] - 1 - u
        jc = jnp.clip(j, 0, Dmax - 1)
        ridx = jnp.take_along_axis(idx, jc, axis=1)
        rseqk = jnp.take_along_axis(seqk, jc, axis=1)
        jp1 = jnp.clip(j + 1, 0, Dmax - 1)
        # the reference reads both the transition factor and the logscale
        # increment from interval j+1 (fast_painting.cpp:960-963,1063-1070)
        rnxt = jnp.take_along_axis(nxt, jp1, axis=1)
        rpfac_next = jnp.take_along_axis(pfac, jp1, axis=1)
        rg = jc.T                                        # (Dmax, B)
        arev = jnp.take_along_axis(a_all, rg[:, :, None], axis=0)
        lsf_rev = jnp.take_along_axis(lsf, rg, axis=0)
        topo_rev, lstot_rev, beta_rev, lsb_rev = bwd(
            G, ridx, rseqk, rpfac_next, rnxt, D, kmask,
            arev, lsf_rev, beta_end)
        topo = jnp.take_along_axis(topo_rev, rg[:, :, None], axis=0)
        lstot = jnp.take_along_axis(lstot_rev, rg, axis=0)
        beta = jnp.take_along_axis(beta_rev, rg[:, :, None], axis=0)
        lsb = jnp.take_along_axis(lsb_rev, rg, axis=0)
        return topo, lstot, beta, lsb

    return jax.jit(fwd), jax.jit(bwd), jax.jit(bwd_full)


def make_device_planner(model: PaintingModel):
    """Jitted device-side twin of :func:`build_target_plan` feeding the
    painting kernels (``ops/paint_kernels.py``).

    Returns the plan arrays in target-major ``(B, Dmax)`` layout. The ragged
    derived-site lists are compacted with one masked sort instead of host
    loops. ``S_hi``/``S_lo`` must be the recombination-distance prefix sum
    REBASED near the window, split into two floats (float32 keeps ~1e-7 of
    the in-window span, vs catastrophic cancellation on whole-chromosome
    magnitudes). Step indices are relative to the panel rows passed in.
    """
    log_ntheta = model.log_ntheta
    Nm1 = model.N - 1.0

    @functools.partial(jax.jit, static_argnames=("Dmax",))
    def prep(GT, S_hi, S_lo, targets, first, last, fin, Dmax):
        L = GT.shape[1]
        B = targets.shape[0]
        GTt = jnp.take(GT, targets, axis=0)                   # (B, L) rows
        pos = jnp.arange(L, dtype=jnp.int32)[None, :]
        first_c = first[:, None].astype(jnp.int32)
        last_c = last[:, None].astype(jnp.int32)
        mask = (GTt != 0) & (pos > first_c) & (pos < last_c)
        counts = jnp.sum(mask, axis=1, dtype=jnp.int32)[:, None]
        D = counts + 2                                        # (B, 1)
        # one multi-operand sort compacts the ragged derived positions AND
        # carries the recombination prefix-sum values along, so no large
        # element gathers are needed afterwards
        keys = jnp.where(mask, pos, jnp.int32(L))
        shv = jnp.broadcast_to(S_hi[None, :L], (B, L))
        slv = jnp.broadcast_to(S_lo[None, :L], (B, L))
        skeys, sh_s, sl_s = jax.lax.sort((keys, shv, slv), dimension=1,
                                         num_keys=1)
        if L < Dmax - 1:
            # Dmax buckets can exceed short windows (tests, chunk tails):
            # extend the compacted arrays with padding columns
            padw = Dmax - 1 - L
            skeys = jnp.concatenate(
                [skeys, jnp.full((B, padw), jnp.int32(L))], axis=1)
            sh_s = jnp.concatenate([sh_s, sh_s[:, -1:].repeat(padw, 1)],
                                   axis=1)
            sl_s = jnp.concatenate([sl_s, sl_s[:, -1:].repeat(padw, 1)],
                                   axis=1)
        col = jnp.arange(Dmax, dtype=jnp.int32)[None, :]
        inner_sel = col <= counts
        idx = jnp.concatenate([first_c, skeys[:, :Dmax - 1]], axis=1)
        idx = jnp.where(col == 0, first_c,
                        jnp.where(inner_sel, idx, last_c))
        # boundary S values: tiny (B,) gathers
        sh_first = S_hi[first][:, None]
        sl_first = S_lo[first][:, None]
        sh_last = S_hi[last][:, None]
        sl_last = S_lo[last][:, None]
        sh = jnp.concatenate([sh_first, sh_s[:, :Dmax - 1]], axis=1)
        sh = jnp.where(col == 0, sh_first, jnp.where(inner_sel, sh, sh_last))
        sl = jnp.concatenate([sl_first, sl_s[:, :Dmax - 1]], axis=1)
        sl = jnp.where(col == 0, sl_first, jnp.where(inner_sel, sl, sl_last))
        # interval ends: step j+1's S, a shift (idx rows are left-compacted)
        sh_next = jnp.concatenate([sh[:, 1:], sh_last], axis=1)
        sl_next = jnp.concatenate([sl[:, 1:], sl_last], axis=1)
        # two-float prefix-sum difference: the hi terms are exact f32 values
        # so their difference rounds at the magnitude of the (small) interval,
        # not of the whole-chromosome prefix sum; the lo terms restore the
        # f64 residual. Error ~ eps*raw instead of eps*S.
        raw = jnp.where(col < D - 1,
                        (sh_next - sh) + (sl_next - sl), 0.0)
        raw = jnp.where(col == D - 1, fin[:, None], raw)
        # target allele per step, gather-free: inner steps are derived by
        # construction; only the first/last boundary steps read the panel
        gfirst = jnp.take_along_axis(GTt, first_c, axis=1)
        glast = jnp.take_along_axis(GTt, last_c, axis=1)
        seqk = jnp.where(col == 0, gfirst,
                         jnp.where(inner_sel, jnp.uint8(1), glast))
        p = -jnp.expm1(-raw)   # full f32 relative precision for small raw
        capped = p > P_CAP
        p = jnp.where(capped, np.float32(P_CAP), p)
        nxtv = jnp.where(capped, np.float32(np.log(0.01) + log_ntheta),
                         -raw + np.float32(log_ntheta))
        pfac = p / ((1.0 - p) * np.float32(Nm1))
        padm = col >= D
        pfac = jnp.where(padm, 0.0, pfac).astype(jnp.float32)
        nxtv = jnp.where(padm, 0.0, nxtv).astype(jnp.float32)
        return idx, seqk.astype(jnp.uint8), D[:, 0], pfac, nxtv

    return prep


def _reverse_plan(plan: TargetPlan):
    """Host: reversed step arrays for the backward scan.

    Returns (ridx, rseqk, rpfac_next, rnxt, rev_gather) where rev_gather[b,u]
    = clip(D_b-1-u, 0) maps reversed step u to forward step j (also used to
    un-reverse output tensors, padding rows land on row 0 harmlessly).
    """
    B, Dmax = plan.idx.shape
    u = np.arange(Dmax)[None, :]
    j = plan.D[:, None] - 1 - u
    jc = np.clip(j, 0, Dmax - 1)
    bidx = np.arange(B)[:, None]
    ridx = plan.idx[bidx, jc]
    rseqk = plan.seqk[bidx, jc]
    jp1 = np.clip(j + 1, 0, Dmax - 1)
    # The reference's backward loop reads BOTH its transition factor and its
    # logscale increment from interval j+1 before decrementing the iterator
    # (fast_painting.cpp:960-963,1063-1070): replicate the pairing exactly —
    # using nxt[j] here would break the scaled-beta/logscale invariant.
    rnxt = plan.nxt[bidx, jp1]
    rpfac_next = plan.pfac[bidx, jp1]
    return ridx, rseqk, rpfac_next, rnxt, jc


class PaintOutput(NamedTuple):
    """Posterior for a set of targets over one window.

    ``topology[j, b, :]`` is alpha*beta at target b's j-th step (rows past
    D[b] are padding). The total logscale of row (j, b) is
    ``logscale[j, b] + ls_base[b]``: the in-window part is float32 (small
    magnitude), the cross-window base float64 (host-chained). Distance
    assembly only ever needs in-row logscale *differences*, so the base
    cancels there.
    """
    topology: np.ndarray   # (Dmax, B, N) — device or host array
    logscale: np.ndarray   # (Dmax, B) float32, relative to ls_base
    ls_base: np.ndarray    # (B,) float64
    plan: TargetPlan


class Checkpoint:
    """Stepping-stone boundary state for one window, all targets
    (the analog of one ``paint/relate_<w>.bin`` record set).

    ``alpha``/``beta`` are (B, N) host arrays, materialized lazily: the
    kernel stones keep the (B, N) slabs ON DEVICE (``a0_dev``/``be_dev``,
    rows possibly padded for a mesh) and feed them to the repaint without a
    host round trip. Host copies are produced only when actually read
    (artifact writes, host scan path).
    """

    __slots__ = ("_alpha", "ls_alpha", "bsb", "_beta", "ls_beta", "bse",
                 "a0_dev", "be_dev", "_n")

    def __init__(self, alpha=None, ls_alpha=None, bsb=None, beta=None,
                 ls_beta=None, bse=None, a0_dev=None, be_dev=None, n=None):
        self._alpha = alpha
        self.ls_alpha = ls_alpha
        self.bsb = bsb
        self._beta = beta
        self.ls_beta = ls_beta
        self.bse = bse
        self.a0_dev = a0_dev          # (Bp, N) f32 device slab
        self.be_dev = be_dev
        self._n = n

    @property
    def alpha(self):
        if self._alpha is None:
            self._alpha = np.asarray(self.a0_dev)[:self._n]
        return self._alpha

    @property
    def beta(self):
        if self._beta is None:
            self._beta = np.asarray(self.be_dev)[:self._n]
        return self._beta


# step-count and window-span buckets of the kernel path: every window of a
# chunk shares a few compilations
DMAX_BUCKET = 32
SPAN_BUCKET = 512


class Painter:
    """Painting driver for one chunk: holds the genotype panel on device,
    computes stepping-stone checkpoints per window and full posteriors."""

    def __init__(self, G: np.ndarray, r: np.ndarray, model: PaintingModel,
                 mesh=None, mesh_axis: str = "shard",
                 use_kernel: Optional[bool] = None, interpret: bool = False):
        """``mesh``: optional jax.sharding.Mesh — the painting target axis
        is sharded over it (each device paints its target shard against the
        replicated panel).

        ``use_kernel``: run the Pallas painting kernels
        (``ops/paint_kernels.py``); by default exactly when the backend is
        a GPU. ``interpret`` runs those kernels in Pallas interpret mode
        (tests on the CPU)."""
        self.G_host = np.asarray(G, dtype=np.uint8)
        self.mesh = mesh
        self._mesh_axis = mesh_axis
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            self._repl = NamedSharding(mesh, P())
            self._row = NamedSharding(mesh, P(mesh_axis))
            self._ndev = int(mesh.devices.size)
            self.G = jax.device_put(jnp.asarray(self.G_host), self._repl)
        else:
            self._ndev = 1
            self.G = jnp.asarray(self.G_host)
        self.r = np.asarray(r, dtype=np.float64)
        self.model = model
        self.use_kernel = (jax.default_backend() == "gpu"
                           if use_kernel is None else bool(use_kernel))
        self.interpret = interpret
        self._fwd, self._bwd, self._bwd_full = make_painting_kernels(model)
        self.L, self.N = G.shape
        self._extract = jax.jit(
            lambda arr, rows: arr[rows, jnp.arange(arr.shape[1])])
        self._csr = None
        self._planner = None
        self._cumG = None
        self._S = None
        self._GT = None
        self._kfns = None

    # -- kernel path -------------------------------------------------------
    def _kernel_fns(self):
        """(posterior, fwd_capture, bwd_capture) kernel callables. With a
        mesh, each is ``shard_map``ped over the target (leading) axis —
        every device runs the kernels on its own target shard against its
        replica of the panel."""
        if self._kfns is not None:
            return self._kfns
        from functools import partial

        from ..ops import paint_kernels
        kw = dict(theta=float(self.model.theta), interpret=self.interpret)
        fns = (partial(paint_kernels.paint_posterior, **kw),
               partial(paint_kernels.paint_fwd_capture, **kw),
               partial(paint_kernels.paint_bwd_capture, **kw))
        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P
            ax = self._mesh_axis
            r, b = P(), P(ax)
            plan = (r, b, b, b, b, b, b)     # G replicated, plan sharded
            post, fcap, bcap = fns
            fns = (jax.shard_map(post, mesh=self.mesh,
                                 in_specs=plan + (b, b),
                                 out_specs=(P(None, ax), P(None, ax)),
                                 check_vma=False),
                   jax.shard_map(fcap, mesh=self.mesh,
                                 in_specs=plan + (b, b), out_specs=(b, b),
                                 check_vma=False),
                   jax.shard_map(bcap, mesh=self.mesh,
                                 in_specs=plan + (b, b), out_specs=(b, b),
                                 check_vma=False))
        self._kfns = fns
        return fns

    def _shard_lead(self, a):
        """device_put with the target (leading) axis sharded."""
        if self.mesh is None:
            return jnp.asarray(a)
        return jax.device_put(a, self._row)

    # -- mesh helpers ------------------------------------------------------
    def _pad_rows(self, a, B_pad: int):
        """Pad a batch-leading host/device array to B_pad rows by repeating
        the last row (padded targets compute throwaway values)."""
        B = a.shape[0]
        if B == B_pad:
            return a
        reps = jnp.broadcast_to(a[-1:], (B_pad - B,) + a.shape[1:])
        return jnp.concatenate([jnp.asarray(a), reps], axis=0)

    def _pad_cols(self, a, B_pad: int):
        """Pad axis 1 (the step-output batch axis) to B_pad columns."""
        B = a.shape[1]
        if B == B_pad:
            return a
        reps = jnp.broadcast_to(a[:, -1:],
                                a.shape[:1] + (B_pad - B,) + a.shape[2:])
        return jnp.concatenate([jnp.asarray(a), reps], axis=1)

    def _cum_counts(self) -> np.ndarray:
        """(L+1, N) prefix counts of derived sites per haplotype."""
        if self._cumG is None:
            c = np.zeros((self.L + 1, self.N), dtype=np.int32)
            np.cumsum(self.G_host, axis=0, out=c[1:])
            self._cumG = c
        return self._cumG

    def _r_prefix(self) -> np.ndarray:
        if self._S is None:
            S = np.zeros(self.L + 1, dtype=np.float64)
            np.cumsum(self.r, out=S[1:])
            self._S = S
        return self._S

    def _prep_kernel(self, targets, first_arr, last_arr, final_raw=None):
        """Device plan (+padding metadata) for one kernel window run.

        The planner only looks at panel rows inside
        [min(first), max(last)] — the window plus its boundary stretch —
        so the panel is SLICED to that span (bucketed for compile-cache
        reuse) before the planner's (B, L) masked sort: at chromosome scale
        a (B, ~1k) sort per window instead of a (B, L) one."""
        if self._planner is None:
            self._planner = make_device_planner(self.model)
            self._GT = jnp.asarray(np.ascontiguousarray(self.G_host.T))
        B = len(targets)
        first_arr = np.broadcast_to(
            np.asarray(first_arr, dtype=np.int64), (B,))
        last_arr = np.broadcast_to(np.asarray(last_arr, dtype=np.int64), (B,))

        cumG = self._cum_counts()
        counts = (cumG[last_arr, targets]
                  - cumG[first_arr + 1, targets]).astype(np.int64)
        Dmax = -(-(int(counts.max()) + 2) // DMAX_BUCKET) * DMAX_BUCKET
        Bp = -(-B // self._ndev) * self._ndev

        # window span slice (bucketed length, clamped to the panel)
        lo = int(first_arr.min())
        hi = int(last_arr.max()) + 1
        Lw = min(-(-(hi - lo) // SPAN_BUCKET) * SPAN_BUCKET, self.L)
        lo = min(lo, self.L - Lw)
        Gw, GTw = self.G, self._GT
        if Lw < self.L:
            Gw = jax.lax.dynamic_slice_in_dim(Gw, lo, Lw, axis=0)
            GTw = jax.lax.dynamic_slice_in_dim(GTw, lo, Lw, axis=1)

        tgt_p = np.zeros(Bp, dtype=np.int32)
        tgt_p[:B] = targets
        fst_p = np.zeros(Bp, dtype=np.int32)
        fst_p[:B] = first_arr - lo
        lst_p = np.full(Bp, hi - 1 - lo, dtype=np.int32)
        lst_p[:B] = last_arr - lo
        S = self._r_prefix() - self._r_prefix()[int(first_arr.min())]
        S = S[lo:lo + Lw]
        S_hi = S.astype(np.float32)
        S_lo = (S - S_hi.astype(np.float64)).astype(np.float32)
        fin = self.r[np.minimum(lst_p + lo, self.L - 1)].astype(np.float32)
        if final_raw is not None:
            fin[:B] = np.asarray(final_raw, dtype=np.float32)

        idx, seqk, D, pfac, nxt = self._planner(
            GTw, jnp.asarray(S_hi), jnp.asarray(S_lo), jnp.asarray(tgt_p),
            jnp.asarray(fst_p), jnp.asarray(lst_p), jnp.asarray(fin),
            Dmax=Dmax)
        # plan laid out with the target axis over the mesh, so the
        # shard_mapped kernels consume it without resharding
        plan = (Gw,) + tuple(self._shard_lead(a) for a in
                             (idx, seqk, pfac, nxt, D, jnp.asarray(tgt_p)))
        return dict(B=B, Bp=Bp, counts=counts, first=first_arr,
                    last=last_arr, plan=plan, idx_abs=idx + jnp.int32(lo),
                    seqk=seqk)

    def _slab(self, arr, Bp: int):
        """(B, N) host state -> (Bp, N) device slab (rows padded)."""
        B = arr.shape[0]
        out = np.zeros((Bp, self.N), dtype=np.float32)
        out[:B] = arr
        return self._shard_lead(out)

    def _rows_of_sites(self, prep, targets, sites):
        """Step-row index of absolute sites within a window plan, from
        prefix counts (the plan's idx stays on device). Sites must be plan
        steps (a boundary or a derived site of the target)."""
        cumG = self._cum_counts()
        sites = np.asarray(sites, dtype=np.int64)
        first = prep["first"]
        cnt = cumG[sites + 1, targets] - cumG[first + 1, targets]
        rows = np.where(sites <= first, 0,
                        np.where(sites >= prep["last"],
                                 prep["counts"] + 1, cnt))
        return rows.astype(np.int64)

    def _want(self, prep, targets, sites):
        rows = np.zeros(prep["Bp"], dtype=np.int32)
        rows[:prep["B"]] = self._rows_of_sites(prep, targets, sites)
        return self._shard_lead(rows)

    def _repaint_kernel(self, first_arr, last_arr, alpha0, beta_end,
                        ls_base, targets, dev_slabs=None) -> "PaintOutput":
        """RePaintSection on the painting kernels."""
        prep = self._prep_kernel(targets, first_arr, last_arr)
        B, Bp = prep["B"], prep["Bp"]
        if dev_slabs is not None:
            a0, be = dev_slabs
            assert a0.shape == (Bp, self.N), (a0.shape, Bp, self.N)
        else:
            a0 = self._slab(alpha0, Bp)
            be = self._slab(beta_end, Bp)
        post = self._kernel_fns()[0]
        topo, lstot = post(*prep["plan"], a0, be)
        if Bp != B:
            topo, lstot = topo[:, :B], lstot[:, :B]
        # idx/seqk stay on device: the only host consumer
        # (distance.init_state) reads idx[:, 0] alone
        plan = TargetPlan(
            targets=np.asarray(targets, dtype=np.int32),
            idx=prep["idx_abs"][:B],
            seqk=prep["seqk"][:B],
            pfac=None, nxt=None,
            D=(prep["counts"] + 2).astype(np.int32),
            kmask=None)
        return PaintOutput(topology=topo, logscale=lstot,
                           ls_base=np.asarray(ls_base, np.float64),
                           plan=plan)

    def _derived_csr(self):
        """CSR layout of per-haplotype derived-site positions: column k's
        sorted positions are ``cols[indptr[k]:indptr[k+1]]``."""
        if self._csr is None:
            rows, cols = np.nonzero(self.G_host.T)
            indptr = np.zeros(self.N + 1, dtype=np.int64)
            np.cumsum(np.bincount(rows, minlength=self.N), out=indptr[1:])
            self._csr = (indptr, cols.astype(np.int64))
        return self._csr

    # -- boundaries ------------------------------------------------------
    def window_boundary_sites(self, boundaries: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-(window, target) stepping-stone boundary SNPs.

        alpha checkpoint of window w = last derived step < boundaries[w+1]
        of the previous stretch; beta checkpoint = first derived step >=
        boundaries[w+1] (fast_painting.cpp:56-107). Window 0 starts at 0; the
        last window ends at L-1.
        """
        G = self.G_host
        L, N = G.shape
        W = len(boundaries) - 1
        bsb = np.zeros((W, N), dtype=np.int64)
        bse = np.zeros((W, N), dtype=np.int64)
        indptr, csr_cols = self._derived_csr()
        wends = np.asarray(boundaries[1:], dtype=np.int64)
        for k in range(N):
            core = csr_cols[indptr[k]:indptr[k + 1]]
            dsites = np.unique(np.concatenate([[0], core, [L - 1]]))
            jpos = np.searchsorted(dsites, wends, side="left")
            bsb[:, k] = dsites[np.maximum(jpos - 1, 0)]
            bse[:, k] = dsites[np.minimum(jpos, len(dsites) - 1)]
        # alpha checkpoint for window w is captured at boundaries[w]: the
        # last derived step < boundaries[w] (i.e. the bsb of window w-1).
        out_bsb = np.zeros((W, N), dtype=np.int64)
        out_bsb[1:, :] = bsb[:-1, :]
        bse[W - 1, :] = L - 1
        return out_bsb, bse

    # -- internals -------------------------------------------------------
    def _plan_dev(self, plan: TargetPlan):
        """Upload a plan's arrays to device once; reused by fwd and bwd.

        With a mesh, the target (batch-leading) axis is padded to a
        multiple of the device count and sharded; the panel G stays
        replicated."""
        arrs = (plan.idx, plan.seqk, plan.pfac, plan.nxt, plan.D,
                plan.kmask)
        if self.mesh is None:
            return tuple(jax.device_put(a) for a in arrs)
        B = arrs[0].shape[0]
        B_pad = -(-B // self._ndev) * self._ndev
        return tuple(jax.device_put(self._pad_rows(np.asarray(a), B_pad),
                                    self._row) for a in arrs)

    @staticmethod
    def _row_of_site(plan: TargetPlan, sites: np.ndarray) -> np.ndarray:
        """Row index of an absolute site in each target's step list."""
        sites = np.asarray(sites, dtype=np.int64)
        # valid step lists are sorted ascending and padding repeats the final
        # site (>= any queried site), so a strict count-below is the rank
        rows = (plan.idx < sites[:, None]).sum(axis=1).astype(np.int64)
        got = np.take_along_axis(plan.idx, rows[:, None], axis=1)[:, 0]
        assert np.array_equal(got, sites), (rows, sites)
        return rows

    def _run_fwd(self, plan: TargetPlan, alpha0, dev=None):
        dev = dev or self._plan_dev(plan)
        if self.mesh is None:
            return self._fwd(self.G, *dev, jnp.asarray(alpha0))
        B = plan.idx.shape[0]
        B_pad = int(dev[0].shape[0])
        a0 = jax.device_put(self._pad_rows(jnp.asarray(alpha0), B_pad),
                            self._row)
        a_all, ls_all = self._fwd(self.G, *dev, a0)
        return a_all[:, :B], ls_all[:, :B]

    def _run_bwd(self, plan: TargetPlan, a_all, lsf, beta_end, dev=None):
        dev = dev or self._plan_dev(plan)
        if self.mesh is None:
            return self._bwd_full(self.G, *dev, a_all, lsf,
                                  jnp.asarray(beta_end))
        B = plan.idx.shape[0]
        B_pad = int(dev[0].shape[0])
        be = jax.device_put(self._pad_rows(jnp.asarray(beta_end), B_pad),
                            self._row)
        out = self._bwd_full(self.G, *dev, self._pad_cols(a_all, B_pad),
                             self._pad_cols(lsf, B_pad), be)
        topo, lstot, beta_all, lsb_all = out
        return (topo[:, :B], lstot[:, :B], beta_all[:, :B],
                lsb_all[:, :B])

    # -- stepping stones -------------------------------------------------
    def paint_stepping_stones(self, boundaries: np.ndarray):
        """Per-window checkpoints via chained window sweeps.

        Forward: window w's forward scan starts from checkpoint w and the
        alpha row at window w+1's begin-boundary (inside window w's range) is
        the next checkpoint. Backward symmetric. Same total cost as the
        reference's full passes, single-window memory.
        """
        boundaries = np.asarray(boundaries)
        if self.use_kernel and len(boundaries) > 1:
            return self._stones_kernel(boundaries)
        W = len(boundaries) - 1
        N = self.N
        targets = np.arange(N, dtype=np.int32)
        bsb, bse = self.window_boundary_sites(boundaries)

        alphas0: list = [None] * W
        lsa0: list = [None] * W
        betasW: list = [None] * W
        lsbW: list = [None] * W

        alpha = initial_alpha(self.G_host, self.model, 0, targets)
        lsa = np.zeros(N, dtype=np.float64)
        for w in range(W):
            alphas0[w] = alpha
            lsa0[w] = lsa
            if w == W - 1:
                break
            plan = build_target_plan(self.G_host, self.r, self.model,
                                     bsb[w], bse[w], targets)
            a_all, ls_all = self._run_fwd(plan, alpha)
            rows = jnp.asarray(self._row_of_site(plan, bsb[w + 1]))
            alpha = np.asarray(self._extract(a_all, rows))
            lsa = lsa + np.asarray(self._extract(ls_all, rows),
                                   dtype=np.float64)

        Dtot = self.G_host[1:-1].sum(axis=0).astype(np.int64) + 2
        beta = np.ones((N, N), dtype=np.float32)
        lsb = normalizing_constant(self.model, Dtot).astype(np.float64)
        for w in range(W - 1, -1, -1):
            betasW[w] = beta
            lsbW[w] = lsb
            if w == 0:
                break
            # extend the final interval to the next derived site beyond the
            # window so the chained checkpoints reproduce the reference's
            # single full-pass interval structure exactly
            final_raw = self._extended_final_raw(bse[w])
            plan = build_target_plan(self.G_host, self.r, self.model,
                                     bsb[w], bse[w], targets,
                                     final_raw=final_raw)
            dev = self._plan_dev(plan)
            a_all, lsf = self._run_fwd(plan, alphas0[w], dev)
            _, _, beta_all, lsb_all = self._run_bwd(plan, a_all, lsf, beta,
                                                    dev)
            rows = jnp.asarray(self._row_of_site(plan, bse[w - 1]))
            beta = np.asarray(self._extract(beta_all, rows))
            lsb = lsb + np.asarray(self._extract(lsb_all, rows),
                                   dtype=np.float64)

        return [Checkpoint(alpha=alphas0[w], ls_alpha=lsa0[w], bsb=bsb[w],
                           beta=betasW[w], ls_beta=lsbW[w], bse=bse[w])
                for w in range(W)]

    def _stones_kernel(self, boundaries: np.ndarray):
        """Stepping-stone checkpoints on the capture kernels: chained
        window sweeps with the (B, N) boundary slabs kept ON DEVICE — each
        window's captured alpha/beta feeds the next sweep directly (no host
        round trip; Checkpoint materializes host copies lazily for artifact
        writes)."""
        W = len(boundaries) - 1
        N = self.N
        targets = np.arange(N, dtype=np.int32)
        bsb, bse = self.window_boundary_sites(boundaries)
        _, fcap, bcap = self._kernel_fns()

        alphas0: list = [None] * W
        lsa0: list = [None] * W
        betasW: list = [None] * W
        lsbW: list = [None] * W

        prep0 = self._prep_kernel(targets, bsb[0], bse[0])
        Bp = prep0["Bp"]
        # device-resident slab budget: keep at most K windows' checkpoint
        # slabs on the device (25% of its memory) and download the rest
        # eagerly — at N=5008 a chunk's slabs are W x 2 x 100MB
        from ..utils.devmem import device_hbm_gb
        slab = Bp * N * 4
        K_dev = max(2, int(device_hbm_gb() * 1e9 * 0.25 / (2 * slab)))

        def keep(w, dev_slab):
            if w < K_dev:
                return dev_slab, None
            return None, np.asarray(dev_slab)[:N]

        a_host: list = [None] * W
        b_host: list = [None] * W
        a_dev = self._slab(initial_alpha(self.G_host, self.model, 0,
                                         targets), Bp)
        lsa = np.zeros(N, dtype=np.float64)
        for w in range(W):
            alphas0[w], a_host[w] = keep(w, a_dev)
            lsa0[w] = lsa
            if w == W - 1:
                break
            prep = prep0 if w == 0 else self._prep_kernel(
                targets, bsb[w], bse[w])
            a_dev, lv = fcap(*prep["plan"],
                             self._want(prep, targets, bsb[w + 1]), a_dev)
            lsa = lsa + np.asarray(lv, dtype=np.float64)[:N]

        Dtot = self.G_host[1:-1].sum(axis=0).astype(np.int64) + 2
        b_dev = self._slab(np.ones((N, N), dtype=np.float32), Bp)
        lsb = normalizing_constant(self.model, Dtot).astype(np.float64)
        for w in range(W - 1, -1, -1):
            betasW[w], b_host[w] = keep(w, b_dev)
            lsbW[w] = lsb
            if w == 0:
                break
            final_raw = self._extended_final_raw(bse[w])
            prep = self._prep_kernel(targets, bsb[w], bse[w],
                                     final_raw=final_raw)
            b_dev, lv = bcap(*prep["plan"],
                             self._want(prep, targets, bse[w - 1]), b_dev)
            lsb = lsb + np.asarray(lv, dtype=np.float64)[:N]

        return [Checkpoint(alpha=a_host[w], beta=b_host[w],
                           ls_alpha=lsa0[w], bsb=bsb[w],
                           ls_beta=lsbW[w], bse=bse[w],
                           a0_dev=alphas0[w], be_dev=betasW[w], n=N)
                for w in range(W)]

    def _extended_final_raw(self, bse_row: np.ndarray) -> np.ndarray:
        """Full-pass interval at each target's window-end step: accumulated r
        from bse to the next derived step of that target beyond it."""
        G, r = self.G_host, self.r
        L, N = G.shape
        S = np.zeros(L + 1, dtype=np.float64)
        np.cumsum(r, out=S[1:])
        indptr, csr_cols = self._derived_csr()
        out = np.empty(N, dtype=np.float64)
        for k in range(N):
            b = int(bse_row[k])
            if b >= L - 1:
                out[k] = r[L - 1]
                continue
            core = csr_cols[indptr[k]:indptr[k + 1]]
            j = np.searchsorted(core, b, side="right")
            nd = int(core[j]) if j < len(core) else L - 1
            out[k] = S[nd] - S[b]
        return out

    # -- full posterior --------------------------------------------------
    def repaint(self, cp: Checkpoint,
                targets: Optional[np.ndarray] = None) -> PaintOutput:
        """Full posterior over a window from its checkpoint
        (RePaintSection equivalent)."""
        if targets is None:
            targets = np.arange(self.N, dtype=np.int32)
        if self.use_kernel:
            base = (np.asarray(cp.ls_alpha, np.float64)[targets]
                    + np.asarray(cp.ls_beta, np.float64)[targets])
            all_t = len(targets) == self.N and \
                np.array_equal(targets, np.arange(self.N))
            if cp.a0_dev is not None and cp.be_dev is not None and all_t:
                # device-resident checkpoint slabs: no 2x(B,N) upload
                return self._repaint_kernel(
                    cp.bsb, cp.bse, None, None, base, targets,
                    dev_slabs=(cp.a0_dev, cp.be_dev))
            return self._repaint_kernel(
                cp.bsb[targets] if np.ndim(cp.bsb) else cp.bsb,
                cp.bse[targets] if np.ndim(cp.bse) else cp.bse,
                cp.alpha[targets], cp.beta[targets], base, targets)
        plan = build_target_plan(self.G_host, self.r, self.model,
                                 cp.bsb[targets] if np.ndim(cp.bsb) else cp.bsb,
                                 cp.bse[targets] if np.ndim(cp.bse) else cp.bse,
                                 targets)
        dev = self._plan_dev(plan)
        a_all, lsf = self._run_fwd(plan, cp.alpha[targets], dev)
        topo, lstot, _, _ = self._run_bwd(plan, a_all, lsf,
                                          cp.beta[targets], dev)
        base = (np.asarray(cp.ls_alpha, np.float64)[targets]
                + np.asarray(cp.ls_beta, np.float64)[targets])
        return PaintOutput(topology=topo, logscale=lstot, ls_base=base,
                           plan=plan)

    def repaint_from_arrays(self, first_arr, last_arr, alpha0, ls_alpha,
                            beta_end, ls_beta,
                            targets: Optional[np.ndarray] = None
                            ) -> PaintOutput:
        """RePaintSection with explicit boundary state (used by tests)."""
        if targets is None:
            targets = np.arange(self.N, dtype=np.int32)
        plan = build_target_plan(self.G_host, self.r, self.model,
                                 first_arr, last_arr, targets)
        dev = self._plan_dev(plan)
        a_all, lsf = self._run_fwd(plan, alpha0, dev)
        topo, lstot, _, _ = self._run_bwd(plan, a_all, lsf, beta_end, dev)
        base = (np.asarray(ls_alpha, np.float64)
                + np.asarray(ls_beta, np.float64))
        return PaintOutput(topology=topo, logscale=lstot, ls_base=base,
                           plan=plan)
