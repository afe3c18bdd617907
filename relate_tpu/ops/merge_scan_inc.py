"""Incremental MinMatch merge scan: one-program Pallas kernel (Triton route).

The XLA twin (``core/topology_device._merge_scan``) does O(N^2) work per
merge step: every step re-scans the full (N, N) matrices for row minima and
mutual pairs, so one tree costs O(N^3). This module maintains *per-row
candidate caches* the way the C++ reference does (MinMatch::Coalesce,
include/src/tree_builder.cpp:1843-2070): amortized O(N) work per step, so a
tree costs ~O(N^2) total.

Key invariant (the reference notes it at tree_builder.cpp:1877): row minima
of d only INCREASE through the scan — the merged column is a convex blend of
two active entries, so it can never undercut a row's minimum; removing a
column can only raise it. Hence per-row state can be maintained
incrementally, with a full row re-scan ("repair") only when a row's cached
minimum or cached candidate is actually touched.

Semantics relative to the XLA twin:
- identical candidate/merge rule: mutual-row-min within threshold, score =
  d[i,j]+d[j,i] (0 when also mutually-min in the CF prior), fallback to the
  global symmetrized argmin when no mutual pair exists, cluster-size-weighted
  averaging of the merged row/column.
- tie-breaking uses a per-PAIR static integer hash of (min,max,seed) instead
  of per-step draws (the cached candidate must keep a stable tie key).
- CF row minima follow the REFERENCE (tree_builder.cpp:2483-2510): d_CF is
  merged by weighted averages, but min_values_CF is refreshed only for the
  newly merged cluster j; other rows keep their (possibly stale) value. The
  XLA twin recomputes them fresh each step. Both land within the e2e golden
  tolerance; the reference comment documents the approximation.
- repair order is ascending row index (deterministic); the reference's
  deque order differs on exact ties only.

`merge_scan_inc_host` is the executable spec; the kernel is bit-exact to it.

GPU mechanics: the whole step chain runs in ONE Triton program (a single
thread block). The per-row state (row minima, candidate score/tie/partner,
active mask, cluster sizes, node ids) is carried in registers as
power-of-two (Np,) vectors; the matrices live in device memory as d and its
transpose, so both the row d[w, :] and the column d[:, w] of a rescan are
coalesced row loads. A merge writes the merged row into one copy and the
merged column into the other as a strided store, followed by a block
barrier. The blend and the size ratio use round-to-nearest PTX arithmetic
(no FMA contraction, IEEE division) so the merged values match the f32
host twin bit for bit. Row minima and the initial candidates are computed
by XLA before the kernel starts (O(N^2) once per tree).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .paint_kernels import pow2_lanes

INF = np.float32(3.0e38)

# static pair-hash constants
_H1 = -1640531527
_H2 = -2048144789
_H3 = 747796405
_H4 = 739213477


def _tie_hash_np(lo, hi, seed):
    """Static per-pair tie hash -> float32 in [0, 2^23). int32 wraparound."""
    lo = np.asarray(lo).astype(np.int64)
    hi = np.asarray(hi).astype(np.int64)

    def trunc(x):
        return ((x + 2**31) % 2**32 - 2**31).astype(np.int64)

    h = trunc(lo * _H1 + hi * _H2)
    h = trunc(h ^ trunc(np.int64(seed) * _H3))
    h = trunc(h ^ ((h % 2**32) >> 15))
    h = trunc(h * _H4)
    h = trunc(h ^ ((h % 2**32) >> 12))
    return (h & 0x7FFFFF).astype(np.float32)


def _tie_hash(lo, hi, seed):
    """jnp twin of :func:`_tie_hash_np` (int32 arithmetic wraps)."""
    h = lo * jnp.int32(_H1) + hi * jnp.int32(_H2)
    h = h ^ (seed * jnp.int32(_H3))
    h = h ^ jax.lax.shift_right_logical(h, jnp.int32(15))
    h = h * jnp.int32(_H4)
    h = h ^ jax.lax.shift_right_logical(h, jnp.int32(12))
    return (h & jnp.int32(0x7FFFFF)).astype(jnp.float32)


# --------------------------------------------------------------------------
# NumPy twin — the executable spec of the kernel's exact semantics.
# --------------------------------------------------------------------------

def merge_scan_inc_host(d, dcf, use_cf, threshold, threshold_cf, seed):
    """Bit-exact host twin of the incremental kernel (float32 throughout).

    Returns (cis, cjs) int32 (N-1,) merge lists in node-id space
    (leaves 0..N-1, cluster born at step t = N+t)."""
    d = np.array(d, dtype=np.float32)
    dcf = np.array(dcf, dtype=np.float32)
    N = d.shape[0]
    thr = np.float32(threshold)
    thrcf = np.float32(threshold_cf)
    active = np.ones(N, dtype=bool)
    sizes = np.ones(N, dtype=np.float32)
    conv = np.arange(N, dtype=np.int32)
    lanes = np.arange(N, dtype=np.int32)

    def row_min(mat, a):
        m = np.where(active & (lanes != a), mat[a], INF)
        return np.float32(m.min())

    rm = np.array([row_min(d, a) for a in range(N)], dtype=np.float32)
    rmcf = np.array([row_min(dcf, a) for a in range(N)], dtype=np.float32)

    cand_s = np.full(N, INF, np.float32)
    cand_t = np.full(N, INF, np.float32)
    cand_p = np.full(N, -1, np.int32)

    def eff_row(w):
        """(eff, tie) vectors for row w against all partners."""
        mask = active & (lanes != w)
        mutual = mask & (d[w] <= rm[w] + thr) & (d[:, w] <= rm + thr)
        if use_cf:
            cfm = (dcf[w] <= rmcf[w] + thrcf) & (dcf[:, w] <= rmcf + thrcf)
            score = np.where(cfm, np.float32(0.0),
                             (d[w] + d[:, w]).astype(np.float32))
        else:
            score = (d[w] + d[:, w]).astype(np.float32)
        eff = np.where(mutual, score, INF).astype(np.float32)
        tie = _tie_hash_np(np.minimum(lanes, w), np.maximum(lanes, w), seed)
        return eff, tie

    def rescan(w, fold=True):
        eff, tie = eff_row(w)
        m = np.float32(eff.min())
        if m >= INF:
            cand_s[w], cand_t[w], cand_p[w] = INF, INF, -1
        else:
            t1 = tie[eff == m].min()
            p = lanes[(eff == m) & (tie == t1)].min()
            cand_s[w], cand_t[w], cand_p[w] = m, t1, p
        if fold:
            better = (eff < cand_s) | ((eff == cand_s) & (tie < cand_t))
            better &= active & (lanes != w)
            cand_s[better] = eff[better]
            cand_t[better] = tie[better]
            cand_p[better] = w

    for w in range(N):
        if active[w]:
            rescan(w, fold=False)

    cis = np.zeros(N - 1, np.int32)
    cjs = np.zeros(N - 1, np.int32)

    for t in range(N - 1):
        ok = active & (cand_s < INF)
        if ok.any():
            m = cand_s[ok].min()
            sel = ok & (cand_s == m)
            t1 = cand_t[sel].min()
            a = lanes[sel & (cand_t == t1)].min()
            b = cand_p[a]
        else:
            # fallback: global symmetrized argmin over active pairs
            mask2 = (active[:, None] & active[None, :]
                     & (lanes[:, None] != lanes[None, :]))
            sym = (d + d.T).astype(np.float32)
            eff = np.where(mask2, sym, INF)
            m = eff.min()
            tie2 = _tie_hash_np(np.minimum(lanes[:, None], lanes[None, :]),
                                np.maximum(lanes[:, None], lanes[None, :]),
                                seed)
            tsel = np.where(eff == m, tie2, INF)
            t1 = tsel.min()
            flat = np.where(tsel == t1)
            a, b = int(flat[0][0]), int(flat[1][0])
        i, j = int(min(a, b)), int(max(a, b))

        cis[t] = conv[i]
        cjs[t] = conv[j]

        w_frac = np.float32(sizes[i] / (sizes[i] + sizes[j]))
        ri_d = d[i].copy()
        rj_d = d[j].copy()
        ci_d = d[:, i].copy()
        cj_d = d[:, j].copy()
        nrow = (w_frac * ri_d + (1 - w_frac) * rj_d).astype(np.float32)
        ncol = (w_frac * ci_d + (1 - w_frac) * cj_d).astype(np.float32)
        nrow_cf = (w_frac * dcf[i] + (1 - w_frac) * dcf[j]).astype(np.float32)
        ncol_cf = (w_frac * dcf[:, i]
                   + (1 - w_frac) * dcf[:, j]).astype(np.float32)

        # rm maintenance: detect rows whose min was at column i or j
        hit = active & (lanes != i) & (lanes != j) & \
            ((ci_d == rm) | (cj_d == rm))
        rm_safe = np.minimum(rm, ncol)   # no-op mathematically; keeps exact
        rm = np.where(active & (lanes != i) & (lanes != j) & ~hit,
                      rm_safe, rm).astype(np.float32)

        dirty = (active & ((cand_p == i) | (cand_p == j))) | hit
        dirty[j] = True
        dirty[i] = False

        # apply the merge (the kernel stores nrow in raw with the diagonal
        # patched to ncol[j], and pends ncol/nrow as lazy columns — value-
        # identical to direct updates)
        d[j, :] = nrow
        d[:, j] = ncol
        dcf[j, :] = nrow_cf
        dcf[:, j] = ncol_cf

        active[i] = False
        cand_s[i] = INF
        sizes[j] = np.float32(sizes[i] + sizes[j])
        conv[j] = N + t

        for w in np.nonzero(dirty & active)[0]:
            if hit[w] or w == j:
                rm[w] = row_min(d, w)
            if w == j:
                # reference-style CF minima: only row j refreshed
                # (tree_builder.cpp:2485-2510); other rows keep stale values
                rmcf[j] = row_min(dcf, j)
            rescan(w, fold=True)

    return cis, cjs


# --------------------------------------------------------------------------
# Pallas kernel (Triton route)
# --------------------------------------------------------------------------

def _rn(op: str, x, y, interpret: bool):
    """IEEE round-to-nearest f32 ``x <op> y``. On the GPU this is one PTX
    instruction with an explicit ``.rn`` rounding mode, which the compiler
    never contracts into an FMA (and, for ``div``, is not the approximate
    ``div.full``); the interpreter's XLA ops are already IEEE."""
    if interpret:
        return {"add": x + y, "sub": x - y, "mul": x * y, "div": x / y}[op]
    [out] = plgpu.elementwise_inline_asm(
        f"{op}.rn.f32 $0, $1, $2;", args=[x, y], constraints="=f,f,f",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, x.dtype)])
    return out


def _make_kernel(n: int, Np: int, use_cf: bool, interpret: bool):
    """Kernel body for n real rows padded to the power of two Np."""
    INFv = np.float32(INF)
    BIG = np.int32(Np)

    def kernel(*refs):
        if use_cf:
            (fp_ref, ip_ref, rm_ref, rmcf_ref, cs_ref, ct_ref, cp_ref,
             _d, _dt, _dcf, _dcft,
             cis_ref, cjs_ref, d_ref, dt_ref, dcf_ref, dcft_ref) = refs
        else:
            (fp_ref, ip_ref, rm_ref, cs_ref, ct_ref, cp_ref, _d, _dt,
             cis_ref, cjs_ref, d_ref, dt_ref) = refs
        lane = jax.lax.broadcasted_iota(jnp.int32, (Np,), 0)
        inb = lane < n
        thr = fp_ref[0]
        thrcf = fp_ref[1]
        seed = ip_ref[0]

        def vec(ref, other):
            return plgpu.load(ref.at[pl.ds(0, Np)], mask=inb, other=other)

        def row(ref, r):
            return plgpu.load(ref.at[r, pl.ds(0, Np)], mask=inb, other=0.0)

        def put_row(ref, r, v):
            plgpu.store(ref.at[r, pl.ds(0, Np)], v, mask=inb)

        def put_col(ref, c, v):
            plgpu.store(ref.at[pl.ds(0, Np), c], v, mask=inb)

        def pick(v, at):
            """Scalar v[at]: a one-hot sum is exact for any value."""
            return jnp.sum(jnp.where(lane == at, v, jnp.zeros_like(v)))

        def lane_min(cond):
            return jnp.min(jnp.where(cond, lane, BIG))

        def barrier():
            if not interpret:
                plgpu.debug_barrier()

        def fallback(active):
            """Global symmetrized argmin over active pairs, first in
            row-major order among (score, tie) minima."""
            act_i = active.astype(jnp.int32)

            def body(r, best):
                bm, bt, br, bc = best
                act_r = pick(act_i, r) > 0
                sym = row(d_ref, r) + row(dt_ref, r)
                eff = jnp.where(active & (lane != r) & act_r, sym, INFv)
                mr = jnp.min(eff)
                tie = _tie_hash(jnp.minimum(lane, r), jnp.maximum(lane, r),
                                seed)
                tr = jnp.min(jnp.where(eff == mr, tie, INFv))
                cr = lane_min((eff == mr) & (tie == tr))
                better = (mr < bm) | ((mr == bm) & (tr < bt))
                return (jnp.where(better, mr, bm), jnp.where(better, tr, bt),
                        jnp.where(better, r, br), jnp.where(better, cr, bc))

            init = (jnp.float32(INF), jnp.float32(INF), jnp.int32(0),
                    jnp.int32(0))
            _, _, br, bc = jax.lax.fori_loop(0, n, body, init)
            return br, bc

        def step(t, carry):
            rm, rmcf, cs, ct, cp, active, sizes, conv = carry
            ok = active & (cs < INFv)
            any_ok = jnp.max(ok.astype(jnp.int32)) > 0
            m = jnp.min(jnp.where(ok, cs, INFv))
            sel = ok & (cs == m)
            t1 = jnp.min(jnp.where(sel, ct, INFv))
            a0 = lane_min(sel & (ct == t1))
            b0 = pick(cp, a0)
            a, b = jax.lax.cond(any_ok, lambda: (a0, b0),
                                lambda: fallback(active))
            i = jnp.minimum(a, b)
            j = jnp.maximum(a, b)
            cis_ref[t] = pick(conv, i)
            cjs_ref[t] = pick(conv, j)

            si = jnp.full((Np,), pick(sizes, i))
            sj = jnp.full((Np,), pick(sizes, j))
            ssum = _rn("add", si, sj, interpret)
            wv = _rn("div", si, ssum, interpret)
            w1 = _rn("sub", jnp.ones((Np,), jnp.float32), wv, interpret)

            def blend(x, y):
                return _rn("add", _rn("mul", wv, x, interpret),
                           _rn("mul", w1, y, interpret), interpret)

            ci = row(dt_ref, i)
            cj = row(dt_ref, j)
            nrow = blend(row(d_ref, i), row(d_ref, j))
            ncol = blend(ci, cj)

            not_ij = (lane != i) & (lane != j)
            hit = active & not_ij & ((ci == rm) | (cj == rm))
            rm = jnp.where(active & not_ij & ~hit, jnp.minimum(rm, ncol), rm)
            dirty = ((active & ((cp == i) | (cp == j))) | hit
                     | (lane == j)) & (lane != i)

            # merged row/column into both copies; d[j, j] = ncol[j]
            diag = lane == j
            nrow_d = jnp.where(diag, ncol, nrow)
            put_row(d_ref, j, nrow_d)
            put_col(d_ref, j, ncol)
            put_row(dt_ref, j, ncol)
            put_col(dt_ref, j, nrow_d)
            if use_cf:
                ncol_cf = blend(row(dcft_ref, i), row(dcft_ref, j))
                nrow_cf = jnp.where(diag, ncol_cf,
                                    blend(row(dcf_ref, i), row(dcf_ref, j)))
                put_row(dcf_ref, j, nrow_cf)
                put_col(dcf_ref, j, ncol_cf)
                put_row(dcft_ref, j, ncol_cf)
                put_col(dcft_ref, j, nrow_cf)

            active = active & (lane != i)
            cs = jnp.where(lane == i, INFv, cs)
            sizes = jnp.where(lane == j, ssum, sizes)
            conv = jnp.where(lane == j, n + t, conv)
            barrier()   # the strided column stores before any row reload

            dirty = dirty & active
            hit_i = hit.astype(jnp.int32)

            def repair(_, c):
                dirty, rm, rmcf, cs, ct, cp = c
                w = lane_min(dirty)
                mask = active & (lane != w)
                dw = row(d_ref, w)
                dtw = row(dt_ref, w)
                fresh = (pick(hit_i, w) > 0) | (w == j)
                rm = jnp.where((lane == w) & fresh,
                               jnp.min(jnp.where(mask, dw, INFv)), rm)
                mutual = (mask & (dw <= pick(rm, w) + thr)
                          & (dtw <= rm + thr))
                score = dw + dtw
                if use_cf:
                    dcfw = row(dcf_ref, w)
                    rmcf = jnp.where((lane == w) & (w == j),
                                     jnp.min(jnp.where(mask, dcfw, INFv)),
                                     rmcf)
                    cfm = ((dcfw <= pick(rmcf, w) + thrcf)
                           & (row(dcft_ref, w) <= rmcf + thrcf))
                    score = jnp.where(cfm, jnp.float32(0.0), score)
                eff = jnp.where(mutual, score, INFv)
                tie = _tie_hash(jnp.minimum(lane, w), jnp.maximum(lane, w),
                                seed)
                mw = jnp.min(eff)
                tw = jnp.min(jnp.where(eff == mw, tie, INFv))
                pw = lane_min((eff == mw) & (tie == tw))
                none = mw >= INFv
                at_w = lane == w
                cs = jnp.where(at_w, jnp.where(none, INFv, mw), cs)
                ct = jnp.where(at_w, jnp.where(none, INFv, tw), ct)
                cp = jnp.where(at_w, jnp.where(none, -1, pw), cp)
                better = (((eff < cs) | ((eff == cs) & (tie < ct)))
                          & mask)
                cs = jnp.where(better, eff, cs)
                ct = jnp.where(better, tie, ct)
                cp = jnp.where(better, w, cp)
                return dirty & ~at_w, rm, rmcf, cs, ct, cp

            ndirty = jnp.sum(dirty.astype(jnp.int32))
            _, rm, rmcf, cs, ct, cp = jax.lax.fori_loop(
                0, ndirty, repair, (dirty, rm, rmcf, cs, ct, cp))
            return rm, rmcf, cs, ct, cp, active, sizes, conv

        rm = vec(rm_ref, INFv)
        rmcf = vec(rmcf_ref, INFv) if use_cf else rm
        init = (rm, rmcf, vec(cs_ref, INFv), vec(ct_ref, INFv),
                vec(cp_ref, -1), inb, jnp.ones((Np,), jnp.float32), lane)
        jax.lax.fori_loop(0, n - 1, step, init)

    return kernel


def _initial_state(d, dcf, use_cf, thr, thrcf, seed):
    """Row minima and every row's first candidate (the spec's
    ``rescan(w, fold=False)`` for all w), vectorized over the matrix."""
    N = d.shape[0]
    lanes = jnp.arange(N, dtype=jnp.int32)
    off = lanes[:, None] != lanes[None, :]
    rm = jnp.min(jnp.where(off, d, INF), axis=1)
    rmt = rm + thr
    mutual = off & (d <= rmt[:, None]) & (d.T <= rmt[None, :])
    score = d + d.T
    rmcf = None
    if use_cf:
        rmcf = jnp.min(jnp.where(off, dcf, INF), axis=1)
        rct = rmcf + thrcf
        cfm = (dcf <= rct[:, None]) & (dcf.T <= rct[None, :])
        score = jnp.where(cfm, jnp.float32(0.0), score)
    eff = jnp.where(mutual, score, INF)
    tie = _tie_hash(jnp.minimum(lanes[:, None], lanes[None, :]),
                    jnp.maximum(lanes[:, None], lanes[None, :]), seed)
    m = eff.min(axis=1)
    eq = eff == m[:, None]
    t1 = jnp.min(jnp.where(eq, tie, INF), axis=1)
    p = jnp.min(jnp.where(eq & (tie == t1[:, None]), lanes[None, :], N),
                axis=1)
    none = m >= INF
    cs = jnp.where(none, INF, m)
    ct = jnp.where(none, INF, t1)
    cp = jnp.where(none, -1, p).astype(jnp.int32)
    return rm, rmcf, cs, ct, cp


@functools.partial(jax.jit, static_argnames=("use_cf", "interpret"))
def merge_scan_incremental(d, dcf, use_cf: bool, threshold, threshold_cf,
                           seed, *, interpret: bool = False):
    """Incremental merge scan; drop-in for ``topology_device._merge_scan``.

    d, dcf: (N, N) float32 (dcf is read only when ``use_cf``). Returns
    (cis, cjs, clades) with shapes ((N-1,), (N-1,), (N-1, N)), bit-exact to
    :func:`merge_scan_inc_host` for the same seed."""
    N = d.shape[0]
    Np = pow2_lanes(N)
    d = jnp.asarray(d, jnp.float32)
    dcf = jnp.asarray(dcf, jnp.float32)
    thr = jnp.asarray(threshold, jnp.float32)
    thrcf = jnp.asarray(threshold_cf, jnp.float32)
    seed = jnp.asarray(seed, jnp.int32)
    rm, rmcf, cs, ct, cp = _initial_state(d, dcf, use_cf, thr, thrcf, seed)
    fp = jnp.stack([thr, thrcf])
    ip = seed[None]
    mats = (d, d.T) + ((dcf, dcf.T) if use_cf else ())
    vecs = (rm,) + ((rmcf,) if use_cf else ()) + (cs, ct, cp)
    nv = 2 + len(vecs)
    out_shape = ((jax.ShapeDtypeStruct((Np,), jnp.int32),) * 2
                 + tuple(jax.ShapeDtypeStruct((N, N), jnp.float32)
                         for _ in mats))
    res = pl.pallas_call(
        _make_kernel(N, Np, use_cf, interpret),
        out_shape=out_shape,
        input_output_aliases={nv + k: 2 + k for k in range(len(mats))},
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(4, min(16, Np // 512)), num_stages=1),
        interpret=interpret,
        name="merge_scan_inc",
    )(fp, ip, *vecs, *mats)
    cis = res[0][:N - 1]
    cjs = res[1][:N - 1]
    return cis, cjs, clades_from_merges(cis, cjs, N)


def clades_from_merges(cis, cjs, N: int):
    """(N-1, N) clade leaf-indicator rows from the merge lists. Node ids:
    [0, N) leaves, N+t = cluster born at step t."""
    C0 = jnp.concatenate([jnp.eye(N, dtype=jnp.float32),
                          jnp.zeros((N - 1, N), jnp.float32)], axis=0)

    def stepc(C, x):
        ci, cj, t = x
        clade = C[ci] + C[cj]
        return C.at[N + t].set(clade), clade

    _, clades = jax.lax.scan(
        stepc, C0, (cis, cjs, jnp.arange(N - 1, dtype=jnp.int32)))
    return clades
