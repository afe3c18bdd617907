"""Device-resident FindEquivalentBranches: leaf matrices, Pearson
correlations AND the staged matcher run on device, batched over adjacent
tree pairs.

Behavioral reference: ``AncesTreeBuilder::BranchAssociation``
(include/src/anc_builder.cpp:1433-1614) and ``Correlation::Pearson``
(include/src/anc.cpp:821-860) — the same semantics as the host matcher in
``branch_association.py`` (its ``_match_from_corr`` is the differential
oracle; see tests/test_ancbuilder.py).

Device mapping: leaf-set indicators are built on device by log-squaring the
child adjacency matrix (``_leafmats``), all pairwise leaf-set
intersections are one batched (M, N) @ (N, M) matmul per pair (0/1
operands are exact in any matmul precision, TF32 included, and f32 sums
of them are exact below 2^24), and the three matching stages are
vectorized masks + scatter-max. The reference's best-score-first greedy
assignment of approximate matches is computed exactly by iterated
locally-dominant locking (mutual row/column best under the greedy total
order) — a short data-dependent ``while_loop`` of masked (M, M)
reductions, unbounded and with no host fallback (see ``_match_pair``).

Per pair, only the (M,) equivalence vector crosses the device link —
~2 KB instead of the (M, M) correlation matrix.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .branch_association import THRESHOLD_BRANCHEQ, EXACT
from .trees import Tree



def _leafmats(parent, cl, cr, N):
    """(B, M) parent/children arrays -> (B, M, N) f32 leaf indicators.

    Descendant closure by log-squaring: P0 = I + child
    adjacency, then ceil(log2(M)) rounds of ``P = min(P @ P, 1)`` cover
    every path length. Only zero-vs-nonzero matters, so the matmuls run
    in bfloat16 (a sum of positive bf16 terms is never rounded to zero
    and an exact zero stays zero); the per-level gather loop this
    replaces moved far more device memory than these 9 batched
    matmuls."""
    import jax
    import jax.numpy as jnp

    B, M = parent.shape
    j = jnp.arange(M)
    P = ((j[None, None, :] == j[None, :, None])
         | (j[None, None, :] == cl[:, :, None])
         | (j[None, None, :] == cr[:, :, None])).astype(jnp.bfloat16)
    for _ in range(int(np.ceil(np.log2(max(M, 2))))):
        P = jnp.minimum(
            jnp.einsum("bij,bjk->bik", P, P,
                       preferred_element_type=jnp.float32),
            1.0).astype(jnp.bfloat16)
    return P[:, :, :N].astype(jnp.float32)


def _pearson_device(prod, n1, n2, N):
    """jnp twin of branch_association._pearson_from_products."""
    import jax.numpy as jnp

    Nf = jnp.float32(N)
    r = prod - n1[:, None] * (n2[None, :] / Nf)
    d1 = jnp.sqrt((n1 / Nf) * (Nf - n1))
    d2 = jnp.sqrt((n2 / Nf) * (Nf - n2))
    denom = d1[:, None] * d2[None, :]
    r = jnp.where(denom != 0, r / jnp.where(denom == 0, 1.0, denom), r)
    r = jnp.maximum(r, 0.0)
    exact_eq = (prod == n1[:, None]) & (prod == n2[None, :])
    r = jnp.where(exact_eq, 1.0, r)
    full1 = n1[:, None] == Nf
    full2 = n2[None, :] == Nf
    r = jnp.where(full1 | full2,
                  jnp.where(full1 & full2, 1.0, 0.0), r)
    return r


def _match_pair(corr, tp, t_cl, t_cr, rp, r_cl, r_cr, nl_t, nl_r, N, M,
                compat_tab):
    """Device twin of branch_association._match_from_corr for ONE pair.

    ``compat_tab``: the host oracle's (N+1, N+1) float64-derived
    leaf-count compatibility table as a device bool constant — computing
    the limit in f32 on device can flip the strict comparison on
    borderline (c, c2, N) combinations and diverge from the differential
    oracle. Returns eq (M,) int32."""
    import jax
    import jax.numpy as jnp

    THR = jnp.float32(THRESHOLD_BRANCHEQ)
    EX = jnp.float32(EXACT)
    ar = jnp.arange(M)

    eq = jnp.full(M, -1, jnp.int32)
    eq_ref = jnp.full(M, -1, jnp.int32)

    # --- stage 1: leaves ------------------------------------------------
    li = jnp.arange(N)
    par = tp[:N]
    rpar = rp[:N]
    sib = jnp.where(t_cl[par] == li, t_cr[par], t_cl[par])
    leaf_sib = sib < N
    rsib_match = (r_cl[rpar] == sib) | (r_cr[rpar] == sib)
    cond_a = leaf_sib & rsib_match
    cond_b = ~leaf_sib & (corr[par, rpar] >= THR)
    sel = cond_a | cond_b
    leaf_val = jnp.where(sel, li, -1).astype(jnp.int32)
    eq = eq.at[li].set(leaf_val)
    eq_ref = eq_ref.at[li].set(leaf_val)
    # cond_a additionally pairs the (leaf) sibling with itself
    sib_val = jnp.where(cond_a, sib, -1).astype(jnp.int32)
    eq = eq.at[jnp.where(cond_a, sib, 0)].max(sib_val)
    eq_ref = eq_ref.at[jnp.where(cond_a, sib, 0)].max(sib_val)

    # --- stage 2: internal exact matches --------------------------------
    is_int = (ar >= N) & (ar < M - 1)
    diag_ok = is_int & (corr[ar, ar] >= EX) & (corr[tp, rp] >= EX)
    # rows without a diagonal match scan equal-leaf-count branches for the
    # lowest exactly-matching j
    pc = corr[tp][:, rp]                          # corr[tp[i], rp[j]]
    cand2 = (corr >= EX) & (pc >= EX) & (nl_t[:, None] == nl_r[None, :])
    j_first = jnp.where(cand2.any(axis=1),
                        jnp.argmin(jnp.where(cand2, ar[None, :], M),
                                   axis=1), -1).astype(jnp.int32)
    use_scan = is_int & ~diag_ok & (j_first >= 0)
    eq_int = jnp.where(diag_ok, ar.astype(jnp.int32),
                       jnp.where(use_scan, j_first, -1))
    eq = jnp.where(is_int, eq_int, eq)
    # eq_ref last-write-wins in ascending-i order == scatter max
    targets = jnp.where(diag_ok, ar,
                        jnp.where(use_scan, j_first, M))
    vals = jnp.where(diag_ok | use_scan, ar, -1).astype(jnp.int32)
    eq_ref = jnp.concatenate([eq_ref, jnp.full(1, -1, jnp.int32)])
    eq_ref = eq_ref.at[targets].max(vals)[:M]

    # --- stage 3: approximate matches, best score first ------------------
    # The host matcher walks candidates in the total order
    # lexsort((j, nl_r[j], i, -score)) and greedily assigns pairs whose
    # endpoints are still free. Greedy matching under a TOTAL order equals
    # iterated locally-dominant locking: lock every (i, j) that is the
    # order-minimal live candidate of BOTH its row and its column, remove
    # locked rows/columns, repeat. (The order-minimal global candidate is
    # always mutual-best, so each round reproduces a prefix of the greedy
    # walk; induction gives exact equality.) Each round is a handful of
    # masked (M, M) reductions — no bounded candidate lists, no 512-step
    # scan, no host fallback.
    unpaired = is_int & (eq == -1)
    # leaf-count compatibility from the precomputed f64 host table (two
    # chained row/column takes on the (N+1, N+1) constant)
    compat_ab = jnp.take(jnp.take(compat_tab, nl_t, axis=0), nl_r, axis=1)
    cand3 = ((corr >= THR) & (pc >= THR) & (eq_ref[None, :] == -1)
             & compat_ab & unpaired[:, None])
    # tie-break sentinel; row_tie < M*(M+2) always fits, so clamping at
    # int32 max keeps the argmin correct for any M
    BIGI = jnp.int32(min(2 * M * (M + 1), 2**31 - 1))
    # row tie-break key among equal scores: (nl_r[j], j); column: i
    row_tie = (nl_r * (M + 1) + ar)[None, :]

    def cond(c):
        _, _, changed = c
        return changed

    def body(c):
        eq, eq_ref, _ = c
        live = cand3 & (eq[:, None] == -1) & (eq_ref[None, :] == -1)
        s = jnp.where(live, corr, -jnp.inf)
        rmax = s.max(axis=1, keepdims=True)
        rt = live & (s == rmax)
        rbest = jnp.argmin(jnp.where(rt, row_tie, BIGI),
                           axis=1).astype(jnp.int32)
        has_r = rt.any(axis=1)
        cmax = s.max(axis=0, keepdims=True)
        ct = live & (s == cmax)
        cbest = jnp.argmin(jnp.where(ct, ar[:, None], BIGI),
                           axis=0).astype(jnp.int32)
        has_c = ct.any(axis=0)
        lock = has_r & (cbest[rbest] == ar) & has_c[rbest]
        eq2 = jnp.where(lock, rbest, eq)
        tgt = jnp.where(lock, rbest, M)
        src = jnp.where(lock, ar, -1).astype(jnp.int32)
        eq_ref2 = jnp.concatenate([eq_ref, jnp.full(1, -1, jnp.int32)])
        eq_ref2 = eq_ref2.at[tgt].max(src)[:M]
        return eq2, eq_ref2, lock.any()

    eq, eq_ref, _ = jax.lax.while_loop(
        cond, body, (eq, eq_ref, jnp.bool_(True)))
    return eq


_KERNEL_CACHE = {}


def _pair_kernel(N: int, M: int):
    """Jitted batched (leafmat -> corr -> match) program for one (N, M)."""
    key = (N, M)
    if key in _KERNEL_CACHE:
        return _KERNEL_CACHE[key]
    import jax
    import jax.numpy as jnp

    from .branch_association import _count_compat_table
    compat_tab = jnp.asarray(_count_compat_table(N))

    def kernel(parent, cl, cr):
        # parent/cl/cr: (T, M) for T = B+1 consecutive trees -> B pairs
        L = _leafmats(parent, cl, cr, N)              # (T, M, N) f32
        nl = L.sum(axis=2)                            # (T, M)
        prod = jnp.einsum("bmn,bkn->bmk", L[1:], L[:-1],
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        corr = jax.vmap(lambda p, a, b: _pearson_device(p, a, b, N))(
            prod, nl[1:], nl[:-1])

        def one(corr_k, tpk, tclk, tcrk, rpk, rclk, rcrk, nlt, nlr):
            return _match_pair(corr_k, tpk, tclk, tcrk, rpk, rclk, rcrk,
                               nlt.astype(jnp.int32),
                               nlr.astype(jnp.int32), N, M, compat_tab)

        return jax.vmap(one)(corr, parent[1:], cl[1:], cr[1:],
                             parent[:-1], cl[:-1], cr[:-1],
                             nl[1:], nl[:-1])

    k = jax.jit(kernel)
    _KERNEL_CACHE[key] = k
    return k


def branch_association_many_device(trees: List[Tree],
                                   pair_chunk: int = None
                                   ) -> List[np.ndarray]:
    """Equivalences for every adjacent pair of ``trees``, computed on
    device in ``pair_chunk``-pair batches by the exact unbounded
    while-loop matcher (no candidate buffers, no host fallback — see
    ``_match_pair``).

    The chunk is sized from device memory: each pair holds an (M, N)
    leaf matrix and an (M, M) correlation product on device
    (~100 MB/pair at N=2048, so a fixed pair count would not fit every
    card)."""
    T = len(trees)
    if T < 2:
        return []
    N = trees[0].N
    M = trees[0].num_nodes
    if pair_chunk is None:
        from ..utils.devmem import device_hbm_gb
        per_pair = 4.0 * (2 * M * N + M * M)    # leafmats + prod, f32
        budget = device_hbm_gb() * 1e9 * 0.25
        pair_chunk = int(max(2, min(256, budget / max(per_pair, 1.0))))
    kernel = _pair_kernel(N, M)
    parent = np.stack([t.parent for t in trees]).astype(np.int32)
    cl = np.stack([t.child_left for t in trees]).astype(np.int32)
    cr = np.stack([t.child_right for t in trees]).astype(np.int32)

    eqs: List[np.ndarray] = []
    # pad the last chunk to the chunk size so at most two shapes compile
    for s in range(0, T - 1, pair_chunk):
        e = min(s + pair_chunk, T - 1)
        n = e - s
        idx = np.arange(s, s + pair_chunk + 1)
        idx = np.minimum(idx, T - 1)
        eq = np.asarray(kernel(parent[idx], cl[idx], cr[idx]))[:n]
        eqs.extend(eq[k] for k in range(n))
    return eqs
