"""Smoothed-aggregation algebraic multigrid (SA-AMG).

From-scratch replacement for PETSc GAMG and Hypre BoomerAMG (reference
solver configs: README.md:63-146 — GAMG with Chebyshev+Jacobi level
smoothers, coarse_eq_limit 1000, rigid-body near-nullspace for
elasticity; BoomerAMG for Poisson.  SA-AMG is the documented functional
equivalent for both paths, per SURVEY.md E18/E19).

Split of labor:
- **setup on host** (numpy/scipy, float64): strength graph, randomized
  parallel (Luby-style) aggregation, tentative prolongator via batched
  per-aggregate QR of the near-nullspace, Jacobi-smoothed P, Galerkin
  triple product, power-iteration eigenvalue estimates, dense coarse
  inverse;
- **V-cycle on device** (jitted, static shapes): padded-ELL SpMVs,
  Chebyshev/Jacobi smoothing, restriction/prolongation as ELL matvecs,
  coarse solve as a dense matmul.  The whole preconditioner traces into
  the CG ``lax.while_loop``, so a full solve is ONE device dispatch.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

logger = logging.getLogger("tpufem")

from tpufem.fem.assemble import ELLMatrix, csr_to_ell
from tpufem.la.chebyshev import (chebyshev_smoother,
                                 chebyshev_smoother_zero,
                                 power_iteration_lmax)


# ---------------------------------------------------------------------------
# Strength of connection + aggregation
# ---------------------------------------------------------------------------


def node_strength_graph(A: sp.csr_matrix, bs: int, theta: float) -> sp.csr_matrix:
    """Node-level symmetric strength graph (no self loops).

    Scalar: strong if |a_ij| > theta * sqrt(a_ii a_jj).  Blocked: blocks
    condensed by max-abs before thresholding.
    """
    if bs > 1:
        coo = A.tocoo()
        rows = (coo.row // bs).astype(np.int64)
        cols = (coo.col // bs).astype(np.int64)
        vals = np.abs(coo.data)
        n = A.shape[0] // bs
        # condense each bs*bs block by max-abs (sorted-key reduceat)
        key = rows * n + cols
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        starts = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
        mx = np.maximum.reduceat(vals[order], starts)
        uk = key_s[starts]
        S = sp.coo_matrix((mx, (uk // n, uk % n)), shape=(n, n)).tocsr()
    else:
        # copy index arrays: in-place ops below (setdiag/eliminate_zeros)
        # must not corrupt the caller's matrix
        S = sp.csr_matrix((np.abs(A.data), A.indices.copy(), A.indptr.copy()),
                          shape=A.shape)
    d = S.diagonal()
    d = np.where(d > 0, d, 1.0)
    if theta > 0.0:
        coo = S.tocoo()
        keep = np.abs(coo.data) > theta * np.sqrt(d[coo.row] * d[coo.col])
        S = sp.coo_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])),
                          shape=S.shape).tocsr()
    S.setdiag(0.0)
    S.eliminate_zeros()
    # No explicit symmetrize: the operators here are SPD (CG requires
    # it) and the strength criterion |a_ij| > theta sqrt(a_ii a_jj) is
    # symmetric in (i, j), so S inherits A's symmetric pattern; a
    # csr_maximum_csr pass measured 1.5 s at 500k and changed nothing.
    # (Aggregation below is also correct for a mildly asymmetric S.)
    return S


def _segment_max(vals: np.ndarray, indptr: np.ndarray, default: float) -> np.ndarray:
    n = indptr.shape[0] - 1
    out = np.full(n, default)
    nnz = np.diff(indptr)
    ne = np.flatnonzero(nnz > 0)
    if ne.size:
        out[ne] = np.maximum.reduceat(vals, indptr[ne])
    return out


def aggregate_nodes(S: sp.csr_matrix, seed: int = 0,
                    max_rounds: int = 64) -> Tuple[np.ndarray, int]:
    """Vanek-Mandel-Brezina aggregation, randomized by ``seed``.

    Production path: one greedy serial pass in C++
    (tpufem.native.aggregate_vmb — visiting nodes in a seeded random
    order, phase-2 attach by strongest connection; ~0.1 s at 500k where
    the numpy rounds below took 13 s on the 1-vCPU host).  Fallback
    when the native build is unavailable: vectorized Luby-style
    randomized-MIS rounds — same root-eligibility rule, so aggregate
    statistics (and AMG iteration counts) are equivalent, not
    bit-identical.  Deterministic for a fixed seed either way.
    Returns (agg [n] int64, num_aggregates).
    """
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)

    from tpufem import native
    got = native.aggregate_vmb(indptr, indices, S.data, perm)
    if got is not None:
        return got

    prio = perm.astype(np.float64)
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0
    # invariants hoisted out of the rounds (each an O(nnz) pass that
    # dominated aggregation time at 500k when rebuilt per round)
    nnz = np.diff(indptr)
    rows_of_nnz = np.repeat(np.arange(n), nnz)
    prio_nnz = prio[indices]
    ne = np.flatnonzero(nnz > 0)
    starts = indptr[ne]

    def seg_max(vals: np.ndarray, default: float) -> np.ndarray:
        out = np.full(n, default)
        if ne.size:
            out[ne] = np.maximum.reduceat(vals, starts)
        return out

    for _ in range(max_rounds):
        cand = agg < 0
        if not cand.any():
            break
        # VMB phase-1 eligibility: the whole strong neighborhood is still
        # unaggregated (nodes bordering an aggregate wait for phase 2)
        agg_nb = agg[indices] >= 0
        has_agg_nb = np.zeros(n, dtype=bool)
        if ne.size:
            has_agg_nb[ne] = np.maximum.reduceat(
                agg_nb.view(np.uint8), starts) > 0
        elig = cand & ~has_agg_nb
        if not elig.any():
            break
        # neighbor priorities among eligible competitors
        nb_p = np.where(elig[indices], prio_nnz, -1.0)
        nmax = seg_max(nb_p, -1.0)
        roots = elig & (prio > nmax)
        nroots = int(roots.sum())
        if nroots == 0:
            break
        root_ids = np.flatnonzero(roots)
        agg[root_ids] = nagg + np.arange(nroots)
        nagg += nroots
        # unaggregated nodes with a root neighbor join the max-priority root
        cand = agg < 0
        rp = np.where(roots[indices], prio_nnz, -1.0)
        rmax = seg_max(rp, -1.0)
        join = cand & (rmax >= 0.0)
        if join.any():
            # find, per joining row, the nnz whose col is that max root
            rows = rows_of_nnz
            hit = (rp == rmax[rows]) & roots[indices] & join[rows]
            # first hit per row wins
            first = np.zeros(n, dtype=np.int64)
            idx = np.flatnonzero(hit)
            # reverse so earlier nnz overwrite later ones
            first[rows[idx[::-1]]] = indices[idx[::-1]]
            agg[np.flatnonzero(join)] = agg[first[np.flatnonzero(join)]]

    # phase 2: attach stragglers to any aggregated neighbor
    for _ in range(4):
        agg_nnz = agg[indices]
        cand = agg < 0
        if not cand.any():
            break
        ap = np.where(agg_nnz >= 0, prio_nnz, -1.0)
        amax = seg_max(ap, -1.0)
        join = cand & (amax >= 0.0)
        if not join.any():
            break
        rows = rows_of_nnz
        hit = (ap == amax[rows]) & (agg_nnz >= 0) & join[rows]
        first = np.zeros(n, dtype=np.int64)
        idx = np.flatnonzero(hit)
        first[rows[idx[::-1]]] = indices[idx[::-1]]
        agg[np.flatnonzero(join)] = agg[first[np.flatnonzero(join)]]

    # phase 3: isolated leftovers become singletons
    left = np.flatnonzero(agg < 0)
    if left.size:
        agg[left] = nagg + np.arange(left.size)
        nagg += left.size
    return agg, nagg


def match_pairs(S2: sp.csr_matrix, rounds: int = 8) -> np.ndarray:
    """Mutual-heaviest-edge matching on a weighted graph (vectorized,
    deterministic).  Returns a dense relabeling ``pair[i]``: matched
    nodes share a label, unmatched nodes keep singleton labels.

    Used for aggressive AMG coarsening: merging aggregate PAIRS halves
    a level's size with only a mild interpolation-quality cost (unlike
    full distance-2 composition).  Edge weights are the inter-aggregate
    strength sums, so the merge follows the strongest couplings."""
    n = S2.shape[0]
    indptr, indices, data = S2.indptr, S2.indices, S2.data
    rows = np.repeat(np.arange(n), np.diff(indptr))
    mate = np.full(n, -1, dtype=np.int64)
    for _ in range(rounds):
        un = mate < 0
        if not un.any():
            break
        # heaviest still-unmatched neighbor of each unmatched node
        w = np.where(un[indices] & un[rows], data, -np.inf)
        mx = _segment_max(w, indptr, -np.inf)
        prop = np.full(n, -1, dtype=np.int64)
        hit = np.isfinite(w) & (w == mx[rows])
        idx = np.flatnonzero(hit)
        # reverse so the LOWEST column index wins ties (deterministic)
        prop[rows[idx[::-1]]] = indices[idx[::-1]]
        valid = prop >= 0
        p = np.where(valid, prop, 0)
        mutual = valid & (prop[p] == np.arange(n))
        i = np.flatnonzero(mutual & (np.arange(n) < prop))
        if i.size == 0:
            break
        mate[i] = prop[i]
        mate[prop[i]] = i
    root = np.where(mate >= 0, np.minimum(np.arange(n), mate),
                    np.arange(n))
    _, pair = np.unique(root, return_inverse=True)
    return pair.astype(np.int64)


# ---------------------------------------------------------------------------
# Tentative + smoothed prolongator
# ---------------------------------------------------------------------------


def tentative_prolongator(agg: np.ndarray, nagg: int, B: np.ndarray,
                          bs: int) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Per-aggregate QR fit of the near-nullspace.

    B: [ndofs, m] fine-level near-nullspace (columns).  Returns
    (P0 [ndofs, nagg*m] CSR, Bc [nagg*m, m] coarse near-nullspace).
    Rank-deficient aggregates (fewer rows than m) get dependent columns
    zeroed; the resulting inert coarse dofs are fixed up in the Galerkin
    product (unit diagonal).
    """
    ndofs, m = B.shape
    nnode = ndofs // bs
    order = np.argsort(agg, kind="stable")
    counts = np.bincount(agg, minlength=nagg)
    maxn = int(counts.max())
    # padded gather of each aggregate's dof rows of B
    pad_nodes = np.zeros((nagg, maxn), dtype=np.int64)
    rowmask = np.zeros((nagg, maxn), dtype=bool)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(nnode) - starts[agg[order]]
    pad_nodes[agg[order], pos] = order
    rowmask[agg[order], pos] = True
    # expand to scalar dofs: [nagg, maxn*bs]
    dofs = (pad_nodes[..., None] * bs + np.arange(bs)).reshape(nagg, maxn * bs)
    rmask = np.repeat(rowmask, bs, axis=1)
    blocks = B[dofs] * rmask[..., None]  # [nagg, rows, m]
    Q, R = np.linalg.qr(blocks)  # batched reduced QR
    Q = Q * rmask[..., None]
    # rank detection from R's diagonal (QR of a zero block still returns a
    # unit Q, so Q norms cannot detect dead aggregates — e.g. singleton
    # BC dofs whose nullspace rows were zeroed)
    rdiag = np.abs(np.diagonal(R, axis1=1, axis2=2))  # [nagg, m]
    scale = np.maximum(rdiag.max(axis=1, keepdims=True), 1e-300)
    bad = (rdiag < 1e-8 * scale) | (rdiag < 1e-12)
    if bad.any():
        Q = np.where(bad[:, None, :], 0.0, Q)
        R = np.where(bad[:, :, None], 0.0, R)
    # fully-dead aggregates (e.g. singleton BC dofs whose nullspace rows
    # are zeroed) are DROPPED — carrying them through every coarser level
    # stalls coarsening.  Partially-deficient aggregates keep all m
    # columns (zeroed where dead) so coarse levels retain clean m-blocks.
    keep_agg = ~bad.all(axis=1)  # [nagg]
    keep = np.repeat(keep_agg, m)  # [nagg * m]
    ncoarse = int(keep.sum())
    colmap = np.cumsum(keep) - 1  # old coarse dof -> new (valid where keep)

    rows = dofs.reshape(-1)
    cols = ((np.arange(nagg)[:, None, None] * m + np.arange(m)[None, None, :])
            * np.ones((1, maxn * bs, 1), dtype=np.int64))
    vals = Q  # [nagg, rows, m]
    mask = np.repeat(rmask.reshape(-1), m) & keep[cols.reshape(-1)]
    rows = np.repeat(rows, m)[mask]
    cols = colmap[cols.reshape(-1)[mask]]
    data = vals.reshape(-1)[mask]
    P0 = sp.coo_matrix((data, (rows, cols)), shape=(ndofs, ncoarse)).tocsr()
    Bc = R.reshape(nagg * m, m)[keep]
    return P0, Bc


def smooth_prolongator(A: sp.csr_matrix, P0: sp.csr_matrix,
                       damping: float, lmax: float,
                       filter_k: int = 0) -> sp.csr_matrix:
    """P = (I - omega D^-1 A) P0 with omega = damping / lmax(D^-1 A)
    (classic SA Jacobi prolongator smoothing).

    ``filter_k > 0`` keeps only the k largest-magnitude entries per row
    and LUMPS the dropped mass by rescaling the survivors to the
    original row sum (preserves interpolation of constants).
    Rationale: transfer matvecs are random-gather bound; the full
    smoothed P carries ~11 entries/row whose tail adds almost nothing —
    measured iteration counts at 69k dofs:
    k=11: 15, k=6: 15, k=4: 16, k=3: 18.  The PETSc-GAMG analogue knob
    is -pc_gamg_threshold row filtering.

    SCALAR nullspaces only: row-sum lumping preserves interpolation of
    the constant vector and nothing else, so for a multi-column
    near-nullspace (elasticity: 6 rigid modes) top-k filtering destroys
    rotation interpolation and SA convergence with it — measured on the
    clamped-cube P1 elasticity operator at 10k dofs: 15 CG+AMG
    iterations unfiltered vs 73/67/63/54 at k=4/6/8/12.  Callers must
    pass filter_k=0 when the nullspace has more than one column
    (SAAMG.setup enforces this)."""
    d = A.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    omega = damping / lmax
    DinvA = sp.diags(dinv) @ A
    P = (P0 - omega * (DinvA @ P0)).tocsr()
    if filter_k <= 0:
        return P
    return _filter_rows_topk(P, filter_k)


def _filter_rows_topk(P: sp.csr_matrix, k: int) -> sp.csr_matrix:
    """Keep the k largest-|.| entries per row, rescaling survivors to
    the original row sum (vectorized; no-op when rows already fit)."""
    nnz = np.diff(P.indptr)
    maxk = int(nnz.max()) if nnz.size else 0
    if maxk <= k:
        return P
    n = P.shape[0]
    cols = np.zeros((n, maxk), dtype=np.int64)
    vals = np.zeros((n, maxk))
    rows = np.repeat(np.arange(n), nnz)
    pos = np.arange(P.indices.size) - np.repeat(P.indptr[:-1], nnz)
    cols[rows, pos] = P.indices
    vals[rows, pos] = P.data
    order = np.argsort(-np.abs(vals), axis=1)[:, :k]
    vk = np.take_along_axis(vals, order, axis=1)
    ck = np.take_along_axis(cols, order, axis=1)
    tot = vals.sum(axis=1)
    sk = vk.sum(axis=1)
    # lump dropped mass into the survivors (guarded against
    # near-cancelling rows where rescaling would amplify)
    safe = np.abs(sk) > 0.1 * np.abs(tot)
    scale = np.where(safe, tot / np.where(sk == 0.0, 1.0, sk), 1.0)
    vk = vk * scale[:, None]
    keep = vk != 0.0
    out_rows = np.repeat(np.arange(n), k)[keep.reshape(-1)]
    return sp.coo_matrix((vk.reshape(-1)[keep.reshape(-1)],
                          (out_rows, ck.reshape(-1)[keep.reshape(-1)])),
                         shape=P.shape).tocsr()


def _csr_rows_padded(P0: sp.csr_matrix, m: int):
    """Tentative-prolongator rows as padded [n, m] (cols, vals) arrays —
    each fine dof touches at most the m coarse dofs of its aggregate
    (zero-padded; dropped aggregates give all-zero rows on col 0)."""
    n = P0.shape[0]
    nnz = np.diff(P0.indptr)
    if nnz.size and nnz.max() > m:
        raise ValueError("tentative prolongator row exceeds m entries")
    cols = np.zeros((n, m), dtype=np.int32)
    vals = np.zeros((n, m))
    rows = np.repeat(np.arange(n), nnz)
    pos = np.arange(P0.indices.size) - np.repeat(P0.indptr[:-1], nnz)
    cols[rows, pos] = P0.indices
    vals[rows, pos] = P0.data
    return cols, vals


# ---------------------------------------------------------------------------
# Hierarchy
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DenseMat:
    """Dense operator for SMALL coarse levels: one matmul replaces a
    gather-bound ELL SpMV.

    When the solve dtype is f32, the matrix is STORED bf16 with f32
    accumulation: the matvec is bandwidth-bound on the matrix bytes, so
    this halves its cost.  The operator stays a fixed symmetric linear
    map (bf16 rounding is entrywise), which is all a Chebyshev-smoothed
    V-cycle level needs — the CG convergence criterion still runs on
    the full-precision fine residual."""

    M: jnp.ndarray

    def tree_flatten(self):
        return (self.M,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.M.dtype == jnp.bfloat16:
            y = jnp.matmul(self.M, x.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
            return y.astype(x.dtype)
        return jnp.matmul(self.M, x)


def _densify_csr(Al: sp.csr_matrix, n: int, ddt) -> jnp.ndarray:
    """Dense [n, n] device matrix scattered directly from the CSR
    triplets: ships nnz*(val+row+col) bytes to the device — no
    padded-ELL intermediate (whose K_max padding tripled the upload at
    wide coarse levels) and no host ``toarray()`` (GB-scale transient +
    scalar-wise ml_dtypes bf16 cast).  Compiled through the AOT cache
    (tpufem.aot), so later processes load it from the persistent cache
    instead of compiling one program per level shape."""
    from tpufem.aot import compile_aot_cached
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(Al.indptr))
    vdt = np.float32 if ddt == jnp.bfloat16 else np.dtype(ddt)
    args = (jnp.asarray(rows),
            jnp.asarray(Al.indices.astype(np.int32)),
            jnp.asarray(Al.data.astype(vdt)))

    def make():
        def go(r, c, v):
            M = jnp.zeros((n, n), v.dtype).at[r, c].add(v)
            return M.astype(ddt)
        return go

    key = ("amg_densify", n, int(Al.nnz), np.dtype(vdt).str, str(ddt))
    return compile_aot_cached(key, make, *args)(*args)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class _Level:
    A: ELLMatrix                # or DenseMat (small levels)
    P: Optional[ELLMatrix]      # fine <- coarse (None in factored form)
    PT: Optional[ELLMatrix]     # coarse <- fine (None in factored form)
    dinv: jnp.ndarray
    lmax: float                 # static (baked into Chebyshev coefficients)
    # factored smoothed-transfer form (fine level only, see setup):
    # P = (I - omega D^-1 A) P0 applied as tentative-gather + one extra
    # operator action instead of a fine-size ELL SpMV.
    fw: Optional[jnp.ndarray] = None        # [n, m] P0 row weights
    fcols: Optional[jnp.ndarray] = None     # [n, m] P0 row cols (int32)
    omega_dinv: Optional[jnp.ndarray] = None  # [n] omega * dinv

    def tree_flatten(self):
        return ((self.A, self.P, self.PT, self.dinv,
                 self.fw, self.fcols, self.omega_dinv), self.lmax)

    @classmethod
    def tree_unflatten(cls, lmax, children):
        A, P, PT, dinv, fw, fcols, odinv = children
        return cls(A, P, PT, dinv, lmax, fw, fcols, odinv)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SAAMG:
    levels: List[_Level]
    coarse_inv: jnp.ndarray     # dense [nc, nc]
    smoother_degree: int
    level_sizes: List[int]

    def tree_flatten(self):
        return (self.levels, self.coarse_inv), (self.smoother_degree,
                                                tuple(self.level_sizes))

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, coarse_inv = children
        degree, sizes = aux
        return cls(list(levels), coarse_inv, degree, list(sizes))

    @classmethod
    def setup(cls, csr_tuple, bs: int, options, dtype=jnp.float32,
              near_nullspace: Optional[np.ndarray] = None,
              bc_mask: Optional[np.ndarray] = None,
              fine_factored: bool = False,
              fine_store_a: bool = True,
              fine_transfer_window: bool = False) -> "SAAMG":
        """``fine_factored=True`` stores the FINE level's smoothed
        transfers in factored form, P = (I - omega D^-1 A) P0: the
        vcycle applies the tentative P0 (one m-wide gather / scatter-add
        per dof) plus one extra fine operator action, instead of
        fine-size ELL SpMVs.  Worth it exactly when the fine operator
        action is gather-free (the matrix-free stencil paths, where the
        per-iteration cost is dominated by the random gathers of the
        full smoothed P/PT).  The factored
        apply is EXACT in exact arithmetic, so level-0 smoothing skips
        the top-k row filter and the Galerkin product uses the same
        unfiltered P.

        PRECISION CAVEAT: at run time the factored P and P^T evaluate
        (I - omega D^-1 A) with fresh f32 operator actions, so they are
        adjoint only to f32 rounding — fine on well-scaled operators
        (the cube stencils), but on the spoke mesh's wildly-scaled
        entries (cell volumes span ~6 orders) the asymmetry makes the
        V-cycle non-SPD and PCG diverges outright (measured rel 3.8
        after 100 its vs 8e-7 with assembled transfers over the SAME
        hierarchy).  Unstructured callers use assembled transfers with
        ``fine_store_a=False`` instead.

        ``fine_store_a=False`` (with assembled transfers) skips
        building/uploading the fine level's own ELL operator when the
        caller always passes ``fine_matvec`` to :meth:`vcycle` — at
        500k that is ~60 MB of uploads and seconds of host padding for
        an operator never applied.

        ``fine_transfer_window=True`` stores the fine level's assembled
        P/PT as block-windowed operators (fem.window_op) instead of ELL
        and renumbers aggregates along the fine (RCM) order so the
        windows are narrow — the exact, symmetric, gather-free fast
        path for unstructured meshes where the factored form's f32
        asymmetry diverges (see the caveat above)."""
        indptr, indices, data = csr_tuple
        if data.ndim == 3:  # block CSR -> scalar CSR
            nb = indptr.shape[0] - 1
            A = sp.bsr_matrix((data, indices, indptr),
                              shape=(nb * bs, nb * bs)).tocsr()
        else:
            A = sp.csr_matrix((data, indices, indptr))
        n = A.shape[0]

        theta = float(options.get("amg_strength_threshold"))
        coarse_limit = int(options.get("amg_coarse_eq_limit"))
        max_levels = int(options.get("amg_max_levels"))
        damping = float(options.get("amg_prolongator_damping"))
        degree = int(options.get("amg_smoother_degree"))
        dense_limit = int(options.get("amg_dense_level_limit", 32768))
        filter_k = int(options.get("amg_filter_k", 4))
        agg_levels = int(options.get("amg_aggressive_levels", 1))
        if near_nullspace is not None and near_nullspace.shape[0] > 1 \
                and filter_k > 0:
            # top-k + row-sum lumping preserves constants only; with a
            # multi-column nullspace (rigid modes) it breaks rotation
            # interpolation and costs ~4-5x the iterations (see
            # smooth_prolongator).  The wider unfiltered transfers are
            # strictly cheaper than the extra V-cycles.
            logger.info("SA-AMG: prolongator top-k filter disabled "
                        "(near-nullspace has %d columns)",
                        near_nullspace.shape[0])
            filter_k = 0

        if near_nullspace is None:
            B = np.ones((n, 1))
        else:
            B = np.ascontiguousarray(near_nullspace.T)  # [ndofs, m]
        if bc_mask is not None:
            # BC rows are identity; zero the candidate rows there so the
            # prolongator never interpolates into constrained dofs
            flat = np.repeat(bc_mask, bs) if bc_mask.shape[0] * bs == n else bc_mask
            B = B * (~flat)[:, None]

        levels: List[_Level] = []
        sizes = [n]
        lvl_bs = bs
        Al = A
        ph = {"eig": 0.0, "strength": 0.0, "aggregate": 0.0,
              "tentative": 0.0, "smoothP": 0.0, "galerkin": 0.0,
              "device": 0.0}
        t_total = time.perf_counter()

        def _tick(key, t0):
            ph[key] += time.perf_counter() - t0
            return time.perf_counter()

        while Al.shape[0] > coarse_limit and len(levels) < max_levels - 1:
            t0 = time.perf_counter()
            d = Al.diagonal()
            dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
            lmax = power_iteration_lmax(lambda v: Al @ v, dinv, Al.shape[0])
            t0 = _tick("eig", t0)
            S = node_strength_graph(Al, lvl_bs, theta)
            t0 = _tick("strength", t0)
            agg, nagg = aggregate_nodes(S, seed=len(levels))
            if len(levels) < agg_levels and nagg > 4 * coarse_limit:
                # aggressive coarsening: pairwise (mutual-heaviest
                # matching) merge of the aggregates — the SA analogue
                # of BoomerAMG's agg_nl (the reference runs
                # -pc_hypre_boomeramg_agg_nl 4,
                # README.md:125,143 of the reference).  This keeps
                # every coarse level inside the dense regime instead of
                # a 34k-row gather-bound ELL level 1.
                # (Full distance-2 composition measured +73% CG
                # iterations at 216k; pairwise costs a few percent.)
                nnode = S.shape[0]
                Agg = sp.csr_matrix(
                    (np.ones(nnode), (np.arange(nnode), agg)),
                    shape=(nnode, nagg))
                S2 = ((Agg.T @ S @ Agg).tocsr())
                S2.setdiag(0.0)
                S2.eliminate_zeros()
                pair = match_pairs(S2)
                agg, nagg = pair[agg], int(pair.max()) + 1
            if fine_transfer_window and len(levels) == 0:
                # renumber aggregates by first fine-node appearance: in
                # RCM fine order this clusters each row-block's coarse
                # columns into a handful of 128-blocks, which is what
                # makes the windowed transfer form narrow (W ~ 2) —
                # a pure coarse-level permutation, algebra unchanged
                first = np.full(nagg, np.iinfo(np.int64).max)
                np.minimum.at(first, agg, np.arange(agg.shape[0]))
                order = np.argsort(first, kind="stable")
                remap = np.empty(nagg, dtype=agg.dtype)
                remap[order] = np.arange(nagg, dtype=agg.dtype)
                agg = remap[agg]
            t0 = _tick("aggregate", t0)
            P0, Bc = tentative_prolongator(agg, nagg, B, lvl_bs)
            if P0.shape[1] == 0 or P0.shape[1] >= Al.shape[0]:
                break  # no useful coarsening possible
            t0 = _tick("tentative", t0)
            factored = fine_factored and len(levels) == 0
            P = smooth_prolongator(Al, P0, damping, lmax,
                                   filter_k=0 if factored else filter_k)
            t0 = _tick("smoothP", t0)
            Ac = (P.T @ Al @ P).tocsr()
            Ac.sum_duplicates()
            # inert coarse dofs (rank-deficient aggregates): unit diagonal
            dc = Ac.diagonal()
            dead = np.flatnonzero(dc == 0.0)
            if dead.size:
                Ac = Ac + sp.coo_matrix(
                    (np.ones(dead.size), (dead, dead)), shape=Ac.shape)
                Ac = Ac.tocsr()

            PT = P.T.tocsr()
            t0 = _tick("galerkin", t0)
            # densification guard: a level just under dense_limit rows
            # would otherwise allocate rows^2 floats silently (16384^2
            # f32 = 1 GiB on device + a f64 host transient); cap the
            # dense form by bytes and log the conversion
            nrows = Al.shape[0]
            store_item = 2 if np.dtype(dtype) == np.float32 else \
                np.dtype(dtype).itemsize  # f32 levels store bf16
            dense_bytes = nrows * nrows * store_item
            use_dense = (nrows <= dense_limit
                         and dense_bytes <= 1536 * 1024 * 1024)
            if use_dense:
                logger.info(
                    "AMG level %d (%d rows) densified for dense matvecs "
                    "(%.1f MiB device)", len(levels) + 1, nrows,
                    dense_bytes / 2**20)
            # densify ON DEVICE from the sparse form: a host toarray at
            # 18k rows is a 1.3 GiB transient and the host f32->bf16
            # elementwise cast measured ~11 s (ml_dtypes converts
            # scalar-wise); scattering the ~MB-scale ELL data into a
            # device-allocated dense block and casting there ships 100x
            # fewer bytes.  f32 solves store the level bf16 (see DenseMat)
            ddt = jnp.bfloat16 if np.dtype(dtype) == np.float32 else dtype
            if factored or (len(levels) == 0 and not fine_store_a):
                # this fine level never applies its own assembled
                # operator (vcycle requires fine_matvec); skip the ELL
                # build + device upload entirely — at 500k that is ~60 MB
                # of uploads and seconds of host padding
                A_dev = None
            elif use_dense:
                A_dev = DenseMat(_densify_csr(Al, nrows, ddt))
            else:
                # k_cap only on the FINE level: coarser ELL levels may be
                # read raw (.cols/.vals) by the rowshard distributor
                A_dev = csr_to_ell(Al.indptr, Al.indices, Al.data,
                                   dtype=dtype,
                                   k_cap="auto" if len(levels) == 0
                                   else None)
            if factored:
                m = B.shape[1]
                fc, fv = _csr_rows_padded(P0, m)
                levels.append(_Level(
                    A=A_dev, P=None, PT=None,
                    dinv=jnp.asarray(dinv, dtype=dtype),
                    lmax=lmax,
                    fw=jnp.asarray(fv.astype(np.dtype(dtype))),
                    fcols=jnp.asarray(fc),
                    omega_dinv=jnp.asarray(
                        ((damping / lmax) * dinv).astype(np.dtype(dtype))),
                ))
            else:
                P_dev = PT_dev = None
                if fine_transfer_window and len(levels) == 0:
                    # windowed (gather-free) transfer matvecs on the
                    # fine level in place of P's ELL gather (~11
                    # entries/row, 2 fine-size gathers per V-cycle).
                    # With aggregates renumbered along the RCM fine order
                    # (above), the windows are narrow and the
                    # dense-window sweep streams.  WindowedMatrix duck-types
                    # .matvec, so vcycle is unchanged.
                    from tpufem.fem.window_op import WindowedMatrix
                    # transfer windows share the caller-visible window
                    # byte budget (-amg_window_budget_mb, default 4096):
                    # 3/8 for P (fine rows x few coarse blocks), 1/8 for
                    # PT — the fine operator's own window is budgeted by
                    # its caller against the same knob
                    wb = int(options.get("amg_window_budget_mb",
                                         4096)) * 2**20
                    P_dev = WindowedMatrix.from_csr(
                        P.indptr, P.indices, P.data, dtype=dtype,
                        ncols=P.shape[1],
                        budget_bytes=3 * wb // 8)
                    PT_dev = WindowedMatrix.from_csr(
                        PT.indptr, PT.indices, PT.data, dtype=dtype,
                        ncols=PT.shape[1],
                        budget_bytes=wb // 8)
                levels.append(_Level(
                    A=A_dev,
                    P=(P_dev if P_dev is not None else
                       csr_to_ell(P.indptr, P.indices, P.data,
                                  dtype=dtype)),
                    PT=(PT_dev if PT_dev is not None else
                        csr_to_ell(PT.indptr, PT.indices, PT.data,
                                   dtype=dtype)),
                    dinv=jnp.asarray(dinv, dtype=dtype),
                    lmax=lmax,
                ))
            _tick("device", t0)
            Al = Ac
            B = Bc
            lvl_bs = B.shape[1]  # coarse levels carry m dofs per aggregate
            sizes.append(Al.shape[0])

        # dense coarse solve, applied as a matmul on device.  Eigen-cutoff
        # PSEUDO-inverse instead of a plain inverse: a singular operator
        # (the pure-Neumann spoke problem, PARITY.md) Galerkin-coarsens
        # to a coarse matrix with a ~1e-15-relative nullspace eigenvalue,
        # and inverting it amplifies the constant mode by ~1e15 — the
        # deflated f32 solve then drowns in cancellation noise.  Zeroing
        # 1/lambda below the cutoff leaves the V-cycle inert on those
        # modes (deflation handles them); for nonsingular systems the
        # cutoff is far below the true spectrum and this equals inv.
        Ad = Al.toarray()
        Ad = 0.5 * (Ad + Ad.T)
        evals, evecs = np.linalg.eigh(Ad)
        tau = 1e-9 * max(float(np.abs(evals).max()), 1e-300)
        inv_evals = np.where(np.abs(evals) > tau, 1.0 / evals, 0.0)
        coarse_inv = jnp.asarray((evecs * inv_evals) @ evecs.T, dtype=dtype)
        logger.info(
            "SA-AMG setup %.2fs: levels %s | %s", time.perf_counter() - t_total,
            sizes, " ".join(f"{k} {v:.2f}s" for k, v in ph.items() if v > 0.005))
        # expose the split for benchmarking: 'device' is uploads + XLA
        # compile of the densify program; the rest is host setup math
        cls.last_phase_s = dict(ph, total=time.perf_counter() - t_total)
        return cls(levels=levels, coarse_inv=coarse_inv,
                   smoother_degree=degree, level_sizes=sizes)

    # -- device V-cycle -------------------------------------------------------
    def vcycle(self, r: jnp.ndarray, i: int = 0,
               fine_matvec: Optional[Callable] = None) -> jnp.ndarray:
        """One V(1,1) cycle; traceable (self may be a jit argument).

        ``fine_matvec`` optionally replaces the finest level's ELL SpMV
        with a caller-supplied operator action (e.g. the constant-stencil
        DiaOperator on the cube path — numerically the same matrix, but
        gather-free; the matrix-free-fine / assembled-coarse split
        standard AMG frameworks offer)."""
        if i == len(self.levels):
            return jnp.matmul(self.coarse_inv, r)
        lv = self.levels[i]
        if i == 0 and fine_matvec is not None:
            mv = fine_matvec
        else:
            if lv.A is None:
                raise ValueError(
                    "fine level stores no assembled operator; pass "
                    "fine_matvec to vcycle (setup ran with "
                    "fine_factored=True or fine_store_a=False)")
            mv = lv.A.matvec
        smooth = chebyshev_smoother(mv, lv.dinv, lv.lmax,
                                    degree=self.smoother_degree)
        smooth0 = chebyshev_smoother_zero(mv, lv.dinv, lv.lmax,
                                          degree=self.smoother_degree)
        # residual-tracking pre-smoothing from zero: one scanned matvec
        # instance + the closing residual in the lowered program
        x, rr = smooth0(r)
        if lv.fw is not None:
            # factored transfers: PT r = P0^T (r - omega A dinv r),
            # P xc = y - omega dinv A y with y = P0 xc — two extra
            # fine operator actions instead of two fine-size ELL SpMVs
            v = rr - mv(lv.omega_dinv * rr)
            rc = jnp.zeros(self.level_sizes[i + 1], dtype=r.dtype).at[
                lv.fcols].add(lv.fw * v[:, None])
            xc = self.vcycle(rc, i + 1)
            y = jnp.sum(lv.fw * xc[lv.fcols], axis=-1)
            x = x + y - lv.omega_dinv * mv(y)
        else:
            rc = lv.PT.matvec(rr)
            xc = self.vcycle(rc, i + 1)
            x = x + lv.P.matvec(xc)
        return smooth(x, r)

    def as_preconditioner(self) -> Callable[[jnp.ndarray], jnp.ndarray]:
        return self.vcycle
