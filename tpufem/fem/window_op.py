"""Block-windowed sparse operator: an opt-in gather-free SpMV form.

The reference's unstructured path hands PETSc a MatAIJ (reference
``src/poisson_problem.cpp`` assembles into PETSc CSR; the spoke-mesh CI
jobs at ``ccpp.yml:102-117`` solve it with CG+AMG).  The default here is
the capped-K ELL SpMV of ``fem.assemble``.  This module stores the SAME
matrix so that the hot loop reads whole column blocks instead of single
entries:

- Rows are grouped into blocks of ``R`` (default 16); columns into
  blocks of ``C`` = 128.
- For each row-block, the set of distinct column-blocks its entries
  touch is recorded (``blk_idx``, [nb, W]).  After reverse-Cuthill-McKee
  ordering a 3-D P1 row-block touches ~6 column-blocks (p90 ≈ 9).
- Values are stored DENSE within the window: ``vals[nb, R, W*C]`` with
  zeros elsewhere.  The matvec is then

      xg = x.reshape(nc, C)[blk_idx]           # gather of whole blocks
      y  = einsum('brk,bk->br', vals, xg)      # one streaming pass

  Entries falling outside the W widest windows spill into an exact COO
  tail (same scheme as ``ELLMatrix``'s capped-K overflow).

The price is memory and bytes: the windowed values are ~30x the ELL
form's.  On an H100 the ELL SpMV of the 150k spoke matrix is ~18x
faster per apply than this form (PERF.md, bring-up findings), so the
form is opt-in (``-amg_fine_window on``) with a fixed width.

Construction never materializes the dense values on the host: the host
computes one int32 destination index per nonzero and a single jitted
scatter builds the buffer on the device (~16 MB shipped for a 150k-dof
operator instead of ~700 MiB).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# window width W of the opt-in form; entries beyond a row-block's W
# widest column-blocks spill into the exact COO tail (at 150k spoke
# dofs, W = 9 leaves ~1.3 % of the nonzeros in the tail)
WINDOW_W = 9


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class WindowedMatrix:
    """Exact block-windowed form of a square CSR matrix (see module
    docstring).  Optionally carries the symmetric permutation it was
    built under (``perm``/``iperm``) so solvers can map vectors in and
    out of the windowed ordering."""

    blk_idx: jnp.ndarray            # [nb, W] int32 column-block ids
    vals: jnp.ndarray               # [nb, R, W*C]
    n: int                          # logical row count (aux)
    C: int                          # column-block width (aux)
    ov_rows: Optional[jnp.ndarray] = None   # [M] int32
    ov_cols: Optional[jnp.ndarray] = None   # [M] int32
    ov_vals: Optional[jnp.ndarray] = None   # [M]
    perm: Optional[jnp.ndarray] = None      # [n] windowed <- original
    iperm: Optional[jnp.ndarray] = None     # [n] original <- windowed
    ncols: Optional[int] = None     # logical column count (aux; None =
    #                                 square, e.g. rectangular transfers)

    def tree_flatten(self):
        return ((self.blk_idx, self.vals, self.ov_rows, self.ov_cols,
                 self.ov_vals, self.perm, self.iperm),
                (self.n, self.C, self.ncols))

    @classmethod
    def tree_unflatten(cls, aux, children):
        blk_idx, vals, ovr, ovc, ovv, perm, iperm = children
        n, C, ncols = aux
        return cls(blk_idx, vals, n, C, ovr, ovc, ovv, perm, iperm, ncols)

    @property
    def nbytes_vals(self) -> int:
        return int(np.prod(self.vals.shape)) * self.vals.dtype.itemsize

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        nb, R, WC = self.vals.shape
        ncols = self.n if self.ncols is None else self.ncols
        nc = (ncols + self.C - 1) // self.C
        x2 = jnp.zeros((nc * self.C,), x.dtype).at[:ncols].set(x)
        xg = x2.reshape(nc, self.C)[self.blk_idx].reshape(nb, WC)
        if self.vals.dtype == jnp.bfloat16:
            # approximate (preconditioner) twin: bf16 values halve the
            # streaming traffic — the apply is bandwidth-bound on vals —
            # with f32 accumulation; entrywise rounding keeps the
            # operator symmetric, which is all a V-cycle level needs
            y = jnp.einsum("brk,bk->br", self.vals,
                           xg.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
            y = y.astype(x.dtype)
        else:
            y = jnp.einsum("brk,bk->br", self.vals, xg)
        y = y.reshape(nb * R)[:self.n]
        if self.ov_rows is not None:
            ov = self.ov_vals.astype(x.dtype) * x[self.ov_cols]
            y = y.at[self.ov_rows].add(ov)
        return y

    def as_bf16(self) -> "WindowedMatrix":
        """bf16-valued twin sharing the index structure (see matvec)."""
        return dataclasses.replace(
            self, vals=self.vals.astype(jnp.bfloat16),
            ov_vals=(self.ov_vals.astype(jnp.bfloat16)
                     if self.ov_vals is not None else None))

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: np.ndarray,
                 data: np.ndarray, dtype=np.float32, R: int = 16,
                 C: int = 128, w_cap=None,
                 budget_bytes: Optional[int] = None,
                 perm: Optional[np.ndarray] = None,
                 device: bool = True,
                 ncols: Optional[int] = None) -> Optional["WindowedMatrix"]:
        """Build from scalar CSR.  Returns None when the window form
        exceeds ``budget_bytes`` even at width 1 (caller falls back to
        ELL).

        ``w_cap``: window width in place of ``WINDOW_W`` (tests use small
        caps to exercise the overflow tail).  ``device=False`` keeps the
        buffers as numpy (host/CPU paths)."""
        itemsize = np.dtype(dtype).itemsize
        n = indptr.shape[0] - 1
        if n == 0:
            return None
        (_, W, nb, nc, b_of, r_of, w_of, c_of) = _plan_windows(
            indptr, indices, R, C, itemsize, w_cap=w_cap, ncols=ncols)
        if budget_bytes is not None and nb * R * W * C * itemsize > budget_bytes:
            # clamp to the widest window that fits the budget (extra
            # entries spill into the exact COO tail) instead of giving
            # the whole form up
            w_fit = int(budget_bytes // (nb * R * C * itemsize))
            if w_fit < 1:
                return None
            (_, W, nb, nc, b_of, r_of, w_of, c_of) = _plan_windows(
                indptr, indices, R, C, itemsize, w_cap=w_fit, ncols=ncols)
            ov_frac = float((w_of >= W).mean())
            if ov_frac > 0.5:
                # scalar overflow tail would dominate the apply: the
                # capped-K ELL form is the better program here
                return None
        WC = W * C
        if nb * R * WC - 1 > np.iinfo(np.int32).max:
            # the flat scatter index space must fit int32: with x64
            # disabled (all f32 production runs) jnp.asarray would
            # silently truncate int64 indices and build a corrupted
            # operator — fall back to the ELL path instead
            import logging
            logging.getLogger("tpufem").warning(
                "windowed form needs %d-entry flat index space (> int32);"
                " falling back to ELL", nb * R * WC)
            return None

        main = w_of < W
        flat = (b_of[main] * (R * WC) + r_of[main] * WC
                + w_of[main] * C + c_of[main]).astype(np.int32)
        vmain = data[main].astype(np.dtype(dtype))

        # blk_idx: one entry per kept (block, w) pair
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        blk_idx = np.zeros((nb, W), dtype=np.int32)
        blk_idx[b_of[main], w_of[main]] = indices[main] // C

        ov = None
        if not main.all():
            sel = ~main
            ov = (rows[sel].astype(np.int32),
                  indices[sel].astype(np.int32),
                  data[sel].astype(np.dtype(dtype)))

        if device:
            # scatter-build the dense window buffer in HBM: ship ~2
            # int32/float per nnz, never the (GB-scale) dense form
            def build(fidx, v):
                return (jnp.zeros((nb * R * WC,), dtype=np.dtype(dtype))
                        .at[fidx].set(v, unique_indices=True)
                        .reshape(nb, R, WC))
            vals = jax.jit(build)(jnp.asarray(flat), jnp.asarray(vmain))
            blk_idx_j = jnp.asarray(blk_idx)
            ovj = (tuple(jnp.asarray(a) for a in ov)
                   if ov is not None else (None, None, None))
            permj = (jnp.asarray(perm.astype(np.int32))
                     if perm is not None else None)
            ipermj = None
            if perm is not None:
                ip = np.empty_like(perm)
                ip[perm] = np.arange(n, dtype=perm.dtype)
                ipermj = jnp.asarray(ip.astype(np.int32))
            return cls(blk_idx_j, vals, n, C, *ovj, permj, ipermj, ncols)

        vals = np.zeros((nb, R, WC), dtype=np.dtype(dtype))
        vals.reshape(-1)[flat] = vmain
        ipn = None
        if perm is not None:
            ipn = np.empty_like(perm)
            ipn[perm] = np.arange(n, dtype=perm.dtype)
        return cls(jnp.asarray(blk_idx), jnp.asarray(vals), n, C,
                   *(tuple(jnp.asarray(a) for a in ov)
                     if ov is not None else (None, None, None)),
                   jnp.asarray(perm.astype(np.int32)) if perm is not None else None,
                   jnp.asarray(ipn.astype(np.int32)) if ipn is not None else None,
                   ncols)


def _plan_windows(indptr: np.ndarray, indices: np.ndarray, R: int, C: int,
                  itemsize: int, w_cap=None, ncols=None):
    """Per-nonzero window coordinates at window width
    ``min(w_cap or WINDOW_W, widest row-block)``.

    Returns (bytes, W, nb, nc, b_of, r_of, w_of, c_of) where for each
    nonzero: b_of = row block, r_of = row within block, w_of = rank of
    its column-block within the row-block's distinct-column-block list
    (by ascending column block), c_of = column within block.
    """
    n = indptr.shape[0] - 1
    nnz_row = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_row)
    cols = indices.astype(np.int64)
    nb = (n + R - 1) // R
    nc = ((n if ncols is None else ncols) + C - 1) // C
    b_of = rows // R

    from tpufem import native
    got = native.plan_windows(indptr, indices, R, C)
    if got is not None:
        # native per-row-block planner (one small sort per block, vs the
        # global argsort + unique below: ~0.15 s at 7M nnz where numpy
        # pays ~4 s on one core)
        w_of, widths, _ = got
    else:
        cb = cols // C
        key = b_of * nc + cb
        order = np.argsort(key, kind="stable")
        uq, inv_sorted = np.unique(key[order], return_inverse=True)
        uid = np.empty(key.shape[0], dtype=np.int64)
        uid[order] = inv_sorted
        ub = uq // nc
        block_first = np.searchsorted(ub, np.arange(nb), side="left")
        w_of = (np.arange(uq.shape[0]) - block_first[ub])[uid]
        widths = np.searchsorted(ub, np.arange(nb), side="right") - block_first

    wmax = int(widths.max()) if nb else 1
    W = max(1, min(int(WINDOW_W if w_cap is None else w_cap), wmax))
    return nb * R * W * C * itemsize, W, nb, nc, b_of, (rows % R), w_of, \
        (cols % C)


def rcm_csr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray
            ) -> Tuple[np.ndarray, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Reverse-Cuthill-McKee symmetric permutation of a CSR matrix.

    RCM shrinks each row-block's distinct-column-block count ~3x on the
    spoke graph (mean 12.4 -> 5.6 at R=8/C=128), which is exactly the
    windowed form's byte footprint.  Returns (perm, permuted_csr)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = indptr.shape[0] - 1
    M = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    perm = np.asarray(reverse_cuthill_mckee(M, symmetric_mode=True),
                      dtype=np.int64)
    from tpufem import native
    got = native.csr_permute_sym(indptr, indices, data, perm)
    if got is not None:
        return perm, got
    Mp = M[perm][:, perm].tocsr()
    Mp.sort_indices()
    return perm, (Mp.indptr, Mp.indices, Mp.data)
