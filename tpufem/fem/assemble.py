"""Global assembly: sparsity construction, scatter-add, BC application.

Replaces ``fem::assemble_matrix`` / ``fem::assemble_vector`` + PETSc
MatSetValues (reference: src/poisson_problem.cpp:122-157,
src/elasticity_problem.cpp:196-229).  No atomic scatter is needed:

- matrix assembly runs at setup: element tensors are computed in batched
  device kernels (tpufem.fem.kernels), then deduped host-side into CSR /
  block-CSR by sort + reduceat (the MAT_FLUSH ghost migration of the
  reference maps to the reverse scatter in the sharded path);
- vector assembly / matrix-free action use a *precomputed* permutation +
  sorted ``segment_sum`` (DofScatter), which XLA lowers efficiently.

BC handling matches the reference: assemble unconstrained, zero BC
rows/cols, unit diagonal (fem::set_diagonal, poisson_problem.cpp:134),
and lifting b -= A @ u_bc (fem::apply_lifting, poisson_problem.cpp:152;
numerically zero in all reference problems since u0 = 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.fem import kernels
from tpufem.fem.dirichlet import DirichletBC


# ---------------------------------------------------------------------------
# Host-side COO -> CSR with duplicate summation (sort + reduceat)
# ---------------------------------------------------------------------------


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedupe-summed CSR from COO triplets.  ``vals`` may be [nnz] or
    [nnz, bs, bs] (block entries).  Returns (indptr, indices, data).

    Scalar entries take the single-pass native route; it drops
    exact-zero sums (eliminate_zeros-style — such entries are spurious
    weak connections for the AMG strength graph anyway) and returns
    float64 data, and the numpy fallback below applies the SAME
    semantics so results do not depend on whether the native library
    loaded.  Block entries keep the vectorized sort+reduceat path
    (explicit zero blocks retained)."""
    scalar = vals.ndim == 1
    if scalar:
        from tpufem import native
        got = native.coo_to_csr_dedup(rows, cols, vals, n)
        if got is not None:
            indptr, ucols, data = got
            return indptr, ucols.astype(np.int64), data
        vals = vals.astype(np.float64)
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    from tpufem.native import argsort_u64
    order = argsort_u64(key)
    key = key[order]
    vals = vals[order]
    boundaries = np.concatenate([[0], np.nonzero(np.diff(key))[0] + 1])
    ukey = key[boundaries]
    data = np.add.reduceat(vals, boundaries, axis=0)
    urows = (ukey // n).astype(np.int64)
    ucols = (ukey % n).astype(np.int64)
    if scalar:  # match the native route: drop exact-zero sums
        keep = data != 0.0
        data, urows, ucols = data[keep], urows[keep], ucols[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, urows + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, ucols, data


# ---------------------------------------------------------------------------
# Device-ready ELL (padded) sparse matrix
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ELLMatrix:
    """Fixed-width padded sparse matrix (scalar or bs x bs blocked).

    The replacement of PETSc MatAIJ for SpMV: row data is a
    dense [N, K] gather + reduction, no indirection chains, static shapes.
    Padding entries point at row 0 with zero value.

    Long rows may spill into an optional COO overflow tail
    (``ov_rows/ov_cols/ov_vals``, applied as one scatter-add): K is then
    a cost-model cap instead of the max row width, so a handful of
    high-degree rows (the spoke hub: max 45 vs mean 13.5 entries) no
    longer triples every row's gather count.  The matvec is EXACT either
    way.

    Registered as a pytree so it is passed into jitted solvers as data
    (baking multi-MB matrices in as HLO constants triggers pathological
    XLA constant folding).
    """

    cols: jnp.ndarray   # [N, K] int32 (block columns)
    vals: jnp.ndarray   # [N, K] or [N, K, bs, bs]
    bs: int = 1
    ov_rows: Optional[jnp.ndarray] = None  # [M] int32 block rows
    ov_cols: Optional[jnp.ndarray] = None  # [M] int32 block cols
    ov_vals: Optional[jnp.ndarray] = None  # [M] or [M, bs, bs]

    def tree_flatten(self):
        return (self.cols, self.vals, self.ov_rows, self.ov_cols,
                self.ov_vals), self.bs

    @classmethod
    def tree_unflatten(cls, bs, children):
        return cls(*children[:2], bs, *children[2:])

    @property
    def n_block_rows(self) -> int:
        return self.cols.shape[0]

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x with x flat [N * bs]."""
        if self.bs == 1:
            y = jnp.sum(self.vals * x[self.cols], axis=1)
            if self.ov_rows is not None:
                y = y.at[self.ov_rows].add(self.ov_vals * x[self.ov_cols])
            return y
        xb = x.reshape(-1, self.bs)
        g = xb[self.cols]  # [N, K, bs]
        y = jnp.einsum("nkab,nkb->na", self.vals, g)
        if self.ov_rows is not None:
            contrib = jnp.einsum("mab,mb->ma", self.ov_vals,
                                 xb[self.ov_cols])
            y = y.at[self.ov_rows].add(contrib)
        return y.reshape(-1)

    def diagonal(self) -> jnp.ndarray:
        """Flat diagonal [N * bs]."""
        n = self.n_block_rows
        row = jnp.arange(n)[:, None]
        hit = self.cols == row
        if self.bs == 1:
            d = jnp.sum(jnp.where(hit, self.vals, 0.0), axis=1)
            if self.ov_rows is not None:
                dhit = (self.ov_rows == self.ov_cols).astype(self.vals.dtype)
                d = d.at[self.ov_rows].add(dhit * self.ov_vals)
            return d
        d = jnp.einsum("nkab,nk->nab", self.vals,
                       hit.astype(self.vals.dtype))  # [N, bs, bs]
        if self.ov_rows is not None:
            dhit = (self.ov_rows == self.ov_cols).astype(self.vals.dtype)
            d = d.at[self.ov_rows].add(dhit[:, None, None] * self.ov_vals)
        return jnp.diagonal(d, axis1=1, axis2=2).reshape(-1)

    def astype(self, dtype) -> "ELLMatrix":
        ov = self.ov_vals.astype(dtype) if self.ov_vals is not None else None
        return ELLMatrix(self.cols, self.vals.astype(dtype), self.bs,
                         self.ov_rows, self.ov_cols, ov)


def csr_to_ell(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               dtype=np.float32, pad_to: Optional[int] = None,
               k_cap=None) -> ELLMatrix:
    """``k_cap``: cap the padded width and spill longer rows' tails into
    the COO overflow (exact matvec either way).  "auto" picks the cap
    minimizing the gather cost model N*K + 2.5*overflow_nnz — worth
    ~2x on graphs with a degree tail (spoke hub: max 45 vs mean 13.5).
    None (default) keeps the classic full-width padding; ``pad_to``
    (shard-aligned stacking) is incompatible with capping."""
    n = indptr.shape[0] - 1
    nnz_row = np.diff(indptr)
    K = int(nnz_row.max()) if nnz_row.size else 0
    if k_cap == "auto" and pad_to is None and n > 0:
        ks = np.unique(np.clip(nnz_row, 1, None))
        over = np.array([(np.maximum(nnz_row - k, 0)).sum() for k in ks])
        cost = n * ks + 2.5 * over
        K = int(ks[int(np.argmin(cost))])
    elif isinstance(k_cap, int):
        K = min(K, k_cap)
    if pad_to is not None:
        if nnz_row.size and int(nnz_row.max()) > pad_to:
            raise ValueError(
                f"pad_to={pad_to} is smaller than the max row width "
                f"{int(nnz_row.max())}; shard-aligned stacking reads "
                ".cols/.vals raw and cannot carry an overflow tail")
        K = pad_to
    block = data.ndim == 3
    bs = data.shape[1] if block else 1
    if not block:
        # single native pass (the numpy fancy-scatter fill below costs
        # ~7 s at 12.5M nnz on the 1-vCPU host)
        from tpufem import native
        got = native.csr_fill_ell(indptr, indices, data, K)
        if got is not None:
            c_, v_, ovr, ovc, ovv = got
            if ovr.size:
                return ELLMatrix(
                    jnp.asarray(c_), jnp.asarray(v_.astype(np.dtype(dtype))),
                    bs=1, ov_rows=jnp.asarray(ovr), ov_cols=jnp.asarray(ovc),
                    ov_vals=jnp.asarray(ovv.astype(np.dtype(dtype))))
            return ELLMatrix(jnp.asarray(c_),
                             jnp.asarray(v_.astype(np.dtype(dtype))), bs=1)
    cols = np.zeros((n, K), dtype=np.int32)
    vals = np.zeros((n, K) + ((bs, bs) if block else ()), dtype=dtype)
    # vectorized fill: position of each nnz within its row
    rows = np.repeat(np.arange(n), nnz_row)
    pos = np.arange(indices.shape[0]) - np.repeat(indptr[:-1], nnz_row)
    main = pos < K
    cols[rows[main], pos[main]] = indices[main]
    vals[rows[main], pos[main]] = data[main].astype(dtype)
    ov = ~main
    if ov.any():
        return ELLMatrix(
            jnp.asarray(cols), jnp.asarray(vals), bs=bs,
            ov_rows=jnp.asarray(rows[ov].astype(np.int32)),
            ov_cols=jnp.asarray(indices[ov].astype(np.int32)),
            ov_vals=jnp.asarray(data[ov].astype(dtype)))
    return ELLMatrix(jnp.asarray(cols), jnp.asarray(vals), bs=bs)


# ---------------------------------------------------------------------------
# Vector scatter (cell -> dof), precomputed for the hot path
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
class DofScatter:
    """Precomputed sorted segment-sum scatter from cell-local contributions
    to the global dof vector (the no-atomics replacement for the
    add-mode VecSetValues / ghost accumulation of the reference)."""

    def __init__(self, cell_dofs: np.ndarray, ndofs_scalar: int, bs: int = 1,
                 _arrays=None) -> None:
        if _arrays is not None:
            self.perm, self.segments = _arrays
        else:
            flat = cell_dofs.reshape(-1)
            perm = np.argsort(flat, kind="stable")
            self.perm = jnp.asarray(perm.astype(np.int32))
            self.segments = jnp.asarray(flat[perm].astype(np.int32))
        self.ndofs_scalar = ndofs_scalar
        self.bs = bs

    def tree_flatten(self):
        return (self.perm, self.segments), (self.ndofs_scalar, self.bs)

    @classmethod
    def tree_unflatten(cls, aux, children):
        ndofs_scalar, bs = aux
        return cls(None, ndofs_scalar, bs, _arrays=children)

    def scatter_add(self, cell_vals: jnp.ndarray) -> jnp.ndarray:
        """cell_vals [C, n] (bs=1) or [C, n, bs] -> flat dof vector."""
        if self.bs == 1:
            data = cell_vals.reshape(-1)[self.perm]
            return jax.ops.segment_sum(data, self.segments,
                                       num_segments=self.ndofs_scalar,
                                       indices_are_sorted=True)
        data = cell_vals.reshape(-1, self.bs)[self.perm]
        out = jax.ops.segment_sum(data, self.segments,
                                  num_segments=self.ndofs_scalar,
                                  indices_are_sorted=True)
        return out.reshape(-1)

    def gather(self, x: jnp.ndarray, cell_dofs: jnp.ndarray,
               n_per_cell: int) -> jnp.ndarray:
        """x[cell_dofs]: pack coefficients per cell
        (fem::pack_coefficients, reference poisson_problem.cpp:126-128)."""
        if self.bs == 1:
            return x[cell_dofs]
        return x.reshape(-1, self.bs)[cell_dofs]


# ---------------------------------------------------------------------------
# Matrix assembly drivers
# ---------------------------------------------------------------------------


def _cell_jacobians(coords: np.ndarray):
    """Per-cell Jacobian J [C,3,3] plus the first cofactor row and det
    (shared by the full-adjugate and det-only geometry paths)."""
    E = coords[:, 1:4, :] - coords[:, 0:1, :]
    J = np.swapaxes(E, 1, 2)  # [C, a, l]
    c00 = J[:, 1, 1] * J[:, 2, 2] - J[:, 1, 2] * J[:, 2, 1]
    c01 = J[:, 1, 2] * J[:, 2, 0] - J[:, 1, 0] * J[:, 2, 2]
    c02 = J[:, 1, 0] * J[:, 2, 1] - J[:, 1, 1] * J[:, 2, 0]
    det = J[:, 0, 0] * c00 + J[:, 0, 1] * c01 + J[:, 0, 2] * c02
    return J, c00, c01, c02, det


def _geometry_np(coords: np.ndarray):
    """Host float64 (Jinv [C,3,3], |detJ| [C]) — assembly runs on the host
    (setup phase).  Closed-form adjugate: numpy's batched inv/det loop
    LAPACK per 3x3 matrix and is ~100x slower at millions of cells."""
    J, c00, c01, c02, det = _cell_jacobians(coords)
    adj = np.empty_like(J)
    adj[:, 0, 0] = c00
    adj[:, 0, 1] = J[:, 0, 2] * J[:, 2, 1] - J[:, 0, 1] * J[:, 2, 2]
    adj[:, 0, 2] = J[:, 0, 1] * J[:, 1, 2] - J[:, 0, 2] * J[:, 1, 1]
    adj[:, 1, 0] = c01
    adj[:, 1, 1] = J[:, 0, 0] * J[:, 2, 2] - J[:, 0, 2] * J[:, 2, 0]
    adj[:, 1, 2] = J[:, 0, 2] * J[:, 1, 0] - J[:, 0, 0] * J[:, 1, 2]
    adj[:, 2, 0] = c02
    adj[:, 2, 1] = J[:, 0, 1] * J[:, 2, 0] - J[:, 0, 0] * J[:, 2, 1]
    adj[:, 2, 2] = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    Jinv = adj / det[:, None, None]
    return Jinv, np.abs(det)


def detJ_np(coords: np.ndarray) -> np.ndarray:
    """Host float64 |detJ| [C] alone — the RHS volume term only needs
    the measure; materializing the full Jinv adjugate for it allocated
    a [C, 3, 3] f64 (~190 MB at 2.6M cells) that was thrown away."""
    return np.abs(_cell_jacobians(coords)[4])


def metric_np(coords: np.ndarray) -> np.ndarray:
    """Host float64 per-cell metric |detJ| Jinv Jinv^T (numpy twin of
    kernels.metric_tensors; setup-phase geometry)."""
    Jinv, adet = _geometry_np(coords)
    return np.einsum("cal,cbl->cab", Jinv, Jinv) * adet[:, None, None]


def _poisson_stiffness_np(coords: np.ndarray, order: int) -> np.ndarray:
    """Numpy twin of kernels.poisson_stiffness_cells (tested equal)."""
    from tpufem.fem.kernels import _poisson_ref_tables
    Kflat, _, n = _poisson_ref_tables(order)
    Jinv, adet = _geometry_np(coords)
    G = np.einsum("cal,cbl->cab", Jinv, Jinv) * adet[:, None, None]
    return (G.reshape(-1, 9) @ Kflat).reshape(-1, n, n)


def _elasticity_stiffness_np(coords: np.ndarray, order: int) -> np.ndarray:
    """Numpy twin of kernels.elasticity_stiffness_cells (tested equal)."""
    from tpufem.fem.kernels import (ELASTICITY_LMBDA, ELASTICITY_MU,
                                    _elasticity_ref_table)
    TT, _, n = _elasticity_ref_table(order)
    mu, lam = ELASTICITY_MU, ELASTICITY_LMBDA
    Jinv, adet = _geometry_np(coords)
    JJ = np.einsum("cal,cbl->cab", Jinv, Jinv)
    eye = np.eye(3)
    C = (mu * JJ[:, :, :, None, None] * eye[None, None, None, :, :]
         + mu * np.einsum("cas,cbr->cabrs", Jinv, Jinv)
         + lam * np.einsum("car,cbs->cabrs", Jinv, Jinv))
    C = C * adet[:, None, None, None, None]
    return (C.reshape(-1, 81) @ TT).reshape(-1, 3 * n, 3 * n)


def assemble_operator(space, bc: Optional[DirichletBC], problem: str,
                      dtype=np.float32, chunk: int = 1 << 18):
    """Assemble the stiffness operator into an ELLMatrix with BC rows/cols
    zeroed and unit diagonal on BC dofs.

    problem: "poisson" | "elasticity".  Element tensors are computed on
    the host in float64 chunks (setup phase; the device kernels serve the
    solve-time matrix-free paths and are verified equal in tests).
    """
    coords_all = space.mesh.cell_coords()
    cell_dofs = space.cell_dofs
    C = coords_all.shape[0]
    n = space.ndofs_per_cell
    bs = space.bs

    if problem == "poisson":
        kern = lambda c: _poisson_stiffness_np(c, space.order)
    elif problem == "elasticity":
        kern = lambda c: _elasticity_stiffness_np(c, space.order)
    else:
        raise ValueError(problem)

    N = space.ndofs_scalar
    indptr = indices = data = None
    if bs == 1:
        # fused native path: element tensors land in ONE preallocated
        # array and the triplet build + radix dedup happens in C++ —
        # the numpy repeat/tile/concatenate route materialized ~300 MB
        # of page-faulting temporaries on this VM (~12 s at 866k cells
        # where this is ~3 s)
        from tpufem import native
        if native.have_native():
            A_all = np.empty((C, n, n), dtype=np.float64)
            for start in range(0, C, chunk):
                end = min(start + chunk, C)
                A_all[start:end] = kern(coords_all[start:end])
            got = native.cells_to_csr(cell_dofs, A_all, N)
            if got is not None:
                indptr, icols, data = got
                indices = icols.astype(np.int64)
            del A_all
    if indptr is None:
        rows_parts, cols_parts, vals_parts = [], [], []
        for start in range(0, C, chunk):
            end = min(start + chunk, C)
            A = kern(coords_all[start:end])  # [c, bn, bn]
            cd = cell_dofs[start:end]
            r = np.repeat(cd, n, axis=1)            # [c, n*n] block rows
            cidx = np.tile(cd, (1, n))              # [c, n*n] block cols
            if bs == 1:
                v = A.reshape(end - start, n * n)
            else:
                # A is [(3i+r),(3j+s)] interleaved; regroup to [i,j,r,s]
                v = A.reshape(end - start, n, bs, n,
                              bs).transpose(0, 1, 3, 2, 4)
                v = v.reshape(end - start, n * n, bs, bs)
            rows_parts.append(r.reshape(-1))
            cols_parts.append(cidx.reshape(-1))
            vals_parts.append(v.reshape((-1,) + v.shape[2:]))

        rows = np.concatenate(rows_parts)
        cols = np.concatenate(cols_parts)
        vals = np.concatenate(vals_parts)
        indptr, indices, data = coo_to_csr(rows, cols, vals, N)

    if bc is not None and bc.flat_dofs().size > 0:
        mask = bc.mask()
        rows_of = np.repeat(np.arange(N), np.diff(indptr))
        onrow = mask[rows_of]
        oncol = mask[indices]
        diag = rows_of == indices
        if bs == 1:
            data = np.where(onrow | oncol, 0.0, data)
            data = np.where(diag & mask[rows_of], 1.0, data)
        else:
            data[onrow | oncol] = 0.0
            data[diag & onrow] = np.eye(bs)

    return (csr_to_ell(indptr, indices, data, dtype=dtype, k_cap="auto"),
            (indptr, indices, data))


def apply_lifting_and_bc(b: np.ndarray, A_nobc: ELLMatrix,
                         bc: DirichletBC) -> np.ndarray:
    """b <- b - A @ u_bc ; b[bc] = value  (fem::apply_lifting + bc.set,
    reference poisson_problem.cpp:152-155).  With the reference's u0 = 0
    the lifting term vanishes; kept general."""
    if bc.value != 0.0:
        u_bc = np.zeros(A_nobc.n_block_rows * A_nobc.bs, dtype=b.dtype)
        u_bc[bc.flat_dofs()] = bc.value
        b = b - np.asarray(A_nobc.matvec(jnp.asarray(u_bc)))
    b = b.copy()
    b[bc.flat_dofs()] = bc.value
    return b
