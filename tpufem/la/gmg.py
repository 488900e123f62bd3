"""Structured geometric multigrid (the cube-path preconditioner).

On the benchmark's structured mesh, algebraic multigrid's unstructured
coarse operators force random gathers (see tpufem.fem.structured_op).  Nested Kuhn lattices admit an exact
geometric hierarchy instead, with every ingredient a stencil/slice op:

- h-coarsening: lattice (Nx, Ny, Nz) -> (Nx/2, ...); P1 prolongation is
  linear interpolation on the coarse tet mesh — every fine vertex is the
  midpoint of a coarse vertex pair (or a coarse vertex itself), because
  Kuhn edges include the face/body diagonals;
- p-coarsening (order >= 2): one transfer from P_k to P1 on the same
  lattice by point evaluation of the linear field at edge/face nodes;
- level operators: re-discretized constant-stencil StructuredOperator
  with per-level Dirichlet masks (spaces are nested, so this matches the
  Galerkin operator for interior dofs);
- smoother: Chebyshev/Jacobi (the GAMG smoother the reference
  recommends, README.md:78), lmax by device power iteration at setup;
- coarse solve: dense inverse (coarse_eq_limit analogue).

This replaces BoomerAMG/GAMG on the cube path; tpufem.la.amg remains the
algebraic fallback for unstructured meshes.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.fem.structured_op import StructuredOperator, dof_slice_plan
from tpufem.la.chebyshev import (chebyshev_smoother,
                                 chebyshev_smoother_zero)
from tpufem.mesh.structured import EDGE_TYPES, FACE_TYPES, BoxTetMesh


# ---------------------------------------------------------------------------
# Transfers (all shifted-slice ops; adjoint pairs verified in tests)
# ---------------------------------------------------------------------------


def _interleave(A: jnp.ndarray, B: jnp.ndarray, axis: int) -> jnp.ndarray:
    """[a0, a1, b0, a2, ...]: weave A (n+1 slices) with B (n slices) along
    ``axis``.  Pure stack/reshape/concat — strided writes (``at[::2]``)
    lower to scatter."""
    n = B.shape[axis]
    Ah = jax.lax.slice_in_dim(A, 0, n, axis=axis)
    At = jax.lax.slice_in_dim(A, n, n + 1, axis=axis)
    pairs = jnp.stack([Ah, B], axis=axis + 1)
    shape = list(A.shape)
    shape[axis] = 2 * n
    woven = pairs.reshape(shape)
    return jnp.concatenate([woven, At], axis=axis)


def _deinterleave(F: jnp.ndarray, axis: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse of _interleave: F (2n+1 slices) -> (A (n+1), B (n))."""
    m = F.shape[axis]
    n = (m - 1) // 2
    body = jax.lax.slice_in_dim(F, 0, 2 * n, axis=axis)
    tail = jax.lax.slice_in_dim(F, 2 * n, 2 * n + 1, axis=axis)
    shape = list(F.shape)
    shape[axis: axis + 1] = [n, 2]
    pairs = body.reshape(shape)
    Ah = jax.lax.index_in_dim(pairs, 0, axis=axis + 1, keepdims=False)
    B = jax.lax.index_in_dim(pairs, 1, axis=axis + 1, keepdims=False)
    return jnp.concatenate([Ah, tail], axis=axis), B


def prolong_h(c: jnp.ndarray, fine_dims: Tuple[int, int, int]) -> jnp.ndarray:
    """P1 vertex-grid prolongation coarse -> fine (2x per axis).

    c: [Zc+1, Yc+1, Xc+1, ...]; every fine vertex f equals the average of
    coarse vertices floor(f/2) and ceil(f/2) (equal when f is even —
    Kuhn edges include the face/body diagonals, so this is exact linear
    interpolation on the coarse tet mesh)."""
    # pattern blocks P[abc] = 0.5 * (c[lo] + c[hi]) for odd-axis offsets
    pat = {}
    for oz, oy, ox in itertools.product((0, 1), repeat=3):
        lo = c[: c.shape[0] - oz, : c.shape[1] - oy, : c.shape[2] - ox]
        hi = c[oz:, oy:, ox:]
        pat[(oz, oy, ox)] = lo if (oz | oy | ox) == 0 else 0.5 * (lo + hi)
    # weave x, then y, then z
    q = {}
    for oz, oy in itertools.product((0, 1), repeat=2):
        q[(oz, oy)] = _interleave(pat[(oz, oy, 0)], pat[(oz, oy, 1)], axis=2)
    r0 = _interleave(q[(0, 0)], q[(0, 1)], axis=1)
    r1 = _interleave(q[(1, 0)], q[(1, 1)], axis=1)
    return _interleave(r0, r1, axis=0)


def restrict_h(f: jnp.ndarray, coarse_dims: Tuple[int, int, int]) -> jnp.ndarray:
    """Adjoint of prolong_h (fine vertex grid -> coarse vertex grid)."""
    r0, r1 = _deinterleave(f, axis=0)
    q00, q01 = _deinterleave(r0, axis=1)
    q10, q11 = _deinterleave(r1, axis=1)
    c = None
    for (oz, oy), qq in (((0, 0), q00), ((0, 1), q01),
                         ((1, 0), q10), ((1, 1), q11)):
        e, o = _deinterleave(qq, axis=2)
        for ox, part in ((0, e), (1, o)):
            if (oz | oy | ox) == 0:
                c = part if c is None else c + part
                continue
            half = 0.5 * part
            # adjoint of lo/hi averaging: pad on the odd axes
            pads = [(0, oz), (0, oy), (0, ox)] + [(0, 0)] * (part.ndim - 3)
            c = c + jnp.pad(half, pads)
            pads = [(oz, 0), (oy, 0), (ox, 0)] + [(0, 0)] * (part.ndim - 3)
            c = c + jnp.pad(half, pads)
    return c


def prolong_p(v: jnp.ndarray, op_fine: StructuredOperator) -> jnp.ndarray:
    """P1 -> P_k on the same lattice: point evaluation of the linear
    field at the P_k nodes (vertex copy; edge nodes at parameter t get
    (1-t) va + t vb; face centroids get the 3-vertex average)."""
    from tpufem.fem.reference import _edge_interior_params
    lay = op_fine.layout
    k = lay.order
    bs = v.shape[-1] if v.ndim == 4 else 1
    grids_out = []
    # vertex grid passthrough
    grids_out.append(v[..., None, :] if v.ndim == 4 else v[..., None])
    tparams = _edge_interior_params(k, "gll_warped").tolist()
    kinds = lay.kinds
    idx = 1
    if k >= 2:
        for t in range(7):
            base, (X, Y, Z), slots = kinds[idx]; idx += 1
            d = EDGE_TYPES[t]
            va = v[: Z, : Y, : X]
            vb = v[d[2]: d[2] + Z, d[1]: d[1] + Y, d[0]: d[0] + X]
            cols = [((1 - tt) * va + tt * vb) for tt in tparams]
            grids_out.append(jnp.stack(cols, axis=3))
    if k >= 3:
        for t in range(12):
            base, (X, Y, Z), slots = kinds[idx]; idx += 1
            o1, o2 = FACE_TYPES[t]
            v0 = v[: Z, : Y, : X]
            v1 = v[o1[2]: o1[2] + Z, o1[1]: o1[1] + Y, o1[0]: o1[0] + X]
            v2 = v[o2[2]: o2[2] + Z, o2[1]: o2[1] + Y, o2[0]: o2[0] + X]
            grids_out.append(((v0 + v1 + v2) / 3.0)[..., None, :]
                             if v.ndim == 4 else ((v0 + v1 + v2) / 3.0)[..., None])
    return lay.join([g if g.ndim >= 4 else g[..., None] for g in grids_out])


def restrict_p(r_flat: jnp.ndarray, op_fine: StructuredOperator,
               bs: int) -> jnp.ndarray:
    """Adjoint of prolong_p: P_k residual -> P1 vertex grid."""
    from tpufem.fem.reference import _edge_interior_params
    lay = op_fine.layout
    k = lay.order
    comp = (bs,) if bs > 1 else (1,)
    rr = r_flat.reshape((-1,) + comp)
    grids = lay.split(rr)
    Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
    out = grids[0][..., 0, :]  # vertex part [Z+1, Y+1, X+1, bs]
    tparams = _edge_interior_params(k, "gll_warped").tolist()
    idx = 1
    if k >= 2:
        for t in range(7):
            g = grids[idx]; idx += 1  # [Z, Y, X, k-1, bs]
            d = EDGE_TYPES[t]
            Z, Y, X = g.shape[0], g.shape[1], g.shape[2]
            for s, tt in enumerate(tparams):
                out = out.at[: Z, : Y, : X].add((1 - tt) * g[..., s, :])
                out = out.at[d[2]: d[2] + Z, d[1]: d[1] + Y,
                             d[0]: d[0] + X].add(tt * g[..., s, :])
    if k >= 3:
        for t in range(12):
            g = grids[idx][..., 0, :]; idx += 1
            o1, o2 = FACE_TYPES[t]
            Z, Y, X = g.shape[0], g.shape[1], g.shape[2]
            third = g / 3.0
            out = out.at[: Z, : Y, : X].add(third)
            out = out.at[o1[2]: o1[2] + Z, o1[1]: o1[1] + Y,
                         o1[0]: o1[0] + X].add(third)
            out = out.at[o2[2]: o2[2] + Z, o2[1]: o2[1] + Y,
                         o2[0]: o2[0] + X].add(third)
    return out


# ---------------------------------------------------------------------------
# Hierarchy
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class _GLevel:
    op: StructuredOperator
    dinv: jnp.ndarray
    lmax: float                 # static

    def tree_flatten(self):
        return (self.op, self.dinv), self.lmax

    @classmethod
    def tree_unflatten(cls, lmax, children):
        return cls(*children, lmax)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GMG:
    """Geometric multigrid preconditioner for BoxTetMesh problems."""

    levels: List[_GLevel]       # level 0 = finest (order k), 1.. = P1 grids
    coarse_inv: jnp.ndarray
    coarse_bc_mask: jnp.ndarray
    dims: Tuple                 # static: per-level (Nx, Ny, Nz)
    order: int                  # static: fine order (p-transfer if > 1)
    bs: int                     # static
    smoother_degree: int        # static
    planar: bool = False        # static: bs > 1 component-planar vectors
    #                             (see fem.dia_op.DiaOperator.planar)

    def tree_flatten(self):
        return (self.levels, self.coarse_inv, self.coarse_bc_mask), (
            self.dims, self.order, self.bs, self.smoother_degree,
            self.planar)

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, coarse_inv, coarse_bc = children
        dims, order, bs, degree, planar = aux
        return cls(list(levels), coarse_inv, coarse_bc, dims, order, bs,
                   degree, planar)

    # -- setup -----------------------------------------------------------------
    @classmethod
    def setup(cls, mesh: BoxTetMesh, order: int, problem: str,
              bc_marker: Callable, dtype=jnp.float32,
              coarse_limit: int = 1000, smoother_degree: int = 2,
              max_levels: int = 12, planar: bool = False,
              use_conv: bool = False) -> "GMG":
        from tpufem.fem.dirichlet import DirichletBC
        from tpufem.fem.space import FunctionSpace

        bs = 3 if problem == "elasticity" else 1
        planar = planar and bs > 1
        if planar and order != 1:
            raise ValueError("planar GMG is P1-only")

        def make_level(m: BoxTetMesh, k: int):
            space = FunctionSpace(m, k, bs=bs)
            facets = m.locate_boundary_facets(bc_marker)
            bc = DirichletBC.from_space(space, facets)
            # P1 levels: DIA stencil (pure shifted multiply-adds,
            # small HLO); Pk fine level: per-perm element matmuls
            from tpufem.fem.dia_op import build_operator
            return build_operator(m, k, problem, bc_dofs=bc.flat_dofs(),
                                  dtype=dtype, planar=planar)

        meshes = [mesh]
        orders = [order]
        if order > 1:
            meshes.append(mesh)
            orders.append(1)
        while True:
            m = meshes[-1]
            ndofs_here = (m.Nx + 1) * (m.Ny + 1) * (m.Nz + 1) * bs
            if (ndofs_here <= coarse_limit or len(meshes) >= max_levels
                    or m.Nx % 2 or m.Ny % 2 or m.Nz % 2
                    or min(m.Nx, m.Ny, m.Nz) < 4):
                break
            meshes.append(BoxTetMesh(m.Nx // 2, m.Ny // 2, m.Nz // 2))
            orders.append(1)
        mC = meshes[-1]
        coarse_ndofs = (mC.Nx + 1) * (mC.Ny + 1) * (mC.Nz + 1) * bs
        if coarse_ndofs > 8 * coarse_limit:
            raise ValueError(
                f"GMG coarsest level has {coarse_ndofs} dofs "
                f"(dims {mC.Nx}x{mC.Ny}x{mC.Nz}); pick lattice dims "
                f"divisible by 2^levels (compute_box_size_structured)")

        lmax_of = {}
        for k in sorted(set(orders[:-1])):
            lmax_of[k] = surrogate_lmax(mesh, k, problem, bc_marker, dtype)

        levels: List[_GLevel] = []
        for m, k in zip(meshes[:-1], orders[:-1]):
            op = make_level(m, k)
            dinv_np = 1.0 / op.diagonal_np()
            if k >= 2 and bs == 1 and use_conv:
                # OPT-IN: Pk fine level as a channel conv
                # (fem/conv_op.py) — a far smaller HLO than the
                # ~1300-slice const-table form; the DIA form is the
                # default and conv is the compile-size escape hatch.  The smoother only needs apply/bc_mask;
                # p-transfers read .layout, which the conv op carries.
                from tpufem.fem.conv_op import ConvStencilOp
                from tpufem.fem.dia_op import DiaOperator
                if isinstance(op, DiaOperator) and op.is_const():
                    try:
                        op = ConvStencilOp.from_dia(op, dtype=dtype)
                    except ValueError:
                        pass
            levels.append(_GLevel(op=op,
                                  dinv=jnp.asarray(dinv_np.astype(np.dtype(dtype))),
                                  lmax=lmax_of[k]))

        # coarsest: dense inverse of the assembled BC-eliminated operator
        kC = orders[-1]
        from tpufem.fem.assemble import assemble_operator
        from tpufem.fem.space import FunctionSpace as FS
        space_c = FS(mC, kC, bs=bs)
        facets_c = mC.locate_boundary_facets(bc_marker)
        bc_c = DirichletBC.from_space(space_c, facets_c)
        _, csr = assemble_operator(space_c, bc_c, problem, dtype=np.float64)
        indptr, indices, data = csr
        import scipy.sparse as sp
        if data.ndim == 3:
            n = (indptr.shape[0] - 1) * bs
            Ad = sp.bsr_matrix((data, indices, indptr), shape=(n, n)).toarray()
        else:
            Ad = sp.csr_matrix((data, indices, indptr)).toarray()
        coarse_inv_np = np.linalg.inv(Ad)
        cmask = np.zeros(coarse_ndofs, dtype=bool)
        cmask[bc_c.flat_dofs()] = True
        if planar:
            # permute the dense coarse solve to planar component order
            perm = np.arange(coarse_ndofs).reshape(-1, bs).T.reshape(-1)
            coarse_inv_np = coarse_inv_np[np.ix_(perm, perm)]
            cmask = cmask[perm]
        coarse_inv = jnp.asarray(coarse_inv_np, dtype=dtype)

        dims = tuple((m.Nx, m.Ny, m.Nz) for m in meshes)
        return cls(levels=levels, coarse_inv=coarse_inv,
                   coarse_bc_mask=jnp.asarray(cmask), dims=dims,
                   order=order, bs=bs, smoother_degree=smoother_degree,
                   planar=planar)

    # -- V-cycle -----------------------------------------------------------------
    def _to_grid(self, x: jnp.ndarray, dims) -> jnp.ndarray:
        Nx, Ny, Nz = dims
        if self.planar:
            # planar components lead: transfers vmap over the component
            # axis as scalar grids
            return x.reshape((self.bs, Nz + 1, Ny + 1, Nx + 1))
        return x.reshape((Nz + 1, Ny + 1, Nx + 1) +
                         ((self.bs,) if self.bs > 1 else (1,)))

    def _to_flat(self, g: jnp.ndarray) -> jnp.ndarray:
        return g.reshape(-1)

    def _restrict_h(self, fg, cdims):
        if self.planar:
            return jax.vmap(lambda g: restrict_h(g, cdims))(fg)
        return restrict_h(fg, cdims)

    def _prolong_h(self, cg, fdims):
        if self.planar:
            return jax.vmap(lambda g: prolong_h(g, fdims))(cg)
        return prolong_h(cg, fdims)

    def _bc_mask_of(self, i: int) -> jnp.ndarray:
        if i == len(self.levels):
            return self.coarse_bc_mask
        return self.levels[i].op.bc_mask

    def vcycle(self, r: jnp.ndarray, i: int = 0) -> jnp.ndarray:
        if i == len(self.levels):
            return jnp.matmul(self.coarse_inv, r)
        lv = self.levels[i]
        smooth = chebyshev_smoother(lv.op.apply, lv.dinv, lv.lmax,
                                    degree=self.smoother_degree)
        smooth0 = chebyshev_smoother_zero(lv.op.apply, lv.dinv, lv.lmax,
                                          degree=self.smoother_degree)
        # pre-smoothing starts from zero: the residual-tracking form
        # returns rr = r - A x in `degree` matvecs and, with the scanned
        # recurrence, TWO matvec instances in the lowered program —
        # compile time of the const-table stencil programs scales with
        # inlined apply instances (631 s round-2 pathology)
        x, rr = smooth0(r)
        # symmetric BC-filtered transfers: P~ = (I - bc_f) P (I - bc_c),
        # so the preconditioner stays SPD for PCG
        rr = jnp.where(lv.op.bc_mask, 0.0, rr)
        p_transfer = (self.order > 1 and i == 0)
        if p_transfer:
            rc = restrict_p(rr, lv.op, self.bs).reshape(-1)
        else:
            fg = self._to_grid(rr, self.dims[i])
            rc = self._to_flat(self._restrict_h(fg, self.dims[i + 1]))
        rc = jnp.where(self._bc_mask_of(i + 1), 0.0, rc)
        xc = self.vcycle(rc, i + 1)
        xc = jnp.where(self._bc_mask_of(i + 1), 0.0, xc)
        if p_transfer:
            vg = self._to_grid(xc, self.dims[1])
            e = prolong_p(vg, lv.op).reshape(-1)
        else:
            cg = self._to_grid(xc, self.dims[i + 1])
            e = self._to_flat(self._prolong_h(cg, self.dims[i]))
        e = jnp.where(lv.op.bc_mask, 0.0, e)
        x = x + e
        return smooth(x, r)


def gmg_viable(mesh: BoxTetMesh, bs: int, coarse_limit: int = 1000,
               max_levels: int = 12) -> bool:
    """Cheap predicate: would GMG.setup succeed on this lattice?  Mirror
    of setup's mesh walk + the coarsest-level size check (callers use it
    to choose the operator layout before committing to a build)."""
    dims = (mesh.Nx, mesh.Ny, mesh.Nz)
    nlev = 1
    while True:
        nx, ny, nz = dims
        ndofs_here = (nx + 1) * (ny + 1) * (nz + 1) * bs
        if (ndofs_here <= coarse_limit or nlev >= max_levels
                or nx % 2 or ny % 2 or nz % 2 or min(nx, ny, nz) < 4):
            break
        dims = (nx // 2, ny // 2, nz // 2)
        nlev += 1
    nx, ny, nz = dims
    return (nx + 1) * (ny + 1) * (nz + 1) * bs <= 8 * coarse_limit


def surrogate_lmax(mesh: BoxTetMesh, order: int, problem: str,
                   bc_marker: Callable, dtype=jnp.float32) -> float:
    """lmax(D^-1 A) estimated on a SMALL surrogate lattice with the same
    (hx : hy : hz) anisotropy — the Jacobi-normalized spectrum of the
    constant stencil is resolution-independent, so one cheap host
    estimate serves every level of the hierarchy (1 vCPU host).  Shared
    by the single-device GMG and the slab-sharded GMG so both smooth on
    the identical Chebyshev interval (iteration-count parity)."""
    import math

    from tpufem.fem.dia_op import build_operator
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace

    g = math.gcd(math.gcd(mesh.Nx, mesh.Ny), mesh.Nz)
    sdims = (mesh.Nx // g, mesh.Ny // g, mesh.Nz // g)
    scale = max(1, 8 // max(sdims))
    surrogate = BoxTetMesh(*(d * scale for d in sdims))
    bs = 3 if problem == "elasticity" else 1
    space = FunctionSpace(surrogate, order, bs=bs)
    facets = surrogate.locate_boundary_facets(bc_marker)
    bc = DirichletBC.from_space(space, facets)
    sop = build_operator(surrogate, order, problem, bc_dofs=bc.flat_dofs(),
                         dtype=dtype, device=False)
    sd = 1.0 / sop.diagonal_np()
    return _host_lmax(sop, sd) * 1.05


def _host_lmax(op: StructuredOperator, dinv_np: np.ndarray,
               iters: int = 20) -> float:
    """Host power-iteration estimate of lambda_max(D^-1 A) (numpy twin of
    the stencil apply; no device jit per level)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal(dinv_np.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv_np * op.apply_np(v)
        lam = float(np.linalg.norm(w))
        v = w / lam
    return lam
