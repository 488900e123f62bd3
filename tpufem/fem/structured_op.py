"""Lattice-structured matrix-free operators (the cube-mesh fast path).

Random gathers and gather+segment-sum cost far more per operator apply
than shifted-slice (stencil) traffic, and the reference's generic
per-cell re-assembly (src/cgpoisson_problem.cpp:193-204) maps to the
gather pattern — so this design exploits what the benchmark mesh
actually is: a translation-invariant lattice.

Key facts used:
- every cube of the Kuhn mesh contains the same 6 tetrahedron shapes;
  each shape's Jacobian is CONSTANT across the lattice, so each of the 6
  per-perm element matrices A_p [n, n] is a single constant matrix;
- every dof belongs to a typed sub-lattice (vertex grid, 7 edge grids,
  12 face grids — tpufem.mesh.structured), and a cell's local dof l of
  tet perm p always sits at a constant lattice offset from the cube
  corner.

Hence the operator action is:

  for each perm p:  gather n shifted SLICES of the dof grids ->
  one [Q, n] @ [n, n] matmul -> scatter-add n shifted slices back

with zero gather/scatter instructions — only contiguous slice reads and
pad-adds, which XLA lowers to pure vector ops.  The same machinery
yields the operator diagonal (for Jacobi/Chebyshev smoothing) and serves
both the matrix-free cgpoisson path and the assembled-equivalent SpMV
  A_bc @ x = where(bc, x, A(where(bc, 0, x)))
(BC rows/cols zeroed + unit diagonal, reference poisson_problem.cpp:134).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.fem.reference import ReferenceTet
from tpufem.mesh.structured import (CELL_VERTEX_OFFSETS, EDGE_TYPES,
                                    FACE_TYPES, LOCAL_EDGES, LOCAL_FACES,
                                    _EDGE_TYPE_OF, _FACE_TYPE_OF, BoxTetMesh)

# ---------------------------------------------------------------------------
# Dof-grid layout: typed sub-lattices of the scalar dof numbering
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridLayout:
    """Where each typed dof grid lives inside the flat dof vector.

    kinds: list of (base offset, dims (X, Y, Z), slots) — slots = dofs per
    entity ((k-1) for edges); grid g reshapes the flat segment
    [base : base + X*Y*Z*slots] to [Z, Y, X, slots].
    """

    order: int
    Nx: int
    Ny: int
    Nz: int
    kinds: Tuple  # tuple of (base, (X, Y, Z), slots)

    @property
    def ndofs(self) -> int:
        b, dims, s = self.kinds[-1]
        return b + int(np.prod(dims)) * s

    def split(self, x: jnp.ndarray) -> List[jnp.ndarray]:
        """Flat [ndofs(, c)] -> list of [Z, Y, X, slots(, c)] grids."""
        out = []
        comp = x.shape[1:]  # () or (bs,)
        for base, (X, Y, Z), s in self.kinds:
            seg = x[base: base + X * Y * Z * s]
            out.append(seg.reshape((Z, Y, X, s) + comp))
        return out

    def join(self, grids: List[jnp.ndarray]) -> jnp.ndarray:
        comp = grids[0].shape[4:]
        return jnp.concatenate(
            [g.reshape((-1,) + comp) for g in grids], axis=0)


def grid_layout(mesh: BoxTetMesh, order: int) -> GridLayout:
    """Dof numbering of tpufem.fem.space as typed grids: vertices first,
    then the 7 edge-type blocks ((k-1) slots each), then 12 face types."""
    Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
    kinds = [(0, (Nx + 1, Ny + 1, Nz + 1), 1)]
    base = (Nx + 1) * (Ny + 1) * (Nz + 1)
    k = order
    if k >= 2:
        dims = mesh._edge_dims()
        for t in range(7):
            X, Y, Z = int(dims[t][0]), int(dims[t][1]), int(dims[t][2])
            kinds.append((base, (X, Y, Z), k - 1))
            base += X * Y * Z * (k - 1)
    if k >= 3:
        dims = mesh._face_dims()
        for t in range(12):
            X, Y, Z = int(dims[t][0]), int(dims[t][1]), int(dims[t][2])
            kinds.append((base, (X, Y, Z), 1))
            base += X * Y * Z
    return GridLayout(order=k, Nx=Nx, Ny=Ny, Nz=Nz, kinds=tuple(kinds))


# ---------------------------------------------------------------------------
# Slice plans: (perm, local dof) -> (grid kind, lattice offset, slot)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def dof_slice_plan(order: int) -> Tuple[Tuple[Tuple[int, Tuple[int, int, int], int], ...], ...]:
    """plan[p][l] = (kind index, (dx, dy, dz) cube offset, slot).

    kind index: 0 = vertices, 1..7 = edge types, 8..19 = face types.
    Slot accounts for edge-dof orientation: the local edge's direction vs
    the anchored (min -> max) global direction is constant per (p, le).
    """
    k = order
    plans = []
    for p in range(6):
        offs = CELL_VERTEX_OFFSETS[p]  # [4, 3]
        entries = []
        for l in range(4):  # vertex dofs
            entries.append((0, tuple(int(v) for v in offs[l]), 0))
        if k >= 2:
            for le, (a, b) in enumerate(LOCAL_EDGES):
                va, vb = offs[a], offs[b]
                anchor = np.minimum(va, vb)
                d = tuple(np.abs(vb - va))
                etype = _EDGE_TYPE_OF[d]
                flipped = bool(np.any(va > vb))
                for s in range(k - 1):
                    slot = (k - 2 - s) if flipped else s
                    entries.append((1 + etype,
                                    tuple(int(v) for v in anchor), slot))
        if k >= 3:
            for lf, (a, b, c) in enumerate(LOCAL_FACES):
                tri = np.stack([offs[a], offs[b], offs[c]])
                anchor = tri.min(axis=0)
                top = tri.max(axis=0)
                mid = tri.sum(axis=0) - anchor - top
                ftype = _FACE_TYPE_OF[(tuple(mid - anchor), tuple(top - anchor))]
                entries.append((8 + ftype, tuple(int(v) for v in anchor), 0))
        plans.append(tuple(entries))
    return tuple(plans)


# ---------------------------------------------------------------------------
# Constant per-perm element matrices
# ---------------------------------------------------------------------------


def perm_element_matrices(mesh: BoxTetMesh, order: int,
                          problem: str = "poisson",
                          h_override=None) -> np.ndarray:
    """[6, n, n] (scalar) or [6, 3n, 3n] constant element matrices.

    Exact because every cube's 6 tets are translates of the 6 shapes at
    the origin cube (anisotropic in (1/Nx, 1/Ny, 1/Nz)).  ``problem`` may
    also be "mass" (the scalar mass matrix |detJ| M_ref, used for
    structured RHS assembly).  ``h_override`` supplies the physical cube
    size when ``mesh`` is a shard-local slab of a larger lattice."""
    if h_override is not None:
        h = np.asarray(h_override, dtype=np.float64)
    else:
        h = np.array([1.0 / mesh.Nx, 1.0 / mesh.Ny, 1.0 / mesh.Nz])
    coords = CELL_VERTEX_OFFSETS.astype(np.float64) * h[None, None, :]  # [6,4,3]
    if problem == "poisson":
        from tpufem.fem.assemble import _poisson_stiffness_np
        return _poisson_stiffness_np(coords, order)
    if problem == "elasticity":
        from tpufem.fem.assemble import _elasticity_stiffness_np
        return _elasticity_stiffness_np(coords, order)
    if problem == "mass":
        el = ReferenceTet(order)
        adet = float(np.prod(h))  # |detJ| identical for all 6 perms
        return np.repeat((adet * el.mass_tensor)[None], 6, axis=0)
    raise ValueError(problem)


def dof_gids_for_cells(mesh: BoxTetMesh, order: int, cubes: np.ndarray,
                       perms: np.ndarray) -> np.ndarray:
    """[n_cells, n] scalar dof gids for (cube lattice corner, perm) pairs,
    computed O(1) per cell from the slice plan (no global dofmap build)."""
    lay = grid_layout(mesh, order)
    plan = dof_slice_plan(order)
    ncells = cubes.shape[0]
    n = len(plan[0])
    out = np.empty((ncells, n), dtype=np.int64)
    for p in range(6):
        sel = np.flatnonzero(perms == p)
        if sel.size == 0:
            continue
        c = cubes[sel]
        for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
            base, (X, Y, Z), slots = lay.kinds[kind]
            ax = c[:, 0] + dx
            ay = c[:, 1] + dy
            az = c[:, 2] + dz
            lex = (az * Y + ay) * X + ax
            out[sel, l] = base + lex * slots + slot
    return out


# ---------------------------------------------------------------------------
# The structured operator
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class StructuredOperator:
    """Constant-stencil matrix-free operator on a BoxTetMesh.

    bs = 1 (Poisson) or 3 (elasticity, component-interleaved grids).
    ``bc_mask`` is the flat [ndofs*bs] boolean Dirichlet mask; apply()
    implements the BC-eliminated operator
      y = where(bc, x, A(where(bc, 0, x)))
    which equals the reference's assembled matrix after zeroing BC
    rows/cols and setting a unit diagonal.
    """

    Ap: np.ndarray              # [6, n*bs, n*bs] — STATIC (weights embed
    #                             as exact scalar constants in the HLO)
    bc_mask: jnp.ndarray        # [ndofs * bs] bool (may be all-False)
    layout: GridLayout          # static
    bs: int                     # static

    def tree_flatten(self):
        aux = (self.Ap.tobytes(), self.Ap.shape, self.Ap.dtype.str,
               self.layout, self.bs)
        return (self.bc_mask,), aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        (bc,) = children
        buf, shape, dt, layout, bs = aux
        Ap = np.frombuffer(buf, dtype=np.dtype(dt)).reshape(shape)
        return cls(Ap, bc, layout, bs)

    # -- construction ----------------------------------------------------------
    @classmethod
    def build(cls, mesh: BoxTetMesh, order: int, problem: str = "poisson",
              bc_dofs: Optional[np.ndarray] = None,
              dtype=jnp.float32, device: bool = True,
              h_override=None) -> "StructuredOperator":
        """device=False keeps arrays in numpy (for host-only *_np use —
        a float64 jnp.asarray with x64 disabled compiles a device
        convert).  ``h_override``
        supplies the physical cube size when ``mesh`` is a shard-local
        slab of a larger lattice."""
        bs = 3 if problem == "elasticity" else 1
        layout = grid_layout(mesh, order)
        Ap = perm_element_matrices(mesh, order, problem,
                                   h_override=h_override)
        nd = layout.ndofs * bs
        mask = np.zeros(nd, dtype=bool)
        if bc_dofs is not None:
            mask[bc_dofs] = True
        Ap_cast = np.ascontiguousarray(Ap.astype(np.dtype(dtype)))
        if not device:
            return cls(Ap_cast, mask, layout, bs)
        return cls(Ap_cast, jnp.asarray(mask), layout, bs)

    # -- raw action (no BC) ------------------------------------------------------
    def apply_raw(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A_unconstrained @ x via shifted slices + constant weights.

        A stack-minor-axis [.., n] matmul layout compiled ~50x slower
        than these forms, so no matmuls for bs = 1: scalar weights are
        embedded as constants (exact f32); bs > 1 uses an einsum over the
        leading stacked axis.
        """
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        bs = self.bs
        xr = x.reshape((-1, bs)) if bs > 1 else x.reshape((-1, 1))
        grids = lay.split(xr)  # list of [Z, Y, X, slots, bs]
        out = [jnp.zeros_like(g) for g in grids]
        n = len(plan[0])
        Ap_np = self.Ap

        for p in range(6):
            cols = [grids[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot]
                    for (kind, (dx, dy, dz), slot) in plan[p]]  # [Z,Y,X,bs]
            if bs == 1:
                A = Ap_np[p]
                for lo, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                    acc = None
                    for li in range(n):
                        w = float(A[lo, li])
                        if w == 0.0:
                            continue
                        t = w * cols[li][..., 0]
                        acc = t if acc is None else acc + t
                    if acc is None:
                        continue
                    out[kind] = out[kind].at[
                        dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot, 0].add(acc)
            else:
                u = jnp.stack(cols, axis=0)  # [n, Z, Y, X, bs]
                A = self.Ap[p].reshape(n, bs, n, bs)
                y = jnp.einsum("MaNb,Nzyxb->Mzyxa", A, u)
                for lo, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                    out[kind] = out[kind].at[
                        dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot].add(y[lo])

        return lay.join(out).reshape(-1)

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        """BC-eliminated operator (zeroed rows/cols, unit diagonal)."""
        x0 = jnp.where(self.bc_mask, 0.0, x)
        y = self.apply_raw(x0)
        return jnp.where(self.bc_mask, x, y)

    def apply_bc_rows_zero(self, x: jnp.ndarray) -> jnp.ndarray:
        """cgpoisson convention: zero BC rows only
        (reference cgpoisson_problem.cpp:207)."""
        y = self.apply_raw(x)
        return jnp.where(self.bc_mask, 0.0, y)

    # -- host (numpy) twin for setup-phase spectral estimates ----------------
    def apply_raw_np(self, x: np.ndarray) -> np.ndarray:
        """Pure-numpy apply (setup-phase power iteration etc. — avoids a
        device jit compile per level)."""
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        bs = self.bs
        Ap = np.asarray(self.Ap, dtype=np.float64)
        xr = x.reshape(-1, bs)
        grids = []
        outs = []
        for base, (X, Y, Z), s in lay.kinds:
            g = xr[base: base + X * Y * Z * s].reshape(Z, Y, X, s, bs)
            grids.append(g)
            outs.append(np.zeros_like(g))
        n = len(plan[0])
        for p in range(6):
            cols = [grids[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot]
                    for (kind, (dx, dy, dz), slot) in plan[p]]
            u = np.stack(cols, axis=-2).reshape(-1, n * bs)
            y = (u @ Ap[p].T).reshape(Nz, Ny, Nx, n, bs)
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                outs[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot] += y[..., l, :]
        flat = np.concatenate([o.reshape(-1, bs) for o in outs], axis=0)
        return flat.reshape(-1)

    def apply_np(self, x: np.ndarray) -> np.ndarray:
        bc = np.asarray(self.bc_mask)
        y = self.apply_raw_np(np.where(bc, 0.0, x))
        return np.where(bc, x, y)

    # -- diagonal ------------------------------------------------------------
    def diagonal_np(self) -> np.ndarray:
        """Host float64 operator diagonal (BC rows get 1)."""
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        bs = self.bs
        Ap = np.asarray(self.Ap, dtype=np.float64)
        outs = [np.zeros((k[1][2], k[1][1], k[1][0], k[2], bs))
                for k in lay.kinds]
        for p in range(6):
            dA = np.diagonal(Ap[p])
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                d = dA[l * bs: (l + 1) * bs]
                outs[kind][dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot] += d
        flat = np.concatenate([o.reshape(-1, bs) for o in outs]).reshape(-1)
        return np.where(np.asarray(self.bc_mask), 1.0, flat)

    def diagonal(self) -> jnp.ndarray:
        """Flat operator diagonal (BC rows get 1), for Jacobi/Chebyshev."""
        lay = self.layout
        plan = dof_slice_plan(lay.order)
        Nx, Ny, Nz = lay.Nx, lay.Ny, lay.Nz
        bs = self.bs
        grids = [jnp.zeros(g_shape + (bs,), dtype=self.Ap.dtype)
                 for g_shape in [( (k[1][2], k[1][1], k[1][0], k[2]) )
                                 for k in lay.kinds]]
        for p in range(6):
            for l, (kind, (dx, dy, dz), slot) in enumerate(plan[p]):
                if bs == 1:
                    d = self.Ap[p, l, l]
                    add = jnp.full((Nz, Ny, Nx, 1), d, dtype=self.Ap.dtype)
                else:
                    d = jnp.diagonal(self.Ap[p])[l * bs: (l + 1) * bs]
                    add = jnp.broadcast_to(d, (Nz, Ny, Nx, bs))
                grids[kind] = grids[kind].at[
                    dz: dz + Nz, dy: dy + Ny, dx: dx + Nx, slot].add(add)
        flat = lay.join(grids).reshape(-1)
        return jnp.where(self.bc_mask, 1.0, flat)
