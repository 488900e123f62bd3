"""Generalized DIA (diagonal-stencil) operator on the structured lattice.

The assembled-matrix representation for the cube path: instead of storing
a sparse matrix with explicit column indices (gather-heavy),
the matrix is stored as a set of *shift diagonals* between typed dof
grids:

  y[dst](z, y, x) += W[(dst, src, delta)](z, y, x) * x[src](z+dz, y+dy, x+dx)

Every entry of the BC-eliminated stiffness matrix lands on one of a few
dozen (dst-kind/slot, src-kind/slot, lattice shift) triples (15 for P1),
because cell couplings on the Kuhn lattice have constant offsets (see
tpufem.fem.structured_op).  The apply is then a handful of elementwise
multiply-adds over contiguous slices — no gathers, no matmuls (hence
no reduced-precision products), and a tiny HLO (the
unrolled multigrid V-cycle compiles quickly).

Constant-weight ("const") mode — the production P1 representation:
each diagonal's weight grid is translation-invariant away from the
lattice boundary (the same six tet shapes tile every interior cube), so
it is stored as ONE interior constant plus thin face-slab corrections
(grid-truncation and Dirichlet rows/cols live within two planes of each
axis end).  This cuts the apply's memory traffic from O(D * N) weight reads
to O(N) vector reads, and the host-side build from O(N) dense-grid
accumulation to an O(1) build on a 6^3 surrogate lattice — the weight
structure is exactly piecewise-constant on a product grid with breaks
only near the ends of each axis, so the surrogate captures it exactly
(verified at build; any violation falls back to the dense path).

Dirichlet elimination (zeroed rows/cols + unit diagonal, reference
poisson_problem.cpp:134) is baked into the weights, so apply() is exactly
the reference's assembled operator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.fem.structured_op import (GridLayout, dof_slice_plan,
                                      grid_layout, perm_element_matrices)
from tpufem.mesh.structured import BoxTetMesh

_SHELL = 2  # per-axis shell margin: truncation (1) + BC adjacency (1)
_SURR = 8   # surrogate lattice cubes per axis (>= 2*(_SHELL+1) + 2 so the
#             shell-clamp reconstruction has a genuine interior plane on
#             every typed grid, incl. edge grids one shorter per axis)


def _overlap(Zo, Yo, Xo, Zi, Yi, Xi, d):
    """Static dst-slice bounds such that src = dst + d stays in range."""
    dz, dy, dx = d[2], d[1], d[0]
    z0, z1 = max(0, -dz), min(Zo, Zi - dz)
    y0, y1 = max(0, -dy), min(Yo, Yi - dy)
    x0, x1 = max(0, -dx), min(Xo, Xi - dx)
    return (z0, z1, y0, y1, x0, x1)


def _rep_index(Lr: int, Ls: int, m: int) -> np.ndarray:
    """Surrogate index -> representative real index: the first/last m
    entries map end-to-end, interior surrogate entries sample one real
    interior plane (all real interior planes are equal by construction)."""
    r = np.full(Ls, Lr // 2, dtype=np.int64)
    r[:m] = np.arange(m)
    r[Ls - m:] = Lr - (Ls - np.arange(Ls - m, Ls))
    return r


def _clamp_index(Lr: int, Ls: int, m: int) -> np.ndarray:
    """Real index -> surrogate index (exact when deviations from the
    interior constant sit within m of each end)."""
    q = np.full(Lr, Ls // 2, dtype=np.int64)
    q[:m] = np.arange(m)
    q[Lr - m:] = Ls - (Lr - np.arange(Lr - m, Lr))
    return q


def _face_slabs(Lz: int, Ly: int, Lx: int, m: int):
    """Disjoint cover of the boundary shell by six thin slabs (z-lo/z-hi
    take the full cross-section; y and x slabs cover the remainder)."""
    return (
        (0, m, 0, Ly, 0, Lx),
        (Lz - m, Lz, 0, Ly, 0, Lx),
        (m, Lz - m, 0, m, 0, Lx),
        (m, Lz - m, Ly - m, Ly, 0, Lx),
        (m, Lz - m, m, Ly - m, 0, m),
        (m, Lz - m, m, Ly - m, Lx - m, Lx),
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DiaOperator:
    """Block-DIA stencil matrix between typed dof grids.

    ``plan`` holds one static entry per (dst, src, shift) term:
    ``(dst_kind, dst_slot, src_kind, src_slot, (dx, dy, dz),
    dst-slice bounds, corrs)``.  ``corrs is None`` marks a dense term
    (one [z1-z0, y1-y0, x1-x0] (+ (bs, bs)) weight array); otherwise
    ``corrs`` is a tuple of slice bounds *relative to the dst slice* and
    the term consumes 1 + len(corrs) weights: the interior constant
    (0-d or [bs, bs]) followed by the thin correction arrays.
    """

    weights: List[jnp.ndarray]
    bc_mask: jnp.ndarray   # flat [ndofs*bs] bool (elimination also baked in;
    #                        kept for transfer filtering in multigrid)
    plan: Tuple            # static (see class docstring)
    layout: GridLayout     # static
    bs: int                # static
    surr_dims: Optional[Tuple[int, int, int]] = None  # static: surrogate
    #                        lattice cubes (const mode only)
    zones: Optional[Tuple] = None       # const mode: per zone_plan entry a
    #                        tuple of PRECOMPUTED weight-field arrays
    #                        ((lo[3,Y,X], mid[1,Y,X], hi[3,Y,X]) or
    #                        (full[Z,Y,X],)) — built on the host at setup
    #                        so the traced apply is pure slice-mult-adds
    #                        (tiny HLO; in-trace field reconstruction made
    #                        the unrolled-V-cycle compile explode)
    zone_plan: Optional[Tuple] = None   # static: (ko, so, ki, si, d, r, s)
    planar: bool = False   # static: bs > 1 component-PLANAR vector layout
    #                        [c * ndofs + i] instead of the reference's
    #                        node-interleaved [i * bs + c].  Interleaved
    #                        grids put the 3 components on the minor
    #                        axis (every slice is a stride-3 access);
    #                        planar components are contiguous scalar
    #                        grids.
    #                        bc_mask / diagonal / apply all use the
    #                        planar ordering when set.

    def tree_flatten(self):
        if self.is_const():
            # surrogate tables are host-side setup data (diagonal_np /
            # apply_np twins); only the zone fields + bc mask are device
            # state.  Tables travel as static bytes (precomputed once in
            # _finalize) so dispatches never re-upload or pull them back.
            wmeta = getattr(self, "_wmeta", None)
            if wmeta is None:
                wmeta = tuple((np.asarray(w).tobytes(), np.asarray(w).shape,
                               np.asarray(w).dtype.str) for w in self.weights)
                self._wmeta = wmeta
            return (self.bc_mask, self.zones), (
                self.plan, self.layout, self.bs, self.surr_dims,
                self.zone_plan, wmeta, self.planar)
        return (self.bc_mask, tuple(self.weights)), (
            self.plan, self.layout, self.bs, self.surr_dims, self.zone_plan,
            None, self.planar)

    @classmethod
    def tree_unflatten(cls, aux, children):
        plan, layout, bs, surr_dims, zone_plan, wmeta, planar = aux
        if wmeta is not None:
            bc_mask, zones = children
            weights = [np.frombuffer(b, dtype=np.dtype(dt)).reshape(shape)
                       for b, shape, dt in wmeta]
            op = cls(weights, bc_mask, plan, layout, bs, surr_dims,
                     zones, zone_plan, planar)
            op._wmeta = wmeta
            return op
        bc_mask, weights = children
        return cls(list(weights), bc_mask, plan, layout, bs, surr_dims,
                   None, zone_plan, planar)

    def terms(self):
        """Yield (meta, weight) walking the weight list in plan order.
        meta[6] is None for a dense dst-slice weight array, "table" for
        an absolute surrogate lookup table."""
        for meta, w in zip(self.plan, self.weights):
            yield meta, w

    def is_const(self) -> bool:
        return bool(self.plan) and all(m[6] == "table" for m in self.plan)

    # -- construction -----------------------------------------------------------
    @classmethod
    def build(cls, mesh: BoxTetMesh, order: int, problem: str,
              bc_dofs: Optional[np.ndarray] = None,
              dtype=jnp.float32, h_override=None,
              bake_bc: bool = True, mode: str = "auto",
              device: bool = True, planar: bool = False) -> "DiaOperator":
        """``bake_bc=False`` records the BC mask without eliminating
        rows/cols in the weights (the matrix-free rows-zero convention).
        ``mode``: "const" | "dense" | "auto" (const for P1 on lattices
        with >= 6 cubes per axis, dense otherwise).  ``device=False``
        keeps every array in numpy — for host-only *_np use (setup-phase
        spectral estimates)."""
        if mode == "auto":
            mode = ("const" if order == 1
                    and min(mesh.Nx, mesh.Ny, mesh.Nz) >= 6 else "dense")
        if mode == "const":
            op = cls._build_const(mesh, order, problem, bc_dofs, dtype,
                                  h_override, bake_bc)
        else:
            op = None
        if op is None:
            op = cls._build_dense(mesh, order, problem, bc_dofs, dtype,
                                  h_override, bake_bc)
        op.planar = planar and op.bs > 1
        return op._finalize(device)

    def _finalize(self, device: bool = True) -> "DiaOperator":
        """Precompute zone weight fields (const mode) and ship the device
        state (zones + bc mask; dense-mode weights) in ONE batched
        transfer (the internal builds keep numpy).  Const-mode surrogate tables stay
        numpy — they serve only the host twins."""
        if self.is_const():
            self._build_zones_np()
        if self.planar:
            self.bc_mask = np.ascontiguousarray(
                np.asarray(self.bc_mask).reshape(-1, self.bs).T).reshape(-1)
        if not device:
            return self
        if self.zones is not None:
            self.zones = jax.device_put(self.zones)
        else:
            self.weights = jax.device_put(self.weights)
        self.bc_mask = jax.device_put(self.bc_mask)
        return self

    @classmethod
    def _build_dense(cls, mesh, order, problem, bc_dofs, dtype,
                     h_override, bake_bc) -> "DiaOperator":
        lay = grid_layout(mesh, order)
        splan = dof_slice_plan(order)
        Ap = perm_element_matrices(mesh, order, problem, h_override=h_override)
        bs = 3 if problem == "elasticity" else 1
        Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
        n = len(splan[0])

        kinds = lay.kinds
        gdims = [(k[1][2], k[1][1], k[1][0]) for k in kinds]  # (Z, Y, X)

        # accumulate constant coefficients per (dst, src, shift) onto
        # dst-grid-sized weight arrays (cube region shifted by dst offset)
        acc: Dict[Tuple, np.ndarray] = {}
        for p in range(6):
            A = Ap[p].reshape(n, bs, n, bs) if bs > 1 else \
                Ap[p].reshape(n, 1, n, 1)
            for lo, (ko, (ox, oy, oz), so) in enumerate(splan[p]):
                for li, (ki, (ix, iy, iz), si) in enumerate(splan[p]):
                    c = A[lo, :, li, :]  # [bs, bs]
                    if not np.any(c):
                        continue
                    key = (ko, so, ki, si, (ix - ox, iy - oy, iz - oz))
                    Zo, Yo, Xo = gdims[ko]
                    if key not in acc:
                        acc[key] = np.zeros((Zo, Yo, Xo, bs, bs))
                    acc[key][oz: oz + Nz, oy: oy + Ny, ox: ox + Nx] += c

        # bake BC elimination into the weights
        bc_grids = None
        if bake_bc and bc_dofs is not None and len(bc_dofs):
            mask = np.zeros(lay.ndofs * bs, dtype=bool)
            mask[bc_dofs] = True
            mask = mask.reshape(-1, bs)
            bc_grids = []
            for base, (X, Y, Z), s in kinds:
                seg = mask[base: base + X * Y * Z * s]
                bc_grids.append(seg.reshape(Z, Y, X, s, bs))

        plan = []
        weights = []
        for (ko, so, ki, si, d), W in sorted(acc.items()):
            Zo, Yo, Xo = gdims[ko]
            Zi, Yi, Xi = gdims[ki]
            z0, z1, y0, y1, x0, x1 = _overlap(Zo, Yo, Xo, Zi, Yi, Xi, d)
            Wc = W[z0:z1, y0:y1, x0:x1].copy()
            if bc_grids is not None:
                dst_bc = bc_grids[ko][z0:z1, y0:y1, x0:x1, so]  # [.., bs]
                src_bc = bc_grids[ki][z0 + d[2]: z1 + d[2],
                                      y0 + d[1]: y1 + d[1],
                                      x0 + d[0]: x1 + d[0], si]
                Wc = np.where(dst_bc[..., :, None], 0.0, Wc)
                Wc = np.where(src_bc[..., None, :], 0.0, Wc)
                if (ko, so, d) == (ki, si, (0, 0, 0)):
                    eye = np.eye(bs)
                    Wc = np.where(dst_bc[..., :, None], eye, Wc)
            if bs == 1:
                Wc = Wc[..., 0, 0]
            if not np.any(Wc):
                continue
            plan.append((ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), None))
            weights.append(Wc.astype(np.dtype(dtype)))

        flat_mask = np.zeros(lay.ndofs * bs, dtype=bool)
        if bc_dofs is not None and len(bc_dofs):
            flat_mask[bc_dofs] = True
        return cls(weights=weights, bc_mask=flat_mask,
                   plan=tuple(plan), layout=lay, bs=bs)

    @classmethod
    def try_const(cls, mesh: BoxTetMesh, order: int, problem: str,
                  bc_dofs: Optional[np.ndarray] = None, dtype=jnp.float32,
                  bake_bc: bool = True, h_override=None,
                  device: bool = True,
                  planar: bool = False) -> Optional["DiaOperator"]:
        """Const-mode build (no dense fallback) or None — the scalar
        P2/P3 production path; callers fall back to StructuredOperator."""
        op = cls._build_const(mesh, order, problem, bc_dofs, dtype,
                              h_override, bake_bc)
        if op is None:
            return None
        op.planar = planar and op.bs > 1
        return op._finalize(device)

    @classmethod
    def _build_const(cls, mesh, order, problem, bc_dofs, dtype,
                     h_override, bake_bc) -> Optional["DiaOperator"]:
        """O(1) constant-weight build via a surrogate lattice, for EVERY
        typed dof grid of the layout (vertex + edge + face kinds — P1-P3).

        Returns None when the weight structure is not shell-representable
        (caller falls back to the dense build)."""
        M = _SHELL
        lay = grid_layout(mesh, order)
        bs = 3 if problem == "elasticity" else 1
        if bs > 1 and len(lay.kinds) != 1:
            return None  # blocked const apply is P1-only (bs^2 scalar
            #              stencil decomposition; see _apply_table)
        Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
        if min(Nx, Ny, Nz) < 2 * (M + 1):
            return None
        h = (tuple(h_override) if h_override is not None
             else (1.0 / Nx, 1.0 / Ny, 1.0 / Nz))
        sdims = (min(Nx, _SURR), min(Ny, _SURR), min(Nz, _SURR))
        smesh = BoxTetMesh(*sdims)
        slay = grid_layout(smesh, order)
        rdims = [(k[1][2], k[1][1], k[1][0]) for k in lay.kinds]
        surr_kdims = [(k[1][2], k[1][1], k[1][0]) for k in slay.kinds]

        # transport the BC pattern to the surrogate, kind by kind (exact
        # only for axis-shell patterns — e.g. face Dirichlet planes;
        # verified by clamping back)
        flat_mask = np.zeros(lay.ndofs * bs, dtype=bool)
        sbc_flat = None
        if bc_dofs is not None and len(bc_dofs):
            flat_mask[bc_dofs] = True
            if bake_bc:
                mask2 = flat_mask.reshape(-1, bs)
                parts = []
                for (b, (X, Y, Zd), s), (Zr, Yr, Xr), (Zs, Ys, Xs) in zip(
                        lay.kinds, rdims, surr_kdims):
                    g = mask2[b: b + X * Y * Zd * s].reshape(
                        Zr, Yr, Xr, s, bs)
                    rz, ry, rx = (_rep_index(Zr, Zs, M),
                                  _rep_index(Yr, Ys, M),
                                  _rep_index(Xr, Xs, M))
                    gs = g[np.ix_(rz, ry, rx)]
                    qz, qy, qx = (_clamp_index(Zr, Zs, M),
                                  _clamp_index(Yr, Ys, M),
                                  _clamp_index(Xr, Xs, M))
                    if not np.array_equal(g, gs[np.ix_(qz, qy, qx)]):
                        return None
                    parts.append(gs.reshape(-1, bs))
                sbc_flat = np.nonzero(np.concatenate(parts).reshape(-1))[0]

        surr = cls._build_dense(smesh, order, problem, sbc_flat,
                                jnp.float64, h, bake_bc)

        plan = []
        weights: List[jnp.ndarray] = []
        npdtype = np.dtype(dtype)
        for (ko, so, ki, si, d, (sz0, sz1, sy0, sy1, sx0, sx1), _), Ws in \
                zip(surr.plan, surr.weights):
            Zr, Yr, Xr = rdims[ko]
            Zi, Yi, Xi = rdims[ki]
            z0, z1, y0, y1, x0, x1 = _overlap(Zr, Yr, Xr, Zi, Yi, Xi, d)
            Lz, Ly, Lx = z1 - z0, y1 - y0, x1 - x0
            Ws = np.asarray(Ws, dtype=np.float64)
            Lsz, Lsy, Lsx = Ws.shape[:3]
            if min(Lsz, Lsy, Lsx) < 2 * M + 2 or min(Lz, Ly, Lx) < 2 * M:
                return None
            inner = Ws[M: Lsz - M, M: Lsy - M, M: Lsx - M]
            w0 = inner.reshape((-1,) + Ws.shape[3:])[0]
            if not (inner == w0).all():
                return None  # interior not translation-invariant
            if not Ws.any():
                continue
            # store the ABSOLUTE surrogate weight grid as a lookup table:
            # the apply reconstructs the full weight field on the fly with
            # per-axis clamp indices (three tiny fused takes — no weight
            # traffic); zeros outside the dst slice make bounds implicit
            # (the padded input supplies zero src there anyway)
            sZ, sY, sX = surr_kdims[ko]
            T = np.zeros((sZ, sY, sX) + Ws.shape[3:])
            T[sz0:sz1, sy0:sy1, sx0:sx1] = Ws
            plan.append((ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1),
                         "table"))
            weights.append(T.astype(npdtype))

        return cls(weights=weights, bc_mask=flat_mask,
                   plan=tuple(plan), layout=lay, bs=bs, surr_dims=sdims)

    # -- apply --------------------------------------------------------------
    def apply_bc_rows_zero(self, x: jnp.ndarray) -> jnp.ndarray:
        """cgpoisson convention: zero BC rows only
        (reference cgpoisson_problem.cpp:207)."""
        return jnp.where(self.bc_mask, 0.0, self.apply(x))

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.zones is not None:
            return self._apply_zones(x)
        if self.planar:
            # dense mode serves only SMALL lattices — permute at the
            # boundary instead of a planar dense kernel
            xi = x.reshape(self.bs, -1).T.reshape(-1)
            return self._apply_dense(xi).reshape(-1, self.bs).T.reshape(-1)
        return self._apply_dense(x)

    def _kind_dims(self, kind: int):
        """((Zr, Yr, Xr), (Zs, Ys, Xs)) real/surrogate dims of one kind."""
        lay = self.layout
        sd = self.surr_dims or (min(lay.Nx, 6), min(lay.Ny, 6),
                                min(lay.Nz, 6))
        slay = grid_layout(BoxTetMesh(*sd), lay.order)
        k, sk = lay.kinds[kind], slay.kinds[kind]
        return ((k[1][2], k[1][1], k[1][0]),
                (sk[1][2], sk[1][1], sk[1][0]))

    def _build_zones_np(self) -> None:
        """Expand every const-table term into PRECOMPUTED z-zone weight
        fields (host numpy; bs > 1 expands into bs^2 scalar components —
        trailing [bs, bs] contraction dims would make every pass a tiny
        strided one).  The clamp maps are identity within 3 planes of each z end
        and constant between, so the full field over the dst grid is
        exactly (lo[3, Y, X], mid[1, Y, X] broadcast along z,
        hi[3, Y, X]); grids shorter than 7 planes store the full field.
        Doing this at build time keeps the traced apply to ~2 HLO ops per
        zone — in-trace field reconstruction made the unrolled-V-cycle
        programs compile in minutes (BENCH_r02: 631 s first solve)."""
        m = _SHELL + 1
        zone_plan = []
        zones = []
        for (ko, so, ki, si, d, _b, _c), T in self.terms():
            (Zr, Yr, Xr), _sd = self._kind_dims(ko)
            qz, qy, qx = self._clamp_maps_np(ko)
            Tn = np.asarray(T)
            for r in range(self.bs):
                for s in range(self.bs):
                    Trs = Tn[..., r, s] if self.bs > 1 else Tn
                    if not Trs.any():
                        continue
                    if Zr >= 2 * m + 1:
                        fields = (Trs[np.ix_(qz[:m], qy, qx)],
                                  Trs[np.ix_(qz[m: m + 1], qy, qx)],
                                  Trs[np.ix_(qz[Zr - m:], qy, qx)])
                    else:
                        fields = (Trs[np.ix_(qz, qy, qx)],)
                    zone_plan.append((ko, so, ki, si, d, r, s))
                    zones.append(tuple(f.copy() for f in fields))
        self.zone_plan = tuple(zone_plan)
        self.zones = tuple(zones)

    def _apply_zones(self, x: jnp.ndarray) -> jnp.ndarray:
        """Bandwidth-optimal const-mode apply (P1-P3, scalar and bs=3).

        Each component grid is zero-padded by 2 per axis (the widest
        (dst dim) - (src dim) + shift excursion); every zone term
        multiplies a shifted src slab by its precomputed weight field and
        XLA fuses all terms of one output zone into a single elementwise
        pass.  The z-mid field is [1, Y, X] broadcast along z, so memory
        traffic matches a pure constant stencil; z-lo/z-hi are exact
        3-plane slabs (O(surface)).  Thin y/x-face slabs are deliberately
        NOT split out: their 4-wide minor dims make tiny strided passes.
        The output is built by concat per grid — no full-grid ``.at[]``
        updates (those copy the array)."""
        lay = self.layout
        bs = self.bs
        m = _SHELL + 1
        pads = ((2, 2), (2, 2), (2, 2))
        rdims = [(k[1][2], k[1][1], k[1][0]) for k in lay.kinds]
        if self.planar and bs > 1:
            # component-planar input: each component is a CONTIGUOUS
            # scalar grid (contiguous slices; const bs>1 is
            # single-kind P1 by construction)
            Ns = lay.ndofs
            Z, Y, X = rdims[0]
            comps = [[[jnp.pad(x[c * Ns: (c + 1) * Ns].reshape(Z, Y, X),
                               pads) for c in range(bs)]]]
        else:
            grids = lay.split(x.reshape(-1, bs) if bs > 1
                              else x.reshape(-1, 1))
            comps = [[[jnp.pad(g[..., sl, c], pads) for c in range(bs)]
                      for sl in range(g.shape[3])] for g in grids]

        acc = {}  # (ko, so, r) -> list of zone accumulators
        src_cache = {}  # (ko, ki, si, s, d): bs>1 emits each shifted
        # slice once for all (r, s) pairs instead of bs^2 times — XLA
        # would CSE the duplicates anyway, but the unoptimized HLO it
        # compiles shrinks ~25% (elasticity GMG program)
        for (ko, so, ki, si, d, r, s), fields in zip(self.zone_plan,
                                                     self.zones):
            Z, Y, X = rdims[ko]
            dz, dy, dx = d[2], d[1], d[0]
            skey = (ko, ki, si, s, d)
            src = src_cache.get(skey)
            if src is None:
                src = comps[ki][si][s][2 + dz: 2 + dz + Z,
                                       2 + dy: 2 + dy + Y,
                                       2 + dx: 2 + dx + X]
                src_cache[skey] = src
            if len(fields) == 3:
                lo, mid, hi = fields
                parts = (lo * src[0:m], mid * src[m: Z - m],
                         hi * src[Z - m: Z])
            else:
                parts = (fields[0] * src,)
            a = acc.get((ko, so, r))
            if a is None:
                acc[(ko, so, r)] = list(parts)
            else:
                acc[(ko, so, r)] = [u + v for u, v in zip(a, parts)]

        if self.planar and bs > 1:
            outs = []
            for r in range(bs):
                a = acc.get((0, 0, r))
                col = (jnp.zeros(rdims[0], dtype=x.dtype) if a is None
                       else (a[0] if len(a) == 1
                             else jnp.concatenate(a, axis=0)))
                outs.append(col.reshape(-1))
            return jnp.concatenate(outs)
        outs = []
        for kidx, (b, _dims, slots) in enumerate(lay.kinds):
            Z, Y, X = rdims[kidx]
            cols = []
            for so in range(slots):
                for r in range(bs):
                    a = acc.get((kidx, so, r))
                    if a is None:
                        cols.append(jnp.zeros((Z, Y, X), dtype=x.dtype))
                        continue
                    cols.append(a[0] if len(a) == 1
                                else jnp.concatenate(a, axis=0))
            outs.append(cols[0].reshape(-1) if len(cols) == 1
                        else jnp.stack(cols, axis=-1).reshape(-1))
        return jnp.concatenate(outs) if len(outs) > 1 else outs[0]

    def _apply_dense(self, x: jnp.ndarray) -> jnp.ndarray:
        lay = self.layout
        bs = self.bs
        xr = x.reshape((-1, bs)) if bs > 1 else x.reshape((-1, 1))
        grids = lay.split(xr)  # [Z, Y, X, slots, bs]
        out = [jnp.zeros_like(g) for g in grids]
        for (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), corrs), W in \
                self.terms():
            if corrs is not None:
                raise ValueError("mixed table/dense operator")
            src = grids[ki][z0 + d[2]: z1 + d[2],
                            y0 + d[1]: y1 + d[1],
                            x0 + d[0]: x1 + d[0], si]  # [.., bs]
            if bs == 1:
                out[ko] = out[ko].at[z0:z1, y0:y1, x0:x1, so, 0].add(
                    W * src[..., 0])
            else:
                out[ko] = out[ko].at[z0:z1, y0:y1, x0:x1, so, :].add(
                    jnp.einsum("...rs,...s->...r", W, src))
        y = lay.join(out)
        return y.reshape(-1)

    # -- dense reconstruction / diagonal ---------------------------------------
    def _clamp_maps_np(self, kind: int = 0):
        m = _SHELL + 1
        (rz, ry, rx), (sz, sy, sx) = self._kind_dims(kind)
        return (_clamp_index(rz, sz, m), _clamp_index(ry, sy, m),
                _clamp_index(rx, sx, m))

    def _dense_weight_np(self, meta, W) -> np.ndarray:
        """Materialize one term's full dst-slice weight array (numpy)."""
        (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), corrs) = meta
        if corrs is None:
            return np.asarray(W, dtype=np.float64)
        qz, qy, qx = self._clamp_maps_np(ko)
        full = np.asarray(W, dtype=np.float64)[np.ix_(qz, qy, qx)]
        return full[z0:z1, y0:y1, x0:x1]

    def diagonal_np(self) -> np.ndarray:
        lay = self.layout
        bs = self.bs
        outs = [np.zeros((k[1][2], k[1][1], k[1][0], k[2], bs))
                for k in lay.kinds]
        for meta, W in self.terms():
            (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), corrs) = meta
            if (ko, so, d) != (ki, si, (0, 0, 0)):
                continue
            Wn = self._dense_weight_np(meta, W)
            if bs == 1:
                outs[ko][z0:z1, y0:y1, x0:x1, so, 0] += Wn
            else:
                outs[ko][z0:z1, y0:y1, x0:x1, so, :] += np.diagonal(
                    Wn, axis1=-2, axis2=-1)
        d = np.concatenate([o.reshape(-1, bs) for o in outs])
        if self.planar:
            return np.ascontiguousarray(d.T).reshape(-1)
        return d.reshape(-1)

    def to_scipy(self):
        """Export the operator as a scipy CSR matrix (float64, the
        operator's interleaved dof ordering).

        The cube-path AMG setup needs the assembled matrix only on the
        host (strength graph, aggregation, RAP); re-assembling it from
        element tensors costs ~36 s at 500k dofs while this export from
        the stencil representation is vectorized index arithmetic
        (~1-2 s).  Equality with ``assemble_operator`` is pinned by
        tests (the stencil IS the assembled matrix on this mesh)."""
        import scipy.sparse as sp
        lay = self.layout
        bs = self.bs
        kinds = [(b, (X, Y, Z), s) for b, (X, Y, Z), s in lay.kinds]

        # P1-scalar fast path: one dof kind, one term per shift diagonal
        # (asserted below), col = row + constant shift — the CSR emits
        # directly in sorted order with NO sort/dedup pass, ~40% the
        # temporary bytes of the triplet route (the deployment VM
        # first-touches fresh pages at 16-80 MB/s, so bytes are wall)
        if bs == 1 and len(kinds) == 1 and kinds[0][2] == 1:
            plan = list(self.terms())
            seen = {}
            for meta, W in plan:
                (ko, so, ki, si, d, _, _) = meta
                seen[d] = seen.get(d, 0) + 1
            if all(v == 1 for v in seen.values()):
                _, (X, Y, Z), _ = kinds[0]
                n = lay.ndofs
                order = sorted(range(len(plan)),
                               key=lambda i: (plan[i][0][4][2] * Y
                                              + plan[i][0][4][1]) * X
                               + plan[i][0][4][0])
                D = len(order)
                V = np.zeros((n, D))
                keep = np.zeros((n, D), dtype=bool)
                shifts = np.empty(D, dtype=np.int64)
                f3 = np.zeros((Z, Y, X))
                m3 = np.zeros((Z, Y, X), dtype=bool)
                for k, i in enumerate(order):
                    meta, W = plan[i]
                    (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), _) = meta
                    shifts[k] = (d[2] * Y + d[1]) * X + d[0]
                    f3[...] = 0.0
                    f3[z0:z1, y0:y1, x0:x1] = self._dense_weight_np(meta, W)
                    V[:, k] = f3.reshape(-1)
                    m3[...] = False
                    m3[z0:z1, y0:y1, x0:x1] = True
                    keep[:, k] = m3.reshape(-1)
                keep &= V != 0.0  # eliminate_zeros semantics
                counts = keep.sum(axis=1)
                indptr = np.zeros(n + 1, dtype=np.int64)
                np.cumsum(counts, out=indptr[1:])
                cols = (np.arange(n, dtype=np.int64)[:, None]
                        + shifts[None, :])[keep].astype(np.int32)
                return sp.csr_matrix((V[keep], cols, indptr), shape=(n, n))

        def flat_nodes(kind, slot, z0, z1, y0, y1, x0, x1):
            b, (X, Y, Z), s = kinds[kind]
            z, y, x = np.meshgrid(np.arange(z0, z1), np.arange(y0, y1),
                                  np.arange(x0, x1), indexing="ij")
            return b + ((z * Y + y) * X + x) * s + slot

        rows_l, cols_l, vals_l = [], [], []
        for meta, W in self.terms():
            (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), corrs) = meta
            Wn = self._dense_weight_np(meta, W)  # [dz,dy,dx(,bs,bs)]
            rr = flat_nodes(ko, so, z0, z1, y0, y1, x0, x1)
            cc = flat_nodes(ki, si, z0 + d[2], z1 + d[2], y0 + d[1],
                            y1 + d[1], x0 + d[0], x1 + d[0])
            if bs == 1:
                rows_l.append(rr.ravel())
                cols_l.append(cc.ravel())
                vals_l.append(Wn.ravel())
            else:
                for r in range(bs):
                    for s_ in range(bs):
                        w = Wn[..., r, s_]
                        if not w.any():
                            continue
                        rows_l.append(rr.ravel() * bs + r)
                        cols_l.append(cc.ravel() * bs + s_)
                        vals_l.append(w.ravel())
        n = lay.ndofs * bs
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        vals = np.concatenate([np.asarray(v, dtype=np.float64)
                               for v in vals_l])
        # single-pass native COO->CSR (radix sort + dedup-sum + zero
        # elimination): scipy's coo->csr + sum_duplicates lexsorts the
        # ~7M triplets with comparison sorts and many full-size numpy
        # passes (~4.5-6 s at 500k on the 1-vCPU host) where the C++
        # sweep is ~0.5 s
        from tpufem import native
        got = native.coo_to_csr_dedup(rows, cols, vals, n)
        if got is not None:
            indptr, ucols, av = got
            return sp.csr_matrix((av, ucols, indptr), shape=(n, n))
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        A.sum_duplicates()
        A.eliminate_zeros()
        return A

    def apply_np(self, x: np.ndarray) -> np.ndarray:
        """Host twin (setup-phase spectral estimates).  Uses the
        operator's vector layout (planar components when ``planar``)."""
        lay = self.layout
        bs = self.bs
        if self.planar and bs > 1:
            xi = np.ascontiguousarray(x.reshape(bs, -1).T).reshape(-1)
            yi = dataclasses.replace(self, planar=False).apply_np(xi)
            return np.ascontiguousarray(yi.reshape(-1, bs).T).reshape(-1)
        xr = x.reshape(-1, bs)
        grids = [xr[b: b + X * Y * Z * s].reshape(Z, Y, X, s, bs)
                 for b, (X, Y, Z), s in lay.kinds]
        outs = [np.zeros_like(g) for g in grids]

        def mul(W, src):
            if bs == 1:
                return np.asarray(W, dtype=np.float64) * src[..., 0]
            return np.einsum("...rs,...s->...r",
                             np.asarray(W, dtype=np.float64), src)

        for meta, W in self.terms():
            (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), corrs) = meta
            Wn = self._dense_weight_np(meta, W)
            src = grids[ki][z0 + d[2]: z1 + d[2], y0 + d[1]: y1 + d[1],
                            x0 + d[0]: x1 + d[0], si]
            if bs == 1:
                outs[ko][z0:z1, y0:y1, x0:x1, so, 0] += mul(Wn, src)
            else:
                outs[ko][z0:z1, y0:y1, x0:x1, so, :] += mul(Wn, src)
        return np.concatenate([o.reshape(-1, bs) for o in outs]).reshape(-1)


def build_operator(mesh: BoxTetMesh, order: int, problem: str,
                   bc_dofs: Optional[np.ndarray] = None,
                   dtype=jnp.float32, bake_bc: bool = True,
                   device: bool = True, planar: bool = False):
    """Pick the structured-operator representation:

    - P1: DIA stencil (7-15 shift diagonals — smallest HLO, elementwise),
      fused z-zone apply;
    - P2/P3 scalar: const-table DIA across all typed dof grids (230 /
      1311 terms, as precomputed zone weight fields), falling back to
      per-perm element matrices when the lattice is too small for shell
      reconstruction;
    - blocked (bs=3) P2/P3: StructuredOperator (per-perm element
      matrices as einsums instead of a bs^2 scalar decomposition).
    All expose apply / apply_np / diagonal_np / bc_mask.
    """
    if order == 1:
        return DiaOperator.build(mesh, order, problem, bc_dofs=bc_dofs,
                                 dtype=dtype, bake_bc=bake_bc, device=device,
                                 planar=planar)
    if planar:
        raise ValueError("planar layout is implemented for the P1 "
                         "DiaOperator forms only")
    if problem != "elasticity" and order in (2, 3):
        op = DiaOperator.try_const(mesh, order, problem, bc_dofs=bc_dofs,
                                   dtype=dtype, bake_bc=bake_bc,
                                   device=device)
        if op is not None:
            return op
    from tpufem.fem.structured_op import StructuredOperator
    return StructuredOperator.build(mesh, order, problem, bc_dofs=bc_dofs,
                                    dtype=dtype, device=device)
