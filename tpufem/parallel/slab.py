"""Slab-sharded SPMD solver for the structured cube path — the
distributed product path behind ``--num_shards``.

Rebuild of the reference's MPI execution model (every rank owns a mesh
partition, PETSc/Hypre solve across ranks; src/main.cpp:118-233) as an
SPMD program over a 1-D ``jax.sharding.Mesh``:

- **decomposition**: z-slabs of vertex planes.  Shard s holds planes
  [s*nzl, (s+1)*nzl]; the bottom plane is a ghost owned by shard s-1
  (the IndexMap owned/ghost split of the reference's dolfinx backend).
  All shards carry identical static shapes — one compiled program.
- **operator apply**: local slab stencil (partial rows at the interface
  planes — the non-overlapping element partition the reference's
  assembler uses) -> reverse halo: ONE ``ppermute`` carries the
  bottom-plane partial sums to their owner and accumulates
  (scatter_rev(plus), poisson_problem.cpp:154) -> BC rows zeroed ->
  forward halo: ONE ``ppermute`` refreshes the downstream ghosts
  (scatter_fwd, cgpoisson_problem.cpp:224-229).
- **distributed geometric multigrid**: every V-cycle ingredient keeps
  the slab structure.  Restriction accumulates each shard's OWNED fine
  planes only; the contributions that cross the interface ride the same
  reverse halo as the operator apply.  Prolongation is halo-free: every
  local fine plane depends only on coarse planes already in the slab
  (ghosts fresh by invariant).  Once a level is small enough its slabs
  are ``all_gather``-ed and the remaining hierarchy runs REPLICATED on
  every shard (redundant compute on O(N / 8^k) dofs beats communicating
  it) via the single-device GMG — the same level chain, Chebyshev
  interval, and coarse dense inverse as the unsharded solver, so
  iteration counts match the single-device run exactly.
- **reductions**: owned-masked dots under ``psum``
  (the MPI_Allreduce of cg.h:61).

Everything — CG, V-cycle, halos, gathers — runs inside ONE jitted
``shard_map`` program; XLA overlaps the collectives with compute.

BC semantics: rows-zero with b[bc] = 0.  Every Krylov/multigrid vector
vanishes on the BC dofs, so the iterates are identical to CG on the
BC-eliminated (unit-diagonal) operator the single-device assembled path
uses — iteration counts are directly comparable.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tpufem.fem.dia_op import DiaOperator
from tpufem.la.cg import cg_solve
from tpufem.la.chebyshev import (chebyshev_smoother,
                                 chebyshev_smoother_zero)
from tpufem.la.gmg import (GMG, prolong_h, prolong_p, restrict_h,
                           restrict_p, surrogate_lmax)
from tpufem.mesh.structured import BoxTetMesh


def _level_chain(mesh: BoxTetMesh, bs: int, coarse_limit: int,
                 max_levels: int) -> List[Tuple[int, int, int]]:
    """Dyadic level dims, finest first — the SAME walk as GMG.setup
    (gmg.py) so the sharded and single-device hierarchies coincide."""
    chain = [(mesh.Nx, mesh.Ny, mesh.Nz)]
    while True:
        nx, ny, nz = chain[-1]
        ndofs_here = (nx + 1) * (ny + 1) * (nz + 1) * bs
        if (ndofs_here <= coarse_limit or len(chain) >= max_levels
                or nx % 2 or ny % 2 or nz % 2 or min(nx, ny, nz) < 4):
            break
        chain.append((nx // 2, ny // 2, nz // 2))
    return chain


def slab_gmg_viable(mesh: BoxTetMesh, nshards: int, bs: int = 1,
                    coarse_limit: int = 1000,
                    max_levels: int = 12, precond: bool = True) -> bool:
    """True when ShardedCubeSolver.build can shard this mesh: Nz must
    split into equal slabs, and — when a multigrid preconditioner is
    wanted — the finest level's slabs must be EVEN and at least one
    coarser level must exist (the same conditions build() raises on).
    The CLI uses this to route small/indivisible cube configs to the
    rowshard fallback instead of erroring; callers must pass the
    solver's own amg_max_levels/pc_type so the predicate matches what
    build() will actually be asked to do."""
    if mesh.Nz % nshards != 0:
        return False
    if not precond:
        return True  # unpreconditioned CG shards without a chain
    chain = _level_chain(mesh, bs, coarse_limit, max_levels)
    return len(chain) >= 2 and (mesh.Nz // nshards) % 2 == 0


def slab_global_ids(mesh: BoxTetMesh, order: int, nzl: int, S: int,
                    bs: int = 1):
    """[S, nloc] global flat dof indices of each slab's local dofs.

    Kind-by-kind z-slices of the typed dof grids: kinds whose lattice
    direction has dz = 0 span nzl+1 planes and overlap neighbours by the
    interface plane; dz = 1 kinds partition exactly.  Works for every
    order (P1's single vertex kind reduces to the plane-major slab)."""
    from tpufem.fem.structured_op import grid_layout
    lay_g = grid_layout(mesh, order)
    lay_s = grid_layout(BoxTetMesh(mesh.Nx, mesh.Ny, nzl), order)
    ids = np.empty((S, lay_s.ndofs), dtype=np.int64)
    for (bg, (Xg, Yg, Zg), sg), (bl, (Xl, Yl, Zl), sl) in zip(
            lay_g.kinds, lay_s.kinds):
        mrow = Xg * Yg * sg
        loc = bl + np.arange(Zl * mrow)
        for s in range(S):
            ids[s, loc] = bg + (s * nzl) * mrow + np.arange(Zl * mrow)
    if bs > 1:
        ids = (ids[:, :, None] * bs + np.arange(bs)).reshape(S, -1)
    return ids, lay_s


def iface_plan(lay_s, nzl: int, bs: int = 1) -> Tuple:
    """Static flat slices of the slab-interface dofs.

    Only dof kinds whose grid spans nzl+1 z-planes (lattice direction
    dz = 0) have entries ON the plane shared between adjacent slabs —
    dz = 1 kinds live strictly between planes of one slab.  Each entry
    is (bottom_ghost_start, top_owned_start, length); both slices are
    contiguous in the kind-major flat layout, so the halo exchange is a
    concat of static slices + ONE ppermute (no gathers)."""
    plan = []
    for base, (X, Y, Z), s in lay_s.kinds:
        if Z == nzl + 1:
            m = X * Y * s * bs
            plan.append((base * bs, base * bs + nzl * m, m))
    return tuple(plan)


@dataclasses.dataclass
class _Level:
    """Host-side build product for one sharded level."""

    op: DiaOperator        # slab operator (unbaked BC; weights replicated)
    dinv: np.ndarray       # [S, nloc] global-diagonal inverse slabs
    bc: np.ndarray         # [S, nloc] bool
    dims: Tuple[int, int, int]   # global (Nx, Ny, Nz) of this level
    nzl: int               # cube layers per shard
    lmax: float
    order: int             # polynomial order of this level
    iface: Tuple           # interface slice plan (see iface_plan)


@dataclasses.dataclass
class ShardedCubeSolver:
    """Distributed CG (optionally GMG-preconditioned) on BoxTetMesh for
    problem in {"poisson", "elasticity"} (P1; scalar and bs=3)."""

    levels: List[_Level]
    suffix: Optional[GMG]         # replicated coarse hierarchy (None when
    #                               unpreconditioned)
    b_local: jnp.ndarray          # [S, nloc]
    owned: jnp.ndarray            # [S, nloc]
    bs: int
    S: int
    mesh_axis: Mesh
    rtol: float
    maxit: int
    smoother_degree: int
    _cache: dict = dataclasses.field(default_factory=dict)

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls, mesh: BoxTetMesh, nshards: int, problem: str = "poisson",
              order: int = 1, dtype=jnp.float32, rtol: float = 1e-8,
              maxit: int = 100, precond: bool = True,
              coarse_limit: int = 1000, smoother_degree: int = 2,
              max_levels: int = 12, gather_limit: int = 100_000,
              devices=None, b_global: Optional[np.ndarray] = None,
              ) -> "ShardedCubeSolver":
        """Orders >= 2 (scalar) add a p-coarsening level on top of the
        P1 h-chain (the GMG.setup walk, gmg.py): the order-k fine level
        shards over the SAME z-slabs, restrict_p/prolong_p act slab-
        locally, and interface-plane contributions ride the same halo.
        Reference: order-3 runs on 2 ranks in CI (ccpp.yml:86-101)."""
        from tpufem.fem.dirichlet import DirichletBC
        from tpufem.fem.space import FunctionSpace
        from tpufem.problems import common

        bs = 3 if problem == "elasticity" else 1
        marker = (common.elasticity_bc_marker if problem == "elasticity"
                  else common.poisson_bc_marker)
        S = nshards
        if mesh.Nz % S:
            raise ValueError(
                f"Nz={mesh.Nz} not divisible by {S} shards "
                "(compute_box_size_structured(num_shards=...) guarantees "
                "this for CLI meshes)")

        chain = _level_chain(mesh, bs, coarse_limit, max_levels)
        lmax_of = {}
        if precond:
            # sharded prefix: levels whose z extent splits into equal
            # even slabs; the first level at/below gather_limit dofs
            # switches to the replicated suffix
            K = 0
            while (K + 1 < len(chain)
                   and chain[K][2] % S == 0 and (chain[K][2] // S) % 2 == 0
                   and (K == 0  # the finest level always shards
                        or (chain[K][0] + 1) * (chain[K][1] + 1)
                           * (chain[K][2] + 1) * bs > gather_limit)):
                K += 1
            if K == 0:
                raise ValueError(
                    f"cannot shard {mesh.Nx}x{mesh.Ny}x{mesh.Nz} over {S} "
                    f"slabs with multigrid (Nz/S={mesh.Nz // S} must be "
                    "even); increase the mesh or lower the shard count")
            for k in sorted({1, order}):
                lmax_of[k] = surrogate_lmax(mesh, k, problem, marker, dtype)
            specs = ([(chain[0], order)] if order > 1 else []) \
                + [(chain[i], 1) for i in range(K)]
        else:
            lmax_of = {order: 1.0}
            specs = [(chain[0], order)]

        from tpufem.fem.dia_op import build_operator as build_host_op

        levels: List[_Level] = []
        ids0 = None
        for dims, kord in specs:
            nx, ny, nz = dims
            nzl = nz // S
            slab = BoxTetMesh(nx, ny, nzl)
            h_over = (1.0 / nx, 1.0 / ny, 1.0 / nz)
            if kord == 1:
                op = DiaOperator.build(slab, 1, problem, dtype=dtype,
                                       h_override=h_over, bake_bc=False)
            elif kord == 2:
                op = DiaOperator.try_const(slab, kord, problem, dtype=dtype,
                                           bake_bc=False, h_override=h_over)
                if op is None:
                    op = DiaOperator.build(slab, kord, problem, dtype=dtype,
                                           h_override=h_over, bake_bc=False,
                                           mode="dense")
            else:
                # P3: per-perm constant-element-matrix apply (the 1311
                # shift diagonals' zone expansion would dominate the
                # V-cycle's compile; the StructuredOperator form is the
                # single-device production choice too)
                from tpufem.fem.structured_op import StructuredOperator
                op = StructuredOperator.build(slab, kord, problem,
                                              dtype=dtype,
                                              h_override=h_over)
            gmesh = BoxTetMesh(nx, ny, nz)
            ids, lay_s = slab_global_ids(gmesh, kord, nzl, S, bs)
            gop = build_host_op(gmesh, kord, problem, bc_dofs=None,
                                dtype=jnp.float64, bake_bc=False,
                                device=False)
            dinv_g = 1.0 / gop.diagonal_np()
            gspace = FunctionSpace(gmesh, kord, bs=bs)
            gbc = DirichletBC.from_space(
                gspace, gmesh.locate_boundary_facets(marker))
            gmask = np.zeros(gspace.ndofs, dtype=bool)
            gmask[gbc.flat_dofs()] = True
            if not levels:
                fine_bc, ids0 = gbc, ids
            levels.append(_Level(
                op=op,
                dinv=dinv_g[ids].astype(np.dtype(dtype)),
                bc=gmask[ids],
                dims=dims, nzl=nzl, lmax=lmax_of[kord], order=kord,
                iface=iface_plan(lay_s, nzl, bs)))

        suffix = None
        if precond:
            suffix = GMG.setup(BoxTetMesh(*chain[K]), 1, problem, marker,
                               dtype=dtype, coarse_limit=coarse_limit,
                               smoother_degree=smoother_degree,
                               max_levels=max_levels - K)

        # RHS + owned masks on the finest level
        if b_global is None:
            b_global = _default_rhs(mesh, problem, bs, order)
        bg = np.asarray(b_global, dtype=np.float64).copy()
        bg[fine_bc.flat_dofs()] = 0.0
        b_local = bg[ids0]
        owned = np.ones(ids0.shape, dtype=bool)
        for (b0, _t, m) in levels[0].iface:
            owned[1:, b0: b0 + m] = False

        if devices is None:
            devices = jax.devices()
        if len(devices) < S:
            raise ValueError(f"need {S} devices, have {len(devices)}")
        mesh_axis = Mesh(np.array(devices[:S]), ("shard",))
        sol = cls(levels=levels, suffix=suffix,
                  b_local=jnp.asarray(b_local.astype(np.dtype(dtype))),
                  owned=jnp.asarray(owned), bs=bs, S=S,
                  mesh_axis=mesh_axis, rtol=rtol, maxit=maxit,
                  smoother_degree=smoother_degree)
        sol._ids0 = ids0
        sol._ndofs_global = (FunctionSpace(mesh, order, bs=bs).ndofs)
        return sol

    @classmethod
    def build_per_host(cls, mesh: BoxTetMesh, nshards: int,
                       problem: str = "poisson", order: int = 1,
                       dtype=jnp.float32,
                       rtol: float = 1e-8, maxit: int = 100,
                       precond: bool = True, coarse_limit: int = 1000,
                       smoother_degree: int = 2, max_levels: int = 12,
                       gather_limit: int = 100_000) -> "ShardedCubeSolver":
        """Multi-process (multi-host) construction — all orders.

        Identical solver to :meth:`build`, but every [S, nloc] array is
        materialized through ``multihost.make_sharded_rows``: the
        builder callbacks run ONLY for the shards this process
        addresses, and each derives its shard's data from SLAB-LOCAL
        constructions (translation-invariant diagonal, z-independent BC
        markers, partial RHS + one interface halo) — no process ever
        holds a global array.  This is the reference's per-node setup
        split (MPI_Comm_split_type subcommunicator, src/mesh.cpp:164-180)
        in SPMD form; the replicated coarse suffix is built once per
        host, like the reference's node-leader partitioning.

        Orders >= 2 add the sharded p-coarsening fine level exactly as
        :meth:`build` (reference CI runs order 3 on 2 ranks,
        ccpp.yml:86-101); ``precond=False`` runs plain distributed CG
        (the cgpoisson convention)."""
        from tpufem.fem.dirichlet import DirichletBC
        from tpufem.fem.space import FunctionSpace
        from tpufem.fem.structured_op import grid_layout
        from tpufem.parallel.multihost import (make_sharded_rows,
                                               shard_devices)
        from tpufem.problems import common

        bs = 3 if problem == "elasticity" else 1
        marker = (common.elasticity_bc_marker if problem == "elasticity"
                  else common.poisson_bc_marker)
        S = nshards
        if mesh.Nz % S:
            raise ValueError(f"Nz={mesh.Nz} not divisible by {S} shards")

        chain = _level_chain(mesh, bs, coarse_limit, max_levels)
        lmax_of = {}
        if precond:
            K = 0
            while (K + 1 < len(chain)
                   and chain[K][2] % S == 0 and (chain[K][2] // S) % 2 == 0
                   and (K == 0
                        or (chain[K][0] + 1) * (chain[K][1] + 1)
                           * (chain[K][2] + 1) * bs > gather_limit)):
                K += 1
            if K == 0:
                raise ValueError("cannot shard with multigrid")
            for k in sorted({1, order}):
                lmax_of[k] = surrogate_lmax(mesh, k, problem, marker, dtype)
            specs = ([(chain[0], order)] if order > 1 else []) \
                + [(chain[i], 1) for i in range(K)]
        else:
            K = 1
            lmax_of = {order: 1.0}
            specs = [(chain[0], order)]

        devices = shard_devices(S)
        dt = np.dtype(dtype)
        levels: List[_Level] = []
        for dims, kord in specs:
            nx, ny, nz = dims
            nzl = nz // S
            slab = BoxTetMesh(nx, ny, nzl)
            h_over = (1.0 / nx, 1.0 / ny, 1.0 / nz)
            if kord == 1:
                op = DiaOperator.build(slab, 1, problem, dtype=dtype,
                                       h_override=h_over, bake_bc=False)
            elif kord == 2:
                op = DiaOperator.try_const(slab, kord, problem, dtype=dtype,
                                           bake_bc=False, h_override=h_over)
                if op is None:
                    op = DiaOperator.build(slab, kord, problem, dtype=dtype,
                                           h_override=h_over, bake_bc=False,
                                           mode="dense")
            else:
                from tpufem.fem.structured_op import StructuredOperator
                op = StructuredOperator.build(slab, kord, problem,
                                              dtype=dtype,
                                              h_override=h_over)
            lay_s = grid_layout(slab, kord)
            d_slab = op.diagonal_np()
            lspace = FunctionSpace(slab, kord, bs=bs)
            lbc = DirichletBC.from_space(
                lspace, slab.locate_boundary_facets(marker))
            lmask = np.zeros(lspace.ndofs, dtype=bool)
            lmask[lbc.flat_dofs()] = True
            nloc = lspace.ndofs

            def dinv_row(s, ds=d_slab, lay=lay_s, z=nzl):
                return _slab_dinv_row_k(ds, lay, z, bs, s, S).astype(dt)

            levels.append(_Level(
                op=op,
                dinv=make_sharded_rows(S, (nloc,), dt, dinv_row, devices),
                bc=make_sharded_rows(S, (nloc,), np.bool_,
                                     lambda s, mm=lmask: mm, devices),
                dims=dims, nzl=nzl, lmax=lmax_of[kord], order=kord,
                iface=iface_plan(lay_s, nzl, bs)))

        suffix = None
        if precond:
            suffix = GMG.setup(BoxTetMesh(*chain[K]), 1, problem, marker,
                               dtype=dtype, coarse_limit=coarse_limit,
                               smoother_degree=smoother_degree,
                               max_levels=max_levels - K)

        nzl0 = chain[0][2] // S
        nloc0 = levels[0].dinv.shape[1]
        b_arr = make_sharded_rows(
            S, (nloc0,), dt,
            lambda s: _slab_partial_rhs(mesh, problem, s, S, nzl0,
                                        order=order).astype(dt), devices)

        def owned_row(s):
            o = np.ones(nloc0, dtype=bool)
            if s > 0:
                for (b0, _t, mm) in levels[0].iface:
                    o[b0: b0 + mm] = False
            return o

        owned = make_sharded_rows(S, (nloc0,), np.bool_, owned_row, devices)

        mesh_axis = Mesh(np.array(devices), ("shard",))
        # accumulate interface partials onto owners, zero BC rows,
        # refresh ghosts: ONE tiny SPMD program at build time
        plan0 = levels[0].iface
        down = [(s, s - 1) for s in range(1, S)]
        up = [(s, s + 1) for s in range(S - 1)]

        def fix_b(b, bcm):
            y, bm = b[0], bcm[0]
            segs = [y[b0: b0 + mm] for (b0, _t, mm) in plan0]
            buf = segs[0] if len(segs) == 1 else jnp.concatenate(segs)
            recv = jax.lax.ppermute(buf, "shard", down)
            off = 0
            for (b0, t, mm) in plan0:
                y = y.at[t: t + mm].add(recv[off: off + mm])
                off += mm
            y = jnp.where(bm, 0.0, y)
            segs = [y[t: t + mm] for (_b, t, mm) in plan0]
            buf = segs[0] if len(segs) == 1 else jnp.concatenate(segs)
            recv = jax.lax.ppermute(buf, "shard", up)
            is_first = jax.lax.axis_index("shard") == 0
            off = 0
            for (b0, _t, mm) in plan0:
                y = y.at[b0: b0 + mm].set(
                    jnp.where(is_first, y[b0: b0 + mm],
                              recv[off: off + mm]))
                off += mm
            return y[None]

        b_fixed = jax.jit(jax.shard_map(
            fix_b, mesh=mesh_axis, in_specs=(P("shard"), P("shard")),
            out_specs=P("shard")))(b_arr, levels[0].bc)

        sol = cls(levels=levels, suffix=suffix, b_local=b_fixed,
                  owned=owned, bs=bs, S=S, mesh_axis=mesh_axis,
                  rtol=rtol, maxit=maxit,
                  smoother_degree=smoother_degree)
        sol._ids0, _ = slab_global_ids(mesh, order, nzl0, S, bs)
        sol._ndofs_global = FunctionSpace(mesh, order, bs=bs).ndofs
        return sol

    # -- the jitted SPMD program ------------------------------------------------
    def _build_program(self):
        S = self.S
        bs = self.bs
        rtol, maxit = self.rtol, self.maxit
        degree = self.smoother_degree
        # static per-level metadata (closed over; only arrays are args)
        meta = [(lv.dims, lv.nzl, lv.lmax, lv.order, lv.iface)
                for lv in self.levels]
        K = len(self.levels)
        preconditioned = self.suffix is not None
        suffix_bc_static = (preconditioned and not self.suffix.levels)
        down = [(s, s - 1) for s in range(1, S)]
        up = [(s, s + 1) for s in range(S - 1)]

        def shard_fn(ops, ldinv, lbc, owned, b, suffix):
            # ops: per-level slab DiaOperators, passed through shard_map
            # as replicated pytrees (every shard runs the same slab
            # stencil; only the diagonal/BC/rhs slabs are sharded)
            ldinv = [d[0] for d in ldinv]
            lbc = [m[0] for m in lbc]
            owned = owned[0]
            b = b[0]

            def halo_rev(y, plan):
                """Interface partial sums -> owner above, accumulate.
                ONE ppermute over the concatenated interface slices."""
                segs = [y[b0: b0 + m] for (b0, _t, m) in plan]
                buf = segs[0] if len(segs) == 1 else jnp.concatenate(segs)
                recv = jax.lax.ppermute(buf, "shard", down)
                off = 0
                for (b0, t, m) in plan:
                    y = y.at[t: t + m].add(recv[off: off + m])
                    off += m
                return y

            def halo_fwd(y, plan):
                """Owner's interface values -> downstream ghosts."""
                segs = [y[t: t + m] for (_b, t, m) in plan]
                buf = segs[0] if len(segs) == 1 else jnp.concatenate(segs)
                recv = jax.lax.ppermute(buf, "shard", up)
                is_first = jax.lax.axis_index("shard") == 0
                off = 0
                for (b0, _t, m) in plan:
                    y = y.at[b0: b0 + m].set(
                        jnp.where(is_first, y[b0: b0 + m],
                                  recv[off: off + m]))
                    off += m
                return y

            def zero_ghost(v, plan):
                """Zero the ghost interface slices on non-first shards
                (each interface dof restricted exactly once)."""
                is_first = jax.lax.axis_index("shard") == 0
                for (b0, _t, m) in plan:
                    v = v.at[b0: b0 + m].set(
                        jnp.where(is_first, v[b0: b0 + m], 0.0))
                return v

            def action(i, x):
                y = ops[i].apply(x)
                y = halo_rev(y, meta[i][4])
                y = jnp.where(lbc[i], 0.0, y)
                return halo_fwd(y, meta[i][4])

            def grid(i, v, coarse=False):
                (nx, ny, _nz), nzl = meta[i][0], meta[i][1]
                if coarse:
                    nx, ny, nzl = nx // 2, ny // 2, nzl // 2
                shape = (nzl + 1, ny + 1, nx + 1) + ((bs,) if bs > 1 else ())
                return v.reshape(shape)

            def suffix_bc0():
                return (suffix.coarse_bc_mask if suffix_bc_static
                        else suffix.levels[0].op.bc_mask)

            def vcycle(i, r):
                smooth = chebyshev_smoother(lambda v: action(i, v),
                                            ldinv[i], meta[i][2],
                                            degree=degree)
                smooth0 = chebyshev_smoother_zero(
                    lambda v: action(i, v), ldinv[i], meta[i][2],
                    degree=degree)
                # residual-tracking pre-smoothing from zero (mirrors
                # la.gmg.GMG.vcycle — one action instance in the scan
                # + the closing residual, vs degree+2 inlined)
                x, rr = smooth0(r)
                rr = jnp.where(lbc[i], 0.0, rr)
                # restrict OWNED dofs only (ghost interface slices
                # zeroed); cross-interface contributions ride the
                # reverse halo of the coarse level
                rr = zero_ghost(rr, meta[i][4])
                p_transfer = meta[i][3] > 1
                if p_transfer:
                    # order-k -> P1 on the SAME lattice (slab-local
                    # point evaluation; gmg.prolong_p/restrict_p work
                    # on the slab grids unchanged — every P_k node is
                    # interpolated from vertices in the same slab,
                    # ghost plane fresh by invariant)
                    rc = restrict_p(rr, ops[i], bs).reshape(-1)
                else:
                    rc = restrict_h(grid(i, rr), None).reshape(-1)
                if i + 1 < K:
                    rc = halo_rev(rc, meta[i + 1][4])
                    rc = jnp.where(lbc[i + 1], 0.0, rc)
                    rc = halo_fwd(rc, meta[i + 1][4])
                    ec = vcycle(i + 1, rc)
                else:
                    # gather the coarse slabs; run the replicated suffix
                    (nx, ny, _nz), nzl = meta[i][0], meta[i][1]
                    cm = (nx // 2 + 1) * (ny // 2 + 1) * bs
                    ctop = (nzl // 2) * cm
                    recv = jax.lax.ppermute(rc[:cm], "shard", down)
                    rc = rc.at[ctop: ctop + cm].add(recv)
                    ag = jax.lax.all_gather(rc, "shard")  # [S, nloc_c]
                    glob = jnp.concatenate([ag[0], ag[1:, cm:].reshape(-1)])
                    glob = jnp.where(suffix_bc0(), 0.0, glob)
                    eg = suffix.vcycle(glob)
                    eg = jnp.where(suffix_bc0(), 0.0, eg)
                    k = jax.lax.axis_index("shard")
                    ec = jax.lax.dynamic_slice(eg, (k * ctop,),
                                               ((nzl // 2 + 1) * cm,))
                if p_transfer:
                    e = prolong_p(grid(i + 1, ec), ops[i]).reshape(-1)
                else:
                    e = prolong_h(grid(i, ec, coarse=True),
                                  None).reshape(-1)
                e = jnp.where(lbc[i], 0.0, e)
                x = x + e
                return smooth(x, r)


            def dot(u, v):
                t = (jnp.float64 if (u.dtype == jnp.float32
                                     and jax.config.jax_enable_x64)
                     else u.dtype)
                local = jnp.sum(jnp.where(owned,
                                          u.astype(t) * v.astype(t), 0.0))
                return jax.lax.psum(local, "shard")

            M = (lambda r: vcycle(0, r)) if preconditioned else None
            x, it, rel = cg_solve(lambda v: action(0, v), b,
                                  precond=M, rtol=rtol, maxit=maxit,
                                  dot_fn=dot)
            return x[None], it, rel

        ops_arg = tuple(lv.op for lv in self.levels)
        ops_specs = jax.tree.map(lambda _: P(), ops_arg)
        fn = jax.shard_map(
            shard_fn, mesh=self.mesh_axis,
            in_specs=(ops_specs, (P("shard"),) * K, (P("shard"),) * K,
                      P("shard"), P("shard"), P()),
            out_specs=(P("shard"), P(), P()),
        )
        return jax.jit(fn)

    def _run(self, b):
        if "run" not in self._cache:
            self._cache["args"] = (
                tuple(lv.op for lv in self.levels),
                tuple(jnp.asarray(lv.dinv) for lv in self.levels),
                tuple(jnp.asarray(lv.bc) for lv in self.levels))
            from tpufem.aot import lower
            self._cache["run"] = lower(
                self._build_program(), *self._cache["args"], self.owned, b,
                self.suffix).compile()
        ops, ldinv, lbc = self._cache["args"]
        return self._cache["run"](ops, ldinv, lbc, self.owned, b, self.suffix)

    # -- public API -------------------------------------------------------------
    def solve(self) -> Tuple[np.ndarray, int, float]:
        x_loc, it, rel = self._run(self.b_local)
        jax.block_until_ready(x_loc)
        return self.collect(np.asarray(x_loc)), int(it), float(rel)

    def solve_timed(self, reps: int = 3) -> Tuple[np.ndarray, int, float, float]:
        """(x, iterations, rel, seconds): mean over ``reps`` perturbed
        solves after a warm-up solve."""
        jax.block_until_ready(self._run(self.b_local)[0])
        t0 = time.perf_counter()
        outs = [self._run(self.b_local * (1.0 + 1e-6 * (i + 1)))[0]
                for i in range(reps)]
        jax.block_until_ready(outs)
        dt = (time.perf_counter() - t0) / reps
        x_loc, it, rel = self._run(self.b_local)
        x = self.collect(np.asarray(jax.block_until_ready(x_loc)))
        return x, int(it), float(rel), dt

    def collect(self, x_loc: np.ndarray) -> np.ndarray:
        """Global dof vector from the per-shard slabs (ghost interface
        copies overwrite with identical owner values — fwd invariant)."""
        out = np.empty(self._ndofs_global, dtype=x_loc.dtype)
        for s in range(self.S):
            out[self._ids0[s]] = x_loc[s]
        return out


def _default_rhs(mesh: BoxTetMesh, problem: str, bs: int,
                 order: int = 1) -> np.ndarray:
    """Host f64 RHS for the benchmark problems (one-time setup)."""
    from tpufem.fem.space import FunctionSpace
    space = FunctionSpace(mesh, order, bs=bs)
    if problem == "elasticity":
        from tpufem.problems.elasticity import assemble_elasticity_rhs_np
        return assemble_elasticity_rhs_np(space)
    from tpufem.problems.poisson import assemble_poisson_rhs_np
    return assemble_poisson_rhs_np(space)


# ---------------------------------------------------------------------------
# Per-host (multi-process) builders — P1.  Every quantity below is
# computed from SLAB-LOCAL data only (no global arrays), so under
# jax.make_array_from_callback each process materializes nothing beyond
# the shards it addresses (the reference's node-level subcommunicator
# setup split, src/mesh.cpp:164-180).
# ---------------------------------------------------------------------------


def _slab_dinv_row(d_slab: np.ndarray, s: int, S: int, nzl: int) -> np.ndarray:
    """Shard s's [nzl+1, m] inverse-diagonal slab from ONE slab
    operator's raw diagonal: the stencil diagonal is z-translation-
    invariant, so interior planes repeat, global z-end planes keep the
    truncated value, and interface planes sum both halves."""
    g = d_slab.copy()
    if s > 0:
        g[0] = d_slab[0] + d_slab[nzl]
    if s < S - 1:
        g[nzl] = d_slab[0] + d_slab[nzl]
    return 1.0 / g


def _slab_dinv_row_k(d_flat: np.ndarray, lay_s, nzl: int, bs: int,
                     s: int, S: int) -> np.ndarray:
    """Order-general version of :func:`_slab_dinv_row`: the interface
    fix applies per dof KIND, to the kinds whose typed grid spans
    nzl+1 z-planes (dz = 0 kinds — only those have dofs ON the shared
    plane; dz = 1 kinds' dofs take contributions from their own layer's
    cells only, so the slab diagonal is already exact)."""
    g = d_flat.copy()
    for base, (X, Y, Z), sl in lay_s.kinds:
        if Z != nzl + 1:
            continue
        m = X * Y * sl * bs
        b0 = base * bs
        seg = g[b0: b0 + Z * m].reshape(Z, m)
        dsl = d_flat[b0: b0 + Z * m].reshape(Z, m)
        if s > 0:
            seg[0] = dsl[0] + dsl[nzl]
        if s < S - 1:
            seg[nzl] = dsl[0] + dsl[nzl]
    return 1.0 / g


def _slab_partial_rhs(mesh: BoxTetMesh, problem: str, s: int, S: int,
                      nzl: int, order: int = 1) -> np.ndarray:
    """Shard s's PARTIAL order-k RHS (volume term over the slab's own
    cells + surface term over the slab faces that lie on the GLOBAL
    boundary; interface-plane contributions stay partial and are
    accumulated by one reverse/forward halo at build)."""
    import jax.numpy as jnp

    from tpufem.fem.space import FunctionSpace
    from tpufem.fem.structured_op import StructuredOperator
    from tpufem.problems import common
    Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
    slab = BoxTetMesh(Nx, Ny, nzl)
    space = FunctionSpace(slab, order)
    # dof coords in GLOBAL space: slab-normalized z -> (s*nzl + k)/Nz
    coords = space.scalar_dof_coords().copy()
    coords[:, 2] = (coords[:, 2] * nzl + s * nzl) / Nz
    # anisotropy: physical cube size is the GLOBAL h, not the slab's
    mass = StructuredOperator.build(slab, order, "mass",
                                    dtype=jnp.float64, device=False,
                                    h_override=(1.0 / Nx, 1.0 / Ny,
                                                1.0 / Nz))
    if problem == "elasticity":
        comps = common.elasticity_f_components(coords[:, 0], coords[:, 1],
                                               coords[:, 2])
        return np.stack(
            [mass.apply_raw_np(np.ascontiguousarray(
                np.broadcast_to(c, coords.shape[:1]), dtype=np.float64))
             for c in comps], axis=-1).reshape(-1)
    b = mass.apply_raw_np(common.poisson_f(coords))
    # Poisson surface term g = sin(5 x0) over global-boundary faces of
    # the slab (x/y faces always; z faces only at the global ends)
    from tpufem.fem.structured_op import dof_gids_for_cells
    from tpufem.mesh.structured import CELL_VERTEX_OFFSETS, LOCAL_FACES
    facets = slab.boundary_faces()
    cubes, perms, lf = slab.boundary_facet_cells(facets)
    cd_cells = dof_gids_for_cells(slab, order, cubes, perms)
    h = np.array([1.0 / Nx, 1.0 / Ny, 1.0 / Nz])
    verts = (cubes[:, None, :] + CELL_VERTEX_OFFSETS[perms]).astype(
        np.float64)
    verts[:, :, 2] += s * nzl
    verts = verts * h
    tri = np.take_along_axis(verts, LOCAL_FACES[lf][:, :, None], axis=1)
    # keep only faces on the GLOBAL boundary: z-interface planes of the
    # slab are interior to the global cube (their facet integral belongs
    # to no one)
    lo = s * nzl / Nz
    hi = (s + 1) * nzl / Nz
    keep = np.ones(len(lf), dtype=bool)
    if s > 0:
        keep &= ~(np.abs(tri[:, :, 2] - lo) < 1e-12).all(axis=1)
    if s < S - 1:
        keep &= ~(np.abs(tri[:, :, 2] - hi) < 1e-12).all(axis=1)
    gdof = common.poisson_g(coords)
    from tpufem.problems.poisson import _facet_rhs_np
    b += _facet_rhs_np(space.element, gdof[cd_cells[keep]], cd_cells[keep],
                       tri[keep], lf[keep], space.ndofs_scalar)
    return b
