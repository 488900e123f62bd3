"""Assembled-matrix Poisson problem.

Rebuild of ``poisson::problem`` (reference: src/poisson_problem.cpp:31-182):
P1-P3 GLL-warped Lagrange space; Dirichlet u=0 on x0 in {0,1}; RHS
f = Gaussian bump (volume) + g = sin(5 x0) (surface); operator with BC
rows/cols eliminated + unit diagonal; solver closure = from-scratch CG
preconditioned by geometric multigrid (structured path) or SA-AMG
(general path) — replacing PETSc KSP + Hypre BoomerAMG
(README.md:110-128).

Structure: on the cube mesh the "assembled matrix" is the
constant-stencil StructuredOperator (numerically identical to the
BC-eliminated CSR matrix; tests assert equality) — no gather/scatter in
the solve.  Setup (RHS, BC location, element constants) is host-side
float64; only the jitted solve touches the device.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.config import Config
from tpufem.fem import kernels
from tpufem.fem.assemble import DofScatter, assemble_operator
from tpufem.fem.dirichlet import DirichletBC
from tpufem.fem.space import FunctionSpace
from tpufem.la.cg import cg_solve
from tpufem.mesh.structured import BoxTetMesh
from tpufem.problems import common
from tpufem.timing import Timer


def assemble_poisson_rhs(space: FunctionSpace, scatter: DofScatter,
                         dtype) -> jnp.ndarray:
    """Device RHS assembly: b_i = int f v dx + int g v ds over the whole
    exterior boundary (form L, src/Poisson.py:32)."""
    mesh = space.mesh
    order = space.order
    f = space.interpolate(common.poisson_f)
    g = space.interpolate(common.poisson_g)

    coords = jnp.asarray(mesh.cell_coords(), dtype=dtype)
    cd = space.cell_dofs
    f_cells = jnp.asarray(f[cd], dtype=dtype)
    b_cells = kernels.poisson_rhs_cells(coords, f_cells, order)
    b = scatter.scatter_add(b_cells)

    facets = mesh.boundary_faces()
    cells, lf = common.facet_to_cell(mesh.cell_faces(), facets)
    fc_coords = jnp.asarray(mesh.cell_coords()[cells], dtype=dtype)
    g_cells = jnp.asarray(g[cd[cells]], dtype=dtype)
    contrib = kernels.facet_rhs_cells(fc_coords, jnp.asarray(lf), g_cells, order)
    flat = cd[cells].reshape(-1)
    b = b.at[jnp.asarray(flat)].add(contrib.reshape(-1))
    return b


def _facet_rhs_structured_np(space: FunctionSpace) -> np.ndarray:
    """Host O(surface) boundary term of L on BoxTetMesh (closed-form
    facet->cell table; the volume term is assembled on-device)."""
    from tpufem.fem.structured_op import dof_gids_for_cells
    from tpufem.mesh.structured import CELL_VERTEX_OFFSETS, LOCAL_FACES
    mesh = space.mesh
    # the facet dofmap and area-weighted facet mass tensors are pure
    # mesh geometry/connectivity — memoized on the immutable mesh (the
    # DOLFINx model: connectivity + geometry built once per mesh); the
    # g-integration below is recomputed per assembly
    geom = mesh.__dict__.get("_facet_geom_cache", {}).get(space.order)
    if geom is None:
        facets = mesh.boundary_faces()
        cubes, perms, lf = mesh.boundary_facet_cells(facets)
        cd_cells = dof_gids_for_cells(mesh, space.order, cubes, perms)
        h = np.array([1.0 / mesh.Nx, 1.0 / mesh.Ny, 1.0 / mesh.Nz])
        verts = (cubes[:, None, :] + CELL_VERTEX_OFFSETS[perms]) * h
        tri = np.take_along_axis(verts, LOCAL_FACES[lf][:, :, None], axis=1)
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
        W = space.element.facet_mass_tensors[lf] * area2[:, None, None]
        geom = (cd_cells, W)
        cache = mesh.__dict__.get("_facet_geom_cache")
        if cache is None:
            cache = {}
            object.__setattr__(mesh, "_facet_geom_cache", cache)
        cache[space.order] = geom
    cd_cells, W = geom
    if space.order == 1:
        # evaluate g only at the O(surface) facet dofs (vertex gids
        # decode to coords in closed form) — interpolating over all N
        # dofs was ~half the P1 structured RHS wall
        g_cells = common.poisson_g(
            mesh.vertex_coords(cd_cells.reshape(-1))).reshape(cd_cells.shape)
    else:
        g_cells = space.interpolate(common.poisson_g)[cd_cells]
    contrib = np.einsum("fij,fj->fi", W, g_cells)
    return np.bincount(cd_cells.reshape(-1), weights=contrib.reshape(-1),
                       minlength=space.ndofs_scalar)


def assemble_poisson_rhs_structured_dev(space: FunctionSpace, bc, dtype):
    """Device-side production RHS on BoxTetMesh: the volume term is ONE
    jitted mass-operator apply (constant-stencil — no gathers).  On the
    P1 path the closed-form f is evaluated ON DEVICE from iota coords
    (it only varies in (x, y) — a 2-D field broadcast along z) and the
    O(surface) host facet term ships as a sparse (idx, val) pair, so
    the whole assembly is one small-argument dispatch.  Replaces the
    O(N) host mass apply that dominated setup time (reference assembles
    b once per run, poisson_problem.cpp:118-131)."""
    mesh = space.mesh
    nd = np.dtype(dtype)
    b_facet = _facet_rhs_structured_np(space)
    bc_idx = jnp.asarray(bc.flat_dofs().astype(np.int32))
    bc_val = jnp.asarray(nd.type(bc.value))

    if space.order == 1:
        from tpufem.fem.dia_op import DiaOperator
        mass = DiaOperator.build(mesh, 1, "mass", dtype=dtype)
        Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
        fnz = np.flatnonzero(b_facet != 0.0)

        def make_rhs1():
            def rhs1(mass, fidx, fvals, idx, val):
                x = jnp.arange(Nx + 1, dtype=dtype) / Nx
                y = jnp.arange(Ny + 1, dtype=dtype) / Ny
                # the SHARED closed form (common.poisson_f_xy) evaluated
                # on traced coords — device and host paths cannot diverge
                f2d = common.poisson_f_xy(x[None, :], y[:, None], jnp)
                fd = jnp.broadcast_to(
                    f2d, (Nz + 1, Ny + 1, Nx + 1)).reshape(-1)
                b = mass.apply(fd)
                b = b.at[fidx].add(fvals)
                return b.at[idx].set(val)
            return rhs1

        from tpufem.aot import compile_aot_cached
        args = (mass, jnp.asarray(fnz.astype(np.int32)),
                jnp.asarray(b_facet[fnz].astype(nd)), bc_idx, bc_val)
        key = ("poisson_rhs1", Nx, Ny, Nz, nd.str, fnz.size, bc_idx.size)
        return compile_aot_cached(key, make_rhs1, *args)(*args)

    from tpufem.fem.structured_op import StructuredOperator
    mass = StructuredOperator.build(mesh, space.order, "mass", dtype=dtype)
    f = space.interpolate(common.poisson_f)

    def make_rhs():
        def rhs(mass, fd, bf, idx, val):
            return (mass.apply_raw(fd) + bf).at[idx].set(val)
        return rhs

    from tpufem.aot import compile_aot_cached
    args = (mass, jnp.asarray(f.astype(nd)),
            jnp.asarray(b_facet.astype(nd)), bc_idx, bc_val)
    key = ("poisson_rhsPk", mesh.Nx, mesh.Ny, mesh.Nz, space.order,
           nd.str, bc_idx.size)
    return compile_aot_cached(key, make_rhs, *args)(*args)


def _facet_rhs_np(el, g_cells: np.ndarray, cd_cells: np.ndarray,
                  tri: np.ndarray, lf: np.ndarray, ndofs: int) -> np.ndarray:
    """Boundary term of L: sum over facets of 2*area * S_lf @ g_cell.
    ``g_cells``: g evaluated at the cell dofs, [F, n]."""
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    S = el.facet_mass_tensors[lf]  # [F, n, n]
    contrib = np.einsum("fij,fj->fi", S, g_cells) * area2[:, None]
    return np.bincount(cd_cells.reshape(-1), weights=contrib.reshape(-1),
                       minlength=ndofs)


def assemble_poisson_rhs_np(space: FunctionSpace) -> np.ndarray:
    """Host float64 twin of assemble_poisson_rhs (the production setup
    path).  On BoxTetMesh the volume term is a structured mass-stencil
    apply and the boundary term uses the closed-form facet->cell table —
    no O(cells) dofmap or topology scans (this host has 1 vCPU)."""
    from tpufem.mesh.structured import LOCAL_FACES, BoxTetMesh
    mesh = space.mesh
    el = space.element
    f = space.interpolate(common.poisson_f)
    g = space.interpolate(common.poisson_g)

    if isinstance(mesh, BoxTetMesh):
        from tpufem.fem.structured_op import StructuredOperator
        mass_op = StructuredOperator.build(mesh, space.order, "mass",
                                           dtype=jnp.float64, device=False)
        return mass_op.apply_raw_np(f) + _facet_rhs_structured_np(space)

    from tpufem.fem.assemble import detJ_np
    cd = space.cell_dofs
    coords = mesh.cell_coords()
    adet = detJ_np(coords)
    b_cells = (f[cd] @ el.mass_tensor.T) * adet[:, None]
    b = np.bincount(cd.reshape(-1), weights=b_cells.reshape(-1),
                    minlength=space.ndofs_scalar)
    facets = mesh.boundary_faces()
    cells, lf = common.facet_to_cell(mesh.cell_faces(), facets)
    tri = np.take_along_axis(coords[cells], LOCAL_FACES[lf][:, :, None], axis=1)
    b += _facet_rhs_np(el, g[cd[cells]], cd[cells], tri, lf,
                       space.ndofs_scalar)
    return b


def _try_window(csr_, bc, solver, dtype, nns=None):
    """RCM + block-windowed fine operator for the unstructured AMG path
    (fem.window_op), opt-in with -amg_fine_window on.  Returns
    (None,)*4 unless enabled, and for block-form CSR (bs>1 keeps the
    ELL path).  Near-nullspace candidates are returned RCM-permuted to
    match csr_w."""
    if str(solver.get("amg_fine_window")) != "on":
        return None, None, None, None
    if np.asarray(csr_[2]).ndim != 1:
        return None, None, None, None
    from tpufem.fem.window_op import WindowedMatrix, rcm_csr
    perm, csr_w = rcm_csr(*csr_)
    wop = WindowedMatrix.from_csr(*csr_w, dtype=np.dtype(dtype), perm=perm)
    if wop is None:  # index space beyond int32: the ELL path serves
        return None, None, None, None
    mask = bc.mask()
    return (wop, csr_w, (mask[perm] if mask is not None else None),
            (nns[:, perm] if nns is not None else None))


def make_solver(A, csr, mesh, order: int, problem_name: str, bc, nns,
                cfg: Config, dtype, planar: bool = False, fidelity=None):
    """Shared CG-solver closure for poisson/elasticity: resolves the
    preconditioner (auto -> gmg on BoxTetMesh, amg otherwise), builds it
    inside the first solve (PETSc's PCSetUp-in-KSPSolve timing), caches
    the jitted program.  ``planar``: A (and b/x) use the component-
    planar bs=3 layout (fem.dia_op.DiaOperator.planar) — the caller
    guarantees GMG viability, so no AMG fallback exists on this path.

    ``fidelity``: lazy ``() -> (apply64, b64)`` float64 HOST twin of the
    assembled system.  When set (and -ksp_true_residual is not "off"),
    every converged solve is certified against the f64 system — true
    relative residual measured in f64, mixed-precision iterative
    refinement until it meets ksp_rtol (la.refine; the reference's
    PetscScalar=double contract, src/poisson_problem.cpp:27)."""
    solver = cfg.solver
    rtol = float(solver.get("ksp_rtol"))
    maxit = int(solver.get("ksp_max_it"))
    structured = isinstance(mesh, BoxTetMesh)
    matvec_of = (lambda A: A.apply) if structured else (lambda A: A.matvec)
    cache = {}
    # pure-Neumann well-posedness (the spoke mesh misses the reference's
    # x0 in {0,1} Dirichlet planes, PARITY.md): deflate the constant
    # nullspace — project b and every preconditioned residual to mean
    # zero, so CG runs on the SPD complement and converges to the unique
    # mean-zero representative (A @ 1 = 0 exactly for the pure-Neumann
    # stiffness, so the Krylov space stays mean-free).  Documented
    # deviation: the reference leaves the system singular and relies on
    # iteration caps.
    deflate = (problem_name == "poisson"
               and np.asarray(bc.flat_dofs()).size == 0)
    if deflate:
        import logging
        logging.getLogger("tpufem").info(
            "no Dirichlet dofs (pure-Neumann): deflating the constant "
            "nullspace (mean-zero solution)")

    bc_marker = (common.poisson_bc_marker if problem_name != "elasticity"
                 else common.elasticity_bc_marker)

    def solver_function(u0: jnp.ndarray, rhs: jnp.ndarray) -> Tuple[jnp.ndarray, int]:
        pc_type = solver.get("pc_type")
        if pc_type == "auto":
            pc_type = "gmg" if structured else "amg"
        if "run" not in cache:
            # "ZZZ PC setup" mirrors PETSc's PCSetUp inside the first
            # KSPSolve (reference poisson_problem.cpp:164-179); program
            # compilation is timed separately by the caller
            pc_timer = Timer("ZZZ PC setup").start()
            if pc_type == "gmg":
                if not structured:
                    raise ValueError("gmg requires a structured cube mesh")
                from tpufem.la.gmg import GMG
                try:
                    pc = GMG.setup(mesh, order, problem_name, bc_marker,
                                   dtype=dtype,
                                   coarse_limit=int(solver.get("amg_coarse_eq_limit")),
                                   smoother_degree=int(solver.get("amg_smoother_degree")),
                                   planar=planar)
                    precond_of = lambda A_, pc_: pc_.vcycle
                except ValueError:
                    if planar:
                        raise  # caller pre-checked gmg_viable
                    # lattice dims not 2^L-divisible: geometric coarsening
                    # impossible -> fall back to algebraic multigrid
                    pc_type = "amg"
            if pc_type == "amg" and structured:
                from tpufem.la.bramg import BrickAMG, brick_viable
                if brick_viable(mesh, order, solver):
                    # lattice-brick SA-AMG: geometric 3^3 aggregates +
                    # probed Galerkin — no CSR export, gather-free
                    # V-cycle at every level (la/bramg.py)
                    pc = BrickAMG.setup(A, mesh, bc.bs, solver,
                                        dtype=dtype, near_nullspace=nns,
                                        bc_mask=bc.mask())
                    precond_of = lambda A_, pc_: (
                        lambda r: pc_.vcycle(r, fine_matvec=matvec_of(A_)))
                    pc_type = "brick-amg"
            if pc_type == "amg":
                from tpufem.la.amg import SAAMG
                csr_ = csr
                if csr_ is None:
                    # structured path (A is a DiaOperator): export the
                    # CSR straight from the stencil representation
                    # (vectorized index arithmetic, ~1.5 s at 500k)
                    # instead of re-assembling from element tensors
                    # (~36 s host time); equality pinned by
                    # tests/test_dia_op.py::test_to_scipy_matches_assembled
                    M = A.to_scipy()
                    csr_ = (M.indptr, M.indices, M.data)
                wop = None
                if not structured:
                    wop, csr_w, mask_w, nns_w = _try_window(csr_, bc, solver,
                                                            dtype, nns)
                if wop is not None:
                    # unstructured fine level: RCM + block-windowed SpMV
                    # (fem.window_op — 2.4 ms vs 18.7 ms per 150k apply)
                    # as BOTH the CG operator and the V-cycle fine level;
                    # the hierarchy is built over the permuted matrix.
                    # The V-cycle's fine applies per iteration use a
                    # bf16-valued twin (halved streaming traffic; a
                    # preconditioner only needs a fixed symmetric
                    # operator) while CG's own matvec stays exact f32
                    # when the solve dtype is f32.  Transfers are
                    # ASSEMBLED, not factored: the factored runtime
                    # form is adjoint only to f32 rounding, and on this
                    # mesh's wildly-scaled entries that asymmetry makes
                    # PCG diverge (SAAMG.setup docstring; measured rel
                    # 3.8 vs 8e-7 over the same hierarchy at 150k).
                    pc = SAAMG.setup(csr_w, bs=bc.bs, options=solver,
                                     dtype=dtype, near_nullspace=nns_w,
                                     bc_mask=mask_w, fine_factored=False,
                                     fine_store_a=False,
                                     fine_transfer_window=True)
                    cache["A_op"] = wop
                    wop_pc = (wop.as_bf16()
                              if (np.dtype(dtype) == np.float32
                                  and str(solver.get("amg_window_bf16"))
                                  == "on") else wop)
                    # the twin rides in the pc pytree so it is a traced
                    # ARGUMENT of the compiled program, not a GB-scale
                    # closure constant baked into it
                    pc = (pc, wop_pc)
                    precond_of = lambda A_, pc_: (
                        lambda r: pc_[0].vcycle(r, fine_matvec=pc_[1].matvec))
                    nnz_w = csr_w[2].shape[0]
                    ov_nnz = (int(wop.ov_vals.shape[0])
                              if wop.ov_vals is not None else 0)
                    cache["window_info"] = {
                        "w": int(wop.vals.shape[2]) // wop.C,
                        "vals_mb": round(wop.nbytes_vals / 2**20, 1),
                        "ov_frac": round(ov_nnz / max(nnz_w, 1), 4),
                    }
                else:
                    pc = SAAMG.setup(csr_, bs=bc.bs, options=solver,
                                     dtype=dtype, near_nullspace=nns,
                                     bc_mask=bc.mask(),
                                     fine_factored=structured)
                    if structured:
                        # the constant-stencil apply IS the assembled
                        # matrix on this mesh: use it as the (gather-free)
                        # fine-level operator inside the V-cycle
                        precond_of = lambda A_, pc_: (
                            lambda r: pc_.vcycle(r, fine_matvec=matvec_of(A_)))
                    else:
                        precond_of = lambda A_, pc_: pc_.vcycle
            elif pc_type == "jacobi":
                if structured:
                    pc = jnp.asarray((1.0 / A.diagonal_np()).astype(np.dtype(dtype)))
                else:
                    pc = 1.0 / A.diagonal()
                precond_of = lambda A_, dinv: (lambda r: dinv * r)
            elif pc_type not in ("gmg", "brick-amg"):
                pc = None
                precond_of = lambda A_, _pc: None

            # zero initial guess by default (PETSc KSP's default; the
            # reference never sets KSPSetInitialGuessNonzero): r0 = b,
            # and cg_solve's lowered program holds ONE operator and ONE
            # preconditioner instance
            nonzero_guess = bool(solver.get("ksp_initial_guess_nonzero",
                                            False))

            A_op = cache.get("A_op", A)
            permuted = getattr(A_op, "perm", None) is not None

            def run(A_, pc_, x0, rhs_):
                if planar:
                    # interleaved contract outside, planar inside: the
                    # conversion transposes run ONCE per solve (the
                    # per-iteration state stays planar)
                    x0 = x0.reshape(-1, 3).T.reshape(-1)
                    rhs_ = rhs_.reshape(-1, 3).T.reshape(-1)
                if permuted:
                    # windowed operator lives in RCM ordering: map the
                    # system in/out once per solve (two n-gathers)
                    x0 = x0[A_.perm]
                    rhs_ = rhs_[A_.perm]
                M_ = precond_of(A_, pc_)
                if deflate:
                    demean = lambda v: v - jnp.mean(v)
                    rhs_ = demean(rhs_)
                    M_ = ((lambda r, _M=M_: demean(_M(r)))
                          if M_ is not None else demean)
                x_, it_, rel_ = cg_solve(matvec_of(A_), rhs_,
                                         x0=x0 if nonzero_guess else None,
                                         precond=M_,
                                         rtol=rtol, maxit=maxit)
                if deflate:
                    x_ = x_ - jnp.mean(x_)
                if permuted:
                    x_ = x_[A_.iperm]
                if planar:
                    x_ = x_.reshape(3, -1).T.reshape(-1)
                return x_, it_, rel_

            make_solver._last_pc_setup_s = pc_timer.stop()
            from tpufem.aot import compile_aot
            cache["A_op"] = A_op
            cache["run"], cache["pc"] = compile_aot(run, A_op, pc, u0,
                                                    rhs), pc
            if "window_info" in cache:  # bench diagnostics
                solver_function._window_info = cache["window_info"]
            # bench diagnostics: let the harness profile the V-cycle
            # per stage without re-running setup
            solver_function._pc = pc
            solver_function._A_op = A_op
        x, it, rel = cache["run"](cache["A_op"], cache["pc"], u0, rhs)
        solver_function._last_rel = float(rel)
        if fidelity is not None and str(solver.get("ksp_true_residual")) != "off":
            x = _certify(x, rhs, it, rel)
        return x, int(it)

    def _certify(x, rhs, it, rel):
        """True-residual check + mixed-precision refinement (f64 host
        twin; la.refine).  Returns the (possibly refined) solution."""
        from tpufem.la.refine import Certifier
        if "certifier" not in cache:
            with Timer("ZZZ True residual setup"):
                apply64, b64 = fidelity()
                cache["certifier"] = Certifier(apply64, b64, rtol)
        cert = cache["certifier"]
        # the f64 twin corresponds to the problem's canonical RHS; a
        # caller-perturbed rhs (throughput reps) is not certified
        rhs_norm = float(np.linalg.norm(np.asarray(rhs, dtype=np.float64)))
        bn = cert.bnorm if cert.bnorm > 0.0 else 1.0
        if abs(rhs_norm - cert.bnorm) > 1e-4 * bn:
            solver_function._last_true_rel = None
            return x
        converged = bool(float(rel) <= rtol)
        # refinement also engages when the inner solve merely made solid
        # progress (f32 CG stagnates near working precision on
        # ill-conditioned meshes — the spoke path stalls at ~3e-4 where
        # f64 converges in 57 iterations; each refinement pass contracts
        # the true residual by the inner solve's reduction factor)
        progressed = bool(float(rel) <= 1e-3)
        is_f32 = np.dtype(dtype) == np.float32
        max_passes = (int(solver.get("ksp_refine_max"))
                      if (is_f32 and (converged or progressed)) else 0)
        zeros = jnp.zeros_like(rhs)

        def corr(r64):
            # unit-normalize the correction RHS: by the 2nd-3rd pass
            # ||r|| can reach ~1e-17 * ||b|| and the f32 CG recurrence
            # squares it (rr ~ 1e-50) — underflow to 0 makes beta = 0/0
            # = NaN (observed as elasticity_10m true_rel = nan).  The
            # solve is linear, so scale out and back.
            s = float(np.linalg.norm(r64))
            if not np.isfinite(s) or s == 0.0:
                return np.zeros_like(r64), 0
            r_dev = jnp.asarray((r64 / s).astype(np.dtype(dtype)))
            d, it_, _ = cache["run"](cache["A_op"], cache["pc"], zeros,
                                     r_dev)
            return np.asarray(d, dtype=np.float64) * s, int(it_)

        res = cert.certify(np.asarray(x), corr if max_passes else None,
                           max_passes=max_passes)
        if res.passes:
            x = jnp.asarray(res.x64.astype(np.dtype(dtype)))
        solver_function._last_true_rel = res.true_rel
        solver_function._last_refine_passes = res.passes
        solver_function._last_refine_iters = res.extra_iterations
        solver_function._last_certify_s = res.seconds
        solver_function._last_norm64 = float(np.linalg.norm(res.x64))
        return x

    def solve_async(u0: jnp.ndarray, rhs: jnp.ndarray):
        """Non-blocking variant (no scalar readback) for pipelined
        benchmarking; requires a prior solver_function call (PC built)."""
        return cache["run"](cache["A_op"], cache["pc"], u0, rhs)

    solver_function.solve_async = solve_async
    return solver_function


def problem(mesh, order: int, cfg: Config) -> common.Problem:
    dtype = common.resolve_dtype(cfg)
    structured = isinstance(mesh, BoxTetMesh)

    with Timer("ZZZ FunctionSpace"):
        space = FunctionSpace(mesh, order)
        if not structured:
            _ = space.cell_dofs

    with Timer("ZZZ Create boundary conditions"):
        facets = mesh.locate_boundary_facets(common.poisson_bc_marker)
        bc = DirichletBC.from_space(space, facets)

    with Timer("ZZZ Assemble matrix"):
        if structured:
            # the DIA stencil operator IS the assembled matrix on this
            # mesh (BC-eliminated; equality tested vs CSR)
            from tpufem.fem.dia_op import build_operator
            A = build_operator(mesh, order, "poisson",
                               bc_dofs=bc.flat_dofs(), dtype=dtype)
            csr = None
        else:
            A, csr = assemble_operator(space, bc, "poisson",
                                       dtype=np.dtype(dtype))

    pure_neumann = np.asarray(bc.flat_dofs()).size == 0
    with Timer("ZZZ Assemble vector"):
        if structured and dtype == jnp.float32:
            # device volume term (one jitted stencil apply); f64 runs
            # keep the host path
            b = assemble_poisson_rhs_structured_dev(space, bc, dtype)
        else:
            b_np = assemble_poisson_rhs_np(space)
            b_np[bc.flat_dofs()] = bc.value  # apply_lifting is zero (u0 = 0)
            if pure_neumann:
                # compatible RHS of the singular Neumann system (the
                # deflated-solve contract, see make_solver)
                b_np = b_np - b_np.mean()
            b = jnp.asarray(b_np.astype(np.dtype(dtype)))

    def fidelity():
        """float64 host twin of the assembled system (la.refine): the
        same operator construction evaluated in f64 + the host f64 RHS
        assembly — the reference's PetscScalar=double system."""
        if structured:
            from tpufem.fem.dia_op import build_operator as _bop
            A64 = _bop(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                       dtype=jnp.float64, device=False)
            apply64 = A64.apply_np
        else:
            import scipy.sparse as sp
            n = space.ndofs
            M64 = sp.csr_matrix((csr[2], csr[1], csr[0]), shape=(n, n))
            apply64 = lambda v: M64 @ v
        b64 = assemble_poisson_rhs_np(space)
        b64[bc.flat_dofs()] = bc.value
        if pure_neumann:
            b64 = b64 - b64.mean()
        return apply64, b64

    u = jnp.zeros(space.ndofs, dtype=dtype)
    solver_function = make_solver(A, csr, mesh, order, "poisson", bc, None,
                                  cfg, dtype, fidelity=fidelity)
    return common.Problem(b=b, u=u, solver_function=solver_function,
                          space=space, bc=bc)
