"""Vector-valued (bs=3) linear elasticity problem.

Rebuild of ``elastic::problem`` (reference: src/elasticity_problem.cpp):
P1-P3 vector Lagrange space; clamped y=0 face; rotational body force;
blocked stiffness with BC elimination; rigid-body near-nullspace (the
MatSetNearNullSpace analogue).  Solver: CG + geometric multigrid on the
cube path (componentwise linear interpolation reproduces all six rigid
modes exactly, since they are linear fields) or SA-AMG seeded by the
nullspace on unstructured meshes — replacing PETSc GAMG
(README.md:63-82).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from tpufem.config import Config
from tpufem.fem import kernels
from tpufem.fem.assemble import DofScatter, assemble_operator
from tpufem.fem.dirichlet import DirichletBC
from tpufem.fem.space import FunctionSpace
from tpufem.la.nullspace import build_near_nullspace
from tpufem.mesh.structured import BoxTetMesh
from tpufem.problems import common
from tpufem.problems.poisson import make_solver
from tpufem.timing import Timer


def assemble_elasticity_rhs(space: FunctionSpace, scatter: DofScatter,
                            dtype) -> jnp.ndarray:
    """Device RHS: b = int f . v dx (form L, src/Elasticity.py:40)."""
    f = space.interpolate(common.elasticity_f)  # flat [3 * ns]
    coords = jnp.asarray(space.mesh.cell_coords(), dtype=dtype)
    cd = space.cell_dofs
    f_cells = jnp.asarray(f.reshape(-1, 3)[cd], dtype=dtype)  # [C, n, 3]
    b_cells = kernels.elasticity_rhs_cells(coords, f_cells, space.order)
    return scatter.scatter_add(b_cells)


def assemble_elasticity_rhs_structured_dev(space: FunctionSpace, bc,
                                           dtype,
                                           planar: bool = False
                                           ) -> jnp.ndarray:
    """Device-side production RHS on BoxTetMesh: three jitted scalar
    mass-stencil applies (one per component).  On the P1 path the
    rotational body force is evaluated ON DEVICE from iota coords (no
    [ndofs, 3] host transfer); higher orders interpolate on the host.
    ``planar`` emits the component-planar layout the planar solve path
    consumes."""
    mesh = space.mesh
    nd = np.dtype(dtype)
    idx_np = bc.flat_dofs().astype(np.int64)
    ns = space.ndofs_scalar
    if planar:
        idx_np = (idx_np % 3) * ns + idx_np // 3
    bc_idx = jnp.asarray(idx_np.astype(np.int32))
    bc_val = jnp.asarray(nd.type(bc.value))

    if space.order == 1:
        from tpufem.fem.dia_op import DiaOperator
        mass = DiaOperator.build(mesh, 1, "mass", dtype=dtype)
        Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz

        def make_rhs1():
            def rhs1(mass, idx, val):
                # the SHARED closed form (common.elasticity_f_components)
                # evaluated on traced iota coords — device and host paths
                # cannot diverge
                x = (jnp.arange(Nx + 1, dtype=dtype) / Nx)[None, None, :]
                y = (jnp.arange(Ny + 1, dtype=dtype) / Ny)[None, :, None]
                z = (jnp.arange(Nz + 1, dtype=dtype) / Nz)[:, None, None]
                shape = (Nz + 1, Ny + 1, Nx + 1)
                comps = [jnp.broadcast_to(c, shape) for c in
                         common.elasticity_f_components(x, y, z, jnp)]
                cols = [mass.apply(c.reshape(-1)) for c in comps]
                b = (jnp.concatenate(cols) if planar
                     else jnp.stack(cols, axis=-1).reshape(-1))
                return b.at[idx].set(val)
            return rhs1

        from tpufem.aot import compile_aot_cached
        key = ("elasticity_rhs1", mesh.Nx, mesh.Ny, mesh.Nz, nd.str,
               planar, bc_idx.size)
        return compile_aot_cached(key, make_rhs1,
                                  mass, bc_idx, bc_val)(mass, bc_idx, bc_val)

    from tpufem.fem.structured_op import StructuredOperator
    mass = StructuredOperator.build(mesh, space.order, "mass", dtype=dtype)
    f = space.interpolate(common.elasticity_f).reshape(-1, 3)

    def make_rhs():
        def rhs(mass, fd, idx, val):
            cols = [mass.apply_raw(fd[:, r]) for r in range(3)]
            b = (jnp.concatenate(cols) if planar
                 else jnp.stack(cols, axis=-1).reshape(-1))
            return b.at[idx].set(val)
        return rhs

    from tpufem.aot import compile_aot_cached
    fd = jnp.asarray(f.astype(nd))
    key = ("elasticity_rhsPk", mesh.Nx, mesh.Ny, mesh.Nz, space.order,
           nd.str, planar, bc_idx.size)
    return compile_aot_cached(key, make_rhs, mass, fd, bc_idx,
                              bc_val)(mass, fd, bc_idx, bc_val)


def assemble_elasticity_rhs_np(space: FunctionSpace) -> np.ndarray:
    """Host float64 twin (production setup path); structured mass-stencil
    fast path per component on BoxTetMesh."""
    f = space.interpolate(common.elasticity_f).reshape(-1, 3)
    if isinstance(space.mesh, BoxTetMesh):
        from tpufem.fem.structured_op import StructuredOperator
        import jax.numpy as jnp
        mass_op = StructuredOperator.build(space.mesh, space.order, "mass",
                                           dtype=jnp.float64, device=False)
        b = np.stack([mass_op.apply_raw_np(f[:, r]) for r in range(3)],
                     axis=-1)
        return b.reshape(-1)
    from tpufem.fem.assemble import detJ_np
    cd = space.cell_dofs
    coords = space.mesh.cell_coords()
    adet = detJ_np(coords)
    M = space.element.mass_tensor
    b_cells = np.einsum("ij,cjr->cir", M, f[cd]) * adet[:, None, None]
    b = np.zeros((space.ndofs_scalar, 3))
    for r in range(3):
        b[:, r] = np.bincount(cd.reshape(-1),
                              weights=b_cells[:, :, r].reshape(-1),
                              minlength=space.ndofs_scalar)
    return b.reshape(-1)


def problem(mesh, order: int, cfg: Config) -> common.Problem:
    dtype = common.resolve_dtype(cfg)
    structured = isinstance(mesh, BoxTetMesh)

    with Timer("ZZZ FunctionSpace"):
        space = FunctionSpace(mesh, order, bs=3)
        if not structured:
            _ = space.cell_dofs

    with Timer("ZZZ Create boundary conditions"):
        facets = mesh.locate_boundary_facets(common.elasticity_bc_marker)
        bc = DirichletBC.from_space(space, facets)

    # component-PLANAR vector layout for the structured P1 solve: the
    # node-interleaved layout puts the 3 components on the minor axis,
    # so every shifted slice is a stride-3 access; planar components
    # are contiguous scalar grids.  Only when every solver
    # piece supports it: P1 DIA + GMG/Jacobi/none (AMG works on the
    # assembled interleaved CSR).
    pc_type = cfg.solver.get("pc_type")
    planar = False
    if structured and order == 1:
        if pc_type == "amg":
            # planar iff the brick-AMG path will serve (it runs planar
            # end-to-end; the generic SA fallback stays interleaved to
            # match its CSR export / ELL hierarchy)
            from tpufem.la.bramg import brick_viable
            planar = brick_viable(mesh, order, cfg.solver)
        else:
            from tpufem.la.gmg import gmg_viable
            planar = (pc_type in ("jacobi", "none")
                      or gmg_viable(mesh, 3,
                                    int(cfg.solver.get("amg_coarse_eq_limit")),
                                    int(cfg.solver.get("amg_max_levels"))))

    with Timer("ZZZ Assemble matrix"):
        if structured:
            from tpufem.fem.dia_op import build_operator
            A = build_operator(mesh, order, "elasticity",
                               bc_dofs=bc.flat_dofs(), dtype=dtype,
                               planar=planar)
            csr = None
        else:
            A, csr = assemble_operator(space, bc, "elasticity",
                                       dtype=np.dtype(dtype))

    with Timer("ZZZ Assemble vector"):
        if structured and dtype == jnp.float32:
            b = assemble_elasticity_rhs_structured_dev(space, bc, dtype)
        else:
            b_np = assemble_elasticity_rhs_np(space)
            b_np[bc.flat_dofs()] = bc.value
            b = jnp.asarray(b_np.astype(np.dtype(dtype)))

    with Timer("ZZZ Create near-nullspace"):
        nns = build_near_nullspace(space.scalar_dof_coords())

    def fidelity():
        """float64 host twin (la.refine) in the node-interleaved layout
        (the solver's external contract; the planar conversion happens
        inside the jitted run)."""
        if structured:
            from tpufem.fem.dia_op import build_operator as _bop
            A64 = _bop(mesh, order, "elasticity", bc_dofs=bc.flat_dofs(),
                       dtype=jnp.float64, device=False)
            apply64 = A64.apply_np
        else:
            import scipy.sparse as sp
            n = space.ndofs
            M64 = sp.bsr_matrix((csr[2], csr[1], csr[0]), shape=(n, n))
            apply64 = lambda v: M64 @ v
        b64 = assemble_elasticity_rhs_np(space)
        b64[bc.flat_dofs()] = bc.value
        return apply64, b64

    u = jnp.zeros(space.ndofs, dtype=dtype)
    # b/u/x keep the reference's node-interleaved contract; the solver
    # program converts to planar internally (make_solver)
    solver_function = make_solver(A, csr, mesh, order, "elasticity", bc,
                                  nns, cfg, dtype, planar=planar,
                                  fidelity=fidelity)
    return common.Problem(b=b, u=u, solver_function=solver_function,
                          space=space, bc=bc)
