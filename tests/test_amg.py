"""SA-AMG tests: component behavior + preconditioned-CG convergence
(replacing PETSc GAMG / Hypre BoomerAMG, reference README.md:63-146)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

from tpufem.config import SolverOptions
from tpufem.la.amg import (SAAMG, aggregate_nodes, node_strength_graph,
                           tentative_prolongator)
from tpufem.la.chebyshev import chebyshev_smoother
from tpufem.la.cg import cg_solve


def laplace_3d(n):
    """7-point Laplacian on an n^3 grid (independent test operator)."""
    I = sp.identity(n)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    A = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
         + sp.kron(sp.kron(I, I), T))
    return A.tocsr()


def test_strength_graph_does_not_mutate_input():
    A = laplace_3d(4)
    data0 = A.data.copy()
    idx0 = A.indices.copy()
    node_strength_graph(A, 1, 0.5)
    assert np.array_equal(A.data, data0)
    assert np.array_equal(A.indices, idx0)


def test_aggregation_covers_and_is_connected():
    A = laplace_3d(6)
    S = node_strength_graph(A, 1, 0.0)
    agg, nagg = aggregate_nodes(S)
    assert agg.min() >= 0 and agg.max() == nagg - 1
    sizes = np.bincount(agg)
    assert sizes.sum() == A.shape[0]
    # decent coarsening on a regular grid
    assert A.shape[0] / nagg > 3.0


def test_tentative_prolongator_reproduces_nullspace():
    """P0 @ Bc == B exactly (the defining SA property)."""
    A = laplace_3d(5)
    S = node_strength_graph(A, 1, 0.0)
    agg, nagg = aggregate_nodes(S)
    rng = np.random.default_rng(3)
    B = rng.standard_normal((A.shape[0], 2))
    P0, Bc = tentative_prolongator(agg, nagg, B, 1)
    assert np.allclose(P0 @ Bc, B, atol=1e-12)


def test_chebyshev_polynomial_property():
    """Error propagator equals the scaled Chebyshev polynomial
    T_m((theta - x)/delta) / T_m(theta/delta) on the eigenvalues."""
    lam = np.linspace(0.05, 2.0, 50)
    A = jnp.asarray(np.diag(lam))
    dinv = jnp.ones(50)
    deg = 4
    smooth = chebyshev_smoother(lambda v: A @ v, dinv, 2.0, degree=deg,
                                lo_frac=0.1, hi_frac=1.1)
    e0 = jnp.ones(50)
    e1 = e0 - smooth(jnp.zeros(50), A @ e0)  # error propagation of x*=1
    lo, hi = 0.2, 2.2
    theta, delta = (hi + lo) / 2, (hi - lo) / 2
    cheb = np.polynomial.chebyshev.Chebyshev([0] * deg + [1])
    expect = cheb((theta - lam) / delta) / cheb(theta / delta)
    assert np.allclose(np.asarray(e1), expect, atol=1e-8)


@pytest.mark.parametrize("n,maxiter", [(12, 30)])
def test_amg_cg_fast_convergence(n, maxiter):
    """CG+V-cycle must converge to 1e-8 in O(10) iterations, independent
    of Jacobi-CG which needs hundreds."""
    A = laplace_3d(n)
    opts = SolverOptions()
    pc = SAAMG.setup((A.indptr, A.indices, A.data), bs=1, options=opts,
                     dtype=jnp.float64)
    assert len(pc.level_sizes) >= 2
    ell_A = pc.levels[0].A
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(A.shape[0]))
    x, it, rel = jax.jit(
        lambda pc, b: cg_solve(pc.levels[0].A.matvec, b,
                               precond=pc.vcycle, rtol=1e-8, maxit=maxiter)
    )(pc, b)
    assert float(rel) < 1e-8
    assert int(it) < maxiter
    r = np.asarray(b) - A @ np.asarray(x)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-7


def test_dense_level_matches_ell():
    """Dense small-level matvecs (amg_dense_level_limit) change nothing
    numerically: identical V-cycle output and CG iterations vs the
    all-ELL hierarchy."""
    A = laplace_3d(12)
    n = A.shape[0]
    csr = (A.indptr, A.indices, A.data)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(n))
    ell = SAAMG.setup(csr, bs=1,
                      options=SolverOptions(amg_dense_level_limit=0),
                      dtype=jnp.float64)
    dense = SAAMG.setup(csr, bs=1,
                        options=SolverOptions(amg_dense_level_limit=10**6),
                        dtype=jnp.float64)
    from tpufem.la.amg import DenseMat
    assert any(isinstance(lv.A, DenseMat) for lv in dense.levels)
    assert not any(isinstance(lv.A, DenseMat) for lv in ell.levels)
    ve = np.asarray(ell.vcycle(b))
    vd = np.asarray(dense.vcycle(b))
    assert np.abs(ve - vd).max() < 1e-11 * np.abs(ve).max()


def test_fine_matvec_hook_matches_ell():
    """vcycle(fine_matvec=...) with an operator equal to the level-0
    matrix reproduces the built-in ELL path exactly (the cube path
    passes the constant-stencil apply here)."""
    A = laplace_3d(12)
    csr = (A.indptr, A.indices, A.data)
    amg = SAAMG.setup(csr, bs=1, options=SolverOptions(),
                      dtype=jnp.float64)
    assert amg.levels
    b = jnp.asarray(np.random.default_rng(1).standard_normal(A.shape[0]))
    v0 = np.asarray(amg.vcycle(b))
    v1 = np.asarray(amg.vcycle(b, fine_matvec=amg.levels[0].A.matvec))
    assert np.array_equal(v0, v1)


def test_factored_fine_transfers_match_ell():
    """fine_factored=True applies the SAME smoothed prolongator in
    factored form, P = (I - omega D^-1 A) P0: the V-cycle must match
    the explicit-ELL hierarchy built with an unfiltered level-0 P
    (amg_filter_k=0 disables the top-k row filter everywhere, making
    the two hierarchies algebraically identical)."""
    A = laplace_3d(12)
    n = A.shape[0]
    csr = (A.indptr, A.indices, A.data)
    b = jnp.asarray(np.random.default_rng(2).standard_normal(n))
    opts = SolverOptions(amg_filter_k=0)
    ell = SAAMG.setup(csr, bs=1, options=opts, dtype=jnp.float64)
    fac = SAAMG.setup(csr, bs=1, options=opts, dtype=jnp.float64,
                      fine_factored=True)
    assert fac.levels[0].fw is not None and fac.levels[0].P is None
    assert ell.levels[0].fw is None
    # the factored fine level stores NO assembled operator (nothing is
    # uploaded for it); a vcycle without fine_matvec must refuse
    assert fac.levels[0].A is None
    with pytest.raises(ValueError, match="fine_matvec"):
        fac.vcycle(b)
    mv = ell.levels[0].A.matvec
    assert fac.level_sizes == ell.level_sizes
    ve = np.asarray(ell.vcycle(b))
    vf = np.asarray(fac.vcycle(b, fine_matvec=mv))
    assert np.abs(ve - vf).max() < 1e-12 * np.abs(ve).max()
    # preconditioned CG through the factored form converges identically
    _, ite, rele = cg_solve(mv, b,
                            precond=ell.vcycle, rtol=1e-8, maxit=50)
    _, itf, relf = cg_solve(mv, b,
                            precond=lambda r: fac.vcycle(r, fine_matvec=mv),
                            rtol=1e-8, maxit=50)
    assert float(relf) < 1e-8
    assert int(ite) == int(itf)


def test_elasticity_nullspace_filter_autodisable():
    """With a 6-column rigid-body nullspace the prolongator top-k
    filter must be auto-disabled: top-k + row-sum lumping preserves
    constants but not rotations, and costs ~5x the iterations
    (clamped-cube P1 elasticity, 10k dofs: 15 its unfiltered vs 73 at
    the default k=4).  Pins the iteration count within 2x of the
    Poisson-AMG ballpark."""
    from tpufem.fem.dia_op import build_operator
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.la.nullspace import build_near_nullspace
    from tpufem.mesh.structured import BoxTetMesh
    from tpufem.problems import common
    from tpufem.problems.elasticity import assemble_elasticity_rhs_np

    mesh = BoxTetMesh(10, 10, 10)
    space = FunctionSpace(mesh, 1, bs=3)
    facets = mesh.locate_boundary_facets(common.elasticity_bc_marker)
    bc = DirichletBC.from_space(space, facets)
    A = build_operator(mesh, 1, "elasticity", bc_dofs=bc.flat_dofs(),
                       dtype=jnp.float64, device=False)
    csr = A.to_scipy()
    n = csr.shape[0]
    nns = build_near_nullspace(space.scalar_dof_coords())
    b_np = assemble_elasticity_rhs_np(space)
    b_np[bc.flat_dofs()] = 0.0
    mask = np.zeros(n, dtype=bool)
    mask[bc.flat_dofs()] = True
    pc = SAAMG.setup((csr.indptr, csr.indices, csr.data), bs=3,
                     options=SolverOptions(), dtype=jnp.float64,
                     near_nullspace=nns, bc_mask=mask)
    x, it, rel = jax.jit(
        lambda pc, b: cg_solve(pc.levels[0].A.matvec, b,
                               precond=pc.vcycle, rtol=1e-8, maxit=60)
    )(pc, jnp.asarray(b_np))
    assert float(rel) < 1e-8
    assert int(it) <= 22, f"elasticity SA-AMG took {int(it)} iterations"
