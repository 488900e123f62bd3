"""Kernel + assembly tests against an independent dense quadrature reference
(the strategy SURVEY.md prescribes: verify the XLA kernels vs dense numpy
assembly on tiny meshes)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

jax.config.update("jax_enable_x64", True)

from tpufem.mesh import BoxTetMesh
from tpufem.fem.space import FunctionSpace
from tpufem.fem.reference import ReferenceTet, tet_quadrature
from tpufem.fem import kernels
from tpufem.fem.assemble import (DofScatter, assemble_operator, coo_to_csr,
                                 csr_to_ell)
from tpufem.fem.dirichlet import DirichletBC


def dense_poisson(space):
    """Independent reference: per-cell numpy quadrature loop."""
    el = space.element
    pts, wts = tet_quadrature(2 * (space.order - 1) + 2)
    _, dphi = el.tabulate(pts)  # [q, n, 3]
    coords = space.mesh.cell_coords()
    cd = space.cell_dofs
    N = space.ndofs_scalar
    A = np.zeros((N, N))
    for c in range(coords.shape[0]):
        x = coords[c]
        J = (x[1:4] - x[0]).T  # [a, l]
        Jinv = np.linalg.inv(J)
        det = abs(np.linalg.det(J))
        g = np.einsum("qnl,la->qna", dphi, Jinv)  # physical grads
        Ac = np.einsum("q,qia,qja->ij", wts * det, g, g)
        A[np.ix_(cd[c], cd[c])] += Ac
    return A


def dense_elasticity(space):
    el = space.element
    pts, wts = tet_quadrature(2 * (space.order - 1) + 2)
    _, dphi = el.tabulate(pts)
    mu, lam = kernels.ELASTICITY_MU, kernels.ELASTICITY_LMBDA
    coords = space.mesh.cell_coords()
    cd = space.cell_dofs
    N = space.ndofs
    n = el.ndofs
    A = np.zeros((N, N))
    for c in range(coords.shape[0]):
        x = coords[c]
        J = (x[1:4] - x[0]).T
        Jinv = np.linalg.inv(J)
        det = abs(np.linalg.det(J))
        g = np.einsum("qnl,la->qna", dphi, Jinv)
        Ac = np.zeros((3 * n, 3 * n))
        for q in range(pts.shape[0]):
            w = wts[q] * det
            for i in range(n):
                for j in range(n):
                    for r in range(3):
                        for s in range(3):
                            v = mu * (r == s) * g[q, i] @ g[q, j] \
                                + mu * g[q, i, s] * g[q, j, r] \
                                + lam * g[q, i, r] * g[q, j, s]
                            Ac[3 * i + r, 3 * j + s] += w * v
        gd = (3 * cd[c][:, None] + np.arange(3)[None, :]).reshape(-1)
        A[np.ix_(gd, gd)] += Ac
    return A


@pytest.mark.parametrize("order", [1, 2, 3])
def test_poisson_matrix_vs_dense(order):
    mesh = BoxTetMesh(2, 2, 2) if order < 3 else BoxTetMesh(1, 1, 2)
    space = FunctionSpace(mesh, order)
    Adense = dense_poisson(space)
    ell, _ = assemble_operator(space, None, "poisson", dtype=np.float64)
    got = np.zeros_like(Adense)
    cols = np.asarray(ell.cols)
    vals = np.asarray(ell.vals)
    for i in range(cols.shape[0]):
        np.add.at(got[i], cols[i], vals[i])
    if ell.ov_rows is not None:  # capped-K overflow tail
        np.add.at(got, (np.asarray(ell.ov_rows), np.asarray(ell.ov_cols)),
                  np.asarray(ell.ov_vals))
    assert np.allclose(got, Adense, atol=1e-10)
    # row sums of the unconstrained stiffness vanish (constants in kernel)
    assert np.abs(Adense.sum(axis=1)).max() < 1e-10


@pytest.mark.parametrize("order", [1, 2])
def test_elasticity_matrix_vs_dense(order):
    mesh = BoxTetMesh(1, 1, 1) if order == 2 else BoxTetMesh(2, 1, 1)
    space = FunctionSpace(mesh, order, bs=3)
    Adense = dense_elasticity(space)
    ell, _ = assemble_operator(space, None, "elasticity", dtype=np.float64)
    N = space.ndofs
    got = np.zeros((N, N))
    cols = np.asarray(ell.cols)
    vals = np.asarray(ell.vals)  # [N/3, K, 3, 3]
    for i in range(cols.shape[0]):
        for k in range(cols.shape[1]):
            j = cols[i, k]
            got[3 * i:3 * i + 3, 3 * j:3 * j + 3] += vals[i, k]
    if ell.ov_rows is not None:  # capped-K overflow tail
        for i, j, v in zip(np.asarray(ell.ov_rows), np.asarray(ell.ov_cols),
                           np.asarray(ell.ov_vals)):
            got[3 * i:3 * i + 3, 3 * j:3 * j + 3] += v
    assert np.allclose(got, Adense, atol=1e-6)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_action_matches_matrix(order):
    """Matrix-free action == assembled SpMV (pre-BC)."""
    mesh = BoxTetMesh(2, 2, 1)
    space = FunctionSpace(mesh, order)
    ell, _ = assemble_operator(space, None, "poisson", dtype=np.float64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(space.ndofs_scalar)
    coords = jnp.asarray(space.mesh.cell_coords())
    cd = jnp.asarray(space.cell_dofs)
    scatter = DofScatter(space.cell_dofs, space.ndofs_scalar)
    y_cells = kernels.poisson_action_cells(coords, jnp.asarray(x)[cd], order)
    y = scatter.scatter_add(y_cells)
    y_ref = ell.matvec(jnp.asarray(x))
    assert np.allclose(np.asarray(y), np.asarray(y_ref), atol=1e-10)


@pytest.mark.parametrize("order", [1, 2])
def test_elasticity_action_matches_matrix(order):
    mesh = BoxTetMesh(1, 2, 1)
    space = FunctionSpace(mesh, order, bs=3)
    ell, _ = assemble_operator(space, None, "elasticity", dtype=np.float64)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(space.ndofs)
    coords = jnp.asarray(space.mesh.cell_coords())
    cd = np.asarray(space.cell_dofs)
    u_cells = x.reshape(-1, 3)[cd]  # [C, n, 3]
    y_cells = kernels.elasticity_action_cells(coords, jnp.asarray(u_cells), order)
    scatter = DofScatter(space.cell_dofs, space.ndofs_scalar, bs=3)
    y = scatter.scatter_add(y_cells)
    y_ref = ell.matvec(jnp.asarray(x))
    assert np.allclose(np.asarray(y), np.asarray(y_ref), atol=1e-8 * 1e6)


def test_facet_rhs_total_surface():
    """sum_i int g phi_i ds with g = 1 equals the boundary area (= 6)."""
    mesh = BoxTetMesh(2, 2, 2)
    order = 2
    space = FunctionSpace(mesh, order)
    facets = mesh.boundary_faces()
    f2c_faces = mesh.cell_faces()  # [C, 4]
    # find (cell, local_face) for each boundary facet
    cell_idx = np.full(mesh.num_faces_global, -1, dtype=np.int64)
    local_idx = np.zeros(mesh.num_faces_global, dtype=np.int64)
    for lf in range(4):
        cell_idx[f2c_faces[:, lf]] = np.arange(f2c_faces.shape[0])
        local_idx[f2c_faces[:, lf]] = lf
    cells = cell_idx[facets]
    lf = local_idx[facets]
    assert (cells >= 0).all()
    coords = jnp.asarray(space.mesh.cell_coords()[cells])
    g = np.ones(space.ndofs_scalar)
    g_cells = jnp.asarray(g[space.cell_dofs[cells]])
    contrib = kernels.facet_rhs_cells(coords, jnp.asarray(lf), g_cells, order)
    assert np.isclose(float(contrib.sum()), 6.0, atol=1e-10)


def test_coo_to_csr_roundtrip():
    rng = np.random.default_rng(2)
    n = 7
    rows = rng.integers(0, n, 50)
    cols = rng.integers(0, n, 50)
    vals = rng.standard_normal(50)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    indptr, indices, data = coo_to_csr(rows, cols, vals, n)
    ell = csr_to_ell(indptr, indices, data, dtype=np.float64)
    x = rng.standard_normal(n)
    assert np.allclose(np.asarray(ell.matvec(jnp.asarray(x))), dense @ x)
    assert np.allclose(np.asarray(ell.diagonal()), np.diag(dense))


def test_ell_k_cap_overflow_exact():
    """csr_to_ell(k_cap=...) spills long-row tails into the COO overflow;
    matvec and diagonal must be EXACT vs the full-width form (the spoke
    hub's degree tail made padded-ELL 3.3x wider than the mean row)."""
    import scipy.sparse as sp
    from tpufem.fem.assemble import csr_to_ell
    rng = np.random.default_rng(7)
    n = 300
    A = sp.random(n, n, density=0.05, random_state=8, format="csr")
    A = (A + A.T).tocsr()  # symmetric-ish, degree spread
    A = A + sp.eye(n)      # ensure diagonal entries exist
    A = A.tocsr()
    x = rng.standard_normal(n)
    full = csr_to_ell(A.indptr, A.indices, A.data, dtype=jnp.float64)
    capped = csr_to_ell(A.indptr, A.indices, A.data, dtype=jnp.float64,
                        k_cap=4)
    auto = csr_to_ell(A.indptr, A.indices, A.data, dtype=jnp.float64,
                      k_cap="auto")
    assert capped.ov_rows is not None and capped.cols.shape[1] == 4
    ref = A @ x
    for ell in (full, capped, auto):
        y = np.asarray(ell.matvec(jnp.asarray(x)))
        assert np.allclose(y, ref, atol=1e-12)
        d = np.asarray(ell.diagonal())
        assert np.allclose(d, A.diagonal(), atol=1e-12)
