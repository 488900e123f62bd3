"""DIA stencil operator vs assembled operator (with and without BC)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

jax.config.update("jax_enable_x64", True)

from tpufem.fem.assemble import assemble_operator
from tpufem.fem.dia_op import DiaOperator
from tpufem.fem.dirichlet import DirichletBC
from tpufem.fem.space import FunctionSpace
from tpufem.mesh import BoxTetMesh
from tpufem.problems import common


@pytest.mark.parametrize("order,dims,problem,bs", [
    (1, (3, 4, 5), "poisson", 1),
    (2, (3, 2, 4), "poisson", 1),
    (3, (2, 3, 2), "poisson", 1),
    (1, (2, 3, 2), "elasticity", 3),
    (2, (2, 2, 2), "elasticity", 3),
])
def test_dia_matches_assembled(order, dims, problem, bs):
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, order, bs=bs)
    marker = (common.poisson_bc_marker if problem == "poisson"
              else common.elasticity_bc_marker)
    facets = mesh.locate_boundary_facets(marker)
    bc = DirichletBC.from_space(space, facets)
    ell, _ = assemble_operator(space, bc, problem, dtype=np.float64)
    op = DiaOperator.build(mesh, order, problem, bc_dofs=bc.flat_dofs(),
                           dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(space.ndofs))
    tol = 1e-11 if problem == "poisson" else 1e-6
    assert np.allclose(np.asarray(op.apply(x)),
                       np.asarray(ell.matvec(x)), atol=tol)
    assert np.allclose(op.apply_np(np.asarray(x)),
                       np.asarray(ell.matvec(x)), atol=tol)
    assert np.allclose(op.diagonal_np(), np.asarray(ell.diagonal()), atol=tol)


@pytest.mark.parametrize("order,dims,problem,bs", [
    (1, (3, 4, 5), "poisson", 1),      # dense-mode small lattice
    (1, (8, 9, 10), "poisson", 1),     # const-mode (table + corrections)
    (2, (3, 2, 4), "poisson", 1),
    (3, (2, 3, 2), "poisson", 1),
    (1, (2, 3, 2), "elasticity", 3),
    (1, (9, 10, 11), "elasticity", 3),  # const-mode bs=3
    (2, (2, 2, 2), "elasticity", 3),
])
def test_to_scipy_matches_assembled(order, dims, problem, bs):
    """to_scipy exports the SAME matrix assemble_operator builds (the
    AMG setup path uses it to skip the O(cells) host re-assembly)."""
    import scipy.sparse as sp
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, order, bs=bs)
    marker = (common.poisson_bc_marker if problem == "poisson"
              else common.elasticity_bc_marker)
    bc = DirichletBC.from_space(space,
                                mesh.locate_boundary_facets(marker))
    _, (indptr, indices, data) = assemble_operator(space, bc, problem,
                                                   dtype=np.float64)
    if data.ndim == 3:
        nb = indptr.shape[0] - 1
        ref = sp.bsr_matrix((data, indices, indptr),
                            shape=(nb * bs, nb * bs)).tocsr()
    else:
        ref = sp.csr_matrix((data, indices, indptr))
    op = DiaOperator.build(mesh, order, problem, bc_dofs=bc.flat_dofs(),
                           dtype=jnp.float64)
    M = op.to_scipy()
    assert M.shape == ref.shape
    diff = (M - ref).tocoo()
    err = np.abs(diff.data).max() if diff.nnz else 0.0
    scale = np.abs(ref.data).max()
    assert err < (1e-11 if problem == "poisson" else 1e-6) * scale


@pytest.mark.parametrize("dims,problem,bake", [
    ((8, 9, 10), "poisson", True),
    ((8, 9, 10), "poisson", False),
    ((9, 10, 11), "elasticity", True),
    ((10, 9, 11), "elasticity", False),
])
def test_const_mode_matches_dense(dims, problem, bake):
    """The production constant-weight build (O(1) surrogate lattice +
    thin boundary corrections) equals the dense build to rounding."""
    mesh = BoxTetMesh(*dims)
    bs = 3 if problem == "elasticity" else 1
    space = FunctionSpace(mesh, 1, bs=bs)
    marker = (common.poisson_bc_marker if problem == "poisson"
              else common.elasticity_bc_marker)
    bc = DirichletBC.from_space(space, mesh.locate_boundary_facets(marker))
    kw = dict(bc_dofs=bc.flat_dofs(), dtype=jnp.float64, bake_bc=bake)
    oc = DiaOperator.build(mesh, 1, problem, mode="const", **kw)
    od = DiaOperator.build(mesh, 1, problem, mode="dense", **kw)
    assert all(m[6] is not None for m in oc.plan), "dense fallback taken"
    scale = max(np.abs(np.asarray(w)).max() for w in od.weights)
    x = np.random.default_rng(0).standard_normal(space.ndofs)
    tol = 1e-13 * scale
    assert np.abs(oc.apply_np(x) - od.apply_np(x)).max() < tol
    assert np.abs(np.asarray(oc.apply(jnp.asarray(x)))
                  - np.asarray(od.apply(jnp.asarray(x)))).max() < tol
    assert np.abs(oc.diagonal_np() - od.diagonal_np()).max() < tol
    # compression actually happened (thin shells, not dense grids)
    assert (sum(np.asarray(w).size for w in oc.weights)
            < sum(np.asarray(w).size for w in od.weights))


def test_const_mode_auto_and_fallback():
    """auto picks const for >= 6-cube lattices, dense below; irregular
    BC patterns (not axis shells) fall back to dense."""
    op = DiaOperator.build(BoxTetMesh(8, 8, 8), 1, "poisson",
                           dtype=jnp.float64)
    assert all(m[6] is not None for m in op.plan)
    op_small = DiaOperator.build(BoxTetMesh(4, 4, 4), 1, "poisson",
                                 dtype=jnp.float64)
    assert all(m[6] is None for m in op_small.plan)
    # a single interior BC dof is not shell-representable -> dense
    mesh = BoxTetMesh(8, 8, 8)
    mid = (4 * 9 + 4) * 9 + 4
    op_bc = DiaOperator.build(mesh, 1, "poisson",
                              bc_dofs=np.array([mid]), dtype=jnp.float64)
    assert all(m[6] is None for m in op_bc.plan)


@pytest.mark.parametrize("order,bake", [(2, True), (2, False),
                                        (3, True), (3, False)])
def test_const_mode_higher_order(order, bake):
    """Multi-kind const-table build (P2/P3): equals the per-perm
    StructuredOperator on every apply path (fused z-zone, 3-D table,
    host twin) and on the diagonal."""
    from tpufem.fem.structured_op import StructuredOperator
    mesh = BoxTetMesh(8, 9, 10)
    space = FunctionSpace(mesh, order)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    oc = DiaOperator.try_const(mesh, order, "poisson",
                               bc_dofs=bc.flat_dofs(),
                               dtype=jnp.float64, bake_bc=bake)
    assert oc is not None
    so = StructuredOperator.build(mesh, order, "poisson",
                                  bc_dofs=bc.flat_dofs(), dtype=jnp.float64)
    x = np.random.default_rng(0).standard_normal(space.ndofs)
    if bake:
        ref = so.apply_np(x)
        got_dev = np.asarray(oc.apply(jnp.asarray(x)))
        got_np = oc.apply_np(x)
        assert np.allclose(oc.diagonal_np(), so.diagonal_np(), atol=1e-12)
    else:
        bcm = np.asarray(so.bc_mask)
        ref = np.where(bcm, 0.0, so.apply_raw_np(x))
        got_dev = np.asarray(oc.apply_bc_rows_zero(jnp.asarray(x)))
        got_np = np.where(np.asarray(oc.bc_mask), 0.0, oc.apply_np(x))
    s = np.abs(ref).max()
    assert np.abs(got_dev - ref).max() < 1e-12 * s
    assert np.abs(got_np - ref).max() < 1e-12 * s
    # const mode precomputed its zone fields (production apply path)
    assert oc.zones is not None and len(oc.zones) == len(oc.zone_plan)


def test_zone_apply_matches_host_twin_p1():
    """The production P1 precomputed-zone apply (scalar and bs=3) equals
    the host twin (full reconstructed weight fields) exactly."""
    for problem, bs in (("poisson", 1), ("elasticity", 3)):
        mesh = BoxTetMesh(9, 8, 10)
        space = FunctionSpace(mesh, 1, bs=bs)
        marker = (common.poisson_bc_marker if problem == "poisson"
                  else common.elasticity_bc_marker)
        bc = DirichletBC.from_space(
            space, mesh.locate_boundary_facets(marker))
        op = DiaOperator.build(mesh, 1, problem, bc_dofs=bc.flat_dofs(),
                               dtype=jnp.float64)
        assert op.is_const() and op.zones is not None
        # z-zone split happened (9+ plane grids) and mid fields are thin
        assert any(len(f) == 3 and f[1].shape[0] == 1 for f in op.zones)
        x = jnp.asarray(np.random.default_rng(3).standard_normal(space.ndofs))
        a = np.asarray(op.apply(x))
        t = op.apply_np(np.asarray(x))
        assert np.abs(a - t).max() < 1e-13 * np.abs(t).max()


@pytest.mark.parametrize("dims", [(9, 8, 10), (4, 4, 4)])
def test_planar_apply_matches_interleaved(dims):
    """Component-planar bs=3 layout (the production elasticity form) is a
    pure permutation of the node-interleaved operator: apply, diagonal
    and bc mask must all agree under the permutation (const-mode zones
    and the small-lattice dense fallback)."""
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, 1, bs=3)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.elasticity_bc_marker))
    kw = dict(bc_dofs=bc.flat_dofs(), dtype=jnp.float64)
    op_i = DiaOperator.build(mesh, 1, "elasticity", **kw)
    op_p = DiaOperator.build(mesh, 1, "elasticity", planar=True, **kw)
    assert op_p.planar
    rng = np.random.default_rng(7)
    x = rng.standard_normal(space.ndofs)
    xp = np.ascontiguousarray(x.reshape(-1, 3).T).reshape(-1)
    y = np.asarray(op_i.apply(jnp.asarray(x)))
    yp = np.asarray(op_p.apply(jnp.asarray(xp)))
    perm_y = np.ascontiguousarray(y.reshape(-1, 3).T).reshape(-1)
    assert np.abs(yp - perm_y).max() < 1e-12 * np.abs(y).max()
    d = op_i.diagonal_np()
    dp = op_p.diagonal_np()
    assert np.array_equal(np.ascontiguousarray(
        d.reshape(-1, 3).T).reshape(-1), dp)
    m = np.asarray(op_i.bc_mask)
    assert np.array_equal(np.ascontiguousarray(
        m.reshape(-1, 3).T).reshape(-1), np.asarray(op_p.bc_mask))
    # host twin follows the planar layout too
    assert np.abs(op_p.apply_np(xp) - perm_y).max() < 1e-12 * np.abs(y).max()


def test_dia_triple_count_p1():
    """P1 Poisson on the Kuhn lattice has at most 15 stencil points; on
    the isotropic unit cube the diagonal couplings cancel exactly and the
    classic 7-point stencil remains (all-zero diagonals are dropped)."""
    op = DiaOperator.build(BoxTetMesh(4, 4, 4), 1, "poisson",
                           dtype=jnp.float64)
    assert len(op.plan) == 7
    op2 = DiaOperator.build(BoxTetMesh(4, 5, 6), 1, "poisson",
                            dtype=jnp.float64)
    assert 7 <= len(op2.plan) <= 15


@pytest.mark.parametrize("order,dims", [(2, (8, 9, 10)), (3, (8, 9, 10)),
                                        (2, (6, 6, 6)), (3, (6, 7, 6)),
                                        (1, (8, 9, 10))])
def test_conv_op_matches_const(order, dims):
    """The channel-conv operator (bulk conv + inclusion-exclusion
    boundary contractions) equals the const-table DIA apply exactly
    (same matrix, reorganized; f64)."""
    from tpufem.fem.conv_op import ConvStencilOp
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, order)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    for bake in (True, False):
        oc = DiaOperator.try_const(mesh, order, "poisson",
                                   bc_dofs=bc.flat_dofs(),
                                   dtype=jnp.float64, bake_bc=bake)
        assert oc is not None
        cv = ConvStencilOp.from_dia(oc, dtype=jnp.float64)
        x = jnp.asarray(
            np.random.default_rng(1).standard_normal(space.ndofs))
        if bake:
            ref = np.asarray(oc.apply(x))
            got = np.asarray(cv.apply(x))
        else:
            ref = np.asarray(oc.apply_bc_rows_zero(x))
            got = np.asarray(cv.apply_bc_rows_zero(x))
        s = np.abs(ref).max()
        assert np.abs(got - ref).max() < 1e-12 * s
        if bake:
            # channel-resident round trip (the in-CG-loop form): padded
            # tensor in/out, phantom + ring re-zeroed every apply
            xch = cv.to_channels_padded(x)
            got_ch = np.asarray(cv.from_channels_padded(
                cv.apply_channels(xch)))
            assert np.abs(got_ch - ref).max() < 1e-12 * s
            # round-trip identity of the layout conversion itself
            back = np.asarray(cv.from_channels_padded(xch))
            assert np.abs(back - np.asarray(x)).max() == 0.0
