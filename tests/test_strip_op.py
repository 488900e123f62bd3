"""StripOperator (fem/strip_op.py) == the const-table DiaOperator.

The strip form must be the SAME matrix as the verified DIA stencil
operator (itself pinned against independent dense quadrature in
test_assemble/test_dia_op), on the channel-strip layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpufem.fem.dia_op import DiaOperator
from tpufem.fem.strip_op import StripOperator
from tpufem.mesh.structured import BoxTetMesh


def _bc_dofs(mesh, order):
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.problems import common
    space = FunctionSpace(mesh, order)
    facets = mesh.locate_boundary_facets(common.poisson_bc_marker)
    return FunctionSpace(mesh, order), DirichletBC.from_space(space, facets)


@pytest.mark.parametrize("order,dims", [(2, (8, 9, 10)), (3, (8, 8, 9)),
                                        (1, (9, 8, 10))])
def test_strip_matches_dia(order, dims):
    mesh = BoxTetMesh(*dims)
    space, bc = _bc_dofs(mesh, order)
    dia = DiaOperator.try_const(mesh, order, "poisson",
                                bc_dofs=bc.flat_dofs(), dtype=jnp.float64,
                                device=False)
    assert dia is not None
    op = StripOperator.from_dia(dia, dtype=jnp.float64)
    assert op is not None
    rng = np.random.default_rng(3)
    u = rng.standard_normal(space.ndofs)

    # round trip
    uf = op.to_strips(jnp.asarray(u))
    np.testing.assert_allclose(np.asarray(op.from_strips(uf)), u,
                               rtol=0, atol=0)

    y_ref = dia.apply_np(u)
    y = np.asarray(op.apply(jnp.asarray(u)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-13)


def test_strip_output_padding_stays_clean():
    """Pad/guard columns and out-of-extent rows of the apply output
    are exactly zero, so a channel-resident CG never contaminates
    dot products."""
    mesh = BoxTetMesh(8, 9, 8)
    space, bc = _bc_dofs(mesh, 2)
    dia = DiaOperator.try_const(mesh, 2, "poisson", bc_dofs=bc.flat_dofs(),
                                dtype=jnp.float64, device=False)
    op = StripOperator.from_dia(dia, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(space.ndofs)
    xf = op.to_strips(jnp.asarray(u))
    yf = np.asarray(op.apply_strips(xf))
    # zero the valid region; everything remaining must be zero
    mask = np.asarray(op.to_strips(jnp.ones(space.ndofs))) != 0.0
    assert np.all(yf[~mask] == 0.0)
    # buffer dot == dof dot
    y = np.asarray(op.from_strips(jnp.asarray(yf)))
    assert np.isclose(float((jnp.asarray(yf) * xf).sum()),
                      float(y @ u), rtol=1e-12)


def test_strip_cg_end_to_end():
    """CG on the channel-resident strip form matches CG on the DIA form
    (iterations and solution)."""
    from tpufem.la.cg import cg_solve_fused
    mesh = BoxTetMesh(8, 8, 8)
    space, bc = _bc_dofs(mesh, 3)
    dia = DiaOperator.try_const(mesh, 3, "poisson", bc_dofs=bc.flat_dofs(),
                                dtype=jnp.float64, device=False)
    op = StripOperator.from_dia(dia, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    b_np = rng.standard_normal(space.ndofs)
    b_np[bc.flat_dofs()] = 0.0
    b = jnp.asarray(b_np)

    x_d, it_d, rel_d = jax.jit(
        lambda b: cg_solve_fused(dia.apply, b, x0=None, rtol=1e-8,
                                 maxit=400))(b)
    rf = op.to_strips(b)
    x_f, it_f, rel_f = jax.jit(
        lambda r: cg_solve_fused(op.apply_strips, r, x0=None, rtol=1e-8,
                                 maxit=400))(rf)
    x_s = np.asarray(op.from_strips(x_f))
    # the two applies are the same matrix (pinned exactly above) but
    # different summation orders, so the CG trajectories may part ways
    # by an ulp-scale step near the tolerance
    assert abs(int(it_f) - int(it_d)) <= 1
    assert float(rel_f) < 1e-8 and float(rel_d) < 1e-8
    r = b_np - dia.apply_np(x_s)
    assert np.linalg.norm(r) / np.linalg.norm(b_np) < 1e-7
    np.testing.assert_allclose(x_s, np.asarray(x_d), rtol=1e-4, atol=1e-6)



@pytest.mark.parametrize("order,dims", [(2, (8, 9, 10)), (3, (8, 8, 9))])
def test_strip_f32_matches_f64_reference(order, dims):
    """In float32 the strip apply stays within the smoke test's parity
    tolerance (rel-L2 1e-5) of the float64 host reference."""
    mesh = BoxTetMesh(*dims)
    space, bc = _bc_dofs(mesh, order)
    ref = DiaOperator.try_const(mesh, order, "poisson",
                                bc_dofs=bc.flat_dofs(), dtype=jnp.float64,
                                device=False)
    dia32 = DiaOperator.try_const(mesh, order, "poisson",
                                  bc_dofs=bc.flat_dofs(), dtype=jnp.float32)
    op = StripOperator.from_dia(dia32, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    u = rng.standard_normal(space.ndofs).astype(np.float32)
    y = np.asarray(jax.jit(lambda v: op.from_strips(
        op.apply_strips(op.to_strips(v))))(jnp.asarray(u)), np.float64)
    y_ref = ref.apply_np(u.astype(np.float64))
    assert np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref) <= 1e-5
