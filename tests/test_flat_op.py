"""FlatOperator (channel-flattened P2/P3 stencil) vs the DiaOperator
float64 host twin it is built from.

The flat form must be the SAME matrix: interior stacked weights +
per-plane z deltas + inclusion-exclusion slab corrections reproduce
dia.apply_np to f32 rounding."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpufem.fem.dia_op import DiaOperator
from tpufem.fem.dirichlet import DirichletBC
from tpufem.fem.flat_op import FlatOperator
from tpufem.fem.space import FunctionSpace
from tpufem.mesh.structured import BoxTetMesh
from tpufem.problems import common


def _build(order, dims):
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, order)
    facets = mesh.locate_boundary_facets(common.poisson_bc_marker)
    bc = DirichletBC.from_space(space, facets)
    dia = DiaOperator.try_const(mesh, order, "poisson",
                                bc_dofs=bc.flat_dofs(), device=False)
    assert dia is not None
    return dia


@pytest.mark.parametrize("order,dims", [(2, (8, 9, 10)), (3, (8, 8, 9))])
def test_flat_matches_dia_xla(order, dims):
    dia = _build(order, dims)
    op = FlatOperator.from_dia(dia)
    assert op is not None
    rng = np.random.default_rng(0)
    x = rng.standard_normal(dia.layout.ndofs)
    ref = dia.apply_np(x)
    got = np.asarray(op.apply(jnp.asarray(x, dtype=jnp.float32)))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 2e-5 * scale


def test_flat_roundtrip_layout():
    dia = _build(3, (8, 8, 9))
    op = FlatOperator.from_dia(dia)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(dia.layout.ndofs).astype(np.float32)
    back = np.asarray(op.from_flat(op.to_flat(jnp.asarray(x))))
    np.testing.assert_allclose(back, x, rtol=0, atol=0)


def test_use_flat_cg_parity():
    """-use_flat 1 end-to-end: same iteration count and solution as the
    default DIA path (identical matrix, identical Krylov trajectory up
    to f32 rounding)."""
    from tpufem.config import Config, SolverOptions
    from tpufem.problems import cgpoisson

    mesh = BoxTetMesh(8, 9, 10)
    sols = {}
    for use_flat in (False, True):
        extra = {"cg_rtol": 1e-6}
        if use_flat:
            extra["use_flat"] = 1
        cfg = Config(problem_type="cgpoisson", ndofs=1000,
                     scaling_type="strong", dtype="float32",
                     solver=SolverOptions(extra=dict(extra)))
        prob = cgpoisson.problem(mesh, 2, cfg)
        x, it = prob.solver_function(prob.u, prob.b)
        sols[use_flat] = (np.asarray(x), it)
    x_ref, it_ref = sols[False]
    x_flat, it_flat = sols[True]
    # same matrix, but dots accumulate in a different order over the
    # padded plane buffer -> the f32 trajectory can take a couple of
    # extra/fewer steps at this tiny size; the solution check is the
    # real parity signal
    assert abs(it_flat - it_ref) <= 3
    scale = np.abs(x_ref).max()
    assert np.abs(x_flat - x_ref).max() < 1e-4 * scale

