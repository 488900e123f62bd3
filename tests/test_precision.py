"""The precision policy: every solve program runs its f32 matrix
products at full f32 precision (``Precision.HIGHEST``), so no GPU can
route them through TF32.  Each case lowers a real program on the CPU
and reads the precision of every ``dot_general`` / ``convolution`` in
its StableHLO."""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from tpufem import aot
from tpufem.config import Config, SolverOptions
from tpufem.mesh.structured import BoxTetMesh

PRODUCT = re.compile(r"stablehlo\.(dot_general|convolution)")


@pytest.fixture
def lowered(monkeypatch):
    """StableHLO text of every program lowered through tpufem.aot."""
    texts = []
    orig = aot.lower

    def spy(fn, *args):
        low = orig(fn, *args)
        texts.append(low.as_text())
        return low

    monkeypatch.setattr(aot, "lower", spy)
    return texts


def _gmg_solve(problem_name, order):
    from tpufem.problems import elasticity, poisson
    cfg = Config(problem_type=problem_name, ndofs=1000,
                 scaling_type="strong", dtype="float32",
                 solver=SolverOptions(pc_type="gmg", ksp_rtol=1e-6,
                                      ksp_true_residual="off"))
    build = {"poisson": poisson.problem,
             "elasticity": elasticity.problem}[problem_name]
    prob = build(BoxTetMesh(8, 8, 8), order, cfg)
    prob.solver_function(prob.u, prob.b)


def _ell_spmv():
    from tpufem.fem.assemble import assemble_operator
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.problems import common
    mesh = BoxTetMesh(4, 4, 4)
    space = FunctionSpace(mesh, 1, bs=3)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.elasticity_bc_marker))
    ell, _ = assemble_operator(space, bc, "elasticity", dtype=np.float32)
    aot.compile_aot(ell.matvec, jnp.ones(space.ndofs, jnp.float32))


@pytest.mark.parametrize("program", [
    pytest.param(lambda: _gmg_solve("poisson", 1), id="poisson-p1-gmg"),
    pytest.param(lambda: _gmg_solve("elasticity", 2), id="elasticity-p2-gmg"),
    pytest.param(_ell_spmv, id="ell-spmv-bs3"),
])
def test_products_run_at_highest_precision(lowered, program):
    program()
    products = [ln for t in lowered for ln in t.splitlines()
                if PRODUCT.search(ln)]
    assert products, "program lowered no matrix product"
    low = [ln.strip()[:160] for ln in products if "HIGHEST" not in ln]
    assert not low, f"{len(low)} products below HIGHEST: {low[:3]}"
