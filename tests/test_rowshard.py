"""Row-sharded assembled solver (general shard graphs, distributed
SA-AMG fine level) vs single-device solves, on the virtual 8-CPU mesh.

Reference behavior: the spoke-mesh CI jobs run assembled Poisson + AMG
CG on 2 MPI ranks (ccpp.yml:102-117); iteration counts and solutions
must not depend on the rank count."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpufem.config import SolverOptions
from tpufem.fem.assemble import assemble_operator
from tpufem.fem.dirichlet import DirichletBC
from tpufem.fem.space import FunctionSpace
from tpufem.la.amg import SAAMG
from tpufem.la.cg import cg_solve
from tpufem.mesh import BoxTetMesh
from tpufem.parallel.gmap import build_general_maps, partition_cells_sfc
from tpufem.parallel.rowshard import ShardedEllSolver
from tpufem.problems import common


def _single(space, bc, csr, b, problem, nns=None):
    A, _ = assemble_operator(space, bc, problem, dtype=np.float64)
    amg = SAAMG.setup(csr, bs=bc.bs, options=SolverOptions(),
                      dtype=jnp.float64, near_nullspace=nns,
                      bc_mask=bc.mask())
    return cg_solve(A.matvec, jnp.asarray(b), precond=amg.vcycle,
                    rtol=1e-8, maxit=100)


@pytest.mark.parametrize("nshards", [2, 8])
def test_rowshard_poisson_matches_single(nshards):
    mesh = BoxTetMesh(8, 9, 10)
    space = FunctionSpace(mesh, 2)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    _, csr = assemble_operator(space, bc, "poisson", dtype=np.float64)
    from tpufem.problems.poisson import assemble_poisson_rhs_np
    b = assemble_poisson_rhs_np(space)
    b[bc.flat_dofs()] = 0.0
    x1, it1, _ = _single(space, bc, csr, b, "poisson")
    sh = ShardedEllSolver.build(space, bc, csr, b, nshards,
                                SolverOptions(), dtype=jnp.float64,
                                rtol=1e-8, maxit=100)
    xs, its, _rel = sh.solve()
    assert its == int(it1)
    err = np.abs(xs - np.asarray(x1)).max() / np.abs(np.asarray(x1)).max()
    assert err < 1e-9


def test_rowshard_elasticity_matches_single():
    from tpufem.la.nullspace import build_near_nullspace
    mesh = BoxTetMesh(6, 6, 8)
    space = FunctionSpace(mesh, 1, bs=3)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.elasticity_bc_marker))
    _, csr = assemble_operator(space, bc, "elasticity", dtype=np.float64)
    from tpufem.problems.elasticity import assemble_elasticity_rhs_np
    b = assemble_elasticity_rhs_np(space)
    b[bc.flat_dofs()] = 0.0
    nns = build_near_nullspace(space.scalar_dof_coords())
    x1, it1, _ = _single(space, bc, csr, b, "elasticity", nns=nns)
    sh = ShardedEllSolver.build(space, bc, csr, b, 4, SolverOptions(),
                                dtype=jnp.float64, near_nullspace=nns,
                                rtol=1e-8, maxit=100)
    xs, its, _rel = sh.solve()
    assert abs(its - int(it1)) <= 1
    err = np.abs(xs - np.asarray(x1)).max() / np.abs(np.asarray(x1)).max()
    assert err < 1e-7


def test_general_maps_fwd_rev():
    """fwd refreshes ghosts from owners; rev accumulates ghost partial
    sums into owners — verified against a dense global reduction on an
    arbitrary (non-slab) ownership pattern."""
    rng = np.random.default_rng(0)
    S, N = 4, 40
    owner_of = rng.integers(0, S, N)
    # every shard references its owned dofs plus a random ghost set
    local_sets = []
    for s in range(S):
        own = np.flatnonzero(owner_of == s)
        gh = rng.choice(np.flatnonzero(owner_of != s), size=7,
                        replace=False)
        local_sets.append(np.unique(np.concatenate([own, gh])))
    gm = build_general_maps(local_sets, owner_of)

    xg = rng.standard_normal(N)
    xl = gm.distribute(xg)

    from jax.sharding import Mesh, PartitionSpec as P
    devs = jax.devices()[:S]
    mesh_axis = Mesh(np.array(devs), ("shard",))

    data = dict(send_idx=jnp.asarray(gm.send_idx),
                send_mask=jnp.asarray(gm.send_mask),
                recv_idx=jnp.asarray(gm.recv_idx),
                recv_mask=jnp.asarray(gm.recv_mask))

    def fn(d, y):
        d = {k: v[0] for k, v in d.items()}
        y = y[0]
        z = gm.fwd(y, d["send_idx"], d["send_mask"], d["recv_idx"],
                   d["recv_mask"])
        w = gm.rev_add(y, d["send_idx"], d["send_mask"], d["recv_idx"],
                       d["recv_mask"])
        return z[None], w[None]

    run = jax.jit(jax.shard_map(
        fn, mesh=mesh_axis,
        in_specs=({k: P("shard") for k in data}, P("shard")),
        out_specs=(P("shard"), P("shard"))))

    # corrupt ghost slots; fwd must restore owner values
    xl_bad = xl.copy()
    for s in range(S):
        ng = int(gm.ghost_counts[s])
        xl_bad[s, gm.max_owned: gm.max_owned + ng] = -99.0
    z, w = run(data, jnp.asarray(xl_bad))
    z = np.asarray(z)
    for s in range(S):
        ng = int(gm.ghost_counts[s])
        sl = slice(gm.max_owned, gm.max_owned + ng)
        assert np.allclose(z[s, sl], xg[gm.local_gids[s, sl]])

    # rev: owners accumulate every shard's ghost contribution
    y = gm.distribute(xg)  # ghost slots hold the owner's value
    _z, w = run(data, jnp.asarray(y))
    w = np.asarray(w)
    expect = xg.copy()
    for s in range(S):
        ng = int(gm.ghost_counts[s])
        for g in gm.local_gids[s, gm.max_owned: gm.max_owned + ng]:
            expect[g] += xg[g]
    for s in range(S):
        no = int(gm.owned_counts[s])
        assert np.allclose(w[s, :no], expect[gm.local_gids[s, :no]])


def test_sfc_partition_balance():
    rng = np.random.default_rng(1)
    pts = rng.random((1000, 3))
    shard = partition_cells_sfc(pts, 8)
    counts = np.bincount(shard, minlength=8)
    assert counts.min() >= 124 and counts.max() <= 126


def test_rowshard_unpreconditioned_matches_matrixfree():
    """precond=False (the sharded cgpoisson path): on the BC-zero
    subspace the eliminated operator's CG trajectory equals the
    single-device rows-zero matrix-free action's."""
    from tpufem.fem.dia_op import build_operator
    mesh = BoxTetMesh(8, 9, 10)
    space = FunctionSpace(mesh, 2)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    _, csr = assemble_operator(space, bc, "poisson", dtype=np.float64)
    from tpufem.problems.poisson import assemble_poisson_rhs_np
    b = assemble_poisson_rhs_np(space)
    b[bc.flat_dofs()] = 0.0
    op = build_operator(mesh, 2, "poisson", bc_dofs=bc.flat_dofs(),
                        dtype=jnp.float64, bake_bc=False)
    x1, it1, _ = cg_solve(op.apply_bc_rows_zero, jnp.asarray(b),
                          rtol=1e-6, maxit=100)
    sh = ShardedEllSolver.build(space, bc, csr, b, 8, SolverOptions(),
                                dtype=jnp.float64, rtol=1e-6, maxit=100,
                                precond=False)
    xs, its, _rel = sh.solve()
    assert abs(its - int(it1)) <= 1
    err = np.abs(xs - np.asarray(x1)).max() / np.abs(np.asarray(x1)).max()
    assert err < 1e-8


def _collect_prims(jaxpr, out):
    """Recursively collect (primitive name, input avals) from a jaxpr."""
    for eq in jaxpr.eqns:
        out.append((eq.primitive.name,
                    [getattr(v, "aval", None) for v in eq.invars]))
        for p in eq.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None and hasattr(inner, "eqns"):
                    _collect_prims(inner, out)
                elif hasattr(sub, "eqns"):
                    _collect_prims(sub, out)
    return out


def test_rowshard_vcycle_comm_payload():
    """The distributed V-cycle's only cross-shard exchange beyond the
    smoother halos is ONE coarse-sized psum: the program must contain NO
    all_gather, and every psum payload is at most the first-coarse size
    (guards against regressing to the fine-residual all-gather this
    replaced)."""
    mesh = BoxTetMesh(8, 9, 10)
    space = FunctionSpace(mesh, 2)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    _, csr = assemble_operator(space, bc, "poisson", dtype=np.float64)
    from tpufem.problems.poisson import assemble_poisson_rhs_np
    b = assemble_poisson_rhs_np(space)
    b[bc.flat_dofs()] = 0.0
    sh = ShardedEllSolver.build(space, bc, csr, b, 4, SolverOptions(),
                                dtype=jnp.float64, rtol=1e-8, maxit=100)
    assert sh.has_fine_level and 0 < sh.nc0 < sh.ndofs // 4
    jaxpr = jax.make_jaxpr(sh._build_program())(sh.data, sh.repl, sh.suffix)
    prims = _collect_prims(jaxpr.jaxpr, [])
    names = {n for n, _ in prims}
    assert "all_gather" not in names, "fine-sized all_gather regressed"
    assert "psum" in names or "psum_invariant" in names
    for n, avals in prims:
        if n.startswith("psum"):
            for a in avals:
                if a is not None and hasattr(a, "size"):
                    assert a.size <= sh.nc0, (
                        f"psum payload {a.size} exceeds coarse size {sh.nc0}")


def test_general_maps_multi_round_schedule():
    """A complete ghost graph (every shard ghosts from every other)
    forces a multi-round edge coloring; fwd must still restore every
    ghost from its owner."""
    S = 4
    # dof g owned by shard g % S; every shard references ALL dofs
    N = 16
    owner_of = np.arange(N) % S
    local_sets = [np.arange(N) for _ in range(S)]
    gm = build_general_maps(local_sets, owner_of)
    assert len(gm.rounds) >= 2  # S-1 = 3 rounds for the complete graph

    xg = np.random.default_rng(5).standard_normal(N)
    xl = gm.distribute(xg)
    for s in range(S):
        ng = int(gm.ghost_counts[s])
        xl[s, gm.max_owned: gm.max_owned + ng] = -1.0  # corrupt ghosts

    from jax.sharding import Mesh, PartitionSpec as P
    mesh_axis = Mesh(np.array(jax.devices()[:S]), ("shard",))
    data = dict(send_idx=jnp.asarray(gm.send_idx),
                send_mask=jnp.asarray(gm.send_mask),
                recv_idx=jnp.asarray(gm.recv_idx),
                recv_mask=jnp.asarray(gm.recv_mask))

    def fn(d, y):
        d = {k: v[0] for k, v in d.items()}
        return gm.fwd(y[0], d["send_idx"], d["send_mask"], d["recv_idx"],
                      d["recv_mask"])[None]

    run = jax.jit(jax.shard_map(
        fn, mesh=mesh_axis,
        in_specs=({k: P("shard") for k in data}, P("shard")),
        out_specs=P("shard")))
    z = np.asarray(run(data, jnp.asarray(xl)))
    for s in range(S):
        ng = int(gm.ghost_counts[s])
        sl = slice(gm.max_owned, gm.max_owned + ng)
        assert np.allclose(z[s, sl], xg[gm.local_gids[s, sl]])


@pytest.mark.parametrize("nshards", [2, 8])
def test_rowshard_distributed_l1_matches_single(nshards):
    """amg_dense_level_limit=0 keeps level 1 sparse, which routes it
    through the DISTRIBUTED level-1 path (row-sharded by aggregate
    ownership, restriction exchanged at boundary-aggregate size).
    Iteration counts and solutions must match the single-device SA-AMG
    built from the same hierarchy options."""
    mesh = BoxTetMesh(8, 9, 10)
    space = FunctionSpace(mesh, 2)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    _, csr = assemble_operator(space, bc, "poisson", dtype=np.float64)
    from tpufem.problems.poisson import assemble_poisson_rhs_np
    b = assemble_poisson_rhs_np(space)
    b[bc.flat_dofs()] = 0.0
    opts = SolverOptions(amg_dense_level_limit=0,
                          amg_coarse_eq_limit=50)
    from tpufem.fem.assemble import assemble_operator as _ao
    A, _ = _ao(space, bc, "poisson", dtype=np.float64)
    amg = SAAMG.setup(csr, bs=bc.bs, options=opts, dtype=jnp.float64,
                      bc_mask=bc.mask())
    assert len(amg.levels) >= 2  # the test needs a sparse level 1
    x1, it1, _ = cg_solve(A.matvec, jnp.asarray(b), precond=amg.vcycle,
                          rtol=1e-8, maxit=100)
    sh = ShardedEllSolver.build(space, bc, csr, b, nshards,
                                SolverOptions(amg_dense_level_limit=0,
                                              amg_coarse_eq_limit=50),
                                dtype=jnp.float64, rtol=1e-8, maxit=100)
    assert sh.dist_l1, "sparse level 1 must take the distributed path"
    xs, its, _rel = sh.solve()
    assert abs(its - int(it1)) <= 1
    err = np.abs(xs - np.asarray(x1)).max() / np.abs(np.asarray(x1)).max()
    assert err < 1e-9


def test_rowshard_distributed_l1_comm_payload():
    """With level 1 distributed, the V-cycle's only psum is at the
    SECOND-coarse size (nc1); the fine->coarse restriction moves only
    boundary-aggregate partials through ghost-sized ppermutes."""
    mesh = BoxTetMesh(8, 9, 10)
    space = FunctionSpace(mesh, 2)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    _, csr = assemble_operator(space, bc, "poisson", dtype=np.float64)
    from tpufem.problems.poisson import assemble_poisson_rhs_np
    b = assemble_poisson_rhs_np(space)
    b[bc.flat_dofs()] = 0.0
    sh = ShardedEllSolver.build(space, bc, csr, b, 4,
                                SolverOptions(amg_dense_level_limit=0,
                                              amg_coarse_eq_limit=50),
                                dtype=jnp.float64, rtol=1e-8, maxit=100)
    assert sh.dist_l1 and 0 < sh.nc1 < sh.nc0
    jaxpr = jax.make_jaxpr(sh._build_program())(sh.data, sh.repl, sh.suffix)
    prims = _collect_prims(jaxpr.jaxpr, [])
    names = {n for n, _ in prims}
    assert "all_gather" not in names, "fine-sized all_gather regressed"
    for n, avals in prims:
        if n.startswith("psum"):
            for a in avals:
                if a is not None and hasattr(a, "size"):
                    assert a.size <= sh.nc1, (
                        f"psum payload {a.size} exceeds second-coarse "
                        f"size {sh.nc1}")
