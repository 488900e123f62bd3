"""Row-sharded assembled-operator solver — the distributed path for
UNSTRUCTURED meshes (and any assembled-CSR problem).

Reference behavior matched: the spoke-mesh CI jobs run the assembled
Poisson problem on multiple MPI ranks with CG + AMG to rtol 1e-8
(.github/workflows/ccpp.yml:102-117, distributed create_mesh at
src/mesh.cpp:362-368).  Design:

- **partition**: dofs are partitioned by a Morton space-filling curve
  over dof coordinates (tpufem.parallel.gmap.partition_cells_sfc) —
  the deterministic, communication-free replacement for
  ParMETIS/PT-SCOTCH (src/mesh.cpp:153-162);
- **operator**: owner-computes-rows.  Each shard holds the FULL rows of
  its owned dofs in padded-ELL form with columns remapped to local
  [owned | ghost] slots; one SpMV = dense [rows, K] gather-multiply-sum
  followed by a forward ghost refresh (a static ppermute schedule,
  tpufem.parallel.gmap.GeneralIndexMaps.fwd).  No reverse scatter is
  needed: rows are never split across shards;
- **preconditioner**: SA-AMG with the FINE level always distributed
  (sharded Chebyshev smoothing, sharded restriction over owned rows,
  sharded prolongation).  Level 1 is ALSO distributed whenever it is
  stored sparse (above ``amg_dense_level_limit``): its rows are
  row-sharded by aggregate ownership (a coarse dof lives where its
  heaviest fine row lives, so transfers are shard-local except at
  subdomain boundaries) with its own edge-colored ppermute schedule;
  the fine->coarse restriction then exchanges only BOUNDARY-aggregate
  partial sums (a reverse scatter at ghost size), and the only psum in
  the V-cycle is at the SECOND coarse size (O(N/750)).  Below the
  dense limit, level 1 is a replicated bf16 dense level and the
  restriction is combined by ONE psum at first-coarse size (O(N/30)) —
  at that size replication is faster than latency-bound tiny
  collectives.  Either way iteration counts match the single-device
  SA-AMG (same hierarchy, same arithmetic up to summation order);
- **reductions**: owned-masked psum dots (MPI_Allreduce of cg.h:65).

Everything runs inside ONE jitted shard_map program.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, PartitionSpec as P

from tpufem.fem.assemble import ELLMatrix
from tpufem.la.cg import cg_solve
from tpufem.la.chebyshev import (chebyshev_smoother,
                                 chebyshev_smoother_zero)
from tpufem.parallel.gmap import (GeneralIndexMaps, build_general_maps,
                                  partition_cells_sfc)


def _localize_rows(A: sp.csr_matrix, gmap: GeneralIndexMaps, shard: int,
                   K: int, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Owned rows of A as padded ELL with LOCAL column slots."""
    no = int(gmap.owned_counts[shard])
    rows = gmap.local_gids[shard, :no]
    cols = np.zeros((gmap.max_owned, K), dtype=np.int32)
    vals = np.zeros((gmap.max_owned, K), dtype=dtype)
    sub = A[rows]
    indptr, indices, data = sub.indptr, sub.indices, sub.data
    loc = gmap.local_of_global(shard, indices.astype(np.int64))
    nnz = np.diff(indptr)
    rowids = np.repeat(np.arange(no), nnz)
    colpos = np.arange(indices.shape[0]) - indptr[rowids]
    cols[rowids, colpos] = loc
    vals[rowids, colpos] = data
    return cols, vals


@dataclasses.dataclass
class ShardedEllSolver:
    """Distributed CG over row-sharded ELL, SA-AMG preconditioned."""

    gmap: GeneralIndexMaps
    data: dict                 # stacked [S, ...] device arrays
    repl: dict                 # replicated arrays (suffix AMG, PT0, gids)
    suffix: object             # SAAMG over levels[1:] (or None)
    ndofs: int
    S: int
    mesh_axis: Mesh
    rtol: float
    maxit: int
    smoother_degree: int
    lmax0: float
    has_fine_level: bool
    nc0: int = 0               # first-coarse size (psum payload length)
    # distributed level 1 (sparse levels only; see module docstring)
    dist_l1: bool = False
    lmax1: float = 1.0
    nc1: int = 0               # second-coarse size (psum payload length)
    c_rounds: Tuple = ()       # level-1 ppermute schedule
    max_owned_c: int = 0
    deflate: bool = False      # project out the constant nullspace
    #                            (pure-Neumann spoke problem, PARITY.md)
    _cache: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, space, bc, csr_tuple, b_global: np.ndarray, nshards: int,
              options, dtype=jnp.float32,
              near_nullspace: Optional[np.ndarray] = None,
              rtol: float = 1e-8, maxit: int = 100,
              precond: bool = True, deflate: bool = False,
              devices=None) -> "ShardedEllSolver":
        """``precond=False`` runs plain distributed CG (the cgpoisson
        convention: on the BC-zero subspace the eliminated unit-diagonal
        operator produces the identical Krylov trajectory as the
        rows-zero matrix-free action, so no AMG hierarchy is built)."""
        from tpufem.la.amg import SAAMG

        indptr, indices, data = csr_tuple
        bs = bc.bs
        if data.ndim == 3:
            nb = indptr.shape[0] - 1
            A = sp.bsr_matrix((data, indices, indptr),
                              shape=(nb * bs, nb * bs)).tocsr()
        else:
            A = sp.csr_matrix((data, indices, indptr))
        N = A.shape[0]
        S = nshards
        npdtype = np.dtype(dtype)

        # dof partition: SFC over dof coordinates (bs components stay
        # together: partition scalar nodes, repeat for components)
        node_shard = partition_cells_sfc(space.scalar_dof_coords(), S)
        owner_of = np.repeat(node_shard, bs) if bs > 1 else node_shard

        # local dof sets: owned + all columns of owned rows
        local_sets = []
        for s in range(S):
            rows = np.flatnonzero(owner_of == s)
            cols = A[rows].indices
            local_sets.append(np.unique(np.concatenate([rows, cols])))
        gmap = build_general_maps(local_sets, owner_of)

        K = int(np.diff(A.indptr).max())
        ell_cols = np.zeros((S, gmap.max_owned, K), dtype=np.int32)
        ell_vals = np.zeros((S, gmap.max_owned, K), dtype=npdtype)
        for s in range(S):
            ell_cols[s], ell_vals[s] = _localize_rows(A, gmap, s, K, npdtype)

        # SA-AMG hierarchy on the global matrix (host setup — the
        # partitioner-analogue phase); level 0 re-sharded below
        repl = {}
        suffix = None
        lmax0 = 1.0
        dist_l1 = False
        dinv_loc = np.zeros((S, gmap.nlocal), dtype=npdtype)
        degree = 2
        if not precond:
            has_fine = False
        else:
            amg = SAAMG.setup(csr_tuple, bs=bs, options=options,
                              dtype=dtype, near_nullspace=near_nullspace,
                              bc_mask=bc.mask())
            degree = amg.smoother_degree
            has_fine = len(amg.levels) > 0
        if has_fine:
            lv0 = amg.levels[0]
            lmax0 = lv0.lmax
            dglob = np.zeros(N)
            dv = np.asarray(lv0.dinv, dtype=np.float64)
            dglob[:dv.shape[0]] = dv
            for s in range(S):
                dinv_loc[s] = dglob[gmap.local_gids[s]]
            # P rows for ALL local slots (owned + ghost): the prolongated
            # error is consistent without any exchange (xc is replicated),
            # and the restriction P^T r sums the SAME rows masked to
            # owned slots (each fine row owned by exactly one shard)
            Pc = np.asarray(lv0.P.cols)
            Pv = np.asarray(lv0.P.vals)
            Kp = Pc.shape[1]
            p_cols = np.zeros((S, gmap.nlocal, Kp), dtype=np.int32)
            p_vals = np.zeros((S, gmap.nlocal, Kp), dtype=npdtype)
            for s in range(S):
                no = int(gmap.owned_counts[s])
                ng = int(gmap.ghost_counts[s])
                sl = np.concatenate([gmap.local_gids[s, :no],
                                     gmap.local_gids[s, gmap.max_owned:
                                                     gmap.max_owned + ng]])
                dst = np.concatenate([np.arange(no),
                                      gmap.max_owned + np.arange(ng)])
                p_cols[s, dst] = Pc[sl]
                p_vals[s, dst] = Pv[sl]
            from tpufem.la.amg import SAAMG as _S
            # distribute level 1 whenever it is stored sparse (above the
            # dense limit) — i.e. exactly when replicating it would
            # not weak-scale; a dense level stays replicated (faster
            # than latency-bound collectives at O(N/30))
            nc0_ = int(amg.level_sizes[1])
            dist_l1 = (len(amg.levels) >= 2
                       and isinstance(amg.levels[1].A, ELLMatrix))
            if dist_l1:
                lv1 = amg.levels[1]
                lmax1 = lv1.lmax
                A1c = np.asarray(lv1.A.cols).astype(np.int64)
                A1v = np.asarray(lv1.A.vals)
                K1 = A1c.shape[1]
                # coarse ownership: a coarse dof lives on the shard that
                # owns its heaviest-|P| fine row (keeps transfers local
                # except at subdomain boundaries); P-less (inert) coarse
                # dofs default to shard 0 (their row is unit diagonal)
                rowsf = np.repeat(np.arange(Pc.shape[0]), Kp)
                colsf = Pc.reshape(-1).astype(np.int64)
                valsf = np.abs(np.asarray(Pv, dtype=np.float64)).reshape(-1)
                mnz = valsf > 0.0
                ordc = np.lexsort((-valsf[mnz], colsf[mnz]))
                cc, rrows = colsf[mnz][ordc], rowsf[mnz][ordc]
                firstpos = np.flatnonzero(np.r_[True, cc[1:] != cc[:-1]])
                owner_c = np.zeros(nc0_, dtype=np.int64)
                owner_c[cc[firstpos]] = owner_of[rrows[firstpos]]
                # local coarse sets: owned rows + their A1 columns + the
                # P-columns of every local fine slot (+ dof 0, the ELL
                # padding target, so local_of_global never misses)
                csets = []
                for s in range(S):
                    no = int(gmap.owned_counts[s])
                    ng = int(gmap.ghost_counts[s])
                    sl = np.concatenate(
                        [gmap.local_gids[s, :no],
                         gmap.local_gids[s, gmap.max_owned:
                                         gmap.max_owned + ng]])
                    own_rows = np.flatnonzero(owner_c == s)
                    csets.append(np.unique(np.concatenate(
                        [own_rows, Pc[sl].reshape(-1).astype(np.int64),
                         A1c[own_rows].reshape(-1),
                         np.zeros(1, dtype=np.int64)])))
                gmap_c = build_general_maps(csets, owner_c)
                c_ell_cols = np.zeros((S, gmap_c.max_owned, K1),
                                      dtype=np.int32)
                c_ell_vals = np.zeros((S, gmap_c.max_owned, K1),
                                      dtype=npdtype)
                c_dinv = np.zeros((S, gmap_c.nlocal), dtype=npdtype)
                d1 = np.asarray(lv1.dinv, dtype=np.float64)
                P1c = np.asarray(lv1.P.cols).astype(np.int64)
                P1v = np.asarray(lv1.P.vals)
                Kp1 = P1c.shape[1]
                p1_cols = np.zeros((S, gmap_c.nlocal, Kp1), dtype=np.int32)
                p1_vals = np.zeros((S, gmap_c.nlocal, Kp1), dtype=npdtype)
                p_cols_loc = np.zeros((S, gmap.nlocal, Kp), dtype=np.int32)
                for s in range(S):
                    noc = int(gmap_c.owned_counts[s])
                    ngc = int(gmap_c.ghost_counts[s])
                    own_rows = gmap_c.local_gids[s, :noc]
                    if noc:
                        lc = gmap_c.local_of_global(
                            s, A1c[own_rows].reshape(-1))
                        c_ell_cols[s, :noc] = lc.reshape(noc, K1)
                        c_ell_vals[s, :noc] = A1v[own_rows]
                    cslots = np.concatenate(
                        [own_rows,
                         gmap_c.local_gids[s, gmap_c.max_owned:
                                           gmap_c.max_owned + ngc]])
                    cdst = np.concatenate(
                        [np.arange(noc),
                         gmap_c.max_owned + np.arange(ngc)])
                    c_dinv[s, cdst] = d1[cslots]
                    # P1 rows for ALL local coarse slots: the level-2
                    # correction is replicated, so e1 = x1 + P1 e2 is
                    # consistent on ghosts without an exchange
                    p1_cols[s, cdst] = P1c[cslots]
                    p1_vals[s, cdst] = P1v[cslots]
                    # fine-level P columns remapped to LOCAL coarse slots
                    no = int(gmap.owned_counts[s])
                    ng = int(gmap.ghost_counts[s])
                    fsl = np.concatenate(
                        [gmap.local_gids[s, :no],
                         gmap.local_gids[s, gmap.max_owned:
                                         gmap.max_owned + ng]])
                    fdst = np.concatenate(
                        [np.arange(no), gmap.max_owned + np.arange(ng)])
                    p_cols_loc[s, fdst] = gmap_c.local_of_global(
                        s, Pc[fsl].reshape(-1).astype(np.int64)
                    ).reshape(fsl.shape[0], Kp)
                suffix = _S(levels=amg.levels[2:],
                            coarse_inv=amg.coarse_inv,
                            smoother_degree=amg.smoother_degree,
                            level_sizes=amg.level_sizes[2:])
            else:
                suffix = _S(levels=amg.levels[1:],
                            coarse_inv=amg.coarse_inv,
                            smoother_degree=amg.smoother_degree,
                            level_sizes=amg.level_sizes[1:])
        elif precond:
            suffix = amg  # levels empty -> vcycle = dense coarse solve

        # multi-process: the host setup above ran identically in every
        # process (the reference's spoke path is serial rank-0 setup
        # too, mesh.cpp:209); the device arrays below materialize ONLY
        # the shards this process addresses
        multiproc = jax.process_count() > 1
        if devices is None:
            if multiproc:
                from tpufem.parallel.multihost import shard_devices
                devices = shard_devices(S)
            else:
                devices = jax.devices()
        if len(devices) < S:
            raise ValueError(f"need {S} devices, have {len(devices)}")

        def _put(a):
            a = np.asarray(a)
            if not multiproc:
                return jnp.asarray(a)
            from tpufem.parallel.multihost import make_sharded_rows
            return make_sharded_rows(S, a.shape[1:], a.dtype,
                                     lambda s, aa=a: aa[s], devices[:S])

        data_d = dict(
            ell_cols=_put(ell_cols),
            ell_vals=_put(ell_vals),
            dinv=_put(dinv_loc),
            owned_mask=_put(gmap.owned_mask),
            send_idx=_put(gmap.send_idx.astype(np.int32)),
            send_mask=_put(gmap.send_mask),
            recv_idx=_put(gmap.recv_idx.astype(np.int32)),
            recv_mask=_put(gmap.recv_mask),
            b=_put(gmap.distribute(
                b_global.astype(np.float64)).astype(npdtype)),
        )
        if has_fine:
            data_d["p_vals"] = _put(p_vals)
            if dist_l1:
                data_d["p_cols_loc"] = _put(p_cols_loc)
                data_d["c_ell_cols"] = _put(c_ell_cols)
                data_d["c_ell_vals"] = _put(c_ell_vals)
                data_d["c_dinv"] = _put(c_dinv)
                data_d["c_owned_mask"] = _put(gmap_c.owned_mask)
                data_d["c_send_idx"] = _put(gmap_c.send_idx.astype(np.int32))
                data_d["c_send_mask"] = _put(gmap_c.send_mask)
                data_d["c_recv_idx"] = _put(gmap_c.recv_idx.astype(np.int32))
                data_d["c_recv_mask"] = _put(gmap_c.recv_mask)
                data_d["p1_cols"] = _put(p1_cols)
                data_d["p1_vals"] = _put(p1_vals)
            else:
                data_d["p_cols"] = _put(p_cols)
        # replicated side data: uncommitted host->default-device arrays
        # (identical in every process; jit replicates them)
        repl["local_gids"] = jnp.asarray(gmap.local_gids.astype(np.int32))
        repl["owned_mask_all"] = jnp.asarray(gmap.owned_mask)

        mesh_axis = Mesh(np.array(devices[:S]), ("shard",))
        return cls(gmap=gmap, data=data_d, repl=repl, suffix=suffix,
                   ndofs=N, S=S, mesh_axis=mesh_axis, rtol=rtol,
                   maxit=maxit, smoother_degree=degree, deflate=deflate,
                   lmax0=lmax0, has_fine_level=has_fine,
                   nc0=int(amg.level_sizes[1]) if has_fine else 0,
                   dist_l1=dist_l1,
                   lmax1=lmax1 if dist_l1 else 1.0,
                   nc1=(int(amg.level_sizes[2]) if dist_l1 else 0),
                   c_rounds=gmap_c.rounds if dist_l1 else (),
                   max_owned_c=gmap_c.max_owned if dist_l1 else 0)

    # -- jitted SPMD program -------------------------------------------------
    def _build_program(self):
        gm = self.gmap
        N = self.ndofs
        rtol, maxit = self.rtol, self.maxit
        degree = self.smoother_degree
        lmax0 = self.lmax0
        has_fine = self.has_fine_level
        nc0 = self.nc0
        rounds = gm.rounds
        max_owned = gm.max_owned
        dist_l1 = self.dist_l1
        deflate = self.deflate
        lmax1 = self.lmax1
        nc1 = self.nc1
        c_rounds = self.c_rounds
        max_owned_c = self.max_owned_c

        def shard_fn(d, repl, suffix):
            d = {k: v[0] for k, v in d.items()}
            lg_all = repl["local_gids"]          # [S, nlocal] replicated
            om_all = repl["owned_mask_all"]

            def fwd(y):
                for r, perm in enumerate(rounds):
                    vals = jnp.where(d["send_mask"][r],
                                     y[d["send_idx"][r]], 0.0)
                    recv = jax.lax.ppermute(vals, "shard", perm)
                    upd = jnp.where(d["recv_mask"][r], recv,
                                    y[d["recv_idx"][r]])
                    y = y.at[d["recv_idx"][r]].set(upd)
                return y

            def spmv(x):
                y_own = jnp.sum(d["ell_vals"] * x[d["ell_cols"]], axis=1)
                y = jnp.zeros_like(x).at[:max_owned].set(y_own)
                return fwd(y)

            def gather_global(y):
                ag = jax.lax.all_gather(y, "shard")      # [S, nlocal]
                lg = jnp.where(om_all, lg_all, N)
                return jnp.zeros(N + 1, y.dtype).at[
                    lg.reshape(-1)].set(ag.reshape(-1))[:N]

            def precond(r):
                if not has_fine:
                    eg = suffix.vcycle(gather_global(r))
                    k = jax.lax.axis_index("shard")
                    return eg[jnp.clip(lg_all[k], 0, N - 1)]
                smooth = chebyshev_smoother(spmv, d["dinv"], lmax0,
                                            degree=degree)
                smooth0 = chebyshev_smoother_zero(spmv, d["dinv"], lmax0,
                                                  degree=degree)
                # residual-tracking pre-smoothing from zero (mirrors
                # la.gmg.GMG.vcycle; one scanned spmv instance)
                x, rr = smooth0(r)
                rro = jnp.where(d["owned_mask"], rr, 0.0)
                contrib = d["p_vals"] * rro[:, None]
                if not dist_l1:
                    # replicated (dense) level 1: restriction
                    # rc = P^T rr, owner-computes — scatter-add each
                    # OWNED fine row's P-row into a coarse-length
                    # accumulator; ONE psum at coarse size (O(N/30))
                    # combines the shard partials.  No fine-sized
                    # collective anywhere in the V-cycle (asserted by
                    # test_rowshard's jaxpr payload check).
                    rc = jax.lax.psum(
                        jnp.zeros(nc0, r.dtype).at[
                            d["p_cols"].reshape(-1)].add(
                            contrib.reshape(-1)), "shard")
                    ec = suffix.vcycle(rc)
                    e = jnp.sum(d["p_vals"] * ec[d["p_cols"]], axis=1)
                    return smooth(x + e, r)

                # DISTRIBUTED level 1 (sparse levels): restriction lands
                # in LOCAL coarse slots; boundary-aggregate partials are
                # accumulated into owners by a reverse scatter (ghost-
                # sized ppermutes, not a coarse-sized psum) and ghosts
                # refreshed forward.
                def c_fwd(y):
                    for cr, perm in enumerate(c_rounds):
                        vals = jnp.where(d["c_send_mask"][cr],
                                         y[d["c_send_idx"][cr]], 0.0)
                        recv = jax.lax.ppermute(vals, "shard", perm)
                        upd = jnp.where(d["c_recv_mask"][cr], recv,
                                        y[d["c_recv_idx"][cr]])
                        y = y.at[d["c_recv_idx"][cr]].set(upd)
                    return y

                def c_rev_add(y):
                    for cr, perm in enumerate(c_rounds):
                        rperm = [(b2, a2) for (a2, b2) in perm]
                        vals = jnp.where(d["c_recv_mask"][cr],
                                         y[d["c_recv_idx"][cr]], 0.0)
                        recv = jax.lax.ppermute(vals, "shard", rperm)
                        y = y.at[d["c_send_idx"][cr]].add(
                            jnp.where(d["c_send_mask"][cr], recv, 0.0))
                    return y

                def spmv1(xc):
                    y_own = jnp.sum(d["c_ell_vals"] * xc[d["c_ell_cols"]],
                                    axis=1)
                    y = jnp.zeros_like(xc).at[:max_owned_c].set(y_own)
                    return c_fwd(y)

                rc_loc = jnp.zeros(d["c_dinv"].shape[0], r.dtype).at[
                    d["p_cols_loc"].reshape(-1)].add(contrib.reshape(-1))
                rc_loc = c_rev_add(rc_loc)
                # owners now hold full sums; ghost slots hold stale
                # partials — refresh them forward for a consistent rhs
                rc_loc = c_fwd(rc_loc.at[max_owned_c:].set(0.0))

                smooth1 = chebyshev_smoother(spmv1, d["c_dinv"], lmax1,
                                             degree=degree)
                smooth01 = chebyshev_smoother_zero(spmv1, d["c_dinv"],
                                                   lmax1, degree=degree)
                x1, rr1 = smooth01(rc_loc)
                # level-1 -> level-2 restriction: owned coarse rows into
                # a SECOND-coarse accumulator; the V-cycle's only psum is
                # this O(N/750) payload
                rr1o = jnp.where(d["c_owned_mask"], rr1, 0.0)
                rc2 = jax.lax.psum(
                    jnp.zeros(nc1, r.dtype).at[
                        d["p1_cols"].reshape(-1)].add(
                        (d["p1_vals"] * rr1o[:, None]).reshape(-1)),
                    "shard")
                e2 = suffix.vcycle(rc2)   # replicated levels[2:]
                # e2 is replicated, and p1 rows exist for ALL local
                # coarse slots, so e1 is ghost-consistent with no
                # exchange; smoothing preserves consistency (spmv1 ends
                # with a forward refresh)
                e1 = x1 + jnp.sum(d["p1_vals"] * e2[d["p1_cols"]], axis=1)
                e1 = smooth1(e1, rc_loc)
                e = jnp.sum(d["p_vals"] * e1[d["p_cols_loc"]], axis=1)
                return smooth(x + e, r)

            def dot(u, v):
                t = (jnp.float64 if (u.dtype == jnp.float32
                                     and jax.config.jax_enable_x64)
                     else u.dtype)
                local = jnp.sum(jnp.where(d["owned_mask"],
                                          u.astype(t) * v.astype(t), 0.0))
                return jax.lax.psum(local, "shard")

            M = precond if suffix is not None else None
            b_in = d["b"]
            if deflate:
                # pure-Neumann deflation (see problems/poisson.make_solver):
                # owned-masked global mean via ONE psum; subtracting a
                # constant keeps ghost slots consistent
                def demean(v):
                    s = jax.lax.psum(
                        jnp.sum(jnp.where(d["owned_mask"], v, 0.0)),
                        "shard")
                    return v - s / N
                b_in = demean(b_in)
                M = ((lambda r, _M=M: demean(_M(r)))
                     if M is not None else demean)
            x, it, rel = cg_solve(spmv, b_in, precond=M,
                                  rtol=rtol, maxit=maxit, dot_fn=dot)
            if deflate:
                x = demean(x)
            return x[None], it, rel

        specs_d = {k: P("shard") for k in self.data}
        fn = jax.shard_map(
            shard_fn, mesh=self.mesh_axis,
            in_specs=(specs_d, P(), P()),
            out_specs=(P("shard"), P(), P()),
        )
        return jax.jit(fn)

    def _run(self, scale: float = 1.0):
        if "run" not in self._cache:
            from tpufem.aot import lower
            self._cache["run"] = lower(self._build_program(), self.data,
                                       self.repl, self.suffix).compile()
        data = self.data
        if scale != 1.0:  # perturb so pipelined timing reps can't dedup
            data = dict(data, b=data["b"] * scale)
        return self._cache["run"](data, self.repl, self.suffix)

    def solve(self) -> Tuple[np.ndarray, int, float]:
        x_loc, it, rel = self._run()
        jax.block_until_ready(x_loc)
        x = self.gmap.collect(np.asarray(x_loc), self.ndofs)
        return x, int(it), float(rel)

    def solve_timed(self, reps: int = 3) -> Tuple[np.ndarray, int, float, float]:
        jax.block_until_ready(self._run()[0])
        t0 = time.perf_counter()
        outs = [self._run(1.0 + 1e-6 * (i + 1))[0] for i in range(reps)]
        jax.block_until_ready(outs)
        dt = (time.perf_counter() - t0) / reps
        x, it, rel = self.solve()
        return x, it, rel, dt
