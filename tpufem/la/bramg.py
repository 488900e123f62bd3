"""Lattice-brick smoothed-aggregation AMG (the structured-path GAMG).

A lattice-first redesign of the SA-AMG preconditioner for problems
assembled on the structured ``BoxTetMesh`` lattice (the reference's
flagship elasticity + GAMG config, README.md:63-82 of the reference, and the
AMG-forced Poisson path, README.md:110-128).  The algebra is standard
smoothed aggregation — per-aggregate QR of the near-nullspace gives the
tentative prolongator P0, one Jacobi step gives P = (I - w D^-1 A) P0,
coarse operators are Galerkin P^T A P, levels smooth with Chebyshev —
but every *choice with representational freedom* is made lattice-first:

- **Aggregates are 3x3x3 lattice bricks** (PETSc GAMG offers the same
  geometric-aggregation mode).  With the P1 stencil's reach of one
  lattice step, brick size 3 makes the Galerkin coarse stencil reach
  provably <= 1 brick: supp(P e_J) = brick J plus a 1-node ring =
  [3J-1, 3J+3] per axis, so (P e_I)^T A (P e_J) != 0 requires
  3|I - J| <= 5, i.e. |I - J| <= 1.  Every coarse level is therefore a
  27-point block stencil on the aggregate lattice — the same
  shift-diagonal structure as the fine DiaOperator, with NO random
  gathers at any level (the generic SA path's padded-ELL/dense coarse
  matvecs and m-wide transfer gathers were its whole V-cycle cost).

- **Transfers are factored** (P applied as tentative-brick op + one
  operator action, la/amg.py's fine_factored generalized to every
  level).  The tentative P0 on a brick lattice is upsample-multiply /
  multiply-bricksum — pure reshape/slice arithmetic.

- **Coarse operators are probed, not multiplied.**  Since the coarse
  stencil reach is 1, a 3x3x3 coloring of the coarse lattice makes
  probe columns non-aliasing: 27 x m applications of the factored
  Galerkin operator to lattice comb vectors recover every stencil
  block exactly.  Setup therefore needs no CSR export, no scipy
  SpGEMM, and no dense densify-upload (the generic path's to_scipy,
  Galerkin and device phases).

- **Block levels are flattened to scalar shift-diagonals.**  A block
  stencil y[I,i] += W[d][I,i,j] x[I+d,j] on an [az, ay, ax, m] lattice
  becomes scalar shift-diagonals on the [az, ay, ax*m] grid: the flat
  minor-axis shift s = dx*m + (j - i) addresses component j of node
  x+dx from component i of node x, and terms with equal s merge into
  one weight field on disjoint lanes.  27 fields for m=1, <= 9*(4m-3)
  for block size m — each applied as a fused shifted-slice multiply-add
  over a contiguous minor dim ax*m.

Vector layout contract: scalar problems use the flat z-major node grid;
bs=3 problems use the component-PLANAR layout ([c * nnodes + node], see
fem.dia_op.DiaOperator.planar) — the interleaved layout's 3-wide minor
axis makes every fine slice a stride-3 access.

Reference analogues: PETSc GAMG smoothed aggregation + near-nullspace
(elasticity_problem.cpp:36-94, 238-241), -pc_gamg_coarse_eq_limit
(README.md:77), Chebyshev/Jacobi level smoothers (README.md:78-79).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.la.chebyshev import chebyshev_smoother, chebyshev_smoother_zero

logger = logging.getLogger("tpufem")

BRICK = 3  # aggregate brick edge (matches the fine stencil reach; see
#            module docstring for why reach 1 requires brick >= 3)


def _ceil3(n: int) -> int:
    return -(-n // BRICK)


# ---------------------------------------------------------------------------
# Tentative prolongator on a brick lattice (host setup)
# ---------------------------------------------------------------------------


def brick_qr(B_lat: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-brick QR of the near-nullspace candidates.

    B_lat: [gz, gy, gx, c, m] nullspace values at lattice nodes (c = the
    level's per-node block size, m = candidate columns; BC rows zeroed).
    Returns (fw [gz, gy, gx, c, m] tentative weights, Bc [az, ay, ax, m, m]
    coarse candidates (the R factors), dead [az, ay, ax, m] bool mask of
    rank-deficient coarse dofs — their fw columns and R rows are zeroed).
    Mirrors la/amg.py:tentative_prolongator's rank handling.
    """
    gz, gy, gx, c, m = B_lat.shape
    az, ay, ax = _ceil3(gz), _ceil3(gy), _ceil3(gx)
    pad = np.zeros((az * BRICK, ay * BRICK, ax * BRICK, c, m))
    pad[:gz, :gy, :gx] = B_lat
    # [az, ay, ax, 27*c, m] brick blocks
    blocks = (pad.reshape(az, BRICK, ay, BRICK, ax, BRICK, c, m)
              .transpose(0, 2, 4, 1, 3, 5, 6, 7)
              .reshape(az, ay, ax, BRICK ** 3 * c, m))
    Q, R = np.linalg.qr(blocks)
    rdiag = np.abs(np.diagonal(R, axis1=-2, axis2=-1))  # [az, ay, ax, m]
    scale = np.maximum(rdiag.max(axis=-1, keepdims=True), 1e-300)
    dead = (rdiag < 1e-8 * scale) | (rdiag < 1e-12)
    if dead.any():
        Q = np.where(dead[..., None, :], 0.0, Q)
        R = np.where(dead[..., :, None], 0.0, R)
    fw = (Q.reshape(az, ay, ax, BRICK, BRICK, BRICK, c, m)
          .transpose(0, 3, 1, 4, 2, 5, 6, 7)
          .reshape(az * BRICK, ay * BRICK, ax * BRICK, c, m)
          [:gz, :gy, :gx])
    return fw, R, dead


# ---------------------------------------------------------------------------
# Lattice stencil level (device apply: flat shift-diagonals)
# ---------------------------------------------------------------------------


def _flat_plan(m: int) -> List[Tuple[int, int, int]]:
    """(dz, dy, s) flat-field plan covering all (dz, dy, dx, i, j):
    s = dx*m + j - i ranges over [-(2m-1), 2m-1]."""
    plan = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for s in range(-(2 * m - 1), 2 * m):
                plan.append((dz, dy, s))
    return plan


def stencil_to_flat_fields(W: np.ndarray, m: int) -> Tuple[Tuple, List[np.ndarray]]:
    """W: [3, 3, 3, az, ay, ax, m, m] block-stencil fields indexed by
    (dz+1, dy+1, dx+1).  Returns (plan, fields): for each kept
    (dz, dy, s), one [az, ay, ax*m] weight field with
    field[z, y, x*m + i] = W[dz, dy, dx, z, y, x, i, j] where
    s = dx*m + j - i (disjoint-lane merge across dx for equal s)."""
    az, ay, ax = W.shape[3:6]
    fields = {}
    for dxi, dx in enumerate((-1, 0, 1)):
        Wd = W[:, :, dxi]  # [3, 3, az, ay, ax, m, m]
        for i in range(m):
            for j in range(m):
                s = dx * m + j - i
                blk = Wd[..., i, j]  # [3, 3, az, ay, ax]
                if not blk.any():
                    continue
                for dzi in range(3):
                    for dyi in range(3):
                        w = blk[dzi, dyi]
                        if not w.any():
                            continue
                        key = (dzi - 1, dyi - 1, s)
                        f = fields.get(key)
                        if f is None:
                            f = np.zeros((az, ay, ax * m))
                            fields[key] = f
                        f[:, :, i::m] = w
    plan = sorted(fields)
    return tuple(plan), [fields[k] for k in plan]


def flat_apply(plan, fields, adims, m, x_flat):
    """Device stencil apply on the [az, ay, ax*m] flat grid (jnp)."""
    az, ay, ax = adims
    P = 2 * m - 1 if m > 1 else 1
    x = x_flat.reshape(az, ay, ax * m)
    xp = jnp.pad(x, ((1, 1), (1, 1), (P, P)))
    out = None
    for (dz, dy, s), f in zip(plan, fields):
        src = xp[1 + dz: 1 + dz + az, 1 + dy: 1 + dy + ay,
                 P + s: P + s + ax * m]
        t = f * src
        out = t if out is None else out + t
    return out.reshape(-1)


def flat_apply_np(plan, fields, adims, m, x_flat):
    """Host numpy twin of flat_apply (lmax power iteration at setup)."""
    az, ay, ax = adims
    P = 2 * m - 1 if m > 1 else 1
    x = x_flat.reshape(az, ay, ax * m)
    xp = np.pad(x, ((1, 1), (1, 1), (P, P)))
    out = np.zeros_like(x)
    for (dz, dy, s), f in zip(plan, fields):
        out += np.asarray(f) * xp[1 + dz: 1 + dz + az,
                                  1 + dy: 1 + dy + ay,
                                  P + s: P + s + ax * m]
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Brick transfers (device)
# ---------------------------------------------------------------------------


def _upsample3(xc: jnp.ndarray, gdims) -> jnp.ndarray:
    """[az, ay, ax, ...] -> [gz, gy, gx, ...]: each brick's value
    repeated 3x per axis, truncated to the real grid."""
    gz, gy, gx = gdims
    up = jnp.repeat(jnp.repeat(jnp.repeat(xc, BRICK, axis=0),
                               BRICK, axis=1), BRICK, axis=2)
    return up[:gz, :gy, :gx]


def _bricksum3(t: jnp.ndarray, adims) -> jnp.ndarray:
    """[gz, gy, gx, ...] -> [az, ay, ax, ...]: zero-pad to brick
    multiples and sum each 3x3x3 brick."""
    az, ay, ax = adims
    gz, gy, gx = t.shape[:3]
    t = jnp.pad(t, ((0, az * BRICK - gz), (0, ay * BRICK - gy),
                    (0, ax * BRICK - gx)) + ((0, 0),) * (t.ndim - 3))
    t = t.reshape((az, BRICK, ay, BRICK, ax, BRICK) + t.shape[3:])
    return t.sum(axis=(1, 3, 5))


# ---------------------------------------------------------------------------
# Level + hierarchy
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class _BLevel:
    """One level: its operator (None at level 0 — the caller's
    fine_matvec) + the factored smoothed transfer to the next level."""

    fields: Optional[Tuple[jnp.ndarray, ...]]  # flat stencil weights
    dinv: jnp.ndarray          # flat [n]
    fw: jnp.ndarray            # [gz, gy, gx, c, m] tentative weights
    omega_dinv: jnp.ndarray    # flat [n]
    lmax: float                # static
    plan: Tuple                # static
    gdims: Tuple[int, int, int]    # static: node-lattice dims
    adims: Tuple[int, int, int]    # static: aggregate-lattice dims
    c: int                     # static: per-node block size at this level
    m: int                     # static: next level's block size
    planar: bool               # static: level-0 bs>1 planar flat layout

    def tree_flatten(self):
        return (self.fields, self.dinv, self.fw, self.omega_dinv), (
            self.lmax, self.plan, self.gdims, self.adims, self.c, self.m,
            self.planar)

    @classmethod
    def tree_unflatten(cls, aux, children):
        fields, dinv, fw, omega_dinv = children
        lmax, plan, gdims, adims, c, m, planar = aux
        return cls(fields, dinv, fw, omega_dinv, lmax, plan, gdims, adims,
                   c, m, planar)

    # flat vector <-> [gz, gy, gx, c] lattice
    def _to_lat(self, v: jnp.ndarray) -> jnp.ndarray:
        gz, gy, gx = self.gdims
        if self.planar:  # [c * n + node] planar components
            return v.reshape(self.c, gz, gy, gx).transpose(1, 2, 3, 0)
        # flat levels store x' = x*c + i (c minor within x)
        return v.reshape(gz, gy, gx, self.c)

    def _to_flat(self, t: jnp.ndarray) -> jnp.ndarray:
        if self.planar:
            return t.transpose(3, 0, 1, 2).reshape(-1)
        return t.reshape(-1)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return flat_apply(self.plan, self.fields, self.gdims, self.c, x)

    # NOTE: transfer contractions need full f32 products (the package's
    # precision policy, tpufem.aot): bf16-rounded products (~1e-2
    # relative) corrupted both the probed stencils and the V-cycle
    # transfers at m = 6 (true_rel 1e-4 at 468k elasticity).
    def p0_apply(self, xc: jnp.ndarray) -> jnp.ndarray:
        """Tentative prolongation: next-level flat -> this-level flat."""
        az, ay, ax = self.adims
        xl = xc.reshape(az, ay, ax, self.m)
        up = _upsample3(xl, self.gdims)                    # [g.., m]
        y = jnp.einsum("zyxcj,zyxj->zyxc", self.fw, up)
        return self._to_flat(y)

    def p0t_apply(self, v: jnp.ndarray) -> jnp.ndarray:
        """Tentative restriction: this-level flat -> next-level flat."""
        t = jnp.einsum("zyxcj,zyxc->zyxj", self.fw, self._to_lat(v))
        return _bricksum3(t, self.adims).reshape(-1)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BrickAMG:
    levels: List[_BLevel]
    coarse_inv: jnp.ndarray
    smoother_degree: int       # static
    level_sizes: List[int]     # static

    def tree_flatten(self):
        return (self.levels, self.coarse_inv), (self.smoother_degree,
                                                tuple(self.level_sizes))

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, coarse_inv = children
        degree, sizes = aux
        return cls(list(levels), coarse_inv, degree, list(sizes))

    # -- setup ---------------------------------------------------------------
    @classmethod
    def setup(cls, fine_op, mesh, bs: int, options, dtype=jnp.float32,
              near_nullspace: Optional[np.ndarray] = None,
              bc_mask: Optional[np.ndarray] = None) -> "BrickAMG":
        """Build the hierarchy from the structured fine operator.

        fine_op: the P1 DiaOperator (planar layout when bs > 1) — its
        ``apply`` is both the probing engine and the V-cycle's
        fine-level matvec; no CSR export happens.
        near_nullspace: [m, ndofs] in the NODE-INTERLEAVED dof order
        (la/nullspace.py contract); converted internally.
        bc_mask: [ndofs] bool, interleaved order.
        """
        t_total = time.perf_counter()
        ph = {"qr": 0.0, "probe": 0.0, "fields": 0.0, "eig": 0.0,
              "coarse": 0.0}
        nd = np.dtype(dtype)
        gz, gy, gx = mesh.Nz + 1, mesh.Ny + 1, mesh.Nx + 1
        nnode = gz * gy * gx
        coarse_limit = int(options.get("amg_coarse_eq_limit"))
        max_levels = int(options.get("amg_max_levels"))
        damping = float(options.get("amg_prolongator_damping"))
        degree = int(options.get("amg_smoother_degree"))
        planar = bool(getattr(fine_op, "planar", False))

        if near_nullspace is None:
            B = np.ones((nnode * bs, 1))
        else:
            B = np.ascontiguousarray(near_nullspace.T)  # [ndofs, m]
        if bc_mask is not None:
            flat = (np.repeat(bc_mask, bs)
                    if bc_mask.shape[0] * bs == B.shape[0] else bc_mask)
            B = B * (~flat)[:, None]
        m = B.shape[1]
        B_lat = B.reshape(gz, gy, gx, bs, m)

        # fine dinv / lmax (host stencil diagonal + surrogate estimate)
        d0 = fine_op.diagonal_np()  # planar order when planar
        dinv0 = np.where(d0 != 0, 1.0 / np.where(d0 == 0, 1.0, d0), 0.0)
        t0 = time.perf_counter()
        from tpufem.la.gmg import surrogate_lmax
        from tpufem.problems import common
        marker = (common.elasticity_bc_marker if bs == 3
                  else common.poisson_bc_marker)
        problem = "elasticity" if bs == 3 else "poisson"
        lmax0 = surrogate_lmax(mesh, 1, problem, marker, dtype)
        ph["eig"] += time.perf_counter() - t0

        levels: List[_BLevel] = []
        sizes = [nnode * bs]

        # ---- level 0: fine (operator external) -----------------------------
        t0 = time.perf_counter()
        fw0, R0, dead0 = brick_qr(B_lat)
        ph["qr"] += time.perf_counter() - t0
        az, ay, ax = _ceil3(gz), _ceil3(gy), _ceil3(gx)
        omega0 = damping / lmax0
        lv0 = _BLevel(
            fields=None,
            dinv=jnp.asarray(dinv0.astype(nd)),
            fw=jnp.asarray(fw0.astype(nd)),
            omega_dinv=jnp.asarray((omega0 * dinv0).astype(nd)),
            lmax=lmax0, plan=(), gdims=(gz, gy, gx), adims=(az, ay, ax),
            c=bs, m=m, planar=planar)
        levels.append(lv0)

        op_here = fine_op  # DiaOperator at level 0, _BLevel deeper
        lv_here = lv0
        Bc = R0
        dead = dead0
        while True:
            adims = lv_here.adims
            azc, ayc, axc = adims
            nc = azc * ayc * axc * m
            sizes.append(nc)
            # ---- probe the coarse stencil (27 colors x m comps) ------------
            t0 = time.perf_counter()
            W = _probe_stencil(lv_here, op_here, adims, m, nd)
            # exact symmetrization: Galerkin operators are symmetric, but
            # f32 probe rounding leaves ~1e-7 relative asymmetry — enough
            # to break PCG's residual recurrence silently through the
            # V-cycle (measured true_rel 1e-4 at 468k elasticity before
            # this fix; PCG requires an SPD preconditioner)
            W = _symmetrize_stencil(W)
            # rank-deficient coarse dofs are inert: zero their couplings
            # (probe rounding noise) and give them a unit diagonal
            dd = dead.reshape(azc, ayc, axc, m)
            ii = np.arange(m)
            fix = dd | (np.abs(W[1, 1, 1][..., ii, ii]) < 1e-30)
            if fix.any():
                W *= ~fix[..., :, None]
                W *= ~fix[..., None, :]
            W[1, 1, 1][..., ii, ii] = np.where(
                fix, 1.0, W[1, 1, 1][..., ii, ii])
            ph["probe"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            plan, fields = stencil_to_flat_fields(W, m)
            dc = np.ascontiguousarray(W[1, 1, 1][..., ii, ii]).reshape(-1)
            dinv_c = np.where(dc != 0, 1.0 / np.where(dc == 0, 1.0, dc), 1.0)
            ph["fields"] += time.perf_counter() - t0

            if nc <= 8 * coarse_limit or len(levels) >= max_levels - 1 \
                    or min(azc, ayc, axc) < 2:
                # ---- coarsest: SPD inverse via eigen-clipping --------------
                # plain inv is unsafe here: probe rounding (~1e-7 |A|
                # through f32 level fields) can flip the coarse
                # operator's smallest eigenvalues negative — elasticity's
                # near-nullspace modes sit exactly there — making the
                # V-cycle indefinite and PCG divergent-but-silent.
                # Clipping the spectrum at eps*lmax keeps the inverse SPD
                # and only weakens the preconditioner on noise-level
                # modes.
                t0 = time.perf_counter()
                dense = _stencil_to_dense(W, adims, m)
                dense = 0.5 * (dense + dense.T)
                evals, evecs = np.linalg.eigh(dense)
                eps = (3e-7 if np.dtype(dtype).itemsize <= 4 else 1e-13)
                floor = eps * max(float(evals.max()), 1e-300)
                evals = np.maximum(evals, floor)
                coarse_inv = jnp.asarray(
                    (evecs / evals) @ evecs.T, dtype=dtype)
                ph["coarse"] += time.perf_counter() - t0
                break

            # ---- this coarse grid becomes a full level ---------------------
            t0 = time.perf_counter()
            lam = _power_lmax_np(plan, fields, adims, m, dinv_c)
            ph["eig"] += time.perf_counter() - t0

            # next-level candidates: R factors, zeroed at dead dofs,
            # on the coarse node lattice with c = m
            Bc_lat = Bc.reshape(azc, ayc, axc, m, m)
            Bc_lat = np.where(dd[..., :, None], 0.0, Bc_lat)
            t0 = time.perf_counter()
            fwc, Rc, deadc = brick_qr(Bc_lat)
            ph["qr"] += time.perf_counter() - t0

            omega_c = damping / lam
            lvc = _BLevel(
                fields=tuple(jnp.asarray(f.astype(nd)) for f in fields),
                dinv=jnp.asarray(dinv_c.astype(nd)),
                fw=jnp.asarray(fwc.astype(nd)),
                omega_dinv=jnp.asarray((omega_c * dinv_c).astype(nd)),
                lmax=lam, plan=plan, gdims=adims,
                adims=(_ceil3(azc), _ceil3(ayc), _ceil3(axc)),
                c=m, m=m, planar=False)
            levels.append(lvc)
            op_here = lvc
            lv_here = lvc
            Bc = Rc
            dead = deadc

        out = cls(levels=levels, coarse_inv=coarse_inv,
                  smoother_degree=degree, level_sizes=sizes)
        ph["total"] = time.perf_counter() - t_total
        cls.last_phase_s = dict(ph)
        logger.info("Brick-AMG setup %.2fs: levels %s | %s",
                    ph["total"], sizes,
                    " ".join(f"{k} {v:.2f}s" for k, v in ph.items()
                             if k != "total" and v > 0.005))
        return out

    # -- V-cycle -------------------------------------------------------------
    def vcycle(self, r: jnp.ndarray, i: int = 0,
               fine_matvec: Optional[Callable] = None) -> jnp.ndarray:
        if i == len(self.levels):
            return jnp.matmul(self.coarse_inv, r)
        lv = self.levels[i]
        mv = fine_matvec if i == 0 else lv.matvec
        if mv is None:
            raise ValueError("BrickAMG.vcycle requires fine_matvec")
        smooth = chebyshev_smoother(mv, lv.dinv, lv.lmax,
                                    degree=self.smoother_degree)
        smooth0 = chebyshev_smoother_zero(mv, lv.dinv, lv.lmax,
                                          degree=self.smoother_degree)
        x, rr = smooth0(r)
        # factored smoothed transfers (la/amg.py:727-737 generalized)
        v = rr - mv(lv.omega_dinv * rr)
        rc = lv.p0t_apply(v)
        xc = self.vcycle(rc, i + 1, fine_matvec=fine_matvec)
        y = lv.p0_apply(xc)
        x = x + y - lv.omega_dinv * mv(y)
        return smooth(x, r)

    def as_preconditioner(self, fine_matvec: Callable) -> Callable:
        return lambda r: self.vcycle(r, fine_matvec=fine_matvec)

    def profile_vcycle(self, fine_op, n: int, reps: int = 10) -> dict:
        """Amortized per-stage milliseconds of one V-cycle apply (the
        bench's attribution of the V-cycle cost).

        Stages: ``smooth`` = level-0 Chebyshev pre+post sweeps;
        ``transfer`` = level-0 restrict + prolong incl. the two factored
        smoothing corrections (4 extra fine applies); ``below`` = the
        whole recursion beneath level 0; ``coarse`` = the dense coarse
        solve alone; ``total`` = one full V-cycle.  Each stage is its
        own AOT-compiled program (operators as pytree args), timed as
        the best of two passes of ``reps`` dispatches."""
        import time as _t
        from tpufem.aot import compile_aot_cached
        lv0 = self.levels[0]
        deg = self.smoother_degree
        nd = lv0.dinv.dtype
        az, ay, ax = lv0.adims
        ncoarse = az * ay * ax * lv0.m
        nbottom = self.coarse_inv.shape[0]

        def timed(tag, fn, *args):
            key = ("bramg_prof", tag, n,
                   str(jax.tree_util.tree_structure(args)),
                   tuple((x.shape, str(x.dtype))
                         for x in jax.tree_util.tree_leaves(args)))
            exe = compile_aot_cached(key, lambda: fn, *args)
            jax.block_until_ready(exe(*args))  # warm
            best = 1e30
            for _ in range(2):
                t0 = _t.perf_counter()
                outs = [exe(*args) for _ in range(reps)]
                jax.block_until_ready(outs)
                best = min(best, (_t.perf_counter() - t0) / reps)
            return round(best * 1e3, 3)

        r = jnp.ones(n, dtype=nd)
        rc = jnp.ones(ncoarse, dtype=nd)
        rb = jnp.ones(nbottom, dtype=nd)

        def st_smooth(me, op, rr):
            l0 = me.levels[0]
            x, _ = chebyshev_smoother_zero(op.apply, l0.dinv, l0.lmax,
                                           degree=me.smoother_degree)(rr)
            return chebyshev_smoother(op.apply, l0.dinv, l0.lmax,
                                      degree=me.smoother_degree)(x, rr)

        def st_transfer(me, op, rr):
            l0 = me.levels[0]
            v = rr - op.apply(l0.omega_dinv * rr)
            xc = l0.p0t_apply(v)
            y = l0.p0_apply(xc)
            return y - l0.omega_dinv * op.apply(y)

        def st_below(me, op, rcv):
            return me.vcycle(rcv, 1, fine_matvec=op.apply)

        def st_coarse(me, rbv):
            return jnp.matmul(me.coarse_inv, rbv)

        def st_total(me, op, rr):
            return me.vcycle(rr, fine_matvec=op.apply)

        out = {
            "smooth": timed("smooth", st_smooth, self, fine_op, r),
            "transfer": timed("transfer", st_transfer, self, fine_op, r),
            "below": timed("below", st_below, self, fine_op, rc),
            "coarse": timed("coarse", st_coarse, self, rb),
            "total": timed("total", st_total, self, fine_op, r),
        }
        out["smoother_degree"] = deg
        logger.info("V-cycle split (n=%d): %s", n, out)
        return out


# ---------------------------------------------------------------------------
# Probing
# ---------------------------------------------------------------------------


def _probe_stencil(lv: "_BLevel", op, adims, m: int, nd) -> np.ndarray:
    """Recover the 27-point block stencil of the Galerkin operator
    Ac = P0^T (I - w A D^-1) A (I - w D^-1 A) P0 by 3x3x3-coloring
    probes.  Returns W [3, 3, 3, az, ay, ax, m, m] (numpy float64)
    indexed by (dz+1, dy+1, dx+1).

    ``lv``/``op`` (the level's transfer data and its operator — a
    DiaOperator at level 0, a _BLevel deeper) are passed as pytree
    ARGUMENTS of the compiled probe program, not MB-scale closure
    constants embedded in it.

    Correctness requires the operator's stencil reach <= 1 on the
    aggregate lattice — guaranteed by brick size 3 >= the fine stencil
    reach (module docstring); aliasing would otherwise corrupt entries
    silently, so tests pin probe-vs-explicit equality."""
    az, ay, ax = adims
    nc = az * ay * ax * m
    is_fine = not isinstance(op, _BLevel)

    def gal(lv_, op_, xcol):
        mv = op_.apply if is_fine else op_.matvec
        w = lv_.p0_apply(xcol)              # P0 xc
        w = w - lv_.omega_dinv * mv(w)      # (I - w D^-1 A) P0 xc
        z = mv(w)                           # A P xc
        z = z - mv(lv_.omega_dinv * z)      # (I - w A D^-1) ...
        return lv_.p0t_apply(z)             # P0^T -> coarse

    # ALL 27*m probe columns in ONE lax.scan program: the column body
    # compiles once (a 27*m-wide vmap over the elasticity fine program
    # compiled pathologically slowly; scan keeps the compiled body
    # single-column) and the whole probe is ONE dispatch + ONE readback
    # instead of 27*m of each.
    def gal_all(lv_, op_, cols_):
        zi = jax.lax.broadcasted_iota(jnp.int32, (az, ay, ax), 0) % 3
        yi = jax.lax.broadcasted_iota(jnp.int32, (az, ay, ax), 1) % 3
        xi = jax.lax.broadcasted_iota(jnp.int32, (az, ay, ax), 2) % 3

        def body(_, col):
            mask = ((zi == col[0]) & (yi == col[1])
                    & (xi == col[2]))[..., None]
            onej = jnp.arange(m, dtype=jnp.int32) == col[3]
            probe = (mask & onej).astype(nd).reshape(nc)
            return None, gal(lv_, op_, probe)

        return jax.lax.scan(body, None, cols_)[1]

    import time as _time
    from tpufem.aot import compile_aot_cached
    t0 = _time.perf_counter()
    cols = np.array([(cz, cy, cx, j)
                     for cz, cy, cx in np.ndindex(3, 3, 3)
                     for j in range(m)], dtype=np.int32)  # [27m, 4]
    # process-wide memo: the probe program depends only on shapes/plan
    # aux, not the weight values (lv/op are pytree arguments), so later
    # setups of the same geometry reuse the executable.  Re-compiling it
    # each setup measured 13.2 s + 6.0 s of the 21 s warm probe phase at
    # 468k elasticity.
    key = ("bramg_probe_scan", is_fine, m, np.dtype(nd).str, adims, nc,
           # the full static structure of the inputs: any aux change
           # (plan, dims, lmax, zone tables) keys a fresh executable,
           # so a hit is exactly-reusable
           str(jax.tree_util.tree_structure((lv, op))),
           tuple(x.shape for x in jax.tree_util.tree_leaves((lv, op))))
    gal_j = compile_aot_cached(key, lambda: gal_all, lv, op,
                               jnp.asarray(cols))
    logger.info("probe program (%s, m=%d) ready in %.2fs",
                "fine" if is_fine else "lattice", m,
                _time.perf_counter() - t0)
    got = np.asarray(jax.device_get(gal_j(lv, op, jnp.asarray(cols))),
                     dtype=np.float64)  # [27*m, nc]
    Y = got.reshape(27, m, nc).transpose(0, 2, 1)  # [color, node K*i, j]
    Y = Y.reshape(27, az, ay, ax, m, m)  # [color, node K, i, probe j]

    W = np.zeros((3, 3, 3, az, ay, ax, m, m))
    # W[d][K] = Y[color == (K + d) mod 3][K]
    for pz, py, px in np.ndindex(3, 3, 3):         # node phase
        sl = (slice(pz, None, 3), slice(py, None, 3), slice(px, None, 3))
        for dz, dy, dx in np.ndindex(3, 3, 3):     # shift d - 1
            cz, cy, cx = (pz + dz - 1) % 3, (py + dy - 1) % 3, \
                (px + dx - 1) % 3
            ci = (cz * 3 + cy) * 3 + cx
            W[dz, dy, dx][sl] = Y[ci][sl]
    # out-of-range shifts carry aliased contributions when the lattice
    # has fewer than 3 nodes along an axis (the colored node wraps);
    # zero them explicitly — entries reaching outside the lattice are 0
    # by definition.
    W[0, :, :, 0] = 0.0
    W[2, :, :, -1] = 0.0
    W[:, 0, :, :, 0] = 0.0
    W[:, 2, :, :, -1] = 0.0
    W[:, :, 0, :, :, 0] = 0.0
    W[:, :, 2, :, :, -1] = 0.0
    return W


def _symmetrize_stencil(W: np.ndarray) -> np.ndarray:
    """W[d][I] <- (W[d][I] + W[-d][I + d]^T) / 2 — make the probed
    stencil an exactly symmetric operator (out-of-range partners are
    zero, matching the zeroed out-of-range entries)."""
    az, ay, ax = W.shape[3:6]
    Ws = np.zeros_like(W)
    for dzi, dyi, dxi in np.ndindex(3, 3, 3):
        dz, dy, dx = dzi - 1, dyi - 1, dxi - 1
        adj = np.zeros_like(W[dzi, dyi, dxi])
        z0, z1 = max(0, -dz), min(az, az - dz)
        y0, y1 = max(0, -dy), min(ay, ay - dy)
        x0, x1 = max(0, -dx), min(ax, ax - dx)
        adj[z0:z1, y0:y1, x0:x1] = np.swapaxes(
            W[2 - dzi, 2 - dyi, 2 - dxi][z0 + dz: z1 + dz,
                                         y0 + dy: y1 + dy,
                                         x0 + dx: x1 + dx], -1, -2)
        Ws[dzi, dyi, dxi] = 0.5 * (W[dzi, dyi, dxi] + adj)
    return Ws


def _stencil_to_dense(W: np.ndarray, adims, m: int) -> np.ndarray:
    """[3,3,3,az,ay,ax,m,m] block stencil -> dense [n, n] (host, for the
    coarsest-level inverse)."""
    az, ay, ax = adims
    n = az * ay * ax * m
    A = np.zeros((n, n))
    node = (np.arange(az)[:, None, None] * ay
            + np.arange(ay)[None, :, None]) * ax + np.arange(ax)[None, None, :]
    for dz, dy, dx in np.ndindex(3, 3, 3):
        blk = W[dz, dy, dx]  # [az, ay, ax, m, m]
        z0, z1 = max(0, 1 - dz), min(az, az + 1 - dz)
        y0, y1 = max(0, 1 - dy), min(ay, ay + 1 - dy)
        x0, x1 = max(0, 1 - dx), min(ax, ax + 1 - dx)
        src_node = node[z0 + dz - 1: z1 + dz - 1,
                        y0 + dy - 1: y1 + dy - 1,
                        x0 + dx - 1: x1 + dx - 1]
        dst_node = node[z0:z1, y0:y1, x0:x1]
        sub = blk[z0:z1, y0:y1, x0:x1]
        rows = np.broadcast_to(
            dst_node[..., None, None] * m + np.arange(m)[:, None], sub.shape)
        cols = np.broadcast_to(
            src_node[..., None, None] * m + np.arange(m)[None, :], sub.shape)
        np.add.at(A, (rows.ravel(), cols.ravel()), sub.ravel())
    return A


def _power_lmax_np(plan, fields, adims, m, dinv_c, iters: int = 20) -> float:
    """Host power iteration for lmax(D^-1 A) on a flat-field level."""
    n = dinv_c.shape[0]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv_c * flat_apply_np(plan, fields, adims, m, v)
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return lam * 1.05


def brick_viable(mesh, order: int, options) -> bool:
    """Predicate: use BrickAMG on this problem?  Structured P1 only
    (higher orders keep the generic SA path), opt-out via -amg_brick."""
    from tpufem.mesh.structured import BoxTetMesh
    if str(options.get("amg_brick", "auto")) == "off":
        return False
    return isinstance(mesh, BoxTetMesh) and order == 1
