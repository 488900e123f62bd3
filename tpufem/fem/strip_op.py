"""Channel-strip P2/P3 stencil operator: the DIA zone apply on wide rows.

The const-table DIA apply (fem/dia_op.py ``_apply_zones``) is exact and
structurally minimal, but its element passes run on typed dof grids
whose minor (x) extent is the lattice width (~27 for P3 at 517k dofs),
so every elementwise pass works on short rows.  This module evaluates
the SAME matrix with the SAME zone decomposition on a channel-resident
layout:

- every (kind, slot) typed grid becomes one channel ``c`` of a buffer
  ``[C, Zp, LW]``: per channel, z-planes are rows and the zero-padded
  (y, x)-flattened plane (plus a 128-entry guard) is the minor axis, so
  every lattice shift (dx, dy, dz) is (row offset dz, column offset
  dy * Xp + dx) and every slice is a long contiguous row;
- each DIA term's weight field is stored as z-zone strips (lo [3, TILE],
  mid [1, TILE] broadcast along z, hi [3, TILE], or a full [Zk, TILE]
  strip for short grids), exactly the decomposition
  ``DiaOperator._build_zones_np`` uses: the clamp maps are identity
  within 3 planes of each z end and constant between, so the mid strip
  captures ALL in-plane (y, x) weight variation with O(plane) weight
  bytes;
- the apply is the identical bag of shifted-slice multiply-adds, fused
  by XLA into one elementwise pass per (channel, zone) output block:
  no gathers, no matmuls, no correction terms.

Parity: this is the reference's assembled cube-path operator
(src/poisson_problem.cpp:117-141; matrix-free action call site
src/cgpoisson_problem.cpp:193-204), built FROM the verified
DiaOperator tables and pinned equal to ``DiaOperator.apply_np`` in
tests/test_strip_op.py, including end-to-end CG solves.

The CG loop runs channel-resident (``to_strips`` once per solve,
``apply_strips`` per iteration): pad/guard entries and out-of-extent
rows are EXACTLY zero in every strip, so the operator output stays
clean-padded and dofwise dot products equal buffer dot products
throughout the Krylov iteration.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.fem.dia_op import DiaOperator

_GUARD = 128  # left guard >= max |in-plane shift| (|dy| * Xp + |dx|)
_M = 3        # z-zone shell width (dia_op._SHELL + 1)


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class StripOperator:
    """Channel-strip const-stencil matrix (scalar P2/P3 cube path)."""

    strips: Tuple[jnp.ndarray, ...]  # per term: [Zk, TILE] full or
    #                                  lo [3, TILE] / mid [1, TILE] /
    #                                  hi [3, TILE] (see plan)
    plan: Tuple                      # static per-term metadata
    meta: Tuple                      # static geometry bundle

    def tree_flatten(self):
        return (self.strips,), (self.plan, self.meta)

    @classmethod
    def tree_unflatten(cls, aux, children):
        plan, meta = aux
        return cls(children[0], plan, meta)

    # geometry accessors -----------------------------------------------------
    @property
    def layout(self):
        return self.meta[0]

    @property
    def channels(self):
        return self.meta[1]  # tuple of (kind, slot)

    @property
    def kdims(self):
        return self.meta[2]  # per-KIND (Z, Y, X)

    @property
    def dims(self):
        return self.meta[3]  # (C, Zc, Yp, Xp, PF, TILE, LW, Zp)

    @property
    def bc_mask(self):
        """Flat BC mask of the underlying matrix (multigrid filtering)."""
        return self.meta[4]

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_dia(cls, dia: DiaOperator, dtype=jnp.float32
                 ) -> Optional["StripOperator"]:
        """Build from a const-mode scalar DiaOperator, or None when the
        structure does not fit (bs > 1, non-const, or in-plane shifts
        beyond the guard)."""
        if dia.bs != 1 or not dia.is_const():
            return None
        lay = dia.layout
        channels = []
        kdims = []
        for kind, (base, (X, Y, Z), s) in enumerate(lay.kinds):
            for slot in range(s):
                channels.append((kind, slot))
            kdims.append((Z, Y, X))
        C = len(channels)
        chan_of = {ks: c for c, ks in enumerate(channels)}
        Zc = max(d[0] for d in kdims)
        Yc = max(d[1] for d in kdims)
        Xc = max(d[2] for d in kdims)
        Yp, Xp = Yc + 2, Xc + 2
        if any(abs(d[4][1]) * Xp + abs(d[4][0]) > _GUARD
               or abs(d[4][2]) > 1 for d in dia.plan):
            return None
        PF = Yp * Xp
        TILE = _rup(PF, 128)
        LW = _GUARD + TILE + 128
        Zp = Zc + 2
        npdt = np.dtype(dtype)

        plan: List[Tuple] = []
        strips: List[np.ndarray] = []
        for term_meta, T in dia.terms():
            (ko, so, ki, si, d, (z0, z1, y0, y1, x0, x1), _c) = term_meta
            co = chan_of[(ko, so)]
            ci = chan_of[(ki, si)]
            Zk, Yk, Xk = kdims[ko]
            off = d[1] * Xp + d[0]
            # full dst-grid weight field, zero outside the slice bounds
            # (exactly dia._dense_weight_np's reconstruction)
            F = np.zeros((Zk, Yk, Xk))
            F[z0:z1, y0:y1, x0:x1] = dia._dense_weight_np(term_meta, T)
            if not F.any():
                continue

            def embed(planes: np.ndarray) -> np.ndarray:
                """[nz, Yk, Xk] -> strips [nz, TILE] at (1 + y, 1 + x)."""
                nz = planes.shape[0]
                canvas = np.zeros((nz, Yp, Xp))
                canvas[:, 1:1 + Yk, 1:1 + Xk] = planes
                out = np.zeros((nz, TILE), dtype=npdt)
                out[:, :PF] = canvas.reshape(nz, PF)
                return out

            if Zk >= 2 * _M + 1:
                # mid-zone constancy in z is guaranteed by the clamp-map
                # structure; assert it at build so a violation can never
                # produce a silently wrong operator
                mid = F[_M: Zk - _M]
                if not (mid == mid[:1]).all():
                    return None
                plan.append((co, ci, d[2], off, Zk, "zones"))
                strips.append(embed(F[:_M]))
                strips.append(embed(F[_M: _M + 1]))
                strips.append(embed(F[Zk - _M:]))
            else:
                plan.append((co, ci, d[2], off, Zk, "full"))
                strips.append(embed(F))

        meta = (lay, tuple(channels), tuple(kdims),
                (C, Zc, Yp, Xp, PF, TILE, LW, Zp), np.asarray(dia.bc_mask))
        return cls(strips=tuple(jnp.asarray(s) for s in strips),
                   plan=tuple(plan), meta=meta)

    # -- layout conversion ------------------------------------------------------
    def to_strips(self, u: jnp.ndarray) -> jnp.ndarray:
        """[ndofs] -> [C, Zp, LW] zero-padded channel buffer (once per
        solve; the CG loop stays channel-resident)."""
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        dt = self.strips[0].dtype
        canvas = jnp.zeros((C, Zp, Yp, Xp), dtype=dt)
        grids = self.layout.split(u.astype(dt).reshape(-1, 1))
        for c, (kind, slot) in enumerate(self.channels):
            Zk, Yk, Xk = self.kdims[kind]
            gr = grids[kind][..., slot, 0]
            canvas = canvas.at[c, 1:1 + Zk, 1:1 + Yk, 1:1 + Xk].set(gr)
        flat = canvas.reshape(C, Zp, PF)
        return jnp.pad(flat, ((0, 0), (0, 0),
                              (_GUARD, LW - _GUARD - PF)))

    def from_strips(self, yb: jnp.ndarray, dtype=None) -> jnp.ndarray:
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        view = yb[:, :, _GUARD:_GUARD + PF].reshape(C, Zp, Yp, Xp)
        chan_of = {ks: c for c, ks in enumerate(self.channels)}
        outs = []
        for kind, (base, (X, Y, Z), s) in enumerate(self.layout.kinds):
            cols = [view[chan_of[(kind, slot)], 1:1 + Z, 1:1 + Y, 1:1 + X]
                    for slot in range(s)]
            if s == 1:
                outs.append(cols[0].reshape(-1))
            else:
                outs.append(jnp.stack(cols, axis=-1).reshape(-1))
        y = jnp.concatenate(outs)
        return y.astype(dtype) if dtype is not None else y

    # -- apply ------------------------------------------------------------------
    def apply_strips(self, x: jnp.ndarray) -> jnp.ndarray:
        """[C, Zp, LW] -> [C, Zp, LW]: fused-slice zone apply.

        Structure mirrors DiaOperator._apply_zones: per output channel
        the z-lo / z-mid / z-hi zone accumulators collect every term's
        shifted-slice multiply-add and XLA fuses each zone into a single
        elementwise pass; the mid strip is [1, TILE] broadcast along z,
        so weight traffic is O(plane) while all in-plane (y, x) weight
        variation is exact."""
        C, Zc, Yp, Xp, PF, TILE, LW, Zp = self.dims
        m = _M
        acc = {}  # co -> list of zone accumulators
        widx = 0
        src_cache = {}
        for (co, ci, dz, off, Zk, mode) in self.plan:
            def src(z0, z1, ci=ci, dz=dz, off=off):
                key = (ci, z0 + dz, z1 + dz, off)
                got = src_cache.get(key)
                if got is None:
                    got = x[ci, 1 + z0 + dz: 1 + z1 + dz,
                            _GUARD + off: _GUARD + off + TILE]
                    src_cache[key] = got
                return got

            if mode == "zones":
                lo, mid, hi = (self.strips[widx], self.strips[widx + 1],
                               self.strips[widx + 2])
                widx += 3
                parts = (lo * src(0, m), mid * src(m, Zk - m),
                         hi * src(Zk - m, Zk))
            else:
                full = self.strips[widx]
                widx += 1
                parts = (full * src(0, Zk),)
            a = acc.get(co)
            if a is None:
                acc[co] = list(parts)
            else:
                acc[co] = [u + v for u, v in zip(a, parts)]

        dt = x.dtype
        outs = []
        for c in range(C):
            Zk = self.kdims[self.channels[c][0]][0]
            a = acc.get(c)
            body = (jnp.zeros((Zk, TILE), dtype=dt) if a is None
                    else (a[0] if len(a) == 1
                          else jnp.concatenate(a, axis=0)))
            col = jnp.pad(body, ((1, Zp - 1 - Zk), (0, 0)))
            outs.append(col)
        y = jnp.stack(outs)
        return jnp.pad(y, ((0, 0), (0, 0), (_GUARD, LW - _GUARD - TILE)))

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        """DiaOperator-compatible flat-dof-vector apply (tests / drop-in
        use; production CG runs channel-resident via apply_strips)."""
        return self.from_strips(self.apply_strips(self.to_strips(u)),
                                dtype=u.dtype)
