"""Flat-channel P2/P3 stencil operator: one matrix product per z-plane
+ thin slab corrections.

The const-table DIA apply (fem/dia_op.py) evaluates the P3 operator as
~3900 small shifted-slice multiply-adds.  This module reorganizes the
SAME matrix around dense contractions:

- every (kind, slot) typed dof grid becomes one CHANNEL of a common
  zero-padded plane buffer ``[Zp, CP, LW]``: leading dim = z-plane,
  then channels (padded to a multiple of 8), then the (y, x)-flattened
  plane with an in-plane halo ring and a 128-entry guard, so EVERY
  lattice shift (dx, dy, dz) with |d|_inf <= 1 is (plane offset dz,
  column offset dy*Xp + dx);
- the interior action is ONE matrix product per plane: the 15 shifted
  source blocks are stacked along the contraction axis and multiplied
  by the stacked interior weight matrix;
- ALL pure-z weight variation (grid truncation + Dirichlet planes,
  confined to <= 3 planes per end) is folded into per-boundary-plane
  weight-delta matrices added to the interior weights of those planes;
- the remaining deviation field of every term decomposes EXACTLY by
  inclusion-exclusion over its clamp table (see fem/conv_op.py:28-37)
  into y/x face profiles, zy/zx/yx edge cross terms and a corner
  residual, each supported within 3 planes of the axis ends; they are
  applied as six stacked slab einsums (O(surface) data) and summed into
  the interior output under one fused final-mask pass.

Parity: this is the reference's assembled operator on the cube path
(src/poisson_problem.cpp:117-141; matrix-free action call site
src/cgpoisson_problem.cpp:193-204) — built FROM the verified
DiaOperator tables and pinned equal to its apply_np in
tests/test_flat_op.py.

Opt-in (`-use_flat 1` via cgpoisson); the fused-slice DIA/strip forms
are the default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.fem.dia_op import DiaOperator

_GUARD = 128   # left guard >= max |in-plane shift| (dy*Xp + dx)
_W = 3         # deviation width per axis end (clamp-map shell)


def _rup(v: int, m: int) -> int:
    return -(-v // m) * m


class _Geom:
    """Static geometry bundle (hashable tuple-backed)."""

    __slots__ = ("C", "CP", "D", "shifts", "Zc", "Yc", "Xc", "Yp", "Xp",
                 "PF", "TILE", "LW", "KP", "ZB", "Zp", "K", "PZ", "NS",
                 "kdims")

    def __init__(self, *vals):
        for name, v in zip(self.__slots__, vals):
            object.__setattr__(self, name, v)

    def __setattr__(self, *a):  # pragma: no cover
        raise AttributeError("frozen")


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FlatOperator:
    """Channel-flattened const-stencil matrix (scalar P2/P3)."""

    W0: jnp.ndarray        # [CP, K] stacked interior weights
    AZT: jnp.ndarray       # [NZP, CP, K] per-boundary-plane deltas
    slot_of: jnp.ndarray   # [1, ZB] int32: plane -> AZT slot or -1
    TY: jnp.ndarray        # [D, C, C, NS] y-face profiles
    TX: jnp.ndarray        # [D, C, C, NS] x-face profiles
    BYZ: jnp.ndarray       # [D, C, C, NZP, NS] (z, y) edge terms
    BZX: jnp.ndarray       # [D, C, C, NZP, NS] (z, x)
    BYX: jnp.ndarray       # [D, C, C, NS, NS] (y, x)
    CC: jnp.ndarray        # [D, C, C, NZP, NS, NS] corner residual
    fmask: jnp.ndarray     # [Zp, CP, LW] channel-extent mask
    meta: Tuple            # static (geometry, channels, layout)

    def tree_flatten(self):
        return ((self.W0, self.AZT, self.slot_of, self.TY, self.TX,
                 self.BYZ, self.BZX, self.BYX, self.CC, self.fmask),
                self.meta)

    @classmethod
    def tree_unflatten(cls, meta, children):
        return cls(*children, meta=meta)

    @property
    def _g(self) -> _Geom:
        return _Geom(*self.meta[0])

    @property
    def channels(self):
        return self.meta[1]

    @property
    def layout(self):
        return self.meta[2]

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_dia(cls, dia: DiaOperator) -> Optional["FlatOperator"]:
        """Build from a const-mode scalar DiaOperator, or None when the
        structure does not fit (non-unit shifts, tiny grids, bs > 1)."""
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
        if min(min(d) for d in kdims) < 2 * _W + 2:
            return None

        shifts = sorted({m[4] for m in dia.plan})
        if any(max(abs(c) for c in d) > 1 for d in shifts):
            return None
        D = len(shifts)
        dslot = {d: j for j, d in enumerate(shifts)}

        CP = _rup(C, 8)
        Yp, Xp = Yc + 2, Xc + 2
        PF = Yp * Xp
        TILE = _rup(PF, 128)
        LW = _GUARD + TILE + 128
        KP = 2
        ZB = _rup(Zc, KP)
        Zp = ZB + 2
        K = D * CP
        PZ = sorted({0, 1, 2, Zc - 4, Zc - 3, Zc - 2, Zc - 1})
        NZP = len(PZ)
        NS = 2 * _W + 1  # per-axis slab slots: _W lo + (_W + 1) hi

        W0 = np.zeros((CP, K), dtype=np.float32)
        AZT = np.zeros((NZP, CP, K), dtype=np.float32)
        TY = np.zeros((D, C, C, NS), dtype=np.float32)
        TX = np.zeros((D, C, C, NS), dtype=np.float32)
        BYZ = np.zeros((D, C, C, NZP, NS), dtype=np.float32)
        BZX = np.zeros((D, C, C, NZP, NS), dtype=np.float32)
        BYX = np.zeros((D, C, C, NS, NS), dtype=np.float32)
        CC = np.zeros((D, C, C, NZP, NS, NS), dtype=np.float32)

        for (ko, so, ki, si, d, _b, _c), T in dia.terms():
            co = chan_of[(ko, so)]
            ci = chan_of[(ki, si)]
            j = dslot[d]
            Zk, Yk, Xk = kdims[ko]
            qz, qy, qx = dia._clamp_maps_np(ko)
            Tn = np.asarray(T, dtype=np.float64)
            mz, my, mx = qz[Zk // 2], qy[Yk // 2], qx[Xk // 2]
            w0 = Tn[mz, my, mx]
            Az = Tn[qz, my, mx] - w0                      # [Zk]
            Ay = Tn[mz, qy, mx] - w0                      # [Yk]
            Ax = Tn[mz, my, qx] - w0                      # [Xk]
            W0[co, j * CP + ci] = w0
            for s_, p in enumerate(PZ):
                if p < Zk:
                    AZT[s_, co, j * CP + ci] = Az[p]
            # slab slot -> real axis index (hi slots anchored at the
            # COMMON hi window; per-channel short axes leave unused
            # slots at 0 and invalid rows are masked by fmask)
            ys = ([(s_, s_) for s_ in range(_W)]
                  + [(_W + t, Yc - 1 - _W + t) for t in range(_W + 1)])
            xs = ([(s_, s_) for s_ in range(_W)]
                  + [(_W + t, Xc - 1 - _W + t) for t in range(_W + 1)])
            zs = list(enumerate(PZ))
            for sy, y in ys:
                if 0 <= y < Yk:
                    TY[j, co, ci, sy] = Ay[y]
            for sx, x in xs:
                if 0 <= x < Xk:
                    TX[j, co, ci, sx] = Ax[x]
            for sz, z in zs:
                if not (0 <= z < Zk):
                    continue
                for sy, y in ys:
                    if 0 <= y < Yk:
                        BYZ[j, co, ci, sz, sy] = (
                            Tn[qz[z], qy[y], mx] - w0 - Az[z] - Ay[y])
                for sx, x in xs:
                    if 0 <= x < Xk:
                        BZX[j, co, ci, sz, sx] = (
                            Tn[qz[z], my, qx[x]] - w0 - Az[z] - Ax[x])
            for sy, y in ys:
                if not (0 <= y < Yk):
                    continue
                for sx, x in xs:
                    if 0 <= x < Xk:
                        BYX[j, co, ci, sy, sx] = (
                            Tn[mz, qy[y], qx[x]] - w0 - Ay[y] - Ax[x])
            for sz, z in zs:
                if not (0 <= z < Zk):
                    continue
                for sy, y in ys:
                    if not (0 <= y < Yk):
                        continue
                    for sx, x in xs:
                        if 0 <= x < Xk:
                            CC[j, co, ci, sz, sy, sx] = (
                                Tn[qz[z], qy[y], qx[x]] - w0
                                - Az[z] - Ay[y] - Ax[x]
                                - BYZ[j, co, ci, sz, sy]
                                - BZX[j, co, ci, sz, sx]
                                - BYX[j, co, ci, sy, sx])

        slot_arr = np.full((1, ZB), -1, dtype=np.int32)
        for s_, p in enumerate(PZ):
            slot_arr[0, p] = s_

        fmask = np.zeros((Zp, CP, LW), dtype=np.float32)
        for c, (kind, slot) in enumerate(channels):
            Zk, Yk, Xk = kdims[kind]
            for y in range(Yk):
                r0 = _GUARD + (1 + y) * Xp + 1
                fmask[1:1 + Zk, c, r0:r0 + Xk] = 1.0

        geom = (C, CP, D, tuple(shifts), Zc, Yc, Xc, Yp, Xp, PF, TILE,
                LW, KP, ZB, Zp, K, tuple(PZ), NS, tuple(kdims))
        meta = (geom, tuple(channels), lay)
        return cls(W0=jnp.asarray(W0), AZT=jnp.asarray(AZT),
                   slot_of=jnp.asarray(slot_arr), TY=jnp.asarray(TY),
                   TX=jnp.asarray(TX), BYZ=jnp.asarray(BYZ),
                   BZX=jnp.asarray(BZX), BYX=jnp.asarray(BYX),
                   CC=jnp.asarray(CC), fmask=jnp.asarray(fmask),
                   meta=meta)

    # -- layout conversion ------------------------------------------------------
    def to_flat(self, u: jnp.ndarray) -> jnp.ndarray:
        """[ndofs] -> [Zp, CP, LW] zero-padded channel buffer (once per
        solve; the CG loop stays channel-resident)."""
        g = self._g
        canvas = jnp.zeros((g.Zp, g.CP, g.Yp, g.Xp), dtype=jnp.float32)
        grids = self.layout.split(u.astype(jnp.float32).reshape(-1, 1))
        for c, (kind, slot) in enumerate(self.channels):
            Zk, Yk, Xk = g.kdims[kind]
            gr = grids[kind][..., slot, 0]
            canvas = canvas.at[1:1 + Zk, c, 1:1 + Yk, 1:1 + Xk].set(gr)
        flat = canvas.reshape(g.Zp, g.CP, g.PF)
        return jnp.pad(flat, ((0, 0), (0, 0),
                              (_GUARD, g.LW - _GUARD - g.PF)))

    def from_flat(self, yf: jnp.ndarray) -> jnp.ndarray:
        g = self._g
        view = yf[:, :, _GUARD:_GUARD + g.PF].reshape(
            g.Zp, g.CP, g.Yp, g.Xp)
        chan_of = {ks: c for c, ks in enumerate(self.channels)}
        outs = []
        for kind, (base, (X, Y, Z), s) in enumerate(self.layout.kinds):
            cols = [view[1:1 + Z, chan_of[(kind, slot)], 1:1 + Y, 1:1 + X]
                    for slot in range(s)]
            if s == 1:
                outs.append(cols[0].reshape(-1))
            else:
                outs.append(jnp.stack(cols, axis=-1).reshape(-1))
        return jnp.concatenate(outs)

    # -- apply ------------------------------------------------------------------
    def apply_flat(self, x: jnp.ndarray) -> jnp.ndarray:
        return (self._interior(x) + self._corrections(x)) * self.fmask

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        """DiaOperator-compatible flat-dof-vector apply (tests / drop-in
        use; production CG runs channel-resident via apply_flat)."""
        return self.from_flat(self.apply_flat(self.to_flat(u))).astype(
            u.dtype)

    # -- interior -------------------------------------------------------------
    def _interior(self, x: jnp.ndarray) -> jnp.ndarray:
        g = self._g
        xv = x[:, :, _GUARD:_GUARD + g.PF].reshape(g.Zp, g.CP, g.Yp, g.Xp)
        slot = self.slot_of[0, :g.Zc]
        WT = jnp.broadcast_to(self.W0, (g.Zc,) + self.W0.shape)
        WT = WT + jnp.where((slot >= 0)[:, None, None],
                            self.AZT[jnp.clip(slot, 0)], 0.0)
        SH = self._shift_stack(xv)                    # [D, Zc, CP, Yc, Xc]
        SHK = jnp.concatenate([SH[j] for j in range(g.D)], axis=1)
        y4 = jnp.einsum("zok,zkyx->zoyx", WT, SHK)
        canvas = jnp.zeros((g.Zp, g.CP, g.Yp, g.Xp), dtype=jnp.float32)
        canvas = canvas.at[1:1 + g.Zc, :, 1:1 + g.Yc, 1:1 + g.Xc].set(y4)
        flat = canvas.reshape(g.Zp, g.CP, g.PF)
        return jnp.pad(flat, ((0, 0), (0, 0),
                              (_GUARD, g.LW - _GUARD - g.PF)))

    def _shift_stack(self, xv: jnp.ndarray) -> jnp.ndarray:
        """SH[d, z, i, y, x] = x[i] at (z + dz, y + dy, x + dx)."""
        g = self._g
        return jnp.stack([
            xv[1 + dz:1 + dz + g.Zc, :, 1 + dy:1 + dy + g.Yc,
               1 + dx:1 + dx + g.Xc]
            for (dx, dy, dz) in g.shifts])

    # -- slab corrections ---------------------------------------------------------
    def _corrections(self, x: jnp.ndarray) -> jnp.ndarray:
        """Face/edge/corner deviation terms as six stacked slab einsums.

        Sources are sliced DIRECTLY from the plane buffer per shift and
        slab (O(surface) bytes); results are summed into a full-size
        canvas through jnp.pad (XLA fuses the pads into one output
        loop — the earlier .at[].add chain materialized ~24 full-buffer
        copies and dominated the apply)."""
        g = self._g
        C, w = g.C, _W
        xv = x[:, :, _GUARD:_GUARD + g.PF].reshape(
            g.Zp, g.CP, g.Yp, g.Xp)[:, :C]
        pzlo = [p for p in g.PZ if p < w]
        pzhi = [p for p in g.PZ if p >= w]
        nlo, nhi = len(pzlo), len(pzhi)
        YS = ((0, w), (g.Yc - 1 - w, w + 1))
        XS = ((0, w), (g.Xc - 1 - w, w + 1))
        ZS = ((pzlo[0], nlo), (pzhi[0], nhi))

        def sh(d, zs=None, ys=None, xs=None):
            """dst-restricted slab of the d-shifted source view."""
            dx, dy, dz = d
            zb = zs or ((0, g.Zc),)
            yb = ys or ((0, g.Yc),)
            xb = xs or ((0, g.Xc),)
            zparts = []
            for z0, zl in zb:
                yparts = []
                for y0, yl in yb:
                    xparts = [xv[1 + dz + z0:1 + dz + z0 + zl, :,
                                 1 + dy + y0:1 + dy + y0 + yl,
                                 1 + dx + x0:1 + dx + x0 + xl]
                              for x0, xl in xb]
                    yparts.append(xparts[0] if len(xparts) == 1
                                  else jnp.concatenate(xparts, axis=3))
                zparts.append(yparts[0] if len(yparts) == 1
                              else jnp.concatenate(yparts, axis=2))
            return (zparts[0] if len(zparts) == 1
                    else jnp.concatenate(zparts, axis=0))

        D_ = g.shifts
        SY = jnp.stack([sh(d, ys=YS) for d in D_])    # [D, Zc, C, NS, Xc]
        SX = jnp.stack([sh(d, xs=XS) for d in D_])    # [D, Zc, C, Yc, NS]
        SZY = jnp.stack([sh(d, zs=ZS, ys=YS) for d in D_])
        SZX = jnp.stack([sh(d, zs=ZS, xs=XS) for d in D_])
        SYX = jnp.stack([sh(d, ys=YS, xs=XS) for d in D_])
        SZYX = jnp.stack([sh(d, zs=ZS, ys=YS, xs=XS) for d in D_])

        cy = jnp.einsum("doia,dziax->zoax", self.TY, SY)
        cx = jnp.einsum("doia,dziya->zoya", self.TX, SX)
        czy = jnp.einsum("doipa,dpiax->poax", self.BYZ, SZY)              # [NZP, C, NS, Xc]
        czx = jnp.einsum("doipa,dpiya->poya", self.BZX, SZX)              # [NZP, C, Yc, NS]
        cyx = jnp.einsum("doiab,dziab->zoab", self.BYX, SYX)              # [Zc, C, NS, NS]
        ccc = jnp.einsum("doipab,dpiab->poab", self.CC, SZYX)              # [NZP, C, NS, NS]

        def pads(block, z0, y0, x0):
            """zero-pad [nz, C, ny, nx] into [Zp, CP, Yp, Xp] at
            (1 + z0 dst planes, channel 0, 1 + y0, 1 + x0)."""
            nz, _, ny, nx = block.shape
            return jnp.pad(block, (
                (1 + z0, g.Zp - 1 - z0 - nz), (0, g.CP - C),
                (1 + y0, g.Yp - 1 - y0 - ny),
                (1 + x0, g.Xp - 1 - x0 - nx)))

        def ysplit(arr, axis):
            lo = [slice(None)] * arr.ndim
            hi = [slice(None)] * arr.ndim
            lo[axis] = slice(0, w)
            hi[axis] = slice(w, 2 * w + 1)
            return ((YS[0][0], arr[tuple(lo)]), (YS[1][0], arr[tuple(hi)]))

        def xsplit(arr, axis):
            lo = [slice(None)] * arr.ndim
            hi = [slice(None)] * arr.ndim
            lo[axis] = slice(0, w)
            hi[axis] = slice(w, 2 * w + 1)
            return ((XS[0][0], arr[tuple(lo)]), (XS[1][0], arr[tuple(hi)]))

        def zsplit(arr):
            return ((ZS[0][0], arr[:nlo]), (ZS[1][0], arr[nlo:]))

        total = None
        for y0, blk in ysplit(cy, 2):
            total = _acc(total, pads(blk, 0, y0, 0))
        for x0, blk in xsplit(cx, 3):
            total = _acc(total, pads(blk, 0, 0, x0))
        for z0, zblk in zsplit(czy):
            for y0, blk in ysplit(zblk, 2):
                total = _acc(total, pads(blk, z0, y0, 0))
        for z0, zblk in zsplit(czx):
            for x0, blk in xsplit(zblk, 3):
                total = _acc(total, pads(blk, z0, 0, x0))
        for y0, yblk in ysplit(cyx, 2):
            for x0, blk in xsplit(yblk, 3):
                total = _acc(total, pads(blk, 0, y0, x0))
        for z0, zblk in zsplit(ccc):
            for y0, yblk in ysplit(zblk, 2):
                for x0, blk in xsplit(yblk, 3):
                    total = _acc(total, pads(blk, z0, y0, x0))

        flat = total.reshape(g.Zp, g.CP, g.PF)
        return jnp.pad(flat, ((0, 0), (0, 0),
                              (_GUARD, g.LW - _GUARD - g.PF)))


def _acc(total, piece):
    return piece if total is None else total + piece
