"""High-order lattice operator as a channel convolution.

The const-table DIA operator (fem/dia_op.py) evaluates P2/P3 applies as
~1300 scalar-weighted shifted-slice passes.  This module maps the SAME
matrix onto dense contractions: every cube of the lattice owns exactly
one entity of each (kind, slot) pair (P2 scalar: 8, P3 scalar: 27), so
the dof vector reshapes into a dense channel tensor ``[Gz, Gy, Gx, C]``
over cube anchors, and the interior of the operator is ONE 3x3x3
channel convolution ``[C -> C]``.

Opt-in (-use_conv) as a compile-size escape hatch: its HLO is ~27 dense
ops where the fused-slice DIA form has ~1300 slices.  The fused-slice
form stays the default.

Boundary exactness.  Near the lattice faces the weights deviate from
the interior constants (grid truncation + baked Dirichlet elimination).
The deviation field of every term is, exactly, a sum of per-axis
profiles supported within 3 planes of each axis end (the same
shell-representability the const-table build verifies), so the full
operator decomposes additively by inclusion-exclusion:

  W(z,y,x) = c  +  fz(z) + fy(y) + fx(x)            (face profiles)
           + fzy(z,y) + fzx(z,x) + fyx(y,x)         (edge cross terms)
           + fzyx(z,y,x)                            (corner residual)

with each f* extracted numerically from the term's surrogate lookup
table (c at the mid index, faces along the mid axes, cross terms by
inclusion-exclusion).  The apply is then

  bulk 3^3 conv  +  6 face contractions (3-4 planes each)
                 +  12 edge contractions (thin pencils)
                 +  8 corner contractions (tiny blocks)

— 27 dense einsum/conv ops total, O(surface) extra traffic, and a
compact HLO (no per-term slicing).  Products run at the package's one
matmul precision (tpufem.aot).

Parity: this is the reference's assembled operator on the cube path
(src/poisson_problem.cpp:117-141 builds it with FFCx kernels; here the
matrix IS the translation-invariant stencil, reorganized as a
convolution).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.fem.dia_op import DiaOperator

_M = 3           # per-axis correction shell planes at the LO end
_MH = 4          # HI-end window in common coords (kind dims differ by 1)


def _axis_windows(G: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((lo0, lo1), (hi0, hi1)) common-coordinate plane windows."""
    return (0, _M), (G - _MH, G)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ConvStencilOp:
    """Channel-conv form of a const-mode scalar DiaOperator.

    Exposes the same apply contract (``apply`` = baked-BC operator,
    ``apply_bc_rows_zero`` = rows-zero convention) over the flat dof
    vector; construction is host-side numpy from the DIA surrogate
    tables.  Kernels ride as pytree leaves (never baked into the HLO).
    """

    Kc: jnp.ndarray            # [3,3,3,C,C] bulk kernel
    Kfaces: Tuple              # 6 x [W, 27, C, C]  (z-lo, z-hi, y-lo, ...)
    Kedges: Tuple              # 12 x [Wa, Wb, 27, C, C]
    Kcorners: Tuple            # 8 x [Wz, Wy, Wx, 27, C, C]
    bc_mask: jnp.ndarray       # flat [ndofs] bool
    layout: object             # GridLayout (static)
    gdims: Tuple[int, int, int]  # (Gz, Gy, Gx) common channel grid (static)
    chan_mask: Optional[jnp.ndarray] = None  # [Gz,Gy,Gx,C] 1.0 on real
    #                            dofs, 0.0 on phantom channel entries
    #                            (kind grids one plane short of G*) —
    #                            keeps the channel-resident CG state's
    #                            phantom-zero invariant (apply_channels)

    def tree_flatten(self):
        return ((self.Kc, self.Kfaces, self.Kedges, self.Kcorners,
                 self.bc_mask, self.chan_mask),
                (self.layout, self.gdims))

    @classmethod
    def tree_unflatten(cls, aux, children):
        Kc, Kf, Ke, Kco, bc, cm = children
        layout, gdims = aux
        return cls(Kc, Kf, Ke, Kco, bc, layout, gdims, cm)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dia(cls, dia: DiaOperator, dtype=jnp.float32
                 ) -> "ConvStencilOp":
        """Build from a const-mode scalar DiaOperator (raises ValueError
        otherwise).  All kernel extraction is numpy on the host."""
        if dia.bs != 1:
            raise ValueError("ConvStencilOp is scalar-only (bs=1)")
        if not dia.is_const():
            raise ValueError("ConvStencilOp requires a const-mode operator")
        lay = dia.layout
        kinds = lay.kinds
        # channel map: kinds in layout order, slots within a kind
        chan_base = []
        C = 0
        for _b, _dims, s in kinds:
            chan_base.append(C)
            C += s
        rdims = [(k[1][2], k[1][1], k[1][0]) for k in kinds]  # (Z, Y, X)
        Gz = max(d[0] for d in rdims)
        Gy = max(d[1] for d in rdims)
        Gx = max(d[2] for d in rdims)
        for (Zk, Yk, Xk) in rdims:
            if Gz - Zk > 1 or Gy - Yk > 1 or Gx - Xk > 1:
                raise ValueError("kind grids differ by more than one plane")
        if min(Gz, Gy, Gx) < _M + _MH:
            raise ValueError("lattice too small for the boundary windows")

        (zl0, zl1), (zh0, zh1) = _axis_windows(Gz)
        (yl0, yl1), (yh0, yh1) = _axis_windows(Gy)
        (xl0, xl1), (xh0, xh1) = _axis_windows(Gx)

        Kc = np.zeros((3, 3, 3, C, C))
        # face kernels: [W, 27, C, C] — W output planes in the window
        face_shapes = [ _M, _MH, _M, _MH, _M, _MH ]  # zlo,zhi,ylo,yhi,xlo,xhi
        Kfaces = [np.zeros((w, 27, C, C)) for w in face_shapes]
        # edges: axis pairs (z,y), (z,x), (y,x) x (lo/hi, lo/hi)
        edge_specs = []
        for ai, aj in ((0, 1), (0, 2), (1, 2)):
            for ei in (0, 1):
                for ej in (0, 1):
                    edge_specs.append((ai, aj, ei, ej))
        Wof = lambda e: _MH if e else _M
        Kedges = [np.zeros((Wof(ei), Wof(ej), 27, C, C))
                  for (_ai, _aj, ei, ej) in edge_specs]
        corner_specs = [(ez, ey, ex) for ez in (0, 1) for ey in (0, 1)
                        for ex in (0, 1)]
        Kcorners = [np.zeros((Wof(ez), Wof(ey), Wof(ex), 27, C, C))
                    for (ez, ey, ex) in corner_specs]

        for (ko, so, ki, si, d, _bounds, tag), T in dia.terms():
            if tag != "table":
                raise ValueError("mixed const/dense operator")
            co = chan_base[ko] + so
            ci = chan_base[ki] + si
            dx, dy, dz = d
            tap = ((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)
            T = np.asarray(T, dtype=np.float64)
            Zs, Ys, Xs = T.shape
            mz, my, mx = Zs // 2, Ys // 2, Xs // 2
            Zo, Yo, Xo = rdims[ko]
            c0 = T[mz, my, mx]
            Kc[dz + 1, dy + 1, dx + 1, ci, co] += c0

            # surrogate index + common-window position for each axis/end
            def planes(Ls_, Lr_, G_, end):
                # [(surrogate idx, window pos)] for this kind/axis/end
                if end == 0:
                    return [(p, p) for p in range(_M)]
                off = _MH - (G_ - Lr_) - _M   # window pos of kind plane 0
                return [(Ls_ - _M + j, off + j) for j in range(_M)]

            zpl = [planes(Zs, Zo, Gz, e) for e in (0, 1)]
            ypl = [planes(Ys, Yo, Gy, e) for e in (0, 1)]
            xpl = [planes(Xs, Xo, Gx, e) for e in (0, 1)]

            fz = {}
            fy = {}
            fx = {}
            for e in (0, 1):
                for sidx, w in zpl[e]:
                    v = T[sidx, my, mx] - c0
                    fz[(e, sidx)] = v
                    if v != 0.0:
                        Kfaces[0 + e][w, tap, ci, co] += v
                for sidx, w in ypl[e]:
                    v = T[mz, sidx, mx] - c0
                    fy[(e, sidx)] = v
                    if v != 0.0:
                        Kfaces[2 + e][w, tap, ci, co] += v
                for sidx, w in xpl[e]:
                    v = T[mz, my, sidx] - c0
                    fx[(e, sidx)] = v
                    if v != 0.0:
                        Kfaces[4 + e][w, tap, ci, co] += v

            # edge cross terms by inclusion-exclusion
            prof_ax = (zpl, ypl, xpl)
            fax = (fz, fy, fx)

            def Tat(a_, b_, axes):
                idx = [mz, my, mx]
                idx[axes[0]] = a_
                idx[axes[1]] = b_
                return T[tuple(idx)]

            eidx = 0
            for (ai, aj, ei, ej) in edge_specs:
                for sa, wa in prof_ax[ai][ei]:
                    for sb, wb in prof_ax[aj][ej]:
                        v = (Tat(sa, sb, (ai, aj)) - c0
                             - fax[ai][(ei, sa)] - fax[aj][(ej, sb)])
                        if v != 0.0:
                            Kedges[eidx][wa, wb, tap, ci, co] += v
                eidx += 1

            for cidx, (ez, ey, ex) in enumerate(corner_specs):
                for sa, wa in zpl[ez]:
                    for sb, wb in ypl[ey]:
                        for sc, wc in xpl[ex]:
                            v = (T[sa, sb, sc] - c0
                                 - fz[(ez, sa)] - fy[(ey, sb)] - fx[(ex, sc)]
                                 - (Tat(sa, sb, (0, 1)) - c0
                                    - fz[(ez, sa)] - fy[(ey, sb)])
                                 - (Tat(sa, sc, (0, 2)) - c0
                                    - fz[(ez, sa)] - fx[(ex, sc)])
                                 - (Tat(sb, sc, (1, 2)) - c0
                                    - fy[(ey, sb)] - fx[(ex, sc)]))
                            if v != 0.0:
                                Kcorners[cidx][wa, wb, wc, tap, ci, co] += v

        npdt = np.dtype(dtype)
        dev = jax.device_put
        cmask = np.zeros((Gz, Gy, Gx, C), dtype=npdt)
        c0 = 0
        for _b, (Xk, Yk, Zk), s in lay.kinds:
            cmask[:Zk, :Yk, :Xk, c0:c0 + s] = 1.0
            c0 += s
        return cls(
            Kc=dev(jnp.asarray(Kc.astype(npdt))),
            Kfaces=tuple(dev(jnp.asarray(k.astype(npdt))) for k in Kfaces),
            Kedges=tuple(dev(jnp.asarray(k.astype(npdt))) for k in Kedges),
            Kcorners=tuple(dev(jnp.asarray(k.astype(npdt)))
                           for k in Kcorners),
            bc_mask=dev(jnp.asarray(np.asarray(dia.bc_mask))),
            layout=lay, gdims=(Gz, Gy, Gx),
            chan_mask=dev(jnp.asarray(cmask)))

    # -- apply --------------------------------------------------------------
    def _to_channels(self, x: jnp.ndarray) -> jnp.ndarray:
        """Flat dofs -> padded channel tensor [Gz+2, Gy+2, Gx+2, C]."""
        lay = self.layout
        Gz, Gy, Gx = self.gdims
        grids = lay.split(x.reshape(-1, 1))  # [Z,Y,X,slots,1]
        parts = []
        for g in grids:
            Zk, Yk, Xk, s, _ = g.shape
            parts.append(jnp.pad(
                g[..., 0],
                ((1, Gz - Zk + 1), (1, Gy - Yk + 1), (1, Gx - Xk + 1),
                 (0, 0))))
        return jnp.concatenate(parts, axis=-1)

    def _from_channels(self, y: jnp.ndarray) -> jnp.ndarray:
        """Channel tensor [Gz, Gy, Gx, C] -> flat dofs (drop phantoms)."""
        lay = self.layout
        outs = []
        c0 = 0
        for _b, (Xk, Yk, Zk), s in lay.kinds:
            blk = y[:Zk, :Yk, :Xk, c0:c0 + s]
            outs.append(blk.reshape(-1))
            c0 += s
        return jnp.concatenate(outs)

    def _patches(self, xp: jnp.ndarray, z0, z1, y0, y1, x0, x1):
        """[27, z1-z0, y1-y0, x1-x0, C] tap-shifted slices of the padded
        tensor over a dst window given in common coordinates."""
        sl = []
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    sl.append(xp[z0 + dz + 1: z1 + dz + 1,
                                 y0 + dy + 1: y1 + dy + 1,
                                 x0 + dx + 1: x1 + dx + 1])
        return jnp.stack(sl, axis=0)

    def apply_raw(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._from_channels(self._apply_interior(self._to_channels(x)))

    def to_channels_padded(self, x: jnp.ndarray) -> jnp.ndarray:
        """Flat dof vector -> padded channel tensor (the channel-resident
        CG state; see apply_channels)."""
        return self._to_channels(x)

    def from_channels_padded(self, xp: jnp.ndarray) -> jnp.ndarray:
        return self._from_channels(xp[1:-1, 1:-1, 1:-1, :])

    def apply_channels(self, xp: jnp.ndarray) -> jnp.ndarray:
        """Channel-resident apply: padded tensor in, padded tensor out.

        The flat<->channel relayout (kind-grid split + concatenate) is
        what made the conv form lose to the fused-slice DIA form when
        paid PER ITERATION; keeping the whole CG loop in the padded
        channel tensor removes it from the loop entirely (convert b
        once in, x once out).  The phantom entries (kind grids one
        plane short of the common grid) and the one-plane zero ring are
        re-zeroed every apply via ``chan_mask`` + re-pad, so dot
        products over the full tensor equal flat-vector dots."""
        y = self._apply_interior(xp) * self.chan_mask
        return jnp.pad(y, ((1, 1), (1, 1), (1, 1), (0, 0)))

    def _apply_interior(self, xp: jnp.ndarray) -> jnp.ndarray:
        Gz, Gy, Gx = self.gdims
        y = jax.lax.conv_general_dilated(
            xp[None], self.Kc, window_strides=(1, 1, 1), padding="VALID",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))[0]

        (zl0, zl1), (zh0, zh1) = _axis_windows(Gz)
        (yl0, yl1), (yh0, yh1) = _axis_windows(Gy)
        (xl0, xl1), (xh0, xh1) = _axis_windows(Gx)
        zw = ((zl0, zl1), (zh0, zh1))
        yw = ((yl0, yl1), (yh0, yh1))
        xw = ((xl0, xl1), (xh0, xh1))

        # boundary corrections accumulate with WINDOWED adds
        # (y.at[window].add): the earlier pad-to-full-then-add form cost
        # 26 full-tensor passes per apply
        # faces: z windows span all y, x (and symmetrically)
        for e in (0, 1):
            a0, a1 = zw[e]
            p = self._patches(xp, a0, a1, 0, Gy, 0, Gx)
            t = jnp.einsum("tpabc,ptcd->pabd", p, self.Kfaces[0 + e])
            y = y.at[a0:a1, :, :, :].add(t)
            b0, b1 = yw[e]
            p = self._patches(xp, 0, Gz, b0, b1, 0, Gx)
            t = jnp.einsum("tzpbc,ptcd->zpbd", p, self.Kfaces[2 + e])
            y = y.at[:, b0:b1, :, :].add(t)
            c0_, c1_ = xw[e]
            p = self._patches(xp, 0, Gz, 0, Gy, c0_, c1_)
            t = jnp.einsum("tzapc,ptcd->zapd", p, self.Kfaces[4 + e])
            y = y.at[:, :, c0_:c1_, :].add(t)

        # edges
        eidx = 0
        axw = (zw, yw, xw)
        for (ai, aj, ei, ej) in [(0, 1, ei, ej) for ei in (0, 1)
                                 for ej in (0, 1)] + \
                                [(0, 2, ei, ej) for ei in (0, 1)
                                 for ej in (0, 1)] + \
                                [(1, 2, ei, ej) for ei in (0, 1)
                                 for ej in (0, 1)]:
            (a0, a1) = axw[ai][ei]
            (b0, b1) = axw[aj][ej]
            if ai == 0 and aj == 1:
                p = self._patches(xp, a0, a1, b0, b1, 0, Gx)
                t = jnp.einsum("tpqbc,pqtcd->pqbd", p, self.Kedges[eidx])
                y = y.at[a0:a1, b0:b1, :, :].add(t)
            elif ai == 0 and aj == 2:
                p = self._patches(xp, a0, a1, 0, Gy, b0, b1)
                t = jnp.einsum("tpaqc,pqtcd->paqd", p, self.Kedges[eidx])
                y = y.at[a0:a1, :, b0:b1, :].add(t)
            else:
                p = self._patches(xp, 0, Gz, a0, a1, b0, b1)
                t = jnp.einsum("tzpqc,pqtcd->zpqd", p, self.Kedges[eidx])
                y = y.at[:, a0:a1, b0:b1, :].add(t)
            eidx += 1

        for cidx, (ez, ey, ex) in enumerate(
                [(a, b, c) for a in (0, 1) for b in (0, 1)
                 for c in (0, 1)]):
            (a0, a1) = zw[ez]
            (b0, b1) = yw[ey]
            (c0_, c1_) = xw[ex]
            p = self._patches(xp, a0, a1, b0, b1, c0_, c1_)
            t = jnp.einsum("tpqrc,pqrtcd->pqrd", p, self.Kcorners[cidx])
            y = y.at[a0:a1, b0:b1, c0_:c1_, :].add(t)

        return y

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        """Baked-BC operator (the DIA weights already eliminate BC
        rows/cols and carry the unit diagonal)."""
        return self.apply_raw(x)

    def apply_bc_rows_zero(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.where(self.bc_mask, 0.0, self.apply_raw(x))
