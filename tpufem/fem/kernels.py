"""Batched element kernels (the FFCx ``tabulate_tensor`` replacement).

The reference links C kernels generated by FFCx from UFL forms
(src/Poisson.py:31-33, src/Elasticity.py:39-40; build wiring
src/CMakeLists.txt:23-33) and calls them cell-by-cell inside assembly
loops.  Here *all cells are computed at once* as batched contractions
of per-cell geometric factors against precomputed reference tensors —
the FLOPs land in large matmuls:

  Poisson stiffness :  A_c = |detJ_c| * G_c[alpha,beta] . K[alpha,beta,i,j]
                       => one [C, 9] @ [9, n^2] matmul
  Elasticity        :  A_c = C_c[alpha,beta,r,s] . K[alpha,beta,i,j]
                       => one [C, 81] @ [81, (3n)^2] matmul
  Action (matrix-free, form M = action(a, un), src/Poisson.py:33):
                       quadrature-point pipeline of two [C, n] x [n, 3q]
                       matmuls with a per-cell 3x3 metric contraction.

All functions are jit-friendly (static shapes, no Python control flow on
traced values).  Geometry enters only through the per-cell vertex
coordinates; Jacobians are inverted in closed form (adjugate).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.fem.reference import ReferenceTet


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def cell_geometry(coords: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(Jinv [C, 3, 3], detJ [C]) from cell vertex coords [C, 4, 3].

    J[a, l] = d x_a / d xi_l; Jinv[l, a] = d xi_l / d x_a via the adjugate
    (closed form beats LU for batched 3x3).
    """
    E = coords[:, 1:4, :] - coords[:, 0:1, :]  # [C, l, a]
    J = jnp.swapaxes(E, 1, 2)  # [C, a, l]
    c00 = J[:, 1, 1] * J[:, 2, 2] - J[:, 1, 2] * J[:, 2, 1]
    c01 = J[:, 1, 2] * J[:, 2, 0] - J[:, 1, 0] * J[:, 2, 2]
    c02 = J[:, 1, 0] * J[:, 2, 1] - J[:, 1, 1] * J[:, 2, 0]
    det = J[:, 0, 0] * c00 + J[:, 0, 1] * c01 + J[:, 0, 2] * c02
    adj = jnp.stack([
        jnp.stack([c00,
                   J[:, 0, 2] * J[:, 2, 1] - J[:, 0, 1] * J[:, 2, 2],
                   J[:, 0, 1] * J[:, 1, 2] - J[:, 0, 2] * J[:, 1, 1]], axis=-1),
        jnp.stack([c01,
                   J[:, 0, 0] * J[:, 2, 2] - J[:, 0, 2] * J[:, 2, 0],
                   J[:, 0, 2] * J[:, 1, 0] - J[:, 0, 0] * J[:, 1, 2]], axis=-1),
        jnp.stack([c02,
                   J[:, 0, 1] * J[:, 2, 0] - J[:, 0, 0] * J[:, 2, 1],
                   J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]], axis=-1),
    ], axis=1)  # [C, l, a] rows of Jinv * det
    Jinv = adj / det[:, None, None]
    return Jinv, det


# ---------------------------------------------------------------------------
# Poisson kernels  (forms a, L, M of src/Poisson.py:31-33)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _poisson_ref_tables(order: int):
    el = ReferenceTet(order)
    K = el.stiffness_tensors  # [3, 3, n, n]
    n = el.ndofs
    return np.ascontiguousarray(K.reshape(9, n * n)), el.mass_tensor, n


def poisson_stiffness_cells(coords: jnp.ndarray, order: int,
                            dtype=jnp.float32) -> jnp.ndarray:
    """Per-cell stiffness tensors [C, n, n] for a = inner(grad u, grad v) dx."""
    Kflat, _, n = _poisson_ref_tables(order)
    Jinv, det = cell_geometry(coords.astype(dtype))
    # G[alpha, beta] = |det| * (Jinv Jinv^T)[alpha, beta]
    G = jnp.einsum("cal,cbl->cab", Jinv, Jinv) * jnp.abs(det)[:, None, None]
    A = G.reshape(-1, 9) @ jnp.asarray(Kflat, dtype=dtype)
    return A.reshape(-1, n, n)


def poisson_rhs_cells(coords: jnp.ndarray, f_cells: jnp.ndarray,
                      order: int) -> jnp.ndarray:
    """Volume RHS b_c[i] = int f v dx per cell, with f interpolated in V:
    b_c = |detJ| * M_ref @ f_c  (form L volume term, src/Poisson.py:32)."""
    _, M, _ = _poisson_ref_tables(order)
    _, det = cell_geometry(coords)
    return (f_cells @ jnp.asarray(M.T, dtype=f_cells.dtype)) * jnp.abs(det)[:, None]


@functools.lru_cache(maxsize=None)
def _facet_tables(order: int):
    el = ReferenceTet(order)
    return el.facet_mass_tensors  # [4, n, n] in unit-triangle measure


def facet_rhs_cells(facet_cell_coords: jnp.ndarray, local_face: jnp.ndarray,
                    g_cells: jnp.ndarray, order: int) -> jnp.ndarray:
    """Surface RHS per boundary facet: int_facet g v ds
    (form L surface term ``g*v*ds``, src/Poisson.py:32).

    facet_cell_coords: [F, 4, 3] coords of the facet's attached cell.
    local_face: [F] local face index in that cell.
    g_cells: [F, n] coefficient g at the cell's dofs.
    Returns [F, n] contributions in the cell-local dof basis.
    """
    from tpufem.mesh.structured import LOCAL_FACES
    S = jnp.asarray(_facet_tables(order), dtype=g_cells.dtype)  # [4, n, n]
    lf = jnp.asarray(LOCAL_FACES)
    tri = jnp.take_along_axis(
        facet_cell_coords, lf[local_face][..., None].astype(jnp.int32), axis=1)  # [F,3,3]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    area2 = jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)  # = 2 * area
    Sf = S[local_face]  # [F, n, n]
    return jnp.einsum("fij,fj->fi", Sf, g_cells) * area2[:, None]


@functools.lru_cache(maxsize=None)
def _action_tables(order: int):
    el = ReferenceTet(order)
    _, wts, _, dphi = el.quad_data  # wts [q], dphi [q, n, 3]
    n = el.ndofs
    q = wts.shape[0]
    # D[n, q*3]: reference-gradient interpolation matrix
    D = np.ascontiguousarray(dphi.transpose(1, 0, 2).reshape(n, q * 3))
    return D, wts, n, q


def metric_tensors(coords: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """Per-cell metric G[c] = |detJ| * Jinv @ Jinv^T  ([C, 3, 3]).

    This is the only geometry the Poisson operator needs; precomputing it
    once at setup removes the per-iteration Jacobian work the reference
    redoes inside every matrix-free apply (pack_coefficients +
    re-tabulation, src/cgpoisson_problem.cpp:202-204).
    """
    Jinv, det = cell_geometry(coords.astype(dtype))
    return jnp.einsum("cal,cbl->cab", Jinv, Jinv) * jnp.abs(det)[:, None, None]


def poisson_action_from_metric(G: jnp.ndarray, u_cells: jnp.ndarray,
                               order: int) -> jnp.ndarray:
    """Matrix-free operator action per cell from precomputed metric:
    y_c = A_c @ u_c without materializing A_c (form M = action(a, un),
    src/Poisson.py:33).

    Pipeline: u -> reference gradients at quadrature points (matmul)
    -> per-cell metric contraction (elementwise) -> transpose matmul
    back.
    """
    dtype = u_cells.dtype
    D, wts, n, q = _action_tables(order)
    D = jnp.asarray(D, dtype=dtype)          # [n, q*3]
    w = jnp.asarray(wts, dtype=dtype)        # [q]
    r = (u_cells @ D).reshape(-1, q, 3)      # [C, q, alpha]
    t = jnp.einsum("cqa,cab->cqb", r, G.astype(dtype)) * w[None, :, None]
    return t.reshape(-1, q * 3) @ D.T        # [C, n]


def poisson_action_cells(coords: jnp.ndarray, u_cells: jnp.ndarray,
                         order: int) -> jnp.ndarray:
    """Action with geometry recomputed from coordinates (testing path)."""
    G = metric_tensors(coords, dtype=u_cells.dtype)
    return poisson_action_from_metric(G, u_cells, order)


# ---------------------------------------------------------------------------
# Elasticity kernels  (forms a, L of src/Elasticity.py:39-40)
# ---------------------------------------------------------------------------

# Lame parameters baked into the generated forms (src/Elasticity.py:12-15)
ELASTICITY_E = 1.0e6
ELASTICITY_NU = 0.3
ELASTICITY_MU = ELASTICITY_E / (2.0 * (1.0 + ELASTICITY_NU))
ELASTICITY_LMBDA = (ELASTICITY_E * ELASTICITY_NU
                    / ((1.0 + ELASTICITY_NU) * (1.0 - 2.0 * ELASTICITY_NU)))


@functools.lru_cache(maxsize=None)
def _elasticity_ref_table(order: int):
    """TT[(alpha,beta,r,s) = 81, (3n)^2] with
    A_c[(i,r),(j,s)] = sum_{ab rs} C_c[a,b,r,s] K[a,b,i,j]."""
    el = ReferenceTet(order)
    K = el.stiffness_tensors  # [3, 3, n, n]
    n = el.ndofs
    TT = np.zeros((3, 3, 3, 3, 3 * n, 3 * n))
    for r in range(3):
        for s in range(3):
            # rows 3i+r, cols 3j+s get K[a,b,i,j] for channel (a,b,r,s)
            TT[:, :, r, s, r::3, s::3] = K
    return np.ascontiguousarray(TT.reshape(81, 9 * n * n)), el.mass_tensor, n


def elasticity_stiffness_cells(coords: jnp.ndarray, order: int,
                               dtype=jnp.float32) -> jnp.ndarray:
    """Per-cell elasticity stiffness [C, 3n, 3n] for
    a = inner(sigma(u), eps(v)) dx with sigma = 2 mu eps + lambda tr(eps) I
    (src/Elasticity.py:30-39).  Dof layout interleaved: (i, r) -> 3i + r.
    """
    TT, _, n = _elasticity_ref_table(order)
    mu, lam = ELASTICITY_MU, ELASTICITY_LMBDA
    Jinv, det = cell_geometry(coords.astype(dtype))
    adet = jnp.abs(det)
    # C[c, a, b, r, s] = |det| ( mu d_rs sum_l Jinv[a,l] Jinv[b,l]
    #                          + mu Jinv[a,s] Jinv[b,r]
    #                          + lam Jinv[a,r] Jinv[b,s] )
    JJ = jnp.einsum("cal,cbl->cab", Jinv, Jinv)  # [C, a, b]
    eye = jnp.eye(3, dtype=dtype)
    C = (mu * JJ[:, :, :, None, None] * eye[None, None, None, :, :]
         + mu * jnp.einsum("cas,cbr->cabrs", Jinv, Jinv)
         + lam * jnp.einsum("car,cbs->cabrs", Jinv, Jinv))
    C = C * adet[:, None, None, None, None]
    A = C.reshape(-1, 81) @ jnp.asarray(TT, dtype=dtype)
    return A.reshape(-1, 3 * n, 3 * n)


def elasticity_rhs_cells(coords: jnp.ndarray, f_cells: jnp.ndarray,
                         order: int) -> jnp.ndarray:
    """Volume RHS for L = inner(f, v) dx: per component the scalar mass
    kernel.  f_cells: [C, n, 3] -> returns [C, n, 3]."""
    _, M, _ = _elasticity_ref_table(order)
    _, det = cell_geometry(coords)
    Mj = jnp.asarray(M, dtype=f_cells.dtype)
    return jnp.einsum("ij,cjr->cir", Mj, f_cells) * jnp.abs(det)[:, None, None]


def elasticity_action_cells(coords: jnp.ndarray, u_cells: jnp.ndarray,
                            order: int) -> jnp.ndarray:
    """Matrix-free elasticity action: u_cells [C, n, 3] -> y [C, n, 3].

    No reference analogue (the mini-app only runs matrix-free Poisson),
    provided for completeness; same quadrature pipeline with the
    elasticity constitutive contraction at quadrature points.
    """
    dtype = u_cells.dtype
    D, wts, n, q = _action_tables(order)
    mu, lam = ELASTICITY_MU, ELASTICITY_LMBDA
    D = jnp.asarray(D, dtype=dtype)
    w = jnp.asarray(wts, dtype=dtype)
    Jinv, det = cell_geometry(coords.astype(dtype))
    adet = jnp.abs(det)
    # reference gradients of each displacement component
    u_flat = u_cells.transpose(0, 2, 1).reshape(-1, n)  # [C*3, n]
    r = (u_flat @ D).reshape(-1, 3, q, 3)  # [C, r, q, alpha]
    gphys = jnp.einsum("crqa,cab->crqb", r, Jinv)  # grad_b u_r at qpts
    eps = 0.5 * (gphys + jnp.swapaxes(gphys, 1, 3))  # [C, r, q, b] sym in (r,b)
    tr = jnp.einsum("caqa->cq", eps)
    sig = (2.0 * mu * eps
           + lam * tr[:, None, :, None] * jnp.eye(3, dtype=dtype)[None, :, None, :])
    # sigma[c, r, q, b]; test gradient in reference coords:
    t = jnp.einsum("crqb,cab->crqa", sig, Jinv) * (w[None, None, :, None] * adet[:, None, None, None])
    y = (t.reshape(-1, q * 3) @ D.T).reshape(-1, 3, n)  # [C, r, n]
    return y.transpose(0, 2, 1)
