"""Rigid-body near-nullspace for elasticity AMG.

Rebuild of ``build_near_nullspace`` (reference:
src/elasticity_problem.cpp:36-94): six modes — three translations and
three rotations built from dof coordinates — orthonormalized with a hard
``is_orthonormal`` check, then handed to the AMG setup as the tentative
prolongator seed (the PETSc ``MatSetNearNullSpace`` analogue,
elasticity_problem.cpp:239-241).
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp
import numpy as np

from tpufem.la.vector import is_orthonormal, orthonormalize


def rigid_body_modes(dof_coords: np.ndarray) -> np.ndarray:
    """[6, 3 * nnodes] rigid-body modes from scalar-dof coordinates.

    Modes (matching elasticity_problem.cpp:46-70):
      0..2: unit translations along x, y, z
      3: (-y, x, 0) rotation about z
      4: (z, 0, -x) rotation about y
      5: (0, -z, y) rotation about x
    """
    n = dof_coords.shape[0]
    x, y, z = dof_coords[:, 0], dof_coords[:, 1], dof_coords[:, 2]
    zero = np.zeros(n)
    one = np.ones(n)
    modes = np.zeros((6, n, 3))
    modes[0, :, 0] = one
    modes[1, :, 1] = one
    modes[2, :, 2] = one
    modes[3, :, 0] = -y
    modes[3, :, 1] = x
    modes[4, :, 0] = z
    modes[4, :, 2] = -x
    modes[5, :, 1] = -z
    modes[5, :, 2] = y
    return modes.reshape(6, 3 * n)


def build_near_nullspace(dof_coords: np.ndarray, dtype=None) -> np.ndarray:
    """Orthonormalized [6, ndofs] near-nullspace.  Raises if the
    Gram-Schmidt result fails the orthonormality check, mirroring the
    hard failure at elasticity_problem.cpp:76-81.

    Host float64 (setup phase; ~30 small ops that would otherwise each
    be an eager device dispatch)."""
    modes = rigid_body_modes(dof_coords)
    basis: List[np.ndarray] = []
    for m in modes:
        v = m.astype(np.float64)
        for u in basis:
            v = v - (u @ v) * u
        n = np.linalg.norm(v)
        if n == 0.0:
            raise RuntimeError("Space not orthonormal")
        basis.append(v / n)
    B = np.stack(basis)
    if not np.allclose(B @ B.T, np.eye(6), atol=1e-4):
        raise RuntimeError("Space not orthonormal")
    return B
