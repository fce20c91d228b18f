"""Independent numpy FEM assembly and direct solve (test oracle + dataset
generator).

Port of ``multigrid_feanet_tpu/data/fem.py``: numpy only, as there; the
elastic element stiffness comes from the port's ``ops/elasticity.py``.

Standard isoparametric Q1 bilinear-quad assembly with 2x2 Gauss quadrature —
the same math as the reference's dataset generator
(reference: Data/IsoPoisson/python_fem.ipynb cells 3-8) and its deal.II C++
oracle (reference: Archive/FEM/dealii_LinearLaplace/linear_laplace.cc:160-226),
written from scratch.  Deliberately shares no code with the stencil path so it
can serve as its correctness oracle: the stencil table is validated against
the rows of the dense matrix assembled here.

Everything is float64 and dense; intended for n <= ~128 oracle runs.
"""

from __future__ import annotations

import numpy as np

_GAUSS = 1.0 / np.sqrt(3.0)
_QPTS = [(-_GAUSS, -_GAUSS), (_GAUSS, -_GAUSS), (_GAUSS, _GAUSS), (-_GAUSS, _GAUSS)]


def element_stiffness(h: float, coeff: float = 1.0) -> np.ndarray:
    """4x4 Q1 stiffness matrix for a square element of size h with scalar
    diffusion coefficient ``coeff`` (local nodes CCW from lower-left, matching
    the stencil module's ``_element_local_nodes``)."""
    ke = np.zeros((4, 4))
    # shape functions on [-1,1]^2, CCW: N0=(1-x)(1-y)/4, N1=(1+x)(1-y)/4,
    # N2=(1+x)(1+y)/4, N3=(1-x)(1+y)/4  -> local nodes (ll, lr, ur, ul)
    for (xi, eta) in _QPTS:
        dN_dxi = 0.25 * np.array([-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)])
        dN_deta = 0.25 * np.array([-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)])
        # Jacobian of the map [-1,1]^2 -> h x h square is (h/2) I
        dN_dx = dN_dxi * (2.0 / h)
        dN_dy = dN_deta * (2.0 / h)
        # quadrature weight 1 * detJ = (h/2)^2
        ke += coeff * (np.outer(dN_dx, dN_dx) + np.outer(dN_dy, dN_dy)) * (h / 2.0) ** 2
    return ke


def element_mass(h: float) -> np.ndarray:
    """4x4 Q1 consistent mass matrix for a square element of size h."""
    me = np.zeros((4, 4))
    for (xi, eta) in _QPTS:
        N = 0.25 * np.array(
            [(1 - xi) * (1 - eta), (1 + xi) * (1 - eta), (1 + xi) * (1 + eta), (1 - xi) * (1 + eta)]
        )
        me += np.outer(N, N) * (h / 2.0) ** 2
    return me


def _element_nodes(r: int, c: int, n_nodes: int) -> np.ndarray:
    """Global node ids (row-major, i*n_nodes+j) of element (r, c), CCW from
    lower-left: (r,c), (r,c+1), (r+1,c+1), (r+1,c)."""
    return np.array(
        [r * n_nodes + c, r * n_nodes + c + 1, (r + 1) * n_nodes + c + 1, (r + 1) * n_nodes + c]
    )


def assemble(n: int, size: float = 2.0, phase: np.ndarray | None = None,
             coefficients=(1.0, 20.0)):
    """Assemble dense (N, N) stiffness K and mass M for an n x n element grid.

    ``phase``: optional (n, n) element phase map; element coefficient is
    ``coefficients[phase[r, c]]``.
    """
    h = size / n
    n_nodes = n + 1
    N = n_nodes * n_nodes
    K = np.zeros((N, N))
    M = np.zeros((N, N))
    ke_by_coeff = {c: element_stiffness(h, c) for c in set(np.asarray(coefficients).tolist())}
    me = element_mass(h)
    for r in range(n):
        for c in range(n):
            coeff = coefficients[int(phase[r, c])] if phase is not None else coefficients[0]
            nodes = _element_nodes(r, c, n_nodes)
            K[np.ix_(nodes, nodes)] += ke_by_coeff[coeff]
            M[np.ix_(nodes, nodes)] += me
    return K, M


def boundary_interior_ids(n: int):
    """(boundary_ids, interior_ids) for the square grid, row-major."""
    n_nodes = n + 1
    idx = np.arange(n_nodes * n_nodes).reshape(n_nodes, n_nodes)
    boundary = np.concatenate([idx[0], idx[-1], idx[1:-1, 0], idx[1:-1, -1]])
    mask = np.ones(n_nodes * n_nodes, dtype=bool)
    mask[boundary] = False
    return np.sort(boundary), np.nonzero(mask)[0]


def solve_dirichlet(n: int, f: np.ndarray, bc_value: np.ndarray | float = 0.0,
                    size: float = 2.0, phase: np.ndarray | None = None,
                    coefficients=(1.0, 20.0)) -> np.ndarray:
    """Direct partition solve K_II u_I = (M f)_I - K_IB u_B.

    ``f``: (n+1, n+1) source field; ``bc_value``: scalar or (n+1, n+1) field
    whose boundary ring supplies Dirichlet data.  Returns (n+1, n+1) u.
    (Same partition-solve scheme as reference Data/IsoPoisson/python_fem.ipynb
    cell 4 and Archive/FEM/matlab_LinearLaplace/laplace.m.)
    """
    K, M = assemble(n, size, phase, coefficients)
    n_nodes = n + 1
    bids, iids = boundary_interior_ids(n)
    fv = np.asarray(f, dtype=np.float64).reshape(-1)
    load = M @ fv
    ub = (np.zeros(n_nodes * n_nodes) + np.asarray(bc_value, dtype=np.float64).reshape(-1)
          if np.ndim(bc_value) else np.full(n_nodes * n_nodes, float(bc_value)))
    rhs = load[iids] - K[np.ix_(iids, bids)] @ ub[bids]
    ui = np.linalg.solve(K[np.ix_(iids, iids)], rhs)
    u = np.zeros(n_nodes * n_nodes)
    u[bids] = ub[bids]
    u[iids] = ui
    return u.reshape(n_nodes, n_nodes)


# ---- vector (elasticity) assembly: plane stress / plane strain ----


def assemble_elastic(n: int, E: float = 1.0, nu: float = 0.3, size: float = 2.0,
                     phase: np.ndarray | None = None, coefficients=(1.0, 1.0),
                     plane: str = "stress"):
    """Dense (2N, 2N) plane-stress/strain stiffness, DOFs (ux, uy) interleaved
    node-major (row-major nodes).  Oracle for ops/elasticity.py; mirrors the
    reference's MATLAB elasticity ground truths
    (Archive/FEM/matlab_elasticity/Plane_Stress_modify.m)."""
    from multigrid_feanet_torch.ops.elasticity import element_stiffness_elastic

    h = size / n
    n_nodes = n + 1
    N = n_nodes * n_nodes
    K = np.zeros((2 * N, 2 * N))
    ke = element_stiffness_elastic(E, nu, h, plane)
    for r in range(n):
        for c in range(n):
            scale = coefficients[int(phase[r, c])] if phase is not None else coefficients[0]
            nodes = _element_nodes(r, c, n_nodes)
            dofs = np.empty(8, dtype=int)
            dofs[0::2] = 2 * nodes
            dofs[1::2] = 2 * nodes + 1
            K[np.ix_(dofs, dofs)] += scale * ke
    return K


def solve_dirichlet_elastic(n: int, f: np.ndarray, E: float = 1.0, nu: float = 0.3,
                            size: float = 2.0, phase: np.ndarray | None = None,
                            coefficients=(1.0, 1.0), plane: str = "stress") -> np.ndarray:
    """Direct solve with zero Dirichlet displacement on the boundary ring.

    ``f``: (2, n+1, n+1) nodal body-force field.  The load vector uses the
    scalar consistent mass per component.  Returns (2, n+1, n+1) u.
    """
    K = assemble_elastic(n, E, nu, size, phase, coefficients, plane)
    _, M = assemble(n, size)
    n_nodes = n + 1
    N = n_nodes * n_nodes
    load = np.zeros(2 * N)
    load[0::2] = M @ np.asarray(f[0], dtype=np.float64).reshape(-1)
    load[1::2] = M @ np.asarray(f[1], dtype=np.float64).reshape(-1)
    bids, iids = boundary_interior_ids(n)
    free = np.concatenate([2 * iids, 2 * iids + 1])
    free.sort()
    u = np.zeros(2 * N)
    u[free] = np.linalg.solve(K[np.ix_(free, free)], load[free])
    return np.stack([u[0::2].reshape(n_nodes, n_nodes), u[1::2].reshape(n_nodes, n_nodes)])
