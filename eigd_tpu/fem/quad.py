"""Bilinear quad (Q4) element kernels, batched over all elements.

Rebuild of /root/reference/examples/fe_utils.py as pure jnp functions: the
reference already vectorizes over elements with einsum; here the quadrature
tables are additionally stacked over the 2x2 Gauss points so the downstream
assembly contractions are single batched einsums.

Element DOF ordering matches the reference: [ux0, uy0, ux1, uy1, ...]
(natural_frequency.py:88-91 var layout); quadrature-point index layout is
index = 2*i + j over gauss_pts[i], gauss_pts[j] as in natural_frequency.py
intital_Be_and_He (:109-132).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

# Plain Python floats: no device computation may happen at import time
# (the multi-chip dryrun configures the platform before first jax use).
GAUSS = (-1.0 / math.sqrt(3.0), 1.0 / math.sqrt(3.0))


def shape_functions(xi, eta):
    """Q4 shape functions and parametric derivatives (fe_utils.py:4-16)."""
    N = 0.25 * jnp.array([
        (1.0 - xi) * (1.0 - eta),
        (1.0 + xi) * (1.0 - eta),
        (1.0 + xi) * (1.0 + eta),
        (1.0 - xi) * (1.0 + eta),
    ])
    Nxi = 0.25 * jnp.array([-(1.0 - eta), (1.0 - eta), (1.0 + eta), -(1.0 + eta)])
    Neta = 0.25 * jnp.array([-(1.0 - xi), -(1.0 + xi), (1.0 + xi), (1.0 - xi)])
    return N, Nxi, Neta


def _grads(xe, ye, xi, eta):
    """Physical shape-function gradients and detJ at one quadrature point.

    xe, ye: (nelems, 4) element nodal coordinates.
    Returns N (4,), Nx, Ny (nelems, 4), detJ (nelems,).
    """
    N, Nxi, Neta = shape_functions(xi, eta)
    J00 = xe @ Nxi
    J10 = ye @ Nxi
    J01 = xe @ Neta
    J11 = ye @ Neta
    detJ = J00 * J11 - J01 * J10
    # invJ rows scaled by 1/detJ
    Nx = jnp.outer(J11 / detJ, Nxi) + jnp.outer(-J10 / detJ, Neta)
    Ny = jnp.outer(-J01 / detJ, Nxi) + jnp.outer(J00 / detJ, Neta)
    return N, Nx, Ny, detJ


def quad_points():
    """The four (xi, eta) Gauss points in reference index order 2*i + j."""
    out = [None] * 4
    for j in range(2):
        for i in range(2):
            out[2 * i + j] = (GAUSS[i], GAUSS[j])
    return out


def plane_stress_tables(X, conn):
    """Quadrature tables for the plane-stress Q4 element.

    Returns
    -------
    Be : (nq, nelems, 3, 8) strain-displacement matrices
    He : (nq, nelems, 2, 8) displacement interpolation matrices
    detJ : (nq, nelems)
    """
    xe = X[conn, 0]
    ye = X[conn, 1]
    nelems = conn.shape[0]

    Be_list, He_list, dJ_list = [], [], []
    for xi, eta in quad_points():
        N, Nx, Ny, detJ = _grads(xe, ye, xi, eta)
        Be = jnp.zeros((nelems, 3, 8), dtype=X.dtype)
        Be = Be.at[:, 0, 0::2].set(Nx)
        Be = Be.at[:, 1, 1::2].set(Ny)
        Be = Be.at[:, 2, 0::2].set(Ny)
        Be = Be.at[:, 2, 1::2].set(Nx)
        He = jnp.zeros((nelems, 2, 8), dtype=X.dtype)
        He = He.at[:, 0, 0::2].set(N[None, :] * jnp.ones((nelems, 1), X.dtype))
        He = He.at[:, 1, 1::2].set(N[None, :] * jnp.ones((nelems, 1), X.dtype))
        Be_list.append(Be)
        He_list.append(He)
        dJ_list.append(detJ)
    return jnp.stack(Be_list), jnp.stack(He_list), jnp.stack(dJ_list)


def stress_stiffness_tables(X, conn):
    """Quadrature tables for the geometric (stress) stiffness (fe_utils.py:58-98).

    Returns
    -------
    Be : (nq, nelems, 3, 8)
    Te : (nq, nelems, 3, 4, 4) with Te[:, :, 0] = Nx Nx^T, [1] = Ny Ny^T,
         [2] = Nx Ny^T + Ny Nx^T
    detJ : (nq, nelems)
    """
    xe = X[conn, 0]
    ye = X[conn, 1]
    nelems = conn.shape[0]

    Be_list, Te_list, dJ_list = [], [], []
    for xi, eta in quad_points():
        _, Nx, Ny, detJ = _grads(xe, ye, xi, eta)
        Be = jnp.zeros((nelems, 3, 8), dtype=X.dtype)
        Be = Be.at[:, 0, 0::2].set(Nx)
        Be = Be.at[:, 1, 1::2].set(Ny)
        Be = Be.at[:, 2, 0::2].set(Ny)
        Be = Be.at[:, 2, 1::2].set(Nx)
        Te = jnp.stack([
            jnp.einsum("ni,nj->nij", Nx, Nx),
            jnp.einsum("ni,nj->nij", Ny, Ny),
            jnp.einsum("ni,nj->nij", Nx, Ny) + jnp.einsum("ni,nj->nij", Ny, Nx),
        ], axis=1)
        Be_list.append(Be)
        Te_list.append(Te)
        dJ_list.append(detJ)
    return jnp.stack(Be_list), jnp.stack(Te_list), jnp.stack(dJ_list)


def thermal_tables(X, conn):
    """Quadrature tables for the scalar heat-conduction Q4 element
    (fe_utils.py:124-156). Index layout 2*j + i as in thermal.py:100-124.

    Returns
    -------
    Be : (nq, nelems, 2, 4) gradient matrices
    He : (nq, nelems, 4) interpolation vectors
    detJ : (nq, nelems)
    """
    xe = X[conn, 0]
    ye = X[conn, 1]
    nelems = conn.shape[0]

    out = [None] * 4
    for j in range(2):
        for i in range(2):
            out[2 * j + i] = (GAUSS[i], GAUSS[j])

    Be_list, He_list, dJ_list = [], [], []
    for xi, eta in out:
        N, Nx, Ny, detJ = _grads(xe, ye, xi, eta)
        Be = jnp.stack([Nx, Ny], axis=1)  # (nelems, 2, 4)
        He = jnp.broadcast_to(N[None, :], (nelems, 4))
        Be_list.append(Be)
        He_list.append(He)
        dJ_list.append(detJ)
    return jnp.stack(Be_list), jnp.stack(He_list), jnp.stack(dJ_list)


def detJ_tables(X, conn):
    """detJ at all quadrature points (nq, nelems) — fe_utils.compute_detJ."""
    xe = X[conn, 0]
    ye = X[conn, 1]
    dJ = []
    for xi, eta in quad_points():
        _, _, _, detJ = _grads(xe, ye, xi, eta)
        dJ.append(detJ)
    return jnp.stack(dJ)
