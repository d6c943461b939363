"""Finite-element matrix assembly as differentiable element-operator builders.

Rebuild of the assembly in /root/reference/examples/natural_frequency.py
(:134-284), buckling.py (:139-255) and thermal.py (:126-246). Differences by
design:

* Matrices are produced as ``ElementOperator``s (per-element dense blocks +
  DOF map) rather than CSR — the on-device matrix-free form; ``.to_dense()``
  feeds the Cholesky factor when an explicit factorization is wanted.
* Every builder is a pure, differentiable function of the element densities
  (and displacement field for the stress stiffness), so all of the
  reference's hand-written ``get_*_matrix_deriv`` reverse passes are replaced
  by ``jax.vjp`` of these builders.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.operators import ElementOperator


# ---------------------------------------------------------------------------
# Material interpolation (SIMP / RAMP / MSIMP / linear)
# ---------------------------------------------------------------------------


def stiffness_interp(rhoE, ptype="simp", p=3.0, q=5.0, rho0=1e-6):
    """Stiffness interpolation factor (natural_frequency.py:139-143)."""
    if ptype == "simp":
        return rhoE**p + rho0
    if ptype == "ramp":
        return rhoE / (1.0 + q * (1.0 - rhoE)) + rho0
    raise ValueError(f"Unknown stiffness interpolation {ptype!r}")


def mass_interp(rhoE, ptype="linear", q=5.0, rho0=1e-9, density=1.0,
                simp_c1=6e5, simp_c2=-5e6):
    """Mass interpolation factor (natural_frequency.py:208-218).

    msimp blends a high-order polynomial below rho=0.1 to avoid spurious
    low-density modes.
    """
    if ptype == "msimp":
        nonlin = simp_c1 * rhoE**6.0 + simp_c2 * rhoE**7.0
        cond = (rhoE > 0.1).astype(rhoE.dtype)
        return density * (rhoE * cond + nonlin * (1.0 - cond))
    if ptype == "ramp":
        return density * ((q + 1.0) * rhoE / (1.0 + q * rhoE) + rho0)
    if ptype == "linear":
        return density * rhoE
    raise ValueError(f"Unknown mass interpolation {ptype!r}")


def plane_stress_C0(E=1.0, nu=0.3, dtype=jnp.float64):
    """Plane-stress constitutive matrix (natural_frequency.py:83-86)."""
    C0 = E / (1.0 - nu**2) * jnp.array(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, 0.5 * (1.0 - nu)]],
        dtype=dtype,
    )
    return C0


def element_dof_map(conn):
    """(nelems, 8) global DOF indices in [ux0, uy0, ux1, uy1, ...] order."""
    var = jnp.zeros((conn.shape[0], 8), dtype=conn.dtype)
    var = var.at[:, 0::2].set(2 * conn)
    var = var.at[:, 1::2].set(2 * conn + 1)
    return var


# ---------------------------------------------------------------------------
# Plane-stress stiffness / mass
# ---------------------------------------------------------------------------


def stiffness_matrix(rhoE, Be, detJ, dofs, nvars, C0, ptype="simp", p=3.0,
                     q=5.0, rho0=1e-6):
    """K(rhoE) as an ElementOperator.

    Ke = sum_q detJ_q Be_q^T (c(rhoE) C0) Be_q  (natural_frequency.py:134-158).
    Be: (nq, nelems, 3, 8), detJ: (nq, nelems).
    """
    c = stiffness_interp(rhoE, ptype=ptype, p=p, q=q, rho0=rho0)
    # Staged contraction (explicit pairwise order): the 3-operand einsum can
    # be planned into a huge outer-product intermediate.
    CB = jnp.einsum("ik,qekl->qeil", C0, Be)  # (nq, ne, 3, 8)
    w = c[None, :] * detJ  # (nq, ne)
    Ke = jnp.einsum("qeij,qeil->ejl", Be, CB * w[:, :, None, None])
    return ElementOperator(Ke, dofs, nvars)


def mass_matrix(rhoE, He, detJ, dofs, nvars, ptype="linear", q=5.0,
                rho0=1e-9, density=1.0):
    """M(rhoE) as an ElementOperator (natural_frequency.py:205-236)."""
    dens = mass_interp(rhoE, ptype=ptype, q=q, rho0=rho0, density=density)
    w = dens[None, :] * detJ  # (nq, ne)
    Me = jnp.einsum("qeij,qeil->ejl", He, He * w[:, :, None, None])
    return ElementOperator(Me, dofs, nvars)


# ---------------------------------------------------------------------------
# Geometric (stress) stiffness for buckling
# ---------------------------------------------------------------------------


def stress_stiffness_matrix(rhoE, u, Be, Te, detJ, dofs, conn, nvars,
                            C0, ptype="simp", p=3.0, q=5.0, rho0=1e-9):
    """G(rhoE, u) as an ElementOperator (buckling.py:220-255).

    Element stresses s = c(rhoE) C0 Be u_e at each quadrature point are
    contracted against the Te tables; the 4x4 scalar block is placed on both
    the x-x and y-y DOF blocks.
    """
    c = stiffness_interp(rhoE, ptype=ptype, p=p, q=q, rho0=rho0)
    ue = u[dofs]  # (nelems, 8)
    # stress components at each qp: (nq, nelems, 3)
    s = jnp.einsum("e,ik,qekl,el->qei", c, C0, Be, ue)
    G0 = jnp.einsum("qe,qei,qeijl->ejl", detJ, s, Te)  # (nelems, 4, 4)
    Ge = jnp.zeros((conn.shape[0], 8, 8), dtype=G0.dtype)
    Ge = Ge.at[:, 0::2, 0::2].add(G0)
    Ge = Ge.at[:, 1::2, 1::2].add(G0)
    return ElementOperator(Ge, dofs, nvars)


# ---------------------------------------------------------------------------
# Thermal conduction / capacitance
# ---------------------------------------------------------------------------


def thermal_stiffness_matrix(rhoE, Be, detJ, conn, nnodes, kappa=1.0,
                             beta=0.0, p=3.0):
    """Heat conduction K with kappa(rho) = kappa0 ((1-beta) rho^p + beta)
    (thermal.py:126-148)."""
    k = kappa * ((1.0 - beta) * rhoE**p + beta)
    BtB = jnp.einsum("qeij,qeil->qejl", Be, Be)
    Ke = jnp.einsum("e,qe,qejl->ejl", k, detJ, BtB)
    return ElementOperator(Ke, conn, nnodes)


def thermal_mass_matrix(rhoE, He, detJ, conn, nnodes, density=1.0,
                        heat_capacity=1.0, beta=0.0):
    """Heat capacitance M with c(rho) = c0 rho0 ((1-beta) rho + beta)
    (thermal.py:192-214)."""
    c = heat_capacity * density * ((1.0 - beta) * rhoE + beta)
    HtH = jnp.einsum("qei,qej->qeij", He, He)
    Me = jnp.einsum("e,qe,qeij->eij", c, detJ, HtH)
    return ElementOperator(Me, conn, nnodes)


# ---------------------------------------------------------------------------
# Element density averaging (node -> element)
# ---------------------------------------------------------------------------


def element_density(rho, conn):
    """rhoE = mean of the four nodal densities (natural_frequency.py:399-404)."""
    return 0.25 * (rho[conn[:, 0]] + rho[conn[:, 1]] + rho[conn[:, 2]]
                   + rho[conn[:, 3]])
