"""Flat-shell Q4 element (membrane + Mindlin bending + reduced shear) with
6 DOF/node, batched over elements.

On-device replacement for the role TACS plays in the reference's CRM wingbox
example (/root/reference/examples/crm.py:62-144): isotropic shell stiffness
and consistent mass as differentiable functions of per-element thickness, so
matrix-DV sensitivities (TACS addMatDVSensInnerProduct, crm.py:343-357) come
from jax.vjp of this assembly instead of a C++ callback.

Formulation: local orthonormal frame per element; membrane = plane-stress Q4;
bending = Mindlin plate with 2x2 quadrature; transverse shear with 1-point
reduced quadrature (avoids locking); small drilling stiffness on the
rotation about the shell normal. All element matrices are built as batched
einsums and rotated to global coordinates with block-diagonal frames.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .quad import GAUSS, shape_functions


def element_frames(Xe):
    """Local orthonormal frames for a batch of (possibly warped) quads.

    Xe: (nelems, 4, 3). Returns R (nelems, 3, 3) with rows (e1, e2, n) and
    local in-plane coordinates xl, yl (nelems, 4).
    """
    d1 = Xe[:, 1] - Xe[:, 0] + Xe[:, 2] - Xe[:, 3]
    d2 = Xe[:, 3] - Xe[:, 0] + Xe[:, 2] - Xe[:, 1]
    n = jnp.cross(d1, d2)
    n = n / jnp.linalg.norm(n, axis=1, keepdims=True)
    e1 = d1 / jnp.linalg.norm(d1, axis=1, keepdims=True)
    e2 = jnp.cross(n, e1)
    R = jnp.stack([e1, e2, n], axis=1)  # (nelems, 3, 3)

    rel = Xe - Xe[:, :1]  # (nelems, 4, 3)
    xl = jnp.einsum("nij,nkj->nki", R, rel)  # local coords (nelems, 4, 3)
    return R, xl[:, :, 0], xl[:, :, 1]


def _grads_local(xl, yl, xi, eta):
    N, Nxi, Neta = shape_functions(xi, eta)
    J00 = xl @ Nxi
    J10 = yl @ Nxi
    J01 = xl @ Neta
    J11 = yl @ Neta
    detJ = J00 * J11 - J01 * J10
    Nx = jnp.outer(J11 / detJ, Nxi) + jnp.outer(-J10 / detJ, Neta)
    Ny = jnp.outer(-J01 / detJ, Nxi) + jnp.outer(J00 / detJ, Neta)
    return N, Nx, Ny, detJ


# Local DOF layout per node: [u, v, w, t1, t2, t3] (t = rotations about the
# local axes); element local vector has 24 entries, node-major.
_U, _V, _W, _T1, _T2, _T3 = range(6)


def shell_element_matrices(Xe, thickness, E=70e9, nu=0.3, rho=2700.0,
                           kappa_s=5.0 / 6.0, drill=1e-5):
    """Batched local->global shell stiffness and mass matrices.

    Xe : (nelems, 4, 3) element nodal coordinates.
    thickness : (nelems,) shell thickness.
    Returns Ke, Me : (nelems, 24, 24) in GLOBAL coordinates.
    """
    nelems = Xe.shape[0]
    R, xl, yl = element_frames(Xe)
    t = thickness

    C0 = E / (1.0 - nu**2) * jnp.array(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, 0.5 * (1.0 - nu)]])
    Gmod = E / (2.0 * (1.0 + nu))

    Kl = jnp.zeros((nelems, 24, 24))
    Ml = jnp.zeros((nelems, 24, 24))

    # column index helpers
    def cols(dof):
        return jnp.arange(4) * 6 + dof

    cu, cv, cw, c1, c2, c3 = (cols(d) for d in range(6))

    area = jnp.zeros(nelems)

    for gx in GAUSS:
        for gy in GAUSS:
            N, Nx, Ny, dJ = _grads_local(xl, yl, gx, gy)
            area = area + dJ

            # membrane B (3, 8-cols scattered onto u,v)
            Bm = jnp.zeros((nelems, 3, 24))
            Bm = Bm.at[:, 0, cu].set(Nx)
            Bm = Bm.at[:, 1, cv].set(Ny)
            Bm = Bm.at[:, 2, cu].set(Ny)
            Bm = Bm.at[:, 2, cv].set(Nx)
            Kl = Kl + jnp.einsum("e,e,eij,ik,ekl->ejl", t, dJ, Bm, C0, Bm)

            # bending curvature B: beta_x = t2, beta_y = -t1
            Bb = jnp.zeros((nelems, 3, 24))
            Bb = Bb.at[:, 0, c2].set(Nx)
            Bb = Bb.at[:, 1, c1].set(-Ny)
            Bb = Bb.at[:, 2, c2].set(Ny)
            Bb = Bb.at[:, 2, c1].set(-Nx)
            Kl = Kl + jnp.einsum("e,e,eij,ik,ekl->ejl", t**3 / 12.0, dJ,
                                 Bb, C0, Bb)

            # consistent mass: translations rho*t, rotations rho*t^3/12
            NN = jnp.outer(N, N)[None, :, :] * jnp.ones((nelems, 1, 1))
            for c in (cu, cv, cw):
                Ml = Ml.at[:, c[:, None], c[None, :]].add(
                    (rho * t * dJ)[:, None, None] * NN)
            for c in (c1, c2):
                Ml = Ml.at[:, c[:, None], c[None, :]].add(
                    (rho * t**3 / 12.0 * dJ)[:, None, None] * NN)

    # reduced (1-point) transverse shear: gamma = [w_x + beta_x, w_y + beta_y]
    N, Nx, Ny, dJ = _grads_local(xl, yl, 0.0, 0.0)
    Bs = jnp.zeros((nelems, 2, 24))
    Bs = Bs.at[:, 0, cw].set(Nx)
    Bs = Bs.at[:, 0, c2].set(N[None, :] * jnp.ones((nelems, 1)))
    Bs = Bs.at[:, 1, cw].set(Ny)
    Bs = Bs.at[:, 1, c1].set(-N[None, :] * jnp.ones((nelems, 1)))
    # 1-point rule weight = 4 (full parametric area)
    Kl = Kl + jnp.einsum("e,e,eij,eil->ejl", kappa_s * Gmod * t, 4.0 * dJ,
                         Bs, Bs)

    # drilling stiffness and a tiny rotary mass on t3 (avoid singular K, M)
    kd = drill * E * t * area
    md = drill * rho * t * area
    diag_idx = c3
    Kl = Kl.at[:, diag_idx, diag_idx].add(kd[:, None] * jnp.ones((1, 4)))
    Ml = Ml.at[:, diag_idx, diag_idx].add(md[:, None] * jnp.ones((1, 4)))

    # rotate to global: T = blockdiag(R x 8); K_g = T^T K_l T as two batched
    # (e, 24, 24) GEMMs. Layout note: the earlier per-node-block einsum
    # ("erp,eirjs,esq->eipjq") materialized (e, 4, 6, 4, 6)-shaped
    # temporaries with tiny trailing dims, which tiled layouts pad many
    # times over. The GEMM form keeps every intermediate at the operands'
    # (e, 24, 24) shape.
    T = jnp.zeros((nelems, 24, 24))
    for i in range(4):
        T = T.at[:, 6 * i:6 * i + 3, 6 * i:6 * i + 3].set(R)
        T = T.at[:, 6 * i + 3:6 * i + 6, 6 * i + 3:6 * i + 6].set(R)

    def rotate(Al):
        # A_g = T^T A_l T
        return jnp.einsum("eri,ers,esj->eij", T, Al, T)

    Kg = rotate(Kl)
    Mg = rotate(Ml)
    Kg = 0.5 * (Kg + Kg.transpose(0, 2, 1))
    Mg = 0.5 * (Mg + Mg.transpose(0, 2, 1))
    return Kg, Mg


def shell_dof_map(conn):
    """(nelems, 24) global DOF indices, 6 DOF per node."""
    conn = np.asarray(conn)
    dofs = np.zeros((conn.shape[0], 24), dtype=np.int32)
    for i in range(4):
        for d in range(6):
            dofs[:, 6 * i + d] = 6 * conn[:, i] + d
    return jnp.asarray(dofs)
