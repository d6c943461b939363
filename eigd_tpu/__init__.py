"""eigd_tpu — an accelerator-native framework for adjoint derivatives of generalized
symmetric eigenproblems ``A(x) phi = lam * B(x) phi``.

This is a from-scratch JAX/XLA/Pallas rebuild of the capability set of
smdogroup/eigd (reference layout documented in SURVEY.md): a shift-and-invert
Lanczos forward eigensolver with B-inner-product orthogonalization, a family of
eigenvector-adjoint linear solvers (laa / sibk / pcpg / pgmres / dl), handling
of repeated and clustered eigenvalues, total-derivative contraction against
matrix-parameter sensitivities, finite-element assembly for plane-stress,
buckling (geometric stiffness) and thermal topology-optimization problems,
density filtering, and aggregation objectives — all wired into JAX autodiff via
``jax.custom_vjp`` so that gradients of functions of eigenvalues *and*
eigenvectors compose with the rest of a JAX program.

Everything on the compute path is jit-compatible: static shapes, ``lax`` control
flow, batched tall-skinny matmuls, and ``shard_map`` sharding over a
device mesh for the large-problem path.
"""

from . import config as _config  # noqa: F401  (enables x64 on import)

__version__ = "0.1.0"

from .ops.operators import (  # noqa: E402
    DenseOperator,
    ElementOperator,
    DiagonalOperator,
    as_operator,
)
from .ops.factor import (  # noqa: E402
    CholeskyFactor,
    EighFactor,
    CGFactor,
    make_shift_factor,
)
from .ops.lanczos import (  # noqa: E402
    BasicLanczos,
    LanczosResult,
    block_lanczos_solve,
    lanczos_iteration,
    lanczos_solve,
)
from .ops.blockfactor import (  # noqa: E402
    BCRFactor,
    BlockTridiagFactor,
    RefinedFactor,
)
from .ops.stencil import GridStencilOperator  # noqa: E402
from .ops.restart import IRAM, thick_restart_solve  # noqa: E402
from .ops.adjoint import (  # noqa: E402
    laa,
    sibk,
    pcpg,
    pgmres,
    generate_adjoint_correction,
    add_eig_total_derivative,
    eval_adjoint_residual_norm,
    are_eigenvalues_repeated,
)
from .ops.autodiff import (eigh_gen, eigh_gen_dense,  # noqa: E402
                           eigh_gen_fwdmode)

__all__ = [
    "DenseOperator",
    "ElementOperator",
    "DiagonalOperator",
    "as_operator",
    "CholeskyFactor",
    "EighFactor",
    "CGFactor",
    "make_shift_factor",
    "BasicLanczos",
    "LanczosResult",
    "lanczos_iteration",
    "lanczos_solve",
    "block_lanczos_solve",
    "BCRFactor",
    "BlockTridiagFactor",
    "RefinedFactor",
    "GridStencilOperator",
    "IRAM",
    "thick_restart_solve",
    "laa",
    "sibk",
    "pcpg",
    "pgmres",
    "generate_adjoint_correction",
    "add_eig_total_derivative",
    "eval_adjoint_residual_norm",
    "are_eigenvalues_repeated",
    "eigh_gen",
    "eigh_gen_dense",
    "eigh_gen_fwdmode",
]
