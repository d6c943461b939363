"""9-point block stencil matvec as a Pallas kernel for NVIDIA GPUs (Triton).

Same operator as ``stencil.stencil_matvec``: y = A x for the 9-point
(ndof, ndof)-block stencil W on an (nx+1, ny+1) node grid, x of shape
(n, k). Each program takes ``block`` consecutive nodes in the flat node
order (node = i*(ny+1) + j) with all ndof*k channels, reads the one-node
halo as masked loads at the flat offsets di*(ny+1) + dj, and writes its
nodes once: x is read in place (no padded or shifted copies) and nothing
carries from one program to the next.

``interpret=True`` runs the same kernel through the Pallas interpreter
(tests on the CPU).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _kernel(w_ref, x_ref, y_ref, *, nx, ny, ndof, k, kp, block,
            interpret):
    yn = ny + 1
    nn = (nx + 1) * yn
    n0 = pl.program_id(0) * block
    node = n0 + jnp.arange(block)
    i, j = node // yn, node % yn
    kmask = (jnp.arange(kp) < k)[None, :]
    live = node < nn

    if interpret:
        # the interpreter clamps an out-of-range slice start (shifting the
        # block) instead of masking it: index with clipped vectors instead
        kk = jnp.clip(jnp.arange(kp), 0, k - 1)[None, :]

        def x_at(off, b):
            return x_ref.at[jnp.clip(node + off, 0, nn - 1)[:, None], b, kk]

        def w_at(c):
            return w_ref.at[jnp.clip(node, 0, nn - 1), c]
    else:
        def x_at(off, b):
            return x_ref.at[pl.ds(n0 + off, block), b, pl.ds(0, kp)]

        def w_at(c):
            return w_ref.at[pl.ds(n0, block), c]

    accs = [jnp.zeros((block, kp), y_ref.dtype) for _ in range(ndof)]
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ok = (live & (i + di >= 0) & (i + di <= nx)
                  & (j + dj >= 0) & (j + dj <= ny))
            xs = [plgpu.load(x_at(di * yn + dj, b),
                             mask=ok[:, None] & kmask, other=0.0)
                  for b in range(ndof)]
            c0 = ((1 + di) * 3 + (1 + dj)) * ndof * ndof
            for a in range(ndof):
                for b in range(ndof):
                    w = plgpu.load(w_at(c0 + a * ndof + b), mask=live,
                                   other=0.0)
                    accs[a] = accs[a] + w[:, None] * xs[b]
    zero = jnp.int32(0)  # int32 like n0: one index dtype under x64
    for a in range(ndof):
        plgpu.store(y_ref.at[pl.ds(n0, block), jnp.int32(a),
                             pl.ds(zero, kp)],
                    accs[a], mask=live[:, None] & kmask)


@partial(jax.jit, static_argnames=("nx", "ny", "ndof", "block", "num_warps",
                                   "interpret"))
def stencil_matvec_pallas(W, x, nx, ny, ndof, block=64, num_warps=8,
                          interpret=False):
    """y = A x like ``stencil.stencil_matvec``; x is (n,) or (n, k).

    The defaults (64 nodes, 8 warps) were the fastest of a 3 x 3 sweep
    (block 64-256, 2-8 warps) at k=8 and k=16, f32 and f64, on the H100:
    larger blocks and fewer warps spill the accumulators
    (scripts/bench_stencil.py).
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k = x.shape[1]
    nn = (nx + 1) * (ny + 1)
    # channel block: Triton block shapes are powers of two; lanes k..kp-1
    # are masked off on load and store
    kp = pl.next_power_of_2(k)
    kernel = partial(_kernel, nx=nx, ny=ny, ndof=ndof, k=k, kp=kp,
                     block=block, interpret=interpret)
    y = pl.pallas_call(
        kernel,
        # under shard_map the output varies over the mesh axes its inputs do
        out_shape=jax.ShapeDtypeStruct(
            (nn, ndof, k), x.dtype,
            vma=jax.typeof(W).vma | jax.typeof(x).vma),
        grid=(pl.cdiv(nn, block),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="stencil_matvec",
    )(W.reshape(nn, 9 * ndof * ndof), x.reshape(nn, ndof, k))
    y = y.reshape(nn * ndof, k)
    return y[:, 0] if squeeze else y
