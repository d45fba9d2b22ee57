"""Fused node-mode assembly kernel for NVIDIA Hopper GPUs (Pallas, Triton
route).

The node formulation (`ops.assemble._assemble_rows_kernel`) turns collocation
assembly into a pairwise interaction sweep: column node j carries a fixed
per-frame table of m = vmax*nq quadrature samples (point, unit normal,
phi*JxW weight), and V/K entries are weighted sums of the Green's-function
pair body over those samples.  XLA's gather path instead writes the
[tile, chunk, nq, 3, 3] G and W.n tensors to device memory and reads them
back for a batched contraction; this kernel keeps every per-pair quantity
in registers.

Grid (row tile i, column chunk j).  Each program owns the T x CJ node block
of all nine (a, b) component planes of V and K, loops over the m samples
of its CJ columns, accumulates the pair body in registers (the upper
triangle only for the symmetric free-space kernel), and stores straight
into the final component-blocked [3, nr, 3, n] layout, which reshapes to
[3*nr, 3*n] for free.  No state carries between programs.

Own-cell pairs (the row node is a node of the sample's cell) are masked
out, as in the XLA gather path, and the singular path adds their singular
integrals.  Including them with the smooth rule and subtracting them again
cancels two separately rounded near-singular terms, which in f32 costs
~4e-5 of the largest entry.  Reference inner loop:
`source/bem_stokes.cc:2915-2949`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..kernels.images import green_pair

# (T, CJ, num_warps, num_stages): the fastest or within noise of it for all
# three Green's functions in f64 and f32 on an H100 (tile sweep in PERF.md);
# larger f64 blocks spill registers
TILE = (16, 32, 4, 1)

_UPPER = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_ALL = tuple((a, b) for a in range(3) for b in range(3))


def _node_kernel(
    x_ref,
    id_ref,
    y_ref,
    n_ref,
    w_ref,
    c_ref,
    v_ref,
    k_ref,
    *,
    T,
    CJ,
    kernel,
    wall_axis,
    wall_position,
):
    nr = x_ref.shape[1]
    m, n = w_ref.shape
    nl = c_ref.shape[0]
    dt = x_ref.dtype
    # one index dtype for every offset: python ints next to a 32-bit
    # program id would mix index widths under x64
    idt = jax.dtypes.canonicalize_dtype(jnp.int64)
    r0 = pl.program_id(0).astype(idt) * T
    c0 = pl.program_id(1).astype(idt) * CJ
    rmask = r0 + jnp.arange(T) < nr
    cmask = c0 + jnp.arange(CJ) < n
    x = [
        plgpu.load(x_ref.at[c, pl.ds(r0, T)], mask=rmask, other=0.0)[:, None]
        for c in range(3)
    ]
    ids = plgpu.load(id_ref.at[pl.ds(r0, T)], mask=rmask, other=-1)[:, None]
    image = kernel != "free_space"
    if image:
        xw_img = 2.0 * wall_position - x[wall_axis]
    keys = _UPPER if kernel == "free_space" else _ALL
    one = jnp.ones((), dt)

    def step(s, accs):
        s = s.astype(idt)

        def col(ref, c, other=0.0):
            at = ref.at[pl.ds(s, 1), pl.ds(c0, CJ)] if c is None else ref.at[
                c, pl.ds(s, 1), pl.ds(c0, CJ)
            ]
            return plgpu.load(at, mask=cmask[None, :], other=other)  # [1, CJ]

        y = [col(y_ref, c) for c in range(3)]
        nrm = [col(n_ref, c) for c in range(3)]
        R = [y[c] - x[c] for c in range(3)]  # [T, CJ]
        # pairs to skip: own cell, or R == 0 (padding rows and columns)
        skip = R[0] * R[0] + R[1] * R[1] + R[2] * R[2] == 0
        for l in range(nl):
            skip = skip | (ids == col(c_ref, l, other=-1))
        w = jnp.where(skip, jnp.zeros((), dt), col(w_ref, None))
        R = [jnp.where(skip, one, Rc) for Rc in R]
        RI = R
        if image:
            RI = list(R)
            RI[wall_axis] = jnp.where(skip, one, y[wall_axis] - xw_img)
        G, Wn = green_pair(kernel, R, RI, nrm, wall_axis)
        terms = [w * G[a][b] for a, b in keys] + [w * Wn[a][b] for a, b in keys]
        return tuple(acc + t for acc, t in zip(accs, terms))

    zeros = tuple(jnp.zeros((T, CJ), dt) for _ in range(2 * len(keys)))
    accs = jax.lax.fori_loop(0, m, step, zeros)
    accV = dict(zip(keys, accs[: len(keys)]))
    accK = dict(zip(keys, accs[len(keys) :]))
    mask = rmask[:, None] & cmask[None, :]
    for a, b in _ALL:
        key = (a, b) if (a, b) in accV else (b, a)
        at = (a, pl.ds(r0, T), b, pl.ds(c0, CJ))
        plgpu.store(v_ref.at[at], accV[key], mask=mask)
        # minus sign: exterior problem (reference `:2941-2947`)
        plgpu.store(k_ref.at[at], -accK[key], mask=mask)


@partial(
    jax.jit,
    static_argnames=("kernel", "wall_axis", "wall_position", "tiles", "interpret"),
)
def node_blocks(
    xi,  # [nr, 3] collocation points
    node_ids,  # [nr] global node ids of those rows
    Y,  # [n, m, 3] column-node quadrature points
    N,  # [n, m, 3] unit normals at those points
    W,  # [n, m] phi * JxW weights (0 on incidence padding)
    C,  # [n, m, nl] node ids of each sample's cell
    *,
    kernel: str = "free_space",
    wall_axis: int = 1,
    wall_position: float = 0.0,
    tiles: tuple | None = None,
    interpret: bool = False,
):
    """Dense smooth-rule (V, K) of the node pass, [3*nr, 3*n] each in the
    dtype of the inputs, own-cell pairs left out (the caller's singular
    pass adds them).  `tiles` = (T, CJ, num_warps, num_stages) overrides
    `TILE` (the tile sweep)."""
    nr, n = xi.shape[0], Y.shape[0]
    dt = xi.dtype
    T, CJ, num_warps, num_stages = tiles or TILE
    out = jax.ShapeDtypeStruct((3, nr, 3, n), dt)
    V, K = pl.pallas_call(
        partial(
            _node_kernel,
            T=T,
            CJ=CJ,
            kernel=kernel,
            wall_axis=wall_axis,
            wall_position=wall_position,
        ),
        grid=(pl.cdiv(nr, T), pl.cdiv(n, CJ)),
        out_shape=(out, out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="bem_node_assembly",
    )(
        xi.T,  # [3, nr]
        node_ids.astype(jnp.int32),
        Y.transpose(2, 1, 0),  # [3, m, n]: a column chunk is contiguous
        N.transpose(2, 1, 0),
        W.T,  # [m, n]
        C.astype(jnp.int32).transpose(2, 1, 0),  # [nl, m, n]
    )
    return V.reshape(3 * nr, 3 * n), K.reshape(3 * nr, 3 * n)
