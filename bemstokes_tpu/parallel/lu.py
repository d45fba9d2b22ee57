"""Distributed dense blocked-LU over the 1-D row-slab layout — the sharded
DirectPreconditioner (reference `source/direct_preconditioner.cc:1-23` wraps
a rank-gathering Amesos LU; SURVEY.md section 7.3 calls the sharded variant
the hardest kernel).

Layout.  The monolithic surface block lives row-sharded in slab order
(`parallel.sharded`): device k owns the m = d*nloc rows of its node slab.
For the factorization the columns are re-ordered to the SAME slab order
(`slab_reorder_columns`, a device-local gather), giving a square [Np, Np]
matrix (Np = ndev*m) whose k-th block row AND block column belong to device
k.  Padded rows/columns carry a unit diagonal.

Factorization: right-looking blocked LU with block-local partial pivoting,
one block step per device.  At step j the pivot block row is broadcast
(psum-masked all-reduce, the shard_map analog of the ScaLAPACK panel
broadcast), every device redundantly factors the [m, m] diagonal block (a
single dense LU — cheaper than a second collective), devices
k > j form L_kj = A_kj U_jj^{-1} by triangular solve and rank-m update their
trailing slab.  Communication: ndev broadcasts of an [m, Np] slab = one
matrix-sized volume total, paid once per refactorization and amortized
across frames by the stale-reuse semantics.

Solve: block forward/backward substitution.  At step k device k solves its
[m, m] triangular block and the m-vector is broadcast; every later device
immediately folds it into its accumulator with an [m, m] GEMV, so the
per-apply FLOP count is ~2 slab GEMVs — the same order as one distributed
matvec.  Wall-time is another matter: the 2*ndev serialized block steps
(each a psum broadcast) pay latency the single-collective matvec does not;
on the 8-virtual-device CPU mesh the measured apply is 13-48x two matvecs
(BENCH_SCALING.json lu_solve_vs_2_matvecs — shared-silicon worst case; on
real chips the gap is ndev broadcast latencies).  The trade still wins
decisively: block-Jacobi fails to converge on the monolithic system (3000+
GMRES iterations at n=386) where the stale LU holds 1-3 iterations
(BENCH_SCALING.json stale_lu_vs_block_jacobi).

Pivoting is block-local (within the [m, m] diagonal blocks).  That is not
full partial pivoting, but the monolithic BEM operator is dense with a
strong diagonal (V's near-singular self-blocks), and the factorization is
used as a GMRES *preconditioner*: f64 GMRES restores full accuracy (the
same argument as the single-chip f32-LU mixed-precision path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .sharded import padded_rows


def _slab_geometry(n_nodes: int, dim: int, mesh: Mesh):
    ndev = mesh.devices.size
    _, nloc = padded_rows(n_nodes, mesh)
    m = dim * nloc
    return ndev, nloc, m


def slab_reorder_columns(
    A_slab: jnp.ndarray, n_nodes: int, dim: int, mesh: Mesh
) -> jnp.ndarray:
    """[ndev*m, d*n] (slab rows, flat columns) -> [ndev*m, ndev*m] (slab rows
    AND columns), with unit diagonal on padded rows/columns.  Device-local:
    a column gather plus a masked row fix, no communication."""
    ndev, nloc, m = _slab_geometry(n_nodes, dim, mesh)
    n = n_nodes
    Np = ndev * m

    # slab column s -> flat column (d*n acts as the zero-fill slot)
    s = np.arange(Np)
    node = (s // m) * nloc + (s % m) % nloc
    comp = (s % m) // nloc
    colperm = np.where(node < n, comp * n + node, dim * n).astype(np.int32)
    colperm_j = jnp.asarray(colperm)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None),),
        out_specs=P("rows", None),
        check_vma=False,
    )
    def _reorder(A_loc):  # [m, d*n] -> [m, Np]
        A_ext = jnp.concatenate(
            [A_loc, jnp.zeros((m, 1), A_loc.dtype)], axis=1
        )
        A2 = A_ext[:, colperm_j]
        # padded rows -> e_row (unit diagonal at this device's slab index)
        r0 = jax.lax.axis_index("rows").astype(jnp.int32) * m
        r = jnp.arange(m, dtype=jnp.int32)
        row_node = (
            jax.lax.axis_index("rows").astype(jnp.int32) * nloc + r % nloc
        )
        pad_row = row_node >= n
        unit_rows = jnp.zeros((m, Np), A_loc.dtype).at[
            r, r0 + r
        ].set(1.0)
        A2 = jnp.where(pad_row[:, None], unit_rows, A2)
        # padded columns are already zero-filled by the gather; their unit
        # diagonal lives in the owning device's padded row
        return A2

    return _reorder(A_slab)


def slab_lu_factor(A2_slab: jnp.ndarray, mesh: Mesh):
    """Blocked LU of the slab-ordered square matrix.  Returns
    (LU_slab [Np, Np] P('rows', None), perm [Np] P('rows')): device k's slab
    holds [L_k0 .. L_k,k-1 | LU_kk | U_k,k+1 .. ] and its block-local row
    permutation (already applied to the stored rows)."""
    Np = A2_slab.shape[1]
    ndev = mesh.devices.size
    m = Np // ndev

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None),),
        out_specs=(P("rows", None), P("rows")),
        check_vma=False,
    )
    def _factor(A_loc):  # [m, Np]
        ax = jax.lax.axis_index("rows").astype(jnp.int32)
        cols = jnp.arange(Np, dtype=jnp.int32)
        eye_m = jnp.eye(m, dtype=A_loc.dtype)

        def step(j, carry):
            A_cur, perm_cur = carry
            pivot = jax.lax.psum(
                jnp.where(ax == j, A_cur, jnp.zeros_like(A_cur)), "rows"
            )  # [m, Np] broadcast of block row j
            D = jax.lax.dynamic_slice(pivot, (0, j * m), (m, m))
            lu_D, piv_D = jax.scipy.linalg.lu_factor(D)
            perm_D = jax.lax.linalg.lu_pivots_to_permutation(piv_D, m)
            permuted = pivot[perm_D, :]
            L_jj = jnp.tril(lu_D, -1) + eye_m
            # U block row: L_jj^{-1} P (trailing columns); left columns hold
            # L factors from earlier steps and only get the permutation
            solved = jax.lax.linalg.triangular_solve(
                L_jj,
                permuted,
                left_side=True,
                lower=True,
                unit_diagonal=True,
            )
            after = cols >= (j + 1) * m
            new_pivot = jnp.where(after[None, :], solved, permuted)
            new_pivot = jax.lax.dynamic_update_slice(
                new_pivot, lu_D, (0, j * m)
            )
            # devices k > j: L_kj = A_kj U_jj^{-1}, trailing rank-m update
            U_jj = jnp.triu(lu_D)
            A_kj = jax.lax.dynamic_slice(A_cur, (0, j * m), (m, m))
            L_kj = jax.lax.linalg.triangular_solve(
                U_jj, A_kj, left_side=False, lower=False
            )
            U_rest = jnp.where(after[None, :], new_pivot, 0.0)
            A_upd = A_cur - L_kj @ U_rest
            A_upd = jax.lax.dynamic_update_slice(A_upd, L_kj, (0, j * m))
            A_next = jnp.where(ax > j, A_upd, A_cur)
            A_next = jnp.where(ax == j, new_pivot, A_next)
            perm_next = jnp.where(ax == j, perm_D, perm_cur)
            return A_next, perm_next

        A_fin, perm_fin = jax.lax.fori_loop(
            0, ndev, step, (A_loc, jnp.arange(m, dtype=jnp.int32))
        )
        return A_fin, perm_fin

    return _factor(A2_slab)


def slab_lu_solve(
    LU_slab: jnp.ndarray,
    perm_slab: jnp.ndarray,
    b_slab: jnp.ndarray,
    mesh: Mesh,
) -> jnp.ndarray:
    """Solve L U x = P b with the factors of `slab_lu_factor`; b and x are
    slab-ordered vectors sharded P('rows')."""
    Np = LU_slab.shape[1]
    ndev = mesh.devices.size
    m = Np // ndev

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None), P("rows"), P("rows")),
        out_specs=P("rows"),
        check_vma=False,
    )
    def _solve(A_loc, perm_loc, b_loc):  # [m, Np], [m], [m]
        ax = jax.lax.axis_index("rows").astype(jnp.int32)
        eye_m = jnp.eye(m, dtype=A_loc.dtype)
        fdt = A_loc.dtype
        acc0 = b_loc.astype(fdt)[perm_loc]

        def fwd(k, carry):
            acc, y_loc = carry
            Dk = jax.lax.dynamic_slice(A_loc, (0, k * m), (m, m))
            L_kk = jnp.tril(Dk, -1) + eye_m
            yk_self = jax.lax.linalg.triangular_solve(
                L_kk,
                acc[:, None],
                left_side=True,
                lower=True,
                unit_diagonal=True,
            )[:, 0]
            yk = jax.lax.psum(
                jnp.where(ax == k, yk_self, jnp.zeros_like(yk_self)), "rows"
            )
            acc = jnp.where(ax > k, acc - Dk @ yk, acc)
            y_loc = jnp.where(ax == k, yk, y_loc)
            return acc, y_loc

        _, y_loc = jax.lax.fori_loop(
            0, ndev, fwd, (acc0, jnp.zeros_like(acc0))
        )

        def bwd(t, carry):
            k = ndev - 1 - t
            acc, x_loc = carry
            Dk = jax.lax.dynamic_slice(A_loc, (0, k * m), (m, m))
            U_kk = jnp.triu(Dk)
            xk_self = jax.lax.linalg.triangular_solve(
                U_kk, acc[:, None], left_side=True, lower=False
            )[:, 0]
            xk = jax.lax.psum(
                jnp.where(ax == k, xk_self, jnp.zeros_like(xk_self)), "rows"
            )
            acc = jnp.where(ax < k, acc - Dk @ xk, acc)
            x_loc = jnp.where(ax == k, xk, x_loc)
            return acc, x_loc

        _, x_loc = jax.lax.fori_loop(
            0, ndev, bwd, (y_loc, jnp.zeros_like(y_loc))
        )
        return x_loc.astype(b_loc.dtype)

    return _solve(LU_slab, perm_slab, b_slab)
