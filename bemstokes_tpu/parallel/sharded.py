"""Row-partitioned distributed operators over a 1-D `jax.sharding.Mesh` —
the replacement for the reference's Epetra row maps + distributed
SpMV (reference row partition `source/bem_stokes.cc:1599-1647`, vmult usage
`:4332`; SURVEY.md section 2.2).

Layout.  The dense operators are stored in *slab* layout: the global node set
is padded to ndev * nloc nodes; device k owns the contiguous node slab
[k*nloc, (k+1)*nloc) and holds the [d*nloc, d*n] block of rows (a, i) for its
nodes.  Stacked over devices this is a [ndev*d*nloc, d*n] array sharded
P('rows', None).  Columns (and therefore GMRES iterates x) stay in the global
component-blocked flat layout, replicated.

Matvec: x replicated -> local GEMV on each slab (no
communication) -> result is row-sharded; the all-gather back to a replicated
vector is O(d*n) bytes vs the O((d*n)^2 / ndev) local read, and XLA overlaps
it with surrounding work.  This is the BASELINE north-star pattern with the
gather on the output side of the GEMV.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.assemble import AssemblyTables, assemble_rows


def row_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("rows",))


def padded_rows(n_nodes: int, mesh: Mesh) -> tuple[int, int]:
    """(n_padded, nloc): node count padded to a multiple of the mesh size."""
    ndev = mesh.devices.size
    nloc = -(-n_nodes // ndev)
    return nloc * ndev, nloc


def flat_to_slab(vflat: jnp.ndarray, n_nodes: int, dim: int, mesh: Mesh):
    """Component-blocked flat [d*n] -> slab [ndev*d*nloc] (device-major,
    then component, then local node), zero-padded."""
    ndev = mesh.devices.size
    n_pad, nloc = padded_rows(n_nodes, mesh)
    v = vflat.reshape(dim, n_nodes)
    v = jnp.pad(v, ((0, 0), (0, n_pad - n_nodes)))
    return v.reshape(dim, ndev, nloc).transpose(1, 0, 2).reshape(-1)


def slab_to_flat(vslab: jnp.ndarray, n_nodes: int, dim: int, mesh: Mesh):
    ndev = mesh.devices.size
    nloc = vslab.shape[0] // (ndev * dim)
    v = vslab.reshape(ndev, dim, nloc).transpose(1, 0, 2).reshape(dim, -1)
    return v[:, :n_nodes].reshape(-1)


def sharded_assemble(
    euler: jnp.ndarray,
    support_pts: jnp.ndarray,
    tables: AssemblyTables,
    mesh: Mesh,
):
    """Row-sharded assembly: device k runs the row-block assembly kernel for
    its node slab (geometry replicated, rows partitioned — the reference's
    SPMD masking `:2875-2877` turned into slabs).  Returns (V, K) in slab
    layout [ndev*d*nloc, d*n], sharded P('rows', None)."""
    cfg = tables.cfg
    d = cfg.dim
    n = tables.n_nodes
    n_pad, nloc = padded_rows(n, mesh)

    sp_pad = jnp.pad(support_pts, ((0, n_pad - n), (0, 0)), constant_values=1e7)
    ids_all = jnp.arange(n_pad, dtype=jnp.int32)
    ids_all = jnp.where(ids_all < n, ids_all, -1)  # padded rows: no node

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("rows"), P("rows")),
        out_specs=(P("rows", None), P("rows", None)),
        check_vma=False,
    )
    def _assemble(euler_rep, sp_rep, xi_loc, ids_loc):
        r0 = jax.lax.axis_index("rows").astype(jnp.int32) * nloc
        return assemble_rows(euler_rep, sp_rep, xi_loc, ids_loc, r0, tables)

    return _assemble(euler, sp_pad, sp_pad, ids_all)


def sharded_matvec(A_slab: jnp.ndarray, x: jnp.ndarray, mesh: Mesh):
    """y_slab = A_slab @ x with x replicated; returns the row-sharded slab
    result (call `all_gather_slab` / slab_to_flat to re-replicate)."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None), P()),
        out_specs=P("rows"),
        check_vma=False,
    )
    def _mv(A_loc, x_rep):
        return A_loc @ x_rep

    return _mv(A_slab, x)


def sharded_matvec_gathered(A_slab: jnp.ndarray, x: jnp.ndarray, mesh: Mesh):
    """y = gather(A_slab @ x): local slab GEMV, then all-gather of the result
    so the caller gets a replicated slab-ordered vector."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None), P()),
        out_specs=P(),
        check_vma=False,
    )
    def _mv(A_loc, x_rep):
        y_loc = A_loc @ x_rep
        return jax.lax.all_gather(y_loc, "rows", tiled=True)

    return _mv(A_slab, x)


def sharded_matvec_ring(A2_slab: jnp.ndarray, x_slab: jnp.ndarray, mesh: Mesh):
    """y_slab = A2 @ x with BOTH operands slab-ordered (columns reordered by
    `lu.slab_reorder_columns`) and x row-sharded: an ndev-step ppermute ring.
    Each step multiplies the local [m, m] column block against the currently
    held x block while the next block rotates in over the ring — the
    explicit comm/compute-overlap formulation of the BASELINE north star
    (vs `sharded_matvec`, which gathers the replicated x up front and leaves
    overlap to XLA's scheduler)."""
    ndev = mesh.devices.size
    Np = A2_slab.shape[1]
    m = Np // ndev
    perm = [(i, (i - 1) % ndev) for i in range(ndev)]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None), P("rows")),
        out_specs=P("rows"),
        check_vma=False,
    )
    def _mv(A_loc, x_loc):  # [m, Np], [m]
        ax = jax.lax.axis_index("rows").astype(jnp.int32)

        def body(s, carry):
            y, xcur = carry  # xcur holds block (ax + s) % ndev
            j = (ax + s.astype(jnp.int32)) % ndev
            blk = jax.lax.dynamic_slice(
                A_loc, (jnp.int32(0), j * m), (m, m)
            )
            y = y + blk @ xcur
            xcur = jax.lax.ppermute(xcur, "rows", perm)
            return y, xcur

        y, _ = jax.lax.fori_loop(
            0, ndev, body, (jnp.zeros_like(x_loc), x_loc)
        )
        return y

    return _mv(A2_slab, x_slab)
