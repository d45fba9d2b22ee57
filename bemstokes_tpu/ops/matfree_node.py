"""Matrix-free V/K actions: the node-formulation pairwise sweep with the
GMRES vectors folded into the sweep, so the operators are never
materialized (reference hot loop `source/bem_stokes.cc:2915-2949`; matvec
use `:4332` — the reference escapes its RAM cap by adding MPI ranks, this
path escapes the device-memory cap on one device).

The sweep runs in XLA: per (row tile, column chunk) step it evaluates the
Green's-function pair body (`_eval_G_Wn`, the body every assembly path
shares) and contracts it against the weights and the input columns.
Semantics match the materialized node pass exactly (same dummy-offset
convention on exact R == 0 pairs, so the singular delta COO cancels them),
verified to 1e-7 by tests/test_matfree.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .assemble import (
    AssemblyTables,
    _eval_G_Wn,
    _pad_to_multiple,
    image_point,
    node_column_samples,
    KERNEL_FREE_SPACE,
)


@dataclasses.dataclass(frozen=True)
class SweepStatic:
    """Static (trace-time) description of a matrix-free sweep."""

    d: int
    n: int  # column nodes
    nr: int  # collocation rows (= n single-device)
    kernel: str
    wall_axis: int
    wall_position: float
    T: int
    CJ: int
    bulk_dt: object  # dtype of the sweep (f32 under mixed_bulk)
    out_dt: object


def sweep_static(tables: AssemblyTables, nr) -> SweepStatic:
    """Static sweep description from the (host) tables alone — no arrays
    touched, so callers can build it outside jit and pass only arrays
    through jitted functions."""
    cfg = tables.cfg
    dt = cfg.dtype
    is_f64 = jnp.dtype(dt) == jnp.float64
    return SweepStatic(
        d=cfg.dim,
        n=tables.n_nodes,
        nr=nr,
        kernel=cfg.kernel,
        wall_axis=cfg.wall_axis,
        wall_position=cfg.wall_position,
        T=min(cfg.row_tile, nr),
        CJ=min(cfg.cell_chunk, tables.n_nodes),
        bulk_dt=jnp.float32 if (cfg.mixed_bulk and is_f64) else dt,
        out_dt=dt,
    )


def build_sweep_arrays(st: SweepStatic, tables, xi, xq, normals, jxw):
    """Per-frame sweep arrays for `sweep_matvec`.  xi [nr, d] collocation
    points; (xq, normals, jxw) the smooth-rule panel geometry (the same
    arrays the assembly pass uses).  Jit-compatible."""
    Yj, Nj, Wj, _, _ = node_column_samples(tables, xq, normals, jxw)
    return dict(
        xi=xi.astype(st.bulk_dt),
        Y=Yj.astype(st.bulk_dt),
        N=Nj.astype(st.bulk_dt),
        W=Wj.astype(st.bulk_dt),
    )


def build_sweep(tables: AssemblyTables, xi, xq, normals, jxw):
    """Convenience: (SweepStatic, arrays) in one call."""
    st = sweep_static(tables, xi.shape[0])
    return st, build_sweep_arrays(st, tables, xi, xq, normals, jxw)


def sweep_matvec(st: SweepStatic, arrs, XV, XK):
    """(V @ XV, K @ XK) of the smooth bulk pass.  XV [d*n, BV] and
    XK [d*n, BK] are component-blocked flat columns; returns
    (VX [d*nr, BV], KX [d*nr, BK]).  1-D inputs are treated as single
    columns and returned 1-D."""
    squeeze_v = XV.ndim == 1
    squeeze_k = XK.ndim == 1
    if squeeze_v:
        XV = XV[:, None]
    if squeeze_k:
        XK = XK[:, None]
    VX, KX = _sweep_matvec_xla(st, arrs, XV, XK)
    VX = VX.astype(st.out_dt)
    KX = KX.astype(st.out_dt)
    if squeeze_v:
        VX = VX[:, 0]
    if squeeze_k:
        KX = KX[:, 0]
    return VX, KX


def _sweep_matvec_xla(st: SweepStatic, arrs, XV, XK):
    d, n, nr = st.d, st.n, st.nr
    bdt = st.bulk_dt
    BV, BK = XV.shape[1], XK.shape[1]
    Yj, Nj, Wj = arrs["Y"], arrs["N"], arrs["W"]  # [n, m, d], [n, m]
    xi = arrs["xi"]

    class _Cfg:
        kernel = st.kernel
        wall_axis = st.wall_axis
        wall_position = st.wall_position

    cj = min(st.CJ, n)
    Yp = _pad_to_multiple(Yj, cj, 0, pad_value=1e8)
    Np = _pad_to_multiple(Nj, cj, 0)
    Wp = _pad_to_multiple(Wj, cj, 0)
    XVn = _pad_to_multiple(
        XV.astype(bdt).reshape(d, n, BV).transpose(1, 2, 0), cj, 0
    )  # [n, BV, d]
    XKn = _pad_to_multiple(
        XK.astype(bdt).reshape(d, n, BK).transpose(1, 2, 0), cj, 0
    )
    ncj = Yp.shape[0] // cj
    m = Yj.shape[1]
    Yc = Yp.reshape(ncj, cj, m, d)
    Nc_ = Np.reshape(ncj, cj, m, d)
    Wc = Wp.reshape(ncj, cj, m)
    XVc = XVn.reshape(ncj, cj, BV, d)
    XKc = XKn.reshape(ncj, cj, BK, d)

    tile = min(st.T, nr)
    xi_p = _pad_to_multiple(xi.astype(bdt), tile, 0, pad_value=1e8)
    n_tiles = xi_p.shape[0] // tile

    def tile_rows(xi_t):  # [tile, d]
        if st.kernel != KERNEL_FREE_SPACE:
            xi_img = image_point(xi_t, st.wall_axis, st.wall_position)

        def col_chunk(carry, inp):
            oV, oK = carry
            Ycc, Ncc, Wcc, xvc, xkc = inp
            Rch = Ycc[None, :, :, :] - xi_t[:, None, None, :]
            r0mask = jnp.sum(Rch * Rch, axis=-1, keepdims=True) == 0
            Rch = jnp.where(r0mask, jnp.ones_like(Rch), Rch)
            if st.kernel == KERNEL_FREE_SPACE:
                R_img = Rch
            else:
                R_img = Ycc[None, :, :, :] - xi_img[:, None, None, :]
                R_img = jnp.where(r0mask, jnp.ones_like(R_img), R_img)
            G, Wn = _eval_G_Wn(_Cfg, Rch, R_img, Ncc[None])
            oV = oV + jnp.einsum("tjmab,jm,jBb->taB", G, Wcc, xvc)
            oK = oK - jnp.einsum("tjmab,jm,jBb->taB", Wn, Wcc, xkc)
            return (oV, oK), None

        init = (
            jnp.zeros((tile, d, BV), bdt),
            jnp.zeros((tile, d, BK), bdt),
        )
        (oV, oK), _ = jax.lax.scan(col_chunk, init, (Yc, Nc_, Wc, XVc, XKc))
        return oV, oK

    oV, oK = jax.lax.map(tile_rows, xi_p.reshape(n_tiles, tile, d))
    oV = oV.reshape(n_tiles * tile, d, BV)[:nr]
    oK = oK.reshape(n_tiles * tile, d, BK)[:nr]
    return (
        oV.transpose(1, 0, 2).reshape(d * nr, BV),
        oK.transpose(1, 0, 2).reshape(d * nr, BK),
    )
