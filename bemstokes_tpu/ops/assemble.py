"""Collocation assembly of the dense single-layer (V) and double-layer (K)
operators — the numerical core (reference `assemble_stokes_system`,
`source/bem_stokes.cc:2841-3000`), redesigned array-first.

Layout: for a scalar space with n nodes in dim-d space, V and K are dense
[d*n, d*n] with component-blocked indices (a*n + i, b*n + j), matching the
reference's `i + c*N/dim` layout.

Structure (instead of the reference's 5-deep element-at-a-time loops):

- smooth path: tile the (collocation-node x panel-quadrature-point) plane;
  each (row-tile, cell-chunk) step evaluates the Green's functions for the
  whole tile at once and contracts over quadrature points with the tabulated
  shape values — one einsum per chunk — then scatter-adds into the tile's
  block rows at the cells' column nodes.  Pairs where the collocation node
  belongs to the panel are masked out;
- singular path: those masked pairs are perfectly uniform — every cell
  contributes exactly nl (local-node) singular integrals, each with a fixed
  per-local-node Duffy/Telles rule — so they batch into one dense
  [Nc, nl, q_sing] evaluation and a single scatter (reference singular rules:
  `source/bem_stokes.cc:4912-4986`).

The XLA path lets XLA fuse kernel evaluation with the contraction; on a
GPU the node pass runs as one fused kernel instead (`ops.node_kernel`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.geometry import panel_geometry
from ..fem.quadrature import (
    gauss_quad,
    iterated_gauss_quad,
    singular_rule_quad,
    singular_rule_line,
    gauss_1d,
    iterated_gauss_1d,
)
from ..fem.reference_element import reference_element
from ..kernels import image_point
from ..kernels.stokeslet import stokeslet_G_Wn
from ..kernels.images import free_surface_G_Wn, no_slip_G_Wn
from ..mesh.dofs import ScalarSpace

KERNEL_FREE_SPACE = "free_space"
KERNEL_FREE_SURFACE = "free_surface"  # reference reflect_kernel=true
KERNEL_NO_SLIP = "no_slip"  # reference no_slip_kernel=true


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    dim: int = 3
    kernel: str = KERNEL_FREE_SPACE
    wall_axis: int = 1
    wall_position: float = 0.0
    quad_order: int = 4  # per-direction Gauss order for smooth panels
    # adaptive two-level quadrature: when set, the dense O(N^2) pass runs at
    # this (lower) order and only each node's `near_panels` nearest panels
    # are corrected to full `quad_order` by a gathered sparse pass — the
    # classic distance-graded BEM quadrature (uniform dense bulk +
    # fixed-size irregular correction).  None = single-pass.
    quad_order_far: int | None = None
    near_panels: int = 32
    singular_quadrature_order: int = 5
    singular_quadrature_type: str = "Mixed"  # Mixed | Duffy | Telles
    row_tile: int = 32  # collocation nodes per tile
    cell_chunk: int = 256  # panels per inner chunk
    dtype: jnp.dtype = jnp.float64
    # column reduction strategy of the XLA path (backend="jax"):
    # - "gather" (default): emits dense per-cell-slot tensors in the hot
    #   loop and maps slots -> node columns with one static incidence gather
    #   (no scatter) — the fastest XLA formulation;
    # - "scatter": the naive scatter-add path (reference semantics oracle).
    # The fused kernel backends reduce per column node instead
    # (`_assemble_rows_kernel`).
    column_mode: str = "gather"
    # tile-body backend:
    # - "auto" (default): resolved per platform by `_resolve_backend`;
    # - "jax": the XLA-fused path with the configured column_mode;
    # - "pallas": the fused per-column-node GPU kernel (`ops.node_kernel`,
    #   dim 3);
    # - "pallas_interpret": that kernel in interpreter mode (CPU tests of
    #   the exact kernel semantics).
    backend: str = "auto"
    # mixed-precision accuracy path: with dtype float64, run the O(N^2)
    # smooth BULK pass in f32 through the fused kernel and keep the
    # near-panel + singular corrections (and everything downstream) in f64.
    # The f32 bulk carries ~1e-7 relative rounding on the far-field
    # entries.  The XLA paths have no f32 bulk: `_resolve_backend` refuses
    # the pair.
    mixed_bulk: bool = False


@dataclasses.dataclass(frozen=True)
class AssemblyTables:
    """Host-precomputed static tables binding a (field space, map space) pair
    to an AssemblyConfig. All arrays are numpy; jitted code closes over them
    as constants."""

    cfg: AssemblyConfig
    n_nodes: int
    nl_fe: int
    nl_map: int
    cells_nodes_fe: np.ndarray  # [Nc, nl_fe]
    cells_nodes_map: np.ndarray  # [Nc, nl_map]
    flip_sign: np.ndarray  # [Nc]
    # smooth rule (the DENSE pass: the far rule under adaptive quadrature)
    q_weights: np.ndarray  # [nq]
    phi_map: np.ndarray  # [nq, nl_map]
    dphi_map: np.ndarray  # [nq, nl_map, cdim]
    phi_fe: np.ndarray  # [nq, nl_fe]
    # singular rules, one per local FE node, padded to a common length
    sq_weights: np.ndarray  # [nl_fe, qs]
    sphi_map: np.ndarray  # [nl_fe, qs, nl_map]
    sdphi_map: np.ndarray  # [nl_fe, qs, nl_map, cdim]
    sphi_fe: np.ndarray  # [nl_fe, qs, nl_fe]
    # node -> incident (cell, local-node) flat slots c*nl + l, padded to the
    # max valence; inc_mask zeroes the padding (column_mode="gather")
    inc_slot: np.ndarray  # [n_nodes, vmax] int32
    inc_mask: np.ndarray  # [n_nodes, vmax]
    # full-order rule for the gathered near-pair correction (None when the
    # dense pass already runs at full order; see AssemblyConfig.quad_order_far)
    hq_weights: np.ndarray | None = None
    hphi_map: np.ndarray | None = None
    hdphi_map: np.ndarray | None = None
    hphi_fe: np.ndarray | None = None


def _singular_rules(cfg: AssemblyConfig, fe_degree: int, unit_sp: np.ndarray):
    """Per-local-support-point singular rules, padded to uniform length.

    Mirrors the reference's selection (`source/bem_stokes.cc:4929-4986`):
    3D "Duffy" -> Duffy split at the support point; "Mixed" -> singular
    treatment for degree 1, iterated Gauss for higher degree; "Telles" ->
    tensor Telles.  2D: Telles for degree 1, iterated Gauss otherwise.
    """
    cdim = unit_sp.shape[1]
    rules = []
    for sp in unit_sp:
        if cdim == 2:
            kind = cfg.singular_quadrature_type
            if kind == "Telles":
                pts, wts = singular_rule_quad(
                    cfg.singular_quadrature_order, sp, kind="telles"
                )
            elif kind == "Mixed" and fe_degree > 1:
                pts, wts = iterated_gauss_quad(
                    cfg.singular_quadrature_order, max(fe_degree, 1)
                )
            else:  # Duffy, or Mixed at degree <= 1
                pts, wts = singular_rule_quad(
                    cfg.singular_quadrature_order, sp, kind="duffy"
                )
        else:
            if fe_degree > 1:
                x, w = iterated_gauss_1d(cfg.singular_quadrature_order, fe_degree)
                pts, wts = x[:, None], w
            else:
                pts, wts = singular_rule_line(cfg.singular_quadrature_order, sp)
        rules.append((pts, wts))
    qs = max(len(w) for _, w in rules)
    # pad with zero-weight points at the cell center
    center = np.full((cdim,), 0.5)
    pad_pts = np.stack(
        [
            np.concatenate([p, np.tile(center, (qs - len(w), 1))])
            for p, w in rules
        ]
    )
    pad_wts = np.stack(
        [np.concatenate([w, np.zeros(qs - len(w))]) for _, w in rules]
    )
    return pad_pts, pad_wts  # [nl_fe, qs, cdim], [nl_fe, qs]


def build_assembly_tables(
    fe_space: ScalarSpace, map_space: ScalarSpace, cfg: AssemblyConfig
) -> AssemblyTables:
    cdim = fe_space.cell_dim
    fe = reference_element(cdim, fe_space.degree)
    me = reference_element(cdim, map_space.degree)

    def rule(order):
        if cdim == 2:
            return gauss_quad(order)
        x, w = gauss_1d(order)
        return x[:, None], w

    dense_order = (
        cfg.quad_order_far if cfg.quad_order_far is not None else cfg.quad_order
    )
    q_pts, q_wts = rule(dense_order)
    hi_tables = {}
    if cfg.quad_order_far is not None:
        h_pts, h_wts = rule(cfg.quad_order)
        hi_tables = dict(
            hq_weights=h_wts,
            hphi_map=me.shape_values(h_pts),
            hdphi_map=me.shape_grads(h_pts),
            hphi_fe=fe.shape_values(h_pts),
        )

    s_pts, s_wts = _singular_rules(cfg, fe_space.degree, fe_space.unit_support_points)

    mesh = fe_space.mesh
    flip = np.where(mesh.flip_normal, -1.0, 1.0)

    # incidence lists: for each node, the flat (cell, local) slots carrying it
    # (native C++ table builder when available, numpy otherwise)
    from .._native import incidence_native

    n_nodes = fe_space.n_nodes
    native = incidence_native(fe_space.cells_nodes, n_nodes)
    if native is not None:
        inc_slot, inc_mask = native
    else:
        flat = np.asarray(fe_space.cells_nodes, dtype=np.int64).reshape(-1)
        counts = np.bincount(flat, minlength=n_nodes)
        vmax = int(counts.max()) if len(flat) else 1
        inc_slot = np.zeros((n_nodes, vmax), dtype=np.int32)
        inc_mask = np.zeros((n_nodes, vmax), dtype=np.float64)
        fill = np.zeros(n_nodes, dtype=np.int64)
        order = np.argsort(flat, kind="stable")
        for slot in order:
            j = flat[slot]
            inc_slot[j, fill[j]] = slot
            inc_mask[j, fill[j]] = 1.0
            fill[j] += 1

    return AssemblyTables(
        cfg=cfg,
        n_nodes=fe_space.n_nodes,
        nl_fe=fe_space.nl,
        nl_map=map_space.nl,
        cells_nodes_fe=np.asarray(fe_space.cells_nodes, dtype=np.int32),
        cells_nodes_map=np.asarray(map_space.cells_nodes, dtype=np.int32),
        flip_sign=flip,
        q_weights=q_wts,
        phi_map=me.shape_values(q_pts),
        dphi_map=me.shape_grads(q_pts),
        phi_fe=fe.shape_values(q_pts),
        sq_weights=s_wts,
        sphi_map=me.shape_values(s_pts),
        sdphi_map=me.shape_grads(s_pts),
        sphi_fe=fe.shape_values(s_pts),
        inc_slot=inc_slot,
        inc_mask=inc_mask,
        **hi_tables,
    )


def _eval_G_Wn(cfg: AssemblyConfig, R, R_img, normals):
    """Fused kernel dispatch: (G, W . n) with the normal contracted
    analytically — never materializes the rank-3 stresslet (the assembly hot
    path; the same values as the explicit kernels + contract_normal)."""
    if cfg.kernel == KERNEL_FREE_SPACE:
        return stokeslet_G_Wn(R, normals)
    if cfg.kernel == KERNEL_FREE_SURFACE:
        return free_surface_G_Wn(R, R_img, normals, cfg.wall_axis)
    if cfg.kernel == KERNEL_NO_SLIP:
        return no_slip_G_Wn(R, R_img, normals, cfg.wall_axis)
    raise ValueError(cfg.kernel)


def _pad_to_multiple(arr, m, axis, pad_value=0):
    size = arr.shape[axis]
    rem = (-size) % m
    if rem == 0:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return jnp.pad(arr, pad, constant_values=pad_value)


def assemble_V_K(
    euler: jnp.ndarray,  # [n_map_nodes, d]
    support_pts: jnp.ndarray,  # [n, d] FE node positions under the mapping
    tables: AssemblyTables,
    row_range: tuple[int, int] | None = None,
):
    """Assemble dense V and K over a contiguous collocation-row range.
    Returns (V, K) of shape [d*nr, d*n] (all nodes by default).

    Jit-compatible: `euler` and `support_pts` are traced; all tables are
    static constants.
    """
    n = tables.n_nodes
    if row_range is None:
        row_range = (0, n)
    r0, r1 = row_range
    node_ids = jnp.arange(r0, r1, dtype=jnp.int32)
    xi = support_pts[r0:r1]
    return assemble_rows(euler, support_pts, xi, node_ids, jnp.int32(r0), tables)


def _resolve_backend(cfg: AssemblyConfig, platform: str | None = None):
    """Resolve backend="auto" for `platform` (default: JAX's default
    backend): the fused node kernel on a GPU in 3D, the XLA path on a CPU
    and in 2D.  Any other platform is an error, as is `mixed_bulk` on a
    path without an f32 bulk pass."""
    if cfg.backend == "auto":
        platform = platform or jax.default_backend()
        if platform not in ("cpu", "gpu"):
            raise ValueError(f"no assembly backend for platform {platform!r}")
        backend = "pallas" if platform == "gpu" and cfg.dim == 3 else "jax"
        cfg = dataclasses.replace(cfg, backend=backend)
    if cfg.backend in ("pallas", "pallas_interpret") and cfg.dim != 3:
        raise ValueError("the fused node kernel is 3D-only")
    if cfg.mixed_bulk and cfg.backend == "jax":
        raise ValueError(
            "mixed_bulk runs the bulk pass in f32 through the fused node "
            "kernel, which this configuration does not use"
        )
    return cfg


def assemble_rows(
    euler: jnp.ndarray,  # [n_map_nodes, d]
    support_pts: jnp.ndarray,  # [n, d] all FE node positions (columns)
    xi: jnp.ndarray,  # [nr, d] collocation points of the rows to assemble
    node_ids: jnp.ndarray,  # [nr] global scalar node ids of those rows
    r0,  # traced or static scalar: first global node id of this row block
    tables: AssemblyTables,
):
    """Row-block assembly kernel: builds (V, K) [d*nr, d*n] for an arbitrary
    contiguous block of collocation nodes.  This is the shard-local body of
    the row-partitioned distributed assembly (the reference's
    `this_cpu_set.is_element(i)` masking, `source/bem_stokes.cc:2875-2877`,
    turned into an explicit row slab per device)."""
    cfg = _resolve_backend(tables.cfg)
    if cfg is not tables.cfg:
        tables = dataclasses.replace(tables, cfg=cfg)
    d = cfg.dim
    n = tables.n_nodes
    dt = cfg.dtype
    euler = euler.astype(dt)
    support_pts = support_pts.astype(dt)
    xi = xi.astype(dt)
    nr = xi.shape[0]

    cells_map = jnp.asarray(tables.cells_nodes_map)
    cells_fe = jnp.asarray(tables.cells_nodes_fe)
    Nc = tables.cells_nodes_fe.shape[0]
    nl = tables.nl_fe

    # ---- smooth panel geometry ----
    xq, normals, jxw = panel_geometry(
        euler[cells_map],
        jnp.asarray(tables.phi_map, dt),
        jnp.asarray(tables.dphi_map, dt),
        jnp.asarray(tables.q_weights, dt),
        jnp.asarray(tables.flip_sign, dt),
        ambient_dim=d,
    )  # [Nc, nq, d], [Nc, nq, d], [Nc, nq]
    phi_fe = jnp.asarray(tables.phi_fe, dt)  # [nq, nl]

    if cfg.backend in ("pallas", "pallas_interpret"):
        return _assemble_rows_kernel(
            euler, support_pts, xi, node_ids, r0, tables, xq, normals, jxw
        )

    tile = min(cfg.row_tile, nr)
    xi_p = _pad_to_multiple(xi, tile, 0)
    ids_p = _pad_to_multiple(node_ids, tile, 0, pad_value=-1)
    n_tiles = xi_p.shape[0] // tile

    cc = min(cfg.cell_chunk, Nc)
    # pad panels with far-away points so padded pairs stay finite (their
    # JxW pads to zero, but 0 * inf would poison the contraction with NaNs)
    xq_p = _pad_to_multiple(xq, cc, 0, pad_value=1e8)
    nrm_p = _pad_to_multiple(normals, cc, 0)
    jxw_p = _pad_to_multiple(jxw, cc, 0)  # zero weights on padded cells
    cfe_p = _pad_to_multiple(cells_fe, cc, 0, pad_value=-1)
    n_chunks = xq_p.shape[0] // cc
    nq = xq.shape[1]

    xq_c = xq_p.reshape(n_chunks, cc, nq, d)
    nrm_c = nrm_p.reshape(n_chunks, cc, nq, d)
    jxw_c = jxw_p.reshape(n_chunks, cc, nq)
    cfe_c = cfe_p.reshape(n_chunks, cc, nl)

    inc_slot = jnp.asarray(tables.inc_slot)  # [n, vmax]
    inc_mask = jnp.asarray(tables.inc_mask, dt)  # [n, vmax]
    n_slots = n_chunks * cc * nl

    def pair_blocks(xi_t, ids_t, xqc, nrmc, jxwc, colsc):
        """Per-chunk local blocks (V, K) [cc, nl, tile, d, d], with the
        singular (own-cell) pairs masked out."""
        # mask panels that carry this collocation node (singular pairs)
        sing = jnp.any(
            ids_t[:, None, None] == colsc[None, :, :], axis=-1
        )  # [t, cc]
        R = xqc[None, :, :, :] - xi_t[:, None, None, :]  # [t, cc, nq, d]
        # masked pairs can hit R == 0 exactly (e.g. Q2 center node vs an
        # odd-order Gauss point); substitute a dummy offset so the kernel
        # stays finite — their contribution is zeroed below anyway
        R = jnp.where(sing[:, :, None, None], jnp.ones_like(R), R)
        if cfg.kernel == KERNEL_FREE_SPACE:
            R_img = R
        else:
            xi_img = image_point(xi_t, cfg.wall_axis, cfg.wall_position)
            R_img = xqc[None, :, :, :] - xi_img[:, None, None, :]
            R_img = jnp.where(sing[:, :, None, None], jnp.ones_like(R_img), R_img)
        G, Wn = _eval_G_Wn(cfg, R, R_img, nrmc[None, :, :, :])
        # fold JxW into the shape values (the singular mask factorizes over
        # q, so it applies after the contraction — cheaper than masking w)
        wphi = jxwc[:, :, None] * phi_fe[None, :, :]  # [cc, nq, nl]
        keep = (~sing).astype(dt).T[:, None, :, None, None]  # [cc, 1, t, 1, 1]
        Vloc = jnp.einsum("tcqab,cql->cltab", G, wphi) * keep
        # minus sign: exterior problem (reference `:2941-2947`)
        Kloc = -jnp.einsum("tcqab,cql->cltab", Wn, wphi) * keep
        return Vloc, Kloc

    def tile_rows(xi_t, ids_t):
        """Assemble ([tile, d, d*n], [tile, d, d*n]) block rows for one
        collocation tile.

        column_mode="gather" (default): the chunk scan emits dense per-cell
        column-slot tensors (a plain stacked write), and one static incidence
        gather-reduce maps slot (c, l) -> node column j = cells_fe[c, l].
        No scatter anywhere.
        """
        if cfg.column_mode == "gather":

            def chunk_step(_, inp):
                Vloc, Kloc = pair_blocks(xi_t, ids_t, *inp)
                return None, (
                    Vloc.reshape(cc * nl, tile, d, d),
                    Kloc.reshape(cc * nl, tile, d, d),
                )

            _, (Vys, Kys) = jax.lax.scan(
                chunk_step, None, (xq_c, nrm_c, jxw_c, cfe_c)
            )
            Vcell = Vys.reshape(n_slots, tile, d, d)
            Kcell = Kys.reshape(n_slots, tile, d, d)
            m = inc_mask[:, :, None, None, None]
            Vt = (Vcell[inc_slot] * m).sum(axis=1)  # [n, tile, d, d]
            Kt = (Kcell[inc_slot] * m).sum(axis=1)
            rowV = Vt.transpose(1, 2, 3, 0).reshape(tile, d, d * n)
            rowK = Kt.transpose(1, 2, 3, 0).reshape(tile, d, d * n)
            return rowV, rowK

        # ---- column_mode="scatter": reference semantics oracle ----
        def chunk_step(carry, inp):
            rowV, rowK = carry
            xqc, nrmc, jxwc, colsc = inp
            Vloc, Kloc = pair_blocks(xi_t, ids_t, xqc, nrmc, jxwc, colsc)
            # scatter columns: col j = b*n + colsc
            colidx = (
                jnp.arange(d, dtype=jnp.int32)[:, None, None] * n
                + colsc[None, :, :]
            ).reshape(-1)  # [d*cc*nl]
            Vblk = Vloc.transpose(2, 3, 4, 0, 1).reshape(tile, d, d * cc * nl)
            Kblk = Kloc.transpose(2, 3, 4, 0, 1).reshape(tile, d, d * cc * nl)
            rowV = rowV.at[:, :, colidx].add(Vblk)
            rowK = rowK.at[:, :, colidx].add(Kblk)
            return (rowV, rowK), None

        init = (
            jnp.zeros((tile, d, d * n), dt),
            jnp.zeros((tile, d, d * n), dt),
        )
        (rowV, rowK), _ = jax.lax.scan(
            chunk_step, init, (xq_c, nrm_c, jxw_c, cfe_c)
        )
        return rowV, rowK

    xi_tiles = xi_p.reshape(n_tiles, tile, d)
    ids_tiles = ids_p.reshape(n_tiles, tile)
    rowsV, rowsK = jax.lax.map(lambda t: tile_rows(*t), (xi_tiles, ids_tiles))
    # [n_tiles, tile, d, d*n] -> [d, nr, d*n] -> [d*nr, d*n]
    rowsV = rowsV.reshape(n_tiles * tile, d, d * n)[:nr].transpose(1, 0, 2)
    rowsK = rowsK.reshape(n_tiles * tile, d, d * n)[:nr].transpose(1, 0, 2)
    V = rowsV.reshape(d * nr, d * n)
    K = rowsK.reshape(d * nr, d * n)

    # ---- near-pair upgrade to full quadrature order (adaptive mode) ----
    V, K = _add_near_corrections(V, K, euler, support_pts, xi, node_ids, tables, nr)
    # ---- singular path (scattered with drop-mode into this row block) ----
    V, K = _add_singular_rows(V, K, euler, support_pts, tables, r0, nr)
    return V, K


def node_column_samples(tables: AssemblyTables, xq, normals, jxw):
    """Per-column-node quadrature sample tables for the node sweep: gather
    each node's incident panel quadrature (points, unit normals,
    phi*JxW-weighted shape values) ONCE per frame.  Returns
    (Yj [n, m, d], Nj [n, m, d], Wj [n, m], vmax, nq) with m = vmax*nq and
    zero weights on incidence padding.  Shared by the fused assembly kernel
    and the matrix-free sweep (`ops.matfree_node`)."""
    cfg = tables.cfg
    d = cfg.dim
    n = tables.n_nodes
    dt = cfg.dtype
    nq = xq.shape[1]
    nl = tables.nl_fe
    phi_fe = jnp.asarray(tables.phi_fe, dt)  # [nq, nl]
    wphi = jxw[:, :, None] * phi_fe[None]  # [Nc, nq, nl]

    inc_slot = jnp.asarray(tables.inc_slot)  # [n, vmax]
    inc_mask = jnp.asarray(tables.inc_mask, dt)
    cell_of = inc_slot // nl
    loc_of = inc_slot % nl
    vmax = inc_slot.shape[1]
    m = vmax * nq

    Yj = xq[cell_of].reshape(n, m, d)  # [n, m, d]
    Nj = normals[cell_of].reshape(n, m, d)
    Wj = jnp.take_along_axis(
        wphi[cell_of], loc_of[:, :, None, None], axis=3
    )[..., 0]
    Wj = (Wj * inc_mask[:, :, None]).reshape(n, m)
    return Yj, Nj, Wj, vmax, nq


def node_sample_cells(tables: AssemblyTables, nq: int):
    """[n, vmax*nq, nl] node ids of the cell each node-sweep sample lies on
    (sample order of `node_column_samples`); the fused kernel masks a row's
    own cells with it."""
    cell_of = jnp.asarray(tables.inc_slot) // tables.nl_fe  # [n, vmax]
    C = jnp.asarray(tables.cells_nodes_fe)[cell_of]  # [n, vmax, nl]
    return jnp.repeat(C, nq, axis=1)


def _assemble_rows_kernel(
    euler, support_pts, xi, node_ids, r0, tables: AssemblyTables, xq, normals, jxw
):
    """Column-centric dense pass through the fused kernel: gather each
    column node's incident panel quadrature (points, normals, JxW-weighted
    shape value) ONCE, then run a pure pairwise interaction sweep (row tile x
    column chunk) with no gather/scatter inside the hot loop.  The kernel
    masks a row's own cells, which the singular path then adds
    (`ops.node_kernel`)."""
    from .node_kernel import node_blocks

    cfg = tables.cfg
    dt = cfg.dtype
    nr = xi.shape[0]
    Yj, Nj, Wj, _, nq = node_column_samples(tables, xq, normals, jxw)
    # mixed-precision: f32 bulk sweep under an f64 assembly (the corrections
    # below stay f64); plain runs keep the assembly dtype
    bulk_dt = jnp.float32 if cfg.mixed_bulk else dt
    V, K = node_blocks(
        xi.astype(bulk_dt),
        node_ids,
        Yj.astype(bulk_dt),
        Nj.astype(bulk_dt),
        Wj.astype(bulk_dt),
        node_sample_cells(tables, nq),
        kernel=cfg.kernel,
        wall_axis=cfg.wall_axis,
        wall_position=cfg.wall_position,
        interpret=cfg.backend == "pallas_interpret",
    )
    V, K = V.astype(dt), K.astype(dt)
    V, K = _add_near_corrections(V, K, euler, support_pts, xi, node_ids, tables, nr)
    return _add_singular_rows(V, K, euler, support_pts, tables, r0, nr)


def _pair_local_blocks(cfg, euler_cells, flip, xi_rows, keep, rule, dt):
    """Local (V, K) blocks [RC, Kn, d, d, nl] for gathered (row, panel)
    pairs, evaluated on one quadrature rule.

    euler_cells [RC, Kn, nlm, d]; xi_rows [RC, d]; keep [RC, Kn] zeroes
    masked (singular) pairs; rule = (weights [q], phi_map [q, nlm],
    dphi_map [q, nlm, cdim], phi_fe [q, nl])."""
    d = cfg.dim
    w, phi_map, dphi_map, phi_fe = (jnp.asarray(t, dt) for t in rule)
    xq = jnp.einsum("qm,rkmd->rkqd", phi_map, euler_cells)
    J = jnp.einsum("qmc,rkmd->rkqdc", dphi_map, euler_cells)
    if d == 3:
        nrm = jnp.cross(J[..., 0], J[..., 1])
    else:
        t = J[..., 0]
        nrm = jnp.stack([-t[..., 1], t[..., 0]], axis=-1)
    jac = jnp.linalg.norm(nrm, axis=-1)
    normals = nrm / jac[..., None] * flip[..., None, None]
    jxw = jac * w[None, None, :]  # [RC, Kn, q]
    R = xq - xi_rows[:, None, None, :]
    wz = keep[..., None, None] == 0
    R = jnp.where(wz, jnp.ones_like(R), R)
    if cfg.kernel == KERNEL_FREE_SPACE:
        R_img = R
    else:
        xi_img = image_point(xi_rows, cfg.wall_axis, cfg.wall_position)
        R_img = jnp.where(wz, jnp.ones_like(R), xq - xi_img[:, None, None, :])
    G, Wn = _eval_G_Wn(cfg, R, R_img, normals)
    keep_l = keep[:, :, None, None, None]
    Vloc = jnp.einsum("rkqab,rkq,qm->rkabm", G, jxw, phi_fe) * keep_l
    Kloc = -jnp.einsum("rkqab,rkq,qm->rkabm", Wn, jxw, phi_fe) * keep_l
    return Vloc, Kloc


def _add_near_corrections(V, K, euler, support_pts, xi, node_ids, tables, nr):
    """Upgrade each block row's `near_panels` nearest panels from the dense
    far rule to the full `quad_order` rule: scatter-add (hi - lo) local
    blocks.  No-op unless adaptive quadrature is enabled."""
    coo = _near_coo(euler, support_pts, xi, node_ids, tables, nr)
    if coo is None:
        return V, K
    ri, ci, dV, dK = coo
    V = V.at[ri, ci].add(dV, mode="drop")
    K = K.at[ri, ci].add(dK, mode="drop")
    return V, K


def _near_coo(euler, support_pts, xi, node_ids, tables, nr):
    """COO triplets (ri, ci, dV, dK) of the near-pair quadrature upgrade —
    the sparse delta both the materialized scatter above and the
    matrix-free operator (`ops.matfree`) apply.  Returns None unless
    adaptive quadrature is enabled.

    This is the distance-graded quadrature the reference approximates with a
    single global order — here the dense pass runs cheap and uniform while a
    fixed-size gathered pass restores full accuracy where the kernel is
    steep (own-cell singular pairs stay with the dedicated singular path)."""
    cfg = tables.cfg
    if tables.hq_weights is None:
        return None
    d = cfg.dim
    n = tables.n_nodes
    dt = cfg.dtype
    cells_map = jnp.asarray(tables.cells_nodes_map)
    cells_fe = jnp.asarray(tables.cells_nodes_fe)
    Nc, nl = tables.cells_nodes_fe.shape
    Kn = min(cfg.near_panels, Nc)
    flip_all = jnp.asarray(tables.flip_sign, dt)

    centers = euler[cells_map].mean(axis=1).astype(dt)  # [Nc, d]
    d2 = jnp.sum(
        (xi[:, None, :].astype(dt) - centers[None, :, :]) ** 2, axis=-1
    )  # [nr, Nc]
    _, near = jax.lax.top_k(-d2, Kn)  # [nr, Kn] panel indices
    near = near.astype(jnp.int32)

    lo_rule = (tables.q_weights, tables.phi_map, tables.dphi_map, tables.phi_fe)
    hi_rule = (tables.hq_weights, tables.hphi_map, tables.hdphi_map, tables.hphi_fe)

    RC = 256
    nr_real = xi.shape[0]
    xi_p = _pad_to_multiple(xi.astype(dt), RC, 0, pad_value=1e8)
    ids_p = _pad_to_multiple(node_ids, RC, 0, pad_value=-1)
    near_p = _pad_to_multiple(near, RC, 0)
    n_rchunks = xi_p.shape[0] // RC
    rows_p = _pad_to_multiple(
        jnp.arange(nr_real, dtype=jnp.int32), RC, 0, pad_value=jnp.int32(d * nr + d * n)
    )

    def chunk(args):
        xi_c, ids_c, near_c, rows_c = args  # [RC, d], [RC], [RC, Kn], [RC]
        ec = euler[cells_map[near_c]].astype(dt)  # [RC, Kn, nlm, d]
        flip = flip_all[near_c]
        cols = cells_fe[near_c]  # [RC, Kn, nl]
        # mask singular (own-cell) pairs and padded rows
        sing = jnp.any(cols == ids_c[:, None, None], axis=-1)  # [RC, Kn]
        keep = ((~sing) & (ids_c[:, None] >= 0)).astype(dt)
        Vh, Kh = _pair_local_blocks(cfg, ec, flip, xi_c, keep, hi_rule, dt)
        Vl, Kl = _pair_local_blocks(cfg, ec, flip, xi_c, keep, lo_rule, dt)
        dV = Vh - Vl  # [RC, Kn, d, d, nl]
        dK = Kh - Kl
        # scatter rows (a, row) local; cols (b, cells_fe) global
        big = jnp.int32(d * nr + d * n)
        row_idx = jnp.where(
            rows_c[:, None] < nr,
            jnp.arange(d, dtype=jnp.int32)[None, :] * nr + rows_c[:, None],
            big,
        )  # [RC, d]
        col_idx = (
            jnp.arange(d, dtype=jnp.int32)[None, None, :, None] * n
            + cols[:, :, None, :]
        )  # [RC, Kn, d, nl]
        ri = jnp.broadcast_to(
            row_idx[:, None, :, None, None], (RC, Kn, d, d, nl)
        ).reshape(-1)
        ci = jnp.broadcast_to(
            col_idx[:, :, None, :, :], (RC, Kn, d, d, nl)
        ).reshape(-1)
        return ri, ci, dV.reshape(-1), dK.reshape(-1)

    ris, cis, dVs, dKs = jax.lax.map(
        chunk,
        (
            xi_p.reshape(n_rchunks, RC, d),
            ids_p.reshape(n_rchunks, RC),
            near_p.reshape(n_rchunks, RC, Kn),
            rows_p.reshape(n_rchunks, RC),
        ),
    )
    return (
        ris.reshape(-1),
        cis.reshape(-1),
        dVs.reshape(-1),
        dKs.reshape(-1),
    )


def _add_singular_rows(
    V, K, euler, support_pts, tables: AssemblyTables, r0, nr, subtract_smooth=False
):
    """Scatter the singular COO triplets into dense (V, K)."""
    ri, ci, dV, dK = _singular_coo(
        euler, support_pts, tables, r0, nr, subtract_smooth=subtract_smooth
    )
    V = V.at[ri, ci].add(dV, mode="drop")
    K = K.at[ri, ci].add(dK, mode="drop")
    return V, K


def _singular_coo(
    euler, support_pts, tables: AssemblyTables, r0, nr, subtract_smooth=False
):
    """Batched singular-pair integrals as COO triplets (ri, ci, dV, dK): for
    every (cell c, local node l) the collocation point is the cell's own node
    and the rule is the precomputed per-local-node singular rule.
    Contributions whose row node falls outside [r0, r0+nr) get an
    out-of-range row index (callers scatter with mode="drop"; the
    matrix-free operator masks them).

    With `subtract_smooth` (the matrix-free node sweep, `ops.matfree_node`)
    the dense pass already added an own-cell contribution with the smooth
    rule; this path adds (singular - smooth) so the net own-cell value is
    the singular-rule integral."""
    cfg = tables.cfg
    d = cfg.dim
    n = tables.n_nodes
    dt = cfg.dtype
    cells_map = jnp.asarray(tables.cells_nodes_map)
    cells_fe = jnp.asarray(tables.cells_nodes_fe)
    Nc, nl = tables.cells_nodes_fe.shape
    qs = tables.sq_weights.shape[1]

    euler_cells = euler[cells_map]  # [Nc, nlm, d]
    sphi_map = jnp.asarray(tables.sphi_map, dt)  # [nl, qs, nlm]
    sdphi_map = jnp.asarray(tables.sdphi_map, dt)  # [nl, qs, nlm, cdim]
    sq_w = jnp.asarray(tables.sq_weights, dt)  # [nl, qs]
    sphi_fe = jnp.asarray(tables.sphi_fe, dt)  # [nl, qs, nl]

    xq = jnp.einsum("lqm,cmd->clqd", sphi_map, euler_cells)  # [Nc, nl, qs, d]
    J = jnp.einsum("lqmk,cmd->clqdk", sdphi_map, euler_cells)
    if d == 3:
        nrm = jnp.cross(J[..., 0], J[..., 1])
    else:
        t = J[..., 0]
        # 2D: left rotation of the tangent (outward for the reference's
        # clockwise-parametrized circle meshes, matching deal.II)
        nrm = jnp.stack([-t[..., 1], t[..., 0]], axis=-1)
    jac = jnp.linalg.norm(nrm, axis=-1)
    flip = jnp.asarray(tables.flip_sign, dt)[:, None, None]
    normals = nrm / jac[..., None] * flip[..., None]
    jxw = jac * sq_w[None, :, :]  # [Nc, nl, qs]

    xi = support_pts[cells_fe]  # [Nc, nl, d] collocation points
    R = xq - xi[:, :, None, :]
    # zero-weight padding points sit at the cell center, which coincides with
    # the center collocation node for Q2 — substitute a finite dummy offset
    wz = (jxw == 0)[..., None]
    R = jnp.where(wz, jnp.ones_like(R), R)
    if cfg.kernel == KERNEL_FREE_SPACE:
        R_img = R
    else:
        xi_img = image_point(xi, cfg.wall_axis, cfg.wall_position)
        R_img = jnp.where(wz, jnp.ones_like(R), xq - xi_img[:, :, None, :])
    G, Wn = _eval_G_Wn(cfg, R, R_img, normals)  # [Nc, nl, qs, d, d]

    Vloc = jnp.einsum("clqab,clq,lqm->clabm", G, jxw, sphi_fe)
    Kloc = -jnp.einsum("clqab,clq,lqm->clabm", Wn, jxw, sphi_fe)

    if subtract_smooth:
        # remove the dense pass's own-cell smooth-rule contribution: same
        # smooth rule (tables.q_weights = the dense rule), same dummy-offset
        # convention for exact R == 0, evaluated per (cell, row-local-node)
        from ..fem.geometry import panel_geometry

        xq_s, normals_s, jxw_s = panel_geometry(
            euler_cells,
            jnp.asarray(tables.phi_map, dt),
            jnp.asarray(tables.dphi_map, dt),
            jnp.asarray(tables.q_weights, dt),
            jnp.asarray(tables.flip_sign, dt),
            ambient_dim=d,
        )  # [Nc, nq, ...]
        wphi_s = jxw_s[:, :, None] * jnp.asarray(tables.phi_fe, dt)[None]
        R2 = xq_s[:, None, :, :] - xi[:, :, None, :]  # [Nc, nl, nq, d]
        r0m = jnp.sum(R2 * R2, axis=-1, keepdims=True) == 0
        R2 = jnp.where(r0m, jnp.ones_like(R2), R2)
        if cfg.kernel == KERNEL_FREE_SPACE:
            R2_img = R2
        else:
            R2_img = xq_s[:, None, :, :] - xi_img[:, :, None, :]
            R2_img = jnp.where(r0m, jnp.ones_like(R2_img), R2_img)
        G2, Wn2 = _eval_G_Wn(
            cfg, R2, R2_img, normals_s[:, None]
        )  # [Nc, nl, nq, d, d]
        Vloc = Vloc - jnp.einsum("clqab,cqm->clabm", G2, wphi_s)
        Kloc = Kloc + jnp.einsum("clqab,cqm->clabm", Wn2, wphi_s)

    # scatter: row (a, cells_fe[c, l] - r0) local to this shard; col
    # (b, cells_fe[c, m]) global.  Out-of-shard rows get an out-of-bounds
    # index and are dropped by the scatter.
    local_node = cells_fe - r0  # [Nc, nl]
    in_shard = (local_node >= 0) & (local_node < nr)
    big = jnp.int32(d * nr + d * n)  # any index >= d*nr drops
    row_idx = jnp.where(
        in_shard[:, :, None],
        jnp.arange(d, dtype=jnp.int32)[None, None, :] * nr + local_node[:, :, None],
        big,
    )  # [Nc, nl, d]
    col_idx = (
        jnp.arange(d, dtype=jnp.int32)[None, :, None] * n
        + cells_fe[:, None, :]
    )  # [Nc, d, nl(m)]
    ri = jnp.broadcast_to(
        row_idx[:, :, :, None, None], (Nc, nl, d, d, nl)
    ).reshape(-1)
    ci = jnp.broadcast_to(
        col_idx[:, None, None, :, :], (Nc, nl, d, d, nl)
    ).reshape(-1)
    return ri, ci, Vloc.reshape(-1), Kloc.reshape(-1)
