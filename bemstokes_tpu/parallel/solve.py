"""Sharded end-to-end frame step: row-partitioned assembly, slab-layout
operator corrections, implicit monolithic matvec, block-Jacobi-LU
preconditioned GMRES — the multi-chip "training step" of the framework.

This is the distributed counterpart of `StokesBEMProblem._pipeline` +
`solve_frame`: same math, with the dense operators living sharded
P('rows', None) on a 1-D device mesh and every correction applied in slab
layout (no device ever holds the full matrix).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .sharded import (
    padded_rows,
    sharded_assemble,
    flat_to_slab,
    slab_to_flat,
)
from ..la.gmres import gmres
from ..ops.monolithic import operator_column_mask
from ..ops.corrections import tangential_projector
from ..physics.rigid import (
    build_mass_operator,
    surface_mass_and_com,
    rigid_modes,
    normal_vector_l2,
    flatten,
    unflatten,
)


def slab_rank1_update(A_slab, u_slab, v_rep, mesh: Mesh):
    """A += outer(u, v) with u row-sharded (slab) and v replicated."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None), P("rows"), P()),
        out_specs=P("rows", None),
        check_vma=False,
    )
    def _upd(A_loc, u_loc, v):
        return A_loc + jnp.outer(u_loc, v)

    return _upd(A_slab, u_slab, v_rep)


def slab_solid_angle_correction(
    K_slab,
    n_nodes,
    dim,
    mesh: Mesh,
    use_internal_alpha=False,
    component_labels=None,
    component_alpha=None,
    return_check=False,
):
    """Distributed version of ops.corrections.k_solid_angle_correction: each
    device corrects the diagonal blocks of its own rows.  With
    `component_labels`/`component_alpha` the row sums are restricted to each
    node's own connected component (see the single-chip docstring: the
    constant-field identity only holds on closed boundaries).  With
    `return_check` also returns the post-correction versor check [d]
    (max restricted row sum per component, computed from the in-hand row
    blocks — the single-chip diagnostic without extra matvecs)."""
    n = n_nodes
    d = dim
    _, nloc = padded_rows(n, mesh)
    lab = None if component_labels is None else jnp.asarray(component_labels)
    alp = (
        None
        if component_alpha is None
        else jnp.asarray(component_alpha, K_slab.dtype)
    )

    def _corr(K_loc):  # [d*nloc, d*n]
        r0 = jax.lax.axis_index("rows").astype(jnp.int32) * nloc
        i = jnp.arange(nloc, dtype=jnp.int32)
        node = r0 + i  # global node ids of this slab
        valid = node < n
        if lab is None:
            C = jnp.stack(
                [K_loc[:, b * n : (b + 1) * n].sum(axis=1) for b in range(d)],
                axis=-1,
            )  # [d*nloc, d]
            alpha = 1.0
        else:
            row_lab = lab[jnp.clip(node, 0, n - 1)]  # [nloc]
            same = (
                jnp.tile(row_lab, d)[:, None] == lab[None, :]
            )  # [d*nloc, n]
            C = jnp.stack(
                [
                    (K_loc[:, b * n : (b + 1) * n] * same).sum(axis=1)
                    for b in range(d)
                ],
                axis=-1,
            )
            alpha = alp[jnp.clip(node, 0, n - 1)]  # [nloc]
        rows = (
            jnp.arange(d, dtype=jnp.int32)[:, None, None] * nloc + i[None, None, :]
        )  # [d,1,nloc]
        big = jnp.int32(d * nloc + d * n)
        cols = jnp.where(
            valid[None, None, :],
            jnp.arange(d, dtype=jnp.int32)[None, :, None] * n + node[None, None, :],
            big,
        )  # [1,d,nloc]
        rows_b = jnp.broadcast_to(rows, (d, d, nloc))
        cols_b = jnp.broadcast_to(cols, (d, d, nloc))
        Cab = C.reshape(d, nloc, d)  # [a, i, b]
        vals = -Cab.transpose(0, 2, 1) + jnp.eye(d, dtype=K_loc.dtype)[
            :, :, None
        ] * (
            (alpha - 1.0 if use_internal_alpha else alpha)
            if lab is not None
            else (0.0 if use_internal_alpha else 1.0)
        )
        K_new = K_loc.at[rows_b.ravel(), cols_b.ravel()].add(
            vals.ravel(), mode="drop"
        )
        if not return_check:
            return K_new
        # post-correction restricted row sums of the corrected rows
        if lab is None:
            C2 = jnp.stack(
                [K_new[:, b * n : (b + 1) * n].sum(axis=1) for b in range(d)],
                axis=-1,
            )
        else:
            C2 = jnp.stack(
                [
                    (K_new[:, b * n : (b + 1) * n] * same).sum(axis=1)
                    for b in range(d)
                ],
                axis=-1,
            )
        vmask = jnp.tile(valid, d)[:, None]
        check = jax.lax.pmax(
            jnp.max(jnp.abs(jnp.where(vmask, C2, 0.0)), axis=0), "rows"
        )  # [d], replicated
        return K_new, check

    wrapped = shard_map(
        _corr,
        mesh=mesh,
        in_specs=(P("rows", None),),
        out_specs=(P("rows", None), P()) if return_check else P("rows", None),
        check_vma=False,
    )
    return wrapped(K_slab)


def slab_apply_hanging_constraints(A_slab, hc, n_nodes, dim, mesh: Mesh):
    """Distributed `mesh.constraints.apply_hanging_constraints_monolithic`:
    each device overwrites the d constrained rows of the hanging nodes it
    owns with the interpolation identity u_h - sum_k w_k u_{m_k} = 0
    (reference constrained-row assembly `source/bem_stokes.cc:2970-2995`,
    woven through the distributed row maps `:1661-1712`).  Rows live in slab
    layout, columns in the flat component-blocked layout; the constraint
    tables close over as dense per-node arrays so the per-device update is a
    fixed-shape masked scatter (no ragged work)."""
    if hc.n == 0:
        return A_slab
    n, d = n_nodes, dim
    _, nloc = padded_rows(n, mesh)
    M = hc.masters.shape[1]
    import numpy as _np

    is_slave = _np.zeros(n, bool)
    is_slave[hc.slaves] = True
    mast = _np.zeros((n, M), _np.int32)
    mast[hc.slaves] = hc.masters
    wts = _np.zeros((n, M))
    wts[hc.slaves] = hc.weights
    is_slave_j = jnp.asarray(is_slave)
    mast_j = jnp.asarray(mast)
    wts_j = jnp.asarray(wts, A_slab.dtype)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None),),
        out_specs=P("rows", None),
        check_vma=False,
    )
    def _apply(A_loc):  # [d*nloc, d*n]
        r0 = jax.lax.axis_index("rows").astype(jnp.int32) * nloc
        i = jnp.arange(nloc, dtype=jnp.int32)
        node = r0 + i  # global node ids of this slab
        nc = jnp.clip(node, 0, n - 1)
        sl = is_slave_j[nc] & (node < n)  # [nloc]
        row_sl = jnp.tile(sl, d)  # local rows are (a, i) -> a*nloc + i
        A_new = jnp.where(row_sl[:, None], 0.0, A_loc)
        a = jnp.arange(d, dtype=jnp.int32)
        rows = a[:, None] * nloc + i[None, :]  # [d, nloc]
        big = jnp.int32(d * n)  # out-of-bounds column -> dropped scatter
        cols_id = jnp.where(sl[None, :], a[:, None] * n + node[None, :], big)
        A_new = A_new.at[rows.ravel(), cols_id.ravel()].add(
            jnp.ones((d * nloc,), A_loc.dtype), mode="drop"
        )
        mk = mast_j[nc]  # [nloc, M]
        wk = wts_j[nc]  # [nloc, M]
        cols_m = jnp.where(
            sl[None, :, None], a[:, None, None] * n + mk[None, :, :], big
        )  # [d, nloc, M]
        rows_m = jnp.broadcast_to(rows[:, :, None], (d, nloc, M))
        vals_m = jnp.broadcast_to(-wk[None, :, :], (d, nloc, M)).astype(
            A_loc.dtype
        )
        return A_new.at[rows_m.ravel(), cols_m.ravel()].add(
            vals_m.ravel(), mode="drop"
        )

    return _apply(A_slab)


def slab_block_jacobi_lu(A_slab, tail_rows, n_nodes, dim, n_rigid, mesh: Mesh):
    """Factor each device's diagonal block (its rows x its columns) for a
    block-Jacobi preconditioner; the rigid tail gets the identity.  Returns
    (lu, piv) stacked over devices, sharded P('rows')."""
    n = n_nodes
    d = dim
    _, nloc = padded_rows(n, mesh)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None),),
        out_specs=(P("rows", None), P("rows")),
        check_vma=False,
    )
    def _factor(A_loc):  # [d*nloc, d*n]
        r0 = jax.lax.axis_index("rows").astype(jnp.int32) * nloc
        # own columns: for each component b, the slice [b*n + r0, +nloc)
        blocks = [
            jax.lax.dynamic_slice(
                A_loc, (0, b * n), (d * nloc, n)
            )  # component block
            for b in range(d)
        ]
        own = jnp.concatenate(
            [
                jax.lax.dynamic_slice(blk, (jnp.int32(0), r0), (d * nloc, nloc))
                for blk in blocks
            ],
            axis=1,
        )  # [d*nloc, d*nloc]
        # padded rows/cols: put 1 on the diagonal to keep the block regular
        node = r0 + jnp.arange(nloc, dtype=jnp.int32)
        pad = jnp.tile(node >= n, d)
        own = jnp.where(
            (pad[:, None] | pad[None, :]),
            jnp.eye(d * nloc, dtype=A_loc.dtype) * 1.0,
            own,
        )
        lu, piv = jax.scipy.linalg.lu_factor(own)
        return lu, piv

    return _factor(A_slab)


def slab_block_jacobi_apply(lu_slab, piv_slab, v_slab, mesh: Mesh):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None), P("rows"), P("rows")),
        out_specs=P("rows"),
        check_vma=False,
    )
    def _apply(lu, piv, v):
        return jax.scipy.linalg.lu_solve((lu, piv), v)

    return _apply(lu_slab, piv_slab, v_slab)


def slab_diagonal(A_slab, n_nodes, dim, mesh: Mesh):
    """Each device's diagonal entries of its own rows (slab-ordered,
    sharded P('rows')) — the distributed Jacobi preconditioner."""
    n, d = n_nodes, dim
    _, nloc = padded_rows(n, mesh)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None),),
        out_specs=P("rows"),
        check_vma=False,
    )
    def _diag(A_loc):  # [d*nloc, d*n]
        r0 = jax.lax.axis_index("rows").astype(jnp.int32) * nloc
        rows = jnp.arange(d * nloc, dtype=jnp.int32)
        a, i = rows // nloc, rows % nloc
        node = r0 + i
        cols = a * n + node
        dg = A_loc[rows, jnp.clip(cols, 0, d * n - 1)]
        return jnp.where(node < n, dg, jnp.ones_like(dg))

    return _diag(A_slab)


def _build_sharded_operators(problem, dmesh: Mesh, euler, return_check=False):
    """Geometry, rigid modes, L2 normals, sharded assembly and the two slab
    operator corrections — the shared traced prefix of the monolithic and
    resistance distributed steps (the distributed analog of the first half
    of `StokesBEMProblem._pipeline`)."""
    tables = problem.tables
    cfg = problem.cfg
    d, n = problem.dim, problem.n
    dt_num = tables.cfg.dtype
    euler = euler.astype(dt_num)
    mass_op, (xq, normals_q, jxw) = build_mass_operator(euler, tables)
    body_nodes = jnp.asarray(problem.body_node_mask, dt_num)
    body_cells = jnp.asarray(problem.body_cell_mask, dt_num)
    mass_body, com_body = surface_mass_and_com(xq, jxw, body_cells)
    pole = problem.force_pole_point(com_body)
    from ..fem.geometry import support_points as support_points_fn

    sp = support_points_fn(euler, problem.map_space, problem.fe_space).astype(
        dt_num
    )
    N = rigid_modes(sp, pole, node_mask=body_nodes)
    N_dual = jax.vmap(mass_op.matvec)(N)
    N_dual_c = jax.vmap(mass_op.matvec)(rigid_modes(sp, pole))
    nv = normal_vector_l2(mass_op, normals_q, jxw, body_nodes)
    n_pure_f = flatten(nv["normal_pure"])
    Mn_pure_f = flatten(nv["M_normal_pure"])
    l2g_pure = nv["l2_gamma_pure"]

    V_slab, K_slab = sharded_assemble(euler, sp, tables, dmesh)
    Vn_slab = _slab_mv(V_slab, n_pure_f, dmesh)
    resid_slab = flat_to_slab(n_pure_f, n, d, dmesh) - Vn_slab
    V_slab = slab_rank1_update(V_slab, resid_slab, Mn_pure_f / l2g_pure, dmesh)
    k_out = slab_solid_angle_correction(
        K_slab,
        n,
        d,
        dmesh,
        use_internal_alpha=cfg.use_internal_alpha,
        component_labels=problem.node_component_label,
        component_alpha=problem.node_component_alpha,
        return_check=return_check,
    )
    k_check = None
    if return_check:
        K_slab, k_check = k_out
    else:
        K_slab = k_out
    return dict(
        euler=euler,
        mass_op=mass_op,
        mass_body=mass_body,
        com_body=com_body,
        pole=pole,
        sp=sp,
        N=N,
        N_dual=N_dual,
        N_dual_c=N_dual_c,
        nv=nv,
        n_pure_f=n_pure_f,
        Mn_pure_f=Mn_pure_f,
        l2g_pure=l2g_pure,
        V_slab=V_slab,
        K_slab=K_slab,
        k_check=k_check,
        resid_slab=resid_slab,
    )


def make_sharded_frame_step(
    problem,
    dmesh: Mesh,
    return_fields: bool = False,
    keep_frozen_pieces: bool = False,
):
    """Build the distributed frame step for a StokesBEMProblem.

    Returns step(euler, sdot_flat) -> (rigid_velocities [R], euler_next,
    info) running: sharded assembly -> slab corrections -> implicit
    monolithic GMRES -> rigid update (translation + rotation of body nodes
    about the force pole).  With `return_fields` the step additionally
    returns a fields dict (forces, wall velocities, rigid modes, normals,
    rigid force sums, per-frame invariant diagnostics) so the swimmer frame
    loop can emit its full output set from the distributed solve
    (SwimmerSimulation with cfg.distributed).

    Config parity with the single-chip path:
    - `solver.gmres_restart` / `solver.max_steps` bound the Arnoldi work
      exactly like `StokesBEMProblem.solve_frame`;
    - `solver.preconditioner_type == "Direct"` uses the DISTRIBUTED stale-LU
      preconditioner (`parallel.lu`): the slab-sharded surface block is
      factored by the blocked LU, the R rigid tail rows/columns are folded
      in exactly via a bordered Schur complement (one distributed LU solve
      per application), and the factors are REUSED across frames with the
      reference's refactor-on-iteration-trigger semantics
      (`source/direct_preconditioner.cc`, trigger `source/bem_stokes.cc:
      4336-4339, 5768-5779`); `solver.preconditioner_dtype == "float32"`
      factors in f32 (the mixed-precision preconditioner);
    - `solver.preconditioner_type == "Jacobi"` uses the distributed diagonal;
      every other type maps to block-Jacobi-LU — each device's diagonal
      block is its local dense LU;
    - `time_integration == "Heun"` is provided by `sharded_heun_step`
      (predictor-corrector re-running this step at the midpoint geometry,
      reference `source/bem_stokes.cc:5787-5835`);
    - `solve_with_torque` adds the motor-torque unknown: an extra rigid
      column (-scale tmp_torque) on the surface rows, the motor balance row,
      and the omega/motor-torque output set, all folded through the bordered
      tail of the distributed LU (reference `source/bem_stokes.cc:3191-3192,
      3252-3256, 3297-3356`);
    - hanging-node constraints are applied in slab layout
      (`slab_apply_hanging_constraints`), matching the single-chip
      monolithic constraint rows (reference `:1654-1712, 2970-2995`).
    """
    cfg = problem.cfg
    if not cfg.monolithic:
        return make_sharded_resistance_step(problem, dmesh, return_fields)
    if keep_frozen_pieces and (
        cfg.solve_with_torque
        or cfg.grid_type != "Real"
        or cfg.solver.preconditioner_type != "Direct"
    ):
        raise ValueError(
            "the frozen-geometry fast path needs grid_type='Real', no "
            "torque unknown, and the Direct preconditioner (matching the "
            "single-chip solve_frame_frozen semantics)"
        )
    tables = problem.tables
    d = problem.dim
    n = problem.n
    R = problem.num_rigid
    # the motor-torque unknown: one extra column (the flagellum rotation
    # rate) and one extra balance row (reference `source/bem_stokes.cc:
    # 3191-3192, 3252-3256, 3340-3356`, rank-0 rows `:3297-3352`)
    with_torque = bool(cfg.solve_with_torque)
    with_torque_dual = with_torque or cfg.imposed_rotation_as_flagellum_shape
    RT = R + (1 if with_torque else 0)
    dt_num = tables.cfg.dtype
    scale = cfg.assemble_scaling
    import numpy as _np

    # body-node mask in MAP space (walls never move; reference rotates only
    # body DoFs in compute_euler_vector, `source/bem_stokes.cc:2247-2440`)
    map_sp = problem.map_space
    map_body = _np.zeros(map_sp.n_nodes)
    map_body[
        _np.unique(map_sp.cells_nodes[problem.body_cell_mask > 0])
    ] = 1.0
    # hanging-node constraints: the d constrained flat rows per slave node
    # (matching the single-chip apply_hanging_constraints_monolithic row set)
    constr_rows = None
    if problem.hanging.n:
        comp = _np.arange(d)[:, None] * n
        constr_rows = (
            problem.hanging.slaves[None, :].astype(_np.int64) + comp
        ).reshape(-1)

    def build_system(euler, sdot_flat, rotation):
        """Sharded assembly + corrections + implicit monolithic system;
        returns the traced pieces shared by every preconditioner variant.
        `rotation` is the accumulated body rotation matrix (consulted only
        by the flagellum torque mode, like the single-chip pipeline)."""
        ops = _build_sharded_operators(
            problem, dmesh, euler, return_check=return_fields
        )
        euler = ops["euler"]
        mass_op = ops["mass_op"]
        mass_body, com_body, pole = (
            ops["mass_body"],
            ops["com_body"],
            ops["pole"],
        )
        N, N_dual, N_dual_c, nv = (
            ops["N"],
            ops["N_dual"],
            ops["N_dual_c"],
            ops["nv"],
        )
        n_pure_f, Mn_pure_f, l2g_pure = (
            ops["n_pure_f"],
            ops["Mn_pure_f"],
            ops["l2g_pure"],
        )
        V_slab, K_slab = ops["V_slab"], ops["K_slab"]
        k_check, resid_slab = ops["k_check"], ops["resid_slab"]

        def P_t(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g_pure)

        def PKP(v):
            Kv = slab_to_flat(_slab_mv(K_slab, P_t(v), dmesh), n, d, dmesh)
            return P_t(Kv)

        N_flat = jax.vmap(flatten)(N)
        tmp_N = jax.vmap(PKP)(N_flat)  # [R, dn]
        N_dual_flat = jax.vmap(flatten)(N_dual)
        rhs_surface = PKP(sdot_flat.astype(dt_num))
        tmp_torque = None
        torque_dual_flat = None
        torque_mode_flat = None
        if with_torque_dual:
            torque_mode_flat = flatten(
                problem.flagellum_torque_mode(euler, rotation)
            )
            torque_dual_flat = flatten(
                mass_op.matvec(unflatten(torque_mode_flat, d))
            )
            if with_torque:
                tmp_torque = PKP(torque_mode_flat)
        if constr_rows is not None:
            # constrained rows: the monolithic row (incl. its rigid columns
            # and rhs entry) is replaced by the interpolation identity, so
            # the rigid-column and rhs contributions vanish there (the A_slab
            # rows themselves are rewritten by slab_apply_hanging_constraints
            # below)
            keep = jnp.ones((d * n,), dt_num).at[constr_rows].set(0.0)
            tmp_N = tmp_N * keep[None, :]
            rhs_surface = rhs_surface * keep
            if tmp_torque is not None:
                tmp_torque = tmp_torque * keep

        sel_V = operator_column_mask(
            jnp.asarray(problem.node_material), flatten(nv["normal"]), n, d
        )

        # ---- implicit monolithic operator ----
        # A_slab for the surface block: select V / -K columns, in slab rows
        @partial(
            shard_map,
            mesh=dmesh,
            in_specs=(P("rows", None), P("rows", None), P()),
            out_specs=P("rows", None),
            check_vma=False,
        )
        def _select(V_loc, K_loc, sel):
            return jnp.where(sel[None, :], V_loc, -K_loc)

        A_slab = _select(V_slab, K_slab, sel_V)
        if constr_rows is not None:
            A_slab = slab_apply_hanging_constraints(
                A_slab, problem.hanging, n, d, dmesh
            )

        tail = scale * N_dual_flat if cfg.grid_type == "Real" else N_dual_flat
        if cfg.grid_type == "ImposedVelocity":
            tail = jnp.zeros_like(N_dual_flat)

        rhs_tail = jnp.zeros((R,), dt_num)
        if cfg.grid_type != "Real":
            from ..ops.monolithic import imposed_tail_vector

            rhs_head = jnp.zeros((d * n,), dt_num)
            rhs_tail = imposed_tail_vector(
                R,
                d,
                cfg.imposed_component,
                angle=cfg.angle_for_imposed_stuff,
                rotate=cfg.extra_debug_info,
                dtype=dt_num,
            )
        elif with_torque:
            # the gait rate is an unknown of the motor balance: zero surface
            # rhs (reference `:3191-3192`)
            rhs_head = jnp.zeros((d * n,), dt_num)
        else:
            rhs_head = rhs_surface
        rhs_parts = [rhs_head, rhs_tail]
        if with_torque:
            rhs_parts.append(
                jnp.full((1,), cfg.imposed_motor_torque, dt_num)
            )
        rhs = jnp.concatenate(rhs_parts)
        sysd = dict(
            euler=euler, A_slab=A_slab, tmp_N=tmp_N, tail=tail, rhs=rhs,
            pole=pole,
        )
        if with_torque_dual:
            sysd["torque_dual"] = torque_dual_flat
            sysd["torque_mode_flat"] = torque_mode_flat
        if with_torque:
            sysd["tmp_torque"] = tmp_torque
        if keep_frozen_pieces:
            # frozen-geometry squirmer fast path: the per-frame rhs rebuild
            # P_t K P_t sdot needs the double-layer slab and the projector
            # vectors (reference squirmer branch skipping re-assembly,
            # `source/bem_stokes.cc:5734-5759`)
            sysd["frozen"] = dict(
                K_slab=K_slab,
                n_pure_f=n_pure_f,
                Mn_pure_f=Mn_pure_f,
                l2g=l2g_pure,
            )
        if return_fields:
            # per-frame output fields + invariant diagnostics (the swimmer
            # frame loop's txt/VTU emitters and per-frame checks); the
            # versor check comes from the correction's in-hand row sums
            v_null_pre = jnp.max(
                jnp.abs(slab_to_flat(resid_slab, n, d, dmesh))
            )
            sysd["fields"] = dict(
                N=N,
                normal=nv["normal"],
                N_dual_flat=N_dual_flat,
                N_dual_c_flat=jax.vmap(flatten)(N_dual_c),
                sel_V=sel_V,
                mass_body=mass_body,
                com_body=com_body,
                rhs_norm=jnp.linalg.norm(rhs),
                v_null_residual_pre=v_null_pre,
                k_solid_angle_check=k_check,
            )
        return sysd

    def make_matvec(sysd):
        A_slab, tmp_N, tail = sysd["A_slab"], sysd["tmp_N"], sysd["tail"]

        def matvec(x):  # x = [dn + R (+1 torque)] replicated
            xs, u = x[: d * n], x[d * n : d * n + R]
            y_surf = slab_to_flat(_slab_mv(A_slab, xs, dmesh), n, d, dmesh)
            y_surf = y_surf - scale * (u @ tmp_N)
            if with_torque:
                y_surf = y_surf - scale * x[d * n + R] * sysd["tmp_torque"]
            if cfg.grid_type == "ImposedVelocity":
                y_tail = scale * u
            else:
                y_tail = tail @ xs
            parts = [y_surf, y_tail]
            if with_torque:
                # motor balance row (reference `:3340-3356`)
                parts.append(scale * (sysd["torque_dual"] @ xs)[None])
            return jnp.concatenate(parts)

        return matvec

    # ---- distributed stale-LU direct preconditioner (parallel.lu) ----
    fdt = (
        jnp.float32
        if cfg.solver.preconditioner_dtype == "float32"
        else dt_num
    )

    def direct_factor(sysd):
        """Distributed blocked-LU of the surface slab + bordered Schur
        complement for the RT tail rows/columns (R rigid + optional torque):
        with As = surface block, B the rigid/torque columns, T/D the tail
        rows, the preconditioner is the EXACT monolithic inverse
        [[As, B], [T, D]]^-1 expressed through Z = As^-1 B and S = D - T Z
        (one distributed LU solve per apply)."""
        from .lu import slab_reorder_columns, slab_lu_factor, slab_lu_solve

        A2 = slab_reorder_columns(sysd["A_slab"], n, d, dmesh).astype(fdt)
        lu, perm = slab_lu_factor(A2, dmesh)
        bcols = [-scale * sysd["tmp_N"][r] for r in range(R)]
        if with_torque:
            bcols.append(-scale * sysd["tmp_torque"])
        Zcols = []
        for c in bcols:
            brhs = flat_to_slab(c.astype(fdt), n, d, dmesh)
            Zcols.append(
                slab_to_flat(slab_lu_solve(lu, perm, brhs, dmesh), n, d, dmesh)
            )
        Z = jnp.stack(Zcols, axis=1)  # [dn, RT]
        if cfg.grid_type == "ImposedVelocity":
            T_top = jnp.zeros((R, d * n), fdt)
            D_top = scale * jnp.eye(R, dtype=fdt)
        else:
            T_top = sysd["tail"].astype(fdt)
            D_top = jnp.zeros((R, R), fdt)
        if with_torque:
            T = jnp.concatenate(
                [T_top, (scale * sysd["torque_dual"]).astype(fdt)[None, :]]
            )
            D = jnp.zeros((RT, RT), fdt).at[:R, :R].set(D_top)
        else:
            T, D = T_top, D_top
        S_lu = jax.scipy.linalg.lu_factor(D - T @ Z)
        return dict(lu=lu, perm=perm, Z=Z, T=T, S_lu=S_lu)

    def direct_apply(fac):
        from .lu import slab_lu_solve

        def precond(x):
            b_s, b_u = x[: d * n], x[d * n :]
            w = slab_to_flat(
                slab_lu_solve(
                    fac["lu"],
                    fac["perm"],
                    flat_to_slab(b_s.astype(fdt), n, d, dmesh),
                    dmesh,
                ),
                n,
                d,
                dmesh,
            )
            x_u = jax.scipy.linalg.lu_solve(
                fac["S_lu"], b_u.astype(fdt) - fac["T"] @ w
            )
            x_s = w - fac["Z"] @ x_u
            return jnp.concatenate([x_s, x_u]).astype(x.dtype)

        return precond

    def make_precond(sysd):
        A_slab = sysd["A_slab"]
        if cfg.solver.preconditioner_type == "Jacobi":
            diag_slab = slab_diagonal(A_slab, n, d, dmesh)

            def precond(x):
                xs, u = x[: d * n], x[d * n :]
                ys = slab_to_flat(
                    flat_to_slab(xs, n, d, dmesh) / diag_slab, n, d, dmesh
                )
                return jnp.concatenate([ys, u])

        else:  # block-Jacobi-LU slab blocks (SOR/SSOR/ILU/AMG analogs)
            lu_slab, piv_slab = slab_block_jacobi_lu(A_slab, None, n, d, R, dmesh)

            def precond(x):
                xs, u = x[: d * n], x[d * n :]
                ys = slab_to_flat(
                    slab_block_jacobi_apply(
                        lu_slab, piv_slab, flat_to_slab(xs, n, d, dmesh), dmesh
                    ),
                    n,
                    d,
                    dmesh,
                )
                return jnp.concatenate([ys, u])

        return precond

    restart = cfg.solver.gmres_restart
    max_restarts = max(1, -(-cfg.solver.max_steps // max(restart, 1)))

    def solve_and_finish(sysd, precond):
        x, info = gmres(
            make_matvec(sysd),
            sysd["rhs"],
            precond=precond,
            restart=restart,
            tol=cfg.solver.tolerance,
            max_restarts=max_restarts,
        )
        rigid_vel = x[d * n : d * n + R] * scale
        if return_fields:
            f = sysd["fields"]
            xs = x[: d * n]
            forces = jnp.where(f["sel_V"], xs, 0.0)
            f = dict(
                f,
                forces=forces,
                wall_velocities=jnp.where(f["sel_V"], 0.0, xs),
                F=f["N_dual_flat"] @ forces,
                F_complete=f["N_dual_c_flat"] @ forces,
            )
            if with_torque:
                # the motor-balance unknown: flagellum rotation rate omega;
                # the effective gait velocity is omega * N_flagellum_torque
                # (reference `:4398-4410`)
                omega = x[-1] * scale
                f["flagellum_omega"] = omega
                f["shape_velocities_flat"] = omega * sysd["torque_mode_flat"]
            if with_torque_dual:
                # motor torque actually transmitted (reference `:4374-4384`)
                f["motor_torque"] = jnp.dot(sysd["torque_dual"], forces)
                f["torque_mode_flat"] = sysd["torque_mode_flat"]
            sysd = dict(sysd, fields=f)

        # ---- rigid update: translation + rotation of body nodes about the
        # pole (forward-Euler axis-angle, reference `:4728-4846`) ----
        euler, pole = sysd["euler"], sysd["pole"]
        U = rigid_vel[:d]
        body = jnp.asarray(map_body, dt_num)[:, None]
        euler_next = euler + cfg.time_step * U[None, :] * body
        if cfg.consider_rigid_rotations:
            from ..physics.kinematics import update_rotation_matrix

            Rm = update_rotation_matrix(
                jnp.eye(d, dtype=dt_num),
                rigid_vel[d : 2 * d] if d == 3 else rigid_vel[d],
                cfg.time_step,
                forward_euler=True,
            )
            rotated = (euler_next - pole[None, :]) @ Rm.T + pole[None, :]
            euler_next = jnp.where(body > 0, rotated, euler_next)
        if return_fields:
            return rigid_vel, euler_next, info, sysd["fields"]
        return rigid_vel, euler_next, info

    def _rot(rotation):
        if rotation is None:
            return jnp.eye(d, dtype=dt_num)
        return jnp.asarray(rotation, dt_num)

    if cfg.solver.preconditioner_type != "Direct":

        @jax.jit
        def _step_plain(euler, sdot_flat, rotation):
            sysd = build_system(euler, sdot_flat, rotation)
            return solve_and_finish(sysd, make_precond(sysd))

        def step(euler, sdot_flat, rotation=None):
            return _step_plain(euler, sdot_flat, _rot(rotation))

        return step

    # Direct: two compiled variants + host-side stale-reuse bookkeeping
    # (reference refactor-on-trigger, `source/bem_stokes.cc:4336-4339`)
    @jax.jit
    def _step_fresh(euler, sdot_flat, rotation):
        sysd = build_system(euler, sdot_flat, rotation)
        fac = direct_factor(sysd)
        out = solve_and_finish(sysd, direct_apply(fac))
        return out + ((fac, sysd) if keep_frozen_pieces else (fac,))

    @jax.jit
    def _step_stale(euler, sdot_flat, rotation, fac):
        sysd = build_system(euler, sdot_flat, rotation)
        out = solve_and_finish(sysd, direct_apply(fac))
        return out + ((sysd,) if keep_frozen_pieces else ())

    state = {
        "factors": None,
        "last_iterations": 0,
        "refactored": False,
        "sysd": None,
    }
    n_out = 4 if return_fields else 3

    def step(euler, sdot_flat, rotation=None):
        reuse = (
            state["factors"] is not None
            and state["last_iterations"]
            <= cfg.solver.refactor_iteration_trigger
        )
        if reuse:
            full = _step_stale(
                euler, sdot_flat, _rot(rotation), state["factors"]
            )
            out = tuple(full[:n_out])
            if keep_frozen_pieces:
                state["sysd"] = full[n_out]
            state["refactored"] = False
        else:
            full = _step_fresh(euler, sdot_flat, _rot(rotation))
            out = tuple(full[:n_out])
            state["factors"] = full[n_out]
            if keep_frozen_pieces:
                state["sysd"] = full[n_out + 1]
            state["refactored"] = True
        info = out[2]
        state["last_iterations"] = int(info["iterations"])
        return out

    if keep_frozen_pieces:
        # frozen-geometry squirmer fast path (reference `:5734-5759`): the
        # operators, corrections and LU factors of the last full step are
        # reused; only the rhs P_t K P_t sdot is rebuilt and re-solved
        @jax.jit
        def _step_frozen(sysd, fac, sdot_flat):
            fz = sysd["frozen"]

            def P_t(v):
                return tangential_projector(
                    v, fz["n_pure_f"], fz["Mn_pure_f"], fz["l2g"]
                )

            rhs_surface = P_t(
                slab_to_flat(
                    _slab_mv(
                        fz["K_slab"], P_t(sdot_flat.astype(dt_num)), dmesh
                    ),
                    n,
                    d,
                    dmesh,
                )
            )
            if constr_rows is not None:
                rhs_surface = rhs_surface.at[constr_rows].set(0.0)
            rhs = jnp.concatenate([rhs_surface, jnp.zeros((R,), dt_num)])
            sysd2 = dict(sysd, rhs=rhs)
            if return_fields:
                sysd2["fields"] = dict(
                    sysd["fields"], rhs_norm=jnp.linalg.norm(rhs)
                )
            return solve_and_finish(sysd2, direct_apply(fac))

        def step_frozen(sdot_flat):
            if state["sysd"] is None or state["factors"] is None:
                raise RuntimeError(
                    "frozen step requires one full step() call first"
                )
            out = _step_frozen(state["sysd"], state["factors"], sdot_flat)
            state["last_iterations"] = int(out[2]["iterations"])
            state["refactored"] = False
            return out

        step.frozen = step_frozen

    step.stale_state = state
    return step


def make_sharded_resistance_step(
    problem, dmesh: Mesh, return_fields: bool = False
):
    """Distributed non-monolithic (grand resistance matrix) strategy — the
    sharded counterpart of `StokesBEMProblem._solve_frame_resistance`
    (reference `solve_system(monolithic=false)` on distributed vectors,
    `source/bem_stokes.cc:4163-4258`, D2N `:4073-4129`).

    Each Dirichlet-to-Neumann application f = P_t V^-1 P_t K P_t v runs as
    GMRES over the slab matvec of V preconditioned by the distributed
    blocked LU of V (the reference's GMRES + DirectPreconditioner inner
    solve, `:4106-4117`); the R+1 D2N solves share one factorization.  The
    R x R resistance system is replicated (it is the reference's rank-0
    tiny GMRES, `:4244-4258`)."""
    from .lu import slab_reorder_columns, slab_lu_factor, slab_lu_solve

    cfg = problem.cfg
    if problem.hanging.n:
        # the reference's resistance path predates constraints too: its D2N
        # operates on the raw V/K blocks with no constrained rows
        # (`:4073-4129` has no ConstraintMatrix use); refuse rather than
        # silently drop the interpolation conditions
        raise NotImplementedError(
            "the resistance strategy does not support hanging-node meshes "
            "(the reference's dirichlet_to_neumann_operator has no "
            "constraint handling either); use the monolithic strategy"
        )
    d = problem.dim
    n = problem.n
    R = problem.num_rigid
    dt_num = problem.tables.cfg.dtype
    restart = cfg.solver.gmres_restart
    max_restarts = max(1, -(-cfg.solver.max_steps // max(restart, 1)))
    import numpy as _np

    map_sp = problem.map_space
    map_body = _np.zeros(map_sp.n_nodes)
    map_body[
        _np.unique(map_sp.cells_nodes[problem.body_cell_mask > 0])
    ] = 1.0

    @jax.jit
    def _step(euler, sdot_flat):
        ops = _build_sharded_operators(
            problem, dmesh, euler, return_check=return_fields
        )
        V_slab, K_slab = ops["V_slab"], ops["K_slab"]
        n_pure_f, Mn_pure_f, l2g_pure = (
            ops["n_pure_f"],
            ops["Mn_pure_f"],
            ops["l2g_pure"],
        )

        def P_t(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g_pure)

        V2 = slab_reorder_columns(V_slab, n, d, dmesh)
        lu, perm = slab_lu_factor(V2, dmesh)

        def V_precond(x):
            return slab_to_flat(
                slab_lu_solve(
                    lu, perm, flat_to_slab(x, n, d, dmesh), dmesh
                ),
                n,
                d,
                dmesh,
            )

        def d2n(v):
            rhs = P_t(
                slab_to_flat(_slab_mv(K_slab, P_t(v), dmesh), n, d, dmesh)
            )
            f, info = gmres(
                lambda x: slab_to_flat(
                    _slab_mv(V_slab, x, dmesh), n, d, dmesh
                ),
                rhs,
                precond=V_precond,
                restart=restart,
                tol=cfg.solver.tolerance,
                max_restarts=max_restarts,
            )
            return P_t(f), info

        N_flat = jax.vmap(flatten)(ops["N"])  # [R, dn]
        N_dual_flat = jax.vmap(flatten)(ops["N_dual"])
        f_s, info_s = d2n(sdot_flat.astype(dt_num))
        DN_rows, iters = [], info_s["iterations"]
        res = info_s["residual"]
        for r in range(R):
            fr, ir = d2n(N_flat[r])
            DN_rows.append(fr)
            iters = jnp.maximum(iters, ir["iterations"])
            res = jnp.maximum(res, ir["residual"])
        DN_N = jnp.stack(DN_rows)  # [R, dn]
        res_matrix = N_dual_flat @ DN_N.T
        rhs_R = -(N_dual_flat @ f_s)
        if cfg.grid_type == "ImposedForce":
            A_R = res_matrix
            rhs_R = rhs_R.at[cfg.imposed_component].add(1.0)
        elif cfg.grid_type == "ImposedVelocity":
            A_R = jnp.eye(R, dtype=dt_num)
            rhs_R = (
                jnp.zeros((R,), dt_num).at[cfg.imposed_component].set(1.0)
            )
        else:
            A_R = res_matrix
        U = jnp.linalg.solve(A_R, rhs_R)
        forces = f_s + U @ DN_N

        # rigid update (same forward-Euler axis-angle as the monolithic step)
        euler_adv = ops["euler"]
        body = jnp.asarray(map_body, dt_num)[:, None]
        euler_next = euler_adv + cfg.time_step * U[None, :d] * body
        if cfg.consider_rigid_rotations:
            from ..physics.kinematics import update_rotation_matrix

            Rm = update_rotation_matrix(
                jnp.eye(d, dtype=dt_num),
                U[d : 2 * d] if d == 3 else U[d],
                cfg.time_step,
                forward_euler=True,
            )
            rotated = (euler_next - ops["pole"][None, :]) @ Rm.T + ops[
                "pole"
            ][None, :]
            euler_next = jnp.where(body > 0, rotated, euler_next)
        # worst inner D2N residual, so _package_dist_result's convergence
        # warning can fire when any of the R+1 V-solves fails to converge
        info = dict(iterations=iters, residual=res)
        if not return_fields:
            return U, euler_next, info
        fields = dict(
            forces=forces,
            wall_velocities=jnp.zeros_like(forces),
            resistance_matrix=res_matrix,
            N=ops["N"],
            normal=ops["nv"]["normal"],
            N_dual_flat=N_dual_flat,
            F=N_dual_flat @ forces,
            F_complete=jax.vmap(flatten)(ops["N_dual_c"]) @ forces,
            mass_body=ops["mass_body"],
            com_body=ops["com_body"],
            rhs_norm=jnp.linalg.norm(rhs_R),
            v_null_residual_pre=jnp.max(
                jnp.abs(slab_to_flat(ops["resid_slab"], n, d, dmesh))
            ),
            k_solid_angle_check=ops["k_check"],
        )
        return U, euler_next, info, fields

    def step(euler, sdot_flat, rotation=None):
        # rotation is accepted for signature parity with the monolithic
        # step; the resistance strategy has no torque mode to rotate
        return _step(euler, sdot_flat)

    return step


def sharded_heun_step(
    step, euler, sdot_flat, euler_pred=None, sdot_pred=None, rotation=None
):
    """Heun predictor-corrector around a jitted sharded frame step: solve at
    `euler`, re-solve at the midpoint geometry, average the rigid velocities
    (reference `source/bem_stokes.cc:5787-5835`).  Mirroring the single-chip
    `SwimmerSimulation` Heun branch, the corrector runs at the NEXT frame's
    gait shape `euler_pred` with the next frame's gait velocity `sdot_pred`
    (both default to the predictor's outputs when the gait is frozen)."""
    rigid_vel, euler_next, info = step(euler, sdot_flat, rotation)
    if euler_pred is None:
        euler_pred = euler_next
    if sdot_pred is None:
        sdot_pred = sdot_flat
    rigid_vel2, _, info2 = step(euler_pred, sdot_pred, rotation)
    return 0.5 * (rigid_vel + rigid_vel2), info, info2


def _slab_mv(A_slab, x_flat, mesh):
    from .sharded import sharded_matvec

    return sharded_matvec(A_slab, x_flat, mesh)
