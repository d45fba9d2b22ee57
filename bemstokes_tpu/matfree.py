"""Matrix-free monolithic frame solve: assembly-fused GMRES.

Every materialized path stores V, K and A as [3n, 3n] device buffers plus
an LU — four dense squares that cap one device's problem size.
This path never materializes ANY of them: the GMRES matvec recomputes
operator tiles on the fly inside the node sweep
(`ops.matfree_node.sweep_matvec`) and adds the exact sparse corrections:

- singular / near-pair quadrature deltas as COO triplets
  (`ops.assemble._singular_coo` / `_near_coo` — the same arrays the
  materialized path scatters into the dense operators);
- the rank-1 V null-space fix as an analytic rank-1 action
  (V + (n - Vn)(Mn)^T/l2) @ u = V u + (n - Vn) (Mn.u)/l2;
- the K solid-angle diagonal replacement as a [d, d, n] block-diagonal
  apply, with the versor row sums C = K e_b computed by ONE batched setup
  sweep (component-restricted columns when alpha_row_sum="component");
- hanging-node rows as a functional row replacement
  (out[slave] = x[slave] - sum w_k x[master_k]).

Preconditioner: block-Jacobi of materialized diagonal node blocks of A
(assembled per block by the standard row-block kernel, so each block holds
its singular/near corrections; slave and padding rows become identity),
closed with an EXACT bordered Schur complement over the rigid(+torque) tail
so the saddle rows are solved, not just scaled.

The reference escapes its RAM cap by adding MPI ranks (row-partitioned
dense rows, `source/bem_stokes.cc:1661-1712`; GMRES matvec use `:4332`);
this escapes the device-memory cap on ONE device.  Matches the materialized
path to 1e-7 (tests/test_matfree.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .fem.geometry import support_points
from .la.gmres import gmres
from .ops.assemble import assemble_rows, _near_coo, _singular_coo
from .ops.corrections import tangential_projector
from .ops.matfree_node import (
    build_sweep_arrays,
    sweep_matvec,
    sweep_static,
)
from .ops.monolithic import (
    GRID_IMPOSED_VELOCITY,
    GRID_REAL,
    imposed_tail_vector,
    operator_column_mask,
)
from .physics.rigid import (
    build_mass_operator,
    surface_mass_and_com,
    rigid_modes,
    normal_vector_l2,
    flatten,
)


def _delta_apply(ri, ci, vals, x, out_len):
    """COO action: out[ri] += vals * x[ci] (rows >= out_len dropped).
    x may be [dn] or [dn, B]."""
    if x.ndim == 1:
        upd = vals * x[ci]
        return jnp.zeros((out_len,), upd.dtype).at[ri].add(upd, mode="drop")
    upd = vals[:, None] * x[ci, :]
    return jnp.zeros((out_len, x.shape[1]), upd.dtype).at[ri].add(
        upd, mode="drop"
    )


class MatfreeSolver:
    """Per-problem matrix-free solve state (sweep statics, constraint index
    tables, jitted stages).  Built lazily by StokesBEMProblem the first time
    cfg.matrix_free routes a frame here."""

    def __init__(self, problem):
        p = problem
        self.p = p
        cfg = p.cfg
        d, n = p.dim, p.n
        self.d, self.n = d, n
        self.dn = d * n
        self.R = p.num_rigid
        self.with_torque = bool(cfg.solve_with_torque)
        self.RT = self.R + (1 if self.with_torque else 0)
        self.has_torque_dual = (
            cfg.solve_with_torque or cfg.imposed_rotation_as_flagellum_shape
        )
        self.dt = p.asm_cfg.dtype
        self.st = sweep_static(p.tables, n)
        self.labels = (
            None
            if p.node_component_label is None
            else np.unique(np.asarray(p.node_component_label))
        )
        # preconditioner blocking over nodes (component-blocked flat layout:
        # block k owns rows/cols {a*n + i : i in [k*bn, (k+1)*bn)})
        self.bn = int(min(cfg.matfree_block_nodes, n))
        self.nblk = -(-n // self.bn)
        self.npad = self.nblk * self.bn
        fd = cfg.solver.preconditioner_dtype
        self.factor_dt = jnp.float32 if fd == "float32" else self.dt
        # hanging-node row-replacement tables (static)
        hc = p.hanging
        if hc.n:
            comp = np.arange(d)[:, None] * n
            self.h_rows = jnp.asarray(
                (hc.slaves[None, :] + comp).reshape(-1), jnp.int32
            )
            M = hc.masters.shape[1]
            self.h_cols = jnp.asarray(
                (hc.masters[None, :, :] + comp[:, :, None]).reshape(-1, M),
                jnp.int32,
            )
            self.h_wts = jnp.asarray(
                np.broadcast_to(
                    np.asarray(hc.weights)[None], (d, hc.n, M)
                ).reshape(-1, M),
                self.dt,
            )
        else:
            self.h_rows = None
        self._jit_setup = jax.jit(self._setup_impl)
        self._jit_block = jax.jit(self._block_impl)
        self._jit_schur = jax.jit(self._schur_impl)
        self._jit_gmres = jax.jit(self._gmres_impl)
        self._jit_finish = jax.jit(self._finish_mf_impl)

    # ------------------------------------------------------------------
    def _versor_columns(self):
        """Static K setup columns for the solid-angle row sums: e_b per
        component (optionally restricted per connected component label —
        reference full-row replacement `source/bem_stokes.cc:3044-3098`,
        component restriction as ops.corrections.k_solid_angle_correction)."""
        d, n = self.d, self.n
        cols = []
        if self.labels is None:
            for b in range(d):
                e = np.zeros((d * n,))
                e[b * n : (b + 1) * n] = 1.0
                cols.append(e)
        else:
            lab = np.asarray(self.p.node_component_label)
            for b in range(d):
                for L in self.labels:
                    e = np.zeros((d * n,))
                    e[b * n : (b + 1) * n] = (lab == L).astype(float)
                    cols.append(e)
        return jnp.asarray(np.stack(cols, axis=1), self.dt)  # [dn, BKv]

    def _solid_angle_vals(self, C):
        """[d, d, n] diagonal-block replacement values from the versor row
        sums C [dn, d] (mirrors k_solid_angle_correction exactly)."""
        d, n = self.d, self.n
        cfg = self.p.cfg
        if self.p.node_component_alpha is None:
            alpha = 1.0
        else:
            alpha = jnp.asarray(self.p.node_component_alpha, self.dt)
        Cab = C.reshape(d, n, d)  # [a, i, b]
        tgt = alpha - 1.0 if cfg.use_internal_alpha else alpha
        return -Cab.transpose(0, 2, 1) + jnp.eye(d, dtype=self.dt)[
            :, :, None
        ] * tgt

    def _sa_apply(self, sa_vals, w):
        """Block-diagonal solid-angle action on a flat [dn] (or [dn, B])
        vector."""
        d, n = self.d, self.n
        if w.ndim == 1:
            w3 = w.reshape(d, n)
            return jnp.einsum("abi,bi->ai", sa_vals, w3).reshape(d * n)
        w3 = w.reshape(d, n, -1)
        return jnp.einsum("abi,biB->aiB", sa_vals, w3).reshape(
            d * n, w.shape[1]
        )

    # ------------------------------------------------------------------
    def _setup_impl(self, euler, sdot_flat, rotation):
        """One jitted stage: geometry, sweep tables, COO deltas, and ONE
        batched setup sweep providing every operator application the
        corrections and the rhs need (Vn, versor row sums, K P_t N_r,
        K P_t sdot, K P_t torque-mode)."""
        p = self.p
        cfg = p.cfg
        d, n, R = self.d, self.n, self.R
        dn = self.dn
        dt = self.dt
        euler = euler.astype(dt)

        mass_op, (xq, normals_q, jxw) = build_mass_operator(euler, p.tables)
        body_mask_nodes = jnp.asarray(p.body_node_mask, dt)
        body_mask_cells = jnp.asarray(p.body_cell_mask, dt)
        mass_body, com_body = surface_mass_and_com(xq, jxw, body_mask_cells)
        pole = p.force_pole_point(com_body)
        sp = support_points(euler, p.map_space, p.fe_space).astype(dt)
        N = rigid_modes(sp, pole, node_mask=body_mask_nodes)
        N_complete = rigid_modes(sp, pole)
        N_dual = jax.vmap(mass_op.matvec)(N)
        N_dual_complete = jax.vmap(mass_op.matvec)(N_complete)
        nv = normal_vector_l2(mass_op, normals_q, jxw, body_mask_nodes)
        n_pure_f = flatten(nv["normal_pure"])
        Mn_pure_f = flatten(nv["M_normal_pure"])
        l2g = nv["l2_gamma_pure"]

        arrs = build_sweep_arrays(self.st, p.tables, sp, xq, normals_q, jxw)
        coo_s = _singular_coo(
            euler, sp, p.tables, jnp.int32(0), n, subtract_smooth=True
        )
        coo_n = _near_coo(
            euler, sp, sp, jnp.arange(n, dtype=jnp.int32), p.tables, n
        )

        def Pt(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g)

        # ---- one batched sweep for every setup application ----
        versors = self._versor_columns()
        nBv = versors.shape[1]
        N_flat = jax.vmap(flatten)(N)  # [R, dn]
        PtN = jax.vmap(Pt)(N_flat)  # [R, dn]
        k_cols = [versors, PtN.T, Pt(sdot_flat.astype(dt))[:, None]]
        torque_mode_flat = None
        torque_dual = None
        if self.has_torque_dual:
            torque_mode_flat = flatten(p.flagellum_torque_mode(euler, rotation))
            torque_dual = flatten(
                mass_op.matvec(torque_mode_flat.reshape(d, n).T)
            )
            k_cols.append(Pt(torque_mode_flat)[:, None])
        XK = jnp.concatenate(k_cols, axis=1)
        XV = n_pure_f[:, None]
        VX, KX = sweep_matvec(self.st, arrs, XV, XK)
        VX = VX + _delta_apply(coo_s[0], coo_s[1], coo_s[2], XV, dn)
        KX = KX + _delta_apply(coo_s[0], coo_s[1], coo_s[3], XK, dn)
        if coo_n is not None:
            VX = VX + _delta_apply(coo_n[0], coo_n[1], coo_n[2], XV, dn)
            KX = KX + _delta_apply(coo_n[0], coo_n[1], coo_n[3], XK, dn)

        Vn = VX[:, 0]  # raw V @ n_pure (the null-space residual)
        # versor row sums C[r, b] (component-restricted when labeled)
        if self.labels is None:
            C = KX[:, :nBv]
        else:
            lab_rows = jnp.asarray(
                np.tile(np.asarray(self.p.node_component_label), d)
            )
            nL = len(self.labels)
            C = jnp.stack(
                [
                    sum(
                        KX[:, b * nL + li]
                        * (lab_rows == int(L)).astype(dt)
                        for li, L in enumerate(self.labels)
                    )
                    for b in range(self.d)
                ],
                axis=-1,
            )
        sa_vals = self._solid_angle_vals(C)
        # post-correction check ||K_corr e_b||_inf restricted like the
        # materialized diagnostic: y_b = C[:, b] + vals[:, b, :]
        k_check = jnp.stack(
            [
                jnp.max(jnp.abs(C[:, b] + sa_vals[:, b, :].reshape(-1)))
                for b in range(d)
            ]
        )

        off = nBv
        KPtN = KX[:, off : off + R]  # raw K @ P_t N_r
        tmp_N = jax.vmap(Pt)(
            (KPtN + self._sa_apply(sa_vals, PtN.T)).T
        )  # [R, dn] = P_t (K_corr P_t N_r)
        Ksdot = KX[:, off + R]
        rhs_surface = Pt(
            Ksdot + self._sa_apply(sa_vals, Pt(sdot_flat.astype(dt)))
        )
        tmp_torque = None
        if self.has_torque_dual:
            Ktq = KX[:, off + R + 1]
            Pt_tq = Pt(torque_mode_flat)
            tmp_torque = Pt(Ktq + self._sa_apply(sa_vals, Pt_tq))

        sel_V = operator_column_mask(
            jnp.asarray(p.node_material), flatten(nv["normal"]), n, d
        )

        # ---- rhs (mirrors ops.monolithic.build_monolithic_system) ----
        scale = cfg.assemble_scaling
        rhs_tail = jnp.zeros((R,), dt)
        if cfg.grid_type != GRID_REAL:
            rhs_head = jnp.zeros((dn,), dt)
            rhs_tail = imposed_tail_vector(
                R,
                d,
                cfg.imposed_component,
                angle=cfg.angle_for_imposed_stuff,
                rotate=cfg.extra_debug_info,
                dtype=dt,
            )
        else:
            rhs_head = rhs_surface
        if self.with_torque:
            rhs = jnp.concatenate(
                [
                    jnp.zeros((dn,), dt),
                    rhs_tail,
                    jnp.full((1,), cfg.imposed_motor_torque, dt),
                ]
            )
        else:
            rhs = jnp.concatenate([rhs_head, rhs_tail])
        if self.h_rows is not None:
            rhs = rhs.at[self.h_rows].set(0.0)

        diagnostics = dict(
            mass_body=mass_body,
            com_body=com_body,
            v_null_residual_pre=jnp.max(jnp.abs(Vn)),
            k_solid_angle_check=k_check,
        )
        operators = dict(
            sel_V=sel_V,
            normal=nv,
            N=N,
            N_dual=N_dual,
            N_dual_complete=N_dual_complete,
            tmp_N=tmp_N,
            mass_jxw=jxw,
        )
        if torque_mode_flat is not None:
            operators["N_flagellum_torque"] = torque_mode_flat
            operators["N_flagellum_torque_dual"] = torque_dual
        sys = dict(
            arrs=arrs,
            coo_s=coo_s,
            coo_n=coo_n,
            Vn=Vn,
            n_pure_f=n_pure_f,
            Mn_pure_f=Mn_pure_f,
            l2g=l2g,
            sa_vals=sa_vals,
            sel_V=sel_V,
            tmp_N=tmp_N,
            tmp_torque=tmp_torque,
            torque_dual=torque_dual,
            N_dual_flat=jax.vmap(flatten)(N_dual),
            N_dual_c_flat=jax.vmap(flatten)(N_dual_complete),
            rhs=rhs,
            sp=sp,
            euler=euler,
        )
        return sys, operators, diagnostics

    # ------------------------------------------------------------------
    def _matvec(self, sys):
        """The monolithic operator action (closure over the frame state)."""
        p = self.p
        cfg = p.cfg
        dn, R = self.dn, self.R
        scale = cfg.assemble_scaling
        sel = sys["sel_V"]
        coo_s, coo_n = sys["coo_s"], sys["coo_n"]
        vec_u = sys["n_pure_f"] - sys["Vn"]
        w_dual = sys["Mn_pure_f"] / sys["l2g"]

        def mv(x):
            xs = x[:dn]
            tail = x[dn : dn + R]
            u = jnp.where(sel, xs, 0.0)
            w = jnp.where(sel, 0.0, xs)
            Vu, Kw = sweep_matvec(self.st, sys["arrs"], u, w)
            Vu = Vu + _delta_apply(coo_s[0], coo_s[1], coo_s[2], u, dn)
            Kw = Kw + _delta_apply(coo_s[0], coo_s[1], coo_s[3], w, dn)
            if coo_n is not None:
                Vu = Vu + _delta_apply(coo_n[0], coo_n[1], coo_n[2], u, dn)
                Kw = Kw + _delta_apply(coo_n[0], coo_n[1], coo_n[3], w, dn)
            Vu = Vu + vec_u * jnp.dot(w_dual, u)
            Kw = Kw + self._sa_apply(sys["sa_vals"], w)
            top = Vu - Kw - scale * (tail @ sys["tmp_N"])
            if self.with_torque:
                top = top - scale * sys["tmp_torque"] * x[-1]
            if cfg.grid_type == GRID_IMPOSED_VELOCITY:
                mid = scale * tail
            elif cfg.grid_type == GRID_REAL:
                mid = scale * (sys["N_dual_flat"] @ xs)
            else:  # ImposedForce / Convergence
                mid = sys["N_dual_flat"] @ xs
            parts = [top, mid]
            if self.with_torque:
                parts.append(scale * jnp.dot(sys["torque_dual"], xs)[None])
            out = jnp.concatenate(parts)
            if self.h_rows is not None:
                out = out.at[self.h_rows].set(
                    x[self.h_rows]
                    - jnp.sum(self.h_wts * x[self.h_cols], axis=1)
                )
            return out

        return mv

    # ------------------------------------------------------------------
    def _block_impl(self, euler, sp, xi_blk, ids_blk, b0, sa_vals, sel3_pad, row_keep):
        """Factor one diagonal node-block of A (same shapes for every block
        => one compile).  row_keep masks real rows; padding / slave rows
        become identity."""
        p = self.p
        d, n, bn = self.d, self.n, self.bn
        dbn = d * bn
        Vb, Kb = assemble_rows(euler, sp, xi_blk, ids_blk, b0, p.tables)
        # column pad to npad so the dynamic block slice never clamps
        Vb4 = jnp.pad(
            Vb.reshape(d, bn, d, n), ((0, 0),) * 3 + ((0, self.npad - n),)
        )
        Kb4 = jnp.pad(
            Kb.reshape(d, bn, d, n), ((0, 0),) * 3 + ((0, self.npad - n),)
        )
        z = jnp.zeros((), b0.dtype)
        Vblk = jax.lax.dynamic_slice(
            Vb4, (z, z, z, b0), (d, bn, d, bn)
        ).reshape(dbn, dbn)
        Kblk = jax.lax.dynamic_slice(
            Kb4, (z, z, z, b0), (d, bn, d, bn)
        ).reshape(dbn, dbn)
        sel_blk = jax.lax.dynamic_slice(sel3_pad, (z, b0), (d, bn)).reshape(
            -1
        )
        A_blk = jnp.where(sel_blk[None, :], Vblk, -Kblk)
        # solid-angle diagonal replacement on the -K columns
        sa_blk = jax.lax.dynamic_slice(
            sa_vals, (z, z, b0), (d, d, bn)
        )  # [a, b, i]
        ii = jnp.arange(bn)
        rows = jnp.broadcast_to(
            (jnp.arange(d)[:, None, None] * bn + ii[None, None, :]),
            (d, d, bn),
        ).reshape(-1)
        cols = jnp.broadcast_to(
            (jnp.arange(d)[None, :, None] * bn + ii[None, None, :]),
            (d, d, bn),
        ).reshape(-1)
        keepc = (~sel_blk[cols]).astype(A_blk.dtype)
        A_blk = A_blk.at[rows, cols].add(-sa_blk.reshape(-1) * keepc)
        # identity rows for padding + hanging slaves (preconditioner only)
        A_blk = jnp.where(
            row_keep[:, None], A_blk, jnp.eye(dbn, dtype=A_blk.dtype)
        )
        lu, piv = jax.scipy.linalg.lu_factor(A_blk.astype(self.factor_dt))
        return lu, piv

    def _build_blocks(self, sys):
        """Sequential per-block factorization (one jitted call per block,
        same shapes; memory stays at one [d*bn, d*n] row panel)."""
        d, n, bn = self.d, self.n, self.bn
        sp = sys["sp"]
        sp_pad = jnp.concatenate(
            [sp, jnp.full((self.npad - n, d), 1e8, sp.dtype)]
        )
        ids = jnp.concatenate(
            [
                jnp.arange(n, dtype=jnp.int32),
                jnp.full((self.npad - n,), -1, jnp.int32),
            ]
        )
        sel3 = jnp.pad(
            sys["sel_V"].reshape(d, n), ((0, 0), (0, self.npad - n))
        )
        slave_scalar = np.zeros(self.npad, bool)
        if self.h_rows is not None:
            slave_scalar[np.asarray(self.p.hanging.slaves)] = True
        valid = np.zeros(self.npad, bool)
        valid[:n] = True
        sa_pad = jnp.pad(
            sys["sa_vals"], ((0, 0), (0, 0), (0, self.npad - n))
        )
        lus, pivs = [], []
        for k in range(self.nblk):
            b0 = k * bn
            keep = np.tile(valid[b0 : b0 + bn] & ~slave_scalar[b0 : b0 + bn], d)
            lu, piv = self._jit_block(
                sys["euler"],
                sys["sp"],
                sp_pad[b0 : b0 + bn],
                ids[b0 : b0 + bn],
                jnp.int32(b0),
                sa_pad,
                sel3,
                jnp.asarray(keep),
            )
            lus.append(lu)
            pivs.append(piv)
        return jnp.stack(lus), jnp.stack(pivs)

    # ------------------------------------------------------------------
    def _ms_inv(self, lus, pivs):
        d, n, bn = self.d, self.n, self.bn
        fdt = self.factor_dt

        def apply(v):
            vdt = v.dtype
            v3 = jnp.pad(v.reshape(d, n), ((0, 0), (0, self.npad - n)))
            vb = (
                v3.reshape(d, self.nblk, bn)
                .transpose(1, 0, 2)
                .reshape(self.nblk, d * bn)
                .astype(fdt)
            )
            xb = jax.vmap(
                lambda lu, piv, b: jax.scipy.linalg.lu_solve((lu, piv), b)
            )(lus, pivs, vb)
            x3 = (
                xb.reshape(self.nblk, d, bn)
                .transpose(1, 0, 2)
                .reshape(d, self.npad)[:, :n]
            )
            return x3.reshape(self.dn).astype(vdt)

        return apply

    def _schur_impl(self, sys, lus, pivs):
        """Bordered Schur closure over the rigid(+torque) tail: the pieces
        the preconditioner applies every iteration, computed once."""
        p = self.p
        cfg = p.cfg
        dn, R = self.dn, self.R
        dt = self.dt
        scale = cfg.assemble_scaling
        ms_inv = self._ms_inv(lus, pivs)
        C_cols = [-scale * sys["tmp_N"].T]  # [dn, R]
        if self.with_torque:
            C_cols.append(-scale * sys["tmp_torque"][:, None])
        C = jnp.concatenate(C_cols, axis=1)
        if self.h_rows is not None:
            C = C.at[self.h_rows, :].set(0.0)
        B_rows = []
        if cfg.grid_type == GRID_IMPOSED_VELOCITY:
            B_rows.append(jnp.zeros((R, dn), dt))
            D = scale * jnp.eye(R, dtype=dt)
        elif cfg.grid_type == GRID_REAL:
            B_rows.append(scale * sys["N_dual_flat"])
            D = jnp.zeros((R, R), dt)
        else:
            B_rows.append(sys["N_dual_flat"])
            D = jnp.zeros((R, R), dt)
        if self.with_torque:
            B_rows.append(scale * sys["torque_dual"][None, :])
            D = jnp.pad(D, ((0, 1), (0, 1)))
        B = jnp.concatenate(B_rows, axis=0)  # [RT, dn]
        MsC = jax.vmap(ms_inv, in_axes=1, out_axes=1)(C)  # [dn, RT]
        S = D - B @ MsC
        S_lu, S_piv = jax.scipy.linalg.lu_factor(S)
        return dict(B=B, MsC=MsC, S_lu=S_lu, S_piv=S_piv)

    def _precond(self, pre, lus, pivs):
        dn = self.dn
        ms_inv = self._ms_inv(lus, pivs)

        def precond(v):
            vs, t = v[:dn], v[dn:]
            ys = ms_inv(vs)
            t2 = jax.scipy.linalg.lu_solve(
                (pre["S_lu"], pre["S_piv"]), t - pre["B"] @ ys
            )
            return jnp.concatenate([ys - pre["MsC"] @ t2, t2])

        return precond

    def _gmres_impl(self, sys, pre, lus, pivs):
        """Restarted preconditioned GMRES in one dispatch, like the
        materialized Direct path."""
        restart, max_restarts = self.p._gmres_solver_params()
        return gmres(
            self._matvec(sys),
            sys["rhs"],
            precond=self._precond(pre, lus, pivs),
            restart=restart,
            tol=self.p.cfg.solver.tolerance,
            max_restarts=max_restarts,
        )

    def _finish_mf_impl(self, sys, diag, x, iters, res):
        p = self.p
        mv = self._matvec(sys)
        return p._finish_impl(
            mv,
            x,
            sys["rhs"],
            sys["sel_V"],
            diag,
            sys["N_dual_flat"],
            sys["N_dual_c_flat"],
            sys["torque_dual"],
            jnp.asarray(iters, x.dtype),
            jnp.asarray(res, x.dtype),
        )

    # ------------------------------------------------------------------
    def solve_frame(self, euler, sdot_flat, rotation=None):
        """Full matrix-free frame: setup sweep -> block factors -> Schur
        tail -> restarted GMRES -> the standard packed finish
        (same result contract as the materialized `solve_frame`, minus the
        dense A)."""
        from .utils import timers

        p = self.p
        if rotation is None:
            rotation = jnp.eye(self.d, dtype=self.dt)
        with timers.scope("Matfree setup sweep"):
            sys, ops, diag = self._jit_setup(
                jnp.asarray(euler), jnp.asarray(sdot_flat), rotation
            )
        with timers.scope("Matfree block preconditioner"):
            lus, pivs = self._build_blocks(sys)
            pre = self._jit_schur(sys, lus, pivs)
        with timers.scope("Matfree GMRES"):
            x, info = self._jit_gmres(sys, pre, lus, pivs)
            forces, wall, packed_dev = self._jit_finish(
                sys, diag, x, info["iterations"], info["residual"]
            )
            packed = np.asarray(packed_dev)
        return p._unpack_result(
            None, sys["rhs"], ops, forces, wall, packed, False
        )
