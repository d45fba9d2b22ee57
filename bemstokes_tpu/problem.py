"""StokesBEMProblem: the orchestrator (the reference's `BEMProblem<dim>`,
`include/bem_stokes.h:107-660`), reorganized as host-side setup plus jitted
compute stages.

The per-frame pipeline (reference `run`, `source/bem_stokes.cc:5636-5884`):

  euler(frame), euler(frame+1)
    -> rigid modes + center of mass        (physics.rigid)
    -> L2 normal vector                    (physics.rigid.normal_vector_l2)
    -> shape velocities (FD or squirmer)   (project_shape_velocities)
    -> assemble V, K + corrections        (ops.assemble / ops.corrections)
    -> monolithic system + solve          (ops.monolithic / la)
    -> rigid velocity update, kinematics   (physics.kinematics)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .config import ProblemConfig
from .fem.geometry import support_points
from .mesh import SurfaceMesh, build_scalar_space, read_mesh
from .mesh.surface_mesh import MATERIAL_BODY
from .ops.assemble import (
    AssemblyConfig,
    build_assembly_tables,
    assemble_V_K,
    KERNEL_FREE_SPACE,
    KERNEL_FREE_SURFACE,
    KERNEL_NO_SLIP,
)
from .ops.corrections import (
    tangential_projector,
    v_nullspace_correction,
    k_solid_angle_correction,
)
from .ops.monolithic import (
    operator_column_mask,
    build_monolithic_system,
    split_monolithic_solution,
)
from .la.gmres import gmres
from .la.direct import (
    LUPreconditioner,
    lu_factor_dense,
    lu_solve_dense,
    precond_apply,
    precond_factor,
)
from .physics.rigid import (
    build_mass_operator,
    surface_mass_and_com,
    rigid_modes,
    normal_vector_l2,
    flatten,
    unflatten,
)


def _dtype_of(cfg: ProblemConfig):
    return jnp.float64 if cfg.dtype == "float64" else jnp.float32


def _resolve_manifold(cfg: ProblemConfig):
    """Body manifold for curved high-order mapping nodes (reference attaches
    SphericalManifold/CylindricalManifold in `read_domain`,
    `source/bem_stokes.cc:609-887`)."""
    kind = getattr(cfg, "body_manifold", "none")
    if kind in (None, "none", ""):
        return None
    from .mesh.refine import (
        CylindricalManifold,
        SphericalManifold,
        SpheroidManifold,
    )

    center = getattr(cfg, "body_manifold_center", (0.0, 0.0, 0.0))
    radius = getattr(cfg, "body_manifold_radius", None)
    if kind == "sphere":
        return SphericalManifold(center[: cfg.dim], radius=radius)
    if kind == "spheroid":
        return SpheroidManifold(
            radii=getattr(cfg, "body_manifold_radii", (2.0, 1.0, 1.0)),
            center=center[: cfg.dim],
        )
    if kind == "cylinder":
        return CylindricalManifold(
            direction=cfg.cylinder.direction,
            point_on_axis=cfg.cylinder.point_on_axis,
            radius=radius,
        )
    raise ValueError(f"unknown body_manifold {kind!r}")


class StokesBEMProblem:
    """Host-side orchestration for one mesh topology.

    The mesh topology (connectivity, spaces, quadrature tables) is fixed at
    construction; geometry (the euler node-position array) changes per frame
    and is a traced input to the jitted stages — so the frame loop reuses one
    compiled executable per stage.
    """

    def __init__(
        self,
        mesh: SurfaceMesh,
        config: ProblemConfig | None = None,
        manifold=None,
    ):
        self.cfg = config or ProblemConfig()
        if self.cfg.force_pole not in ("Origin", "Baricenter", "Point"):
            # force_pole_point silently falls back to Origin while the
            # swimmer's txt-output pole transform falls back to Point —
            # reject unknown values up front so the two can never disagree
            raise ValueError(
                f"force_pole must be 'Origin', 'Baricenter' or 'Point', "
                f"got {self.cfg.force_pole!r}"
            )
        self.mesh = mesh
        self.manifold = (
            manifold if manifold is not None else _resolve_manifold(self.cfg)
        )
        self.dim = mesh.dim
        self.fe_space = build_scalar_space(mesh, self.cfg.fe_degree)
        self.map_space = build_scalar_space(mesh, self.cfg.map_degree)
        self.n = self.fe_space.n_nodes
        self.num_rigid = 2 * self.dim if self.dim == 3 else self.dim + 1

        kernel = KERNEL_FREE_SPACE
        wall_axis, wall_position = 1, 0.0
        if self.cfg.reflect_kernel or self.cfg.no_slip_kernel:
            kernel = (
                KERNEL_FREE_SURFACE if self.cfg.reflect_kernel else KERNEL_NO_SLIP
            )
            # wall 0 defines the image plane (reference `:2861-2870`)
            if self.cfg.walls:
                w0 = self.cfg.walls[0]
                wall_axis = int(np.argmin(np.abs(np.asarray(w0.span))))
                wall_position = float(w0.position[wall_axis])

        # near-contact quadrature auto-promotion: gap below the local panel
        # diameter (distinct components, or the surface vs its wall image)
        # switches to the adaptive two-level scheme with a raised near-pair
        # order (reference counterpart: geometric refine_walls only,
        # `source/bem_stokes.cc:1478-1519`; mesh/proximity.py)
        quad = self.cfg.quadrature
        q_order, q_far = quad.order, quad.order_far
        self.quadrature_promoted = False
        if quad.auto_promote and q_far is None:
            from .mesh.proximity import (
                min_intercomponent_gap,
                wall_image_gap,
            )

            cands = []
            g = min_intercomponent_gap(mesh)
            if g is not None:
                cands.append(g)
            if kernel != KERNEL_FREE_SPACE:
                cands.append(wall_image_gap(mesh, wall_axis, wall_position))
            if any(gap < diam for gap, diam in cands):
                q_far = q_order
                q_order = q_order + quad.promote_boost
                self.quadrature_promoted = True

        self.asm_cfg = AssemblyConfig(
            dim=self.dim,
            kernel=kernel,
            wall_axis=wall_axis,
            wall_position=wall_position,
            quad_order=q_order,
            quad_order_far=q_far,
            near_panels=self.cfg.quadrature.near_panels,
            singular_quadrature_order=self.cfg.quadrature.singular_order,
            singular_quadrature_type=self.cfg.quadrature.singular_type,
            row_tile=self.cfg.row_tile,
            cell_chunk=self.cfg.cell_chunk,
            dtype=_dtype_of(self.cfg),
            mixed_bulk=self.cfg.mixed_precision_bulk,
            backend=self.cfg.assembly_backend,
        )
        self.tables = build_assembly_tables(self.fe_space, self.map_space, self.asm_cfg)

        # per-node material: a node takes the body material if any adjacent
        # cell is body, else the (first) wall material of its cells
        node_mat = np.full(self.n, np.iinfo(np.int32).max, dtype=np.int64)
        np.minimum.at(
            node_mat,
            self.fe_space.cells_nodes.ravel(),
            np.repeat(self.mesh.material_id, self.fe_space.nl),
        )
        self.node_material = node_mat.astype(np.int32)
        self.body_node_mask = (self.node_material == MATERIAL_BODY).astype(
            np.float64
        )
        self.body_cell_mask = (self.mesh.material_id == MATERIAL_BODY).astype(
            np.float64
        )
        # flagellum / head split of the body nodes at x > -0.1 on the initial
        # geometry (reference `create_wall_body_index_sets`,
        # `source/bem_stokes.cc:1967-1971`)
        from .fem.geometry import euler_from_mesh

        init_euler = euler_from_mesh(mesh.vertices, self.map_space)
        init_sp = np.asarray(
            support_points(jnp.asarray(init_euler), self.map_space, self.fe_space)
        )
        self.flagellum_node_mask = (
            (self.body_node_mask > 0) & (init_sp[:, 0] > -0.1)
        ).astype(np.float64)
        self.head_node_mask = (
            (self.body_node_mask > 0) & ~(init_sp[:, 0] > -0.1)
        ).astype(np.float64)

        # per-node component labels / alpha targets for the per-component
        # solid-angle correction (alpha_row_sum == "component")
        self.node_component_label = None
        self.node_component_alpha = None
        if getattr(self.cfg, "alpha_row_sum", "full") == "component":
            from .mesh.surface_mesh import cell_components_and_closedness

            cell_lab, closed = cell_components_and_closedness(mesh)
            lab = np.zeros(self.n, dtype=np.int32)
            lab[self.fe_space.cells_nodes.ravel()] = np.repeat(
                cell_lab, self.fe_space.nl
            )
            self.node_component_label = lab
            self.node_component_alpha = np.where(
                closed[lab], 1.0, 0.5
            ).astype(np.float64)

        from .mesh.constraints import hanging_node_constraints_for_space

        self.hanging = hanging_node_constraints_for_space(mesh, self.fe_space)
        # map_degree >= 2 on non-conforming meshes needs no special gate:
        # euler_from_mesh distributes the MAP space's hanging constraints
        # onto the position vector (slave map DoFs interpolated from their
        # masters), keeping the geometry conforming at any map degree with
        # or without an analytic manifold — the reference's constrained
        # euler_vec (`source/bem_stokes.cc:1654-1656, 2247-2440`);
        # fem/geometry._distribute_map_constraints,
        # tests/test_wall_refinement.py::test_q2_map_without_exact_manifold
        if self.cfg.apply_iges_to_frame or self.cfg.apply_iges_to_reference:
            # the reference gates these behind an OpenCASCADE build
            # (`BEM_STOKES_WITH_OCE`, iges manifold `source/bem_stokes.cc:
            # 532-578, 2296-2303`); there is no CAD kernel in this image, so
            # refusing beats silently ignoring the CAD manifold
            raise NotImplementedError(
                "iges CAD manifolds need an OpenCASCADE-class kernel (the "
                "reference compile-gates them behind BEM_STOKES_WITH_OCE); "
                "use body_manifold sphere/spheroid/cylinder instead"
            )
        if self.cfg.galerkin:
            # the reference ships the Galerkin strategy gutted ("just
            # experimental ... not fit for real simulations",
            # `include/bem_stokes.h:230-233`; `assemble_stokes_system_
            # galerkin` is ~410 commented lines + a stub)
            raise NotImplementedError(
                "the Galerkin resolution strategy is dead experimental code "
                "in the reference; use the (default) collocation assembly"
            )
        if (
            self.cfg.solver.preconditioner_type == "Direct"
            and self.cfg.solver.bandwith_preconditioner
        ):
            # the reference AssertThrows here too (`source/bem_stokes.cc:4311`)
            raise ValueError(
                "Direct preconditioner cannot be band-limited; disable "
                "bandwith_preconditioner or pick a banded type (Jacobi/SOR/"
                "SSOR/ILU)"
            )

        self.preconditioner = LUPreconditioner(
            self.cfg.solver.refactor_iteration_trigger,
            factor_dtype=(
                jnp.float32
                if self.cfg.solver.preconditioner_dtype == "float32"
                else None
            ),
        )
        # stale-LU bookkeeping (reference `reassemble_preconditoner`,
        # `source/bem_stokes.cc:5679, 4336-4339`): the factorization from an
        # earlier frame is reused until a solve blows past the trigger, and
        # only then is the NEXT frame's matrix refactored
        self._last_direct_iterations = 0
        self._matfree = None  # lazy MatfreeSolver (cfg.matrix_free)
        self._jit_pipeline = jax.jit(self._pipeline)
        self._jit_frozen_rhs = jax.jit(self._frozen_rhs)
        # jitted GMRES solvers with the operator (and any LU factors) as
        # TRACED arguments: calling gmres eagerly per frame would bake the
        # frame's matrices in as constants and recompile the Arnoldi scan on
        # every solve
        self._jit_gmres_direct = jax.jit(self._gmres_direct_impl)
        self._jit_gmres_generic = jax.jit(self._gmres_generic_impl)
        self._jit_finish = jax.jit(self._finish_impl)
        # fused Direct frame step: pipeline + (factor) + GMRES + finish in
        # ONE dispatch and one host readback per frame
        self._jit_direct_fresh = jax.jit(self._direct_fresh_impl)
        self._jit_direct_stale = jax.jit(self._direct_stale_impl)

    def _gmres_solver_params(self):
        cfg = self.cfg
        restart = cfg.solver.gmres_restart
        max_restarts = max(1, -(-cfg.solver.max_steps // max(restart, 1)))
        return restart, max_restarts

    def _gmres_direct_impl(self, A, rhs, factors):
        restart, max_restarts = self._gmres_solver_params()
        fdt = factors[0].dtype

        def precond(v):
            return precond_apply(factors, v.astype(fdt)).astype(v.dtype)

        return gmres(
            lambda v: A @ v,
            rhs,
            precond=precond,
            restart=restart,
            tol=self.cfg.solver.tolerance,
            max_restarts=max_restarts,
        )

    def _finish_impl(
        self,
        A,
        x,
        rhs,
        sel_V,
        diag,
        N_dual_flat,
        N_dual_c_flat,
        torque_dual,
        solver_iters,
        solver_res,
    ):
        """Post-solve bookkeeping fused into ONE dispatch with ONE packed
        scalar vector to read back (one host synchronization per frame).

        Packed layout: [residual, |rhs|, rigid (R), mass, com (d),
        v_null_pre, k_check (d), F (R), F_complete (R), iters, gmres_res]
        (+ [omega] with the torque unknown, + [motor_torque] whenever the
        flagellum torque dual exists — imposed-rotation runs report the
        transmitted torque too, reference `:4374-4384`)."""
        cfg = self.cfg
        Amv = A if callable(A) else (lambda v: A @ v)  # matrix-free: callable
        x_main = x[:-1] if cfg.solve_with_torque else x
        forces, wall_vel, rigid_vel = split_monolithic_solution(
            x_main, sel_V, self.num_rigid, cfg.assemble_scaling
        )
        F = N_dual_flat @ forces  # rigid forces at the pole (`:4466-4476`)
        F_c = N_dual_c_flat @ forces
        parts = [
            jnp.linalg.norm(Amv(x) - rhs)[None],
            jnp.linalg.norm(rhs)[None],
            rigid_vel,
            diag["mass_body"][None],
            diag["com_body"],
            diag["v_null_residual_pre"][None],
            diag["k_solid_angle_check"],
            F,
            F_c,
            solver_iters[None],
            solver_res[None],
        ]
        if cfg.solve_with_torque:
            parts += [(x[-1] * cfg.assemble_scaling)[None]]
        if torque_dual is not None:
            parts += [jnp.dot(torque_dual, forces)[None]]
        return forces, wall_vel, jnp.concatenate(
            [jnp.asarray(p, x.dtype) for p in parts]
        )

    def _finish_from_solve(self, A, rhs, ops, diag, x, it_dev, res_dev):
        """Shared finish for the fused Direct steps (same packing as the
        dispatch-per-stage path)."""
        return self._finish_impl(
            A,
            x,
            rhs,
            ops["sel_V"],
            diag,
            jax.vmap(flatten)(ops["N_dual"]),
            jax.vmap(flatten)(ops["N_dual_complete"]),
            ops.get("N_flagellum_torque_dual"),
            jnp.asarray(it_dev, A.dtype),
            jnp.asarray(res_dev, A.dtype),
        )

    def _direct_fresh_impl(self, euler, sdot_flat, rotation):
        A, rhs, ops, diag = self._pipeline(euler, sdot_flat, rotation)
        fA = (
            A.astype(self.preconditioner.factor_dtype)
            if self.preconditioner.factor_dtype is not None
            else A
        )
        factors = precond_factor(fA)
        x, info = self._gmres_direct_impl(A, rhs, factors)
        forces, wall, packed = self._finish_from_solve(
            A, rhs, ops, diag, x, info["iterations"], info["residual"]
        )
        return A, rhs, ops, forces, wall, packed, factors

    def _direct_stale_impl(self, euler, sdot_flat, rotation, factors):
        A, rhs, ops, diag = self._pipeline(euler, sdot_flat, rotation)
        x, info = self._gmres_direct_impl(A, rhs, factors)
        forces, wall, packed = self._finish_from_solve(
            A, rhs, ops, diag, x, info["iterations"], info["residual"]
        )
        return A, rhs, ops, forces, wall, packed

    def _gmres_generic_impl(self, A, rhs):
        from .la.preconditioners import build_preconditioner

        cfg = self.cfg
        restart, max_restarts = self._gmres_solver_params()
        bw = cfg.solver.bandwith if cfg.solver.bandwith_preconditioner else None
        precond = build_preconditioner(
            A, cfg.solver.preconditioner_type, bandwith=bw
        ).apply
        return gmres(
            lambda v: A @ v,
            rhs,
            precond=precond,
            restart=restart,
            tol=cfg.solver.tolerance,
            max_restarts=max_restarts,
        )

    # ------------------------------------------------------------------
    def initial_euler(self) -> jnp.ndarray:
        from .fem.geometry import euler_from_mesh

        return jnp.asarray(
            euler_from_mesh(self.mesh.vertices, self.map_space, self.manifold)
        )

    def force_pole_point(self, com_body):
        if self.cfg.force_pole == "Baricenter":
            return com_body
        if self.cfg.force_pole == "Point":
            return jnp.asarray(
                self.cfg.force_arbitrary_point, dtype=com_body.dtype
            )
        return jnp.zeros_like(com_body)

    # ------------------------------------------------------------------
    def flagellum_torque_mode(self, euler, rotation=None):
        """N_flagellum_torque [n, d]: rotation of the flagellum about the
        body-frame x-axis, expressed in world coordinates —
        N(x) = R . (e_x x (R^T x - pole)) on flagellum nodes, 0 elsewhere
        (reference `source/bem_stokes.cc:2657-2670` builds the body-frame
        mode, then `rotate_vector` applies R at `:2770`)."""
        d = self.dim
        if d != 3:
            return jnp.zeros((self.n, d), self.asm_cfg.dtype)
        dt = self.asm_cfg.dtype
        R = (
            jnp.eye(3, dtype=dt)
            if rotation is None
            else jnp.asarray(rotation, dt)
        )
        sp = support_points(
            euler.astype(dt), self.map_space, self.fe_space
        ).astype(dt)
        pole = self.force_pole_point(jnp.zeros((3,), dt))
        body = sp @ R - pole[None, :]  # R^T x (row-vector convention)
        ex = jnp.zeros((3,), dt).at[0].set(1.0)
        mode_body = jnp.cross(jnp.broadcast_to(ex, body.shape), body)
        mode = mode_body @ R.T
        return mode * jnp.asarray(self.flagellum_node_mask, dt)[:, None]

    def flagellum_translation_mode(self):
        """N_flagellum_translation [n, d]: unit x-velocity of the flagellum
        nodes (reference `:2670`, not rotated)."""
        mode = jnp.zeros((self.n, self.dim), self.asm_cfg.dtype)
        return mode.at[:, 0].set(
            jnp.asarray(self.flagellum_node_mask, self.asm_cfg.dtype)
        )

    # ------------------------------------------------------------------
    def _pipeline(self, euler, shape_velocities_flat, rotation=None):
        """Jitted: geometry -> operators -> monolithic system.  Returns the
        system plus diagnostics. shape_velocities_flat is the component-
        blocked [d*n] projected gait velocity; `rotation` is the accumulated
        body rotation matrix (only consulted by the flagellum torque mode)."""
        cfg = self.cfg
        d = self.dim
        n = self.n
        dt = self.asm_cfg.dtype
        euler = euler.astype(dt)

        mass_op, (xq, normals_q, jxw) = build_mass_operator(euler, self.tables)
        body_mask_nodes = jnp.asarray(self.body_node_mask, dt)
        body_mask_cells = jnp.asarray(self.body_cell_mask, dt)

        mass_body, com_body = surface_mass_and_com(xq, jxw, body_mask_cells)
        pole = self.force_pole_point(com_body)

        sp = support_points(euler, self.map_space, self.fe_space).astype(dt)
        N = rigid_modes(sp, pole, node_mask=body_mask_nodes)  # [R, n, d]
        N_complete = rigid_modes(sp, pole)
        N_dual = jax.vmap(mass_op.matvec)(N)
        N_dual_complete = jax.vmap(mass_op.matvec)(N_complete)

        nv = normal_vector_l2(mass_op, normals_q, jxw, body_mask_nodes)
        n_pure_f = flatten(nv["normal_pure"])
        Mn_pure_f = flatten(nv["M_normal_pure"])
        l2g_pure = nv["l2_gamma_pure"]

        V, K = assemble_V_K(euler, sp, self.tables)
        V, Vn_pre = v_nullspace_correction(V, n_pure_f, Mn_pure_f, l2g_pure)
        K, k_check = k_solid_angle_correction(
            K,
            n,
            d,
            use_internal_alpha=cfg.use_internal_alpha,
            component_labels=self.node_component_label,
            component_alpha=self.node_component_alpha,
        )

        def P_t(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g_pure)

        def PKP(v):
            return P_t(K @ P_t(v))

        N_flat = jax.vmap(flatten)(N)  # [R, d*n]
        tmp_N = jax.vmap(PKP)(N_flat)
        N_dual_flat = jax.vmap(flatten)(N_dual)
        rhs_surface = PKP(shape_velocities_flat.astype(dt))

        sel_V = operator_column_mask(
            jnp.asarray(self.node_material), flatten(nv["normal"]), n, d
        )
        torque_mode_flat = None
        torque_dual_flat = None
        tmp_torque = None
        if cfg.solve_with_torque or cfg.imposed_rotation_as_flagellum_shape:
            torque_mode_flat = flatten(self.flagellum_torque_mode(euler, rotation))
            torque_dual_flat = flatten(
                mass_op.matvec(unflatten(torque_mode_flat, d))
            )
            tmp_torque = PKP(torque_mode_flat)
        from .ops.monolithic import imposed_tail_vector

        A, rhs = build_monolithic_system(
            V,
            K,
            sel_V,
            tmp_N,
            N_dual_flat,
            rhs_surface,
            grid_type=cfg.grid_type,
            imposed_component=cfg.imposed_component,
            assemble_scaling=cfg.assemble_scaling,
            tmp_torque=tmp_torque if cfg.solve_with_torque else None,
            torque_dual=torque_dual_flat if cfg.solve_with_torque else None,
            imposed_motor_torque=cfg.imposed_motor_torque,
            imposed_tail=imposed_tail_vector(
                self.num_rigid,
                d,
                cfg.imposed_component,
                angle=cfg.angle_for_imposed_stuff,
                rotate=cfg.extra_debug_info,
                dtype=dt,
            ),
        )
        if self.hanging.n:
            from .mesh.constraints import apply_hanging_constraints_monolithic

            A, rhs = apply_hanging_constraints_monolithic(
                A, rhs, self.hanging, n, d
            )
        diagnostics = dict(
            mass_body=mass_body,
            com_body=com_body,
            v_null_residual_pre=jnp.max(jnp.abs(Vn_pre)),
            k_solid_angle_check=k_check,
        )
        operators = dict(
            # cfg.keep_operators=False drops the dense pair from the jitted
            # outputs (5.4 GB at f64 production scale); the frozen path and
            # the resistance strategy need them and check for None
            V=V if cfg.keep_operators else None,
            K=K if cfg.keep_operators else None,
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
            operators["N_flagellum_torque_dual"] = torque_dual_flat
        return A, rhs, operators, diagnostics

    # ------------------------------------------------------------------
    def solve_frame(self, euler, shape_velocities_flat, rotation=None):
        """Assemble + solve one frame. Returns dict of results (host).
        `rotation` is the accumulated body rotation (flagellum torque mode
        only; identity when omitted)."""
        from .utils import timers

        cfg = self.cfg
        if not cfg.monolithic:
            return self._solve_frame_resistance(euler, shape_velocities_flat)
        if cfg.matrix_free:
            if self._matfree is None:
                from .matfree import MatfreeSolver

                self._matfree = MatfreeSolver(self)
            return self._matfree.solve_frame(
                euler, shape_velocities_flat, rotation
            )
        ptype = cfg.solver.preconditioner_type
        if (
            not cfg.solver.solve_directly
            and ptype == "Direct"
            and not cfg.print_matrices
        ):
            # fused fresh/stale Direct step: ONE device dispatch + ONE
            # packed scalar readback per frame (stale-reuse bookkeeping on
            # the host exactly as before; reference refactor-on-trigger
            # `source/bem_stokes.cc:4336-4339, 5768-5779`)
            with timers.scope("Assemble + LAC Solve (fused)"):
                reuse = (
                    self.preconditioner._factors is not None
                    and self._last_direct_iterations
                    <= cfg.solver.refactor_iteration_trigger
                )
                if reuse:
                    A, rhs, ops, forces, wall, packed_dev = (
                        self._jit_direct_stale(
                            euler,
                            shape_velocities_flat,
                            rotation,
                            self.preconditioner._factors,
                        )
                    )
                    refactored = False
                else:
                    with timers.scope("DirectPreconditioner Refactorisation"):
                        (
                            A,
                            rhs,
                            ops,
                            forces,
                            wall,
                            packed_dev,
                            factors,
                        ) = self._jit_direct_fresh(
                            euler, shape_velocities_flat, rotation
                        )
                        self.preconditioner._factors = factors
                    refactored = True
                packed = np.asarray(packed_dev)
            return self._unpack_result(
                A, rhs, ops, forces, wall, packed, refactored
            )
        with timers.scope("Assemble") as _:
            A, rhs, ops, diag = self._jit_pipeline(
                euler, shape_velocities_flat, rotation
            )
            jax.block_until_ready(A)
        if cfg.print_matrices:
            self._dump_matrices(A, ops)
        return self._solve_monolithic_system(A, rhs, ops, diag)

    def _dump_matrices(self, A, ops, out_dir="."):
        """Txt dumps of the assembled operators (reference `print_matrices`,
        `source/bem_stokes.cc:3362-3430`: monolithic_matrix.txt,
        V_matrix.txt, K_matrix.txt, Mass_matrix.txt, normals_matrix.txt
        written into the working directory)."""
        import os

        if ops.get("V") is None:
            raise ValueError(
                "print_matrices needs the assembled V/K operators; run "
                "with cfg.keep_operators=True"
            )
        np.savetxt(os.path.join(out_dir, "monolithic_matrix.txt"), np.asarray(A))
        np.savetxt(os.path.join(out_dir, "V_matrix.txt"), np.asarray(ops["V"]))
        np.savetxt(os.path.join(out_dir, "K_matrix.txt"), np.asarray(ops["K"]))
        np.savetxt(
            os.path.join(out_dir, "normals_matrix.txt"),
            np.asarray(ops["normal"]["normal"]),
        )
        # dense consistent mass (operator-form internally; materialized only
        # under this debug flag)
        eye = jnp.eye(self.n, dtype=self.asm_cfg.dtype)
        jxw = ops["mass_jxw"]
        from .physics.rigid import MassOperator

        mop = MassOperator(
            self.n, self.tables.cells_nodes_fe, self.tables.phi_fe, jxw
        )
        M = jax.vmap(lambda col: mop.matvec(col))(eye)
        np.savetxt(os.path.join(out_dir, "Mass_matrix.txt"), np.asarray(M).T)

    # ------------------------------------------------------------------
    def solve_frame_frozen(self, prev_result, shape_velocities_flat):
        """Frozen-geometry fast path: reuse the previous frame's operators
        and monolithic matrix, recompute only the surface rhs from the new
        gait velocity, and re-solve (the reference's squirmer branch that
        skips `assemble_stokes_system` when `squirmer_change_geometry` is
        false, `source/bem_stokes.cc:5734-5759`).  Only meaningful for
        grid_type == "Real" (the rhs is sdot-independent otherwise)."""
        A = prev_result["A"]
        ops = prev_result["operators"]
        if ops.get("K") is None:
            raise ValueError(
                "solve_frame_frozen needs the previous frame's K operator; "
                "run with cfg.keep_operators=True"
            )
        diag = {k: jnp.asarray(v) for k, v in prev_result["diagnostics"].items()}
        rhs = self._jit_frozen_rhs(
            ops["K"],
            flatten(ops["normal"]["normal_pure"]),
            flatten(ops["normal"]["M_normal_pure"]),
            ops["normal"]["l2_gamma_pure"],
            shape_velocities_flat,
        )
        return self._solve_monolithic_system(A, rhs, ops, diag)

    def _frozen_rhs(self, K, n_pure_f, Mn_pure_f, l2g_pure, sdot_flat):
        dt = self.asm_cfg.dtype
        d, n = self.dim, self.n

        def P_t(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g_pure)

        rhs_surface = P_t(K @ P_t(sdot_flat.astype(dt)))
        tail_len = self.num_rigid + (1 if self.cfg.solve_with_torque else 0)
        rhs = jnp.concatenate([rhs_surface, jnp.zeros((tail_len,), dt)])
        if self.hanging.n:
            comp = np.arange(d)[:, None] * n
            rows = (self.hanging.slaves[None, :] + comp).reshape(-1)
            rhs = rhs.at[rows].set(0.0)
        return rhs

    # ------------------------------------------------------------------
    def _solve_monolithic_system(self, A, rhs, ops, diag):
        from .utils import timers

        cfg = self.cfg
        d = self.dim
        R = self.num_rigid
        refactored = False
        with timers.scope("LAC Solve"):
            if cfg.solver.solve_directly:
                x = lu_solve_dense(lu_factor_dense(A), rhs)
                it_dev = jnp.ones((), A.dtype)
                # true residual, reported like the GMRES paths
                res_dev = jnp.linalg.norm(A @ x - rhs)
            else:
                ptype = cfg.solver.preconditioner_type
                if ptype == "Direct":
                    # stale-LU: reuse the factors of an earlier frame; only
                    # refactor if the PREVIOUS solve exceeded the trigger
                    # (reference `source/bem_stokes.cc:4336-4339, 5768-5779`)
                    with timers.scope("DirectPreconditioner Refactorisation"):
                        refactored = self.preconditioner.maybe_refactor(
                            A, self._last_direct_iterations
                        )
                    x, info = self._jit_gmres_direct(
                        A, rhs, self.preconditioner._factors
                    )
                else:
                    x, info = self._jit_gmres_generic(A, rhs)
                it_dev = info["iterations"]
                res_dev = info["residual"]

            # ONE fused finish dispatch + ONE packed host readback for every
            # per-frame scalar (iterations, residuals, rigid velocities,
            # diagnostics, rigid force sums, motor torque).  ops carries the
            # torque dual for imposed-rotation runs too; only the
            # solve_with_torque system has the extra unknown to strip
            torque_dual = ops.get("N_flagellum_torque_dual")
            forces, wall_vel, packed_dev = self._jit_finish(
                A,
                x,
                rhs,
                ops["sel_V"],
                diag,
                jax.vmap(flatten)(ops["N_dual"]),
                jax.vmap(flatten)(ops["N_dual_complete"]),
                torque_dual,
                jnp.asarray(it_dev, A.dtype),
                jnp.asarray(res_dev, A.dtype),
            )
            packed = np.asarray(packed_dev)
        return self._unpack_result(
            A, rhs, ops, forces, wall_vel, packed, refactored
        )

    def _unpack_result(self, A, rhs, ops, forces, wall_vel, packed, refactored):
        """Unpack the fused finish's packed scalar vector (layout documented
        on _finish_impl) into the result dict; host-side bookkeeping for the
        stale-LU refactor trigger and the convergence warning."""
        cfg = self.cfg
        d = self.dim
        R = self.num_rigid
        o = 0

        def take(k):
            nonlocal o
            out = packed[o : o + k]
            o += k
            return out

        residual = float(take(1)[0])
        b_norm = float(take(1)[0])
        rigid_vel = take(R)
        host_diag = dict(
            mass_body=take(1)[0],
            com_body=take(d),
            v_null_residual_pre=take(1)[0],
            k_solid_angle_check=take(d),
        )
        F_pole = take(R)
        F_complete = take(R)
        iters = int(take(1)[0])
        gmres_res = float(take(1)[0])

        converged = True
        if not cfg.solver.solve_directly:
            if cfg.solver.preconditioner_type == "Direct":
                self._last_direct_iterations = iters
            converged = gmres_res <= cfg.solver.tolerance * (
                b_norm if b_norm > 0 else 1.0
            ) * 1.0001
            if not converged:
                import warnings

                warnings.warn(
                    f"GMRES did not converge in {iters} iterations "
                    f"(residual {gmres_res:.3e}, "
                    f"max_steps {cfg.solver.max_steps})",
                    stacklevel=2,
                )

        extra = {}
        if cfg.solve_with_torque:
            # the motor-balance unknown: flagellum rotation rate omega
            # (reference `:4398-4410`); the effective gait velocity is
            # omega * N_flagellum_torque
            flagellum_omega = float(take(1)[0])
            extra["flagellum_omega"] = flagellum_omega
            extra["shape_velocities"] = (
                flagellum_omega * ops["N_flagellum_torque"]
            )
        if "N_flagellum_torque_dual" in ops:
            # motor torque actually transmitted (reference `:4374`)
            extra["motor_torque"] = float(take(1)[0])
        return dict(
            stokes_forces=forces,
            wall_velocities=wall_vel,
            rigid_velocities=rigid_vel,
            rigid_forces_pole=F_pole,
            rigid_forces_complete=F_complete,
            iterations=iters,
            converged=converged,
            refactored=refactored,
            residual=residual,
            diagnostics=host_diag,
            operators=ops,
            A=A,
            rhs=rhs,
            **extra,
        )

    # ------------------------------------------------------------------
    def _solve_frame_resistance(self, euler, shape_velocities_flat):
        """Non-monolithic grand-resistance-matrix strategy (reference
        `solve_system(monolithic=false)`, `source/bem_stokes.cc:4163-4261`)."""
        import jax as _jax

        from .ops.resistance import solve_resistance_system

        cfg = self.cfg
        if not cfg.keep_operators:
            raise ValueError(
                "the resistance strategy applies V/K directly; run with "
                "cfg.keep_operators=True"
            )
        A, rhs, ops, diag = self._jit_pipeline(euler, shape_velocities_flat)
        nv = ops["normal"]
        N_flat = _jax.vmap(flatten)(ops["N"])
        N_dual_flat = _jax.vmap(flatten)(ops["N_dual"])
        U, forces, res_matrix = solve_resistance_system(
            ops["V"],
            ops["K"],
            shape_velocities_flat.astype(self.asm_cfg.dtype),
            N_flat,
            N_dual_flat,
            flatten(nv["normal_pure"]),
            flatten(nv["M_normal_pure"]),
            nv["l2_gamma_pure"],
            grid_type=cfg.grid_type,
            imposed_component=cfg.imposed_component,
        )
        return dict(
            stokes_forces=forces,
            wall_velocities=jnp.zeros_like(forces),
            rigid_velocities=np.asarray(U),
            resistance_matrix=np.asarray(res_matrix),
            iterations=1,
            residual=0.0,
            diagnostics={k: np.asarray(v) for k, v in diag.items()},
            operators=ops,
            A=A,
            rhs=rhs,
        )

    # ------------------------------------------------------------------
    def shape_velocities_fd(self, euler_now, euler_next, time_step=None):
        """Finite-difference gait velocity projected onto the FE space
        (reference `project_shape_velocities`, `source/bem_stokes.cc:2120`).
        With equal FE and mapping spaces the projection is the identity."""
        dt_step = time_step or self.cfg.time_step
        vel_map = (euler_next - euler_now) / dt_step  # [n_map, d]
        if self.cfg.fe_degree == self.cfg.map_degree:
            return flatten(vel_map)
        # degree mismatch: evaluate the map-space velocity field at the FE
        # support points (nodal interpolation — exact whenever the gait
        # velocity is polynomial of map degree on each cell; the reference
        # instead L2-projects via a mass solve, `source/bem_stokes.cc:
        # 2145-2242`, which agrees at these collocation semantics)
        return flatten(support_points(vel_map, self.map_space, self.fe_space))


def load_frame_mesh(cfg: ProblemConfig, frame: int) -> SurfaceMesh:
    path = (
        f"{cfg.input_grid_path}{cfg.input_grid_base_name}{frame}."
        f"{cfg.input_grid_format}"
    )
    return read_mesh(path, dim=cfg.dim)
