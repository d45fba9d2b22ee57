"""End-to-end solves with image kernels and mixed wall BCs (reference
`tests/reflected_kernel_test_velocity.cc`, `wall_kernel_test_velocity.cc`,
`stokeselet_wall_test.cc`, and the per-BC column selection of the monolithic
build `source/bem_stokes.cc:3196-3243`).  The body is the in-code unit
sphere at refinement 2 (98 nodes)."""

import numpy as np
import jax.numpy as jnp
import pytest

from bemstokes_tpu.config import ProblemConfig, SolverConfig, WallConfig
from bemstokes_tpu.mesh.factories import add_walls_to_mesh, create_sphere
from bemstokes_tpu.problem import StokesBEMProblem
from bemstokes_tpu.physics.rigid import flatten
from bemstokes_tpu.postprocess import evaluate_stokes_bie

SPHERE_REFINEMENTS = 2


def _solve_translating_sphere(cfg, refine=0):
    mesh = create_sphere(refinements=SPHERE_REFINEMENTS + refine)
    mesh = add_walls_to_mesh(mesh, cfg)
    prob = StokesBEMProblem(mesh, cfg)
    res = prob.solve_frame(prob.initial_euler(), jnp.zeros((3 * prob.n,)))
    return prob, res


def _wall_plane_velocity(prob, res, wall_y, imposed=0):
    """Evaluate the BIE velocity on a grid of points in the image plane."""
    xs = np.linspace(-6.0, 6.0, 5)
    pts = np.array([[x, wall_y, z] for x in xs for z in xs])
    # boundary velocity trace of the ImposedVelocity solve = rigid mode
    u_flat = flatten(jnp.asarray(res["operators"]["N"][imposed]))
    euler = prob.initial_euler()
    return np.asarray(
        evaluate_stokes_bie(
            jnp.asarray(pts), u_flat, res["stokes_forces"], euler, prob.tables
        )
    )


def test_free_surface_image_solve():
    """reflect_kernel: solve a sphere translating parallel to a free surface
    at y = -3; the velocity NORMAL to the symmetry plane must vanish on the
    plane (reference `reflected_kernel_test_velocity.cc:66-108`, tol 1e-8)."""
    wall_y = -3.0
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        reflect_kernel=True,
        walls=(
            WallConfig(
                enabled=False,  # image plane only, no wall panels
                position=(0.0, wall_y, 0.0),
                span=(10.0, 0.0, 10.0),
            ),
        ),
        solver=SolverConfig(solve_directly=True),
    )
    prob, res = _solve_translating_sphere(cfg)
    assert res["residual"] < 1e-8
    u = _wall_plane_velocity(prob, res, wall_y)
    assert np.max(np.abs(u[:, 1])) < 1e-8  # normal component vanishes
    # the tangential flow on a free surface is NOT zero (slip plane)
    assert np.max(np.abs(u[:, 0])) > 1e-4


def test_no_slip_image_solve_wall_velocity_and_drag():
    """no_slip_kernel (Blake image): the full velocity must vanish on the
    wall plane, and the drag of a sphere translating parallel to the wall at
    h = 4 radii must match the Lorentz wall correction
    F = 6 pi / (1 - 9a/(16h)) to O((a/h)^3) (reference
    `wall_kernel_test_velocity.cc`)."""
    wall_y = -4.0
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        no_slip_kernel=True,
        body_manifold="sphere",
        walls=(
            WallConfig(
                enabled=False,
                position=(0.0, wall_y, 0.0),
                span=(10.0, 0.0, 10.0),
            ),
        ),
        solver=SolverConfig(solve_directly=True),
    )
    prob, res = _solve_translating_sphere(cfg, refine=1)
    assert res["residual"] < 1e-8
    u = _wall_plane_velocity(prob, res, wall_y)
    assert np.max(np.abs(u)) < 1e-8  # ALL components vanish on the wall
    N_dual = res["operators"]["N_dual"]
    F = float(
        jnp.dot(flatten(jnp.asarray(N_dual[0])), res["stokes_forces"])
    )
    lorentz = 6.0 * np.pi / (1.0 - 9.0 / (16.0 * 4.0))
    assert abs(F) == pytest.approx(lorentz, rel=0.04)
    # and strictly MORE drag than in free space
    assert abs(F) > 6.0 * np.pi * 1.05


def test_free_surface_image_vs_explicit_mirror_body():
    """The free-surface image solve must agree with the EXPLICIT mirror-body
    solve (sphere + reflected sphere in free space, same imposed parallel
    velocity) — the image system is the analytic elimination of the mirror
    unknowns, so the two are the same discrete problem up to round-off
    (observed 2.4e-14; the reference's `reflected_kernel_test_G_comparison`
    family checks the same identity at kernel level)."""
    from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh
    from bemstokes_tpu.fem.geometry import support_points

    plane_y = -3.0
    mesh = create_sphere(refinements=SPHERE_REFINEMENTS)
    cfg_i = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        reflect_kernel=True,
        walls=(
            WallConfig(
                enabled=False, position=(0.0, plane_y, 0.0), span=(10.0, 0.0, 10.0)
            ),
        ),
        solver=SolverConfig(solve_directly=True),
    )
    prob_i = StokesBEMProblem(mesh, cfg_i)
    res_i = prob_i.solve_frame(prob_i.initial_euler(), jnp.zeros((3 * prob_i.n,)))
    F_i = float(
        jnp.dot(
            flatten(jnp.asarray(res_i["operators"]["N_dual"][0])),
            res_i["stokes_forces"],
        )
    )
    # explicit mirror body: reflect vertices across the plane, flip cell
    # orientation to keep outward normals
    mv = mesh.vertices.copy()
    mv[:, 1] = 2 * plane_y - mv[:, 1]
    mirror = SurfaceMesh(mv, mesh.cells[:, [1, 0, 3, 2]], mesh.material_id.copy())
    two = mesh.merged_with(mirror)
    cfg_2 = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        solver=SolverConfig(solve_directly=True),
    )
    prob_2 = StokesBEMProblem(two, cfg_2)
    res_2 = prob_2.solve_frame(prob_2.initial_euler(), jnp.zeros((3 * prob_2.n,)))
    sp2 = np.asarray(
        support_points(prob_2.initial_euler(), prob_2.map_space, prob_2.fe_space)
    )
    top = (sp2[:, 1] > plane_y).astype(float)
    Ndual_top = np.asarray(res_2["operators"]["N_dual"][0]) * top[:, None]
    F_2 = float(
        np.dot(
            np.asarray(flatten(jnp.asarray(Ndual_top))),
            np.asarray(res_2["stokes_forces"]),
        )
    )
    assert F_i == pytest.approx(F_2, rel=1e-10)
    # a parallel free surface REDUCES drag below free space (slip plane)
    assert abs(F_i) < 6.0 * np.pi


def test_resolved_no_slip_wall_monotonicity():
    """Explicitly meshed no-slip wall: drag exceeds free space and decays
    monotonically toward it as the wall recedes (reference
    `stokeselet_wall_test.cc` exercises the resolved-wall path).  Free space
    is the same sphere without a wall: the 98-node sphere's own drag sits
    1.0e-2 below Stokes' law, more than a distant wall patch adds."""
    drags = []
    for dist in (8.0, 16.0, 30.0, None):
        walls = ()
        if dist is not None:
            walls = (
                WallConfig(
                    enabled=True,
                    wall_type="no_slip",
                    position=(0.0, -dist, 0.0),
                    span=(8.0, 0.0, 8.0),
                ),
            )
        cfg = ProblemConfig(
            grid_type="ImposedVelocity",
            imposed_component=0,
            force_pole="Origin",
            walls=walls,
            solver=SolverConfig(solve_directly=True),
        )
        prob, res = _solve_translating_sphere(cfg)
        assert res["residual"] < 1e-8
        drags.append(
            abs(
                float(
                    jnp.dot(
                        flatten(jnp.asarray(res["operators"]["N_dual"][0])),
                        res["stokes_forces"],
                    )
                )
            )
        )
    assert drags[0] > drags[1] > drags[2] > drags[3]
    assert drags[2] == pytest.approx(6.0 * np.pi, rel=0.05)


def test_mixed_bc_wall_column_branches():
    """dirichlet / neumann / do-nothing walls exercise every
    operator_column_mask branch in one solve: tractions are the unknown on
    V-columns, velocities on K-columns, the solve is consistent, and distant
    walls leave the sphere drag near Stokes law."""
    from bemstokes_tpu.mesh.surface_mesh import (
        MATERIAL_WALL_DIRICHLET,
        MATERIAL_WALL_NEUMANN,
        MATERIAL_WALL_DO_NOTHING,
    )

    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        walls=(
            WallConfig(
                enabled=True,
                wall_type="dirichlet",
                position=(0.0, -8.0, 0.0),
                span=(8.0, 0.0, 8.0),
            ),
            WallConfig(
                enabled=True,
                wall_type="neumann",
                position=(0.0, 8.0, 0.0),
                span=(8.0, 0.0, 8.0),
            ),
            WallConfig(
                enabled=True,
                wall_type="do_nothing",
                position=(8.0, 0.0, 0.0),
                span=(0.0, 8.0, 8.0),
            ),
        ),
        solver=SolverConfig(solve_directly=True),
    )
    prob, res = _solve_translating_sphere(cfg)
    assert res["residual"] < 1e-8
    sel = np.asarray(res["operators"]["sel_V"])
    forces = np.asarray(res["stokes_forces"])
    wall_vel = np.asarray(res["wall_velocities"])
    # split respects the column mask exactly
    assert np.all(forces[~sel] == 0)
    assert np.all(wall_vel[sel] == 0)
    # every branch is actually populated
    mats = np.tile(prob.node_material, 3)
    assert np.any(sel & (mats == MATERIAL_WALL_DIRICHLET))
    assert np.any(~sel & (mats == MATERIAL_WALL_NEUMANN))
    assert np.any(sel & (mats == MATERIAL_WALL_DO_NOTHING))
    assert np.any(~sel & (mats == MATERIAL_WALL_DO_NOTHING))
    # neumann/do-nothing wall velocities came out finite and nonzero
    assert np.all(np.isfinite(wall_vel))
    assert np.max(np.abs(wall_vel)) > 1e-8
    # walls only ADD drag; coarse open patches overestimate the blockage
    # (the row-sum solid-angle correction absorbs the patches' double-layer
    # tail, a systematic the reference's algorithm shares), so bound rather
    # than pin: above free space, below 2x
    F = float(
        jnp.dot(
            flatten(jnp.asarray(res["operators"]["N_dual"][0])),
            res["stokes_forces"],
        )
    )
    assert 6.0 * np.pi < abs(F) < 2.0 * 6.0 * np.pi


def test_single_wall_type_drags_physical():
    """Each wall type alone, at distance 8: drag stays within a physical
    band above Stokes law, and the rigid no-slip-like (dirichlet) wall blocks
    at least as much as the traction-free (neumann) one."""
    drags = {}
    for wt in ("dirichlet", "neumann", "do_nothing", "free_surface"):
        cfg = ProblemConfig(
            grid_type="ImposedVelocity",
            imposed_component=0,
            force_pole="Origin",
            walls=(
                WallConfig(
                    enabled=True,
                    wall_type=wt,
                    position=(0.0, -8.0, 0.0),
                    span=(8.0, 0.0, 8.0),
                ),
            ),
            solver=SolverConfig(solve_directly=True),
        )
        prob, res = _solve_translating_sphere(cfg)
        assert res["residual"] < 1e-8
        drags[wt] = abs(
            float(
                jnp.dot(
                    flatten(jnp.asarray(res["operators"]["N_dual"][0])),
                    res["stokes_forces"],
                )
            )
        )
    for wt, F in drags.items():
        assert 6.0 * np.pi < F < 1.25 * 6.0 * np.pi, (wt, F)
    assert drags["dirichlet"] > drags["neumann"]
