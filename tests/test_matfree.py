"""Matrix-free (assembly-fused) monolithic GMRES vs the materialized path.

The matrix-free operator (bemstokes_tpu.matfree) recomputes the smooth bulk
inside the GMRES matvec and applies the exact sparse / low-rank / diagonal
corrections functionally; every configuration here must match the
materialized solve to 1e-7.  Geometry is built in code: the
refinement-2 sphere (98 nodes) and the head + helical flagellum bacterium."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bemstokes_tpu.config import (
    ProblemConfig,
    SolverConfig,
    WallConfig,
    WallRefinementConfig,
)
from bemstokes_tpu.flagella import create_bacterium_mesh
from bemstokes_tpu.mesh.refine import refine_uniform, SphericalManifold
from bemstokes_tpu.mesh.factories import add_walls_to_mesh, create_sphere
from bemstokes_tpu.problem import StokesBEMProblem

# the sphere-translation gait: per frame the shape moves by -DX along x and
# stretches fore-aft symmetrically, so the force-free body swims at
# +DX / time_step (the stretch adds no net motion) and the surface forces
# are not trivially zero
DX = 1.0 / 120.0


def _sphere():
    return create_sphere(refinements=2)


def _translation_sdot(prob, euler):
    x = euler[:, 0]
    return prob.shape_velocities_fd(euler, euler.at[:, 0].add(-DX * (1 + 0.5 * x)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _solve_pair(mesh, cfg_kwargs, sdot_fn=None, mesh_ops=None):
    """Solve the same frame materialized and matrix-free; return both."""
    results = []
    for mf in (False, True):
        cfg = ProblemConfig(
            solver=SolverConfig(
                preconditioner_type="Direct", tolerance=1e-11
            ),
            matrix_free=mf,
            matfree_block_nodes=64,
            **cfg_kwargs,
        )
        m = mesh
        if mesh_ops is not None:
            m = mesh_ops(m, cfg)
        prob = StokesBEMProblem(m, cfg)
        euler = prob.initial_euler()
        if sdot_fn is None:
            sdot = jnp.zeros((prob.dim * prob.n,))
        else:
            sdot = sdot_fn(prob, euler)
        results.append(prob.solve_frame(euler, sdot))
    return results


def _check_pair(res_mat, res_mf, tol=1e-7):
    assert _rel(res_mf["rigid_velocities"], res_mat["rigid_velocities"]) < tol
    assert _rel(res_mf["stokes_forces"], res_mat["stokes_forces"]) < tol
    dm, df = res_mat["diagnostics"], res_mf["diagnostics"]
    assert _rel(df["v_null_residual_pre"], dm["v_null_residual_pre"]) < 1e-9
    assert np.allclose(
        np.asarray(df["k_solid_angle_check"]),
        np.asarray(dm["k_solid_angle_check"]),
        atol=1e-9,
    )
    # the matrix-free finish reports the TRUE residual of the implicit
    # operator; the solve must actually have converged
    assert res_mf["converged"]


def test_matfree_sphere_translation():
    """Real-grid translating sphere: U, forces, diagnostics match to 1e-7
    and the known velocity is recovered."""
    res_mat, res_mf = _solve_pair(
        _sphere(), dict(grid_type="Real", force_pole="Origin"), _translation_sdot
    )
    _check_pair(res_mat, res_mf)
    exact = DX / 0.1
    assert abs(res_mf["rigid_velocities"][0] - exact) / exact < 2e-2


def test_matfree_imposed_force_adaptive():
    """ImposedForce mobility solve WITH adaptive quadrature (near-pair COO
    deltas in the implicit operator)."""
    from bemstokes_tpu.config import QuadratureConfig

    res_mat, res_mf = _solve_pair(
        _sphere(),
        dict(
            grid_type="ImposedForce",
            imposed_component=0,
            force_pole="Origin",
            quadrature=QuadratureConfig(order=4, order_far=2, near_panels=8),
        ),
    )
    _check_pair(res_mat, res_mf)


def test_matfree_hanging_nodes_walls():
    """The Lorentz refined-wall configuration: hanging-node constraints,
    resolved no-slip wall, component-restricted solid angle, and
    ImposedVelocity tail — all through the implicit operator."""
    H = 2.0
    cfg_kwargs = dict(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        body_manifold="sphere",
        alpha_row_sum="component",
        walls=(
            WallConfig(
                enabled=True,
                wall_type="no_slip",
                position=(0.0, -H, 0.0),
                span=(8.0, 0.0, 8.0),
            ),
        ),
        wall_refinement=WallRefinementConfig(
            enabled=True, threshold=1.0, distance_from_center=3.0
        ),
    )

    def mesh_ops(m, cfg):
        m = refine_uniform(m, SphericalManifold(), times=1)
        return add_walls_to_mesh(m, cfg)

    res_mat, res_mf = _solve_pair(
        create_sphere(refinements=1), cfg_kwargs, mesh_ops=mesh_ops
    )
    _check_pair(res_mat, res_mf)


def test_matfree_free_surface_kernel():
    """reflect_kernel (free-surface image Green's function) through the
    matrix-free sweep's image fold: the implicit monolithic operator acts
    like the materialized A.  (The image-kernel monolithic system on a lone
    sphere is numerically singular — three zero singular values at any
    resolution, ROADMAP — so a solve cannot be compared to 1e-7.)"""
    from bemstokes_tpu.matfree import MatfreeSolver

    cfg = ProblemConfig(
        grid_type="Real",
        force_pole="Origin",
        reflect_kernel=True,
        walls=(
            WallConfig(
                enabled=True,
                wall_type="free_surface",
                position=(0.0, -2.0, 0.0),
                span=(0.0, 0.0, 0.0),
            ),
        ),
    )
    prob = StokesBEMProblem(_sphere(), cfg)
    euler = prob.initial_euler()
    sdot = _translation_sdot(prob, euler)
    A, rhs, _, _ = prob._jit_pipeline(euler, sdot, None)
    mf = MatfreeSolver(prob)
    sys_, _, _ = mf._jit_setup(euler, sdot, jnp.eye(3))
    x = jnp.asarray(np.random.default_rng(3).standard_normal(A.shape[0]))
    assert _rel(mf._matvec(sys_)(x), A @ x) < 1e-9
    assert _rel(sys_["rhs"], rhs) < 1e-9


def test_matfree_torque():
    """solve_with_torque: the motor-torque row/column ride the bordered
    Schur tail of the matrix-free preconditioner."""
    res_mat, res_mf = _solve_pair(
        create_bacterium_mesh(),
        dict(grid_type="Real", force_pole="Origin", solve_with_torque=True),
    )
    _check_pair(res_mat, res_mf)
    assert res_mf["flagellum_omega"] == pytest.approx(
        res_mat["flagellum_omega"], rel=1e-7
    )
    assert res_mf["motor_torque"] == pytest.approx(-2.0, rel=1e-7)
