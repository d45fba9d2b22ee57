"""Distributed blocked-LU preconditioner (`parallel.lu`) on the 8-virtual-
device mesh — the sharded DirectPreconditioner (reference
`source/direct_preconditioner.cc`, stale-reuse trigger `source/bem_stokes.cc:
4336-4339, 5768-5779`; SURVEY.md section 7.3 "hardest kernel").

Covers: the raw factor/solve vs numpy, the bordered (Schur) rigid-tail fold
inside `make_sharded_frame_step` reaching the reference's 1-iteration
operating point, stale reuse across frames with the refactor trigger, and
the f32 mixed-precision factor path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.mesh import read_mesh
from bemstokes_tpu.problem import StokesBEMProblem
from bemstokes_tpu.fem.geometry import euler_from_mesh
from bemstokes_tpu.parallel import row_mesh
from bemstokes_tpu.parallel.sharded import (
    padded_rows,
    flat_to_slab,
    slab_to_flat,
)
from bemstokes_tpu.parallel.lu import (
    slab_reorder_columns,
    slab_lu_factor,
    slab_lu_solve,
)
from bemstokes_tpu.parallel.solve import make_sharded_frame_step


@pytest.mark.parametrize("n", [13, 16, 40])
def test_slab_lu_matches_numpy(n):
    """Factor + solve of a random diagonally-dominant matrix in slab layout
    vs numpy, with garbage in the padded rows (the reorder must fix them).
    n = 13/40 exercise ragged padding, n = 16 the exact-multiple case."""
    mesh = row_mesh(8)
    d = 3
    rng = np.random.default_rng(0)
    A = rng.standard_normal((d * n, d * n)) + 4.0 * np.eye(d * n)
    ndev = 8
    _, nloc = padded_rows(n, mesh)
    m = d * nloc
    s = np.arange(ndev * m)
    node = (s // m) * nloc + (s % m) % nloc
    comp = (s % m) // nloc
    A_slab = rng.standard_normal((ndev * m, d * n))  # junk padded rows
    valid = node < n
    A_slab[valid] = A[comp[valid] * n + node[valid]]

    A2 = slab_reorder_columns(jnp.asarray(A_slab), n, d, mesh)
    lu, perm = slab_lu_factor(A2, mesh)
    b = rng.standard_normal(d * n)
    x = slab_to_flat(
        slab_lu_solve(lu, perm, flat_to_slab(jnp.asarray(b), n, d, mesh), mesh),
        n,
        d,
        mesh,
    )
    assert np.abs(np.asarray(x) - np.linalg.solve(A, b)).max() < 1e-10


def _sphere_problem(reference_grid_dir, **solver_kw):
    mesh = read_mesh(f"{reference_grid_dir}/sphere_translation_0.msh", dim=3)
    mesh1 = read_mesh(f"{reference_grid_dir}/sphere_translation_1.msh", dim=3)
    cfg = ProblemConfig(
        grid_type="Real",
        force_pole="Origin",
        solver=SolverConfig(preconditioner_type="Direct", **solver_kw),
    )
    prob = StokesBEMProblem(mesh, cfg)
    euler0 = prob.initial_euler()
    euler1 = jnp.asarray(euler_from_mesh(mesh1.vertices, prob.map_space))
    sdot = prob.shape_velocities_fd(euler0, euler1)
    return prob, euler0, euler1, sdot


def test_direct_sharded_one_iteration_and_agreement(reference_grid_dir):
    """Fresh distributed LU + bordered tail = exact monolithic inverse: the
    GMRES hits the reference's 1-iteration operating point
    (`tests/sphere_translation.output:30`) and matches the single-chip
    Direct solve to 1e-7."""
    prob, euler0, _, sdot = _sphere_problem(reference_grid_dir)
    res_ref = prob.solve_frame(euler0, sdot)
    step = make_sharded_frame_step(prob, row_mesh())
    U, _, info = step(euler0, sdot)
    assert int(info["iterations"]) <= 2
    assert step.stale_state["refactored"] is True
    assert np.allclose(
        np.asarray(U), res_ref["rigid_velocities"], atol=1e-7
    )


def test_direct_sharded_stale_reuse_semantics(reference_grid_dir):
    """Reference DirectPreconditioner semantics on the sharded path: factor
    on frame 0, REUSE the stale factors on the next (slightly different)
    geometry, refactor only when the previous iteration count blows past the
    trigger."""
    prob, euler0, euler1, sdot = _sphere_problem(reference_grid_dir)
    step = make_sharded_frame_step(prob, row_mesh())

    _, _, info0 = step(euler0, sdot)
    assert step.stale_state["refactored"] is True
    it0 = int(info0["iterations"])
    assert it0 <= 2

    U1, _, info1 = step(euler1, -sdot)  # new geometry, stale factors
    assert step.stale_state["refactored"] is False
    it1 = int(info1["iterations"])
    assert it1 <= 25  # stale LU is still a strong preconditioner

    # stale solve must still be CORRECT (preconditioner only changes the
    # iteration count, not the answer)
    res1 = prob.solve_frame(euler1, -sdot)
    assert np.allclose(
        np.asarray(U1), res1["rigid_velocities"], atol=1e-7
    )

    # blowup path: pathological previous iteration count -> refactor
    step.stale_state["last_iterations"] = 10_000
    _, _, info2 = step(euler0, sdot)
    assert step.stale_state["refactored"] is True
    assert int(info2["iterations"]) <= 2


def test_direct_sharded_f32_factor_path(reference_grid_dir):
    """preconditioner_dtype=float32 (the mixed-precision preconditioner): f32
    distributed LU preconditioning f64 GMRES still converges in a few
    iterations to the f64 answer."""
    prob, euler0, _, sdot = _sphere_problem(
        reference_grid_dir, preconditioner_dtype="float32"
    )
    res_ref = prob.solve_frame(euler0, sdot)
    step = make_sharded_frame_step(prob, row_mesh())
    U, _, info = step(euler0, sdot)
    assert int(info["iterations"]) <= 10
    assert np.allclose(
        np.asarray(U), res_ref["rigid_velocities"], atol=1e-7
    )
