"""Preconditioner family (reference selection `source/bem_stokes.cc:4283-4313`,
banded variant `:1724-1761`): every member must drive GMRES on the monolithic
sphere system to the same solution as the direct solve.  The sphere is the
in-code refinement-2 sphere (98 nodes)."""

import numpy as np
import jax.numpy as jnp
import pytest

from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.mesh.factories import create_sphere
from bemstokes_tpu.problem import StokesBEMProblem
from bemstokes_tpu.la.gmres import gmres
from bemstokes_tpu.la.direct import lu_factor_dense, lu_solve_dense
from bemstokes_tpu.la.preconditioners import build_preconditioner, band_mask


@pytest.fixture(scope="module")
def monolithic_system():
    mesh = create_sphere(refinements=2)
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        solver=SolverConfig(solve_directly=True),
    )
    prob = StokesBEMProblem(mesh, cfg)
    res = prob.solve_frame(prob.initial_euler(), jnp.zeros((3 * prob.n,)))
    return res["A"], res["rhs"]


@pytest.mark.parametrize("kind", ["Jacobi", "SOR", "SSOR", "ILU", "AMG", "Direct"])
def test_preconditioned_gmres_matches_direct(monolithic_system, kind):
    A, rhs = monolithic_system
    x_ref = lu_solve_dense(lu_factor_dense(A), rhs)
    P = build_preconditioner(A, kind, n_blocks=4)
    x, info = gmres(
        lambda v: A @ v, rhs, precond=P.apply, restart=60, tol=1e-12,
        max_restarts=8,
    )
    assert np.linalg.norm(np.asarray(A @ x - rhs)) < 1e-8
    assert np.allclose(np.asarray(x), np.asarray(x_ref), atol=1e-6)
    if kind == "Direct":
        assert int(info["iterations"]) <= 2  # fresh LU: 1 iteration


def test_banded_preconditioner(monolithic_system):
    A, rhs = monolithic_system
    P = build_preconditioner(A, "Direct", bandwith=50)
    x, info = gmres(
        lambda v: A @ v, rhs, precond=P.apply, restart=100, tol=1e-12,
        max_restarts=8,
    )
    assert np.linalg.norm(np.asarray(A @ x - rhs)) < 1e-8
    # band mask keeps the diagonal and drops far off-band entries
    B = band_mask(A, 50)
    n = A.shape[0]
    assert np.allclose(np.diagonal(np.asarray(B)), np.diagonal(np.asarray(A)))
    assert float(B[0, n - 1]) == 0.0


def test_problem_level_dispatch():
    mesh = create_sphere(refinements=2)
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        solver=SolverConfig(
            solve_directly=False, preconditioner_type="SSOR", tolerance=1e-10
        ),
    )
    prob = StokesBEMProblem(mesh, cfg)
    res = prob.solve_frame(prob.initial_euler(), jnp.zeros((3 * prob.n,)))
    assert res["residual"] < 1e-8
    assert abs(res["rigid_velocities"][0] - 1.0) < 1e-10
