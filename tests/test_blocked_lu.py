"""The single-device dense LU (`la.direct`): jax.scipy's LU with full
partial pivoting (cuSOLVER getrf on a GPU) at every size, used as the
stale-LU GMRES preconditioner with the reference's refactor trigger, whose
apply substitutes block by block through inverted diagonal blocks."""

import numpy as np
import jax.numpy as jnp
import pytest

from bemstokes_tpu.la.direct import (
    lu_factor_dense,
    lu_solve_dense,
    precond_apply,
    precond_factor,
    LUPreconditioner,
)


def _system(n, seed, shift=5.0):
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.standard_normal((n, n)) + shift * np.eye(n))
    return A, jnp.asarray(rng.standard_normal(n))


def test_blocked_lu_as_gmres_preconditioner():
    """A fresh dense-LU factorization drives GMRES to 1-iteration
    convergence (preconditioner-quality check)."""
    from bemstokes_tpu.la.gmres import gmres

    A, b = _system(400, 2)
    facs = lu_factor_dense(A)
    x, info = gmres(
        lambda v: A @ v,
        b,
        precond=lambda v: lu_solve_dense(facs, v),
        restart=30,
        tol=1e-12,
        max_restarts=3,
    )
    assert int(info["iterations"]) == 1
    assert np.abs(np.asarray(A @ x - b)).max() < 1e-9


@pytest.mark.parametrize(
    "n, block", [(300, 128), (256, 128), (50, 128), (129, 128)]
)
def test_block_inverse_apply_matches_lu_solve(n, block):
    """Ragged, exact and single-block tilings: the block-inverse apply
    solves the same pivoted LU as `lu_solve`."""
    A, b = _system(n, 5 + n)
    facs = precond_factor(A, block=block)
    nb = -(-n // block)
    assert facs[2].shape == facs[3].shape == (nb, min(block, n), min(block, n))
    x = precond_apply(facs, b)
    x_ref = lu_solve_dense(lu_factor_dense(A), b)
    assert x.shape == (n,)
    assert np.abs(np.asarray(x - x_ref)).max() < 1e-12 * np.abs(np.asarray(x_ref)).max()


def test_block_inverse_apply_columns():
    """An [n, k] right-hand side is solved column by column."""
    A, _ = _system(200, 8)
    B = jnp.asarray(np.random.default_rng(9).standard_normal((200, 3)))
    X = precond_apply(precond_factor(A, block=64), B)
    assert np.abs(np.asarray(A @ X - B)).max() < 1e-10


def test_lu_preconditioner_refactor_trigger():
    """Stale-factor reuse: refactor on first use and only after a solve
    that needed more iterations than the trigger (reference
    `source/bem_stokes.cc:4336-4339`)."""
    A, b = _system(64, 3)
    pre = LUPreconditioner(refactor_iteration_trigger=10)
    assert pre.maybe_refactor(A, last_iterations=0)
    first = pre._factors
    assert not pre.maybe_refactor(2.0 * A, last_iterations=10)
    assert pre._factors is first
    assert pre.maybe_refactor(2.0 * A, last_iterations=11)
    x = pre.apply(b)
    assert np.abs(np.asarray(2.0 * A @ x - b)).max() < 1e-10


def test_lu_preconditioner_f32_factor():
    """factor_dtype=float32: f32 factors applied to an f64 vector return
    f64 at f32 accuracy (the mixed-precision preconditioner)."""
    A, b = _system(128, 4)
    pre = LUPreconditioner(factor_dtype=jnp.float32)
    pre.set_up(A)
    assert pre._factors[0].dtype == jnp.float32
    x = pre.apply(b)
    assert x.dtype == jnp.float64
    x_ref = np.linalg.solve(np.asarray(A), np.asarray(b))
    assert np.abs(np.asarray(x) - x_ref).max() < 1e-4 * np.abs(x_ref).max()
