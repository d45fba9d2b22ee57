"""Dense LU direct solver / stale-LU preconditioner.

The reference's DirectPreconditioner wraps a Trilinos Amesos LU: factor the
monolithic matrix once, apply the (possibly stale) factorization as a
preconditioner on later frames, and refactor when GMRES iteration counts blow
past a trigger (reference `include/direct_preconditioner.h:25-27`,
`source/bem_stokes.cc:4336-4339, 5768-5779`).

The factorization is jax.scipy's LU with full partial pivoting (cuSOLVER
getrf on a GPU) at every single-device size; the sharded variant lives in
`bemstokes_tpu.parallel.lu`.

A stale factor is applied once per GMRES iteration, so the preconditioner
keeps its factors in a form whose apply is made of matrix-vector products:
the LU plus the inverses of the diagonal blocks of L and U
(`precond_factor` / `precond_apply`).  cuSOLVER's getrs runs the two
triangular solves as single-column trsm, which streams the factor far
below memory bandwidth.  At 18,444 f64 unknowns on an H100 (80 GB HBM3,
400 W limit): getrf 0.21 s, then 1.4 ms per apply against getrs's 7.0 ms
and the 3.2 ms of a blocked LU with block-local pivoting (whose factor
takes 0.56 s); GMRES iterations are the same under all three.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

# rows per diagonal block of the preconditioner apply: each substitution
# step is one [block, block] inverse product plus one off-diagonal panel
# product.  At 18,444 unknowns on an H100, 2048 applies in 1.4 ms (1024:
# 1.5 ms, 512: 1.9 ms); every step has its own shape, so fewer blocks also
# compile faster (7 s against 15 s and 35 s)
APPLY_BLOCK = 2048


@jax.jit
def lu_factor_dense(A: jnp.ndarray):
    return jax.scipy.linalg.lu_factor(A)


@jax.jit
def lu_solve_dense(factors, b: jnp.ndarray):
    return jax.scipy.linalg.lu_solve(factors, b)


@partial(jax.jit, static_argnames=("block",))
def precond_factor(A: jnp.ndarray, block: int = APPLY_BLOCK):
    """Stale-LU preconditioner factors (lu, perm, linv, uinv): the LU with
    partial pivoting, its row permutation, and the inverses of L's and U's
    [block, block] diagonal blocks ([nb, block, block]; a ragged last block
    is padded with the identity)."""
    n = A.shape[0]
    lu, piv = jax.scipy.linalg.lu_factor(A)
    perm = jax.lax.linalg.lu_pivots_to_permutation(piv, n)
    B = min(block, n)
    eye = jnp.eye(B, dtype=lu.dtype)
    diag = []
    for s in range(0, n, B):
        m = min(B, n - s)
        diag.append(eye.at[:m, :m].set(lu[s : s + m, s : s + m]))
    D = jnp.stack(diag)
    eyes = jnp.broadcast_to(eye, D.shape)
    linv = jax.lax.linalg.triangular_solve(
        jnp.tril(D, -1) + eye, eyes, left_side=True, lower=True, unit_diagonal=True
    )
    uinv = jax.lax.linalg.triangular_solve(
        jnp.triu(D), eyes, left_side=True, lower=False
    )
    return lu, perm, linv, uinv


@jax.jit
def precond_apply(factors, b: jnp.ndarray):
    """Solve L U x = P b with `precond_factor` factors by block forward and
    back substitution, every step a matrix-vector product; b is [n] or
    [n, k]."""
    lu, perm, linv, uinv = factors
    n = lu.shape[0]
    B = linv.shape[1]
    bounds = [(s, min(s + B, n)) for s in range(0, n, B)]
    x = b.astype(lu.dtype)[perm]
    y = []
    for j, (s, e) in enumerate(bounds):
        r = x[s:e]
        if s:
            r = r - lu[s:e, :s] @ jnp.concatenate(y)
        y.append(linv[j, : e - s, : e - s] @ r)
    z = []
    for j in reversed(range(len(bounds))):
        s, e = bounds[j]
        r = y[j]
        if e < n:
            r = r - lu[s:e, e:] @ jnp.concatenate(z)
        z.insert(0, uinv[j, : e - s, : e - s] @ r)
    return jnp.concatenate(z).astype(b.dtype)


@dataclasses.dataclass
class LUPreconditioner:
    """Stateful stale-LU preconditioner with the reference's refactor-on-
    iteration-count semantics.

    `factor_dtype` supports the mixed-precision path: factor in float32 and
    apply casts, while GMRES iterates in float64 — a stale approximate
    factorization is a preconditioner either way, and f64 GMRES restores
    full accuracy."""

    refactor_iteration_trigger: int = 100
    factor_dtype: jnp.dtype | None = None
    _factors: tuple | None = None

    def set_up(self, A: jnp.ndarray):
        if self.factor_dtype is not None:
            A = A.astype(self.factor_dtype)
        self._factors = precond_factor(A)

    @property
    def initialized(self) -> bool:
        return self._factors is not None

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        if self._factors is None:
            raise RuntimeError("LUPreconditioner not initialized")
        fdt = self._factors[0].dtype
        return precond_apply(self._factors, v.astype(fdt)).astype(v.dtype)

    def maybe_refactor(self, A: jnp.ndarray, last_iterations: int) -> bool:
        """Refactor if the last solve needed too many iterations. Returns
        whether a refactorization happened."""
        if (
            self._factors is None
            or last_iterations > self.refactor_iteration_trigger
        ):
            self.set_up(A)
            return True
        return False
