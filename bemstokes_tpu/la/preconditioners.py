"""Preconditioner family for the monolithic GMRES solve.

The reference selects among Trilinos preconditioners by name — ILU (IFPACK),
AMG (ML), Jacobi, SOR, SSOR, Direct (stale Amesos LU) — at
`source/bem_stokes.cc:4283-4313`.  The BEM operators here are DENSE, so the
family here maps each name onto a dense equivalent:

- "Jacobi":   diagonal scaling (identical math to the reference's).
- "SOR"/"SSOR": one forward (resp. forward+backward) Gauss-Seidel sweep with
  relaxation omega, as dense triangular solves — the standard one-sweep
  preconditioner the reference applies.
- "ILU":      the reference applies IFPACK ILU(k) to a matrix whose sparsity
  is fully dense, which degenerates to a (block-limited) LU; here it is a
  block-Jacobi LU — exact LU of diagonal blocks — the dense analog that keeps
  setup O(N^3/nb^2) instead of O(N^3).
- "AMG":      algebraic multigrid has no dense-BEM analog (no sparsity to
  coarsen); mapped to block-Jacobi as well, with the block count as the
  "coarsening".
- "Direct":   stale-LU with refactor-on-iteration-trigger (la.direct).

A `bandwith` limit (reference `bandwith_preconditioner`,
`source/bem_stokes.cc:1724-1761`) masks the matrix to a band before
factorization.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .direct import LUPreconditioner


def band_mask(A: jnp.ndarray, bandwith: int) -> jnp.ndarray:
    """Zero all entries outside the +-bandwith diagonal band, keeping the
    diagonal (the reference's banded preconditioner sparsity)."""
    n = A.shape[0]
    i = jnp.arange(n)
    keep = jnp.abs(i[:, None] - i[None, :]) <= bandwith
    return jnp.where(keep, A, jnp.zeros_like(A))


@dataclasses.dataclass
class JacobiPreconditioner:
    inv_diag: jnp.ndarray

    @classmethod
    def build(cls, A: jnp.ndarray):
        d = jnp.diagonal(A)
        safe = jnp.where(d == 0, jnp.ones_like(d), d)
        return cls(inv_diag=1.0 / safe)

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        return self.inv_diag * v


@dataclasses.dataclass
class SORPreconditioner:
    """One SOR sweep: solve (D/omega + L) x = v (forward triangular)."""

    M: jnp.ndarray  # lower-triangular factor incl. scaled diagonal
    omega: float = 1.0

    @classmethod
    def build(cls, A: jnp.ndarray, omega: float = 1.0):
        L = jnp.tril(A, -1)
        D = _safe_diag(A)
        M = L + jnp.diag(D / omega)
        return cls(M=M, omega=omega)

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        return jax.scipy.linalg.solve_triangular(self.M, v, lower=True)


@dataclasses.dataclass
class SSORPreconditioner:
    """Symmetric SOR sweep:
    x = (D/omega + U)^-1 . D/omega . (D/omega + L)^-1 v  (scaled)."""

    Ml: jnp.ndarray
    Mu: jnp.ndarray
    diag_scaled: jnp.ndarray

    @classmethod
    def build(cls, A: jnp.ndarray, omega: float = 1.0):
        D = _safe_diag(A) / omega
        Ml = jnp.tril(A, -1) + jnp.diag(D)
        Mu = jnp.triu(A, 1) + jnp.diag(D)
        return cls(Ml=Ml, Mu=Mu, diag_scaled=D)

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        y = jax.scipy.linalg.solve_triangular(self.Ml, v, lower=True)
        y = self.diag_scaled * y
        return jax.scipy.linalg.solve_triangular(self.Mu, y, lower=False)


def _safe_diag(A: jnp.ndarray) -> jnp.ndarray:
    """Diagonal with zeros replaced by 1: the monolithic saddle system has a
    ZERO bottom-right rigid block (grid Real), which would make triangular /
    LU preconditioner factors singular (NaN poisoning the whole GMRES)."""
    d = jnp.diagonal(A)
    return jnp.where(d == 0, jnp.ones_like(d), d)


@partial(jax.jit, static_argnames=("n_blocks",))
def _block_lu_factor(A: jnp.ndarray, n_blocks: int):
    n = A.shape[0]
    nb = -(-n // n_blocks)  # block size, ceil
    pad = n_blocks * nb - n
    # zero diagonal entries (the rigid saddle tail) -> 1, so every diagonal
    # block stays invertible
    i = jnp.arange(n)
    A = A.at[i, i].set(_safe_diag(A))
    Ap = jnp.pad(A, ((0, pad), (0, pad)))
    # pad diagonal with identity so padded blocks stay invertible
    idx = jnp.arange(n, n_blocks * nb)
    Ap = Ap.at[idx, idx].set(1.0)
    blocks = jnp.stack(
        [Ap[k * nb : (k + 1) * nb, k * nb : (k + 1) * nb] for k in range(n_blocks)]
    )
    return jax.vmap(jax.scipy.linalg.lu_factor)(blocks)


@partial(jax.jit, static_argnames=("n_blocks", "n"))
def _block_lu_solve(factors, v: jnp.ndarray, n_blocks: int, n: int):
    nb = -(-n // n_blocks)
    pad = n_blocks * nb - n
    vp = jnp.pad(v, (0, pad)).reshape(n_blocks, nb)
    y = jax.vmap(jax.scipy.linalg.lu_solve)(factors, vp)
    return y.reshape(-1)[:n]


@dataclasses.dataclass
class BlockJacobiPreconditioner:
    """Exact LU of the diagonal blocks (the dense stand-in for ILU/AMG, and
    the shard-local preconditioner of the distributed solve)."""

    factors: tuple
    n_blocks: int
    n: int

    @classmethod
    def build(cls, A: jnp.ndarray, n_blocks: int = 8):
        return cls(
            factors=_block_lu_factor(A, n_blocks), n_blocks=n_blocks, n=A.shape[0]
        )

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        return _block_lu_solve(self.factors, v, self.n_blocks, self.n)


def build_preconditioner(
    A: jnp.ndarray,
    kind: str,
    *,
    omega: float = 1.0,
    n_blocks: int = 8,
    bandwith: int | None = None,
    refactor_iteration_trigger: int = 100,
):
    """Name-based dispatch mirroring the reference's selection
    (`source/bem_stokes.cc:4283-4313`).  Returns an object with `.apply(v)`."""
    if bandwith is not None:
        A = band_mask(A, bandwith)
    if kind == "Jacobi":
        return JacobiPreconditioner.build(A)
    if kind == "SOR":
        return SORPreconditioner.build(A, omega)
    if kind == "SSOR":
        return SSORPreconditioner.build(A, omega)
    if kind in ("ILU", "AMG", "BlockJacobi"):
        return BlockJacobiPreconditioner.build(A, n_blocks)
    if kind == "Direct":
        p = LUPreconditioner(refactor_iteration_trigger)
        p.set_up(A)
        return p
    raise ValueError(f"unknown preconditioner type {kind!r}")
