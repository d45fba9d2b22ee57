"""Free-space Stokes Green's functions, vectorized over arbitrary batch shapes.

Physics (exterior Stokes problem, viscosity mu = 1):

- single layer (Stokeslet / Oseen tensor), 3D:
      G_ij(p) = (p_i p_j / R^3 + delta_ij / R) / (8 pi)
  2D (log form):
      G_ij(p) = (p_i p_j / R^2 - delta_ij log R) / (4 pi)
- double layer (stresslet contracted later with the panel normal):
      W_ijk(p) = -dim p_i p_j p_k / R^(dim+2) / (2 pi (dim-1))
- hypersingular 4-tensor (traction of the stresslet; experimental in the
  reference, kept for API parity).

Behavioral parity with reference `source/kernel.cc:61-228` including the
epsilon regularization R -> R + eps (default 0).

All functions take p[..., dim] and broadcast; dtype follows the input.  They
are pure jnp elementwise code, safe to call inside Pallas kernel bodies.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def _norm(p, eps):
    return jnp.sqrt(jnp.sum(p * p, axis=-1)) + eps


def stokeslet_G(p: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Single-layer kernel. p[..., dim] -> G[..., dim, dim]."""
    dim = p.shape[-1]
    R = _norm(p, eps)[..., None, None]
    pp = p[..., :, None] * p[..., None, :]
    eye = jnp.eye(dim, dtype=p.dtype)
    if dim == 2:
        G = pp / (R * R) - eye * jnp.log(R)
    else:
        G = pp / (R * R * R) + eye / R
    return G / (4.0 * math.pi * (dim - 1))


def stresslet_W(p: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Double-layer kernel. p[..., dim] -> W[..., dim, dim, dim]."""
    dim = p.shape[-1]
    R = _norm(p, eps)
    ppp = (
        p[..., :, None, None] * p[..., None, :, None] * p[..., None, None, :]
    )
    scale = -dim / (2.0 * math.pi * (dim - 1))
    return scale * ppp / (R ** (dim + 2))[..., None, None, None]


def contract_normal(W: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """singular_kernel_ij = W_ijk n_k (reference `compute_singular_kernel`,
    `source/bem_stokes.cc:5075-5087`). W[..., d, d, d], n[..., d] -> [..., d, d]."""
    return jnp.einsum("...ijk,...k->...ij", W, n)


def hypersingular_L(p: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Hypersingular 4-tensor (reference `value_tens3`,
    `source/kernel.cc:189-228`; flagged experimental there). p[..., dim] ->
    L[..., dim, dim, dim, dim]."""
    dim = p.shape[-1]
    R = _norm(p, eps)
    eye = jnp.eye(dim, dtype=p.dtype)
    R3 = (R**3)[..., None, None, None, None]
    R5 = (R**5)[..., None, None, None, None]
    R7 = (R**7)[..., None, None, None, None]
    d_im = eye[:, None, None, :]
    d_jk = eye[None, :, :, None]
    d_ij = eye[:, :, None, None]
    d_jm = eye[None, :, None, :]
    d_mk = eye[None, None, :, :]  # delta_{k m} (symmetric)
    d_ik = eye[:, None, :, None]
    pi = p[..., :, None, None, None]
    pj = p[..., None, :, None, None]
    pk = p[..., None, None, :, None]
    pm = p[..., None, None, None, :]
    L = (
        -4.0 * d_im * d_jk / R3
        - 6.0 * pk * (d_jm * pi + d_ij * pm) / R5
        - 6.0 * pj * (d_mk * pi + d_ik * pm) / R5
        + 60.0 * pi * pj * pk * pm / R7
    )
    return L / (-4.0 * math.pi * (dim - 1))


def stokeslet_pair(p, n):
    """3D (G, W . n) in component form: p and n are sequences of three
    broadcastable arrays (one per Cartesian component), and the result is a
    pair of 3x3 nested tuples of arrays.  Both tensors are symmetric, and
    G[a][b] IS G[b][a] (the same object), so a caller can accumulate the
    upper triangle only.

    This is the pair body every 3D assembly path evaluates: the XLA paths
    through `stokeslet_G_Wn`, and the fused GPU kernel
    (`ops.node_kernel`), which needs per-component [rows, cols] planes
    because a block cannot hold a trailing axis of length 3."""
    r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2]
    invR = jax.lax.rsqrt(r2)
    invR2 = invR * invR
    cG = 1.0 / (8.0 * math.pi)
    gs = cG * invR * invR2
    diag = cG * invR
    pn = p[0] * n[0] + p[1] * n[1] + p[2] * n[2]
    ws = (-3.0 / (4.0 * math.pi)) * pn * (invR2 * invR2 * invR)
    G = [[None] * 3 for _ in range(3)]
    Wn = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(a, 3):
            pp = p[a] * p[b]
            G[a][b] = G[b][a] = gs * pp + diag if a == b else gs * pp
            Wn[a][b] = Wn[b][a] = ws * pp
    return tuple(map(tuple, G)), tuple(map(tuple, Wn))


def stack_3x3(T):
    """3x3 nested tuple of broadcastable arrays -> one [..., 3, 3] array."""
    rows = [jnp.broadcast_arrays(*row) for row in T]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def stokeslet_G_Wn(p: jnp.ndarray, n: jnp.ndarray, eps: float = 0.0):
    """Fused (G, W . n) without materializing the rank-3 stresslet:
    (W . n)_ij = -dim p_i p_j (p . n) / R^(dim+2) / (2 pi (dim-1)).
    p[..., d], n[..., d] (broadcastable) -> ([..., d, d], [..., d, d]).

    eps == 0 (the default) takes the division-free rsqrt path — this is the
    assembly hot loop, evaluated once per (collocation, quadrature) pair;
    in 3D it is `stokeslet_pair`."""
    dim = p.shape[-1]
    if eps == 0.0 and dim == 3:
        G, Wn = stokeslet_pair(
            [p[..., c] for c in range(3)], [n[..., c] for c in range(3)]
        )
        return stack_3x3(G), stack_3x3(Wn)
    if eps == 0.0:
        r2 = jnp.sum(p * p, axis=-1)
        invR = jax.lax.rsqrt(r2)
        R = r2 * invR
    else:
        R = _norm(p, eps)
        invR = 1.0 / R
    pp = p[..., :, None] * p[..., None, :]
    eye = jnp.eye(dim, dtype=p.dtype)
    if dim == 2:
        G = pp * (invR * invR)[..., None, None] - eye * jnp.log(R)[..., None, None]
    else:
        invR3 = invR * invR * invR
        G = pp * invR3[..., None, None] + eye * invR[..., None, None]
    G = G / (4.0 * math.pi * (dim - 1))
    pn = jnp.sum(p * n, axis=-1)
    scale = -dim / (2.0 * math.pi * (dim - 1))
    Wn = scale * pp * (pn * invR ** (dim + 2))[..., None, None]
    return G, Wn
