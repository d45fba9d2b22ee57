"""Periodic (repeated-image) Stokes kernels.

The reference ships a machine-generated, fully unrolled 21-image periodic
Stokeslet/stresslet (`include/repeated_kernel.h:28-42`,
`source/repeated_kernel.cc:13-3782`, 3D only, images at -10h..+10h along y;
compiled but referenced nowhere else).  The version here is simply the
free-space kernel summed over a static image lattice — a [n_images] batch
axis the compiler vectorizes, replacing 3.8k lines of unrolled C++.
"""

from __future__ import annotations

import jax.numpy as jnp

from .stokeslet import stokeslet_G, stresslet_W, stokeslet_G_Wn


def _image_offsets(p, h: float, axis: int, n_images: int):
    """[2*n_images+1, dim] lattice offsets k*h along `axis` (k = -n..n)."""
    dim = p.shape[-1]
    k = jnp.arange(-n_images, n_images + 1, dtype=p.dtype)
    offs = jnp.zeros((2 * n_images + 1, dim), p.dtype).at[:, axis].set(k * h)
    return offs


def repeated_G(
    p: jnp.ndarray, h: float, axis: int = 1, n_images: int = 10
) -> jnp.ndarray:
    """Periodic single-layer kernel: sum of Stokeslets at p + k*h*e_axis
    (reference `RepeatedStokesKernel::value_tens`). p[..., d] -> [..., d, d]."""
    offs = _image_offsets(p, h, axis, n_images)
    pk = p[..., None, :] + offs  # [..., ni, d]
    return stokeslet_G(pk).sum(axis=-3)


def repeated_W(
    p: jnp.ndarray, h: float, axis: int = 1, n_images: int = 10
) -> jnp.ndarray:
    """Periodic double-layer kernel (reference
    `RepeatedStokesKernel::value_tens2`). p[..., d] -> [..., d, d, d]."""
    offs = _image_offsets(p, h, axis, n_images)
    pk = p[..., None, :] + offs
    return stresslet_W(pk).sum(axis=-4)


def repeated_G_Wn(
    p: jnp.ndarray, n: jnp.ndarray, h: float, axis: int = 1, n_images: int = 10
):
    """Fused periodic (G, W . n) for the assembly hot path."""
    offs = _image_offsets(p, h, axis, n_images)
    pk = p[..., None, :] + offs
    G, Wn = stokeslet_G_Wn(pk, n[..., None, :])
    return G.sum(axis=-3), Wn.sum(axis=-3)
