"""Image-system Green's functions for a flat wall, vectorized.

Two wall models, behaviorally matching the reference:

- free surface (perfect slip): mirror Stokeslet/stresslet with a sign flip on
  the wall-normal row (reference `source/free_surface_kernel.cc:19-209`);
- no-slip plane wall (Blake-type system): mirror Stokeslet plus h0-weighted
  source-doublet / Stokes-doublet corrections (reference
  `source/no_slip_wall_kernel.cc:23-199`, including its exact sign structure
  and the literal `delta_ij * pI_k * delta_jk * pI_i` product term).

Conventions: p = x_q - x_i is the vector from the collocation point to the
quadrature point; p_image = x_q - x_i^image with the image point mirrored
across the wall plane along axis `wall_axis`.  The collocation height above
the wall is h0 = (p_image - p)[wall_axis] / 2.

`wall_axis` is a static Python int (resolved at trace time), so all masks are
constants and the kernels stay branch-free on device.  3D only, like the
reference (2D asserts there).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def image_point(x: jnp.ndarray, wall_axis: int, wall_position: float) -> jnp.ndarray:
    """Mirror collocation points across the wall plane
    (reference `source/bem_stokes.cc:2917-2920`)."""
    shift = jnp.zeros_like(x).at[..., wall_axis].set(
        2.0 * (x[..., wall_axis] - wall_position)
    )
    return x - shift


def _unnormalized_G3(p, eps):
    R = jnp.sqrt(jnp.sum(p * p, axis=-1)) + eps
    pp = p[..., :, None] * p[..., None, :]
    eye = jnp.eye(p.shape[-1], dtype=p.dtype)
    return pp / (R**3)[..., None, None] + eye / R[..., None, None]


def _unnormalized_W3(p, eps, dim_power_extra=0):
    dim = p.shape[-1]
    R = jnp.sqrt(jnp.sum(p * p, axis=-1)) + eps
    ppp = p[..., :, None, None] * p[..., None, :, None] * p[..., None, None, :]
    return ppp / (R ** (dim + 2 + dim_power_extra))[..., None, None, None]


def _row_sign(dim, wall_axis, dtype):
    """s_i = -1 on the wall-normal row, +1 elsewhere."""
    s = jnp.ones((dim,), dtype=dtype).at[wall_axis].set(-1.0)
    return s


def free_surface_G(
    p: jnp.ndarray,
    p_image: jnp.ndarray,
    wall_axis: int,
    eps: float = 0.0,
    sign_on: str = "row",
) -> jnp.ndarray:
    """Free-surface image Stokeslet.

    sign_on == "row": the image contribution enters with a minus sign on the
    wall-normal *row* (reference `value_tens_image`); "col": minus on the
    wall-normal *column* (the `_old`/`_pimponi` variants used in tests).
    """
    dim = p.shape[-1]
    assert dim == 3, "image kernels are 3D-only, as in the reference"
    G0 = _unnormalized_G3(p, eps)
    GI = _unnormalized_G3(p_image, eps)
    s = _row_sign(dim, wall_axis, p.dtype)
    if sign_on == "row":
        G = G0 + s[:, None] * GI
    elif sign_on == "col":
        G = G0 + s[None, :] * GI
    else:
        raise ValueError(sign_on)
    return G / (4.0 * math.pi * (dim - 1))


def free_surface_W(
    p: jnp.ndarray,
    p_image: jnp.ndarray,
    wall_axis: int,
    eps: float = 0.0,
    sign_on: str = "row",
) -> jnp.ndarray:
    """Free-surface image stresslet: sign flip on the wall-normal row
    (first index) of the image term (reference `value_tens_image2`)."""
    dim = p.shape[-1]
    assert dim == 3
    scale = -dim / (2.0 * math.pi * (dim - 1))
    W0 = scale * _unnormalized_W3(p, eps)
    WI = scale * _unnormalized_W3(p_image, eps)
    s = _row_sign(dim, wall_axis, p.dtype)
    if sign_on == "row":
        return W0 + s[:, None, None] * WI
    elif sign_on == "col":
        return W0 + s[None, :, None] * WI
    raise ValueError(sign_on)


def no_slip_wall_G(
    p: jnp.ndarray, p_image: jnp.ndarray, wall_axis: int, eps: float = 0.0
) -> jnp.ndarray:
    """Blake-type no-slip wall Stokeslet (reference
    `no_slip_wall_kernel.cc:23-116`).

    G = G0(p) - G0(pI) + t_i * ( -2 h0^2 D + 2 h0 (pI_w D + SD) ),
    with D_ij = -3 pI_i pI_j / RI^5 + delta_ij / RI^3,
    SD_ij = (delta_iw pI_j - delta_jw pI_i) / RI^3,
    and t_i = +1 on the wall-normal row, -1 elsewhere.
    """
    dim = p.shape[-1]
    assert dim == 3
    h0 = 0.5 * (p_image[..., wall_axis] - p[..., wall_axis])[..., None, None]
    RI = (jnp.sqrt(jnp.sum(p_image * p_image, axis=-1)) + eps)[..., None, None]
    eye = jnp.eye(dim, dtype=p.dtype)
    pIpI = p_image[..., :, None] * p_image[..., None, :]
    base = _unnormalized_G3(p, eps) - _unnormalized_G3(p_image, eps)
    D = -3.0 * pIpI / RI**5 + eye / RI**3
    e_w = jnp.zeros((dim,), dtype=p.dtype).at[wall_axis].set(1.0)
    SD = (
        e_w[:, None] * p_image[..., None, :] - e_w[None, :] * p_image[..., :, None]
    ) / RI**3
    pI_w = p_image[..., wall_axis][..., None, None]
    corr = -2.0 * h0 * h0 * D + 2.0 * h0 * (pI_w * D + SD)
    t = -_row_sign(dim, wall_axis, p.dtype)  # +1 on wall row, -1 elsewhere
    G = base + t[:, None] * corr
    return G / (4.0 * math.pi * (dim - 1))


def no_slip_wall_W(
    p: jnp.ndarray, p_image: jnp.ndarray, wall_axis: int, eps: float = 0.0
) -> jnp.ndarray:
    """Blake-type no-slip wall stresslet (reference
    `no_slip_wall_kernel.cc:127-199`).

    W = [ W0u(p) - W0u(pI) + t'_i (2 h0^2 T - 2 h0 (pI_w T + U)) ]
          * dim / (2 pi (dim-1)),
    W0u = -p_i p_j p_k / R^(dim+2),
    T_ijk = -(d_ik pI_j + d_ij pI_k d_jk pI_i)/RI^(dim+2) + 5 pI_i pI_j pI_k / RI^(dim+4)
    (the d_ij pI_k d_jk pI_i *product* reproduces the reference literally),
    U_ijk = (d_jk pI_i pI_w - d_iw pI_j pI_k)/RI^(dim+2),
    t'_i = -1 on the wall-normal row, +1 elsewhere.
    """
    dim = p.shape[-1]
    assert dim == 3
    h0 = 0.5 * (p_image[..., wall_axis] - p[..., wall_axis])[..., None, None, None]
    RI = (jnp.sqrt(jnp.sum(p_image * p_image, axis=-1)) + eps)[
        ..., None, None, None
    ]
    eye = jnp.eye(dim, dtype=p.dtype)
    d_ik = eye[:, None, :]
    d_ij = eye[:, :, None]
    d_jk = eye[None, :, :]
    pIi = p_image[..., :, None, None]
    pIj = p_image[..., None, :, None]
    pIk = p_image[..., None, None, :]
    base = -_unnormalized_W3(p, eps) + _unnormalized_W3(p_image, eps)
    T = (
        -(d_ik * pIj + d_ij * pIk * d_jk * pIi) / RI ** (dim + 2)
        + 5.0 * pIi * pIj * pIk / RI ** (dim + 4)
    )
    pI_w = p_image[..., wall_axis][..., None, None, None]
    e_w = jnp.zeros((dim,), dtype=p.dtype).at[wall_axis].set(1.0)
    U = (d_jk * pIi * pI_w - e_w[:, None, None] * pIj * pIk) / RI ** (dim + 2)
    t = _row_sign(dim, wall_axis, p.dtype)  # -1 on wall row, +1 elsewhere
    W = base + t[:, None, None] * (2.0 * h0 * h0 * T - 2.0 * h0 * (pI_w * T + U))
    return W * dim / (2.0 * math.pi * (dim - 1))


def no_slip_wall_singular_GW(
    p: jnp.ndarray,
    p_image: jnp.ndarray,
    normal: jnp.ndarray,
    wall_axis: int,
    eps: float = 0.0,
) -> jnp.ndarray:
    """Combined singular kernel with wall terms: (W(p) - W(pI)) . n plus the
    h0-weighted Blake correction (reference `value_tens_image3`,
    `no_slip_wall_kernel.cc:210-265`). Returns [..., dim, dim]."""
    dim = p.shape[-1]
    assert dim == 3
    from .stokeslet import stresslet_W

    W1 = stresslet_W(p, eps)
    W2 = stresslet_W(p_image, eps)
    sk = jnp.einsum("...ijk,...k->...ij", W1 - W2, normal)

    h0 = 0.5 * (p_image[..., wall_axis] - p[..., wall_axis])
    R = jnp.sqrt(jnp.sum(p * p, axis=-1)) + eps
    RI = jnp.sqrt(jnp.sum(p_image * p_image, axis=-1)) + eps
    RmNm = jnp.sum(normal * p_image, axis=-1)
    x3 = p[..., wall_axis] + h0
    pI_w = p_image[..., wall_axis]
    e_w = jnp.zeros((dim,), dtype=p.dtype)
    e_w = e_w.at[wall_axis].set(1.0)

    pIi = p_image[..., :, None]
    pIj = p_image[..., None, :]
    ni = normal[..., :, None]
    nj = normal[..., None, :]
    d_ij = jnp.eye(dim, dtype=p.dtype)
    d_iw = e_w[:, None]
    d_jw = e_w[None, :]
    B = lambda a: a[..., None, None]  # broadcast scalar fields to [.., i, j]

    extra = (
        -d_jw * pIi * B(RmNm)
        + B(pI_w) * ni * (2.0 * d_jw * B(pI_w) - pIj)
        + B(x3)
        * (
            d_ij * B(RmNm)
            + pIi * nj
            - 2.0 * d_jw * (d_iw * B(RmNm) + pIi * B(normal[..., wall_axis]))
            + (5.0 * pIi * B(RmNm) / B(R * R) - ni)
            * (2.0 * d_jw * B(pI_w) - pIj)
        )
    ) * (0.3 * B(h0) / math.pi / B(RI ** (dim + 2)) / 2.0)
    return sk + extra


def free_surface_pair(p, p_image, n, wall_axis: int):
    """Component form of `free_surface_G_Wn` (see `stokeslet_pair`): the
    mirror Stokeslet/stresslet enters with a minus sign on the wall-normal
    row, so the 3x3 results are not symmetric."""
    from .stokeslet import stokeslet_pair

    G0, Wn0 = stokeslet_pair(p, n)
    GI, WnI = stokeslet_pair(p_image, n)
    s = [-1.0 if a == wall_axis else 1.0 for a in range(3)]
    G = tuple(tuple(G0[a][b] + s[a] * GI[a][b] for b in range(3)) for a in range(3))
    Wn = tuple(
        tuple(Wn0[a][b] + s[a] * WnI[a][b] for b in range(3)) for a in range(3)
    )
    return G, Wn


def no_slip_pair(p, p_image, n, wall_axis: int):
    """Component form of the Blake no-slip system (`no_slip_wall_G` and
    `no_slip_wall_Wn`, same literal term structure), for the pair body
    shared by every 3D assembly path (see `stokeslet_pair`).  The
    collocation height h0 = (p_image - p)_w / 2 is read off the pair, so a
    pair whose offsets are both replaced by the same dummy gets h0 = 0."""
    w = wall_axis
    h0 = 0.5 * (p_image[w] - p[w])
    r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2]
    rI2 = p_image[0] * p_image[0] + p_image[1] * p_image[1] + p_image[2] * p_image[2]
    invR = jax.lax.rsqrt(r2)
    invRI = jax.lax.rsqrt(rI2)
    invR2, invRI2 = invR * invR, invRI * invRI
    invR3, invRI3 = invR * invR2, invRI * invRI2
    invR5, invRI5 = invR3 * invR2, invRI3 * invRI2
    invRI7 = invRI5 * invRI2
    pn = p[0] * n[0] + p[1] * n[1] + p[2] * n[2]
    pIn = p_image[0] * n[0] + p_image[1] * n[1] + p_image[2] * n[2]
    pIw = p_image[w]
    # corr = -2 h0^2 D + 2 h0 (pI_w D + SD) = beta D + 2 h0 SD
    beta = 2.0 * h0 * (pIw - h0)
    cG = 1.0 / (8.0 * math.pi)
    cW = 3.0 / (4.0 * math.pi)
    G = [[None] * 3 for _ in range(3)]
    Wn = [[None] * 3 for _ in range(3)]
    for a in range(3):
        t = 1.0 if a == w else -1.0  # G correction row sign
        tp = -t  # W correction row sign
        for b in range(3):
            eye = a == b
            base = p[a] * p[b] * invR3 - p_image[a] * p_image[b] * invRI3
            if eye:
                base = base + invR - invRI
            D = -3.0 * p_image[a] * p_image[b] * invRI5
            if eye:
                D = D + invRI3
            corr = beta * D
            if a == w:
                corr = corr + 2.0 * h0 * p_image[b] * invRI3
            if b == w:
                corr = corr - 2.0 * h0 * p_image[a] * invRI3
            G[a][b] = cG * (base + t * corr)
            wbase = (
                -p[a] * p[b] * pn * invR5 + p_image[a] * p_image[b] * pIn * invRI5
            )
            Tn = -n[a] * p_image[b] * invRI5 + 5.0 * p_image[a] * p_image[b] * pIn * invRI7
            if eye:
                Tn = Tn - p_image[a] * p_image[a] * n[a] * invRI5
            Un = n[b] * p_image[a] * pIw * invRI5
            if a == w:
                Un = Un - p_image[b] * pIn * invRI5
            # 2 h0^2 Tn - 2 h0 (pI_w Tn + Un) = -(beta Tn + 2 h0 Un)
            Wn[a][b] = cW * (wbase - tp * (beta * Tn + 2.0 * h0 * Un))
    return tuple(map(tuple, G)), tuple(map(tuple, Wn))


def green_pair(kernel: str, p, p_image, n, wall_axis: int):
    """The 3D pair body of `kernel` ("free_space" | "free_surface" |
    "no_slip") in component form (see `stokeslet_pair`)."""
    if kernel == "free_space":
        from .stokeslet import stokeslet_pair

        return stokeslet_pair(p, n)
    if kernel == "free_surface":
        return free_surface_pair(p, p_image, n, wall_axis)
    if kernel == "no_slip":
        return no_slip_pair(p, p_image, n, wall_axis)
    raise ValueError(kernel)


def _components(x):
    return [x[..., c] for c in range(3)]


def free_surface_G_Wn(p, p_image, n, wall_axis: int):
    """Fused (G, W . n) for the free-surface image kernel (row-sign
    convention of the assembly path): `free_surface_pair` stacked to
    [..., 3, 3] arrays."""
    from .stokeslet import stack_3x3

    G, Wn = free_surface_pair(
        _components(p), _components(p_image), _components(n), wall_axis
    )
    return stack_3x3(G), stack_3x3(Wn)


def no_slip_G_Wn(p, p_image, n, wall_axis: int):
    """Fused (G, W . n) of the Blake no-slip system: `no_slip_pair`
    stacked to [..., 3, 3] arrays."""
    from .stokeslet import stack_3x3

    G, Wn = no_slip_pair(
        _components(p), _components(p_image), _components(n), wall_axis
    )
    return stack_3x3(G), stack_3x3(Wn)


def no_slip_wall_Wn(p, p_image, n, wall_axis: int):
    """Fused Blake stresslet contraction (W . n)_ij, analytically contracting
    every term of `no_slip_wall_W` with n_k (same literal term structure):
    the W . n half of `no_slip_G_Wn`."""
    return no_slip_G_Wn(p, p_image, n, wall_axis)[1]
