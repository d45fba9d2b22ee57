"""Analytic helical flagellum geometry (reference FlagellarGeometryHandler,
`source/flagellar_geometry_handler.cc`): build an initial cylindrical tube
mesh, deform it to the Phan-Thien/Ramia/Shum growing spiral (or a perfect
constant spiral), and rotate it about the x-axis to gait phase theta.

All deformations are vectorized jnp maps over the node-position array; the
initial tube is a host-side numpy mesh factory.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from .mesh.surface_mesh import SurfaceMesh


@dataclasses.dataclass
class FlagellumConfig:
    """Reference parameter names/defaults
    (`source/flagellar_geometry_handler.cc:26-35`)."""

    Nlambda: float = 1.5  # turns of the spiral
    Lx: float = 7.17952051265  # length along x
    alpha: float = 0.761770785745  # amplitude
    k: float = 1.31273083546  # wave number
    ke: float = 1.31273083546  # growth (reduction) parameter
    delta_head_flagellum: float = 0.125
    a: float = 0.1  # cross-section radius


def create_initial_flagellum_mesh(
    cfg: FlagellumConfig, n_length: int = 24, n_around: int = 8
) -> SurfaceMesh:
    """Cylindrical tube of radius a from x = delta to delta + Lx, axis e_x —
    the analog of the reference's extracted-boundary hyper-rectangle +
    cylindrical manifold (`create_initial_flagellum_triangulation`,
    `:43-102`), built directly as a structured tube (no end caps, matching
    the open tube the reference extracts after removing anisotropy)."""
    x = np.linspace(cfg.delta_head_flagellum, cfg.delta_head_flagellum + cfg.Lx, n_length + 1)
    phi = np.linspace(0, 2 * np.pi, n_around, endpoint=False)
    # vertex grid [n_length+1, n_around]
    verts = np.zeros(((n_length + 1) * n_around, 3))
    for i, xi in enumerate(x):
        for j, pj in enumerate(phi):
            verts[i * n_around + j] = (xi, cfg.a * np.sin(pj), cfg.a * np.cos(pj))
    cells = []
    for i in range(n_length):
        for j in range(n_around):
            j2 = (j + 1) % n_around
            v00 = i * n_around + j
            v10 = i * n_around + j2
            v01 = (i + 1) * n_around + j
            v11 = (i + 1) * n_around + j2
            # lexicographic (u, v) = (x, phi): t_x x t_phi = +radial, so the
            # parametric normal points OUT of the tube (into the fluid)
            cells.append([v00, v01, v10, v11])
    return SurfaceMesh(
        verts, np.asarray(cells, dtype=np.int32), np.zeros(len(cells), dtype=np.int32)
    )


def reference_spiral_euler(
    euler: jnp.ndarray, cfg: FlagellumConfig, flagellum_mask: jnp.ndarray
) -> jnp.ndarray:
    """Deform tube node positions [n, 3] to the growing-amplitude spiral
    (reference `compute_reference_euler`, `:125-172`).  Nodes outside
    `flagellum_mask` (or with x <= delta) are left in place."""
    c = cfg
    X, Y, Z = euler[:, 0], euler[:, 1], euler[:, 2]
    phi = jnp.arctan2(Y, Z)
    x = X - c.delta_head_flagellum
    aa = jnp.sqrt(Y * Y + Z * Z)
    E = 1.0 - jnp.exp(-((c.ke * x) ** 2))
    E2 = 1.0 - jnp.exp(-(c.ke**3 * x * c.ke * x))
    Eprime = 2.0 * c.ke**2 * x * jnp.exp(-((c.ke * x) ** 2))
    theta = c.k * x - math.pi
    D = jnp.sqrt(1.0 + c.alpha**2 * ((E * c.k) ** 2 + Eprime**2))
    G = jnp.sqrt((E * c.k) ** 2 + Eprime**2)
    G = jnp.where(G == 0, 1.0, G)
    H = c.alpha * aa * D / G * jnp.sin(phi)
    M = (
        aa
        / G
        * (
            (E * c.k * jnp.sin(theta) - Eprime * jnp.cos(theta)) / D * jnp.sin(phi)
            + (Eprime * jnp.sin(theta) + E * c.k * jnp.cos(theta)) * jnp.cos(phi)
        )
    )
    N = (
        aa
        / G
        * (
            (E * c.k * jnp.sin(theta) - Eprime * jnp.cos(theta)) * jnp.cos(phi)
            - (Eprime * jnp.sin(theta) + E * c.k * jnp.cos(theta)) / D * jnp.sin(phi)
        )
    )
    new = jnp.stack(
        [
            x + E2 * H + c.delta_head_flagellum,
            c.alpha * E * jnp.cos(theta) + M,
            c.alpha * E * jnp.sin(theta) + N,
        ],
        axis=-1,
    )
    apply = (flagellum_mask > 0) & (x > 0.0)
    return jnp.where(apply[:, None], new, euler)


def reference_constant_spiral_euler(
    euler: jnp.ndarray, cfg: FlagellumConfig, flagellum_mask: jnp.ndarray
) -> jnp.ndarray:
    """Perfect constant spiral with tapered ends (reference
    `compute_reference_euler_constant_spiral`, `:181-238`)."""
    c = cfg
    X, Y, Z = euler[:, 0], euler[:, 1], euler[:, 2]
    phi = jnp.arctan2(Y, Z)
    x = X - c.delta_head_flagellum
    aa = jnp.sqrt(Y * Y + Z * Z)
    E3 = jnp.where(x < 0.2, (x + 0.1) / 0.3, 1.0)
    E4 = jnp.where(c.Lx - x < 0.2, (c.Lx + 0.1 - x) / 0.3, 1.0)
    a_eff = E3 * E4 * aa
    theta = c.k * x - math.pi
    D = jnp.sqrt(1.0 + c.alpha**2 * c.k**2)
    H = c.alpha * a_eff * D / c.k * jnp.sin(phi)
    M = a_eff / c.k * (
        c.k * jnp.sin(theta) / D * jnp.sin(phi) + c.k * jnp.cos(theta) * jnp.cos(phi)
    )
    N = a_eff / c.k * (
        c.k * jnp.sin(theta) / D * jnp.cos(phi)
        - c.k * jnp.cos(theta) * jnp.sin(phi) / D
    )
    new = jnp.stack(
        [
            x + H + c.delta_head_flagellum,
            c.alpha * jnp.cos(theta) + M,
            c.alpha * jnp.sin(theta) + N,
        ],
        axis=-1,
    )
    return jnp.where((flagellum_mask > 0)[:, None], new, euler)


def euler_at_theta(
    reference_euler: jnp.ndarray, theta: float, flagellum_mask: jnp.ndarray
) -> jnp.ndarray:
    """Rotate the flagellum nodes about the x-axis to gait phase theta
    (reference `compute_euler_at_theta`, `:263-294`)."""
    ct, st = jnp.cos(theta), jnp.sin(theta)
    Rm = jnp.asarray([[1.0, 0.0, 0.0], [0.0, ct, -st], [0.0, st, ct]])
    rotated = reference_euler @ Rm.T
    return jnp.where((flagellum_mask > 0)[:, None], rotated, reference_euler)


def create_bacterium_mesh(
    cfg: FlagellumConfig | None = None,
    n_length: int = 24,
    n_around: int = 8,
    head_refinements: int = 2,
    head_radius: float = 0.8,
) -> SurfaceMesh:
    """A bacterium built in code: a spherical head of `head_radius` whose
    surface ends 0.2 short of the origin, plus the constant-spiral
    flagellum tube (`reference_constant_spiral_euler` applied to
    `create_initial_flagellum_mesh`).  The head lies at x <= -0.2 and the
    flagellum at x > 0, which is the flagellum/head split
    `StokesBEMProblem` draws at x = -0.1.  It stands in for the
    reference's bacterium gait meshes (`tests/grid_test/bacterium_*.msh`)."""
    from .mesh.factories import create_sphere

    cfg = cfg or FlagellumConfig()
    tube = create_initial_flagellum_mesh(cfg, n_length=n_length, n_around=n_around)
    verts = np.asarray(
        reference_constant_spiral_euler(
            jnp.asarray(tube.vertices), cfg, jnp.ones(tube.n_vertices)
        )
    )
    flagellum = SurfaceMesh(verts, tube.cells, tube.material_id)
    head = create_sphere(
        center=(-(head_radius + 0.2), 0.0, 0.0),
        radius=head_radius,
        refinements=head_refinements,
    )
    return head.merged_with(flagellum)
