"""The fused node-mode GPU assembly kernel (`ops.node_kernel`) against the
XLA gather path, and the platform resolution that picks between them.

On the CPU the kernel runs in Pallas interpret mode, which executes the
exact kernel program (tiles, masks, own-cell exclusion, the shared pair
body).  The `gpu`-marked test compiles it through Triton and runs on the
card (`python chip_smoke.py` covers the production width)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bemstokes_tpu.fem.geometry import euler_from_mesh, support_points
from bemstokes_tpu.mesh import build_scalar_space
from bemstokes_tpu.mesh.factories import create_sphere
from bemstokes_tpu.ops.assemble import (
    AssemblyConfig,
    _resolve_backend,
    assemble_rows,
    assemble_V_K,
    build_assembly_tables,
)

# kernel vs XLA on identical inputs, relative to the largest entry: both
# sum <= vmax*nq terms per entry in another order (f64), and f32 must stay
# at f32 rounding — TF32 products would show near 1e-3
TOL = {jnp.float64: 1e-11, jnp.float32: 1e-5}
KERNELS = ["free_space", "free_surface", "no_slip"]


@pytest.fixture(scope="module")
def sphere():
    mesh = create_sphere(refinements=1)  # 26 nodes: partial row/col tiles
    space = build_scalar_space(mesh, 1)
    euler = jnp.asarray(euler_from_mesh(mesh.vertices, space))
    return space, euler, support_points(euler, space, space)


def _assemble(sphere, kernel, dtype, backend, row_range=None):
    space, euler, sp = sphere
    cfg = AssemblyConfig(
        kernel=kernel, wall_position=-2.0, dtype=dtype, backend=backend
    )
    tables = build_assembly_tables(space, space, cfg)
    if row_range is None:
        return assemble_V_K(euler, sp, tables)
    r0, r1 = row_range
    return assemble_rows(
        euler, sp, sp[r0:r1], jnp.arange(r0, r1, dtype=jnp.int32), r0, tables
    )


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("kernel", KERNELS)
def test_interpret_kernel_matches_xla_gather(sphere, kernel, dtype):
    Vk, Kk = _assemble(sphere, kernel, dtype, "pallas_interpret")
    Vx, Kx = _assemble(sphere, kernel, dtype, "jax")
    assert Vk.dtype == Vx.dtype == dtype
    assert _rel(Vk, Vx) < TOL[dtype]
    assert _rel(Kk, Kx) < TOL[dtype]


def test_interpret_kernel_row_block(sphere):
    """A row slab with an offset (the shard-local body of the distributed
    assembly): own-cell masking must use the global node ids."""
    rows = (7, 20)
    Vk, Kk = _assemble(sphere, "no_slip", jnp.float64, "pallas_interpret", rows)
    Vx, Kx = _assemble(sphere, "no_slip", jnp.float64, "jax", rows)
    assert Vk.shape == (3 * 13, 3 * 26)
    assert _rel(Vk, Vx) < 1e-11 and _rel(Kk, Kx) < 1e-11


@pytest.mark.parametrize(
    "platform, dim, expected",
    [("cpu", 3, "jax"), ("gpu", 3, "pallas"), ("gpu", 2, "jax"), ("metal", 3, None)],
)
def test_auto_backend_resolution(platform, dim, expected):
    cfg = AssemblyConfig(dim=dim)
    if expected is None:
        with pytest.raises(ValueError, match="platform"):
            _resolve_backend(cfg, platform)
        return
    out = _resolve_backend(cfg, platform)
    assert out.backend == expected
    # the backend alone picks the kernel; the XLA column mode is untouched
    assert out.column_mode == cfg.column_mode


def test_mixed_bulk_needs_the_kernel():
    cfg = AssemblyConfig(dtype=jnp.float64, mixed_bulk=True)
    with pytest.raises(ValueError, match="mixed_bulk"):
        _resolve_backend(cfg, "cpu")
    assert _resolve_backend(cfg, "gpu").backend == "pallas"
    with pytest.raises(ValueError, match="3D"):
        _resolve_backend(dataclasses.replace(cfg, dim=2, backend="pallas"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("kernel", KERNELS)
def test_compiled_kernel_matches_xla_gather(gpu_only, kernel, dtype):
    mesh = create_sphere(refinements=3)
    space = build_scalar_space(mesh, 1)
    euler = jnp.asarray(euler_from_mesh(mesh.vertices, space))
    sphere = (space, euler, support_points(euler, space, space))
    Vk, Kk = jax.jit(lambda: _assemble(sphere, kernel, dtype, "pallas"))()
    Vx, Kx = jax.jit(lambda: _assemble(sphere, kernel, dtype, "jax"))()
    assert _rel(Vk, Vx) < TOL[dtype]
    assert _rel(Kk, Kx) < TOL[dtype]
