"""Native mesh-core parity tests: the C++ parsers/table builders must agree
exactly with the numpy fallbacks (native/meshcore.cpp vs mesh/io.py,
ops/assemble.py)."""

import numpy as np
import pytest

from bemstokes_tpu._native import (
    get_lib,
    read_mesh_native,
    incidence_native,
    weld_native,
)
from bemstokes_tpu.mesh.io import read_msh, read_inp

needs_native = pytest.mark.skipif(
    get_lib() is None, reason="native meshcore not buildable here"
)


@pytest.fixture
def msh_path(tmp_path):
    """The in-code refinement-2 sphere written as gmsh v2: 1-based node
    ids, counterclockwise quads, one physical tag per cell."""
    from bemstokes_tpu.mesh.factories import create_sphere

    mesh = create_sphere(refinements=2)
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes"]
    lines.append(str(mesh.n_vertices))
    lines += [
        f"{k + 1} {x:.17g} {y:.17g} {z:.17g}" for k, (x, y, z) in enumerate(mesh.vertices)
    ]
    lines += ["$EndNodes", "$Elements", str(len(mesh.cells))]
    for k, (a, b, c, d) in enumerate(mesh.cells):
        lines.append(f"{k + 1} 3 2 {k % 3} 1 {a + 1} {b + 1} {d + 1} {c + 1}")
    lines.append("$EndElements")
    path = tmp_path / "sphere.msh"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def inp_path(tmp_path):
    """A 24-segment circle written as UCD lines with 1-based node ids."""
    n = 24
    t = 2 * np.pi * np.arange(n) / n
    lines = [f"{n} {n} 0 0 0"]
    lines += [f"{k + 1} {np.cos(a):.17g} {np.sin(a):.17g} 0" for k, a in enumerate(t)]
    lines += [f"{k + 1} {k % 2} line {k + 1} {(k + 1) % n + 1}" for k in range(n)]
    path = tmp_path / "circle.inp"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@needs_native
def test_native_msh_matches_python(msh_path):
    v, c, m = read_mesh_native(msh_path, 3, "msh")
    ref = read_msh(msh_path, 3)
    assert len(ref.cells) == 96 and ref.material_id.max() == 2
    assert np.array_equal(v, ref.vertices)
    assert np.array_equal(c, ref.cells)
    assert np.array_equal(m, ref.material_id)


@needs_native
def test_native_inp_matches_python_2d(inp_path):
    v, c, m = read_mesh_native(inp_path, 2, "inp")
    ref = read_inp(inp_path, 2)
    assert ref.cells.shape == (24, 2)
    assert np.array_equal(v, ref.vertices)
    assert np.array_equal(c, ref.cells)
    assert np.array_equal(m, ref.material_id)


@needs_native
def test_native_incidence_matches_numpy():
    rng = np.random.default_rng(0)
    cells = rng.integers(0, 50, size=(120, 4)).astype(np.int32)
    n = 50
    slots, mask = incidence_native(cells, n)
    # numpy reference
    flat = cells.reshape(-1).astype(np.int64)
    counts = np.bincount(flat, minlength=n)
    vmax = counts.max()
    ref_slots = np.zeros((n, vmax), np.int32)
    ref_mask = np.zeros((n, vmax))
    fill = np.zeros(n, np.int64)
    for s, j in enumerate(flat):
        ref_slots[j, fill[j]] = s
        ref_mask[j, fill[j]] = 1.0
        fill[j] += 1
    assert slots.shape == ref_slots.shape
    assert np.array_equal(slots, ref_slots)
    assert np.array_equal(mask, ref_mask)


@needs_native
def test_native_weld():
    verts = np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 1e-15]]
    )
    remap, n_unique = weld_native(verts, 1e-12)
    assert n_unique == 2
    assert remap[0] == remap[2]
    assert remap[1] == remap[3]
    assert remap[0] != remap[1]
