#!/usr/bin/env python3
"""Timing harness for one NVIDIA GPU, on geometry built in code.

    python bench.py [--refinements 5] [--tiles] [--matfree]

Measures, at the production sphere (create_sphere(refinements=5): 6,146
nodes, 18,444 unknowns, f64):
  - assembly: the fused node kernel and the XLA gather path for the three
    Green's functions in f64 and f32 (`--tiles` adds the kernel tile sweep);
  - the production frame (`StokesBEMProblem.solve_frame`, ImposedVelocity,
    Direct stale LU, GMRES): a fresh (factoring) frame, a stale frame, their
    compile times, and the drag error against Stokes' law;
  - the dense LU: factor and apply;
  - `--matfree`: one matrix-free frame (compile included) and its GMRES
    iterations.
Every time is host wall clock around work that ends in block_until_ready
(or a host readback), best of a few repeats after a warm-up call.  The
output names the device and its power limit; it states no roofline share.
The last line of standard output is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def best_of(fn, *args, reps=3):
    """(best seconds, result) of `reps` timed calls after one warm-up."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t)
    return best, out


def bench_assembly(refinements, tiles):
    import jax
    import jax.numpy as jnp

    from bemstokes_tpu.fem.geometry import euler_from_mesh, panel_geometry, support_points
    from bemstokes_tpu.mesh import build_scalar_space
    from bemstokes_tpu.mesh.factories import create_sphere
    from bemstokes_tpu.ops import node_kernel
    from bemstokes_tpu.ops.assemble import (
        AssemblyConfig,
        assemble_V_K,
        build_assembly_tables,
        node_column_samples,
        node_sample_cells,
    )

    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, 1)
    euler = jnp.asarray(euler_from_mesh(mesh.vertices, space))
    sp = support_points(euler, space, space)
    out = {}
    for kernel in ("free_space", "free_surface", "no_slip"):
        for dtype in (jnp.float64, jnp.float32):
            row = {}
            for backend in ("pallas", "jax"):
                cfg = AssemblyConfig(
                    kernel=kernel, wall_position=-2.0, dtype=dtype, backend=backend
                )
                tables = build_assembly_tables(space, space, cfg)
                fn = jax.jit(lambda e, s, t=tables: assemble_V_K(e, s, t))
                row["kernel_s" if backend == "pallas" else "xla_s"] = best_of(
                    fn, euler, sp
                )[0]
            key = f"{kernel}_{jnp.dtype(dtype).name}"
            print(f"assembly {key}: {row}", file=sys.stderr, flush=True)
            out[key] = row
            if not tiles:
                continue
            e = euler.astype(dtype)
            geo = panel_geometry(
                e[jnp.asarray(tables.cells_nodes_map)],
                jnp.asarray(tables.phi_map, dtype),
                jnp.asarray(tables.dphi_map, dtype),
                jnp.asarray(tables.q_weights, dtype),
                jnp.asarray(tables.flip_sign, dtype),
                ambient_dim=3,
            )
            Y, N, W, _, nq = node_column_samples(tables, *geo)
            C = node_sample_cells(tables, nq)
            ids = jnp.arange(tables.n_nodes, dtype=jnp.int32)
            for t in [(16, 32, 4, 1), (16, 32, 4, 2), (8, 64, 4, 1), (32, 32, 8, 1)]:
                fn = jax.jit(
                    lambda *a, t=t: node_kernel.node_blocks(
                        *a, kernel=kernel, wall_position=-2.0, tiles=t
                    )
                )
                row[f"tile_{t}_s"] = best_of(fn, sp.astype(dtype), ids, Y, N, W, C)[0]
            print(f"tiles {key}: {row}", file=sys.stderr, flush=True)
    return out


def _sphere_problem(refinements, **kw):
    import jax.numpy as jnp

    from bemstokes_tpu.config import ProblemConfig, SolverConfig
    from bemstokes_tpu.mesh.factories import create_sphere
    from bemstokes_tpu.problem import StokesBEMProblem

    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        solver=SolverConfig(preconditioner_type="Direct", tolerance=1e-10),
        **kw,
    )
    prob = StokesBEMProblem(create_sphere(refinements=refinements), cfg)
    return prob, prob.initial_euler(), jnp.zeros((3 * prob.n,))


def _timed_frame(prob, euler, sdot, fresh):
    if fresh:
        prob.preconditioner._factors = None
    t = time.perf_counter()
    res = prob.solve_frame(euler, sdot)  # ends in a host readback
    return time.perf_counter() - t, res


def bench_frame(refinements):
    import jax
    import numpy as np

    from bemstokes_tpu.la.direct import precond_apply, precond_factor
    from bemstokes_tpu.physics.rigid import flatten

    prob, euler, sdot = _sphere_problem(refinements)
    first, res = _timed_frame(prob, euler, sdot, fresh=True)
    fresh = min(_timed_frame(prob, euler, sdot, fresh=True)[0] for _ in range(2))
    stale_first, _ = _timed_frame(prob, euler, sdot, fresh=False)
    stale = min(_timed_frame(prob, euler, sdot, fresh=False)[0] for _ in range(3))
    F = np.asarray(jax.vmap(flatten)(res["operators"]["N_dual"]) @ res["stokes_forces"])
    A = res["A"]
    factor_s, facs = best_of(precond_factor, A, reps=2)
    apply_s, _ = best_of(precond_apply, facs, res["rhs"], reps=5)
    out = dict(
        unknowns=int(A.shape[0]),
        fresh_frame_s=fresh,
        fresh_compile_s=first - fresh,
        stale_frame_s=stale,
        stale_compile_s=stale_first - stale,
        iterations=res["iterations"],
        drag_rel_err=float(abs(abs(F[0]) - 6 * np.pi) / (6 * np.pi)),
        lu_factor_s=factor_s,
        lu_apply_s=apply_s,
    )
    print(f"frame: {out}", file=sys.stderr, flush=True)
    return out


def bench_matfree(refinements):
    prob, euler, sdot = _sphere_problem(refinements, matrix_free=True)
    secs, res = _timed_frame(prob, euler, sdot, fresh=False)
    out = dict(frame_with_compile_s=secs, iterations=res["iterations"])
    print(f"matfree: {out}", file=sys.stderr, flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refinements", type=int, default=5)
    ap.add_argument("--tiles", action="store_true", help="kernel tile sweep")
    ap.add_argument("--matfree", action="store_true", help="one matrix-free frame")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    import bemstokes_tpu  # noqa: F401  (x64, matmul precision)
    from bemstokes_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(smi, file=sys.stderr, flush=True)
    result = dict(
        device=dict(kind=dev.device_kind, count=len(jax.devices()), nvidia_smi=smi),
        refinements=args.refinements,
        assembly=bench_assembly(args.refinements, args.tiles),
        frame=bench_frame(args.refinements),
    )
    if args.matfree:
        result["matfree"] = bench_matfree(args.refinements)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
