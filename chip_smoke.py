#!/usr/bin/env python3
"""On-card smoke test of bemstokes_tpu: drives the main path once on an
NVIDIA GPU at the production width and checks every result.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs: the sharded path only

One GPU, in one process, phase by phase:
  1. device       the platform must be "gpu"; prints the card's name and
                  power limit (nvidia-smi, run as a child that never
                  touches JAX);
  2. kernels      the fused node assembly kernel, compiled for the card,
                  against the XLA gather path at the production sphere for
                  all three Green's functions in f64 and f32;
  3. frame        `StokesBEMProblem.solve_frame` on the in-code 6,146-node
                  sphere (18,444 unknowns, f64, Direct stale LU, GMRES):
                  drag against Stokes' law and the GMRES residual;
  4. swimmer      `bemstokes run` (the CLI, in-process) on the in-code
                  helical flagellum for three frames: GMRES converges in
                  every frame, and the bare-helix counter-rotation
                  invariant holds;
  5. matrix-free  the same sphere without materialized operators, against
                  phase 3;
  6. gpu tests    the `gpu`-marked tests of tests/, in-process.

With --four only the distributed path runs: the sharded frame step on four
cards against `solve_frame` on one, and the motor-torque configuration.

Any failed check raises, so the exit code is non-zero; the last line of
standard output is one JSON object only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the production sphere: create_sphere(refinements=5) has 6,146 nodes
SPHERE_REFINEMENTS = 5
KERNEL_BACKEND = "pallas"  # the fused kernel as compiled for the card
# Q1 flat panels on the unit sphere: the drag error is the O(h^2) geometry
# error.  The f64 CPU ladder at refinements 2, 3, 4 reads 1.03e-2, 2.67e-3,
# 6.83e-4 (a factor ~3.9 per refinement), so refinement 5 should read
# ~1.8e-4; the bound leaves a factor ~3 above that
DRAG_BOUND = 5e-4
GMRES_TOL = 1e-10
# f64: sums of <= vmax*nq terms in another order; f32 must stay at f32
# rounding (TF32 products would show near 1e-3)
KERNEL_TOL = {"float64": 1e-11, "float32": 1e-5}
# tests/test_matfree.py holds the matrix-free and materialized solves to this
MATFREE_TOL = 1e-7
# the bound tests/test_flagellum_swimmer.py holds the bare helix to
HELIX_TOL = 2e-3
SWIMMER = dict(n_length=199, n_around=16)  # 3,200 nodes
SWIMMER_MIN_NODES = 3000
SWIMMER_FRAMES = 3


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _done(t0):
    print(f"   phase time {time.perf_counter() - t0:.3f} s", flush=True)


def _sphere_problem(**cfg_kw):
    import jax.numpy as jnp

    from bemstokes_tpu.config import ProblemConfig, SolverConfig
    from bemstokes_tpu.mesh.factories import create_sphere
    from bemstokes_tpu.problem import StokesBEMProblem

    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        solver=SolverConfig(preconditioner_type="Direct", tolerance=GMRES_TOL),
        **cfg_kw,
    )
    prob = StokesBEMProblem(create_sphere(refinements=SPHERE_REFINEMENTS), cfg)
    return prob, prob.initial_euler(), jnp.zeros((3 * prob.n,))


def _drag(res):
    import jax
    import numpy as np

    from bemstokes_tpu.physics.rigid import flatten

    N_dual = jax.vmap(flatten)(res["operators"]["N_dual"])
    return np.asarray(N_dual @ res["stokes_forces"])


def phase_kernels():
    import jax
    import jax.numpy as jnp

    from bemstokes_tpu.fem.geometry import euler_from_mesh, support_points
    from bemstokes_tpu.mesh import build_scalar_space
    from bemstokes_tpu.mesh.factories import create_sphere
    from bemstokes_tpu.ops.assemble import (
        AssemblyConfig,
        assemble_V_K,
        build_assembly_tables,
    )

    t0 = _phase("kernels: fused node assembly vs XLA gather path")
    mesh = create_sphere(refinements=SPHERE_REFINEMENTS)
    space = build_scalar_space(mesh, 1)
    euler = jnp.asarray(euler_from_mesh(mesh.vertices, space))
    sp = support_points(euler, space, space)
    for kernel in ("free_space", "free_surface", "no_slip"):
        for dtype in (jnp.float64, jnp.float32):
            out, secs = {}, {}
            for backend in (KERNEL_BACKEND, "jax"):
                cfg = AssemblyConfig(
                    kernel=kernel, wall_position=-2.0, dtype=dtype, backend=backend
                )
                tables = build_assembly_tables(space, space, cfg)
                fn = jax.jit(lambda e, s, t=tables: assemble_V_K(e, s, t))
                compiled = fn.lower(euler, sp).compile()
                if backend == KERNEL_BACKEND:
                    print(f"  {kernel} {dtype.__name__}: {compiled.memory_analysis()}")
                out[backend] = jax.block_until_ready(compiled(euler, sp))
                t = time.perf_counter()
                jax.block_until_ready(compiled(euler, sp))
                secs[backend] = time.perf_counter() - t
            name = jnp.dtype(dtype).name
            eV = rel(out[KERNEL_BACKEND][0], out["jax"][0])
            eK = rel(out[KERNEL_BACKEND][1], out["jax"][1])
            print(
                f"  {kernel} {name}: kernel {secs[KERNEL_BACKEND]:.4f} s, XLA "
                f"{secs['jax']:.4f} s, |dV|/max {eV:.2e}, |dK|/max {eK:.2e}"
            )
            check(
                max(eV, eK) <= KERNEL_TOL[name],
                f"{kernel} {name} kernel within {KERNEL_TOL[name]:g} of XLA",
            )
            del out
    _done(t0)


def phase_frame():
    import numpy as np

    t0 = _phase("frame: production sphere, f64, Direct, GMRES")
    prob, euler, sdot = _sphere_problem()
    unknowns = 3 * prob.n + prob.num_rigid
    check(prob.n == 6 * 4**SPHERE_REFINEMENTS + 2, f"{unknowns} unknowns")
    t = time.perf_counter()
    res = prob.solve_frame(euler, sdot)  # host readback: the frame is done
    first = time.perf_counter() - t
    prob.preconditioner._factors = None  # a second fresh (factoring) frame
    t = time.perf_counter()
    res = prob.solve_frame(euler, sdot)
    fresh = time.perf_counter() - t
    t = time.perf_counter()
    stale = prob.solve_frame(euler, sdot)  # reuses the factors (compiles)
    stale_first = time.perf_counter() - t
    t = time.perf_counter()
    stale = prob.solve_frame(euler, sdot)
    stale_s = time.perf_counter() - t
    F = _drag(res)
    err = abs(abs(F[0]) - 6 * np.pi) / (6 * np.pi)
    print(
        f"  fresh frame {fresh:.4f} s (compile {first - fresh:.1f} s), "
        f"stale frame {stale_s:.4f} s (compile {stale_first - stale_s:.1f} s), "
        f"iterations {res['iterations']}/{stale['iterations']}, "
        f"true residual {res['residual']:.2e}, drag {F[0]:.10f}, "
        f"rel err vs 6 pi mu a U {err:.3e}"
    )
    check(res["converged"] and stale["converged"], f"GMRES residual <= {GMRES_TOL:g}")
    check(err < DRAG_BOUND, f"drag within {DRAG_BOUND:g} of Stokes' law")
    _done(t0)
    return res


def phase_swimmer():
    import numpy as np

    from bemstokes_tpu import cli
    from bemstokes_tpu.config import ProblemConfig, SolverConfig
    from bemstokes_tpu.config_io import save_config

    t0 = _phase("swimmer: bemstokes run on the in-code flagellum")
    n_frames, dt = 8, 0.05
    cfg = ProblemConfig(
        use_flagellum_handler=True,
        imposed_rotation_as_flagellum_shape=True,
        flagellum_params=dict(SWIMMER),
        n_frames=n_frames,
        time_step=dt,
        grid_type="Real",
        force_pole="Origin",
        solver=SolverConfig(preconditioner_type="Direct", tolerance=GMRES_TOL),
    )
    nodes = (SWIMMER["n_length"] + 1) * SWIMMER["n_around"]
    check(nodes >= SWIMMER_MIN_NODES, f"{nodes} flagellum nodes")
    with tempfile.TemporaryDirectory() as out:
        params = os.path.join(out, "params.json")
        save_config(cfg, params)
        log = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main(["run", "-p", params, "-o", out, "0", str(SWIMMER_FRAMES)])
        wall = time.perf_counter() - t
        print(log.getvalue(), end="", flush=True)
        check(rc == 0, "bemstokes run exits 0")
        rows = np.loadtxt(os.path.join(out, "point_velocities.txt"))
    # the run's own per-frame report: one FINAL CHECK line per frame, and a
    # warning for every frame whose GMRES stopped short of the tolerance
    reports = re.findall(
        r"^frame (\d+):.*FINAL CHECK residual = (\S+), iterations = (\d+)$",
        log.getvalue(),
        re.M,
    )
    iterations = [int(it) for _, _, it in reports]
    check(len(reports) == SWIMMER_FRAMES, f"{len(reports)} frames reported")
    check(
        "did not converge" not in log.getvalue(),
        f"GMRES converged in every frame (iterations {iterations})",
    )
    U = rows[:, 1].reshape(SWIMMER_FRAMES, 6)
    omega_gait = -2.0 * np.pi / (dt * n_frames)
    print(f"  {SWIMMER_FRAMES} frames in {wall:.2f} s (compile included); U =\n{U}")
    check(np.all(np.isfinite(rows)), "outputs finite")
    err = np.abs(U[:, 3] + omega_gait) / abs(omega_gait)
    check(
        np.all(err < HELIX_TOL),
        f"omega_x = -dtheta/dt within {HELIX_TOL:g} (worst {err.max():.2e})",
    )
    drift = np.abs(U[:, [0, 1, 2, 4, 5]]).max() / abs(omega_gait)
    check(drift < 5e-3, f"U ~ 0: other modes {drift:.2e} of the gait rate")
    _done(t0)


def phase_matrix_free(materialized):
    t0 = _phase("matrix-free: the production sphere without V/K/A")
    prob, euler, sdot = _sphere_problem(matrix_free=True)
    t = time.perf_counter()
    res = prob.solve_frame(euler, sdot)
    secs = time.perf_counter() - t
    eU = rel(res["rigid_velocities"], materialized["rigid_velocities"])
    eF = rel(_drag(res), _drag(materialized))
    print(
        f"  frame {secs:.3f} s (compile included), GMRES iterations "
        f"{res['iterations']}, |dU| {eU:.2e}, |dF| {eF:.2e}"
    )
    check(res["converged"], f"GMRES residual <= {GMRES_TOL:g}")
    check(max(eU, eF) <= MATFREE_TOL, f"agrees with phase 3 to {MATFREE_TOL:g}")
    _done(t0)


def phase_gpu_tests():
    import pytest

    t0 = _phase("gpu tests: pytest -m gpu, in-process")

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(HERE, "tests")],
        plugins=[Count()],
    )
    check(rc == 0 and Count.passed > 0, f"{Count.passed} gpu tests passed")
    _done(t0)


def phase_four():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bemstokes_tpu.config import ProblemConfig, SolverConfig
    from bemstokes_tpu.fem.geometry import support_points
    from bemstokes_tpu.flagella import create_bacterium_mesh
    from bemstokes_tpu.mesh.factories import create_sphere
    from bemstokes_tpu.parallel import row_mesh
    from bemstokes_tpu.parallel.sharded import sharded_assemble
    from bemstokes_tpu.parallel.solve import make_sharded_frame_step
    from bemstokes_tpu.problem import StokesBEMProblem

    t0 = _phase("four cards: sharded frame step vs one card")
    devices = jax.devices()
    check(len(devices) >= 4, f"{len(devices)} GPUs visible")
    dmesh = row_mesh(devices=devices[:4])
    cfg = ProblemConfig(
        grid_type="Real",
        force_pole="Origin",
        solver=SolverConfig(preconditioner_type="Direct", tolerance=GMRES_TOL),
    )
    prob = StokesBEMProblem(create_sphere(refinements=SPHERE_REFINEMENTS), cfg)
    euler = prob.initial_euler()
    # the sphere-translation gait: the force-free sphere swims at +1/120
    # per time step
    sdot = prob.shape_velocities_fd(euler, euler.at[:, 0].add(-1.0 / 120.0))

    sp = support_points(euler, prob.map_space, prob.fe_space)
    V_slab, K_slab = jax.jit(
        lambda e, s: sharded_assemble(e, s, prob.tables, dmesh)
    )(euler, sp)
    for nm, slab in (("V", V_slab), ("K", K_slab)):
        devs = {sh.device for sh in slab.addressable_shards}
        check(len(devs) == 4, f"{nm} slab shards on {len(devs)} distinct devices")
    del V_slab, K_slab

    step = make_sharded_frame_step(prob, dmesh)
    U, _, info = step(euler, sdot)
    U = np.asarray(jax.block_until_ready(U))
    t = time.perf_counter()
    U, _, info = step(euler, sdot)
    U = np.asarray(jax.block_until_ready(U))
    t_dist = time.perf_counter() - t
    res = prob.solve_frame(euler, sdot)
    agree = rel(U, res["rigid_velocities"])
    iters, ref = int(info["iterations"]), max(int(res["iterations"]), 1)
    print(
        f"  second sharded step {t_dist:.3f} s on 4 cards (its stale-LU path "
        f"compiles on first use); U {U}; agreement vs one card {agree:.2e}; "
        f"iterations {iters} (one card {ref})"
    )
    check(agree <= 1e-7, "sharded vs one card within 1e-7")
    check(iters <= max(3 * ref, 3), "iterations <= max(3 x one card, 3)")

    cfg_t = ProblemConfig(
        solve_with_torque=True,
        grid_type="Real",
        force_pole="Origin",
        solver=SolverConfig(preconditioner_type="Direct", tolerance=GMRES_TOL),
    )
    prob_t = StokesBEMProblem(create_bacterium_mesh(n_length=48), cfg_t)
    step_t = make_sharded_frame_step(prob_t, dmesh, return_fields=True)
    e_t = prob_t.initial_euler()
    U_t, _, info_t, fields = step_t(e_t, jnp.zeros((3 * prob_t.n,)))
    U_t = np.asarray(U_t)
    torque = float(fields["motor_torque"])
    omega = float(fields["flagellum_omega"])
    res_t = prob_t.solve_frame(e_t, jnp.zeros((3 * prob_t.n,)))
    print(
        f"  torque config ({prob_t.n} nodes): U {U_t}, omega {omega:.6e} "
        f"(one card {res_t['flagellum_omega']:.6e}), motor torque {torque:.8f}"
    )
    check(np.all(np.isfinite(U_t)), "torque config finite")
    check(abs(torque + 2.0) < 1e-6, "motor torque = -2 (imposed)")
    check(
        abs(omega) > 1e-3 and np.sign(U_t[3]) == -np.sign(omega),
        "body counter-rotates against the flagellum",
    )
    check(
        rel(omega, res_t["flagellum_omega"]) <= 1e-7,
        "omega agrees with one card to 1e-7",
    )
    _done(t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four", action="store_true", help="run the four-card sharded path only"
    )
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "bemstokes_tpu")):
        print("chip_smoke.py runs from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    import bemstokes_tpu  # noqa: F401  (x64, matmul precision)
    from bemstokes_tpu.utils.compile_cache import enable_compile_cache

    t0 = _phase("device")
    print(f"  cache {enable_compile_cache()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(f"  {dev.device_kind}, {len(jax.devices())} device(s)")
    print(smi, flush=True)
    _done(t0)
    if args.four:
        phase_four()
    else:
        phase_kernels()
        res = phase_frame()
        phase_swimmer()
        phase_matrix_free(res)
        phase_gpu_tests()
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
