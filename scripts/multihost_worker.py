"""Multi-host worker: one OS process of an N-process jax.distributed run.

Each process owns a slice of virtual CPU devices; together they form the
process-spanning row mesh over which the full distributed frame step
(sharded assembly, slab corrections, distributed stale-LU GMRES) runs SPMD —
the analog of the reference's MPI ranks + Epetra row maps
(`/root/reference/source/bem_stokes.cc:1599-1647`, Allreduce `:2525-2537`,
Bcast `:4409-4414`).

Usage (launched once per process, e.g. by tests/test_multihost.py):
    python scripts/multihost_worker.py <process_id> <num_processes> \
        <coordinator_port> <devices_per_process> <out_json> [config]

`config` selects the feature cell of the multihost matrix (VERDICT r4 ask
#6 — every distributed feature must also be validated over the REAL
2-OS-process transport, not just the single-process virtual mesh):
  - "plain" (default): conforming sphere, Real grid;
  - "constraints": the locally-refined Lorentz wall (hanging-node
    constraints through slab layout + distributed LU), ImposedVelocity;
  - "torque": the bacterium motor-torque balance (bordered torque
    row/column through the distributed LU tail).

The coordinator (process 0) also runs the single-chip reference solve and
writes agreement + iteration metrics to <out_json>.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = int(sys.argv[3])
    dev_per_proc = int(sys.argv[4])
    out_json = sys.argv[5]
    config = sys.argv[6] if len(sys.argv) > 6 else "plain"

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={dev_per_proc}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from bemstokes_tpu.parallel.multihost import (
        initialize_multihost,
        global_row_mesh,
        is_coordinator,
    )

    assert initialize_multihost(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    ), "multi-process initialization did not engage"
    assert jax.process_count() == nproc
    assert len(jax.devices()) == nproc * dev_per_proc
    assert len(jax.local_devices()) == dev_per_proc

    import numpy as np
    import jax.numpy as jnp
    from bemstokes_tpu.config import (
        ProblemConfig,
        SolverConfig,
        WallConfig,
        WallRefinementConfig,
    )
    from bemstokes_tpu.flagella import create_bacterium_mesh
    from bemstokes_tpu.mesh.factories import add_walls_to_mesh, create_sphere
    from bemstokes_tpu.problem import StokesBEMProblem
    from bemstokes_tpu.parallel.solve import make_sharded_frame_step

    if config == "constraints":
        cfg = ProblemConfig(
            grid_type="ImposedVelocity",
            imposed_component=0,
            force_pole="Origin",
            body_manifold="sphere",
            alpha_row_sum="component",
            walls=(
                WallConfig(
                    enabled=True,
                    wall_type="no_slip",
                    position=(0.0, -2.0, 0.0),
                    span=(12.0, 0.0, 12.0),
                ),
            ),
            wall_refinement=WallRefinementConfig(
                enabled=True, threshold=1.0, distance_from_center=6.0
            ),
            solver=SolverConfig(
                preconditioner_type="Direct", tolerance=1e-10
            ),
        )
        mesh = add_walls_to_mesh(create_sphere(refinements=3), cfg)
        prob = StokesBEMProblem(mesh, cfg)
        assert prob.hanging.n > 0  # the matrix cell this config exists for
        euler0 = prob.initial_euler()
        sdot = jnp.zeros((3 * prob.n,))
    elif config == "torque":
        cfg = ProblemConfig(
            solve_with_torque=True,
            grid_type="Real",
            force_pole="Origin",
            solver=SolverConfig(
                preconditioner_type="Direct", tolerance=1e-10
            ),
        )
        prob = StokesBEMProblem(create_bacterium_mesh(), cfg)
        euler0 = prob.initial_euler()
        sdot = jnp.zeros((3 * prob.n,))
    else:  # plain
        # the sphere-translation gait: the shape moves by -1/120 along x per
        # time step, so the force-free sphere swims at +1/120 per step
        cfg = ProblemConfig(grid_type="Real", force_pole="Origin")
        prob = StokesBEMProblem(create_sphere(refinements=2), cfg)
        euler0 = prob.initial_euler()
        sdot = prob.shape_velocities_fd(euler0, euler0.at[:, 0].add(-1.0 / 120.0))

    dmesh = global_row_mesh()
    assert dmesh.devices.size == nproc * dev_per_proc
    want_fields = config == "torque"
    step = make_sharded_frame_step(prob, dmesh, return_fields=want_fields)
    out = step(euler0, sdot)
    rigid_vel, euler_next, info = out[:3]
    fields = out[3] if want_fields else {}
    jax.block_until_ready((rigid_vel, euler_next))
    U = np.asarray(jax.device_get(rigid_vel))
    iters = int(info["iterations"])
    print(f"proc {pid} [{config}]: U = {U}, iterations = {iters}", flush=True)

    if is_coordinator():
        # single-process reference solve (process-local compute)
        res_ref = prob.solve_frame(euler0, sdot)
        U_ref = np.asarray(res_ref["rigid_velocities"])
        agree = float(
            np.max(np.abs(U - U_ref)) / max(float(np.max(np.abs(U_ref))), 1e-30)
        )
        metrics = dict(
            config=config,
            num_processes=nproc,
            global_devices=len(jax.devices()),
            rigid_velocities=U.tolist(),
            iterations=iters,
            single_chip_iterations=int(res_ref["iterations"]),
            agreement_vs_single_chip=agree,
            hanging_nodes=int(prob.hanging.n),
        )
        if config == "plain":
            exact = (1.0 / 120.0) / cfg.time_step
            metrics["rel_err_vs_imposed"] = abs(U[0] - exact) / exact
        if config == "torque":
            omega = float(np.asarray(fields["flagellum_omega"]))
            torque = float(np.asarray(fields["motor_torque"]))
            metrics["flagellum_omega"] = omega
            metrics["omega_agreement"] = abs(
                omega - res_ref["flagellum_omega"]
            ) / max(abs(res_ref["flagellum_omega"]), 1e-30)
            metrics["motor_torque"] = torque
        with open(out_json, "w") as f:
            json.dump(metrics, f, indent=2)
        assert agree < 1e-7, agree


if __name__ == "__main__":
    main()
