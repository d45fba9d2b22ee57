"""f32 end-to-end dtype discipline: with dtype=float32 the whole pipeline
must stay f32 even under jax_enable_x64 (a single unconverted f64 table used
to promote the normal solve — and through the V null-space correction the V
operator — to f64, which silently doubles the cost of every f32 run)."""

import numpy as np
import jax.numpy as jnp

from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.mesh.factories import create_sphere
from bemstokes_tpu.problem import StokesBEMProblem


def test_f32_pipeline_stays_f32():
    mesh = create_sphere(refinements=2)
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        dtype="float32",
        solver=SolverConfig(solve_directly=True),
    )
    prob = StokesBEMProblem(mesh, cfg)
    res = prob.solve_frame(
        prob.initial_euler(), jnp.zeros((3 * prob.n,), jnp.float32)
    )
    assert res["A"].dtype == jnp.float32
    assert jnp.asarray(res["stokes_forces"]).dtype == jnp.float32
    ops = res["operators"]
    for key in ("V", "K", "tmp_N", "N_dual"):
        assert jnp.asarray(ops[key]).dtype == jnp.float32, key
    nv = ops["normal"]
    assert nv["normal"].dtype == jnp.float32
    # physics is still right at f32 resolution
    U = np.asarray(res["rigid_velocities"])
    assert np.all(np.isfinite(U))
    from bemstokes_tpu.physics.rigid import flatten
    import jax

    N_dual_flat = jax.vmap(flatten)(ops["N_dual"])
    F = np.asarray(N_dual_flat @ res["stokes_forces"])
    assert abs(abs(F[0]) - 6 * np.pi) / (6 * np.pi) < 2e-2
