"""bemstokes_tpu: a boundary-element framework for the exterior Stokes
problem and micro-swimmer motility, written in JAX.

Built from scratch in JAX/XLA (with a fused Pallas kernel for the GPU
assembly hot path), with the capabilities of the reference
C++/deal.II/Trilinos library mathLab/BEMStokes (see SURVEY.md) but an
array-first architecture:

- surface meshes, Lagrange elements and quadrature as plain arrays
  (`bemstokes_tpu.mesh`, `bemstokes_tpu.fem`)
- Stokeslet / stresslet / image-system Green's functions as vectorized jnp
  functions, with a component-form pair body the GPU kernel shares
  (`bemstokes_tpu.kernels`)
- dense single-layer (V) / double-layer (K) operators assembled by tiled
  collocation kernels, with a separate uniform batched path for the singular
  pairs (`bemstokes_tpu.ops`)
- jitted GMRES + dense-LU direct preconditioner, row-sharded over a
  `jax.sharding.Mesh` (`bemstokes_tpu.la`, `bemstokes_tpu.parallel`)
- rigid-body kinematics, quaternion time stepping and the frame loop
  (`bemstokes_tpu.physics`, `bemstokes_tpu.problem`)

Float64 is required for BEM conditioning in the validation path; we enable
x64 at import unless the user explicitly opts out with BEMSTOKES_X64=0.
"""

import os as _os

import jax as _jax

if _os.environ.get("BEMSTOKES_X64", "1") != "0":
    _jax.config.update("jax_enable_x64", True)

# f32 operands must meet f32 products: a GPU runs a DEFAULT-precision f32
# matmul in TF32 (10-bit mantissa, ~3 digits), which BEM conditioning cannot
# absorb in the operator, the GMRES matvec or the LU.  f64 is unaffected.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
