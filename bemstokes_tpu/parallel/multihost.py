"""Multi-host distribution scaffolding.

The reference's only transport is MPI (`include/bem_stokes.h:74`,
`source/bem_stokes.cc:1599-1647` row maps).  The counterpart here is
`jax.distributed.initialize` + a process-spanning 1-D row mesh: every process
runs the same SPMD program, `jax.devices()` covers every device of every
process, and the slab row partition of `parallel.sharded` spans hosts with
collectives inserted by XLA (SURVEY.md section 2.2).

Entry points:
- `initialize_multihost()` — call once per process before any jax op; no-op
  for single-process runs.  Honors the standard JAX env vars
  (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) or explicit
  kwargs, so launchers (GKE/xpk/mpirun) can inject them.
- `global_row_mesh()` — 1-D mesh over ALL devices of ALL processes.
- `is_coordinator()` — rank-0 check for file IO (the reference's
  `this_mpi_process == 0` guards).
"""

from __future__ import annotations

import os

import numpy as np


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Initialize jax.distributed for a multi-process (multi-host) run.

    Returns True if a multi-process runtime was initialized, False for the
    single-process no-op path.  Arguments default to the JAX_* env vars;
    nothing is auto-detected, so a multi-process run passes all three.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes in (None, 1) and coordinator_address is None:
        return False  # single-process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def global_row_mesh():
    """1-D 'rows' mesh spanning every device of every process — the global
    analog of `parallel.row_mesh` for jitted pjit/shard_map programs that run
    identically on all hosts."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), ("rows",))


def is_coordinator() -> bool:
    """True on the process that should do file IO (reference
    `this_mpi_process == 0`)."""
    import jax

    return jax.process_index() == 0


def replicate_to_global(x):
    """Host-local numpy/array -> fully replicated global array on the row
    mesh (the analog of the reference's replicated geometry vectors)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = global_row_mesh()
    sharding = NamedSharding(mesh, P())
    return jax.make_array_from_callback(
        np.shape(x), sharding, lambda idx: np.asarray(x)[idx]
    )
