"""Multi-host execution: jax.distributed initialization + global meshes.

The reference has no distributed story at all — one Linux process with
mutexes (SURVEY.md §5 "distributed communication backend"). Here every
host process calls :func:`initialize`, after which ``jax.devices()`` spans
every process's devices and the same ``shard_map`` programs
(parallel/sharded_ba.py) run over a global mesh, with no code changes to the
solvers.

Tested with multiple CPU processes on one machine
(tests/test_parallel.py::TestMultiHost): each process gets
xla_force_host_platform_device_count local devices and the distributed BA
psum reduces across all of them.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-host runtime (jax.distributed.initialize).

    With no arguments, reads the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); where
    they are unset, jax.distributed.initialize must find them from a
    cluster environment it knows, or it fails.
    """
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    n = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    if n is not None:
        kwargs["num_processes"] = int(n)
    pid = process_id if process_id is not None else os.environ.get("JAX_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "ba") -> jax.sharding.Mesh:
    """1-D mesh over every device of every participating process."""
    return jax.sharding.Mesh(np.asarray(jax.devices()), (axis,))


def is_multihost() -> bool:
    return jax.process_count() > 1
