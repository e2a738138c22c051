"""Device-mesh construction + multi-host process bootstrap.

One axis is enough for map-scale parallelism: landmarks/edges shard over
`"lm"`.  Multi-host runs call `init_distributed()` first (the
`jax.distributed.initialize` entry the round-1 review flagged as missing);
a single-device mesh runs the identical code (SURVEY.md §7.2 L5: the
single-chip path IS the distributed path with n=1).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join (or bootstrap) a multi-host JAX cluster.

    Call ONCE per process before any backend use.  With no arguments the
    standard env vars drive it (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES
    / JAX_PROCESS_ID, or a supported cluster environment that
    jax.distributed can auto-detect).  Returns True if a multi-process
    cluster was initialized, False for the single-process fallback — the
    caller proceeds identically either way: after this, `jax.devices()`
    spans every host and `make_mesh()` builds the global mesh.

    Once processes are joined, shard_map collectives span every host's
    devices with no further application code (SURVEY.md §2.9).
    """
    explicit = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if not explicit and not num_processes:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def make_mesh(n_devices: int | None = None, axis: str = "lm") -> Mesh:
    """A 1-D mesh over the first `n_devices` devices of the default
    backend (global across hosts after init_distributed).  Raises when
    fewer than `n_devices` exist: a mesh never silently shrinks or moves
    to another platform."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(devs)} "
                f"{jax.default_backend()}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def virtual_mesh(n_devices: int, axis: str = "lm") -> Mesh:
    """A correctness-only mesh: real devices when the host has
    `n_devices`, else virtual CPU devices, without pinning the process
    platform to CPU.  For tests and `__graft_entry__.dryrun_multichip`;
    the CLI and benchmarks use `make_mesh`, which never falls back.

    jax_num_cpu_devices only takes effect before the CPU backend
    initializes; if it is too late and the CPU backend is smaller than
    requested, this raises with a clear message.
    """
    try:
        jax.config.update("jax_num_cpu_devices", max(
            n_devices, jax.config.jax_num_cpu_devices))
    except RuntimeError:
        pass                      # backends already up; check sizes below
    devs = jax.devices()
    if len(devs) < n_devices:
        devs = jax.devices("cpu")
    if len(devs) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(jax.devices())} "
            f"{jax.default_backend()} and {len(jax.devices('cpu'))} cpu; "
            "set jax_num_cpu_devices (or XLA_FLAGS="
            "--xla_force_host_platform_device_count) before JAX init")
    return Mesh(np.asarray(devs[:n_devices]), (axis,))


def map_mesh(mesh: Mesh | None = None) -> Mesh:
    return mesh if mesh is not None else make_mesh()


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded_axis0(mesh: Mesh, axis: str = "lm") -> NamedSharding:
    return NamedSharding(mesh, P(axis))
