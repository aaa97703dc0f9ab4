"""Device-mesh helpers for multi-device / multi-host scale-out.

The reference has no distributed backend at all (SURVEY.md §2.3 — its
entire concurrency model is two boost threads + parallel_for). This layer
is the new capability: TSDF chunk slots and BA edges are sharded over a
1-D mesh of the first n devices; XLA inserts the psum/all_gather
collectives under shard_map/pjit. The cards of one host reach each other
all to all at one rate, so the mesh follows the algorithm alone.

Multi-host: call `init_distributed()` (jax.distributed.initialize) before
building meshes; the same code then spans hosts over DCN.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard") -> Mesh:
    """1-D mesh over the first `n_devices` devices (all when None);
    raises when fewer devices exist than asked for."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"asked for {n_devices} devices, "
                             f"{len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_leading(mesh: Mesh, axis: str = "shard") -> NamedSharding:
    """Sharding that splits an array's leading dimension over the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host runtime bring-up (jax.distributed). No-op in a single
    process when no coordinator is configured."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        pass  # single-process / already initialized
