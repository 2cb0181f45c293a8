"""Multi-host execution.

The reference is a single process (SURVEY.md section 2d); here,
independent LH cases shard data-parallel across hosts over the network
while each host's devices split cases and scoring-matmul row shards
over their own interconnect.

Usage on each host of an N-host slice:

    from ambigram_tpu.parallel.distributed import initialize, host_shard
    initialize(coordinator="host0:8476", num_processes=N, process_id=k)
    my_cases = host_shard(all_case_paths)      # N-way round robin
    results = run_bfb_many(my_cases)           # local devices do the rest

jax.distributed wires the cross-host runtime; global-mesh collectives
(psum over "model", argmin over pools) then ride the device
interconnect within a host and the network across hosts under jit.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, TypeVar

import jax

T = TypeVar("T")


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op on a single host).

    Arguments default to the standard env vars
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID); a GPU
    cluster has no autodetection, so multi-host runs must set them."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator is None and num_processes in (None, 1):
        return  # single host
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def host_shard(items: Sequence[T]) -> List[T]:
    """This host's round-robin share of a global work list. Cases are
    independent (no cross-case state), so each host runs its share with
    purely local meshes — the cheapest possible DCN pattern."""
    k = jax.process_index()
    n = jax.process_count()
    return [item for i, item in enumerate(items) if i % n == k]


def global_mesh(axis_names=("case", "model")):
    """A mesh over every device in the slice (all hosts)."""
    import numpy as np
    from jax.sharding import Mesh

    devices = np.array(jax.devices())
    n = len(devices)
    case = max(1, n // 2) if n % 2 == 0 and n > 1 else n
    return Mesh(devices.reshape(case, n // case), axis_names)
