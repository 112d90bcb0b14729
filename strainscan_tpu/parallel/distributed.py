"""Multi-host execution: jax.distributed bootstrap + host-level input
sharding.

The reference is single-node (SURVEY §2.3).  Here every host parses its
own slice of the FASTQ stream (the network moves only raw input and the
O(strains) merged report), while per-k-mer count vectors merge across a
host's devices inside ``ShardedCountPipeline``'s psum.

Usage (one process per host, e.g. under a cluster scheduler):

    from strainscan_tpu.parallel import distributed as dist
    dist.initialize()                  # env-driven
    ...
    # identification as usual; global meshes span all hosts' devices

``shard_paths``/``shard_range`` split work deterministically by process
index so hosts never duplicate reads.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

log = logging.getLogger("strainscan_tpu.distributed")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up jax.distributed.  Arguments come from the explicit
    parameters or the standard JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID variables."""
    import jax

    kwargs = {}
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    log.info("jax.distributed up: process %d/%d, %d local / %d global devices",
             jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())


def process_info() -> Tuple[int, int]:
    """(process_index, process_count); (0, 1) when not distributed."""
    import jax

    try:
        return jax.process_index(), jax.process_count()
    except RuntimeError:
        return 0, 1


def shard_paths(paths: Sequence[str]) -> List[str]:
    """Round-robin file assignment for this host (multi-file inputs)."""
    idx, n = process_info()
    return [p for i, p in enumerate(paths) if i % n == idx]


def shard_range(n_items: int) -> Tuple[int, int]:
    """Contiguous [start, stop) slice of a work list for this host."""
    idx, n = process_info()
    per = -(-n_items // n)
    return min(idx * per, n_items), min((idx + 1) * per, n_items)


def maybe_initialize() -> bool:
    """Env-gated bootstrap used by the CLI: a no-op unless
    JAX_COORDINATOR_ADDRESS is set.  Returns True if initialized."""
    if not os.environ.get("JAX_COORDINATOR_ADDRESS"):
        return False
    try:
        initialize()
        return True
    except RuntimeError as e:  # already initialized
        log.warning("jax.distributed initialize skipped: %s", e)
        return False


def merge_counts(counts):
    """Sum per-host count vectors across processes (host allgather over
    DCN + int64 host sum — exact).  No-op when single-process."""
    import jax
    import numpy as np

    if jax.process_count() == 1:
        return counts
    from jax.experimental.multihost_utils import process_allgather

    gathered = np.asarray(
        process_allgather(np.asarray(counts, dtype=np.int32)))
    return gathered.astype(np.int64).sum(axis=0)
