"""Multi-host mesh bootstrap for distributed bundle adjustment.

The reference has no distributed computing at all (SURVEY.md §2.4); this
layer runs the same landmark-block-sharded BA (parallel/dist_ba.py)
unchanged over a multi-host mesh — XLA routes the psum collectives over
NVLink within a host and the network across hosts.

Single-host multi-GPU needs no initialization (jax.devices() already sees
the local cards). Multi-host jobs call `init_distributed` once per process
before any jax use, then build the global mesh with `global_ba_mesh` and
hand its size to TrackerConfig.mesh_devices (or the examples' --devices).

This machine exposes one chip, so multi-CHIP hardware execution cannot run
here; the path is exercised three ways: a virtual multi-device mesh in the
test suite, the driver's dryrun (__graft_entry__.dryrun_multichip), and a
REAL two-process mesh — tests/test_multihost.py launches two worker
processes (tools/multihost_worker.py) that initialize through
`init_distributed`, build the global mesh here, and run the sharded BA
with its psums crossing the process boundary (the cross-host analog),
matching the single-process result bit-for-tolerance.
"""
from __future__ import annotations

from typing import Optional


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Initialize jax's multi-process runtime (a no-op when single-process).
    On a plain GPU host nothing describes the cluster to JAX, so pass all
    three arguments (coordinator "host:port", process count, this process's
    id); called without them, jax.distributed.initialize() must find a
    cluster environment it knows (e.g. SLURM) or it fails."""
    import jax

    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_ba_mesh(n_devices: Optional[int] = None):
    """1-D device mesh over all (global) devices for the distributed BA's
    landmark axis. With multiple hosts, jax.devices() enumerates every
    device in the job; the landmark-block partitioning keeps each device's
    observations local and the per-iteration collectives are O(P) vectors
    (dist_ba.py), so cross-host traffic stays tiny."""
    import numpy as np
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("obs",))
