"""Multi-host (multi-process) initialization + two-level (hosts x devices) meshes.

New scope vs the single-node reference (its distribution story is one process
per GPU under MPI-style launchers; examples/large-data-set-batch.sh drives one
device).  The design:

* **Process bootstrap** — :func:`init_distributed` wraps
  ``jax.distributed.initialize``: explicit coordinator args for manual
  launches, auto-detection (SLURM or an exported coordinator address)
  otherwise, and a clean single-process fallback so every code path runs
  unchanged on one host.
* **Hybrid mesh** — :func:`hybrid_mesh` builds a 2-D ``Mesh`` whose OUTER axis
  spans hosts (``dcn`` — the network between nodes) and INNER axis spans each
  host's devices (``ici`` — the in-node links, NVLink on a GPU node).  Devices
  are arranged process-major, so the ``ici`` axis never crosses a host
  boundary (the layout contract ``jax.experimental.mesh_utils.
  create_hybrid_device_mesh`` encodes for nd meshes).
* **Staged collectives** — :func:`dist_spmv_hier_fn` row-partitions A over the
  flattened (dcn, ici) grid and gathers x in TWO stages: ``all_gather`` over
  ``ici`` first (within-host), then over ``dcn`` — cross-host traffic happens
  once per HOST block rather than once per device.

The multi-process path is exercised structurally here (single-process context,
virtual-device hybrid meshes in the tests); the ``jax.distributed`` call itself
is the standard entry and carries no logic beyond argument plumbing.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ._compat import shard_map
from .partition import PartitionedCSR

__all__ = ["DistContext", "init_distributed", "hybrid_mesh",
           "shard_partitioned_hier", "dist_spmv_hier_fn", "dist_spmv_hier"]

# env vars whose presence signals a managed multi-process launch that
# jax.distributed.initialize() can auto-configure from
_CLUSTER_ENVS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "SLURM_JOB_ID")


@dataclasses.dataclass(frozen=True)
class DistContext:
    """What a rank knows after bootstrap."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    initialized: bool  # whether jax.distributed.initialize actually ran


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> DistContext:
    """Bootstrap multi-process JAX.

    With explicit arguments (manual launch) or a managed-cluster environment
    (SLURM or an exported coordinator address), calls
    ``jax.distributed.initialize``; otherwise
    this is a no-op returning the single-process context, so code written
    against it runs identically on one host."""
    explicit = coordinator_address is not None or process_id is not None
    managed = any(os.environ.get(k) for k in _CLUSTER_ENVS)
    did_init = False
    if explicit or managed:
        kwargs = {}
        if coordinator_address is not None:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        if local_device_ids is not None:
            kwargs["local_device_ids"] = list(local_device_ids)
        try:
            jax.distributed.initialize(**kwargs)
            did_init = True
        except (ValueError, RuntimeError):
            # a cluster-looking env without a resolvable coordinator: explicit
            # launches must fail loudly, auto-detection degrades to one process
            if explicit:
                raise
    return DistContext(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_device_count=jax.local_device_count(),
        global_device_count=jax.device_count(),
        initialized=did_init,
    )


def hybrid_mesh(
    dcn: Optional[int] = None,
    ici: Optional[int] = None,
    axis_names: tuple = ("dcn", "ici"),
    devices=None,
) -> Mesh:
    """2-D (hosts x devices-per-host) mesh, process-major so the inner axis
    never crosses hosts.  On a single process any (dcn, ici) factoring
    of the device count is accepted — used by the tests/dryrun to validate the
    hybrid collectives on a virtual CPU mesh."""
    devs = list(devices) if devices is not None else jax.devices()
    # process-major order (jax.devices() is already sorted by process, but make
    # the contract explicit — the ici axis must stay within one host)
    devs.sort(key=lambda d: (d.process_index, d.id))
    nproc = jax.process_count()
    if dcn is None:
        dcn = nproc if nproc > 1 else 1
    if ici is None:
        ici = len(devs) // dcn
    if dcn * ici > len(devs):
        raise ValueError(f"mesh {dcn}x{ici} needs {dcn * ici} devices, have {len(devs)}")
    arr = np.array(devs[: dcn * ici], dtype=object).reshape(dcn, ici)
    return Mesh(arr, axis_names)


def shard_partitioned_hier(part: PartitionedCSR, mesh: Mesh) -> PartitionedCSR:
    """Place each shard's slab on its device of the flattened (dcn, ici) grid —
    shard s lives on host s // ici, device s % ici (row-partition order matches
    the mesh's process-major layout, so neighboring shards share a host)."""
    sh = NamedSharding(mesh, P(mesh.axis_names))

    def put(a):
        return jax.device_put(a, sh)

    return PartitionedCSR(
        values=put(part.values),
        col_idx=put(part.col_idx),
        row_ids=put(part.row_ids),
        row_offset=put(part.row_offset),
        col_idx_padded=put(part.col_idx_padded),
        num_shards=part.num_shards,
        local_rows=part.local_rows,
        global_shape=part.global_shape,
        nnz=part.nnz,
    )


def dist_spmv_hier_fn(mesh: Mesh, part: PartitionedCSR):
    """Distributed SpMV over the hybrid mesh with the TWO-STAGE x gather:
    ``all_gather`` over ici (within-host), then over dcn (one block per HOST
    crosses the network).  Equivalent in result to the flat all-gather."""
    local_rows = part.local_rows
    m, n = part.global_shape
    D = part.num_shards
    x_pad = -(-n // D)
    axes = mesh.axis_names  # ("dcn", "ici")

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axes), P(axes), P(axes), P(axes)),
        out_specs=P(axes),
        check_rep=False,
    )
    def _shard_fn(values, col_idx, row_ids, x_local):
        # ici is the MINOR axis of the shard order, so the ici gather yields the
        # host's contiguous x block, and the dcn gather concatenates host blocks
        # in global order
        x_host = jax.lax.all_gather(x_local, axes[1], tiled=True)
        x_full = jax.lax.all_gather(x_host, axes[0], tiled=True)
        prod = values[0] * x_full[:n][col_idx[0]]
        y = jax.ops.segment_sum(prod, row_ids[0], num_segments=local_rows + 1,
                                indices_are_sorted=True)
        return y[:local_rows]

    @jax.jit
    def run(values, col_idx, row_ids, x_sharded):
        return _shard_fn(values, col_idx, row_ids, x_sharded)

    return run, x_pad


def dist_spmv_hier(part: PartitionedCSR, x, mesh: Optional[Mesh] = None):
    """y = A @ x over the hybrid mesh (padded per-shard layout, see
    ``dist_spmv.unpad_y``)."""
    mesh = mesh or hybrid_mesh()
    if int(np.prod(mesh.devices.shape)) != part.num_shards:
        raise ValueError(
            f"partition has {part.num_shards} shards but mesh is {mesh.devices.shape}")
    run, x_pad = dist_spmv_hier_fn(mesh, part)
    n = part.global_shape[1]
    D = part.num_shards
    xp = jnp.zeros((D * x_pad,), x.dtype).at[:n].set(x)
    xp = jax.device_put(xp, NamedSharding(mesh, P(mesh.axis_names)))
    return run(part.values, part.col_idx, part.row_ids, xp)
