"""Device mesh + sharding helpers — the framework's collectives backend.

The reference's only "distributed" layer is ROS TCP pub/sub between node
processes (SURVEY.md §2.6); its replacement is a single mesh abstraction
over XLA collectives with two axes: ``mission`` (data-parallel Monte-Carlo
fleets; missions are independent, so this axis carries no traffic, and
``map_mission_blocks`` runs the one-device program on each device) and
``particle`` (one mission's particle bank sharded across devices; the
systematic resample's collectives are written out in
``parallel.resample_dist``, the rest is inserted by GSPMD from the
shardings below). The mesh is a plain reshape of the device list, which
suits GPUs of one host joined all-to-all by NVLink: no device pair is
closer than another.
"""

from __future__ import annotations

import concurrent.futures
from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

MISSION_AXIS = "mission"
PARTICLE_AXIS = "particle"


def make_mesh(
    mission: Optional[int] = None,
    particle: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over the available devices: (mission, particle) grid.

    Defaults to all devices on the mission axis (the common fleet shape).
    """
    devices = jax.devices() if devices is None else list(devices)
    n = len(devices)
    if mission is None:
        mission = n // particle
    if mission * particle != n:
        raise ValueError(f"mesh {mission}x{particle} != {n} devices")
    arr = np.asarray(devices).reshape(mission, particle)
    return Mesh(arr, (MISSION_AXIS, PARTICLE_AXIS))


def mission_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Batch-of-missions arrays: leading axis sharded over `mission`."""
    return NamedSharding(mesh, P(MISSION_AXIS, *([None] * (ndim - 1))))


def particle_sharding(mesh: Mesh, ndim: int, particle_axis: int = 0) -> NamedSharding:
    spec = [None] * ndim
    spec[particle_axis] = PARTICLE_AXIS
    return NamedSharding(mesh, P(*spec))


def mission_particle_sharding(
    mesh: Mesh, ndim: int, particle_axis: int = 1
) -> NamedSharding:
    """Fleet particle banks: leading mission axis + a particle axis
    (default axis 1; the PF's (B, 6, N) layout passes particle_axis=2)."""
    spec = [None] * ndim
    spec[0] = MISSION_AXIS
    spec[particle_axis] = PARTICLE_AXIS
    return NamedSharding(mesh, P(*spec))


def shard_missions(tree, mesh: Mesh):
    """device_put every leaf with its leading axis over the mission axis."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, mission_sharding(mesh, x.ndim)), tree
    )


def map_mission_blocks(fn, batched, mesh: Mesh, batch_axes, shared=()):
    """Run ``fn(block, *shared)``, a one-device program, on every device of
    the mesh's ``mission`` axis, each on its contiguous block of the
    leading (mission) axis of ``batched``; return the outputs as global
    arrays sharded over the mission axis. ``batch_axes(out)`` maps the
    output pytree to the mission axis of each leaf.

    One program per device, not one SPMD program over the mesh: each
    device runs what a single device runs on its block, so the result is
    the single-device result bit for bit. Each device is driven from its
    own host thread: launched from one thread, the SLAM fleet's blocks ran
    on four GPUs one after another (its ``while`` loops read their
    predicate back to the host, which holds the launching thread). The
    inputs must be concrete (call it outside ``jit``). On a mesh whose
    ``particle`` axis is wider than 1 the first device of each mission row
    runs the block."""
    if any(isinstance(x, jax.core.Tracer)
           for x in jax.tree_util.tree_leaves((batched, shared))):
        raise TypeError("a mission-sharded fleet runs one program per device: "
                        "call it outside jit, on concrete arrays")
    M = mesh.shape[MISSION_AXIS]
    B = jax.tree_util.tree_leaves(batched)[0].shape[0]
    if B % M:
        raise ValueError(f"fleet size {B} not divisible by mission axis {M}")
    b = B // M
    devs = np.moveaxis(mesh.devices, mesh.axis_names.index(MISSION_AXIS), 0)
    devs = devs.reshape(M, -1)[:, 0]

    def run_block(i):
        block = jax.tree_util.tree_map(lambda x: x[i * b:(i + 1) * b], batched)
        return jax.block_until_ready(
            fn(*jax.device_put((block,) + tuple(shared), devs[i])))

    with concurrent.futures.ThreadPoolExecutor(M) as pool:
        outs = list(pool.map(run_block, range(M)))
    row = Mesh(devs, (MISSION_AXIS,))

    def assemble(axis, *parts):
        shape = list(parts[0].shape)
        shape[axis] *= M
        spec = [None] * len(shape)
        spec[axis] = MISSION_AXIS
        return jax.make_array_from_single_device_arrays(
            tuple(shape), NamedSharding(row, P(*spec)), list(parts))

    return jax.tree_util.tree_map(assemble, batch_axes(outs[0]), *outs)


def replicate(tree, mesh: Mesh):
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree
    )
