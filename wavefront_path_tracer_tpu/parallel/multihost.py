"""Multi-host (multi-process) rendering.

The reference is single-GPU/single-process; ``parallel/sharding.py``
scales over the chips of ONE process.  This module extends the same
tile/sample mesh across processes (several GPU hosts, or N CPU
processes for testing):

* ``initialize()`` wraps ``jax.distributed.initialize``.  Nothing
  announces a cluster to JAX, so callers pass the coordinator address
  (``host:port``), process count and process id explicitly.
* ``make_global_mesh()`` builds the ("tiles", "samples") mesh over ALL
  processes' devices, keeping each process's devices contiguous along
  the *tiles* axis — tile data-parallelism is embarrassingly parallel,
  so the only cross-host network traffic is the final radiance gather,
  while any sample-axis psum stays inside a host (NVLink).
* ``render_sharded_global()`` runs the standard sharded render with
  globally-sharded inputs (``jax.make_array_from_callback``) and
  returns this process's addressable tile rows plus their global
  offsets.

Tested without a cluster via 2 CPU processes x 4 virtual devices
(``tests/multihost_dryrun.py``, spawned by ``test_parallel_multihost``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the distributed runtime (idempotent per process)."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_global_mesh(sample_axis: int = 1) -> Mesh:
    """("tiles", "samples") mesh over every process's devices.

    Device order: process-major, so the tiles axis assigns each process
    a contiguous band of tiles (cross-host traffic only at the gather
    boundary).  The
    sample axis must divide each process's local device count so sample
    psums never cross hosts.
    """
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devices)
    assert n % sample_axis == 0
    local = jax.local_device_count()
    assert local % sample_axis == 0, (
        f"sample_axis {sample_axis} must divide the per-process device "
        f"count {local} so sample psums stay inside one host")
    dev = np.array(devices).reshape(n // sample_axis, sample_axis)
    return Mesh(dev, ("tiles", "samples"))


def render_sharded_global(scene, camera, config, mesh: Mesh | None = None,
                          sample_axis: int = 1):
    """Multi-process sharded render.

    Returns (local_radiance (rows, 3) float32, local_pixel_ids (rows,))
    — the tile rows this process computed and their global pixel ids.
    A caller that wants the full image gathers across processes (e.g.
    ``jax.experimental.multihost_utils.process_allgather``).
    """
    from wavefront_path_tracer_tpu.parallel.sharding import (
        render_samples_sharded, shard_pixels)
    from wavefront_path_tracer_tpu.renderer import prepare_scene

    if mesh is None:
        mesh = make_global_mesh(sample_axis)

    scene_arrays = prepare_scene(scene, config)
    # Replicate small inputs across the whole mesh: every process holds
    # identical host values, so this is a pure local device_put.
    rep = NamedSharding(mesh, P())
    scene_arrays = {k: jax.make_array_from_callback(
        v.shape, rep, lambda idx, v=v: np.asarray(v)[idx])
        for k, v in scene_arrays.items()}
    view = jax.make_array_from_callback(
        (4, 4), rep, lambda idx: np.asarray(camera.view_matrix(),
                                            np.float32)[idx])
    inv_proj_np = np.asarray(
        camera.inverse_projection(config.width, config.height), np.float32)
    inv_proj = jax.make_array_from_callback(
        (4, 4), rep, lambda idx: inv_proj_np[idx])
    cam = camera.gpu_camera()

    shard_pixels(config, mesh.shape["tiles"])  # validates divisibility
    rad = render_samples_sharded(
        mesh, scene_arrays, cam, view, inv_proj, config,
        jnp.uint32(config.frame), jnp.uint32(0), config.samples_per_pixel,
        global_arrays=True,
    )
    # Collect this process's addressable tile shards: rad is the global
    # (n_tiles, per_tile, 3) array; shard.index[0] is the tile slice.
    per_tile = rad.shape[1]
    seen = set()
    local_rows = []
    local_ids = []
    for shard in rad.addressable_shards:
        sl = shard.index[0]
        t0 = sl.start or 0
        t1 = rad.shape[0] if sl.stop is None else sl.stop
        if (t0, t1) in seen:  # replicated sample-axis copies
            continue
        seen.add((t0, t1))
        local_rows.append(np.asarray(shard.data).reshape(-1, 3))
        local_ids.append(np.arange(t0 * per_tile, t1 * per_tile))
    ids = np.concatenate(local_ids)
    order = np.argsort(ids, kind="stable")
    return np.concatenate(local_rows)[order], ids[order]
