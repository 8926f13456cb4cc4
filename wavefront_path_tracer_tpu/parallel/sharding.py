"""Multi-chip rendering via jax.sharding + shard_map.

The reference is strictly single-GPU/single-process (SURVEY.md §2.3);
this module is the scaling layer it never had:

* **Pixel data parallelism**: the flat pixel-index space is sharded over
  a 1-D ``Mesh(("tiles",))``; every device traces its own contiguous
  pixel tile with a *replicated* scene (the sphere/BVH tables are small
  and read-only, so replication beats sharding them).  Rays never cross
  devices — path tracing is embarrassingly parallel over pixels — so
  the only collective is the implicit all-gather when the sharded
  radiance is assembled into the full image (over NVLink between the
  cards of one host).
* **Sample parallelism** (``sample_axis``): for low-resolution /
  high-spp configs the sample budget is split across a second mesh axis
  and reduced with a ``psum`` — radiance sums are order-independent by
  construction (pure float adds of independent samples).

Each device runs the *same* per-(pixel,sample,bounce) RNG streams it
would run on one device.  On the CPU backend sharded renders are
therefore bit-identical to one-device renders up to the floating-point
reduction order of the sample psum (exactly identical when
sample_axis == 1).  On the GPU, XLA compiles the per-device module with
its own fusion choices, so float rounding can differ in the last bit
and send a few paths another way: the images agree statistically
(display RMSE ~1e-4 at 1080p @ 16 spp on four H100s), not bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from wavefront_path_tracer_tpu.utils.config import RenderConfig


def make_mesh(n_devices: int | None = None, sample_axis: int = 1) -> Mesh:
    """Build a ("tiles", "samples") mesh over the first n devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    assert n_devices % sample_axis == 0
    tile_axis = n_devices // sample_axis
    dev = np.array(devices[:n_devices]).reshape(tile_axis, sample_axis)
    return Mesh(dev, ("tiles", "samples"))


def shard_pixels(config: RenderConfig, n_tiles: int) -> int:
    """Pixels per tile; image size must divide evenly (pad upstream)."""
    assert config.num_pixels % n_tiles == 0, (
        f"{config.num_pixels} pixels not divisible into {n_tiles} tiles; "
        "choose a resolution divisible by the mesh"
    )
    return config.num_pixels // n_tiles


def render_samples_sharded(
    mesh: Mesh,
    scene_arrays: dict,
    cam,
    view,
    inv_proj,
    config: RenderConfig,
    frame,
    sample_base,
    n_samples: int,
    global_arrays: bool = False,
):
    """Sharded equivalent of ``engine.render_samples``; returns (P, 3).

    Pixels shard over "tiles"; samples shard over "samples"; the result
    is the full-image radiance sum (replicated).

    ``global_arrays=True`` is the multi-process mode (parallel/
    multihost.py): inputs are already globally-sharded jax.Arrays, the
    pixel index is built as a global array (each process owns a
    contiguous pixel band), and the caller assembles its addressable
    shards.
    """
    n_tiles = mesh.shape["tiles"]
    n_sample_shards = mesh.shape["samples"]
    assert n_samples % n_sample_shards == 0, (
        f"{n_samples} samples not divisible over {n_sample_shards} shards"
    )
    samples_per_shard = n_samples // n_sample_shards
    pixels_per_tile = shard_pixels(config, n_tiles)

    # Per-device trace over its own pixel slab: engines consume a pixel
    # *index* array, so a tile is just a contiguous index range — the
    # engine code is unchanged (SPMD over the index space).
    def tile_fn(pixel_idx, scene_arrays, view, inv_proj, frame, sample_base):
        sshard = jax.lax.axis_index("samples").astype(jnp.uint32)
        base = sample_base + sshard * jnp.uint32(samples_per_shard)
        if config.engine == "megakernel":
            from wavefront_path_tracer_tpu.models.megakernel import (
                trace_pixels as trace,
            )
        else:
            from wavefront_path_tracer_tpu.models.wavefront import (
                trace_wavefront as trace,
            )

        def one_sample(s, acc):
            r, _ = trace(
                pixel_idx[0], scene_arrays, cam, view, inv_proj, config,
                frame, base + jnp.uint32(s),
            )
            return acc + r

        acc = jnp.zeros((pixel_idx.shape[1], 3), jnp.float32)
        rad = jax.lax.fori_loop(0, samples_per_shard, one_sample, acc)
        # Reduce the sample axis; tiles stay sharded until the out_spec
        # gathers them.
        rad = jax.lax.psum(rad, axis_name="samples")
        return rad[None]

    if global_arrays:
        import numpy as np_

        from jax.sharding import NamedSharding

        per_tile = config.num_pixels // n_tiles
        pixel_idx = jax.make_array_from_callback(
            (n_tiles, per_tile),
            NamedSharding(mesh, P("tiles", None)),
            lambda idx: np_.arange(config.num_pixels, dtype=np_.uint32)
                        .reshape(n_tiles, per_tile)[idx],
        )
        rep = NamedSharding(mesh, P())
        frame = jax.make_array_from_callback(
            (), rep, lambda idx: np_.uint32(frame))
        sample_base = jax.make_array_from_callback(
            (), rep, lambda idx: np_.uint32(sample_base))
    else:
        pixel_idx = jnp.arange(config.num_pixels, dtype=jnp.uint32).reshape(n_tiles, -1)

    sharded = shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(
            P("tiles", None),  # pixel tiles
            P(),               # scene replicated
            P(), P(), P(), P(),
        ),
        out_specs=P("tiles", None, None),
        check_vma=False,
    )
    rad = sharded(pixel_idx, scene_arrays, view, inv_proj, frame, sample_base)
    if global_arrays:
        # Leave the (n_tiles, per_tile, 3) global array as-is: eager
        # reshapes/gathers on non-fully-addressable arrays are invalid;
        # the multihost caller assembles its addressable shards.
        return rad
    return rad.reshape(config.num_pixels, 3)


@functools.partial(
    jax.jit, static_argnames=("mesh", "cam", "config", "n_samples")
)
def _render_sharded_jit(mesh, scene_arrays, cam, view, inv_proj, config,
                        frame, sample_base, n_samples):
    return render_samples_sharded(
        mesh, scene_arrays, cam, view, inv_proj, config, frame, sample_base, n_samples
    )


def render_sharded(scene, camera, config: RenderConfig, mesh: Mesh | None = None,
                   sample_axis: int = 1):
    """One-shot sharded render; returns (RenderResult-like arrays)."""
    from wavefront_path_tracer_tpu.renderer import prepare_scene

    if mesh is None:
        mesh = make_mesh(config.num_devices, sample_axis)
    scene_arrays = prepare_scene(scene, config)
    view = jnp.asarray(camera.view_matrix())
    inv_proj = jnp.asarray(camera.inverse_projection(config.width, config.height))
    cam = camera.gpu_camera()
    rad = _render_sharded_jit(
        mesh, scene_arrays, cam, view, inv_proj, config,
        jnp.uint32(config.frame), jnp.uint32(0), config.samples_per_pixel,
    )
    return np.asarray(rad).reshape(config.height, config.width, 3), config.samples_per_pixel
