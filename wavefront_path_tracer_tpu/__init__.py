"""wavefront_path_tracer_tpu — a wavefront path tracer in JAX.

A JAX/XLA re-design of the capability surface of
rchiaramo/wavefront_path_tracer (Rust + WGSL, single GPU): Shirley
"Ray Tracing in One Weekend" scenes rendered with a wavefront
(generate / extend / shade / miss / accumulate) integrator, a binned-SAH
BVH, progressive accumulation, thin-lens defocus, and three material
families (Lambertian / Metal / Dielectric).  It runs on NVIDIA GPUs
(and on the CPU for tests).

Design points (vs. the reference's wgpu architecture):

* Thread-per-ray kernels become vectorized lane-per-ray batches that XLA
  compiles; atomic queue appends become deterministic stable-sort
  stream compaction.
* The host counter-readback bounce loop becomes an on-device
  ``lax.while_loop`` with fixed-capacity SoA queues — zero host syncs.
* Multi-GPU scaling (absent in the reference) is pixel/sample data
  parallelism over a ``jax.sharding.Mesh`` with XLA collectives.
* Two engines: ``wavefront`` (production, the reference's five-stage
  split) and ``megakernel`` (the per-pixel oracle).
"""

__version__ = "0.1.0"

from wavefront_path_tracer_tpu.utils.config import RenderConfig  # noqa: F401
