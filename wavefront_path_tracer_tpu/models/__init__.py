"""Integrator engines.

Each engine module exposes::

    render_samples(scene, cam, view, inv_proj, config, frame, sample_base,
                   n_samples) -> (num_pixels, 3) float32 radiance *sum*

All engines share the RNG stream contract (ops/rng.py), so with the same
intersector they integrate the same paths and agree to float rounding.
"""

from wavefront_path_tracer_tpu.models import megakernel, wavefront  # noqa: F401


def get_engine(name: str):
    if name == "megakernel":
        return megakernel
    if name == "wavefront":
        return wavefront
    raise KeyError(
        f"unknown engine {name!r}; have ['megakernel', 'wavefront']"
    )
