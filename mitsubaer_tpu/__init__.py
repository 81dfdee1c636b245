"""mitsubaer_tpu — a differentiable volumetric path tracer in JAX.

A from-scratch JAX/Pallas framework with the capabilities of
cmu-ci-lab/MitsubaER (refractive radiative transfer / eikonal rendering,
transient & CW-ToF imaging, volumetric path tracing), built as an array
program for accelerators: pytree scenes, wavefront ray batches, compiled
`lax` control flow, Pallas kernels (Triton route, NVIDIA GPUs) on the hot
loops, and `shard_map` scaling over device meshes.
"""

__version__ = "0.1.0"

from . import core  # noqa: F401
