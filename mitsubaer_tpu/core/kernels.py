"""The one place that decides whether a hand-written kernel runs.

The repository's hand-written kernels (integrators/boxwalk.py,
models/ermarch.py) are Pallas kernels for the Triton route, compiled for
NVIDIA GPUs. Every caller asks `route()` which implementation to use:

  * ``"triton"`` — the Pallas kernel, compiled for the GPU;
  * ``"xla"``    — the plain-JAX version of the same computation.

`RenderConfig.kernels` selects the policy: ``"auto"`` takes the kernel on a
GPU and plain XLA elsewhere, ``"xla"`` never takes the kernel, and
``"triton"`` demands it, raising where it cannot run. The Pallas
interpreter is never chosen here: tests reach it through the kernels'
explicit ``interpret=True`` argument.
"""
from __future__ import annotations

import jax

TRITON = "triton"
XLA = "xla"
POLICIES = ("auto", XLA, TRITON)


def route(kernels: str = "auto", backend: str | None = None) -> str:
    """Return TRITON or XLA for the given policy on `backend` (default: the
    default JAX backend)."""
    if kernels not in POLICIES:
        raise ValueError(f"kernels={kernels!r}: expected one of {POLICIES}")
    if kernels == XLA:
        return XLA
    backend = backend or jax.default_backend()
    if backend == "gpu":
        return TRITON
    if kernels == TRITON:
        raise ValueError(
            f"kernels='triton' needs a GPU, but the JAX backend is "
            f"{backend!r}; use kernels='auto' or 'xla'")
    return XLA
