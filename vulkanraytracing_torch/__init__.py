"""vulkanraytracing_torch — the path tracer in PyTorch, for one NVIDIA H100.

This package is the PyTorch + CUDA counterpart of ``vulkanraytracing_tpu``
(the JAX/Pallas reference, which stays beside it).  It mirrors the
reference's module layout and public names so each module has an obvious
counterpart:

- ``core``   — hash RNG (xoroshiro64** + Wang hash), shading math
- ``scene``  — scene tensors, camera, procedural scenes, numpy bridge
- ``accel``  — native SAH build + BVH8 collapse (the reference's C++ sources)
- ``ops``    — brute-force oracle, the BVH8 traversal (CUDA kernel + plain
  PyTorch version), trace dispatch
- ``env``    — environment panorama sampling
- ``pt``     — BSDF, material unpack, the integrator, progressive frames

The package imports torch and numpy only.  Its one CUDA kernel (the BVH8
traversal, ``csrc/``) and the native builders are compiled on first use
into ``vulkanraytracing_torch/build/``.
"""

__version__ = "0.1.0"
