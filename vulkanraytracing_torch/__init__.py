"""vulkanraytracing_torch — the path tracer in PyTorch, for one NVIDIA H100.

This package is the PyTorch + CUDA counterpart of ``vulkanraytracing_tpu``
(the JAX/Pallas reference, which stays beside it).  It mirrors the
reference's module layout and public names so each module has an obvious
counterpart:

- ``core``   — hash RNG (xoroshiro64** + Wang hash), shading math
- ``scene``  — scene tensors, camera, procedural scenes, numpy bridge
- ``accel``  — on-device LBVH, instancing and TLAS refit, native SAH build
  + BVH8 collapse (the reference's C++ sources)
- ``ops``    — brute-force oracle, the BVH8 and BVH2 traversals (CUDA
  kernels + plain PyTorch versions), trace dispatch
- ``env``    — environment panorama sampling
- ``pt``     — BSDF, material unpack, the integrator, progressive frames
- ``app``    — the Engine: systems, events, animated instances, checkpoints
- ``utils``  — logging, frame timer, ray counter

The package imports torch and numpy only.  Its CUDA kernels (the BVH8 and
BVH2 traversals, ``csrc/``) and the native builders are compiled on first
use into ``vulkanraytracing_torch/build/``.
"""

__version__ = "0.1.0"
