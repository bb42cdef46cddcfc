"""vulkanraytracing_torch — the path tracer in PyTorch, for one NVIDIA H100.

This package is the PyTorch + CUDA counterpart of ``vulkanraytracing_tpu``
(the JAX/Pallas reference, which stays beside it).  It mirrors the
reference's module layout and public names so each module has an obvious
counterpart:

- ``core``   — hash RNG (xoroshiro64** + Wang hash), shading math
- ``scene``  — scene tensors, camera, procedural scenes, numpy bridge
- ``accel``  — on-device LBVH, instancing and TLAS refit, native SAH build
  + BVH8 collapse (copies of the reference's C++ sources, in ``csrc/``)
- ``ops``    — brute-force oracle, the BVH8, BVH2, subpacket and
  shared-cursor traversals (CUDA kernels + plain PyTorch versions), the
  plain packet backend, trace dispatch
- ``env``    — environment panorama sampling
- ``pt``     — BSDF, material unpack, the integrator, progressive frames
- ``app``    — the Engine: systems, events, animated instances, checkpoints
- ``utils``  — logging, frame timer, ray counter

The package imports torch and numpy only.  Its CUDA kernels (the four
traversals, ``csrc/``) and the native builders are compiled on first use
into ``vulkanraytracing_torch/build/``.  Every entry point builds on the
card unless it is given ``device="cpu"``.
"""

__version__ = "0.1.0"
