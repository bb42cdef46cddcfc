"""vulkanraytracing_torch — the path tracer in PyTorch, for one NVIDIA H100.

This package is the PyTorch + CUDA counterpart of ``vulkanraytracing_tpu``
(the JAX/Pallas reference, which stays beside it).  It mirrors the
reference's module layout and public names so each module has an obvious
counterpart:

- ``core``   — hash RNG (xoroshiro64** + Wang hash), shading math
- ``scene``  — scene tensors, camera, procedural scenes, the glTF/GLB
  importer and .glb writer, numpy bridge
- ``accel``  — on-device LBVH, instancing and TLAS refit, native SAH build
  + BVH8 collapse (copies of the reference's C++ sources, in ``csrc/``)
- ``ops``    — brute-force oracle, the BVH8, BVH2, subpacket and
  shared-cursor traversals (CUDA kernels + plain PyTorch versions), the
  plain packet and per-ray backends, trace dispatch
- ``env``    — panorama and cube sampling, the sun, the IBL bake
- ``pt``     — BSDF, material unpack, the integrator, progressive frames
- ``hybrid`` — the hybrid (G-buffer + IBL) render mode
- ``parallel`` — pixel rows or samples sharded over several devices
  (one process; a device may hold several shards)
- ``app``    — the Engine (both render modes, systems, events, animated
  instances, checkpoints, a multi-device mesh), the command line
  (``python -m vulkanraytracing_torch render|view|compare``, with
  ``--devices N``), the terminal viewer, PNG and HDR image I/O
- ``utils``  — logging, frame timer, scope stopwatch, ray counter, named
  profiler ranges (``trace_scope``) and traces (``profile_to``)

The package imports torch and numpy (and Pillow where it is installed:
for a glTF image that is not an 8-bit PNG, and to resize textures).  Its
CUDA kernels (the four traversals, ``csrc/``) and the native builders are
compiled on first use into ``vulkanraytracing_torch/build/``.  Every entry point builds on the
card unless it is given ``device="cpu"``.
"""

__version__ = "0.1.0"

from vulkanraytracing_torch.config import Config, RenderMode  # noqa: E402,F401
