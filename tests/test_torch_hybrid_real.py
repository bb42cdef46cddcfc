"""The port's hybrid mode against the JAX package's on the real workload.

The real workload at its 20,000-triangle target (textures, alpha-tested
foliage through the opaque view and the cutout subset, the HDR sky),
built and baked (small IBL sizes) by the JAX package and carried across
(``tests/test_torch_hybrid.py``'s ``_carried``), rendered at 64x36 by the
port's ``BVH_KERNEL`` (the BVH8 plain version on the CPU) and by the JAX
package's ``BVH``.  Gate: 99.9% of the channels within 1/255.

Both run 4 anisotropic taps, not the default 16: the JAX package unrolls
the tap loop into its compiled frame, which at 16 taps takes 90 s to
compile here, against 22 s at 4.  The taps are one loop in the port, run
at 16 on the card by ``chip_smoke.py``.
"""

import torch
from test_torch_hybrid import _frames, _gate, _carried

from vulkanraytracing_torch.config import TraversalMode as TMode
from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh as j_build
from vulkanraytracing_tpu.scene.procedural import sponza_like_scene as j_sponza

torch.set_num_threads(1)

HALL = dict(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0))


def test_real_scene_hybrid_matches_jax():
    js, ts = _carried(j_build(j_sponza(20000, workload="real"), builder="sah"))
    assert ts.alpha is not None and ts.textures is not None
    want, got = _frames(js, ts, HALL, 64, 36, (TMode.BVH_KERNEL,), hybrid_aniso_taps=4)
    _gate(got[TMode.BVH_KERNEL], want)
    assert got[TMode.BVH_KERNEL].mean() > 0.05
