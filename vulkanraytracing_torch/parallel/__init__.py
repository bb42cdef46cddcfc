"""Multi-device rendering: pixel rows or samples spread over devices."""

from vulkanraytracing_torch.parallel.mesh import (  # noqa: F401
    make_render_mesh,
    replicate_scene,
    shard_render_frame,
    shard_render_frame_samples,
)
