"""Pixel-row and sample parallelism over several devices.

Counterpart of ``vulkanraytracing_tpu/parallel/mesh.py``.  The JAX
package drives its devices from one controller over a 1-D mesh; so does
this module, from one process, with no ``torch.distributed``:

- a mesh (``make_render_mesh``) is an ordered list of shard devices.  A
  device may appear more than once: several shards then run one after the
  other on it, as the JAX package's virtual CPU devices let one host stand
  for a pod (``--devices N --device cpu`` in the CLI);
- the scene is replicated, one copy per distinct device
  (``replicate_scene``); each copy caches its own kernel tables;
- ``shard_render_frame``: shard ``k`` of ``n`` traces rows
  ``[k h/n, (k+1) h/n)`` on its device and folds them into its slice of
  the accumulator.  Per-pixel random numbers come from absolute pixel
  coordinates, so the image and the ray count equal the single-device
  frame's bit for bit.  The image is gathered on the first shard's device
  (where the state lives), the ray count summed in int64;
- ``shard_render_frame_samples``: shard ``k`` renders the whole image at
  sample index ``accum_index * n + k``; the ``n`` images are averaged on
  the first device in shard order and folded in as ``n`` samples.  The
  same estimator as ``n`` frames, other random numbers: equal to
  single-device rendering in distribution, not bit for bit.

Each shard's work is queued under ``torch.cuda.device(...)`` of its
device, on that device's current stream (the kernel wrappers launch
there); results are gathered only after every shard's work is queued, so
distinct cards run at once.
"""

from __future__ import annotations

import contextlib

import torch

from vulkanraytracing_torch.config import Config
from vulkanraytracing_torch.pt.integrator import TraceStats
from vulkanraytracing_torch.pt.render import RenderState, accumulate, trace_rows
from vulkanraytracing_torch.scene.camera import CameraPT
from vulkanraytracing_torch.scene.types import Scene

_M32 = 0xFFFFFFFF


def _canon(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_render_mesh(devices=None) -> list[torch.device]:
    """The shard devices in order: every CUDA device when ``devices`` is
    None, else the given ones (repeats allowed)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (pass the devices, e.g. "
                               "['cpu'] * n, to shard on the host)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [_canon(d) for d in devices]
    if not mesh:
        raise ValueError("a render mesh needs at least one device")
    return mesh


def replicate_scene(scene: Scene, mesh: list[torch.device]) -> dict[torch.device, Scene]:
    """One copy of the scene per distinct device of the mesh (the scene
    itself on the device it already lives on, so its cached tables stay)."""
    home = _canon(scene.geometry.v0.device)
    return {dev: scene if dev == home else scene.to(dev)
            for dev in dict.fromkeys(make_render_mesh(mesh))}


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_render_frame(
    replicas: dict[torch.device, Scene], cfg: Config, camera: CameraPT,
    state: RenderState, mesh: list[torch.device],
) -> tuple[RenderState, TraceStats]:
    """One progressive frame with its rows sharded over the mesh;
    ``replicas`` are ``replicate_scene``'s copies.  Requires ``height % n
    == 0``.  Equals ``render_frame`` bit for bit."""
    mesh = make_render_mesh(mesh)
    n, h = len(mesh), cfg.height
    if h % n:
        raise ValueError(f"height {h} must divide over {n} devices")
    rows = h // n
    count = float(state.accum_index)
    parts = []
    for k, dev in enumerate(mesh):
        with _on(dev):
            value, rays = trace_rows(replicas[dev], cfg, camera.to(dev), state.accum_index,
                                     dev, k * rows, rows)
            mine = state.accumulation[k * rows:(k + 1) * rows].to(dev)
            parts.append((accumulate(value, mine, count, 1.0, cfg), rays))
    home = state.accumulation.device
    image = torch.cat([p.to(home) for p, _ in parts])
    rays = sum(r.to(home) for _, r in parts)
    return (RenderState(accumulation=image, accum_index=(state.accum_index + 1) & _M32),
            TraceStats(rays=rays))


def shard_render_frame_samples(
    replicas: dict[torch.device, Scene], cfg: Config, camera: CameraPT,
    state: RenderState, mesh: list[torch.device],
) -> tuple[RenderState, TraceStats]:
    """One step of sample-parallel progressive rendering: shard ``k`` of
    ``n`` renders the whole image at sample index ``accum_index * n + k``,
    and the mean of the ``n`` images is folded in as ``n`` samples,
    ``(mean * n + count * accum) / (count + n)`` with ``count =
    accum_index * n``; ``replicas`` are ``replicate_scene``'s copies.  ``n`` spp of progress a call; ``accum_index``
    counts calls."""
    mesh = make_render_mesh(mesh)
    n = len(mesh)
    parts = []
    for k, dev in enumerate(mesh):
        with _on(dev):
            sample = (state.accum_index * n + k) & _M32
            parts.append(trace_rows(replicas[dev], cfg, camera.to(dev), sample, dev))
    home = state.accumulation.device
    total = parts[0][0].to(home)
    for value, _ in parts[1:]:
        total = total + value.to(home)
    mean = total / n
    count = float(state.accum_index) * n
    image = accumulate(mean * n, state.accumulation, count, float(n), cfg)
    rays = sum(r.to(home) for _, r in parts)
    return (RenderState(accumulation=image, accum_index=(state.accum_index + 1) & _M32),
            TraceStats(rays=rays))
