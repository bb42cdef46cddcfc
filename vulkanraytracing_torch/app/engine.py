"""The Engine: application lifecycle, frame loop, mode toggle.

Counterpart of ``vulkanraytracing_tpu/app/engine.py``.  Headless: the
window loop is replaced by scripted input (``inject_key``,
``inject_mouse_move``, ``inject_resize``), and the accumulated framebuffer
is the presented image.  Each ``draw`` runs every system, advances the
animated instances, and traces one progressive frame.  A camera update,
the R key, a resize, or instances that moved reset the accumulation; a
frame whose transforms did not change keeps accumulating.  Checkpoints
are ``.npz`` files in the JAX package's format (framebuffer, spp, camera,
render mode), so either package can resume the other's.

The T key toggles between the two render modes.  A hybrid frame
(``hybrid.render_hybrid``) does not accumulate: its display image goes
into ``RenderState.accumulation`` and the frame count stays.  A static
textured scene traces as its caller built it (with the cutout subset
that ``accel.lbvh.build_scene_bvh`` attaches); animated instances trace
with the alpha re-trace over the whole scene, as their trees are built
on the device and carry no subset.

Every tensor lives on ``device``, a required keyword: there is no default
that could move a scene off the card and onto the plain versions.  With a
``mesh`` (``parallel.make_render_mesh``, its first device ``device``),
path-traced frames shard their rows over the mesh's devices
(``parallel.shard_render_frame``, bit-equal to one device); a moving frame
hands its refitted scene to every other device once.  The hybrid mode
ignores the mesh, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vulkanraytracing_torch.accel import tlas
from vulkanraytracing_torch.app.events import EventBus, EventType, Key, KeyAction, KeyInput
from vulkanraytracing_torch.app.systems import CameraSystem, StatsSystem, System
from vulkanraytracing_torch.config import Config, RenderMode
from vulkanraytracing_torch.hybrid import render_hybrid
from vulkanraytracing_torch.parallel import make_render_mesh, replicate_scene, shard_render_frame
from vulkanraytracing_torch.pt.render import (
    RenderState,
    create_render_state,
    render_frame,
    reset_accumulation,
    to_display,
)
from vulkanraytracing_torch.scene.camera import Camera
from vulkanraytracing_torch.scene.types import Scene
from vulkanraytracing_torch.utils import Timer, log_i
from vulkanraytracing_torch.utils.profiling import RayCounter


class Engine:
    def __init__(
        self,
        cfg: Config,
        scene: Scene,
        camera: Optional[Camera] = None,
        instances: Optional[tlas.InstanceSoup] = None,  # two-level scene
        animation=None,  # frame_index -> (I, 4, 4) world transforms (numpy)
        mesh=None,       # shard devices (parallel.make_render_mesh): pixel rows
        *,
        device: torch.device | str,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = None if mesh is None else make_render_mesh(mesh)
        if self.mesh is not None and self.mesh[0] != make_render_mesh([self.device])[0]:
            raise ValueError(f"the mesh's first device {self.mesh[0]} is not the Engine's "
                             f"device {self.device}")
        self.scene = scene.to(self.device)
        self.bus = EventBus()
        # Animated instances: the soup is transformed, built and permuted
        # into Morton order once; each frame whose transforms changed
        # refits the TLAS on the device and resets the accumulation.
        self._soup_sorted = None
        self._animation = animation
        self._frame_index = 0
        self._last_transforms = None
        if instances is not None:
            t0 = animation(0) if animation is not None else None
            if t0 is None:
                raise ValueError("instances require an animation callback")
            t0 = np.asarray(t0, np.float32)
            instances = instances.to(self.device)
            geom, bvh, order = tlas.build_tlas(instances, self._transforms(t0))
            self._soup_sorted = tlas.permute_soup(instances, order)
            self.scene = self.scene._replace(geometry=geom, bvh=bvh, alpha=None)
            self._last_transforms = t0
        self._replicas = (None, None)  # (the scene they copy, its copies by device)
        self.camera = camera or Camera(cfg.camera)
        self.render_mode = cfg.render_mode
        self.timer = Timer()
        self.total_rays = 0.0
        self.ray_counter = RayCounter()

        self.state: RenderState = create_render_state(cfg, self.device)
        self._camera_dirty = True
        self._camera_dev = None

        self.systems: list[System] = []
        self.camera_system = CameraSystem(self.camera, self.bus)
        self.stats = StatsSystem()
        self.add_system(self.camera_system)
        self.add_system(self.stats)

        self.bus.add_handler(EventType.CAMERA_UPDATE, self._on_camera_update)
        self.bus.add_handler(EventType.KEY_INPUT, self._on_key)
        self.bus.add_handler(EventType.RESIZE, self._on_resize)

        self.stats.bind_text(lambda: f"spp {int(self.state.accum_index)}")
        self.stats.bind_text(
            lambda: f"{self.ray_counter.mrays_per_sec():.2f} Mrays/s"
        )
        self.stats.bind_text(
            lambda: "camera position: %.2f %.2f %.2f"
            % tuple(self.camera.description.position)
        )

    def _transforms(self, transforms: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(transforms, np.float32)).to(self.device)

    # --- systems ---

    def add_system(self, system: System) -> None:
        self.systems.append(system)

    def get_system(self, kind: type) -> System:
        for s in self.systems:
            if isinstance(s, kind):
                return s
        raise KeyError(kind)

    # --- event handlers ---

    def _on_camera_update(self, _payload=None) -> None:
        self.state = reset_accumulation(self.state)
        self._camera_dirty = True

    def _on_key(self, event: KeyInput) -> None:
        if event.action != KeyAction.PRESS:
            return
        if event.key == Key.T:
            self.render_mode = (
                RenderMode.HYBRID
                if self.render_mode == RenderMode.PATH_TRACING
                else RenderMode.PATH_TRACING
            )
            log_i(f"render mode: {self.render_mode.value}")
        elif event.key == Key.R:
            self.state = reset_accumulation(self.state)

    def _on_resize(self, extent) -> None:
        w, h = extent
        if w and h and (w != self.cfg.width or h != self.cfg.height):
            self.cfg = self.cfg.replace(width=w, height=h)
            self.state = create_render_state(self.cfg, self.device)
            self._camera_dirty = True

    # --- scripted input ---

    def inject_key(self, key: Key, action: KeyAction = KeyAction.PRESS) -> None:
        self.bus.trigger(EventType.KEY_INPUT, KeyInput(key, action))

    def inject_mouse_move(self, x: float, y: float) -> None:
        self.bus.trigger(EventType.MOUSE_MOVE, (x, y))

    def inject_resize(self, width: int, height: int) -> None:
        self.bus.trigger(EventType.RESIZE, (width, height))

    # --- frame loop ---

    def _device_camera(self):
        if self._camera_dirty or self._camera_dev is None:
            self._camera_dev = self.camera.to_device(self.device, self.cfg.reverse_depth)
            self._camera_dirty = False
        return self._camera_dev

    def _advance_animation(self) -> None:
        if self._soup_sorted is None or self._animation is None:
            return
        transforms = np.asarray(self._animation(self._frame_index), np.float32)
        self._frame_index += 1
        if np.array_equal(transforms, self._last_transforms):
            return  # static this frame: keep accumulating
        geom, bvh = tlas.refit_tlas(self.scene.bvh, self._soup_sorted,
                                    self._transforms(transforms))
        self.scene = self.scene._replace(geometry=geom, bvh=bvh)
        self._last_transforms = transforms
        self.state = reset_accumulation(self.state)

    def draw(self) -> None:
        """One frame with the active render mode."""
        dt = self.timer.get_delta_seconds()
        for system in self.systems:
            system.process(dt)

        self._advance_animation()
        camera = self._device_camera()
        if self.render_mode == RenderMode.HYBRID:
            image = render_hybrid(self.scene, self.cfg, camera)
            self.state = RenderState(accumulation=image, accum_index=self.state.accum_index)
            return
        if self.mesh is not None:
            if self._replicas[0] is not self.scene:
                # a new (e.g. refitted) scene goes to every other device once
                self._replicas = (self.scene, replicate_scene(self.scene, self.mesh))
            self.state, stats = shard_render_frame(self._replicas[1], self.cfg, camera,
                                                   self.state, self.mesh)
        else:
            self.state, stats = render_frame(self.scene, self.cfg, camera, self.state)
        rays = float(stats.rays)  # a readback every frame, as the reference
        self.total_rays += rays
        self.ray_counter.add(rays)

    def run(self, frames: int) -> None:
        for _ in range(frames):
            self.draw()

    # --- output ---

    def display_image(self) -> np.ndarray:
        return to_display(self.state, self.cfg)

    def hud_lines(self) -> list[str]:
        return self.stats.lines()

    # --- checkpoint / resume ---

    def save_checkpoint(self, path: str | Path) -> None:
        """Persist the (framebuffer, spp, camera, mode) render state."""
        d = self.camera.description
        np.savez(
            str(path),
            accumulation=self.state.accumulation.detach().cpu().numpy(),
            accum_index=np.asarray(self.state.accum_index, np.uint32),
            camera_position=np.asarray(d.position),
            camera_target=np.asarray(d.target),
            camera_up=np.asarray(d.up),
            camera_params=np.asarray([d.x_fov, d.aspect_ratio, d.z_near, d.z_far]),
            render_mode=self.render_mode.value,
        )

    def load_checkpoint(self, path: str | Path) -> None:
        data = np.load(str(path), allow_pickle=False)
        self.state = RenderState(
            accumulation=torch.from_numpy(
                np.array(data["accumulation"], np.float32)).to(self.device),
            accum_index=int(data["accum_index"]),
        )
        fov, aspect, znear, zfar = data["camera_params"]
        self.camera.description = dataclasses.replace(
            self.camera.description,
            position=tuple(data["camera_position"]),
            target=tuple(data["camera_target"]),
            up=tuple(data["camera_up"]),
            x_fov=float(fov),
            aspect_ratio=float(aspect),
            z_near=float(znear),
            z_far=float(zfar),
        )
        self.render_mode = RenderMode(str(data["render_mode"]))
        self._camera_dirty = True
