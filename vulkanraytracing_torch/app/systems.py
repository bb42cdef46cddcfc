"""Engine systems: the per-frame ``process(dt)`` units.

Counterpart of ``vulkanraytracing_tpu/app/systems.py``: the ``System``
base, the FPS-style ``CameraSystem`` and the ``StatsSystem`` that turns
frame time and bound values into text lines.  Host-side numpy only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from vulkanraytracing_torch.app.events import EventBus, EventType, Key, KeyAction, KeyInput
from vulkanraytracing_torch.scene.camera import Camera

_SENSITIVITY_REDUCTION = 0.001
_PITCH_LIMIT = math.radians(89.0)

# forward is -Z, left -X (the A key strafes left), up +Y
_FORWARD = np.array([0.0, 0.0, -1.0])
_LEFT = np.array([-1.0, 0.0, 0.0])
_UP = np.array([0.0, 1.0, 0.0])


class System:
    def process(self, dt: float) -> None:
        raise NotImplementedError


def _orientation_matrix(yaw: float, pitch: float) -> np.ndarray:
    """Yaw about -Y, then pitch about +X, as a rotation matrix."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    yaw_m = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    pitch_m = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return yaw_m @ pitch_m


class CameraSystem(System):
    """FPS-style camera controller.

    Movement keys accumulate an axis direction; ``process`` translates
    both position and target by orientation * direction * speed * dt, with
    speed = base_speed * speed_multiplier ** speed_index (keys 1-5); mouse
    deltas steer yaw and pitch, the pitch clamped to +-89 degrees.  Any
    movement fires CAMERA_UPDATE, which resets the accumulation.
    """

    def __init__(
        self,
        camera: Camera,
        bus: EventBus,
        sensitivity: float = 1.0,
        base_speed: float = 2.0,
        speed_multiplier: float = 4.0,
    ) -> None:
        self.camera = camera
        self.bus = bus
        self.sensitivity = sensitivity
        self.base_speed = base_speed
        self.speed_multiplier = speed_multiplier
        self.speed_index = 0
        self._pressed: set[Key] = set()
        self._last_mouse: tuple[float, float] | None = None

        # initial yaw and pitch from the camera direction
        d = np.asarray(self.camera.description.target) - np.asarray(
            self.camera.description.position
        )
        d = d / np.linalg.norm(d)
        self.yaw = math.atan2(d[0], -d[2])
        self.pitch = math.atan2(d[1], math.hypot(d[0], d[2]))

        bus.add_handler(EventType.KEY_INPUT, self._on_key)
        bus.add_handler(EventType.MOUSE_MOVE, self._on_mouse_move)
        bus.add_handler(EventType.RESIZE, self._on_resize)

    # --- event handlers ---

    def _on_key(self, event: KeyInput) -> None:
        digits = {
            Key.DIGIT_1: 0, Key.DIGIT_2: 1, Key.DIGIT_3: 2,
            Key.DIGIT_4: 3, Key.DIGIT_5: 4,
        }
        if event.action == KeyAction.PRESS:
            if event.key in digits:
                self.speed_index = digits[event.key]
            else:
                self._pressed.add(event.key)
        elif event.action == KeyAction.RELEASE:
            self._pressed.discard(event.key)

    def _on_mouse_move(self, position) -> None:
        x, y = position
        if self._last_mouse is not None:
            dx = x - self._last_mouse[0]
            dy = -(y - self._last_mouse[1])
            self.yaw += dx * self.sensitivity * _SENSITIVITY_REDUCTION
            self.pitch += dy * self.sensitivity * _SENSITIVITY_REDUCTION
            self.pitch = max(-_PITCH_LIMIT, min(_PITCH_LIMIT, self.pitch))
            direction = _orientation_matrix(self.yaw, self.pitch) @ _FORWARD
            self.camera.set_direction(direction / np.linalg.norm(direction))
        self._last_mouse = (x, y)
        self.bus.trigger(EventType.CAMERA_UPDATE)

    def _on_resize(self, extent) -> None:
        w, h = extent
        if w and h:
            self.camera.description = dataclasses.replace(
                self.camera.description, aspect_ratio=w / h
            )

    # --- per frame ---

    def _movement_direction(self) -> np.ndarray:
        d = np.zeros(3)
        if Key.W in self._pressed:
            d += _FORWARD
        if Key.S in self._pressed:
            d -= _FORWARD
        if Key.A in self._pressed:
            d += _LEFT
        if Key.D in self._pressed:
            d -= _LEFT
        if Key.SPACE in self._pressed:
            d += _UP
        if Key.LEFT_CONTROL in self._pressed:
            d -= _UP
        return d

    def process(self, dt: float) -> None:
        move = self._movement_direction()
        if not move.any():
            return
        direction = _orientation_matrix(self.yaw, self.pitch) @ move
        speed = self.base_speed * self.speed_multiplier ** self.speed_index
        translation = direction * speed * dt
        desc = self.camera.description
        self.camera.set_position(np.asarray(desc.position) + translation)
        self.camera.set_target(np.asarray(desc.target) + translation)
        self.bus.trigger(EventType.CAMERA_UPDATE)


class StatsSystem(System):
    """Text stat lines: the frame time and FPS, then every bound line."""

    def __init__(self) -> None:
        self.bindings: list[Callable[[], str]] = []
        self.frame_time_ms = 0.0

    def bind_text(self, fn: Callable[[], str]) -> None:
        self.bindings.append(fn)

    def process(self, dt: float) -> None:
        self.frame_time_ms = dt * 1e3

    def lines(self) -> list[str]:
        fps = 1e3 / self.frame_time_ms if self.frame_time_ms > 0 else 0.0
        out = [f"{self.frame_time_ms:.2f} ms/frame ({fps:.1f} FPS)"]
        out.extend(fn() for fn in self.bindings)
        return out
