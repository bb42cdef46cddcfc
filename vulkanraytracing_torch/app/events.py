"""Typed event bus and input types.

Counterpart of ``vulkanraytracing_tpu/app/events.py``: a handler registry
with ``trigger`` / ``add_handler``, the event types, and the keys and key
actions the default bindings use.  The bus is an instance, so several
engines can live in one process.
"""

from __future__ import annotations

import enum
from collections import defaultdict
from typing import Any, Callable, NamedTuple


class EventType(enum.Enum):
    RESIZE = "resize"
    KEY_INPUT = "key_input"
    MOUSE_INPUT = "mouse_input"
    MOUSE_MOVE = "mouse_move"
    CAMERA_UPDATE = "camera_update"


class Key(enum.Enum):
    """The keys of the default bindings."""

    W = "w"
    A = "a"
    S = "s"
    D = "d"
    SPACE = "space"
    LEFT_CONTROL = "lctrl"
    DIGIT_1 = "1"
    DIGIT_2 = "2"
    DIGIT_3 = "3"
    DIGIT_4 = "4"
    DIGIT_5 = "5"
    T = "t"  # render-mode toggle
    R = "r"  # reload: reset the accumulation


class KeyAction(enum.Enum):
    PRESS = "press"
    RELEASE = "release"
    REPEAT = "repeat"


class KeyInput(NamedTuple):
    key: Key
    action: KeyAction


class EventBus:
    """Handlers per event type, called in the order they were added."""

    def __init__(self) -> None:
        self._handlers: dict[EventType, list[Callable[[Any], None]]] = (
            defaultdict(list)
        )

    def add_handler(self, event: EventType, handler: Callable[[Any], None]) -> None:
        self._handlers[event].append(handler)

    def trigger(self, event: EventType, payload: Any = None) -> None:
        for handler in self._handlers[event]:
            handler(payload)
