"""Interactive terminal viewer.

Counterpart of ``vulkanraytracing_tpu/app/viewer.py``, driving the port's
``Engine``.  Frames render as ANSI truecolor half-block cells (two pixels
per character row); keys are read raw from the tty and injected into the
Engine's event bus, as a window's callbacks would; the HUD lines are the
Engine's stats lines.

Controls:
  w/a/s/d       move (space/c for up/down)
  mouse         look around (xterm any-motion reporting, ESC[?1003h with
                SGR encoding, ESC[?1006h)
  arrow keys    look around (h/j/k/l also work)
  1-5           speed tiers
  t             toggle render mode (hybrid <-> path tracing)
  r             reset accumulation
  q / Esc       quit

Run: ``python -m vulkanraytracing_torch view --scene cornell``.  Needs a
truecolor-capable terminal.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np

from vulkanraytracing_torch.app.engine import Engine
from vulkanraytracing_torch.app.events import Key, KeyAction

_KEYMAP = {
    "w": Key.W, "a": Key.A, "s": Key.S, "d": Key.D,
    " ": Key.SPACE, "c": Key.LEFT_CONTROL,
    "1": Key.DIGIT_1, "2": Key.DIGIT_2, "3": Key.DIGIT_3,
    "4": Key.DIGIT_4, "5": Key.DIGIT_5,
    "t": Key.T, "r": Key.R,
}
# arrow/vi keys -> mouse-look deltas in pixels
_LOOKMAP = {
    "UP": (0.0, -20.0), "DOWN": (0.0, 20.0),
    "LEFT": (-20.0, 0.0), "RIGHT": (20.0, 0.0),
    "k": (0.0, -20.0), "j": (0.0, 20.0),
    "h": (-20.0, 0.0), "l": (20.0, 0.0),
}


def _ansi_image(img: np.ndarray, cols: int, rows: int) -> str:
    """(H, W, 3) float [0,1] -> ANSI truecolor half-block string."""
    h, w = img.shape[:2]
    # sample the image at the terminal grid (2 pixels per char row)
    ys = (np.linspace(0, h - 1, rows * 2)).astype(np.int32)
    xs = (np.linspace(0, w - 1, cols)).astype(np.int32)
    grid = (np.clip(img[ys][:, xs], 0.0, 1.0) * 255).astype(np.uint8)
    top = grid[0::2]
    bot = grid[1::2]
    lines = []
    for r in range(rows):
        parts = []
        for c in range(cols):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            parts.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


MOUSE_SENS = 8.0  # virtual look-pixels per terminal cell of mouse travel


def _decode_input(data: str) -> tuple[list, str]:
    """Decode raw tty input into tokens.

    Tokens are key strings ("w", "UP", "ESC", ...) plus
    ``("MOUSE", col, row, is_press_or_motion)`` tuples from xterm SGR
    mouse reports (``ESC[<b;x;yM`` / ``...m``, enabled by ESC[?1003h +
    ESC[?1006h).  Returns ``(tokens, remainder)`` where remainder is an
    incomplete trailing escape sequence to prepend to the next read."""
    tokens: list = []
    i, n = 0, len(data)
    while i < n:
        c = data[i]
        if c != "\x1b":
            tokens.append(c)
            i += 1
            continue
        if data.startswith("\x1b[<", i):
            j = i + 3
            while j < n and data[j] not in "Mm":
                j += 1
            if j >= n:  # incomplete mouse report: wait for more bytes
                return tokens, data[i:]
            fields = data[i + 3: j].split(";")
            if len(fields) == 3:
                try:
                    _b, x, y = (int(f) for f in fields)
                    tokens.append(("MOUSE", x, y, data[j] == "M"))
                except ValueError:
                    pass  # malformed report: drop it
            i = j + 1
        elif data.startswith("\x1b[", i):
            if i + 2 >= n:  # incomplete CSI: wait for more bytes
                return tokens, data[i:]
            tokens.append(
                {"A": "UP", "B": "DOWN", "C": "RIGHT", "D": "LEFT"}.get(
                    data[i + 2], "ESC"
                )
            )
            i += 3
        else:
            tokens.append("ESC")
            i += 1
    return tokens, ""


def _read_keys(timeout: float, carry: str = "") -> tuple[list, str]:
    """Non-blocking raw input reads; decodes arrows + SGR mouse reports.

    ``carry`` is the undecoded remainder from the previous call: an SGR
    mouse report split across polls must keep its ``\\x1b[<`` prefix, or
    the tail bytes (e.g. ``2;7M``) decode as literal keys — digits 1-5
    trigger speed-tier changes.  Returns (tokens, new carry)."""
    tokens: list = []
    buf = carry
    while select.select([sys.stdin], [], [], timeout)[0]:
        timeout = 0.0
        data = os.read(sys.stdin.fileno(), 1024).decode(errors="ignore")
        if not data:
            break
        toks, buf = _decode_input(buf + data)
        tokens.extend(toks)
    # leftover bare ESC bytes with no continuation = the Escape key
    if buf and set(buf) == {"\x1b"}:
        tokens.extend("ESC" for _ in buf)
        buf = ""
    return tokens, buf


class TerminalViewer:
    """Drives an Engine interactively in the terminal."""

    def __init__(self, engine: Engine, cols: int | None = None,
                 rows: int | None = None):
        self.engine = engine
        try:
            size = os.get_terminal_size()
            self.cols = cols or max(20, min(size.columns, 160))
            self.rows = rows or max(10, min(size.lines - 4, 60))
        except OSError:
            self.cols = cols or 96
            self.rows = rows or 40

    def frame(self, keys: list[str]) -> str:
        """One interactive step: inject keys, draw, return the ANSI frame.

        Split from run() so tests can drive the viewer without a tty."""
        eng = self.engine
        for k in keys:
            if k in _KEYMAP:
                eng.inject_key(_KEYMAP[k], KeyAction.PRESS)
                if _KEYMAP[k] not in (Key.T, Key.R):
                    # terminals deliver no key-up: treat as a tap; track
                    # ALL taps from this poll so none is left held
                    self._taps = getattr(self, "_taps", [])
                    self._taps.append(_KEYMAP[k])
            elif isinstance(k, tuple) and k and k[0] == "MOUSE":
                # mouse-look: any motion rotates, as with a captured
                # cursor.  Cell deltas scale to the
                # same virtual-pixel space the key-look path uses; the
                # first report only anchors (no camera jump).
                _, cx, cy, _press = k
                last = getattr(self, "_mouse_cell", None)
                if last is None:
                    # first report: anchor both the viewer cell and the
                    # CameraSystem delta base (its first event is also
                    # anchor-only)
                    eng.inject_mouse_move(*getattr(self, "_mouse", (0.0, 0.0)))
                elif (cx, cy) != last:
                    x, y = getattr(self, "_mouse", (0.0, 0.0))
                    self._mouse = (
                        x + (cx - last[0]) * MOUSE_SENS,
                        y + (cy - last[1]) * MOUSE_SENS,
                    )
                    eng.inject_mouse_move(*self._mouse)
                self._mouse_cell = (cx, cy)
            elif k in _LOOKMAP:
                dx, dy = _LOOKMAP[k]
                x, y = getattr(self, "_mouse", (0.0, 0.0))
                self._mouse = (x + dx, y + dy)
                eng.inject_mouse_move(*self._mouse)
        eng.draw()
        for tap in getattr(self, "_taps", []):
            eng.inject_key(tap, KeyAction.RELEASE)
        self._taps = []
        img = eng.display_image()
        hud = " | ".join(eng.hud_lines())
        body = _ansi_image(np.asarray(img), self.cols, self.rows)
        return f"\x1b[H{body}\n\x1b[K{hud}"

    def run(self) -> None:
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        # clear, hide cursor, enable any-motion mouse reporting (1003)
        # with SGR encoding (1006)
        sys.stdout.write("\x1b[2J\x1b[?25l\x1b[?1003h\x1b[?1006h")
        try:
            tty.setcbreak(fd)
            pending = ""
            while True:
                t0 = time.time()
                keys, pending = _read_keys(0.0, pending)
                if any(k in ("q", "ESC") for k in keys):
                    break
                sys.stdout.write(self.frame(keys))
                sys.stdout.flush()
                # cap redraw rate; leave the device busy, not the tty
                dt = time.time() - t0
                if dt < 0.05:
                    time.sleep(0.05 - dt)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            # mouse reporting off, restore cursor
            sys.stdout.write("\x1b[?1006l\x1b[?1003l\x1b[?25h\x1b[0m\n")
