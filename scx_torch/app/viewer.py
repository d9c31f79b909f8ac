"""Headless viewer (port of scx.app.viewer): drive the sandbox on the card
and write frames to disk.

The reference opens an SDL window (sc_app.cpp); here frames go to PNG files
(PIL) or PPM (always available). Doubles as the app-shell component: event
pump -> scripted inputs, resize -> raster params. scx's `--edit` (the world
editor) and the interactive console are not ported: both need scx.tools and
scx.app.debugui.

Usage: python -m scx_torch.app.viewer --frames 120 --out build/frames
       [--cpu] [--interactive] [--trace build/trace]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from scx_torch.assets.textures import linear_to_srgb


def _host_rgb(rgb) -> np.ndarray:
    if isinstance(rgb, torch.Tensor):
        return rgb.detach().cpu().numpy()
    return np.asarray(rgb)


def save_frame(path: str, rgb, srgb: bool = True) -> str:
    """Write a linear-light frame to PNG/PPM. srgb=True applies the display
    transfer (the swapchain's implicit sRGB encode in the reference's
    present path — sc_assets.cpp:600 renders into an sRGB target);
    srgb=False dumps raw values (debug/AOV sinks)."""
    arr = _host_rgb(rgb)
    if srgb:
        arr = np.asarray(linear_to_srgb(arr))
    arr = np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)
    try:
        from PIL import Image

        p = path + ".png"
        Image.fromarray(arr).save(p)
        return p
    except Exception:
        p = path + ".ppm"
        with open(p, "wb") as fh:
            fh.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            fh.write(arr.tobytes())
        return p


def scripted_input(frame: int) -> tuple:
    """Drive forward, weave gently — a demo 'event pump'."""
    import math

    steer = 0.35 * math.sin(frame * 0.02)
    return (0.8, 0.0, steer, 0.0)


def frame_to_ansi(rgb, cols: int = 100, srgb: bool = True) -> str:
    """Terminal rendering: half-block chars, 2 pixels per cell, 24-bit color.

    The interactive stand-in for the reference's SDL window — works over
    any ssh terminal. Applies the display sRGB encode like save_frame."""
    arr = _host_rgb(rgb)
    if srgb:
        arr = np.asarray(linear_to_srgb(arr))
    arr = np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    rows = max(2, int(cols * h / w / 2) * 2)
    ys = (np.arange(rows) * h // rows).clip(0, h - 1)
    xs = (np.arange(cols) * w // cols).clip(0, w - 1)
    img = arr[ys][:, xs]
    out = []
    for r in range(0, rows - 1, 2):
        line = []
        for c in range(cols):
            tr, tg, tb = img[r, c]
            br, bg_, bb = img[r + 1, c]
            line.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀"
            )
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


class TerminalInput:
    """Non-blocking WASD/space keyboard pump (cbreak tty; the reference's
    SDL event pump, sc_app.cpp:12-90). Keys decay after a few frames so
    auto-repeat feels like held keys."""

    HOLD = 6  # frames a keypress stays asserted

    def __init__(self):
        import sys as _sys

        self._held: dict[str, int] = {}
        self.quit = False
        self._fd = None
        self._old = None
        if _sys.stdin.isatty():
            import termios
            import tty

            self._fd = _sys.stdin.fileno()
            self._old = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)

    def pump(self) -> tuple:
        import select
        import sys as _sys

        while self._fd is not None:
            r, _, _ = select.select([_sys.stdin], [], [], 0)
            if not r:
                break
            ch = _sys.stdin.read(1).lower()
            if ch == "q":
                self.quit = True
            self._held[ch] = self.HOLD
        for k in list(self._held):
            self._held[k] -= 1
            if self._held[k] <= 0:
                del self._held[k]
        h = self._held
        throttle = 1.0 if "w" in h else 0.0
        brake = 1.0 if "s" in h else 0.0
        steer = (1.0 if "d" in h else 0.0) - (1.0 if "a" in h else 0.0)
        handbrake = 1.0 if " " in h else 0.0
        return (throttle, brake, steer, handbrake)

    def close(self):
        if self._fd is not None and self._old is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--every", type=int, default=10, help="save every Nth frame")
    ap.add_argument("--out", default="build/frames")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=352)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument(
        "--interactive", action="store_true",
        help="render to the terminal (ANSI half-blocks), WASD+space drive, q quits",
    )
    ap.add_argument(
        "--trace", default=None, metavar="LOGDIR",
        help="capture a torch.profiler trace of the run into LOGDIR",
    )
    ap.add_argument("--term-cols", type=int, default=110)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); the card otherwise")
    args = ap.parse_args(argv)

    from scx_torch.app.sandbox import Sandbox
    from scx_torch.render.pipeline import RasterParams

    os.makedirs(args.out, exist_ok=True)
    sb = Sandbox(
        capacity=args.capacity,
        raster=RasterParams(width=args.width, height=args.height, max_tris=65536),
        device="cpu" if args.cpu else None,
    )
    saved = []
    term = TerminalInput() if args.interactive else None
    if args.trace:
        from scx_torch.telemetry import trace

        trace.start_trace(args.trace)
    try:
        for i in range(args.frames):
            inp = term.pump() if term else scripted_input(i)
            rgb, tel = sb.frame(player_input=inp)
            if term:
                print("\x1b[H\x1b[2J" + frame_to_ansi(rgb, args.term_cols))
                print(sb.telemetry.format_overlay(), flush=True)
                if term.quit:
                    break
            elif i % args.every == 0:
                saved.append(
                    save_frame(os.path.join(args.out, f"frame_{i:04d}"), rgb)
                )
                print(sb.telemetry.format_overlay())
                print("->", saved[-1], flush=True)
    finally:
        if term:
            term.close()
        if args.trace:
            trace.stop_trace()
            print(f"trace captured to {args.trace}", flush=True)
    sb.shutdown()
    if not args.interactive:
        print(f"saved {len(saved)} frames to {args.out}")
    return saved


if __name__ == "__main__":
    main()
