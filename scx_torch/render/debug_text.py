"""In-framebuffer debug text (port of scx.render.debug_text): a 5x7 bitmap
font stamped into the rendered frame on device.

The reference draws its Debug Overlay with ImGui into the swapchain image
(sc_imgui.cpp:186-629); the software renderer's framebuffer is a device
tensor, so the overlay becomes one masked blend.  Glyphs cover what the telemetry
overlay prints (scx.telemetry.snapshots.format_overlay): digits, uppercase
letters (input is uppercased), and punctuation.  Unknown glyphs render as
blanks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

GLYPH_W, GLYPH_H = 5, 7
_CELL_W, _CELL_H = 6, 9  # 1px x / 2px y spacing

# 5x7 string-art font ('#' = lit). Public-domain shapes, hand-authored.
_GLYPHS = {
    " ": ["     "] * 7,
    "0": [" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "],
    "1": ["  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "2": [" ### ", "#   #", "    #", "  ## ", " #   ", "#    ", "#####"],
    "3": [" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "],
    "4": ["   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "],
    "5": ["#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "],
    "6": [" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "],
    "7": ["#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "],
    "8": [" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "],
    "9": [" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "],
    "A": [" ### ", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"],
    "B": ["#### ", "#   #", "#   #", "#### ", "#   #", "#   #", "#### "],
    "C": [" ### ", "#   #", "#    ", "#    ", "#    ", "#   #", " ### "],
    "D": ["#### ", "#   #", "#   #", "#   #", "#   #", "#   #", "#### "],
    "E": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#####"],
    "F": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#    "],
    "G": [" ### ", "#   #", "#    ", "# ###", "#   #", "#   #", " ### "],
    "H": ["#   #", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"],
    "I": [" ### ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "J": ["  ###", "   # ", "   # ", "   # ", "   # ", "#  # ", " ##  "],
    "K": ["#   #", "#  # ", "# #  ", "##   ", "# #  ", "#  # ", "#   #"],
    "L": ["#    ", "#    ", "#    ", "#    ", "#    ", "#    ", "#####"],
    "M": ["#   #", "## ##", "# # #", "# # #", "#   #", "#   #", "#   #"],
    "N": ["#   #", "##  #", "# # #", "#  ##", "#   #", "#   #", "#   #"],
    "O": [" ### ", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "P": ["#### ", "#   #", "#   #", "#### ", "#    ", "#    ", "#    "],
    "Q": [" ### ", "#   #", "#   #", "#   #", "# # #", "#  # ", " ## #"],
    "R": ["#### ", "#   #", "#   #", "#### ", "# #  ", "#  # ", "#   #"],
    "S": [" ####", "#    ", "#    ", " ### ", "    #", "    #", "#### "],
    "T": ["#####", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
    "U": ["#   #", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "V": ["#   #", "#   #", "#   #", "#   #", "#   #", " # # ", "  #  "],
    "W": ["#   #", "#   #", "#   #", "# # #", "# # #", "## ##", "#   #"],
    "X": ["#   #", "#   #", " # # ", "  #  ", " # # ", "#   #", "#   #"],
    "Y": ["#   #", "#   #", " # # ", "  #  ", "  #  ", "  #  ", "  #  "],
    "Z": ["#####", "    #", "   # ", "  #  ", " #   ", "#    ", "#####"],
    ".": ["     ", "     ", "     ", "     ", "     ", " ##  ", " ##  "],
    ",": ["     ", "     ", "     ", "     ", " ##  ", "  #  ", " #   "],
    ":": ["     ", " ##  ", " ##  ", "     ", " ##  ", " ##  ", "     "],
    ";": ["     ", " ##  ", " ##  ", "     ", " ##  ", "  #  ", "     "],
    "-": ["     ", "     ", "     ", "#####", "     ", "     ", "     "],
    "+": ["     ", "  #  ", "  #  ", "#####", "  #  ", "  #  ", "     "],
    "/": ["    #", "    #", "   # ", "  #  ", " #   ", "#    ", "#    "],
    "(": ["   # ", "  #  ", " #   ", " #   ", " #   ", "  #  ", "   # "],
    ")": [" #   ", "  #  ", "   # ", "   # ", "   # ", "  #  ", " #   "],
    "%": ["##  #", "##  #", "   # ", "  #  ", " #   ", "#  ##", "#  ##"],
    "#": [" # # ", " # # ", "#####", " # # ", "#####", " # # ", " # # "],
    "_": ["     ", "     ", "     ", "     ", "     ", "     ", "#####"],
    "=": ["     ", "     ", "#####", "     ", "#####", "     ", "     "],
    "[": [" ### ", " #   ", " #   ", " #   ", " #   ", " #   ", " ### "],
    "]": [" ### ", "   # ", "   # ", "   # ", "   # ", "   # ", " ### "],
    "'": ["  #  ", "  #  ", "     ", "     ", "     ", "     ", "     "],
    ">": [" #   ", "  #  ", "   # ", "    #", "   # ", "  #  ", " #   "],
    "<": ["   # ", "  #  ", " #   ", "#    ", " #   ", "  #  ", "   # "],
    "|": ["  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
}


@functools.lru_cache(maxsize=1)
def _font_table() -> np.ndarray:
    """[96, GLYPH_H, GLYPH_W] f32 bitmap for ASCII 32..127."""
    table = np.zeros((96, GLYPH_H, GLYPH_W), np.float32)
    for ch, rows in _GLYPHS.items():
        g = np.asarray(
            [[1.0 if c == "#" else 0.0 for c in row.ljust(GLYPH_W)] for row in rows],
            np.float32,
        )
        table[ord(ch) - 32] = g
    return table


def text_to_codes(text: str, max_cols: int) -> np.ndarray:
    """Host: multi-line string -> [rows, max_cols] i32 font indices."""
    lines = text.upper().splitlines() or [""]
    rows = len(lines)
    codes = np.zeros((rows, max_cols), np.int32)  # 0 == space
    for r, line in enumerate(lines):
        for c, ch in enumerate(line[:max_cols]):
            v = ord(ch) - 32
            codes[r, c] = v if 0 <= v < 96 else 0
    return codes


def stamp_text(rgb, codes, x: int = 4, y: int = 4,
               color=(1.0, 1.0, 1.0), bg_alpha: float = 0.55):
    """Blend the glyph block into rgb [H,W,3] at (x, y); returns a new rgb.

    One [region] gather over the font table + two masked blends."""
    dev = rgb.device
    font = torch.from_numpy(_font_table()).to(dev)
    rows, cols = codes.shape
    rh, rw = rows * _CELL_H, cols * _CELL_W
    h, w = rgb.shape[0], rgb.shape[1]
    rh = min(rh, h - y)
    rw = min(rw, w - x)
    yy = torch.arange(rh, device=dev)
    xx = torch.arange(rw, device=dev)
    cell_r = yy // _CELL_H
    cell_c = xx // _CELL_W
    gy = yy % _CELL_H
    gx = xx % _CELL_W
    code = torch.as_tensor(np.asarray(codes), device=dev).long()[cell_r[:, None],
                                                                 cell_c[None, :]]
    in_glyph = (gy[:, None] < GLYPH_H) & (gx[None, :] < GLYPH_W)
    lit = font[
        code,
        torch.clamp(gy, max=GLYPH_H - 1)[:, None],
        torch.clamp(gx, max=GLYPH_W - 1)[None, :],
    ] * in_glyph
    region = rgb[y:y + rh, x:x + rw]
    dimmed = region * (1.0 - bg_alpha)
    out = torch.where(
        lit[..., None] > 0.5, torch.tensor(color, dtype=rgb.dtype, device=dev), dimmed
    )
    rgb = rgb.clone()
    rgb[y:y + rh, x:x + rw] = out
    return rgb
