"""The 5x7 bitmap HUD font.

Glyph data matches the reference's 41-glyph table bit-for-bit
(reference drawing.rs:53-94, duplicated at nv12_convert.rs:255-296)
— digits, ``. : - %`` and exactly the upper/lower-case letters needed for
the status strings ("SELECT START/END", "TRACKING", "LOST", "FPS",
"score", "trk", "ms", ...).  Like the reference's ``get_glyph`` (which
panics on an unmapped char, drawing.rs:99), :func:`encode_text` raises on
characters outside the table so HUD strings stay within the font.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_GLYPHS = {
    "0": [0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110],
    "1": [0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110],
    "2": [0b01110, 0b10001, 0b00001, 0b00110, 0b01000, 0b10000, 0b11111],
    "3": [0b01110, 0b10001, 0b00001, 0b00110, 0b00001, 0b10001, 0b01110],
    "4": [0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010],
    "5": [0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110],
    "6": [0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110],
    "7": [0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000],
    "8": [0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110],
    "9": [0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100],
    ".": [0b00000, 0b00000, 0b00000, 0b00000, 0b00000, 0b01100, 0b01100],
    ":": [0b00000, 0b01100, 0b01100, 0b00000, 0b01100, 0b01100, 0b00000],
    "-": [0b00000, 0b00000, 0b00000, 0b11111, 0b00000, 0b00000, 0b00000],
    " ": [0b00000, 0b00000, 0b00000, 0b00000, 0b00000, 0b00000, 0b00000],
    "F": [0b11111, 0b10000, 0b11110, 0b10000, 0b10000, 0b10000, 0b10000],
    "P": [0b11110, 0b10001, 0b11110, 0b10000, 0b10000, 0b10000, 0b10000],
    "S": [0b01110, 0b10001, 0b10000, 0b01110, 0b00001, 0b10001, 0b01110],
    "T": [0b11111, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100],
    "R": [0b11110, 0b10001, 0b11110, 0b10100, 0b10010, 0b10001, 0b10001],
    "A": [0b01110, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001, 0b10001],
    "C": [0b01110, 0b10001, 0b10000, 0b10000, 0b10000, 0b10001, 0b01110],
    "K": [0b10001, 0b10010, 0b10100, 0b11000, 0b10100, 0b10010, 0b10001],
    "I": [0b01110, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110],
    "N": [0b10001, 0b11001, 0b10101, 0b10011, 0b10001, 0b10001, 0b10001],
    "G": [0b01110, 0b10001, 0b10000, 0b10111, 0b10001, 0b10001, 0b01110],
    "E": [0b11111, 0b10000, 0b11110, 0b10000, 0b10000, 0b10000, 0b11111],
    "L": [0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b11111],
    "O": [0b01110, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110],
    "D": [0b11100, 0b10010, 0b10001, 0b10001, 0b10001, 0b10010, 0b11100],
    "%": [0b11001, 0b11010, 0b00100, 0b00100, 0b01000, 0b01011, 0b10011],
    "s": [0b00000, 0b00000, 0b01110, 0b10000, 0b01110, 0b00001, 0b11110],
    "c": [0b00000, 0b00000, 0b01110, 0b10000, 0b10000, 0b10001, 0b01110],
    "o": [0b00000, 0b00000, 0b01110, 0b10001, 0b10001, 0b10001, 0b01110],
    "r": [0b00000, 0b00000, 0b10110, 0b11001, 0b10000, 0b10000, 0b10000],
    "e": [0b00000, 0b00000, 0b01110, 0b10001, 0b11111, 0b10000, 0b01110],
    "m": [0b00000, 0b00000, 0b11010, 0b10101, 0b10101, 0b10001, 0b10001],
    "t": [0b01000, 0b01000, 0b11100, 0b01000, 0b01000, 0b01001, 0b00110],
    "k": [0b10000, 0b10000, 0b10010, 0b10100, 0b11000, 0b10100, 0b10010],
    "n": [0b00000, 0b00000, 0b10110, 0b11001, 0b10001, 0b10001, 0b10001],
    "v": [0b00000, 0b00000, 0b10001, 0b10001, 0b10001, 0b01010, 0b00100],
}

FONT_CHARS = "".join(_GLYPHS.keys())
_CHAR_INDEX = {c: i for i, c in enumerate(FONT_CHARS)}

# (num_glyphs, 7, 5) boolean bitmap table — a device constant for the
# overlay compositor.
FONT_TABLE = np.array(
    [[[(bits >> (4 - col)) & 1 for col in range(5)] for bits in rows]
     for rows in _GLYPHS.values()],
    dtype=np.uint8,
)

ADVANCE = 6  # glyph cell width incl. 1px spacing (drawing_rgb.rs:102)


def encode_text(text: str, max_len: int) -> Tuple[np.ndarray, int]:
    """Map a string to glyph indices, padded with spaces to ``max_len``.

    Raises KeyError on unmapped characters (get_glyph parity, drawing.rs:99)
    and ValueError if the string exceeds ``max_len``.
    """
    if len(text) > max_len:
        raise ValueError(f"text {text!r} exceeds max_len={max_len}")
    idx = np.full((max_len,), _CHAR_INDEX[" "], np.int32)
    for i, ch in enumerate(text):
        if ch not in _CHAR_INDEX:
            raise KeyError(f"No char! {ch!r} not in HUD font")
        idx[i] = _CHAR_INDEX[ch]
    return idx, len(text)


def glyph(ch: str) -> np.ndarray:
    """(7, 5) uint8 bitmap for one char (test/inspection helper)."""
    return FONT_TABLE[_CHAR_INDEX[ch]]
