"""User commands and the key-byte mapping.

Port of the reference's command enum (reference user_commands.rs)
and the raw-byte keyboard decode table (raw_mode_guard.rs:65-101):
Enter/Space confirm; WASD + IJKL move; TFGH fast-move; R/Esc cancel;
Q quit; '[' (escape-sequence filler) ignored.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Kind(enum.Enum):
    MOVE_UP = "up"
    MOVE_DOWN = "down"
    MOVE_LEFT = "left"
    MOVE_RIGHT = "right"
    CONFIRM = "confirm"
    CANCEL = "cancel"
    QUIT = "quit"


@dataclasses.dataclass(frozen=True)
class UserCommand:
    kind: Kind
    fast: bool = False


_KEYMAP = {}
for _bytes, _cmd in [
    ((10, 13, 32), UserCommand(Kind.CONFIRM)),
    ((87, 119, 73, 105), UserCommand(Kind.MOVE_UP)),        # W w I i
    ((83, 115, 75, 107), UserCommand(Kind.MOVE_DOWN)),      # S s K k
    ((65, 97, 74, 106), UserCommand(Kind.MOVE_LEFT)),       # A a J j
    ((68, 100, 76, 108), UserCommand(Kind.MOVE_RIGHT)),     # D d L l
    ((84, 116), UserCommand(Kind.MOVE_UP, fast=True)),      # T t
    ((71, 103), UserCommand(Kind.MOVE_DOWN, fast=True)),    # G g
    ((70, 102), UserCommand(Kind.MOVE_LEFT, fast=True)),    # F f
    ((72, 104), UserCommand(Kind.MOVE_RIGHT, fast=True)),   # H h
    ((82, 114, 27), UserCommand(Kind.CANCEL)),              # R r Esc
    ((81, 113), UserCommand(Kind.QUIT)),                    # Q q
]:
    for _b in _bytes:
        _KEYMAP[_b] = _cmd


def decode_key(byte: int) -> Optional[UserCommand]:
    """Byte -> command, or None for unmapped bytes (incl. '[' = 91,
    raw_mode_guard.rs:98)."""
    return _KEYMAP.get(byte)
