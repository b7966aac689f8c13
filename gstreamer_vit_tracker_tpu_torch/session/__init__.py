"""Interactive tracking session: commands, selection geometry, state machine."""

from . import commands, machine, selection  # noqa: F401
from .commands import Kind, UserCommand, decode_key  # noqa: F401
from .machine import SessionState, TorchTrackerBackend, TrackerSession  # noqa: F401
from .selection import SelectionPhase, SelectionState  # noqa: F401
