"""Frame sources, sinks, containers and pipeline descriptions.

The port's own copy of ``gstreamer_vit_tracker_tpu/media`` (numpy, ctypes
and lazily imported cv2 / PIL; no JAX), held equal to the original by
``tests/test_torch_media.py`` (``indie.py``, the independent eval world, by
``tests/test_torch_indie.py``).
"""

from . import gst, mjpeg, queue, sink, source  # noqa: F401
from .gst import PipelineSpec, parse_launch  # noqa: F401
from .mjpeg import MJPEGSource  # noqa: F401
from .queue import FrameQueue  # noqa: F401
from .sink import FileSink, MJPEGSink, MultiSink, NullSink  # noqa: F401
from .source import (FileSource, FlakySource, SyntheticSource,  # noqa: F401
                     V4L2Source)
