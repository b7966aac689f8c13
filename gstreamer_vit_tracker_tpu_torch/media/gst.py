"""gst-launch-style pipeline descriptions, mapped onto this framework.

The reference builds its media graph as a GStreamer element chain —
``v4l2src → capsfilter → videoconvert → capsfilter → identity →
rgaconvert → capsfilter → queue → kmssink``
(reference pipeline_ir.rs:21-87; the legacy NV12 variant at
reference pipeline.rs:19-53).  Its users think in
``gst-launch-1.0`` one-liners.  This module accepts that dialect and maps
each element onto the framework component that plays its role, so the
reference's own pipeline line drives this framework unchanged:

    v4l2src device=/dev/video21 io-mode=4 !
      video/x-raw,format=YUY2,width=640,height=512,framerate=60/1 !
      videoconvert n-threads=4 ! video/x-raw,format=RGB ! identity !
      rgaconvert ! video/x-raw,format=RGB,width=1280,height=1024 !
      queue max-size-buffers=3 leaky=downstream ! kmssink sync=false

Element → component map (every row cites the reference stage it mirrors):

=================  ====================================================
gst element        framework component
=================  ====================================================
v4l2src            media.source.V4L2Source (pipeline_ir.rs:21-26)
videotestsrc       media.source.SyntheticSource (portable test source)
filesrc+decodebin  media.source.FileSource (y4m / cv2 containers)
souphttpsrc +      media.mjpeg.MJPEGSource (IP-camera MJPEG over HTTP;
multipartdemux +   the network analog of the reference's live sensor)
jpegdec
video/x-raw caps   capture or display geometry + frame format
                   (pipeline_ir.rs:27-41,64-73)
videoconvert       no-op: colorspace conversion happens on-device inside
                   the fused preprocess kernel (ops/preprocess.py), not
                   as a pipeline stage (pipeline_ir.rs:43-45)
identity           the tracker tap — the reference installs its pad
                   probe here (pipeline_ir.rs:98-100); the app's frame
                   loop plays the probe closure
rgaconvert /       on-device display upscale (--display-scale;
videoscale         ops/resample.py) (pipeline_ir.rs:62-73)
queue              media.queue.FrameQueue (max-size-buffers / leaky,
                   pipeline_ir.rs:75-78)
kmssink /          live view — media.sink.MJPEGSink (connector-id /
autovideosink      plane-id accepted and recorded; there is no DRM on a
                   accelerator host) (pipeline_ir.rs:80-84)
y4menc ! filesink  media.sink.FileSink recording (location → path)
fakesink / appsink media.sink.NullSink (headless)
=================  ====================================================

Only parsing lives here; ``app/main.py --gst "<desc>"`` consumes the spec
(apply_to_args) so one pipeline string configures the whole app.  Unknown
elements fail loudly with the supported set — a silently dropped stage
would change semantics.
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import Dict, List, Optional, Tuple

__all__ = ["PipelineSpec", "parse_launch", "apply_to_args"]

_FORMAT_MAP = {"YUY2": "yuy2", "NV12": "nv12", "RGB": "rgb"}

# Elements that are accepted and contribute nothing beyond their
# documented mapping (conversion is fused on-device; decodebin is implied
# by FileSource's container handling; multipartdemux+jpegdec by
# MJPEGSource's stream parsing).
_NOOP_ELEMENTS = {"videoconvert", "decodebin", "y4mdec", "jpegdec",
                  "multipartdemux"}

_SINK_ELEMENTS = {"kmssink", "autovideosink", "ximagesink", "glimagesink",
                  "waylandsink", "fakesink", "appsink", "filesink"}


@dataclasses.dataclass
class PipelineSpec:
    """Normalized result of parsing a gst-launch description."""

    source: str = "synthetic"            # synthetic | file | v4l2
    device: str = "/dev/video21"         # v4l2src device=
    input_path: str = ""                 # filesrc location=
    fmt: str = "rgb"                     # capture caps format
    width: int = 640
    height: int = 512
    fps: int = 60
    queue_buffers: int = 3               # queue max-size-buffers=
    queue_leaky: bool = True             # queue leaky=downstream|2
    has_probe: bool = False              # identity present (tracker tap)
    display: bool = False                # a live video sink is present
    display_width: Optional[int] = None  # caps after the scaler stage
    display_height: Optional[int] = None
    record_path: str = ""                # filesink location=
    sink_props: Dict[str, str] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)
    fmt_from_caps: bool = False          # first format-bearing caps wins
    v4l2_pixfmt: str = "yuy2"            # image/jpeg caps -> "mjpeg"


def _parse_caps(caps: str) -> Tuple[str, Dict[str, str]]:
    """Parse ``video/x-raw,format=YUY2,width=640,...`` into
    (media_type, fields).  ``image/jpeg`` caps select a camera's MJPEG
    compressed mode (the v4l2src dialect for USB cams above 30fps)."""
    parts = caps.split(",")
    media = parts[0].strip()
    if media not in ("video/x-raw", "image/jpeg"):
        raise ValueError(f"unsupported caps media type {media!r} "
                         "(video/x-raw or image/jpeg)")
    fields: Dict[str, str] = {}
    for part in parts[1:]:
        if not part.strip():
            continue
        if "=" not in part:
            raise ValueError(f"malformed caps field {part!r} in {caps!r}")
        k, v = part.split("=", 1)
        # gst-launch type annotations: width=(int)640, format=(string)YUY2
        if v.startswith("(") and ")" in v:
            v = v.split(")", 1)[1]
        fields[k.strip()] = v.strip()
    return media, fields


def _parse_fraction(value: str) -> int:
    """``60/1`` or ``60`` → frames per second (integer part)."""
    if "/" in value:
        num, den = value.split("/", 1)
        return max(1, round(int(num) / max(1, int(den))))
    return int(value)


def _split_segment(seg: str) -> Tuple[str, Dict[str, str]]:
    """One ``!``-separated segment → (element-or-caps, properties)."""
    tokens = shlex.split(seg)
    if not tokens:
        raise ValueError("empty pipeline segment (doubled '!'?)")
    name = tokens[0]
    props: Dict[str, str] = {}
    for tok in tokens[1:]:
        if "=" not in tok:
            raise ValueError(f"malformed property {tok!r} for element "
                             f"{name!r} (expected key=value)")
        k, v = tok.split("=", 1)
        props[k] = v.strip('"')
    return name, props


def _apply_caps(spec: PipelineSpec, media: str, fields: Dict[str, str],
                after_scaler: bool) -> None:
    """Caps before the scaler set capture geometry; after it, display."""
    if media == "image/jpeg":
        if after_scaler:
            raise ValueError("image/jpeg caps only select a capture mode "
                             "(before the scaler)")
        if spec.fmt_from_caps:
            raise ValueError("image/jpeg caps must be the capture caps "
                             "(first format-bearing segment)")
        # v4l2src in MJPEG compressed mode; frames decode to RGB before
        # the device preprocess (media/source.py::V4L2Source pixfmt).
        spec.v4l2_pixfmt = "mjpeg"
        spec.fmt = "rgb"
        spec.fmt_from_caps = True
    if "format" in fields:
        fmt = fields["format"]
        if fmt not in _FORMAT_MAP:
            raise ValueError(f"unsupported caps format {fmt!r} "
                             f"(supported: {sorted(_FORMAT_MAP)})")
        if after_scaler:
            spec.notes.append(f"display caps format {fmt} noted (display "
                              "path is RGB on-device)")
        elif spec.fmt_from_caps:
            # Caps after the capture caps describe converted intermediate
            # layouts (the reference's post-videoconvert RGB probe view,
            # pipeline_ir.rs:46-55); ingest keeps the CAPTURE format —
            # conversion is fused into the on-device preprocess here.
            spec.notes.append(f"intermediate caps format {fmt} noted "
                              "(conversion is fused on-device; ingest "
                              f"stays {spec.fmt})")
        else:
            spec.fmt = _FORMAT_MAP[fmt]
            spec.fmt_from_caps = True
    if after_scaler:
        if "width" in fields:
            spec.display_width = int(fields["width"])
        if "height" in fields:
            spec.display_height = int(fields["height"])
    else:
        if "width" in fields:
            spec.width = int(fields["width"])
        if "height" in fields:
            spec.height = int(fields["height"])
        if "framerate" in fields:
            spec.fps = _parse_fraction(fields["framerate"])


def parse_launch(description: str) -> PipelineSpec:
    """Parse a gst-launch-1.0 pipeline description into a PipelineSpec.

    Mirrors the element semantics of the reference pipeline constructors
    (reference pipeline_ir.rs:13-87, pipeline.rs:13-53).
    Raises ValueError on anything that cannot be mapped faithfully.
    """
    segments = [s.strip() for s in description.split("!")]
    if not any(segments):
        raise ValueError("empty pipeline description")

    spec = PipelineSpec()
    saw_source = False
    after_scaler = False
    pending_record = False   # saw y4menc/encoder; next filesink records

    for seg in segments:
        name, props = _split_segment(seg)

        if "/" in name:                       # bare caps segment
            _apply_caps(spec, *_parse_caps(name), after_scaler)
            continue

        if name == "capsfilter":
            if "caps" not in props:
                raise ValueError("capsfilter without caps= property")
            _apply_caps(spec, *_parse_caps(props["caps"]), after_scaler)
            continue

        if name in ("v4l2src", "videotestsrc", "filesrc", "souphttpsrc"):
            if saw_source:
                raise ValueError("multiple sources in one pipeline "
                                 "(tee/compositor topologies unsupported)")
            saw_source = True
            if name == "v4l2src":
                spec.source = "v4l2"
                spec.device = props.get("device", spec.device)
                for k in ("io-mode", "do-timestamp"):   # accepted, moot:
                    if k in props:                      # ingest is h2d DMA
                        spec.notes.append(f"v4l2src {k}={props[k]} noted")
            elif name == "videotestsrc":
                spec.source = "synthetic"
            elif name == "souphttpsrc":
                # MJPEG network camera: souphttpsrc ! multipartdemux !
                # jpegdec — media/mjpeg.py::MJPEGSource plays the whole
                # chain (transport + demux + decode).
                spec.source = "mjpeg"
                if "location" not in props:
                    raise ValueError("souphttpsrc requires location=")
                spec.input_path = props["location"]
            else:
                spec.source = "file"
                if "location" not in props:
                    raise ValueError("filesrc requires location=")
                spec.input_path = props["location"]
            continue

        if name in _NOOP_ELEMENTS:
            continue

        if name == "identity":
            spec.has_probe = True
            continue

        if name in ("rgaconvert", "videoscale"):
            after_scaler = True
            continue

        if name == "queue":
            if "max-size-buffers" in props:
                spec.queue_buffers = int(props["max-size-buffers"])
            leaky = props.get("leaky", "downstream")
            spec.queue_leaky = leaky in ("downstream", "2", "upstream", "1")
            continue

        if name == "y4menc" or name.endswith("mux") or name.endswith("enc"):
            pending_record = True
            continue

        if name in _SINK_ELEMENTS:
            if name == "filesink":
                if "location" not in props:
                    raise ValueError("filesink requires location=")
                spec.record_path = props["location"]
                pending_record = False
            elif name in ("fakesink", "appsink"):
                pass                                    # NullSink
            else:                                       # live video sink
                spec.display = True
                spec.sink_props.update(props)
            continue

        raise ValueError(
            f"unsupported element {name!r} — supported: v4l2src, "
            "videotestsrc, filesrc, souphttpsrc, capsfilter / bare caps, "
            "videoconvert, decodebin, multipartdemux, jpegdec, identity, "
            "rgaconvert, videoscale, queue, y4menc, filesink, kmssink, "
            "autovideosink, fakesink, appsink")

    if not saw_source:
        raise ValueError("pipeline has no source element")
    if pending_record:
        raise ValueError("encoder without a following filesink location=")
    return spec


def apply_to_args(spec: PipelineSpec, args) -> None:
    """Overlay a parsed pipeline onto an app argparse namespace.

    Explicit CLI flags for the same knobs are overridden — the pipeline
    string is the single source of truth when given, exactly as a
    gst-launch line is in the reference.
    """
    args.source = spec.source
    args.device = spec.device
    if hasattr(args, "v4l2_pixfmt"):
        args.v4l2_pixfmt = spec.v4l2_pixfmt
    if spec.input_path:
        args.input = spec.input_path
    args.fmt = spec.fmt
    args.width = spec.width
    args.height = spec.height
    args.fps = spec.fps
    if spec.record_path:
        args.record = spec.record_path
    if spec.display and spec.display_width:
        args.display_scale = True
    if spec.display and getattr(args, "preview", -1) < 0:
        # A live video sink (kmssink/autovideosink) means "show it": the
        # accelerator host's display plane is the MJPEG preview server
        # (media/sink.py::MJPEGSink); port 0 binds ephemerally and the
        # app prints the URL.
        args.preview = 0
    if not spec.has_probe:
        spec.notes.append("no identity element: the tracker taps frames "
                          "at the loop head regardless (the probe point "
                          "is implicit in this framework)")


if __name__ == "__main__":   # pragma: no cover - debugging aid
    import sys

    print(parse_launch(" ".join(sys.argv[1:])))
