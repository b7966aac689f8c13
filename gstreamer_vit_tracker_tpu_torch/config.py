"""Configuration for the PyTorch/CUDA port.

A copy of ``gstreamer_vit_tracker_tpu/config.py`` (``ModelConfig`` and the
capture, display, queue, session, telemetry and app configs: every field
and property, same defaults) and of the three presets of
``gstreamer_vit_tracker_tpu/app/main.py::PRESETS``.  The port keeps its own
copy so that it imports nothing of the JAX package;
``tests/test_torch_weights.py`` and ``tests/test_torch_app_config.py`` hold
the two copies equal.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    """Camera / frame-source geometry: the reference's active pipeline caps
    (YUY2 640x512@60, pipeline_ir.rs:27-41) and its legacy NV12 1080p
    pipeline (pipeline.rs:26-37)."""

    device: str = "/dev/video21"          # main.rs:32
    width: int = 640                       # pipeline_ir.rs:27
    height: int = 512                      # pipeline_ir.rs:28
    fps: int = 60                          # pipeline_ir.rs:39
    pixel_format: str = "RGB"              # format delivered to the tracker
    # Legacy pipeline variant (pipeline.rs:26-27)
    legacy_width: int = 1920
    legacy_height: int = 1080
    legacy_format: str = "NV12"


@dataclasses.dataclass(frozen=True)
class DisplayConfig:
    """Display sink geometry (reference pipeline_ir.rs:29-30, 64-84)."""

    width: int = 1280
    height: int = 1024
    connector_id: int = 231                # pipeline_ir.rs:82
    plane_id: int = 72                     # pipeline_ir.rs:83
    vsync: bool = False                    # kmssink sync=false (pipeline_ir.rs:81)


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    """Bounded, drop-oldest frame queue (pipeline_ir.rs:75-78:
    ``max-size-buffers=3, leaky=downstream``)."""

    max_buffers: int = 3
    leaky: str = "downstream"


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Tracking-session state machine constants.

    score_threshold   — accept/keep threshold (tracker_context.rs:93,122)
    lost_frames_max   — auto-reset counter bound; the reference resets when
                        the Lost counter *exceeds* 60, i.e. on the 62nd lost
                        frame (tracker_context.rs:144-151)
    min_bbox          — minimum selection box edge (selection_state.rs:42-43)
    cursor_step       — normal cursor step px (selection_state.rs:28)
    cursor_fast_step  — fast cursor step px (selection_state.rs:29)
    """

    score_threshold: float = 0.25
    lost_frames_max: int = 60
    min_bbox: int = 20
    cursor_step: int = 10
    cursor_fast_step: int = 50


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """VitTrack model hyper-parameters (OSTrack-style one-stream tracker:
    template and search crops are patch-embedded, concatenated, encoded by
    a pre-LN ViT, and the search tokens feed score/offset/size heads decoded
    with a hanning-window penalty).  See the JAX package's ModelConfig for
    the measurements behind each default."""

    template_size: int = 128        # template crop resolution (Hz = Wz)
    search_size: int = 256          # search crop resolution (Hx = Wx)
    patch_size: int = 16
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    template_factor: float = 2.0    # context amount around bbox for template
    search_factor: float = 4.0      # context amount around bbox for search
    head_mode: str = "conv"         # "conv" (learned) | "corr" (training-free)
    # Hanning-penalty formula for the decode: "interior" (cv2.TrackerVit's
    # window) or "opencv" (cv2.createHanningWindow).  models/heads.py.
    hann_mode: str = "interior"
    # Normalisation applied after /255 (ImageNet stats).
    norm_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    dtype: str = "bfloat16"         # compute dtype
    # Online template update.
    template_update_enabled: bool = False
    template_update_threshold: float = 0.7
    template_update_interval: int = 25
    # Blend weight kept on the *initial* template during an online update.
    template_update_anchor: float = 0.35
    # Static band (px) sliced around the crop window before the resample
    # matmuls (ops/preprocess.py::band_origin).  None disables banding.
    preprocess_band: Optional[int] = 1152
    # Below this confidence the tracker freezes its carried bbox.
    window_freeze_threshold: float = 0.25
    # Max per-frame relative size change of the tracked box (0 disables).
    size_rate_limit: float = 0.25
    # Below this confidence the box size holds while position updates.
    size_conf_freeze: float = 0.5
    # Re-detection ramp: the search-window factor grows by this per
    # consecutive low-confidence frame, capped at lost_window_max_growth.
    lost_window_growth: float = 1.12
    lost_window_max_growth: float = 4.0
    # Multi-object exclusive slots (tracker/multi.py).
    exclusive_overlap_threshold: float = 0.6

    @property
    def feat_size(self) -> int:
        """Side of the search feature map (e.g. 256/16 = 16)."""
        return self.search_size // self.patch_size

    @property
    def template_feat_size(self) -> int:
        return self.template_size // self.patch_size

    @property
    def num_template_tokens(self) -> int:
        return self.template_feat_size ** 2

    @property
    def num_search_tokens(self) -> int:
        return self.feat_size ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_template_tokens + self.num_search_tokens


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Rolling perf-stats window and print cadence (the reference's
    120-sample windows, timing_stats.rs:18-34; a print every 60 frames,
    pipeline_ir.rs:210)."""

    window: int = 120
    print_every: int = 60
    hud_enabled: bool = True


@dataclasses.dataclass(frozen=True)
class AppConfig:
    """Top-level application config bundling all subsystems."""

    capture: CaptureConfig = CaptureConfig()
    display: DisplayConfig = DisplayConfig()
    queue: QueueConfig = QueueConfig()
    session: SessionConfig = SessionConfig()
    model: ModelConfig = ModelConfig()
    telemetry: TelemetryConfig = TelemetryConfig()
    model_path: str = ""   # optional checkpoint to load (main.rs:25 analog)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "AppConfig":
        raw = json.loads(text)
        return AppConfig(
            capture=CaptureConfig(**raw.get("capture", {})),
            display=DisplayConfig(**raw.get("display", {})),
            queue=QueueConfig(**raw.get("queue", {})),
            session=SessionConfig(**raw.get("session", {})),
            model=ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in raw.get("model", {}).items()}),
            telemetry=TelemetryConfig(**raw.get("telemetry", {})),
            model_path=raw.get("model_path", ""),
        )

    def replace(self, **kwargs: Any) -> "AppConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT = AppConfig()

# The app's model presets.  corr-tiny is the training-free correlation
# tracker (depth 0: the encoder is the final LayerNorm alone); small and
# vittrack-t ship trained checkpoints (models/weights.py::CHECKPOINTS).
PRESETS = {
    "corr-tiny": ModelConfig(template_size=64, search_size=128, patch_size=8,
                             embed_dim=64, depth=0, num_heads=2,
                             head_mode="corr", dtype="float32"),
    "small": ModelConfig(template_size=64, search_size=128, patch_size=16,
                         embed_dim=96, depth=4, num_heads=2, dtype="float32"),
    "vittrack-t": ModelConfig(),
}
