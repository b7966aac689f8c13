"""Model configuration for the PyTorch/CUDA port.

A copy of ``gstreamer_vit_tracker_tpu/config.py::ModelConfig`` (every field
and property, same defaults) and of the two presets of
``gstreamer_vit_tracker_tpu/app/main.py::PRESETS`` that carry trained
weights.  The port keeps its own copy so that it imports nothing of the
JAX package; ``tests/test_torch_weights.py`` holds the two copies equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
    # Multi-object exclusive slots (batched tracking, a later slice).
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


PRESETS = {
    "small": ModelConfig(template_size=64, search_size=128, patch_size=16,
                         embed_dim=96, depth=4, num_heads=2, dtype="float32"),
    "vittrack-t": ModelConfig(),
}
