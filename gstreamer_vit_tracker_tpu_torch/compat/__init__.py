"""Cross-implementation compatibility layer: an executable, measured spec
of OpenCV 5.0's ``cv2.TrackerVit`` pipeline, plus the matched-crop mode
that runs the port's model under those exact semantics (the parity bridge
between this framework and the reference's model family, reference
main.rs:25).  Port of ``gstreamer_vit_tracker_tpu/compat``."""

from .cv2vit import (CV2_50_HANN_PEAK, Cv2VitReplica, MatchedCropTracker,
                     blob_cv2_50, hann_interior_np, measure_cv2_convention,
                     sample_window, verify_cv2_convention)

__all__ = [
    "CV2_50_HANN_PEAK", "Cv2VitReplica", "MatchedCropTracker",
    "blob_cv2_50", "hann_interior_np", "measure_cv2_convention",
    "sample_window", "verify_cv2_convention",
]
