"""Executable spec of OpenCV 5.0's ``cv2.TrackerVit`` pipeline, measured
to f32 precision — and the matched-crop mode that runs OUR model under it.

The reference app's tracker is OpenCV's VitTrack semantics around an
opaque NPU blob (reference main.rs:25, SURVEY.md §2.9).  cv2's
implementation is a closed binary in this environment, so every semantic
below was MEASURED, not read, using spy ONNX graphs driven through
``cv2.TrackerVit`` itself (the graph is ours to construct; its conf
output read back through ``getTrackingScore`` is a float32-exact probe).
The full pipeline, validated bit-exact — integer Rects AND scores — over
synthetic trajectories (tests/test_cv2_replica.py):

1. window side  ``sz = ceil(sqrt(w*h) * factor)``; factor 2.0 template /
   4.0 search (OSTrack ``sample_target`` lineage);
2. window origin ``x1 = floor(cx - sz/2 + 0.5)`` — round-HALF-UP, not
   banker's ``cvRound`` (distinguished by probing half-integer cases);
3. out-of-frame padding ``max(-x1, 0)`` / ``max(x2 - W, 0)``, zero-fill
   (no OSTrack ``+1`` pad quirk);
4. uint8 crop -> ``cv2.resize`` INTER_LINEAR (fixed-point u8 path —
   resizing in float does NOT reproduce it);
5. blob ``blob_c = SLOPE_c * (x_c/255 - mean_c)`` with NO channel swap,
   SLOPE = (+1.4943686, -1.4617397, -1.4682663): zero-crossings land
   exactly on the documented means, ch1/2 sign-flipped, and the
   magnitudes are near but NOT equal to 1/sum(std) = 1.4749 (the round-3
   model; 0.5-1.3% off per channel — no closed form of mean/std fits,
   so the slopes are pinned empirically and re-measured at export time);
6. score penalty: the INTERIOR hann window ``sin^2(pi*(i+1)/17)`` outer
   product — NOT ``cv2.createHanningWindow((16,16))``: the measured peak
   is sin^4(9*pi/17) = 0.9830457, which is an 18-point hann cropped to
   its interior 16 cells.  (This is exactly this repo's default
   ``hann_mode="interior"`` — models/heads.py::hanning_2d — so the
   shipped decode is the reference-exact one; the "opencv" mode matches
   the ``createHanningWindow`` function, which TrackerVit turns out not
   to use.)
7. decode: ``argmax(conf * hann)`` (first index wins);
   ``cx = (ix + offset[0]) / 16`` etc.; box mapped back through the
   window as ``(x1 + cx*sz - w*sz/2, y1 + cy*sz - h*sz/2, w*sz, h*sz)``
   and TRUNCATED to int; that int Rect is both the API output and the
   next frame's window seed; ``getTrackingScore() = max(conf * hann)``.

The measurement helpers at the bottom re-derive 5-6 against the
*installed* cv2 (a few spy-tracker runs) — the export-time self-check
that a future cv2 with different blob semantics aborts the export
instead of shipping a silently mistracking graph.

Port of ``gstreamer_vit_tracker_tpu/compat/cv2vit.py``: the replica and
the measurement functions are the same cv2 + numpy code;
:class:`MatchedCropTracker` runs the port's model.  cv2 is imported only
inside the functions that use it, so nothing on the card's path needs it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import vittrack
from ..models.export_onnx import (CV2_50_BLOB_MEAN, CV2_50_BLOB_SLOPE,
                                  GraphBuilder)
from ..utils import graph

__all__ = [
    "CV2_50_HANN_PEAK", "Cv2VitReplica", "MatchedCropTracker",
    "blob_cv2_50", "hann_interior_np", "measure_cv2_convention",
    "sample_window", "verify_cv2_convention",
]

# Measured value of TrackerVit's internal penalty window at its peak
# cells: sin^4(9*pi/17) (see module docstring, item 6).
CV2_50_HANN_PEAK = float(np.sin(9 * np.pi / 17) ** 4)


def hann_interior_np(n: int = 16) -> np.ndarray:
    """The interior hann window cv2.TrackerVit multiplies into conf —
    identical to models/heads.py::hanning_2d(n, "interior") (gate-pinned
    in tests/test_cv2_replica.py), in float32 numpy."""
    w = np.sin(np.pi * (np.arange(n) + 1) / (n + 1)) ** 2
    return np.outer(w, w).astype(np.float32)


def _resize_u8_cv2(crop: np.ndarray, out: int) -> np.ndarray:
    import cv2

    return cv2.resize(crop, (out, out), interpolation=cv2.INTER_LINEAR)


def sample_window(im: np.ndarray, rect, factor: float, out_sz: int,
                  resize: Optional[Callable] = None
                  ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """cv2.TrackerVit's crop: integer window around ``rect`` -> zero-padded
    uint8 crop -> resize to ``out_sz``.  Returns (crop, (x1, y1, sz)).

    ``resize=None`` uses cv2's u8 INTER_LINEAR (bit-exact path; requires
    cv2); pass a callable ``(crop, out_sz) -> crop`` to substitute."""
    x, y, w, h = (float(v) for v in rect)
    sz = int(np.ceil(np.sqrt(max(w, 1.0) * max(h, 1.0)) * factor))
    x1 = int(np.floor(x + 0.5 * w - sz * 0.5 + 0.5))
    y1 = int(np.floor(y + 0.5 * h - sz * 0.5 + 0.5))
    x2, y2 = x1 + sz, y1 + sz
    x1p, y1p = max(0, -x1), max(0, -y1)
    x2p, y2p = max(x2 - im.shape[1], 0), max(y2 - im.shape[0], 0)
    inner = im[y1 + y1p:y2 - y2p, x1 + x1p:x2 - x2p]
    if x1p or y1p or x2p or y2p:
        crop = np.zeros((sz, sz) + im.shape[2:], im.dtype)
        crop[y1p:sz - y2p, x1p:sz - x2p] = inner
    else:
        crop = np.ascontiguousarray(inner)
    if resize is None:
        crop = _resize_u8_cv2(crop, out_sz)
    else:
        crop = resize(crop, out_sz)
    return crop, (x1, y1, sz)


def blob_cv2_50(crop: np.ndarray) -> np.ndarray:
    """The quirked blob cv2 5.0 feeds the net: (1, 3, H, W) float32."""
    x = crop.astype(np.float32) / np.float32(255.0)
    mean = np.asarray(CV2_50_BLOB_MEAN, np.float32)
    slope = np.asarray(CV2_50_BLOB_SLOPE, np.float32)
    return np.stack([(x[..., c] - mean[c]) * slope[c]
                     for c in range(3)])[None]


def _decode(conf: np.ndarray, size: np.ndarray, offset: np.ndarray,
            origin: Tuple[int, int, int], hann: np.ndarray):
    """cv2's decode: maps (16,16)/(2,16,16) + window -> (rect_f, score)."""
    x1, y1, sz = origin
    fs = conf.shape[-1]
    ch = conf * hann
    iy, ix = np.unravel_index(int(np.argmax(ch)), ch.shape)
    score = float(ch[iy, ix])
    cx = (ix + float(offset[0, iy, ix])) / fs * sz + x1
    cy = (iy + float(offset[1, iy, ix])) / fs * sz + y1
    w = float(size[0, iy, ix]) * sz
    h = float(size[1, iy, ix]) * sz
    return (cx - w / 2.0, cy - h / 2.0, w, h), score


class Cv2VitReplica:
    """Bit-exact Python replica of ``cv2.TrackerVit`` (OpenCV 5.0) driving
    an exported ONNX graph through ``cv2.dnn`` — same rects, same scores.
    The controlled baseline for the residual decomposition in
    docs/EXPORT.md (swap one stage at a time and measure)."""

    def __init__(self, net_path: str):
        import cv2

        self.net = cv2.dnn.readNetFromONNX(net_path)
        self.hann = hann_interior_np()
        self.rect: Tuple[int, int, int, int] = (0, 0, 0, 0)
        self.score = 0.0

    def init(self, frame: np.ndarray, bbox) -> None:
        crop, _ = sample_window(frame, bbox, 2.0, 128)
        self._z = blob_cv2_50(crop)
        self.rect = tuple(int(v) for v in bbox)

    def update(self, frame: np.ndarray) -> Tuple[int, int, int, int]:
        crop, origin = sample_window(frame, self.rect, 4.0, 256)
        self.net.setInput(self._z, "template")
        self.net.setInput(blob_cv2_50(crop), "search")
        conf, size, off = self.net.forward(["output1", "output2", "output3"])
        rect_f, self.score = _decode(conf[0, 0], size[0], off[0],
                                     origin, self.hann)
        self.rect = tuple(int(v) for v in rect_f)
        return self.rect


def _batch(crop: np.ndarray) -> np.ndarray:
    """A normalised (H, W, 3) crop as the (1, H, W, 3) float32 batch."""
    return np.ascontiguousarray(crop[None], dtype=np.float32)


@graph.compiled("cv2vit.embed", static=("cfg",))
def _embed(params, crop, cfg, device) -> torch.Tensor:
    """The template embed of :class:`MatchedCropTracker`, compiled."""
    return vittrack.embed_template(params, crop, cfg)


@graph.compiled("cv2vit.forward", static=("cfg",))
def _forward(params, z_tok, crop, cfg, device):
    """The f32 forward of :class:`MatchedCropTracker`, compiled: the plain
    per-block route (JAX's ``use_pallas=False, fused=False``)."""
    return vittrack.forward(params, z_tok, crop, cfg, use_kernel=False,
                            fused=False)


class MatchedCropTracker:
    """OUR model run under cv2.TrackerVit's exact pipeline — the
    matched-crop eval mode (VERDICT r3 item 1).

    The forward is the port's ``vittrack.forward`` in f32 (per-block
    encoder on the plain versions, as JAX's ``use_pallas=False``; standard
    normalisation — no blob quirk needed when we build the blob) on
    ``device``, where ``params`` lie; it and the template embed are
    compiled (:func:`_embed`, :func:`_forward`, JAX's two ``jax.jit`` s):
    the params are read in place and each crop is copied in.  Crop,
    decode and integer-Rect feedback are the measured cv2 semantics
    above.  Knobs
    ablate one stage at a time back toward the production tracker, for
    the residual decomposition:

    * ``window="float"``: production float crop (ops/preprocess.py
      CropWindow + bilinear resample products) instead of the integer
      Rect + u8 cv2.resize;
    * ``feedback="float"``: carry the float rect between frames instead
      of cv2's truncated ints (the output is still reported as cv2
      truncates it, so trajectories stay comparable).
    """

    def __init__(self, params, cfg, window: str = "int",
                 feedback: str = "int", device="cuda"):
        if cfg.dtype != "float32":
            raise ValueError("matched-crop mode is an f32 parity tool; "
                             "build the config with dtype='float32'")
        self.cfg = cfg
        self.params = params
        self.window = window
        self.feedback = feedback
        self.device = resolve_device(device)
        self.hann = hann_interior_np(cfg.feat_size)
        self.rect = (0.0, 0.0, 0.0, 0.0)
        self.score = 0.0

    # -- crops ---------------------------------------------------------------

    def _norm(self, crop_u8: np.ndarray) -> np.ndarray:
        x = crop_u8.astype(np.float32) / np.float32(255.0)
        m = np.asarray(self.cfg.norm_mean, np.float32)
        s = np.asarray(self.cfg.norm_std, np.float32)
        return (x - m) / s

    def _crop(self, frame: np.ndarray, rect, factor: float, out_sz: int):
        if self.window == "int":
            crop, origin = sample_window(frame, rect, factor, out_sz)
            return self._norm(crop), origin
        # Production float window + on-device bilinear resample
        # (ops/preprocess.py) — the crop-quantisation ablation.
        from ..ops import preprocess as pp

        dev = self.device
        win = pp.crop_window(torch.tensor(rect, dtype=torch.float32,
                                          device=dev), factor)
        crop = pp.preprocess_rgb(
            torch.as_tensor(frame, device=dev), win, out_sz,
            self.cfg.norm_mean, self.cfg.norm_std,
            dtype=torch.float32).cpu().numpy()
        cx, cy, sz = float(win.cx), float(win.cy), float(win.size)
        return crop, (cx - sz / 2.0, cy - sz / 2.0, sz)

    # -- cv2-shaped API --------------------------------------------------------

    def init(self, frame: np.ndarray, bbox) -> None:
        crop, _ = self._crop(frame, bbox, self.cfg.template_factor,
                             self.cfg.template_size)
        self._z_tok = _embed(self.params, _batch(crop), self.cfg,
                             self.device)
        self.rect = tuple(float(int(v)) for v in bbox)

    def update(self, frame: np.ndarray) -> Tuple[int, int, int, int]:
        crop, origin = self._crop(frame, self.rect, self.cfg.search_factor,
                                  self.cfg.search_size)
        maps = _forward(self.params, self._z_tok, _batch(crop), self.cfg,
                        self.device)
        conf = maps.score[0].float().cpu().numpy()
        size = maps.size[0].float().cpu().numpy().transpose(2, 0, 1)
        off = maps.offset[0].float().cpu().numpy().transpose(2, 0, 1)
        rect_f, self.score = _decode(conf, size, off, origin, self.hann)
        rect_i = tuple(int(v) for v in rect_f)
        self.rect = rect_i if self.feedback == "int" else rect_f
        return rect_i


# ---------------------------------------------------------------------------
# Spy-graph measurement of the installed cv2's convention
# ---------------------------------------------------------------------------

def _build_probe_graph(pool_chan: Optional[int]) -> bytes:
    """Spy ONNX with TrackerVit's IO contract.  ``pool_chan=None``: conf is
    a CONSTANT map with a unique peak at (8,8) -> score reads the internal
    hann peak.  ``pool_chan=c``: conf(8,8) encodes MaxPool(search blob
    channel c) affinely -> score reads the blob value of a flat frame."""
    g = GraphBuilder()
    z = g.input("template", [1, 3, 128, 128])
    x = g.input("search", [1, 3, 256, 256])

    def gpool(t, hw, op="AveragePool"):
        ch = g.node("Slice", [t, g.const_i64([0]), g.const_i64([1]),
                              g.const_i64([1])])
        return g.node(op, [ch], kernel_shape=[hw, hw], strides=[hw, hw],
                      pads=[0, 0, 0, 0])

    # Zero-weight consumption of both inputs keeps the engine from pruning
    # either graph input.
    zero = g.node("Mul", [g.node("Add", [gpool(z, 128), gpool(x, 256)]),
                          g.init(np.float32(0.0), "z0")])
    if pool_chan is None:
        conf_np = np.full((1, 1, 16, 16), 0.1, np.float32)
        conf_np[0, 0, 8, 8] = 0.8
        conf = g.node("Add", [g.init(conf_np, "conf"), zero],
                      out_names=["output1"])
    else:
        ch = g.node("Slice", [x, g.const_i64([pool_chan]),
                              g.const_i64([pool_chan + 1]), g.const_i64([1])])
        m = g.node("MaxPool", [ch], kernel_shape=[256, 256],
                   strides=[256, 256], pads=[0, 0, 0, 0])
        # conf(8,8) = 0.4 + 0.25*m  (m in [-1.6, 1.6] -> conf88 in (0, 0.8],
        # always above the 0.1 background so argmax stays at (8,8))
        scaled = g.node("Add", [g.node("Mul", [m, g.init(
            np.float32(0.25), "k")]), g.init(np.float32(0.4), "b")])
        mask = np.zeros((1, 1, 16, 16), np.float32)
        mask[0, 0, 8, 8] = 1.0
        base = np.full((1, 1, 16, 16), 0.1, np.float32)
        base[0, 0, 8, 8] = 0.0
        conf = g.node("Add", [g.node("Add", [g.node("Mul", [
            g.init(mask, "mask"), scaled]), g.init(base, "base")]), zero],
            out_names=["output1"])
    g.output("output1", [1, 1, 16, 16])
    for i, name in ((2, "output2"), (3, "output3")):
        c = np.full((1, 2, 16, 16), 0.4 if i == 2 else 0.5, np.float32)
        g.node("Add", [g.init(c, f"c{i}"), zero], out_names=[name])
        g.output(name, [1, 2, 16, 16])
    return g.build()


def _spy_score(graph: bytes, frame: np.ndarray, workdir: str) -> float:
    import cv2

    path = os.path.join(workdir, "spy.onnx")
    with open(path, "wb") as f:
        f.write(graph)
    p = cv2.TrackerVit_Params()
    p.net = path
    tr = cv2.TrackerVit_create(p)
    bb = (296, 232, 48, 48)   # 192-px search window fully inside 640x512
    tr.init(frame, bb)
    tr.update(frame)
    return float(tr.getTrackingScore())


def measure_cv2_convention(workdir: Optional[str] = None) -> dict:
    """Measure the installed cv2.TrackerVit's hann peak and per-channel
    blob affine (slope, crossing) with spy graphs.  ~7 tiny tracker runs.
    Returns {"hann_peak": float, "slope": [3], "crossing": [3]}."""
    own = workdir is None
    if own:
        tmp = tempfile.TemporaryDirectory()
        workdir = tmp.name
    try:
        h, w = 512, 640
        frame = np.full((h, w, 3), 100, np.uint8)
        hann_peak = _spy_score(_build_probe_graph(None), frame,
                               workdir) / 0.8
        slopes, crossings = [], []
        for c in range(3):
            graph = _build_probe_graph(c)
            vs = []
            for lv in (0, 255):
                f = np.zeros((h, w, 3), np.uint8)
                f[..., c] = lv
                score = _spy_score(graph, f, workdir)
                # score = (0.4 + 0.25*blob) * hann_peak
                vs.append((score / hann_peak - 0.4) / 0.25)
            a = vs[1] - vs[0]
            slopes.append(a)
            crossings.append(-vs[0] / a)
        return {"hann_peak": hann_peak, "slope": slopes,
                "crossing": crossings}
    finally:
        if own:
            tmp.cleanup()


def verify_cv2_convention(rtol: float = 2e-3) -> dict:
    """Export-time self-check (VERDICT r3 item 5): measure the installed
    cv2's convention and compare against the constants the cv2-5.0 export
    target bakes in.  Raises RuntimeError with BOTH conventions printed if
    they differ — a future cv2 that fixes (or re-breaks) its blob path
    aborts the export instead of shipping a silently mistracking graph."""
    got = measure_cv2_convention()
    want_slope = np.asarray(CV2_50_BLOB_SLOPE)
    want_cross = np.asarray(CV2_50_BLOB_MEAN)
    errs = []
    if abs(got["hann_peak"] - CV2_50_HANN_PEAK) > 1e-4:
        errs.append(f"hann peak {got['hann_peak']:.7f} != "
                    f"{CV2_50_HANN_PEAK:.7f}")
    for c in range(3):
        if abs(got["slope"][c] - want_slope[c]) > rtol * abs(want_slope[c]):
            errs.append(f"ch{c} slope {got['slope'][c]:+.5f} != "
                        f"{want_slope[c]:+.5f}")
        if abs(got["crossing"][c] - want_cross[c]) > 2e-3:
            errs.append(f"ch{c} crossing {got['crossing'][c]:.5f} != "
                        f"{want_cross[c]:.5f}")
    if errs:
        raise RuntimeError(
            "installed cv2.TrackerVit blob convention differs from the "
            "cv2-5.0 export target's baked compensation — exporting would "
            "ship a silently mistracking graph. Measured vs baked: "
            + "; ".join(errs))
    return got
