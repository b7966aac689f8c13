"""PyTorch/CUDA port of gstreamer_vit_tracker_tpu for NVIDIA Hopper (H100).

The JAX package ``gstreamer_vit_tracker_tpu`` is the reference; this
package keeps its module names so each counterpart is easy to find, and
imports nothing of it.  Plain tensor code is PyTorch; the TPU's Pallas
kernels become CUDA kernels written by hand (``csrc/``), each with a plain
PyTorch twin that the CPU runs and the tests compare against.

Ported: the tracker core and its batched and scanned forms, the serving
tier, float32 training, the tracker app (``app/main.py``, sessions, media,
HUD) with every preset of the JAX app (``corr-tiny``, ``small``,
``vittrack-t``), and the train-and-score loop: synthetic data, checkpoints,
the independent eval world, ONNX import and export, the cv2 replica, FLOP
accounting and the ``scripts.train_synthetic`` / ``scripts.eval_tracking``
entry points, ``parallel/`` (the data x model mesh on
``torch.distributed``, tensor-parallel blocks, multi-rank serving and
training, the multi-rank dry run) and every root script.  What is next is
listed in ROADMAP.md.
"""

from .config import PRESETS, AppConfig, ModelConfig

__all__ = ["AppConfig", "ModelConfig", "PRESETS"]
