"""PyTorch/CUDA port of gstreamer_vit_tracker_tpu for NVIDIA Hopper (H100).

The JAX package ``gstreamer_vit_tracker_tpu`` is the reference; this
package keeps its module names so each counterpart is easy to find, and
imports nothing of it.  Plain tensor code is PyTorch; the TPU's Pallas
kernels become CUDA kernels written by hand (``csrc/``), each with a plain
PyTorch twin that the CPU runs and the tests compare against.

This slice covers the single-object NV12 tracking step on the flagship
``vittrack-t`` model: ``tracker.core.init`` / ``update`` / ``update_packed``
and ``entry.entry``.
"""

from .config import PRESETS, ModelConfig

__all__ = ["ModelConfig", "PRESETS"]
