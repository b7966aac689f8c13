"""Entry points of the port that are scripts in the JAX package
(``scripts/``): ``train_synthetic`` and ``eval_tracking``, run as
``python -m gstreamer_vit_tracker_tpu_torch.scripts.<name>``."""
