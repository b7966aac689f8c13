"""Entry points of the port that are scripts in the JAX package
(``scripts/``): ``train_synthetic``, ``eval_tracking``, ``profile_scan``,
``profile_streams``, ``bench_serve``, ``soak``, ``export_vittrack_onnx``,
``import_vittrack_onnx`` and ``agreement_cv2``, each run as
``python -m gstreamer_vit_tracker_tpu_torch.scripts.<name>`` and callable as
``main(argv)``."""
