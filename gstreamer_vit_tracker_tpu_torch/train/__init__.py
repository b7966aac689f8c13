"""Training: losses and the optimisation step (float32)."""
