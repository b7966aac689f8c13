"""Training: losses, the optimisation step (float32) and synthetic data."""
