"""Single-object tracker core and its state."""
