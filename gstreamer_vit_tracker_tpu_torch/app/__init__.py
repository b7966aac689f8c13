"""CLI application layer: keyboard control plane + interactive/headless entry."""
