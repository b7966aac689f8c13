"""Tests of the benchmark harness (CPU, and card-only ones marked ``cuda``)."""
