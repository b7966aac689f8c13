"""Ops: preprocess, attention, and the CUDA encoder kernel with its build."""
