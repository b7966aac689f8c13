"""Model: weights, ViT backbone, heads, VitTrack forward."""
