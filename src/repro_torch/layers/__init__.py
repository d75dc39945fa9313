"""Layers: dense, LayerNorm, transition and gated attention."""
