"""The LM serving engine (``repro_torch.serving.engine``)."""
