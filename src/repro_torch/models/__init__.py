"""Decoder LMs (``repro_torch.models.decoder``)."""
