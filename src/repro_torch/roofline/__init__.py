"""The roofline of a PyTorch program: its FLOPs, HBM bytes and collective
bytes, and the least time the card could take for them
(``roofline.analysis``)."""
