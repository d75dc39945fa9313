from repro_torch.exec.session import FastFold  # noqa: F401
