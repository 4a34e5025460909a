from repro_torch.core.propagators import acoustic  # noqa: F401
