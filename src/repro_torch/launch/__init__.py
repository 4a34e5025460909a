"""Launchers of the PyTorch/CUDA port (port of `repro.launch`)."""
