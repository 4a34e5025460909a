"""repro_torch.kernels — the TB kernel (CUDA, `csrc/`), its plain version,
its drivers (`ops`) and the Listing-1 oracle (`ref`)."""
