"""repro_torch.kernels — the TB kernel (CUDA, `csrc/`), its plain version,
its drivers (`ops`) and the Listing-1 oracle (`ref`); the Mamba2 SSD scan
kernel (`ssd_scan`, CUDA `csrc/ssd_scan.cu`) and its naive oracle
(`ref.ssd_chunked_reference`)."""
