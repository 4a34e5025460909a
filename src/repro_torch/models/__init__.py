"""repro_torch.models — the ported model families (port of
`repro.models`): Mamba2 (`mamba2`), the zamba2 hybrid (`zamba2`) and the
dense transformer (`transformer`) over the shared `layers`, behind the
family-dispatched `api`."""
