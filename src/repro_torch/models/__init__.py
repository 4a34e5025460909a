"""repro_torch.models — the ported model families (port of
`repro.models`): Mamba2 (`mamba2`), behind the family-dispatched `api`."""
