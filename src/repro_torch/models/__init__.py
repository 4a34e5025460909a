"""repro_torch.models — the ported model families (port of
`repro.models`): Mamba2 (`mamba2`), the zamba2 hybrid (`zamba2`), the
dense and MoE transformer (`transformer`, `moe`), whisper's
encoder-decoder (`whisper`) and llava's VLM (`llava`) over the shared
`layers`, behind the family-dispatched `api`."""
