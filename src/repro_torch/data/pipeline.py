"""Deterministic, shardable synthetic data pipeline (port of
`repro.data.pipeline`).

`SyntheticLM` is the reference's, copied: a row is a pure function of
(step, global row) through numpy's counter-based Philox generator, so a
resumed run replays the same stream with no reader state to checkpoint,
and any data-parallel split partitions the same global batch.  The "text"
is an order-1 Markov process, x_{t+1} = (31 x_t + noise) mod vocab, so
the LM loss is learnable.

`make_batch` builds the reference's batch for every family in numpy, bit
for bit (the same tokens, labels and stub embeddings), and hands it to
the device as tensors in `models.api`'s layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import whisper


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _row(self, step: int, row: int) -> np.ndarray:
        """One global row, addressed by (step, global_row) — rank-agnostic,
        which is what makes re-sharding exact (elasticity)."""
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[step, row, 0, 0]))
        v = self.vocab_size
        toks = np.zeros(self.seq_len + 1, np.int64)
        toks[0] = rng.integers(0, v)
        noise = rng.integers(0, max(v // 16, 1), size=self.seq_len)
        # order-1 Markov stream: x_{t+1} = (31 * x_t + noise) % v
        for t in range(self.seq_len):
            toks[t + 1] = (31 * toks[t] + noise[t]) % v
        return toks

    def batch_at(self, step: int, dp_rank: int = 0, dp_size: int = 1):
        """{tokens, labels} (int32 numpy) for this data-parallel shard.
        Rows are addressed globally, so any dp_size partitions the SAME
        global batch."""
        if self.global_batch % dp_size:
            raise ValueError(f"global_batch={self.global_batch} must divide "
                             f"by dp_size={dp_size}")
        b = self.global_batch // dp_size
        rows = range(dp_rank * b, (dp_rank + 1) * b)
        toks = np.stack([self._row(step, r) for r in rows])
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


def make_batch(cfg, shape, step: int = 0, dp_rank: int = 0, dp_size: int = 1,
               reduced_batch: int | None = None, np_rng=None,
               device="cuda") -> dict:
    """The reference's concrete training batch (`models.api`'s layouts),
    as tensors on `device`: int32 tokens and labels, and for the vlm and
    encdec families the stub embeddings (drawn in float32 from
    `np_rng`, by default ``RandomState(step * 1000 + dp_rank)``, cast to
    the activation dtype on the device)."""
    dev = resolve_device(device)
    B = reduced_batch or shape.global_batch
    S = shape.seq_len
    rng = np_rng or np.random.RandomState(step * 1000 + dp_rank)
    act = L.act_dtype_of(cfg)

    def ints(a):
        return torch.from_numpy(a).to(dev)

    def embeds(a):
        return torch.from_numpy(a).to(dev).to(act)

    if cfg.family == "vlm":
        n_img = cfg.num_image_tokens
        base = SyntheticLM(cfg.vocab_size, S - n_img, B).batch_at(
            step, dp_rank, dp_size)
        img = rng.randn(B, n_img, cfg.d_model).astype(np.float32)
        labels = np.concatenate(
            [np.zeros((B, n_img), np.int32), base["labels"]], axis=1)
        return {"tokens": ints(base["tokens"]), "image_embeds": embeds(img),
                "labels": ints(labels)}
    if cfg.family == "encdec":
        Sd = whisper.dec_seq_len(S)
        base = SyntheticLM(cfg.vocab_size, Sd, B).batch_at(
            step, dp_rank, dp_size)
        frames = rng.randn(B, S, cfg.d_model).astype(np.float32)
        return {"frame_embeds": embeds(frames),
                "tokens": ints(base["tokens"]),
                "labels": ints(base["labels"])}
    base = SyntheticLM(cfg.vocab_size, S, B).batch_at(step, dp_rank, dp_size)
    return {"tokens": ints(base["tokens"]), "labels": ints(base["labels"])}


def rank_batch(cfg, shape, step: int, dp_rank: int, dp_size: int,
               device="cuda") -> dict:
    """The rows of data coordinate `dp_rank` (of `dp_size` along the
    mesh's data axis; not the process's rank: the ranks of one model axis
    share a coordinate and take the same rows) of the global batch of
    `shape`: rows [r * b, (r + 1) * b), b = global_batch / dp_size, so the
    data axis together trains on the one-process batch.  The text families build
    only their rows (`make_batch`'s dp split; rows are addressed
    globally); the vlm and encdec stub embeddings are drawn for the
    global batch from one seed (`make_batch`), so their rank takes its
    rows of it."""
    if shape.global_batch % dp_size:
        raise ValueError(f"global_batch={shape.global_batch} must divide "
                         f"by dp_size={dp_size}")
    if cfg.family not in ("vlm", "encdec") or dp_size == 1:
        return make_batch(cfg, shape, step=step, dp_rank=dp_rank,
                          dp_size=dp_size, device=device)
    b = shape.global_batch // dp_size
    full = make_batch(cfg, shape, step=step, device="cpu")
    return {k: v[dp_rank * b:(dp_rank + 1) * b].to(resolve_device(device))
            for k, v in full.items()}
