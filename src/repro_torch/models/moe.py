"""Mixture-of-Experts FFN with token-choice top-k routing (port of
`repro.models.moe`).

Sort-based capacity dispatch: the (token, choice) entries are sorted by
expert (stable), ranked within their expert, and the first C of each
expert are packed into an (E, C, D) buffer; the experts' SwiGLU is three
batched products over the expert axis (`torch.bmm`: the reference's
einsums run outside any Pallas kernel); the outputs are gathered back,
weighted by the router and summed over each token's K choices.

One token group: the reference's `runtime.MOE_DP_GROUPS` is set only by
its language-model dry run, which the port does not have (ROADMAP A11).

Two steps differ from the reference's code, each deterministic on a card:
- Dropped entries are not written.  The reference writes every dropped
  (token, choice) entry to slot (E-1, C-1) with value 0
  (`src/repro/models/moe.py:87-92`), so when expert E-1 itself overflows
  the kept token at its rank C-1 can lose its input, depending on the
  order of duplicate scatter writes (ROADMAP C5).  Here kept entries have
  distinct slots and the dropped ones go to a spare row that is cut off.
- The combine undoes the sort (every token has exactly K entries) and
  sums each token's K contributions in float32, rounded once to x's
  dtype; the reference's `segment_sum` adds in x's dtype (ROADMAP C2).  No
  atomic adds: the sum is the same in every run.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The router (float32, as in the reference) and the experts' SwiGLU
    weights, (E, D, F) and (E, F, D), in the parameter dtype."""
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = L.dtype_of(cfg)
    return {
        "router": L.dense_init(gen, D, E, torch.float32),
        "w_gate": L.normal(gen, (E, D, F), dt, 1.0 / math.sqrt(D)),
        "w_up": L.normal(gen, (E, D, F), dt, 1.0 / math.sqrt(D)),
        "w_down": L.normal(gen, (E, F, D), dt, 1.0 / math.sqrt(F)),
    }


def moe_shapes(cfg: ModelConfig) -> dict:
    """`init_moe`'s shapes, by name."""
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {"router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F),
            "w_down": (E, F, D)}


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert: ceil(n * K * capacity_factor / E), at least K."""
    cap = math.ceil(n_tokens * cfg.experts_per_tok * cfg.capacity_factor
                    / cfg.num_experts)
    return max(cap, cfg.experts_per_tok)


def route(p, cfg: ModelConfig, x2d: torch.Tensor):
    """Top-k routing.  x2d: (N, D) -> (expert_idx (N, K), weights (N, K)
    in x's dtype, aux loss).  The router's product and softmax in float32;
    the top-k weights normalised to sum 1; the Switch-style load-balancing
    loss over each token's first choice."""
    E = cfg.num_experts
    probs = torch.softmax(torch.matmul(x2d.float(), p["router"]), dim=-1)
    weights, expert_idx = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    density = torch.nn.functional.one_hot(expert_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(density * probs.mean(0))
    return expert_idx, weights.to(x2d.dtype), aux


class Dispatch(NamedTuple):
    """The capacity dispatch of N tokens' N * K (token, choice) entries,
    in expert order: `buf` (E, C, D) the experts' inputs; per sorted entry
    its slot (`slot_e`, `slot_c`: (E-1, C-1) where dropped, as in the
    reference), whether it is kept, its router weight, and `order`, its
    index in the flattened (N, K) entries (its token is order // K)."""

    buf: torch.Tensor
    slot_e: torch.Tensor
    slot_c: torch.Tensor
    keep: torch.Tensor
    order: torch.Tensor
    w_sorted: torch.Tensor


def dispatch(cfg: ModelConfig, x2d, expert_idx, weights, C: int) -> Dispatch:
    """Sort the entries by expert (stable, so each expert's entries keep
    token order), rank each within its expert (its position less the
    expert's first, `searchsorted`), keep ranks below C, and write the kept
    entries' tokens into their slots.  Nothing is read back to the host."""
    n, D = x2d.shape
    E = cfg.num_experts
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    ids = torch.arange(flat_e.numel(), device=x2d.device)
    start = torch.searchsorted(e_sorted, torch.arange(E, device=x2d.device),
                               side="left")
    rank = ids - start[e_sorted]
    keep = rank < C
    # kept entries have distinct rows e * C + rank; the dropped ones all go
    # to the spare row E * C, cut off below
    rows = torch.where(keep, e_sorted * C + rank, E * C)
    buf = x2d.new_zeros((E * C + 1, D))
    buf[rows] = x2d[torch.div(order, cfg.experts_per_tok,
                              rounding_mode="floor")]
    return Dispatch(buf[:E * C].view(E, C, D),
                    torch.where(keep, e_sorted, E - 1),
                    torch.where(keep, rank, C - 1), keep, order,
                    weights.reshape(-1)[order])


def experts(p, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its C slots: (E, C, D) -> (E, C, D)."""
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    return torch.bmm(L.silu(g) * u, p["w_down"])


def combine(d: Dispatch, out_buf: torch.Tensor, n: int, K: int,
            dtype) -> torch.Tensor:
    """Each token's weighted expert outputs summed over its K choices:
    (n, D) in `dtype`.  A dropped entry adds 0."""
    out = out_buf[d.slot_e, d.slot_c]
    contrib = torch.where(d.keep[:, None], out, 0) * d.w_sorted[:, None]
    per_choice = torch.empty_like(contrib)
    per_choice[d.order] = contrib                 # back to (token, choice)
    return per_choice.view(n, K, -1).sum(dim=1, dtype=torch.float32).to(dtype)


def moe_block(p, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, D) -> ((B, S, D), aux loss): route the B * S tokens,
    dispatch them at capacity `capacity(B * S)`, run the experts and
    combine."""
    B, S, D = x.shape
    n = B * S
    x2d = x.reshape(n, D)
    expert_idx, weights, aux = route(p, cfg, x2d)
    d = dispatch(cfg, x2d, expert_idx, weights, capacity(n, cfg))
    y = combine(d, experts(p, d.buf), n, cfg.experts_per_tok, x.dtype)
    return y.reshape(B, S, D), aux


def moe_flops_per_token(cfg: ModelConfig) -> int:
    """Active FFN FLOPs per token (forward): 3 products x top-k experts."""
    return 2 * 3 * cfg.d_model * cfg.moe_d_ff * cfg.experts_per_tok
