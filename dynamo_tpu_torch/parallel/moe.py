"""Routed MoE on one device: the router and the dropless dispatch
(counterpart of ``dynamo_tpu/parallel/moe.py``'s ``route_tokens`` and
``moe_mlp_dropless``).

The dispatch keeps static shapes and never reads the device back, so a MoE
step is captured in the runner's CUDA graph like any other: a stable sort of
the flat expert ids, group offsets ``int32[E+1]`` by ``searchsorted`` on the
device, the gather of token rows, three grouped products in the kernel of
``ops/grouped_matmul.py`` (the plain version on the CPU), the unsort and the
f32 weighted sum over the k choices, as in the JAX build.

Not ported: the capacity dispatch (``moe_mlp``, ``expert_capacity``,
``moe_drop_stats``, ``DROP_COUNTER``), which serves only an ``ep`` mesh
axis (ROADMAP A8), and quantized expert leaves (``maybe_dequant`` on 4-D
leaves, ROADMAP B6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.grouped_matmul import grouped_matmul


def route_tokens(
    lp: dict,
    x: torch.Tensor,  # [N, D] flattened tokens
    *,
    k: int,
    scoring: str = "softmax",
    norm_topk: bool = True,
    scaling: float = 1.0,
    n_group: int = 0,
    topk_group: int = 0,
    group_score: str = "max",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Router semantics shared by every MoE family; returns (weights f32[N,k],
    expert ids int64[N,k]), both ordered by descending choice score.

    - ``softmax`` scoring + ``norm_topk``: Mixtral, OLMoE, Qwen3-MoE.
    - ``softmax`` without norm: Qwen2-MoE, DeepSeek-V2.
    - ``sigmoid``: DeepSeek-V3. Selection uses the scores plus the aux-free
      bias ``router_bias`` (noaux_tc), optionally group-limited: experts
      split into ``n_group`` groups, only the best ``topk_group`` groups
      eligible. The weights use the unbiased scores, renormalized, then
      scaled by ``scaling``.
    - ``group_score``: how a group is ranked, DeepSeek-V2's per-group
      ``"max"`` or V3's ``"top2sum"`` of biased scores."""
    logits = (x @ lp["router"]).float()  # [N, E]
    if scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    elif scoring == "softmax":
        scores = torch.softmax(logits, dim=-1)
    else:
        raise ValueError(f"unknown moe scoring {scoring!r}")
    choice = scores + lp["router_bias"] if "router_bias" in lp else scores
    if n_group > 1 and 0 < topk_group < n_group:
        n, e = choice.shape
        grouped = choice.reshape(n, n_group, e // n_group)
        if group_score == "top2sum":
            gscore = grouped.topk(min(2, e // n_group), dim=-1).values.sum(-1)  # [N, G]
        else:
            gscore = grouped.amax(-1)
        gidx = gscore.topk(topk_group, dim=-1).indices
        gmask = torch.zeros_like(gscore, dtype=torch.bool).scatter(1, gidx, True)
        keep = gmask[:, :, None].expand(n, n_group, e // n_group).reshape(n, e)
        choice = torch.where(keep, choice, float("-inf"))
    topi = choice.topk(k, dim=-1).indices
    weights = scores.gather(1, topi)  # [N, k] unbiased
    if norm_topk:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * scaling, topi


def moe_mlp_dropless(
    lp: dict,
    x: torch.Tensor,  # [N, D] flattened tokens
    *,
    num_experts_per_token: int,
    routing: dict | None = None,
) -> torch.Tensor:
    """Dropless routed MoE FFN over flattened tokens; returns [N, D].

    ``lp`` holds one layer's ``router [D, E]``, ``w_gate/w_up [E, D, F]``
    and ``w_down [E, F, D]``. Token copies are stable-sorted by expert id,
    the expert FFNs run as grouped products over the per-expert row groups,
    and the results unsort back: no capacity, no drops, an output that does
    not depend on the batch's composition."""
    n, d = x.shape
    e = lp["router"].shape[-1]
    k = num_experts_per_token

    weights, topi = route_tokens(lp, x, k=k, **(routing or {}))

    flat_e = topi.reshape(-1)  # [N*k]; choice j of token t at t*k+j
    sorted_e, order = torch.sort(flat_e, stable=True)
    xk = x[order // k]  # [N*k, D] grouped by expert
    experts = torch.arange(e + 1, device=x.device, dtype=sorted_e.dtype)
    offsets = torch.searchsorted(sorted_e, experts, out_int32=True)  # [E+1]: rows of experts < e

    gate = F.silu(grouped_matmul(xk, lp["w_gate"], offsets))
    up = grouped_matmul(xk, lp["w_up"], offsets)
    down = grouped_matmul((gate * up).contiguous(), lp["w_down"], offsets)  # [N*k, D]

    rows = torch.empty_like(down).index_copy_(0, order, down)  # unsort
    out = (rows.float() * weights.reshape(-1, 1)).reshape(n, k, d).sum(dim=1)
    return out.to(x.dtype)
