# SPDX-License-Identifier: Apache-2.0
"""Mixture-of-Experts layers: stacked expert weights, dense or quantized, and
GShard-style capacity routing.

Mirrors `hqq_tpu.nn.moe`. Expert weights stack on a leading E axis
(`GroupedLinear` [E, out, in]; `GroupedQuantLinear` the canonical `QTensor`
fields with a leading E), so an expert layer is one batched product, not a
loop over experts. Routing (`moe_dispatch`) builds one-hot dispatch and
combine tensors of a static capacity: the shapes depend on the token count
alone, nothing is read back from the device, and a decode step that holds
an MoE block can be captured as a CUDA graph. With ``capacity_factor`` at
E / top_k or more no assignment is dropped.

`GroupedQuantLinear` computes what `hqq_tpu`'s does (every W_e dequantized
to x's type as (c - zero) * scale in the meta type, products summed in
fp32), by the route `ops.fused_matmul.grouped_matmul_plan` picks from the
shapes: the grouped kernel (csrc/grouped_matmul.cu) for 4-bit axis=1 codes
at up to 32 rows an expert, which reads the packed codes and never writes
W; otherwise the stack dequantized in one launch (`dequant_canonical` over
the stack) and `torch.bmm`. On the CPU both routes are the plain twins.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.quantize import QTensor, quantize as _quantize
from ..ops.fused_matmul import dequant_canonical, grouped_matmul, grouped_plan_for

__all__ = ["GroupedLinear", "GroupedQuantLinear", "quantize_grouped", "quantize_experts",
           "moe_dispatch", "moe_capacity", "dispatch_tokens", "combine_experts", "route_tokens",
           "swiglu_moe", "refuse_expert_parallel", "stable_topk", "weighted_rows_sum"]


class GroupedLinear(nn.Module):
    """Stacked dense expert weights [E, out, in], an optional bias [E, out]."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    @property
    def n_experts(self) -> int:
        return self.weight.shape[0]

    @property
    def in_features(self) -> int:
        return self.weight.shape[2]

    @property
    def out_features(self) -> int:
        return self.weight.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [E, C, in] -> [E, C, out] in x's type, summed in fp32."""
        out = torch.bmm(x, self.weight.to(x.dtype).transpose(1, 2))
        if self.bias is not None:
            out = out + self.bias[:, None, :].to(out.dtype)
        return out


class GroupedQuantLinear(nn.Module):
    """Stacked quantized expert weights: ``wq`` [E, packed_rows, cols],
    ``scale`` and ``zero`` [E, groups, 1] (axis=1), the canonical `QTensor`
    fields of each expert with a leading E; ``shape`` is one expert's
    (out, in)."""

    def __init__(self, wq: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 nbits: float = 4, group_size: Optional[int] = 64, axis: int = 1,
                 shape: tuple = (), packing: Optional[str] = "4bit_u8",
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.wq, self.scale, self.zero = wq, scale, zero
        self.nbits, self.group_size, self.axis = nbits, group_size, axis
        self.shape, self.packing, self.compute_dtype = tuple(shape), packing, compute_dtype

    @property
    def n_experts(self) -> int:
        return self.wq.shape[0]

    @property
    def in_features(self) -> int:
        return self.shape[1]

    @property
    def out_features(self) -> int:
        return self.shape[0]

    def qtensor(self) -> QTensor:
        """The stack as one `QTensor` whose tensors carry the leading E
        (`ops.fused_matmul.stacked_experts`)."""
        return QTensor(wq=self.wq, scale=self.scale, zero=self.zero, nbits=self.nbits,
                       group_size=self.group_size, axis=self.axis, shape=self.shape,
                       packing=self.packing, compute_dtype=self.compute_dtype)

    def dequantize(self, dtype=None) -> torch.Tensor:
        """[E, out, in] in ``dtype`` (default the compute type): one launch
        of the canonical dequant kernel for the stack on the card."""
        return dequant_canonical(self.qtensor(), dtype or self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [E, C, in] -> [E, C, out] in x's type: the grouped kernel where
        its plan takes the shapes, else the dequantized stack and
        `torch.bmm` (fp32 sums either way)."""
        qt = self.qtensor()
        if grouped_plan_for(x, qt).route == "kernel":
            return grouped_matmul(x, qt)
        return torch.bmm(x, dequant_canonical(qt, x.dtype).transpose(1, 2))


def quantize_grouped(weights: torch.Tensor, nbits: float = 4, group_size: int = 64,
                     axis: int = 1, round_zero: Optional[bool] = None,
                     compute_dtype=torch.bfloat16) -> GroupedQuantLinear:
    """Quantize stacked expert weights [E, out, in], one expert at a time
    (`core.quantize.quantize`, HQQ's solver), into a `GroupedQuantLinear`."""
    round_zero = (nbits == 4) if round_zero is None else round_zero
    parts = [_quantize(weights[e], nbits=nbits, group_size=group_size, axis=axis,
                       round_zero=round_zero, compute_dtype=compute_dtype)
             for e in range(weights.shape[0])]
    qt0 = parts[0]
    return GroupedQuantLinear(
        torch.stack([p.wq for p in parts]), torch.stack([p.scale for p in parts]),
        torch.stack([p.zero for p in parts]), nbits=qt0.nbits, group_size=qt0.group_size,
        axis=qt0.axis, shape=qt0.shape, packing=qt0.packing, compute_dtype=compute_dtype)


def quantize_experts(experts: dict, names, expert_config: dict, compute_dtype) -> None:
    """Each dense stack ``experts[name]`` quantized in place
    (`quantize_grouped` with the config's nbits, group size, axis and
    round_zero); the dense weights are dropped as each is done: the MoE
    families' quantizers."""
    wqp = expert_config["weight_quant_params"]
    for name in names:
        gl = experts[name]
        if isinstance(gl, GroupedLinear):
            experts[name] = quantize_grouped(gl.weight.data, nbits=wqp["nbits"],
                                             group_size=wqp["group_size"], axis=wqp["axis"],
                                             round_zero=wqp["round_zero"],
                                             compute_dtype=compute_dtype)


def refuse_expert_parallel(cfg) -> None:
    """A config whose ``ep_axis`` is set asks for expert parallelism, which
    needs `parallel/` (the sharded expert stacks): not ported."""
    if getattr(cfg, "ep_axis", None) is not None:
        raise NotImplementedError(f"ep_axis={cfg.ep_axis!r}: expert parallelism needs "
                                  f"parallel/ (the sharded expert stacks), which is not ported")


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of x along its last dim and their indices,
    largest first, equal values lower index first: `jax.lax.top_k`'s order,
    which a stable descending sort gives and `torch.topk` does not promise
    on the card."""
    vals, idxs = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]


def weighted_rows_sum(rows: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k w[t, k] * rows[idx[t, k]] for rows [R, D], idx and w [T, K]:
    [T, D] in fp32, each token's terms summed in its own k order."""
    return (w[..., None] * rows[idx].to(torch.float32)).sum(1)


def moe_capacity(tokens: int, top_k: int, experts: int, capacity_factor: float) -> int:
    """Slots an expert holds for ``tokens`` tokens: ceil(tokens * top_k /
    experts * capacity_factor), at least 1, a Python int from the shapes."""
    return max(int(-(-(tokens * top_k / experts * capacity_factor) // 1)), 1)


def moe_dispatch(router_probs: torch.Tensor, top_k: int,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style dispatch and combine tensors from router probabilities
    [T, E] (already softmaxed), as `hqq_tpu`'s:

      dispatch [T, E, C] bool: token t occupies slot c of expert e
      combine  [T, E, C] fp32: the routing weight at that slot

    The top-k of each token, equal probabilities taken lower expert first
    (`stable_topk`), the kept weights renormalized by
    max(sum, 1e-9); each (token, k) assignment's place in its expert's queue
    by a cumsum over the token-major flattened assignments; assignments past
    ``capacity`` are dropped."""
    t, e = router_probs.shape
    vals, idxs = stable_topk(router_probs, top_k)  # [T, K]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)

    experts = torch.arange(e, device=router_probs.device)
    a = (idxs.reshape(t * top_k)[:, None] == experts).to(torch.int32)  # [TK, E]
    pos = ((torch.cumsum(a, dim=0, dtype=torch.int32) - 1) * a).sum(-1).reshape(t, top_k)
    keep = pos < capacity

    slots = torch.arange(capacity, device=router_probs.device)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.bool, device=router_probs.device)
    combine = torch.zeros((t, e, capacity), dtype=torch.float32, device=router_probs.device)
    for k in range(top_k):
        e_oh = idxs[:, k, None] == experts  # [T, E]
        c_oh = pos[:, k].clamp(0, capacity - 1)[:, None] == slots  # [T, C]
        d_k = e_oh[:, :, None] & c_oh[:, None, :] & keep[:, k, None, None]
        dispatch = dispatch | d_k
        combine = combine + d_k.to(torch.float32) * vals[:, k, None, None]
    return dispatch, combine


def dispatch_tokens(dispatch: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """The experts' inputs [E, C, D] from tokens xf [T, D]: each slot the
    token it holds, zeros where it holds none (``einsum tec,td->ecd``)."""
    return torch.einsum("tec,td->ecd", dispatch.to(xf.dtype), xf)


def combine_experts(combine: torch.Tensor, expert_out: torch.Tensor,
                    top_k: int) -> torch.Tensor:
    """Each token's weighted sum of its experts' outputs, [T, D] in fp32:
    `hqq_tpu`'s ``einsum tec,ecd->td``, summed over the token's own
    ``top_k`` largest combine entries (ties to the lower expert and slot),
    each its weight times its slot's output, in that order. A token's sum
    so reads its own entries only and does not move with the slots its
    neighbours took: a GEMM over all E x C slots rounds by where the
    token's slots lie in its k order (on the card, a request's ids then
    depended on the requests batched beside it)."""
    t, e, c = combine.shape
    w, slot = stable_topk(combine.reshape(t, e * c), top_k)
    return weighted_rows_sum(expert_out.reshape(e * c, -1), slot, w)


def route_tokens(router, xf: torch.Tensor, top_k: int,
                 capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routing step of every MoE family: the router's softmax over
    tokens xf [T, D] in fp32, `moe_dispatch` at `moe_capacity`; returns the
    combine tensor [T, E, C] and the experts' inputs [E, C, D]."""
    probs = torch.softmax(router(xf).to(torch.float32), dim=-1)
    t, e = probs.shape
    dispatch, combine = moe_dispatch(probs, top_k, moe_capacity(t, top_k, e, capacity_factor))
    return combine, dispatch_tokens(dispatch, xf)


def swiglu_moe(block: dict, names: Tuple[str, str, str], x: torch.Tensor, top_k: int,
               capacity_factor: float) -> torch.Tensor:
    """x [B, T, D] -> [B, T, D] through the top-k routed experts of
    ``block`` (its router under "gate", the stacks under "experts"), each
    expert down(silu(gate(x)) * up(x)); ``names`` the gate, up and down
    stacks' keys (Mixtral's w1, w3, w2; Qwen3-MoE's gate/up/down_proj)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    combine, expert_in = route_tokens(block["gate"], xf, top_k, capacity_factor)
    gate, up, down = (block["experts"][n] for n in names)
    h = torch.nn.functional.silu(gate(expert_in)) * up(expert_in)  # [E, C, F]
    return combine_experts(combine, down(h), top_k).reshape(b, t, d).to(x.dtype)
