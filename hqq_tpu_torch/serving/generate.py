# SPDX-License-Identifier: Apache-2.0
"""Generation: prefill, then the decode loop, eager or as a replayed CUDA
graph.

Mirrors `hqq_tpu.serving.generate`. The cache is sized to the next power of
two above prompt + new tokens, the prompt is right-padded to a power-of-two
bucket, and the first token comes from ``logits[:, t-1]``. Padded prompt
slots are written to the cache, but each is overwritten by a real token
before any query can attend to it.

The decode step is one function over static buffers: the `KVCache`, the
current tokens, the position (a 0-d device tensor), the EOS flags, a step
counter, the output [B, cache_len] and the sampling noise. ``compile_mode``
says how the loop runs it, as in `hqq_tpu`:

  * "full" (the default; `hqq_tpu` scans the whole loop in one XLA
    program): on the card the step is captured once per (B, cache_len) in
    a `torch.cuda.CUDAGraph` and replayed ``steps - 1`` times; each replay
    advances the position and the counter on the device, so the host reads
    the tokens back once, after the last replay. On the CPU the same step
    runs eagerly, the graph's plain twin. A capture that fails raises.
  * "partial": the same step called eagerly from a host loop; ``on_token``
    streaming forces it for the call, with the ids read back every step.

Only a captured graph keeps its buffers between calls (at most
`Generator.max_graphs` of them, the least recently used dropped first);
every other call allocates its cache and frees it when it returns. A graph
reads the parameters at the addresses it was captured on, so the kept
graphs are dropped, and the step captured anew, whenever a tensor of the
tree has been replaced, moved or reshaped or a setting of the tree changed.

Sampling draws its Gumbel noise for every step from the seeded generator
before the loop, so both modes give equal tokens for one seed.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models import llama

__all__ = ["Generator", "sample_token", "sample_token_batch", "next_power_of_2", "MAX_TOP_K"]


def next_power_of_2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    do_sample: bool,
    top_k: int,
    temperature: float,
    top_p: float = 1.0,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy, or top-k (with optional top-p) sampling by the Gumbel trick.

    ``gumbel`` is optional noise of shape [..., top_k]; without it the noise
    is drawn from ``generator``."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(temperature, 1e-5)
    vals, idxs = torch.topk(logits, top_k, dim=-1)
    if top_p < 1.0:
        # nucleus filter within the top-k candidates (sorted descending):
        # keep tokens whose CDF before them is below top_p; the first stays
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        vals = torch.where(keep, vals, torch.finfo(vals.dtype).min)
    if gumbel is None:
        gumbel = _gumbel(vals.shape, generator, vals.device, vals.dtype)
    choice = torch.argmax(vals + gumbel.to(vals.dtype), dim=-1)
    return torch.gather(idxs, -1, choice[..., None])[..., 0]


# width of the per-row sampler's top-k: requested values are clamped to it
MAX_TOP_K = 64


def _gumbel(shape, generator, device, dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def sample_token_batch(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    do_sample: torch.Tensor,
    top_k: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sampling with per-row parameters: every slot of a continuous batch
    carries its own request's.

    logits [S, V]; do_sample bool [S]; top_k int [S] (clamped to MAX_TOP_K);
    temperature and top_p float [S]. Greedy rows (do_sample False) are the
    argmax whatever the other parameters. ``gumbel`` is optional noise of
    shape [S, min(MAX_TOP_K, V)]; without it the noise is drawn from
    ``generator``."""
    greedy = torch.argmax(logits, dim=-1)
    lt = logits.to(torch.float32) / temperature.to(torch.float32).clamp_min(1e-5)[:, None]
    k_eff = min(MAX_TOP_K, logits.shape[-1])
    vals, idxs = torch.topk(lt, k_eff, dim=-1)  # sorted descending
    pos = torch.arange(k_eff, device=logits.device)[None, :]
    neg = torch.finfo(vals.dtype).min
    vals = torch.where(pos < top_k.clamp(1, k_eff)[:, None], vals, neg)
    # nucleus filter within the top-k candidates (the first always stays;
    # rows cut by top_k have probability ~0 and stay cut)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    vals = torch.where(keep, vals, neg)
    if gumbel is None:
        gumbel = _gumbel(vals.shape, generator, vals.device, vals.dtype)
    choice = torch.argmax(vals + gumbel.to(vals.dtype), dim=-1)
    sampled = torch.gather(idxs, -1, choice[:, None])[:, 0]
    return torch.where(do_sample, sampled, greedy)


def _fingerprint(tree: Any) -> list:
    """What a captured step bakes in of a parameter tree, in tree order: the
    address, shape, strides and type of every tensor, the type of every
    layer and every other setting. Equal fingerprints mean a replay reads
    the tree as a new capture would."""
    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append((node.data_ptr(), node.shape, node.stride(), node.dtype, node.device))
        elif isinstance(node, dict):
            for key, sub in node.items():
                out.append(key)
                walk(sub)
        elif isinstance(node, (list, tuple)):
            out.append(len(node))
            for sub in node:
                walk(sub)
        elif isinstance(node, torch.nn.Module):
            out.append(type(node))
            walk(node._parameters)
            walk(node._buffers)
            walk(node._modules)
            walk({k: v for k, v in vars(node).items() if not k.startswith("_")})
        elif dataclasses.is_dataclass(node):
            out.append(type(node))
            walk(vars(node))
        else:
            out.append(node)

    walk(tree)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``: never a view of a kept buffer, which the next
    step or call overwrites (on the CPU, ``.cpu()`` alone would be one)."""
    return t.to("cpu", copy=True).numpy()


def capture_graph(device, step: Callable[[], None]):
    """(graph, {"seconds": s, "launches": {wrapper: n}}) of ``step``, a call
    on static buffers that reads nothing on the host: one eager call on the
    side stream of the capture first (the kernels build and load at their
    first launch, and nothing of that may happen under capture), then the
    capture on that stream. It is PyTorch's one capture stream of the
    process: each new stream would get a cuBLAS workspace of its own, kept
    for the process's life. Every launch the step records counts once in
    its wrapper's count, as in an eager call. A capture that fails raises."""
    from ..ops import kernel_wrappers

    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        capture = torch.cuda.graph(graph)
    stream = capture.capture_stream
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        step()
    torch.cuda.current_stream(device).wait_stream(stream)
    before = {w.__name__: w.launches for w in kernel_wrappers()}
    with capture:
        step()
    torch.cuda.synchronize(device)
    return graph, {"seconds": time.perf_counter() - t0,
                   "launches": {w.__name__: w.launches - before[w.__name__]
                                for w in kernel_wrappers()
                                if w.launches != before[w.__name__]}}


class _GraphCache(OrderedDict):
    """Kept buffers with their captured graphs, by key, oldest use first.
    The graphs read the parameters at the addresses they were captured on,
    so `state` drops every one when the trees are not those they were
    captured on (`_fingerprint`)."""

    def __init__(self):
        super().__init__()
        self.tree: list = []  # `_fingerprint` of the trees the graphs read

    def state(self, key, trees, new_state: Callable, capture: Callable, max_graphs: int = 4):
        """The kept buffers of ``key``, or ``new_state()`` with its graph
        captured by ``capture(state)`` on first use (before the caller sets
        the buffers: the warm-up moves them); the least recently used is
        dropped when more than ``max_graphs`` would be kept."""
        tree = _fingerprint(trees)
        if tree != self.tree:
            self.clear()
            self.tree = tree
        st = self.pop(key, None)
        if st is None:
            while len(self) >= max_graphs:
                self.popitem(last=False)
            st = new_state()
            capture(st)
        self[key] = st
        return st

    def captures(self) -> dict:
        """{key: {"seconds": s, "launches": {wrapper: n}}} of each kept graph."""
        return {key: st.capture for key, st in self.items()}


class _DecodeState:
    """The static buffers of one (B, cache_len): the cache and the step's
    inputs and outputs, which a captured graph reads and writes in place,
    and the graph where one is captured."""

    def __init__(self, cfg, b: int, cache_len: int, cache_dtype, device, noise_width: int):
        self.cache = llama.cache_for(cfg)(cfg, b, cache_len, cache_dtype, device)
        self.tok = torch.zeros((b,), dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.done = torch.zeros((b,), dtype=torch.bool, device=device)
        self.counter = torch.zeros((), dtype=torch.long, device=device)  # output column
        self.out = torch.zeros((b, cache_len), dtype=torch.long, device=device)
        # Gumbel noise [cache_len, B, top_k] of every step (sampling only)
        self.noise = (torch.zeros((cache_len, b, noise_width), dtype=torch.float32, device=device)
                      if noise_width else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture: dict = {}  # seconds, and launches of each kernel wrapper


class Generator:
    """Prefill plus decode over the dense cache.

    forward_fn(params, tokens, cache, start_pos) -> (logits, cache) defaults
    to the Llama forward; any model with that signature works, whose
    ``start_pos`` may be a 0-d device tensor. ``batch_size`` is kept for
    `hqq_tpu`'s signature: as there, the batch is the prompt's. ``params``
    may be set anew between calls.
    """

    # decode graphs kept at once, each with its cache and buffers
    max_graphs = 4

    def __init__(
        self,
        params: Any,
        cfg: Any,
        max_new_tokens: int = 256,
        batch_size: int = 1,
        cache_len: Optional[int] = None,
        do_sample: bool = False,
        top_k: int = 20,
        temperature: float = 0.6,
        top_p: float = 1.0,
        eos_token_id: Optional[int] = None,
        compile_mode: str = "full",
        forward_fn: Optional[Callable] = None,
        cache_dtype=torch.bfloat16,
        device="cuda",
    ):
        if compile_mode not in ("full", "partial"):
            raise ValueError(f"compile_mode must be 'full' or 'partial', not {compile_mode!r}")
        self.params = params
        self.cfg = cfg
        self.max_new_tokens = max_new_tokens
        self.batch_size = batch_size
        self.cache_len = cache_len
        self.do_sample = do_sample
        self.top_k = top_k
        self.temperature = temperature
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.compile_mode = compile_mode
        self.cache_dtype = cache_dtype
        self.device = torch.device(device)
        self._forward = forward_fn or (
            lambda p, toks, cache, pos: llama.forward(p, cfg, toks, cache, pos)
        )
        self._graphs = _GraphCache()  # {(B, cache_len): _DecodeState}

    def captures(self) -> dict:
        """{(B, cache_len): {"seconds": s, "launches": {wrapper: n}}} of each
        kept decode graph: the kernel launches recorded into one step."""
        return self._graphs.captures()

    def release_graphs(self) -> None:
        """Drop the kept graphs with their caches and buffers."""
        self._graphs.clear()

    def _new_state(self, b: int, cache_len: int) -> _DecodeState:
        return _DecodeState(self.cfg, b, cache_len, self.cache_dtype, self.device,
                            self.top_k if self.do_sample else 0)

    def _graphed(self, steps: int, on_token: Optional[Callable]) -> bool:
        """Whether this call replays a decode graph: "full" on the card, with
        no streaming and a step to replay."""
        return (self.compile_mode == "full" and on_token is None and steps > 1
                and self.device.type == "cuda")

    def _graph_state(self, b: int, cache_len: int) -> _DecodeState:
        """The kept buffers of (b, cache_len) with their graph
        (`_GraphCache.state`)."""
        return self._graphs.state((b, cache_len), self.params,
                                  lambda: self._new_state(b, cache_len), self._capture,
                                  self.max_graphs)

    def _decode_step(self, st: _DecodeState) -> None:
        """One decode step on ``st``'s buffers, in place: the forward of the
        current tokens at ``pos``, the next token (noise row ``counter``),
        the EOS rule (a row that has emitted EOS keeps emitting it), and
        the token into output column ``counter``; pos and counter advance.
        Nothing is read on the host, so the step can be captured."""
        logits, _ = self._forward(self.params, st.tok[:, None], st.cache, st.pos)
        col = st.counter.view(1)
        gumbel = None if st.noise is None else st.noise.index_select(0, col)[0]
        nxt = sample_token(logits[:, -1], None, self.do_sample, self.top_k, self.temperature,
                           self.top_p, gumbel=gumbel)
        if self.eos_token_id is not None:
            nxt = torch.where(st.done, torch.full_like(nxt, self.eos_token_id), nxt)
            st.done.logical_or_(nxt == self.eos_token_id)
        st.tok.copy_(nxt)
        st.out.index_copy_(1, col, nxt[:, None])
        st.pos.add_(1)
        st.counter.add_(1)

    def _capture(self, st: _DecodeState) -> None:
        """Capture the decode step of ``st`` into ``st.graph``
        (`capture_graph`)."""
        st.graph, st.capture = capture_graph(self.device, lambda: self._decode_step(st))

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None, seed: int = 0,
                 on_token: Optional[Callable] = None) -> np.ndarray:
        """input_ids: [B, T] token ids (list, numpy or tensor). Returns the
        generated ids [B, <= max_new_tokens] (prompt not included) as a
        numpy array; with ``eos_token_id`` a batch of one ends at its first
        EOS. ``on_token(ids)`` is called with the ids [B] (numpy) of the
        first token and of every decode step, and forces "partial"."""
        input_ids = np.asarray(input_ids)
        if input_ids.ndim == 1:
            input_ids = input_ids[None]
        b, t = input_ids.shape
        steps = max_new_tokens or self.max_new_tokens
        dev = self.device
        cache_len = self.cache_len or next_power_of_2(t + steps + 1)
        t_pad = next_power_of_2(max(t, 2))
        if max(t_pad, t + steps - 1) > cache_len:
            raise ValueError(f"a prompt of {t} (padded to {t_pad}) and {steps} new tokens do "
                             f"not fit a cache of {cache_len}")
        graphed = self._graphed(steps, on_token)
        st = self._graph_state(b, cache_len) if graphed else self._new_state(b, cache_len)
        st.cache.k.zero_()
        st.cache.v.zero_()
        prompt = np.zeros((b, t_pad), np.int64)
        prompt[:, :t] = input_ids
        logits, _ = self._forward(self.params, torch.from_numpy(prompt).to(dev), st.cache, 0)
        if st.noise is not None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            st.noise.copy_(_gumbel(st.noise.shape, gen, dev, st.noise.dtype))
        first = sample_token(logits[:, t - 1], None, self.do_sample, self.top_k, self.temperature,
                             self.top_p, gumbel=None if st.noise is None else st.noise[0])
        st.tok.copy_(first)
        st.out[:, 0] = first
        st.pos.fill_(t)
        st.done.zero_()
        st.counter.fill_(1)
        if on_token is not None:
            on_token(_to_numpy(first))

        for _ in range(steps - 1):
            if graphed:
                st.graph.replay()
            else:
                self._decode_step(st)
                if on_token is not None:
                    on_token(_to_numpy(st.tok))
        out = _to_numpy(st.out[:, :steps])

        eos = self.eos_token_id
        if eos is not None and b == 1:
            idx = np.where(out[0] == eos)[0]
            return out[:, : idx[0] + 1] if len(idx) else out
        return out
