# SPDX-License-Identifier: Apache-2.0
"""Vision-language serving in hqq_tpu_torch against hqq_tpu: embeds
requests on both engines, M-RoPE on the dense engine, pixel_values at the
server. Mirrors tests/test_vl_serving.py on the port's engines.

hqq_tpu's tiny LLaVA (text 4-bit g32 in fp32) and Qwen2-VL (both towers
8-bit g16 in fp32), their trees carried across with params_from_numpy;
the prompt embeddings are hqq_tpu's (the towers have their own tests in
tests/test_torch_vl.py), so the engines' logic is what is compared.
hqq_tpu's runs happen once, in module fixtures.

* the dense engine serves three image requests on two slots with
  hqq_tpu's engine's greedy ids; different images give different ids;
* the paged engine with the prefix cache on serves two requests with the
  same tokens and different images, each with its own ids (hqq_tpu's),
  beside a text request, and no page is shared;
* embeddings of the wrong shape and embeds requests on an engine with a
  custom forward and no embeds forward are refused at add_request; fp32
  embeddings go into bf16 engines;
* Qwen2-VL through the dense engine with ``mrope_offsets``: the image
  request's ids equal hqq_tpu's `HQQVLModel.generate`, and a text request
  beside it hqq_tpu's engine's; the control with ``pos_offset`` 0 (plain
  RoPE at decode) parts the decode logits from hqq_tpu's;
* the server: `serve.main` on an hqq_tpu LLaVA checkpoint answers a
  ``pixel_values`` request (blocking and streamed) with the ids of the
  in-process engine on the embedder's rows and of `hqq_tpu.serve.main`;
  a wrong placeholder count, bad pixels and a server with no embedder are
  answered 400.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.engine.vl import HQQVLModel as JVL
from hqq_tpu.models import base as jbase
from hqq_tpu.models import llava as jllava
from hqq_tpu.models import qwen2_vl as jqwen
from hqq_tpu.serving.batching import ContinuousBatchingEngine as JDense
from hqq_tpu.serving.paged import PagedBatchingEngine as JPaged
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.models import qwen2_vl as tqwen
from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine as TDense
from hqq_tpu_torch.serving.paged import PagedBatchingEngine as TPaged
from hqq_tpu_torch.serving.server import InferenceServer
from hqq_tpu_torch.utils import params_from_numpy

_NEW = 6
_DENSE = dict(batch_slots=2, max_len=64)
_PAGED = dict(batch_slots=2, num_pages=32, page_size=4, max_pages_per_seq=16)
_GRID = ((1, 4, 4),)  # 16 patches -> 4 merged rows


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _prompt(cfg, extra):
    return [5] + [cfg.image_token_index] * cfg.vision.num_patches + list(extra)


def _pixels(cfg, seed):
    vc = cfg.vision
    return np.random.default_rng(seed).standard_normal(
        (1, vc.num_channels, vc.image_size, vc.image_size)).astype(np.float32)


def _embeds(cfg, params, toks, seed):
    img = jllava.vision_forward(params, cfg, jnp.asarray(_pixels(cfg, seed)))
    emb = jllava.embed_multimodal(params, cfg, jnp.asarray([toks]),
                                  img.reshape(-1, cfg.text.hidden_size))
    return np.asarray(emb[0])


def _run(eng, requests):
    uids = [eng.add_request(toks, max_new_tokens=_NEW, **kw) for toks, kw in requests]
    out = eng.run()
    eng.close()
    return [out[u] for u in uids]


@pytest.fixture(scope="module")
def llava():
    """hqq_tpu's tiny LLaVA, its text 4-bit g32, the requests' embeddings,
    and hqq_tpu's engines on them."""
    cfg = jllava.LlavaConfig.tiny()
    params = jllava.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    params = {**params, "text": jbase.quantize_model(
        params["text"], JConfig(nbits=4, group_size=32), compute_dtype=jnp.float32)}
    dense_reqs = [(_prompt(cfg, [7 + i]), dict(inputs_embeds=_embeds(
        cfg, params, _prompt(cfg, [7 + i]), i))) for i in range(3)]
    toks = _prompt(cfg, [7])
    paged_reqs = [(toks, dict(inputs_embeds=_embeds(cfg, params, toks, s))) for s in (10, 11)]
    paged_reqs.append(([5, 9, 7], {}))
    ref = dict(
        dense=_run(JDense(params["text"], cfg.text, cache_dtype=jnp.float32, **_DENSE),
                   dense_reqs),
        paged=_run(JPaged(params["text"], cfg.text, cache_dtype=jnp.float32,
                          enable_prefix_cache=True, **_PAGED), paged_reqs))
    return cfg, params, dense_reqs, paged_reqs, ref


def test_dense_engine_serves_multimodal(llava):
    cfg, params, reqs, _, ref = llava
    assert len({tuple(ids) for ids in ref["dense"]}) > 1  # the images lead apart
    eng = TDense(_to_torch(params["text"]), tl.LlamaConfig(**vars(cfg.text)),
                 cache_dtype=torch.float32, device="cpu", **_DENSE)
    assert _run(eng, reqs) == ref["dense"]


def test_paged_engine_serves_multimodal_no_prefix_alias(llava):
    cfg, params, _, reqs, ref = llava
    assert ref["paged"][0] != ref["paged"][1]  # same tokens, different images
    eng = TPaged(_to_torch(params["text"]), tl.LlamaConfig(**vars(cfg.text)),
                 cache_dtype=torch.float32, enable_prefix_cache=True, device="cpu", **_PAGED)
    uids = [eng.add_request(toks, max_new_tokens=_NEW, **kw) for toks, kw in reqs]
    out = eng.run()
    assert [out[u] for u in uids] == ref["paged"]
    assert eng.prefix_cache_hits == 0  # embeds requests never touch the prefix cache
    # the text request registered its pages, and a second one reuses them
    eng.add_request([5, 9, 7, 1, 2, 3, 4, 8], max_new_tokens=2)
    eng.add_request([5, 9, 7, 1, 2, 3, 4, 8, 6], max_new_tokens=2)
    eng.run()
    assert eng.prefix_cache_hits > 0


def test_embeds_shape_and_dtype(llava):
    cfg, params, reqs, _, _ = llava
    tcfg = tl.LlamaConfig(**vars(cfg.text))
    tree = _to_torch(params["text"])
    eng = TDense(tree, tcfg, cache_dtype=torch.float32, device="cpu", **_DENSE)
    with pytest.raises(ValueError, match="inputs_embeds"):
        eng.add_request([1, 2, 3], max_new_tokens=4,
                        inputs_embeds=np.zeros((2, tcfg.hidden_size), np.float32))
    with pytest.raises(ValueError, match="inputs_embeds"):
        eng.add_request([1, 2, 3], max_new_tokens=4,
                        inputs_embeds=np.zeros((3, tcfg.hidden_size), np.int32))
    custom = TDense(tree, tcfg, device="cpu", forward_fn=lambda p, t, c, s: tl.forward(
        p, tcfg, t, c, s), **_DENSE)
    with pytest.raises(ValueError, match="embeds_forward_fn"):
        custom.add_request(*reqs[0][:1], max_new_tokens=4, **reqs[0][1])
    # fp32 embeddings into engines over a bf16 tree and bf16 caches
    bf16 = _to_torch(jbase.quantize_model(
        jllava.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.bfloat16)["text"],
        JConfig(nbits=4, group_size=32), compute_dtype=jnp.bfloat16))
    toks, kw = reqs[0]
    for eng in (TDense(bf16, tcfg, cache_dtype=torch.bfloat16, device="cpu", **_DENSE),
                TPaged(bf16, tcfg, cache_dtype=torch.bfloat16, device="cpu", **_PAGED)):
        uid = eng.add_request(toks, max_new_tokens=4, **kw)
        assert eng.queue[0].embeds.dtype == torch.float32
        assert len(eng.run()[uid]) == 4


@pytest.fixture(scope="module")
def qwen():
    """hqq_tpu's tiny Qwen2-VL (8-bit g16), one image request's embeddings
    and positions, `generate`'s ids and hqq_tpu's M-RoPE engine."""
    cfg = jqwen.Qwen2VLConfig.tiny()
    m = JVL(params=jqwen.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32),
            cfg=cfg).quantize_model(JConfig(nbits=8, group_size=16), compute_dtype=jnp.float32)
    patches = np.random.default_rng(0).standard_normal((16, cfg.vision.patch_dim)).astype(
        np.float32)
    toks = [5, 9] + [cfg.image_token_id] * 4 + [7]
    img = m.encode_images(jnp.asarray(patches), _GRID)
    emb = np.asarray(jqwen.embed_multimodal(m.params["text"], cfg, jnp.asarray([toks]), img)[0])
    pos = jqwen.get_mrope_positions(cfg, np.asarray(toks), _GRID)
    mp = int(pos.max()) + 1
    fwd, efwd = jqwen.serving_forward_fns(cfg)
    eng = JDense(m.params["text"], cfg.text, cache_dtype=jnp.float32, forward_fn=fwd,
                 embeds_forward_fn=efwd, mrope_offsets=True, **_DENSE)
    reqs = [(toks, dict(inputs_embeds=emb, position_ids=pos[:, 0], pos_offset=mp - len(toks))),
            ([5, 9, 7], {})]
    # hqq_tpu's logits of the first decode step after the image prompt
    cache = jqwen.init_cache(cfg.text, 1, 16, jnp.float32)
    logits, cache = jqwen.forward(m.params["text"], cfg, None, cache, 0,
                                  position_ids=jnp.asarray(pos), inputs_embeds=emb[None])
    nxt = int(jnp.argmax(logits[0, -1]))
    step, _ = jqwen.forward(m.params["text"], cfg, jnp.asarray([[nxt]]), cache, len(toks),
                            position_ids=jnp.full((3, 1, 1), mp))
    ref = dict(generate=m.generate(toks, pixel_values=jnp.asarray(patches), grid_thw=_GRID,
                                   max_new_tokens=_NEW),
               engine=_run(eng, reqs), step=np.asarray(step[0, -1]), nxt=nxt)
    return cfg, m, reqs, ref


def _t_qwen(m):
    tcfg = tqwen.Qwen2VLConfig.tiny()
    return tcfg, _to_torch(m.params["text"])


def test_qwen2_vl_through_dense_engine(qwen):
    cfg, m, reqs, ref = qwen
    tcfg, text = _t_qwen(m)
    fwd, efwd = tqwen.serving_forward_fns(tcfg)
    eng = TDense(text, tcfg.text, cache_dtype=torch.float32, forward_fn=fwd,
                 embeds_forward_fn=efwd, mrope_offsets=True, device="cpu", **_DENSE)
    got = _run(eng, reqs)
    assert got[0] == ref["generate"] == ref["engine"][0]
    assert got[1] == ref["engine"][1]  # the text request beside it: offset 0, plain RoPE


def test_pos_offset_zero_control(qwen):
    """The first decode step after the image prompt, through the serving
    forward at the request's offset: hqq_tpu's logits within 1e-5 of
    max|logit|; at offset 0 (plain RoPE from the cache length) they part."""
    cfg, m, reqs, ref = qwen
    tcfg, text = _t_qwen(m)
    toks, kw = reqs[0]
    fwd, efwd = tqwen.serving_forward_fns(tcfg)
    want = ref["step"]
    parted = {}
    for off in (kw["pos_offset"], 0):
        cache = tqwen.init_cache(tcfg.text, 1, 16, torch.float32, "cpu")
        _, cache = efwd(text, torch.tensor(kw["inputs_embeds"])[None], cache, 0,
                        torch.from_numpy(kw["position_ids"])[:, None])
        logits, _ = fwd(text, torch.tensor([[ref["nxt"]]]), cache, torch.tensor([len(toks)]),
                        torch.tensor([off]))
        parted[off] = np.abs(logits[0, -1].numpy() - want).max() / np.abs(want).max()
    assert kw["pos_offset"] != 0
    assert parted[kw["pos_offset"]] < 1e-5 < 1e-3 < parted[0], parted


def _post(port, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/generate", json.dumps(obj), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read().decode()
    if obj.get("stream") and resp.status == 200:
        events = [json.loads(line[6:]) for line in body.splitlines() if line.startswith("data: ")]
        return resp.status, events
    return resp.status, json.loads(body)


@pytest.fixture(scope="module")
def llava_checkpoint(tmp_path_factory):
    """A tiny LLaVA quantized (4-bit g32, fp32) and saved by hqq_tpu's
    `HQQVLModel`, with an image request and `hqq_tpu.serve.main`'s ids."""
    from hqq_tpu.serve import main as j_main

    cfg = jllava.LlavaConfig.tiny()
    p = jllava.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    m = JVL(params={"text": p["text"], "vision": {"vision": p["vision"],
                                                  "projector": p["projector"]}},
            cfg=cfg, model_type="llava").quantize_model(JConfig(nbits=4, group_size=32),
                                                        compute_dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("vl") / "llava")
    m.save_quantized(path)
    body = {"prompt_ids": _prompt(cfg, [7, 3]), "pixel_values": _pixels(cfg, 4).tolist(),
            "max_new_tokens": _NEW}
    srv = j_main(_SERVE_ARGS(path), serve=False).start()
    try:
        status, out = _post(srv.port, body)
    finally:
        srv.stop()
    assert status == 200
    return path, cfg, body, out["tokens"]


def _SERVE_ARGS(path):
    return ["--model", path, "--port", "0", "--slots", "2", "--num-pages", "32", "--page-size",
            "4", "--max-pages-per-seq", "16", "--horizon", "4"]


def test_server_serves_pixel_values(llava_checkpoint):
    from hqq_tpu_torch.serve import main as t_main

    path, cfg, body, ref = llava_checkpoint
    srv = t_main(_SERVE_ARGS(path) + ["--device", "cpu"], serve=False).start()
    try:
        status, out = _post(srv.port, body)
        assert status == 200 and out["tokens"] == ref
        status, events = _post(srv.port, dict(body, stream=True))
        assert status == 200 and events[-1]["done"] and events[-1]["tokens"] == ref
        # a wrong placeholder count, pixels of another size: 400, and the server serves on
        one_short = body["prompt_ids"][:1] + body["prompt_ids"][2:]  # 15 placeholders
        status, out = _post(srv.port, dict(body, prompt_ids=one_short))
        assert status == 400 and "placeholders" in out["error"]
        status, out = _post(srv.port, dict(body, pixel_values=[[[0.0] * 8] * 8] * 3))
        assert status == 400 and "pixel_values" in out["error"]
        status, out = _post(srv.port, body)
        assert status == 200 and out["tokens"] == ref
    finally:
        srv.stop()
    # the in-process engine (the loop thread has stopped) on the embedder's rows
    emb = srv.embedder(body["prompt_ids"], {"pixel_values": body["pixel_values"]})
    uid = srv.engine.add_request(body["prompt_ids"], max_new_tokens=_NEW, inputs_embeds=emb)
    assert srv.engine.run()[uid] == ref


def test_server_without_embedder_answers_400(llava):
    cfg, params, reqs, _, _ = llava
    eng = TDense(_to_torch(params["text"]), tl.LlamaConfig(**vars(cfg.text)),
                 cache_dtype=torch.float32, device="cpu", **_DENSE)
    srv = InferenceServer(eng, port=0).start()
    try:
        status, out = _post(srv.port, {"prompt_ids": reqs[0][0], "pixel_values": [[0.0]]})
        assert status == 400 and "embedder" in out["error"]
    finally:
        srv.stop()
