# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's HTTP server and one-command entry point.

CPU: `InferenceServer` over both of the port's engines (a fused
LlamaConfig.tiny() in fp32 on the CPU, localhost only): /generate returns
the ids the same engine gives in-process, for single and concurrent
requests; a stream's chunks concatenate to the blocking result; /healthz,
bad JSON, missing ids, a multimodal request and a refused request answer
as they should; a request that would fail inside a step (an id outside
the vocabulary, top_k 0) is answered 400 and the server serves on; /cancel ends a running stream with the tokens it has; a
step that raises is answered 500. `serve.main(["--device", "cpu", ...])`
on a checkpoint written by hqq_tpu's `save_quantized` gives the tokens of
`hqq_tpu.serve.main` on the same checkpoint (paged w4a8 fused, dense int8
fused with int8 pools; 4-bit g32 in fp32 from PRNGKey(0): equal greedy
ids, the bar of the other engine tests), and refuses a GPTQ checkpoint,
Aria and Qwen2-VL (both served through the Python API) and --tp 2. No module of hqq_tpu_torch, nor
chip_smoke.py, imports jax or hqq_tpu.

Card (marked ``cuda``; skips where torch sees no CUDA device; JAX is
imported only inside the CPU tests, so on the GPU:
``python -m pytest --noconftest -m cuda tests/test_torch_server.py``): the
server over the paged engine on the card (4-bit g32, w4a8, fused) returns
the in-process engine's ids, blocking and streamed.
"""

import ast
import http.client
import json
import os
import threading
import time

import pytest
import torch

from hqq_tpu_torch import BaseQuantizeConfig
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.models.base import quantize_model
from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine
from hqq_tpu_torch.serving.paged import PagedBatchingEngine
from hqq_tpu_torch.serving.server import InferenceServer
from hqq_tpu_torch.utils.patching import fuse_for_decode, prepare_for_inference

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENGINES = {
    "dense": (ContinuousBatchingEngine, dict(batch_slots=2, max_len=64, horizon=4)),
    "paged": (PagedBatchingEngine, dict(batch_slots=2, num_pages=40, page_size=8,
                                        max_pages_per_seq=8, horizon=4)),
}
_PROMPTS = [[3, 17, 29, 5], [9, 8, 7, 6, 5, 4, 3, 2, 1], [4, 4], [200, 100, 50, 25, 12]]


def _tree(device, quantize: bool):
    """LlamaConfig.tiny() in fp32, q/k/v and gate/up fused; with
    ``quantize`` 4-bit g32 on the w4a8 kernels."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator(device=device).manual_seed(0), torch.float32,
                            device)
    if quantize:
        quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=32),
                       compute_dtype=torch.float32)
        params = prepare_for_inference(params, "w4a8")
    return fuse_for_decode(params), cfg


def _engine(kind, tree, cfg, device="cpu"):
    cls, kw = _ENGINES[kind]
    return cls(tree, cfg, cache_dtype=torch.float32, device=device, **kw)


def _in_process(kind, tree, cfg, prompts, new, device="cpu"):
    eng = _engine(kind, tree, cfg, device)
    uids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    out = eng.run()
    eng.close()
    return [out[u] for u in uids]


@pytest.fixture(scope="module")
def model():
    # unquantized: the server's plumbing is under test here, and a quantized
    # tree would spend the CPU's time dequantizing (serve.main's test below
    # serves quantized trees)
    return _tree("cpu", quantize=False)


@pytest.fixture(scope="module", params=list(_ENGINES))
def server(request, model):
    srv = InferenceServer(_engine(request.param, *model), port=0).start()
    yield srv, request.param
    srv.stop()


def _post(port, path, obj, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, raw if raw is not None else json.dumps(obj),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _stream(port, obj, on_first=None):
    """The events of a streamed /generate; ``on_first(event)`` runs when
    the first one arrives."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/generate", json.dumps(dict(obj, stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
    events = []
    for line in resp:
        if line.startswith(b"data: "):
            events.append(json.loads(line[6:]))
            if len(events) == 1 and on_first is not None:
                on_first(events[0])
    return events


def test_generate_equals_the_engine(server, model):
    srv, kind = server
    status, out = _post(srv.port, "/generate", {"prompt_ids": _PROMPTS[0], "max_new_tokens": 6})
    assert status == 200 and set(out) == {"uid", "tokens"}
    assert out["tokens"] == _in_process(kind, *model, _PROMPTS[:1], 6)[0]


def test_concurrent_requests_equal_the_engine(server, model):
    """Requests that arrive together, in any order and mix, get the ids the
    engine gives them in-process: a request's ids do not depend on its
    neighbours."""
    srv, kind = server
    results = {}

    def call(i):
        results[i] = _post(srv.port, "/generate", {"prompt_ids": _PROMPTS[i],
                                                   "max_new_tokens": 7})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(_PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    ref = _in_process(kind, *model, _PROMPTS, 7)
    assert [results[i][0] for i in range(len(_PROMPTS))] == [200] * len(_PROMPTS)
    assert [results[i][1]["tokens"] for i in range(len(_PROMPTS))] == ref


def test_stream_equals_blocking(server):
    srv, _ = server
    _, ref = _post(srv.port, "/generate", {"prompt_ids": _PROMPTS[1], "max_new_tokens": 9})
    events = _stream(srv.port, {"prompt_ids": _PROMPTS[1], "max_new_tokens": 9})
    assert events[-1]["done"] and events[-1]["tokens"] == ref["tokens"]
    chunks = [t for e in events[:-1] for t in e["tokens"]]
    assert chunks == ref["tokens"] and len(events) >= 3  # the prefill's token, then horizons


def test_healthz_and_bad_requests(server):
    srv, _ = server
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    assert resp.status == 200 and json.loads(resp.read()) == {"ok": True, "active": 0,
                                                              "queued": 0}
    assert _post(srv.port, "/generate", None, raw="{not json")[0] == 400
    assert _post(srv.port, "/generate", {})[0] == 400  # no prompt_ids
    status, out = _post(srv.port, "/generate", {"prompt_ids": [1, 2], "pixel_values": [[0.0]]})
    assert status == 400 and "multimodal" in out["error"]
    status, out = _post(srv.port, "/generate", {"prompt_ids": [1, 2], "adapter_id": 1})
    assert status == 400 and "adapter_id" in out["error"]
    status, out = _post(srv.port, "/generate", {"prompt_ids": [1, 2], "stop": ["x"]})
    assert status == 400 and "tokenizer" in out["error"]
    assert _post(srv.port, "/nowhere", {})[0] == 404


_VOCAB = tl.LlamaConfig.tiny().vocab_size


@pytest.mark.parametrize("bad, what", [
    ({"prompt_ids": [3, _VOCAB]}, "prompt ids"),
    ({"prompt_ids": [-1, 3]}, "prompt ids"),
    ({"prompt_ids": [3, 1.5]}, "prompt ids"),
    ({"prompt_ids": [3, _VOCAB], "stream": True}, "prompt ids"),
    ({"prompt_ids": [3, 4], "do_sample": True, "top_k": 0}, "top_k"),
], ids=["id-vocab", "id-negative", "id-float", "id-vocab-stream", "top_k-0"])
def test_a_bad_request_is_refused_and_the_server_serves_on(server, model, bad, what):
    """A request that would fail inside a step (an id past the embedding
    table, a top_k that torch.topk refuses) is answered 400 before any
    step, and the next request gets the engine's ids."""
    srv, kind = server
    status, out = _post(srv.port, "/generate", dict(bad, max_new_tokens=3))
    assert status == 400 and what in out["error"]
    status, out = _post(srv.port, "/generate", {"prompt_ids": _PROMPTS[0], "max_new_tokens": 6})
    assert status == 200 and out["tokens"] == _in_process(kind, *model, _PROMPTS[:1], 6)[0]
    assert srv.error is None


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_engines_refuse_embeds_forward_fn(model, kind):
    """An engine with a custom forward_fn and no embeds_forward_fn refuses
    an embeds request at add_request (the Llama default would run another
    model); given an embeds_forward_fn it takes one."""
    cls, kw = _ENGINES[kind]
    tree, cfg = model
    emb = torch.zeros((3, cfg.hidden_size))
    eng = cls(tree, cfg, forward_fn=lambda *a, **k: None, device="cpu", **kw)
    with pytest.raises(ValueError, match="embeds_forward_fn"):
        eng.add_request([1, 2, 3], max_new_tokens=4, inputs_embeds=emb)
    eng = cls(tree, cfg, forward_fn=lambda *a, **k: None, embeds_forward_fn=lambda *a: None,
              device="cpu", **kw)
    eng.add_request([1, 2, 3], max_new_tokens=4, inputs_embeds=emb)
    assert len(eng.queue) == 1


def test_cancel_ends_a_stream_with_its_tokens(server):
    """/cancel after the first chunk: the stream ends with the tokens it
    had, fewer than asked; the engine is idle after it."""
    srv, _ = server
    step = srv.engine.step
    srv.engine.step = lambda: (time.sleep(0.02), step())[1]  # room to cancel in
    try:
        cancelled = []
        events = _stream(srv.port, {"prompt_ids": _PROMPTS[3], "max_new_tokens": 40},
                         on_first=lambda e: cancelled.append(
                             _post(srv.port, "/cancel", {"uid": e["uid"]})))
    finally:
        del srv.engine.step
    assert cancelled == [(200, {"cancelled": True})]
    assert events[-1]["done"] and 0 < len(events[-1]["tokens"]) < 40
    assert [t for e in events[:-1] for t in e["tokens"]] == events[-1]["tokens"]
    assert _post(srv.port, "/cancel", {"uid": events[-1]["uid"]})[1] == {"cancelled": False}
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    conn.request("GET", "/healthz")
    assert json.loads(conn.getresponse().read()) == {"ok": True, "active": 0, "queued": 0}


def test_a_failed_step_is_answered_500(model):
    eng = _engine("dense", *model)

    def broken():
        raise RuntimeError("the card went away")

    eng.step = broken
    srv = InferenceServer(eng, port=0).start()
    try:
        status, out = _post(srv.port, "/generate", {"prompt_ids": [1, 2], "max_new_tokens": 3})
        assert status == 500 and "the card went away" in out["error"]
        status, out = _post(srv.port, "/generate", {"prompt_ids": [1, 2], "stream": True})
        assert status == 500 and "went away" in out["error"]  # and every later request
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 500
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A 4-bit g32 fp32 checkpoint of LlamaConfig.tiny() written by
    hqq_tpu's `save_quantized`."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
    from hqq_tpu.engine.hf import HQQModel as JModel
    from hqq_tpu.models import llama as jl

    cfg = jl.LlamaConfig.tiny()
    model = JModel(params=jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32), cfg=cfg,
                   model_type="llama")
    model.quantize_model(JConfig(nbits=4, group_size=32), compute_dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("serve") / "ckpt")
    model.save_quantized(path)
    return path


def _serve_tokens(main, ckpt, extra):
    srv = main(["--model", ckpt, "--port", "0", "--slots", "2", "--num-pages", "40",
                "--page-size", "8", "--max-pages-per-seq", "8", "--max-len", "64",
                "--horizon", "4"] + extra, serve=False).start()
    try:
        return [_post(srv.port, "/generate", {"prompt_ids": p, "max_new_tokens": 6})[1]["tokens"]
                for p in _PROMPTS[:2]], srv
    finally:
        srv.stop()


@pytest.mark.parametrize("extra", [
    ["--engine", "paged", "--backend", "w4a8"],
    ["--engine", "dense", "--backend", "int8", "--int8-kv"],
], ids=["paged-w4a8", "dense-int8"])
def test_serve_main_matches_jax_on_its_checkpoint(jax_checkpoint, extra):
    from hqq_tpu.serve import main as j_main
    from hqq_tpu_torch.serve import main as t_main

    got, srv = _serve_tokens(t_main, jax_checkpoint, ["--device", "cpu"] + extra)
    ref, _ = _serve_tokens(j_main, jax_checkpoint, extra)
    assert got == ref and [len(t) for t in got] == [6, 6]
    engine = srv.engine
    assert type(engine).__name__ == {"paged": "PagedBatchingEngine",
                                     "dense": "ContinuousBatchingEngine"}[extra[1]]
    assert engine.device == torch.device("cpu")
    layer = engine.params["layers"][0]
    assert set(layer["self_attn"]) == {"qkv_proj", "o_proj"} and "gate_up_proj" in layer["mlp"]
    if extra[1] == "dense":
        assert engine.cache.quantized and engine.cache.k.dtype == torch.int8
    else:
        assert engine.cache.k.dtype == torch.float32  # the layers' compute dtype


def test_serve_refuses_what_is_not_ported(jax_checkpoint, tmp_path):
    from hqq_tpu_torch.serve import main as t_main

    with pytest.raises(NotImplementedError, match="parallel"):
        t_main(["--model", jax_checkpoint, "--device", "cpu", "--tp", "2"], serve=False)
    os.makedirs(tmp_path / "gptq")
    with open(tmp_path / "gptq" / "config.json", "w") as f:
        json.dump({"model_type": "llama", "quantization_config": {"quant_method": "gptq"}}, f)
    with pytest.raises(NotImplementedError, match="GPTQ"):
        t_main(["--model", str(tmp_path / "gptq"), "--device", "cpu"], serve=False)
    # Qwen2-VL and Aria serve through the Python API, and the CLI says so, as
    # hqq_tpu.serve does
    for name in ("qwen2_vl", "aria"):
        os.makedirs(tmp_path / name)
        with open(tmp_path / name / "config.json", "w") as f:
            json.dump({"model_type": name}, f)
        with pytest.raises(SystemExit, match="Python API"):
            t_main(["--model", str(tmp_path / name), "--device", "cpu"], serve=False)


def test_the_port_imports_no_jax():
    """Every module of the package, and chip_smoke.py, by its import
    statements: neither jax (nor jaxlib, flax) nor hqq_tpu."""
    banned = {"jax", "jaxlib", "flax", "hqq_tpu"}
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_ROOT, "hqq_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert any(f.endswith("serving/server.py") for f in files)
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, (path, names)


@pytest.mark.cuda
def test_server_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tree, cfg = _tree("cuda", quantize=True)
    srv = InferenceServer(_engine("paged", tree, cfg, "cuda"), port=0).start()
    try:
        ref = _in_process("paged", tree, cfg, _PROMPTS, 7, "cuda")
        got = [_post(srv.port, "/generate", {"prompt_ids": p, "max_new_tokens": 7})[1]["tokens"]
               for p in _PROMPTS]
        events = _stream(srv.port, {"prompt_ids": _PROMPTS[1], "max_new_tokens": 7})
    finally:
        srv.stop()
    assert got == ref
    assert events[-1]["tokens"] == ref[1] == [t for e in events[:-1] for t in e["tokens"]]
