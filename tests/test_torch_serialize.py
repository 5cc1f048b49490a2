# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch checkpoints against hqq_tpu's: the port's own safetensors
reader and writer against the ``safetensors`` package (every dtype, 0-d,
empty and non-contiguous tensors); `tree_to_state` against hqq_tpu's on the
same tiny Llama carried across (structure JSON, tensor names, dtypes,
shapes and bytes) over ten quantization configs; checkpoints written by
either package loaded by the other, tensors bit-equal and greedy tokens
equal (fp32 compute and cache); sharding at ``max_shard_bytes``; kernel
layouts and unknown nodes refused both ways."""

import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.peft import PeftUtils as JPeft
from hqq_tpu.core.peft import lora_config as j_lora_config
from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.engine.hf import HQQModel as JModel
from hqq_tpu.engine.hf import HQQModelForCausalLM as JForCausalLM
from hqq_tpu.models import llama as jl
from hqq_tpu.models import quantize_model as j_quantize_model
from hqq_tpu.models import serialize as js
from hqq_tpu.utils.patching import prepare_for_inference as j_prepare
from hqq_tpu_torch.engine.hf import HQQModel as TModel
from hqq_tpu_torch.engine.hf import HQQModelForCausalLM as TForCausalLM
from hqq_tpu_torch.models import _safetensors as tst
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.models import serialize as ts
from hqq_tpu_torch.utils import params_from_numpy, prepare_for_inference

_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16, "I32": torch.int32,
    "U32": torch.uint32, "I64": torch.int64, "BOOL": torch.bool,
}


def _bytes(x) -> bytes:
    """The raw C-order bytes of a torch tensor or a numpy/JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _tensor(dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    """Random values of ``dtype`` (raw bytes from a seed, NaN-free floats)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape)) if shape else 1
    if n == 0:
        return torch.empty(shape, dtype=dtype)
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal(n)).to(dtype).reshape(shape)
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, n).astype(bool)).reshape(shape)
    raw = rng.integers(0, 256, n * dtype.itemsize, dtype=np.uint8)
    return torch.from_numpy(raw).view(dtype).reshape(shape)


def _cases(dtype):
    """Tensors of one dtype: 2-d, 0-d, empty, and a non-contiguous view."""
    big = _tensor(dtype, (6, 10), 1)
    return {"m": _tensor(dtype, (3, 5), 0), "scalar": _tensor(dtype, (), 2),
            "empty": _tensor(dtype, (0, 4), 3), "strided": big[::2, 1::3]}


@pytest.mark.parametrize("code", list(_DTYPES))
def test_writer_read_by_safetensors(code, tmp_path):
    from safetensors.numpy import load_file

    tensors = _cases(_DTYPES[code])
    path = str(tmp_path / "w.safetensors")
    tst.save_file(tensors, path)
    got = load_file(path)
    assert sorted(got) == sorted(tensors)
    for name, t in tensors.items():
        assert tuple(got[name].shape) == tuple(t.shape), name
        assert got[name].dtype.itemsize == t.element_size()
        assert _bytes(got[name]) == _bytes(t), name
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    assert n % 8 == 0 and {e["dtype"] for e in header.values()} == {code}


@pytest.mark.parametrize("code", list(_DTYPES))
def test_reader_reads_safetensors_files(code, tmp_path):
    from safetensors.torch import save_file

    tensors = {k: v.contiguous() for k, v in _cases(_DTYPES[code]).items()}
    # a second dtype in the file shifts the tensors' offsets
    tensors["other"] = _tensor(torch.int8, (7,), 4)
    path = str(tmp_path / "r.safetensors")
    save_file(tensors, path, metadata={"k": "v"})
    with tst.SafeTensorsFile(path) as f:
        assert sorted(f.keys()) == sorted(tensors) and f.metadata == {"k": "v"}
        got = {name: f.get(name) for name in f.keys()}
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape, name
        assert _bytes(got[name]) == _bytes(t), name


def test_reader_refuses_offsets_that_do_not_fit(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    tst.save_file({"a": torch.zeros(4)}, path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        body = f.read()
    header["a"]["shape"] = [5]
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + body)
    with pytest.raises(ValueError, match="offsets"):
        tst.SafeTensorsFile(path)


# ---------------------------------------------------------------------------
# Trees of both packages
# ---------------------------------------------------------------------------


def _jconfig(**kw):
    extra = {k: kw.pop(k) for k in ("bitpack_weights", "meta_dtype") if k in kw}
    cfg = JConfig(compute_dtype=jnp.float32, **kw)
    cfg["weight_quant_params"].update(extra)
    return cfg


def _with_biases(params, key):
    def add(lin, i):
        b = jax.random.normal(jax.random.fold_in(key, i), (lin.weight.shape[0],)) * 0.1
        return lin.replace(bias=b)

    i = 0
    for layer in params["layers"]:
        for block in (layer["self_attn"], layer["mlp"]):
            for name in list(block):
                i += 1
                block[name] = add(block[name], i)
    return params


def _with_lora(params, key):
    params = JPeft.add_lora(params, j_lora_config(r=4, lora_alpha=8), key)
    for i, layer in enumerate(params["layers"]):
        for block in (layer["self_attn"], layer["mlp"]):
            for name, mod in block.items():
                b = jax.random.normal(jax.random.fold_in(key, 100 + i), mod.lora_b.shape) * 0.05
                block[name] = mod.replace(lora_b=b)
    return params


# name -> (quant config kwargs, config changes, tree change after quantization)
_CONFIGS = {
    "4bit_g64_axis1": (dict(nbits=4, group_size=64), {}, None),
    "3bit_g64_axis0": (dict(nbits=3, group_size=64, axis=0), {}, None),
    "2bit_g16_meta_quantized": (dict(nbits=2, group_size=16, quant_scale=True, quant_zero=True),
                                {}, None),
    "1.58bit": (dict(nbits=1.58, group_size=64), {}, None),
    "packing_none": (dict(nbits=4, group_size=64, bitpack_weights=False), {}, None),
    "bf16_meta": (dict(nbits=4, group_size=64, meta_dtype=jnp.bfloat16), {}, None),
    "biases": (dict(nbits=4, group_size=64), {}, "biases"),
    "lora": (dict(nbits=4, group_size=64), {}, "lora"),
    "tied_embeddings": (dict(nbits=4, group_size=64), dict(tie_word_embeddings=True), None),
    "none_leaves": (dict(nbits=4, group_size=64), {}, "none"),
}


@pytest.fixture(scope="module")
def trees():
    """name -> (cfg, hqq_tpu tree, the port's tree on the CPU), built once."""
    built = {}

    def get(name):
        if name not in built:
            qkw, cfg_kw, change = _CONFIGS[name]
            cfg = dataclasses.replace(jl.LlamaConfig.tiny(), **cfg_kw)
            key = jax.random.PRNGKey(3)
            params = jl.init_params(cfg, key, dtype=jnp.float32)
            if change == "biases":
                params = _with_biases(params, key)
            with warnings.catch_warnings():  # meta-quantization is deprecated upstream
                warnings.simplefilter("ignore", DeprecationWarning)
                qcfg = _jconfig(**qkw)
            jtree = j_quantize_model(params, qcfg, compute_dtype=jnp.float32)
            if change == "lora":
                jtree = _with_lora(jtree, key)
            if change == "none":
                jtree["unused"] = None
            # tree_map rebuilds dicts in sorted key order; both trees take it,
            # so that they flatten (and shard) in one order
            jtree = jax.tree_util.tree_map(lambda x: x, jtree)
            ttree = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")
            built[name] = cfg, jtree, ttree
        return built[name]

    return get


def _same_state(flat_a, flat_b):
    assert list(flat_a) == list(flat_b)
    for k in flat_a:
        a, b = flat_a[k], flat_b[k]
        assert tuple(a.shape) == tuple(b.shape), k
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype).removeprefix("torch."), k
        assert _bytes(a) == _bytes(b), k


def _greedy(jtree, ttree, cfg):
    prompts = [[1, 7, 3, 9, 11], [4, 5, 6, 200, 17]]
    ref = JModel(params=jtree, cfg=cfg, quantized=True).generate(
        prompts, max_new_tokens=4, cache_dtype=jnp.float32)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(cfg))
    got = TModel(params=ttree, cfg=tcfg, quantized=True).generate(
        prompts, max_new_tokens=4, cache_dtype=torch.float32)
    return np.asarray(ref), got


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_checkpoints_cross_both_ways(trees, name, tmp_path):
    """The same tree gives hqq_tpu's structure and tensors; a checkpoint of
    each package loads in the other, bit-equal, with equal greedy tokens."""
    cfg, jtree, ttree = trees(name)
    jflat, jstruct = js.tree_to_state(jtree)
    tflat, tstruct = ts.tree_to_state(ttree)
    assert json.loads(json.dumps(tstruct)) == json.loads(json.dumps(jstruct))
    _same_state(jflat, tflat)

    # the port writes, hqq_tpu reads; hqq_tpu writes, the port reads
    ts.save_checkpoint(str(tmp_path / "port"), ttree, config={"k": 1}, max_shard_bytes=40_000)
    js.save_checkpoint(str(tmp_path / "ref"), jtree, config={"k": 1}, max_shard_bytes=40_000)
    with open(tmp_path / "port" / "hqq_config.json") as f:
        port_index = json.load(f)
    with open(tmp_path / "ref" / "hqq_config.json") as f:
        ref_index = json.load(f)
    assert port_index == ref_index  # format, structure, config and shards
    assert len(set(port_index["weight_map"].values())) > 1
    jload, jconf = js.load_checkpoint(str(tmp_path / "port"))
    tload, tconf = ts.load_checkpoint(str(tmp_path / "ref"), device="cpu")
    assert jconf == tconf == {"k": 1}
    _same_state(js.tree_to_state(jload)[0], jflat)
    _same_state(ts.tree_to_state(tload)[0], tflat)
    ref, got = _greedy(jload, tload, cfg)
    np.testing.assert_array_equal(got, ref)


def test_sharding_is_greedy_in_tree_order(trees, tmp_path):
    _, _, ttree = trees("4bit_g64_axis1")
    flat, _ = ts.tree_to_state(ttree)
    limit = 100_000
    ts.save_checkpoint(str(tmp_path), ttree, max_shard_bytes=limit)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".safetensors"))
    with open(tmp_path / "hqq_config.json") as f:
        weight_map = json.load(f)["weight_map"]
    n = len(files)
    assert n > 2 and files == [f"model-{i:05d}-of-{n:05d}.safetensors" for i in range(1, n + 1)]
    order = [weight_map[k] for k in flat]
    assert order == sorted(order)  # shards follow the tree's order
    for fname in files:
        names = [k for k in flat if weight_map[k] == fname]
        size = sum(flat[k].numel() * flat[k].element_size() for k in names)
        assert size <= limit or len(names) == 1
        with tst.SafeTensorsFile(str(tmp_path / fname)) as f:
            assert sorted(f.keys()) == sorted(names)


def test_engine_checkpoint_crosses_both_ways(trees, tmp_path):
    """`HQQModelForCausalLM.from_quantized` of each package on the other's
    `save_quantized`: the config and sidecar agree, greedy tokens equal."""
    cfg, jtree, ttree = trees("4bit_g64_axis1")
    tcfg = tl.LlamaConfig(**dataclasses.asdict(cfg))
    TModel(params=ttree, cfg=tcfg, quantized=True).save_quantized(str(tmp_path / "port"))
    JModel(params=jtree, cfg=cfg, quantized=True).save_quantized(str(tmp_path / "ref"))
    with open(tmp_path / "port" / "hqq_config.json") as f:
        port_sidecar = json.load(f)
    with open(tmp_path / "ref" / "hqq_config.json") as f:
        ref_sidecar = json.load(f)
    assert port_sidecar == ref_sidecar
    assert port_sidecar["config"]["config_class"] == "hqq_tpu.models.llama.LlamaConfig"
    jm = JForCausalLM.from_quantized(str(tmp_path / "port"))
    tm = TForCausalLM.from_quantized(str(tmp_path / "ref"), device="cpu")
    assert jm.cfg == cfg and tm.cfg == tcfg and tm.quantized and tm.model_type == "llama"
    prompts = [[1, 7, 3, 9, 11], [4, 5, 6, 200, 17]]
    ref = jm.generate(prompts, max_new_tokens=6, cache_dtype=jnp.float32)
    got = tm.generate(prompts, max_new_tokens=6, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("backend", ["pallas", "w4a8", "lora_pallas", "lora_w4a8"])
def test_kernel_layouts_refused_on_save(trees, backend):
    _, _, ttree = trees("lora" if backend.startswith("lora") else "4bit_g64_axis1")
    prepared = prepare_for_inference(_copy_tree(ttree), backend.removeprefix("lora_"))
    with pytest.raises(TypeError, match="prepare_for_inference"):
        ts.tree_to_state(prepared)


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


@pytest.mark.parametrize("backend", ["pallas", "w4a8"])
def test_kernel_layouts_refused_on_load(trees, backend, tmp_path):
    """A checkpoint of hqq_tpu's kernel layouts (PallasQuantLinear or
    A8QuantLinear over KernelQTensor) does not load in the port."""
    _, jtree, _ = trees("4bit_g64_axis1")
    js.save_checkpoint(str(tmp_path), j_prepare(jtree, backend))
    with open(tmp_path / "hqq_config.json") as f:
        assert "KernelQTensor" in f.read()
    with pytest.raises(TypeError, match="prepare_for_inference"):
        ts.load_checkpoint(str(tmp_path), device="cpu")


@pytest.mark.parametrize("node", ["KernelQTensor", "Int8QuantLinear", "GroupedLinear",
                                  "GroupedQuantLinear", "SomethingElse"])
def test_unknown_and_kernel_nodes_refused_on_load(node):
    # Int8QuantLinear, GroupedLinear and GroupedQuantLinear are known nodes
    # since the int8 backend and the MoE layers were ported; these hold no
    # weight of their shape and no meta, which the loader refuses
    structure = {"type": "dict", "children": {"w": {"type": node, "children": {}, "meta": {}}}}
    with pytest.raises(TypeError):
        ts.state_to_tree(structure, lambda path: torch.zeros(1))


def test_unknown_leaf_refused_on_save():
    with pytest.raises(TypeError, match="Unsupported leaf"):
        ts.tree_to_state({"w": object()})
