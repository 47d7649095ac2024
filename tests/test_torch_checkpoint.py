"""Quantized checkpoints of arcquant_tpu_torch (utils/checkpoint.py:
save_quantized / load_quantized over one safetensors file) on test-tiny
and test-tiny-moe, the patterns of the JAX package's
tests/test_qwen_and_ckpt.py (its orbax directory is not read by the
port):

- the accuracy path's packed tree (quantize_model_params, w8 and w4):
  every leaf bitwise, the same NamedTuple types and dtypes, and the same
  quantized forward;
- the engine's fused tree (dense w8 and w4, and MoE with its expert
  stacks): every leaf bitwise, and an InferenceEngine on the loaded tree
  gives the same greedy tokens;
- non-tensor leaves and absent biases round-trip; a file without the
  tree raises; the default device is the card.
"""

import jax
import numpy as np
import pytest
import torch

from arcquant_tpu.models import llama as jllama
from arcquant_tpu_torch import convert
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.models import llama, quantized
from arcquant_tpu_torch.quant.packing import PackedWeight, PackedWeightI8
from arcquant_tpu_torch.utils import load_quantized, save_quantized
from arcquant_tpu_torch.utils.safetensors_io import write_safetensors

ECFG = dict(max_batch=2, max_seq_len=64, page_size=16)


def _assert_same_tree(a, b, name=""):
    assert type(a) is type(b), name
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert b.device.type == "cpu", name
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), name
    elif isinstance(a, (PackedWeight, PackedWeightI8)):
        for f in a._fields:
            _assert_same_tree(getattr(a, f), getattr(b, f), f"{name}.{f}")
    elif isinstance(a, dict):
        assert list(a) == list(b), name
        for k in a:
            _assert_same_tree(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{name}.{i}")
    else:
        assert a == b, name


def _params(name, seed):
    cfg = get_model_config(name)
    jp = jllama.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("fmt", ["w8", "w4"])
def test_quantized_checkpoint_roundtrip(tmp_path, fmt):
    cfg, params = _params("test-tiny", 1)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt=fmt,
                       act_scale="row")
    calib = quantized.identity_calib(cfg, 0.125)
    qp = quantized.quantize_model_params(cfg, params, calib, qcfg)
    path = str(tmp_path / "ckpt.safetensors")
    save_quantized(path, qp)
    back = load_quantized(path, device="cpu")
    _assert_same_tree(qp, back)
    cls = PackedWeightI8 if fmt == "w8" else PackedWeight
    assert isinstance(back["layers"][1]["down"], cls)
    toks = torch.tensor([[5, 10, 15, 20]])
    a = quantized.quant_model_forward(cfg, qp, calib, qcfg, toks)
    b = quantized.quant_model_forward(cfg, back, calib, qcfg, toks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name,fmt", [("test-qwen-tiny", "w8"),
                                      ("test-qwen-tiny", "w4"),
                                      ("test-tiny-moe", "w8")])
def test_engine_checkpoint_roundtrip(tmp_path, name, fmt):
    """The engine's packed tree (fused qkv/gateup, the W4A16 head; an MoE
    layer's gate/up pack and down stack) saved and loaded bitwise, and
    the engine on the loaded tree generates the same tokens."""
    cfg, params = _params(name, 2)
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True, weight_fmt=fmt,
                       act_scale="row", w_scale="channel",
                       quantize_lm_head=True)
    calib = quantized.identity_calib(cfg, 0.125)
    eng = InferenceEngine(cfg, params, calib, qcfg, EngineConfig(**ECFG),
                          device="cpu")
    path = str(tmp_path / "engine.safetensors")
    save_quantized(path, eng.qparams)
    back = load_quantized(path, device="cpu")
    _assert_same_tree(eng.qparams, back)
    loaded = InferenceEngine(cfg, back, calib, qcfg, EngineConfig(**ECFG),
                             device="cpu", quantize_params=False)
    prompts = [[3, 7, 11, 2, 9], [4]]
    assert loaded.generate(prompts, 4) == eng.generate(prompts, 4)


def test_checkpoint_leaves_and_errors(tmp_path):
    tree = {"layers": [{"w": PackedWeightI8(
        torch.ones(32, 4, dtype=torch.int8), torch.zeros(2, 4,
                                                         dtype=torch.uint8),
        torch.tensor(0.5), None)}], "step": 7, "name": "x", "frac": 0.125,
        "flag": True, "none": None, "bf": torch.randn(3).to(torch.bfloat16)}
    path = str(tmp_path / "t.safetensors")
    save_quantized(path, tree)
    back = load_quantized(path, device="cpu")
    _assert_same_tree(tree, back)
    assert back["layers"][0]["w"].bias is None
    write_safetensors(str(tmp_path / "raw.safetensors"),
                      {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="arcquant.tree"):
        load_quantized(str(tmp_path / "raw.safetensors"), device="cpu")
    with pytest.raises(TypeError, match="cannot save"):
        save_quantized(path, {"x": object()})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_quantized(path)
