"""HuggingFace checkpoint loading (counterpart of
``arcquant_tpu/models/hf.py``): a local Llama / Qwen2 / Mixtral /
Qwen-MoE checkpoint directory (config.json and *.safetensors shards)
into the port's parameter tree, tensor by tensor. The shards are read by
``utils/safetensors_io.py``, not by the ``safetensors`` package; only
``load_tokenizer`` needs ``transformers``, imported when it is called.
Nothing is downloaded.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

import torch

from ..config import ModelConfig, config_from_hf
from ..engine.engine import resolve_device
from ..utils.safetensors_io import read_safetensors


def _load_shards(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the directory's *.safetensors files, on the host."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir!r}")
    out: Dict[str, torch.Tensor] = {}
    for f in files:
        out.update(read_safetensors(f)[0])
    return out


def load_hf_config(model_dir: str) -> ModelConfig:
    """The ModelConfig of a checkpoint directory's config.json (a missing
    model_type reads as llama; other missing keys as None)."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no config.json in {model_dir!r}: not a "
                                "HuggingFace checkpoint directory")
    with open(path) as f:
        raw = json.load(f)

    class _Cfg:
        def __init__(self, d):
            self.__dict__.update(d)

        def __getattr__(self, k):        # missing keys -> None
            return None

    hf = _Cfg(raw)
    if hf.model_type is None:
        hf.model_type = "llama"
    return config_from_hf(hf)


def load_hf_params(model_dir: str, cfg: Optional[ModelConfig] = None,
                   dtype=torch.bfloat16, device="cuda"):
    """(cfg, params) of a local HF checkpoint: the tree of
    llama.init_params (an MoE layer's experts stacked as
    moe.init_moe_params lays them out: gate/up [E, F, D], down [E, D,
    F]), every tensor cast to `dtype` on `device` (the card unless
    "cpu"). Names may carry a "model." prefix or not; a missing
    lm_head.weight means a tied head."""
    device = resolve_device(device)
    if cfg is None:
        cfg = load_hf_config(model_dir)
    t = _load_shards(model_dir)

    def get(name):
        if name not in t:
            # some checkpoints prefix with "model.", some do not
            name = name[6:] if name.startswith("model.") else "model." + name
        return t[name].to(device=device, dtype=dtype)

    def linear(prefix, bias):
        p = {"w": get(prefix + ".weight")}
        if bias:
            p["b"] = get(prefix + ".bias")
        return p

    def moe_params(pre):
        """The stacked experts of either layout: Mixtral
        {pre}.block_sparse_moe.gate / .experts.{e}.w1|w3|w2; Qwen-MoE
        {pre}.mlp.gate / .mlp.experts.{e}.gate|up|down_proj with
        .mlp.shared_expert.* and .mlp.shared_expert_gate."""
        mixtral = any(".block_sparse_moe." in k
                      and k.split(".block_sparse_moe.")[0]
                      .endswith(pre.split("model.")[-1]) for k in t)
        mpre = pre + (".block_sparse_moe" if mixtral else ".mlp")
        names = (("w1", "w3", "w2") if mixtral
                 else ("gate_proj", "up_proj", "down_proj"))
        p = {"router": {"w": get(mpre + ".gate.weight")}}
        for dst, src in zip(("gate", "up", "down"), names):
            p[dst] = {"w": torch.stack(
                [get(f"{mpre}.experts.{e}.{src}.weight")
                 for e in range(cfg.num_experts)])}
        if cfg.shared_expert_size:
            p["sgate"] = linear(mpre + ".shared_expert.gate_proj", False)
            p["sup"] = linear(mpre + ".shared_expert.up_proj", False)
            p["sdown"] = linear(mpre + ".shared_expert.down_proj", False)
            p["shared_gate"] = linear(mpre + ".shared_expert_gate", False)
        return p

    layers = []
    qb = cfg.qkv_bias
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"
        lp = {
            "attn_norm": get(pre + ".input_layernorm.weight"),
            "mlp_norm": get(pre + ".post_attention_layernorm.weight"),
            "q": linear(pre + ".self_attn.q_proj", qb),
            "k": linear(pre + ".self_attn.k_proj", qb),
            "v": linear(pre + ".self_attn.v_proj", qb),
            "o": linear(pre + ".self_attn.o_proj", False),
        }
        if cfg.num_experts:
            lp["moe"] = moe_params(pre)
        else:
            lp.update(gate=linear(pre + ".mlp.gate_proj", False),
                      up=linear(pre + ".mlp.up_proj", False),
                      down=linear(pre + ".mlp.down_proj", False))
        layers.append(lp)
    params: Dict[str, Any] = {
        "embed": get("model.embed_tokens.weight"),
        "final_norm": get("model.norm.weight"),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        try:
            params["lm_head"] = get("lm_head.weight")
        except KeyError:
            pass  # tied after all
    return cfg, params


def load_tokenizer(model_dir: str):
    """The directory's tokenizer through transformers' AutoTokenizer,
    local files only. Without transformers it raises ImportError."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "load_tokenizer needs the transformers package, which is not "
            "installed here; pass token ids instead of text") from e
    return AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
