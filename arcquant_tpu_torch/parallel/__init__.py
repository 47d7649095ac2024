"""Parallelism on torch.distributed (counterpart of
``arcquant_tpu/parallel``): the TP process group and its launcher, and
the tensor-parallel sharded quantized forward and serving engine. Not
ported yet (ROADMAP queue 1 item 8): dp > 1, pipeline and expert
parallelism, ring attention, multi-host init."""

from .mesh import CommStats, TPContext, launch, make_mesh
from .tp import (shard_layer_params_tp, shard_linear_col, shard_linear_row,
                 shard_model_params_tp, tp_quant_layer_forward,
                 tp_quant_model_forward)
from .tp_engine import TPInferenceEngine
