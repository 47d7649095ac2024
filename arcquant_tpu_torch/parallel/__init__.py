"""Parallelism on torch.distributed (counterpart of
``arcquant_tpu/parallel``): process groups and their launcher, multi-host
init, the tensor-parallel sharded quantized forward and serving engine
(with a data-parallel axis and page groups, and MoE experts sharded over
its ranks), expert parallelism, the pipeline-parallel forward and
serving engine, and sequence-parallel ring attention and paged decode."""

from .ep import ep_moe_block, make_ep_moe_forward, shard_moe_params
from .mesh import (AxisContext, CommStats, PPContext, SPContext, TPContext,
                   launch, make_mesh, make_pp, make_sp, multihost_init)
from .pp import pp_quant_model_forward, stack_stage_params
from .pp_engine import PPInferenceEngine, bucket_calib_uniform
from .ring import ring_attention, sp_flash_prefill, sp_paged_decode
from .tp import (shard_layer_params_tp, shard_linear_col, shard_linear_row,
                 shard_model_params_tp, tp_quant_layer_forward,
                 tp_quant_model_forward)
from .tp_engine import TPInferenceEngine
