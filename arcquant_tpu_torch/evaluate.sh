#!/bin/bash
# Accuracy evaluation suite of the PyTorch port: the three invocations of
# the repository's evaluate.sh over python -m arcquant_tpu_torch.evaluate
# (zero-shot task suite, 5-shot MMLU, WikiText-2 PPL; all NVFP4). The
# datasets come through HF `datasets`, the tokenizer from the model
# directory. Runs on the card.
#
# Usage: bash arcquant_tpu_torch/evaluate.sh <model_dir_or_config> [calib.npz]
set -e

MODEL=${1:?usage: evaluate.sh <model> [calib.npz]}
CALIB=${2:-}
CALIB_ARG=""
if [ -n "$CALIB" ]; then CALIB_ARG="--calib $CALIB"; fi

# 1. zero-shot task suite
python -m arcquant_tpu_torch.evaluate --model "$MODEL" $CALIB_ARG \
    --quant_type NVFP4 \
    --tasks piqa,arc_challenge,boolq,hellaswag,winogrande,lambada,arc_easy

# 2. 5-shot MMLU
python -m arcquant_tpu_torch.evaluate --model "$MODEL" $CALIB_ARG \
    --quant_type NVFP4 --tasks mmlu --num_fewshot 5

# 3. WikiText-2 perplexity
python -m arcquant_tpu_torch.evaluate --model "$MODEL" $CALIB_ARG \
    --quant_type NVFP4 --eval_ppl --dataset wikitext2 --seqlen 2048
