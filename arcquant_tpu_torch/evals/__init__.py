"""Accuracy evaluation: the perplexity protocol, the task suites and the
dataset loaders (counterpart of ``arcquant_tpu/evals``)."""

from .data import get_calib_samples, get_token_stream, synthetic_stream
from .ppl import eval_ppl
