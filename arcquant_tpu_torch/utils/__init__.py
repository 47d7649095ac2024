"""Utilities of the port: packed-checkpoint persistence (``checkpoint``,
over the safetensors reader and writer ``safetensors_io``),
device-memory accounting (``mem``) and the CUDA-event timer and profiler
trace (``timing``)."""

from .checkpoint import load_quantized, save_quantized
