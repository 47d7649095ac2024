"""Utilities of the port: packed-checkpoint persistence (``checkpoint``,
over the safetensors reader and writer ``safetensors_io``) and
device-memory accounting (``mem``)."""

from .checkpoint import load_quantized, save_quantized
