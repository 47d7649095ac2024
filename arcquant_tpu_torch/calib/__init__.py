"""Calibration artifacts (counterpart of ``arcquant_tpu/calib``): the
loader of the .npz that the JAX package's calibrate.py writes."""

from .artifacts import load_calibration
