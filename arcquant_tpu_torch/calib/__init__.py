"""Calibration (counterpart of ``arcquant_tpu/calib``): activation
statistics, channel reorder indices and ARC select counts
(``calibrate.compute_calibration``), and their .npz artifact."""

from .artifacts import load_calibration, load_calibration_meta, save_calibration
from .calibrate import compute_calibration
