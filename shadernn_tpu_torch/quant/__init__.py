"""INT8: weight quantization (quantize.py) and activation calibration
(calibrate.py)."""
