"""DEFLATE constants the device encode uses (RFC1951 §3.2.5; the port's
copy of the part of ``compu_tpu/formats/deflate/consts.py`` it needs)."""

MIN_MATCH = 3
MAX_MATCH = 258
WINDOW_SIZE = 32768
