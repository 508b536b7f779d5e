"""The host runtime: the C++ helpers under ``csrc/``, built with g++ into
``_build/`` at first use and called through ctypes (``native.py``)."""
