"""Zstandard (RFC 8878) encode over the device LZ stage: the port's copy
of the encoder half of ``compu_tpu/formats/zstd`` (FSE/tANS tables,
zstd-canonical Huffman literals, sequence coding with the 3-slot
repeat-offset history, frame handling and the xxhash64 checksum)."""
