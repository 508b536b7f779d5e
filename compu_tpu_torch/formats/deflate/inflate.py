"""DEFLATE decode error codes: the port's copy of the ``ERR_*`` codes and
the ``ERRORS`` table of ``compu_tpu/formats/deflate/inflate.py``, which
``describe_error`` reads. The host ``Inflate`` itself is not ported: the
port decodes DEFLATE on the device (``device_inflate.py``)."""

from __future__ import annotations

# Error codes (surfaced through DecodeError; messages in ERRORS).
ERR_HEADER = 101
ERR_BLOCK_TYPE = 102
ERR_STORED_LEN = 103
ERR_CODE_LENGTHS = 104
ERR_BAD_SYMBOL = 105
ERR_DISTANCE = 106
ERR_CHECKSUM = 107
ERR_DICT_REQUIRED = 108
ERR_LENGTH_MISMATCH = 109
ERR_TRAILING = 110

ERRORS = {
    ERR_HEADER: "invalid stream header",
    ERR_BLOCK_TYPE: "invalid deflate block type",
    ERR_STORED_LEN: "stored block LEN/NLEN mismatch",
    ERR_CODE_LENGTHS: "invalid huffman code lengths",
    ERR_BAD_SYMBOL: "invalid huffman symbol",
    ERR_DISTANCE: "distance too far back",
    ERR_CHECKSUM: "stream checksum mismatch",
    ERR_DICT_REQUIRED: "preset dictionary not supported",
    ERR_LENGTH_MISMATCH: "gzip length field mismatch",
    ERR_TRAILING: "truncated trailer",
}
