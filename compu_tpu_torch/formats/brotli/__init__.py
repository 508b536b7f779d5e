"""Brotli (RFC 7932): the port's copy of ``compu_tpu/formats/brotli``.

The encoder takes its LZ tokens from the device LZ stage
(``formats/device_lz.py``) and writes the prefix codes and the meta-blocks
on the host; the decoder is the reference's full-spec host decoder (static
dictionary and word transforms, context modelling, block switching, the
insert-and-copy command alphabet, postfix and direct distances)."""
