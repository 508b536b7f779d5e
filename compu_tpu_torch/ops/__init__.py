"""Host-side algebra the port's framing needs (checksum combining)."""
