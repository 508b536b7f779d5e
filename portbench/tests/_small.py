"""A cell cut down for the CPU: the same configuration and traffic, 128
KiB requests of 32 KiB blocks."""

from portbench import harness

REQUEST_BYTES = 1 << 17
BLOCK_SIZE = 1 << 15


def small_cell(name: str = "gzip-l6.mixed-16m", **traffic) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.traffic = dict(cell.traffic, request_bytes=REQUEST_BYTES, **traffic)
    cell.config = dict(cell.config, block_size=BLOCK_SIZE)
    return cell
