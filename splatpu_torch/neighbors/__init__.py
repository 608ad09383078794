"""Nearest-neighbour search (port of ``splatpu/neighbors``)."""
