"""Densification of the fixed-capacity cloud (port of ``splatpu/growth``)."""
