"""Drivers: one a kind of configuration (its ``driver`` key), ``run`` a cell once."""
