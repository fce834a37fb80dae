"""Drivers: one module a kind of cell, ``run(...)`` -> the record."""
