"""Registers the planted faults and the control of cells whose driver
``faults.py`` and ``controls.py`` do not name yet (``pagerank_hooks``),
before the test modules read those tables."""

from perfbench import pagerank_hooks  # noqa: F401
