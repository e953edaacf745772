"""Whole-sequence modes (parallel/sharding.py: the online hybrid)."""
