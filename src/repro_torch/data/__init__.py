"""Synthetic spatial data (the paper's test protocol)."""
