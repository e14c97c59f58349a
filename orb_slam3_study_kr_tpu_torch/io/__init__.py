"""Synthetic scene rendering (numpy)."""
