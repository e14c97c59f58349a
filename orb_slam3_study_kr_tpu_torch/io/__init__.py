"""Synthetic scene rendering and stereo rectification (numpy)."""
