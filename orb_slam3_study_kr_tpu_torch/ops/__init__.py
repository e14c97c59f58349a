"""Perception ops: ORB extraction, Hamming matching, KLT, geometry, and the
hand-written CUDA kernels behind them (cuda_fast, cuda_matching)."""
