"""Plain references of what the benchmark's cells check.  They import only
numpy and torch: nothing of the port and nothing of JAX."""
