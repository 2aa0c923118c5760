"""Exact integer reference kernels of the plain reference (the numeric
spec), copied from the JAX package's spec/: each function is the
bit-exact arithmetic of one codec kernel of the C reference."""
