"""Exact integer reference kernels (the numeric spec).

Every function here defines the bit-exact arithmetic of one codec kernel,
mirroring the reference C (cited per function).  The JAX/Pallas kernels in
thor_tpu.ops must match these exactly; tests enforce both directions
(spec == C oracle goldens, ops == spec).
"""
