"""Device tier of the port: torch functions and CUDA kernel wrappers,
bit-exact with thor_tpu/ops and thor_tpu/dec."""
