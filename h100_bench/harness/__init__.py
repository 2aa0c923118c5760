"""The benchmark harness of thor_tpu_torch (the PyTorch and CUDA port).

Everything here is the yardstick: it finds a cell's configuration,
traffic mix and metric readers by the names in BENCHMARK.json, runs the
port through its public entry points, times a window of whole units,
records spans around the port's callables in a traced run, reduces the
device trace, and judges the outputs against the plain reference in
`plainref/`.  Nothing here imports jax or the JAX package, and nothing
of the port is imported when a harness module is imported.
"""
