"""mc_roofline (%): the MC kernels K1, K2 and K3 (ops.mc ->
csrc/mc_*.cu), their launches' summed bound time over their summed
device time in the trace; the bound is harness.roofline's, from the
cells each call was given, at the published peaks."""
from harness.readers import mc_roofline

NEEDS = ("mc_calls",)


def read(ctx):
    return mc_roofline(ctx)
