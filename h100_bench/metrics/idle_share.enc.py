"""idle_share (%): the share of the traced window in which the device
ran nothing (1 minus the union of its activities)."""
from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
