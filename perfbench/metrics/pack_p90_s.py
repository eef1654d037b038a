"""The 90th percentile (nearest rank) of the latency of every request of
the window, from its start to its PDB text."""
import math


def read(ctx):
    lat = ctx.window["latencies"]
    return lat[max(0, math.ceil(0.9 * len(lat)) - 1)] if lat else None
