"""The 95th percentile of every call's latency in the window (host clock),
by the nearest rank: the value that 95% of the calls do not exceed."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
