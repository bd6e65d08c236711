"""Driver intake and ack release: the 99th percentile of handler call
to ack release over every request acked in the traced run's window."""

import numpy as np


def read(ctx):
    lat = ctx["lat_ms"]
    return float(np.percentile(lat, 99)) if lat.size >= 1000 else None
