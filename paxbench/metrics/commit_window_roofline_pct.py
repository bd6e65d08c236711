"""Commit window kernel: the share of the H100's memory roofline that
``commit_window`` reaches. The least time is the bytes its inputs need
(``peaks.commit_window_bytes``, N = groups x replicas instances, the
configured window) over the published 3.35 TB/s; the share is that
over the kernel's mean device time in the trace."""

from paxbench import peaks
from paxbench.trace import kernel_times


def read(ctx):
    dt = ctx.get("trace")
    if dt is None:
        return None
    kt = kernel_times(dt.events, "commit_window")
    if kt is None:
        return None
    conf = ctx["conf"]
    R, G = int(conf["replicas"]), int(conf["groups"])
    W = int(conf["log"]["window_slots"])
    need = peaks.commit_window_bytes(G * R, R, W)
    return 100.0 * need / peaks.hbm_peak(ctx["device_name"]) / kt[1]
