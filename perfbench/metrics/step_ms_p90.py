"""step_ms_p90 (ms): the 90th percentile (nearest rank) of the host's
clock around each ``Trainer.step`` of the window (it ends in a
synchronise), failed steps included."""
from pbench.stats import nearest_rank


def read(run):
    times = [r.host_s * 1e3 for r in run.window]
    return nearest_rank(times, 0.9) if times else None
