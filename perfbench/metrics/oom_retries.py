"""oom_retries (count): the OOM watchdog's ``oom_events`` during the
window (each one a retried or failed attempt)."""


def read(run):
    return run.oom_events
