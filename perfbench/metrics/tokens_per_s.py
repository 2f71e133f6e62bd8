"""tokens_per_s (tokens/s): the true (unpadded) tokens of every step of
the window that ran, over the window's wall time on the host's clock,
plan time, retries and failed steps included."""


def read(run):
    tokens = sum(sum(r.lengths) for r in run.window if r.ok)
    return tokens / run.window_s
