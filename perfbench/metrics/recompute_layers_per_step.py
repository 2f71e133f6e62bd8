"""recompute_layers_per_step (layers/step): the mean of
``StepStats.recompute_layers`` (layers whose forward runs again in the
backward) over the window's steps that ran."""


def read(run):
    ok = [r.stats for r in run.window if r.ok]
    if not ok:
        return None
    return sum(s.recompute_layers for s in ok) / len(ok)
