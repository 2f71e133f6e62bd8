"""plan_ms (ms): the mean of ``StepStats.plan_time_s`` over the window's
steps that ran: the program's own clock around ``planner.plan`` (the
trainer's ``plan`` spans), re-plans after an OOM included.  The window's
buckets are planned in the warm-up, so this is the plan cache's cost a
step, or a responsive plan's where a bucket was not."""


def read(run):
    ok = [r.stats for r in run.window if r.ok]
    if not ok:
        return None
    return 1e3 * sum(s.plan_time_s for s in ok) / len(ok)
