"""step_mfu (%): the model FLOPs of the traced stretch's steps that ran
(``pbench.flops.step_train_flops``) over the stretch's length on the
trace's clock times the configuration's peak: the whole step's share of
the chip, which bounds every kernel's roofline share below it."""
from pbench.flops import step_train_flops


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    flops = sum(step_train_flops(run.cell.model, r.lengths)
                for r in run.stretch if r.ok)
    if not flops:
        return None
    peak = float(run.cell.config["peak_flops"])
    return 100.0 * flops / (run.trace.window_s * peak)
