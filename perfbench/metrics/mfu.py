"""mfu (fraction): the model FLOPs of the window's steps that ran
(forward and backward at each sequence's true length:
``pbench.flops.step_train_flops``) over the window's wall time times
the configuration's peak (989 TFLOP/s, the H100's dense bf16 rate)."""
from pbench.flops import step_train_flops


def read(run):
    flops = sum(step_train_flops(run.cell.model, r.lengths)
                for r in run.window if r.ok)
    return flops / (run.window_s * float(run.cell.config["peak_flops"]))
