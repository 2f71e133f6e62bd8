"""pad_fraction (fraction): 1 - true tokens / bucket-padded tokens over
the window's steps that ran, from the trainer's ``StepStats``."""


def read(run):
    ok = [r.stats for r in run.window if r.ok]
    padded = sum(s.padded_tokens for s in ok)
    if not padded:
        return None
    return 1.0 - sum(s.tokens for s in ok) / padded
