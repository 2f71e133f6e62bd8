"""peak_over_predicted (ratio): the largest, over the window's steps
that ran, of the allocator's peak over the planner's predicted peak
(``StepStats.max_memory_bytes / predicted_peak_bytes``): how far the
memory model misses on the card."""


def read(run):
    ratios = [r.stats.max_memory_bytes / r.stats.predicted_peak_bytes
              for r in run.window
              if r.ok and r.stats.predicted_peak_bytes > 0]
    return max(ratios) if ratios else None
