"""Mimose core: collector, estimator, scheduler, planner."""
