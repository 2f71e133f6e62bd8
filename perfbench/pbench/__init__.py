"""The benchmark's harness: traffic, weights, the program's run, the
plain references' common parts, the check, the trace and the work
counters.  Importing the package imports nothing (``env`` runs before
torch is loaded)."""
