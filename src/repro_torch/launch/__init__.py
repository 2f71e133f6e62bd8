"""Entry points and the analytic cost model."""
