"""Sharding rules and per-device memory budgets for a device mesh."""
