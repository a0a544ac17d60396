"""Sharding rules (counterpart of `repro.parallel`)."""
