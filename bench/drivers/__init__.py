"""Drivers: one a kind of traffic mix (its ``kind`` key), found by name."""
