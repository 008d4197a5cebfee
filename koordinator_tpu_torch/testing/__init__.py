"""Deterministic inputs for the checks: fault injection for the guarded
cycle, and K3's order-sensitive scatter case."""
