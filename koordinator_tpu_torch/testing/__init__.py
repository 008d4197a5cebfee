"""Deterministic fault injection for the guarded cycle and its checks."""
