"""Vectorized feasibility checks of the port (stage 1 of the cascade)."""
