"""Scheduler plugins of the port (the slim path's subset)."""
