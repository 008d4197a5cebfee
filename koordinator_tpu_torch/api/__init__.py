"""The port's copy of the annotation/label protocol it needs."""
