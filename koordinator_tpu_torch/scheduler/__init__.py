"""The slim batched scheduling core of the port."""
