"""Input builders of the port."""
