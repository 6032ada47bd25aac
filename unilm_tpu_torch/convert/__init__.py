"""Weight bridges into the port's state_dicts."""
