"""Runtime of the port: generation."""
