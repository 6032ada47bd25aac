"""Models of the port (text path of Kosmos-2.5's UniGPT so far)."""
