"""Transformer core: config, layers, positional schemes, the decoder stack."""
