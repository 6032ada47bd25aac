"""Attention ops: the plain torch reference, the dispatcher, and the
wrappers of the hand-written CUDA kernels (csrc/)."""
