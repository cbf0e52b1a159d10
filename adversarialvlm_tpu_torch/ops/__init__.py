"""Image ops, losses and the hand-written kernels (``ops.kernels``)."""
