"""Host staging, device primitives and the hand-written kernels of the
packed cold converge."""

__all__: list = []
