"""Host staging, device primitives, the merge modules and the
hand-written kernels of the packed cold converge and the fleet round."""

__all__: list = []
