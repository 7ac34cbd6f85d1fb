"""The replica-fleet rounds and the device mesh: full gossip and the
mesh steps in :mod:`.gossip`, targeted anti-entropy (the swarm-floor
delta and the ring) in :mod:`.delta`, the mesh and its collectives in
:mod:`.mesh`."""

__all__: list = []
