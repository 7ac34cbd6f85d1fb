"""The replica-fleet rounds on one card: the replica axis as a batch
axis (full gossip in :mod:`.gossip`, targeted anti-entropy in
:mod:`.delta`)."""

__all__: list = []
