"""Device failure policy: the guarded dispatch ladder."""

from crdt_tpu_torch.guard.device import dispatch_guarded

__all__ = ["dispatch_guarded"]
