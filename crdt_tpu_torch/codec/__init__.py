"""The Yjs v1 wire codec: lib0 primitives, the Python codec and the
native column codec."""

from crdt_tpu_torch.codec.lib0 import Decoder, Encoder

__all__ = ["Decoder", "Encoder"]
