from crdt_tpu_torch.api.doc import Crdt, ReservedNameError, WrongKindError
from crdt_tpu_torch.api.resident_doc import ResidentCrdt

__all__ = ["Crdt", "ResidentCrdt", "ReservedNameError", "WrongKindError"]
