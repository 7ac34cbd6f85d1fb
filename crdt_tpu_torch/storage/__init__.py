"""Durable state: the native ordered-KV update log (``KvLog``,
``LogPersistence``) and device-layout snapshots of the live replica
(:mod:`crdt_tpu_torch.storage.snapshot`)."""

from crdt_tpu_torch.storage.kv import KvLog
from crdt_tpu_torch.storage.persistence import LogPersistence

__all__ = ["KvLog", "LogPersistence"]
