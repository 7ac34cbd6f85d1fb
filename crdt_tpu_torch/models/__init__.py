"""Product pipelines over the ops: the cold trace replay, the streaming
replay and the replica-fleet round."""

from crdt_tpu_torch.models.replay import ReplayResult, replay_trace
from crdt_tpu_torch.models.streaming import stream_replay

__all__ = ["ReplayResult", "replay_trace", "stream_replay"]
