"""Product pipelines over the ops: the cold trace replay and the
replica-fleet round."""

from crdt_tpu_torch.models.replay import ReplayResult, replay_trace

__all__ = ["ReplayResult", "replay_trace"]
