"""PyTorch/CUDA port of ``crdt_tpu`` for an NVIDIA H100.

Mirrors the reference package's layout and names. The port imports
``torch`` and ``numpy``, never ``jax`` and nothing from ``crdt_tpu``.
Entry points take ``device=`` and default to the card (``"cuda"``);
they raise when no card is present instead of falling back to the CPU.
The kernels of the converge and fleet hot paths are hand-written CUDA
for Hopper (``csrc/``), built at first use
(:mod:`crdt_tpu_torch.ops._build`).
"""

from crdt_tpu_torch.models.replay import ReplayResult, replay_trace

__all__ = ["ReplayResult", "replay_trace"]
