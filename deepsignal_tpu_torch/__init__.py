"""deepsignal_tpu_torch: the DeepSignal methylation caller in PyTorch for an
NVIDIA H100.

A port of ``deepsignal_tpu`` (JAX/Flax/Pallas) that keeps its layout
(``core``, ``io``, ``ops``, ``models``, ``train``, ``runtime``, ``cli``) and
its on-disk formats: a checkpoint directory written by either package loads
in the other.  The hot recurrence runs in a hand-written CUDA kernel
(``csrc/lstm_encoder.cu``); everything else is plain PyTorch.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
