"""deepsignal_tpu_torch: the DeepSignal methylation caller in PyTorch for an
NVIDIA H100.

A port of ``deepsignal_tpu`` (JAX/Flax/Pallas) that keeps its layout
(``core``, ``io``, ``ops``, ``models``, ``train``, ``runtime``, ``cli``) and
its on-disk formats: a checkpoint directory written by either package loads
in the other.  The LSTM recurrence runs in hand-written CUDA kernels (the
fused encoder ``csrc/lstm_encoder.cu`` and the per-layer scan
``csrc/lstm_scan.cu``); everything else is plain PyTorch.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
