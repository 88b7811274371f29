from .deepsignal import DeepSignalNet, forward_with_loss, predictions  # noqa: F401
