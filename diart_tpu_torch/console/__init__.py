"""The port's console entry points: ``python -m
diart_tpu_torch.console.stream|serve|client|benchmark``."""
