"""repro_torch.examples — runnable drivers of the port (``python -m
repro_torch.examples.<name>``): the G-set batch with its SA column, the
MoE expert placement, and the LM serving and training drivers."""
