"""optim of the PyTorch port: masked AdamW, LR schedules, int8 gradient
compression (see the package docstring)."""
