"""PyTorch / CUDA port of the PEQA system (the JAX package ``repro`` is the
reference it is tested against).

The port imports torch and numpy only — never JAX and never ``repro``; each
module it needs from the reference has its own copy here, under the same
name (``configs/``, ``core/``, ``kernels/``, ``models/``, ``optim/``, ``data/``,
``ckpt/``, ``train/``).

Entry points place everything on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that request they raise
(``repro_torch.device.resolve``).
"""
