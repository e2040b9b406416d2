"""PyTorch/CUDA port of the JAX package ``repro``.

It imports ``torch`` and never ``jax`` nor anything of ``repro``. Entry
points run on the CUDA card unless the caller asks for the CPU
(``repro_torch.device.resolve``).
"""
