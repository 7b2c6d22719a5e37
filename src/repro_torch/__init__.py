"""PyTorch/CUDA port of ``repro`` for one NVIDIA Hopper card.

Mirrors ``repro``'s module names so each counterpart is easy to find.
Imports ``torch`` and nothing of JAX or of the ``repro`` package; the
framework-free pieces it needs (configs, the KV-pool allocator, the chunk
scheduler) are its own copies.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see ``repro_torch.device``).
"""
