"""Shelby on PyTorch and CUDA: the paid erasure-coded write/read path.

A port of the JAX package ``repro`` to PyTorch on an NVIDIA Hopper GPU.  It
keeps that package's module layout and names, imports neither ``jax`` nor
``repro``, and runs its byte data path (Clay encode/decode) on the device
through the hand-written CUDA kernel in ``kernels/csrc/gf_matmul.cu``.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU device they raise (see
:func:`repro_torch.device.resolve_device`).
"""
