"""repro_torch — the D4M analytics stack on PyTorch and CUDA.

Mirrors the layout and public names of the JAX package ``repro``
(``core``, ``db``, ``pipeline``, ``analytics``, ``obs``, ``kernels``),
so one call can run through either and the results compare.  Device
work goes to :func:`repro_torch.device.get_device` — the card unless
the caller asks for the CPU — and the ELL SpMV/SpMM hot path runs
hand-written CUDA kernels (``repro_torch.kernels``).
"""
