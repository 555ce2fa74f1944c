"""PyTorch port of the Tarema reproduction in ``repro`` (JAX).

Same layout and names as ``repro``: ``core/`` (profiling, grouping,
labeling, allocation, schedulers), ``workflow/`` (the simulated engine and
its inputs) and ``kernels/`` (hand-written CUDA kernels for Hopper with
their plain PyTorch versions).  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``; see ``repro_torch.device``.
"""
