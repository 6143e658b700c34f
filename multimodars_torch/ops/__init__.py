"""Device compute of the port.

- :mod:`sweep` — the rotation sweep's cost table: the hand-written CUDA
  kernel (``csrc/sweep_cost.cu``), its plain PyTorch version, its binding
- :mod:`hausdorff_batch` — the centerline refine's table, many candidate
  sets against shared reference sets: the hand-written CUDA kernel
  (``csrc/hausdorff_batch.cu``), its plain version, its binding
- :mod:`_cuda_build` — the nvcc build and ctypes load of both kernels
- :mod:`hausdorff` — masked pairwise-distance Hausdorff reductions (plain)
- :mod:`rotation_search` — batched grid search with the reference's
  multi-resolution ladder semantics, certified lower-bound pruning
- :mod:`argmin_repair` — f64 and exact host repair of flagged argmins
"""
