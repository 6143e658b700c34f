"""Device compute of the port.

- :mod:`sweep` — the rotation sweep's cost table: the hand-written CUDA
  kernel (``csrc/sweep_cost.cu``), its plain PyTorch version, the build
- :mod:`hausdorff` — masked pairwise-distance Hausdorff reductions (plain)
- :mod:`rotation_search` — batched grid search with the reference's
  multi-resolution ladder semantics, certified lower-bound pruning
- :mod:`argmin_repair` — f64 and exact host repair of flagged argmins
"""
