"""The benchmark's plain references: a D2Q9 and a D3Q19 BGK step in plain
PyTorch, the loop that drives them at a stated storage precision, and the
comparison that decides a run's `correct`.

Frozen with the benchmark. They import nothing of `jax`, `lbm_tpu` or
`lbm_tpu_torch`, and take only the host inputs a job is given: they work
out again the start state, the body-force weights, the first acceleration
and the free-cell count that the program derives from the same inputs.
"""
