"""Plain references of what the cells run, in PyTorch, independent of the
program: they import nothing of ``tpudash_torch``, ``tpudash`` or JAX, and
take from the harness only the inputs it made from the seed."""
