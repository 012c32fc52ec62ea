"""Plan engine of the PyTorch port: sparse tensors, options, Krylov solvers,
preconditioners, dispatch and the adjoint (mirrors ``repro.core``)."""
