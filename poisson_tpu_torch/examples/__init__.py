"""Runnable examples of the port, the twins of the repo's ``examples/``:
``python -m poisson_tpu_torch.examples.<name> [--device cuda|cpu]``. Each
module's ``main(argv)`` returns the numbers it printed, so tests can
hold them against the JAX package's."""
