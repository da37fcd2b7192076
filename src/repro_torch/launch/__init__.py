"""Train steps (``steps``). Serving, the dry-run and the launch helpers of
the JAX package are still to port (``ROADMAP.md``)."""
