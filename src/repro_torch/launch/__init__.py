"""Train steps (``steps``), JSONL metrics and the device clock
(``metrics``) and held-out eval (``evaluate``). Serving, the dry-run and
the launch helpers of the JAX package are still to port (``ROADMAP.md``)."""
