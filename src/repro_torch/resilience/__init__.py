"""Resilience: the divergence guard. The chaos harness waits for its item
of ``ROADMAP.md``."""
