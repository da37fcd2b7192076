"""Distribution helpers. Only the host-side straggler monitor is ported;
the rest waits for the distribution item of ``ROADMAP.md``."""
