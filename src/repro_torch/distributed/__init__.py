"""Distribution helpers: the host-side straggler monitor and microbatch
gradient accumulation. The rest waits for the distribution item of
``ROADMAP.md``."""
