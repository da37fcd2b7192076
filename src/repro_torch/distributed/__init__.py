"""Distribution helpers: the host-side straggler monitor, microbatch
gradient accumulation, the batch stager and the int8 error-feedback
reduce. The sharded engine and ``pipeline_forward`` wait for A10b of
``ROADMAP.md``."""
