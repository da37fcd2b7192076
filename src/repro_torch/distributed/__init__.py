"""Distribution helpers: the host-side straggler monitor, microbatch
gradient accumulation, the batch stager, the int8 error-feedback reduce,
the logical-axis sharding rules (``sharding``) and the GPipe executor
(``pipeline.pipeline_forward``)."""
