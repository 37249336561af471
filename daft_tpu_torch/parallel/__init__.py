"""The device mesh and its exchange programs (reference
``daft_tpu/parallel/``)."""
