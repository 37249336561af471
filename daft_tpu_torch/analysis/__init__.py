"""The port's analysis tools (``python -m daft_tpu_torch.analysis``): the
differential plan fuzzer (``plan_fuzzer.py``) and the registry of the
hand-written CUDA entry points (``dispatch_registry.py``)."""
