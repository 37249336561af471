"""The port's analysis tools (``python -m daft_tpu_torch.analysis``): the
port's own copy of ``daft_tpu/analysis``.

Import-light on purpose: the engine imports the sanitizers' hooks on its
hot paths; the AST rule families and the CLI load lazily.

- ``framework.py`` — findings, ``# daft-lint: allow(<rule>) -- reason``
  pragmas, source walking, the (empty) baseline
- ``dataflow.py`` — per-function CFGs and the must-reach solver under
  the flow-sensitive families
- ``rule_knobs.py`` — the knob registry (``daft_tpu_torch/knobs.py``)
- ``rule_determinism.py`` — chaos-replay determinism (no unseeded
  random draws, wall-clock decisions or completion-order iteration in
  the replay-critical modules)
- ``rule_locks.py`` — blocking calls under a lock, unguarded module state
- ``rule_resources.py`` — paired acquire/release contracts on every path
- ``rule_cancellation.py`` / ``rule_attribution.py`` — drain loops poll
  the cancel token; worker threads carry the query's attribution
- ``rule_launch.py`` — every CUDA entry, compile and runtime dispatch site
  goes through ``dispatch_registry.py``
- ``rule_shapes.py`` — row counts reach capacities only through
  ``column.bucket_capacity``; device programs are memoized
- ``rule_donation.py`` — kernel workspaces are read only through their
  layout
- ``plan_contracts.py`` / ``rule_plans.py`` — the plan-node and optimizer
  rule contracts
- ``lock_sanitizer.py``, ``retrace_sanitizer.py``, ``plan_sanitizer.py``
  — the runtime sanitizers (``DAFT_TORCH_SANITIZE``,
  ``DAFT_TORCH_SANITIZE_RETRACE``, ``DAFT_TORCH_SANITIZE_PLAN``)
- ``plan_fuzzer.py`` — the differential plan fuzzer (``--fuzz``)
- ``dispatch_registry.py`` — the CUDA entry points and runtime dispatch
  sites
"""


def run_analysis(*args, **kwargs):
    from .framework import run_analysis as _run
    return _run(*args, **kwargs)
