"""``python -m daft_tpu_torch.analysis --fuzz``: the differential plan
fuzzer (``plan_fuzzer.py``) over every mode of :data:`plan_fuzzer.MODES`
(or ``--modes``), on the device ``DAFT_TORCH_DEVICE`` names (``cuda`` by
default, ``cpu`` without a card). Prints one summary line per mode, then a
total; exits 1 on any mismatch or error, after printing each one's
minimized repro.

The reference's lint rules (``daft_tpu/analysis``) are not part of the
port yet (ROADMAP).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m daft_tpu_torch.analysis",
        description="analysis tools of daft_tpu_torch")
    ap.add_argument("--fuzz", action="store_true",
                    help="run the differential plan fuzzer: seeded random "
                         "queries, each mode against the unoptimized host "
                         "interpreter")
    ap.add_argument("--count", type=int, default=None, metavar="N",
                    help="seeds (default DAFT_TORCH_FUZZ_COUNT)")
    ap.add_argument("--seed", type=int, default=None,
                    help="base seed (default DAFT_TORCH_FUZZ_SEED)")
    ap.add_argument("--modes", default=None,
                    help="comma-separated modes (default: all of "
                         "plan_fuzzer.MODES)")
    args = ap.parse_args(argv)
    if not args.fuzz:
        ap.error("nothing to do: pass --fuzz")

    from . import plan_fuzzer
    modes = tuple(m.strip() for m in args.modes.split(",")) \
        if args.modes else plan_fuzzer.MODES
    res = plan_fuzzer.run_fuzz(count=args.count, seed=args.seed,
                               modes=modes, log=print)
    s = res.summary()
    for m in res.mismatches:
        print("plan fuzzer MISMATCH\n" + m.repro())
    for e in res.errors:
        print(f"plan fuzzer error: {e}")
    for mode, c in res.per_mode.items():
        print(f"plan fuzzer mode {mode}: {s['seeds_run']} seeds, "
              f"{c['cases']} compared, {c['mismatches']} mismatches, "
              f"{c['errors']} errors")
    print(f"plan fuzzer: {s['seeds_run']} seeds, "
          f"{s['cases_compared']} comparisons, "
          f"{s['mismatches']} mismatches, {s['errors']} errors")
    return 1 if (res.mismatches or res.errors) else 0


if __name__ == "__main__":
    sys.exit(main())
