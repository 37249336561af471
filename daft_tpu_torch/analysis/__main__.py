"""``python -m daft_tpu_torch.analysis``: daft-lint over the port, the
knob-docs generator, and the differential plan fuzzer.

Lint mode (the default): every rule family over ``paths`` (default: the
port's tree — ``daft_tpu_torch``, ``tests/test_torch_*.py``,
``chip_smoke.py``); exit 0 when clean, 1 on findings, 2 on an unknown
``--rule`` id. ``--no-contracts`` skips the CUDA entry-point registry's
two-way check and the fusion-region schema check (the one part that
imports torch). ``--knob-docs`` prints the generated port knob tables;
``--knob-docs --write`` rewrites the README's port blocks.

``--fuzz``: the plan fuzzer (``plan_fuzzer.py``) over every mode of
:data:`plan_fuzzer.MODES` (or ``--modes``), with the plan sanitizer armed,
on the device ``DAFT_TORCH_DEVICE`` names (``cuda`` by default, ``cpu``
without a card). One summary line per mode, then a total; exit 1 on any
mismatch, error or sanitizer violation, after printing each mismatch's
minimized repro.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m daft_tpu_torch.analysis",
        description="engine-aware static analysis and the plan fuzzer of "
                    "daft_tpu_torch")
    ap.add_argument("paths", nargs="*",
                    help="repo-relative files/dirs to lint (default: "
                         "daft_tpu_torch tests/test_torch_*.py "
                         "chip_smoke.py)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings (with family and fix "
                         "hint)")
    ap.add_argument("--rule", action="append", default=None, metavar="ID",
                    help="only report findings of this rule id "
                         "(repeatable)")
    ap.add_argument("--stats", action="store_true",
                    help="print a summary line: files scanned, functions "
                         "analyzed, per-family finding counts")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the CUDA entry-point registry check and the "
                         "fusion-region schema check (no torch import)")
    ap.add_argument("--no-readme", action="store_true",
                    help="skip the README port knob-table drift check")
    ap.add_argument("--knob-docs", action="store_true",
                    help="print the generated port knob tables and exit")
    ap.add_argument("--write", action="store_true",
                    help="with --knob-docs: rewrite the README's port "
                         "blocks")
    ap.add_argument("--fuzz", action="store_true",
                    help="run the differential plan fuzzer: seeded random "
                         "queries, each mode against the unoptimized host "
                         "interpreter")
    ap.add_argument("--count", type=int, default=None, metavar="N",
                    help="with --fuzz: seeds (default DAFT_TORCH_FUZZ_COUNT)")
    ap.add_argument("--seed", type=int, default=None,
                    help="with --fuzz: base seed (default "
                         "DAFT_TORCH_FUZZ_SEED)")
    ap.add_argument("--modes", default=None,
                    help="with --fuzz: comma-separated modes (default: all "
                         "of plan_fuzzer.MODES)")
    args = ap.parse_args(argv)

    from .. import knobs
    from .framework import DEFAULT_SUBDIRS, known_rules, repo_root, \
        run_analysis

    root = repo_root()
    if args.fuzz:
        return _fuzz(args)

    if args.knob_docs:
        if args.write:
            changed = knobs.update_readme(os.path.join(root, "README.md"))
            print("README.md updated" if changed else "README.md up to date")
            return 0
        for group in knobs.GROUPS:
            print(f"### {group}\n{knobs.knob_table_markdown(group)}\n")
        return 0

    if args.rule:
        rules = known_rules()
        unknown = [r for r in args.rule if r not in rules]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}; known: "
                  f"{', '.join(sorted(rules))}")
            return 2

    subdirs = tuple(args.paths) if args.paths else DEFAULT_SUBDIRS
    stats = {} if args.stats else None
    findings = run_analysis(root, subdirs=subdirs,
                            contracts=not args.no_contracts,
                            readme=not args.no_readme, stats=stats)
    if args.rule:
        findings = [f for f in findings if f.rule in args.rule]
        if stats is not None:
            by_family = {}
            for f in findings:
                by_family[f.family or "?"] = by_family.get(
                    f.family or "?", 0) + 1
            stats["findings_by_family"] = by_family
    if args.json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
            if f.hint:
                print(f"    hint: {f.hint}")
        print(f"daft-lint: {len(findings)} finding(s)")
    if stats is not None:
        fam = ", ".join(f"{k}={v}" for k, v in
                        sorted(stats["findings_by_family"].items())) \
            or "none"
        print(f"daft-lint stats: files={stats['files_scanned']} "
              f"functions={stats['functions_analyzed']} "
              f"rules={len(stats['rules'])} findings_by_family: {fam}")
    return 1 if findings else 0


def _fuzz(args) -> int:
    from . import plan_fuzzer
    modes = tuple(m.strip() for m in args.modes.split(",")) \
        if args.modes else plan_fuzzer.MODES
    res = plan_fuzzer.run_fuzz(count=args.count, seed=args.seed,
                               modes=modes, log=print)
    s = res.summary()
    if args.json:
        print(json.dumps({**s, "mismatches_detail": [
            {"seed": m.seed, "mode": m.mode,
             "ops": [list(o) if isinstance(o, tuple) else o
                     for o in m.ops], "detail": m.detail}
            for m in res.mismatches]}, indent=2, default=str))
        return 1 if (res.mismatches or res.errors
                     or res.sanitizer_violations) else 0
    for m in res.mismatches:
        print("plan fuzzer MISMATCH\n" + m.repro())
    for e in res.errors:
        print(f"plan fuzzer error: {e}")
    for v in res.sanitizer_detail:
        print(f"plan fuzzer sanitizer violation: {v}")
    for mode, c in res.per_mode.items():
        print(f"plan fuzzer mode {mode}: {s['seeds_run']} seeds, "
              f"{c['cases']} compared, {c['mismatches']} mismatches, "
              f"{c['errors']} errors")
    print(f"plan fuzzer: {s['seeds_run']} seeds, "
          f"{s['cases_compared']} comparisons, "
          f"{s['mismatches']} mismatches, {s['errors']} errors, "
          f"{s['sanitizer_violations']} sanitizer violations")
    return 1 if (res.mismatches or res.errors
                 or res.sanitizer_violations) else 0


if __name__ == "__main__":
    sys.exit(main())
