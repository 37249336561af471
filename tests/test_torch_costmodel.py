"""The port's cost model (``daft_tpu_torch/device/costmodel.py``), its
calibration store and its byte models, on the CPU.

- The reference's own tests of ``daft_tpu/device/costmodel.py``
  (``tests/test_costmodel.py``, all but the two image-resize gates, which
  wait for ROADMAP A8) and the calibration-only tests of
  ``tests/test_adaptive_feedback.py``, replayed against the port.
- Decision parity: over a seeded grid of rows, bytes up and down, group
  counts, key dtypes, windows and cacheability, with the port's constants
  set to the reference's values and one link profile given to both
  packages, every ``*_wins`` answer and every ``groupby_strategy`` /
  ``join_strategy`` answer equals ``daft_tpu.device.costmodel``'s.
- The port's one pricing term the reference lacks, ``agg_upload_wins``'s
  ``host_rescan_bytes``, asserted as exactly that difference.
- Knob semantics: ``DAFT_TORCH_DEVICE_MIN_ROWS`` unset → the model
  decides, set → its row floor on the per-operator paths and the fused
  fragment unpriced; ``DAFT_TORCH_DEVICE_FORCE`` trumps it;
  ``decision_counts`` and the JSONL log record each decision.
- Bytes: the ``mfu`` models equal ``chip_smoke.py``'s byte counts (the
  bound column of PERF.md) on a hash-agg case and a join case.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import daft_tpu_torch
from daft_tpu.device import costmodel as ref_cm
from daft_tpu_torch.device import calibration as cal
from daft_tpu_torch.device import costmodel as cm
from daft_tpu_torch.device import mfu, runtime
from daft_tpu_torch.recordbatch import RecordBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (reference knob, port knob) of each link term
_LINK = (("DAFT_TPU_LINK_RTT_MS", "DAFT_TORCH_LINK_RTT_MS"),
         ("DAFT_TPU_LINK_UP_MBPS", "DAFT_TORCH_LINK_UP_MBPS"),
         ("DAFT_TPU_LINK_DOWN_MBPS", "DAFT_TORCH_LINK_DOWN_MBPS"))


def _set_link(monkeypatch, rtt_ms, up_mbps, down_mbps):
    """One link profile for both packages."""
    for names, v in zip(_LINK, (rtt_ms, up_mbps, down_mbps)):
        for k in names:
            monkeypatch.setenv(k, str(v))
    cm.reset_for_tests()
    ref_cm.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    for k in ("DAFT_TORCH_DEVICE_MIN_ROWS", "DAFT_TORCH_DEVICE_FORCE",
              "DAFT_TORCH_DISPATCH_LOG", "DAFT_TORCH_CALIBRATION",
              "DAFT_TORCH_CALIBRATION_DIR", "DAFT_TORCH_KERNEL_GROUPBY",
              "DAFT_TORCH_KERNEL_JOIN", "DAFT_TPU_DEVICE_FORCE",
              "DAFT_TPU_KERNEL_GROUPBY", "DAFT_TPU_KERNEL_JOIN",
              "DAFT_TPU_DISPATCH_LOG", "DAFT_TPU_CALIBRATION"):
        monkeypatch.delenv(k, raising=False)
    for names in _LINK:
        for k in names:
            monkeypatch.delenv(k, raising=False)
    cm.reset_for_tests()
    ref_cm.reset_for_tests()
    runtime.reset_counters()
    yield
    cm.reset_for_tests()
    ref_cm.reset_for_tests()


@pytest.fixture
def slow_link(monkeypatch):
    """A 10 MB/s, 80 ms RTT link (the reference's tunnel worst case)."""
    _set_link(monkeypatch, 80, 10, 10)


@pytest.fixture
def fast_link(monkeypatch):
    """A ~100 MB/s link."""
    _set_link(monkeypatch, 40, 100, 100)


# --------------------------------------- tests/test_costmodel.py, ported

def test_invest_refused_on_slow_link(slow_link):
    """A 210 MB cache fill at 10 MB/s costs tens of host passes: the
    bounded investment rule refuses it."""
    assert not cm.agg_upload_wins(bytes_up=210e6, bytes_down=1e5,
                                  cacheable=True, host_bytes=336e6)


def test_invest_accepted_on_fast_link(fast_link):
    """The same fill at 100 MB/s costs a few host passes, and a resident
    rerun beats the host: invest."""
    assert cm.agg_upload_wins(bytes_up=210e6, bytes_down=1e5,
                              cacheable=True, host_bytes=336e6)


def test_noncacheable_upload_must_beat_host_outright(fast_link):
    assert not cm.agg_upload_wins(bytes_up=210e6, bytes_down=1e5,
                                  cacheable=False, host_bytes=336e6)


def test_rtt_bound_tiny_aggregates_stay_host(slow_link):
    """Tiny aggregates are round-trip-bound even when resident."""
    assert not cm.agg_upload_wins(bytes_up=2e5, bytes_down=1e5,
                                  cacheable=True, round_trips=2.0,
                                  host_bytes=3e5)


def test_host_bytes_defaults_to_bytes_up(fast_link):
    a = cm.agg_upload_wins(1e6, 1e4, cacheable=False)
    b = cm.agg_upload_wins(1e6, 1e4, cacheable=False, host_bytes=1e6)
    assert a == b


def test_decision_counts_and_jsonl_log(tmp_path, slow_link, monkeypatch):
    log = tmp_path / "dispatch.jsonl"
    monkeypatch.setenv("DAFT_TORCH_DISPATCH_LOG", str(log))
    cm.row_output_op_wins(1e6, 1e6)
    cm.agg_upload_wins(1e6, 1e4, cacheable=True, host_bytes=1e6)
    cm.join_wins(1000, 1000, 1e5, 1e5)
    assert cm.decision_counts["row_output"]["host"] == 1
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["kind"] for r in recs] == \
        ["row_output", "agg_upload_invest", "join"]
    assert all({"device", "host_s", "dev_s"} <= set(r) for r in recs)


def test_link_profile_persistence_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_LINK_CACHE_PATH",
                       str(tmp_path / "link.json"))
    p = cm.LinkProfile(rtt_s=0.05, up_bps=2e7, down_bps=1e7)
    cm._store("NVIDIA H100 80GB HBM3@host-a", p)
    got, age = cm._load_stored("NVIDIA H100 80GB HBM3@host-a")
    assert got == p and age is not None and age < 5
    # another card, or the same card on another host: a miss
    assert cm._load_stored("NVIDIA H100 80GB HBM3@host-b") == (None, None)
    assert cm._load_stored("cpu") == (None, None)


def test_link_profile_cpu_is_shared_memory():
    lp = cm.link_profile()   # DAFT_TORCH_DEVICE=cpu
    assert lp.rtt_s == 0.0 and lp.up_bps == float("inf")
    assert lp.down_bps == float("inf")


def test_encoded_nbytes_compacts_f64():
    from daft_tpu_torch.device import column as dcol
    rb = RecordBatch.from_pydict({
        "f": [1.0] * 1000, "s": ["ab"] * 1000, "i": [1] * 1000})
    enc = dcol.encoded_nbytes(rb, ["f", "s", "i"])
    cap = dcol.bucket_capacity(1000)
    # float64 rides its own width on the card; strings int32 codes; +1
    # validity byte each
    assert enc == cap * ((8 + 1) + (4 + 1) + (8 + 1))


def test_mfu_report_shape():
    """Every family with its fields on CPU tensors (CPU times name the
    CPU; the card's come from a chip run)."""
    r = mfu.report(n=1 << 12, device="cpu")
    assert r["device"] == "cpu"
    fams = ("vector", "grouped_agg", "grouped_agg_hash",
            "grouped_agg_dense", "argsort", "join", "join_hash")
    for fam in fams:
        assert r[fam]["time_s"] > 0 and r[fam]["bytes"] > 0, fam
        assert {"roofline_pct", "achieved_gbps", "rows_per_s"} \
            <= set(r[fam]), fam
    assert r["grouped_agg"]["input_bytes"] == (1 << 12) * (9 + 2 * 9)
    # a dead bit and two (null rank, float64) keys: 131 bits, a two-word
    # chunk and a one-word chunk
    assert r["argsort"]["sort_passes"] == 3


# ---------------------- tests/test_adaptive_feedback.py (calibration only)

def test_ewma_update_and_sample_floor(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION", "1")
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION_MIN_SAMPLES", "3")
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION_ALPHA", "0.5")
    cal.observe("DEV_AGG_BPS", 1e9)
    cal.observe("DEV_AGG_BPS", 1e9)
    assert cal.const("DEV_AGG_BPS", 4e9) == 4e9   # below the floor
    cal.observe("DEV_AGG_BPS", 2e9)
    assert cal.const("DEV_AGG_BPS", 4e9) == pytest.approx(1.5e9)
    s = cal.summary()["DEV_AGG_BPS"]
    assert s["active"] and s["samples"] == 3
    assert cal.calibrated_names() == ["DEV_AGG_BPS"]


def test_disabled_by_default_and_observe_noop():
    cal.observe("DEV_AGG_BPS", 1e9)
    assert not cal.enabled()
    assert cal.const("DEV_AGG_BPS", 4e9) == 4e9
    assert cal.summary()["DEV_AGG_BPS"]["samples"] == 0


def test_persistence_roundtrip(monkeypatch, tmp_path):
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION", "1")
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION_DIR", str(tmp_path))
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION_MIN_SAMPLES", "2")
    cal.observe("DEV_SORT_ROWS_PER_S", 9e6)
    cal.observe("DEV_SORT_ROWS_PER_S", 9e6)
    cal.flush()
    files = os.listdir(str(tmp_path))
    assert files == ["calibration_cpu.json"], files
    assert cal.const("DEV_SORT_ROWS_PER_S", 50e6) == pytest.approx(9e6)
    # a fresh process (reset) reloads the profile of this device and host
    cal.reset_for_tests()
    assert cal.const("DEV_SORT_ROWS_PER_S", 50e6) == pytest.approx(9e6)
    # a profile stored under another key prices nothing here
    path = os.path.join(str(tmp_path), files[0])
    d = json.load(open(path))
    d["key"] = "NVIDIA H100 80GB HBM3@another-host"
    json.dump(d, open(path, "w"))
    cal.reset_for_tests()
    assert cal.const("DEV_SORT_ROWS_PER_S", 50e6) == 50e6


def test_ledger_record_feeds_observations(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION", "1")
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION_MIN_SAMPLES", "1")
    cm.ledger_record("grouped_agg", rows=1 << 16, nbytes=1 << 24,
                     seconds=0.1, strategy="hash")
    assert cal.const("DEV_AGG_HASH_BPS", 0.0) > 0
    cm.ledger_record("argsort", rows=1 << 16, nbytes=1 << 20, seconds=0.05)
    assert cal.const("DEV_SORT_ROWS_PER_S", 0.0) > 0
    # tiny dispatches (launch-dominated) are skipped
    before = cal.summary()["DEV_SORT_ROWS_PER_S"]["samples"]
    cm.ledger_record("argsort", rows=16, nbytes=128, seconds=0.01)
    assert cal.summary()["DEV_SORT_ROWS_PER_S"]["samples"] == before
    snap = cm.ledger_snapshot()
    assert snap["grouped_agg"]["strategy"] == "hash"
    assert snap["argsort"]["dispatches"] == 2


def test_constants_override_changes_decision(monkeypatch):
    """A calibrated (much slower) device agg rate flips a borderline
    ``agg_upload_wins`` the measured constants accept."""
    _set_link(monkeypatch, 1, 5000, 5000)
    nbytes = 64 << 20
    assert cm.agg_upload_wins(nbytes, 1 << 10, cacheable=False)
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION", "1")
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION_MIN_SAMPLES", "1")
    cal.observe("DEV_AGG_BPS", 1e6)   # observed: the kernel is terrible
    assert not cm.agg_upload_wins(nbytes, 1 << 10, cacheable=False)


def test_ndv_ratio_damps_footer_evidence(monkeypatch):
    """Footer evidence that reads near-unique sends a group-by to sort; a
    calibrated actual/footer ratio of 0.05 damps it back to hash."""
    monkeypatch.setattr(cm, "_hash_capable_backend", lambda device=None:
                        True)
    rows, groups = 100_000, 90_000
    kd = [torch.int64]
    assert cm.groupby_strategy(rows, groups, kd, 128, log=False)[0] \
        == "sort"
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION", "1")
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION_MIN_SAMPLES", "1")
    cal.observe("NDV_FOOTER_RATIO", 0.05)
    assert cm.groupby_strategy(rows, groups, kd, 128, log=False)[0] \
        == "hash"


def test_knob_off_is_verbatim_static(tmp_path):
    """``DAFT_TORCH_CALIBRATION`` unset: a query's dispatches leave the
    profile empty, and the answer equals the one with the knob set to 0
    (the static constants price both)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(1)
    pq.write_table(pa.table({"k": rng.integers(0, 50, 20_000),
                             "v": rng.random(20_000)}),
                   str(tmp_path / "p.parquet"))

    def q():
        return daft_tpu_torch.read_parquet(str(tmp_path / "*.parquet")) \
            .groupby("k").agg(daft_tpu_torch.col("v").sum().alias("s")) \
            .sort("k").to_pydict()
    a = q()
    assert cal.profile_entries() == {}
    prev = os.environ.get("DAFT_TORCH_CALIBRATION")
    os.environ["DAFT_TORCH_CALIBRATION"] = "0"
    try:
        assert q() == a
    finally:
        if prev is None:
            del os.environ["DAFT_TORCH_CALIBRATION"]
        else:
            os.environ["DAFT_TORCH_CALIBRATION"] = prev
    assert cal.profile_entries() == {}


# ------------------------------------------------------ decision parity

#: the reference's constants, given to the port for the parity grid
_CONSTS = ("HOST_VECTOR_BPS", "HOST_AGG_BPS", "HOST_SORT_ROWS_PER_S",
           "HOST_JOIN_ROWS_PER_S", "DEV_VECTOR_BPS", "DEV_AGG_BPS",
           "DEV_AGG_HASH_BPS", "DEV_AGG_DENSE_BPS", "DEV_SORT_ROWS_PER_S",
           "DEV_JOIN_ROWS_PER_S", "DEV_JOIN_HASH_ROWS_PER_S",
           "DEV_DISPATCH_S", "INVEST_MAX_RATIO")

_NP_TO_TORCH = {np.dtype(np.int64): torch.int64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.bool_): torch.bool,
                np.dtype(np.float64): torch.float64}

#: link profiles of the grid: a slow tunnel, the H100 machine's measured
#: order of magnitude, and one between
_PROFILES = [(80, 10, 10), (0.17, 5700, 37000), (2, 800, 800)]


@pytest.fixture
def reference_constants(monkeypatch):
    """The reference's constants, and its two byte models the
    hash-vs-sort choice compares, given to the port: parity of the rule
    on equal inputs (the port's own models price its own kernels, and
    may order hash and sort differently: ``test_byte_models_are_the_
    ports_own``)."""
    from daft_tpu.device import mfu as ref_mfu
    for name in _CONSTS:
        monkeypatch.setattr(cm, name, getattr(ref_cm, name))
    monkeypatch.setattr(mfu, "grouped_agg_models", ref_mfu.grouped_agg_models)
    monkeypatch.setattr(mfu, "hash_agg_models", ref_mfu.hash_agg_models)


def _past_tpu_ceiling(n_left: int, n_right: int) -> bool:
    """Where the reference declines the hash join for its on-chip slot
    ceiling (``daft_tpu.device.costmodel._join_strategy``)."""
    from daft_tpu.device import pallas_kernels as pk
    from daft_tpu_torch.device.column import bucket_capacity
    return pk.join_table_capacity(bucket_capacity(max(n_right, 1))) \
        > pk.max_table_slots() \
        or bucket_capacity(max(n_left, n_right, 1)) > pk.max_table_slots()


def _grid(seed: int, n: int):
    rng = np.random.default_rng(seed)
    dts = [[np.int64], [np.int32, np.int32], [np.int64, np.int64],
           [np.int32], [np.int64, np.int32, np.int16], [np.bool_]]
    for _ in range(n):
        rows = int(rng.choice([1000, 8192, 50_000, 1 << 20, 6 << 20]))
        yield dict(
            rows=rows,
            bytes_up=float(rows * rng.choice([1, 9, 27, 80])),
            bytes_down=float(rng.choice([0, 1e3, 1e5, rows * 16.0])),
            host_bytes=float(rows * rng.choice([8, 24, 64])),
            groups=[None, 4.0, 10_000.0, 0.9 * rows][rng.integers(4)],
            out_cap=int(rng.choice([128, 4096, 1 << 16, 1 << 20])),
            key_dtypes=[np.dtype(d) for d in dts[rng.integers(len(dts))]],
            window=int(rng.choice([0, 1, 2, 4])),
            cacheable=bool(rng.integers(2)),
            round_trips=float(rng.choice([2.0, 0.5, 2.0 / 8])),
            strategy=str(rng.choice(["sort", "hash", "dense"])),
            n_keys=int(rng.integers(1, 4)),
            n_right=int(rng.choice([1000, 8192, 100_000, 1 << 19])))


@pytest.mark.parametrize("profile", _PROFILES)
@pytest.mark.parametrize("hash_capable", [True, False])
def test_decisions_match_the_reference(monkeypatch, reference_constants,
                                       profile, hash_capable):
    _set_link(monkeypatch, *profile)
    monkeypatch.setattr(cm, "_hash_capable_backend",
                        lambda device=None: hash_capable)
    monkeypatch.setattr(ref_cm, "_hash_capable_backend",
                        lambda: hash_capable)
    checked = past = 0
    ref_join_strategy = ref_cm._join_strategy
    for g in _grid(hash(profile) % 1000 + hash_capable, 120):
        r, rb = g["rows"], g["bytes_up"]
        if hash_capable and _past_tpu_ceiling(r, g["n_right"]):
            # the one intended difference: the port's join tables live in
            # device memory (test_join_strategy_has_no_on_chip_ceiling);
            # the reference prices the join at the port's strategy here
            past += 1
            assert ref_join_strategy(r, g["n_right"]) == "sort"
            monkeypatch.setattr(ref_cm, "_join_strategy",
                                lambda n_l, n_r: "hash")
        else:
            monkeypatch.setattr(ref_cm, "_join_strategy", ref_join_strategy)
        pairs = [
            (cm.row_output_op_wins(rb, g["bytes_down"],
                                   host_bytes=g["host_bytes"]),
             ref_cm.row_output_op_wins(rb, g["bytes_down"],
                                       host_bytes=g["host_bytes"])),
            (cm.argsort_wins(r, rb, g["n_keys"]),
             ref_cm.argsort_wins(r, rb, g["n_keys"])),
            (cm.agg_upload_wins(rb, g["bytes_down"], g["cacheable"],
                                g["round_trips"], g["host_bytes"],
                                g["strategy"], g["window"]),
             ref_cm.agg_upload_wins(rb, g["bytes_down"], g["cacheable"],
                                    g["round_trips"], g["host_bytes"],
                                    g["strategy"], g["window"])),
            (cm.join_wins(r, g["n_right"], rb, g["bytes_down"],
                          g["window"]),
             ref_cm.join_wins(r, g["n_right"], rb, g["bytes_down"],
                              g["window"])),
            (cm.join_strategy(r, g["n_right"]),
             ref_cm.join_strategy(r, g["n_right"])),
            (cm.groupby_strategy(
                r, g["groups"], [_NP_TO_TORCH[d] for d in g["key_dtypes"]],
                g["out_cap"], log=False),
             ref_cm.groupby_strategy(r, g["groups"], g["key_dtypes"],
                                     g["out_cap"], log=False)),
        ]
        for i, (mine, ref) in enumerate(pairs):
            assert mine == ref, (i, g, mine, ref)
            checked += 1
    assert checked == 120 * 6
    assert past < 120 // 2
    # both logged the same decisions
    assert cm.decision_counts_snapshot() == {
        k: dict(v) for k, v in ref_cm.decision_counts.items()}


@pytest.mark.parametrize("profile", _PROFILES)
def test_rescan_bytes_are_the_one_pricing_difference(
        monkeypatch, reference_constants, profile):
    """``agg_upload_wins``'s ``host_rescan_bytes`` (the port's one pricing
    term the reference lacks): on a cacheable upload the port decides as
    the reference does with those bytes added to the host pass's; on any
    other it changes nothing. ``kind`` only renames the logged
    decision."""
    _set_link(monkeypatch, *profile)
    flips = 0
    for g in _grid(hash(profile) % 1000 + 7, 120):
        rescan = float(g["rows"] * 40)
        args = (g["bytes_up"], g["bytes_down"], g["cacheable"],
                g["round_trips"])
        mine = cm.agg_upload_wins(*args, g["host_bytes"], g["strategy"],
                                  g["window"], host_rescan_bytes=rescan,
                                  kind="fused_agg_upload")
        ref = ref_cm.agg_upload_wins(
            *args, g["host_bytes"] + (rescan if g["cacheable"] else 0.0),
            g["strategy"], g["window"])
        assert mine == ref, g
        flips += mine != ref_cm.agg_upload_wins(
            *args, g["host_bytes"], g["strategy"], g["window"])
    assert flips > 0   # the grid reaches decisions the term changes
    counts = cm.decision_counts_snapshot()
    assert set(counts) <= {"fused_agg_upload", "fused_agg_upload_invest"}
    assert sum(sum(v.values()) for v in counts.values()) == 120


@pytest.mark.parametrize("forced", ["1", "0"])
def test_forced_decisions_match_the_reference(monkeypatch, forced):
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", forced)
    monkeypatch.setenv("DAFT_TPU_DEVICE_FORCE", forced)
    for mine, ref in ((cm.row_output_op_wins(1e9, 1e9),
                       ref_cm.row_output_op_wins(1e9, 1e9)),
                      (cm.argsort_wins(10, 80, 1),
                       ref_cm.argsort_wins(10, 80, 1)),
                      (cm.agg_upload_wins(1e3, 1e3, True),
                       ref_cm.agg_upload_wins(1e3, 1e3, True)),
                      (cm.join_wins(10, 10, 1e2, 1e2),
                       ref_cm.join_wins(10, 10, 1e2, 1e2))):
        assert mine == ref == (forced == "1")


@pytest.mark.parametrize("kernel", ["hash", "sort"])
def test_forced_strategies_match_the_reference(monkeypatch, kernel):
    monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY", kernel)
    monkeypatch.setenv("DAFT_TPU_KERNEL_GROUPBY", kernel)
    monkeypatch.setenv("DAFT_TORCH_KERNEL_JOIN", kernel)
    monkeypatch.setenv("DAFT_TPU_KERNEL_JOIN", kernel)
    for dts in ([np.int64], [np.int64, np.int64]):
        mine = cm.groupby_strategy(1 << 20, None,
                                   [_NP_TO_TORCH[np.dtype(d)] for d in dts],
                                   1 << 21, log=False)
        ref = ref_cm.groupby_strategy(1 << 20, None,
                                      [np.dtype(d) for d in dts], 1 << 21,
                                      log=False)
        assert mine == ref
    assert cm.join_strategy(1 << 22, 1 << 22) \
        == ref_cm.join_strategy(1 << 22, 1 << 22) == kernel


def test_byte_models_are_the_ports_own(monkeypatch):
    """The hash-vs-sort comparison reads the port's kernels' byte models:
    at 50,000 rows over one int64 key and a 65,536-group budget the
    port's one-pass table build moves fewer bytes than its torch sort
    strategy (hash), where the reference's models order them the other
    way (sort)."""
    from daft_tpu.device import mfu as ref_mfu
    monkeypatch.setattr(cm, "_hash_capable_backend", lambda device=None:
                        True)
    monkeypatch.setattr(ref_cm, "_hash_capable_backend", lambda: True)
    rows, cap = 50_000, 1 << 16
    table = 1 << 17
    assert mfu.hash_agg_models(rows, cap, table, 1, 1)[1] \
        < mfu.grouped_agg_models(rows, cap, 1, 1)[1]
    assert ref_mfu.hash_agg_models(rows, cap, table, 1, 1)[1] \
        > ref_mfu.grouped_agg_models(rows, cap, 1, 1)[1]
    assert cm.groupby_strategy(rows, None, [torch.int64], cap,
                               log=False)[0] == "hash"
    assert ref_cm.groupby_strategy(rows, None, [np.dtype(np.int64)], cap,
                                   log=False)[0] == "sort"


def test_join_strategy_has_no_on_chip_ceiling(monkeypatch):
    """Past the reference's slot ceiling (its tables must fit a TPU's
    on-chip memory) the reference's ``auto`` join takes sort; the H100's
    tables live in device memory, so the port's stays on hash."""
    monkeypatch.setattr(cm, "_hash_capable_backend", lambda device=None:
                        True)
    monkeypatch.setattr(ref_cm, "_hash_capable_backend", lambda: True)
    assert ref_cm.join_strategy(1 << 18, 1 << 22) == "sort"
    assert cm.join_strategy(1 << 18, 1 << 22) == "hash"


def test_cpu_tensors_take_sort_under_auto():
    """The reference's rule: the hash kernels are compiled for a card."""
    assert cm.join_strategy(1 << 20, 1 << 20) == "sort"
    assert cm.groupby_strategy(1 << 20, None, [torch.int64], 128)[0] \
        == "sort"
    assert cm.decision_counts_snapshot() == {
        "join_strategy": {"device": 0, "host": 1},
        "groupby_strategy": {"device": 0, "host": 1}}


# ------------------------------------------------------- knob semantics

def _batch(n: int):
    import pyarrow as pa
    rng = np.random.default_rng(n)
    return RecordBatch.from_arrow_table(pa.table({
        "k": rng.integers(0, 50, n), "v": rng.random(n)}))


def test_min_rows_unset_lets_the_model_decide(monkeypatch):
    c = daft_tpu_torch.col
    small, large = _batch(200), _batch(1 << 20)
    for rb in (small, large):
        runtime.try_eval_projection(rb, [c("v") * 2])
    # a zero-cost link (CPU tensors): the dispatch term keeps 200 rows on
    # the host, the rate terms send 2^20 to the device
    assert cm.decision_counts["row_output"] == {"device": 1, "host": 1}
    assert runtime.counters().get("projection") == 1
    assert runtime.counters().get("host_ops") == 1


def test_min_rows_set_keeps_its_meaning(monkeypatch):
    c = daft_tpu_torch.col
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "300")
    assert runtime.try_eval_projection(_batch(200), [c("v") * 2]) is None
    assert runtime.try_eval_projection(_batch(400), [c("v") * 2]) \
        is not None
    assert runtime.try_argsort([_batch(400).get_column("v")], [False],
                               [False]) is not None
    # no pricing: the floor decided
    assert cm.decision_counts_snapshot() == {}
    assert runtime.counters()["host_ops"] == 1


def test_force_trumps_min_rows(monkeypatch):
    c = daft_tpu_torch.col
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "1000000")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    assert runtime.try_eval_projection(_batch(200), [c("v") * 2]) \
        is not None
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "0")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "0")
    assert runtime.try_eval_projection(_batch(1 << 20), [c("v") * 2]) \
        is None
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "maybe")
    with pytest.raises(ValueError, match="DAFT_TORCH_DEVICE_FORCE"):
        runtime.try_eval_projection(_batch(200), [c("v") * 2])


def test_join_gate_knobs(monkeypatch):
    """``DAFT_TORCH_DEVICE_JOIN=1/0`` forces; unset, the 8,192-row floor
    and then ``join_wins``."""
    from daft_tpu_torch import joins
    g = np.arange(5000, dtype=np.int64)
    ones = np.ones(5000, dtype=bool)
    monkeypatch.setenv("DAFT_TORCH_DEVICE_JOIN", "1")
    joins.match_indices(g[:100], g[:100], ones[:100], ones[:100])
    assert runtime.counters() == {"join_sort": 1}
    monkeypatch.setenv("DAFT_TORCH_DEVICE_JOIN", "0")
    joins.match_indices(g, g, ones, ones)
    assert runtime.counters() == {"join_sort": 1, "host_joins": 1}
    monkeypatch.delenv("DAFT_TORCH_DEVICE_JOIN")
    joins.match_indices(g[:4000], g[:4000], ones[:4000], ones[:4000])
    assert "join" not in cm.decision_counts   # under the floor, unpriced
    joins.match_indices(g, g, ones, ones)
    assert sum(cm.decision_counts["join"].values()) == 1
    monkeypatch.setenv("DAFT_TORCH_DEVICE_JOIN", "2")
    with pytest.raises(ValueError, match="DAFT_TORCH_DEVICE_JOIN"):
        joins.match_indices(g, g, ones, ones)


def test_fused_fragment_is_priced(tmp_path, monkeypatch):
    """A fused agg over a small file is priced onto the host at the
    default knobs (and counted); forced, it runs on the device; the
    answers agree."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(2)
    pq.write_table(pa.table({"k": rng.integers(0, 9, 300),
                             "v": rng.random(300)}),
                   str(tmp_path / "p.parquet"))

    def q():
        return daft_tpu_torch.read_parquet(str(tmp_path / "*.parquet")) \
            .groupby("k").agg(daft_tpu_torch.col("v").sum().alias("s")) \
            .sort("k").to_pydict()
    host = q()
    assert runtime.counters()["host_morsels"] == 1
    assert cm.decision_counts["fused_agg_upload_invest"]["host"] == 1
    runtime.reset_counters()
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    dev = q()
    assert runtime.counters().get("host_morsels", 0) == 0
    assert runtime.counters()["sort"] == 1
    assert dev["k"] == host["k"]
    np.testing.assert_allclose(dev["s"], host["s"], rtol=1e-12)


def test_min_rows_leaves_the_fused_fragment_unpriced(tmp_path,
                                                     monkeypatch):
    """An explicit ``DAFT_TORCH_DEVICE_MIN_ROWS`` floors the per-operator
    paths only: the fused fragment keeps the rule it had before the cost
    model (every non-empty batch on the device, no pricing, whatever the
    floor), and ``DAFT_TORCH_DEVICE_FORCE`` trumps it."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from daft_tpu_torch.device import cache
    rng = np.random.default_rng(3)
    pq.write_table(pa.table({"k": rng.integers(0, 9, 300),
                             "v": rng.random(300)}),
                   str(tmp_path / "p.parquet"))

    def q():
        return daft_tpu_torch.read_parquet(str(tmp_path / "*.parquet")) \
            .groupby("k").agg(daft_tpu_torch.col("v").sum().alias("s")) \
            .sort("k").to_pydict()
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "1000000")
    dev = q()
    counts = runtime.counters()
    assert counts.get("host_morsels", 0) == 0 and counts["sort"] == 1
    assert not any(k.startswith("fused_agg_upload")
                   for k in cm.decision_counts_snapshot())
    runtime.reset_counters()
    cache.get_cache().clear()   # a cache hit is never priced
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "0")
    host = q()
    assert runtime.counters()["host_morsels"] == 1
    assert dev["k"] == host["k"]
    np.testing.assert_allclose(dev["s"], host["s"], rtol=1e-12)


# ---------------------------------------------------------------- bytes

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hash_agg_bytes_equal_chip_smoke_bound():
    """Every row live, two float64 sums over distinct planes, a table that
    does not fill: the model and chip_smoke's ``build_bytes`` agree."""
    from daft_tpu_torch.device import hash_kernels as hk
    cs = _chip_smoke()
    C, T = 1 << 12, 1 << 10
    g = torch.Generator().manual_seed(0)
    words = [torch.randint(0, 300, (C,), generator=g)]
    live = torch.ones(C, dtype=torch.bool)
    vals = [torch.rand(C, generator=g, dtype=torch.float64)
            for _ in range(2)]
    contribs = [torch.ones(C, dtype=torch.bool) for _ in range(2)]
    specs = hk.agg_state_specs(("sum", "sum"), [v.dtype for v in vals])
    want = cs.build_bytes(words, live, vals, contribs, specs, T)
    assert mfu.hash_agg_models(C, 128, T, 1, 2, 8)[1] == want


def test_hash_join_bytes_equal_chip_smoke_bound():
    """Every row live on both sides, ``cap`` pairs emitted: the model and
    chip_smoke's ``join_build_bytes`` + ``join_probe_bytes`` agree."""
    from daft_tpu_torch.device import join_kernels as jk
    cs = _chip_smoke()
    C_l, C_r = 1 << 11, 1 << 12
    T = jk.join_table_capacity(C_r)
    cap = 3000
    live_r = torch.ones(C_r, dtype=torch.bool)
    live_l = torch.ones(C_l, dtype=torch.bool)
    packed = torch.zeros((3, max(cap, C_l)), dtype=torch.int64)
    packed[2, :C_l] = 2   # 4096 pairs: the bound charges the first cap
    want = cs.join_build_bytes(live_r, T) \
        + cs.join_probe_bytes(live_l, packed, cap)
    assert mfu.hash_join_bytes_model(C_l, C_r, cap) == want


def test_argsort_plan_matches_the_kernel_packing():
    from daft_tpu_torch.device import kernels
    keys = (torch.arange(8, dtype=torch.int64),
            torch.arange(8, dtype=torch.float32))
    ones = torch.ones(8, dtype=torch.bool)
    codes = kernels._sort_codes(keys, (ones, ones), ones, (False,) * 2,
                                (False,) * 2)
    chunks = kernels._packed_chunks(codes)
    assert mfu.argsort_pack_plan([k.dtype for k in keys]) \
        == [len(c) for c in chunks]


def test_groups_past_the_link_ceiling_run_on_the_host(tmp_path,
                                                      monkeypatch):
    """A slow link (1 MB/s down) prices fetching more than 128 groups over
    the host's own aggregation (``fragment._max_out_cap``): up front for a
    key with footer statistics (``_fragment_groups_affordable``: the
    morsel path), at run time for a computed key (the table climbs to the
    ceiling and is aggregated on the host). Answers equal the host
    tier's."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(4)
    for i in range(2):
        pq.write_table(pa.table({"k": rng.integers(0, 3000, 4000),
                                 "v": rng.random(4000)}),
                       str(tmp_path / f"p{i}.parquet"))
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    _set_link(monkeypatch, 0.1, 1000, 1)
    c = daft_tpu_torch.col

    def q(key):
        return daft_tpu_torch.read_parquet(str(tmp_path / "*.parquet")) \
            .groupby(key.alias("g")).agg(c("v").sum().alias("s")) \
            .sort("g").to_pydict()
    for key in (c("k"), c("k") % 2000):
        runtime.reset_counters()
        # one scan task per file (the scan would merge the two)
        with daft_tpu_torch.execution_config_ctx(scan_tasks_min_size_bytes=0):
            got = q(key)
        counts = runtime.counters()
        assert counts["host_morsels"] == 2, counts
        with daft_tpu_torch.execution_config_ctx(device="0"):
            want = q(key)
        assert got["g"] == want["g"]
        np.testing.assert_allclose(got["s"], want["s"], rtol=1e-12)
    # the computed key reached the device and climbed to the ceiling
    assert counts.get("sort", 0) + counts.get("hash", 0) >= 2, counts


def test_translate_carries_footer_ndv_like_the_reference(tmp_path):
    """The final aggregate's ``group_ndv`` / ``group_rows_est`` equal the
    reference's (footer ranges), and the fused fragment carries them."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    import daft_tpu
    from daft_tpu.physical import plan as ref_pp
    from daft_tpu.physical.translate import translate as ref_translate
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.physical.translate import translate
    rng = np.random.default_rng(6)
    for i in range(2):
        pq.write_table(pa.table({"k": rng.integers(100, 400, 1000),
                                 "v": rng.random(1000)}),
                       str(tmp_path / f"p{i}.parquet"))
    path = str(tmp_path / "*.parquet")

    def nodes(plan, cls, out):
        if isinstance(plan, cls):
            out.append(plan)
        for ch in plan.children:
            nodes(ch, cls, out)
        return out
    mine = translate(daft_tpu_torch.read_parquet(path).groupby("k").agg(
        daft_tpu_torch.col("v").sum()).builder.optimize().plan)
    ref = ref_translate(daft_tpu.read_parquet(path).groupby("k").agg(
        daft_tpu.col("v").sum())._builder.optimize()._plan)
    final = [n for n in nodes(mine, pp.Aggregate, []) if n.mode == "final"]
    ref_final = [n for n in nodes(ref, ref_pp.Aggregate, [])
                 if n.mode == "final"]
    assert len(final) == len(ref_final) == 1
    assert final[0].group_ndv == ref_final[0].group_ndv
    assert final[0].group_rows_est == ref_final[0].group_rows_est == 2000
    frag = nodes(mine, pp.DeviceFragmentAgg, [])[0]
    assert (frag.group_ndv, frag.group_rows_est) \
        == (final[0].group_ndv, 2000)
    assert 250 <= frag.group_ndv <= 300


def test_ledger_delta_accounts_the_work_between_snapshots():
    cm.ledger_record("join", rows=1000, nbytes=1e6, seconds=1e-3,
                     strategy="hash", load_factor=0.25)
    before = cm.ledger_snapshot(raw=True)
    cm.ledger_record("join", rows=3000, nbytes=4e6, seconds=2e-3,
                     strategy="sort")
    d = cm.ledger_delta(before, cm.ledger_snapshot(raw=True))
    assert d["join"]["dispatches"] == 1 and d["join"]["rows"] == 3000
    assert d["join"]["strategy"] == "sort"
    assert d["join"]["achieved_gbps"] == pytest.approx(2.0)
    snap = cm.ledger_snapshot()["join"]
    assert snap["strategy"] == "mixed" and snap["load_factor"] == 0.25


# ----------------------- fusion_wins: the join_agg region's port-only price

@pytest.fixture
def h100_link(monkeypatch):
    """The H100 machine's link (0.303 ms RTT, 5.64 GB/s up, 46.8 GB/s
    down: PERF.md §6)."""
    _set_link(monkeypatch, 0.303, 5640, 46800)


@pytest.mark.parametrize("rows, build_rows",
                         [(2048, 1024), (4096, 1024), (131072, 1024),
                          (131072, 65536)])
def test_join_agg_gate_prices_the_per_operator_chain(
        h100_link, tmp_path, monkeypatch, rows, build_rows):
    """A join_agg morsel: the fused program at the region's own constants
    against the chain a declined morsel runs, the join where
    ``join_wins`` would put it (the host under the join's row floor) and
    then the host agg pass; both sides logged as ``fusion``."""
    log = tmp_path / "d.jsonl"
    monkeypatch.setenv("DAFT_TORCH_DISPATCH_LOG", str(log))
    up, down, hb = rows * 24.0, 9 * 8 * 1024.0, rows * 24.0
    win = cm.fusion_wins("join_agg", rows, up, down, 3, host_bytes=hb,
                         build_rows=build_rows)
    rec = json.loads(log.read_text().splitlines()[-1])
    jh, jd = cm._join_seconds(rows, build_rows, (rows + build_rows) * 9.0,
                              16.0 * max(rows, build_rows))
    join_s = jh if rows + build_rows < 8192 else min(jh, jd)
    assert rec["kind"] == "fusion" and rec["build_rows"] == build_rows
    assert rec["host_s"] == pytest.approx(join_s + hb / cm.HOST_AGG_BPS)
    assert rec["dev_s"] == pytest.approx(cm.link_profile().device_seconds(
        up, down, 2.0, cm.DEV_REGION_DISPATCH_S
        + rows / cm.DEV_REGION_JOIN_AGG_ROWS_PER_S))
    assert win == (rec["dev_s"] < rec["host_s"])


def test_join_agg_gate_follows_the_region_constants(h100_link, monkeypatch):
    """At the measured constants a 128Ki-row morsel stays on the
    per-operator chain (its join on the card); a program a hundred times
    faster would take it."""
    args = ("join_agg", 131072, 131072 * 24.0, 9 * 8 * 1024.0, 3)
    assert not cm.fusion_wins(*args, build_rows=1024)
    monkeypatch.setattr(cm, "DEV_REGION_DISPATCH_S",
                        cm.DEV_REGION_DISPATCH_S / 100)
    monkeypatch.setattr(cm, "DEV_REGION_JOIN_AGG_ROWS_PER_S",
                        cm.DEV_REGION_JOIN_AGG_ROWS_PER_S * 100)
    assert cm.fusion_wins(*args, build_rows=1024)
