"""The port's native host library (``daft_tpu_torch/native/``) held against
``daft_tpu.native`` and against its own numpy twins: the 12 cases of
``tests/test_native.py`` through both packages (hashes, fanout, MinHash
signatures, HyperLogLog registers and probe pairs equal exactly), each
twin equal to the library bit for bit, ``approx_count_distinct`` equal to
the reference's on 200,000 seeded integers, and the build's rules: two
processes building at once both load a whole library, and with
``DAFT_TORCH_NATIVE`` on a failed build raises with the compiler's
message rather than falling back.

The reference's answers for string hashes and ``approx_count_distinct``
depend on its own library having built, so every case that compares with
it first asserts ``daft_tpu.native.AVAILABLE``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import native as rnative
from daft_tpu.series import Series as RSeries
from daft_tpu_torch import native
from daft_tpu_torch.series import Series, _minhash_fallback, _xxh64_var

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


@pytest.fixture
def ref_native():
    assert rnative.AVAILABLE, (
        "daft_tpu.native did not build: the reference's string hashes and "
        "approx_count_distinct then take its fallback, which the port does "
        "not follow (g++ is needed on this machine)")
    return rnative


def _strings(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    words = np.array(["alpha", "beta", "gamma", "delta", "ε", "",
                      "a much longer word with spaces in it"])
    out = [" ".join(words[rng.integers(0, len(words), rng.integers(0, 9))])
           for _ in range(n)]
    for i in range(0, n, 97):
        out[i] = None
    return out


def _layout(vals):
    arr = pa.array(vals, pa.large_binary() if vals and isinstance(
        next((v for v in vals if v is not None), b""), bytes)
        else pa.large_string()).cast(pa.large_binary())
    b = arr.buffers()
    offsets = np.frombuffer(b[1], dtype=np.int64, count=len(arr) + 1)
    data = np.frombuffer(b[2], dtype=np.uint8) if b[2] is not None \
        else np.empty(0, dtype=np.uint8)
    valid = np.array([v is not None for v in vals])
    return offsets, data, valid


# ------------------------------------------- the reference's 12 cases

def test_xxh64_known_vectors(ref_native):
    assert native.xxh64(b"") == 0xEF46DB3751D8E999
    assert native.xxh64(b"Hello, world!") == 0xF58336A78B6F9476
    assert _xxh64_var(np.array([0, 0, 13], np.int64), np.frombuffer(
        b"Hello, world!", np.uint8)).tolist() == [0xEF46DB3751D8E999,
                                                   0xF58336A78B6F9476]


def test_hash_var_and_fixed_consistency(ref_native):
    off = np.array([0, 3, 6, 9], dtype=np.int64)
    data = np.frombuffer(b"abcxyzabc", dtype=np.uint8)
    h = native.hash_var(off, data, None)
    assert h[0] == h[2] and h[0] != h[1]
    assert np.array_equal(h, ref_native.hash_var(off, data, None))
    keys = np.array([7, 8, 7], dtype=np.int64)
    hf = native.hash_fixed(keys, None)
    assert hf[0] == hf[2] and hf[0] != hf[1]
    assert np.array_equal(hf, ref_native.hash_fixed(keys, None))
    valid = np.array([1, 0, 1], dtype=np.uint8)
    h2 = native.hash_var(off, data, valid)
    assert h2[0] == h[0] and h2[1] != h[1]
    assert np.array_equal(h2, ref_native.hash_var(off, data, valid))


def test_fanout_hash_covers_all_rows(ref_native):
    h = native.hash_fixed(np.arange(1000, dtype=np.int64), None)
    counts, idx = native.fanout_hash(h, 7)
    rc, ri = ref_native.fanout_hash(h, 7)
    assert np.array_equal(counts, rc) and np.array_equal(idx, ri)
    assert counts.sum() == 1000
    assert sorted(idx.tolist()) == list(range(1000))
    c2, _ = native.fanout_hash(
        native.hash_fixed(np.array([5, 5], dtype=np.int64), None), 7)
    assert (c2 > 0).sum() == 1


def test_series_hash_groups_equal_values(ref_native):
    vals = ["foo", "bar", "foo", None, None]
    h = Series.from_pylist(vals, "s").hash().to_pylist()
    assert h == RSeries.from_pylist(vals, "s").hash().to_pylist()
    assert h[0] == h[2] and h[0] != h[1]
    assert h[3] == h[4]


def test_partition_by_hash_recordbatch(ref_native):
    data = {"k": ["a", "b", "a", "c", "b", "a"], "v": [1, 2, 3, 4, 5, 6]}
    got = [p.to_pydict() for p in daft_tpu_torch.RecordBatch.from_pydict(
        data).partition_by_hash([daft_tpu_torch.col("k")], 4)]
    want = [p.to_pydict() for p in daft_tpu.RecordBatch.from_pydict(
        data).partition_by_hash([daft_tpu.col("k")], 4)]
    assert got == want
    assert sum(len(p["k"]) for p in got) == 6
    for key in ("a", "b", "c"):
        assert len([p for p in got if key in p["k"]]) == 1


def test_minhash_series_and_expression(ref_native):
    vals = ["the quick brown fox", "the quick brown fox",
            "lorem ipsum dolor", None]
    sig = Series.from_pylist(vals, "txt").minhash(num_hashes=16,
                                                  ngram_size=2)
    assert sig.datatype() == daft_tpu_torch.DataType.fixed_size_list(
        daft_tpu_torch.DataType.uint32(), 16)
    rows = sig.to_pylist()
    assert rows == RSeries.from_pylist(vals, "txt").minhash(
        num_hashes=16, ngram_size=2).to_pylist()
    assert rows[0] == rows[1] and rows[0] != rows[2] and rows[3] is None
    data = {"t": ["a b c", "a b c", "x y z"]}
    got, want = (p.from_pydict(data).select(p.col("t").minhash(
        num_hashes=8, ngram_size=1)).to_pydict()
        for p in (daft_tpu_torch, daft_tpu))
    assert got == want
    assert got["t"][0] == got["t"][1] != got["t"][2]


def test_minhash_jaccard_correlation(ref_native):
    vals = ["w1 w2 w3 w4 w5 w6 w7 w8", "w1 w2 w3 w4 w5 w6 xx yy",
            "z1 z2 z3 z4 z5 z6 z7 z8"]
    m = np.array(Series.from_pylist(vals, "t").minhash(
        num_hashes=128, ngram_size=1).to_pylist())
    assert m.tolist() == RSeries.from_pylist(vals, "t").minhash(
        num_hashes=128, ngram_size=1).to_pylist()
    assert (m[0] == m[1]).mean() > 0.4
    assert (m[0] == m[2]).mean() < 0.15


def test_hyperloglog_accuracy_and_merge(ref_native):
    h1 = native.hash_fixed(np.arange(0, 60000, dtype=np.int64), None)
    h2 = native.hash_fixed(np.arange(40000, 100000, dtype=np.int64), None)
    a = native.HyperLogLog().add_hashes(h1)
    b = native.HyperLogLog().add_hashes(h2)
    ra = ref_native.HyperLogLog().add_hashes(h1)
    assert a.estimate() == ra.estimate()
    assert abs(a.estimate() - 60000) / 60000 < 0.03
    a.merge(b)
    ra.merge(ref_native.HyperLogLog().add_hashes(h2))
    assert np.array_equal(a.registers, ra.registers)
    assert a.estimate() == ra.estimate()
    assert abs(a.estimate() - 100000) / 100000 < 0.03


def test_approx_count_distinct_agg(ref_native):
    import random
    random.seed(0)
    vals = [random.randrange(5000) for _ in range(20000)]
    truth = len(set(vals))
    got, want = (p.from_pydict({"x": vals}).agg(
        p.col("x").approx_count_distinct()).to_pydict()["x"][0]
        for p in (daft_tpu_torch, daft_tpu))
    assert got == want
    assert abs(got - truth) / truth < 0.05


def test_probe_table_pairs(ref_native):
    build = np.array([1, 2, 3, 2], dtype=np.int64)
    probe = np.array([2, 4, 1], dtype=np.int64)
    pt = native.ProbeTable(native.hash_fixed(build, None))
    pi, bi = pt.probe(native.hash_fixed(probe, None))
    rpi, rbi = ref_native.ProbeTable(
        ref_native.hash_fixed(build, None)).probe(
        ref_native.hash_fixed(probe, None))
    assert pi.tolist() == rpi.tolist() and bi.tolist() == rbi.tolist()
    assert sorted(zip(pi.tolist(), bi.tolist())) == [(0, 1), (0, 3), (2, 0)]


def test_murmur3_known_vector():
    assert native.murmur3_32(b"hello", 0) == 0x248BFA47


def test_minhash_fallback_matches_native():
    vals = ["the quick brown fox", "a  b", "a b", "", None, "single",
            "x " * 40 + "tail", "\tmulti\nline  text\r"]
    offsets, data, valid = _layout(vals)
    for nh, ng, sd in [(16, 2, 7), (4, 1, 1), (8, 3, 42)]:
        nat = native.minhash(offsets, data, valid, nh, ng, sd)
        assert np.array_equal(nat, _minhash_fallback(vals, nh, ng, sd))


# ------------------------------------------- the twins, bit for bit

def test_xxh64_twin_equals_library():
    vals = _strings()
    offsets, data, valid = _layout(vals)
    nat = native.hash_var(offsets, data, valid)
    twin = _xxh64_var(offsets, data)
    assert np.array_equal(nat[valid], twin[valid])
    assert (nat[~valid] == native.NULL_HASH).all()


def test_minhash_twin_equals_library():
    vals = _strings(400, seed=1)
    offsets, data, valid = _layout(vals)
    nat = native.minhash(offsets, data, valid, 16, 3, 42)
    assert np.array_equal(nat, _minhash_fallback(vals, 16, 3, 42))


@pytest.mark.parametrize("p", [4, 10, 14])
def test_hll_twin_equals_library(p):
    rng = np.random.default_rng(p)
    h = np.concatenate([rng.integers(0, 2 ** 63, 50000, dtype=np.uint64)
                        * np.uint64(2) + np.uint64(1),
                        np.zeros(3, np.uint64),
                        np.full(3, 2 ** 64 - 1, np.uint64)])
    for n in (0, 10, 1000, len(h)):
        a = native.HyperLogLog(p, native=True).add_hashes(h[:n])
        b = native.HyperLogLog(p, native=False).add_hashes(h[:n])
        assert np.array_equal(a.registers, b.registers)
        assert a.estimate() == b.estimate()
    c = native.HyperLogLog(p, native=False).add_hashes(h[:100])
    c.merge(native.HyperLogLog(p, native=False).add_hashes(h[100:]))
    assert np.array_equal(c.registers, b.registers)


def test_answers_do_not_depend_on_the_library(monkeypatch):
    """DAFT_TORCH_NATIVE=0 takes the numpy twins: the same hashes,
    signatures, fanout and approx_count_distinct."""
    vals = _strings(500, seed=2)
    data = {"s": vals, "k": list(range(len(vals)))}

    def run():
        df = daft_tpu_torch.from_pydict(data)
        return (df.select(daft_tpu_torch.col("s").hash().alias("h"),
                          daft_tpu_torch.col("s").minhash(
                              8, 2, 3).alias("m")).to_pydict(),
                df.agg(daft_tpu_torch.col("s").approx_count_distinct())
                .to_pydict(),
                [p.to_pydict() for p in daft_tpu_torch.RecordBatch
                 .from_pydict(data).partition_by_hash(
                     [daft_tpu_torch.col("s")], 5)])
    on = run()
    monkeypatch.setenv("DAFT_TORCH_NATIVE", "0")
    assert not native.available()
    assert run() == on


def test_approx_count_distinct_equals_reference(ref_native):
    """The reference counts with HyperLogLog over its library's hashes;
    the port counted exactly and gave 199,981 here."""
    x = np.random.default_rng(0).integers(0, 10 ** 9, 200_000).tolist()
    got, want = (p.from_pydict({"x": x}).agg(
        p.col("x").approx_count_distinct()).to_pydict()["x"][0]
        for p in (daft_tpu_torch, daft_tpu))
    assert want == 198_205
    assert got == want


def test_bpe_vocab_encodes_lowest_rank_merges(ref_native):
    toks = [b"a", b"b", b"c", b"ab", b"bc", b"abc"]
    ranks = [0, 1, 2, 3, 4, 5]
    v, rv = native.BpeVocab(toks, ranks), ref_native.BpeVocab(toks, ranks)
    for piece in (b"abc", b"abab", b"cba", b""):
        assert v.encode(piece).tolist() == rv.encode(piece).tolist()
    assert v.encode(b"abx") is None
    pieces = [b"ab", b"c", b"abcabc"]
    assert [x.tolist() for x in v.encode_batch(pieces)] == \
        [x.tolist() for x in rv.encode_batch(pieces)]


# ------------------------------------------- the build

def _child(body: str, env=None, cwd=None):
    code = textwrap.dedent(body)
    e = dict(os.environ)
    e.update(env or {})
    return subprocess.Popen([sys.executable, "-c", code], cwd=cwd or ROOT,
                            env=e, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_two_processes_building_at_once_load_a_whole_library(tmp_path):
    body = f"""
        import numpy as np
        from daft_tpu_torch import native
        native.BUILD_DIR = {str(tmp_path)!r}
        h = native.hash_var(np.array([0, 13], np.int64),
                            np.frombuffer(b"Hello, world!", np.uint8), None)
        assert h[0] == 0xF58336A78B6F9476, h
        print("ok", native.built)
    """
    procs = [_child(body) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("ok")
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert libs == [os.path.basename(native.library_path())]


def test_failed_build_raises_with_the_compilers_message(tmp_path):
    bad = tmp_path / "bin"
    bad.mkdir()
    gxx = bad / "g++"
    gxx.write_text("#!/bin/sh\necho 'kernels.cpp:1: error: bad compiler "
                   "here' >&2\nexit 3\n")
    gxx.chmod(0o755)
    body = f"""
        from daft_tpu_torch import native, series
        native.BUILD_DIR = {str(tmp_path / "build")!r}
        s = series.Series.from_pylist(["a", "b"], "s")
        try:
            s.hash()
        except native.NativeBuildError as e:
            print("raised", e)
        else:
            print("no error")
    """
    env = {"PATH": f"{bad}:{os.environ.get('PATH', '')}",
           "DAFT_TORCH_NATIVE": "1"}
    p = _child(body, env)
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err
    assert out.startswith("raised"), out
    assert "bad compiler here" in out and "exit 3" in out
    p = _child(body, dict(env, DAFT_TORCH_NATIVE="0"))
    out, err = p.communicate(timeout=120)
    assert out.startswith("no error"), (out, err)
