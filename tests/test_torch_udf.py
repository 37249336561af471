"""Stateful UDFs, tokenize, the torch bridges and the rest of ROADMAP A8d
held against ``daft_tpu``:

- the ``UDFProject`` node: logical trees (unoptimized and optimized) and
  physical trees equal to the reference's, concurrency carried through
  the optimizer's column pruning;
- the actor pool: ``concurrency`` processes that are not the caller, one
  in-process instance for a Python-object column; an error raised inside
  an actor reaches the caller (the reference instead re-runs the batch
  on its in-process instance: the port's one deliberate difference here);
- tokenize: ids and decodes equal to the reference's over a seeded
  vocabulary and text, with the native library and with its Python merge
  loop (``DAFT_TORCH_NATIVE=0``), and the SQL functions;
- ``to_torch_map_dataset`` / ``to_torch_iter_dataset`` equal to the
  reference's; ``map_groups`` raising the reference's error; the pivot's
  planning probe through ``runners/runner_io.py``;
- a subprocess that runs a tokenize, a stateful UDF and an Iceberg read
  through ``daft_tpu_torch`` with ``jax`` never imported.
"""

import base64
import os
import subprocess
import sys

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch

PKGS = (daft_tpu, daft_tpu_torch)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


def _both(fn):
    ref, port = (fn(p) for p in PKGS)
    assert port == ref
    return ref


class _Scale:
    def __init__(self, k=1):
        self.k = k
        self.pid = os.getpid()

    def __call__(self, x):
        return [v * self.k for v in x.to_pylist()]


class _Pid:
    def __init__(self):
        self.pid = os.getpid()

    def __call__(self, x):
        return [self.pid] * len(x)


class _Raises:
    def __call__(self, x):
        raise ValueError("bad batch")


# ------------------------------------------------------------ UDFProject

def _sig(n):
    t = type(n).__name__
    extra = ()
    if t == "UDFProject":
        extra = (n.concurrency, tuple(e.name() for e in n.exprs))
    elif t == "Project":
        extra = (tuple(e.name() for e in n.exprs),)
    return (t,) + extra + (tuple(_sig(c) for c in n.children),)


def _plans(p):
    from importlib import import_module
    tr = import_module(f"{p.__name__}.physical.translate")
    scale = p.udf(return_dtype=p.DataType.int64(), concurrency=2)(_Scale)
    df = (p.from_pydict({"x": [1, 2, 3], "y": [4, 5, 6], "w": [0, 0, 0]})
          .with_column("z", scale.with_init_args(3)(p.col("x")))
          .where(p.col("y") > 4).select("z", "y"))
    b = df._builder
    raw = b._plan if p is daft_tpu else b.plan
    opt = b.optimize()._plan if p is daft_tpu else b.optimize().plan
    return _sig(raw), _sig(opt), _sig(tr.translate(opt))


def test_udf_project_trees_equal_the_reference():
    raw, opt, phys = _both(_plans)
    assert raw[0] == "Project" and raw[-1][0][-1][0][0] == "UDFProject"
    assert any("UDFProject" in str(s) for s in (opt, phys))
    # pruning keeps the node and its concurrency
    assert "('UDFProject', 2, ('y', 'z')" in str(opt)


def test_stateless_udfs_plan_plain_projects():
    def run(p):
        double = p.udf(return_dtype=p.DataType.int64())(
            lambda x: [v * 2 for v in x.to_pylist()])
        return _plans_of(p, p.from_pydict({"x": [1]}).select(
            double(p.col("x")).alias("y")))
    assert _both(run)[0] == "Project"


def _plans_of(p, df):
    b = df._builder
    return _sig(b._plan if p is daft_tpu else b.plan)


# ------------------------------------------------------------ actor pool

def test_pool_runs_in_concurrency_processes_and_answers_alike():
    def run(p):
        scale = p.udf(return_dtype=p.DataType.int64(), concurrency=2)(_Scale)
        df = p.from_pydict({"x": list(range(40))}).into_partitions(4)
        return sorted(df.select(scale.with_init_args(5)(p.col("x"))
                                .alias("y")).to_pydict()["y"])
    assert _both(run) == [5 * i for i in range(40)]
    pid = daft_tpu_torch.udf(return_dtype=daft_tpu_torch.DataType.int64(),
                             concurrency=2)(_Pid)
    df = daft_tpu_torch.from_pydict({"x": list(range(64))}).into_partitions(8)
    pids = set(df.select(pid(daft_tpu_torch.col("x")).alias("p"))
               .to_pydict()["p"])
    assert os.getpid() not in pids and len(pids) == 2
    pool = pid._get_pool()
    assert sorted(pool.pids) == sorted(pids)
    pool.shutdown()
    assert not any(a.process.is_alive() for a in pool._actors)


def test_python_object_columns_stay_in_process():
    """Arrow IPC cannot carry Python objects: such a batch runs on the one
    in-process instance, as in the reference."""
    def run(p):
        pid = p.udf(return_dtype=p.DataType.int64(), concurrency=2)(_Pid)
        objs = [object(), object()]
        out = p.from_pydict({"o": objs}).select(
            pid(p.col("o")).alias("p")).to_pydict()["p"]
        if p is daft_tpu_torch:
            # no batch could cross to an actor, so no pool was started
            assert pid._pool == "unset"
        return set(out) == {os.getpid()}
    assert _both(run)


def test_actor_error_reaches_the_caller():
    raises = daft_tpu_torch.udf(
        return_dtype=daft_tpu_torch.DataType.int64())(_Raises)
    df = daft_tpu_torch.from_pydict({"x": [1, 2]})
    with pytest.raises(RuntimeError, match="bad batch"):
        df.select(raises(daft_tpu_torch.col("x")).alias("y")).to_pydict()
    raises._get_pool().shutdown()


# -------------------------------------------------------------- tokenize

def _vocab(tmp_path):
    words = ["he", "ll", "hell", "hello", " w", " wo", "or", "ld", " world",
             "ab", "abc", " ab"]
    toks = [bytes([i]) for i in range(256)] + [w.encode() for w in words]
    path = tmp_path / "v.tiktoken"
    path.write_text("".join(f"{base64.b64encode(t).decode()} {i}\n"
                            for i, t in enumerate(toks)))
    return str(path)


@pytest.mark.parametrize("native", ["1", "0"])
def test_tokenize_matches_the_reference(tmp_path, monkeypatch, native):
    monkeypatch.setenv("DAFT_TORCH_NATIVE", native)
    path = _vocab(tmp_path)
    rng = np.random.default_rng(3)
    alphabet = list("helo wrdabcxyz\n\té'")
    texts = ["".join(rng.choice(alphabet, rng.integers(0, 30)))
             for _ in range(60)] + [None, "hello world", "abc ab"]

    def run(p):
        df = p.from_pydict({"s": texts})
        out = df.select(p.col("s").str.tokenize_encode(path).alias("ids"),
                        p.col("s").str.tokenize_encode().alias("b"))
        back = out.select(
            p.col("ids").str.tokenize_decode(path).alias("d"),
            p.col("b").str.tokenize_decode("bytes").alias("db")).to_pydict()
        return out.to_pydict(), back
    (enc, back) = _both(run)
    assert back["d"] == texts and back["db"] == texts
    assert enc["ids"][-2] == [256 + 3, 256 + 8]


def test_tokenize_sql_functions_match_the_reference(tmp_path):
    path = _vocab(tmp_path)
    q = (f"SELECT tokenize_encode(s, '{path}') AS ids, "
         f"tokenize_decode(tokenize_encode(s, '{path}'), '{path}') AS d "
         f"FROM t")
    out = _both(lambda p: p.sql(q, t=p.from_pydict(
        {"s": ["hello world", "abc"]})).to_pydict())
    assert out["d"] == ["hello world", "abc"]


def test_tokenize_pattern_kind_follows_regex():
    from daft_tpu_torch.functions import tokenize
    try:
        import regex  # noqa: F401
        want = "unicode"
    except ImportError:
        want = "ascii"
    assert tokenize.PATTERN_KIND == want


# ------------------------------------------------- bridges, map_groups, pivot

def test_torch_datasets_match_the_reference():
    import torch.utils.data

    def run(p):
        df = p.from_pydict({"a": [1, 2, 3, 4, 5], "b": list("vwxyz")})
        m = df.to_torch_map_dataset()
        it = df.to_torch_iter_dataset()
        # the port's bridges are datasets; the reference's hold one
        rows = list(torch.utils.data.DataLoader(
            it if p is daft_tpu_torch else it._ds, batch_size=None))
        return len(m), [m[i] for i in range(len(m))], rows
    n, mapped, it = _both(run)
    assert n == 5 and mapped == it == daft_tpu_torch.from_pydict(
        {"a": [1, 2, 3, 4, 5], "b": list("vwxyz")}).to_pylist()


def test_map_groups_raises_as_the_reference():
    for p in PKGS:
        g = p.from_pydict({"g": [1], "v": [2]}).groupby("g")
        with pytest.raises(NotImplementedError, match="actor pools"):
            g.map_groups(p.col("v"))


def test_pivot_probe_goes_through_runner_io(monkeypatch):
    from daft_tpu_torch.runners import runner_io
    seen = []
    orig = runner_io.materialize_for_planning

    def spy(b):
        out = orig(b)
        seen.append(sorted(out))
        return out
    monkeypatch.setattr(runner_io, "materialize_for_planning", spy)
    out = _both(lambda p: p.from_pydict(
        {"g": [1, 1, 2], "k": ["a", "b", "a"], "v": [1, 2, 3]})
        .pivot("g", "k", "v", "sum").sort("g").to_pydict())
    assert seen == [["a", "b"]] and out["a"] == [1, 3]


# ---------------------------------------------------------- stands alone

_ALONE = r"""
import base64, os, sys
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
sys.path.insert(0, os.getcwd())
import daft_tpu_torch as dt


class Doubler:
    def __call__(self, x):
        return [2 * v for v in x.to_pylist()]


root = sys.argv[1]
path = os.path.join(root, "v.tiktoken")
with open(path, "w") as f:
    for i in range(256):
        f.write(base64.b64encode(bytes([i])).decode() + f" {i}\n")
df = dt.from_pydict({"s": ["ab cd", "ef"], "x": [1, 2]})
ids = df.select(dt.col("s").str.tokenize_encode(path).alias("i")).to_pydict()
assert ids["i"][1] == [101, 102], ids
scale = dt.udf(return_dtype=dt.DataType.int64(), concurrency=1)(Doubler)
out = df.select(scale(dt.col("x")).alias("y")).to_pydict()
assert out["y"] == [2, 4], out
df.write_iceberg(os.path.join(root, "ice"))
assert dt.read_iceberg(os.path.join(root, "ice")).to_pydict()["x"] == [1, 2]
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "daft_tpu" or m.startswith("daft_tpu."))
assert not leaked, leaked
print("ALONE OK")
"""


def test_tokenize_udf_and_iceberg_run_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _ALONE, str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True, timeout=180,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ALONE OK" in r.stdout
