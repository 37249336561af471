"""The reference's own tests of the modules ROADMAP A8d and A8e port,
replayed against ``daft_tpu_torch``: ``tests/test_actor_pool.py``,
``test_tokenize.py``, ``test_delta.py``, ``test_iceberg.py``,
``test_hudi.py``, ``test_lance.py`` and ``test_catalog_unity.py``.

Each file's source is compiled with ``daft_tpu`` replaced by
``daft_tpu_torch``, ``DAFT_TPU_`` knobs by their ``DAFT_TORCH_`` names
and ``native.AVAILABLE`` by ``native.available()``, and every ``test_*``
function in it runs with its fixtures (the file's own, and ``tmp_path``,
``tmp_path_factory``, ``monkeypatch``), its assertions unchanged. The reference side runs in the reference's own
files; ``tests/test_torch_lake.py`` and ``tests/test_torch_udf.py`` hold
the two packages' answers against each other. The replayed module is not
registered in ``sys.modules``, so ``cloudpickle`` ships the actor-pool
file's UDF classes to the actors by value, as it ships a class its
``@udf`` wrapper shadows.
"""

import ast
import contextlib
import inspect
import os
import re

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
FILES = ("test_actor_pool.py", "test_tokenize.py", "test_delta.py",
         "test_iceberg.py", "test_hudi.py", "test_lance.py",
         "test_catalog_unity.py")


def _cases():
    out = []
    for f in FILES:
        tree = ast.parse(open(os.path.join(TESTS, f)).read())
        out += [(f, n.name) for n in tree.body
                if isinstance(n, ast.FunctionDef)
                and n.name.startswith("test_")]
    return out


def port_source(fname: str) -> str:
    """The reference test file's source, pointed at the port."""
    src = open(os.path.join(TESTS, fname)).read()
    src = re.sub(r"\bdaft_tpu\b", "daft_tpu_torch", src)
    src = src.replace("DAFT_TPU_", "DAFT_TORCH_")
    # the port builds its native library at first use, never at import:
    # ``available()`` asks (and builds), where the reference has a flag
    src = src.replace("native.AVAILABLE", "native.available()")
    # fixtures are resolved here, by name, and called as plain functions
    return re.sub(r"^@pytest\.fixture.*$", "", src, flags=re.M)


_LOADED = {}


def _load(fname: str) -> dict:
    if fname not in _LOADED:
        ns = {"__name__": f"replay_port_{fname[:-3]}"}
        exec(compile(port_source(fname), os.path.join(TESTS, fname),
                     "exec"), ns)
        _LOADED[fname] = ns
    return _LOADED[fname]


@pytest.mark.parametrize("fname,test", _cases(),
                         ids=[f"{f[:-3]}::{t}" for f, t in _cases()])
def test_reference_test_on_the_port(fname, test, tmp_path, tmp_path_factory,
                                    monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    ns = _load(fname)
    given = {"tmp_path": tmp_path, "tmp_path_factory": tmp_path_factory,
             "monkeypatch": monkeypatch}
    with contextlib.ExitStack() as stack:
        def resolve(fn):
            kw = {}
            for p in inspect.signature(fn).parameters:
                if p not in given:
                    given[p] = resolve(ns[p])
                kw[p] = given[p]
            out = fn(**kw)
            if inspect.isgenerator(out):
                gen = out
                out = next(gen)
                stack.callback(lambda: next(gen, None))
            return out
        resolve(ns[test])


def test_every_reference_case_is_replayed():
    """53 cases: actor pool 5, tokenize 7, Delta 7, Iceberg 11, Hudi 10,
    Lance 9, Unity 4."""
    counts = {}
    for f, _ in _cases():
        counts[f] = counts.get(f, 0) + 1
    assert counts == {"test_actor_pool.py": 5, "test_tokenize.py": 7,
                      "test_delta.py": 7, "test_iceberg.py": 11,
                      "test_hudi.py": 10, "test_lance.py": 9,
                      "test_catalog_unity.py": 4}
