"""The port's registry of hand-written CUDA entry points
(``daft_tpu_torch/analysis/dispatch_registry.py``), the counterpart of
``daft_tpu/analysis/dispatch_registry.py``: it declares every
``extern "C"`` entry of ``csrc/*.cu`` with its binding, wrapper, plain
twin, launch counter and TPU source, and fails on an undeclared or a
stale site. The negative cases edit a copy of the package."""

import os
import re
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reg():
    from daft_tpu_torch.analysis import dispatch_registry
    return dispatch_registry


@pytest.fixture
def tree(tmp_path):
    """A copy of the port's package to break."""
    shutil.copytree(os.path.join(REPO, "daft_tpu_torch"),
                    tmp_path / "daft_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return tmp_path


def _edit(root, rel, old, new):
    path = os.path.join(root, rel)
    with open(path) as f:
        text = f.read()
    assert old in text, (rel, old)
    with open(path, "w") as f:
        f.write(text.replace(old, new, 1))


def _rules(found):
    return sorted({rule for rule, _ in found})


def test_every_entry_point_declared_and_the_table_honest():
    reg = _reg()
    in_src = reg.source_entries(REPO)
    assert sorted(in_src) == sorted(e.entry for e in reg.ENTRIES) == [
        "daft_device_info", "daft_hash_agg_build", "daft_hash_join_build",
        "daft_hash_join_probe"]
    assert reg.findings(REPO) == []
    kernels = [e for e in reg.ENTRIES if e.kind == "kernel"]
    assert len(kernels) == 3
    assert [e.launches for e in reg.ENTRIES if e.kind == "query"] == [None]


def test_entries_name_the_tpu_kernels_they_replace():
    """Each kernel's TPU source is a ``pl.pallas_call`` function of the
    reference at the line it names, with its row in ``PERF.md`` §6."""
    reg = _reg()
    with open(os.path.join(REPO, "daft_tpu/device/pallas_kernels.py")) as f:
        pallas = f.read().splitlines()
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    for e in reg.ENTRIES:
        if e.kind != "kernel":
            continue
        m = re.fullmatch(r"(\S+):(\w+) \(:(\d+)\)", e.replaces)
        path, func, line = m.group(1), m.group(2), int(m.group(3))
        assert path == "daft_tpu/device/pallas_kernels.py"
        assert pallas[line - 1].startswith(f"def {func}("), e
        assert f"`{func}` (:{line}" in perf, e


def test_an_undeclared_entry_in_the_sources_is_found(tree):
    reg = _reg()
    _edit(tree, "daft_tpu_torch/csrc/hash_join.cu",
          'extern "C" int daft_hash_join_probe(',
          'extern "C" int daft_hash_join_extra(void* stream) { return 0; }\n'
          'extern "C" int daft_hash_join_probe(')
    found = reg.findings(str(tree))
    assert _rules(found) == ["dispatch-site-unregistered"], found
    assert "daft_hash_join_extra" in found[0][1]


def test_an_undeclared_binding_is_found(tree):
    reg = _reg()
    _edit(tree, "daft_tpu_torch/device/runtime.py", '"""',
          '"""\n# cuda_build.library().daft_hash_agg_build\n', )
    found = reg.findings(str(tree))
    assert _rules(found) == ["dispatch-site-unregistered"], found
    _edit(tree, "daft_tpu_torch/device/cuda_build.py",
          '"daft_device_info": [_P],',
          '"daft_device_info": [_P],\n    "daft_other": [_P],')
    assert any("daft_other" in d for _, d in reg.findings(str(tree)))


def test_a_stale_declaration_is_found(tree):
    reg = _reg()
    import dataclasses
    ghost = dataclasses.replace(reg.ENTRIES[0], id="ghost",
                                entry="daft_gone")
    found = reg.findings(str(tree), reg.ENTRIES + (ghost,))
    assert _rules(found) == ["dispatch-site-stale"], found
    assert all("daft_gone" in d for _, d in found)
    _edit(tree, "daft_tpu_torch/device/join_kernels.py",
          "def hash_join_probe_plain(", "def hash_join_probe_plain_v2(")
    found = reg.findings(str(tree))
    assert found == [("dispatch-site-stale",
                      "hash_join.probe: plain daft_tpu_torch/device/"
                      "join_kernels.py:hash_join_probe_plain is gone")]


def test_a_removed_kernel_entry_is_stale(tree):
    reg = _reg()
    _edit(tree, "daft_tpu_torch/csrc/hash_join.cu",
          'extern "C" int daft_hash_join_probe(',
          'static int daft_hash_join_probe_static(')
    found = reg.findings(str(tree))
    assert _rules(found) == ["dispatch-site-stale"], found


def test_a_second_compile_site_is_found(tree):
    reg = _reg()
    _edit(tree, "daft_tpu_torch/device/runtime.py", '"""',
          '"""\n\ndef _build():\n    from . import cuda_build\n'
          '    return cuda_build.compile_library([], "x.so")\n')
    found = reg.findings(str(tree))
    assert _rules(found) == ["compile-site-unregistered"], found
