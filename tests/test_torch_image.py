"""The image functions of ROADMAP A8d (``daft_tpu_torch/functions/image.py``)
held against ``daft_tpu``:

- the three image cases of ``tests/test_functions.py`` (the pipeline
  decode → resize → to_mode → crop → encode, the batched resize against
  per-image PIL, and 16-bit pixels kept), each through both packages; the
  batched resizes of the two packages agree within the tolerance below;
- the batched resize program (``_resize_program``, the port of the
  reference's ``_get_resize_jit``) against ``jax.image.resize(...,
  "bilinear")`` in 64-bit mode (the reference's) at the shapes of ROADMAP
  B1.2: the f32 result within 1e-4, and after the clip and the cast to
  uint8 at most 1 apart, on at most 0.1% of the pixels;
- the cost model's gate (``costmodel.image_resize_wins``, the reference's
  two gate tests) and the planned declines (a batch below
  ``_RESIZE_BATCH_MIN``, a ragged batch), each logged as an
  ``image_resize`` host decision.
"""

import io
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.device import costmodel as cm
from daft_tpu_torch.functions import image as img_mod

PKGS = (daft_tpu, daft_tpu_torch)
PIL = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


def _close_u8(a: np.ndarray, b: np.ndarray) -> bool:
    """At most 1 apart, on at most 0.1% of the elements."""
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return a.shape == b.shape and int(d.max(initial=0)) <= 1 \
        and (d > 0).mean() <= 1e-3


# ---------------------------------------- tests/test_functions.py, replayed

def test_image_pipeline_decode_resize_mode_encode_crop():
    imgs = []
    for _ in range(2):
        a = (np.arange(100 * 80 * 3) % 255).astype(np.uint8) \
            .reshape(100, 80, 3)
        b = io.BytesIO()
        PIL.fromarray(a).save(b, format="PNG")
        imgs.append(b.getvalue())

    def run(p):
        c = p.col
        df = p.from_pydict({"b": imgs, "bbox": [[0, 0, 8, 6]] * 2})
        return (df.with_column("img", c("b").image.decode())
                .with_column("small", c("img").image.resize(16, 12))
                .with_column("gray", c("small").image.to_mode("L"))
                .with_column("cropped", c("small").image.crop(c("bbox")))
                .with_column("enc", c("gray").image.encode("png"))
                .to_pydict())
    ref, port = (run(p) for p in PKGS)
    for k in ("img", "small", "gray", "cropped"):
        assert all(np.array_equal(a, b) for a, b in zip(ref[k], port[k]))
    assert ref["enc"] == port["enc"]
    out = port
    assert out["small"][0].shape == (12, 16, 3)
    assert out["gray"][0].shape == (12, 16)
    assert out["cropped"][0].shape == (6, 8, 3)
    assert out["enc"][0][:4] == b"\x89PNG"


def test_image_resize_batched_device_path_matches_pil(monkeypatch):
    """A uniform batch at or above the floor takes the one-program resize
    in both packages (spied on: a quiet fall back to PIL fails); the two
    agree, nulls survive, and the values stay near PIL's."""
    from daft_tpu.functions import image as ref_img
    monkeypatch.setenv("DAFT_TPU_DEVICE_FORCE", "1")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    calls = []
    for mod in (ref_img, img_mod):
        orig = mod._device_batch_resize

        def spy(imgs, w, h, orig=orig):
            out = orig(imgs, w, h)
            calls.append(out is not None)
            return out
        monkeypatch.setattr(mod, "_device_batch_resize", spy)
    base = (np.arange(24 * 32 * 3) % 255).astype(np.uint8).reshape(24, 32, 3)
    imgs = [base.copy() for _ in range(9)] + [None]
    ref, port = (p.from_pydict({"img": imgs})
                 .select(p.col("img").image.resize(16, 12))
                 .to_pydict()["img"] for p in PKGS)
    assert calls == [True, True], "a device batch path did not run"
    assert port[-1] is None and ref[-1] is None
    assert all(o.shape == (12, 16, 3) and o.dtype == np.uint8
               for o in port[:-1])
    assert _close_u8(np.stack(ref[:-1]), np.stack(port[:-1]))
    want = np.asarray(PIL.fromarray(base).resize((16, 12)))
    assert np.abs(port[0].astype(int) - want.astype(int)).mean() < 12


def test_image_resize_uint16_values_preserved():
    """Integer dtypes clamp to their own range on the device path: 16-bit
    pixels above 255 survive."""
    base = np.full((8, 8), 40_000, dtype=np.uint16)
    imgs = [base.copy() for _ in range(10)]
    for p in PKGS:
        out = p.from_pydict({"img": imgs}) \
            .select(p.col("img").image.resize(4, 4)).to_pydict()["img"]
        assert all(o.dtype == np.uint16 for o in out)
        assert all((o == 40_000).all() for o in out)


# ------------------------------------------ the resize against jax (B1.2)

@pytest.mark.parametrize("src,dst", [
    ((64, 48), (32, 24)), ((37, 53), (16, 29)), ((64, 48), (100, 80)),
    ((256, 256), (224, 224)), ((64, 64), (17, 40))])
def test_resize_program_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(src[0] * 1000 + dst[1])
    (H, W), (h, w) = src, dst
    x = rng.integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    # as the reference runs it: its device tier turns 64-bit mode on at
    # import, so jax computes the weight matrices in f64 (the port too)
    with jax.enable_x64(True):
        want = jax.image.resize(jnp.asarray(x, jnp.float32), (3, h, w, 3),
                                method="bilinear")
        want_u8 = np.asarray(jnp.clip(want, 0, 255).astype(jnp.uint8))
    got = img_mod._resize_program(torch.from_numpy(x), h, w, None, None,
                                  torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    got_u8 = img_mod._resize_program(torch.from_numpy(x), h, w, 0.0, 255.0,
                                     torch.uint8).numpy()
    assert got_u8.dtype == np.uint8
    assert _close_u8(got_u8, want_u8)


def test_resize_series_matches_reference_grayscale_and_float(monkeypatch):
    """2-D (grayscale) batches and float batches (no clip) through both
    packages' device paths (PIL resizes no float RGB image)."""
    monkeypatch.setenv("DAFT_TPU_DEVICE_FORCE", "1")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    rng = np.random.default_rng(5)
    for imgs in ([rng.integers(0, 256, (20, 30), dtype=np.uint8)
                  for _ in range(8)],
                 [rng.random((20, 30, 3), dtype=np.float32) * 300
                  for _ in range(8)]):
        ref, port = (p.from_pydict({"img": imgs})
                     .select(p.col("img").image.resize(11, 7))
                     .to_pydict()["img"] for p in PKGS)
        r, g = np.stack(ref), np.stack(port)
        assert r.shape == g.shape and r.dtype == g.dtype
        if g.dtype == np.uint8:
            assert _close_u8(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * 300)


# --------------------------------------------------- gates and declines

@pytest.fixture
def slow_link(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_LINK_RTT_MS", "100")
    monkeypatch.setenv("DAFT_TORCH_LINK_UP_MBPS", "10")
    monkeypatch.setenv("DAFT_TORCH_LINK_DOWN_MBPS", "10")
    cm.reset_for_tests()
    yield
    cm.reset_for_tests()


def test_image_resize_gate(slow_link):
    # a 50 MB batch over a 10 MB/s link (~5 s) vs PIL (~0.3 s): the host
    # keeps it
    assert not cm.image_resize_wins(50e6, 12.5e6)


def test_image_resize_gate_local_chip(monkeypatch):
    # a fast local link: the batched device resize wins by orders of
    # magnitude
    monkeypatch.setenv("DAFT_TORCH_LINK_RTT_MS", "0.01")
    monkeypatch.setenv("DAFT_TORCH_LINK_UP_MBPS", "50000")
    monkeypatch.setenv("DAFT_TORCH_LINK_DOWN_MBPS", "50000")
    cm.reset_for_tests()
    try:
        assert cm.image_resize_wins(50e6, 12.5e6)
    finally:
        cm.reset_for_tests()


def test_gate_matches_reference(slow_link, monkeypatch):
    """Equal inputs, equal links, the reference's constants: equal
    answers."""
    from daft_tpu.device import costmodel as ref_cm
    monkeypatch.setenv("DAFT_TPU_LINK_RTT_MS", "100")
    monkeypatch.setenv("DAFT_TPU_LINK_UP_MBPS", "10")
    monkeypatch.setenv("DAFT_TPU_LINK_DOWN_MBPS", "10")
    ref_cm.reset_for_tests()
    monkeypatch.setattr(cm, "DEV_VECTOR_BPS", ref_cm.DEV_VECTOR_BPS)
    monkeypatch.setattr(cm, "HOST_PIL_BPS", ref_cm.HOST_PIL_BPS)
    monkeypatch.setattr(cm, "DEV_DISPATCH_S", ref_cm.DEV_DISPATCH_S)
    try:
        for up in (1e5, 1e6, 5e6, 5e7, 5e8):
            assert cm.image_resize_wins(up, up / 4) \
                == ref_cm.image_resize_wins(up, up / 4)
    finally:
        ref_cm.reset_for_tests()


def test_declines_are_logged_and_run_on_the_host(monkeypatch, tmp_path):
    """Below the floor and ragged batches decline before any pricing, each
    counted as an ``image_resize`` host decision with its reason; the
    per-image path answers as the reference's."""
    log = tmp_path / "d.jsonl"
    monkeypatch.setenv("DAFT_TORCH_DISPATCH_LOG", str(log))
    cm.reset_decision_counts()
    small = [np.zeros((6, 6, 3), np.uint8) + i for i in range(3)]
    ragged = [np.zeros((6 + i % 2, 6, 3), np.uint8) for i in range(9)]
    for imgs in (small, ragged):
        ref, port = (p.from_pydict({"img": imgs})
                     .select(p.col("img").image.resize(3, 3))
                     .to_pydict()["img"] for p in PKGS)
        assert all(np.array_equal(a, b) for a, b in zip(ref, port))
    assert cm.decision_counts_snapshot()["image_resize"] == \
        {"device": 0, "host": 2}
    import json
    reasons = [json.loads(x)["reason"] for x in log.read_text().splitlines()
               if json.loads(x)["kind"] == "image_resize"]
    assert reasons == ["batch_min", "ragged"]


def test_host_tier_runs_per_image(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    imgs = [np.full((10, 10, 3), 7, np.uint8) for _ in range(9)]
    assert img_mod._device_batch_resize(imgs, 5, 5) is None
    out = daft_tpu_torch.from_pydict({"img": imgs}) \
        .select(daft_tpu_torch.col("img").image.resize(5, 5)) \
        .to_pydict()["img"]
    assert all(o.shape == (5, 5, 3) and (o == 7).all() for o in out)


def test_image_rows_keep_their_element_type():
    """Rows read back from an image column are arrays of its element type
    (uint8 for RGB), read without a Python object per pixel; the
    reference's rows hold the same values as int64 (ROADMAP Queue C
    caveats)."""
    pngs = []
    for i in range(3):
        b = io.BytesIO()
        PIL.fromarray(np.full((4, 5, 3), 40 * i, np.uint8)).save(
            b, format="PNG")
        pngs.append(b.getvalue())
    ref, port = (p.from_pydict({"b": pngs}).select(
        p.col("b").image.decode(mode="RGB").alias("img")).to_pydict()["img"]
        for p in PKGS)
    assert all(np.array_equal(a, b) for a, b in zip(ref, port))
    assert {a.dtype for a in port} == {np.dtype(np.uint8)}
    assert all(a.shape == (4, 5, 3) for a in port)


def test_image_rows_are_writable():
    """A row read back from an image column is the caller's own array: a
    UDF may write into it (normalise it in place), as into the
    reference's rows, and the column keeps its values."""
    imgs = [np.full((3, 4, 3), 50 + i, np.uint8) for i in range(2)]
    for p in PKGS:
        df = p.from_pydict({"img": imgs}).select(
            p.col("img").cast(p.DataType.image("RGB"))).collect()
        assert df.schema()["img"].dtype == p.DataType.image("RGB")
        rows = df.to_pylist()
        for r in rows:
            r["img"][0, 0, 0] = 255
            r["img"] //= 2
        assert [int(r["img"][1, 1, 1]) for r in rows] == [25, 25]
        assert [int(r["img"][0, 0, 0]) for r in rows] == [127, 127]
        again = df.to_pydict()["img"]
        assert [int(a[0, 0, 0]) for a in again] == [50, 51]


def test_tensor_rows_with_null_values_keep_their_element_type():
    """A tensor row holding null values reads back as a masked array of
    the column's element type, its nulls masked (the reference: an object
    array with None there); such rows, put back, make a Python column in
    both packages (ROADMAP Queue C caveats)."""
    rows = {}
    for p in PKGS:
        S = import_module(p.__name__ + ".series").Series
        dt = p.DataType.tensor(p.DataType.int32())
        phys = S.from_pylist([np.zeros(3, np.int32),
                              np.zeros((2, 2), np.int32)], "t",
                             dtype=dt).to_arrow()
        data = pa.array([[1, None, 3], [4, 5, 6, 7]],
                        phys.type.field("data").type)
        arr = pa.StructArray.from_arrays([data, phys.field("shape")],
                                         ["data", "shape"])
        got = S("t", dt, arrow=arr).to_pylist()
        back = S.from_pylist(got, "t", dtype=dt)
        assert back.datatype() == p.DataType.python()
        rows[p.__name__] = got
    ref, port = rows["daft_tpu"], rows["daft_tpu_torch"]
    assert ref[0].tolist() == [1, None, 3]
    assert np.ma.isMaskedArray(port[0]) and port[0].dtype == np.int32
    assert port[0].mask.tolist() == [False, True, False]
    assert port[0].tolist() == ref[0].tolist()
    assert port[1].dtype == np.int32 and np.array_equal(port[1], ref[1])
    assert port[1].flags.writeable and port[0].data.flags.writeable
