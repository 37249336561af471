"""Phase 7p of ``chip_smoke.py``: the multimodal and text pipelines of
ROADMAP A8d on the card, held to numpy and pyarrow oracles. Alone, from
the repository root on a machine with a CUDA card:

    python3 daft_tpu_torch/benchmarking/multimodal_phase.py [--runs N]

(builds the kernels and the native library, generates the SF1 files into
``.cache/`` with ``chip_smoke.tpch_root``, runs the phase N times, then
holds its hash and join rungs against the plain versions as phase 8
does; exits non-zero when a check fails).

The phase:

(a) images: 4,096 RGB images of 256x256 from the LAION-style generator of
    ``bench.py``'s ``_gen_laion`` (seed 7, the label the dominant channel;
    PNG bytes kept in ``.cache/laion_256_4096/``) → ``image.decode`` →
    ``image.resize(224, 224)`` (one batch: 805 MB up, 617 MB down) → the
    stateful :class:`ImageEmbedder` (a seeded 150,528 → 128 f32 random
    projection on the card; each image's cosine to a seeded query and its
    cluster, the argmax over 64 seeded centroids) → group by label and by
    cluster (mean cosine, count). The decode runs once; resize, embedding
    and group-bys run at the default knobs and at
    ``DAFT_TORCH_DEVICE_FORCE=1``. Held: a seeded sample of 512 images
    resized by the plain torch program on CPU tensors against the card's
    program in f32 (1e-4) and against the pipeline's uint8 images (at
    most 1 apart, and only where the f32 value lies within 1e-4 of an
    integer, which the cast truncates to either side), every cosine (1e-4)
    and cluster
    to numpy over the same resized arrays (a cluster may differ only where
    numpy's top-two margin is below 1e-6, and those rows are counted), the
    group-bys to pyarrow over the UDF's own outputs (keys and counts
    exactly, means within the worst-case bound of any summation order).
    The resize program is timed alone with CUDA events over the whole
    batch, beside its bound: the larger of its bytes over the memory rate
    and the resize's operations (a multiply-add per nonzero tap of the
    weights) over the f32 rate; the line also gives the operations of the
    program's dense contractions. Without Pillow the phase starts from
    the generator's arrays
    (``mm codec: no Pillow``): decode is skipped, the rest runs;
(b) text: a tiktoken-format vocabulary (the 256 single bytes, then
    ``o_comment``'s words with and without a leading space) over the first
    two of the eight SF1 ``orders`` files → ``str.tokenize_encode`` →
    ``explode`` → group by token (count; a hash-agg build on integer
    keys) → join to the vocabulary table (join build and probe) →
    ``tokenize_decode`` of the lists, equal to the comments. The stateful
    :class:`TokenEmbedder` (``concurrency=2``, ``batch_size=8192``: two
    spawned actors, each with a seeded embedding table on the query's
    device, passed to it) gives each comment a cluster over 256 centroids
    in f64, its actor's pid and its table's device type (two distinct
    pids, neither the parent's; on the card both tables ``cuda``, logged
    as ``actor_devices``); its clusters are held to
    the same class run in the parent on the CPU, then group by cluster
    (count, mean ``o_totalprice``) joined back to the orders. The group-by
    and join steps run at the default and the forced knobs (the latter
    with ``DAFT_TORCH_DEVICE_JOIN=1`` too);
(c) bridges: ``to_torch_iter_dataset`` under a ``DataLoader`` and
    ``to_torch_map_dataset`` over the image results, equal to
    ``to_pylist()``.

Each step prints an ``mm`` line: its wall, rows in and out, the cost
model's decisions, the device tier's dispatch counts and the launches
per kernel. The actor pool is shut down at the end (its CUDA contexts
close with it). Nothing here imports ``jax`` or ``daft_tpu``.
"""

from __future__ import annotations

import base64
import glob
import io
import json
import os
import sys
import time

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

#: the image batch: count, side, resized side, and the generator's seed
IMG_N, IMG_PX, IMG_OUT, IMG_SEED = 4096, 256, 224, 7
EMB_OUT, IMG_CENTROIDS, IMG_EMB_SEED = 128, 64, 3
#: resized images held to the plain program on CPU tensors (a seeded
#: sample; the CPU program takes about 1 ms an image)
RESIZE_CHECK = 512
#: one H100's f32 rate outside the tensor cores (NVIDIA's data sheet, SXM,
#: at 700 W): the resize contracts in f32 with TF32 off
F32_FLOPS = 67e12
TOK_DIM, TOK_CENTROIDS, TOK_SEED = 64, 256, 11
TOK_CONCURRENCY, TOK_BATCH = 2, 8192
#: the SF1 orders files tokenized (of 8): a cut of rows, not of widths
ORDERS_FILES = 2
#: the forced way: every priced decision on the device, the hash
#: group-by and join, and every join on the device whatever its size (the
#: vocabulary join is below the 8,192-row floor)
FORCED = dict(DAFT_TORCH_DEVICE_FORCE="1", DAFT_TORCH_KERNEL_GROUPBY="hash",
              DAFT_TORCH_KERNEL_JOIN="hash", DAFT_TORCH_DEVICE_JOIN="1")
#: the marker words ``benchmarking/tpch/datagen.py`` appends to ~1% of
#: ``o_comment``
MARK_WORDS = ("special", "requests")


# ---------------------------------------------------------------- data

def laion_arrays(n: int, px: int, seed: int = IMG_SEED):
    """``bench.py``'s LAION-style generator at ``px``: labels (the dominant
    channel, "r" / "g" / "b") and the uint8 ``[px, px, 3]`` images."""
    rng = np.random.default_rng(seed)
    labels, imgs = [], []
    for i in range(n):
        lab = i % 3
        img = rng.integers(0, 96, size=(px, px, 3), dtype=np.uint8)
        img[..., lab] += 128
        labels.append("rgb"[lab])
        imgs.append(img)
    return labels, imgs


def _encode_pngs(imgs) -> list:
    """PNG bytes of the images, stored (level 0) deflate blocks: a valid
    PNG that encodes in a third and decodes in a quarter of the default
    level's time."""
    from PIL import Image
    out = []
    for img in imgs:
        b = io.BytesIO()
        Image.fromarray(img).save(b, format="PNG", compress_level=0)
        out.append(b.getvalue())
    return out


def laion_shard(cache: str, n: int, px: int, workers: int = 8) -> str:
    """The PNG shard (``id``, ``label``, ``png``) under ``cache``, written
    once; the images are encoded by ``workers`` spawned processes."""
    import concurrent.futures as cf
    import multiprocessing as mp
    d = os.path.join(cache, f"laion_{px}_{n}")
    path = os.path.join(d, "images.parquet")
    if os.path.exists(path):
        return path
    labels, imgs = laion_arrays(n, px)
    if n < 512:  # a small shard: starting the workers costs more
        blobs = _encode_pngs(imgs)
    else:
        step = -(-n // workers)
        chunks = [imgs[i:i + step] for i in range(0, n, step)]
        with cf.ProcessPoolExecutor(
                len(chunks), mp_context=mp.get_context("spawn")) as ex:
            blobs = [b for part in ex.map(_encode_pngs, chunks)
                     for b in part]
    os.makedirs(d, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    pq.write_table(pa.table({"id": pa.array(range(n), pa.int64()),
                             "label": pa.array(labels),
                             "png": pa.array(blobs, pa.large_binary())}),
                   tmp)
    os.replace(tmp, path)
    return path


def write_vocab(path: str) -> dict:
    """A tiktoken-format vocabulary: the 256 single bytes, then each word
    of ``o_comment`` bare and with a leading space → its size."""
    from benchmarking.tpch.datagen import P_NAME_WORDS
    toks = [bytes([i]) for i in range(256)]
    for w in list(P_NAME_WORDS) + list(MARK_WORDS):
        toks += [w.encode(), (" " + w).encode()]
    with open(path, "w") as f:
        for i, t in enumerate(toks):
            f.write(f"{base64.b64encode(t).decode()} {i}\n")
    return dict(entries=len(toks), bytes=os.path.getsize(path))


def vocab_table(path: str) -> pa.Table:
    ids, toks = [], []
    with open(path, "rb") as f:
        for line in f:
            t, r = line.split()
            ids.append(int(r))
            toks.append(base64.b64decode(t).decode("utf-8", "replace"))
    return pa.table({"tok": pa.array(ids, pa.uint32()),
                     "text": pa.array(toks, pa.large_string())})


# ---------------------------------------------------------------- UDFs
# Plain classes at module scope: an actor unpickles them by reference
# (the ``@udf`` wrapper takes another name, so it does not shadow them).

def projection(d_in: int, seed: int = IMG_EMB_SEED):
    """The seeded projection ``[d_in, 128]`` (f32), query ``[128]`` and
    centroids ``[64, 128]`` (f64, unit rows)."""
    rng = np.random.default_rng(seed)
    P = (rng.standard_normal((d_in, EMB_OUT), dtype=np.float32)
         / np.float32(np.sqrt(d_in)))
    q = rng.standard_normal(EMB_OUT)
    C = rng.standard_normal((IMG_CENTROIDS, EMB_OUT))
    return P, q / np.linalg.norm(q), \
        C / np.linalg.norm(C, axis=1, keepdims=True)


class ImageEmbedder:
    """Images → ``{cos, cluster}``: pixels / 255 through the f32
    projection on the card, then in f64 the unit embedding's cosine to the
    query and the argmax over the centroids."""

    def __init__(self, d_in: int, device: str):
        import torch
        self.device = torch.device(device)
        P, q, C = projection(d_in)
        self.P = torch.from_numpy(P).to(self.device)
        self.q = torch.from_numpy(q).to(self.device)
        self.C = torch.from_numpy(C).to(self.device)

    def __call__(self, images):
        import torch
        x = np.stack([np.asarray(a) for a in images.to_pylist()])
        xt = torch.from_numpy(x.reshape(len(x), -1)).to(self.device)
        emb = (xt.to(torch.float32) / 255.0) @ self.P
        e = emb.to(torch.float64)
        e = e / e.norm(dim=1, keepdim=True)
        cos = (e @ self.q).cpu().numpy()
        cluster = (e @ self.C.T).argmax(dim=1).cpu().numpy()
        return pa.StructArray.from_arrays(
            [pa.array(cos), pa.array(cluster.astype(np.int64))],
            names=["cos", "cluster"])


def image_reference(resized, chunk: int = 512):
    """numpy over the resized arrays: cosines, clusters and each row's
    top-two centroid margin."""
    P, q, C = projection(resized[0].size)
    cos, cluster, margin = [], [], []
    for i in range(0, len(resized), chunk):
        x = np.stack(resized[i:i + chunk]).reshape(-1, P.shape[0])
        e = ((x.astype(np.float32) / np.float32(255.0)) @ P) \
            .astype(np.float64)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        s = e @ C.T
        top = np.sort(s, axis=1)
        cos.append(e @ q)
        cluster.append(s.argmax(axis=1))
        margin.append(top[:, -1] - top[:, -2])
    return np.concatenate(cos), np.concatenate(cluster), \
        np.concatenate(margin)


class TokenEmbedder:
    """Token-id lists → ``{cluster, margin, pid, device}``: the mean of the
    tokens' rows of a seeded f32 embedding table on ``device``, in f64,
    scored against 256 seeded centroids (argmax, and the top-two margin);
    ``pid`` is the process that ran the batch and ``device`` the type of
    the device its table lies on."""

    def __init__(self, vocab_size: int, device: str):
        import torch
        self.device = torch.device(device)
        rng = np.random.default_rng(TOK_SEED)
        table = rng.standard_normal((vocab_size, TOK_DIM), dtype=np.float32)
        C = rng.standard_normal((TOK_CENTROIDS, TOK_DIM))
        self.table = torch.from_numpy(table).to(self.device)
        self.C = torch.from_numpy(C).to(self.device)

    def __call__(self, ids):
        import torch
        arr = ids.to_arrow()
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        n = len(arr)
        lens = pc.fill_null(pc.list_value_length(arr), 0).to_numpy() \
            .astype(np.int64)
        flat = pc.list_flatten(arr).to_numpy().astype(np.int64)
        dev = self.device
        seg = torch.repeat_interleave(torch.arange(n, device=dev),
                                      torch.from_numpy(lens).to(dev))
        emb = self.table[torch.from_numpy(flat).to(dev)].to(torch.float64)
        sums = torch.zeros((n, TOK_DIM), dtype=torch.float64, device=dev)
        sums.index_add_(0, seg, emb)
        mean = sums / torch.from_numpy(np.maximum(lens, 1)).to(dev)[:, None]
        s = mean @ self.C.T
        top = torch.topk(s, 2, dim=1).values
        return pa.StructArray.from_arrays(
            [pa.array(s.argmax(dim=1).cpu().numpy().astype(np.int64)),
             pa.array((top[:, 0] - top[:, 1]).cpu().numpy()),
             pa.array(np.full(n, os.getpid(), dtype=np.int64)),
             pa.array([self.table.device.type] * n, pa.large_string())],
            names=["cluster", "margin", "pid", "device"])


# ---------------------------------------------------------------- checks

def _means_close(got: dict, want: dict, key: str, mean: str, vals: dict):
    """Keys and counts exact; each mean within the worst case of any
    summation order, 2 n eps sum|x| / n (``vals``: key → values)."""
    if got[key] != want[key] or got["n"] != want["n"]:
        return False
    eps = np.finfo(np.float64).eps
    for k, g, w in zip(got[key], got[mean], want[mean]):
        x = np.abs(np.asarray(vals[k], dtype=np.float64))
        if abs(g - w) > 2 * len(x) * eps * x.sum() / max(len(x), 1):
            return False
    return True


def _group_oracle(keys, vals, key: str, mean: str) -> dict:
    t = pa.table({key: keys, "v": vals}).group_by(key).aggregate(
        [("v", "mean"), ("v", "count")]).sort_by(key)
    return {key: t[key].to_pylist(), mean: t["v_mean"].to_pylist(),
            "n": t["v_count"].to_pylist()}


def _by_key(keys, vals) -> dict:
    out = {}
    for k, v in zip(keys, vals):
        out.setdefault(k, []).append(v)
    return out


# ---------------------------------------------------------------- the card

def phase(cs, root: str, card: str) -> dict:
    """Phase 7p over the SF1 files under ``root``; ``cs`` is the
    ``chip_smoke`` module (its recorder, logger and helpers)."""
    import torch
    import daft_tpu_torch as dtt
    from daft_tpu_torch.device import backend
    from daft_tpu_torch.functions import image as img_mod
    from daft_tpu_torch.functions import tokenize
    t_phase = time.perf_counter()
    # the UDFs' state lies on the query's device, passed to each instance
    # (the spawned actors' too), so an actor cannot drift to another one
    udf_device = str(backend.resolve_device())
    cache = os.path.dirname(os.path.abspath(root))
    recs = {w: cs.KernelRecorder(f"mm_{w}") for w in ("default", "forced")}
    lines = []
    steps = {}

    def knobs_set():
        return sorted(k for k in os.environ if k.startswith("DAFT_TORCH_")
                      and k != "DAFT_TORCH_LINK_CACHE")

    def counted(way, label, fn):
        rec = recs[way]
        with cs._env(**(FORCED if way == "forced" else {})):
            out, wall, counts, launches = rec.counted(f"mm {way} {label}",
                                                      fn)
            set_knobs = knobs_set()
        rec.to_host()  # the recorded inputs wait on the host for phase 8
        steps[id(launches)] = (rec.decisions, {
            k: v for k, v in counts.items() if isinstance(v, int) and v},
            set_knobs)
        return out, wall, launches

    def line(step, way, wall, rows_in, rows_out, launches=None, **extra):
        d = dict(step=step, way=way, wall_s=wall, rows_in=rows_in,
                 rows_out=rows_out, card=card, **extra)
        if launches is not None:
            decisions, dispatches, set_knobs = steps[id(launches)]
            d.update(decisions=decisions, launches=launches,
                     dispatches=dispatches, knobs=set_knobs)
        lines.append(d)
        cs.log("mm " + json.dumps(d))

    # ------------------------------------------------------------ (a)
    n_img, px, out_px = IMG_N, IMG_PX, IMG_OUT
    t0 = time.perf_counter()
    pil = img_mod._HAS_PIL
    if pil:
        shard = laion_shard(cache, n_img, px)
        t = pq.read_table(shard)
        labels = t.column("label").to_pylist()
        images = dtt.from_arrow(t)
    else:
        cs.log("mm codec: no Pillow")
        labels, arrs = laion_arrays(n_img, px)
        from daft_tpu_torch.series import Series
        images = dtt.from_pydict({
            "id": np.arange(n_img, dtype=np.int64), "label": labels,
            "img": Series.from_pyobjects(arrs, "img")})
    cs.log("mm data " + json.dumps(dict(
        images=n_img, px=px, pillow=pil,
        setup_s=time.perf_counter() - t0)))
    if pil:
        decoded, wall, launches = counted(
            "default", "decode", lambda: images.select(
                "id", "label", dtt.col("png").image.decode(mode="RGB")
                .alias("img")).collect())
        line("decode", "default", wall, n_img, n_img, launches)
    else:
        decoded = images.collect()
    embed = dtt.udf(return_dtype=dtt.DataType.struct({
        "cos": dtt.DataType.float64(), "cluster": dtt.DataType.int64()}),
        batch_size=1024)(ImageEmbedder).with_init_args(
        out_px * out_px * 3, device=udf_device)
    img_results = {}
    for way in ("default", "forced"):
        resized, wall, launches = counted(
            way, "resize", lambda: decoded.select(
                "id", "label", dtt.col("img").image.resize(out_px, out_px)
                .alias("img")).collect())
        on_card = steps[id(launches)][1].get("image_resize", 0)
        line("resize", way, wall, n_img, n_img, launches,
             device=str(backend.resolve_device()), device_resizes=on_card,
             bytes_up=n_img * px * px * 3,
             bytes_down=n_img * out_px * out_px * 3)
        if on_card < 1:
            raise AssertionError(f"mm resize {way}: the batch did not run "
                                 "on the device")
        emb, wall, launches = counted(
            way, "embed", lambda: resized.select(
                "id", "label", embed(dtt.col("img")).alias("e")).select(
                "id", "label", dtt.col("e").struct.get("cos").alias("cos"),
                dtt.col("e").struct.get("cluster").alias("cluster"))
            .collect())
        line("embed", way, wall, n_img, n_img, launches)
        e = emb.to_pydict()
        for key in ("label", "cluster"):
            g, wall, launches = counted(
                way, f"groupby {key}", lambda: emb.groupby(key).agg(
                    dtt.col("cos").mean().alias("mean_cos"),
                    dtt.col("id").count().alias("n")).sort(key).to_pydict())
            want = _group_oracle(e[key], e["cos"], key, "mean_cos")
            if not _means_close(g, want, key, "mean_cos",
                                _by_key(e[key], e["cos"])):
                raise AssertionError(f"mm groupby {key} {way}: differs from "
                                     "pyarrow")
            line(f"groupby {key}", way, wall, n_img, len(g[key]), launches)
        img_results[way] = (resized, e)
    # the resized arrays and the embedding, held (the images reach the UDF
    # as Python objects, so it ran on its in-process instance and started
    # no actor)
    t0 = time.perf_counter()
    sections, t_last = {}, [t0]

    def mark(name):
        now = time.perf_counter()
        sections[name] = now - t_last[0]
        t_last[0] = now
    resized, e = img_results["default"]
    rz = resized.to_pydict()
    order = np.argsort(np.asarray(rz["id"]))
    arrs = [rz["img"][i] for i in order]
    src = decoded.to_pydict()
    src_order = np.argsort(np.asarray(src["id"]))
    rng = np.random.default_rng(17)
    sample = np.sort(rng.choice(n_img, min(RESIZE_CHECK, n_img),
                                replace=False))
    x = torch.from_numpy(np.stack([src["img"][src_order[i]]
                                   for i in sample]))
    mark("gather")
    t1 = time.perf_counter()
    plain32 = img_mod._resize_program(x, out_px, out_px, None, None,
                                      torch.float32).numpy()
    plain_s = time.perf_counter() - t1
    mark("plain")
    card32 = img_mod._resize_program(
        x.to(backend.resolve_device()), out_px, out_px, None, None,
        torch.float32).cpu().numpy()
    got = np.stack([arrs[i] for i in sample])
    plain8 = np.clip(plain32, 0, 255).astype(np.uint8)
    d = np.abs(got.astype(np.int64) - plain8.astype(np.int64))
    # a pixel whose value lies within f32 rounding of an integer truncates
    # to either side of it: the only place the uint8 images may differ
    off = d > 0
    at = plain32[off]
    near_int = np.abs(at - np.round(at)) <= 1e-4
    resize_diff = dict(
        f32_max_abs_err=float(np.abs(card32 - plain32).max()),
        u8_max=int(d.max()), u8_share=float(off.mean()),
        u8_off_near_integers=int(near_int.sum()),
        u8_off_elsewhere=int((~near_int).sum()))
    if resize_diff["f32_max_abs_err"] > 1e-4 or resize_diff["u8_max"] > 1 \
            or resize_diff["u8_off_elsewhere"]:
        raise AssertionError(f"mm resize: the card's images differ from the "
                             f"plain program's ({resize_diff})")
    mark("held")
    other = img_results["forced"][0].to_pydict()
    if not all(np.array_equal(a, b) for a, b in zip(rz["img"],
                                                    other["img"])):
        raise AssertionError("mm resize: the forced way's images differ")
    cos_ref, cl_ref, margin = image_reference(arrs)
    mark("numpy embedding")
    for way, (_, ew) in img_results.items():
        o = np.argsort(np.asarray(ew["id"]))
        cos = np.asarray(ew["cos"])[o]
        cl = np.asarray(ew["cluster"])[o]
        err = float(np.abs(cos - cos_ref).max())
        off = cl != cl_ref
        ties = int((margin < 1e-6).sum())
        if err > 1e-4 or (off & (margin >= 1e-6)).any():
            raise AssertionError(
                f"mm embed {way}: cos err {err}, clusters off "
                f"{int(off.sum())} ({int((off & (margin >= 1e-6)).sum())} "
                "outside near-ties)")
        cs.log("mm embed check " + json.dumps(dict(
            way=way, card=card, cos_max_abs_err=err,
            clusters_off=int(off.sum()), near_ties=ties)))
    # the resize program alone over the whole batch, on the card
    resize_line = {}
    if backend.is_accelerator():
        stack = torch.from_numpy(np.stack(
            [src["img"][i] for i in src_order])).to("cuda")
        ms = cs.cuda_ms(lambda: img_mod._resize_program(
            stack, out_px, out_px, 0.0, 255.0, torch.uint8), reps=5)
        nbytes = n_img * (px * px + out_px * out_px) * 3
        # the function's operations: a multiply-add per nonzero tap of the
        # two axes' weights (rows, then columns), per image and channel;
        # the program's dense contractions do every tap, zero or not
        taps = int(np.count_nonzero(img_mod._resize_weights(px, out_px)))
        flops = 2 * n_img * 3 * (taps * px + out_px * taps)
        dense_flops = 2 * n_img * 3 * (out_px * px * px
                                       + out_px * px * out_px)
        bytes_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS * 1e3
        resize_line = dict(
            ms=ms, bytes=nbytes, flops=flops, dense_flops=dense_flops,
            taps=taps, bytes_bound_ms=bytes_ms,
            ops_bound_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms > bytes_ms else "bytes",
            dense_ops_ms=dense_flops / F32_FLOPS * 1e3)
        del stack
        torch.cuda.empty_cache()
    mark("timed")
    cs.log("mm resize " + json.dumps(dict(
        card=card, images=n_img, src=[px, px, 3],
        dst=[out_px, out_px, 3], held_images=len(sample),
        plain_cpu_s=plain_s, diff=resize_diff, **resize_line,
        check_s=time.perf_counter() - t0, sections=sections)))

    # ------------------------------------------------------------ (b)
    vocab_path = os.path.join(cache, "mm_vocab.tiktoken")
    vinfo = write_vocab(vocab_path)
    vt = vocab_table(vocab_path)
    vocab = dtt.from_arrow(vt)
    cs.log("mm vocab " + json.dumps(dict(
        vinfo, pattern=tokenize.PATTERN_KIND)))
    files = sorted(glob.glob(os.path.join(root, "orders", "*.parquet")))
    files = files[:ORDERS_FILES]
    orders = dtt.read_parquet(files).select(
        "o_orderkey", "o_totalprice", "o_comment")
    toks, wall, launches = counted(
        "default", "tokenize", lambda: orders.with_column(
            "toks", dtt.col("o_comment").str.tokenize_encode(vocab_path))
        .collect())
    ta = toks.to_arrow()
    n_orders = ta.num_rows
    line("tokenize", "default", wall, n_orders, n_orders, launches,
         files=len(files), pattern=tokenize.PATTERN_KIND)
    ex, wall, launches = counted("default", "explode", lambda: toks.select(
        dtt.col("toks").alias("tok")).explode("tok").collect())
    flat = pc.list_flatten(ta.column("toks").combine_chunks())
    n_tok = len(flat)
    line("explode", "default", wall, n_orders, n_tok, launches)
    vc = pc.value_counts(flat)
    want_counts = sorted(zip(vc.field("values").to_pylist(),
                             vc.field("counts").to_pylist()))
    text_of = dict(zip(vt.column("tok").to_pylist(),
                       vt.column("text").to_pylist()))
    for way in ("default", "forced"):
        cnt, wall, l1 = counted(way, "token counts", lambda: ex.groupby(
            "tok").agg(dtt.col("tok").count().alias("n")).collect())
        c = cnt.to_pydict()
        if sorted(zip(c["tok"], c["n"])) != want_counts:
            raise AssertionError(f"mm token counts {way}: differ from "
                                 "pyarrow")
        line("token counts", way, wall, n_tok, len(c["tok"]), l1)
        j, wall, l2 = counted(way, "token join", lambda: cnt.join(
            vocab, on="tok").to_pydict())
        if sorted(zip(j["tok"], j["n"])) != want_counts or any(
                text_of[k] != s for k, s in zip(j["tok"], j["text"])):
            raise AssertionError(f"mm token join {way}: differs from the "
                                 "vocabulary")
        line("token join", way, wall, len(c["tok"]), len(j["tok"]), l2)
    dec, wall, launches = counted("default", "detokenize", lambda: toks.select(
        "o_orderkey", "o_comment", dtt.col("toks").str.tokenize_decode(
            vocab_path).alias("back")).to_arrow())
    if not dec.column("back").equals(dec.column("o_comment")):
        raise AssertionError("mm detokenize: the decoded lists differ from "
                             "the comments")
    line("detokenize", "default", wall, n_orders, n_orders, launches)
    tok_udf = dtt.udf(return_dtype=dtt.DataType.struct({
        "cluster": dtt.DataType.int64(), "margin": dtt.DataType.float64(),
        "pid": dtt.DataType.int64(), "device": dtt.DataType.string()}),
        concurrency=TOK_CONCURRENCY,
        batch_size=TOK_BATCH)(TokenEmbedder).with_init_args(
        vocab_size=vinfo["entries"], device=udf_device)
    try:
        clus, wall, launches = counted(
            "default", "token embed", lambda: toks.into_partitions(
                2 * TOK_CONCURRENCY * 2).select(
                "o_orderkey", "o_totalprice",
                tok_udf(dtt.col("toks")).alias("e")).select(
                "o_orderkey", "o_totalprice",
                dtt.col("e").struct.get("cluster").alias("cluster"),
                dtt.col("e").struct.get("pid").alias("pid"),
                dtt.col("e").struct.get("device").alias("device")).collect())
        pool = tok_udf._get_pool()
        pool_pids = sorted(pool.pids) if pool is not None else []
    finally:
        pool = tok_udf._get_pool()
        if pool is not None:
            pool.shutdown()
    cd = clus.to_pydict()
    pids = sorted(set(cd["pid"]))
    if len(pids) != TOK_CONCURRENCY or os.getpid() in pids \
            or pids != pool_pids:
        raise AssertionError(f"mm token embed: pids {pids}, pool "
                             f"{pool_pids}, parent {os.getpid()}")
    actor_devices = {str(p): sorted({d for q, d in zip(cd["pid"],
                                                        cd["device"])
                                      if q == p}) for p in pids}
    # on the card, each actor's table lies on it (``cuda``)
    if any(v != [backend.resolve_device().type]
           for v in actor_devices.values()):
        raise AssertionError(f"mm token embed: the actors' tables lie on "
                             f"{actor_devices}, not {udf_device}")
    line("token embed", "default", wall, n_orders, n_orders, launches,
         actor_pids=pids, actor_devices=actor_devices, pool_shut_down=True)
    t0 = time.perf_counter()
    local = TokenEmbedder(vinfo["entries"], device="cpu")(
        dtt.Series.from_arrow(ta.column("toks").combine_chunks(), "toks"))
    by_key = dict(zip(ta.column("o_orderkey").to_pylist(),
                      zip(local.field("cluster").to_pylist(),
                          local.field("margin").to_pylist())))
    off = [k for k, c in zip(cd["o_orderkey"], cd["cluster"])
           if by_key[k][0] != c]
    bad = [k for k in off if by_key[k][1] >= 1e-9]
    if bad:
        raise AssertionError(f"mm token embed: {len(bad)} clusters differ "
                             "from the parent's CPU run outside near-ties")
    cs.log("mm token check " + json.dumps(dict(
        card=card, rows=n_orders, clusters_off=len(off),
        near_ties=sum(m < 1e-9 for _, m in by_key.values()),
        check_s=time.perf_counter() - t0)))
    want = _group_oracle(cd["cluster"], cd["o_totalprice"], "cluster",
                         "mean_price")
    vals = _by_key(cd["cluster"], cd["o_totalprice"])
    forced = {"hash_agg_build": 0, "hash_join_build": 0,
              "hash_join_probe": 0}
    for way in ("default", "forced"):
        st, wall, l1 = counted(way, "cluster stats", lambda: clus.groupby(
            "cluster").agg(dtt.col("o_orderkey").count().alias("n"),
                           dtt.col("o_totalprice").mean()
                           .alias("mean_price")).collect())
        s = st.sort("cluster").to_pydict()
        if not _means_close(s, want, "cluster", "mean_price", vals):
            raise AssertionError(f"mm cluster stats {way}: differ from "
                                 "pyarrow")
        line("cluster stats", way, wall, n_orders, len(s["cluster"]), l1)
        jn, wall, l2 = counted(way, "cluster join", lambda: clus.join(
            st, on="cluster").select("o_orderkey", "cluster", "n")
            .to_arrow())
        per = dict(zip(s["cluster"], s["n"]))
        if jn.num_rows != n_orders or any(
                per[c] != n for c, n in zip(jn.column("cluster").to_pylist(),
                                            jn.column("n").to_pylist())):
            raise AssertionError(f"mm cluster join {way}: differs")
        line("cluster join", way, wall, n_orders, jn.num_rows, l2)
        if way == "forced":
            for ls in (l1, l2):
                for k in forced:
                    forced[k] += ls[k]
    for k, v in forced.items():
        if v < 1:
            raise AssertionError(f"mm forced: {k} launched no time "
                                 f"({forced})")

    # ------------------------------------------------------------ (c)
    import torch.utils.data
    t0 = time.perf_counter()
    frame = img_results["default"][0].select("id", "label")
    rows = frame.to_pylist()
    it = list(torch.utils.data.DataLoader(frame.to_torch_iter_dataset(),
                                          batch_size=None))
    m = frame.to_torch_map_dataset()
    picks = np.random.default_rng(23).choice(len(rows), 64, replace=False)
    if len(it) != len(rows) or len(m) != len(rows) or any(
            it[i] != rows[i] or m[i] != rows[i] for i in picks):
        raise AssertionError("mm bridges: the torch datasets differ from "
                             "to_pylist()")
    line("bridges", "default", time.perf_counter() - t0, len(rows),
         len(it))
    cs.log(f"mm phase wall: {time.perf_counter() - t_phase:.3f} s")
    for rec in recs.values():
        rec.to_host("cuda" if backend.is_accelerator() else "cpu")
    return dict(recs=list(recs.values()), lines=lines)


def main() -> int:
    import argparse
    import subprocess
    ap = argparse.ArgumentParser(description="phase 7p alone")
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    os.environ["DAFT_TORCH_LINK_CACHE"] = "0"
    from daft_tpu_torch import native
    from daft_tpu_torch.device import cuda_build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    cs.log(f"card: {card}")
    cs.log("env " + json.dumps(cs.env_probe()))
    t0 = time.perf_counter()
    cuda_build.library()
    cs.log(f"kernel build: {time.perf_counter() - t0:.3f} s")
    native.library()
    root = cs.tpch_root(1.0)
    bw = cs.copy_bandwidth()
    for i in range(args.runs):
        t0 = time.perf_counter()
        out = cs.run_phase("7p", lambda: phase(cs, root, card), t0)
        cs.log(f"phase 7p run {i + 1}: {time.perf_counter() - t0:.3f} s")
    hash_rungs, join_rungs = {}, {}
    for rec in out["recs"]:
        hash_rungs.update(rec.hash_rungs())
        join_rungs.update({k: dict(v, pass_=rec.pass_)
                           for k, v in rec.join_rungs.items()})
    hash_recs = cs.main_path_kernel_timing(hash_rungs, bw)
    join_recs = cs.join_rung_timing(join_rungs, bw)
    cs.log(f"mm rungs held: {len(hash_recs)} hash, {len(join_recs)} join")
    return 0


if __name__ == "__main__":
    sys.exit(main())
