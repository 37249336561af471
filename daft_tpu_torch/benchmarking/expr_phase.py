"""Phase 7o of ``chip_smoke.py``: the expression families of ROADMAP A8c
over TPC-H ``orders`` at SF1, through the DataFrame API and SQL, held to
numpy and pyarrow oracles. Alone, from the repository root on a machine
with a CUDA card:

    python3 daft_tpu_torch/benchmarking/expr_phase.py [--runs N]

(builds the kernels and the native library, generates the SF1 files into
``.cache/`` with ``chip_smoke.tpch_root``, runs the phase N times, then
holds its hash and join rungs against the plain versions as phase 8
does; exits non-zero when a check fails).

The phase:

(a) word count: ``o_comment.str.split(" ")`` → ``explode`` → group by
    word → count, sorted by count descending then word; held exactly to
    pyarrow (``split_pattern`` → ``list_flatten`` → ``value_counts``);
(b) MinHash near-dedup: normalized comments → 16-value MinHash over word
    3-grams → four int64 band keys (value + band << 32) → ``explode`` →
    group by band (count, min order key) where the count passes 1 →
    inner join of the exploded rows to those groups → the (order key,
    representative) pairs without the representative itself →
    ``drop_duplicates`` → ``agg_list`` per representative. It runs at the
    default knobs (the cost model's decisions logged), forced to the card
    (``DAFT_TORCH_DEVICE_FORCE=1`` with the hash group-by and hash join,
    which must launch the hash-agg build, the join build and the join
    probe) and on the host tier; each way is held exactly to the numpy
    oracle of :func:`near_dedup_oracle` over the port's signatures and
    to the host tier. The signatures and the exploded bands are computed
    once, in the default way; the forced and host ways start from them;
(c) the native library on SF1 data: its MinHash of a seeded 10,000-row
    sample equals the numpy twin's, its XXH64 of every ``o_comment`` equals
    ``series._xxh64_var``, and ``approx_count_distinct`` of ``o_comment``
    and ``o_custkey`` equals the numpy HyperLogLog's estimate and lies
    within 3% of the exact count;
(d) SQL: ``regexp_extract`` and ``hash`` group-bys (the latter a uint64
    key of about 1.5M groups) at the forced knobs, each held to its
    DataFrame form. Both forms of the ``hash`` query aggregate on the
    host (a uint64 value at or above 2^63 has no device plane), so a
    third form groups the same hashes reinterpreted as int64 on the card
    (it must launch the hash-agg build) and is held to them.

Each step prints an ``expr`` line: its wall, rows in and out, the cost
model's decisions and the launches per kernel, and the native library's
build time. The pipeline builders take the package as an argument
(``p``), so the CPU tests run the same code through ``daft_tpu`` and
this package; nothing here imports the former.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

#: MinHash signature width, word n-gram, seed; bands; the bands used
NUM_HASHES, NGRAM, SEED, BANDS = 16, 3, 42, 4
#: the knobs of the forced way
FORCED = dict(DAFT_TORCH_DEVICE_FORCE="1", DAFT_TORCH_KERNEL_GROUPBY="hash",
              DAFT_TORCH_KERNEL_JOIN="hash")
SQL_EXTRACT = (r"SELECT regexp_extract(o_comment, '^\S+') AS w, count(*) AS n"
               r" FROM orders GROUP BY regexp_extract(o_comment, '^\S+')")
SQL_HASH = ("SELECT hash(o_comment) AS h, count(*) AS n FROM orders "
            "GROUP BY hash(o_comment)")

_WORDS = ("almond antique aquamarine azure beige bisque black blanched blue "
          "blush brown burlywood burnished chartreuse chiffon chocolate "
          "coral cornflower cornsilk cream cyan dark deep dim dodger drab "
          "firebrick floral forest frosted").split()


def seeded_comments(n: int, seed: int = 0, words: int = 6):
    """``n`` word-salad comments of ``words`` words (``o_comment``'s shape)
    and their order keys 1..n; about 1% carry "special requests"."""
    rng = np.random.default_rng(seed)
    w = np.array(_WORDS)[rng.integers(0, len(_WORDS), (n, words))]
    out = [" ".join(r) for r in w]
    for i in np.flatnonzero(rng.random(n) < 0.01):
        out[i] += " special requests"
    return out, list(range(1, n + 1))


# ---------------------------------------------------------------- pipelines

def signature_expr(p):
    return p.col("o_comment").str.normalize(
        remove_punct=True, lowercase=True).minhash(
        num_hashes=NUM_HASHES, ngram_size=NGRAM, seed=SEED)


def word_count(df, p):
    return (df.select(p.col("o_comment").str.split(" ").alias("word"))
            .explode("word")
            .groupby("word").agg(p.col("word").count().alias("n"))
            .sort(["n", "word"], desc=[True, False]))


def exploded_bands(sigs, p):
    """(o_orderkey, sig) → one row per (order, band): the band key is the
    band's MinHash value, as int64, plus the band number << 32."""
    sig = p.col("sig")
    band = p.list_(*[sig.list.get(i).cast(p.DataType.int64()) + (i << 32)
                     for i in range(BANDS)]).alias("band")
    return sigs.select(p.col("o_orderkey"), band).explode("band")


def band_groups(ex, p):
    return (ex.groupby("band")
            .agg(p.col("o_orderkey").count().alias("n"),
                 p.col("o_orderkey").min().alias("rep"))
            .where(p.col("n") > 1))


def near_pairs(ex, groups, p):
    return (ex.join(groups, on="band")
            .where(p.col("o_orderkey") != p.col("rep"))
            .select("o_orderkey", "rep").drop_duplicates())


def rep_lists(pairs, p):
    return pairs.groupby("rep").agg_list("o_orderkey")


def dedup_steps(ex, p):
    """The device-facing steps from the exploded bands: → (groups, pairs,
    lists), each collected."""
    g = band_groups(ex, p).collect()
    pr = near_pairs(ex, g, p).collect()
    return g, pr, rep_lists(pr, p).collect()


def run_pipelines(get_df, p) -> dict:
    """The phase's word count and near-dedup through package ``p`` over the
    frame ``get_df()`` (columns o_orderkey, o_comment) → plain answers."""
    words = word_count(get_df(), p).to_pydict()
    sigs = get_df().select(p.col("o_orderkey"),
                           signature_expr(p).alias("sig")).collect()
    ex = exploded_bands(sigs, p).collect()
    g, pr, lists = dedup_steps(ex, p)
    return {"words": words, "dedup": {"groups": g.to_pydict(),
                                      "pairs": pr.to_pydict(),
                                      "lists": lists.to_pydict()}}


# ---------------------------------------------------------------- oracles

def canonical_words(d: dict) -> list:
    return list(zip(d["word"], d["n"]))


def _table(d) -> pa.Table:
    return d if isinstance(d, pa.Table) else pa.table(d)


def _pairs_sorted(a: np.ndarray, b: np.ndarray, by_b: bool = False):
    """``[a, b]`` rows, sorted by (a, b) or (b, a)."""
    if not len(a):
        return np.zeros((0, 2), np.int64)
    hi, lo = (b, a) if by_b else (a, b)
    if min(hi.min(), lo.min()) >= 0 and max(hi.max(), lo.max()) < 1 << 31:
        # both fit 31 bits (order keys): one sort of the packed pair
        packed = np.sort((hi.astype(np.int64) << 32) | lo.astype(np.int64))
        hi, lo = packed >> 32, packed & 0xFFFFFFFF
    else:
        order = np.lexsort((lo, hi))
        hi, lo = hi[order], lo[order]
    return np.stack([lo, hi] if by_b else [hi, lo], 1)


def canonical_dedup(d: dict) -> dict:
    """The near-dedup answers as sorted int64 arrays: groups ``[band, n,
    rep]`` by band, pairs ``[o_orderkey, rep]`` by (key, rep), and the
    lists exploded to ``[o_orderkey, rep]`` by (rep, key) with each rep's
    list count (a rep listed twice shows there)."""
    g = _table(d["groups"])
    band = g.column("band").to_numpy().astype(np.int64)
    order = np.argsort(band, kind="stable")
    groups = np.stack([band, g.column("n").to_numpy().astype(np.int64),
                       g.column("rep").to_numpy().astype(np.int64)],
                      1)[order] if len(band) else np.zeros((0, 3), np.int64)
    pr = _table(d["pairs"])
    pairs = _pairs_sorted(pr.column("o_orderkey").to_numpy().astype(np.int64),
                          pr.column("rep").to_numpy().astype(np.int64))
    li = _table(d["lists"])
    lcol = li.column("o_orderkey").combine_chunks()
    lens = pc.list_value_length(lcol).to_numpy(zero_copy_only=False)
    reps = li.column("rep").to_numpy().astype(np.int64)
    flat = pc.list_flatten(lcol).to_numpy().astype(np.int64)
    lists = _pairs_sorted(flat, np.repeat(reps, lens), by_b=True)
    return {"groups": groups, "pairs": pairs, "lists": lists,
            "reps": np.sort(reps)}


def same(a, b) -> bool:
    """Equality of canonical answers (dicts, lists, numpy arrays)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def canonical(r: dict) -> dict:
    return {"words": canonical_words(r["words"]),
            "dedup": canonical_dedup(r["dedup"])}


def word_count_oracle(comments) -> list:
    """pyarrow: split on " ", flatten, count; by count descending, then
    word."""
    arr = pa.array(comments, pa.large_string()) \
        if not isinstance(comments, (pa.Array, pa.ChunkedArray)) else comments
    vc = pc.value_counts(pc.list_flatten(pc.split_pattern(arr, " ")))
    words = vc.field("values").to_pylist()
    counts = vc.field("counts").to_numpy()
    order = sorted(range(len(words)), key=lambda i: (-counts[i], words[i]))
    return [(words[i], int(counts[i])) for i in order]


def signatures(comments) -> np.ndarray:
    """The port's MinHash signatures of the comments, normalized as the
    phase normalizes them → uint32 ``[n, NUM_HASHES]``."""
    from daft_tpu_torch.series import Series
    import string
    table = str.maketrans("", "", string.punctuation)
    norm = [None if c is None else c.lower().translate(table)
            for c in comments]
    sig = Series.from_pylist(norm, "s").minhash(NUM_HASHES, NGRAM, SEED)
    return np.asarray(sig.to_pylist(), dtype=np.uint32)


def near_dedup_oracle(sig: np.ndarray, keys: np.ndarray) -> dict:
    """numpy: the band keys, their counts and minima, the groups past one
    row, the (order key, representative) pairs and the lists, in the
    layout of :func:`canonical_dedup`."""
    band = (sig[:, :BANDS].astype(np.int64)
            + (np.arange(BANDS, dtype=np.int64) << 32)[None, :]).ravel()
    okey = np.repeat(np.asarray(keys, dtype=np.int64), BANDS)
    order = np.lexsort((okey, band))
    b_s, k_s = band[order], okey[order]
    starts = np.flatnonzero(np.concatenate([[True], b_s[1:] != b_s[:-1]])) \
        if len(b_s) else np.zeros(0, np.int64)
    counts = np.diff(np.concatenate([starts, [len(b_s)]]))
    reps = k_s[starts]                       # sorted by key within a band
    keep = counts > 1
    groups = np.stack([b_s[starts][keep], counts[keep], reps[keep]], 1) \
        if len(starts) else np.zeros((0, 3), np.int64)
    rep_of_row = np.repeat(reps, counts)
    in_group = np.repeat(keep, counts) & (k_s != rep_of_row)
    pairs = _pairs_sorted(k_s[in_group], rep_of_row[in_group])
    if len(pairs):
        # unique rows: sorted, so a row equal to the one before goes
        first = np.concatenate([[True], (np.diff(pairs, axis=0) != 0)
                                .any(axis=1)])
        pairs = pairs[first]
    return {"groups": groups.astype(np.int64), "pairs": pairs,
            "lists": _pairs_sorted(pairs[:, 0], pairs[:, 1], by_b=True),
            "reps": np.unique(pairs[:, 1])}


# ---------------------------------------------------------------- the card

def phase(cs, root: str, card: str) -> dict:
    """Phase 7o on the card over the SF1 files under ``root``; ``cs`` is
    the ``chip_smoke`` module (its recorder, logger and helpers)."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch import native
    from daft_tpu_torch.series import Series, _minhash_fallback, _xxh64_var
    t_phase = time.perf_counter()
    sections, t_last = {}, [t_phase]

    def mark(name):
        """Seconds since the last mark, by section (the steps' walls are
        on their own lines; these hold the oracles and bookkeeping too)."""
        now = time.perf_counter()
        sections[name] = now - t_last[0]
        t_last[0] = now
    native.library()
    build = dict(native_build_s=native.build_seconds,
                 native_built_here=native.built)
    get = lambda: dtt.read_parquet(os.path.join(root, "orders"))  # noqa
    recs = {w: cs.KernelRecorder(f"expr_{w}")
            for w in ("default", "forced", "sql")}
    lines = []

    def line(step, way, wall, rows_in, rows_out, launches=None, **extra):
        d = dict(step=step, way=way, wall_s=wall, rows_in=rows_in,
                 rows_out=rows_out, card=card, **build, **extra)
        if launches is not None:
            decisions, dispatches, set_knobs = steps[id(launches)]
            d.update(decisions=decisions, launches=launches,
                     dispatches=dispatches, knobs=set_knobs)
        else:
            d.update(knobs=knobs_set())
        lines.append(d)
        cs.log("expr " + json.dumps(d))

    #: the cost model's decisions, the device tier's dispatch counters and
    #: the knobs set of each counted step, by the identity of its launches
    #: dict
    steps = {}

    def knobs_set():
        """The port's knobs the environment sets (at the default knobs only
        the asked-for device, where it is asked for)."""
        return sorted(k for k in os.environ if k.startswith("DAFT_TORCH_")
                      and k != "DAFT_TORCH_LINK_CACHE")

    def counted(way, label, fn):
        rec = recs[way]
        out, wall, counts, launches = rec.counted(f"expr {way} {label}", fn)
        rec.to_host()  # the recorded inputs wait on the host for phase 8
        steps[id(launches)] = (rec.decisions, {
            k: v for k, v in counts.items() if isinstance(v, int) and v
            and k in ("dense", "hash", "sort", "global", "agg_hash",
                      "agg_sort", "agg_global", "projection", "predicate",
                      "argsort", "join_hash", "join_sort", "host_joins",
                      "host_ops", "host_morsels")}, knobs_set())
        return out, wall, launches

    orders = get().select("o_orderkey", "o_custkey", "o_comment") \
        .to_arrow()
    n_orders = orders.num_rows
    comments = orders.column("o_comment").combine_chunks()
    keys = orders.column("o_orderkey").to_numpy()

    mark("read")
    # (a) word count
    words, wall, launches = counted(
        "default", "words", lambda: word_count(get(), dtt).to_pydict())
    oracle = word_count_oracle(comments)
    if canonical_words(words) != oracle:
        raise AssertionError("expr words: differs from pyarrow")
    line("words", "default", wall, n_orders, len(words["word"]),
         launches, exploded=sum(words["n"]))

    mark("words")
    # (b) near-dedup, default knobs
    sigs, wall, launches = counted("default", "signatures", lambda: get()
                                   .select(dtt.col("o_orderkey"),
                                           signature_expr(dtt).alias("sig"))
                                   .collect())
    line("signatures", "default", wall, n_orders, n_orders, launches)
    sd = sigs.to_arrow()
    sig_np = np.asarray(pc.list_flatten(sd.column("sig").combine_chunks())
                        .to_numpy(), dtype=np.uint32).reshape(-1, NUM_HASHES)
    ex, wall, launches = counted("default", "explode",
                                 lambda: exploded_bands(sigs, dtt).collect())
    n_ex = ex.to_arrow().num_rows
    if n_ex != BANDS * n_orders:
        raise AssertionError(f"expr explode: {n_ex} rows, not "
                             f"{BANDS} x {n_orders}")
    line("explode", "default", wall, n_orders, n_ex, launches)
    mark("bands")
    t0 = time.perf_counter()
    oracle = near_dedup_oracle(sig_np, sd.column("o_orderkey").to_numpy())
    oracle_s = time.perf_counter() - t0
    mark("oracle")
    answers = {}
    for way in ("default", "forced", "host"):
        ctx = cs._env(**FORCED) if way == "forced" else (
            dtt.execution_config_ctx(device="0") if way == "host"
            else cs._env())
        with ctx:
            if way == "host":
                t0 = time.perf_counter()
                g, pr, lists = dedup_steps(ex, dtt)
                out = {"groups": g.to_arrow(), "pairs": pr.to_arrow(),
                       "lists": lists.to_arrow()}
                line("dedup", way, time.perf_counter() - t0, n_ex,
                     out["pairs"].num_rows)
            else:
                g, wg, lg = counted(way, "groups",
                                    lambda: band_groups(ex, dtt).collect())
                pr, wp, lp = counted(way, "pairs",
                                     lambda: near_pairs(ex, g, dtt).collect())
                lists, wl, ll = counted(way, "lists",
                                        lambda: rep_lists(pr, dtt).collect())
                out = {"groups": g.to_arrow(), "pairs": pr.to_arrow(),
                       "lists": lists.to_arrow()}
                n_g, n_p = out["groups"].num_rows, out["pairs"].num_rows
                line("groups", way, wg, n_ex, n_g, lg)
                line("pairs", way, wp, n_ex, n_p, lp)
                line("lists", way, wl, n_p, out["lists"].num_rows, ll)
                if way == "forced":
                    total = {k: lg[k] + lp[k] + ll[k] for k in lg}
                    for k in ("hash_agg_build", "hash_join_build",
                              "hash_join_probe"):
                        if total[k] < 1:
                            raise AssertionError(
                                f"expr forced: {k} launched no time "
                                f"({total})")
        mark(f"dedup {way}")
        answers[way] = canonical_dedup(out)
        mark(f"canonical {way}")
        if not same(answers[way], oracle):
            diff = {k: (len(answers[way][k]), len(oracle[k]))
                    for k in oracle}
            raise AssertionError(f"expr dedup {way}: differs from the numpy "
                                 f"oracle (sizes {diff})")
    if not (same(answers["default"], answers["forced"])
            and same(answers["default"], answers["host"])):
        raise AssertionError("expr dedup: the ways differ")
    cs.log("expr dedup " + json.dumps(dict(
        card=card, groups=len(oracle["groups"]), pairs=len(oracle["pairs"]),
        reps=len(oracle["reps"]), oracle_s=oracle_s, **build)))

    mark("dedup")
    # (c) the native library on SF1 data
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    sample = comments.take(pa.array(np.sort(rng.choice(
        n_orders, 10_000, replace=False))))
    b = sample.cast(pa.large_binary()).buffers()
    offs = np.frombuffer(b[1], np.int64, count=len(sample) + 1)
    data = np.frombuffer(b[2], np.uint8)
    valid = np.ones(len(sample), bool)
    lib_sig = native.minhash(offs, data, valid, NUM_HASHES, NGRAM, SEED)
    if not np.array_equal(lib_sig, _minhash_fallback(
            sample.to_pylist(), NUM_HASHES, NGRAM, SEED)):
        raise AssertionError("expr native: MinHash differs from the twin")
    col_s = Series.from_arrow(comments, "o_comment")
    lib_h = col_s.hash().to_numpy()
    b = comments.cast(pa.large_binary()).buffers()
    offs = np.frombuffer(b[1], np.int64, count=len(comments) + 1,
                         offset=comments.offset * 8)
    twin_h = _xxh64_var(offs, np.frombuffer(b[2], np.uint8))
    if not np.array_equal(lib_h, twin_h):
        raise AssertionError("expr native: XXH64 differs from the twin")
    got = get().agg(dtt.col("o_comment").approx_count_distinct(),
                    dtt.col("o_custkey").approx_count_distinct()) \
        .to_pydict()
    hll = {}
    for name in ("o_comment", "o_custkey"):
        s = Series.from_arrow(orders.column(name), name)
        h = s.filter(s.not_null()).hash().to_numpy()
        twin = int(round(native.HyperLogLog(native=False).add_hashes(h)
                         .estimate()))
        exact = pc.count_distinct(orders.column(name)).as_py()
        hll[name] = dict(approx=got[name][0], twin=twin, exact=exact,
                         rel_err=abs(got[name][0] - exact) / exact)
        if got[name][0] != twin or hll[name]["rel_err"] > 0.03:
            raise AssertionError(f"expr native: approx_count_distinct "
                                 f"{name} {hll[name]}")
    cs.log("expr native " + json.dumps(dict(
        card=card, minhash_sample=len(sample), hashed=len(comments),
        hll=hll, wall_s=time.perf_counter() - t0, **build)))

    mark("native")
    # (d) SQL, held to the DataFrame forms, both at the forced knobs. The
    # SQL group-bys keep their keys' expressions (``hash`` has no device
    # form, and ``count(*)`` counts every row), and a uint64 column with a
    # value at or above 2^63 has no device plane
    # (``device/column.has_device_plane``), so the hash query aggregates
    # on the host in both forms; a third form groups the same hashes
    # reinterpreted as int64 (half of them negative) on the card
    def rows(t: pa.Table, k):
        """(key, count) rows by key (keys are unique: group-by output)."""
        t = t.select([k, "n"]).sort_by([(k, "ascending")])
        return t.column(k).combine_chunks(), \
            t.column("n").combine_chunks().cast(pa.uint64())

    def same_rows(a, b, k):
        (ka, na), (kb, nb) = rows(a, k), rows(b, k)
        return ka.equals(kb) and na.equals(nb)
    hashed = get().select(dtt.col("o_comment").hash().alias("h")).collect()
    for label, sql, key, form in (
            ("sql extract", SQL_EXTRACT, "w",
             lambda: get().groupby(dtt.col("o_comment").str.extract(
                 r"^\S+").alias("w")).agg(
                 dtt.col("o_orderkey").count().alias("n"))),
            ("sql hash", SQL_HASH, "h",
             lambda: hashed.groupby("h").agg(
                 dtt.col("h").count().alias("n")))):
        with cs._env(**FORCED):
            out, wall, launches = counted(
                "sql", label,
                lambda: dtt.sql(cs._sql_tables(sql, root)).to_arrow())
            want, form_s, form_launches = counted(
                "sql", label + " form", lambda: form().to_arrow())
        if not same_rows(out, want, key):
            raise AssertionError(f"expr {label}: differs from the "
                                 "DataFrame form")
        extra = {}
        if key == "h":
            as_i64 = hashed.select(dtt.col("h").cast(
                dtt.DataType.int64()).alias("h"))
            with cs._env(**FORCED):
                signed, i64_s, i64_launches = counted(
                    "sql", "hash int64", lambda: as_i64.groupby("h").agg(
                        dtt.col("h").count().alias("n")).to_arrow())
            back = pa.table({
                "h": np.asarray(signed.column("h").to_numpy(), np.int64)
                .view(np.uint64), "n": signed.column("n")})
            if not same_rows(back, want, "h"):
                raise AssertionError("expr sql hash: the int64 form "
                                     "differs")
            if i64_launches["hash_agg_build"] < 1:
                raise AssertionError(f"expr sql hash: the int64 group-by "
                                     f"launched no hash-agg build "
                                     f"({i64_launches})")
            extra = dict(int64_form_s=i64_s, int64_form_launches=i64_launches)
        line(label, "forced", wall, n_orders, out.num_rows, launches,
             dataframe_form_s=form_s,
             dataframe_form_launches=form_launches, **extra)
    mark("sql")
    cs.log("expr sections " + json.dumps(dict(card=card, **sections)))
    cs.log(f"expr phase wall: {time.perf_counter() - t_phase:.3f} s")
    for rec in recs.values():
        rec.to_host("cuda")  # phase 8 runs the kernels on them
    return dict(recs=list(recs.values()), lines=lines)


def main() -> int:
    import argparse
    import subprocess
    ap = argparse.ArgumentParser(description="phase 7o alone")
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
    t0 = time.perf_counter()
    cuda_build.library()
    cs.log(f"kernel build: {time.perf_counter() - t0:.3f} s")
    native.library()
    cs.log(f"native library: {native.build_seconds:.3f} s (built here: "
           f"{native.built})")
    root = cs.tpch_root(1.0)
    bw = cs.copy_bandwidth()
    for i in range(args.runs):
        t0 = time.perf_counter()
        out = cs.run_phase("7o", lambda: phase(cs, root, card), t0)
        cs.log(f"phase 7o run {i + 1}: {time.perf_counter() - t0:.3f} s")
    hash_rungs, join_rungs = {}, {}
    for rec in out["recs"]:
        hash_rungs.update(rec.hash_rungs())
        join_rungs.update({k: dict(v, pass_=rec.pass_)
                           for k, v in rec.join_rungs.items()})
    hash_recs = cs.main_path_kernel_timing(hash_rungs, bw)
    join_recs = cs.join_rung_timing(join_rungs, bw)
    cs.log(f"expr rungs held: {len(hash_recs)} hash, {len(join_recs)} join")
    return 0


if __name__ == "__main__":
    sys.exit(main())
