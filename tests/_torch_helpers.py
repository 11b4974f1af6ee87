"""Helpers of the port's tests (imported by tests/test_torch_*.py; the
tests directory is on sys.path under pytest): the reference pinned to one
device, simulated FR mate pairs, random text intervals, read files, random
node-path coverage cases, and the comparison of two runs' output tables."""
import filecmp
import gzip

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def reference_on_one_device():
    """Autouse in every module that imports it: the JAX reference runs on
    one device there, whatever process-wide read-sharding mesh an earlier
    test in the same worker installed.  Under a mesh the reference ships
    reads in its 4-bit wire, which does not blank the codes past a read's
    length, so its rows for such reads differ from the single-device
    reference's that the port is held to."""
    from pantax_tpu.parallel import default_mesh, set_default_mesh

    prev = default_mesh()
    set_default_mesh(None)
    yield
    set_default_mesh(prev)


def simulate_pairs(index, n: int, seed: int, sub: float = 0.01,
                   Lr: int = 150, L: int = 160, hap_weights=None):
    """FR mate pairs: fragment length uniform in 250-500, mate 1 forward at
    the fragment start, mate 2 the reverse complement at its end (mates
    swapped for half the pairs), ``sub`` substitutions per base, haplotypes
    drawn uniformly or by ``hap_weights``.  (codes1, lens1, codes2, lens2)
    with codes int8 [n, L] padded with 4."""
    rng = np.random.default_rng(seed)
    H = len(index.hap_names)
    if hap_weights is None:
        hap = rng.integers(0, H, size=n)
    else:
        w = np.asarray(hap_weights, dtype=np.float64)
        hap = rng.choice(H, size=n, p=w / w.sum())
    spans = np.diff(index.hap_offsets) - 1
    frag = rng.integers(250, 501, size=n)
    starts = (index.hap_offsets[hap] + rng.integers(
        0, np.maximum(spans[hap] - frag - 64, 1))).astype(np.int64)
    cols = np.arange(Lr)
    fwd = index.text[starts[:, None] + cols]
    end = index.text[(starts + frag - Lr)[:, None] + cols][:, ::-1]
    rev = np.where(end < 4, 3 - end, 4).astype(np.int8)
    swap = rng.random(n) < 0.5
    mates = []
    for m in (np.where(swap[:, None], rev, fwd), np.where(swap[:, None], fwd, rev)):
        m = np.where(rng.random(m.shape) < sub,
                     rng.integers(0, 4, size=m.shape), m)
        codes = np.full((n, L), 4, np.int8)
        codes[:, :Lr] = m
        mates += [codes, np.full(n, Lr, np.int64)]
    return tuple(mates)


def random_intervals(index, n: int, seed: int, max_len: int = 3000):
    """Pre-aligned text intervals for feed_intervals: (ts, te, mapq,
    read_len) of ``n`` reads of 100..max_len bases on uniform haplotypes,
    the first five running 100 kb past their haplotype's end and the next
    five unaligned-looking (mapq 0, te == ts)."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, len(index.hap_names), size=n)
    span = np.diff(index.hap_offsets)[hap]
    read_len = rng.integers(100, max_len, size=n)
    ts = index.hap_offsets[hap] + rng.integers(0, np.maximum(
        span - read_len - 8, 1))
    te = ts + read_len
    te[:5] += 100_000
    te[5:10] = ts[5:10]
    mapq = rng.integers(0, 61, size=n)
    mapq[5:10] = 0
    return ts, te, mapq, read_len


BASES = np.frombuffer(b"ACGTN", np.uint8)


def code_seqs(codes, lens):
    """Code rows [n, L] and lengths -> ASCII sequences (bytes)."""
    return [BASES[c[:n]].tobytes() for c, n in zip(codes, lens)]


def write_reads(path, ids, seqs, fmt):
    """FASTQ ("fq"), or FASTA ("fa") with 60-column lines; gzip when the
    path ends in .gz."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        for rid, s in zip(ids, seqs):
            if fmt == "fq":
                f.write(b"@%s desc\n%s\n+\n%s\n" % (rid.encode(), s,
                                                     b"I" * len(s)))
            else:
                f.write(b">%s\n" % rid.encode())
                for i in range(0, len(s), 60):
                    f.write(s[i:i + 60] + b"\n")


# two canonical trios with equal mix3 hashes (found by search over node ids
# below 5000)
COLLIDING_TRIOS = ((1088, 1103, 1500), (1729, 1455, 3667))


def coverage_case(rng, width: int, n_nodes: int = 700, n_reads: int = 300,
                  range_start: int = 41, extra_paths=()):
    """Three haplotype paths that revisit recent nodes (so reads repeat
    nodes) plus ``extra_paths``; reads are sub-paths of the three, one
    exactly ``width`` nodes long, some single-node, some reversed, with
    random offsets (negative and out-of-bounds spans included)."""
    nodes_len = rng.integers(1, 40, size=n_nodes).astype(np.int64)
    paths = {}
    for h in range(3):
        p = [int(rng.integers(n_nodes))]
        while len(p) < max(width, 8) + 200:
            if len(p) > 4 and rng.random() < 0.25:
                p.append(p[-int(rng.integers(2, 5))])
            else:
                p.append(int(rng.integers(n_nodes)))
        paths[f"h{h}"] = np.array(p, dtype=np.int64)
    for i, p in enumerate(extra_paths):
        paths[f"x{i}"] = np.asarray(p, dtype=np.int64)
    reads = []
    for i in range(n_reads):
        p = paths[f"h{int(rng.integers(3))}"]
        ln = width if i == 0 else int(rng.integers(1, min(width, len(p)) + 1))
        s = int(rng.integers(0, len(p) - ln + 1))
        nodes = p[s:s + ln]
        if rng.random() < 0.3:
            nodes = nodes[::-1]
        rs = int(rng.integers(0, 30))
        re = rs + int(rng.integers(-5, int(nodes_len[nodes].sum()) + 20))
        reads.append((f"r{i}", nodes + range_start, rs, re))
    return nodes_len, paths, reads, range_start



def strain_rows(path):
    lines = path.read_text().splitlines()
    return lines[0], [ln.split("\t") for ln in lines[1:]]


def _numbers(row):
    return np.array([float(v) if v else np.nan for v in row[3:]])


def assert_same_strains(out_a, out_b):
    """Species byte-identical; strain rows the same strains in the same
    order; returns the pairs of numeric strain rows."""
    assert filecmp.cmp(out_a / "species_abundance.txt",
                       out_b / "species_abundance.txt", shallow=False)
    pairs = []
    for name in ("strain_abundance.txt", "ori_strain_abundance.txt"):
        head_a, rows_a = strain_rows(out_a / name)
        head_b, rows_b = strain_rows(out_b / name)
        assert head_a == head_b and len(rows_a) == len(rows_b), name
        assert [r[:3] for r in rows_a] == [r[:3] for r in rows_b], name
        pairs += [(head_a, ra, rb) for ra, rb in zip(rows_a, rows_b)]
    return pairs


STAT_COLS = ("path_base_cov", "unique_trio_fraction", "uniq_trio_cov_mean")


def assert_tables_agree(out_a, out_b, abundance_tol):
    """Two runs' tables on the same coverage: species byte-identical, the
    same strains in the same order; the columns computed from the tail
    stats within rtol 2e-4; the solver's columns within the reference's
    ADMM bar (coverages within 0.05, tests/test_pao.py; the rounded
    divergence within one rounding step), abundances within
    ``abundance_tol`` and total_cov_diff (a difference of coverages over
    the species coverage) within 2e-4.  The solver's columns are held no
    tighter because the L1 optimum can be a face (it is on the 3-species
    scale slice): two ADMM runs whose float32 sums round differently stop
    at different points of it, with polished objectives within 1e-4
    (tests/test_torch_profile_tail.py holds the solvers to that)."""
    pairs = assert_same_strains(out_a, out_b)
    assert len(pairs) >= 6
    for head, ra, rb in pairs:
        a = dict(zip(head.split("\t"), [np.nan] * 3 + list(_numbers(ra))))
        b = dict(zip(head.split("\t"), [np.nan] * 3 + list(_numbers(rb))))
        for k in STAT_COLS:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-6,
                                       err_msg=f"{k}: {ra} vs {rb}")
        for k, tol in (("predicted_coverage", 0.05), ("first_sol", 0.05),
                       ("strain_cov_diff", 0.01 + 1e-9),
                       ("predicted_abundance", abundance_tol),
                       ("total_cov_diff", 2e-4)):
            assert abs(a[k] - b[k]) <= tol, (k, ra, rb)
