"""fused.align_cover_s: reading the sample's files and the fused
alignment + coverage loop, the "alignment+coverage (fused)" or "long-read
alignment+coverage (fastpath)" stage line, in seconds, mean per sample."""

NAMES = ("alignment+coverage (fused)", "long-read alignment+coverage (fastpath)")


def read(run):
    per = [sum(s for name, _, _, s in r.stages if name in NAMES)
           for r in run.samples if r.rc == 0]
    return sum(per) / len(per) if per and any(per) else None
