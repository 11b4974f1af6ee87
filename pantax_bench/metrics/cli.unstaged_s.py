"""cli.unstaged_s: the time of a pantax-gpu invocation that no stage line
covers (the database open, flag resolution, writing the outputs), in
seconds, mean per sample: the invocation's wall time less the union of
its stage lines' intervals."""


def read(run):
    per = []
    for r in run.samples:
        if r.rc != 0:
            continue
        covered, cur = 0.0, r.start
        for _, s, e, _ in sorted(r.stages, key=lambda st: st[1]):
            s, e = max(s, cur), min(e, r.end)
            if e > s:
                covered += e - s
                cur = e
        per.append(r.wall - covered)
    return sum(per) / len(per) if per else None
