"""profile.profile_s: the profile (species, strain filters and solve,
report, the classification writer), the "profiling..." stage line, in
seconds, mean per sample."""


def read(run):
    per = [sum(s for name, _, _, s in r.stages if name.startswith("profiling"))
           for r in run.samples if r.rc == 0]
    return sum(per) / len(per) if per and any(per) else None
