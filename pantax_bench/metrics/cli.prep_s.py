"""cli.prep_s: the command line's per-invocation preparation, the
"aligner (...)" and "fused tables" stage lines of pantax-gpu, in seconds,
mean per sample over the window."""


def read(run):
    per = [sum(s for name, _, _, s in r.stages
               if name.startswith("aligner") or name == "fused tables")
           for r in run.samples if r.rc == 0]
    return sum(per) / len(per) if per and any(per) else None
