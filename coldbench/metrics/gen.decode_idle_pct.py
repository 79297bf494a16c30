"""Share of the program window's ``gen.decode_step`` spans' time in which
the device intervals, mapped onto the spans' clock, show nothing running,
in %; None where fewer than 99% of the launches the alignment check counts
(K1 in ``install.job``, K3 in ``gen.decode_step``) lie inside their spans
(``coldbench/spans.py``)."""
from coldbench.spans import aligned_share, covered, program


def read(run):
    prog = program(run)
    if not prog or (aligned_share(prog) or 0.0) < 0.99:
        return None
    steps = [(x["start"], x["end"]) for x in prog["spans"] if x["name"] == "gen.decode_step"]
    total = sum(e - s for s, e in steps)
    if total <= 0:
        return None
    return 100.0 * (1.0 - sum(covered(prog["busy"], s, e) for s, e in steps) / total)
