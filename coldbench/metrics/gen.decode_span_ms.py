"""Median ``gen.decode_step`` span of the program window: one decode step
from its embedding to its token on the host, in ms (``coldbench/spans.py``)."""
import statistics

from coldbench.spans import program


def read(run):
    prog = program(run)
    v = [x["end"] - x["start"] for x in prog["spans"] if x["name"] == "gen.decode_step"] \
        if prog else []
    return statistics.median(v) * 1e-6 if v else None
