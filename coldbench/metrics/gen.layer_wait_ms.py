"""Median over the program window's cold starts of the time their
generation blocked on restored layers (the summed ``gen.layer_wait``
spans of the call), in ms (``coldbench/spans.py``)."""
from coldbench.spans import per_cold_start_ms


def read(run):
    return per_cold_start_ms(run, "gen.layer_wait")
