"""The functions' fine-tunes of a base, made from the base's weights.

Frozen copies of ``chip_smoke.py``'s ``fine_tune`` and ``py_rnn_fine_tune``
(the latter the reference benchmark zoo's ``py-rnn``, function index 4 of
``benchmarks/common.py``), rewritten over plain dicts; each function of a
configuration's file names its maker and the maker's arguments.  A maker
never writes into the base.
"""
from __future__ import annotations

import importlib

PAGE_BYTES = 64 << 10  # the JIF's page: a fine-tune at another page leaves these disjoint


def fine_tune(params, model: dict, page: int = 0):
    """One 64 KiB page of every layer's attention output matrix (the
    ``page``-th: its rows offset by ``page`` pages) plus 0.01, and the
    final norm plus ``0.01 * (page + 1)``; the rest is the base."""
    attn = params["pattern"][0]["attn"]
    wo = attn["wo"].clone()
    rows = PAGE_BYTES // (wo.shape[-1] * wo.element_size())
    wo[:, page * rows:(page + 1) * rows, :] += 0.01
    layer = dict(params["pattern"][0], attn=dict(attn, wo=wo))
    return dict(params, pattern=(layer,), final_norm=params["final_norm"] + 0.01 * (page + 1))


def py_rnn_fine_tune(params, model: dict, upper: float = 0.6):
    """Every stacked leaf from layer ``int(upper * layers)`` on times 1.10,
    the output head times 1.05 (the embedding's table where the model ties
    it), the final norm plus 0.05."""
    layer = params["pattern"][0]
    reps = next(iter(layer.values())).shape[0]
    cut = int(reps * upper)

    def bump(node):
        if isinstance(node, dict):
            return {k: bump(v) for k, v in node.items()}
        a = node.clone()
        a[cut:] *= 1.10
        return a

    head = "unembed" if "unembed" in params["embed"] else "tok"
    embed = dict(params["embed"], **{head: params["embed"][head] * 1.05})
    return dict(params, embed=embed, final_norm=params["final_norm"] + 0.05,
                pattern=(bump(layer),))


def make(params, model: dict, spec: dict):
    """The function ``spec`` describes: ``{"maker": "<module>.<function>",
    **arguments}``, the maker a function of a module of
    ``coldbench.reference`` (a later maker comes in a file of its own)."""
    args = dict(spec)
    module, _, fn = args.pop("maker").rpartition(".")
    maker = getattr(importlib.import_module(f"coldbench.reference.{module}"), fn)
    return maker(params, model, **args)
