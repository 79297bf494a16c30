"""The expert-specialised fine-tune of a MoE base (ESFT, arXiv:2407.01906):
only the experts most relevant to the task are trained, attention, the
mixers, the shared expert and the router stay frozen.  Here, in each
layer, ``per_layer`` of the experts held on this chip have their gate, up
and down matrices times ``factor``; the rest is the base.  Layer ``l``
rewrites experts ``l``, ``l + s``, ... (mod E) with the step ``s = 1 + l //
E``, so no two layers rewrite the same set.  Reached through
``finetunes.make``; never writes into the base."""
from __future__ import annotations


def esft(params, model: dict, per_layer: int = 2, factor: float = 1.10):
    n = len(params["pattern"])
    pattern = []
    for i, layer in enumerate(params["pattern"]):
        moe = layer["moe"]
        reps, E = moe["w_gate"].shape[:2]
        new = {k: moe[k].clone() for k in ("w_gate", "w_up", "w_down")}
        for r in range(reps):
            l = r * n + i
            step = 1 + l // E
            for j in range(per_layer):
                e = (l + j * step) % E
                for a in new.values():
                    a[r, e] *= factor
        pattern.append(dict(layer, moe=dict(moe, **new)))
    return dict(params, pattern=tuple(pattern))
