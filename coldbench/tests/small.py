"""Small configurations and cells for the CPU tests: the benchmark's own
configurations with every size cut (the real ones are for the card)."""
import copy

from coldbench import spec

DENSE = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
         "vocab_size": 256}
DENSE_PROGRAM = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
                 "d_ff": 128, "vocab_size": 256, "pattern_reps": 2}
SSM = {"d_model": 64, "n_layer": 2, "vocab_size": 256, "d_state": 16, "headdim": 16,
       "chunk_size": 8}
SSM_PROGRAM = {"n_layers": 2, "d_model": 64, "vocab_size": 256, "ssm_state": 16,
               "ssm_head_dim": 16, "ssm_chunk": 8, "pattern_reps": 2}


def config(name: str) -> dict:
    """The configuration ``name`` at the tests' size."""
    c = copy.deepcopy(spec.config(name))
    small, program = (DENSE, DENSE_PROGRAM) if c["reference"] == "dense_lm" else (SSM, SSM_PROGRAM)
    c.update(small)
    c["program"].update(program)
    c["name"] += "-small"
    c["base"] += "-small"
    return c


def cell(name: str, **changes) -> dict:
    """The cell ``name`` with a ledger of 1000 images (at these sizes every
    tensor takes a whole 64 KiB page on the device) and ``changes``."""
    c = copy.deepcopy(spec.cell(name))
    c["budget_images"] = 1000
    c.update(changes)
    return c
