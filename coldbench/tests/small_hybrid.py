"""The granite-4.0-h-small configuration at the tests' size: every width
cut, the structure kept (layer kinds, a router over more experts than are
held, the multipliers, NoPE, the gated norm's order).  The real sizes are
for the card."""
import copy

from coldbench import spec

NAME = "granite-4.0-h-small"


def config(held=2, experts=6, offset=0, layers=("mamba", "mamba", "attention", "mamba")) -> dict:
    """d 64, ``held`` experts of a router over ``experts`` from ``offset``
    on, top 3, ``layers``."""
    c = copy.deepcopy(spec.config(NAME))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, intermediate_size=32,
             shared_intermediate_size=48, mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16,
             mamba_chunk_size=8, vocab_size=256, num_local_experts=held, num_experts_per_tok=3,
             layer_types=list(layers), attention_multiplier=1 / 16)
    c["deployment"] = dict(c["deployment"], router_experts=experts, expert_offset=offset)
    pattern = [{"kind": "mamba" if t == "mamba" else "attn", "moe": True} for t in layers]
    c["program"].update(n_layers=len(layers), d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                        d_ff=32, shared_ff=48, vocab_size=256, n_experts=held, top_k=3,
                        router_experts=experts, expert_offset=offset, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=8, attn_scale=1 / 16, pattern=pattern)
    c["name"] += f"-small-{held}-{offset}-{len(layers)}"
    c["base"] += "-small"
    return c
