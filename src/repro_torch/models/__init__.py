"""The LM substrate of the port: parameter declarations, layers, dense
attention, MLA, the MoE FFN, decoder blocks and the model's three modes
(full, prefill, decode), as plain functions on nested dicts of tensors.

The counterpart of ``repro.models``. The attention families run
(``block="attn"``: the dense-attention llama3-8b, qwen2.5-14b,
deepseek-coder-33b and gemma-2b; the MoE qwen3-moe-235b-a22b; and
deepseek-v2-lite-16b, MLA with MoE after a leading dense layer), in all
three modes: the full forward trains (``model.loss_fn`` under autograd,
with the remat policies), prefill and decode serve. The others are
declared, so that their parameters can be counted, and raise
NotImplementedError when applied (ROADMAP §1 items 9.4-9.6).
"""
