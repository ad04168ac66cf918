"""The LM substrate of the port: parameter declarations, layers, dense
attention, decoder blocks and the model's three modes (full, prefill,
decode), as plain functions on nested dicts of tensors.

The counterpart of ``repro.models``. Only the dense-attention families
run (``block="attn"`` with ``attn_impl="gqa"`` and no MoE: llama3-8b,
qwen2.5-14b, deepseek-coder-33b, gemma-2b), in all three modes: the full
forward trains (``model.loss_fn`` under autograd, with the remat
policies), prefill and decode serve. The others are declared, so that
their parameters can be counted, and raise NotImplementedError when
applied (ROADMAP §1 items 9.2-9.6).
"""
