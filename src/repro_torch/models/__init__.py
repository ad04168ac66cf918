"""The LM substrate of the port: parameter declarations, layers, dense
attention, MLA, the MoE FFN, Mamba, decoder blocks and the model's three
modes (full, prefill, decode), as plain functions on nested dicts of
tensors.

The counterpart of ``repro.models``. All ten families run, in all three
modes (the full forward trains, through ``model.loss_fn`` under
autograd with the remat policies; prefill and decode serve): the
dense-attention llama3-8b, qwen2.5-14b, deepseek-coder-33b and gemma-2b;
the MoE qwen3-moe-235b-a22b; deepseek-v2-lite-16b, MLA with MoE after a
leading dense layer; the Mamba-1 falcon-mamba-7b (``mamba.py`` with
``scan_utils.py``); hymba-1.5b, sliding-window attention and Mamba heads
in parallel; llama-3.2-vision-11b, groups of one cross-attention
block and four self blocks over precomputed vision embeddings; and the
audio musicgen-medium, dense attention over [B, T, K] tokens of K
codebooks, their embeddings summed and one head each.
"""
