"""LM serving in the port (serve.LMDecodeWorkload, ServeEngine and
``launch/serve.py --workload lm``) against the reference's, at smoke size,
with 6 requests on 4 slots so that slots are reused, for the dense and
the MoE families (deepseek-v2-lite-16b's caches are two stacks, "dense"
and "blocks", of 4-d MLA leaves [L, B, S, .]; the slot merge copies axis
1 of every leaf) and, at fp32, for Mamba, Hymba (caches of an attention
ring and an SSM state) and the VLM (text-only, as the reference's
ServeEngine serves it: zero cross caches; the grouped self-caches [G, g,
B, ...] merged on axis 2), and the audio family (musicgen-medium) on 1-D
prompts, as the reference serves it: each id written into all four
codebooks, codebook 0's greedy id emitted.

Weights come from the reference's init_params (params_from_numpy);
prompts are made with numpy. At fp32 compute both workloads run on fp32
caches (the reference's default bf16 caches refuse fp32 rows, and so do
the port's) and the greedy tokens must be identical. At the configs' bf16
the two may pick different tokens at a near-tie, so the port is
teacher-forced on the reference's input tokens and every step's logits
are held to the bf16 tolerance of tests/test_torch_models.py: the norm
of the difference within 6e-2 of the reference's, and the same argmax
wherever the reference's top two logits are further apart than 6e-2 of
the largest logit.
"""
import argparse
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro import configs as rc  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.models import model as rm  # noqa: E402
from repro.models import params as rp  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import LMDecodeWorkload as RefWorkload  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402
from repro_torch.serve import Engine, LMDecodeWorkload, ServeEngine  # noqa: E402

DENSE = ["llama3-8b", "qwen2.5-14b", "deepseek-coder-33b", "gemma-2b"]
MOE = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
SSM_VLM = ["falcon-mamba-7b", "hymba-1.5b", "llama-3.2-vision-11b"]
AUDIO = ["musicgen-medium"]
BF16_TOL = 6e-2
PROMPT_LENS = (5, 3, 8, 4, 6, 2)
MAX_NEWS = (4, 1, 3, 5, 2, 4)
SLOTS = 4


def _setup(arch, dtype):
    rcfg = dataclasses.replace(rc.smoke_config(rc.get_config(arch)),
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(tc.smoke_config(tc.get_config(arch)),
                               compute_dtype=dtype)
    p = rp.init_params(rm.model_spec(rcfg), jax.random.key(7))
    pt = tp.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    return rcfg, tcfg, p, pt, prompts


def _cache_len():
    return tserve.required_cache_len(max(PROMPT_LENS), max(MAX_NEWS))


def _serve(engine, prompts):
    rids = [engine.submit(pr, max_new=n) for pr, n in zip(prompts, MAX_NEWS)]
    engine.run_until_drained()
    return [engine.result(r).tokens_out for r in rids]


@pytest.mark.parametrize("arch", DENSE + MOE + SSM_VLM + AUDIO)
def test_greedy_tokens_identical_at_fp32(arch):
    """Both engines on fp32 caches, and a plain greedy decode_step loop
    per request in each package: one token stream."""
    rcfg, tcfg, p, pt, prompts = _setup(arch, "float32")
    cl = _cache_len()
    ref_wl = RefWorkload(rcfg, p, max_batch=SLOTS, cache_len=cl)
    ref_wl.caches = rm.init_caches(rcfg, SLOTS, cl, dt=jnp.float32)
    wl = LMDecodeWorkload(tcfg, pt, max_batch=SLOTS, cache_len=cl,
                          device="cpu")
    wl.caches = tm.init_caches(tcfg, SLOTS, cl, dt=torch.float32,
                               device="cpu")
    want = _serve(RefEngine(ref_wl), prompts)
    got = _serve(Engine(wl), prompts)
    assert got == want
    assert [len(t) for t in got] == list(MAX_NEWS)

    # the engines' streams equal a plain greedy loop over decode_step
    # (the audio family's id in every codebook, codebook 0's argmax)
    prompt, n_new = prompts[0], MAX_NEWS[0]
    k = (tcfg.n_codebooks,) if tcfg.n_codebooks else ()
    caches = tm.init_caches(tcfg, 1, cl, dt=torch.float32, device="cpu")
    out, logits = [], None

    def tok(t):
        return torch.full((1, 1, *k), int(t), dtype=torch.int32)

    for i, t in enumerate(prompt):
        logits, caches = tm.decode_step(pt, tcfg, tok(t), caches, i)
    for j in range(n_new):
        out.append(int(torch.argmax(logits[0, -1], -1).reshape(-1)[0]))
        logits, caches = tm.decode_step(pt, tcfg, tok(out[-1]), caches,
                                        len(prompt) + j)
    assert out == want[0]


def _recording(decode, log, forced=None):
    """Wrap a workload's decode step: log its (input tokens, logits); with
    ``forced``, feed the i-th call the reference's i-th input tokens."""
    def step(params, tok, caches, pos):
        if forced is not None:
            tok = torch.from_numpy(np.array(forced[len(log)][0]))
        logits, new = decode(params, tok, caches, pos)
        log.append((np.asarray(tok), np.asarray(
            logits.float() if isinstance(logits, torch.Tensor)
            else logits.astype(jnp.float32)), int(pos)))
        return logits, new
    return step


@pytest.mark.parametrize("arch", DENSE + MOE + AUDIO)
def test_teacher_forced_logits_at_bf16(arch):
    rcfg, tcfg, p, pt, prompts = _setup(arch, "bfloat16")
    cl = _cache_len()
    ref_wl = RefWorkload(rcfg, p, max_batch=SLOTS, cache_len=cl)
    ref_log, log = [], []
    ref_wl._decode = _recording(ref_wl._decode, ref_log)
    _serve(RefEngine(ref_wl), prompts)
    wl = LMDecodeWorkload(tcfg, pt, max_batch=SLOTS, cache_len=cl,
                          device="cpu")
    wl._decode = _recording(wl._decode, log, forced=ref_log)
    got = _serve(Engine(wl), prompts)
    assert [len(t) for t in got] == list(MAX_NEWS)
    assert len(log) == len(ref_log) == sum(
        n + m - 1 for n, m in zip(PROMPT_LENS, MAX_NEWS))
    for (tok, lt, pos), (rtok, lr, rpos) in zip(log, ref_log):
        assert pos == rpos and np.array_equal(tok, rtok)
        assert np.isfinite(lt).all()
        assert np.linalg.norm(lt - lr) <= BF16_TOL * np.linalg.norm(lr)
        top2 = np.sort(lr, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > BF16_TOL * np.abs(lr).max()
        assert np.array_equal(lt.argmax(-1)[clear], lr.argmax(-1)[clear])


def test_fp32_compute_on_default_caches_raises_in_both():
    rcfg, tcfg, p, pt, prompts = _setup("llama3-8b", "float32")
    ref = RefServeEngine(rcfg, p, max_batch=2, cache_len=16)
    ref.submit(prompts[0])
    with pytest.raises(TypeError):
        ref.run_until_drained()
    eng = ServeEngine(tcfg, pt, max_batch=2, cache_len=16, device="cpu")
    eng.submit(prompts[0])
    with pytest.raises(TypeError):
        eng.run_until_drained()


def test_max_new_one_and_validation():
    rcfg, tcfg, p, pt, prompts = _setup("gemma-2b", "bfloat16")
    ref = RefServeEngine(rcfg, p, max_batch=2, cache_len=16)
    eng = ServeEngine(tcfg, pt, max_batch=2, cache_len=16, device="cpu")
    for e in (ref, eng):
        rids = [e.submit(prompts[i], max_new=1) for i in range(3)]
        e.run_until_drained()
        assert [len(e.result(r).tokens_out) for r in rids] == [1, 1, 1]
        assert all(e.result(r).done for r in rids)
        with pytest.raises(ValueError, match="max_new"):
            e.submit(prompts[0], max_new=0)


def test_expire_and_cancel_pending_as_reference():
    rcfg, tcfg, p, pt, prompts = _setup("llama3-8b", "bfloat16")
    results = []
    for wl in (RefWorkload(rcfg, p, max_batch=3, cache_len=16),
               LMDecodeWorkload(tcfg, pt, max_batch=3, cache_len=16,
                                device="cpu")):
        reqs = [wl.make_request(i, prompts[i], max_new=4) for i in range(3)]
        for r in reqs:
            wl.admit(r)
        wl.tick()
        reqs[1].deadline = 10.0
        expired = wl.expire(20.0)
        assert wl.active == 2 and wl.has_capacity()
        cancelled = wl.cancel_pending()
        assert wl.active == 0 and wl.pending_rids() == []
        results.append([(r.rid, r.failure.code, r.failure.detail,
                         len(r.tokens_out), r.done)
                        for r in expired + cancelled])
    assert results[0] == results[1]
    assert [code for _, code, *_ in results[1]] == [
        "deadline", "cancelled", "cancelled"]


def test_lm_path_launches_no_kernel():
    """The reference's LM path reaches no pallas_call; the port's
    forward, decode_step and workload ticks launch none of K1-K9."""
    _, tcfg, _, pt, prompts = _setup("llama3-8b", "bfloat16")
    ops.reset_dispatch_count()
    eng = ServeEngine(tcfg, pt, max_batch=2, cache_len=16, device="cpu")
    eng.submit(prompts[0], max_new=3)
    eng.run_until_drained()
    tm.forward(pt, tcfg, torch.from_numpy(prompts[0][None]), mode="prefill")
    assert ops.dispatch_count() == 0


def test_cli_lm_is_the_default_and_prints_the_summary(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--prompt-len", "4",
                 "--max-new", "3", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert re.search(r"^served 3 requests / 9 tokens in [\d.]+s \([\d.]+"
                     r" tok/s, \d+ ticks, cache_len 6\)$", out, re.M), out
    assert len(re.findall(r"^  req \d: \[\d+, \d+, \d+\]$", out, re.M)) == 3
    tserve.main(["--workload", "lm", "--device", "cpu", "--arch", "gemma-2b",
                 "--requests", "1", "--prompt-len", "2", "--max-new", "1",
                 "--cache-len", "9"])
    assert "served 1 requests / 1 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", MOE[:1])
def test_cli_serves_the_moe_families(arch, capsys):
    tserve.main(["--workload", "lm", "--device", "cpu", "--arch", arch,
                 "--requests", "3", "--prompt-len", "4", "--max-new", "3",
                 "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out, out
    assert len(re.findall(r"^  req \d: \[\d+, \d+, \d+\]$", out, re.M)) == 3


@pytest.mark.parametrize("arch", SSM_VLM)
def test_cli_serves_the_ssm_and_vlm_families(arch, capsys):
    """``--arch`` of Mamba, Hymba and the VLM (text-only) through the
    launcher's smoke config."""
    tserve.main(["--workload", "lm", "--device", "cpu", "--arch", arch,
                 "--requests", "3", "--prompt-len", "4", "--max-new", "3",
                 "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out, out
    assert len(re.findall(r"^  req \d: \[\d+, \d+, \d+\]$", out, re.M)) == 3


def test_merge_slot_copies_one_slot_of_every_stack():
    """deepseek-v2-lite-16b's caches: two stacks ("dense", "blocks") of
    4-d MLA leaves [L, B, S, .]; merging slot 2 copies axis 1's row 2 of
    every leaf and nothing else."""
    from repro_torch.serve.engine import _merge_slot

    _, tcfg, _, _, _ = _setup("deepseek-v2-lite-16b", "float32")
    old = tm.init_caches(tcfg, SLOTS, 8, dt=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    new = tp.tree_map(lambda x: torch.randn(x.shape, generator=gen), old)
    _merge_slot(old, new, 2)
    assert sorted(old) == ["blocks", "dense"]
    leaves = [x for key in sorted(old) for x in old[key].kv]
    fresh = [x for key in sorted(new) for x in new[key].kv]
    assert [x.dim() for x in leaves] == [4] * 4
    for got, src in zip(leaves, fresh):
        assert torch.equal(got[:, 2], src[:, 2])
        assert torch.count_nonzero(got[:, [0, 1, 3]]) == 0


def test_required_cache_len_and_too_small_cache_as_reference():
    for n, m in ((1, 1), (8, 8), (32, 16)):
        assert tserve.required_cache_len(n, m) == rserve.required_cache_len(
            n, m)
    args = argparse.Namespace(prompt_len=8, max_new=8, cache_len=5)
    with pytest.raises(SystemExit) as ref_err:
        rserve.serve_lm(args)
    with pytest.raises(SystemExit) as err:
        tserve.main(["--device", "cpu", "--prompt-len", "8", "--max-new",
                     "8", "--cache-len", "5"])
    assert str(err.value) == str(ref_err.value)
    assert "needs >= 15" in str(err.value)
