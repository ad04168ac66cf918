#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its main paths — root extraction served through
``repro_torch.serve.Engine`` + ``StemmerWorkload`` onto the stemmer
kernels, text served through ``TextAnalysisWorkload`` onto the text front
end and the stemmer kernels, a corpus index built through the stemmer
kernels and the postings kernel, flash attention (K9) on a full-width
LM's attention, that LM, the MoE and MLA models, Mamba, Hymba, the VLM
and the audio model served through ``LMDecodeWorkload``, and gemma-2b,
deepseek-v2-lite-16b, hymba-1.5b, falcon-mamba-7b, the VLM and the audio
model trained through ``repro_torch.train.loop.fit`` — at a realistic
size — and the dry run (``repro_torch.launch.dryrun``) held against what
the card measured. Phases (8d, 8d', 8e, 8e', 8f, 8g, 10, 10b, 10c, 10d,
10e, 10f and 11 run in that order after 8c, each model freed before the
next, and before 9):

  1. card      name and power limit (nvidia-smi)
  2. build     nvcc build of every kernel library, with its seconds
  3. K1        the resident megakernel against its plain PyTorch version
               on the card, bit for bit, over infix x match x block_b
               {64, ..., 512, 1024, 2048} x B {0, 1, 257, 4096, 8192,
               16384, 65536, 1,048,576}, on the realistic dictionary
               (shared-memory tables) and on a ~60K-key grown dictionary
               (global memory); every launch's lanes a word and blocks
               equal those the g++ build of the launcher's rule and walk
               gives (build.host_resident_walk), the launches reach every
               lane count (1, 2, 4, 8), and the phase prints them
  4. K2        the streamed megakernel against its plain version, bit for
               bit: the realistic dictionary forced to streamed, a
               262,144-key grown one (fences every 8th entry) and a
               524,288-key one (its 8-entry fences pass the shared-memory
               budget: every 16th), x dict_block_r {1, 8, 16} x a fence
               budget (the default, and 8 KB: coarse fences) x infix x
               match x B {0, 1, 257, 65536} (the full grid); then through
               stem_fused at B = 65536, its launches = planned_launches, x
               num_buffers {1, 2, 4} x skip_index (accepted, no effect),
               and at block_b 1024 and 2048
  5. K3        both persistent variants against their plain versions,
               roots, sources and flags, version_slot {0, 5}, block_b 256,
               1024, 2048: the resident one on both K1 dictionaries at B
               {1, 257, 4096, 8192, 16384, 65536, 1,048,576}, lanes and
               blocks checked against the rule as for K1; the streamed one
               through visit-budget chunks on the three streamed
               dictionaries
  5b. K4       the text front end against its plain version, identical
               rows, by the launcher's rule (its lanes a word checked
               against the g++ build of the rule, build.host_text_lanes)
               and at every lane count G (1, 8) through the
               measurement builds that fix it: documents with every
               clitic, function word, mark and letter variant, over-long
               words, empty and punctuation-only documents, at block_w
               {128, 256, 1024, 2048} (their rows equal the host front
               end's); a one-codepoint tile; an index chunk's tile at the
               index path's block_w 2048; a ~7M-codepoint tile of
               1,048,576 words, whose rows equal the word stream's; every
               rule's lane count reached
  5c. K5       the three postings instances against the plain version,
               identical hist and rank, each launch's instance read from
               its counter: the counting one at block_w {8, 128, 1024,
               2048, 8192} and the bitonic one at 65536 (in global-memory
               scratch rows), on all ids dropped, one root, the realistic
               vocabulary's ids and those ids with 1 in 20 outside [0,
               n_roots]; the sliced one at block_w {128, 2048, 4096} on
               the 262,144-key dictionary's vocabulary: all dropped, one
               root, its ids, both sides of every slice edge, 1 in 20
               outside it; the overflow guard raises
  5f. K6-K8    the staged Compare path's kernels against their plain
               versions, bit for bit: K6 (the standalone datapath) over
               batch sizes {0, 1, 257, 65536} x block_b {64, 256, 1024},
               zero pad columns; K7 (the banked comparator bank) over
               (block_n, block_r) {(1,1), (2,8), (4,2), (16,200)} x tables
               with and without padding, the grown quad table shuffled
               (974 KB, banked in chunks) and a table whose entries all
               share one bank, with the padding-hit keys -2, -1 and the
               sentinel and keys in the one bank; each table's largest
               bank and compares a key; K8 (the sorted search) on the
               realistic tables, a 32,768-entry table and the 262,144-key
               grown dictionary's tri table (the shared instance) and its
               quad table (the global one), each launch's instance read
               from its counter, the sentinel hitting exactly where the
               table was padded, keys also at a 4-byte offset and in a
               count that is not a multiple of 4
  5g. staged   1,048,576 words through stem_batch(backend="pallas") (5 K7
               launches), ops.extract_roots_multilaunch (1 K6 + 5 K7) and
               extract_roots(backend="fused", extended=True) (7 K8), each
               with the launch counters set to 0 just before it: equal to
               the fused path, the fused path and the plain sorted
               extended path; Table-6 recall through the bank, exactly
  5h. models   the paper's three execution models from configs.paper
               PRESETS, words/s each: software (stem_sequential, dense,
               the first 4096 words), non_pipelined (stem_batch, dense, in
               batches of 65,536), pipelined (stem_pipelined, the bank,
               microbatches of 4096, 1,048,576 words), pipelined_sorted;
               each equal to the fused path; the pipelined/software ratio,
               a profile of extract_roots_multilaunch by kernel, and the
               repo's fused_vs_multilaunch ratio (reported, not
               claimed)
  5d. index    build_corpus_index over 1,048,576 corpus words (block_b =
               block_w = 2048), launches counted from zero (K5 on its
               counting instance), bit-identical to the host build; the
               same corpus from text through build_root_index_text, equal
               to it; the same words on the 262,144-key dictionary (K2,
               and K5 on its sliced instance), bit-identical to the host
               build
  5e. text     256 requests of 16 documents of 256 words through the
               engine with the kernel front end, resident and persistent,
               every request equal to the host front end and the plain
               stemmer
  6. serve     1,048,576 corpus words in 256 requests of 4096 through the
               engine, three ways, each run's kernel launches counted from
               zero: resident (K1); persistent on the 262,144-key
               dictionary (K3 streamed); persistent on the realistic one
               (K3 resident); then the two resident ways again in the
               other order. Every request equals the plain sorted-search
               stemmer, every retire's checksum (and flags, read from the
               slots' host-mapped memory) is verified, and launches equal
               the planned launches
  6b. faults   the same 256 requests, persistent on the realistic
               dictionary (block_b 256, 16 tiles a launch, 2 in flight),
               under a FaultPlan: two dispatch failures, one corrupted
               retire, one wedge after 5 retired descriptors (watchdog
               0.05 s) and one poison request; every other request equals
               the plain stemmer, the poison one is quarantined, and the
               counters, fired log and events are the ones the plan
               implies (5 x 256 words salvaged, K3 resident 256 launches,
               K1 one); a DegradationPolicy driven by queue pressure walks
               persistent -> megabatch x16 -> per-tile -> streamed-dict and
               back, every request equal to the plain stemmer, K3
               resident, K1 and K2 each launched; a journaled serve
               dropped mid-drain with a torn journal tail, recovered by
               Engine.recover over DictStore.restore, together equal to
               the plain stemmer; the fault-free persistent serve with and
               without the journal, twice each; one 1M-word K3 resident
               launch into host-mapped flags polled by the host until it
               completes (the count never falls, the final flags equal the
               plain version's, read with no copy)
  7. extract   the same words through core.stemmer.extract_roots
               (backend "fused") on the 262,144-key dictionary, which
               streams them through K2
  8. accuracy  Table-6 root recall through the megakernel, exactly
  8b. K9       flash attention against its plain version, fp32 (rtol =
               atol = 1e-5) and bf16 (2e-2): the reference test's grid
               (B=2, H=3, D=64, T/block_q/block_k (128,128,128),
               (256,128,128), (256,64,128), (512,128,64), causal and not),
               head_dim 32-256 and 576, llama3-8b's [1, 32, 4096, 128] and
               gemma-2b's head_dim 256 at T=2048; each case's instance
               (wgmma: bf16 at head_dim 64/128/256; fma: the rest) read
               from its counter
  8c. LM       llama3-8b at full width (32 layers, d 4096, fp32 weights
               drawn from a seeded CUDA generator, bf16 compute): K9
               through its entry point on layer 0's q, k, v after rope over
               4096 random tokens (K/V repeat_interleave'd to 32 heads),
               launches counted from zero, against the port's
               _attend_chunked (chunk 512) at fp32; then 8 requests of 16
               prompt tokens and 4 new served by Engine + LMDecodeWorkload
               on 4 slots (152 decode steps, prefill-by-decode):
               tokens/s, the wall, decode_step's share, a profile of two
               decode steps by kernel; every request max_new tokens, every
               logit finite, no kernel launched; prefill against
               prefill-by-decode on a 32-token prompt of its own, checked
               in bf16 and fp32 on the same weights cut to 2 layers,
               reported at all 32
  8d. moe     deepseek-v2-lite-16b at full width and depth (27 layers:
               MLA with kv_lora 512, one dense layer, then 64 experts
               top-6 and 2 shared; 15.7 B fp32 parameters, 62.8 GB, drawn
               from a seeded CUDA generator, bf16 compute): its first MoE
               block at fp32 over 64 tokens on the card and on the CPU
               (every token past a 1e-5 routing margin to the same
               experts, the output within 1e-4 of its scale); then 8c's
               traffic and checks (8 requests of 16 + 4 tokens on 4
               slots, the checks' 32-token prompt), the capacity of a
               prompt's and a decode step's tokens keeping every
               assignment, prefill against
               prefill-by-decode at 2 layers (the dense one and an MoE
               one); the kernels a step, the device's busy share, peak
               memory
  8d'. moe    qwen3-moe-235b-a22b at full width cut to 2 layers (128
               experts top-8, GQA with 4 KV heads; 6.2 B parameters): the
               same, 4 requests
  8e. mamba   falcon-mamba-7b at full width and depth (64 Mamba-1 layers,
               d_inner 8192, N 16, dt_rank 256; 7.0 B fp32 parameters,
               28.0 GB, from a seeded CUDA generator): one of its blocks
               at fp32 over 64 tokens on the card and on the CPU (output
               and final state within 1e-4 of their scale); a decode
               step at long_500k's last position, 524,287 (its caches'
               bytes, the same at position 0, and its logits equal to
               position 0's); then 8c's traffic and checks, prefill
               against prefill-by-decode at 2 layers, a profile of two
               decode steps by kernel and by kind
  8e'. hymba  hymba-1.5b at full width and depth (1.66 B; sliding-window
               attention over 1024 positions beside Mamba heads): 8c's
               traffic and checks; then at 2 layers in fp32 a prefill of
               1,280 tokens into the ring (rolled so that position p sits
               at slot p % 1024) and 8 decode steps past the window, each
               step's logits within 5e-4 of the full forward's
  8f. vlm     llama-3.2-vision-11b at full width and depth (32 self + 8
               cross layers; 9.78 B, 39.1 GB): make_prefill_step on 4
               prompts with vision embeddings [4, 1601, 4096] bf16 from a
               seeded generator, 16 greedy decode steps over the
               prefilled cross keys and values, launches counted from
               zero, every logit finite; prefill against prefill-by-decode
               at 2 layers (a cross and a self layer) in bf16 and fp32,
               reported at 2 whole groups; then 8c's traffic, text-only
               with zero cross caches (the grouped self-caches merged on
               axis 2)
  8g. audio   musicgen-medium at full width and depth (48 layers, d 1536,
               24 heads x 64, d_ff 6144, 4 codebooks of 2048; 1.38 B fp32
               parameters, 5.54 GB, from a seeded CUDA generator): its
               embeddings, first block, final norm and heads at fp32 over
               64 positions of [1, 64, 4] tokens on the card and on the
               CPU, logits within 1e-4 of their scale; then 8c's traffic
               and checks (1-D prompts, each id in every codebook and
               codebook 0's greedy id emitted, as the reference serves
               them); prefill against prefill-by-decode on 4 prompts of
               [32, 4] distinct ids at 2 layers in bf16 and fp32; the
               kernels a step, the device's busy share, peak memory
  10. train    gemma-2b at full width and depth (18 layers, d 2048, 8
               heads x 256, 1 KV head, d_ff 16384, vocab 256,000 tied;
               2.51 B fp32 parameters from a seeded CUDA generator,
               rescaled to a trainable fan-in, bf16 compute) trained 8
               steps through train.loop.fit: remat "full", B 1, T 4096
               (the query blocks of 512 checkpointed, the chunked loss),
               synthetic batches over 64 ids, lr 3e-3, warmup 20, AdamW
               with fp32 moments, launches counted from zero; every loss
               and gradient norm finite, the last loss below the first, no
               kernel of the port launched; ms a step, tokens/s, 6 N
               tokens/s as TFLOP/s and a share of 989, peak memory; one
               more step split by CUDA events (forward, backward, update),
               one profiled (kernels, device busy share, kernel time by
               kind and by op) and the weight casts one step makes
               (fp32 -> bf16 forward, bf16 -> fp32 backward), timed alone
  10b. remat   the same width at 2 layers, T 4096: a step under "none",
               "dots" and "full" from the same weights and batch, loss and
               gradient norm within 1e-3 of "none"; each policy's memory
               kept for the backward pass, peak memory and second step
  10c. example the example's model (examples/torch_train_lm.py, 69 M
               parameters) on the morph stream, the stemmer on the card: 30
               steps with a checkpoint every 15, then resumed to 40:
               resumed_from 30, the checkpoint equal bit for bit to the
               trained weights, the resumed run's first loss that of those
               weights, the loss falls
  10d. moe    deepseek-v2-lite-16b at full width cut to 5 layers (the
               dense one and 4 MoE ones; 2.84 B parameters, 45.4 GB of
               weights, gradients and moments) trained as 10: 8 steps
               through fit, B 1, T 4096 (MLA's 512-query blocks), remat
               "full", 6 N tokens/s with N the active parameters (routed
               experts at 6/64, the head counted, the embedding not);
               the aux loss before and after two steps; those two steps
               run again from the same seed give bit-identical losses
  10e. ssm    trained as 10 (8 steps through fit, B 1, T 4096, remat
               "full", rescaled weights): hymba-1.5b at full width cut to
               4 layers, falcon-mamba-7b at full width cut to 4 layers
               (the scan's [1, 4096, 8192, 16] fp32 tensors),
               llama-3.2-vision-11b cut to one group (1 cross +
               4 self layers, 2.1 B; the training launcher's vision
               embeddings); before each, the first batch's gradient norm
               at the reference's own init
  10f. audio  musicgen-medium at full width and depth trained as 10 (8
               steps through fit, B 1, T 4096, remat "full", rescaled
               weights) on synthetic [1, 4096, 4] batches, one stream a
               codebook (22.1 GB of weights, gradients and moments);
               phases 10 and 10f also read the memory held at one AdamW
               update (parameters, gradients, moments, batch)
  12. devices several devices, after 7b: make_data_mesh over every GPU
               there is (one on the card) and explicit meshes that repeat
               cuda:0 (4 and 5 shards on one GPU, run one after another on
               its stream: not four GPUs); shard_batch over the 1M serve
               words and B 7 and 100 on the realistic (K1) and the
               262,144-key (K2) dictionaries, equal to phases 6-7's
               unsharded results, checksums verified, at 1 and 4 shards;
               Engine + StemmerWorkload(data_devices=4) over the 256
               requests; the 1M-word index on 4 shards equal to 7b's; the
               5-stage pipeline_map on 5 entries over 1,024 words (K6 a
               tick) equal to the plain stemmer. Each of these runs is
               warmed up, then timed with the launch counters set to 0
               just before and read just after (the 4-shard ones summed
               into the kernels line). Then, untimed, while the CLI with
               --devices 1 runs in a process of its own: the ragged
               batches, and the serve again with a device lost at one
               launch (the ladder's devices-2 rung, then served on 2
               shards with the streamed override), every request exact
  13. examples the six examples ported, in-process after 12, each as
               main(["--device", "cuda:0"]) loaded from examples/:
               torch_quickstart, torch_serve_stemmer (K1),
               torch_serve_text (K4 + K1), torch_index_corpus (K1 + K5),
               torch_serve_decode (no kernel) and torch_chaos_matrix (K1,
               K3 in the stall scenario, K5 in the checkpoint one); each
               checks itself and raises (SystemExit) on a mismatch, which
               ends the script. A line an example: its wall seconds and
               what it checked, and its launches counted from 0 just
               before it (kept out of the kernels line's counts)
  11. dryrun  launch.dryrun --all over its 32 cells, in a process of its
               own on the host's CPU started after the build (the meta
               device, no CUDA device visible), every line printed, all 32
               OK, with its seconds; then its functions applied to the
               configurations measured here: the argument bytes of 10's
               gemma-2b and 10f's musicgen-medium within 1% of the memory
               held at their AdamW update, the bytes kept for the backward
               pass within 10% (or 0.05 GB) of 10b's under "none", "dots"
               and "full", the predicted peak beside the fit's (ratio
               reported, not checked), and each steady step no faster than
               the roofline's compute term (989 TFLOP/s bf16)
  9. times     the launch floor (a one-element torch op, same timer);
               the registers and spills of every instance of the resident
               kernels, K4 and K7/K8 (the build's -Xptxas -v log); each
               kernel's device time with
               CUDA events at 4096 and
               1,048,576 words (K1 and K3 resident with their lanes a word
               and blocks, their bank instance too; K1 at 4096 words and at
               an index chunk, 131,072 words at block_b 2048, at each lane
               count through measurement builds that fix it; K4: a served
               request's tile and the 1,048,576-word tile, by the rule and
               at each lane count through its measurement builds; K5: an
               index chunk of 131,072 words and
               1,048,576 words (counting), an index chunk of the 262,144-key
               vocabulary (sliced), 1,048,576 words at block_w 65536
               (bitonic), with torch.sort of the same keys beside each;
               K7 and K8: the tri group's 6 keys a word, with
               torch.isin of the same keys beside them, K7 with its
               banks' compares; K8 also on the 262,144-key dictionary's
               tri and quad tables at 1,048,576 words, its instance,
               threads, blocks and tree step printed), its wall time per
               call with the host's share, the plain version's wall time
               per call, the streamed kernels' fence step and bytes, the
               reference's visit pre-pass (which the port no longer runs)
               and its tile visits, and a bound; K9 at llama3-8b's attention
               shape, bf16 (wgmma) and fp32 (fma), and at gemma-2b's
               [1, 8, 2048, 256] in bf16, each with
               scaled_dot_product_attention of the same tensors beside it
               and its share of the bound

Imports nothing of jax or of the ``repro`` package. Any failed check
raises, so the script exits non-zero and prints no result line; it also
exits non-zero without a CUDA device. The last line is the JSON result.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# Table-6 root recall over build_corpus(2000, seed=0) (BENCH_stemmer.json)
RECALL_WITH_INFIX = 0.8914728682170543
RECALL_WITHOUT_INFIX = 0.8062015503875969
# H100 SXM peaks (published data sheet): HBM bytes/s, and the
# non-tensor-core 32-bit rate used as the peak for the kernels' int32 ops
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# int32 operations per word for stages 1-4 (count nonzero 16, prefix run
# 5 x 4, suffix run 16 x 3, then per prefix cut: two valid_s tests ~10,
# five packs x 6, infix test 3, flags ~6) and per bisection probe (mid
# add+shift, clamp 2, load, compare, 2 selects, +1)
DATAPATH_OPS_PER_WORD = 16 + 5 * 4 + 16 * 3 + 6 * (10 + 5 * 6 + 3 + 6)
OPS_PER_PROBE = 9
WORD_BYTES = 16 * 4 + 4 * 4 + 4          # word row in, root + source out
SERVE_WORDS = 1 << 20
SERVE_REQUEST_WORDS = 4096
# phase 6b: the faulted persistent serve's plan (dispatch events 3 and 7
# fail, the 3rd retire is corrupted, the 6th persistent launch wedges
# after 5 descriptors, request 200 fails every dispatch) and its watchdog.
# The corrupted retire comes before the wedge, so it is a K3 launch's
FAULT_DISPATCH_AT = (3, 7)
FAULT_RETIRE_AT = 2
FAULT_STALL_AT = 5
FAULT_RETIRED_TILES = 5
FAULT_POISON_RID = 200
FAULT_WATCHDOG_S = 0.05
# the ladder walk: requests of 1024 words, one admitted at a time (a mode
# lands only at a tick whose ring is empty), queue pressure down to the
# bottom rung and healthy steps back up
LADDER_REQUESTS = 128
LADDER_REQUEST_WORDS = 1024
LADDER_QUEUE_HIGH = 100
LADDER_DOWN_AFTER = 2
LADDER_UP_AFTER = 10
# the journaled serve dropped after this many engine steps
KILL_STEPS = 64
GROWN_KEYS = 262_144
# a dictionary whose 8-entry fences do not fit one block's shared memory
FENCE_KEYS = 524_288
K2_SMALL_FENCE_BUDGET = 8192        # bytes: coarse fences, F >= 128
K1_BATCHES = (0, 1, 257, 4096, 8192, 16384, 65536, 1 << 20)
K1_BLOCKS = (64, 128, 256, 512, 1024, 2048)
K2_BATCHES = (0, 1, 257, 65536)
K2_DICT_BLOCK_RS = (1, 8, 16)
K2_NUM_BUFFERS = (1, 2, 4)
K3_BATCHES = (1, 257, 65536)       # the streamed variant
K3_RESIDENT_BATCHES = (1, 257, 4096, 8192, 16384, 65536, 1 << 20)
K3_VERSION_SLOTS = (0, 5)
WIDE_BLOCKS = (1024, 2048)          # the block_b repair: tiles > 512 threads
K4_BLOCK_WS = (128, 256, 1024, 2048)
K5_BLOCK_WS = (8, 128, 1024, 2048, 8192, 65536)
K5_MAX_TILES = 512                  # the K5 parity cases' tiles at most
# the sliced instance's parity cases on the 262,144-key vocabulary: tiles
# of 128, 2048 (the index path's) and 4096 lanes, at most 64 tiles a case
K5_SLICED_BLOCK_WS = (128, 2048, 4096)
K5_SLICED_TILES = 64
K6_BATCHES = (0, 1, 257, 65536)
K6_BLOCKS = (64, 256, 1024)
K7_BLOCKS = ((1, 1), (2, 8), (4, 2), (16, 200))
K8_BLOCK_NS = (1, 8)
SOFTWARE_WORDS = 4096               # stem_sequential: one word a step
# bytes a word through the standalone datapath (K6): the word row in, two
# int32[32] rows (keys, valid) out
K6_BYTES_PER_WORD = 16 * 4 + 2 * 32 * 4
INDEX_WORDS = 1 << 20
INDEX_CHUNK = 1 << 17
INDEX_WORDS_PER_DOC = 512
INDEX_BLOCK = 2048                  # block_b = block_w of the index path
FORCED_LANES = (1, 2, 4, 8)          # K1's measurement builds, phase 9
TEXT_REQUESTS = 256
TEXT_DOCS_PER_REQUEST = 16
TEXT_WORDS_PER_DOC = 256
TEXT_CHAR_BLOCK = 2048
# int32 operations of the text front end (K4): per codepoint of a word's
# window (classify ~4, the 20-entry shift register 20, count 2) and per
# word row with a word (packed key 9, 7 probes x 9, proclitic scan ~50,
# the three tail reads 60, enclitic scan ~50, the 16 shifted outputs 80);
# an empty row stores zeros (~5)
K4_OPS_PER_CHAR = 26
K4_OPS_PER_WORD = 9 + 7 * 9 + 50 + 60 + 50 + 80
K4_OPS_PER_EMPTY_ROW = 5
# int32 operations the postings function (K5) needs, whatever algorithm
# computes it: per tile a counting pass over its words (read an id, bump
# its bin), an exclusive scan of the n_roots + 1 bins, and each word's
# stable rank (its bin's start and the equal ids before it): about 4 a
# word and 2 a bin, O(block_w + n_roots) a tile. The kernel's own work
# (ballots, a scan of the bins down the warps, a slice's tile read again;
# the bitonic network and bisections) is more; it is not the bound.
K5_OPS_PER_WORD = 4
K5_OPS_PER_BIN = 2
# K9: the reference test's grid (B=2, H=3, D=64) and head dims (and 576,
# which the FMA instance takes in output chunks), llama3-8b's prefill
# attention at train_4k's length and gemma-2b's head_dim 256;
# tolerances rtol = atol, the reference test's own
K9_GRID = ((128, 128, 128), (256, 128, 128), (256, 64, 128), (512, 128, 64))
K9_HEAD_DIMS = (32, 64, 128, 256, 576)
K9_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# gemma-2b's attention (8 heads, head_dim 256) at T = 2048
GEMMA_ATTN_SHAPE = (1, 8, 2048, 256)
# H100 SXM dense peaks for K9's bound: bf16 tensor cores; plain fp32 (the
# reference's 1e-5 tolerance rules out TF32)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# the dense LM path at full width: llama3-8b, layer 0's attention over
# 4096 tokens (_chunk_q(4096) = 512), and serving 8 requests of a 16-token
# prompt and 4 new tokens on 4 slots: twice as many requests as slots, so
# every slot is refilled. Every LM serve phase takes this traffic; its
# decode steps (19 a request) set most of their time, so they are kept to
# what the script's time aim allows. Prefill is held against
# prefill-by-decode on a prompt of its own, LM_PROMPT ids (the serve
# generator's first draw), in caches of LM_CACHE = 32 + 4 - 1 positions
LM_ARCH = "llama3-8b"
LM_ATTN_T = 4096
LM_SLOTS = 4
LM_REQUESTS = 8
LM_SERVE_PROMPT = 16
LM_PROMPT = 32
LM_NEW = 4
LM_CACHE = LM_PROMPT + LM_NEW - 1
# K9 against the LM's attention: relative to the largest |output|
LM_ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# prefill against prefill-by-decode, relative to the largest |logit|, on
# the full-width weights cut to LM_CHECK_LAYERS layers: the two paths
# round their products over matrices of other shapes, and at this random
# init (scores with a std of about 250, a nearly one-hot softmax) each
# layer multiplies such a difference about five times, so at 32 layers
# even fp32 rounding grows to O(1) (reported, not checked)
LM_CHECK_LAYERS = 2
LM_PREFILL_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
# For MLA (phase 8d's deepseek-v2-lite) the bf16 tolerance holds at the
# check's own prompt (LM_PROMPT ids, numpy seed 0), not at every prompt:
# the unabsorbed prefill and the absorbed decode round their bf16
# products apart, by up to about 2e-1 of the largest |logit| at 2 layers
# over other prompts, in the reference as in the port, with or without
# the MoE layer (tests/test_torch_mla.py::
# test_bf16_prefill_against_decode_gap_is_the_references,
# chip_moe_prefill.py); in fp32 they agree within 1e-4
# phase 10: training at full width and depth. gemma-2b (2.51 B parameters,
# vocab 256,000 tied) with the reference CLI's learning rate and warmup,
# B 1 and T 4096, which takes the checkpointed query blocks (chunk 512)
# and the chunked loss; synthetic batches over 64 live ids
TRAIN_ARCH = "gemma-2b"
TRAIN_B = 1
TRAIN_T = 4096
TRAIN_STEPS = 8
TRAIN_LR = 3e-3
TRAIN_WARMUP = 20
TRAIN_LIVE_IDS = 64
# 10b: the remat policies at this many layers of the same width; loss and
# gradient norm relative to "none" (the backward's sums on the card may
# run in another order from one run to the next)
REMAT_LAYERS = 2
REMAT_TOL = 1e-3
# 10c: the example's model and data (examples/torch_train_lm.py), trained
# to the first count with a checkpoint every EXAMPLE_CKPT_EVERY steps,
# then resumed to the second
EXAMPLE_STEPS = (30, 40)
EXAMPLE_CKPT_EVERY = 15
EXAMPLE_BATCH = 8
EXAMPLE_SEQ = 128
# phase 8d: the MoE families at full width. deepseek-v2-lite-16b (MLA
# with kv_lora 512, one dense layer, then 26 MoE layers of 64 experts
# top-6 and 2 shared; 15.7 B parameters, 62.8 GB in fp32) served at full
# depth with phase 8c's traffic, after one of its MoE blocks is run at
# fp32 over MOE_BLOCK_T tokens on the card and on the CPU (routing alike
# past MOE_MARGIN, the output within MOE_BLOCK_TOL of its scale); 8d':
# qwen3-moe-235b-a22b (128 experts top-8, no shared or dense layer, GQA
# with 4 KV heads) at full width cut to MOE_QWEN_LAYERS layers (6.1 B
# parameters, 24 GB), MOE_QWEN_REQUESTS requests
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_BLOCK_T = 64
MOE_MARGIN = 1e-5
MOE_BLOCK_TOL = 1e-4
MOE_QWEN_ARCH = "qwen3-moe-235b-a22b"
MOE_QWEN_LAYERS = 2
MOE_QWEN_REQUESTS = 4
# phase 10d: deepseek-v2-lite-16b trained at full width with its depth cut
# to MOE_TRAIN_LAYERS (the dense layer and 4 MoE layers: 2.84 B
# parameters, 45.4 GB of fp32 weights, gradients and AdamW moments at 16
# B a parameter; the whole model's 251 GB fits no card), phase 10's
# settings otherwise; then MOE_REPEAT_STEPS steps again from the same seed
MOE_TRAIN_LAYERS = 5
MOE_REPEAT_STEPS = 2
# phases 8e, 8e' and 8f: the Mamba, Hymba and VLM families at full width
# and depth, each served with phase 8c's traffic. 8e: falcon-mamba-7b (64
# Mamba-1 layers, d_inner 8192, N 16, dt_rank 256; 7.0 B parameters,
# 28.0 GB in fp32); one of its blocks at fp32 over SSM_BLOCK_T tokens on
# the card and on the CPU (output and state within SSM_BLOCK_TOL of their
# scale); a decode step at long_500k's last position, LONG_POS. 8e':
# hymba-1.5b (sliding-window attention over 1024 positions beside Mamba
# heads; 1.66 B); RING_PREFILL tokens prefilled past the window, then
# RING_STEPS decode steps on the ring cache at RING_LAYERS layers in fp32,
# each step's logits within RING_TOL of the full forward's at that
# position. 8f: llama-3.2-vision-11b (32 self + 8 cross layers; 9.78 B,
# 39.1 GB): make_prefill_step on VLM_BATCH prompts with vision embeddings
# [VLM_BATCH, 1601, 4096] bf16, then VLM_DECODE_STEPS decode steps
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "hymba-1.5b"
VLM_ARCH = "llama-3.2-vision-11b"
SSM_BLOCK_T = 64
SSM_BLOCK_TOL = 1e-4
LONG_POS = 524_287
RING_PREFILL = 1280
RING_STEPS = 8
RING_LAYERS = 2
RING_TOL = 5e-4
VLM_BATCH = 4
VLM_DECODE_STEPS = 16
# phase 10e: phase 10's training (B 1, remat "full", TRAIN_STEPS steps
# through fit) of hymba-1.5b at full width cut to HYBRID_TRAIN_LAYERS
# layers, falcon-mamba-7b at full width cut to SSM_TRAIN_LAYERS layers at T
# SSM_TRAIN_T (the whole model's 112 GB at 16 B a parameter fits no card;
# each layer's scan keeps [1, T, 8192, 16] fp32 tensors of 2.15 GB at T
# 4096 for the backward pass) and the VLM at full width cut to
# VLM_TRAIN_GROUPS group (one cross and four self layers). The depths keep
# the whole script inside its time aim: hymba at 32 layers and
# falcon-mamba at 16 took 190-199 s of it; a layer's step is the same at
# any depth
SSM_TRAIN_LAYERS = 4
HYBRID_TRAIN_LAYERS = 4
SSM_TRAIN_T = 4096
VLM_TRAIN_GROUPS = 1
# phases 8g and 10f: the audio family, musicgen-medium at full width and
# depth (48 layers, d 1536, 24 heads x 64, d_ff 6144, 4 codebooks of 2048;
# 1.38 B parameters, 5.54 GB in fp32). 8g serves it with phase 8c's
# traffic (1-D prompts, each id in every codebook, as the reference
# serves it), runs its embedding, first block, final norm and heads at
# fp32 over AUDIO_BLOCK_T positions of [1, T, 4] tokens on the card and
# on the CPU (logits within AUDIO_BLOCK_TOL of their scale), and holds
# prefill against prefill-by-decode on LM_SLOTS [T, 4] prompts at
# LM_CHECK_LAYERS layers. 10f trains it as phase 10 on [1, 4096, 4]
# batches, 22.1 GB of weights, gradients and AdamW moments
AUDIO_ARCH = "musicgen-medium"
AUDIO_BLOCK_T = 64
AUDIO_BLOCK_TOL = 1e-4
# phase 11: the dry run's predictions of the configurations phases 10,
# 10b and 10f measured: argument bytes within ARGS_TOL of the state the
# card holds at the AdamW update, the bytes kept for the backward pass
# within KEPT_TOL (or KEPT_FLOOR_GB, whichever is larger) of 10b's
ARGS_TOL = 0.01
KEPT_TOL = 0.10
KEPT_FLOOR_GB = 0.05
DRYRUN_CELLS = 32
# phase 12: several devices. The card has one GPU, so the meshes of
# DEVICE_SHARDS and PIPELINE_STAGES entries repeat cuda:0 (Mesh.of): their
# shards run one after another on its stream
DEVICE_SHARDS = 4
SHARD_MEGABATCH = 4          # 4 x 256 x 4 = 4096 rows a launch
RAGGED_BATCHES = (7, 100)
DEVICE_LOSS_AT = 128         # the 129th sharded launch loses a device
AFTER_LOSS_REQUESTS = 8      # served on the ladder's devices-2 rung
# phase 13: the examples ported (examples/torch_<name>.py), run in-process
# in this order, and the kernels each must launch on the card
EXAMPLES = (("quickstart", ()),
            ("serve_stemmer", ("stem_fused_cuda",)),
            ("serve_text", ("text_frontend_cuda", "stem_fused_cuda")),
            ("index_corpus", ("stem_fused_cuda", "postings_cuda")),
            ("serve_decode", ()),
            ("chaos_matrix", ("stem_fused_cuda", "persistent_resident_cuda",
                              "postings_cuda")))
PIPELINE_STAGES = 5
PIPELINE_WORDS = 1024
PIPELINE_MICROBATCHES = 8
BLOCK_B = 256
DEVICE = "cuda"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def call_ms(fn, n: int) -> float:
    """Wall time per call, host included: n calls after a warm-up, then a
    synchronize."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def device_ms(fn, n: int, host_ms: float) -> float:
    """Device time per call: CUDA events around n back-to-back calls,
    queued behind a spacer kernel that keeps the card busy until the host
    has queued them all, so host time between launches is not counted."""
    import torch

    cycles = int(4 * n * host_ms * 1e-3 * 2e9)   # > 4x the queueing time
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        queued_in_time = not start.query()
        stop.synchronize()
        if queued_in_time:
            return start.elapsed_time(stop) / n
        cycles *= 4
    raise RuntimeError("chip_smoke: the host never got ahead of the card")


def event_ms(fn, n: int) -> float:
    """Device time per call for a function that synchronizes inside (as
    torch.isin does), so no spacer can hold its launches back: CUDA events
    around n back-to-back calls after a warm-up; the host's time between
    its kernels counts."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def same(got, want) -> int:
    """Rows or entries that differ between two output tuples (or two
    tensors)."""
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    bad = 0
    for g, w in zip(got, want):
        d = g != w
        bad += int(d.any(1).sum() if d.dim() == 2 else d.sum())
    return bad


def max_err(got, want) -> int:
    return max((int((g - w).abs().max()) for g, w in zip(got, want)
                if g.numel()), default=0)


@contextlib.contextmanager
def plain_kernels(sf):
    """Route every CUDA wrapper of stem_fused to its plain version on the
    card, so a whole stem_fused call (pre-pass, chunks) can be run both
    ways on the same inputs; the kernels' launch counters do not move."""
    names = {"stem_fused_cuda": sf.stem_fused_plain,
             "stem_streamed_cuda": sf.stem_streamed_plain,
             "persistent_resident_cuda": sf.persistent_resident_plain,
             "persistent_streamed_cuda": sf.persistent_streamed_plain}
    saved = {n: getattr(sf, n) for n in names}
    try:
        for n, fn in names.items():
            setattr(sf, n, fn)
        yield
    finally:
        for n, fn in saved.items():
            setattr(sf, n, fn)


def wrapper(sf, name: str):
    """A CUDA wrapper of stem_fused by name, as ops counts its launches."""
    return {w.__name__: w for w in sf.CUDA_WRAPPERS}[name]


def resident_shape(wrapper_fn, b: int, block_b: int, shapes: set,
                   n_desc: int | None = None) -> None:
    """Check the lanes a word and blocks a resident wrapper's last launch
    took (K1's over b words, or K3 resident's over a ring of n_desc
    tiles) against those the g++ build of the launchers' rule and walk
    gives for this card, and note them in `shapes`."""
    import torch

    from repro_torch.kernels import build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if n_desc is None:
        walk = build.host_resident_walk(b, 1, b, 1, sms=sms,
                                        persistent=False)
    else:
        walk = build.host_resident_walk(n_desc * block_b, n_desc, block_b,
                                        wrapper_fn.last_capacity, sms=sms,
                                        persistent=True)
    got = (wrapper_fn.last_lanes, wrapper_fn.last_grid)
    check(got == (walk["lanes"], walk["grid"]),
          f"{wrapper_fn.__name__} B={b} block_b={block_b}: lanes, grid {got},"
          f" the rule's {(walk['lanes'], walk['grid'])}")
    shapes.add((b, block_b) + got)


def visit_tables(sf, w, tiles, *, infix: bool, skip_index: bool = True,
                 block_b: int = BLOCK_B):
    n_groups = 5 if infix else 2
    keys, valid = sf._candidates(sf._pad_words(w, block_b), n_groups)
    return sf._visit_tables(keys, valid, tiles, n_groups=n_groups,
                            block_b=block_b, skip_index=skip_index)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------
def k1_phase(sf, ops, realistic, grown60k, words):
    import torch

    t0 = time.perf_counter()
    worst, cases, shapes = 0, 0, set()
    for dict_name, arrays, want_shared in (("realistic", realistic, True),
                                           ("grown", grown60k, False)):
        for infix in (True, False):
            n_groups = 5 if infix else 2
            for match in ("bsearch", "bank"):
                tables = sf.padded_tables(arrays, match=match, infix=infix)
                check(sf.dict_in_shared(tables, n_groups=n_groups)
                      == want_shared,
                      f"{dict_name} tables expected in"
                      f" {'shared' if want_shared else 'global'} memory")
                for b in K1_BATCHES:
                    w = words[:b]
                    if b == 0:   # the wrapper returns early, no launch
                        before = ops.dispatch_count()
                        r, s = sf.stem_fused(w, arrays, infix=infix,
                                             match=match)
                        check(r.shape == (0, 4) and s.shape == (0,)
                              and ops.dispatch_count() == before,
                              "B=0 must return empty outputs, no launch")
                        continue
                    want = sf.stem_fused_plain(w, tables, n_groups=n_groups,
                                               match=match, block_b=BLOCK_B)
                    for block_b in K1_BLOCKS:
                        got = sf.stem_fused_cuda(w, tables, n_groups=n_groups,
                                                 match=match, block_b=block_b)
                        torch.cuda.synchronize()
                        bad = same(got, want)
                        worst = max(worst, max_err(got, want))
                        cases += 1
                        check(bad == 0, f"K1 vs plain: {bad} mismatches"
                              f" ({dict_name}, infix={infix}, match={match},"
                              f" B={b}, block_b={block_b})")
                        resident_shape(sf.stem_fused_cuda, b, block_b,
                                       shapes)
                print(f"[K1] {dict_name} dict ({arrays.n_keys} keys,"
                      f" {'shared' if want_shared else 'global'} memory)"
                      f" infix={infix} match={match}: B in {K1_BATCHES} x"
                      f" block_b in {K1_BLOCKS} identical")
    print(f"[K1] lanes a word and blocks the launcher took, as the rule"
          f" gives them, (B, block_b, lanes, grid): {sorted(shapes)}")
    check({x[2] for x in shapes} == {1, 2, 4, 8},
          "K1's launches must reach every lane count")
    print(f"[K1] {cases} launches identical to the plain version,"
          f" max_abs_err {worst} ({time.perf_counter() - t0:.1f} s)")
    return worst


def k2_phase(sf, sm, ops, dicts, words):
    import torch

    t0 = time.perf_counter()
    worst, cases = 0, 0
    for dict_name, arrays in dicts:
        for dict_block_r in K2_DICT_BLOCK_RS:
            for budget in (sm.FENCE_BUDGET_BYTES, K2_SMALL_FENCE_BUDGET):
                tiles = sm.build_dict_tiles(arrays.tri, arrays.quad,
                                            arrays.bi, dict_block_r,
                                            fence_budget=budget)
                for infix in (True, False):
                    n_groups = 5 if infix else 2
                    for b in K2_BATCHES:
                        w = words[:b]
                        if b == 0:
                            before = ops.dispatch_count()
                            r, s = sf.stem_fused(w, arrays, infix=infix,
                                                 residency="streamed",
                                                 dict_block_r=dict_block_r)
                            check(r.shape == (0, 4) and s.shape == (0,)
                                  and ops.dispatch_count() == before,
                                  "streamed B=0: empty outputs, no launch")
                            continue
                        want = sf.stem_streamed_plain(
                            w, tiles, n_groups=n_groups, match="bsearch")
                        for match in ("bsearch", "bank"):
                            got = sf.stem_streamed_cuda(
                                w, tiles, n_groups=n_groups, match=match)
                            torch.cuda.synchronize()
                            bad = same(got, want)
                            worst = max(worst, max_err(got, want))
                            cases += 1
                            check(bad == 0,
                                  f"K2 vs plain: {bad} mismatches"
                                  f" ({dict_name}, dict_block_r="
                                  f"{dict_block_r}, F={tiles.fence_step},"
                                  f" infix={infix}, B={b}, match={match})")
                print(f"[K2] {dict_name} dict ({arrays.n_keys} keys,"
                      f" {tiles.n_tiles} tiles of {dict_block_r} rows,"
                      f" fence budget {budget} B: F {tiles.fence_step},"
                      f" {4 * tiles.fences.numel()} B of fences): infix x"
                      f" B in {K2_BATCHES} x match identical")
    # through the entry point: its chunks, the options of the reference's
    # walk, and tiles wider than a block of threads
    w = words[:max(K2_BATCHES)]
    for dict_name, arrays in dicts:
        budget = 64 * sf.dict_tile_count(arrays, 8)   # 64 batch tiles a launch
        runs = ([dict(block_b=BLOCK_B, num_buffers=nb, skip_index=si)
                 for nb in K2_NUM_BUFFERS for si in (True, False)]
                + [dict(block_b=bb) for bb in WIDE_BLOCKS])
        for infix in (True, False):
            for match in ("bsearch", "bank"):
                for run in runs:
                    kw = dict(run, infix=infix, match=match,
                              residency="streamed", visit_budget=budget)
                    counter = wrapper(sf, "stem_streamed_cuda")
                    before = counter.launches
                    got = sf.stem_fused(w, arrays, **kw)
                    torch.cuda.synchronize()
                    launches = counter.launches - before
                    with plain_kernels(sf):
                        want = sf.stem_fused(w, arrays, **kw)
                    bad = same(got, want)
                    worst = max(worst, max_err(got, want))
                    cases += launches
                    check(bad == 0 and launches == sf.planned_launches(
                        w.shape[0], arrays, **{k: v for k, v in kw.items()
                                               if k not in ("match",
                                                            "num_buffers",
                                                            "skip_index")}),
                          f"K2 through stem_fused: {bad} mismatches,"
                          f" {launches} launches ({dict_name}, {kw})")
        print(f"[K2] {dict_name} dict through stem_fused, B={w.shape[0]},"
              f" visit_budget {budget}: infix x match x (num_buffers in"
              f" {K2_NUM_BUFFERS} x skip_index, block_b in {WIDE_BLOCKS})"
              " identical, launches = planned")
    print(f"[K2] full grid: {cases} launches identical to the plain version,"
          f" max_abs_err {worst} ({time.perf_counter() - t0:.1f} s)")
    return worst


def k3_phase(sf, sm, ops, resident_dicts, streamed_dicts, words):
    import torch

    t0 = time.perf_counter()
    worst, cases, shapes = 0, 0, set()
    for dict_name, arrays in resident_dicts:
        for infix in (True, False):
            n_groups = 5 if infix else 2
            for match in ("bsearch", "bank"):
                tables = sf.padded_tables(arrays, match=match, infix=infix)
                for b in K3_RESIDENT_BATCHES:
                    w = words[:b]
                    # the plain version's rows of a whole ring of tiles do
                    # not depend on block_b or the version slot: once a B
                    bt = -(-b // BLOCK_B)
                    rows = sf.persistent_resident_plain(
                        w, tables, sf._descriptors(
                            bt, BLOCK_B, torch.zeros(bt, dtype=torch.int32,
                                                     device=w.device), 0),
                        n_groups=n_groups, match=match, block_b=BLOCK_B)[:2]
                    for block_b in (BLOCK_B,) + WIDE_BLOCKS:
                        bt = -(-b // block_b)
                        zeros = torch.zeros(bt, dtype=torch.int32,
                                            device=w.device)
                        for version_slot in K3_VERSION_SLOTS:
                            desc = sf._descriptors(bt, block_b, zeros,
                                                   version_slot)
                            got = sf.persistent_resident_cuda(
                                w, tables, desc, n_groups=n_groups,
                                match=match, block_b=block_b)
                            torch.cuda.synchronize()
                            want = rows + ((1 + desc[:, 2]).to(torch.int32),)
                            bad = same(got, want)
                            worst = max(worst, max_err(got, want))
                            cases += 1
                            check(bad == 0 and bool(
                                (got[2] == 1 + version_slot).all()),
                                  f"K3 resident vs plain: {bad} mismatches"
                                  f" ({dict_name}, infix={infix},"
                                  f" match={match}, B={b}, block_b={block_b},"
                                  f" version_slot={version_slot})")
                            resident_shape(sf.persistent_resident_cuda, b,
                                           block_b, shapes, n_desc=bt)
        print(f"[K3] resident, {dict_name} dict ({arrays.n_keys} keys):"
              f" infix x match x B in {K3_RESIDENT_BATCHES} x block_b in"
              f" {(BLOCK_B,) + WIDE_BLOCKS} x version_slot in"
              f" {K3_VERSION_SLOTS}: roots, sources, flags identical")
    print(f"[K3] resident: lanes a word and blocks the launcher took, as the"
          f" rule gives them, (B, block_b, lanes, grid): {sorted(shapes)}")
    check({x[2] for x in shapes} == {1, 2, 4, 8},
          "K3 resident's launches must reach every lane count")
    for dict_name, arrays in streamed_dicts:
        n_tiles = sf.dict_tile_count(arrays, 8)
        budget = 64 * n_tiles                     # chunks of 64 batch tiles
        for infix in (True, False):
            for match in ("bsearch", "bank"):
                for b, block_b in ([(b, BLOCK_B) for b in K3_BATCHES]
                                   + [(max(K3_BATCHES), bb)
                                      for bb in WIDE_BLOCKS]):
                    w = words[:b]
                    for version_slot in K3_VERSION_SLOTS:
                        kw = dict(infix=infix, match=match, block_b=block_b,
                                  residency="streamed", persistent=True,
                                  version_slot=version_slot,
                                  visit_budget=budget)
                        counter = wrapper(sf, "persistent_streamed_cuda")
                        before = counter.launches
                        got = sf.stem_fused(w, arrays, **kw)
                        torch.cuda.synchronize()
                        chunks = counter.launches - before
                        with plain_kernels(sf):
                            want = sf.stem_fused(w, arrays, **kw)
                        bad = same(got, want)
                        worst = max(worst, max_err(got, want))
                        cases += chunks
                        check(bad == 0 and bool((got[2] == 1 + version_slot)
                                                .all())
                              and chunks == sf.planned_launches(
                                  b, arrays, block_b=block_b,
                                  residency="streamed", persistent=True,
                                  visit_budget=budget),
                              f"K3 streamed vs plain: {bad} mismatches,"
                              f" {chunks} launches ({dict_name},"
                              f" infix={infix}, match={match}, B={b},"
                              f" block_b={block_b},"
                              f" version_slot={version_slot})")
        fence_step = sm.build_dict_tiles(arrays.tri, arrays.quad, arrays.bi,
                                         8).fence_step
        print(f"[K3] streamed, {dict_name} dict ({arrays.n_keys} keys,"
              f" {n_tiles} tiles of 8 rows, F {fence_step}, visit_budget"
              f" {budget}: 64 batch tiles a launch): infix x match x B in"
              f" {K3_BATCHES} (and"
              f" block_b in {WIDE_BLOCKS} at B={max(K3_BATCHES)}) x"
              f" version_slot in {K3_VERSION_SLOTS}: roots, sources, flags"
              " identical")
    print(f"[K3] {cases} launches identical to the plain versions,"
          f" max_abs_err {worst} ({time.perf_counter() - t0:.1f} s)")
    return worst


def k4_phase(tf, tn, build, docs, chunk_tile, big_tile, big_words):
    """The text front end against its plain version on the card, identical
    rows, by the launcher's rule (its lanes a word the g++ build's) and at
    every lane count through the measurement builds; the documents' rows
    also equal the host front end's, the 1M-word tile's the word
    stream's."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, cases, rule_lanes = 0, 0, set()
    chars, _, _ = tn.coalesce_docs(docs)
    n_host = sum(len(tn.tokenize_py(d)) for d in docs)
    tiles = [("documents", torch.from_numpy(chars).to(DEVICE), K4_BLOCK_WS),
             ("one codepoint", torch.tensor([0x0628], dtype=torch.int32,
                                            device=DEVICE), K4_BLOCK_WS),
             ("index chunk", chunk_tile, (INDEX_BLOCK,)),
             ("1M words", big_tile, (128,))]
    for name, tile, block_ws in tiles:
        for block_w in block_ws:
            geo = tn.segment_geometry(tile, block_w=block_w)
            rows = geo.starts.shape[0]
            want = tf.text_frontend_plain(tile, geo.starts, geo.lens,
                                          block_w=block_w)
            got = tf.text_frontend_cuda(tile, geo.starts, geo.lens,
                                        block_w=block_w)
            rule = tf.text_frontend_cuda.last_lanes
            check(rule == build.host_text_lanes(rows, sms=sms),
                  f"K4 {name}: {rule} lanes a word, the rule's"
                  f" {build.host_text_lanes(rows, sms=sms)}")
            rule_lanes.add(rule)
            outs = [(f"the rule's {rule}", got)]
            outs += [(str(g), forced_k4(g, tile, geo.starts, geo.lens,
                                        block_w)) for g in build.TEXT_LANES]
            torch.cuda.synchronize()
            for lanes, out in outs:
                bad = same((out,), (want,))
                worst = max(worst, max_err((out,), (want,)))
                cases += 1
                check(bad == 0, f"K4 vs plain: {bad} rows differ ({name},"
                      f" block_w={block_w}, {lanes} lanes a word)")
            n = int(geo.n_words)
            if name == "documents":
                want_rows = np.concatenate([tn.analyze_text_py(d)[0]
                                            for d in docs])
                check(n == n_host and np.array_equal(
                    got[:n].cpu().numpy(), want_rows),
                    "K4 rows differ from the host front end")
            if name == "1M words":
                check(n == big_words.shape[0] and torch.equal(
                    got[:n], big_words), "the 1M-word tile's rows differ"
                    " from the word stream's")
            print(f"[K4] {name}: {tile.shape[0]} codepoints, {n} words,"
                  f" {rows} rows, block_w={block_w}: the rule's {rule} lanes"
                  f" a word ({tf.text_frontend_cuda.last_grid} blocks) and"
                  f" G in {build.TEXT_LANES} identical to the plain version")
    check(rule_lanes == set(build.TEXT_LANES),
          f"the rule reached only G in {rule_lanes}")
    print(f"[K4] {cases} launches identical to the plain version (the"
          f" rule reached G in {sorted(rule_lanes)}), max_abs_err {worst}"
          f" ({time.perf_counter() - t0:.1f} s)")
    return worst


def out_of_range(ids, n_roots: int, *, any_int32: bool):
    """ids with every 20th replaced by one outside [0, n_roots]: any int32
    for the counting and sliced instances; for the bitonic one, values
    whose composite keys still fit int32."""
    import torch

    values = [-1, -7, n_roots + 1, n_roots + 9]
    if any_int32:
        values += [-(1 << 31), (1 << 31) - 1]
    bad = ids.clone()
    bad[::20] = torch.tensor(values, dtype=torch.int32, device=ids.device
                             ).repeat(-(-bad[::20].numel() // len(values))
                                      )[:bad[::20].numel()]
    return bad


def slice_edge_ids(pk, ids, n_roots: int, block_w: int):
    """ids of ``ids``'s shape drawn from both sides of every slice edge of
    a sliced ``block_w`` launch over ``n_roots`` roots, and the first and
    last bins (seed 0)."""
    import torch

    bins, n_slices = pk.slices(n_roots, block_w)
    edges = torch.arange(1, n_slices, dtype=torch.int32) * bins
    values = torch.cat([edges - 1, edges,
                        torch.tensor([0, n_roots], dtype=torch.int32)])
    pick = torch.randint(values.numel(), ids.shape,
                         generator=torch.Generator().manual_seed(0))
    return values[pick].to(ids.device)


def k5_phase(pk, real_ids, n_roots, big_ids, n_big):
    """The three postings instances against the plain version on the card,
    each launch's instance read from its counter: the realistic
    vocabulary's ids (counting at block_w <= 8192, bitonic at 65,536) and
    the 262,144-key dictionary's (sliced at block_w 128, the index path's
    2048 and 4096: the drop bucket only, one root, the vocabulary's ids,
    both sides of every slice edge, 1 in 20 outside [0, n_roots]) ->
    (max_abs_err, {instance: launches checked})."""
    import torch

    t0 = time.perf_counter()
    worst, seen = 0, {"counting": 0, "sliced": 0, "bitonic": 0}

    def run(name, ids, n, block_w):
        nonlocal worst
        tiles = pk.pad_ids(ids, n_roots=n, block_w=block_w)
        instance = pk._instance(n, block_w)
        before = dict(pk.postings_cuda.instances)
        got = pk.postings_cuda(tiles, n_roots=n, block_w=block_w)
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in pk.postings_cuda.instances.items()
               if v != before[k]}
        want = pk.postings_plain(tiles, n_roots=n, block_w=block_w)
        bad = same(got, want)
        worst = max(worst, max_err(got, want))
        seen[instance] += 1
        check(bad == 0 and ran == {instance: 1},
              f"K5 vs plain: {bad} differ ({name}, block_w={block_w}), or"
              f" the launch ran {ran}, not the {instance} instance")
        return instance

    for block_w in K5_BLOCK_WS:
        ids = real_ids[:K5_MAX_TILES * block_w]
        cases = (("all dropped", torch.full_like(ids, n_roots)),
                 ("one root", torch.zeros_like(ids)),
                 ("realistic vocabulary", ids))
        for name, case in cases:
            instance = run(name, case, n_roots, block_w)
        oob = out_of_range(ids, n_roots, any_int32=instance != "bitonic")
        run("out of range", oob, n_roots, block_w)
        print(f"[K5] block_w={block_w} ({instance}): {ids.shape[0]} ids x"
              " {all dropped, one root, realistic vocabulary of"
              f" {n_roots}, 1 in 20 outside [0, {n_roots}]}}: hist and"
              " rank identical")
    for block_w in K5_SLICED_BLOCK_WS:
        ids = big_ids[:K5_SLICED_TILES * block_w]
        cases = (("all dropped", torch.full_like(ids, n_big)),
                 ("one root", torch.full_like(ids, n_big // 2)),
                 ("262,144-key vocabulary", ids),
                 ("slice edges", slice_edge_ids(pk, ids, n_big, block_w)),
                 ("out of range", out_of_range(ids, n_big, any_int32=True)))
        for name, case in cases:
            instance = run(name, case, n_big, block_w)
        bins, n_slices = pk.slices(n_big, block_w)
        print(f"[K5] block_w={block_w} ({instance}, {n_slices} slices of"
              f" {bins} bins): {ids.shape[0]} ids x {{all dropped, one root,"
              f" the 262,144-key dictionary's vocabulary of {n_big} roots,"
              " both sides of every slice edge, 1 in 20 outside it}: hist"
              " and rank identical")
    try:
        pk.postings(real_ids, n_roots=1 << 22, block_w=1024)
    except ValueError as e:
        check("overflow" in str(e), f"unexpected guard message: {e}")
        print(f"[K5] overflow guard raises: {e}")
    else:
        check(False, "the int32 overflow guard did not raise")
    check(all(seen.values()), f"K5 instances not all run: {seen}")
    print(f"[K5] {sum(seen.values())} launches ({seen}) identical to the"
          f" plain version, max_abs_err {worst}"
          f" ({time.perf_counter() - t0:.1f} s)")
    return worst, seen


def k6_phase(sdp, ops, words):
    """The standalone datapath against its plain version on the card."""
    import torch

    t0 = time.perf_counter()
    worst, cases = 0, 0
    for b in K6_BATCHES:
        w = words[:b]
        if b == 0:   # the wrapper returns early, no launch
            before = ops.dispatch_count()
            keys, valid = sdp.stem_datapath(w)
            check(keys.shape == valid.shape == (0, sdp.N_OUT)
                  and ops.dispatch_count() == before,
                  "K6 B=0 must return empty outputs, no launch")
            continue
        want = sdp.stem_datapath_plain(w)
        for block_b in K6_BLOCKS:
            got = sdp.stem_datapath_cuda(w, block_b=block_b)
            torch.cuda.synchronize()
            bad = same(got, want)
            worst = max(worst, max_err(got, want))
            cases += 1
            check(bad == 0 and not got[0][:, 30:].any()
                  and not got[1][:, 30:].any(),
                  f"K6 vs plain: {bad} rows differ (B={b}, block_b="
                  f"{block_b}), or a pad column is not zero")
    print(f"[K6] B in {K6_BATCHES} x block_b in {K6_BLOCKS}: {cases}"
          f" launches identical to the plain version, pad columns zero,"
          f" max_abs_err {worst} ({time.perf_counter() - t0:.1f} s)")
    return worst


def padded_keys(sm, keys, table):
    """The stemmer's candidate keys with the keys that hit only padding,
    and one that hits the table, in front."""
    import torch

    edge = torch.tensor([sm.DICT_PAD, sm.KEY_PAD, sm.DICT_SENTINEL,
                         int(table[0])], dtype=torch.int32,
                        device=keys.device)
    return torch.cat([edge, keys])


def one_bank_table(sm, n: int, device):
    """n distinct int32 values whose hashes all fall in bank 0 (at any bank
    count up to 2^16), the comparator bank's adversarial table."""
    import numpy as np
    import torch

    inv = pow(sm.BANK_HASH_MUL, -1, 1 << 32)
    t = np.arange(n, dtype=np.uint64)
    vals = (t * inv % (1 << 32)).astype(np.uint32).view(np.int32)
    return torch.from_numpy(vals).to(device)


def k7_phase(sm, keys, tables):
    """The comparator bank against its plain version on the card, with the
    padding-hit key -2 hitting exactly when the table was padded; each
    table's banks (largest bank, compares a key) printed."""
    import torch

    t0 = time.perf_counter()
    worst, cases = 0, 0
    for name, table in tables:
        k = padded_keys(sm, keys, table)
        for block_n, block_r in K7_BLOCKS:
            got = sm.dict_match_cuda(k, table, block_n=block_n,
                                     block_r=block_r)
            torch.cuda.synchronize()
            want = sm.dict_match_plain(k, table, block_n=block_n,
                                       block_r=block_r)
            bad = same(got, want)
            worst = max(worst, max_err((got.int(),), (want.int(),)))
            cases += 1
            padded = table.shape[0] % (block_r * sm.LANE) != 0
            check(bad == 0 and bool(got[0]) == (padded or bool(
                      (table == sm.DICT_PAD).any()))
                  and bool(got[1]) == bool((table == sm.KEY_PAD).any())
                  and bool(got[3]),
                  f"K7 vs plain: {bad} flags differ ({name},"
                  f" block_n={block_n}, block_r={block_r}), or the padding"
                  " hits differ from the reference's rule")
        st = sm.bank_stats(k, table)
        print(f"[K7] {name} ({table.shape[0]} entries): {k.shape[0]} keys x"
              f" (block_n, block_r) in {K7_BLOCKS}: identical, -2 hits"
              " exactly where the table was padded; at block_r 8:"
              f" {st['entries']} entries kept in {st['chunks']} chunk(s)"
              f" of {st['banks']} banks, largest bank {st['largest']},"
              f" {st['compares'] / k.shape[0]:.6f} compares a key")
    print(f"[K7] {cases} launches identical to the plain version,"
          f" max_abs_err {worst} ({time.perf_counter() - t0:.1f} s)")
    return worst


def k8_phase(sm, build, keys, tables):
    """The sorted search against its plain version on the card, each
    launch's instance from its counter (both reached), with the sentinel
    hitting exactly when the table was padded; keys also at a 4-byte
    offset (the wrapper copies them) and in a count that is not a multiple
    of 4."""
    import torch

    t0 = time.perf_counter()
    worst, cases, reached = 0, 0, set()
    for name, table in tables:
        k = padded_keys(sm, keys, table)
        rp = sm.sorted_padded(table.shape[0])
        inst = build.host_bsearch_instance(rp)
        ragged = k.shape[0] // 4 * 4 - 1
        # edge: the keys start at padded_keys' first (KEY_PAD at 1, the
        # sentinel at 2, an entry at 3)
        for label, kk, edge in (("aligned", k, True),
                                ("at a 4-byte offset", k[1:], False),
                                (f"{ragged} keys", k[:ragged], True)):
            want = sm.dict_match_bsearch_plain(kk, table)
            for block_n in K8_BLOCK_NS:
                before = dict(sm.dict_match_bsearch_cuda.instances)
                got = sm.dict_match_bsearch_cuda(kk, table, block_n=block_n)
                torch.cuda.synchronize()
                took = {i for i, c in sm.dict_match_bsearch_cuda.instances
                        .items() if c != before[i]}
                check(took == {inst}, f"K8 {name}: instance {took}, the"
                      f" rule's {inst}")
                reached |= took
                bad = same(got, want)
                worst = max(worst, max_err((got.int(),), (want.int(),)))
                cases += 1
                check(bad == 0, f"K8 vs plain: {bad} flags differ ({name},"
                      f" keys {label}, block_n={block_n})")
                check(not edge or bool(got[2]) == (rp != table.shape[0])
                      and bool(got[1]) == bool((table == sm.KEY_PAD).any())
                      and bool(got[3]),
                      f"K8 {name}: the sentinel or KEY_PAD hit differs from"
                      f" the reference's rule (keys {label},"
                      f" block_n={block_n})")
        print(f"[K8] {name} ({table.shape[0]} keys, padded {rp}, {inst}"
              f" instance): {k.shape[0]} keys, also at a 4-byte offset and"
              f" {ragged} of them, x block_n in {K8_BLOCK_NS}: identical")
    check(reached == set(sm.BSEARCH_INSTANCES),
          f"K8 reached only the instances {reached}")
    print(f"[K8] {cases} launches identical to the plain version, max_abs_err"
          f" {worst} ({time.perf_counter() - t0:.1f} s)")
    return worst


def launch_counts(ops) -> dict:
    return {w.__name__: w.launches for w in ops.CUDA_WRAPPERS if w.launches}


def example_verified(name: str, res) -> str:
    """What example ``name``'s main checked, from what it returned."""
    if name == "quickstart":
        return (f"{len(res)} words' roots and sources equal to the host"
                " algorithm (pyref.stem_word)")
    if name == "serve_stemmer":
        return (f"{res['words']} words bit-identical to stem_batch under"
                f" the versions that served them {res['versions']};"
                f" {res['retries']} retry in the faulted pass")
    if name == "serve_text":
        return (f"{res['tokens']} tokens of {res['documents']} documents"
                " bit-identical to the host front end -> stem_batch")
    if name == "index_corpus":
        return (f"{res.n_postings} postings over {res.n_roots} roots"
                " bit-identical to the host index, the resumed build too")
    if name == "serve_decode":
        return (f"{len(res)} requests x {len(res[0])} tokens, request 0's"
                " greedy against a plain decode_step loop")
    return f"{len(res)} scenarios: {' '.join(res)}"


def examples_phase(ops, device: str = "cuda:0") -> dict:
    """Phase 13: each example of EXAMPLES loaded from examples/ and run as
    main(["--device", device]), the launch counters set to 0 just before
    it and read just after; a mismatch raises SystemExit out of main and
    ends the script. Checks that the example launched the kernels it must.
    -> {name: (seconds, launches)}."""
    import importlib.util

    import torch

    out = {}
    t_phase = time.perf_counter()
    for name, kernels in EXAMPLES:
        path = Path(__file__).resolve().parent / "examples" / (
            f"torch_{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"torch_example_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        torch.cuda.synchronize()
        ops.reset_dispatch_count()
        t0 = time.perf_counter()
        res = mod.main(["--device", device])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts(ops)
        if torch.device(device).type == "cuda":
            missing = [k for k in kernels if not launches.get(k)]
            check(not missing, f"torch_{name} launched {launches}, none of"
                  f" {missing}")
        print(f"[examples] torch_{name}: {secs:.3f} s wall; checked"
              f" {example_verified(name, res)}", flush=True)
        print(f"[examples] torch_{name} launches: {launches or 'none'}",
              flush=True)
        out[name] = (secs, launches)
    print(f"[examples] phase 13 in {time.perf_counter() - t_phase:.1f} s;"
          f" {card_line()}", flush=True)
    return out


def staged_phase(ops, stemmer, arrays, words, fused, sorted_ext):
    """The staged Compare path over 1M words, three ways, each after a
    warm-up with the launch counters set to 0 just before and read just
    after -> {label: (launches, seconds)}."""
    import torch

    runs = (
        ("stem_batch(backend='pallas')", "K7",
         lambda: stemmer.stem_batch(words, arrays, backend="pallas",
                                    device=DEVICE),
         {"dict_match_cuda": 5}, fused, "the fused path"),
        ("ops.extract_roots_multilaunch", "K6+K7",
         lambda: ops.extract_roots_multilaunch(words, arrays, device=DEVICE),
         {"stem_datapath_cuda": 1, "dict_match_cuda": 5}, fused,
         "the fused path"),
        ("extract_roots(backend='fused', extended=True)", "K8",
         lambda: stemmer.extract_roots(words, arrays, backend="fused",
                                       extended=True, device=DEVICE),
         {"dict_match_bsearch_cuda": 7}, sorted_ext,
         "the plain sorted extended path"),
    )
    out = {}
    for label, kernels, run, want_launches, want, want_name in runs:
        run()                                   # warm-up: allocations
        torch.cuda.synchronize()
        ops.reset_dispatch_count()
        t = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = launch_counts(ops)
        check(launches == want_launches,
              f"{label}: launches {launches}, want {want_launches}")
        bad = same(got, want)
        check(bad == 0, f"{label}: {bad} words differ from {want_name}")
        n = words.shape[0]
        print(f"[staged] {label}: {n} words in {secs:.6f} s ({n / secs:.0f}"
              f" words/s, launches {launches}), equal to {want_name}")
        out[kernels] = (launches, secs)
    return out


def models_phase(ops, stemmer, presets, arrays, words, fused):
    """The paper's three execution models (and pipelined_sorted) from the
    presets, each after a warm-up, checked against the fused path ->
    {name: words/s}."""
    import torch

    def batched(w, cfg):
        outs = [stemmer.stem_batch(w[c0:c0 + cfg.batch], arrays,
                                   infix=cfg.infix, backend=cfg.backend,
                                   device=DEVICE)
                for c0 in range(0, w.shape[0], cfg.batch)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    models = {
        "software": (lambda w, cfg: stemmer.stem_sequential(
            w, arrays, infix=cfg.infix, backend=cfg.backend, device=DEVICE),
            SOFTWARE_WORDS),
        "non_pipelined": (batched, words.shape[0]),
        "pipelined": (lambda w, cfg: stemmer.stem_pipelined(
            w, arrays, infix=cfg.infix, backend=cfg.backend,
            microbatch=cfg.microbatch, device=DEVICE), words.shape[0]),
        "pipelined_sorted": (lambda w, cfg: stemmer.stem_pipelined(
            w, arrays, infix=cfg.infix, backend=cfg.backend,
            microbatch=cfg.microbatch, device=DEVICE), words.shape[0]),
    }
    rates = {}
    for name, (run, n) in models.items():
        cfg = presets[name]
        w = words[:n]
        run(w[:64 if name == "software" else 2 * cfg.microbatch], cfg)
        torch.cuda.synchronize()
        ops.reset_dispatch_count()
        t = time.perf_counter()
        got = run(w, cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = launch_counts(ops)
        bad = same(got, tuple(x[:n] for x in fused))
        check(bad == 0, f"execution model {name}: {bad} words differ from"
              " the fused path")
        if cfg.backend == "pallas":
            want = -(-n // cfg.microbatch) * 5
            check(launches == {"dict_match_cuda": want},
                  f"{name}: launches {launches}, want {want} K7 launches")
        rates[name] = n / secs
        print(f"[models] {name} (backend {cfg.backend!r}, batch {cfg.batch},"
              f" microbatch {cfg.microbatch}): {n} words in {secs:.6f} s,"
              f" {n / secs:.0f} words/s, launches {launches or 'none'}; equal"
              " to the fused path")
    ratio = rates["pipelined"] / rates["software"]
    print(f"[models] pipelined / software: {ratio:.3f}x words/s (reported,"
          " not claimed)")
    return rates


def index_phase(ops, pk, ix, corpus, tn, arrays, table):
    """The corpus index over 1M words, words path then text path, launches
    counted from zero for each; bit-identical to the host build ->
    (launches, K5 launches by instance, words-path s, text-path s, the
    words path's index)."""
    import numpy as np
    import torch

    def stream():
        return corpus.stream_corpus_words(
            INDEX_WORDS, seed=0, chunk_words=INDEX_CHUNK,
            words_per_doc=INDEX_WORDS_PER_DOC, table=table)

    kw = dict(block_b=INDEX_BLOCK, block_w=INDEX_BLOCK, device=DEVICE)
    ix.build_corpus_index(corpus.stream_corpus_words(
        INDEX_CHUNK, seed=1, chunk_words=INDEX_CHUNK, table=table),
        arrays, **kw)                                       # warm-up
    # the corpus is made first (set-up), so both paths time the same work:
    # per chunk the device build, the n_postings sync, the copies back,
    # and the merge
    t = time.perf_counter()
    chunks = list(stream())
    make_s = time.perf_counter() - t
    torch.cuda.synchronize()
    ops.reset_dispatch_count()
    t = time.perf_counter()
    idx = ix.build_corpus_index(iter(chunks), arrays, **kw)
    torch.cuda.synchronize()
    words_s = time.perf_counter() - t
    launches = {w.__name__: w.launches for w in ops.CUDA_WRAPPERS
                if w.launches}
    instances = dict(pk.postings_cuda.instances)
    n_chunks = INDEX_WORDS // INDEX_CHUNK
    check(launches == {"stem_fused_cuda": n_chunks,
                       "postings_cuda": n_chunks}
          and instances == {"counting": n_chunks, "sliced": 0, "bitonic": 0},
          f"index launches {launches} ({instances}), want K1 and K5's"
          " counting instance once a chunk")
    vocab = ix.build_vocab(arrays)
    parts = []
    for ch in chunks:
        ids = ix.host_root_ids(ch.words, arrays, vocab)
        parts.append(ix.IndexPartial(*ix.host_index(
            ids, ch.doc_ids.astype(np.int32), ch.positions, len(vocab))))
    want = ix.merge_partials(parts, vocab)
    for name in ("counts", "offsets", "docs", "positions"):
        check(np.array_equal(getattr(idx, name), getattr(want, name)),
              f"index {name} differ from the host build")
    check(idx.n_postings > INDEX_WORDS // 2, "the corpus must be indexable")
    print(f"[index] {INDEX_WORDS} words in {n_chunks} chunks through"
          f" build_corpus_index in {words_s:.6f} s"
          f" ({INDEX_WORDS / words_s:.0f} words/s, launches {launches},"
          f" K5 instances {instances};"
          f" making the corpus, not timed, {make_s:.6f} s),"
          f" {idx.n_postings} postings over {int((idx.counts > 0).sum())}"
          f" roots, bit-identical to the host build")

    # the same corpus from text, chunk by chunk
    docs_chunks = []
    for doc0, docs in corpus.stream_corpus_docs(
            INDEX_WORDS, seed=0, chunk_words=INDEX_CHUNK,
            words_per_doc=INDEX_WORDS_PER_DOC, table=table):
        chars, _, byte_off = tn.coalesce_docs(docs)
        docs_chunks.append((doc0, chars, byte_off,
                            sum(len(d.encode("utf-8")) for d in docs)))
    text_kw = dict(block_w_text=INDEX_BLOCK, **kw)
    ops.build_root_index_text(docs_chunks[0][1], arrays, vocab,
                              docs_chunks[0][2], doc0=docs_chunks[0][0],
                              **text_kw)                    # warm-up
    torch.cuda.synchronize()
    ops.reset_dispatch_count()
    t = time.perf_counter()
    parts = []
    for doc0, chars, byte_off, _ in docs_chunks:
        counts, docs, poss, n_post = ops.build_root_index_text(
            chars, arrays, vocab, byte_off, doc0=doc0, **text_kw)
        n = int(n_post)
        parts.append(ix.IndexPartial(counts.cpu().numpy().astype(np.int64),
                                     docs[:n].cpu().numpy(),
                                     poss[:n].cpu().numpy()))
    text_idx = ix.merge_partials(parts, vocab)
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t
    text_launches = {w.__name__: w.launches for w in ops.CUDA_WRAPPERS
                     if w.launches}
    check(text_launches == {"text_frontend_cuda": n_chunks,
                            "stem_fused_cuda": n_chunks,
                            "postings_cuda": n_chunks},
          f"text index launches {text_launches}")
    for name in ("counts", "offsets", "docs", "positions"):
        check(np.array_equal(getattr(text_idx, name), getattr(idx, name)),
              f"text-path index {name} differ from the words path")
    n_bytes = sum(c[3] for c in docs_chunks)
    print(f"[index] the same corpus from text ({n_bytes} bytes, block_w_text"
          f" {INDEX_BLOCK}) through build_root_index_text, the syncs, the"
          f" copies back and the merge in {text_s:.6f} s"
          f" ({INDEX_WORDS / text_s:.0f} words/s, {n_bytes / text_s:.0f}"
          f" B/s, launches {text_launches}), equal to the words path")
    return launches, instances, words_s, text_s, idx


def index_grown_phase(ops, pk, sf, ix, corpus, grown, table):
    """The same 1M-word corpus indexed on the 262,144-key dictionary: K2
    streams the dictionary and the vocabulary's 262K roots take K5's
    sliced instance; launches counted from zero; bit-identical to the
    host build -> (K5 launches by instance, seconds)."""
    import numpy as np
    import torch

    kw = dict(block_b=INDEX_BLOCK, block_w=INDEX_BLOCK, device=DEVICE)
    chunks = list(corpus.stream_corpus_words(
        INDEX_WORDS, seed=0, chunk_words=INDEX_CHUNK,
        words_per_doc=INDEX_WORDS_PER_DOC, table=table))
    ix.build_corpus_index(iter(chunks[:1]), grown, **kw)     # warm-up
    torch.cuda.synchronize()
    ops.reset_dispatch_count()
    t = time.perf_counter()
    idx = ix.build_corpus_index(iter(chunks), grown, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = launch_counts(ops)
    instances = dict(pk.postings_cuda.instances)
    n_chunks = len(chunks)
    vocab = ix.build_vocab(grown)
    check(set(launches) == {"stem_streamed_cuda", "postings_cuda"}
          and launches["postings_cuda"] == n_chunks
          and instances == {"counting": 0, "sliced": n_chunks, "bitonic": 0}
          and pk._instance(len(vocab), INDEX_BLOCK) == "sliced",
          f"grown index launches {launches} ({instances}), want K2 and K5's"
          " sliced instance once a chunk")
    parts = []
    for ch in chunks:
        ids = ix.host_root_ids(ch.words, grown, vocab)
        parts.append(ix.IndexPartial(*ix.host_index(
            ids, ch.doc_ids.astype(np.int32), ch.positions, len(vocab))))
    want = ix.merge_partials(parts, vocab)
    for name in ("counts", "offsets", "docs", "positions"):
        check(np.array_equal(getattr(idx, name), getattr(want, name)),
              f"grown index {name} differ from the host build")
    print(f"[index] the same {INDEX_WORDS} words on the 262,144-key"
          f" dictionary ({len(vocab)} roots) through build_corpus_index in"
          f" {secs:.6f} s ({INDEX_WORDS / secs:.0f} words/s, launches"
          f" {launches}, K5 instances {instances}), {idx.n_postings}"
          " postings, bit-identical to the host build")
    return instances, secs


def text_serve_phase(ops, stemmer, tn, arrays, docs, *,
                     persistent: bool):
    """Serve the documents through Engine + TextAnalysisWorkload with the
    kernel front end (after a warm-up), launch counters set to 0 just
    before and read just after; every request equals the host front end
    and the plain stemmer."""
    import numpy as np
    import torch

    from repro_torch.serve import DictStore, Engine, TextAnalysisWorkload

    per = TEXT_DOCS_PER_REQUEST
    payloads = [docs[i * per:(i + 1) * per] for i in range(TEXT_REQUESTS)]

    def serve(batch):
        wl = TextAnalysisWorkload(DictStore(arrays, device=DEVICE),
                                  block_b=BLOCK_B, megabatch_tiles=16,
                                  max_inflight=2, persistent=persistent,
                                  char_block=TEXT_CHAR_BLOCK,
                                  frontend="kernel")
        eng = Engine(wl)
        t = time.perf_counter()
        rids = [eng.submit(p) for p in batch]
        t_admit = time.perf_counter() - t
        rep = eng.run_until_drained(max_ticks=100_000)
        torch.cuda.synchronize()
        return eng, rids, rep, time.perf_counter() - t, t_admit

    serve(payloads[:8])                                     # warm-up
    ops.reset_dispatch_count()
    eng, rids, rep, serve_s, admit_s = serve(payloads)
    launches = {w.__name__: w.launches for w in ops.CUDA_WRAPPERS
                if w.launches}
    reqs = [eng.result(r) for r in rids]
    host = [[tn.analyze_text_py(d) for d in p] for p in payloads]
    host_words = np.concatenate([w for h in host for w, _ in h])
    want_r, want_s = stemmer.extract_roots(host_words, arrays,
                                           backend="sorted", device=DEVICE)
    want_r, want_s = want_r.cpu().numpy(), want_s.cpu().numpy()
    at = 0
    for req, h in zip(reqs, host):
        n = sum(w.shape[0] for w, _ in h)
        check(req is not None and req.done and req.n_words == n,
              "text request not finished or of the wrong length")
        check(np.array_equal(req.words, np.concatenate([w for w, _ in h]))
              and np.array_equal(req.spans,
                                 np.concatenate([s for _, s in h]))
              and np.array_equal(req.doc_ids, np.concatenate(
                  [np.full(w.shape[0], i, np.int32)
                   for i, (w, _) in enumerate(h)]))
              and np.array_equal(req.roots, want_r[at:at + n])
              and np.array_equal(req.sources, want_s[at:at + n]),
              f"served text request {req.rid} differs from the host front"
              " end and the plain stemmer")
        at += n
    n_words = at
    n_bytes = sum(r.n_bytes for r in reqs)
    stem_name = ("persistent_resident_cuda" if persistent
                 else "stem_fused_cuda")
    wl = eng.workload
    check(set(launches) == {"text_frontend_cuda", stem_name}
          and launches["text_frontend_cuda"] == TEXT_REQUESTS
          and launches[stem_name] == wl.ticks_launched > 0,
          f"text serve launches {launches}, engine {wl.ticks_launched}")
    print(f"[text] {'persistent' if persistent else 'resident'}:"
          f" {TEXT_REQUESTS} requests / {len(docs)} documents / {n_bytes}"
          f" bytes / {n_words} words in {serve_s:.6f} s"
          f" ({n_bytes / serve_s:.0f} B/s, {n_words / serve_s:.0f} words/s,"
          f" {rep.ticks} ticks, launches {launches}); admission (the front"
          f" end) {admit_s:.6f} s = {admit_s / serve_s:.6f} of the wall"
          " time; every request equal to the host front end and the plain"
          " stemmer")
    return launches, serve_s, admit_s, n_words, n_bytes


def k9_phase(fa):
    """K9 against its plain version on the card over the reference test's
    grid, its head dims (and 576), llama3-8b's [1, 32, 4096, 128] and
    gemma-2b's head_dim 256 at T = 2048, fp32 and bf16; each case's
    instance read from the per-instance counter, every bf16 case at
    head_dim 64, 128 or 256 on the tensor cores -> the largest
    |K9 - plain| of each instance."""
    import torch

    t0 = time.perf_counter()
    cases = []
    for t, bq, bk in K9_GRID:
        cases += [(f"grid T={t} block_q={bq} block_k={bk}", (2, 3, t, 64),
                   causal, bq, bk) for causal in (True, False)]
    cases += [(f"head_dim {d}", (1, 2, 128, d), True, 128, 128)
              for d in K9_HEAD_DIMS]
    cases += [("llama3-8b prefill", (1, 32, LM_ATTN_T, 128), True, 128, 128),
              ("gemma-2b head_dim 256", GEMMA_ATTN_SHAPE, True, 128, 128)]
    g = torch.Generator(DEVICE).manual_seed(0)
    worst = {"wgmma": 0.0, "fma": 0.0}
    n = 0
    for dtype, tol in K9_TOL.items():
        for label, shape, causal, bq, bk in cases:
            q, k, v = ((torch.randn(shape, generator=g, device=DEVICE) * 0.5)
                       .to(getattr(torch, dtype)) for _ in range(3))
            before = dict(fa.flash_attention_cuda.instances)
            got = fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                     block_k=bk, device=DEVICE)
            torch.cuda.synchronize()
            ran = [name for name, c in fa.flash_attention_cuda.instances.items()
                   if c != before[name]]
            want_inst = ("wgmma" if dtype == "bfloat16"
                         and shape[3] in (64, 128, 256) else "fma")
            check(ran == [want_inst], f"K9 {label} {dtype}: instance {ran},"
                  f" want {want_inst}")
            want = fa.flash_attention_plain(q, k, v, causal=causal).float()
            err = (got.float() - want).abs()
            check(bool((err <= tol + tol * want.abs()).all()),
                  f"K9 {label} {dtype} causal={causal}: max error"
                  f" {float(err.max())} beyond rtol = atol = {tol}")
            worst[want_inst] = max(worst[want_inst], float(err.max()))
            n += 1
            print(f"[K9] {label} {list(shape)} {dtype} causal={causal}:"
                  f" instance {want_inst}, max |K9 - plain|"
                  f" {float(err.max()):.3e} (rtol = atol = {tol})")
    print(f"[K9] {n} cases (the grid, head dims {K9_HEAD_DIMS}, both"
          f" dtypes) within rtol = atol = 1e-5 (fp32) and 2e-2 (bf16) of"
          f" the plain version, every bf16 case at head_dim 64/128/256 on"
          f" the wgmma instance; largest |K9 - plain| {worst['wgmma']:.3e}"
          f" (wgmma), {worst['fma']:.3e} (fma), in"
          f" {time.perf_counter() - t0:.1f} s")
    return worst


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------
def serve_phase(label, ops, sf, arrays, serve_words, want, *,
                persistent: bool, store_kw=None, journal_dir=None):
    """Serve every word through Engine + StemmerWorkload (after an 8-request
    warm-up), with the launch counters set to 0 just before and read just
    after; check every request and the accounting (a persistent serve's
    flags read from the slots' host-mapped memory) -> (launches, seconds).
    With ``journal_dir`` the engine journals every admit and retire there
    (the write-ahead journal of ``--journal``)."""
    import numpy as np
    import torch

    from repro_torch.serve import DictStore, Engine, Journal, StemmerWorkload

    n_req = SERVE_WORDS // SERVE_REQUEST_WORDS

    def serve(n_requests: int):
        store = DictStore(arrays, device=arrays.device, **(store_kw or {}))
        wl = StemmerWorkload(store, block_b=BLOCK_B, megabatch_tiles=16,
                             max_inflight=2, persistent=persistent)
        journal = None
        if journal_dir is not None:
            path = Path(journal_dir) / f"wal-{time.perf_counter_ns()}.jsonl"
            journal = Journal(path)
        eng = Engine(wl, journal=journal)
        t = time.perf_counter()
        rids = [eng.submit(serve_words[i * SERVE_REQUEST_WORDS:
                                       (i + 1) * SERVE_REQUEST_WORDS])
                for i in range(n_requests)]
        rep = eng.run_until_drained(max_ticks=100_000)
        torch.cuda.synchronize()
        return eng, rids, rep, time.perf_counter() - t

    serve(8)                                  # warm-up: buffers, first load
    ops.reset_dispatch_count()
    eng, rids, rep, serve_s = serve(n_req)
    launches = {w.__name__: w.launches for w in sf.CUDA_WRAPPERS}
    total = ops.dispatch_count()
    wl = eng.workload
    handle = wl.store.acquire().handle
    n_launch = -(-SERVE_WORDS // wl.launch_b)     # full megabatches
    planned = n_launch * sf.planned_launches(
        wl.launch_b, handle, block_b=BLOCK_B, persistent=persistent)
    want_r, want_s = want
    for i, rid in enumerate(rids):
        req = eng.result(rid)
        sl = slice(i * SERVE_REQUEST_WORDS, (i + 1) * SERVE_REQUEST_WORDS)
        check(req is not None and req.done, f"request {rid} not finished")
        check(np.array_equal(req.roots, want_r[sl])
              and np.array_equal(req.sources, want_s[sl])
              and (req.dict_versions == 0).all(),
              f"{label}: served request {rid} differs from the plain stemmer")
    tiles = SERVE_WORDS // wl.block_b
    check(wl.checksum_tiles == tiles,
          f"{wl.checksum_tiles} tiles checksum-verified, want {tiles}")
    check(wl.flag_tiles == (tiles if persistent else 0),
          f"{wl.flag_tiles} tiles flag-verified")
    mapped = [f for f in wl._flags if f is not None]
    check(all(isinstance(f, sf.MappedFlags) for f in mapped)
          and bool(mapped) == persistent,
          f"{label}: the flags must come from host-mapped memory")
    if journal_dir is not None:
        eng.journal.close()
        records, _ = type(eng.journal).read(eng.journal.path)
        check(len(records) == 2 * n_req,
              f"{label}: {len(records)} journal records, want {2 * n_req}")
    check(total == planned == wl.ticks_launched,
          f"{label}: kernel launches {total}, planned {planned}, engine"
          f" {wl.ticks_launched}")
    check(total > 0, f"{label}: the serve run launched no kernel")
    ran = {n: c for n, c in launches.items() if c}
    print(f"[serve] {label}: {n_req} requests / {SERVE_WORDS} words in"
          f" {serve_s:.6f} s ({SERVE_WORDS / serve_s:.0f} words/s,"
          f" {rep.ticks} ticks, launches {ran} = planned {planned}, {tiles}"
          f" tiles checksum-verified, {wl.flag_tiles} flag-verified,"
          f" residency {handle.residency})")
    return ran, serve_s


def fault_serve_phase(ops, sf, arrays, serve_words, want) -> dict:
    """Phase 6b, the faulted persistent serve: the 1M words in 256
    requests through Engine + StemmerWorkload (block_b 256, 16 tiles a
    launch, 2 in flight, persistent, watchdog) under a FaultPlan of two
    dispatch failures, one retire corruption, one wedge after 5 retired
    descriptors and one poison request, the launch counters set to 0 just
    before and read just after. Every other request equals the plain
    stemmer, the poison one is quarantined, and the counters, the fired
    log and the events are exactly those the plan implies -> launches."""
    import numpy as np

    from repro_torch.serve import (DictStore, Engine, FaultInjector,
                                   FaultPlan, FaultSpec, StemmerWorkload)

    n_req = SERVE_WORDS // SERVE_REQUEST_WORDS
    plan = FaultPlan(specs=tuple(
        [FaultSpec("dispatch", at=a) for a in FAULT_DISPATCH_AT]
        + [FaultSpec("retire", at=FAULT_RETIRE_AT),
           FaultSpec("stall", at=FAULT_STALL_AT,
                     retired_tiles=FAULT_RETIRED_TILES)]),
        poison_rids=frozenset({FAULT_POISON_RID}))
    inj = FaultInjector(plan)
    wl = StemmerWorkload(DictStore(arrays, device=arrays.device),
                         block_b=BLOCK_B, megabatch_tiles=16, max_inflight=2,
                         persistent=True, watchdog_s=FAULT_WATCHDOG_S,
                         injector=inj)
    eng = Engine(wl)
    ops.reset_dispatch_count()
    t = time.perf_counter()
    rids = [eng.submit(serve_words[i * SERVE_REQUEST_WORDS:
                                   (i + 1) * SERVE_REQUEST_WORDS])
            for i in range(n_req)]
    rep = eng.run_until_drained(max_ticks=100_000)
    wall = time.perf_counter() - t
    launches = {w.__name__: w.launches for w in sf.CUDA_WRAPPERS}
    want_r, want_s = want
    for i, rid in enumerate(rids):
        req = eng.result(rid)
        sl = slice(i * SERVE_REQUEST_WORDS, (i + 1) * SERVE_REQUEST_WORDS)
        if rid == FAULT_POISON_RID:
            check(req.failure is not None
                  and req.failure.code == "quarantined"
                  and req.failure.retries == wl.max_retries + 1,
                  f"the poison request ended as {req.failure}")
            continue
        check(req.failure is None and np.array_equal(req.roots, want_r[sl])
              and np.array_equal(req.sources, want_s[sl]),
              f"faulted serve: request {rid} differs from the plain stemmer"
              f" ({req.failure})")
    # what the plan implies: each dispatch failure and the corrupted
    # retire one retry; the poison request max_retries + 1 retries and a
    # quarantine (a launch holds one request: no bisection); one stall
    # whose 5 retired descriptors are salvaged and whose other 11 go out
    # again through one K1 launch; the corrupted launch goes out again
    # through K3
    poison_tries = wl.max_retries + 1
    want_counts = {"retries_total": len(FAULT_DISPATCH_AT) + 1 + poison_tries,
                   "bisections": 0, "quarantined": 1, "timeouts": 0,
                   "checksum_failures": 1, "watchdog_stalls": 1,
                   "device_losses": 0, "ticks_launched": n_req + 1}
    got_counts = {k: getattr(wl, k) for k in want_counts}
    check(got_counts == want_counts,
          f"faulted serve counters {got_counts}, the plan implies"
          f" {want_counts}")
    fired = sorted((site, kind) for site, kind, _ in inj.fired)
    want_fired = sorted([("dispatch", "fail")] * len(FAULT_DISPATCH_AT)
                        + [("dispatch", "poison")] * poison_tries
                        + [("retire", "corrupt"), ("stall", "wedge")])
    check(fired == want_fired, f"fired {inj.fired}")
    kinds: dict = {}
    for ev in eng.events():
        kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
    want_kinds = {"retry": want_counts["retries_total"],
                  "checksum_failure": 1, "watchdog_stall": 1, "failure": 1}
    check(kinds == want_kinds, f"events {kinds}, want {want_kinds}")
    (stall,) = [e for e in eng.events() if e.kind == "watchdog_stall"]
    check(stall.data["salvaged_words"] == FAULT_RETIRED_TILES * BLOCK_B
          and stall.data["redispatched_words"]
          == SERVE_REQUEST_WORDS - FAULT_RETIRED_TILES * BLOCK_B,
          f"watchdog stall {stall.data}")
    check(launches["persistent_resident_cuda"] == n_req
          and launches["stem_fused_cuda"] == 1
          and ops.dispatch_count() == n_req + 1,
          f"faulted serve launches {launch_counts(ops)}")
    ran = {n: c for n, c in launches.items() if c}
    print(f"[faults] {n_req} requests / {SERVE_WORDS} words, persistent,"
          f" under {len(plan.specs)} faults and poison request"
          f" {FAULT_POISON_RID}: {wall:.6f} s"
          f" ({(SERVE_WORDS - SERVE_REQUEST_WORDS) / wall:.0f} served"
          f" words/s), {rep.ticks} ticks, launches {ran}; counters"
          f" {got_counts}; events {kinds}; watchdog salvaged"
          f" {stall.data['salvaged_words']} words and re-dispatched"
          f" {stall.data['redispatched_words']}; {wl.flag_tiles} tiles"
          f" flag-verified (host-mapped), {wl.checksum_tiles}"
          " checksum-verified; every other request equal to the plain"
          " stemmer, the poison one quarantined")
    return ran


def ladder_phase(ops, sf, arrays, serve_words, want) -> dict:
    """Phase 6b, the degradation ladder: LADDER_REQUESTS requests through
    an engine with a DegradationPolicy driven by queue pressure (one
    request admitted at a time): it walks persistent -> megabatch x16 ->
    per-tile -> streamed-dict and back up, every rung applied in turn,
    every request equal to the plain stemmer, and the launch counters,
    from 0, show K3 resident, K1 and K2 ran -> launches."""
    import numpy as np

    from repro_torch.serve import (DegradationPolicy, DictStore, Engine,
                                   StemmerWorkload)

    wl = StemmerWorkload(DictStore(arrays, device=arrays.device),
                         block_b=BLOCK_B, megabatch_tiles=16, max_inflight=2,
                         persistent=True, max_requests=1)
    pol = DegradationPolicy(queue_high=LADDER_QUEUE_HIGH,
                            down_after=LADDER_DOWN_AFTER,
                            up_after=LADDER_UP_AFTER)
    eng = Engine(wl, policy=pol)
    labels = [r.label for r in pol.rungs]
    check(labels == ["persistent", "megabatch x16", "per-tile",
                     "streamed-dict"], f"ladder {labels}")

    def rung() -> str:
        if wl.residency_override == "streamed":
            return "streamed-dict"
        if wl.persistent:
            return "persistent"
        return "megabatch x16" if wl.megabatch_tiles > 1 else "per-tile"

    ops.reset_dispatch_count()
    n = LADDER_REQUESTS * LADDER_REQUEST_WORDS
    rids = [eng.submit(serve_words[i * LADDER_REQUEST_WORDS:
                                   (i + 1) * LADDER_REQUEST_WORDS])
            for i in range(LADDER_REQUESTS)]
    walk, served = [], {}
    steps = 0
    while (eng.queue or wl.active) and steps < 100_000:
        before = wl.ticks_launched
        eng.step()
        steps += 1
        now = rung()
        if not walk or walk[-1] != now:
            walk.append(now)
        served[now] = served.get(now, 0) + wl.ticks_launched - before
    launches = {w.__name__: w.launches for w in sf.CUDA_WRAPPERS}
    check(not eng.queue and not wl.active, "the ladder serve did not drain")
    want_walk = labels + labels[-2::-1]
    check(walk == want_walk, f"ladder walk {walk}, want {want_walk}")
    want_r, want_s = want
    for i, rid in enumerate(rids):
        req = eng.result(rid)
        sl = slice(i * LADDER_REQUEST_WORDS, (i + 1) * LADDER_REQUEST_WORDS)
        check(req.failure is None and np.array_equal(req.roots, want_r[sl])
              and np.array_equal(req.sources, want_s[sl]),
              f"ladder: request {rid} differs from the plain stemmer")
    check(all(served.get(r, 0) > 0 for r in labels),
          f"launches by rung {served}")
    check(launches["persistent_resident_cuda"] > 0
          and launches["stem_fused_cuda"] > 0
          and launches["stem_streamed_cuda"] > 0,
          f"ladder launches {launch_counts(ops)}")
    ran = {k: c for k, c in launches.items() if c}
    print(f"[faults] ladder: {LADDER_REQUESTS} requests / {n} words in"
          f" {steps} steps walked {' -> '.join(walk)}"
          f" ({[t[2] for t in pol.transitions]}), launches by rung"
          f" {served}, kernel launches {ran}; every request equal to the"
          " plain stemmer")
    return ran


def restart_phase(sf, arrays, serve_words, want, workdir) -> None:
    """Phase 6b, kill and restart: a journaled persistent serve of the 1M
    words, its DictStore snapshotted, is dropped after KILL_STEPS engine
    steps (launches still in flight, no close), its journal given a torn
    tail; Engine.recover over DictStore.restore re-serves exactly the
    unfinished requests, and the outputs of both engines together equal
    the plain stemmer's."""
    import numpy as np

    from repro_torch.serve import DictStore, Engine, Journal, StemmerWorkload

    n_req = SERVE_WORDS // SERVE_REQUEST_WORDS
    jp, sp = Path(workdir) / "restart.jsonl", Path(workdir) / "dict.npz"
    store = DictStore(arrays, device=arrays.device, keep_history=True)
    store.snapshot(sp)
    kw = dict(block_b=BLOCK_B, megabatch_tiles=16, max_inflight=2,
              persistent=True)
    eng = Engine(StemmerWorkload(store, **kw), journal=Journal(jp))
    rids = [eng.submit(serve_words[i * SERVE_REQUEST_WORDS:
                                   (i + 1) * SERVE_REQUEST_WORDS])
            for i in range(n_req)]
    for _ in range(KILL_STEPS):
        eng.step()
    done_before = {r: eng.result(r) for r in rids
                   if eng.result(r) is not None}
    in_flight = len(eng.workload.ring)
    eng.journal._f.flush()               # what a killed process left
    with open(jp, "ab") as f:            # and half a record after it
        f.write(b"0123456789abcdef {\"kind\":\"ret")
    del eng
    t = time.perf_counter()
    eng2 = Engine.recover(jp, StemmerWorkload(
        DictStore.restore(sp, device=arrays.device), **kw))
    check(eng2.run_until_drained(max_ticks=100_000).drained,
          "the recovered engine did not drain")
    recover_s = time.perf_counter() - t
    rec = eng2.recovery
    check(0 < len(done_before) < n_req and rec.dropped_bytes > 0
          and sorted(rec.replayed) == [r for r in rids
                                       if r not in done_before]
          and rec.already_retired == len(done_before),
          f"recovery {rec.already_retired} retired, {len(rec.replayed)}"
          f" replayed, {rec.dropped_bytes} B dropped; {len(done_before)}"
          " finished before the drop")
    want_r, want_s = want
    for i, rid in enumerate(rids):
        req = done_before.get(rid) or eng2.result(rid)
        sl = slice(i * SERVE_REQUEST_WORDS, (i + 1) * SERVE_REQUEST_WORDS)
        check(req.failure is None and np.array_equal(req.roots, want_r[sl])
              and np.array_equal(req.sources, want_s[sl])
              and (req.dict_versions == 0).all(),
              f"restart: request {rid} differs from the plain stemmer")
    print(f"[faults] kill and restart: dropped after {KILL_STEPS} steps"
          f" with {len(done_before)} requests finished and {in_flight}"
          f" launches in flight; recovered {len(rec.replayed)} requests"
          f" ({rec.dropped_bytes} B of torn tail dropped) in"
          f" {recover_s:.6f} s; both engines' outputs equal the plain"
          " stemmer")


def mapped_flags_phase(sf, arrays, serve_words) -> None:
    """Phase 6b, mapped flags: one 1M-word K3 resident launch writing its
    flags into host-mapped memory, queued behind a ~1 ms spin so the host
    is polling when it starts, polled until the launch's event completes:
    the retired count never falls, and the final flags, read from that
    memory with no copy, equal the plain version's."""
    import numpy as np
    import torch

    dev = arrays.device
    w = torch.from_numpy(serve_words).to(dev)
    bt = SERVE_WORDS // BLOCK_B
    tables = sf.padded_tables(arrays, match="bsearch", infix=True)
    desc = sf._descriptors(bt, BLOCK_B, torch.zeros(bt, dtype=torch.int32,
                                                    device=dev), 0)
    kern = dict(n_groups=5, match="bsearch", block_b=BLOCK_B)
    want = sf.persistent_resident_plain(w, tables, desc, **kern)[2].cpu()
    flags = sf.MappedFlags(bt, dev)
    host = flags.host.numpy()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)          # ~1 ms: the host polls from 0
    got = sf.persistent_resident_cuda(w, tables, desc, flags_out=flags,
                                      **kern)[2]
    done = torch.cuda.Event()
    done.record()
    polls = partial = last = 0
    while not done.query():
        n = int(np.count_nonzero(host == 1))
        check(n >= last, f"the retired count fell from {last} to {n}")
        polls += 1
        partial += 0 < n < bt
        last = n
    n = int(np.count_nonzero(host == 1))
    check(n >= last and got.data_ptr() == flags.host.data_ptr()
          and torch.equal(flags.host, want),
          "the mapped flags differ from the plain version's")
    print(f"[faults] mapped flags: one {SERVE_WORDS}-word K3 resident"
          f" launch, {bt} flags in host-mapped memory, {polls} polls before"
          f" its event completed, {partial} saw a partial count (reported"
          " only), the count never fell, the final flags equal the plain"
          " version's with no device-to-host copy")


def lm_attention_phase(ops, fa, ta, tl, tm, cfg, params):
    """K9 through its entry point on the full-width LM's own tensors: layer
    0's q, k, v after rope from 4096 random tokens, K/V expanded to every
    query head (head h reads KV head h // n_rep: repeat_interleave) and
    moved to [B, H, T, D], held against the port's _attend_chunked (chunk
    512) on the same tensors. Launch counters are set to 0 just before
    the two K9 calls (bf16, and fp32 on the same values) and read just
    after -> (launches of each K9 instance, [B, H, T, D] bf16 q, k, v for
    the timings)."""
    import torch

    g = torch.Generator(DEVICE).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, LM_ATTN_T), generator=g,
                         device=DEVICE)
    dt = tm.compute_dtype(cfg)
    lp = tm._layer(params["blocks"], 0)
    hn = tl.rmsnorm(lp["norm1"], tm.embed_tokens(params, cfg, toks, dt),
                    cfg.rms_eps)
    q, k, v = ta._qkv(lp["attn"], hn, cfg, dt)
    q, k = ta._rope_qk(q, k, torch.arange(LM_ATTN_T, device=DEVICE), cfg)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    chunk = 512

    def heads(x):   # [B, T, H, D] <-> [B, H, T, D]
        return x.transpose(1, 2).contiguous()

    qh, kh, vh = (heads(x) for x in (q, k.repeat_interleave(n_rep, dim=2),
                                     v.repeat_interleave(n_rep, dim=2)))
    lm = {"bfloat16": ta._attend_chunked(q, k, v, cfg, n_rep, chunk),
          "float32": ta._attend_chunked(q.float(), k.float(), v.float(), cfg,
                                        n_rep, chunk)}
    torch.cuda.synchronize()
    ops.reset_dispatch_count()
    k9 = {"bfloat16": heads(fa.flash_attention(qh, kh, vh, device=DEVICE)),
          "float32": heads(fa.flash_attention(qh.float(), kh.float(),
                                              vh.float(), device=DEVICE))}
    torch.cuda.synchronize()
    launches = launch_counts(ops)
    instances = dict(fa.flash_attention_cuda.instances)
    check(launches == {"flash_attention_cuda": 2},
          f"K9 on the LM's attention: launches {launches}, want 2 of K9")
    check(instances == {"wgmma": 1, "fma": 1},
          f"K9 on the LM's attention: instances {instances}, want the"
          " bf16 call on wgmma and the fp32 one on fma")
    ref = lm["float32"]
    scale = float(ref.abs().max())

    def rel(a, b):
        d = (a.float() - b.float())
        return float(d.abs().max()) / scale, float(d.norm() / b.float().norm())

    # the fp32 attention of the LM is the reference value; K9 in bf16
    # computes its scores and statistics in fp32 from the same bf16 values,
    # rounds P to bf16 for P V and its output once
    for dtype, tol in LM_ATTN_TOL.items():
        err, norm = rel(k9[dtype], ref)
        check(err <= tol, f"K9 ({dtype}) differs from the LM's fp32"
              f" attention by {err} of its scale (tolerance {tol})")
        print(f"[lm-attn] K9 {dtype} vs the LM's _attend_chunked at fp32:"
              f" max error {err:.3e} of the largest |output| {scale:.3f}"
              f" (tolerance {tol}), norm {norm:.3e}")
    # head 0's scores over the first 256 positions: their spread is why
    # bf16-rounded scores move the nearly one-hot softmax
    s0 = torch.einsum("th,sh->ts", q[0, :256, 0].float(),
                      k[0, :256, 0].float()) * cfg.head_dim ** -0.5
    for label, (a, b) in (("the LM's own bf16 attention vs its fp32",
                           (lm["bfloat16"], ref)),
                          ("K9 bf16 vs the LM's bf16 attention",
                           (k9["bfloat16"], lm["bfloat16"]))):
        err, norm = rel(a, b)
        print(f"[lm-attn] {label}: max error {err:.3e} of the scale, norm"
              f" {norm:.3e} (reported, not checked: the LM rounds its"
              " scores to bf16 before the softmax; their std here is"
              f" {float(s0.std()):.1f}, a bf16 step at that size is"
              " 1-2, so near-ties in the nearly one-hot softmax move)")
    err, norm = rel(k9["bfloat16"], k9["float32"])
    print(f"[lm-attn] K9 bf16 (wgmma, P rounded to bf16) vs K9 fp32 (fma):"
          f" max error {err:.3e} of the scale, norm {norm:.3e} (reported,"
          f" not checked); launches {launches}, instances {instances}")
    return instances, (qh, kh, vh)


def profile_kernels(tag: str, label: str, fn, calls: int) -> dict:
    """Device time of `calls` calls of fn by kernel (torch.profiler),
    beside the wall time of the same calls -> {"busy_ms", "kernels",
    "wall_ms"} a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / calls
    by_name: dict = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            key = ev.name[:60]
            by_name[key] = (by_name.get(key, 0.0)
                            + ev.time_range.elapsed_us() / 1e3)
            n_kernels += 1
    busy = sum(by_name.values()) / calls
    out = dict(busy_ms=busy, kernels=n_kernels // calls, wall_ms=wall)
    if not busy:
        print(f"[{tag}] profiler: no device time in the trace (not"
              " measured)")
        return out
    print(f"[{tag}] profile of {calls} {label}: {busy:.3f} ms of kernels a"
          f" call ({n_kernels // calls} kernels a call) in {wall:.3f} ms of"
          f" wall (with the profiler on; device busy {busy / wall:.4f})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   {ms / calls:9.3f} ms a call"
              f" ({ms / calls / busy:.4f} of kernel time)  {name}")
    by_kind: dict = {}
    for name, ms in by_name.items():
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + ms
    out["by_kind"] = {k: v / calls for k, v in by_kind.items()}
    print(f"[{tag}] kernel time by kind, a call: " + ", ".join(
        f"{k} {v / calls:.3f} ms ({v / calls / busy:.4f})" for k, v in
        sorted(by_kind.items(), key=lambda kv: -kv[1])))
    return out


def cut_layers(pm, cfg, params, n: int):
    """cfg and its parameters cut to the first n layers: the leading dense
    layers first (``first_dense``), then the first of ``blocks`` -> (cfg,
    params), the weights views of the full ones."""
    import dataclasses

    dense = min(n, cfg.first_dense)
    cut = dict(params, blocks=pm.tree_map(lambda x: x[:n - dense],
                                          params["blocks"]))
    if cfg.first_dense:
        cut["dense_blocks"] = pm.tree_map(lambda x: x[:dense],
                                          params["dense_blocks"])
    return dataclasses.replace(cfg, n_layers=n, first_dense=dense), cut


def no_drops(cfg, n_tokens: int, label: str) -> str:
    """For an MoE config: check that a batch of n_tokens tokens can drop
    no assignment (an expert takes at most one assignment a token, so a
    capacity >= n_tokens keeps them all) -> the line that says so."""
    from repro_torch.models import moe

    if not cfg.is_moe:
        return ""
    cap = moe._capacity(n_tokens, cfg)
    check(cap >= n_tokens, f"{label}: capacity {cap} < {n_tokens} tokens,"
          " so prefill may drop assignments that decode keeps")
    return (f"{label}: {n_tokens} tokens, capacity {cap}: 0 assignments"
            " can be dropped")


def arch_note(cfg) -> str:
    """What a config adds to a layer count, width and vocabulary."""
    if cfg.is_moe:
        return (f", {cfg.n_experts} experts top-{cfg.top_k}"
                f" ({cfg.n_shared_experts} shared), first_dense"
                f" {cfg.first_dense}, attn {cfg.attn_impl}")
    note = ""
    if cfg.block in ("mamba", "hymba"):
        note += (f", Mamba d_inner {cfg.d_inner}, N {cfg.ssm_state}, dt_rank"
                 f" {cfg.dt_rank_}, d_conv {cfg.d_conv}, ssm_chunk"
                 f" {cfg.ssm_chunk}")
    if cfg.block == "hymba":
        note += (f", attention in parallel ({cfg.n_heads} heads x"
                 f" {cfg.head_dim}, {cfg.n_kv_heads} KV, window"
                 f" {cfg.sliding_window})")
    if cfg.n_cross_layers:
        note += (f", {cfg.n_cross_layers} cross layers, one before each"
                 f" {cfg.group_self} self layers, vision_seq {cfg.vision_seq}")
    if cfg.n_codebooks:
        note += (f", {cfg.n_codebooks} codebooks (embeddings summed, one"
                 f" head each), ffn {cfg.ffn}")
    return note


def first_state(caches, n: int):
    """The first layer stack's first cache leaf per layer, row 0: an
    attention cache's keys over the first n positions [L, n, KV, hd],
    MLA's latents, or (Mamba) the recurrent state [L, d_inner, N]."""
    c = caches["blocks"]
    if c.kv == ():
        return c.ssm.ssm[:, 0].float()
    return c.kv[0][:, 0, :n].float()


def lm_serve_phase(ops, serve, tm, pm, cfg, params, *, tag="lm-serve",
                   requests=LM_REQUESTS, check_prefill=True) -> dict:
    """Serving at full width: Engine + LMDecodeWorkload serve ``requests``
    requests of LM_SERVE_PROMPT + LM_NEW tokens through prefill-by-decode on
    LM_SLOTS slots, the launch counters set to 0 just before and read just
    after (the model reaches no kernel, as the reference's reaches no
    pallas_call). Checks every request's token count and every step's
    logits finite; then holds the prefill forward's last logits against
    prefill-by-decode for request 0 on the same weights cut to
    LM_CHECK_LAYERS layers, in bf16 and fp32 (fp32 caches), and reports
    the same at all layers. For an MoE model both paths must be free of
    capacity drops (no_drops), so that they route alike. Without
    ``check_prefill`` (the VLM served text-only, whose prefill needs the
    vision embeddings: vlm_phase checks it; the audio family, whose
    prefill audio_prefill_phase checks on [T, K] prompts) only the serve
    runs."""
    import dataclasses

    import numpy as np
    import torch

    def recording(wl, log):
        decode = wl._decode

        def step(p, tok, caches, pos):
            t = time.perf_counter()
            logits, new = decode(p, tok, caches, pos)
            torch.cuda.synchronize()
            log.append((time.perf_counter() - t, torch.isfinite(
                logits).all(), logits[0, -1].float()))
            return logits, new
        wl._decode = step

    wl = serve.LMDecodeWorkload(cfg, params, max_batch=LM_SLOTS,
                                cache_len=LM_CACHE, device=DEVICE)
    # device time of two decode steps by kernel (also the warm-up); the
    # audio family's tokens [B, 1, K]
    k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    tok = torch.zeros((LM_SLOTS, 1, *k), dtype=torch.int32, device=DEVICE)
    prof = profile_kernels(tag, f"decode steps (B={LM_SLOTS})",
                           lambda i: tm.decode_step(wl.params, cfg, tok,
                                                    wl.caches, i), 2)
    log: list = []
    recording(wl, log)
    eng = serve.Engine(wl)
    rng = np.random.default_rng(0)
    check_ids = rng.integers(0, cfg.vocab, LM_PROMPT)
    prompts = [rng.integers(0, cfg.vocab, LM_SERVE_PROMPT)
               for _ in range(requests)]
    torch.cuda.synchronize()
    ops.reset_dispatch_count()
    t = time.perf_counter()
    rids = [eng.submit(pr, max_new=LM_NEW) for pr in prompts]
    rep = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts(ops)
    check(not launches, f"the LM path launched {launches}; its model calls"
          " no kernel")
    outs = [eng.result(r).tokens_out for r in rids]
    check([len(o) for o in outs] == [LM_NEW] * requests,
          f"token counts {[len(o) for o in outs]}, want {LM_NEW} each")
    steps = requests * (LM_SERVE_PROMPT + LM_NEW - 1)
    check(len(log) == steps, f"{len(log)} decode steps, want {steps}")
    check(bool(torch.stack([f for _, f, _ in log]).all()),
          "non-finite logits in a decode step")
    decode_s = sum(s for s, _, _ in log)
    tokens = sum(len(o) for o in outs)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {cfg.name} at full width ({cfg.n_layers} layers, d"
          f" {cfg.d_model}, vocab {cfg.vocab}{arch_note(cfg)}, bf16 compute"
          " on fp32"
          f" weights): {requests} requests of {LM_SERVE_PROMPT} prompt tokens"
          f" and {LM_NEW} new on {LM_SLOTS} slots (cache_len {LM_CACHE}),"
          f" {tokens} tokens in {wall:.6f} s ({tokens / wall:.6f} tokens/s,"
          f" {steps} decode steps, {decode_s / steps * 1e3:.6f} ms a step,"
          f" decode_step {decode_s / wall:.6f} of the wall, {rep.ticks}"
          f" ticks, kernel launches 0); every request returned"
          f" {LM_NEW} tokens, every logit finite; {prof['kernels']} PyTorch"
          f" kernels a step, {prof['busy_ms']:.3f} ms of them: the device"
          f" busy {prof['busy_ms'] / (decode_s / steps * 1e3):.4f} of a"
          f" served step; peak memory {peak / 1e9:.6f} GB"
          " (max_memory_allocated)")
    print(f"[{tag}] request 0: {outs[0]}")
    for line in (no_drops(cfg, LM_PROMPT, "prefill of one prompt"),
                 no_drops(cfg, LM_SLOTS, "a decode step of every slot")):
        if line:
            print(f"[{tag}] {line}")

    prompt = torch.from_numpy(check_ids[None]).to(DEVICE)

    def prefill_vs_decode(cfg_, params_):
        """-> (max error / scale, norm, argmax equal where the top-2 gap
        is clear of tol, the prefill caches' and the decode caches' first
        leaf of "blocks": attention's k, MLA's latent)."""
        fp32 = cfg_.compute_dtype == "float32"
        pre = tm.forward(params_, cfg_, prompt, mode="prefill")
        wl_ = serve.LMDecodeWorkload(cfg_, params_, max_batch=LM_SLOTS,
                                     cache_len=LM_CACHE, device=DEVICE)
        if fp32:
            wl_.caches = tm.init_caches(cfg_, LM_SLOTS, LM_CACHE,
                                        dt=torch.float32, device=DEVICE)
        log_: list = []
        recording(wl_, log_)
        wl_.admit(wl_.make_request(0, check_ids, max_new=1))
        by_decode = log_[-1][2]
        k_dec = first_state(wl_.caches, LM_PROMPT)
        a, b = pre.logits[0, -1].float(), by_decode
        scale = float(a.abs().max())
        err = float((a - b).abs().max()) / scale
        norm = float((a - b).norm() / a.norm())
        top2 = a.topk(2).values
        tol = LM_PREFILL_TOL[cfg_.compute_dtype]
        clear = float(top2[0] - top2[1]) > tol * scale
        same_top = not clear or int(a.argmax()) == int(b.argmax())
        return err, norm, same_top, first_state(pre.caches, LM_PROMPT), k_dec

    out = dict(tokens=tokens, wall=wall, steps=steps, decode_s=decode_s,
               kernels=prof["kernels"], busy_ms=prof["busy_ms"],
               by_kind=prof.get("by_kind", {}), peak_gb=peak / 1e9)
    if not check_prefill:
        return out
    cfg_cut, cut = cut_layers(pm, cfg, params, LM_CHECK_LAYERS)
    for dtype in ("bfloat16", "float32"):
        cfg_d = dataclasses.replace(cfg_cut, compute_dtype=dtype)
        err, norm, same_top, _, _ = prefill_vs_decode(cfg_d, cut)
        tol = LM_PREFILL_TOL[dtype]
        print(f"[{tag}] {dtype}, full width cut to {LM_CHECK_LAYERS}"
              f" layers: prefill vs prefill-by-decode, max error {err:.3e}"
              f" of the largest |logit| (tolerance {tol}), norm {norm:.3e},"
              f" same argmax where the top-2 gap is clear: {same_top}")
        check(err <= tol and same_top, f"{dtype} prefill and prefill-by-"
              f"decode differ by {err} of the logits' scale at"
              f" {LM_CHECK_LAYERS} layers")
    if cfg.n_layers > LM_CHECK_LAYERS:
        err, norm, same_top, _, _ = prefill_vs_decode(cfg, params)
        print(f"[{tag}] bfloat16, all {cfg.n_layers} layers (the served"
              f" model): prefill vs prefill-by-decode, max error {err:.3e} of"
              f" the scale, norm {norm:.3e}, same clear argmax {same_top}"
              " (reported, not checked)")
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        err, norm, same_top, k_pre, k_dec = prefill_vs_decode(cfg32, params)
        growth = [float((k_pre[i] - k_dec[i]).abs().max()
                        / k_pre[i].abs().max())
                  for i in range(k_pre.shape[0])]
        print(f"[{tag}] float32, all {cfg.n_layers} layers: prefill vs"
              f" prefill-by-decode, max error {err:.3e} of the scale, norm"
              f" {norm:.3e}, same clear argmax {same_top} (reported, not"
              " checked); the two caches' first leaf of \"blocks\" (the"
              " SSM state for Mamba) differs, relative to the layer's"
              " largest |value|, by " + ", ".join(
                  f"{g:.1e}" for g in growth[:8]) + f" ... {growth[-1]:.1e}"
              " from its layer 0 on")
    return out


def moe_block_phase(tm, cfg, params) -> dict:
    """One MLA + MoE block of the full-width weights (``blocks`` layer 0)
    at fp32 over MOE_BLOCK_T tokens (the embedding of random ids), run by
    the same port code on the card and on the CPU, as its pieces once
    (norm1, mla_attention, the residual, norm2, then moe's routing,
    slots, dispatch, experts, combine and shared experts), their sum
    checked equal to blocks.block's output: every token whose k-th and
    (k+1)-th router probabilities (the CPU's) differ by more than
    MOE_MARGIN routes to the same experts on both, and the block's output
    agrees within MOE_BLOCK_TOL of its largest |value|. The CUDA index
    ops (topk, cumsum, the buffer's writes and reads) keep the CPU's
    semantics."""
    import dataclasses

    import torch

    from repro_torch.models import blocks, layers, mla, moe
    from repro_torch.models import params as pm

    f32 = torch.float32
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    g = torch.Generator(DEVICE).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (1, MOE_BLOCK_T), generator=g,
                         device=DEVICE)
    lp = tm._layer(params["blocks"], 0)
    h = tm.embed_tokens(params, cfg32, toks, f32)

    def run(lp, h):
        pos = torch.arange(MOE_BLOCK_T, dtype=torch.int32, device=h.device)
        h2 = h + mla.mla_attention(
            lp["attn"], layers.rmsnorm(lp["norm1"], h, cfg.rms_eps), cfg32,
            positions=pos, dt=f32)
        xf = layers.rmsnorm(lp["norm2"], h2, cfg.rms_eps).reshape(
            -1, cfg.d_model)
        cap = moe._capacity(xf.shape[0], cfg32)
        r = moe.routing(lp["ffn"], xf, cfg32)
        s = moe.slots(r.top_e, cap, cfg.n_experts)
        ye = moe.experts(lp["ffn"], moe.dispatch(xf, s, cap, cfg32, f32), f32)
        y = moe.combine(ye, s, r.top_p, f32)
        if "shared" in lp["ffn"]:
            y = y + moe.shared_experts(lp["ffn"], xf, f32)
        out = h2 + y.reshape(h2.shape)
        ref, _, aux = blocks.block(lp, h, cfg32, mode="full", positions=pos,
                                   moe_layer=True, dt=f32)
        check(torch.equal(out, ref) and torch.equal(r.aux, aux),
              f"the MoE block's pieces on {h.device.type} do not sum to"
              " blocks.block's output")
        return out.cpu(), r.probs.cpu(), r.top_e.cpu(), float(r.aux)

    t = time.perf_counter()
    with torch.no_grad():
        card = run(lp, h)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        host = run(pm.tree_map(lambda x: x.cpu(), lp), h.cpu())
        host_s = time.perf_counter() - t
    out_d, _, e_d, aux_d = card
    out_h, probs_h, e_h, aux_h = host
    srt = probs_h.sort(dim=-1, descending=True).values
    clear = (srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]) > MOE_MARGIN
    same = (e_d.sort(-1).values == e_h.sort(-1).values).all(-1)
    scale = float(out_h.abs().max())
    err = float((out_d - out_h).abs().max()) / scale
    print(f"[moe-block] {cfg.name} blocks[0] (MLA + {cfg.n_experts} experts"
          f" top-{cfg.top_k}) at fp32, {MOE_BLOCK_T} tokens, card"
          f" {card_s:.3f} s, CPU {host_s:.3f} s: {int(clear.sum())} of"
          f" {MOE_BLOCK_T} tokens past the {MOE_MARGIN} margin route alike"
          f" ({int(same[clear].sum())}; {int((~clear).sum())} excused, of"
          f" which {int(same[~clear].sum())} route alike too); output max"
          f" error {err:.3e} of its scale {scale:.3f} (tolerance"
          f" {MOE_BLOCK_TOL}); aux loss {aux_d!r} on the card, {aux_h!r} on"
          " the CPU")
    check(bool(same[clear].all()), "the card routes a token past the margin"
          " to other experts than the CPU")
    check(err <= MOE_BLOCK_TOL, f"the MoE block on the card differs from"
          f" the CPU's by {err} of its scale")
    return dict(err=err, excused=int((~clear).sum()))


def moe_serve_phase(ops, serve, tm, pm, configs) -> dict:
    """8d: deepseek-v2-lite-16b at full width and depth, drawn on the card
    from a seeded CUDA generator: the CPU check of one MoE block
    (moe_block_phase), then lm_serve_phase at phase 8c's traffic. 8d':
    qwen3-moe-235b-a22b at full width cut to MOE_QWEN_LAYERS layers, with
    MOE_QWEN_REQUESTS requests. Each model is freed before the next."""
    import dataclasses

    import torch

    out = {}
    dev = torch.device(DEVICE)
    for tag, cfg, requests in (
            ("moe-serve", configs.get_config(MOE_ARCH), LM_REQUESTS),
            ("moe-serve-qwen", dataclasses.replace(
                configs.get_config(MOE_QWEN_ARCH),
                n_layers=MOE_QWEN_LAYERS), MOE_QWEN_REQUESTS)):
        torch.cuda.empty_cache()
        t = time.perf_counter()
        params = pm.init_params(tm.model_spec(cfg),
                                torch.Generator(dev).manual_seed(0),
                                device=dev)
        torch.cuda.synchronize()
        n, active = pm.count_params(params), active_params(pm, cfg, params)
        print(f"[{tag}] {cfg.name} at full width, {cfg.n_layers} layers:"
              f" {n} parameters, {torch.cuda.memory_allocated() / 1e9:.3f}"
              f" GB on the card (fp32, drawn on the card in"
              f" {time.perf_counter() - t:.3f} s); {active} active a token")
        block = moe_block_phase(tm, cfg, params) if tag == "moe-serve" else {}
        torch.cuda.reset_peak_memory_stats()
        run = lm_serve_phase(ops, serve, tm, pm, cfg, params, tag=tag,
                             requests=requests)
        out[cfg.name] = dict(run, params=n, block=block)
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def moe_train_phase(ops, tm, pm, configs) -> dict:
    """10d: deepseek-v2-lite-16b at full width, depth cut to
    MOE_TRAIN_LAYERS (the dense layer and MoE layers), trained by
    train_phase (TRAIN_STEPS steps through fit, B 1, T 4096: MLA's
    512-query blocks and the chunked loss, remat "full"); the aux loss of
    the first batch before and after; then the parameters drawn again
    from the same seed and MOE_REPEAT_STEPS steps run on the same
    batches: their losses equal the first run's bit for bit (the MoE
    dispatch adds no two values into one element by index, so its
    gradients do not depend on the order of atomic adds)."""
    import dataclasses

    import torch

    from repro_torch.train import loop

    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    res = train_phase(ops, tm, pm, cfg, tag="moe-train")
    batches, run = res.pop("batches"), res.pop("run")
    torch.cuda.empty_cache()
    params = trainable_params(tm, pm, cfg, 0)
    tokens = torch.as_tensor(batches[0]["tokens"]).to(dev)
    with torch.no_grad():
        aux0 = float(tm.forward(params, cfg, tokens,
                                return_hidden=True).aux_loss)
    again = loop.fit(cfg, run, iter(batches[:MOE_REPEAT_STEPS]),
                     params=params, steps=MOE_REPEAT_STEPS, device=dev)
    first = res["losses"][:MOE_REPEAT_STEPS]
    with torch.no_grad():
        aux2 = float(tm.forward(params, cfg, tokens,
                                return_hidden=True).aux_loss)
    print(f"[moe-train] aux loss of the first batch (the sum over"
          f" {cfg.n_layers - cfg.first_dense} MoE layers of"
          f" {cfg.router_aux_weight} x E sum_e f_e P_e, in the loss): {aux0!r}"
          f" at the init, {aux2!r} after {MOE_REPEAT_STEPS} steps; the first"
          f" {MOE_REPEAT_STEPS} steps run twice from seed 0: losses"
          f" {first!r} and {again.losses!r}")
    check(again.losses == first, f"two runs of {MOE_REPEAT_STEPS} steps from"
          f" one seed differ: {first} and {again.losses}")
    del params
    torch.cuda.empty_cache()
    return dict(res, aux0=aux0, aux2=aux2)


def leaves(tree) -> list:
    """The tensors of a tree of dicts, tuples and NamedTuples (caches)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for part in tree for x in leaves(part)]
    return [tree]


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def cut_groups(pm, cfg, params, n: int, g: int):
    """The VLM's cfg and parameters cut to its first n groups of its
    cross block and g self blocks: n whole groups (g = group_self) or the
    first group's cross block and its first g self blocks (n = 1) ->
    (cfg, params), the weights views of the full ones."""
    import dataclasses

    check(n == 1 or g == cfg.group_self, f"cut_groups({n}, {g})")
    cut = dict(params,
               cross_blocks=pm.tree_map(lambda x: x[:n],
                                        params["cross_blocks"]),
               self_blocks=pm.tree_map(lambda x: x[:n * g],
                                       params["self_blocks"]))
    return dataclasses.replace(cfg, n_cross_layers=n, group_self=g,
                               n_layers=n * g), cut


def ssm_block_phase(tm, pm, cfg, params) -> dict:
    """8e: one Mamba block of the full-width weights (``blocks`` layer 0)
    at fp32 over SSM_BLOCK_T tokens (the embedding of random ids), in
    prefill mode, by the same port code on the card and on the CPU: the
    output and the final state within SSM_BLOCK_TOL of their largest
    |value|."""
    import dataclasses

    import torch

    from repro_torch.models import blocks

    f32 = torch.float32
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    g = torch.Generator(DEVICE).manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (1, SSM_BLOCK_T), generator=g,
                         device=DEVICE)
    lp = tm._layer(params["blocks"], 0)
    h = tm.embed_tokens(params, cfg32, toks, f32)

    def run(lp, h):
        pos = torch.arange(SSM_BLOCK_T, dtype=torch.int32, device=h.device)
        out, cache, _ = blocks.block(lp, h, cfg32, mode="prefill",
                                     positions=pos, dt=f32)
        return out.cpu(), cache.ssm.ssm.cpu()

    with torch.no_grad():
        t = time.perf_counter()
        card = run(lp, h)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        host = run(pm.tree_map(lambda x: x.cpu(), lp), h.cpu())
        host_s = time.perf_counter() - t
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(card, host)]
    print(f"[mamba-block] {cfg.name} blocks[0] at fp32, {SSM_BLOCK_T} tokens"
          f" (one chunk of {min(cfg.ssm_chunk, SSM_BLOCK_T)}), card"
          f" {card_s:.3f} s, CPU {host_s:.3f} s: output max error"
          f" {errs[0]:.3e} of its scale, final state [1, {cfg.d_inner},"
          f" {cfg.ssm_state}] {errs[1]:.3e} (tolerance {SSM_BLOCK_TOL})")
    check(max(errs) <= SSM_BLOCK_TOL, f"the Mamba block on the card differs"
          f" from the CPU's by {errs} of the scale")
    return dict(out_err=errs[0], state_err=errs[1])


def long_decode_phase(tm, cfg, params) -> dict:
    """8e: one decode step of batch 1 at long_500k's last position
    (LONG_POS) from zero caches, against the same step at position 0:
    Mamba's state does not grow with the position, so its caches' bytes
    and (with no position in the arithmetic) its logits are the same."""
    import torch

    tok = torch.zeros((1, 1), dtype=torch.int32, device=DEVICE)
    caches = tm.init_caches(cfg, 1, LM_CACHE, device=DEVICE)
    with torch.no_grad():
        first, new0 = tm.decode_step(params, cfg, tok, caches, 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        last, new = tm.decode_step(params, cfg, tok, caches, LONG_POS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    c = new["blocks"].ssm
    diff = float((last.float() - first.float()).abs().max())
    print(f"[mamba-long] decode_step at position {LONG_POS} (long_500k's"
          f" last; batch 1): {ms:.3f} ms, logits finite"
          f" {bool(torch.isfinite(last).all())}; caches"
          f" {tree_bytes(new)} B: state {list(c.ssm.shape)} {c.ssm.dtype}"
          f" {tree_bytes(c.ssm)} B, conv history {list(c.conv.shape)}"
          f" {c.conv.dtype} {tree_bytes(c.conv)} B; at position 0 the caches"
          f" {tree_bytes(new0)} B, the logits {diff!r} apart")
    check(bool(torch.isfinite(last).all()), "non-finite logits at"
          f" position {LONG_POS}")
    check(tree_bytes(new) == tree_bytes(new0) == tree_bytes(caches),
          "Mamba's caches changed size with the position")
    return dict(ms=ms, cache_bytes=tree_bytes(new), diff=diff)


def ring_phase(tm, pm, cfg, params) -> dict:
    """8e': Hymba's sliding-window ring past its window, at RING_LAYERS
    layers of the full-width weights in fp32: a prefill of RING_PREFILL
    tokens keeps the last `window` positions, which go into the decode
    ring rolled so that position p sits at slot p % window (the layout
    decode_attention reads), the SSM state whole; then RING_STEPS decode
    steps, each step's logits within RING_TOL of the largest |logit| of
    the full forward's at that position."""
    import dataclasses

    import torch

    cfg_c, cut = cut_layers(pm, cfg, params, RING_LAYERS)
    cfg32 = dataclasses.replace(cfg_c, compute_dtype="float32")
    g = torch.Generator(DEVICE).manual_seed(4)
    n = RING_PREFILL + RING_STEPS
    toks = torch.randint(0, cfg.vocab, (1, n), generator=g, device=DEVICE)
    errs = []
    with torch.no_grad():
        full = tm.forward(cut, cfg32, toks).logits[0, RING_PREFILL:].float()
        pre = tm.forward(cut, cfg32, toks[:, :RING_PREFILL], mode="prefill")
        caches = tm.init_caches(cfg32, 1, n, dt=torch.float32, device=DEVICE)
        ring = caches["blocks"].kv.k.shape[2]
        check(ring == cfg.sliding_window < RING_PREFILL,
              f"ring of {ring} for a window of {cfg.sliding_window}")
        for dst, src in zip(caches["blocks"].kv, pre.caches["blocks"].kv):
            dst.copy_(torch.roll(src, RING_PREFILL % ring, dims=2))
        for dst, src in zip(caches["blocks"].ssm, pre.caches["blocks"].ssm):
            dst.copy_(src)
        for i in range(RING_STEPS):
            pos = RING_PREFILL + i
            logits, caches = tm.decode_step(cut, cfg32, toks[:, pos:pos + 1],
                                            caches, pos)
            a, b = logits[0, 0].float(), full[i]
            errs.append(float((a - b).abs().max() / b.abs().max()))
    print(f"[hymba-ring] {RING_LAYERS} layers of {cfg.name} at fp32: prefill"
          f" of {RING_PREFILL} tokens into a ring of {ring} (rolled by"
          f" {RING_PREFILL % ring}), then {RING_STEPS} decode steps at"
          f" positions {RING_PREFILL}-{n - 1}: max error of each step's"
          f" logits against the full forward's, of the largest |logit|: "
          + ", ".join(f"{e:.2e}" for e in errs) + f" (tolerance {RING_TOL})")
    check(max(errs) <= RING_TOL, f"decode on the ring past the window"
          f" differs from the full forward by {max(errs)}")
    return dict(errs=errs)


def vlm_phase(ops, tm, pm, cfg, params) -> dict:
    """8f: make_prefill_step on VLM_BATCH random prompts of LM_PROMPT
    tokens with vision embeddings [VLM_BATCH, vision_seq, d_model] bf16
    drawn on the card from a seeded generator, its caches into decode
    caches (the self-caches' leading positions, the cross keys and values
    whole), then VLM_DECODE_STEPS greedy decode steps through
    make_decode_step, the launch counters set to 0 just before and read
    just after: every step's logits finite. Then prefill against
    prefill-by-decode (the prompt decoded token by token over the
    prefill's cross caches), in bf16 and fp32, on the weights cut to
    LM_CHECK_LAYERS layers (the first group's cross block and its first
    LM_CHECK_LAYERS - 1 self blocks), within LM_PREFILL_TOL, and reported
    at LM_CHECK_LAYERS whole groups (2 cross + 8 self layers, deep enough
    for the init's growth of rounding: ROADMAP §3)."""
    import dataclasses

    import torch

    from repro_torch.train import train_step as ts

    dev = torch.device(DEVICE)
    g = torch.Generator(dev).manual_seed(5)
    ve = torch.randn((VLM_BATCH, cfg.vision_seq, cfg.d_model), generator=g,
                     device=dev).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (VLM_BATCH, LM_PROMPT), generator=g,
                         device=dev, dtype=torch.int32)
    prefill, decode = ts.make_prefill_step(cfg), ts.make_decode_step(cfg)
    torch.cuda.synchronize()
    ops.reset_dispatch_count()
    t = time.perf_counter()
    last, pre = prefill(params, toks, vision_embeds=ve)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    caches = tm.init_caches(cfg, VLM_BATCH, LM_PROMPT + VLM_DECODE_STEPS,
                            device=dev)
    for dst, src in zip(leaves(caches["self"]), leaves(pre["self"])):
        dst[:, :, :, :LM_PROMPT].copy_(src)
    caches["cross"] = pre["cross"]
    finite = [torch.isfinite(last).all()]
    tok = last[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    t = time.perf_counter()
    for i in range(VLM_DECODE_STEPS):
        logits, caches = decode(params, tok, caches, LM_PROMPT + i)
        finite.append(torch.isfinite(logits).all())
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    launches = launch_counts(ops)
    check(not launches, f"the VLM path launched {launches}; its model calls"
          " no kernel")
    check(bool(torch.stack(finite).all()), "non-finite VLM logits")
    print(f"[vlm] make_prefill_step on {VLM_BATCH} prompts of {LM_PROMPT}"
          f" tokens with vision embeddings {list(ve.shape)} bf16:"
          f" {prefill_s * 1e3:.3f} ms (the first call); cross caches"
          f" {list(pre['cross'].k.shape)} x 2, {tree_bytes(pre['cross'])} B,"
          f" self caches {list(caches['self'].kv.k.shape)} x 2,"
          f" {tree_bytes(caches['self'])} B; {VLM_DECODE_STEPS} greedy decode"
          f" steps over the prefilled cross keys and values,"
          f" {decode_s / VLM_DECODE_STEPS * 1e3:.3f} ms a step; every logit"
          " finite; kernel launches 0")
    errs = {}
    for (n, g_), dtype in itertools.product(
            ((1, LM_CHECK_LAYERS - 1), (LM_CHECK_LAYERS, cfg.group_self)),
            ("bfloat16", "float32")):
        cfg_c, cut = cut_groups(pm, cfg, params, n, g_)
        checked = n == 1
        cfg_d = dataclasses.replace(cfg_c, compute_dtype=dtype)
        with torch.no_grad():
            ref = tm.forward(cut, cfg_d, toks[:1], vision_embeds=ve[:1],
                             mode="prefill")
            c = tm.init_caches(cfg_d, 1, LM_PROMPT, dt=getattr(torch, dtype),
                               device=dev)
            c["cross"] = ref.caches["cross"]
            for i in range(LM_PROMPT):
                logits, c = tm.decode_step(cut, cfg_d, toks[:1, i:i + 1], c,
                                           i)
        a, b = ref.logits[0, -1].float(), logits[0, -1].float()
        err = float((a - b).abs().max() / a.abs().max())
        errs[(n, g_, dtype)] = err
        tol = LM_PREFILL_TOL[dtype]
        print(f"[vlm] {dtype}, full width cut to {n} group(s) of one cross"
              f" and {g_} self layer(s): prefill vs prefill-by-decode over"
              f" the prefill's cross caches, max error {err:.3e} of the"
              f" largest |logit| ("
              + (f"tolerance {tol}" if checked else "reported, not checked")
              + f"), norm {float((a - b).norm() / a.norm()):.3e}")
        check(not checked or err <= tol, f"{dtype} VLM prefill and"
              f" prefill-by-decode differ by {err} of the logits' scale")
    return dict(prefill_ms=prefill_s * 1e3,
                decode_ms=decode_s / VLM_DECODE_STEPS * 1e3, errs=errs)


def ssm_serve_phase(ops, serve, tm, pm, configs) -> dict:
    """8e, 8e', 8f: falcon-mamba-7b, hymba-1.5b and llama-3.2-vision-11b
    at full width and depth, each drawn on the card from a seeded CUDA
    generator and freed before the next: their own checks
    (ssm_block_phase and long_decode_phase; ring_phase; vlm_phase), and
    lm_serve_phase at phase 8c's traffic (the VLM text-only, zero cross
    caches, as the reference's ServeEngine serves it)."""
    import torch

    out = {}
    dev = torch.device(DEVICE)
    for tag, arch in (("mamba-serve", SSM_ARCH), ("hymba-serve", HYBRID_ARCH),
                      ("vlm-serve", VLM_ARCH)):
        cfg = configs.get_config(arch)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        params = pm.init_params(tm.model_spec(cfg),
                                torch.Generator(dev).manual_seed(0),
                                device=dev)
        torch.cuda.synchronize()
        n = pm.count_params(params)
        print(f"[{tag}] {cfg.name} at full width and depth,"
              f" {cfg.n_layers + cfg.n_cross_layers} layers{arch_note(cfg)}:"
              f" {n} parameters, {torch.cuda.memory_allocated() / 1e9:.3f} GB"
              f" on the card (fp32, drawn on the card in"
              f" {time.perf_counter() - t:.3f} s)")
        extra = {}
        if arch == SSM_ARCH:
            extra["block"] = ssm_block_phase(tm, pm, cfg, params)
            extra["long"] = long_decode_phase(tm, cfg, params)
        if arch == VLM_ARCH:
            extra["vlm"] = vlm_phase(ops, tm, pm, cfg, params)
        torch.cuda.reset_peak_memory_stats()
        run = lm_serve_phase(ops, serve, tm, pm, cfg, params, tag=tag,
                             check_prefill=arch != VLM_ARCH)
        if arch == HYBRID_ARCH:
            extra["ring"] = ring_phase(tm, pm, cfg, params)
        out[arch] = dict(run, params=n, **extra)
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def raw_init_gnorm(tm, pm, cfg, t: int, tag: str) -> float:
    """The gradient norm of the first training batch at the reference's
    init (init_params, not rescaled), remat "full": whether the
    rescaling of trainable_params is needed for cfg."""
    import torch

    from repro_torch.train import train_step as ts

    dev = torch.device(DEVICE)
    params = pm.init_params(tm.model_spec(cfg),
                            torch.Generator(dev).manual_seed(0), device=dev)
    live = [x.requires_grad_() for x in pm.tree_leaves(params)]
    batch = ts.to_device(synthetic_batches(cfg, 1, TRAIN_B, t)[0], dev)
    loss = tm.loss_fn(params, cfg, batch, remat_policy=tm.nothing_saveable)
    grads = torch.autograd.grad(loss, live)
    norm = float(torch.stack([g.float().pow(2).sum() for g in grads])
                 .sum().sqrt())
    print(f"[{tag}] at the reference's init (init_params, not rescaled):"
          f" loss {float(loss.detach())!r}, gradient norm {norm!r} on the"
          " first batch")
    del params, live, grads, loss
    torch.cuda.empty_cache()
    return norm


def ssm_train_phase(ops, tm, pm, configs) -> dict:
    """10e: train_phase (TRAIN_STEPS steps through fit, B 1, remat "full",
    from trainable_params) on hymba-1.5b cut to HYBRID_TRAIN_LAYERS
    layers, falcon-mamba-7b cut to SSM_TRAIN_LAYERS layers at T
    SSM_TRAIN_T, and
    llama-3.2-vision-11b cut to VLM_TRAIN_GROUPS group with the training
    launcher's vision embeddings; before each, the first batch's gradient
    norm at the reference's own init (raw_init_gnorm)."""
    import dataclasses

    import torch

    vlm = configs.get_config(VLM_ARCH)
    runs = (("hymba-train", dataclasses.replace(
                configs.get_config(HYBRID_ARCH),
                n_layers=HYBRID_TRAIN_LAYERS), TRAIN_T),
            ("mamba-train", dataclasses.replace(
                configs.get_config(SSM_ARCH), n_layers=SSM_TRAIN_LAYERS),
             SSM_TRAIN_T),
            ("vlm-train", dataclasses.replace(
                vlm, n_cross_layers=VLM_TRAIN_GROUPS,
                n_layers=VLM_TRAIN_GROUPS * vlm.group_self), TRAIN_T))
    out = {}
    for tag, cfg, t in runs:
        torch.cuda.empty_cache()
        raw = raw_init_gnorm(tm, pm, cfg, t, tag)
        res = train_phase(ops, tm, pm, cfg, tag=tag, t=t)
        res.pop("batches")
        res.pop("run")
        out[cfg.name] = dict(res, raw_gnorm=raw, t=t,
                             layers=cfg.n_layers + cfg.n_cross_layers)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def audio_block_phase(tm, pm, cfg, params) -> dict:
    """8g: the audio path of the full-width weights at fp32 over
    AUDIO_BLOCK_T positions of random [1, T, K] tokens, by the same port
    code on the card and on the CPU: the codebooks' embeddings summed,
    ``blocks`` layer 0, the final norm and the K heads; the logits [1, T,
    K, V] within AUDIO_BLOCK_TOL of their largest |value|."""
    import dataclasses

    import torch

    from repro_torch.models import blocks, layers

    f32 = torch.float32
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    g = torch.Generator(DEVICE).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (1, AUDIO_BLOCK_T, cfg.n_codebooks),
                         generator=g, device=DEVICE)
    keys = ("embed", "final_norm", "head")

    def run(p, lp, toks):
        h = tm.embed_tokens(p, cfg32, toks, f32)
        pos = torch.arange(AUDIO_BLOCK_T, dtype=torch.int32, device=h.device)
        h, _, _ = blocks.block(lp, h, cfg32, mode="full", positions=pos,
                               dt=f32)
        h = layers.rmsnorm(p["final_norm"], h, cfg.rms_eps)
        return tm.logits_fn(p, cfg32, h, f32).cpu()

    lp = tm._layer(params["blocks"], 0)
    top = {k: params[k] for k in keys}
    with torch.no_grad():
        t = time.perf_counter()
        card = run(top, lp, toks)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        host = run(pm.tree_map(lambda x: x.cpu(), top),
                   pm.tree_map(lambda x: x.cpu(), lp), toks.cpu())
        host_s = time.perf_counter() - t
    err = float((card - host).abs().max() / host.abs().max())
    print(f"[audio-block] {cfg.name} at fp32, {AUDIO_BLOCK_T} positions of"
          f" {cfg.n_codebooks} codebooks: embeddings summed, blocks[0], the"
          f" final norm and the heads (logits {list(card.shape)}), card"
          f" {card_s:.3f} s, CPU {host_s:.3f} s: max error {err:.3e} of the"
          f" logits' scale (tolerance {AUDIO_BLOCK_TOL})")
    check(card.shape == (1, AUDIO_BLOCK_T, cfg.n_codebooks, cfg.vocab),
          f"audio logits of shape {tuple(card.shape)}")
    check(err <= AUDIO_BLOCK_TOL, f"the audio path on the card differs from"
          f" the CPU's by {err} of the scale")
    return dict(err=err)


def audio_prefill_phase(tm, pm, cfg, params) -> dict:
    """8g: prefill against prefill-by-decode on LM_SLOTS prompts of
    LM_PROMPT positions [B, T, K] (every codebook its own random ids), on
    the full-width weights cut to LM_CHECK_LAYERS layers, in bf16 and in
    fp32 (fp32 caches): the prefill forward's last logits [B, K, V]
    against decode_step's after the prompt's positions one by one, within
    LM_PREFILL_TOL of the largest |logit|, the same argmax wherever the
    top-2 gap is clear of it."""
    import dataclasses

    import torch

    g = torch.Generator(DEVICE).manual_seed(6)
    prompts = torch.randint(0, cfg.vocab, (LM_SLOTS, LM_PROMPT,
                                           cfg.n_codebooks),
                            generator=g, device=DEVICE, dtype=torch.int32)
    cfg_cut, cut = cut_layers(pm, cfg, params, LM_CHECK_LAYERS)
    out = {}
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            cfg_d = dataclasses.replace(cfg_cut, compute_dtype=dtype)
            pre = tm.forward(cut, cfg_d, prompts, mode="prefill")
            a = pre.logits[:, -1].float()
            caches = tm.init_caches(
                cfg_d, LM_SLOTS, LM_PROMPT, device=DEVICE,
                dt=torch.float32 if dtype == "float32" else torch.bfloat16)
            for i in range(LM_PROMPT):
                logits, caches = tm.decode_step(cut, cfg_d,
                                                prompts[:, i:i + 1], caches, i)
            b = logits[:, -1].float()
            scale = float(a.abs().max())
            err = float((a - b).abs().max()) / scale
            tol = LM_PREFILL_TOL[dtype]
            top2 = a.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > tol * scale
            same_top = bool((a.argmax(-1) == b.argmax(-1))[clear].all())
            print(f"[audio-serve] {dtype}, full width cut to"
                  f" {LM_CHECK_LAYERS} layers, {LM_SLOTS} prompts [T"
                  f" {LM_PROMPT}, {cfg.n_codebooks} codebooks]: prefill vs"
                  f" prefill-by-decode, max error {err:.3e} of the largest"
                  f" |logit| (tolerance {tol}), same argmax on the"
                  f" {int(clear.sum())} of {clear.numel()} (prompt, codebook)"
                  f" rows whose top-2 gap is clear: {same_top}")
            check(err <= tol and same_top, f"{dtype} audio prefill and"
                  f" prefill-by-decode differ by {err} of the scale")
            out[dtype] = err
    return out


def audio_serve_phase(ops, serve, tm, pm, configs) -> dict:
    """8g: musicgen-medium at full width and depth, drawn on the card from
    a seeded CUDA generator: audio_block_phase, lm_serve_phase at phase
    8c's traffic (1-D prompts, as the reference's ServeEngine serves the
    audio family), audio_prefill_phase; freed at the end."""
    import torch

    dev = torch.device(DEVICE)
    cfg = configs.get_config(AUDIO_ARCH)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    params = pm.init_params(tm.model_spec(cfg),
                            torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n = pm.count_params(params)
    print(f"[audio-serve] {cfg.name} at full width and depth,"
          f" {cfg.n_layers} layers{arch_note(cfg)}: {n} parameters,"
          f" {torch.cuda.memory_allocated() / 1e9:.3f} GB on the card (fp32,"
          f" drawn on the card in {time.perf_counter() - t:.3f} s)")
    block = audio_block_phase(tm, pm, cfg, params)
    torch.cuda.reset_peak_memory_stats()
    run = lm_serve_phase(ops, serve, tm, pm, cfg, params, tag="audio-serve",
                         check_prefill=False)
    prefill = audio_prefill_phase(tm, pm, cfg, params)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(run, params=n, block=block, prefill=prefill)


def audio_train_phase(ops, tm, pm, configs) -> dict:
    """10f: train_phase on musicgen-medium at full width and depth, B 1,
    T TRAIN_T, remat "full", from trainable_params, on synthetic [1, T,
    K] batches; no profiled step, which with its 36,000 kernels a step
    would add tens of seconds to the run."""
    import torch

    cfg = configs.get_config(AUDIO_ARCH)
    torch.cuda.empty_cache()
    res = train_phase(ops, tm, pm, cfg, tag="audio-train", profile=False)
    res.pop("batches")
    res.pop("run")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def devices_phase(ops, sf, pk, ix, corpus, stemmer, arrays, grown,
                  serve_words, wants, table, index_want) -> dict:
    """12, several devices: the sharded stemmer, serving, index and stage
    pipeline on meshes of the card (see the module docstring), each result
    held to its unsharded counterpart. The path's runs (the pipeline,
    shard_batch over the 1M words at 4 shards on both dictionaries, the
    sharded serve, the sharded index) are each warmed up, then timed with
    the launch counters set to 0 just before and read just after; their
    counts are summed. Then the CLI starts in a process of its own while
    the untimed checks run (ragged batches, shard_batch at 1 shard's
    launches, the device loss). -> launches by wrapper and K5 instance
    over the counted runs, words/s by path, seconds."""
    import os

    import numpy as np
    import torch

    from repro_torch.dist import mesh_axis_size, shard_batch
    from repro_torch.dist import pipeline as dpipe
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.serve import (DegradationPolicy, DictStore, Engine,
                                   FaultInjector, FaultPlan, FaultSpec,
                                   StemmerWorkload)

    dev = torch.device(DEVICE, 0)
    root = Path(__file__).resolve().parent
    cli = None
    try:
        t_phase = time.perf_counter()
        n_gpu = torch.cuda.device_count()
        gpus = mesh_mod.make_data_mesh(n_gpu)
        check(gpus.shape == {"data": n_gpu}
              and [d.index for d in gpus.devices] == list(range(n_gpu)),
              f"make_data_mesh({n_gpu}) gave {gpus}")
        mesh = mesh_mod.Mesh.of([dev] * DEVICE_SHARDS)
        stages = mesh_mod.Mesh.of([dev] * PIPELINE_STAGES, axis="stage")
        print(f"[devices] torch.cuda.device_count() = {n_gpu}:"
              f" make_data_mesh({n_gpu}) = {gpus}; the {DEVICE_SHARDS}- and"
              f" {PIPELINE_STAGES}-entry meshes repeat {dev}, so their shards"
              f" run one after another on one GPU, not on {DEVICE_SHARDS}"
              f" GPUs; {card_line()}")
        handles = {"realistic": stemmer.resolve_dict(arrays, dict_block_r=8),
                   "grown": stemmer.resolve_dict(grown, dict_block_r=8)}
        words = torch.from_numpy(serve_words).to(dev)
        n_req = SERVE_WORDS // SERVE_REQUEST_WORDS
        counted: dict = {}              # launches over the counted runs
        counted_k5: dict = {}

        def run(fn, count=True):
            """fn() with the counters set to 0 just before and read just
            after -> (its result, seconds, launches by wrapper); with
            ``count`` the launches join the phase's."""
            torch.cuda.synchronize()
            ops.reset_dispatch_count()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            n = launch_counts(ops)
            if count:
                for k, v in n.items():
                    counted[k] = counted.get(k, 0) + v
                for k, v in pk.postings_cuda.instances.items():
                    counted_k5[k] = counted_k5.get(k, 0) + v
            return out, secs, n

        # -- the 5-stage pipeline over 1,024 words ---------------------------
        m = PIPELINE_MICROBATCHES
        mb = PIPELINE_WORDS // m
        pw = words[:PIPELINE_WORDS]
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                       device=dev)
        bundle = {"words": pw.reshape(m, mb, 16), "keys": z(m, mb, 32),
                  "valid": z(m, mb, 32), "root": z(m, mb, 4),
                  "source": z(m, mb)}
        fns = dpipe.stemmer_stage_fns(arrays)
        dpipe.pipeline_map(fns, bundle, stages)             # warm-up
        out, pipe_s, n = run(lambda: dpipe.pipeline_map(fns, bundle, stages))
        k6 = sum(n.values())
        want_r, want_s = wants["realistic"]
        check(np.array_equal(out["root"].reshape(-1, 4).cpu().numpy(),
                             want_r[:PIPELINE_WORDS])
              and np.array_equal(out["source"].reshape(-1).cpu().numpy(),
                                 want_s[:PIPELINE_WORDS]),
              "pipeline_map differs from the plain stemmer")
        check(n == {"stem_datapath_cuda": m + PIPELINE_STAGES - 1},
              f"pipeline_map launched {n}, want K6 once a tick"
              f" ({m + PIPELINE_STAGES - 1})")
        print(f"[devices] pipeline_map, {PIPELINE_STAGES} stages on"
              f" {PIPELINE_STAGES} entries of {dev}, {m} microbatches of {mb}"
              f" words: {m + PIPELINE_STAGES - 1} ticks, {k6} K6 launches, in"
              f" {pipe_s:.6f} s, equal to the plain stemmer")

        # -- shard_batch over 1M words at 1 and 4 shards ---------------------
        rates = {}
        for name, h in handles.items():
            want_r, want_s = wants[name]
            want_cs = ops.tile_checksum_host(want_r, want_s, block_b=BLOCK_B)
            for label, mm in (("1 shard", gpus), ("4 shards", mesh)):
                n_dev = mesh_axis_size(mm, "data")
                sharded = lambda: shard_batch(  # noqa: E731
                    words, h, mm, block_b=BLOCK_B, with_checksum=True)
                sharded()                                   # warm-up
                (r, s_, cs), secs, n = run(sharded, count=mm is mesh)
                planned = n_dev * sf.planned_launches(
                    -(-SERVE_WORDS // n_dev), h, block_b=BLOCK_B)
                check(np.array_equal(r.cpu().numpy(), want_r)
                      and np.array_equal(s_.cpu().numpy(), want_s)
                      and np.array_equal(cs.cpu().numpy(), want_cs),
                      f"shard_batch, {name}, {label}: differs from the"
                      " unsharded result or its checksums")
                check(sum(n.values()) == planned, f"shard_batch, {name},"
                      f" {label}: launched {n}, planned {planned}")
                rates[(name, label)] = SERVE_WORDS / secs
                print(f"[devices] shard_batch, {name} dictionary"
                      f" ({h.residency}), {SERVE_WORDS} words on {label} of"
                      f" {dev}: {secs:.6f} s"
                      f" ({SERVE_WORDS / secs:.0f} words/s, {n} = planned),"
                      " equal to the unsharded result,"
                      f" {cs.shape[0]} tile checksums equal")

        # -- the sharded serve, no fault -------------------------------------
        def serve(n, *, injector=None, policy=None):
            wl = StemmerWorkload(DictStore(arrays, device=dev),
                                 block_b=BLOCK_B,
                                 megabatch_tiles=SHARD_MEGABATCH,
                                 max_inflight=2, data_devices=DEVICE_SHARDS,
                                 mesh=mesh, injector=injector)
            eng = Engine(wl, policy=policy)
            rids = [eng.submit(serve_words[i * SERVE_REQUEST_WORDS:
                                           (i + 1) * SERVE_REQUEST_WORDS])
                    for i in range(n)]
            return eng, rids, eng.run_until_drained(max_ticks=100_000)

        def exact(eng, rids, label):
            want_r, want_s = wants["realistic"]
            for i, rid in enumerate(rids):
                req = eng.result(rid)
                sl = slice(i * SERVE_REQUEST_WORDS,
                           (i + 1) * SERVE_REQUEST_WORDS)
                check(req is not None and req.done and req.failure is None
                      and np.array_equal(req.roots, want_r[sl])
                      and np.array_equal(req.sources, want_s[sl]),
                      f"{label}: request {rid} differs from the plain stemmer")

        serve(8)                        # warm-up: buffers at size
        (eng, rids, rep), serve_s, n = run(lambda: serve(n_req))
        wl = eng.workload
        exact(eng, rids, "sharded serve")
        check(wl.checksum_tiles == SERVE_WORDS // BLOCK_B
              and wl.ticks_launched == SERVE_WORDS // wl.launch_b
              and n == {"stem_fused_cuda": DEVICE_SHARDS * wl.ticks_launched},
              f"sharded serve: {wl.checksum_tiles} tiles checksum-verified,"
              f" {wl.ticks_launched} launches of {wl.launch_b} rows,"
              f" launched {n}")
        rates["serve, 4 shards"] = SERVE_WORDS / serve_s
        print(f"[devices] Engine + StemmerWorkload(data_devices="
              f"{DEVICE_SHARDS}, megabatch_tiles {SHARD_MEGABATCH}) on"
              f" {DEVICE_SHARDS} x {dev}: {n_req} requests / {SERVE_WORDS}"
              f" words in {serve_s:.6f} s"
              f" ({SERVE_WORDS / serve_s:.0f} words/s,"
              f" {rep.ticks} ticks, {wl.ticks_launched} launches of"
              f" {wl.launch_b} rows = {sum(n.values())} K1 kernels,"
              f" {wl.checksum_tiles} tiles"
              " checksum-verified), every request exact")

        # -- the 1M-word index on 4 shards -----------------------------------
        chunks = list(corpus.stream_corpus_words(
            INDEX_WORDS, seed=0, chunk_words=INDEX_CHUNK,
            words_per_doc=INDEX_WORDS_PER_DOC, table=table))
        kw = dict(mesh=mesh, block_b=INDEX_BLOCK, block_w=INDEX_BLOCK)
        ix.build_corpus_index(iter(chunks[:1]), arrays, **kw)    # warm-up
        idx, index_s, n = run(
            lambda: ix.build_corpus_index(iter(chunks), arrays, **kw))
        for name in ("counts", "offsets", "docs", "positions"):
            check(np.array_equal(getattr(idx, name),
                                 getattr(index_want, name)),
                  f"the sharded index's {name} differ from phase 7b's")
        want_n = DEVICE_SHARDS * len(chunks)
        check(n == {"stem_fused_cuda": want_n, "postings_cuda": want_n},
              f"sharded index: launched {n}, want K1 and K5 once a shard a"
              " chunk")
        rates["index, 4 shards"] = INDEX_WORDS / index_s
        print(f"[devices] build_corpus_index over {INDEX_WORDS} words in"
              f" {len(chunks)} chunks on {DEVICE_SHARDS} x {dev}:"
              f" {index_s:.6f} s ({INDEX_WORDS / index_s:.0f} words/s,"
              f" launched {n}), equal to phase 7b's index")
        for name in ("stem_fused_cuda", "stem_streamed_cuda", "postings_cuda",
                     "stem_datapath_cuda"):
            check(counted.get(name, 0) > 0,
                  f"phase 12's counted runs never launched {name}: {counted}")
        print(f"[devices] launches of the counted runs (pipeline, shard_batch"
              f" at 4 shards on both dictionaries, serve, index): {counted}"
              f" (K5 instances {counted_k5})")

        # -- untimed: the CLI in a process of its own meanwhile --------------
        cli = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
             "stemmer", "--devices", "1"], cwd=root,
            env={**os.environ, "PYTHONPATH": str(root / "src")},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def launched() -> int:
            torch.cuda.synchronize()
            return ops.dispatch_count()

        # -- untimed: shard_batch on ragged batches, both dictionaries -------
        for name, h in handles.items():
            want_r, want_s = wants[name]
            for b in RAGGED_BATCHES:
                before = launched()
                r, s_ = shard_batch(serve_words[:b], h, mesh, block_b=BLOCK_B)
                n = launched() - before
                planned = DEVICE_SHARDS * sf.planned_launches(
                    -(-b // DEVICE_SHARDS), h, block_b=BLOCK_B)
                check(np.array_equal(r.cpu().numpy(), want_r[:b])
                      and np.array_equal(s_.cpu().numpy(), want_s[:b]),
                      f"shard_batch, {name}, B={b}: differs from the unsharded"
                      " result")
                check(n == planned, f"shard_batch, {name}, B={b}: {n}"
                      f" launches, planned {planned}")

        # -- untimed: the sharded serve under a device loss ------------------
        inj = FaultInjector(FaultPlan(specs=(FaultSpec("device_loss",
                                                       at=DEVICE_LOSS_AT),)))
        pol = DegradationPolicy(down_after=1)
        eng, rids, rep = serve(n_req, injector=inj, policy=pol)
        wl = eng.workload
        exact(eng, rids, "sharded serve under a device loss")
        check(wl.device_losses == 1 and inj.fired == [
            ("device_loss", "lost", DEVICE_LOSS_AT)]
              and [t[1:] for t in pol.transitions] == [
                  (f"devices-{DEVICE_SHARDS // 2}", "device_loss")],
              f"device loss: {wl.device_losses} losses, fired {inj.fired},"
              f" transitions {pol.transitions}")
        loss_launches = wl.ticks_launched
        eng.step()                      # the mode lands at an empty ring
        check(wl.data_devices == DEVICE_SHARDS // 2
              and wl.residency_override == "streamed",
              f"after the loss: {wl.data_devices} data devices, residency"
              f" {wl.residency_override}")
        before = launched()
        streamed_before = sf.stem_streamed_cuda.launches
        rids2 = [eng.submit(serve_words[i * SERVE_REQUEST_WORDS:
                                        (i + 1) * SERVE_REQUEST_WORDS])
                 for i in range(AFTER_LOSS_REQUESTS)]
        check(eng.run_until_drained(max_ticks=100_000).drained,
              "the serve on the smaller mesh did not drain")
        exact(eng, rids2, "sharded serve on the devices-2 rung")
        check(launched() > before
              and sf.stem_streamed_cuda.launches > streamed_before,
              "the devices-2 rung launched no K2 (the streamed override)")
        print(f"[devices] Engine + StemmerWorkload(data_devices="
              f"{DEVICE_SHARDS}) on {DEVICE_SHARDS} x {dev}, {n_req} requests"
              f" of {SERVE_WORDS // n_req} words with a device lost at launch"
              f" {DEVICE_LOSS_AT}: {rep.ticks} ticks, {loss_launches}"
              f" launches, {wl.retries_total} retried, events"
              f" {sorted({e.kind for e in eng.events()})}, transitions"
              f" {pol.transitions}, every request exact; then"
              f" {AFTER_LOSS_REQUESTS} requests on {wl.data_devices} shards"
              " (streamed override), exact (untimed: the CLI runs"
              " meanwhile)")

        cli_out, _ = cli.communicate(timeout=300)
        check(cli.returncode == 0 and "super-tile 1x256" in cli_out,
              f"the CLI with --devices 1 failed: {cli_out[-2000:]}")
        print("[devices] CLI: python -m repro_torch.launch.serve --workload"
              f" stemmer --devices 1: {cli_out.strip().splitlines()[0]}")
        secs = time.perf_counter() - t_phase
        print(f"[devices] phase 12 in {secs:.1f} s")
        return {"launches": counted, "rates": rates, "seconds": secs,
                "k5_instances": counted_k5}
    finally:
        if cli is not None and cli.poll() is None:
            cli.kill()
            cli.wait()


def start_dryrun():
    """Phase 11's ``launch.dryrun --all`` in a process of its own, on the
    host's CPU and the meta device (no CUDA device visible to it), while
    the card runs the phases before; dryrun_phase collects it."""
    import atexit
    import os

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--force"], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def dryrun_phase(dry, configs, train_run, remat_runs, audio_run) -> dict:
    """11: the dry run's 32 cells (every line printed, all OK), then its
    own functions applied to the configurations phases 10, 10b and 10f
    measured on the card: the argument bytes (dryrun.argument_bytes)
    within ARGS_TOL of the memory held at the AdamW update, the bytes kept
    for the backward pass (dryrun.kept_bytes) within KEPT_TOL (or
    KEPT_FLOOR_GB) of 10b's under each policy, the predicted peak against
    the fit's (reported, not checked), and the steady step no faster than
    the roofline's compute term."""
    import dataclasses

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun, input_specs

    proc, t0 = dry
    out, _ = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    lines = out.strip().splitlines()
    for line in lines:
        print(f"[dryrun-card] {line}")
    ok = [x for x in lines if x.startswith("[dryrun] OK")]
    print(f"[dryrun-card] {len(ok)} cells OK; the process (its own"
          " seconds on its last line but one) started after the build, ran"
          f" on the host's CPU beside phases 3 on and was collected"
          f" {wall:.1f} s after it started")
    check(proc.returncode == 0 and len(ok) == DRYRUN_CELLS
          and lines[-1] == f"[dryrun] {DRYRUN_CELLS} ok, 0 failed",
          f"the dry run exited {proc.returncode}: {lines[-3:]}")

    shape = ShapeConfig("chip", TRAIN_T, TRAIN_B, "train")
    res = {}
    for tag, arch, run in (("train", TRAIN_ARCH, train_run),
                           ("audio-train", AUDIO_ARCH, audio_run)):
        cfg = configs.get_config(arch)
        t = time.perf_counter()
        pred = dryrun.predict(cfg, shape,
                              costs=dryrun.analysis_costs(arch, shape))
        sec = time.perf_counter() - t
        mem, roof = pred["memory"], pred["roofline"]
        args, held = mem["arguments"], run["state_bytes"]
        err = (args - held) / held
        peak_ratio = mem["peak"] / run["peak_above"]
        compute_ms = roof["compute_s"] * 1e3
        print(f"[dryrun-card] {tag} ({arch}, B {TRAIN_B}, T {TRAIN_T},"
              f" remat full; predicted in {sec:.3f} s): arguments"
              f" {args} B predicted, {held} B held at the AdamW update on"
              f" the card ({err:+.6f}; tolerance {ARGS_TOL}); kept for the"
              f" backward pass {mem['kept'] / 1e9:.6f} GB; peak"
              f" {mem['peak'] / 1e9:.6f} GB predicted, the fit's"
              f" {run['peak_above'] / 1e9:.6f} GB (ratio {peak_ratio:.4f},"
              f" reported); FLOPs {pred['flops']:.6e}, bytes moved"
              f" {pred['bytes']:.6e}: compute term {compute_ms:.3f} ms,"
              f" memory term {roof['memory_s'] * 1e3:.3f} ms"
              f" ({roof['bottleneck']}) against the steady step's"
              f" {run['steady_ms']:.3f} ms ({compute_ms / run['steady_ms']:.4f}"
              " of it)")
        check(abs(err) <= ARGS_TOL, f"{tag}: predicted arguments {args} B,"
              f" held {held} B")
        check(run["steady_ms"] >= compute_ms, f"{tag}: a step of"
              f" {run['steady_ms']} ms beats the roofline's compute term"
              f" {compute_ms} ms")
        res[tag] = dict(args=args, held=held, err=err, peak=mem["peak"],
                        peak_ratio=peak_ratio, compute_ms=compute_ms,
                        memory_ms=roof["memory_s"] * 1e3,
                        flops=pred["flops"], bytes=pred["bytes"])

    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              n_layers=REMAT_LAYERS)
    batch = input_specs.batch_specs(cfg, shape)
    for name in ("none", "dots", "full"):
        pred = dryrun.kept_bytes(cfg, batch, name) / 1e9
        got = remat_runs[name]["kept_gb"]
        tol = max(KEPT_TOL * got, KEPT_FLOOR_GB)
        print(f"[dryrun-card] remat {name!r} ({TRAIN_ARCH} at"
              f" {REMAT_LAYERS} layers, T {TRAIN_T}): kept for the backward"
              f" pass {pred:.6f} GB predicted, {got:.6f} GB measured (10b),"
              f" {pred - got:+.6f} GB (tolerance {tol:.6f})")
        check(abs(pred - got) <= tol, f"remat {name!r}: predicted kept"
              f" {pred} GB, measured {got} GB")
        res[f"kept_{name}"] = (pred, got)
    res["wall"] = wall
    return res


def synthetic_batches(cfg, n: int, b: int, t: int) -> list:
    """n numpy batches of the synthetic LM stream, made before a timed run
    (a 4096-token batch takes the host tens of ms); the VLM's with the
    training launcher's stand-in vision embeddings, bf16 [b, vision_seq,
    d_model] drawn from seed 0; the audio family's [b, t, K], K streams
    stacked."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train as launch_train

    import numpy as np

    if cfg.n_codebooks:   # one stream a codebook (seed k), stacked
        its = [pipeline.synthetic_lm_batches(cfg.vocab, b, t, seed=k,
                                             effective_vocab=TRAIN_LIVE_IDS)
               for k in range(cfg.n_codebooks)]
        out = []
        for _ in range(n):
            parts = [next(it) for it in its]
            out.append({key: np.stack([p[key] for p in parts], axis=-1)
                        for key in ("tokens", "labels")})
        return out
    it = pipeline.synthetic_lm_batches(cfg.vocab, b, t,
                                       effective_vocab=TRAIN_LIVE_IDS)
    if cfg.n_cross_layers:
        it = launch_train.with_vision_embeds(it, cfg)
    return [next(it) for _ in range(n)]


STACKS = ("dense_blocks", "blocks", "self_blocks", "cross_blocks")


def trainable_params(tm, pm, cfg, seed: int):
    """cfg's parameters drawn by init_params from a generator on the card
    seeded with ``seed``, then rescaled, in every layer stack (``blocks``
    and DeepSeek's ``dense_blocks``): each weight to std (the product of
    the dims it contracts)^-0.5, and the residual outputs (attention's
    ``wo``, the FFN's, the routed and the shared experts') by a further
    (2 L)^-0.5, GPT-2's scaling. The reference's rule takes the fan-in
    from shape[-2]: right for a matrix [d_in, d_out] and an expert's [E,
    d_in, d_out], but for attention's 3-d weights a head count or a head
    dim: the in-projections [d_in, n, h] (GQA's wq, wk, wv; MLA's wq and
    its up-projections wuk, wuv from the latent) contract their first
    dim, the out-projection wo [n, h, d] its first two. From that rule
    gemma-2b's gradients at 18 layers overflow fp32 (its single KV head
    gets std 1: a gradient norm of inf at every step, on the card), and
    the reference's grow as fast. Every stack (the VLM's self and cross
    blocks too) is rescaled; Mamba's weights are matrices whose fan-in
    the rule gets right, and its out_proj takes the residual scaling."""
    import torch

    dev = torch.device(DEVICE)
    p = pm.init_params(tm.model_spec(cfg),
                       torch.Generator(dev).manual_seed(seed), device=dev)
    depth = (2 * (cfg.n_layers + cfg.n_cross_layers)) ** -0.5
    with torch.no_grad():
        for key in STACKS:
            if key not in p:
                continue
            attn, ffn = p[key].get("attn", {}), p[key].get("ffn", {})
            for name, w in attn.items():
                if w.dim() == 4:   # [L, ., ., .]: std shape[-2]^-0.5 now
                    fan = w.shape[1] * (w.shape[2] if name == "wo" else 1)
                    w.mul_((w.shape[-2] / fan) ** 0.5)
            for w in (attn.get("wo"), ffn.get("wo"),
                      ffn.get("shared", {}).get("wo"),
                      p[key].get("mamba", {}).get("out_proj")):
                if w is not None:
                    w.mul_(depth)
    return p


def active_params(pm, cfg, params) -> int:
    """The parameters a token's forward pass multiplies, for 6 N tokens:
    every leaf but the input embedding (a lookup; counted when the head
    is tied to it, as then it is the output head) and the routed experts,
    counted at top_k / n_experts, a token's share of them."""
    n = pm.count_params(params)
    if not cfg.tie_embeddings:
        n -= params["embed"].numel()
    for key in STACKS:
        ffn = params.get(key, {}).get("ffn", {})
        if "router" in ffn:
            routed = sum(ffn[k].numel() for k in ("wi", "wg", "wo"))
            n -= routed - routed * cfg.top_k // cfg.n_experts
    return n


def trace_split(prof, params) -> tuple:
    """From the trace of one profiled train step: its kernel ms by part,
    {"forward", "backward", "update"}, and its weight casts,
    {"forward": (count, ms), "backward": (count, ms)}. A kernel belongs to
    the op that launched it; an op under an autograd evaluate_function is
    in the backward pass (the recomputation with it), the others before
    it are the forward pass and those after it the gradient norm and the
    AdamW update. A weight cast is an aten::_to_copy of a weight's shape
    (a layer's slice of a stacked weight, or the embedding): under
    ToCopyBackward0 a gradient's cast back to fp32, else a weight's to
    bf16 (the forward pass or its recomputation); its ms are its kernels'."""
    from torch.autograd import DeviceType

    from repro_torch.models import params as pm

    shapes = {tuple(x.shape[1:]) for key in STACKS
              for x in pm.tree_leaves(params.get(key, {})) if x.dim() >= 3}
    shapes.add(tuple(params["embed"].shape))
    ops = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def grad_node(e):
        while e is not None:
            if e.name.startswith("autograd::engine::evaluate_function"):
                return e.name
            e = e.cpu_parent
        return None

    # a cast nested in another is a dispatch mode's redispatch ("dots")
    def outermost_cast(e):
        a = e.cpu_parent
        while a is not None and a.name != "aten::_to_copy":
            a = a.cpu_parent
        return a is None

    node = {id(e): grad_node(e) for e in ops}
    bwd = [e for e in ops if node[id(e)]]
    check(bool(bwd), "the profiled step has no backward op")
    first = min(e.time_range.start for e in bwd)
    split = {"forward": 0.0, "backward": 0.0, "update": 0.0}
    casts = {"forward": [0, 0.0], "backward": [0, 0.0]}
    for e in ops:
        ms = sum(k.duration for k in e.kernels) / 1e3
        part = ("backward" if node[id(e)] else
                "forward" if e.time_range.start < first else "update")
        split[part] += ms
        if (e.name == "aten::_to_copy" and e.input_shapes
                and tuple(e.input_shapes[0]) in shapes
                and outermost_cast(e)):
            key = ("backward" if node[id(e)] and node[id(e)].endswith(
                "ToCopyBackward0") else "forward")
            casts[key][0] += 1
            casts[key][1] += e.device_time_total / 1e3
    return split, {k: tuple(v) for k, v in casts.items()}


def profiled_step(step, params, opt, batch) -> dict:
    """One train step under torch.profiler (shapes recorded): its wall
    with the profiler on, its kernels (count, ms by name and by kind) and
    trace_split's parts and weight casts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name: dict = {}
    by_kind: dict = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            by_name[ev.name[:60]] = by_name.get(ev.name[:60], 0.0) + ms
            kind = kernel_kind(ev.name)
            by_kind[kind] = by_kind.get(kind, 0.0) + ms
            n_kernels += 1
    split, casts = trace_split(prof, params)
    return dict(prof=prof, wall=wall, by_name=by_name, by_kind=by_kind,
                n_kernels=n_kernels, busy=sum(by_name.values()),
                split=split, casts=casts)


@contextlib.contextmanager
def memory_at_update():
    """torch.cuda.memory_allocated() at the entry of each AdamW update run
    inside the block (train_step calls optimizer.update once a step, when
    the parameters, their gradients, the moments and the batch are all
    alive) -> the list of readings."""
    import torch

    from repro_torch.train import optimizer

    seen: list = []
    update = optimizer.update

    def reading(*args, **kwargs):
        torch.cuda.synchronize()
        seen.append(torch.cuda.memory_allocated())
        return update(*args, **kwargs)

    optimizer.update = reading
    try:
        yield seen
    finally:
        optimizer.update = update


def kernel_kind(name: str) -> str:
    """A kernel's kind, by its name."""
    if any(k in name for k in ("nvjet", "gemm", "cutlass", "xmma")):
        return "matrix products"
    if "softmax" in name.lower():
        return "softmax"
    if "elementwise" in name or "copy" in name:
        return "elementwise and copies"
    if "reduce" in name.lower():
        return "reductions"
    return "other"


def train_phase(ops, tm, pm, cfg, *, tag="train", t=TRAIN_T,
                profile=True) -> dict:
    """cfg trained at full width: TRAIN_STEPS steps through train.loop.fit
    from trainable_params(seed 0) (remat "full", the RunConfig default),
    the launch counters set to 0 just before and read just after (the
    training path reaches no kernel of the port, as the reference's
    reaches no pallas_call). Checks every loss and gradient norm finite
    and the last loss below the first, not that it falls every step: at
    this recipe (lr warming up to 3e-3 over 20 steps, B 1, 64 live ids)
    the loss falls for a few steps and then jumps back up, and so does
    the reference's, at the same step and within 1e-6 of the port's, from
    the same weights and batches (tests/train_recipe.py;
    chip_train_recipe.py finds the smallest recipe that jumps on the
    card). Prints ms a step, tokens/s, 6 N
    tokens/s (N = active_params), peak memory, then the memory held at one
    more step's AdamW update and (``profile``) a profile of a step and its
    weight casts. -> its numbers and the losses."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.train import loop, optimizer, train_step as ts

    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = trainable_params(tm, pm, cfg, 0)
    n_params = pm.count_params(params)
    n_active = active_params(pm, cfg, params)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "chip", t, TRAIN_B, "train"), learning_rate=TRAIN_LR,
        lr_warmup=TRAIN_WARMUP)
    check(run.remat == "full", f"RunConfig's remat default is {run.remat}")
    batches = synthetic_batches(cfg, TRAIN_STEPS + 2, TRAIN_B, t)
    log: list = []

    def on_metrics(step, m):
        log.append((time.perf_counter(), float(m["loss"]),
                    float(m["grad_norm"]), float(m["lr"]),
                    float(m["clip_scale"])))

    moe = (f", {cfg.attn_impl} attention, {cfg.first_dense} dense layer(s)"
           f" then {cfg.n_experts} experts top-{cfg.top_k}"
           f" ({cfg.n_shared_experts} shared) of d_ff {cfg.d_ff_expert}"
           if cfg.is_moe else arch_note(cfg))
    active = ("routed experts at top_k / n_experts, the embedding table"
              " not counted (a lookup), the head counted"
              if cfg.is_moe else "all (the tied embedding is the head)"
              if cfg.tie_embeddings else "all but the embedding table")
    print(f"[{tag}] {cfg.name} at full width: {cfg.n_layers}"
          f" layers, d {cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim},"
          f" {cfg.n_kv_heads} KV head, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          f" (tied {cfg.tie_embeddings}){moe}; {n_params} parameters"
          f" ({n_active} active a token: {active}),"
          f" {torch.cuda.memory_allocated() / 1e9:.3f} GB on the card;"
          f" {cfg.compute_dtype} compute, remat {run.remat!r}, B {TRAIN_B},"
          f" T {t}, lr {TRAIN_LR}, warmup {TRAIN_WARMUP}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_dispatch_count()
    t0 = time.perf_counter()
    res = loop.fit(cfg, run, iter(batches[:TRAIN_STEPS]), params=params,
                   steps=TRAIN_STEPS, device=dev, on_metrics=on_metrics)
    torch.cuda.synchronize()
    launches = launch_counts(ops)
    peak = torch.cuda.max_memory_allocated()
    check(not launches, f"the training path launched {launches}; it calls"
          " no kernel of the port")
    check(res.steps_run == TRAIN_STEPS == len(log),
          f"{res.steps_run} steps run, {len(log)} logged")
    losses = [e[1] for e in log]
    gnorms = [e[2] for e in log]
    check(all(map(math.isfinite, losses + gnorms)),
          f"non-finite losses {losses} or gradient norms {gnorms}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    ends = [t0] + [e[0] for e in log]
    step_s = [b - a for a, b in zip(ends, ends[1:])]
    steady = sum(step_s[1:]) / len(step_s[1:])
    tokens = TRAIN_B * t
    flops = 6 * n_active * tokens
    peak_flops = PEAK_FLOPS["bfloat16"]
    print(f"[{tag}] losses {[round(x, 4) for x in losses]}; gradient norms"
          f" {[round(x, 3) for x in gnorms]}; lr {[f'{e[3]:.2e}' for e in log]};"
          f" clip scale {[round(e[4], 4) for e in log]}")
    print(f"[{tag}] step s {[round(x, 6) for x in step_s]} (the first with"
          f" the warm-up); steady {steady * 1e3:.6f} ms a step,"
          f" {tokens / steady:.6f} tokens/s, 6 N tokens / s ="
          f" {flops / steady / 1e12:.6f} TFLOP/s,"
          f" {flops / steady / peak_flops:.6f} of the card's"
          f" {peak_flops / 1e12:.0f} TFLOP/s bf16 peak; peak memory"
          f" {peak / 1e9:.6f} GB (torch.cuda.max_memory_allocated); kernel"
          " launches of the port 0")

    # one more step, unprofiled (the memory held at its AdamW update:
    # the parameters, their gradients, the moments and the batch), then
    # one profiled
    opt = optimizer.init(params)
    step = ts.make_train_step(cfg, run)
    with memory_at_update() as at_update:
        step(params, opt, batches[TRAIN_STEPS])
    state = at_update[0] - base
    print(f"[{tag}] held at the AdamW update (parameters, gradients,"
          f" moments, batch): {state} B ({state / 1e9:.6f} GB above the"
          f" {base / 1e9:.6f} GB held before the phase); the fit's peak"
          f" {(peak - base) / 1e9:.6f} GB above it")
    out = dict(steady_ms=steady * 1e3, tokens_s=tokens / steady,
               tflops=flops / steady / 1e12, peak_gb=peak / 1e9,
               state_bytes=state, peak_above=peak - base,
               losses=losses, n_active=n_active, n_params=n_params,
               batches=batches, run=run)
    if not profile:
        return out
    pr = profiled_step(step, params, opt, batches[TRAIN_STEPS + 1])
    del opt
    prof, prof_wall, by_name, by_kind = (pr["prof"], pr["wall"],
                                         pr["by_name"], pr["by_kind"])
    n_kernels, busy, split, casts = (pr["n_kernels"], pr["busy"],
                                     pr["split"], pr["casts"])
    out.update(n_kernels=n_kernels, busy_ms=busy, casts=casts, split=split)
    print(f"[{tag}] the profiled step's kernel ms by part (its trace):"
          f" forward {split['forward']:.3f}, backward with the"
          f" recomputation {split['backward']:.3f}, gradient norm and AdamW"
          f" update {split['update']:.3f}; {sum(split.values()):.3f} ms of"
          f" the {busy:.3f} ms of kernels traced linked to an op")
    if not busy:
        print(f"[{tag}] profiler: no device time in the trace (not"
              " measured)")
    else:
        print(f"[{tag}] profile of one step: {n_kernels} kernels,"
              f" {busy:.3f} ms of kernels in {prof_wall * 1e3:.3f} ms of"
              f" wall with the profiler on ({busy / prof_wall / 1e3:.6f}"
              f" busy); against the steady step without the profiler"
              f" {busy / (steady * 1e3):.6f}")
        print(f"[{tag}] kernel time by kind: " + ", ".join(
            f"{k} {v:.3f} ms ({v / busy:.4f})" for k, v in sorted(
                by_kind.items(), key=lambda kv: -kv[1])))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            print(f"[{tag}]   {ms:10.3f} ms ({ms / busy:.4f} of kernel"
                  f" time)  {name}")
        rows = sorted(prof.key_averages(), key=lambda e: -getattr(
            e, "self_device_time_total", 0))[:12]
        for e in rows:
            ms = getattr(e, "self_device_time_total", 0) / 1e3
            print(f"[{tag}]   op {e.key}: {e.count} calls, {ms:.3f} ms of"
                  " kernels")
    for key, (count, ms) in casts.items():
        print(f"[{tag}] weight casts in the profiled step, {key}"
              f" ({'fp32 -> bf16' if key == 'forward' else 'bf16 -> fp32'}):"
              f" {count}, {ms:.6f} ms of kernels"
              f" ({ms / (steady * 1e3):.6f} of the steady step"
              + (f", {ms / busy:.6f} of its kernel time)" if busy else ")"))
    return out


def remat_phase(tm, pm, cfg) -> dict:
    """The three remat policies at REMAT_LAYERS layers of cfg's width and
    T = TRAIN_T: a step under each from the same weights and batch (loss
    and gradient norm within REMAT_TOL of "none"), then a second step,
    timed, and a third profiled; the peak memory of the first two."""
    import dataclasses

    import torch

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.train import optimizer, train_step as ts

    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(cfg, n_layers=REMAT_LAYERS)
    base = trainable_params(tm, pm, cfg, 1)
    b0, b1 = synthetic_batches(cfg, 2, TRAIN_B, TRAIN_T)
    out = {}
    for name in ("none", "dots", "full"):
        run = RunConfig(model=cfg, shape=ShapeConfig(
            "chip", TRAIN_T, TRAIN_B, "train"), learning_rate=TRAIN_LR,
            lr_warmup=TRAIN_WARMUP, remat=name)
        p = pm.tree_map(torch.clone, base)
        opt = optimizer.init(p)
        step = ts.make_train_step(cfg, run)
        # what the forward keeps for the backward pass: memory held after
        # the loss, before the gradients
        live = pm.tree_map(lambda x: x.detach().requires_grad_(), p)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        loss = tm.loss_fn(live, cfg, ts.to_device(b0, dev),
                          remat_policy=ts.remat_policy(name))
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - held
        del loss, live
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = torch.cuda.memory_allocated()
        p, opt, m = step(p, opt, b0)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, opt, m = step(p, opt, b1)
        float(m["loss"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        pr = profiled_step(step, p, opt, b0)
        busy, casts = pr["busy"], pr["casts"]
        cast_ms = casts["forward"][1] + casts["backward"][1]
        out[name] = dict(loss=loss, grad_norm=gnorm, peak_gb=peak / 1e9,
                         above_state_gb=(peak - state) / 1e9,
                         kept_gb=kept / 1e9, step_ms=sec * 1e3,
                         n_kernels=pr["n_kernels"], busy_ms=busy,
                         casts=casts, split=pr["split"])
        print(f"[remat] {name}: loss {loss!r}, gradient norm {gnorm!r};"
              f" kept for the backward pass {kept / 1e9:.6f} GB; peak"
              f" memory {peak / 1e9:.6f} GB ({(peak - state) / 1e9:.6f}"
              f" above the weights and AdamW state); second step"
              f" {sec * 1e3:.6f} ms")
        print(f"[remat] {name}, a third step profiled: {pr['n_kernels']}"
              f" kernels, {busy:.3f} ms of them ({busy / (sec * 1e3):.6f}"
              f" of the second step's wall); forward"
              f" {pr['split']['forward']:.3f}, backward"
              f" {pr['split']['backward']:.3f}, update"
              f" {pr['split']['update']:.3f} ms; weight casts"
              f" {casts['forward'][0]} + {casts['backward'][0]},"
              f" {cast_ms:.6f} ms ({cast_ms / (sec * 1e3):.6f} of the second"
              f" step, {cast_ms / busy if busy else 0.0:.6f} of its kernel"
              " time)")
        del pr
        del p, opt, m
    for name in ("dots", "full"):
        for key in ("loss", "grad_norm"):
            a, b = out[name][key], out["none"][key]
            check(math.isfinite(a) and abs(a - b) <= REMAT_TOL * abs(b),
                  f"remat {name!r} {key} {a} against 'none' {b}")
    print(f"[remat] {cfg.name} at {REMAT_LAYERS} layers of full width, T"
          f" {TRAIN_T}: loss and gradient norm of 'dots' and 'full' within"
          f" {REMAT_TOL} of 'none'")
    return out


def example_phase(tm, pm) -> dict:
    """The example's path (examples/torch_train_lm.py): its 100M model on
    the morph stream, the stemmer on the card, trained through fit with
    checkpoints, then resumed. Checks resumed_from, the checkpoint equal
    bit for bit to the trained weights, the resumed run's first loss that
    of those weights on its first batch, and a falling loss."""
    import importlib.util

    import torch

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.launch.train import batched
    from repro_torch.train import checkpoint, loop, optimizer
    from repro_torch.train import train_step as ts

    dev = torch.device(DEVICE)
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", Path(__file__).resolve().parent / "examples"
        / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = example.lm_100m()
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "ex", EXAMPLE_SEQ, EXAMPLE_BATCH, "train"), learning_rate=3e-3,
        lr_warmup=30, remat="none")
    first, last = EXAMPLE_STEPS
    t = time.perf_counter()
    pre = pipeline.MorphPreprocessor(device=dev)
    stream = batched(pipeline.morph_lm_batches(
        batch_words=4096, seq=EXAMPLE_SEQ, preproc=pre), EXAMPLE_BATCH)
    batches = [next(stream) for _ in range(last)]
    data_s = time.perf_counter() - t
    params = pm.init_params(tm.model_spec(cfg),
                            torch.Generator(dev).manual_seed(0), device=dev)
    with tempfile.TemporaryDirectory() as ckpt:
        t = time.perf_counter()
        r1 = loop.fit(cfg, run, iter(batches[:first]), params=params,
                      steps=first, ckpt_dir=ckpt,
                      ckpt_every=EXAMPLE_CKPT_EVERY, device=dev)
        fit_s = time.perf_counter() - t
        check(checkpoint.latest_step(ckpt) == first,
              f"latest step {checkpoint.latest_step(ckpt)}, want {first}")
        saved = checkpoint.restore(
            ckpt, first, {"params": params, "opt": optimizer.init(params)})
        same = all(torch.equal(a, b) for a, b in zip(
            pm.tree_leaves(saved["params"]), pm.tree_leaves(params)))
        check(same and int(saved["opt"].step) == first,
              "the checkpoint differs from the trained weights")
        with torch.no_grad():
            want0 = float(tm.loss_fn(params, cfg,
                                     ts.to_device(batches[first], dev)))
        other = pm.init_params(tm.model_spec(cfg),
                               torch.Generator(dev).manual_seed(1),
                               device=dev)
        r2 = loop.fit(cfg, run, iter(batches[first:]), params=other,
                      steps=last, ckpt_dir=ckpt,
                      ckpt_every=EXAMPLE_CKPT_EVERY, device=dev)
    check((r2.resumed_from, r2.steps_run, r2.final_step)
          == (first, last - first, last),
          f"resumed_from {r2.resumed_from}, {r2.steps_run} steps to"
          f" {r2.final_step}")
    check(abs(r2.losses[0] - want0) <= 1e-5 * abs(want0),
          f"the resumed run's first loss {r2.losses[0]}, the checkpointed"
          f" weights' {want0}")
    losses = r1.losses + r2.losses
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"the example's loss did not fall: {losses[0]} -> {losses[-1]}")
    print(f"[example] {cfg.name}: {pm.count_params(params)} parameters,"
          f" batch {EXAMPLE_BATCH} x {EXAMPLE_SEQ} of the morph stream"
          f" (stemmer on the card, {data_s:.3f} s for {last} batches);"
          f" {first} steps with checkpoints every {EXAMPLE_CKPT_EVERY} in"
          f" {fit_s:.3f} s, resumed from {r2.resumed_from} to"
          f" {r2.final_step}; the checkpoint equals the trained weights"
          f" bit for bit; the resumed first loss {r2.losses[0]!r} against"
          f" {want0!r} from the checkpointed weights; loss {losses[0]:.4f}"
          f" -> {losses[-1]:.4f}")
    return dict(fit_s=fit_s, first=losses[0], last=losses[-1])


def instance_registers(libs: dict) -> list:
    """Registers and spills of every kernel instance of the resident
    kernels (K1, K3 resident), K4 and K7/K8, from the build's -Xptxas -v
    log: one line each, its template arguments decoded."""
    resident = re.compile(r"resident_kernelILi(\d)ELb(\d)ELi(\d)ELb(\d)E")
    pats = {"stem_fused": resident, "stem_persistent": resident,
            "text_frontend": re.compile(r"text_frontend_kernelILi(\d+)E"),
            "dict_match": re.compile(
                r"dict_bank_kernel|dict_bsearch_kernelILi(\d)E")}

    def label(name, m):
        if name == "text_frontend":
            return f"K4, {m.group(1)} lanes a word"
        if name == "dict_match":
            if m.group(1) is None:
                return "K7, the banks"
            return f"K8, {('shared', 'global')[int(m.group(1))]} instance"
        match, shared, groups, split = m.groups()
        return (f"{('bsearch', 'bank')[int(match)]},"
                f" {('global', 'shared')[int(shared)]} tables,"
                f" {groups} groups,"
                f" {('one lane', 'G lanes')[int(split)]} a word")

    out = []
    for name, pat in pats.items():
        log = libs[name].with_suffix(".log")
        entry, spill = None, ""
        for line in log.read_text().splitlines() if log.exists() else []:
            if "Compiling entry function" in line:
                m = pat.search(line)
                entry = label(name, m) if m else None
            elif entry and "spill" in line:
                spill = line.strip()
            elif entry and "Used " in line:
                regs = line.split("Used ")[1].split(" registers")[0]
                out.append(f"{name}: {entry}: {regs} registers; {spill}")
                entry = None
    return out


def forced_k1(sf, lib, w, tables, block_b: int):
    """K1's launch through a measurement build that fixes its lanes a
    word (build.forced_lanes_library), as the wrapper makes it; counted
    nowhere."""
    import torch

    root = torch.empty((w.shape[0], 4), dtype=torch.int32, device=w.device)
    source = torch.empty((w.shape[0],), dtype=torch.int32, device=w.device)
    tri, quad, bi = tables
    err = lib.stem_fused_launch(
        w.data_ptr(), w.shape[0], tri.data_ptr(), tri.shape[0],
        quad.data_ptr(), quad.shape[0], bi.data_ptr(), bi.shape[0],
        root.data_ptr(), source.data_ptr(), block_b, 5,
        sf.MATCHES.index("bsearch"), int(sf.dict_in_shared(tables,
                                                            n_groups=5)),
        torch.cuda.current_stream(w.device).cuda_stream)
    check(err == 0, f"K1 measurement build: CUDA error {err}")
    return root, source


def forced_grid(lib) -> int:
    """Blocks the measurement build's last launch took."""
    import ctypes

    shape = [ctypes.c_int(0) for _ in range(3)]
    lib.stem_fused_last_shape(*(ctypes.byref(x) for x in shape))
    return shape[1].value


def forced_k4(lanes: int, tile, starts, lens, block_w: int = 128):
    """K4's launch through a measurement build that fixes its lanes a word
    (build.forced_text_lanes_library), as the wrapper makes it; counted
    nowhere."""
    import torch

    from repro_torch.core import textnorm as tn
    from repro_torch.kernels import build

    lib = build.forced_text_lanes_library(lanes)
    words = torch.empty((starts.shape[0], 16), dtype=torch.int32,
                        device=tile.device)
    lut, fw = tn.device_tables(tile.device)
    err = lib.text_frontend_launch(
        tile.data_ptr(), tile.shape[0], starts.data_ptr(), lens.data_ptr(),
        starts.shape[0], lut.data_ptr(), fw.data_ptr(), fw.shape[0],
        words.data_ptr(), block_w,
        torch.cuda.current_stream(tile.device).cuda_stream)
    check(err == 0, f"K4 measurement build at {lanes} lanes: CUDA error"
          f" {err}")
    return words


def request_tile(tn, docs):
    """The codepoint tile of one served text request: its documents
    coalesced, zero-padded to the text workload's char block doubled until
    it holds them."""
    import numpy as np

    chars, _, _ = tn.coalesce_docs(docs)
    tile = np.zeros(TEXT_CHAR_BLOCK, np.int32)
    while tile.shape[0] < chars.shape[0]:
        tile = np.zeros(2 * tile.shape[0], np.int32)
    tile[:chars.shape[0]] = chars
    return tile


def bsearch_shape(lib) -> str:
    """The instance, threads, blocks and tree step of the last K8 launch."""
    import ctypes

    shape = [ctypes.c_int(0) for _ in range(4)]
    lib.dict_bsearch_last_shape(*(ctypes.byref(x) for x in shape))
    inst, threads, grid, log2s = (x.value for x in shape)
    return (f"instance {('shared', 'global')[inst]}, {grid} blocks of"
            f" {threads} threads, a tree of every {1 << log2s}th entry")


def bound(n_bytes: int, n_ops: int) -> dict:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                n_bytes=n_bytes, n_ops=n_ops)


def _probes(sf, hits, valid, steps: dict) -> int:
    """Probes of a sorted search, every valid slot up to the word's first
    hit, steps[table] + 1 each."""
    import torch

    slot = torch.arange(30, device=hits.device)
    first = torch.where(hits.any(1), hits.to(torch.int8).argmax(1), 30)
    tried = valid & (slot[None, :] <= first[:, None])
    per_slot = torch.tensor([steps[sf.GROUP_DICTS[g]] + 1
                             for g in range(5) for _ in range(6)],
                            device=hits.device)
    return int((tried * per_slot).sum())


def resident_probes(sf, w, tables, *, steps) -> int:
    """Bisection probes the resident kernels make on these words: every
    valid slot up to the word's first hit, ceil(log2 Rp) + 1 each."""
    keys, valid = sf._candidates(w, 5)
    hits = sf._resident_hits(keys, valid, dict(zip(sf.DICT_NAMES, tables)),
                             n_groups=5, match="bsearch")
    return _probes(sf, hits, valid, steps)


def search_stats(sf, w, tables) -> str:
    """How long the resident search chain is on these words: live slots a
    word, slots searched up to the first hit, and the share of found words
    whose first hit is their first live slot."""
    import torch

    keys, valid = sf._candidates(w, 5)
    hits = sf._resident_hits(keys, valid, dict(zip(sf.DICT_NAMES, tables)),
                             n_groups=5, match="bsearch")
    slot = torch.arange(30, device=w.device)
    found = hits.any(1)
    first = torch.where(found, hits.to(torch.int8).argmax(1), 30)
    searched = (valid & (slot[None, :] <= first[:, None])).sum(1)
    rank0 = ((valid & (slot[None, :] < first[:, None])).sum(1) == 0)[found]
    live = valid.sum(1)
    return (f"{float(live.float().mean()):.6f} live slots a word (at most"
            f" {int(live.max())}), {float(searched.float().mean()):.6f}"
            f" searched (at most {int(searched.max())}), first hit on the"
            f" first live slot for {float(rank0.float().mean()):.6f} of"
            " found words")


def streamed_probes(sf, w, tiles) -> int:
    """Probes a sorted search of the stream needs on these words, whatever
    searches it: every valid slot up to the word's first hit, ceil(log2
    n) + 1 each, n the entries of its table's part of the stream. (The
    kernels' own search, a bisection of the fences and of an F-entry
    segment, then one 8-entry block, takes about as many.)"""
    keys, valid = sf._candidates(w, 5)
    hits = sf._fence_hits(keys, valid, tiles, n_groups=5)
    tile_n = tiles.dict_block_r * 128
    steps = {name: (c * tile_n - 1).bit_length()
             for name, c in zip(sf.DICT_NAMES, tiles.counts)}
    return _probes(sf, hits, valid, steps)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import index as ix
    from repro_torch.core import accuracy, corpus, stemmer
    from repro_torch.core import textnorm as tn
    from repro_torch.kernels import build, ops
    from repro_torch.configs.paper import PRESETS
    from repro_torch.kernels import postings as pk
    from repro_torch.kernels import stem_datapath as sdp
    from repro_torch.kernels import stem_fused as sf
    from repro_torch.kernels import stem_match as sm
    from repro_torch.kernels import text_frontend as tf
    from repro_torch.launch.serve import build_documents, edge_documents
    from repro_torch import configs, serve
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as ta
    from repro_torch.models import layers as tl
    from repro_torch.models import model as tm
    from repro_torch.models import params as pm

    dev = torch.device(DEVICE)
    t_all = time.perf_counter()
    laps = [t_all]

    def lap(name: str) -> None:
        """Seconds the phase that just ended took, and the run so far."""
        now = time.perf_counter()
        print(f"[lap] {name}: {now - laps[-1]:.1f} s (run {now - t_all:.1f}"
              " s)")
        laps.append(now)

    # ---- 1. card ---------------------------------------------------------
    card = card_line()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}"
          f" python {sys.version.split()[0]}")
    # fp32 matrix products and convolutions in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[card] TF32 off for fp32 matrix products and convolutions")

    # ---- 2. build --------------------------------------------------------
    build_s, libs = build.build_cuda(forced_lanes=FORCED_LANES,
                                     forced_text_lanes=build.TEXT_LANES)
    print(f"[build] {len(libs)} kernel libraries built in {build_s:.1f} s")
    # phase 11's dry run, on the host's CPU beside the phases to come
    dry = start_dryrun()
    for name, path in libs.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs = [int(x.split("Used ")[1].split(" registers")[0])
                for x in lines if "Used " in x and " registers" in x]
        spills = sorted({x.strip() for x in lines if "spill" in x
                         and any(int(n) for n in re.findall(
                             r"(\d+) bytes spill", x))})
        print(f"[build] {name}: {len(regs)} kernel instances,"
              f" {min(regs, default=0)}-{max(regs, default=0)} registers;"
              f" spills: {spills or 'none'}")

    realistic = stemmer.RootDictArrays.from_rootdict(
        corpus.build_dictionary(), device=dev)
    grown60k = corpus.grow_root_arrays(realistic, 60_000)
    grown = corpus.grow_root_arrays(realistic, GROWN_KEYS)
    grown_fences = corpus.grow_root_arrays(realistic, FENCE_KEYS)
    check(sf.choose_residency(grown) == "streamed",
          "the 262,144-key dictionary must stream under residency='auto'")
    words_np = next(corpus.stream_corpus_words(
        max(K1_BATCHES), seed=0, chunk_words=max(K1_BATCHES))).words
    words = torch.from_numpy(words_np).to(dev)

    lap("card, build and inputs")

    # ---- 3-5. kernels against their plain versions -----------------------
    k1_err = k1_phase(sf, ops, realistic, grown60k, words)
    streamed_dicts = (("realistic", realistic), ("grown", grown),
                      ("grown past the fence budget", grown_fences))
    k2_err = k2_phase(sf, sm, ops, streamed_dicts, words)
    k3_err = k3_phase(sf, sm, ops, (("realistic", realistic),
                                    ("grown", grown60k)),
                      streamed_dicts, words)
    del grown_fences

    lap("K1-K3 parity")

    # ---- 5b-5c. the text front end and the postings kernel ---------------
    table = corpus.build_token_table()
    doc_chunks = list(corpus.stream_corpus_docs(
        INDEX_WORDS, seed=0, chunk_words=INDEX_CHUNK,
        words_per_doc=INDEX_WORDS_PER_DOC, table=table))
    big_chars, _, _ = tn.coalesce_docs([d for _, ds in doc_chunks
                                        for d in ds])
    # the tile build_root_index_text gives K4 for the index's first chunk
    chunk_tile = torch.from_numpy(tn.coalesce_docs(doc_chunks[0][1])[0]
                                  ).to(dev)
    big_tile = torch.from_numpy(big_chars).to(dev)
    big_words = torch.from_numpy(np.concatenate([
        c.words for c in corpus.stream_corpus_words(
            INDEX_WORDS, seed=0, chunk_words=INDEX_CHUNK,
            words_per_doc=INDEX_WORDS_PER_DOC, table=table)])).to(dev)
    k4_err = k4_phase(tf, tn, build,
                      edge_documents() + build_documents(64, 256, seed=3),
                      chunk_tile, big_tile, big_words)
    vocab = ix.build_vocab(realistic)
    vocab_t = torch.from_numpy(vocab).to(dev)
    real_ids = ops._root_ids(*sf.stem_fused(big_words, realistic,
                                            block_b=INDEX_BLOCK), vocab_t)
    # the 262,144-key dictionary's vocabulary takes K5's sliced instance
    grown_vocab = ix.build_vocab(grown)
    grown_ids = ops._root_ids(
        *sf.stem_fused(big_words[:INDEX_CHUNK], grown, block_b=INDEX_BLOCK),
        torch.from_numpy(grown_vocab).to(dev))
    k5_err, k5_checked = k5_phase(pk, real_ids, len(vocab), grown_ids,
                                  len(grown_vocab))

    lap("K4-K5 parity")

    # ---- 5f. the staged Compare path's kernels ---------------------------
    k6_err = k6_phase(sdp, ops, words)
    cand = sdp.stem_datapath_cuda(words[:max(K6_BATCHES)])[0][:, :30].reshape(
        -1).contiguous()
    placeholder = torch.tensor([-1], dtype=torch.int32, device=dev)
    unpadded = torch.unique(cand)[:1024].contiguous()
    # larger than a block's shared memory: the grown quad table (243,614
    # keys, 974 KB) in a seeded order
    g7 = torch.Generator(dev).manual_seed(7)
    shuffled = grown.quad[torch.randperm(grown.quad.shape[0], generator=g7,
                                         device=dev)].contiguous()
    # and keys in the adversarial table's bank: its 2000 entries, 2000 not
    k7_err = k7_phase(sm, torch.cat([cand, one_bank_table(sm, 4000, dev)]),
                      (("realistic tri", realistic.tri),
                                 ("realistic bi", realistic.bi),
                                 ("1024-entry table", unpadded),
                                 ("placeholder [-1]", placeholder),
                                 ("grown quad, shuffled", shuffled),
                                 ("one bank (adversarial)",
                                  one_bank_table(sm, 2000, dev))))
    k8_err = k8_phase(sm, build, cand, (
        ("realistic tri", realistic.tri), ("realistic quad", realistic.quad),
        ("realistic bi", realistic.bi),
        ("32,768-entry table", torch.unique(torch.cat(
            [grown.tri, grown.quad]))[:32768].contiguous()),
        ("grown tri", grown.tri), ("grown quad", grown.quad),
        ("placeholder [-1]", placeholder)))

    lap("K6-K8 parity")

    # ---- 6. serve --------------------------------------------------------
    serve_words = np.concatenate([c.words for c in corpus.stream_corpus_words(
        SERVE_WORDS, seed=0, chunk_words=65536)])

    def plain_stemmer(arrays):
        r, s = stemmer.extract_roots(serve_words, arrays, backend="sorted",
                                     device=dev)
        return r.cpu().numpy(), s.cpu().numpy()

    want_real, want_grown = plain_stemmer(realistic), plain_stemmer(grown)
    k1_launches, k1_serve_s = serve_phase(
        "resident (K1)", ops, sf, realistic, serve_words, want_real,
        persistent=False)
    k3s_launches, k3s_serve_s = serve_phase(
        "persistent, 262,144-key dict (K3 streamed)", ops, sf, grown,
        serve_words, want_grown, persistent=True,
        store_kw=dict(dict_block_r=8))
    k3r_launches, k3r_serve_s = serve_phase(
        "persistent, realistic dict (K3 resident)", ops, sf, realistic,
        serve_words, want_real, persistent=True)
    check(set(k1_launches) == {"stem_fused_cuda"}
          and set(k3s_launches) == {"persistent_streamed_cuda"}
          and set(k3r_launches) == {"persistent_resident_cuda"},
          "each serve run must go through its own kernel only")
    # the resident serves again in the other order: the spread of the
    # host-bound serve rate within this run
    for label, persistent in (("persistent, realistic dict (K3 resident),"
                               " again", True),
                              ("resident (K1), again", False)):
        serve_phase(label, ops, sf, realistic, serve_words, want_real,
                    persistent=persistent)
    found = float((want_grown[1] > 0).mean())
    print(f"[serve] root found for {found:.4f} of words on the 262,144-key"
          f" dictionary, {float((want_real[1] > 0).mean()):.4f} on the"
          " realistic one")

    lap("serve")

    # ---- 6b. faults ------------------------------------------------------
    fault_launches = fault_serve_phase(ops, sf, realistic, serve_words,
                                       want_real)
    ladder_launches = ladder_phase(ops, sf, realistic, serve_words,
                                   want_real)
    with tempfile.TemporaryDirectory() as workdir:
        restart_phase(sf, realistic, serve_words, want_real, workdir)
        rates = {}
        for journaled in (False, True, False, True):
            label = ("persistent, realistic dict (K3 resident), "
                     + ("journaled" if journaled else "no journal"))
            _, sec = serve_phase(label, ops, sf, realistic, serve_words,
                                 want_real, persistent=True,
                                 journal_dir=workdir if journaled else None)
            rates.setdefault(journaled, []).append(SERVE_WORDS / sec)
    mapped_flags_phase(sf, realistic, serve_words)
    print(f"[faults] fault-free persistent serve, words/s: without the"
          f" journal {rates[False]}, with it {rates[True]} (phase 6:"
          f" {SERVE_WORDS / k3r_serve_s:.0f}); {card_line()}")
    check(set(fault_launches) == {"persistent_resident_cuda",
                                  "stem_fused_cuda"}
          and {"persistent_resident_cuda", "stem_fused_cuda",
               "stem_streamed_cuda"} <= set(ladder_launches),
          "phase 6b must run K3 resident, K1 and K2")

    lap("faults")

    # ---- 7. extract_roots through K2 -------------------------------------
    stemmer.extract_roots(serve_words, grown, backend="fused",
                          device=dev)       # warm-up: allocations at size
    torch.cuda.synchronize()
    ops.reset_dispatch_count()
    t = time.perf_counter()
    got_r, got_s = stemmer.extract_roots(serve_words, grown, backend="fused",
                                         device=dev)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t
    k2_launches = wrapper(sf, "stem_streamed_cuda").launches
    planned = sf.planned_launches(SERVE_WORDS, grown)
    check(k2_launches == ops.dispatch_count() == planned > 0,
          f"extract_roots: {k2_launches} K2 launches of"
          f" {ops.dispatch_count()}, planned {planned}")
    check(np.array_equal(got_r.cpu().numpy(), want_grown[0])
          and np.array_equal(got_s.cpu().numpy(), want_grown[1]),
          "extract_roots(backend='fused') differs from the plain stemmer")
    print(f"[extract] {SERVE_WORDS} words through extract_roots(backend="
          f"'fused') on the 262,144-key dictionary in {extract_s:.6f} s"
          f" ({SERVE_WORDS / extract_s:.0f} words/s, {k2_launches} K2"
          f" launches = planned {planned}), equal to the plain stemmer")

    lap("extract")

    # ---- 7b. the corpus index, words and text --------------------------
    k5_launches, k5_inst, index_s, index_text_s, index_1m = index_phase(
        ops, pk, ix, corpus, tn, realistic, table)
    k5_grown_inst, index_grown_s = index_grown_phase(ops, pk, sf, ix, corpus,
                                                     grown, table)

    lap("index")

    # ---- 12. several devices: the sharded paths on meshes of the card ----
    devices = devices_phase(
        ops, sf, pk, ix, corpus, stemmer, realistic, grown, serve_words,
        {"realistic": want_real, "grown": want_grown}, table, index_1m)
    print(f"[devices] words/s: shard_batch at 1 / 4 shards,"
          f" realistic {devices['rates'][('realistic', '1 shard')]:.0f} /"
          f" {devices['rates'][('realistic', '4 shards')]:.0f}, 262,144"
          f" keys {devices['rates'][('grown', '1 shard')]:.0f} /"
          f" {devices['rates'][('grown', '4 shards')]:.0f}; the served"
          f" words at 4 shards {devices['rates']['serve, 4 shards']:.0f}"
          f" beside phase 6's unsharded {SERVE_WORDS / k1_serve_s:.0f};"
          f" the index at 4 shards {devices['rates']['index, 4 shards']:.0f}"
          f" beside 7b's {INDEX_WORDS / index_s:.0f}; 4 shards on one GPU,"
          f" not 4 GPUs; {card_line()}")

    lap("several devices")

    # ---- 13. the examples on the card -------------------------------------
    examples_phase(ops)

    lap("examples")

    # ---- 7c. text serving -------------------------------------------------
    text_docs = build_documents(TEXT_REQUESTS * TEXT_DOCS_PER_REQUEST,
                                TEXT_WORDS_PER_DOC)
    text_runs = {}
    for persistent in (False, True):
        text_runs[persistent] = text_serve_phase(
            ops, stemmer, tn, realistic, text_docs,
            persistent=persistent)

    lap("text serving")

    # ---- 7d. the staged Compare path and the three execution models -------
    staged_words = torch.from_numpy(serve_words).to(dev)
    fused_out = stemmer.extract_roots(staged_words, realistic,
                                      backend="fused", device=dev)
    sorted_ext = stemmer.extract_roots(staged_words, realistic,
                                       backend="sorted", extended=True,
                                       device=dev)
    staged = staged_phase(ops, stemmer, realistic, staged_words, fused_out,
                          sorted_ext)
    for name in PRESETS:
        cfg = PRESETS[name]
        check((cfg.dict_tri, cfg.dict_quad) == (2000, 200),
              f"preset {name} is not the realistic dictionary")
    rates = models_phase(ops, stemmer, PRESETS, realistic, staged_words,
                         fused_out)
    fused_call = lambda: ops.extract_roots_fused(  # noqa: E731
        staged_words, realistic, match="bsearch", device=dev)
    multi_call = lambda: ops.extract_roots_multilaunch(  # noqa: E731
        staged_words, realistic, device=dev)
    fused_wall, multi_wall = call_ms(fused_call, 10), call_ms(multi_call, 10)
    profile_kernels("staged", "extract_roots_multilaunch calls (1M words)",
                    lambda i: multi_call(), 2)
    print(f"[models] fused_vs_multilaunch: {multi_wall / fused_wall:.3f}x"
          f" (extract_roots_fused, bsearch, {fused_wall:.6f} ms a call;"
          f" extract_roots_multilaunch {multi_wall:.6f} ms a call;"
          f" {staged_words.shape[0]} words, wall with a sync; reported, not"
          " claimed)")

    lap("staged path and execution models")

    # ---- 8. accuracy -----------------------------------------------------
    for backend in ("fused", "pallas"):
        t6 = accuracy.table6(n_words=2000, seed=0, backend=backend,
                             device=dev)
        rw = t6["with_infix"].root_recall
        ro = t6["without_infix"].root_recall
        print(f"[accuracy] table6 root recall (backend {backend!r}) with"
              f" infix {rw!r}, without {ro!r}")
        check(rw == RECALL_WITH_INFIX and ro == RECALL_WITHOUT_INFIX,
              f"table6 recall (backend {backend!r}) differs from the"
              " reference")

    lap("accuracy")

    # ---- 8b. K9 against its plain version --------------------------------
    k9_err = k9_phase(fa)

    lap("K9 parity")

    # ---- 8c. the dense LM path at full width -----------------------------
    lm_cfg = configs.get_config(LM_ARCH)
    lm_params = pm.init_params(tm.model_spec(lm_cfg),
                               torch.Generator(dev).manual_seed(0),
                               device=dev)
    print(f"[lm] {LM_ARCH} at full width: {pm.count_params(lm_params)}"
          f" parameters, {torch.cuda.memory_allocated() / 1e9:.3f} GB on"
          " the card")
    k9_launches, k9_inputs = lm_attention_phase(ops, fa, ta, tl, tm, lm_cfg,
                                                lm_params)
    lap("K9 on the LM's attention")
    lm_run = lm_serve_phase(ops, serve, tm, pm, lm_cfg, lm_params)
    print(f"[lm] peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          " GB")
    del lm_params
    torch.cuda.empty_cache()

    lap("LM serving")

    # ---- 8d. the MoE families: deepseek-v2-lite-16b, qwen3-moe ----------
    moe_runs = moe_serve_phase(ops, serve, tm, pm, configs)
    lap("MoE and MLA serving")

    # ---- 8e, 8e', 8f. Mamba, Hymba and the VLM at full width and depth --
    ssm_runs = ssm_serve_phase(ops, serve, tm, pm, configs)
    lap("Mamba, Hymba and VLM serving")

    # ---- 8g. the audio family: musicgen-medium at full width and depth --
    audio_serve = audio_serve_phase(ops, serve, tm, pm, configs)
    lap("audio serving")

    # ---- 10. training: gemma-2b at full width and depth -----------------
    train_cfg = configs.get_config(TRAIN_ARCH)
    train_run = train_phase(ops, tm, pm, train_cfg)
    torch.cuda.empty_cache()
    lap("training at full width")
    remat_runs = remat_phase(tm, pm, train_cfg)
    torch.cuda.empty_cache()
    lap("remat policies")
    example_run = example_phase(tm, pm)
    lap("the example's path with checkpoints")
    moe_train = moe_train_phase(ops, tm, pm, configs)
    lap("MoE and MLA training at full width")
    ssm_train = ssm_train_phase(ops, tm, pm, configs)
    lap("Mamba, Hymba and VLM training at full width")
    audio_train = audio_train_phase(ops, tm, pm, configs)
    lap("audio training at full width")

    # ---- 11. the dry run, and its predictions against the card ----------
    dry_run = dryrun_phase(dry, configs, train_run, remat_runs, audio_train)
    lap("dry run")

    # ---- 9. times --------------------------------------------------------
    real_tables = sf.padded_tables(realistic, match="bsearch", infix=True)
    table_bytes = 4 * sum(int(t.shape[0]) for t in real_tables)
    steps = {name: max(1, int(t.shape[0]) - 1).bit_length()
             for name, t in zip(sf.DICT_NAMES, real_tables)}
    tiles = sm.build_dict_tiles(grown.tri, grown.quad, grown.bi, 8)
    stream_bytes = 4 * tiles.stream.numel()
    print(f"[times] the 262,144-key dictionary's stream: {tiles.n_tiles}"
          f" tiles of 8 rows, {stream_bytes} B; fence level every"
          f" {tiles.fence_step}th entry, {4 * tiles.fences.numel()} B in"
          " shared memory")
    times = {}
    # the launch floor: a one-element op on the same stream, same timer
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_fn = lambda: one.add_(1)  # noqa: E731
    floor_ms = device_ms(floor_fn, 200, call_ms(floor_fn, 200))
    print(f"[times] launch floor: a one-element torch op takes"
          f" {floor_ms:.6f} ms on the card (CUDA events, the same timer)")
    for line in instance_registers(libs):
        print(f"[times] registers, {line}")
    for b in (SERVE_REQUEST_WORDS, SERVE_WORDS):
        w = torch.from_numpy(serve_words[:b]).to(dev)
        bt = b // BLOCK_B
        n_k = 200 if b == SERVE_REQUEST_WORDS else 10
        n_p = 10 if b == SERVE_REQUEST_WORDS else 2
        zeros = torch.zeros(bt, dtype=torch.int32, device=dev)
        res_desc = sf._descriptors(bt, BLOCK_B, zeros, 0)
        stats = sf.tile_visit_stats(w, grown, block_b=BLOCK_B)
        skern = dict(n_groups=5, match="bsearch")
        rkern = dict(n_groups=5, match="bsearch", block_b=BLOCK_B)
        runs = {
            "K1": (lambda: sf.stem_fused_cuda(w, real_tables, **rkern),
                   lambda: sf.stem_fused_plain(w, real_tables, **rkern)),
            "K2": (lambda: sf.stem_streamed_cuda(w, tiles, **skern),
                   lambda: sf.stem_streamed_plain(w, tiles, **skern)),
            "K3 resident": (
                lambda: sf.persistent_resident_cuda(w, real_tables, res_desc,
                                                    **rkern),
                lambda: sf.persistent_resident_plain(w, real_tables, res_desc,
                                                     **rkern)),
            "K3 streamed": (
                lambda: sf.persistent_streamed_cuda(w, tiles, res_desc,
                                                    block_b=BLOCK_B, **skern),
                lambda: sf.persistent_streamed_plain(
                    w, tiles, res_desc, block_b=BLOCK_B, **skern)),
        }
        # K3 as the serving ring launches it: its flags into host-mapped
        # memory (the same kernel; a system-scope fence before each item's
        # flag stores either way)
        mapped = sf.MappedFlags(bt, dev)
        runs["K3 resident, mapped flags"] = (
            lambda: sf.persistent_resident_cuda(w, real_tables, res_desc,
                                                flags_out=mapped, **rkern),
            runs["K3 resident"][1])
        runs["K3 streamed, mapped flags"] = (
            lambda: sf.persistent_streamed_cuda(w, tiles, res_desc,
                                                block_b=BLOCK_B,
                                                flags_out=mapped, **skern),
            runs["K3 streamed"][1])
        res_probes = resident_probes(sf, w, real_tables, steps=steps)
        str_probes = streamed_probes(sf, w, tiles)
        # bytes: words in and outputs out once, the tables once (the
        # resident tables, and the ~1 MB stream, stay in the 50 MB L2); the
        # persistent kernels also read descriptors and write flags
        n_ops_res = b * DATAPATH_OPS_PER_WORD + res_probes * OPS_PER_PROBE
        n_ops_str = b * DATAPATH_OPS_PER_WORD + str_probes * OPS_PER_PROBE
        bounds = {
            "K1": bound(b * WORD_BYTES + table_bytes, n_ops_res),
            "K2": bound(b * WORD_BYTES + stream_bytes, n_ops_str),
            "K3 resident": bound(b * WORD_BYTES + table_bytes + 16 * bt,
                                 n_ops_res),
            "K3 streamed": bound(b * WORD_BYTES + stream_bytes + 16 * bt,
                                 n_ops_str),
        }
        bounds["K3 resident, mapped flags"] = bounds["K3 resident"]
        bounds["K3 streamed, mapped flags"] = bounds["K3 streamed"]
        for name, (kernel, plain) in runs.items():
            got = kernel()
            torch.cuda.synchronize()        # mapped flags: read after it
            check(same(tuple(t.to(dev) for t in got), plain()) == 0,
                  f"timed shape B={b}: {name} differs from its plain version")
            k_call = call_ms(kernel, n_k)
            ms = device_ms(kernel, n_k, k_call)
            # the plain versions issue hundreds of small kernels a call,
            # more than the launch queue holds behind a spacer: their time
            # is the wall time per call
            plain_ms = call_ms(plain, n_p)
            times[(name, b)] = dict(ms=ms, call_ms=k_call, plain_ms=plain_ms,
                                    **bounds[name])
            bd = bounds[name]
            extra = ""
            if name.startswith("K3"):
                grid = wrapper(sf, "persistent_resident_cuda" if "resident"
                               in name else "persistent_streamed_cuda"
                               ).last_grid
                extra = f", {grid} blocks for {bt} descriptors"
            if name in ("K1", "K3 resident"):
                fn = wrapper(sf, "stem_fused_cuda" if name == "K1"
                             else "persistent_resident_cuda")
                extra = (f", {fn.last_lanes} lanes a word, {fn.last_grid}"
                         f" blocks for {bt} tiles")
            if name == "K2":
                extra = (f", {wrapper(sf, 'stem_streamed_cuda').last_grid}"
                         " blocks")
            print(f"[times] {name} B={b}: {ms:.6f} ms on the card"
                  f" ({k_call:.6f} ms a call with the host{extra}), plain"
                  f" {plain_ms:.6f} ms a call, bound {bd['bound_ms']:.6f} ms"
                  f" by {bd['bound_by']} ({bd['n_bytes']} B,"
                  f" {bd['n_ops']} int32 ops)")
        # the reference's visit pre-pass (stages 1-4 in plain PyTorch, then
        # the visit tables), which only the plain walk the tests hold to the
        # reference runs: neither path of the port does
        prepass_ms = call_ms(lambda: visit_tables(sf, w, tiles, infix=True),
                             n_p)
        print(f"[times] B={b}: the reference's visit pre-pass, in plain"
              f" PyTorch on the card, takes {prepass_ms:.6f} ms a call"
              f" (wall) for {stats['visited']} tile visits of a full sweep's"
              f" {stats['full_sweep']} ({stats['batch_tiles']} batch tiles x"
              f" {stats['dict_tiles']} dictionary tiles of 8 rows); the"
              " port's streamed path runs no pre-pass")
        print(f"[times] B={b}: resident probes {res_probes}, streamed probes"
              f" {str_probes}; no single PyTorch call computes these"
              " functions, so library_ms is null")
        print(f"[times] B={b}, the resident search:"
              f" {search_stats(sf, w, real_tables)}")
        # the resident kernels' bank instance (a linear scan of the padded
        # table a searched slot), and at the serve shape each lane count
        # the launchers could take, forced (the answers do not change)
        bank_tables = sf.padded_tables(realistic, match="bank", infix=True)
        bkern = dict(n_groups=5, match="bank", block_b=BLOCK_B)
        for name, kernel in (
                ("K1", lambda: sf.stem_fused_cuda(w, bank_tables, **bkern)),
                ("K3 resident", lambda: sf.persistent_resident_cuda(
                    w, bank_tables, res_desc, **bkern))):
            plain = (sf.stem_fused_plain(w, bank_tables, **bkern)
                     if name == "K1" else
                     sf.persistent_resident_plain(w, bank_tables, res_desc,
                                                  **bkern))
            check(same(kernel(), plain) == 0,
                  f"timed shape B={b}: {name} (bank) differs from its plain"
                  " version")
            ms = device_ms(kernel, n_k, call_ms(kernel, n_k))
            times[(name + " bank", b)] = dict(ms=ms)
            print(f"[times] {name} bank instance B={b}: {ms:.6f} ms on the"
                  f" card (a {bank_tables[0].numel()}-entry tri table scanned"
                  " a searched tri slot)")

    # K1 at the serve shape and as the index builds launch it, at the lane
    # count the rule picks and at each count through measurement builds
    # that fix it (the answers do not change)
    for b, block_b in ((SERVE_REQUEST_WORDS, BLOCK_B),
                       (INDEX_CHUNK, INDEX_BLOCK)):
        w = torch.from_numpy(serve_words[:b]).to(dev)
        rkern = dict(n_groups=5, match="bsearch", block_b=block_b)
        want = sf.stem_fused_plain(w, real_tables, **rkern)
        n_k = 200 if b == SERVE_REQUEST_WORDS else 50
        kernel = lambda: sf.stem_fused_cuda(w, real_tables, **rkern)  # noqa
        check(same(kernel(), want) == 0, f"K1 B={b} block_b={block_b}"
              " differs from its plain version")
        ms = device_ms(kernel, n_k, call_ms(kernel, n_k))
        fn = sf.stem_fused_cuda
        if b == INDEX_CHUNK:
            times[("K1", "index chunk")] = dict(ms=ms)
        row = [f"the rule's {fn.last_lanes} ({fn.last_grid} blocks)"
               f" {ms:.6f} ms"]
        for lanes in FORCED_LANES:
            lib = build.forced_lanes_library(lanes)
            forced = lambda: forced_k1(sf, lib, w, real_tables,  # noqa
                                       block_b)
            check(same(forced(), want) == 0, f"K1 B={b} block_b={block_b}"
                  f" at {lanes} lanes differs from its plain version")
            ms = device_ms(forced, n_k, call_ms(forced, n_k))
            row.append(f"{lanes} ({forced_grid(lib)} blocks) {ms:.6f} ms")
        print(f"[times] K1 B={b} block_b={block_b} by lanes a word: "
              + ", ".join(row))

    # K4 at a served request's tile and at the 1M-word tile, by the rule
    # and at each lane count through the measurement builds (the answers
    # do not change); K5 at an index chunk and at 1M words, with
    # torch.sort of the same keys beside it
    req_tile = request_tile(tn, text_docs[:TEXT_DOCS_PER_REQUEST])
    for label, tile in (("request", torch.from_numpy(req_tile).to(dev)),
                        ("1M words", big_tile)):
        geo = tn.segment_geometry(tile, block_w=128)
        rows = geo.starts.shape[0]
        n = int(geo.n_words)
        live = geo.lens.clamp(max=tn.MAX_RAW)
        n_chars = int(live.sum())
        kernel = lambda: tf.text_frontend_cuda(tile, geo.starts, geo.lens)
        plain = lambda: tf.text_frontend_plain(tile, geo.starts, geo.lens)
        want = plain()
        check(same((kernel(),), (want,)) == 0,
              f"timed tile {label}: K4 differs from its plain version")
        n_k = 200 if label == "request" else 10
        k_call = call_ms(kernel, n_k)
        ms = device_ms(kernel, n_k, k_call)
        rule = (tf.text_frontend_cuda.last_lanes,
                tf.text_frontend_cuda.last_grid)
        plain_ms = call_ms(plain, 10 if label == "request" else 2)
        bd = bound(4 * tile.shape[0] + 8 * rows + 64 * rows,
                   K4_OPS_PER_CHAR * n_chars + K4_OPS_PER_WORD * n
                   + K4_OPS_PER_EMPTY_ROW * (rows - n))
        times[("K4", label)] = dict(ms=ms, call_ms=k_call, plain_ms=plain_ms,
                                    library_ms=None, **bd)
        by_lanes = []
        for lanes in build.TEXT_LANES:
            forced = lambda: forced_k4(lanes, tile, geo.starts,  # noqa
                                       geo.lens)
            check(same((forced(),), (want,)) == 0, f"timed tile {label}: K4"
                  f" at {lanes} lanes differs from its plain version")
            f_ms = device_ms(forced, n_k, call_ms(forced, n_k))
            by_lanes.append(f"{lanes} {f_ms:.6f}")
        print(f"[times] K4 {label} tile ({tile.shape[0]} codepoints, {n}"
              f" words, {rows} rows): {ms:.6f} ms on the card at the rule's"
              f" {rule[0]} lanes a word, {rule[1]} blocks ({k_call:.6f} ms a"
              f" call with the host), plain {plain_ms:.6f} ms a call, bound"
              f" {bd['bound_ms']:.6f} ms by {bd['bound_by']} ({bd['n_bytes']}"
              f" B, {bd['n_ops']} int32 ops): {bd['bound_ms'] / ms:.6f} of"
              " the bound; no single PyTorch call computes it, library_ms"
              " null; by lanes a word (measurement builds), ms: "
              + ", ".join(by_lanes))
    # K4's lane rule on either side of its threshold (SMs x 1024 rows:
    # 135,168 on 132 SMs): prefixes of the 1M-word tile and an index
    # chunk's tile at both lane counts through the measurement builds
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, tile in ([(f"{c} codepoints", big_tile[:c]) for c in
                         (150_000, 262_144, 280_000, 400_000)]
                        + [("index chunk", chunk_tile)]):
        geo = tn.segment_geometry(tile, block_w=128)
        rows = geo.starts.shape[0]
        want = tf.text_frontend_plain(tile, geo.starts, geo.lens)
        by_lanes = []
        for lanes in build.TEXT_LANES:
            forced = lambda: forced_k4(lanes, tile, geo.starts,  # noqa
                                       geo.lens)
            check(same((forced(),), (want,)) == 0, f"K4 at {label}, {lanes}"
                  " lanes, differs from its plain version")
            f_ms = device_ms(forced, 50, call_ms(forced, 50))
            by_lanes.append(f"{lanes} {f_ms:.6f}")
        print(f"[times] K4 lane rule, {label} ({rows} rows): the rule's"
              f" {build.host_text_lanes(rows, sms=sms)} lanes a word on"
              f" {sms} SMs; by lanes a word (measurement builds), ms: "
              + ", ".join(by_lanes))
    # K5: the counting instance at an index chunk and at 1M words of the
    # realistic vocabulary; the sliced one at an index chunk of the
    # 262,144-key dictionary's vocabulary; the bitonic one at phase 5c's
    # 65,536-lane tiles, on 1M words of the realistic vocabulary
    for label, ids_, n_roots, block_w in (
            ("index chunk", real_ids[:INDEX_CHUNK], len(vocab), INDEX_BLOCK),
            ("1M words", real_ids[:INDEX_WORDS], len(vocab), INDEX_BLOCK),
            ("index chunk, 262,144-key vocabulary", grown_ids,
             len(grown_vocab), INDEX_BLOCK),
            ("1M words, block_w 65536", real_ids[:INDEX_WORDS], len(vocab),
             1 << 16)):
        tiles_ = pk.pad_ids(ids_, n_roots=n_roots, block_w=block_w)
        n_tiles = tiles_.shape[0]
        w = ids_.shape[0]
        lane = torch.arange(block_w, dtype=torch.int32, device=dev)
        keys = (tiles_ * block_w + lane).view(n_tiles, block_w)
        kern = dict(n_roots=n_roots, block_w=block_w)
        instance = pk._instance(n_roots, block_w)
        kernel = lambda: pk.postings_cuda(tiles_, **kern)  # noqa: E731
        plain = lambda: pk.postings_plain(tiles_, **kern)  # noqa: E731
        library = lambda: torch.sort(keys, dim=1)  # noqa: E731
        check(same(kernel(), plain()) == 0,
              f"timed shape {label}: K5 differs from its plain version")
        k_call = call_ms(kernel, 100)
        ms = device_ms(kernel, 100, k_call)
        # torch.sort of 65,536-key rows synchronizes inside: no spacer can
        # hold its launches back
        lib_ms = (event_ms(library, 100) if block_w > INDEX_BLOCK else
                  device_ms(library, 100, call_ms(library, 100)))
        plain_ms = call_ms(plain, 10)
        if instance == "bitonic":
            log_bw = block_w.bit_length() - 1
            work = f"{log_bw * (log_bw + 1) // 2} sort stages"
        else:
            bins, n_slices = pk.slices(n_roots, block_w)
            work = (f"{n_slices} slice(s) of {bins} bins a tile,"
                    f" {pk.COUNT_LANES_PER_WARP // 32} groups a warp")
        n_ops = n_tiles * (K5_OPS_PER_WORD * block_w
                           + K5_OPS_PER_BIN * (n_roots + 1))
        # ids in, rank and histogram out
        bd = bound(4 * n_tiles * block_w + 4 * n_tiles * block_w
                   + 4 * n_tiles * (n_roots + 1), n_ops)
        times[("K5", label)] = dict(ms=ms, call_ms=k_call, plain_ms=plain_ms,
                                    library_ms=lib_ms, **bd)
        print(f"[times] K5 {label} ({w} words, {n_tiles} tiles of"
              f" {block_w}, {n_roots} roots, instance {instance},"
              f" {work}): {ms:.6f} ms on the card ({k_call:.6f} ms a call"
              f" with the host), plain {plain_ms:.6f} ms a call, torch.sort"
              f" of the same keys alone (library_ms) {lib_ms:.6f} ms, bound"
              f" {bd['bound_ms']:.6f} ms by {bd['bound_by']}"
              f" ({bd['n_bytes']} B, {bd['n_ops']} int32 ops):"
              f" {bd['bound_ms'] / ms:.6f} of the bound,"
              f" {lib_ms / ms:.6f}x torch.sort's speed")
    # K6 at 4096 and 1M words; K7 and K8 on the tri group's keys of those
    # words (6 a word, against the realistic tri table), as the staged path
    # gives them, with torch.isin of the same keys beside them
    tri_bank = sm.pad_dict_bank(realistic.tri, 8).numel()
    tri_sorted = sm.pad_dict_sorted(realistic.tri).numel()
    tri_steps = (tri_sorted - 1).bit_length()
    for b in (SERVE_REQUEST_WORDS, SERVE_WORDS):
        w = staged_words[:b]
        k = sdp.stem_datapath_cuda(w)[0][:, :6].reshape(-1).contiguous()
        n = k.shape[0]
        n_k = 200 if b == SERVE_REQUEST_WORDS else 10
        n_p = 10 if b == SERVE_REQUEST_WORDS else 2
        # membership needs the keys read once, the flags (1 B) written
        # once and the table read once; its operations are those of a
        # sorted search, ceil(log2 Rp) probes a key, whatever computes it
        member_ops = n * tri_steps * OPS_PER_PROBE
        runs = {
            "K6": (lambda: sdp.stem_datapath_cuda(w),
                   lambda: sdp.stem_datapath_plain(w), None,
                   bound(b * K6_BYTES_PER_WORD, b * DATAPATH_OPS_PER_WORD),
                   "no single PyTorch call computes stages 1-4"),
            "K7": (lambda: sm.dict_match_cuda(k, realistic.tri),
                   lambda: sm.dict_match_plain(k, realistic.tri),
                   lambda: torch.isin(k, realistic.tri),
                   bound(5 * n + 4 * tri_bank, member_ops),
                   "the banks' {compares} compares ({per_key:.6f} a key,"
                   " largest bank {largest}; all-pairs would make"
                   f" {n * tri_bank})"),
            "K8": (lambda: sm.dict_match_bsearch_cuda(k, realistic.tri),
                   lambda: sm.dict_match_bsearch_plain(k, realistic.tri),
                   lambda: torch.isin(k, realistic.tri),
                   bound(5 * n + 4 * tri_sorted, member_ops),
                   f"{n * (tri_steps + 1)} probes"),
        }
        for name, (kernel, plain, library, bd, note) in runs.items():
            check(same(kernel(), plain()) == 0,
                  f"timed shape B={b}: {name} differs from its plain version")
            if library is not None:
                check(torch.equal(kernel(), library()),
                      f"timed shape B={b}: {name} differs from torch.isin")
            k_call = call_ms(kernel, n_k)
            ms = device_ms(kernel, n_k, k_call)
            # torch.isin synchronizes inside: events around the calls
            lib_ms = event_ms(library, n_k) if library is not None else None
            plain_ms = call_ms(plain, n_p)
            times[(name, b)] = dict(ms=ms, call_ms=k_call, plain_ms=plain_ms,
                                    library_ms=lib_ms, **bd)
            lib = (f"torch.isin of the same keys (library_ms) {lib_ms:.6f} ms,"
                   f" {lib_ms / ms:.6f}x its speed"
                   if lib_ms is not None else "library_ms null")
            if name == "K8":
                note += "; " + bsearch_shape(build.dict_match_library())
            if name == "K7":
                st = sm.bank_stats(k, realistic.tri)
                note = note.format(compares=st["compares"],
                                   per_key=st["compares"] / n,
                                   largest=st["largest"])
            print(f"[times] {name} B={b} ({n} keys for K7/K8): {ms:.6f} ms"
                  f" on the card ({k_call:.6f} ms a call with the host),"
                  f" plain {plain_ms:.6f} ms a call, {lib}, bound"
                  f" {bd['bound_ms']:.6f} ms by {bd['bound_by']}"
                  f" ({bd['n_bytes']} B, {bd['n_ops']} int32 ops); {note}")
    # K8 on the 262,144-key dictionary's tri table (18,000 keys, padded
    # 32,768: the shared instance at its largest) and quad table (243,614,
    # padded 262,144: the global instance), on the tri-group keys of 1M
    # words, torch.isin beside each
    k = sdp.stem_datapath_cuda(staged_words)[0][:, :6].reshape(-1).contiguous()
    n = k.shape[0]
    k8_lib = build.dict_match_library()
    for label, table in (("grown tri", grown.tri), ("grown quad", grown.quad)):
        rp = sm.sorted_padded(table.shape[0])
        kernel = lambda: sm.dict_match_bsearch_cuda(k, table)  # noqa: E731
        plain = lambda: sm.dict_match_bsearch_plain(k, table)  # noqa: E731
        library = lambda: torch.isin(k, table)  # noqa: E731
        got = kernel()
        check(torch.equal(got, plain()) and torch.equal(got, library()),
              f"timed table {label}: K8 differs from its plain version or"
              " from torch.isin")
        shape = bsearch_shape(k8_lib)
        k_call = call_ms(kernel, 10)
        ms = device_ms(kernel, 10, k_call)
        lib_ms = event_ms(library, 10)
        plain_ms = call_ms(plain, 2)
        steps = (rp - 1).bit_length()
        bd = bound(5 * n + 4 * rp, n * steps * OPS_PER_PROBE)
        times[("K8", label)] = dict(ms=ms, call_ms=k_call, plain_ms=plain_ms,
                                    library_ms=lib_ms, **bd)
        print(f"[times] K8 {label} table ({table.shape[0]} keys, padded {rp};"
              f" {shape}) at B={SERVE_WORDS} ({n} keys): {ms:.6f} ms on the"
              f" card ({k_call:.6f} ms a call with the host), plain"
              f" {plain_ms:.6f} ms a call, torch.isin of the same keys"
              f" (library_ms) {lib_ms:.6f} ms, {lib_ms / ms:.6f}x its speed,"
              f" bound {bd['bound_ms']:.6f} ms by {bd['bound_by']}"
              f" ({bd['n_bytes']} B, {bd['n_ops']} int32 ops):"
              f" {bd['bound_ms'] / ms:.6f} of the bound")
    for label, (launches, secs) in staged.items():
        key = "K8" if label == "K8" else "K7"
        busy = (launches.get("dict_match_cuda", 0)
                + launches.get("dict_match_bsearch_cuda", 0)) \
            * times[(key, SERVE_WORDS)]["ms"] * 1e-3 / secs
        print(f"[times] staged {label}: the Compare kernel ran for"
              f" {busy:.6f} of the wall time ({secs:.6f} s)")
    for persistent, (launches, serve_s, admit_s, n_w, n_b) in \
            text_runs.items():
        k4_busy = (launches["text_frontend_cuda"]
                   * times[("K4", "request")]["ms"] * 1e-3 / serve_s)
        print(f"[times] text serve, {'persistent' if persistent else 'resident'}:"
              f" K4 ran for {k4_busy:.6f} of the wall time"
              f" ({launches['text_frontend_cuda']} launches x its device"
              f" time at a request's tile, over {serve_s:.6f} s)")
    k1_busy = (k5_launches["stem_fused_cuda"]
               * times[("K1", "index chunk")]["ms"] * 1e-3 / index_s)
    print(f"[times] index build: K1 ran for {k1_busy:.6f} of the wall time"
          f" ({k5_launches['stem_fused_cuda']} launches x its device time at"
          f" an index chunk, over {index_s:.6f} s)")
    k5_busy = (k5_launches["postings_cuda"]
               * times[("K5", "index chunk")]["ms"] * 1e-3 / index_s)
    print(f"[times] index build: K5 ran for {k5_busy:.6f} of the wall time"
          f" ({k5_launches['postings_cuda']} launches x its device time at"
          f" an index chunk, over {index_s:.6f} s)")
    k5_grown_busy = (k5_grown_inst["sliced"] * times[(
        "K5", "index chunk, 262,144-key vocabulary")]["ms"] * 1e-3
        / index_grown_s)
    print(f"[times] index build, 262,144 keys: K5 (sliced) ran for"
          f" {k5_grown_busy:.6f} of the wall time ({k5_grown_inst['sliced']}"
          f" launches x its device time at an index chunk, over"
          f" {index_grown_s:.6f} s)")

    serve_b = SERVE_REQUEST_WORDS
    for label, kernel, launches, serve_s in (
            ("K1, resident serve", "K1", sum(k1_launches.values()),
             k1_serve_s),
            ("K3 streamed, persistent serve", "K3 streamed, mapped flags",
             sum(k3s_launches.values()), k3s_serve_s),
            ("K3 resident, persistent serve", "K3 resident, mapped flags",
             sum(k3r_launches.values()), k3r_serve_s)):
        busy = launches * times[(kernel, serve_b)]["ms"] * 1e-3 / serve_s
        print(f"[times] {label}: the kernel ran for {busy:.6f} of the wall"
              f" time ({launches} launches x its device time at B={serve_b},"
              f" over {serve_s:.6f} s)")
    # K9 at llama3-8b's prefill attention shape, on the LM's own tensors,
    # bf16 (the wgmma instance) and fp32 (the fma one), and at gemma-2b's
    # [1, 8, 2048, 256] in bf16, with scaled_dot_product_attention of the
    # same tensors beside each
    g9 = torch.Generator(dev).manual_seed(2)
    gemma = tuple((torch.randn(GEMMA_ATTN_SHAPE, generator=g9, device=dev)
                   * 0.5).bfloat16() for _ in range(3))
    for key, label, (q, k, v) in (
            ("bfloat16", "llama3-8b layer 0",
             (x.bfloat16() for x in k9_inputs)),
            ("float32", "llama3-8b layer 0", (x.float() for x in k9_inputs)),
            ("gemma bf16", "gemma-2b shape, random", gemma)):
        dtype = str(q.dtype).removeprefix("torch.")
        kernel = lambda: fa.flash_attention_cuda(q, k, v)  # noqa: E731
        plain = lambda: fa.flash_attention_plain(q, k, v)  # noqa: E731
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True)
        lib_diff = float((library().float() - kernel().float()).abs().max())
        k_call = call_ms(kernel, 5)
        ms = device_ms(kernel, 10, k_call)
        lib_ms = device_ms(library, 10, call_ms(library, 5))
        plain_ms = call_ms(plain, 3)
        b_, h_, t_, d_ = q.shape
        flops = 4 * b_ * h_ * d_ * t_ * (t_ + 1) // 2
        n_bytes = 4 * b_ * h_ * t_ * d_ * q.element_size()
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], n_bytes / PEAK_BYTES_S
        bd = dict(bound_ms=1e3 * max(t_ops, t_bytes),
                  bound_by="operations" if t_ops > t_bytes else "bytes",
                  n_bytes=n_bytes, n_ops=flops)
        times[("K9", key)] = dict(ms=ms, call_ms=k_call, plain_ms=plain_ms,
                                  library_ms=lib_ms, **bd)
        print(f"[times] K9 {dtype} {list(q.shape)} causal ({label},"
              f" instance {fa._instance(q.dtype, d_)}): {ms:.6f} ms on the"
              f" card ({k_call:.6f} ms a call with the host), plain"
              f" {plain_ms:.6f} ms a call,"
              f" scaled_dot_product_attention(is_causal=True) of the same"
              f" tensors (library_ms) {lib_ms:.6f} ms (max |difference|"
              f" {lib_diff:.3e}), bound {bd['bound_ms']:.6f} ms by"
              f" {bd['bound_by']} ({n_bytes} B, {flops} flops at"
              f" {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s):"
              f" {bd['bound_ms'] / ms:.6f} of the bound;"
              f" {flops / ms / 1e9:.3f} TFLOP/s achieved")
    print(f"[times] LM serve: {lm_run['steps']} decode steps,"
          f" {lm_run['decode_s'] / lm_run['steps'] * 1e3:.6f} ms a step,"
          f" {lm_run['tokens'] / lm_run['wall']:.6f} tokens/s")
    casts = train_run["casts"]
    print(f"[times] LM train, {TRAIN_ARCH} full width and depth, remat full,"
          f" B {TRAIN_B}, T {TRAIN_T}: {train_run['steady_ms']:.6f} ms a"
          f" step, {train_run['tokens_s']:.6f} tokens/s,"
          f" {train_run['tflops']:.6f} TFLOP/s (6 N tokens), peak"
          f" {train_run['peak_gb']:.6f} GB, {train_run['n_kernels']} kernels"
          f" a step, {train_run['busy_ms']:.3f} ms of them; weight casts"
          f" {casts['forward'][1]:.6f} ms forward, {casts['backward'][1]:.6f}"
          " ms backward; remat at " + ", ".join(
              f"{k} {v['step_ms']:.3f} ms / {v['peak_gb']:.3f} GB"
              for k, v in remat_runs.items())
          + f" ({REMAT_LAYERS} layers); the example {example_run['fit_s']:.3f}"
          f" s for {EXAMPLE_STEPS[0]} steps")
    for name, r in moe_runs.items():
        step_ms = r["decode_s"] / r["steps"] * 1e3
        print(f"[times] MoE serve, {name} ({r['params']} parameters):"
              f" {r['steps']} decode steps, {step_ms:.6f}"
              f" ms a step, {r['tokens'] / r['wall']:.6f} tokens/s,"
              f" {r['kernels']} kernels a step, {r['busy_ms']:.3f} ms of them"
              f" (busy {r['busy_ms'] * r['steps'] / r['decode_s'] / 1e3:.4f}"
              f" of a served step), peak {r['peak_gb']:.6f} GB")
    casts = moe_train["casts"]
    print(f"[times] MoE train, {MOE_ARCH} full width, {MOE_TRAIN_LAYERS}"
          f" layers, remat full, B {TRAIN_B}, T {TRAIN_T}:"
          f" {moe_train['steady_ms']:.6f} ms a step,"
          f" {moe_train['tokens_s']:.6f} tokens/s, {moe_train['tflops']:.6f}"
          f" TFLOP/s (6 N tokens, N = {moe_train['n_active']} active of"
          f" {moe_train['n_params']}),"
          f" {moe_train['tflops'] * 1e12 / PEAK_FLOPS['bfloat16']:.6f} of"
          f" the bf16 peak, peak {moe_train['peak_gb']:.6f} GB,"
          f" {moe_train['n_kernels']} kernels a step,"
          f" {moe_train['busy_ms']:.3f} ms of them; weight casts"
          f" {casts['forward'][1]:.6f} ms forward, {casts['backward'][1]:.6f}"
          " ms backward")
    for name, r in ssm_runs.items():
        step_ms = r["decode_s"] / r["steps"] * 1e3
        print(f"[times] serve, {name} ({r['params']} parameters):"
              f" {r['steps']} decode steps, {step_ms:.6f} ms a step,"
              f" {r['tokens'] / r['wall']:.6f} tokens/s, {r['kernels']}"
              f" kernels a step, {r['busy_ms']:.3f} ms of them (busy"
              f" {r['busy_ms'] / step_ms:.4f} of a served step), peak"
              f" {r['peak_gb']:.6f} GB")
    for name, r in ssm_train.items():
        print(f"[times] train, {name} full width, {r['layers']} layers,"
              f" remat full, B {TRAIN_B}, T {r['t']}: {r['steady_ms']:.6f} ms"
              f" a step, {r['tokens_s']:.6f} tokens/s, {r['tflops']:.6f}"
              f" TFLOP/s (6 N tokens, N = {r['n_active']}),"
              f" {r['tflops'] * 1e12 / PEAK_FLOPS['bfloat16']:.6f} of the bf16"
              f" peak, peak {r['peak_gb']:.6f} GB, {r['n_kernels']} kernels a"
              f" step, {r['busy_ms']:.3f} ms of them; the reference's init"
              f" gave a first gradient norm of {r['raw_gnorm']!r}")
    r = audio_serve
    step_ms = r["decode_s"] / r["steps"] * 1e3
    print(f"[times] serve, {AUDIO_ARCH} ({r['params']} parameters):"
          f" {r['steps']} decode steps, {step_ms:.6f} ms a step,"
          f" {r['tokens'] / r['wall']:.6f} tokens/s, {r['kernels']} kernels a"
          f" step, {r['busy_ms']:.3f} ms of them (busy"
          f" {r['busy_ms'] / step_ms:.4f} of a served step), peak"
          f" {r['peak_gb']:.6f} GB")
    r = audio_train
    print(f"[times] train, {AUDIO_ARCH} full width and depth, remat full, B"
          f" {TRAIN_B}, T {TRAIN_T}: {r['steady_ms']:.6f} ms a step,"
          f" {r['tokens_s']:.6f} tokens/s, {r['tflops']:.6f} TFLOP/s (6 N"
          f" tokens, N = {r['n_active']}),"
          f" {r['tflops'] * 1e12 / PEAK_FLOPS['bfloat16']:.6f} of the bf16"
          f" peak, peak {r['peak_gb']:.6f} GB")
    for tag in ("train", "audio-train"):
        r = dry_run[tag]
        print(f"[times] dry run, {tag}: arguments {r['err']:+.6f} off the"
              f" card's, peak ratio {r['peak_ratio']:.4f}, compute term"
              f" {r['compute_ms']:.3f} ms, memory term {r['memory_ms']:.3f}"
              " ms")
    lap("times")
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(card_line())

    def entry(name, key, source, replaces, launches, err, shape=serve_b):
        t = times[(key, shape)]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms")}

    csrc = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/stem_fused.py:"
    # each kernel's launches on its main path's run, plus those of phase
    # 12's counted runs (each with the counters set to 0 just before)
    more = devices["launches"]
    more_k5 = devices["k5_instances"]
    print(f"[done] launches added by phase 12: {more} (K5 {more_k5})")
    print(json.dumps({"kernels": [
        entry("stem_fused", "K1", csrc + "stem_fused.cu", ref + "166",
              k1_launches["stem_fused_cuda"]
              + more.get("stem_fused_cuda", 0), k1_err),
        entry("stem_streamed", "K2", csrc + "stem_streamed.cu", ref + "312",
              k2_launches + more.get("stem_streamed_cuda", 0), k2_err),
        entry("persistent_resident", "K3 resident, mapped flags",
              csrc + "stem_persistent.cu", ref + "403",
              k3r_launches["persistent_resident_cuda"], k3_err),
        entry("persistent_streamed", "K3 streamed, mapped flags",
              csrc + "stem_persistent.cu", ref + "364",
              k3s_launches["persistent_streamed_cuda"], k3_err),
        entry("text_frontend", "K4", csrc + "text_frontend.cu",
              "src/repro/kernels/text_frontend.py:41",
              text_runs[False][0]["text_frontend_cuda"], k4_err,
              shape="request"),
        entry("postings_counting", "K5", csrc + "postings.cu (+ postings.cuh)",
              "src/repro/kernels/postings.py:92",
              k5_inst["counting"] + more_k5.get("counting", 0),
              k5_err, shape="index chunk"),
        entry("postings_sliced", "K5", csrc + "postings.cu (+ postings.cuh)",
              "src/repro/kernels/postings.py:92",
              k5_grown_inst["sliced"] + more_k5.get("sliced", 0), k5_err,
              shape="index chunk, 262,144-key vocabulary"),
        # on no main path since the sliced instance (0 in the counted
        # runs); phase 5c's parity launches under a key of their own
        dict(entry("postings_bitonic", "K5",
                   csrc + "postings.cu (+ postings.cuh)",
                   "src/repro/kernels/postings.py:92",
                   k5_inst["bitonic"] + k5_grown_inst["bitonic"]
                   + more_k5.get("bitonic", 0), k5_err,
                   shape="1M words, block_w 65536"),
             parity_launches=k5_checked["bitonic"]),
        entry("stem_candidates", "K6", csrc + "stem_candidates.cu",
              "src/repro/kernels/stem_datapath.py:121",
              staged["K6+K7"][0]["stem_datapath_cuda"]
              + more.get("stem_datapath_cuda", 0), k6_err),
        entry("dict_match_bank", "K7",
              csrc + "dict_match.cu (+ dict_bank.cuh)",
              "src/repro/kernels/stem_match.py:152",
              staged["K7"][0]["dict_match_cuda"], k7_err),
        entry("dict_match_bsearch", "K8", csrc + "dict_match.cu",
              "src/repro/kernels/stem_match.py:208",
              staged["K8"][0]["dict_match_bsearch_cuda"], k8_err),
        entry("flash_attention_wgmma", "K9",
              csrc + "flash_attention.cu (+ flash_sm90.cuh)",
              "src/repro/kernels/flash_attention.py:26", k9_launches["wgmma"],
              k9_err["wgmma"], shape="bfloat16"),
        entry("flash_attention_fma", "K9", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:26", k9_launches["fma"],
              k9_err["fma"], shape="float32"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
