#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--rounds T] [--out results.json]

Phases, each fatal on failure (nonzero exit):

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. the build of every CUDA kernel from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once; ``-Xptxas -v`` output printed);
3. each of the seven kernels at the main paths' real shapes -- every run of
   the full smollm-360m wire layout, n = 4 clients, 8-bit quant (plus 2 and
   4 bits on the largest run; ``scatter_agg`` and ``unpack_mma`` also with
   the non-unit weights ``HT_WEIGHTS``, checked); ``segment_rows`` at the
   gather phases' m = 4
   of n = 8 rows (the top-k values and the ``[4, d]`` deltas, plus a case
   with duplicate and out-of-range ids and the quant scales, checked);
   ``quantize_ef`` and ``switch_blend`` on the flat ``[d]`` buffer -- held
   against its plain PyTorch version on the card, and timed with CUDA
   events beside its plain version, the nearest single PyTorch call (where
   there is one) and its bound; ``block_topk`` also on the largest
   960-block run with rows of ties and of NaNs written in (bits compared),
   and the kernel variant each run takes is printed; then the reader of
   every profiled round below (``device_kernels``, from the Kineto events)
   against ``key_averages()`` on one profile;
4. a small-input reference check: one reduced round on the card against the
   same round on the CPU for each wire -- ``comm="pallas"`` with a top-k
   or quant uplink; ``comm="dense"`` and ``"packed"`` with top-k or 8-bit
   quant up and down; 6-bit quant up and down on ``"packed"`` (the dense
   fallback); penalty-fedavg; centralized-sgm at n = m = 1 -- and, for
   rand-k and natural compression, whose card streams differ from the
   CPU's, a round that must be finite and a compressor that must contract;
5. the mask paths on ``comm="pallas"``: full-width smollm-360m federated
   training (d = 361,821,120), T rounds with ``--uplink quant`` then T with
   ``--uplink topk`` (4 clients, all participating: the fused eval/step-1
   round), through the launcher's ``setup`` and
   ``engine.rounds.run_rounds``;
6. gather against mask on the card: full width at 2 layers, 8 clients,
   4 of them in each of 2 rounds replayed through the ``fixed`` sampler,
   top-k and quant up and down on ``comm="pallas"`` and rand-k up and down
   on ``comm="packed"`` (per-client streams), and a ragged client fleet
   with the ``weighted`` sampler (Horvitz-Thompson weights) and 2 fresh
   rows per client and round, top-k up and down on ``comm="pallas"``;
   state and per-round metrics bit-equal; then the token draws: redraws
   of one batch on the card's generator, step by step (recorded: the
   steps that do not reproduce), and the port's own draws from a CPU
   generator, which must reproduce;
7. the gather paths on ``comm="pallas"``: full-width smollm-360m, 8
   clients, 4 sampled per round (``--participation gather``, ``uniform``
   sampler), the same compressor up and down (top-k 0.1, then 8-bit quant)
   through the engine API, T rounds each;
8. the dense and packed wires at full width, T rounds each: the reference
   launcher's default wire (``comm="dense"``, top-k up and down, mask 4 of
   4, fused), packed top-k up and down in gather mode (4 of 8,
   ``full_eval=False``: the fused sparse eval, the library sort, the
   sort-free embedding run), and packed 8-bit quant up and down (mask 4 of
   4);
9. the client fleet at full width on ``comm="pallas"``, gather 4 of 8, T
   rounds each: (a) through the engine API, a quantity-skewed token fleet
   (``build_fleet`` over 64 sequences of 64 tokens, ``zipf`` a = 1.2, cap
   factor 4), the ``weighted`` sampler (its weights must not all be 0/1)
   and 2 fresh rows per client and round, top-k 0.1 up and down; (b)
   through the launcher, ``--fleet --fleet-pool 8 --sampler markov``,
   8-bit quant up and down; every provisioned row must lie below its
   client's count;
10. the NP task of the paper's Figure 1 (n = 20, m = 10, E = 5, top-k 0.1
   up and down, the dense wire): two rounds on the card against the same
   rounds on the CPU from the same shards and recorded cohorts, hard and
   soft, then the port's quickstart on the card (40, 20 and 20 rounds
   for its three parts, cut from its own 500, 200 and 50 because the
   phase is bound by the host) and one more Figure-1 round under the
   profiler;
11. the paper's other experiments: (a) the CMDP example's config (10
   clients, 7 sampled, top-k 0.5 up) for 2 rounds at horizon 50 on the
   card against the CPU, from the same fleet draws and one recorded Markov
   cohort, on ``comm="dense"`` and ``"pallas"``, after ``block_topk`` and
   ``scatter_agg`` are held against their plain versions at the CMDP
   layout; (b) the CMDP example as the reference runs it (horizon 200,
   ``CMDP_ROUNDS`` rounds cut from 300) and one more round under the
   profiler; (c) the fair example (alpha 10 and 0.5, the penalty sweep,
   ``FAIR_ROUNDS`` rounds each); (d) the weakly-convex measure on NP (n =
   4), which must halve over 150 rounds; (e) the LM example at ``--preset
   100m`` (packed wire, blocks of 2048), 3 rounds, after ``scatter_agg``
   is held against its plain version at that layout;
12. asynchronous buffered rounds with the telemetry bus, T rounds a part
   at full width: (a) the launcher's async path (``--fleet --fleet-pool 8
   --async-buffer --sampler markov --staleness constraint --obs``, gather 4
   of 8, pallas top-k 0.1 up and down, max staleness 4), each round's
   counters and telemetry printed and one profiled round split by stage
   span (``round.*``, ``comm.*``, ``kernel.*``: host ms and device ms);
   (b) async mask 4 of 8, pallas 8-bit quant up and down, the ``uniform``
   sampler and the ``poly`` law through the engine API; in both the
   counters equal a host replay of the recorded events and the stale
   reduce's kernel equals its plain version on the final buffer's rows
   with fractional weights; (c) at 2 layers, full width otherwise: the
   buffer off equal to the synchronous rounds bit for bit (pallas and
   dense), obs on equal to obs off, gather equal to mask, the card against
   the CPU from the same cohorts and events; over the phase at least one
   payload parks, one delivers and one expires;
13. population scale-out and checkpoints: (a) at 2 layers, full width
   otherwise, 3 rounds each on recorded cohorts (``fixed`` sampler): a slot
   store of cap 8 >= n = 8 against the dense residual, bit for bit (pallas
   top-k and quant up and down, dense-wire top-k); an evicting store (cap
   4 of n = 12) on the card against the CPU, with at least one eviction
   and each round's flush partial bit-equal to ``scatter_agg``'s plain
   version on the same orphan payloads, and every ``scatter_agg`` launch
   of the 12-row fresh reduce and ``segment_rows`` launch into 12 rows
   bit-equal to its plain version on the same inputs; cohorts k = 2 and 4 against k = 1
   (top-k bit for bit, quant within rtol 1e-5); save -> restore ->
   continue of an evicting store, the async buffer and a Markov fleet,
   bit for bit against the uninterrupted run, and a compressed-residual
   sidecar restoring ``decode(pack(e))``; (b) the slot store at full
   width: 32 clients, 4 sampled, ``--ef-slots 8``, pallas top-k 0.1 up and
   down, ``--sparse-eval``, ``--lean-metrics`` (the ``delta_norm``
   diagnostic scatters ``[n, d]``), T rounds, with its resident bytes,
   evictions and flushed HT mass, then one more round whose 32-row
   ``scatter_agg`` and ``segment_rows`` launches are each held bit-equal
   to their plain versions; (c) two-tier aggregation at full width:
   gather 4 of 8, ``--cohorts 4``, pallas 8-bit quant up and down,
   ``--sparse-eval``, T rounds, one round's tiered ``v_bar`` against the single-tier reduce of
   the same messages and a strided cohort slice through ``unpack_mma``
   against its plain version;
14. the token-only model families at full published width, T rounds each
   through the launcher's setup (``--arch``; depth cut through a config
   where one card forces it) and ``run_rounds``, batch 2, seq 64: (a)
   mamba2-130m, all 24 layers, gather 4 of 8, pallas top-k 0.1 up and
   down; (b) recurrentgemma-2b at 3 of 26 layers (one ``(rec, rec,
   attn)`` period), 2 clients, pallas 8-bit quant up; (c) gemma3-4b at 2
   of 34 layers (two local layers: ``blocks == []``), 2 clients, pallas
   top-k 0.1 up; in each one more round whose every wire-kernel launch is
   held against its plain version on the same inputs, tolerance 0 (the
   new block layouts: 24, 838, 896; 640, 960, 256; 640, 256, 1024); (d)
   each of the five families' reduced configs (qwen3-4b, minitron-4b,
   gemma3-4b, mamba2-130m, recurrentgemma-2b) at seq 64, 2 rounds on the
   card against the CPU, dense top-k up and down then pallas 8-bit quant
   up: f and g_hat at rtol 1e-4, all but 0.1% of w within rtol 1e-4 /
   atol 1e-6;
15. the moe family: (a) deepseek-v2-236b at its published widths (d_model
   5120, 128 heads, MLA kv_lora 512 / rope 64 / nope 128 / v 128, d_expert
   1536, 2 shared experts, top-6, capacity 1.25), cut to 2 of 60 layers
   (the leading dense layer and one MoE layer), 16 of 160 routed experts
   and 12,800 of 102,400 vocab rows (d = 1,203,480,576), T rounds through
   the launcher's setup (2 clients, pallas top-k 0.1 up, g the router's
   load imbalance minus 6) and ``run_rounds``; one more round whose every
   wire-kernel launch is held against its plain version, tolerance 0 (the
   block layouts printed: 512, 576, 800, 768, 16 among them), the peak
   leaving at least 5 GB of the card free, and the MoE layer's parts
   timed (routing, dispatch, expert GEMMs, combine; its forward and
   backward profiled); (b) the hidden state that enters 15(a)'s MoE layer
   through that layer on the card and on the CPU: ``idx`` equal wherever
   the CPU's margin exceeds 1e-5 (the count under it printed), y and aux +
   1 within rtol 1e-4 on the tokens whose routing agrees, and the card's
   draw-free core on the CPU's routing within the same; (c) the reduced
   deepseek-v2 and deepseek-v3 (MTP, low-rank queries) as in 14(d);
16. the vlm and audio families, T rounds each through the launcher's setup
   and ``run_rounds``, batch 2, seq 64, each round's media drawn on the
   CPU with its tokens: (a) llama-3.2-vision-90b at its published widths
   (d_model 8192, GQA 64/8, head_dim 128, d_ff 28,672, 1,601 media tokens
   of width 8192, rope theta 500,000), cut to its one cross layer (1 of
   100 layers, ``cross_attn_every`` 1) and 16,032 of 128,256 vocab rows
   (d = 1,118,330,881), 2 clients, pallas 8-bit quant up (block 1 for the
   gate); (b) whisper-small whole (12 + 12 layers, 1,500 frames; d =
   239,649,036), gather 4 of 8, pallas top-k 0.1 up and down, separate
   eval; in each one more round whose every wire-kernel launch is held
   against its plain version, tolerance 0, the CPU draw of a round's batch
   timed, one more round profiled with the forward's cross-attention and
   encoder device ms, and f of client 0 under a second media draw, which
   must differ (in (a) with the gate set to 1: the trained one is about
   1e-6); in (a) ``tanh(gate)`` 0 in round 1's forwards and nonzero in
   round 2's, and the peak leaving at least 5 GB of the card free; (c)
   the reduced llama-3.2-vision-90b (``media_proj`` 8192 -> 128) and
   whisper-small, with media, as in 14(d);
17. cross-process federation (``repro_torch.wire``): (a) the launcher's
   ``--wire 2 --reduced --clients 4 --participating 2 --comm pallas
   --uplink topk --rounds 2`` as a subprocess (its two workers processes
   too), each round's f, g_hat and sigma bit-equal to ``rounds.drive`` on
   ``build_problem("lm")``; (b) mamba2-130m whole (d = 128,983,488), a
   full-width problem this script registers with ``bootstrap.problem``,
   ``wire_drive(spawn="thread")`` over 4 workers, 8 clients, gather 4,
   the full eval, lean metrics, pallas top-k 0.1 up, identity down, batch
   2, seq 64, 3 rounds (round 1 timed and profiled on the card's side,
   round 2 checked): state and every metric bit-equal to ``rounds.drive``
   on the same problem, every ``block_topk`` and ``scatter_agg`` launch of
   round 2 (every thread) bit-equal to its plain version, each kernel launched
   once per wire run and encoding worker or reduce; printed: s/round of
   the wire and of ``drive``, round 1's frames and bytes by kind, its
   host seconds in CRC-32 and socket I/O and its device busy share, the
   EF_DUMP frames, the largest frame against ``MAX_FRAME``, peak GB;
   (c) as (b) with pallas 8-bit quant up
   (``quantize_ef_pack``, ``unpack_mma``); (d) ``wire_drive(spawn=
   "process")`` on the reduced LM problem, 2 rounds, with a
   ``WireFaultConfig`` and a seeded ``ChaosProcess`` SIGKILL at round 1's
   eval: respawned, and bit-equal to the clean oracle; (a)'s subprocess
   and those of 18(d) and 19(f) run beside (d) (none is timed, and each
   process counts its own launches);
18. serving (``prefill``, then greedy ``decode_step`` over the KV caches)
   at full published width, each cell under ``torch.inference_mode`` with
   weights drawn on CPU generators (seed 0) and the launcher's prompts and
   media: (a) qwen3-4b whole (36 layers), batch 4, prompt 512, 32 steps;
   (b) gemma3-4b whole (34 layers, window 1024, 5:1), batch 4, prompt
   1,100, 16 steps (every local ring holds the whole prompt; decode past
   position 1,024); (c) llama-3.2-vision-90b at its published widths and
   vocab cut to one period (4 self layers, 1 cross layer), its gate at
   0.5, media ``[4, 1601, 8192]``, batch 4, prompt 32, 16 steps; in each
   the prefill ms, the decode ms per step and tokens/s, one profiled
   decode step (device ms, launches, busy share), the peak, the step's
   byte bound, and every decode step's logits against the card's own
   forward over the prompt and the decoded tokens (within 1e-4 of the
   largest logit); (d) ``python -m repro_torch.launch.serve`` (reduced
   qwen3-4b), ``... --arch smollm-360m --no-reduced`` and ``python -m
   repro_torch.examples.serve_batched --arch gemma3-4b`` as subprocesses
   started together (beside 17(d)), each exiting 0 with its line; no wire
   kernel launches in the phase.
19. serving of the state-cache families, as 18(a)-(c) (the checked
   forward over the prompt and the decoded tokens, within 1e-4 of its
   largest logit): (a) mamba2-130m whole (24 layers), batch 4, prompt
   1,000 (a padded last SSD chunk), 32 steps; (b) recurrentgemma-2b whole
   (26 layers, window 2,048), batch 4, prompt 2,040, 16 steps (a ring of
   2,049 slots; decode past ``pos = window`` and the wrap to slot 0); (c)
   deepseek-v2-236b at its published widths, all 160 routed experts and
   vocab 102,400, cut to 3 layers (1 dense + 2 MoE), ``capacity_factor``
   27 (no route dropped), batch 4, prompt 256, 16 steps, with the routes
   the published 1.25 would drop at each decode step counted from the
   router's choices; (d) whisper-small whole (12 + 12 layers, frames ``[4,
   1500, 768]``), batch 4, prompt 64, 32 steps; each with a bound of its
   decode step over any cache tree (whisper's by operations: the cross K/V
   it recomputes); (e) the reduced mamba2-130m, recurrentgemma-2b,
   deepseek-v2-236b, deepseek-v3-671b (published capacity, drops
   included) and whisper-small, prefill and 6 decode steps on the card
   against the CPU (the moe routes equal where the CPU's router margin
   exceeds 1e-5, logits within 1e-4 of the largest up to any step where a
   route under the margin flipped); (f) ``launch.serve --arch mamba2-130m
   --no-reduced``, ``--arch recurrentgemma-2b``, ``--arch
   deepseek-v2-236b``, ``--arch whisper-small`` and
   ``examples.serve_batched --arch deepseek-v3-671b`` as subprocesses
   started together (beside 17(d)), each exiting 0 with its line; no wire
   kernel launches in the phase;
20. the launch tooling (``repro_torch.launch.{steps,dryrun,roofline,
   mesh}``): (a) ``python -m repro_torch.launch.dryrun --sweep`` as a
   process started after the build (meta tensors only, no card visible to
   it), read at the phase's end: 80 records, 66 ``ok`` and the reference's
   14 skips (an ``error`` allowed only for a giant's bf16 train case), each
   ok record's per-device GB and dominant term printed; on a (1, 1) debug
   mesh, each case counted by the dry run on meta tensors, then built on
   the card, whose bytes of the inputs must equal the dry run's argument
   bytes within 1%: (b) smollm-360m whole at train_4k's sequence (4,096),
   one client of 2 rows (``fed_config_for``: n = m = 1, top-k 0.1 up and
   down on ``comm="pallas"``), remat on, 3 rounds (the second with every
   wire-kernel launch held against its plain version, tolerance 0; f and
   g_hat finite), one more profiled: s/round, device ms, busy share, peak
   GB, FLOP/s against 67 TFLOP/s from the dry run's count; (c) the same
   case at seq 1,024, one round with remat on and one off from the same
   state: w bit-equal, each peak GB; then at phase 5's mask top-k layout
   (4 clients, seq 64) rounds with remat on and off in turns, 5 timed of
   each, and one of each profiled; (d) qwen3-4b whole, decode_32k at
   batch 4 of 128 (caches of 32,768 slots, pos 32,767), 2 warm and 5
   timed decode steps; (e) gemma3-4b whole, long_500k (batch 1, 524,288
   slots in its 5 global layers); (f) mamba2-130m whole, prefill_32k at
   batch 4 of 32 (32,768 tokens), one warm and one timed prefill; in (d)-(f)
   the device ms and launches of one profiled call against the case's
   roofline bound, finite logits, no wire kernel;
21. rounds across ranks (the mesh's client axis over a
   ``torch.distributed`` group, ``launch.mesh.make_rank_mesh``), 3 rounds a
   cell through the engine API (the launcher's setup), first in one process
   ((a) here; (b) and (c) are phases 14(a) and 5's runs, whose final states
   they keep), then in one world of ranks started by ``spawn`` that runs
   every cell: 2 ranks sharing the card over gloo (CUDA tensors, the
   collectives staged through pinned host memory; the collectives gloo
   takes on CUDA tensors probed first) and, where 2 or more cards exist,
   one rank per card over NCCL, up to 4: (a) the reference's ``multidev``
   configuration (NP, 12 clients, 4 sampled, gather, hard switch 0.35,
   top-k 0.25 block 8 up on the dense wire, ``ef_slots`` 12, E 2) with the
   reference's checks of ``sharded_take`` and ``constrain_fleet`` /
   ``constrain_store``; (b) mamba2-130m whole at phase 14(a)'s layout
   (gather 4 of 8, pallas top-k 0.1 up and down, the separate eval over all
   8); (c) smollm-360m whole at phase 5's mask quant layout (4 of 4, pallas
   8-bit quant up, the fused eval); on every rank the state (w, x, the
   averaged-iterate sums, every metric, the residual rows or slot pool it
   holds) bit-equal to the one process by sha1, the launches and
   ``loss_pair`` calls its rows and the replicated reduce demand, the
   collectives' bytes and host seconds per round, one more round profiled
   and one whose every wire-kernel launch is held against its plain
   version, tolerance 0; a rank that fails fails the phase;
22. the mesh's model axis (the flat state split by columns over a data x
   model rank mesh, ``make_rank_mesh(shape=(W / 2, 2), axes=("data",
   "model"))``), in phase 21's world after its cells, on the same
   one-process runs: (a) 21(b)'s cell, mamba2-130m whole, gather 4 of 8,
   pallas top-k up and down (``block_topk`` up and down, ``scatter_agg``
   and ``segment_rows`` on each rank's column blocks): no leaf split, so
   each model rank runs every client's eval and local steps on the whole
   ``w`` (one all-gather of its columns a round), and the digests of what
   it holds (``w``, every metric, its column block of ``w``, ``x``, the
   averaged-iterate sum and each residual row) are the one process's, bit
   for bit; (b) 21(c)'s cell, smollm-360m whole, mask quant
   (``quantize_ef_pack`` and ``unpack_mma`` on the column blocks) under
   the split plan (``sharding.partition.tensor_plan``: its MLP and tied
   vocab split over the 2 model ranks, its attention whole, 5 kv heads):
   the ranks share each client's forward and backward, the new ``w``'s
   columns go into each rank's tensor layout and each delta row back to
   the columns (``comm.flat.TensorLayout``), held against phase 5's run by
   :data:`TP_LAW`; both: the plan's split and whole leaves and bytes, the
   launches its column block's wire runs demand, its peak below the one
   process's, the collectives' bytes and host seconds per group, one
   round profiled and one whose every wire-kernel launch is held against
   its plain version;
23. tensor parallelism at qwen3-4b's published widths, cut to 2 of 36
   layers, pallas top-k up, mask 2 of 2, fused: :data:`TP_ROUNDS` rounds
   in one process, then in phase 22's world on the ``(1, 2)`` mesh (every
   leaf split but the norms: GQA at 4 q heads per kv group, qk-norm
   under a head split, the untied vocab-parallel head), held by
   :data:`TP_LAW`, the metrics the same bits on every rank, each rank's
   peak below the one process's, every wire-kernel launch of the checked
   round equal to plain; (b) only where asked (``rank_phase(...,
   phases=("23b",))``) and 4 cards exist, qwen3-4b whole (36 layers) on a
   ``(1, 4)`` NCCL mesh, one rank a card.

In phases 5, 7, 8, 9, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22 and 23 the
launch counts are zeroed just before each part and read just after: each kernel must have launched
exactly as often per round as the wire layout demands (on ``comm="pallas"`` the
encode kernel once per wire run and direction, and once more for a slot
store's eviction flush; the reduce kernel once per run and cohort on the
pallas and packed wires, twice in an async round, once more per run for
the flush; ``segment_rows`` twice in a gather round, once with
``lean_metrics``; no kernel on the dense wire), and ``loss_pair`` as often as the round's
forwards (n*E fused, n + m*E unfused); f and g_hat must be finite and
``up_bytes`` / ``down_bytes`` the wires' bytes.  One more round per phase
then runs under ``torch.profiler`` for the device time by kernel and
the device's busy share.

Before them, one line gives each phase's wall seconds
(``{"phase_seconds": ...}``).  The last three lines are the kernels' JSON
record, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.  Without a card, or
without the rest of the repository beside it, it exits nonzero and prints
no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = pathlib.Path(__file__).resolve().parent
N_CLIENTS = 4
N_GATHER, M_GATHER = 8, 4      # gather phases: m of n clients
REPS = 3
D_FULL = 361_821_120           # smollm-360m parameters = the flat buffer

# kernel -> (source, the Pallas call site it replaces)
KERNELS = {
    "block_topk": ("src/repro_torch/csrc/topk_block.cu",
                   "src/repro/kernels/topk_block.py:49"),
    "scatter_agg": ("src/repro_torch/csrc/scatter_agg.cu",
                    "src/repro/kernels/scatter_agg.py:74"),
    "quantize_ef_pack": ("src/repro_torch/csrc/quantize_ef_pack.cu",
                         "src/repro/kernels/quantize_ef_pack.py:70"),
    "unpack_mma": ("src/repro_torch/csrc/unpack_mma.cu",
                   "src/repro/kernels/unpack_mma.py:59"),
    "segment_rows": ("src/repro_torch/csrc/segment_rows.cu",
                     "src/repro/kernels/scatter_agg.py:116"),
    "quantize_ef": ("src/repro_torch/csrc/quantize_ef.cu",
                    "src/repro/kernels/quantize_ef.py:39"),
    "switch_blend": ("src/repro_torch/csrc/switch_blend.cu",
                     "src/repro/kernels/switch_blend.py:34"),
}
# uplink -> (encode kernel, reduce kernel)
PHASE_KERNELS = {"quant": ("quantize_ef_pack", "unpack_mma"),
                 "topk": ("block_topk", "scatter_agg")}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Mean milliseconds of ``fn()`` on the card: one warm-up call, then
    REPS calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def interleaved_ms(torch, fns: dict, pairs: int = 20) -> dict:
    """Each of ``fns`` timed alternately on the same inputs: REPS warm-up
    calls of each, then ``pairs`` rounds of one call of each between two
    CUDA events.  Returns ``{name: {"median", "min", "max"}}`` in ms."""
    for fn in fns.values():
        for _ in range(REPS):
            fn()
    times = {name: [] for name in fns}
    for _ in range(pairs):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: {"median": sorted(t)[len(t) // 2], "min": min(t),
                   "max": max(t), "pairs": pairs}
            for name, t in times.items()}


def bound_ms(nbytes: float, ops: float):
    """The larger of the bytes over the card's memory rate and the float32
    operations over its peak (``launch/roofline.py``'s H100 table)."""
    from repro_torch.launch.roofline import F32_OPS_PER_S, HBM_BYTES_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want) -> float:
    """Integer outputs must be equal; the largest float difference."""
    err = 0.0
    for a, b in zip(got, want):
        if a.dtype.is_floating_point:
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        else:
            if a.dtype in (torch.uint16, torch.uint32):
                signed = torch.int16 if a.dtype == torch.uint16 \
                    else torch.int32
                a, b = a.view(signed), b.view(signed)
            if not torch.equal(a, b):
                raise AssertionError("integer outputs differ")
    return err


def check_kernels(torch, dev, layout):
    """Phase 3: each kernel at the main path's shapes (every run, n = 4)
    against its plain version, with timings.  Returns {name: record}."""
    from repro_torch.comm import payloads
    from repro_torch.comm.flat import run_view
    from repro_torch.kernels import (quantize_ef_pack, scatter_agg,
                                     topk_block, unpack_mma)
    runs = layout.runs
    n = N_CLIENTS
    d = sum(r.span for r in runs)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def record(name, kernel, plain, library, nbytes, ops, tol):
        """``kernel()`` / ``plain()`` return one tuple of outputs per run."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max(max_err(torch, a, b) for a, b in zip(got, want))
        if err > tol:
            raise AssertionError(f"{name}: max |kernel - plain| = {err} "
                                 f"> {tol}")
        del got, want
        bnd, by = bound_ms(nbytes, ops)
        rec = {"name": name, "route": "cuda", "source": KERNELS[name][0],
               "replaces": KERNELS[name][1], "max_abs_err": err,
               "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
               "bound_ms": bnd, "bound_by": by,
               "library_ms": (time_ms(torch, library)
                              if library is not None else None)}
        print(json.dumps({"kernel_check": rec, "tolerance": tol}), flush=True)
        out[name] = rec
        return rec

    # -- top-k encode and select reduce (one round: 8 runs) ---------------
    x = torch.randn((n, d), generator=g, device=dev)
    xs = [run_view(x, r) for r in runs]
    record("block_topk",
           lambda: [topk_block.block_topk(v, r.k) for v, r in zip(xs, runs)],
           lambda: [topk_block.block_topk_plain(v, r.k)
                    for v, r in zip(xs, runs)],
           None, sum(n * r.nblocks * (4 * r.block + 8 * r.k) for r in runs),
           sum(n * r.nblocks * r.block for r in runs), 0.0)
    absx = [v.abs() for v in xs]
    out["block_topk"]["library_ms"] = time_ms(
        torch, lambda: [torch.topk(a, r.k, dim=-1) for a, r in
                        zip(absx, runs)])
    del absx
    out["block_topk"]["variants"] = [topk_block.variant(v, r.k)
                                     for v, r in zip(xs, runs)]
    print(json.dumps({"block_topk_variants": [
        {"block": r.block, "k": r.k, "rows": n * r.nblocks, "variant": w}
        for r, w in zip(runs, out["block_topk"]["variants"])]}), flush=True)
    sel = [topk_block.block_topk(v, r.k) for v, r in zip(xs, runs)]
    check_topk_special_rows(torch, xs, runs)
    del x, xs
    vals = [v for v, _ in sel]
    idx = [payloads.to_u16(i) for _, i in sel]
    del sel
    weight = torch.ones(n, device=dev)
    pos = [(torch.arange(r.nblocks, device=dev)[:, None] * r.block
            + payloads.u16_to_i64(i)).reshape(-1) for i, r in zip(idx, runs)]
    wv = [(v * weight[:, None, None]).reshape(-1) for v in vals]
    accs = [torch.zeros(r.nblocks * r.block, device=dev) for r in runs]
    # both add in slot order (no duplicate offsets in top-k payloads)
    record("scatter_agg",
           lambda: [(scatter_agg.scatter_agg(v, i, weight, r.block),)
                    for v, i, r in zip(vals, idx, runs)],
           lambda: [(scatter_agg.scatter_agg_plain(v, i, weight, r.block),)
                    for v, i, r in zip(vals, idx, runs)],
           lambda: [a.index_add_(0, p, s) for a, p, s in zip(accs, pos, wv)],
           sum(n * r.nblocks * r.k * 6 + 4 * n + r.nblocks * r.block * 4
               for r in runs),
           sum(2 * n * r.nblocks * r.k for r in runs), 0.0)
    check_weighted(torch, "scatter_agg", [
        (lambda w, v=v, i=i, r=r: scatter_agg.scatter_agg(v, i, w, r.block),
         lambda w, v=v, i=i, r=r: scatter_agg.scatter_agg_plain(v, i, w,
                                                                r.block),
         f"block={r.block} k={r.k} rows={n * r.nblocks}")
        for v, i, r in zip(vals, idx, runs)], dev)
    del vals, idx, pos, wv, accs

    # -- fused quant encode and unpack reduce (8-bit main path) -----------
    e = torch.randn((n, d), generator=g, device=dev) * 0.01
    delta = torch.randn((n, d), generator=g, device=dev)
    es = [run_view(e, r) for r in runs]
    ds = [run_view(delta, r) for r in runs]
    record("quantize_ef_pack",
           lambda: [quantize_ef_pack.quantize_ef_pack(a, b, 8)
                    for a, b in zip(es, ds)],
           lambda: [quantize_ef_pack.quantize_ef_pack_plain(a, b, 8)
                    for a, b in zip(es, ds)],
           None,
           sum(n * r.nblocks * (12 * r.block + 4 * r.W + 4) for r in runs),
           sum(8 * n * r.nblocks * r.block for r in runs), 0.0)
    msgs = [quantize_ef_pack.quantize_ef_pack(a, b, 8)[:2]
            for a, b in zip(es, ds)]
    record("unpack_mma",
           lambda: [(unpack_mma.unpack_mma(w, s[..., 0], weight, 8,
                                           r.block),)
                    for (w, s), r in zip(msgs, runs)],
           lambda: [(unpack_mma.unpack_mma_plain(w, s[..., 0], weight, 8,
                                                 r.block),)
                    for (w, s), r in zip(msgs, runs)],
           None,
           sum(n * r.nblocks * (4 * r.W + 4) + 4 * n + 4 * r.nblocks * r.block
               for r in runs),
           sum(3 * n * r.nblocks * r.block for r in runs), 0.0)
    check_weighted(torch, "unpack_mma", [
        (lambda w, ws=ws, r=r: unpack_mma.unpack_mma(
            ws[0], ws[1][..., 0], w, 8, r.block),
         lambda w, ws=ws, r=r: unpack_mma.unpack_mma_plain(
            ws[0], ws[1][..., 0], w, 8, r.block),
         f"bits=8 block={r.block} rows={n * r.nblocks}")
        for ws, r in zip(msgs, runs)], dev)
    del msgs
    # 2 and 4 bits on the largest run: checked, not timed
    big = max(range(len(runs)), key=lambda i: runs[i].nblocks * runs[i].block)
    for bits in (2, 4):
        got = quantize_ef_pack.quantize_ef_pack(es[big], ds[big], bits)
        want = quantize_ef_pack.quantize_ef_pack_plain(es[big], ds[big], bits)
        err = max_err(torch, got, want)
        acc = unpack_mma.unpack_mma(got[0], got[1][..., 0], weight, bits,
                                    runs[big].block)
        acc_plain = unpack_mma.unpack_mma_plain(got[0], got[1][..., 0],
                                                weight, bits, runs[big].block)
        err = max(err, max_err(torch, [acc], [acc_plain]))
        if err != 0.0:
            raise AssertionError(f"{bits}-bit quant kernels differ: {err}")
        print(json.dumps({"kernel_check": f"quantize_ef_pack+unpack_mma "
                          f"bits={bits} block={runs[big].block} rows="
                          f"{n * runs[big].nblocks}", "max_abs_err": err}),
              flush=True)
    del e, delta, es, ds
    torch.cuda.empty_cache()
    check_gather_kernels(torch, dev, layout, d, g, record)
    return out


# phase 3: aggregation weights that are not 0/1 -- Horvitz-Thompson weights
# of the weighted sampler, one of them 0 (a client off the support)
HT_WEIGHTS = [1.375, 0.0, 0.62, 2.9]


def check_weighted(torch, name, cases, dev):
    """Phase 3: a reduce kernel with the non-unit weights ``HT_WEIGHTS``
    against its plain version at every run's shapes, tolerance 0 (the
    rounding order of ``weight * scale / L`` and of ``weight * v``)."""
    w = torch.tensor(HT_WEIGHTS, device=dev)
    for kernel, plain, shape in cases:
        err = max_err(torch, [kernel(w)], [plain(w)])
        print(json.dumps({"kernel_check": f"{name} weights={HT_WEIGHTS} "
                          f"{shape}", "max_abs_err": err, "tolerance": 0.0}),
              flush=True)
        if err != 0.0:
            raise AssertionError(f"{name} with weights {HT_WEIGHTS} "
                                 f"differs ({shape}): {err}")


def check_topk_special_rows(torch, xs, runs):
    """Phase 3: ``block_topk`` on the largest run of the widest block with
    rows of ties and rows of NaNs written into its view (tolerance 0; the
    values compared as bits, so NaN payloads count)."""
    from repro_torch.kernels import topk_block
    top = max(r.block for r in runs)
    i = max((i for i, r in enumerate(runs) if r.block == top),
            key=lambda i: runs[i].nblocks)
    v, r = xs[i], runs[i]
    v[0, 0] = 1.5                                   # all magnitudes tie
    v[0, 0, ::3] = -1.5
    v[0, 1] = torch.round(v[0, 1] * 2) / 2          # ties at T
    v[0, 2] = 0.0
    v[0, 2, ::2] = -0.0
    v[0, 3] = v[0, 3] * torch.pow(10.0, v[0, 4] * 8)   # many binades
    pos = torch.arange(r.block, device=v.device, dtype=torch.int32)
    v[1, 0].view(torch.int32).copy_(0x7FC00000 + pos)   # payload rises
    v[1, 1, ::2].view(torch.int32).copy_(
        -0x3E0000 - pos[::2])                       # -NaNs 0xFFC2...
    v[1, 1, 1::7] = float("inf")
    v[1, 2, ::5].view(torch.int32).fill_(0x7FC00001)
    v[1, 2, 1::5].view(torch.int32).fill_(0x7FC00000)
    got = topk_block.block_topk(v, r.k)
    want = topk_block.block_topk_plain(v, r.k)
    err = max_err(torch, [got[0].view(torch.int32), got[1]],
                  [want[0].view(torch.int32), want[1]])
    print(json.dumps({"kernel_check": f"block_topk ties and NaNs block="
                      f"{r.block} k={r.k} rows={v.shape[0] * v.shape[1]} "
                      f"variant={topk_block.variant(v, r.k)}",
                      "max_abs_err": err}), flush=True)


def check_gather_kernels(torch, dev, layout, d, g, record):
    """Phase 3, second part: ``segment_rows`` at one gather round's shapes
    (m = 4 rows into n = 8: the top-k values, then the ``[4, d]`` deltas of
    ``delta_norm``), and ``quantize_ef`` / ``switch_blend`` on the flat
    ``[d]`` buffer (their ``kernels.ops`` entry points block it by 1024 and
    take it whole)."""
    from repro_torch.kernels import quantize_ef, ref, scatter_agg, switch_blend
    m, n = M_GATHER, N_GATHER
    idx = torch.tensor([1, 2, 5, 7], device=dev)     # sorted, unique
    vals = torch.randn((m, layout.K_total), generator=g, device=dev)
    deltas = torch.randn((m, d), generator=g, device=dev)
    rows = (vals, deltas)
    sinks = [torch.zeros((n, r.shape[1]), device=dev) for r in rows]
    # unique ids: bit-equal (rows add in the same order)
    record("segment_rows",
           lambda: [(scatter_agg.segment_rows(r, idx, n),) for r in rows],
           lambda: [(scatter_agg.segment_rows_plain(r, idx, n),)
                    for r in rows],
           lambda: [o.index_add_(0, idx, r) for o, r in zip(sinks, rows)],
           sum(4 * (m + n) * r.shape[1] + 8 * m for r in rows),
           sum(m * r.shape[1] for r in rows), 0.0)
    del sinks
    # duplicate and out-of-range ids, and the quant phase's scales: checked
    scales = torch.rand((m, layout.NB_total), generator=g, device=dev)
    for name, r, ids in (
            ("values, ids [3, 3, 9, -1]", vals,
             torch.tensor([3, 3, 9, -1], device=dev)),
            ("quant scales", scales, idx)):
        err = max_err(torch, [scatter_agg.segment_rows(r, ids, n)],
                      [scatter_agg.segment_rows_plain(r, ids, n)])
        if err != 0.0:
            raise AssertionError(f"segment_rows ({name}) differs: {err}")
        print(json.dumps({"kernel_check": f"segment_rows {name} rows="
                          f"{tuple(r.shape)} n={n}", "max_abs_err": err}),
              flush=True)
    del vals, deltas, rows, scales
    torch.cuda.empty_cache()

    nb = -(-d // 1024)
    e = torch.randn((nb, 1024), generator=g, device=dev) * 0.01
    delta = torch.randn((nb, 1024), generator=g, device=dev)
    record("quantize_ef",
           lambda: [quantize_ef.quantize_ef(e, delta, 8)],
           lambda: [ref.quantize_ef_ref(e, delta, 8)],
           None, 16 * nb * 1024, 9 * nb * 1024, 0.0)
    del e, delta
    torch.cuda.empty_cache()

    gf = torch.randn(d, generator=g, device=dev)
    gg = torch.randn(d, generator=g, device=dev)
    sigma = torch.tensor(0.3, device=dev)
    rec = record("switch_blend",
                 lambda: [(switch_blend.switch_blend(gf, gg, sigma),)],
                 lambda: [(switch_blend.switch_blend_plain(gf, gg, sigma),)],
                 lambda: torch.lerp(gf, gg, sigma), 12 * d, 3 * d, 0.0)
    rec["interleaved"] = interleaved_ms(torch, {
        "switch_blend": lambda: switch_blend.switch_blend(gf, gg, sigma),
        "torch.lerp": lambda: torch.lerp(gf, gg, sigma)})
    print(json.dumps({"switch_blend_vs_lerp": rec["interleaved"]}),
          flush=True)
    del gf, gg
    torch.cuda.empty_cache()


# phase 4: (name, launcher arguments, compressed downlink, FedConfig changes)
REFERENCE_CASES = [
    ("pallas quant", ["--comm", "pallas", "--uplink", "quant"], False, {}),
    ("pallas topk", ["--comm", "pallas", "--uplink", "topk"], False, {}),
    ("dense topk up/down", ["--uplink", "topk"], True, {}),
    ("dense quant up/down", ["--uplink", "quant"], True, {}),
    ("packed topk up/down", ["--comm", "packed", "--uplink", "topk"], True,
     {}),
    ("packed quant up/down", ["--comm", "packed", "--uplink", "quant"], True,
     {}),
    ("packed quant6 up/down (dense fallback)",
     ["--comm", "packed", "--uplink", "quant"], True, {"bits": 6}),
    ("penalty-fedavg dense topk", ["--uplink", "topk", "--strategy",
                                   "penalty-fedavg"], False, {}),
    ("centralized-sgm dense topk", ["--uplink", "topk", "--clients", "1",
                                    "--strategy", "centralized-sgm"], False,
     {}),
]
# phase 4: random kinds, checked for finite values and contraction only
RANDOM_CASES = [("packed randk up/down", "packed", "randk"),
                ("dense natural up/down", "dense", "natural")]


def reference_case(torch, argv, downlink, device="cpu", seq=16, **over):
    """The launcher's reduced setup on ``device`` for ``argv``, with the
    uplink's compressor changed by ``over`` (kind, bits) and, with
    ``downlink``, the same compressor on the downlink."""
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    from repro_torch.launch import train
    state, _, loss_pair, fed, cfg, _ = train.setup(train.parser().parse_args(
        ["--reduced", "--seq", str(seq), "--device", device] + argv))
    cc = dataclasses.replace(fed.uplink, **over)
    fed = fed.replace(uplink=cc, downlink=cc if downlink else fed.downlink)
    state = rounds.init_state(flat.unflatten(state.spec, state.w), fed,
                              device=device)
    return state, loss_pair, fed, cfg


def reference_check(torch):
    """Phase 4: one reduced round on the card against the same round on the
    CPU (plain versions) for each wire, strategy and kind of
    ``REFERENCE_CASES``; the random kinds of ``RANDOM_CASES`` must give a
    finite round and a contractive compressor."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.comm import flat, transports
    from repro_torch.engine import rounds
    from repro_torch.tasks import lm
    for name, argv, downlink, over in REFERENCE_CASES:
        state, loss_pair, fed, cfg = reference_case(torch, argv, downlink,
                                                    **over)
        nc = fed.n_clients
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (nc, 2, 16)))
        mask = torch.zeros((nc, 2, 16))
        mask[..., -2:] = 1.0
        res = {}
        for device in ("cuda", "cpu"):
            on = state._replace(**{f: getattr(state, f).to(device) for f in
                                   ("w", "x", "e_up", "wbar_sum",
                                    "wbar_weight")
                                   if getattr(state, f) is not None})
            if on.x is not None:
                on = on._replace(x=on.w)
            new, met = rounds.round_step(
                on, lm.LMBatch(toks.to(device), mask.to(device)), loss_pair,
                fed, device=device)
            res[device] = (new.w.cpu(), float(met.f), float(met.g_hat))
        far = ~torch.isclose(res["cuda"][0], res["cpu"][0], rtol=1e-4,
                             atol=1e-6)
        ok = (math.isclose(res["cuda"][1], res["cpu"][1], rel_tol=1e-4)
              and math.isclose(res["cuda"][2], res["cpu"][2], rel_tol=1e-4)
              and float(far.float().mean()) <= 1e-3)
        print(json.dumps({"reference_check": name, "comm": fed.comm,
                          "strategy": fed.strategy,
                          "f": [res["cuda"][1], res["cpu"][1]],
                          "g_hat": [res["cuda"][2], res["cpu"][2]],
                          "w_far_fraction": float(far.float().mean()),
                          "ok": ok}), flush=True)
        if not ok:
            raise AssertionError(f"reduced round ({name}): card and CPU "
                                 "disagree")
    for name, comm, kind in RANDOM_CASES:
        state, loss_pair, fed, cfg = reference_case(
            torch, ["--comm", comm], True, device="cuda", kind=kind)
        cc = fed.uplink
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2, 16)))
        mask = torch.zeros((4, 2, 16))
        mask[..., -2:] = 1.0
        new, met = rounds.round_step(
            state, lm.LMBatch(toks.cuda(), mask.cuda()), loss_pair, fed,
            device="cuda")
        up = flat.FlatTransport(transports.get_transport(
            cc, transports.backend_for(comm)), state.spec)
        x = torch.randn(state.spec.d, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
        cx = up.decompress(up.compress(
            x, transports.WireKey(0, 0, 0).generator(0, x.device)))
        ratio = float(((cx - x) ** 2).sum() / (x ** 2).sum())
        ok = (math.isfinite(float(met.f)) and math.isfinite(float(met.g_hat))
              and bool(torch.isfinite(new.w).all()) and ratio < 1.0)
        print(json.dumps({"random_check": name, "f": float(met.f),
                          "g_hat": float(met.g_hat),
                          "contraction_gap_ratio": ratio, "ok": ok}),
              flush=True)
        if not ok:
            raise AssertionError(f"reduced round ({name}): not finite or "
                                 "not contractive")
    kernels.reset_launches()


def setup_phase(torch, argv, downlink: bool, cfg=None, **fed_over):
    """The launcher's ``setup`` for ``argv`` (``cfg``, when given, in place
    of ``--arch``'s config); with ``downlink`` the uplink's compressor runs
    on the downlink too, and ``fed_over`` changes the FedConfig, through
    the engine API (the launcher keeps the identity downlink, as the
    reference's does)."""
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    from repro_torch.launch import train
    state, batch_fn, loss_pair, fed, cfg, dev = train.setup(
        train.parser().parse_args(argv), cfg)
    fed = fed.replace(**fed_over)
    if downlink:
        from repro_torch.sharding import partition
        fed = fed.replace(downlink=fed.uplink)
        params = flat.unflatten(state.spec, partition.whole(state.w))
        plan = state.plan
        del state
        state = rounds.init_state(params, fed, device=dev, plan=plan)
        del params
    return state, batch_fn, loss_pair, fed, dev


def expected_launches(fed, runs: int) -> dict:
    """Kernel launches per round that the wire layout demands: on
    ``comm="pallas"`` the uplink kind's encode kernel once per run and
    compressed direction, and once more for a slot store's eviction flush
    (present when its capacity is below n); the reduce kernel once per run
    and cohort on the pallas and packed wires (the reference reaches
    neither on its dense wire), twice in an async round (the fresh
    messages, then the buffer's), and once more per run for the flush
    (a single-tier reduce); in a gather round ``segment_rows`` twice (the
    message's float field and the ``delta_norm`` deltas), once with
    ``lean_metrics``."""
    enc, red = PHASE_KERNELS[fed.uplink.kind]
    flush = int(0 < fed.scale.ef_slots < fed.n_clients)
    want = {}
    if fed.comm == "pallas":
        want[enc] = runs * (1 + (fed.downlink.kind != "none") + flush)
    if fed.comm in ("pallas", "packed"):
        # an async round reduces twice: the fresh messages and the buffer
        want[red] = runs * (fed.scale.cohorts
                            * (2 if fed.async_.enabled else 1) + flush)
    if fed.participation == "gather":
        want["segment_rows"] = 1 if fed.lean_metrics else 2
    return want


def train_phase(torch, name: str, argv, T: int, downlink: bool = False,
                fleet_fn=None, after=None, cfg=None, d_want=D_FULL,
                digest: bool = False, **fed_over):
    """Phases 5, 7, 8, 9, 13 and 14: full-width training rounds through the
    launcher's setup (``cfg`` in place of ``--arch``'s config where depth
    is cut; the flat buffer must hold ``d_want`` parameters) and
    ``run_rounds``, on per-round batches or on a
    client fleet (the launcher's ``--fleet``, or ``fleet_fn(fed, dev)``
    through the engine API); returns the phase record (launch
    counts included, and the fields ``after(state, hist, batches,
    loss_pair, fed, dev)`` returns, called last; with ``digest``, the
    final state's :func:`state_digest` for phase 21).  Every kernel must
    launch as often as the wire layout demands, no other kernel may
    launch, and ``loss_pair`` must run once per forward of the round (fused
    or not); on a fleet every provisioned row must lie below its client's
    count."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.comm import flat
    from repro_torch.engine import participation, rounds, strategies
    from repro_torch.fleet import provision
    state, batch_fn, pair, fed, dev = setup_phase(torch, argv, downlink, cfg,
                                                  **fed_over)
    if fleet_fn is not None:
        batch_fn = fleet_fn(fed, dev)
    fleet = batch_fn if isinstance(batch_fn, provision.Fleet) else None
    batches = batch_fn if fleet is None else (lambda t, g: fleet)
    if state.spec.d != d_want:
        raise AssertionError(f"d = {state.spec.d}, expected {d_want}")
    up, down = rounds.flat_transports_for(fed, state.spec)
    runs = len(flat.wire_layout(state.spec, fed.uplink).runs)
    want = expected_launches(fed, runs)
    part = participation.finalize(torch.ones(fed.n_clients), None, fed)
    fused = rounds.fuses(part, strategies.get_strategy(fed.strategy), fed)
    local = fed.m if fed.participation == "gather" else fed.n_clients
    want_pairs = local * fed.local_steps + (0 if fused else fed.n_clients)
    calls = []

    def loss_pair(params, batch):
        calls.append(1)
        return pair(params, batch)

    stamps = []

    def timed_batches(t, gen):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return batches(t, gen)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with (FleetRecorder(fed.fleet.sampler) if fleet is not None
          else contextlib.nullcontext()) as seen:
        state, hist = rounds.run_rounds(state, timed_batches, loss_pair, fed,
                                        T=T, device=dev)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    counts = kernels.launch_counts()
    per_round = [b - a for a, b in zip(stamps, stamps[1:])]
    final = state_digest(torch, state, hist, fed) if digest else None
    samples = state_samples(torch, state, hist) if digest else None
    rec = {"phase": name, "d": state.spec.d, "comm": fed.comm,
           "clients": fed.n_clients, "participating": fed.m,
           "participation": fed.participation, "full_eval": fed.full_eval,
           "fused": fused, "uplink": fed.uplink.kind,
           "downlink": fed.downlink.kind,
           "rounds": T, "s_per_round": per_round,
           "s_per_round_after_first": (sum(per_round[1:]) / (T - 1)
                                       if T > 1 else None),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "f": hist.f.tolist(), "g_hat": hist.g_hat.tolist(),
           "sigma": hist.sigma.tolist(), "up_bytes": int(hist.up_bytes[0]),
           "down_bytes": int(hist.down_bytes[0]),
           "up_wire_bytes": up.wire_bytes(),
           "down_wire_bytes": down.wire_bytes(),
           "loss_pair_per_round": len(calls) / T,
           "loss_pair_per_round_expected": want_pairs,
           "alloc_retries": torch.cuda.memory_stats().get(
               "num_alloc_retries", 0),
           "launches": counts, "launches_per_round_expected": want}
    if fleet is not None:
        rec.update(seen.check(fleet, fed, T))
    print(json.dumps(rec), flush=True)
    if final is not None:
        rec["digest"] = final
        rec["samples"] = samples
    if not (all(math.isfinite(v) for v in rec["f"])
            and all(math.isfinite(v) for v in rec["g_hat"])):
        raise AssertionError(f"{name}: non-finite f or g_hat")
    # RoundMetrics holds the bytes as float32 (as the reference does), which
    # rounds counts above 2^24
    for field, t in (("up_bytes", up), ("down_bytes", down)):
        if not (getattr(hist, field) == np.float32(t.wire_bytes())).all():
            raise AssertionError(f"{name}: {field} {rec[field]} is not the "
                                 f"wire's {t.wire_bytes()}")
    if len(calls) != want_pairs * T:
        raise AssertionError(f"{name}: loss_pair ran {len(calls)} times, "
                             f"expected {want_pairs * T}")
    for kname, cnt in counts.items():
        if cnt != want.get(kname, 0) * T:
            raise AssertionError(f"{name}: {kname} launched {cnt} times, "
                                 f"expected {want.get(kname, 0) * T}")
    if rec["peak_mem_gb"] >= 80:
        raise AssertionError(f"{name}: peak {rec['peak_mem_gb']} GB")
    rec["profile"] = profile_round(torch, state, batches, pair, fed, dev,
                                   rec["s_per_round_after_first"])
    print(json.dumps({"profile": name, **rec["profile"]}), flush=True)
    if after is not None:
        rec.update(after(state, hist, batches, pair, fed, dev))
    del state
    torch.cuda.empty_cache()
    return rec


class FleetRecorder:
    """Records, while active, every row draw of the fleet's provisioning
    (``provision.draw_rows``: the client ids and their rows) and the
    aggregation weights the ``sampler`` law returns (on the CPU, where the
    law draws: recording them costs no device sync)."""

    def __init__(self, sampler: str):
        self.sampler = sampler
        self.rows, self.weights = [], []

    def __enter__(self):
        from repro_torch.fleet import provision, samplers
        self._draw, self._cls = provision.draw_rows, type(
            samplers.get_sampler(self.sampler))
        self._sample = self._cls.sample

        def draw_rows(key, host_count, ids, b):
            rows = self._draw(key, host_count, ids, b)
            self.rows.append((list(ids), rows.clone()))
            return rows

        def sample(obj, *a, **kw):
            mask, weights, st = self._sample(obj, *a, **kw)
            self.weights.append(weights.tolist())
            return mask, weights, st
        provision.draw_rows = draw_rows
        self._cls.sample = sample
        return self

    def __exit__(self, *exc):
        from repro_torch.fleet import provision
        provision.draw_rows = self._draw
        self._cls.sample = self._sample

    def check(self, fleet, fed, T: int) -> dict:
        """Every provisioned row below its client's count (one draw of
        ``batch_size`` rows per provisioned client and round); returns the
        record's fleet fields."""
        counts = fleet.host_count.tolist()
        n_rows = 0
        for ids, rows in self.rows:
            if rows.shape != (len(ids), fed.fleet.batch_size):
                raise AssertionError(f"provisioned {tuple(rows.shape)} rows")
            for j, r in zip(ids, rows.tolist()):
                if not all(0 <= v < max(counts[j], 1) for v in r):
                    raise AssertionError(f"client {j}: row outside "
                                         f"[0, {counts[j]}): {r}")
                n_rows += len(r)
        if len(self.rows) != T or len(self.weights) != T:
            raise AssertionError(f"{len(self.rows)} provisionings and "
                                 f"{len(self.weights)} draws in {T} rounds")
        return {"fleet_counts": counts, "sampler": fed.fleet.sampler,
                "batch_size": fed.fleet.batch_size,
                "redraw": fed.fleet.redraw, "provisioned_rows": n_rows,
                "weights": self.weights,
                "weights_non_unit": any(w not in (0.0, 1.0)
                                        for ws in self.weights
                                        for w in ws)}


def gather_mask_check(torch, dev, R: int = 2, layers: int = 2):
    """Phase 6: gather against mask on the card, from the same weights,
    batches and recorded cohorts (``fixed`` sampler), for top-k and quant up
    and down at full width and ``layers`` layers: w, x, e_up and every
    per-round metric bit-equal."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                          FleetConfig, SwitchConfig)
    from repro_torch.data import synthetic
    from repro_torch.engine import rounds
    from repro_torch.fleet import samplers
    from repro_torch.models import build
    from repro_torch.tasks import lm
    cfg = dataclasses.replace(configs.get_config("smollm-360m"),
                              n_layers=layers)
    fns = build(cfg)
    loss_pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0)
    rng = np.random.default_rng(0)
    masks = np.zeros((R, N_GATHER), np.float32)
    for r in range(R):
        masks[r, rng.choice(N_GATHER, M_GATHER, replace=False)] = 1.0

    def batch_fn(t, g):
        toks, mask = synthetic.client_token_batches(
            g, N_GATHER, 2, 64, cfg.vocab, hetero=0.5, device=dev)
        return lm.LMBatch(tokens=toks, minority_mask=mask)

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    for kind, comm in (("topk", "pallas"), ("quant", "pallas"),
                       ("randk", "packed")):
        cc = CompressorConfig(kind=kind, ratio=0.1, bits=8)
        out = {}
        for mode in ("gather", "mask"):
            fed = FedConfig(
                n_clients=N_GATHER, m=M_GATHER, local_steps=1, lr=0.03,
                switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
                uplink=cc, downlink=cc, comm=comm, participation=mode,
                fleet=FleetConfig(sampler="fixed"))
            params = fns.init(torch.Generator(device=dev).manual_seed(0),
                              cfg, device=dev)
            state = rounds.init_state(params, fed, device=dev)
            del params
            state = state._replace(sampler=samplers.fixed_state(masks,
                                                                masks))
            out[mode] = rounds.run_rounds(state, batch_fn, loss_pair, fed,
                                          T=R, device=dev)
        (sg, hg), (sm, hm) = out["gather"], out["mask"]
        same_state = all(torch.equal(bits(getattr(sg, f)),
                                     bits(getattr(sm, f)))
                         for f in ("w", "x", "e_up"))
        same_metrics = bits_equal(torch, np, hg, hm)
        rec = {"gather_vs_mask": kind, "comm": comm, "d": sg.spec.d,
               "layers": layers,
               "rounds": R, "cohorts": masks.tolist(),
               "f": hg.f.tolist(), "g_hat": hg.g_hat.tolist(),
               "state_bit_equal": same_state,
               "metrics_bit_equal": same_metrics}
        print(json.dumps(rec), flush=True)
        if not (same_state and same_metrics):
            raise AssertionError(f"gather and mask differ ({kind} on "
                                 f"{comm})")
        del out, sg, sm
        torch.cuda.empty_cache()
    fleet_gather_mask_check(torch, dev, fns, cfg, loss_pair, R)


# phase 6: the ragged fleet's rows per client (a pool of 6 sequences);
# client 0's inclusion probability caps at 1, so the weights are not 0/1
FLEET_COUNTS = [6, 1, 2, 1, 3, 1, 1, 2]


def fleet_gather_mask_check(torch, dev, fns, cfg, loss_pair, R: int):
    """Phase 6, the fleet case: a ragged fleet (``FLEET_COUNTS`` valid rows
    of a pool of 6 sequences per client), the ``weighted`` sampler (its
    Horvitz-Thompson weights, not 0/1) and 2 fresh rows per client and
    round, top-k 0.1 up and down on ``comm="pallas"``: gather and mask
    bit-equal, state and every metric."""
    import numpy as np
    from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                          FleetConfig, SwitchConfig)
    from repro_torch.data import synthetic
    from repro_torch.engine import rounds
    from repro_torch.fleet import provision
    from repro_torch.tasks import lm
    toks, mask = synthetic.client_token_batches(
        torch.Generator().manual_seed(3), N_GATHER, 6, 64,
        cfg.vocab, hetero=0.5, device=dev)
    fleet = provision.from_stacked(lm.LMBatch(toks, mask),
                                   count=torch.tensor(FLEET_COUNTS))
    cc = CompressorConfig(kind="topk", ratio=0.1)
    out = {}
    for mode in ("gather", "mask"):
        fed = FedConfig(
            n_clients=N_GATHER, m=M_GATHER, local_steps=1, lr=0.03,
            switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
            uplink=cc, downlink=cc, comm="pallas", participation=mode,
            fleet=FleetConfig(sampler="weighted", batch_size=2,
                              redraw=True))
        params = fns.init(torch.Generator(device=dev).manual_seed(0), cfg,
                          device=dev)
        state = rounds.init_state(params, fed, device=dev)
        del params
        with FleetRecorder("weighted") as seen:
            out[mode] = rounds.drive(state, fleet, loss_pair, fed, T=R,
                                     device=dev)
        del state
        info = seen.check(fleet, fed, R)
    (sg, hg), (sm, hm) = out["gather"], out["mask"]
    same_state = all(torch.equal(getattr(sg, f).view(torch.int32),
                                 getattr(sm, f).view(torch.int32))
                     for f in ("w", "x", "e_up", "wbar_sum"))
    same_metrics = bits_equal(torch, np, hg, hm)
    rec = {"gather_vs_mask": "fleet topk", "comm": "pallas",
           "d": sg.spec.d, "rounds": R, **info, "f": hg.f.tolist(),
           "g_hat": hg.g_hat.tolist(), "state_bit_equal": same_state,
           "metrics_bit_equal": same_metrics}
    print(json.dumps(rec), flush=True)
    if not (same_state and same_metrics and info["weights_non_unit"]):
        raise AssertionError("fleet gather and mask differ (or the "
                             "weights were all 0/1)")
    del out, sg, sm
    torch.cuda.empty_cache()


# phase 6: redraws of one batch of tokens in the token-draw probe
TOKEN_PROBE_TRIALS = 600


def token_draw_probe(torch, dev, vocab: int) -> dict:
    """Phase 6, the token draws: ``TOKEN_PROBE_TRIALS`` redraws, from one
    seed, of the gather phases' per-round batch (``N_GATHER`` clients x 2
    sequences of 64 tokens, hetero 0.5), made step by step as
    ``synthetic.token_stream`` would make it on the card's generator (a
    draw the port refuses): the Zipf probabilities, their ``cumsum`` (the
    cumulative distribution a with-replacement ``multinomial`` samples
    from), the ``multinomial`` draw, the rare-half ``randint``.  Records,
    per step, how many distinct results the redraws gave (1 where the step
    reproduces).  The port's own draw (a CPU generator, moved to the card)
    must give one."""
    from repro_torch.data import synthetic
    zipfs = 1.2 + 0.5 * torch.linspace(-0.3, 0.3, N_GATHER)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=dev)
    seen = {k: set() for k in ("probs", "cumsum", "multinomial", "randint")}

    def key(ts):
        return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                       for t in ts)).digest()

    for _ in range(TOKEN_PROBE_TRIALS):
        gen = torch.Generator(device=dev).manual_seed(0)
        draw = {k: [] for k in seen}
        for a in zipfs.tolist():
            probs = ranks ** (-a)
            probs = probs / probs.sum()
            draw["probs"].append(probs)
            draw["cumsum"].append(torch.cumsum(probs, 0))
            draw["multinomial"].append(torch.multinomial(
                probs, 2 * 64, replacement=True, generator=gen))
            draw["randint"].append(torch.randint(
                vocab // 2, vocab, (2, 8), generator=gen, device=dev))
        for k, ts in draw.items():
            seen[k].add(key(ts))
    port = {key(synthetic.client_token_batches(
        torch.Generator().manual_seed(0), N_GATHER, 2, 64, vocab,
        hetero=0.5, device=dev)) for _ in range(TOKEN_PROBE_TRIALS)}
    rec = {"token_draw_probe": TOKEN_PROBE_TRIALS,
           "card_generator_distinct": {k: len(v) for k, v in seen.items()},
           "port_distinct": len(port)}
    print(json.dumps(rec), flush=True)
    if len(port) != 1:
        raise AssertionError(f"the port's token draws gave {len(port)} "
                             f"results in {TOKEN_PROBE_TRIALS} redraws")
    return rec


def zipf_token_fleet(torch, cfg):
    """Phase 9(a): a quantity-skewed token fleet through the engine API --
    ``build_fleet`` over 64 sequences of 64 tokens with the ``zipf``
    partitioner (a = 1.2, cap factor 4; ``fed.fleet`` carries the law)."""
    from repro_torch.data import synthetic
    from repro_torch.fleet import provision
    from repro_torch.tasks import lm

    def make(fed, dev):
        toks, mask = synthetic.token_stream(
            torch.Generator().manual_seed(1), 64, 64, cfg.vocab, device=dev)
        return provision.build_fleet(torch.Generator().manual_seed(2),
                                     lm.LMBatch(toks, mask), fed)
    return make


# phase 10: rounds of each card-vs-CPU Figure-1 check, then of the
# quickstart's parts: each Figure-1 run, each alpha of the sweep, the
# gather == mask check.  The phase is bound by the host (thousands of tiny
# launches a round): the quickstart's own 500 / 200 / 50 rounds took 358 s
# on an H100, so they are cut to keep the phase near a minute (and the
# whole script, with phase 11, near half its time limit); Figure 1 from 60
# to 40 when phase 16 came (a Figure-1 round took 0.16-0.31 s, the whole
# script 652-1080 s, on H100 hosts of different speeds), all three parts
# halved again (20 / 10 / 10) when phase 21 came, and again (10 / 5 / 5)
# when phase 23 came (the gates: finite values, gather == mask, the
# launches, card == CPU on the check's rounds)
NP_CHECK_ROUNDS = 2
NP_FIGURE1_ROUNDS = 10
NP_SWEEP_ROUNDS = 5
NP_ENGINE_ROUNDS = 5


def np_phase(torch, dev) -> dict:
    """Phase 10: the NP task of the paper's Figure 1 on the card.  First
    ``NP_CHECK_ROUNDS`` rounds (n = 20, m = 10, E = 5, top-k 0.1 up and
    down, the dense wire) on the card against the same rounds on the CPU,
    from the same shards and recorded cohorts (``fixed``), hard and soft;
    then the quickstart's three parts on the card (Figure 1 hard and soft,
    the Dirichlet alpha sweep with the weighted sampler, gather == mask),
    and one more Figure-1 round under the profiler.  The dense wire
    launches no wire kernel: only the gather rounds' ``segment_rows``,
    twice a round."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs.base import FleetConfig
    from repro_torch.engine import rounds
    from repro_torch.examples import quickstart
    from repro_torch.fleet import samplers
    from repro_torch.tasks import np_classification as npc
    data, _ = npc.make_dataset(torch.Generator().manual_seed(0), 20,
                               device="cpu")
    rng = np.random.default_rng(0)
    masks = np.zeros((NP_CHECK_ROUNDS, 20), np.float32)
    for r in range(NP_CHECK_ROUNDS):
        masks[r, rng.choice(20, 10, replace=False)] = 1.0
    out = {"check": []}
    for mode in ("hard", "soft"):
        fed = quickstart.fed_config(mode, 0.35, FleetConfig(sampler="fixed"))
        res = {}
        for device in ("cuda", "cpu"):
            state = rounds.init_state(npc.init_params(30, device), fed,
                                      device=device)
            state = state._replace(sampler=samplers.fixed_state(masks,
                                                                masks))
            state, hist = rounds.drive(
                state, npc.NPBatch(data.x.to(device), data.y.to(device)),
                npc.loss_pair, fed, T=NP_CHECK_ROUNDS, device=device)
            res[device] = (state.w.cpu(), hist)
        (w_c, h_c), (w_p, h_p) = res["cuda"], res["cpu"]
        far = ~torch.isclose(w_c, w_p, rtol=1e-4, atol=1e-6)
        ok = (np.allclose(h_c.f, h_p.f, rtol=1e-4, atol=0)
              and np.allclose(h_c.g_hat, h_p.g_hat, rtol=1e-4, atol=0)
              and np.allclose(h_c.sigma, h_p.sigma, rtol=1e-4, atol=1e-6)
              and float(far.float().mean()) <= 1e-3
              and bool(torch.isfinite(w_c).all()))
        rec = {"np_reference_check": mode, "rounds": NP_CHECK_ROUNDS,
               "f": [h_c.f.tolist(), h_p.f.tolist()],
               "g_hat": [h_c.g_hat.tolist(), h_p.g_hat.tolist()],
               "w_far_fraction": float(far.float().mean()), "ok": ok}
        print(json.dumps(rec), flush=True)
        out["check"].append(rec)
        if not ok:
            raise AssertionError(f"NP Figure-1 rounds ({mode}): card and "
                                 "CPU disagree")
    kernels.reset_launches()
    t0 = time.time()
    out["quickstart"] = {
        "figure1": [quickstart.run(mode, T=NP_FIGURE1_ROUNDS, device=dev)
                    for mode in ("hard", "soft")],
        "sweep": quickstart.fleet_demo(T=NP_SWEEP_ROUNDS, device=dev),
        "engine": quickstart.engine_demo(T=NP_ENGINE_ROUNDS, device=dev)}
    torch.cuda.synchronize()
    out["quickstart_s"] = time.time() - t0
    out["launches"] = kernels.launch_counts()
    fed = quickstart.fed_config("soft", 0.35, FleetConfig())
    fleet, _ = npc.make_fleet(torch.Generator().manual_seed(0), fed,
                              device=dev)
    state = rounds.init_state(npc.init_params(30, dev), fed, device=dev)
    out["profile"] = profile_round(
        torch, state, lambda t, g: fleet, npc.loss_pair, fed, dev,
        out["quickstart"]["figure1"][1]["s_per_round"])
    print(json.dumps({"np_quickstart": out["quickstart"],
                      "seconds": out["quickstart_s"],
                      "launches": out["launches"],
                      "profile": out["profile"]}), flush=True)
    for r in out["quickstart"]["figure1"] + out["quickstart"]["sweep"]:
        if not all(math.isfinite(r[k]) for k in ("f", "g_hat",
                                                  "mean_sigma")):
            raise AssertionError(f"NP quickstart: non-finite {r}")
    if not out["quickstart"]["engine"]["gather_equals_mask"]:
        raise AssertionError("NP quickstart: gather and mask rounds differ")
    want = {name: 0 for name in out["launches"]}
    want["segment_rows"] = 2 * NP_ENGINE_ROUNDS
    if out["launches"] != want:
        raise AssertionError(f"the NP rounds launched {out['launches']}, "
                             f"expected {want}")
    return out


# phase 11: the paper's other experiments.  The CMDP card-vs-CPU check's
# rounds and horizon; the CMDP example's rounds, in chunks of CMDP_CHUNK
# with an eval after each, and the fair example's rounds, both cut from
# their own 300 because they are bound by the host (a CMDP round is about
# 242,000 launches, 2.4-5.6 s on an H100 depending on its host; a fair
# round 0.05-0.12 s) to keep the script inside its time (the CMDP example
# 20 rounds until phase 12 came, 10 until phase 16 came, 5 until phase 22
# came; the fair example 60 until phase 16 came, 30 until phase 22 came;
# the LM example 3 rounds until phase 22 came);
# the weakly-convex measure's training rounds (the reference test's 150);
# the 100m LM example's rounds
CMDP_CHECK_ROUNDS = 2
CMDP_CHECK_HORIZON = 50
CMDP_ROUNDS = 1
CMDP_CHUNK = 1
FAIR_ROUNDS = 15
WC_ROUNDS = 150
LM100M_ROUNDS = 2


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def meta_spec(torch, cfg):
    """The flat spec of a model config, from ``meta`` tensors."""
    from repro_torch.comm import flat
    from repro_torch.models import build, common
    return flat.spec_of(common.meta_tree(build(cfg).param_shapes(cfg)))


def check_layout_kernels(torch, dev, name, layout, n, encode: bool):
    """Phase 11: the wire kernels at every run of a path's layout (n
    clients) where the path launches them, against their plain versions,
    tolerance 0: ``scatter_agg`` on top-k payloads with non-unit weights
    (runs of blocks > 1; a block of 1 is a weighted sum), and with
    ``encode`` also ``block_topk`` (the pallas wire's encode, for runs with
    k < block; the packed wire encodes with a library sort)."""
    from repro_torch.comm import payloads
    from repro_torch.kernels import scatter_agg, topk_block
    g = torch.Generator(device=dev).manual_seed(11)
    w = torch.rand(n, generator=g, device=dev) * 2
    for r in layout.runs:
        if r.block == 1:
            continue
        x = torch.randn((n, r.nblocks, r.block), generator=g, device=dev)
        want = topk_block.block_topk_plain(x, r.k)
        err = {}
        if encode and r.k < r.block:
            err["block_topk"] = max_err(torch, topk_block.block_topk(x, r.k),
                                        want)
        vals, idx = want[0], payloads.to_u16(want[1])
        err["scatter_agg"] = max_err(
            torch, [scatter_agg.scatter_agg(vals, idx, w, r.block)],
            [scatter_agg.scatter_agg_plain(vals, idx, w, r.block)])
        print(json.dumps({"kernel_check": f"{name}: block={r.block} k={r.k} "
                          f"rows={n * r.nblocks}", "max_abs_err": err,
                          "tolerance": 0.0}), flush=True)
        if any(err.values()):
            raise AssertionError(f"{name}: a kernel differs from its plain "
                                 f"version at block={r.block} k={r.k}: {err}")
        del x, want, vals, idx
    torch.cuda.empty_cache()


class RolloutRecorder:
    """Records, while active, every CMDP rollout's reward, cost and alive
    flags (on the CPU; for the card-vs-CPU check only)."""

    def __enter__(self):
        import torch
        from repro_torch.tasks import cmdp
        self._rollout, self.flags = cmdp.rollout, []

        def rollout(params, s0, noise):
            traj = self._rollout(params, s0, noise)
            self.flags.append(torch.stack([traj.rewards, traj.costs,
                                           traj.alive]).cpu())
            return traj
        cmdp.rollout = rollout
        return self

    def __exit__(self, *exc):
        from repro_torch.tasks import cmdp
        cmdp.rollout = self._rollout


def cmdp_check(torch, dev) -> list:
    """Phase 11(a): the CMDP example's FedConfig (10 clients, 7 sampled,
    soft switch, top-k 0.5 up) for CMDP_CHECK_ROUNDS rounds at horizon
    CMDP_CHECK_HORIZON, with cohorts recorded from one Markov draw and
    replayed (``fixed``), from the same fleet draws, on the card against
    the CPU: on ``comm="dense"`` (no kernel may launch) and on
    ``comm="pallas"`` (``block_topk`` once per run and round where k <
    block, ``scatter_agg`` where the block is wider than 1: 2 and 2 of the
    4 runs).  f, g_hat + the participants' mean budget (the mean cost) and
    sigma at rtol 1e-4, at most 1e-3 of w outside rtol 1e-4 / atol 1e-6;
    the reward, cost and alive flags that differ are printed."""
    from repro_torch import kernels
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    from repro_torch.examples import cmdp_cartpole
    from repro_torch.fleet import samplers
    from repro_torch.tasks import cmdp
    import numpy as np
    base = cmdp_cartpole.fed_config()
    n, R = base.n_clients, CMDP_CHECK_ROUNDS
    E, T = cmdp_cartpole.N_EPISODES, CMDP_CHECK_HORIZON
    markov = samplers.get_sampler("markov")
    gen, st, masks = torch.Generator().manual_seed(5), markov.init(base), []
    for _ in range(R):
        mask, _, st = markov.sample(gen, base, st)
        masks.append(mask)
    masks = torch.stack(masks)
    s0, noise = cmdp.fleet_draws(torch.Generator().manual_seed(1), n, 8, E, T)
    params = cmdp.init_params(torch.Generator().manual_seed(0), device="cpu")
    layout = flat.wire_layout(flat.spec_of(params), base.uplink)
    check_layout_kernels(torch, dev, "cmdp pallas", layout, n, encode=True)
    loss_pair = cmdp.fleet_loss_pair(E, T)
    b_bar = ((masks * cmdp.client_budgets(n)).sum(1) / base.m).numpy()
    out = []
    for comm in ("dense", "pallas"):
        fed = base.replace(comm=comm, fleet=dataclasses.replace(
            base.fleet, sampler="fixed"))
        res, secs = [], {}
        for device in (dev, torch.device("cpu")):
            t0 = time.time()
            fleet = cmdp.fleet_from_draws(s0, noise, device=device)
            state = rounds.init_state(to_device(params, device), fed,
                                      device=device)
            state = state._replace(sampler=samplers.fixed_state(masks,
                                                                masks))
            kernels.reset_launches()
            with RolloutRecorder() as seen:
                state, hist = rounds.drive(state, fleet, loss_pair, fed, T=R,
                                           device=device)
            if device is dev:
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
            secs[device.type] = time.time() - t0
            res.append((state.w.cpu(), hist, seen.flags))
        (w_c, h_c, f_c), (w_p, h_p, f_p) = res
        flips = [(i, int((a != b).sum())) for i, (a, b) in
                 enumerate(zip(f_c, f_p)) if not torch.equal(a, b)]
        far = ~torch.isclose(w_c, w_p, rtol=1e-4, atol=1e-6)
        want = {name: 0 for name in kernels.WRAPPERS}
        if comm == "pallas":
            want.update({"block_topk": R * sum(r.k < r.block
                                               for r in layout.runs),
                         "scatter_agg": R * sum(r.block > 1
                                                for r in layout.runs)})
        ok = (np.allclose(h_c.f, h_p.f, rtol=1e-4, atol=0)
              and np.allclose(h_c.g_hat + b_bar, h_p.g_hat + b_bar,
                              rtol=1e-4, atol=0)
              and np.allclose(h_c.sigma, h_p.sigma, rtol=1e-4, atol=1e-6)
              and float(far.float().mean()) <= 1e-3
              and bool(torch.isfinite(w_c).all()) and counts == want
              and len(f_c) == len(f_p))
        rec = {"cmdp_reference_check": comm, "rounds": R, "horizon": T,
               "cohorts": masks.tolist(), "f": [h_c.f.tolist(),
                                                h_p.f.tolist()],
               "g_hat": [h_c.g_hat.tolist(), h_p.g_hat.tolist()],
               "sigma": [h_c.sigma.tolist(), h_p.sigma.tolist()],
               "w_far_fraction": float(far.float().mean()),
               "rollouts": len(f_c), "rollouts_with_flag_flips": flips,
               "launches": counts, "launches_expected": want,
               "seconds": secs, "ok": ok}
        print(json.dumps(rec), flush=True)
        out.append({"phase": f"paper cmdp check {comm}", "launches": counts})
        if not ok:
            raise AssertionError(f"CMDP rounds on {comm}: card and CPU "
                                 "disagree, or the kernels launched "
                                 f"{counts}, expected {want}")
    return out


def cmdp_example(torch, dev) -> dict:
    """Phase 11(b): the CMDP example as the reference runs it (dense wire,
    horizon 200, 10 clients, Markov sampler), CMDP_ROUNDS rounds in chunks
    of CMDP_CHUNK with an eval of 10 episodes after each; then one more
    round under the profiler."""
    from repro_torch import kernels
    from repro_torch.engine import rounds
    from repro_torch.examples import cmdp_cartpole
    from repro_torch.tasks import cmdp
    kernels.reset_launches()
    t0 = time.time()
    chunks = cmdp_cartpole.main(rounds=CMDP_ROUNDS, chunk=CMDP_CHUNK,
                                device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = kernels.launch_counts()
    fed = cmdp_cartpole.fed_config()
    fleet = cmdp.make_fleet(torch.Generator().manual_seed(1), fed, pool=256,
                            device=dev)
    state = rounds.init_state(cmdp.init_params(
        torch.Generator().manual_seed(0), device=dev), fed, device=dev)
    spr = [c["s_per_round"] for c in chunks]
    prof = profile_round(torch, state, lambda t, g: fleet,
                         cmdp.fleet_loss_pair(cmdp_cartpole.N_EPISODES, 200),
                         fed, dev, sum(spr[1:]) / max(len(spr) - 1, 1))
    rec = {"cmdp_example": chunks, "rounds": CMDP_ROUNDS,
           "chunk": CMDP_CHUNK, "horizon": 200, "seconds": secs,
           "launches": counts, "profile": prof}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(c[k]) for c in chunks
               for k in ("reward", "cost", "sigma")):
        raise AssertionError(f"CMDP example: non-finite {chunks}")
    if any(counts.values()):
        raise AssertionError(f"CMDP example (dense wire) launched {counts}")
    return rec


def fair_example(torch, dev) -> dict:
    """Phase 11(c): the fair example (FedSGM at alpha 10 and 0.5, the
    penalty baseline at rho 0.1, 1 and 10), FAIR_ROUNDS rounds each, on the
    dense wire (no kernel may launch)."""
    from repro_torch import kernels
    from repro_torch.examples import fair_classification
    kernels.reset_launches()
    t0 = time.time()
    out = fair_classification.main(T=FAIR_ROUNDS, device=dev)
    torch.cuda.synchronize()
    rec = {"fair_example": out, "rounds": FAIR_ROUNDS,
           "seconds": time.time() - t0, "launches": kernels.launch_counts()}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(r[k]) for r in out["fedsgm"] + out["penalty"]
               for k in ("bce", "dp")):
        raise AssertionError(f"fair example: non-finite {out}")
    if any(rec["launches"].values()):
        raise AssertionError(f"fair example launched {rec['launches']}")
    return rec


def weakly_convex_check(torch, dev) -> dict:
    """Phase 11(d): Theorem 10's measure on NP (n = 4, eps 0.35, E = 2, no
    compression): ``stationarity`` at w_0 and after WC_ROUNDS rounds must
    fall below half (the reference's own test)."""
    from repro_torch import kernels
    from repro_torch.comm import flat
    from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                          SwitchConfig)
    from repro_torch.core import weakly_convex
    from repro_torch.engine import rounds
    from repro_torch.tasks import np_classification as npc
    data, _ = npc.make_dataset(torch.Generator().manual_seed(0), 4,
                               device=dev)
    fed = FedConfig(n_clients=4, m=4, local_steps=2, lr=0.1,
                    switch=SwitchConfig(mode="hard", eps=0.35),
                    uplink=CompressorConfig(kind="none"),
                    downlink=CompressorConfig(kind="none"))
    params = npc.init_params(30, device=dev)
    kernels.reset_launches()
    t0 = time.time()
    s0 = float(weakly_convex.stationarity(npc.loss_pair, data, params,
                                          eps=0.35))
    state = rounds.init_state(params, fed, device=dev)
    state, _ = rounds.drive(state, data, npc.loss_pair, fed, T=WC_ROUNDS,
                            device=dev)
    sT = float(weakly_convex.stationarity(
        npc.loss_pair, data, flat.unflatten(state.spec, state.w), eps=0.35))
    rec = {"weakly_convex": {"s0": s0, "sT": sT, "rounds": WC_ROUNDS},
           "seconds": time.time() - t0, "launches": kernels.launch_counts()}
    print(json.dumps(rec), flush=True)
    if not sT < 0.5 * s0:
        raise AssertionError(f"stationarity {sT} not below half of {s0}")
    return rec


def lm_100m_example(torch, dev) -> dict:
    """Phase 11(e): the LM example at ``--preset 100m`` (12 layers, d_model
    768, GQA 12/4, d_ff 2048, vocab 32000; packed wire, top-k 0.1 up and
    0.25 down in blocks of 2048, 8 clients, 6 sampled, mask mode, E = 2),
    LM100M_ROUNDS rounds: s/round, peak memory, and ``scatter_agg``
    launched once per uplink run and round (no other kernel), after
    ``scatter_agg`` is held against its plain version at that layout."""
    from repro_torch import kernels
    from repro_torch.comm import flat
    from repro_torch.examples import train_lm_federated
    cfg = train_lm_federated.get_cfg("100m")
    fed = train_lm_federated.fed_config()
    layout = flat.wire_layout(meta_spec(torch, cfg), fed.uplink)
    check_layout_kernels(torch, dev, "lm 100m packed", layout,
                         fed.n_clients, encode=False)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = train_lm_federated.main(rounds=LM100M_ROUNDS, preset="100m",
                                  chunk=1, device=dev)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {name: 0 for name in kernels.WRAPPERS}
    want["scatter_agg"] = LM100M_ROUNDS * sum(r.block > 1
                                              for r in layout.runs)
    rec = {"lm_100m_example": out, "rounds": LM100M_ROUNDS,
           "runs": len(layout.runs),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "launches_expected": want}
    print(json.dumps(rec), flush=True)
    if not all(math.isfinite(v) for v in out["f"] + out["g_hat"]):
        raise AssertionError(f"LM 100m example: non-finite {out}")
    if counts != want:
        raise AssertionError(f"LM 100m example launched {counts}, expected "
                             f"{want}")
    return rec


def paper_phase(torch, dev) -> tuple:
    """Phase 11: the paper's other experiments on the card, (a)-(e).
    Returns ``(records, launch records)``."""
    t0 = time.time()
    launches = cmdp_check(torch, dev)
    seconds, rec = {"11a": time.time() - t0}, {}
    for part, fn in (("cmdp_example", cmdp_example),
                     ("fair_example", fair_example),
                     ("weakly_convex", weakly_convex_check),
                     ("lm_100m", lm_100m_example)):
        t0 = time.time()
        rec[part] = fn(torch, dev)
        seconds[part] = time.time() - t0
    print(json.dumps({"paper_seconds": seconds}), flush=True)
    for name, part in (("paper cmdp example", "cmdp_example"),
                       ("paper fair example", "fair_example"),
                       ("paper weakly-convex", "weakly_convex"),
                       ("paper lm 100m", "lm_100m")):
        launches.append({"phase": name, "launches": rec[part]["launches"]})
    return rec, launches


# phase 12: asynchronous buffered rounds with the telemetry bus.  2 rounds
# a part at full width (6 until phase 22 came: the parks, deliveries and
# expiries the phase must see come from 12(c) as well); the checks of
# 12(c) at 2 layers, 2 rounds (3 until phase 23 came: (ii)'s parks and
# merges come in rounds 0 and 1, (iv)'s expiries in round 1, on an H100)
ASYNC_ROUNDS = 2
ASYNC_CHECK_ROUNDS = 2
CARD_CPU_ROUNDS = 2            # 12(c)(iv): parks in round 0, expiries in 1
ASYNC_COUNTERS = ("fresh", "departed", "merged", "dropped", "occupancy",
                  "max_age")
STAGE_PREFIXES = ("round.", "comm.", "kernel.")


def bits_equal(torch, np, a, b) -> bool:
    """Bit equality of two (nested) states, buffers or metric records:
    tensors and numpy arrays by their bits, None only to None."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        elif a.dtype in (torch.uint16, torch.uint32):
            signed = torch.int16 if a.dtype == torch.uint16 else torch.int32
            a, b = a.view(signed), b.view(signed)
        return a.shape == b.shape and torch.equal(a, b.to(a.device))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(
            a.view(np.uint32) if a.dtype == np.float32 else a,
            b.view(np.uint32) if b.dtype == np.float32 else b)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(bits_equal(torch, np, x, y)
                                        for x, y in zip(a, b))
    return a == b


class EventRecorder:
    """Records, while active, each round's cohort mask and mid-round events
    as the ``sampler`` law draws them (on the CPU, where it draws:
    recording costs no device sync)."""

    def __init__(self, sampler: str):
        self.sampler = sampler
        self.events = []

    def __enter__(self):
        from repro_torch.fleet import samplers
        self._cls = type(samplers.get_sampler(self.sampler))
        self._events = self._cls.events

        def events(obj, gen, cfg, mask, state=None):
            ev, st = self._events(obj, gen, cfg, mask, state)
            self.events.append((mask.tolist(), ev.depart.tolist(),
                                ev.arrive.tolist()))
            return ev, st
        self._cls.events = events
        return self

    def __exit__(self, *exc):
        self._cls.events = self._events


def replay_buffer(events, max_staleness: int) -> list:
    """The staleness buffer's bookkeeping replayed on the host, one client
    at a time, from recorded ``(mask, depart, arrive)`` events: per round
    the counters the engine reports (``fresh``, ``departed``, ``merged``,
    ``dropped``, ``occupancy``, ``max_age``) and the fates behind
    ``dropped`` (``expired``, ``overwritten``)."""
    n = len(events[0][0])
    occ, origin = [0] * n, [0] * n
    out = []
    for t, (mask, dep, arr) in enumerate(events):
        merged = expired = over = 0
        for j in range(n):
            if not occ[j]:
                continue
            if arr[j]:
                merged += 1
                occ[j] = 0
            elif t - origin[j] >= max_staleness:
                expired += 1
                occ[j] = 0
            elif dep[j]:
                over += 1
        for j in range(n):
            if dep[j]:
                occ[j], origin[j] = 1, t
        out.append({"fresh": sum(m * (1 - d) for m, d in zip(mask, dep)),
                    "departed": sum(dep), "merged": merged,
                    "dropped": expired + over, "occupancy": sum(occ),
                    "max_age": max([t - origin[j] for j in range(n)
                                    if occ[j]] or [0]),
                    "expired": expired, "overwritten": over})
    return out


def check_counters(name, hist, events, fed) -> list:
    """The engine's async counters against the host replay of the recorded
    events, exactly; returns the replay."""
    want = replay_buffer(events, fed.async_.max_staleness)
    for key in ASYNC_COUNTERS:
        got = [float(v) for v in getattr(hist, key)]
        if got != [float(r[key]) for r in want]:
            raise AssertionError(f"{name}: {key} {got} is not the host "
                                 f"replay's {[r[key] for r in want]}")
    return want


def check_stale_reduce(torch, name, up, buf, t, fed, g_hat) -> dict:
    """Phase 12: the reduce kernel on the rows the stale merge reduces --
    every slot of the final buffer: rows parked rounds ago, rows still all
    zero -- each weighted ``w_origin * lambda(s)`` at its age (fractional;
    0 for a slot that never parked), against its plain version, tolerance
    0, run by run."""
    from repro_torch.engine import strategies
    from repro_torch.kernels import scatter_agg, unpack_mma
    strat = strategies.get_strategy(fed.strategy)
    age = (t - buf.origin).to(torch.float32)
    w = buf.weight * strat.staleness_weight(age, buf.sigma, g_hat, fed)
    n = w.shape[0]
    err = 0.0
    for r in up.codec.layout.runs:
        if fed.uplink.kind == "quant":
            words = buf.msgs.words[:, r.woff:r.woff + r.nblocks * r.W] \
                .reshape(n, r.nblocks, r.W)
            scale = buf.msgs.scale[:, r.boff:r.boff + r.nblocks]
            got = unpack_mma.unpack_mma(words, scale, w, fed.uplink.bits,
                                        r.block)
            want = unpack_mma.unpack_mma_plain(words, scale, w,
                                               fed.uplink.bits, r.block)
        else:
            sl = slice(r.koff, r.koff + r.nblocks * r.k)
            vals = buf.msgs.values[:, sl].reshape(n, r.nblocks, r.k)
            idx = buf.msgs.indices[:, sl].reshape(n, r.nblocks, r.k)
            got = scatter_agg.scatter_agg(vals, idx, w, r.block)
            want = scatter_agg.scatter_agg_plain(vals, idx, w, r.block)
        err = max(err, max_err(torch, [got], [want]))
        del got, want
    rec = {"kernel_check": f"{name}: stale reduce of the final buffer",
           "weights": w.tolist(), "occupied": buf.occupied.tolist(),
           "max_abs_err": err, "tolerance": 0.0}
    print(json.dumps(rec), flush=True)
    if err != 0.0:
        raise AssertionError(f"{name}: the stale reduce kernel differs from "
                             f"its plain version: {err}")
    return rec


def stage_split(prof, path, prefixes=STAGE_PREFIXES) -> dict:
    """The device side of one profiled round, from the trace exported to
    ``path``: the round's device ms and launches (kernels, copies, sets),
    and per span name (``prefixes``: ``round.*``, ``comm.*``, ``kernel.*``
    by default; nested spans each count in full) ``device_ms``, the device
    time of the work launched
    while the span was open -- from any thread (the autograd engine
    launches the backward from its own), each launch matched to its device
    work by the trace's correlation ids -- and ``host_ms_profiled``, the
    span's wall time under the profiler."""
    import bisect
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    path.unlink()
    launch = {e["args"]["correlation"]: e["ts"] for e in evs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    work = sorted((launch.get(e.get("args", {}).get("correlation")),
                   e.get("dur", 0.0)) for e in evs
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    matched = [w for w in work if w[0] is not None]
    at = [w[0] for w in matched]
    cum = [0.0]
    for _, d in matched:
        cum.append(cum[-1] + d)
    spans = {}
    for e in evs:
        if e.get("cat") != "user_annotation" or \
                not e.get("name", "").startswith(prefixes):
            continue
        lo, hi = e["ts"], e["ts"] + e.get("dur", 0.0)
        o = spans.setdefault(e["name"], {"calls": 0, "device_ms": 0.0,
                                         "host_ms_profiled": 0.0})
        o["calls"] += 1
        o["host_ms_profiled"] += e.get("dur", 0.0) / 1e3
        o["device_ms"] += (cum[bisect.bisect_right(at, hi)]
                           - cum[bisect.bisect_left(at, lo)]) / 1e3
    total = sum(d for _, d in work) / 1e3
    staged = sum(v["device_ms"] for k, v in spans.items()
                 if k.startswith("round."))
    return {"device_ms": total, "launches": len(work),
            "launches_matched": len(matched),
            "round_spans_device_share": staged / total if total else None,
            "spans": spans}


class StageTimer:
    """Host wall time under each stage span of an unprofiled round: while
    active, the span helper of the modules that open spans also reads the
    host clock on enter and exit (no device sync)."""

    def __init__(self):
        self.ms, self.calls = {}, {}

    def __enter__(self):
        from repro_torch.comm import flat
        from repro_torch.engine import async_rounds, rounds
        from repro_torch.kernels import ops
        from repro_torch.obs import trace
        self._mods = (flat, async_rounds, rounds, ops)

        @contextlib.contextmanager
        def timed(name):
            t0 = time.perf_counter()
            with trace.stage(name):
                yield
            self.ms[name] = self.ms.get(name, 0.0) + \
                (time.perf_counter() - t0) * 1e3
            self.calls[name] = self.calls.get(name, 0) + 1
        for mod in self._mods:
            mod.stage = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.obs import trace
        for mod in self._mods:
            mod.stage = trace.stage


def profile_async_round(torch, state, buf, batches, loss_pair, fed, dev,
                        s_round) -> dict:
    """Two more async rounds: one with its host time per stage span
    (:class:`StageTimer`), one under ``torch.profiler`` for the device
    time, the launches, the busy share (as :func:`profile_round`) and the
    device time per span (:func:`stage_split`)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine import async_rounds
    b = batches(0, torch.Generator().manual_seed(7))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StageTimer() as timer:
        state, buf, _ = async_rounds.async_round_step(state, buf, b,
                                                      loss_pair, fed,
                                                      device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        async_rounds.async_round_step(state, buf, b, loss_pair, fed,
                                      device=dev)
        torch.cuda.synchronize()
    trace = ROOT / "build" / "trace_async_round.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    split = stage_split(prof, trace)
    for name, o in split["spans"].items():
        o["host_ms"] = timer.ms.get(name)
    return {"device_ms": split["device_ms"],
            "kernel_launches": split["launches"],
            "busy_share": split["device_ms"] / 1e3 / s_round
            if s_round else None,
            "timed_round_s": wall, **split}


def async_part(torch, name: str, argv, T: int, downlink: bool = True,
               **fed_over) -> dict:
    """Phase 12(a) and (b): full-width async rounds through the launcher's
    setup and ``async_rounds.async_run_rounds``: the counters against the
    host replay of the recorded events, the launches per round (the reduce
    kernel twice: the fresh messages and the buffer), ``loss_pair`` once
    per forward, finite f and g_hat, each round's counters and telemetry
    printed; then the stale reduce of the final buffer against its plain
    version and one profiled round with the per-stage split."""
    from repro_torch import kernels
    from repro_torch.engine import async_rounds, participation, rounds
    from repro_torch.engine import strategies
    from repro_torch.fleet import provision
    from repro_torch.obs import sinks
    t_part = time.time()
    state, batch_fn, pair, fed, dev = setup_phase(torch, argv, downlink,
                                                  **fed_over)
    fleet = batch_fn if isinstance(batch_fn, provision.Fleet) else None
    batches = batch_fn if fleet is None else (lambda t, g: fleet)
    if state.spec.d != D_FULL or not fed.async_.enabled:
        raise AssertionError(f"{name}: d = {state.spec.d}, async "
                             f"{fed.async_.enabled}")
    up, _ = rounds.flat_transports_for(fed, state.spec)
    want = expected_launches(fed, len(up.codec.layout.runs))
    part = participation.finalize(torch.ones(fed.n_clients), None, fed)
    fused = rounds.fuses(part, strategies.get_strategy(fed.strategy), fed)
    local = fed.m if fed.participation == "gather" else fed.n_clients
    want_pairs = local * fed.local_steps + (0 if fused else fed.n_clients)
    calls, stamps = [], []

    def loss_pair(params, batch):
        calls.append(1)
        return pair(params, batch)

    def timed_batches(t, gen):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return batches(t, gen)

    torch.cuda.reset_peak_memory_stats()
    with EventRecorder(fed.fleet.sampler) as rec_ev:
        kernels.reset_launches()
        state, buf, hist = async_rounds.async_run_rounds(
            state, timed_batches, loss_pair, fed, T=T, device=dev)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    stamps.append(time.perf_counter())
    per_round = [b - a for a, b in zip(stamps, stamps[1:])]
    replay = check_counters(name, hist, rec_ev.events, fed)
    rows = sinks.rows(hist)
    for r in rows:
        print(json.dumps({"async_round": name, **r}), flush=True)
    rec = {"phase": name, "d": state.spec.d, "comm": fed.comm,
           "clients": fed.n_clients, "participating": fed.m,
           "participation": fed.participation, "sampler": fed.fleet.sampler,
           "uplink": fed.uplink.kind, "downlink": fed.downlink.kind,
           "async": dataclasses.asdict(fed.async_), "obs": fed.obs.enabled,
           "rounds": T, "s_per_round": per_round,
           "s_per_round_after_first": sum(per_round[1:]) / (T - 1),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "f": hist.round.f.tolist(), "g_hat": hist.round.g_hat.tolist(),
           "counters": {k: getattr(hist, k).tolist()
                        for k in ASYNC_COUNTERS},
           "replay": replay, "events": rec_ev.events,
           "loss_pair_per_round": len(calls) / T,
           "loss_pair_per_round_expected": want_pairs,
           "launches": counts, "launches_per_round_expected": want}
    print(json.dumps({k: v for k, v in rec.items() if k != "events"}),
          flush=True)
    if not (all(math.isfinite(v) for v in rec["f"] + rec["g_hat"])):
        raise AssertionError(f"{name}: non-finite f or g_hat")
    if len(calls) != want_pairs * T:
        raise AssertionError(f"{name}: loss_pair ran {len(calls)} times, "
                             f"expected {want_pairs * T}")
    for kname, cnt in counts.items():
        if cnt != want.get(kname, 0) * T:
            raise AssertionError(f"{name}: {kname} launched {cnt} times, "
                                 f"expected {want.get(kname, 0) * T}")
    if fed.obs.enabled:
        tel = hist.round.telemetry
        if not all(math.isfinite(v) for leaf in tel for v in
                   leaf.reshape(-1).tolist()):
            raise AssertionError(f"{name}: non-finite telemetry")
        if tel.buf_stale_hist.sum(axis=1).tolist() != \
                hist.occupancy.tolist():
            raise AssertionError(f"{name}: the staleness histogram misses "
                                 "parked entries")
    if rec["peak_mem_gb"] >= 80:
        raise AssertionError(f"{name}: peak {rec['peak_mem_gb']} GB")
    rec["stale_reduce_check"] = check_stale_reduce(
        torch, name, up, buf, state.t, fed,
        torch.tensor(float(hist.round.g_hat[-1]), device=dev))
    rec["profile"] = profile_async_round(torch, state, buf, batches, pair,
                                         fed, dev,
                                         rec["s_per_round_after_first"])
    print(json.dumps({"profile": name, **rec["profile"]}), flush=True)
    rec["seconds"] = time.time() - t_part
    del state, buf
    torch.cuda.empty_cache()
    return rec


def async_checks(torch, dev, T: int = ASYNC_CHECK_ROUNDS,
                 layers: int = 2) -> dict:
    """Phase 12(c), at full width and ``layers`` layers, 8 clients, top-k
    0.1: (i) the buffer off is the synchronous ``run_rounds``, bit for bit,
    on the pallas (gather 4 of 8, top-k up and down) and dense (mask 4 of
    8) wires; (ii) obs on gives the obs-off state, buffer and metrics, bit
    for bit; (iii) async gather equals async mask, bit for bit; (iv) the
    card against the CPU from the same CPU-drawn cohorts and events,
    ``CARD_CPU_ROUNDS`` rounds (pallas gather, top-k up, max staleness 1,
    so that parked payloads expire within the run): the counters equal, f and g_hat at rtol 1e-4
    and all but 0.1% of w within rtol 1e-4 / atol 1e-6 (the CPU tests'
    tolerances for the card against the CPU).  Returns the records and the
    host replays."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.configs.base import (AsyncConfig, CompressorConfig,
                                          FedConfig, ObsConfig,
                                          SwitchConfig)
    from repro_torch.data import synthetic
    from repro_torch.engine import async_rounds, rounds
    from repro_torch.models import build
    from repro_torch.tasks import lm
    cfg = dataclasses.replace(configs.get_config("smollm-360m"),
                              n_layers=layers)
    fns = build(cfg)
    loss_pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0)
    params0 = fns.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    cc = CompressorConfig(kind="topk", ratio=0.1)

    def fed_of(comm="pallas", mode="gather", down=True, obs=False, **async_kw):
        return FedConfig(
            n_clients=N_GATHER, m=M_GATHER, local_steps=1, lr=0.03,
            switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0), uplink=cc,
            downlink=cc if down else CompressorConfig(kind="none"),
            comm=comm, participation=mode,
            async_=AsyncConfig(**async_kw), obs=ObsConfig(enabled=obs))

    def run(fed, device, sync=False, T=T):
        d = torch.device(device)

        def batch_fn(t, g):
            toks, mask = synthetic.client_token_batches(
                g, N_GATHER, 2, 64, cfg.vocab, hetero=0.5, device=d)
            return lm.LMBatch(tokens=toks, minority_mask=mask)
        state = rounds.init_state(to_device(params0, d), fed, device=d)
        if sync:
            s, h = rounds.run_rounds(state, batch_fn, loss_pair, fed, T,
                                     device=d)
            return s, None, h, []
        with EventRecorder(fed.fleet.sampler) as rec_ev:
            s, b, h = async_rounds.async_run_rounds(state, batch_fn,
                                                    loss_pair, fed, T,
                                                    device=d)
        return s, b, h, rec_ev.events

    def state_of(s):
        return (s.w, s.x, s.e_up, s.wbar_sum, s.wbar_weight)

    out, replays = {}, []
    # (i) the buffer off
    for comm, mode in (("pallas", "gather"), ("dense", "mask")):
        fed = fed_of(comm, mode)
        ss, _, hs, _ = run(fed, dev, sync=True)
        sa, ba, ha, _ = run(fed, dev)
        ok = (ba is None and bits_equal(torch, np, state_of(ss),
                                        state_of(sa))
              and bits_equal(torch, np, hs, ha.round))
        out[f"disabled {comm} {mode}"] = ok
        print(json.dumps({"async_check": f"disabled == sync, {comm} {mode}",
                          "bit_equal": ok}), flush=True)
        if not ok:
            raise AssertionError(f"async disabled differs from the sync "
                                 f"rounds on {comm} {mode}")
        del ss, sa
    # (ii) obs on is observation only; (iii) gather == mask, both async
    kw = dict(enabled=True, staleness="constraint", max_staleness=2,
              depart=0.5, rejoin=0.5)
    runs = {(mode, obs): run(fed_of(mode=mode, obs=obs, **kw), dev)
            for mode, obs in (("gather", False), ("gather", True),
                              ("mask", False))}
    for (mode, obs), (_, _, _, evs) in runs.items():
        replays.append(replay_buffer(evs, 2))

    def strip(h):
        return h._replace(round=h.round._replace(telemetry=None))
    (sg, bg, hg, _) = runs[("gather", False)]
    (so, bo, ho, _) = runs[("gather", True)]
    (sm, bm, hm, _) = runs[("mask", False)]
    tel_ok = all(np.isfinite(leaf).all() for leaf in ho.round.telemetry)
    checks = {
        "obs on == obs off": bits_equal(torch, np, (state_of(sg), bg,
                                                    hg),
                                        (state_of(so), bo, strip(ho))),
        "obs telemetry finite": bool(tel_ok),
        "gather == mask": bits_equal(torch, np, (state_of(sg), bg, hg),
                                     (state_of(sm), bm, hm))}
    for k, v in checks.items():
        print(json.dumps({"async_check": k, "bit_equal": v,
                          "departed": hg.departed.tolist(),
                          "merged": hg.merged.tolist()}), flush=True)
        if not v:
            raise AssertionError(f"async check failed: {k}")
    out.update(checks)
    del runs, sg, so, sm, bg, bo, bm
    torch.cuda.empty_cache()
    # (iv) the card against the CPU
    fed = fed_of(down=False, enabled=True, staleness="poly",
                 max_staleness=1, depart=0.5, rejoin=0.5)
    sc, bc, hc, evc = run(fed, dev, T=CARD_CPU_ROUNDS)
    sh, bh, hh, evh = run(fed, "cpu", T=CARD_CPU_ROUNDS)
    replays.append(replay_buffer(evc, 1))
    far = ~torch.isclose(sc.w.cpu(), sh.w, rtol=1e-4, atol=1e-6)
    rec = {"async_check": "card vs cpu", "layers": layers,
           "rounds": CARD_CPU_ROUNDS,
           "events_equal": evc == evh,
           "counters_card": {k: getattr(hc, k).tolist()
                             for k in ASYNC_COUNTERS},
           "counters_cpu": {k: getattr(hh, k).tolist()
                            for k in ASYNC_COUNTERS},
           "f": [hc.round.f.tolist(), hh.round.f.tolist()],
           "g_hat": [hc.round.g_hat.tolist(), hh.round.g_hat.tolist()],
           "w_far_share": float(far.float().mean()),
           "replay": replays[-1]}
    print(json.dumps(rec), flush=True)
    same = rec["events_equal"] and rec["counters_card"] == rec["counters_cpu"]
    close = (np.allclose(hc.round.f, hh.round.f, rtol=1e-4)
             and np.allclose(hc.round.g_hat, hh.round.g_hat, rtol=1e-4)
             and rec["w_far_share"] <= 1e-3)
    check_counters("card vs cpu", hc, evc, fed)
    if not (same and close):
        raise AssertionError("async rounds on the card differ from the CPU")
    out["card vs cpu"] = rec
    return {"checks": out, "replays": replays}


def async_phase(torch, dev, T: int = ASYNC_ROUNDS) -> tuple:
    """Phase 12: (a) the launcher's async path (``--fleet --fleet-pool 8
    --async-buffer --sampler markov --staleness constraint``, gather 4 of
    8, pallas top-k up and down, ``--obs``), (b) async mask 4 of 8, pallas
    8-bit quant up and down, ``uniform`` sampler, ``poly`` law, through the
    engine API, T rounds each at full width; (c) the checks of
    :func:`async_checks`.  Over the phase at least one payload must park,
    one deliver and one expire.  Returns ``(records, launch records)``."""
    from repro_torch.configs.base import AsyncConfig
    cohort = ["--clients", str(N_GATHER), "--participating", str(M_GATHER)]
    t0 = time.time()
    part_a = async_part(
        torch, f"smollm-360m async launcher --fleet markov gather "
        f"{M_GATHER} of {N_GATHER} topk up and down, constraint law, obs",
        cohort + ["--participation", "gather", "--comm", "pallas",
                  "--uplink", "topk", "--fleet", "--fleet-pool", "8",
                  "--sampler", "markov", "--async-buffer", "--staleness",
                  "constraint", "--max-staleness", "4", "--depart", "0.25",
                  "--obs"], T)
    part_b = async_part(
        torch, f"smollm-360m async mask {M_GATHER} of {N_GATHER} quant up "
        "and down, uniform sampler, poly law",
        cohort + ["--comm", "pallas", "--uplink", "quant"], T,
        async_=AsyncConfig(enabled=True, staleness="poly", max_staleness=4,
                           depart=0.25, rejoin=0.5, decay=1.0))
    t1 = time.time()
    checks = async_checks(torch, dev)
    seconds = {"part_a": part_a["seconds"], "part_b": part_b["seconds"],
               "parts_a_b": t1 - t0, "checks_c": time.time() - t1}
    fates = {"parked": 0, "merged": 0, "expired": 0}
    for replay in [part_a["replay"], part_b["replay"]] + checks["replays"]:
        for r in replay:
            fates["parked"] += r["departed"]
            fates["merged"] += r["merged"]
            fates["expired"] += r["expired"]
    print(json.dumps({"async_fates": fates, "seconds": seconds}),
          flush=True)
    if not all(fates.values()):
        raise AssertionError(f"phase 12 saw no park, delivery or expiry: "
                             f"{fates}")
    for part in (part_a, part_b):
        part.pop("events")
    return ({"launcher": part_a, "engine": part_b, "checks":
             checks["checks"], "fates": fates, "seconds": seconds},
            [{"phase": p["phase"], "launches": p["launches"]}
             for p in (part_a, part_b)])


# phase 13: population scale-out and checkpoints.  The checks of 13(a) at
# 2 layers, full width otherwise (2 rounds a run, 3 until phase 23 came:
# the evictions, departures and merges their gates need come in its first
# two rounds on an H100); 13(b) and 13(c) T rounds at full width
SCALE_CHECK_ROUNDS = 2
SCALE_CLIENTS, SCALE_SLOTS = 32, 8          # 13(b): n and the store's cap
EVICT_CLIENTS, EVICT_SLOTS = 12, 4          # 13(a): the evicting store
# 13(a): the evicting store's cohorts (4 of 12): disjoint, so round 1 takes
# every slot from its owner, then a mix of hits and misses
EVICT_COHORTS = [[0, 1, 2, 3], [4, 5, 6, 7], [0, 5, 8, 11]]
# 13(a): cohorts (4 of 8) whose members beyond the first cohort's fall one
# to a cohort at k = 2 (cohorts of 4) and k = 4 (of 2): a cohort's partial
# adds its rows in client order and m = 4 divides exactly, so the tiers
# add the same terms in the same order
TIERED_COHORTS = [[0, 1, 2, 4], [0, 1, 3, 6], [0, 1, 2, 5]]
TIER_RTOL, TIER_ATOL = 1e-5, 1e-6


def cohort_masks(np, n: int, cohorts) -> "np.ndarray":
    masks = np.zeros((len(cohorts), n), np.float32)
    for r, ids in enumerate(cohorts):
        masks[r, ids] = 1.0
    return masks


class ReduceRecorder:
    """Records, while active, every call of ``FlatTransport.<method>`` made
    on the thread that entered it whose weights have ``rows`` rows (or that
    has more than one cohort, ``tiered``): the messages, weights, m and
    result (a concurrent run on another thread is not recorded)."""

    def __init__(self, method: str, rows: int = 0, tiered: bool = False):
        self.method, self.rows, self.tiered = method, rows, tiered
        self.calls = []

    def __enter__(self):
        import threading
        from repro_torch.comm import flat
        self._orig = getattr(flat.FlatTransport, self.method)
        self._thread = threading.get_ident()
        rec = self

        def wrapped(ft, msgs, weights, m):
            out = rec._orig(ft, msgs, weights, m)
            if threading.get_ident() == rec._thread and (
                    (rec.tiered and ft.cohorts > 1)
                    or (rec.rows and weights.shape[0] == rec.rows)):
                rec.calls.append((ft, msgs, weights, m, out))
            return out
        setattr(flat.FlatTransport, self.method, wrapped)
        return self

    def __exit__(self, *exc):
        from repro_torch.comm import flat
        setattr(flat.FlatTransport, self.method, self._orig)


class KernelRecorder:
    """Records, while active, every call of the kernel wrapper
    ``module.<name>`` made on the thread that entered it and accepted by
    ``keep(*args)``: its arguments and result (a concurrent run on another
    thread is not recorded).  The wrapper counts its launches on the
    module's attribute (``<name>.launches``), so the stand-in carries the
    count while it is installed and hands it back."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep = module, name, keep
        self.calls = []

    def __enter__(self):
        import threading
        self._orig = getattr(self.module, self.name)
        self._thread = threading.get_ident()
        rec = self

        def wrapped(*args):
            out = rec._orig(*args)
            if threading.get_ident() == rec._thread and rec.keep(*args):
                rec.calls.append((args, out))
            return out
        wrapped.launches = self._orig.launches
        self._wrapped = wrapped
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        self._orig.launches = self._wrapped.launches
        setattr(self.module, self.name, self._orig)


def row_kernel_recorders(rows: int):
    """Recorders of the ``scatter_agg`` launches over ``rows`` stacked
    payload rows and the ``segment_rows`` launches into ``rows`` rows: a
    round's fresh reduce and its ``[n]``-layout scatters at n = ``rows``."""
    from repro_torch.kernels import scatter_agg
    return (KernelRecorder(scatter_agg, "scatter_agg",
                           lambda vals, *a: vals.shape[0] == rows),
            KernelRecorder(scatter_agg, "segment_rows",
                           lambda r, seg, n: n == rows))


def check_recorded(torch, name: str, reduce_rec, seg_rec) -> dict:
    """Every recorded ``scatter_agg`` / ``segment_rows`` launch against its
    plain version on the same inputs, on the card, tolerance 0."""
    from repro_torch.kernels import scatter_agg
    err = {"scatter_agg": 0.0, "segment_rows": 0.0}
    for kname, rec, plain in (
            ("scatter_agg", reduce_rec, scatter_agg.scatter_agg_plain),
            ("segment_rows", seg_rec, scatter_agg.segment_rows_plain)):
        for args, got in rec.calls:
            err[kname] = max(err[kname],
                             max_err(torch, [got], [plain(*args)]))
    out = {"kernel_check": name, "scatter_agg_calls": len(reduce_rec.calls),
           "segment_rows_calls": len(seg_rec.calls),
           "scatter_agg_rows": sorted({tuple(a[0].shape[:2])
                                       for a, _ in reduce_rec.calls}),
           "segment_rows_shapes": sorted({(a[0].shape[0], a[2])
                                          for a, _ in seg_rec.calls}),
           "max_abs_err": err, "tolerance": 0.0}
    print(json.dumps(out), flush=True)
    if any(err.values()) or not (reduce_rec.calls and seg_rec.calls):
        raise AssertionError(f"{name}: a recorded kernel launch differs "
                             f"from its plain version, or none ran: {out}")
    reduce_rec.calls.clear()
    seg_rec.calls.clear()
    return out


def scale_checks(torch, dev, T: int = SCALE_CHECK_ROUNDS,
                 layers: int = 2) -> dict:
    """Phase 13(a), at full width and ``layers`` layers, top-k 0.1 or 8-bit
    quant, E = 1, on recorded cohorts: (i) a store of cap >= n against the
    dense residual, bit for bit (state, metrics, every owned pool row);
    (ii) an evicting store on the card against the CPU (the store's
    integer leaves and weights, the slot counters equal; f and g_hat at
    rtol 1e-4), at least one eviction, every round's flush partial
    bit-equal to the single-tier reduce's plain version (``scatter_agg``
    on the CPU) of the same orphan payloads; (iii) cohorts k = 2 and 4
    against k = 1; (iv) save -> restore -> continue with the evicting
    store, the async buffer and a Markov fleet, bit for bit, and a
    compressed-residual sidecar.  The CPU side of (ii) runs in a thread
    beside the card's checks (its plain top-k sorts take most of its
    time)."""
    import tempfile
    import threading
    import numpy as np
    from repro_torch import checkpoint, configs
    from repro_torch.configs.base import (AsyncConfig, CompressorConfig,
                                          FedConfig, FleetConfig, ObsConfig,
                                          ScaleConfig, SwitchConfig)
    from repro_torch.data import synthetic
    from repro_torch.engine import async_rounds, rounds
    from repro_torch.fleet import samplers
    from repro_torch.models import build
    from repro_torch.scale import slots
    from repro_torch.tasks import lm
    cfg = dataclasses.replace(configs.get_config("smollm-360m"),
                              n_layers=layers)
    fns = build(cfg)
    loss_pair = lm.make_loss_pair(fns.forward, cfg, budget=6.0)
    params0 = fns.init(torch.Generator().manual_seed(0), cfg, device="cpu")

    def fed_of(kind="topk", comm="pallas", n=N_GATHER, cap=0, cohorts=1,
               **kw):
        cc = CompressorConfig(kind=kind, ratio=0.1, bits=8)
        return FedConfig(
            n_clients=n, m=M_GATHER, local_steps=1, lr=0.03,
            switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0), uplink=cc,
            downlink=cc, comm=comm, participation="gather",
            fleet=FleetConfig(sampler="fixed"),
            scale=ScaleConfig(ef_slots=cap, cohorts=cohorts), **kw)

    def run(fed, device, cohorts, T=T):
        d = torch.device(device)

        def batch_fn(t, g):
            toks, mask = synthetic.client_token_batches(
                g, fed.n_clients, 2, 64, cfg.vocab, hetero=0.5, device=d)
            return lm.LMBatch(tokens=toks, minority_mask=mask)
        masks = cohort_masks(np, fed.n_clients, cohorts)
        state = rounds.init_state(to_device(params0, d), fed, device=d)
        state = state._replace(sampler=samplers.fixed_state(masks, masks))
        return rounds.run_rounds(state, batch_fn, loss_pair, fed, T,
                                 device=d)

    def state_of(s):
        return (s.w, s.x, s.wbar_sum, s.wbar_weight)

    def report(rec, ok):
        print(json.dumps(rec), flush=True)
        if not ok:
            raise AssertionError(f"scale check failed: {rec}")

    out, seconds = {}, {}
    # (ii)'s CPU side, in a thread beside the card's work
    evict_fed = fed_of(n=EVICT_CLIENTS, cap=EVICT_SLOTS, full_eval=False,
                       obs=ObsConfig(enabled=True))
    host = {}

    def host_run():
        t_host = time.time()
        try:
            host["run"] = run(evict_fed, "cpu", EVICT_COHORTS)
        except BaseException as e:          # re-raised after the join
            host["error"] = e
        host["seconds"] = time.time() - t_host
    thread = threading.Thread(target=host_run, daemon=True)
    thread.start()
    t0 = time.time()
    red12, seg12 = row_kernel_recorders(EVICT_CLIENTS)
    with ReduceRecorder("reduce_single", rows=evict_fed.m) as flushes, \
            red12, seg12:
        sc, hc = run(evict_fed, dev, EVICT_COHORTS)
    seconds["evicting_card"] = time.time() - t0
    out["evicting store kernels"] = check_recorded(
        torch, f"13(a) evicting store: {EVICT_CLIENTS}-row fresh reduce "
        f"and [{EVICT_CLIENTS}] scatters", red12, seg12)

    # (i) cap >= n is the dense residual
    t0 = time.time()
    for kind, comm in (("topk", "pallas"), ("quant", "pallas"),
                       ("topk", "dense")):
        sd, hd = run(fed_of(kind, comm), dev, TIERED_COHORTS)
        ss, hs = run(fed_of(kind, comm, cap=N_GATHER), dev, TIERED_COHORTS)
        owner = ss.e_up.owner.tolist()
        rows_ok = all(bits_equal(torch, np, ss.e_up.pool[s_], sd.e_up[j])
                      for s_, j in enumerate(owner) if j >= 0)
        ok = (bits_equal(torch, np, state_of(sd), state_of(ss))
              and bits_equal(torch, np, hd, hs) and rows_ok
              and sorted(j for j in owner if j >= 0)
              == sorted({j for c in TIERED_COHORTS[:T] for j in c}))
        key = f"slots cap {N_GATHER} >= n == dense, {kind} on {comm}"
        out[key] = ok
        report({"scale_check": key, "layers": layers, "rounds": T,
                "bit_equal": ok, "owner": owner}, ok)
        del sd, ss
    torch.cuda.empty_cache()
    seconds["cap_ge_n"] = time.time() - t0
    # (iii) cohorts k = 2 and 4 against k = 1
    t0 = time.time()
    for kind in ("topk", "quant"):
        s1, h1 = run(fed_of(kind), dev, TIERED_COHORTS)
        for k in (2, 4):
            sk, hk = run(fed_of(kind, cohorts=k), dev, TIERED_COHORTS)
            same = bits_equal(torch, np, (state_of(s1), s1.e_up, h1),
                              (state_of(sk), sk.e_up, hk))
            err = float((sk.w - s1.w).abs().max())
            close = bool(torch.allclose(sk.w, s1.w, rtol=TIER_RTOL,
                                        atol=TIER_ATOL))
            key = f"cohorts {k} vs 1, {kind}"
            out[key] = {"bit_equal": same, "w_max_abs_err": err}
            report({"scale_check": key, "cohorts": TIERED_COHORTS,
                    "bit_equal": same, "w_max_abs_err": err,
                    "tolerance": "bit-equal" if kind == "topk" else
                    f"rtol {TIER_RTOL} atol {TIER_ATOL}"},
                   same if kind == "topk" else close)
            del sk
        del s1
    torch.cuda.empty_cache()
    seconds["cohorts"] = time.time() - t0

    # (iv) save -> restore -> continue
    t0 = time.time()
    fed = FedConfig(
        n_clients=N_GATHER, m=M_GATHER, local_steps=1, lr=0.03,
        switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
        uplink=CompressorConfig(kind="topk", ratio=0.1),
        downlink=CompressorConfig(kind="topk", ratio=0.1), comm="pallas",
        participation="gather", full_eval=False,
        fleet=FleetConfig(sampler="markov", avail_stay=0.6, batch_size=2,
                          redraw=True),
        async_=AsyncConfig(enabled=True, staleness="constant",
                           max_staleness=3),
        scale=ScaleConfig(ef_slots=M_GATHER), obs=ObsConfig(enabled=True))
    fleet = lm.make_fleet(torch.Generator().manual_seed(1), fed, pool=8,
                          seq_len=64, vocab=cfg.vocab, hetero=0.5,
                          device=dev)

    def fresh():
        return rounds.init_state(to_device(params0, dev), fed, device=dev)

    def arun(state, buf, T_):
        return async_rounds.async_run_rounds(state, lambda t, g: fleet,
                                             loss_pair, fed, T_, device=dev,
                                             buf=buf)
    straight, sbuf, sh = arun(fresh(), None, 2 * T)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        state, buf, _ = arun(fresh(), None, T)
        checkpoint.save_round(tmp, T, state, fleet=fleet, cfg=fed)
        checkpoint.save_buffer(tmp, T, async_rounds.buffer_wire(buf, state,
                                                                fed))
        like = fresh()
        (restored, fleet_r), t_r = checkpoint.restore_round(
            tmp, like, like_fleet=fleet)
        wire = checkpoint.restore_buffer(
            tmp, t_r, async_rounds.buffer_wire_struct(like, fed), device=dev)
        restored_ok = (t_r == T and bits_equal(
            torch, np, (state_of(state), state.e_up, state.sampler, buf),
            (state_of(restored), restored.e_up, restored.sampler, wire))
            and torch.equal(state.gen.get_state(), restored.gen.get_state())
            and bits_equal(torch, np, tuple(fleet.data),
                           tuple(fleet_r.data)))
        del state, buf, like
        cont, cbuf, ch = arun(restored, async_rounds.buffer_from_wire(
            wire, restored, fed), T)
        cont_ok = (bits_equal(torch, np, (state_of(straight), straight.e_up,
                                          straight.sampler, sbuf),
                              (state_of(cont), cont.e_up, cont.sampler,
                               cbuf))
                   and bits_equal(torch, np, rounds_from(sh, T), ch)
                   and torch.equal(straight.gen.get_state(),
                                   cont.gen.get_state()))
        # the compressed-residual sidecar: decode(pack(pool)), row by row
        up, _ = rounds.flat_transports_for(fed, cont.spec)
        checkpoint.save_round(tmp, 2 * T, cont, cfg=fed,
                              compress_residual=True, params=cont.spec)
        back, _ = checkpoint.restore_round(tmp, fresh(), params=cont.spec,
                                           cfg=fed)
        exp = up.codec.decode(up.codec.pack(cont.e_up.pool))
        eup_ok = (all(bits_equal(torch, np, back.e_up.pool[r], exp[r])
                      for r in range(exp.shape[0]))
                  and bits_equal(torch, np, back.e_up._replace(pool=None),
                                 cont.e_up._replace(pool=None))
                  and bits_equal(torch, np, state_of(back), state_of(cont)))
        files = sorted(os.listdir(tmp))
    rec = {"scale_check": "checkpoint save -> restore -> continue",
           "rounds": [T, T], "slots": M_GATHER,
           "evictions": sh.round.telemetry.slot_evictions.tolist(),
           "departed": sh.departed.tolist(), "merged": sh.merged.tolist(),
           "restored_bit_equal": restored_ok,
           "continue_bit_equal": cont_ok,
           "compressed_residual_is_decode_pack": eup_ok, "files": files}
    out["checkpoint"] = rec
    report(rec, restored_ok and cont_ok and eup_ok
           and sum(rec["evictions"]) >= 1 and sum(rec["departed"]) >= 1)
    del straight, cont, back, restored, fleet
    torch.cuda.empty_cache()
    seconds["checkpoint"] = time.time() - t0
    # (ii) the evicting store, card against CPU, and its flush partials
    t0 = time.time()
    thread.join()
    seconds["evicting_cpu_wait"] = time.time() - t0
    seconds["evicting_cpu"] = host["seconds"]
    if "error" in host:
        raise host["error"]
    sh, hh = host["run"]
    fed = evict_fed
    up, _ = rounds.flat_transports_for(fed, sc.spec)
    flush_err = []
    for ft, msgs, w, m, got in flushes.calls:
        host = type(msgs)(*(x.cpu() for x in msgs))
        want = up.codec.reduce(host, w.cpu(), m)
        flush_err.append(not bits_equal(torch, np, got.cpu(), want))
    tc, th = hc.telemetry, hh.telemetry
    rec = {"scale_check": "evicting store, card vs cpu",
           "clients": fed.n_clients, "slots": EVICT_SLOTS,
           "cohorts": EVICT_COHORTS,
           "occupancy": [tc.slot_occupancy.tolist(),
                         th.slot_occupancy.tolist()],
           "evictions": [tc.slot_evictions.tolist(),
                         th.slot_evictions.tolist()],
           "flush_weight": [tc.slot_flush_weight.tolist(),
                            th.slot_flush_weight.tolist()],
           "f": [hc.f.tolist(), hh.f.tolist()],
           "g_hat": [hc.g_hat.tolist(), hh.g_hat.tolist()],
           "flush_partials_checked": len(flushes.calls),
           "flush_partials_differing": sum(flush_err)}
    ok = (all(torch.equal(getattr(sc.e_up, f).cpu(), getattr(sh.e_up, f))
              for f in ("owner", "stamp", "client_slot", "weight"))
          and rec["occupancy"][0] == rec["occupancy"][1]
          and rec["evictions"][0] == rec["evictions"][1]
          and sum(rec["evictions"][0]) >= 1
          and np.allclose(hc.f, hh.f, rtol=1e-4)
          and np.allclose(hc.g_hat, hh.g_hat, rtol=1e-4)
          and len(flushes.calls) == T and not any(flush_err))
    out["evicting store card vs cpu"] = rec
    report(rec, ok)
    del sc, sh, flushes
    torch.cuda.empty_cache()

    out["seconds"] = seconds
    print(json.dumps({"scale_check_seconds": seconds}), flush=True)
    return out


def rounds_from(rec, k: int):
    """A host metric record (numpy arrays with a leading round axis,
    nested, None fields kept) from round ``k`` on."""
    if rec is None:
        return None
    if isinstance(rec, tuple):
        return type(rec)(*(rounds_from(x, k) for x in rec))
    return rec[k:]


def slot_store_record(state, hist, batches, pair, fed, dev) -> dict:
    """Phase 13(b)'s fields: the store's resident bytes against the dense
    residual's, and per round its occupancy, evictions and flushed HT
    mass (the telemetry); then one more round whose ``scatter_agg``
    launches over the ``[n]``-row messages (the fresh reduce) and whose
    ``segment_rows`` launches into ``[n]`` rows are each held against
    their plain versions, tolerance 0 (:func:`check_recorded`)."""
    import torch
    from repro_torch.engine import rounds
    from repro_torch.scale import slots
    tel = hist.telemetry
    rec = {"slot_resident_bytes": slots.resident_bytes(state.e_up),
           "dense_residual_bytes": fed.n_clients * state.spec.d * 4,
           "slot_occupancy": tel.slot_occupancy.tolist(),
           "slot_evictions": tel.slot_evictions.tolist(),
           "slot_flush_weight": tel.slot_flush_weight.tolist()}
    print(json.dumps({"slot_store": fed.n_clients, **rec}), flush=True)
    red, seg = row_kernel_recorders(fed.n_clients)
    with red, seg:
        rounds.round_step(state, batches(0, torch.Generator().manual_seed(7)),
                          pair, fed, device=dev)
    rec["row_kernels"] = check_recorded(
        torch, f"13(b) slot store: {fed.n_clients}-row fresh reduce and "
        f"[{fed.n_clients}] scatters", red, seg)
    return rec


def tiered_record(state, hist, batches, pair, fed, dev) -> dict:
    """Phase 13(c)'s check, after the counted rounds: one more round's
    tiered ``v_bar`` against the single-tier reduce of the same messages
    (rtol ``TIER_RTOL``, atol ``TIER_ATOL``), and ``unpack_mma`` on the
    second cohort's rows -- a view into the stacked payload with its
    leading stride -- against its plain version, run by run, tolerance
    0."""
    import torch
    from repro_torch.engine import rounds
    from repro_torch.kernels import unpack_mma
    with ReduceRecorder("reduce", tiered=True) as rec_red:
        rounds.round_step(state, batches(0, torch.Generator().manual_seed(7)),
                          pair, fed, device=dev)
    ft, msgs, w, m, got = rec_red.calls[0]
    single = ft.reduce_single(msgs, w, m)
    err = float((got - single).abs().max())
    close = bool(single.allclose(got, rtol=TIER_RTOL, atol=TIER_ATOL))
    size = w.shape[0] // fed.scale.cohorts
    sl = slice(size, 2 * size)
    slice_err = 0.0
    for r in ft.codec.layout.runs:
        words = msgs.words[sl, r.woff:r.woff + r.nblocks * r.W].reshape(
            size, r.nblocks, r.W)
        scale = msgs.scale[sl, r.boff:r.boff + r.nblocks]
        args = (words, scale, w[sl], fed.uplink.bits, r.block)
        a, b = unpack_mma.unpack_mma(*args), unpack_mma.unpack_mma_plain(
            *args)
        slice_err = max(slice_err, float((a - b).abs().max()))
    rec = {"tiered_vs_single_max_abs_err": err,
           "tiered_vs_single_bit_equal": bool(single.equal(got)),
           "tiered_vs_single_tolerance": f"rtol {TIER_RTOL} atol "
                                         f"{TIER_ATOL}",
           "cohort_slice_unpack_mma_err": slice_err,
           "cohort_rows": [size, 2 * size], "weights": w.tolist()}
    print(json.dumps({"tiered_check": fed.scale.cohorts, **rec}),
          flush=True)
    if not close or slice_err != 0.0:
        raise AssertionError(f"two-tier reduce check failed: {rec}")
    return rec


def scale_phase(torch, dev, T: int) -> tuple:
    """Phase 13: (a) :func:`scale_checks`; (b) the slot store at full
    width, 32 clients, 4 sampled, 8 slots, pallas top-k 0.1 up and down,
    ``--sparse-eval``, ``--lean-metrics``, telemetry on; (c) gather 4 of 8
    with 4 cohorts, pallas 8-bit quant up and down, ``--sparse-eval`` --
    T rounds each through the launcher's setup.  Returns ``(records, launch records)``."""
    t0 = time.time()
    checks = scale_checks(torch, dev)
    t1 = time.time()
    part_b = train_phase(
        torch, f"smollm-360m slot store gather {M_GATHER} of "
        f"{SCALE_CLIENTS}, {SCALE_SLOTS} slots, topk up and down",
        ["--clients", str(SCALE_CLIENTS), "--participating", str(M_GATHER),
         "--participation", "gather", "--comm", "pallas", "--uplink",
         "topk", "--ef-slots", str(SCALE_SLOTS), "--sparse-eval",
         "--lean-metrics", "--obs"], T, downlink=True,
        after=slot_store_record)
    t2 = time.time()
    part_c = train_phase(
        torch, f"smollm-360m two-tier gather {M_GATHER} of {N_GATHER}, "
        "4 cohorts, quant up and down",
        ["--clients", str(N_GATHER), "--participating", str(M_GATHER),
         "--participation", "gather", "--comm", "pallas", "--uplink",
         "quant", "--cohorts", "4", "--sparse-eval"], T, downlink=True,
        after=tiered_record)
    seconds = {"checks_a": t1 - t0, "slots_b": t2 - t1,
               "tiered_c": time.time() - t2}
    print(json.dumps({"scale_seconds": seconds}), flush=True)
    return ({"checks": checks, "slots": part_b, "tiered": part_c,
             "seconds": seconds},
            [{"phase": p["phase"], "launches": p["launches"]}
             for p in (part_b, part_c)])


# phase 14: the token-only model families at full published width.  Each
# cell: (name, arch, layers kept (None: the whole model), launcher
# arguments, compressed downlink).  Depth is cut only where one card
# forces it: a fused round holds about 16 + 2.2n fp32 copies of d, so
# recurrentgemma-2b (2.56B) and gemma3-4b (3.88B) keep one pattern period
# and two local layers
FAMILY_CELLS = [
    ("14a mamba2-130m", "mamba2-130m", None,
     ["--clients", str(N_GATHER), "--participating", str(M_GATHER),
      "--participation", "gather", "--comm", "pallas", "--uplink", "topk"],
     True),
    ("14b recurrentgemma-2b", "recurrentgemma-2b", 3,
     ["--clients", "2", "--comm", "pallas", "--uplink", "quant"], False),
    ("14c gemma3-4b", "gemma3-4b", 2,
     ["--clients", "2", "--comm", "pallas", "--uplink", "topk"], False),
]
# 14(d): each family's reduced config, card against CPU, at seq 64 (gemma3's
# window 32 masks, Mamba-2 runs two SSD chunks): (name, launcher arguments,
# compressed downlink)
FAMILY_CHECK_ARCHS = ["qwen3-4b", "minitron-4b", "gemma3-4b", "mamba2-130m",
                      "recurrentgemma-2b"]
FAMILY_CHECK_WIRES = [("dense topk up/down", ["--uplink", "topk"], True),
                      ("pallas quant", ["--comm", "pallas", "--uplink",
                                        "quant"], False)]
FAMILY_CHECK_ROUNDS = 2
FAMILY_CHECK_SEQ = 64
# block rows per slice of a plain version in :class:`PlainCheck` (bounds
# the extra memory of holding a full-width launch against its plain version)
PLAIN_ROWS = 1 << 16


def _plain_pieces():
    """``ops`` dispatcher -> (kernel, block rows of a call, the kernel's
    output and the plain version's on one slice of block rows); the
    dispatchers' own casts are repeated on the plain side."""
    import torch
    from repro_torch.kernels import (quantize_ef_pack, scatter_agg,
                                     topk_block, unpack_mma)

    def topk(out, sl, x, k):
        return ([o[..., sl, :] for o in out],
                topk_block.block_topk_plain(x[..., sl, :], k))

    def quant(out, sl, e, d, bits):
        return ([o[..., sl, :] for o in out],
                quantize_ef_pack.quantize_ef_pack_plain(
                    e[..., sl, :], d[..., sl, :], bits))

    def agg(out, sl, vals, idx, w, block):
        return ([out[sl]], [scatter_agg.scatter_agg_plain(
            vals[:, sl], idx[:, sl], w.to(torch.float32), block)])

    def qagg(out, sl, words, scale, w, bits, block):
        return ([out[sl]], [unpack_mma.unpack_mma_plain(
            words[:, sl], scale[:, sl], w.to(torch.float32), bits, block)])

    def seg(out, sl, rows, ids, n):
        m = rows.shape[0]
        want = scatter_agg.segment_rows_plain(
            rows.reshape(m, -1)[:, sl].to(torch.float32), ids, n)
        return [out.reshape(n, -1)[:, sl]], [want.to(rows.dtype)]

    return {
        "block_topk": ("block_topk", lambda x, k: x.shape[-2], topk),
        "quantize_ef_pack": ("quantize_ef_pack",
                             lambda e, d, bits: e.shape[-2], quant),
        "scatter_agg": ("scatter_agg",
                        lambda vals, idx, w, block:
                        vals.shape[1] if block > 1 else 0, agg),
        "quant_agg": ("unpack_mma",
                      lambda words, scale, w, bits, block: words.shape[1],
                      qagg),
        "segment_rows": ("segment_rows",
                         lambda rows, ids, n: rows[0].numel(), seg),
    }


class PlainCheck:
    """While active, every kernel launch through the ``ops`` dispatchers
    (``block_topk``, ``quantize_ef_pack``, ``scatter_agg``, ``quant_agg``
    -> ``unpack_mma``, ``segment_rows``) made on this thread (on every
    thread with ``any_thread``: the wire's worker threads) is held
    against the kernel's plain version on the same inputs, on the spot and
    in slices of ``PLAIN_ROWS`` block rows, tolerance 0.  The plain
    versions launch no kernel, so the launch counts stay the path's."""

    def __init__(self, torch, any_thread: bool = False):
        import threading
        self.torch = torch
        self.any_thread = any_thread
        self.calls, self.err, self.layouts = {}, {}, {}
        self._lock = threading.Lock()

    def __enter__(self):
        import threading
        from repro_torch.kernels import ops
        self._orig = {}
        thread = threading.get_ident()
        for disp, (kname, rows_of, piece) in _plain_pieces().items():
            orig = self._orig[disp] = getattr(ops, disp)

            def wrapped(*args, _orig=orig, _k=kname, _rows=rows_of,
                        _piece=piece):
                out = _orig(*args)
                rows = _rows(*args)
                if (not self.any_thread and threading.get_ident() != thread
                        or not rows or not args[0].is_cuda):
                    return out
                err = 0.0
                for i in range(0, rows, PLAIN_ROWS):
                    got, want = _piece(out, slice(i, i + PLAIN_ROWS), *args)
                    err = max(err, max_err(self.torch, got, want))
                shape = [int(x) for x in args[0].shape]
                with self._lock:
                    self.calls[_k] = self.calls.get(_k, 0) + 1
                    self.err[_k] = max(self.err.get(_k, 0.0), err)
                    self.layouts.setdefault(_k, [])
                    if shape not in self.layouts[_k]:
                        self.layouts[_k].append(shape)
                return out
            setattr(ops, disp, wrapped)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for disp, fn in self._orig.items():
            setattr(ops, disp, fn)


def plain_check_record(state, hist, batches, pair, fed, dev) -> dict:
    """Phase 14's check, after the counted rounds: one more round whose
    every wire-kernel launch is held against its plain version
    (:class:`PlainCheck`)."""
    import torch
    from repro_torch.engine import rounds
    with PlainCheck(torch) as chk:
        rounds.round_step(state, batches(0, torch.Generator().manual_seed(7)),
                          pair, fed, device=dev)
    torch.cuda.synchronize()
    rec = {"kernel_calls": chk.calls, "max_abs_err": chk.err,
           "input_shapes": chk.layouts, "tolerance": 0.0}
    print(json.dumps({"kernel_check": f"{fed.comm} {fed.uplink.kind} "
                      "every launch of one round", **rec}), flush=True)
    if any(chk.err.values()) or not chk.calls:
        raise AssertionError(f"a kernel launch differs from its plain "
                             f"version, or none ran: {rec}")
    return {"plain_check": rec}


def family_card_check(torch, archs=FAMILY_CHECK_ARCHS,
                      label: str = "14(d)") -> list:
    """Phase 14(d) (15(c) for the moe archs, 16(c) for the media archs,
    whose batches carry media ``* 0.02`` from the same numpy draws): each
    arch's reduced config, 2 rounds on the card against the same rounds on
    the CPU, dense
    top-k up and down then pallas 8-bit quant up: f and g_hat within
    phase 4's tolerances (rtol 1e-4), all but 0.1% of w within rtol 1e-4 /
    atol 1e-6."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.engine import rounds
    from repro_torch.tasks import lm
    out = []
    for arch in archs:
        for wire, argv, downlink in FAMILY_CHECK_WIRES:
            state, loss_pair, fed, cfg = reference_case(
                torch, ["--arch", arch] + argv, downlink,
                seq=FAMILY_CHECK_SEQ)
            nc, S = fed.n_clients, FAMILY_CHECK_SEQ
            rng = np.random.default_rng(0)
            batches = []
            for _ in range(FAMILY_CHECK_ROUNDS):
                toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (nc, 2, S)))
                mask = torch.zeros((nc, 2, S))
                mask[..., -4:] = 1.0
                media = None        # the stub frontends' embeddings
                if cfg.family in ("vlm", "audio"):
                    media = torch.from_numpy(rng.standard_normal(
                        (nc, 2, cfg.n_media_tokens or cfg.n_audio_frames,
                         cfg.d_media or cfg.d_model)).astype(np.float32)
                        * 0.02)
                batches.append((toks, mask, media))
            res = {}
            for device in ("cuda", "cpu"):
                # copies: a round updates its state's buffers and
                # generator in place, and both devices start from state
                on = state._replace(gen=torch.Generator().set_state(
                    state.gen.get_state()), **{
                    f: getattr(state, f).to(device, copy=True) for f in
                    ("w", "x", "e_up", "wbar_sum", "wbar_weight")
                    if getattr(state, f) is not None})
                if on.x is not None:
                    on = on._replace(x=on.w)
                fs, gs = [], []
                for toks, mask, media in batches:
                    on, met = rounds.round_step(
                        on, lm.LMBatch(toks.to(device), mask.to(device),
                                       None if media is None
                                       else media.to(device)),
                        loss_pair, fed, device=device)
                    fs.append(float(met.f))
                    gs.append(float(met.g_hat))
                res[device] = (on.w.cpu(), fs, gs)
            far = ~torch.isclose(res["cuda"][0], res["cpu"][0], rtol=1e-4,
                                 atol=1e-6)
            ok = (all(math.isfinite(v) for v in res["cuda"][1]
                      + res["cuda"][2])
                  and all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(
                      res["cuda"][1] + res["cuda"][2],
                      res["cpu"][1] + res["cpu"][2]))
                  and float(far.float().mean()) <= 1e-3)
            rec = {"family_check": f"{arch} {wire}", "d": state.spec.d,
                   "f": [res["cuda"][1], res["cpu"][1]],
                   "g_hat": [res["cuda"][2], res["cpu"][2]],
                   "w_far_fraction": float(far.float().mean()), "ok": ok}
            print(json.dumps(rec), flush=True)
            out.append(rec)
            if not ok:
                raise AssertionError(f"{label} {arch} {wire}: card and CPU "
                                     "disagree")
    kernels.reset_launches()
    return out


def family_phase(torch, dev, T: int) -> tuple:
    """Phase 14: (a)-(c) the token-only families at full published width
    (:data:`FAMILY_CELLS`), T rounds each through the launcher's setup and
    ``run_rounds``, every kernel launch of one more round held against its
    plain version; (d) :func:`family_card_check`.  Returns ``(records,
    launch records)``."""
    from repro_torch import configs
    t0 = time.time()
    cells = []
    for name, arch, layers, argv, downlink in FAMILY_CELLS:
        cfg = configs.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        spec = meta_spec(torch, cfg)
        print(json.dumps({"family_cell": name, "arch": arch,
                          "n_layers": cfg.n_layers, "d": spec.d}),
              flush=True)
        rec = train_phase(torch, name, ["--arch", arch] + argv, T,
                          downlink=downlink, after=plain_check_record,
                          cfg=cfg, d_want=spec.d, digest=name in RANK_FROM)
        rec.update({"arch": arch, "n_layers": cfg.n_layers,
                    "seconds": time.time() - t0})
        cells.append(rec)
        t0 = time.time()
    checks = family_card_check(torch)
    seconds = {c["phase"]: c["seconds"] for c in cells}
    seconds["checks_d"] = time.time() - t0
    print(json.dumps({"family_seconds": seconds}), flush=True)
    return ({"cells": cells, "checks": checks, "seconds": seconds},
            [{"phase": c["phase"], "launches": c["launches"]}
             for c in cells])


# phase 15: the moe family.  15(a) trains deepseek-v2-236b at its published
# widths (d_model 5120, 128 heads, MLA kv_lora 512 / q_lora 0 / rope 64 /
# nope 128 / v 128, d_expert 1536, 2 shared experts, top-6, capacity 1.25,
# router group 4096) through the launcher's setup, cut where one card
# forces it: a fused 2-client round holds 13-14.3 fp32 copies of d (phase
# 14), so a card holds about 1.4B parameters.  Depth 60 -> 2 (the leading
# dense layer and one MoE layer, the MoE period), routed experts 160 -> 16
# (the router 16 wide, top-k still 6; 24 would reach the card's 80 GB),
# vocab 102,400 -> 12,800 (an eighth): d = 1,203,480,576
MOE_ARCH = "deepseek-v2-236b"
MOE_CUTS = {"n_layers": 2, "n_experts": 16, "vocab": 12_800}
MOE_ARGV = ["--clients", "2", "--comm", "pallas", "--uplink", "topk"]
MOE_FREE_GB = 5.0              # 15(a)'s peak must leave this much free
MOE_MARGIN = 1e-5              # 15(b): idx must agree where the CPU's
                               # k-th minus (k+1)-th probability exceeds it
MOE_RTOL = 1e-4                # 15(b): y and aux + 1, card against CPU
MOE_CHECK_ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]     # 15(c)


def moe_cut(cfg):
    """15(a)'s config: ``cfg`` with :data:`MOE_CUTS`."""
    return dataclasses.replace(
        cfg, n_layers=MOE_CUTS["n_layers"], vocab=MOE_CUTS["vocab"],
        moe=dataclasses.replace(cfg.moe, n_experts=MOE_CUTS["n_experts"]))


class MoEInputRecorder:
    """While active, records the tokens ``x [T, d]`` that enter every
    ``moe.moe_ffn`` call (the hidden state after an MoE layer's ln2)."""

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe.moe_ffn
        self.inputs = []

        def wrapped(p, x, mcfg):
            self.inputs.append(x.detach().clone())
            return self._orig(p, x, mcfg)
        moe.moe_ffn = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_ffn = self._orig


def profile_device(torch, fn) -> tuple:
    """``fn()`` once under ``torch.profiler``, the card's activity only:
    ``(device ms, kernel launches, the profile's key averages of device
    work)``.  Recording the host's operators too cost 20-130 s a round on
    the host-bound rounds (a CMDP round makes 242,000 launches) and adds
    nothing these numbers read."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    return (sum(dev_us(e) for e in kernels) / 1e3,
            sum(e.count for e in kernels), kernels)


class KernelTotal(NamedTuple):
    """One kernel name's device work in a profile (:func:`device_kernels`),
    under the names a ``key_averages()`` entry gives it."""
    key: str
    count: int
    self_device_time_total: float       # microseconds


def device_kernels(prof) -> list:
    """The device work of a finished ``torch.profiler`` run by kernel name,
    summed from its Kineto events: the ``key_averages()`` entries of work
    on the card with a positive device time, less the stage spans'
    device-side annotations (spans show on the device timeline too, with
    their extent as their duration), without the Python event
    ``key_averages()`` builds for every launch first (about 0.2 ms each on
    the host: 10 s for a 43,000-launch round, most of a minute for a CMDP
    round's 242,000)."""
    from torch.autograd import DeviceType
    us, count = {}, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        name = e.name()
        if name.startswith(STAGE_PREFIXES):
            continue
        us[name] = us.get(name, 0.0) + e.duration_ns() / 1e3
        count[name] = count.get(name, 0) + 1
    return [KernelTotal(k, count[k], v) for k, v in us.items() if v > 0]


def profile_reader_check(torch, dev) -> dict:
    """:func:`device_kernels` against ``key_averages()`` on one profile of
    3,000 launches and a copy inside a stage span: the same kernel
    names, launches and device ms (within 1e-9), and each reader's host
    seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.trace import stage
    x = torch.randn(1 << 20, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with stage("round.profile_reader_check"):
            for _ in range(1000):
                x = torch.tanh(x * 0.5 + 0.1)
            x.cpu()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = {e.key: (e.count, dev_us(e)) for e in device_kernels(prof)}
    t1 = time.perf_counter()
    old = {e.key: (e.count, dev_us(e)) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.key.startswith(STAGE_PREFIXES) and dev_us(e) > 0}
    t2 = time.perf_counter()
    rec = {"profile_reader_check": {
        "launches": [sum(c for c, _ in new.values()),
                     sum(c for c, _ in old.values())],
        "device_ms": [sum(u for _, u in new.values()) / 1e3,
                      sum(u for _, u in old.values()) / 1e3],
        "kernel_names": [len(new), len(old)],
        "host_s": [t1 - t0, t2 - t1]}}
    print(json.dumps(rec), flush=True)
    if new.keys() != old.keys() or any(
            new[k][0] != old[k][0]
            or abs(new[k][1] - old[k][1]) > 1e-9 * old[k][1] for k in old):
        raise AssertionError(f"device_kernels differs from key_averages: "
                             f"{new} against {old}")
    return rec


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def moe_layer_parts(torch, p, mcfg, x) -> dict:
    """The MoE layer's device cost on 15(a)'s tokens: CUDA-event ms of the
    forward's parts (routing, dispatch, expert GEMMs, combine) and, under
    the profiler, the device ms and launches of the layer's forward and
    backward."""
    from repro_torch.comm import payloads
    from repro_torch.models import moe
    E, k = mcfg.n_experts, mcfg.top_k
    with torch.no_grad():
        xg = moe.groups(x, mcfg)
        ng, G, d = xg.shape
        C = moe.capacity(G, mcfg)
        probs, gates, idx = moe.route(p["router"], xg, k)
        ein, slot, keep = moe.dispatch(xg, idx, E, C)
        ei = ein.transpose(0, 1).reshape(E, ng * C, d)
        eo = moe.experts(p["experts"], ei).reshape(E, ng, C, d) \
            .transpose(0, 1)
        parts = {
            "route_ms": time_ms(torch, lambda: moe.route(p["router"], xg, k)),
            "dispatch_ms": time_ms(torch, lambda: moe.dispatch(xg, idx, E,
                                                               C)),
            "experts_ms": time_ms(torch, lambda: moe.experts(p["experts"],
                                                             ei)),
            "combine_ms": time_ms(torch, lambda: moe.combine(eo, slot, gates,
                                                             keep)),
            "forward_ms": time_ms(torch, lambda: moe.moe_ffn(p, x, mcfg))}
    # copies of the layer's weights that take gradients
    grads = payloads.tree_map(
        lambda v: v.detach().clone().requires_grad_(True), p)

    def fwd_bwd():
        y, aux = moe.moe_ffn(grads, x, mcfg)
        (y.square().mean() + aux).backward()
    fwd_bwd()
    ms, launches, _ = profile_device(torch, fwd_bwd)
    parts.update({"fwd_bwd_device_ms": ms, "fwd_bwd_launches": launches,
                  "tokens": int(x.shape[0]), "groups": ng, "capacity": C,
                  "dropped_choices": int((~keep).sum())})
    return parts


def moe_layer_check(torch, p, mcfg, x) -> dict:
    """Phase 15(b): the MoE layer at full width on the card and on the CPU
    from the same tokens ``x`` (15(a)'s hidden state) and weights.  ``idx``
    must be equal wherever the CPU's margin exceeds :data:`MOE_MARGIN`
    (the count under it printed); on the tokens whose routing (choices and
    kept slots) agrees, y within rtol 1e-4 and atol 1e-4 x rms(y), and
    with no flip aux + 1 within rtol 1e-4; the card's draw-free core on the
    CPU's routing gives y (every token) and aux + 1 within the same."""
    from repro_torch.models import moe
    E, k, T = mcfg.n_experts, mcfg.top_k, x.shape[0]
    res = {}
    with torch.no_grad():
        for device in ("cuda", "cpu"):
            pp = p if device == "cuda" else to_device(p, "cpu")
            xg = moe.groups(x.to(device), mcfg)
            probs, gates, idx = moe.route(pp["router"], xg, k)
            keep = moe.dispatch(xg, idx, E, moe.capacity(xg.shape[1],
                                                         mcfg))[2]
            y, aux = moe.moe_core(pp, xg, probs, gates, idx, mcfg, T)
            res[device] = {"probs": probs.cpu(), "gates": gates.cpu(),
                           "idx": idx.cpu(), "keep": keep.cpu(),
                           "y": y.cpu(), "aux": float(aux)}
        cpu, card = res["cpu"], res["cuda"]
        core_y, core_aux = moe.moe_core(
            p, moe.groups(x, mcfg), cpu["probs"].cuda(), cpu["gates"].cuda(),
            cpu["idx"].cuda(), mcfg, T)
    srt = cpu["probs"].sort(-1, descending=True).values
    margin = (srt[..., k - 1] - srt[..., k]).reshape(-1)[:T]
    same_idx = (card["idx"] == cpu["idx"]).all(-1).reshape(-1)[:T]
    same_keep = (card["keep"] == cpu["keep"]).reshape(
        -1, k).all(-1)[:T]
    agree = same_idx & same_keep

    def close(a, b):
        tol = MOE_RTOL * b.abs() + MOE_RTOL * b.square().mean().sqrt()
        return bool(((a - b).abs() <= tol).all()), float(
            ((a - b).abs() / b.abs().max()).max())

    y_ok, y_err = close(card["y"][agree], cpu["y"][agree])
    core_ok, core_err = close(core_y.cpu(), cpu["y"])
    flips = int((~same_idx).sum())
    aux_ok = flips > 0 or math.isclose(card["aux"] + 1, cpu["aux"] + 1,
                                       rel_tol=MOE_RTOL)
    core_aux_ok = math.isclose(float(core_aux) + 1, cpu["aux"] + 1,
                               rel_tol=MOE_RTOL)
    rec = {"tokens": T, "experts": E, "top_k": k,
           "under_margin": int((margin <= MOE_MARGIN).sum()),
           "margin": MOE_MARGIN, "flipped": flips,
           "flipped_over_margin": int((~same_idx & (margin > MOE_MARGIN))
                                      .sum()),
           "tokens_compared": int(agree.sum()),
           "y_max_err_of_max": y_err, "core_y_max_err_of_max": core_err,
           "aux": [card["aux"], cpu["aux"]], "core_aux": float(core_aux),
           "rtol": MOE_RTOL}
    rec["ok"] = (rec["flipped_over_margin"] == 0 and y_ok and core_ok
                 and aux_ok and core_aux_ok)
    print(json.dumps({"moe_layer_check": "15(b) card vs CPU", **rec}),
          flush=True)
    if not rec["ok"]:
        raise AssertionError(f"15(b): the MoE layer differs between the "
                             f"card and the CPU: {rec}")
    return rec


def moe_cell_record(state, hist, batches, pair, fed, dev) -> dict:
    """15(a)'s checks after the counted rounds: one more round whose every
    wire-kernel launch is held against its plain version; the memory
    left; the MoE layer's costs (:func:`moe_layer_parts`) and 15(b)
    (:func:`moe_layer_check`) on the hidden state that enters the MoE
    layer in a forward of client 0's batch."""
    import torch
    from repro_torch import configs
    from repro_torch.comm import flat
    from repro_torch.models import build
    rec = plain_check_record(state, hist, batches, pair, fed, dev)
    peak = torch.cuda.max_memory_allocated() / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    rec["memory"] = {"peak_gb": peak, "total_gb": total,
                     "free_gb": total - peak,
                     "copies_of_d": peak / (4 * state.spec.d / 1e9)}
    print(json.dumps({"moe_memory": rec["memory"]}), flush=True)
    if total - peak < MOE_FREE_GB:
        raise AssertionError(f"15(a) leaves {total - peak:.1f} GB free, "
                             f"under {MOE_FREE_GB}")
    cfg = moe_cut(configs.get_config(MOE_ARCH))
    params = flat.unflatten(state.spec, state.w)
    toks = batches(0, torch.Generator().manual_seed(7)).tokens[0]
    with torch.no_grad(), MoEInputRecorder() as seen:
        build(cfg).forward(params, cfg, toks)
    lp = params["moe_layers"]["moe"]
    layer = {"router": lp["router"][0],
             "experts": {kk: v[0] for kk, v in lp["experts"].items()}}
    if "shared" in lp:
        layer["shared"] = {kk: v[0] for kk, v in lp["shared"].items()}
    x = seen.inputs[0]
    rec["moe_layer"] = moe_layer_parts(torch, layer, cfg.moe, x)
    print(json.dumps({"moe_layer_parts": rec["moe_layer"]}), flush=True)
    rec["layer_check"] = moe_layer_check(torch, layer, cfg.moe, x)
    return rec


def moe_phase(torch, dev, T: int) -> tuple:
    """Phase 15: (a) deepseek-v2-236b at its published widths with
    :data:`MOE_CUTS`, T rounds through the launcher's setup and
    ``run_rounds`` (2 clients, pallas top-k 0.1 up, the router-imbalance
    constraint), then :func:`moe_cell_record` (with 15(b)); (c) the
    reduced deepseek-v2 and v3 (MTP, low-rank queries), 2 rounds card
    against CPU on 14(d)'s two wires.  Returns ``(record, launch
    records)``."""
    from repro_torch import configs
    from repro_torch.comm import flat
    from repro_torch.configs.base import CompressorConfig
    t0 = time.time()
    full = configs.get_config(MOE_ARCH)
    cfg = moe_cut(full)
    spec = meta_spec(torch, cfg)
    layout = flat.wire_layout(spec, CompressorConfig(kind="topk", ratio=0.1))
    cuts = {"n_layers": [full.n_layers, cfg.n_layers],
            "n_experts": [full.moe.n_experts, cfg.moe.n_experts],
            "vocab": [full.vocab, cfg.vocab]}
    print(json.dumps({"moe_cell": "15a " + MOE_ARCH, "cuts": cuts,
                      "d": spec.d, "blocks": [r.block for r in layout.runs],
                      "k": [r.k for r in layout.runs]}), flush=True)
    name = f"15a {MOE_ARCH}"
    cell = train_phase(torch, name, ["--arch", MOE_ARCH] + MOE_ARGV, T,
                       after=moe_cell_record, cfg=cfg, d_want=spec.d)
    cell.update({"arch": MOE_ARCH, "cuts": cuts,
                 "seconds": time.time() - t0})
    t0 = time.time()
    checks = family_card_check(torch, MOE_CHECK_ARCHS, "15(c)")
    seconds = {"15a": cell["seconds"], "15c": time.time() - t0}
    print(json.dumps({"moe_seconds": seconds}), flush=True)
    return ({"cell": cell, "checks": checks, "seconds": seconds},
            [{"phase": name, "launches": cell["launches"]}])


# phase 16: the vlm and audio families.  16(a) trains llama-3.2-vision-90b
# at its published widths (d_model 8192, GQA 64/8, head_dim 128, d_ff
# 28,672, d_media 8192, 1,601 media tokens, rope theta 500,000) through the
# launcher's setup, cut where one card forces it: layers 100 -> 1 and
# cross_attn_every 5 -> 1, so the one layer is the cross layer this family
# adds (its self layer is the dense layer the smollm phases run), and
# vocab 128,256 -> 16,032 (an eighth): d = 1,118,330,881, about 64 GB at
# the 14.3 fp32 copies of a fused 2-client round (a self and a cross layer
# are 1.97B, about 113 GB).  8-bit quant up, so that every coordinate (the
# scalar gate included) reaches the server in round 1; identity down; 2 of
# 2, mask, fused.  16(b) trains whisper-small whole (12 + 12 layers,
# d_model 768, 12 heads, d_ff 3072, vocab 51,865 tied, 1,500 frames): d =
# 239,649,036; top-k 0.1 up and down, gather 4 of 8, separate eval.  Each:
# (name, arch, cuts, launcher arguments, compressed downlink)
MEDIA_CELLS = [
    ("16a llama-3.2-vision-90b", "llama-3.2-vision-90b",
     {"n_layers": 1, "cross_attn_every": 1, "vocab": 16_032},
     ["--clients", "2", "--comm", "pallas", "--uplink", "quant"], False),
    ("16b whisper-small", "whisper-small", {},
     ["--clients", str(N_GATHER), "--participating", str(M_GATHER),
      "--participation", "gather", "--comm", "pallas", "--uplink", "topk"],
     True),
]
MEDIA_FREE_GB = 5.0            # 16(a)'s peak must leave this much free
MEDIA_GATE_CALLS = 4           # 16(a): gated forwards of its first two
                               # rounds (2 a fused round); with remat each
                               # is called once more, recomputed in the
                               # backward, so twice as many are recorded
MEDIA_CHECK_ARCHS = ["llama-3.2-vision-90b", "whisper-small"]   # 16(c)
MEDIA_SPANS = ("media.",)


class MediaSpans:
    """While active, the forward's cross attention (``cross_kv`` and
    ``cross_attention``) and whisper's encoder run inside profiler spans
    ``media.cross_kv``, ``media.cross_attention`` and ``media.encode``."""

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.models import attention, whisper
        self._orig = [(attention, "cross_kv"), (attention, "cross_attention"),
                      (whisper, "encode")]
        self._orig = [(m, a, getattr(m, a)) for m, a in self._orig]
        for mod, attr, fn in self._orig:
            def wrapped(*args, _fn=fn, _name="media." + attr, **kw):
                with record_function(_name):
                    return _fn(*args, **kw)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._orig:
            setattr(mod, attr, fn)


class GateRecorder:
    """While active, records ``tanh(gate)`` of the first ``limit`` gated
    ``cross_attention`` calls (a detached copy each, read after the
    rounds: no device sync inside them)."""

    def __init__(self, torch, limit: int):
        self.torch, self.limit, self.tanh = torch, limit, []

    def __enter__(self):
        from repro_torch.models import attention
        self._orig = attention.cross_attention

        def wrapped(p, x, kv, *, gated=True, **kw):
            if gated and len(self.tanh) < self.limit:
                self.tanh.append(self.torch.tanh(p["gate"].detach()))
            return self._orig(p, x, kv, gated=gated, **kw)
        attention.cross_attention = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.cross_attention = self._orig


def media_cell_record(state, hist, batches, pair, fed, dev,
                      gates=None) -> dict:
    """16(a) and 16(b)'s checks after the counted rounds: one more round
    whose every wire-kernel launch is held against its plain version; the
    memory left (16(a): at least :data:`MEDIA_FREE_GB`); the CPU draw of
    one round's batch, timed alone; one more round under the profiler with
    the :class:`MediaSpans` (the forward's device ms in cross attention
    and in the encoder); f of client 0's rows under the round's media and
    under a second draw, which must differ (for the vlm with its gates
    set to 1, beside the pair at the trained gates); for the vlm,
    ``tanh(gate)`` 0 in round 1's forwards (and their recomputes) and
    nonzero in round 2's (``gates``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    rec = plain_check_record(state, hist, batches, pair, fed, dev)
    peak = torch.cuda.max_memory_allocated() / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    rec["memory"] = {"peak_gb": peak, "total_gb": total,
                     "free_gb": total - peak,
                     "copies_of_d": peak / (4 * state.spec.d / 1e9)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = batches(0, torch.Generator().manual_seed(7))
    torch.cuda.synchronize()
    rec["batch_draw_s"] = time.perf_counter() - t0
    rec["media_shape"] = list(b.media.shape)
    with MediaSpans(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        rounds.round_step(state, b, pair, fed, device=dev)
        torch.cuda.synchronize()
    trace = ROOT / "build" / "trace_media_round.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    split = stage_split(prof, trace, MEDIA_SPANS)
    rec["media_spans"] = {"device_ms": split["device_ms"],
                          "launches": split["launches"],
                          "spans": split["spans"]}
    params = flat.unflatten(state.spec, state.w)
    one = rounds.client_batch(b, 0)
    other = one._replace(media=(torch.randn(
        tuple(one.media.shape), generator=torch.Generator().manual_seed(8))
        * 0.02).to(dev))

    def f_pair(p):
        with torch.no_grad():
            return [float(pair(p, one)[0]), float(pair(p, other)[0])]
    rec["f_two_media_draws"] = f_pair(params)
    if gates is not None:
        # the trained tanh(gate) is about 1e-6 after T rounds: the stub
        # media (0.02 normals) averaged over 1,601 positions give the cross
        # layer an output of about 5e-4, so the gate's gradient is small,
        # and f at float32 does not resolve the media through the trained
        # gate; the forward's reading of the media is shown at gate 1
        opened = dict(params, blocks=[
            dict(blk, attn=dict(blk["attn"],
                                gate=torch.ones_like(blk["attn"]["gate"])))
            if "gate" in blk["attn"] else blk for blk in params["blocks"]])
        rec["f_two_media_draws_gate_1"] = f_pair(opened)
        f1, f2 = rec["f_two_media_draws_gate_1"]
    else:
        f1, f2 = rec["f_two_media_draws"]
    ok = math.isfinite(f1) and math.isfinite(f2) and f1 != f2
    if gates is not None:
        tanh = [float(g) for g in gates.tanh]
        rec["tanh_gate_per_forward"] = tanh
        rec["tanh_gate_last"] = float(torch.tanh(
            params["blocks"][0]["attn"]["gate"]).reshape(-1)[0])
        half = gates.limit // 2
        ok = ok and len(tanh) == gates.limit \
            and all(v == 0.0 for v in tanh[:half]) \
            and all(v != 0.0 for v in tanh[half:])
        ok = ok and total - peak >= MEDIA_FREE_GB
    rec["media_ok"] = ok
    print(json.dumps({"media_check": {k: rec[k] for k in (
        "memory", "batch_draw_s", "media_shape", "f_two_media_draws",
        "media_ok") + (("f_two_media_draws_gate_1", "tanh_gate_per_forward",
                        "tanh_gate_last") if gates is not None else ())},
        "media_spans": rec["media_spans"]}), flush=True)
    if not ok:
        raise AssertionError(f"phase 16: the media do not reach the loss, "
                             f"the gate did not move, or the memory left "
                             f"is under {MEDIA_FREE_GB} GB: {rec}")
    return rec


def media_phase(torch, dev, T: int) -> tuple:
    """Phase 16: (a), (b) the :data:`MEDIA_CELLS`, T rounds each through
    the launcher's setup and ``run_rounds``, then
    :func:`media_cell_record`; (c) the reduced llama-3.2-vision-90b and
    whisper-small, 2 rounds card against CPU on 14(d)'s two wires.
    Returns ``(record, launch records)``."""
    import functools
    from repro_torch import configs
    from repro_torch.comm import flat
    from repro_torch.configs.base import CompressorConfig
    cells = []
    for name, arch, cuts, argv, downlink in MEDIA_CELLS:
        t0 = time.time()
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, **cuts)
        spec = meta_spec(torch, cfg)
        kind = argv[argv.index("--uplink") + 1]
        layout = flat.wire_layout(spec, CompressorConfig(kind=kind,
                                                         ratio=0.1))
        print(json.dumps({"media_cell": name, "d": spec.d,
                          "cuts": {k: [getattr(full, k), v]
                                   for k, v in cuts.items()},
                          "blocks": [r.block for r in layout.runs],
                          "k": [r.k for r in layout.runs]}), flush=True)
        calls = MEDIA_GATE_CALLS * (2 if cfg.remat else 1)
        with (GateRecorder(torch, calls) if cfg.family == "vlm"
              else contextlib.nullcontext()) as gates:
            rec = train_phase(
                torch, name, ["--arch", arch] + argv, T, downlink=downlink,
                after=functools.partial(media_cell_record, gates=gates),
                cfg=cfg, d_want=spec.d)
        spans = rec["media_spans"]["spans"]
        summary = {
            "media_cell": name, "d": rec["d"],
            "s_per_round_after_first": rec["s_per_round_after_first"],
            "batch_draw_s": rec["batch_draw_s"],
            "device_ms": rec["profile"]["device_ms"],
            "launches": rec["profile"]["kernel_launches"],
            "busy_share": rec["profile"]["busy_share"],
            "peak_gb": rec["peak_mem_gb"],
            "cross_attention_fwd_device_ms": sum(
                spans.get(k, {}).get("device_ms", 0.0)
                for k in ("media.cross_kv", "media.cross_attention")),
            "encoder_fwd_device_ms": spans.get("media.encode", {}).get(
                "device_ms")}
        print(json.dumps(summary), flush=True)
        rec.update({"arch": arch, "cuts": cuts, "summary": summary,
                    "seconds": time.time() - t0})
        cells.append(rec)
    t0 = time.time()
    checks = family_card_check(torch, MEDIA_CHECK_ARCHS, "16(c)")
    seconds = {c["phase"]: c["seconds"] for c in cells}
    seconds["16c"] = time.time() - t0
    print(json.dumps({"media_seconds": seconds}), flush=True)
    return ({"cells": cells, "checks": checks, "seconds": seconds},
            [{"phase": c["phase"], "launches": c["launches"]}
             for c in cells])


# phase 17: the wire (repro_torch.wire), cross-process federation.  17(a)
# runs the launcher's --wire over worker processes on the reduced LM
# problem, beside 17(d) (both untimed checks, mostly process start-ups);
# 17(b), (c) train mamba2-130m whole (d = 128,983,488) over 4 worker
# threads, 8 clients, gather 4: the largest of the port's models whose
# flat buffer crosses the reference's frame bound (MAX_FRAME = 2^30 bytes:
# one ACTIVATE frame holds 4d bytes, a worker's EF_DUMP 4d per residual row,
# so 4 workers of 2 clients; smollm-360m's 4d is 1.45 GB); 17(d) SIGKILLs a
# worker process and recovers.  Worker threads share the card's default
# stream and this process's launch counters; worker processes count their
# own, so 17(a) counts none here and 17(d) the coordinator's reduces only.
WIRE_ARCH = "mamba2-130m"
WIRE_PROBLEM = "chip-smoke-mamba2-130m"
WIRE_WORKERS = 4
WIRE_ROUNDS = 3                # round 1 timed, profiled (the card's
                               # kernels only) and its host seconds split;
                               # round 2 checked (after a round that left
                               # the residual rows nonzero)
WIRE_CELLS = [("17b mamba2-130m wire topk", "topk"),
              ("17c mamba2-130m wire quant", "quant")]
# 17(a)'s launcher and 17(d)'s recovery: 2 rounds each (3 until phase 22
# came; the launcher's process start-ups and the kill's respawn are most
# of their time)
WIRE_LAUNCH_ROUNDS = 2
WIRE_LAUNCH = ["--wire", "2", "--reduced", "--clients", "4",
               "--participating", "2", "--comm", "pallas", "--uplink",
               "topk", "--rounds", str(WIRE_LAUNCH_ROUNDS)]
WIRE_KILL_SEED = 10            # 17(d): ChaosProcess draws spare round 0's
                               # eval and kill at round 1's (p = 0.5)


def wire_fed(kind: str, n: int, m: int):
    """The launcher's ``--wire`` FedConfig: gather m of n, the full eval,
    lean metrics, pallas ``kind`` 0.1 / 8-bit up, identity down, E = 1."""
    from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                          SwitchConfig)
    return FedConfig(n_clients=n, m=m, local_steps=1, lr=0.03,
                     switch=SwitchConfig(mode="soft", eps=0.0, beta=2.0),
                     uplink=CompressorConfig(kind=kind, ratio=0.1),
                     downlink=CompressorConfig(kind="none"), comm="pallas",
                     participation="gather", full_eval=True,
                     lean_metrics=True)


def register_wire_problem() -> None:
    """17(b), (c)'s full-width problem in the wire's registry (threads
    share it): mamba2-130m at its published widths, all 24 layers, weights
    from a CPU generator seeded ``seed``, one token batch per client from
    one seeded ``seed + 1``, g the minority CE minus 6."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.models import build
    from repro_torch.tasks import lm
    from repro_torch.wire import bootstrap

    @bootstrap.problem(WIRE_PROBLEM)
    def full_width(args, device):
        import torch
        cfg = configs.get_config(WIRE_ARCH)
        fns = build(cfg)
        seed = int(args.get("seed", 0))
        params = bootstrap.tree_to(fns.init(
            torch.Generator().manual_seed(seed), cfg, device="cpu"), device)
        toks, mask = synthetic.client_token_batches(
            torch.Generator().manual_seed(seed + 1), int(args["n_clients"]),
            int(args["batch"]), int(args["seq"]), cfg.vocab, hetero=0.5,
            device=device)
        return (params, lm.LMBatch(tokens=toks, minority_mask=mask),
                lm.make_loss_pair(fns.forward, cfg, budget=6.0))


class HostTimers:
    """While active, the host seconds (summed over threads) in the wire
    codec's CRC-32 (``frames._crc``), its socket sends
    (``frames.write_frame``, coordinator and workers; a send waits while
    its receiver does not read) and the workers' reads of frame bodies
    (``frames._recv_exact`` past the length prefix: the wait for the next
    frame is not counted), and the largest frame written.  The
    coordinator's own socket reads are ``stats.recv_s``."""

    NAMES = ("_crc", "write_frame", "_recv_exact")

    def __init__(self):
        import threading
        self.s = dict.fromkeys(self.NAMES, 0.0)
        self.max_frame = 0
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.s)

    def __enter__(self):
        from repro_torch.wire import frames
        self._orig = {n: getattr(frames, n) for n in self.NAMES}
        for name, fn in self._orig.items():
            def timed(*args, _fn=fn, _name=name):
                t0 = time.perf_counter()
                try:
                    return _fn(*args)
                finally:
                    dt = time.perf_counter() - t0
                    with self._lock:
                        if _name != "_recv_exact" or args[1] > 4:
                            self.s[_name] += dt
                        if _name == "write_frame":
                            self.max_frame = max(self.max_frame,
                                                 len(args[1]))
            setattr(frames, name, timed)
        return self

    def __exit__(self, *exc):
        from repro_torch.wire import frames
        for name, fn in self._orig.items():
            setattr(frames, name, fn)


def wire_cohort_workers(torch, fed, T: int, workers: int) -> list:
    """Per round, the workers with a sampled client: the uniform law's
    draws replayed on a generator seeded as ``init_state`` seeds the
    state's (each such worker encodes once per wire run)."""
    from repro_torch.fleet import samplers
    from repro_torch.wire.worker import client_range
    gen = torch.Generator().manual_seed(fed.seed)
    out = []
    for _ in range(T):
        mask, _, _ = samplers.get_sampler(fed.fleet.sampler).sample(gen, fed)
        out.append(sum(int(mask[lo:hi].sum() > 0) for lo, hi in (
            client_range(fed.n_clients, workers, i)
            for i in range(workers))))
    return out


def wire_oracle(torch, problem: str, args: dict, fed, T: int, dev):
    """``rounds.drive`` on the wire's problem and config on the card, one
    metrics segment a round (so each round's wall time is read): ``(state,
    metrics, s per round)``."""
    from repro_torch.engine import rounds
    from repro_torch.wire import bootstrap
    params, batches, pair = bootstrap.build_problem(
        problem, dict(args, n_clients=fed.n_clients), dev)
    state = rounds.init_state(params, fed, device=dev)
    del params
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]

    def stamp(*_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    state, mets = rounds.drive(state, batches, pair, fed, T, device=dev,
                               block=1, progress=stamp)
    return state, mets, [b - a for a, b in zip(stamps, stamps[1:])]


def wire_equal(torch, name: str, st_o, mets_o, st_w, mets_w,
               fields=("w", "x", "e_up", "wbar_sum", "wbar_weight")):
    """The wire's state and every metric bit-equal to the oracle's."""
    import numpy as np
    from repro_torch.engine import rounds
    bad = [f for f in fields
           if not bits_equal(torch, np, getattr(st_o, f), getattr(st_w, f))]
    bad += [f"metrics.{f}" for f in rounds.RoundMetrics._fields
            if not bits_equal(torch, np, getattr(mets_o, f),
                              getattr(mets_w, f))]
    if bad:
        raise AssertionError(f"{name}: the wire differs from rounds.drive "
                             f"in {bad}")


def wire_cell(torch, dev, name: str, kind: str) -> dict:
    """17(b) / (c): the oracle (``rounds.drive``, WIRE_ROUNDS rounds) then
    ``wire_drive(spawn="thread", workers=4)`` on the same problem: every
    round timed; round 1's frames and host seconds recorded, its device
    work under ``torch.profiler`` (the card's activity only, which leaves
    the host's time alone); round 2 under ``PlainCheck`` (every launch,
    every thread); state and every metric bit-equal, each kernel launched
    as the cohorts demand."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.comm import flat
    from repro_torch.obs import sinks as obs_sinks
    from repro_torch.wire import frames, wire_drive
    from torch.profiler import ProfilerActivity, profile
    T, fed = WIRE_ROUNDS, wire_fed(kind, N_GATHER, M_GATHER)
    args = {"batch": 2, "seq": 64}
    t0 = time.time()
    st_o, mets_o, oracle_s = wire_oracle(torch, WIRE_PROBLEM, args, fed, T,
                                         dev)
    oracle_seconds = time.time() - t0
    spec = st_o.spec
    runs = len(flat.wire_layout(spec, fed.uplink).runs)
    active = wire_cohort_workers(torch, fed, T, WIRE_WORKERS)
    enc, red = PHASE_KERNELS[kind]
    want = {enc: runs * sum(active), red: runs * T}
    timers, chk = HostTimers(), PlainCheck(torch, any_thread=True)
    sink = obs_sinks.get_sink("memory")
    marks, snaps = [], {}
    prof = profile(activities=[ProfilerActivity.CUDA])

    def progress(t, f, g, s):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        snaps[t] = timers.snapshot()
        if t == 1:
            prof.__enter__()
        elif t == 2:
            prof.__exit__(None, None, None)
            chk.__enter__()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with timers:
            st_w, mets_w, stats = wire_drive(
                fed, T, workers=WIRE_WORKERS, spawn="thread",
                problem=WIRE_PROBLEM, problem_args=args, deadline=900.0,
                sink=sink, device=dev, progress=progress)
    finally:
        if 2 in snaps:
            chk.__exit__(None, None, None)
    torch.cuda.synchronize()
    after = {"close_s": time.perf_counter() - marks[-1]}
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t1 = time.perf_counter()
    wire_equal(torch, name, st_o, mets_o, st_w, mets_w)
    del st_o, st_w
    after["compare_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    kernels_dev = device_kernels(prof)
    after["profile_read_s"] = time.perf_counter() - t1
    device_ms = sum(dev_us(e) for e in kernels_dev) / 1e3
    wire_s = [marks[0] - t0] + [b - a for a, b in zip(marks, marks[1:])]
    r1 = [r for r in sink.records if r["round"] == 1][0]
    host = {k: snaps[2][k] - snaps[1][k] for k in snaps[1]}
    ef = stats.by_kind.get("ef_dump", [0, 0])
    rec = {
        "wire_cell": name, "arch": WIRE_ARCH, "d": spec.d,
        "workers": WIRE_WORKERS, "clients": fed.n_clients,
        "participating": fed.m, "uplink": kind, "comm": fed.comm,
        "rounds": T, "wire_s_per_round": wire_s,
        "drive_s_per_round": oracle_s, "after_rounds": after,
        "wire_s_round1": wire_s[1], "drive_s_round1": oracle_s[1],
        "oracle_seconds": oracle_seconds,
        "frames_round1": r1["wire_kinds"],
        "bytes_round1": sum(v[1] for v in r1["wire_kinds"].values()),
        "ef_dump": {"frames": ef[0], "bytes": ef[1]},
        "max_frame_bytes": timers.max_frame,
        "max_frame_limit": frames.MAX_FRAME,
        "host_s_round1": {"crc32": host["_crc"],
                          "send": host["write_frame"],
                          "worker_recv": host["_recv_exact"],
                          "coordinator_recv": r1["wire_recv_ms"] / 1e3},
        "profiled_round": {"device_ms": device_ms,
                           "kernel_launches": sum(e.count
                                                  for e in kernels_dev),
                           "busy_share": device_ms / 1e3 / wire_s[1]},
        "peak_gb": peak_gb, "cohort_workers": active,
        "launches": counts, "launches_expected": want,
        "plain_check": {"kernel_calls": chk.calls, "max_abs_err": chk.err,
                        "input_shapes": chk.layouts, "tolerance": 0.0},
        "f": mets_w.f.tolist(), "g_hat": mets_w.g_hat.tolist(),
        "sigma": mets_w.sigma.tolist(),
        "totals": stats.totals}
    print(json.dumps(rec), flush=True)
    for kname, cnt in counts.items():
        if cnt != want.get(kname, 0):
            raise AssertionError(f"{name}: {kname} launched {cnt} times, "
                                 f"expected {want.get(kname, 0)}")
    checked = {PHASE_KERNELS[kind][0],
               "quant_agg" if kind == "quant" else "scatter_agg"}
    chk_names = {"unpack_mma" if k == "quant_agg" else k for k in checked}
    if any(chk.err.values()) or not chk_names <= set(chk.calls):
        raise AssertionError(f"{name}: a kernel launch of the checked "
                             f"round differs from its plain version, or "
                             f"none ran: {rec['plain_check']}")
    if timers.max_frame >= frames.MAX_FRAME or stats.totals["missing"]:
        raise AssertionError(f"{name}: frame bound or missing frames: "
                             f"{timers.max_frame}, {stats.totals}")
    if not np.isfinite(mets_w.f).all():
        raise AssertionError(f"{name}: non-finite f")
    torch.cuda.empty_cache()
    return rec


def wire_launcher_start():
    """17(a)'s subprocess, started: ``python -m repro_torch.launch.train
    --wire 2 --reduced ...`` on the card (its 2 workers are processes
    too), its JSONL sink and its output under ``build/``.  Returns what
    :func:`wire_launcher_check` waits for."""
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    path, log = build / "wire_17a.jsonl", build / "wire_17a.log"
    path.unlink(missing_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *WIRE_LAUNCH,
             "--sink", "jsonl", "--sink-path", str(path), "--quiet"],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, path, log, time.time()


def wire_launcher_check(torch, dev, started) -> dict:
    """17(a): waits for :func:`wire_launcher_start`'s subprocess (``started``;
    killed if it is still running after 600 s); each round's f, g_hat and
    sigma (its JSONL sink) equal ``rounds.drive`` on
    ``build_problem("lm")`` with the launcher's FedConfig, bit for bit."""
    proc, path, log, t0 = started
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.time() - t0
    text = log.read_text()
    log.unlink()
    if rc != 0:
        raise AssertionError(f"17(a): the launcher exited {rc}:\n"
                             f"{text[-6000:]}")
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    meta, recs = recs[0]["meta"], [r for r in recs[1:] if r["round"] >= 0]
    path.unlink()
    fed = wire_fed("topk", 4, 2)
    _, mets, _ = wire_oracle(torch, "lm", {"batch": 2, "seq": 64}, fed,
                             WIRE_LAUNCH_ROUNDS, dev)
    rec = {"wire_launcher": " ".join(WIRE_LAUNCH), "seconds": seconds,
           "device": meta.get("device"),
           "rounds": [{k: r[k] for k in ("round", "f", "g_hat", "sigma",
                                         "wire_frames", "wire_bytes")}
                      for r in recs]}
    print(json.dumps(rec), flush=True)
    for key in ("f", "g_hat", "sigma"):
        if [r[key] for r in recs] != [float(v) for v in getattr(mets, key)]:
            raise AssertionError(f"17(a): {key} over the wire "
                                 f"{[r[key] for r in recs]} differs from "
                                 f"drive's {getattr(mets, key).tolist()}")
    if not meta.get("device", "").startswith("cuda"):
        raise AssertionError(f"17(a): the launcher ran on {meta}")
    return rec


def wire_fault_check(torch, dev) -> dict:
    """17(d): ``wire_drive(spawn="process")`` on the reduced LM problem
    with a ``WireFaultConfig`` and a seeded ``ChaosProcess`` that SIGKILLs
    a worker at round 1's eval: respawned, EF re-seeded from the pre-round
    snapshot (``ckpt_every=1``), the round replayed -- bit-equal to the
    clean oracle, ``respawns`` >= 1.  The launches are the coordinator's
    reduce."""
    import shutil
    from repro_torch import kernels
    from repro_torch.comm import flat
    from repro_torch.wire import wire_drive
    from repro_torch.wire.supervisor import WireFaultConfig
    fed, T = wire_fed("topk", 4, 2), WIRE_LAUNCH_ROUNDS
    args = {"batch": 2, "seq": 64}
    st_o, mets_o, _ = wire_oracle(torch, "lm", args, fed, T, dev)
    ckpt = ROOT / "build" / "wire_17d_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    faults = WireFaultConfig(max_respawns=1, eval_grace=300.0,
                             respawn_window=300.0)
    kernels.reset_launches()
    t0 = time.time()
    try:
        st_w, mets_w, stats = wire_drive(
            fed, T, workers=2, spawn="process", problem="lm",
            problem_args=args, deadline=300.0, faults=faults,
            proc_chaos={"kill": 0.5, "phase": "eval", "max_kills": 1},
            chaos_seed=WIRE_KILL_SEED, ckpt_dir=str(ckpt), ckpt_every=1,
            device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    counts = kernels.launch_counts()
    runs = len(flat.wire_layout(st_o.spec, fed.uplink).runs)
    rec = {"wire_fault": "SIGKILL at round 1's eval, process spawn",
           "seconds": time.time() - t0, "totals": stats.totals,
           "recovery_s": stats.recovery_s, "launches": counts,
           "launches_expected": {"scatter_agg": runs * T}}
    print(json.dumps(rec), flush=True)
    wire_equal(torch, "17(d)", st_o, mets_o, st_w, mets_w)
    if stats.totals["respawns"] < 1 or stats.totals["recovered"] < 1:
        raise AssertionError(f"17(d): no respawn: {stats.totals}")
    if counts != {**dict.fromkeys(counts, 0), "scatter_agg": runs * T}:
        raise AssertionError(f"17(d): launches {counts}")
    return rec


def wire_phase(torch, dev) -> tuple:
    """Phase 17: (b), (c) :func:`wire_cell` for :data:`WIRE_CELLS`; then
    (a)'s launcher (:func:`wire_launcher_start`) and the subprocesses of
    18(d) and 19(f) (:func:`start_commands`) started, (d)
    :func:`wire_fault_check` while they run, and (a)
    :func:`wire_launcher_check`, 18(d) and 19(f) waited for.  Returns
    ``(record, launch records, {"18(d)": record, "19(f)": record})``."""
    register_wire_problem()
    seconds, cells = {}, []
    for name, kind in WIRE_CELLS:
        t0 = time.time()
        cells.append(wire_cell(torch, dev, name, kind))
        seconds[name.split()[0]] = time.time() - t0
    t0 = time.time()
    started = wire_launcher_start()
    serving = [start_commands(SERVE_COMMANDS, "18(d)"),
               start_commands(STATE_COMMANDS, "19(f)")]
    try:
        fault = wire_fault_check(torch, dev)
        seconds["17d"] = time.time() - t0
        launcher = wire_launcher_check(torch, dev, started)
        commands = {s[0]: finish_commands(s) for s in serving}
    finally:
        if started[0].poll() is None:
            started[0].kill()
            started[0].wait()
        for s_ in serving:
            stop_commands(s_)
    seconds["17a"] = launcher["seconds"]
    seconds["18d"] = commands["18(d)"][-1]["seconds"]
    seconds["19f"] = commands["19(f)"][-1]["seconds"]
    seconds["17a, 17d, 18d, 19f"] = time.time() - t0
    print(json.dumps({"wire_seconds": seconds}), flush=True)
    return ({"launcher": launcher, "cells": cells, "fault": fault,
             "seconds": seconds},
            [{"phase": c["wire_cell"], "launches": c["launches"]}
             for c in cells]
            + [{"phase": "17d wire SIGKILL recovered",
                "launches": fault["launches"]}], commands)


# phase 18: serving (prefill, then greedy one-token decode over the KV
# caches) of the dense and vlm families at full published width, each cell
# under torch.inference_mode with weights from CPU generators (seed 0) and
# the launcher's prompts and media (``serve.draw_inputs``: a CPU generator
# seeded 0; media normal * 0.1).  (name, arch, config changes, batch,
# prompt, decode steps): 18(a) qwen3-4b whole (36 layers, 4,411,424,256
# parameters): the homogeneous stacked cache with qk-norm; 18(b) gemma3-4b
# whole (34 layers, window 1024, 5:1): a prompt of 1,100 > window + 1, so
# every local layer's ring holds the whole prompt and decodes past
# position 1,024 (where the port departs from the reference's ring mask);
# 18(c) llama-3.2-vision-90b at its published widths and vocab, cut to one
# period (4 self layers and 1 cross layer, about 6.38B parameters), its
# gate set to 0.5 (at 0 a cross layer adds nothing): the cross caches
# filled at prefill and read at decode.  cache_len = prompt + steps
SERVE_CELLS = [
    ("18a qwen3-4b", "qwen3-4b", {}, 4, 512, 32),
    ("18b gemma3-4b", "gemma3-4b", {}, 4, 1100, 16),
    ("18c llama-3.2-vision-90b 5 layers", "llama-3.2-vision-90b",
     {"n_layers": 5}, 4, 32, 16),
]
# 18(a)-(c): each decode step's logits against the card's own forward over
# the prompt and the decoded tokens, |decode - forward| <= SERVE_RTOL *
# max|forward logits of the cell|: float32 throughout, TF32 off, so the two
# differ only by the order of the GEMMs' sums (a [4, d] row block against a
# [4 * S, d] one, cuBLAS picking other tilings); float32's 2^-24 grows
# about with the square root of the sum lengths (d_ff 9,728-28,672) and
# the depth, which puts the expected difference near 1e-6 of the largest
# logit (2e-6 to 5e-6 measured on an H100): 1e-4 leaves a margin of 20 or
# more, and a wrong mask or cache slot moves logits by 1e-2 to 1 of it
# (the reference's ring on reduced gemma3: 0.08-0.45)
SERVE_RTOL = 1e-4
SERVE_CHUNK = 1 << 24          # entries one CPU generator draws
SERVE_THREADS = 8
# 18(d): the entry points as subprocesses on the card, each must exit 0 and
# print its line
SERVE_COMMANDS = [
    (["-m", "repro_torch.launch.serve"], r"\[qwen3-4b\] batch=4 decode "),
    (["-m", "repro_torch.launch.serve", "--arch", "smollm-360m",
      "--no-reduced"], r"\[smollm-360m\] batch=4 decode "),
    (["-m", "repro_torch.examples.serve_batched", "--arch", "gemma3-4b"],
     r"decoded 16 steps x batch 4: .* ms/step \(cuda, reduced config\)"),
]


FILLED = ("A_log", "D", "dt_bias", "lam")   # init's constant leaves


def cpu_drawn_params(torch, fns, cfg, dev, seed: int = 0) -> dict:
    """A model's weights on the card with ``init``'s distributions
    (``common.init_tree``'s rules: zeros for the norms and gates, the
    constants of :data:`FILLED`, 0.02 * normal for the embeddings, 0.1 *
    normal for a conv, fan-in scaled normals for the rest), drawn on
    CPU generators: one per chunk of SERVE_CHUNK entries, seeded ``seed``,
    ``seed + 1``, ... in the tree's order, SERVE_THREADS at a time, each
    chunk copied to the card as soon as it is drawn (one generator draws
    about 0.1 G entries a second: 4.4B would take a minute)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.models import common
    jobs = []

    def leaf(name, shape):
        if name in FILLED:         # constants: no draw
            return common._init_leaf(None, name, shape, dev)
        out = torch.zeros(shape, dtype=torch.float32, device=dev)
        if name in common._ZEROS:
            return out
        scale = 0.02 if name in common._EMBEDS else 0.1 \
            if name == "conv_w" else 1.0 / math.sqrt(max(shape[-2], 1))
        flat_out = out.view(-1)
        for a in range(0, flat_out.numel(), SERVE_CHUNK):
            jobs.append((flat_out[a:a + SERVE_CHUNK], seed + len(jobs),
                         scale))
        return out

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return leaf(name, tuple(tree))

    params = walk(fns.param_shapes(cfg))

    def draw(job):
        dst, chunk_seed, scale = job
        gen = torch.Generator().manual_seed(chunk_seed)
        dst.copy_(torch.randn(dst.numel(), generator=gen).mul_(scale))

    with ThreadPoolExecutor(SERVE_THREADS) as ex:
        list(ex.map(draw, jobs))
    torch.cuda.synchronize()
    return params


def decode_traffic(torch, cfg, cache, batch: int) -> tuple:
    """One decode step's cache entries ``(read, written, operations)``:
    every cache leaf read once; written, one slot a layer of a KV cache
    (self layers only) or an MLA latent cache, a recurrent layer's whole
    conv window and state (mamba2's SSM state too); operations, 2 *
    (n_heads / n_kv_heads) a KV entry, 4 * n_heads a latent ``c_kv``
    entry and 2 * n_heads a ``k_rope`` one (the absorbed scores and
    context), 4 a recurrent state entry (decay, update, readout)."""
    from repro_torch.models import attention, mla, transformer

    def numel(tree):
        return sum(x.numel() for x in torch_leaves(tree))
    rep = cfg.n_heads // max(cfg.n_kv_heads, 1)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        read = numel(cache.layers)
        n_self = sum(p["kind"] == "self" for p in transformer.layer_plan(cfg))
        written = 2 * n_self * batch * cfg.n_kv_heads * cfg.resolved_head_dim
        return read, written, 2 * rep * read
    if fam == "ssm":
        read = numel(cache)
        return read, read, 4 * cache.ssm.numel()
    if fam == "moe":
        read = written = ops = 0
        for c in list(cache.dense) + [cache.moe]:
            read += numel(c)
            written += numel(c) // c.c_kv.shape[-2]
            ops += 4 * cfg.n_heads * c.c_kv.numel() + \
                2 * cfg.n_heads * c.k_rope.numel()
        return read, written, ops
    if fam == "hybrid":
        read = written = ops = 0
        for c in cache.layers["blocks"] + cache.layers["rest"]:
            read += numel(c)
            if isinstance(c, attention.KVCache):
                written += numel(c) // c.k.shape[-3]
                ops += 2 * rep * numel(c)
            else:
                written += numel(c)
                ops += 4 * c["state"].numel()
        return read, written, ops
    if fam == "audio":
        kv = cache.self_kv
        return (numel(kv) + cache.enc.numel(), numel(kv) // kv.k.shape[-3],
                2 * rep * numel(kv))
    raise ValueError(fam)


def serve_bound(torch, cfg, params, cache, batch: int) -> dict:
    """The bound of one decode step, the larger of a byte and an operation
    time.  Bytes: every weight the step reads, once (an untied embedding
    table only at the ``batch`` rows it looks up; whisper's decoder alone,
    its learned positions at one row; no MTP head), and the cache's
    traffic (:func:`decode_traffic`), over the card's memory rate.
    Operations: 2 * batch a weight read, the cache's operations, and
    whisper's cross keys and values recomputed from its encoder states in
    every layer (``2 * 2 * batch * n_frames * d * n_kv * hd`` a layer) and
    attended (``2 * 2 * batch * n_frames * n_heads * hd``), over the
    float32 rate."""
    def numel(tree):
        return sum(x.numel() for x in torch_leaves(tree))
    weights = numel(params)
    if not cfg.tie_embeddings:
        weights -= params["embed"].numel() - batch * cfg.d_model
    for name in ("mtp", "encoder", "pos_emb_enc", "ln_enc"):
        weights -= numel(params.get(name))
    if "pos_emb_dec" in params:
        weights -= params["pos_emb_dec"].numel() - cfg.d_model
    read, written, cache_ops = decode_traffic(torch, cfg, cache, batch)
    recompute = 0
    if cfg.family == "audio":
        frames = batch * cache.enc.shape[1]
        kv_w = cfg.n_kv_heads * cfg.resolved_head_dim
        recompute = cfg.n_layers * (
            4 * frames * cfg.d_model * kv_w
            + 4 * frames * cfg.n_heads * cfg.resolved_head_dim)
    nbytes = 4 * (weights + read + written)
    ops = 2 * batch * weights + cache_ops + recompute
    ms, by = bound_ms(nbytes, ops)
    return {"bound_ms": ms, "bound_by": by, "bytes": nbytes,
            "weight_bytes": 4 * weights, "cache_bytes": 4 * read,
            "operations": ops, "recompute_operations": recompute}


def config_with(cfg, over: dict):
    """``dataclasses.replace(cfg, **over)``; ``capacity_factor`` goes to
    the MoE config."""
    over = dict(over)
    if "capacity_factor" in over:
        over["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=over.pop("capacity_factor"))
    return dataclasses.replace(cfg, **over)


class RouteLog:
    """The router's choices while active (``with``): wraps
    ``models.moe.route`` and keeps each call's ``(probs, idx)`` on its
    device (no synchronisation)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.calls = moe, moe.route, []

        def route(router, xg, k):
            out = self.real(router, xg, k)
            self.calls.append((out[0], out[2]))
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def dropped_routes(torch, idx, E: int, C: int) -> int:
    """The choices ``idx`` ``[ng, G, k]`` that a capacity of ``C`` slots
    an expert and group drops (token-major priority, as
    ``moe.dispatch``)."""
    ng, G, k = idx.shape
    onehot = torch.nn.functional.one_hot(idx.reshape(ng, G * k), E)
    pos = (onehot * (onehot.cumsum(1) - onehot)).sum(-1)
    return int((pos >= C).sum())


def serve_cell(torch, dev, name: str, arch: str, over: dict, batch: int,
               prompt: int, steps: int) -> dict:
    """18(a)-(c): ``prefill`` of ``batch`` prompts (``cache_len = prompt +
    steps``; timed twice, the first call and a warm one, whose cache is
    kept), then ``steps`` greedy ``decode_step`` calls: step 0 warms up,
    steps 1 .. steps - 2 are timed between two synchronisations (ms per
    step, tokens/s), the last runs under ``torch.profiler`` (device ms,
    launches, busy share against the timed steps' wall).  Then the card's
    ``forward`` over the prompt and the decoded tokens (one call: its
    logits at a position depend only on the tokens up to it, so position
    ``prompt + k`` is the forward over the prompt and the first k + 1
    decoded tokens) against the prefill's last logits and every decode
    step's, within SERVE_RTOL of the forward's largest logit.  A moe
    cell's decode routes are logged: the choices dropped at its capacity
    and at the published one (:data:`PUBLISHED_CAPACITY`), a decode
    step."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import build, moe
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    cfg = config_with(configs.get_config(arch), over)
    fns = build(cfg)
    t0 = time.time()
    params = cpu_drawn_params(torch, fns, cfg, dev)
    draw_s = time.time() - t0
    if cfg.family == "vlm":
        for blk in params["blocks"]:
            if "gate" in blk["attn"]:
                blk["attn"]["gate"].fill_(0.5)
    toks, kw = serve.draw_inputs(cfg, batch, prompt, dev)
    cap = prompt + steps
    with torch.inference_mode():
        prefill_ms = []
        for _ in range(2):          # the first call, then a warm one
            logits = cache = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fns.prefill(params, cfg, toks, cap, **kw)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        outs, fed = [logits], []
        timed = (None, None)
        routes = contextlib.ExitStack()
        log = routes.enter_context(RouteLog()) if cfg.family == "moe" \
            else None

        def step(i):
            nonlocal logits, cache
            tok = serve.greedy(logits)
            fed.append(tok)
            logits, cache = fns.decode_step(params, cfg, tok, cache,
                                            prompt + i)
            outs.append(logits)
        for i in range(steps - 1):
            if i == 1:
                torch.cuda.synchronize()
                timed = (time.perf_counter(), None)
            step(i)
        torch.cuda.synchronize()
        timed = (timed[0], time.perf_counter())
        step_ms = (timed[1] - timed[0]) * 1e3 / (steps - 2)
        bound = serve_bound(torch, cfg, params, cache, batch)
        device_ms, launches, kernels = profile_device(
            torch, lambda: step(steps - 1))
        routes.close()
        top = sorted(kernels, key=dev_us, reverse=True)[:6]
        seq = torch.cat([toks] + fed, dim=1)
        want = fns.forward(params, cfg, seq, **kw)
        if isinstance(want, tuple):         # moe: (logits, aux[, mtp])
            want = want[0]
        want = want[:, prompt - 1:]
        got = torch.cat(outs, dim=1)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        err_by_step = (got - want).abs().amax(dim=(0, 2)).tolist()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = {"serve_cell": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "n_params": sum(x.numel() for x in torch_leaves(params)),
           "batch": batch, "prompt": prompt, "steps": steps,
           "cache_len": cap, "cpu_draw_s": draw_s,
           "prefill_ms_first": prefill_ms[0], "prefill_ms": prefill_ms[1],
           "decode_ms_per_step": step_ms,
           "tokens_per_s": batch / step_ms * 1e3,
           "profiled_step": {"device_ms": device_ms,
                             "kernel_launches": launches,
                             "busy_share": device_ms / step_ms,
                             "top_ms": {e.key[:100]: dev_us(e) / 1e3
                                        for e in top},
                             "top_calls": {e.key[:100]: e.count
                                           for e in top}},
           "peak_gb": peak_gb, "resident_gb_before": resident_gb, **bound,
           "bound_share": bound["bound_ms"] / step_ms,
           "check": {"max_abs_err": err, "max_abs_logit": scale,
                     "tolerance": SERVE_RTOL * scale,
                     "positions": [prompt - 1, prompt + steps - 1],
                     "err_by_position": err_by_step},
           "card": card_line()}
    if log is not None:
        n_moe = cfg.n_layers - cfg.moe.first_dense
        E = cfg.moe.n_experts
        caps = {"run": cfg.moe.capacity_factor,
                "published": PUBLISHED_CAPACITY}
        rec["dropped_routes"] = {
            key: [sum(dropped_routes(torch, idx, E, moe.capacity(
                idx.shape[1], dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf)))
                for _, idx in log.calls[j * n_moe:(j + 1) * n_moe])
                for j in range(steps)]
            for key, cf in caps.items()}
        rec["dropped_routes"]["capacity_factor"] = caps
        rec["dropped_routes"]["choices_a_step"] = \
            batch * cfg.moe.top_k * n_moe
    print(json.dumps(rec), flush=True)
    del params, cache, logits, outs, want, got, kw, log
    gc.collect()
    torch.cuda.empty_cache()
    if not math.isfinite(err) or err > SERVE_RTOL * scale:
        raise AssertionError(f"{name}: decode differs from the forward by "
                             f"{err} (limit {SERVE_RTOL * scale})")
    return rec


def torch_leaves(tree):
    """The tensors of a tree of dicts, lists and tuples (None dropped)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from torch_leaves(v)
    elif tree is not None:
        yield tree


def start_commands(commands, label: str):
    """18(d), 19(f): ``commands`` as subprocesses started together on the
    card (``PYTHONPATH=src``), each one's output to a file under
    ``build/``; what :func:`finish_commands` waits for."""
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    procs = []
    for i, (argv, pat) in enumerate(commands):
        log = build / f"serve_{label[:2]}_{i}.log"
        with open(log, "w") as out:
            procs.append((argv, pat, log, subprocess.Popen(
                [sys.executable, *argv], cwd=ROOT, env=env, stdout=out,
                stderr=subprocess.STDOUT)))
    return label, procs, time.time()


def finish_commands(started) -> list:
    """Waits for :func:`start_commands`' subprocesses (``started``; each
    killed if still running 300 s from the start): each must exit 0 and
    print its line."""
    import re
    label, procs, t0 = started
    recs = []
    try:
        for argv, pat, log, proc in procs:
            rc = proc.wait(timeout=max(1.0, t0 + 300 - time.time()))
            text = log.read_text()
            line = next((x for x in text.splitlines() if re.search(pat, x)),
                        None)
            recs.append({"command": " ".join(argv), "rc": rc,
                         "line": line, "seconds": time.time() - t0})
            if rc != 0 or line is None:
                raise AssertionError(f"{label}: {' '.join(argv)} exited "
                                     f"{rc}:\n{text[-6000:]}")
            log.unlink()
    finally:
        stop_commands(started)
    print(json.dumps({"serve_commands": recs, "part": label}), flush=True)
    return recs


def stop_commands(started) -> None:
    """Kills what is left of :func:`start_commands`' subprocesses."""
    for _, _, _, proc in started[1]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def serve_phase(torch, dev, commands=None) -> tuple:
    """Phase 18: :func:`serve_cell` for :data:`SERVE_CELLS`; ``commands``
    is 18(d)'s record (:data:`SERVE_COMMANDS`, run beside 17(d) in the
    whole script; None: run here, after the cells); no wire kernel may
    launch.  Returns ``(record, launch records)``."""
    from repro_torch import kernels
    t_phase = time.time()
    kernels.reset_launches()
    cells, seconds = [], {}
    for cell in SERVE_CELLS:
        t0 = time.time()
        cells.append(serve_cell(torch, dev, *cell))
        seconds[cell[0].split()[0]] = time.time() - t0
    if commands is None:
        t0 = time.time()
        commands = finish_commands(start_commands(SERVE_COMMANDS, "18(d)"))
        seconds["18d"] = time.time() - t0
    counts = kernels.launch_counts()
    seconds["phase"] = time.time() - t_phase
    print(json.dumps({"serve_seconds": seconds}), flush=True)
    if any(counts.values()):
        raise AssertionError(f"phase 18 launched wire kernels: {counts}")
    return ({"cells": cells, "commands": commands, "seconds": seconds},
            [{"phase": "18 serving", "launches": counts}])


# phase 19: serving of the state-cache families, cells as 18(a)-(c): (name,
# arch, config changes, batch, prompt, steps), cache_len = prompt + steps.
# 19(c) deepseek-v2-236b at its published widths, all 160 routed experts
# and vocab 102,400, cut to 3 of 60 layers (1 dense + 2 MoE; 9.57B
# parameters, 38.3 GB), capacity_factor 1.25 -> 27: C = round(1.0125 G)
# >= G, so no route is dropped and the decode and the checked forward
# route the same tokens (with drops they route different token sets and
# cannot agree, as in the reference's own consistency test)
STATE_CELLS = [
    ("19a mamba2-130m", "mamba2-130m", {}, 4, 1000, 32),
    ("19b recurrentgemma-2b", "recurrentgemma-2b", {}, 4, 2040, 16),
    ("19c deepseek-v2-236b 3 layers", "deepseek-v2-236b",
     {"n_layers": 3, "capacity_factor": 27.0}, 4, 256, 16),
    ("19d whisper-small", "whisper-small", {}, 4, 64, 32),
]
PUBLISHED_CAPACITY = 1.25      # deepseek's capacity_factor
# 19(e): the reduced configs, prefill and STATE_CHECK_STEPS decode steps on
# the card against the CPU (the moe archs at the published capacity)
STATE_CHECK_ARCHS = ["mamba2-130m", "recurrentgemma-2b", "deepseek-v2-236b",
                     "deepseek-v3-671b", "whisper-small"]
STATE_CHECK_PROMPT, STATE_CHECK_STEPS = 16, 6
# 19(f): the entry points as subprocesses on the card
STATE_COMMANDS = [
    (["-m", "repro_torch.launch.serve", "--arch", "mamba2-130m",
      "--no-reduced"], r"\[mamba2-130m\] batch=4 decode "),
    (["-m", "repro_torch.launch.serve", "--arch", "recurrentgemma-2b"],
     r"\[recurrentgemma-2b\] batch=4 decode "),
    (["-m", "repro_torch.launch.serve", "--arch", "deepseek-v2-236b"],
     r"\[deepseek-v2-236b\] batch=4 decode "),
    (["-m", "repro_torch.launch.serve", "--arch", "whisper-small"],
     r"\[whisper-small\] batch=4 decode "),
    (["-m", "repro_torch.examples.serve_batched", "--arch",
      "deepseek-v3-671b"],
     r"decoded 16 steps x batch 4: .* ms/step \(cuda, reduced config\)"),
]


def state_card_check(torch, dev, arch: str) -> dict:
    """19(e): one reduced config's prefill (prompt STATE_CHECK_PROMPT,
    batch 2) and STATE_CHECK_STEPS decode steps on the card and on the
    CPU, from the same weights (``init`` on a CPU generator), tokens and
    frames.  A moe arch's router choices must be equal wherever the CPU's
    k-th minus (k+1)-th probability exceeds :data:`MOE_MARGIN`; from the
    step of the first choice that flips under it, the logits are not
    gated (counted).  Every gated step's logits within SERVE_RTOL of the
    CPU's largest."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.wire.bootstrap import tree_to
    cfg = configs.get_reduced(arch)
    fns = build(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg)
    P, T = STATE_CHECK_PROMPT, STATE_CHECK_STEPS
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, P + T)))
    kw = serve.draw_inputs(cfg, 2, 1, torch.device("cpu"))[1]
    res = {}
    for d in (dev, torch.device("cpu")):
        p, dkw = tree_to(params, d), {k: v.to(d) for k, v in kw.items()}
        with RouteLog() as log, torch.inference_mode():
            logits, cache = fns.prefill(p, cfg, toks[:, :P].to(d), P + T,
                                        **dkw)
            got = [logits.cpu()]
            for pos in range(P, P + T):
                logits, cache = fns.decode_step(
                    p, cfg, toks[:, pos:pos + 1].to(d), cache, pos)
                got.append(logits.cpu())
        res[d.type] = (got, [(pr.cpu(), ix.cpu()) for pr, ix in log.calls])
    n_moe = cfg.n_layers - cfg.moe.first_dense if cfg.family == "moe" \
        else 0
    first_flip, over_margin, under = T + 1, 0, 0
    for j, ((_, ix_card), (pr, ix)) in enumerate(zip(res["cuda"][1],
                                                     res["cpu"][1])):
        k = ix.shape[-1]
        srt = pr.sort(-1, descending=True).values
        margin = srt[..., k - 1] - srt[..., k]
        flip = (ix_card != ix).any(-1)
        under += int((margin <= MOE_MARGIN).sum())
        over_margin += int((flip & (margin > MOE_MARGIN)).sum())
        if flip.any():
            first_flip = min(first_flip, j // n_moe)
    scale = max(float(x.abs().max()) for x in res["cpu"][0])
    errs = [float((a - b).abs().max()) for a, b in zip(res["cuda"][0],
                                                        res["cpu"][0])]
    gated = errs[:first_flip]
    rec = {"state_card_check": arch, "prompt": P, "steps": T,
           "max_abs_err": max(gated, default=0.0), "err_by_step": errs,
           "tolerance": SERVE_RTOL * scale, "route_calls": len(res["cpu"][1]),
           "under_margin": under, "flipped_over_margin": over_margin,
           "steps_not_gated": len(errs) - len(gated)}
    rec["ok"] = (over_margin == 0 and all(math.isfinite(e) for e in errs)
                 and max(gated, default=0.0) <= SERVE_RTOL * scale)
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise AssertionError(f"19(e) {arch}: card and CPU disagree: {rec}")
    return rec


def state_serve_phase(torch, dev, commands=None) -> tuple:
    """Phase 19: :func:`serve_cell` for :data:`STATE_CELLS` (19(c) must
    drop no route at its capacity), :func:`state_card_check` for
    :data:`STATE_CHECK_ARCHS`; ``commands`` is 19(f)'s record
    (:data:`STATE_COMMANDS`, run beside 17(d) in the whole script; None:
    run here, last); no wire kernel may launch.  Returns ``(record, launch
    records)``."""
    from repro_torch import kernels
    t_phase = time.time()
    kernels.reset_launches()
    cells, seconds = [], {}
    for cell in STATE_CELLS:
        t0 = time.time()
        rec = serve_cell(torch, dev, *cell)
        if "dropped_routes" in rec and any(rec["dropped_routes"]["run"]):
            raise AssertionError(f"{cell[0]}: routes dropped at capacity "
                                 f"{cell[2]}: {rec['dropped_routes']}")
        cells.append(rec)
        seconds[cell[0].split()[0]] = time.time() - t0
    t0 = time.time()
    checks = [state_card_check(torch, dev, arch)
              for arch in STATE_CHECK_ARCHS]
    seconds["19e"] = time.time() - t0
    if commands is None:
        t0 = time.time()
        commands = finish_commands(start_commands(STATE_COMMANDS, "19(f)"))
        seconds["19f"] = time.time() - t0
    counts = kernels.launch_counts()
    seconds["phase"] = time.time() - t_phase
    print(json.dumps({"state_serve_seconds": seconds}), flush=True)
    if any(counts.values()):
        raise AssertionError(f"phase 19 launched wire kernels: {counts}")
    return ({"cells": cells, "checks": checks, "commands": commands,
             "seconds": seconds},
            [{"phase": "19 state serving", "launches": counts}])


# phase 20: the launch tooling.  (a) the dry run's sweep as a process,
# started after the build and read here; (b)-(f) cases of launch/steps.py
# at a single card's cut of their batch, on a (1, 1) debug mesh: the dry
# run counts each case on meta tensors, the card runs it, and the card's
# bytes of the inputs must equal the dry run's within 1%
LAUNCH_SWEEP = 80              # 10 archs x 4 shapes x 2 meshes
LAUNCH_SKIPS = 14              # long_500k of the 7 full-attention archs
LAUNCH_SWEEP_WAIT = 900        # s the phase waits for the sweep at most
LAUNCH_BYTES_RTOL = 0.01
LAUNCH_DECODE_WARM, LAUNCH_DECODE_TIMED = 2, 5
REMAT_PAIRS = 3                # 20(c): timed rounds of each, in turns
                               # (5 until phase 22 came)
# (label, arch, shape name, seq_len, batch) of the serving cells
LAUNCH_SERVE_CELLS = [
    ("20d qwen3-4b decode_32k", "qwen3-4b", "decode_32k", 32_768, 4),
    ("20e gemma3-4b long_500k", "gemma3-4b", "long_500k", 524_288, 1),
    ("20f mamba2-130m prefill_32k", "mamba2-130m", "prefill_32k", 32_768,
     4)]


def start_dryrun_sweep(out_dir: pathlib.Path):
    """20(a)'s ``python -m repro_torch.launch.dryrun --sweep`` as a process
    of its own, on the host's cores beside phases 3-19 (it builds meta
    tensors only; no card is visible to it).  Returns ``(process, jsonl
    path, log path)``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path, log = out_dir / "dryrun_sweep.jsonl", out_dir / "dryrun_sweep.log"
    path.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--sweep",
             "--out", str(path), "--quiet"], cwd=ROOT, env=env, stdout=f,
            stderr=subprocess.STDOUT)
    return proc, path, log


def sweep_record(sweep) -> dict:
    """20(a): wait for the sweep, then its records: 80, of which 66 ``ok``
    and the 14 reference skips; an ``error`` only for a giant's bf16 train
    case.  Prints the count and each ok record's per-device GB and
    dominant term."""
    from repro_torch.launch import steps
    proc, path, log = sweep
    t0 = time.time()
    rc = proc.wait(timeout=LAUNCH_SWEEP_WAIT)
    waited = time.time() - t0
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    by = {}
    for r in recs:
        by[r["status"]] = by.get(r["status"], 0) + 1
    errors = [r for r in recs if r["status"] == "error"]
    print(json.dumps({"dryrun_sweep": {"records": len(recs), "by_status": by,
                                       "rc": rc, "waited_s": waited}}),
          flush=True)
    for r in recs:
        if r["status"] == "ok":
            print(f"  {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r['memory']['total_per_device'] / 1e9:.3f} GB per "
                  f"device, {r['roofline']['dominant']}-bound "
                  f"({r['flops_source']} flops, {r['count_s']} s)",
                  flush=True)
    for r in errors:
        print(f"  error {r['arch']} x {r['shape']} x {r['mesh']}: "
              f"{r['error'][:300]}", flush=True)
    bad = [r for r in errors if not (r["shape"] == "train_4k"
                                     and r["arch"] in steps.GIANTS)]
    if rc != 0 or len(recs) != LAUNCH_SWEEP or \
            by.get("skip", 0) != LAUNCH_SKIPS or bad or \
            by.get("ok", 0) + len(errors) != LAUNCH_SWEEP - LAUNCH_SKIPS:
        raise AssertionError(f"20(a): the sweep gave {by} over {len(recs)} "
                             f"records (rc {rc}; log {log})")
    return {"records": len(recs), "by_status": by, "waited_s": waited,
            "errors": [(r["arch"], r["mesh"], r["error"][:300])
                       for r in errors],
            "ok": [{k: r[k] for k in ("arch", "shape", "mesh", "chips",
                                      "dtype", "flops_source")}
                   | {"gb_per_device": r["memory"]["total_per_device"] / 1e9,
                      "dominant": r["roofline"]["dominant"],
                      "compute_s": r["roofline"]["compute_s"],
                      "memory_s": r["roofline"]["memory_s"]}
                   for r in recs if r["status"] == "ok"]}


def counted_case(torch, case, cfg, shape) -> dict:
    """The dry run's count of ``case`` on its (1, 1) debug mesh, then the
    mesh deactivated."""
    from repro_torch.launch import dryrun
    from repro_torch.sharding import partition
    try:
        with (torch.enable_grad() if shape.kind == "train"
              else torch.no_grad()):
            return dryrun.count(case, 1, cfg, shape)
    finally:
        partition.activate_mesh(None)


def check_arg_bytes(torch, name: str, before: int, counted: dict) -> dict:
    """The card's bytes of the inputs just built against the dry run's
    per-device argument bytes, within :data:`LAUNCH_BYTES_RTOL`."""
    torch.cuda.synchronize()
    card = torch.cuda.memory_allocated() - before
    want = counted["memory"]["argument_size_in_bytes"]
    rel = abs(card - want) / want
    print(json.dumps({"arg_bytes": name, "card": card, "dry_run": want,
                      "rel": rel}), flush=True)
    if rel > LAUNCH_BYTES_RTOL:
        raise AssertionError(f"{name}: the card holds {card} B of inputs, "
                             f"the dry run counts {want} B")
    return {"card_arg_bytes": card, "dry_run_arg_bytes": want,
            "arg_bytes_rel": rel}


def free_card(torch) -> int:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def bits(torch, x):
    return x.contiguous().view(torch.int32)


def train_4k_cell(torch, dev) -> tuple:
    """20(b): smollm-360m whole (d = 361,821,120) at train_4k's sequence,
    one client of 2 rows (``fed_config_for`` on a (1, 1) mesh: n = m = 1,
    top-k 0.1 up and down on ``comm="pallas"``), remat on: 3 rounds, the
    second with every wire-kernel launch held against its plain version,
    then one profiled; the card's FLOP/s against the dry run's count of
    the same case.  20(c): the same case at seq 1,024, one round with
    remat on and one with it off from the same state: w bit-equal, each
    peak recorded."""
    from repro_torch import configs, kernels
    from repro_torch.configs.base import InputShape
    from repro_torch.engine import rounds
    from repro_torch.launch import mesh, roofline, steps
    from repro_torch.models import build
    from repro_torch.sharding import partition
    from repro_torch.tasks import lm
    cfg = configs.get_config("smollm-360m")
    debug = mesh.make_debug_mesh((1, 1))
    shape = InputShape("train_4k", 4096, 2, "train")
    case = steps.build_train_case(cfg, shape, debug, comm="pallas")
    fed = case.meta["fed"]
    t0 = time.time()
    counted = counted_case(torch, case, cfg, shape)
    count_s = time.time() - t0
    before = free_card(torch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build(cfg).init(gen, cfg, device=dev)
    state = rounds.init_state(params, fed, device=dev)
    del params
    S = shape.seq_len
    toks = torch.randint(0, cfg.vocab, (1, 2, S), generator=gen, device=dev,
                         dtype=torch.int32)
    mask = (torch.rand((1, 2, S), generator=gen, device=dev) < 0.1).float()
    batches = lm.LMBatch(toks, mask)
    rec = {"cell": "20b smollm-360m train_4k seq 4096, 1 client x 2 rows",
           "d": state.spec.d, "fed": {"n": fed.n_clients, "m": fed.m,
                                      "comm": fed.comm,
                                      "uplink": fed.uplink.kind,
                                      "downlink": fed.downlink.kind},
           "remat": cfg.remat, "count_s": count_s,
           "flops_counted": counted["cost"]["flops_counted"]}
    rec.update(check_arg_bytes(torch, "20(b)", before, counted))
    kernels.reset_launches()
    walls = []
    for r in range(3):
        t0 = time.time()
        if r == 1:
            with PlainCheck(torch) as chk:
                state, met = case.fn(state, batches)
        else:
            state, met = case.fn(state, batches)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        if not (math.isfinite(float(met.f)) and
                math.isfinite(float(met.g_hat))):
            raise AssertionError(f"20(b) round {r}: f {float(met.f)}, "
                                 f"g_hat {float(met.g_hat)}")
    counts = kernels.launch_counts()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["plain_check"] = {"kernel_calls": chk.calls,
                          "max_abs_err": chk.err,
                          "input_shapes": chk.layouts, "tolerance": 0.0}
    if any(chk.err.values()) or not counts["block_topk"] or \
            not counts["scatter_agg"]:
        raise AssertionError(f"20(b): {rec['plain_check']}, launches "
                             f"{counts}")
    ms, launches, _ = profile_device(torch, lambda: case.fn(state, batches))
    s_round = walls[2]
    rec.update(s_round=walls, device_ms=ms, kernel_launches=launches,
               busy_share=ms / 1e3 / s_round, launches=counts,
               f=float(met.f), g_hat=float(met.g_hat),
               flops_per_s=counted["cost"]["flops_counted"] / s_round,
               f32_peak=roofline.F32_OPS_PER_S)
    rec["f32_peak_share"] = rec["flops_per_s"] / roofline.F32_OPS_PER_S
    print(json.dumps(rec), flush=True)
    del state, batches, case
    free_card(torch)

    # 20(c): remat on against off at seq 1,024
    shape = InputShape("train_4k", 1024, 2, "train")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = build(cfg).init(gen, cfg, device=dev)
    state0 = rounds.init_state(params, fed, device=dev)
    del params
    toks = torch.randint(0, cfg.vocab, (1, 2, 1024), generator=gen,
                         device=dev, dtype=torch.int32)
    mask = (torch.rand((1, 2, 1024), generator=gen, device=dev) < 0.1).float()
    batches = lm.LMBatch(toks, mask)
    remat = {}
    kernels.reset_launches()
    for on in (True, False):
        c = dataclasses.replace(cfg, remat=on)
        case = steps.build_train_case(c, shape, debug, comm="pallas")
        partition.activate_mesh(None)
        w = state0.w.clone()
        state = state0._replace(w=w, x=w if state0.x is not None else None,
                                e_up=state0.e_up.clone())
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        state, met = case.fn(state, batches)
        torch.cuda.synchronize()
        remat[on] = (state.w, {"s_round": time.time() - t0,
                               "peak_gb": torch.cuda.max_memory_allocated()
                               / 1e9,
                               "peak_above_inputs_gb":
                               (torch.cuda.max_memory_allocated() - base)
                               / 1e9, "f": float(met.f)})
        del state, case
    equal = torch.equal(bits(torch, remat[True][0]),
                        bits(torch, remat[False][0]))
    rec_c = {"cell": "20c smollm-360m seq 1024, remat on vs off",
             "w_bit_equal": equal, "on": remat[True][1],
             "off": remat[False][1]}
    del remat, state0, batches
    free_card(torch)
    rec_c["phase5_layout"] = remat_pairs(torch)
    counts_c = rec_c["launches"] = kernels.launch_counts()
    print(json.dumps(rec_c), flush=True)
    if not equal:
        raise AssertionError("20(c): w differs with remat on and off")
    return rec, rec_c, counts, counts_c


def remat_pairs(torch) -> dict:
    """20(c) at phase 5's mask top-k layout (smollm-360m whole, 4 clients
    of 2 rows, seq 64, pallas top-k up, the fused round): rounds with
    remat on and off in turns (one warm-up each, then
    :data:`REMAT_PAIRS` pairs), host wall of each; then one round of each
    profiled (device ms, launches)."""
    from repro_torch import configs
    from repro_torch.engine import rounds
    from repro_torch.models import build
    from repro_torch.tasks import lm
    cfg = configs.get_config("smollm-360m")
    state, batch_fn, _, fed, dev = setup_phase(
        torch, ["--comm", "pallas", "--uplink", "topk", "--clients",
                str(N_CLIENTS)], False)
    batches = batch_fn(0, torch.Generator().manual_seed(7))
    pairs = {}
    for on in (True, False):
        c = dataclasses.replace(cfg, remat=on)
        pairs[on] = lm.make_loss_pair(build(c).forward, c, budget=6.0)
    walls = {True: [], False: []}
    for i in range(REMAT_PAIRS + 1):
        for on in (True, False):
            t0 = time.time()
            state, _ = rounds.round_step(state, batches, pairs[on], fed,
                                         device=dev)
            torch.cuda.synchronize()
            if i:
                walls[on].append(time.time() - t0)
    out = {}
    for on in (True, False):
        holder = {}

        def one():
            holder["s"] = rounds.round_step(state, batches, pairs[on], fed,
                                            device=dev)[0]
        ms, launches, _ = profile_device(torch, one)
        state = holder["s"]
        w = sorted(walls[on])
        out["on" if on else "off"] = {"s_round": walls[on],
                                      "median_s": w[len(w) // 2],
                                      "device_ms": ms,
                                      "kernel_launches": launches}
    del state, batches
    free_card(torch)
    return out


def serve_case_cell(torch, dev, label: str, arch: str, shape_name: str,
                    seq: int, batch: int) -> dict:
    """20(d)-(f): ``build_decode_case`` (its zero caches, as the reference
    lowers them; pos = seq - 1) or ``build_prefill_case`` of ``arch``
    whole at ``batch`` rows, weights drawn on a card generator; the card's
    input bytes against the dry run's; a decode runs 2 warm and 5 timed
    steps, a prefill one warm and one timed call; one more profiled;
    against the case's roofline bound (the dry run's bytes and FLOPs on
    the H100)."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import mesh, steps
    from repro_torch.models import build
    cfg = configs.get_config(arch)
    kind = configs.INPUT_SHAPES[shape_name].kind
    shape = InputShape(shape_name, seq, batch, kind)
    debug = mesh.make_debug_mesh((1, 1))
    build_case = steps.build_decode_case if kind == "decode" \
        else steps.build_prefill_case
    case = build_case(cfg, shape, debug)
    counted = counted_case(torch, case, cfg, shape)
    fns = build(cfg)
    before = free_card(torch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fns.init(gen, cfg, device=dev)
    toks = torch.randint(0, cfg.vocab, tuple(case.args[1].shape),
                         generator=gen, device=dev, dtype=torch.int32)
    args = [params, toks] + [steps.materialize(a, dev)
                             for a in case.args[2:]]
    rec = {"cell": label, "batch": batch, "seq": seq,
           "n_params": cfg.n_params()}
    rec.update(check_arg_bytes(torch, label, before, counted))
    warm, timed = (LAUNCH_DECODE_WARM, LAUNCH_DECODE_TIMED) \
        if kind == "decode" else (1, 1)
    with torch.inference_mode():
        t0 = time.time()
        for _ in range(warm):
            logits, _ = case.fn(*args)
        torch.cuda.synchronize()
        first = time.time() - t0
        t0 = time.time()
        for _ in range(timed):
            logits, _ = case.fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) / timed * 1e3
        ms, launches, _ = profile_device(torch, lambda: case.fn(*args))
    finite = bool(torch.isfinite(logits).all())
    terms = counted["roofline"]
    bound = max(terms["compute_s"], terms["memory_s"]) * 1e3
    rec.update(warm_s=first, wall_ms=wall_ms, device_ms=ms,
               kernel_launches=launches, busy_share=ms / wall_ms,
               bound_ms=bound, bound_by=terms["dominant"],
               bound_share=bound / ms, logits_finite=finite,
               logits_shape=list(logits.shape),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               flops_counted=counted["cost"]["flops_counted"],
               bytes_counted=counted["cost"]["bytes"])
    print(json.dumps(rec), flush=True)
    if not finite:
        raise AssertionError(f"{label}: logits not finite")
    del args, params, case, logits
    free_card(torch)
    return rec


def launch_phase(torch, dev, sweep) -> tuple:
    """Phase 20, the launch tooling (see the module docstring).  Returns
    ``(record, launch records)``."""
    t_phase = time.time()
    seconds = {}
    t0 = time.time()
    train_b, train_c, counts_b, counts_c = train_4k_cell(torch, dev)
    seconds["20bc"] = time.time() - t0
    serve = []
    from repro_torch import kernels
    kernels.reset_launches()
    for cell in LAUNCH_SERVE_CELLS:
        t0 = time.time()
        serve.append(serve_case_cell(torch, dev, *cell))
        seconds[cell[0].split()[0]] = time.time() - t0
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"20(d)-(f) launched wire kernels: {counts}")
    t0 = time.time()
    sweep_rec = sweep_record(sweep)
    seconds["20a_wait"] = time.time() - t0
    seconds["phase"] = time.time() - t_phase
    print(json.dumps({"launch_seconds": seconds}), flush=True)
    return ({"sweep": sweep_rec, "train_4k": train_b, "remat": train_c,
             "serve": serve, "seconds": seconds},
            [{"phase": "20b train_4k", "launches": counts_b},
             {"phase": "20c remat", "launches": counts_c}])


# phase 21: rounds across ranks -- the mesh's client axis over a
# torch.distributed group.  (cell, arch (None: the NP task), launcher
# arguments, compressed downlink, the earlier phase whose run is the cell's
# one-process run (None: phase 21 runs it)); 21(a) is the reference's
# ``multidev`` configuration (tests/test_scale.py), 21(b) phase 14(a)'s
# layout, 21(c) phase 5's mask quant layout, each run by its phase with
# the same launcher arguments, seeds and rounds
RANK_CELLS = [
    ("21a np multidev", None, [], False, None),
    ("21b mamba2-130m", "mamba2-130m",
     ["--clients", str(N_GATHER), "--participating", str(M_GATHER),
      "--participation", "gather", "--comm", "pallas", "--uplink", "topk"],
     True, "14a mamba2-130m"),
    ("21c smollm-360m", "smollm-360m",
     ["--comm", "pallas", "--uplink", "quant"], False,
     "smollm-360m uplink=quant"),
]
# phase 22: the mesh's model axis -- the flat state split by columns over
# a data x model rank mesh of RANK_MODEL model ranks, in phase 21's world
# after its cells: 22(a) is 21(b)'s cell (mamba2: no leaf split, held
# against the same one-process digests, their column blocks), 22(b)
# 21(c)'s (smollm-360m under the split plan: its MLP and tied vocab split,
# its attention whole; held against phase 5's run by TP_LAW)
MODEL_CELLS = [("22a mamba2-130m",) + RANK_CELLS[1][1:],
               ("22b smollm-360m",) + RANK_CELLS[2][1:]]
# phase 23: tensor parallelism at qwen3-4b's published widths (d_model
# 2,560, 32 heads / 8 kv, head_dim 128, d_ff 9,728, vocab 151,936 untied,
# qk-norm), depth cut to 2 of 36 layers (d = 979,776,512: a fused 2-client
# round of the one process holds about 14 fp32 copies of d), pallas top-k
# up, mask 2 of 2, fused: in one process here, then in phase 22's world
# (every leaf split but the norms).  TP_ROUNDS rounds (the checked round
# after them)
TP_CELLS = [("23 qwen3-4b", "qwen3-4b",
             ["--clients", "2", "--comm", "pallas", "--uplink", "topk"],
             False, None)]
TP_ROUNDS = 2
# depth cuts of a cell's config
CELL_CUTS = {"23 qwen3-4b": {"n_layers": 2}}
# 23(b), where RANK_FULL_CARDS or more cards exist: qwen3-4b whole (36
# layers, 4,411,424,256 parameters) on a (1, RANK_FULL_CARDS) NCCL mesh,
# one rank a card, TP_ROUNDS rounds (no one process holds it)
TP_FULL_CELL = ("23b qwen3-4b whole", "qwen3-4b", TP_CELLS[0][2], False,
                None)
RANK_FULL_CARDS = 4
# the phases that keep their final state's digest for phases 21 and 22
RANK_FROM = {cell[4] for cell in RANK_CELLS if cell[4] is not None}
# a split plan's ranks against one process (the tolerances of
# tests/test_torch_tensor_parallel.py): the metrics f, g_hat, sigma,
# f_full, g_full and delta_norm within rtol 1e-5, feasible and the wire
# bytes equal; all but 0.1% of w within rtol 1e-4 / atol 1e-6 (every entry
# within rtol 1e-5 / atol 1e-7 on an uncompressed wire); each residual
# row's difference from the one process's row (the norm of a - b) within
# "row_gap" of that row's norm.  The residual's entries are not held one
# by one: a quant level flipped at a near-tie moves its entry by a whole
# level, twice a residual entry's bound, and the flips cascade over the
# rounds.  On the CPU's reduced rounds (2) the rows end 0.7-1.7% apart and
# the tests hold 5%.  At smollm-360m's full width on an H100, after
# 22(b)'s 3 rounds, the one process's own rounds from w moved by one ulp
# (residual_witness: every entry up, every entry down, every other entry
# up) end 20.5-31.8% of the norm from the unmoved run's, as 22(b)'s ranks
# end 24.5-32.0% from it; the control (a row shifted by one sample: its
# norm equal, its entries not) ends 140-144% from it.  The limit, 60%,
# lies between: about twice the witness's largest, well below the
# control's least; every rank held by it also checks that it refuses the
# control (row_control).
# Held on every SAMPLE_W-th entry of w and every SAMPLE_ROW-th of each
# residual row (strides prime to the wire's blocks)
TP_LAW = {"metric_rtol": 1e-5, "w_rtol": 1e-4, "w_atol": 1e-6,
          "w_far": 1e-3, "exact_rtol": 1e-5, "exact_atol": 1e-7,
          "row_gap": 0.6}
SAMPLE_W, SAMPLE_ROW = 11, 101
RANK_SHARED = 2                # ranks sharing the one card over gloo
RANK_NCCL_MAX = 4              # ranks over NCCL, one a card, where 2+ cards
RANK_MODEL = 2                 # phase 22's model ranks
RANK_TIMEOUT = 900             # s a world's collectives may wait
RANK_DEVICE = "cuda"


def rank_cell_setup(torch, cell):
    """``(state, batch_fn, loss_pair, fed)`` of a phase-21, 22 or 23 cell
    on the current card, under whatever mesh is active (``init_state``
    splits the residual over the ranks; the launcher's setup gives the
    model's plan)."""
    from repro_torch import configs, resolve_device
    name, arch, argv, downlink, _ = cell
    if arch is not None:
        cfg = dataclasses.replace(configs.get_config(arch),
                                  **CELL_CUTS.get(name, {}))
        state, batch_fn, pair, fed, _ = setup_phase(
            torch, ["--arch", arch, "--device", RANK_DEVICE] + argv,
            downlink, cfg)
        return state, batch_fn, pair, fed
    from repro_torch.configs.base import (CompressorConfig, FedConfig,
                                          ScaleConfig, SwitchConfig)
    from repro_torch.engine import rounds
    from repro_torch.tasks import np_classification as npc
    dev = resolve_device(RANK_DEVICE)
    fed = FedConfig(n_clients=12, m=4, local_steps=2, lr=0.1,
                    switch=SwitchConfig(mode="hard", eps=0.35),
                    participation="gather",
                    uplink=CompressorConfig(kind="topk", ratio=0.25, block=8),
                    downlink=CompressorConfig(kind="none"),
                    scale=ScaleConfig(ef_slots=12))
    data, _ = npc.make_dataset(torch.Generator().manual_seed(0), 12,
                               device=dev)
    state = rounds.init_state(npc.init_params(data.x.shape[-1], dev), fed,
                              device=dev)
    return state, (lambda t, g: data), npc.loss_pair, fed


def _sha1_all(torch, items: dict) -> dict:
    """sha1 of the bytes of each tensor or array of ``items``, on the host
    (a card tensor copied into pinned memory first), four at a time."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np

    def one(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().contiguous().reshape(-1).view(torch.uint8)
            if x.is_cuda:
                x = torch.empty(x.shape, dtype=torch.uint8,
                                pin_memory=True).copy_(x)
            x = x.numpy()
        return hashlib.sha1(np.ascontiguousarray(x)).hexdigest()
    with ThreadPoolExecutor(4) as ex:
        return dict(zip(items, ex.map(one, items.values())))


def digest_split(fed, spec):
    """The column split of a round of ``fed`` over :data:`RANK_MODEL`
    model ranks (what ``comm.flat.columns_for`` gives phase 22's ranks)."""
    from repro_torch.comm import flat
    return flat.column_split(spec, flat.flat_transports_for(fed, spec),
                             RANK_MODEL)


def state_digest(torch, state, hist, fed) -> dict:
    """sha1 of every field of a round state and of its metrics; the residual
    (the dense stack's or the slot store's pool) row by row, keyed by row
    id: under a rank mesh, the rows this rank holds.  The fields split by
    columns under a model axis (w, x, the averaged-iterate sum, each
    residual row) are digested per column block of :func:`digest_split`,
    keyed
    ``"<name> cols <lo>:<hi>"``: in one process every block, on a model
    rank (a ``partition.FlatShard``) its own."""
    from repro_torch.scale import slots
    from repro_torch.sharding import partition
    split = digest_split(fed, state.spec)

    def blocks(name, x, own=None):
        if own is not None:
            return {f"{name} cols {own[0]}:{own[1]}": x}
        return {f"{name} cols {lo}:{hi}": x[..., lo:hi]
                for lo, hi in map(split.block, range(RANK_MODEL))}

    def own(x):
        if not isinstance(x, partition.FlatShard):
            return None
        if x.split != split:
            raise AssertionError(f"columns {x.split} against {split}")
        return x.split.block()
    fields = {"wbar_weight": state.wbar_weight}
    for f in ("w", "x", "wbar_sum"):
        v = getattr(state, f)
        if v is not None:
            fields.update(blocks(f, partition.flat_local(v), own(v)))
    fields.update({f"metric_{f}": getattr(hist, f) for f in hist._fields
                   if getattr(hist, f) is not None})
    e = state.e_up
    if isinstance(e, slots.SlotStore):
        fields.update({f: getattr(e, f) for f in ("owner", "stamp",
                                                  "weight", "client_slot")})
        e = e.pool
    rows = {}
    if e is not None:
        held, e = own(e), partition.flat_local(e)
        local, lo = (e.local, partition.block(e.n)[0]) \
            if isinstance(e, partition.ClientShard) else (e, 0)
        for i in range(local.shape[0]):
            rows.update(blocks(str(lo + i), local[i], held))
    return {"fields": _sha1_all(torch, fields),
            "rows": _sha1_all(torch, rows),
            "delta_norm": [float(v) for v in hist.delta_norm]}


# where a column cut falls inside a leaf, delta_norm adds two ranks' partial
# sums of that leaf (comm.flat.tree_norm): within this rtol of one process
NORM_RTOL = 1e-6


def _sampled(x, lo: int, hi: int, stride: int) -> tuple:
    """``(k0, values)``: the entries of the flat columns ``lo:hi`` (``x``
    holds them) at the positions ``k * stride``, from ``k0``, copied to
    the host (a later round updates the residual in place)."""
    k0 = -(-lo // stride)
    return k0, x[..., k0 * stride - lo::stride].float().cpu().numpy().copy()


def state_samples(torch, state, hist) -> dict:
    """What :data:`TP_LAW` holds of a round state: the metrics, every
    :data:`SAMPLE_W`-th entry of w and every :data:`SAMPLE_ROW`-th of each
    residual row (the dense stack's), by flat position -- in one process
    of the whole buffer, on a model rank of its columns (``hist`` None: no
    metrics)."""
    from repro_torch.sharding import partition

    def span(x):
        if isinstance(x, partition.FlatShard):
            return partition.flat_local(x), *x.split.block()
        return x, 0, state.spec.d
    w, lo, hi = span(state.w)
    out = {"metrics": {} if hist is None else {
        f: [float(v) for v in getattr(hist, f)]
        for f in ("f", "g_hat", "sigma", "f_full", "g_full", "delta_norm",
                  "feasible", "up_bytes", "down_bytes")},
           "w": _sampled(w, lo, hi, SAMPLE_W), "rows": {}}
    if state.e_up is not None and not hasattr(state.e_up, "pool"):
        e, lo, hi = span(state.e_up)
        first = 0
        if isinstance(e, partition.ClientShard):
            first, e = partition.block(e.n)[0], e.local
        for i in range(e.shape[0]):
            out["rows"][first + i] = _sampled(e[i], lo, hi, SAMPLE_ROW)
    return out


def samples_mismatch(got: dict, want: dict, exact: bool) -> tuple:
    """``(problems, counts)``: where a rank's :func:`state_samples` breaks
    :data:`TP_LAW` against the one process's (``exact``: the uncompressed
    wire's law), and the measured counts."""
    import numpy as np
    law, bad, counts = TP_LAW, [], {}
    for f, vals in got["metrics"].items():
        ref = want["metrics"][f]
        if f in ("feasible", "up_bytes", "down_bytes"):
            ok = vals == ref
        else:
            ok = np.allclose(vals, ref, rtol=law["metric_rtol"], atol=0)
        if not ok:
            bad.append(f"{f} {vals} against {ref}")
    k0, a = got["w"]
    b = want["w"][1][k0:k0 + a.shape[-1]]
    if exact:
        far = ~np.isclose(a, b, rtol=law["exact_rtol"],
                          atol=law["exact_atol"])
        limit = 0.0
    else:
        far = ~np.isclose(a, b, rtol=law["w_rtol"], atol=law["w_atol"])
        limit = law["w_far"]
    counts["w_far"] = [int(far.sum()), int(far.size)]
    counts["w_max_abs"] = float(np.abs(a - b).max()) if a.size else 0.0
    if far.mean() > limit:
        bad.append(f"w: {int(far.sum())} of {far.size} sampled entries "
                   "beyond the law")
    counts["row_norm"], counts["row_gap"] = {}, {}
    for r, (k0, a) in got["rows"].items():
        b = want["rows"][r][1][k0:k0 + a.shape[-1]]
        gap = float(np.linalg.norm((a - b).astype(np.float64)))
        size = float(np.linalg.norm(b.astype(np.float64)))
        mine = float(np.linalg.norm(a.astype(np.float64)))
        counts["row_norm"][r] = [mine, size]
        counts["row_gap"][r] = gap / size if size else gap
        if gap > law["row_gap"] * size:
            bad.append(f"residual row {r}: {gap} from the one process's, "
                       f"whose norm is {size}")
    return bad, counts


def shifted_rows(samples: dict) -> dict:
    """The control of :data:`TP_LAW`'s residual gate: ``samples`` with
    each residual row's sampled entries shifted by one place (each row's
    norm unchanged, its entries not), which the gate must refuse."""
    import numpy as np
    return {**samples, "rows": {r: (k0, np.roll(a, 1))
                                for r, (k0, a) in samples["rows"].items()}}


def row_control(samples: dict) -> dict:
    """:func:`shifted_rows` of ``samples`` against ``samples`` itself: each
    row's gap (a share of its norm); raises unless the gate refuses every
    row."""
    bad, counts = samples_mismatch(shifted_rows(samples), samples, False)
    refused = [b for b in bad if b.startswith("residual row")]
    if len(refused) != len(samples["rows"]):
        raise AssertionError(f"the residual gate passed a shifted row: "
                             f"{counts['row_gap']}")
    return counts["row_gap"]


def residual_witness(torch, T: int = 3) -> dict:
    """The witness of :data:`TP_LAW`'s residual limit: 21(c)'s cell
    (smollm-360m whole, mask quant, 22(b)'s rounds) in one process on the
    card, T rounds from its seeded ``w`` and T from each of three nudges
    of it (every entry one ulp up, every entry one ulp down, every other
    entry one ulp up); after each round, each residual row's gap between
    a nudged run and the unmoved one (a share of its norm), ``w``'s
    samples beyond the law, and the control's gaps (each unmoved row
    shifted by one sample, which the gate must refuse).  Run alone; its
    record is printed and returned."""
    import math
    from repro_torch.engine import rounds

    def up(w):
        return torch.nextafter(w, torch.full_like(w, math.inf))

    def down(w):
        return torch.nextafter(w, torch.full_like(w, -math.inf))

    def even_up(w):
        return torch.where(torch.arange(w.shape[0], device=w.device) % 2
                           == 0, up(w), w)
    nudges = {"none": None, "every entry one ulp up": up,
              "every entry one ulp down": down,
              "every other entry one ulp up": even_up}
    cell = RANK_CELLS[2]
    runs = {}
    for what, nudge in nudges.items():
        state, batch_fn, pair, fed = rank_cell_setup(torch, cell)
        if nudge is not None:
            state = state._replace(w=nudge(state.w))
        dev = rounds.state_device(state)
        gen = torch.Generator().manual_seed(fed.seed + 1)
        runs[what] = []
        for t in range(T):
            state, _ = rounds.round_step(state, batch_fn(t, gen), pair, fed,
                                         device=dev)
            runs[what].append(state_samples(torch, state, None))
        del state
        free_card(torch)
    base = runs.pop("none")
    rec = {"phase": "22(b) residual witness", "cell": cell[0], "rounds": T,
           "control_row_gap": [row_control(s) for s in base],
           "nudges": {}}
    for what, per in runs.items():
        rec["nudges"][what] = []
        for t in range(T):
            _, counts = samples_mismatch(per[t], base[t], False)
            rec["nudges"][what].append({
                k: counts[k] for k in ("row_gap", "row_norm", "w_far",
                                       "w_max_abs")})
    print(json.dumps(rec), flush=True)
    return rec


def whole_grad_sha1(torch, state, batch_fn, pair, fed) -> dict:
    """Under a split plan, one client's loss pair and gradient of f at the
    state's ``w`` on this model rank (its tensor layout): the sha1 of f,
    g and of the gradient of every whole leaf (the norms, and attention
    kept whole), which must be the same bits on every model rank (each
    "f" in place)."""
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    from repro_torch.sharding import partition
    cols = flat.columns_for(fed, state.spec)
    lay = flat.tensor_layout(state.spec, cols, state.plan)
    w = lay.to_tensor(partition.flat_local(state.w)).requires_grad_(True)
    batch = rounds.client_batch(batch_fn(0, torch.Generator().manual_seed(7)),
                                0)
    f, g = pair(flat.unflatten(lay.spec, w), batch)
    f.backward()
    whole = [w.grad[ls.offset:ls.offset + ls.size]
             for ls, d in zip(lay.spec.leaves, state.plan.dims) if d is None]
    out = _sha1_all(torch, {"f": f.detach().reshape(1),
                            "g": g.detach().reshape(1),
                            "whole_grads": torch.cat(whole)})
    out["whole_leaves"] = len(whole)
    return out


def replicated_sha1(torch, hist) -> str:
    """sha1 of a run's metrics (f, g_hat, sigma, the wire bytes, ...):
    the same bits on every rank of a world."""
    import numpy as np
    h = hashlib.sha1()
    for f in hist._fields:
        v = getattr(hist, f)
        if v is not None:
            h.update(np.ascontiguousarray(np.asarray(v)).tobytes())
    return h.hexdigest()


def straddles(split, spec) -> bool:
    """Whether a cut of ``split`` falls inside a leaf of ``spec``."""
    starts = {ls.offset for ls in spec.leaves}
    return any(c not in starts for c in split.cuts[1:-1])


def digest_mismatch(digest: dict, want: dict, norm_close: bool = False
                    ) -> list:
    """What a rank's :func:`state_digest` holds that is not the one
    process's: a differing or unknown key, or a field it lacks (a field
    split by columns needs one block).  ``norm_close``: ``delta_norm``
    within :data:`NORM_RTOL` instead of bit-equal."""
    close = {"metric_delta_norm"} if norm_close else set()
    bad = [k for k, v in digest["fields"].items()
           if k not in close and want["fields"].get(k) != v]
    if close and not all(
            math.isclose(a, b, rel_tol=NORM_RTOL, abs_tol=0.0)
            for a, b in zip(digest["delta_norm"], want["delta_norm"])):
        bad.append(f"delta_norm {digest['delta_norm']} against "
                   f"{want['delta_norm']}")
    bad += [f"row {k}" for k, v in digest["rows"].items()
            if want["rows"].get(k) != v]

    def names(keys):
        return {k.split(" cols ")[0] for k in keys}
    bad += [f"no {k}" for k in names(want["fields"]) - names(
        digest["fields"])]
    return bad


def rank_expected(fed, runs: int, rank=None) -> tuple:
    """A rank's (kernel launches, ``loss_pair`` calls) per round: the
    wire's encode on its rows, the reduce and the downlink replicated; in
    a gather round ``delta_norm``'s ``segment_rows`` on rank 0 only (it
    aggregates there).  ``rank`` None: one process (or a client axis of
    one rank).  ``runs``: the wire runs this rank works on (under a model
    axis, those of its columns)."""
    import torch
    from repro_torch.engine import participation, rounds, strategies
    from repro_torch.sharding import partition
    want = expected_launches(fed, runs)
    gather = fed.participation == "gather"
    rows = fed.m if gather else fed.n_clients
    evals = fed.n_clients
    if rank is not None:
        rows = partition.counts(rows)[rank]
        evals = partition.counts(evals)[rank]
        if gather and not fed.lean_metrics and rank != 0:
            want["segment_rows"] -= 1
    part = participation.finalize(torch.ones(fed.n_clients), None, fed)
    fused = rounds.fuses(part, strategies.get_strategy(fed.strategy), fed)
    return want, rows * fed.local_steps + (0 if fused else evals)


def rank_cell_run(torch, cell, T: int, ref=None, keep_digest: bool = True
                  ) -> dict:
    """A phase-21, 22 or 23 cell's T rounds on this card through
    ``run_rounds``, in one process or (under an active rank mesh) as one
    rank: s/round, peak GB, launches and ``loss_pair`` calls against what
    the layout demands, the collectives' bytes and host seconds per round
    (both axes, and each axis's group), the model's plan (its split and
    whole leaves and their bytes; under a model axis the tensor layout's
    exchange bytes), the state's digest and samples; on a rank held
    against the one process's ``ref`` when given (``{"digest",
    "samples"}``): a plan with no split leaf by the digest, every field,
    row and column block this rank holds bit for bit, a split plan by
    :data:`TP_LAW` on the samples.  Then one more round profiled and, on a
    rank, one whose every wire-kernel launch is held against its plain
    version.  The digest (sha1 of every column block: seconds at full
    width) is taken only where it is read: with ``keep_digest`` (a
    one-process run a world is held against by it), or on a rank held by
    it."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.comm import flat
    from repro_torch.engine import rounds
    from repro_torch.sharding import collectives, partition
    ra, ma = partition.rank_axis(), partition.model_axis()
    t_cell = time.time()

    def progress(what):
        # where a world stands (a rank that stops in a collective leaves
        # its peers waiting until the group's timeout)
        if ra is not None or ma is not None:
            print(json.dumps({"rank_progress": cell[0],
                              "rank": dist.get_rank(), "at": what,
                              "s": time.time() - t_cell,
                              "gb": torch.cuda.max_memory_allocated() / 1e9}),
                  flush=True)
    state, batch_fn, pair, fed = rank_cell_setup(torch, cell)
    progress("setup")
    dev = rounds.state_device(state)
    cols = flat.columns_for(fed, state.spec)
    split_plan = state.plan is not None and state.plan.split
    plan_rec = None if state.plan is None else \
        partition.plan_record(state.spec, state.plan)
    if plan_rec is not None and cols is not None:
        plan_rec["exchange_bytes"] = flat.tensor_layout(
            state.spec, cols, state.plan).exchange_bytes()
    up, _ = flat.flat_transports_for(fed, state.spec, cols)
    runs = len(up.codec.layout.runs) if up.codec is not None else \
        len(flat.wire_layout(state.spec, fed.uplink).runs)
    want, want_pairs = rank_expected(fed, runs,
                                     None if ra is None else ra.rank)
    calls, stamps = [], []

    def loss_pair(params, batch):
        calls.append(1)
        return pair(params, batch)

    def timed_batches(t, gen):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        progress(f"round {t}")
        return batch_fn(t, gen)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    collectives.reset_stats()
    state, hist = rounds.run_rounds(state, timed_batches, loss_pair, fed,
                                    T=T, device=dev)
    progress("rounds")
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    coll = collectives.stats()
    coll_axes = collectives.stats_by_axis()
    counts = kernels.launch_counts()
    per_round = [b - a for a, b in zip(stamps, stamps[1:])]
    ranked = ra is not None or ma is not None
    where = ""
    if ranked:
        where = f" {dist.get_backend()} rank {dist.get_rank()} of " \
            f"{dist.get_world_size()}"
        if ma is not None:
            where += f" (data {0 if ra is None else ra.rank}, model " \
                f"{ma.rank}; columns {cols.lo}:{cols.hi})"
    rec = {"phase": cell[0] + where,
           "backend": dist.get_backend() if ranked else None,
           "world": dist.get_world_size() if ranked else 1,
           "rank": None if ra is None else ra.rank,
           "model_rank": None if ma is None else ma.rank,
           "mesh": None if partition.current_mesh() is None else
           list(partition.current_mesh().devices.shape),
           "plan": plan_rec, "split_plan": split_plan,
           "columns": None if cols is None else [cols.lo, cols.hi],
           "split": None if cols is None else list(cols.split.cuts),
           "wire_runs": runs,
           "cards": torch.cuda.device_count(), "device": str(dev),
           "d": state.spec.d, "comm": fed.comm, "clients": fed.n_clients,
           "participating": fed.m, "participation": fed.participation,
           "uplink": fed.uplink.kind, "downlink": fed.downlink.kind,
           "ef_slots": fed.scale.ef_slots, "rounds": T,
           "s_per_round": per_round,
           "s_per_round_after_first": (sum(per_round[1:]) / (T - 1)
                                       if T > 1 else None),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "f": hist.f.tolist(), "g_hat": hist.g_hat.tolist(),
           "loss_pair_per_round": len(calls) / T,
           "loss_pair_per_round_expected": want_pairs,
           "launches": counts, "launches_per_round_expected": want,
           "collectives_per_round": {k: v / T for k, v in coll.items()},
           "collectives_per_round_by_axis": {
               a: {k: v / T for k, v in st.items()}
               for a, st in coll_axes.items()}}
    digest = state_digest(torch, state, hist, fed) if (
        keep_digest if ref is None else not split_plan) else None
    samples = state_samples(torch, state, hist)
    rec["replicated_sha1"] = replicated_sha1(torch, hist)
    rec["straddles"] = cols is not None and straddles(cols.split,
                                                       state.spec)
    if ref is not None and split_plan:
        exact = fed.uplink.kind == "none" and fed.downlink.kind == "none"
        bad, rec["law_counts"] = samples_mismatch(samples, ref["samples"],
                                                  exact)
        rec["law"] = "exact wire" if exact else "0.1% law"
        rec["law_counts"]["row_gap_control"] = row_control(ref["samples"])
        if bad:
            raise AssertionError(f"{rec['phase']}: beyond the split plan's "
                                 f"law against one process: {bad}")
        rec["within_law_of_one_process"] = True
    elif ref is not None:
        want_digest = ref["digest"]
        bad = digest_mismatch(digest, want_digest, rec["straddles"])
        rec["delta_norm"] = [digest["delta_norm"],
                             want_digest["delta_norm"]]
        if bad:
            raise AssertionError(f"{rec['phase']}: not bit-equal to one "
                                 f"process: {bad}")
        rec["bit_equal_to_one_process"] = True
        rec["rows_held"] = sorted({int(k.split()[0])
                                   for k in digest["rows"]})
        rec["digests_held"] = len(digest["fields"]) + len(digest["rows"])
    if not (all(math.isfinite(v) for v in rec["f"])
            and all(math.isfinite(v) for v in rec["g_hat"])):
        raise AssertionError(f"{rec['phase']}: non-finite f or g_hat")
    if len(calls) != want_pairs * T:
        raise AssertionError(f"{rec['phase']}: loss_pair ran {len(calls)} "
                             f"times, expected {want_pairs * T}")
    for kname, cnt in counts.items():
        if cnt != want.get(kname, 0) * T:
            raise AssertionError(f"{rec['phase']}: {kname} launched {cnt} "
                                 f"times, expected {want.get(kname, 0) * T}")
    collectives.reset_stats()
    rec["profile"] = profile_round(torch, state, batch_fn, pair, fed, dev,
                                   rec["s_per_round_after_first"])
    rec["profile"]["collectives"] = collectives.stats()
    rec["profile"]["collectives_by_axis"] = collectives.stats_by_axis()
    if ranked:
        rec.update(plain_check_record(state, hist, batch_fn, pair, fed, dev))
    if split_plan:
        rec["whole_grad_sha1"] = whole_grad_sha1(torch, state, batch_fn,
                                                 pair, fed)
    if cell[1] is None and ra is not None:
        rec["shard_check"] = rank_shard_check(torch, dev)
    rec["digest"] = digest
    rec["samples"] = samples
    del state
    free_card(torch)
    return rec


def rank_shard_check(torch, dev) -> dict:
    """The reference's ``multidev`` checks (a), (b) on the card under the
    rank mesh: ``sharded_take`` from a client-split stack gives the exact
    rows; ``constrain_fleet`` / ``constrain_store`` split values that
    gather back unchanged."""
    from repro_torch.fleet.provision import Fleet
    from repro_torch.scale import shard, slots
    from repro_torch.sharding import partition
    data = torch.arange(12 * 24.0, device=dev).reshape(12, 4, 6)
    idx = torch.tensor([1, 5, 8, 11], device=dev)
    taken = shard.sharded_take(partition.constrain_leading(data, "client"),
                               idx)
    rows = partition.all_rows(taken, 4)
    count = torch.full((12,), 4, device=dev)
    fleet = shard.constrain_fleet(Fleet(data, count, count.cpu()))
    store = slots.init(12, 12, 16, torch.float32, dev)
    pool = torch.randn(12, 16, generator=torch.Generator().manual_seed(0))
    split = shard.constrain_store(store._replace(pool=pool.to(dev)))
    ok = {"take": torch.equal(rows, data[idx]),
          "fleet": torch.equal(partition.gather_leading(fleet.data), data)
          and torch.equal(partition.gather_leading(fleet.count), count),
          "store": torch.equal(partition.gather_leading(split.pool),
                               pool.to(dev))
          and split.owner is store.owner}
    if not all(ok.values()):
        raise AssertionError(f"21(a) shard checks: {ok}")
    return ok


def gloo_cuda_probe(torch, dist) -> dict:
    """Which collectives gloo takes on CUDA tensors in this torch (each
    tried on a ``uint8`` tensor on the card; ``sharding.collectives``
    stages every CUDA tensor through the host under gloo either way)."""
    world = dist.get_world_size()
    x = torch.full((4,), dist.get_rank(), dtype=torch.uint8, device="cuda")
    tries = {
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x, [4 // world] * world,
            [4 // world] * world),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_reduce": lambda: dist.all_reduce(x.clone().to(torch.int32)),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError) as err:
            out[name] = str(err).splitlines()[0][:160]
    return out


# the records of each phase's cells in a rank's output
RANK_KEYS = {21: "cells", 22: "model_cells", 23: "tp_cells", "23b": "full"}


def rank_main(rank: int, world: int, backend: str, T: int, wants: dict,
              out_dir: str, phases=(21, 22, 23)) -> None:
    """One rank of a phase-21 world (started by ``spawn``): its card, the
    default group (rendezvous through a file store in ``out_dir``), under
    gloo the probe of its collectives on CUDA tensors, then (phase 21)
    each cell of :data:`RANK_CELLS` under the rank mesh of the client axis,
    (phase 22) each of :data:`MODEL_CELLS` and (phase 23, its cells at
    :data:`TP_ROUNDS` rounds) each of :data:`TP_CELLS` under the ``(world
    / RANK_MODEL, RANK_MODEL)`` data x model mesh, held against its
    one-process ``wants`` (``{"digest", "samples"}``), or ("23b")
    :data:`TP_FULL_CELL` on a ``(1, world)`` mesh; its records to
    ``out_dir/rank<r>.json``.  A failure raises (and fails the world)."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh
    from repro_torch.sharding import partition
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"file://{out_dir}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        out = {"probe": gloo_cuda_probe(torch, dist)
               if backend == "gloo" else None, "seconds": {},
               **{key: [] for key in RANK_KEYS.values()}}
        model_mesh = mesh.make_rank_mesh(
            RANK_DEVICE, shape=(world // RANK_MODEL, RANK_MODEL),
            axes=("data", "model")) if world % RANK_MODEL == 0 else None
        meshes = {21: (RANK_CELLS, mesh.make_rank_mesh(RANK_DEVICE)),
                  22: (MODEL_CELLS, model_mesh), 23: (TP_CELLS, model_mesh),
                  "23b": ([TP_FULL_CELL], mesh.make_rank_mesh(
                      RANK_DEVICE, shape=(1, world),
                      axes=("data", "model")))}
        for phase in phases:
            cells, rank_mesh = meshes[phase]
            for cell in cells:
                t0 = time.time()
                partition.activate_mesh(rank_mesh)
                rec = rank_cell_run(
                    torch, cell, TP_ROUNDS if phase in (23, "23b") else T,
                    wants.get(cell[4] or cell[0]), keep_digest=False)
                rec.pop("digest")
                rec.pop("samples")
                partition.activate_mesh(None)
                out[RANK_KEYS[phase]].append(rec)
                out["seconds"][cell[0]] = time.time() - t0
        pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        partition.activate_mesh(None)
        dist.destroy_process_group()


def rank_world(backend: str, world: int, T: int, wants: dict,
               phases=(21, 22, 23)) -> list:
    """Spawn a world of ``world`` ranks over ``backend`` that runs every
    cell of ``phases`` (:func:`rank_main`); each rank's records (a rank
    that fails raises here).  The ranks' folder (their rendezvous and
    records) is removed after."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    out_dir = tempfile.mkdtemp(prefix="ranks-")
    try:
        mp.start_processes(rank_main, args=(world, backend, T, wants,
                                            out_dir, phases),
                           nprocs=world, join=True, start_method="spawn")
        return [json.loads(pathlib.Path(out_dir, f"rank{r}.json").read_text())
                for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


ONE_PROCESS_KEYS = ("phase", "d", "rounds", "s_per_round",
                    "s_per_round_after_first", "peak_mem_gb",
                    "loss_pair_per_round", "launches", "profile")


def rank_phase(torch, dev, T: int, earlier=None, phases=(21, 22, 23),
               backends=("gloo", "nccl")) -> tuple:
    """Phases 21, 22 and 23: each cell of :data:`RANK_CELLS` and
    :data:`TP_CELLS` in one process: 21(b) and (c) from the earlier phase
    the cell names (``earlier``: that phase's record and its final
    state's digest and samples, T rounds as here), otherwise run here, its
    memory freed after it (21(a), 23; every cell when the phase runs
    alone); then one world that runs every cell of ``phases`` over ranks
    (phase 22's cells on the same one-process runs as 21(b), (c)):
    :data:`RANK_SHARED` ranks sharing the card over gloo (CUDA tensors,
    collectives staged through the host) and, where 2 or more cards
    exist, one rank per card over NCCL (up to :data:`RANK_NCCL_MAX`);
    every rank held against the one process (bit for bit, or by
    :data:`TP_LAW` under a split plan), the same metrics' bits on every
    rank, and in phases 22 and 23 each rank's peak below the one
    process's.  "23b", only where asked and :data:`RANK_FULL_CARDS` cards
    exist: qwen3-4b whole over NCCL, one rank a card (not a default phase:
    its one 4-card run passed its time limit, the cause not found).
    ``backends``: the worlds to run of these two.  Returns ``(records,
    launch records)``."""
    t_phase = time.time()
    cards = torch.cuda.device_count()
    cells, wants, launches, seconds = [], {}, [], {}
    wanted = [c for c in RANK_CELLS if 21 in phases or
              (22 in phases and c[4] is not None)]
    wanted += TP_CELLS if 23 in phases else []
    for cell in wanted:
        t0 = time.time()
        rec = (earlier or {}).get(cell[4])
        rounds_ = TP_ROUNDS if cell in TP_CELLS else T
        if rec is None:
            one = rank_cell_run(torch, cell, rounds_,
                                keep_digest=cell not in TP_CELLS)
            launches.append({"phase": one["phase"],
                             "launches": one["launches"]})
        else:
            if rec["rounds"] != T:
                raise AssertionError(f"{cell[0]}: {cell[4]} ran "
                                     f"{rec['rounds']} rounds, not {T}")
            one = {k: rec[k] for k in ONE_PROCESS_KEYS}
            one["digest"] = rec.pop("digest")
            one["samples"] = rec.pop("samples")
        wants[cell[4] or cell[0]] = {"digest": one.pop("digest"),
                                     "samples": one.pop("samples")}
        print(json.dumps({"rank_cell": cell[0], **one}), flush=True)
        cells.append({"cell": cell[0], "from": cell[4], "one_process": one,
                      "worlds": {}})
        seconds[f"{cell[0]} one process"] = time.time() - t0
    by_from = {c["from"] or c["cell"]: c["one_process"] for c in cells}
    groups = {21: cells if 21 in phases else [],
              22: [{"cell": c[0], "from": c[4], "worlds": {},
                    "one_process": by_from[c[4]]}
                   for c in (MODEL_CELLS if 22 in phases else [])],
              23: [c for c in cells if c["cell"] in
                   {t[0] for t in TP_CELLS}],
              "23b": [{"cell": TP_FULL_CELL[0], "from": None, "worlds": {},
                       "one_process": None}] if "23b" in phases else []}
    groups[21] = [c for c in groups[21] if c not in groups[23]]
    base = tuple(p for p in phases if p != "23b")
    worlds = [("gloo", RANK_SHARED, base)] if "gloo" in backends and base \
        else []
    if cards >= 2 and "nccl" in backends and base:
        worlds.append(("nccl", min(cards, RANK_NCCL_MAX), base))
    if cards >= RANK_FULL_CARDS and "nccl" in backends and "23b" in phases:
        worlds.append(("nccl", RANK_FULL_CARDS, ("23b",)))
    probe = None
    for backend, world, run in worlds:
        t0 = time.time()
        ranks = rank_world(backend, world, T, wants, run)
        label = f"{backend} x{world}"
        seconds[label] = time.time() - t0
        for key, value in ranks[0]["seconds"].items():
            seconds[f"{label} {key}"] = value
        probe = probe or ranks[0]["probe"]
        for phase in run:
            for i, rec in enumerate(groups[phase]):
                recs = [r[RANK_KEYS[phase]][i] for r in ranks]
                rec["worlds"][label] = recs
                for r in recs:
                    print(json.dumps({"rank_cell": rec["cell"], **r}),
                          flush=True)
                    launches.append({"phase": r["phase"],
                                     "launches": r["launches"]})
                sha = {r["replicated_sha1"] for r in recs}
                if len(sha) != 1:
                    raise AssertionError(f"{rec['cell']} {label}: the "
                                         f"ranks' metrics differ: {sha}")
                grads = {json.dumps(r.get("whole_grad_sha1"),
                                    sort_keys=True) for r in recs}
                if len(grads) != 1:
                    raise AssertionError(f"{rec['cell']} {label}: the "
                                         "ranks' f, g or whole leaves' "
                                         f"gradients differ: {grads}")
    for phase in (22, 23):
        for rec in groups[phase]:
            one = rec["one_process"]["peak_mem_gb"]
            for label, recs in rec["worlds"].items():
                peaks = [r["peak_mem_gb"] for r in recs]
                if not all(p < one for p in peaks):
                    raise AssertionError(f"{rec['cell']} {label}: peaks "
                                         f"{peaks} GB, one process {one} GB")
    nccl = None if cards >= 2 else (
        f"not run: {cards} card; NCCL cannot put two ranks on one card, "
        "and a one-rank group calls no collective")
    full = "23(b) not run: only where asked (phases=(\"23b\",))" \
        if "23b" not in phases else None if cards >= RANK_FULL_CARDS else (
            f"23(b) not run: {cards} card(s); qwen3-4b whole needs "
            f"{RANK_FULL_CARDS} cards over NCCL, one rank a card")
    seconds["phase"] = time.time() - t_phase
    print(json.dumps({"rank_seconds": seconds, "cards": cards,
                      "gloo_on_cuda_tensors": probe, "nccl": nccl,
                      "qwen3_whole": full}), flush=True)
    return {"cells": groups[21], "model_cells": groups[22],
            "tp_cells": groups[23], "full": groups["23b"],
            "gloo_on_cuda_tensors": probe, "nccl": nccl,
            "qwen3_whole": full, "seconds": seconds}, launches


def profile_round(torch, state, batch_fn, loss_pair, fed, dev, s_round):
    """One more round (after the counted ones) under ``torch.profiler``:
    the device time by operator and the device's busy share of an
    unprofiled round's wall time ``s_round``."""
    from repro_torch.engine import rounds
    batches = batch_fn(0, torch.Generator().manual_seed(7))
    total_ms, launches, kernels = profile_device(
        torch, lambda: rounds.round_step(state, batches, loss_pair, fed,
                                         device=dev))
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {"device_ms": total_ms, "kernel_launches": launches,
            "busy_share": (total_ms / 1e3 / s_round if s_round else None),
            "top_ms": {e.key[:120]: dev_us(e) / 1e3 for e in top},
            "top_calls": {e.key[:120]: e.count for e in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3,
                    help="full-width rounds per training phase (phases "
                    "5-16, 21 and 22)")
    ap.add_argument("--out", default=None,
                    help="also write every record to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the port (src/repro_torch) is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    t_start = time.time()
    card = card_line()
    dev = resolve_device("cuda")
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    t0 = time.time()
    logs = build.build_all(force=True)
    for name, log in logs.items():
        print(f"--- nvcc {name} ---\n{log.strip()}", flush=True)
    print(f"build: {len(logs)} kernels in {time.time() - t0:.1f} s",
          flush=True)
    sweep = start_dryrun_sweep(pathlib.Path(args.out).parent if args.out
                               else ROOT / "results")
    try:
        return run_phases(torch, args, dev, card, t_start, sweep)
    finally:
        if sweep[0].poll() is None:
            sweep[0].kill()
            sweep[0].wait()


def run_phases(torch, args, dev, card: str, t_start: float, sweep) -> int:
    """Phases 3-22 (the sweep of 20(a) already running) and the last
    lines; each phase's wall seconds on a line of their own before
    them."""
    from repro_torch import configs
    from repro_torch.comm import flat
    from repro_torch.configs.base import CompressorConfig

    walls, mark = {"1, 2 card, build": time.time() - t_start}, [time.time()]

    def done(name):
        now = time.time()
        walls[name] = now - mark[0]
        mark[0] = now

    cfg = configs.get_config("smollm-360m")
    spec = meta_spec(torch, cfg)
    layout = flat.wire_layout(spec, CompressorConfig(kind="topk", ratio=0.1))
    print(f"layout: d={spec.d}, {len(layout.runs)} runs, blocks "
          f"{[r.block for r in layout.runs]}, k {[r.k for r in layout.runs]}",
          flush=True)
    records = check_kernels(torch, dev, layout)
    profile_reader_check(torch, dev)
    torch.cuda.empty_cache()
    done("3 kernels")
    reference_check(torch)
    done("4 reference")
    phases = [train_phase(torch, f"smollm-360m uplink={uplink}",
                          ["--comm", "pallas", "--uplink", uplink],
                          args.rounds,
                          digest=f"smollm-360m uplink={uplink}" in RANK_FROM)
              for uplink in ("quant", "topk")]
    done("5 mask")
    gather_mask_check(torch, dev)
    token_draw_probe(torch, dev, cfg.vocab)
    done("6 gather = mask")
    gather = ["--clients", str(N_GATHER), "--participating", str(M_GATHER),
              "--participation", "gather"]
    phases += [train_phase(torch, f"smollm-360m gather {M_GATHER} of "
                           f"{N_GATHER} {kind} up and down",
                           gather + ["--comm", "pallas", "--uplink", kind],
                           args.rounds, downlink=True)
               for kind in ("topk", "quant")]
    done("7 gather")
    phases += [
        train_phase(torch, "smollm-360m dense topk up and down",
                    ["--comm", "dense", "--uplink", "topk"], args.rounds,
                    downlink=True),
        train_phase(torch, f"smollm-360m packed gather {M_GATHER} of "
                    f"{N_GATHER} topk up and down, full_eval=False",
                    gather + ["--comm", "packed", "--uplink", "topk"],
                    args.rounds, downlink=True, full_eval=False),
        train_phase(torch, "smollm-360m packed quant up and down",
                    ["--comm", "packed", "--uplink", "quant"], args.rounds,
                    downlink=True)]
    done("8 dense, packed")
    from repro_torch.configs.base import FleetConfig
    phases += [
        train_phase(torch, f"smollm-360m fleet zipf weighted gather "
                    f"{M_GATHER} of {N_GATHER} topk up and down",
                    gather + ["--comm", "pallas", "--uplink", "topk"],
                    args.rounds, downlink=True,
                    fleet_fn=zipf_token_fleet(torch, cfg),
                    fleet=FleetConfig(partitioner="zipf", zipf_a=1.2,
                                      cap_factor=4.0, sampler="weighted",
                                      batch_size=2, redraw=True)),
        train_phase(torch, f"smollm-360m launcher --fleet markov gather "
                    f"{M_GATHER} of {N_GATHER} quant up and down",
                    gather + ["--comm", "pallas", "--uplink", "quant",
                              "--fleet", "--fleet-pool", "8", "--sampler",
                              "markov"], args.rounds, downlink=True)]
    if not phases[-2]["weights_non_unit"]:
        raise AssertionError("the zipf fleet's weighted sampler gave only "
                             "0/1 weights")
    done("9 fleet")
    np_rec = np_phase(torch, dev)
    done("10 np")
    paper_rec, paper_launches = paper_phase(torch, dev)
    done("11 paper")
    async_rec, async_launches = async_phase(torch, dev)
    done("12 async")
    scale_rec, scale_launches = scale_phase(torch, dev, args.rounds)
    done("13 scale")
    family_rec, family_launches = family_phase(torch, dev, args.rounds)
    done("14 families")
    moe_rec, moe_launches = moe_phase(torch, dev, args.rounds)
    done("15 moe")
    media_rec, media_launches = media_phase(torch, dev, args.rounds)
    done("16 media")
    wire_rec, wire_launches, commands = wire_phase(torch, dev)
    done("17 wire")
    serve_rec, serve_launches = serve_phase(torch, dev, commands["18(d)"])
    done("18 serve")
    state_rec, state_launches = state_serve_phase(torch, dev,
                                                  commands["19(f)"])
    done("19 state serve")
    launch_rec, launch_launches = launch_phase(torch, dev, sweep)
    done("20 launch")
    rank_rec, rank_launches = rank_phase(
        torch, dev, args.rounds,
        {r["phase"]: r for r in phases + family_rec["cells"]})
    done("21-23 ranks")
    # launches on the main paths: each phase's count (phases 21 and 22's
    # rank by rank), and their sum
    counted = phases + [{"phase": "np quickstart",
                         "launches": np_rec["launches"]}] + paper_launches \
        + async_launches + scale_launches + family_launches + moe_launches \
        + media_launches + wire_launches + serve_launches + state_launches \
        + launch_launches + rank_launches
    for name, rec in records.items():
        rec["launches_by_phase"] = {p["phase"]: p["launches"][name]
                                    for p in counted}
        rec["launches"] = sum(rec["launches_by_phase"].values())
    kern = {"kernels": [records[name] for name in KERNELS]}
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"card": card, "torch": torch.__version__,
                                    "cuda": torch.version.cuda,
                                    "kernels": kern["kernels"],
                                    "phases": phases, "np": np_rec,
                                    "paper": paper_rec,
                                    "async": async_rec,
                                    "scale": scale_rec,
                                    "families": family_rec,
                                    "moe": moe_rec,
                                    "media": media_rec,
                                    "wire": wire_rec,
                                    "serve": serve_rec,
                                    "state_serve": state_rec,
                                    "launch": launch_rec,
                                    "ranks": rank_rec,
                                    "phase_seconds": walls,
                                    "seconds": time.time() - t_start},
                                   indent=1))
    print(json.dumps({"phase_seconds": walls}), flush=True)
    print(f"total: {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps(kern), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
