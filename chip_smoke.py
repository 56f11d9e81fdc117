#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

1. The card: ``nvidia-smi`` name and power limit, ``torch`` device name.
2. The build: every CUDA kernel, built cold with ``nvcc`` (one process per
   source, in parallel); build seconds and ptxas usage, and the flash
   kernel's registers and spills for each head-dim template.
3. Every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at the edge cases.  Integer and bool outputs must be
   exactly equal (tolerance 0).  ``edge_spmv`` sums float32 with atomics in
   an order that changes from run to run, so it and its plain version are
   each held, per vertex, to twice the recursive-summation bound of a
   float64 sum of the same inputs:
   ``|y - y64| <= 2 * deg_in(v) * 2**-24 * sum |x[u]| + 1e-30``.  Each
   kernel is timed with CUDA events beside its plain version, the one
   PyTorch call that computes the same function where there is one, and
   its bound (the least time the card could take: bytes over 3.35 TB/s or
   integer operations over 67 T/s, whichever is larger); a line gives the
   kernel / library ratio, which compares across machines.  Beside the
   per-call time (``ms``, which holds the host's dispatch when that is
   longer than the kernel) each case gets ``device_ms``: the kernels,
   fills and copies ``torch.profiler`` records on the card over 20 more
   launches, per call, and how many of them a call puts on the stream.  A
   capture counts only if it holds the wrapper's own kernel
   (``<name>_kernel``); when none of ``PROFILE_TRIES`` does, a CUDA-graph
   replay gives the time.  The join kernels
   (TPC-DS SF1 key columns) run first, with a probe edge case whose runs
   of one key are far longer than the probe's fence stride; the graph
   kernels run on the JS-OJ graph's CSR (phase 6's shapes), with edge
   cases aimed at the shared-memory
   table of ``edge_spmv`` and ``edge_min_label`` at that size (every edge
   into one vertex, more distinct destinations in a block's range than
   table slots, destinations past the probe bound, runs longer than a
   block's range).  ``edge_min_label`` is timed on WCC's first labels and
   on the labels after one step, which its later launches see.
4. The JS-OJ path: ``ExtractionEngine.extract(fraud_model("store"))`` on
   ``make_tpcds(sf=1000)``, cold then warm.  ``Buy`` and ``Sell`` must
   equal the numpy bags (c_sk, i_sk) and (o_sk, i_sk) of store_sales, and
   the plain-torch path's digests.  The kernel phase replays phases 4-5
   with every ``bloom_build`` and ``bloom_prune_keys`` launch recorded (the
   join's pruning: the probe kernel in its prune mode, counted as
   ``bloom_probe``): it logs their (N, num_bits) and checks and times both
   kernels at the largest and the most frequent, with the bits the path
   built: ``bloom_probe`` itself, ``bloom_prune_keys`` beside the two calls
   it replaces (``bloom_probe`` + ``torch.where``, timed in the same run),
   and ``bloom_probe`` at N = 1 (its prologue alone).  The same replays
   record every ``join_expand`` launch (the pair expansion of each join
   step): each is held bit for bit against ``ref.join_expand`` on its own
   operands (row, right row, matched and valid of every slot, padding
   included), and the largest and most frequent of each path are timed
   beside the plain version and ``torch.searchsorted`` of the slots in the
   count cumsum (the row map alone).
5. The JS-MV path: ``ExtractionEngine.extract(dblp_model())`` on
   ``make_dblp(scale=100)``, cold (view built) then warm (plan cache hit,
   view reused); edge counts against numpy, digests against the plain path.
6. Analytics on the JS-OJ graph (V = 600,502, E = 5,760,000):
   ``engine.analyze`` PageRank on ``Buy`` cold then warm (CSR and plan
   cache hits), then WCC, k-hop (8 seeds, k = 3) and degree statistics.
   WCC, k-hop and the degrees must equal the numpy ground truth
   (``repro_torch.graph.reference``) exactly.  PageRank, on the kernels
   and on the plain-torch path, must be within ``D_max * 2**-24`` of the
   float64 ground truth in L1 (the ranks sum to 1) and in max relative
   error, where ``D_max`` is the largest in-degree: a float32 sum over that
   hub may be off by this much relative (the recursive-summation bound),
   and every vertex's rank shares the error through the dangling mass.
   The CSR built through the ``segment_counts`` kernel must equal the plain
   build array for array.  The kernel phase replays the phase with every
   ``segment_counts`` launch recorded, and checks and times the kernel on
   each distinct operand (the CSR build's sources in extraction order,
   PageRank's out-degree, the degree statistics' sources and targets),
   labelled by call site, and ``frontier_expand`` on each of k-hop's three
   launch operands, bounded by the bytes any kernel must read for the
   operand (a flag per edge, a source per valid edge, a destination per
   valid edge from the frontier, the fill of the output).
7. Analytics on the JS-MV graph (dblp scale=100, ~25M edges): PageRank and
   WCC through the kernels against the plain-torch path on the same CSR:
   WCC exactly, PageRank to the tolerance of phase 6.  Then ``edge_spmv``
   on PageRank's edges and ``edge_min_label`` on WCC's (first step and
   second), checked and timed as in phase 3, and ``segment_counts`` on the
   operands of its launches (replayed), as in phase 6.
8. The LM serving path.  (a) ``flash_attention`` against its plain version
   in bf16 at the main path's shapes (qwen2.5-3b prefill B 4 x S 2048,
   16/2 heads, Dh 128, causal; gemma-2b Dh 256; h2o-danube-3-4b S 8192,
   Dh 120, window 4096) and at the edge cases (S 4096 wraps the K/V ring
   of shared memory many times), and at phase 8c's shapes (seamless's
   encoder, B 4 x S 1,536, 16/16 heads, Dh 64, non-causal, and its
   cross-attention, Sq 256 over Sk 1,536; recurrentgemma's MQA 16/1 at
   Dh 256 under a 2,048 window; qwen3-moe's 64/4 and llama4-scout's 40/8
   GQA, B 4 x S 2,048, causal) and at phase 15's (a qwen2.5-3b rank's
   8/1 and 4/1 heads at ``model`` 2 and 4; the last of internvl2-1b's four
   sequence-parallel ranks, Sq 512 at ``q_offset`` 1,536 against Sk
   2,048, 14/2 heads, Dh 64; a recurrentgemma-9b rank's 8/1 heads at
   ``model`` 2, Dh 256, window 2,048), to the reference test's
   rtol = atol = 2e-2: the kernel rounds the probabilities to bf16 before
   P V, the plain version does not, and both round the output to bf16 once,
   so they may sit a bf16 ulp or two apart.  Timed like phase 3; its bound
   counts the attended (i, j) pairs of this run (4 Dh flops each) over the
   989 TFLOP/s of bf16 tensor cores, and its library yardstick is
   ``scaled_dot_product_attention``.  (b) qwen2.5-3b at full width on one
   card (36 layers, d 2048, vocab 151,936; random bf16 weights from a seeded
   ``torch.Generator``): ``prefill`` of 4 prompts of 2,048 tokens, then 32
   greedy ``decode_step``s, with the flash kernel launched once per layer
   of the prefill.  Then the same prefill and first decode step on the
   plain attention path: the last logits and the first step's logits must
   agree to ``LM_REL_TOL`` x std(logits) (see there).  (c) The other
   families at full width, one model at a time (freed before the next;
   ``LM_FAMILIES``): recurrentgemma-9b whole (38 layers, 26 RG-LRU, 12
   windowed MQA), qwen3-moe-235b-a22b cut to 4 of 94 layers (128
   experts, top 8), llama4-scout-17b-a16e cut to 2 of 48 (16 experts,
   top 1, a shared expert), xlstm-1.3b whole (42 mLSTM, 6 sLSTM layers)
   and seamless-m4t-medium whole (12 encoder layers over frames (4, 1,536,
   1,024) from numpy's seed, 12 decoder layers with cross-attention, a
   256-token prompt): prefill of 4 prompts, 32 greedy decode steps, a
   warm prefill, with every full-sequence attention (self, windowed, the
   encoder's, cross) through the flash kernel: its launches must equal
   the prefill's attentions (0 for xlstm) and none in the decode steps.
   Logged per model: parameters, cold and warm prefill s, decode ms a
   step and tokens/s, the decode step's weight-read bound (the bytes of
   the parameters it must read over 3.35 TB/s; MoE: the experts this
   run's tokens chose), peak memory.  Then the plain attention path as
   in (b); for the MoE models the (token, k) routing choices that differ
   between the paths are counted per layer, and the gate holds the rows
   whose routing agreed in every layer (a near tie flips with the bf16
   rounding of the attention, and that token's output moves by O(1)).
   For recurrentgemma-9b and xlstm-1.3b the recurrent states after the
   prefill and after ``TP_STEPS`` steps are kept for phase 15d/e, and one
   more prefill with one weight of the first mixer moved by a bf16 ulp
   records the model's own sensitivity (logits and states).

9. Refresh and recovery.  (a) JS-OJ: ``fraud_model("store")`` on a fresh
   ``make_tpcds(sf=1000)``, extracted cold and warm, PageRank analysed so a
   CSR is cached, then four ``engine.refresh`` rounds: 28,800 store_sales
   rows in and 14,400 out (the delta path; the cached CSR patched), 1,000
   new items (delta; the vertex set changes, no patch), 432,000 rows out
   (or more, until the churn exceeds the 0.1 threshold: the full path),
   nothing (noop).  Each round must take its path and give the digests of
   every vertex and edge table of a from-scratch extraction on the plain
   path (a new database, exact ANALYZE, a new engine whose compiler
   launches no kernel); after round 1, the patched CSR's live (src, dst)
   multiset of every label must equal the fresh plain build's, PageRank on
   it meets phase 6's ``D_max * 2**-24`` check against plain PageRank on
   that build, and WCC equals plain WCC there.  (b) JS-MV:
   ``dblp_model()`` on a fresh ``make_dblp(scale=100)``; 18,000 wrote rows
   in and 9,000 out; the delta path with the view maintained, digests
   against a plain-path fresh extraction.
   (c) A WAL in a temporary directory is attached to (a)'s database before
   round 1 and a manifest written after round 2; after round 4 the WAL is
   abandoned and ``recover_database`` rebuilds the database on the card:
   its fingerprint, every table's digest and capacity, and the graph an
   engine extracts from it must equal the live ones.  Logged: each
   refresh's ``extract_s`` beside the cold and warm ones, the host fold's
   (``apply_table_delta``) share, the delta terms, the peak device memory,
   and the seconds of the manifest write, the recovery, and its restore and
   replay.  The delta refreshes must launch ``sorted_probe``,
   ``join_expand``, ``bloom_build`` and ``bloom_probe``.
10. Discovery.  ``ExtractionEngine.discover(use_name_hints=False)`` on
   ``anonymize_columns(make_tpcds(sf=1000))`` (JS-OJ's data) and
   ``anonymize_columns(make_dblp(scale=100))`` (JS-MV's), cold then warm.
   The warm call must be a cache hit that runs no pipeline and launches
   nothing.  The cold result must equal a plain-path discovery
   (``PipelineCompiler(use_kernel=False, use_bloom=False)``) in every
   profile's NDV, non-null count and null fraction, every candidate's
   (pair, sampled, matched, confidence), the accepted FKs and the edge
   candidates' signatures, and the JAX package's result at these sizes
   (``DISCOVERY_REF``: the counts, the FK precision and recall, the edge
   recall, and sha1 digests of the accepted (pair, matched, sampled) with
   every profile's NDV, and of every candidate; written by
   ``examples/discovery_summary.py`` on the JAX package).  Every
   containment check launches ``sorted_probe``, ``join_expand``,
   ``bloom_build`` and ``bloom_probe``.  Logged: the cold and warm
   seconds, profile, infer and synthesize seconds, containment checks a
   second, the peak device memory and the launches.
11. The graph service.  ``GraphService`` over a fresh
   ``make_tpcds(sf=1000)`` serving ``fraud_model("store")``, with 4
   workers, two tenants and a ``durable_dir`` in a temporary directory:
   8 identical extracts submitted at once execute once (the others
   coalesce), a tenant's repeat is served from its cache, PageRank on
   ``Buy`` and ``discover`` run through it; phase 9's round-1 churn
   (28,800 store_sales rows in, 14,400 out) goes in through ``mutate``
   and ``refresh`` publishes the next epoch while readers pinned to
   epoch 0 read: their payloads (epoch, fingerprint, vertex and edge
   counts) must equal the first one, during the build and after, and the
   published graph's digests a plain-path fresh extraction's.  Then
   ``examples/serve_graphs_torch.py``'s ``make_server(svc, port=0)``
   answers ``/healthz``, ``/v1/extract``, ``/v1/analyze``,
   ``/v1/discover``, ``/v1/mutate`` (1,000 new items) and ``/v1/refresh``,
   and a 429 under a tight quota.  The service is closed and reopened on
   the same directory: it must report a checkpoint recovery verified
   against, and serve, the fingerprint it last published.  Logged: each
   request kind's seconds (cold and warm), the publish's, the recovery's,
   and the peak device memory with two live snapshots.  Its worker
   threads overlap, so the phase only requires every join kernel,
   ``segment_counts`` and ``edge_spmv`` to launch.
12. Training.  (a) The data plane: ``make_dblp(scale=36)`` extracted and
   its CSR built on the card (the join kernels and ``segment_counts``):
   151,200 vertices, within qwen2.5-3b's vocabulary.  (b)
   ``GraphWalkPipeline`` over Co-auth feeds qwen2.5-3b at its published
   width (3.09 B parameters), B 2 x S 2,048, ``remat``, AdamW, the plain
   attention (no flash launch): a warm-up step, two steps on fresh
   batches, three timed steps on one batch, whose loss must fall; every
   loss finite; step ms, tokens/s, the share of the model-FLOP bound and
   the peak memory are logged; the same step from the same parameters
   and batch twice must give the same loss (``TRAIN_REPEAT_RTOL``).  (c)
   ``run_with_recovery`` at qwen2.5-3b smoke size with a failure at step
   9 of 12 (checkpoints every 4, in a directory that is removed): the
   losses after the restart and the final parameters equal a clean run's
   (rtol 1e-4).  (d) The trained parameters serve a prompt from the
   pipeline: ``prefill`` through the flash kernel (one launch a layer)
   and 8 greedy ``decode_step``s, every logit finite.  (e) Last of all,
   after every other timing, one more step under ``torch.profiler``: its
   device time by kernel name and its busy share.
13. The sharded slice, on ``nccl`` at world size 1 (a ``FileStore``
   under ``build/``; NCCL cannot put two ranks on one card, so each
   exchange moves nothing while the code, the communicator and the
   kernels run at full width; the group is destroyed after the phase).
   (a) ``distributed_join`` on the JS-OJ extraction's inner equi-joins
   (store_sales, 2.88M rows, on ``c_sk``, ``i_sk`` and ``o_sk`` against
   their dimensions, TPC-DS SF1), directly and with the fact side
   repartitioned first (``left_partitioned=True``): every repartition's
   overflow must be 0 and every join's ``table_digest`` equal
   ``sort_merge_join``'s on the same tables (the plain bisection probe);
   its ``sorted_probe`` and ``join_expand`` launches are the
   ``distributed_join`` path, each recorded and held against its plain
   version on its own operands (padded 5.76M-row probe sides), the largest
   and most frequent timed.
   (b) ``moe_ffn_shard_map`` on a 1x1 mesh at full width, one layer, B 4
   x S 2,048 tokens: qwen3-moe (D 4,096, 128 experts, top-8, F 1,536) and
   llama4-scout must equal ``moe_ffn`` bit for bit, with equal routes
   (llama4-scout adds its shared expert after the routed sum's cast, as
   the reference, but with top-1 routing the gate is exactly 1 and the
   routed sum one bf16 value, so the cast changes nothing).  Then phase
   8c's 4-layer qwen3-moe
   ``forward`` with ``ActSharding(moe_mesh=mesh)`` (the ``sharded_moe``
   path, through the flash kernel) must give the logits of the forward
   without it.  (c) the dry run's per-device argument bytes on the 1x1
   mesh for qwen2.5-3b at phase 8b's serving shape (B 4, a cache of 2,080
   positions) must be within ``DRYRUN_REL_TOL`` of the growth of
   ``torch.cuda.memory_allocated()`` when the parameters, cache and token
   are built on the card.  Each part's times (the distributed path beside
   the single-device call, warm, CUDA events) are printed beside the
   card's name and power limit.
14. The sharded train step, on ``nccl`` at world size 1 (phase 13's
   ``nccl_world``; every gather and reduce-scatter a copy).  (a)
   qwen2.5-3b at full width and depth, phase 12's B 2 x S 2,048, remat,
   AdamW, one microbatch, on a 1x1 ``("data", "model")`` mesh (ZeRO-3 by
   ``zero_policy``): one unsharded step from seeded parameters, a fresh
   AdamW state and a seeded batch, its parameters and moments copied to
   the host; then the same start as ``DTensor``s
   (``training.sharded.shard_train_state``) and one sharded step
   (``act_sharding``): the loss within ``TRAIN_REPEAT_RTOL`` and every
   parameter and moment leaf bit-equal (else within
   ``test_train_step_matches_jax``'s tolerances; the log says which held,
   and anything else fails); then ``SHARDED_TRAIN_TIMED`` timed steps,
   whose loss must fall: step ms, ``max_memory_allocated`` and the ratio
   to phase 12's step.  (b) qwen3-moe-235b-a22b at full width cut to 1 of
   94 layers (3.73 B parameters), B 1 x S 2,048, the expert-parallel MoE
   (``moe_mesh``; its ``all_to_all`` and ``all_gather`` backwards on
   ``nccl``), against the unsharded step (``moe_ffn``) alike.  (c) qwen2.5-3b
   smoke: one sharded step, its ``DTensor`` state saved under ``build/``
   (removed after) and restored onto the mesh with ``shardings`` and whole:
   every leaf bit-equal.  (d) The tensor-parallel step at ``model`` 2:
   qwen2.5-3b at full width cut to 4 of its 36 layers, phase 12's shape,
   one unsharded step from seeded parameters, state and batch, its loss,
   parameters and moments saved under ``build/`` and freed; then two
   processes, a rank each on the one card over ``gloo``
   (``chip_smoke.py --tp-rank R --tp-world 2 --tp-dir D --tp-train``),
   start from the same seed, place the parameters by
   ``params_shardings`` and build the AdamW state block by block (each
   block asserted at ``local_shape``), and take one step under
   ``act_sharding``: each rank's ``heads`` block at 8 of 16 heads and its
   ``logits`` at 75,968 of 151,936 columns (``recording_placements``);
   its all-reduce bytes those the dry run records for the rank's program
   (``tp_train_reckoning``: ``launch.dryrun.run_step`` on ``meta``
   blocks of a fake world of 2) plus the step's own reductions
   (``step_reductions``), and no gather of whole logits; the loss within
   ``LOSS_TOL`` of the unsharded step's; each moment block within
   ``GRAD_TOL`` of the same block of the reference; each parameter block
   within lr times the difference of the updates the two sides' moments
   give plus a bf16 ulp, and to a bf16 ulp of the reference where the
   gradient's sign is certain and the new parameter is at least
   ``TP_TRAIN_FAR`` x lr (``step_margins``), each leaf group's worst
   margin printed, and the entries that miss the CPU tests' rule
   recorded (``sign_rule_misses``); the peak memory a rank beside the
   unsharded step's.  The step's seconds go through the host, not
   tensor-parallel speed.  No kernel launches in the train step (the plain
   attention, as the JAX package's); the phase asserts 0 for all eight.
   ``python3 chip_smoke.py --tp-train-depths 1,2,4`` runs this phase
   alone at each of those depths.
15. Tensor-parallel serving over ``model`` (``ActSharding.mesh``).  (a)
   Phase 8b's qwen2.5-3b, B 4 x 2,048 + 32 steps fed 8b's greedy tokens,
   through ``DTensor`` parameters placed by ``params_shardings`` on a 1x1
   mesh (``nccl`` at world size 1) and ``act_sharding``'s ``ActSharding``:
   every logit row bit-equal to 8b's (TP at ``model`` 1 is the identity),
   36 flash launches.  (b) The same model at ``model`` 2 and 4, one
   process a rank on the one card (``chip_smoke.py --tp-rank``, the two
   worlds at once) over ``gloo`` (``nccl`` cannot put two ranks on one
   card; every collective is staged through the host, so no time of
   theirs is TP speed): each rank's parameter and cache blocks against
   ``local_shape``, its GEMMs and flash launches at its local widths (8/1
   and 4/1 heads), the prefill's cache narrowed into the decode layout
   (``head_dim``-sharded at ``model`` 4), ``TP_STEPS`` steps fed 8b's
   tokens; every logit row within ``LM_REL_TOL`` x std of 8b's and the
   greedy tokens agreeing on at least ``TP_ARGMAX_MIN`` of the rows.  (c)
   At ``model`` 4, internvl2-1b at full width, B 4 x (256 patches + 1,792
   tokens), its prefill sequence-parallel (each rank's 512 rows against
   the 2,048 gathered keys: the flash kernel's ``q_offset``), against the
   unsharded prefill alike.  (d, e) Then, two processes a model, both
   models at once, at ``model`` 2, their recurrent mixers split by
   channels (the mLSTM's memory by key rows): first each mixer alone at
   full width, split against whole on the same seeded inputs
   (``MIXER_OUT_TOL``, ``MIXER_STATE_TOL``); then recurrentgemma-9b (38
   layers) and xlstm-1.3b (48) at full width, fed 8c's prompt (B 4 x
   2,048) and its first ``TP_STEPS`` greedy tokens: each rank's parameter
   and cache blocks at ``local_shape``; the recurrent states gathered
   after the prefill and after the steps and held to 8c's leaf by leaf
   (the first recurrent layer's to ``FIRST_STATE_TOL``, every leaf to
   ``LM_REL_TOL`` of its largest entry but the sLSTM's rescaled ``c`` and
   ``n``); every logit row within ``LM_REL_TOL`` x std of 8c's and the
   greedy tokens agreeing on ``TP_ARGMAX_MIN`` of the rows.  xlstm-1.3b
   turns a one-ulp change into drift beyond those bounds at full depth
   (8c measures it: ``TP_RECURRENT_CUT``), so there its run is recorded
   (the first layer's states still gated) and the gates hold at one
   cycle, 8 layers, against the unsharded run of that cut.  Logged per
   rank: the parameter and state blocks' bytes beside the whole's, the
   peak memory beside 8c's, the bytes of each kind of collective of the
   prefill and of a decode step, and the seconds over ``gloo`` (no TP
   speed).  Every flash launch of (b)-(e) is held against the plain
   version on its own operands (``FLASH_TOL``).  A rank that fails fails
   the phase.

The phases run in their order, each kernel case checked and timed with
CUDA events where it stands.  Then a kernel phase: the kernel cases of 4-7
on the operands the paths' launches saw, taken from an untimed replay of
each path on regenerated data with the wrappers recorded (``replay``, which
checks that the replay launched every kernel as often as the timed run);
then phase 9's three delta refreshes and phase 10's two cold discoveries
replayed alike (the same seeded churn, the same data), every one of their
``sorted_probe``, ``join_expand``, ``bloom_build`` and ``bloom_prune_keys``
launches held exactly against its plain version and the largest and most
frequent operands of each timed; and last every
case's device time (``torch.profiler``, on operands rebuilt alike).  So no profiler session and no recorded operand comes before or
during a path's timed run, nor a profiler session before a CUDA-event
timing: after one, the host's launches are slower.

Launch counters are set to 0 just before each of phases 4–7, 8b, each
model of 8c, each refresh of phase 9, each discovery of phase 10,
phase 11, 12's data plane, training and serving, 13a's distributed
joins and 13b's forward, 14's sharded steps and each rank's step of
14d, and 15a's run and each rank's run of 15b-e (summed over the ranks),
and read just after;
every kernel of a path must have launched inside it, and on every path
``join_expand`` as often as ``sorted_probe`` (one each a join step).  The
last lines are a JSON object of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Any failed check raises
(exit != 0).  Without a CUDA card, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TPCDS_SF = 1000        # store_sales 2.88M rows: TPC-DS SF1's fact size
DBLP_SCALE = 100       # wrote 1.8M rows, Auth-Edit ~18M edges

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (fp32 table)
HASH_OPS = 6                  # multiply, add, shift, xor, modulo, or/test

JOIN_KERNELS = ("sorted_probe", "join_expand", "bloom_build", "bloom_probe")
PROBE_SOURCE = "src/repro_torch/kernels/csrc/sorted_probe.cu"
# join_expand replaces no Pallas kernel: the jnp scatter and scan
EXPAND_REPLACES = "src/repro/relational/join.py:64"
BLOOM_SOURCE = "src/repro_torch/kernels/csrc/bloom.cu"
BLOOM_REPLACES = "src/repro/kernels/bloom.py:29"
PROBE_REPLACES = "src/repro/kernels/bloom.py:48"
FRONTIER_SOURCE = "src/repro_torch/kernels/csrc/frontier.cu"
FRONTIER_REPLACES = "src/repro/kernels/frontier.py:28"
NULL_KEY = 2**31 - 1
SEGMENT_SOURCE = "src/repro_torch/kernels/csrc/segment_csr.cu"
SEGMENT_REPLACES = "src/repro/kernels/segment_csr.py:24"
GRAPH_KERNELS = ("segment_counts", "edge_spmv", "edge_min_label",
                 "frontier_expand")
SPMV_BOUND_FACTOR = 2.0       # x the recursive-summation bound
PROFILE_TRIES = 4
# the shared-memory table of csrc/spmv.cu and csrc/label_prop.cu: its
# multiplicative hash, 2**12 slots, probes of at most 16 slots
TABLE_HASH, TABLE_SLOT_BITS, TABLE_MAX_PROBE = 2654435769, 12, 16
KHOP_SEEDS, KHOP_K = 8, 3
PR_ITERS = 20
# phase 9's churn on JS-OJ's store_sales (2.88M rows) and JS-MV's wrote
# (1.8M rows): ~1% in then 0.5% out (delta path, CSR patched), 1,000 new
# items (delta, the vertex set changes), 15% out (full), nothing (noop)
REFRESH_INSERT, REFRESH_DELETE = 28_800, 14_400
ITEM_INSERT = 1_000
FULL_DELETE = 432_000
MV_INSERT, MV_DELETE = 18_000, 9_000
OJ_SEED, MV_SEED = 9, 10
# phase 10: what the JAX package's discovery gives at these sizes, on
# anonymized data without name hints, written by
# examples/discovery_summary.py run on the JAX package on a CPU.  numpy's
# Zipf draws differ between releases, so the TPC-DS numbers are of the
# tables make_tpcds(sf=1000) generates with numpy 2.3.5 (the H100
# machine's: saved there with ``--package repro_torch --save-tables``,
# loaded on the CPU with ``--load-tables``); numpy 2.0.2 draws other
# sales keys.  The DBLP tables are the same under both.
DISCOVERY_REF = {
    "tpcds": {"candidates": 123, "containment_checks": 123,
              "compiled_checks": 123, "accepted_fks": 14,
              "edge_candidates": 428, "precision": 0.6428571428571429,
              "recall": 0.75, "edge_recall": 0.5,
              "data_sha1": "d4295a6759621d4f0d2b50a45a44d2a42316ff20",
              "fk_ndv_sha1": "0cc8345717da57d051a459ca1bb2c981ab8e938f",
              "candidates_sha1":
                  "d90ead77a3f959199a2f0dc4641a36b514201dde"},
    "dblp": {"candidates": 50, "containment_checks": 50,
             "compiled_checks": 50, "accepted_fks": 5,
             "edge_candidates": 16, "precision": 1.0, "recall": 1.0,
             "edge_recall": 1.0,
             "data_sha1": "5adb53b8aa7abd7793eef2fbfb2b0d09c26d08ee",
             "fk_ndv_sha1": "caf2679d62cdc10054c4f745f025873a447f528e",
             "candidates_sha1": "abdea35c8a4708076c5b28575c06700941898e31"},
}
DISCOVERY_SIZES = (("tpcds", TPCDS_SF, "js_oj_discovery"),
                   ("dblp", DBLP_SCALE, "js_mv_discovery"))
SERVICE_TENANTS = ("alice", "bob")
SERVICE_COALESCE = 8          # identical concurrent extracts
SERVICE_PINNED_READS = 3      # epoch-0 reads during and after a publish

BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
FLASH_TOL = 2e-2              # rtol = atol of tests/test_kernels.py
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 2048, 32
# max |kernel - plain| / std(plain logits).  The two paths differ only in
# where the attention probabilities are rounded to bf16, so each layer's
# attention output may move by a bf16 ulp (2**-8 relative), and the moves
# of 36 layers carry through the residual stream to the logits.  Measured
# on the CPU at depth 36 (d 64-256, vocab 4096) with float32 probabilities
# on one side: 0.08, the max over 16k logits; over 4 x 151,936 it sits a
# little further out.  A mask or indexing fault moves logits by O(1) x std.
LM_REL_TOL = 0.25
# phase 8c: (arch, num_layers after a depth cut or None, prompt length).
# qwen3-moe (94 layers, ~470 GB of bf16) and llama4-scout (48, ~216 GB) do
# not fit one 80 GB card: cut in depth, full width.  seamless's decoder
# prompt is 256 tokens over 1,536 encoder frames.
LM_FAMILIES = (("recurrentgemma-9b", None, 2048),
               ("qwen3-moe-235b-a22b", 4, 2048),
               ("llama4-scout-17b-a16e", 2, 2048),
               ("xlstm-1.3b", None, 2048),
               ("seamless-m4t-medium", None, 256))
# phase 12: train qwen2.5-3b at its published width on random walks over
# the port's own extraction of make_dblp(scale=36), Co-auth: 4,200 x 36 =
# 151,200 vertices, within the vocabulary (151,936), so no walk starts
# outside it (ROADMAP.md §3: a first token past the vocabulary embeds as
# NaN in both packages).
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_DBLP_SCALE = 36
TRAIN_BATCH, TRAIN_SEQ, TRAIN_FRESH, TRAIN_TIMED = 2, 2048, 2, 3
# The same step from the same parameters and batch twice: the forward runs
# the same kernels on the same operands in the same order, and cuBLAS's
# GEMMs repeat bit for bit on one card; a float32 sum that split its work
# otherwise would move the loss (~12) by a few ulps, far below this.
TRAIN_REPEAT_RTOL = 1e-6
TRAIN_SERVE_STEPS = 8
# the recovery drill at smoke size (tests/test_fault_tolerance.py's)
RECOVERY_STEPS, RECOVERY_EVERY, RECOVERY_FAIL = 12, 4, 9
# phase 13: the sharded slice on a world of one rank (nccl, one card).
# (a) the JS-OJ extraction's inner equi-joins, store_sales (2.88M rows) on
# each dimension key: (fact key, dimension table, dimension key)
SHARDED_JOINS = (("c_sk", "customer", "c_id"), ("i_sk", "item", "i_id"),
                 ("o_sk", "outlet_store", "o_id"))
# (b) the expert-parallel MoE at full width, one layer, on phase 8b/8c's
# B 4 x S 2,048 tokens; then phase 8c's 4-layer qwen3-moe forward
SHARDED_MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")
SHARDED_FORWARD = ("qwen3-moe-235b-a22b", 4)
# (c) the dry run's argument bytes against the card's allocation
DRYRUN_REL_TOL = 0.01
# phase 14: the sharded train step on a world of one rank (nccl, one card).
# (a) phase 12's model and shape, whole; (b) qwen3-moe at full width, cut
# to 1 of its 94 layers (~3.73 B parameters: its state does not fit one
# card at more), B 1 x S 2,048, with the expert-parallel MoE
SHARDED_TRAIN_TIMED = 3
SHARDED_TRAIN_MOE = ("qwen3-moe-235b-a22b", 1, 1, 2048)  # arch, layers, B, S
# phase 15: tensor-parallel serving over ``model``.  (b) phase 8b's model
# at model 2 and 4, one process a rank on the one card over gloo (nccl
# cannot put two ranks on one device), TP_STEPS decode steps fed 8b's
# greedy tokens; (c) internvl2-1b at model 4, its prefill
# sequence-parallel (14 heads do not divide 4): 256 patches + 1,792 tokens
TP_WORLDS = (2, 4)
TP_STEPS = 8
TP_VLM, TP_VLM_TOKENS = "internvl2-1b", 1792
# greedy tokens of a TP run against 8b's: random weights give near-flat
# logits, so a near-tie may flip now and then (one of 8 rows at smoke
# size on the CPU); a layout or exchange fault agrees on next to none
TP_ARGMAX_MIN = 0.75
# (d, e) the recurrent families at full width at model 2, one process a
# rank over gloo, fed phase 8c's prompt (B 4 x 2,048) and its first
# TP_STEPS greedy tokens: recurrentgemma-9b (38 layers) and xlstm-1.3b
# (48).  Their states after the prefill and after the steps are gathered
# and held to the unsharded run's leaf by leaf (check_states): max |TP -
# unsharded| over the leaf's largest entry within LM_REL_TOL.  A state
# drifts with the hidden states that feed it (the split sums round
# otherwise in bf16, as the logits do); a channel or key-row block in
# another rank's place is off by about that largest entry.
TP_RECURRENT = ("recurrentgemma-9b", "xlstm-1.3b")
TP_RECURRENT_WORLD = 2
# xlstm-1.3b at random weights amplifies a bf16 rounding: one weight of its
# first mLSTM moved by a bf16 ulp moves 8c's full-depth logits by 0.56 x std
# and flips half the greedy tokens (the sLSTM's stabilizer m sums its raw
# forget gates to ~544 over 2,048 steps).  So at full depth its TP run is
# recorded against 8c's, not gated, and the gate holds at one cycle of its
# pattern (8 layers: 7 mLSTM, 1 sLSTM) against the unsharded run of that
# cut; each mixer alone is gated at full width.
TP_RECURRENT_CUT = ("xlstm-1.3b", 8)
# the first recurrent layer's states after the prefill: its input is the
# embedding alone, so the split and whole runs agree to float32 sums (a
# bf16 ulp of the leaf's largest entry; a block in another rank's place is
# off by about that entry)
FIRST_STATE_TOL = 2.0**-8
# each mixer alone, split against whole on the same inputs: outputs within
# two bf16 ulps of their largest entry (a row-parallel psum rounds each
# rank's bf16 part), states within one (a decode step's bf16 projections
# through a column block may round apart from the whole matrix's: cuBLAS
# takes another kernel at 4 rows)
MIXER_OUT_TOL, MIXER_STATE_TOL = 2.0**-6, 2.0**-8
# the sLSTM's c and n are held relative to exp(m), m a running max of sums
# of its raw forget gates: a bf16 rounding upstream moves m's path and
# rescales both (one weight moved by an ulp moves them by 0.15-0.19 of
# their largest entry within one cycle), so they are recorded, not gated;
# h = o c / max(n, 1), what the layer passes on, reaches the logits
SLSTM_SCALED = ("_slstm/c", "_slstm/n")
# the tolerances of tests/test_torch_training.py::test_train_step_matches_jax
# (moments to GRAD_TOL x their largest entry, v twice that; parameters to a
# bf16 ulp where the gradient's sign is certain, 2 lr elsewhere), held where
# the sharded step is not bit-equal to the unsharded one
GRAD_TOL, BF16_ULP = 2.0**-5, 2.0**-7
# (d) the tensor-parallel train step at model 2, one process a rank on the
# one card over gloo: qwen2.5-3b at full width cut to 4 of its 36 layers
# (619.6 M parameters, 311.2 M of them the tied embedding), phase 12's
# B 2 x S 2,048, remat, AdamW, one step against the unsharded step of the
# cut from the same parameters, state and batch: the loss to
# tests/test_torch_training.py's LOSS_TOL, the moments to GRAD_TOL (v twice
# that); each parameter to lr times the difference of the two AdamW updates
# the two sides' moments give plus a bf16 ulp (step_margins), and, where
# the gradient's sign is certain and the new parameter is at least
# TP_TRAIN_FAR x lr (its old value at least that far from the update of
# about lr it could cancel), to a bf16 ulp of the reference, the CPU
# tests' rule.  That rule does not hold everywhere at full width: a
# parameter within ~1e-5 of lr nearly cancels its update, and the eps of
# |g| / (|g| + eps) moves the small result by more than an ulp of it (the
# entries that miss it are recorded, sign_rule_misses)
TP_TRAIN_LAYERS, TP_TRAIN_WORLD, TP_TRAIN_FAR = 4, 2, 0.5
LOSS_TOL = 1e-4


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, warmed up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time(torch, fn, kernel: str, iters: int = 20, warmup: int = 3):
    """(ms, operations) on the card per call of ``fn``: the kernels, fills
    and copies that ``torch.profiler`` records over ``iters`` calls, without
    the host's dispatch: the larger of two captures.  A capture counts only
    if it holds ``kernel`` (the wrapper's CUDA kernel, by name) at least
    every other call, and is taken again otherwise (up to
    ``PROFILE_TRIES``); when none holds it, the time comes from a CUDA-graph
    replay of the calls (operations None)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # each operation's mean time x its launches a call: a few events
        # the profiler drops do not lower the sum
        us, ops, held = 0.0, 0, False
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    2 * e.count >= iters:
                per_call = round(e.count / iters) or 1
                us += e.self_device_time_total / e.count * per_call
                ops += per_call
                held = held or kernel in e.key
        if held:
            seen.append((us / 1e3, ops))
        else:
            log(f"  (a profiler capture lacks {kernel}: taken again)")
        if len(seen) == 2:
            # now and then a capture drops most events of a kernel, and
            # its sum reads low: of two captures, the larger
            return max(seen)
    if seen:
        return seen[0]
    log(f"  (no profiler capture held {kernel}: CUDA-graph replay)")
    return graph_ms(torch, fn, iters), None


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``iters`` calls: device time without the host's dispatch.  Warmed up
    on the capture stream first, so per-stream state (the Bloom build's
    scratch) exists before the capture."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def recording(kops, name: str):
    """Swap ``kops.<name>`` for a recorder while the block runs: each call
    appends (call site, args) to the yielded list and goes on to the
    wrapper, whose launch count counts it as before.  The list holds every
    operand, so only untimed runs record (``replay``, phase 13a's counted
    run)."""
    wrapper, calls = getattr(kops, name), []

    def record(*args, **kwargs):
        caller = sys._getframe(1)
        calls.append((f"{caller.f_code.co_name} < "
                      f"{caller.f_back.f_code.co_name}", args))
        return wrapper(*args, **kwargs)

    setattr(kops, name, record)
    try:
        yield calls
    finally:
        setattr(kops, name, wrapper)


def distinct_calls(torch, calls):
    """[(label, args)] of the recorded calls with distinct operands (the
    first tensor argument), in order; the label names the call site and
    numbers the site's distinct operands (#0, #1, ...)."""
    out, seen = [], {}
    for site, args in calls:
        prior = seen.setdefault(site, [])
        if any(p.shape == args[0].shape and torch.equal(p, args[0])
               for p in prior):
            continue
        out.append((f"{site} #{len(prior)}", args))
        prior.append(args[0])
    return out


def bound_ms(nbytes: float, ops: float, ops_per_s: float = INT_OPS_PER_S):
    """The larger of bytes over HBM bandwidth and operations over their peak
    rate (32-bit integer by default; bf16 tensor cores for attention)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"shape/dtype {tuple(got.shape)}/{got.dtype} != "
            f"{tuple(want.shape)}/{want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def flash_ptxas(log_text: str):
    """[(head-dim template, "N registers, ... spill ...")] from the flash
    kernel's ptxas -v log, one entry per template instantiation."""
    import re

    out, template = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '.*kernelILi(\d+)E", line)
        if m:
            template, spill = m.group(1), ""
        elif template and "spill" in line:
            spill = line.strip()
        elif template and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((template, f"{regs} registers, {spill}"))
            template = None
    assert out, "no flash_attention template in the ptxas log"
    return out


def record_rows(torch, rows, name, source, replaces, cases, compare=None,
                device=True):
    """Check and time each case of one kernel; append its JSON row (or add
    the cases to the kernel's row, when it has one already) and return it.

    cases: [(label, run_kernel, run_plain, run_library, nbytes, ops)], with
    an optional seventh item, the operations' peak rate (``bound_ms``).
    ``compare(got, want) -> max_abs_err`` raises when the two disagree
    beyond the kernel's tolerance; the default demands exact equality.
    ``device=False`` leaves ``device_ms`` to ``add_device_times`` (a
    profiler session must not precede the paths' timed runs).
    """
    out_cases = []
    worst = 0
    for label, run_k, run_p, run_l, nbytes, ops, *rate in cases:
        got, want = run_k(), run_p()
        if compare is not None:
            err = compare(got, want)
        elif isinstance(got, tuple):
            err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
        else:
            err = max_abs_err(torch, got, want)
        if compare is None:
            assert err == 0, f"{name} {label}: max_abs_err {err}"
        worst = max(worst, err)
        # turns: plain, kernel, kernel, plain
        p1 = cuda_ms(torch, run_p)
        k1 = cuda_ms(torch, run_k)
        k2 = cuda_ms(torch, run_k)
        p2 = cuda_ms(torch, run_p)
        lib = cuda_ms(torch, run_l) if run_l is not None else None
        dev_ms, dev_ops = (device_time(torch, run_k, f"{name}_kernel")
                           if device else (None, None))
        b, by = bound_ms(nbytes, ops, *rate)
        ms = min(k1, k2)
        ratio = None if lib is None else ms / lib
        out_cases.append({"shape": label, "ms": ms, "device_ms": dev_ms,
                          "device_ops_per_call": dev_ops,
                          "plain_ms": min(p1, p2), "library_ms": lib,
                          "library_ratio": ratio,
                          "bound_ms": b, "bound_by": by})
        dev = "later" if dev_ms is None else \
            f"{dev_ms:.4f} ms in {dev_ops} operations a call"
        log(f"  {name} [{label}] kernel {ms:.4f} ms (device {dev}), plain "
            f"{min(p1, p2):.4f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{b:.4f} ms ({by})"
            + ("" if ratio is None else f"; kernel / library {ratio:.3f}"))
    row = next((r for r in rows if r["name"] == name), None)
    if row is not None:                   # more cases of a kernel's row
        row["cases"] += out_cases
        row["max_abs_err"] = max(row["max_abs_err"], worst)
        return row
    head = out_cases[0]
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0,
           "max_abs_err": worst, "ms": head["ms"],
           "device_ms": head["device_ms"],
           "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
           "bound_by": head["bound_by"],
           "library_ms": head["library_ms"], "cases": out_cases}
    rows.append(row)
    return row


def add_device_times(torch, rows, name, cases):
    """``device_ms`` of the cases ``record_rows(..., device=False)`` left
    without it, on ``cases`` (record_rows' form) rebuilt alike, by label."""
    row = next(r for r in rows if r["name"] == name)
    for label, run_k, *_ in cases:
        out = next(c for c in row["cases"] if c["shape"] == label)
        assert out["device_ms"] is None, f"{name} [{label}] timed twice"
        out["device_ms"], out["device_ops_per_call"] = device_time(
            torch, run_k, f"{name}_kernel")
        log(f"  {name} [{label}] device {out['device_ms']:.4f} ms in "
            f"{out['device_ops_per_call']} operations a call")
    row["device_ms"] = row["cases"][0]["device_ms"]


def probe_case(torch, kops, ref, label, sk, pk):
    """A ``record_rows`` case of sorted_probe, with two ``searchsorted``
    calls as the library call: the sorted keys and the probe keys read
    once, two int32 bounds written per probe key; a bisection's compares."""
    s, p = sk.shape[0], pk.shape[0]
    depth = (max(s, 2) - 1).bit_length() + 1     # ceil(log2 s) + 1
    return (label,
            lambda: kops.sorted_probe(sk, pk),
            lambda: ref.sorted_probe(sk, pk),
            lambda: (torch.searchsorted(sk, pk, out_int32=True),
                     torch.searchsorted(sk, pk, right=True, out_int32=True)),
            4 * s + 4 * p + 8 * p, 2 * depth * p)


def segment_case(torch, kops, ref, label, values, valid, n):
    """A ``record_rows`` case of segment_counts on one operand, with
    ``bincount`` of its valid in-range values as the library call;
    ``{live}`` in ``label`` becomes the count of valid slots."""
    counted = values[valid & (values >= 0) & (values < n)].to(torch.int64)
    e, live = values.shape[0], int(valid.sum())
    label = label.format(live=live)
    # a flag per slot, a value per valid slot, a count per bin
    return (label, lambda: kops.segment_counts(values, valid, n),
            lambda: ref.segment_counts(values, valid, n),
            lambda: torch.bincount(counted, minlength=n),
            e + 4 * live + 4 * n, live)


def bloom_case(kops, ref, label, keys, valid, nbits):
    """A ``record_rows`` case of bloom_build (no library call computes it);
    ``{live}`` in ``label`` becomes the count of valid keys."""
    n, live = keys.shape[0], int(valid.sum())
    label = label.format(live=live)
    # a flag per slot, a key per valid slot, an int32 per bit
    return (label, lambda: kops.bloom_build(keys, valid, nbits),
            lambda: ref.bloom_build(keys, valid, nbits), None,
            n + 4 * live + 4 * nbits, 2 * HASH_OPS * live)


def record_segment_calls(torch, kops, ref, rows, path, calls):
    """Check and time segment_counts with CUDA events on the distinct
    operands of the launches recorded on one path (cases of the kernel's
    row); returns the cases, for ``add_device_times``."""
    cases = []
    for label, (values, valid, n) in distinct_calls(torch, calls):
        label = (f"{path} {label}: E={values.shape[0]} ({{live}} valid) "
                 f"into V={n}")
        cases.append(segment_case(torch, kops, ref, label, values, valid, n))
    record_rows(torch, rows, "segment_counts", SEGMENT_SOURCE,
                SEGMENT_REPLACES, cases, device=False)
    return cases


def most(shapes):
    """{shape: "largest" / "most frequent"} of a Counter of shapes."""
    picks = {max(shapes): "largest", shapes.most_common(1)[0][0]:
             "most frequent"}
    if len(picks) == 1:
        picks = {max(shapes): "largest and most frequent"}
    return picks


def record_bloom_calls(torch, kops, ref, rows, calls, where="phases 4-5"):
    """Log the (N, num_bits) of every bloom_build launch ``where`` (the
    paths that made ``calls``), and check and time the kernel with CUDA
    events at the largest and the most frequent; returns the cases, for
    ``add_device_times``."""
    shapes = collections.Counter((args[0].shape[0], args[2])
                                 for _, args in calls)
    log(f"bloom_build launches of {where} by (N, num_bits): "
        f"{sorted(shapes.items())}")
    cases = []
    for shape, which in most(shapes).items():
        keys, valid, nbits = next(args for _, args in calls
                                  if (args[0].shape[0], args[2]) == shape)
        label = (f"{which} of {where} ({shapes[shape]} of "
                 f"{len(calls)} launches): N={shape[0]} ({{live}} valid) "
                 f"bits={nbits}")
        cases.append(bloom_case(kops, ref, label, keys, valid, nbits))
    record_rows(torch, rows, "bloom_build", BLOOM_SOURCE, BLOOM_REPLACES,
                cases, device=False)
    return cases


def bloom_probe_case(kops, ref, label, bits, keys):
    """A ``record_rows`` case of bloom_probe (no library call computes it):
    a key read and a bool written per key, the bitset read once."""
    n, nbits = keys.shape[0], bits.shape[0]
    return (label, lambda: kops.bloom_probe(bits, keys),
            lambda: ref.bloom_probe(bits, keys), None,
            5 * n + 4 * nbits, 2 * HASH_OPS * n)


def prune_case(torch, kops, ref, label, bits, keys):
    """A ``record_rows`` case of bloom_prune_keys against its plain
    version, ``where(ref.bloom_probe(...), keys, NULL_KEY)``: a key read
    and an int32 written per key, the bitset read once."""
    n, nbits = keys.shape[0], bits.shape[0]
    null = torch.tensor(NULL_KEY, dtype=torch.int32, device=keys.device)
    return (label, lambda: kops.bloom_prune_keys(bits, keys),
            lambda: torch.where(ref.bloom_probe(bits, keys), keys, null),
            None, 8 * n + 4 * nbits, 2 * HASH_OPS * n)


def probe_pair(torch, kops, bits, keys):
    """The two calls bloom_prune_keys replaces on the join path:
    ``where(bloom_probe(bits, keys), keys, NULL_KEY)``."""
    null = torch.tensor(NULL_KEY, dtype=torch.int32, device=keys.device)
    return lambda: torch.where(kops.bloom_probe(bits, keys), keys, null)


def record_probe_calls(torch, kops, ref, rows, calls, where="phases 4-5"):
    """Log the (N, num_bits) of every bloom_prune_keys launch ``where``,
    and check and time (CUDA events) at the largest and the most
    frequent, with the bits the path built: bloom_probe, bloom_prune_keys
    beside ``probe_pair`` (``pair_ms``, same run), and bloom_probe at
    N = 1 on the largest's bits (the prologue alone).  Returns
    ``(cases, pairs)`` for ``add_device_times`` / ``add_pair_device_times``.
    """
    shapes = collections.Counter((args[1].shape[0], args[0].shape[0])
                                 for _, args in calls)
    log(f"bloom_probe launches of {where} (bloom_prune_keys) by "
        f"(N, num_bits): {sorted(shapes.items())}")
    cases, pairs = [], []
    for shape, which in most(shapes).items():
        bits, keys = next(args[:2] for _, args in calls
                          if (args[1].shape[0], args[0].shape[0]) == shape)
        label = (f"{which} of {where} ({shapes[shape]} of {len(calls)} "
                 f"launches): N={shape[0]} bits={shape[1]}")
        cases.append(bloom_probe_case(kops, ref, label, bits, keys))
        prune = prune_case(torch, kops, ref, f"bloom_prune_keys, {label}",
                           bits, keys)
        cases.append(prune)
        pairs.append((prune[0], probe_pair(torch, kops, bits, keys)))
        if which.startswith("largest"):
            cases.append(bloom_probe_case(
                kops, ref, f"prologue alone: N=1 bits={shape[1]} (the "
                f"largest's of {where})", bits, keys[:1].clone()))
    row = record_rows(torch, rows, "bloom_probe", BLOOM_SOURCE,
                      PROBE_REPLACES, cases, device=False)
    for label, pair in pairs:
        case = next(c for c in row["cases"] if c["shape"] == label)
        case["pair_ms"] = min(cuda_ms(torch, pair), cuda_ms(torch, pair))
        log(f"  bloom_probe + torch.where [{label}] {case['pair_ms']:.4f} "
            f"ms; bloom_prune_keys / pair {case['ms'] / case['pair_ms']:.3f}")
    return cases, pairs


def record_sorted_probe_calls(torch, kops, ref, rows, calls, where):
    """Log the (P, S) of every sorted_probe launch ``where``, and check and
    time the kernel with CUDA events at the largest and the most frequent
    (cases of the kernel's row); returns the cases, for
    ``add_device_times``."""
    shapes = collections.Counter((args[1].shape[0], args[0].shape[0])
                                 for _, args in calls)
    log(f"sorted_probe launches of {where} by (P, S): "
        f"{sorted(shapes.items())}")
    cases = []
    for shape, which in most(shapes).items():
        sk, pk = next(args for _, args in calls
                      if (args[1].shape[0], args[0].shape[0]) == shape)
        cases.append(probe_case(
            torch, kops, ref, f"{which} of {where} ({shapes[shape]} of "
            f"{len(calls)} launches): P={shape[0]} into S={shape[1]}",
            sk, pk))
    record_rows(torch, rows, "sorted_probe", PROBE_SOURCE,
                "src/repro/kernels/sorted_probe.py:45", cases, device=False)
    return cases


def expand_case(torch, kops, ref, label, cum, match_counts, lo, order,
                capacity):
    """A ``record_rows`` case of join_expand, with ``torch.searchsorted`` of
    the slots in ``cum`` (the row map alone) as the library call.  Its
    least bytes: 18 written a slot (two int64, two flags), and read once
    the cum, lo and match count of each left row a slot lands on (16) and
    the order entry of each distinct matched right row (8); a compare a
    slot."""
    row, ridx, matched, _ = ref.join_expand(cum, match_counts, lo, order,
                                            capacity)
    reached = int(torch.unique(row).numel())
    distinct = int(torch.unique(ridx[matched]).numel())
    del row, ridx, matched
    slots = torch.arange(capacity, dtype=torch.int64, device=cum.device)
    return (label,
            lambda: kops.join_expand(cum, match_counts, lo, order, capacity),
            lambda: ref.join_expand(cum, match_counts, lo, order, capacity),
            lambda: torch.searchsorted(cum, slots, right=True),
            18 * capacity + 16 * reached + 8 * distinct, capacity)


def record_join_expand_calls(torch, kops, ref, rows, calls, where):
    """Log the (slots, left rows) of every join_expand launch ``where``, and
    check and time the kernel with CUDA events at the largest and the most
    frequent (cases of the kernel's row); returns the cases, for
    ``add_device_times``."""
    shapes = collections.Counter((args[4], args[0].shape[0])
                                 for _, args in calls)
    log(f"join_expand launches of {where} by (slots, left rows): "
        f"{sorted(shapes.items())}")
    cases = []
    for shape, which in most(shapes).items():
        args = next(args for _, args in calls
                    if (args[4], args[0].shape[0]) == shape)
        total = int(args[0][-1]) if shape[1] else 0
        cases.append(expand_case(
            torch, kops, ref, f"{which} of {where} ({shapes[shape]} of "
            f"{len(calls)} launches): C={shape[0]} slots from {shape[1]} "
            f"left rows ({total} live)", *args))
    record_rows(torch, rows, "join_expand", PROBE_SOURCE, EXPAND_REPLACES,
                cases, device=False)
    return cases


def check_every_call(torch, kops, ref, calls, where):
    """Every recorded launch of the join kernels ``where`` once more, each
    against its plain version on the same operands, exact: sorted_probe
    against the bisection, join_expand against the scatter and scan of row
    ends (every output, padding slots included), bloom_build against the
    plain bitset, bloom_prune_keys against ``where(plain bloom_probe, keys,
    NULL_KEY)``.  Returns {kernel: launches checked}."""
    checked = {}
    for name, recorded in calls.items():
        for i, (_, args) in enumerate(recorded):
            if name in ("sorted_probe", "join_expand"):
                got = getattr(kops, name)(*args)
                want = getattr(ref, name)(*args)
                err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
            elif name == "bloom_build":
                err = max_abs_err(torch, kops.bloom_build(*args),
                                  ref.bloom_build(*args))
            else:
                bits, keys = args[:2]
                null = torch.full_like(keys, NULL_KEY)
                err = max_abs_err(
                    torch, kops.bloom_prune_keys(*args),
                    torch.where(ref.bloom_probe(bits, keys), keys, null))
            assert err == 0, \
                f"{name} launch {i + 1} of {where}: max_abs_err {err}"
        checked[name] = len(recorded)
    log(f"{where}: every launch against its plain version, exact: {checked}")
    return checked


def add_pair_device_times(torch, rows, pairs):
    """``pair_device_ms`` of ``record_probe_calls``' pairs, beside the
    prune cases' ``device_ms``, and their ratio."""
    row = next(r for r in rows if r["name"] == "bloom_probe")
    for label, pair in pairs:
        case = next(c for c in row["cases"] if c["shape"] == label)
        case["pair_device_ms"], _ = device_time(torch, pair,
                                                "bloom_probe_kernel")
        case["device_over_pair"] = case["device_ms"] / case["pair_device_ms"]
        log(f"  bloom_probe + torch.where [{label}] device "
            f"{case['pair_device_ms']:.4f} ms; bloom_prune_keys / pair "
            f"{case['device_over_pair']:.3f}")


def frontier_case(torch, kops, ref, label, args):
    """A ``record_rows`` case of frontier_expand on one operand (no library
    call computes it), bounded by the bytes any kernel must read for it: a
    flag per edge, a source per valid edge, a destination per valid edge
    from the frontier, and the n bytes of the fill.  ``{live}`` and
    ``{reach}`` in ``label`` become those two edge counts."""
    src, _, valid, front, _, n = args
    e, live = src.shape[0], int(valid.sum())
    gather = src.clamp(0, front.shape[0] - 1).to(torch.int64)
    reach = int((valid & front[gather]).sum())
    return (label.format(live=live, reach=reach),
            functools.partial(kops.frontier_expand, *args),
            functools.partial(ref.frontier_expand, *args), None,
            e + 4 * live + 4 * reach + n, e)


def record_frontier_calls(torch, kops, ref, rows, calls):
    """Check and time frontier_expand with CUDA events on each launch
    recorded in k-hop (cases of the kernel's row); returns the cases."""
    cases = []
    for i, (_, args) in enumerate(calls):
        front = int(args[3].sum())
        label = (f"k-hop launch {i + 1} of {len(calls)}: E={args[0].shape[0]}"
                 f" ({{live}} valid, {{reach}} from a frontier of {front}) "
                 f"V={args[5]}")
        cases.append(frontier_case(torch, kops, ref, label, args))
    record_rows(torch, rows, "frontier_expand", FRONTIER_SOURCE,
                FRONTIER_REPLACES, cases, device=False)
    return cases


def check_kernels(torch, kops, ref, tpcds_np):
    """Phase 3: the join kernels against their plain versions, exact, at
    the edge cases and at ``join_cases``, timed with CUDA events (device
    times later: ``add_device_times``)."""
    import numpy as np

    from repro_torch.kernels.sorted_probe import fence_stride

    dev = torch.device("cuda")
    null = np.int32(2**31 - 1)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    zipf = np.sort(np.minimum(rng.zipf(1.3, 1_000_000), 50_000))
    edge_probe = [
        ("empty probe", t(np.arange(100)), t([])),
        # runs of one key (up to ~250k) far longer than the fence stride
        ("duplicate runs > fence stride", t(zipf),
         t(np.concatenate([rng.permutation(zipf)[:100_000], [0, 50_001]]))),
        ("empty build", t([]), t([-3, 0, 7])),
        ("all NULL", t(np.full(16, null)), t(np.full(7, null))),
        ("NULL tail", t([1, 5, 5, null, null]), t([null, null, 5, 0])),
        ("negative keys", t(np.sort(rng.integers(-1000, 1000, 5000))),
         t(rng.integers(-2**31, 2**31 - 1, 3000))),
    ]
    for name, sk, pk in edge_probe:
        lo, hi = kops.sorted_probe(sk, pk)
        rlo, rhi = ref.sorted_probe(sk, pk)
        err = max(max_abs_err(torch, lo, rlo), max_abs_err(torch, hi, rhi))
        assert err == 0, f"sorted_probe {name}: max_abs_err {err}"
        if name.startswith("duplicate runs"):
            run, stride = int((rhi - rlo).max()), fence_stride(sk.shape[0])
            assert run > stride, f"longest run {run} <= stride {stride}"
            log(f"  sorted_probe [{name}]: longest run {run}, fence stride "
                f"{stride}: exact")
    keys_all_null = t(np.full(1000, null))
    edge_bloom = [
        ("empty", t([]), torch.zeros(0, dtype=torch.bool, device=dev), 256),
        ("all NULL invalid", keys_all_null,
         torch.zeros(1000, dtype=torch.bool, device=dev), 256),
        ("all NULL valid", keys_all_null,
         torch.ones(1000, dtype=torch.bool, device=dev), 16384),
        ("negative keys", t(rng.integers(-2**31, 0, 5000)),
         torch.from_numpy(rng.random(5000) < 0.7).to(dev), 1024),
    ]
    for name, keys, valid, nbits in edge_bloom:
        bits = kops.bloom_build(keys, valid, nbits)
        rbits = ref.bloom_build(keys, valid, nbits)
        err = max_abs_err(torch, bits, rbits)
        assert err == 0, f"bloom_build {name}: max_abs_err {err}"
        probe = torch.cat([keys, t([-5, 0, null])])
        hit = ref.bloom_probe(rbits, probe)
        err = max_abs_err(torch, kops.bloom_probe(bits, probe), hit)
        assert err == 0, f"bloom_probe {name}: max_abs_err {err}"
        err = max_abs_err(torch, kops.bloom_prune_keys(bits, probe),
                          torch.where(hit, probe, t(null)))
        assert err == 0, f"bloom_prune_keys {name}: max_abs_err {err}"
    log("edge cases: sorted_probe", len(edge_probe), "bloom",
        len(edge_bloom), "all exact")

    rows = []
    for name, (source, replaces, cases) in join_cases(
            torch, kops, ref, tpcds_np).items():
        record_rows(torch, rows, name, source, replaces, cases, device=False)
    return rows


def join_cases(torch, kops, ref, tpcds_np):
    """Phase 3's timed cases of the join kernels, {name: (source, replaces,
    cases)} in ``record_rows``' form, on the TPC-DS SF1 key columns."""
    import numpy as np

    dev = torch.device("cuda")
    fact_i = torch.from_numpy(tpcds_np["i_sk"]).to(dev)       # 2.88M
    item_sorted = torch.from_numpy(np.sort(tpcds_np["i_id"])).to(dev)
    fact_sorted = torch.sort(fact_i).values

    nbits = kops.bloom_bits_for(fact_i.shape[0])
    valid = torch.ones(fact_i.shape, dtype=torch.bool, device=dev)
    n = fact_i.shape[0]
    bits = ref.bloom_build(item_sorted, torch.ones_like(item_sorted,
                                                        dtype=torch.bool),
                           nbits)
    return {
        "sorted_probe": (
            PROBE_SOURCE, "src/repro/kernels/sorted_probe.py:45",
            [probe_case(torch, kops, ref,
                        f"P={n} into S={fact_sorted.shape[0]}",
                        fact_sorted, fact_i),
             probe_case(torch, kops, ref,
                        f"P={n} into S={item_sorted.shape[0]}",
                        item_sorted, fact_i)]),
        "bloom_build": (
            BLOOM_SOURCE, BLOOM_REPLACES,
            [bloom_case(kops, ref, f"N={n} ({{live}} valid) bits={nbits}",
                        fact_i, valid, nbits)]),
        "bloom_probe": (
            BLOOM_SOURCE, PROBE_REPLACES,
            [bloom_probe_case(kops, ref, f"N={n} bits={nbits}", bits,
                              fact_i)]),
    }


def spmv_compare(torch, src, dst, valid, x, n, stats):
    """``compare`` for edge_spmv: kernel and plain each within
    ``SPMV_BOUND_FACTOR`` x the recursive-summation bound of a float64 sum
    of the same inputs, per vertex; returns max |kernel - plain|."""
    keep = valid & (dst >= 0) & (dst < n)
    d = dst[keep].to(torch.int64)
    xs = x[src[keep].clamp(0, x.shape[0] - 1).to(torch.int64)].double()
    zero = torch.zeros(n, dtype=torch.float64, device=x.device)
    y64 = zero.clone().index_add_(0, d, xs)
    deg = zero.clone().index_add_(0, d, torch.ones_like(xs))
    absum = zero.clone().index_add_(0, d, xs.abs())
    bound = SPMV_BOUND_FACTOR * deg * 2.0**-24 * absum + 1e-30

    def compare(got, want):
        assert got.dtype == want.dtype == torch.float32
        for who, y in (("kernel", got), ("plain", want)):
            ratio = float(((y.double() - y64).abs() / bound).max()) \
                if n else 0.0
            stats[who] = max(stats.get(who, 0.0), ratio)
            assert ratio <= 1.0, f"edge_spmv {who}: error {ratio} x bound"
        return float((got - want).abs().max()) if n else 0.0
    return compare


def record_spmv(torch, kops, ref, rows, label, src, dst, valid, x, n,
                device=True):
    """Check edge_spmv to its bound on one edge list and time it beside
    gather + ``index_add_``, into the kernel's row."""
    keep = valid & (dst >= 0) & (dst < n)
    s64, d64 = src[keep].to(torch.int64), dst[keep].to(torch.int64)
    e = src.shape[0]
    stats = {}
    row = record_rows(
        torch, rows, "edge_spmv", "src/repro_torch/kernels/csrc/spmv.cu",
        "src/repro/kernels/spmv.py:31",
        [(label, lambda: kops.edge_spmv(src, dst, valid, x, n),
          lambda: ref.edge_spmv(src, dst, valid, x, n),
          lambda: torch.zeros(n, device=x.device).index_add_(0, d64, x[s64]),
          9 * e + 8 * n, e)],
        compare=spmv_compare(torch, src, dst, valid, x, n, stats),
        device=device)
    seen = row.setdefault("error_over_bound", {})
    for who, ratio in stats.items():
        seen[who] = max(seen.get(who, 0.0), ratio)
    log(f"  edge_spmv [{label}] error / bound: {stats}")


def record_min_label(torch, kops, ref, rows, label, src, dst, valid, labels,
                     n, device=True):
    """Check edge_min_label exactly on one edge list and labels, and time
    it beside clone + gather + ``scatter_reduce_``, into the kernel's row."""
    keep = valid & (dst >= 0) & (dst < n)
    s64, d64 = src[keep].to(torch.int64), dst[keep].to(torch.int64)
    e = src.shape[0]
    record_rows(
        torch, rows, "edge_min_label",
        "src/repro_torch/kernels/csrc/label_prop.cu",
        "src/repro/kernels/label_prop.py:33",
        [(label, lambda: kops.edge_min_label(src, dst, valid, labels, n),
          lambda: ref.edge_min_label(src, dst, valid, labels, n),
          lambda: labels[:n].clone().scatter_reduce_(0, d64, labels[s64],
                                                     "amin"),
          9 * e + 8 * n, e)], device=device)


def check_scatter_table(torch, kops, ref, n, n_edges):
    """Edge cases aimed at the shared-memory table of edge_spmv and
    edge_min_label, at n vertices and n_edges edges: kernel and plain
    within the spmv bound, min-label exactly equal at the first and second
    step."""
    import numpy as np

    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    _, per_block = _build.scatter_grid(
        n_edges, torch.cuda.get_device_properties(dev).multi_processor_count)
    keys = np.arange(n, dtype=np.int64)
    home = (keys * TABLE_HASH & 0xFFFFFFFF) >> (32 - TABLE_SLOT_BITS)
    colliding = keys[home == home[-1]]
    stride = np.arange(n_edges, dtype=np.int64) * 7919 % n
    cases = [
        ("every edge into one vertex", np.full(n_edges, n - 1)),
        ("more distinct dst in a block's range than table slots", stride),
        (f"{colliding.size} dst of one home slot, past the probe bound",
         rng.choice(colliding, n_edges)),
        ("dst runs longer than a block's range",
         np.arange(n_edges) // (4 * per_block)),
    ]
    assert np.unique(stride[:per_block]).size > 2**TABLE_SLOT_BITS
    assert colliding.size > TABLE_MAX_PROBE

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype=dtype)).to(dev)

    src = t(rng.integers(0, n, n_edges), np.int32)
    valid = t(rng.random(n_edges) < 0.95, bool)
    x = t(rng.random(n) / n, np.float32)
    for name, dst_np in cases:
        dst = t(dst_np, np.int32)
        stats = {}
        spmv_compare(torch, src, dst, valid, x, n, stats)(
            kops.edge_spmv(src, dst, valid, x, n),
            ref.edge_spmv(src, dst, valid, x, n))
        labels = t(rng.permutation(n), np.int32)
        for step in (1, 2):
            got = kops.edge_min_label(src, dst, valid, labels, n)
            labels = ref.edge_min_label(src, dst, valid, labels, n)
            assert torch.equal(got, labels), \
                f"edge_min_label [{name}] step {step} != plain"
        log(f"  [{name}]: edge_spmv error / bound {stats}; edge_min_label "
            f"steps 1-2 exact")
    log(f"edge cases: scatter table {len(cases)} at E={n_edges} V={n}, "
        f"{per_block} edges a block")


def check_graph_kernels(torch, kops, ref, csr):
    """Phase 3, graph kernels (at the start of phase 6): each against its
    plain version at the edge cases and at ``oj_graph_specs``, exact, spmv
    to its bound; timed with CUDA events (device times later)."""
    import numpy as np

    dev = csr.device
    rng = np.random.default_rng(1)

    def t(a, dtype=None):
        return torch.from_numpy(np.asarray(a, dtype=dtype)).to(dev)

    # edge cases: empty, all invalid, one vertex with a self-loop and a
    # padding slot, -1 destinations on valid slots
    dst_neg = rng.integers(0, 50, 300)
    dst_neg[rng.random(300) < 0.3] = -1
    edge_cases = [
        ("empty", t([], np.int32), t([], np.int32), t([], bool), 5),
        ("all invalid", t(rng.integers(0, 8, 16), np.int32),
         t(rng.integers(0, 8, 16), np.int32), t(np.zeros(16, bool)), 8),
        ("n=1 self-loop + padding", t([0, 0], np.int32), t([0, 0], np.int32),
         t([True, False]), 1),
        ("dst=-1 slots", t(rng.integers(0, 50, 300), np.int32),
         t(dst_neg, np.int32), t(rng.random(300) < 0.9), 50),
    ]
    for name, s, d, v, n in edge_cases:
        lab = t(rng.permutation(n), np.int32)
        front = t(rng.random(n) < 0.5)
        seen = t(rng.random(n) < 0.3)
        x = t(rng.integers(-4, 5, n), np.float32)   # exact float32 sums
        pairs = [
            (kops.segment_counts(d, v, n), ref.segment_counts(d, v, n)),
            (kops.segment_counts(s, v, n), ref.segment_counts(s, v, n)),
            (kops.edge_spmv(s, d, v, x, n), ref.edge_spmv(s, d, v, x, n)),
            (kops.edge_min_label(s, d, v, lab, n),
             ref.edge_min_label(s, d, v, lab, n)),
            (kops.frontier_expand(s, d, v, front, seen, n),
             ref.frontier_expand(s, d, v, front, seen, n)),
        ]
        for got, want in pairs:
            assert got.dtype == want.dtype and torch.equal(got, want), name
    log("edge cases: graph kernels", len(edge_cases), "all exact")
    check_scatter_table(torch, kops, ref, csr.num_vertices,
                        csr.coo("Buy")[0].shape[0])
    rows = []
    record_specs(torch, kops, ref, rows, oj_graph_specs(torch, ref, csr),
                 device=False)
    return rows


def oj_graph_specs(torch, ref, csr):
    """The graph kernels' timed operands on the JS-OJ CSR: [(kernel,
    label, args)], ``args`` as the kernel's wrapper takes them."""
    import numpy as np

    dev, n = csr.device, csr.num_vertices
    sb, db, vb = csr.coo("Buy")                   # PageRank's label
    sa, da, va = csr.coo()                        # k-hop, degree stats
    ss, ds, vs = csr.coo(symmetric=True)          # WCC
    e_b, e_a, e_s = sb.shape[0], sa.shape[0], ss.shape[0]
    x = torch.from_numpy(np.random.default_rng(1).random(n).astype(
        np.float32) / n).to(dev)
    lab = torch.arange(n, dtype=torch.int32, device=dev)
    front = torch.zeros(n, dtype=torch.bool, device=dev)
    front[:KHOP_SEEDS] = True
    label = f"E={e_s} (symmetric) V={n}"
    return [
        ("segment_counts", f"Buy sources, CSR order: E={e_b} "
         f"({int(vb.sum())} valid) into V={n}", (sb, vb, n)),
        ("edge_spmv", f"E={e_b} V={n}", (sb, db, vb, x, n)),
        ("edge_min_label", label, (ss, ds, vs, lab, n)),
        # the labels WCC's second to last launches see
        ("edge_min_label", f"{label}, labels after one step",
         (ss, ds, vs, ref.edge_min_label(ss, ds, vs, lab, n), n)),
        ("frontier_expand", f"E={e_a} V={n} frontier={KHOP_SEEDS}",
         (sa, da, va, front, front.clone(), n)),
    ]


def mv_graph_specs(torch, ref, csr):
    """``oj_graph_specs`` on the JS-MV CSR: edge_spmv on PageRank's edges,
    edge_min_label on WCC's (first step and second)."""
    import numpy as np

    dev, n = csr.device, csr.num_vertices
    src, dst, valid = csr.coo()                   # PageRank's edges
    x = torch.from_numpy(np.random.default_rng(7).random(n).astype(
        np.float32) / n).to(dev)
    ss, ds, vs = csr.coo(symmetric=True)          # WCC's edges
    lab = torch.arange(n, dtype=torch.int32, device=dev)
    label = f"JS-MV E={ss.shape[0]} (symmetric) V={n}"
    return [
        ("edge_spmv", f"JS-MV E={src.shape[0]} V={n}",
         (src, dst, valid, x, n)),
        ("edge_min_label", label, (ss, ds, vs, lab, n)),
        ("edge_min_label", f"{label}, labels after one step",
         (ss, ds, vs, ref.edge_min_label(ss, ds, vs, lab, n), n)),
    ]


def record_specs(torch, kops, ref, rows, specs, device):
    """Check and time each (kernel, label, args) of ``specs`` into
    ``rows`` (``record_rows``; ``device`` as there)."""
    for kernel, label, args in specs:
        if kernel == "segment_counts":
            record_rows(torch, rows, kernel, SEGMENT_SOURCE,
                        SEGMENT_REPLACES,
                        [segment_case(torch, kops, ref, label, *args)],
                        device=device)
        elif kernel == "edge_spmv":
            record_spmv(torch, kops, ref, rows, label, *args, device=device)
        elif kernel == "edge_min_label":
            record_min_label(torch, kops, ref, rows, label, *args,
                             device=device)
        else:
            record_rows(torch, rows, kernel, FRONTIER_SOURCE,
                        FRONTIER_REPLACES,
                        [frontier_case(torch, kops, ref, label, args)],
                        device=device)


def add_spec_device_times(torch, kops, rows, specs):
    """``add_device_times`` for the cases ``record_specs(..., device=False)``
    recorded, on ``specs`` rebuilt alike."""
    for kernel, label, args in specs:
        add_device_times(torch, rows, kernel, [
            (label, functools.partial(getattr(kops, kernel), *args))])


def digest_s(graph) -> float:
    """Seconds of one content digest of ``graph``'s tables (what every
    ``analyze`` pays to look its CSR up), on a fresh, unmemoized copy."""
    from repro_torch.core.extract import ExtractedGraph

    fresh = ExtractedGraph(vertices=dict(graph.vertices),
                           edges=dict(graph.edges))
    t0 = time.perf_counter()
    fp = fresh.fingerprint()
    seconds = time.perf_counter() - t0
    assert fp == graph.fingerprint()
    return seconds


def pagerank_error(got, want) -> dict:
    """L1 distance and max relative error of one rank vector to another."""
    diff = (got.double() - want.double()).abs()
    return {"l1": float(diff.sum()),
            "max_rel": float((diff / want.double().abs()).max())}


def pagerank_tolerance(ref, csr, label=None) -> float:
    """``D_max * 2**-24``: the relative recursive-summation bound of one
    float32 sum over the largest in-degree of the edges PageRank runs on."""
    _, dst, valid = csr.coo(label)
    d_max = int(ref.segment_counts(dst.clamp_min(0), valid,
                                   csr.num_vertices).max())
    return d_max * 2.0**-24


def check_pagerank(err: dict, tol: float, what: str) -> None:
    err["tolerance"] = tol
    assert err["l1"] <= tol and err["max_rel"] <= tol, \
        f"{what}: {err} beyond L1 / max_rel {tol}"


def replay(torch, kops, names, counts, fn):
    """Run ``fn`` (a path) once more, untimed, with the wrappers ``names``
    recorded: (its result, {name: recorded calls}).  The replay must launch
    every kernel as often as the timed run whose ``counts`` are given, so
    the recorded operands are the ones that run's launches saw."""
    kops.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        calls = {n: stack.enter_context(recording(kops, n)) for n in names}
        out = fn()
        torch.cuda.synchronize()
    again = kops.launch_counts()
    assert again == counts, f"replay launched {again}, the timed run {counts}"
    return out, calls


def extract_twice(engine, model):
    """The extraction paths (phases 4-5): a cold request, then a warm one."""
    return engine.extract(model), engine.extract(model)


def drive(torch, kops, engine, model, label):
    """Cold then warm extract between a counter reset and a counter read."""
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    cold, warm = extract_twice(engine, model)
    counts = kops.launch_counts()
    missing = [k for k in JOIN_KERNELS if counts[k] == 0]
    assert not missing, f"{label}: kernels never launched: {missing}"
    rows = {lab: int(t.valid.sum()) for lab, t in cold.edges.items()}
    assert rows == {lab: int(t.valid.sum()) for lab, t in warm.edges.items()}
    assert cold.graph.fingerprint() == warm.graph.fingerprint()
    log(f"{label}: rows {rows}")
    log(f"{label}: extract_s cold {cold.timings.extract_s:.4f} warm "
        f"{warm.timings.extract_s:.4f}; plan_s cold "
        f"{cold.timings.plan_s:.4f} warm {warm.timings.plan_s:.4f}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
        f"{counts}")
    return cold, warm, counts, rows


def analyze_oj(kops, engine, model):
    """Phase 6's requests: PageRank on Buy cold then warm, WCC, k-hop and
    degree statistics; also the launches WCC took."""
    import numpy as np

    cold = engine.analyze(model, algorithm="pagerank", label="Buy",
                          iters=PR_ITERS)
    warm = engine.analyze(model, algorithm="pagerank", label="Buy",
                          iters=PR_ITERS)
    before = kops.launch_counts()["edge_min_label"]
    wcc = engine.analyze(model, algorithm="wcc")
    wcc_iters = kops.launch_counts()["edge_min_label"] - before
    khop = engine.analyze(model, algorithm="khop",
                          seeds=np.arange(KHOP_SEEDS), k=KHOP_K)
    deg = engine.analyze(model, algorithm="degree_stats")
    return cold, warm, wcc, khop, deg, wcc_iters


def analyze_mv(engine, model):
    """Phase 7's requests: PageRank, then WCC."""
    return (engine.analyze(model, algorithm="pagerank", iters=PR_ITERS),
            engine.analyze(model, algorithm="wcc"))


def analytics_oj(torch, kops, ref, ExtractionEngine, db, model, graph):
    """Phase 6: the graph kernels checked and timed with CUDA events
    (their rows, device times later), then engine.analyze on the JS-OJ
    graph, timed, against numpy and the plain CSR build."""
    import numpy as np

    from repro_torch.graph import algorithms as talg
    from repro_torch.graph import build_csr
    from repro_torch.graph import reference as gref

    t0 = time.perf_counter()
    plain_csr = build_csr(graph, model, use_kernel=False)
    torch.cuda.synchronize()
    log(f"JS-OJ graph: plain CSR build {time.perf_counter() - t0:.4f} s, "
        f"V={plain_csr.num_vertices} E={plain_csr.edge_counts}")
    log("graph kernels vs plain, CUDA-event times:")
    rows = check_graph_kernels(torch, kops, ref, plain_csr)

    engine = ExtractionEngine(db)
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    cold, warm, wcc, khop, deg, wcc_iters = analyze_oj(kops, engine, model)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in GRAPH_KERNELS if counts[k] == 0]
    assert not missing, f"JS-OJ analytics: kernels never launched: {missing}"
    assert not cold.provenance.csr_cache_hit
    assert warm.provenance.csr_cache_hit, "warm analyze rebuilt the CSR"
    assert warm.provenance.extraction.plan_cache_hit
    for r in (wcc, khop, deg):
        assert r.provenance.csr_cache_hit and r.csr is cold.csr

    csr = cold.csr
    assert csr.num_vertices == plain_csr.num_vertices
    same = [torch.equal(csr.vertex_ids, plain_csr.vertex_ids)]
    for field in ("offsets", "targets", "sources"):
        got, want = getattr(csr, field), getattr(plain_csr, field)
        same += [set(got) == set(want)]
        same += [torch.equal(got[k], want[k]) for k in want]
    assert all(same), "kernel-built CSR != plain build"

    n = csr.num_vertices
    sb, db, vb = [a.cpu().numpy() for a in csr.coo("Buy")]
    sa, da, va = [a.cpu().numpy() for a in csr.coo()]
    t0 = time.perf_counter()
    pr_np = gref.pagerank_np(sb, db, vb, n, iters=PR_ITERS)
    wcc_np = gref.wcc_np(sa, da, va, n)
    seeds = np.zeros(n, bool)
    seeds[:KHOP_SEEDS] = True
    khop_np = gref.khop_np(sa, da, va, seeds, n, k=KHOP_K)
    deg_np = gref.degree_stats_np(sa, da, va, n)
    numpy_s = time.perf_counter() - t0
    pr_tol = pagerank_tolerance(ref, csr, "Buy")
    pr_truth = torch.from_numpy(pr_np).to(csr.device)
    pr_err = pagerank_error(warm.values, pr_truth)
    check_pagerank(pr_err, pr_tol, "JS-OJ PageRank (kernels) vs numpy")
    plain_pr = talg.pagerank(csr, label="Buy", iters=PR_ITERS,
                             use_kernel=False)
    plain_err = pagerank_error(plain_pr, pr_truth)
    check_pagerank(plain_err, pr_tol, "JS-OJ PageRank (plain) vs numpy")
    assert np.array_equal(wcc.values.cpu().numpy(), wcc_np), "WCC != numpy"
    assert np.array_equal(khop.values.cpu().numpy(), khop_np), "k-hop != numpy"
    for key in ("out_degree", "in_degree"):
        assert np.array_equal(deg.values[key].cpu().numpy(), deg_np[key]), key
    for key in ("num_edges", "max_out_degree", "max_in_degree", "isolated"):
        assert int(deg.values[key]) == deg_np[key], key
    # float32 quotient against numpy's float64 one
    assert abs(float(deg.values["mean_degree"]) - deg_np["mean_degree"]) \
        <= 1e-6 * deg_np["mean_degree"]

    timing = {
        "V": n, "E": int(sum(csr.edge_counts.values())),
        "csr_build_s_cold": cold.timings.csr_build_s,
        "csr_build_s_warm": warm.timings.csr_build_s,
        "extract_s_cold": cold.timings.extract_s,
        "extract_s_warm": warm.timings.extract_s,
        "analyze_s": {"pagerank_cold": cold.timings.analyze_s,
                      "pagerank_warm": warm.timings.analyze_s,
                      "wcc": wcc.timings.analyze_s,
                      "khop": khop.timings.analyze_s,
                      "degree_stats": deg.timings.analyze_s},
        "graph_digest_s": digest_s(cold.extraction.graph),
        "wcc_iterations": wcc_iters, "pagerank_vs_numpy": pr_err,
        "plain_pagerank_vs_numpy": plain_err,
        "max_memory_allocated_gib": peak / 2**30, "launches": counts}
    log(f"JS-OJ analytics: {json.dumps(timing)}")
    log(f"  WCC components {len(np.unique(wcc_np))}, k-hop reached "
        f"{int((khop_np >= 0).sum())}; CSR (kernel) == plain build; "
        f"WCC, k-hop, degrees == numpy (numpy took {numpy_s:.2f} s); "
        f"PageRank L1 {pr_err['l1']:.3e} (plain {plain_err['l1']:.3e}), "
        f"max_rel {pr_err['max_rel']:.3e} (plain {plain_err['max_rel']:.3e})"
        f" <= {pr_tol:.3e}")
    return rows, counts, timing


def analytics_mv(torch, kops, ref, ExtractionEngine, db, model, rows):
    """Phase 7: PageRank and WCC on the JS-MV graph, timed, kernels vs the
    plain path on the same CSR; then edge_spmv and edge_min_label checked
    and timed with CUDA events on its edge lists (cases added to their
    ``rows``, device times later)."""
    from repro_torch.graph import algorithms as talg

    engine = ExtractionEngine(db)
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    pr, wcc = analyze_mv(engine, model)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in ("segment_counts", "edge_spmv", "edge_min_label")
               if counts[k] == 0]
    assert not missing, f"JS-MV analytics: kernels never launched: {missing}"
    assert wcc.provenance.csr_cache_hit

    csr = pr.csr
    t0 = time.perf_counter()
    plain_pr = talg.pagerank(csr, iters=PR_ITERS, use_kernel=False)
    torch.cuda.synchronize()
    plain_pr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_wcc = talg.wcc(csr, use_kernel=False)
    torch.cuda.synchronize()
    plain_wcc_s = time.perf_counter() - t0
    assert torch.equal(wcc.values, plain_wcc), "JS-MV WCC != plain path"
    pr_err = pagerank_error(pr.values, plain_pr)
    check_pagerank(pr_err, pagerank_tolerance(ref, csr),
                   "JS-MV PageRank vs plain path")
    timing = {
        "V": csr.num_vertices, "E": int(sum(csr.edge_counts.values())),
        "csr_build_s_cold": pr.timings.csr_build_s,
        "csr_build_s_warm": wcc.timings.csr_build_s,
        "graph_digest_s": digest_s(pr.extraction.graph),
        "extract_s_cold": pr.timings.extract_s,
        "extract_s_warm": wcc.timings.extract_s,
        "analyze_s": {"pagerank": pr.timings.analyze_s,
                      "wcc": wcc.timings.analyze_s,
                      "pagerank_plain": plain_pr_s,
                      "wcc_plain": plain_wcc_s},
        "pagerank_vs_plain": pr_err,
        "max_memory_allocated_gib": peak / 2**30, "launches": counts}
    log(f"JS-MV analytics: {json.dumps(timing)}")
    log(f"  WCC == plain path; PageRank L1 {pr_err['l1']:.3e}, max_rel "
        f"{pr_err['max_rel']:.3e} <= {pr_err['tolerance']:.3e}")
    log("JS-MV graph kernels vs plain, CUDA-event times:")
    record_specs(torch, kops, ref, rows, mv_graph_specs(torch, ref, csr),
                 device=False)
    return counts, timing


def attended_pairs(sq: int, sk: int, causal: bool, window,
                   q_offset: int = 0) -> int:
    """(i, j) pairs the flash kernel's masks keep: j < sk, p >= j when
    causal, p - j < window, for the position p = i + q_offset."""
    import numpy as np

    i = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(i + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def flash_compare(torch):
    """``compare`` for flash_attention: bf16 outputs within rtol = atol =
    FLASH_TOL of the plain version; returns max |kernel - plain|."""
    def compare(got, want):
        assert got.dtype == want.dtype == torch.bfloat16
        assert got.shape == want.shape
        assert bool(torch.isfinite(got.float()).all()), "non-finite output"
        diff = (got.float() - want.float()).abs()
        bad = diff > FLASH_TOL + FLASH_TOL * want.float().abs()
        assert not bool(bad.any()), \
            f"flash_attention: {int(bad.sum())} outputs beyond {FLASH_TOL}"
        return float(diff.max()) if diff.numel() else 0.0
    return compare


FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:32"


def flash_qkv(torch, gen, b, sq, sk, hq, hkv, dh):
    """Random bf16 (B, S, H, Dh) q, k, v on the card from ``gen``."""
    dev = torch.device("cuda")
    return [torch.randn((b, s, h, dh), generator=gen, device=dev)
            .to(torch.bfloat16) for s, h in ((sq, hq), (sk, hkv), (sk, hkv))]


def check_flash_kernel(torch, kops, ref):
    """Phase 8a: flash_attention against its plain version in bf16, at the
    edge cases and at ``flash_cases`` (timed with CUDA events; device times
    later: ``add_device_times``)."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(8)
    compare = flash_compare(torch)
    edge = [  # (B, Sq, Sk, Hq, Hkv, Dh, causal, window)
        ("S 1", (1, 1, 1, 2, 1, 64), True, None),
        ("S 200, Dh 32", (2, 200, 200, 4, 2, 32), True, None),
        ("non-causal", (1, 256, 256, 4, 2, 128), False, None),
        ("window 64, Dh 16", (1, 300, 300, 4, 4, 16), True, 64),
        ("MQA, S 333", (1, 333, 333, 8, 1, 64), True, None),
        ("Sk > Sq", (1, 64, 300, 2, 1, 64), False, None),
        ("S 200, Dh 120, window 64", (1, 200, 200, 4, 2, 120), True, 64),
        # 32 key tiles of 128: the K/V ring of shared memory wraps many times
        ("ring wrap, S 4096, Dh 128", (1, 4096, 4096, 2, 1, 128), True, None),
    ]
    for name, shape, causal, window in edge:
        q, k, v = flash_qkv(torch, gen, *shape)
        compare(kops.flash_attention(q, k, v, causal=causal, window=window),
                ref.flash_attention(q, k, v, causal=causal, window=window))
    log(f"edge cases: flash_attention {len(edge)} within {FLASH_TOL}")
    rows = []
    record_rows(torch, rows, "flash_attention", FLASH_SOURCE, FLASH_REPLACES,
                flash_cases(torch, kops, ref), compare=compare, device=False)
    torch.cuda.empty_cache()
    return rows


def flash_cases(torch, kops, ref):
    """The LM path's flash_attention shapes in ``record_rows``' form, on
    inputs from one seeded generator (the same on every call)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)

    def case(label, b, s, hq, hkv, dh, window, sq=None, causal=True,
             q_offset=0):
        sq = s if sq is None else sq           # s is Sk
        q, k, v = flash_qkv(torch, gen, b, sq, s, hq, hkv, dh)
        # the library yardstick: (B, H, S, Dh) copies with K/V expanded to
        # Hq heads, prepared outside the timing; a window or an offset
        # needs a mask
        qt, kt, vt = (x.transpose(1, 2).repeat_interleave(hq // x.shape[2],
                                                          dim=1).contiguous()
                      for x in (q, k, v))
        mask = None
        if window is not None or q_offset:
            i = torch.arange(sq, device=dev)[:, None] + q_offset
            j = torch.arange(s, device=dev)[None, :]
            mask = i >= j
            if window is not None:
                mask = mask & (i - j < window)

        def library():
            if mask is None:
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        pairs = attended_pairs(sq, s, causal, window, q_offset)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        return (label,
                lambda: kops.flash_attention(q, k, v, causal=causal,
                                             window=window,
                                             q_offset=q_offset),
                lambda: ref.flash_attention(q, k, v, causal=causal,
                                            window=window,
                                            q_offset=q_offset),
                library, nbytes, 4 * b * hq * dh * pairs, BF16_FLOPS_PER_S)

    return [case(f"{LM_ARCH} prefill B 4 S 2048 16/2 Dh 128 causal",
                 4, 2048, 16, 2, 128, None),
            case("gemma-2b B 1 S 2048 8/1 Dh 256 causal",
                 1, 2048, 8, 1, 256, None),
            case("h2o-danube-3-4b B 1 S 8192 32/8 Dh 120 window 4096",
                 1, 8192, 32, 8, 120, 4096),
            # phase 8c's shapes (the MoE, recurrent and enc-dec families)
            case("seamless encoder B 4 S 1536 16/16 Dh 64 non-causal",
                 4, 1536, 16, 16, 64, None, causal=False),
            case("seamless cross-attention B 4 Sq 256 Sk 1536 16/16 Dh 64 "
                 "non-causal", 4, 1536, 16, 16, 64, None, sq=256,
                 causal=False),
            case("recurrentgemma B 4 S 2048 16/1 Dh 256 window 2048",
                 4, 2048, 16, 1, 256, 2048),
            case("qwen3-moe B 4 S 2048 64/4 Dh 128 causal",
                 4, 2048, 64, 4, 128, None),
            case("llama4-scout B 4 S 2048 40/8 Dh 128 causal",
                 4, 2048, 40, 8, 128, None),
            # phase 15's: a qwen2.5-3b rank at model 2 and 4, and the
            # last internvl2-1b sequence-parallel rank of 4 (its 512 rows
            # at positions 1,536-2,047 against the 2,048 gathered keys)
            case(f"{LM_ARCH} model 2 rank B 4 S 2048 8/1 Dh 128 causal",
                 4, 2048, 8, 1, 128, None),
            case(f"{LM_ARCH} model 4 rank B 4 S 2048 4/1 Dh 128 causal",
                 4, 2048, 4, 1, 128, None),
            # phase 15d's: a recurrentgemma-9b rank at model 2
            case("recurrentgemma model 2 rank B 4 S 2048 8/1 Dh 256 window "
                 "2048", 4, 2048, 8, 1, 256, 2048),
            case("internvl2-1b seq-par rank 3 of 4 B 4 Sq 512 Sk 2048 14/2 "
                 "Dh 64 causal offset 1536", 4, 2048, 14, 2, 64, None,
                 sq=512, q_offset=1536)]


def serve_lm(torch, kops):
    """Phase 8b: qwen2.5-3b at full width: prefill + greedy decode through
    the flash kernel, then the plain attention path on the same inputs."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"LM: {cfg.name} layers {cfg.num_layers} d_model {cfg.d_model} "
        f"vocab {cfg.vocab_size}: {n_params} parameters (bf16 weights) in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens}
    max_len = LM_PROMPT + LM_STEPS

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    (logits, cache), prefill_s = timed(
        lambda: prefill(params, cfg, batch, max_len))
    prefill_launches = kops.launch_counts()["flash_attention"]
    first_logits = logits
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step_logits = []

    def decode():
        nonlocal cache, tok
        for _ in range(LM_STEPS):
            out, cache = decode_step(params, cfg, cache, tok)
            step_logits.append(out)
            tok = torch.argmax(out, dim=-1).to(torch.int32)

    _, decode_s = timed(decode)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert prefill_launches == cfg.num_layers, \
        f"flash_attention launched {prefill_launches} times in the prefill"
    assert counts["flash_attention"] == cfg.num_layers, \
        "decode steps launched the flash kernel"
    for out in [first_logits] + step_logits:
        assert out.shape == (LM_BATCH, cfg.vocab_size)
        assert out.dtype == torch.float32
        assert bool(torch.isfinite(out).all()), "non-finite logits"
    assert int(cache["pos"]) == LM_PROMPT + LM_STEPS
    first_tok = torch.argmax(first_logits, dim=-1).to(torch.int32)
    first_step = step_logits[0]
    del cache
    # for phase 15: the prompt, every logit row and the greedy tokens fed
    outputs = {"tokens": tokens.cpu(),
               "logits": [x.cpu() for x in [first_logits] + step_logits],
               "fed": [torch.argmax(x, dim=-1).to(torch.int32).cpu()
                       for x in [first_logits] + step_logits[:-1]]}

    # the same prefill and first decode step on the plain attention path
    (plain_logits, plain_cache), plain_prefill_s = timed(
        lambda: prefill(params, cfg, batch, max_len, use_kernel=False))
    plain_step, _ = decode_step(params, cfg, plain_cache, first_tok)
    del plain_cache
    _, warm_prefill_s = timed(lambda: prefill(params, cfg, batch, max_len))
    agree = {}
    for what, got, want in (("prefill", first_logits, plain_logits),
                            ("step 1", first_step, plain_step)):
        rel = float((got - want).abs().max() / want.std())
        same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        agree[what] = {"max_abs_over_std": rel, "argmax_agreement": same}
        assert rel <= LM_REL_TOL, \
            f"LM {what}: kernel vs plain {rel:.4f} x std > {LM_REL_TOL}"
    timing = {
        "arch": cfg.name, "batch": LM_BATCH, "prompt": LM_PROMPT,
        "decode_steps": LM_STEPS, "prefill_s": prefill_s,
        "prefill_s_warm": warm_prefill_s,
        "plain_prefill_s": plain_prefill_s,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
        "decode_ms_per_step": decode_s / LM_STEPS * 1e3,
        "decode_tokens_per_s": LM_BATCH * LM_STEPS / decode_s,
        "max_memory_allocated_gib": peak / 2**30,
        "kernel_vs_plain": agree, "launches": counts}
    log(f"LM serve: {json.dumps(timing)}")
    return counts, timing, outputs


def named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf, paths joined with '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def decode_weight_bytes(params, cfg, routes):
    """(bound bytes, bytes the step's code reads) of the parameters one
    decode step must read: every decoder weight once, the head (the tied
    embedding in full, else the head and B embedding rows); not the
    encoder, nor cross-attention's wk/wv (their keys and values are
    cached).  MoE experts: the bound counts the distinct experts this run's
    tokens chose in each layer and step (``routes``: the (B, k) choices of
    every MoE call, step by step), averaged over the steps; the static
    capacity dispatch reads all of them."""
    tied = "head" not in params
    bound = reads = 0
    for path, t in named_leaves(params):
        nbytes = t.numel() * t.element_size()
        name = path.rsplit("/", 1)[-1]
        if path.startswith(("encoder/", "patch_proj")) or \
                path.endswith(("xattn/wk", "xattn/wv")):
            continue
        if path == "embed" and not tied:
            nbytes = LM_BATCH * t.shape[1] * t.element_size()
        if cfg.moe is not None and "/ffn/" in path and \
                name in ("w_gate", "w_up", "w_down"):
            reads += nbytes
            continue
        bound += nbytes
        reads += nbytes
    if cfg.moe is not None:
        per_expert = 3 * cfg.d_model * cfg.moe.d_expert * 2      # bf16
        chosen = sum(int(r.unique().numel()) for r in routes)
        bound += per_expert * chosen / LM_STEPS
    return bound, reads


def recurrent_states(cache):
    """(path, tensor) of the recurrent states phase 15d/e compares: every
    RG-LRU and sLSTM state, every mLSTM ``n``, and the mLSTM memory ``c``
    of the first slot of the cycle (each slot's is 100 MB at xlstm-1.3b's
    width)."""
    for path, t in named_leaves(cache):
        name = path.rsplit("/", 1)[-1]
        if name not in ("h", "conv", "c", "n", "m"):
            continue
        if name == "c" and t.dim() == 5 and "/s0_" not in path:
            continue
        yield path, t


def serve_family(torch, kops, arch, layers, prompt):
    """Phase 8c, one model: ``prefill`` of LM_BATCH prompts through the
    flash kernel, LM_STEPS greedy decode steps, a warm prefill; then the
    prefill and the first (teacher-forced) decode step on the plain
    attention path, held to LM_REL_TOL x std(logits).  Returns (launch
    counts, a record, and for ``TP_RECURRENT`` the outputs phase 15d/e
    compares with: the prompt, the logit rows of the prefill and the first
    ``TP_STEPS`` steps, the greedy tokens fed to those, the recurrent
    states after the prefill and after those steps, the peak memory)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.moe import recording_routes, route_changes

    dev = torch.device("cuda")
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(
        full, num_layers=layers)
    t_start = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"LM family: {cfg.name} layers {cfg.num_layers} "
        f"{cfg.layer_kinds()[:3]}... d_model {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} Dh {cfg.head_dim} vocab "
        f"{cfg.vocab_size}: {n_params} parameters in "
        f"{time.perf_counter() - t_start:.2f} s")
    if layers is not None:
        log(f"  depth cut: num_layers {full.num_layers} -> {layers} "
            f"(the whole model's ~{full.n_params() * 2 / 1e9:.0f} GB of "
            f"bf16 does not fit one 80 GB card; widths unchanged)")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, prompt)).astype(np.int32)).to(dev)}
    if cfg.frontend == "frames":
        batch["frames"] = torch.from_numpy(rng.normal(size=(
            LM_BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        ).to(dev)
    max_len = prompt + LM_STEPS
    n_attn = sum(k in ("attn", "swa") for k in cfg.layer_kinds())
    n_enc = cfg.encoder.num_layers if cfg.encoder is not None else 0
    flash_calls = n_attn + n_enc + (n_attn if n_enc else 0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    with recording_routes() as prefill_routes:
        (logits, cache), prefill_s = timed(
            lambda: prefill(params, cfg, batch, max_len))
    prefill_launches = kops.launch_counts()["flash_attention"]
    keep = arch in TP_RECURRENT and layers is None
    if keep:
        states_prefill = {p: t.to("cpu", copy=True)   # decode writes
                          for p, t in recurrent_states(cache)}   # in place
    first_logits = logits
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step_logits = []

    def decode(steps):
        nonlocal cache, tok
        for _ in range(steps):
            out, cache = decode_step(params, cfg, cache, tok)
            step_logits.append(out)
            tok = torch.argmax(out, dim=-1).to(torch.int32)

    # timed in two parts: phase 15d/e's states after TP_STEPS steps are
    # copied out between them
    with recording_routes() as decode_routes:
        _, decode_s = timed(lambda: decode(TP_STEPS))
        if keep:
            states_steps = {p: t.to("cpu", copy=True)
                            for p, t in recurrent_states(cache)}
        _, rest_s = timed(lambda: decode(LM_STEPS - TP_STEPS))
    decode_s += rest_s
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert prefill_launches == flash_calls, \
        f"{cfg.name}: flash_attention launched {prefill_launches} times in " \
        f"the prefill, want {flash_calls}"
    assert counts["flash_attention"] == flash_calls, \
        f"{cfg.name}: decode steps launched the flash kernel"
    for out in [first_logits] + step_logits:
        assert out.shape == (LM_BATCH, cfg.vocab_size)
        assert out.dtype == torch.float32
        assert bool(torch.isfinite(out).all()), f"{cfg.name}: non-finite"
    assert int(cache["pos"]) == prompt + LM_STEPS
    first_tok = torch.argmax(first_logits, dim=-1).to(torch.int32)
    first_step = step_logits[0]
    outputs = None
    if keep:          # for phase 15d/e
        rows = [first_logits] + step_logits[:TP_STEPS]
        outputs = {
            "tokens": batch["tokens"].cpu(),
            "logits": [x.cpu() for x in rows],
            "fed": [torch.argmax(x, dim=-1).to(torch.int32).cpu()
                    for x in rows[:-1]],
            "states_prefill": states_prefill,
            "states_steps": states_steps,
            "peak_gib": peak / 2**30}
    del cache
    out, warm_prefill_s = timed(lambda: prefill(params, cfg, batch,
                                                max_len))
    del out
    if keep:    # the model's own sensitivity: one weight moved by an ulp
        kind = cfg.block_pattern[0]
        mixer = params["cycles"][f"s0_{kind}"][kind]
        w = mixer["w_out" if "w_out" in mixer else "w_o"]
        saved = w[0, 0, 0].clone()
        w[0, 0, 0] = (saved.float() * (1 + 2.0**-7)).to(w.dtype)
        nudged, ncache = prefill(params, cfg, batch, max_len)
        w[0, 0, 0] = saved
        outputs["nudged_weight_prefill"] = dict(
            lm_agreement(torch, nudged, first_logits),
            states=state_agreement(torch, dict(recurrent_states(ncache)),
                                   states_prefill, f"{cfg.name} nudged"))
        del nudged, ncache
    bound_bytes, read_bytes = decode_weight_bytes(params, cfg,
                                                  decode_routes)
    timing = {
        "arch": cfg.name, "layers": cfg.num_layers,
        "full_layers": full.num_layers, "parameters": n_params,
        "batch": LM_BATCH, "prompt": prompt, "decode_steps": LM_STEPS,
        "prefill_s": prefill_s, "prefill_s_warm": warm_prefill_s,
        "prefill_tokens_per_s": LM_BATCH * prompt / warm_prefill_s,
        "decode_ms_per_step": decode_s / LM_STEPS * 1e3,
        "decode_tokens_per_s": LM_BATCH * LM_STEPS / decode_s,
        "decode_weight_bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
        "decode_weight_bound_bytes": bound_bytes,
        "decode_weight_read_bytes": read_bytes,
        "max_memory_allocated_gib": peak / 2**30,
        "flash_launches": counts["flash_attention"]}
    if keep:
        timing["nudged_weight_prefill"] = outputs["nudged_weight_prefill"]
    if flash_calls:
        # the same prefill and first decode step on the plain attention
        with recording_routes() as plain_routes:
            (plain_logits, plain_cache), plain_prefill_s = timed(
                lambda: prefill(params, cfg, batch, max_len,
                                use_kernel=False))
        if keep:
            timing["kernel_vs_plain_states"] = check_states(
                state_agreement(torch, dict(recurrent_states(plain_cache)),
                                states_prefill, f"{cfg.name} plain"),
                None, cfg.name, every=False)
        with recording_routes() as plain_step_routes:
            plain_step, _ = decode_step(params, cfg, plain_cache, first_tok)
        del plain_cache
        timing["plain_prefill_s"] = plain_prefill_s
        rows = {w: torch.ones(LM_BATCH, dtype=torch.bool, device=dev)
                for w in ("prefill", "step 1")}
        if cfg.moe is not None:
            # bf16 differences in the attention output move the fp32
            # router logits; at a near tie a token takes another expert and
            # its output moves by O(1), so the gate holds the positions
            # whose routing agreed in every layer (the prefill's last, the
            # teacher-forced step's)
            changed, agree = route_changes(prefill_routes, plain_routes)
            n_moe = len(plain_step_routes)
            step_changed, step_agree = route_changes(
                decode_routes[:n_moe], plain_step_routes)
            rows["prefill"] = agree.reshape(LM_BATCH, prompt)[:, -1]
            rows["step 1"] = step_agree
            timing["routing_changes"] = {
                "prefill_per_layer": changed, "step_1_per_layer":
                step_changed, "choices_per_layer": agree.numel()
                * cfg.moe.top_k,
                "gated_rows": {w: int(r.sum()) for w, r in rows.items()}}
        agree_out = {}
        for what, got, want in (("prefill", first_logits, plain_logits),
                                ("step 1", first_step, plain_step)):
            r = rows[what]
            assert bool(r.any()), f"{cfg.name} {what}: no row to compare"
            rel_all = float((got - want).abs().max() / want.std())
            rel = float((got[r] - want[r]).abs().max() / want.std())
            same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            agree_out[what] = {"max_abs_over_std": rel,
                               "max_abs_over_std_all_rows": rel_all,
                               "argmax_agreement": same}
            assert rel <= LM_REL_TOL, \
                f"{cfg.name} {what}: kernel vs plain {rel:.4f} x std > " \
                f"{LM_REL_TOL}"
        timing["kernel_vs_plain"] = agree_out
    else:
        log(f"  {cfg.name} has no attention: no flash launch, no "
            "kernel-vs-plain comparison")
    timing["model_s"] = time.perf_counter() - t_start
    log(f"LM family serve: {json.dumps(timing)}")
    del params, first_logits, step_logits
    return counts, timing, outputs


def serve_families(torch, kops):
    """Phase 8c: the MoE, recurrent and encoder-decoder families at full
    width on one card, one after another (each freed before the next).
    Returns (launch counts by path, records, {arch: outputs} of
    ``TP_RECURRENT``)."""
    counts, timings, outputs = {}, [], {}
    for arch, layers, prompt in LM_FAMILIES:
        c, t, out = serve_family(torch, kops, arch, layers, prompt)
        counts[f"lm_serve_{arch}"] = c
        timings.append(t)
        if out is not None:
            outputs[arch] = out
        torch.cuda.empty_cache()
    return counts, timings, outputs


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, the
    recompute not counted): 6 N T for the weights, and 6 L S Hq Dh T for
    causal attention's two products (half the S x S pairs, times 2 FLOPs
    a multiply-add, times 3 for forward and backward)."""
    tokens = batch * seq
    return 6.0 * n_params * tokens + 6.0 * cfg.num_layers * seq * \
        cfg.num_heads * cfg.head_dim * tokens


def train_lm(torch, kops):
    """Phase 12: the data plane feeds the compute plane.  The port extracts
    make_dblp(scale=TRAIN_DBLP_SCALE) and builds its CSR on the card (the
    join kernels and ``segment_counts``), ``GraphWalkPipeline`` turns the
    Co-auth CSR into token batches, and qwen2.5-3b at its published width
    takes AdamW steps with ``remat`` (the plain attention, as the JAX
    package's ``forward``: no flash kernel launches).  One warm-up step on
    the pipeline's batch 0, TRAIN_FRESH steps on fresh batches (their
    losses and the share of their labels that earlier batches held are
    printed: a fresh batch of walks hardly repeats the tokens of the
    batches before it, so a few steps need not lower its loss), then
    TRAIN_TIMED timed steps (host clock, each ending in a synchronize),
    each on the pipeline's batch 1: the loss must fall over them, which
    shows that the step learns.  Every step is timed and printed.
    Then the same step twice from the same parameters and batch; then the
    trained parameters serve a prompt from the pipeline through the flash
    kernel.  Returns ({path: launch counts}, a record)."""
    import numpy as np

    from repro_torch.api import ExtractionEngine
    from repro_torch.configs import get_config
    from repro_torch.data import dblp_model, make_dblp
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.training.data import GraphWalkPipeline
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import (TrainStepConfig,
                                                 make_train_step)
    from repro_torch.training.tree import leaves

    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    counts = {}

    # the data plane: extraction and the CSR on the card
    t0 = time.perf_counter()
    db = make_dblp(scale=TRAIN_DBLP_SCALE)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    csr = ExtractionEngine(db).extract(dblp_model()).graph_view(
        use_kernel=True)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    counts["lm_train_data"] = kops.launch_counts()
    missing = [k for k in JOIN_KERNELS + ("segment_counts",)
               if counts["lm_train_data"][k] == 0]
    assert not missing, f"train data plane: never launched {missing}"
    assert csr.num_vertices <= cfg.vocab_size, \
        f"{csr.num_vertices} vertices > vocabulary {cfg.vocab_size}"
    pipe = GraphWalkPipeline(csr=csr, label="Co-auth", batch=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size)
    log(f"LM train data: make_dblp(scale={TRAIN_DBLP_SCALE}) {make_s:.2f} s;"
        f" extract + CSR {data_s:.2f} s: {csr.num_vertices} vertices "
        f"(vocabulary {cfg.vocab_size}), {csr.edge_counts}; launches "
        f"{counts['lm_train_data']}")
    del db, csr
    torch.cuda.empty_cache()

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(i).items()}

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt = AdamW()
    state = opt.init(params)
    n_params = sum(p.numel() for p in leaves(params))
    step_fn = make_train_step(cfg, opt, TrainStepConfig(microbatches=1,
                                                        remat=True))
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    # batch 0 warms up, batches 2.. are fresh, batch 1 is taken
    # TRAIN_TIMED times
    order = [0] + list(range(2, 2 + TRAIN_FRESH)) + [1] * TRAIN_TIMED
    seen, losses, step_ms, fresh = set(), [], [], []
    for n, i in enumerate(order):
        host_batch = pipe.batch_at(i)
        labels = host_batch["labels"].ravel()
        repeats = float(np.isin(labels, list(seen)).mean()) if seen else 0.0
        seen.update(labels.tolist())
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        what = ("warm-up" if n == 0 else "fresh" if n <= TRAIN_FRESH
                else "timed")
        if what == "fresh":
            fresh.append({"batch": i, "loss": loss,
                          "labels_seen_before": repeats})
        log(f"  train step {n} ({what}, batch {i}): loss {loss:.6f}, "
            f"{step_ms[-1]:.1f} ms; labels seen in earlier batches "
            f"{repeats:.4f}")
    peak = torch.cuda.max_memory_allocated()
    counts["lm_train"] = kops.launch_counts()
    assert all(np.isfinite(losses)), f"non-finite loss: {losses}"
    timed_losses = losses[-TRAIN_TIMED:]
    assert timed_losses[-1] < timed_losses[0], \
        f"loss did not fall over the timed steps: {timed_losses}"
    assert counts["lm_train"]["flash_attention"] == 0, \
        "the train step launched the flash kernel"

    # the same step twice from the same parameters and batch
    batch = batch_at(2 + TRAIN_FRESH)
    saved = [p.clone() for p in leaves(params)]
    params, state, metrics = step_fn(params, state, batch)
    first = float(metrics["loss"])
    for p, s in zip(leaves(params), saved):
        p.copy_(s)
    del saved
    params, state, metrics = step_fn(params, state, batch)
    again = float(metrics["loss"])
    assert np.isfinite(first) and abs(again - first) <= \
        TRAIN_REPEAT_RTOL * abs(first), \
        f"the same step gave losses {first!r} and {again!r}"
    timed = step_ms[-TRAIN_TIMED:]
    mean_ms = sum(timed) / len(timed)
    record = {
        "arch": cfg.name, "params": n_params, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "remat": True, "optimizer": "AdamW",
        "losses": losses, "warmup_ms": step_ms[0],
        "fresh_ms": step_ms[1:1 + TRAIN_FRESH], "fresh": fresh,
        "step_ms": timed,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (mean_ms / 1e3),
        "model_flops": flops, "bound_ms": bound_ms,
        "share_of_bound": bound_ms / mean_ms,
        "max_memory_allocated_gib": peak / 2**30,
        "repeat_losses": [first, again]}
    log(f"LM train: {cfg.name} {n_params} parameters, B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ}, remat, AdamW: steps {[round(t, 1) for t in timed]} "
        f"ms (mean {mean_ms:.1f}), {record['tokens_per_s']:.0f} tokens/s, "
        f"bound {bound_ms:.1f} ms ({flops:.3e} model FLOPs at 989 TFLOP/s):"
        f" {record['share_of_bound']:.3f} of it; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; losses {losses}; the same step twice "
        f"{first!r} {again!r}")
    del state
    torch.cuda.empty_cache()

    # serve what was trained: a prompt from the pipeline, flash kernel on
    prompt = batch_at(3 + TRAIN_FRESH)
    kops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, {"tokens": prompt["tokens"]},
                            TRAIN_SEQ + TRAIN_SERVE_STEPS)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    outs = [logits]
    for _ in range(TRAIN_SERVE_STEPS):
        logits, cache = decode_step(params, cfg, cache, tok)
        outs.append(logits)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts["lm_train_serve"] = kops.launch_counts()
    assert counts["lm_train_serve"]["flash_attention"] == cfg.num_layers, \
        f"the prefill launched {counts['lm_train_serve']} kernels"
    for out in outs:
        assert out.shape == (TRAIN_BATCH, cfg.vocab_size)
        assert bool(torch.isfinite(out).all()), "non-finite served logits"
    assert int(cache["pos"]) == TRAIN_SEQ + TRAIN_SERVE_STEPS
    record["serve_s"] = serve_s
    log(f"LM train -> serve: prefill {TRAIN_BATCH} x {TRAIN_SEQ} + "
        f"{TRAIN_SERVE_STEPS} decode steps of the trained parameters in "
        f"{serve_s:.3f} s; launches {counts['lm_train_serve']}")
    del params, cache, outs
    torch.cuda.empty_cache()
    return counts, record


TRACE_BUCKETS = (("float32 GEMM (the plain attention's einsums)",
                  ("gemm_f32f32",)),
                 ("bf16 GEMM", ("gemm", "xmma", "nvjet", "cutlass")),
                 ("softmax", ("softmax",)),
                 ("reductions", ("reduce",)),
                 ("elementwise and copies", ("elementwise", "vectorized",
                                             "copy", "fill", "memcpy",
                                             "memset", "cat", "index",
                                             "gather", "scatter")))


def profile_train_step(torch):
    """Phase 12's step once more, under ``torch.profiler``, after every
    other timing (a profiler session slows the host's later launches):
    qwen2.5-3b, B 2 x S 2,048 of seeded tokens, remat, AdamW, after one
    warm-up step.  Logs the step's wall ms, the device time the profiler
    records (busy share = device ms / wall ms), the device time in buckets
    by kernel name, and the ten kernels that take the most."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import (TrainStepConfig,
                                                 make_train_step)

    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt = AdamW()
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, TrainStepConfig(remat=True))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    batch = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
             for k, v in batch.items()}
    params, state, _ = step_fn(params, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert np.isfinite(float(metrics["loss"]))
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(ms for _, ms, _ in kernels)
    assert device_ms > 0, "the profiler recorded no device time"
    buckets = collections.Counter()
    for key, ms, _ in kernels:
        name = key.lower()
        bucket = next((b for b, pats in TRACE_BUCKETS
                       if any(p in name for p in pats)), "other")
        buckets[bucket] += ms
    record = {"wall_ms": wall_ms, "device_ms": device_ms,
              "busy_share": device_ms / wall_ms,
              "buckets_ms": dict(buckets.most_common()),
              "top": [(key[:80], ms, n) for key, ms, n in
                      sorted(kernels, key=lambda k: -k[1])[:10]]}
    log(f"LM train step traced: {json.dumps(record)}")
    del params, state
    torch.cuda.empty_cache()
    return record


def recovery_drill(torch):
    """Phase 12, smoke size: ``run_with_recovery`` with a failure at step
    RECOVERY_FAIL, checkpoints every RECOVERY_EVERY steps, against a clean
    run: losses after the restart and the final parameters to rtol 1e-4
    (``tests/test_fault_tolerance.py``).  Checkpoints go to a temporary
    directory that is removed."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.training.data import TokenPipeline
    from repro_torch.training.trainer import (FailureInjector,
                                              TrainerConfig, run_training,
                                              run_with_recovery)
    from repro_torch.training.tree import leaves

    cfg = get_smoke_config(TRAIN_ARCH)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=16,
                         seed=3)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        clean = run_training(cfg, TrainerConfig(
            steps=RECOVERY_STEPS, ckpt_every=RECOVERY_EVERY,
            ckpt_dir=f"{tmp}/clean"), pipe)
        rec = run_with_recovery(cfg, TrainerConfig(
            steps=RECOVERY_STEPS, ckpt_every=RECOVERY_EVERY,
            ckpt_dir=f"{tmp}/failed"), pipe,
            FailureInjector(fail_at_step=RECOVERY_FAIL))
        drill_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert rec["restarts"] == 1
    resumed = RECOVERY_FAIL - RECOVERY_FAIL % RECOVERY_EVERY
    for step in range(resumed, RECOVERY_STEPS):
        np.testing.assert_allclose(rec["losses_by_step"][step],
                                   clean["losses"][step], rtol=1e-4,
                                   err_msg=f"step {step} after recovery")
    for a, b in zip(leaves(clean["final_params"]),
                    leaves(rec["final_params"])):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), rtol=1e-4)
    log(f"LM train recovery ({cfg.name}): failure at step {RECOVERY_FAIL}, "
        f"restart from step {resumed}; losses after it and final "
        f"parameters == the clean run's (rtol 1e-4); {drill_s:.2f} s for "
        f"both runs")
    return {"drill_s": drill_s, "restarts": rec["restarts"]}


@contextlib.contextmanager
def fold_timer():
    """Sums the seconds of the engine's host fold (``apply_table_delta``,
    edges and views) while it is active; ``{"s": seconds, "calls": n}``."""
    import repro_torch.api.engine as eng

    fold = eng.apply_table_delta
    acc = {"s": 0.0, "calls": 0}

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fold(*args, **kwargs)
        acc["s"] += time.perf_counter() - t0
        acc["calls"] += 1
        return out

    eng.apply_table_delta = timed
    try:
        yield acc
    finally:
        eng.apply_table_delta = fold


def graph_digests(graph) -> dict:
    """Every vertex and edge table's bag digest."""
    return {"vertices": digests(graph.vertices), "edges": digests(graph.edges)}


def fresh_graph(ExtractionEngine, Database, db, model):
    """A from-scratch extraction over ``db``'s current tables on the plain
    path: a new database (exact ANALYZE) and a new engine whose compiler
    launches no kernel, so no kernel's fault can reach the reference."""
    from repro_torch.core.pipeline import PipelineCompiler

    engine = ExtractionEngine(Database(dict(db.tables)),
                              compiler=PipelineCompiler(use_kernel=False,
                                                        use_bloom=False))
    return engine, engine.extract(model)


def check_coo(torch, got, want, what):
    """Every edge label's live (src, dst) multiset of CSR ``got`` equal to
    ``want``'s, on the same vertex numbering; {label: live edges}."""
    assert got.num_vertices == want.num_vertices and torch.equal(
        got.vertex_ids, want.vertex_ids), f"{what}: vertices differ"
    assert sorted(got.targets) == sorted(want.targets), what
    n, live = got.num_vertices, {}
    for label in sorted(want.targets):
        bags = []
        for csr in (got, want):
            src, dst, valid = csr.coo(label)
            bags.append(torch.sort(src[valid].to(torch.int64) * n
                                   + dst[valid].to(torch.int64)).values)
        assert torch.equal(*bags), f"{what}: {label} edges differ"
        live[label] = bags[0].numel()
    return live


def churn_sales(db, rng, n_ins, n_del):
    """Insert ``n_ins`` store_sales rows (new rids, foreign keys drawn over
    the dimensions) and delete ``n_del`` live rows by slot."""
    import numpy as np

    if n_ins:
        n = int(db.tables["store_sales"]["rid"].max()) + 1
        draw = {c: db.stats[t].rows for c, t in (
            ("c_sk", "customer"), ("i_sk", "item"), ("p_sk", "promotion"),
            ("o_sk", "outlet_store"))}
        db.insert_rows("store_sales",
                       rid=np.arange(n, n + n_ins, dtype=np.int32),
                       **{c: rng.integers(0, k, n_ins).astype(np.int32)
                          for c, k in draw.items()})
    if n_del:
        live = np.flatnonzero(db.tables["store_sales"].valid.cpu().numpy())
        db.delete_rows("store_sales", rng.choice(live, n_del, replace=False))


def mutate_oj(db, rng, rnd):
    """Phase 9(a)'s churn before delta round ``rnd``: 1, store_sales rows
    in and out; 2, new items that no sale references."""
    import numpy as np

    if rnd == 1:
        churn_sales(db, rng, REFRESH_INSERT, REFRESH_DELETE)
        return
    n_item = int(db.tables["item"]["rid"].max()) + 1
    ids = np.arange(n_item, n_item + ITEM_INSERT, dtype=np.int32)
    db.insert_rows("item", rid=ids, i_id=ids,
                   i_price=rng.integers(1, 100, ITEM_INSERT).astype(np.int32))


def mutate_mv(db, rng):
    """Phase 9(b)'s churn: wrote rows in and out."""
    import numpy as np

    n = int(db.tables["wrote"]["rid"].max()) + 1
    db.insert_rows(
        "wrote", rid=np.arange(n, n + MV_INSERT, dtype=np.int32),
        a_sk=rng.integers(0, db.stats["author"].rows,
                          MV_INSERT).astype(np.int32),
        p_sk=rng.integers(0, db.stats["paper"].rows,
                          MV_INSERT).astype(np.int32))
    live = np.flatnonzero(db.tables["wrote"].valid.cpu().numpy())
    db.delete_rows("wrote", rng.choice(live, MV_DELETE, replace=False))


def analyze_patched(engine, model):
    """Phase 9(a)'s requests on the patched CSR after round 1: PageRank on
    Buy, then WCC, each after a refresh that must be a noop."""
    return (engine.analyze(model, algorithm="pagerank", label="Buy",
                           iters=PR_ITERS, auto_refresh=True),
            engine.analyze(model, algorithm="wcc", auto_refresh=True))


def refresh_round(torch, kops, engine, model, expect, label):
    """One ``engine.refresh`` between a counter reset and a counter read,
    timed on the host clock ending in a device sync; the path must be
    ``expect``.  Returns (result, launches, record)."""
    from repro_torch import obs

    terms0 = obs.REGISTRY.value("delta_terms_total")
    with fold_timer() as fold:
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        res = engine.refresh(model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kops.launch_counts()
    rp = res.refresh
    assert rp.path == expect, f"{label}: path {rp.path}, expected {expect}"
    record = {"path": rp.path, "churn": rp.churn,
              "rows_changed": rp.rows_changed,
              "tables_changed": list(rp.tables_changed),
              "views_maintained": list(rp.views_maintained),
              "csr_patched": rp.csr_patched,
              "extract_s": res.timings.extract_s, "refresh_s": wall,
              "fold_s": fold["s"], "fold_calls": fold["calls"],
              "delta_terms": obs.REGISTRY.value("delta_terms_total") - terms0,
              "launches": {k: v for k, v in counts.items() if v}}
    if rp.path == "delta":
        missing = [k for k in JOIN_KERNELS if counts[k] == 0]
        assert not missing, f"{label}: kernels never launched: {missing}"
    return res, counts, record


def check_fresh(ExtractionEngine, Database, db, model, res, label):
    """The refreshed graph's digests against a from-scratch extraction;
    returns the fresh engine (its CSR cache is cold)."""
    engine, fresh = fresh_graph(ExtractionEngine, Database, db, model)
    got, want = graph_digests(res.graph), graph_digests(fresh.graph)
    assert got == want, f"{label}: refreshed digests {got} != fresh {want}"
    return engine


def refresh_oj(torch, kops, ref, ExtractionEngine, Database, wal_dir):
    """Phase 9(a) and (c): JS-OJ refresh rounds on a database with a WAL in
    ``wal_dir``, then recovery.  Returns (launches summed over the rounds,
    the launches of rounds 1 and 2, record)."""
    import numpy as np

    from repro_torch.data import fraud_model, make_tpcds
    from repro_torch.durability import (load_manifest, recover_database,
                                        replay_wal, restore_database,
                                        write_manifest)
    from repro_torch.relational.ops import table_digest

    model = fraud_model("store")
    db = make_tpcds(sf=TPCDS_SF)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ExtractionEngine(db)
    cold, warm = extract_twice(engine, model)
    engine.analyze(model, algorithm="pagerank", label="Buy", iters=PR_ITERS)
    assert len(engine._csrs) == 1
    db.attach_wal(str(wal_dir))
    rng = np.random.default_rng(OJ_SEED)
    rounds, total, delta_counts = {}, collections.Counter(), []

    # round 1: 1% in, 0.5% out: the delta path, the cached CSR patched
    mutate_oj(db, rng, 1)
    res, counts, rec = refresh_round(torch, kops, engine, model, "delta",
                                     "JS-OJ round 1")
    assert rec["csr_patched"], "JS-OJ round 1 did not patch the CSR"
    total.update(counts)
    delta_counts.append(counts)
    fresh_engine = check_fresh(ExtractionEngine, Database, db, model, res,
                               "JS-OJ round 1")
    pr, wcc = analyze_patched(engine, model)
    assert pr.extraction.refresh.path == "noop"
    assert pr.provenance.csr_cache_hit, "the patched CSR did not serve"
    assert wcc.provenance.csr_cache_hit
    # the reference: a CSR built from the fresh extraction, and PageRank
    # and WCC on it, all on the plain path
    want = fresh_engine.analyze(model, algorithm="pagerank", label="Buy",
                                iters=PR_ITERS, use_kernel=False)
    rec["patched_live_edges"] = check_coo(
        torch, pr.csr, want.csr, "the patched CSR vs a fresh build")
    err = pagerank_error(pr.values, want.values)
    check_pagerank(err, pagerank_tolerance(ref, want.csr, "Buy"),
                   "PageRank on the patched CSR vs a fresh build")
    assert torch.equal(wcc.values, fresh_engine.analyze(
        model, algorithm="wcc", use_kernel=False).values), \
        "WCC on the patched CSR != fresh"
    rec["patched_labels_dirty"] = sorted(pr.csr.dirty)
    rec["pagerank_vs_fresh"] = err
    rounds["1_delta_csr_patched"] = rec
    del fresh_engine, want, pr, wcc

    # round 2: new items, no sale references them: the vertex set changes
    mutate_oj(db, rng, 2)
    res, counts, rec = refresh_round(torch, kops, engine, model, "delta",
                                     "JS-OJ round 2")
    assert not rec["csr_patched"], "round 2 changed the vertex set"
    total.update(counts)
    delta_counts.append(counts)
    check_fresh(ExtractionEngine, Database, db, model, res, "JS-OJ round 2")
    rounds["2_delta_vertices"] = rec
    t0 = time.perf_counter()
    write_manifest(str(wal_dir), db, {}, {"fraud": res.graph.fingerprint()})
    manifest_s = time.perf_counter() - t0

    # round 3: 15% out (or more, so that churn > threshold): the full path
    base = sum(db.stats[t].rows for t in
               {r.table for q in model.queries() for r in q.relations})
    n_del = max(FULL_DELETE, base // 11 + 1)
    churn_sales(db, rng, 0, n_del)
    res, counts, rec = refresh_round(torch, kops, engine, model, "full",
                                     "JS-OJ round 3")
    assert rec["churn"] > engine.refresh_threshold
    rec["deleted"] = n_del
    total.update(counts)
    check_fresh(ExtractionEngine, Database, db, model, res, "JS-OJ round 3")
    rounds["3_full"] = rec

    # round 4: nothing changed: noop
    res, counts, rec = refresh_round(torch, kops, engine, model, "noop",
                                     "JS-OJ round 4")
    total.update(counts)
    check_fresh(ExtractionEngine, Database, db, model, res, "JS-OJ round 4")
    rounds["4_noop"] = rec
    peak = torch.cuda.max_memory_allocated()
    final_fp = res.graph.fingerprint()

    # (c) crash: the WAL abandoned; recover from the manifest + its tail
    db.detach_wal()
    t0 = time.perf_counter()
    recovered, report = recover_database(str(wal_dir), Database(),
                                         device=db.device)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    assert report.path == "checkpoint" and report.replayed_records == 1
    assert recovered.epoch == db.epoch
    assert recovered.fingerprint() == db.fingerprint(), "stats differ"
    for t in db.tables:
        assert recovered.tables[t].capacity == db.tables[t].capacity, t
        assert table_digest(recovered.tables[t]) == \
            table_digest(db.tables[t]), f"recovered {t} differs"
    got = ExtractionEngine(recovered).extract(model).graph.fingerprint()
    assert got == final_fp, "the recovered database extracts another graph"
    t0 = time.perf_counter()
    again = restore_database(str(wal_dir), load_manifest(str(wal_dir)),
                             device=db.device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay_wal(again, str(wal_dir))
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    assert again.fingerprint() == db.fingerprint()
    wal_bytes = sum(f.stat().st_size for f in wal_dir.iterdir())
    record = {"extract_s_cold": cold.timings.extract_s,
              "extract_s_warm": warm.timings.extract_s, "rounds": rounds,
              "max_memory_allocated_gib": peak / 2**30,
              "durability": {"manifest_s": manifest_s,
                             "recovery_s": recovery_s,
                             "restore_s": restore_s, "replay_s": replay_s,
                             "report": report.summary(),
                             "dir_bytes": wal_bytes}}
    log(f"JS-OJ refresh: {json.dumps(record)}")
    log("  every round's digests == a plain-path fresh extract; the patched "
        "CSR's edges, PageRank and WCC == a fresh plain build's; recovered "
        "fingerprint, digests and graph == the live database's")
    return dict(total), delta_counts, record


def refresh_mv(torch, kops, ExtractionEngine, Database):
    """Phase 9(b): one JS-MV refresh through the maintained view."""
    import numpy as np

    from repro_torch.data import dblp_model, make_dblp

    model = dblp_model()
    db = make_dblp(scale=DBLP_SCALE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ExtractionEngine(db)
    cold, warm = extract_twice(engine, model)
    assert cold.provenance.views_built
    mutate_mv(db, np.random.default_rng(MV_SEED))
    res, counts, rec = refresh_round(torch, kops, engine, model, "delta",
                                     "JS-MV")
    assert list(cold.provenance.views_built) == rec["views_maintained"], \
        f"JS-MV maintained {rec['views_maintained']}"
    peak = torch.cuda.max_memory_allocated()
    check_fresh(ExtractionEngine, Database, db, model, res, "JS-MV")
    record = {"extract_s_cold": cold.timings.extract_s,
              "extract_s_warm": warm.timings.extract_s, "round": rec,
              "max_memory_allocated_gib": peak / 2**30}
    log(f"JS-MV refresh: {json.dumps(record)}")
    log("  digests == a plain-path fresh extract")
    return counts, record


def refresh_and_recovery(torch, kops, ref, ExtractionEngine):
    """Phase 9: refresh rounds on JS-OJ (a) and JS-MV (b), and the WAL and
    its recovery on JS-OJ's database (c).  Returns the launches of each
    path's refreshes, and of JS-OJ's two delta rounds one by one."""
    import shutil
    import tempfile

    from repro_torch.core.database import Database

    wal_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_wal_"))
    try:
        counts_oj, delta_counts, _ = refresh_oj(
            torch, kops, ref, ExtractionEngine, Database, wal_dir)
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    counts_mv, _ = refresh_mv(torch, kops, ExtractionEngine, Database)
    torch.cuda.empty_cache()
    return counts_oj, counts_mv, delta_counts


def replay_refresh(torch, kops, ExtractionEngine, counts_oj, counts_mv):
    """Phase 9's delta refreshes once more, untimed, on regenerated data
    with the same seeded churn and the same requests between them, the
    join wrappers recorded (``replay``: each refresh must launch every
    kernel as often as its timed run).  {"JS-OJ" / "JS-MV": {name: calls}}.
    """
    import numpy as np

    from repro_torch.data import dblp_model, fraud_model, make_dblp, make_tpcds

    names = ("sorted_probe", "join_expand", "bloom_build",
             "bloom_prune_keys")
    out = {"JS-OJ": collections.defaultdict(list)}
    model = fraud_model("store")
    db = make_tpcds(sf=TPCDS_SF)
    engine = ExtractionEngine(db)
    extract_twice(engine, model)
    engine.analyze(model, algorithm="pagerank", label="Buy", iters=PR_ITERS)
    rng = np.random.default_rng(OJ_SEED)
    for rnd, counts in enumerate(counts_oj, 1):
        mutate_oj(db, rng, rnd)
        _, calls = replay(torch, kops, names, counts,
                          lambda: engine.refresh(model))
        for name, recorded in calls.items():
            out["JS-OJ"][name] += recorded
        if rnd == 1:
            analyze_patched(engine, model)
    del engine, db
    model = dblp_model()
    db = make_dblp(scale=DBLP_SCALE)
    engine = ExtractionEngine(db)
    extract_twice(engine, model)
    mutate_mv(db, np.random.default_rng(MV_SEED))
    _, out["JS-MV"] = replay(torch, kops, names, counts_mv,
                             lambda: engine.refresh(model))
    return out


def anonymized(dataset, size):
    """Phase 10's input: ``dataset`` at ``size`` on the card, columns
    renamed ``col<j>``; (database, mapping, truth models, hand queries)."""
    from discovery_summary import make_dataset
    from repro_torch.discovery import anonymize_columns

    db, truth, hand = make_dataset("repro_torch", dataset, size)
    adb, mapping = anonymize_columns(db)
    return adb, mapping, truth, hand


def cold_discover(ExtractionEngine, db):
    """Phase 10's first request on a new engine: (engine, result)."""
    engine = ExtractionEngine(db)
    return engine, engine.discover(use_name_hints=False)


def discovery_view(res):
    """What phase 10 holds the kernel path to the plain path on: every
    profile's NDV / non-null / null fraction, every candidate's (pair,
    sampled, matched, confidence), the accepted FKs, the edge candidates'
    signatures."""
    return {
        "profiles": {(t, c): (p.ndv, p.non_null, p.null_frac)
                     for t, tp in res.profiles.items()
                     for c, p in tp.columns.items()},
        "candidates": [(c.pair(), c.sampled, c.matched, c.confidence)
                       for c in res.candidates],
        "fks": [c.pair() for c in res.fks],
        "edges": [repr(e.signature) for e in res.edges]}


def discovery_phase(torch, kops, ExtractionEngine):
    """Phase 10: ``engine.discover(use_name_hints=False)`` cold then warm on
    anonymized JS-OJ and JS-MV data, against the plain path and the JAX
    package's constants.  Returns ({path: launches}, {path: record})."""
    import numpy as np

    from discovery_summary import summary
    from repro_torch.core.pipeline import PipelineCompiler

    counts, records = {}, {}
    for dataset, size, path in DISCOVERY_SIZES:
        adb, mapping, truth, hand = anonymized(dataset, size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        engine, cold = cold_discover(ExtractionEngine, adb)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts[path] = kops.launch_counts()
        pipe = engine.compiler.cache_info()
        t0 = time.perf_counter()
        warm = engine.discover(use_name_hints=False)
        warm_s = time.perf_counter() - t0
        label = f"{path} {dataset} {size}"
        assert warm is cold, f"{label}: the warm call missed the cache"
        assert engine.compiler.cache_info() == pipe and \
            kops.launch_counts() == counts[path], \
            f"{label}: the warm call ran a pipeline"
        missing = [k for k in JOIN_KERNELS if counts[path][k] == 0]
        assert not missing, f"{label}: kernels never launched: {missing}"
        peak = torch.cuda.max_memory_allocated()
        plain = ExtractionEngine(adb, compiler=PipelineCompiler(
            use_kernel=False, use_bloom=False)).discover(use_name_hints=False)
        assert discovery_view(cold) == discovery_view(plain), \
            f"{label}: the kernel path's discovery != the plain path's"
        got = summary("repro_torch", cold, adb, mapping, truth, hand)
        want = DISCOVERY_REF[dataset]
        assert got["data_sha1"] == want["data_sha1"], \
            f"{label}: numpy {np.__version__} generated other tables than " \
            f"those DISCOVERY_REF was written for"
        assert got == want, f"{label}: {got} != the JAX package's {want}"
        t = cold.timings
        records[path] = {
            "discover_s_cold": cold_s, "discover_s_warm": warm_s,
            # profiled by the engine (its cache), each table timed alone
            "profile_s": sum(p.profile_s for p in cold.profiles.values()),
            "infer_s": t["infer_s"],
            "synthesize_s": t["synthesize_s"],
            "checks_per_s": cold.stats["containment_checks"] / t["infer_s"],
            "executable_misses": cold.stats["executable_misses"],
            "max_memory_allocated_gib": peak / 2**30,
            "launches": {k: v for k, v in counts[path].items() if v},
            **got}
        log(f"discovery {label}: {json.dumps(records[path])}")
        log("  == the plain path (profiles, candidates, FKs, edges) and the "
            "JAX package's counts, quality and digests; warm: a cache hit, "
            "no pipeline")
        del engine, cold, warm, plain, adb
        torch.cuda.empty_cache()
    return counts, records


def replay_discovery(torch, kops, ExtractionEngine, counts):
    """Phase 10's cold discoveries once more, untimed, on regenerated data,
    the join wrappers recorded (``replay``).  {path: {name: calls}}."""
    names = ("sorted_probe", "join_expand", "bloom_build",
             "bloom_prune_keys")
    out = {}
    for dataset, size, path in DISCOVERY_SIZES:
        adb = anonymized(dataset, size)[0]
        _, out[path] = replay(torch, kops, names, counts[path],
                              lambda: cold_discover(ExtractionEngine, adb))
        del adb
    return out


def http(url, payload=None, tenant=None):
    """(status, headers, JSON body) of one request to the front end."""
    import urllib.error
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data,
                                 headers={"X-Tenant": tenant} if tenant
                                 else {})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def timed(fn):
    """(fn(), seconds on the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def wait_until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never became true"
        time.sleep(0.005)


def payload_view(p):
    """What an extract payload says of the graph: its epoch, fingerprint
    and vertex and edge counts (not how the request was served)."""
    return {k: p[k] for k in ("kind", "model", "method", "epoch",
                              "fingerprint", "vertices", "edges")}


def churn_request(db, rng):
    """Phase 9's round-1 churn as one ``mutate``: REFRESH_INSERT new
    store_sales rows and a mask of REFRESH_DELETE live rows."""
    import numpy as np

    t = db.tables["store_sales"]
    n = int(t["rid"].max()) + 1
    insert = {"rid": np.arange(n, n + REFRESH_INSERT, dtype=np.int32),
              **{c: rng.integers(0, db.stats[d].rows,
                                 REFRESH_INSERT).astype(np.int32)
                 for c, d in (("c_sk", "customer"), ("i_sk", "item"),
                              ("p_sk", "promotion"),
                              ("o_sk", "outlet_store"))}}
    live = np.flatnonzero(t.valid.cpu().numpy())
    mask = np.zeros(t.capacity, dtype=bool)
    mask[rng.choice(live, REFRESH_DELETE, replace=False)] = True
    return insert, mask


def service_requests(svc, record):
    """Phase 11's library requests: coalesced extracts, the tenant cache,
    PageRank and discover through the service.  Returns epoch 0's first
    extract payload."""
    a, b = SERVICE_TENANTS
    t0 = time.perf_counter()
    pairs = [svc.submit_extract("fraud_store", tenant=(a, b)[i % 2])
             for i in range(SERVICE_COALESCE)]
    payloads = [f.result(600) for f, _ in pairs]
    record["extract_s_cold"] = time.perf_counter() - t0
    assert all(p is payloads[0] for p in payloads), "payloads not shared"
    assert [m["coalesced"] for _, m in pairs] == \
        [False] + [True] * (SERVICE_COALESCE - 1)
    st = svc.stats()
    assert st["scheduler"]["executed"] == 1, st["scheduler"]
    assert st["scheduler"]["coalesced"] == SERVICE_COALESCE - 1
    assert st["engine"]["requests"]["extracts"] == 1, st["engine"]
    wait_until(lambda: svc.stats()["tenants"][a]["cache_entries"] == 1)
    again, record["extract_s_warm"] = timed(
        lambda: svc.extract("fraud_store", tenant=a))
    assert again["source"] == "tenant-cache"
    assert payload_view(again) == payload_view(payloads[0])

    pr, record["analyze_s_cold"] = timed(lambda: svc.analyze(
        "fraud_store", algorithm="pagerank", tenant=a, label="Buy",
        iters=PR_ITERS))
    values = pr["values"]
    assert pr["fingerprint"] == payloads[0]["fingerprint"]
    assert values["shape"] == [sum(payloads[0]["vertices"].values())]
    assert values["dtype"] == "float32" and 0 < values["min"] <= \
        values["max"] < 1, values
    wait_until(lambda: svc.stats()["tenants"][a]["cache_entries"] == 2)
    pr2, record["analyze_s_warm"] = timed(lambda: svc.analyze(
        "fraud_store", algorithm="pagerank", tenant=a, label="Buy",
        iters=PR_ITERS))
    assert pr2["source"] == "tenant-cache"

    disc, record["discover_s_cold"] = timed(
        lambda: svc.discover(use_name_hints=False, top=5, tenant=b))
    assert disc["stats"]["all_compiled"] and len(disc["edges"]) == 5
    wait_until(lambda: svc.stats()["tenants"][b]["cache_entries"] == 2)
    disc2, record["discover_s_warm"] = timed(
        lambda: svc.discover(use_name_hints=False, top=5, tenant=b))
    assert disc2["source"] == "tenant-cache"
    record["discover"] = {k: disc["stats"][k] for k in (
        "candidates", "accepted_fks", "edge_candidates")}
    return payloads[0]


def pinned_reads(svc, first):
    """Epoch-0 extracts past the tenant cache: each must be ``first``."""
    b = SERVICE_TENANTS[1]
    for _ in range(SERVICE_PINNED_READS):
        svc._quotas.invalidate(b)
        got = svc.extract("fraud_store", tenant=b, epoch=0)
        assert got["source"] == "computed"
        assert payload_view(got) == payload_view(first), \
            "a reader pinned to epoch 0 saw another graph"


def service_publish(torch, ExtractionEngine, svc, model, first, record):
    """Phase 11's write side: phase 9's round-1 churn through ``mutate``
    (its delete and its insert are two epochs), then ``refresh`` publishes
    the next epoch while readers pinned to epoch 0 read; the published
    graph against a plain-path fresh extraction.  Returns its
    fingerprint."""
    import threading

    import numpy as np

    from repro_torch.core.database import Database

    insert, mask = churn_request(svc._db, np.random.default_rng(OJ_SEED))
    out, record["mutate_s"] = timed(lambda: svc.mutate(
        "store_sales", insert=insert, delete_mask=mask))
    assert out["live_epoch"] == 2 and out["served_epoch"] == 0, out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result, errors = {}, []

    def refresh():
        try:
            result.update(svc.refresh())
        except BaseException as e:      # raised below, in the phase
            errors.append(e)

    writer = threading.Thread(target=refresh)
    writer.start()
    pinned_reads(svc, first)
    writer.join(1200)
    assert not errors, errors
    pinned_reads(svc, first)            # after the swap too
    torch.cuda.synchronize()
    assert result["path"] == "published" and result["epoch"] == 2, result
    record["refresh"] = {k: result[k] for k in ("models", "build_s")}
    record["peak_gib_two_snapshots"] = torch.cuda.max_memory_allocated() \
        / 2**30
    record["allocated_gib_two_snapshots"] = torch.cuda.memory_allocated() \
        / 2**30
    assert svc.stats()["snapshots"]["epochs"] == [0, 2]
    _, fresh = fresh_graph(ExtractionEngine, Database, svc._db, model)
    with svc._store.pin(2) as snap:
        got = snap.engine.extract(model, auto_refresh=True)
        assert graph_digests(got.graph) == graph_digests(fresh.graph), \
            "the published epoch != a plain-path fresh extraction"
    return fresh.graph.fingerprint()


def service_http(svc, record):
    """Phase 11's front end: ``make_server(svc, port=0)`` answers every
    route once, and a 429 under a tight quota.  Returns the fingerprint
    its refresh published."""
    import threading

    import numpy as np

    from repro_torch.serving import TenantQuota
    from serve_graphs_torch import make_server

    a, b = SERVICE_TENANTS
    server = make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    url, times = f"http://{host}:{port}", []

    def call(route, payload=None, tenant=a, want=200):
        (status, headers, body), seconds = timed(
            lambda: http(f"{url}{route}", payload, tenant))
        assert status == want, f"{route}: {status} {body}"
        times.append([route, status, seconds])
        return headers, body

    try:
        assert call("/healthz")[1]["ok"]
        ext = call("/v1/extract", {"model": "fraud_store"})[1]
        assert ext["epoch"] == svc.stats()["served_epoch"]
        pr = call("/v1/analyze", {"model": "fraud_store",
                                  "algorithm": "pagerank", "params": {
                                      "label": "Buy", "iters": PR_ITERS}})[1]
        assert pr["fingerprint"] == ext["fingerprint"]
        disc = call("/v1/discover", {"use_name_hints": False, "top": 5},
                    tenant=b)[1]
        assert disc["stats"]["all_compiled"] and len(disc["edges"]) == 5
        n = int(svc._db.tables["item"]["rid"].max()) + 1
        ids = list(range(n, n + ITEM_INSERT))
        prices = np.random.default_rng(OJ_SEED).integers(1, 100, ITEM_INSERT)
        out = call("/v1/mutate", {"table": "item", "insert": {
            "rid": ids, "i_id": ids, "i_price": prices.tolist()}})[1]
        assert out["live_epoch"] > out["served_epoch"]
        pub = call("/v1/refresh", {})[1]
        assert pub["path"] == "published", pub
        svc._quotas.set_quota(b, TenantQuota(max_inflight=0))
        headers, body = call("/v1/extract", {"model": "fraud_store"},
                             tenant=b, want=429)
        assert body["retryable"] and float(headers["Retry-After"]) > 0
        svc._quotas.set_quota(b, TenantQuota())
        last = call("/v1/extract", {"model": "fraud_store"})[1]
        assert last["epoch"] == pub["epoch"]
        assert last["fingerprint"] != ext["fingerprint"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
    record["http_s"] = times
    return last["fingerprint"]


def service_phase(torch, kops, ExtractionEngine):
    """Phase 11: ``GraphService`` over a fresh JS-OJ database with a
    ``durable_dir``: coalescing, the tenant cache, PageRank and discover,
    a churn published while pinned readers read, the HTTP front end, and a
    reopen that recovers the published graph.  Returns (launches,
    record)."""
    import shutil
    import tempfile

    from repro_torch.core.database import Database
    from repro_torch.data import fraud_model, make_tpcds
    from repro_torch.serving import GraphService

    model = fraud_model("store")
    durable = Path(tempfile.mkdtemp(prefix="chip_smoke_service_"))
    record = {}
    try:
        db = make_tpcds(sf=TPCDS_SF)
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        svc, record["open_s"] = timed(lambda: GraphService(
            db, {"fraud_store": model}, max_workers=4,
            durable_dir=str(durable)))
        del db
        try:
            first = service_requests(svc, record)
            published = service_publish(torch, ExtractionEngine, svc, model,
                                        first, record)
            assert svc.extract("fraud_store")["fingerprint"] == published
            published = service_http(svc, record)
        finally:
            svc.close()
        torch.cuda.synchronize()
        counts = kops.launch_counts()
        missing = [k for k in JOIN_KERNELS + ("segment_counts", "edge_spmv")
                   if counts[k] == 0]
        assert not missing, f"graph service: kernels never launched: " \
            f"{missing}"
        svc = None
        torch.cuda.empty_cache()
        svc, record["recovery_s"] = timed(lambda: GraphService(
            Database(), {"fraud_store": model}, max_workers=4,
            durable_dir=str(durable)))
        try:
            report = svc.recovery
            assert report.path == "checkpoint", report.summary()
            assert report.verified["fraud_store"] == published
            got, record["recovered_extract_s"] = timed(
                lambda: svc.extract("fraud_store"))
            assert got["fingerprint"] == published
            record["recovery"] = report.summary()
        finally:
            svc.close()
        record["durable_dir_bytes"] = sum(
            f.stat().st_size for f in durable.rglob("*") if f.is_file())
    finally:
        shutil.rmtree(durable, ignore_errors=True)
    record["launches"] = {k: v for k, v in counts.items() if v}
    log(f"graph service: {json.dumps(record)}")
    log("  8 identical extracts ran once; tenant-cache repeats; epoch-0 "
        "reads bit-identical during and after the publish; the published "
        "graph == a plain-path fresh extraction; HTTP routes and a 429; "
        "the reopen recovered the published fingerprint")
    return counts, record


# ---------------------------------------------------------------------------
# phase 13: the sharded slice on a world of one rank
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def nccl_world(torch):
    """``nccl`` at world size 1 through a ``FileStore`` under ``build/``,
    its communicator made at once (``device_id``); destroyed, and the store
    removed, on exit.  A failure to initialise raises: no fallback."""
    import shutil
    import tempfile

    import torch.distributed as dist

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_", dir=ROOT / "build")
    torch.cuda.set_device(0)          # the rank's card, before any mesh
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1, device_id=torch.device("cuda", 0))
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_joins(torch, kops, ref, kernel_rows, smi):
    """Phase 13a: ``distributed_join`` and ``repartition_by_key`` on the
    JS-OJ extraction's inner equi-joins (store_sales on each dimension key,
    TPC-DS SF1), on a 1x1 mesh: every repartition drops nothing, and every
    join's digest equals ``sort_merge_join``'s (the plain probe) on the
    same tables, the exchange skipped (``left_partitioned=True``) or not.
    Launches of the distributed joins are counted and recorded: each
    probe and each pair expansion is held against its plain version on its
    own operands, and the largest and most frequent are cases of the
    kernels' rows.  Returns (counts, timings, {kernel: cases}), the cases
    for ``add_device_times``."""
    from repro_torch.data import make_tpcds
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.relational.distributed import (distributed_join,
                                                    repartition_by_key)
    from repro_torch.relational.join import (join_count, join_with_capacity,
                                             round_capacity, sort_merge_join)
    from repro_torch.relational.ops import table_digest

    mesh = make_host_mesh()
    db = make_tpcds(sf=TPCDS_SF)
    fact = db.table("store_sales")
    cases = []
    for fkey, dim, dkey in SHARDED_JOINS:
        left = fact.select([fkey, "rid"]).prefix("F")
        right = db.table(dim).select([dkey, "rid"]).prefix("D")
        on = [(f"F.{fkey}", f"D.{dkey}")]
        cap = round_capacity(int(join_count(left, right, (on[0][0],),
                                            (on[0][1],))))
        cases.append((f"store_sales.{fkey} = {dim}.{dkey}", left, right, on,
                      cap))
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    results = []
    with recording(kops, "sorted_probe") as calls, \
            recording(kops, "join_expand") as expand_calls:
        for label, left, right, on, cap in cases:
            lpart, lover = repartition_by_key(left, on[0][0], mesh)
            rpart, rover = repartition_by_key(right, on[0][1], mesh)
            got = distributed_join(left, right, on, mesh,
                                   capacity_per_shard=cap)
            got_part = distributed_join(lpart, right, on, mesh,
                                        capacity_per_shard=cap,
                                        left_partitioned=True)
            results.append((label, int(lover), int(rover), got, got_part))
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    assert counts["sorted_probe"] > 0, f"13a: no sorted_probe launch {counts}"
    assert len(calls) == counts["sorted_probe"], \
        f"13a: {len(calls)} sorted_probe calls recorded, {counts} launched"
    assert len(expand_calls) == counts["join_expand"] == len(calls), \
        f"13a: {len(expand_calls)} join_expand calls recorded, {counts} " \
        f"launched"
    check_every_call(torch, kops, ref, {"sorted_probe": calls,
                                        "join_expand": expand_calls},
                     "distributed_join")
    dj_cases = {
        "sorted_probe": record_sorted_probe_calls(
            torch, kops, ref, kernel_rows, calls, "distributed_join"),
        "join_expand": record_join_expand_calls(
            torch, kops, ref, kernel_rows, expand_calls,
            "distributed_join")}
    del calls, expand_calls
    timings = []
    for (label, left, right, on, cap), (_, lover, rover, got, got_part) in \
            zip(cases, results):
        assert lover == 0 and rover == 0, f"13a {label}: overflow " \
            f"{lover} / {rover}"
        want = sort_merge_join(left, right, on, capacity=cap)
        rows = int(want.valid.sum())
        assert rows == int(got.valid.sum()) == int(got_part.valid.sum())
        digest = table_digest(want)
        assert table_digest(got) == digest, f"13a {label}: digest"
        assert table_digest(got_part) == digest, \
            f"13a {label}: left_partitioned digest"
        lp, _ = repartition_by_key(left, on[0][0], mesh)
        t = {
            "join": label, "left_rows": left.capacity,
            "right_rows": right.capacity, "matches": rows,
            "capacity": cap,
            "distributed_ms": cuda_ms(torch, lambda: distributed_join(
                left, right, on, mesh, capacity_per_shard=cap)),
            "left_partitioned_ms": cuda_ms(torch, lambda: distributed_join(
                lp, right, on, mesh, capacity_per_shard=cap,
                left_partitioned=True)),
            "repartition_left_ms": cuda_ms(torch, lambda: repartition_by_key(
                left, on[0][0], mesh)),
            "sort_merge_join_ms": cuda_ms(torch, lambda: join_with_capacity(
                left, right, on, capacity=cap, use_kernel=True))}
        timings.append(t)
        log(f"13a distributed_join ({smi}): {json.dumps(t)}")
    log(f"13a: overflow 0, digests == sort_merge_join's, launches {counts}")
    del db, fact, cases, results
    torch.cuda.empty_cache()
    return counts, timings, dj_cases


def sharded_moe(torch, kops, smi):
    """Phase 13b: ``moe_ffn_shard_map`` on a 1x1 mesh at full width (one
    layer, phase 8's B 4 x S 2,048 tokens) against ``moe_ffn``: bit for bit
    (llama4-scout's shared expert too: top-1, see the module's docstring);
    then phase 8c's
    4-layer qwen3-moe ``forward`` with ``ActSharding(moe_mesh=mesh)``
    (counted) against the same forward without: equal logits."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import local_shape, moe_param_specs
    from repro_torch.models import ActSharding, forward, init_params
    from repro_torch.models import moe
    from repro_torch.models.layers import ACT_DTYPE

    mesh = make_host_mesh()
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    timings = []
    for arch in SHARDED_MOE_ARCHS:
        cfg = get_config(arch)
        spec = cfg.moe
        p = moe.init_moe(torch.Generator(device=dev).manual_seed(13),
                         cfg.d_model, spec, dev)
        x = torch.from_numpy(rng.normal(size=(
            LM_BATCH * LM_PROMPT, cfg.d_model)).astype(np.float32)).to(
            dev, ACT_DTYPE)
        with moe.recording_routes() as routes_ep:
            got = moe.moe_ffn_shard_map(x, p, spec, mesh, ("data",))
        with moe.recording_routes() as routes:
            want = moe.moe_ffn(x, p, spec)
        changed, _ = moe.route_changes(routes_ep, routes)
        assert changed == [0], f"13b {arch}: routes changed {changed}"
        t = {"arch": arch, "tokens": x.shape[0], "d_model": cfg.d_model,
             "experts": spec.num_experts, "top_k": spec.top_k,
             "d_expert": spec.d_expert,
             "shared_expert_dim": spec.shared_expert_dim}
        assert torch.equal(got, want), f"13b {arch}: not bit-equal"
        t.update(max_abs_err=0.0, bit_equal=True)
        t.update(shard_map_ms=cuda_ms(torch, lambda: moe.moe_ffn_shard_map(
            x, p, spec, mesh, ("data",)), iters=10),
            moe_ffn_ms=cuda_ms(torch, lambda: moe.moe_ffn(x, p, spec),
                               iters=10))
        timings.append(t)
        log(f"13b moe_ffn_shard_map ({smi}): {json.dumps(t)}")
        del p, x, got, want
        torch.cuda.empty_cache()

    arch, layers = SHARDED_FORWARD
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    # on a 1x1 mesh every rank's block is the whole tensor: no copy
    specs = moe_param_specs(params, mesh)
    for path, t_ in named_leaves(params):
        spec = functools.reduce(lambda d, k: d[k], path.split("/"), specs)
        assert local_shape(tuple(t_.shape), spec, mesh) == tuple(t_.shape)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)}
    sh = ActSharding(moe_mesh=mesh, moe_dp_axes=("data",))
    want = forward(params, cfg, batch)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    with moe.recording_routes() as routes_ep:
        got = forward(params, cfg, batch, sh=sh)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    assert counts["flash_attention"] == layers, \
        f"13b forward: flash_attention launched {counts}"
    assert len(routes_ep) == layers
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), "13b forward: moe_mesh changed the logits"
    del got, want
    t = {"arch": arch, "layers": layers, "batch": LM_BATCH,
         "prompt": LM_PROMPT,
         "forward_moe_mesh_ms": cuda_ms(torch, lambda: forward(
             params, cfg, batch, sh=sh), iters=3, warmup=1),
         "forward_ms": cuda_ms(torch, lambda: forward(params, cfg, batch),
                               iters=3, warmup=1),
         "launches": counts}
    timings.append(t)
    log(f"13b forward with moe_mesh ({smi}): logits == without; "
        f"{json.dumps(t)}")
    del params, batch
    torch.cuda.empty_cache()
    return counts, timings


def dryrun_memory(torch, smi):
    """Phase 13c: the dry run's per-device argument bytes on a 1x1 mesh for
    qwen2.5-3b at phase 8b's serving shape (a decode step: parameters, a
    cache of LM_PROMPT + LM_STEPS positions for LM_BATCH rows, the token)
    against the growth of ``torch.cuda.memory_allocated()`` when those are
    built on the card: within DRYRUN_REL_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ShapeConfig, init_cache, init_params

    mesh = make_host_mesh()
    cfg = get_config(LM_ARCH)
    shape = ShapeConfig("serve_8b", LM_PROMPT + LM_STEPS, LM_BATCH, "decode")
    want = dryrun.argument_bytes(cfg, shape, mesh)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device=dev)
    token = torch.zeros((shape.global_batch,), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    rel = abs(grown - want) / want
    t = {"arch": cfg.name, "batch": shape.global_batch,
         "cache_positions": shape.seq_len, "dryrun_argument_bytes": want,
         "memory_allocated_growth": grown, "rel_diff": rel}
    log(f"13c dry run vs the card ({smi}): {json.dumps(t)}")
    assert rel <= DRYRUN_REL_TOL, f"13c: {rel:.4f} > {DRYRUN_REL_TOL}"
    del params, cache, token
    torch.cuda.empty_cache()
    return t


def sharded_phase(torch, kops, ref, kernel_rows):
    """Phase 13: the sharded slice in a world of one rank (one card: NCCL
    cannot put two ranks on one GPU, so each exchange moves nothing, while
    the code, the communicator and the kernels all run at full width)."""
    smi = nvidia_smi()
    t0 = time.perf_counter()
    with nccl_world(torch):
        counts_dj, join_t, dj_cases = sharded_joins(
            torch, kops, ref, kernel_rows, smi)
        counts_ep, moe_t = sharded_moe(torch, kops, smi)
        mem_t = dryrun_memory(torch, smi)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s ({smi})")
    return counts_dj, counts_ep, dj_cases, {
        "joins": join_t, "moe": moe_t, "dryrun": mem_t}


# ---------------------------------------------------------------------------
# phase 14: the sharded train step on a world of one rank
# ---------------------------------------------------------------------------

def seeded_batch(torch, cfg, batch: int, seq: int, seed: int = 14):
    """A batch of seeded token ids on the card (labels are the next
    tokens)."""
    import numpy as np

    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).cuda(),
            "labels": torch.from_numpy(toks[:, 1:].copy()).cuda()}


def timed_step(torch, step, params, state, batch):
    """One step between two synchronizes: (params, state, loss, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, metrics = step(params, state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    return params, state, loss, (time.perf_counter() - t0) * 1e3


def state_leaves(params, state):
    """(key, tensor) of the parameters and AdamW moments, local blocks of
    ``DTensor``s taken (on a 1x1 mesh each block is the whole tensor)."""
    from repro_torch.training.tree import flatten

    out = []
    for prefix, tree in (("p", params), ("m", state.m), ("v", state.v)):
        for path, t in flatten(tree):
            t = t.to_local() if hasattr(t, "to_local") else t
            out.append((prefix + "/" + "/".join(path), t))
    return out


def compare_states(torch, want, got, lr):
    """The sharded step's parameters and moments (``got``, on the card)
    against the unsharded step's (``want``, host copies): ``"bit-equal"``
    if every leaf is, else ``"tolerances"`` if every leaf meets
    GRAD_TOL / BF16_ULP as ``test_train_step_matches_jax`` holds them
    (raises otherwise).  Returns (verdict, leaves not bit-equal)."""
    got = dict(got)
    unequal = [k for k, w in want if not torch.equal(got[k], w.cuda())]
    if not unequal:
        return "bit-equal", unequal
    m_of = dict(want)
    for key in unequal:
        g = got[key].float().cpu()
        w = m_of[key].float()
        kind, name = key.split("/", 1)
        if kind in ("m", "v"):
            tol = GRAD_TOL * (2 if kind == "v" else 1)
            assert torch.allclose(g, w, rtol=tol,
                                  atol=tol * float(w.abs().max())), key
        else:
            m = m_of["m/" + name].float().abs()
            sure = m > GRAD_TOL * float(m.max())
            assert torch.allclose(g[sure], w[sure], rtol=BF16_ULP,
                                  atol=0), key
            assert torch.allclose(g, w, rtol=BF16_ULP, atol=2 * lr), key
    return "tolerances", unequal


def sharded_train_case(torch, kops, mesh, cfg, batch_size: int, seq: int,
                       smi, label: str):
    """Phase 14 (a)/(b): one unsharded step from seeded parameters, a fresh
    AdamW state and a seeded batch, its parameters and moments kept on the
    host; then the sharded step (``DTensor`` state on ``mesh``,
    ``act_sharding``, the expert-parallel MoE where the model has one) from
    the same parameters, state and batch: the loss within
    TRAIN_REPEAT_RTOL and every leaf bit-equal (or, failing that, within
    ``compare_states``' tolerances; the result says which held); then
    SHARDED_TRAIN_TIMED timed steps.  Returns (launch counts of the
    sharded steps, a record)."""
    import numpy as np

    from repro_torch.launch.sharding import act_sharding, zero_policy
    from repro_torch.models import init_params
    from repro_torch.training import sharded
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import (TrainStepConfig,
                                                 make_train_step)
    from repro_torch.training.tree import leaves

    dev = torch.device("cuda")
    opt = AdamW()
    ts = TrainStepConfig(microbatches=1, remat=True)
    batch = seeded_batch(torch, cfg, batch_size, seq)

    def start():
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        return params, opt.init(params)

    params, state = start()
    n_params = sum(p.numel() for p in leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, state, loss_u, unsharded_ms = timed_step(
        torch, make_train_step(cfg, opt, ts), params, state, batch)
    peak_u = torch.cuda.max_memory_allocated()
    want = [(k, t.cpu()) for k, t in state_leaves(params, state)]
    del params, state
    torch.cuda.empty_cache()

    params, state = start()
    params, state = sharded.shard_train_state(params, state, cfg, mesh)
    step = make_train_step(cfg, opt, ts,
                           sh=act_sharding(cfg, mesh, batch_size, seq))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    params, state, loss_s, first_ms = timed_step(torch, step, params, state,
                                                 batch)
    counts = kops.launch_counts()
    peak_first = torch.cuda.max_memory_allocated()
    assert np.isfinite(loss_s) and abs(loss_s - loss_u) <= \
        TRAIN_REPEAT_RTOL * abs(loss_u), \
        f"14{label}: sharded loss {loss_s!r} != unsharded {loss_u!r}"
    verdict, unequal = compare_states(torch, want,
                                      state_leaves(params, state), opt.lr)
    del want
    losses, step_ms = [loss_s], []
    kops.reset_launch_counts()
    for _ in range(SHARDED_TRAIN_TIMED):
        params, state, loss, ms = timed_step(torch, step, params, state,
                                             batch)
        losses.append(loss)
        step_ms.append(ms)
    timed_counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)), f"14{label}: losses {losses}"
    assert losses[-1] < losses[0], f"14{label}: the loss did not fall"
    for c in (counts, timed_counts):
        assert not any(c.values()), \
            f"14{label}: the train step launched kernels {c}"
    record = {
        "arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
        "policy": zero_policy(cfg), "mesh": dict(zip(
            mesh.mesh_dim_names, (int(n) for n in mesh.shape))),
        "batch": batch_size, "seq": seq, "remat": True,
        "optimizer": "AdamW", "unsharded_loss": loss_u,
        "sharded_loss": loss_s, "leaves": len(leaves(params)) * 3,
        "result": verdict, "leaves_not_bit_equal": unequal[:10],
        "unsharded_step_ms": unsharded_ms, "first_sharded_step_ms": first_ms,
        "step_ms": step_ms, "losses": losses,
        "unsharded_max_memory_gib": peak_u / 2**30,
        "first_step_max_memory_gib": peak_first / 2**30,
        "max_memory_allocated_gib": peak / 2**30}
    log(f"14{label} sharded train step ({smi}): {json.dumps(record)}")
    del params, state, batch
    torch.cuda.empty_cache()
    return counts, record


def sharded_checkpoint(torch, mesh, smi):
    """Phase 14 (c): qwen2.5-3b smoke, one sharded step on ``mesh``, the
    ``DTensor`` state saved (whole leaves, rank 0) under ``build/`` and
    restored twice: with ``shardings`` onto the mesh (``DTensor``s of the
    same placements) and whole onto the card; every leaf bit-equal to the
    saved state.  The directory is removed."""
    import shutil
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.sharding import (act_sharding, params_shardings,
                                             same_layout, spec_of)
    from repro_torch.models import init_params
    from repro_torch.training import sharded
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import flatten, leaves

    dev = torch.device("cuda")
    cfg = get_smoke_config(TRAIN_ARCH)
    opt = AdamW()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    params, state = sharded.shard_train_state(params, opt.init(params), cfg,
                                              mesh)
    params, state, _ = make_train_step(
        cfg, opt, sh=act_sharding(cfg, mesh, 2, 16))(
            params, state, seeded_batch(torch, cfg, 2, 16))
    tree = {"p": params, "o": state}
    meta = init_params(cfg, device="meta")
    like = {"p": meta, "o": opt.init(meta)}
    specs = {"p": params_shardings(meta, mesh, cfg),
             "o": sharded.state_specs(meta, mesh, cfg, like["o"])}
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_ckpt_",
                           dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        CheckpointManager(tmp).save(1, tree, blocking=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        onto_mesh = CheckpointManager(tmp).restore(1, like, mesh=mesh,
                                                   shardings=specs)
        restore_s = time.perf_counter() - t0
        whole = CheckpointManager(tmp).restore(1, like)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    saved = flatten(tree)
    for (key, t), (_, r), (_, w) in zip(saved, flatten(onto_mesh),
                                        flatten(whole)):
        assert same_layout(spec_of(r), spec_of(t)), key
        assert r.to_local().device.type == "cuda" == w.device.type, key
        assert torch.equal(r.to_local(), t.to_local()), key
        assert torch.equal(w, t.full_tensor()), key
    record = {"arch": cfg.name, "leaves": len(leaves(tree)),
              "save_s": save_s, "restore_s": restore_s}
    log(f"14c sharded checkpoint ({smi}): saved and restored onto the "
        f"mesh and whole, every leaf bit-equal: {json.dumps(record)}")
    return record


def sharded_train_phase(torch, kops, phase12_ms=None):
    """Phase 14: the sharded train step in a world of one rank (nccl; each
    collective is a copy while the code, the communicator and the model run
    at full width): (a) qwen2.5-3b, phase 12's model and shape, (b)
    qwen3-moe at full width cut to one layer with the expert-parallel MoE,
    (c) a sharded checkpoint round trip.  Returns (launch counts, a
    record)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    smi = nvidia_smi()
    t0 = time.perf_counter()
    with nccl_world(torch):
        mesh = make_host_mesh()
        counts_a, dense = sharded_train_case(
            torch, kops, mesh, get_config(TRAIN_ARCH), TRAIN_BATCH,
            TRAIN_SEQ, smi, "a")
        if phase12_ms:
            dense["phase12_step_ms"] = phase12_ms
            dense["ratio_to_phase12"] = (sum(dense["step_ms"])
                                         / len(dense["step_ms"])
                                         / phase12_ms)
            log(f"14a: {dense['ratio_to_phase12']:.4f} x phase 12's "
                f"{phase12_ms:.1f} ms a step ({smi})")
        arch, layers, batch, seq = SHARDED_TRAIN_MOE
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        counts_b, moe_rec = sharded_train_case(torch, kops, mesh, cfg, batch,
                                               seq, smi, "b")
        ckpt = sharded_checkpoint(torch, mesh, smi)
    counts = collections.Counter(counts_a)
    counts.update(counts_b)
    counts_d, tp_rec = tp_train_phase(torch, smi, TP_TRAIN_LAYERS)
    counts.update(counts_d)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s ({smi})")
    return dict(counts), {"dense": dense, "moe": moe_rec, "checkpoint": ckpt,
                          "tp": tp_rec}


def tp_train_config(layers: int):
    """Phase 14d's model: qwen2.5-3b at full width, ``layers`` layers."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN_ARCH), num_layers=layers)


def tp_train_reckoning(cfg, batch: int, seq: int, world: int) -> dict:
    """The collectives of rank 0's program of one tensor-parallel train
    step at ``model`` ``world``, as the dry run records them: its train
    cell's program (``dryrun.run_step``: the forward, remat's recompute,
    the backward and the vocab-parallel loss, then AdamW) on ``meta``
    compute blocks of a 1 x ``world`` mesh of a ``fake`` world, with
    ``act_sharding``.  {kind: bytes, "<kind> calls": count}."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import act_sharding
    from repro_torch.models import ShapeConfig

    shape = ShapeConfig("tp_train", seq, batch, "train")
    with dryrun.fake_world(world):
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        args = dryrun.cell_arguments(cfg, shape, mesh)
        _, _, _, moved = dryrun.run_step(
            cfg, shape, args, act_sharding(cfg, mesh, batch, seq), 1, mesh)
    return collective_totals(moved)


def step_reductions(params, mesh, cfg, sh) -> int:
    """The all-reduce bytes the sharded step adds to its program's
    (:func:`tp_train_reckoning`) on a mesh whose dp axes have one rank:
    each leaf's float32 gradient that is still a partial sum over
    ``model`` (``sharded.leaf_plans``: the biases each rank narrows), the
    loss's sum over dp and the global norm's, two float32 scalars."""
    from repro_torch.launch.sharding import local_shape
    from repro_torch.training import sharded
    from repro_torch.training.tree import flatten

    shapes = {path: tuple(p.shape) for path, p in flatten(params)}
    return sum(4 * math.prod(local_shape(shapes[path], plan.compute, mesh))
               for path, plan in sharded.leaf_plans(params, mesh, cfg,
                                                    sh).items()
               if "model" in plan.partial) + 2 * 4


def tp_train_phase(torch, smi, layers: int):
    """Phase 14d: the unsharded step of :func:`tp_train_config` from seeded
    parameters, a fresh AdamW state and a seeded batch, its loss, new
    parameters and moments saved under ``build/`` and freed, and the dry
    run's record of the rank's program (:func:`tp_train_reckoning`); then
    one tensor-parallel step at ``model`` ``TP_TRAIN_WORLD``, one process
    a rank on the one card over ``gloo`` (:func:`tp_train_rank`), from the
    same start.  Returns (launch counts summed over the ranks, a
    record)."""
    import shutil
    import tempfile

    from repro_torch.models import init_params
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import (TrainStepConfig,
                                                 make_train_step)
    from repro_torch.training.tree import leaves

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = tp_train_config(layers)
    opt = AdamW()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    state = opt.init(params)
    batch = seeded_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, state, loss, ms = timed_step(
        torch, make_train_step(cfg, opt, TrainStepConfig(remat=True)),
        params, state, batch)
    peak = torch.cuda.max_memory_allocated()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_train_",
                                 dir=ROOT / "build"))
    try:
        t1 = time.perf_counter()
        torch.save({"loss": loss, "leaves": {
            k: t.cpu() for k, t in state_leaves(params, state)}},
            work / "reference.pt")
        save_s = time.perf_counter() - t1
        del params, state, batch
        torch.cuda.empty_cache()
        log(f"14d: the unsharded step of {cfg.name} cut to {cfg.num_layers} "
            f"layers ({n_params} parameters): loss {loss!r}, {ms:.1f} ms, "
            f"peak {peak / 2**30:.2f} GiB; saved in {save_s:.1f} s ({smi})")
        world = TP_TRAIN_WORLD
        t1 = time.perf_counter()
        reckoned = tp_train_reckoning(cfg, TRAIN_BATCH, TRAIN_SEQ, world)
        (work / "reckoned.json").write_text(json.dumps(reckoned))
        log(f"14d: the dry run's record of rank 0's program "
            f"({time.perf_counter() - t1:.1f} s): {json.dumps(reckoned)}")
        run_ranks([(f"train {world}:{rank}",
                    ["--tp-rank", str(rank), "--tp-world", str(world),
                     "--tp-dir", str(work), "--tp-train",
                     "--tp-layers", str(layers)])
                   for rank in range(world)], "14d")
        counts, ranks = collections.Counter(), {}
        for rank in range(world):
            rec = json.loads((work / f"train_{rank}.json").read_text())
            counts.update(rec["launches"])
            ranks[rank] = rec
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec = {"params": n_params, "unsharded_loss": loss,
           "unsharded_step_ms": ms, "unsharded_peak_gib": peak / 2**30,
           "ranks": ranks, "seconds": time.perf_counter() - t0}
    log(f"phase 14d: {rec['seconds']:.1f} s; rank peaks "
        f"{[r['peak_gib'] for r in ranks.values()]} GiB against the "
        f"unsharded step's {peak / 2**30:.2f} ({smi})")
    return dict(counts), rec


def tp_train_depths(torch, depths) -> int:
    """Phase 14d alone at each of ``depths`` layers (``--tp-train-depths``):
    each run's ranks print their records, the entries that miss the CPU
    tests' parameter rule among them, so that the same leaves can be read
    at several depths.  Not the smoke run: it prints no result line, and
    exits non-zero if a depth failed."""
    smi = nvidia_smi()
    log(f"card: {smi}")
    failed = []
    for layers in depths:
        try:
            tp_train_phase(torch, smi, layers)
        except AssertionError as e:
            log(f"14d at {layers} layers failed: {e}")
            failed.append(layers)
    return 1 if failed else 0


def adamw_update(torch, m, v, step: int, eps: float):
    """AdamW's update direction ``m_hat / (sqrt(v_hat) + eps)`` of the
    moments after ``step`` steps (``optim.AdamW``'s arithmetic)."""
    b1c = 1 - torch.pow(torch.tensor(0.9), step)
    b2c = 1 - torch.pow(torch.tensor(0.95), step)
    return (m.float() / b1c.to(m.device)) / (
        torch.sqrt(v.float() / b2c.to(v.device)) + eps)


def step_margins(torch, got, want, lr: float, eps: float) -> dict:
    """{"p", "p_sure", "m", "v": max over the entries of |got - want| over
    each entry's tolerance} (a margin <= 1 passes) of one leaf's block
    after a step from the same state: ``got`` and ``want`` map ``"p"``,
    ``"m"``, ``"v"`` to the rank's block and the same block of the
    reference, and ``"m_max"``/``"v_max"`` to the largest entry of the
    reference's whole leaf.  The moments: ``GRAD_TOL`` x (max |w| + |w|),
    twice that for v.  The parameters, from the same bits: the difference
    of the two AdamW updates the two sides' own moments give, times lr,
    plus a bf16 ulp of the larger side (a sign flipped where the gradient
    is near 0 is 2 lr; where the parameter nearly cancels its update, the
    bf16 result is as small as that difference allows).  ``p_sure``: the
    CPU tests' rule, a bf16 ulp of the reference, where the gradient's
    sign is certain (``|m| > GRAD_TOL`` x the leaf's largest) and the new
    parameter is at least ``TP_TRAIN_FAR`` x lr."""
    out = {}
    for kind, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
        w = want[kind].float()
        out[kind] = float(((got[kind].float() - w).abs() / (
            tol * (want[kind + "_max"] + w.abs()))).max())
    g, w = got["p"].float(), want["p"].float()
    du = (adamw_update(torch, got["m"], got["v"], 1, eps)
          - adamw_update(torch, want["m"], want["v"], 1, eps)).abs()
    # what the updates' difference leaves over, against the rounding: the
    # same test as |g - w| <= lr du + rounding, but a margin near 1 then
    # means a rounding near its bound, not a large du
    rounding = BF16_ULP * torch.maximum(g.abs(), w.abs()) + 2.0**-20 * lr
    out["p"] = float(((g - w).abs() - lr * du).clamp(min=0).div(
        rounding).max())
    sure = (want["m"].float().abs() > GRAD_TOL * want["m_max"]) & (
        w.abs() >= TP_TRAIN_FAR * lr)
    out["p_sure"] = float(((g - w).abs()[sure] / (
        BF16_ULP * w.abs()[sure])).max()) if bool(sure.any()) else 0.0
    return out


def sign_rule_misses(torch, got, want, lr: float, stacked: bool,
                     first: int = 8) -> dict:
    """The entries of one leaf's block that miss the CPU tests' first-step
    rule (a bf16 ulp of the reference where the gradient's sign is certain,
    2 lr plus that ulp elsewhere), with no restriction to parameters far
    from lr: {"n": how many, "uncertain": how many of them of uncertain
    sign, "w_max": the largest |want| / lr among them, "per_layer": how
    many in each layer of a stacked leaf, "first": [layer, index in the
    layer's block, want / lr, got / lr, old / lr] of the first ``first``},
    or None when none miss.  ``got``/``want`` as :func:`step_margins`'
    plus ``"p0"``, the block's parameter before the step (on the host)."""
    g, w = got["p"].float(), want["p"].float()
    d, ulp = (g - w).abs(), BF16_ULP * w.abs()
    sure = want["m"].float().abs() > GRAD_TOL * want["m_max"]
    miss = (sure & (d > ulp)) | (d > 2 * lr + ulp)
    n = int(miss.sum())
    if not n:
        return None
    layers = miss.flatten(1).sum(1) if stacked else miss.sum().view(1)
    idx = miss.flatten().nonzero()[:first, 0].tolist()
    per = miss[0].numel() if stacked else miss.numel()
    wf, gf, p0 = (t.flatten() for t in (w, g, got["p0"].float()))
    return {"n": n, "uncertain": int((miss & ~sure).sum()),
            "w_max": float(w.abs()[miss].max() / lr),
            "per_layer": layers.tolist(), "first": [
                [i // per, i % per, float(wf[i] / lr), float(gf[i] / lr),
                 float(p0[i] / lr)] for i in idx]}


def tp_train_rank(torch, kops, rank: int, world: int, work: Path,
                  layers: int) -> int:
    """One rank of phase 14d, in its own process on card 0: a ``gloo``
    world of ``world`` ranks through a file store in ``work``, a 1 x
    ``world`` ``("data", "model")`` mesh.  :func:`tp_train_config`'s
    parameters from the reference's seed, placed by ``params_shardings``,
    AdamW's state built block by block (``sharded.init_state``), every
    block asserted at ``local_shape``; one step under ``act_sharding``
    with the activations and collectives recorded: the ``heads`` block at
    its query heads, the ``logits`` block at its vocabulary columns, the
    all-reduce bytes those of the dry run's record of the program
    (:func:`tp_train_reckoning`, from ``reckoned.json``) plus the step's
    own (:func:`step_reductions`), no gather of whole logits, no kernel
    launch; the loss to ``LOSS_TOL`` of the reference's; each parameter
    and moment block to :func:`step_margins`' tolerances against the same
    block of the reference's leaf, and the entries that miss the CPU
    tests' rule recorded (:func:`sign_rule_misses`).  Writes
    ``train_<rank>.json``."""
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.sharding import (act_sharding, distribute,
                                             local_block, local_shape,
                                             params_shardings, spec_of)
    from repro_torch.mesh_axes import recording_collectives
    from repro_torch.models import init_params
    from repro_torch.models.layers import recording_placements
    from repro_torch.training import sharded
    from repro_torch.training.optim import AdamW
    from repro_torch.training.train_step import (TrainStepConfig,
                                                 make_train_step)
    from repro_torch.training.tree import flatten

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        cfg = tp_train_config(layers)
        opt = AdamW()
        whole = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        params = distribute(whole, params_shardings(whole, mesh, cfg), mesh)
        del whole
        torch.cuda.empty_cache()
        state = sharded.init_state(opt, params, cfg)
        trees = (("p", params), ("m", state.m), ("v", state.v))
        nbytes = 0
        for _, tree in trees:
            for path, t in flatten(tree):
                block = t.to_local()
                assert tuple(block.shape) == local_shape(
                    tuple(t.shape), spec_of(t), mesh), path
                nbytes += block.numel() * block.element_size()
        batch = seeded_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)
        sh = act_sharding(cfg, mesh, TRAIN_BATCH, TRAIN_SEQ)
        step = make_train_step(cfg, opt, TrainStepConfig(remat=True), sh=sh)
        before = {path: t.to_local().cpu() for path, t in flatten(params)}
        own = step_reductions(params, mesh, cfg, sh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launch_counts()
        with recording_placements() as placed, \
                recording_collectives() as moved:
            params, state, loss, ms = timed_step(torch, step, params, state,
                                                 batch)
        counts = kops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert not any(counts.values()), f"14d: kernels launched {counts}"
        first = {}
        for field, _, shape, _ in placed:
            first.setdefault(field, list(shape))
        assert first["heads"] == [TRAIN_BATCH, TRAIN_SEQ,
                                  cfg.num_heads // world, cfg.head_dim], \
            first
        assert first["logits"] == [TRAIN_BATCH, TRAIN_SEQ,
                                   cfg.vocab_size // world], first
        moved_by_kind = collective_totals(moved)
        reckoned = json.loads((work / "reckoned.json").read_text())
        assert moved_by_kind["all-reduce"] == reckoned["all-reduce"] + own, \
            (moved_by_kind, reckoned, own)
        logits_bytes = TRAIN_BATCH * TRAIN_SEQ * cfg.vocab_size * 4
        assert all(n < logits_bytes for k, n in moved
                   if k == "all-gather"), "14d: whole logits gathered"
        ref = torch.load(work / "reference.pt", mmap=True)
        assert np.isfinite(loss) and abs(loss - ref["loss"]) <= \
            LOSS_TOL * (1 + abs(ref["loss"])), (loss, ref["loss"])
        margins, misses = {}, {}
        blocks = {kind: dict(flatten(tree)) for kind, tree in trees}
        for path, p in flatten(params):
            key = "/".join(path)
            got, want = {}, {}
            for kind in ("p", "m", "v"):
                t = blocks[kind][path]
                got[kind] = t.to_local()
                whole = ref["leaves"][f"{kind}/{key}"].to(dev)
                want[kind] = local_block(whole, spec_of(t), mesh)
                want[kind + "_max"] = float(whole.float().abs().max())
                del whole
            for kind, margin in step_margins(torch, got, want, opt.lr,
                                             opt.eps).items():
                group = f"{kind}/{path[-1]}"
                margins[group] = max(margins.get(group, 0.0), margin)
            got["p0"] = before.pop(path)
            missed = sign_rule_misses(torch, got, want, opt.lr,
                                      path[0] == "cycles")
            if missed:
                misses[key] = missed
        worst = max(margins.values())
        rec = {"rank": rank, "backend": dist.get_backend(
            mesh.get_group("model")), "loss": loss,
            "reference_loss": ref["loss"], "step_s_gloo": ms / 1e3,
            "blocks_bytes": nbytes, "peak_gib": peak / 2**30,
            "heads": first["heads"], "logits": first["logits"],
            "collectives": moved_by_kind, "reckoned": reckoned,
            "step_reductions": own, "worst_margin": worst,
            "margins": margins, "sign_rule_misses": misses,
            "launches": counts}
        print(json.dumps(rec), flush=True)
        print("the step's seconds run every collective through the host "
              "(gloo, two ranks on one card): not tensor-parallel speed",
              flush=True)
        assert worst <= 1.0, f"14d: a leaf outside its tolerance: {margins}"
        (work / f"train_{rank}.json").write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def lm_agreement(torch, got, want) -> dict:
    """max |got - want| / std(want) and argmax agreement of two logit
    rows."""
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape, (tuple(got.shape), tuple(want.shape))
    assert bool(torch.isfinite(got).all()), "non-finite logits"
    return {"max_abs_over_std": float((got - want).abs().max()
                                      / want.std()),
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean())}


def tp_world1(torch, kops, lm_outputs, smi):
    """Phase 15a: phase 8b's qwen2.5-3b through the placed entry points on
    ``nccl`` at world size 1: ``DTensor`` parameters on a 1x1 mesh
    (``params_shardings``), ``act_sharding``'s ``ActSharding``, 8b's
    prompt and the greedy tokens 8b fed; every logit row must equal 8b's
    bit for bit (TP at ``model`` 1 is the identity).  Returns (launch
    counts, a record)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (act_sharding, cache_shardings,
                                             distribute, narrow_tree,
                                             params_shardings)
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.decode import init_cache

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    max_len = LM_PROMPT + LM_STEPS
    with nccl_world(torch):
        mesh = make_host_mesh()
        whole = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        params = distribute(whole, params_shardings(whole, mesh, cfg), mesh)
        sh_p = act_sharding(cfg, mesh, LM_BATCH, seq=LM_PROMPT)
        sh_d = act_sharding(cfg, mesh, LM_BATCH)
        meta = init_cache(cfg, LM_BATCH, max_len, device="meta")
        c_pre = cache_shardings(meta, cfg, mesh, LM_BATCH, for_decode=False)
        c_dec = cache_shardings(meta, cfg, mesh, LM_BATCH)
        tokens = lm_outputs["tokens"].to(dev)
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, {"tokens": tokens}, max_len,
                                sh=sh_p)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        cache = narrow_tree(cache, c_pre, c_dec, mesh)
        rows = [logits]
        t0 = time.perf_counter()
        for tok in lm_outputs["fed"]:
            out, cache = decode_step(params, cfg, cache,
                                     tok.to(dev, torch.int32), sh=sh_d)
            rows.append(out)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counts = kops.launch_counts()
        del cache, params, whole
    equal = [torch.equal(r.cpu(), w) for r, w in zip(rows,
                                                     lm_outputs["logits"])]
    assert len(rows) == LM_STEPS + 1 and all(equal), \
        f"15a: logit rows not bit-equal to 8b's: {equal}"
    assert counts["flash_attention"] == cfg.num_layers, counts
    rec = {"prefill_s": prefill_s, "decode_ms_per_step":
           decode_s / LM_STEPS * 1e3, "bit_equal_rows": len(rows),
           "launches": counts}
    log(f"15a: qwen2.5-3b placed on a 1x1 mesh (nccl): {len(rows)} logit "
        f"rows bit-equal to 8b's; {json.dumps(rec)} ({smi})")
    torch.cuda.empty_cache()
    return counts, rec


def run_ranks(jobs, label: str):
    """Start ``chip_smoke.py`` once per (tag, arguments) of ``jobs``, all
    at once, log each one's output under its tag, and fail if one fails."""
    procs = [(tag, subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for tag, args in jobs]
    failed = []
    try:
        for tag, p in procs:
            out, _ = p.communicate(timeout=900)
            for line in out.splitlines():
                log(f"  [{tag}] {line}")
            if p.returncode != 0:
                failed.append((tag, p.returncode))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failed, f"{label}: ranks failed (rank, rc): {failed}"


def tp_serve_phase(torch, kops, lm_outputs, family_outputs):
    """Phase 15: tensor-parallel serving over ``model``.  (a) at world size
    1 (:func:`tp_world1`); (b, c) one process a rank on the one card over
    ``gloo`` (:func:`tp_rank`), the worlds of ``TP_WORLDS`` ranks at once;
    then (d, e) the recurrent families of ``TP_RECURRENT`` at model
    ``TP_RECURRENT_WORLD`` (:func:`tp_recurrent_rank`), both at once.
    Returns (launch counts summed over (a) and every rank, a record)."""
    import shutil
    import tempfile

    smi = nvidia_smi()
    t0 = time.perf_counter()
    counts_a, rec_a = tp_world1(torch, kops, lm_outputs, smi)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=ROOT / "build"))
    try:
        torch.save(lm_outputs, work / "ref.pt")
        run_ranks([(f"{world}:{rank}", ["--tp-rank", str(rank), "--tp-world",
                                        str(world), "--tp-dir", str(work)])
                   for world in TP_WORLDS for rank in range(world)], "15b-c")
        counts = collections.Counter(counts_a)
        ranks = {}
        for world in TP_WORLDS:
            for rank in range(world):
                rec = json.loads((work / f"rank{world}_{rank}.json")
                                 .read_text())
                counts.update(rec["launches"])
                ranks[f"{world}/{rank}"] = rec
        log(f"phase 15b-c: {time.perf_counter() - t0:.1f} s ({smi})")
        t1 = time.perf_counter()
        for arch in TP_RECURRENT:
            torch.save(family_outputs[arch], work / f"{arch}.pt")
        world = TP_RECURRENT_WORLD
        run_ranks([(f"{arch} {world}:{rank}",
                    ["--tp-rank", str(rank), "--tp-world", str(world),
                     "--tp-dir", str(work), "--tp-arch", arch])
                   for arch in TP_RECURRENT for rank in range(world)],
                  "15d-e")
        for arch in TP_RECURRENT:
            for rank in range(world):
                rec = json.loads((work / f"{arch}_{world}_{rank}.json")
                                 .read_text())
                counts.update(rec["launches"])
                ranks[f"{arch}/{world}/{rank}"] = rec
        log(f"phase 15d-e: {time.perf_counter() - t1:.1f} s ({smi})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s ({smi})")
    return dict(counts), {"a": rec_a, "ranks": ranks}


def tp_rank(torch, kops, ref, rank: int, world: int, work: Path) -> int:
    """One rank of phase 15 (b, c), in its own process on card 0: a
    ``gloo`` world of ``world`` ranks through a file store in ``work``, a
    1 x ``world`` ``("data", "model")`` mesh.  (b) qwen2.5-3b placed by
    ``params_shardings`` (each rank's blocks asserted against
    ``local_shape``), prefill of 8b's prompt and ``TP_STEPS`` decode steps
    fed 8b's greedy tokens, the cache narrowed into the decode layout;
    every row against 8b's (``LM_REL_TOL``, ``TP_ARGMAX_MIN``).  (c) at
    world 4, internvl2-1b's sequence-parallel prefill against the
    unsharded prefill.  Every flash launch is held against the plain
    version on its own operands.  Writes ``rank<world>_<rank>.json``."""
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import (act_sharding, cache_shardings,
                                             distribute, local_shape,
                                             narrow_tree, params_shardings,
                                             spec_of)
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.decode import init_cache

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{work}/store{world}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        backend = dist.get_backend(mesh.get_group("model"))
        print(f"backend {backend}, model {world}, rank {rank}", flush=True)
        real, compare = kops.flash_attention, flash_compare(torch)
        flash = {"shapes": set(), "max_abs_err": 0.0, "checked": 0}

        def checked(q, k, v, **kw):
            out = real(q, k, v, **kw)
            err = compare(out, ref.flash_attention(q, k, v, **kw))
            flash["max_abs_err"] = max(flash["max_abs_err"], err)
            flash["checked"] += 1
            flash["shapes"].add(f"q {tuple(q.shape)} k {tuple(k.shape)} "
                                f"offset {kw.get('q_offset', 0)}")
            return out

        def placed(cfg, seed):
            whole = init_params(cfg, torch.Generator(device=dev).manual_seed(
                seed), device=dev)
            params = distribute(whole, params_shardings(whole, mesh, cfg),
                                mesh)
            nbytes = 0
            for t in _leaves(params):
                block = t.to_local()
                assert tuple(block.shape) == local_shape(
                    tuple(t.shape), spec_of(t), mesh)
                nbytes += block.numel() * block.element_size()
            return whole, params, nbytes

        ref_out = torch.load(work / "ref.pt")
        cfg = get_config(LM_ARCH)
        whole, params, nbytes = placed(cfg, 0)
        del whole
        torch.cuda.empty_cache()
        max_len = LM_PROMPT + LM_STEPS
        sh_p = act_sharding(cfg, mesh, LM_BATCH, seq=LM_PROMPT)
        sh_d = act_sharding(cfg, mesh, LM_BATCH)
        meta = init_cache(cfg, LM_BATCH, max_len, device="meta")
        c_pre = cache_shardings(meta, cfg, mesh, LM_BATCH, for_decode=False)
        c_dec = cache_shardings(meta, cfg, mesh, LM_BATCH)
        rec = {"backend": backend, "params_bytes": nbytes}
        kops.flash_attention = checked
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, {"tokens": ref_out["tokens"]
                                              .to(dev)}, max_len, sh=sh_p)
        torch.cuda.synchronize()
        rec["prefill_s_gloo"] = time.perf_counter() - t0
        for t, spec, w in zip(_leaves(cache), _leaves(c_pre),
                              _leaves(meta)):
            assert tuple(t.shape) == local_shape(tuple(w.shape), spec, mesh)
        rec["prefill_k"] = next(list(t.shape) for t in _leaves(cache)
                                if t.dim() == 5)
        cache = narrow_tree(cache, c_pre, c_dec, mesh)
        for t, spec, w in zip(_leaves(cache), _leaves(c_dec),
                              _leaves(meta)):
            assert tuple(t.shape) == local_shape(tuple(w.shape), spec, mesh)
        rec["decode_k"] = next(list(t.shape) for t in _leaves(cache)
                               if t.dim() == 5)
        rows = [logits]
        t0 = time.perf_counter()
        for i in range(TP_STEPS):
            out, cache = decode_step(params, cfg, cache,
                                     ref_out["fed"][i].to(dev), sh=sh_d)
            rows.append(out)
        torch.cuda.synchronize()
        rec["decode_ms_per_step_gloo"] = (time.perf_counter() - t0) \
            / TP_STEPS * 1e3
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        counts = kops.launch_counts()
        assert counts["flash_attention"] == cfg.num_layers, counts
        agree = [lm_agreement(torch, r, w)
                 for r, w in zip(rows, ref_out["logits"])]
        rec["worst_over_std"] = max(a["max_abs_over_std"] for a in agree)
        rec["argmax_agreement"] = float(np.mean(
            [a["argmax_agreement"] for a in agree]))
        assert rec["worst_over_std"] <= LM_REL_TOL, agree
        assert rec["argmax_agreement"] >= TP_ARGMAX_MIN, agree
        del params, cache, rows
        torch.cuda.empty_cache()
        if world == 4:
            rec["vlm"], vlm_counts = tp_vlm(torch, kops, real, mesh, placed)
            for k, v in vlm_counts.items():
                counts[k] += v
        kops.flash_attention = real
        rec["launches"] = counts
        rec["flash"] = dict(flash, shapes=sorted(flash["shapes"]))
        print(json.dumps(rec), flush=True)
        (work / f"rank{world}_{rank}.json").write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def tp_vlm(torch, kops, real, mesh, placed):
    """Phase 15c on one rank: internvl2-1b at model 4, its prefill
    sequence-parallel, against the unsharded prefill (taken first, with
    the kernel unchecked: its launches are not counted)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import act_sharding
    from repro_torch.models import prefill

    dev = torch.device("cuda", 0)
    cfg = get_config(TP_VLM)
    rng = np.random.default_rng(15)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, TP_VLM_TOKENS)).astype(np.int32)).to(
            dev),
        "embeds": torch.from_numpy(rng.normal(size=(
            LM_BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)).to(
                dev, torch.bfloat16)}
    seq = cfg.frontend_len + TP_VLM_TOKENS
    whole, params, nbytes = placed(cfg, 1)
    checked, kops.flash_attention = kops.flash_attention, real
    want, _ = prefill(whole, cfg, batch, seq)
    kops.flash_attention = checked
    del whole
    sh = act_sharding(cfg, mesh, LM_BATCH, seq=seq)
    assert sh.hidden[1] == "model", "internvl2-1b at model 4: not seq_par"
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    got, cache = prefill(params, cfg, batch, seq, sh=sh)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = kops.launch_counts()
    assert counts["flash_attention"] == cfg.num_layers, counts
    agree = lm_agreement(torch, got, want)
    assert agree["max_abs_over_std"] <= LM_REL_TOL, agree
    assert agree["argmax_agreement"] >= TP_ARGMAX_MIN, agree
    k = next(t for t in _leaves(cache) if t.dim() == 5)
    assert k.shape[2] == seq, tuple(k.shape)      # the gathered keys, whole
    return {"prefill_s_gloo": elapsed, "params_bytes": nbytes,
            "cache_k": list(k.shape), **agree}, counts


def state_agreement(torch, got, want, what: str) -> dict:
    """Per state leaf (``want``: the unsharded run's, whole, on the host):
    max |got - want| over max |want| (``over_max``) and over std(want), and
    ``first``: the first cycle's slice (a tail leaf whole) over its max;
    every leaf finite and of ``want``'s shape."""
    out = {}
    for path, w in want.items():
        g, w = got[path].float().cpu(), w.float()
        assert g.shape == w.shape, (what, path, tuple(g.shape),
                                    tuple(w.shape))
        assert bool(torch.isfinite(g).all()), f"{what} {path}: non-finite"
        d = (g - w).abs()
        first = 0 if path.startswith("cycles/") else slice(None)
        out[path] = {
            "over_max": float(d.max() / max(float(w.abs().max()), 1e-30)),
            "over_std": float(d.max() / max(float(w.std()), 1e-30)),
            "first": float(d[first].max()
                           / max(float(w[first].abs().max()), 1e-30))}
    return out


def check_states(agree: dict, first_layer, what: str, every: bool) -> dict:
    """The gates of phase 15d/e on ``state_agreement``'s record: the first
    recurrent layer's states after the prefill (``first_layer``: its
    path's prefix; its input is the embedding alone) within
    ``FIRST_STATE_TOL`` of their largest entry (None: no such check);
    with ``every``, each leaf's ``over_max`` within ``LM_REL_TOL`` but the
    sLSTM's c and n (``SLSTM_SCALED``).  Returns the worst leaf."""
    for path, a in agree.items():
        if first_layer is not None and path.startswith(first_layer):
            assert a["first"] <= FIRST_STATE_TOL, (what, path, a)
        if every and not path.endswith(SLSTM_SCALED):
            assert a["over_max"] <= LM_REL_TOL, (what, path, a)
    worst = max(agree, key=lambda p: agree[p]["over_max"])
    return {"leaves": len(agree), "worst": worst, **agree[worst]}


def mixers_alone(torch, cfg, group, rank: int, world: int) -> dict:
    """Each recurrent mixer of ``cfg`` at its full width, B LM_BATCH x
    LM_PROMPT, on this rank's column / row blocks against the whole mixer
    on the same inputs (seeded): the sequence form, then a decode step from
    its state.  Outputs within ``MIXER_OUT_TOL`` of their largest entry
    (the row-parallel sums round in bf16 otherwise), states within
    ``MIXER_STATE_TOL`` (they are the whole mixer's channels or key rows;
    only float32 sums may round apart)."""
    from repro_torch.models import recurrent as rec
    from repro_torch.models.layers import TP

    dev = torch.device("cuda", 0)
    tp = TP(group, world, rank)
    d, h = cfg.d_model, max(cfg.num_heads, 1)
    gen = torch.Generator(device=dev).manual_seed(26)

    def cols(w):
        n = w.shape[-1] // world
        return w[..., rank * n:(rank + 1) * n].contiguous()

    def rows(w):
        n = w.shape[0] // world
        return w[rank * n:(rank + 1) * n].contiguous()

    def keys(t):                   # the mLSTM's key rows (dim 2 of C, n)
        n = t.shape[2] // world
        return t[:, :, rank * n:(rank + 1) * n]

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    out = {}
    for kind in sorted(set(cfg.block_pattern) & {"rglru", "mlstm", "slstm"}):
        x = torch.randn(LM_BATCH, LM_PROMPT, d, generator=gen,
                        device=dev).to(torch.bfloat16)
        xs = torch.randn(LM_BATCH, d, generator=gen, device=dev).to(
            torch.bfloat16)
        if kind == "rglru":
            p = rec.init_rglru(gen, d, dev)
            mine = {k: rows(v) if k == "w_out" else v if k == "lam"
                    else cols(v) for k, v in p.items()}
            o, st = rec.rglru_seq(p, x)
            lo, lst = rec.rglru_seq(mine, x, tp=tp)
            conv = x[:, -(rec.CONV_WIDTH - 1):] @ p["w_x"]
            o2, st2, _ = rec.rglru_step(p, xs, st, conv)
            lo2, lst2, _ = rec.rglru_step(mine, xs, lst, cols(conv), tp)
            pairs = [(lst, cols(st)), (lst2, cols(st2))]
        elif kind == "slstm":
            p = rec.init_slstm(gen, d, dev)
            mine = {k: rows(v) if k == "w_out" else cols(v)
                    for k, v in p.items()}
            o, st = rec.slstm_seq(p, x)
            lo, lst = rec.slstm_seq(mine, x, tp=tp)
            pairs = [(a, cols(b)) for a, b in zip(lst, st)]
            o2, st2 = rec.slstm_step(p, xs, st)
            lo2, lst2 = rec.slstm_step(mine, xs, lst, tp)
            pairs += [(a, cols(b)) for a, b in zip(lst2, st2)]
        else:                          # the step updates C, n in place
            p = rec.init_mlstm(gen, d, h, dev)
            mine = {k: v if k in ("w_i", "w_f") and h % world else cols(v)
                    for k, v in p.items()}
            o, (c, n) = rec.mlstm_seq(p, x, h)
            lo, (lc, ln) = rec.mlstm_seq(mine, x, h, tp=tp)
            errs = [rel(lc, keys(c)), rel(ln, keys(n))]
            o2, _ = rec.mlstm_step(p, xs, (c, n), h)
            lo2, _ = rec.mlstm_step(mine, xs, (lc, ln), h, tp)
            pairs = [(lc, keys(c)), (ln, keys(n))]
        out[kind] = {"out": max(rel(lo, o), rel(lo2, o2)),
                     "states": max([rel(a, b) for a, b in pairs]
                                   + (errs if kind == "mlstm" else []))}
        assert out[kind]["out"] <= MIXER_OUT_TOL, (kind, out[kind])
        assert out[kind]["states"] <= MIXER_STATE_TOL, (kind, out[kind])
        del p, mine, x
    torch.cuda.empty_cache()
    return out


def unsharded_outputs(torch, cfg, params, tokens) -> dict:
    """Phase 8c's record (``serve_family``) of an unsharded run of
    ``params`` on ``tokens``: the logit rows of the prefill and
    ``TP_STEPS`` greedy steps, the tokens fed, the recurrent states after
    the prefill and after the steps."""
    from repro_torch.models import decode_step, prefill

    logits, cache = prefill(params, cfg, {"tokens": tokens},
                            tokens.shape[1] + LM_STEPS)
    out = {"tokens": tokens.cpu(), "logits": [logits.cpu()], "fed": [],
           "states_prefill": {p: t.to("cpu", copy=True)
                              for p, t in recurrent_states(cache)}}
    for _ in range(TP_STEPS):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out["fed"].append(tok.cpu())
        logits, cache = decode_step(params, cfg, cache, tok)
        out["logits"].append(logits.cpu())
    out["states_steps"] = {p: t.to("cpu", copy=True)
                           for p, t in recurrent_states(cache)}
    return out


def tp_recurrent_run(torch, kops, cfg, mesh, whole, want, gate: bool):
    """``whole`` (freed here) placed by ``params_shardings`` on ``mesh``,
    the prefill of ``want``'s prompt and its fed tokens through the TP
    entry points, against ``want`` (:func:`unsharded_outputs`' record):
    the parameter and cache blocks at ``local_shape``; the states
    (``check_states``; with ``gate`` every leaf, and the logit rows within
    ``LM_REL_TOL`` x std and ``TP_ARGMAX_MIN``).  Returns (a record, launch
    counts)."""
    import numpy as np

    from repro_torch.launch.sharding import (act_sharding, cache_shardings,
                                             distribute, gather_to,
                                             local_shape, narrow_tree,
                                             params_shardings, spec_of)
    from repro_torch.mesh_axes import recording_collectives
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.decode import init_cache

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    params = distribute(whole, params_shardings(whole, mesh, cfg), mesh)
    whole_bytes = sum(t.numel() * t.element_size() for t in _leaves(whole))
    whole.clear()
    torch.cuda.empty_cache()
    nbytes = 0
    for t in _leaves(params):
        block = t.to_local()
        assert tuple(block.shape) == local_shape(
            tuple(t.shape), spec_of(t), mesh), tuple(block.shape)
        nbytes += block.numel() * block.element_size()
    rec = {"layers": cfg.num_layers, "params_bytes": nbytes,
           "whole_params_bytes": whole_bytes,
           "place_s": time.perf_counter() - t0}
    prompt = want["tokens"].shape[1]
    max_len = prompt + LM_STEPS
    sh_p = act_sharding(cfg, mesh, LM_BATCH, seq=prompt)
    sh_d = act_sharding(cfg, mesh, LM_BATCH)
    meta = init_cache(cfg, LM_BATCH, max_len, device="meta")
    c_pre = cache_shardings(meta, cfg, mesh, LM_BATCH, for_decode=False)
    c_dec = cache_shardings(meta, cfg, mesh, LM_BATCH)
    first = f"cycles/s0_{cfg.block_pattern[0]}/"

    def blocks_of(cache, specs, what):
        local = whole_bytes = 0
        for (path, t), (_, spec), (_, w) in zip(
                named_leaves(cache), named_leaves(specs), named_leaves(meta)):
            assert tuple(t.shape) == local_shape(tuple(w.shape), spec,
                                                 mesh), (what, path)
            if path.rsplit("/", 1)[-1] in ("h", "conv", "c", "n", "m"):
                local += t.numel() * t.element_size()
                whole_bytes += w.numel() * w.element_size()
        return local, whole_bytes

    def gathered(cache, specs):
        spec = dict(named_leaves(specs))
        return {p: gather_to(t, spec[p], (None,) * t.dim(), mesh)
                for p, t in recurrent_states(cache)}

    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_collectives() as moved:
        logits, cache = prefill(params, cfg, {"tokens": want["tokens"]
                                              .to(dev)}, max_len, sh=sh_p)
    torch.cuda.synchronize()
    rec["prefill_s_gloo"] = time.perf_counter() - t0
    rec["prefill_collective_bytes"] = collective_totals(moved)
    rec["state_bytes"], rec["whole_state_bytes"] = blocks_of(
        cache, c_pre, "prefill cache")
    states = {"prefill": state_agreement(
        torch, gathered(cache, c_pre), want["states_prefill"],
        f"15 {cfg.name} prefill states")}
    cache = narrow_tree(cache, c_pre, c_dec, mesh)
    blocks_of(cache, c_dec, "decode cache")
    rows = [logits]
    t0 = time.perf_counter()
    for i, tok in enumerate(want["fed"]):
        with recording_collectives() as moved:
            out, cache = decode_step(params, cfg, cache, tok.to(dev),
                                     sh=sh_d)
        if i == 0:
            rec["step_collective_bytes"] = collective_totals(moved)
        rows.append(out)
    torch.cuda.synchronize()
    rec["decode_ms_per_step_gloo"] = (time.perf_counter() - t0) \
        / len(want["fed"]) * 1e3
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    counts = kops.launch_counts()
    blocks_of(cache, c_dec, "cache after the steps")
    states["steps"] = state_agreement(
        torch, gathered(cache, c_dec), want["states_steps"],
        f"15 {cfg.name} states after the steps")
    agree = [lm_agreement(torch, r, w) for r, w in zip(rows, want["logits"])]
    assert len(agree) == TP_STEPS + 1
    rec["worst_over_std"] = max(a["max_abs_over_std"] for a in agree)
    rec["argmax_agreement"] = float(np.mean(
        [a["argmax_agreement"] for a in agree]))
    print(json.dumps({cfg.name: rec, "states": states}), flush=True)
    rec["states"] = {
        "prefill": check_states(states["prefill"], first, cfg.name, gate),
        "steps": check_states(states["steps"], None, cfg.name, gate)}
    if gate:
        assert rec["worst_over_std"] <= LM_REL_TOL, agree
        assert rec["argmax_agreement"] >= TP_ARGMAX_MIN, agree
    del params, cache, rows
    torch.cuda.empty_cache()
    return rec, counts


def tp_recurrent_rank(torch, kops, ref, rank: int, world: int, work: Path,
                      arch: str) -> int:
    """One rank of phase 15d/e, in its own process on card 0: a ``gloo``
    world of ``world`` ranks, a 1 x ``world`` ``("data", "model")`` mesh.
    First each of ``arch``'s mixers alone at full width, split against
    whole (:func:`mixers_alone`).  Then ``arch`` at full width and depth
    (:func:`tp_recurrent_run`) against 8c's run of it (``work /
    <arch>.pt``): gated where ``TP_RECURRENT_CUT`` does not name it, else
    recorded, and gated at that depth against the unsharded run of the cut
    model (:func:`unsharded_outputs`, taken first with whole parameters).
    Every flash launch is held against the plain version on its own
    operands.  Writes ``<arch>_<world>_<rank>.json``."""
    import dataclasses
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo",
                            init_method=f"file://{work}/store_{arch}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        group = mesh.get_group("model")
        backend = dist.get_backend(group)
        print(f"backend {backend}, {arch}, model {world}, rank {rank}",
              flush=True)
        real, compare = kops.flash_attention, flash_compare(torch)
        flash = {"shapes": set(), "max_abs_err": 0.0, "checked": 0}

        def checked(q, k, v, **kw):
            out = real(q, k, v, **kw)
            err = compare(out, ref.flash_attention(q, k, v, **kw))
            flash["max_abs_err"] = max(flash["max_abs_err"], err)
            flash["checked"] += 1
            flash["shapes"].add(f"q {tuple(q.shape)} k {tuple(k.shape)} "
                                f"window {kw.get('window')}")
            return out

        cfg = get_config(arch)
        rec = {"backend": backend, "arch": arch, "model": world,
               "mixers_alone": mixers_alone(torch, cfg, group, rank, world)}
        cut = dict([TP_RECURRENT_CUT]).get(arch)
        want = torch.load(work / f"{arch}.pt")
        kops.flash_attention = checked

        def params_of(c):
            return init_params(c, torch.Generator(device=dev).manual_seed(0),
                               device=dev)

        rec["full"], counts = tp_recurrent_run(
            torch, kops, cfg, mesh, params_of(cfg), want, gate=cut is None)
        rec["full"]["unsharded_peak_gib"] = want["peak_gib"]
        tokens = want["tokens"]
        del want
        n_attn = sum(k in ("attn", "swa") for k in cfg.layer_kinds())
        assert counts["flash_attention"] == n_attn == flash["checked"], \
            (counts, flash["checked"])
        if cut is not None:
            cut_cfg = dataclasses.replace(cfg, num_layers=cut)
            whole = params_of(cut_cfg)
            kops.flash_attention = real      # the reference launches nothing
            base = unsharded_outputs(torch, cut_cfg, whole,
                                     tokens.to(dev))
            kops.flash_attention = checked
            rec["cut"], cut_counts = tp_recurrent_run(
                torch, kops, cut_cfg, mesh, whole, base, gate=True)
            for k, v in cut_counts.items():
                counts[k] += v
        kops.flash_attention = real
        rec["launches"] = counts
        rec["flash"] = dict(flash, shapes=sorted(flash["shapes"]))
        print(json.dumps(rec), flush=True)
        (work / f"{arch}_{world}_{rank}.json").write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def collective_totals(moved) -> dict:
    """Bytes of each kind of collective of a ``recording_collectives``
    record, and how many ran."""
    out = collections.Counter()
    for kind, nbytes in moved:
        out[kind] += nbytes
        out[f"{kind} calls"] += 1
    return dict(out)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def digests(edges):
    from repro_torch.relational.ops import table_digest

    return {lab: table_digest(t) for lab, t in edges.items()}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # one rank of phase 15 (b, c): the script starts these itself
    parser.add_argument("--tp-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--tp-world", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--tp-dir", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-arch", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-train", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--tp-layers", type=int, default=TP_TRAIN_LAYERS,
                        help=argparse.SUPPRESS)
    # phase 14d alone at each of these depths (comma-separated), for the
    # depth of the entries that miss the CPU tests' parameter rule
    parser.add_argument("--tp-train-depths", default=None,
                        help="run phase 14d alone at these layer counts")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "examples"))
    import numpy as np

    from repro_torch.api import ExtractionEngine
    from repro_torch.core.pipeline import PipelineCompiler
    from repro_torch.data import (dblp_model, fraud_model, make_dblp,
                                  make_tpcds)
    from repro_torch.graph import build_csr
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.relational import Table
    from repro_torch.relational.ops import table_digest

    assert "jax" not in sys.modules and "repro" not in sys.modules
    # float32 matmuls and convolutions in full float32 (the plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tp_rank is not None and args.tp_train:
        return tp_train_rank(torch, kops, args.tp_rank, args.tp_world,
                             Path(args.tp_dir), args.tp_layers)
    if args.tp_train_depths:
        return tp_train_depths(torch, [int(n) for n in
                                       args.tp_train_depths.split(",")])
    if args.tp_rank is not None and args.tp_arch is not None:
        return tp_recurrent_rank(torch, kops, ref, args.tp_rank,
                                 args.tp_world, Path(args.tp_dir),
                                 args.tp_arch)
    if args.tp_rank is not None:
        return tp_rank(torch, kops, ref, args.tp_rank, args.tp_world,
                       Path(args.tp_dir))

    # 1. the card
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch: {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # 2. the build (cold in a fresh checkout: build/ is not committed)
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(logs) or 'nothing (already built)'}")
    for src, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{src}]: {line.strip()}")
    for template, usage in flash_ptxas(
            (_build.BUILD_DIR / "flash_attention.log").read_text()):
        log(f"  flash_attention<{template}> (head dims up to {template}): "
            f"{usage}")

    # 4's data first: phase 3 takes its shapes from it
    t0 = time.perf_counter()
    tpcds = make_tpcds(sf=TPCDS_SF)
    torch.cuda.synchronize()
    log(f"data: make_tpcds(sf={TPCDS_SF}) {time.perf_counter() - t0:.2f} s,"
        f" store_sales {tpcds.stats['store_sales'].rows} rows")
    ss = {c: tpcds.table("store_sales")[c].cpu().numpy()
          for c in ("c_sk", "i_sk", "o_sk")}
    fact_np = {"i_sk": ss["i_sk"],
               "i_id": tpcds.table("item")["i_id"].cpu().numpy()}

    # 3. kernels against their plain versions (CUDA events only: the
    # profiler's device times come after the paths, which run with nothing
    # recorded; see the module's docstring)
    log("kernels vs plain (exact), CUDA-event times:")
    kernel_rows = check_kernels(torch, kops, ref, fact_np)

    # 4. the JS-OJ path
    oj_model = fraud_model("store")
    cold, warm, counts_oj, rows_oj = drive(
        torch, kops, ExtractionEngine(tpcds), oj_model,
        f"JS-OJ fraud_model(store) sf={TPCDS_SF}")
    plan_units = [("merged" if not u.is_single else "single")
                  for u in cold.plan.units]
    log(f"  plan units {plan_units}, views {[v.name for v in cold.plan.views]}")
    assert "merged" in plan_units, "expected a JS-OJ merged unit"

    def host_digest(src, dst):
        return table_digest(Table.from_arrays(device="cpu", src=src, dst=dst))

    want = {"Buy": host_digest(ss["c_sk"], ss["i_sk"]),
            "Sell": host_digest(ss["o_sk"], ss["i_sk"])}
    got = digests(cold.edges)
    assert got == want, f"JS-OJ edges differ from numpy: {got} vs {want}"
    plain = ExtractionEngine(tpcds, compiler=PipelineCompiler(
        use_kernel=False, use_bloom=False)).extract(oj_model)
    assert digests(plain.edges) == got, "JS-OJ kernel path != plain path"
    log("  edges == numpy bags == plain-torch path")
    oj_graph = cold.graph
    del plain, cold, warm
    torch.cuda.empty_cache()

    # 5. the JS-MV path
    t0 = time.perf_counter()
    dblp = make_dblp(scale=DBLP_SCALE)
    torch.cuda.synchronize()
    log(f"data: make_dblp(scale={DBLP_SCALE}) "
        f"{time.perf_counter() - t0:.2f} s, wrote "
        f"{dblp.stats['wrote'].rows} rows")
    mv_model = dblp_model()
    cold, warm, counts_mv, rows_mv = drive(
        torch, kops, ExtractionEngine(dblp), mv_model,
        f"JS-MV dblp_model scale={DBLP_SCALE}")
    log(f"  cold {cold.provenance}\n  warm {warm.provenance}")
    assert cold.provenance.views_built, "cold request built no view"
    assert warm.provenance.plan_cache_hit, "warm request missed the plan"
    assert warm.provenance.views_reused, "warm request reused no view"
    wrote = {c: dblp.table("wrote")[c].cpu().numpy() for c in ("a_sk", "p_sk")}
    v_of_paper = dblp.table("paper")["v_sk"].cpu().numpy()
    n_venue = dblp.stats["venue"].rows
    per_paper = np.bincount(wrote["p_sk"]).astype(np.int64)
    editors = np.bincount(dblp.table("edits")["v_sk"].cpu().numpy(),
                          minlength=n_venue).astype(np.int64)
    want_rows = {"Co-auth": int((per_paper ** 2).sum()),
                 "Auth-Edit": int(editors[v_of_paper[wrote["p_sk"]]].sum())}
    assert rows_mv == want_rows, f"JS-MV rows {rows_mv} != numpy {want_rows}"
    plain = ExtractionEngine(dblp, compiler=PipelineCompiler(
        use_kernel=False, use_bloom=False)).extract(mv_model)
    assert digests(plain.edges) == digests(cold.edges), \
        "JS-MV kernel path != plain path"
    log("  edge counts == numpy; digests == plain-torch path")
    del plain, cold, warm
    torch.cuda.empty_cache()

    # 6. analytics on the JS-OJ graph (and phase 3's graph kernels)
    graph_rows, counts_oja, _ = analytics_oj(
        torch, kops, ref, ExtractionEngine, tpcds, oj_model, oj_graph)
    del tpcds, oj_graph
    torch.cuda.empty_cache()

    # 7. analytics on the JS-MV graph
    counts_mva, _ = analytics_mv(torch, kops, ref, ExtractionEngine, dblp,
                                 mv_model, graph_rows)
    del dblp
    torch.cuda.empty_cache()

    # 8. the LM serving path: the flash kernel, then qwen2.5-3b full width
    log("flash_attention vs plain (bf16), CUDA-event times:")
    flash_rows = check_flash_kernel(torch, kops, ref)
    counts_lm, _, lm_outputs = serve_lm(torch, kops)
    torch.cuda.empty_cache()
    counts_families, _, family_outputs = serve_families(torch, kops)

    # 9. refresh and recovery: JS-OJ rounds (delta, delta, full, noop) on a
    # durable database, JS-MV through its maintained view, then recovery
    counts_oj_ref, counts_mv_ref, delta_counts = refresh_and_recovery(
        torch, kops, ref, ExtractionEngine)

    # 10. discovery on anonymized JS-OJ and JS-MV data, cold then warm,
    # against the plain path and the JAX package's constants
    counts_disc, _ = discovery_phase(torch, kops, ExtractionEngine)

    # 11. the graph service over a durable JS-OJ database, its HTTP front
    # end, and a reopen that recovers what it published
    counts_svc, _ = service_phase(torch, kops, ExtractionEngine)

    # 12. training: qwen2.5-3b at full width on DBLP walks, the recovery
    # drill at smoke size, then serving the trained parameters
    counts_train, train_record = train_lm(torch, kops)
    recovery_drill(torch)

    # 13. the sharded slice on nccl at world size 1: the distributed join
    # (TPC-DS SF1), the expert-parallel MoE at full width, the dry run's
    # accounting against the card's memory
    counts_dj, counts_ep, dj_cases, _ = sharded_phase(torch, kops, ref,
                                                      kernel_rows)

    # 14. the sharded train step on nccl at world size 1: qwen2.5-3b whole
    # and a full-width qwen3-moe layer against the unsharded step, then a
    # sharded checkpoint round trip
    counts_st, _ = sharded_train_phase(
        torch, kops, sum(train_record["step_ms"])
        / len(train_record["step_ms"]))

    # 15. tensor-parallel serving over model: 8b's qwen2.5-3b placed on a
    # 1x1 mesh (nccl, bit-equal), at model 2 and 4 (a process a rank over
    # gloo), and internvl2-1b's sequence-parallel prefill at model 4
    counts_tp, _ = tp_serve_phase(torch, kops, lm_outputs, family_outputs)
    del lm_outputs, family_outputs

    # the kernel phase: the kernel cases of 4-7 on untimed replays of the
    # paths, then every case's device time (a profiler session slows the
    # host's later launches, so it comes after every CUDA-event timing)
    tpcds = make_tpcds(sf=TPCDS_SF)
    dblp = make_dblp(scale=DBLP_SCALE)
    names = ("join_expand", "bloom_build", "bloom_prune_keys")
    (cold, _), calls = replay(
        torch, kops, names, counts_oj,
        lambda: extract_twice(ExtractionEngine(tpcds), oj_model))
    oj_csr = build_csr(cold.graph, oj_model, use_kernel=False)
    del cold
    _, calls_mv = replay(
        torch, kops, names, counts_mv,
        lambda: extract_twice(ExtractionEngine(dblp), mv_model))
    bloom_cases = record_bloom_calls(
        torch, kops, ref, kernel_rows,
        calls["bloom_build"] + calls_mv["bloom_build"])
    probe_cases, probe_pairs = record_probe_calls(
        torch, kops, ref, kernel_rows,
        calls["bloom_prune_keys"] + calls_mv["bloom_prune_keys"])
    # every pair expansion of 4-5 against its plain version; the largest
    # and most frequent operands of each path timed
    refresh_cases = collections.defaultdict(list)
    for path, recorded in (("JS-OJ", calls), ("JS-MV", calls_mv)):
        check_every_call(torch, kops, ref,
                         {"join_expand": recorded["join_expand"]},
                         f"{path} extraction")
        refresh_cases["join_expand"] += record_join_expand_calls(
            torch, kops, ref, kernel_rows, recorded["join_expand"],
            f"{path} extraction")
    del calls, calls_mv, recorded
    _, calls = replay(torch, kops, ["segment_counts", "frontier_expand"],
                      counts_oja,
                      lambda: analyze_oj(kops, ExtractionEngine(tpcds),
                                         oj_model))
    log("segment_counts on the operands of the JS-OJ launches:")
    segment_cases = record_segment_calls(torch, kops, ref, graph_rows,
                                         "JS-OJ", calls["segment_counts"])
    log("frontier_expand on the operands of the k-hop launches:")
    frontier_cases = record_frontier_calls(torch, kops, ref, graph_rows,
                                           calls["frontier_expand"])
    (pr, _), calls = replay(torch, kops, ["segment_counts"], counts_mva,
                            lambda: analyze_mv(ExtractionEngine(dblp),
                                               mv_model))
    mv_csr = pr.csr
    del pr
    log("segment_counts on the operands of the JS-MV launches:")
    segment_cases += record_segment_calls(torch, kops, ref, graph_rows,
                                          "JS-MV", calls["segment_counts"])
    del calls
    # phase 9's delta refreshes and phase 10's discoveries: every launch
    # against its plain version, the largest and most frequent operands
    # timed
    for kernel, cases in dj_cases.items():
        refresh_cases[kernel] += cases

    def replays():        # one path's recorded operands alive at a time
        for path, calls in replay_refresh(torch, kops, ExtractionEngine,
                                          delta_counts,
                                          counts_mv_ref).items():
            yield (f"{path} delta refresh"
                   + (f"es 1-{len(delta_counts)}" if path == "JS-OJ"
                      else ""), calls)
        for path, calls in replay_discovery(torch, kops, ExtractionEngine,
                                            counts_disc).items():
            yield f"{path} discovery", calls

    for where, calls in replays():
        check_every_call(torch, kops, ref, calls, where)
        refresh_cases["sorted_probe"] += record_sorted_probe_calls(
            torch, kops, ref, kernel_rows, calls["sorted_probe"], where)
        refresh_cases["join_expand"] += record_join_expand_calls(
            torch, kops, ref, kernel_rows, calls["join_expand"], where)
        refresh_cases["bloom_build"] += record_bloom_calls(
            torch, kops, ref, kernel_rows, calls["bloom_build"], where)
        cases, pairs = record_probe_calls(
            torch, kops, ref, kernel_rows, calls["bloom_prune_keys"], where)
        refresh_cases["bloom_probe"] += cases
        probe_pairs += pairs
    del calls
    torch.cuda.empty_cache()

    log("device times (torch.profiler), every case above:")
    for kernel, (_, _, cases) in join_cases(torch, kops, ref,
                                            fact_np).items():
        add_device_times(torch, kernel_rows, kernel, cases)
    add_device_times(torch, kernel_rows, "bloom_build", bloom_cases)
    add_device_times(torch, kernel_rows, "bloom_probe", probe_cases)
    for kernel, cases in refresh_cases.items():
        add_device_times(torch, kernel_rows, kernel, cases)
    add_pair_device_times(torch, kernel_rows, probe_pairs)
    add_spec_device_times(torch, kops, graph_rows,
                          oj_graph_specs(torch, ref, oj_csr))
    add_spec_device_times(torch, kops, graph_rows,
                          mv_graph_specs(torch, ref, mv_csr))
    add_device_times(torch, graph_rows, "segment_counts", segment_cases)
    add_device_times(torch, graph_rows, "frontier_expand", frontier_cases)
    add_device_times(torch, flash_rows, "flash_attention",
                     flash_cases(torch, kops, ref))
    del bloom_cases, probe_cases, probe_pairs, segment_cases, \
        frontier_cases, refresh_cases, dj_cases, tpcds, dblp, oj_csr, \
        mv_csr
    torch.cuda.empty_cache()
    profile_train_step(torch)

    by_path = {"js_oj": counts_oj, "js_mv": counts_mv,
               "js_oj_analytics": counts_oja, "js_mv_analytics": counts_mva,
               "lm_serve": counts_lm, **counts_families,
               "js_oj_refresh": counts_oj_ref,
               "js_mv_refresh": counts_mv_ref, **counts_disc,
               "graph_service": counts_svc, **counts_train,
               "distributed_join": counts_dj, "sharded_moe": counts_ep,
               "sharded_train": counts_st, "tp_serve": counts_tp}
    kernel_rows += graph_rows + flash_rows
    untimed = [(row["name"], case["shape"]) for row in kernel_rows
               for case in row["cases"] if case["device_ms"] is None]
    assert not untimed, f"cases without a device time: {untimed}"
    # the probe and the pair expansion run once each in every join step
    unpaired = {p: (c["sorted_probe"], c["join_expand"])
                for p, c in by_path.items()
                if c["sorted_probe"] != c["join_expand"]}
    assert not unpaired, f"sorted_probe / join_expand launches {unpaired}"
    for row in kernel_rows:
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
