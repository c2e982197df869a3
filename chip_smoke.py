#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mpit_tpu_torch``) on one NVIDIA card.

The quickest proof that the port still starts on the GPU.  Phases, in
order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every kernel of the path, from the sources in this checkout;
3. kernels: each kernel against its plain PyTorch twin at the shapes each
   path below gives it (each must be bit-equal; K1, K2 and K3 also at the
   edges of their sweep and replayed from a CUDA graph, and ptxas must
   report no spill), then timed with CUDA events beside the twin, the
   per-launch floor and the bytes bound, cold, L2-warm and queued behind
   an elementwise PyTorch kernel as in a step: K1 (msgd
   commit), K2 (elastic force + retract), K3 (Adam), and the server's
   per-GRAD apply around K3;
4. the headline path: ``mesh_launch.run`` at the flagship configuration
   (CNN side 32, 544,522 parameters, EASGD, dp=1) for two epochs with the
   steady-state throughput leg; then three EASGD steps at dp=4 on the card
   held against the same steps on the CPU;
5. ``launch --np 1 --opt msgd`` for one epoch; then the flagship trained
   to 2% test error (10 epochs at most, stopping at the target) by the
   host loop and by the device loop (``--device_loop 1``: one CUDA-graph
   replay an epoch), both timings and ``time_to_target`` printed: bit for
   bit under deterministic cuDNN, within twice the host loop's own spread
   in the same call under its defaults (``device_loop_vs_host``); then
   ``mesh_syncdp`` (``--opt syncdp`` at the flagship CNN, lr 0.2,
   momentum 0.9, batch 128, two epochs by the host loop and by the device
   loop, one graph for every epoch: bit for bit under deterministic cuDNN)
   and ``mesh_resume`` (the flagship two epochs with ``--ckpt_dir``, then
   ``--resume auto`` to four, bit for bit as a straight four-epoch run);
6. the asynchronous parameter-server gang, every role a thread of this
   process over the in-process router (``launch.run_gang``), every shard
   and every worker on the card, at the flagship widths: DOWNPOUR np=4,
   EAMSGD np=12 (BASELINE configs 2 and 3), server-side Adam np=4,
   adam-single np=2 and comm-only EAMSGD (lr 0) np=4; then a one-worker
   Adam gang on the card held against the same gang on the CPU; then
   process gangs (``launch.launch_processes``, the ``--np N`` path: every
   rank a fresh interpreter over the port's shm transport, all on the
   card, the codec on the port's native library, ``/dev/shm`` printed):
   DOWNPOUR np=4 and EAMSGD np=12 (two epochs, samples/s printed beside
   the in-process gangs'), then side by side server-side Adam np=4, a
   DOWNPOUR np=5 gang with a tester rank (3 rounds, its checkpoint loaded
   back) and DOWNPOUR np=4 over TCP on 127.0.0.1; each child returns its
   own K1-K3 launch counts, held exact (K1 = the workers' steps at
   EAMSGD, K3 in the servers = 2 x the workers' steps under Adam, none at
   DOWNPOUR); then ``tools/torch_ptest.py``'s push/pull bandwidth over shm
   (64 MB, 2 servers + 2 clients, 10 rounds, codecs none and int8: MB/s
   and the servers' per-GRAD apply), and its observability legs at codec none in
   one more call: obs off, obs on (MB/s of each and their ratio, written
   down, never gated), and the framed ``FLAG_TIMING`` wire with traces,
   decomposed by ``obs analyze`` (every op joined);
6b. BiCNN (slice 4): ``bicnn_scale`` (``tools/torch_bicnn_scale.py`` at its
   defaults: 3,000 filters, 3,416,600 floats, two epochs of 63 steps,
   examples/s, each epoch's seconds, the warm test3, then ten steps under
   ``torch.profiler``), ``bicnn_vs_cpu`` (five ``sgd`` steps of the docqa
   model at full width, 1,365,250 floats, card against CPU) and three
   docqa process gangs over shm, every rank on the card, one epoch at
   batch 4: EAMSGD np=6 with the tester first (its checkpoint read back),
   server-side Adam np=4 (K3 in the servers = 2 x the workers' steps; the
   servers' per-GRAD apply timed at their 682,625-float shard, K3 held
   bit-equal there) and adamsingle np=4 (K3 = the workers' steps);
6c. fault tolerance (slice 5a), right after the process gangs: two
   supervised process gangs (``launch --np 4 --opt adam --transport tcp
   --ft_heartbeat_s 0.25 --ft_lease_ttl_s 20 --ft_op_deadline_s 5
   --supervise 2 --server_ckpt_dir d --server_ckpt_interval 2`` at the
   flagship widths, every child on the card) run side by side in the
   background, the supervisor SIGKILLing worker rank 3 in one and server
   rank 2 in the other once they have taken steps (the kill lands 2 s
   after the victim's server wrote its first checkpoint, and the epochs
   are sized from the process gangs' epoch); each must restart its victim once
   (the worker as epoch 1, the server from its checkpoint with Adam's m
   and v), keep both workers inside the fault-free Adam gang's test
   error, have every server process's K3 equal its own applies, and pass
   the exactly-once accounting (``ft.supervisor.grad_accounting``); the
   kill-to-rejoin time is printed.  Meanwhile this process runs
   ``ft_retry_dedup`` (two workers computing the flagship gradient on the
   card in lockstep against two Adam servers at 272,261 a shard, 8 rounds
   fault-free and under the reference's drop/dup matrix: bit for bit,
   with resends and dups, K3 = the applies and the same in both runs;
   then int8 EAMSGD workers (K1) under dropped replies, bit for bit),
   ``ft_server_restart`` (an Adam server at 272,261 applies a GRAD,
   checkpoints; a GRAD sent into the void is resent to a server restored
   onto the card: 2 applies, the resent one a DUP, the restored p, m, v
   bit-equal in storage of their own; save and restore times printed) and
   ``ft_lease_eviction`` (a silent worker evicted within 1.5x a 1 s lease,
   rejoining as epoch 1);
6d. observability (slice 5b): ``obs_lockstep_adam`` (the ``ft_retry_dedup``
   gang, fault-free, run four times in turns: obs off, then obs, the
   profile plane and ``FLAG_TIMING`` on, twice, then off: all bit for bit,
   K3 32 = 2 x 16 in each run, each on-run's applied server GRAD spans 32
   and its trace joined; each round's ms printed), then
   ``obs_timed_procs`` (``launch --np 4 --opt adam`` over shm at the
   flagship widths, 20 epochs, with ``--ft_op_deadline_s``, ``--ft_timing
   1``, ``MPIT_OBS_TRACE``, ``MPIT_OBS_PROFILE=1`` and ``MPIT_OBS_HTTP`` on
   a free base port: while it trains this process scrapes every rank's
   ``/metrics`` and ``/status`` and takes one ``top`` table; then the
   merged trace validates, ``python -m mpit_tpu_torch.obs analyze`` joins
   every op with no violation and the wire's offsets for all four
   client-server pairs, each server's applied GRAD spans equal its K3
   launches and its applies, and ``obs profile`` reads the counter tracks;
   samples/s and the decomposition's per-phase p50/p99 printed);
6e. shard control (slice 5c): ``sc_migrate_adam`` (the ``ft_retry_dedup``
   gang's two workers and two Adam servers, now shard-addressed with the
   controller as a fifth role, 8 lockstep rounds: the static map, then
   shard 1 moved live from server 1 to server 0 at round 3, then at two
   shards a server shard 3 moved at round 3 with the SHARD_STATE param
   leg cut at 256 KiB; each bit for bit its static run, K3 = the applies
   over both owners, the drain through NACK_MAP; the freeze window, the
   SHARD_STATE bytes and the RELEASE-to-DONE time printed) and
   ``sc_failover_adam`` (server 1 checkpoints its shard after round 3 and
   dies; its lease expires and server 0 ADOPTs the shard: bit for bit,
   K3 = the applies of both owners).  Beside them in the background,
   ``elastic_adam_procs`` (``launch --np 5 --elastic 1 --elastic_spares 1
   --opt adam --transport tcp --supervise 2`` at the flagship widths,
   every rank on the card: a scale-up onto the spare through the
   controller's ``/scale`` route, then a SIGTERM preemption of server rank
   2 with a 25 s grace, drained and retired; the final map tiles the
   vector, every server process's K3 equals its applies, the workers'
   test error under 0.8; the /scale-to-first-apply and SIGTERM-to-retired
   times printed), and ``tools/torch_ptest.py``'s straggler legs
   (rebalance off, then on: the map must move) and its 1 -> 2 -> 1
   elastic sweep at 16 MB;
6f. the read path (slices 5d and 5e), the open-file limit printed (and
   its soft limit lifted to the hard one): ``serve_readers_adam`` (2 Adam
   servers on the card at 272,261 a shard, one writer running 8 lockstep
   rounds of seeded GRADs, 64 READ-ONLY readers in this process over the
   port's TCP event loop, 5 whole-vector reads each, 4 MB admission
   budgets: every read bit for bit the shard at its stamped version, from
   a readerless record of the same GRADs; versions monotone; BUSY issued
   and honoured; no RetryExhausted; one device->host copy per version a
   server served, each timed among the readers and alone in the record;
   K3 = the applies) and ``cells_fabric_adam`` (one Adam server at
   544,522, 2 cells on int8 subscriptions, 32 fabric-routed readers x 6
   reads, the first cell retired by GOODBYE a third of the way in: every
   read the int8 round trip of the shard at its version, lag within 4,
   reroutes, one encode per version shipped, DELTA and FULL frames and
   DIFF bytes printed); beside them ``serve_cells_procs`` (``launch --np
   8 --opt adam --serve_readers 4 --cells 2`` over TCP, the first cell
   SIGKILLed after it served 20 reads: evicted by its upstream's lease,
   the readers failing over, the server process's K3 = its applies);
7. flash attention: K4 (forward, both output modes), K5 (fused backward)
   and K6 (two-kernel backward) against their plain twins at each LM
   path's shape and on ragged, offset pairs, in float32 and bfloat16
   (bfloat16 K4, K5 and K6 on the tensor cores, whose SASS must carry
   wgmma's HGMMA, with no spill and no wgmma serialized by ptxas), K5
   against K6, K5 and K6 each against itself (equal bits), bfloat16 K5 and
   K6 element by element and K4 on one key tile within one bf16 step,
   then timed beside the twins and PyTorch's
   ``scaled_dot_product_attention`` at the two LM shapes; then bfloat16 K6
   at the 32k LM's attention (N 8, L 32,768, D 128): K6 against the twin
   run one head at a time (one float32 (L, L) matrix per head is 4 GiB)
   and against K5 on one head, twice for equal bits, and timed beside
   SDPA and the twin;
8. the long-context LM (``lm_launch.run``): ``lm_default``
   (``LM_LAUNCH_DEFAULTS``, 20 steps), ``lm_default`` again for 3 steps
   under the other backward schedule, ``lm_longcontext`` (TinyDecoder at
   d 1,024, 8 heads, 4 layers, context 8,192, 6 steps),
   ``lm_longcontext_32k`` (the same widths at context 32,768, 3 steps,
   where the gate itself picks K6), and three small steps on the card
   held against the same steps on the CPU, with float32 and with bfloat16
   attention (bfloat16 twice: under the gate's K5 and forced to K6);
   then ``lm_resume``: ``LM_LAUNCH_DEFAULTS`` 6 steps straight against 3
   steps with ``--ckpt_dir`` and ``--resume auto`` to 6, equal losses and
   state;
8b. hierarchical aggregation and the LM through the gang (slices 5g and
   7b), every rank on the card: ``agg_lockstep_adam`` (4 clients in two
   colocated groups reduce through a fanin-2 REDUCE tree onto 2 Adam
   servers at 544,522 floats, 8 lockstep rounds, at codecs none (traced:
   ``obs analyze``'s aggregation line) and int8, and int8 with REDUCE
   frames and acks dropped and duplicated: the servers' params bit for bit
   a flat client pushing the fixed-order fold, every group fold on the
   card bit for bit the host fold of its tickets, K3 = each server's
   applies = 8; REDUCE bytes and fold ms printed), ``lm_gang_flagship``
   (``bench_lm``'s headline at ``lm_default``'s widths, 1,971,200 floats:
   2 rmsprop servers on the 3:2 weighted cut, 2 workers through the tree,
   int8, 64 KiB chunks, 20 steps: the losses fall, no server holds 75% of
   the footprint, K4 and K5 exact; tokens/s printed) and
   ``lm_gang_adam_vs_cpu`` (one worker, 2 Adam servers, 3 steps on the card
   twice, bit for bit, and on the CPU, within ``LM_LIMITS["float32"]``, per
   element within ``LM_GANG_ADAM_MAX_ABS_SHARE``; the first apply on each
   shard shows why: gradients within ``LM_LIMITS["float32"]``, K3 bit for bit
   its twin, each step gap within Adam's slope near 0 times its gradient gap);
   beside them ``lm_agg_procs`` (``launch --np 6 --lm 1 --lm_weights 3,1,2
   --agg tree`` at the same widths, 10 steps: each child's K4 and K5 exact)
   and ``tools/torch_ptest.py``'s aggregation A/B and LM legs;
8c. ring attention and ``lm_launch --sp`` on one card (slice 7c), the ring's
   4 ranks virtual on the card: ``ring_kernels`` (lm_longcontext's attention,
   bf16, zigzag and contiguous: the flash ring's output against the plain
   ring's, its grads against the same backward ring over the pairs' twin on
   its own (o, lse), both against flash_attention at sp 1, under the bf16 row
   rule; the contiguous ring also forced to K6; K4 once a live pair, K5 once
   and K6 twice), wholly masked pairs (every key after every query) on K4's
   partial mode, K5 and K6 in float32 and bfloat16, their outputs allocated
   over NaN: the twin's exact zeros; the collectives bit for bit their
   definitions; then ``lm_ring_longcontext`` (``lm_longcontext`` at ``--sp 4
   --layout zigzag``: K4 and K5 36 a layer a pass), ``lm_ring_contiguous_k6``
   (``--layout contiguous``, 3 steps, K6 forced: K4 16, K6 2 x 16),
   ``lm_ring_vs_local`` (the first window's loss against
   ``lm_longcontext``'s; ``--sp 4`` in float32 at lm_vs_cpu's widths, both
   layouts, card against the CPU under ``LM_LIMITS["float32"]``) and
   ``measure_ps_pushpull(64)``'s MB/s;
8d. multi-card parallelism on the card's virtual ranks (slice 9), at
   ``lm_longcontext``'s widths (``parallel_phases``): ``tp_mlp_longcontext``
   and ``tp_attn_longcontext`` (tp 4: the forward and the weights' grads
   against the unsplit MLP and attention on the card within ``PAR_RTOL``;
   the attention's heads bit for bit, K4 once a call and K5 once),
   ``pp_decoder_longcontext`` (its 4 blocks as 4 stages over 4 microbatches
   of one row: the output bit for bit the blocks in sequence, K4 and K5 16),
   ``ep_moe_longcontext`` (8 experts, 2 a rank, against ``moe_reference``;
   no kernel), ``lm_dp2_sp4_longcontext`` (``--dp 2 --sp 4``, batch 2,
   against ``--dp 1``: losses, state and launches equal),
   ``mesh_shard2`` (the flagship at ``--dp 4 --shard 2`` against
   ``--shard 1``: bits and K1 equal) and ``pg_group_of_one`` (a child
   forms an NCCL group of one, all-reduces on the card, shuts down);
8e. meshes over a group of two processes sharing the card (slice 9b,
   ``multiproc_phases``): first a one-process control
   (``mp_vmap_control``: the flagship CNN's worker gradients in a ``vmap``
   over four rows and over two, under deterministic cuDNN) says whether a
   row's bits depend on the ``vmap`` width; then the one-process controls
   here, and one pair of processes, both on the card, running the
   launchers' CLI in turn, each run over a group of its own (gloo,
   asserted), ``dp`` cut across the two: ``mp_easgd`` (the flagship CNN at
   ``--dp 4 --su 2``, 2 epochs with ``--ckpt_dir``) and
   ``mp_easgd_resume`` (that checkpoint resumed to 4 epochs by the pair and
   by one process): each process's rows of w, vt and k, the center and
   every epoch against one process at ``--dp 4``, bit for bit, or within
   K1's tolerances where the control shows the width moving bits, each
   exchange timed with its bytes; ``mp_syncdp_linear`` (``--opt syncdp`` at
   ``--dp 2``, batch 128: within ``MP_LOSS_RTOL`` of one process) and
   ``mp_syncdp_cnn`` (the same with the CNN: bit for bit one process
   computing the pair's arithmetic, two half-batch means averaged); and
   ``mp_lm`` (``lm_launch --dp 2`` at ``lm_default``'s widths, 5 steps,
   bfloat16 attention: within ``LM_LIMITS["float32"]`` of one process);
   both processes' replicas alike; each child's K1 and K4-K6 launches equal
   the one-process run's; each child's start-up printed; then every axis
   across processes (slice 9c): the pair also runs ``mp_shard`` (the
   flagship CNN's EASGD at ``--dp 1 --shard 2``, each process owning one of
   the center's shards: against one process within K1's tolerances, bit
   for bit printed) and ``mp_lm_sp`` (``lm_longcontext``'s widths at ``--sp
   2``, zigzag, 4 steps: against one process under
   ``LM_LIMITS["bfloat16"]``), and one quartet of children runs
   ``mp_lm_dp_sp`` (``lm_default`` at ``--dp 2 --sp 2``, 4 steps, under
   ``LM_LIMITS["float32"]``); each child's K4 and K5/K6 launches are its
   ``sp`` rank's share of the ring's pairs, an ``sp`` line's shares adding
   up to the one-process count, and the ring's hops between processes are
   timed with their bytes and their path (gloo: host copies);
9. static analysis (slice 8, ``analysis_phases``): the port's analyzer
   (``mpit_tpu_torch.analysis``, which reads source) over
   ``mpit_tpu_torch/`` on this host under ``mtlint_torch.toml``: no
   unsuppressed finding, no unused baseline entry, no stale or violated
   declaration, findings per family and seconds printed; then the sync
   audit: every ``torchrules.HOT_PATHS`` row called on the card once warm,
   once under ``torch.cuda.set_sync_debug_mode("warn")`` counting syncs and
   once under ``"error"`` (a sync raises out of the script) — the msgd
   lookahead, commit (K1) and step, EAMSGD's ``elastic_step`` (K2), the
   Adam rule (K3), ``HbmSlot.apply_wire`` with a frame on the card at
   codecs none and int8 (K3), ``MeshEASGD.step`` uncaptured (K1) and one
   ``lm_launch`` ``train_step`` at ``lm_default`` (K4, K5, K1) — then
   ``mesh_launch --device_loop 1`` at the flagship for two epochs, every
   replay of its captured epoch graphs under the mode; a control first
   shows the mode catching a known sync; every kernel's launches exact.

The kernels' launch counters are set to 0 just before each path and read
just after it: a path that did not launch each of its kernels exactly as
often as its steps (or its servers' applies, or its layers) say fails,
and so does one that launched a kernel it should not.  A counter moves
where the wrapper launches its kernel, and a CUDA graph replays launches
without calling the wrapper: on the device loop the counter must be the
warm-up's steps plus each graph's steps (captured once) plus the
throughput leg's, from the steps and graphs the run reports; and on one
device-loop run ``torch.profiler`` reads K1's kernels that ran on the
card, graph replays included, which must be the run's steps plus the
warm-up's.  The last two lines
are one JSON object describing every kernel (``launches`` is the count of
the kernel's main path: the headline for K1, comm-only EAMSGD for K2,
server-side Adam for K3, and for K4-K6 the first LM path that launched
them, as each path's gate picked the schedule (see ``fa_entries``: K4 and
K5 ``lm_longcontext``, K6 ``lm_longcontext_32k``);
``paths`` holds every path's launches and steps), and ``{"ok": true,
"device": {...}}``.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, NVIDIA data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores, NVIDIA data sheet
TIMED_LAUNCHES = 200
L2_BYTES = 50e6  # H100 L2 cache
# The hold of a queued timing: 2e8 clock cycles last at least 0.1 s at
# clocks up to 2 GHz (the H100's boost clock is 1.98 GHz).
HOLD_CYCLES = 200_000_000
HOLD_S_MIN = HOLD_CYCLES / 2.0e9
# Calls queued behind the hold: few enough that the launch queue (about a
# thousand kernels) never fills while the device sleeps.
QUEUED_CALLS = 100
# Limits of the dp=4 card-vs-CPU comparison (see easgd_dp4): the largest
# elementwise gap, and the gap's norm over the norm of the three steps'
# change to the state.
DP4_MAX_ABS_GAP = 2e-6
DP4_GAP_OVER_CHANGE = 1e-3
# Limits of the one-worker Adam gang's card-vs-CPU comparison (see
# adam_gang_vs_cpu).
ADAM_MAX_ABS_GAP = 3e-4
ADAM_GAP_OVER_CHANGE = 1e-3
# The flagship widths every gang path runs at (BASELINE configs 2-3).
GANG_BASE = dict(model="cnn", side=32, batch=128, device="cuda")
# BASELINE configs 2 and 3 (su 10, not 100, which would sync once in 22
# steps), in threads of this process and as process gangs alike.
PS_CONFIGS = {
    "ps_downpour_np4": dict(opt="downpour", lr=1e-2, su=1, epochs=2),
    "ps_eamsgd_np12": dict(opt="eamsgd", lr=1e-2, mom=0.99, mva=0.15, su=10,
                           epochs=2),
}
# Flash attention against its twins (see check_flash).  float32 inputs:
# the reference's tolerances (tests/test_ops.py), atol 2e-5 forward, 3e-5
# backward, 3e-4 on a ragged, offset pair.  The partials acc and l are
# sums of up to Lk terms p*v and p (p <= 1), so their rounding grows with
# l: acc is held as acc / l (the twin's l) at the forward tolerance, and l
# to FA_PARTIAL_RTOL of itself.
# bfloat16 inputs.  m, lse and l are float32 functions of float32 scores
# that kernel and twin compute from the same bf16 values, and neither
# rounds them to bf16: they keep the float32 limits.  o, acc and the grads
# depend on P and dS rounded to bf16, and o and the grads are themselves
# rounded to bf16.  Two effects part kernel and twin there:
# - K4 rounds P = exp(s - m) tile by tile with its running max m, the
#   twin with the row's final max; on a row whose max rises after its
#   first key tile the two round each P element independently (a gap of up
#   to 2**-8 of p, about 2**-9 rms), which moves acc / l by about 2**-9 of
#   its row (the gaps of the terms add as a random walk, as the terms do).
#   The backward rounds P = exp(s - lse) and dS from the same lse in both,
#   so only a score a few float32 ulps apart flips a rounding there;
# - a bf16 output lands one bf16 step away (at most 2**-7 of itself) where
#   the two float32 values straddle a rounding point.
# So those outputs are held row by row, over the D elements of one output
# row of one head: ||gap|| <= FA_BF16_ROW ||twin's row|| + atol sqrt(D),
# and each element |gap| <= 2**-7 |twin| + FA_BF16_ELEM rms(twin's row) +
# atol.  A lost key tile of 64 moves a row of o by about sqrt(64 / L) of
# it (1/11 at L 8,192), a lost q tile all of a dK or dV row's share from
# it, each far past 2**-6.  bf16 K4, K5 and K6 run on the tensor cores, not
# on the float32 kernels' code, so tighter checks hold them elementwise
# where kernel and twin round the same values.  On random inputs the two
# sum a score's D products in another order, a score lands an ulp apart
# now and then, and P or dS rounds to the neighbouring bf16 value (a
# measured 1.03-1.25 of the one-step limit at lm_default).  So the tight
# checks run on inputs whose scores and dP are exact in float32 whatever
# the order (fa_exact: multiples of 1/16 in [-2, 2], so every product is
# a multiple of 2**-8 below 4 and a sum of up to 128 of them fits 24
# bits); there kernel and twin round the same P and dS:
# - K5 and K6 at every FA_CASES shape: every element of dq, dk and dv lies
#   within one bf16 step of the twin, 2**-7 |twin| + atol (FA_BF16_STEP;
#   atol the backward's, or the pair's on offset pairs);
# - K4 on FA_ONE_TILE, where every key fits one 128-key tile of the kernel:
#   there the running max is the final max, so o and acc / l keep the same
#   one-step rule, in both output modes.
# And K5 and K6 run twice on the same inputs give the same bits (no
# atomics).
FA_FWD_ATOL, FA_BWD_ATOL, FA_PAIR_ATOL = 2e-5, 3e-5, 3e-4
FA_PARTIAL_RTOL = 1e-5
FA_BF16_ROW, FA_BF16_ELEM = 2.0**-6, 2.0**-5
FA_BF16_STEP = 2.0**-7
# Limits of the LM's card-vs-CPU comparison (see lm_vs_cpu), by attention
# dtype: the largest elementwise gap of w and vt (absolute, or as a share
# of the largest change), the gap's norm over the norm of the three
# steps' change, and the per-step losses' relative gap.
# float32: the devices differ by summation order only (cuBLAS's f32
# products with TF32 off, the kernels' online softmax against the twins'
# one-pass softmax), which leaves each gradient a few f32 ulps apart,
# about 1e-6 of itself, so the change (at most ~6 x lr x |g| per element,
# lr 1e-3) differs by some 1e-9 absolute.
# bfloat16: the kernels round P with their running max and the twins with
# the final one (about 2**-9 of an attention output row, see FA_BF16_ROW),
# and q, k, v a few ulps apart now and then round to neighbouring bf16
# values (2**-8 of an element), so the gradients, and the three steps'
# change, differ by at most about 2**-8 of themselves: 2**-5 leaves 8x.
# The first step's loss, from the same w0, moves by the outputs' 2**-9.
# Either way a dropped or doubled step moves w by a third of the change,
# and a wrong attention tile the gradient by percents.
LM_LIMITS = {
    "float32": {"max_abs_gap": 1e-6, "gap_over_change": 1e-3, "loss_rtol": 1e-5},
    "bfloat16": {"max_abs_share": 2.0**-5, "gap_over_change": 2.0**-5,
                 "loss_rtol": 2.0**-8},
}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, queued=False, kernels_per_call=1, n=None) -> float:
    """Mean ms per call of ``fn()`` on the current stream, by CUDA events
    after a warm-up.  ``queued``: the stream is held by a sleep kernel while
    the host queues the calls, so the events see the device time of
    back-to-back launches, without the host's per-call overhead; otherwise
    the time is that of calls issued from a host loop, as a training step
    issues them.  ``kernels_per_call`` (a plain twin's several PyTorch
    kernels) shortens the queued run so the launch queue never fills.
    ``n`` caps the calls timed (long kernels)."""
    n_max = QUEUED_CALLS // kernels_per_call if queued else TIMED_LAUNCHES
    n = n_max if n is None else max(1, min(n, n_max))
    for _ in range(min(5, n)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    host_s = time.perf_counter() - t0
    end.synchronize()
    ms = start.elapsed_time(end) / n
    if queued and host_s > HOLD_S_MIN:
        raise AssertionError(f"the host queued {n} calls in {host_s:.4f}s, "
                             "longer than the hold: the device time would "
                             "include host gaps")
    return ms


def rotating(fn, sets):
    """``fn`` over buffer sets in turn: together they exceed the 50 MB L2,
    so every call finds its operands in device memory, as a training step
    does after the forward and backward passes."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def n_sets(set_bytes):
    """How many buffer sets of ``set_bytes`` together exceed twice the L2."""
    return max(2, math.ceil(2 * L2_BYTES / set_bytes))


def launch_floor_ms(torch) -> float:
    """The fixed cost of one launch on the device: ``torch.cuda._sleep(1)``
    queued behind a hold, as the kernels are timed."""
    return time_ms(torch, lambda: torch.cuda._sleep(1), queued=True)


def behind_ms(torch, fn, pre):
    """Device ms that ``fn()`` adds when each call is queued behind
    ``pre()``, a PyTorch kernel, as a training step queues a sweep: the
    pairs' time less ``pre`` alone, both queued behind a hold."""
    pair = time_ms(torch, lambda: (pre(), fn()), queued=True, kernels_per_call=2)
    return pair - time_ms(torch, pre, queued=True)


def timed_entry(torch, kernel, plain, sets, n_bytes, n_ops, plain_kernels):
    """Times of ``kernel`` and ``plain`` (which launches ``plain_kernels``
    PyTorch kernels a call) over rotating buffer ``sets`` (``ms``: device
    time, every launch finding its operands in device memory), of
    ``kernel`` on the first set alone (``warm_ms``: operands in the L2, as
    an MNIST step's 2.18 MB vectors can find theirs), of ``kernel`` queued
    behind an elementwise PyTorch kernel on a vector of the first
    operand's size (``behind_ms``), the per-launch floor, and the bound of
    the work: ``n_bytes`` moved at the HBM rate or ``n_ops`` f32
    operations at the peak rate, whichever is longer."""
    warm = functools.partial(kernel, *sets[0])
    kernel, plain = rotating(kernel, sets), rotating(plain, sets)
    scratch = torch.zeros_like(sets[0][0])
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOPS * 1e3
    return {
        "ms": time_ms(torch, kernel, queued=True),
        "warm_ms": time_ms(torch, warm, queued=True),
        "behind_ms": behind_ms(torch, kernel, lambda: scratch.add_(1.0)),
        "floor_ms": launch_floor_ms(torch),
        "call_ms": time_ms(torch, kernel),
        "plain_ms": time_ms(torch, plain, queued=True, kernels_per_call=plain_kernels),
        "plain_call_ms": time_ms(torch, plain),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def offset_copy(torch, t, offset):
    """A copy of ``t`` that starts ``offset`` floats into a buffer of its own
    (``offset % 4 != 0``: not on 16 bytes)."""
    buf = torch.empty(offset + t.numel(), device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


# The edges of K1's and K3's sweep (csrc/fused_update.cu), each (rows, n,
# offsets of the operands within their buffers): lengths below, at and
# past one 16-byte chunk (the scalar path alone, then a scalar tail); an
# odd length and views 1-3 floats into their buffers at the main path's
# size (a scalar head and tail around the chunks); operands at different
# offsets (no common chunk grid: the scalar path alone); rows whose
# boundaries fall inside a chunk.  rows 0: the 1-D form.
def sweep_edges(n_mesh):
    return ((0, 1, 0), (0, 3, 0), (0, 4, 0), (0, 5, 0), (0, 17, 0),
            (1, n_mesh + 1, 1), (1, n_mesh, 3), (4, n_mesh, 2),
            (1, n_mesh, (0, 1, 2, 3)), (3, 1025, 0), (0, n_mesh + 3, 0))


def check_k1(torch, n_mesh, n_msgd, n_bicnn=()):
    """K1 against its twin at the shapes each driven path gives it; returns
    the kernel's entry for the closing JSON line (times at 1 x n_mesh, no
    retract: the commit of nine steps in ten on the headline path).
    ``n_bicnn``: the BiCNN trainers' 1-D lengths, held bit-equal untimed."""
    from mpit_tpu_torch.ops.fused_update import (
        fused_nesterov_commit, fused_nesterov_commit_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    rows_out = []
    # (rows, form, n, retract variants): MeshEASGD's (dp, n) rows at dp=1
    # and dp=4, plain and with the sync round's retract; and the 1-D form
    # with a 0-d clr that `launch --np 1 --opt msgd` gives it at its own
    # model's size, never with a retract.
    for rows, form, n, retracts in ((1, "rows", n_mesh, (False, True)),
                                    (4, "rows", n_mesh, (False, True)),
                                    (1, "1-D", n_msgd, (False,))):
        w, vt, g, sug = (torch.randn(rows, n, device=dev, generator=gen)
                         for _ in range(4))
        sug.mul_(1e-2)
        clr = torch.tensor([0.01, 0.02, 0.03, 0.04][:rows], device=dev)
        if form == "1-D":
            w, vt, g, sug, clr = w[0], vt[0], g[0], sug[0], clr[0]
        for retract in retracts:
            s = sug if retract else None
            for l2wd in (0.0, 1e-4):
                want_w, want_vt = fused_nesterov_commit_reference(
                    w, vt, g, clr, l2wd=l2wd, sug=s)
                kw, kvt = w.clone(), vt.clone()
                fused_nesterov_commit(kw, kvt, g, clr, l2wd=l2wd, sug=s)
                torch.cuda.synchronize()
                err = max(float((kw - want_w).abs().max()),
                          float((kvt - want_vt).abs().max()))
                max_err = max(max_err, err)
                if not (torch.equal(kw, want_w) and torch.equal(kvt, want_vt)):
                    raise AssertionError(
                        f"K1 differs from its twin: rows={rows} {form} "
                        f"sug={retract} l2wd={l2wd} max_abs_err={err}")
            elems = rows * n
            # w, vt and g (and sug) read; w and vt written.  The twin runs
            # clr*g, w - step, vt - step (and - sug): one kernel each.
            n_vecs = 4 if retract else 3
            sets = [(w.clone(), vt.clone(), g.clone(), None if s is None else s.clone())
                    for _ in range(n_sets(n_vecs * 4 * elems))]
            times = timed_entry(
                torch, lambda a, b, c, d: fused_nesterov_commit(a, b, c, clr, sug=d),
                lambda a, b, c, d: fused_nesterov_commit_reference(a, b, c, clr, sug=d),
                sets, (n_vecs + 2) * 4 * elems, n_vecs * elems, plain_kernels=n_vecs)
            rows_out.append({"rows": rows, "form": form, "n": n, "sug": retract,
                             **times})
            del sets
    # BiCNN's MSGD (sgd, and eamsgd with its retract) commits the whole
    # 1-D vector with a 0-d clr and the trainer's weight decay (1e-6,
    # about 5e-9 of w a step: held bit-equal, so a dropped l2wd shows).
    for n in n_bicnn:
        w, vt, g, sug = (torch.randn(n, device=dev, generator=gen) for _ in range(4))
        sug.mul_(1e-2)
        clr = torch.tensor(0.05, device=dev)
        for l2wd, s in ((0.0, None), (1e-6, None), (0.0, sug), (1e-6, sug)):
            want_w, want_vt = fused_nesterov_commit_reference(w, vt, g, clr, l2wd=l2wd, sug=s)
            kw, kvt = w.clone(), vt.clone()
            fused_nesterov_commit(kw, kvt, g, clr, l2wd=l2wd, sug=s)
            torch.cuda.synchronize()
            err = max(float((kw - want_w).abs().max()),
                      float((kvt - want_vt).abs().max()))
            max_err = max(max_err, err)
            if not (torch.equal(kw, want_w) and torch.equal(kvt, want_vt)):
                raise AssertionError(f"K1 differs from its twin: BiCNN 1-D n={n} "
                                     f"sug={s is not None} l2wd={l2wd} max_abs_err={err}")
        del w, vt, g, sug
    # The sweep's edges, in every variant: bit-equal to the twin.
    for rows, n, offsets in sweep_edges(n_mesh):
        offsets = offsets if isinstance(offsets, tuple) else (offsets,) * 4
        shape = (n,) if rows == 0 else (rows, n)
        w, vt, g, sug = (offset_copy(torch, torch.randn(shape, device=dev, generator=gen), o)
                         for o in offsets)
        clr = (torch.tensor(0.02, device=dev) if rows == 0
               else torch.linspace(0.01, 0.04, rows, device=dev))
        for l2wd, s in ((0.0, None), (1e-4, None), (0.0, sug), (1e-4, sug)):
            want_w, want_vt = fused_nesterov_commit_reference(w, vt, g, clr, l2wd=l2wd, sug=s)
            kw, kvt = offset_copy(torch, w, offsets[0]), offset_copy(torch, vt, offsets[1])
            fused_nesterov_commit(kw, kvt, g, clr, l2wd=l2wd, sug=s)
            torch.cuda.synchronize()
            if not (torch.equal(kw, want_w) and torch.equal(kvt, want_vt)):
                raise AssertionError(f"K1 differs from its twin: shape={shape} "
                                     f"offsets={offsets} sug={s is not None} l2wd={l2wd}")
    print("K1 shapes: " + json.dumps(rows_out))
    main_row = rows_out[0]
    return {
        "name": "fused_nesterov_commit",
        "route": "cuda",
        "source": "mpit_tpu_torch/ops/csrc/fused_update.cu",
        "replaces": "mpit_tpu/ops/fused_update.py:81",
        "launches": None,  # set from the headline run
        "paths": {},  # launches and steps of every driven path
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "warm_ms": main_row["warm_ms"],
        "behind_ms": main_row["behind_ms"],
        "call_ms": main_row["call_ms"],
        "floor_ms": main_row["floor_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes K1
    }


def check_k2(torch, n_path):
    """K2 bit-equal to its twin at the comm-only EAMSGD path's length, one
    float longer (the scalar tail) and at the sweep's edges (K3's; ``w``
    at each edge's offset, whose ``sug`` the wrapper allocates at the same
    offset, and the center at that offset and at another); timed at the
    path's length as the path calls it.  Returns the kernel's entry for
    the closing line."""
    from mpit_tpu_torch.ops.fused_update import fused_elastic, fused_elastic_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    mva = 0.45  # ps_eamsgd_lr0_np4's
    max_err = 0.0
    edges = [(n, o if isinstance(o, int) else o[:2])
             for r, n, o in sweep_edges(n_path) if r <= 1]
    for n, offsets in [(n_path, 0), (n_path + 1, 0), *edges]:
        offsets = (offsets,) * 2 if isinstance(offsets, int) else offsets
        w, c = (offset_copy(torch, torch.randn(n, device=dev, generator=gen), o)
                for o in offsets)
        want_w, want_sug = fused_elastic_reference(w, c, mva)
        for c_offset in (offsets[1], (offsets[1] + 1) % 4):
            kw, kc = offset_copy(torch, w, offsets[0]), offset_copy(torch, c, c_offset)
            _, sug = fused_elastic(kw, kc, mva)
            torch.cuda.synchronize()
            err = max(float((kw - want_w).abs().max()), float((sug - want_sug).abs().max()))
            max_err = max(max_err, err)
            if not (torch.equal(kw, want_w) and torch.equal(sug, want_sug)):
                raise AssertionError(f"K2 differs from its twin at n={n} offsets={offsets} "
                                     f"center at {c_offset}: max_abs_err={err}")
    sets = [tuple(torch.randn(n_path, device=dev, generator=gen) for _ in range(2))
            for _ in range(n_sets(8 * n_path))]
    # w and c read, w and sug written; the twin runs w - c, mva * d, w - sug.
    times = timed_entry(torch, lambda a, b: fused_elastic(a, b, mva),
                        lambda a, b: fused_elastic_reference(a, b, mva),
                        sets, 16 * n_path, 3 * n_path, plain_kernels=3)
    print("K2 shapes: " + json.dumps([{"n": n_path, **times}]))
    return {
        "name": "fused_elastic", "route": "cuda",
        "source": "mpit_tpu_torch/ops/csrc/fused_update.cu",
        "replaces": "mpit_tpu/ops/fused_update.py:220",
        "launches": None, "paths": {}, "max_abs_err": max_err,
        "ms": times["ms"], "warm_ms": times["warm_ms"], "behind_ms": times["behind_ms"],
        "call_ms": times["call_ms"], "floor_ms": times["floor_ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        # torch.lerp(w, c, mva) gives the retracted w but not sug.
        "library_ms": None,
    }


def check_k3(torch, n_shard, n_full, n_bicnn=()):
    """K3 bit-equal to its twin at the server's shard (np=4) and at the
    whole vector (adam-single), at a length that is not a multiple of 4
    and at ``n_bicnn``, BiCNN's lengths (a server's shard at np=4 and the
    whole docqa vector under adamsingle); timed at both path lengths, beside the server's whole per-GRAD
    apply at the shard's length (the frame's copy to the card, the device
    step counter and lr_t, K3).  Returns the kernel's entry (times at the
    server's shard, its main path)."""
    import numpy as np

    from mpit_tpu_torch.ops.fused_update import fused_adam, fused_adam_reference
    from mpit_tpu_torch.optim import rules

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    lr_t = torch.tensor(1e-3 * math.sqrt(1 - 0.999) / (1 - 0.9), device=dev)
    max_err = 0.0
    rows = []
    # The two path lengths (timed), then the sweep's edges.
    edges = [(n, (o,) * 4 if isinstance(o, int) else o)
             for r, n, o in sweep_edges(n_full) if r <= 1]
    for n, offsets in [(n_shard, (0,) * 4), (n_full, (0,) * 4),
                       (n_shard + 2, (0,) * 4), (4 * n_full, (0,) * 4),
                       *((n, (0,) * 4) for n in n_bicnn), *edges]:
        p, g, m, v = (offset_copy(torch, torch.randn(n, device=dev, generator=gen), o)
                      for o in offsets)
        v.abs_()
        want = fused_adam_reference(p, g, m, v, lr_t)
        kp, km, kv = (offset_copy(torch, x, offsets[i]) for i, x in ((0, p), (2, m), (3, v)))
        fused_adam(kp, g, km, kv, lr_t)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip((kp, km, kv), want))
        max_err = max(max_err, err)
        if not all(torch.equal(a, b) for a, b in zip((kp, km, kv), want)):
            raise AssertionError(f"K3 differs from its twin at n={n} offsets={offsets}: "
                                 f"max_abs_err={err}")
        if n not in (n_shard, n_full) or offsets != (0,) * 4:
            continue
        sets = [tuple(x.clone() for x in (p, g, m, v)) for _ in range(n_sets(16 * n))]
        times = timed_entry(
            torch, lambda a, b, c, d: fused_adam(a, b, c, d, lr_t),
            lambda a, b, c, d: fused_adam_reference(a, b, c, d, lr_t),
            sets, 28 * n, 12 * n, plain_kernels=12)
        rows.append({"n": n, **times})
    # The server's per-GRAD apply at the shard's length: the GRAD frame's
    # copy from host staging to the card, then the adam rule (step
    # counter, lr_t, K3), as ParamServer._recv_grad runs it.
    rule = rules.make("adam", lr=1e-3)
    frame = np.random.default_rng(3).standard_normal(n_shard, dtype=np.float32)
    shard = torch.randn(n_shard, device=dev, generator=gen)
    state = rule.init(shard)

    def frame_copy():
        return torch.from_numpy(frame).to(dev, copy=True)

    def server_apply():
        rule.apply(shard, frame_copy(), state)

    rows[0]["server_apply_call_ms"] = time_ms(torch, server_apply)
    rows[0]["frame_copy_call_ms"] = time_ms(torch, frame_copy)
    print("K3 shapes: " + json.dumps(rows))
    main_row = rows[0]
    return {
        "name": "fused_adam", "route": "cuda",
        "source": "mpit_tpu_torch/ops/csrc/fused_update.cu",
        "replaces": "mpit_tpu/ops/fused_update.py:157",
        "launches": None, "paths": {}, "max_abs_err": max_err,
        "ms": main_row["ms"], "warm_ms": main_row["warm_ms"],
        "behind_ms": main_row["behind_ms"],
        "call_ms": main_row["call_ms"], "floor_ms": main_row["floor_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        # torch.optim's fused Adam places eps after dividing sqrt(v) by
        # sqrt(1 - beta2^t) and corrects the bias itself: another function.
        "library_ms": None,
    }


def check_graph_replay(torch, n_mesh, n_shard):
    """K1 (the headline's commit with the retract and l2wd, and dp=4's four
    rows), K2 (comm-only EAMSGD's vector, ``sug`` the graph's own output)
    and K3 (a server's shard) captured once in a CUDA graph and replayed
    three times, lr_t and the center rewritten on the card before each
    replay: bit-equal to three eager launches.  A host sync or an
    allocation on the card in the call path would break the capture."""
    from mpit_tpu_torch.ops.fused_update import (
        fused_adam, fused_elastic, fused_nesterov_commit)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    w1, vt1, g1, sug1 = (torch.randn(1, n_mesh, device=dev, generator=gen) for _ in range(4))
    w4, vt4, g4 = (torch.randn(4, n_mesh, device=dev, generator=gen) for _ in range(3))
    p, g, m, v = (torch.randn(n_shard, device=dev, generator=gen) for _ in range(4))
    v.abs_()
    clr1 = torch.tensor([0.01], device=dev)
    clr4 = torch.tensor([0.01, 0.02, 0.03, 0.04], device=dev)
    we, center = (torch.randn(n_mesh, device=dev, generator=gen) for _ in range(2))
    lr_t = torch.empty((), device=dev)
    lrs = (1e-3, 2e-3, 5e-4)
    centers = [torch.randn(n_mesh, device=dev, generator=gen) for _ in lrs]

    def step(st):
        fused_nesterov_commit(st[0], st[1], g1, clr1, l2wd=1e-4, sug=sug1)
        fused_nesterov_commit(st[2], st[3], g4, clr4)
        fused_adam(st[4], g, st[5], st[6], lr_t)
        return fused_elastic(st[7], center, 0.45)[1]

    state = (w1, vt1, w4, vt4, p, m, v, we)
    eager = [x.clone() for x in state]
    for lr, c in zip(lrs, centers):
        lr_t.fill_(lr)
        center.copy_(c)
        eager_sug = step(eager)
    graphed = [x.clone() for x in state]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph_sug = step(graphed)
    for lr, c in zip(lrs, centers):
        lr_t.fill_(lr)
        center.copy_(c)
        graph.replay()
    torch.cuda.synchronize()
    names = ("w1", "vt1", "w4", "vt4", "p", "m", "v", "w", "sug")
    bad = [nm for nm, a, b in zip(names, [*graphed, graph_sug], [*eager, eager_sug])
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"K1/K2/K3 replayed from a CUDA graph differ from eager: {bad}")
    print("K1/K2/K3 CUDA graph replay: 3 replays bit-equal to eager")


def headline(torch, commit):
    from mpit_tpu_torch.train.mesh_launch import (
        FLAGSHIP_BENCH_KWARGS, MESH_LAUNCH_DEFAULTS, run)

    cfg = MESH_LAUNCH_DEFAULTS.merged(
        FLAGSHIP_BENCH_KWARGS, dp=1, epochs=2, measure_throughput=1, device="cuda")
    commit.launches = 0
    res = run(cfg)
    launches = commit.launches
    hist = res["history"]
    print("headline: " + json.dumps({
        "samples_per_sec": res["samples_per_sec"],
        "samples_per_sec_steady": res["samples_per_sec_steady"],
        "losses": [h["avg_loss"] for h in hist],
        "test_err": res["final_test_err"], "compile_s": res["compile_s"],
        "train_time": res["train_time"], "device": res["device"],
        "device_name": res["device_name"], "k1_launches": launches,
        "steps": res["steps"]}))
    if len(hist) != 2 or not hist[1]["avg_loss"] < hist[0]["avg_loss"]:
        raise AssertionError(f"the loss did not fall: {hist}")
    if not res["device"].startswith("cuda"):
        raise AssertionError(f"the state is on {res['device']}, not cuda")
    # One launch per step, and one for each of precompile's two warm-up
    # steps (a sync and a local step, on copies of the state).
    warm = 2 if cfg.precompile else 0
    if launches <= 0 or launches != res["steps"] + warm:
        raise AssertionError(f"the headline path launched K1 {launches} times "
                             f"in {res['steps']} steps + {warm} warm-up steps")
    return {"launches": launches, "steps": res["steps"], "warmup_steps": warm}


def grad_repeatability(torch, repeats=5):
    """The flagship CNN's gradient (side 32, one worker row under ``vmap``,
    a fixture batch of 128, as a dp=1 step takes it) computed ``repeats``
    times from the same inputs on the card: for each parameter, the
    largest gap to the first run.  A convolution whose gradient cuDNN sums
    with atomics, in no fixed order, shows here."""
    from mpit_tpu_torch.data.mnist import load_mnist
    from mpit_tpu_torch.models.flat import flatten_module, value_and_grad_nll
    from mpit_tpu_torch.models.mnist import make_model

    dev = torch.device("cuda")
    flat = flatten_module(make_model("cnn", 32), 1, dev)
    (x, y, _, _), _ = load_mnist(side=32)
    xb = torch.as_tensor(x[:128].reshape(1, 128, -1), dtype=torch.float32, device=dev)
    yb = torch.as_tensor(y[:128].reshape(1, 128), dtype=torch.int64, device=dev)
    grads = torch.func.vmap(value_and_grad_nll(flat))
    w = flat.w0[None]
    runs = [flat.unravel(grads(w, xb, yb)[1][0]) for _ in range(repeats)]
    return {name: max(float((r[name] - runs[0][name]).abs().max()) for r in runs[1:])
            for name, _ in flat.spec}


# The device loop against the host loop under cuDNN's default algorithms,
# which do not repeat their bits (see grad_repeatability): the largest
# relative gap of an epoch's mean loss, and of its test error in samples
# of the 270, may be twice the host loop's own spread in the same call
# (the largest gap between any two of its four runs there: three under the
# defaults, one under deterministic cuDNN), and never less than these floors, which
# hold where the host runs happen to land close together: twice the
# largest host-loop gap of earlier calls (1.02e-2 in loss at the
# flagship's eighth epoch, 0 samples, on an H100), and three samples.
# Runs fall about 1e-4 or about 1e-2 apart in loss, as cuDNN's algorithm
# choice lands.  The bit-for-bit check is the one under deterministic cuDNN.
LOOP_LOSS_FLOOR = 2.04e-2
LOOP_ERR_SAMPLES_FLOOR = 3
N_TEST = 270


def k1_on_card(torch, prof):
    """K1's launches that the card ran while ``prof`` (``torch.profiler``)
    recorded: its sweep's kernel events, those replayed from a CUDA graph
    included."""
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no kernel on the card")
    return sum("sweep_kernel" in k and "CommitRule" in k for k in kernels)


def device_loop_run(torch, commit, cfg, on_card=False):
    """One ``mesh_launch.run`` of ``cfg`` with K1's count set to 0 just
    before and read just after; checks the count.  The host loop launches
    K1 once a step and once for each of precompile's warm-up steps (EASGD
    two, sync-DP one).  The device loop's wrapper runs while a graph is
    captured, not while it replays: its count must be the warm-up's steps
    (precompile's and one epoch, on copies), each graph's steps (one
    capture each) and the
    throughput leg's eager steps.  ``on_card``: the run is recorded by
    ``torch.profiler`` and K1's kernels that ran on the card, replays
    included, must be the run's steps plus the warm-up's.  Returns the
    result and its path entry."""
    from mpit_tpu_torch.train.mesh_launch import run

    # precompile's warm-up steps, on copies: EASGD's sync and local step,
    # sync-DP's one step.
    pre = 1 if cfg.opt == "syncdp" else 2
    commit.launches = 0
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = run(cfg)
            torch.cuda.synchronize()
    else:
        res = run(cfg)
    wrapper = commit.launches
    if not cfg.device_loop:
        warm = pre if cfg.precompile else 0
        if wrapper != res["steps"] + warm:
            raise AssertionError(f"host loop: K1 launched {wrapper} times in "
                                 f"{res['steps']} steps + {warm} warm-up steps")
        return res, {"launches": wrapper, "steps": res["steps"], "warmup_steps": warm}
    info = res["device_loop"]
    graphs, warm = info["graphs"], info["warmup_steps"]
    spe = graphs[0]["steps"]
    replayed = sum(g["steps"] * g["replays"] for g in graphs)
    leg = res["steps"] - replayed
    if (not info["captured"] or any(g["steps"] != spe for g in graphs)
            or replayed != spe * len(res["history"]) or warm != pre + spe):
        raise AssertionError(f"device loop: {replayed} steps replayed in "
                             f"{len(res['history'])} epochs; {info}")
    if wrapper != warm + spe * len(graphs) + leg:
        raise AssertionError(f"device loop: K1's wrapper ran {wrapper} times; {info}, "
                             f"{leg} leg steps")
    entry = {"wrapper_launches": wrapper, "steps": res["steps"], "warmup_steps": warm,
             "graphs": graphs}
    if on_card:
        card = k1_on_card(torch, prof)
        if card != res["steps"] + warm:
            raise AssertionError(f"device loop: the card ran K1 {card} times for "
                                 f"{res['steps']} steps + {warm} warm-up steps")
        entry["launches"] = entry["card_launches"] = card
    return res, entry


def device_loop_vs_host(torch, commit):
    """The flagship at dp=1 trained to 2% test error as the reference's
    bench runs it (10 epochs at most, stopping at the target), by the host
    loop (``device_stream=1``) and by the device loop (one CUDA-graph
    replay an epoch):

    - with cuDNN held to deterministic algorithms, the host loop twice and
      the device loop once: the host loop repeats its own bits there, and
      the device loop must give them too, every epoch's loss and test
      error; this device loop runs under ``torch.profiler``, which reads
      K1's launches on the card;
    - with cuDNN's default algorithms, as the port trains: the host loop
      three times (the first with the steady-state leg) and the device
      loop with the leg; they are timed, and the device loop is held to
      the host loop within twice the host loop's spread in this call (the
      largest gap between any two of its four runs here, the three
      default ones and the deterministic one; LOOP_LOSS_FLOOR and
      LOOP_ERR_SAMPLES_FLOOR at least).

    Every run's K1 launches are checked exactly (``device_loop_run``).
    Returns the path entry: the profiled device loop's, the default
    device loop's under ``default_cudnn``, and both times to target."""
    from mpit_tpu_torch.train.mesh_launch import FLAGSHIP_BENCH_KWARGS, MESH_LAUNCH_DEFAULTS

    base = MESH_LAUNCH_DEFAULTS.merged(
        FLAGSHIP_BENCH_KWARGS, dp=1, epochs=10, target_test_err=0.02, stop_at_target=1,
        device="cuda")
    runs, entries = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        for name, kw in (("det_host_loop", {}), ("det_host_loop_again", {}),
                         ("det_device_loop", {"device_loop": 1})):
            runs[name], entries[name] = device_loop_run(
                torch, commit, base.merged(kw), on_card=name == "det_device_loop")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for name, kw in (("host_loop", {"measure_throughput": 1}), ("host_loop_again", {}),
                     ("host_loop_third", {}),
                     ("device_loop", {"device_loop": 1, "measure_throughput": 1})):
        runs[name], entries[name] = device_loop_run(torch, commit, base.merged(kw))

    def curve(name):
        return [(h["avg_loss"], h["test_err"]) for h in runs[name]["history"]]

    def gaps(a, b):
        pairs = list(zip(curve(a), curve(b)))
        return {"loss_rel": max(abs(x[0] - y[0]) / abs(y[0]) for x, y in pairs),
                "err_samples": max(round(abs(x[1] - y[1]) * N_TEST) for x, y in pairs),
                "epochs": [len(curve(a)), len(curve(b))]}

    summary = {name: {
        "time_to_target": res["time_to_target"], "epochs": len(res["history"]),
        "wall_s": res["history"][-1]["at"],
        "epoch_ms": 1e3 * res["history"][-1]["at"] / len(res["history"]),
        "compile_s": res["compile_s"], "samples_per_sec": res["samples_per_sec"],
        "samples_per_sec_steady": res["samples_per_sec_steady"], "steps": res["steps"],
        "test_err": [h["test_err"] for h in res["history"]],
        "avg_loss": [h["avg_loss"] for h in res["history"]]} for name, res in runs.items()}
    host_runs = ("host_loop", "host_loop_again", "host_loop_third", "det_host_loop")
    spread = {f"{a}_vs_{b}": gaps(a, b)
              for i, a in enumerate(host_runs) for b in host_runs[i + 1:]}
    summary["gaps"] = {"det_host_runs": gaps("det_host_loop_again", "det_host_loop"),
                       "det_device_vs_host": gaps("det_device_loop", "det_host_loop"),
                       "host_spread": spread,
                       "device_vs_host": gaps("device_loop", "host_loop")}
    summary["graphs"] = entries["device_loop"]["graphs"]
    summary["gradient_gaps"] = grad_repeatability(torch)
    print("device loop vs host loop: " + json.dumps(summary))
    if curve("det_host_loop") != curve("det_host_loop_again"):
        raise AssertionError("the host loop does not repeat its bits under deterministic "
                             "cuDNN")
    if curve("det_device_loop") != curve("det_host_loop"):
        raise AssertionError("the device loop did not train bit for bit as the host loop "
                             "under deterministic cuDNN")
    g = summary["gaps"]["device_vs_host"]
    # The host loop's own spread: the largest gap between any two of its
    # four runs in this call (three under cuDNN's defaults, one under
    # deterministic cuDNN), six pairs.
    h = {k: max(p[k] for p in spread.values()) for k in ("loss_rel", "err_samples")}
    limits = {"loss_rel": max(2 * h["loss_rel"], LOOP_LOSS_FLOOR),
              "err_samples": max(2 * h["err_samples"], LOOP_ERR_SAMPLES_FLOOR)}
    if not (g["epochs"][0] == g["epochs"][1] and g["loss_rel"] <= limits["loss_rel"]
            and g["err_samples"] <= limits["err_samples"]):
        raise AssertionError(f"the device loop strays from the host loop: {g}, "
                             f"limits {limits} (host spread {h})")
    print("device loop: bit-equal to the host loop under deterministic cuDNN; "
          f"under its defaults {g} (host spread {h}, limits {limits})")
    return {**entries["det_device_loop"], "default_cudnn": entries["device_loop"],
            "time_to_target": {k: summary[k]["time_to_target"]
                               for k in ("host_loop", "device_loop")}}


def easgd_dp4(torch, commit):
    """Three EASGD steps at dp=4 (one K1 launch commits four rows, each with
    its own clr) on the card, held against the same steps on the CPU."""
    import numpy as np

    from mpit_tpu_torch.models.flat import FlatModel, flatten_module, value_and_grad_nll
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.optim.msgd import MSGDConfig
    from mpit_tpu_torch.parallel import MeshEASGD, make_mesh

    dp, batch, side = 4, 128, 32
    # Uniform random pixels, not the fixture: its digits are 8x8 scans
    # upsampled 4x, so 2x2 pooling windows hold exact ties, and cuDNN and
    # the CPU (which round neighbouring outputs differently) route the
    # gradient of a tie to different elements.  Without ties the two
    # devices differ only by summation order.
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.random((3, dp, batch, side * side), dtype=np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(3, dp, batch)))
    cfg = MSGDConfig(lr=1e-2, mom=0.99, lrd=1e-3, lrp=1.0)
    w0 = flatten_module(make_model("cnn", side), 1).w0
    finals = {}
    for device in ("cuda", "cpu"):
        flat = FlatModel(make_model("cnn", side).to(device), w0.to(device))
        tr = MeshEASGD(make_mesh(dp=dp, device=device), value_and_grad_nll(flat),
                       cfg, mva=0.9 / dp, su=2)
        state = tr.init(flat.w0)
        # Stagger the rows' counters so every row decays its lr differently.
        state["k"].copy_(torch.arange(dp, dtype=torch.int32) * 100)
        initial = {k: v.cpu().clone() for k, v in state.items()}
        commit.launches = 0
        for s in range(3):
            state, loss = tr.step(state, xs[s].to(device), ys[s].to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            launches, steps = commit.launches, tr.steps
            if launches != steps:
                raise AssertionError(f"dp=4: {launches} K1 launches in "
                                     f"{steps} steps")
        if not bool(torch.isfinite(loss).all()):
            raise AssertionError(f"dp=4 loss not finite on {device}: {loss}")
        finals[device] = {k: v.cpu() for k, v in state.items()}
    # The gap between the devices is held against what the three steps
    # changed, not against the state: w and the center stay near w0, and
    # vt sums three updates of about 1e-6..1e-5 on most elements.  cuDNN
    # and the CPU sum the convolutions in different orders, which leaves
    # the gap at f32 rounding of the gradients (max 5e-7 for w, 2.5e-7 for
    # vt, 8.6e-8 for the center, measured on an H100).  A row given another
    # row's lr moves its update by 7% or more (clr 0.01/(1 + k*1e-3) at
    # k = 0, 100, 200, 300), and a dropped retract moves w by 0.225 times
    # its drift since the last sync: far past both limits.
    readings = {}
    for key in ("w", "vt", "center"):
        gap = finals["cuda"][key] - finals["cpu"][key]
        change = finals["cpu"][key] - initial[key]
        readings[key] = {
            "max_abs_gap": float(gap.abs().max()),
            "max_abs_change": float(change.abs().max()),
            "gap_over_change": float(gap.norm() / change.norm()),
        }
    print("dp=4: 3 steps, cuda vs cpu " + json.dumps(readings))
    for key, r in readings.items():
        if not (r["max_abs_gap"] <= DP4_MAX_ABS_GAP
                and r["gap_over_change"] <= DP4_GAP_OVER_CHANGE):
            raise AssertionError(f"dp=4: {key} on the card differs from the CPU "
                                 f"beyond the limits: {r}")
    return {"launches": launches, "steps": steps}


def launch_msgd(torch, commit):
    from mpit_tpu_torch.train import launch

    commit.launches = 0
    res = launch.main(["--np", "1", "--opt", "msgd", "--epochs", "1"])
    launches = commit.launches
    err = res["final_test_err"]
    print(f"launch --np 1 --opt msgd: test_err {err} k1_launches {launches} "
          f"steps {res['steps']}")
    if launches <= 0 or launches != res["steps"]:
        raise AssertionError(f"launch --np 1 --opt msgd launched K1 {launches} "
                             f"times in {res['steps']} steps")
    if not (0.0 <= err < 0.9):
        raise AssertionError(f"msgd did not learn: test_err {err}")
    return {"launches": launches, "steps": res["steps"]}


def run_gang_path(torch, name, size, kernels, data, **kw):
    """One gang path: the counters set to 0 just before, read just after.
    Checks every shard and every worker's ``w`` on the path's device (the
    card unless ``device`` says otherwise), finite losses, and a falling
    epoch-mean loss on every worker when ``lr > 0`` over two epochs.
    Returns the results, the launches and the reading printed for the
    path."""
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, run_gang

    cfg = LAUNCH_DEFAULTS.merged(GANG_BASE, **kw)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    results = run_gang(size, cfg, data=data, timeout=600)
    wall = time.perf_counter() - t0
    launches = {key: k.launches for key, k in kernels.items()}
    servers = [r for r in results.values() if r["role"] == "server"]
    workers = [r for r in results.values() if r["role"] == "worker"]
    for r in servers:
        if r["param"].device.type != cfg.device:
            raise AssertionError(f"{name}: a server shard is on {r['param'].device}")
    for r in workers:
        if r["w"].device.type != cfg.device:
            raise AssertionError(f"{name}: a worker's w is on {r['w'].device}")
        losses = [h["avg_loss"] for h in r["history"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: losses not finite: {losses}")
        if cfg.lr > 0 and len(losses) == 2 and not losses[1] < losses[0]:
            raise AssertionError(f"{name}: a worker's loss did not fall: {losses}")
    steps = [r["steps"] for r in workers]
    reading = {
        "wall_s": wall,
        "samples_per_sec": sum(steps) * cfg.batch / wall,
        "samples_per_sec_train": train_rate(workers, cfg.batch),
        "samples_per_sec_last_epoch": last_epoch_rate(workers, cfg.batch),
        "worker_steps": steps,
        "grads_applied": [r["grads_applied"] for r in servers],
        "params_served": [r["params_served"] for r in servers],
        "losses": [[h["avg_loss"] for h in r["history"]] for r in workers],
        "test_err": [r["final_test_err"] for r in workers],
        "launches": launches,
    }
    print(f"{name}: " + json.dumps(reading))
    return results, launches, reading


def train_rate(workers, batch):
    """Samples over the slowest worker's own clock (its trainer's
    ``elapsed``: data and model set up, the epochs, the stop): what a gang
    trains a second once its processes exist."""
    return sum(r["steps"] for r in workers) * batch / max(r["elapsed"] for r in workers)


def last_epoch_rate(workers, batch):
    """The workers' last-epoch samples/s, summed (each over its own clock,
    from its history's ``at``): the steady state, with every set-up and
    first call behind it.  None for a one-epoch run."""
    rates = []
    for r in workers:
        hist = r["history"]
        if len(hist) < 2:
            return None
        steps = r["steps"] // len(hist)
        rates.append(steps * batch / (hist[-1]["at"] - hist[-2]["at"]))
    return sum(rates)


def expect_launches(name, launches, want):
    """Every kernel launched exactly as ``want`` says (0 where absent)."""
    for key, got in launches.items():
        if got != want.get(key, 0):
            raise AssertionError(f"{name}: {key} launched {got} times, "
                                 f"expected {want.get(key, 0)}")


def gang_paths(torch, kernels, paths):
    """The five gang paths; fills ``paths[kernel][path]`` with every
    kernel's launches on every path (0 where the path runs none of it).
    Returns each path's reading."""
    from mpit_tpu_torch.data.mnist import load_mnist
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.mnist import make_model

    data, _ = load_mnist(side=GANG_BASE["side"])

    def worker_steps(results):
        return sum(r["steps"] for r in results.values() if r["role"] == "worker")

    def record(name, res, launches, **extra):
        for key in kernels:
            paths[key][name] = {"launches": launches[key],
                                "steps": worker_steps(res), **extra}

    readings = {}
    name = "ps_downpour_np4"
    res, launches, readings[name] = run_gang_path(torch, name, 4, kernels, data,
                                                  **PS_CONFIGS[name])
    expect_launches(name, launches, {})
    record(name, res, launches)

    name = "ps_eamsgd_np12"
    res, launches, readings[name] = run_gang_path(torch, name, 12, kernels, data,
                                                  **PS_CONFIGS[name])
    expect_launches(name, launches, {"k1": worker_steps(res)})
    record(name, res, launches)

    name = "ps_adam_np4"
    res, launches, _ = run_gang_path(torch, name, 4, kernels, data, opt="adam",
                                     lr=1e-3, su=1, epochs=1)
    applied = sum(r["grads_applied"] for r in res.values() if r["role"] == "server")
    if applied != 2 * worker_steps(res):
        raise AssertionError(f"{name}: {applied} applies for {worker_steps(res)} "
                             "worker steps on 2 servers")
    expect_launches(name, launches, {"k3": applied})
    record(name, res, launches, server_applies=applied)

    name = "ps_adam_single_np2"
    res, launches, _ = run_gang_path(torch, name, 2, kernels, data,
                                     opt="adam-single", lr=1e-3, epochs=1)
    expect_launches(name, launches, {"k3": worker_steps(res)})
    record(name, res, launches)

    # Comm-only EAMSGD: the workers start from different w0 (seed + rank)
    # and only the elastic force moves them, so they must end closer
    # together than they started.
    name = "ps_eamsgd_lr0_np4"
    res, launches, _ = run_gang_path(torch, name, 4, kernels, data,
                                     opt="eamsgd", lr=0.0, mva=0.45, su=1,
                                     epochs=1)
    expect_launches(name, launches, {"k2": worker_steps(res)})
    ranks = sorted(r for r, v in res.items() if v["role"] == "worker")
    module = make_model(GANG_BASE["model"], GANG_BASE["side"])
    w0 = {r: flatten_module(module, 1 + r).w0 for r in ranks}
    start = max(float((w0[a] - w0[b]).norm()) for a in ranks for b in ranks)
    end = max(float((res[a]["w"] - res[b]["w"]).norm()) for a in ranks for b in ranks)
    print(f"{name}: largest distance between workers {start} -> {end}")
    if not end < start:
        raise AssertionError(f"{name}: the workers did not draw together "
                             f"({start} -> {end})")
    record(name, res, launches, distance=[start, end])
    return readings


def adam_gang_vs_cpu(torch, kernels):
    """A one-worker server-side Adam gang (np=3: 2 servers, 1 worker) for
    three steps on the card, held against the same gang on the CPU."""
    import numpy as np

    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.mnist import make_model

    side, batch = GANG_BASE["side"], GANG_BASE["batch"]
    # Uniform random pixels: no max-pool ties (see easgd_dp4).
    rng = np.random.default_rng(4)
    x = rng.random((3 * batch, side * side), dtype=np.float32)
    y = rng.integers(0, 10, size=3 * batch)
    data = (x, y, x[:batch], y[:batch])
    finals = {}
    for device in ("cuda", "cpu"):
        res, launches, _ = run_gang_path(
            torch, f"adam_gang_{device}", 3, kernels, data, opt="adam",
            lr=1e-3, su=1, epochs=1, device=device)
        if device == "cuda":
            steps = sum(r["steps"] for r in res.values() if r["role"] == "worker")
            applied = sum(r["grads_applied"] for r in res.values()
                          if r["role"] == "server")
            if steps != 3 or applied != 2 * steps:
                raise AssertionError(f"adam gang: {applied} applies on 2 servers "
                                     f"for {steps} worker steps, expected 3")
            expect_launches("adam_gang_cuda", launches, {"k3": applied})
            cuda_launches = launches["k3"]
        finals[device] = torch.cat([res[r]["param"].cpu() for r in sorted(res)
                                    if res[r]["role"] == "server"])
    w0 = flatten_module(make_model(GANG_BASE["model"], side), 2).w0
    # A step moves each element by about lr = 1e-3 (Adam's step is lr_t
    # m/sqrt(v), with |m|/sqrt(v) near 1 at every step's start), so three
    # steps change it by up to 3e-3.  Grads on the card and the CPU differ
    # by summation order (cuDNN may pick FFT convolutions); where a grad
    # is near 0 the normalized step amplifies that: the largest gap was
    # 4.7e-5 and the norm ratio 8.1e-5 on an H100.  A dropped or doubled
    # apply on one server moves every element of its shard by ~1e-3
    # (3x the max-abs limit) and its norm by about a third of the whole
    # change (300x the ratio limit).
    gap = finals["cuda"] - finals["cpu"]
    change = finals["cpu"] - w0
    reading = {"max_abs_gap": float(gap.abs().max()),
               "max_abs_change": float(change.abs().max()),
               "gap_over_change": float(gap.norm() / change.norm())}
    print("adam gang: 3 steps, cuda vs cpu " + json.dumps(reading))
    if not (reading["max_abs_gap"] <= ADAM_MAX_ABS_GAP
            and reading["gap_over_change"] <= ADAM_GAP_OVER_CHANGE):
        raise AssertionError(f"adam gang: the card differs from the CPU beyond "
                             f"the limits: {reading}")
    return {"launches": cuda_launches, "steps": steps, **reading}


# Flash attention's checked shapes: (name, leading axes, Lq, Lk, D,
# q_offset, kv_offset, causal).  The three LM paths' attention (batch x
# heads, context, head width), a ragged pair whose first 20 q rows are dead
# under the causal mask, and full attention over a ragged pair.
#: rounds of ptest_shm's five legs (the twin's default is 20; cut to 10 to
#: make room for the aggregation and LM block)
PTEST_SHM_ROUNDS = "10"


def run_procs_path(name, size, **kw):
    """One process gang through ``launch.launch_processes`` (every rank a
    fresh interpreter over the port's shm transport, or TCP): every child
    on the card, finite losses on every worker, falling over two epochs
    when ``lr > 0``.  The children count their own K1-K3 launches (the
    counters are set to 0 in each new process) and return them; the sums
    over the gang are the path's launches.  Returns the results, the
    launches and the reading printed for the path."""
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    cfg = LAUNCH_DEFAULTS.merged(GANG_BASE, np=size, **kw)
    t0 = time.perf_counter()
    results = launch_processes(cfg, timeout=600)
    wall = time.perf_counter() - t0
    off = {r: res["platform"] for r, res in results.items()
           if res["platform"] != cfg.device}
    if off:
        raise AssertionError(f"{name}: ranks off {cfg.device}: {off}")
    servers = [r for r in results.values() if r["role"] == "server"]
    workers = [r for r in results.values() if r["role"] == "worker"]
    for r in workers:
        losses = [h["avg_loss"] for h in r["history"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: losses not finite: {losses}")
        if cfg.lr > 0 and len(losses) == 2 and not losses[1] < losses[0]:
            raise AssertionError(f"{name}: a worker's loss did not fall: {losses}")
    launches = {k: sum(res["launches"][k] for res in results.values())
                for k in ("k1", "k2", "k3")}
    steps = [r["steps"] for r in workers]
    reading = {
        "wall_s": wall,
        "samples_per_sec": sum(steps) * cfg.batch / wall,
        "samples_per_sec_train": train_rate(workers, cfg.batch),
        "samples_per_sec_last_epoch": last_epoch_rate(workers, cfg.batch),
        "worker_steps": steps,
        "grads_applied": [r["grads_applied"] for r in servers],
        "params_served": [r["params_served"] for r in servers],
        "losses": [[h["avg_loss"] for h in r["history"]] for r in workers],
        "test_err": [r["final_test_err"] for r in workers],
        "launches": launches,
        "launches_by_rank": {r: res["launches"] for r, res in sorted(results.items())},
    }
    print(f"{name}: " + json.dumps(reading))
    return results, launches, reading


def process_gang_paths(torch, paths, inproc, smi):
    """The process gangs (``launch --np N``) at the flagship widths, every
    rank on the card: BASELINE configs 2 and 3 over shm (beside the
    in-process gangs' samples/s from this call), server-side Adam, a
    tester, DOWNPOUR over TCP on 127.0.0.1, then the ptest twin's push/pull
    bandwidth (codecs none and int8).  The codec must run the port's native
    library, never its numpy fallback."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mpit_tpu_torch.comm import codec
    from mpit_tpu_torch.comm.native import build as native_build
    from mpit_tpu_torch.comm.tcp import allocate_local_addresses
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.utils.checkpoint import load_flat

    t0 = time.perf_counter()
    print(f"native library: {native_build.ensure_built()}")
    print(f"codec host path: {codec.native_path()}")
    if codec.native_path() != "native":
        raise AssertionError("the codec runs its numpy fallback: the port's "
                             "native library did not load")
    print(subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                         text=True).stdout.strip())

    def worker_steps(results):
        return sum(r["steps"] for r in results.values() if r["role"] == "worker")

    def record(name, res, launches, **extra):
        for key in ("k1", "k2", "k3"):
            paths[key][name] = {"launches": launches[key],
                                "steps": worker_steps(res), **extra}

    timing = {}
    for name, size in (("ps_downpour_np4", 4), ("ps_eamsgd_np12", 12)):
        pname = f"{name}_procs"
        res, launches, reading = run_procs_path(pname, size, **PS_CONFIGS[name])
        if name == "ps_downpour_np4":
            # A worker process's steady epoch (its last, from its history).
            timing["epoch_s"] = max(r["history"][-1]["at"] - r["history"][-2]["at"]
                                    for r in res.values() if r["role"] == "worker")
        expect_launches(pname, launches,
                        {"k1": worker_steps(res)} if "eamsgd" in name else {})
        record(pname, res, launches)
        print(f"{name} on {smi}: samples/s, processes / threads: over the gang's wall "
              f"{reading['samples_per_sec']:.1f} / {inproc[name]['samples_per_sec']:.1f}, "
              f"the workers' clocks {reading['samples_per_sec_train']:.1f} / "
              f"{inproc[name]['samples_per_sec_train']:.1f}, the last epoch "
              f"{reading['samples_per_sec_last_epoch']:.1f} / "
              f"{inproc[name]['samples_per_sec_last_epoch']:.1f}")

    # Three gangs side by side (13 processes on one card): their checks
    # are exact, and their samples/s are not read.
    n_params = flatten_module(make_model(GANG_BASE["model"], GANG_BASE["side"]), 1).size
    addrs, socks = allocate_local_addresses(4)
    for sock in socks:
        sock.close()  # the TCP gang's ranks bind these ports
    with tempfile.TemporaryDirectory() as ckpt_dir, ThreadPoolExecutor(3) as pool:
        adam = pool.submit(run_procs_path, "ps_adam_np4_procs", 4, opt="adam",
                           lr=1e-3, su=1, epochs=1)
        tester = pool.submit(run_procs_path, "ps_downpour_np5_tester_procs", 5,
                             opt="downpour", lr=1e-2, su=1, epochs=1, tester="last",
                             tester_rounds=3, tester_interval=0.5, ckpt_dir=ckpt_dir)
        tcp = pool.submit(run_procs_path, "ps_downpour_np4_tcp", 4, opt="downpour",
                          lr=1e-2, su=1, epochs=1, transport="tcp",
                          tcp_addrs=",".join(addrs))
        adam, tester, tcp = adam.result(), tester.result(), tcp.result()
        w, meta = load_flat(os.path.join(ckpt_dir, "ckpt_latest.npz"))

    name = "ps_adam_np4_procs"
    res, launches, _ = adam
    applied = sum(r["grads_applied"] for r in res.values() if r["role"] == "server")
    in_servers = sum(r["launches"]["k3"] for r in res.values() if r["role"] == "server")
    if not applied == in_servers == launches["k3"] == 2 * worker_steps(res):
        raise AssertionError(f"{name}: K3 {in_servers} in the servers ({launches['k3']} "
                             f"in all), {applied} applies, {worker_steps(res)} worker "
                             "steps on 2 servers")
    expect_launches(name, launches, {"k3": applied})
    record(name, res, launches, server_applies=applied)
    # The children's start-up beside two other gangs (the gang's wall less
    # its workers' own clocks), and the fault-free test errors: what the
    # supervised gangs of ``ft_chaos_procs`` are sized and held by.
    timing["startup_s"] = adam[2]["wall_s"] - max(
        r["elapsed"] for r in res.values() if r["role"] == "worker")
    timing["adam_test_err"] = adam[2]["test_err"]

    name = "ps_downpour_np5_tester_procs"
    res, launches, _ = tester
    hist = res[4].get("history", [])
    if res[4]["role"] != "tester" or len(hist) != 3:
        raise AssertionError(f"{name}: rank 4 {res[4]['role']}, history {hist}")
    if w.size != n_params or not np.isfinite(w).all() \
            or meta["test_err"] != res[4]["best_test_err"]:
        raise AssertionError(f"{name}: checkpoint of {w.size} values, meta {meta}, "
                             f"best {res[4]['best_test_err']}")
    print(f"{name}: tester history {hist}, checkpoint of {w.size} values at "
          f"test_err {meta['test_err']}")
    expect_launches(name, launches, {})
    record(name, res, launches)

    name = "ps_downpour_np4_tcp"
    res, launches, _ = tcp
    expect_launches(name, launches, {})
    record(name, res, launches)

    t_ptest = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_ptest.py")],
                          env=dict(os.environ, MPIT_BENCH_CODECS="none,int8",
                                   MPIT_BENCH_ROUNDS=PTEST_SHM_ROUNDS),
                          capture_output=True, text=True, timeout=600)
    sys.stdout.write(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"ptest_shm failed ({proc.returncode}):\n{proc.stdout}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    for row in rows:
        print(f"ptest_shm on {smi}: " + json.dumps(row))
        if row["codec_path"] != "native" \
                or row.get("server_platforms") != [GANG_BASE["device"]] \
                or not row["value"] > 0:
            raise AssertionError(f"ptest_shm: {row}")
    if [row["codec"] for row in rows] != ["none", "int8"]:
        raise AssertionError(f"ptest_shm: rows {rows}")
    # The observability legs at codec none, in one call: obs off, then on
    # (registry counters and op spans in every child), then the framed
    # FLAG_TIMING wire with traces, merged and decomposed by `obs analyze`.
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_ptest.py")],
                          env=dict(os.environ, MPIT_BENCH_CODECS="none", MPIT_BENCH_OBS="1",
                                   MPIT_BENCH_DECOMP="1", MPIT_BENCH_ROUNDS=PTEST_SHM_ROUNDS),
                          capture_output=True, text=True, timeout=600)
    sys.stdout.write(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"ptest_shm obs legs failed ({proc.returncode}):\n{proc.stdout}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    for row in rows:
        print(f"ptest_shm_obs on {smi}: " + json.dumps(row))
    legs = [(row["obs"], row.get("decomp", 0)) for row in rows]
    if legs != [(0, 0), (1, 0), (0, 1)] or not all(row["value"] > 0 for row in rows):
        raise AssertionError(f"ptest_shm obs legs: {legs}")
    if rows[2]["join_rate"] != 1.0:
        raise AssertionError(f"ptest_shm decomposition: join rate {rows[2]['join_rate']}")
    # The JAX twin gates obs-on at 97% of the captured record; the ratio is
    # written down here, whatever it is, and does not fail the run.
    print(f"ptest_shm obs on {smi}: codec none {rows[0]['value']} MB/s with obs off, "
          f"{rows[1]['value']} MB/s on (ratio {rows[1]['value'] / rows[0]['value']:.4f}), "
          f"{rows[2]['value']} MB/s on the timed, traced wire")
    print(f"ptest_shm: {time.perf_counter() - t_ptest:.1f}s; process gang phases: "
          f"{time.perf_counter() - t0:.1f}s")
    print("process gang timing: " + json.dumps(timing))
    return timing


# -- fault tolerance (slice 5a) ----------------------------------------------------

FT_ROUNDS = 8
#: short deadlines and a fast backoff, so a dropped message costs ~0.2 s
FT_FAST = dict(op_deadline_s=0.2, max_retries=12, backoff_base_s=0.005,
               backoff_cap_s=0.02)
FT_DATA_TAGS = frozenset({2, 4, 6})  # GRAD, PARAM_REQ, PARAM_PUSH
FT_REPLY_TAGS = frozenset({3, 5, 7})  # their acks and the PARAM replies
#: the reference's matrix (tests/test_ft.py): every 3rd client data
#: message dropped and every 4th duplicated, every 3rd server reply dropped
FT_CLIENT_PLAN = dict(drop_every=3, dup_every=4, tags=FT_DATA_TAGS)
FT_SERVER_PLAN = dict(seed=9, drop_every=3, tags=FT_REPLY_TAGS)
FT_LEASE_TTL_S = 1.0


def ft_gang(rule, codec, server_plan=None, client_plan=None, nclients=2, timing=False,
            mode="wire", chunk_bytes=0, ft=FT_FAST):
    """2 servers (ranks 0, 1) on the card and ``nclients`` clients over one
    in-process router, each endpoint behind its side's fault plan where
    one is given (client ``i`` seeded ``i``), the clients on the
    ``FLAG_TIMING`` wire with ``timing`` and chunked at ``chunk_bytes``
    (0: whole frames); the servers run on threads.  ``mode`` places the
    shards: "wire" (no plane), "slots" (device slots, no exchange),
    "device" (both servers publish a plane, every client an
    ``ExchangeClient`` that requires the device path) or "mixed" (server 0
    on the device path, server 1 on the wire).  Returns (servers, clients,
    threads)."""
    import threading

    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.dplane import ExchangeClient, PlaneConfig
    from mpit_tpu_torch.ft import FaultPlan, FaultyTransport, FTConfig
    from mpit_tpu_torch.ps import ParamClient, ParamServer

    router = LocalRouter(2 + nclients)
    cranks = list(range(2, 2 + nclients))
    servers = []
    for r in (0, 1):
        ep = router.endpoint(r)
        if server_plan:
            ep = FaultyTransport(ep, FaultPlan(**server_plan))
        plane = None if mode == "wire" else PlaneConfig(
            device=GANG_BASE["device"], publish=(mode == "device" or
                                                 (mode == "mixed" and r == 0)))
        servers.append(ParamServer(r, cranks, ep, rule=rule, device=GANG_BASE["device"],
                                   ft=FTConfig(rejoin=True), dplane=plane))
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    clients = []
    for i, r in enumerate(cranks):
        ep = router.endpoint(r)
        if client_plan:
            ep = FaultyTransport(ep, FaultPlan(seed=i, **client_plan))
        pc = ParamClient(r, [0, 1], ep, seed_servers=(i == 0), codec=codec,
                         ft=FTConfig(**ft, timing=timing, chunk_bytes=chunk_bytes))
        if mode == "device":
            pc = ExchangeClient(pc, require_device=True, device=GANG_BASE["device"])
        elif mode == "mixed":
            pc = ExchangeClient(pc, device_ranks=[0], device=GANG_BASE["device"])
        clients.append(pc)
    return servers, clients, threads


def ft_start(clients, starts):
    """Each client's ``start`` (or the callable in ``starts``) on a thread:
    the seeding client's push waits for every INIT."""
    import threading

    errors = []

    def run(fn):
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 — raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(fn,), daemon=True) for fn in starts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"ft: client start failed or hung: {errors}")


def ft_close(name, servers, clients, threads, kernels):
    """Stop the clients, join the servers; returns the gang's counts.  The
    servers' K3 launches must equal their applies, and every admitted seq
    must have been applied exactly once."""
    for c in clients:
        c.stop()
    for t in threads:
        t.join(60)
        if t.is_alive():
            raise AssertionError(f"{name}: a server did not stop")
    stats = {"grads_applied": sum(s.grads_applied for s in servers),
             "dup_ops": sum(s.dup_ops for s in servers),
             "stale_drops": sum(s.stale_drops for s in servers),
             "retries": sum(c.retries for c in clients),
             "launches": read_counts(kernels)}
    for s in servers:
        if s.param.device.type != GANG_BASE["device"]:
            raise AssertionError(f"{name}: a shard is on {s.param.device}")
        for (crank, epoch), (lo, hi, n) in s.admitted.items():
            if n != hi - lo + 1:
                raise AssertionError(f"{name}: server {s.rank} applied {n} GRADs "
                                     f"of seqs {lo}..{hi} from {crank}:{epoch}")
    return stats


def ft_lockstep_adam(torch, kernels, data, faulty, timing=False, name=None, mode="wire",
                     time_grads=False):
    """Two workers compute the flagship CNN's gradient on the card at the
    params they pull, in lockstep turns (each pulls, computes, pushes and
    has its GRAD acked before the other moves: the order
    ``tests/test_ft.py``'s ``run_lockstep`` pins), against two servers
    applying Adam by K3 to their 272,261-float shards, on the
    ``FLAG_TIMING`` wire with ``timing``, the shards placed by ``mode``
    (``ft_gang``).  With ``time_grads`` each GRAD's round trip is timed to
    its apply's end on the card (``stats["grad_s"]``).  Returns the final
    params, the counts and the seconds a round took."""
    import numpy as np

    from mpit_tpu_torch.models.flat import flatten_module, value_and_grad_nll_eager
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.optim import rules

    name = name or f"ft_adam_{'faulty' if faulty else 'clean'}"
    flat = flatten_module(make_model(GANG_BASE["model"], GANG_BASE["side"]), 1,
                          GANG_BASE["device"])
    vgf = value_and_grad_nll_eager(flat)
    x, y = data
    batch = GANG_BASE["batch"]
    servers, clients, threads = ft_gang(
        rules.make("adam", lr=1e-3), None, server_plan=faulty and FT_SERVER_PLAN,
        client_plan=faulty and FT_CLIENT_PLAN, timing=timing, mode=mode)
    params = [flat.w0.cpu().numpy().copy(), np.zeros(flat.size, np.float32)]
    grads = [np.zeros(flat.size, np.float32) for _ in clients]
    vgf(flat.w0, x[:batch], y[:batch])  # first-call costs out of the rounds
    ft_start(clients, [lambda c=c, i=i: c.start(params[i], grads[i])
                       for i, c in enumerate(clients)])
    zero_counts(kernels)
    grad_s, queued = [], []
    t0 = time.perf_counter()
    for rnd in range(FT_ROUNDS):
        for i, c in enumerate(clients):
            c.async_recv_param()
            c.wait()
            lo = ((rnd * len(clients) + i) * batch) % (len(x) - batch)
            _loss, g = vgf(torch.from_numpy(params[i]).to(GANG_BASE["device"]), x[lo:lo + batch],
                           y[lo:lo + batch])
            grads[i][:] = g.cpu().numpy()
            t_grad = time.perf_counter()
            c.async_send_grad()
            c.wait()
            if time_grads:
                torch.cuda.synchronize()  # the apply done, not just launched
                grad_s.append(time.perf_counter() - t_grad)
                queued += [t.queued_s for t in getattr(c, "last_tickets", [])]
    round_s = (time.perf_counter() - t0) / FT_ROUNDS
    clients[0].async_recv_param()
    clients[0].wait()
    final = params[0].copy()
    device_ranks = [getattr(c, "device_ranks", []) for c in clients]
    wire_ops = [int(c._m_ops["wire"].value) for c in clients if hasattr(c, "_m_ops")]
    stats = ft_close(name, servers, clients, threads, kernels)
    if mode != "wire":
        stats["device_ops"] = [sum(int(v.value) for v in s._m_dp_ops.values())
                               for s in servers]
        stats["device_ranks"], stats["wire_ops"] = device_ranks, wire_ops
    if time_grads:
        stats["grad_s"], stats["queued_s"] = grad_s, queued
    expect_launches(name, stats["launches"], {"k3": stats["grads_applied"]})
    if stats["grads_applied"] != 2 * len(clients) * FT_ROUNDS:
        raise AssertionError(f"{name}: {stats['grads_applied']} applies")
    return final, stats, round_s


def ft_lockstep_eamsgd_int8(torch, kernels, data, faulty):
    """The int8 codec under resends: two EAMSGD workers (each step pulls
    the center, pushes its elastic difference and commits by K1) in
    lockstep, against two plain-add servers whose replies drop every
    2nd time.  The error-feedback residual telescopes exactly only if
    every resent frame is the one encoded, and applied once."""
    import numpy as np

    from mpit_tpu_torch.models.flat import flatten_module, value_and_grad_nll_eager
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.optim.easgd import EAMSGD

    name = f"ft_eamsgd_int8_{'faulty' if faulty else 'clean'}"
    module = make_model(GANG_BASE["model"], GANG_BASE["side"])
    flats = [flatten_module(module, 1 + i, GANG_BASE["device"]) for i in range(2)]
    x, y = data
    batch = GANG_BASE["batch"]
    # Only the server's replies are faulty here, as in the reference's test.
    servers, clients, threads = ft_gang(
        "add", "int8", server_plan=faulty and dict(seed=5, drop_every=2,
                                                   tags=FT_REPLY_TAGS))
    opts = [EAMSGD(value_and_grad_nll_eager(flats[i]), c, lr=0.01, mom=0.9, mva=0.15,
                   su=1) for i, c in enumerate(clients)]
    ws = [f.w0.clone() for f in flats]
    ft_start(clients, [lambda o=o, i=i: ws.__setitem__(i, o.start(ws[i]))
                       for i, o in enumerate(opts)])
    zero_counts(kernels)
    for rnd in range(FT_ROUNDS):
        for i, opt in enumerate(opts):
            lo = ((rnd * 2 + i) * batch) % (len(x) - batch)
            ws[i], _loss = opt.step(ws[i], x[lo:lo + batch], y[lo:lo + batch])
            opt.pc.wait()  # the elastic push acked before the other moves
    clients[0].async_recv_param()
    clients[0].wait()
    final = opts[0].center_host.copy()
    for opt in opts:
        opt.pc.wait()
    stats = ft_close(name, servers, clients, threads, kernels)
    expect_launches(name, stats["launches"], {"k1": 2 * FT_ROUNDS})
    return final, stats, torch.cat(ws).cpu().numpy()


def ft_retry_dedup(torch, kernels, all_paths, smi):
    """The retry/dedup matrix on the card: fault-free, then under the
    reference's drop/dup plans, bit for bit, with K3's launches equal to
    the applies and the same in both runs; then the int8 codec with
    EAMSGD workers (K1) under dropped replies, bit for bit."""
    import numpy as np

    from mpit_tpu_torch.data.mnist import load_mnist

    raw, _ = load_mnist(side=GANG_BASE["side"])
    data = (torch.as_tensor(raw[0], device=GANG_BASE["device"]),
            torch.as_tensor(np.asarray(raw[1]), dtype=torch.int64, device=GANG_BASE["device"]))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        clean, clean_stats, clean_s = ft_lockstep_adam(torch, kernels, data, False)
        faulty, stats, faulty_s = ft_lockstep_adam(torch, kernels, data, True)
        i8_clean, i8_clean_stats, i8_w = ft_lockstep_eamsgd_int8(torch, kernels, data,
                                                                 False)
        i8_faulty, i8_stats, i8_w_faulty = ft_lockstep_eamsgd_int8(torch, kernels,
                                                                   data, True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    reading = {"round_s_clean": clean_s, "round_s_faulty": faulty_s,
               "clean": clean_stats, "faulty": stats,
               "int8_clean": i8_clean_stats, "int8_faulty": i8_stats}
    print("ft_retry_dedup: " + json.dumps(reading))
    print(f"ft_retry_dedup on {smi}: a lockstep round (2 workers, 2 Adam servers at "
          f"272,261) {clean_s * 1e3:.1f} ms fault-free, {faulty_s * 1e3:.1f} ms under "
          f"the drop/dup matrix; retries {stats['retries']}, dups {stats['dup_ops']}")
    if clean.tobytes() != faulty.tobytes():
        raise AssertionError("ft_retry_dedup: faulty params differ from the fault-free "
                             f"run's (max gap {np.abs(clean - faulty).max()})")
    if not (stats["retries"] > 0 and stats["dup_ops"] > 0):
        raise AssertionError(f"ft_retry_dedup: the plans never bit: {stats}")
    if clean_stats["launches"] != stats["launches"]:
        raise AssertionError(f"ft_retry_dedup: K launches {clean_stats['launches']} "
                             f"fault-free, {stats['launches']} under faults")
    if i8_clean.tobytes() != i8_faulty.tobytes() or i8_w.tobytes() != i8_w_faulty.tobytes():
        raise AssertionError("ft_retry_dedup: int8 EAMSGD under resends differs from "
                             "its fault-free run")
    if not (i8_stats["retries"] > 0 and i8_stats["dup_ops"] > 0):
        raise AssertionError(f"ft_retry_dedup: int8 replies never dropped: {i8_stats}")
    steps = 2 * FT_ROUNDS
    record_path(all_paths, "ft_adam_clean", clean_stats["launches"], steps)
    record_path(all_paths, "ft_adam_faulty", stats["launches"], steps)
    record_path(all_paths, "ft_eamsgd_int8_faulty", i8_stats["launches"], steps)


def ft_server_restart(torch, kernels, all_paths, smi, tmp):
    """An Adam server at 272,261 floats applies one GRAD on the card, stops
    and checkpoints; the client sends a GRAD and a PARAM_REQ into the
    void; a new server restores onto the card and serves them: 2 applies,
    the restored p, m and v bit-equal to the saved ones in device storage
    of their own, and the read equal to Adam applied once more to them."""
    import threading

    import numpy as np

    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.optim import rules
    from mpit_tpu_torch.ps import ParamClient, ParamServer
    from mpit_tpu_torch.utils import checkpoint as ckpt

    n = flatten_module(make_model(GANG_BASE["model"], GANG_BASE["side"]), 1).size // 2
    rule = rules.make("adam", lr=1e-3)
    rng = np.random.default_rng(8)
    w0 = rng.normal(size=n).astype(np.float32)
    g1, g2 = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    router = LocalRouter(2)
    s1 = ParamServer(0, [1], router.endpoint(0), rule=rule, device=GANG_BASE["device"])
    t1 = threading.Thread(target=s1.start, daemon=True)
    t1.start()
    client = ParamClient(1, [0], router.endpoint(1), seed_servers=True,
                         ft=FTConfig(op_deadline_s=0.2, max_retries=40,
                                     backoff_base_s=0.01, backoff_cap_s=0.05))
    param, grad = w0.copy(), g1.copy()
    client.start(param, grad)
    zero_counts(kernels)
    client.async_send_grad()
    client.wait()
    s1.live.stop()
    t1.join(30)
    saved = {"param": s1.param.clone(), **{k: v.clone() for k, v in s1.rule_state.items()}}
    t_kill = time.perf_counter()
    t0 = time.perf_counter()
    s1.save_state(tmp)
    save_s = time.perf_counter() - t0
    grad[:] = g2
    client.async_send_grad()  # into the void, retried until served
    client.async_recv_param()
    t0 = time.monotonic()
    while client.retries == 0 and time.monotonic() < t0 + 10:
        client.ping()  # the GRAD goes out, times out and is sent again
        time.sleep(0.01)
    loaded = {}

    def load(path):
        out = real_load(path)
        loaded["arrays"] = [out[2], *out[3].values()]
        return out

    real_load = ckpt.load_server_state
    ckpt.load_server_state = load
    try:
        s2 = ParamServer(0, [1], router.endpoint(0), rule=rule, device=GANG_BASE["device"],
                         ft=FTConfig(rejoin=True))
        t0 = time.perf_counter()
        s2.restore_state(os.path.join(tmp, "server0_latest.npz"))
        if s2.param.is_cuda:
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        ckpt.load_server_state = real_load
    restored = {"param": s2.param, **s2.rule_state}
    for key, t in restored.items():
        if t.device.type != GANG_BASE["device"] or not torch.equal(t, saved[key]):
            raise AssertionError(f"ft_server_restart: restored {key} differs from the "
                                 "saved one or is off the card")
    spans = [(a.ctypes.data, a.ctypes.data + a.nbytes) for a in loaded["arrays"]]
    ptrs = [t.untyped_storage().data_ptr() for t in restored.values()]
    if len(set(ptrs)) != len(ptrs) or any(lo <= p < hi for p in ptrs for lo, hi in spans):
        raise AssertionError("ft_server_restart: restored tensors share storage")
    t2 = threading.Thread(target=s2.start, daemon=True)
    t2.start()
    client.wait()
    back_s = time.perf_counter() - t_kill
    client.stop()
    t2.join(30)
    launches = read_counts(kernels)
    # What the read must see: Adam applied once more to the saved state
    # (this K3 launch compares; the path's launches were read before it).
    want_p = saved["param"].clone()
    rule.apply(want_p, torch.from_numpy(g2).to(want_p.device),
               {k: v.clone() for k, v in saved.items() if k != "param"})
    if s2.grads_applied != 2 or s2.restored_applied != 1 or s2.dup_ops < 1:
        raise AssertionError(f"ft_server_restart: {s2.grads_applied} applies "
                             f"({s2.restored_applied} restored, {s2.dup_ops} dups), "
                             "expected 2 (1, the resent GRAD a DUP)")
    if param.tobytes() != want_p.cpu().numpy().tobytes():
        raise AssertionError("ft_server_restart: the read is not the restored state "
                             "plus one Adam step")
    expect_launches("ft_server_restart", launches, {"k3": 2})
    reading = {"save_s": save_s, "restore_s": restore_s, "stop_to_served_s": back_s,
               "retries": client.retries, "dups": s2.dup_ops, "floats": n}
    print("ft_server_restart: " + json.dumps(reading))
    print(f"ft_server_restart on {smi}: save_state at {n:,} floats (p, m, v) "
          f"{save_s * 1e3:.1f} ms, restore_state onto the card {restore_s * 1e3:.1f} ms")
    record_path(all_paths, "ft_server_restart", launches, 1)


def ft_lease_eviction(torch, kernels, all_paths, smi):
    """Two workers heartbeat to an Adam server on the card holding the whole
    flagship vector; one goes silent.  It is evicted within 1.5x the lease
    TTL, the survivor finishes its rounds, and the silent one rejoins as
    epoch 1 and has its GRADs admitted."""
    import threading

    import numpy as np

    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.ft import EVICTED, FaultPlan, FaultyTransport, FTConfig
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.optim import rules
    from mpit_tpu_torch.ps import ParamClient, ParamServer

    n = flatten_module(make_model(GANG_BASE["model"], GANG_BASE["side"]), 1).size
    rng = np.random.default_rng(9)
    router = LocalRouter(3)
    server = ParamServer(0, [1, 2], router.endpoint(0), rule=rules.make("adam", lr=1e-3),
                         device=GANG_BASE["device"], ft=FTConfig(lease_ttl_s=FT_LEASE_TTL_S,
                                                    rejoin=True))
    st = threading.Thread(target=server.start, daemon=True)
    st.start()
    beat = dict(heartbeat_s=0.05, op_deadline_s=1.0, max_retries=8,
                backoff_base_s=0.005, backoff_cap_s=0.05)
    silent_ep = FaultyTransport(router.endpoint(2), FaultPlan())
    c1 = ParamClient(1, [0], router.endpoint(1), seed_servers=True, ft=FTConfig(**beat))
    c2 = ParamClient(2, [0], silent_ep, ft=FTConfig(**beat))
    bufs = [(rng.normal(size=n).astype(np.float32), np.zeros(n, np.float32)),
            (np.zeros(n, np.float32), np.zeros(n, np.float32))]
    ft_start([c1, c2], [lambda: c1.start(*bufs[0]), lambda: c2.start(*bufs[1])])
    zero_counts(kernels)

    def step(c, bufs):
        bufs[1][:] = rng.normal(size=n).astype(np.float32)
        c.async_send_grad()
        c.async_recv_param()
        c.wait()

    for _ in range(3):
        step(c1, bufs[0])
        step(c2, bufs[1])
    deadline = time.monotonic() + 10
    while server.heartbeats_seen < 4 and time.monotonic() < deadline:
        c2.ping()
        time.sleep(0.01)
    silent_ep.sever(0)
    t0 = time.monotonic()
    while server.leases.state(2) != EVICTED and time.monotonic() < t0 + 10:
        c1.ping()
        time.sleep(0.005)
    evict_s = time.monotonic() - t0
    if server.leases.state(2) != EVICTED or evict_s > 1.5 * FT_LEASE_TTL_S:
        raise AssertionError(f"ft_lease_eviction: evicted {server.leases.state(2)} "
                             f"after {evict_s:.3f}s (TTL {FT_LEASE_TTL_S}s)")
    for _ in range(5):  # the survivor finishes its rounds
        step(c1, bufs[0])
    c2b = ParamClient(2, [0], silent_ep.inner, ft=FTConfig(**beat, epoch=1))
    buf2b = (np.zeros(n, np.float32), np.zeros(n, np.float32))
    c2b.start(*buf2b)
    for _ in range(2):
        step(c2b, buf2b)
    c1.stop()
    c2b.stop()
    st.join(30)
    launches = read_counts(kernels)
    admitted = {f"{c}:{e}": v for (c, e), v in server.admitted.items()}
    if admitted.get("2:1") != [1, 2, 2] or server.rejoins != 1 \
            or server.evictions != 1:
        raise AssertionError(f"ft_lease_eviction: admitted {admitted}, rejoins "
                             f"{server.rejoins}, evictions {server.evictions}")
    expect_launches("ft_lease_eviction", launches, {"k3": server.grads_applied})
    reading = {"silence_to_eviction_s": evict_s, "ttl_s": FT_LEASE_TTL_S,
               "admitted": admitted, "grads_applied": server.grads_applied,
               "heartbeats_seen": server.heartbeats_seen}
    print("ft_lease_eviction: " + json.dumps(reading))
    print(f"ft_lease_eviction on {smi}: silence to eviction {evict_s:.3f} s at a "
          f"{FT_LEASE_TTL_S} s lease")
    record_path(all_paths, "ft_lease_eviction", launches, 10)


def ft_chaos_gang(name, kill_rank, after_s, epochs, addrs, ckpt_dir):
    """``launch --np 4 --opt adam --transport tcp --ft_heartbeat_s 0.25
    --ft_lease_ttl_s 20 --ft_op_deadline_s 5 --supervise 2
    --server_ckpt_dir d --server_ckpt_interval 2`` at the flagship widths,
    every child on the card, with the supervisor SIGKILLing
    ``kill_rank`` ``after_s`` seconds after the first checkpoint of its
    server (the victim itself, or server 0 for a worker) is on disk: the
    gang is training by then, however long its start-up took."""
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    cfg = LAUNCH_DEFAULTS.parse_args([
        "--np", "4", "--opt", "adam", "--transport", "tcp", "--ft_heartbeat_s", "0.25",
        "--ft_lease_ttl_s", "20", "--ft_op_deadline_s", "5", "--supervise", "2",
        "--server_ckpt_dir", ckpt_dir, "--server_ckpt_interval", "2"]).merged(
        GANG_BASE, lr=1e-3, su=1, epochs=epochs, tcp_addrs=",".join(addrs))
    marker = os.path.join(ckpt_dir, f"server{kill_rank if kill_rank == 2 else 0}"
                          "_latest.npz")
    t0 = time.perf_counter()
    results = launch_processes(cfg, timeout=900, chaos=dict(
        chaos_kill_rank=kill_rank, chaos_kill_after_s=after_s,
        chaos_when=functools.partial(os.path.exists, marker)))
    return name, results, time.perf_counter() - t0


def ft_chaos_check(name, results, kill_rank, fault_free_err):
    """The supervised gang's checks: roles, one restart of the victim, a
    replacement worker at epoch 1, both workers inside the fault-free
    envelope, each server process's K3 equal to its own applies, and the
    exactly-once accounting.  Returns the reading."""
    from mpit_tpu_torch.ft.supervisor import grad_accounting

    roles = {r: v["role"] for r, v in results.items()}
    if roles != {0: "server", 1: "worker", 2: "server", 3: "worker"}:
        raise AssertionError(f"{name}: roles {roles}")
    restarts = [results[r]["restarts"] for r in range(4)]
    if restarts != [int(r == kill_rank) for r in range(4)]:
        raise AssertionError(f"{name}: restarts {restarts}")
    off = {r: v["platform"] for r, v in results.items()
           if v["platform"] != GANG_BASE["device"]}
    if off:
        raise AssertionError(f"{name}: ranks off the card: {off}")
    epochs = {r: results[r]["epoch"] for r in (1, 3)}
    if epochs != {1: 0, 3: int(kill_rank == 3)}:
        raise AssertionError(f"{name}: worker epochs {epochs}")
    errs = [results[r]["final_test_err"] for r in (1, 3)]
    if max(errs) > max(fault_free_err):
        raise AssertionError(f"{name}: test errors {errs} outside the fault-free "
                             f"envelope {fault_free_err}")
    for r in (0, 2):
        srv = results[r]
        here = srv["grads_applied"] - srv["restored_applied"]
        if srv["launches"]["k3"] != here:
            raise AssertionError(f"{name}: server {r} launched K3 "
                                 f"{srv['launches']['k3']} times for {here} applies")
    books = grad_accounting(results)
    victim = results[kill_rank]
    if kill_rank == 3:
        back_at = min(results[s]["rejoined_at"][0] for s in (0, 2))
        if set(books[0]["landed"]) != {"3:0"} or books[0]["lost"] or books[2]["lost"]:
            raise AssertionError(f"{name}: accounting {books}")
    else:
        back_at = victim["serving_since"]
        if not victim["restored"] or books[0]["lost"]:
            raise AssertionError(f"{name}: accounting {books}")
    return {"kill_to_rejoin_s": back_at - victim["chaos_killed_at"],
            "books": books, "test_err": errs,
            "worker_steps": [results[r]["steps"] for r in (1, 3)],
            "launches": {k: sum(v["launches"][k] for v in results.values())
                         for k in ("k1", "k2", "k3")}}


def ft_chaos_procs(torch, all_paths, smi, timing, tmp):
    """Two supervised process gangs side by side: one whose worker rank 3
    is SIGKILLed once it has taken steps, one whose server rank 2 is.
    The kill lands 2 s after the first checkpoint of the victim's server
    (written 2 s into training), whatever the children's start-up (this
    call measured it above); the epochs are sized from this call's
    process-gang epoch for ~20 s of training, so the victim is still
    training when the kill lands."""
    from concurrent.futures import ThreadPoolExecutor

    from mpit_tpu_torch.comm.tcp import allocate_local_addresses

    startup, epoch_s = timing["startup_s"], timing["epoch_s"]
    after_s = 2.0
    epochs = max(int(math.ceil(20.0 / epoch_s)), 4)
    print(f"ft_chaos_procs: start-up {startup:.1f}s, epoch {epoch_s:.3f}s: kill "
          f"{after_s:.1f}s after the first checkpoint, {epochs} epochs")
    gangs = []
    for kill_rank in (3, 2):
        addrs, socks = allocate_local_addresses(4)
        for sock in socks:
            sock.close()  # the gang's ranks bind these ports
        ckpt_dir = os.path.join(tmp, f"chaos{kill_rank}")
        gangs.append((f"ft_chaos_kill_{'worker' if kill_rank == 3 else 'server'}",
                      kill_rank, after_s, epochs, addrs, ckpt_dir))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        done = [pool.submit(ft_chaos_gang, *g) for g in gangs]
        done = [f.result() for f in done]
    wall = time.perf_counter() - t0
    for (name, results, gang_wall), g in zip(done, gangs):
        reading = ft_chaos_check(name, results, g[1], timing["adam_test_err"])
        reading["wall_s"] = gang_wall
        print(f"{name}: " + json.dumps(reading))
        landed = reading["books"][0]["landed"]
        print(f"{name} on {smi}: kill to rejoin {reading['kill_to_rejoin_s']:.1f} s"
              + (f", the kill landed at GRAD {landed['3:0']} of worker 3"
                 if landed else f", {reading['books'][2]['lost']} GRADs the dead server "
                 "acked after its last checkpoint (one every 2 s) lost"))
        record_path(all_paths, name, reading["launches"], sum(reading["worker_steps"]))
    return wall


def ft_phases(torch, kernels, all_paths, smi, timing):
    """Fault tolerance on the card (slice 5a): the supervised process gangs
    run in the background while this process drives the retry/dedup
    matrix, the server restart and the lease eviction."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        chaos = pool.submit(ft_chaos_procs, torch, all_paths, smi, timing, tmp)
        t1 = time.perf_counter()
        ft_retry_dedup(torch, kernels, all_paths, smi)
        ft_server_restart(torch, kernels, all_paths, smi, tmp)
        ft_lease_eviction(torch, kernels, all_paths, smi)
        inproc_s = time.perf_counter() - t1
        chaos_s = chaos.result()
    print(f"ft phases: {time.perf_counter() - t0:.1f}s (in-process {inproc_s:.1f}s, "
          f"supervised gangs {chaos_s:.1f}s, side by side)")



# -- shard control (slice 5c) ------------------------------------------------------

#: lockstep rounds of the shard-control gangs (the FT gangs' count)
SC_ROUNDS = 8
#: their clients' FT: a deadline no lockstep op on the card comes near
SC_FT = dict(op_deadline_s=5.0, max_retries=8, backoff_base_s=0.005, backoff_cap_s=0.02)
#: the chunked SHARD_STATE leg's cut: below a shard's bytes at 2 shards a
#: server (544,522 / 4 floats = 544 KB), so the param leg is 3 messages
SC_CHUNK_BYTES = 262144


def sc_gang(shards_per_server, ckpt_dir=None, ctl_kwargs=None):
    """2 Adam servers (ranks 0, 1) on the card, 2 shard-control clients (2,
    3) and the controller (4) over one in-process router; the servers run
    on threads.  Returns (servers, clients, threads, ctl)."""
    import threading

    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.optim import rules
    from mpit_tpu_torch.ps import ParamClient, ParamServer
    from mpit_tpu_torch.shardctl import RebalancePolicy, ShardController

    router = LocalRouter(5)
    servers = [ParamServer(r, [2, 3], router.endpoint(r), rule=rules.make("adam", lr=1e-3),
                           device=GANG_BASE["device"], ft=FTConfig(**SC_FT),
                           controller_rank=4, ckpt_dir=ckpt_dir, ckpt_interval=1e9)
               for r in (0, 1)]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    # The rebalance policy is off: only the phase's own moves happen.
    ctl = ShardController(4, router.endpoint(4), [0, 1], [2, 3],
                          policy=RebalancePolicy(enabled=False), **(ctl_kwargs or {}))
    clients = [ParamClient(r, [0, 1], router.endpoint(r), seed_servers=(r == 2),
                           ft=FTConfig(**SC_FT), shardctl=True, controller_rank=4,
                           sc_shards_per_server=shards_per_server)
               for r in (2, 3)]
    return servers, clients, threads, ctl


def sc_lockstep_adam(torch, kernels, data, name, shards_per_server=1, hook=None,
                     ckpt_dir=None, ctl_kwargs=None):
    """Two workers compute the flagship CNN's gradient on the card at the
    params they pull, in lockstep turns, against the shard-control gang of
    ``sc_gang``; ``hook(rnd, servers, threads, ctl)`` runs before each
    round.  K3's count is set to 0 after the seeding and must equal the
    applies summed over every owner, 2 workers x rounds x shards.  Returns
    the final params and the gang's readings."""
    import numpy as np

    from mpit_tpu_torch.models.flat import flatten_module, value_and_grad_nll_eager
    from mpit_tpu_torch.models.mnist import make_model

    flat = flatten_module(make_model(GANG_BASE["model"], GANG_BASE["side"]), 1,
                          GANG_BASE["device"])
    vgf = value_and_grad_nll_eager(flat)
    x, y = data
    batch = GANG_BASE["batch"]
    servers, clients, threads, ctl = sc_gang(shards_per_server, ckpt_dir, ctl_kwargs)
    params = [flat.w0.cpu().numpy().copy(), np.zeros(flat.size, np.float32)]
    grads = [np.zeros(flat.size, np.float32) for _ in clients]
    vgf(flat.w0, x[:batch], y[:batch])  # first-call costs out of the rounds
    ft_start(clients, [lambda c=c, i=i: c.start(params[i], grads[i])
                       for i, c in enumerate(clients)])
    ctl.pump()  # the seeder's map
    zero_counts(kernels)
    t0 = time.perf_counter()
    for rnd in range(SC_ROUNDS):
        if hook is not None:
            hook(rnd, servers, threads, ctl)
        for i, c in enumerate(clients):
            c.async_recv_param()
            c.wait()
            lo = ((rnd * len(clients) + i) * batch) % (len(x) - batch)
            _loss, g = vgf(torch.from_numpy(params[i]).to(GANG_BASE["device"]),
                           x[lo:lo + batch], y[lo:lo + batch])
            grads[i][:] = g.cpu().numpy()
            c.async_send_grad()
            c.wait()
    round_s = (time.perf_counter() - t0) / SC_ROUNDS
    clients[0].async_recv_param()
    clients[0].wait()
    final = params[0].copy()
    for c in clients:
        c.stop()
    for t in threads:
        t.join(60)
        if t.is_alive():
            raise AssertionError(f"{name}: a server did not stop")
    ctl.pump()
    if not ctl.done:
        raise AssertionError(f"{name}: the controller missed the clients' STOPs")
    nshards = 2 * shards_per_server
    applied = sum(s.grads_applied for s in servers)
    launches = read_counts(kernels)
    if applied != 2 * SC_ROUNDS * nshards:
        raise AssertionError(f"{name}: {applied} applies for {SC_ROUNDS} rounds of 2 "
                             f"workers on {nshards} shards")
    expect_launches(name, launches, {"k3": applied})
    for s in servers:
        for sid in s.owned_shards:
            slot = s._slots[sid]
            tensors = [slot.param, *slot.rule_state.values()]
            if any(t.device.type != GANG_BASE["device"] for t in tensors) \
                    or not slot.param.is_contiguous():
                raise AssertionError(f"{name}: shard {sid} of server {s.rank} is off "
                                     "the card or not contiguous")
    return final, {"launches": launches, "applied": applied, "round_s": round_s,
                   "map": [[e.shard_id, e.owner] for e in ctl.smap.entries],
                   "nacks": sum(int(c._m_nacks.value) for c in clients),
                   "reroutes": sum(int(c._m_reroutes.value) for c in clients),
                   "per_server": [s.grads_applied for s in servers]}


def sc_handoff_probe(dst, sid, box):
    """Time a live migration of shard ``sid`` to ``dst``: the SHARD_STATE
    messages (count and bytes, where the source packs them) and the first
    OK the new owner gives for the shard (the end of the freeze window,
    which starts with the controller's RELEASE)."""
    from mpit_tpu_torch.shardctl import migrate as scmigrate
    from mpit_tpu_torch.shardctl import wire as scwire

    pack = scmigrate.pack_shard_state

    def counted_pack(slot, chunk_bytes=None):
        t0 = time.perf_counter()
        msgs = pack(slot, chunk_bytes)
        box["pack_ms"] = (time.perf_counter() - t0) * 1e3
        box["state_msgs"] = len(msgs)
        box["state_bytes"] = int(sum(m.nbytes for m in msgs))
        return msgs

    verdict = dst._sc_verdict

    def first_ok(s):
        v = verdict(s)
        if s == sid and v == scwire.OK and "first_ok" not in box:
            box["first_ok"] = time.perf_counter()
        return v

    scmigrate.pack_shard_state = counted_pack
    dst._sc_verdict = first_ok
    return lambda: setattr(scmigrate, "pack_shard_state", pack)


def sc_migrate_adam(torch, kernels, data, all_paths, smi):
    """Live migration of server-side Adam shards on the card: the static
    map, then shard 1 moved from server 1 to server 0 at round 3, then at
    2 shards a server (4 shards) shard 3 moved to server 0 at round 3 with
    the SHARD_STATE param leg cut at ``SC_CHUNK_BYTES``.  Each is bit for
    bit the static run, K3 = the applies over both owners (the static
    run's count at the same cut), and the drain went through NACK_MAP."""
    from mpit_tpu_torch.shardctl import migrate as scmigrate

    static, st = sc_lockstep_adam(torch, kernels, data, "sc_static_adam")
    static4, st4 = sc_lockstep_adam(torch, kernels, data, "sc_static_adam_4shards",
                                    shards_per_server=2)
    readings = {}
    for name, k, sid, cut in (("sc_migrate_adam", 1, 1, None),
                              ("sc_migrate_adam_4shards_chunked", 2, 3, SC_CHUNK_BYTES)):
        box = {}
        restore = []

        def hook(rnd, servers, threads, ctl, box=box, sid=sid, restore=restore):
            if rnd != 3:
                return
            restore.append(sc_handoff_probe(servers[0], sid, box))
            box["release"] = time.perf_counter()
            if not ctl.migrate(sid, 0):
                raise AssertionError(f"migrate({sid}, 0) refused")
            box["handoff_ms"] = (time.perf_counter() - box["release"]) * 1e3

        saved = scmigrate.SC_CHUNK_BYTES
        if cut is not None:
            scmigrate.SC_CHUNK_BYTES = cut
        try:
            got, r = sc_lockstep_adam(torch, kernels, data, name, shards_per_server=k,
                                      hook=hook)
        finally:
            scmigrate.SC_CHUNK_BYTES = saved
            for fn in restore:
                fn()
        want, want_stats = (static, st) if k == 1 else (static4, st4)
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"{name}: params differ from the static map's "
                                 f"(max gap {abs(got - want).max()})")
        if r["launches"]["k3"] != want_stats["launches"]["k3"]:
            raise AssertionError(f"{name}: K3 {r['launches']['k3']}, the static run's "
                                 f"{want_stats['launches']['k3']}")
        if not r["nacks"] > 0 or dict(r["map"])[sid] != 0:
            raise AssertionError(f"{name}: no NACK_MAP drain, or map {r['map']}")
        shard_bytes = 4 * (-(-len(got) // (2 * k)))
        if cut is not None and box["state_msgs"] < 2 + 3 + -(-shard_bytes // cut) - 1:
            raise AssertionError(f"{name}: the param leg was not chunked: {box}")
        r.update(freeze_ms=(box["first_ok"] - box["release"]) * 1e3,
                 handoff_ms=box["handoff_ms"], pack_ms=box["pack_ms"],
                 state_msgs=box["state_msgs"], state_bytes=box["state_bytes"])
        readings[name] = r
        print(f"{name}: " + json.dumps(r))
        print(f"{name} on {smi}: freeze window (RELEASE to the first OK on the new "
              f"owner) {r['freeze_ms']:.2f} ms, SHARD_STATE {r['state_bytes']} bytes in "
              f"{r['state_msgs']} messages, RELEASE to DONE {r['handoff_ms']:.2f} ms "
              f"(pack {r['pack_ms']:.2f} ms); a round {r['round_s'] * 1e3:.1f} ms "
              f"(static {st['round_s'] * 1e3:.1f} ms); K3 {r['launches']['k3']}")
        record_path(all_paths, name, r["launches"], 2 * SC_ROUNDS)
    record_path(all_paths, "sc_static_adam", st["launches"], 2 * SC_ROUNDS)
    return static, st


def sc_failover_adam(torch, kernels, data, all_paths, smi, static, st):
    """Lease-expiry failover on the card: after round 3 server 1 checkpoints
    its shard (``shard1_latest.npz``) and dies; the controller's clock jumps
    past the lease while server 0 keeps beating, and server 0 ADOPTs the
    shard from the checkpoint.  Bit for bit the static run, with K3 = the
    applies of the dead and the adopting owner."""
    import tempfile

    now = [0.0]
    box = {}

    def hook(rnd, servers, threads, ctl):
        now[0] += 1.0
        if rnd != 3:
            return
        t0 = time.perf_counter()
        while ctl.leases._expiry.get(1) is None:  # a beat armed the lease
            ctl.pump()
            if time.perf_counter() - t0 > 20:
                raise AssertionError("sc_failover_adam: no beat from server 1")
            time.sleep(0.01)
        t1 = time.perf_counter()
        servers[1].save_state(ckpt)
        box["ckpt_ms"] = (time.perf_counter() - t1) * 1e3
        servers[1].live.stop()
        threads[1].join(30)
        ctl._drain_beats()
        now[0] += 100.0
        t0 = time.perf_counter()
        while ctl.leases._expiry.get(0) is not None and ctl.leases._expiry[0] < now[0]:
            ctl._drain_beats()
            if time.perf_counter() - t0 > 20:
                raise AssertionError("sc_failover_adam: no fresh beat from server 0")
            time.sleep(0.01)
        t1 = time.perf_counter()
        ctl.check_leases()
        box["adopt_ms"] = (time.perf_counter() - t1) * 1e3
        if ctl.smap.owner(1) != 0:
            raise AssertionError("sc_failover_adam: failover did not move shard 1")

    with tempfile.TemporaryDirectory() as ckpt:
        got, r = sc_lockstep_adam(torch, kernels, data, "sc_failover_adam", hook=hook,
                                  ckpt_dir=ckpt,
                                  ctl_kwargs=dict(lease_ttl_s=5.0, clock=lambda: now[0]))
    if got.tobytes() != static.tobytes():
        raise AssertionError("sc_failover_adam: params differ from the static map's "
                             f"(max gap {abs(got - static).max()})")
    if r["launches"]["k3"] != st["launches"]["k3"] or min(r["per_server"]) == 0:
        raise AssertionError(f"sc_failover_adam: K3 {r['launches']['k3']} over applies "
                             f"{r['per_server']}")
    r.update(box)
    print("sc_failover_adam: " + json.dumps(r))
    print(f"sc_failover_adam on {smi}: checkpoint {box['ckpt_ms']:.2f} ms, lease expiry "
          f"to the adopted shard's DONE {box['adopt_ms']:.2f} ms; K3 "
          f"{r['launches']['k3']} = applies {r['per_server']} of the dead and the "
          "adopting owner")
    record_path(all_paths, "sc_failover_adam", r["launches"], 2 * SC_ROUNDS)


def http_metric(port, name, rank):
    """One counter of one rank's ``/metrics`` (None while it is not up)."""
    import re

    try:
        with urllib_request().urlopen(f"http://127.0.0.1:{port}/metrics", timeout=1) as r:
            text = r.read().decode()
    except OSError:
        return None
    m = re.search(rf'^{name}\{{rank="{rank}"\}} ([0-9.e+]+)$', text, re.M)
    return float(m.group(1)) if m else None


def urllib_request():
    import urllib.request

    return urllib.request


def elastic_adam_procs(all_paths, smi, timing):
    """``launch --np 5 --elastic 1 --elastic_spares 1 --opt adam --transport
    tcp --supervise 2`` at the flagship widths, every rank on the card:
    once the gang trains, this process asks the controller's ``/scale``
    route (statusd, ``MPIT_OBS_HTTP``) for a server; the supervisor spawns
    the spare rank 5 and the controller moves a shard onto it; then the
    supervisor SIGTERMs server rank 2 with a 25 s grace, which checkpoints,
    reports PREEMPT and is drained and retired.  Held: both events
    counted, the final map tiles the vector with each shard owned once by
    a live server, every server process's K3 equal to its applies, the
    workers under the reference soak's test-error bound (0.8).  The
    epochs are sized from this call's process-gang epoch for ~45 s of
    training, which holds the joiner's start-up."""
    import signal
    import tempfile
    import threading

    from mpit_tpu_torch.comm.tcp import allocate_local_addresses
    from mpit_tpu_torch.obs.statusd import free_base_port
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    epochs = max(int(math.ceil(45.0 / timing["epoch_s"])), 6)
    addrs, socks = allocate_local_addresses(6)
    for sock in socks:
        sock.close()
    base = free_base_port(6)
    box = {}
    up_done = threading.Event()

    def operator():
        http = urllib_request()
        t0 = time.time()
        while time.time() - t0 < 300:  # the controller holds the seeder's map
            try:
                with http.urlopen(f"http://127.0.0.1:{base + 4}/status", timeout=1) as r:
                    if (json.loads(r.read()).get("controller") or {}).get(
                            "map_version") is not None:
                        break
            except OSError:
                pass
            time.sleep(0.2)
        time.sleep(2.0)
        box["scale_at"] = time.time()
        with http.urlopen(f"http://127.0.0.1:{base + 4}/scale?op=up", timeout=5) as r:
            box["scale"] = json.loads(r.read())
        while not (http_metric(base + 5, "mpit_ps_grads_applied_total", 5) or 0) > 0:
            if time.time() - box["scale_at"] > 300:
                return
            time.sleep(0.05)
        box["first_apply_at"] = time.time()
        up_done.set()
        while True:
            try:
                with http.urlopen(f"http://127.0.0.1:{base + 4}/status", timeout=1) as r:
                    st = json.loads(r.read()).get("controller") or {}
                if 2 in st.get("retired", []):
                    box["retired_at"] = time.time()
                    return
            except OSError:
                return
            time.sleep(0.02)

    saved = os.environ.get("MPIT_OBS_HTTP")
    os.environ["MPIT_OBS_HTTP"] = str(base)
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            cfg = LAUNCH_DEFAULTS.parse_args([
                "--np", "5", "--opt", "adam", "--transport", "tcp", "--elastic", "1",
                "--elastic_spares", "1", "--elastic_grace_s", "25", "--supervise", "2",
                "--ft_heartbeat_s", "0.25", "--ft_lease_ttl_s", "30",
                "--ft_op_deadline_s", "5", "--shardctl_lease_ttl_s", "30",
                # the rebalance policy stays quiet: the moves under test are
                # the scale-up's and the drain's (ptest's skew legs hold the
                # policy)
                "--shardctl_ratio", "1000",
                "--server_ckpt_dir", ckpt, "--server_ckpt_interval", "2"]).merged(
                GANG_BASE, lr=1e-3, su=1, epochs=epochs, tcp_addrs=",".join(addrs))
            th = threading.Thread(target=operator, daemon=True)
            th.start()
            t0 = time.perf_counter()
            results = launch_processes(cfg, timeout=900, chaos=dict(
                chaos_kill_rank=2, chaos_kill_after_s=1.0, chaos_signal=signal.SIGTERM,
                chaos_grace_s=25.0, chaos_when=up_done.is_set))
            wall = time.perf_counter() - t0
            th.join(10)
    finally:
        if saved is None:
            os.environ.pop("MPIT_OBS_HTTP", None)
        else:
            os.environ["MPIT_OBS_HTTP"] = saved
    name = "elastic_adam_procs"
    roles = {r: v["role"] for r, v in results.items()}
    if roles != {0: "server", 1: "worker", 2: "server", 3: "worker", 4: "controller",
                 5: "server"}:
        raise AssertionError(f"{name}: roles {roles}")
    ctl = results[4]
    ev = ctl["elastic_events"]
    if not (ev["up"] >= 1 and ev["preempt"] >= 1 and ev["down"] >= 1):
        raise AssertionError(f"{name}: elastic events {ev}")
    cut = sorted(ctl["map"])
    n_params = sum(size for _sid, _off, size, _owner in cut)
    at = 0
    for sid, off, size, owner in cut:
        if off != at or owner not in (0, 5) or size <= 0:
            raise AssertionError(f"{name}: the final map {cut} does not tile the vector "
                                 "over live servers")
        at += size
    owned = sorted(s for r in (0, 2, 5) for s in results[r]["owned_shards"])
    if owned != [c[0] for c in cut] or not results[2]["retired"]:
        raise AssertionError(f"{name}: shards owned {owned}, map {cut}, rank 2 retired "
                             f"{results[2]['retired']}")
    off = {r: v["platform"] for r, v in results.items() if v["platform"] != "cuda"}
    if off:
        raise AssertionError(f"{name}: ranks off the card: {off}")
    for r in (0, 2, 5):
        srv = results[r]
        if srv["launches"]["k3"] != srv["grads_applied"] or not srv["grads_applied"]:
            raise AssertionError(f"{name}: server {r} launched K3 "
                                 f"{srv['launches']['k3']} times for "
                                 f"{srv['grads_applied']} applies")
    errs = [results[r]["final_test_err"] for r in (1, 3)]
    if max(errs) >= 0.8:
        raise AssertionError(f"{name}: worker test errors {errs}")
    reading = {
        "wall_s": wall, "epochs": epochs, "n_params": n_params, "events": ev,
        "map": cut, "membership_epoch": ctl["membership_epoch"],
        "applies": {r: results[r]["grads_applied"] for r in (0, 2, 5)},
        "spawn_to_first_apply_s": box["first_apply_at"] - box["scale_at"],
        "drain_ms": ((box["retired_at"] - results[2]["chaos_killed_at"]) * 1e3
                     if "retired_at" in box else None),
        "test_err": errs,
        "launches": {k: sum(v["launches"][k] for v in results.values())
                     for k in ("k1", "k2", "k3")}}
    print(f"{name}: " + json.dumps(reading))
    print(f"{name} on {smi}: /scale to the joiner's first apply "
          f"{reading['spawn_to_first_apply_s']:.1f} s, SIGTERM to retired "
          f"{reading['drain_ms']} ms, {epochs} epochs in {wall:.1f} s")
    record_path(all_paths, name, reading["launches"],
                sum(results[r]["steps"] for r in (1, 3)))
    return wall


#: rounds of each of ptest's shard-control legs: 20 took the block 112.6-128.9 s
#: on an H100, of it the two straggler legs 23-25 s; 10 keeps the whole script
#: inside its time beside the ring block
PTEST_SC_ROUNDS = "10"


def ptest_sc_legs(smi):
    """``tools/torch_ptest.py``'s shard-control legs at 16 MB: the codec-none
    leg, the straggler A/B (rebalance off, then on: the on-leg's map must
    have moved) and the 1 -> 2 -> 1 elastic sweep, MB/s printed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_ptest.py")],
                          env=dict(os.environ, MPIT_BENCH_CODECS="none", MPIT_BENCH_MB="16",
                                   MPIT_BENCH_ROUNDS=PTEST_SC_ROUNDS, MPIT_BENCH_SKEW="1",
                                   MPIT_BENCH_ELASTIC="1"),
                          capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise AssertionError(f"ptest shard-control legs failed ({proc.returncode}):\n"
                             f"{proc.stdout}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    for row in rows:
        print(f"ptest_sc on {smi}: " + json.dumps(row))
    skew = [r for r in rows if r.get("skew")]
    el = [r for r in rows if r.get("elastic")]
    if [r["rebalance"] for r in skew] != [0, 1] or not skew[1]["map_version"] > 0 \
            or skew[0]["map_version"] != 0:
        raise AssertionError(f"ptest skew legs: {skew}")
    if [r["phase"] for r in el] != ["start", "grown", "shrunk"] \
            or [r["servers"] for r in el] != [1, 2, 1] \
            or not all(r["value"] > 0 for r in rows):
        raise AssertionError(f"ptest elastic legs: {el}")
    print(f"ptest_sc on {smi}: straggler {skew[0]['value']} MB/s static, "
          f"{skew[1]['value']} MB/s rebalanced (map v{skew[1]['map_version']}); elastic "
          f"1 -> 2 -> 1 servers {[r['value'] for r in el]} MB/s; "
          f"{time.perf_counter() - t0:.1f}s")
    return time.perf_counter() - t0


def sc_phases(torch, kernels, all_paths, smi, timing):
    """Shard control (slice 5c) on the card: the elastic process gang and
    the ptest legs run in the background, side by side, while this process
    drives the live migrations and the failover of Adam shards."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mpit_tpu_torch.data.mnist import load_mnist

    from mpit_tpu_torch import obs

    raw, _ = load_mnist(side=GANG_BASE["side"])
    data = (torch.as_tensor(raw[0], device=GANG_BASE["device"]),
            torch.as_tensor(np.asarray(raw[1]), dtype=torch.int64, device=GANG_BASE["device"]))
    # The elastic gang sets MPIT_OBS_HTTP for its children while this
    # process builds its own gangs: obs stays off here, so each in-process
    # server counts into a registry of its own.
    obs.configure(enabled=False)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        procs = pool.submit(elastic_adam_procs, all_paths, smi, timing)
        ptest = pool.submit(ptest_sc_legs, smi)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            t1 = time.perf_counter()
            static, st = sc_migrate_adam(torch, kernels, data, all_paths, smi)
            sc_failover_adam(torch, kernels, data, all_paths, smi, static, st)
            inproc_s = time.perf_counter() - t1
        finally:
            torch.backends.cudnn.deterministic = deterministic
        procs_s, ptest_s = procs.result(), ptest.result()
    obs.configure(enabled=None)
    print(f"shard-control phases: {time.perf_counter() - t0:.1f}s (in-process "
          f"{inproc_s:.1f}s; beside it the elastic gang {procs_s:.1f}s and the ptest "
          f"legs {ptest_s:.1f}s)")


# -- the read path (slices 5d and 5e) -----------------------------------------------

#: serve_readers_adam: READ-ONLY readers in this process, reads each, the
#: writer's lockstep rounds and each server's admission budget (a shard's
#: frame is 1.09 MB, so about three replies fit in flight: the first wave,
#: every reader at once, draws BUSY)
SERVE_READERS = 64
SERVE_READS = 5
SERVE_ROUNDS = 8
SERVE_BUDGET_MB = 4.0
#: cells_fabric_adam: fabric-routed readers, reads each, the bound
CELL_READERS = 32
CELL_READS = 6
CELL_MAX_LAG = 4
#: serve_cells_procs: role ranks (1 server + 1 worker), cells, readers
PROCS_CELLS = 2
PROCS_READERS = 4


def nofile():
    """This process's open-file limit, its soft limit lifted to the hard one
    (64 readers in one process hold ~5 descriptors each: two sockets, the
    selector and the wakeup pipe; the servers' side another two).
    Returns (soft before, soft now, hard)."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    return soft, resource.getrlimit(resource.RLIMIT_NOFILE)[0], hard


def serve_mesh(core, nranks):
    """The port's TCP transports of the ranks below ``core`` (full mesh
    among them, the event loop accepting the rest lazily), and every
    rank's address (ranks past ``core`` never listen)."""
    import threading

    from mpit_tpu_torch.comm.tcp import TcpTransport, allocate_local_addresses

    addrs, socks = allocate_local_addresses(core)
    addrs = addrs + ["127.0.0.1:0"] * (nranks - core)
    tr = {}

    def build(r):
        tr[r] = TcpTransport(r, nranks, addrs, listener=socks[r], reconnect=60.0,
                             dial_peers=list(range(r)))

    threads = [threading.Thread(target=build, args=(r,)) for r in range(core)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if len(tr) != core:
        raise AssertionError("serve: the TCP mesh did not form")
    return addrs, tr


def serve_grads(n, rounds, seed):
    """The writer's GRADs: seeded, the same in a readerless record and in
    the run it holds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal(n).astype(np.float32) * 0.05
    return w0, rng.standard_normal((rounds, n)).astype(np.float32) * 0.01


def serve_record(torch, nservers, w0, gtab):
    """The shards at every version, from a readerless run of the same
    lockstep GRADs: Adam servers on the card over the in-process router and
    one writer; after the seed (version 1) and after each acked GRAD
    (versions 2, 3, ...) each shard is copied to the host.  K3 is
    elementwise and deterministic, so these are the bytes a reader at that
    version must get.  Returns ({server rank: {version: shard}}, the
    copies' ms: each shard's device->host copy timed alone, after a
    synchronize, with nothing else running in this process)."""
    import threading

    import numpy as np

    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.optim import rules
    from mpit_tpu_torch.ps import ParamClient, ParamServer

    router = LocalRouter(nservers + 1)
    wrank = nservers
    servers = [ParamServer(r, [wrank], router.endpoint(r), rule=rules.make("adam", lr=1e-3),
                           device=GANG_BASE["device"]) for r in range(nservers)]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    grad = np.zeros_like(w0)
    client = ParamClient(wrank, list(range(nservers)), router.endpoint(wrank),
                         seed_servers=True, ft=FTConfig(op_deadline_s=30.0))
    client.start(w0.copy(), grad)
    out = {s.rank: {} for s in servers}
    copy_ms = []

    def snap():
        for s in servers:
            if s.param.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[s.rank][s._snap_version] = s.param.to("cpu", copy=True).numpy()
            copy_ms.append((time.perf_counter() - t0) * 1e3)

    snap()
    for g in gtab:
        grad[:] = g
        client.async_send_grad()
        client.wait()
        snap()
    client.stop()
    for t in threads:
        t.join(60)
        if t.is_alive():
            raise AssertionError("serve record: a server did not stop")
    return out, copy_ms


def timed_copies(server, log):
    """Wrap the server's snapshot cache: each new version's device->host
    copy is timed into ``log`` as (version, seconds)."""
    inner = server._host_snapshot

    def wrapped():
        fresh = server._snap_host is None or server._snap_host[0] != server._snap_version
        t0 = time.perf_counter()
        out = inner()
        if fresh:
            log.append((server._snap_version, time.perf_counter() - t0))
        return out

    server._host_snapshot = wrapped


def paced_reads(clients, reads, gap_s, on_read):
    """Drive readers from this thread: every reader's first read at once
    (the first wave), then each reader's next read ``gap_s`` after its last
    completed; ``on_read(rank, client, seconds)`` after each.  Raises the
    first reader error (a RetryExhausted is a failure here).  Returns the
    read window's seconds."""
    import heapq

    due = [(0.0, r) for r in clients]
    heapq.heapify(due)
    left = {r: reads for r in clients}
    started, inflight = {}, set()
    t0 = time.perf_counter()
    while due or inflight:
        now = time.perf_counter() - t0
        while due and due[0][0] <= now:
            _t, r = heapq.heappop(due)
            clients[r].async_read_params()
            started[r] = time.perf_counter()
            inflight.add(r)
        for r in list(inflight):
            if clients[r].poll():
                continue
            inflight.discard(r)
            clients[r].reads_done += 1
            on_read(r, clients[r], time.perf_counter() - started[r])
            left[r] -= 1
            if left[r]:
                heapq.heappush(due, (time.perf_counter() - t0 + gap_s, r))
        # Each pass steps every reader in flight while holding the
        # interpreter lock the servers' threads need: pace the passes.
        time.sleep(0.001 if inflight else 0.002)
    return time.perf_counter() - t0


def serve_writer(client, grad, gtab, gap_s, errors):
    """The writer's lockstep rounds on a thread: one GRAD, acked, then a
    pause, so the readers' reads spread over the versions."""
    import threading

    def run():
        try:
            for g in gtab:
                grad[:] = g
                client.async_send_grad()
                client.wait()
                time.sleep(gap_s)
        except BaseException as exc:  # noqa: BLE001 — raised by the caller
            errors.append(exc)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def read_stats(lat, nbytes, window):
    import numpy as np

    ms = np.asarray(lat) * 1e3
    return {"reads": len(lat), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mbs": len(lat) * nbytes / window / 2**20, "window_s": window}


def serve_readers_adam(torch, kernels, all_paths, smi):
    """2 Adam servers on the card at the flagship CNN's widths (544,522
    floats, 272,261 a shard), 1 writer running 8 lockstep rounds and 64
    READ-ONLY readers in this process, all over the port's TCP event loop;
    each server admits against a 4 MB budget.  Every read is bit for bit
    the shard at its stamped version (from a readerless record of the same
    GRADs), versions are monotone per reader, the first wave draws BUSY,
    which the readers honour, none exhausts its retries, each server makes
    one device->host copy per version it served, and K3 runs once per
    apply."""
    import numpy as np

    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.optim import rules
    from mpit_tpu_torch.ps import ParamClient, ParamServer, ReaderClient, ServeConfig
    from mpit_tpu_torch.ps.sharding import shard_layout
    from mpit_tpu_torch.comm.tcp import TcpTransport

    name = "serve_readers_adam"
    n = flatten_module(make_model(GANG_BASE["model"], GANG_BASE["side"]), 1).size
    w0, gtab = serve_grads(n, SERVE_ROUNDS, seed=21)
    expected, quiet_ms = serve_record(torch, 2, w0, gtab)
    shards = shard_layout(n, 2)
    sranks, wrank = [0, 1], 2
    readers = list(range(3, 3 + SERVE_READERS))
    addrs, tr = serve_mesh(3, 3 + SERVE_READERS)
    servers = [ParamServer(r, [wrank], tr[r], rule=rules.make("adam", lr=1e-3),
                           device=GANG_BASE["device"], reader_ranks=readers,
                           serve=ServeConfig(budget_bytes=int(SERVE_BUDGET_MB * (1 << 20))))
               for r in sranks]
    copies = {s.rank: [] for s in servers}
    for s in servers:
        timed_copies(s, copies[s.rank])
    import threading

    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    grad = np.zeros(n, np.float32)
    client = ParamClient(wrank, sranks, tr[wrank], seed_servers=True,
                         ft=FTConfig(op_deadline_s=30.0))
    client.start(w0.copy(), grad)
    rtr, clients, mirrors = {}, {}, {}
    for r in readers:
        rtr[r] = TcpTransport(r, len(addrs), addrs, reconnect=60.0, dial_peers=sranks,
                              listen=False)
        # The default backoff: BUSYs escalate to its 2 s cap (with a 50 ms
        # cap the 64 readers drew 8,846 BUSYs and took longer).
        clients[r] = ReaderClient(r, sranks, rtr[r], ft=FTConfig(op_deadline_s=30.0))
        mirrors[r] = np.zeros(n, np.float32)
        clients[r].start(mirrors[r])
    zero_counts(kernels)
    lat, served, bad = [], {0: set(), 1: set()}, []

    def on_read(r, rc, dt):
        lat.append(dt)
        for s, shard in zip(sranks, shards):
            v = rc.read_versions[s]
            served[s].add(v)
            want = expected[s].get(v)
            got = mirrors[r][shard.offset:shard.offset + shard.size]
            if want is None or got.tobytes() != want.tobytes():
                bad.append((r, s, v))

    errors = []
    writer = serve_writer(client, grad, gtab, 0.03, errors)
    window = paced_reads(clients, SERVE_READS, 0.02, on_read)
    writer.join(120)
    if errors or writer.is_alive():
        raise AssertionError(f"{name}: the writer failed or hung: {errors}")
    monotone = all(rc.monotone for rc in clients.values())
    busy_honored = sum(rc.busy_honored for rc in clients.values())
    retries = sum(rc.retries for rc in clients.values())
    for rc in clients.values():
        rc.stop()
    client.stop()
    for t in threads:
        t.join(60)
        if t.is_alive():
            raise AssertionError(f"{name}: a server did not stop")
    for t in list(rtr.values()) + list(tr.values()):
        t.close()
    launches = read_counts(kernels)
    applied = sum(s.grads_applied for s in servers)
    if bad:
        raise AssertionError(f"{name}: {len(bad)} reads differ from the shard at their "
                             f"stamped version, e.g. (reader, server, version) {bad[:3]}")
    if not monotone:
        raise AssertionError(f"{name}: a reader saw a version go back")
    if len(lat) != SERVE_READERS * SERVE_READS:
        raise AssertionError(f"{name}: {len(lat)} reads")
    busy = [s.busy_replies for s in servers]
    if not (sum(busy) >= 1 and busy_honored >= 1):
        raise AssertionError(f"{name}: BUSY issued {busy}, honoured {busy_honored}")
    for s in servers:
        if s.snapshot_copies != len(served[s.rank]) or len(copies[s.rank]) != len(served[s.rank]):
            raise AssertionError(f"{name}: server {s.rank} made {s.snapshot_copies} copies "
                                 f"for {len(served[s.rank])} versions served")
        if s.grads_applied != SERVE_ROUNDS:
            raise AssertionError(f"{name}: server {s.rank} applied {s.grads_applied}")
    expect_launches(name, launches, {"k3": applied})
    copy_ms = [dt * 1e3 for log in copies.values() for _v, dt in log]
    reading = {**read_stats(lat, 4 * n, window), "readers": SERVE_READERS,
               "busy_issued": busy, "busy_honored": busy_honored, "retries": retries,
               "versions_served": {s: sorted(v) for s, v in served.items()},
               "snapshot_copies": [s.snapshot_copies for s in servers],
               "snapshot_hits": [s.snapshot_hits for s in servers],
               "d2h_copy_ms": {"median": float(np.median(copy_ms)), "max": max(copy_ms),
                               "n": len(copy_ms)},
               "d2h_copy_ms_alone": {"median": float(np.median(quiet_ms)),
                                     "max": max(quiet_ms), "n": len(quiet_ms)},
               "applied": applied, "launches": launches}
    print(f"{name}: " + json.dumps(reading))
    print(f"{name} on {smi}: {SERVE_READERS} readers x {SERVE_READS} whole-vector reads "
          f"of {n:,} floats: p50 {reading['p50_ms']:.3f} ms, p99 {reading['p99_ms']:.3f} ms, "
          f"{reading['mbs']:.1f} MB/s; BUSY {sum(busy)} issued, {busy_honored} honoured; "
          f"one device->host copy per version served, median "
          f"{reading['d2h_copy_ms']['median']:.3f} ms among the readers, "
          f"{reading['d2h_copy_ms_alone']['median']:.3f} ms alone")
    record_path(all_paths, name, launches, SERVE_ROUNDS)
    return reading


def cells_fabric_adam(torch, kernels, all_paths, smi):
    """One Adam server on the card holding the flagship CNN's 544,522
    floats, 1 writer (8 lockstep rounds), 2 cells on the default int8
    subscription and 32 fabric-routed readers, over the port's TCP event
    loop in this process; a third of the way into the reads the first cell
    retires with GOODBYE toward the second.  Every read is bit for bit the
    int8 round trip of the shard at its stamped version, every stamped lag
    is within max_lag, no reader exhausts its retries and some reroute, and
    the server encodes once per version it ships, not once per cell and
    version."""
    import threading

    import numpy as np

    from mpit_tpu_torch.cells.cell import ServingCell
    from mpit_tpu_torch.comm import codec as codec_mod
    from mpit_tpu_torch.comm.tcp import TcpTransport
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.optim import rules
    from mpit_tpu_torch.ps import ParamClient, ParamServer, ReaderClient

    name = "cells_fabric_adam"
    n = flatten_module(make_model(GANG_BASE["model"], GANG_BASE["side"]), 1).size
    w0, gtab = serve_grads(n, SERVE_ROUNDS, seed=22)
    int8 = codec_mod.get("int8")

    def roundtrip(x):
        wire = np.empty(int8.wire_nbytes(n), np.uint8)
        int8.encode_into(x, wire)
        out = np.empty(n, np.float32)
        int8.decode_into(wire, out)
        return out

    expected = {v: roundtrip(x) for v, x in serve_record(torch, 1, w0, gtab)[0][0].items()}
    cell_ranks = [2, 3]
    readers = list(range(4, 4 + CELL_READERS))
    addrs, tr = serve_mesh(4, 4 + CELL_READERS)
    server = ParamServer(0, [1], tr[0], rule=rules.make("adam", lr=1e-3),
                         device=GANG_BASE["device"], cell_ranks=cell_ranks,
                         ft=FTConfig(lease_ttl_s=30.0))
    pushed = []  # (cell, head, kind, bytes) per DIFF frame
    inner = server._cell_frame

    def frame(crank):
        msgs = inner(crank)
        kind = int(msgs[0][:8].view(np.int64)[0])
        pushed.append((crank, server._snap_version, kind, sum(m.nbytes for m in msgs)))
        return msgs

    server._cell_frame = frame
    sth = threading.Thread(target=server.start, daemon=True)
    sth.start()
    cells, cth = {}, []
    for c in cell_ranks:
        cells[c] = ServingCell(c, 0, tr[c], readers, size=n, codec="int8",
                               max_lag=CELL_MAX_LAG,
                               ft=FTConfig(heartbeat_s=0.05, op_deadline_s=30.0))
        cth.append(threading.Thread(target=cells[c].start, daemon=True))
        cth[-1].start()
    grad = np.zeros(n, np.float32)
    client = ParamClient(1, [0], tr[1], seed_servers=True, ft=FTConfig(op_deadline_s=30.0))
    client.start(w0.copy(), grad)
    rtr, clients, mirrors = {}, {}, {}
    for r in readers:
        rtr[r] = TcpTransport(r, len(addrs), addrs, reconnect=60.0, dial_peers=cell_ranks,
                              listen=False)
        clients[r] = ReaderClient(r, [0], rtr[r], codec="int8", cells={0: cell_ranks},
                                  ft=FTConfig(op_deadline_s=30.0, heartbeat_s=0.25))
        mirrors[r] = np.zeros(n, np.float32)
        clients[r].start(mirrors[r])
    zero_counts(kernels)
    lat, lags, bad = [], [], []
    retire_after = CELL_READERS * CELL_READS // 3

    def on_read(r, rc, dt):
        lat.append(dt)
        v = rc.read_versions[0]
        lags.append(rc.lags[0])
        want = expected.get(v)
        if want is None or mirrors[r].tobytes() != want.tobytes():
            bad.append((r, v))
        if len(lat) == retire_after:
            cells[cell_ranks[0]].retire_serving(cell_ranks[1])

    errors = []
    writer = serve_writer(client, grad, gtab, 0.04, errors)
    window = paced_reads(clients, CELL_READS, 0.03, on_read)
    writer.join(120)
    if errors or writer.is_alive():
        raise AssertionError(f"{name}: the writer failed or hung: {errors}")
    reroutes = sum(int(rc._m_reroutes.value) for rc in clients.values())
    monotone = all(rc.monotone for rc in clients.values())
    busy_honored = sum(rc.busy_honored for rc in clients.values())
    for rc in clients.values():
        rc.stop()
    client.stop()
    for t in cth + [sth]:
        t.join(60)
        if t.is_alive():
            raise AssertionError(f"{name}: a cell or the server did not stop")
    for t in list(rtr.values()) + list(tr.values()):
        t.close()
    launches = read_counts(kernels)
    final = server._snap_version
    if bad:
        raise AssertionError(f"{name}: {len(bad)} reads differ from the int8 round trip of "
                             f"the shard at their version, e.g. {bad[:3]}")
    if not monotone or max(lags) > CELL_MAX_LAG or reroutes < 1:
        raise AssertionError(f"{name}: monotone {monotone}, largest lag {max(lags)}, "
                             f"reroutes {reroutes}")
    heads = {h for _c, h, _k, _b in pushed}
    if server.snapshot_copies != len(heads) or len(pushed) <= len(heads):
        raise AssertionError(f"{name}: {server.snapshot_copies} encodes for {len(heads)} "
                             f"versions shipped in {len(pushed)} DIFF frames")
    survivor = cells[cell_ranks[1]]
    if survivor.version != final or bytes(survivor._frame) != bytes(
            server._snap_wire["int8"][1]):
        raise AssertionError(f"{name}: the surviving cell holds version {survivor.version} "
                             f"of {final}, or not the server's frame")
    expect_launches(name, launches, {"k3": server.grads_applied})
    kinds = {"full": sum(1 for p in pushed if p[2] == 0),
             "delta": sum(1 for p in pushed if p[2] == 1)}
    reading = {**read_stats(lat, 4 * n, window), "readers": CELL_READERS,
               "max_lag": max(lags), "max_lag_bound": CELL_MAX_LAG, "reroutes": reroutes,
               "busy_honored": busy_honored, "diffs": kinds,
               "diff_bytes": sum(p[3] for p in pushed),
               "full_frame_bytes": int8.wire_nbytes(n) + 40,
               "snapshot_copies": server.snapshot_copies, "versions_shipped": len(heads),
               "final_version": final,
               "cells": {c: {"params_served": cl.params_served, "busy": cl.busy_replies,
                             "diffs_installed": cl.diffs_installed,
                             "resyncs": cl.resyncs, "lag_sheds": cl.lag_sheds}
                         for c, cl in cells.items()},
               "applied": server.grads_applied, "launches": launches}
    print(f"{name}: " + json.dumps(reading))
    print(f"{name} on {smi}: {CELL_READERS} fabric readers x {CELL_READS} int8 reads of "
          f"{n:,} floats through 2 cells, one retired mid-run: p50 "
          f"{reading['p50_ms']:.3f} ms, p99 {reading['p99_ms']:.3f} ms; {kinds['delta']} "
          f"DELTA + {kinds['full']} FULL frames, {reading['diff_bytes']:,} DIFF bytes; "
          f"{server.snapshot_copies} encodes for {len(heads)} versions; {reroutes} reroutes")
    record_path(all_paths, name, launches, SERVE_ROUNDS)
    return reading


def serve_cells_procs(all_paths, smi):
    """``launch --np 8 --opt adam --serve_readers 4 --cells 2
    --ft_op_deadline_s 2 --ft_heartbeat_s 0.25 --ft_lease_ttl_s 3
    --transport tcp --supervise 1`` at the flagship widths: the server and
    the worker on the card, the cells and readers host roles.  Once the
    first cell has served 20 reads (its ``/metrics``), it is SIGKILLed
    (expendable: never restarted); its upstream's lease evicts it, the
    readers fail over to the sibling and finish.  Held: every reader's
    reads monotone and within the lag bound, at least one failover, the
    eviction, and the server process's K3 equal to its applies."""
    import signal
    import threading

    from mpit_tpu_torch.comm.tcp import allocate_local_addresses
    from mpit_tpu_torch.obs.statusd import free_base_port
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    name = "serve_cells_procs"
    size = 2 + PROCS_CELLS + PROCS_READERS
    victim = 2
    addrs, socks = allocate_local_addresses(size)
    for sock in socks:
        sock.close()
    base = free_base_port(size)
    saved = os.environ.get("MPIT_OBS_HTTP")
    os.environ["MPIT_OBS_HTTP"] = str(base)
    try:
        cfg = LAUNCH_DEFAULTS.parse_args([
            "--np", str(size), "--opt", "adam", "--transport", "tcp",
            "--serve_readers", str(PROCS_READERS), "--cells", str(PROCS_CELLS),
            "--serve_rounds", "40", "--serve_interval_s", "0.1", "--ft_op_deadline_s", "2",
            "--ft_heartbeat_s", "0.25", "--ft_lease_ttl_s", "3", "--supervise", "1"]).merged(
            GANG_BASE, lr=1e-3, epochs=1, tcp_addrs=",".join(addrs))
        t0 = time.perf_counter()
        results = launch_processes(cfg, timeout=600, chaos=dict(
            chaos_kill_rank=victim, chaos_kill_after_s=0.0, chaos_signal=signal.SIGKILL,
            expendable=[victim],
            # Late enough that the victim's beats armed its lease at the
            # server (a cell that never beat is never evicted: its death
            # is the supervisor's to notice).
            chaos_when=lambda: (http_metric(base + victim, "mpit_ps_params_served_total",
                                            victim) or 0) >= 20))
        wall = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("MPIT_OBS_HTTP", None)
        else:
            os.environ["MPIT_OBS_HTTP"] = saved
    srv, worker = results[0], results[1]
    survivor = results[3]
    rdr = [results[r] for r in range(4, size)]
    if not results[victim].get("killed") or srv["role"] != "server" \
            or worker["role"] != "worker" or survivor["role"] != "cell":
        raise AssertionError(f"{name}: roles {[v.get('role') for v in results.values()]}")
    if srv["evictions"] < 1:
        raise AssertionError(f"{name}: the killed cell was never evicted by its lease")
    restarted = {r: v["restarts"] for r, v in results.items() if v.get("restarts")}
    if restarted:
        raise AssertionError(f"{name}: ranks restarted {restarted}")
    if srv["launches"]["k3"] != srv["grads_applied"] or not srv["grads_applied"]:
        raise AssertionError(f"{name}: K3 {srv['launches']['k3']} for "
                             f"{srv['grads_applied']} applies")
    if (srv["platform"], worker["platform"]) != ("cuda", "cuda") \
            or {v["platform"] for v in rdr + [survivor]} != {"cpu"}:
        raise AssertionError(f"{name}: platforms "
                             f"{[v.get('platform') for v in results.values()]}")
    failovers = sum(v["failovers"] for v in rdr)
    lags = [lag for v in rdr for lag in v["lags"].values()]
    if failovers < 1 or any(not v["monotone"] or v["reads"] != 40 for v in rdr) \
            or max(lags) > int(cfg.cell_max_lag):
        raise AssertionError(f"{name}: readers {rdr}")
    reading = {"wall_s": wall, "failovers": failovers, "evictions": srv["evictions"],
               "reads": sum(v["reads"] for v in rdr), "busy_honored":
               sum(v["busy_honored"] for v in rdr), "max_lag": max(lags),
               "survivor": {k: survivor[k] for k in ("params_served", "diffs_installed",
                                                     "resyncs", "busy_replies")},
               "server": {"applies": srv["grads_applied"], "k3": srv["launches"]["k3"],
                          "diffs_sent": srv["diffs_sent"],
                          "snapshot_copies": srv["snapshot_copies"],
                          "snap_version": srv["snap_version"]},
               "launches": {k: sum(v.get("launches", {}).get(k, 0) for v in results.values())
                            for k in ("k1", "k2", "k3")}}
    print(f"{name}: " + json.dumps(reading))
    print(f"{name} on {smi}: cell {victim} SIGKILLed mid-read, evicted by its upstream's "
          f"lease; {failovers} failovers, {reading['reads']} reads, largest lag "
          f"{reading['max_lag']}; {wall:.1f} s")
    record_path(all_paths, name, reading["launches"], worker["steps"])
    return wall


def serve_phases(torch, kernels, all_paths, smi):
    """The read path (slices 5d and 5e) on the card: the process gang with a
    cell killed runs in the background while this process drives the reader
    tier and the cell fabric over Adam shards that K3 applies.  (ptest's
    read legs, ``MPIT_BENCH_READERS`` and ``MPIT_BENCH_CELLS``, took 182-197
    s on the card, past this block's time: they run as a command of their
    own, ``README.md``.)"""
    from concurrent.futures import ThreadPoolExecutor

    from mpit_tpu_torch import obs

    limits = nofile()
    print(f"serve: open-file limit {limits[0]} (soft, lifted to {limits[1]}; hard "
          f"{limits[2]})")
    obs.configure(enabled=False)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        procs = pool.submit(serve_cells_procs, all_paths, smi)
        t1 = time.perf_counter()
        serve_readers_adam(torch, kernels, all_paths, smi)
        cells_fabric_adam(torch, kernels, all_paths, smi)
        inproc_s = time.perf_counter() - t1
        procs_s = procs.result()
    obs.configure(enabled=None)
    print(f"read-path phases: {time.perf_counter() - t0:.1f}s (in-process {inproc_s:.1f}s; "
          f"beside it the process gang {procs_s:.1f}s)")


# -- the device data plane and chunked streaming (slices 6 and 5f) ------------

#: the streamed gangs' chunk cut: a 272,261-float shard (1.09 MB) ships in 5
#: chunks of 65,536 floats
STREAM_CHUNK_BYTES = 262144
#: the §12 matrix's reply faults: every 7th ack or reply chunk dropped, every
#: 3rd duplicated (a period prime to a read's 5 reply chunks, which a drop every
#: 5th would hit on every resend)
STREAM_SERVER_PLAN = dict(seed=9, drop_every=7, dup_every=3, tags=FT_REPLY_TAGS)
#: the streamed gangs' client FT: a chunk op over the in-process router takes
#: milliseconds, so a lost chunk is resent after 50 ms
STREAM_FT = dict(FT_FAST, op_deadline_s=0.05)
#: the streamed lockstep harness's rounds (each client pushes this many GRADs)
STREAM_ROUNDS = 4
#: every (rule, codec) the streamed lockstep harness holds chunked == unchunked
STREAM_RULES = ("add", "rmsprop")
STREAM_CODECS = ("none", "bf16", "int8")


def dplane_adam_lockstep(torch, kernels, data, all_paths, smi):
    """The device exchange on the card: the wire path, every pair on the
    device path, and one device server beside one wire server under the
    drop/dup matrix end bit for bit equal, K3 equal to the applies in each;
    the device run counts device ranks [0, 1] and no wire data op.  The
    device run again with the interpreter's switch interval at 0.5 ms (5
    ms by default) asks whether thread switches set the round trip."""
    import numpy as np

    runs = {mode: ft_lockstep_adam(torch, kernels, data, mode == "mixed",
                                   name=f"dplane_adam_{mode}", mode=mode, time_grads=True)[:2]
            for mode in ("wire", "device", "mixed")}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        runs["device_switch_0.5ms"] = ft_lockstep_adam(
            torch, kernels, data, False, name="dplane_adam_device_switch_0.5ms",
            mode="device", time_grads=True)[:2]
    finally:
        sys.setswitchinterval(interval)
    wire = runs["wire"][0]
    for mode, (final, stats) in runs.items():
        if final.tobytes() != wire.tobytes():
            raise AssertionError(f"dplane_adam_{mode}: params differ from the wire "
                                 f"path's (max gap {np.abs(final - wire).max()})")
    dev = runs["device"][1]
    if dev["device_ranks"] != [[0, 1], [0, 1]] or any(dev["wire_ops"]):
        raise AssertionError(f"dplane_adam_device: device ranks {dev['device_ranks']}, "
                             f"wire ops {dev['wire_ops']}")
    mixed = runs["mixed"][1]
    if not (mixed["retries"] > 0 and mixed["device_ops"][0] > 0
            and mixed["device_ops"][1] == 0):
        raise AssertionError(f"dplane_adam_mixed: the mix did not run as planned: {mixed}")
    reading = {}
    for mode, (_f, stats) in runs.items():
        grad_s, queued = stats["grad_s"], stats["queued_s"]
        reading[mode] = {"grad_rt_ms_p50": float(np.median(grad_s)) * 1e3,
                         "grad_rt_ms_min": float(np.min(grad_s)) * 1e3,
                         "queued_ms_p50": float(np.median(queued)) * 1e3 if queued else None,
                         "retries": stats["retries"], "dup_ops": stats["dup_ops"],
                         "device_ops": stats.get("device_ops"), "launches": stats["launches"]}
        record_path(all_paths, f"dplane_adam_{mode}", stats["launches"], 2 * FT_ROUNDS)
    d = reading["device"]
    d["pacing_share"] = (d["queued_ms_p50"] / d["grad_rt_ms_p50"]
                         if d["queued_ms_p50"] is not None else None)
    print("dplane_adam_lockstep: " + json.dumps(reading))
    print(f"dplane_adam_lockstep on {smi}: a GRAD of 272,261 floats to 2 Adam servers, "
          f"round trip p50 {reading['wire']['grad_rt_ms_p50']:.3f} ms by the wire, "
          f"{d['grad_rt_ms_p50']:.3f} ms by the device path, of it "
          f"{d['queued_ms_p50']:.3f} ms in the plane's queue (the service's 0.5 ms "
          f"idle pacing: {100 * d['pacing_share']:.0f}%); with a 0.5 ms switch "
          f"interval {reading['device_switch_0.5ms']['grad_rt_ms_p50']:.3f} ms")


#: the sync_device A/B: each mode's gang takes this many rounds, and each mode
#: runs twice, in the order mirror, vector, parts, parts, vector, mirror
SYNC_ROUNDS = 25
SYNC_ORDER = ("mirror", "vector", "parts", "parts", "vector", "mirror")


def dplane_sync_device(torch, kernels, all_paths, smi):
    """``ExchangeClient.sync_device`` with the flagship gradient as a card
    tensor, as one vector and as the per-shard list (``pull_dev`` results on
    the card), bit for bit equal to the mirror path's round (grad through
    the host mirrors, params read back); each round timed, 50 a mode over
    two gangs in mirrored order."""
    import numpy as np

    from mpit_tpu_torch.optim import rules

    n = 544_522
    gen = torch.Generator(device=GANG_BASE["device"]).manual_seed(3)
    w0 = torch.randn(n, generator=gen, device=GANG_BASE["device"]).cpu().numpy()
    updates = [1e-3 * torch.randn(n, generator=gen, device=GANG_BASE["device"])
               for _ in range(SYNC_ROUNDS)]

    finals, times = [], {how: [] for how in SYNC_ORDER}
    launches = {key: 0 for key in kernels}
    for j, how in enumerate(SYNC_ORDER):
        name = f"dplane_sync_{how}_{j}"
        servers, clients, threads = ft_gang(rules.make("adam", lr=1e-3), None,
                                            nclients=1, mode="device")
        c = clients[0]
        ft_start([c], [lambda: c.start(w0.copy(), np.zeros(n, np.float32))])
        zero_counts(kernels)
        for r, u in enumerate(updates):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if how == "mirror":
                c.grad[:] = u.cpu().numpy()
                c.async_send_grad()
                c.async_recv_param()
                c.wait()
                got = torch.from_numpy(c.param).to(GANG_BASE["device"])
            elif how == "vector":
                got = c.sync_device(u)
            else:
                half = c.pc.shards[0].size
                got = torch.cat(c.sync_device([u[:half], u[half:]], concat=False))
            torch.cuda.synchronize()
            if r:  # the gang's first round pays its first-call costs
                times[how].append(time.perf_counter() - t0)
        finals.append((how, got.cpu().numpy()))
        stats = ft_close(name, servers, clients, threads, kernels)
        expect_launches(name, stats["launches"], {"k3": stats["grads_applied"]})
        for key, k in stats["launches"].items():
            launches[key] += k
    for how, final in finals:
        if final.tobytes() != finals[0][1].tobytes():
            raise AssertionError(f"dplane_sync_device: a {how} gang differs from the "
                                 "mirror path's")
    reading = {how: {"rounds": len(t),
                     **{f"round_ms_p{q}": float(np.percentile(t, q)) * 1e3
                        for q in (10, 50, 90)}}
               for how, t in times.items()}
    record_path(all_paths, "dplane_sync_device", launches,
                len(SYNC_ORDER) * len(updates))
    print("dplane_sync_device: " + json.dumps(reading))
    print(f"dplane_sync_device on {smi}: a round of 544,522 floats (2 Adam shards) "
          f"p50 {reading['mirror']['round_ms_p50']:.3f} ms through the mirrors, "
          f"{reading['vector']['round_ms_p50']:.3f} ms by sync_device (one vector), "
          f"{reading['parts']['round_ms_p50']:.3f} ms (per-shard list)")


def stream_lockstep(torch, kernels, rule, codec, chunk_bytes, faulty, dplane=False):
    """The lockstep harness on random flagship-sized gradients (numpy seed
    5): 2 clients seed and push ``STREAM_ROUNDS`` turns each to 2 servers on the
    card (``rule``, ``codec``), chunked at ``chunk_bytes`` (0: whole
    frames), under the §12 chunk drop/dup matrix with ``faulty``; the
    servers as device slots with ``dplane``.  Returns the final params and
    the counts."""
    import numpy as np

    n = 544_522
    rng = np.random.default_rng(5)
    w0 = rng.normal(size=n).astype(np.float32)
    gtab = (1e-2 * rng.normal(size=(2, STREAM_ROUNDS, n))).astype(np.float32)
    servers, clients, threads = ft_gang(
        rule, codec, server_plan=faulty and STREAM_SERVER_PLAN,
        client_plan=faulty and FT_CLIENT_PLAN, mode="slots" if dplane else "wire",
        chunk_bytes=chunk_bytes, ft=STREAM_FT)
    params = [w0.copy(), np.zeros_like(w0)]
    grads = [np.zeros_like(w0) for _ in clients]
    ft_start(clients, [lambda c=c, i=i: c.start(params[i], grads[i])
                       for i, c in enumerate(clients)])
    zero_counts(kernels)
    for rnd in range(STREAM_ROUNDS):
        for i, c in enumerate(clients):
            grads[i][:] = gtab[i, rnd]
            c.async_send_grad()
            c.wait()
    clients[0].async_recv_param()
    clients[0].wait()
    final = params[0].copy()
    stats = ft_close("stream", servers, clients, threads, kernels)
    stats["chunked_pairs"] = sum(1 for s in servers for c in s._chunk.values() if c)
    stats["hbm"] = [s._hbm is not None for s in servers]
    return final, stats


def stream_lockstep_matrix(torch, kernels, all_paths, smi):
    """Chunked streaming on the card: rules add and rmsprop, codecs none,
    bf16 and int8, at a 256 KiB chunk cut (a 272,261-float shard in 5
    chunks), fault-free and under the §12 chunk drop/dup matrix, with the
    worker pool serial (0) and at 2 threads: every run bit for bit its
    unchunked control; the faulty runs resend and dup.  The add run again
    on device slots (chunks through ``apply_wire_chunk``).  The path's
    launches are the sum of its runs' own counts.  Adam with chunks is
    refused loudly at negotiation."""
    import numpy as np

    from mpit_tpu_torch.comm import pool as comm_pool
    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.ft import FLAG_CHUNKED, FLAG_FRAMED, init_v5
    from mpit_tpu_torch.ps import ParamServer

    t0 = time.perf_counter()
    launches = {key: 0 for key in kernels}
    runs = 0
    reading = {}

    def run(*args, **kw):
        nonlocal runs
        final, st = stream_lockstep(torch, kernels, *args, **kw)
        runs += 1
        for key, n in st["launches"].items():
            launches[key] += n
        return final, st

    saved = comm_pool.current_pool()
    try:
        for rule in STREAM_RULES:
            for codec in STREAM_CODECS:
                control, _ = run(rule, codec, 0, False)
                for threads in (0, 2):
                    comm_pool.configure(threads)
                    for faulty in (False, True):
                        final, st = run(rule, codec, STREAM_CHUNK_BYTES, faulty)
                        key = f"{rule}/{codec}/pool{threads}/{'faulty' if faulty else 'clean'}"
                        if final.tobytes() != control.tobytes():
                            raise AssertionError(
                                f"stream_lockstep {key}: chunked differs from unchunked "
                                f"(max gap {np.abs(final - control).max()})")
                        if st["chunked_pairs"] != 4:
                            raise AssertionError(f"stream_lockstep {key}: not chunked")
                        if faulty and not (st["retries"] > 0 and st["dup_ops"] > 0):
                            raise AssertionError(f"stream_lockstep {key}: the plans "
                                                 f"never bit: {st}")
                        expect_launches(f"stream_{key}", st["launches"], {})
                        reading[key] = {"retries": st["retries"], "dups": st["dup_ops"]}
        control, _ = run("add", "none", 0, False)
        final, st = run("add", "none", STREAM_CHUNK_BYTES, False, dplane=True)
        if not all(st["hbm"]) or final.tobytes() != control.tobytes():
            raise AssertionError("stream_lockstep add/dplane: chunks through the device "
                                 "slots differ from the unchunked run")
    finally:
        if saved is None:
            comm_pool.configure(None)
    record_path(all_paths, "stream_lockstep", launches, runs * 2 * STREAM_ROUNDS)
    server = ParamServer(0, [1], LocalRouter(2).endpoint(0), rule="adam",
                         device=GANG_BASE["device"])
    try:
        server._negotiate(1, init_v5(0, 4096, 0, 0, FLAG_FRAMED | FLAG_CHUNKED,
                                     65536).tobytes())
    except ValueError as exc:
        print(f"stream_lockstep: Adam with chunks refused: {exc}")
    else:
        raise AssertionError("stream_lockstep: Adam with chunks was not refused loudly")
    print("stream_lockstep: " + json.dumps(reading))
    print(f"stream_lockstep on {smi}: {runs} runs (2 rules x 3 codecs, chunked at "
          f"{STREAM_CHUNK_BYTES} bytes, fault-free and faulty, pool 0 and 2; the add "
          f"run on device slots; Adam refused) bit for bit in "
          f"{time.perf_counter() - t0:.1f}s")


def stream_procs(all_paths, smi, tcp_addrs):
    """The chunked process gangs: ``launch --np 4 --opt eamsgd
    --ft_op_deadline_s 5 --ft_chunk_bytes 262144`` over shm beside its
    unchunked control (K1 = the workers' steps, counted in the children;
    the chunked gang's test error within 2 points of the control's), and
    the comm-only EAMSGD (``--lr 0``) chunked over TCP (K2 = the workers'
    steps).  Returns the seconds taken."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    eamsgd = dict(opt="eamsgd", lr=1e-2, mom=0.99, mva=0.15, su=10, epochs=2,
                  ft_op_deadline_s=5.0)
    with ThreadPoolExecutor(3) as pool:
        chunked = pool.submit(run_procs_path, "stream_eamsgd_procs", 4,
                              ft_chunk_bytes=STREAM_CHUNK_BYTES, **eamsgd)
        control = pool.submit(run_procs_path, "stream_eamsgd_control_procs", 4, **eamsgd)
        lr0 = pool.submit(run_procs_path, "stream_eamsgd_lr0_tcp_procs", 4,
                          opt="eamsgd", lr=0.0, mva=0.45, su=1, epochs=1,
                          ft_op_deadline_s=5.0, ft_chunk_bytes=STREAM_CHUNK_BYTES,
                          transport="tcp", tcp_addrs=",".join(tcp_addrs))
        for name, fut, key in (("stream_eamsgd_procs", chunked, "k1"),
                               ("stream_eamsgd_lr0_tcp_procs", lr0, "k2")):
            results, launches, reading = fut.result()
            steps = sum(reading["worker_steps"])
            expect_launches(name, launches, {key: steps})
            record_path(all_paths, name, launches, steps)
        _c_results, _c_launches, c_reading = control.result()
    err = max(chunked.result()[2]["test_err"])
    err0 = max(c_reading["test_err"])
    print(f"stream_procs on {smi}: test error {err} chunked, {err0} unchunked")
    if err > err0 + 0.02:
        raise AssertionError(f"stream_procs: the chunked gang's test error {err} is past "
                             f"the unchunked gang's {err0} + 0.02")
    return time.perf_counter() - t0


def dplane_gangs(torch, kernels, data, all_paths):
    """``run_gang`` with ``--dplane 1``: DOWNPOUR np=4 (every pair on the
    device path, no kernel) and Adam np=4 (K3 = the applies = 2 x the
    workers' steps)."""
    for name, kw, k3 in (("dplane_downpour_np4", dict(opt="downpour", lr=1e-2, su=1,
                                                      epochs=1), False),
                         ("dplane_adam_np4", dict(opt="adam", lr=1e-3, su=1, epochs=1),
                          True)):
        res, launches, _ = run_gang_path(torch, name, 4, kernels, data, dplane=1, **kw)
        workers = [r for r in res.values() if r["role"] == "worker"]
        if any(r["device_ranks"] != [0, 2] for r in workers):
            raise AssertionError(f"{name}: device ranks "
                                 f"{[r['device_ranks'] for r in workers]}")
        steps = sum(r["steps"] for r in workers)
        applied = sum(r["grads_applied"] for r in res.values() if r["role"] == "server")
        if k3 and applied != 2 * steps:
            raise AssertionError(f"{name}: {applied} applies for {steps} worker steps")
        expect_launches(name, launches, {"k3": applied} if k3 else {})
        record_path(all_paths, name, launches, steps)


def dplane_adam_procs(all_paths):
    """``launch --np 4 --opt adam --dplane 1``: every pair crosses a process,
    so every pair falls back to the wire; the servers' slots apply by K3 =
    2 x the workers' steps (counted in the children)."""
    name = "dplane_adam_procs"
    results, launches, reading = run_procs_path(name, 4, opt="adam", lr=1e-3, su=1,
                                                epochs=1, dplane=1)
    workers = [r for r in results.values() if r["role"] == "worker"]
    if any(r.get("device_ranks") != [] for r in workers):
        raise AssertionError(f"{name}: a pair across processes took the device path")
    steps = sum(reading["worker_steps"])
    expect_launches(name, launches, {"k3": 2 * steps})
    record_path(all_paths, name, launches, steps)


def ptest_stream(smi):
    """The ptest twin's streaming A/B at 64 MB and codec none over the
    modelled 800 MB/s link (8 MB chunks): GRAD and PARAM p50 by whole
    frames and chunked.  The pool sweep and the wider widths run as a
    command of their own (``README.md``)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "tools/torch_ptest.py"], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, MPIT_BENCH_STREAM="only",
                                   MPIT_BENCH_CODECS="none", MPIT_BENCH_MB="64",
                                   MPIT_BENCH_ROUNDS="5"))
    if proc.returncode != 0:
        raise AssertionError(f"ptest stream: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    for row in rows:
        print("ptest_stream: " + json.dumps(row))
    if [r["stream"] for r in rows] != [0, 1] or any(r["retries"] for r in rows):
        raise AssertionError(f"ptest stream: unexpected rows {rows}")
    print(f"ptest_stream on {smi}: GRAD p50 {rows[0]['grad_p50_ms']:.1f} -> "
          f"{rows[1]['grad_p50_ms']:.1f} ms, PARAM p50 {rows[0]['param_p50_ms']:.1f} -> "
          f"{rows[1]['param_p50_ms']:.1f} ms in {time.perf_counter() - t0:.1f}s")


def dplane_stream_phases(torch, kernels, all_paths, smi):
    """Slices 6 and 5f on the card: the process gangs (the dplane Adam gang
    and the chunked EAMSGD gangs) and ptest's stream leg run in the
    background while this process drives the device exchange and the
    streamed lockstep matrix."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mpit_tpu_torch import obs
    from mpit_tpu_torch.comm.tcp import allocate_local_addresses
    from mpit_tpu_torch.data.mnist import load_mnist

    obs.configure(enabled=False)
    t0 = time.perf_counter()
    raw, _ = load_mnist(side=GANG_BASE["side"])
    data = (torch.as_tensor(raw[0], device=GANG_BASE["device"]),
            torch.as_tensor(np.asarray(raw[1]), dtype=torch.int64,
                            device=GANG_BASE["device"]))
    addrs, socks = allocate_local_addresses(4)
    for s in socks:
        s.close()
    with ThreadPoolExecutor(2) as pool:
        procs = pool.submit(stream_procs, all_paths, smi, addrs)
        dprocs = pool.submit(dplane_adam_procs, all_paths)
        t1 = time.perf_counter()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            dplane_adam_lockstep(torch, kernels, data, all_paths, smi)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        dplane_sync_device(torch, kernels, all_paths, smi)
        dplane_gangs(torch, kernels, raw, all_paths)
        stream_lockstep_matrix(torch, kernels, all_paths, smi)
        inproc_s = time.perf_counter() - t1
        dprocs.result()
        procs_s = procs.result()
    ptest_stream(smi)
    obs.configure(enabled=None)
    print(f"dplane and stream phases: {time.perf_counter() - t0:.1f}s (in-process "
          f"{inproc_s:.1f}s; beside it the process gangs {procs_s:.1f}s)")


# -- observability (slice 5b) -----------------------------------------------------

#: the timed process gang's epochs: long enough that the parent scrapes every
#: rank's endpoint and takes a ``top`` table while the workers train
OBS_PROCS_EPOCHS = 20


def obs_lockstep_adam(torch, kernels, all_paths, smi, tmp):
    """``ft_lockstep_adam`` (2 workers, 2 Adam servers at 272,261 a shard,
    8 lockstep rounds) with obs off and with obs on, the profile plane on
    and the clients on the ``FLAG_TIMING`` wire, in turns (off, on, on,
    off: the first gang of a process pays first-call costs): all four bit
    for bit, K3 32 = 2 x 16 in each run, each on-run's applied server GRAD
    spans 32, and its trace joins (rate 1.0, no violations).  Prints the
    round of each run."""
    import numpy as np

    from mpit_tpu_torch import obs
    from mpit_tpu_torch.data.mnist import load_mnist
    from mpit_tpu_torch.obs import causal, profile, spans, trace

    raw, _ = load_mnist(side=GANG_BASE["side"])
    data = (torch.as_tensor(raw[0], device=GANG_BASE["device"]),
            torch.as_tensor(np.asarray(raw[1]), dtype=torch.int64, device=GANG_BASE["device"]))
    want = 2 * 2 * FT_ROUNDS
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i, on in enumerate((False, True, True, False)):
            obs.configure(enabled=on, reset=True)
            if on:
                profile.configure(enabled=True, reset=True)
            final, stats, round_s = ft_lockstep_adam(
                torch, kernels, data, False, timing=on,
                name=f"obs_adam_{'on' if on else 'off'}")
            run = {"obs": on, "round_ms": round_s * 1e3, "stats": stats, "final": final}
            if on:
                run["grad_spans"] = sum(1 for sp in spans.get_recorder().spans
                                        if sp.name == "GRAD" and sp.outcome == "applied"
                                        and sp.args.get("side") == "server")
                report = causal.analyze(trace.write_rank_trace(
                    os.path.join(tmp, f"obs_adam{i}.json"), 0, role="gang"))
                run["join"] = report["ops"]
                run["violations"] = report["violations"]
            runs.append(run)
    finally:
        obs.configure(enabled=None, reset=True)
        torch.backends.cudnn.deterministic = deterministic
    print("obs_lockstep_adam: " + json.dumps(
        [{k: v for k, v in r.items() if k != "final"} for r in runs]))
    off_ms = [r["round_ms"] for r in runs if not r["obs"]]
    on_ms = [r["round_ms"] for r in runs if r["obs"]]
    print(f"obs_lockstep_adam on {smi}: a lockstep round (2 workers, 2 Adam servers at "
          f"272,261), in turns off/on/on/off: {' / '.join('%.2f' % r['round_ms'] for r in runs)}"
          f" ms; obs off {sum(off_ms) / 2:.2f} ms, obs, the profile plane and FLAG_TIMING "
          f"on {sum(on_ms) / 2:.2f} ms (means of each pair)")
    for r in runs:
        if r["final"].tobytes() != runs[0]["final"].tobytes():
            raise AssertionError("obs_lockstep_adam: obs on and off end at different bits "
                                 f"(max gap {np.abs(r['final'] - runs[0]['final']).max()})")
        if r["stats"]["launches"]["k3"] != want or r["stats"]["grads_applied"] != want:
            raise AssertionError(f"obs_lockstep_adam: {r['stats']}, want K3 = applies = {want}")
        if r["obs"] and (r["grad_spans"] != want or r["join"]["join_rate"] != 1.0
                         or r["violations"]):
            raise AssertionError(f"obs_lockstep_adam: {r['grad_spans']} applied server GRAD "
                                 f"spans (want {want}), join {r['join']}, violations "
                                 f"{r['violations'][:3]}")
    record_path(all_paths, "obs_adam_off", runs[0]["stats"]["launches"], 2 * FT_ROUNDS)
    record_path(all_paths, "obs_adam_on", runs[1]["stats"]["launches"], 2 * FT_ROUNDS)


def http_get(port, route, timeout=2.0):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=timeout) as resp:
        return resp.read()


def obs_cli(args, timeout=300):
    """``python -m mpit_tpu_torch.obs <args>``; returns (rc, stdout)."""
    proc = subprocess.run([sys.executable, "-m", "mpit_tpu_torch.obs", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    if proc.stderr.strip():
        sys.stdout.write(proc.stderr)
    return proc.returncode, proc.stdout


def obs_timed_procs(torch, all_paths, smi, tmp):
    """``launch --np 4 --opt adam`` over shm at the flagship widths, every
    rank on the card, on the framed ``FLAG_TIMING`` wire with traces, the
    profile plane and the live endpoints on (``MPIT_OBS_TRACE``,
    ``MPIT_OBS_PROFILE=1``, ``MPIT_OBS_HTTP`` on a free base port).  While
    it trains, this process scrapes every rank's ``/metrics`` and
    ``/status`` and takes one ``top`` table; an endpoint that never answers
    is an error.  Then the merged trace must validate, ``obs analyze`` join
    every op (rate 1.0, no violations, the wire's offsets for all four
    client-server pairs), each server's applied GRAD spans equal its K3
    launches and its applies, and ``obs profile`` read the counter tracks."""
    import threading

    from mpit_tpu_torch.obs import causal, trace
    from mpit_tpu_torch.obs.statusd import free_base_port
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    name = "obs_timed_procs"
    size = 4
    base = free_base_port(size)
    trace_path = os.path.join(tmp, "obs_timed.json")
    env = {"MPIT_OBS_TRACE": trace_path, "MPIT_OBS_PROFILE": "1",
           "MPIT_OBS_HTTP": str(base)}
    saved = {k: os.environ.get(k) for k in env}
    cfg = LAUNCH_DEFAULTS.merged(GANG_BASE, np=size, opt="adam", lr=1e-3, su=1,
                                 epochs=OBS_PROCS_EPOCHS, ft_op_deadline_s=30.0,
                                 ft_timing=True)
    box = {}

    def run():
        try:
            box["results"] = launch_processes(cfg, timeout=600)
        except BaseException as exc:  # noqa: BLE001 — raised below
            box["error"] = exc

    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        gang = threading.Thread(target=run, daemon=True)
        gang.start()
        # Each child serves its endpoint once torch is imported and its
        # CUDA context made (8-10 s on this host): poll until every rank
        # answered, while the gang lives.
        scraped = {}
        deadline = time.monotonic() + 300
        while len(scraped) < size and gang.is_alive() and time.monotonic() < deadline:
            for rank in range(size):
                if rank in scraped:
                    continue
                try:
                    metrics = http_get(base + rank, "/metrics").decode()
                    status = json.loads(http_get(base + rank, "/status"))
                except OSError:
                    continue
                if "mpit_" not in metrics:
                    continue  # up, but its role has not registered yet
                scraped[rank] = {"role": status.get("role"), "pid": status.get("pid"),
                                 "metrics_lines": len(metrics.splitlines()),
                                 "up_s": time.perf_counter() - t0}
            time.sleep(0.1)
        top_rc, top_out = (None, "")
        if len(scraped) == size and gang.is_alive():
            top_rc, top_out = obs_cli(["top", "--np", str(size), "--base-port", str(base),
                                       "--iters", "1", "--json", "--min-up", str(size),
                                       "--retry-s", "60"], timeout=120)
        gang.join(600)
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if "error" in box or gang.is_alive():
        raise AssertionError(f"{name}: the gang failed: {box.get('error')}")
    print(f"{name}: endpoints scraped: " + json.dumps(scraped))
    if len(scraped) != size:
        raise AssertionError(f"{name}: endpoints of ranks "
                             f"{sorted(set(range(size)) - set(scraped))} never answered")
    if top_rc != 0:
        raise AssertionError(f"{name}: top failed ({top_rc}) while the gang ran: {top_out}")
    top_rows = json.loads(top_out.strip().splitlines()[-1])["ranks"]
    print(f"{name}: top: " + json.dumps(top_rows))
    results = box["results"]
    off = {r: res["platform"] for r, res in results.items()
           if res["platform"] != GANG_BASE["device"]}
    if off:
        raise AssertionError(f"{name}: ranks off the card: {off}")
    stats = trace.validate_trace(trace_path)
    print(f"{name}: trace {os.path.getsize(trace_path)} bytes: " + json.dumps(stats))
    rc, out = obs_cli(["analyze", trace_path, "--json", "--min-join", "1.0"])
    if rc != 0:
        raise AssertionError(f"{name}: obs analyze failed ({rc})")
    report = json.loads(out)
    sources = {(e["client"], e["server"]): e["source"] for e in report["offsets"]}
    want_pairs = {(c, s) for c in (1, 3) for s in (0, 2)}
    if report["ops"]["join_rate"] != 1.0 or report["violations"] \
            or {p: sources.get(p) for p in want_pairs} != {p: "wire" for p in want_pairs}:
        raise AssertionError(f"{name}: join {report['ops']}, violations "
                             f"{report['violations'][:3]}, offsets {sources}")
    events, _ = causal.load_trace(trace_path)
    spans = causal.extract_spans(events)
    per_server = {}
    for r, res in sorted(results.items()):
        if res["role"] != "server":
            continue
        grads = sum(1 for sp in spans if sp.name == "GRAD" and sp.side == "server"
                    and sp.pid == r and sp.outcome == "applied")
        per_server[r] = {"grad_spans": grads, "k3": res["launches"]["k3"],
                         "grads_applied": res["grads_applied"]}
        if not grads == res["launches"]["k3"] == res["grads_applied"] > 0:
            raise AssertionError(f"{name}: server {r}: {per_server[r]}")
    rc, out = obs_cli(["profile", trace_path, "--json", "--require-counters"])
    if rc != 0:
        raise AssertionError(f"{name}: obs profile failed ({rc})")
    prof = json.loads(out)
    workers = [res for res in results.values() if res["role"] == "worker"]
    steps = [w["steps"] for w in workers]
    phases = {op: {ph: [round(p["p50_us"], 1), round(p["p99_us"], 1)]
                   for ph, p in st["phases"].items() if p["count"]}
              for op, st in report["phase_stats"].items()}
    reading = {
        "wall_s": wall, "samples_per_sec": sum(steps) * cfg.batch / wall,
        "samples_per_sec_train": train_rate(workers, cfg.batch),
        "worker_steps": steps, "servers": per_server, "ops": report["ops"],
        "phase_p50_p99_us": phases,
        "cpu_util": {r: round(row["cpu_util"], 3) for r, row in prof["ranks"].items()},
        "counter_events": prof["counter_events"],
    }
    print(f"{name}: " + json.dumps(reading))
    print(f"{name} on {smi}: {reading['samples_per_sec']:.1f} samples/s over the wall, "
          f"{reading['samples_per_sec_train']:.1f} on the workers' clocks; "
          f"{report['ops']['joined']} ops joined")
    launches = {k: sum(res["launches"][k] for res in results.values())
                for k in ("k1", "k2", "k3")}
    if launches["k3"] != 2 * sum(steps):
        raise AssertionError(f"{name}: K3 {launches['k3']}, want 2 x {sum(steps)} steps")
    record_path(all_paths, name, launches, sum(steps))


def obs_phases(torch, kernels, all_paths, smi):
    """Observability on the card (slice 5b): the in-process lockstep Adam
    gang with obs off and on, then the timed, traced process gang."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        obs_lockstep_adam(torch, kernels, all_paths, smi, tmp)
        t1 = time.perf_counter()
        obs_timed_procs(torch, all_paths, smi, tmp)
    print(f"obs phases: {time.perf_counter() - t0:.1f}s (in-process {t1 - t0:.1f}s, "
          f"process gang {time.perf_counter() - t1:.1f}s)")


FA_CASES = (
    ("lm_default", (8, 8), 1024, 1024, 32, 0, 0, True),
    ("lm_longcontext", (1, 8), 8192, 8192, 128, 0, 0, True),
    ("lm_vs_cpu", (2, 4), 256, 256, 32, 0, 0, True),
    ("ragged_pair", (2, 3), 203, 131, 64, 20, 40, True),
    ("ragged_full", (2, 3), 203, 131, 64, 100, 40, False),
)
FA_TIMED = ("lm_default", "lm_longcontext")
# The attention of lm_longcontext_32k (leading axes, L, D; bf16, causal),
# where the gate refuses K5's dQ partials (32 GiB) and K6 runs.
FA_32K = ((1, 8), 32768, 128)
# K4 in bf16 where Lk fits one key tile of the tensor-core kernel (128):
# (leading axes, Lq, Lk, D, q_offset, kv_offset, causal), with and without
# offsets (dead rows under the first offset pair), causal and not.
FA_ONE_TILE = (
    ((2, 3), 200, 128, 64, 0, 0, True),
    ((2, 3), 200, 64, 64, 0, 0, False),
    ((2, 3), 200, 61, 128, 20, 60, True),
    ((2, 3), 200, 61, 32, 100, 40, False),
)


def fa_work(lead, lq, lk, d, q_off, kv_off, causal, itemsize):
    """Valid (q, key) pairs, and the bytes the forward and the backward
    must move (each input read once, each output written once)."""
    import numpy as np

    n = math.prod(lead)
    per_row = (np.clip(q_off + np.arange(lq) - kv_off + 1, 0, lk) if causal
               else np.full(lq, lk))
    pairs = n * int(per_row.sum())
    fwd_bytes = n * ((2 * lq + 2 * lk) * d * itemsize + 4 * lq)  # q k v in, o lse out
    bwd_bytes = n * ((3 * lq + 4 * lk) * d * itemsize + 8 * lq)  # q k v do lse delta, dq dk dv
    return pairs, fwd_bytes, bwd_bytes


def fa_bound_ms(n_bytes, flops, bf16):
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / (BF16_FLOPS if bf16 else F32_FLOPS) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def fa_err(torch, got, want, atol, rtol=0.0, rows=False):
    """The largest elementwise gap, and the largest share of its limit that
    any element (or, with ``rows``, any row) uses: inside the limit while
    the share is at most 1.  ``-inf`` must sit where the twin has it.
    ``rows``: the bf16 rule, row by row and element by element (see
    FA_BF16_ROW)."""
    got, want = got.float(), want.float()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        return math.inf, math.inf
    fin = torch.isfinite(want)
    gap = torch.where(fin, got - want, 0.0)
    want = torch.where(fin, want, 0.0)
    if not bool(torch.isfinite(gap).all()):
        return math.inf, math.inf
    if gap.numel() == 0:
        return 0.0, 0.0
    if rows:
        d = want.shape[-1]
        row_norm = want.norm(dim=-1)
        used_row = gap.norm(dim=-1) / (FA_BF16_ROW * row_norm + atol * math.sqrt(d))
        rms = (row_norm / math.sqrt(d))[..., None]
        used_elem = gap.abs() / (2.0**-7 * want.abs() + FA_BF16_ELEM * rms + atol)
        used = max(float(used_row.max()), float(used_elem.max()))
    else:
        limit = atol + rtol * want.abs()
        used = float(torch.where(gap == 0, 0.0, gap.abs() / limit).max())
    return float(gap.abs().max()), used


def fa_exact(torch, t):
    """``t`` rounded to a multiple of 1/16 in [-2, 2], in bf16: scores and
    dP over such inputs are exact in float32 in any summation order (see
    FA_BF16_STEP)."""
    return (torch.round(t.float() * 16) / 16).clamp(-2, 2).to(torch.bfloat16)


def bwd_exact_steps(torch, base, kw, atol):
    """bf16 K5 and K6 on ``base`` (q, k, v, do) made exact by ``fa_exact``,
    each held to the twin element by element within one bf16 step, and run
    twice for equal bits.  Returns each kernel's and grad's (max abs gap,
    share of the limit), keyed ``k5_dq_step`` and so on."""
    from mpit_tpu_torch.ops.flash_attention import (
        _lse_of, attention_bwd_reference, block_attention_partial,
        finalize_partials, flash_bwd_fused, flash_bwd_two_kernel)

    q, k, v, do = (fa_exact(torch, t) for t in base)
    acc, m, l = block_attention_partial(q, k, v, **kw)
    lse = _lse_of(m, l)
    delta = (do.float() * finalize_partials(acc, l, q.dtype).float()).sum(-1)
    want = attention_bwd_reference(q, k, v, do, lse, delta, **kw)
    out = {}
    for key, fn in (("k5", flash_bwd_fused), ("k6", flash_bwd_two_kernel)):
        got = fn(q, k, v, do, lse, delta, **kw)
        again = fn(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{key} gave other bits on a second run (exact inputs)")
        for grad, a, w in zip(("dq", "dk", "dv"), got, want):
            out[f"{key}_{grad}_step"] = fa_err(torch, a, w, atol, FA_BF16_STEP)
    return out


def sdpa_backend(torch, q, k, v):
    """The backend ``scaled_dot_product_attention`` picks for these inputs."""
    try:
        choice = torch._fused_sdp_choice(q, k, v, None, 0.0, True)
        return torch.nn.attention.SDPBackend(choice).name
    except (AttributeError, TypeError, ValueError, RuntimeError):
        return "unknown"


def check_flash(torch):
    """K4, K5 and K6 against their twins at every FA_CASES shape, in f32 and
    bf16 (the twins on the same inputs on the card; K4 in both output
    modes; K5 and K6 also against each other, and each against a second
    run of itself); then each timed at the two LM shapes in bf16 beside its
    twin and SDPA; then K4 in bf16 at the FA_ONE_TILE shapes; then K6 at
    the 32k LM's shape (``check_k6_32k``).  Returns each kernel's largest
    gap to its twin and the times at the three shapes."""
    import torch.nn.functional as F

    from mpit_tpu_torch.ops.flash_attention import (
        _lse_of, attention_bwd_reference, block_attention_partial,
        finalize_partials, flash_bwd_fused, flash_bwd_two_kernel, flash_fwd)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    errs = {"k4": 0.0, "k5": 0.0, "k6": 0.0}
    timed = {}
    for name, lead, lq, lk, d, q_off, kv_off, causal in FA_CASES:
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
        base = [0.5 * torch.randn(*lead, n, d, device=dev, generator=gen)
                for n in (lq, lk, lk)]
        base.append(torch.randn(*lead, lq, d, device=dev, generator=gen))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dtype) for t in base)
            rows = dtype == torch.bfloat16  # the bf16 rule (FA_BF16_ROW)
            acc_t, m_t, l_t = block_attention_partial(q, k, v, **kw)
            o_t, lse_t = finalize_partials(acc_t, l_t, dtype), _lse_of(m_t, l_t)
            o, lse = flash_fwd(q, k, v, **kw)
            acc, m, l = flash_fwd(q, k, v, partial=True, **kw)
            den = torch.where(l_t == 0, 1.0, l_t)[..., None]
            checks = {
                "k4_o": fa_err(torch, o, o_t, FA_FWD_ATOL, rows=rows),
                "k4_lse": fa_err(torch, lse, lse_t, FA_FWD_ATOL),
                "k4_m": fa_err(torch, m, m_t, FA_FWD_ATOL),
                "k4_acc/l": fa_err(torch, acc / den, acc_t / den, FA_FWD_ATOL, rows=rows),
                "k4_l": fa_err(torch, l, l_t, 0.0, FA_PARTIAL_RTOL),
            }
            delta = (do.float() * o_t.float()).sum(-1)
            want = attention_bwd_reference(q, k, v, do, lse_t, delta, **kw)
            got5 = flash_bwd_fused(q, k, v, do, lse_t, delta, **kw)
            again5 = flash_bwd_fused(q, k, v, do, lse_t, delta, **kw)
            got6 = flash_bwd_two_kernel(q, k, v, do, lse_t, delta, **kw)
            again6 = flash_bwd_two_kernel(q, k, v, do, lse_t, delta, **kw)
            torch.cuda.synchronize()
            for key, got, again in (("K5", got5, again5), ("K6", got6, again6)):
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{key} gave other bits on a second run at "
                                         f"{name} {dtype}")
            bwd_atol = FA_PAIR_ATOL if (q_off or kv_off) else FA_BWD_ATOL
            for grad, w, a5, a6 in zip(("dq", "dk", "dv"), want, got5, got6):
                checks[f"k5_{grad}"] = fa_err(torch, a5, w, bwd_atol, rows=rows)
                checks[f"k6_{grad}"] = fa_err(torch, a6, w, bwd_atol, rows=rows)
                checks[f"k5_vs_k6_{grad}"] = fa_err(torch, a5, a6, bwd_atol, rows=rows)
            if rows:
                checks.update(bwd_exact_steps(torch, base, kw, bwd_atol))
            print(f"flash check {name} {str(dtype)[6:]} (max abs gap, share of the "
                  "limit used): " + json.dumps(checks))
            for what, (gap, used) in checks.items():
                key = what[:2]
                if not what.startswith("k5_vs"):
                    errs[key] = max(errs[key], gap)
                if not used <= 1.0:
                    raise AssertionError(f"{what} past its limit at {name} {dtype}: "
                                         f"gap {gap}, {used} of the limit")
            if dtype == torch.bfloat16 and name in FA_TIMED:
                timed[name] = time_flash(torch, F, q, k, v, do, lse_t, delta, kw,
                                         lead, lq, lk, d)
            del want, got5, again5, got6, again6, acc_t, o_t, den
    for lead, lq, lk, d, q_off, kv_off, causal in FA_ONE_TILE:
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
        q, k, v = (fa_exact(torch, 0.5 * torch.randn(*lead, n, d, device=dev,
                                                     generator=gen))
                   for n in (lq, lk, lk))
        acc_t, m_t, l_t = block_attention_partial(q, k, v, **kw)
        o_t = finalize_partials(acc_t, l_t, q.dtype)
        o, _ = flash_fwd(q, k, v, **kw)
        acc, m, l = flash_fwd(q, k, v, partial=True, **kw)
        den = torch.where(l_t == 0, 1.0, l_t)[..., None]
        checks = {
            "k4_o_step": fa_err(torch, o, o_t, FA_FWD_ATOL, FA_BF16_STEP),
            "k4_acc/l_step": fa_err(torch, acc / den, acc_t / den, FA_FWD_ATOL,
                                    FA_BF16_STEP),
            "k4_m": fa_err(torch, m, m_t, FA_FWD_ATOL),
            "k4_l": fa_err(torch, l, l_t, 0.0, FA_PARTIAL_RTOL),
        }
        print(f"flash check one key tile {lead} Lq {lq} Lk {lk} D {d} offsets "
              f"({q_off}, {kv_off}) causal {causal}: " + json.dumps(checks))
        for what, (gap, used) in checks.items():
            errs["k4"] = max(errs["k4"], gap)
            if not used <= 1.0:
                raise AssertionError(f"{what} past its limit on one key tile (Lk {lk}, "
                                     f"D {d}): gap {gap}, {used} of the limit")
    timed["lm_longcontext_32k"], gap = check_k6_32k(torch, F, gen)
    errs["k6"] = max(errs["k6"], gap)
    print("flash times: " + json.dumps(timed))
    return errs, timed


def fa_entries(errs, timed, paths):
    """K4's, K5's and K6's entries for the closing line.  A kernel's main
    path is the first LM path that launched it, in the order
    lm_longcontext, lm_longcontext_32k, lm_default,
    lm_default_other_schedule (the gate picks the schedule); its launches
    are that run's and its times those at that path's attention shape."""
    entries = []
    tc = "mpit_tpu_torch/ops/csrc/flash_attention_tc.cu"
    for key, fn, src_line in (
            ("k4", "flash_fwd", "mpit_tpu/ops/flash_attention.py:233"),
            ("k5", "flash_bwd_fused", "mpit_tpu/ops/flash_attention.py:623"),
            ("k6", "flash_bwd_two_kernel", "mpit_tpu/ops/flash_attention.py:536")):
        main_path = next(p for p in ("lm_longcontext", "lm_longcontext_32k", "lm_default",
                                     "lm_default_other_schedule")
                         if paths[key][p]["launches"])
        shape = main_path if main_path.startswith("lm_longcontext") else "lm_default"
        t = timed[shape][key]
        entries.append({
            "name": fn, "route": "cuda", "source": tc, "replaces": src_line,
            "launches": paths[key][main_path]["launches"],
            "paths": paths[key], "max_abs_err": errs[key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "main_path": main_path, "timed_at": shape,
            "sdpa_backend": timed[shape]["sdpa_backend"],
        })
    return entries


def check_k6_32k(torch, F, gen):
    """bf16 K6 at FA_32K, the attention of ``lm_longcontext_32k``: K6
    against its twin run one head at a time (each head's float32 (L, L)
    matrices take 4 GiB apiece) under the bf16 row rule on every head; K6
    twice on every head for equal bits; K6 against K5 on one head (N 1,
    beside K5's 4 GiB of dQ partials; K6's dK/dV kernel is K5's sweep, so
    there only dQ is computed apart); then K6 timed beside SDPA's backward
    and the twin.  lse and o come from K4, held to its twin above.  Returns
    the times and K6's largest gap to its twin."""
    from mpit_tpu_torch.ops.flash_attention import (
        attention_bwd_reference, flash_bwd_fused, flash_bwd_two_kernel, flash_fwd)

    dev = torch.device("cuda")
    lead, seq, d = FA_32K
    kw = dict(causal=True, q_offset=0, kv_offset=0)
    q, k, v = (0.5 * torch.randn(*lead, seq, d, device=dev, generator=gen)
               for _ in range(3))
    do = torch.randn(*lead, seq, d, device=dev, generator=gen)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    o, lse = flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    del o

    def plain_bwd():
        outs = [attention_bwd_reference(*(t[:, h:h + 1] for t in (q, k, v, do, lse, delta)),
                                        **kw)
                for h in range(lead[-1])]
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))

    got = flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)
    again = flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K6 gave other bits on a second run at FA_32K")
    del again
    want = plain_bwd()
    torch.cuda.empty_cache()
    head = [t[:, :1].clone() for t in (q, k, v, do, lse, delta)]
    got5 = flash_bwd_fused(*head, **kw)
    torch.cuda.synchronize()
    checks = {}
    for grad, a, w, b in zip(("dq", "dk", "dv"), got, want, got5):
        checks[f"k6_{grad}"] = fa_err(torch, a, w, FA_BWD_ATOL, rows=True)
        checks[f"k6_vs_k5_{grad}"] = fa_err(torch, a[:, :1], b, FA_BWD_ATOL, rows=True)
    print(f"flash check 32k {lead} L {seq} D {d} bfloat16, K6 vs twin on every head, "
          "vs K5 on head 0 (max abs gap, share of the limit): " + json.dumps(checks))
    for what, (gap, used) in checks.items():
        if not used <= 1.0:
            raise AssertionError(f"{what} past its limit at FA_32K: gap {gap}, "
                                 f"{used} of the limit")
    del got, want, got5, head
    torch.cuda.empty_cache()
    times = time_flash(torch, F, q, k, v, do, lse, delta, kw, lead, seq, seq, d,
                       keys=("k6",), plain_bwd=plain_bwd, plain_kernels=20 * lead[-1])
    torch.cuda.empty_cache()
    gap = max(g for what, (g, _) in checks.items() if not what.startswith("k6_vs"))
    return times, gap


def time_flash(torch, F, q, k, v, do, lse, delta, kw, lead, lq, lk, d,
               keys=("k4", "k5", "k6"), plain_bwd=None, plain_kernels=20):
    """``keys`` of K4, K5 and K6 at one shape (bf16, as the LM paths give
    them), each beside its twin (for the backward ``plain_bwd`` where
    given; ``plain_kernels`` PyTorch kernels a call) and the SDPA call
    computing the same function.  One buffer set:
    each kernel reads every K/V tile once per q tile, far more than one
    pass over device memory, so L2 residency of the first read does not
    set its time."""
    from mpit_tpu_torch.ops.flash_attention import (
        _lse_of, attention_bwd_reference, block_attention_partial,
        finalize_partials, flash_bwd_fused, flash_bwd_two_kernel, flash_fwd)

    def reps(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return max(3, min(TIMED_LAUNCHES, int(0.25 / max(time.perf_counter() - t0, 1e-6))))

    def timing(fn, plain_kernels=1):
        n = reps(fn)
        return {"ms": time_ms(torch, fn, queued=True, kernels_per_call=plain_kernels, n=n),
                "call_ms": time_ms(torch, fn, n=n)}

    def plain_fwd():
        acc, m, l = block_attention_partial(q, k, v, **kw)
        return finalize_partials(acc, l, q.dtype), _lse_of(m, l)

    if plain_bwd is None:
        def plain_bwd():
            return attention_bwd_reference(q, k, v, do, lse, delta, **kw)

    q4, k4, v4 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    pairs, fwd_bytes, bwd_bytes = fa_work(lead, lq, lk, d, kw["q_offset"],
                                          kw["kv_offset"], kw["causal"], q.element_size())
    out = {"sdpa_backend": sdpa_backend(torch, q, k, v), "pairs": pairs}
    for key, kernel, plain, library, n_bytes, flops in (
            ("k4", lambda: flash_fwd(q, k, v, **kw), plain_fwd,
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
             fwd_bytes, 4 * d * pairs),
            ("k5", lambda: flash_bwd_fused(q, k, v, do, lse, delta, **kw), plain_bwd,
             lambda: torch.autograd.grad(o4, (q4, k4, v4), do, retain_graph=True),
             bwd_bytes, 10 * d * pairs),
            ("k6", lambda: flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw), plain_bwd,
             lambda: torch.autograd.grad(o4, (q4, k4, v4), do, retain_graph=True),
             bwd_bytes, 10 * d * pairs)):
        if key not in keys:
            continue
        bound, bound_by = fa_bound_ms(n_bytes, flops, q.dtype == torch.bfloat16)
        kt, pt, lt = timing(kernel), timing(plain, plain_kernels), timing(library)
        out[key] = {"ms": kt["ms"], "call_ms": kt["call_ms"], "plain_ms": pt["ms"],
                    "plain_call_ms": pt["call_ms"], "library_ms": lt["ms"],
                    "library_call_ms": lt["call_ms"], "bound_ms": bound,
                    "bound_by": bound_by, "bytes": n_bytes, "flops": flops,
                    "tflops": flops / kt["ms"] / 1e9, "x_bound": kt["ms"] / bound,
                    "x_library": kt["ms"] / lt["ms"]}
    return out


def lm_expected(cfg, runs):
    """Launches of ``runs`` LM steps: K1 once a step, K4 once a layer, and
    K5 once or K6 twice a layer, as the gate decides at the path's
    attention shape; at ``sp > 1`` each of those once a live pair of the
    ring (``ring_pairs``) at the pair's shape."""
    from mpit_tpu_torch.ops.flash_attention import _use_fused_bwd
    from mpit_tpu_torch.parallel.ring_attention import ring_pairs

    import torch

    head = cfg.d_model // cfg.n_heads
    sp = int(cfg.sp) or 1
    pairs, rows = 1, cfg.seq_len
    if sp > 1:
        pairs = ring_pairs(sp, cfg.layout)
        rows = cfg.seq_len // sp // (2 if cfg.layout == "zigzag" else 1)
    shape = (cfg.batch, cfg.n_heads, rows, head)
    fused = _use_fused_bwd(shape, shape, head, cfg.device, getattr(torch, cfg.attn_dtype))
    want = {"k1": runs, "k4": cfg.n_layers * runs * pairs}
    want["k5" if fused else "k6"] = (1 if fused else 2) * cfg.n_layers * runs * pairs
    return want, "fused (K5)" if fused else "two-kernel (K6)"


def lm_path(torch, name, kernels, **kw):
    """One ``lm_launch.run`` on the card, the counters set to 0 just before
    and read just after: the weights on the card, finite losses, and every
    kernel's launches exact, the warm-up step's included.  Returns the
    result and the path's record for ``paths``."""
    from mpit_tpu_torch.train.lm_launch import LM_LAUNCH_DEFAULTS, run

    cfg = LM_LAUNCH_DEFAULTS.merged(kw, device="cuda")
    for k in kernels.values():
        k.launches = 0
    res = run(cfg)
    launches = {key: k.launches for key, k in kernels.items()}
    losses = [h["avg_loss"] for h in res["history"]]
    if not res["device"].startswith("cuda"):
        raise AssertionError(f"{name}: w is on {res['device']}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: losses not finite: {losses}")
    want, schedule = lm_expected(cfg, cfg.steps + 1)
    reading = {
        "tokens_per_sec": res["tokens_per_sec"],
        "step_ms": res["elapsed"] / cfg.steps * 1e3, "compile_s": res["compile_s"],
        "params": res["params"], "steps": cfg.steps, "losses": losses,
        "schedule": schedule, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"{name}: " + json.dumps(reading))
    expect_launches(name, launches, want)
    if res["mesh"] != {"dp": int(cfg.dp) or 1, "sp": int(cfg.sp) or 1}:
        raise AssertionError(f"{name}: ran on the mesh {res['mesh']}")
    return res, {"launches": launches, "steps": cfg.steps, "warmup_steps": 1,
                 "schedule": schedule, "tokens_per_sec": reading["tokens_per_sec"],
                 "peak_mem_gb": reading["peak_mem_gb"]}


@contextlib.contextmanager
def fused_bwd_env(value):
    """``MPIT_FA_FUSED_BWD`` set to ``value`` (None: unset, the gate's own
    choice) inside the block, restored after it."""
    old = os.environ.pop("MPIT_FA_FUSED_BWD", None)
    if value is not None:
        os.environ["MPIT_FA_FUSED_BWD"] = value
    try:
        yield
    finally:
        os.environ.pop("MPIT_FA_FUSED_BWD", None)
        if old is not None:
            os.environ["MPIT_FA_FUSED_BWD"] = old


def lm_paths(torch, kernels, paths):
    """``lm_default``, ``lm_default`` under the other schedule,
    ``lm_longcontext`` and ``lm_longcontext_32k`` (where the gate, left to
    itself, must pick K6); fills ``paths[kernel][path]`` and returns
    ``lm_longcontext``'s result."""
    from mpit_tpu_torch.train.lm_launch import LONGCONTEXT_32K_KWARGS, LONGCONTEXT_KWARGS

    def record(name, rec):
        for key in kernels:
            paths[key][name] = {**rec, "launches": rec["launches"][key]}

    torch.cuda.reset_peak_memory_stats()
    res, rec = lm_path(torch, "lm_default", kernels, steps=20, log_every=10)
    losses = [h["avg_loss"] for h in res["history"]]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"lm_default: the loss did not fall: {losses}")
    record("lm_default", rec)
    with fused_bwd_env("0" if rec["schedule"].startswith("fused") else "1"):
        _, rec = lm_path(torch, "lm_default_other_schedule", kernels, steps=3,
                         log_every=3)
    record("lm_default_other_schedule", rec)
    torch.cuda.reset_peak_memory_stats()
    longcontext, rec = lm_path(torch, "lm_longcontext", kernels, steps=6, log_every=3,
                               **LONGCONTEXT_KWARGS)
    record("lm_longcontext", rec)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with fused_bwd_env(None):
        _, rec = lm_path(torch, "lm_longcontext_32k", kernels, steps=3, log_every=3,
                         **LONGCONTEXT_32K_KWARGS)
    if not rec["schedule"].startswith("two-kernel"):
        raise AssertionError(f"lm_longcontext_32k: the gate picked {rec['schedule']}, "
                             "not K6")
    record("lm_longcontext_32k", rec)
    for key in ("k5", "k6"):
        if not any(p["launches"] for name, p in paths[key].items()
                   if name.startswith("lm_")):
            raise AssertionError(f"{key} launched in no LM training step")
    return longcontext


def lm_vs_cpu(torch, kernels, attn_dtype, fused_bwd=None, sp=1, layout="zigzag"):
    """Three LM steps at d 128, 4 heads (head width 32), 2 layers, context
    256, batch 2, attention in ``attn_dtype``, on the card and on the CPU
    from one w0 (flatten_module draws it on the CPU from the seed), held
    to LM_LIMITS[attn_dtype].  ``fused_bwd``: ``MPIT_FA_FUSED_BWD`` for
    the run (None: the gate's choice, K5 at this shape; ``"0"``: K6).
    ``sp > 1``: ring attention over ``sp`` ranks in ``layout``, the flash
    ring on the card against the plain ring on the CPU."""
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.transformer import TinyDecoder
    from mpit_tpu_torch.train.lm_launch import LM_LAUNCH_DEFAULTS, run

    name = (f"lm_vs_cpu_{attn_dtype}" + ("" if fused_bwd is None else "_two_kernel")
            + ("" if sp == 1 else f"_sp{sp}_{layout}"))
    kw = dict(d_model=128, n_heads=4, n_layers=2, seq_len=256, batch=2,
              attn_dtype=attn_dtype, steps=3, log_every=1, sp=sp, layout=layout)
    finals, losses = {}, {}
    for device in ("cuda", "cpu"):
        for k in kernels.values():
            k.launches = 0
        with fused_bwd_env(fused_bwd):
            res = run(LM_LAUNCH_DEFAULTS.merged(kw, device=device))
            if device == "cuda":
                cfg = LM_LAUNCH_DEFAULTS.merged(kw)
                launches = {key: k.launches for key, k in kernels.items()}
                want, schedule = lm_expected(cfg, cfg.steps + 1)
                expect_launches(name, launches, want)
        finals[device] = {key: res["state"][key].cpu() for key in ("w", "vt")}
        losses[device] = [h["avg_loss"] for h in res["history"]]
    w0 = flatten_module(TinyDecoder(vocab=256, d_model=128, n_heads=4, n_layers=2,
                                    max_len=256), LM_LAUNCH_DEFAULTS.seed).w0
    lim = LM_LIMITS[attn_dtype]
    readings, held = lm_state_gaps(torch, finals["cuda"], finals["cpu"], w0, lim)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    readings["loss_rel_gap"] = loss_gap
    readings["losses"] = losses
    print(f"{name}: 3 steps, cuda vs cpu " + json.dumps(readings))
    if not held:
        raise AssertionError(f"{name}: w or vt on the card differs from the CPU beyond "
                             f"the limits: {readings}")
    if not loss_gap <= lim["loss_rtol"]:
        raise AssertionError(f"{name}: losses differ by {loss_gap} relative")
    return {"name": name, "launches": launches, "steps": 3, "warmup_steps": 1,
            "schedule": schedule,
            **{k: readings[k] for k in ("w", "vt", "loss_rel_gap")}}


# -- ring attention and lm_launch --sp on one card (slice 7c) ----------------------

#: the ring's virtual ranks on every ring path
RING_SP = 4
#: ring_kernels' attention: lm_longcontext's (B, H, L, D), bf16, causal
RING_ATTN = (1, 8, 8192, 128)
#: wholly masked pairs, every key after every query, as the contiguous ring hands
#: every rank below the owner at steps s > 0: (leading axes, Lq, Lk, D, q_offset,
#: kv_offset); the first is a pair of ring_kernels' contiguous ring
RING_DEAD = (((1, 8), 2048, 2048, 128, 0, 2048), ((2, 3), 203, 131, 64, 20, 223))


def ring_attend(torch, fn, q, k, v, do):
    """``fn(q, k, v)`` and the grads of ``sum(out * do)`` with respect to q,
    k and v, by autograd."""
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(qs, ks, vs)
    grads = torch.autograd.grad(out, (qs, ks, vs), do)
    return (out.detach(),) + tuple(grads)


@contextlib.contextmanager
def twin_pair_backward():
    """The ring's pair backward replaced by K5's and K6's twin
    (``attention_bwd_reference``) inside the block: the flash ring's
    backward then runs its plain version on the same (o, lse)."""
    import importlib

    from mpit_tpu_torch.ops.flash_attention import attention_bwd_reference

    ring_mod = importlib.import_module("mpit_tpu_torch.parallel.ring_attention")
    real = ring_mod.flash_attention_bwd_pair

    def twin(q, k, v, do, lse, *, delta, **kw):
        return attention_bwd_reference(q, k, v, do, lse, delta, **kw)

    ring_mod.flash_attention_bwd_pair = twin
    try:
        yield
    finally:
        ring_mod.flash_attention_bwd_pair = real


def ring_kernels(torch, kernels, errs):
    """At lm_longcontext's attention cut over RING_SP ranks, in both layouts,
    the flash ring on the card against its plain version on the card, under
    the bf16 row rule (fa_err): the output against the plain ring's
    (block_attention_partial's partials, merged), the grads against the
    same backward ring over the pairs' twin (``attention_bwd_reference``)
    on the flash ring's own (o, lse); and output and grads against
    flash_attention at sp 1.  The contiguous ring runs under the gate (K5)
    and forced to K6.  Each flash ring launches K4 once a pair and K5 once
    (K6 twice) a pair.  The plain ring's own grads, by autograd, are
    printed beside them and not held: they take ``delta`` from the float32
    output where the flash backward (K5, K6 and their twin, in the ring and
    at sp 1 alike) takes it from the bf16 one, which moves rows with a
    few keys by more than the row rule allows.  Folds the gaps to the plain
    versions into ``errs`` (K4: the output; K5, K6: the grads).  Returns
    the readings."""
    from mpit_tpu_torch.models.transformer import default_attn
    from mpit_tpu_torch.ops.flash_attention import _use_fused_bwd
    from mpit_tpu_torch.parallel import ring_attention, sp_mesh
    from mpit_tpu_torch.parallel.ring_attention import ring_pairs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, h, seq, d = RING_ATTN
    q, k, v = ((0.5 * torch.randn(b, seq, h, d, device=dev, generator=gen)).to(torch.bfloat16)
               for _ in range(3))
    do = torch.randn(b, seq, h, d, device=dev, generator=gen).to(torch.bfloat16)
    mesh = sp_mesh(RING_SP, dev)
    local = ring_attend(torch, default_attn(causal=True), q, k, v, do)
    readings, autograd = {}, {}
    for layout in ("zigzag", "contiguous"):
        plain = ring_attend(torch, ring_attention(mesh, impl="plain", layout=layout),
                            q, k, v, do)
        pairs = ring_pairs(RING_SP, layout)
        rows = seq // RING_SP // (2 if layout == "zigzag" else 1)
        shape = (b, h, rows, d)
        if not _use_fused_bwd(shape, shape, d, dev, torch.bfloat16):
            raise AssertionError(f"ring_kernels: the gate refuses K5 at the pair {shape}")
        flash_ring = ring_attention(mesh, impl="flash", layout=layout)
        with twin_pair_backward():
            twin = ring_attend(torch, flash_ring, q, k, v, do)
        for schedule, env, want in (("k5", None, {"k4": pairs, "k5": pairs}),
                                    ("k6", "0", {"k4": pairs, "k6": 2 * pairs})):
            if schedule == "k6" and layout == "zigzag":
                continue
            zero_counts(kernels)
            with fused_bwd_env(env):
                flash = ring_attend(torch, flash_ring, q, k, v, do)
            torch.cuda.synchronize()
            expect_launches(f"ring_kernels {layout} {schedule}", read_counts(kernels), want)
            for what, got, p, t, sp1 in zip(("o", "dq", "dk", "dv"), flash, plain, twin,
                                            local):
                atol = FA_FWD_ATOL if what == "o" else FA_BWD_ATOL
                gap = fa_err(torch, got, p if what == "o" else t, atol, rows=True)
                readings[f"{layout}_{schedule}_{what}_vs_plain"] = gap
                readings[f"{layout}_{schedule}_{what}_vs_sp1"] = fa_err(torch, got, sp1, atol,
                                                                        rows=True)
                if what != "o":
                    autograd[f"{layout}_{schedule}_{what}"] = fa_err(torch, got, p, atol,
                                                                     rows=True)
                key = "k4" if what == "o" else schedule
                errs[key] = max(errs[key], gap[0])
            del flash
        del plain, twin
        torch.cuda.empty_cache()
    print(f"ring_kernels at (B, H, L, D) = {RING_ATTN} bf16 causal, sp {RING_SP} (max abs "
          "gap, share of the limit): " + json.dumps(readings))
    print("ring_kernels, the grads against the plain ring's by autograd (not held): "
          + json.dumps(autograd))
    for what, (gap, used) in readings.items():
        if not used <= 1.0:
            raise AssertionError(f"ring_kernels: {what} past its limit: gap {gap}, "
                                 f"{used} of the limit")
    return readings


def poison_allocator(torch, blocks):
    """Hand the caching allocator blocks of ``(shape, dtype)`` filled with
    NaN: outputs allocated next with those sizes likely start from NaN, so a
    kernel that leaves an element unwritten shows."""
    held = [torch.full(shape, float("nan"), dtype=dtype, device="cuda")
            for shape, dtype in blocks]
    torch.cuda.synchronize()
    del held


def ring_dead_pairs(torch):
    """K4's partial mode, K5 and K6 on RING_DEAD's wholly masked pairs, in
    float32 and bfloat16, each output allocated over NaN: bit for bit the
    twin's acc 0, m -inf, l 0, and exact zero grads (lse and delta finite,
    as the ring's backward gives them)."""
    from mpit_tpu_torch.ops.flash_attention import (
        _dq_block_k, attention_bwd_reference, block_attention_partial, flash_bwd_fused,
        flash_bwd_two_kernel, flash_fwd)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    checked = []
    for lead, lq, lk, d, q_off, kv_off in RING_DEAD:
        if q_off + lq > kv_off:
            raise AssertionError(f"RING_DEAD pair {lead, lq, lk} is not wholly masked")
        kw = dict(causal=True, q_offset=q_off, kv_offset=kv_off)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = ((0.5 * torch.randn(*lead, n, d, device=dev, generator=gen)).to(dtype)
                           for n in (lq, lk, lk, lq))
            lse = torch.randn(*lead, lq, device=dev, generator=gen) + 3.0
            delta = torch.randn(*lead, lq, device=dev, generator=gen)
            twin_fwd = block_attention_partial(q, k, v, **kw)
            twin_bwd = attention_bwd_reference(q, k, v, do, lse, delta, **kw)
            f32, rows, size = torch.float32, (*lead, lq), (*lead, lq, d)
            grads = [(size, dtype), ((*lead, lk, d), dtype), ((*lead, lk, d), dtype)]
            poison_allocator(torch, [(size, f32), (rows, f32), (rows, f32)])
            fwd = flash_fwd(q, k, v, partial=True, **kw)
            tiles = math.ceil(lk / _dq_block_k(dev, dtype))
            poison_allocator(torch, [((tiles, *size), f32)] + grads)
            k5 = flash_bwd_fused(q, k, v, do, lse, delta, **kw)
            poison_allocator(torch, grads)
            k6 = flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            acc, m, l = fwd
            exact = (torch.equal(acc, twin_fwd[0]) and not bool(acc.any())
                     and torch.equal(m, twin_fwd[1]) and bool(torch.isneginf(m).all())
                     and torch.equal(l, twin_fwd[2]) and not bool(l.any()))
            for name, grads in (("K5", k5), ("K6", k6)):
                exact = exact and all(torch.equal(g, t) and not bool(g.any())
                                      for g, t in zip(grads, twin_bwd))
            if not exact:
                raise AssertionError(f"a wholly masked pair {lead} Lq {lq} Lk {lk} D {d} "
                                     f"offsets ({q_off}, {kv_off}) {dtype}: K4's partials "
                                     "or K5's / K6's grads are not the twin's exact zeros")
            checked.append(f"{lead} {lq}x{lk} D {d} ({q_off}, {kv_off}) {str(dtype)[6:]}")
    print("ring dead pairs, K4 partials and K5 / K6 grads the twin's exact zeros: "
          + json.dumps(checked))


def ring_collectives(torch, smi):
    """``ring_shift`` (both ways), ``ps_pull``, ``ps_push`` (with and without
    the worker sum), ``ps_pushpull`` and ``allreduce_mean`` on the card bit for
    bit against their definitions, over 4 virtual ranks; then
    ``measure_ps_pushpull(64, rounds=20)``'s MB/s."""
    from mpit_tpu_torch.parallel import (
        Mesh, allreduce_mean, ps_pull, ps_push, ps_pushpull, ring_shift)
    from mpit_tpu_torch.parallel.collective import measure_ps_pushpull

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    mesh = Mesh(dev, dp=4, shard=4)
    x, p = (torch.randn(4, 1 << 18, device=dev, generator=gen) for _ in range(2))
    g = torch.randn(4 << 18, device=dev, generator=gen)
    # integers: a sum of four is exact in any order, and so is its quarter
    w = torch.randint(-1000, 1000, (4, 1 << 18), device=dev, generator=gen).float()
    full, shards = ps_pushpull(mesh, lambda ps, gs: ps + gs)(p, g)
    checks = {
        "ring_shift": torch.equal(ring_shift(mesh, "shard")(x), torch.cat([x[-1:], x[:-1]])),
        "ring_shift_reverse": torch.equal(ring_shift(mesh, "shard", reverse=True)(x),
                                          torch.cat([x[1:], x[:1]])),
        "ps_pull": torch.equal(ps_pull(mesh)(x), torch.cat(list(x))),
        "ps_push": torch.equal(ps_push(mesh)(g), torch.stack(g.chunk(4))),
        "ps_push_reduce": torch.equal(ps_push(mesh, reduce_axis="dp")(w),
                                      torch.stack((w[0] + w[1] + w[2] + w[3]).chunk(4))),
        "ps_pushpull": torch.equal(shards, p + torch.stack(g.chunk(4)))
        and torch.equal(full, torch.cat(list(shards))),
        "allreduce_mean": torch.equal(allreduce_mean(mesh)(w),
                                      ((w[0] + w[1] + w[2] + w[3]) / 4).expand(4, -1)),
    }
    print("ring collectives on the card, bit for bit their definitions: " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"a collective differs from its definition: {checks}")
    res = measure_ps_pushpull(64, rounds=20)
    print(f"ps_pushpull on {smi}: {res['mbs']:.1f} MB/s (64 MB payload, one card, "
          f"shard 1: the round is one add) " + json.dumps(res))
    return res


def ring_lm_phases(torch, kernels, all_paths, smi, longcontext, errs):
    """Ring attention and ``lm_launch --sp`` on one card (slice 7c):
    ``ring_kernels``, the wholly masked pairs and the collectives, then
    ``lm_ring_longcontext`` (lm_longcontext's widths and steps at ``--sp 4
    --layout zigzag``: K4 once a live pair, 36 a layer a pass, K5 the same),
    ``lm_ring_contiguous_k6`` (``--layout contiguous``, 3 steps, forced to
    K6: K4 16 a layer a pass, K6 2 x 16), ``lm_ring_vs_local`` (the first
    window's loss against ``lm_longcontext``'s at the same seed, within
    ``LM_LIMITS["bfloat16"]["loss_rtol"]``; and the ring on the card against
    the port's CPU ring at lm_vs_cpu's widths in float32, both layouts, under
    ``LM_LIMITS["float32"]``), and ``measure_ps_pushpull``."""
    from mpit_tpu_torch.train.lm_launch import LONGCONTEXT_KWARGS

    t0 = time.perf_counter()
    ring_kernels(torch, kernels, errs)
    ring_dead_pairs(torch)
    ring_collectives(torch, smi)
    t_checks = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with fused_bwd_env(None):
        ring, rec = lm_path(torch, "lm_ring_longcontext", kernels, steps=6, log_every=3,
                            sp=RING_SP, layout="zigzag", **LONGCONTEXT_KWARGS)
    record_path(all_paths, "lm_ring_longcontext", rec["launches"], rec["steps"])
    torch.cuda.reset_peak_memory_stats()
    with fused_bwd_env("0"):
        _, rec = lm_path(torch, "lm_ring_contiguous_k6", kernels, steps=3, log_every=3,
                         sp=RING_SP, layout="contiguous", **LONGCONTEXT_KWARGS)
    record_path(all_paths, "lm_ring_contiguous_k6", rec["launches"], rec["steps"])
    first = {name: r["history"][0]["avg_loss"]
             for name, r in (("ring", ring), ("local", longcontext))}
    gap = abs(first["ring"] - first["local"]) / abs(first["local"])
    print(f"lm_ring_vs_local on {smi}: the first window's loss (steps 0-2), sp {RING_SP} "
          f"zigzag {first['ring']} vs sp 1 {first['local']}: relative gap {gap} (limit "
          f"{LM_LIMITS['bfloat16']['loss_rtol']}); tokens/s {ring['tokens_per_sec']} vs "
          f"{longcontext['tokens_per_sec']}")
    if not gap <= LM_LIMITS["bfloat16"]["loss_rtol"]:
        raise AssertionError(f"lm_ring_vs_local: the ring's loss differs by {gap} relative")
    for layout in ("zigzag", "contiguous"):
        rec = lm_vs_cpu(torch, kernels, "float32", sp=RING_SP, layout=layout)
        record_path(all_paths, rec["name"], rec["launches"], rec["steps"])
    print(f"ring_lm phases: {time.perf_counter() - t0:.1f}s (kernel and collective checks "
          f"{t_checks:.1f}s)")


# -- multi-card parallelism on the card's virtual ranks (slice 9) ------------------

#: lm_longcontext's widths: d 1,024, 8 heads of 128, MLP 4,096, context 8,192
PAR_D, PAR_HEADS, PAR_MLP, PAR_L = 1024, 8, 4096, 8192
#: the ranks of every tp, pp and ep path
PAR_RANKS = 4
#: ep_moe_longcontext's experts (2 a rank)
PAR_EXPERTS = 8
#: the pipelined decoder's microbatches, each one row of PAR_L tokens
PAR_MICRO = 4
# The norm-relative limit of a float32 result computed in another order
# (tp_mlp's, tp_self_attention's output and grads, ep_moe's against their
# unsplit versions): both sides round f32 sums of up to 8,192 terms (the
# grads' sums over tokens; 4,096 over the MLP's hidden width, 1,024 over
# the heads' features), the split side as 4 rank partials added in rank
# order, the unsplit one in cuBLAS's own order.  The rounding of such a sum
# moves like a random walk, ~sqrt(8192) * 2**-24 = 5.4e-6 of its size, so
# two orders differ by about that; 1e-4 leaves a margin of ~18 for the
# gelu's and the softmax's slopes.  A rank's block dropped, doubled or
# misplaced moves the result by a quarter of itself.
PAR_RTOL = 1e-4


def rel_gap(torch, got, want):
    """||got - want|| / ||want||, and the largest elementwise gap."""
    gap = (got.float() - want.float())
    return float(gap.norm() / want.float().norm()), float(gap.abs().max())


def timed_s(torch, fn):
    """``fn()`` and the seconds its second call took (the first warms
    cuBLAS's and the allocator's choices for its shapes), the card
    synchronized on both sides."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(kernels, fn):
    """``fn()`` with every kernel's count set to 0 just before: read just
    after, the counts are this call's."""
    zero_counts(kernels)
    return fn()


def par_randn(torch, gen, *shape, scale=1.0):
    return scale * torch.randn(*shape, device="cuda", generator=gen)


def par_grads(torch, fn, args, wrt, cot):
    """``fn(*args)`` and the grads of ``sum(out * cot)`` with respect to
    ``args[i]`` for ``i`` in ``wrt``, by autograd."""
    leaves = [a.detach().clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, [leaves[i] for i in wrt], cot)
    return (out.detach(),) + tuple(grads)


def par_hold(name, readings, smi):
    """Print a path's readings on its own line with the card, and fail on
    a norm-relative gap past PAR_RTOL."""
    print(f"{name} on {smi}: " + json.dumps(readings))
    bad = {k: v for k, v in readings.items()
           if isinstance(v, tuple) and not v[0] <= PAR_RTOL}
    if bad:
        raise AssertionError(f"{name}: past the limit {PAR_RTOL} (norm gap, max gap): {bad}")


def tp_mlp_longcontext(torch, kernels, all_paths, smi):
    """``tp_mlp`` over PAR_RANKS virtual ranks at x (1, 8,192, 1,024), h
    4,096: the forward and the grads of w1 and w2 against the dense MLP on
    the card, within PAR_RTOL.  Plain products: no kernel of the port lies
    on this path (its count must stay 0)."""
    from mpit_tpu_torch.parallel import Mesh, tp_mlp
    from mpit_tpu_torch.parallel.tensor_parallel import gelu

    gen = torch.Generator(device="cuda").manual_seed(21)
    d, h = PAR_D, PAR_MLP
    args = (par_randn(torch, gen, 1, PAR_L, d), par_randn(torch, gen, d, h, scale=d**-0.5),
            par_randn(torch, gen, h, scale=0.1), par_randn(torch, gen, h, d, scale=h**-0.5),
            par_randn(torch, gen, d, scale=0.1))
    cot = par_randn(torch, gen, 1, PAR_L, d)
    tp = tp_mlp(Mesh("cuda", tp=PAR_RANKS))

    def dense(x, w1, b1, w2, b2):
        return torch.matmul(gelu(torch.matmul(x, w1) + b1), w2) + b2

    got, tp_s = timed_s(torch, lambda: counted(kernels, lambda: par_grads(
        torch, tp, args, (1, 3), cot)))
    launches = read_counts(kernels)
    want, dense_s = timed_s(torch, lambda: par_grads(torch, dense, args, (1, 3), cot))
    readings = {what: rel_gap(torch, a, b) for what, a, b in zip(("out", "dw1", "dw2"),
                                                                 got, want)}
    readings.update(tp_ms=tp_s * 1e3, dense_ms=dense_s * 1e3, launches=launches)
    par_hold("tp_mlp_longcontext (tp 4, fwd + dw1, dw2; gap norm / norm, max gap)",
             readings, smi)
    expect_launches("tp_mlp_longcontext", launches, {})
    record_path(all_paths, "tp_mlp_longcontext", launches, 1)


@contextlib.contextmanager
def captured_attention(torch):
    """``tensor_parallel.flash_attention`` wrapped inside the block to keep
    each call's output (the heads) in the list it yields."""
    import importlib

    tp_mod = importlib.import_module("mpit_tpu_torch.parallel.tensor_parallel")
    real, seen = tp_mod.flash_attention, []

    def keep(*a, **kw):
        out = real(*a, **kw)
        seen.append(out.detach())
        return out

    tp_mod.flash_attention = keep
    try:
        yield seen
    finally:
        tp_mod.flash_attention = real


def tp_attn_longcontext(torch, kernels, all_paths, smi):
    """``tp_self_attention`` over PAR_RANKS ranks (2 of the 8 heads a rank),
    causal, float32, at x (1, 8,192, 1,024): one K4 launch a call for all
    ranks' heads, and K5 once (K6 twice) in its backward as the gate
    decides; against the unsplit 8-head ``flash_attention`` and ``wo``
    product on the card: the heads bit for bit (K4 runs each head's row on
    the same inputs), the output and the grads of x, wqkv and wo within
    PAR_RTOL (the output projection sums 4 rank partials)."""
    from mpit_tpu_torch.ops.flash_attention import _use_fused_bwd, flash_attention
    from mpit_tpu_torch.parallel import Mesh, tp_self_attention

    gen = torch.Generator(device="cuda").manual_seed(22)
    d, heads, dh = PAR_D, PAR_HEADS, PAR_D // PAR_HEADS
    args = (par_randn(torch, gen, 1, PAR_L, d),
            par_randn(torch, gen, d, 3, heads, dh, scale=d**-0.5),
            par_randn(torch, gen, heads, dh, d, scale=d**-0.5))
    cot = par_randn(torch, gen, 1, PAR_L, d)
    tp = tp_self_attention(Mesh("cuda", tp=PAR_RANKS), causal=True)

    def dense(x, wqkv, wo):
        qkv = torch.matmul(x.reshape(PAR_L, d), wqkv.reshape(d, -1))
        qkv = qkv.reshape(1, PAR_L, 3, heads, dh).permute(2, 0, 3, 1, 4).contiguous()
        out = flash_attention(qkv[0], qkv[1], qkv[2], causal=True)
        dense.heads = out.detach()
        return torch.einsum("bhlk,hkd->bld", out, wo)

    fused = _use_fused_bwd((PAR_RANKS, 1, heads // PAR_RANKS, PAR_L, dh),
                           (PAR_RANKS, 1, heads // PAR_RANKS, PAR_L, dh), dh,
                           torch.device("cuda"), torch.float32)
    with captured_attention(torch) as seen:
        def call():
            seen.clear()
            return par_grads(torch, tp, args, (0, 1, 2), cot)

        got, tp_s = timed_s(torch, lambda: counted(kernels, call))
    launches = read_counts(kernels)
    want, dense_s = timed_s(torch, lambda: par_grads(torch, dense, args, (0, 1, 2), cot))
    tp_heads = seen[0].reshape(1, heads, PAR_L, dh) if len(seen) == 1 else None
    readings = {what: rel_gap(torch, a, b) for what, a, b in zip(("out", "dx", "dwqkv",
                                                                  "dwo"), got, want)}
    readings.update(heads_bit_for_bit=tp_heads is not None
                    and torch.equal(tp_heads, dense.heads),
                    schedule="K5" if fused else "K6", tp_ms=tp_s * 1e3,
                    dense_ms=dense_s * 1e3, launches=launches)
    par_hold("tp_attn_longcontext (tp 4, 2 heads a rank, f32, fwd + grads)", readings, smi)
    expect_launches("tp_attn_longcontext", launches,
                    {"k4": 1, "k5": 1} if fused else {"k4": 1, "k6": 2})
    if not readings["heads_bit_for_bit"]:
        raise AssertionError("tp_attn_longcontext: the ranks' heads are not the unsplit "
                             "heads bit for bit")
    record_path(all_paths, "tp_attn_longcontext", launches, 1)


def pp_decoder_longcontext(torch, kernels, all_paths, smi):
    """``pipeline`` over PAR_RANKS stages, ``lm_longcontext``'s 4
    ``DecoderBlock``s (random weights from the seed, float32 attention), on
    PAR_MICRO microbatches of one 8,192-token row: the forward and the
    grads of every stacked leaf of ``sum(out * cot)``, against the 4 blocks
    run in sequence, microbatch by microbatch, on the same stage views.
    The forward is the same calls on the same inputs: bit for bit.  The
    grads sum each block's 4 microbatch contributions in autograd's order:
    every leaf that differs is named, and held within
    ``LM_LIMITS["float32"]``'s gap_over_change (as a norm-relative gap).
    K4 launches once a stage call: 16 forward; K5 16 (or K6 32) backward."""
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.transformer import DecoderBlock, TinyDecoder
    from mpit_tpu_torch.ops.flash_attention import _use_fused_bwd
    from mpit_tpu_torch.parallel import Mesh, pipeline, stack_stage_params

    n, m = PAR_RANKS, PAR_MICRO
    flat = flatten_module(TinyDecoder(vocab=256, d_model=PAR_D, n_heads=PAR_HEADS,
                                      n_layers=n, max_len=PAR_L), 3, "cuda")
    views = flat.unravel(flat.w0)
    blocks = [{name[len(f"DecoderBlock_{i}."):]: t for name, t in views.items()
               if name.startswith(f"DecoderBlock_{i}.")} for i in range(n)]
    block = DecoderBlock(PAR_D, PAR_HEADS).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(23)
    xs = par_randn(torch, gen, m, 1, PAR_L, PAR_D)
    cot = par_randn(torch, gen, m, 1, PAR_L, PAR_D)

    def stage(p, x):
        return torch.func.functional_call(block, p, (x,))

    def run(pipelined):
        stacked = {k: v.clone().requires_grad_() for k, v in
                   stack_stage_params(blocks).items()}
        if pipelined:
            out = pipeline(Mesh("cuda", pp=n), stage)(stacked, xs)
        else:
            params = [{k: v[i] for k, v in stacked.items()} for i in range(n)]
            outs = []
            for j in range(m):
                x = xs[j]
                for i in range(n):
                    x = stage(params[i], x)
                outs.append(x)
            out = torch.stack(outs)
        grads = torch.autograd.grad(out, list(stacked.values()), cot)
        return out.detach(), dict(zip(stacked, grads))

    head = PAR_D // PAR_HEADS
    shape = (1, PAR_HEADS, PAR_L, head)
    fused = _use_fused_bwd(shape, shape, head, torch.device("cuda"), torch.float32)
    with deterministic_algorithms(torch):
        (out, grads), pp_s = timed_s(torch, lambda: counted(kernels, lambda: run(True)))
        launches = read_counts(kernels)
        (ref_out, ref_grads), seq_s = timed_s(torch, lambda: run(False))
    differ = {k: rel_gap(torch, g, ref_grads[k]) for k, g in grads.items()
              if not torch.equal(g, ref_grads[k])}
    readings = {"out_bit_for_bit": torch.equal(out, ref_out),
                "grads_bit_for_bit": len(grads) - len(differ), "grads": len(grads),
                "differ (norm gap, max gap)": differ, "pp_ms": pp_s * 1e3,
                "sequential_ms": seq_s * 1e3, "schedule": "K5" if fused else "K6",
                "launches": launches}
    print(f"pp_decoder_longcontext (pp {n}, {m} microbatches of 1 x {PAR_L}, f32) on "
          f"{smi}: " + json.dumps(readings))
    calls = n * m
    expect_launches("pp_decoder_longcontext", launches,
                    {"k4": calls, "k5": calls} if fused else {"k4": calls, "k6": 2 * calls})
    if not readings["out_bit_for_bit"]:
        raise AssertionError("pp_decoder_longcontext: the pipeline's output is not the "
                             "sequential blocks' bit for bit")
    limit = LM_LIMITS["float32"]["gap_over_change"]
    bad = {k: v for k, v in differ.items() if not v[0] <= limit}
    if bad:
        raise AssertionError(f"pp_decoder_longcontext: grads past {limit}: {bad}")
    record_path(all_paths, "pp_decoder_longcontext", launches, 1)


def ep_moe_longcontext(torch, kernels, all_paths, smi):
    """``ep_moe`` over PAR_RANKS ranks, PAR_EXPERTS experts (2 a rank), d
    1,024, h 4,096, 8,192 tokens: the forward and the grads of the gate and
    w1 against ``moe_reference`` on the card, within PAR_RTOL.  No Pallas
    kernel lies on this path (the JAX package's is dense dispatch in XLA):
    every op is a plain PyTorch one, and no kernel of the port launches."""
    from mpit_tpu_torch.parallel import Mesh, ep_moe, moe_reference

    gen = torch.Generator(device="cuda").manual_seed(24)
    e, d, h = PAR_EXPERTS, PAR_D, PAR_MLP
    args = (par_randn(torch, gen, 1, PAR_L, d), par_randn(torch, gen, d, e, scale=d**-0.5),
            par_randn(torch, gen, e, d, h, scale=d**-0.5), par_randn(torch, gen, e, h, scale=0.1),
            par_randn(torch, gen, e, h, d, scale=h**-0.5), par_randn(torch, gen, e, d, scale=0.1))
    cot = par_randn(torch, gen, 1, PAR_L, d)
    ep = ep_moe(Mesh("cuda", ep=PAR_RANKS))
    got, ep_s = timed_s(torch, lambda: counted(kernels, lambda: par_grads(
        torch, ep, args, (1, 2), cot)))
    launches = read_counts(kernels)
    want, ref_s = timed_s(torch, lambda: par_grads(torch, moe_reference, args, (1, 2), cot))
    routed = torch.bincount(torch.argmax(args[0].reshape(-1, d) @ args[1], -1), minlength=e)
    readings = {what: rel_gap(torch, a, b) for what, a, b in zip(("out", "dgate", "dw1"),
                                                                 got, want)}
    readings.update(tokens_per_expert=routed.tolist(), ep_ms=ep_s * 1e3,
                    reference_ms=ref_s * 1e3, launches=launches)
    par_hold("ep_moe_longcontext (ep 4, 8 experts, fwd + dgate, dw1)", readings, smi)
    expect_launches("ep_moe_longcontext", launches, {})
    record_path(all_paths, "ep_moe_longcontext", launches, 1)


def lm_dp2_sp4_longcontext(torch, kernels, all_paths, smi):
    """``lm_launch --dp 2 --sp 4 --layout zigzag`` at ``lm_longcontext``'s
    widths, bf16 attention, batch 2, 5 steps, against ``--dp 1 --sp 4`` at
    batch 2, both under deterministic algorithms: every step's loss and the
    final w, vt and k bit for bit, and K1, K4 and K5 / K6 launched alike
    (the two groups' rows ride the ring's launches); tokens/s of both."""
    from mpit_tpu_torch.train.lm_launch import LONGCONTEXT_KWARGS

    kw = dict(LONGCONTEXT_KWARGS, batch=2, steps=5, log_every=1, sp=RING_SP,
              layout="zigzag")
    runs = {}
    torch.cuda.empty_cache()
    with deterministic_algorithms(torch), fused_bwd_env(None):
        for dp in (2, 1):
            runs[dp] = lm_path(torch, f"lm_dp{dp}_sp4_longcontext", kernels, dp=dp, **kw)
    (two, rec), (one, rec_one) = runs[2], runs[1]
    losses = {dp: [h["avg_loss"] for h in r[0]["history"]] for dp, r in runs.items()}
    same = losses[2] == losses[1] and all(torch.equal(two["state"][k], one["state"][k])
                                          for k in ("w", "vt", "k"))
    print(f"lm_dp2_sp4_longcontext on {smi}: bit for bit --dp 1: {same}; tokens/s dp 2 "
          f"{two['tokens_per_sec']}, dp 1 {one['tokens_per_sec']}; launches equal: "
          f"{rec['launches'] == rec_one['launches']}")
    if not same:
        raise AssertionError(f"lm_dp2_sp4_longcontext: --dp 2 differs from --dp 1: {losses}")
    if rec["launches"] != rec_one["launches"]:
        raise AssertionError(f"lm_dp2_sp4_longcontext: launches {rec['launches']} at dp 2, "
                             f"{rec_one['launches']} at dp 1")
    record_path(all_paths, "lm_dp2_sp4_longcontext", rec["launches"], rec["steps"])
    record_path(all_paths, "lm_dp1_sp4_longcontext", rec_one["launches"], rec_one["steps"])


def mesh_shard2(torch, commit, all_paths, smi):
    """``mesh_launch`` at FLAGSHIP_BENCH_KWARGS, ``--dp 4 --shard 2``, 2
    epochs, against ``--shard 1``, under deterministic cuDNN (the first
    convolution's weight gradient varies from run to run under its
    defaults): every epoch's loss and test error and the final w, vt, k
    and center bit for bit, and K1 launched alike, once a step over the
    whole (dp, plong) stack and once for each of precompile's 2 warm-up
    steps."""
    from mpit_tpu_torch.train.mesh_launch import (
        FLAGSHIP_BENCH_KWARGS, MESH_LAUNCH_DEFAULTS, run)

    base = MESH_LAUNCH_DEFAULTS.merged(FLAGSHIP_BENCH_KWARGS, dp=4, epochs=2, device="cuda")
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        for shard in (2, 1):
            commit.launches = 0
            res = run(base.merged(shard=shard))
            runs[shard] = (res, commit.launches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (two, k1), (one, k1_one) = runs[2], runs[1]
    curve = lambda r: [(h["avg_loss"], h["test_err"]) for h in r["history"]]  # noqa: E731
    same = curve(two) == curve(one) and all(torch.equal(two["state"][k], one["state"][k])
                                            for k in two["state"])
    print(f"mesh_shard2 on {smi}: mesh {two['mesh']}, bit for bit --shard 1: {same}; "
          f"K1 {k1} (shard 1: {k1_one}) for {two['steps']} steps; samples/s "
          f"{two['samples_per_sec']} (shard 1: {one['samples_per_sec']})")
    if two["mesh"] != {"dp": 4, "shard": 2} or not same:
        raise AssertionError("mesh_shard2: --shard 2 differs from --shard 1")
    if not k1 == k1_one == two["steps"] + 2:
        raise AssertionError(f"mesh_shard2: K1 launched {k1} and {k1_one} times for "
                             f"{two['steps']} steps + 2 warm-up")
    record_path(all_paths, "mesh_shard2", {"k1": k1}, two["steps"])
    record_path(all_paths, "mesh_shard1", {"k1": k1_one}, one["steps"])


PG_CHILD = """
import sys, torch
sys.path.insert(0, {repo!r})
from mpit_tpu_torch.parallel import bootstrap
from mpit_tpu_torch.parallel.distributed import shutdown
pg = bootstrap(coordinator="localhost:{port}", num_processes=1, process_id=0, device="cuda")
t = torch.arange(1.0, 5.0, device="cuda")
torch.distributed.all_reduce(t)
torch.cuda.synchronize()
assert torch.distributed.get_backend() == "nccl", torch.distributed.get_backend()
assert t.tolist() == [1.0, 2.0, 3.0, 4.0], t.tolist()
print("GROUP", pg.describe(), "backend nccl, all_reduce", t.tolist())
shutdown()
"""


def pg_group_of_one(smi):
    """In a child process: ``bootstrap`` of a group of one over NCCL on the
    card, one ``all_reduce``, ``describe()``, ``shutdown``; its exit code
    and its printed group."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MPIT_COORDINATOR", "MPIT_NUM_PROCESSES", "MPIT_PROCESS_ID",
                        "MPIT_HOSTFILE")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PG_CHILD.format(repo=REPO, port=port)],
                          capture_output=True, text=True, timeout=180, env=env)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("GROUP")]
    print(f"pg_group_of_one on {smi}: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f}s: {line}")
    if proc.returncode != 0 or not line or "process 0/1" not in line[0]:
        raise AssertionError(f"pg_group_of_one: the child failed: {proc.stderr[-2000:]}")


def parallel_phases(torch, kernels, all_paths, smi):
    """Tensor, pipeline and expert parallelism, ``lm_launch --dp`` and
    ``mesh_launch --shard`` on the card's virtual ranks, and a process group
    of one (slice 9), at ``lm_longcontext``'s widths; each path's seconds on
    its own line."""
    secs = {}
    for name, fn in (("tp_mlp_longcontext", tp_mlp_longcontext),
                     ("tp_attn_longcontext", tp_attn_longcontext),
                     ("pp_decoder_longcontext", pp_decoder_longcontext),
                     ("ep_moe_longcontext", ep_moe_longcontext),
                     ("lm_dp2_sp4_longcontext", lm_dp2_sp4_longcontext)):
        t0 = time.perf_counter()
        fn(torch, kernels, all_paths, smi)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_shard2(torch, kernels["k1"], all_paths, smi)
    secs["mesh_shard2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pg_group_of_one(smi)
    secs["pg_group_of_one"] = time.perf_counter() - t0
    print(f"parallel phases: {sum(secs.values()):.1f}s " + json.dumps(
        {k: round(v, 1) for k, v in secs.items()}))


# -- meshes over a group of processes sharing the card (slice 9b) -----------------

#: epochs of ``mp_easgd``'s first run and of its resume (the JAX test's [2, 3])
MP_EPOCHS, MP_RESUME_EPOCHS = 2, 4
#: the LM pair's steps at ``lm_default``'s widths
MP_LM_STEPS = 5
#: the steps of ``mp_lm_sp`` (``lm_longcontext``'s widths at ``--sp 2``, zigzag,
#: over two processes) and of ``mp_lm_dp_sp`` (``lm_default``'s at ``--dp 2
#: --sp 2`` over four)
MP_LM_SP_STEPS = 4
#: ``mp_shard``'s epochs (the flagship CNN's EASGD at ``--dp 1 --shard 2``)
MP_SHARD_EPOCHS = 2
#: sync-DP across processes against one process: the per-epoch losses'
#: relative gap (tests/test_torch_syncdp.py's LOSS_RTOL).  The mean of two
#: processes' mean gradients is the batch's mean up to float32 rounding.
MP_LOSS_RTOL = 1e-5
#: K1's tolerances (its CPU tests'), for rows whose bits move with the
#: ``vmap`` width alone (``mp_vmap_control``)
K1_RTOL, K1_ATOL = 1e-5, 1e-6
MP_CHILD_TIMEOUT_S = 300
GROUP_VARS = ("MPIT_COORDINATOR", "MPIT_NUM_PROCESSES", "MPIT_PROCESS_ID", "MPIT_HOSTFILE")
#: sync-DP's settings on the card (``mesh_syncdp``'s), and the model of each run
MP_SYNCDP = dict(opt="syncdp", side=32, batch=128, lr=0.2, mom=0.9, epochs=2,
                 device_stream=1, precompile=1, dp=2)

# One process of a group: each run is the launcher's CLI (``main``) over a
# group of its own (its own port), under deterministic cuDNN; its state
# is saved for the parent, and its K1 and K4-K6 launches, its group's
# formation, each EASGD exchange (``timed_exchanges``) and each ring hop
# between processes (``timed_hops``) are reported; the process's start-up
# (imports, the CUDA context) once.
MP_CHILD = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {repo!r})
import importlib
import torch
import chip_smoke
from mpit_tpu_torch.ops import fused_update as fu
from mpit_tpu_torch.train import lm_launch, mesh_launch
fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
import_s = time.perf_counter() - t0
torch.zeros(1, device="cuda")
cuda_init_s = time.perf_counter() - t0 - import_s
torch.backends.cudnn.deterministic = True
runs, pid = json.loads(sys.argv[1]), sys.argv[2]
times = {{}}
def timed_boot(real):
    def boot(cfg, device):
        t = time.perf_counter()
        pg = real(cfg, device)
        times["group_s"] = time.perf_counter() - t
        return pg
    return boot
for mod in (lm_launch, mesh_launch):
    mod.bootstrap_launcher = timed_boot(mod.bootstrap_launcher)
kernels = {{"k1": fu.fused_nesterov_commit, "k4": fa.flash_fwd,
           "k5": fa.flash_bwd_fused, "k6": fa.flash_bwd_two_kernel}}
for run in runs:
    times.clear()
    times["exchange_ms"], times["hops"] = [], []
    for k in kernels.values():
        k.launches = 0
    mod = lm_launch if run["module"] == "lm" else mesh_launch
    with chip_smoke.timed_exchanges(torch, times["exchange_ms"]), \
            chip_smoke.timed_hops(torch, times["hops"]):
        res = mod.main(run["argv"] + ["--process_id", pid])
    torch.cuda.synchronize()
    torch.save({{k: v.cpu() for k, v in res.pop("state").items()}},
               run["state"].format(pid=pid))
    res.update(name=run["name"], launches={{k: v.launches for k, v in kernels.items()}},
               import_s=import_s, cuda_init_s=cuda_init_s, **times)
    print("RESULT " + json.dumps(res), flush=True)
"""


def cli_args(cfg_kw):
    """Keyword settings as the launchers' command line."""
    return [a for k, v in cfg_kw.items() for a in (f"--{k}", str(v))]


def free_ports(n):
    """``n`` distinct free ports on the loopback (held open together while
    they are picked)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def mp_group(torch, runs, tmp, world=2):
    """``world`` processes sharing the card, side by side, each running
    every run of ``runs`` (``name``, ``module`` "mesh" or "lm", ``argv``) in
    turn, each run a group of its own: per run, every process's result and
    state (on the CPU); the group's wall seconds.  Each process must exit 0
    in time, and each run go over gloo with its tensors on the card."""
    ports = free_ports(len(runs))
    spec = [{"name": r["name"], "module": r["module"],
             "state": os.path.join(tmp, f"{r['name']}_{{pid}}.pt"),
             "argv": r["argv"] + ["--device", "cuda", "--coordinator", f"127.0.0.1:{port}",
                                  "--num_processes", str(world)]}
            for r, port in zip(runs, ports)]
    pids = range(world)
    env = {k: v for k, v in os.environ.items() if k not in GROUP_VARS}
    env["MPIT_LOG_STREAM"] = "stderr"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MP_CHILD.format(repo=REPO), json.dumps(spec), str(pid)],
        cwd=REPO, env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in pids]
    outs = []
    try:
        for pid, proc in enumerate(procs):
            out, err = proc.communicate(timeout=MP_CHILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"multiproc: process {pid} exited {proc.returncode}: "
                                     f"{err[-3000:]}")
            outs.append([json.loads(ln[len("RESULT "):]) for ln in out.splitlines()
                         if ln.startswith("RESULT ")])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    runs_out = {}
    for i, r in enumerate(spec):
        results = [outs[pid][i] for pid in pids]
        for pid, res in enumerate(results):
            if (res["name"], res["backend"], res["processes"]) != (r["name"], "gloo", world) \
                    or not res["device"].startswith("cuda"):
                raise AssertionError(f"{r['name']}: process {pid} ran {res['processes']} "
                                     f"processes over {res['backend']} on {res['device']}")
        states = [torch.load(r["state"].format(pid=pid), map_location="cpu") for pid in pids]
        runs_out[r["name"]] = (results, states)
    return runs_out, wall


def expect_child_launches(name, results, want):
    """Every child launched each kernel as often as the one-process run."""
    for pid, res in enumerate(results):
        got = {k: res["launches"].get(k, 0) for k in ("k1", "k4", "k5", "k6")}
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"{name}: process {pid} launched {got}, the one-process "
                                 f"run {want}")


def mp_vmap_control(torch):
    """One process: the flagship CNN's per-worker gradients (side 32, batch
    128 a row) of rows 0-1 in a ``vmap`` over four rows and over those two
    alone, under deterministic cuDNN.  Returns whether they are the same
    bits, and the largest gap."""
    import numpy as np

    from mpit_tpu_torch.data.mnist import load_mnist
    from mpit_tpu_torch.models.flat import flatten_module, value_and_grad_nll
    from mpit_tpu_torch.models.mnist import make_model

    (x, y, _, _), _ = load_mnist(side=32)
    xb = torch.as_tensor(x[:512].reshape(4, 128, -1), dtype=torch.float32, device="cuda")
    yb = torch.as_tensor(y[:512].reshape(4, 128).astype(np.int64), device="cuda")
    flat = flatten_module(make_model("cnn", 32), 1, "cuda")
    vg = torch.func.vmap(value_and_grad_nll(flat))
    w = flat.w0.expand(4, -1).clone()
    deterministic = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        (l4, g4), (l2, g2) = vg(w, xb, yb), vg(w[:2], xb[:2], yb[:2])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = torch.equal(g4[:2], g2) and torch.equal(l4[:2], l2)
    return same, float((g4[:2] - g2).abs().max())


def epochs_of(res):
    return [(h["epoch"], h["avg_loss"], h["test_err"]) for h in res["history"]]


def mp_hold_rows(torch, name, results, states, one, exact, rows_of=None):
    """Each child's history and its rows of the state against the
    one-process run's: bit for bit where ``exact``, else within K1's
    tolerances (losses too) and one test sample.  ``rows_of(pid)``: the
    process's rows of the ``dp`` stack (two a process by default).
    Returns each tensor's largest gap; a miss raises with all of them."""
    gaps, misses = {}, []
    for pid, (res, st) in enumerate(zip(results, states)):
        rows = rows_of(pid) if rows_of else slice(2 * pid, 2 * pid + 2)
        for key, got in st.items():
            want = one["state"][key].cpu()
            want = want if key == "center" else want[rows]
            gaps[f"{key}{pid}"] = float((got.double() - want.double()).abs().max())
            held = (torch.equal(got, want) if exact else
                    bool(torch.isclose(got, want, rtol=K1_RTOL, atol=K1_ATOL).all()))
            if not held:
                misses.append(f"process {pid}'s {key}")
        if exact and epochs_of(res) != epochs_of(one):
            misses.append(f"process {pid}'s epochs {epochs_of(res)}, one process "
                          f"{epochs_of(one)}")
        for (e, lp, tp), (_, lo, to) in zip(epochs_of(res), epochs_of(one)):
            if abs(lp - lo) > K1_RTOL * abs(lo) or abs(tp - to) > 1.0 / N_TEST + 1e-7:
                misses.append(f"process {pid}'s epoch {e}: ({lp}, {tp}), one process "
                              f"({lo}, {to})")
    if misses:
        raise AssertionError(f"{name}: {'bit for bit' if exact else 'K1 tolerances'} "
                             f"missed by {misses}; largest gaps {gaps}")
    return gaps


@contextlib.contextmanager
def timed_exchanges(torch, times):
    """``MeshEASGD._exchange`` timed call by call (the card synchronized
    around it), as the children time theirs."""
    from mpit_tpu_torch.parallel.easgd import MeshEASGD

    real = MeshEASGD._exchange

    def exchange(self, center, sug):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(self, center, sug)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)

    MeshEASGD._exchange = exchange
    try:
        yield
    finally:
        MeshEASGD._exchange = real


@contextlib.contextmanager
def timed_hops(torch, hops):
    """``collective.RingHop.move`` timed call by call (the card
    synchronized around it): ``(ms, bytes sent, path)`` appended to
    ``hops``, the bytes the boundary blocks', the path the hop's
    (``"host"``: gloo, each block copied to the host and back; ``"card"``:
    NCCL)."""
    from mpit_tpu_torch.parallel.collective import RingHop

    real = RingHop.move

    def move(self, blocks, step):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(self, blocks, step)
        torch.cuda.synchronize()
        hops.append(((time.perf_counter() - t) * 1e3,
                     sum(b[0].numel() * b.element_size() for b in blocks),
                     "host" if self.staged else "card"))
        return out

    RingHop.move = move
    try:
        yield
    finally:
        RingHop.move = real


def lm_state_gaps(torch, got, want, w0, lim):
    """The gaps of a run's final w and vt (``got``) to another's
    (``want``), and whether they hold ``lim`` (an ``LM_LIMITS`` entry):
    the largest gap (absolute, or a share of the largest change) and the
    gap's norm over the change's."""
    readings, held = {}, True
    for key in ("w", "vt"):
        gap = got[key].float() - want[key].float()
        change = want[key].float() - (w0 if key == "w" else 0.0)
        r = {"max_abs_gap": float(gap.abs().max()), "max_abs_change": float(change.abs().max()),
             "gap_over_change": float(gap.norm() / change.norm()),
             "bit_for_bit": bool(torch.equal(got[key], want[key]))}
        max_abs = lim.get("max_abs_gap", lim.get("max_abs_share", 0.0) * r["max_abs_change"])
        held = held and r["max_abs_gap"] <= max_abs and r["gap_over_change"] <= \
            lim["gap_over_change"]
        readings[key] = r
    return readings, held


def ring_share(cfg, ranks):
    """The launches of K4 and of the pair backward that ``ranks`` of the
    ring's ``sp`` ranks make in a pass: ``ring_pairs(n, layout) / n`` a
    rank (``n`` contiguous, ``2n + 1`` zigzag, the same for every rank)."""
    from mpit_tpu_torch.parallel.ring_attention import ring_pairs

    n = int(cfg.sp)
    return ring_pairs(n, cfg.layout) // n * ranks


@contextlib.contextmanager
def half_batch_gradients(torch):
    """``mesh_launch``'s sync-DP gradient as two processes of one row of dp
    compute it: each half of the batch's mean loss and gradient, the two
    averaged, ``(first + second) / 2``, in one float32 vector as
    ``process_mean`` averages them: the pair's arithmetic in one process."""
    import mpit_tpu_torch.train.mesh_launch as ml

    real = ml.value_and_grad_nll_eager

    def halves(flat):
        vgf = real(flat)

        def vg(w, xb, yb):
            n = xb.shape[0] // 2
            parts = [torch.cat([g, loss.reshape(1)])
                     for loss, g in (vgf(w, xb[:n], yb[:n]), vgf(w, xb[n:], yb[n:]))]
            both = (parts[0] + parts[1]) / 2
            return both[-1], both[:-1]

        return vg

    ml.value_and_grad_nll_eager = halves
    try:
        yield
    finally:
        ml.value_and_grad_nll_eager = real


def step_ms(res, per_step):
    """A run's training milliseconds a step (its epochs' walls over the
    steps it trained)."""
    return res["train_time"] / (res["samples_trained"] / per_step) * 1e3


def multiproc_phases(torch, kernels, all_paths, smi):
    """Meshes over a group of two processes sharing the card (slice 9b).
    First ``mp_vmap_control``; then the one-process controls in this
    process; then one pair of processes running, each in a group of its
    own: ``mp_easgd`` (the flagship CNN at ``--dp 4 --su 2``, 2 epochs with
    ``--ckpt_dir``), ``mp_easgd_resume`` (the pair's checkpoint resumed to
    4 epochs; its one-process control resumes the same file after the pair),
    ``mp_syncdp_linear`` and ``mp_syncdp_cnn`` (``--opt syncdp`` at
    ``--dp 2``, batch 128: the linear model against one process within
    ``MP_LOSS_RTOL``; the CNN, whose half-batch gradients leave the whole
    batch's trajectory within a few steps on the card at these settings,
    bit for bit against one process computing the pair's arithmetic,
    ``half_batch_gradients``, its gap to the plain one-process run
    printed) and ``mp_lm`` (``lm_launch --dp 2`` at ``lm_default``'s
    widths, 5 steps, bfloat16 attention: w and vt within
    ``LM_LIMITS["float32"]``; each row's attention is the same bits in both,
    what differs is the float32 sum over rows and the processes' mean).
    Every child's K1 and K4-K6 launches equal the one-process run's."""
    import tempfile

    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.transformer import TinyDecoder
    from mpit_tpu_torch.train.lm_launch import LM_LAUNCH_DEFAULTS, LONGCONTEXT_KWARGS
    from mpit_tpu_torch.train.mesh_launch import (
        FLAGSHIP_BENCH_KWARGS, MESH_LAUNCH_DEFAULTS, run)

    t_block = time.perf_counter()
    commit = kernels["k1"]
    exact, gap = mp_vmap_control(torch)
    print(f"mp_vmap_control on {smi}: rows 0-1 of a vmap over four rows and over two: "
          f"{'the same bits' if exact else 'bits differ'} (largest gap {gap}); the "
          f"EASGD pair's rows held {'bit for bit' if exact else 'within K1 rtol 1e-5 / atol 1e-6'}")
    easgd = dict(FLAGSHIP_BENCH_KWARGS, dp=4, su=2, epochs=MP_EPOCHS)
    syncdp = {"linear": dict(MP_SYNCDP, model="linear"), "cnn": dict(MP_SYNCDP, model="cnn")}
    lm_kw = dict(dp=2, steps=MP_LM_STEPS, log_every=1)
    shard_kw = dict(FLAGSHIP_BENCH_KWARGS, dp=1, shard=2, epochs=MP_SHARD_EPOCHS)
    axes_lm = {"mp_lm_sp": dict(LONGCONTEXT_KWARGS, sp=2, layout="zigzag",
                                steps=MP_LM_SP_STEPS, log_every=1),
               "mp_lm_dp_sp": dict(dp=2, sp=2, layout="zigzag", steps=MP_LM_SP_STEPS,
                                   log_every=1)}
    ones, k1s, ex_ms = {}, {}, {"mp_easgd": [], "mp_easgd_resume": [], "mp_shard": []}
    axes_recs = {}
    deterministic = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory() as tmp:
        d = {k: os.path.join(tmp, k) for k in ("one", "pair", "pair_resume", "one_resume")}
        try:
            torch.backends.cudnn.deterministic = True
            t0 = time.perf_counter()
            for name, kw, ctx in (
                    ("mp_easgd", dict(easgd, ckpt_dir=d["one"]), timed_exchanges(
                        torch, ex_ms["mp_easgd"])),
                    ("mp_syncdp_linear", syncdp["linear"], contextlib.nullcontext()),
                    ("mp_syncdp_cnn", syncdp["cnn"], half_batch_gradients(torch)),
                    ("mp_syncdp_cnn_whole", syncdp["cnn"], contextlib.nullcontext()),
                    ("mp_shard", shard_kw, timed_exchanges(torch, ex_ms["mp_shard"]))):
                commit.launches = 0
                with ctx:
                    ones[name] = run(MESH_LAUNCH_DEFAULTS.merged(kw, device="cuda"))
                k1s[name] = {"k1": commit.launches}
            with fused_bwd_env(None):
                ones["mp_lm"], lm_rec = lm_path(torch, "mp_lm_one", kernels, **lm_kw)
                for name, kw in axes_lm.items():
                    ones[name], axes_recs[name] = lm_path(torch, f"{name}_one", kernels, **kw)
                    ones[name]["state"] = {k: v.cpu() for k, v in ones[name]["state"].items()}
            k1s["mp_lm"] = lm_rec["launches"]
            torch.cuda.empty_cache()
            one_s = time.perf_counter() - t0
            resume_file = os.path.join(d["pair"], "mesh_latest.npz")
            pair, wall = mp_group(torch, [
                dict(name="mp_easgd", module="mesh",
                     argv=cli_args(dict(easgd, ckpt_dir=d["pair"]))),
                dict(name="mp_easgd_resume", module="mesh", argv=cli_args(dict(
                    easgd, epochs=MP_RESUME_EPOCHS, resume=resume_file,
                    ckpt_dir=d["pair_resume"]))),
                dict(name="mp_syncdp_linear", module="mesh", argv=cli_args(syncdp["linear"])),
                dict(name="mp_syncdp_cnn", module="mesh", argv=cli_args(syncdp["cnn"])),
                dict(name="mp_lm", module="lm", argv=cli_args(lm_kw)),
                dict(name="mp_shard", module="mesh", argv=cli_args(shard_kw)),
                dict(name="mp_lm_sp", module="lm", argv=cli_args(axes_lm["mp_lm_sp"]))], tmp)
            quartet, wall4 = mp_group(torch, [dict(
                name="mp_lm_dp_sp", module="lm", argv=cli_args(axes_lm["mp_lm_dp_sp"]))],
                tmp, world=4)
            t0 = time.perf_counter()
            commit.launches = 0
            with timed_exchanges(torch, ex_ms["mp_easgd_resume"]):
                ones["mp_easgd_resume"] = run(MESH_LAUNCH_DEFAULTS.merged(
                    easgd, epochs=MP_RESUME_EPOCHS, resume=resume_file,
                    ckpt_dir=d["one_resume"], device="cuda"))
            k1s["mp_easgd_resume"] = {"k1": commit.launches}
            one_s += time.perf_counter() - t0
        finally:
            torch.backends.cudnn.deterministic = deterministic
    readings = {"pair_wall_s": wall, "one_process_s": one_s,
                "startup_s": [{k: round(pair["mp_easgd"][0][pid][k], 3) for k in (
                    "import_s", "cuda_init_s", "group_s", "compile_s")} for pid in (0, 1)]}
    for name in ("mp_easgd", "mp_easgd_resume", "mp_syncdp_linear", "mp_syncdp_cnn",
                 "mp_lm"):
        results, states = pair[name]
        one = ones[name]
        expect_child_launches(name, results, k1s[name])
        r = {"launches_each": k1s[name]}
        if name.startswith("mp_easgd"):
            want = (list(range(MP_EPOCHS)) if name == "mp_easgd"
                    else list(range(MP_EPOCHS, MP_RESUME_EPOCHS)))
            if [h["epoch"] for h in results[0]["history"]] != want:
                raise AssertionError(f"{name}: epochs {epochs_of(results[0])}, want {want}")
            per_step = 4 * easgd["batch"]
            r.update(bit_for_bit=exact,
                     max_abs_gaps=mp_hold_rows(torch, name, results, states, one, exact),
                     step_ms={"one": step_ms(one, per_step),
                              "pair": [step_ms(x, per_step) for x in results]},
                     exchange_ms={"one": ex_ms[name],
                                  "pair": [x["exchange_ms"] for x in results]},
                     # every process's sug rows, float32: the whole (dp, plong)
                     exchange_bytes_gathered=4 * easgd["dp"] * one["state"]["center"].numel())
            steps = one["samples_trained"] // per_step
        elif name.startswith("mp_syncdp"):
            if epochs_of(results[0]) != epochs_of(results[1]) or any(
                    not torch.equal(states[0][k], states[1][k]) for k in states[0]):
                raise AssertionError(f"{name}: the two processes' replicas differ")
            w_gap = float((states[0]["w"] - one["state"]["w"].cpu()).abs().max())
            if name == "mp_syncdp_cnn":
                same = epochs_of(results[0]) == epochs_of(one) and w_gap == 0.0
                whole = ones["mp_syncdp_cnn_whole"]
                r.update(bit_for_bit_half_batches=same, whole_batch={
                    "epochs": epochs_of(whole),
                    "w_max_abs_gap": float((states[0]["w"] - whole["state"]["w"].cpu())
                                           .abs().max())})
                if not same:
                    raise AssertionError(f"{name}: the pair {epochs_of(results[0])} is not "
                                         f"the one-process half-batch run {epochs_of(one)}")
            else:
                for (e, lp, tp), (_, lo, to) in zip(epochs_of(results[0]), epochs_of(one)):
                    if abs(lp - lo) > MP_LOSS_RTOL * abs(lo) or abs(tp - to) > (
                            1.0 / N_TEST + 1e-7):
                        raise AssertionError(f"{name}: epoch {e} ({lp}, {tp}) against one "
                                             f"process's ({lo}, {to})")
            r.update(w_max_abs_gap=w_gap, epochs={"one": epochs_of(one),
                                                  "pair": epochs_of(results[0])},
                     step_ms={"one": step_ms(one, MP_SYNCDP["batch"]),
                              "pair": [step_ms(x, MP_SYNCDP["batch"]) for x in results]})
            steps = one["samples_trained"] // MP_SYNCDP["batch"]
        else:
            losses = [[h["avg_loss"] for h in x["history"]] for x in (*results, one)]
            if losses[0] != losses[1]:
                raise AssertionError(f"mp_lm: the processes' losses differ: {losses}")
            cfg = LM_LAUNCH_DEFAULTS
            w0 = flatten_module(TinyDecoder(vocab=256, d_model=cfg.d_model,
                                            n_heads=cfg.n_heads, n_layers=cfg.n_layers,
                                            max_len=cfg.seq_len), cfg.seed).w0
            lim = LM_LIMITS["float32"]
            gaps, held = lm_state_gaps(torch, states[0], {
                key: one["state"][key].cpu() for key in ("w", "vt")}, w0, lim)
            r.update(gaps)
            if not held:
                raise AssertionError(f"mp_lm: beyond LM_LIMITS['float32']: {r}")
            r["loss_rel_gap"] = max(abs(a - b) / abs(b) for a, b in zip(losses[0], losses[2]))
            if not r["loss_rel_gap"] <= lim["loss_rtol"]:
                raise AssertionError(f"mp_lm: losses {losses[0]} against {losses[2]}")
            r.update(tokens_per_sec={"one": one["tokens_per_sec"],
                                     "pair": [x["tokens_per_sec"] for x in results]},
                     schedule=lm_rec["schedule"])
            steps = MP_LM_STEPS
        readings[name] = r
        for pid, res in enumerate(results):
            record_path(all_paths, f"{name}_p{pid}", res["launches"], steps)
        record_path(all_paths, f"{name}_one", k1s[name], steps)
    readings["quartet_wall_s"] = wall4
    readings["mp_shard"] = mp_shard_readings(torch, pair["mp_shard"], ones["mp_shard"],
                                             k1s["mp_shard"], ex_ms["mp_shard"], shard_kw)
    record_mp(all_paths, "mp_shard", pair["mp_shard"][0], k1s["mp_shard"],
              ones["mp_shard"]["samples_trained"] // shard_kw["batch"])
    for name, group, lim in (("mp_lm_sp", pair, "bfloat16"),
                             ("mp_lm_dp_sp", quartet, "float32")):
        cfg = LM_LAUNCH_DEFAULTS.merged(axes_lm[name])
        readings[name] = mp_lm_axes_readings(torch, name, group[name], ones[name],
                                             axes_recs[name], cfg, lim)
        record_mp(all_paths, name, group[name][0], axes_recs[name]["launches"], cfg.steps)
    print(f"multiproc phases on {smi}: " + json.dumps(readings))
    print(f"multiproc phases: {time.perf_counter() - t_block:.1f}s (the pair "
          f"{wall:.1f}s, the quartet {wall4:.1f}s, one process {one_s:.1f}s)")


def record_mp(all_paths, name, results, one_launches, steps):
    """Every child's launches and the one-process run's, as paths."""
    for pid, res in enumerate(results):
        record_path(all_paths, f"{name}_p{pid}", res["launches"], steps)
    record_path(all_paths, f"{name}_one", one_launches, steps)


def mp_shard_readings(torch, group, one, k1_one, ex_ms_one, kw):
    """``mp_shard``: the flagship CNN's EASGD at ``--dp 1 --shard 2`` over two
    processes, each holding the one worker row and owning one of the
    center's two shards, against one process at ``--dp 1 --shard 2``: each
    process's row, the center and every epoch within K1's tolerances (bit
    for bit printed), K1 launched by each as often as by one process, and
    each exchange (a push to the owned shard, the owner's add, the pull of
    the other shard) timed."""
    results, states = group
    expect_child_launches("mp_shard", results, k1_one)
    epochs = [h["epoch"] for h in results[0]["history"]]
    if epochs != list(range(MP_SHARD_EPOCHS)):
        raise AssertionError(f"mp_shard: epochs {epochs}")
    gaps = mp_hold_rows(torch, "mp_shard", results, states, one, False,
                        rows_of=lambda pid: slice(0, 1))
    per_step = kw["batch"]
    plong = one["state"]["center"].numel()
    return {"launches_each": k1_one, "max_abs_gaps": gaps,
            "bit_for_bit": all(torch.equal(st[k], one["state"][k].cpu()) for st in states
                               for k in st),
            "step_ms": {"one": step_ms(one, per_step),
                        "pair": [step_ms(x, per_step) for x in results]},
            "exchange_ms": {"one": ex_ms_one, "pair": [x["exchange_ms"] for x in results]},
            # each process pulls the other's shard of the center, float32
            "exchange_bytes_pulled": 4 * (plong - plong // 2)}


def mp_lm_axes_readings(torch, name, group, one, rec, cfg, lim_key):
    """An LM run whose ``sp`` spans processes (one ``sp`` rank each) against
    the same flags in one process: every process's K4 and pair backward
    launches its share of the ring's pairs (``ring_share``), the shares of
    an ``sp`` line adding up to the one-process count, K1 once a step;
    every replica alike; w, vt and the losses within
    ``LM_LIMITS[lim_key]`` of one process (bit for bit printed); each
    hop's path, and its ms and bytes a step (the warm-up's step counted)."""
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.transformer import TinyDecoder
    from mpit_tpu_torch.parallel.ring_attention import ring_pairs

    results, states = group
    runs, sp = cfg.steps + 1, int(cfg.sp)
    one_l = {k: rec["launches"].get(k, 0) for k in ("k1", "k4", "k5", "k6")}
    share = ring_share(cfg, 1)
    want = {k: v if k == "k1" else v // ring_pairs(sp, cfg.layout) * share
            for k, v in one_l.items()}
    expect_child_launches(name, results, want)
    for k in ("k4", "k5", "k6"):
        if sum(r["launches"].get(k, 0) for r in results[:sp]) != one_l[k]:
            raise AssertionError(f"{name}: the sp line's {k} launches "
                                 f"{[r['launches'] for r in results[:sp]]} do not add up to "
                                 f"one process's {one_l[k]}")
    losses = [[h["avg_loss"] for h in x["history"]] for x in (*results, one)]
    if any(x != losses[0] for x in losses[1:-1]) or any(
            not torch.equal(st[k], states[0][k]) for st in states[1:] for k in st):
        raise AssertionError(f"{name}: the processes' replicas differ: {losses}")
    w0 = flatten_module(TinyDecoder(vocab=256, d_model=cfg.d_model, n_heads=cfg.n_heads,
                                    n_layers=cfg.n_layers, max_len=cfg.seq_len), cfg.seed).w0
    lim = LM_LIMITS[lim_key]
    r, held = lm_state_gaps(torch, states[0], one["state"], w0, lim)
    r["loss_rel_gap"] = max(abs(a - b) / abs(b) for a, b in zip(losses[0], losses[-1]))
    r["losses"] = {"one": losses[-1], "group": losses[0]}
    if not (held and r["loss_rel_gap"] <= lim["loss_rtol"]):
        raise AssertionError(f"{name}: beyond LM_LIMITS[{lim_key!r}]: {r}")
    paths = {p for x in results for _, _, p in x["hops"]}
    if paths != {"host"}:
        raise AssertionError(f"{name}: a gloo group's hops went by {paths}")
    r.update(launches_each=want, launches_one=one_l, schedule=rec["schedule"],
             hop_path="gloo send/recv of host copies of the boundary blocks",
             hops_a_step=[len(x["hops"]) / runs for x in results],
             hop_ms_a_step=[sum(h[0] for h in x["hops"]) / runs for x in results],
             hop_bytes_a_step=[sum(h[1] for h in x["hops"]) / runs for x in results],
             tokens_per_sec={"one": one["tokens_per_sec"],
                             "group": [x["tokens_per_sec"] for x in results]},
             startup_s=[{k: round(x[k], 3) for k in ("import_s", "cuda_init_s", "group_s",
                                                     "compile_s")} for x in results])
    return r


# -- hierarchical aggregation and the LM through the gang (slices 5g and 7b) -------

#: lockstep rounds of the aggregation gangs
AGG_ROUNDS = 8
#: the two colocated groups of the aggregation gang's four clients (ranks 2-5)
AGG_GROUPS = ((2, 3), (4, 5))
#: the REDUCE hop's chunk (9 chunks of the flagship vector)
AGG_CHUNK_BYTES = 262144
#: the straggler wall of the in-process gangs: faults must not pass for stragglers
AGG_DEADLINE_S = 30.0
#: the LM gangs' widths: ``lm_default``'s model (d 256, 8 heads of 32, 2 layers,
#: context 1,024, batch 8), 1,971,200 floats
LM_GANG = dict(d_model=256, n_heads=8, n_layers=2, seq_len=1024, batch=8)
LM_GANG_PARAMS = 1_971_200
#: lm_gang_adam_vs_cpu's per-element limit, as a share of the largest change
#: (LM_LIMITS["float32"] holds the norm and the losses).  LM_LIMITS's 1e-6
#: absolute assumes a step proportional to the gradient.  Adam's first step is
#: ``lr * g / (|g| + eps')`` with ``eps' = eps / sqrt(1 - beta2)`` (3.2e-7): about
#: lr whatever |g|, but with slope ``lr / eps'`` (3,162 at lr 1e-3) near g = 0,
#: so a gradient gap of summation order far below 1e-6 moves a near-zero element
#: by more (``adam_first_step`` shows it every run: on an H100, 5.14e-6 from a
#: 1.74e-9 gradient gap at |g| 9.7e-9; PERF.md).  A dropped or doubled step is a
#: third of the change.
LM_GANG_ADAM_MAX_ABS_SHARE = 2.0**-7


#: unique group-plane namespaces of this process's aggregation gangs
_AGG_SEQ = itertools.count(1)


def agg_gang(nclients, codec, agg_cfg, faulty=False):
    """2 Adam servers (ranks 0, 1, lr 1e-3) on the card and ``nclients``
    ``AggClient``s (ranks 2..) over one in-process router, every group plane
    on the card; with ``faulty`` each client's endpoint drops every 3rd and
    duplicates every 4th REDUCE frame and ack it sends.  Returns (servers,
    clients, threads)."""
    import threading

    from mpit_tpu_torch.agg import AggClient, AggConfig
    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.ft import FaultPlan, FaultyTransport, FTConfig
    from mpit_tpu_torch.optim import rules
    from mpit_tpu_torch.ps import ParamClient, ParamServer, tags

    router = LocalRouter(2 + nclients)
    cranks = list(range(2, 2 + nclients))
    servers = [ParamServer(r, cranks, router.endpoint(r), rule=rules.make("adam", lr=1e-3),
                           device=GANG_BASE["device"], ft=FTConfig(rejoin=True))
               for r in (0, 1)]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    namespace = f"agg{os.getpid()}_{next(_AGG_SEQ)}"
    clients = []
    for i, r in enumerate(cranks):
        ep = router.endpoint(r)
        if faulty:
            ep = FaultyTransport(ep, FaultPlan(seed=i, drop_every=3, dup_every=4,
                                               tags=frozenset({tags.REDUCE, tags.REDUCE_ACK})))
        pc = ParamClient(r, [0, 1], ep, seed_servers=(i == 0), codec=codec,
                         ft=FTConfig(**FT_FAST))
        clients.append(AggClient(pc, cranks, AggConfig(**agg_cfg), namespace=namespace,
                                 device=GANG_BASE["device"]))
    return servers, clients, threads



def agg_lockstep(torch, kernels, name, w0, gtab, codec, agg_cfg, faulty=False):
    """AGG_ROUNDS lockstep rounds of the gang's gradients ``gtab`` (clients x
    rounds x n) from per-client threads, each waiting client pumping its own
    I/O; the counters set to 0 just before and read just after.  Returns the
    servers' final params (host bytes) and the run's counts."""
    import threading

    import numpy as np

    nclients = gtab.shape[0]
    zero_counts(kernels)
    servers, clients, threads = agg_gang(nclients, codec, agg_cfg, faulty)
    mirrors = [(w0.copy() if i == 0 else np.zeros_like(w0), np.zeros_like(w0))
               for i in range(nclients)]
    lock = threading.Condition()
    arrived = [0]
    errors = {}
    round_s = []

    def barrier(c, k):
        with lock:
            arrived[0] += 1
            lock.notify_all()
        bound = time.monotonic() + 120
        while True:
            with lock:
                if arrived[0] >= k * nclients or errors:
                    return
            c.ping()
            time.sleep(0.0005)
            if time.monotonic() > bound:
                raise TimeoutError(f"{name}: lockstep barrier {k} timed out")

    def drive(i, c):
        try:
            c.start(*mirrors[i])
            barrier(c, 1)
            for r in range(AGG_ROUNDS):
                t0 = time.perf_counter()
                mirrors[i][1][:] = gtab[i, r]
                c.async_send_grad()
                c.wait()
                barrier(c, r + 2)
                if i == 0:
                    round_s.append(time.perf_counter() - t0)
        except BaseException as exc:  # noqa: BLE001 — raised below
            errors[i] = exc

    runners = [threading.Thread(target=drive, args=(i, c), daemon=True)
               for i, c in enumerate(clients)]
    for t in runners:
        t.start()
    for t in runners:
        t.join(300)
    if errors or any(t.is_alive() for t in runners):
        raise AssertionError(f"{name}: a client failed or hung: {errors}")
    torch.cuda.synchronize()
    stats = {
        "applied": [s.grads_applied for s in servers],
        "late": sum(int(c._m_late.value) for c in clients),
        "fallbacks": sum(int(c._m_fallbacks.value) for c in clients),
        "reduce_frames": sum(int(c._m_chunks.value) for c in clients),
        "reduce_bytes": sum(int(c._m_chunks.value) * c._stride for c in clients),
        "faults": sum(c.pc.transport.dropped + c.pc.transport.duplicated
                      for c in clients if faulty),
        "launches": read_counts(kernels),
        "round_ms": float(np.median(round_s)) * 1e3,
    }
    final = np.concatenate([s.param.detach().cpu().numpy() for s in servers])
    for c in clients:
        c.stop()
    for t in threads:
        t.join(60)
        if t.is_alive():
            raise AssertionError(f"{name}: a server did not stop")
    return final, stats


def agg_oracle(plan, gtab, codec_name):
    """Per round, the value the tree's root pushes: each group folded in
    ascending rank order, each child subtree round-tripped through the codec
    with its sender's error-feedback residual, folded in ascending child
    order (the numpy oracle of tests/test_torch_agg.py)."""
    import numpy as np

    from mpit_tpu_torch.comm import codec as codec_mod

    codec = codec_mod.get(codec_name)
    n = gtab.shape[2]
    idx = {r: i for i, r in enumerate(plan.cranks)}
    residual = {r: np.zeros(n, np.float32) for r in plan.cranks}

    def fold(rank, r):
        acc = gtab[idx[rank], r].copy()
        for m in plan.members(rank):
            acc += gtab[idx[m], r]
        for c in plan.children(rank):
            wire = np.zeros(codec.wire_nbytes(n), np.uint8)
            codec.encode_into(fold(c, r), wire,
                              residual=residual[c] if codec.uses_residual else None)
            dec = np.zeros(n, np.float32)
            codec.decode_into(wire, dec)
            acc += dec
        return acc

    return np.stack([[fold(plan.root, r) for r in range(gtab.shape[1])]])


def agg_lockstep_adam(torch, kernels, all_paths, smi, tmp):
    """4 clients in two colocated groups reduce through a fanin-2 tree onto 2
    Adam servers at the flagship's 544,522 floats, 8 lockstep rounds, at
    codec none (traced: ``obs analyze``'s aggregation line printed), int8,
    and int8 with REDUCE frames and acks dropped and duplicated: each run's
    server params bit for bit a flat client pushing the oracle's
    fixed-order fold; every group fold on the card bit for bit the host
    fold of the same tickets; K3 = each server's applies = 8 (no late fold,
    no fallback; flat pushes would make 32)."""
    import numpy as np

    from mpit_tpu_torch import obs
    from mpit_tpu_torch.agg import ReductionPlan
    from mpit_tpu_torch.agg import client as agg_client
    from mpit_tpu_torch.comm import codec as codec_mod
    from mpit_tpu_torch.obs import causal, trace

    n = 544_522
    rng = np.random.default_rng(15)
    w0 = rng.standard_normal(n, dtype=np.float32) * 0.1
    gtab = rng.standard_normal((4, AGG_ROUNDS, n), dtype=np.float32) * 1e-2
    tree = dict(mode="tree", groups=AGG_GROUPS, fanin=2, tree_seed=0,
                deadline_s=AGG_DEADLINE_S, chunk_bytes=AGG_CHUNK_BYTES)
    plan = ReductionPlan.build(range(2, 6), groups=AGG_GROUPS, fanin=2, seed=0)
    folds = []
    real_fold = agg_client.card_fold

    def checked_fold(out, base, tickets, device):
        # The card's fold, held bit for bit against the host fold of the
        # same tickets; its wall (the adds and the copy to the host) timed.
        if not all(t.payload.is_cuda for t in tickets) or device.type != "cuda":
            raise AssertionError("agg: a group fold left the card")
        t0 = time.perf_counter()
        real_fold(out, base, tickets, device)
        folds.append(time.perf_counter() - t0)
        host = base.copy()
        for t in tickets:
            host += t.payload.cpu().numpy()
        if out.tobytes() != host.tobytes():
            raise AssertionError("agg: the card's group fold differs from the host fold")

    runs = {}
    agg_client.card_fold = checked_fold
    try:
        for codec in ("none", "int8"):
            name = f"agg_flat_adam_{codec}"
            final, st = agg_lockstep(torch, kernels, name, w0, agg_oracle(plan, gtab, codec),
                                     codec, dict(mode="off"))
            runs[name] = (final, st)
        for codec, faulty, traced in (("none", False, True), ("int8", False, False),
                                      ("int8", True, False)):
            name = f"agg_tree_adam_{codec}" + ("_faulty" if faulty else "")
            if traced:
                obs.configure(enabled=True, reset=True)
            del folds[:]
            try:
                final, st = agg_lockstep(torch, kernels, name, w0, gtab, codec, tree, faulty)
                if traced:
                    report = causal.analyze(trace.write_rank_trace(
                        os.path.join(tmp, "agg_tree.json"), 0, role="gang"))
                    st["analyze"] = [line for line in causal.render_report(report).splitlines()
                                     if line.startswith("aggregation:")]
                    st["aggregation"] = report.get("aggregation")
            finally:
                if traced:
                    obs.configure(enabled=None, reset=True)
            st["folds"] = len(folds)
            st["fold_ms_p50"] = float(np.median(folds)) * 1e3 if folds else None
            runs[name] = (final, st)
    finally:
        agg_client.card_fold = real_fold
    wire = sum(codec_mod.get("none").wire_nbytes(s) for s in (n // 2, n - n // 2))
    for name, (final, st) in runs.items():
        tree_run = name.startswith("agg_tree")
        codec = "int8" if "int8" in name else "none"
        control = runs[f"agg_flat_adam_{codec}"][0]
        server_bytes = sum(codec_mod.get(codec).wire_nbytes(s) for s in (n // 2, n - n // 2))
        reading = {k: v for k, v in st.items() if k != "launches"}
        reading.update(launches=st["launches"],
                       reduce_bytes_per_round=st["reduce_bytes"] / AGG_ROUNDS,
                       grad_bytes_per_round_to_servers=server_bytes,
                       flat_grad_bytes_per_round=4 * server_bytes,
                       f32_vector_bytes=wire)
        print(f"{name} on {smi}: " + json.dumps(reading))
        want = AGG_ROUNDS + st["fallbacks"]
        if tree_run and (final.tobytes() != control.tobytes()):
            raise AssertionError(f"{name}: the servers' params differ from flat pushes of "
                                 f"the fixed-order fold (max gap "
                                 f"{np.abs(final - control).max()})")
        if st["applied"] != [want, want] or st["launches"]["k3"] != 2 * want:
            raise AssertionError(f"{name}: applies {st['applied']}, K3 "
                                 f"{st['launches']['k3']}; want {want} on each server")
        if tree_run and (st["late"] or st["fallbacks"]
                         or st["folds"] != 2 * AGG_ROUNDS):
            raise AssertionError(f"{name}: {st['late']} late folds, {st['fallbacks']} "
                                 f"fallbacks, {st['folds']} card folds (want "
                                 f"{2 * AGG_ROUNDS})")
        if name.endswith("_faulty") and not st["faults"]:
            raise AssertionError(f"{name}: the fault plan injected nothing")
        if name == "agg_tree_adam_none" and not (
                st["analyze"] and st["aggregation"]["rounds"] == 2 * AGG_ROUNDS):
            raise AssertionError(f"{name}: obs analyze read {st.get('aggregation')}")
        expect_launches(name, st["launches"], {"k3": 2 * want})
        record_path(all_paths, name, st["launches"], AGG_ROUNDS)
    st = runs["agg_tree_adam_none"][1]
    print(f"agg_lockstep_adam on {smi}: REDUCE bytes a round {st['reduce_bytes'] / AGG_ROUNDS:.0f}"
          f" (none), {runs['agg_tree_adam_int8'][1]['reduce_bytes'] / AGG_ROUNDS:.0f} (int8); "
          f"GRAD bytes a round to the servers {wire} against {4 * wire} flat (none); group "
          f"fold p50 {st['fold_ms_p50']:.3f} ms; round p50 {st['round_ms']:.2f} ms tree, "
          f"{runs['agg_flat_adam_none'][1]['round_ms']:.2f} ms one flat client")
    print(f"agg_lockstep_adam obs analyze: {st['analyze'][0]}")


def lm_gang_expected(nworkers, steps, evals, eval_batches=2):
    """The flash kernels' launches of ``nworkers`` LM workers at LM_GANG:
    K4 once a layer a training step and a layer an eval batch, K5 once (or
    K6 twice) a layer a training step, as the gate decides."""
    import torch

    from mpit_tpu_torch.ops.flash_attention import _use_fused_bwd

    head = LM_GANG["d_model"] // LM_GANG["n_heads"]
    shape = (LM_GANG["batch"], LM_GANG["n_heads"], LM_GANG["seq_len"], head)
    fused = _use_fused_bwd(shape, shape, head, "cuda", torch.float32)
    layers = LM_GANG["n_layers"]
    want = {"k4": layers * (steps + eval_batches * evals)}
    want["k5" if fused else "k6"] = (1 if fused else 2) * layers * steps
    return {k: nworkers * v for k, v in want.items()}


def lm_gang(torch, kernels, name, *, nworkers, weights, opt, lr, codec, chunk_bytes,
            steps, eval_every, eval_batches=2, device="cuda", seed=1):
    """One in-process LM gang at LM_GANG: len(weights) servers holding the
    plan's weighted cut under the rule of ``opt`` and ``nworkers`` LmTrainer
    threads through the aggregation tree, chunked at ``chunk_bytes``; the
    counters set to 0 just before and read just after.  Returns the workers'
    results, the plan, the wall, the servers' final params and applies, and
    the launches."""
    import threading

    import numpy as np

    from mpit_tpu_torch.agg import AggClient, AggConfig
    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.lm import LmTrainer, plan
    from mpit_tpu_torch.optim import rules
    from mpit_tpu_torch.ps import ParamClient, ParamServer
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, lm_spec_tree
    from mpit_tpu_torch.utils.config import Config

    nservers = len(weights)
    rule = opt if opt in rules.names() else "add"
    lm_plan = plan(lm_spec_tree(LAUNCH_DEFAULTS.merged(
        lm_d_model=LM_GANG["d_model"], lm_heads=LM_GANG["n_heads"],
        lm_layers=LM_GANG["n_layers"], lm_seq=LM_GANG["seq_len"])),
        nservers, rule=rule, server_weights=weights)
    zero_counts(kernels)
    router = LocalRouter(nservers + nworkers)
    cranks = list(range(nservers, nservers + nworkers))
    servers = [ParamServer(r, cranks, router.endpoint(r),
                           rule=rules.make(rule, lr=lr) if rule != "add" else "add",
                           device=device, ft=FTConfig(rejoin=True))
               for r in range(nservers)]
    sths = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in sths:
        t.start()
    ft = FTConfig(op_deadline_s=120.0, max_retries=4, backoff_base_s=0.01,
                  backoff_cap_s=0.1, chunk_bytes=chunk_bytes)
    acfg = AggConfig(mode="tree", fanin=2, tree_seed=0, deadline_s=600.0)
    namespace = f"lmgang{os.getpid()}_{next(_AGG_SEQ)}"
    tcfg = Config(d_model=LM_GANG["d_model"], n_heads=LM_GANG["n_heads"],
                  n_layers=LM_GANG["n_layers"], seq_len=LM_GANG["seq_len"],
                  batch=LM_GANG["batch"], opt=opt, lr=lr, steps=steps,
                  eval_every=eval_every, eval_batches=eval_batches, seed=seed,
                  device=device)
    trainers = []
    for i, r in enumerate(cranks):
        pc = ParamClient(r, list(range(nservers)), router.endpoint(r),
                         seed_servers=(i == 0), ft=ft, codec=codec, layout=lm_plan.layout)
        trainers.append(LmTrainer(tcfg, pclient=AggClient(pc, cranks, acfg,
                                                           namespace=namespace,
                                                           device=device), rank=r))
    results, errors = [None] * nworkers, {}

    def drive(i):
        try:
            results[i] = trainers[i].run()
        except BaseException as exc:  # noqa: BLE001 — raised below
            errors[i] = exc

    t0 = time.perf_counter()
    ths = [threading.Thread(target=drive, args=(i,), daemon=True) for i in range(nworkers)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in ths):
        raise AssertionError(f"{name}: a worker failed or hung: {errors}")
    if device == "cuda":
        torch.cuda.synchronize()
    launches = read_counts(kernels)
    for tr in trainers:
        if tr.w.device.type != device:
            raise AssertionError(f"{name}: a worker's w is on {tr.w.device}")
    for s in servers:
        s.live.stop()
    for t in sths:
        t.join(60)
        if t.is_alive():
            raise AssertionError(f"{name}: a server did not stop")
    final = np.concatenate([s.param.detach().cpu().numpy() for s in servers])
    if final.size != LM_GANG_PARAMS:
        raise AssertionError(f"{name}: the servers hold {final.size} floats")
    return {"results": results, "plan": lm_plan, "wall": wall, "final": final,
            "applied": [s.grads_applied for s in servers], "launches": launches}


def lm_gang_flagship(torch, kernels, all_paths, smi):
    """``bench_lm``'s headline at the LM's full width: 2 servers on the 3:2
    weighted cut under rmsprop, 2 workers, int8, 64 KiB chunks, the aggregation tree, 20
    steps, eval every 10: every worker's windowed loss falls, no server
    holds 75% of the footprint, K4 and K5 exact.  The servers' rmsprop at
    lr 1e-3: at this width 2e-3, 3e-3, 5e-3 and the rule's own 1e-2 raise
    the loss within 20 steps (``PERF.md``)."""
    name, steps = "lm_gang_flagship", 20
    run = lm_gang(torch, kernels, name, nworkers=2, weights=[3.0, 2.0], opt="rmsprop",
                  lr=1e-3, codec="int8", chunk_bytes=65536, steps=steps, eval_every=10)
    summary = run["plan"].summary()
    losses = [[h["avg_loss"] for h in r["history"]] for r in run["results"]]
    tokens = sum(r["tokens_total"] for r in run["results"])
    reading = {"wall_s": run["wall"], "tokens_per_s_gang": tokens / run["wall"],
               "tokens_per_s_workers": [r["tokens_per_s"] for r in run["results"]],
               "losses": losses,
               "eval_losses": [[h["eval_loss"] for h in r["history"]] for r in run["results"]],
               "plan": summary, "grads_applied": run["applied"],
               "launches": run["launches"]}
    print(f"{name} on {smi}: " + json.dumps(reading))
    if not all(math.isfinite(x) for ls in losses for x in ls) or \
            not all(ls[-1] < ls[0] for ls in losses):
        raise AssertionError(f"{name}: a worker's windowed loss did not fall: {losses}")
    if not max(summary["footprint_mb"]) < 0.75 * summary["total_footprint_mb"]:
        raise AssertionError(f"{name}: one server holds most of the state: {summary}")
    if run["applied"] != [steps, steps]:
        raise AssertionError(f"{name}: applies {run['applied']}, want {steps} a server "
                             "(one tree fold a step)")
    expect_launches(name, run["launches"], lm_gang_expected(2, steps, evals=2))
    record_path(all_paths, name, run["launches"], 2 * steps)


@contextlib.contextmanager
def first_adam_applies(box):
    """Wrap the Adam rule's K3 call (``rules.fused_adam``) so that each shard's
    first apply, keyed by the shard's length, leaves in ``box`` copies of
    what K3 read (p, g, m, v, lr_t and its keywords) and of the p it wrote.
    The real wrapper still launches and counts."""
    from mpit_tpu_torch.optim import rules

    real = rules.fused_adam

    def wrapped(p, g, m, v, lr_t, **kw):
        first = p.numel() not in box
        if first:
            box[p.numel()] = {"p0": p.clone(), "g": g.clone(), "m0": m.clone(),
                              "v0": v.clone(), "lr_t": lr_t.clone(), "kw": kw}
        out = real(p, g, m, v, lr_t, **kw)
        if first:
            box[p.numel()]["p1"] = p.clone()
        return out

    rules.fused_adam = wrapped
    try:
        yield
    finally:
        rules.fused_adam = real


def adam_first_step(torch, card, cpu):
    """Where the LM Adam gang's card-vs-CPU gap comes from, shard by shard on
    the first apply (m and v zero, ``t`` 1): the card's gradient against the
    CPU's (the largest gap, and its norm over the gradient's); K3's apply on
    the card against its twin applied on the card to the same inputs; the
    twin's rounding on the CPU against the card's on those inputs; and each
    element's step gap against Adam's slope at 0, ``lr / eps'`` with ``eps'
    = eps / sqrt(1 - beta2)``, times its gradient gap, plus four float32
    ulps of the larger of p and the step (the twins' rounding and p's).
    Returns the readings; ``adam_first_step_holds`` judges them."""
    from mpit_tpu_torch.ops.fused_update import fused_adam_reference

    out = {}
    if sorted(card) != sorted(cpu) or len(card) != 2:
        raise AssertionError(f"adam first applies: shards {sorted(card)} vs {sorted(cpu)}")
    for size in sorted(card):
        on_card = card[size]
        c = {k: (v.cpu() if hasattr(v, "cpu") else v) for k, v in on_card.items()}
        h = cpu[size]
        inputs = ("p0", "g", "m0", "v0", "lr_t")
        card_twin = fused_adam_reference(*(on_card[k] for k in inputs), **c["kw"])[0].cpu()
        cpu_twin = fused_adam_reference(*(c[k] for k in inputs), **c["kw"])[0]
        g_gap = (c["g"] - h["g"]).abs()
        step_gap = (c["p1"] - h["p1"]).abs()
        beta1, beta2 = c["kw"].get("beta1", 0.9), c["kw"].get("beta2", 0.999)
        lr = float(c["lr_t"]) * (1 - beta1) / math.sqrt(1 - beta2)
        slope = lr * math.sqrt(1 - beta2) / c["kw"].get("epsilon", 1e-8)
        scale = torch.maximum(h["p0"].abs(), torch.maximum((h["p1"] - h["p0"]).abs(),
                                                           (c["p1"] - c["p0"]).abs()))
        over = step_gap - (slope * g_gap * 1.001 + 4 * 2.0**-23 * scale)
        at, worst = int(step_gap.argmax()), int(over.argmax())
        twins_apart = cpu_twin != card_twin
        out[size] = {
            "p0_equal": torch.equal(c["p0"], h["p0"]),
            "lr_t_equal": torch.equal(c["lr_t"], h["lr_t"]),
            "grad_max_abs_gap": float(g_gap.max()),
            "grad_gap_over_norm": float(g_gap.norm() / h["g"].norm()),
            "k3_is_twin": torch.equal(c["p1"], card_twin),
            "twin_cpu_vs_card": {"elements_apart": int(twins_apart.sum()),
                                 "max_abs": float((cpu_twin - card_twin).abs().max())},
            "step_max_abs_gap": float(step_gap.max()),
            "at_max": {"g_cpu": float(h["g"][at]), "g_gap": float(g_gap[at]),
                       "slope_x_g_gap": float(slope * g_gap[at])},
            "over_slope": {"count": int((over > 0).sum()), "worst": float(over[worst])},
            "max_abs_step": float((h["p1"] - h["p0"]).abs().max()),
        }
    return out


def adam_first_step_holds(readings):
    """``adam_first_step``'s claim, shard by shard: the same p0 and lr_t,
    gradients within LM_LIMITS["float32"], K3 bit for bit its twin on the
    card, and no step gap past Adam's slope on its gradient gap."""
    lim = LM_LIMITS["float32"]
    for size, r in readings.items():
        if not (r["p0_equal"] and r["lr_t_equal"]
                and r["grad_max_abs_gap"] <= lim["max_abs_gap"]
                and r["grad_gap_over_norm"] <= lim["gap_over_change"] and r["k3_is_twin"]
                and r["over_slope"]["count"] == 0):
            raise AssertionError(f"adam first apply at a shard of {size}: the gap is not "
                                 f"Adam's slope on gradients within LM_LIMITS: {r}")


def lm_gang_adam_vs_cpu(torch, kernels, all_paths, smi):
    """One LM worker through the tree onto 2 Adam servers on the 3:2 cut,
    unchunked, codec none, 3 steps at LM_GANG (one eval batch a step), on
    the card twice and on the CPU once from the same seed (the per-element
    limit LM_GANG_ADAM_MAX_ABS_SHARE, the others LM_LIMITS["float32"]'s):
    the card runs bit for bit equal (the determinism leg of ``bench_lm``; under PyTorch's
    deterministic algorithms, as ``lm_resume``: under its defaults the LM's
    step does not repeat its bits on the card), the card's final server
    params and per-step losses within LM_LIMITS["float32"] of the CPU's,
    K3 = each server's applies, K4 and K5 exact.  The first apply on each
    shard shows where the per-element gap comes from (``adam_first_step``)."""
    import numpy as np

    from mpit_tpu_torch.lm import build

    name, steps = "lm_gang_adam_vs_cpu", 3
    kw = dict(nworkers=1, weights=[3.0, 2.0], opt="adam", lr=1e-3, codec="none",
              chunk_bytes=0, steps=steps, eval_every=1, eval_batches=1)
    first = {"cuda": {}, "cpu": {}}
    with deterministic_algorithms(torch):
        with first_adam_applies(first["cuda"]):
            runs = [lm_gang(torch, kernels, name, **kw)]
        runs.append(lm_gang(torch, kernels, name, **kw))
    for r in runs:
        if r["applied"] != [steps, steps]:
            raise AssertionError(f"{name}: applies {r['applied']}, want {steps} a server")
        expect_launches(name, r["launches"], {
            "k3": 2 * steps, **lm_gang_expected(1, steps, evals=steps, eval_batches=1)})
    if runs[0]["final"].tobytes() != runs[1]["final"].tobytes():
        raise AssertionError(f"{name}: two card runs end at different bits")
    with first_adam_applies(first["cpu"]):
        cpu = lm_gang(torch, kernels, name + "_cpu", device="cpu", **kw)
    first_step = adam_first_step(torch, first["cuda"], first["cpu"])
    print(f"{name} on {smi}: the first apply a shard, cuda vs cpu "
          + json.dumps(first_step))
    adam_first_step_holds(first_step)
    w0 = build(device="cpu", use_flash=False, seed=1,
               **{k: LM_GANG[k] for k in ("d_model", "n_heads", "n_layers", "seq_len")}
               ).flat.w0.numpy()
    gap = runs[0]["final"] - cpu["final"]
    change = cpu["final"] - w0
    losses = {dev: [h["avg_loss"] for h in run["results"][0]["history"]]
              for dev, run in (("cuda", runs[0]), ("cpu", cpu))}
    reading = {"max_abs_gap": float(np.abs(gap).max()),
               "max_abs_change": float(np.abs(change).max()),
               "gap_over_change": float(np.linalg.norm(gap) / np.linalg.norm(change)),
               "loss_rel_gap": max(abs(a - b) / abs(b)
                                   for a, b in zip(losses["cuda"], losses["cpu"])),
               "losses": losses, "wall_s": {"cuda": [r["wall"] for r in runs],
                                            "cpu": cpu["wall"]},
               "launches": runs[0]["launches"]}
    print(f"{name} on {smi}: 3 steps, cuda vs cpu " + json.dumps(reading))
    lim = LM_LIMITS["float32"]
    if not (reading["max_abs_gap"] <= LM_GANG_ADAM_MAX_ABS_SHARE * reading["max_abs_change"]
            and reading["gap_over_change"] <= lim["gap_over_change"]
            and reading["loss_rel_gap"] <= lim["loss_rtol"]):
        raise AssertionError(f"{name}: the card's run differs from the CPU's beyond "
                             f"LM_LIMITS['float32']: {reading}")
    record_path(all_paths, name, runs[0]["launches"], steps)


def lm_agg_procs(all_paths, smi):
    """The "everything at once" recipe as processes, every rank on the card:
    ``launch --np 6 --lm 1 --lm_weights 3,1,2 --opt downpour --lr 0.3
    --ft_op_deadline_s 5 --ft_chunk_bytes 65536 --codec int8 --agg tree
    --agg_fanin 2`` at LM_GANG for 10 steps (a 60 s straggler wall: six
    processes start at once).  Each child returns its own launches: K4 and
    K5 exact in every worker, none in the servers; the three workers fold
    into one GRAD a step, so each server applies 10.  Returns the seconds
    taken."""
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    name, steps = "lm_agg_procs", 10
    cfg = LAUNCH_DEFAULTS.merged(
        np=6, lm=1, lm_weights="3,1,2", opt="downpour", lr=0.3, ft_op_deadline_s=5.0,
        ft_chunk_bytes=65536, codec="int8", agg="tree", agg_fanin=2, agg_deadline_s=60.0,
        lm_d_model=LM_GANG["d_model"], lm_heads=LM_GANG["n_heads"],
        lm_layers=LM_GANG["n_layers"], lm_seq=LM_GANG["seq_len"], batch=LM_GANG["batch"],
        lm_steps=steps, device="cuda")
    t0 = time.perf_counter()
    results = launch_processes(cfg, timeout=600)
    wall = time.perf_counter() - t0
    off = {r: res["platform"] for r, res in results.items() if res["platform"] != "cuda"}
    if off:
        raise AssertionError(f"{name}: ranks off the card: {off}")
    workers = {r: res for r, res in results.items() if res["role"] == "worker"}
    servers = {r: res for r, res in results.items() if res["role"] == "server"}
    # lm_eval_every 50 > 10 steps: one eval (2 batches) after the last step
    want = lm_gang_expected(1, steps, evals=1)
    for r, res in results.items():
        expect_launches(f"{name} rank {r}", res["launches"],
                        want if res["role"] == "worker" else {})
    applied = [res["grads_applied"] for res in servers.values()]
    losses = {r: [h["avg_loss"] for h in res["history"]] for r, res in workers.items()}
    if applied != [steps] * 3 or not all(math.isfinite(x) for ls in losses.values()
                                         for x in ls):
        raise AssertionError(f"{name}: applies {applied}, losses {losses}")
    launches = {k: sum(res["launches"][k] for res in results.values())
                for k in ("k1", "k2", "k3", "k4", "k5", "k6")}
    reading = {"wall_s": wall, "grads_applied": applied, "losses": losses,
               "tokens_per_s": {r: res["tokens_per_s"] for r, res in workers.items()},
               "train_seconds": {r: res["train_seconds"] for r, res in workers.items()},
               "launches_by_rank": {r: res["launches"] for r, res in sorted(results.items())}}
    print(f"{name} on {smi}: " + json.dumps(reading))
    record_path(all_paths, name, launches, 3 * steps)
    return time.perf_counter() - t0


def ptest_agg_lm(smi):
    """``tools/torch_ptest.py``'s aggregation A/B (4 clients, 64 MB, 300 MB/s
    links, 5 rounds, codecs none and int8: flat, prereduce, tree) and its LM
    legs, at their defaults, on the card; the rows printed."""
    out = {}
    for leg, timeout in (("AGG", 300), ("LM", 300)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "tools/torch_ptest.py"], capture_output=True,
                              text=True, timeout=timeout,
                              env=dict(os.environ, **{f"MPIT_BENCH_{leg}": "only"}))
        if proc.returncode != 0:
            raise AssertionError(f"ptest {leg}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        for row in rows:
            row.pop("trajectory", None)
            print(f"ptest_{leg.lower()} on {smi}: " + json.dumps(row))
        out[leg] = (rows, time.perf_counter() - t0)
    agg = out["AGG"][0]
    if [(r["codec"], r["mode"]) for r in agg] != [
            (c, m) for c in ("none", "int8") for m in ("flat", "prereduce", "tree")]:
        raise AssertionError(f"ptest agg: unexpected rows {agg}")
    if [r["metric"] for r in out["LM"][0]] != ["lm_tokens_per_s", "lm_bitwise_determinism"]:
        raise AssertionError(f"ptest lm: unexpected rows {out['LM'][0]}")
    return {leg: s for leg, (_rows, s) in out.items()}


def agg_lm_phases(torch, kernels, all_paths, smi):
    """Slices 5g and 7b on the card: the LM process gang and, beside it,
    ptest's agg and LM legs run in the background while this process drives
    the aggregation tree's lockstep matrix and the in-process LM gangs."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        procs = pool.submit(lm_agg_procs, all_paths, smi)
        ptest = pool.submit(ptest_agg_lm, smi)
        t1 = time.perf_counter()
        agg_lockstep_adam(torch, kernels, all_paths, smi, tmp)
        t_agg = time.perf_counter() - t1
        lm_gang_flagship(torch, kernels, all_paths, smi)
        lm_gang_adam_vs_cpu(torch, kernels, all_paths, smi)
        inproc_s = time.perf_counter() - t1
        procs_s, ptest_s = procs.result(), ptest.result()
    print(f"agg and LM gang phases: {time.perf_counter() - t0:.1f}s (in-process "
          f"{inproc_s:.1f}s, of it agg_lockstep_adam {t_agg:.1f}s; beside it "
          f"lm_agg_procs {procs_s:.1f}s, and ptest agg {ptest_s['AGG']:.1f}s then lm "
          f"{ptest_s['LM']:.1f}s)")


# -- slice 4: sync-DP, checkpoint/resume and BiCNN ----------------------------

# Limits of bicnn_vs_cpu (five sgd steps of the docqa model at full width,
# card against CPU): the largest elementwise gap, and the gap's norm over
# the norm of the five steps' change.  The two differ by summation order
# (the 3,000-filter convolution, the 3,000-wide GESD and normalization
# sums, the embedding gradient's scatter), which float32 keeps near 1e-7
# relative in a gradient; five steps of momentum 0.9 at lr 0.05 carry a
# gradient into w about 13 times.  A dropped K1 launch moves the state by
# a whole step's update (about 0.025 where the clipped gradient is 0.5),
# and a wrong pick of the violating negative moves every weight of the
# towers: far past both limits.
BICNN_MAX_ABS_GAP = 1e-4
BICNN_GAP_OVER_CHANGE = 1e-3
# The docqa fixture at full width: BICNN_DEFAULTS (3,000 filters, hidden
# 200, conv width 2) over the data's 50-dim vocabulary: 1,365,250 floats.
BICNN_DOCQA = dict(docqa=True, num_filters=3000, word_hidden_dim=200, cont_conv_width=2)
BICNN_DOCQA_PARAMS = 1_365_250
# tools/torch_bicnn_scale.py's 3,000-filter configuration (embedding 300,
# conv width 3, over its 5,178-word vocabulary).
BICNN_SCALE_PARAMS = 3_416_600
# The docqa gangs' batch: the reference's 1 took 130 s for the three gangs
# on an H100 (1,021 round trips a worker), 2 took 81 s (511); 4 (256 round
# trips a worker) keeps the whole script inside its time beside the ring
# block.
BICNN_GANG_BATCH = 4


def record_path(all_paths, name, launches, steps):
    """``all_paths[kernel][name]``: each kernel's launches on the path and
    the path's steps (the readings are printed on the path's own line,
    which keeps the kernels line short)."""
    for key in all_paths:
        all_paths[key][name] = {"launches": launches.get(key, 0), "steps": steps}


def launched_paths(entries):
    """One rule for the kernels line: a kernel's ``paths`` keep only the
    paths that launched it, so a path absent there launched it 0 times.
    Returns every driven path's steps, printed on a line of their own, so
    a path that launched no kernel is told from one never driven."""
    driven = {}
    for entry in entries:
        for name, rec in entry["paths"].items():
            driven.setdefault(name, rec.get("steps"))
        entry["paths"] = {name: rec for name, rec in entry["paths"].items()
                          if rec["launches"]}
    return driven


def read_counts(kernels):
    return {key: k.launches for key, k in kernels.items()}


def zero_counts(kernels):
    for k in kernels.values():
        k.launches = 0


def mesh_syncdp(torch, commit):
    """``mesh_launch --opt syncdp`` at the flagship CNN (side 32, 544,522
    floats) with the JAX tests' sync-DP settings (lr 0.2, momentum 0.9,
    global batch 128), two epochs by the host loop and by the device loop
    (one CUDA graph for every epoch: no centre, no sync phases), under
    deterministic cuDNN: equal bits, every epoch and the final state.
    K1 counted as ``device_loop_run`` counts it (sync-DP's precompile runs
    one warm-up step); on the device loop ``torch.profiler`` reads K1's
    kernels on the card.  Returns the path entry."""
    from mpit_tpu_torch.train.mesh_launch import MESH_LAUNCH_DEFAULTS

    base = MESH_LAUNCH_DEFAULTS.merged(
        opt="syncdp", model="cnn", side=32, batch=128, lr=0.2, mom=0.9, epochs=2,
        device_stream=1, precompile=1, dp=1, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        host, host_entry = device_loop_run(torch, commit, base)
        loop, loop_entry = device_loop_run(torch, commit, base.merged(device_loop=1),
                                           on_card=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    curve = lambda r: [(h["avg_loss"], h["test_err"]) for h in r["history"]]
    reading = {"host_loop": curve(host), "device_loop": curve(loop),
               "graphs": loop_entry["graphs"], "steps": host["steps"],
               "host_samples_per_sec": host["samples_per_sec"],
               "host_epoch_s": host["train_time"] / len(host["history"]),
               "device_loop_wall_s": loop["history"][-1]["at"],
               "k1": {"host_loop": host_entry["launches"],
                      "device_loop_wrapper": loop_entry["wrapper_launches"],
                      "device_loop_card": loop_entry["card_launches"]}}
    print("mesh_syncdp: " + json.dumps(reading))
    if len(loop_entry["graphs"]) != 1:
        raise AssertionError(f"mesh_syncdp: {len(loop_entry['graphs'])} graphs, not one")
    if curve(host) != curve(loop) or any(
            not torch.equal(host["state"][k], loop["state"][k]) for k in ("w", "vt", "k")):
        raise AssertionError("mesh_syncdp: the device loop did not train bit for bit as "
                             "the host loop under deterministic cuDNN")
    if not curve(host)[1][0] < curve(host)[0][0]:
        raise AssertionError(f"mesh_syncdp: the loss did not fall: {curve(host)}")
    return {**loop_entry, "host_loop": host_entry}


def mesh_resume(torch, commit):
    """The flagship (EASGD, dp=1, ``FLAGSHIP_BENCH_KWARGS``) for two epochs
    with ``--ckpt_dir``, then ``--resume auto`` to four, against a straight
    four-epoch run, under deterministic cuDNN: every epoch and the final
    state bit for bit (the resume falls at step 22, two steps into su 10's
    schedule, which the port continues).  K1 once a step and twice for
    each run's precompile."""
    import tempfile

    from mpit_tpu_torch.train.mesh_launch import (
        FLAGSHIP_BENCH_KWARGS, MESH_LAUNCH_DEFAULTS, run)

    base = MESH_LAUNCH_DEFAULTS.merged(FLAGSHIP_BENCH_KWARGS, dp=1, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    counts = []
    try:
        torch.backends.cudnn.deterministic = True
        with tempfile.TemporaryDirectory() as ckpt:
            runs = []
            for kw in (dict(epochs=4), dict(epochs=2, ckpt_dir=ckpt),
                       dict(epochs=4, ckpt_dir=ckpt, resume="auto")):
                commit.launches = 0
                runs.append(run(base.merged(kw)))
                counts.append(commit.launches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    straight, first, resumed = runs
    curve = lambda r: [(h["epoch"], h["avg_loss"], h["test_err"]) for h in r["history"]]
    spe = straight["steps"] // 4
    reading = {"straight": curve(straight), "resumed": curve(first) + curve(resumed),
               "k1": counts, "steps": [straight["steps"], first["steps"], resumed["steps"]],
               "time_to_target": [r["time_to_target"] for r in runs],
               "resumed_at": [h["at"] for h in resumed["history"]]}
    print("mesh_resume: " + json.dumps(reading))
    if curve(first) + curve(resumed) != curve(straight) or any(
            not torch.equal(straight["state"][k], resumed["state"][k])
            for k in straight["state"]):
        raise AssertionError("mesh_resume: 2 + 2 epochs differ from the straight 4")
    want = [4 * spe + 2, 2 * spe + 2, 2 * spe + 2]
    if counts != want:
        raise AssertionError(f"mesh_resume: K1 launched {counts}, expected {want}")
    return {"launches": sum(counts), "steps": 8 * spe, "warmup_steps": 6}


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """``torch.use_deterministic_algorithms(True)`` inside the block (its
    cuBLAS check wants ``CUBLAS_WORKSPACE_CONFIG`` set), restored after."""
    was, env = torch.are_deterministic_algorithms_enabled(), os.environ.get(
        "CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def lm_resume(torch, kernels):
    """``lm_launch`` at ``LM_LAUNCH_DEFAULTS`` (d 256, 8 heads, 2 layers,
    context 1,024, batch 8): 6 steps straight against 3 steps with
    ``--ckpt_dir`` and ``--resume auto`` to 6: every step's loss and the
    final ``w``, ``vt`` and ``k`` equal.  Under PyTorch's deterministic
    algorithms: under its defaults the LM does not repeat its own bits on
    the card from the third step on (two straight runs' losses ~1e-6
    apart on an H100).  Each run's kernels counted as ``lm_path``
    counts them (its warm-up step included)."""
    import tempfile

    from mpit_tpu_torch.train.lm_launch import LM_LAUNCH_DEFAULTS, run

    base = LM_LAUNCH_DEFAULTS.merged(log_every=1, ckpt_every=3, device="cuda")
    runs, total = [], {k: 0 for k in kernels}
    with tempfile.TemporaryDirectory() as ckpt, deterministic_algorithms(torch):
        for kw, steps in ((dict(steps=6), 6), (dict(steps=3, ckpt_dir=ckpt), 3),
                          (dict(steps=6, ckpt_dir=ckpt, resume="auto"), 3)):
            cfg = base.merged(kw)
            zero_counts(kernels)
            runs.append(run(cfg))
            launches = read_counts(kernels)
            want, schedule = lm_expected(cfg, steps + 1)
            expect_launches("lm_resume", launches, want)
            total = {k: total[k] + launches[k] for k in kernels}
    straight, first, resumed = runs
    losses = lambda r: [h["avg_loss"] for h in r["history"]]
    reading = {"straight": losses(straight), "resumed": losses(first) + losses(resumed),
               "schedule": schedule, "launches": total,
               "tokens_per_sec": [r["tokens_per_sec"] for r in runs]}
    print("lm_resume: " + json.dumps(reading))
    if losses(first) + losses(resumed) != losses(straight) or any(
            not torch.equal(straight["state"][k], resumed["state"][k])
            for k in ("w", "vt", "k")):
        raise AssertionError("lm_resume: 3 + 3 steps differ from the straight 6")
    return {"launches": total, "steps": 12, "warmup_steps": 3, "schedule": schedule}


def load_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bicnn_scale(torch, kernels, smi):
    """``tools/torch_bicnn_scale.py`` at its defaults (3,000 filters,
    embedding 300, conv width 3: 3,416,600 floats; ``sgd`` lr 0.05 momentum
    0.9, batch 32, two epochs of 63 steps): K1 once a step and nothing
    else; the loss falls.  Then ten more steps under ``torch.profiler``
    (counted apart): where a step's time goes."""
    tool = load_tool("torch_bicnn_scale")
    tr, data = tool.build()
    zero_counts(kernels)
    row = tool.run(tr, data)
    launches = read_counts(kernels)
    steps = row["steps"]
    print(f"bicnn_scale on {smi}: " + json.dumps(row))
    if row["flat_params"] != BICNN_SCALE_PARAMS or row["vocab"] != 5178 or steps != 2 * 63:
        raise AssertionError(f"bicnn_scale: {row['flat_params']} floats, vocab "
                             f"{row['vocab']}, {steps} steps")
    expect_launches("bicnn_scale", launches, {"k1": steps})
    losses = row["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[1] < losses[0]):
        raise AssertionError(f"bicnn_scale: losses {losses}")
    prof = tool.profile(tr, data, 10)
    print("bicnn_scale step profile: " + json.dumps(prof))
    return {"launches": launches, "steps": steps, "examples_per_sec": row["value"],
            "epoch_seconds": row["epoch_seconds"], "eval3_warm_s": row["eval3_warm_s"],
            "step_ms_profiled": prof["step_ms"],
            "device_busy_share": prof["device_busy_share"]}


def bicnn_vs_cpu(torch, kernels):
    """Five ``sgd`` steps (lr 0.05, momentum 0.9, batch 4, 100 negatives)
    of the docqa model at full width on the card and on the CPU, from one
    ``w0`` (drawn on the CPU from the seed) and the same negatives (the
    host's draws from the seed), held to BICNN_MAX_ABS_GAP and
    BICNN_GAP_OVER_CHANGE; K1 once a step on the card."""
    import numpy as np

    from mpit_tpu_torch.train.bicnn import BICNN_DEFAULTS, BiCNNTrainer

    cfg = BICNN_DEFAULTS.merged(BICNN_DOCQA, optimization="sgd", learning_rate=0.05,
                                momentum=0.9, batch_size=4)
    finals, losses = {}, {}
    for device in ("cuda", "cpu"):
        tr = BiCNNTrainer(cfg.merged(device=device))
        w0 = tr.w.cpu().clone()
        order = np.arange(len(tr.data.train))
        zero_counts(kernels)
        losses[device] = [float(tr.step(order[4 * s:4 * s + 4])) for s in range(5)]
        if device == "cuda":
            torch.cuda.synchronize()
            launches = read_counts(kernels)
            expect_launches("bicnn_vs_cpu", launches, {"k1": 5})
        finals[device] = {"w": tr.w.cpu(), "vt": tr.optimizer.state["vt"].cpu()}
    if w0.numel() != BICNN_DOCQA_PARAMS:
        raise AssertionError(f"bicnn_vs_cpu: {w0.numel()} floats")
    readings = {"losses": losses}
    for key in ("w", "vt"):
        gap = finals["cuda"][key] - finals["cpu"][key]
        change = finals["cpu"][key] - (w0 if key == "w" else 0.0)
        readings[key] = {"max_abs_gap": float(gap.abs().max()),
                         "max_abs_change": float(change.abs().max()),
                         "gap_over_change": float(gap.norm() / change.norm())}
    print("bicnn_vs_cpu: 5 steps, cuda vs cpu " + json.dumps(readings))
    for key in ("w", "vt"):
        r = readings[key]
        if not (r["max_abs_gap"] <= BICNN_MAX_ABS_GAP
                and r["gap_over_change"] <= BICNN_GAP_OVER_CHANGE):
            raise AssertionError(f"bicnn_vs_cpu: {key} on the card differs from the "
                                 f"CPU beyond the limits: {r}")
    return {"launches": launches, "steps": 5, **{k: readings[k] for k in ("w", "vt")}}


def bicnn_shard_apply(torch, n_shard):
    """K3 bit-equal to its twin at a BiCNN Adam server's shard, and the
    server's per-GRAD apply there timed: the frame's copy to the card, then
    the adam rule with ``step_div`` 72 (step counter, lr_t, K3), as
    ``ParamServer._recv_grad`` runs it.  Launches here are checks, not a
    path's."""
    import numpy as np

    from mpit_tpu_torch.ops.fused_update import fused_adam, fused_adam_reference
    from mpit_tpu_torch.optim import rules

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    p, g, m, v = (torch.randn(n_shard, device=dev, generator=gen) for _ in range(4))
    v.abs_()
    lr_t = torch.tensor(1e-3 * math.sqrt(1 - 0.999) / (1 - 0.9), device=dev)
    want = fused_adam_reference(p, g, m, v, lr_t)
    fused_adam(p, g, m, v, lr_t)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((p, m, v), want)):
        raise AssertionError(f"K3 differs from its twin at the BiCNN shard ({n_shard})")
    rule = rules.make("adam", lr=1e-3, step_div=72)
    frame = np.random.default_rng(3).standard_normal(n_shard, dtype=np.float32)
    state = rule.init(p)
    apply_ms = time_ms(torch, lambda: rule.apply(
        p, torch.from_numpy(frame).to(dev, copy=True), state))
    copy_ms = time_ms(torch, lambda: torch.from_numpy(frame).to(dev, copy=True))
    return {"n": n_shard, "server_apply_call_ms": apply_ms, "frame_copy_call_ms": copy_ms}


def run_bicnn_gang(name, size, **kw):
    """One docqa process gang through ``bicnn_launch.launch_processes``,
    every rank on the card, one epoch: finite losses, and each child's
    K1-K3 launches summed over the gang.  Returns the results, the
    launches and the reading printed."""
    from mpit_tpu_torch.train.bicnn_launch import BICNN_LAUNCH_DEFAULTS, launch_processes

    cfg = BICNN_LAUNCH_DEFAULTS.merged(BICNN_DOCQA, np=size, epoch=1, device="cuda",
                                       batch_size=BICNN_GANG_BATCH, **kw)
    t0 = time.perf_counter()
    results = launch_processes(cfg, timeout=600)
    wall = time.perf_counter() - t0
    off = {r: v["platform"] for r, v in results.items() if v["platform"] != "cuda"}
    if off:
        raise AssertionError(f"{name}: ranks off cuda: {off}")
    workers = [v for v in results.values() if v["role"] == "worker"]
    servers = [v for v in results.values() if v["role"] == "server"]
    for v in workers:
        if not all(math.isfinite(h["avg_loss"]) for h in v["history"]):
            raise AssertionError(f"{name}: losses {v['history']}")
    launches = {k: sum(v["launches"][k] for v in results.values()) for k in ("k1", "k2", "k3")}
    steps = sum(v["steps"] for v in workers)
    batch = int(cfg.batch_size)
    reading = {
        "wall_s": wall, "worker_steps": [v["steps"] for v in workers],
        "samples_per_sec": steps * batch / wall,
        "samples_per_sec_train": steps * batch / max(v["elapsed"] for v in workers),
        "epoch_s": [v["history"][-1]["seconds"] for v in workers],
        "sync_s": [v["timers"].get("sync", 0.0) for v in workers],
        "feval_s": [v["timers"].get("feval", 0.0) for v in workers],
        "accuracy": [v["accuracy"] for v in workers],
        "grads_applied": [v["grads_applied"] for v in servers],
        "params_served": [v["params_served"] for v in servers],
        "launches": launches,
        "launches_by_rank": {r: v["launches"] for r, v in sorted(results.items())},
        "roles": {r: v["role"] for r, v in sorted(results.items())},
    }
    print(f"{name}: " + json.dumps(reading))
    return results, launches, reading


def bicnn_gangs(torch, all_paths, smi):
    """The docqa process gangs over shm, every rank on the card, one epoch
    at batch BICNN_GANG_BATCH: EAMSGD np=6 with the tester first (the JAX
    README's command; its last checkpoint read back with ``load_flat``),
    server-side Adam np=4 (K3 in the servers = 2 x the workers' steps; the
    servers' per-GRAD apply timed at their shard), adamsingle np=4 (K3 on
    the workers = their steps)."""
    import tempfile

    from mpit_tpu_torch.utils.checkpoint import load_flat

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        name = "bicnn_eamsgd_np6_tester"
        res, launches, reading = run_bicnn_gang(
            name, 6, optimization="eamsgd", testerfirst=True,
            valid_mode="additionalTester", tester_rounds=3,
            outputprefix=os.path.join(ckpt, "bicnn"))
        w, meta = load_flat(os.path.join(ckpt, "bicnn_latest.npz"))
    if reading["roles"] != {0: "tester", 1: "worker", 2: "server", 3: "worker",
                            4: "server", 5: "worker"} or len(res[0]["history"]) != 3:
        raise AssertionError(f"{name}: roles {reading['roles']}, tester {res[0]}")
    if w.shape != (BICNN_DOCQA_PARAMS,) or not np_isfinite(w) or meta["epoch"] != 2:
        raise AssertionError(f"{name}: checkpoint {w.shape}, meta {meta}")
    print(f"{name}: tester history {res[0]['history']}, checkpoint of {w.size} floats")
    expect_launches(name, launches, {})
    record_path(all_paths, name, launches, sum(reading["worker_steps"]))

    name = "bicnn_adam_np4"
    res, launches, reading = run_bicnn_gang(name, 4, optimization="adam", valid_mode="none")
    steps = sum(reading["worker_steps"])
    applied = sum(reading["grads_applied"])
    in_servers = sum(v["launches"]["k3"] for v in res.values() if v["role"] == "server")
    if not applied == in_servers == launches["k3"] == 2 * steps:
        raise AssertionError(f"{name}: K3 {in_servers} in the servers, {applied} applies, "
                             f"{steps} worker steps on 2 servers")
    expect_launches(name, launches, {"k3": applied})
    shard = bicnn_shard_apply(torch, BICNN_DOCQA_PARAMS // 2)
    print(f"{name} on {smi}: the servers' per-GRAD apply " + json.dumps(shard))
    record_path(all_paths, name, launches, steps)

    name = "bicnn_adamsingle_np4"
    res, launches, reading = run_bicnn_gang(name, 4, optimization="adamsingle",
                                            valid_mode="none")
    steps = sum(reading["worker_steps"])
    on_workers = sum(v["launches"]["k3"] for v in res.values() if v["role"] == "worker")
    if not on_workers == launches["k3"] == steps:
        raise AssertionError(f"{name}: K3 {on_workers} on the workers for {steps} steps")
    expect_launches(name, launches, {"k3": steps})
    record_path(all_paths, name, launches, steps)
    print(f"BiCNN process gangs: {time.perf_counter() - t0:.1f}s")


# -- static analysis and the sync audit (slice 8) -------------------------------------

#: flagship batch of one uncaptured MeshEASGD step in the audit
AUDIT_BATCH = 128
#: what torch.cuda's sync debug mode warns with
SYNC_WARNING = "synchronizing CUDA operation"


def analysis_lint(smi):
    """The port's analyzer over ``mpit_tpu_torch/`` on this host (it reads
    source; no device) under ``mtlint_torch.toml``: no unsuppressed finding,
    no unused baseline entry, and no stale or violated declaration or hot
    path.  Findings per rule family and the seconds printed."""
    import pathlib

    from mpit_tpu_torch import analysis
    from mpit_tpu_torch.analysis import disciplines

    root = pathlib.Path(REPO) / "mpit_tpu_torch"
    t0 = time.perf_counter()
    rep = analysis.run(root, analysis.load_config(pathlib.Path(REPO) / "mtlint_torch.toml"))
    lint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cov = disciplines.coverage_report(root)
    cov_s = time.perf_counter() - t0

    def by_family(findings):
        out = {}
        for f in findings:
            out[f.rule[:4] + "xxx"] = out.get(f.rule[:4] + "xxx", 0) + 1
        return out

    print("analysis_lint: " + json.dumps({
        "unsuppressed": by_family(rep.findings),
        "suppressed": by_family(f for f, _s in rep.suppressed),
        "unused_baseline": len(rep.unused_suppressions), "lint_s": round(lint_s, 2),
        "disciplines": {k: cov[k] for k in ("verified", "violated", "stale", "retired")},
        "disciplines_s": round(cov_s, 2), "functions": cov["functions"],
        "files": cov["files"], "card": smi}))
    if rep.findings or rep.unused_suppressions:
        raise AssertionError("analysis_lint: " + "; ".join(
            [f.render() for f in rep.findings]
            + [f"unused {s.render()}" for s in rep.unused_suppressions]))
    if cov["violated"] or cov["stale"]:
        raise AssertionError("analysis_lint: disciplines " + json.dumps(
            [r for r in cov["disciplines"] if r["status"] in ("violated", "stale")]))


@contextlib.contextmanager
def sync_mode(torch, mode):
    """``torch.cuda.set_sync_debug_mode(mode)`` inside the block, ``"default"``
    restored in a ``finally``; yields the warnings the block raised."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode("default")


def sync_detector(torch):
    """The audit's control: the mode sees a known sync (``.item()``) in
    "warn" and raises on it in "error", and it reads a pageable host-to-card
    copy as a sync.  Returns the syncs each control made."""
    import numpy as np

    x = torch.ones(1024, device="cuda")
    host = np.ones(1024, np.float32)
    with sync_mode(torch, "warn") as seen:
        x.sum().item()
    item = sum(SYNC_WARNING in str(m.message) for m in seen)
    with sync_mode(torch, "warn") as seen:
        torch.from_numpy(host).to("cuda")
    pageable = sum(SYNC_WARNING in str(m.message) for m in seen)
    raised = False
    with sync_mode(torch, "error"):
        try:
            x.sum().item()
        except RuntimeError:
            raised = True
    if not (item and pageable and raised):
        raise AssertionError(f"sync audit: the debug mode missed a known sync: "
                             f"item {item}, pageable copy {pageable}, raised {raised}")
    return {"item": item, "pageable_h2d": pageable, "error_mode_raised": raised}


def audit_call(torch, name, fn):
    """One warm call of ``fn``, one under ``set_sync_debug_mode("warn")``
    counting the syncs it makes, and one under ``"error"``, where a sync
    raises out of the script.  Returns the syncs seen (0, or it raised)."""
    fn()
    torch.cuda.synchronize()
    with sync_mode(torch, "warn") as seen:
        fn()
    syncs = [str(m.message) for m in seen if SYNC_WARNING in str(m.message)]
    if syncs:
        raise AssertionError(f"sync audit: {name} synchronized {len(syncs)} "
                             f"times: {syncs[:3]}")
    torch.cuda.synchronize()
    with sync_mode(torch, "error"):
        fn()
    torch.cuda.synchronize()
    return len(syncs)


def sync_audit(torch, kernels, all_paths, smi):
    """Every ``torchrules.HOT_PATHS`` row called on the card under the sync
    debug mode (``audit_call``), at the shapes its path gives it, inputs
    already on the card; then ``mesh_launch --device_loop 1`` at the
    flagship for two epochs, each replay of its captured epoch graphs under
    the mode (the first in "warn", the rest in "error").  First a control
    shows the mode sees a known sync.  The counters are set to 0 before the
    cases and read after (K1, K2, K3, K4 and K5 exactly as the calls, three
    a case, say), and the device loop's K1 is checked as
    ``device_loop_run`` checks it.  The server's copy of a received frame
    to the card is not audited: a pageable host-to-card copy reads as a
    sync in this mode (the control shows it), so ``HbmSlot.apply_wire`` is
    called with the frame on the card."""
    from mpit_tpu_torch.analysis.torchrules import HOT_PATHS
    from mpit_tpu_torch.comm import codec as codec_mod
    from mpit_tpu_torch.dplane.hbm import HbmSlot, PlaneConfig
    from mpit_tpu_torch.models.flat import flatten_module, value_and_grad_nll
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.optim.easgd import elastic_step
    from mpit_tpu_torch.optim.msgd import (
        MSGDConfig, msgd_commit, msgd_init, msgd_lookahead, msgd_step)
    from mpit_tpu_torch.optim.rules import adam_apply, adam_init, make as make_rule
    from mpit_tpu_torch.parallel.easgd import MeshEASGD
    from mpit_tpu_torch.parallel.mesh import make_mesh
    from mpit_tpu_torch.train.lm_launch import LM_LAUNCH_DEFAULTS, build_step
    from mpit_tpu_torch.train.mesh_launch import FLAGSHIP_BENCH_KWARGS, MESH_LAUNCH_DEFAULTS

    import numpy as np

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    mcfg_mesh = MESH_LAUNCH_DEFAULTS.merged(FLAGSHIP_BENCH_KWARGS)
    flat = flatten_module(make_model(mcfg_mesh.model, mcfg_mesh.side), mcfg_mesh.seed, dev)
    n_mesh, n_shard = flat.size, flat.size // 2

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    mcfg = MSGDConfig(lr=0.01, mom=0.9, l2wd=1e-4)
    w, g, center = randn(n_mesh), randn(n_mesh), randn(n_mesh)
    st = msgd_init(w)

    def vgf(x):
        return (x * x).sum(), 2.0 * x

    p, g3 = randn(n_shard), randn(n_shard)
    pst = adam_init(p)
    slot = HbmSlot(n_shard, make_rule("adam", lr=1e-3), config=PlaneConfig(device="cuda"))
    frame = randn(n_shard)
    int8 = codec_mod.get("int8")
    wire = np.zeros(int8.wire_nbytes(n_shard), np.uint8)
    int8.encode_into(np.random.default_rng(18).standard_normal(n_shard).astype(np.float32),
                     wire)
    parts = [torch.from_numpy(v.copy()).to(dev) for v in int8.split_wire(wire, n_shard)]

    trainer = MeshEASGD(make_mesh(dp=1, device=dev), value_and_grad_nll(flat),
                        MSGDConfig(lr=mcfg_mesh.lr, mom=mcfg_mesh.mom, l2wd=mcfg_mesh.l2wd),
                        mva=mcfg_mesh.mva or 0.9, su=2)
    mstate = trainer.init(flat.w0)
    side = mcfg_mesh.side
    xb = randn(1, AUDIT_BATCH, side * side)
    yb = torch.randint(0, 10, (1, AUDIT_BATCH), device=dev, generator=gen)

    lm_cfg = LM_LAUNCH_DEFAULTS.merged(device="cuda")
    _flat_lm, w_lm, st_lm, train_step = build_step(lm_cfg, dev)
    toks = torch.randint(0, 256, (lm_cfg.batch, lm_cfg.seq_len + 1), device=dev,
                         generator=gen)
    lm_per_call, schedule = lm_expected(lm_cfg, 1)

    # (HOT_PATHS row, label, call, launches a call)
    cases = (
        ("msgd_lookahead", "msgd_lookahead", lambda: msgd_lookahead(w, st, mcfg), {}),
        ("msgd_commit", "msgd_commit", lambda: msgd_commit(w, g, st, mcfg), {"k1": 1}),
        ("msgd_step", "msgd_step", lambda: msgd_step(vgf, w, st, mcfg), {"k1": 1}),
        ("elastic_step", "elastic_step", lambda: (
            elastic_step(w, center, 0.3, retract=True),
            elastic_step(w, center, 0.3, retract=False)), {"k2": 1}),
        ("adam_apply", "adam_apply", lambda: adam_apply(p, g3, pst, lr=1e-3), {"k3": 1}),
        ("HbmSlot.apply_wire", "HbmSlot.apply_wire[none]",
         lambda: slot.apply_wire(codec_mod.get("none"), frame), {"k3": 1}),
        ("HbmSlot.apply_wire", "HbmSlot.apply_wire[int8]",
         lambda: slot.apply_wire(int8, parts), {"k3": 1}),
        # su 2: the warm call syncs, the warn-mode call is local, the
        # error-mode call syncs again
        ("MeshEASGD.step", "MeshEASGD.step[uncaptured]",
         lambda: trainer.step(mstate, xb, yb), {"k1": 1}),
        ("build_step.train_step", "build_step.train_step[lm_default]",
         lambda: train_step(w_lm, st_lm, toks), lm_per_call),
    )
    missing = {h.qual for h in HOT_PATHS} - {row for row, *_ in cases}
    if missing:
        raise AssertionError(f"sync audit: HOT_PATHS rows without a case: {missing}")

    control = sync_detector(torch)
    zero_counts(kernels)
    t_audit = time.perf_counter()
    readings, want = {}, {}
    for _row, label, fn, per_call in cases:
        t0 = time.perf_counter()
        syncs = audit_call(torch, label, fn)
        readings[label] = {"syncs": syncs, "s": round(time.perf_counter() - t0, 3)}
        for key, n in per_call.items():
            want[key] = want.get(key, 0) + 3 * n

    case_launches = read_counts(kernels)

    # The device loop itself: mesh_launch --device_loop 1 at the flagship,
    # two epochs, every replay of its captured epoch graphs audited.
    t0 = time.perf_counter()
    loop_cfg = mcfg_mesh.merged(device_loop=1, epochs=2, device="cuda")
    replays = {"n": 0, "syncs": 0}
    replay = torch.cuda.CUDAGraph.replay

    def audited_replay(graph):
        with sync_mode(torch, "warn" if replays["n"] == 0 else "error") as seen:
            out = replay(graph)
        replays["n"] += 1
        replays["syncs"] += sum(SYNC_WARNING in str(m.message) for m in seen)
        return out

    torch.cuda.CUDAGraph.replay = audited_replay
    try:
        res, loop_entry = device_loop_run(torch, kernels["k1"], loop_cfg)
    finally:
        torch.cuda.CUDAGraph.replay = replay
    if replays["syncs"] or replays["n"] != len(res["history"]):
        raise AssertionError(f"sync audit: device loop replays {replays}")
    readings["MeshEASGD.step[device loop replay]"] = {
        "syncs": replays["syncs"], "replays": replays["n"],
        "graphs": len(loop_entry["graphs"]), "steps": res["steps"],
        "s": round(time.perf_counter() - t0, 3)}
    launches = dict(case_launches, k1=case_launches["k1"] + loop_entry["wrapper_launches"])
    audit_s = time.perf_counter() - t_audit

    finite = {nm: bool(torch.isfinite(x).all()) for nm, x in (
        ("w", w), ("p", p), ("slot", slot.param), ("mesh_w", mstate["w"]),
        ("mesh_center", mstate["center"]), ("lm_w", w_lm))}
    print("sync_audit: " + json.dumps({
        "control": control, "hot_functions": readings, "launches": launches,
        "schedule": schedule,
        "seconds": round(audit_s, 2), "not_audited": "the server's pageable "
        "host-to-card copy of a received frame (reads as a sync in this mode)",
        "card": smi}))
    if not all(finite.values()):
        raise AssertionError(f"sync audit: state not finite: {finite}")
    expect_launches("sync_audit", case_launches, want)
    for key in ("k1", "k2", "k3", "k4", "k5"):
        if not launches[key]:
            raise AssertionError(f"sync audit: {key} was not launched")
    record_path(all_paths, "sync_audit", launches, len(cases) * 3 + res["steps"])


def analysis_phases(torch, kernels, all_paths, smi):
    """Slice 8: the port's analyzer on this host, then the sync audit of
    its hot functions on the card; each part's seconds printed."""
    t0 = time.perf_counter()
    analysis_lint(smi)
    lint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sync_audit(torch, kernels, all_paths, smi)
    torch.cuda.empty_cache()
    print(f"analysis phases: {lint_s + time.perf_counter() - t0:.1f}s " + json.dumps(
        {"analysis_lint": round(lint_s, 1),
         "sync_audit": round(time.perf_counter() - t0, 1)}))


def np_isfinite(w):
    import numpy as np

    return bool(np.isfinite(w).all())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.ops import build
    from mpit_tpu_torch.ops.flash_attention import (
        flash_bwd_fused, flash_bwd_two_kernel, flash_fwd)
    from mpit_tpu_torch.ops.fused_update import fused_adam, fused_elastic, fused_nesterov_commit
    from mpit_tpu_torch.train.mesh_launch import FLAGSHIP_BENCH_KWARGS, MESH_LAUNCH_DEFAULTS
    from mpit_tpu_torch.train.trainer import TRAINER_DEFAULTS
    from mpit_tpu_torch.utils.platform import pin_float32

    pin_float32()
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    secs = build.build_all()
    for name, s in secs.items():
        print(f"build {name}: {s:.1f}s")
        print(build.library_path(name).with_suffix(".log").read_text().strip())
    # bf16 K4, K5 and K6 must run their products as wgmma (SASS HGMMA),
    # which ptxas neither serializes (note C7512) nor feeds from spills.
    tc_ops = build.tensor_ops("flash_attention_tc")
    print("tensor-core instructions: " + json.dumps(tc_ops))
    for kernel in ("fa_fwd_tc_kernel", "fa_bwd_tc_kernel", "fa_bwd_dkdv_tc_kernel",
                   "fa_bwd_dq_tc_kernel"):
        if not any(kernel in k and ops["HGMMA"] for k, ops in tc_ops.items()):
            raise AssertionError(f"{kernel} carries no HGMMA instruction")
    ptxas = build.ptxas_report("flash_attention_tc")
    print("ptxas, tensor-core kernels: " + json.dumps(ptxas))
    bad = {k: r for k, r in ptxas.items() if r["spill_bytes"] or r["serialized"]}
    if bad:
        raise AssertionError(f"ptxas spilled or serialized wgmma in: {bad}")

    # K1-K3 keep every value in registers: no spill.
    ptxas_fu = build.ptxas_report("fused_update")
    print("ptxas, fused updates: " + json.dumps(ptxas_fu))
    bad = {k: r for k, r in ptxas_fu.items() if r["spill_bytes"]}
    if bad:
        raise AssertionError(f"ptxas spilled in: {bad}")

    mesh_cfg = MESH_LAUNCH_DEFAULTS.merged(FLAGSHIP_BENCH_KWARGS)
    n_mesh = flatten_module(make_model(mesh_cfg.model, mesh_cfg.side), 1).size
    n_msgd = flatten_module(make_model(TRAINER_DEFAULTS.model, TRAINER_DEFAULTS.side), 1).size
    k1 = check_k1(torch, n_mesh, n_msgd, (BICNN_SCALE_PARAMS, BICNN_DOCQA_PARAMS))
    # The gang paths run the flagship CNN: K2 sweeps the whole vector, K3
    # a server's shard at np=4 (the first of two; the last takes the
    # remainder) and the whole vector under adam-single.
    k2 = check_k2(torch, n_mesh)
    k3 = check_k3(torch, n_mesh // 2, n_mesh,
                  (BICNN_DOCQA_PARAMS // 2, BICNN_DOCQA_PARAMS))
    check_graph_replay(torch, n_mesh, n_mesh // 2)
    paths = k1["paths"]
    paths["headline"] = headline(torch, fused_nesterov_commit)
    paths["easgd_dp4"] = easgd_dp4(torch, fused_nesterov_commit)
    paths["launch_msgd"] = launch_msgd(torch, fused_nesterov_commit)
    paths["device_loop_flagship"] = device_loop_vs_host(torch, fused_nesterov_commit)
    t_slice4 = time.perf_counter()
    paths["mesh_syncdp"] = mesh_syncdp(torch, fused_nesterov_commit)
    paths["mesh_resume"] = mesh_resume(torch, fused_nesterov_commit)
    slice4_s = time.perf_counter() - t_slice4
    k1["launches"] = paths["headline"]["launches"]

    kernels = {"k1": fused_nesterov_commit, "k2": fused_elastic, "k3": fused_adam,
               "k4": flash_fwd, "k5": flash_bwd_fused, "k6": flash_bwd_two_kernel}
    fa_errs, fa_timed = check_flash(torch)
    all_paths = {"k1": paths, "k2": k2["paths"], "k3": k3["paths"], "k4": {},
                 "k5": {}, "k6": {}}
    inproc = gang_paths(torch, kernels, all_paths)
    k3["paths"]["adam_gang_vs_cpu"] = adam_gang_vs_cpu(torch, kernels)
    gang_timing = process_gang_paths(torch, all_paths, inproc, smi)
    ft_phases(torch, kernels, all_paths, smi, gang_timing)
    obs_phases(torch, kernels, all_paths, smi)
    sc_phases(torch, kernels, all_paths, smi, gang_timing)
    serve_phases(torch, kernels, all_paths, smi)
    dplane_stream_phases(torch, kernels, all_paths, smi)
    k2["launches"] = k2["paths"]["ps_eamsgd_lr0_np4"]["launches"]
    k3["launches"] = k3["paths"]["ps_adam_np4"]["launches"]

    t_bicnn = time.perf_counter()
    rec = bicnn_scale(torch, kernels, smi)
    record_path(all_paths, "bicnn_scale", rec["launches"], rec["steps"])
    rec = bicnn_vs_cpu(torch, kernels)
    record_path(all_paths, "bicnn_vs_cpu", rec["launches"], rec["steps"])
    bicnn_gangs(torch, all_paths, smi)
    slice4_s += time.perf_counter() - t_bicnn

    t_lm = time.perf_counter()
    longcontext = lm_paths(torch, kernels, all_paths)
    # bf16 twice: under the gate's K5 and under K6, each held to the CPU.
    for attn_dtype, fused_bwd in (("float32", None), ("bfloat16", None),
                                  ("bfloat16", "0")):
        rec = lm_vs_cpu(torch, kernels, attn_dtype, fused_bwd)
        for key in kernels:  # the readings are on the path's own line
            all_paths[key][rec["name"]] = {"launches": rec["launches"][key],
                                           "steps": rec["steps"], "schedule": rec["schedule"]}
    ring_lm_phases(torch, kernels, all_paths, smi, longcontext, fa_errs)
    t_resume = time.perf_counter()
    rec = lm_resume(torch, kernels)
    record_path(all_paths, "lm_resume", rec["launches"], rec["steps"])
    slice4_s += time.perf_counter() - t_resume
    agg_lm_phases(torch, kernels, all_paths, smi)
    parallel_phases(torch, kernels, all_paths, smi)
    multiproc_phases(torch, kernels, all_paths, smi)
    analysis_phases(torch, kernels, all_paths, smi)
    k4, k5, k6 = fa_entries(fa_errs, fa_timed, all_paths)
    print(f"LM phases: {time.perf_counter() - t_lm:.1f}s")
    print(f"sync-DP, resume and BiCNN phases: {slice4_s:.1f}s")

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s")
    driven = launched_paths([k1, k2, k3, k4, k5, k6])
    print(f"paths driven ({len(driven)}, each with its steps): " + json.dumps(driven))
    line = json.dumps({"kernels": [k1, k2, k3, k4, k5, k6]})
    print(f"kernels line: {len(line)} bytes", file=sys.stderr)
    print(smi)
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
