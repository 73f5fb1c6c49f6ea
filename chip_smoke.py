#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths on one NVIDIA card and hold
its kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

The paths, each through its hand-written kernels:
- the interactive REPL, ``python -m ba_tpu_torch.runtime.main`` and its
  ``handle_command``: ``actual-order`` (no kernel at m = 1; K9 at m = 2;
  K7, K5, K4 and K3 on a signed backend), ``run-rounds`` (K1, plain; on a
  signed backend the signed pipelined engine, K7, K5, K4 and K3 in its
  last round's check) and ``scenario`` (K1, scenario), its output byte
  for byte the JAX package's;
- the signed SM(m) pipelined engine, ``pipeline_sweep(signed=True)``: the
  signed megastep (plain torch, as the reference's runs in XLA) behind
  the sign-ahead lane, which signs each window's round tables on the host
  and verifies them on the card through K7, K5, K4 and K3 (its device
  route), or on the host with a live signing pool;
- the oral OM(1) pipelined engine: ``pipeline_sweep`` (plain sweeps) and
  ``scenario_sweep`` (mutating campaigns), both through K1, the megastep
  kernel (``ba_tpu_torch/ops/csrc/megastep.cu``);
- leader failover and carry checkpoints on that engine: ``failover_sweep``
  (a kill-only campaign, one K1 scenario launch), and ``pipeline_sweep``
  / ``scenario_sweep`` writing checkpoints in the JAX package's file
  format and resuming from them, on the card and across to the CPU;
- the setup of BASELINE config #5's signed sweep (``bench.py``'s
  ``bench_sweep10k_signed``), ``setup_signed_tables``: by default it signs
  on the card in one chunk, as the reference does on its accelerator,
  through ``crypto/ed25519.sign``, that is K5' and K5
  (``sha512_modl.cu``), K4 (``treeadd.cu``), K8 (``powchain.cu``) and K6
  (``modl.cu``), then verifies the tables there through
  ``crypto/ed25519.verify``, that is K7 (``decompress.cu``), K5, K4 and
  K3 (``window_verify.cu``); its host-sign route (the reference's
  BA_TPU_SIGN_DEVICE=0 mode, two chunks, the host signing while the card
  verifies) runs beside it;
- the signed sweep's timed step (its dispatch loop) through K2, the
  sweep-step kernel (``ba_tpu_torch/ops/csrc/sweep_step.cu``);
- BASELINE config #3 (``bench.py``'s ``bench_sm1_n64_signed``): the
  per-signature verify, the batch verify ``verify_rlc`` (K7, K5, K6,
  K3''s sum ``window_mult.cu``, K4, K8), K3' alone (the ladder leg) and the
  field-multiply probe P (``fieldmul_probe.cu``), interleaved, then the
  exact SM(1) round;
- the coalesced serving batch, ``coalesced_sweep``, through K1's slot
  mode (the same source): ``bench.py``'s ``bench_serving`` requests alone
  and coalesced, and a full-width scenario cohort;
- the serving tier, ``runtime/serve.py``'s ``AgreementService`` (its
  cohorts through ``coalesced_sweep``: K1's slot mode, as CUDA graphs when
  warm, K7, K5, K4 and K3 through a signed cohort's lane, K9 at m = 2),
  with and without its SLO engine, and the REPL's ``serve``;
  ``setup_signed_tables_overlapped`` by both sign routes and both verify
  routes;
- the device tier's observability on those paths: K1's artifact records,
  the recompile explainer, the compile ledger replayed by another
  process's warmup, and a ``torch.profiler`` trace of a K1 dispatch;
- BASELINE configs #1 (``bench_om1_n4``) and #4 (``bench_n1024_m32``),
  which run no kernel: the plain OM(1) round and the collapsed SM(32);
- OM(m) by the EIG tree (``core/eig.py``), through K9, the masked
  majority (``ba_tpu_torch/ops/csrc/majority.cu``), at every resolve
  level: BASELINE config #2 (``bench_om3_n10``), ``bench_eig_n1024`` and
  the sweeps at m = 2 (the composed torch engine: K1 is OM(1) only);
- several devices: K2's sharded form ``fused_sharded_sweep_step`` (one K2
  launch a "data" shard), the mesh engine ``pipeline_sweep(mesh=)`` /
  ``scenario_sweep(mesh=)`` (the shard-mapped torch scan core, as the
  reference's mesh runs its XLA core) with checkpoints that move between
  device counts, a one-rank NCCL group, the node-sharded OM(1), EIG and
  SM protocols and the REPL's ``scenario ... mesh=N``, on meshes whose
  entries name the one card (NCCL cannot put two ranks on one GPU);
- the double-and-add scalar multiply and the field exponentiations, which
  have no production caller here or in the reference:
  ``ed25519.scalar_mult`` through K3'' (``scalar_mult.cu``) at 65 536
  lanes, and ``powchain.pow_planes`` through K8', the p - 2 chain and K8''
  (``powchain.cu``) at 131 072.

Phases, one JSON line each:
1. environment and the builds from the checkout's sources, started
   together: one nvcc a CUDA source (twelve), K1's counting build and
   the native Ed25519 signer (g++);
2. threefry and Philox4x32-10 known answers on the card, the latter
   through the very Philox rounds K2 draws from (its source's
   ``philox4x32_10``) as well as through the plain version;
3. K1 against its plain engine at B = 256, n in {1, 37, 128, 300}, R = 8,
   plain and scenario modes, random strategies / events / faulty
   leaders — every output bit-equal;
4. K1 at full width (B = 10 000, capacity 1024, n uniform in [16, 1024],
   traitors uniform in [0, n // 3] among lieutenants, leader 0 honest,
   drawn by the port's ``make_sweep_state``): ``pipeline_sweep`` 64
   rounds, 16 a dispatch, depth 2 — the OM(1) validity invariant; then
   faulty leaders in every fourth instance, instances 0-63 against the
   plain engine run on them alone;
5. ``scenario_sweep`` of examples/scenarios/colluding_coalition.json at
   the same width, instances 0-63 against the plain engine;
6. K2 against its plain version at B = 256, n in {1, 5, 8, 37, 128,
   1024}, m in {1, 3}, rounds in {1, 35}, with faulty leaders, dead
   generals, random table verdicts, and instances of 4 to 8 alive
   generals with a faulty leader and a traitor lieutenant — every
   decision bit-equal, and at n >= 4 the plain version's decisions move
   when only the seed does (the draws decided what was compared);
7. Ed25519 known answers on the card: oracle-made signatures with every
   rejection path (corrupted R, S, message or key; y >= p; a non-square
   y; x = 0 with sign 1; S >= L) verify as the oracle says, the RFC 8032
   vectors verify and the card's ``sign`` reproduces their signatures,
   ``sign`` equals the oracle's on 32 keys (the all-zero secret key
   among them), K5 equals hashlib's digest mod L on 256 random 80-byte
   messages and K5' hashlib's digest on messages of 0 to 300 bytes;
8. K7, K5, K5', K6, K4, K8 and K3 against their plain versions at S in
   {1, 37, 1024, 4096}: half real signatures, half edge values (y at
   p - 1, p and 2p - 2, the identity, x = 0 with sign 1; scalars 0, 1,
   8, 15, 16, L - 1, L, 2^256 - 1, every nibble 8, a top nibble of 8;
   K6's 512-bit values ``modl_edges``: 0, 2^512 - 1, L - 1, L, 2L,
   muladd_bytes' largest, 2^256 m for small m, kL and kL +- 1 up to the
   largest k, all ones in one word; the identity, B and [s]B with
   Z != 1) and random bytes — verdicts, scalars, digests, encodings and
   canonical point encodings bit-equal;
9. the setup at full width, ``setup_signed_tables(10 240)``, 20 480
   table signatures: first the default device-sign route (one chunk,
   warmed by a throwaway key-set; its queueing held under
   ``torch.cuda.set_sync_debug_mode("error")`` up to its one fetch on a
   second throwaway key-set) — every signature byte-equal to the native
   host signer's, every verdict True, launches K5' 1, K5 3, K4 2, K8 1,
   K6 1, K7 1, K3 1; then the host-sign route (two chunks, the host
   signing chunk c + 1 while the card verifies chunk c, warmed alike);
   then the "rlc" route (device signing, one batch check as the table
   verify, its verdict in the one fetch; sync-checked alike; launches
   K5' 1, K5 3, K4 2, K8 2, K6 5, K7 1, K3''s sum 1); then a copy with every
   7th signature corrupted (R, S or message in turn), its card verdicts,
   by the exact route and by the "rlc" route's exact fallback, equal to
   the native host verifier's on all 20 480; each route's keys, sign,
   drain and total times, the warm
   device sign and verify of the whole batch (CUDA events) and the host
   verify of the same tables;
10. the signed sweep at full width: ``bucketed_sweep_states(key(5),
   10240, 1024, 2)``, m = 3, one 480-round K2 dispatch per bucket a step,
   seeds from ``fold_in(fold_in(key(6), step), bucket)``, on the verdicts
   of phase 9's device-sign setup; as ``bench.py`` times it, one warm-up
   step, then 3 windows of 50 steps (steps r * 50 + 1 .. r * 50 + 50) —
   every one of the 10 240 x 480 x 151 decisions ATTACK (SM validity);
   agreement-rounds/s of each window by host wall clock, the best
   (``bench.py``'s reading) and the spread;
11. the sweep's rate with phase 9's setups charged at ``bench.py``'s
   horizons of 50, 100, 500 and 5000 steps, for each route (sign and
   verify on the card; sign on the host, verify on the card; sign on the
   card, batch-verify there);
12. faulty leaders in every fourth instance of the same buckets, and in
   every eighth only 4 to 8 generals alive with a traitor lieutenant:
   one 480-round dispatch per bucket against the plain version in full
   (and its CUDA-event time), the plain version's decisions moving with
   the seed, and the round-0 histogram of the few-alive instances
   against the port's ``core/sm.py`` composition (threefry draws) within
   6 sqrt(count);
13. ``verify_rlc`` known answers on the card: a valid batch accepts with
   pk_group n and 1, one flipped signature byte rejects, S >= L is
   flagged and rejects, a torsion-malleated signature (tests/
   test_crypto.py:489) is rejected by ``verify`` and accepted by the
   cofactored batch check, and rejected with S + 1;
14. K3' (per lane, 256-bit k) and its sum (the R set's 128-bit k, the
   A set's 256-bit k, either empty) and P against their plain versions
   at S in {1, 37, 4096} (k 0, 1, 8, 15, 16, L - 1, all ones, top
   nibbles 8 and 15, random; the identity, B, [s]B with Z != 1, keys) —
   encodings bit-equal;
15. config #3 at full width: ``commander_keys(64)``, n = 64, m = 1,
   65 536 verify lanes (4096 signed broadcasts tiled 16 times), 10
   variants from ``default_rng(2)``; 3 reps, each interleaving 3 timed
   calls (after a warm one) of ``verify``, ``verify_rlc(pk_group=64)``,
   K3' on the 256-bit h (the ladder leg) and P; the best rep counts,
   with the spread; every verdict True, the per-signature mask equal to
   the native verifier's on one variant; verifies/s both ways, the
   speedup, the ladder's and the probe's field multiplies a second and
   ``pct_of_ladder_rate`` as bench.py derives them, and beside it the
   same share from the port's own operation counts; the host's queueing
   and the card's time of one call of each verify; then the exact SM(1)
   ``sm_agreement`` at B = 64, n = 64 (honest leader, lieutenant 1
   faulty), 20 calls a rep, best of 3, every decision ATTACK;
16. K1's slot mode against the plain ``coalesced_megastep``
   (``coalesced_vs_plain_middle``): plain and scenario modes, B in {1, 8,
   64}, n in {4, 33, 300}, R = 5, random leaders, strategies and events,
   an all-dead row — every output bit-equal, the last round's
   majorities of every general (dead ones included);
17. ``coalesced_serving``, ``bench_serving``'s shape: 32 requests (8
   clients x 4; n = 4 at capacity 4, 32 rounds 8 a dispatch, seeds 1000 +
   i, faulty sets (2,), (), (1, 3) in turn, orders attack / retreat) run
   alone (B = 1) and as 4 cohorts of 8 — decisions, counters and
   majorities bit-equal between the legs; requests/s of each leg and the
   per-cohort walls;
18. ``coalesced_full_width``: B = 10 000 slots at capacity 1024 (the
   arrays of phase 4's kind), every slot running colluding_coalition.json
   (its planes whole on the card), slot b keyed by key(seed + b), 8
   rounds 4 a dispatch; shapes, ranges and per-slot counters checked, 64
   slots against their own B = 1 runs; the wall and slots x rounds / s;
19. BASELINE config #1 (``bench_om1_n4``): ``om1_agreement`` at B = 4 194
   304, n = 4, general 2 faulty, 30 calls a rep after a warm one, best
   of 3 reps with the spread — every decision ATTACK, needed 3 of 4;
20. BASELINE config #4 (``bench_n1024_m32``): the collapsed
   ``sm_agreement`` at B = 1, n = 1024, m = 32, the first 32 generals
   faulty, 100 rounds a call, 2 calls a rep (bench.py: 5), best of 3
   with the spread — every round's honest lieutenants agree (IC1);
21. K9 against its plain version (``majority_middle``): R in {1, 255,
   257, 70 001}, K in {1, 7, 10, 33, 128, 1024, 1025}, dense and with the
   mask shared by 3 receivers, rows with no valid responder and exact
   ties — bit-equal;
22. ``eig_middle``: the port on the card against the port on the CPU,
   bit-equal: ``eig_agreement`` at config #2's shape (B = 64, fused and
   dense), B = 4 at n = 300, m = 2 (tallies past 256), ``pipeline_sweep``
   at m = 2 (B = 64, capacity 16, 8 rounds 4 a dispatch; K9's launches
   counted there), ``scenario_sweep`` of the coalition campaign at m = 2,
   ``coalesced_sweep`` at m = 2 (each slot also against its own B = 1
   run);
23. BASELINE config #2 (``bench_om3_n10``): ``eig_agreement`` at B = 131
   072, n = 10, m = 3, generals 2, 5, 7 faulty, max_liars 3 from the
   state, one key fold_in(key(1), i) a call, 20 calls a rep after a warm
   one, best of 3 with the spread — every decision ATTACK, needed 7 of
   10; K9's launches, the peak device memory, and one call's stages
   (send, fused deepest level, its Binomial draw, the resolve levels) by
   CUDA events;
24. ``bench_eig_n1024``: B = 128, n = 1024, m = 2, generals 3 and 7
   faulty, 5 calls a rep — every decision ATTACK; bench's stage split
   (the fused level alone, its float32 product alone) and K9 alone, by
   CUDA events on device-resident inputs;
25. ``ladder_pow_known_answers``: K3'' (``ladder.scalar_mult``,
   ``ed25519.scalar_mult`` and ``scalar_mult_base``) against the oracle's
   Python arithmetic for k in {0, 1, L - 1, L, 2^256 - 1} (and 2^512 - 1)
   on the identity, B and a small-order point at 256 and 512 bits;
   ``pow_planes`` against pow(a, e, p) for a in {0, 1, p - 1, random} and
   e in {0, 1, 2, 37, (p - 5)/8, p - 2, p - 1}, every route;
26. ``ladder_pow_vs_plain_middle``: K3'' at 3 000 lanes (256-bit k), K8',
   the p - 2 chain and K8'' (a random 255-bit e and (p - 5)/8) at 4 096
   field elements against their plain versions, bit-equal;
27. ``ladder_pow_full_width``: ``ed25519.scalar_mult`` at 65 536 lanes,
   256-bit k, and ``pow_planes`` at 131 072 limbs in [-8000, 8000) with e
   = (p - 5)/8, p - 2 and (p - 1)/2, then K8'' launched directly at (p -
   5)/8, and K3' on the same points and k — launches counted; K3''
   against K3' (one group element, compared compressed), the roots,
   inverses and
   Legendre symbols checked by field identities, K8'' at (p - 5)/8 equal
   to K8'; each kernel alone by CUDA events: scalar-mults/s of K3'' and
   K3', their ratio, and the generic exponent against the chain;
28. ``failover_full_width`` (run right after phase 5): ``failover_sweep``
   at phase 4's width, R = 16, a seeded [16, 10 000, 1024] kill plane
   (each general dies with probability 0.002 a round; every leader before
   round 1): one K1 scenario launch, instances 0-63 bit-equal to the
   torch engine on the card (leaders, decisions, final state), then 3
   more calls timed (wall, CUDA events), agreement-rounds/s, the kill
   plane's bytes and the launch's bound;
29. ``checkpoint_resume_full_width``: phase 4's plain campaign with a
   checkpoint every 16 rounds into a ``{round}`` family, the two newest
   kept, resumed from round 32 with key=None, state=None; phase 5's
   coalition campaign with one every 4 rounds, resumed from round 4 —
   each tail bit-equal to the uninterrupted run, the files left on disk,
   each header's round against its stored counter, the resumed run id
   against the writer's; the bytes and host ms of each write, and the
   wall without checkpoints, with them, and of the resume;
30. ``checkpoint_cross_device``: a narrow campaign (B = 64, n = 128),
   plain and scenario, written under engine="cuda" and resumed with
   engine="torch" on the CPU, bit-equal to the card's run; then ``python
   -m ba_tpu_torch.scenario`` validates every checkpoint written (exit
   0) and refuses one with a byte of ``alive`` flipped (digest mismatch);
   the checkpoints, in ``_smoke_checkpoints/``, are removed at the end;
31. ``repl_cuda`` (run after phase 27): SURVEY.md section 3.1's script
   (``REPL_SCRIPT``) through the launcher with ``--backend cuda``,
   ``torch`` (the CPU) and ``py``: the card's stdout byte-equal to the
   CPU's and to ``REPL_GOLDEN`` (the JAX package's output), its first 24
   lines to the py oracle's (which draws its own coins after them); a
   roster of 1 000 generals (capacity 1024), every third faulty through
   ``g-state`` lines: ``actual-order attack``, ``run-rounds attack 32``
   and ``scenario`` of cascading_failover.json on the card and the CPU,
   every line equal; ``run-rounds attack 256`` alone (32 K1 dispatches
   of 8 rounds), timed, then again with every dispatch recorded and
   replayed against the plain megastep; OM(2) on a roster of 100
   (``actual-order``, ``run-rounds attack 4``; K9) card against CPU;
   ``scenario <file> <dir>/ck_{round}.npz 2`` two rounds a dispatch, each
   file validated and each one before the end resumed on the CPU's torch
   engine bit-equal to the card's run; one signed ``actual-order
   retreat`` at n = 4, the reference's quorum line; each command's wall
   and ``run-rounds``' agreement-rounds/s; then the signed session,
   ``main 4 --protocol sm --signed`` with ``run-rounds attack 8`` through
   the launcher on the card and on the CPU, every line equal but
   ``sign_ahead_s``'s value, and the same ``run-rounds`` in-process on
   the card (K7, K5, K4, K3 twice each: the lane's one pass and the last
   round's check), once more recorded; then ``serve start batch=8
   engine=cuda``, 8 requests through the cluster's service (each bit-equal
   to its run alone), ``serve stat`` and ``serve stop``, their lines the
   JAX package's; the launches join K1's, K9's and the Ed25519 kernels'
   lines (K1's REPL dispatches as ``repl_path``);
32. ``signed_pipeline_middle``: ``pipeline_sweep(signed=True)`` at B = 64,
   capacity 64 (``make_sweep_state``, every fourth leader faulty), m = 2,
   the exact relay, 6 rounds 2 a dispatch, every seventh instance's
   ATTACK signature corrupted in every round, on the card with ``pool=0``
   (the lane's device route: K7, K5, K4, K3 and nothing else launched)
   and on the CPU (the native host verifier): decisions, histograms,
   counters (``sig_rejections`` as many as were corrupted) and final
   state bit-equal; once more on the card, recorded;
33. ``signed_pipeline_full_width``: B = 10 240 at capacity 1024, m = 3,
   the collapsed relay, 16 rounds 4 a dispatch, depth 2, ``sign_seed`` 0,
   two windows a lane pass (163 840 verify lanes, VERIFY_CHUNK pieces):
   run A with ``pool=0`` (device route; 6 launches each of K7, K5, K4,
   K3), run B with the default pool signing and the card verifying (the
   same launches; every worker alive), run C ``sequential_signed_sweep`` for 4 rounds — bit-equal in
   decisions, histograms and counters (C against A's first 4 rounds);
   each run's wall and agreement-rounds/s, the lane's ``sign_ahead_s``,
   ``sign_s``, ``verify_s`` and ``pool_s``, host signatures/s, one
   dispatch of the signed megastep and of its threefry draws alone (CUDA
   events), the pool's workers and the host's cores; run A once more with
   its dispatches recorded for the kernels line;
34. ``sharded_sweep_step_full_width``: ``fused_sharded_sweep_step`` on
   phase 10's buckets, seeds and verdicts (config #5's shape) on a
   one-entry and a four-entry mesh of cuda:0, timed as phase 10 (a
   warm-up step, 3 windows of 50): K2 launched once a shard a bucket a
   step, every decision ATTACK, every step bit-equal to
   ``fused_signed_sweep_step`` at the same seed (checked in a second pass,
   counted apart), the median agreement-rounds/s beside phase 10's; then
   (``sharded_sweep_step_middle``) the four-entry mesh at phase 6's
   middle shapes (B = 256, n in {37, 1024}, 1 and 35 rounds), every shard
   launch recorded and replayed against the plain version at its index
   base (0, 64, 128, 192);
35. ``mesh_pipeline_full_width``: ``pipeline_sweep(mesh=)`` on phase 4's
   arrays (every fourth leader faulty), 8 rounds 4 a dispatch, counters
   and decisions, on one- and two-entry meshes at B = 1 000 and on a
   20-entry mesh at B = 10 000 (500 a shard, what one plain-engine call
   holds; the entries take turns), and ``scenario_sweep(mesh=)`` of the
   coalition campaign on a two-entry mesh at B = 1 000 (checkpointed
   every 4 rounds) and on the 20-entry mesh at B = 10 000: engine
   "torch", no K1 launch, decisions, leaders, histograms and counters
   bit-equal to the single-device K1 run at the same key; each run's
   wall, agreement-rounds/s, per-shard bytes and the engine's reason;
36. ``mesh_checkpoint_reshard``: phase 35's two-entry checkpoint at round
   4 has header ``shard_layout`` {"data": 2, "node": 1}, resumes on one
   device through K1, and its live carry (``[2, C]`` counters, Sharded
   planes) resumes without a mesh, each tail bit-equal to K1's run;
37. ``distributed_nccl``: ``init_distributed`` with one rank, NCCL and a
   tcp://127.0.0.1:<free port> method, ``make_global_mesh()``;
   ``sharded_sweep``, one sharded K2 step and two dispatches of
   ``pipeline_sweep(mesh=)`` at B = 64, n = 128 (counters on: an NCCL
   all-reduce a round) bit-equal to an in-process mesh of the same
   shape; the group destroyed at the end;
38. ``node_sharded``: ``om1_node_sharded`` (B = 16, n = 256),
   ``eig_node_sharded`` (n = 64, m = 2) and ``sm_node_sharded`` at config
   #4's point (n = 1 024, m = 32, collapsed) on a (1, 2) mesh of cuda:0,
   bit-equal to the same calls on a (1, 2) CPU mesh, and
   ``signed_sm_agreement_sharded`` at n = 64 (its verify through K7, K5,
   K4 and K3) equal to the CPU's; each one's wall;
39. ``repl_mesh``: ``scenario <file> mesh=1`` through ``handle_command``
   on the card prints ``REPL_MESH_GOLDEN`` (the JAX package's bytes) and
   what the command prints without ``mesh=``; ``mesh=2`` prints one
   ``scenario error:`` line naming both counts and runs nothing;
40. ``serve_bench_serving``: ``bench.py``'s ``bench_serving`` legs on the
   card at its shape (``phase_serve_bench_serving``): each request alone,
   a live ``AgreementService`` (``engine="cuda"``, K1's slot mode) whose
   every result is bit-equal to its run alone, and the deadline-storm
   drill (examples/faults/deadline_storm.json, a 50 ms stall a window, a
   queue of 4): no hung client, the queue bounded, a probe served after;
41. ``serve_full_width``: the service at max_batch 1 024, a queue of
   16 384 and 64 client threads, 4 736 requests (plain run-rounds at
   capacity 1024, coalition campaigns, signed run-rounds through the
   lane's K7, K5, K4 and K3, OM(2) through K9), a sample of 128 bit-equal
   to their runs alone; wall, requests/s, latency, cohorts, launches,
   peak memory and the share of the host's result building;
42. ``serve_warm``: a warm service (CUDA graphs of K1's slot mode for
   every cohort bucket, eager entries for the rest) with live traffic
   during its warmup; after the warm barrier no compile on the request
   path, warm dispatches, no graph fallback, every result bit-equal to a
   cold service's; cold against warm latency;
43. ``signed_setup_overlapped``: ``setup_signed_tables_overlapped(10 240)``
   in 2 and 4 chunks by each sign route and verify route after
   ``warm_signed_tables``: tables byte-equal to ``setup_signed_tables``',
   every verdict True, the timings beside phase 9's;
44. ``supervised_full_width`` (run after phase 30): ``supervised_sweep``
   on phase 4's campaign at 4 rounds a dispatch, a checkpoint every 8
   rounds into a ``{round}`` family, the two newest kept: unsupervised
   and supervised (``health_every=1``) in two A B B A pairs, bit-equal,
   16 K1 launches each, a health sample a dispatch, the walls and their
   ratio; under ``examples/faults/transient_storm.json`` (a pinned 0.1 s
   watchdog): bit-equal, one stall, one degrade, the corrupted checkpoint
   quarantined; phase 5's coalition campaign at 2 rounds a dispatch with
   a fatal retire after the round-4 checkpoint, recovered bit-equal to
   phase 5's run; a child process killed by
   ``examples/faults/midcampaign_kill.json`` at round 20 and the same
   call rerun with ``resume="auto"``, bit-equal from round 0 in one
   attempt; a real ``torch.cuda.OutOfMemoryError`` classified ``oom``;
45. ``serve_slo`` (run after phase 43): (a) ``bench.py``'s
   ``bench_serving_slo`` (``:2052``) at its shape on a warm
   ``ServeConfig(slo=<its policy>, engine="cuda")`` service, every record
   captured to a JSONL file: 4 clients x 3 requests, a tenant each, n =
   4, 16 rounds, max_batch 4, burn windows of 1 and 3 s; serve, a quiet
   gap, a burst of 120 shaped by deadline_storm.json's client plan on a
   tenant of its own, recovery and a probe — recomputed from the file:
   every ok request's five phases sum to its wall within ATTRIB_TOL_S,
   the burn alert fires and clears, a scale-up ``autoscale_signal``, the
   tenants' ok tallies, every served request bit-equal to its run alone,
   no request-path compile after the warm barrier; (b) phase 41's
   traffic (a tenant a client modulo 8) on an ``slo=True`` service: the
   engine's own final report checks every ok request's attribution and
   the tenants' tallies, the 128-request sample bit-equal to its runs
   alone, requests/s beside phase 41's (the engine's cost); both legs'
   cohorts once more, recorded, for K1's slot line;
46. ``device_obs``: with the sink, the tracer and a compile ledger on and
   the classifier reset, phase 4's campaign at 16 and then 8 rounds a
   dispatch: one ``compile`` span and one ``compiled_artifact`` record a
   signature, ``alias_bytes`` the carry's bytes (the in-place carry), K1's
   registers and spill from its ``ptxas`` report in the record, one
   ``recompile`` record naming ``rounds``; a warm service at capacity 16
   writes its signatures to the ledger, and a child process whose lattice
   holds capacity 4 only warms from that ledger and serves the same
   capacity-16 requests with no request-path compile and no warm miss,
   bit-equal; one ``obs.cuda.profile_session`` over a 16-round
   full-width dispatch, whose Chrome trace holds K1's launch and the
   ``megastep_dispatch`` range; every run bit-equal to phase 4's;
47. ``search_hunt``: (a) ``bench.py:4174``'s adversary hunt on
   ``engine="cuda"`` (population 256, capacity 16, 8 rounds, 4
   generations, seed 41, 2 findings minimized): a violation found and
   minimized, every finding bit-exact by the alone vs in-population
   oracle, the whole result equal to ``engine="torch"``, to the hunt
   resumed from its generation-2 search checkpoint and to a two-entry
   mesh of the card; campaigns/s from the steady generations; (b) full
   width, population 4 096 at capacity 1 024, 16 rounds, 2 generations:
   64 seeded candidates' rows equal their runs alone, generation 0's the
   torch engine's, the host lowering's share of the generations' wall;
   (c) the REPL's ``search gens=2`` at n = 16 prints the port's CPU lines;
48. ``fleet_serve``: (a) ``bench.py:2625``'s two legs at its shape (a
   warm one-replica fleet; a warm 3-replica fleet whose cohort home runs
   a 4 000-round checkpointing campaign and is killed mid-run, its orphan
   adopted): every client answered bit-equal, the adopted campaign equal
   to an uninterrupted run, 0 request-path compiles, every queue inside
   its bound; (b) phase 41's traffic through a warm 3-replica fleet while
   a full-width campaign (B 10 000, capacity 1 024, 64 rounds, 16 a
   dispatch) is drained to a survivor: the moved campaign equal to an
   uninterrupted run, 128 requests bit-equal alone, 0 request-path
   compiles, requests/s beside phase 41's;
49. ``fleet_trace``: ``bench.py:2424``'s shape (3 clients x 2 signed
   requests, a warm service, the sign pool live without a table cache,
   the sink a directory): from the shards, through ``obs/fleet.py``,
   every request's tree parented and within tolerance, across the pool
   workers' shards, two merges equal, 0 request-path compiles, and
   ``python -m ba_tpu_torch.obs.fleet``'s digest equal to the merge's;
50. ``lint``: (a) ``python3 -m ba_tpu_torch.analysis`` over the lint set
   (``ba_tpu_torch``, ``chip_smoke.py``, ``tests/test_torch_*.py``) in a
   subprocess: exit 0, the JSON's schema fields, SARIF 2.1.0 with the 13
   rules, 0 errors and 0 warnings, the suppressed count, and under ``-X
   importtime`` no torch, numpy or jax loaded; (b) one violation each of
   BA101, BA201, BA301, BA501 and BA603, through an import alias, seeded
   into a copy of the package (``_smoke_lint/``, git-ignored) and linted
   with ``--rules <code>``: each red with its code; (c) BA201's hazard:
   one K1 plain dispatch at B 64 updates its carry in place
   (``carry_updated_in_place``);
51. ``strategy_chain``: ``bench.py:3709``'s ``bench_megastep_ab`` shape (B
   2 048, capacity 64, 64 rounds, 8 a dispatch, depth 2, strategies 0-4,
   2 % kills, 1 % revives, 5 % strategy churn, seeds 40, 41, 42), three
   legs: ``engine="torch"`` under ``strategies.chain_impl()``, branch-free,
   and ``engine="cuda"`` (K1's scenario mode); decisions, leaders,
   histograms, counters, the final state and strategy bit-equal between
   every pair; each leg's wall, no claim; the cuda leg's dispatches
   recorded and replayed against plain (K1's scenario line,
   ``strategy_chain_path``);
then the kernels line.  For K1's plain and scenario modes and K2 it replays
the main paths' own dispatches with the same keys, inputs and rounds a
dispatch (K2's sharded form: phase 34's four-entry warm-up step, shard
by shard, against the plain version at each shard's index base).  For
K1's slot mode, the Ed25519 kernels, K3' and P it replays what the main
paths recorded (phases 17 and 18 each run once more with
their dispatches recorded, inputs copied before each dispatch; the
serving phases' cohorts once more through the service's own staging,
``AgreementService._execute``, every dispatch timed and held against
plain): each
setup route run once more with its dispatches recorded (the wrappers'
arguments and outputs, taken at their modules), and one call of each of
config #3's legs on its first inputs, one more run of phase 27's
path, of phase 31's two signed commands, of phase 32's card run and of
phase 33's run A; K9 likewise, from one more call of
config #2 and of eig_n1024 and one more m = 2 sweep; every recorded dispatch is held
against the recorded output and against its plain version, timed, and
bounded, and the dispatches replayed, times the calls of the counted
run, must equal the launches counted there.  Each line gives the
launches on the main paths (K1's plain and scenario lines add phases
28-30's, 44's, 46's and 48's campaigns to phases 4's and 5's, the
scenario line phase 51's cuda leg, by path in
``launches_by_path``; the slot line phases 45's, 46's and 48's served cohorts
and 47's hunts), the time, bound and plain time per path and per dispatch,
and the largest difference from the plain version; the Ed25519 kernels',
P's and K9's time twice: as the path launches them (``ms``, which reads
the wrapper's host cost where the kernel is shorter) and queued behind a
spin (``device_ms``, the card's own time) (K9's dispatch groups sum a
shape's dispatches and give each one's time, plain time and bound
beside; K8's, K5's, K5''s and K6's lines group
their dispatches by lane count, K8's with the 2^k - 1 chain's bound
beside its own); K1's, K2's, K3's, K3''s, K4's, K5's, K5''s, K6's,
K7's, K8's and K9's lines also name their design and
give each kernel instance's ptxas registers, spill, stack frame and
shared memory (phase 1's record), and K1's the threefry
words it drew on the card beside those the inputs need: each K1
dispatch runs once more on K1's counting build (``megastep.cu`` with
``-DBA_COUNT_DRAWS``, built in phase 1 beside the kernel; outputs
bit-equal to the kernel's), whose device counter adds one a threefry
word evaluated (the plain full-width dispatch must draw at least the
words needed and at most twice as many); then
the card's name and power limit, and ``{"ok": true, ...}`` last.  Any
failure exits non-zero before that.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import gc
import glob
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ba_tpu_torch import convert, native
from ba_tpu_torch.core import eig, om, rng, sm
from ba_tpu_torch.core.election import elect_lowest_id
from ba_tpu_torch.core.om import om1_agreement, round1_broadcast
from ba_tpu_torch.core.state import SimState, make_state
from ba_tpu_torch.core.types import ATTACK
from ba_tpu_torch.crypto import ed25519, oracle, scalar, sha512, signed
from ba_tpu_torch.crypto import field as F
from ba_tpu_torch.obs import flight
from ba_tpu_torch.obs import registry as obs_registry
from ba_tpu_torch.ops import (_build, decompress, fieldmul_probe, ladder, majority, modl,
                              powchain, scenario_step, sha512_kernel, sweep_step, treeadd)
from ba_tpu_torch.parallel import eig_parallel as eparallel
from ba_tpu_torch.parallel import mesh as pmesh
from ba_tpu_torch.parallel import multihost
from ba_tpu_torch.parallel import node_parallel as nparallel
from ba_tpu_torch.parallel import pipeline, sweep
from ba_tpu_torch.parallel import shard as pshard
from ba_tpu_torch.parallel import sm_parallel as smparallel
from ba_tpu_torch.runtime import chaos, serve, supervisor
from ba_tpu_torch.runtime.backends import TorchBackend
from ba_tpu_torch.runtime.cluster import Cluster
from ba_tpu_torch.runtime.repl import handle_command
from ba_tpu_torch.scenario import compile as scenario_compile
from ba_tpu_torch.scenario import spec as scenario_spec
from ba_tpu_torch.utils import snapshot

ROOT = os.path.dirname(os.path.abspath(__file__))
COALITION = os.path.join(ROOT, "examples", "scenarios", "colluding_coalition.json")
KERNEL_SOURCE = "ba_tpu_torch/ops/csrc/megastep.cu"
REPLACES = "ba_tpu/ops/scenario_step.py:182"
K2_SOURCE = "ba_tpu_torch/ops/csrc/sweep_step.cu"
K2_REPLACES = "ba_tpu/ops/sweep_step.py:73"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth
INT32_LANES_PER_SM = 64    # int32 add / logic / shift / IMAD results per clock per SM (sm_90)
THREEFRY_OPS = 80          # 60 mix ops, 15 key-injection ops, 4 setup, 1 output xor
PHILOX_OPS = 80            # 10 rounds x (2 IMAD.HI + 2 IMAD.LO + 2 three-way xors + 2 key adds)
RELAY_WORD_OPS = 10        # per relay round and 32-general mask word: 4 and/popc for the
                           # traitor counts, 2 and/vote for the honest flags, 4 or/and updates
CHOICE_WORD_OPS = 8        # per round and mask word: choice masks and the two popcounts
B_FULL, CAP_FULL, R_FULL, RPD_FULL = 10_000, 1024, 64, 16
B_SIGNED, M_SIGNED, ROUNDS_SIGNED = 10_240, 3, 480
STEPS_SIGNED, WINDOWS_SIGNED = 50, 3  # bench.py's iters and reps
RPD_SCEN = 4  # the coalition campaign's rounds a dispatch
CHUNK = 500
PTXAS: dict = {}  # source -> ptxas_records of its build in phase_env
R_FAIL, P_KILL = 16, 0.002  # failover_full_width: rounds, a general's death rate a round
FAIL_REPS = 3  # its timed calls after the counted one
CKPT_EVERY_PLAIN, CKPT_KEEP, CKPT_RESUME = 16, 2, 32  # the plain campaign's checkpoints
B_NARROW, N_NARROW = 64, 128  # checkpoint_cross_device's campaign
CKPT_DIR = os.path.join(ROOT, "_smoke_checkpoints")  # git-ignored; removed at the end
COUNTING_FLAGS = ("-DBA_COUNT_DRAWS",)  # K1's counting build (words_drawn)
CUDA_SOURCES = ("megastep.cu", "sweep_step.cu", "decompress.cu", "sha512_modl.cu",
                "treeadd.cu", "window_verify.cu", "modl.cu", "powchain.cu", "window_mult.cu",
                "fieldmul_probe.cu", "majority.cu", "scalar_mult.cu")
# The Ed25519 kernels and the field-multiply probe: (name, wrapper, its plain
# version, source, the TPU kernel it replaces).
ED_KERNELS = {
    "K5'": ("sha512", sha512_kernel.sha512_blocks, sha512_kernel.plain_sha512_blocks,
            "ba_tpu_torch/ops/csrc/sha512_modl.cu", "ba_tpu/ops/sha512_kernel.py:43"),
    "K5": ("sha512_modl", sha512_kernel.sha512_blocks_mod_l,
           sha512_kernel.plain_sha512_blocks_mod_l, "ba_tpu_torch/ops/csrc/sha512_modl.cu",
           "ba_tpu/ops/sha512_kernel.py:98"),
    "K4": ("fixed_base_tree", treeadd.fixed_base_fold, treeadd.plain_fixed_base_fold,
           "ba_tpu_torch/ops/csrc/treeadd.cu", "ba_tpu/ops/treeadd.py:49"),
    "K8": ("compress_inv_chain", powchain.compress, powchain.plain_compress,
           "ba_tpu_torch/ops/csrc/powchain.cu", "ba_tpu/ops/powchain.py:101"),
    "K6": ("modl", modl.reduce_mod_l_planes, modl.plain_reduce_mod_l,
           "ba_tpu_torch/ops/csrc/modl.cu", "ba_tpu/ops/modl.py:65"),
    "K7": ("decompress", decompress.decompress, decompress.plain_decompress,
           "ba_tpu_torch/ops/csrc/decompress.cu", "ba_tpu/ops/decompress.py:45"),
    "K3": ("window_verify", ladder.window_verify, ladder.plain_window_verify,
           "ba_tpu_torch/ops/csrc/window_verify.cu", "ba_tpu/ops/ladder.py:121"),
    "K3'": ("window_mult", ladder.window_mult, ladder.plain_window_mult,
            "ba_tpu_torch/ops/csrc/window_mult.cu", "ba_tpu/ops/ladder.py:113"),
    "K3' sum": ("window_mult_sum8", ladder.window_mult_sum8, ladder.plain_window_mult_sum8,
                "ba_tpu_torch/ops/csrc/window_mult.cu", "ba_tpu/ops/ladder.py:113"),
    "P": ("fieldmul_probe", fieldmul_probe.fieldmul_probe, fieldmul_probe.plain_fieldmul_probe,
          "ba_tpu_torch/ops/csrc/fieldmul_probe.cu", "bench.py:3404"),
    "K3''": ("scalar_mult_ladder", ladder.scalar_mult, ladder.plain_scalar_mult,
             "ba_tpu_torch/ops/csrc/scalar_mult.cu", "ba_tpu/ops/ladder.py:53"),
    "K8'": ("sqrt_chain", powchain.sqrt_chain, powchain.plain_sqrt_chain,
            "ba_tpu_torch/ops/csrc/powchain.cu", "ba_tpu/ops/powchain.py:94"),
    "K8 p-2": ("inv_chain", powchain.inv_chain, powchain.plain_inv_chain,
               "ba_tpu_torch/ops/csrc/powchain.cu", "ba_tpu/ops/powchain.py:101"),
    "K8''": ("pow_generic", powchain.pow_exp, powchain.plain_pow_exp,
             "ba_tpu_torch/ops/csrc/powchain.cu", "ba_tpu/ops/powchain.py:108"),
}
ED_WRAPPERS = {key: fn for key, (_, fn, *_) in ED_KERNELS.items()}
K3_DESIGN = ("signed 3-bit windows (k plus 4 in every window once a lane, the carry digit "
             "first), [1..4]P in the cached form (Y - X, Y + X, 2d T, 2 Z) in shared memory, "
             "lane-major, 20 kB a 32-lane block; additions of 8 multiplies")
WARP_DESIGN = ("; a warp whose lanes hold one point runs signed 4-bit windows on one table "
               "of [1..8]P for the warp")
K4_DESIGN = ("signed 4-bit digits recoded on the fly (S plus 8 in every window, the carry "
             "out of the top a 65th digit of weight 2^256); a table of [1..8] 16^w B in the "
             "cached form (Y - X, Y + X, 2d T) at Z = 1 as int32 limbs, 65 rows, read "
             "through the read-only path, no byte decoded, the identity for digit 0 by "
             "selects; 8 groups of 8 windows summed in window order by mixed additions of 7 "
             "multiplies, then a balanced tree of 7 complete additions; 8 / T groups a "
             "thread (a loop with a counter of pending partials) and log2 T shuffle levels, "
             "T from S (8 below 4 096 lanes, 2 below 16 384, 4 below 32 768, else 1), the "
             "same bits for every T")
K8_DESIGN = ("1/Z by Bernstein and Yang's constant-time divsteps (safegcd.cuh: 20 batches of "
             "30 branch-free divsteps on the low words, each batch's 2x2 matrix applied to "
             "(f, g) and to (d, e) mod p in 9 signed 30-bit limbs), one thread a lane, "
             "32-thread blocks; x = X / Z, y = Y / Z by two multiplies, the canonical y with "
             "x's low bit")
K7_DESIGN = ("one lane a thread, 64-thread blocks, the (p - 5)/8 chain in one serial carry "
             "chain a product; from 32 768 lanes the instance bounded to 8 blocks a SM (128 "
             "registers), below it the unbounded one (no spill)")
MODL_DESIGN = ("each lane's 64 bytes as sixteen 32-bit words by four 16-byte loads, "
               "Barrett's quotient from the products of q = x >> 252 and 2^260 - "
               "floor(2^512 / L) at columns 7 and up (20 word products), x - qL mod 2^256 "
               "(26 more), the exact fold at 2^252 and one conditional add of L; two 16-byte "
               "stores; one thread a lane, 128-thread blocks")
K5_DESIGN = ("the halves by 16-byte loads, the 80 rounds on native 64-bit words, the "
             "digest's 16 little-endian words from the state's halves by byte permutes")
K3PP_DESIGN = ("two threads a lane, adjacent in a warp, 128-thread blocks: the even one "
               "holds q, the odd one acc; each bit both take q_t from the even one by 40 "
               "__shfl_sync and run the same complete addition (9 multiplies) on (own "
               "point, q_t), kept under a mask (always for q, at a set bit for acc): one "
               "instruction stream, no divergence, one addition's chain a bit")
# The kernels whose lines name their design and carry their source's ptxas records.
ED_DESIGNS = {"K4": K4_DESIGN, "K7": K7_DESIGN, "K8": K8_DESIGN, "K6": MODL_DESIGN,
              "K5'": K5_DESIGN + ", stored as four 16-byte vectors; 32-thread blocks",
              "K5": K5_DESIGN + ", then K6's reduction (modl.cuh) on them; 128-thread blocks",
              "K3''": K3PP_DESIGN,
              "K3": K3_DESIGN + WARP_DESIGN, "K3'": K3_DESIGN + WARP_DESIGN,
              "K3' sum": K3_DESIGN + "; both sets in one launch, the 256-bit set's blocks "
              "first; warp halving sums, then a tree over the block sums climbed by the "
              "second block of each pair; times 8 by three doublings"}
# Launches of each on the device-sign setup: sign (K5', K5 twice, K4, K8, K6),
# then verify (K7, K5, K4, K3); on the "rlc" route the verify is one batch check
# (K7, K5, K6 four times, K3''s sum, K4, K8).  No setup runs the
# double-and-add ladder or pow_planes' kernels.
NO_LADDER_POW = {"K3''": 0, "K8'": 0, "K8 p-2": 0, "K8''": 0}
DEVICE_SETUP_LAUNCHES = {"K5'": 1, "K5": 3, "K4": 2, "K8": 1, "K6": 1, "K7": 1, "K3": 1,
                         "K3'": 0, "K3' sum": 0, "P": 0, **NO_LADDER_POW}
HOST_SETUP_LAUNCHES = {"K5'": 0, "K5": 2, "K4": 2, "K8": 0, "K6": 0, "K7": 2, "K3": 2,
                       "K3'": 0, "K3' sum": 0, "P": 0, **NO_LADDER_POW}
RLC_SETUP_LAUNCHES = {"K5'": 1, "K5": 3, "K4": 2, "K8": 2, "K6": 5, "K7": 1, "K3": 0,
                      "K3'": 0, "K3' sum": 1, "P": 0, **NO_LADDER_POW}
# The ladder / pow path: ed25519.scalar_mult (K3'') at 65 536 lanes with 256-bit
# scalars (the reference's reported width, ba_tpu/ops/__init__.py:7-15), and
# pow_planes' three routes at config #3's 2B = 131 072 decompression lanes, plus
# K8'' launched directly with e = (p - 5)/8 (the chain-against-generic ratio), and
# K3' on the same points and k (the random 256-bit k beside config #3's h).
S_LADDER, N_POW = 65_536, 131_072
LEGENDRE_EXP = (oracle.P - 1) // 2  # pow_planes' generic route: Euler's criterion
LADDER_POW_LAUNCHES = {**{key: 0 for key in DEVICE_SETUP_LAUNCHES},
                       "K3''": 1, "K8'": 1, "K8 p-2": 1, "K8''": 2, "K3'": 1}
# BASELINE config #3 as bench.py:194-394 (bench_sm1_n64_signed) runs it: 64
# commanders, n = 64, m = 1; 65 536 verify lanes (the signed broadcasts tiled);
# 3 reps of 3 timed calls a leg; the SM(1) round 20 calls a rep.
B_C3, N_C3, NV_C3 = 64, 64, 65_536
ITERS_C3, REPS_C3, SM1_ITERS = 3, 3, 20
FMULS_PER_VERIFY = 3.66e3  # bench.py:351's estimate of one verify's field multiplies
LADDER_FMULS_PER_LANE = 64 * 38 + 14 * 9  # bench.py:299: 38 a window, 126 a lane
FM_VARIANTS = 12  # the probe's input variants (bench.py's BA_TPU_FMUL_PROBE_VARIANTS)
# int32 operations of one field multiply in the kernels' radix (ed25519_field.cuh
# fe_mul) and of one squaring (fe_sq): the instructions each compiles to on the
# integer pipes for sm_90a, counted in the SASS by scripts/fe_sass_counts.py
# (290.5 and 173.25; a multiply of two operands that both change, as in the
# kernels; one by a loop-invariant operand compiles to 524 as 64-bit products).
# That script's loops reach 56-63 of them a clock an SM, under the 64 of
# INT32_LANES_PER_SM, which the bounds divide them by.
FE_MUL_OPS, FE_SQ_OPS = 290, 173
# (multiplies, squarings) a lane: K7 the (p-5)/8 chain (11, 251) and (9, 4)
# around it; K8 the p - 2 chain (13, 257) and x / Z, y / Z.  K3 is K3''s
# 32-byte chain and 9 + 4 to finish.  K4 the least work on its table of
# signed 4-bit windows: one chain of mixed additions over the 65 entries a
# lane reads, the first from the identity at 1 multiply, each next at 7
# (the shipped fold does 470, its tree of complete additions keeping the
# bits the same for every thread count; the first port's tree of 64
# unsigned window points 535).
K7_WORK = (20, 255)
K4_WORK = (1 + 64 * 7, 0)
K4_ENTRY_BYTES = 128  # a table entry: 30 limbs and 2 zero words
K8_WORK = (15, 257)  # the p - 2 chain's compress (the previous design): its bound stays beside
# K8's compress by divsteps: integer-pipe instructions a lane in the SASS of
# powchain.cu's compress_kernel (its instructions plus 19 more passes of its one
# loop, the batch of 30 divsteps), counted by scripts/k9k8_variants.py: the
# shipped algorithm's work, kept beside the bound.
K8_SAFEGCD_OPS = 23_950
# K8's bound, the least work of the function: 1/Z over the launch's lanes by
# Montgomery's batch inversion, one inversion a launch (K8_SAFEGCD_OPS, a
# whole lane's compress) and a lane's three multiplies of the batch, Z = 0
# masked, x / Z, y / Z and the canonical encoding: the integer-pipe
# instructions of compress_variants.cu's batch_lane_probe, counted by
# scripts/k9k8_variants.py --sass-only.
K8_BATCH_LANE_OPS = 2_748


def k8_least_ops(lanes):
    """The least int32 operations of K8's function over ``lanes`` lanes:
    a divsteps inversion a lane, or one for the launch and the batch's
    work a lane, whichever is less."""
    return min(lanes * K8_SAFEGCD_OPS, K8_SAFEGCD_OPS + lanes * K8_BATCH_LANE_OPS)
K8P_WORK, INV_WORK = (11, 251), (13, 257)  # the (p - 5)/8 and p - 2 chains alone


def field_ops(work):
    """int32 operations of (multiplies, squarings)."""
    return work[0] * FE_MUL_OPS + work[1] * FE_SQ_OPS


# K3''s per-step costs, integer-pipe instructions on the basis of every
# other Ed25519 bound here: a step's field operations at FE_MUL_OPS and
# FE_SQ_OPS, and FE_LINEAR_OPS for each fe_add, fe_sub and fe_dbl (one int32
# add or subtract a limb, ed25519_field.cuh).  q + q by squarings
# (ge_add_self, scripts/k3ppk5p_variants/ge_add_self.cuh): 5 multiplies, 4
# squarings and 7 of those; acc + q (ge_add): 9 multiplies and 9.  The
# compiled steps read more in the SASS of straight-line probes, 2d's limbs
# opaque and the probes' loads, stores and addresses taken off
# (scripts/k3ppk5p_variants.py --sass-only, k3pp_step_ops): an addition
# 2 925, a doubling by squarings 2 757, as if a multiply took ~315 and a
# squaring ~278 there; the bound counts the lesser.
FE_LINEAR_OPS = 10
K3PP_DBL_OPS = field_ops((5, 4)) + 7 * FE_LINEAR_OPS
K3PP_ADD_OPS = field_ops((9, 0)) + 9 * FE_LINEAR_OPS


def k3pp_least_ops(bits):
    """The least int32 operations of K3''s product, [k]P in the
    reference's projective coordinates (which no windowed chain returns),
    on these bits (a lane a row, least significant first): per lane q + q
    up to k's highest set bit (its index in doublings) and acc + q at the
    set bits only (popcount(k) additions); k = 0 needs none."""
    b = bits != 0
    top = torch.where(b, torch.arange(b.shape[1], device=b.device), 0).amax(dim=1)
    return int(top.sum()) * K3PP_DBL_OPS + int(b.sum()) * K3PP_ADD_OPS


def k3pp_always_add_ops(lanes, nbits):
    """A lockstep ladder's work, a doubling by squarings and an addition at
    every bit: the design note kept beside K3''s bound."""
    return lanes * nbits * (K3PP_DBL_OPS + K3PP_ADD_OPS)


def k3p_chains(nbytes):
    """(multiplies, squarings) a lane of [k]P for a k of nbytes by each
    window chain the port has run: unsigned 4-bit windows (14 additions of
    9 for the table, 2 nbytes windows of 26 multiplies and 12 squarings),
    and window.cuh's signed ones at W = 4 and W = 3 (2^(W-1) - 1 additions
    of 8 and 2^(W-1) multiplies by 2d for the table, ceil(8 nbytes / W)
    windows of W - 1 doublings of 4 and 3, one of 5 and 3, an addition of
    8; the carry digit costs a select)."""
    def signed(w):
        half, nwin = 1 << (w - 1), -(-8 * nbytes // w)
        return (9 * half - 8 + nwin * (4 * w + 1 + 8), nwin * 3 * w)
    return {"unsigned4": (14 * 9 + 26 * 2 * nbytes, 12 * 2 * nbytes),
            "signed4": signed(4), "signed3": signed(3)}


def k3p_work(nbytes):
    """The least of k3p_chains: a bound counts the least work of the
    product, so a chain that does more cannot flatter its share."""
    return min(k3p_chains(nbytes).values(), key=field_ops)


# The chain config #3's K3 and ladder leg run: each warp's lanes hold one key, so
# the warp's one table (window.cuh, WARP_WINDOW_BITS = 4)
K3P_CHAIN = "signed4"
K3_WORK = (k3p_work(32)[0] + 9 + 4, k3p_work(32)[1])


# int32 operations of one per-signature verify as the port's kernels run it: K3's
# chain (K3P_CHAIN), K4 ([S]B) and K7 for A and for R
K3P_RUN = k3p_chains(32)[K3P_CHAIN]
VERIFY_OPS = (field_ops((K3P_RUN[0] + 13, K3P_RUN[1])) + field_ops(K4_WORK)
              + 2 * field_ops(K7_WORK))
# The least work of K5's and K6's functions, integer-pipe instructions counted
# in the SASS of straight-line probe kernels by scripts/k6k5_variants.py
# --sass-only: one SHA-512 compression block (sha512_variants.cu's
# sha512_block_probe: the state and the block's words loaded, the 80 rounds,
# the state stored), and a lane of the mod-L reduction by the lesser of its two
# plans in words (modl_variants.cu's modl_probe_barrett, the shipped one, 267;
# modl_probe_fold 325: four 16-byte loads, the reduction, two 16-byte stores).
SHA_BLOCK_OPS, MODL_OPS = 3_566, 267


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


T0 = time.perf_counter()


def emit(obj):
    obj.setdefault("t_s", time.perf_counter() - T0)  # seconds since the script started
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


# -- inputs, made with numpy from the seed ------------------------------------


def random_arrays(rs, B, n, R):
    kill = rs.random((R, B, n)) < 0.1
    state = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=rs.integers(0, n, B).astype(np.int32),
        faulty=rs.random((B, n)) < 0.35,
        alive=rs.random((B, n)) < 0.85,
        ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)),
    )
    state["alive"][0] = False  # an all-dead row
    events = dict(
        kill=kill,
        revive=(rs.random((R, B, n)) < 0.1) & ~kill,
        set_faulty=np.where(rs.random((R, B, n)) < 0.2,
                            rs.integers(0, 2, (R, B, n)), -1).astype(np.int8),
        set_strategy=np.where(rs.random((R, B, n)) < 0.3,
                              rs.integers(0, 6, (R, B, n)), -1).astype(np.int8),
    )
    return state, events, rs.integers(0, 6, (B, n)).astype(np.int8)


def sweep_arrays(key, B, cap, order):
    """``make_sweep_state``'s draws (the port's, bit-exact with jax's): n
    uniform in [16, cap] (alive = the first n slots), traitors uniform
    in [0, n // 3] among lieutenants, leader 0 honest; as numpy arrays."""
    state = sweep.make_sweep_state(key, B, cap, min_n=16, order=order)
    return convert.state_to_numpy(state)


def to_state(arrays, dev):
    return convert.state_from_numpy(type("S", (), arrays), dev)


def rows_of(state: SimState, lo, hi) -> SimState:
    return SimState(*(t[lo:hi].clone() for t in state.tensors()))


def max_abs_err(pairs):
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


# -- the plain engine over a full-width dispatch, in instance chunks ----------


def plain_chunked(state, sched, rounds, counters, strategy=None, events=None):
    """One dispatch of the plain scan cores over every instance, CHUNK
    instances at a time (global instance indices fold the keys, so the
    result is the whole batch's).  Returns the kernel wrapper's outputs."""
    B = state.batch
    dev = state.device
    parts = []
    for lo in range(0, B, CHUNK):
        hi = min(B, lo + CHUNK)
        st = rows_of(state, lo, hi)
        if events is None:
            carry, (hist, dec, rows) = pipeline._pipeline_scan(
                st, sched, torch.zeros(3, dtype=torch.int32, device=dev),
                rounds=rounds, collect_decisions=True, index_base=lo)
            parts.append(dict(hist=hist, dec=dec, rows=rows, state=carry[0]))
        else:
            ev = {k: v[:, lo:hi] for k, v in events.items()}
            carry, (hist, lead, rows, dec) = pipeline._scenario_scan(
                st, sched, strategy[lo:hi], torch.zeros(5, dtype=torch.int32, device=dev),
                ev, rounds=rounds, collect_decisions=True, index_base=lo)
            parts.append(dict(hist=hist, dec=dec, rows=rows, lead=lead,
                              state=carry[0], strategy=carry[2]))
    hist = sum(p["hist"] for p in parts)
    deltas = sum(torch.diff(p["rows"], dim=0, prepend=torch.zeros_like(p["rows"][:1]))
                 for p in parts)
    deltas[:, 1] = (hist.max(dim=1).values == B).to(torch.int32)
    out = dict(
        hist=hist,
        dec=torch.cat([p["dec"] for p in parts], dim=1),
        rows=(counters + deltas.cumsum(dim=0)).to(torch.int32),
        state=SimState(*(torch.cat(ts) for ts in zip(*(p["state"].tensors() for p in parts)))),
    )
    if events is not None:
        out["lead"] = torch.cat([p["lead"] for p in parts], dim=1)
        out["strategy"] = torch.cat([p["strategy"] for p in parts])
    return out


# -- the bound ----------------------------------------------------------------


def work_counts(state, rounds, strategy=None, events=None, slot=False):
    """(threefry words, tally steps): what these inputs need at least.

    Per instance-round: the coins that decide a vote — one per recipient
    of a faulty coin-drawing leader, one per (counted asker, counted
    coin-drawing responder other than itself) — take at least coins / 32
    threefry words, plus four words of round keys; each coin vote is one
    tally step, and each counted general one more.  In slot mode the last
    round's askers are every general but the leader, dead ones included
    (their majorities are returned).
    """
    alive, faulty, leader = state.alive, state.faulty, state.leader
    strat = torch.zeros_like(faulty, dtype=torch.int8) if strategy is None else strategy
    idx = torch.arange(state.n, device=state.device)[None, :]
    words = steps = 0
    for r in range(rounds):
        if events is not None:
            alive = (alive & ~events["kill"][r]) | events["revive"][r]
            fset, sset = events["set_faulty"][r], events["set_strategy"][r]
            faulty = torch.where(fset >= 0, fset > 0, faulty)
            strat = torch.where(sset >= 0, sset, strat)
            leader_alive = alive.gather(1, leader.long()[:, None])[:, 0]
            leader = torch.where(leader_alive, leader, elect_lowest_id(state.ids, alive))
        coin_type = (strat < 1) | (strat > 4)
        counted = alive & (idx != leader[:, None])
        a = counted.sum(1)
        u = (counted & faulty & coin_type).sum(1)
        lead = leader.long()[:, None]
        lcoin = (faulty.gather(1, lead) & coin_type.gather(1, lead))[:, 0]
        coins1 = torch.where(lcoin, a, torch.zeros_like(a))
        asking = (idx != leader[:, None]) if slot and r == rounds - 1 else counted
        askers = asking.sum(1)
        coins2 = u * (askers - 1).clamp(min=0)
        words += int(((coins1 + 31) // 32 + (coins2 + 31) // 32 + 4).sum())
        steps += int((coins2 + askers).sum())
    return words, steps


def k1_bytes(B, n, R, scenario):
    """The bytes a K1 dispatch of R rounds at B x n must move at least.

    Plain: each input read once (order, leader, faulty, alive, ids, key,
    counter, counters) and each output written once (histograms,
    decisions, counter rows; the state is unchanged).  Scenario: the
    inputs also hold the strategy plane and the four event planes, and the
    outputs the state planes and strategy, and the leaders."""
    if scenario:
        return (B * 5 + B * n * 7 + R * B * n * 4 + 16 + 4 + 20
                + B * 4 + B * n * 3 + R * B * 5 + R * (12 + 20))
    return B * 5 + B * n * 6 + 16 + 4 + 12 + R * (12 + B + 12)


K1_DESIGN = ("each threefry word that holds a needed coin drawn once an instance and round, "
             "every bit used; n a multiple of 32: a warp a column, a lane a responder, "
             "a 32 x 32 bit transpose by shuffles, lane k pops asker k's coins (no atomics); "
             "other n: a warp 32 words, lane k the need window of their bit k from the "
             "responders' bitmap, two transposes, a row's coins by one shared atomic; "
             "round-1 coins 32 a word; round keys once a block")
K2_DESIGN = ("one packed segment sum a relay round (capped traitor counts and honest "
             "flags of both values), thresholds by selects, two 32-general mask words a "
             "lane, 32 / S instances a warp (S lanes an instance, 64 S >= n), segment "
             "sums by xor shuffles, four rounds a pass, the draws out of line")


def ptxas_records(log):
    """Each kernel instance's registers, spill, stack frame and static
    shared memory from an ``nvcc -Xptxas=-v`` log: [{"kernel" (its
    mangled name), "registers", "spill_stores", "spill_loads",
    "stack_frame", "smem"}] (bytes), ``_build.ptxas_resources`` in the
    kernels line's spelling."""
    return [{"kernel": name, "registers": r["registers"], "spill_stores": r["spill_stores"],
             "spill_loads": r["spill_loads"], "stack_frame": r["stack_frame"],
             "smem": r["shared_bytes"]} for name, r in _build.ptxas_resources(log).items()]


def words_drawn(run):
    """(run(), the threefry words K1 evaluated on the card during it): run
    with the wrappers' library swapped for K1's counting build
    (``megastep.cu`` with COUNTING_FLAGS: the same kernel, whose
    ``COIN_DRAWN`` in ``coins.cuh`` adds one to a device counter a
    threefry word; ``ba_megastep_words_drawn`` reads and clears it)."""
    lib, own = _build.load("megastep.cu", COUNTING_FLAGS), scenario_step._lib
    lib.ba_megastep.argtypes = own().ba_megastep.argtypes
    lib.ba_megastep.restype = ctypes.c_int
    lib.ba_megastep_words_drawn.restype = ctypes.c_ulonglong
    lib.ba_megastep_words_drawn()  # clears the count
    scenario_step._lib = lambda: lib
    try:
        out = run()
    finally:
        scenario_step._lib = own
    return out, int(lib.ba_megastep_words_drawn())


def bound(words, steps, nbytes, int_ops_per_s):
    ops_s = (words * THREEFRY_OPS + steps) / int_ops_per_s
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


QUEUE_SPIN_CYCLES = 2_000_000  # ~1 ms at the card's clock: longer than queueing 10 calls


def time_cuda(fn, reps, queued=False):
    """Mean ms of ``reps`` calls of ``fn`` after one warm-up call, as they
    are launched; or ``queued``: the card spins (``torch.cuda._sleep``)
    while the host queues the calls behind the start event, so they run
    back to back and a kernel shorter than its launch's host cost is timed
    at its own length, not at the host's launch rate."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    sync()
    if queued:
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def timed_plain(fn):
    """(result, host wall ms) of one call of the plain engine."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


# -- phases -------------------------------------------------------------------


def phase_env(dev):
    """Build every kernel and the native signer from the checkout's
    sources, all started together (one nvcc a source), then load them."""
    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES) + 1) as pool:
        jobs = {name: pool.submit(timed, _build.build, name) for name in CUDA_SOURCES}
        jobs["native"] = pool.submit(timed, native.build)
        jobs["megastep.cu (counting)"] = pool.submit(timed, _build.build, "megastep.cu",
                                                     COUNTING_FLAGS)
        build_s = {name: job.result() for name, job in jobs.items()}
    for module in (scenario_step, sweep_step, decompress, sha512_kernel, treeadd, ladder, modl,
                   powchain, fieldmul_probe, majority):
        module._lib()
    ladder._mult_lib()
    ladder._ladder_lib()
    native.publickey_batch(np.zeros((1, 32), np.uint8))  # loads the signer
    PTXAS.update({name: ptxas_records(_build.build_log.get(name, ""))
                  for name in CUDA_SOURCES})
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(dev), "gpu": smi("name,power.limit"),
          "build_wall_s": time.perf_counter() - t0, "build_s": build_s,
          "ptxas": PTXAS, "native_build": {k: native.build_log.get(k)
                                           for k in ("cmd", "seconds", "output")}})


def phase_known_answers(dev):
    k = rng.key(1234, device=dev)
    check(k.tolist() == [0, 1234], "key(1234)")
    check(rng.split(k).tolist() == [[1264997412, 2518116175], [2877103387, 1697627890]],
          "split(key(1234))")
    check(rng.fold_in(k, 1).tolist() == [2877103387, 1697627890], "fold_in(key, 1)")
    check(rng.bits(k, (3,)).tolist() == [3715183467, 3461522409, 1578076316], "bits")
    check(rng.coin_bits(k, (2, 5)).tolist() == [[1, 1, 0, 1, 0], [1, 1, 0, 1, 1]],  # ba-lint: disable=BA202 (known answers)
          "coin_bits")
    check(rng.key(2**32 + 5, device=dev).tolist() == [0, 5], "seed cut to 32 bits")
    # Random123's known answers for Philox4x32-10, the draws of K2: the
    # plain version's, and the kernel source's own rounds on the card
    answers = (((0,) * 6, [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
               ((0xFFFFFFFF,) * 6, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
               ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0),
                [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]))
    on_card = sweep_step.kernel_philox4x32_10(
        torch.tensor([w for w, _ in answers], dtype=torch.int64, device=dev))
    for (words, want), got_card in zip(answers, on_card.tolist()):
        got = sweep_step.philox4x32_10(*(torch.tensor(w, device=dev) for w in words))
        check([int(x) for x in got] == want, f"plain philox4x32_10{words}")
        check(got_card == want, f"the kernel's philox4x32_10{words}: {got_card}")
    emit({"phase": "threefry_known_answers", "philox_plain": True, "philox_kernel": True,
          "ok": True})


def phase_middle(dev, rs):
    B, R = 256, 8
    for n in (1, 37, 128, 300):
        arrays, events, strategy = random_arrays(rs, B, n, R)
        ev = convert.events_from_numpy(events, dev)
        outs = {}
        for name, fn in (("plain", pipeline.scenario_megastep),
                         ("kernel", scenario_step.cuda_scenario_megastep)):
            st = to_state(arrays, dev)
            sc = pipeline.make_key_schedule(rng.key(n, device=dev), 2**31 - 4)
            out = fn(st, sc, convert.strategy_from_numpy(strategy, dev),
                     convert.counters_from_numpy([1, 2, 3, 4, 5], dev), ev,
                     rounds=R, collect_decisions=True)
            outs[name] = (*out[0].tensors(), out[1].counter, *out[2:])
        sync()
        err_s = max_abs_err(zip(outs["plain"], outs["kernel"]))
        for name, fn in (("plain", pipeline.pipeline_megastep),
                         ("kernel", scenario_step.cuda_pipeline_megastep)):
            st = to_state(arrays, dev)
            sc = pipeline.make_key_schedule(rng.key(n + 1, device=dev), 7)
            out = fn(st, sc, rounds=R, collect_decisions=True,
                     counters=convert.counters_from_numpy([0, 1, 2], dev))
            outs[name] = (*out[0].tensors(), out[1].counter, *out[2:])
        sync()
        err_p = max_abs_err(zip(outs["plain"], outs["kernel"]))
        check(err_s == 0 and err_p == 0, f"kernel differs from plain at n={n}")
        emit({"phase": "kernel_vs_plain_middle", "B": B, "n": n, "R": R,
              "scenario_max_abs_err": err_s, "plain_max_abs_err": err_p})


def phase_full_width(dev, seed, card):
    key = rng.key(seed, device=dev)
    arrays = sweep_arrays(rng.fold_in(key, 1000), B_FULL, CAP_FULL, order=1)
    kw = dict(depth=2, rounds_per_dispatch=RPD_FULL, collect_decisions=True,
              with_counters=True, device=dev)

    scenario_step.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = pipeline.pipeline_sweep(key, to_state(arrays, dev), R_FULL, engine="cuda", **kw)
    wall = time.perf_counter() - t0
    launches = scenario_step.cuda_pipeline_megastep.launches
    check(launches == R_FULL // RPD_FULL, f"pipeline kernel launches {launches}")
    check(out["stats"]["engine"] == "cuda", "engine")
    hist = out["histograms"]
    check(hist.shape == (R_FULL, 3) and out["decisions"].shape == (R_FULL, B_FULL), "shapes")
    check((hist == np.array([0, B_FULL, 0])).all(), "validity: some round did not attack")
    check(out["counters"] == {"quorum_failures": 0, "unanimous_rounds": R_FULL,
                              "equivocation_observed": 0}, f"counters {out['counters']}")
    emit({"phase": "full_width_validity", "B": B_FULL, "capacity": CAP_FULL,
          "rounds": R_FULL, "rounds_per_dispatch": RPD_FULL, "depth": 2,
          "wall_s": wall, "rounds_per_s": R_FULL / wall,
          "agreement_rounds_per_s": R_FULL * B_FULL / wall, "card": card,
          "counters": out["counters"], "kernel_launches": launches})
    main_out = out

    faulty_leaders = dict(arrays, faulty=arrays["faulty"].copy())
    faulty_leaders["faulty"][::4, 0] = True
    out = pipeline.pipeline_sweep(key, to_state(faulty_leaders, dev), R_FULL,
                                  engine="cuda", **kw)
    sub = {k: v[:64] for k, v in faulty_leaders.items()}
    ref = pipeline.pipeline_sweep(key, to_state(sub, dev), R_FULL, engine="torch", **kw)
    check(np.array_equal(out["decisions"][:, :64], ref["decisions"]),
          "faulty-leader decisions of instances 0-63 differ from the plain engine")
    emit({"phase": "full_width_faulty_leaders", "subset_equal": True,
          "histogram_round0": out["histograms"][0].tolist(), "counters": out["counters"]})
    return arrays, main_out, launches


def replay_first_plain_dispatch(dev, seed, arrays, campaign, R, int_ops_per_s):
    """A plain campaign's first dispatch of R rounds again (the campaign's
    key, state and zero counters): K1 against the plain engine on the
    same inputs (state, histograms, decisions and counter rows), and
    against the campaign's own first R rounds; K1's CUDA-event time, the
    plain time and the bound.  These launches are not the path's."""
    state = to_state(arrays, dev)
    counters = convert.counters_from_numpy([0, 0, 0], dev)
    sched = pipeline.make_key_schedule(rng.key(seed, device=dev))
    k_out = scenario_step.cuda_pipeline_megastep(
        pipeline.fresh_copy(state), pipeline.fresh_copy(sched), rounds=R,
        collect_decisions=True, counters=counters)
    p_out, plain_ms = timed_plain(lambda: plain_chunked(state, sched, R, counters))
    err = max_abs_err([(k_out[2], p_out["hist"]), (k_out[3], p_out["dec"]),
                       (k_out[4], p_out["rows"])]
                      + list(zip(k_out[0].tensors(), p_out["state"].tensors())))
    check(err == 0, f"full-width plain dispatch of {R} rounds differs: {err}")
    for name, got in (("histograms", k_out[2]), ("decisions", k_out[3]),
                      ("counters_per_round", k_out[4])):
        check(np.array_equal(campaign[name][:R], got.cpu().numpy()),
              f"the campaign's first dispatch {name} differ from the replayed kernel")
    sc = pipeline.fresh_copy(sched)
    ms = time_cuda(lambda: scenario_step.cuda_pipeline_megastep(
        state, sc, rounds=R, collect_decisions=True, counters=counters), reps=3)
    words, steps = work_counts(state, R)
    B, n = state.faulty.shape
    bound_ms, bound_by = bound(words, steps, k1_bytes(B, n, R, scenario=False), int_ops_per_s)
    return {"state": state, "sched": sched, "counters": counters, "k_out": k_out, "err": err,
            "ms": ms, "plain_ms": plain_ms, "words": words, "steps": steps,
            "bound_ms": bound_ms, "bound_by": bound_by, "shape": {"B": B, "n": n, "R": R}}


def kernel_line_plain(dev, seed, arrays, main_out, launches, int_ops_per_s, repl_path,
                      supervised_path, device_obs_run, fleet_paths=()):
    """The main path's first plain dispatch again (same key, state and
    shape): the kernel against the plain engine and against the main
    path's own outputs; its time, the plain time and the bound.  The
    REPL's dispatches (``k1_repl_path``) and the supervised campaign's
    first 4-round dispatch ride along as ``repl_path`` and
    ``supervised_path``; device_obs' 8-round campaign's first dispatch,
    replayed the same way, as ``device_obs_path``; the fleet campaigns'
    first dispatches (``replay_campaign_first_dispatch``) as
    ``fleet_paths``."""
    first = replay_first_plain_dispatch(dev, seed, arrays, main_out, RPD_FULL, int_ops_per_s)
    d_obs = replay_first_plain_dispatch(dev, seed, arrays, device_obs_run, RPD_FULL // 2,
                                        int_ops_per_s)
    device_obs_path = {"what": "device_obs: the 8-round campaign's first dispatch",
                       **{k: d_obs[k] for k in ("err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "shape")}}
    state, sched, counters, k_out = (first[k] for k in ("state", "sched", "counters", "k_out"))
    c_out, drawn = words_drawn(lambda: scenario_step.cuda_pipeline_megastep(
        pipeline.fresh_copy(state), pipeline.fresh_copy(sched), rounds=RPD_FULL,
        collect_decisions=True, counters=counters))
    check(max_abs_err(zip(c_out[2:5], k_out[2:5])) == 0,
          "K1's counting build differs from the kernel on the plain dispatch")
    words = first["words"]
    check(words <= drawn <= 2 * words,
          f"K1 drew {drawn} threefry words on the card; the inputs need {words}")
    return {"name": "megastep_plain", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "wrapper": "ba_tpu_torch/ops/scenario_step.py:cuda_pipeline_megastep",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(first["err"], repl_path["max_abs_err"],
                               supervised_path["max_abs_err"], d_obs["err"],
                               *(f["err"] for f in fleet_paths)),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None,
            "checked_against_plain": True, "shape": first["shape"],
            "design": K1_DESIGN, "ptxas": PTXAS["megastep.cu"],
            "threefry_words_needed": words, "threefry_words_drawn": drawn,
            "tally_steps": first["steps"], "repl_path": repl_path,
            "supervised_path": supervised_path, "device_obs_path": device_obs_path,
            "fleet_paths": list(fleet_paths)}


def phase_scenario(dev, seed, card):
    spec = scenario_spec.load(COALITION)
    key = rng.key(seed + 1, device=dev)
    arrays = sweep_arrays(rng.fold_in(key, 1000), B_FULL, CAP_FULL,
                          order=0 if spec.order == "retreat" else 1)
    block = scenario_compile.compile_scenario(spec, B_FULL, CAP_FULL, sparse=True)
    kw = dict(depth=2, rounds_per_dispatch=RPD_SCEN, collect_decisions=True, device=dev)

    scenario_step.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = pipeline.scenario_sweep(key, to_state(arrays, dev), block, engine="cuda", **kw)
    wall = time.perf_counter() - t0
    launches = scenario_step.cuda_scenario_megastep.launches
    R = spec.rounds
    check(launches == -(-R // RPD_SCEN), f"scenario kernel launches {launches}")
    check(out["histograms"].shape == (R, 3) and (out["histograms"].sum(1) == B_FULL).all(),
          "scenario histograms")
    check(out["leaders"].shape == (R, B_FULL), "leaders shape")

    t0 = time.perf_counter()
    planes = block.chunk(0, R)
    materialize_ms = (time.perf_counter() - t0) * 1e3
    sub = {k: v[:64] for k, v in arrays.items()}
    sub_block = scenario_compile.ScenarioBlock(**{k: np.ascontiguousarray(v[:, :64])
                                                  for k, v in planes.items()})
    ref = pipeline.scenario_sweep(key, to_state(sub, dev), sub_block, engine="torch", **kw)
    for name in ("decisions", "leaders"):
        check(np.array_equal(out[name][:, :64], ref[name]), f"scenario {name} 0-63 differ")
    final = out["final_state"]
    for name, value in convert.state_to_numpy(ref["final_state"]).items():
        check(np.array_equal(getattr(final, name)[:64].cpu().numpy(), value),
              f"scenario final {name} 0-63 differ")
    check(torch.equal(out["final_strategy"][:64], ref["final_strategy"]), "final strategy")
    emit({"phase": "scenario_full_width", "spec": os.path.basename(COALITION), "B": B_FULL,
          "capacity": CAP_FULL, "rounds": R, "wall_s": wall,
          "agreement_rounds_per_s": R * B_FULL / wall, "card": card,
          "counters": out["counters"], "subset_equal": True, "kernel_launches": launches,
          "chunks_materialize_ms": materialize_ms})
    return arrays, planes, out, launches


def kernel_line_scenario(dev, seed, arrays, planes, main_out, launches, int_ops_per_s,
                         repl_path, chain_path):
    """The main path's scenario dispatches again (same key, state and
    chunks of RPD_SCEN rounds), each continuing from the previous one's
    carry, schedule counter and counter block: every dispatch against the
    plain engine in full, the whole campaign against the main path's
    outputs.  The first dispatch is timed and bounded.  The REPL's
    dispatches (``k1_repl_path``) ride along as ``repl_path``, phase 51's
    cuda leg's as ``chain_path``."""
    R = planes["kill"].shape[0]
    key = rng.key(seed + 1, device=dev)
    state = to_state(arrays, dev)
    strategy = torch.zeros_like(state.faulty, dtype=torch.int8)
    counters = convert.counters_from_numpy([0] * 5, dev)
    k_carry = (pipeline.fresh_copy(state), pipeline.make_key_schedule(key), strategy.clone())
    k_counters = counters
    p_state, p_sched, p_strategy, p_counters = (
        state, pipeline.make_key_schedule(key), strategy, counters)
    first, outs, plain_ms, err = None, [], [], 0
    for lo in range(0, R, RPD_SCEN):
        nr = min(RPD_SCEN, R - lo)
        events = convert.events_from_numpy({k: v[lo:lo + nr] for k, v in planes.items()}, dev)
        if first is None:
            first = (pipeline.fresh_copy(k_carry), events)
        k_out = scenario_step.cuda_scenario_megastep(
            *k_carry, k_counters, events, rounds=nr, collect_decisions=True)
        p_out, ms = timed_plain(lambda: plain_chunked(
            p_state, p_sched, nr, p_counters, strategy=p_strategy, events=events))
        plain_ms.append(ms)
        err = max(err, max_abs_err(
            [(k_out[1].counter, p_sched.counter + nr), (k_out[2], p_out["strategy"]),
             (k_out[3], p_out["hist"]), (k_out[4], p_out["lead"]),
             (k_out[5], p_out["rows"]), (k_out[6], p_out["dec"])]
            + list(zip(k_out[0].tensors(), p_out["state"].tensors()))))
        outs.append(k_out[3:])
        k_carry, k_counters = k_out[:3], k_out[5][-1]
        p_state, p_strategy, p_counters = p_out["state"], p_out["strategy"], p_out["rows"][-1]
        p_sched = pipeline.KeySchedule(p_sched.key_data, p_sched.counter + nr)
    check(err == 0, f"full-width scenario dispatches differ from the plain engine: {err}")
    for name, i in (("histograms", 0), ("leaders", 1), ("counters_per_round", 2),
                    ("decisions", 3)):
        got = torch.cat([o[i] for o in outs]).cpu().numpy()
        check(np.array_equal(main_out[name], got),
              f"main path's scenario {name} differ from the replayed kernel")
    check(max_abs_err(zip(main_out["final_state"].tensors(), k_carry[0].tensors())) == 0
          and torch.equal(main_out["final_strategy"], k_carry[2])
          and torch.equal(main_out["final_schedule"].counter, k_carry[1].counter),
          "main path's final carry differs from the replayed kernel")

    (st0, sc0, strat0), ev0 = first
    copies = iter([pipeline.fresh_copy((st0, sc0, strat0)) for _ in range(4)])
    ms = time_cuda(lambda: scenario_step.cuda_scenario_megastep(
        *next(copies), counters, ev0, rounds=RPD_SCEN, collect_decisions=True), reps=3)
    c_out, drawn = words_drawn(lambda: scenario_step.cuda_scenario_megastep(
        *pipeline.fresh_copy((st0, sc0, strat0)), counters, ev0, rounds=RPD_SCEN,
        collect_decisions=True))
    check(max_abs_err(zip(c_out[3:], outs[0])) == 0,
          "K1's counting build differs from the kernel on the first scenario dispatch")
    R = RPD_SCEN
    words, steps = work_counts(st0, R, strategy=strat0, events=ev0)
    B, n = st0.faulty.shape
    nbytes = k1_bytes(B, n, R, scenario=True)
    bound_ms, bound_by = bound(words, steps, nbytes, int_ops_per_s)
    return {"name": "megastep_scenario", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "wrapper": "ba_tpu_torch/ops/scenario_step.py:cuda_scenario_megastep",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(err, repl_path["max_abs_err"], chain_path["max_abs_err"]),
            "ms": ms,
            "plain_ms": plain_ms[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "checked_against_plain": True, "shape": {"B": B, "n": n, "R": R},
            "dispatches_checked": len(outs), "plain_ms_per_dispatch": plain_ms,
            "design": K1_DESIGN, "ptxas": PTXAS["megastep.cu"],
            "threefry_words_needed": words, "threefry_words_drawn": drawn,
            "tally_steps": steps, "repl_path": repl_path, "strategy_chain_path": chain_path}


# -- failover and carry checkpoints at full width ------------------------------


def kill_plane(seed, R, B, n):
    """A seeded [R, B, n] kill schedule: each general dies with
    probability P_KILL a round, and every instance's leader (index 0)
    before round 1.  Drawn a round at a time in float32."""
    rs = np.random.default_rng(seed)
    kills = np.empty((R, B, n), bool)
    for r in range(R):
        np.less(rs.random((B, n), dtype=np.float32), P_KILL, out=kills[r])
    kills[1, :, 0] = True
    return kills


def phase_failover_full_width(dev, seed, card, int_ops_per_s):
    """``failover_sweep`` at B_FULL x CAP_FULL, R_FAIL rounds: one K1
    scenario launch; instances 0-63 against the torch engine on the card
    (leaders, decisions, final state); then FAIL_REPS more calls timed,
    and the launch's bound from the inputs' needed work."""
    key = rng.key(seed + 2, device=dev)
    arrays = sweep_arrays(rng.fold_in(key, 1000), B_FULL, CAP_FULL, order=1)
    kills = kill_plane(seed + 2, R_FAIL, B_FULL, CAP_FULL)
    kills_dev = torch.from_numpy(kills).to(dev)
    state = to_state(arrays, dev)
    scenario_step.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = sweep.failover_sweep(key, state, kills_dev, engine="cuda", device=dev)
    sync()
    first_wall = time.perf_counter() - t0
    launches = scenario_step.cuda_scenario_megastep.launches
    check(launches == 1, f"failover_sweep launched K1 {launches} times, not once")
    check(scenario_step.cuda_pipeline_megastep.launches == 0, "failover ran a plain dispatch")
    hist, dec, lead = (out[k].cpu().numpy() for k in ("histograms", "decisions", "leaders"))
    check(hist.shape == (R_FAIL, 3) and dec.shape == lead.shape == (R_FAIL, B_FULL),
          "failover shapes")
    for code in range(3):
        check(np.array_equal(hist[:, code], (dec == code).sum(axis=1)),
              "failover histograms disagree with its decisions")
    check((lead[1] != 0).all(), "an instance kept its killed leader")
    ref = sweep.failover_sweep(key, rows_of(state, 0, 64), kills_dev[:, :64].contiguous(),
                               engine="torch", device=dev)
    for name in ("leaders", "decisions"):
        check(torch.equal(out[name][:, :64], ref[name]), f"failover {name} 0-63 differ")
    check(max_abs_err(zip((t[:64] for t in out["final_state"].tensors()),
                          ref["final_state"].tensors())) == 0,
          "failover final state 0-63 differs")
    walls, device_ms = [], []
    for _ in range(FAIL_REPS):  # the caller's state is kept, so each call is the same
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sync()
        t0 = time.perf_counter()
        start.record()
        again = sweep.failover_sweep(key, state, kills_dev, engine="cuda", device=dev)
        end.record()
        sync()
        walls.append(time.perf_counter() - t0)
        device_ms.append(start.elapsed_time(end))
        check(torch.equal(again["decisions"], out["decisions"]), "failover is not repeatable")
    B, n = state.faulty.shape
    keep = torch.full_like(kills_dev, -1, dtype=torch.int8)
    words, steps = work_counts(state, R_FAIL, strategy=torch.zeros_like(keep[0]),
                               events={"kill": kills_dev, "revive": torch.zeros_like(kills_dev),
                                       "set_faulty": keep, "set_strategy": keep})
    nbytes = k1_bytes(B, n, R_FAIL, scenario=True)
    bound_ms, bound_by = bound(words, steps, nbytes, int_ops_per_s)
    wall = float(np.median(walls))
    emit({"phase": "failover_full_width", "B": B_FULL, "capacity": CAP_FULL,
          "rounds": R_FAIL, "p_kill": P_KILL, "kill_plane_bytes": kills.nbytes,
          "first_wall_s": first_wall, "wall_s": walls, "device_ms": device_ms,
          "agreement_rounds_per_s": R_FAIL * B_FULL / wall, "card": card,
          "bound_ms": bound_ms, "bound_by": bound_by, "threefry_words_needed": words,
          "tally_steps": steps, "kernel_launches": launches, "subset_equal": True,
          "histogram_round1": hist[1].tolist(),
          "alive_after": int(out["final_state"].alive.sum())})
    return launches


def same_tail(full, tail, start, names):
    """``tail`` (a run resumed at ``start``) against ``full``'s rounds from
    ``start`` and its final carry."""
    for name in names:
        check(np.array_equal(full[name][start:], tail[name]), f"resumed {name} differ")
    check(full["counters"] == tail["counters"], "resumed counters differ")
    check(max_abs_err(zip(full["final_state"].tensors(), tail["final_state"].tensors())) == 0,
          "resumed final state differs")
    if "final_strategy" in full:
        check(torch.equal(full["final_strategy"], tail["final_strategy"]),
              "resumed final strategy differs")
    check(torch.equal(full["final_schedule"].counter, tail["final_schedule"].counter),
          "resumed schedule counter differs")


def headers_agree(paths):
    """Each file's header round equals its stored KeySchedule counter."""
    for path in paths:
        meta, arrays = snapshot.read_carry_checkpoint(path)
        check(meta["round"] == int(arrays["counter"]), f"{path}: round != counter")


def checkpoint_campaign(name, run, total, every, resume_at, keep_last=None, out_names=()):
    """One campaign three times: uninterrupted, with checkpoints every
    ``every`` rounds into CKPT_DIR, and resumed from round ``resume_at``
    with key=None, state=None.  ``run(**kw)`` drives it.  Returns the
    phase's record and the K1 launches of the three runs."""
    template = os.path.join(CKPT_DIR, name + "_{round}.npz")
    kept = os.path.join(CKPT_DIR, f"{name}_resume_at_{resume_at}.npz")

    def keep(r, path):  # the resume point outlives the family's pruning
        if r == resume_at:
            os.link(path, kept)

    scenario_step.reset_launches()
    walls = {}
    for leg, kw in (("no_checkpoints", {}),
                    ("checkpoints", dict(checkpoint_every=every, checkpoint_path=template,
                                         checkpoint_keep_last=keep_last,
                                         on_checkpoint=keep))):
        sync()
        t0 = time.perf_counter()
        out = run(**kw)
        sync()
        walls[leg] = time.perf_counter() - t0
        if leg == "no_checkpoints":
            full = out
    ckpt = out
    same_tail(full, ckpt, 0, out_names)
    left = [r for r, _ in snapshot.checkpoint_paths(template)]
    want = list(range(every, total + 1, every))
    if keep_last is not None:
        want = want[-keep_last:]
    check(left == want, f"{name}: checkpoints left on disk {left}, want {want}")
    headers_agree([kept] + [p for _, p in snapshot.checkpoint_paths(template)])
    sync()
    t0 = time.perf_counter()
    tail = run(resume=kept)
    sync()
    walls["resume"] = time.perf_counter() - t0
    same_tail(full, tail, resume_at, out_names)
    check(tail["stats"]["start_round"] == resume_at, "resume cursor")
    check(tail["stats"]["run_id"] == ckpt["stats"]["run_id"] == full["stats"]["run_id"],
          "the resumed run's id differs from the writer's")
    writes = ckpt["stats"]["checkpoint_writes"]
    return {"campaign": name, "rounds": total, "checkpoint_every": every,
            "keep_last": keep_last, "resumed_from": resume_at, "files_left": left,
            "checkpoint_bytes": [w["bytes"] for w in writes],
            "write_host_ms": [w["host_ms"] for w in writes],
            "wall_s_no_checkpoints": walls["no_checkpoints"],
            "wall_s_checkpoints": walls["checkpoints"], "wall_s_resume": walls["resume"],
            "run_id": tail["stats"]["run_id"], "bit_equal": True}, (
        scenario_step.cuda_pipeline_megastep.launches,
        scenario_step.cuda_scenario_megastep.launches)


def phase_checkpoint_resume_full_width(dev, seed, card, arrays, s_arrays):
    """Phase 4's plain campaign (64 rounds, 16 a dispatch, counters) with
    a checkpoint every 16 rounds, the two newest kept, resumed at 32; and
    phase 5's coalition campaign (8 rounds, 4 a dispatch) with a
    checkpoint every 4, resumed at 4."""
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    atexit.register(shutil.rmtree, CKPT_DIR, True)  # also when a check fails
    key = rng.key(seed, device=dev)
    plain_kw = dict(depth=2, rounds_per_dispatch=RPD_FULL, collect_decisions=True,
                    with_counters=True, engine="cuda", device=dev)

    def plain(resume=None, **kw):
        if resume is not None:
            return pipeline.pipeline_sweep(None, None, R_FULL, resume=resume, **plain_kw)
        return pipeline.pipeline_sweep(key, to_state(arrays, dev), R_FULL, **plain_kw, **kw)

    rec_p, (p_plain, p_scen) = checkpoint_campaign(
        "plain", plain, R_FULL, CKPT_EVERY_PLAIN, CKPT_RESUME, keep_last=CKPT_KEEP,
        out_names=("histograms", "decisions", "counters_per_round"))
    check((p_plain, p_scen) == (10, 0), f"plain campaign launches {(p_plain, p_scen)}")

    spec = scenario_spec.load(COALITION)
    s_key = rng.key(seed + 1, device=dev)
    block = scenario_compile.compile_scenario(spec, B_FULL, CAP_FULL, sparse=True)
    scen_kw = dict(depth=2, rounds_per_dispatch=RPD_SCEN, collect_decisions=True,
                   engine="cuda", device=dev)

    def scen(resume=None, **kw):
        if resume is not None:
            return pipeline.scenario_sweep(None, None, block, resume=resume, **scen_kw)
        return pipeline.scenario_sweep(s_key, to_state(s_arrays, dev), block, **scen_kw, **kw)

    rec_s, (s_plain, s_scen) = checkpoint_campaign(
        "scenario", scen, spec.rounds, RPD_SCEN, RPD_SCEN,
        out_names=("histograms", "decisions", "leaders", "counters_per_round"))
    check((s_plain, s_scen) == (0, 5), f"scenario campaign launches {(s_plain, s_scen)}")
    emit({"phase": "checkpoint_resume_full_width", "B": B_FULL, "capacity": CAP_FULL,
          "card": card, "campaigns": [rec_p, rec_s]})
    return p_plain, s_scen


def flip_alive_byte(src, dst):
    """``src`` rewritten to ``dst`` with one byte of ``alive`` flipped and
    every other entry, the header included, as it was."""
    with np.load(src) as data:
        fields = {k: data[k] for k in data.files}
    alive = fields["alive"].copy()
    alive.flat[0] = not alive.flat[0]
    fields["alive"] = alive
    with open(dst, "wb") as fh:
        np.savez(fh, **fields)


def phase_checkpoint_cross_device(dev, seed):
    """A narrow campaign, plain and scenario, written under engine="cuda"
    and resumed with engine="torch" on the CPU: bit-equal to the card's
    uninterrupted run.  Then ``python -m ba_tpu_torch.scenario`` validates
    every checkpoint on disk, and refuses one with a byte of ``alive``
    flipped."""
    key = rng.key(seed + 3, device=dev)
    arrays = sweep_arrays(rng.fold_in(key, 1000), B_NARROW, N_NARROW, order=1)
    spec = scenario_spec.load(COALITION)
    block = scenario_compile.compile_scenario(spec, B_NARROW, N_NARROW, sparse=True)
    kw = dict(depth=2, collect_decisions=True)
    scenario_step.reset_launches()
    cases = {"narrow_plain": (None, R_FULL, RPD_FULL, dict(with_counters=True)),
             "narrow_scenario": (block, spec.rounds, RPD_SCEN, {})}
    for name, (scn, rounds, rpd, extra) in cases.items():
        template = os.path.join(CKPT_DIR, name + "_{round}.npz")
        run = dict(kw, rounds_per_dispatch=rpd, scenario=scn, **extra)
        full = pipeline.pipeline_sweep(key, to_state(arrays, dev), rounds, engine="cuda",
                                       device=dev, checkpoint_every=rpd,
                                       checkpoint_path=template, **run)
        resumed = template.format(round=rpd)
        tail = pipeline.pipeline_sweep(None, None, rounds, resume=resumed, engine="torch",
                                       device="cpu", **run)
        check(tail["stats"]["engine"] == "torch", "the resumed run's engine")
        names = ("histograms", "decisions", "counters_per_round") + (
            ("leaders",) if scn is not None else ())
        cpu_full = dict(full, final_state=full["final_state"].to(CPU),
                        final_schedule=pipeline.fresh_copy(full["final_schedule"], CPU))
        if scn is not None:
            cpu_full["final_strategy"] = full["final_strategy"].cpu()
        same_tail(cpu_full, tail, rpd, names)
    launches = (scenario_step.cuda_pipeline_megastep.launches,
                scenario_step.cuda_scenario_megastep.launches)
    check(launches == (R_FULL // RPD_FULL, -(-spec.rounds // RPD_SCEN)),
          f"cross-device launches {launches}")

    files = sorted(os.path.join(CKPT_DIR, f) for f in os.listdir(CKPT_DIR)
                   if f.endswith(".npz"))
    cli = [sys.executable, "-m", "ba_tpu_torch.scenario"]
    proc = subprocess.run(cli + files, capture_output=True, text=True, cwd=ROOT, timeout=300)
    check(proc.returncode == 0 and proc.stdout.count(": OK") == len(files),
          f"the scenario CLI refused a checkpoint: {proc.stderr[-500:]}")
    bad = os.path.join(CKPT_DIR, "flipped_alive.npz")
    flip_alive_byte(os.path.join(CKPT_DIR, f"narrow_scenario_{RPD_SCEN}.npz"), bad)
    refused = subprocess.run(cli + [bad], capture_output=True, text=True, cwd=ROOT,
                             timeout=300)
    check(refused.returncode != 0 and "digest mismatch" in refused.stderr,
          f"a flipped alive byte was not refused: rc {refused.returncode}, "
          f"{refused.stderr[-300:]}")
    emit({"phase": "checkpoint_cross_device", "B": B_NARROW, "n": N_NARROW,
          "campaigns": list(cases), "written": "cuda", "resumed": "torch on the CPU",
          "bit_equal": True, "cli_validated": len(files), "cli_refused_rc": refused.returncode,
          "kernel_launches": {"plain": launches[0], "scenario": launches[1]}})
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return launches


# -- supervised campaigns -------------------------------------------------------


TRANSIENT_PLAN = os.path.join(ROOT, "examples", "faults", "transient_storm.json")
KILL_PLAN = os.path.join(ROOT, "examples", "faults", "midcampaign_kill.json")
RPD_SUP, SUP_EVERY, SUP_KEEP = 4, 8, 2  # supervised_full_width: phase 4's campaign's dials
RPD_SUP_SCEN, SUP_SCEN_EVERY = 2, 4  # its coalition campaign's
SUP_DIR = os.path.join(ROOT, "_smoke_supervised")  # git-ignored; removed at the end


def sup_plain_kw(dev):
    """Phase 4's campaign at RPD_SUP rounds a dispatch, with checkpoints."""
    return dict(depth=2, rounds_per_dispatch=RPD_SUP, collect_decisions=True,
                with_counters=True, engine="cuda", device=dev, checkpoint_every=SUP_EVERY,
                checkpoint_keep_last=SUP_KEEP)


def supervised_kill_child(seed, template):
    """The kill-and-rerun drill's child process: phase 4's campaign under
    ``midcampaign_kill.json``, which SIGKILLs this process at round 20."""
    dev = CARD
    key = rng.key(seed, device=dev)
    arrays = sweep_arrays(rng.fold_in(key, 1000), B_FULL, CAP_FULL, order=1)
    supervisor.supervised_sweep(key, to_state(arrays, dev), R_FULL,
                                chaos=chaos.load(KILL_PLAN), checkpoint_path=template,
                                **sup_plain_kw(dev))
    sys.exit(3)  # the plan's kill did not fire


def same_campaign(got, want, names, what):
    for name in names:
        check(np.array_equal(got[name], want[name]), f"{what}: {name} differ")
    check(got["counters"] == want["counters"], f"{what}: counters differ")


SUP_B1_ROTATIONS = 12  # supervised_full_width's B = 1 legs: rounds of the four


def supervised_b1(dev, rotations):
    """Supervision's host cost where dispatches are shortest: the REPL's
    ``run-rounds attack 1024`` shape (one instance, the N_REPL roster with
    every third general faulty, 128 K1 dispatches of 8 rounds, depth 2)
    without checkpoints, through ``pipeline_sweep`` alone, with the retire
    watchdog alone (``retire_timeout_s=30``), with a pass-through
    ``exec_seam`` alone, and through ``supervised_sweep``; one warm-up of
    each, then ``rotations`` rounds of the four, in turn forward and
    backward.  All equal, 128 K1 launches each.  -> each leg's walls,
    median and minimum, and the supervised / unsupervised ratio of the
    medians."""
    cluster, _ = roster(TorchBackend(device=dev))
    state = cluster.backend._make_state(cluster.generals, 0, 1)
    kw = dict(depth=2, rounds_per_dispatch=8, collect_decisions=True, with_counters=True,
              engine="cuda", device=dev)
    legs = {"unsupervised": pipeline.pipeline_sweep,
            "watchdog": functools.partial(pipeline.pipeline_sweep, retire_timeout_s=30.0),
            "seam": functools.partial(pipeline.pipeline_sweep,
                                      exec_seam=lambda call, *where: call()),
            "supervised": supervisor.supervised_sweep}
    walls = {leg: [] for leg in legs}
    want = None
    for i in range(1 + rotations):
        for leg in list(legs) if i % 2 == 0 else list(legs)[::-1]:
            st = pipeline.fresh_copy(state)
            scenario_step.reset_launches()
            sync()
            t0 = time.perf_counter()
            out = legs[leg](rng.key(7, device=dev), st, R_AB_REPL, **kw)
            wall = time.perf_counter() - t0
            check(scenario_step.cuda_pipeline_megastep.launches == R_AB_REPL // 8,
                  f"B = 1 {leg}: K1 launches")
            want = want or out
            same_campaign(out, want, ("histograms", "decisions", "counters_per_round"),
                          f"B = 1 {leg}")
            if i:  # the first round warms every leg up
                walls[leg].append(wall)
    med = {leg: float(np.median(w)) for leg, w in walls.items()}
    return {"shape": {"B": 1, "n": N_REPL, "capacity": CAP_FULL, "rounds": R_AB_REPL,
                      "rounds_per_dispatch": 8, "depth": 2, "checkpoints": None},
            "rotations": rotations, "walls_s": walls, "median_s": med,
            "min_s": {leg: min(w) for leg, w in walls.items()},
            "median_unsupervised_s": med["unsupervised"],
            "median_supervised_s": med["supervised"],
            "ratio_of_medians": med["supervised"] / med["unsupervised"],
            "min_unsupervised_s": min(walls["unsupervised"]),
            "min_supervised_s": min(walls["supervised"])}


def ab_supervised(dev, card):
    """``supervised_b1``'s reading for an A/B of two checkouts, one line."""
    emit({"phase": "ab_supervised", **supervised_b1(dev, SUP_B1_ROTATIONS), "card": card})


def phase_supervised_full_width(dev, seed, card, arrays, main_out, s_arrays, s_main_out,
                                int_ops_per_s):
    """``supervised_sweep`` on the card at full width, K1 throughout.

    1. Phase 4's campaign at 4 rounds a dispatch with a checkpoint every
       8 rounds (the two newest kept), unsupervised and supervised
       (``health_every=1``) in two pairs, A B B A: bit-equal, and equal to
       phase 4's run at 16 rounds a dispatch; 16 K1 launches each, a
       health sample a dispatch with a finite watchdog margin; the walls
       and their ratio.  The campaign's first 4-round dispatch is
       replayed through K1 and the plain engine on the same key and state
       (``replay_first_plain_dispatch``): all equal, and K1's time and
       bound at that shape for K1's plain line.
    2. The same campaign under ``transient_storm.json`` (transients at
       dispatch and retire, a 0.25 s stall against a pinned 0.1 s
       watchdog, a fatal retire after a corrupted checkpoint, an OOM):
       bit-equal to the clean run; its supervisor block and the
       quarantined file.
    3. Phase 5's coalition campaign at 2 rounds a dispatch, a checkpoint
       every 4, a fatal fault at the retire of rounds [6, 8): recovered
       from the round-4 checkpoint, bit-equal to phase 5's run.
    4. A child process runs 1. under ``midcampaign_kill.json`` and dies by
       SIGKILL at round 20; the same call here, ``resume="auto"``,
       completes it bit-equal with its history from round 0 in one
       attempt.
    5. An allocation larger than the card raises
       ``torch.cuda.OutOfMemoryError``, classified ``oom`` and spelled as
       the JAX package spells a fault.
    6. ``supervised_b1``: the REPL's B = 1 shape without checkpoints,
       unsupervised, with the watchdog or a seam alone, and supervised,
       in rotation.
    Returns the phase's K1 launches (plain, scenario) and the supervised
    path's record for K1's plain line."""
    shutil.rmtree(SUP_DIR, ignore_errors=True)
    os.makedirs(SUP_DIR)
    atexit.register(shutil.rmtree, SUP_DIR, True)
    key = rng.key(seed, device=dev)
    names = ("histograms", "decisions", "counters_per_round")
    n_dispatch = R_FULL // RPD_SUP
    launches = {"plain": 0, "scenario": 0}

    def counted(fn):
        scenario_step.reset_launches()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
        launches["plain"] += scenario_step.cuda_pipeline_megastep.launches
        launches["scenario"] += scenario_step.cuda_scenario_megastep.launches
        return out, wall, scenario_step.cuda_pipeline_megastep.launches

    def unsupervised(tag):
        return pipeline.pipeline_sweep(
            key, to_state(arrays, dev), R_FULL,
            checkpoint_path=os.path.join(SUP_DIR, tag + "_{round}.npz"), **sup_plain_kw(dev))

    def supervised(tag, **kw):
        return supervisor.supervised_sweep(
            key, to_state(arrays, dev), R_FULL,
            checkpoint_path=os.path.join(SUP_DIR, tag + "_{round}.npz"), **sup_plain_kw(dev),
            **kw)

    walls = {"unsupervised": [], "supervised": []}
    clean = None
    for i, leg in enumerate(("unsupervised", "supervised", "supervised", "unsupervised")):
        tag = f"{leg}_{i}"
        if leg == "unsupervised":
            out, wall, k1 = counted(lambda: unsupervised(tag))
        else:
            out, wall, k1 = counted(lambda: supervised(tag, health_every=1))
            sup = out["supervisor"]
            check((sup["attempts"], sup["retries"], sup["stalls"]) == (1, 0, 0),
                  f"a clean supervised run: {sup}")
            check(out["stats"]["health_samples"] == n_dispatch,
                  f"health samples {out['stats']['health_samples']}")
            margin = obs_registry.default_registry().get("health_watchdog_margin_s")
            check(margin is not None and np.isfinite(margin.value),
                  "no finite watchdog margin")
            health = {"samples": out["stats"]["health_samples"],
                      "watchdog_margin_s": margin.value, "timeout_s": sup["timeout_s"]}
        check(k1 == n_dispatch, f"{tag}: {k1} K1 launches")
        clean = clean or out
        same_campaign(out, clean, names, tag)
        walls[leg].append(wall)
    ratio = sum(walls["supervised"]) / sum(walls["unsupervised"])
    same_campaign(clean, main_out, names,
                  f"{RPD_SUP} rounds a dispatch against phase 4's {RPD_FULL}")

    plan = chaos.load(TRANSIENT_PLAN)
    drill, drill_wall, drill_k1 = counted(lambda: supervised(
        "drill", chaos=plan,
        config=supervisor.SupervisorConfig(timeout_s=0.1, backoff_base_s=0.01)))
    same_campaign(drill, clean, names, "transient storm")
    dsup = drill["supervisor"]
    check(dsup["degrades"] == 1 and dsup["depth"] == 1, f"the storm's degrade: {dsup}")
    check(dsup["stalls"] == 1 and dsup["injected"] == 7, f"the storm's faults: {dsup}")
    corrupt = sorted(f for f in os.listdir(SUP_DIR) if f.endswith(".corrupt"))
    check(corrupt == ["drill_16.npz.corrupt", "drill_16.npz.rows.npz.corrupt"],
          f"quarantined files {corrupt}")  # the checkpoint and its sidecar

    spec = scenario_spec.load(COALITION)
    block = scenario_compile.compile_scenario(spec, B_FULL, CAP_FULL, sparse=True)
    fatal = chaos.from_dict({"name": "fatal-after-round-4", "faults": [
        {"round": 6, "kind": "fatal", "phase": "retire"}]})
    scen, scen_wall, _ = counted(lambda: supervisor.supervised_sweep(
        rng.key(seed + 1, device=dev), to_state(s_arrays, dev), scenario=block, chaos=fatal,
        depth=2, rounds_per_dispatch=RPD_SUP_SCEN, collect_decisions=True, engine="cuda",
        device=dev, checkpoint_every=SUP_SCEN_EVERY,
        checkpoint_path=os.path.join(SUP_DIR, "coalition_{round}.npz"),
        config=supervisor.SupervisorConfig(backoff_base_s=0.01)))
    same_campaign(scen, s_main_out, names + ("leaders",), "supervised coalition")
    ssup = scen["supervisor"]
    check((ssup["attempts"], ssup["recoveries"]) == (2, 1), f"the coalition's recovery {ssup}")

    template = os.path.join(SUP_DIR, "killed_{round}.npz")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.supervised_kill_child("
                               f"{seed}, {template!r})"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    child_wall = time.perf_counter() - t0
    check(child.returncode == -signal.SIGKILL,
          f"the kill child exited {child.returncode}: {child.stderr[-800:]}")
    left = [r for r, _ in snapshot.checkpoint_paths(template)]
    rerun, rerun_wall, rerun_k1 = counted(lambda: supervised("killed"))
    same_campaign(rerun, clean, names, "kill and rerun")
    rsup = rerun["supervisor"]
    check((rsup["history_start"], rsup["attempts"]) == (0, 1), f"the rerun: {rsup}")

    free, total = torch.cuda.mem_get_info(dev)
    try:
        torch.empty(2 * total, dtype=torch.uint8, device=dev)
        err = None
    except torch.cuda.OutOfMemoryError as e:
        err = e
    check(err is not None, "an allocation of twice the card did not raise")
    attribution = supervisor.fault_attribution(err)
    check(attribution == {"fault": "oom", "error": f"OutOfMemoryError: {err}"[:200]},
          f"a real OOM is attributed {attribution}")
    del err
    torch.cuda.empty_cache()

    first = replay_first_plain_dispatch(dev, seed, arrays, clean, RPD_SUP, int_ops_per_s)
    sup_path = {"path": f"supervised_full_width: the clean campaign's first dispatch "
                        f"({RPD_SUP} rounds)",
                "launches": launches["plain"], "max_abs_err": first["err"],
                "shape": first["shape"], "ms_each": first["ms"],
                "plain_ms_each": first["plain_ms"], "bound_ms_each": first["bound_ms"],
                "bound_by": first["bound_by"]}
    del first
    b1 = supervised_b1(dev, SUP_B1_ROTATIONS)

    emit({"phase": "supervised_full_width", "B": B_FULL, "capacity": CAP_FULL,
          "rounds": R_FULL, "rounds_per_dispatch": RPD_SUP, "checkpoint_every": SUP_EVERY,
          "keep_last": SUP_KEEP, "card": card, "bit_equal": True,
          "clean": {"wall_s_unsupervised": walls["unsupervised"],
                    "wall_s_supervised": walls["supervised"],
                    "ratio_supervised_to_unsupervised": ratio, "k1_launches": n_dispatch,
                    "health": health, "run_id": clean["stats"]["run_id"]},
          "drill": {"plan": os.path.basename(TRANSIENT_PLAN), "wall_s": drill_wall,
                    "k1_launches": drill_k1, "quarantined": corrupt,
                    **{k: dsup[k] for k in ("attempts", "retries", "recoveries", "degrades",
                                            "stalls", "lost_rounds", "injected",
                                            "rounds_per_dispatch")}},
          "scenario": {"spec": os.path.basename(COALITION), "rounds": spec.rounds,
                       "rounds_per_dispatch": RPD_SUP_SCEN, "wall_s": scen_wall,
                       "fault": "fatal at the retire of [6, 8)", **ssup},
          "kill_and_rerun": {"plan": os.path.basename(KILL_PLAN),
                             "child_exit": child.returncode, "child_wall_s": child_wall,
                             "checkpoints_left": left, "rerun_wall_s": rerun_wall,
                             "rerun_k1_launches": rerun_k1, **rsup},
          "real_oom": {"bytes_asked": 2 * total, "free_bytes": free, **attribution},
          "first_dispatch_replayed": {k: v for k, v in sup_path.items() if k != "path"},
          "b1_supervision_cost": b1, "kernel_launches": launches})
    shutil.rmtree(SUP_DIR, ignore_errors=True)
    return launches["plain"], launches["scenario"], sup_path


# -- K2: the fused signed sweep ---------------------------------------------


def k2_inputs(rs, B, n, dev):
    """Random K2 inputs: faulty leaders in every third instance, random
    leaders, dead generals (an all-dead row), random table verdicts.  At
    n >= 4, every other instance from the fourth on keeps only 4 to 8
    generals alive: a faulty leader, a traitor lieutenant and the rest
    random, with valid tables, so round-1 coins and relay draws decide
    its rounds (with many honest generals both values reach everyone
    and no draw matters)."""
    faulty = rs.random((B, n)) < 0.3
    faulty[::3, 0] = True
    arrays = dict(
        order=rs.integers(0, 2, B).astype(np.int8),
        leader=np.where(rs.random(B) < 0.5, 0, rs.integers(0, n, B)).astype(np.int32),
        faulty=faulty,
        alive=rs.random((B, n)) < 0.8,
        ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)),
    )
    arrays["alive"][1] = False
    ok = rs.random((B, 2)) < 0.85
    if n >= 4:
        for b in range(3, B, 2):
            slots = rs.choice(n, int(rs.integers(4, min(n, 8) + 1)), replace=False)
            arrays["alive"][b] = False
            arrays["alive"][b, slots] = True
            arrays["leader"][b] = slots[0]
            arrays["faulty"][b, slots[:2]] = True
            ok[b] = True
    seed = torch.tensor([int(rs.integers(-2**31, 2**31))], dtype=torch.int32, device=dev)
    return seed, to_state(arrays, dev), torch.tensor(ok, device=dev)


def k2_args(seed, state, ok, rounds, m=M_SIGNED):
    return (seed, state.order, state.leader, state.faulty, state.alive, ok, m, rounds)


def seed_moved(args, want):
    """Decisions of the plain version that change when only the seed
    does: above 0, draws decided the outputs compared at this seed."""
    other = torch.bitwise_xor(args[0], 1)
    return int((sweep_step.plain_fused_signed_sweep_step(other, *args[1:]) != want).sum())


def phase_k2_middle(dev, rs):
    B = 256
    for n in (1, 5, 8, 37, 128, 1024):
        errs, moved = {}, {}
        for m in (1, 3):
            for rounds in (1, 35):
                seed, st, ok = k2_inputs(rs, B, n, dev)
                args = k2_args(seed, st, ok, rounds, m)
                got = sweep_step.fused_signed_sweep_step(*args)
                want = sweep_step.plain_fused_signed_sweep_step(*args)
                sync()
                name = f"m{m}_rounds{rounds}"
                errs[name] = max_abs_err([(got, want)])
                moved[name] = seed_moved(args, want)
        check(all(e == 0 for e in errs.values()), f"K2 differs from plain at n={n}: {errs}")
        # with one general no draw can matter; elsewhere the few-alive
        # instances must make some decision depend on the draws
        check(n < 4 or all(v > 0 for v in moved.values()),
              f"no decision at n={n} depended on a draw: {moved}")
        emit({"phase": "k2_vs_plain_middle", "B": B, "n": n, "max_abs_err": errs,
              "decisions_moved_by_seed": moved})


# -- K7, K5, K4, K3: the Ed25519 table verify ---------------------------------

RFC8032 = (  # RFC 8032 section 7.1, tests 1 and 2: (secret key, public key, message, signature)
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
)
SHA_LENGTHS = (0, 1, 32, 111, 112, 127, 128, 300)  # one to three blocks


def le32(v: int) -> bytes:
    return v.to_bytes(32, "little")


def u8(rows, dev) -> torch.Tensor:
    arr = np.stack([np.frombuffer(bytes(r), np.uint8) for r in rows])
    return torch.tensor(arr.reshape(len(rows), -1), device=dev)


def verify_cases():
    """16 lanes of oracle-made signatures: valid ones beside every
    rejection path of tests/test_crypto.py: a corrupted R, S, message or
    key; R's y = p; a key with y = 2 (no square root); the key x = 0 with
    sign 1 (with the forgery it would admit); S + L in place of S; a key
    with y >= p.  Returns byte rows and the oracle's verdicts."""
    P, L = oracle.P, oracle.L
    pks, msgs, sigs = [], [], []
    for i in range(16):
        sk, pk = oracle.keypair(bytes([70 + i]))
        msg = bytes([i]) * 16
        pks.append(pk), msgs.append(msg), sigs.append(bytearray(oracle.sign(sk, pk, msg)))
    sigs[6][0] ^= 1
    sigs[7][40] ^= 1
    msgs[8] = bytes([0xFF]) + msgs[8][1:]
    pks[9] = pks[10]
    sigs[10][:32] = le32(P)
    pks[11] = le32(2)
    pks[12] = bytes([1] + [0] * 30 + [0x80])
    sigs[12] = bytearray(oracle.encode_point(oracle.scalarmult(oracle.BASE, 5)) + le32(5))
    sigs[13][32:] = le32(int.from_bytes(sigs[13][32:], "little") + L)
    pks[14] = le32(P + 3)
    want = [oracle.verify(pk, m, bytes(sg)) for pk, m, sg in zip(pks, msgs, sigs)]
    return pks, msgs, sigs, want


def phase_ed25519_known_answers(dev, rs):
    """Known answers through the card's verify (K7, K5, K4, K3) and sign
    (K5', K5, K4, K8, K6): the oracle's verdicts on every rejection path,
    the RFC 8032 vectors verified and signed, ``sign`` against the
    oracle's on 32 keys with the all-zero secret key, K5 against
    hashlib's digest mod L on random 80-byte messages and K5' against
    hashlib's digest at SHA_LENGTHS."""
    pks, msgs, sigs, want = verify_cases()
    check(want == [True] * 6 + [False] * 9 + [True], f"the oracle's verdicts {want}")
    got = ed25519.verify(u8(pks, dev), u8(msgs, dev), u8(sigs, dev)).tolist()
    check(got == want, f"card verdicts {got} differ from the oracle's {want}")
    for sk, pk, msg, sig in RFC8032:
        args = [u8([bytes.fromhex(x)], dev) for x in (pk, msg, sig)]
        check(ed25519.verify(*args).tolist() == [True], f"RFC 8032 vector {pk[:8]}")
        signed_here = ed25519.sign(u8([bytes.fromhex(sk)], dev), args[0], args[1])
        check(signed_here.cpu().numpy().tobytes().hex() == sig,
              f"the card's sign differs from RFC 8032 vector {pk[:8]}")
        args[1] = u8([bytes.fromhex(msg) + b"x"], dev)
        check(ed25519.verify(*args).tolist() == [False], f"RFC 8032 vector {pk[:8]}, bad msg")
    sks = [oracle.secret_from_seed(f"smoke:{i}".encode()) for i in range(32)]
    sks[0] = bytes(32)
    pks = [oracle.publickey(sk) for sk in sks]
    msgs = [signed.order_message(i, i % 3) for i in range(32)]
    got_sigs = ed25519.sign(u8(sks, dev), u8(pks, dev), u8(msgs, dev)).cpu().numpy()
    check([s.tobytes() for s in got_sigs] == [oracle.sign(*t) for t in zip(sks, pks, msgs)],
          "the card's sign differs from the oracle's")
    msg80 = rs.integers(0, 256, (256, 80), dtype=np.uint8)
    h = sha512.sha512_mod_l(torch.tensor(msg80, device=dev)).cpu().numpy()
    for m, got_h in zip(msg80, h):
        digest = int.from_bytes(hashlib.sha512(m.tobytes()).digest(), "little")
        check(int.from_bytes(got_h.tobytes(), "little") == digest % oracle.L,
              "K5 differs from hashlib's digest mod L")
    for nbytes in SHA_LENGTHS:
        msg = rs.integers(0, 256, (16, nbytes), dtype=np.uint8)
        wh, wl, nb = sha512._message_words(torch.tensor(msg, device=dev))
        digests = sha512_kernel.sha512_blocks(wh, wl, nb).cpu().numpy()
        check([d.tobytes() for d in digests] == [hashlib.sha512(m.tobytes()).digest()
                                                 for m in msg],
              f"K5' differs from hashlib's digest at {nbytes} bytes")
    emit({"phase": "ed25519_known_answers", "verdicts": got, "oracle_agrees": True,
          "rfc8032_vectors": len(RFC8032), "rfc8032_signed": True, "oracle_signs": len(sks),
          "k5_hashlib_messages": len(msg80), "k5_prime_hashlib_lengths": list(SHA_LENGTHS),
          "ok": True})


def ed_middle_inputs(rs, S, dev):
    """Inputs for the four kernels at S lanes: the first half real
    signatures of the native signer, then edge values (y at p - 1, p and
    2p - 2, the identity's y = 1, x = 0 with sign 1; scalars 0, 1, 8, 15,
    16, L - 1, L, 2^256 - 1, every nibble 8 and a top nibble of 8, the
    last two carrying out of K4's top window) and random bytes."""
    P, L = oracle.P, oracle.L
    n_sig = max(S // 2, 1)
    sks, pks = signed.commander_keys(n_sig, seed=S)
    msgs, sigs = signed.sign_value_tables(sks, pks, n_values=1)
    msg, sig = msgs[:, 0], sigs[:, 0]
    rand = lambda k, w: rs.integers(0, 256, (k, w), dtype=np.uint8)  # noqa: E731
    edge_y = np.stack([np.frombuffer(le32(v), np.uint8)
                       for v in (P - 1, P, 2 * P - 2, 1, 1 | 1 << 255)])
    edge_s = np.stack([np.frombuffer(le32(v), np.uint8)
                       for v in (0, 1, 8, 15, 16, L - 1, L, 2**256 - 1, int("8" * 64, 16),
                                 (8 << 252) | 5)])
    a_enc = np.concatenate([pks, edge_y, rand(S, 32)])[:S]
    r_enc = np.concatenate([sig[:, :32], edge_y[::-1], rand(S, 32)])[:S]
    m = np.concatenate([msg, rand(S, msg.shape[1])])[:S]
    s_enc = np.concatenate([sig[:, 32:], edge_s, rand(S, 32)])[:S]
    h_tail = np.concatenate([edge_s, rand(S, 32)])[:S - n_sig]
    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return n_sig, t(a_enc), t(r_enc), t(m), t(s_enc), t(h_tail)


def modl_edges():
    """K6's edge values: 0, 2^512 - 1, L - 1, L, 2L, the largest value of
    ``muladd_bytes`` (k = a = r = 2^256 - 1, also the word form's first
    fold at its most negative: low half 0, high half all ones); 2^256 m
    for small m; kL and kL +- 1 up to the largest k below 2^512; all ones
    in one word -> uint8 [E, 64]."""
    L = oracle.L
    vals = [0, 2**512 - 1, L - 1, L, 2 * L, (2**256 - 1) * 2**256]
    vals += [m << 256 for m in (1, 2, 15, 16, 17)]
    vals += [k * L + e for k in (1, 2, 3, 2**256 // L, 2**512 // L) for e in (-1, 0, 1)]
    vals += [0xFFFFFFFF << (32 * i) for i in range(16)]
    return np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8)
                     for v in vals if v < 2**512])


def modl_inputs(rs, S, dev):
    """K6's inputs at S lanes: ``modl_edges``, then muladd_bytes of random
    scalars and random bytes."""
    edges = modl_edges()
    kar = [torch.tensor(rs.integers(0, 256, (S, 32), dtype=np.uint8), device=dev)
           for _ in range(3)]
    mixed = torch.cat([scalar.muladd_bytes(*kar)[:S // 2],
                       torch.tensor(rs.integers(0, 256, (S, 64), dtype=np.uint8), device=dev)])
    return torch.cat([torch.tensor(edges, device=dev), mixed])[:S].contiguous()


def phase_ed25519_middle(dev, rs):
    """K7, K5, K5', K6, K4, K8 and K3 against their plain versions at S
    lanes: every output bit-equal (points as canonical encodings).  K8
    compresses the identity, B and K4's [s]B (Z != 1); K5' hashes
    messages of one, two and three blocks in turn."""
    table = ed25519.fixed_base_table(dev)
    ends = torch.cat([ed25519.encode_point(ed25519.identity((1,), dev)),
                      ed25519.encode_point(ed25519.base_point((1,), dev))])
    for i, S in enumerate((1, 37, 1024, 4096)):
        n_sig, a_enc, r_enc, msg, s_enc, h_tail = ed_middle_inputs(rs, S, dev)
        enc = torch.cat([a_enc, r_enc])
        pts, ok = decompress.decompress(enc)
        errs = {"K7": max_abs_err(zip((pts, ok), decompress.plain_decompress(enc)))}
        wh, wl, nb = sha512._message_words(torch.cat([r_enc, a_enc, msg], dim=1))
        h = sha512_kernel.sha512_blocks_mod_l(wh, wl, nb)
        errs["K5"] = max_abs_err([(h, sha512_kernel.plain_sha512_blocks_mod_l(wh, wl, nb))])
        left = treeadd.fixed_base_fold(s_enc, table)
        errs["K4"] = max_abs_err([(left, treeadd.plain_fixed_base_fold(s_enc, table))])
        h3 = torch.cat([h[:n_sig], h_tail])
        got = ladder.window_verify(pts[:S], h3, pts[S:], left)
        errs["K3"] = max_abs_err([(got, ladder.plain_window_verify(pts[:S], h3, pts[S:], left))])
        pts8 = torch.cat([ends, left])[:S].contiguous()
        errs["K8"] = max_abs_err([(powchain.compress(pts8), powchain.plain_compress(pts8))])
        wide = modl_inputs(rs, S, dev)
        errs["K6"] = max_abs_err([(modl.reduce_mod_l_planes(wide),
                                   modl.plain_reduce_mod_l(wide))])
        nbytes = (1, 200, 300, 111)[i]  # 1, 2, 3 and 1 blocks
        wh, wl, nb = sha512._message_words(
            torch.tensor(rs.integers(0, 256, (S, nbytes), dtype=np.uint8), device=dev))
        errs["K5'"] = max_abs_err([(sha512_kernel.sha512_blocks(wh, wl, nb),
                                    sha512_kernel.plain_sha512_blocks(wh, wl, nb))])
        sync()
        check(all(e == 0 for e in errs.values()), f"a kernel differs from plain at S={S}: {errs}")
        check(bool(got[:n_sig].all()), f"a real signature's verdict was False at S={S}")
        emit({"phase": "ed25519_vs_plain_middle", "S": S, "max_abs_err": errs,
              "valid_encodings": int(ok.sum()), "true_verdicts": int(got.sum()),
              "signature_lanes": n_sig, "k5_prime_blocks": nb})


def reset_ed_launches():
    for module in (decompress, sha512_kernel, treeadd, ladder, modl, powchain, fieldmul_probe):
        module.reset_launches()


def ed_launches():
    return {key: fn.launches for key, (_, fn, *_) in ED_KERNELS.items()}


def timed_setup(dev, sign_device, verify="exact"):
    """One full-width setup of the route after a throwaway key-set has
    warmed it, as bench.py warms its setup; the launches of its own run."""
    signed.setup_signed_tables(B_SIGNED, seed=1, device=dev, sign_device=sign_device,
                               verify=verify)
    sync()
    reset_ed_launches()
    out = signed.setup_signed_tables(B_SIGNED, device=dev, sign_device=sign_device,
                                     verify=verify)
    return out, ed_launches()


def recorded_setup(dev, sign_device, verify, sigs):
    """The timed setup of the route once more (the same seed, so the same
    keys and signatures), its kernel dispatches recorded; its tables and
    verdicts held against the timed run's."""
    with recording(ED_WRAPPERS) as calls:
        out = signed.setup_signed_tables(B_SIGNED, device=dev, sign_device=sign_device,
                                         verify=verify)
    check(np.array_equal(out[3], sigs) and bool(out[4].all()),
          f"the recorded setup ({verify}, sign_device={sign_device}) differs from the timed one")
    return calls


def phase_signed_setup(dev, rs):
    """The sweep's setup at full width by both routes, one fetch at the
    end of each.  The default on the card signs there (K5', K5, K4, K8,
    K6) in one chunk and verifies (K7, K5, K4, K3); its queueing, up to
    the fetch, runs once under torch.cuda.set_sync_debug_mode("error"),
    on a throwaway key-set.  Its signatures are held byte for byte
    against the native host signer's.  The host-sign route (the
    reference's BA_TPU_SIGN_DEVICE=0 mode) signs chunk c + 1 on the host
    while the card verifies chunk c.  Then a copy with every 7th
    signature corrupted (R, S or the message in turn) verifies on the
    card, held against the native host verifier on all 20 480; and the
    warm device sign and verify of the whole batch (CUDA events) beside
    the host verify of the same tables.  Last, each route's timed setup
    once more, its dispatches recorded for the kernels line."""
    (sks, pks, msgs, sigs, ok, timings), launches = timed_setup(dev, None)
    check(launches == DEVICE_SETUP_LAUNCHES, f"device-sign setup launches {launches}")
    check(timings["device_sign"] and timings["chunks"] == signed.DEVICE_SIGN_CHUNKS == 1
          and timings["verify_route"] == "device", f"the default setup's route {timings}")
    check(tuple(ok.shape) == (B_SIGNED, 2) and bool(ok.all()),
          "a device-signed table signature failed to verify")
    t0 = time.perf_counter()
    host_m, host_s = signed.sign_value_tables(sks, pks)
    native_sign_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(msgs, host_m) and np.array_equal(sigs, host_s),
          f"{int((sigs != host_s).any(-1).sum())} card signatures differ from the host signer's")

    torch.cuda.set_sync_debug_mode("error")
    try:
        queued = signed.queue_signed_tables(B_SIGNED, seed=2, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(signed.drain_signed_tables(queued)[4].all()), "the sync-checked setup failed")

    (h_sks, h_pks, h_msgs, h_sigs, h_ok, h_timings), h_launches = timed_setup(dev, False)
    check(h_launches == HOST_SETUP_LAUNCHES, f"host-sign setup launches {h_launches}")
    check(not h_timings["device_sign"] and h_timings["chunks"] == signed.SETUP_CHUNKS,
          f"the host-sign setup's route {h_timings}")
    check(bool(h_ok.all()) and np.array_equal(h_sigs, sigs) and np.array_equal(h_pks, pks),
          "the host-sign setup's tables differ from the device-sign setup's")

    (_, r_pks, _, r_sigs, r_ok, r_timings), r_launches = timed_setup(dev, None, "rlc")
    check(r_launches == RLC_SETUP_LAUNCHES, f"rlc setup launches {r_launches}")
    check(r_timings["verify"] == "rlc" and r_timings["device_sign"]
          and r_timings["chunks"] == 1, f"the rlc setup's route {r_timings}")
    check(bool(r_ok.all()) and np.array_equal(r_sigs, sigs) and np.array_equal(r_pks, pks),
          "the rlc setup's verdicts or tables differ from the device-sign setup's")
    torch.cuda.set_sync_debug_mode("error")
    try:
        queued = signed.queue_signed_tables(B_SIGNED, seed=3, device=dev, verify="rlc")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(signed.drain_signed_tables(queued)[4].all()), "the sync-checked rlc setup failed")

    flat_m, flat_s = msgs.reshape(-1, msgs.shape[-1]).copy(), sigs.reshape(-1, 64).copy()
    idx = np.arange(0, len(flat_s), 7)
    kind = np.arange(len(idx)) % 3
    flip = rs.integers(1, 256, len(idx)).astype(np.uint8)
    flat_s[idx[kind == 0], rs.integers(0, 32, (kind == 0).sum())] ^= flip[kind == 0]
    flat_s[idx[kind == 1], rs.integers(32, 64, (kind == 1).sum())] ^= flip[kind == 1]
    flat_m[idx[kind == 2], rs.integers(0, flat_m.shape[1], (kind == 2).sum())] ^= flip[kind == 2]
    bad_m, bad_s = flat_m.reshape(msgs.shape), flat_s.reshape(sigs.shape)
    got = signed.verify_received(pks, bad_m, bad_s, device=dev).cpu().numpy()
    t0 = time.perf_counter()
    want = signed.verify_host_exact(pks, bad_m, bad_s)
    host_bad_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(got, want), f"{int((got != want).sum())} card verdicts differ from the host's")
    got_rlc = signed.verify_received(pks, bad_m, bad_s, device=dev, verify="rlc").cpu().numpy()
    check(np.array_equal(got_rlc, want),
          f"{int((got_rlc != want).sum())} rlc-route verdicts differ from the host's")

    tables = [torch.tensor(a, device=dev) for a in (pks, msgs, sigs)]
    verify_ms = time_cuda(lambda: signed.verify_received(*tables, device=dev), reps=5)
    sign_ms = time_cuda(lambda: signed.sign_value_tables_device(sks, tables[0], device=dev),
                        reps=5)
    t0 = time.perf_counter()
    signed.verify_host_exact(pks, msgs, sigs)
    host_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "signed_setup", "batch": B_SIGNED, "signatures": 2 * B_SIGNED,
          "device_sign": {**timings, "kernel_launches": launches, "all_valid": True,
                          "signatures_equal_native": True, "sync_checked": True},
          "host_sign": {**h_timings, "kernel_launches": h_launches, "all_valid": True},
          "rlc": {**r_timings, "kernel_launches": r_launches, "all_valid": True,
                  "sync_checked": True},
          "corrupted": len(idx), "rejected": int((~want).sum()), "card_equals_host": True,
          "rlc_route_equals_host": True,
          "device_sign_ms": sign_ms, "device_verify_ms": verify_ms,
          "native_sign_ms": native_sign_ms, "host_verify_ms": host_ms,
          "host_verify_corrupted_ms": host_bad_ms})
    paths = [("device-sign setup", recorded_setup(dev, None, "exact", sigs), launches, 1),
             ("host-sign setup", recorded_setup(dev, False, "exact", sigs), h_launches, 1),
             ("rlc setup", recorded_setup(dev, None, "rlc", sigs), r_launches, 1)]
    return ok, paths, {"device": timings, "host": h_timings, "rlc": r_timings}


def signed_seeds(dev, steps, buckets):
    """[steps, buckets] int32 seeds: the last word of
    ``fold_in(fold_in(key(6), step), bucket)``, as ``bench.py`` seeds
    its fused step, reinterpreted as int32."""
    k = rng.fold_in(rng.key(6, device=dev)[None, :], torch.arange(steps, device=dev))
    k = rng.fold_in(k[:, None, :], torch.arange(buckets, device=dev)[None, :])
    last = k[..., 1]
    return torch.where(last >= 2**31, last - 2**32, last).to(torch.int32)


def phase_signed_sweep(dev, ok, card):
    """The signed sweep's timed step, as ``bench.py`` drives and times it:
    per step one 480-round K2 dispatch per bucket and an on-device count
    of its decisions that are not ATTACK (the reference sums each
    dispatch's decisions on the device); one warm-up step, then
    WINDOWS_SIGNED windows of STEPS_SIGNED steps, each timed by host wall
    clock from its first dispatch to the synchronised end.  The seeds
    are derived for every step, in one call, before the first window."""
    states = sweep.bucketed_sweep_states(rng.key(5, device=dev), B_SIGNED, CAP_FULL, 2)
    oks = list(torch.split(ok, [st.batch for st in states]))
    n_steps = 1 + WINDOWS_SIGNED * STEPS_SIGNED
    seeds = signed_seeds(dev, n_steps, len(states))
    not_attack = torch.zeros((), dtype=torch.int64, device=dev)

    def step(it):
        outs = []
        for i, (st, ok_b) in enumerate(zip(states, oks)):
            dec = sweep_step.fused_signed_sweep_step(
                *k2_args(seeds[it, i:i + 1], st, ok_b, ROUNDS_SIGNED))
            not_attack.add_((dec != ATTACK).sum())
            outs.append(dec)
        return outs

    sweep_step.reset_launches()
    first = step(0)
    walls = []
    for w in range(WINDOWS_SIGNED):
        sync()
        t0 = time.perf_counter()
        for it in range(w * STEPS_SIGNED + 1, (w + 1) * STEPS_SIGNED + 1):
            step(it)
        sync()
        walls.append(time.perf_counter() - t0)
    launches = sweep_step.fused_signed_sweep_step.launches
    check(launches == n_steps * len(states), f"K2 launches {launches}")
    for dec, st in zip(first, states):
        check(tuple(dec.shape) == (st.batch, ROUNDS_SIGNED), "decision shape")
    bad = int(not_attack)
    check(bad == 0, f"SM validity: {bad} decisions were not ATTACK")
    per_window = B_SIGNED * ROUNDS_SIGNED * STEPS_SIGNED
    rates = sorted(per_window / w for w in walls)
    median = rates[len(rates) // 2]
    emit({"phase": "signed_sweep_full_width", "batch": B_SIGNED, "capacity": CAP_FULL,
          "buckets": [{"B": st.batch, "n_pad": st.n,
                       "n_mean": float(st.alive.sum(1).float().mean())} for st in states],
          "m": M_SIGNED, "rounds_per_dispatch": ROUNDS_SIGNED, "steps_per_window": STEPS_SIGNED,
          "windows": WINDOWS_SIGNED, "decisions_checked": B_SIGNED * ROUNDS_SIGNED * n_steps,
          "all_attack": True, "window_wall_s": walls,
          "agreement_rounds_per_s": {"best": rates[-1], "median": median, "worst": rates[0],
                                     "spread": (rates[-1] - rates[0]) / median},
          "kernel_launches": launches, "card": card})
    return states, oks, seeds, first, launches, walls


def phase_rate_with_setup(timings, walls, card):
    """The signed sweep's rate with this run's setups charged, at
    bench.py's horizons (bench.py:805-810): h steps of one 480-round
    dispatch per bucket after one setup, the step at the best window's
    pace; for each route: sign and verify on the card (the default, as
    bench.py's accelerator default), sign on the host and verify on the
    card (the reference's BA_TPU_SIGN_DEVICE=0 path), and sign on the card
    with the batch check as the verify (BA_TPU_VERIFY_RLC=1)."""
    step_s = min(walls) / STEPS_SIGNED
    rounds_per_step = B_SIGNED * ROUNDS_SIGNED
    for route, sign, verify in (("device", "device", "exact"), ("host", "host", "exact"),
                                ("rlc", "device", "rlc")):
        total_s = timings[route]["total_s"]
        rates = {f"h{h}": rounds_per_step * h / (total_s + h * step_s)
                 for h in (50, 100, 500, 5000)}
        emit({"phase": "signed_sweep_rate_with_setup", "sign": sign, "verify": verify,
              "setup_total_s": total_s, "step_s": step_s, "agreement_rounds_per_s": rates,
              "card": card})


def phase_faulty_leaders(dev, rs, states, oks):
    """Leaders faulty in every fourth instance of each bucket, and in
    every eighth only the first 4 to 8 generals alive, slot 1 a traitor
    (so draws decide those instances): one 480-round dispatch per bucket
    against the plain version in full, the plain version's decisions
    moving with the seed, and the round-0 histogram of the few-alive
    instances against the port's sm.py composition (threefry)."""
    for i, (st, ok_b) in enumerate(zip(states, oks)):
        faulty, alive = st.faulty.clone(), st.alive.clone()
        faulty[::4, 0] = True
        few = torch.arange(4, st.batch, 8, device=dev)
        n_alive = torch.tensor(rs.integers(4, 9, len(few)), device=dev)
        alive[few] = torch.arange(st.n, device=dev)[None, :] < n_alive[:, None]
        faulty[few, 1] = True
        fst = SimState(st.order, st.leader, faulty, alive, st.ids)
        args = k2_args(torch.tensor([17 + i], dtype=torch.int32, device=dev), fst, ok_b,
                       ROUNDS_SIGNED)
        got = sweep_step.fused_signed_sweep_step(*args)
        want = sweep_step.plain_fused_signed_sweep_step(*args)
        err = max_abs_err([(got, want)])
        check(err == 0, f"faulty-leader dispatch of bucket {i} differs from plain: {err}")
        moved = seed_moved(args, want)
        check(moved > 0, f"bucket {i}: no faulty-leader decision depended on a draw")
        ms = time_cuda(lambda: sweep_step.fused_signed_sweep_step(*args), reps=3)
        k1, k2 = rng.split(rng.key(23 + i, device=dev)).unbind(-2)
        received = round1_broadcast(k1, fst)
        ref = sm.sm_agreement(k2, fst, M_SIGNED, None,
                              signed.sig_valid_from_tables(ok_b, received), received, True)
        h_kernel = torch.bincount(got[few, 0].long(), minlength=3)
        h_ref = torch.bincount(ref["decision"][few].long(), minlength=3)
        band = 6 * len(few) ** 0.5
        check(int((h_kernel - h_ref).abs().max()) < band,
              f"bucket {i} few-alive round-0 histogram {h_kernel.tolist()} "
              f"vs sm.py {h_ref.tolist()}")
        emit({"phase": "signed_faulty_leaders", "bucket": i, "B": fst.batch, "n_pad": fst.n,
              "rounds": ROUNDS_SIGNED, "max_abs_err": err, "kernel_ms": ms,
              "decisions_moved_by_seed": moved, "few_alive_instances": len(few),
              "histogram_round0_few_alive": h_kernel.tolist(),
              "histogram_sm_py_few_alive": h_ref.tolist(), "band": band,
              "histogram_round0_all": torch.bincount(got[:, 0].long(), minlength=3).tolist()})


def k2_philox_calls(state, rounds):
    """Philox calls K2 needs at the least on these inputs.  With an
    honest leader every relay threshold is 0 or 256 (every alive
    recipient gets the order, so an honest general holds it and no one
    holds the other value) and no draw matters; with a faulty one each
    alive recipient needs its round-1 coin, one call per round, which
    for m <= 3 also serves its relay draws (draws 0-3 share a block)."""
    lead = state.leader.long()[:, None]
    faulty_leader = state.faulty.gather(1, lead)[:, 0]
    recipients = state.alive.sum(1) - state.alive.gather(1, lead)[:, 0].long()
    return int((recipients * faulty_leader).sum()) * rounds


def k2_bound(state, philox_calls, rounds, m, int_ops_per_s):
    """(bound ms, bound_by, counts) of one K2 dispatch on these inputs.

    Operations: per round, m relay rounds and the choice over each live
    32-general mask word (ceil(alive / 32) words an instance), and
    ``philox_calls`` Philox calls.  Bytes: each input read once (seed,
    order, leader, faulty, alive, ok), each decision written once.
    """
    B, n = state.faulty.shape
    words = int(((state.alive.sum(1) + 31) // 32).sum())
    ops = words * rounds * (RELAY_WORD_OPS * m + CHOICE_WORD_OPS) + philox_calls * PHILOX_OPS
    nbytes = 4 + B * (1 + 4 + 2) + 2 * B * n + B * rounds
    ops_s, bytes_s = ops / int_ops_per_s, nbytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes",
            {"mask_words": words, "philox_calls": philox_calls, "int_ops": ops, "bytes": nbytes})


def kernel_line_k2(states, oks, seeds, main_decisions, launches, int_ops_per_s):
    """The signed sweep's warm-up step again, per bucket with the main
    path's seed, state, verdicts and shape: the kernel against the plain
    version and against the main path's decisions; its CUDA-event time,
    the plain time and the bound.  The line's numbers are per step (one
    dispatch per bucket), with each bucket's beside them."""
    buckets, err = [], 0
    for i, (st, ok_b) in enumerate(zip(states, oks)):
        args = k2_args(seeds[0, i:i + 1], st, ok_b, ROUNDS_SIGNED)
        got = sweep_step.fused_signed_sweep_step(*args)
        want, plain_ms = timed_plain(lambda: sweep_step.plain_fused_signed_sweep_step(*args))
        err = max(err, max_abs_err([(got, want)]))
        check(torch.equal(got, main_decisions[i]),
              f"main path's warm-up dispatch of bucket {i} differs from the replay")
        ms = time_cuda(lambda: sweep_step.fused_signed_sweep_step(*args), reps=10)
        bound_ms, bound_by, counts = k2_bound(st, k2_philox_calls(st, ROUNDS_SIGNED),
                                              ROUNDS_SIGNED, M_SIGNED, int_ops_per_s)
        buckets.append({"B": st.batch, "n": st.n, "rounds": ROUNDS_SIGNED, "m": M_SIGNED,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, **counts})
    check(err == 0, f"full-width K2 dispatch differs from plain: {err}")
    ops_bound = sum(b["bound_by"] == "operations" for b in buckets) == len(buckets)
    return {"name": "sweep_step", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES,
            "wrapper": "ba_tpu_torch/ops/sweep_step.py:fused_signed_sweep_step",
            "launches": launches, "max_abs_err": err,
            "ms": sum(b["ms"] for b in buckets),
            "plain_ms": sum(b["plain_ms"] for b in buckets),
            "bound_ms": sum(b["bound_ms"] for b in buckets),
            "bound_by": "operations" if ops_bound else "bytes", "library_ms": None,
            "checked_against_plain": True, "per": "step (one dispatch per bucket)",
            "design": K2_DESIGN, "ptxas": PTXAS["sweep_step.cu"], "buckets": buckets}


# -- the crypto kernels' lines: the main paths' own dispatches again ----------


@contextlib.contextmanager
def recording(wrappers, snapshot=False):
    """While open, every call of a wrapper in ``wrappers`` ({key: wrapper})
    made through its module (the port's callers import a wrapper from its
    module at each call) is appended to the yielded list as (key, args,
    kwargs, output, entry); ``entry`` names the outermost
    ``crypto/ed25519.py`` function on the stack, else the caller.  With
    ``snapshot`` the arguments are copied before the call and the output
    after it (a megastep updates its carry in place, and the next
    dispatch updates it again).  While open, a wrapper's ``launches``
    count goes to its stand-in: the recorded runs are not the counted
    ones."""
    calls, saved = [], []
    for key, fn in wrappers.items():
        module = sys.modules[fn.__module__]

        def stand_in(*args, _key=key, _fn=fn, **kw):
            recorded_args = pipeline.fresh_copy(args) if snapshot else args
            out = _fn(*args, **kw)
            frame = sys._getframe(1)
            entry = frame.f_code.co_name
            while frame is not None:
                if frame.f_globals.get("__name__") == ed25519.__name__:
                    entry = frame.f_code.co_name
                frame = frame.f_back
            calls.append((_key, recorded_args, kw,
                          pipeline.fresh_copy(out) if snapshot else out, entry))
            return out

        stand_in.launches = 0
        saved.append((module, fn.__name__, fn))
        setattr(module, fn.__name__, stand_in)
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def dispatch_work(key, args, kw):
    """(lanes, int32 operations, bytes, shape) of one dispatch: field
    multiplies and squarings (FE_MUL_OPS and FE_SQ_OPS int32 operations
    each), SHA-512 blocks and mod-L folds, the least work these inputs
    need; bytes, each input read once and each output written once."""
    S = args[0].shape[0]
    if key in ("K5'", "K5"):
        nb = args[2]
        width, fold_ops = (64, 0) if key == "K5'" else (32, MODL_OPS)
        return (S, S * (SHA_BLOCK_OPS * nb + fold_ops), S * (2 * 8 * 16 * nb + width),
                f"{S} lanes, {nb} blocks")
    if key == "K3'":
        nbytes = args[1].shape[1]
        return (S, S * field_ops(k3p_work(nbytes)), S * (128 + nbytes + 128),
                f"{S} lanes, {8 * nbytes}-bit k")
    if key == "K3' sum":  # the products, S - 1 additions of 9, three doublings
        nz, na = S, args[2].shape[0]
        ops = (nz * field_ops(k3p_work(16)) + na * field_ops(k3p_work(32))
               + 9 * (nz + na - 1) * FE_MUL_OPS + field_ops((13, 9)))
        return (nz + na, ops, nz * (128 + 16) + na * (128 + 32) + 128,
                f"{nz} lanes of 128-bit k + {na} of 256-bit k, summed, times 8")
    if key == "P":
        return (S, S * fieldmul_probe.MULTIPLIES * FE_MUL_OPS, S * 96, f"{S} lanes")
    if key == "K3''":  # the least work that keeps the coordinates, from these bits
        bits = args[1]
        return (S, k3pp_least_ops(bits), S * (128 + bits.shape[1] * bits.element_size() + 128),
                f"{S} lanes, {bits.shape[1]}-bit k")
    if key == "K8''":  # nbits - 1 squarings, a multiply a one bit
        e = args[1]
        work = (bin(e).count("1"), max(e.bit_length() - 1, 0))
        return (S, S * field_ops(work), S * 64,
                f"{S} lanes, e of {e.bit_length()} bits, {work[0]} ones")
    if key in ("K8'", "K8 p-2"):
        return S, S * field_ops(K8P_WORK if key == "K8'" else INV_WORK), S * 64, f"{S} lanes"
    if key == "K4":  # the scalars in, the points out, 65 table entries a lane
        threads = kw.get("threads") or treeadd.threads_per_lane(S)
        table_bytes = min(S * 65 * K4_ENTRY_BYTES, args[1].numel() * args[1].element_size())
        return (S, S * field_ops(K4_WORK), (32 + 128) * S + table_bytes,
                f"{S} lanes, {threads} threads a lane")
    if key == "K8":  # 128 bytes in and 32 out a lane
        return S, k8_least_ops(S), S * (128 + 32), f"{S} lanes"
    ops, lane_bytes = {"K6": (MODL_OPS, 64 + 32),
                       "K7": (field_ops(K7_WORK), 32 + 128 + 1),
                       "K3": (field_ops(K3_WORK), 3 * 128 + 32 + 1)}[key]
    return S, S * ops, S * lane_bytes, f"{S} lanes"


def replay(calls, int_ops_per_s):
    """Each recorded dispatch again on its own inputs: the kernel's output
    held against the recorded one (the path's own) and against its plain
    version's on the same inputs; its CUDA-event time (mean of 10 after a
    warm-up) as the path launches it (``ms``: the wrapper's host cost shows
    where the kernel is shorter) and queued behind a spin (``device_ms``:
    the card's own time), the plain version's (one call, host clock) and the bound
    (``dispatch_work``) at the card's int32 rate or memory rate.
    -> {key: [dispatch, ...]} in launch order."""
    out = {}
    pair = (lambda a, b: list(zip(a, b)) if isinstance(a, tuple) else [(a, b)])  # noqa: E731
    for key, args, kw, recorded, entry in calls:
        _, fn, plain, *_ = ED_KERNELS[key]
        got = fn(*args, **kw)
        want, plain_ms = timed_plain(lambda: plain(*args, **kw))
        check(max_abs_err(pair(got, recorded)) == 0,
              f"{key} replayed ({entry}) differs from its path's own output")
        err = max_abs_err(pair(got, want))
        ms = time_cuda(lambda: fn(*args, **kw), reps=10)
        device_ms = time_cuda(lambda: fn(*args, **kw), reps=10, queued=True)
        lanes, ops, nbytes, shape = dispatch_work(key, args, kw)
        ops_s, bytes_s = ops / int_ops_per_s, nbytes / HBM_BYTES_PER_S
        part = {"what": f"{entry}: {shape}", "lanes": lanes, "max_abs_err": err, "ms": ms,
                "device_ms": device_ms, "plain_ms": plain_ms,
                "bound_ms": max(ops_s, bytes_s) * 1e3,
                "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                "int32_ops": ops, "bytes": nbytes}
        if key == "K8":  # the shipped divsteps' work and the previous design's chain
            part["divsteps_ms_at_rate"] = lanes * K8_SAFEGCD_OPS / int_ops_per_s * 1e3
            part["chain_ms_at_rate"] = lanes * field_ops(K8_WORK) / int_ops_per_s * 1e3
        if key == "K3''":  # an addition at every bit, as a lockstep ladder runs
            part["always_add_ms_at_rate"] = (k3pp_always_add_ops(lanes, args[1].shape[1])
                                             / int_ops_per_s * 1e3)
        out.setdefault(key, []).append(part)
    return out


def totals(parts):
    out = {"device_ms": sum(p["device_ms"] for p in parts)} if all(
        "device_ms" in p for p in parts) else {}
    return {**out, "max_abs_err": max(p["max_abs_err"] for p in parts),
            "ms": sum(p["ms"] for p in parts),
            "plain_ms": sum(p["plain_ms"] for p in parts),
            "bound_ms": sum(p["bound_ms"] for p in parts),
            "bound_by": ("operations" if all(p["bound_by"] == "operations" for p in parts)
                         else "bytes")}


def by_lanes(parts):
    """Dispatches grouped by lane count: each group's count and, per
    dispatch, its mean time, plain time and bound (and the other *_ms
    readings the parts carry)."""
    groups = {}
    for p in parts:
        groups.setdefault(p["lanes"], []).append(p)
    out = {}
    for lanes, ps in sorted(groups.items()):
        n = len(ps)
        out[str(lanes)] = {"dispatches": n, "ms_each": sum(p["ms"] for p in ps) / n,
                           "device_ms_each": sum(p["device_ms"] for p in ps) / n,
                           "plain_ms_each": sum(p["plain_ms"] for p in ps) / n,
                           "bound_ms_each": sum(p["bound_ms"] for p in ps) / n,
                           "bound_by": ps[0]["bound_by"]}
        for k in ("divsteps_ms_at_rate", "chain_ms_at_rate", "always_add_ms_at_rate"):
            if k in ps[0]:
                out[str(lanes)][f"{k}_each"] = sum(p[k] for p in ps) / n
    return out


def kernel_lines_crypto(paths, int_ops_per_s):
    """The Ed25519 kernels' and P's lines.  ``paths``: (path, recorded
    calls, the launches counted on the path's main run, the calls that
    run made of each recorded one).  Every recorded dispatch is replayed
    (``replay``); a path's replayed dispatches of a kernel, times its
    calls, must equal the kernel's launches there, so the replay covers
    every launch of the counted run.  A line gives each path's dispatches
    and sums; its own numbers sum one run of each path (config #3: one
    call of each leg)."""
    replayed = [(path, replay(calls, int_ops_per_s), launches, runs)
                for path, calls, launches, runs in paths]
    lines = []
    for key, (name, fn, _, source, replaces) in ED_KERNELS.items():
        entries = []
        for path, by_key, launches, runs in replayed:
            parts = by_key.get(key, [])
            check(len(parts) * runs == launches[key],
                  f"{key} on {path}: {len(parts)} dispatches replayed x {runs} calls, "
                  f"{launches[key]} launches counted")
            if parts:
                entries.append({"path": path, "launches": launches[key], "calls": runs,
                                **totals(parts), "dispatches": parts})
        line = totals([p for e in entries for p in e["dispatches"]])
        check(line["max_abs_err"] == 0,
              f"{key} differs from its plain version on its paths' inputs: {line['max_abs_err']}")
        if key in ED_DESIGNS:
            line.update(design=ED_DESIGNS[key], ptxas=PTXAS[os.path.basename(source)])
        if key in ("K8", "K5", "K5'", "K6"):
            line["by_lanes"] = by_lanes([p for e in entries for p in e["dispatches"]])
        lines.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "wrapper": f"ba_tpu_torch/ops/{fn.__module__.rsplit('.', 1)[1]}.py:{fn.__name__}",
            "launches": sum(e["launches"] for e in entries), **line, "library_ms": None,
            "checked_against_plain": True,
            "per": "one run of each path (config #3: one call of each leg)", "paths": entries})
    return lines

# -- K3', P and the batch verify: BASELINE config #3 --------------------------


def torsion_point():
    """A small-order point: the first curve point by y whose [L]Q is not
    the identity (tests/test_crypto.py:489)."""
    for y in range(2, 200):
        try:
            q = oracle.decode_point(int(y).to_bytes(32, "little"))
        except ValueError:
            continue
        x, yy = q
        if (-x * x + yy * yy - 1 - oracle.D * x * x * yy * yy) % oracle.P == 0 \
                and oracle.scalarmult(q, oracle.L) != (0, 1):
            return oracle.scalarmult(q, oracle.L)
    raise SmokeFailure("no small-order point in the scan range")


def phase_rlc_known_answers(dev):
    """verify_rlc on the card: a valid batch accepts with pk_group n and
    1; one flipped signature byte rejects; S >= L is flagged in enc_ok
    and rejects; a torsion-malleated signature is rejected by verify and
    accepted by the cofactored batch check, and rejected with S + 1."""
    L = oracle.L
    B, n = 8, 8
    sks, pks = signed.commander_keys(B, seed=41)
    received = np.random.default_rng(41).integers(0, 2, (B, n))
    msgs, sigs = signed.sign_received(sks, pks, received)
    pk, msg, sig = (torch.tensor(a, device=dev) for a in
                    (np.repeat(pks, n, axis=0), msgs.reshape(B * n, -1), sigs.reshape(B * n, 64)))
    z = torch.tensor(signed.fresh_rlc_coeffs(B * n), device=dev)
    out = {}
    for group in (n, 1):
        ok, enc = ed25519.verify_rlc(pk, msg, sig, z, pk_group=group)
        check(bool(ok) and bool(enc.all()), f"a valid batch rejected at pk_group {group}")
        out[f"valid_pk_group_{group}"] = True
    flipped = sig.clone()
    flipped[13, 40] ^= 1
    ok, enc = ed25519.verify_rlc(pk, msg, flipped, z, pk_group=n)
    check(not bool(ok) and bool(enc.all()), "one flipped signature byte was accepted")
    big = sig.clone()
    big[21, 32:] = 0xFF
    ok, enc = ed25519.verify_rlc(pk, msg, big, z, pk_group=n)
    check(not bool(ok) and not bool(enc[21]) and int(enc.sum()) == B * n - 1,
          "S >= L was not flagged")
    # torsion: lane 1 offsets its own R by a small-order point and re-signs
    sks, pks = signed.commander_keys(16, seed=7)
    tmsgs = [signed.order_message(i, i & 1) for i in range(16)]
    tsigs = [oracle.sign(sk, pkb.tobytes(), m) for sk, pkb, m in zip(sks, pks, tmsgs)]
    h = hashlib.sha512(sks[1]).digest()
    a = oracle._clamp(h[:32])
    r = oracle._hint(h[32:] + tmsgs[1]) % L
    r_enc = oracle.encode_point(oracle.edwards_add(oracle.scalarmult(oracle.BASE, r),
                                                   torsion_point()))
    s = (r + oracle._hint(r_enc + pks[1].tobytes() + tmsgs[1]) % L * a) % L
    tsigs[1] = r_enc + le32(s)
    check(not oracle.verify(pks[1].tobytes(), tmsgs[1], tsigs[1]), "the oracle accepted torsion")
    tpk, tmsg, tsig = torch.tensor(pks, device=dev), u8(tmsgs, dev), u8(tsigs, dev)
    per_sig = ed25519.verify(tpk, tmsg, tsig).tolist()
    check(per_sig == [True, False] + [True] * 14, f"per-signature verdicts {per_sig}")
    tz = torch.tensor(signed.fresh_rlc_coeffs(16), device=dev)
    ok, enc = ed25519.verify_rlc(tpk, tmsg, tsig, tz)
    check(bool(ok) and bool(enc.all()), "the cofactored batch check rejected torsion")
    tsig[1, 32:] = torch.tensor(np.frombuffer(le32((s + 1) % L), np.uint8), device=dev)
    check(not bool(ed25519.verify_rlc(tpk, tmsg, tsig, tz)[0]), "S + 1 was accepted")
    emit({"phase": "rlc_known_answers", **out, "flipped_byte_rejects": True,
          "s_ge_l_flagged": True, "torsion_per_sig_rejects": True, "torsion_rlc_accepts": True,
          "torsion_s_plus_1_rejects": True, "ok": True})


def k3p_inputs(rs, S, nbytes, dev):
    """K3''s lanes at S: the identity, B, [s]B from K4 (Z != 1), then
    decompressed keys; scalars 0, 1, 8, 15, 16, L - 1 (cut to nbytes), all
    ones, top nibbles of 8 and 15 (the recoding carries out of the top),
    then random bytes."""
    ends = torch.cat([ed25519.encode_point(ed25519.identity((1,), dev)),
                      ed25519.encode_point(ed25519.base_point((1,), dev))])
    sb = treeadd.fixed_base_fold(
        torch.tensor(rs.integers(0, 256, (4, 32), dtype=np.uint8), device=dev),
        ed25519.fixed_base_table(dev))
    keys = torch.tensor(signed.commander_keys(S, seed=S + nbytes)[1], device=dev)
    pts = torch.cat([ends, sb, decompress.decompress(keys)[0]])[:S].contiguous()
    top = 2 ** (8 * nbytes) - 1
    edges = np.stack([np.frombuffer(v.to_bytes(nbytes, "little"), np.uint8)
                      for v in (0, 1, 8, 15, 16, (oracle.L - 1) & top, top,
                                8 << (8 * nbytes - 4), 15 << (8 * nbytes - 4))])
    k = np.concatenate([edges, rs.integers(0, 256, (S, nbytes), dtype=np.uint8)])[:S]
    return pts, torch.tensor(np.ascontiguousarray(k), device=dev)


def phase_k3p_middle(dev, rs):
    """K3' (per lane, 32-byte k) and its sum (16-byte R set and 32-byte A
    set, each alone and both) and P against their plain versions at S in
    {1, 37, 4096}: encodings bit-equal."""
    for S in (1, 37, 4096):
        r, z = k3p_inputs(rs, S, 16, dev)
        a, w = k3p_inputs(rs, S, 32, dev)
        errs = {"K3'_256bit": max_abs_err([(ladder.window_mult(a, w),
                                            ladder.plain_window_mult(a, w))])}
        for label, sets in (("R", (r, z, a[:0], w[:0])), ("A", (r[:0], z[:0], a, w)),
                            ("both", (r, z, a[: S // 3 + 1], w[: S // 3 + 1]))):
            errs[f"K3'_sum8_{label}"] = max_abs_err(
                [(ladder.window_mult_sum8(*sets), ladder.plain_window_mult_sum8(*sets))])
        a, b = (torch.tensor(rs.integers(0, 256, (S, 32), dtype=np.uint8), device=dev)
                for _ in range(2))
        errs["P"] = max_abs_err([(fieldmul_probe.fieldmul_probe(a, b),
                                  fieldmul_probe.plain_fieldmul_probe(a, b))])
        sync()
        check(all(e == 0 for e in errs.values()), f"K3' or P differs from plain at S={S}: {errs}")
        emit({"phase": "k3p_probe_vs_plain_middle", "S": S, "max_abs_err": errs})


def leg_seconds(fn, args_of, iters):
    """bench.py's _timed with reps=1: one warm call (args_of(0)), then
    ``iters`` calls timed by host wall clock to the synchronised end."""
    fn(*args_of(0))
    sync()
    t0 = time.perf_counter()
    for i in range(1, iters + 1):
        fn(*args_of(i))
    sync()
    return time.perf_counter() - t0


def spread(times):
    return (max(times) - min(times)) / min(times)


class HostPauses:
    """What held the host while a call was queued: the garbage
    collector's pauses (ms, and how many were full collections) and the
    cudaMalloc calls the caching allocator made."""

    def __init__(self, dev):
        self.dev, self.gc_ms, self.gc_full, self._t0 = dev, 0.0, 0, 0.0

    def _gc(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.gc_ms += (time.perf_counter() - self._t0) * 1e3
            self.gc_full += info["generation"] == 2

    def _mallocs(self):
        return torch.cuda.memory_stats(self.dev).get("num_device_alloc", 0)

    def __enter__(self):
        self.cuda_mallocs = -self._mallocs()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        self.cuda_mallocs += self._mallocs()


def phase_config3(dev, card):
    """BASELINE config #3 as bench_sm1_n64_signed runs it (bench.py:194-394):
    commander_keys(64), n = 64, m = 1; 65 536 verify lanes, the 4096
    signed broadcasts tiled 16 times, 10 variants from default_rng(2),
    every signature valid; 3 reps, each interleaving 3 timed calls (after
    a warm one) of the per-signature verify, verify_rlc(pk_group=64), K3'
    alone on the 256-bit h (the ladder leg) and P; the best rep counts.
    Then the exact SM(1) sm_agreement at B = 64, n = 64, 20 calls a rep,
    best of 3.  Every verdict True; every SM(1) decision ATTACK."""
    n = N_C3
    sks, pks = signed.commander_keys(B_C3)
    tile = -(-NV_C3 // (B_C3 * n))
    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    pk_rows = np.tile(np.repeat(pks, n, axis=0), (tile, 1))[:NV_C3]
    pk_flat = t(pk_rows)
    gen = np.random.default_rng(2)
    variants, host_rows = [], []
    for _ in range(1 + REPS_C3 * ITERS_C3):
        msgs, sigs = signed.sign_received(sks, pks, gen.integers(0, 2, (B_C3, n)))
        host_rows.append((np.tile(msgs.reshape(B_C3 * n, -1), (tile, 1))[:NV_C3],
                          np.tile(sigs.reshape(B_C3 * n, 64), (tile, 1))[:NV_C3]))
        variants.append((pk_flat, *(t(a) for a in host_rows[-1])))
    zs = [t(signed.fresh_rlc_coeffs(NV_C3)) for _ in variants]
    ladder_in = []  # (points, h) a variant, on the card before the clock starts
    for pk_v, msg_v, sig_v in variants:
        pts, _ = ed25519.decompress(pk_v)
        h = sha512.sha512_mod_l(torch.cat([sig_v[:, :32], pk_v, msg_v], dim=1))
        ladder_in.append((pts, h))
    fm_gen = np.random.default_rng(11)
    fm_in = [tuple(t(fm_gen.integers(0, 256, (NV_C3, 32), dtype=np.uint8)) for _ in range(2))
             for _ in range(FM_VARIANTS)]
    sync()

    bad = torch.zeros(2, dtype=torch.int64, device=dev)  # per-signature, rlc rejects
    first = {}

    def per_sig(pk, msg, sig):
        ok = ed25519.verify(pk, msg, sig)
        first.setdefault("verify", ok)
        bad[0] += (~ok).sum()
        return ok

    def rlc(pk, msg, sig, z):
        ok = ed25519.verify_rlc(pk, msg, sig, z, pk_group=n)[0]
        first.setdefault("rlc", ok)
        bad[1] += (~ok).to(torch.int64)
        return ok

    def ladder_leg(pts, h):
        return first.setdefault("ladder", ladder.window_mult(pts, h))

    def probe(a, b):
        return first.setdefault("probe", fieldmul_probe.fieldmul_probe(a, b))

    reset_ed_launches()
    legs = {"verify": [], "probe": [], "rlc": [], "ladder": []}
    nv = len(variants)
    for r in range(REPS_C3):
        at = lambda i, r=r: r * ITERS_C3 + i  # noqa: E731
        legs["verify"].append(leg_seconds(per_sig, lambda i: variants[at(i) % nv], ITERS_C3))
        legs["probe"].append(leg_seconds(probe, lambda i: fm_in[at(i) % FM_VARIANTS], ITERS_C3))
        legs["rlc"].append(leg_seconds(
            rlc, lambda i: (*variants[at(i) % nv], zs[at(i) % nv]), ITERS_C3))
        legs["ladder"].append(leg_seconds(ladder_leg, lambda i: ladder_in[at(i) % nv], ITERS_C3))
    launches = ed_launches()
    check(bad.tolist() == [0, 0], f"config #3 rejects (per-signature, rlc): {bad.tolist()}")
    with recording(ED_WRAPPERS) as calls:  # one call of each leg on its first inputs
        again = {"verify": per_sig(*variants[0]), "rlc": rlc(*variants[0], zs[0]),
                 "ladder": ladder_leg(*ladder_in[0]), "probe": probe(*fm_in[0])}
    check(all(torch.equal(again[k], first[k]) for k in again),
          "a recorded leg differs from its first call in the timed run")
    want = native.verify_batch(pk_rows, *host_rows[0])
    check(np.array_equal(first["verify"].cpu().numpy(), want),
          "the per-signature mask differs from the native host verifier's")

    # one call of each verify again: the host's time to queue it, and the
    # card's from its first launch to its last (CUDA events); beside them
    # the collector's pauses and the cudaMallocs while it was queued
    one_call = {}
    for name, fn in (("verify", lambda: ed25519.verify(*variants[0])),
                     ("rlc", lambda: ed25519.verify_rlc(*variants[0], zs[0], pk_group=n))):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sync()
        with HostPauses(dev) as pauses:
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            queue_ms = (time.perf_counter() - t0) * 1e3
        sync()
        one_call[name] = {"host_queue_ms": queue_ms, "card_ms": start.elapsed_time(end),
                          "gc_ms": pauses.gc_ms, "gc_full": pauses.gc_full,
                          "cuda_mallocs": pauses.cuda_mallocs}

    faulty = torch.zeros((B_C3, n), dtype=torch.bool, device=dev)
    faulty[:, 1] = True
    state = make_state(B_C3, n, order=ATTACK, faulty=faulty, device=dev)
    sig_valid = torch.ones((B_C3, n), dtype=torch.bool, device=dev)
    keys = rng.fold_in(rng.key(3, device=dev)[None, :],
                       torch.arange(1 + REPS_C3 * SM1_ITERS, device=dev))
    not_attack = torch.zeros((), dtype=torch.int64, device=dev)

    def sm1_step(k):
        out = sm.sm_agreement(k, state, 1, None, sig_valid, None, False)
        not_attack.add_((out["decision"] != ATTACK).sum())

    sm1_walls = [leg_seconds(sm1_step, lambda i, r=r: (keys[r * SM1_ITERS + i],), SM1_ITERS)
                 for r in range(REPS_C3)]
    check(int(not_attack) == 0, f"SM(1): {int(not_attack)} decisions were not ATTACK")

    best = {k: min(v) for k, v in legs.items()}
    verifies = NV_C3 * ITERS_C3 / best["verify"]
    ladder_rate = NV_C3 * LADDER_FMULS_PER_LANE * ITERS_C3 / best["ladder"]
    emit({"phase": "config3_sm1_n64_signed", "batch": B_C3, "n": n, "m": 1,
          "verify_batch": NV_C3, "variants": len(variants), "iters": ITERS_C3, "reps": REPS_C3,
          "leg_seconds": legs, "leg_spread": {k: spread(v) for k, v in legs.items()},
          "ed25519_verifies_per_sec": verifies,
          "rlc_batch_verifies_per_sec": NV_C3 * ITERS_C3 / best["rlc"],
          "rlc_speedup_vs_per_sig": best["verify"] / best["rlc"],
          "ladder_fieldmuls_per_sec": ladder_rate,
          "probe_fieldmuls_per_sec": NV_C3 * fieldmul_probe.MULTIPLIES * ITERS_C3 / best["probe"],
          "achieved_fieldmuls_per_sec": verifies * FMULS_PER_VERIFY,
          "pct_of_ladder_rate": 100 * verifies * FMULS_PER_VERIFY / ladder_rate,
          "pct_of_ladder_rate_port_ops": 100 * verifies * VERIFY_OPS * best["ladder"]
          / (NV_C3 * ITERS_C3 * field_ops(K3P_RUN)),
          "one_call": one_call,
          "sm1_rounds_per_sec": B_C3 * SM1_ITERS / min(sm1_walls), "sm1_walls_s": sm1_walls,
          "sm1_spread": spread(sm1_walls), "sm1_iters": SM1_ITERS,
          "verdicts_all_true": True, "native_mask_equal": True, "sm1_all_attack": True,
          "kernel_launches": launches, "card": card})
    return "config #3", calls, launches, REPS_C3 * (1 + ITERS_C3)

# -- K1's slot mode: the coalesced serving batch -----------------------------

# bench.py:1532-1580 (bench_serving): 8 clients x 4 requests, n = 4 at
# capacity 4, 32 rounds 8 a dispatch, seeds 1000 + i, cohorts of 8.
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_ROUNDS, SERVE_RPD = 8, 4, 32, 8
SERVE_COHORT, SERVE_CAP = 8, 4
RPD_COAL = 4   # the full-width cohort's rounds a dispatch (the scenario phase's)
SAMPLE_COAL = 64  # full-width slots held against their own B = 1 runs
SLOT_WRAPPERS = {"K1 slot": scenario_step.cuda_coalesced_megastep}


def slot_flat(out):
    """A coalesced megastep's outputs as one tuple of tensors: the state's
    five, the counter, the strategy plane (scenario mode), the last
    round's majorities, decisions, counter rows and leaders (scenario)."""
    state, sched, strategy, *rest = out
    return (*state.tensors(), sched.counter, *(() if strategy is None else (strategy,)), *rest)


def slot_carry(arrays, seeds, dev, counters, counter=0):
    state = to_state(arrays, dev)
    sched = pipeline.make_slot_key_schedule([rng.key(s, device=dev) for s in seeds], counter)
    return state, sched, convert.slot_counters_from_numpy(counters, dev)


def phase_coalesced_middle(dev, rs):
    """K1's slot mode against the plain ``coalesced_megastep`` on the card:
    plain and scenario modes, B in {1, 8, 64}, n in {4, 33, 300} (the
    block's thread loop wraps at 300), random leaders, dead generals, an
    all-dead row, random strategies and events — every output bit-equal,
    the last round's majorities of every general included."""
    R, errs = 5, {}
    for n in (4, 33, 300):
        for B in (1, 8, 64):
            arrays, events, strategy = random_arrays(rs, B, n, R)
            seeds = [int(v) for v in rs.integers(0, 2**31, B)]
            for scenario in (False, True):
                C = 5 if scenario else 3
                block = rs.integers(0, 100, (B, C))
                outs = []
                for fn in (pipeline.coalesced_megastep, scenario_step.cuda_coalesced_megastep):
                    st, sc, ctr = slot_carry(arrays, seeds, dev, block, counter=2**31 - 3)
                    out = fn(st, sc, convert.strategy_from_numpy(strategy, dev) if scenario
                             else None, ctr,
                             convert.events_from_numpy(events, dev) if scenario else None,
                             rounds=R, scenario=scenario)
                    outs.append(slot_flat(out))
                errs[f"{'scenario' if scenario else 'plain'}_B{B}_n{n}"] = max_abs_err(
                    zip(*outs))
    sync()
    check(all(e == 0 for e in errs.values()), f"slot mode differs from plain: {errs}")
    emit({"phase": "coalesced_vs_plain_middle", "R": R, "max_abs_err": errs})


def serve_requests():
    """bench_serving's requests: (order, faulty generals, seed), n = 4."""
    return [((1, 0)[i % 2], ((2,), (), (1, 3))[i % 3], 1000 + i)
            for i in range(SERVE_CLIENTS * SERVE_PER_CLIENT)]


def serve_cohort(reqs, dev):
    """One coalesced batch of the requests at capacity SERVE_CAP through
    ``coalesced_sweep`` on the kernel (the first n = 4 generals alive,
    leader 0)."""
    B = len(reqs)
    faulty = np.zeros((B, SERVE_CAP), bool)
    for i, (_, fl, _) in enumerate(reqs):
        faulty[i, list(fl)] = True
    arrays = dict(order=np.array([o for o, _, _ in reqs], np.int8),
                  leader=np.zeros(B, np.int32), faulty=faulty,
                  alive=np.ones((B, SERVE_CAP), bool),
                  ids=np.tile(np.arange(1, SERVE_CAP + 1, dtype=np.int32), (B, 1)))
    return pipeline.coalesced_sweep(
        [rng.key(seed, device="cpu") for _, _, seed in reqs], to_state(arrays, dev),
        SERVE_ROUNDS, rounds_per_dispatch=SERVE_RPD, engine="cuda", device=dev)


def phase_coalesced_serving(dev, card):
    """``bench_serving``'s shape (bench.py:1532-1580): 32 requests, each
    run alone (B = 1) and then as 4 cohorts of 8, both through K1's slot
    mode; every request's decisions, counters and last-round majorities
    bit-equal between the legs; requests/s of each leg by host wall clock
    and the per-cohort walls.  Then both legs once more, their dispatches
    recorded for the kernels line."""
    reqs = serve_requests()

    def legs():
        t0 = time.perf_counter()
        alone = [serve_cohort([r], dev) for r in reqs]
        alone_s = time.perf_counter() - t0
        cohorts, walls = [], []
        for lo in range(0, len(reqs), SERVE_COHORT):
            t0 = time.perf_counter()
            cohorts.append(serve_cohort(reqs[lo:lo + SERVE_COHORT], dev))
            walls.append(time.perf_counter() - t0)
        return alone, alone_s, cohorts, walls

    serve_cohort(reqs[:1], dev)  # both shapes warm, off the clock
    serve_cohort(reqs[:SERVE_COHORT], dev)
    scenario_step.reset_launches()
    sync()
    alone, alone_s, cohorts, walls = legs()
    launches = scenario_step.cuda_coalesced_megastep.launches
    per = -(-SERVE_ROUNDS // SERVE_RPD)
    check(launches == per * (len(reqs) + len(cohorts)), f"slot-mode launches {launches}")

    def results(alone, cohorts):
        out = []
        for i, solo in enumerate(alone):
            co, b = cohorts[i // SERVE_COHORT], i % SERVE_COHORT
            check(np.array_equal(co["decisions"][:, b], solo["decisions"][:, 0])
                  and np.array_equal(co["counters"][b], solo["counters"][0])
                  and np.array_equal(co["majorities"][b], solo["majorities"][0]),
                  f"request {i}: coalesced differs from alone")
            out.append((solo["decisions"][:, 0], solo["counters"][0]))
        return out

    first = results(alone, cohorts)
    check(all(c["decisions"].shape == (SERVE_ROUNDS, SERVE_COHORT) for c in cohorts),
          "cohort decisions shape")
    with recording(SLOT_WRAPPERS, snapshot=True) as calls:
        again = results(*legs()[::2])
    check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
              for a, b in zip(first, again)), "the recorded serving run differs")
    n_req = len(reqs)
    emit({"phase": "coalesced_serving", "requests": n_req, "n": 4, "capacity": SERVE_CAP,
          "rounds": SERVE_ROUNDS, "rounds_per_dispatch": SERVE_RPD, "cohort": SERVE_COHORT,
          "alone_wall_s": alone_s, "alone_requests_per_s": n_req / alone_s,
          "coalesced_wall_s": sum(walls), "coalesced_requests_per_s": n_req / sum(walls),
          "cohort_walls_s": walls, "bit_equal_alone_vs_coalesced": True,
          "decisions_attack": int(sum((d == ATTACK).sum() for d, _ in first)),
          "kernel_launches": launches, "card": card})
    return "coalesced serving", calls, launches, 1


def phase_coalesced_full_width(dev, seed, card):
    """A coalesced scenario cohort at full width: B = 10 000 slots at
    capacity 1024 (``make_sweep_state``'s arrays), every slot running
    examples/scenarios/colluding_coalition.json (its B = 1 planes, the
    whole [8, B, 1024] on the card), slot b keyed by key(seed + b), 8
    rounds 4 a dispatch.  Checks: shapes, decisions and leaders in range,
    each slot's unanimity column = rounds and quorum failures = its
    UNDEFINED decisions, and 64 slots against their own B = 1 runs.
    The wall holds the batch's derived run id (the planes fetched and
    hashed after the last dispatch); that derivation is also timed alone
    and its id checked against the run's.  Then the cohort once more,
    its dispatches recorded."""
    spec = scenario_spec.load(COALITION)
    R = spec.rounds
    arrays = sweep_arrays(rng.fold_in(rng.key(seed + 2, device=dev), 1000), B_FULL, CAP_FULL,
                          order=0 if spec.order == "retreat" else 1)
    one = scenario_compile.compile_scenario(spec, 1, CAP_FULL)
    planes = {name: torch.from_numpy(np.ascontiguousarray(getattr(one, name))).to(dev)
              .expand(R, B_FULL, CAP_FULL).contiguous()
              for name in scenario_compile.PLANE_NAMES}
    keys = [rng.key(seed + b, device="cpu") for b in range(B_FULL)]
    kw = dict(rounds_per_dispatch=RPD_COAL, scenario=planes, engine="cuda", device=dev)

    scenario_step.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = pipeline.coalesced_sweep(keys, to_state(arrays, dev), R, **kw)
    wall = time.perf_counter() - t0
    launches = scenario_step.cuda_coalesced_megastep.launches
    check(launches == -(-R // RPD_COAL), f"full-width slot-mode launches {launches}")
    t0 = time.perf_counter()
    material = [pipeline._plane_bytes(planes[k], k) for k in pipeline.EVENT_PLANES]
    rid = flight.derive_run_id("coalesced", R, B_FULL, convert.key_data_to_numpy(
        pipeline.make_slot_key_schedule(keys).key_data).tobytes(), *material)
    run_id_s = time.perf_counter() - t0
    check(rid == out["stats"]["run_id"], f"run id {out['stats']['run_id']}, derived {rid}")
    dec, lead, ctr = out["decisions"], out["leaders"], out["counters"]
    check(dec.shape == (R, B_FULL) and lead.shape == (R, B_FULL)
          and ctr.shape == (B_FULL, 5) and out["majorities"].shape == (B_FULL, CAP_FULL),
          "full-width cohort shapes")
    check(((dec >= 0) & (dec <= 2)).all() and ((lead >= 0) & (lead < CAP_FULL)).all(),
          "decisions or leaders out of range")
    check((ctr[:, 1] == R).all() and (ctr[:, 0] == (dec == 2).sum(0)).all(),
          "per-slot unanimity or quorum-failure counters")
    for b in np.linspace(0, B_FULL - 1, SAMPLE_COAL).astype(int):
        solo = pipeline.coalesced_sweep(
            [keys[b]], to_state({k: v[b:b + 1] for k, v in arrays.items()}, dev), R,
            **dict(kw, scenario={k: v[:, b:b + 1] for k, v in planes.items()}))
        for name in ("decisions", "leaders"):
            check(np.array_equal(out[name][:, b], solo[name][:, 0]), f"slot {b} {name}")
        for name in ("counters", "majorities"):
            check(np.array_equal(out[name][b], solo[name][0]), f"slot {b} {name}")
    with recording(SLOT_WRAPPERS, snapshot=True) as calls:
        again = pipeline.coalesced_sweep(keys, to_state(arrays, dev), R, **kw)
    check(all(np.array_equal(out[k], again[k]) for k in ("decisions", "counters", "leaders",
                                                         "majorities")),
          "the recorded full-width cohort differs")
    emit({"phase": "coalesced_full_width", "spec": os.path.basename(COALITION),
          "slots": B_FULL, "capacity": CAP_FULL, "rounds": R,
          "rounds_per_dispatch": RPD_COAL, "wall_s": wall,
          "slot_rounds_per_s": B_FULL * R / wall, "run_id_s": run_id_s,
          "run_id_plane_bytes": sum(m.nbytes for m in material),
          "sample_equal_alone": SAMPLE_COAL,
          "counters_sum": dict(zip(out["counter_names"], ctr.sum(0).tolist())),
          "decision_histogram": np.bincount(dec.ravel(), minlength=3).tolist(),
          "kernel_launches": launches, "card": card})
    return "coalesced full width", calls, launches, 1


def slot_nbytes(B, n, R, scenario):
    """Bytes each input read once and each output written once: order,
    leader, faulty, alive, ids, keys, counter and counter blocks in
    (strategy and the four event planes in scenario mode); majorities,
    decisions and counter rows out (leader, faulty, alive, strategy and
    leaders in scenario mode)."""
    C = 5 if scenario else 3
    nbytes = B * 5 + B * n * 6 + B * 16 + 4 + B * C * 4 + B * n + R * B + R * B * C * 4
    if scenario:
        nbytes += B * n + R * B * n * 4 + B * 4 + B * n * 3 + R * B * 4
    return nbytes


def plain_slots(args, kw):
    """The plain ``coalesced_megastep`` on a recorded dispatch's inputs,
    CHUNK slots at a time (slots are independent), as one flat tuple."""
    state, sched, strategy, counters, events = args
    parts = []
    for lo in range(0, state.batch, CHUNK):
        hi = min(state.batch, lo + CHUNK)
        parts.append(slot_flat(pipeline.coalesced_megastep(
            rows_of(state, lo, hi), pipeline.KeySchedule(sched.key_data[lo:hi].clone(),
                                                          sched.counter.clone()),
            None if strategy is None else strategy[lo:hi].clone(), counters[lo:hi],
            None if events is None else {k: v[:, lo:hi] for k, v in events.items()}, **kw)))
    # concatenation axis of each slot_flat entry; the counter is shared
    axes = [0] * 5 + [None] + ([0] if strategy is not None else []) + [0, 1, 1] \
        + ([1] if events is not None else [])
    return tuple(parts[0][i] if ax is None else torch.cat([p[i] for p in parts], dim=ax)
                 for i, ax in enumerate(axes))


def replay_slot(calls, int_ops_per_s):
    """Each recorded slot-mode dispatch again on its own inputs: held
    against the recorded output (the path's own) and the plain version;
    its CUDA-event time (mean of 10 after a warm-up, 3 at full width),
    the plain version's (one call, host clock) and the bound.  Dispatches
    of one shape are summed into one entry: every reading in it was
    taken on each of them."""
    groups = {}
    kernel = scenario_step.cuda_coalesced_megastep
    for _, args, kw, recorded, _ in calls:
        state = args[0]
        B, n = state.faulty.shape
        R, scen = kw["rounds"], kw.get("scenario", False)
        got = slot_flat(kernel(*pipeline.fresh_copy(args), **kw))
        check(max_abs_err(zip(got, slot_flat(recorded))) == 0,
              "a replayed slot-mode dispatch differs from its path's own output")
        what = f"B {B}, n {n}, R {R}, {'scenario' if scen else 'plain'}"
        want, plain_ms = timed_plain(lambda: plain_slots(pipeline.fresh_copy(args), kw))
        reps = 10 if B * n <= 1 << 16 else 3
        copies = iter([pipeline.fresh_copy(args) for _ in range(reps + 1)])
        ms = time_cuda(lambda: kernel(*next(copies), **kw), reps=reps)
        c_got, drawn = words_drawn(lambda: slot_flat(kernel(*pipeline.fresh_copy(args), **kw)))
        check(max_abs_err(zip(c_got, got)) == 0,
              "K1's counting build differs from the kernel on a slot-mode dispatch")
        words, steps = work_counts(state, R, strategy=args[2], events=args[4], slot=True)
        bound_ms, bound_by = bound(words, steps, slot_nbytes(B, n, R, scen), int_ops_per_s)
        g = groups.setdefault(what, {"what": what, "dispatches": 0, "max_abs_err": 0,
                                     "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                     "bound_by": bound_by, "threefry_words_needed": 0,
                                     "threefry_words_drawn": 0, "tally_steps": 0})
        g["dispatches"] += 1
        g["max_abs_err"] = max(g["max_abs_err"], max_abs_err(zip(got, want)))
        g["ms"] += ms
        g["plain_ms"] += plain_ms
        g["bound_ms"] += bound_ms
        g["threefry_words_needed"] += words
        g["threefry_words_drawn"] += drawn
        g["tally_steps"] += steps
        if bound_by != g["bound_by"]:
            g["bound_by"] = "bytes"
    return list(groups.values())


def kernel_line_slot(paths, int_ops_per_s):
    """K1's slot-mode line.  ``paths``: (path, recorded calls, launches
    counted on the path's main run, the calls that run made of each
    recorded one).  Every recorded dispatch is replayed, timed and held
    against the plain version (``replay_slot``); a path's dispatches
    replayed, times its calls, must equal
    its counted launches (a serving path's graph replays count as
    launches, and its recorded rerun dispatches each window eagerly)."""
    entries = []
    for path, calls, launches, runs in paths:
        parts = replay_slot(calls, int_ops_per_s)
        replayed = sum(p["dispatches"] for p in parts)
        check(replayed * runs == launches,
              f"K1 slot on {path}: {replayed} dispatches replayed x {runs} calls, "
              f"{launches} launches counted")
        entries.append({"path": path, "launches": launches, "calls": runs,
                        **totals(parts), "dispatches": parts})
    line = totals([p for e in entries for p in e["dispatches"]])
    check(line["max_abs_err"] == 0, f"K1 slot differs from its plain version: {line}")
    return {"name": "megastep_slot", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "mode": "slot (pallas_coalesced_megastep, "
            "ba_tpu/ops/scenario_step.py:745)",
            "wrapper": "ba_tpu_torch/ops/scenario_step.py:cuda_coalesced_megastep",
            "launches": sum(e["launches"] for e in entries), **line, "library_ms": None,
            "checked_against_plain": True, "per": "one run of each path",
            "design": K1_DESIGN, "ptxas": PTXAS["megastep.cu"], "paths": entries}


# -- BASELINE configs #1 and #4 ------------------------------------------------

# bench.py:130 (bench_om1_n4): om1_agreement at B = 4 194 304, n = 4, general 2
# faulty, 30 calls a rep; bench.py:628 (bench_n1024_m32): the collapsed SM(32) at
# B = 1, n = 1024, the first 32 generals faulty, 100 rounds a call, 5 calls a rep
# there; 2 here: a call takes ~16 s of host-bound plain torch on the card's
# machine, and 3 reps of 5 were 40 % of this script's run.
B_C1, N_C1, ITERS_C1 = 4_194_304, 4, 30
# bench_n1024_m32 runs 100 rounds a call; 10 keep the script inside its time limit
N_C4, M_C4, INNER_C4, ITERS_C4 = 1024, 32, 10, 2


def bench_timed(fn, args_of, iters, reps=3):
    """bench.py's _timed: one warm call (args_of(0)), then ``reps`` reps of
    ``iters`` calls, each timed by host wall clock to the synchronised
    end; -> the reps' seconds (the best is the reading)."""
    fn(*args_of(0))
    sync()
    walls = []
    for r in range(reps):
        t0 = time.perf_counter()
        for i in range(1, iters + 1):
            fn(*args_of(r * iters + i))
        sync()
        walls.append(time.perf_counter() - t0)
    return walls


def phase_config1(dev, card):
    """BASELINE config #1 as bench_om1_n4 runs it: om1_agreement on the
    constant state, keys fold_in(key(0), i); every decision ATTACK with
    needed 3 of 4 (counted on the card, read after the clock)."""
    faulty = torch.zeros((B_C1, N_C1), dtype=torch.bool, device=dev)
    faulty[:, 2] = True
    state = make_state(B_C1, N_C1, order=ATTACK, faulty=faulty, device=dev)
    keys = rng.fold_in(rng.key(0, device=dev)[None, :],
                       torch.arange(1 + 3 * ITERS_C1, device=dev))
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def step(k):
        out = om1_agreement(k, state)
        bad.add_((out["decision"] != ATTACK).sum() + (out["needed"] != 3).sum()
                 + (out["total"] != N_C1).sum())
        return out["decision"].to(torch.int32).sum(), out["needed"].sum()

    walls = bench_timed(step, lambda i: (keys[i],), ITERS_C1)
    check(int(bad) == 0, f"config #1: {int(bad)} decisions not ATTACK with 3 of 4")
    emit({"phase": "config1_om1_n4", "batch": B_C1, "n": N_C1, "m": 1, "iters": ITERS_C1,
          "rep_seconds": walls, "spread": spread(walls),
          "rounds_per_sec": B_C1 * ITERS_C1 / min(walls),
          "all_attack_needed_3_of_4": True, "card": card})


def phase_config4(dev, card):
    """BASELINE config #4 at bench_n1024_m32's shape: the collapsed
    sm_agreement at B = 1, n = 1024, m = 32, the first 32 generals faulty
    (the commander among them), 10 rounds a call on split(key, 10),
    keys fold_in(key(4), i); every round's honest lieutenants agree (IC1)
    and count all 1024 (counted on the card, read after the clock)."""
    faulty = torch.zeros((1, N_C4), dtype=torch.bool, device=dev)
    faulty[:, :M_C4] = True
    state = make_state(1, N_C4, order=ATTACK, faulty=faulty, device=dev)
    honest_lt = pipeline._lieutenants(state) & ~state.faulty
    keys = rng.fold_in(rng.key(4, device=dev)[None, :],
                       torch.arange(1 + 3 * ITERS_C4, device=dev))
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def step(k):
        acc = torch.zeros((), dtype=torch.int32, device=dev)
        for kk in rng.split(k, INNER_C4).unbind(0):
            out = sm.sm_agreement(kk, state, M_C4, None, None, None, True)
            acc = acc + out["decision"].to(torch.int32).sum()
            bad.add_(pipeline._disagree(out["majorities"], honest_lt).sum()
                     + (out["total"] != N_C4).sum())
        return acc

    walls = bench_timed(step, lambda i: (keys[i],), ITERS_C4)
    check(int(bad) == 0, f"config #4: {int(bad)} rounds broke IC1 or the count")
    emit({"phase": "config4_n1024_m32", "batch": 1, "n": N_C4, "m": M_C4,
          "rounds_per_call": INNER_C4, "iters": ITERS_C4, "rep_seconds": walls,
          "spread": spread(walls), "rounds_per_sec": INNER_C4 * ITERS_C4 / min(walls),
          "ic1_all_rounds": True, "card": card})


# -- OM(m) by the EIG tree and K9: BASELINE config #2 and eig_n1024 ------------

K9_SOURCE = "ba_tpu_torch/ops/csrc/majority.cu"
K9_REPLACES = "ba_tpu/ops/majority.py:37"
K9_WRAPPERS = {"K9": majority.masked_majority_rows}
K9_DESIGN = ("K <= 32: a block of 128 threads owns 512 consecutive rows; their answer, "
             "fallback and mask-row bytes staged into shared memory by 16-byte cp.async "
             "copies, each thread 4 consecutive rows tallied as realigned 32-bit words "
             "(SWAR, the words' flags packed before two popcounts), row positions by a "
             "multiply-shift division once a thread, the outputs written in 16-byte stores; "
             "K >= 33: a warp a row, 16-byte chunks a lane, the counts summed by shuffles")
MAJ_R, MAJ_K = (1, 255, 257, 70_001), (1, 7, 10, 33, 128, 1024, 1025)
# bench.py:161 (bench_om3_n10): eig_agreement at B = 131 072, n = 10, m = 3, order
# ATTACK, generals 2, 5, 7 faulty, 20 calls a rep; bench.py:523 (bench_eig_n1024):
# B = 128, n = 1024, m = 2, generals 3, 7 faulty, 5 calls a rep.  max_liars from
# the state, keys fold_in(key(1 or 8), i), as bench.py derives them.
B_C2, N_C2, M_C2, FAULTY_C2, ITERS_C2, SEED_C2 = 131_072, 10, 3, (2, 5, 7), 20, 1
B_E, N_E, M_E, FAULTY_E, ITERS_E, SEED_E = 128, 1024, 2, (3, 7), 5, 8
# the m = 2 sweep of the middle phase: B, capacity, rounds, rounds a dispatch
B_SW2, CAP_SW2, R_SW2, RPD_SW2 = 64, 16, 8, 4
CPU = torch.device("cpu")


def majority_case(rs, lead, K, shared=False):
    """Random K9 inputs (numpy): any small int8 code, every 7th row with no
    valid responder, every 7th from the 4th an exact tie over all K (one
    UNDEFINED slot where K is odd); ``shared`` gives the [G, S, P, K]
    form with a [G, 1, P, K] mask."""
    a = rs.integers(-2, 4, (*lead, K)).astype(np.int8)
    v = rs.random((*lead[:-2], 1, lead[-1], K) if shared else (*lead, K)) < 0.5
    flat_a, flat_v = a.reshape(-1, K), v.reshape(-1, K)
    flat_v[0::7] = False
    tie = (np.arange(K) % 2).astype(np.int8)
    if K % 2:
        tie[-1] = 2
    flat_a[3::7] = tie
    if not shared:
        flat_v[3::7] = True
    return a, v, rs.integers(0, 3, lead).astype(np.int8)


def phase_majority_middle(dev, rs):
    """K9 against its plain version on the card, bit-equal: R in MAJ_R, K
    in MAJ_K, dense, and the shared-mask form the resolve uses."""
    errs, rows = {}, 0
    for R in MAJ_R:
        for K in MAJ_K:
            for shared in (False, True):
                lead = (max(1, R // 6), 3, 2) if shared else (R,)
                a, v, f = (torch.tensor(x, device=dev) for x in majority_case(rs, lead, K, shared))
                got = majority.masked_majority_rows(a, v, f)
                want = majority.plain_masked_majority_rows(a, v, f)
                errs[f"R{R}_K{K}{'_shared' if shared else ''}"] = max_abs_err([(got, want)])
                rows += f.numel()
    sync()
    check(all(e == 0 for e in errs.values()), f"K9 differs from plain: {errs}")
    emit({"phase": "majority_middle", "cases": len(errs), "rows": rows, "max_abs_err": 0})


def both_devices(fn, dev):
    """``fn(device)`` -> tuple of tensors, on the card and on the CPU: the
    largest difference (0 expected: the EIG path is exact integer work)."""
    card = fn(dev)
    sync()
    return max_abs_err(zip((t.cpu() for t in card), fn(CPU))), card


def sweep2_state(device):
    """The m = 2 sweep's state: make_sweep_state at capacity 16, n in [8,
    16], traitors at most a quarter (OM(2) validity holds)."""
    return sweep.make_sweep_state(rng.key(2, device=device), B_SW2, CAP_SW2, min_n=8,
                                  max_traitor_frac=0.25, order=ATTACK)


def sweep2(device, engine=None):
    out = pipeline.pipeline_sweep(rng.key(13, device=device), sweep2_state(device), R_SW2,
                                  m=2, depth=2,
                                  rounds_per_dispatch=RPD_SW2, collect_decisions=True,
                                  with_counters=True, engine=engine, device=device)
    check(out["stats"]["engine"] == "torch", "the m = 2 sweep ran another engine")
    return tuple(torch.tensor(out[k]) for k in ("histograms", "decisions",
                                                 "counters_per_round"))


def config_state(B, n, faulty_ids, device):
    faulty = torch.zeros((B, n), dtype=torch.bool, device=device)
    faulty[:, list(faulty_ids)] = True
    return make_state(B, n, order=ATTACK, faulty=faulty, device=device)


def phase_eig_middle(dev, rs):
    """The port's EIG path on the card against the port on the CPU,
    bit-equal: eig_agreement at config #2's shape (B = 64; one key over
    the batch; fused and dense); B = 4, n = 300, m = 2 (tallies pass 256:
    the product's float32 is exact); the m = 2 pipeline_sweep (its K9
    launches counted: a main path of the kernels line), a scenario_sweep
    of the coalition campaign at m = 2, and a coalesced_sweep at m = 2,
    each slot also against its own B = 1 run on the card."""
    errs = {}
    for fused in (True, False):
        def agree(device, fused=fused):
            out = eig.eig_agreement(rng.key(5, device=device),
                                    config_state(64, N_C2, FAULTY_C2, device), M_C2, 3,
                                    fused=fused)
            return out["majorities"], out["decision"], out["needed"], out["total"]
        errs[f"config2_B64_{'fused' if fused else 'dense'}"], out = both_devices(agree, dev)
        check(bool((out[1] == ATTACK).all()), "OM(3) with 3 of 10 faulty did not decide ATTACK")

    def n300(device):
        state = config_state(4, 300, (4, 150), device)
        state.order[1] = 0  # one instance ordered to retreat
        out = eig.eig_agreement(rng.key(30, device=device), state, 2, 2)
        return out["majorities"], out["decision"]
    errs["n300_m2"], out = both_devices(n300, dev)
    check(out[1].tolist() == [ATTACK, 0, ATTACK, ATTACK], f"n = 300: {out[1].tolist()}")

    majority.reset_launches()
    card = sweep2(dev)
    sync()
    sweep_launches = majority.masked_majority_rows.launches
    errs["pipeline_sweep_m2"] = max_abs_err(zip(card, sweep2(CPU)))
    check(bool((card[0][:, 1] == B_SW2).all()), "the m = 2 sweep did not decide ATTACK")
    check(sweep_launches == R_SW2, f"m = 2 sweep: {sweep_launches} K9 launches, "
          f"{R_SW2} expected (one resolve level a round)")

    def campaign(device):
        B, n = 16, 16
        arrays, _, _ = random_arrays(np.random.default_rng(3), B, n, 1)
        arrays["leader"][:] = 0
        block = scenario_compile.compile_scenario(scenario_spec.load(COALITION), B, n)
        out = pipeline.scenario_sweep(rng.key(9, device=device), to_state(arrays, device),
                                      block, m=2, rounds_per_dispatch=4,
                                      collect_decisions=True, device=device)
        return tuple(torch.tensor(out[k]) for k in ("histograms", "decisions", "leaders",
                                                      "counters_per_round"))
    errs["scenario_sweep_m2"], _ = both_devices(campaign, dev)

    B, n, R = 8, 6, 4
    arrays, _, _ = random_arrays(rs, B, n, 1)
    arrays["leader"][:] = 0
    seeds = [int(s) for s in rs.integers(0, 2**31, B)]

    def cohort(device, lo=0, hi=B):
        out = pipeline.coalesced_sweep(
            [rng.key(s, device=device) for s in seeds[lo:hi]],
            to_state({k: v[lo:hi] for k, v in arrays.items()}, device), R, m=2,
            max_liars=n - 1, rounds_per_dispatch=2, device=device)
        return tuple(torch.tensor(out[k]) for k in ("decisions", "majorities", "counters"))
    errs["coalesced_sweep_m2"], co = both_devices(cohort, dev)
    alone = [cohort(dev, b, b + 1) for b in range(B)]
    errs["coalesced_slots_alone"] = max(
        max_abs_err([(co[0][:, b:b + 1], a[0]), (co[1][b:b + 1], a[1]), (co[2][b:b + 1], a[2])])
        for b, a in enumerate(alone))
    check(all(e == 0 for e in errs.values()), f"EIG on the card differs: {errs}")
    emit({"phase": "eig_middle", "max_abs_err": errs, "k9_launches_m2_sweep": sweep_launches})
    with recording(K9_WRAPPERS) as calls:
        again = sweep2(dev)
    check(max_abs_err(zip(again, card)) == 0, "the recorded m = 2 sweep differs")
    return ("pipeline_sweep m=2 (B 64, capacity 16, 8 rounds)", calls, sweep_launches, 1)


def eig_stages(key, state, m, max_liars, reps=3):
    """CUDA-event ms of one fused call's parts on device-resident inputs:
    the send levels 0..m-1, the fused deepest level, its Binomial draw
    alone, and the remaining resolve levels (K9)."""
    k_send, k_coin = rng.split(key).unbind(-2)
    levels = eig.eig_send(k_send, state, m - 1)
    resolved = eig.eig_deepest_fused(k_coin, state, levels, m, max_liars)
    k_full = torch.full(resolved.shape, max_liars, dtype=torch.int32, device=state.device)
    return {
        "send_ms": time_cuda(lambda: eig.eig_send(k_send, state, m - 1), reps),
        "fused_level_ms": time_cuda(
            lambda: eig.eig_deepest_fused(k_coin, state, levels, m, max_liars), reps),
        "binomial_draw_ms": time_cuda(lambda: eig._binomial_half(k_coin, k_full, max_liars),
                                      reps),
        "resolve_levels_ms": time_cuda(lambda: eig._resolve_from(state, levels, resolved, m - 1),
                                       reps),
    }


def timed_eig(name, dev, B, n, m, faulty_ids, iters, seed):
    """bench.py's _timed of eig_agreement at one key a call (fold_in(key(seed),
    i)): one warm call, 3 reps of ``iters``, best rep; every decision
    ATTACK with the quorum of all n (counted on the card, read after the
    clock); K9's launches counted over exactly those calls, and the peak
    device memory.  Returns (state, first key, max_liars, rep walls,
    launches, calls, peak bytes)."""
    want_needed = 2 * ((n - 1) // 3) + 1  # the 3f + 1 quorum of n alive (n > 3)
    state = config_state(B, n, faulty_ids, dev)
    max_liars = int(state.faulty.sum(-1).max())  # derived, never hardcoded
    keys = rng.fold_in(rng.key(seed, device=dev)[None, :],
                       torch.arange(1 + 3 * iters, device=dev))
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def step(k):
        out = eig.eig_agreement(k, state, m, max_liars)
        bad.add_((out["decision"] != ATTACK).sum() + (out["needed"] != want_needed).sum()
                 + (out["total"] != n).sum())
        return out["decision"].to(torch.int32).sum(), out["needed"].sum()

    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    majority.reset_launches()
    walls = bench_timed(step, lambda i: (keys[i],), iters)
    launches = majority.masked_majority_rows.launches
    peak = torch.cuda.max_memory_allocated(dev)
    calls = 1 + 3 * iters
    check(int(bad) == 0, f"{name}: {int(bad)} decisions not ATTACK with {want_needed} of {n}")
    check(launches == calls * (m - 1), f"{name}: {launches} K9 launches in {calls} calls")
    return state, keys[0], max_liars, walls, launches, calls, peak


def phase_config2(dev, card):
    """BASELINE config #2 as bench_om3_n10 runs it (bench.py:161): OM(3),
    n = 10, 3 traitors; every decision ATTACK, needed 7 of 10; then one
    call's stages by CUDA events, and one call recorded for K9's line."""
    state, key0, max_liars, walls, launches, calls, peak = timed_eig(
        "config #2", dev, B_C2, N_C2, M_C2, FAULTY_C2, ITERS_C2, SEED_C2)
    emit({"phase": "config2_om3_n10", "batch": B_C2, "n": N_C2, "m": M_C2,
          "max_liars": max_liars, "iters": ITERS_C2, "rep_seconds": walls,
          "spread": spread(walls), "rounds_per_sec": B_C2 * ITERS_C2 / min(walls),
          "all_attack_needed_7_of_10": True, "k9_launches": launches, "calls": calls,
          "peak_device_bytes": peak, "stages": eig_stages(key0, state, M_C2, max_liars),
          "card": card})
    want = eig.eig_agreement(key0, state, M_C2, max_liars)["majorities"]
    with recording(K9_WRAPPERS) as recorded:
        got = eig.eig_agreement(key0, state, M_C2, max_liars)["majorities"]
    check(torch.equal(got, want), "config #2: the recorded call differs")
    return ("config2_om3_n10 (one call)", recorded, launches, calls)


def phase_eig_n1024(dev, card):
    """bench_eig_n1024 (bench.py:523): OM(2) at n = 1024, generals 3 and 7
    faulty, B = 128; every decision ATTACK with 683 of 1024 needed; then
    bench's stage split on device-resident levels (key(9)): the fused
    deepest level alone, its matrix product alone and its Binomial draw
    alone, and K9 alone on the last resolve level's inputs, each by CUDA
    events; one call recorded."""
    state, key0, max_liars, walls, launches, calls, peak = timed_eig(
        "eig_n1024", dev, B_E, N_E, M_E, FAULTY_E, ITERS_E, SEED_E)
    levels = eig.eig_send(rng.key(9, device=dev), state, M_E - 1)
    prev = levels[M_E - 1].reshape(B_E, N_E, N_E ** (M_E - 1))
    eligible = state.alive & ~om._leader_mask(state)
    eye = torch.eye(N_E, dtype=torch.bool, device=dev)
    m1 = (eligible[:, None, :] & (~state.faulty[:, None, :] | eye[None])).to(torch.float32)

    def product():
        return torch.bmm(m1, (prev == ATTACK).to(torch.float32)).to(torch.int32)

    k_coin = rng.key(100, device=dev)
    resolved = eig.eig_deepest_fused(k_coin, state, levels, M_E, max_liars)
    valid = (state.alive & ~om._leader_mask(state))[:, None, None, :]
    fallback = levels[0].reshape(B_E, N_E, 1)
    children = resolved.reshape(B_E, N_E, 1, N_E)
    t_level = time_cuda(lambda: eig.eig_deepest_fused(k_coin, state, levels, M_E, max_liars),
                        ITERS_E)
    t_product = time_cuda(product, ITERS_E)
    k_full = torch.full(resolved.shape, max_liars, dtype=torch.int32, device=dev)
    t_draw = time_cuda(lambda: eig._binomial_half(k_coin, k_full, max_liars), ITERS_E)
    t_k9 = time_cuda(lambda: majority.masked_majority_rows(children, valid, fallback), 10)
    flops = 2 * B_E * N_E ** 3
    emit({"phase": "eig_n1024", "batch": B_E, "n": N_E, "m": M_E, "max_liars": max_liars,
          "iters": ITERS_E, "rep_seconds": walls, "spread": spread(walls),
          "rounds_per_sec": B_E * ITERS_E / min(walls), "all_attack": True,
          "k9_launches": launches, "calls": calls, "peak_device_bytes": peak,
          "stages": {"full_call_ms": min(walls) / ITERS_E * 1e3,
                     "fused_level_ms": t_level, "product_only_ms": t_product,
                     "product_tflops_fp32": flops / t_product / 1e9,
                     "binomial_draw_ms": t_draw, "k9_ms": t_k9},
          "card": card})
    with recording(K9_WRAPPERS) as recorded:
        eig.eig_agreement(key0, state, M_E, max_liars)
    return ("eig_n1024 (one call)", recorded, launches, calls)


def kernel_line_k9(paths, int_ops_per_s):
    """K9's line.  ``paths``: (path, recorded calls, launches counted on the
    path's main run, calls in that run).  Every recorded dispatch is
    replayed on its own inputs: bit-equal to the path's own output and to
    the plain version's; its CUDA-event mean of 10 as launched and queued
    (``time_cuda(..., queued=True)``), the plain version's
    time (one call, host clock), and the bound: each input byte read once
    and each output byte written once at the memory rate, against one
    int32 tally step a responder slot.  Dispatches of one shape are
    summed; dispatches replayed x calls must equal the launches."""
    entries = []
    for path, calls, launches, runs in paths:
        groups = {}
        for _, (a, v, f), kw, recorded, entry in calls:
            got = majority.masked_majority_rows(a, v, f, **kw)
            check(torch.equal(got, recorded), f"K9 replayed ({path}) differs from its path")
            want, plain_ms = timed_plain(lambda: majority.plain_masked_majority_rows(a, v, f))
            ms = time_cuda(lambda: majority.masked_majority_rows(a, v, f), reps=10)
            device_ms = time_cuda(lambda: majority.masked_majority_rows(a, v, f), reps=10,
                                  queued=True)
            R, K = f.numel(), a.shape[-1]
            nbytes = a.numel() + v.numel() + f.numel() + R
            ops_s, bytes_s = R * K / int_ops_per_s, nbytes / HBM_BYTES_PER_S
            what = f"{entry}: R {R}, K {K}, mask rows {v.numel() // K}"
            g = groups.setdefault(what, {"what": what, "dispatches": 0, "max_abs_err": 0,
                                         "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                         "bound_ms": 0.0, "bound_by": "bytes", "bytes": 0})
            g["dispatches"] += 1
            g["max_abs_err"] = max(g["max_abs_err"], max_abs_err([(got, want)]))
            g["ms"] += ms
            g["device_ms"] += device_ms
            g["plain_ms"] += plain_ms
            g["bound_ms"] += max(ops_s, bytes_s) * 1e3
            g["bytes"] += nbytes
            if ops_s > bytes_s:
                g["bound_by"] = "operations"
        parts = list(groups.values())
        for g in parts:  # the group sums its dispatches; *_each is one dispatch
            for k in ("ms", "device_ms", "plain_ms", "bound_ms"):
                g[f"{k}_each"] = g[k] / g["dispatches"]
        replayed = sum(p["dispatches"] for p in parts)
        check(replayed * runs == launches,
              f"K9 on {path}: {replayed} dispatches replayed x {runs} calls, "
              f"{launches} launches counted")
        entries.append({"path": path, "launches": launches, "calls": runs, **totals(parts),
                        "dispatches": parts})
    line = totals([p for e in entries for p in e["dispatches"]])
    check(line["max_abs_err"] == 0, f"K9 differs from its plain version: {line}")
    return {"name": "masked_majority", "route": "cuda", "source": K9_SOURCE,
            "replaces": K9_REPLACES,
            "wrapper": "ba_tpu_torch/ops/majority.py:masked_majority_rows",
            "launches": sum(e["launches"] for e in entries), **line, "library_ms": None,
            "design": K9_DESIGN, "ptxas": PTXAS["majority.cu"],
            "checked_against_plain": True,
            "per": ("one call of each path; a dispatch group's ms, plain_ms and bound_ms sum "
                    "its dispatches, its *_each fields are one dispatch's"),
            "paths": entries}



# -- K3'', K8', the p - 2 chain and K8'': scalar_mult and pow_planes ---------


def affine_limbs(points, dev):
    """Affine oracle points [(x, y), ...] -> extended limbs (X, Y, 1, XY)."""
    P = oracle.P
    cols = [[x for x, _ in points], [y for _, y in points], [1] * len(points),
            [x * y % P for x, y in points]]
    return tuple(torch.stack([F.constant(v, dev) for v in col]) for col in cols)


def affine_of(enc):
    """A point uint8 [4, 32] (canonical X, Y, Z, T) -> its affine (x, y) by
    Python integers, after checking Z != 0 and X Y = Z T."""
    P = oracle.P
    x, y, z, t = (int.from_bytes(enc[c].tobytes(), "little") for c in range(4))
    check(z % P != 0 and x * y % P == z * t % P, "a product is off the extended curve form")
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def int_bits(values, nbits, dev):
    """Python ints -> 0/1 int32 [len, nbits], least significant first."""
    return torch.tensor([[(v >> t) & 1 for t in range(nbits)] for v in values],
                        dtype=torch.int32, device=dev)


def phase_ladder_pow_known_answers(dev, rs):
    """K3'' against the oracle's Python arithmetic: scalars 0, 1, L - 1, L
    and 2^256 - 1 (and 2^512 - 1 at 512 bits) on the identity, B and a
    small-order point, nbits 256 and 512, through ladder.scalar_mult and
    ed25519.scalar_mult / scalar_mult_base; pow_planes' every route
    against pow(a, e, p) for a in {0, 1, p - 1, random} and e in {0, 1, 2,
    37, (p - 5)/8, p - 2, p - 1}."""
    P, L = oracle.P, oracle.L
    points = [(0, 1), oracle.BASE, torsion_point()]
    lanes = 0
    for nbits in (256, 512):
        ks = [0, 1, L - 1, L, 2**256 - 1] + ([2**512 - 1] if nbits == 512 else [])
        pairs = [(pt, k) for pt in points for k in ks]
        limbs = affine_limbs([pt for pt, _ in pairs], dev)
        bits = int_bits([k for _, k in pairs], nbits, dev)
        out = ladder.scalar_mult(ed25519.encode_point(limbs), bits).cpu().numpy()
        via_limbs = ed25519.encode_point(ed25519.scalar_mult(limbs, bits)).cpu().numpy()
        check(np.array_equal(out, via_limbs), "ed25519.scalar_mult differs from K3''")
        for (pt, k), enc in zip(pairs, out):
            check(affine_of(enc) == oracle.scalarmult(pt, k),
                  f"K3'' differs from the oracle: k = {k}, {nbits} bits")
        base = ed25519.encode_point(ed25519.scalar_mult_base(int_bits(ks, nbits, dev)))
        for k, enc in zip(ks, base.cpu().numpy()):
            check(affine_of(enc) == oracle.scalarmult(oracle.BASE, k),
                  f"scalar_mult_base differs from the oracle: k = {k}, {nbits} bits")
        lanes += len(pairs)
    a_vals = [0, 1, P - 1, int.from_bytes(rs.bytes(32), "little") % P]
    exps = [0, 1, 2, 37, powchain.SQRT_EXP, powchain.INV_EXP, P - 1]
    a = torch.stack([F.constant(v, dev) for v in a_vals])
    for e in exps:
        got = F.to_bytes(powchain.pow_planes(a, e)).cpu().numpy()
        check([int.from_bytes(g.tobytes(), "little") for g in got] ==
              [pow(v, e, P) for v in a_vals], f"pow_planes differs from pow(a, e, p) at e = {e}")
    emit({"phase": "ladder_pow_known_answers", "k3pp_lanes": lanes, "pow_values": len(a_vals),
          "pow_exponents": len(exps), "oracle_agrees": True, "ok": True})


def phase_ladder_pow_middle(dev, rs):
    """K3'', K8', the p - 2 chain and K8'' against their plain versions at a
    few thousand lanes: K3'' at 3 000 lanes with 256-bit k (points from
    k3p_inputs: the identity, B, [s]B, keys; edge and random scalars),
    the chains at 4 096 field elements (edges, bit 255 set, random) with
    K8'' at a random 255-bit e and at (p - 5)/8 - bit-equal."""
    S = 3000
    pts, k = k3p_inputs(rs, S, 32, dev)
    bits = F.bytes_to_bits(k)
    errs = {"K3''": max_abs_err([(ladder.scalar_mult(pts, bits),
                                  ladder.plain_scalar_mult(pts, bits))])}
    P = oracle.P
    edges = np.stack([np.frombuffer(le32(v), np.uint8)
                      for v in (0, 1, P - 1, P, 2**255 - 1, 5 | 1 << 255)])
    enc = torch.tensor(np.concatenate([edges, rs.integers(0, 256, (4090, 32), dtype=np.uint8)]),
                       device=dev)
    e = int.from_bytes(rs.bytes(32), "little") >> 1
    errs["K8'"] = max_abs_err([(powchain.sqrt_chain(enc), powchain.plain_sqrt_chain(enc))])
    errs["K8 p-2"] = max_abs_err([(powchain.inv_chain(enc), powchain.plain_inv_chain(enc))])
    errs["K8''"] = max_abs_err([(powchain.pow_exp(enc, e), powchain.plain_pow_exp(enc, e)),
                                (powchain.pow_exp(enc, powchain.SQRT_EXP),
                                 powchain.plain_pow_exp(enc, powchain.SQRT_EXP))])
    sync()
    check(all(v == 0 for v in errs.values()), f"a ladder / pow kernel differs from plain: {errs}")
    emit({"phase": "ladder_pow_vs_plain_middle", "k3pp_lanes": S, "pow_lanes": len(enc),
          "max_abs_err": errs})


def phase_ladder_pow_full_width(dev, rs, card):
    """The ladder / pow path at full width, through the entry points:
    ed25519.scalar_mult at S_LADDER lanes (points [s]B from K4, Z != 1;
    random 256-bit k) and pow_planes at N_POW limbs in [-8000, 8000) with
    e = (p - 5)/8, p - 2 and (p - 1)/2, and K8'' launched directly with
    e = (p - 5)/8; its launches counted.  Checks: K3'' and K3' (window_mult,
    the same 32-byte k) give the same group element (both compressed by
    K8); r = a^((p - 5)/8) has r^8 a^4 = 1, a / a = 1 and a^((p - 1)/2) is
    0, 1 or -1 (0 only for a = 0) on every lane; K8'' at (p - 5)/8 equals
    K8'.  Then each kernel alone by CUDA events: scalar-mults/s of K3'' and
    K3' and their ratio, the chains' ms and the generic-against-chain
    ratio.  Returns the recorded path for the kernels line."""
    P = oracle.P
    k = torch.tensor(rs.integers(0, 256, (S_LADDER, 32), dtype=np.uint8), device=dev)
    bits = F.bytes_to_bits(k)
    pts = ed25519.fixed_base_mult(
        torch.tensor(rs.integers(0, 256, (S_LADDER, 32), dtype=np.uint8), device=dev))
    limbs = ed25519.decode_point(pts)
    a = torch.tensor(rs.integers(-8000, 8000, (N_POW, F.LIMBS), dtype=np.int32), device=dev)
    a[0] = 0  # a zero lane: its inverse, root candidate and symbol are 0
    enc_a = F.to_bytes(a)

    def ladder_pow_path():
        return (ed25519.scalar_mult(limbs, bits), powchain.pow_planes(a, powchain.SQRT_EXP),
                powchain.pow_planes(a, powchain.INV_EXP), powchain.pow_planes(a, LEGENDRE_EXP),
                powchain.pow_exp(enc_a, powchain.SQRT_EXP), ladder.window_mult(pts, k))

    sync()
    reset_ed_launches()
    prod, root, inv, symbol, root_generic, windowed = ladder_pow_path()
    sync()
    launches = ed_launches()
    check(launches == LADDER_POW_LAUNCHES, f"ladder / pow path launches {launches}")
    check(torch.equal(ed25519.compress(ed25519.encode_point(prod).contiguous()),
                      ed25519.compress(windowed)), "K3'' and K3' give different points")
    one = F.constant(1, dev)
    nonzero = ~F.is_zero(a)
    check(not bool(nonzero[0]) and bool(nonzero[1:].all()), "the test limbs' zero lanes moved")
    sq = lambda x, n: F.sq_n(x, n)  # noqa: E731
    check(bool((F.eq(F.mul(sq(root, 3), sq(a, 2)), one) == nonzero).all()),
          "a^((p - 5)/8) fails r^8 a^4 = 1")
    check(bool((F.eq(F.mul(inv, a), one) == nonzero).all()) and bool(F.is_zero(inv[0])),
          "the p - 2 route is no inverse")
    canon = F.canonical(symbol)
    legal = (F.eq(symbol, one) | F.eq(symbol, F.constant(P - 1, dev))) == nonzero
    check(bool(legal.all()) and bool(F.is_zero(canon[:1]).all()),
          "a^((p - 1)/2) is not a Legendre symbol")
    check(torch.equal(F.to_bytes(root), root_generic), "K8'' at (p - 5)/8 differs from K8'")
    ms = {"K3''": time_cuda(lambda: ladder.scalar_mult(pts, bits), reps=3),
          "K3'": time_cuda(lambda: ladder.window_mult(pts, k), reps=3),
          "K8'": time_cuda(lambda: powchain.sqrt_chain(enc_a), reps=5),
          "K8 p-2": time_cuda(lambda: powchain.inv_chain(enc_a), reps=5),
          "K8'' (p-5)/8": time_cuda(lambda: powchain.pow_exp(enc_a, powchain.SQRT_EXP), reps=5),
          "K8'' (p-1)/2": time_cuda(lambda: powchain.pow_exp(enc_a, LEGENDRE_EXP), reps=5)}
    with recording(ED_WRAPPERS) as calls:
        again = ladder_pow_path()
    check(all(torch.equal(x, y) for x, y in zip((*again[0], *again[1:]),
                                                (*prod, root, inv, symbol, root_generic,
                                                 windowed))),
          "the recorded ladder / pow run differs from the counted one")
    emit({"phase": "ladder_pow_full_width", "ladder_lanes": S_LADDER, "ladder_bits": 256,
          "pow_lanes": N_POW, "kernel_ms": ms,
          "k3pp_scalar_mults_per_sec": S_LADDER / ms["K3''"] * 1e3,
          "k3p_scalar_mults_per_sec": S_LADDER / ms["K3'"] * 1e3,
          "k3pp_over_k3p_time": ms["K3''"] / ms["K3'"],
          "generic_over_chain_time": ms["K8'' (p-5)/8"] / ms["K8'"],
          "k3pp_k3p_same_points": True, "roots_inverses_symbols_checked": True,
          "kernel_launches": launches, "card": card})
    return "ladder / pow", calls, launches, 1


# -- the A/B of K1 and K2 (scripts/torch_checkout_ab.py --phase sweeps) ------

N_GENERAL = 1000  # a full-width capacity that is not a multiple of 32


def ab_sweeps(dev, card):
    """The sweeps' readings for an A/B of two checkouts of the package:
    builds K1 and K2 alone, runs the plain sweep, the coalition campaign,
    the full-width coalesced cohort and the signed sweep (on all-valid
    table verdicts, as the setup gives them), then times by CUDA events
    one full-width dispatch of K1 in each mode (the plain sweep's first
    inputs, the campaign's first, the cohort's first), one plain dispatch
    at capacity N_GENERAL (K1's path for n not a multiple of 32) and K2's
    warm-up dispatch of each bucket.  Emits them as one line."""
    for source in ("megastep.cu", "sweep_step.cu"):
        _build.load(source)
    ctr = convert.counters_from_numpy([0, 0, 0], dev)

    def k1_plain_ms(arrays):
        state = to_state(arrays, dev)
        sched = pipeline.make_key_schedule(rng.key(0, device=dev))
        return time_cuda(lambda: scenario_step.cuda_pipeline_megastep(
            state, sched, rounds=RPD_FULL, collect_decisions=True, counters=ctr), reps=5)

    arrays, _, _ = phase_full_width(dev, 0, card)
    k1_plain = k1_plain_ms(arrays)
    k1_general = k1_plain_ms(sweep_arrays(rng.fold_in(rng.key(0, device=dev), 1000), B_FULL,
                                          N_GENERAL, order=1))
    s_arrays, planes, _, _ = phase_scenario(dev, 0, card)
    carry = (to_state(s_arrays, dev), pipeline.make_key_schedule(rng.key(1, device=dev)),
             torch.zeros(s_arrays["faulty"].shape, dtype=torch.int8, device=dev))
    ev0 = convert.events_from_numpy({k: v[:RPD_SCEN] for k, v in planes.items()}, dev)
    ctr5 = convert.counters_from_numpy([0] * 5, dev)
    copies = iter([pipeline.fresh_copy(carry) for _ in range(6)])
    k1_scen = time_cuda(lambda: scenario_step.cuda_scenario_megastep(
        *next(copies), ctr5, ev0, rounds=RPD_SCEN, collect_decisions=True), reps=5)
    _, calls, _, _ = phase_coalesced_full_width(dev, 0, card)
    _, args, kw, _, _ = calls[0]
    slots = iter([pipeline.fresh_copy(args) for _ in range(4)])
    k1_slot = time_cuda(lambda: scenario_step.cuda_coalesced_megastep(*next(slots), **kw),
                        reps=3)
    ok = torch.ones((B_SIGNED, 2), dtype=torch.bool, device=dev)
    states, oks, seeds, _, _, _ = phase_signed_sweep(dev, ok, card)
    k2 = [time_cuda(lambda: sweep_step.fused_signed_sweep_step(
        *k2_args(seeds[0, i:i + 1], st, ok_b, ROUNDS_SIGNED)), reps=10)
          for i, (st, ok_b) in enumerate(zip(states, oks))]
    emit({"phase": "ab_sweeps", "k1_plain_ms": k1_plain, "k1_scenario_ms": k1_scen,
          "k1_slot_ms": k1_slot, "k1_plain_n1000_ms": k1_general, "k2_step_ms": sum(k2),
          "k2_bucket_ms": k2, "card": card})


R_AB_REPL, AB_REPL_REPS = 1024, 7  # ab_repl: run-rounds' rounds (128 K1 dispatches), commands


def ab_repl(dev, card):
    """The host shell's reading for an A/B of two checkouts: the REPL's
    ``run-rounds attack 1024`` on a roster of N_REPL generals (phase 31's
    timed command at 1 024 rounds: 128 K1 dispatches of 8 rounds at B = 1, the dispatch
    loop's host work per dispatch at its largest share), after one warm-up
    command, AB_REPL_REPS times, each on a fresh roster of the same shape.
    Emits the walls and their median as one line."""
    repl(roster(TorchBackend(device=dev))[0], [f"run-rounds attack {R_REPL}"])
    line = f"run-rounds attack {R_AB_REPL}"
    walls = []
    for _ in range(AB_REPL_REPS):
        cluster, _ = roster(TorchBackend(device=dev))
        scenario_step.reset_launches()
        sync()
        t0 = time.perf_counter()
        out = repl(cluster, [line])
        walls.append(time.perf_counter() - t0)
        check(out[-1] == f"Rounds: {R_AB_REPL} - attack={R_AB_REPL}, retreat=0, undefined=0",
              f"ab_repl: {out[-1]}")
        check(scenario_step.cuda_pipeline_megastep.launches == R_AB_REPL // 8,
              "ab_repl: K1 launches")
    emit({"phase": "ab_repl", "command": line, "n": N_REPL, "run_rounds_s": float(
        np.median(walls)), "walls_s": walls, "card": card})


# -- the A/Bs of kernels through their wrappers (torch_checkout_ab.py --phase GROUP)

K4_AB_LANES = (1, 10_240, 20_480, 65_536)  # [c]B; the setups; config #3's [S]B
K7_AB_LANES = (20_480, 40_960, 66_560, 131_072)
# K9's resolve levels (G, S, P, K): config #2's two (bench_om3_n10), eig_n1024's
# one and the m = 2 sweep's; K8's lane counts: verify_rlc's comparison and the
# setups'.
K9_AB_SHAPES = {"config2_level1": (B_C2, N_C2, N_C2, N_C2),
                "config2_level0": (B_C2, N_C2, 1, N_C2), "eig_n1024": (B_E, N_E, 1, N_E),
                "sweep_m2": (64, 16, 1, 16)}
K8_AB_LANES = (2, 2 * B_SIGNED)
# K6's lane counts: verify_rlc's c (one lane), its W sums (65 536 lanes in groups
# of 64), the signing setup's S and config #3's products; K5's: the setup's and
# config #3's hashes; K5''s the signer's SHA-512(sk) at the setup's width.
K6_AB_LANES = (1, 1_024, 2 * B_SIGNED, NV_C3)
K5_AB_LANES = (2 * B_SIGNED, NV_C3)


def _ab_bytes(dev, rs, shape):
    return torch.tensor(rs.integers(0, 256, shape, dtype=np.uint8), device=dev)


def _ab_window(dev, rs, n):
    """n points [s]B (K4, Z != 1) and n random 256-bit k."""
    k = _ab_bytes(dev, rs, (n, 32))
    return ed25519.fixed_base_mult(_ab_bytes(dev, rs, (n, 32))), k


def _ab_majority(dev, rs, G, S, P, K):
    """Answers 0 or 1, nine mask bytes in ten valid, fallbacks 0-2."""
    return (torch.tensor(rs.integers(0, 2, (G, S, P, K), dtype=np.int8), device=dev),
            torch.tensor(rs.random((G, 1, P, K)) < 0.9, device=dev),
            torch.tensor(rs.integers(0, 3, (G, S, P), dtype=np.int8), device=dev))


def _ab_words(dev, rs, n, nbytes):
    """(wh, wl, n_blocks): the padded message halves of n random messages
    of nbytes."""
    return sha512._message_words(_ab_bytes(dev, rs, (n, nbytes)))


def _ab_raw_modl(h, out):
    """K6's library launch alone, into an output allocated once."""
    check(modl._lib().ba_modl(h.shape[0], h.data_ptr(), out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream) == 0, "K6 launch failed")


def _ab_raw_sha(entry, wh, wl, nb, out):
    """K5's or K5''s library launch alone (``ba_<entry>``), into an output
    allocated once."""
    check(getattr(sha512_kernel._lib(), f"ba_{entry}")(
        wh.shape[0], nb, wh.data_ptr(), wl.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream) == 0, f"{entry} launch failed")


def _ab_ladder(dev, rs, n, nbits):
    """n points [s]B (K4, Z != 1), n random k of nbits as 0/1 int32 bits,
    and their words as the wrapper packs them."""
    pts = ed25519.fixed_base_mult(_ab_bytes(dev, rs, (n, 32)))
    bits = torch.tensor(rs.integers(0, 2, (n, nbits), dtype=np.int32), device=dev)
    return pts, bits, ladder.pack_bits(bits)


def _ab_raw_ladder(pts, bits, words, out):
    """K3''s library launch alone, into an output allocated once."""
    check(ladder._ladder_lib().ba_scalar_mult(
        pts.shape[0], bits.shape[1] // 32, pts.data_ptr(), words.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream) == 0, "K3'' launch failed")


def _ab_points(dev, rs, n):
    """n random points' coordinates, each below 2^255."""
    pts = _ab_bytes(dev, rs, (n, 4, 32))
    pts[:, :, 31] &= 0x7F
    return (pts,)


# K3''s shapes: the ladder / pow path's (its reading through the wrapper is that
# path's scalar-mults/s) and 3 000 lanes of the reference's 512-bit h.
K3PP_AB_SHAPES = ((S_LADDER, 256), (3_000, 512))
# reading -> (sources it builds, the call timed, its inputs(dev, rs)); each
# reading's inputs come from its own default_rng(seed).
AB_ROWS = {
    "k3p_random_ms": (("window_mult.cu", "treeadd.cu"),
                      lambda p, k: ladder.window_mult(p, k),
                      lambda dev, rs: _ab_window(dev, rs, S_LADDER)),
    "k3_random_ms": (("window_verify.cu", "treeadd.cu"),
                     lambda p, k: ladder.window_verify(p, k, p, p),
                     lambda dev, rs: _ab_window(dev, rs, S_LADDER)),
    f"k3_random_{2 * B_SIGNED}_ms": (("window_verify.cu", "treeadd.cu"),
                                     lambda p, k: ladder.window_verify(p, k, p, p),
                                     lambda dev, rs: _ab_window(dev, rs, 2 * B_SIGNED)),
    **{f"k4_{n}_ms": (("treeadd.cu",), lambda s: ed25519.fixed_base_mult(s),
                      lambda dev, rs, n=n: (_ab_bytes(dev, rs, (n, 32)),))
       for n in K4_AB_LANES},
    **{f"k7_{n}_ms": (("decompress.cu",), lambda e: ed25519.decompress(e),
                      lambda dev, rs, n=n: (_ab_bytes(dev, rs, (n, 32)),))
       for n in K7_AB_LANES},
    **{f"k9_{label}_ms": (("majority.cu",), lambda a, v, f: majority.masked_majority_rows(a, v, f),
                          lambda dev, rs, shape=shape: _ab_majority(dev, rs, *shape))
       for label, shape in K9_AB_SHAPES.items()},
    **{f"k8_{n}_ms": (("powchain.cu",), lambda p: powchain.compress(p),
                      lambda dev, rs, n=n: _ab_points(dev, rs, n))
       for n in K8_AB_LANES},
    **{f"k6_{n}_ms": (("modl.cu",), lambda h: modl.reduce_mod_l_planes(h),
                      lambda dev, rs, n=n: (_ab_bytes(dev, rs, (n, 64)),))
       for n in K6_AB_LANES},
    **{f"k6_alone_{n}_ms": (("modl.cu",), _ab_raw_modl,
                            lambda dev, rs, n=n: (_ab_bytes(dev, rs, (n, 64)),
                                                  torch.empty((n, 32), dtype=torch.uint8,
                                                              device=dev)))
       for n in K6_AB_LANES},
    **{f"k5_{n}_ms": (("sha512_modl.cu",), lambda wh, wl, nb: sha512_kernel.sha512_blocks_mod_l(
        wh, wl, nb), lambda dev, rs, n=n: _ab_words(dev, rs, n, 80)) for n in K5_AB_LANES},
    **{f"k5_alone_{n}_ms": (("sha512_modl.cu",),
                            lambda *a: _ab_raw_sha("sha512_modl", *a),
                            lambda dev, rs, n=n: (*_ab_words(dev, rs, n, 80),
                                                  torch.empty((n, 32), dtype=torch.uint8,
                                                              device=dev)))
       for n in K5_AB_LANES},
    f"k5p_{2 * B_SIGNED}_ms": (("sha512_modl.cu",),
                               lambda wh, wl, nb: sha512_kernel.sha512_blocks(wh, wl, nb),
                               lambda dev, rs: _ab_words(dev, rs, 2 * B_SIGNED, 32)),
    f"k5p_alone_{2 * B_SIGNED}_ms": (("sha512_modl.cu",), lambda *a: _ab_raw_sha("sha512", *a),
                                     lambda dev, rs: (*_ab_words(dev, rs, 2 * B_SIGNED, 32),
                                                      torch.empty((2 * B_SIGNED, 64),
                                                                  dtype=torch.uint8,
                                                                  device=dev))),
    f"k3pp_{S_LADDER}_ms": (("scalar_mult.cu", "treeadd.cu"),
                            lambda p, b, w: ladder.scalar_mult(p, b),
                            lambda dev, rs: _ab_ladder(dev, rs, S_LADDER, 256)),
    **{f"k3pp_alone_{n}_{nbits}bit_ms": (("scalar_mult.cu", "treeadd.cu"),
                                         _ab_raw_ladder,
                                         lambda dev, rs, n=n, nbits=nbits: (
                                             *_ab_ladder(dev, rs, n, nbits),
                                             torch.empty((n, 4, 32), dtype=torch.uint8,
                                                         device=dev)))
       for n, nbits in K3PP_AB_SHAPES},
}
# Readings of a kernel alone (its library's launch, the output allocated once):
# timed queued behind a spin (time_cuda's queued), so a kernel shorter than its
# launch's host cost reads its own length; the rest are timed as launched.
AB_ALONE = {k for k in AB_ROWS if "_alone_" in k}


def phase_device_setup(dev, card):
    """The default setup route (signing on the card) at full width, timed
    as phase_signed_setup times it after a warm key-set: its ``total_s``."""
    (_, _, _, _, ok, timings), launches = timed_setup(dev, None)
    check(bool(ok.all()) and launches == DEVICE_SETUP_LAUNCHES,
          f"device-sign setup: launches {launches}")
    emit({"phase": "device_sign_setup", "batch": B_SIGNED, "total_s": timings["total_s"],
          "card": card})


RATE = (("rounds_per_sec", True),)
CONFIG3_SOURCES = ("decompress.cu", "sha512_modl.cu", "treeadd.cu", "window_verify.cu",
                   "modl.cu", "powchain.cu", "window_mult.cu", "fieldmul_probe.cu")
CONFIG3_LINE = (phase_config3, "config3_sm1_n64_signed",
                (("ed25519_verifies_per_sec", True), ("rlc_batch_verifies_per_sec", True)),
                CONFIG3_SOURCES)
DEVICE_SETUP_LINE = (phase_device_setup, "device_sign_setup", (("total_s", False),),
                     ("sha512_modl.cu", "treeadd.cu", "powchain.cu", "modl.cu", "decompress.cu",
                      "window_verify.cu"))
# group -> (its readings, the phases run after them: (phase, the line it emits,
# that line's readings (field, higher wins), the sources it builds))
AB_GROUPS = {
    "k3p_random": ([k for k in AB_ROWS if k.startswith(("k3p_", "k3_"))], ()),
    "k4k7": ([k for k in AB_ROWS if k.startswith(("k4_", "k7_"))], ()),
    "k9k8": ([k for k in AB_ROWS if k.startswith(("k9_", "k8_"))],
             ((phase_config2, "config2_om3_n10", RATE, ("majority.cu",)),
              (phase_eig_n1024, "eig_n1024", RATE, ("majority.cu",)))),
    "k6k5": ([k for k in AB_ROWS if k.startswith(("k6_", "k5_", "k5p_"))],
             (CONFIG3_LINE, DEVICE_SETUP_LINE)),
    "k3ppk5p": ([k for k in AB_ROWS if k.startswith(("k3pp_", "k5p_"))],
                (CONFIG3_LINE, DEVICE_SETUP_LINE)),
}


def ab_kernels(dev, card, group, seed=0):
    """One group of AB_GROUPS, for an A/B of two checkouts of the package:
    builds the group's sources and its phases' alone (in parallel), times
    by CUDA events each reading's call on its inputs (mean of 10 after a
    warm one; AB_ALONE's queued), runs the group's phases, and emits one
    line: the readings, the phases' readings by (line, field), and which
    readings win higher."""
    names, phases = AB_GROUPS[group]
    sources = sorted({src for name in names for src in AB_ROWS[name][0]}
                     | {src for *_, srcs in phases for src in srcs})
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for job in [pool.submit(_build.build, source) for source in sources]:
            job.result()
    readings = {}
    for name in names:
        _, call, inputs = AB_ROWS[name]
        args = inputs(dev, np.random.default_rng(seed))
        readings[name] = time_cuda(lambda: call(*args), reps=10, queued=name in AB_ALONE)
        del args
    for phase, *_ in phases:
        phase(dev, card)
    fields = [(line, field, up) for _, line, fs, _ in phases for field, up in fs]
    emit({"phase": f"ab_{group}", "readings": readings,
          "from_lines": {f"{line}_{field}": [line, field] for line, field, _ in fields},
          "higher_wins": [f"{line}_{field}" for line, field, up in fields if up],
          "card": card})


# -- the host shell on the card: the REPL (repl_cuda) --------------------------

# SURVEY.md section 3.1's script, piped through the launcher at n = 4, seed 0.
REPL_SCRIPT = ("g-state\nactual-order attack\ng-state 2 faulty\nactual-order retreat\n"
               "g-kill 1\ng-add 2\nList\nactual-order attack\nactual-order charge\nExit\n")
# What the JAX package's REPL (its JaxBackend) prints on REPL_SCRIPT;
# tests/test_torch_backends.py holds this text against it.
REPL_GOLDEN = """\
G1, primary, state=NF
G2, secondary, state=NF
G3, secondary, state=NF
G4, secondary, state=NF
G1, primary, majority=attack, state=NF
G2, secondary, majority=attack, state=NF
G3, secondary, majority=attack, state=NF
G4, secondary, majority=attack, state=NF
Execute order: attack! Non-faulty nodes in the system - 3 out of 4 quorum suggests attack
G1, state=NF
G2, state=F
G3, state=NF
G4, state=NF
G1, primary, majority=retreat, state=NF
G2, secondary, majority=retreat, state=F
G3, secondary, majority=retreat, state=NF
G4, secondary, majority=retreat, state=NF
Execute order: retreat! 1 faulty node(s) in the system - 3 out of 4 quorum suggests retreat
P2, True
P3, False
P4, False
P5, False
P6, False
G2, primary, majority=attack, state=F
G3, secondary, majority=attack, state=NF
G4, secondary, majority=attack, state=NF
G5, secondary, majority=attack, state=NF
G6, secondary, majority=attack, state=NF
Execute order: attack! 1 faulty node(s) in the system - 3 out of 5 quorum suggests attack
G2, primary, majority=charge, state=F
G3, secondary, majority=retreat, state=NF
G4, secondary, majority=retreat, state=NF
G5, secondary, majority=retreat, state=NF
G6, secondary, majority=retreat, state=NF
Execute order: retreat! 1 faulty node(s) in the system - 3 out of 5 quorum suggests retreat
"""
# The lines before the faulty leader's first round (G2 leads after g-kill 1):
# the py oracle draws its coins from Python's random, so only these are its too.
REPL_COIN_FREE_LINES = 24
REPL_CARD_BACKEND = "cuda"  # the launcher's --backend on the card
# the full roster; run-rounds' two runs (the timed one 256 rounds: the time limit)
N_REPL, R_REPL, R_REPL_TIMED = 1000, 32, 256
N_REPL_EIG = 100  # the m = 2 roster: OM(2) by the EIG tree, K9 at its resolve level
RPD_REPL_CKPT = 2  # the checkpointed campaign's rounds a dispatch (three dispatches)
CASCADING = os.path.join(ROOT, "examples", "scenarios", "cascading_failover.json")
K1_REPL_WRAPPERS = {"K1 plain": scenario_step.cuda_pipeline_megastep,
                    "K1 scenario": scenario_step.cuda_scenario_megastep}
SIGNED_GOLDEN = ("Execute order: retreat! Non-faulty nodes in the system - "
                 "3 out of 4 quorum suggests retreat")  # tests/test_backends.py:120-122
# The signed session: SM(1) with Ed25519 at n = 4, run-rounds through the signed
# pipelined engine; its lines differ between backends only in sign_ahead_s's value.
SIGNED_SCRIPT = "g-state 2 faulty\nrun-rounds attack 8\nExit\n"
SIGNED_ARGS = ("--protocol", "sm", "--signed")
SIGN_AHEAD = re.compile(r"sign_ahead_s=[0-9.e-]+")


def reset_all_launches():
    scenario_step.reset_launches()
    majority.reset_launches()
    reset_ed_launches()


def launcher(backend, script=REPL_SCRIPT, args=()):
    """``script`` through ``python -m ba_tpu_torch.runtime.main 4 --backend
    <backend> <args>`` -> (stdout, wall s); it must exit 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ba_tpu_torch.runtime.main", "4", "--backend", backend, *args],
        input=script, capture_output=True, text=True, timeout=600, cwd=ROOT)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the launcher with --backend {backend} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, wall


def repl(cluster, lines, walls=None, tag=""):
    """``lines`` through the port's REPL -> the printed lines; ``walls``
    takes each line's host wall seconds under ``"<tag>: <line>"`` (a
    line's output is fetched, so its device work is done)."""
    out = []
    for line in lines:
        t0 = time.perf_counter()
        handle_command(cluster, line, out.append)
        if walls is not None:
            walls[f"{tag}: {line.replace(ROOT + os.sep, '')}"] = time.perf_counter() - t0
    return out


def roster(backend, n=N_REPL):
    """A cluster of ``n`` generals on ``backend`` with every third one (ids
    3, 6, ...: lieutenants) made faulty by ``g-state <id> faulty`` lines ->
    (cluster, the lines printed)."""
    cluster = Cluster(n, backend, seed=0)
    return cluster, repl(cluster, [f"g-state {gid} faulty" for gid in range(3, n + 1, 3)])


def k1_flat(out):
    """A megastep's outputs as a flat list of tensors (state, counter, the rest)."""
    state, sched, *rest = out
    return [*state.tensors(), sched.counter, *rest]


def k1_repl_path(path, calls, launches, int_ops_per_s):
    """The REPL path's K1 dispatches, recorded (inputs copied before each):
    each again through its wrapper, bit-equal to the path's own output and
    to the plain megastep's on the same inputs; the first one's CUDA-event
    time as launched and queued, its plain time and its bound.  Dispatches
    replayed must equal the launches counted on the path's run."""
    check(len(calls) == launches,
          f"K1 on {path}: {len(calls)} dispatches recorded, {launches} launches counted")
    err = 0
    for key, args, kw, recorded, _ in calls:
        kernel = K1_REPL_WRAPPERS[key]
        plain = pipeline.scenario_megastep if key == "K1 scenario" else pipeline.pipeline_megastep
        got = k1_flat(kernel(*pipeline.fresh_copy(args), **kw))
        check(max_abs_err(zip(got, k1_flat(recorded))) == 0,
              f"a replayed {key} dispatch of {path} differs from the path's own output")
        err = max(err, max_abs_err(zip(got, k1_flat(plain(*pipeline.fresh_copy(args), **kw)))))
    key, args, kw, _, _ = calls[0]
    kernel = K1_REPL_WRAPPERS[key]
    plain = pipeline.scenario_megastep if key == "K1 scenario" else pipeline.pipeline_megastep
    _, plain_ms = timed_plain(lambda: plain(*pipeline.fresh_copy(args), **kw))
    copies = iter([pipeline.fresh_copy(args) for _ in range(22)])
    ms = time_cuda(lambda: kernel(*next(copies), **kw), reps=10)
    device_ms = time_cuda(lambda: kernel(*next(copies), **kw), reps=10, queued=True)
    state, R = args[0], kw["rounds"]
    B, n = state.faulty.shape
    if key == "K1 scenario":
        words, steps = work_counts(state, R, strategy=args[2], events=args[4])
    else:
        words, steps = work_counts(state, R)
    nbytes = k1_bytes(B, n, R, scenario=key == "K1 scenario")
    bound_ms, bound_by = bound(words, steps, nbytes, int_ops_per_s)
    return {"path": path, "launches": launches, "calls": 1, "dispatches_replayed": len(calls),
            "max_abs_err": err, "shape": {"B": B, "n": n, "R": R}, "ms_each": ms,
            "device_ms_each": device_ms, "plain_ms_each": plain_ms, "bound_ms_each": bound_ms,
            "bound_by": bound_by}


def phase_repl_cuda(dev, card, int_ops_per_s):
    """The host shell on the card, through the entry points a user calls.

    1. REPL_SCRIPT through the launcher with the card's backend, the CPU's
       torch backend and the py oracle, three processes: the card's stdout
       byte-equal to the torch backend's and to REPL_GOLDEN (the JAX
       package's output), and its first REPL_COIN_FREE_LINES lines to the
       py oracle's.
    2. A roster of N_REPL generals (capacity 1024), every third one faulty:
       ``actual-order attack``, ``run-rounds attack 32`` and ``scenario``
       of cascading_failover.json on the card and on the CPU, every line
       equal; then ``run-rounds attack 256`` on the card alone (32 K1
       dispatches of 8 rounds), timed, and once more with its dispatches
       recorded, each replayed against the plain megastep.  At m = 2 on
       N_REPL_EIG generals: ``actual-order attack`` and ``run-rounds
       attack 4`` on the card and the CPU (K9 at the resolve level).
    3. ``scenario <file> <dir>/ck_{round}.npz 2`` on the card, two rounds a
       dispatch: each file validates, and each one before the campaign's
       end resumes on the CPU's torch engine bit-equal to the card's run;
       the campaign once more with its dispatches recorded and replayed.
    4. One signed round, ``actual-order retreat`` on SM(1) with Ed25519 at
       n = 4: the reference's quorum line; K7, K5, K4 and K3 launched, and
       the round once more with its dispatches recorded.
    5. The signed session, ``main 4 --protocol sm --signed`` on SIGNED_SCRIPT
       (``run-rounds attack 8``: the signed megastep behind the sign-ahead
       lane and its default pool) with ``--backend`` cuda and torch (the
       CPU): every line equal but ``sign_ahead_s``'s value.  In-process,
       the same ``run-rounds`` on the card launches K7, K5, K4 and K3 once
       each (the last round's recomputed check), and once more recorded.
    """
    walls = {}
    std = {b: launcher(b) for b in (REPL_CARD_BACKEND, "torch", "py")}
    card_out = std[REPL_CARD_BACKEND][0]
    check(card_out == REPL_GOLDEN, "the launcher's stdout on the card differs from the "
          "JAX package's REPL output")
    check(card_out == std["torch"][0], "the launcher's stdout differs between card and CPU")
    k = REPL_COIN_FREE_LINES
    check(card_out.splitlines()[:k] == std["py"][0].splitlines()[:k],
          "the launcher's coin-free lines differ from the py oracle's")

    # The walls read warm calls: each timed command's first call in the
    # process (CUDA's context, torch's and the kernels' module loads) runs
    # on a throwaway cluster of the same shape first.
    repl(roster(TorchBackend(device=dev))[0], ["actual-order attack"])
    on_card, card_lines = roster(TorchBackend(device=dev))
    on_cpu, cpu_lines = roster(TorchBackend(device="cpu"))
    lines = ["actual-order attack", f"run-rounds attack {R_REPL}", f"scenario {CASCADING}"]
    reset_all_launches()
    card_lines += repl(on_card, lines, walls, f"n {N_REPL}")
    plain_launches = scenario_step.cuda_pipeline_megastep.launches
    scen_launches = scenario_step.cuda_scenario_megastep.launches
    cpu_lines += repl(on_cpu, lines)
    check(card_lines == cpu_lines, "the full roster's lines differ between card and CPU")
    check(plain_launches == R_REPL // 8 and scen_launches == 1,
          f"K1 launches {plain_launches} plain, {scen_launches} scenario")

    timed, _ = roster(TorchBackend(device=dev))
    line = f"run-rounds attack {R_REPL_TIMED}"
    start = timed._round
    reset_all_launches()
    sync()
    timed_lines = repl(timed, [line], walls, f"n {N_REPL}, alone")
    run_rounds_s = walls[f"n {N_REPL}, alone: {line}"]
    timed_launches = scenario_step.cuda_pipeline_megastep.launches
    check(timed_launches == R_REPL_TIMED // 8, f"run-rounds: {timed_launches} K1 launches")
    check(timed_lines[-1] == f"Rounds: {R_REPL_TIMED} - attack={R_REPL_TIMED}, retreat=0, "
          "undefined=0", f"run-rounds: {timed_lines[-1]}")
    timed._round = start  # the same round seeds again
    with recording(K1_REPL_WRAPPERS, snapshot=True) as calls:
        again = repl(timed, [line])
    check(again == timed_lines, "the recorded run-rounds printed other lines")
    plain_path = k1_repl_path(f"repl_cuda: {line} (n {N_REPL})", calls, timed_launches,
                              int_ops_per_s)
    check(plain_path["max_abs_err"] == 0, "a run-rounds dispatch differs from the plain megastep")

    eig_lines = ["actual-order attack", "run-rounds attack 4"]
    repl(roster(TorchBackend(device=dev, m=2), N_REPL_EIG)[0], ["actual-order attack"])
    eig_card, _ = roster(TorchBackend(device=dev, m=2), N_REPL_EIG)
    reset_all_launches()
    got = repl(eig_card, eig_lines, walls, f"m 2, n {N_REPL_EIG}")
    k9_launches = majority.masked_majority_rows.launches
    check(got == repl(roster(TorchBackend(device="cpu", m=2), N_REPL_EIG)[0], eig_lines),
          "the m = 2 roster's lines differ between card and CPU")
    check(k9_launches > 0, "the m = 2 roster launched no K9")
    with recording(K9_WRAPPERS) as k9_calls:
        again = repl(roster(TorchBackend(device=dev, m=2), N_REPL_EIG)[0], eig_lines)
    check(again == got, "the recorded m = 2 roster printed other lines")

    spec = scenario_spec.load(CASCADING)
    ck_dir = os.path.join(CKPT_DIR, "repl")
    os.makedirs(ck_dir, exist_ok=True)
    atexit.register(shutil.rmtree, CKPT_DIR, True)
    ckpt, _ = roster(TorchBackend(device=dev, rounds_per_dispatch=RPD_REPL_CKPT))
    ids = np.array([g.id for g in ckpt.generals] + [0] * (CAP_FULL - N_REPL), np.int64)
    results = []
    run = ckpt.backend.run_scenario
    ckpt.backend.run_scenario = lambda *a, **kw: results.append(run(*a, **kw)) or results[-1]
    line = f"scenario {CASCADING} {ck_dir}/ck_{{round}}.npz 2"
    reset_all_launches()
    ck_lines = repl(ckpt, [line], walls, f"n {N_REPL}, 2 rounds a dispatch")
    ck_launches = scenario_step.cuda_scenario_megastep.launches
    check(ck_launches == -(-spec.rounds // RPD_REPL_CKPT),
          f"checkpointed scenario: {ck_launches} K1 launches")
    res = results[0]
    check(ck_lines[-1] == f"Scenario checkpoints: {spec.rounds // 2} -> {ck_dir}/ck_{{round}}.npz",
          f"checkpointed scenario: {ck_lines[-1]}")
    block = scenario_compile.compile_scenario(spec, batch=1, capacity=CAP_FULL, ids=ids,
                                              sparse=True)
    resumed = []
    for r in range(2, spec.rounds + 1, 2):
        path = os.path.join(ck_dir, f"ck_{r}.npz")
        meta = snapshot.validate_carry_checkpoint(path)
        check(meta["round"] == r and meta["scenario"], f"{path}: {meta}")
        if r == spec.rounds:
            continue
        out = pipeline.pipeline_sweep(None, None, spec.rounds, resume=path, scenario=block,
                                      rounds_per_dispatch=RPD_REPL_CKPT, collect_decisions=True,
                                      engine="torch", device="cpu")
        check(out["decisions"][:, 0].tolist() == res["decisions"][r:]
              and out["leaders"][:, 0].tolist() == res["leaders"][r:]
              and out["counters"] == res["counters"]
              and out["final_state"].alive[0, :N_REPL].tolist() == res["alive"]
              and out["final_state"].faulty[0, :N_REPL].tolist() == res["faulty"],
              f"the resume from round {r} on the CPU differs from the card's run")
        resumed.append(r)
    replay_ckpt, _ = roster(TorchBackend(device=dev, rounds_per_dispatch=RPD_REPL_CKPT))
    with recording(K1_REPL_WRAPPERS, snapshot=True) as s_calls:
        again = repl(replay_ckpt, [line.replace("/ck_", "/again_ck_")])
    check(again[:2] == ck_lines[:2], "the recorded checkpointed scenario printed other lines")
    scen_path = k1_repl_path(f"repl_cuda: scenario cascading_failover.json, checkpoints "
                             f"every 2 (n {N_REPL})", s_calls, ck_launches, int_ops_per_s)
    check(scen_path["max_abs_err"] == 0, "a scenario dispatch differs from the plain megastep")

    signed_backend = TorchBackend(device=dev, protocol="sm", signed=True)
    repl(Cluster(4, signed_backend, seed=1), ["actual-order retreat"])
    signed_cluster = Cluster(4, signed_backend, seed=1)
    reset_all_launches()
    signed_lines = repl(signed_cluster, ["actual-order retreat"], walls, "SM(1) signed, n 4")
    signed_launches = ed_launches()
    check(signed_lines[-1] == SIGNED_GOLDEN, f"signed round: {signed_lines[-1]}")
    check(all(signed_launches[k] > 0 for k in ("K7", "K5", "K4", "K3")),
          f"signed round launches {signed_launches}")
    with recording(ED_WRAPPERS) as ed_calls:
        again = repl(Cluster(4, TorchBackend(device=dev, protocol="sm", signed=True), seed=1),
                     ["actual-order retreat"])
    check(again == signed_lines, "the recorded signed round printed other lines")

    signed_std = {b: launcher(b, SIGNED_SCRIPT, SIGNED_ARGS) for b in (REPL_CARD_BACKEND, "torch")}
    masked = {b: SIGN_AHEAD.sub("sign_ahead_s=*", out).splitlines()
              for b, (out, _) in signed_std.items()}
    check(masked[REPL_CARD_BACKEND] == masked["torch"],
          "the signed session's lines differ between card and CPU")
    check(masked["torch"][-2:] == ["Rounds: 8 - attack=8, retreat=0, undefined=0",
                                   "Signed lane: sign_ahead_s=*, dispatches=1"],
          f"the signed session printed {masked['torch'][-2:]}")
    rr_line = "run-rounds attack 8"
    rr = Cluster(4, TorchBackend(device=dev, protocol="sm", signed=True), seed=1)
    repl(rr, ["g-state 2 faulty"])
    reset_all_launches()
    rr_lines = repl(rr, [rr_line], walls, "SM(1) signed, n 4")
    rr_launches = ed_launches()
    check(all(rr_launches[k] == 2 for k in LANE_KERNELS)
          and sum(rr_launches.values()) == 2 * len(LANE_KERNELS),
          f"signed run-rounds launches {rr_launches}")  # the lane's one pass, the last round
    with recording(ED_WRAPPERS) as rr_calls:
        rr_again = Cluster(4, TorchBackend(device=dev, protocol="sm", signed=True), seed=1)
        again = repl(rr_again, ["g-state 2 faulty", rr_line])[4:]
    check([SIGN_AHEAD.sub("", x) for x in again] == [SIGN_AHEAD.sub("", x) for x in rr_lines],
          "the recorded signed run-rounds printed other lines")

    serve_seg = repl_serve(dev)

    emit({"phase": "repl_cuda", "card": card,
          "launcher": {"stdout_bytes": len(card_out), "equal_to_reference_golden": True,
                       "equal_to_torch_cpu": True, "coin_free_lines_equal_to_py": k,
                       "wall_s": {b: w for b, (_, w) in std.items()}},
          "roster": {"n": N_REPL, "capacity": CAP_FULL, "faulty": N_REPL // 3,
                     "lines_equal_to_cpu": len(card_lines)},
          "command_wall_s": walls,
          "run_rounds_agreement_rounds_per_s": R_REPL_TIMED / run_rounds_s,
          # K1's share of run-rounds' wall: its dispatches' queued time over the wall
          "run_rounds_k1_share_of_wall": (plain_path["device_ms_each"] * timed_launches
                                          / (run_rounds_s * 1e3)),
          "k1_plain_launches": plain_launches + timed_launches,
          "k1_scenario_launches": scen_launches + ck_launches, "k9_launches": k9_launches,
          "resumed_on_cpu_from_rounds": resumed, "signed_launches": signed_launches,
          "signed_line": signed_lines[-1],
          "serve": {k: v for k, v in serve_seg.items() if k != "calls"},
          "signed_session": {"lines_equal_but_sign_ahead_s": len(masked["torch"]),
                             "wall_s": {b: w for b, (_, w) in signed_std.items()},
                             "signed_lane_lines": [x for x in rr_lines
                                                   if x.startswith("Signed lane")],
                             "run_rounds_launches": rr_launches}})
    return {"plain": plain_launches + timed_launches, "plain_path": plain_path,
            "scenario": scen_launches + ck_launches, "scenario_path": scen_path,
            "slot": ("repl_cuda: serve start batch=8 engine=cuda, 8 requests",
                     serve_seg["calls"], serve_seg["k1_slot_launches"], 1),
            "k9": (f"repl_cuda: m = 2 roster, {' / '.join(eig_lines)} (n {N_REPL_EIG})",
                   k9_calls, k9_launches, 1),
            "ed": [("repl_cuda: signed actual-order retreat (n 4)", ed_calls, signed_launches, 1),
                   (f"repl_cuda: signed {rr_line} (n 4), the lane and the last round's check",
                    rr_calls,
                    rr_launches, 1)]}


# -- the signed SM(m) pipelined engine and its sign-ahead lane -------------------

B_SPM, CAP_SPM, M_SPM, R_SPM, RPD_SPM = 64, 64, 2, 6, 2  # signed_pipeline_middle
CORRUPT_EVERY_SPM = 7  # signed_pipeline_middle: the instances whose tables are corrupted
# signed_pipeline_full_width: config #5's shape through the general engine
B_SPF, CAP_SPF, M_SPF, R_SPF, RPD_SPF, DEPTH_SPF = 10_240, 1024, 3, 16, 4, 2
R_SEQ = 4  # run C's rounds, held against run A's first ones
SIGN_COALESCE = 2  # pipeline_sweep's default: two windows a lane pass
LANE_KERNELS = ("K7", "K5", "K4", "K3")  # the exact verify of the round tables


def signed_arrays(key, B, cap):
    """``make_sweep_state``'s draws with the leader faulty in every fourth
    instance, so the commander-equivocation counter moves."""
    arrays = convert.state_to_numpy(sweep.make_sweep_state(key, B, cap, order=1))
    arrays["faulty"][::4, 0] = True
    return arrays


def same_signed_run(a, b, what, names=("histograms", "decisions", "counters_per_round")):
    for name in names:
        check(np.array_equal(a[name], b[name]), f"{what}: {name} differ")
    check(a["counters"] == b["counters"], f"{what}: counters {a['counters']} != {b['counters']}")
    for name in ("order", "leader", "faulty", "alive", "ids"):
        check(torch.equal(getattr(a["final_state"], name).cpu(),
                          getattr(b["final_state"], name).cpu()), f"{what}: final {name}")


def lane_launches_only(launches, what):
    """The lane's device route launches K7, K5, K4 and K3 and nothing else."""
    check(all(launches[k] > 0 for k in LANE_KERNELS)
          and not any(v for k, v in launches.items() if k not in LANE_KERNELS),
          f"{what}: launches {launches}")


@contextlib.contextmanager
def corrupted_tables(every):
    """While open, the lane's in-process signer flips one byte of the
    ATTACK signature of every ``every``-th instance in every round it
    signs, so those verdicts are False and ``sig_rejections`` moves."""
    from ba_tpu_torch.parallel import signing

    real = signing.SignAheadLane._sign_inprocess

    def corrupt(self, rounds):
        sigs = real(self, rounds)
        sigs[:, ::every, ATTACK, 0] ^= 0xFF
        return sigs

    signing.SignAheadLane._sign_inprocess = corrupt
    try:
        yield
    finally:
        signing.SignAheadLane._sign_inprocess = real


def phase_signed_pipeline_middle(dev, seed):
    """``pipeline_sweep(signed=True)`` at B = 64, capacity 64, m = 2, the
    exact relay, 6 rounds 2 a dispatch, every seventh instance's ATTACK
    signature corrupted in every round: on the card with ``pool=0`` (the
    device route, K7, K5, K4 and K3 verifying each window's tables), then
    on the CPU (the native host verifier).  Decisions, histograms,
    counters (``sig_rejections`` > 0 among them) and the final state
    bit-equal: the kernels' verdicts, rejections included, held against
    the host's along the whole path.  Run once more on the card with its
    dispatches recorded for the kernels line."""
    key = rng.key(seed + 17, device=dev)
    arrays = signed_arrays(key, B_SPM, CAP_SPM)
    kw = dict(signed=True, m=M_SPM, rounds_per_dispatch=RPD_SPM, collect_decisions=True,
              pool=0, cache=0)
    with corrupted_tables(CORRUPT_EVERY_SPM):
        reset_ed_launches()
        card = pipeline.pipeline_sweep(key, to_state(arrays, dev), R_SPM, device=dev, **kw)
        sync()
        launches = ed_launches()
        cpu = pipeline.pipeline_sweep(key.cpu(), to_state(arrays, "cpu"), R_SPM, device="cpu",
                                      **kw)
        with recording(ED_WRAPPERS) as calls:
            again = pipeline.pipeline_sweep(key, to_state(arrays, dev), R_SPM, device=dev, **kw)
    lane_launches_only(launches, "signed_pipeline_middle")
    same_signed_run(card, cpu, "signed pipeline, card against CPU")
    same_signed_run(card, again, "the recorded signed pipeline")
    rejected = len(range(0, B_SPM, CORRUPT_EVERY_SPM)) * R_SPM
    check(card["counters"]["sig_rejections"] == rejected,
          f"sig_rejections {card['counters']['sig_rejections']}, {rejected} corrupted")
    check(card["counters"]["commander_equivocations"] > 0, "no equivocation was counted")
    emit({"phase": "signed_pipeline_middle", "B": B_SPM, "capacity": CAP_SPM, "m": M_SPM,
          "rounds": R_SPM, "rounds_per_dispatch": RPD_SPM, "card_equals_cpu": True,
          "corrupted_every": CORRUPT_EVERY_SPM, "counters": card["counters"],
          "launches": launches})
    return (f"signed_pipeline_middle (B {B_SPM}, corrupted tables)", calls, launches, 1)


def relay_draws(keys, n, m):
    """The threefry draws of one ``signed_agreement_step`` on per-instance
    keys: the splits, round 1's coins and m collapsed relay rounds'
    uniforms (what the step draws, without the rest of the round)."""
    k1, k2 = rng.split(keys).unbind(-2)
    out = [rng.coin_bits(k1, (n,))]
    relay = rng.split(k2).unbind(-2)[1]
    out += [rng.uniform_u8(rng.fold_in(relay, r), (n, 2)) for r in range(1, m + 1)]
    return out


def phase_signed_pipeline_full_width(dev, seed, card):
    """The north star's shape through the general signed engine: B = 10 240
    instances at capacity 1024 (``make_sweep_state``, the leader faulty in
    every fourth), m = 3, the collapsed relay, 16 rounds 4 a dispatch,
    depth 2, ``sign_seed`` 0, two windows a lane pass, no cache.

    A. ``pool=0``: in-process signing, the tables verified on the card
       (the device route: 163 840 lanes a pass in VERIFY_CHUNK pieces,
       K7, K5, K4, K3); launches counted.
    B. the default pool signing (its workers started first, every one
       alive at the end), the tables verified on the card as in A: the
       same launches.
    C. ``sequential_signed_sweep``, the blocking driver, for the first
       R_SEQ rounds, verifying on the card.
    A, B and C bit-equal in decisions, histograms and counters (C against
    A's first R_SEQ rounds), A and B in the final state too.  Then the
    signed megastep of one dispatch and its threefry draws alone (CUDA
    events), and run A once more with its kernel dispatches recorded.
    """
    from ba_tpu_torch.crypto import pool as pool_mod
    from ba_tpu_torch.parallel import signing

    t_phase = time.perf_counter()
    key = rng.key(seed + 5, device=dev)
    arrays = signed_arrays(rng.fold_in(key, 1), B_SPF, CAP_SPF)
    kw = dict(signed=True, m=M_SPF, collapsed=True, rounds_per_dispatch=RPD_SPF,
              depth=DEPTH_SPF, sign_seed=0, sign_coalesce=SIGN_COALESCE,
              collect_decisions=True, cache=0, device=dev)

    def run(pool):
        sync()
        t0 = time.perf_counter()
        out = pipeline.pipeline_sweep(key, to_state(arrays, dev), R_SPF, pool=pool, **kw)
        sync()
        return out, time.perf_counter() - t0

    reset_ed_launches()
    out_a, wall_a = run(0)
    launches = ed_launches()
    lane_launches_only(launches, "run A")
    passes = -(-R_SPF // (RPD_SPF * SIGN_COALESCE))
    lanes = RPD_SPF * SIGN_COALESCE * B_SPF * 2
    check(all(launches[k] == passes * -(-lanes // signed.VERIFY_CHUNK) for k in LANE_KERNELS),
          f"run A: {launches} for {passes} passes of {lanes} lanes")

    workers = pool_mod.default_workers()
    check(workers > 0, f"the default pool has no workers on {os.cpu_count()} cores")
    pool = pool_mod.default_pool()
    check(pool is not None and pool.workers == workers, "the default pool did not start")
    reset_ed_launches()
    out_b, wall_b = run(None)
    check(ed_launches() == launches, f"run B launched {ed_launches()}, run A {launches}")
    check(out_b["stats"]["sign_pool_s"] > 0, "run B: the pool signed nothing")
    check(pool.workers == workers and pool.degraded == 0,
          f"pool: {pool.workers} of {workers} workers alive, {pool.degraded} degraded")
    same_signed_run(out_a, out_b, "run A against run B")

    sync()
    t0 = time.perf_counter()
    out_c = signing.sequential_signed_sweep(key, to_state(arrays, dev), R_SEQ, m=M_SPF,
                                            collapsed=True, device=dev)
    wall_c = time.perf_counter() - t0
    for name in ("histograms", "decisions"):
        check(np.array_equal(out_c[name], out_a[name][:R_SEQ]), f"run C: {name} differ")
    want = dict(zip(pipeline.SIGNED_COUNTER_NAMES, out_a["counters_per_round"][R_SEQ - 1]))
    check(out_c["counters"] == {k: int(v) for k, v in want.items()},
          f"run C counters {out_c['counters']} != run A's {want}")
    check(out_a["counters"]["commander_equivocations"] > 0, "no equivocation was counted")

    # one dispatch of the megastep alone, and its threefry draws alone
    lane = signing.SignAheadLane(B_SPF, pool=0, cache=0, device=dev)
    ok = lane.stage(0, RPD_SPF)
    state = to_state(arrays, dev)
    sched = pipeline.make_key_schedule(key)
    ctr = pipeline.signed_counters_init(dev)
    megastep_ms = time_cuda(lambda: pipeline.signed_megastep(
        state, sched, ctr, ok, rounds=RPD_SPF, m=M_SPF, collapsed=True), reps=3)
    keys = pipeline.round_keys(sched, B_SPF)
    draws_ms = time_cuda(lambda: relay_draws(keys, CAP_SPF, M_SPF), reps=3) * RPD_SPF

    with recording(ED_WRAPPERS) as calls:
        again, _ = run(0)
    same_signed_run(out_a, again, "the recorded run A")
    stats = {tag: {k: out["stats"][k] for k in ("sign_ahead_s", "host_sign_s", "host_verify_s",
                                                 "sign_pool_s", "sign_pool_workers")}
             for tag, out in (("A", out_a), ("B", out_b))}
    sigs = B_SPF * 2 * R_SPF
    emit({"phase": "signed_pipeline_full_width", "card": card, "B": B_SPF,
          "capacity": CAP_SPF, "m": M_SPF, "collapsed": True, "rounds": R_SPF,
          "rounds_per_dispatch": RPD_SPF, "depth": DEPTH_SPF, "sign_coalesce": SIGN_COALESCE,
          "a_equals_b_equals_c": True, "counters": out_a["counters"],
          "wall_s": {"A": wall_a, "B": wall_b, "C": wall_c},
          "agreement_rounds_per_s": {"A": B_SPF * R_SPF / wall_a, "B": B_SPF * R_SPF / wall_b,
                                     "C": B_SPF * R_SEQ / wall_c},
          "lane": stats, "sequential_timings": out_c["timings"],
          "host_signatures_per_s": {tag: sigs / st["host_sign_s"] for tag, st in stats.items()},
          "signatures": sigs, "verify_lanes_a_pass": lanes,
          "megastep_ms_a_dispatch": megastep_ms, "threefry_draws_ms_a_dispatch": draws_ms,
          "threefry_share_of_megastep": draws_ms / megastep_ms,
          "pool_workers": workers, "cpu_count": os.cpu_count(), "launches_a": launches,
          "phase_s": time.perf_counter() - t_phase})
    return ("signed_pipeline_full_width: run A, the lane's device route", calls, launches, 1)


# -- several devices: the mesh slice (phases 34-39) --------------------------

K2S_REPLACES = "ba_tpu/ops/sweep_step.py:299"
K2S_ENTRIES = 4  # the sharded step's four-entry mesh of cuda:0
K2S_MIDDLE_N = (37, 1024)  # phase 6's middle shapes, B = 256, for the recorded shard launches
B_MESH_SMALL, R_MESH, RPD_MESH = 1_000, 8, 4  # the one- and two-entry meshes' batch
# A plain (torch engine) call holds CHUNK instances of n = 1024 at once on the card (the coin
# unpack alone is ~8 MB an instance), so the full-width mesh has B_FULL / CHUNK entries of
# cuda:0, which take turns between the histogram sums.
MESH_FULL_ENTRIES = B_FULL // CHUNK
B_NCCL, N_NCCL, R_NCCL, RPD_NCCL = 64, 128, 4, 2
B_NODE, N_OM1, N_EIG, M_EIG = 16, 256, 64, 2
N_C4_NODE, M_C4_NODE = 1024, 32  # config #4's point (tests/test_sm_parallel.py:211)
B_SIGNED_NODE, N_SIGNED_NODE, M_SIGNED_NODE = 8, 64, 2
# What the JAX package's REPL prints for REPL_MESH_SCRIPT at n = 4, seed 0;
# tests/test_torch_backends.py holds this text against it.
REPL_MESH_SCRIPT = (f"scenario {CASCADING} mesh=1", "g-state", "actual-order attack")
NCCL = "nccl"  # the one-rank group's backend on the card
REPL_MESH_GOLDEN = """\
Scenario cascading-failover: 6 rounds - attack=6, retreat=0, undefined=0
Scenario counters: quorum_failures=0, unanimous_rounds=6, equivocation_observed=0, \
ic1_violations=0, ic2_violations=0
G2, secondary, state=NF
G4, primary, state=NF
G2, secondary, majority=attack, state=NF
G4, primary, majority=attack, state=NF
Execute order: attack! Non-faulty nodes in the system - 1 out of 2 quorum suggests attack
"""


CARD = torch.device("cuda", 0)  # the one card every mesh entry names


def card_mesh(d, node=1):
    """A (d, node) mesh whose entries all name cuda:0."""
    return pmesh.make_mesh((d, node), devices=[CARD] * (d * node))


def k2_shards(mesh, states, oks):
    """Each bucket's K2 inputs split once on the mesh's "data" axis (so
    the timed steps pass Sharded values and copy nothing)."""
    row = pmesh.P("data")
    return [[multihost.put_global(mesh, x, row) for x in (st.order, st.leader, st.faulty, st.alive, ok)]
            for st, ok in zip(states, oks)]


def phase_sharded_sweep_step(card, states, oks, seeds, unsharded_walls):
    """``fused_sharded_sweep_step`` at config #5's shape (phase 10's
    buckets, seeds and verdicts), on a one-entry and a four-entry mesh of
    cuda:0, timed as phase 10 times the unsharded step (a warm-up step,
    then WINDOWS_SIGNED windows of STEPS_SIGNED steps); K2 launched once a
    shard a bucket a step; then every step again, each bucket's decisions
    held against ``fused_signed_sweep_step`` at the same seed (counted
    apart); then the four-entry mesh at phase 6's middle shapes with
    every shard launch recorded and replayed against the plain version
    at its index base.  Returns the four-entry run for the kernels line."""
    n_steps = seeds.shape[0]
    per_window = B_SIGNED * ROUNDS_SIGNED * STEPS_SIGNED
    unsharded = sorted(per_window / w for w in unsharded_walls)
    runs = {}
    for d in (1, K2S_ENTRIES):
        mesh = card_mesh(d)
        shards = k2_shards(mesh, states, oks)
        not_attack = torch.zeros((), dtype=torch.int64, device=mesh.device((0, 0)))

        def step(it):
            outs = []
            for i, args in enumerate(shards):
                dec = sweep_step.fused_sharded_sweep_step(mesh, seeds[it, i:i + 1], *args,
                                                          M_SIGNED, ROUNDS_SIGNED)
                for piece in dec.pieces.values():
                    not_attack.add_((piece != ATTACK).sum())
                outs.append(dec)
            return outs

        sweep_step.reset_launches()
        first = step(0)
        walls = []
        for w in range(WINDOWS_SIGNED):
            sync()
            t0 = time.perf_counter()
            for it in range(w * STEPS_SIGNED + 1, (w + 1) * STEPS_SIGNED + 1):
                step(it)
            sync()
            walls.append(time.perf_counter() - t0)
        launches = sweep_step.fused_signed_sweep_step.launches
        check(launches == d * len(states) * n_steps, f"sharded K2 launches {launches} on {d}")
        check(int(not_attack) == 0, f"SM validity on {d} entries: some decision not ATTACK")
        mismatched = torch.zeros((), dtype=torch.int64, device=not_attack.device)
        for it in range(n_steps):
            for i, (st, ok_b) in enumerate(zip(states, oks)):
                got = sweep_step.fused_sharded_sweep_step(mesh, seeds[it, i:i + 1], *shards[i],
                                                          M_SIGNED, ROUNDS_SIGNED).gather()
                want = sweep_step.fused_signed_sweep_step(
                    *k2_args(seeds[it, i:i + 1], st, ok_b, ROUNDS_SIGNED))
                mismatched.add_((got != want).sum())
        check(int(mismatched) == 0,
              f"the {d}-entry sharded step differs from the unsharded one: {int(mismatched)}")
        rates = sorted(per_window / w for w in walls)
        runs[d] = {"mesh": mesh, "shards": shards, "first": first, "launches": launches}
        emit({"phase": "sharded_sweep_step_full_width", "entries": d, "device": "cuda:0",
              "batch": B_SIGNED, "buckets": [st.batch for st in states], "m": M_SIGNED,
              "rounds_per_dispatch": ROUNDS_SIGNED, "steps": n_steps,
              "kernel_launches": launches, "launches_per_bucket_step": d,
              "steps_bit_equal_unsharded": n_steps, "all_attack": True,
              "window_wall_s": walls,
              "agreement_rounds_per_s": {"best": rates[-1], "median": rates[len(rates) // 2],
                                         "worst": rates[0]},
              "unsharded_median": unsharded[len(unsharded) // 2], "card": card})

    mesh = runs[K2S_ENTRIES]["mesh"]
    rs = np.random.default_rng(18)
    replays, err = 0, 0
    with recording({"K2": sweep_step.fused_signed_sweep_step}) as calls:
        for n in K2S_MIDDLE_N:
            for rounds in (1, 35):
                seed_t, st, ok = k2_inputs(rs, 256, n, CARD)
                sweep_step.fused_sharded_sweep_step(mesh, seed_t, st.order, st.leader,
                                                    st.faulty, st.alive, ok, M_SIGNED, rounds)
    check(len(calls) == K2S_ENTRIES * len(K2S_MIDDLE_N) * 2, f"recorded {len(calls)} launches")
    for _, args, kw, out, _ in calls:
        want = sweep_step.plain_fused_signed_sweep_step(*args, **kw)
        err = max(err, max_abs_err([(out, want)]))
        replays += 1
    check(err == 0, f"a recorded shard launch differs from the plain version: {err}")
    check(sorted({kw["index_base"] for _, _, kw, _, _ in calls}) == [0, 64, 128, 192],
          "the shards' index bases")
    emit({"phase": "sharded_sweep_step_middle", "entries": K2S_ENTRIES, "B": 256,
          "n": list(K2S_MIDDLE_N), "rounds": [1, 35], "recorded_launches": replays,
          "max_abs_err": err})
    runs[K2S_ENTRIES]["middle_replays"] = replays
    return runs[K2S_ENTRIES]


def kernel_line_k2_sharded(run, states, oks, seeds, int_ops_per_s):
    """The four-entry main path's warm-up step again, bucket by bucket:
    each shard's piece against the plain version at its index base (and
    the main path's piece), the step's CUDA-event time, the plain time
    and the bound summed over the shards."""
    mesh, shards, first = run["mesh"], run["shards"], run["first"]
    buckets, err = [], 0
    for i, (st, ok_b) in enumerate(zip(states, oks)):
        seed_i = seeds[0, i:i + 1]
        dec = sweep_step.fused_sharded_sweep_step(mesh, seed_i, *shards[i], M_SIGNED,
                                                  ROUNDS_SIGNED)
        per = st.batch // K2S_ENTRIES
        plain_ms = bound_ms = 0.0
        by = []
        for pos, piece in dec.pieces.items():
            rows = slice(pos[0] * per, (pos[0] + 1) * per)
            sub = rows_of(st, rows.start, rows.stop)
            args = k2_args(seed_i, sub, ok_b[rows], ROUNDS_SIGNED)
            want, ms = timed_plain(lambda: sweep_step.plain_fused_signed_sweep_step(
                *args, index_base=rows.start))
            plain_ms += ms
            err = max(err, max_abs_err([(piece, want)]))
            check(torch.equal(piece, first[i].pieces[pos]),
                  f"main path's shard {pos} of bucket {i} differs from the replay")
            b_ms, b_by, _ = k2_bound(sub, k2_philox_calls(sub, ROUNDS_SIGNED), ROUNDS_SIGNED,
                                     M_SIGNED, int_ops_per_s)
            bound_ms += b_ms
            by.append(b_by)
        ms = time_cuda(lambda: sweep_step.fused_sharded_sweep_step(
            mesh, seed_i, *shards[i], M_SIGNED, ROUNDS_SIGNED), reps=10)
        buckets.append({"B": st.batch, "n": st.n, "shards": K2S_ENTRIES, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "operations" if all(b == "operations" for b in by)
                        else "bytes"})
    check(err == 0, f"full-width shard launch differs from plain: {err}")
    return {"name": "sweep_step_sharded", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2S_REPLACES,
            "wrapper": "ba_tpu_torch/ops/sweep_step.py:fused_sharded_sweep_step",
            "launches": run["launches"], "max_abs_err": err,
            "ms": sum(b["ms"] for b in buckets),
            "plain_ms": sum(b["plain_ms"] for b in buckets),
            "bound_ms": sum(b["bound_ms"] for b in buckets),
            "bound_by": "operations" if all(b["bound_by"] == "operations" for b in buckets)
            else "bytes", "library_ms": None, "checked_against_plain": True,
            "per": f"step ({K2S_ENTRIES} shard launches a bucket, one entry each of cuda:0)",
            "middle_replays": run["middle_replays"], "design": K2_DESIGN,
            "ptxas": PTXAS["sweep_step.cu"], "buckets": buckets}


def host(x) -> np.ndarray:
    """A tensor (on any device) or a Sharded value as a host array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same_outputs(a, b, names, what):
    for name in names:
        check(np.array_equal(np.asarray(a[name]), np.asarray(b[name])), f"{what}: {name}")
    check(a["counters"] == b["counters"], f"{what}: counters")


def phase_mesh_pipeline(dev, seed, card, arrays):
    """``pipeline_sweep(mesh=)`` and ``scenario_sweep(mesh=)`` on meshes of
    cuda:0 against the single-device K1 run at the same key: the plain
    campaign (phase 4's arrays, every fourth leader faulty, R_MESH rounds
    RPD_MESH a dispatch, counters and decisions) on a one- and a
    two-entry mesh at B_MESH_SMALL and on MESH_FULL_ENTRIES entries at
    B_FULL; the coalition campaign on a two-entry mesh at B_MESH_SMALL,
    checkpointed every 4 rounds, and on MESH_FULL_ENTRIES entries at
    B_FULL.  Every run's engine is "torch" (no K1 launch), its outputs
    bit-equal to K1's.  Returns what phase 36 resumes."""
    key = rng.key(seed + 3, device=dev)
    faulty = dict(arrays, faulty=arrays["faulty"].copy())
    faulty["faulty"][::4, 0] = True
    kw = dict(depth=2, rounds_per_dispatch=RPD_MESH, collect_decisions=True, device=dev)
    names = ("decisions", "histograms", "counters_per_round")

    def on_mesh(what, fn, ref, d, B, out_names, **extra):
        scenario_step.reset_launches()
        sync()
        t0 = time.perf_counter()
        out = fn(mesh=card_mesh(d), **extra)
        wall = time.perf_counter() - t0
        launched = (scenario_step.cuda_pipeline_megastep.launches
                    + scenario_step.cuda_scenario_megastep.launches)
        check(launched == 0, f"{what}: K1 launched on the mesh")
        stats = out["stats"]
        check(stats["engine"] == "torch" and stats["shards"] == d, f"{what}: engine, shards")
        same_outputs(out, ref, out_names, f"{what} on {d} entries")
        emit({"phase": "mesh_pipeline_full_width", "campaign": what, "entries": d,
              "device": "cuda:0", "B": B, "capacity": CAP_FULL, "rounds": R_MESH,
              "rounds_per_dispatch": RPD_MESH, "bit_equal_k1": True, "wall_s": wall,
              "agreement_rounds_per_s": R_MESH * B / wall,
              "carry_bytes_per_shard": stats["carry_bytes_per_shard"],
              "plane_peak_bytes_per_shard": stats["plane_peak_bytes_per_shard"],
              "engine": stats["engine"], "engine_fallback": stats["engine_fallback"],
              "counters": out["counters"], "card": card})
        return out

    for B, entries in ((B_MESH_SMALL, (1, 2)), (B_FULL, (MESH_FULL_ENTRIES,))):
        sub = {k: v[:B] for k, v in faulty.items()}
        ref = pipeline.pipeline_sweep(key, to_state(sub, dev), R_MESH, engine="cuda",
                                      with_counters=True, **kw)
        check(ref["stats"]["engine"] == "cuda", "the reference run is K1's")
        for d in entries:
            out = on_mesh("plain", functools.partial(
                pipeline.pipeline_sweep, key, to_state(sub, dev), R_MESH, with_counters=True,
                **kw), ref, d, B, names)
            check(np.array_equal(np.asarray(out["final_counters"]).sum(0),
                                 ref["final_counters"].cpu().numpy()), "final counters")

    spec = scenario_spec.load(COALITION)
    s_arrays = sweep_arrays(rng.fold_in(key, 2000), B_FULL, CAP_FULL,
                            order=0 if spec.order == "retreat" else 1)
    s_names = ("decisions", "leaders", "histograms", "counters_per_round")
    small = None
    for B, d in ((B_MESH_SMALL, 2), (B_FULL, MESH_FULL_ENTRIES)):
        sub = {k: v[:B] for k, v in s_arrays.items()}
        block = scenario_compile.compile_scenario(spec, B, CAP_FULL, sparse=True)
        ref = pipeline.scenario_sweep(key, to_state(sub, dev), block, engine="cuda", **kw)
        extra = {}
        if B == B_MESH_SMALL:
            os.makedirs(CKPT_DIR, exist_ok=True)
            extra = dict(checkpoint_every=4,
                         checkpoint_path=os.path.join(CKPT_DIR, "mesh2_{round}.npz"))
        out = on_mesh("coalition", functools.partial(
            pipeline.scenario_sweep, key, to_state(sub, dev), block, **kw, **extra),
            ref, d, B, s_names)
        for name in ("leader", "faulty", "alive"):
            check(np.array_equal(np.asarray(getattr(out["final_state"], name)),
                                 getattr(ref["final_state"], name).cpu().numpy()),
                  f"coalition final {name}")
        if B == B_MESH_SMALL:
            small = dict(key=key, sub=sub, block=block, ref=ref, kw=kw,
                         path=os.path.join(CKPT_DIR, "mesh2_4.npz"))
    return small


def phase_mesh_checkpoint_reshard(dev, card, small):
    """Phase 35's two-entry coalition checkpoint at round 4: its header's
    layout is the mesh's, it resumes on one device through K1 (engine
    "cuda"), and a live carry of it ([2, C] counters, Sharded planes)
    resumes without a mesh; each tail bit-equal to K1's uninterrupted
    run."""
    path, block, ref, kw = small["path"], small["block"], small["ref"], small["kw"]
    meta, _ = snapshot.read_carry_checkpoint(path)
    check(meta["shard_layout"] == {"data": 2, "node": 1}, f"layout {meta['shard_layout']}")
    names = ("decisions", "leaders", "counters_per_round")

    def tail_ok(tail, what):
        for name in names:
            check(np.array_equal(tail[name], ref[name][4:]), f"{what}: {name}")
        check(tail["counters"] == ref["counters"], f"{what}: counters")

    scenario_step.reset_launches()
    t0 = time.perf_counter()
    tail = pipeline.scenario_sweep(None, None, block, resume=path, engine="cuda", **kw)
    file_s = time.perf_counter() - t0
    tail_ok(tail, "resume from the mesh file")
    check(scenario_step.cuda_scenario_megastep.launches == 1, "K1 ran the resumed tail")
    ck = pipeline.load_carry_checkpoint(path, dev)
    mesh = card_mesh(2)
    live = pipeline.CarryCheckpoint(
        state=pmesh.shard_state(mesh, ck.state), schedule=ck.schedule,
        counters=pshard.expand_counters(mesh, ck.counters),
        strategy=multihost.put_global(mesh, ck.strategy, pmesh.P("data")), round=ck.round,
        shard_layout=pshard.shard_layout(mesh))
    check(live.counters.shape == (2, len(pipeline.SCENARIO_COUNTER_NAMES)), "live [2, C]")
    t0 = time.perf_counter()
    tail = pipeline.scenario_sweep(None, None, block, resume=live, engine="cuda", **kw)
    live_s = time.perf_counter() - t0
    tail_ok(tail, "resume of the live [2, C] carry")
    emit({"phase": "mesh_checkpoint_reshard", "written_on_entries": 2,
          "shard_layout": meta["shard_layout"], "resumed_on": "one device, engine cuda",
          "round": meta["round"], "bit_equal": True, "resume_file_s": file_s,
          "resume_live_s": live_s, "card": card})


def phase_distributed_nccl(dev, card):
    """A one-rank NCCL group (``init_distributed`` with a
    tcp://127.0.0.1:<free port> method) and ``make_global_mesh()`` over
    it: ``sharded_sweep``, one sharded K2 step and two dispatches of
    ``pipeline_sweep(mesh=)`` with counters (each round's histogram sum an
    NCCL all-reduce), each bit-equal to the same call on an in-process
    mesh of the same shape; the group is destroyed at the end."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ranks = multihost.init_distributed(f"127.0.0.1:{port}", 1, 0)
    init_s = time.perf_counter() - t0
    try:
        check(ranks == 1 and dist.get_backend() == NCCL, "a one-rank NCCL group")
        group_mesh = multihost.make_global_mesh()
        check(group_mesh.group is not None, "the global mesh keeps the group")
        local = pmesh.make_mesh(tuple(group_mesh.shape.values()),
                                devices=list(group_mesh.devices.flat))
        key = rng.key(37, device=dev)
        arrays = sweep_arrays(key, B_NCCL, N_NCCL, order=1)
        arrays["faulty"][::4, 0] = True
        walls = {}

        def both(name, fn):
            outs = []
            for mesh in (group_mesh, local):
                sync()
                t = time.perf_counter()
                outs.append(fn(mesh))
                sync()
                walls.setdefault(name, []).append(time.perf_counter() - t)
            return outs

        a, b = both("sharded_sweep", lambda mesh: sweep.sharded_sweep(
            mesh, rng.key(9, device=dev), to_state(arrays, dev)))
        for name in ("majorities", "decision", "histogram"):
            check(np.array_equal(np.asarray(a[name]), np.asarray(b[name])), f"sweep {name}")
        seed_t, st, ok = k2_inputs(np.random.default_rng(37), B_NCCL, N_NCCL, dev)
        args = (seed_t, st.order, st.leader, st.faulty, st.alive, ok, M_SIGNED, 35)
        sweep_step.reset_launches()
        a, b = both("k2_step", lambda mesh: sweep_step.fused_sharded_sweep_step(mesh, *args))
        check(sweep_step.fused_signed_sweep_step.launches == 2 * group_mesh.size, "K2 launches")
        check(np.array_equal(np.asarray(a), np.asarray(b)), "sharded K2 step")
        check(np.array_equal(np.asarray(a), sweep_step.fused_signed_sweep_step(*args).cpu()),
              "sharded K2 step against the unsharded one")
        kw = dict(rounds_per_dispatch=RPD_NCCL, collect_decisions=True, with_counters=True)
        a, b = both("pipeline_sweep", lambda mesh: pipeline.pipeline_sweep(
            key, to_state(arrays, dev), R_NCCL, mesh=mesh, **kw))
        same_outputs(a, b, ("decisions", "histograms", "counters_per_round"), "NCCL pipeline")
        check(a["stats"]["dispatches"] == 2, "two dispatches")
    finally:
        dist.destroy_process_group()
    emit({"phase": "distributed_nccl", "backend": NCCL, "ranks": 1,
          "mesh": group_mesh.shape, "init_s": init_s, "bit_equal_in_process": True,
          "walls_s": {k: {"group": v[0], "in_process": v[1]} for k, v in walls.items()},
          "B": B_NCCL, "n": N_NCCL, "card": card})


def phase_node_sharded(dev, card):
    """``om1_node_sharded`` (B_NODE, N_OM1), ``eig_node_sharded`` (n =
    N_EIG, m = M_EIG) and ``sm_node_sharded`` at config #4's point (B = 1,
    n = 1024, m = 32, collapsed, the first 32 generals faulty) on a (1, 2)
    mesh of cuda:0, each bit-equal to the same call on a (1, 2) CPU mesh;
    ``signed_sm_agreement_sharded`` (B_SIGNED_NODE, N_SIGNED_NODE) on the
    card verifies through K7, K5, K4 and K3 and equals the CPU's."""
    card_m = card_mesh(1, 2)
    cpu_m = pmesh.make_mesh((1, 2), devices=[CPU] * 2)
    rs = np.random.default_rng(38)

    def arrays_of(B, n, faulty):
        leader = rs.integers(0, n, B).astype(np.int32)
        f = np.zeros((B, n), bool)
        f[:, :faulty] = True
        return dict(order=rs.integers(0, 2, B).astype(np.int8), leader=leader, faulty=f,
                    alive=rs.random((B, n)) < 0.95,
                    ids=np.tile(np.arange(1, n + 1, dtype=np.int32), (B, 1)))

    cases = [("om1_node_sharded", nparallel.om1_node_sharded, arrays_of(B_NODE, N_OM1, 60), ()),
             ("eig_node_sharded", eparallel.eig_node_sharded, arrays_of(B_NODE, N_EIG, 15),
              (M_EIG,)),
             ("sm_node_sharded_config4", smparallel.sm_node_sharded,
              dict(arrays_of(1, N_C4_NODE, 32), leader=np.zeros(1, np.int32)), (M_C4_NODE,))]
    walls = {}
    for name, fn, arrays, extra in cases:
        fn(card_m, rng.key(5, device=dev), to_state(arrays, dev), *extra)  # warm
        sync()
        t0 = time.perf_counter()
        got = fn(card_m, rng.key(5, device=dev), to_state(arrays, dev), *extra)
        np.asarray(got["decision"])
        walls[name] = time.perf_counter() - t0
        want = fn(cpu_m, rng.key(5, device="cpu"), to_state(arrays, CPU), *extra)
        for k in want:
            check(np.array_equal(host(got[k]), host(want[k])), f"{name}: {k}")
    arrays = arrays_of(B_SIGNED_NODE, N_SIGNED_NODE, 8)
    reset_ed_launches()
    t0 = time.perf_counter()
    got = signed.signed_sm_agreement_sharded(card_m, rng.key(6, device=dev), to_state(arrays, dev),
                                             M_SIGNED_NODE, seed=3)
    np.asarray(got["decision"])
    walls["signed_sm_agreement_sharded"] = time.perf_counter() - t0
    launched = ed_launches()
    check(all(launched[k] > 0 for k in LANE_KERNELS), f"verify kernels {launched}")
    want = signed.signed_sm_agreement_sharded(cpu_m, rng.key(6, device="cpu"),
                                              to_state(arrays, CPU), M_SIGNED_NODE, seed=3)
    for k in want:
        check(np.array_equal(host(got[k]), host(want[k])), f"signed: {k}")
    emit({"phase": "node_sharded", "mesh": {"data": 1, "node": 2}, "device": "cuda:0",
          "bit_equal_cpu_mesh": True, "wall_s": walls,
          "verify_launches": {k: launched[k] for k in LANE_KERNELS},
          "config4": {"B": 1, "n": N_C4_NODE, "m": M_C4_NODE, "collapsed": True,
                      "rounds_per_s": 1 / walls["sm_node_sharded_config4"]}, "card": card})


def phase_repl_mesh(dev, card):
    """``scenario <file> mesh=1`` through ``handle_command`` on the card:
    the JAX package's bytes (REPL_MESH_GOLDEN) and those of the command
    without ``mesh=``; ``mesh=2`` prints one ``scenario error:`` line
    naming both counts (the card is one device) and runs nothing."""
    walls = {}
    meshed = repl(Cluster(4, TorchBackend(device=dev), seed=0), REPL_MESH_SCRIPT, walls, "mesh=1")
    plain_script = (REPL_MESH_SCRIPT[0].replace(" mesh=1", ""), *REPL_MESH_SCRIPT[1:])
    plain = repl(Cluster(4, TorchBackend(device=dev), seed=0), plain_script, walls, "no mesh")
    check(meshed == plain == REPL_MESH_GOLDEN.splitlines(),
          f"scenario mesh=1 printed {meshed}, without mesh= {plain}")
    cluster = Cluster(4, TorchBackend(device=dev), seed=0)
    scenario_step.reset_launches()
    err = repl(cluster, (REPL_MESH_SCRIPT[0].replace("mesh=1", "mesh=2"),))
    check(len(err) == 1 and err[0].startswith("scenario error: mesh shape (2, 1) needs 2 "
                                              "device(s) but only 1 are available"),
          f"mesh=2 printed {err}")
    check([g.id for g in cluster.generals] == [1, 2, 3, 4] and cluster._round == 0,
          "mesh=2 ran something")
    check(scenario_step.cuda_scenario_megastep.launches == 0, "mesh=2 launched K1")
    emit({"phase": "repl_mesh", "mesh1_equals_golden": True, "mesh2_error": err[0],
          "walls_s": walls, "card": card})


# -- the serving tier: AgreementService, warm serving, the overlapped setup ------

# AgreementService.stats()'s keys, in the JAX package's order
# (ba_tpu/runtime/serve.py:1498-1534); ``serve stat`` prints one line each.
SERVE_STAT_KEYS = ("open", "running", "tier", "window_s", "queue_depth", "queue_limit",
                   "max_batch", "admitted", "completed", "rejected", "expired", "failed",
                   "retries", "stalls", "batches", "batch_s_ewma", "injected",
                   "compiles_on_request_path", "warm", "slo", "slo_reports", "engine")
SERVE_WINDOW_S, STORM_STALL_S = 0.01, 0.05  # bench_serving's window and storm stall
STORM_PLAN = os.path.join(ROOT, "examples", "faults", "deadline_storm.json")
# serve_full_width: the size a user runs a service at
FW_BATCH, FW_QUEUE, FW_CLIENTS, FW_RPD, FW_ROUNDS = 1024, 16_384, 64, 8, 32
FW_PLAIN, FW_SCEN, FW_SIGNED, FW_EIG = 4_096, 512, 64, 64  # 4 096 plain: the time limit
FW_N_SIGNED, FW_N_EIG = 64, 16
FW_SAMPLE = (("run-rounds", 64), ("scenario", 32), ("signed", 16), ("m2", 16))  # 128 in all
WARM_WINDOW_S = 0.2  # serve_warm: one 1 024-slot cohort forms inside it (halved at tier 1)
OVERLAP_CHUNKS = (2, 4)  # setup_signed_tables_overlapped's chunk counts
ALL_WRAPPERS = {**SLOT_WRAPPERS, **ED_WRAPPERS, **K9_WRAPPERS}


def serve_request(i, rounds=SERVE_ROUNDS):
    """bench_serving's request i (bench.py:1542-1551)."""
    return serve.AgreementRequest(kind="run-rounds", order=("attack", "retreat")[i % 2], n=4,
                                  faulty=((2,), (), (1, 3))[i % 3], seed=1000 + i,
                                  rounds=rounds)


def served(svc, reqs):
    """``reqs`` submitted with no deadline and waited for -> (results,
    each request's submit-to-result seconds)."""
    t0 = [time.perf_counter()] * len(reqs)
    tickets = []
    for i, r in enumerate(reqs):
        t0[i] = time.perf_counter()
        tickets.append(svc.submit(r, deadline_s=None))
    results, lat = [], []
    for t, start in zip(tickets, t0):
        results.append(t.result(timeout=600))
        lat.append(time.perf_counter() - start)
    return results, lat


def burst(svc, reqs):
    """``reqs`` admitted to an open service whose dispatcher has not
    started (``open()``), then ``start()``: the dispatcher finds the whole
    burst queued and coalesces it as one cohort, however slowly the host
    admits it -> (results, each request's start-to-result seconds)."""
    tickets = [svc.submit(r, deadline_s=None) for r in reqs]
    t0 = time.perf_counter()
    svc.start()
    results, lat = [], []
    for t in tickets:
        results.append(t.result(timeout=600))
        lat.append(time.perf_counter() - t0)
    return results, lat


def clients(svc, reqs, n_clients, sequential):
    """``reqs`` from ``n_clients`` threads, request i on client i mod
    n_clients: each submits and waits one at a time (``sequential``, as
    bench_serving's clients do) or submits all of its requests, then waits
    -> (results in request order, latencies, wall s)."""
    results, lat = [None] * len(reqs), [0.0] * len(reqs)

    def client(c):
        mine = list(range(c, len(reqs), n_clients))
        if sequential:
            for i in mine:
                (results[i],), (lat[i],) = served(svc, [reqs[i]])
        else:
            res, ls = served(svc, [reqs[i] for i in mine])
            for i, r, x in zip(mine, res, ls):
                results[i], lat[i] = r, x

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(n_clients) as ex:
        list(ex.map(client, range(n_clients)))
    return results, lat, time.perf_counter() - t0


def pct(values, q):
    s = sorted(values)
    return s[min(len(s) - 1, int(len(s) * q))]


def same_result(a, b):
    return all(a.get(k) == b.get(k) for k in ("decisions", "counts", "majorities", "counters",
                                             "leaders"))


def cohorts_of(reqs, results):
    """The served cohorts, each its requests in slot order: results that
    share a run id came from one cohort."""
    groups = {}
    for req, res in zip(reqs, results):
        groups.setdefault(res["run_id"], {})[res["slot"]] = req
    out = []
    for g in groups.values():
        check(sorted(g) == list(range(len(g))), "a run id spans two cohorts")
        out.append([g[s] for s in sorted(g)])
    return out


def executed_cohorts(services):
    """A list that each cohort ``services`` execute from here on is
    appended to, its requests in slot order (each service's ``_execute``
    wrapped on the instance).  Unlike ``cohorts_of`` it tells apart two
    cohorts of the same requests (a probe that repeats a request), and
    cohorts served beside a campaign lane, whose process-wide run scope
    gives them its run id."""
    seen = []
    for svc in services:
        def stand_in(live, _real=svc._execute):
            out = _real(live)
            seen.append([t.request for t in live])
            return out

        svc._execute = stand_in
    return seen


def tickets_for(reqs):
    """Tickets as ``submit`` makes them (a scenario request's planes
    compiled at its capacity)."""
    out = []
    for i, r in enumerate(reqs):
        t = serve.Ticket(r, i, None)
        if r.kind == "scenario":
            cap = serve._capacity(r.n)
            t._block = scenario_compile.compile_scenario(
                r.spec, batch=1, capacity=cap, ids=np.arange(1, cap + 1, dtype=np.int64))
        out.append(t)
    return out


def execute(cfg, dev, reqs):
    """``reqs`` as one cohort through the service's own staging and
    dispatch (``AgreementService._execute`` of a service that never
    starts: no queue, no cache) -> its results."""
    svc = serve.AgreementService(cfg, registry=obs_registry.MetricsRegistry())
    svc._device = dev
    return svc._execute(tickets_for(reqs))[0]


def rerun_recorded(cfg, dev, cohorts):
    """The served cohorts once more, eagerly, each through
    ``AgreementService._execute``, their kernel dispatches recorded (the
    inputs copied before each): the same dispatches the service made."""
    with recording(ALL_WRAPPERS, snapshot=True) as calls:
        for reqs in cohorts:
            execute(cfg, dev, reqs)
    by = {"slot": [], "ed": [], "k9": []}
    for c in calls:
        by["slot" if c[0] in SLOT_WRAPPERS else "k9" if c[0] in K9_WRAPPERS else "ed"].append(c)
    return by


def served_launches(slot_before=0):
    return {"K1 slot": scenario_step.cuda_coalesced_megastep.launches - slot_before,
            "K9": majority.masked_majority_rows.launches, **ed_launches()}


def slot_dispatches(cfg, cohorts):
    """K1 slot-mode dispatches the cohorts make on the card: one a window
    of each cohort whose engine resolves to the kernel."""
    n = 0
    for reqs in cohorts:
        key = serve.cohort_key(reqs[0], cfg.engine, cfg.m)
        engine, m, signed_ = key[3], key[4], key[5]
        if engine in ("cuda", "auto") and m == 1 and not signed_:
            n += len(pipeline._chunks(key[1], cfg.rounds_per_dispatch))
    return n


def repl_serve(dev):
    """Phase 31's ``serve``: ``serve start batch=8 engine=cuda`` on a
    cluster of the card, 8 of bench_serving's requests through its
    service, ``serve stat`` and ``serve stop``; the lines the JAX
    package's, every result bit-equal to its run alone, the K1 slot-mode
    launches accounted for, the cohorts once more recorded."""
    serve_cluster = Cluster(4, TorchBackend(device=dev), seed=0)
    started = repl(serve_cluster, ["serve start batch=8 engine=cuda"])
    check(started == ["serve: started (queue=64, window=0.005s, batch=8)"],
          f"serve start printed {started}")
    svc = serve_cluster._serve_service
    serve_reqs = [serve_request(i) for i in range(SERVE_COHORT)]
    reset_all_launches()
    serve_results, _ = served(svc, serve_reqs)
    serve_launches = scenario_step.cuda_coalesced_megastep.launches
    stat = repl(serve_cluster, ["serve stat"])
    check([x.split(" ")[0] for x in stat] == [f"serve_{k}" for k in SERVE_STAT_KEYS]
          and f"serve_completed {SERVE_COHORT}" in stat and "serve_engine cuda" in stat,
          f"serve stat printed {stat}")
    stopped = repl(serve_cluster, ["serve stop"])
    check(stopped == [f"serve: stopped — admitted={SERVE_COHORT}, completed={SERVE_COHORT}, "
                      f"rejected=0, expired=0, failed=0"], f"serve stop printed {stopped}")
    serve_cfg = serve.ServeConfig(max_batch=SERVE_COHORT, engine="cuda", device=str(dev))
    check(all(same_result(r, execute(serve_cfg, dev, [q])[0])
              for q, r in zip(serve_reqs, serve_results)),
          "a request served through the REPL's service differs from its run alone")
    serve_cohorts = cohorts_of(serve_reqs, serve_results)
    check(serve_launches == slot_dispatches(serve_cfg, serve_cohorts),
          f"the REPL's service: {serve_launches} K1 slot launches")
    serve_calls = rerun_recorded(serve_cfg, dev, serve_cohorts)["slot"]
    return {"lines": started + stat + stopped, "requests": SERVE_COHORT,
            "cohorts": len(serve_cohorts), "k1_slot_launches": serve_launches,
            "bit_equal_alone": True, "calls": serve_calls}


def timed_cohorts(svc, cfg):
    """Measure each cohort the service dispatches: a list that fills with
    (cohort label, slots, the wall of ``_execute``: staging, the engine
    and the result building) as the service runs."""
    log, execute_ = [], svc._execute

    def timed(live):
        t0 = time.perf_counter()
        out = execute_(live)
        log.append((serve.cohort_label(serve.cohort_key(live[0].request, cfg.engine, cfg.m)),
                    len(live), time.perf_counter() - t0))
        return out

    svc._execute = timed
    return log


def phase_serve_bench_serving(dev, card):
    """bench.py:1493 ``bench_serving``'s three legs on the card at its
    shape (8 clients x 4 requests, n = 4, capacity 4, 32 rounds, max_batch
    8, queue 32, window 0.01 s, 8 rounds a dispatch, ``engine="cuda"``):
    1. each request alone, one slot through ``coalesced_sweep``;
    2. a live ``AgreementService``, each client submitting and waiting in
       turn: every result bit-equal to leg 1's (decisions, counts,
       majorities, counters); its K1 slot-mode launches counted, then its
       cohorts once more, recorded, for the kernels line;
    3. the deadline-storm drill: examples/faults/deadline_storm.json's
       client plan on 16 clients, a 50 ms stall at every dispatch window,
       a queue of 4; no client hangs, the queue stays bounded, both
       shedding (rejections or expiries) and served requests occur, and a
       probe request afterwards is served bit-equal to leg 1's."""
    reqs = [serve_request(i) for i in range(SERVE_CLIENTS * SERVE_PER_CLIENT)]
    cfg = serve.ServeConfig(max_batch=SERVE_COHORT, max_queue=4 * SERVE_COHORT,
                            coalesce_window_s=SERVE_WINDOW_S, rounds_per_dispatch=SERVE_RPD,
                            engine="cuda", device=str(dev))
    execute(cfg, dev, reqs[:1])  # off the clock: the first launch's module load
    t0 = time.perf_counter()
    alone = [execute(cfg, dev, [r])[0] for r in reqs]
    alone_s = time.perf_counter() - t0

    svc = serve.AgreementService(cfg, registry=obs_registry.MetricsRegistry())
    svc.start()
    scenario_step.reset_launches()
    results, lat, wall = clients(svc, reqs, SERVE_CLIENTS, sequential=True)
    launches = scenario_step.cuda_coalesced_megastep.launches
    stats = svc.stats()
    svc.stop()
    check(all(same_result(r, a) for r, a in zip(results, alone)),
          "a served request differs from its run alone")
    cohorts = cohorts_of(reqs, results)
    check(launches == slot_dispatches(cfg, cohorts) and stats["failed"] == 0,
          f"serving: {launches} K1 slot launches for {len(cohorts)} cohorts")
    calls = rerun_recorded(cfg, dev, cohorts)["slot"]

    storm = chaos.ChaosInjector(chaos.load(STORM_PLAN))
    stall = chaos.from_dict({"name": "storm-stall", "faults": [
        {"round": r, "kind": "stall", "phase": "dispatch", "seconds": STORM_STALL_S,
         "times": -1} for r in range(0, SERVE_ROUNDS, SERVE_RPD)]})
    storm_queue = max(2, SERVE_COHORT // 2)
    svc2 = serve.AgreementService(dataclasses.replace(cfg, max_queue=storm_queue),
                                  fault_plan=stall, registry=obs_registry.MetricsRegistry())
    svc2.start()
    counts = {"ok": 0, "rejected": 0, "expired": 0, "failed": 0}
    lock, storming, ordinals = threading.Lock(), threading.Event(), iter(range(10**9))
    depth_seen = [0]

    def storm_client(c):
        for j in range(SERVE_PER_CLIENT):
            req, abandon = reqs[(c * SERVE_PER_CLIENT + j) % len(reqs)], False
            with lock:
                ordinal = next(ordinals)
            for f in storm.client_faults(ordinal):
                if f.kind == "slow_client":
                    time.sleep(f.seconds)
                elif f.kind == "abandon":
                    abandon = True
                elif f.kind == "deadline_storm":
                    storming.set()
            try:
                ticket = svc2.submit(req, deadline_s=0.001 if storming.is_set() else 5.0)
            except serve.Overloaded:
                outcome = "rejected"
            else:
                outcome = None
                if not abandon:
                    try:
                        ticket.result(timeout=600)
                        outcome = "ok"
                    except serve.DeadlineExceeded:
                        outcome = "expired"
                    except serve.RequestFailed:
                        outcome = "failed"
            with lock:
                depth_seen[0] = max(depth_seen[0], svc2.stats()["queue_depth"])
                if outcome:
                    counts[outcome] += 1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=storm_client, args=(c,)) for c in range(2 * SERVE_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    storm_s = time.perf_counter() - t0
    hung = sum(th.is_alive() for th in threads)
    probe = None
    for _ in range(200):
        try:
            probe = svc2.submit(reqs[0], deadline_s=None)
            break
        except serve.Overloaded:
            time.sleep(0.05)
    check(probe is not None, "the service never decayed its shed tier after the storm")
    probe_ok = same_result(probe.result(timeout=600), alone[0])
    storm_stats = svc2.stats()
    svc2.stop()
    survived = hung == 0 and probe_ok
    bounded = depth_seen[0] <= storm_queue and storm_stats["queue_depth"] <= storm_queue
    shed = counts["rejected"] + counts["expired"]
    check(survived and bounded and shed > 0 and counts["ok"] > 0,
          f"the storm drill: hung {hung}, probe {probe_ok}, counts {counts}, "
          f"max depth {depth_seen[0]} of {storm_queue}")
    emit({"phase": "serve_bench_serving", "requests": len(reqs), "clients": SERVE_CLIENTS,
          "n": 4, "capacity": SERVE_CAP, "rounds": SERVE_ROUNDS,
          "rounds_per_dispatch": SERVE_RPD, "max_batch": SERVE_COHORT,
          "window_s": SERVE_WINDOW_S, "engine": "cuda",
          "sequential_wall_s": alone_s, "sequential_requests_per_s": len(reqs) / alone_s,
          "serving_wall_s": wall, "requests_per_s": len(reqs) / wall,
          "agreement_rounds_per_s": len(reqs) * SERVE_ROUNDS / wall,
          "p50_latency_s": pct(lat, 0.5), "p99_latency_s": pct(lat, 0.99),
          "batches": stats["batches"], "cohorts": len(cohorts),
          "bit_equal_alone": True, "k1_slot_launches": launches,
          "storm": {**counts, "requests": 2 * SERVE_CLIENTS * SERVE_PER_CLIENT,
                    "wall_s": storm_s, "injected_client_faults": len(storm.fired),
                    "queue_limit": storm_queue, "max_queue_depth_seen": depth_seen[0],
                    "stalls_injected": storm_stats["injected"]},
          "overload_survived_ok": survived, "queue_bounded": bounded, "card": card})
    return ("serve_bench_serving: a live service, 8 clients x 4 requests", calls, launches, 1)


def full_width_requests(seed):
    """serve_full_width's requests, seeded: plain run-rounds at n uniform in
    [513, 1024] with an eighth of the generals faulty, the coalition
    campaign at n = 1024, signed run-rounds at n = 64 and OM(2) at
    n = 16 (those two on ``engine="auto"``: K1 runs oral OM(1) only)."""
    rs = np.random.default_rng(seed)
    spec = scenario_spec.load(COALITION)

    def faulty(n):
        return tuple(int(i) for i in np.sort(rs.choice(n, n // 8, replace=False)))

    reqs = []
    for i in range(FW_PLAIN):
        n = int(rs.integers(CAP_FULL // 2 + 1, CAP_FULL + 1))
        reqs.append(serve.AgreementRequest(kind="run-rounds", order=("attack", "retreat")[i % 2],
                                           n=n, faulty=faulty(n), seed=20_000 + i,
                                           rounds=FW_ROUNDS))
    for i in range(FW_SCEN):
        reqs.append(serve.AgreementRequest(kind="scenario", n=CAP_FULL, seed=40_000 + i,
                                           spec=spec))
    for i in range(FW_SIGNED):
        reqs.append(serve.AgreementRequest(kind="run-rounds", n=FW_N_SIGNED,
                                           faulty=faulty(FW_N_SIGNED), seed=50_000 + i,
                                           rounds=FW_ROUNDS, signed=True, engine="auto"))
    for i in range(FW_EIG):
        reqs.append(serve.AgreementRequest(kind="run-rounds", order=("attack", "retreat")[i % 2],
                                           n=FW_N_EIG, faulty=faulty(FW_N_EIG), seed=60_000 + i,
                                           rounds=FW_ROUNDS, m=2, engine="auto"))
    order = rs.permutation(len(reqs))
    return [reqs[i] for i in order]


def phase_serve_full_width(dev, seed, card):
    """The service at the size a user runs it: max_batch 1 024, a queue of
    16 384, 64 client threads each submitting its share and then waiting,
    ``engine="cuda"``, 8 rounds a dispatch; 4 096 plain run-rounds of 32
    rounds (n in [513, 1024], capacity 1024, an eighth faulty), 512
    coalition campaigns at n = 1024, 64 signed run-rounds at n = 64 (the
    sign-ahead lane: K7, K5, K4 and K3) and 64 at m = 2, n = 16 (K9).  A
    seeded sample of 128 requests across the kinds is held bit-equal to
    its run alone (one slot through the same staging).  Launches counted
    over the service's run; then its cohorts once more, recorded, for the
    kernels lines (K1's slot mode timed and held against plain on the
    first dispatch of each shape)."""
    reqs = full_width_requests(seed)
    cfg = serve.ServeConfig(max_batch=FW_BATCH, max_queue=FW_QUEUE,
                            rounds_per_dispatch=FW_RPD, engine="cuda", device=str(dev))
    svc = serve.AgreementService(cfg, registry=obs_registry.MetricsRegistry())
    per_cohort = timed_cohorts(svc, cfg)
    svc.start()
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    results, lat, wall = clients(svc, reqs, FW_CLIENTS, sequential=False)
    launches = served_launches()
    stats, timing = svc.stats(), svc.timings()
    svc.stop()
    peak = torch.cuda.max_memory_allocated(dev)
    check(stats["completed"] == len(reqs) and stats["failed"] == stats["rejected"] == 0,
          f"serve_full_width: {stats}")
    cohorts = cohorts_of(reqs, results)
    check(launches["K1 slot"] == slot_dispatches(cfg, cohorts),
          f"serve_full_width: {launches['K1 slot']} K1 slot launches")
    kinds = ["signed" if r.signed else "m2" if r.m == 2 else r.kind for r in reqs]
    rs = np.random.default_rng(seed + 1)
    sample = []
    for kind, k in FW_SAMPLE:
        idx = [i for i, x in enumerate(kinds) if x == kind]
        sample += [int(i) for i in rs.choice(idx, k, replace=False)]
    for i in sample:
        check(same_result(results[i], execute(cfg, dev, [reqs[i]])[0]),
              f"served request {i} ({kinds[i]}) differs from its run alone")
    recorded = rerun_recorded(cfg, dev, cohorts)
    big = [c for c in recorded["slot"] if c[1][0].batch == FW_BATCH]
    check(bool(big), "no 1 024-slot cohort formed")
    _, args, kw, _, _ = big[0]
    copies = iter([pipeline.fresh_copy(args) for _ in range(5)])
    k1_ms = time_cuda(lambda: scenario_step.cuda_coalesced_megastep(*next(copies), **kw), reps=3)
    rounds = sum(serve.request_rounds(r) for r in reqs)
    emit({"phase": "serve_full_width", "requests": len(reqs),
          "by_kind": {k: kinds.count(k) for k in sorted(set(kinds))},
          "max_batch": FW_BATCH, "max_queue": FW_QUEUE, "clients": FW_CLIENTS,
          "rounds_per_dispatch": FW_RPD, "engine": "cuda", "wall_s": wall,
          "requests_per_s": len(reqs) / wall, "agreement_rounds_per_s": rounds / wall,
          "p50_latency_s": pct(lat, 0.5), "p99_latency_s": pct(lat, 0.99),
          "cohorts": len(cohorts), "mean_slots_per_cohort": len(reqs) / len(cohorts),
          "cohort_walls": per_cohort,
          "k1_slot_launches": launches["K1 slot"], "k9_launches": launches["K9"],
          "lane_launches": {k: launches[k] for k in LANE_KERNELS},
          "request_path_compiles": stats["compiles_on_request_path"],
          "max_memory_allocated_bytes": peak, "sample_equal_alone": len(sample),
          "host": {**timing, "result_build_share_of_execute":
                   timing["result_build_s"] / timing["execute_s"]},
          "k1_event_ms_full_cohort_dispatch": k1_ms,
          "result_build_ms_per_cohort": timing["result_build_s"] / timing["cohorts"] * 1e3,
          "card": card})
    path = "serve_full_width: 4 736 requests, 64 clients"
    return {"requests_per_s": len(reqs) / wall, "slot": (path, recorded["slot"], launches["K1 slot"], 1),
            "ed": (path + ", the signed cohorts' lane", recorded["ed"],
                   {k: launches[k] for k in ED_KERNELS}, 1),
            "k9": (path + ", the m = 2 cohorts", recorded["k9"], launches["K9"], 1)}


GVE_CALLS = 200  # graph_vs_eager: dispatches timed a way, and coalesced_sweep calls


def graph_vs_eager(dev):
    """K1's slot mode by its CUDA graph (``obs/graphcache.py``) against
    the eager wrapper at phase 17's shapes (B = 1 alone, B = 8 a cohort;
    n = 4 at capacity 4, 8 rounds a dispatch).  Per dispatch, the carry
    chained from one dispatch to the next as the loop chains it: the host
    wall of the call (no wait) and the CUDA-event time of GVE_CALLS calls
    in a row.  End to end: the mean wall of a 32-round ``coalesced_sweep``
    with and without the graph cache, the two alternating.  Both ways
    bit-equal.  Launches made here count on no path."""
    from ba_tpu_torch.obs import graphcache

    kernel = scenario_step.cuda_coalesced_megastep
    out = {}
    for B in (1, SERVE_COHORT):
        axes = {"batch": B, "capacity": SERVE_CAP, "rounds": SERVE_RPD, "m": 1,
                "max_liars": None, "unroll": 1, "scenario": False, "signed": False,
                "collapsed": False, "engine": "cuda"}
        cache = graphcache.GraphCache(dev)
        cache.ensure(graphcache.COALESCED_FN, axes)
        entry = cache.get(graphcache.COALESCED_FN, axes)
        reqs = serve_requests()[:B]

        def carry():
            faulty = np.zeros((B, SERVE_CAP), bool)
            for i, (_, fl, _) in enumerate(reqs):
                faulty[i, list(fl)] = True
            state = to_state(dict(order=np.array([o for o, _, _ in reqs], np.int8),
                                  leader=np.zeros(B, np.int32), faulty=faulty,
                                  alive=np.ones((B, SERVE_CAP), bool),
                                  ids=np.tile(np.arange(1, SERVE_CAP + 1, dtype=np.int32),
                                              (B, 1))), dev)
            sched = pipeline.make_slot_key_schedule(
                [rng.key(seed, device="cpu") for _, _, seed in reqs])
            sched = pipeline.KeySchedule(sched.key_data.to(dev), sched.counter.to(dev))
            counters = torch.zeros((B, len(pipeline.COUNTER_NAMES)), dtype=torch.int32,
                                   device=dev)
            return [state, sched, counters]

        def way(call):
            c = carry()

            def one():
                o = call(c[0], c[1], None, c[2], None)
                c[0], c[1], c[2] = o[0], o[1], o[5][-1]
                return o

            one()
            sync()
            host = []
            for _ in range(GVE_CALLS):
                t0 = time.perf_counter()
                one()
                host.append(time.perf_counter() - t0)
            sync()
            ev = time_cuda(one, reps=GVE_CALLS)
            last = [t.clone() for t in one()[3:6]]
            return {"host_us_each": 1e6 * sum(host) / len(host), "event_us_each": 1e3 * ev}, last

        eager, e_last = way(lambda *a: kernel(*a, rounds=SERVE_RPD, scenario=False))
        graph, g_last = way(entry)
        check(all(torch.equal(a, b) for a, b in zip(e_last, g_last)),
              f"B {B}: a graph replay differs from the eager dispatch")

        def sweep(executables):
            c = carry()
            return pipeline.coalesced_sweep([rng.key(seed, device="cpu") for _, _, seed in reqs],
                                            c[0], SERVE_ROUNDS, rounds_per_dispatch=SERVE_RPD,
                                            engine="cuda", device=dev, executables=executables)

        walls = {"eager": 0.0, "graph": 0.0}
        firsts = {}
        for i in range(2 * GVE_CALLS):
            name, ex = ("eager", None) if i % 2 == 0 else ("graph", cache)
            t0 = time.perf_counter()
            res = sweep(ex)
            walls[name] += time.perf_counter() - t0
            firsts.setdefault(name, res)
        check(all(np.array_equal(firsts["eager"][k], firsts["graph"][k])
                  for k in ("decisions", "counters", "majorities")),
              f"B {B}: coalesced_sweep with graphs differs from without")
        check(firsts["graph"]["stats"]["warm_dispatches"] == -(-SERVE_ROUNDS // SERVE_RPD),
              f"B {B}: {firsts['graph']['stats']}")
        out[f"B {B}"] = {"dispatch": {"eager": eager, "graph": graph},
                         "coalesced_sweep_ms_each": {k: 1e3 * v / GVE_CALLS
                                                     for k, v in walls.items()}}
    return out


def phase_serve_warm(dev, card):
    """Warm serving on the card: ``warm=True``, ``warm_capacities=(4,
    1024)``, ``warm_rounds=32``, ``warm_ms=(1, 2)``, ``warm_signed=True``,
    max_batch 1 024, window 0.2 s, ``engine="cuda"``.  Live traffic
    (phase 40's 32 requests) runs while the warmup captures; then
    ``warm_barrier()``, then phase 40's 32 requests from 8 clients.  A
    second warm service, opened without its dispatcher, passes its barrier,
    admits a 1 024-request burst (n = 1 024, 32 rounds) and then starts, so
    the burst is one 1 024-slot plain cohort whatever the host's pace of
    admission.  Asserts, for both: no compile on the request path after
    the barrier, warm dispatches, no graph fallback, every result bit-equal
    to a cold service's (the same config without warm, driven the same
    way: the graphs' replays equal the eager dispatches)."""
    cfg = serve.ServeConfig(max_batch=FW_BATCH, max_queue=FW_QUEUE,
                            coalesce_window_s=WARM_WINDOW_S, rounds_per_dispatch=SERVE_RPD,
                            engine="cuda", device=str(dev), warm=True,
                            warm_capacities=(SERVE_CAP, CAP_FULL), warm_rounds=SERVE_ROUNDS,
                            warm_ms=(1, 2), warm_signed=True)
    small = [serve_request(i) for i in range(SERVE_CLIENTS * SERVE_PER_CLIENT)]
    big = [serve.AgreementRequest(kind="run-rounds", order=("attack", "retreat")[i % 2],
                                  n=CAP_FULL, faulty=(i % 7 + 1, CAP_FULL // 2 + i % 5),
                                  seed=70_000 + i, rounds=SERVE_ROUNDS)
           for i in range(FW_BATCH)]

    def warmed(svc, reg):
        check(svc.warm_barrier(timeout=600), "the warmup never finished")
        return reg.get("serve_compile_on_request_path_total").value

    def after(svc, reg, rpc_before):
        stats, wstats = svc.stats(), svc.warm_stats()
        rpc = reg.get("serve_compile_on_request_path_total").value - rpc_before
        svc.stop()
        check(rpc == 0, f"a warm service compiled on the request path: {rpc}")
        check(stats["warmup_errors"] == 0 and stats["warmup_warmed"] == stats["warmup_planned"],
              f"the warmup: {stats}")
        check(wstats["warm_dispatches"] > 0 and wstats["graph_fallbacks"] == 0,
              f"warm dispatches: {wstats}")
        return stats, wstats

    reg = obs_registry.MetricsRegistry()
    svc = serve.AgreementService(cfg, registry=reg)
    t0 = time.perf_counter()
    svc.start()
    live, _, _ = clients(svc, small, SERVE_CLIENTS, sequential=True)  # during the warmup
    rpc_before = warmed(svc, reg)
    warm_wall = time.perf_counter() - t0
    scenario_step.reset_launches()
    warm_small, lat, _ = clients(svc, small, SERVE_CLIENTS, sequential=True)
    launches = scenario_step.cuda_coalesced_megastep.launches
    stats, wstats = after(svc, reg, rpc_before)

    big_reg = obs_registry.MetricsRegistry()
    big_svc = serve.AgreementService(cfg, registry=big_reg)
    t0 = time.perf_counter()
    big_svc.open()
    big_rpc_before = warmed(big_svc, big_reg)
    big_warm_wall = time.perf_counter() - t0
    scenario_step.reset_launches()
    warm_big, lat_big = burst(big_svc, big)
    launches += scenario_step.cuda_coalesced_megastep.launches
    big_stats, big_wstats = after(big_svc, big_reg, big_rpc_before)

    cold_svc = serve.AgreementService(dataclasses.replace(cfg, warm=False),
                                      registry=obs_registry.MetricsRegistry())
    cold_svc.open()
    cold_big, cold_lat_big = burst(cold_svc, big)
    cold_small, cold_lat, _ = clients(cold_svc, small, SERVE_CLIENTS, sequential=True)
    cold_svc.stop()
    check(all(same_result(a, b) for a, b in zip(warm_small + warm_big, cold_small + cold_big)),
          "a warm result differs from the cold service's")
    check(all(same_result(a, b) for a, b in zip(live, warm_small)),
          "a result served during the warmup differs")
    cohorts = cohorts_of(small, warm_small) + cohorts_of(big, warm_big)
    check(launches == slot_dispatches(cfg, cohorts),
          f"serve_warm: {launches} K1 slot launches (graph replays and eager)")
    check(any(len(c) == FW_BATCH for c in cohorts),
          f"the 1 024-slot cohort did not form: {sorted(map(len, cohorts))}")
    calls = rerun_recorded(dataclasses.replace(cfg, warm=False), dev, cohorts)["slot"]
    replay_vs_eager = graph_vs_eager(dev)
    emit({"phase": "serve_warm", "warm_capacities": list(cfg.warm_capacities),
          "warm_rounds": cfg.warm_rounds, "warm_ms": list(cfg.warm_ms),
          "warm_signed": True, "max_batch": FW_BATCH, "window_s": WARM_WINDOW_S,
          "warmup_wall_s": warm_wall, "warmup_runner_wall_s": wstats["warmup_wall_s"],
          "burst_service_warmup_wall_s": big_warm_wall,
          "planned": stats["warmup_planned"], "graphs_captured": wstats["graphs_captured"],
          "eager_entries": wstats["eager_entries"], "live_requests_during_warmup": len(small),
          "serve_compile_on_request_path_total": 0,
          "warm_dispatches": wstats["warm_dispatches"] + big_wstats["warm_dispatches"],
          "graph_fallbacks": wstats["graph_fallbacks"] + big_wstats["graph_fallbacks"],
          "k1_slot_launches": launches, "bit_equal_cold": True, "cohorts": len(cohorts),
          "cohort_sizes": sorted((len(c) for c in cohorts), reverse=True),
          "burst_completed": big_stats["completed"],
          "warm": {"p50_latency_s": pct(lat, 0.5), "p99_latency_s": pct(lat, 0.99),
                   "burst_p50_from_start_s": pct(lat_big, 0.5)},
          "cold": {"p50_latency_s": pct(cold_lat, 0.5), "p99_latency_s": pct(cold_lat, 0.99),
                   "burst_p50_from_start_s": pct(cold_lat_big, 0.5)},
          "graph_vs_eager": replay_vs_eager, "card": card})
    return ("serve_warm: 32 requests, then a 1 024-slot burst, after the barrier (graph "
            "replays)", calls, launches, 1)


def phase_signed_setup_overlapped(dev, setup_t, card):
    """``setup_signed_tables_overlapped(10 240)`` after
    ``warm_signed_tables`` of the same chunk shape, in 2 and 4 chunks, for
    each ``sign_device`` in (True, False) and ``verify`` in ("exact",
    "rlc"): every verdict True, ``msgs`` and ``sigs`` byte-equal to
    ``setup_signed_tables(10 240)``'s; the timings beside phase 9's
    ``total_s``.  The launches of the 2-chunk runs are counted, and those
    runs once more recorded for the kernels lines."""
    _, _, msgs, sigs, ok, _ = signed.setup_signed_tables(B_SIGNED, device=dev)
    check(bool(ok.all()), "the reference setup rejected a table signature")
    runs, paths = {}, []
    for sign_device in (True, False):
        for verify in ("exact", "rlc"):
            for chunks in OVERLAP_CHUNKS:
                kw = dict(chunks=chunks, sign_device=sign_device, verify=verify, device=dev)
                signed.warm_signed_tables(B_SIGNED, **kw)
                sync()
                reset_ed_launches()
                out = signed.setup_signed_tables_overlapped(B_SIGNED, **kw)
                launches = ed_launches()
                check(bool(out[4].all()) and np.array_equal(out[2], msgs)
                      and np.array_equal(out[3], sigs),
                      f"the overlapped setup ({kw}) differs from setup_signed_tables'")
                runs[f"{'device' if sign_device else 'host'}_sign.{verify}.c{chunks}"] = {
                    k: out[5][k] for k in ("keys_s", "sign_s", "drain_s", "total_s", "chunks",
                                           "device_sign")} | {"kernel_launches": launches}
                if chunks == OVERLAP_CHUNKS[0]:
                    with recording(ED_WRAPPERS) as calls:
                        again = signed.setup_signed_tables_overlapped(B_SIGNED, **kw)
                    check(np.array_equal(again[3], sigs), "the recorded setup differs")
                    paths.append((f"signed_setup_overlapped: sign_device={sign_device}, "
                                  f"{verify}, {chunks} chunks", calls, launches, 1))
    emit({"phase": "signed_setup_overlapped", "batch": B_SIGNED, "runs": runs,
          "phase9_total_s": {k: v["total_s"] for k, v in setup_t.items()},
          "all_valid": True, "tables_equal_setup_signed_tables": True, "card": card})
    return paths


# -- device-tier observability: the SLO engine, artifact records, the ledger ---

OBS_DIR = os.path.join(ROOT, "_smoke_obs")  # git-ignored; removed at the end
# serve_slo leg (a): bench.py:2052 bench_serving_slo's shape and burn windows
SLO_CLIENTS, SLO_PER_CLIENT, SLO_ROUNDS, SLO_BATCH, SLO_BURST = 4, 3, 16, 4, 120
SLO_FAST_W, SLO_SLOW_W, SLO_RPD = 1.0, 3.0, 8
FW_TENANTS = 8  # serve_slo leg (b): tenants over phase 41's 64 clients (4 cohorts x 8 groups)
# device_obs: the ledger leg's service (capacity 16 warmed in this process, and
# left out of the child's lattice) and the profiled dispatch
LEDGER_CAP, LEDGER_BATCH, LEDGER_REQS, LEDGER_RPD = 16, 4, 8, 8
PROFILE_ROUNDS = 16


class ListSink:
    """A metrics sink that keeps its records in a list."""

    def __init__(self):
        self.records = []

    def emit(self, rec):
        self.records.append(rec)


def read_jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def slo_request(c, j, tenant=None):
    """bench_serving_slo's request of client c, turn j (bench.py:2107)."""
    i = c * SLO_PER_CLIENT + j
    return serve.AgreementRequest(kind="run-rounds", order=("attack", "retreat")[i % 2], n=4,
                                  faulty=((2,), (), (1, 3))[i % 3], seed=3000 + i,
                                  rounds=SLO_ROUNDS, tenant=tenant or f"tenant-{c}")


def slo_policy():
    """bench_serving_slo's policy: ok is good, expired and rejected burn;
    target 0.5 (an all-bad window burns 2.0), threshold 1.5, windows of 1
    and 3 seconds, a report every 0.05 s."""
    from ba_tpu_torch.obs import slo

    return slo.SLOPolicy(objectives=(slo.SLOObjective(
        name="serve-wall", latency_s=30.0, target=0.5, window_s=60.0,
        fast_window_s=SLO_FAST_W, slow_window_s=SLO_SLOW_W, burn_threshold=1.5),),
        report_every_s=0.05)


def attribution_bad(recs):
    """Ids of ok ``request`` records whose five phases do not sum to their
    wall within ATTRIB_TOL_S."""
    from ba_tpu_torch.obs import slo

    bad = []
    for r in recs:
        if r.get("event") == "request" and r.get("status") == "ok":
            phases = [r.get(k) for k in slo.PHASES]
            if not all(isinstance(p, (int, float)) for p in phases) or \
                    abs(sum(phases) - r["wall_s"]) > slo.ATTRIB_TOL_S:
                bad.append(r["id"])
    return bad


def slo_leg_bench(dev, card):
    """serve_slo leg (a): bench.py:2052's four phases (serve, quiet, burst,
    recover) on a warm service of the card with ``slo=`` its policy's file,
    every record captured to a JSONL file and the acceptance recomputed
    from it."""
    from ba_tpu_torch.utils import metrics

    reqs = [slo_request(c, j) for c in range(SLO_CLIENTS) for j in range(SLO_PER_CLIENT)]
    policy = os.path.join(OBS_DIR, "serving_slo_policy.json")
    slo_policy().save(policy)  # served from its file: ServeConfig(slo=<path>)
    cfg = serve.ServeConfig(max_batch=SLO_BATCH, max_queue=4 * SLO_BATCH,
                            coalesce_window_s=0.01, rounds_per_dispatch=SLO_RPD, warm=True,
                            warm_rounds=SLO_ROUNDS, warm_scenarios=False, warm_signed=False,
                            slo=policy, engine="cuda", device=str(dev))
    refs = {r.seed: execute(cfg, dev, [r])[0] for r in reqs}
    capture = os.path.join(OBS_DIR, "serve_slo.jsonl")
    metrics.configure(capture)
    tickets, t_phase = [], {}
    try:
        svc = serve.AgreementService(cfg, registry=obs_registry.MetricsRegistry())
        t0 = time.perf_counter()
        svc.open()
        check(svc.warm_barrier(timeout=600), "serve_slo: the warm barrier timed out")
        t_phase["warmup_s"] = time.perf_counter() - t0
        reset_all_launches()
        executed = executed_cohorts([svc])
        svc.start()
        # 1. serve: a tenant a client, each submitting and waiting in turn
        results, lat, t_phase["serve_s"] = clients(svc, reqs, SLO_CLIENTS, sequential=True)
        bit_equal = all(same_result(r, refs[q.seed]) for q, r in zip(reqs, results))
        # 2. quiet: the healthy traffic ages out of the slow window
        time.sleep(SLO_SLOW_W + 0.3)
        # 3. burst: deadline_storm.json's client plan on a dedicated tenant
        storm = chaos.ChaosInjector(chaos.load(STORM_PLAN))
        storming, rejected = False, 0
        t0 = time.perf_counter()
        for ordinal in range(SLO_BURST):
            for f in storm.client_faults(ordinal):
                if f.kind == "slow_client":
                    time.sleep(f.seconds)
                elif f.kind == "deadline_storm":
                    storming = True
            req = slo_request(ordinal % SLO_CLIENTS, ordinal % SLO_PER_CLIENT,
                              tenant="tenant-burst")
            try:
                tickets.append((req, svc.submit(req, deadline_s=0.002 if storming else 5.0)))
            except serve.Overloaded:
                rejected += 1
            if not storming:
                time.sleep(0.005)
        for _ in range(600):
            if svc.stats()["queue_depth"] == 0:
                break
            time.sleep(0.05)
        t_phase["burst_s"] = time.perf_counter() - t0
        # 4. recover: the fast window empties, a probe serves normally
        time.sleep(SLO_FAST_W + 0.4)
        probe_req, probe = slo_request(0, 0), None
        for _ in range(200):
            try:
                probe = svc.submit(probe_req, deadline_s=None).result(timeout=600)
                break
            except serve.Overloaded:
                time.sleep(0.05)
        check(probe is not None, "serve_slo: the service never recovered after the burst")
        bit_equal = bit_equal and same_result(probe, refs[probe_req.seed])
        launches = scenario_step.cuda_coalesced_megastep.launches
        stats, warm = svc.stats(), svc.warm_stats()
        svc.stop()
    finally:
        metrics.configure(None)
    recs = read_jsonl(capture)
    bad = attribution_bad(recs)
    states = [r["state"] for r in recs if r.get("event") == "slo_alert"]
    fired_and_cleared = "fire" in states and "clear" in states[states.index("fire") + 1:]
    scale_up = [s for s in recs if s.get("event") == "autoscale_signal"
                and s["recommended"] > s["replicas"]]
    reports = [r for r in recs if r.get("event") == "slo_report"]
    want_ok = collections.Counter(r.tenant for r in reqs) + collections.Counter(["tenant-0"])
    got_ok = {g["tenant"]: g["counts"]["ok"] for g in reports[-1]["groups"]}
    burned = sum(g["counts"]["expired"] + g["counts"]["rejected"]
                 for g in reports[-1]["groups"] if g["tenant"] == "tenant-burst")
    tenant_ok = all(got_ok.get(t, 0) == n for t, n in want_ok.items()) and burned > 0
    for req, t in tickets:  # every served burst ticket
        if t.done() and t._error is None:
            bit_equal = bit_equal and same_result(t.result(0), refs[req.seed])
    # the probe repeats the first request, and two B = 1 cohorts of it share
    # a run id: the cohorts for the recorded rerun are the ones executed
    cohorts = executed
    check(not bad, f"serve_slo: attribution broke on requests {bad}")
    check(fired_and_cleared, f"serve_slo: the alert did not fire and clear: {states}")
    check(bool(scale_up), "serve_slo: no scale-up autoscale_signal in the burst")
    check(tenant_ok, f"serve_slo: tenants want {dict(want_ok)}, got {got_ok}, burst {burned}")
    check(bit_equal, "serve_slo: a served request differs from its run alone")
    check(stats["compiles_on_request_path"] == 0 and stats["warmup_misses"] == 0,
          f"serve_slo: {stats['compiles_on_request_path']} request-path compiles, "
          f"{stats['warmup_misses']} warm misses after the barrier")
    check(launches == slot_dispatches(cfg, cohorts) and warm["graph_fallbacks"] == 0,
          f"serve_slo: {launches} K1 slot launches for {len(cohorts)} cohorts")
    calls = rerun_recorded(cfg, dev, cohorts)["slot"]
    out = {"requests": len(reqs), "clients": SLO_CLIENTS, "tenants": SLO_CLIENTS,
           "rounds": SLO_ROUNDS, "max_batch": SLO_BATCH, "capacity": 4,
           **{k: round(v, 6) for k, v in t_phase.items()},
           "requests_per_s": len(reqs) / t_phase["serve_s"],
           "p50_latency_s": pct(lat, 0.5), "p99_latency_s": pct(lat, 0.99),
           "burst_submitted": len(tickets), "burst_rejected": rejected,
           "burst_expired": sum(1 for r in recs if r.get("event") == "request"
                                and r.get("status") == "expired"),
           "slo_reports": len(reports), "slo_alerts": states,
           "peak_gate_burn": max((o["burn"] for r in reports for o in r["objectives"]
                                  if o["burn"] is not None), default=None),
           "attribution_checked": sum(g["attribution_checked"]
                                      for g in reports[-1]["groups"]),
           "attribution_sums_ok": True, "burn_alert_fired_and_cleared": True,
           "autoscale_scale_up_ok": True, "tenant_accounting_ok": True,
           "bit_exact_vs_alone": True, "request_path_compiles": 0,
           "warm_dispatches": warm["warm_dispatches"], "k1_slot_launches": launches,
           "cohorts": len(cohorts)}
    return out, ("serve_slo (a): bench_serving_slo's four phases, warm", calls, launches, 1)


def slo_leg_full_width(dev, seed, fw_rate):
    """serve_slo leg (b): phase 41's traffic served again by an ``slo=True``
    service (the sink off, as in phase 41, so the rate ratio is the
    engine's cost), a tenant a client modulo FW_TENANTS; the engine's own
    final report checks every ok request's attribution and the tenants'
    tallies, and the 128-request sample is held bit-equal to its runs
    alone."""
    from ba_tpu_torch.obs import slo

    reqs = [dataclasses.replace(r, tenant=f"tenant-{i % FW_CLIENTS % FW_TENANTS}")
            for i, r in enumerate(full_width_requests(seed))]
    cfg = serve.ServeConfig(max_batch=FW_BATCH, max_queue=FW_QUEUE,
                            rounds_per_dispatch=FW_RPD, engine="cuda", device=str(dev),
                            slo=True)
    svc = serve.AgreementService(cfg, registry=obs_registry.MetricsRegistry())
    svc.start()
    sync()
    reset_all_launches()
    results, lat, wall = clients(svc, reqs, FW_CLIENTS, sequential=False)
    launches = scenario_step.cuda_coalesced_megastep.launches
    sink = ListSink()
    report = svc._slo.maybe_report(force=True, sink=sink)
    stats = svc.stats()
    svc.stop()
    check(slo.installed() is None, "serve_slo: stop() left the engine installed")
    check(stats["completed"] == len(reqs) and stats["failed"] == stats["rejected"] == 0,
          f"serve_slo (b): {stats}")
    groups = report["groups"]
    checked = sum(g["attribution_checked"] for g in groups)
    check(checked == len(reqs) and all(g["attribution_bad"] == 0 for g in groups),
          f"serve_slo (b): {checked} attributions checked, "
          f"{sum(g['attribution_bad'] for g in groups)} bad")
    want = collections.Counter(r.tenant for r in reqs)
    got = collections.Counter()
    for g in groups:
        got[g["tenant"]] += g["counts"]["ok"]
    check(got == want and len(groups) <= slo.MAX_GROUPS, f"serve_slo (b): tenants {got}")
    kinds = ["signed" if r.signed else "m2" if r.m == 2 else r.kind for r in reqs]
    rs = np.random.default_rng(seed + 1)
    sample = []
    for kind, k in FW_SAMPLE:
        idx = [i for i, x in enumerate(kinds) if x == kind]
        sample += [int(i) for i in rs.choice(idx, k, replace=False)]
    for i in sample:
        check(same_result(results[i], execute(cfg, dev, [reqs[i]])[0]),
              f"serve_slo (b): request {i} ({kinds[i]}) differs from its run alone")
    check(stats["compiles_on_request_path"] == 0, "serve_slo (b): request-path compiles")
    cohorts = cohorts_of(reqs, results)
    check(launches == slot_dispatches(cfg, cohorts),
          f"serve_slo (b): {launches} K1 slot launches")
    calls = rerun_recorded(cfg, dev, cohorts)["slot"]
    rate = len(reqs) / wall
    out = {"requests": len(reqs), "clients": FW_CLIENTS, "tenants": FW_TENANTS,
           "wall_s": wall, "requests_per_s": rate,
           "serve_full_width_requests_per_s": fw_rate, "engine_cost_ratio": rate / fw_rate,
           "p50_latency_s": pct(lat, 0.5), "p99_latency_s": pct(lat, 0.99),
           "cohorts": len(cohorts), "slo_reports": stats["slo_reports"],
           "attribution_checked": checked, "groups": len(groups),
           "worst_p99_s": report["worst_p99_s"], "sample_equal_alone": len(sample),
           "request_path_compiles": 0, "k1_slot_launches": launches}
    return out, ("serve_slo (b): phase 41's traffic with the SLO engine", calls, launches, 1)


def phase_serve_slo(dev, seed, card, fw_rate):
    """45. ``serve_slo``: an ``slo=`` service on the card (``engine="cuda"``),
    legs (a) and (b) (``slo_leg_bench``, ``slo_leg_full_width``)."""
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    os.makedirs(OBS_DIR)
    atexit.register(shutil.rmtree, OBS_DIR, True)
    t0 = time.perf_counter()
    a, path_a = slo_leg_bench(dev, card)
    b, path_b = slo_leg_full_width(dev, seed, fw_rate)
    emit({"phase": "serve_slo", "bench_serving_slo": a, "full_width": b,
          "wall_s": time.perf_counter() - t0, "card": card})
    return [path_a, path_b]


def ledger_requests():
    """device_obs' ledger leg: run-rounds at n in [9, 16] (capacity 16)."""
    return [serve.AgreementRequest(kind="run-rounds", order=("attack", "retreat")[i % 2],
                                   n=9 + i % 8, faulty=((1,), (), (2, 5))[i % 3],
                                   seed=7000 + i, rounds=LEDGER_RPD)
            for i in range(LEDGER_REQS)]


def ledger_cfg(dev, ledger, capacities):
    return serve.ServeConfig(max_batch=LEDGER_BATCH, max_queue=4 * LEDGER_REQS,
                             rounds_per_dispatch=LEDGER_RPD, warm=True,
                             warm_capacities=capacities, warm_rounds=LEDGER_RPD,
                             warm_scenarios=False, warm_signed=False, engine="cuda",
                             device=str(dev), compile_ledger=ledger)


def ledger_child(ledger):
    """The ledger leg's child process: a warm service whose lattice holds
    capacity 4 only, with ``compile_ledger=`` the parent's ledger; it
    serves the capacity-16 requests and prints one JSON line."""
    dev = CARD
    from ba_tpu_torch.runtime import warmup

    cfg = ledger_cfg(dev, ledger, (4,))
    svc = serve.AgreementService(cfg, registry=obs_registry.MetricsRegistry())
    svc.open()
    plan = warmup.service_plan(cfg, dev)
    replayed = len(warmup.ledger_replay_set(("coalesced_megastep",)))
    warmed = svc.warm_barrier(timeout=600)
    svc.start()
    reqs = ledger_requests()
    results, _ = served(svc, reqs)
    stats, warm = svc.stats(), svc.warm_stats()
    svc.stop()
    print(json.dumps({"warmed": warmed, "stats": stats, "warm": warm,
                      "ledger_rows_replayed": replayed,
                      "plan_capacities": sorted({a["capacity"] for _, a in plan}),
                      "results": [{k: r[k] for k in ("decisions", "counts", "majorities",
                                                     "counters")} for r in results]}))


def phase_device_obs(dev, seed, card, arrays, main_out):
    """46. ``device_obs``: K1's artifact records, the recompile explainer, the
    compile ledger across processes, and a profiler trace of a full-width
    dispatch; every run bit-equal to the same run without observability."""
    from ba_tpu_torch import obs
    from ba_tpu_torch.utils import metrics

    os.makedirs(OBS_DIR, exist_ok=True)
    capture, ledger = os.path.join(OBS_DIR, "device_obs.jsonl"), \
        os.path.join(OBS_DIR, "axes_ledger.json")
    key = rng.key(seed, device=dev)
    kw = dict(depth=2, collect_decisions=True, with_counters=True, engine="cuda", device=dev)
    names = ("histograms", "decisions", "counters_per_round")
    obs.reset_first_calls()  # this process's classifier afresh, as a new process's
    obs.trace.configure(True)
    metrics.configure(capture)
    obs.configure_compile_ledger(ledger)
    launches = {}
    try:
        runs = {}
        for rpd in (RPD_FULL, RPD_FULL // 2):
            scenario_step.reset_launches()
            sync()
            t0 = time.perf_counter()
            runs[rpd] = pipeline.pipeline_sweep(key, to_state(arrays, dev), R_FULL,
                                                rounds_per_dispatch=rpd, **kw)
            runs[f"wall_{rpd}"] = time.perf_counter() - t0
            launches[f"rpd_{rpd}"] = scenario_step.cuda_pipeline_megastep.launches
            same_campaign(runs[rpd], main_out, names, f"device_obs at {rpd} rounds a dispatch")
            check(launches[f"rpd_{rpd}"] == R_FULL // rpd, f"device_obs: {launches}")
        metrics.default_sink().close()
        recs = read_jsonl(capture)
        spans = [e["args"] for e in obs.default_tracer().chrome_events()
                 if e["name"] == "compile" and e["args"].get("fn") == "pipeline_megastep"]
        arts = [r for r in recs if r["event"] == "compiled_artifact"]
        recompiles = [r for r in recs if r["event"] == "recompile"]
        check(sorted(s["rounds"] for s in spans) == [RPD_FULL // 2, RPD_FULL]
              and sorted(a["axes"]["rounds"] for a in arts) == [RPD_FULL // 2, RPD_FULL],
              f"device_obs: compile spans {spans}, artifacts {[a['axes'] for a in arts]}")
        state = to_state(arrays, dev)
        sched = pipeline.make_key_schedule(key)
        carry = sum(t.nbytes for t in (*state.tensors(), sched.key_data, sched.counter))
        k1 = [(name, res) for a in arts for name, res in a["kernels"].items()
              if "megastep_kernel" in name]
        check(all(a["alias_bytes"] == carry and a["donation_aliased"] for a in arts)
              and len(k1) == len(arts) and all(r["registers"] for _, r in k1),
              f"device_obs: alias {[a['alias_bytes'] for a in arts]} of {carry}, K1 {k1}")
        check([r["changed"] for r in recompiles] == [{"rounds": [RPD_FULL, RPD_FULL // 2]}],
              f"device_obs: recompile records {recompiles}")

        # the ledger across processes: a warm service here writes capacity 16
        reqs = ledger_requests()
        cfg = ledger_cfg(dev, ledger, (LEDGER_CAP,))
        svc = serve.AgreementService(cfg, registry=obs_registry.MetricsRegistry())
        svc.open()
        check(svc.warm_barrier(timeout=600), "device_obs: the warm barrier timed out")
        reset_all_launches()
        svc.start()
        here, _ = served(svc, reqs)
        slot_launches = scenario_step.cuda_coalesced_megastep.launches
        svc.stop()
        cohorts = cohorts_of(reqs, here)
        check(slot_launches == slot_dispatches(cfg, cohorts),
              f"device_obs: {slot_launches} K1 slot launches")
        calls = rerun_recorded(cfg, dev, cohorts)["slot"]
        rows = json.load(open(ledger))["fns"]
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.ledger_child({ledger!r})"],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        child_s = time.perf_counter() - t0
        check(child.returncode == 0, f"device_obs: the ledger child failed:\n{child.stderr}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        st = got["stats"]
        check(got["warmed"] and LEDGER_CAP in got["plan_capacities"]
              and st["compiles_on_request_path"] == 0 and st["warmup_misses"] == 0
              and st["warmup_errors"] == 0 and got["warm"]["graph_fallbacks"] == 0,
              f"device_obs: the ledger child {got['stats']}, plan {got['plan_capacities']}")
        check(all(same_result(a, b) for a, b in zip(got["results"], here)),
              "device_obs: the child's results differ from this process's")

        # one profiler session over a 16-round full-width dispatch
        scenario_step.reset_launches()
        with obs.cuda.profile_session(os.path.join(OBS_DIR, "profile")) as prof:
            traced = pipeline.pipeline_sweep(key, to_state(arrays, dev), PROFILE_ROUNDS,
                                             rounds_per_dispatch=PROFILE_ROUNDS, **kw)
        launches["profiled"] = scenario_step.cuda_pipeline_megastep.launches
        for name in names:
            check(np.array_equal(traced[name], main_out[name][:PROFILE_ROUNDS]),
                  f"device_obs: the profiled dispatch's {name} differ")
        events = json.load(open(prof.path))["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        k1_events = [e for e in kernels if "megastep_kernel" in e.get("name", "")]
        ranges = [e for e in events if e.get("name") == "megastep_dispatch"]
        check(k1_events and ranges and launches["profiled"] == 1,
              f"device_obs: trace holds {len(k1_events)} K1 launches, {len(ranges)} ranges")
        kernel_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    finally:
        metrics.configure(None)
        obs.configure_compile_ledger(None)
        obs.trace.configure(None)
    emit({"phase": "device_obs", "B": B_FULL, "capacity": CAP_FULL, "rounds": R_FULL,
          "artifacts": [{k: a[k] for k in ("axes", "argument_bytes", "output_bytes",
                                            "temp_bytes", "alias_bytes",
                                            "generated_code_bytes", "kernels")}
                        for a in arts],
          "carry_bytes": carry, "recompile": recompiles[0]["changed"],
          "compile_spans": [{k: s.get(k) for k in ("rounds", "library_load")} for s in spans],
          "walls_s": {str(r): runs[f"wall_{r}"] for r in (RPD_FULL, RPD_FULL // 2)},
          "ledger": {"fns": {f: len(v) for f, v in rows.items()},
                     "child_rows_replayed": got["ledger_rows_replayed"],
                     "child_plan_capacities": got["plan_capacities"],
                     "child_request_path_compiles": st["compiles_on_request_path"],
                     "child_warm_misses": st["warmup_misses"],
                     "child_warm_dispatches": got["warm"]["warm_dispatches"],
                     "child_s": child_s, "requests": len(reqs),
                     "k1_slot_launches_here": slot_launches},
          "profile": {"trace": os.path.relpath(prof.path, ROOT), "events": len(events),
                      "k1_launches": len(k1_events), "megastep_dispatch_ranges": len(ranges),
                      "kernel_ms": kernel_ms, "window_wall_ms": prof.block_s * 1e3,
                      "kernel_share_of_window": kernel_ms / (prof.block_s * 1e3),
                      "session_wall_ms": prof.wall_s * 1e3},
          "k1_plain_launches": launches, "bit_equal_without_observability": True,
          "card": card})
    plain = sum(launches.values())
    return {"plain": plain, "plain_run": runs[RPD_FULL // 2],
            "slot": ("device_obs: the ledger's warm service, capacity 16", calls,
                     slot_launches, 1)}


# -- adversary search and the elastic fleet ------------------------------------

FLEET_DIR = os.path.join(ROOT, "_smoke_fleet")  # git-ignored; removed at the end
# search_hunt (a): bench.py:4174 bench_adversary_search at its shape
HUNT_A = dict(rounds=8, capacity=16, population=256, events_min=2, events_max=6)
HUNT_A_KW = dict(seed=41, generations=4, objective="ic", minimize=True, minimize_max=2)
# search_hunt (b): full width; the 64 seeded candidates held against their runs alone
HUNT_B = dict(rounds=16, capacity=CAP_FULL, population=4096, events_min=2, events_max=6)
HUNT_B_KW = dict(seed=42, generations=2, objective="ic", minimize=False)
HUNT_B_ALONE = 64
N_REPL_SEARCH = 16  # search_hunt (c): the REPL's `search gens=2` at n = 16
# fleet_serve (a): bench.py:2625 bench_serving_fleet at its shape
FLEET_CLIENTS, FLEET_PER_CLIENT, FLEET_ROUNDS, FLEET_BATCH, FLEET_CAP = 6, 3, 32, 4, 4
FLEET_CAMPAIGN = dict(campaign="bench-fleet", seed=71, state_seed=72, batch=8, rounds=4000,
                      capacity=FLEET_CAP, checkpoint_every=8)
# fleet_serve (b): phase 41's traffic through a 3-replica fleet beside a full-width campaign
FLEET_FW_CAMPAIGN = dict(campaign="full-width", seed=73, state_seed=74, batch=B_FULL,
                         rounds=R_FULL, capacity=CAP_FULL, rounds_per_dispatch=RPD_FULL,
                         checkpoint_every=RPD_FULL)
# fleet_trace: bench.py:2424 bench_fleet_trace at its shape
TRACE_CLIENTS, TRACE_PER_CLIENT, TRACE_ROUNDS, TRACE_BATCH, TRACE_WORKERS = 3, 2, 12, 4, 2


def same_hunt(a, b, what, keys=("found", "elites", "minimized", "state")):
    """Two hunts' results equal but their walls and time stamps."""
    for k in keys:
        check(a[k] == b[k], f"{what}: the hunts' {k} differ")
    check(a["stats"]["run_id"] == b["stats"]["run_id"], f"{what}: the run ids differ")


def timed_hunt(space, **kw):
    """``hunt`` -> (result, each generation's wall s)."""
    from ba_tpu_torch.search import loop as search_loop

    marks = [time.perf_counter()]
    out = search_loop.hunt(space, on_generation=lambda g, info: marks.append(
        time.perf_counter()), **kw)
    return out, [b - a for a, b in zip(marks, marks[1:])]


@contextlib.contextmanager
def generations_kept():
    """While open, each generation's (uids, candidates, counter rows,
    decisions, leaders) of a hunt is appended to the yielded list (the
    hunt calls ``_evaluate_candidates`` through its module)."""
    from ba_tpu_torch.search import loop as search_loop

    kept, real = [], search_loop._evaluate_candidates

    def stand_in(candidates, uids, *args, **kw):
        out = real(candidates, uids, *args, **kw)
        kept.append((list(uids), list(candidates), out[0], out[2], out[3]))
        return out

    search_loop._evaluate_candidates = stand_in
    try:
        yield kept
    finally:
        search_loop._evaluate_candidates = real


def hunt_rates(walls, space):
    """bench_adversary_search's steady rates: the narrowest generation
    wall after generation 0."""
    steady = min(walls[1:]) if len(walls) > 1 else walls[0]
    return {"steady_generation_s": steady, "campaigns_per_s": space.population / steady,
            "campaign_rounds_per_s": space.population * space.rounds / steady}


def phase_search_hunt(dev, card):
    """Adversary search on the card (``search/loop.hunt``, K1's slot mode
    with scenario planes for every population, minimizer trial and
    oracle).  (a) ``bench.py:4174``'s hunt: population 256, capacity 16,
    8 rounds, 4 generations, seed 41, objective ``ic``, 2 minimized:
    a violation found and minimized, every finding ``bit_exact``, the
    whole result equal to ``engine="torch"`` on the card, to a hunt
    resumed from its generation-2 checkpoint and to a two-entry mesh of
    the card.  (b) Full width: population 4 096, capacity 1 024, 16
    rounds, 2 generations: 64 seeded candidates' rows equal their runs
    alone, and generation 0's rows the torch engine's; the host's
    lowering share of the generations' wall.  (c) The REPL's ``search
    gens=2`` at n = 16 prints the port's CPU lines.  Launches counted on
    each main run; each run once more, recorded, for K1's slot line."""
    from ba_tpu_torch.search import generate as search_gen
    from ba_tpu_torch.search import loop as search_loop

    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    os.makedirs(FLEET_DIR)
    atexit.register(shutil.rmtree, FLEET_DIR, True)
    space_a = search_gen.SearchSpace(**HUNT_A)
    kw_a = dict(HUNT_A_KW, engine="cuda", device=dev)
    sync()
    scenario_step.reset_launches()
    a, walls_a = timed_hunt(space_a, **kw_a)
    launches_a = scenario_step.cuda_coalesced_megastep.launches
    check(a["stats"]["found"] >= 1 and len(a["minimized"]) >= 1,
          f"search_hunt (a): found {a['stats']['found']}, minimized {len(a['minimized'])}")
    check(all(m["bit_exact"] for m in a["minimized"]), "a minimized finding is not bit-exact")
    check(a["stats"]["engine"] == "cuda", f"search_hunt (a) ran {a['stats']['engine']}")
    same_hunt(search_loop.hunt(space_a, **dict(kw_a, engine="torch")), a,
              "search_hunt (a), torch against cuda")
    ck = os.path.join(FLEET_DIR, "hunt_g{generation}.json")
    same_hunt(search_loop.hunt(space_a, checkpoint_path=ck, **kw_a), a,
              "search_hunt (a), checkpointed")
    resume_kw = {k: v for k, v in kw_a.items() if k != "seed"}
    same_hunt(search_loop.hunt(resume=ck.replace("{generation}", "2"), **resume_kw), a,
              "search_hunt (a), resumed at generation 2")
    mesh = pmesh.make_mesh((2, 1), ("data", "node"), devices=[CARD, CARD])
    meshed = search_loop.hunt(space_a, mesh=mesh, **dict(kw_a, device=None))
    same_hunt(meshed, a, "search_hunt (a), a two-entry mesh")
    with recording(SLOT_WRAPPERS, snapshot=True) as calls_a:
        search_loop.hunt(space_a, **kw_a)

    space_b = search_gen.SearchSpace(**HUNT_B)
    kw_b = dict(HUNT_B_KW, engine="cuda", device=dev)
    sync()
    scenario_step.reset_launches()
    with generations_kept() as kept:
        b, walls_b = timed_hunt(space_b, **kw_b)
    launches_b = scenario_step.cuda_coalesced_megastep.launches
    uids, cands, rows, decisions, leaders = kept[0]
    pop_state = search_loop.population_state(len(cands), space_b.capacity, space_b.order, dev)
    block = search_gen.lower_population(cands, space_b.capacity, space_b.rounds)
    t_rows = search_loop.evaluate_population(
        search_loop.candidate_keys(HUNT_B_KW["seed"], uids), pop_state, block,
        rounds=space_b.rounds, engine="torch", device=dev)
    for name, got in (("counters", rows), ("decisions", decisions), ("leaders", leaders)):
        check(np.array_equal(t_rows[name], got),
              f"search_hunt (b): generation 0's {name} differ from the torch engine's")
    rs = np.random.default_rng(HUNT_B_KW["seed"])
    for i in sorted(int(x) for x in rs.choice(len(uids), HUNT_B_ALONE, replace=False)):
        alone = search_loop.evaluate_alone(cands[i], seed=HUNT_B_KW["seed"], uid=uids[i],
                                           capacity=space_b.capacity, engine="cuda", device=dev)
        check(np.array_equal(alone["counters"], rows[i])
              and np.array_equal(alone["decisions"], decisions[:, i])
              and np.array_equal(alone["leaders"], leaders[:, i]),
              f"search_hunt (b): candidate {uids[i]} differs from its run alone")
    with recording(SLOT_WRAPPERS, snapshot=True) as calls_b:
        search_loop.hunt(space_b, **kw_b)

    card_cluster = Cluster(N_REPL_SEARCH, TorchBackend(device=dev), seed=0)
    sync()
    scenario_step.reset_launches()
    got, t0 = [], time.perf_counter()
    handle_command(card_cluster, "search gens=2", got.append)
    repl_wall = time.perf_counter() - t0
    launches_c = scenario_step.cuda_coalesced_megastep.launches
    want = []
    handle_command(Cluster(N_REPL_SEARCH, TorchBackend(device="cpu"), seed=0), "search gens=2",
                   want.append)
    check(got == want and len(got) == 2 and got[0].startswith("Search: generations=2"),
          f"search_hunt (c): the card's lines {got} against the CPU's {want}")
    with recording(SLOT_WRAPPERS, snapshot=True) as calls_c:
        handle_command(Cluster(N_REPL_SEARCH, TorchBackend(device=dev), seed=0),
                       "search gens=2", lambda line: None)
    emit({"phase": "search_hunt",
          "a": {"space": HUNT_A, **HUNT_A_KW, "engine": "cuda", "found": a["stats"]["found"],
                "minimized_events": [[m["events_before"], m["events_after"]]
                                     for m in a["minimized"]],
                "minimize_evals": sum(m["evals"] for m in a["minimized"]),
                "bit_exact": True, "equal_torch_engine": True, "equal_resumed": True,
                "equal_two_entry_mesh": True, "generation_walls_s": walls_a,
                **hunt_rates(walls_a, space_a), "wall_s": a["stats"]["wall_s"],
                "k1_slot_launches": launches_a, "run_id": a["stats"]["run_id"]},
          "b": {"space": HUNT_B, **HUNT_B_KW, "engine": "cuda", "found": b["stats"]["found"],
                "generation_walls_s": walls_b, **hunt_rates(walls_b, space_b),
                "lower_s": b["stats"]["lower_s"],
                "lower_share_of_generations": b["stats"]["lower_s"] / sum(walls_b),
                "sample_equal_alone": HUNT_B_ALONE, "generation0_equal_torch_engine": True,
                "k1_slot_launches": launches_b},
          "c": {"command": "search gens=2", "n": N_REPL_SEARCH, "lines": got,
                "equal_cpu_lines": True, "wall_s": repl_wall, "k1_slot_launches": launches_c},
          "card": card})
    return [("search_hunt (a): bench.py:4174's hunt, minimizer and oracle", calls_a,
             launches_a, 1),
            ("search_hunt (b): population 4 096 at capacity 1 024", calls_b, launches_b, 1),
            ("search_hunt (c): the REPL's search gens=2 at n = 16", calls_c, launches_c, 1)]


def replay_campaign_first_dispatch(dev, spec, result, int_ops_per_s, what):
    """A fleet campaign's first dispatch again (its doc's key and state,
    zero counters): K1 against the campaign's own first rounds, and
    against the plain engine on its first CHUNK instances (instances are
    independent; all of them below CHUNK).  K1's time, that plain time and
    the whole dispatch's bound.  These launches are not the path's."""
    R = spec.rounds_per_dispatch
    state = sweep.make_sweep_state(rng.key(spec.state_seed, device=dev), spec.batch,
                                   spec.capacity)
    sched = pipeline.make_key_schedule(rng.key(spec.seed, device=dev))
    counters = convert.counters_from_numpy([0, 0, 0], dev)
    k_out = scenario_step.cuda_pipeline_megastep(
        pipeline.fresh_copy(state), pipeline.fresh_copy(sched), rounds=R,
        collect_decisions=True, counters=counters)
    hi = min(spec.batch, CHUNK)
    p_out, plain_ms = timed_plain(lambda: plain_chunked(rows_of(state, 0, hi), sched, R,
                                                        counters))
    pairs = [(k_out[3][:, :hi], p_out["dec"])] + list(zip(
        rows_of(k_out[0], 0, hi).tensors(), p_out["state"].tensors()))
    if hi == spec.batch:
        pairs += [(k_out[2], p_out["hist"]), (k_out[4], p_out["rows"])]
    err = max_abs_err(pairs)
    check(err == 0, f"{what}: K1 differs from the plain engine on the first dispatch: {err}")
    check(np.array_equal(np.asarray(result["decisions"])[:R], k_out[3].cpu().numpy())
          and np.array_equal(np.asarray(result["histograms"])[:R], k_out[2].cpu().numpy()),
          f"{what}: the campaign's first rounds differ from the replayed kernel")
    sc = pipeline.fresh_copy(sched)
    ms = time_cuda(lambda: scenario_step.cuda_pipeline_megastep(
        state, sc, rounds=R, collect_decisions=True, counters=counters), reps=3)
    words, steps = work_counts(state, R)
    B, n = state.faulty.shape
    bound_ms, bound_by = bound(words, steps, k1_bytes(B, n, R, scenario=False), int_ops_per_s)
    return {"what": what, "err": err, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "plain_instances": hi, "bound_ms": bound_ms,
            "bound_by": bound_by, "shape": {"B": B, "n": n, "R": R}}


def fleet_request(i, rounds=FLEET_ROUNDS, seed0=9000):
    """bench_serving_fleet's request i (bench.py:2685-2694)."""
    return serve.AgreementRequest(kind="run-rounds", order=("attack", "retreat")[i % 2], n=4,
                                  faulty=((2,), (), (1, 3))[i % 3], seed=seed0 + i,
                                  rounds=rounds)


def routed(router, reqs, n_clients, sequential, on_started=None):
    """``reqs`` through the router from ``n_clients`` threads, request i on
    client i mod n_clients (sequential: submit and wait one at a time;
    else submit all, then wait) -> (results in request order, latencies,
    errors, wall s from the start barrier).  ``on_started`` runs on the
    caller's thread once every client is at the barrier."""
    results, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []
    barrier = threading.Barrier(n_clients + 1)

    def client(c):
        mine = list(range(c, len(reqs), n_clients))
        barrier.wait(timeout=120)
        try:
            if sequential:
                for i in mine:
                    t0 = time.perf_counter()
                    results[i] = router.submit(reqs[i], deadline_s=None).result(timeout=600)
                    lat[i] = time.perf_counter() - t0
            else:
                t0 = [time.perf_counter()] * len(mine)
                tickets = []
                for k, i in enumerate(mine):
                    t0[k] = time.perf_counter()
                    tickets.append(router.submit(reqs[i], deadline_s=None))
                for k, (i, t) in enumerate(zip(mine, tickets)):
                    results[i] = t.result(timeout=600)
                    lat[i] = time.perf_counter() - t0[k]
        except Exception as e:  # noqa: BLE001 - every client error is a failure
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for th in threads:
        th.start()
    barrier.wait(timeout=120)
    t0 = time.perf_counter()
    if on_started is not None:
        on_started()
    for th in threads:
        th.join(timeout=900)
    check(not any(th.is_alive() for th in threads), "a routed client hung")
    return results, lat, errors, time.perf_counter() - t0


def request_path_compiles(mgr):
    return sum(r.registry.counter("serve_compile_on_request_path_total").value
               for r in mgr.all())


def wait_fingerprint(handle, what):
    t0 = time.perf_counter()
    while handle.fingerprint is None and not handle.done():
        check(time.perf_counter() - t0 < 120, f"{what}: no fingerprinted checkpoint")
        time.sleep(0.002)
    check(not handle.done(), f"{what}: the campaign ended before a checkpoint: "
          f"{handle.outcome} {handle.error}")


def uninterrupted(spec, dev):
    """The campaign of ``spec`` without a fleet, on the card (its doc's key
    and state, ``supervised_sweep`` as the campaign lane runs it)."""
    return supervisor.supervised_sweep(
        rng.key(spec.seed, device=dev),
        sweep.make_sweep_state(rng.key(spec.state_seed, device=dev), spec.batch, spec.capacity),
        spec.rounds, rounds_per_dispatch=spec.rounds_per_dispatch, collect_decisions=True,
        config=supervisor.SupervisorConfig(timeout_s=60.0), device=dev)


def same_campaign_run(got, want, what):
    check(np.array_equal(np.asarray(got["decisions"]), np.asarray(want["decisions"]))
          and np.array_equal(np.asarray(got["histograms"]), np.asarray(want["histograms"]))
          and got["supervisor"]["history_start"] == 0,
          f"{what}: the migrated campaign differs from the uninterrupted run")


def fleet_leg_reference(dev, card, int_ops_per_s):
    """fleet_serve (a): bench_serving_fleet's two legs."""
    from ba_tpu_torch import fleet

    reqs = [fleet_request(i) for i in range(FLEET_CLIENTS * FLEET_PER_CLIENT)]
    cfg = serve.ServeConfig(max_batch=FLEET_BATCH, max_queue=4 * FLEET_BATCH,
                            coalesce_window_s=0.02, rounds_per_dispatch=8, warm=True,
                            warm_rounds=FLEET_ROUNDS, warm_scenarios=False, engine="cuda",
                            device=str(dev))
    cold = dataclasses.replace(cfg, warm=False)
    refs = [execute(cold, dev, [r])[0] for r in reqs]

    mgr1 = fleet.ReplicaManager(fleet.FleetConfig(replicas=1), serve_config=cfg)
    t0 = time.perf_counter()
    mgr1.start(warm_timeout_s=600)
    warm_single = time.perf_counter() - t0
    scenario_step.cuda_coalesced_megastep.launches = 0
    cohorts = executed_cohorts([r.service for r in mgr1.all()])
    one, one_lat, one_err, t_single = routed(fleet.FleetRouter(mgr1), reqs, FLEET_CLIENTS,
                                             sequential=True)
    slot_launches = scenario_step.cuda_coalesced_megastep.launches
    rpc_single = request_path_compiles(mgr1)
    mgr1.stop()
    check(not one_err and all(same_result(a, b) for a, b in zip(one, refs)),
          f"fleet_serve (a), one replica: {one_err or 'a result differs from its run alone'}")

    root = os.path.join(FLEET_DIR, "reference")
    shutil.rmtree(root, ignore_errors=True)
    mgr = fleet.ReplicaManager(fleet.FleetConfig(replicas=3, root=root), serve_config=cfg)
    t0 = time.perf_counter()
    mgr.start(warm_timeout_s=600)
    warm_fleet = time.perf_counter() - t0
    router = fleet.FleetRouter(mgr)
    router._sync_ring()
    label = serve.cohort_label(serve.cohort_key(reqs[0]))
    victim = router._ring.prefer(label)[0]
    spec = fleet.CampaignSpec(**FLEET_CAMPAIGN)
    scenario_step.cuda_pipeline_megastep.launches = 0
    handle = mgr.get(victim).run_campaign(spec)
    wait_fingerprint(handle, "fleet_serve (a)")
    peak = {r.name: 0 for r in mgr.all()}
    sampling = threading.Event()
    sampling.set()

    def sample():
        while sampling.is_set():
            for r in mgr.all():
                peak[r.name] = max(peak[r.name], r.health()["queue_depth"])
            time.sleep(0.002)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()

    def kill_home():
        time.sleep(0.05)  # the first window queues on the home
        mgr.kill(victim)

    scenario_step.cuda_coalesced_megastep.launches = 0
    fleet_cohorts = executed_cohorts([r.service for r in mgr.all()])
    res, lat, err, t_fleet = routed(router, reqs, FLEET_CLIENTS, sequential=True,
                                    on_started=kill_home)
    slot_launches += scenario_step.cuda_coalesced_megastep.launches
    cohorts = cohorts + fleet_cohorts
    sampling.clear()
    sampler.join(timeout=10)
    rstats = router.stats()
    check(handle.wait(120) and handle.outcome == "abandoned",
          f"fleet_serve (a): the killed home's campaign ended {handle.outcome!r}")
    adopted = mgr.adopt_orphans(victim)
    check(len(adopted) == 1 and adopted[0].wait(600) and adopted[0].outcome == "completed",
          f"fleet_serve (a): adoption {[(h.outcome, h.error) for h in adopted]}")
    plain_launches = scenario_step.cuda_pipeline_megastep.launches
    rpc_fleet = request_path_compiles(mgr)
    mgr.stop()
    reroute_ok = not err and all(same_result(a, b) for a, b in zip(res, refs))
    check(reroute_ok, f"fleet_serve (a): clients through the kill: {err}")
    got = adopted[0].result
    same_campaign_run(got, uninterrupted(spec, dev), "fleet_serve (a)")
    check(rpc_single == 0 and rpc_fleet == 0,
          f"fleet_serve (a): request-path compiles {rpc_single} + {rpc_fleet}")
    over = {k: v for k, v in peak.items() if v > cfg.max_queue}
    check(not over, f"fleet_serve (a): queue bound {cfg.max_queue} exceeded: {over}")
    check(slot_launches == slot_dispatches(cfg, cohorts),
          f"fleet_serve (a): {slot_launches} K1 slot launches")
    calls = rerun_recorded(cold, dev, cohorts)["slot"]
    replay = replay_campaign_first_dispatch(dev, spec, got, int_ops_per_s,
                                            "fleet_serve (a): the adopted campaign")

    def pcts(x):
        return {"p50_latency_s": pct(x, 0.5), "p99_latency_s": pct(x, 0.99)}

    record = {"clients": FLEET_CLIENTS, "requests": len(reqs), "rounds": FLEET_ROUNDS,
              "max_batch": FLEET_BATCH, "max_queue": cfg.max_queue, "replicas": 3,
              "victim": victim, "campaign_rounds": spec.rounds,
              "single": {"warmup_wall_s": warm_single, "elapsed_s": t_single, **pcts(one_lat)},
              "fleet": {"warmup_wall_s": warm_fleet, "elapsed_s": t_fleet, **pcts(lat),
                        "agreement_rounds_per_s": len(reqs) * FLEET_ROUNDS / t_fleet},
              "routes": rstats["routes"], "reroutes": rstats["reroutes"],
              "peak_queue_depths": peak, "reroute_zero_hung_clients": reroute_ok,
              "migrated_bit_exact": True, "no_request_path_compiles_fleet": True,
              "queue_bounded_all_replicas": True, "k1_slot_launches": slot_launches,
              "k1_plain_launches": plain_launches}
    return record, ("fleet_serve (a): bench.py:2625's two legs", calls, slot_launches, 1), \
        plain_launches, replay


def fleet_leg_full_width(dev, seed, fw_rate, int_ops_per_s):
    """fleet_serve (b): phase 41's traffic through a 3-replica warm fleet
    while one replica's full-width campaign is drained to a survivor."""
    from ba_tpu_torch import fleet

    reqs = full_width_requests(seed)
    # warm: K1's graphs at capacity 1 024 (the plain and coalition cohorts);
    # the signed and m = 2 cohorts run eagerly, their libraries loaded
    cfg = serve.ServeConfig(max_batch=FW_BATCH, max_queue=FW_QUEUE, rounds_per_dispatch=FW_RPD,
                            engine="cuda", device=str(dev), warm=True,
                            warm_capacities=(CAP_FULL,), warm_rounds=FW_ROUNDS,
                            warm_ms=(1,), warm_signed=False)
    cold = dataclasses.replace(cfg, warm=False)
    root = os.path.join(FLEET_DIR, "full_width")
    shutil.rmtree(root, ignore_errors=True)
    mgr = fleet.ReplicaManager(fleet.FleetConfig(replicas=3, root=root), serve_config=cfg)
    t0 = time.perf_counter()
    mgr.start(warm_timeout_s=600)
    warm_wall = time.perf_counter() - t0
    router = fleet.FleetRouter(mgr)
    spec = fleet.CampaignSpec(**FLEET_FW_CAMPAIGN)
    holder = "replica-1"
    drained = {}

    def drain_mid_traffic():
        handle = mgr.get(holder).run_campaign(spec)
        wait_fingerprint(handle, "fleet_serve (b)")
        t1 = time.perf_counter()
        drained["adopted"] = mgr.drain(holder)
        drained["drain_s"] = time.perf_counter() - t1
        drained["handle"] = handle

    sync()
    reset_all_launches()
    cohorts = executed_cohorts([r.service for r in mgr.all()])
    results, lat, err, wall = routed(router, reqs, FW_CLIENTS, sequential=False,
                                     on_started=drain_mid_traffic)
    launches = served_launches()
    check(not err, f"fleet_serve (b): client errors {err[:3]}")
    handle = drained["handle"]
    check(handle.outcome == "handoff", f"fleet_serve (b): the drained campaign ended "
          f"{handle.outcome!r} ({handle.error})")
    (moved,) = drained["adopted"]
    check(moved.wait(600) and moved.outcome == "completed",
          f"fleet_serve (b): the moved campaign ended {moved.outcome!r} ({moved.error})")
    plain_launches = scenario_step.cuda_pipeline_megastep.launches
    rstats = router.stats()
    rpc = request_path_compiles(mgr)
    mgr.stop()
    check(rpc == 0, f"fleet_serve (b): {rpc} request-path compiles across the roster")
    same_campaign_run(moved.result, uninterrupted(spec, dev), "fleet_serve (b)")
    check(launches["K1 slot"] == slot_dispatches(cfg, cohorts),
          f"fleet_serve (b): {launches['K1 slot']} K1 slot launches")
    kinds = ["signed" if r.signed else "m2" if r.m == 2 else r.kind for r in reqs]
    rs = np.random.default_rng(seed + 2)
    sample = []
    for kind, k in FW_SAMPLE:
        idx = [i for i, x in enumerate(kinds) if x == kind]
        sample += [int(i) for i in rs.choice(idx, k, replace=False)]
    for i in sample:
        check(same_result(results[i], execute(cold, dev, [reqs[i]])[0]),
              f"fleet_serve (b): routed request {i} ({kinds[i]}) differs from its run alone")
    recorded = rerun_recorded(cold, dev, cohorts)
    replay = replay_campaign_first_dispatch(dev, spec, moved.result, int_ops_per_s,
                                            "fleet_serve (b): the moved campaign")
    record = {"requests": len(reqs), "by_kind": {k: kinds.count(k) for k in sorted(set(kinds))},
              "clients": FW_CLIENTS, "replicas": 3, "max_batch": FW_BATCH,
              "warmup_wall_s": warm_wall, "wall_s": wall, "requests_per_s": len(reqs) / wall,
              "phase41_requests_per_s_same_run": fw_rate,
              "ratio_to_phase41": len(reqs) / wall / fw_rate,
              "p50_latency_s": pct(lat, 0.5), "p99_latency_s": pct(lat, 0.99),
              "routes": rstats["routes"], "reroutes": rstats["reroutes"],
              "cohorts": len(cohorts), "campaign": FLEET_FW_CAMPAIGN,
              "campaign_holder": holder, "drain_s": drained["drain_s"],
              "moved_to": [r.name for r in mgr.all() if r.campaign(spec.campaign) is moved],
              "migrated_bit_exact": True, "sample_equal_alone": len(sample),
              "request_path_compiles": rpc, "k1_slot_launches": launches["K1 slot"],
              "k9_launches": launches["K9"], "k1_plain_launches": plain_launches,
              "lane_launches": {k: launches[k] for k in LANE_KERNELS}}
    path = "fleet_serve (b): 4 736 requests through a 3-replica fleet"
    return record, {
        "slot": (path, recorded["slot"], launches["K1 slot"], 1),
        "ed": (path + ", the signed cohorts' lane", recorded["ed"],
               {k: launches[k] for k in ED_KERNELS}, 1),
        "k9": (path + ", the m = 2 cohorts", recorded["k9"], launches["K9"], 1)}, \
        plain_launches, replay


def phase_fleet_serve(dev, seed, card, fw_rate, int_ops_per_s):
    """The elastic fleet on the card (``fleet/``: ``ReplicaManager``,
    ``FleetRouter``, live migration).  (a) ``bench.py:2625``'s two legs
    at its shape: 6 clients x 3 requests (n = 4, 32 rounds, max_batch 4)
    through a warm one-replica fleet, then a warm 3-replica fleet whose
    cohort home runs a checkpointing campaign (B 8, capacity 4, 4 000
    rounds, a checkpoint every 8) and is killed mid-run: the four
    booleans recomputed and asserted.  (b) Phase 41's 4 736 requests from
    64 clients through a warm 3-replica ``engine="cuda"`` fleet while one
    replica's full-width campaign (B 10 000, capacity 1 024, 64 rounds,
    16 a dispatch, a checkpoint each) is drained to a survivor: the moved
    campaign bit-equal to an uninterrupted run, a 128-request sample
    bit-equal alone, 0 request-path compiles; requests/s beside phase
    41's."""
    t0 = time.perf_counter()
    rec_a, slot_a, plain_a, replay_a = fleet_leg_reference(dev, card, int_ops_per_s)
    t_a = time.perf_counter() - t0
    rec_b, paths_b, plain_b, replay_b = fleet_leg_full_width(dev, seed, fw_rate, int_ops_per_s)
    emit({"phase": "fleet_serve", "a": rec_a, "b": rec_b, "leg_a_wall_s": t_a,
          "leg_b_wall_s": time.perf_counter() - t0 - t_a, "card": card})
    return {"slot": [slot_a, paths_b["slot"]], "ed": paths_b["ed"], "k9": paths_b["k9"],
            "plain": {"fleet_serve (a)": plain_a, "fleet_serve (b)": plain_b},
            "plain_paths": [replay_a, replay_b]}


def phase_fleet_trace(dev, card):
    """``bench.py:2424``'s fleet_trace at its shape: 3 clients x 2 signed
    requests (n = 4, 12 rounds), max_batch 4, a warm service, the sign
    pool live (2 workers, no table cache: the cache would satisfy every
    cohort in-process), the sink a directory.  From the shards, through
    ``obs/fleet.py``: every request's tree fully parented, its phases
    within tolerance, two merges identical, the pool workers' shards in
    every tree, 0 request-path compiles; ``python -m
    ba_tpu_torch.obs.fleet <dir>``'s digest equal to the in-process
    merge's.  The lane's K7, K5, K4 and K3 launches counted; the cohorts
    once more, recorded, for their lines."""
    from ba_tpu_torch.crypto import pool as pool_mod
    from ba_tpu_torch.obs import fleet as obs_fleet
    from ba_tpu_torch.utils import metrics

    reqs = [serve.AgreementRequest(kind="run-rounds", order=("attack", "retreat")[i % 2], n=4,
                                   faulty=((2,), (), (1, 3))[i % 3], seed=7000 + i,
                                   rounds=TRACE_ROUNDS, m=1, signed=True,
                                   tenant=f"tenant-{i // TRACE_PER_CLIENT}")
            for i in range(TRACE_CLIENTS * TRACE_PER_CLIENT)]
    sink = os.path.join(FLEET_DIR, "trace_sink") + os.sep
    cfg = serve.ServeConfig(max_batch=TRACE_BATCH, max_queue=4 * TRACE_BATCH,
                            coalesce_window_s=0.02, rounds_per_dispatch=4, warm=True,
                            warm_rounds=TRACE_ROUNDS, warm_scenarios=False, device=str(dev))
    pool_mod.configure_defaults(workers=TRACE_WORKERS, cache=False)
    metrics.configure(sink)  # before the pool starts: its workers get the directory
    try:
        svc = serve.AgreementService(cfg, registry=obs_registry.MetricsRegistry())
        t0 = time.perf_counter()
        svc.open()
        check(svc.warm_barrier(timeout=600), "fleet_trace: the warmup never finished")
        warm_wall = time.perf_counter() - t0
        svc.start()
        reset_ed_launches()
        results, lat, wall = clients(svc, reqs, TRACE_CLIENTS, sequential=True)
        launches = ed_launches()
        stats = svc.stats()
        svc.stop()  # closes the pool: the workers' shards are whole
        metrics.configure(None)  # the recorded rerun below writes no shard
        recorded = rerun_recorded(dataclasses.replace(cfg, warm=False), dev,
                                  cohorts_of(reqs, results))
    finally:
        metrics.configure(None)
        pool_mod.configure_defaults()
    merged = obs_fleet.merge_shards(sink)
    digest = obs_fleet.merge_digest(merged)
    merge_deterministic = digest == obs_fleet.merge_digest(obs_fleet.merge_shards(sink))
    rids = obs_fleet.request_ids(merged)
    check(len(rids) == len(reqs), f"fleet_trace: {len(rids)} traced requests in the shards")
    traces = [obs_fleet.assemble_request_trace(merged, request_id=rid) for rid in rids]
    all_parented = all(t["unparented"] == [] for t in traces)
    within_tol = all(t["within_tol"] for t in traces)
    cross_process = all(len(t["processes"]) >= 2
                        and any(s["name"] == "pool_task" for s in t["spans"]) for t in traces)
    pool_tasks = sum(1 for r in merged if r.get("event") == "pool_task")
    no_rpc = stats["compiles_on_request_path"] == 0
    cli = subprocess.run([sys.executable, "-m", "ba_tpu_torch.obs.fleet", sink],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    check(cli.returncode == 0, f"fleet_trace: the CLI exited {cli.returncode}: "
          f"{cli.stdout[-500:]} {cli.stderr[-500:]}")
    cli_doc = json.loads(cli.stdout.strip().splitlines()[-1])
    for name, ok in (("merge_deterministic", merge_deterministic),
                     ("all_spans_parented", all_parented),
                     ("critical_path_within_tol", within_tol),
                     ("cross_process", cross_process),
                     ("no_request_path_compiles", no_rpc),
                     ("cli_digest_equal", cli_doc["digest"] == digest)):
        check(ok, f"fleet_trace: {name} is false "
                  f"{[(t['request_id'], t['unparented'], t['processes']) for t in traces]}")
    check(pool_tasks > 0 and all(launches[k] > 0 for k in LANE_KERNELS),
          f"fleet_trace: {pool_tasks} pool tasks, lane launches {launches}")
    summary = obs_fleet.fleet_summary(merged)
    emit({"phase": "fleet_trace", "clients": TRACE_CLIENTS, "requests": len(reqs),
          "rounds": TRACE_ROUNDS, "max_batch": TRACE_BATCH, "pool_workers": TRACE_WORKERS,
          "warmup_wall_s": warm_wall, "serve_elapsed_s": wall,
          "rounds_per_s": len(reqs) * TRACE_ROUNDS / wall,
          "shards": [name for name, _ in obs_fleet.list_shards(sink)],
          "records_by_shard": {r["shard"]: r["records"] for r in summary["replicas"]},
          "pool_tasks": pool_tasks,
          "spans_per_trace": [t["span_count"] for t in traces],
          "processes_per_trace": [len(t["processes"]) for t in traces],
          "merge_digest": digest, "all_spans_parented": True,
          "critical_path_within_tol": True, "merge_deterministic": True,
          "cross_process": True, "no_request_path_compiles": True, "cli_digest_equal": True,
          "lane_launches": {k: launches[k] for k in LANE_KERNELS}, "card": card})
    return ("fleet_trace: 6 signed requests, the pool live, the sink a directory",
            recorded["ed"], {k: launches[k] for k in ED_KERNELS}, 1)



# -- ba-lint on the card's machine, and the legacy strategy chains ------------

LINT_DIR = os.path.join(ROOT, "_smoke_lint")  # git-ignored; removed at the end
LINT_CODES = {"BA101", "BA102", "BA201", "BA202", "BA301", "BA401", "BA501", "BA502",
              "BA503", "BA504", "BA601", "BA602", "BA603"}
# One seeded violation a rule, each through an import alias, appended to a
# module of a copy of the package in that rule's scope.
LINT_SEEDS = {
    "BA101": ("parallel/pipeline.py",
              "import torch.cuda as _seed_tc\n\n\ndef _seeded():\n    _seed_tc.synchronize()\n"),
    "BA201": ("parallel/pipeline.py",
              "from ba_tpu_torch.ops import scenario_step as _seed_ss\n\n\n"
              "def _seeded(state, sched):\n"
              "    out = _seed_ss.cuda_pipeline_megastep(state, sched, rounds=1)\n"
              "    return out, state.alive\n"),
    "BA301": ("core/quorum.py", "from ba_tpu_torch import obs as _seed_obs\n\n_SEED = _seed_obs\n"),
    "BA501": ("runtime/serve.py",
              "import threading as _seed_th\n\n\nclass _Seeded:\n    def start(self):\n"
              "        _seed_th.Thread(target=self._loop, daemon=True).start()\n\n"
              "    def _loop(self):\n        self.n = 1\n\n    def poke(self):\n"
              "        self.n = 2\n"),
    "BA603": ("parallel/sweep.py",
              "import os as _seed_os\n\n_SEEDED = _seed_os.environ.get('HOME')\n"),
}
# bench.py:3709 bench_megastep_ab's shape
CHAIN_B, CHAIN_CAP, CHAIN_R, CHAIN_RPD, CHAIN_DEPTH = 2048, 64, 64, 8, 2


def lint_set():
    tests = sorted(os.path.relpath(p, ROOT)
                   for p in glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    return ["ba_tpu_torch", "chip_smoke.py", *tests]


def phase_lint(dev, card):
    """(a) The port's ba-lint over the lint set as a user runs it, in a
    subprocess (``-X importtime`` lists every module it loads: no torch,
    numpy or jax); (b) a seeded violation of BA101, BA201, BA301, BA501
    and BA603 in a copy of the package, each red with its code; (c) the
    hazard BA201 names, on the card: a K1 dispatch updates its carry in
    place."""
    os.makedirs(LINT_DIR, exist_ok=True)
    atexit.register(shutil.rmtree, LINT_DIR, True)
    sarif = os.path.join(LINT_DIR, "lint.sarif")
    paths = lint_set()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "ba_tpu_torch.analysis", *paths,
         "--format", "json", "--sarif", sarif],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    lint_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"ba-lint exited {proc.returncode}: {proc.stdout[-2000:]}")
    doc = json.loads(proc.stdout)
    check(all(k in doc for k in ("version", "tool", "files_scanned", "rules", "findings",
                                 "suppressed", "counts", "exit"))
          and doc["version"] == 1 and doc["tool"] == "ba-lint" and doc["exit"] == 0,
          "ba-lint's JSON lacks its schema fields")
    check(doc["counts"]["error"] == 0 and doc["counts"]["warning"] == 0,
          f"ba-lint: {doc['counts']}")
    with open(sarif) as fh:
        sdoc = json.load(fh)
    rules = {r["id"] for r in sdoc["runs"][0]["tool"]["driver"]["rules"]}
    check(sdoc["version"] == "2.1.0" and rules == LINT_CODES, f"SARIF {sdoc['version']} {rules}")
    loaded = {line.rsplit("|", 1)[-1].strip().split(".")[0]
              for line in proc.stderr.splitlines() if line.startswith("import time:")}
    banned = sorted(loaded & {"torch", "numpy", "jax", "jaxlib", "ba_tpu"})
    check(not banned, f"ba-lint loaded {banned}")

    copy = os.path.join(LINT_DIR, "copy")
    shutil.copytree(os.path.join(ROOT, "ba_tpu_torch"), os.path.join(copy, "ba_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    seeded = {}
    for code, (rel, seed) in LINT_SEEDS.items():
        target = os.path.join(copy, "ba_tpu_torch", rel)
        with open(target) as fh:
            original = fh.read()
        with open(target, "w") as fh:
            fh.write(original + "\n\n" + seed)
        got = subprocess.run([sys.executable, "-m", "ba_tpu_torch.analysis", target, "--rules",
                              code, "--format", "json"],
                             capture_output=True, text=True, cwd=ROOT, timeout=120)
        with open(target, "w") as fh:
            fh.write(original)
        found = [f["code"] for f in json.loads(got.stdout)["findings"]]
        check(got.returncode == 1 and found and set(found) == {code},
              f"the seeded {code} went {got.returncode} with {found}")
        seeded[code] = len(found)

    arrays, _, _ = random_arrays(np.random.default_rng(50), 64, 32, 4)
    state, sched = to_state(arrays, dev), pipeline.make_key_schedule(rng.key(50, device=dev))
    before = pipeline.fresh_copy((state, sched))
    out = scenario_step.cuda_pipeline_megastep(state, sched, rounds=4)
    sync()
    changed = [not torch.equal(a, b) for a, b in zip([*before[0].tensors(), before[1].counter],
                                                     [*out[0].tensors(), out[1].counter])]
    in_place = out[0] is state and out[1] is sched  # ba-lint: disable=BA201 (the hazard, shown)
    check(in_place and any(changed), "K1's dispatch did not update its carry in place")
    emit({"phase": "lint", "lint_set_files": doc["files_scanned"], "counts": doc["counts"],
          "suppressed": doc["counts"]["suppressed"], "sarif_version": sdoc["version"],
          "sarif_rules": len(rules), "loaded_torch_numpy_jax": banned, "lint_s": lint_s,
          "seeded_red": seeded, "carry_updated_in_place": in_place and any(changed),
          "carry_tensors_changed": {"state": sum(changed[:-1]), "sched.counter": changed[-1]},
          "card": card})


def chain_campaign(dev):
    """bench_megastep_ab's campaign: the sweep state from seed 40, the
    strategy plane and the event planes from seed 41 (every id 0-4, 2 %
    kills, 1 % revives, 5 % strategy churn), the sweep key 42."""
    state = sweep.make_sweep_state(rng.key(40, device=dev), CHAIN_B, CHAIN_CAP)
    rs = np.random.default_rng(41)
    shape = (CHAIN_R, CHAIN_B, CHAIN_CAP)
    strat0 = rs.integers(0, 5, (CHAIN_B, CHAIN_CAP)).astype(np.int8)
    block = scenario_compile.ScenarioBlock(
        kill=rs.random(shape) < 0.02,
        revive=rs.random(shape) < 0.01,
        set_faulty=np.full(shape, -1, np.int8),
        set_strategy=np.where(rs.random(shape) < 0.05, rs.integers(0, 5, shape),
                              -1).astype(np.int8))
    return state, torch.tensor(strat0), block


def phase_strategy_chain(dev, card, int_ops_per_s):
    """bench.py:3709's three legs on the card: the torch engine under
    ``strategies.chain_impl()`` (the legacy select chains and the
    per-instance round), the torch engine branch-free, and
    ``engine="cuda"`` (K1's scenario mode, which reads only its lie
    table); bit-equal between every pair; each leg's wall (no claim).
    The cuda leg's dispatches are replayed against the plain megastep."""
    from ba_tpu_torch.scenario import strategies

    state, strat0, block = chain_campaign(dev)
    key = rng.key(42, device=dev)

    def run(engine, chain):
        st = pipeline.fresh_copy(state)
        sync()
        t0 = time.perf_counter()
        with strategies.chain_impl(chain):
            out = pipeline.scenario_sweep(key, st, block, initial_strategy=strat0,
                                          depth=CHAIN_DEPTH, rounds_per_dispatch=CHAIN_RPD,
                                          collect_decisions=True, engine=engine, device=dev)
        sync()
        return out, time.perf_counter() - t0

    legs = {"torch_chain": ("torch", True), "torch_branch_free": ("torch", False),
            "cuda": ("cuda", False)}
    outs, walls = {}, {}
    for name, (engine, chain) in legs.items():
        run(engine, chain)  # warm: first launches and allocations off the clock
        if engine == "cuda":
            scenario_step.reset_launches()
        outs[name], walls[name] = run(engine, chain)
        if engine == "cuda":
            launches = scenario_step.cuda_scenario_megastep.launches
    check(launches == CHAIN_R // CHAIN_RPD, f"strategy_chain: K1 launches {launches}")
    check(outs["cuda"]["stats"]["engine"] == "cuda"
          and outs["torch_chain"]["stats"]["engine"] == "torch", "strategy_chain: engines")
    names = ("decisions", "leaders", "histograms", "counters_per_round")
    for a, b in (("torch_chain", "torch_branch_free"), ("torch_chain", "cuda"),
                 ("torch_branch_free", "cuda")):
        x, y = outs[a], outs[b]
        check(all(np.array_equal(x[k], y[k]) for k in names)
              and torch.equal(x["final_strategy"], y["final_strategy"])
              and max_abs_err(zip(x["final_state"].tensors(), y["final_state"].tensors())) == 0,
              f"strategy_chain: {a} and {b} differ")
    with recording({"K1 scenario": scenario_step.cuda_scenario_megastep}, snapshot=True) as calls:
        again, _ = run("cuda", False)
    check(np.array_equal(again["decisions"], outs["cuda"]["decisions"]),
          "strategy_chain: the recorded cuda leg differs")
    path = k1_repl_path(f"strategy_chain: B {CHAIN_B}, capacity {CHAIN_CAP}, {CHAIN_R} "
                        f"rounds, {CHAIN_RPD} a dispatch", calls, launches, int_ops_per_s)
    check(path["max_abs_err"] == 0, "strategy_chain: a K1 dispatch differs from plain")
    emit({"phase": "strategy_chain", "B": CHAIN_B, "capacity": CHAIN_CAP, "rounds": CHAIN_R,
          "rounds_per_dispatch": CHAIN_RPD, "depth": CHAIN_DEPTH, "seeds": [40, 41, 42],
          "bit_equal_pairs": 3, "wall_s": walls, "kernel_launches": launches,
          "histogram_totals": outs["cuda"]["histograms"].sum(0).tolist(), "card": card})
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rs = np.random.default_rng(args.seed)
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int_ops_per_s = sms * INT32_LANES_PER_SM * clock_mhz * 1e6

    phase_env(dev)
    phase_known_answers(dev)
    phase_middle(dev, rs)
    arrays, main_out, plain_launches = phase_full_width(dev, args.seed, card)
    s_arrays, planes, s_main_out, scen_launches = phase_scenario(dev, args.seed, card)
    fail_launches = phase_failover_full_width(dev, args.seed, card, int_ops_per_s)
    ckpt_plain, ckpt_scen = phase_checkpoint_resume_full_width(dev, args.seed, card, arrays,
                                                               s_arrays)
    cross_plain, cross_scen = phase_checkpoint_cross_device(dev, args.seed)
    sup_plain, sup_scen, sup_path = phase_supervised_full_width(
        dev, args.seed, card, arrays, main_out, s_arrays, s_main_out, int_ops_per_s)
    plain_launches = {"full_width_validity": plain_launches,
                      "checkpoint_resume_full_width": ckpt_plain,
                      "checkpoint_cross_device": cross_plain,
                      "supervised_full_width": sup_plain}
    scen_launches = {"scenario_full_width": scen_launches,
                     "failover_full_width": fail_launches,
                     "checkpoint_resume_full_width": ckpt_scen,
                     "checkpoint_cross_device": cross_scen,
                     "supervised_full_width": sup_scen}
    phase_k2_middle(dev, rs)
    phase_ed25519_known_answers(dev, rs)
    phase_ed25519_middle(dev, rs)
    ok, setup_paths, setup_t = phase_signed_setup(dev, rs)
    states, oks, seeds, k2_main, k2_launches, walls = phase_signed_sweep(dev, ok, card)
    phase_rate_with_setup(setup_t, walls, card)
    phase_faulty_leaders(dev, rs, states, oks)
    phase_rlc_known_answers(dev)
    phase_k3p_middle(dev, rs)
    c3 = phase_config3(dev, card)
    phase_coalesced_middle(dev, rs)
    slot_paths = [phase_coalesced_serving(dev, card),
                  phase_coalesced_full_width(dev, args.seed, card)]
    phase_config1(dev, card)
    phase_config4(dev, card)
    phase_majority_middle(dev, rs)
    k9_paths = [phase_eig_middle(dev, rs), phase_config2(dev, card), phase_eig_n1024(dev, card)]
    phase_ladder_pow_known_answers(dev, rs)
    phase_ladder_pow_middle(dev, rs)
    ladder_pow = phase_ladder_pow_full_width(dev, rs, card)
    shell = phase_repl_cuda(dev, card, int_ops_per_s)
    signed_middle = phase_signed_pipeline_middle(dev, args.seed)
    signed_path = phase_signed_pipeline_full_width(dev, args.seed, card)
    k2_sharded = phase_sharded_sweep_step(card, states, oks, seeds, walls)
    mesh_small = phase_mesh_pipeline(dev, args.seed, card, arrays)
    phase_mesh_checkpoint_reshard(dev, card, mesh_small)
    phase_distributed_nccl(dev, card)
    phase_node_sharded(dev, card)
    phase_repl_mesh(dev, card)
    slot_paths.append(phase_serve_bench_serving(dev, card))
    full = phase_serve_full_width(dev, args.seed, card)
    slot_paths += [full["slot"], phase_serve_warm(dev, card), shell["slot"]]
    overlapped = phase_signed_setup_overlapped(dev, setup_t, card)
    slot_paths += phase_serve_slo(dev, args.seed, card, full["requests_per_s"])
    dobs = phase_device_obs(dev, args.seed, card, arrays, main_out)
    slot_paths.append(dobs["slot"])
    slot_paths += phase_search_hunt(dev, card)
    fleet_run = phase_fleet_serve(dev, args.seed, card, full["requests_per_s"], int_ops_per_s)
    slot_paths += fleet_run["slot"]
    trace_ed = phase_fleet_trace(dev, card)
    phase_lint(dev, card)
    chain_path = phase_strategy_chain(dev, card, int_ops_per_s)
    scen_launches["strategy_chain"] = chain_path["launches"]
    plain_launches.update(fleet_run["plain"])
    plain_launches["device_obs"] = dobs["plain"]
    plain_launches["repl_cuda"] = shell["plain"]
    scen_launches["repl_cuda"] = shell["scenario"]
    kernels = [
        kernel_line_plain(dev, args.seed, arrays, main_out, plain_launches, int_ops_per_s,
                          shell["plain_path"], sup_path, dobs["plain_run"],
                          fleet_run["plain_paths"]),
        kernel_line_scenario(dev, args.seed, s_arrays, planes, s_main_out, scen_launches,
                             int_ops_per_s, shell["scenario_path"], chain_path),
        kernel_line_slot(slot_paths, int_ops_per_s),
        kernel_line_k2(states, oks, seeds, k2_main, k2_launches, int_ops_per_s),
        kernel_line_k2_sharded(k2_sharded, states, oks, seeds, int_ops_per_s),
        *kernel_lines_crypto([*setup_paths, c3, ladder_pow, *shell["ed"], signed_middle,
                              signed_path, full["ed"], *overlapped, fleet_run["ed"],
                              trace_ed],
                             int_ops_per_s),
        kernel_line_k9([*k9_paths, shell["k9"], full["k9"], fleet_run["k9"]], int_ops_per_s),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
    print(json.dumps({"kernels": kernels, "int32_ops_per_s": int_ops_per_s,
                      "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
