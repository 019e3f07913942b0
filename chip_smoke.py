#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero
without printing its result line:

1. Card check: a CUDA device is required; prints ``nvidia-smi``'s name
   and power limit.
2. Build: compiles the aggregate kernels (``csrc/aggregate.cu``), the
   flash-attention kernel (``csrc/flash_attention.cu``) and the scan
   kernel (``csrc/gla_scan.cu``) with nvcc, one process for each source,
   all started at once; it waits for the aggregate kernels, which the
   phases up to the dist phase use, and for the other two after the
   dist phase ("build wait"), printing the seconds. For K3 it prints ptxas's
   registers and spills of the bf16 kernels and fails on a spill or a
   setmaxnreg or wgmma-serialisation warning (C7508, C7520), and counts
   their HGMMA and UTMALDG instructions in the SASS (cuobjdump), which
   must not be 0. For K4 it prints, for each kernel the K4 main path
   instantiates (the scores and walk kernels at both shapes, chunk 64),
   ptxas's registers and spills, the walk's tiling and dynamic shared
   memory, and the HMMA (tensor-core) instructions in its SASS; it fails
   on a spill or a kernel without HMMA.
3. Kernel phase, at the Fig-1 shape (N = 40 clients, P = 316,554 CNN
   parameters) and at a ragged P = 2,049: K1 (dense; masked with inf/NaN
   rows; bf16 gradients into f32) and K2 (update f32; update of bf16
   params; delta) against their plain PyTorch versions on the card,
   K2 against K1 → update bitwise, masked rows exact zeros. Prints the
   kernels' geometry at the Fig-1 shape: blocks (one a SM), the span of
   P a block owns, rows a stage, stages, and the bytes in flight a SM.
   Times K1 and K2 at the Fig-1 shape with CUDA events over 60 launches,
   the L2 cache flushed before each by a pass that reads a 256 MB
   buffer through (it leaves the L2 holding clean lines of that buffer
   and none of the inputs), and back to back, beside the plain versions,
   the one PyTorch call that computes the same function, and the bound.
   K3 and K4 are timed the same way.
4. Fig-1 phase: the paper's Fig-1 training loop at full width through
   ``ClientSimulator`` with ``use_kernel=True``: alg1, benchmark1,
   benchmark2 and oracle with sgd(0.05) (kernel K2), alg1 with momentum
   (kernel K1), and both again with 4 of the 40 clients masked out (the
   masked bodies). 40 steps each, evaluated every 20. The launch counts
   are set to 0 before these runs and must equal the steps that used
   each kernel. Then alg1/sgd runs once more through the plain torch
   matvec (``use_kernel=False``) as the reference the kernel run must
   agree with, and a last run under ``torch.profiler`` prints where a
   step's device time goes and the device's busy share. Then the legacy
   per-leaf carry at the same width, K1 once a leaf (8 launches a step,
   counted from 0 before each run and held at 8 x steps, K2 at 0): (a)
   ``flat=False`` all f32 with sgd, with momentum, and with sgd and the
   4 masked clients (none may take part), and (b) the CNN with its 4
   biases (170 parameters) in bf16 under the default ``flat=None``, 40
   steps each, finite; and, under deterministic cuDNN, REF_STEPS of (a)
   with sgd against the flat route (K2) from the same seed:
   participation bitwise, params within ``rtol=1e-4, atol=1e-5``, and
   whether they are bitwise equal printed.
   Legacy K1 timings: K1 at each leaf shape of (a) and (b) (40 rows; f32
   leaves of 10 to 262,144 columns, bf16 leaves of 10, 32 and 64) against
   its plain version, timed flushed and warm beside the plain version,
   ``torch.mv`` and the bound, and a step's 8 launches summed beside the
   flat route's one K1. The legacy carry's added seconds print on a line
   of their own.
5. Engine phase: the experiments engine (``repro_torch.experiments``)
   at the Fig-1 width, with the Fig-1 phase's data and batcher, through
   the kernels (``use_kernel=True``) under deterministic cuDNN. The
   ``fig1`` study (4 cells x seeds 1 and 2 x 40 steps, evaluated every
   20): K2 must launch once a step of every cell and seed, every cell
   must stay finite, and the alg1 cell's seed 1 must equal a standalone
   ``ClientSimulator.run`` of that cell bit for bit (participation,
   parameters, evaluations). The ``population_scaling`` study at
   n = 10, 20, 40 in a capacity of 40 (one ragged structure group, one
   seed): K2 launches counted, participation cropped to (steps, n), and
   the n = 10 cell rerun uncropped, where clients 10..39 must never take
   part and clients 0..9 must equal the engine's cell. One alg1 cell
   with momentum: K1 once a step. A legacy study (the CNN with its
   biases in bf16, the simulator's legacy per-leaf carry; alg1 at n = 30
   and 40, one ragged group, seeds 1 and 2, 40 steps): K1 8 x steps of
   every cell and seed, no K2; then checkpointed every 20 steps, cut
   after its first checkpoint and resumed in this process, launching
   only the missing steps, every cell bitwise the grouped run. The
   counts are set to 0 before each study. Prints each study's cells,
   seeds, steps, wall seconds and ms/step, beside the standalone run's
   ms/step.
6. Faults and resume phase, with the engine phase's data and CNN under
   deterministic cuDNN, seed 1, 40 steps a cell: alg1 cells clean, drop
   at rate 0, drop 0.3, drop_corrupt with every row NaN-poisoned and
   dropped, stale 0.5 with delay 3, and per-client offline windows
   through K2 (sgd), and a drop 0.3 cell with momentum through K1; the
   counts are set to 0 before each run and must equal cells x steps.
   Rate 0 must equal the clean cell bit for bit; the NaN cell must
   leave the params unmoved and finite with no delivered weight; stale
   must deliver less than the clean cell before its delay and the same
   after; no fault may change the schedule. Each K2 cell is timed alone
   three times, the cells in turns (host clock, synchronised; the
   median printed), and profiled over 2 steps (device ops a step, the
   device's busy share). Then a
   checkpointed study (clean, drop, stale; chunks of 10) through
   ``execute_cells_resumable``, bitwise ``execute_cells``, with each
   group's checkpoint size and the time of one write of it from the
   card; a child process (this script with ``--resume-child``) runs the
   same study and SIGKILLs itself after its second checkpoint; the
   directory is resumed (bitwise the uninterrupted run, only the
   missing steps launched) and replayed once finished (no launch).
   Each line carries the card's name and power limit.
7. Serve phase: the Study service (``repro_torch.serve.StudyService``)
   on the card over the Fig-1 CNN (the faults phase's data and params,
   ``sgd(0.05)``, ``use_kernel=True``, cuDNN deterministic). A cold
   round of 8 JSON manifests of one structure (alg1 on the Fig-1
   arrivals, n = 10, 15, ..., 40, 40 in a capacity of 40, seed 1, 20
   steps): every response without error, one dispatch, one compile,
   exactly 160 K2 launches, and the n = 10 and n = 40 responses bit for
   bit their solo ``Study.run``. A warm round of the same 8: no new
   compile, responses bit for bit the cold round's. 4 threads submit
   through ``BackgroundServer`` beside a competing flusher: the K2 count
   exact, every response bit for bit the cold round's of its n. One
   momentum manifest through K1. A child process (this script with
   ``--serve-child``) serves 3 checkpointed manifests (40 steps, chunks
   of 10) and SIGKILLs itself after its second checkpoint; a fresh
   service's ``recover()`` resumes the dispatch, bit for bit an
   uninterrupted checkpointed dispatch, launching only the missing
   steps. Then ``repro_torch.launch.serve --demo --demo-requests 4
   --demo-steps 30`` in this process. Prints each round's wall time,
   p50/p99 request latency (taken after the card finished), scenarios/s
   and launches, with the card's name and power limit. Any response
   with an ``error`` fails the phase.
8. Dist phase: the Fig-1 study across ranks, started by
   ``repro_torch.launch.distributed.launch_simulated`` as copies of this
   script (``--dist-child``, each a rank from the ``REPRO_DIST_*``
   environment): 4 ranks over NCCL on a machine of four cards or more,
   2 on one of two or three (40 clients split over 2 or 4 ranks, not
   3), else 2 ranks sharing the one card over gloo. N = 40 clients, the
   316,554-parameter CNN, batch 16, 4 energy groups, sgd 0.05; alg1 and
   benchmark1 at populations 40 and 37, 2 seeds, 10 steps, through
   ``Study.run(config=ExecutionConfig(mesh=...))`` on a clients mesh at
   ``gather``, ``psum`` and ``fused``, a cells mesh, and a 2 x 2 grid
   mesh when W = 4; each with ``use_kernel=True`` and again with
   ``use_kernel=False``. Each rank first holds K1 and K2's delta form at
   its shard of a ragged (40, P) buffer whose last shard has every row
   masked (NaN) against their plain versions (1e-6; that shard's
   results exact zeros). Held here: cells and ``gather`` bitwise the
   same study run unsharded in this process; ``psum`` and ``fused`` over
   two client shards bitwise (every step's loss, the params, the
   participation) the unsharded study with its client sum split in two
   halves as the ranks split it (``split_rows``: each half through K1,
   or K2's delta, alone, then one f32 add, which is what two ranks'
   all-reduce does), their weight sums within 1e-6; over four shards
   (the ring's order) participation bitwise and the losses of steps 1-3
   within rtol=1e-5, atol=1e-6 of the unsplit study. The per-step loss
   distance to the unsplit study and the final params' are printed.
   Each kernel run against its plain run at the same mesh within 1e-6;
   one compile per structure group per rank and none on the warm
   repeat; the params' sha256 equal on every rank; each rank's K1 and
   K2 launches (a launch a step of every cell the rank runs). Prints
   the backend, world size, cards and whether they are shared, each
   combination's ms per cell-step on each rank (host clock,
   synchronised, median and spread of its first run and a repeat, after
   one untimed step that pays a fresh process's one-off costs), and K1
   and K2's delta timed at a shard's rows (20 and 10 of 40, the last
   masked) beside their plain versions, ``torch.mv`` / ``torch.addmv``
   and the bound (the active rows' bytes). Each line carries the card's
   name and power limit, "shared card" where the ranks shared one.
9. K3 phase: the flash-attention kernel against its plain version
   computed in f32 from the same inputs, at the prefill shape of the LM
   phase (B = 8, H = 32, S = T = 2,048, Dh = 64, causal, bf16),
   minitron-4b's attention at the same B and S (H = 24, Hkv = 8,
   Dh = 128, causal: the GQA shape of the later models), GQA 24/8 with
   Dh = 128, a 512 window, bidirectional f32, ragged S = T = 1,000,
   S = 100 against T = 40 with a 16 window (rows that see no key must be
   exact zeros), zamba2-2.7b's shared attention at the same B and S
   (H = Hkv = 32, Dh = 80, causal, in the Dh = 128 tile), Dh = 80 with
   GQA 32/8 and a 256 window at a ragged S = T = 1,000, and Dh = 80 in
   f32, the GQA shapes of deepseek-coder-33b (H = 56, Hkv = 8),
   llama4-scout (H = 40, Hkv = 8), command-r-35b (H = 64, Hkv = 8),
   phi3.5-moe (H = 32, Hkv = 8) and qwen2-vl-2b (H = 12, Hkv = 2),
   Dh = 128, at the same B and S, and whisper-tiny's decoder
   self-attention (B = 8, H = Hkv = 6, S = T = 448, Dh = 64). Times K3
   at each model's shape, flushed and warm,
   beside the plain version, ``F.scaled_dot_product_attention`` and the
   bound, with the achieved TFLOP/s, the share of the bound, and the
   time the exponentials take at the MUFU rate (one ex2 per visible
   score, 16 a clock per SM at the card's top SM clock).
10. K4 phase: the gated-linear-recurrence scan through
   ``repro_torch.kernels.ssm_scan.gla_scan`` at the full width of the two
   layers it serves, B = 8 × S = 2,048, chunk 64: zamba2-2.7b's Mamba2
   layer (H = 80, dk = dv = 64; a and v f32, k and q bf16, one row a
   position broadcast over the heads with stride 0, as the block makes
   them) and
   xlstm-1.3b's mLSTM layer (H = 4, dk = 1,024, dv = 1,025; f32). The
   K4 count is set to 0 before these two calls and must be 2 after. Both
   outputs, a ragged S = 2,000, small decays (a log-uniform down to 1e-6,
   with exact zeros for the 1e-12 clamp) and chunk 32 against chunk 64
   are held against the plain sequential version on the card. Times K4
   at both shapes, flushed and warm, beside the plain version, the port's
   ``chunked_gla`` (the nearest comparator: no single PyTorch call
   computes this function) and the bound of the route the kernel takes:
   the larger of the bytes and 3 x the operations at the TF32 tensor-core
   rate (3xTF32). The line also prints the bound at the f32 rate, the
   count earlier runs report; the ``kernels`` line holds the route's.
11. LM phase: stablelm-1.6b at full width (24 layers, d_model 2048, 32
   heads of 64, d_ff 5632, vocab 100352, bf16; random weights from a
   seed). Three prefills of B = 8 × S = 2,048 through
   ``make_prefill_step`` with ``use_flash=True``: the K3 count is set to
   0 before them and must be 24 × 3 after. Then the same prefill with
   plain attention (bf16) and with the weights upcast to f32 and plain
   attention (the reference): flash's last-position logits must lie
   within 2× the plain bf16 prefill's distance from the reference (the
   floor), and flash's argmax must equal the reference's on every row
   whose top-two gap exceeds 2× the floor. Then decode at B = 8 through
   ``make_serve_step``: a 192-token prompt fed token by token into a
   512-slot cache, its logits at position 191 held against the f32
   reference prefill of those 192 tokens by the same rule, and 32
   greedy steps. ``torch.profiler`` over one prefill and one decode
   step, and the peak device memory.
12. Train phase, on the LM phase's weights: the driver
   (``repro_torch.launch.train.main``) at stablelm-1.6b full width, remat
   on, B = 16 x S = 1,024 over 8 clients, alg1 on periodic arrivals,
   adamw 1e-4: one warm-up step, 6 timed (host clock after a
   synchronise; median and spread), the last of them under
   ``torch.profiler`` (the profiler started before its clock). Prints
   ms a step, tokens/s, the model FLOP a step and their share of the
   dense bf16 peak (``mfu``), the losses (finite, the last below the
   first), active clients and the weight sum a step, and the peak
   device memory. Then, with deterministic algorithms: one adamw step
   where alg1 masks a client, run again with that client's tokens
   replaced, must give the same update bit for bit; the flat SGD route
   (``build_energy_train_step(flat=True, use_kernel=True)``, sgd 0.05)
   3 steps, K2's count set to 0 before and 3 after, against the same
   steps through K2's plain version; K2 timed alone at that one-row
   shape (P = 1,644,883,968 bf16) beside ``torch.add``; and, at full
   width cut to 2 layers, a straight 8-step driver run against one
   halted at step 4 (``--halt-at``) and resumed in a child process (this
   script with ``--train-child``): losses and final params bitwise.
13. Recurrent phase: zamba2-2.7b (9 super-blocks of 5 Mamba2 blocks and
   the shared attention block, Dh = 80) and xlstm-1.3b (6 of 7 mLSTM and
   1 sLSTM) at full width, random bf16 weights from a seed, in turn.
   One prefill of B = 8 x S = 2,048 through ``make_prefill_step`` with
   ``use_flash=True``: the K4 and K3 counts are set to 0 before it and
   must be 45 and 9 (zamba2: a K4 call a Mamba2 layer, a K3 call a
   shared-block call) or 42 and 0 (xlstm: a K4 call an mLSTM layer)
   after it; one more prefill timed. Then the same prefill on the plain
   route (``chunked_gla``, plain attention) in bf16, and in f32 with the
   weights upcast (the reference), and the LM phase's rule: the kernel
   prefill's last-position logits within 2x the plain bf16 prefill's
   distance from the reference, the same argmax on every row whose
   top-two gap exceeds 2x that floor; and the kernel route in f32 with
   the f32 weights within 1e-2 of max|logit| of the reference, its
   argmax the reference's above twice that distance. Decode through
   ``make_serve_step``:
   a 64-token prompt fed token by token into a 256-slot cache, its
   logits at position 63 held against the f32 reference prefill of
   those tokens by the same rule, then 16 greedy steps. One prefill under
   ``torch.profiler``, tracing the device alone (top kernels, the
   device's busy share, K4's and K3's shares of the device time), and
   the peak device memory. Each line
   carries the card's name and power limit.
14. Zoo phase: the five decoder-only configs at full width, random bf16
   weights from a seed, each at the depth one card holds beside its f32
   copy: minitron-4b (all 32 layers), deepseek-coder-33b (4 of 62),
   command-r-35b (4 of 40), phi3.5-moe-42b-a6.6b (6 of 32; 16 experts
   top-2) and llama4-scout-17b-a16e (3 of 48; 16 experts top-1 and a
   shared expert), in turn: init (seconds, parameters, peak memory); one
   prefill of B = 8 x S = 2,048 through ``make_prefill_step`` with
   ``use_flash=True``, the K3 count set to 0 before it and equal to the
   layers after it, and one more timed; the plain bf16, f32 reference
   and f32 K3-route prefills and the recurrent phase's rule, on every
   row for a dense model; an MoE model's routing is logged
   (``moe.routing_log``), and a row whose last token two routes sent to
   other experts, or dropped in one, is not held (PERF.md §2); the
   dropped share of the MoE dispatch's (token, k) assignments in the
   prefills, in a prefill of uniform tokens and in decode, and each
   layer's; decode replay of a 64-token prompt into a 256-slot cache,
   held against the f32 reference prefill of the prompt (dense); for an
   MoE model, against an f32 replay through the same serve step by the
   same rule: first at a capacity that drops nothing (the floor the
   prompt's prefill at that capacity; and f32 against the f32 prefill
   of the prompt within 1e-2 of max|logit|), then at the decode step's
   capacity of one assignment an expert (the floor the replays without
   drops); then 16 greedy steps. One phi3.5-moe prefill under
   ``torch.profiler`` (host and device): K3, the MoE layer's router,
   dispatch, expert products and combine (its ``torch.profiler``
   ranges), and the rest, as shares of the device time. Each line
   carries the card's name and power limit. phi3.5's prefill, decode
   (the replay and 8 greedy steps, their routing logged) and floor are
   kept for the ep phase.
15. Ep phase: phi3.5-moe-42b-a6.6b at full width served with its
   experts split over ranks (``repro_torch.models.moe``'s
   expert-parallel path), random bf16 weights from seed 0, the zoo
   phase's tokens; ranks are copies of this script (``--ep-child``)
   started by ``launch_simulated``. One card: two ranks share it over
   gloo, at the zoo phase's 6 layers, on ``(data 2, model 1)`` (all 16
   experts a layer, half the rows each), then ``(data 1, model 2)``
   (each rank's 8 of 16 experts a layer cut from that model,
   ``place_params``, the other 8 freed). On each
   mesh a rank prints its rows, experts and bytes, its prefill ms (the
   first counted: K3 once a layer, and two more), one ``all_reduce``
   of a layer's partial outputs timed alone, decode (the zoo phase's
   64-token replay, then 8 greedy steps) ms a step, its peak memory
   and aux loss, and the mesh its dropped share. ``(1, 2)`` is held
   against the zoo phase's one-rank run: bitwise (logits, every
   token's routing, greedy tokens) when cuBLAS gives a batch of 8
   experts the bits of 16 (checked and printed), else by the zoo
   phase's rule. ``(2, 1)`` is held bitwise against each data shard's
   rows prefilled alone on rank 0, by the rule against rank 0's global
   path at ds = 2 (a ``("data",)`` layout mesh: per-shard positions
   and capacity, every row, the decode too), and its aux within 1e-6
   of the mean of the shards' own. The ranks start once K3 is built,
   after the Fig-1 phase ("k3 build wait"), run beside the engine,
   faults and serve phases, which leave the card idle most of a step
   ("ep wait" is the wait for them before the dist phase, whose timings
   they must not share the card with), and are reported after the zoo
   phase. Four cards: a rank a card over NCCL, ``(1, 4)`` at all 32
   layers (4 experts a layer a rank, each rank drawing its own alone,
   ``init_lm(mesh=)``) and ``(2, 2)`` at 6, a prefill held layer by
   layer: each MoE layer's output and routing
   against the one-rank ``apply_moe`` on its input with the layer's
   experts gathered from the row (within 2**-7 of its largest value,
   every token routed alike). After their serving meshes the ranks
   train phi3.5-moe with its experts split over them
   (``make_sgd_train_step`` / ``make_train_step`` under ``use_mesh``,
   plain attention, remat, 8 clients, alg1's decision that masks a
   client, the masked client's rows last, Zipf-Markov tokens from seed
   1). One card, B 8 x S 1,024 at 1 of 32 layers cut from the ranks'
   serving weights: ``(2, 1)`` SGD (lr 0.01, 2 steps; each rank all 16
   experts and 4 rows, the gradients summed over the data group), then
   ``(1, 2)`` adamw (1e-4, 3 steps; each rank 8 experts a layer). Four
   cards, B 16: ``(1, 4)`` adamw 1e-4 at 1 layer (3 steps, held), then
   at 6 layers (adamw 3e-5, the deepest a card holds; 5 steps, not held:
   no card holds the one-rank model), ``(2, 2)`` adamw at 1.
   Each step is timed and its ``all_reduce`` calls counted and timed
   (bytes, ms); a rank prints its peak memory, losses (finite, falling)
   and K3 launches (0: no backward). A held mesh's first step is held
   against the same function stepped on one rank with no collective
   (every row off a mesh; or each data shard's rows stepped alone, a
   ``(dp, 1)`` layout, at 1/dp of the aux-loss weight, the gradients
   summed), on the whole model: SGD's new params or adamw's first
   moment (0.1 of the gradient), this rank's block of each leaf, each
   leaf within 2x its floor (that reference's distance from itself in
   f32, computed only when some leaf is not bitwise), bitwise leaves
   counted; with every row on every rank (``(1, 2)``, ``(1, 4)``) step
   0's loss bit for bit. After the steps
   every leaf whole on the ranks of a row is the same bits on all of
   them, an expert leaf on its column (sha256). The masked client's rows
   given other tokens leave the update bitwise the same at capacity
   factor E / top_k without the aux loss.
   ``--ep-only`` runs this phase alone (for four cards; on one, ``(1,
   2)``'s serving has no one-rank run to be held against). Each line
   carries the card's name and power limit.
16. Multimodal phase: qwen2-vl-2b (28 layers, 12 heads over 2 kv heads
   of 128, M-RoPE, 256 vision tokens) and whisper-tiny (4 encoder and 4
   decoder layers, 6 heads of 64, sinusoidal positions) at full width
   and depth, random bf16 weights from a seed, in turn: init; one
   prefill through ``make_prefill_step`` with ``use_flash=True`` (qwen2-vl:
   B = 8 x S = 2,048, the first 256 positions replaced by synthetic
   vision embeddings (8, 256, 1,536) at the embedding's scale; whisper:
   B = 8 x S = 448 with synthetic frame embeddings (8, 1,500, 384),
   encoded in the prefill), the K3 count set to 0 before it and 28 or 4
   after (whisper's encoder and cross attention take the plain
   attention, as in the JAX package), then 4 timed (median and spread);
   the plain bf16, f32 reference and f32 K3-route prefills and the
   recurrent phase's rule on every row; qwen2-vl's prefill again with
   three distinct position rows (the vision tokens on a 16 x 16 grid,
   the text after it), which must move the f32 reference by more than
   the floor, held by the same rule, 28 K3 launches; whisper's encoder
   alone; decode replay of a 64-token prompt (qwen2-vl: text; whisper:
   through the encoder's memory) into a 256- or 448-slot cache, held
   against the f32 reference prefill of the prompt, then 16 greedy
   steps; one prefill under ``torch.profiler`` (K3's share of the device
   time); the peak device memory. Each line carries the card's name and
   power limit.
17. Zoo train phase: whisper-tiny (B = 16 x S = 448, 1,500 zero frames),
   qwen2-vl-2b (B = 16 x S = 1,024, 256 synthetic patch embeddings a
   row, given to the driver as ``side_inputs``: its own zero vision
   tokens make full-depth training non-finite, ROADMAP R5), zamba2-2.7b
   and xlstm-1.3b (B = 16 x S = 1,024) at full width and depth, and
   phi3.5-moe-42b-a6.6b at 1 of its 32 layers, random bf16 weights from
   seed 0, in turn, each freed before the next: the driver's run as in
   the train phase (one warm-up step, the timed steps of ``ZOO_TRAIN``,
   the last under ``torch.profiler``, the device alone): ms a step,
   tokens/s, the model FLOP a step (matmul weights, an expert's at
   top_k / E, and attention scores; not the recurrent scans) and
   ``mfu``, the losses (finite, the last below the first), the peak
   device memory, the profile's top kernels and busy share, and for
   phi3.5 the dropped share a step. Step 0's batch loss in bf16 (equal
   to the driver's) within 1e-2 of the same weights in f32. One adamw
   step where alg1 masks a client, run again with the last masked
   client's tokens replaced, deterministic algorithms on: the same
   update bit for bit; phi3.5 bitwise at capacity factor E / top_k
   without the aux loss, its move printed at its own capacity and with
   the aux loss. zamba2's flat SGD route through K2 (its f32 SSM leaves
   cast to bf16 for the one-dtype flat buffer), 1 step, counted, against
   K2's plain version. Each line carries the card's name and power
   limit.
18. Prints the ``kernels`` JSON line (K1 also carries the legacy
   carry's launches, ``legacy_launches`` (the Fig-1 phase's runs and the
   engine's legacy study), its times at each leaf shape,
   ``legacy_shapes``, and a step's 8 launches summed,
   ``legacy_step_ms`` and ``legacy_step_bound_ms``; K1 and K2 also carry
   the engine,
   faults, serve and dist phases' counts, ``engine_launches``,
   ``faults_launches``, ``serve_launches`` and ``dist_launches`` (a
   rank's, by combination), and their times at a shard's rows,
   ``sharded_shapes``; K2 the train phases'
   flat SGD launches, ``train_launches`` (stablelm's under ``flat_sgd``,
   zamba2's under its name), and its time at stablelm's shape,
   ``train_shape``; K3
   and K4 the recurrent phase's, ``recurrent_launches``; K3 the zoo,
   multimodal and ep phases', ``zoo_launches``, ``mm_launches`` and
   ``ep_launches`` (a rank's prefill by mesh, and its training steps,
   ``train <mesh>``); K4's
   ``launches`` are the recurrent prefills', its K4 phase's count
   ``phase_launches``), then the result line.

The three child processes (``--resume-child``, ``--serve-child``,
``--train-child``) are started a little before they are needed: each
loads the interpreter, torch and the port while this process works on,
then waits on its standard input for its directory. The train child
reports its last step before the driver writes its final checkpoint;
that write runs beside the recurrent phase, and the child's exit is
checked after it (``phase seconds`` lists the wait as "resume end").
The dist phase's ranks (``--dist-child``) are started by
``launch_simulated`` when that phase begins; the ep phase's
(``--ep-child``) after the Fig-1 phase.

Tolerances: f32 aggregate kernels against the plain versions
rtol=atol=1e-6 (the client sum runs in another order; weights at the
trainer's scale, Σω≈1); bf16 gradients into f32 1e-5; a bf16 result
within one bf16 rounding step (relative 2**-8), as the flat SGD
route's bf16 params through K2 against its plain version. K3 in bf16:
max|K3 − plain_f32| ≤ 2**-7 · max|plain_f32| (two bf16 roundings: p for
the tensor-core product, and the output); K3 in f32 rtol=atol=1e-5.
K4 (f32 arithmetic on any mix of f32 and bf16 inputs, the same inputs
for both sides): max|K4 − plain| ≤ 1e-4 · max|plain|, chunk 32 against
chunk 64 likewise.
TF32 is off for matmuls and convolutions, so every reference is full
f32.
"""

import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
# cuBLAS takes its workspace setting when CUDA starts: the train phase's
# deterministic checks need a fixed one.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
SOURCE = "src/repro_torch/kernels/aggregate/csrc/aggregate.cu"
K3_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
K4_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/gla_scan.cu"
N_CLIENTS, N_GROUPS, BATCH, LR = 40, 4, 16, 0.05
N_TRAIN, N_TEST = 8000, 800
STEPS, EVAL_EVERY, REF_STEPS, PROFILE_STEPS = 40, 20, 3, 10
# Engine phase: the seeds of the fig1 study, the populations of the
# population_scaling study (at the Fig-1 capacity of 40 clients).
ENGINE_SEEDS, POPULATIONS = (1, 2), (10, 20, 40)
# Faults and resume phase: the cells (name, fault family, its kwargs),
# alg1 at the Fig-1 width, seed 1; the cells of the checkpointed study,
# its chunk, and the timing repeats of each cell.
FAULT_CELLS = (
    ("clean", None, {}),
    ("drop_rate0", "drop", {"rate": 0.0}),
    ("drop", "drop", {"rate": 0.3}),
    ("drop_corrupt_nan", "drop_corrupt", {"drop_rate": 1.0,
                                          "corrupt_rate": 1.0,
                                          "scale": float("nan")}),
    ("stale", "stale", {"rate": 0.5, "delay": 3}),
    # Every client offline 4 steps in 20, the windows staggered.
    ("offline", "offline", {"start": [3 * i % 20 for i in range(N_CLIENTS)],
                            "length": 4, "period": 20}),
)
RESUME_CELLS, CHECKPOINT_EVERY, TIMING_REPEATS = ("clean", "drop", "stale"), 10, 3
# Serve phase: the populations of the 8 manifests of a round (alg1 on
# the Fig-1 arrivals, seed 1), their steps, the submitting threads, and
# the populations of the recovered dispatch (STEPS steps, checkpoints
# every CHECKPOINT_EVERY).
SERVE_POPULATIONS, SERVE_STEPS, SERVE_THREADS = (
    (10, 15, 20, 25, 30, 35, 40, 40), 20, 4)
RECOVER_POPULATIONS = (20, 30, 40)
# Dist phase: the Fig-1 study across ranks (schedulers, populations,
# steps, seeds, the client reductions of a clients axis, the repeats of a
# kernel combination after its first run, and the steps whose losses
# psum and fused over four client shards are held over), and the shard
# rows K1 and K2's delta are timed at.
DIST_SCHEDULERS, DIST_POPULATIONS = ("alg1", "benchmark1"), (40, 37)
DIST_STEPS, DIST_SEEDS, DIST_REPEATS, DIST_HELD_STEPS = 10, 2, 1, 3
DIST_REDUCTIONS = ("gather", "psum", "fused")
DIST_ROWS = (20, 10)
# Steps a fault cell is profiled over: a step's device ops do not vary,
# and the profiler's own cost grows with the ops it records.
FAULT_PROFILE_STEPS = 2
TIMED_LAUNCHES = 60
# K3's plain version takes 1–57 ms a call at the timed shapes: fewer
# calls time it as well.
K3_PLAIN_LAUNCHES = 10
# LM phase: batch, prefill length, prefills counted, decode prompt,
# cache slots and greedy steps.
LM_BATCH, LM_SEQ, LM_PREFILLS = 8, 2048, 3
LM_PROMPT, LM_CACHE, LM_GREEDY = 192, 512, 32
LM_PARAMS = 1_644_883_968
# Train phase: the driver at full width (clients, global batch, sequence
# length, warm-up and timed steps, then one profiled step), the flat SGD
# route's steps and lr, and the resume check (layers, steps, halt).
TRAIN_CLIENTS, TRAIN_BATCH, TRAIN_SEQ = 8, 16, 1024
# adamw at 1e-4, not the driver's default 3e-4: Adam's first steps move
# every weight by about lr (lr x sign(g)), and at d_model 2,048 without
# warm-up 3e-4 throws the loss up to 16.5 within 8 steps from 12.1
# (benchmarks_torch/train_lr.py on the card).
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_LR = 1, 6, 1e-4
FLAT_STEPS, FLAT_LR = 3, 0.05
RESUME_LAYERS, RESUME_STEPS, RESUME_HALT = 2, 8, 4
K2_TRAIN_LAUNCHES = 10
# Bytes a masked-client check may hold on the card: the first of its two
# updates stays there if the step's peak and the update fit below this
# (of 79.6 GB), else it waits on the host.
KEEP_ON_CARD = 70e9
# Peak rates of the H100 SXM (NVIDIA data sheet): HBM bytes/s, f32
# (non-tensor-core) flop/s, dense bf16 and dense TF32 tensor-core flop/s.
# torch names that card "NVIDIA H100 80GB HBM3".
H100_SXM = "H100 80GB HBM3"
H100_SXM_PEAKS = (3.35e12, 67e12, 989e12, 495e12)


def card_peaks(name):
    if H100_SXM not in name:
        raise RuntimeError(f"no peak rates known for {name!r}: the bound is "
                           f"stated for the H100 SXM ({H100_SXM}) only")
    return H100_SXM_PEAKS


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def spawn_child(flag, stderr=subprocess.PIPE):
    """Start this script as a ``flag`` child now: it loads the
    interpreter, torch and the port and makes its CUDA context while
    this process works on (the train resume line prints its child's
    share of that), then waits on its standard input for its directory
    (:func:`child_directory`; :func:`run_child` sends it). A child left
    waiting exits when this process does and its stdin closes."""
    return subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag, "-"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr,
        text=True)


def run_child(proc, directory, timeout=600):
    """Send a :func:`spawn_child` child its directory and wait for it
    (killed at ``timeout``); returns its ``CompletedProcess``."""
    try:
        out, err = proc.communicate(directory + "\n", timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def child_directory(arg):
    """A child's directory: ``arg``, or for ``-`` the line its parent
    sends once the child has loaded and made its CUDA context
    (:func:`spawn_child`)."""
    if arg != "-":
        return arg
    import torch

    torch.zeros((), device=DEVICE)
    line = sys.stdin.readline().strip()
    if not line:
        raise SystemExit("chip_smoke child: the parent sent no directory")
    return line


def flush_buffer(torch):
    """The 256 MB buffer ``time_ms`` reads through, written once."""
    return torch.zeros(64 * 2 ** 20, dtype=torch.float32, device=DEVICE)


def time_ms(torch, fn, flush, n=TIMED_LAUNCHES):
    """Mean ms per call over ``n`` calls: (flushed, warm). The flushed
    figure reads the 256 MB ``flush`` buffer through (its sum into a
    scalar) before each call, so the 50 MB L2 holds none of the inputs,
    only clean lines of the buffer: a pass that wrote it would leave up
    to 50 MB of dirty lines for the timed call to write back. The warm
    figure runs the calls back to back."""
    sink = torch.empty((), dtype=torch.float32, device=DEVICE)
    for _ in range(min(3, n)):
        fn()
    pairs = []
    for _ in range(n):
        torch.sum(flush, dim=0, out=sink)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    flushed = sum(s.elapsed_time(e) for s, e in pairs) / n
    return flushed, start.elapsed_time(end) / n


def profile(torch, label, unit, fn, n_units, keep=None, top=8, cpu=True):
    """Print ``torch.profiler``'s view of ``fn`` (``n_units`` steps or
    prefills): wall and device-busy time per unit, the device's busy
    share of the wall time, and the ``top`` kernels by device time (plus
    any kernel whose name holds ``keep``). ``cpu=False`` traces the
    device alone: the host's operator events cost the profiler about
    three times as long to sort, for lines that read only device rows."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[act.CPU, act.CUDA] if cpu else [act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_report(torch, label, unit, prof, wall_us, n_units, keep, top)


# The device's events in a profiler's Chrome trace: kernels, copies, fills.
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_rows(prof):
    """A finished profiler's device events summed by name: (name, us,
    count). They are read from the Chrome trace, which the profiler
    writes in C++; ``key_averages`` would build a Python event for each
    record first, ~100 s for the ~574k device ops of an xlstm train
    step."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    sums = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENTS:
            us, n = sums.get(e["name"], (0.0, 0))
            sums[e["name"]] = (us + e["dur"], n + 1)
    return [(name, us, n) for name, (us, n) in sums.items()]


def profile_report(torch, label, unit, prof, wall_us, n_units, keep=None,
                   top=8):
    """The lines of :func:`profile` for a finished profiler ``prof`` that
    covered ``wall_us`` of wall time. Returns the kernel rows (name,
    device us, count) and their device us in all."""
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    check(busy_us > 0, f"profile {label}: the profiler saw no device time")
    print(f"profile {label}: wall {wall_us / n_units / 1e3:.2f} ms/{unit}, "
          f"device busy {busy_us / n_units / 1e3:.2f} ms/{unit} "
          f"({100 * busy_us / wall_us:.1f} % of wall), "
          f"{sum(r[2] for r in rows) / n_units:.0f} device ops/{unit}")
    ranked = sorted(rows, key=lambda r: -r[1])
    for name, us, count in ranked[:top] + [r for r in ranked[top:]
                                           if keep and keep in r[0]]:
        print(f"profile {label}:   {100 * us / busy_us:5.1f} %  "
              f"{us / n_units:9.1f} us/{unit}  x{count / n_units:<6.1f} "
              f"{name[:90]}")
    return rows, busy_us


def kernel_phase(torch, ops, ref, peaks):
    """Correctness at both shapes; timings at the Fig-1 shape."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    eta = torch.tensor(LR, device=DEVICE)
    errs = {"k1": 0.0, "k2": 0.0}
    timing = {}
    for n, p in ((N_CLIENTS, 316_554), (N_CLIENTS, 2_049)):
        g = torch.randn(n, p, device=DEVICE, generator=gen)
        w = torch.rand(n, device=DEVICE, generator=gen) * (2.0 / n)
        mask = (torch.arange(n, device=DEVICE) % 7 != 3).float()
        params = torch.randn(p, device=DEVICE, generator=gen)
        poisoned = g.clone()
        poisoned[mask == 0] = float("inf")
        poisoned[3] = float("nan")
        clean = torch.where(mask[:, None] > 0, g, 0.0)

        def close(name, got, want, tol):
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            errs[name] = max(errs[name], (got - want).abs().max().item())

        k1 = ops.masked_scaled_aggregate(g, w)
        close("k1", k1, ref.masked_scaled_aggregate_ref(g, w), 1e-6)
        k1m = ops.masked_scaled_aggregate(poisoned, w, mask=mask)
        check(torch.equal(k1m, ops.masked_scaled_aggregate(clean, w, mask=mask)),
              "K1: masked inf/NaN rows must contribute exact zeros")
        close("k1", k1m, ref.masked_scaled_aggregate_ref(clean, w, mask), 1e-6)
        gb = g.to(torch.bfloat16)
        torch.testing.assert_close(
            ops.masked_scaled_aggregate(gb, w, out_dtype=torch.float32),
            ref.masked_scaled_aggregate_ref(gb, w, None, torch.float32),
            rtol=1e-5, atol=1e-5)

        for m, gg, k1_ in ((None, g, k1), (mask, poisoned, k1m)):
            k2 = ops.masked_scaled_aggregate_update(gg, w, eta, params, m)
            cl = g if m is None else clean
            close("k2", k2, ref.masked_scaled_aggregate_update_ref(
                cl, w, eta, params, m), 1e-6)
            check(torch.equal(k2, params + (-eta * k1_)),
                  "K2 must equal K1 followed by params + (-eta * agg), bitwise")
            delta = ops.masked_scaled_aggregate_update(gg, w, eta, None, m)
            close("k2", delta, ref.masked_scaled_aggregate_update_ref(
                cl, w, eta, None, m), 1e-6)
            check(torch.isfinite(k2).all(), "K2 output not finite")
        pb = params.to(torch.bfloat16)
        torch.testing.assert_close(
            ops.masked_scaled_aggregate_update(g, w, eta, pb).float(),
            ref.masked_scaled_aggregate_update_ref(g, w, eta, pb).float(),
            rtol=2 ** -8, atol=1e-6)
        torch.cuda.synchronize()
        print(f"kernel phase N={n} P={p}: K1 and K2 agree "
              f"(max abs err K1 {errs['k1']:.3g}, K2 {errs['k2']:.3g})")
        if p != 316_554:
            continue
        geo = ops.geometry(p, g.element_size(), ops.sm_count(g.device.index),
                           g.data_ptr())
        ring = geo.stages * geo.rows * geo.pitch
        print(f"k1/k2 geometry at N={n} P={p} f32: {geo.blocks} blocks (one "
              f"a SM), span {geo.span} columns ({geo.span * 4} B of a row) "
              f"in chunks of {geo.chunk}, {geo.rows} rows a stage x "
              f"{geo.stages} stages of {geo.rows * geo.pitch} B: {ring} B "
              f"({ring / 1024:.1f} KB) in flight a SM")
        flush = flush_buffer(torch)
        # The first timing of the script: half a second of flush passes
        # first, so the card's clocks are up from the build's idle.
        for _ in range(5000):
            torch.sum(flush, dim=0)
        gt = g.t()
        calls = {
            "k1": (lambda: ops.masked_scaled_aggregate(g, w),
                   lambda: ref.masked_scaled_aggregate_ref(g, w),
                   lambda: torch.mv(gt, w)),
            "k2": (lambda: ops.masked_scaled_aggregate_update(g, w, eta, params),
                   lambda: ref.masked_scaled_aggregate_update_ref(g, w, eta, params),
                   lambda: torch.addmv(params, gt, w, alpha=-LR)),
        }
        # Bytes each function must move (inputs read once, output written
        # once) and the flops it does; f32 throughout.
        work = {"k1": (4 * (n * p + n + p), 2 * n * p),
                "k2": (4 * (n * p + n + 1 + 2 * p), 2 * n * p + 2 * p)}
        for name, fns in calls.items():
            t = [time_ms(torch, fn, flush) for fn in fns]
            nbytes, flops = work[name]
            bound_b = nbytes / peaks[0] * 1e3
            bound_f = flops / peaks[1] * 1e3
            timing[name] = {
                "ms": t[0][0], "plain_ms": t[1][0], "library_ms": t[2][0],
                "warm_ms": t[0][1], "plain_warm_ms": t[1][1],
                "library_warm_ms": t[2][1],
                "bound_ms": max(bound_b, bound_f),
                "bound_by": "bytes" if bound_b >= bound_f else "operations"}
            print(f"time {name} (L2 flushed | warm, ms): kernel "
                  f"{t[0][0]:.4f} | {t[0][1]:.4f}, plain {t[1][0]:.4f} | "
                  f"{t[1][1]:.4f}, library {t[2][0]:.4f} | {t[2][1]:.4f}, "
                  f"bound {timing[name]['bound_ms']:.4f} "
                  f"({nbytes / 1e6:.2f} MB; "
                  f"{nbytes / t[0][0] / 1e6:.0f} GB/s achieved flushed)")
    return errs, timing


#: The CNN's leaves, (dtype of form (b), columns), in tree order: its
#: four biases are bf16 in form (b), every leaf f32 in form (a).
CNN_LEAF_SHAPES = (("bf16", 32), ("f32", 2_400), ("bf16", 64),
                   ("f32", 51_200), ("bf16", 64), ("f32", 262_144),
                   ("bf16", 10), ("f32", 640))
#: K1's launches a step on the legacy carry: one a leaf of the CNN.
CNN_LEAVES = len(CNN_LEAF_SHAPES)


def legacy_k1_phase(torch, ops, ref, peaks, flat_ms):
    """K1 at each leaf shape of the legacy carry (40 rows; f32 leaves of
    10 to 262,144 columns, bf16 leaves of 10, 32 and 64): against its
    plain version, then timed flushed and warm beside the plain version,
    ``torch.mv`` and the bound (bytes over the card's memory rate); and a
    step's 8 launches summed for forms (a) and (b) beside the flat
    route's one K1 (``flat_ms``, the kernel phase's)."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    flush = flush_buffer(torch)
    shapes, err = {}, 0.0
    for kind, p in sorted({(k, p) for k, p in CNN_LEAF_SHAPES}
                          | {("f32", p) for _, p in CNN_LEAF_SHAPES}):
        dt = dtypes[kind]
        g = torch.randn(N_CLIENTS, p, device=DEVICE, generator=gen).to(dt)
        w = torch.rand(N_CLIENTS, device=DEVICE, generator=gen) * (
            2.0 / N_CLIENTS)
        got = ops.masked_scaled_aggregate(g, w)
        want = ref.masked_scaled_aggregate_ref(g, w)
        if dt == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            err = max(err, (got - want).abs().max().item())
        else:  # one bf16 rounding of the f32 sum
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -8, atol=1e-6)
        gt, wl = g.t(), w.to(dt)
        t = [time_ms(torch, fn, flush) for fn in (
            lambda: ops.masked_scaled_aggregate(g, w),
            lambda: ref.masked_scaled_aggregate_ref(g, w),
            lambda: torch.mv(gt, wl))]
        esize = g.element_size()
        nbytes = esize * N_CLIENTS * p + 4 * N_CLIENTS + esize * p
        bound_b = nbytes / peaks[0] * 1e3
        bound_f = 2 * N_CLIENTS * p / peaks[1] * 1e3
        shapes[f"{kind} {p}"] = {
            "ms": t[0][0], "warm_ms": t[0][1], "plain_ms": t[1][0],
            "library_ms": t[2][0], "bound_ms": max(bound_b, bound_f),
            "bound_by": "bytes" if bound_b >= bound_f else "operations"}
        print(f"time k1 leaf {kind} (40, {p}) (L2 flushed | warm, ms): "
              f"kernel {t[0][0]:.4f} | {t[0][1]:.4f}, plain {t[1][0]:.4f}, "
              f"torch.mv {t[2][0]:.4f}, bound "
              f"{max(bound_b, bound_f):.5f} ({nbytes / 1e3:.1f} KB)")
    del flush
    step = {"a": sum(shapes[f"f32 {p}"]["ms"] for _, p in CNN_LEAF_SHAPES),
            "b": sum(shapes[f"{k} {p}"]["ms"] for k, p in CNN_LEAF_SHAPES),
            "flat": flat_ms}
    bound = {"a": sum(shapes[f"f32 {p}"]["bound_ms"]
                      for _, p in CNN_LEAF_SHAPES),
             "b": sum(shapes[f"{k} {p}"]["bound_ms"]
                      for k, p in CNN_LEAF_SHAPES)}
    print(f"time k1 legacy step (8 launches, one a leaf, flushed): (a) all "
          f"f32 {step['a']:.4f} ms (bound {bound['a']:.4f}), (b) biases bf16 "
          f"{step['b']:.4f} ms (bound {bound['b']:.4f}); the flat route's one "
          f"K1 {flat_ms:.4f} ms")
    return {"shapes": shapes, "step_ms": step, "step_bound_ms": bound,
            "max_abs_err": err}


def fig1_setup(torch, rt, seed=0):
    """The Fig-1 data on the card, its client batcher and the CNN's
    initial parameters, all from ``seed``: (batcher, params0, test_x,
    test_y)."""
    ds = rt.data.make_confusable_image_classification(
        seed, N_TRAIN + N_TEST, image_shape=(32, 32, 3), similarity=0.9,
        noise=0.8)
    train_x, train_y = ds.images[:N_TRAIN], ds.labels[:N_TRAIN]
    test_x = torch.from_numpy(ds.images[N_TRAIN:]).to(DEVICE)
    test_y = torch.from_numpy(ds.labels[N_TRAIN:]).to(DEVICE)
    parts = rt.data.group_label_skew_partition(seed, train_y, N_CLIENTS,
                                               N_GROUPS, skew=1.0)
    batcher = rt.data.ClientBatcher(
        [{"x": train_x[ix], "y": train_y[ix]} for ix in parts], BATCH,
        seed=seed, device=DEVICE)
    params0 = rt.models.init_cnn(rt.random.PRNGKey(seed, device=DEVICE),
                                 image_hw=32)
    n_params = rt.core.ravel_spec(params0).total
    check(n_params == 316_554, f"CNN has {n_params} parameters")
    return batcher, params0, test_x, test_y


def bf16_biases(torch, params):
    """The CNN's params with its four biases (170 parameters) in bf16 and
    the rest f32: a tree of mixed dtypes, which the simulator runs on the
    legacy per-leaf carry under its default ``flat=None``."""
    return {k: {kk: v.to(torch.bfloat16) if kk == "b" else v
                for kk, v in d.items()} for k, d in params.items()}


def fig1_phase(torch, rt):
    """The Fig-1 loop at full width, through the kernels; then the legacy
    per-leaf carry. Returns the launch counts, the data the later phases
    take, and the legacy runs' counts and seconds."""
    seed = 0
    batcher, params0, test_x, test_y = fig1_setup(torch, rt, seed)
    arrivals = rt.core.make_arrivals("periodic", N_CLIENTS, STEPS)

    def evaluate(p):
        return {"accuracy": rt.models.cnn_accuracy(p, test_x, test_y),
                "loss": rt.models.cnn_loss(p, test_x, test_y)}

    def run(method, opt, use_kernel=True, active=None, steps=STEPS,
            flat=None, start=params0):
        sim = rt.core.ClientSimulator(
            grads_fn=rt.models.client_grads_fn(batcher), p=batcher.p,
            optimizer=opt(), scheduler=rt.core.make_scheduler(method, N_CLIENTS),
            energy=arrivals, use_kernel=use_kernel, flat=flat, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, hist, evals = sim.run(
            rt.random.PRNGKey(seed + 1, device=DEVICE), start, steps,
            active_mask=active, eval_fn=evaluate,
            eval_every=EVAL_EVERY if steps % EVAL_EVERY == 0 else steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        flat = rt.core.ravel_pytree(params)
        check(bool(torch.isfinite(flat).all()) and bool(hist.finite.all()),
              f"{method}: parameters not finite")
        check(hist.participation.shape == (steps, N_CLIENTS), "history shape")
        return flat, hist, evals, ms

    sgd = lambda: rt.optim.sgd(LR)
    # Momentum 0.9 at the same effective step size η/(1−β) as sgd.
    momentum = lambda: rt.optim.momentum(LR * 0.1, beta=0.9)
    run("alg1", sgd, steps=2)        # warm-up: cuDNN and vmap set-up
    run("alg1", momentum, steps=2)
    counts = rt.kernels.aggregate.ops.launch_counts
    rt.kernels.aggregate.ops.reset_launch_counts()
    active = torch.ones(N_CLIENTS, device=DEVICE)
    active[[3, 13, 22, 31]] = 0.0
    expected = {"masked_scaled_aggregate": 0, "masked_scaled_aggregate_update": 0}
    for label, method, opt, act, kernel in (
            ("alg1", "alg1", sgd, None, "masked_scaled_aggregate_update"),
            ("benchmark1", "benchmark1", sgd, None,
             "masked_scaled_aggregate_update"),
            ("benchmark2", "benchmark2", sgd, None,
             "masked_scaled_aggregate_update"),
            ("oracle", "oracle", sgd, None,
             "masked_scaled_aggregate_update"),
            ("alg1+momentum", "alg1", momentum, None,
             "masked_scaled_aggregate"),
            ("alg1 masked", "alg1", sgd, active,
             "masked_scaled_aggregate_update"),
            ("alg1+momentum masked", "alg1", momentum, active,
             "masked_scaled_aggregate")):
        flat, hist, evals, ms = run(method, opt, active=act)
        expected[kernel] += STEPS
        check(counts == expected,
              f"{label}: launch counts {counts}, expected {expected}")
        if act is not None:
            check(not bool(hist.participation[:, act == 0].any()),
                  f"{label}: a masked-out client took part")
        acc = evals["accuracy"].tolist()
        loss = evals["loss"].tolist()
        print(f"fig-1 {label:<22} test acc {acc[0]:.3f} -> {acc[-1]:.3f}  "
              f"test loss {loss[0]:.4f} -> {loss[-1]:.4f}  "
              f"mean participation {hist.participation.mean().item():.3f}  "
              f"{ms:.2f} ms/step")
    launches = dict(counts)

    # The legacy per-leaf carry at full width: (a) flat=False, all f32,
    # and (b) the biases in bf16 under the default flat=None. K1 runs
    # once a leaf (8 launches a step) and never fuses into K2.
    legacy_t0 = time.perf_counter()
    legacy = {}
    for label, opt, act, flat, start in (
            ("a alg1", sgd, None, False, params0),
            ("a alg1+momentum", momentum, None, False, params0),
            ("a alg1 masked", sgd, active, False, params0),
            ("b alg1 bf16 biases", sgd, None, None,
             bf16_biases(torch, params0))):
        rt.kernels.aggregate.ops.reset_launch_counts()
        _, hist, evals, ms = run("alg1", opt, active=act, flat=flat,
                                 start=start)
        legacy[label] = dict(counts)
        want = {"masked_scaled_aggregate": CNN_LEAVES * STEPS,
                "masked_scaled_aggregate_update": 0}
        check(legacy[label] == want,
              f"legacy {label}: launch counts {legacy[label]}, expected {want}")
        if act is not None:
            check(not bool(hist.participation[:, act == 0].any()),
                  f"legacy {label}: a masked-out client took part")
        acc = evals["accuracy"].tolist()
        print(f"fig-1 legacy {label:<20} test acc {acc[0]:.3f} -> "
              f"{acc[-1]:.3f}  mean participation "
              f"{hist.participation.mean().item():.3f}  {ms:.2f} ms/step; "
              f"K1 {legacy[label]['masked_scaled_aggregate']} launches "
              f"({CNN_LEAVES} a step), K2 "
              f"{legacy[label]['masked_scaled_aggregate_update']}")
    legacy_seconds = time.perf_counter() - legacy_t0

    # Reference: a short alg1/sgd run through the kernels and through the
    # plain torch matvec, with deterministic cuDNN so the two differ only
    # in the order of the client sum (over 40 steps at this step size
    # that difference grows chaotically, so the comparison is short).
    torch.backends.cudnn.deterministic = True
    flat_k, hist_k, _, _ = run("alg1", sgd, steps=REF_STEPS)
    flat_k2, _, _, _ = run("alg1", sgd, steps=REF_STEPS)
    flat_ref, hist_ref, _, _ = run("alg1", sgd, use_kernel=False,
                                   steps=REF_STEPS)
    legacy_t0 = time.perf_counter()
    flat_l, hist_l, _, _ = run("alg1", sgd, steps=REF_STEPS, flat=False)
    legacy_seconds += time.perf_counter() - legacy_t0
    torch.backends.cudnn.deterministic = False
    check(torch.equal(flat_k, flat_k2),
          "two kernel runs from one seed differ: the step is not deterministic")
    check(torch.equal(hist_k.participation, hist_ref.participation),
          "participation differs between the kernel and the matvec path")
    torch.testing.assert_close(flat_k, flat_ref, rtol=1e-4, atol=1e-5)
    print(f"fig-1 reference: {REF_STEPS} alg1 steps through the kernels and "
          f"through the torch matvec agree, max abs param diff "
          f"{(flat_k - flat_ref).abs().max().item():.3g}")
    # The legacy carry (K1 once a leaf, then sgd's step) against the flat
    # route (K2) from the same seed: K2 is bitwise the unfused K1 path,
    # and K1 sums each column the same way whatever its leaf.
    check(torch.equal(hist_l.participation, hist_k.participation),
          "participation differs between the legacy carry and the flat route")
    torch.testing.assert_close(flat_l, flat_k, rtol=1e-4, atol=1e-5)
    print(f"fig-1 legacy reference: {REF_STEPS} alg1 steps on the legacy "
          f"carry (flat=False, K1 once a leaf) and on the flat route (K2) "
          f"agree, max abs param diff "
          f"{(flat_l - flat_k).abs().max().item():.3g}, bitwise "
          f"{torch.equal(flat_l, flat_k)}")

    # Where a step's time goes: torch.profiler over PROFILE_STEPS alg1/sgd
    # steps (no evaluation), kernels by device time, and the device's
    # busy share of the wall time.
    sim = rt.core.ClientSimulator(
        grads_fn=rt.models.client_grads_fn(batcher), p=batcher.p,
        optimizer=sgd(), scheduler=rt.core.make_scheduler("alg1", N_CLIENTS),
        energy=arrivals, use_kernel=True, device=DEVICE)
    key = rt.random.PRNGKey(seed + 1, device=DEVICE)
    sim.run(key, params0, 2)
    profile(torch, f"fig-1 ({PROFILE_STEPS} alg1/sgd steps)", "step",
            lambda: sim.run(key, params0, PROFILE_STEPS), PROFILE_STEPS,
            "aggregate")
    data = {"batcher": batcher, "params0": params0,
            "accuracy": lambda p: rt.models.cnn_accuracy(p, test_x, test_y)}
    return launches, data, {"launches": legacy, "seconds": legacy_seconds}


def engine_phase(torch, rt, data):
    """The experiments engine at Fig-1 width, through the kernels: the
    ``fig1`` study against a standalone run, ``population_scaling`` with
    its padding, one momentum cell, and a legacy study (the bf16-bias CNN)
    grouped and resumed. Returns the launch counts of each study's run
    and the legacy study's seconds."""
    from repro_torch._tree import tree_leaves, tree_map

    rx = rt.experiments
    ops = rt.kernels.aggregate.ops
    batcher, params0, accuracy = data["batcher"], data["params0"], data["accuracy"]
    kw = dict(grads_fn=rt.models.client_grads_fn(batcher), p=batcher.p,
              optimizer=rt.optim.sgd(LR), use_kernel=True, device=DEVICE)
    config = rx.ExecutionConfig(eval_fn=accuracy, eval_every=EVAL_EVERY)
    flat = rt.core.ravel_pytree
    counts = {}

    def timed(label, fn, expect):
        """Run ``fn`` with the counts set to 0 before it; check and keep
        the counts read after it; return its result and wall seconds."""
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[label] = dict(ops.launch_counts)
        check(counts[label] == expect,
              f"engine {label}: launch counts {counts[label]}, expected {expect}")
        return out, seconds

    def finite(label, result):
        for name, cell in result.items():
            check(bool(torch.isfinite(flat(cell.params)).all())
                  and bool(cell.history.finite.all())
                  and cell.diverged.tolist() == [-1] * len(cell.diverged),
                  f"engine {label}: cell {name} not finite")

    # Deterministic cuDNN, so that a cell of the study and a standalone
    # run of it may be held bit for bit.
    torch.backends.cudnn.deterministic = True
    study = rx.get_study("fig1", n_clients=N_CLIENTS, num_steps=STEPS,
                         taus_profile=[1, 5, 10, 20], seeds=list(ENGINE_SEEDS))
    n_runs = len(study.resolve()) * len(ENGINE_SEEDS)
    result, wall = timed("fig1", lambda: study.run(
        params0=params0, config=config, **kw),
        {"masked_scaled_aggregate": 0,
         "masked_scaled_aggregate_update": n_runs * STEPS})
    finite("fig1", result)
    sim = study.simulator(**kw)
    (alg1,) = [sc for sc in study.resolve() if sc.scheduler == "alg1"]
    scheduler, energy = alg1.build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist, evals = sim.run(
        rt.random.PRNGKey(ENGINE_SEEDS[0], device=DEVICE), params0, STEPS,
        scheduler=scheduler, energy=energy, eval_fn=accuracy,
        eval_every=EVAL_EVERY)
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t0) / STEPS * 1e3
    cell = result[alg1.name]
    check(torch.equal(cell.history.participation[0], hist.participation)
          and torch.equal(flat(tree_map(lambda x: x[0], cell.params)),
                          flat(params))
          and torch.equal(cell.evals[0], evals),
          "engine fig1: the alg1 cell's seed differs from a standalone run")
    accs = " ".join(f"{name} {cell.evals[:, -1].mean().item():.3f}"
                    for name, cell in result.items())
    print(f"engine fig1 study: {len(result)} cells x {len(ENGINE_SEEDS)} "
          f"seeds x {STEPS} steps in {wall:.2f} s, "
          f"{wall / (n_runs * STEPS) * 1e3:.2f} ms/step with evaluation "
          f"(standalone alg1 run {alone_ms:.2f} ms/step); "
          f"{counts['fig1']['masked_scaled_aggregate_update']} K2 launches; "
          f"the alg1 cell's seed {ENGINE_SEEDS[0]} equals the standalone run "
          f"bit for bit (participation, {flat(params).numel():,} params, "
          f"evals); final test acc: {accs}")

    pop = rx.get_study("population_scaling", n_clients=POPULATIONS,
                       num_steps=STEPS, seeds=[ENGINE_SEEDS[0]])
    result, wall = timed("population_scaling", lambda: pop.run(
        params0=params0, **kw),
        {"masked_scaled_aggregate": 0,
         "masked_scaled_aggregate_update": len(POPULATIONS) * STEPS})
    finite("population_scaling", result)
    for n, cell in zip(POPULATIONS, result.values()):
        check(tuple(cell.history.participation.shape) == (1, STEPS, n),
              f"engine population_scaling n={n}: participation shape "
              f"{tuple(cell.history.participation.shape)}")
    # The smallest cell again, uncropped: its absent rows never took part.
    groups = rx.resolve_structure_groups(pop.resolve(), sim=sim)[2]
    grp = groups[0]
    check(len(groups) == 1 and grp.ragged, "population_scaling: one ragged group")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = sim.run(rt.random.PRNGKey(ENGINE_SEEDS[0], device=DEVICE),
                      params0, STEPS, scheduler=grp.scheduler[0],
                      energy=grp.energy[0], p=grp.p[0], active_mask=grp.active[0])
    torch.cuda.synchronize()
    padded_ms = (time.perf_counter() - t0) / STEPS * 1e3
    n0 = POPULATIONS[0]
    first = next(iter(result.values()))
    check(not bool(hist.participation[:, n0:].any()),
          f"population_scaling n={n0}: an absent client took part")
    check(torch.equal(hist.participation[:, :n0], first.history.participation[0]),
          f"population_scaling n={n0}: the engine's cell differs from a "
          f"standalone padded run")
    rates = " ".join(f"n={n} {c.history.participation.mean().item():.3f}"
                     for n, c in zip(POPULATIONS, result.values()))
    print(f"engine population_scaling study: n = {POPULATIONS} at N_cap "
          f"{N_CLIENTS}, 1 seed x {STEPS} steps in {wall:.2f} s, "
          f"{wall / (len(POPULATIONS) * STEPS) * 1e3:.2f} ms/step (standalone "
          f"padded n={n0} run {padded_ms:.2f} ms/step); "
          f"{counts['population_scaling']['masked_scaled_aggregate_update']} "
          f"K2 launches; participation cropped to (steps, n); the n={n0} "
          f"cell uncropped: rows {n0}..{N_CLIENTS - 1} never took part, rows "
          f"0..{n0 - 1} equal the engine's; mean participation {rates}")

    one = rx.Study("alg1_momentum", num_steps=STEPS, axes={
        "scheduler": "alg1", "arrivals": "periodic", "n_clients": N_CLIENTS,
        "taus_profile": [1, 5, 10, 20], "seeds": [ENGINE_SEEDS[0]]})
    result, wall = timed("momentum", lambda: one.run(
        params0=params0, **dict(kw, optimizer=rt.optim.momentum(LR * 0.1, beta=0.9))),
        {"masked_scaled_aggregate": STEPS, "masked_scaled_aggregate_update": 0})
    finite("momentum", result)
    print(f"engine momentum cell: 1 cell x 1 seed x {STEPS} steps in "
          f"{wall:.2f} s, {wall / STEPS * 1e3:.2f} ms/step; "
          f"{counts['momentum']['masked_scaled_aggregate']} K1 launches")

    # A legacy study: the CNN with its biases in bf16 (the simulator's
    # legacy per-leaf carry), alg1 at n = 30 and 40 (one ragged group) x
    # 2 seeds, grouped; then checkpointed, cut after its first checkpoint
    # and resumed in this process, bitwise the grouped run.
    legacy_t0 = time.perf_counter()
    mixed0 = bf16_biases(torch, params0)
    legacy = rx.Study("legacy_bf16_biases", num_steps=STEPS, axes={
        "scheduler": "alg1", "arrivals": "periodic",
        "n_clients": [30, N_CLIENTS], "taus_profile": [1, 5, 10, 20],
        "seeds": list(ENGINE_SEEDS)})
    n_runs = 2 * len(ENGINE_SEEDS)
    check(sim.flat_spec(mixed0) is None, "the bf16-bias CNN is not legacy")
    grouped, wall = timed("legacy", lambda: legacy.run(params0=mixed0, **kw),
                          {"masked_scaled_aggregate":
                           n_runs * CNN_LEAVES * STEPS,
                           "masked_scaled_aggregate_update": 0})
    finite("legacy", grouped)
    manager = rt.checkpoint.CheckpointManager
    real_save = manager.save

    def save_then_cut(self, step, state):
        real_save(self, step, state)
        raise RuntimeError(f"cut after the checkpoint of step {step}")

    with tempfile.TemporaryDirectory() as ckdir:
        config = rx.ExecutionConfig(checkpoint_dir=ckdir,
                                    checkpoint_every=STEPS // 2)
        manager.save = save_then_cut
        try:
            legacy.run(params0=mixed0, config=config, **kw)
            cut = None
        except RuntimeError as e:
            cut = str(e)
        finally:
            manager.save = real_save
        check(cut is not None, "the checkpointed legacy study was not cut")
        resumed, rwall = timed(
            "legacy resumed", lambda: legacy.run(params0=mixed0,
                                                 config=config, **kw),
            {"masked_scaled_aggregate": n_runs * CNN_LEAVES * (STEPS // 2),
             "masked_scaled_aggregate_update": 0})
    for name, cell in grouped.items():
        got, want = (tree_leaves(tuple(c)) for c in (resumed[name], cell))
        check(len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)),
            f"engine legacy: the resumed cell {name} differs from the grouped "
            f"run")
    legacy_seconds = time.perf_counter() - legacy_t0
    torch.backends.cudnn.deterministic = False
    print(f"engine legacy study (CNN, biases bf16, legacy per-leaf carry): "
          f"n = 30, {N_CLIENTS} x {len(ENGINE_SEEDS)} seeds x {STEPS} steps "
          f"grouped in {wall:.2f} s, {wall / (n_runs * STEPS) * 1e3:.2f} "
          f"ms/step, {counts['legacy']['masked_scaled_aggregate']} K1 launches "
          f"({CNN_LEAVES} a step), 0 K2; checkpointed every {STEPS // 2}, "
          f"cut ({cut}) and resumed: {rwall:.2f} s, "
          f"{counts['legacy resumed']['masked_scaled_aggregate']} K1 launches "
          f"(the missing steps), every cell bitwise the grouped run")
    return counts, legacy_seconds


def fault_cells(rt, names=None):
    """The faults phase's cells (alg1 on the paper's periodic arrivals at
    the Fig-1 width), those in ``names`` when given, in FAULT_CELLS
    order."""
    return [rt.experiments.Scenario(
        name=name, scheduler="alg1", arrivals="periodic", n_clients=N_CLIENTS,
        horizon=STEPS + 1, faults=kind, fault_kwargs=dict(kw))
        for name, kind, kw in FAULT_CELLS if names is None or name in names]


def fault_sim(rt, batcher, optimizer):
    return rt.core.ClientSimulator(
        grads_fn=rt.models.client_grads_fn(batcher), p=batcher.p,
        optimizer=optimizer, use_kernel=True, device=DEVICE)


def same_cell(torch, a, b):
    """Two CellResults bit for bit: params, history and ``diverged``."""
    from repro_torch._tree import tree_leaves

    la, lb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def resume_child(ckdir):
    """The faults phase's checkpointed study, run into ``ckdir`` by a
    child process that SIGKILLs itself from ``progress`` right after its
    second checkpoint. Returns only if it was not killed."""
    import torch

    rt = load_port()
    ckdir = child_directory(ckdir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batcher, params0, _, _ = fig1_setup(torch, rt)
    saved = []

    def progress(gid, step, num_steps):
        if step > 0:
            saved.append(step)
        if len(saved) == 2:
            os.kill(os.getpid(), signal.SIGKILL)

    rt.experiments.execute_cells_resumable(
        fault_cells(rt, RESUME_CELLS),
        sim=fault_sim(rt, batcher, rt.optim.sgd(LR)), params0=params0,
        num_steps=STEPS, seeds=[ENGINE_SEEDS[0]], checkpoint_dir=ckdir,
        checkpoint_every=CHECKPOINT_EVERY, progress=progress)
    print("resume child: the study ended without being killed",
          file=sys.stderr)
    return 1


def faults_phase(torch, rt, data, card):
    """Fault injection and checkpointed, resumable studies at the Fig-1
    width through K2 and K1. Returns the launch counts of each counted
    run."""
    import numpy as np

    from repro_torch._tree import tree_map
    from repro_torch.checkpoint import latest_step, save_pytree

    phase_t0 = time.perf_counter()
    rx, ops = rt.experiments, rt.kernels.aggregate.ops
    k1, k2 = "masked_scaled_aggregate", "masked_scaled_aggregate_update"
    batcher, params0 = data["batcher"], data["params0"]
    flat = rt.core.ravel_pytree
    sgd_sim = fault_sim(rt, batcher, rt.optim.sgd(LR))
    run = dict(params0=params0, num_steps=STEPS, seeds=[ENGINE_SEEDS[0]])
    counts = {}

    def counted(label, fn, n_k1, n_k2):
        """Run ``fn`` with the counts set to 0 before it; check and keep
        the counts read after it; return its result and wall seconds."""
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[label] = dict(ops.launch_counts)
        check(counts[label] == {k1: n_k1, k2: n_k2},
              f"faults {label}: launch counts {counts[label]}, expected "
              f"{k1} {n_k1}, {k2} {n_k2}")
        return out, seconds

    torch.backends.cudnn.deterministic = True
    cells = fault_cells(rt)
    res, wall = counted("cells", lambda: rx.execute_cells(
        cells, sim=sgd_sim, **run), 0, len(cells) * STEPS)
    (mom,) = fault_cells(rt, ["drop"])
    mom.name = "drop_momentum"
    mres, mwall = counted("momentum", lambda: rx.execute_cells(
        [mom], sim=fault_sim(rt, batcher, rt.optim.momentum(LR * 0.1,
                                                            beta=0.9)),
        **run), STEPS, 0)

    clean = res["clean"]
    p0 = flat(params0)
    first = lambda cell: flat(tree_map(lambda x: x[0], cell.params))  # noqa: E731
    wc = clean.history.weight_sum[0]
    for name, cell in list(res.items()) + list(mres.items()):
        finite = (bool(torch.isfinite(first(cell)).all())
                  and bool(cell.history.finite.all())
                  and cell.diverged.tolist() == [-1])
        check(finite, f"faults {name}: not finite")
        check(torch.equal(cell.history.participation,
                          clean.history.participation),
              f"faults {name}: the fault changed the schedule")
        if name not in ("clean", "drop_rate0", "drop_corrupt_nan"):
            ws = cell.history.weight_sum[0]
            check(not torch.equal(first(cell), p0)
                  and bool((ws <= wc).all()) and bool((ws < wc).any()),
                  f"faults {name}: did not move, or delivered more than "
                  f"the clean cell")
    check(same_cell(torch, res["drop_rate0"], clean),
          "faults: drop at rate 0 differs from the clean cell")
    leak = res["drop_corrupt_nan"]
    check(torch.equal(first(leak), p0)
          and bool((leak.history.weight_sum == 0).all()),
          "faults drop_corrupt_nan: a dropped NaN row reached the params")
    ws = res["stale"].history.weight_sum[0]
    delay = {n: kw for n, _, kw in FAULT_CELLS}["stale"]["delay"]
    check(bool((ws[:delay] < wc[:delay]).any())
          and torch.equal(ws[delay:], wc[delay:]),
          "faults stale: hit rows not dropped before the delay, or "
          "dropped after it")
    print(f"faults cells: {len(cells)} cells x 1 seed x {STEPS} steps "
          f"through K2 in {wall:.2f} s ({counts['cells'][k2]} K2 launches), "
          f"the drop momentum cell through K1 in {mwall:.2f} s "
          f"({counts['momentum'][k1]} K1 launches); rate 0 equals the clean "
          f"cell bit for bit; drop_corrupt NaN: params unmoved, finite, "
          f"weight_sum 0 on all {STEPS} steps; stale drops hit rows for "
          f"t < {delay} and delivers all after; final test acc "
          + " ".join(f"{n} {data['accuracy'](tree_map(lambda x: x[0], c.params)).item():.3f}"
                     for n, c in list(res.items()) + list(mres.items()))
          + f" [{card}]")

    # The cells in turns, so that a drift of the host's speed over the
    # phase touches every cell alike.
    timed = {name: [] for name, _, _ in FAULT_CELLS}
    for _ in range(TIMING_REPEATS):
        for name in timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rx.execute_cells(fault_cells(rt, [name]), sim=sgd_sim, **run)
            torch.cuda.synchronize()
            timed[name].append((time.perf_counter() - t0) / STEPS * 1e3)
    print(f"faults ms/step (host clock, synchronised, median of "
          f"{TIMING_REPEATS} runs of {STEPS} steps taken in turns, runs in "
          f"brackets): " + "; ".join(
              f"{n} {sorted(t)[len(t) // 2]:.2f} "
              f"[{' '.join(f'{x:.2f}' for x in t)}]"
              for n, t in timed.items()) + f" [{card}]")
    # The resume check's child loads while the profiles and the
    # checkpointed study run.
    resume_proc = spawn_child("--resume-child")
    # Where a fault's time goes: the device ops a step and the device's
    # busy share, clean against each family.
    key = rt.random.PRNGKey(ENGINE_SEEDS[0], device=DEVICE)
    for name, _, _ in FAULT_CELLS:
        (sc,) = fault_cells(rt, [name])
        scheduler, energy = sc.build()
        faults = sc.build_faults()
        profile(torch, f"faults {name} ({FAULT_PROFILE_STEPS} steps; {card})",
                "step", lambda: sgd_sim.run(
                    key, params0, FAULT_PROFILE_STEPS, scheduler=scheduler,
                    energy=energy, faults=faults), FAULT_PROFILE_STEPS, top=0)

    rcells = fault_cells(rt, RESUME_CELLS)
    resumable = dict(run, sim=sgd_sim, checkpoint_every=CHECKPOINT_EVERY)
    n_resume = len(rcells) * STEPS
    with tempfile.TemporaryDirectory() as tmp:
        whole_dir = os.path.join(tmp, "whole")
        whole, wwall = counted("resumable", lambda: rx.execute_cells_resumable(
            rcells, checkpoint_dir=whole_dir, **resumable), 0, n_resume)
        for name in RESUME_CELLS:
            check(same_cell(torch, whole[name], res[name]),
                  f"faults resume: the checkpointed {name} cell differs from "
                  f"execute_cells")
        manifest = json.load(open(os.path.join(whole_dir, "manifest.json")))
        sizes = []
        for gid, grp in manifest["groups"].items():
            step = latest_step(os.path.join(whole_dir, gid))
            path = os.path.join(whole_dir, gid, f"step_{step}.npz")
            with np.load(path) as npz:
                tree = {k: torch.from_numpy(npz[k]).to(DEVICE)
                        for k in npz.files}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_pytree(os.path.join(tmp, "rewrite.npz"), tree)
            ms = (time.perf_counter() - t0) * 1e3
            sizes.append(f"{gid} ({'+'.join(grp['members'])}) "
                         f"{os.path.getsize(path) / 1e6:.1f} MB, write "
                         f"{ms:.1f} ms")
        print(f"faults checkpoint: {len(rcells)} cells x {STEPS} steps in "
              f"chunks of {CHECKPOINT_EVERY}, {wwall:.2f} s, bitwise "
              f"execute_cells; a group's newest checkpoint and one write of "
              f"it from the card (device to host, npz, fsync, rename): "
              + "; ".join(sizes) + f" [{card}]")

        killed_dir = os.path.join(tmp, "killed")
        t0 = time.perf_counter()
        child = run_child(resume_proc, killed_dir)
        child_s = time.perf_counter() - t0
        check(child.returncode == -signal.SIGKILL,
              f"faults resume: the child exited {child.returncode}, not by "
              f"SIGKILL:\n{child.stdout[-3000:]}{child.stderr[-3000:]}")
        done = {gid: g["step"] for gid, g in json.load(open(os.path.join(
            killed_dir, "manifest.json")))["groups"].items()}
        check(list(done.values()) == [2 * CHECKPOINT_EVERY] + [0] * (
            len(done) - 1), f"faults resume: the killed run's manifest {done}")
        resumed, rwall = counted("resume", lambda: rx.execute_cells_resumable(
            rcells, checkpoint_dir=killed_dir, **resumable), 0,
            n_resume - 2 * CHECKPOINT_EVERY)
        replay, pwall = counted("replay", lambda: rx.execute_cells_resumable(
            rcells, checkpoint_dir=killed_dir, **resumable), 0, 0)
        for name in RESUME_CELLS:
            check(same_cell(torch, resumed[name], whole[name])
                  and same_cell(torch, replay[name], whole[name]),
                  f"faults resume: the resumed {name} cell differs from the "
                  f"uninterrupted run")
    torch.backends.cudnn.deterministic = False
    print(f"faults resume: a child process ran the study and was killed "
          f"by SIGKILL after its 2nd checkpoint ({child_s:.1f} s, manifest "
          f"steps {done}); resumed in {rwall:.2f} s wall "
          f"({counts['resume'][k2]} K2 launches), bitwise the uninterrupted "
          f"run; the finished directory replayed in {pwall:.2f} s with 0 "
          f"launches, bitwise; the phase took "
          f"{time.perf_counter() - phase_t0:.1f} s [{card}]")
    return counts


def serve_manifest(rt, name, n, steps=None):
    """One request of the serve phase: alg1 on the Fig-1 arrivals (the
    engine phase's ``fig1`` study's taus) at population ``n``, seed 1,
    ``steps`` steps (default SERVE_STEPS), as JSON."""
    return rt.experiments.Study(name, num_steps=steps or SERVE_STEPS, axes={
        "scheduler": "alg1", "arrivals": "periodic", "n_clients": n,
        "taus_profile": [1, 5, 10, 20], "seeds": [ENGINE_SEEDS[0]]}).to_json()


def serve_service(rt, data, optimizer=None, **kw):
    """A StudyService on the card over the Fig-1 CNN through the
    aggregate kernels."""
    batcher = data["batcher"]
    return rt.serve.StudyService(
        grads_fn=data["grads_fn"], p=batcher.p,
        optimizer=optimizer or rt.optim.sgd(LR), use_kernel=True,
        params0=data["params0"], device=DEVICE, **kw)


def recover_manifests(rt):
    return [serve_manifest(rt, f"recover{i}", n, STEPS)
            for i, n in enumerate(RECOVER_POPULATIONS)]


def serve_child(root):
    """The serve phase's checkpointed dispatch, served into ``root`` by
    a child process that SIGKILLs itself right after its second
    checkpoint is written. Returns only if it was not killed."""
    import torch

    rt = load_port()
    root = child_directory(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batcher, params0, _, _ = fig1_setup(torch, rt)
    data = {"batcher": batcher, "params0": params0,
            "grads_fn": rt.models.client_grads_fn(batcher)}
    manager = rt.checkpoint.CheckpointManager
    real_save, saved = manager.save, []

    def save_then_die(self, step, state):
        out = real_save(self, step, state)
        saved.append(step)
        if len(saved) == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        return out

    manager.save = save_then_die
    svc = serve_service(rt, data, checkpoint_root=root)
    config = rt.experiments.ExecutionConfig(checkpoint_every=CHECKPOINT_EVERY)
    for m in recover_manifests(rt):
        svc.submit(m, config)
    responses = svc.flush()
    print(f"serve child: the dispatch ended without being killed: "
          f"{[r.error for r in responses]}", file=sys.stderr)
    return 1


def serve_phase(torch, rt, data, card):
    """The Study service at the Fig-1 width on the card, through K2 and
    K1: a cold and a warm round of 8 JSON manifests, concurrent
    submitters, a service killed by SIGKILL and recovered, and the serve
    launcher's demo. Returns the launch counts of each counted run."""
    import threading

    from repro_torch.launch import serve as serve_launcher

    phase_t0 = time.perf_counter()
    rx, ops = rt.experiments, rt.kernels.aggregate.ops
    k1, k2 = "masked_scaled_aggregate", "masked_scaled_aggregate_update"
    data = dict(data, grads_fn=rt.models.client_grads_fn(data["batcher"]))
    counts = {}

    def counted(label, fn, n_k1, n_k2):
        """Run ``fn`` with the counts set to 0 before it; check and keep
        the counts read after it; return its result and wall seconds."""
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[label] = dict(ops.launch_counts)
        check(counts[label] == {k1: n_k1, k2: n_k2},
              f"serve {label}: launch counts {counts[label]}, expected "
              f"{k1} {n_k1}, {k2} {n_k2}")
        return out, seconds

    def served(label, responses, n):
        errors = [f"{r.request_id}: {r.error}" for r in responses
                  if r.error is not None]
        check(not errors, f"serve {label}: dispatch errors {errors}")
        check(len(responses) == n, f"serve {label}: {len(responses)} "
              f"responses, expected {n}")
        return responses

    def flush_all(svc, manifests, config=None):
        for m in manifests:
            svc.submit(m, config)
        return svc.flush()

    def same_grid(a, b):
        return list(a.cells) == list(b.cells) and all(
            same_cell(torch, a.cells[c], b.cells[c]) for c in a.cells)

    def latency(responses):
        """p50 and p99 of the responses' latency (nearest rank)."""
        lat = sorted(r.timings["latency_us"] / 1e3 for r in responses)
        p50, p99 = (lat[min(len(lat) - 1, int(q * len(lat)))]
                    for q in (0.5, 0.99))
        return f"p50 {p50:.1f} ms, p99 {p99:.1f} ms"

    torch.backends.cudnn.deterministic = True
    manifests = [serve_manifest(rt, f"serve{i}", n)
                 for i, n in enumerate(SERVE_POPULATIONS)]
    n_req, n_k2 = len(manifests), len(manifests) * SERVE_STEPS
    svc = serve_service(rt, data)
    cold, cold_s = counted("cold", lambda: flush_all(svc, manifests), 0, n_k2)
    served("cold", cold, n_req)
    stats = svc.stats()
    check(cold[0].batch["dispatches"] == 1 and stats["compiles"] == 1
          and cold[0].batch["new_compiles"] == 1,
          f"serve cold: {cold[0].batch}, compiles {stats['compiles']}: "
          f"expected one dispatch and one compile")
    for n in (SERVE_POPULATIONS[0], N_CLIENTS):
        i = SERVE_POPULATIONS.index(n)
        alone = rx.Study.from_json(manifests[i]).run(
            params0=data["params0"], grads_fn=data["grads_fn"],
            p=data["batcher"].p, optimizer=rt.optim.sgd(LR),
            use_kernel=True, device=DEVICE)
        check(same_grid(cold[i].result, alone),
              f"serve cold: the n={n} response differs from its solo "
              f"Study.run")
    print(f"serve cold round: {n_req} JSON manifests (alg1, Fig-1 arrivals, "
          f"n = {list(SERVE_POPULATIONS)} at N_cap {N_CLIENTS}, seed "
          f"{ENGINE_SEEDS[0]}, {SERVE_STEPS} steps) in {cold_s:.2f} s: "
          f"{cold[0].batch['dispatches']} dispatch, compiles "
          f"{stats['compiles']}, {counts['cold'][k2]} K2 + "
          f"{counts['cold'][k1]} K1 launches; latency {latency(cold)}; "
          f"{n_req / cold_s:.2f} scenarios/s; the n={SERVE_POPULATIONS[0]} "
          f"and n={N_CLIENTS} responses equal their solo Study.run bit for "
          f"bit [{card}]")

    warm, warm_s = counted("warm", lambda: flush_all(svc, manifests), 0, n_k2)
    served("warm", warm, n_req)
    check(warm[0].batch["new_compiles"] == 0
          and warm[0].batch["cache_hits"] == 1,
          f"serve warm: {warm[0].batch}: expected a cache hit, no compile")
    check(all(same_grid(a.result, b.result) for a, b in zip(cold, warm)),
          "serve warm: a response differs from the cold round's")
    print(f"serve warm round: the same {n_req} manifests in {warm_s:.2f} s, "
          f"new compiles {warm[0].batch['new_compiles']}, cache hits "
          f"{warm[0].batch['cache_hits']}, {counts['warm'][k2]} K2 launches; "
          f"latency {latency(warm)}; {n_req / warm_s:.2f} scenarios/s; bit "
          f"for bit the cold round [{card}]")

    # The recover check's child loads while the rounds below run.
    serve_proc = spawn_child("--serve-child")
    # Concurrent submitters through the batching thread, and a competing
    # flusher: dispatches may overlap on the card's default stream.
    pops = [SERVE_POPULATIONS[2 * i] for i in range(SERVE_THREADS)]
    by_n = {n: cold[SERVE_POPULATIONS.index(n)].result for n in pops}
    results, failures = {}, []

    def submitter(i, n):
        try:
            rid = svc.submit(serve_manifest(rt, f"thread{i}", n))
            results[i] = svc.wait(rid, timeout=600)
        except Exception as e:  # noqa: BLE001 — reported by the check
            failures.append(f"thread {i}: {type(e).__name__}: {e}")

    def concurrent():
        threads = [threading.Thread(target=submitter, args=(i, n))
                   for i, n in enumerate(pops)]
        flusher = threading.Thread(target=lambda: [
            svc.flush() or time.sleep(0.005) for _ in range(100)])
        with rt.serve.BackgroundServer(svc):
            for t in threads + [flusher]:
                t.start()
            for t in threads + [flusher]:
                t.join(timeout=600)
        return [results[i] for i in sorted(results)]

    conc, conc_s = counted("concurrent", concurrent, 0,
                           SERVE_THREADS * SERVE_STEPS)
    check(not failures, f"serve concurrent: {failures}")
    served("concurrent", conc, SERVE_THREADS)
    check(all(same_grid(r.result, by_n[n]) for r, n in zip(conc, pops)),
          "serve concurrent: a response differs from the cold round's")
    print(f"serve concurrent: {SERVE_THREADS} threads submitting n = {pops} "
          f"through BackgroundServer with a competing flusher, served in "
          f"{conc_s:.2f} s, {counts['concurrent'][k2]} K2 launches counted "
          f"exactly, every response bit for bit the cold round's [{card}]")

    msvc = serve_service(rt, data, rt.optim.momentum(LR * 0.1, beta=0.9))
    mom, mom_s = counted("momentum", lambda: flush_all(
        msvc, [serve_manifest(rt, "momentum", N_CLIENTS)]), SERVE_STEPS, 0)
    served("momentum", mom, 1)
    print(f"serve momentum: 1 manifest through K1 in {mom_s:.2f} s, "
          f"{counts['momentum'][k1]} K1 launches [{card}]")

    recover = recover_manifests(rt)
    config = rx.ExecutionConfig(checkpoint_every=CHECKPOINT_EVERY)
    n_rec = len(recover) * STEPS
    with tempfile.TemporaryDirectory() as tmp:
        whole, whole_s = counted("checkpointed", lambda: flush_all(
            serve_service(rt, data, checkpoint_root=os.path.join(
                tmp, "whole")), recover, config), 0, n_rec)
        served("checkpointed", whole, len(recover))
        root = os.path.join(tmp, "killed")
        t0 = time.perf_counter()
        child = run_child(serve_proc, root)
        child_s = time.perf_counter() - t0
        check(child.returncode == -signal.SIGKILL,
              f"serve recover: the child exited {child.returncode}, not by "
              f"SIGKILL:\n{child.stdout[-3000:]}{child.stderr[-3000:]}")
        check(os.listdir(root) == [os.path.basename(
            whole[0].batch["checkpoint_dir"])],
              f"serve recover: the killed service's root holds "
              f"{os.listdir(root)}, not the dispatch's directory")
        fresh = serve_service(rt, data, checkpoint_root=root)
        rids, rec_s = counted("recover", fresh.recover, 0,
                              n_rec - 2 * CHECKPOINT_EVERY * len(recover))
        rec = served("recover", [fresh.result(r) for r in rids],
                     len(recover))
        resumed = rec[0].batch["resumed_steps"]
        check(resumed == 2 * CHECKPOINT_EVERY,
              f"serve recover: resumed_steps {resumed}, expected "
              f"{2 * CHECKPOINT_EVERY}")
        by_study = {r.study: r.result for r in whole}
        check(all(same_grid(r.result, by_study[r.study]) for r in rec),
              "serve recover: a recovered response differs from the "
              "uninterrupted checkpointed dispatch")
    torch.backends.cudnn.deterministic = False
    print(f"serve recover: a child service ran {len(recover)} checkpointed "
          f"manifests (n = {list(RECOVER_POPULATIONS)}, {STEPS} steps, "
          f"checkpoints every {CHECKPOINT_EVERY}) and was killed by SIGKILL "
          f"after its 2nd checkpoint ({child_s:.1f} s); a fresh service's "
          f"recover() took {rec_s:.2f} s wall, resumed_steps {resumed}, "
          f"{counts['recover'][k2]} K2 launches, bit for bit the "
          f"uninterrupted checkpointed dispatch ({whole_s:.2f} s, "
          f"{counts['checkpointed'][k2]} K2 launches) [{card}]")

    demo, demo_s = counted("demo", lambda: serve_launcher.main(
        ["--demo", "--demo-requests", "4", "--demo-steps", "30"]), 0,
        4 * 2 * 30)
    served("demo", demo, 4)
    print(f"serve demo: repro_torch.launch.serve --demo (4 requests x 2 "
          f"seeds x 30 quadratic steps) in {demo_s:.2f} s, "
          f"{counts['demo'][k2]} K2 launches; the serve phase took "
          f"{time.perf_counter() - phase_t0:.1f} s [{card}]")
    return counts


K3_CASES = (  # label, (B, H, Hkv, S, T, Dh), causal, window, dtype name
    ("prefill shape", (LM_BATCH, 32, 32, LM_SEQ, LM_SEQ, 64), True, 0, "bfloat16"),
    # src/repro/configs/minitron_4b.py: 24 query heads over 8 kv heads of 128.
    ("minitron-4b", (LM_BATCH, 24, 8, LM_SEQ, LM_SEQ, 128), True, 0, "bfloat16"),
    ("GQA 24/8 Dh=128", (2, 24, 8, 1024, 1024, 128), True, 0, "bfloat16"),
    ("window 512", (2, 32, 32, 2048, 2048, 64), True, 512, "bfloat16"),
    ("bidirectional f32", (2, 8, 8, 512, 512, 64), False, 0, "float32"),
    ("ragged S=T=1000", (2, 32, 32, 1000, 1000, 64), True, 0, "bfloat16"),
    ("rows with no key", (2, 4, 2, 100, 40, 64), False, 16, "bfloat16"),
    # src/repro/configs/zamba2_2p7b.py: the shared attention block, 32
    # heads (MHA) of 80, in the Dh = 128 tile; then Dh = 80 with GQA, a
    # window and ragged S, and in f32.
    ("zamba2-2.7b", (LM_BATCH, 32, 32, LM_SEQ, LM_SEQ, 80), True, 0, "bfloat16"),
    ("Dh=80 GQA window", (2, 32, 8, 1000, 1000, 80), True, 256, "bfloat16"),
    ("Dh=80 f32", (2, 8, 8, 300, 300, 80), True, 0, "float32"),
    # The zoo phase's other prefills, heads of 128: deepseek_coder_33b.py
    # (56 heads over 8 kv heads), llama4_scout_17b.py (40 over 8),
    # command_r_35b.py (64 over 8) and phi35_moe_42b.py (32 over 8), the
    # GQA ratios 7, 5, 8 and 4.
    ("deepseek-coder-33b", (LM_BATCH, 56, 8, LM_SEQ, LM_SEQ, 128), True, 0,
     "bfloat16"),
    ("llama4-scout-17b", (LM_BATCH, 40, 8, LM_SEQ, LM_SEQ, 128), True, 0,
     "bfloat16"),
    ("command-r-35b", (LM_BATCH, 64, 8, LM_SEQ, LM_SEQ, 128), True, 0,
     "bfloat16"),
    ("phi3.5-moe-42b", (LM_BATCH, 32, 8, LM_SEQ, LM_SEQ, 128), True, 0,
     "bfloat16"),
    # The multimodal phase's prefills: qwen2_vl_2b.py (12 heads over 2 kv
    # heads of 128, GQA ratio 6) and whisper_tiny.py's decoder
    # self-attention (6 heads of 64, MHA) over its 448-token text
    # context, no multiple of the 128-row tile.
    ("qwen2-vl-2b", (LM_BATCH, 12, 2, LM_SEQ, LM_SEQ, 128), True, 0,
     "bfloat16"),
    ("whisper-tiny", (LM_BATCH, 6, 6, 448, 448, 64), True, 0, "bfloat16"),
)
K3_TIMED = ("prefill shape", "minitron-4b", "zamba2-2.7b", "deepseek-coder-33b",
            "llama4-scout-17b", "command-r-35b", "phi3.5-moe-42b",
            "qwen2-vl-2b", "whisper-tiny")
# MUFU ex2 results a clock per SM on compute capability 9.0 (CUDA C++
# programming guide, arithmetic instruction throughput).
MUFU_PER_CLOCK = 16


def dist_study(rt, steps):
    """The dist phase's study: alg1 and benchmark1 on the paper's
    periodic arrivals at populations 40 and 37 (one ragged group each),
    DIST_SEEDS seeds."""
    return (rt.experiments.Study("dist_fig1", num_steps=steps)
            .axis("scheduler", list(DIST_SCHEDULERS))
            .axis("arrivals", "periodic")
            .axis("n_clients", list(DIST_POPULATIONS))
            .axis("seeds", DIST_SEEDS))


def dist_sim(rt, data, use_kernel, optimizer=None):
    """The Fig-1 simulator of the dist phase on ``data`` (fig1_setup's):
    sgd(LR), the test split's loss."""
    batcher, _, test_x, test_y = data
    return rt.core.ClientSimulator(
        grads_fn=rt.models.client_grads_fn(batcher), p=batcher.p,
        optimizer=rt.optim.sgd(LR) if optimizer is None else optimizer,
        loss_fn=lambda w: rt.models.cnn_loss(w, test_x, test_y),
        use_kernel=use_kernel, device=DEVICE)


def dist_masked_shard(torch, ops, ref, placement, p):
    """K1 and K2's delta form over this rank's shard of a ragged
    (N_CLIENTS, p) buffer whose population ends one row before the last
    shard starts, masked rows NaN: the local results against the plain
    versions on the same rows within 1e-6 (the last shard exact zeros),
    and the all-reduced sums against the plain reduction of the whole
    buffer within 1e-6."""
    from repro_torch.core.energy import ClientShard, shard_all_reduce

    mesh = placement.make_client_mesh()
    shards, index = mesh.size, mesh.coords[0]
    shard = ClientShard(placement.CLIENT_AXIS, shards, "psum", index,
                        mesh.groups[0])
    n_local = N_CLIENTS // shards
    n_active = (shards - 1) * n_local - 1
    gen = torch.Generator(device="cpu").manual_seed(7)
    g = torch.randn(N_CLIENTS, p, generator=gen).to(DEVICE)
    w = (torch.rand(N_CLIENTS, generator=gen) * (2.0 / N_CLIENTS)).to(DEVICE)
    mask = (torch.arange(N_CLIENTS) < n_active).float().to(DEVICE)
    clean = torch.where(mask[:, None] > 0, g, 0.0)
    poisoned = torch.where(mask[:, None] > 0, g, float("nan"))
    rows = slice(index * n_local, (index + 1) * n_local)
    g_l, w_l, m_l = poisoned[rows].contiguous(), w[rows], mask[rows]
    eta = torch.tensor(LR, device=DEVICE)
    k1_local = ops.masked_scaled_aggregate(g_l, w_l, out_dtype=torch.float32,
                                           mask=m_l)
    k2_local = ops.masked_scaled_aggregate_update(g_l, w_l, eta, None, m_l)
    k1 = ops.masked_scaled_aggregate_sharded(g_l, w_l, shard=shard, mask=m_l)
    k2 = shard_all_reduce(k2_local, shard)
    err = lambda a, b: (a - b).abs().max().item()  # noqa: E731
    out = {"rank": index, "rows": [rows.start, rows.stop],
           "active_rows": int(m_l.sum().item()), "p": p,
           "local_k1_err": err(k1_local, ref.masked_scaled_aggregate_ref(
               clean[rows], w_l, m_l, torch.float32)),
           "local_k2_err": err(k2_local,
                               ref.masked_scaled_aggregate_update_ref(
                                   clean[rows], w_l, eta, None, m_l)),
           "k1_err": err(k1, ref.masked_scaled_aggregate_ref(
               clean, w, mask, torch.float32)),
           "k2_err": err(k2, ref.masked_scaled_aggregate_update_ref(
               clean, w, eta, None, mask)),
           "local_zero": bool(
               torch.equal(k1_local, torch.zeros_like(k1_local))
               and torch.equal(k2_local, torch.zeros_like(k2_local)))}
    check(out["active_rows"] > 0 or out["local_zero"],
          f"dist rank {index}: an all-masked shard gave non-zero K1/K2 "
          f"results: {out}")
    for name in ("local_k1_err", "local_k2_err", "k1_err", "k2_err"):
        check(out[name] <= 1e-6, f"dist rank {index}: {name} "
              f"{out[name]:.3g} above 1e-6: {out}")
    return out


def dist_child(out):
    """A rank of the dist phase (``--dist-child``, started by
    ``launch_simulated``, the rank from the ``REPRO_DIST_*``
    environment): the masked-shard check, then the study on every
    (kernel route, mesh, reduction): one compile per structure group and
    none on the repeat, K1's and K2's launches in the first run, the
    first run and DIST_REPEATS repeats timed on the kernel route (host
    clock, synchronised) after one untimed step, the final params'
    sha256. Rank 0 writes the results npz; every rank its report."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as tdist

    rt = load_port()
    from repro_torch.experiments import ExecutionConfig, engine, placement
    from repro_torch.kernels.aggregate import ops, ref
    from repro_torch.launch import distributed as D

    t_setup = time.perf_counter()
    device = D.init_from_env()
    size, rank = placement._world()
    threads = D.share_threads(size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Replicated params stay bit-equal only with deterministic cuDNN.
    torch.backends.cudnn.deterministic = True
    backend = tdist.get_backend()
    data = fig1_setup(torch, rt)
    report = {"process_id": rank, "process_count": size,
              "device": str(device), "backend": backend,
              # NCCL refuses two ranks on one card: gloo on the card means
              # the ranks share it.
              "shared_card": backend == "gloo", "threads": threads,
              "masked_shard": dist_masked_shard(
                  torch, ops, ref, placement,
                  rt.core.ravel_spec(data[1]).total),
              "combos": {}}
    study = dist_study(rt, DIST_STEPS)
    n_cells = len(study.resolve()) * DIST_SEEDS
    report["setup_s"] = time.perf_counter() - t_setup
    meshes = ("clients", "cells") + (("grid",) if size == 4 else ())
    # One step on the first mesh, untimed: a fresh process pays its
    # one-off costs (cuDNN's first choices, the first collectives) here.
    t0 = time.perf_counter()
    dist_study(rt, 1).run(sim=dist_sim(rt, data, True), params0=data[1],
                          config=ExecutionConfig(
                              mesh=D._build_mesh(meshes[0]),
                              client_reduction=DIST_REDUCTIONS[0]))
    torch.cuda.synchronize()
    report["warmup_s"] = time.perf_counter() - t0
    flat_all = {}
    for use_kernel in (True, False):
        sim = dist_sim(rt, data, use_kernel)
        _, _, groups = engine.resolve_structure_groups(study.resolve(),
                                                       sim=sim)
        for kind in meshes:
            mesh = D._build_mesh(kind)
            _, client_ax = placement._mesh_axes(mesh)
            for reduction in DIST_REDUCTIONS if client_ax else (None,):
                tag = (kind if reduction is None else f"{kind}-{reduction}") \
                    + ("" if use_kernel else "-plain")
                cfg = ExecutionConfig(mesh=mesh,
                                      client_reduction=reduction or "psum")
                before = placement._run_group_sharded._cache_size()
                walls = []
                # The plain route is the kernels' reference and runs once.
                for i in range(1 + DIST_REPEATS * use_kernel):
                    ops.reset_launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    result = study.run(sim=sim, params0=data[1], config=cfg)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    if i == 0:
                        launches = dict(ops.launch_counts)
                        compiles = (placement._run_group_sharded._cache_size()
                                    - before)
                        digest = D.params_digest(result.cells)
                        flat_all.update(D.flatten_results(tag, result.cells))
                check(compiles == len(groups),
                      f"dist {tag}: expected one compile per structure "
                      f"group ({len(groups)}), counted {compiles}")
                warm = placement._run_group_sharded._cache_size() - before
                ms = sorted(w / (n_cells * DIST_STEPS) * 1e3 for w in walls)
                report["combos"][tag] = {
                    "mesh_shape": dict(mesh.shape), "coords": mesh.coords,
                    "use_kernel": use_kernel, "compiles": compiles,
                    "warm_new_compiles": warm - compiles,
                    "launches": launches,
                    "ms_per_cell_step": statistics.median(ms),
                    "ms_spread": [ms[0], ms[-1]], "repeats": len(walls),
                    "params_sha256": digest}
    if rank == 0:
        np.savez(os.path.join(out, "results.npz"), **flat_all)
    with open(os.path.join(out, f"report_p{rank}.json"), "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    tdist.destroy_process_group()
    return 0


class split_rows:
    """While entered, the one-rank engine reduces the client axis as two
    client shards do: K1, and K2 with parameters, each run on rows
    0..N/2-1 and N/2..N-1 alone into f32 and the halves added, then
    K1's sum cast, or K2's added to the parameters in f32 (the sharded
    step's order, ``fused_flat_sgd_update``). Two ranks' all-reduce is
    that one f32 add, whichever rank's half comes first, so the sharded
    psum and fused runs on two ranks can be held to it bit for bit."""

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops
        self.k1 = ops.masked_scaled_aggregate
        self.k2 = ops.masked_scaled_aggregate_update

    def _halves(self, g, w, mask):
        n = g.shape[0] // 2
        return [(g[s], w[s], None if mask is None else mask[s])
                for s in (slice(0, n), slice(n, 2 * n))]

    def aggregate(self, g, w, out_dtype=None, mask=None):
        a, b = [self.k1(gi, wi, out_dtype=self.torch.float32, mask=mi)
                for gi, wi, mi in self._halves(g, w, mask)]
        return (a + b).to(g.dtype if out_dtype is None else out_dtype)

    def update(self, g, w, eta, params=None, mask=None, *, out_dtype=None):
        a, b = [self.k2(gi, wi, eta, None, mi)
                for gi, wi, mi in self._halves(g, w, mask)]
        if params is None:
            return a + b
        return (params.to(self.torch.float32) + (a + b)).to(params.dtype)

    def __enter__(self):
        self.ops.masked_scaled_aggregate = self.aggregate
        self.ops.masked_scaled_aggregate_update = self.update
        return self

    def __exit__(self, *exc):
        self.ops.masked_scaled_aggregate = self.k1
        self.ops.masked_scaled_aggregate_update = self.k2


def dist_phase(torch, rt, ops, ref, peaks, card):
    """The Fig-1 study across ranks (module docstring, phase 8). Returns
    each rank's K1 and K2 launches by combination, and K1 and K2's delta
    timed at a shard's rows."""
    import numpy as np

    from repro_torch.launch import distributed as D

    phase_t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    # The 40 clients split over 2 or 4 ranks, not 3.
    world = 4 if cards >= 4 else 2
    shared = cards < 2
    tag_card = f"[{card}{', shared card' if shared else ''}]"
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        D.launch_simulated(world, command=[
            sys.executable, str(ROOT / "chip_smoke.py"), "--dist-child"],
            argv=[out], timeout=600)
        ranks_s = time.perf_counter() - t0
        results = dict(np.load(os.path.join(out, "results.npz")))
        reports = []
        for rank in range(world):
            with open(os.path.join(out, f"report_p{rank}.json")) as f:
                reports.append(json.load(f))
    rep0 = reports[0]
    check([r["backend"] for r in reports] == ["gloo" if shared else "nccl"]
          * world and all(r["shared_card"] == shared for r in reports),
          f"dist: backends {[r['backend'] for r in reports]}")
    print(f"dist: {world} ranks over {rep0['backend']} on {cards} card(s), "
          f"{'shared by the ranks' if shared else 'one a rank'} "
          f"({', '.join(r['device'] for r in reports)}); {rep0['threads']} "
          f"torch threads a rank; gloo gathers and reduces CUDA tensors "
          f"itself (torch {torch.__version__}); the ranks ran in "
          f"{ranks_s:.1f} s wall, each rank's set-up (the Fig-1 data, the "
          f"masked-shard check) {max(r['setup_s'] for r in reports):.1f} s "
          f"{tag_card}")
    for r in reports:
        m = r["masked_shard"]
        print(f"dist masked shard: rank {m['rank']} rows {m['rows'][0]}.."
              f"{m['rows'][1] - 1} of a ragged (40, {m['p']:,}) buffer, "
              f"{m['active_rows']} active; K1 local err {m['local_k1_err']:.3g}"
              f", K2 delta local err {m['local_k2_err']:.3g}, after the "
              f"all-reduce {m['k1_err']:.3g} / {m['k2_err']:.3g}"
              + (", exact zeros" if m["local_zero"] else "") + f" {tag_card}")
    check(reports[-1]["masked_shard"]["active_rows"] == 0
          and reports[-1]["masked_shard"]["local_zero"],
          "dist: the last shard must have no active row and give zeros")

    # The same study on one rank, in this process, deterministic cuDNN:
    # as it is (the oracle of cells and gather), and with the client sum
    # split as two shards split it, through the psum route (sgd untagged,
    # so the engine does not fuse) and through K2 (fused).
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    data = fig1_setup(torch, rt)
    study = dist_study(rt, DIST_STEPS)
    want = {"one": D.flatten_results("ref", study.run(
        sim=dist_sim(rt, data, True), params0=data[1]).cells)}
    with split_rows(torch, ops):
        want["psum"] = D.flatten_results("ref", study.run(
            sim=dist_sim(rt, data, True, rt.optim.sgd(LR)._replace(kind="")),
            params0=data[1]).cells)
        want["fused"] = D.flatten_results("ref", study.run(
            sim=dist_sim(rt, data, True), params0=data[1]).cells)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = False
    del data
    tags = sorted({k.split("|")[0] for k in results})
    kernel_tags = [t for t in tags if not t.endswith("-plain")]
    n_cells = len(study.resolve()) * DIST_SEEDS

    def keys(tag):
        return [k for k in results if k.startswith(tag + "|")]

    def dist_of(a, b):
        return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())

    held_lines = {}
    for tag in kernel_tags:
        shape = rep0["combos"][tag]["mesh_shape"]
        mode = tag.rsplit("-", 1)[-1] if "clients" in shape else "cells"
        if mode in ("cells", "gather"):
            # Bit for bit the one-rank study.
            for k in keys(tag):
                _, cell, field = k.split("|")
                check(np.array_equal(results[k], want["one"][
                    f"ref|{cell}|{field}"]),
                      f"dist {tag}: {cell}/{field} differs from one rank")
            held_lines[tag] = "bitwise the one-rank study"
            continue
        if shape["clients"] == 2:
            # Bit for bit the one-rank study with the client sum split in
            # two; the weight sum (recorded, not fed back) is summed over
            # 40 rows there and over 2 x 20 here.
            for k in keys(tag):
                _, cell, field = k.split("|")
                exp = want[mode][f"ref|{cell}|{field}"]
                if field == "weight_sum":
                    np.testing.assert_allclose(results[k], exp, rtol=1e-6,
                                               atol=0)
                else:
                    check(np.array_equal(results[k], exp),
                          f"dist {tag}: {cell}/{field} differs from the "
                          f"one-rank study with the client sum split in two")
            held_lines[tag] = ("every step's loss, the params and the "
                               "participation bitwise the one-rank study with "
                               "the client sum split in two as the ranks "
                               "split it, the weight sums within 1e-6")
        else:
            # Four shards: their sum runs in the ring's order, which no
            # one-rank split reproduces; participation bit for bit, the
            # first steps' losses within f32 (the CNN at this step size
            # separates f32-reassociated trajectories ~3x a step).
            for k in keys(tag):
                _, cell, field = k.split("|")
                exp = want["one"][f"ref|{cell}|{field}"]
                if field in ("participation", "finite", "diverged"):
                    check(np.array_equal(results[k], exp),
                          f"dist {tag}: {cell}/{field} differs from one rank")
                elif field == "loss":
                    np.testing.assert_allclose(
                        results[k][..., :DIST_HELD_STEPS],
                        exp[..., :DIST_HELD_STEPS], rtol=1e-5, atol=1e-6)
            held_lines[tag] = (f"participation bitwise the one-rank study, "
                               f"the losses of steps 1-{DIST_HELD_STEPS} "
                               f"within rtol=1e-5, atol=1e-6")
        losses = [k for k in keys(tag) if k.endswith("|loss")]
        per_step = [max(dist_of(results[k][..., t],
                                want["one"][k.replace(tag, "ref", 1)][..., t])
                        for k in losses) for t in range(DIST_STEPS)]
        params = max(dist_of(results[k], want["one"][k.replace(tag, "ref", 1)])
                     for k in keys(tag) if k.endswith("|params"))
        held_lines[tag] += (f"; against the unsplit one-rank study, max "
                            f"|loss - one rank| by step "
                            f"{' '.join(f'{x:.2g}' for x in per_step)}, final "
                            f"params {params:.3g}")
    for tag in kernel_tags:
        worst = max(dist_of(results[k], results[k.replace(tag, tag + "-plain",
                                                          1)])
                    for k in keys(tag) if k.split("|")[2] in ("params",
                                                               "loss"))
        check(worst <= 1e-6, f"dist {tag}: kernels against plain {worst:.3g}")
        print(f"dist {tag}: {held_lines[tag]}; kernels against plain at this "
              f"mesh max {worst:.3g} {tag_card}")
    launches = {}
    n_groups = len(DIST_SCHEDULERS)
    for r in reports:
        digests = {t: c["params_sha256"] for t, c in r["combos"].items()}
        check(digests == {t: c["params_sha256"]
                          for t, c in rep0["combos"].items()},
              f"dist: rank {r['process_id']}'s params differ from rank 0's")
        launches[f"rank{r['process_id']}"] = {
            t: c["launches"] for t, c in r["combos"].items()}
        for t, c in r["combos"].items():
            check(c["compiles"] == n_groups and c["warm_new_compiles"] == 0,
                  f"dist {t}: compiles {c['compiles']}, warm "
                  f"{c['warm_new_compiles']}")
            # A launch a step of every cell the rank runs: its cell row's
            # share of each group's cells (all of them on a clients mesh);
            # K1 under gather and psum, K2 under fused and on a cells mesh
            # (sgd fused), none on the plain route.
            rows = c["mesh_shape"].get("cells", 1)
            row = c["coords"][0] if "cells" in c["mesh_shape"] else 0
            mine = n_groups * len(np.array_split(
                np.arange(n_cells // n_groups), rows)[row])
            k1_route = "clients" in c["mesh_shape"] and not t.endswith(
                ("fused", "fused-plain"))
            expect = {"masked_scaled_aggregate":
                      mine * DIST_STEPS * (c["use_kernel"] and k1_route),
                      "masked_scaled_aggregate_update":
                      mine * DIST_STEPS * (c["use_kernel"] and not k1_route)}
            check(c["launches"] == expect,
                  f"dist {t} rank {r['process_id']}: launches "
                  f"{c['launches']}, expected {expect}")
    for t in rep0["combos"]:
        row = "; ".join(
            f"rank {r['process_id']} K1 {r['combos'][t]['launches']['masked_scaled_aggregate']}"
            f" K2 {r['combos'][t]['launches']['masked_scaled_aggregate_update']}"
            f" {r['combos'][t]['ms_per_cell_step']:.2f} ms/cell-step "
            f"[{r['combos'][t]['ms_spread'][0]:.2f}, "
            f"{r['combos'][t]['ms_spread'][1]:.2f}]" for r in reports)
        c = rep0["combos"][t]
        print(f"dist time {t} (mesh {c['mesh_shape']}, {n_cells} cells x "
              f"{DIST_STEPS} steps, median of {c['repeats']} run(s), after a "
              f"{rep0['warmup_s']:.1f} s untimed step a rank): {row} "
              f"{tag_card}")
    print(f"dist: one compile per structure group per rank, none on the warm "
          f"repeat; params sha256 equal on all {world} ranks; the three "
          f"one-rank reference studies in {ref_s:.2f} s {tag_card}")

    # K1 and K2's delta at a shard's rows of the Fig-1 buffer (its last row
    # masked), timed alone on the card (this process), beside the plain
    # versions and the one PyTorch call of the same function (torch.mv,
    # torch.addmv with beta 0, on the masked weights).
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    p = 316_554
    flush = flush_buffer(torch)
    eta = torch.tensor(LR, device=DEVICE)
    shapes = {}
    for n in DIST_ROWS:
        g = torch.randn(n, p, device=DEVICE, generator=gen)
        w = torch.rand(n, device=DEVICE, generator=gen) * (2.0 / N_CLIENTS)
        mask = torch.ones(n, device=DEVICE)
        mask[n - 1] = 0.0
        wm, zeros = w * mask, torch.zeros(p, device=DEVICE)
        torch.testing.assert_close(
            ops.masked_scaled_aggregate(g, w, mask=mask),
            ref.masked_scaled_aggregate_ref(g, w, mask), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(
            ops.masked_scaled_aggregate_update(g, w, eta, None, mask),
            ref.masked_scaled_aggregate_update_ref(g, w, eta, None, mask),
            rtol=1e-6, atol=1e-6)
        gt = g.t()
        # The kernels read the active rows only (a masked row is never
        # loaded), the weights and the mask, and write the (P,) result.
        active = int(mask.sum().item())
        nbytes = 4 * (active * p + 2 * n + p)
        bound = nbytes / peaks[0] * 1e3
        for name, library, fns in (
                ("k1", "torch.mv",
                 (lambda: ops.masked_scaled_aggregate(g, w, mask=mask),
                  lambda: ref.masked_scaled_aggregate_ref(g, w, mask),
                  lambda: torch.mv(gt, wm))),
                ("k2 delta", "torch.addmv",
                 (lambda: ops.masked_scaled_aggregate_update(g, w, eta, None,
                                                             mask),
                  lambda: ref.masked_scaled_aggregate_update_ref(
                      g, w, eta, None, mask),
                  lambda: torch.addmv(zeros, gt, wm, beta=0, alpha=-LR)))):
            t = [time_ms(torch, fn, flush) for fn in fns]
            shapes[f"{name} {n} rows"] = {
                "ms": t[0][0], "warm_ms": t[0][1], "plain_ms": t[1][0],
                "library_ms": t[2][0], "bound_ms": bound, "bound_by": "bytes"}
            print(f"time {name} at a shard's {n} of 40 rows (L2 flushed | "
                  f"warm, ms): kernel {t[0][0]:.4f} | {t[0][1]:.4f}, plain "
                  f"{t[1][0]:.4f} | {t[1][1]:.4f}, {library} {t[2][0]:.4f} | "
                  f"{t[2][1]:.4f}, bound {bound:.4f} ({nbytes / 1e6:.1f} MB: "
                  f"the {active} active rows, the weights, the mask and the "
                  f"result; the timing floor is ~0.006-0.007 ms) [{card}]")
    del flush
    print(f"dist phase: took {time.perf_counter() - phase_t0:.1f} s {tag_card}")
    return launches, shapes


def build_report(build, source):
    """ptxas's report of each kernel in the library of ``source`` as
    {mangled name: [spill line, registers line]}, and its SASS as
    {mangled name: body}."""
    funcs, name = {}, None
    for line in build.build_log(source).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            funcs[name] = [line.strip()]
        elif name and "Used" in line and "registers" in line:
            funcs[name].append(line.split(":", 1)[1].strip())
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    bodies = {b.split("\n", 1)[0].strip(): b for b in sass.split("Function : ")[1:]}
    return funcs, bodies


def k3_build_report(build, fa_ops):
    """ptxas's registers and spills and the SASS's HGMMA and UTMALDG
    counts of the bf16 K3 kernels; fails on a spill, a C7508 (setmaxnreg
    ignored) or C7520 (wgmma serialised) warning, or a kernel without
    wgmma or TMA."""
    log = build.build_log(fa_ops.SOURCE)
    for code in ("C7508", "C7520"):
        check(code not in log, f"K3 build: ptxas warns {code}:\n{log}")
    funcs, bodies = build_report(build, fa_ops.SOURCE)
    # (tile width, head dim) of each bf16 instance: Dh = 80 in the 128 tile.
    for tile, dh in ((64, 64), (128, 80), (128, 128)):
        tag = f"flash_attention_bf16ILi{tile}ELi{dh}E"
        fn = next(f for f in funcs if tag in f)
        body = next(b for n, b in bodies.items() if tag in n)
        spills, regs = funcs[fn]
        counts = {op: body.count(op) for op in ("HGMMA", "UTMALDG", "USETMAXREG")}
        check(spills.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
              f"K3 bf16 Dh={dh} spills: {spills}")
        check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
              f"K3 bf16 Dh={dh}: SASS without wgmma or TMA {counts}")
        print(f"k3 build: bf16 Dh={dh} (tile {tile}): ptxas {regs} (entry count; setmaxnreg "
              f"moves consumers to 232), {spills}; SASS {counts}")


def k3_phase(torch, fa_ops, fa_ref, peaks, sm_clock_hz):
    """K3 against its plain version (in f32, same inputs) at every case;
    timings at the shapes of K3_TIMED."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    max_err = 0.0
    timing = {}
    for label, (b, h, hkv, s, t, dh), causal, window, dt in K3_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, s, h, dh, device=DEVICE, generator=gen).to(dtype)
        k = torch.randn(b, t, hkv, dh, device=DEVICE, generator=gen).to(dtype)
        v = torch.randn(b, t, hkv, dh, device=DEVICE, generator=gen).to(dtype)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        want = fa_ref.flash_attention_ref(
            q.float().transpose(1, 2), k.float().transpose(1, 2),
            v.float().transpose(1, 2), causal=causal,
            window=window).transpose(1, 2)
        torch.cuda.synchronize()
        check(out.dtype == dtype and out.shape == q.shape,
              f"K3 {label}: output {out.dtype} {tuple(out.shape)}")
        err = (out.float() - want).abs().max().item()
        max_err = max(max_err, err)
        if dtype == torch.float32:
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
            how = "rtol=atol=1e-05"
        else:
            bound = 2 ** -7 * want.abs().max().item()
            check(err <= bound, f"K3 {label}: max abs err {err:.4g} above "
                  f"the bf16 bound {bound:.4g}")
            how = f"{err / bound:.3f} of the bf16 bound"
        dead = ~fa_ref.visible_mask(s, t, causal=causal, window=window,
                                    device=DEVICE).any(dim=1)
        if dead.any():
            check(bool((out[:, dead] == 0).all()),
                  f"K3 {label}: rows with no key are not exact zeros")
            how += f", {int(dead.sum())} rows with no key exact zeros"
        print(f"k3 phase {label:<18} B,H,Hkv,S,T,Dh={(b, h, hkv, s, t, dh)} "
              f"causal={causal} window={window} {dt}: agrees "
              f"(max abs err {err:.3g}, {how})")
        if label not in K3_TIMED:
            continue
        del want
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        flush = flush_buffer(torch)
        fns = (lambda: fa_ops.flash_attention(q, k, v, causal=True),
               lambda: fa_ref.flash_attention_ref(qt, kt, vt, causal=True),
               lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=hkv != h))
        with torch.no_grad():
            times = [time_ms(torch, fn, flush, n) for fn, n in zip(
                fns, (TIMED_LAUNCHES, K3_PLAIN_LAUNCHES, TIMED_LAUNCHES))]
        # The work this run's inputs need: the two products and one
        # exponential over the visible (query, key) pairs only, and q, k,
        # v, out moved once.
        pairs = int(fa_ref.visible_mask(s, t, causal=True, window=0,
                                        device=DEVICE).sum())
        flops = 4 * b * h * dh * pairs
        nbytes = 2 * (2 * b * s * h * dh + 2 * b * t * hkv * dh)
        bound_f, bound_b = flops / peaks[2] * 1e3, nbytes / peaks[0] * 1e3
        exp_ms = b * h * pairs / (MUFU_PER_CLOCK * n_sm * sm_clock_hz) * 1e3
        tflops = flops / times[0][0] / 1e9
        timing[label] = {
            "ms": times[0][0], "plain_ms": times[1][0],
            "library_ms": times[2][0], "warm_ms": times[0][1],
            "plain_warm_ms": times[1][1], "library_warm_ms": times[2][1],
            "bound_ms": max(bound_f, bound_b),
            "bound_by": "operations" if bound_f >= bound_b else "bytes",
            "shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "T": t, "Dh": dh,
                      "causal": True}}
        print(f"time k3 {label} (L2 flushed | warm, ms): kernel "
              f"{times[0][0]:.4f} | {times[0][1]:.4f}, plain {times[1][0]:.4f} "
              f"| {times[1][1]:.4f}, library (F.scaled_dot_product_attention) "
              f"{times[2][0]:.4f} | {times[2][1]:.4f}, bound "
              f"{timing[label]['bound_ms']:.4f} ({flops / 1e9:.1f} GFLOP bf16, "
              f"{nbytes / 1e6:.0f} MB); {tflops:.1f} TFLOP/s achieved flushed, "
              f"{100 * timing[label]['bound_ms'] / times[0][0]:.1f} % of the "
              f"bound; {b * h * pairs / 1e6:.0f} M exponentials take "
              f"{exp_ms:.4f} ms at the MUFU rate ({MUFU_PER_CLOCK} a clock x "
              f"{n_sm} SMs x {sm_clock_hz / 1e6:.0f} MHz) beside the "
              f"tensor-core bound {bound_f:.4f} ms")
        del q, k, v, out, flush
    print(f"k3 phase: largest abs error {max_err:.4g}")
    return max_err, timing


K4_CASES = (  # label, (B, S, H, dk, dv), dtypes of a, k, v, q, shared k/q
    # zamba2-2.7b's Mamba2 layer (d_model 2560, expand 2, head_dim 64):
    # 80 heads, dk = d_state = 64, dv = head_dim = 64; a and v f32, k and
    # q bf16, one B/C row a position broadcast over the 80 heads (stride
    # 0), as the JAX block's _mamba2_preact feeds the scan.
    ("zamba2-2.7b mamba2", (LM_BATCH, LM_SEQ, 80, 64, 64),
     ("float32", "bfloat16", "float32", "bfloat16"), True),
    # xlstm-1.3b's mLSTM layer: d_inner 4096 over 4 heads, dk = 1024 and
    # dv = 1025 (v carries the normaliser column); all f32, k and q per head.
    ("xlstm-1.3b mlstm", (LM_BATCH, LM_SEQ, 4, 1024, 1025), ("float32",) * 4,
     False),
)
K4_CHUNK, K4_TOL = 64, 1e-4


def k4_build_report(torch, build, ssm_ops):
    """For each K4 kernel the main path instantiates (the scores kernel
    and the walk at each K4_CASES shape, chunk 64): ptxas's registers and
    spills, the walk's tiling and dynamic shared memory, and the HMMA
    (tensor-core) instructions of its SASS; fails on a spill or a kernel
    without HMMA."""
    funcs, bodies = build_report(build, ssm_ops.SOURCE)
    for label, (_, _, _, dk, _), dtypes, _ in K4_CASES:
        cfg = ssm_ops.kernel_config(dk, [getattr(torch, d) for d in dtypes], K4_CHUNK)
        exact = int(dtypes[1] == dtypes[3] == "bfloat16")
        mt = cfg["columns"] // 16
        nr = cfg["warps"] // mt
        tags = {"scores": f"gla_scoresILi{K4_CHUNK}ELb{exact}E",
                "walk": f"gla_walkILi{K4_CHUNK}ELi{mt}ELi{nr}E"
                        f"Li{cfg['dk_step'] // (8 * nr)}ELi{cfg['cluster']}ELb{exact}E"}
        for kind, tag in tags.items():
            fn = next(f for f in funcs if tag in f)
            body = next(b for n, b in bodies.items() if tag in n)
            spills, regs = funcs[fn]
            hmma = body.count("HMMA")
            check("0 bytes spill stores, 0 bytes spill loads" in spills,
                  f"K4 {kind} at {label} spills: {spills}")
            check(hmma > 0, f"K4 {kind} at {label}: SASS without HMMA")
            tiling = (f"{cfg['columns']} state columns a block, {cfg['warps']} "
                      f"warps, dk in steps of {cfg['dk_step']}, split over "
                      f"{cfg['cluster']} block(s) of a cluster, "
                      f"{cfg['walk_smem']} B dynamic shared memory"
                      if kind == "walk" else
                      f"{cfg['scores_smem']} B dynamic shared memory")
            print(f"k4 build: {kind} kernel for {label}: ptxas {regs}, {spills}; "
                  f"{tiling}; SASS HMMA {hmma}, LDGSTS {body.count('LDGSTS')}")


def k4_inputs(torch, gen, shape, dtypes, shared_kq, small_decay=False):
    """a in [0.6, 1] (or log-uniform in [1e-6, 1] with every 61st position
    exactly 0); k and q N(0, 1/dk); v N(0, 1); each in its dtype. With
    ``shared_kq`` k and q hold one row a position, expanded over the heads
    (stride 0)."""
    b, s, h, dk, dv = shape
    kq_heads = 1 if shared_kq else h
    u = torch.rand(b, s, h, device=DEVICE, generator=gen)
    if small_decay:
        a = torch.exp(u * torch.log(torch.tensor(1e-6)))
        a[:, ::61] = 0.0
    else:
        a = 0.6 + 0.4 * u
    k = torch.randn(b, s, kq_heads, dk, device=DEVICE, generator=gen) * dk ** -0.5
    q = torch.randn(b, s, kq_heads, dk, device=DEVICE, generator=gen) * dk ** -0.5
    v = torch.randn(b, s, h, dv, device=DEVICE, generator=gen)
    a, k, v, q = (x.to(getattr(torch, dt)) for x, dt in zip((a, k, v, q), dtypes))
    return a, k.expand(b, s, h, dk), v, q.expand(b, s, h, dk)


def k4_work(x):
    """Operations and bytes of one scan at chunk 64: the four products,
    the two intra-chunk ones over the causal half of each chunk. Where k
    and q are both shared by the heads (stride 0) their dot products are
    counted once a batch row, since only the decay differs by head. Each
    operand is read once, a broadcast axis as one copy, and y written once
    in f32."""
    a, k, v, q = x
    b, s, h = a.shape
    dk, dv = k.shape[-1], v.shape[-1]
    full, rest = divmod(s, K4_CHUNK)
    pairs = full * K4_CHUNK * (K4_CHUNK + 1) // 2 + rest * (rest + 1) // 2
    qk_heads = 1 if k.stride(2) == 0 and q.stride(2) == 0 else h
    flops = b * (2 * pairs * (qk_heads * dk + h * dv) + 4 * h * s * dk * dv)
    stored = lambda t: t.element_size() * math.prod(
        n for n, st in zip(t.shape, t.stride()) if st)
    nbytes = sum(stored(t) for t in x) + 4 * b * s * h * dv
    return flops, nbytes


def k4_phase(torch, ssm_ops, ssm_ref, chunked_gla, peaks):
    """K4 through ``gla_scan`` at both full-width shapes (the counted main
    path), the extra cases against the plain version, and the timings."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    max_err = 0.0

    def plain(a, k, v, q):
        b, s, h = a.shape
        fold = lambda x: x.transpose(1, 2).reshape((b * h, s) + x.shape[3:])
        y = ssm_ref.gla_scan_ref(fold(a), fold(k), fold(v), fold(q))
        return y.reshape(b, h, s, v.shape[-1]).transpose(1, 2)

    def held(label, x, y, want=None):
        nonlocal max_err
        want = plain(*x) if want is None else want
        torch.cuda.synchronize()
        check(y.dtype == torch.float32 and y.shape == x[2].shape,
              f"K4 {label}: output {y.dtype} {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"K4 {label}: output not finite")
        err = (y - want).abs().max().item()
        top = want.abs().max().item()
        check(err <= K4_TOL * top, f"K4 {label}: max abs err {err:.4g} above "
              f"{K4_TOL} x max|plain| {top:.4g}")
        max_err = max(max_err, err)
        b, s, h, dk = x[1].shape
        shared = ", k/q shared by the heads" if x[1].stride(2) == 0 else ""
        print(f"k4 phase {label:<22} B,S,H,dk,dv={(b, s, h, dk, x[2].shape[-1])} "
              f"{'/'.join(str(t.dtype)[6:] for t in x)}{shared}: agrees (max abs err "
              f"{err:.3g}, {err / top:.3g} of max|plain| {top:.3g})")
        return want

    inputs = [k4_inputs(torch, gen, shape, dts, shared)
              for _, shape, dts, shared in K4_CASES]
    torch.cuda.synchronize()
    # The main path: one scan at each shape, counted.
    ssm_ops.reset_launch_counts()
    outs = [ssm_ops.gla_scan(*x, chunk=K4_CHUNK) for x in inputs]
    torch.cuda.synchronize()
    launches = ssm_ops.launch_counts["gla_scan"]
    check(launches == len(K4_CASES),
          f"K4 launches {launches}, expected {len(K4_CASES)}")
    print(f"k4 main path: {launches} K4 launches for the {len(K4_CASES)} "
          f"full-width scans")
    for (label, *_), x, y in zip(K4_CASES, inputs, outs):
        held(label, x, y)
    del outs

    zamba, xlstm = K4_CASES[0][2:], K4_CASES[1][2:]
    x = k4_inputs(torch, gen, (2, 2000, 80, 64, 64), *zamba)
    held("ragged S=2000", x, ssm_ops.gla_scan(*x, chunk=K4_CHUNK))
    x = k4_inputs(torch, gen, (2, 1024, 80, 64, 64), *zamba, small_decay=True)
    held("small decay", x, ssm_ops.gla_scan(*x, chunk=K4_CHUNK))
    x = k4_inputs(torch, gen, (1, 512, 4, 1024, 1025), *xlstm)
    y64 = ssm_ops.gla_scan(*x, chunk=64)
    want = held("chunk 64", x, y64)
    y32 = ssm_ops.gla_scan(*x, chunk=32)
    held("chunk 32", x, y32, want)
    diff = (y32 - y64).abs().max().item()
    check(diff <= K4_TOL * want.abs().max().item(),
          f"K4 chunk 32 against chunk 64: {diff:.4g}")
    print(f"k4 phase chunk invariance: chunk 32 against chunk 64 max abs "
          f"diff {diff:.3g}")
    del x, want, y32, y64

    flush = flush_buffer(torch)
    timing = {}
    for (label, *_), x in zip(K4_CASES, inputs):
        fns = (lambda: ssm_ops.gla_scan(*x, chunk=K4_CHUNK),
               lambda: plain(*x),
               lambda: chunked_gla(*x, chunk=K4_CHUNK))
        with torch.no_grad():
            times = [time_ms(torch, fn, flush, n)
                     for fn, n in zip(fns, (TIMED_LAUNCHES, 2, 10))]
        flops, nbytes = k4_work(x)
        bound_b = nbytes / peaks[0] * 1e3
        # The route taken: every product on the TF32 tensor cores as
        # 3xTF32. The f32 count is printed too, as earlier runs report it.
        bound_f, bound_f32 = 3 * flops / peaks[3] * 1e3, flops / peaks[1] * 1e3
        timing[label] = {
            "ms": times[0][0], "warm_ms": times[0][1],
            "plain_ms": times[1][0], "plain_warm_ms": times[1][1],
            "comparator_ms": times[2][0], "comparator_warm_ms": times[2][1],
            "bound_ms": max(bound_f, bound_b),
            "bound_by": "operations" if bound_f >= bound_b else "bytes"}
        print(f"time k4 {label} (L2 flushed | warm, ms): kernel "
              f"{times[0][0]:.4f} | {times[0][1]:.4f}, plain {times[1][0]:.2f} "
              f"| {times[1][1]:.2f}, nearest comparator (chunked_gla) "
              f"{times[2][0]:.4f} | {times[2][1]:.4f}, library call none, "
              f"bound {timing[label]['bound_ms']:.4f} "
              f"({timing[label]['bound_by']}: 3 x {flops / 1e9:.1f} GFLOP at "
              f"the TF32 rate, {nbytes / 1e6:.0f} MB; "
              f"{100 * timing[label]['bound_ms'] / times[0][0]:.1f} % of it "
              f"reached flushed; {flops / times[0][0] / 1e9:.2f} TFLOP/s "
              f"achieved), bound at the f32 rate {max(bound_f32, bound_b):.4f}")
    del inputs, flush
    torch.cuda.empty_cache()
    print(f"k4 phase: largest abs error {max_err:.4g}")
    return launches, max_err, timing


def dist(a, b):
    """The largest absolute difference of two logit tensors."""
    return (a.float() - b.float()).abs().max().item()


def row_dists(a, b):
    """The largest absolute difference of each row of two logit tensors."""
    return (a.float() - b.float()).abs().amax(dim=-1)


def argmax_agrees(got, ref, floor):
    """Whether ``got``'s argmax equals ``ref``'s on every row whose top-two
    gap in ``ref`` exceeds 2x ``floor``, and how many rows those are."""
    top2 = ref.float().topk(2, dim=-1).values
    rows = (top2[:, 0] - top2[:, 1]) > 2 * floor
    same = got.float().argmax(-1) == ref.float().argmax(-1)
    return bool(same[rows].all()), int(rows.sum())


def lm_phase(torch, rt, fa_ops):
    """stablelm-1.6b at full width: flash prefill through K3, the f32
    reference, decode through the KV cache, the profile."""
    from repro_torch._tree import tree_map
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer

    cfg = rt.configs.get_config("stablelm-1.6b").replace(use_flash=True)
    plain_cfg = cfg.replace(use_flash=False)
    ref_cfg = plain_cfg.replace(dtype_name="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = transformer.init_lm(rt.random.PRNGKey(0, device=DEVICE), cfg)
    torch.cuda.synchronize()
    n_params = rt.models.count_params(params)
    check(n_params == LM_PARAMS, f"stablelm-1.6b has {n_params} parameters")
    check(params["stack"]["seg0"]["attn"]["wq"]["w"].shape
          == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
          and params["embed"]["w"].dtype == torch.bfloat16,
          "stablelm-1.6b parameter layout")
    print(f"lm init: {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"{n_params:,} parameters "
          f"({2 * n_params / 1e9:.2f} GB bf16) in "
          f"{time.perf_counter() - t0:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    data = rt.data.make_lm_tokens(0, LM_BATCH, LM_SEQ, cfg.vocab).tokens
    tokens = torch.from_numpy(data[:, :LM_SEQ]).to(DEVICE)
    prompt = tokens[:, :LM_PROMPT]
    prefill = make_prefill_step(cfg)
    plain = make_prefill_step(plain_cfg)
    reference = make_prefill_step(ref_cfg)

    # The main path: the counted flash prefills.
    fa_ops.reset_launch_counts()
    ms = []
    with torch.no_grad():
        for _ in range(LM_PREFILLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flash = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    launches = fa_ops.launch_counts["flash_attention"]
    check(launches == cfg.n_layers * LM_PREFILLS,
          f"K3 launches {launches}, expected {cfg.n_layers} x {LM_PREFILLS}")
    check(flash.shape == (LM_BATCH, cfg.vocab) and bool(torch.isfinite(flash).all()),
          "flash prefill logits not finite or of the wrong shape")
    print(f"lm prefill (use_flash, K3): B={LM_BATCH} S={LM_SEQ}: "
          + " ".join(f"{m:.2f}" for m in ms) + f" ms per prefill, "
          f"{LM_BATCH * LM_SEQ / min(ms) * 1e3:,.0f} tokens/s (best), "
          f"{launches} K3 launches in {LM_PREFILLS} prefills")

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_logits = plain(params, {"tokens": tokens})
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        params32 = tree_map(lambda x: x.float(), params)
        ref_logits = reference(params32, {"tokens": tokens})
        ref_prompt = reference(params32, {"tokens": prompt})
        plain_prompt = plain(params, {"tokens": prompt})
        del params32
    torch.cuda.empty_cache()
    floor = dist(plain_logits, ref_logits)
    err = dist(flash, ref_logits)
    agree, rows = argmax_agrees(flash, ref_logits, floor)
    check(err <= 2 * floor, f"flash prefill {err:.4g} from the f32 reference, "
          f"above 2x the bf16 floor {floor:.4g}")
    check(agree, "flash prefill argmax differs from the f32 reference on a "
          "row whose top-two gap exceeds 2x the floor")
    print(f"lm reference: plain-attention bf16 prefill {plain_ms:.2f} ms; "
          f"last-position logits (max |logit| {ref_logits.abs().max().item():.3g}) "
          f"from the f32 reference: plain bf16 {floor:.4g} (the floor), "
          f"flash {err:.4g} (<= 2x floor); argmax agrees on all {rows} of "
          f"{LM_BATCH} rows whose top-two gap exceeds 2x the floor")

    serve = make_serve_step(cfg)
    cache_len = transformer.decode_cache_len(cfg, LM_CACHE)
    states = transformer.init_decode_state(cfg, LM_BATCH, cache_len,
                                           device=DEVICE)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(LM_PROMPT):
            nxt, logits, states = serve(params, prompt[:, pos:pos + 1],
                                        states, pos)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) / LM_PROMPT * 1e3
    floor_p = dist(plain_prompt, ref_prompt)
    err_p = dist(logits, ref_prompt)
    agree, rows = argmax_agrees(logits, ref_prompt, floor_p)
    check(err_p <= 2 * floor_p, f"decode at position {LM_PROMPT - 1}: "
          f"{err_p:.4g} from the f32 reference, above 2x the floor {floor_p:.4g}")
    check(agree, "decode argmax differs from the f32 reference on a row "
          "whose top-two gap exceeds 2x the floor")
    print(f"lm decode replay: {LM_PROMPT} prompt tokens one at a time through "
          f"make_serve_step (cache {cache_len}), {replay_ms:.2f} ms/step; "
          f"logits at position {LM_PROMPT - 1} from the f32 reference prefill "
          f"of those tokens {err_p:.4g} (<= 2x the floor {floor_p:.4g}); "
          f"argmax agrees on all {rows} rows above 2x the floor")

    tok = nxt[:, None]
    first = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(LM_PROMPT, LM_PROMPT + LM_GREEDY):
            nxt, logits, states = serve(params, tok, states, pos)
            tok = nxt[:, None]
            first.append(nxt)
        torch.cuda.synchronize()
        greedy_ms = (time.perf_counter() - t0) / LM_GREEDY * 1e3
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    print(f"lm decode: {LM_GREEDY} greedy steps at positions {LM_PROMPT}.."
          f"{LM_PROMPT + LM_GREEDY - 1}, {greedy_ms:.2f} ms/step "
          f"({LM_BATCH * 1e3 / greedy_ms:.0f} tokens/s); tokens of row 0: "
          f"{[int(t[0]) for t in first[:8]]}")

    with torch.no_grad():
        profile(torch, "prefill", "prefill",
                lambda: prefill(params, {"tokens": tokens}), 1,
                "flash_attention")
        profile(torch, "decode", "step",
                lambda: serve(params, tok, states, LM_PROMPT + LM_GREEDY - 1), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"lm phase: peak device memory {peak:.2f} GB")
    return launches, params


def train_argv(steps, *extra, arch="stablelm-1.6b", seq=TRAIN_SEQ):
    """The driver's arguments in the train phases: full width, alg1 on
    periodic arrivals, adamw, every step logged."""
    return ["--arch", arch, "--steps", str(steps),
            "--global-batch", str(TRAIN_BATCH), "--seq-len", str(seq),
            "--n-clients", str(TRAIN_CLIENTS), "--scheduler", "alg1",
            "--arrivals", "periodic", "--lr", str(TRAIN_LR),
            "--log-every", "1", "--device", DEVICE, *extra]


def deterministic(torch, on):
    """Deterministic algorithms (the embedding's and the CE's scatter
    backward included) and cuDNN; cuBLAS's workspace is fixed by
    ``CUBLAS_WORKSPACE_CONFIG``, set before CUDA starts."""
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on


def resume_cfg(rt):
    """stablelm-1.6b at full width cut to RESUME_LAYERS layers."""
    return rt.configs.get_config("stablelm-1.6b").replace(
        n_layers=RESUME_LAYERS)


def params_sha256(torch, tree):
    """sha256 of a tensor tree's leaves: their dtypes, shapes and bytes."""
    import hashlib

    from repro_torch._tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(f"{leaf.dtype}{tuple(leaf.shape)}".encode())
        h.update(leaf.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy())
    return h.hexdigest()


# The line a resume child prints once its last step is done, before the
# driver writes its final checkpoint.
RESUMED_MARK = "train child resumed: "


def train_child(ckdir):
    """The resume check's second leg, in a process of its own: resume the
    run halted in ``ckdir`` to its end, deterministic. After its last
    step it prints RESUMED_MARK and its losses, final params' sha256
    and times on one line; after the driver's final checkpoint it
    writes that write's time to ``ckdir/child_times.json``."""
    import torch

    rt = load_port()
    from repro_torch.launch import train as train_mod

    loaded = time.perf_counter()
    ckdir = child_directory(ckdir)
    handed = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic(torch, True)
    stamps, losses = {}, []

    def on_step(step, state, metrics):
        torch.cuda.synchronize()
        stamps.setdefault("first_step", time.perf_counter())
        stamps["last_step"] = time.perf_counter()
        losses.append(float(metrics["loss"]))
        if step == RESUME_STEPS - 1:
            # Where the child's time went: interpreter and imports, its
            # CUDA context and the wait for its directory (while the
            # parent worked on), the driver's set-up and restore with the
            # first resumed step, the other steps.
            times = {"load_s": loaded - T0,
                     "context_and_wait_s": handed - loaded,
                     "restore_and_first_step_s": stamps["first_step"] - handed,
                     "steps_s": stamps["last_step"] - stamps["first_step"]}
            print(RESUMED_MARK + json.dumps({
                "losses": losses, "times": times,
                "params_sha256": params_sha256(torch, state.params)}),
                flush=True)
            # The card is the next phase's while the checkpoint is
            # written: keep only what is allocated.
            torch.cuda.empty_cache()

    returned = train_mod.main(
        train_argv(RESUME_STEPS, "--checkpoint-dir", ckdir, "--resume"),
        cfg=resume_cfg(rt), on_step=on_step)
    check(returned == losses, f"train child: the driver returned {returned}, "
          f"its steps gave {losses}")
    with open(os.path.join(ckdir, "child_times.json"), "w") as f:
        json.dump({"final_write_s": time.perf_counter() - stamps["last_step"]},
                  f)
    return 0


# Leaf names of the weights that enter a product with every token: dense
# layers ("w"), xLSTM's per-head q/k/v and the sLSTM's recurrent matrix,
# the MoE experts.
MATMUL_LEAVES = frozenset(("w", "wq", "wk", "wv", "r", "w_gate", "w_up",
                           "w_down"))


def named_leaves(tree, path=()):
    """``(path, leaf)`` for every leaf of a nested dict of tensors."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from named_leaves(sub, path + (key,))
    else:
        yield path, tree


def train_flop(cfg, params, batch, seq):
    """Model FLOP of one train step and the matmul weights counted.

    2 a multiply-add, forward and backward (x3), over the matmul weights:
    each reads ``batch x seq`` tokens, or ``batch x enc_len`` frames for
    the encoder's weights and cross attention's K/V projections; an MoE
    expert weight counts top_k / n_experts of itself (the experts a token
    is routed to); a shared segment's weights count once a call site; the
    embedding only when tied to the head (it is a gather otherwise);
    depthwise convolutions not at all. Plus every attention layer's two
    score products in full, as the plain path computes them: self
    attention seq x seq, cross attention seq x enc_len, the encoder's
    enc_len x enc_len. The recurrent scans (chunked_gla, the sLSTM's
    cell) are not counted."""
    shared = {f"seg{i}": cfg.n_super
              for i, (_, _, sh) in enumerate(cfg.resolved_superblock) if sh}
    frames = batch * cfg.enc_len
    weights, flop = 0, 0
    for path, leaf in named_leaves(params):
        if (path[-1] not in MATMUL_LEAVES or leaf.dim() < 2 or "conv" in path
                or (path[0] == "embed" and not cfg.tie_embeddings)):
            continue
        n = leaf.numel() * next((shared[k] for k in path if k in shared), 1)
        if "moe" in path and path[-1] != "w":
            n = n * cfg.top_k // cfg.n_experts
        reads = (frames if path[0] == "encoder"
                 or ("cross" in path and path[-1] in ("wk", "wv"))
                 else batch * seq)
        weights += n
        flop += 6 * n * reads
    width = cfg.n_heads * cfg.resolved_head_dim
    for kind, count, sh in cfg.resolved_superblock:
        layers = cfg.n_super * (1 if sh else count)
        if "attn" in kind:
            flop += 12 * layers * batch * seq * seq * width
        if kind == "xattn":
            flop += 12 * layers * batch * seq * cfg.enc_len * width
    if cfg.enc_dec:
        flop += 12 * cfg.n_enc_layers * batch * cfg.enc_len ** 2 * width
    return flop, weights


def alg1_decisions(torch, rt, n):
    """alg1 on periodic arrivals over TRAIN_CLIENTS clients, seed 1: its
    first decision with a masked client beside an active one, its first
    ``n`` with an active client, and the key the phases draw batches
    from."""
    sched, energy = rt.experiments.build_components(
        scheduler="alg1", arrivals="periodic", n_clients=TRAIN_CLIENTS,
        horizon=64)
    energy = energy.to(DEVICE)
    key = rt.random.PRNGKey(1, device=DEVICE)
    k_sched, k_energy, k_draw = rt.random.split(key, 3)
    sstate, estate = sched.init(k_sched), energy.init(k_energy)
    masked, decisions = None, []
    for t in range(63):
        k_arr, k_dec = rt.random.split(rt.random.fold_in(k_draw, t))
        estate, arr = energy.arrivals(estate, t, k_arr)
        sstate, dec = sched.step(sstate, t, k_dec, arr)
        n_on = int(dec.mask.sum().item())
        if n_on and len(decisions) < n:
            decisions.append((dec.mask, dec.scale))
        if masked is None and 0 < n_on < TRAIN_CLIENTS:
            masked = (dec.mask, dec.scale)
        if masked is not None and len(decisions) == n:
            break
    check(masked is not None and len(decisions) == n,
          "train: alg1 gave no step with a masked and an active client")
    return masked, decisions, k_draw


def lm_batch(raw, ids, extra=None):
    """A driver batch from ``raw`` (B, S + 1) token rows and client ids,
    with a config's zero side inputs ``extra``."""
    return {"tokens": raw[:, :-1], "labels": raw[:, 1:], "client_ids": ids,
            **(extra or {})}


def replace_rows(torch, raw, ids, client, vocab):
    """``raw`` with ``client``'s rows replaced by other random tokens, and
    the number of rows replaced."""
    other = raw.clone()
    rows = ids == client
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    other[rows] = torch.randint(0, vocab, other[rows].shape, device=DEVICE,
                                dtype=other.dtype, generator=gen)
    check(not torch.equal(other, raw), "train: the replaced tokens are the same")
    return other, int(rows.sum())


def adamw_update(torch, rt, cfg, params, batch, mask, scale, aux=None):
    """One ``make_train_step`` adamw step from ``params`` (with ``aux``,
    ``build_energy_train_step`` at that aux-loss weight): the new params'
    and first moment's leaves, and the step's mean loss."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core.trainer import build_energy_train_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer

    opt = rt.optim.adamw(TRAIN_LR)
    if aux is None:
        init_state, step = make_train_step(cfg, TRAIN_CLIENTS, optimizer=opt)
    else:
        init_state, step = build_energy_train_step(
            per_example_loss_fn=lambda p, b: transformer.per_example_loss(
                p, cfg, b),
            optimizer=opt, n_clients=TRAIN_CLIENTS, aux_loss_weight=aux)
    state, metrics = step(init_state(params), batch, mask, scale)
    leaves = tuple(tree_leaves(t) for t in (state.params, state.opt_state.mu))
    return leaves, metrics["loss"].item()


def two_updates(torch, rt, cfg, params, batch_a, batch_b, mask, scale,
                aux=None):
    """:func:`adamw_update` from ``params`` on two batches: the first
    update stays on the card when it fits beside the step's peak below
    KEEP_ON_CARD, else it waits on the host. Returns both updates and
    their mean losses."""
    torch.cuda.reset_peak_memory_stats()
    a, loss_a = adamw_update(torch, rt, cfg, params, batch_a, mask, scale, aux)
    size = sum(x.numel() * x.element_size() for xs in a for x in xs)
    if torch.cuda.max_memory_allocated() + size > KEEP_ON_CARD:
        a = tuple([x.cpu() for x in xs] for xs in a)
    b, loss_b = adamw_update(torch, rt, cfg, params, batch_b, mask, scale, aux)
    return a, b, loss_a, loss_b


def update_moved(a, b):
    """How far one update (params, first moment) moved from another, on
    ``b``'s device: for each of the two, the elements that differ and the
    largest absolute difference among them."""
    out = []
    for xs, ys in zip(a, b):
        check(len(xs) == len(ys), "two updates of different trees")
        differ, err = 0, 0.0
        for x, y in zip(xs, ys):
            x = x.to(y.device)
            n = int((x != y).sum())
            if n:
                differ += n
                err = max(err, (x.float() - y.float()).abs().max().item())
        out.append((differ, err))
    return out


def flat_sgd_check(torch, rt, ops, cfg, params, batches, decisions, label,
                   card):
    """The flat SGD route of ``build_energy_train_step`` (one K2 launch a
    step on a one-row bf16 stack of every parameter) for the given
    steps, against the same steps through K2's plain version: launches
    counted, every leaf within one bf16 rounding. Returns the launches
    and the parameters in the stack."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core.trainer import build_energy_train_step
    from repro_torch.models import transformer

    k2 = "masked_scaled_aggregate_update"

    def loss_fn(p, b):
        return transformer.per_example_loss(p, cfg, b)

    finals, walls = {}, {}
    for use_kernel in (True, False):
        init, flat_step = build_energy_train_step(
            per_example_loss_fn=loss_fn, optimizer=rt.optim.sgd(FLAT_LR),
            n_clients=TRAIN_CLIENTS, flat=True, use_kernel=use_kernel)
        state = init(params)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, (m, sc) in zip(batches, decisions):
            state, metrics = flat_step(state, b, m, sc)
            check(math.isfinite(metrics["loss"].item()),
                  f"{label} flat sgd: loss not finite")
        torch.cuda.synchronize()
        walls[use_kernel] = time.perf_counter() - t0
        finals[use_kernel] = (state.params, ops.launch_counts[k2])
        del state
    launches = finals[True][1]
    check(launches == len(batches) and finals[False][1] == 0,
          f"{label} flat sgd: {launches} K2 launches in {len(batches)} steps "
          f"(plain route {finals[False][1]})")
    err, differ, n_el = 0.0, 0, 0
    for a, b in zip(tree_leaves(finals[True][0]), tree_leaves(finals[False][0])):
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -8, atol=1e-6)
        err = max(err, (a.float() - b.float()).abs().max().item())
        differ += int((a != b).sum().item())
        n_el += a.numel()
    del finals
    print(f"{label} flat sgd: {cfg.name}, build_energy_train_step(flat=True, "
          f"use_kernel=True), sgd({FLAT_LR}), {len(batches)} step(s) at P = "
          f"{n_el:,} bf16: {launches} K2 launches ({walls[True]:.2f} s); "
          f"against K2's plain version ({walls[False]:.2f} s) max abs diff "
          f"{err:.3g}, {differ} of {n_el:,} params differ (gate: one bf16 "
          f"rounding step) [{card}]")
    torch.cuda.empty_cache()
    return launches, n_el


def driver_run(torch, argv, cfg, params, timed, label, on_step=None,
               cpu=True, side_inputs=None):
    """The driver's own run (``repro_torch.launch.train.main`` on
    ``argv(steps)``, ``cfg`` and ``params``): TRAIN_WARMUP warm-up steps,
    then ``timed`` timed steps, the last of them under ``torch.profiler``
    (the device alone unless ``cpu``; started before that step's clock
    starts, stopped after it ends), each step synchronised and stamped
    and passed on to ``on_step``. Holds the losses and weight sums finite
    and the last loss below the first. Returns the losses, the timed
    steps' ms and their median, the peak device memory in GB (reset
    before the run), the active clients and weight sums, the profiler
    and the profiled step's wall us. ``side_inputs`` replaces the
    driver's zero vision tokens or audio frames."""
    from repro_torch.launch import train as train_mod

    last = TRAIN_WARMUP + timed - 1
    stamps, active, wsum = [], [], []
    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(
        activities=[act.CPU, act.CUDA] if cpu else [act.CUDA])

    def stamp(step, state, metrics):
        torch.cuda.synchronize()
        end = time.perf_counter()
        if step == last:
            prof.stop()
        active.append(int(metrics["active_clients"].item()))
        wsum.append(metrics["weight_sum"].item())
        if on_step is not None:
            on_step(step, state, metrics)
        if step == last - 1:
            prof.start()
        # A step's clock runs from the end of the bookkeeping above for
        # the step before it to the synchronise after it.
        stamps.append((end, time.perf_counter()))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = train_mod.main(argv(last + 1), cfg=cfg, params=params,
                            on_step=stamp, side_inputs=(
                                side_inputs or train_mod.zero_side_inputs))
    del params
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = sorted((stamps[k][0] - stamps[k - 1][1]) * 1e3
                for k in range(TRAIN_WARMUP, last + 1))
    med = (ms[len(ms) // 2] if len(ms) % 2
           else sum(ms[len(ms) // 2 - 1:len(ms) // 2 + 1]) / 2)
    check(all(math.isfinite(x) for x in losses + wsum),
          f"{label}: a loss or weight sum is not finite: {losses} {wsum}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall: {losses}")
    return {"losses": losses, "ms": ms, "med": med, "peak": peak,
            "active": active, "wsum": wsum, "prof": prof,
            "wall_us": (stamps[last][0] - stamps[last - 1][1]) * 1e6}


def train_phase(torch, rt, params, ops, ref, peaks, card):
    """Energy-weighted LM training at stablelm-1.6b full width through
    the driver (``repro_torch.launch.train.main``) on the LM phase's
    weights; a masked client's tokens change nothing; the flat SGD route
    through K2 against its plain version, and K2 timed at that shape; a
    2-layer run halted, resumed in a child process, bit for bit. Returns
    the flat SGD launches, K2's time at that shape, and the resume child
    still writing its final checkpoint (:func:`finish_resume`)."""
    from repro_torch.launch import train as train_mod

    phase_t0 = time.perf_counter()
    cfg = rt.configs.get_config("stablelm-1.6b")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    d = cfg.d_model
    flops, matmul_params = train_flop(cfg, params, TRAIN_BATCH, TRAIN_SEQ)
    bound_s = flops / peaks[2]

    # The main path: the driver's own run.
    run = driver_run(torch, train_argv, cfg, params, TRAIN_TIMED, "train")
    losses, ms, med, peak = run["losses"], run["ms"], run["med"], run["peak"]
    mfu = flops / (med / 1e3) / peaks[2]
    print(f"train run: {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {d}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16, remat "
          f"{cfg.remat_policy if cfg.remat else 'off'}) through "
          f"repro_torch.launch.train.main, B={TRAIN_BATCH} x S={TRAIN_SEQ} "
          f"({tokens:,} tokens a step), {TRAIN_CLIENTS} clients, alg1 on "
          f"periodic arrivals, adamw {TRAIN_LR}: {TRAIN_WARMUP} warm-up step, "
          f"{TRAIN_TIMED} timed: median {med:.1f} ms/step (spread "
          f"{min(ms):.1f}..{max(ms):.1f}), {tokens / med * 1e3:,.0f} tokens/s; "
          f"model FLOP a step {flops:.4g} ({matmul_params:,} matmul weights), "
          f"mfu {mfu:.3f} of {peaks[2] / 1e12:.0f} TFLOP/s dense bf16 (that "
          f"peak's bound: {bound_s * 1e3:.1f} ms/step); peak device memory "
          f"{peak:.2f} GB [{card}]")
    print(f"train losses: {[round(x, 4) for x in losses]}; active clients "
          f"{run['active']}; weight sums {[round(x, 3) for x in run['wsum']]}")
    profile_report(torch, "train step", "step", run["prof"], run["wall_us"], 1)
    del run

    # Scheduler decisions of alg1 on periodic arrivals; batches from the
    # driver's token stream.
    deterministic(torch, True)
    (mask, scale), decisions, k_draw = alg1_decisions(torch, rt, FLAT_STEPS)
    lm = rt.data.make_lm_tokens(0, 512, TRAIN_SEQ, cfg.vocab)
    batcher = rt.data.GlobalBatcher({"raw": lm.tokens}, TRAIN_CLIENTS,
                                    TRAIN_BATCH, device=DEVICE)
    client = int((mask == 0).nonzero()[0])
    drawn = batcher.sample(rt.random.fold_in(k_draw, 1000))
    raw, ids = drawn["raw"], drawn["client_ids"]
    other, n_rows = replace_rows(torch, raw, ids, client, cfg.vocab)
    t0 = time.perf_counter()
    kept, got, first_loss, changed_loss = two_updates(
        torch, rt, cfg, params, lm_batch(raw, ids), lm_batch(other, ids), mask,
        scale)
    moved = update_moved(kept, got)
    del kept, got
    check(moved[0][0] == moved[1][0] == 0, f"train: client {client} is masked, yet its tokens changed "
          f"the update")
    print(f"train masked client: mask {mask.tolist()}, client {client}'s "
          f"{n_rows} sequences replaced by other random tokens "
          f"(mean loss {first_loss:.4f} -> {changed_loss:.4f}): the adamw "
          f"update (params and first moment) bitwise the same, deterministic "
          f"algorithms on; 2 steps in {time.perf_counter() - t0:.1f} s")

    # The flat SGD route: one K2 launch a step at P = LM_PARAMS, bf16,
    # against the same steps through K2's plain version.
    batches = [lm_batch(b["raw"], b["client_ids"])
               for b in (batcher.sample(rt.random.fold_in(k_draw, 2000 + i))
                         for i in range(FLAT_STEPS))]
    flat_launches, n_el = flat_sgd_check(torch, rt, ops, cfg, params, batches,
                                         decisions, "train", card)

    # K2 alone at the route's shape: a one-row (1, P) bf16 stack.
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    g = torch.randn(1, n_el, device=DEVICE, dtype=torch.bfloat16, generator=gen)
    pp = torch.randn(n_el, device=DEVICE, dtype=torch.bfloat16, generator=gen)
    w = torch.ones(1, device=DEVICE)
    eta = torch.tensor(FLAT_LR, device=DEVICE)
    k2_err = (ops.masked_scaled_aggregate_update(g, w, eta, pp).float()
              - ref.masked_scaled_aggregate_update_ref(g, w, eta, pp).float()
              ).abs().max().item()
    check(k2_err <= 2 ** -8 * pp.float().abs().max().item(),
          f"K2 at the one-row shape: {k2_err} from its plain version")
    flush = flush_buffer(torch)
    fns = (lambda: ops.masked_scaled_aggregate_update(g, w, eta, pp),
           lambda: ref.masked_scaled_aggregate_update_ref(g, w, eta, pp),
           lambda: torch.add(pp, g[0], alpha=-FLAT_LR))
    t = [time_ms(torch, fn, flush, n=K2_TRAIN_LAUNCHES) for fn in fns]
    nbytes, nflops = 2 * 3 * n_el + 8, 4 * n_el
    bound_b, bound_f = nbytes / peaks[0] * 1e3, nflops / peaks[1] * 1e3
    k2_train = {"shape": f"N=1 P={n_el} bf16", "ms": t[0][0],
                "warm_ms": t[0][1], "plain_ms": t[1][0],
                "plain_warm_ms": t[1][1], "library_ms": t[2][0],
                "library_warm_ms": t[2][1], "bound_ms": max(bound_b, bound_f),
                "bound_by": "bytes" if bound_b >= bound_f else "operations",
                "max_abs_err": k2_err}
    print(f"time k2 one-row train shape (N=1, P={n_el:,}, bf16; L2 flushed | "
          f"warm, ms): kernel {t[0][0]:.4f} | {t[0][1]:.4f}, plain "
          f"{t[1][0]:.4f} | {t[1][1]:.4f}, torch.add {t[2][0]:.4f} | "
          f"{t[2][1]:.4f}, bound {k2_train['bound_ms']:.4f} "
          f"({nbytes / 1e9:.2f} GB; {nbytes / t[0][0] / 1e6:.0f} GB/s "
          f"achieved flushed) [{card}]")
    del g, pp, flush
    torch.cuda.empty_cache()

    resume = resume_check(torch, rt, card, phase_t0)
    return {"flat_sgd": flat_launches}, k2_train, resume


def resume_check(torch, rt, card, phase_t0):
    """The train phase's resume check: a straight run against one halted
    and resumed in a child process, deterministic, at full width cut to
    RESUME_LAYERS layers. Returns the child, still writing the driver's
    final checkpoint (:func:`finish_resume`)."""
    from repro_torch.launch import train as train_mod

    # The child reports its losses and final params after its last
    # step; the driver's final checkpoint is then written while the next
    # phase runs (finish_resume).
    deterministic(torch, True)
    cfg2 = resume_cfg(rt)
    final, stamp = {}, {}

    def keep_last(step, state, metrics):
        if step == RESUME_STEPS - 1:
            final["params"] = state.params

    def at_halt(step, state, metrics):
        torch.cuda.synchronize()
        stamp["t"] = time.perf_counter()

    # The child loads while the straight and halted runs go; its error
    # stream goes to a file, so it cannot fill a pipe while the child
    # writes its final checkpoint unread.
    child_err = tempfile.TemporaryFile("w+")
    train_proc = spawn_child("--train-child", stderr=child_err)
    t0 = time.perf_counter()
    straight = train_mod.main(train_argv(RESUME_STEPS), cfg=cfg2,
                              on_step=keep_last)
    straight_s = time.perf_counter() - t0
    want_sha = params_sha256(torch, final.pop("params"))
    tmp = tempfile.TemporaryDirectory()
    ckdir = os.path.join(tmp.name, "halted")
    halted = train_mod.main(
        train_argv(RESUME_STEPS, "--checkpoint-dir", ckdir, "--halt-at",
                   str(RESUME_HALT)), cfg=cfg2, on_step=at_halt)
    write_ms = (time.perf_counter() - stamp["t"]) * 1e3
    mb = os.path.getsize(os.path.join(ckdir, f"step_{RESUME_HALT}.npz")) / 1e6
    # The child shares the card: hand it the memory this process holds
    # cached.
    torch.cuda.empty_cache()
    t_hand = time.perf_counter()
    train_proc.stdin.write(ckdir + "\n")
    train_proc.stdin.flush()
    resumed = None
    for line in train_proc.stdout:
        if line.startswith(RESUMED_MARK):
            resumed = json.loads(line[len(RESUMED_MARK):])
            break
    child_s = time.perf_counter() - t_hand
    if resumed is None:
        train_proc.wait(timeout=60)
        child_err.seek(0)
        check(False, f"train resume: the child exited "
              f"{train_proc.returncode} before its last step:\n"
              f"{child_err.read()[-3000:]}")
    check(halted == straight[:RESUME_HALT]
          and resumed["losses"] == straight[RESUME_HALT:],
          f"train resume: losses {halted} + {resumed['losses']} against "
          f"{straight}")
    check(resumed["params_sha256"] == want_sha,
          "train resume: the resumed run's final params differ from the "
          "straight run's")
    deterministic(torch, False)
    print(f"train resume: {cfg2.name} at full width cut to {RESUME_LAYERS} "
          f"layers, deterministic: a straight {RESUME_STEPS}-step run "
          f"({straight_s:.1f} s) against one "
          f"halted at {RESUME_HALT} (checkpoint {mb:.1f} MB, written in "
          f"{write_ms:.0f} ms from the card: device to host, npz, fsync, "
          f"rename) and resumed in a child process (its last step "
          f"{child_s:.1f} s after it was handed the directory: "
          + ", ".join(f"{k} {v:.1f}" for k, v in resumed["times"].items())
          + f"): loss streams bitwise equal, final params' sha256 equal; "
          f"the phase took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    torch.cuda.empty_cache()
    resume = {"proc": train_proc, "err": child_err, "tmp": tmp,
              "ckdir": ckdir, "t": time.perf_counter()}
    return resume


def finish_resume(resume, card):
    """Wait for the train phase's resume child to write the driver's
    final checkpoint and exit 0."""
    proc = resume["proc"]
    t0 = time.perf_counter()
    try:
        proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    waited = time.perf_counter() - t0
    err = resume["err"]
    err.seek(0)
    check(proc.returncode == 0, f"train resume: the child exited "
          f"{proc.returncode}:\n{err.read()[-3000:]}")
    err.close()
    path = os.path.join(resume["ckdir"], f"step_{RESUME_STEPS}.npz")
    check(os.path.exists(path), f"train resume: no final checkpoint {path}")
    with open(os.path.join(resume["ckdir"], "child_times.json")) as f:
        times = json.load(f)
    mb = os.path.getsize(path) / 1e6
    resume["tmp"].cleanup()
    print(f"train resume: the child wrote the driver's final checkpoint "
          f"({mb:.1f} MB) in {times['final_write_s']:.1f} s and exited 0 "
          f"while the phases after the train phase ran "
          f"({time.perf_counter() - resume['t']:.1f} s of them); this "
          f"process then waited {waited:.1f} s for it [{card}]")


# Recurrent phase: zamba2-2.7b and xlstm-1.3b at full width, each with
# the K4 and K3 launches one prefill must make (a Mamba2 or mLSTM layer
# one K4 call; zamba2's shared attention block one K3 call a
# super-block) and its parameter count.
REC_MODELS = (
    ("zamba2-2.7b", 9 * 5, 9, 2_063_676_080),
    ("xlstm-1.3b", 6 * 7, 0, 2_012_002_640),
)
# Timed prefills after the counted one, decode prompt, cache slots and
# greedy steps.
REC_TIMED, REC_PROMPT, REC_CACHE, REC_GREEDY = 1, 64, 256, 16
# The kernel route in f32 against the f32 reference: K4's 3xTF32 products
# (about 2**-20 each) and K3's f32 path sum in other orders than
# chunked_gla and the plain attention, through 48-54 layers (the "rec f32
# kernels" lines of an H100 run read 1e-5 to 1e-3 of max|logit|, PERF.md
# §6).
REC_F32_TOL = 1e-2


def timed(torch, fn):
    """``fn()`` and its wall ms, the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def recurrent_model(torch, rt, fa_ops, ssm_ops, card, name, n_k4, n_k3,
                    n_params):
    """One recurrent model at full width: the kernel prefill counted and
    timed, the plain bf16 and the f32 reference prefills, decode replay
    and greedy decode, the profile. Returns the counted launches."""
    from repro_torch._tree import tree_map
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import ssm, transformer

    cfg = rt.configs.get_config(name).replace(use_flash=True)
    plain_cfg = cfg.replace(use_flash=False)
    ref_cfg = plain_cfg.replace(dtype_name="float32")
    t0_model = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = transformer.init_lm(rt.random.PRNGKey(0, device=DEVICE), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    count = rt.models.count_params(params)
    check(count == n_params, f"{name} has {count} parameters, not {n_params}")
    layout = ", ".join(f"{k} x{c}{' shared' if sh else ''}"
                       for k, c, sh in cfg.resolved_superblock)
    print(f"rec init: {name} at full width ({cfg.n_super} super-blocks of "
          f"{layout}; d_model {cfg.d_model}, vocab {cfg.vocab}), {count:,} "
          f"parameters ({2 * count / 1e9:.2f} GB bf16) in {init_s:.1f} s "
          f"[{card}]")

    data = rt.data.make_lm_tokens(0, LM_BATCH, LM_SEQ, cfg.vocab).tokens
    tokens = torch.from_numpy(data[:, :LM_SEQ]).to(DEVICE)
    prompt = tokens[:, :REC_PROMPT]
    prefill = make_prefill_step(cfg)
    plain = make_prefill_step(plain_cfg)
    reference = make_prefill_step(ref_cfg)
    kernel32 = make_prefill_step(cfg.replace(dtype_name="float32"))

    with torch.no_grad():
        # The main path: one kernel prefill, counted from 0.
        fa_ops.reset_launch_counts()
        ssm_ops.reset_launch_counts()
        flash, first_ms = timed(torch, lambda: prefill(params, {"tokens": tokens}))
        launches = {"gla_scan": ssm_ops.launch_counts["gla_scan"],
                    "flash_attention": fa_ops.launch_counts["flash_attention"]}
        check(launches == {"gla_scan": n_k4, "flash_attention": n_k3},
              f"{name} prefill launches {launches}, expected {n_k4} K4 and "
              f"{n_k3} K3")
        check(flash.shape == (LM_BATCH, cfg.vocab)
              and bool(torch.isfinite(flash).all()),
              f"{name} kernel prefill logits not finite or of the wrong shape")
        ms = [first_ms] + [timed(torch, lambda: prefill(params, {"tokens": tokens}))[1]
                           for _ in range(REC_TIMED)]
        print(f"rec prefill {name} (use_flash: K4, K3): B={LM_BATCH} "
              f"S={LM_SEQ}: " + " ".join(f"{m:.2f}" for m in ms)
              + f" ms (the first counted: {n_k4} K4 and {n_k3} K3 launches), "
              f"{LM_BATCH * LM_SEQ / min(ms[1:]) * 1e3:,.0f} tokens/s (best "
              f"timed) [{card}]")

        plain_logits, plain_ms = timed(torch, lambda: plain(params, {"tokens": tokens}))
        plain_prompt = plain(params, {"tokens": prompt})
        params32 = tree_map(lambda x: x.float(), params)
        ref_logits, ref_ms = timed(torch, lambda: reference(params32, {"tokens": tokens}))
        ref_prompt = reference(params32, {"tokens": prompt})
        k32_logits = kernel32(params32, {"tokens": tokens})
        del params32
    torch.cuda.empty_cache()
    floor = dist(plain_logits, ref_logits)
    err = dist(flash, ref_logits)
    agree, rows = argmax_agrees(flash, ref_logits, floor)
    check(err <= 2 * floor, f"{name} kernel prefill {err:.4g} from the f32 "
          f"reference, above 2x the bf16 floor {floor:.4g}")
    check(agree, f"{name} kernel prefill argmax differs from the f32 "
          f"reference on a row whose top-two gap exceeds 2x the floor")
    print(f"rec reference {name}: plain bf16 prefill (chunked_gla, plain "
          f"attention) {plain_ms:.2f} ms, f32 reference {ref_ms:.2f} ms; "
          f"last-position logits (max |logit| "
          f"{ref_logits.abs().max().item():.3g}) from the f32 reference: plain "
          f"bf16 {floor:.4g} (the floor), kernel {err:.4g} (<= 2x floor); "
          f"argmax agrees on all {rows} of {LM_BATCH} rows whose top-two gap "
          f"exceeds 2x the floor [{card}]")
    # The rule's floor is wide here (bf16 rounding through 48-54 layers),
    # so the kernels are also held in f32, against the same reference.
    top = ref_logits.abs().max().item()
    err32 = dist(k32_logits, ref_logits)
    agree, rows = argmax_agrees(k32_logits, ref_logits, err32)
    check(err32 <= REC_F32_TOL * top and agree,
          f"{name} f32 kernel prefill {err32:.4g} from the f32 reference "
          f"(bound {REC_F32_TOL} x {top:.4g}), argmax agrees {agree}")
    print(f"rec f32 kernels {name}: the kernel route (K4, K3 in f32) with "
          f"the f32 weights {err32:.4g} from the f32 reference "
          f"({err32 / top:.3g} of max|logit|, bound {REC_F32_TOL}); argmax "
          f"agrees on all {rows} of {LM_BATCH} rows whose top-two gap "
          f"exceeds 2x that [{card}]")

    serve = make_serve_step(cfg)
    states = transformer.init_decode_state(
        cfg, LM_BATCH, transformer.decode_cache_len(cfg, REC_CACHE),
        device=DEVICE)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(REC_PROMPT):
            nxt, logits, states = serve(params, prompt[:, pos:pos + 1],
                                        states, pos)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) / REC_PROMPT * 1e3
    floor_p = dist(plain_prompt, ref_prompt)
    err_p = dist(logits, ref_prompt)
    agree, rows = argmax_agrees(logits, ref_prompt, floor_p)
    check(err_p <= 2 * floor_p, f"{name} decode at position {REC_PROMPT - 1}: "
          f"{err_p:.4g} from the f32 reference, above 2x the floor {floor_p:.4g}")
    check(agree, f"{name} decode argmax differs from the f32 reference on a "
          f"row whose top-two gap exceeds 2x the floor")
    print(f"rec decode replay {name}: {REC_PROMPT} prompt tokens one at a time "
          f"through make_serve_step (cache {REC_CACHE}), {replay_ms:.2f} "
          f"ms/step; logits at position {REC_PROMPT - 1} from the f32 "
          f"reference prefill of those tokens {err_p:.4g} (<= 2x the floor "
          f"{floor_p:.4g}); argmax agrees on all {rows} rows above 2x the "
          f"floor [{card}]")

    tok, first = nxt[:, None], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(REC_PROMPT, REC_PROMPT + REC_GREEDY):
            nxt, logits, states = serve(params, tok, states, pos)
            tok = nxt[:, None]
            first.append(nxt)
        torch.cuda.synchronize()
        greedy_ms = (time.perf_counter() - t0) / REC_GREEDY * 1e3
    check(bool(torch.isfinite(logits).all()), f"{name} decode logits not finite")
    print(f"rec decode {name}: {REC_GREEDY} greedy steps at positions "
          f"{REC_PROMPT}..{REC_PROMPT + REC_GREEDY - 1}, {greedy_ms:.2f} ms/step "
          f"({LM_BATCH * 1e3 / greedy_ms:.0f} tokens/s); tokens of row 0: "
          f"{[int(t[0]) for t in first[:8]]} [{card}]")

    with torch.no_grad():
        rows, busy_us = profile(torch, f"rec prefill {name}", "prefill",
                                lambda: prefill(params, {"tokens": tokens}), 1,
                                cpu=False)
    share = lambda *keys: 100 * sum(us for n, us, _ in rows
                                    if any(k in n for k in keys)) / busy_us
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"rec phase {name}: K4 (gla_scores, gla_walk) {share('gla_'):.1f} % "
          f"and K3 {share('flash_attention'):.1f} % of the prefill's device "
          f"time; peak device memory {peak:.2f} GB; {time.perf_counter() - t0_model:.1f} s "
          f"[{card}]")
    del params, states
    ssm.release_slstm_graphs()
    torch.cuda.empty_cache()
    return launches


def recurrent_phase(torch, rt, fa_ops, ssm_ops, card):
    """zamba2-2.7b and xlstm-1.3b served at full width (random bf16 weights
    from seed 0), each prefill counted: K4 on every Mamba2 and mLSTM
    layer, K3 on zamba2's shared attention (Dh = 80)."""
    phase_t0 = time.perf_counter()
    counts = {name: recurrent_model(torch, rt, fa_ops, ssm_ops, card, name,
                                    *rest)
              for name, *rest in REC_MODELS}
    print(f"rec phase: took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    return counts


# Zoo phase: the five decoder-only configs at full width, each at the
# depth one card holds with its f32 copy for the reference (the bf16
# weights, then 2x them in f32): name, layers on the card, parameters at
# that depth. The decode prompt, cache and greedy steps are REC_*'s.
ZOO_MODELS = (
    ("minitron-4b", 32, 4_190_309_376),
    ("deepseek-coder-33b", 4, 2_583_755_776),
    ("command-r-35b", 4, 7_013_023_744),
    ("phi3.5-moe-42b-a6.6b", 6, 8_064_520_192),
    ("llama4-scout-17b-a16e", 3, 8_675_281_920),
)
ZOO_PROFILED = "phi3.5-moe-42b-a6.6b"
# The MoE layer's parts, each a torch.profiler range in
# repro_torch/models/moe.py.
MOE_RANGES = ("moe_router", "moe_dispatch", "moe_experts", "moe_combine")
# Dropped shares of a prefill's (token, k) assignments. A router that
# sends every token to one set of top-k experts drops 1 - 1.25 k / 16 at
# a capacity of 1.25x the mean load: 84 % (phi3.5) or 92 % (llama4). The
# Zipf-Markov tokens of make_lm_tokens repeat their most frequent ids,
# and a repeated id routes alike, so their prefill drops 36-45 % (an
# H100 run, PERF.md §6); tokens drawn uniformly over the vocabulary are
# the measure of the router itself.
ZOO_MAX_DROPPED = 0.75
ZOO_MAX_UNIFORM_DROPPED = 0.25


def flipped_rows(torch, log_a, log_b, n_layers):
    """The rows of the batch whose last token two runs routed differently:
    in one of the last ``n_layers`` entries of their ``moe.routing_log``
    (a prefill's layers, or a replay's last step) a chosen expert or a
    drop differs. All False for a dense model (empty logs)."""
    rows = torch.zeros(LM_BATCH, dtype=torch.bool, device=DEVICE)
    for (ea, ka), (eb, kb) in zip(log_a[-n_layers:], log_b[-n_layers:]):
        rows |= ((ea != eb) | (ka != kb)).any(-1).reshape(LM_BATCH, -1)[:, -1]
    return rows


def routing_diffs(torch, log_a, log_b):
    """For each row of the batch, how many (layer, position) or (step,
    layer) entries of two routing logs route it differently."""
    counts = torch.zeros(LM_BATCH, dtype=torch.int64, device=DEVICE)
    for (ea, ka), (eb, kb) in zip(log_a, log_b):
        counts += ((ea != eb) | (ka != kb)).any(-1).reshape(
            LM_BATCH, -1).sum(-1)
    return counts.tolist()


def hold_unflipped(label, rows, flips, floor_rows, floor_flips, least, card):
    """The reference rule on the rows that no routing flip moved: the
    largest distance of ``rows`` outside ``flips`` within 2x the largest
    of ``floor_rows`` outside ``floor_flips``, each taken over at least
    ``least`` rows. Returns (distance, floor)."""
    n, n_floor = int((~flips).sum()), int((~floor_flips).sum())
    err = rows[~flips].max().item() if n else float("inf")
    floor = floor_rows[~floor_flips].max().item() if n_floor else 0.0
    print(f"{label}: row distances {[round(x, 4) for x in rows.tolist()]}, "
          f"a flip moved rows {flips.nonzero()[:, 0].tolist()}; the floor's "
          f"{[round(x, 4) for x in floor_rows.tolist()]}, flipped "
          f"{floor_flips.nonzero()[:, 0].tolist()}; largest of the {n} rows "
          f"held {err:.4g} <= 2x the floor {floor:.4g} (largest of {n_floor} "
          f"rows) [{card}]")
    check(n >= least and n_floor >= least, f"{label}: routing flips moved "
          f"{LM_BATCH - n} of {LM_BATCH} rows ({LM_BATCH - n_floor} on the "
          f"floor's route), more than {LM_BATCH - least}")
    check(err <= 2 * floor, f"{label}: {err:.4g} on the rows held, above 2x "
          f"the bf16 floor {floor:.4g}")
    return err, floor


def dispatch_layers(torch, log, n_experts):
    """Each layer's dropped share, its busiest expert's load over the mean
    load, and the number of experts it routed to, from a routing log."""
    out = []
    for top_e, keep in log:
        load = torch.bincount(top_e.reshape(-1), minlength=n_experts)
        out.append(((~keep).float().mean().item(),
                    load.max().item() * n_experts / top_e.numel(),
                    int((load > 0).sum())))
    return out


def moe_profile(torch, label, fn, card):
    """One call of ``fn`` under ``torch.profiler`` (host and device, the
    host's operator tree gives each kernel its MoE range): the device
    time of K3, of each range of ``MOE_RANGES`` and of the rest, and
    their shares of the device's busy time."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel rows only; a range's own device-side row is not a kernel.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in MOE_RANGES]
    busy_us = sum(r[1] for r in rows)
    check(busy_us > 0, f"profile {label}: the profiler saw no device time")
    parts = {name: sum(e.device_time_total for e in prof.events()
                       if e.name == name
                       and e.device_type == torch.autograd.DeviceType.CPU)
             for name in MOE_RANGES}
    parts["K3"] = sum(us for n, us, _ in rows if "flash_attention" in n)
    rest = busy_us - sum(parts.values())
    print(f"profile {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f} % of wall), "
          f"{sum(r[2] for r in rows)} device ops [{card}]")
    for name, us in list(parts.items()) + [("rest", rest)]:
        print(f"profile {label}:   {name:<13} {us / 1e3:9.3f} ms "
              f"{100 * us / busy_us:5.1f} %")
    for name, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"profile {label}:   top kernel {100 * us / busy_us:5.1f} %  "
              f"{us / 1e3:8.3f} ms  x{count:<5} {name[:80]}")


def zoo_model(torch, rt, fa_ops, card, name, n_layers, n_params):
    """One decoder-only config at full width and ``n_layers`` layers: the
    K3 prefill counted and timed, the plain bf16, f32 reference and f32
    kernel-route prefills, the MoE dispatch's dropped shares, decode
    replay and greedy decode. Returns the counted K3 launches."""
    from repro_torch._tree import tree_map
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import moe, transformer

    cfg = rt.configs.get_config(name).replace(n_layers=n_layers, use_flash=True)
    plain_cfg = cfg.replace(use_flash=False)
    ref_cfg = plain_cfg.replace(dtype_name="float32")
    is_moe = cfg.n_experts > 0
    t0_model = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = timed(torch, lambda: transformer.init_lm(
        rt.random.PRNGKey(0, device=DEVICE), cfg))
    count = rt.models.count_params(params)
    check(count == n_params, f"{name} has {count} parameters, not {n_params}")
    moe_text = (f", {cfg.n_experts} experts top-{cfg.top_k}"
                f"{' + a shared expert' if cfg.shared_expert else ''}, "
                f"capacity factor {cfg.moe_capacity_factor}" if is_moe else "")
    print(f"zoo init: {name} at full width, {n_layers} of "
          f"{rt.configs.get_config(name).n_layers} layers (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv heads "
          f"of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          f"{moe_text}), {count:,} parameters ({2 * count / 1e9:.2f} GB bf16) "
          f"in {init_ms / 1e3:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")

    data = rt.data.make_lm_tokens(0, LM_BATCH, LM_SEQ, cfg.vocab).tokens
    tokens = torch.from_numpy(data[:, :LM_SEQ]).to(DEVICE)
    prompt = tokens[:, :REC_PROMPT]
    prefill = make_prefill_step(cfg)
    plain = make_prefill_step(plain_cfg)
    reference = make_prefill_step(ref_cfg)
    kernel32 = make_prefill_step(cfg.replace(dtype_name="float32"))
    shares, logs = {}, {}

    def dropped(label, fn):
        """``fn()`` with the MoE dispatch counted and every layer's
        routing logged, both kept under ``label``."""
        moe.reset_dispatch_counts()
        moe.routing_log = []
        try:
            out = fn()
        finally:
            logs[label], moe.routing_log = moe.routing_log, None
        shares[label] = moe.dropped_share()
        return out

    with torch.no_grad():
        # The main path: one K3 prefill, counted from 0.
        fa_ops.reset_launch_counts()
        flash, first_ms = dropped("prefill", lambda: timed(
            torch, lambda: prefill(params, {"tokens": tokens})))
        launches = fa_ops.launch_counts["flash_attention"]
        check(launches == n_layers, f"{name} prefill: {launches} K3 launches, "
              f"expected {n_layers}")
        check(flash.shape == (LM_BATCH, cfg.vocab)
              and bool(torch.isfinite(flash).all()),
              f"{name} K3 prefill logits not finite or of the wrong shape")
        ms = [first_ms] + [timed(torch, lambda: prefill(
            params, {"tokens": tokens}))[1] for _ in range(REC_TIMED)]
        print(f"zoo prefill {name} (use_flash: K3): B={LM_BATCH} S={LM_SEQ}: "
              + " ".join(f"{m:.2f}" for m in ms) + f" ms (the first counted: "
              f"{launches} K3 launches), {LM_BATCH * LM_SEQ / min(ms[1:]) * 1e3:,.0f} "
              f"tokens/s (best timed) [{card}]")

        plain_logits, plain_ms = dropped("plain", lambda: timed(
            torch, lambda: plain(params, {"tokens": tokens})))
        plain_prompt = dropped("plain prompt", lambda: plain(
            params, {"tokens": prompt}))
        params32 = tree_map(lambda x: x.float(), params)
        ref_logits, ref_ms = dropped("reference", lambda: timed(
            torch, lambda: reference(params32, {"tokens": tokens})))
        ref_prompt = dropped("reference prompt", lambda: reference(
            params32, {"tokens": prompt}))
        k32_logits = kernel32(params32, {"tokens": tokens})
        if not is_moe:
            del params32
    torch.cuda.empty_cache()
    # The reference rule, on the last position's logits. An MoE router
    # flips an expert where two of its logits nearly tie, in one route and
    # not the other, and moves that token's output by a whole expert's.
    # So a row whose last token the two routes sent to other experts, or
    # dropped in one and not the other, in any layer, is not held; every
    # other row is, on its largest distance, and at least half the rows
    # must be held. A dense model has no flips: every row is held.
    top = ref_logits.abs().max().item()
    print(f"zoo reference {name}: plain bf16 prefill {plain_ms:.2f} ms, f32 "
          f"reference {ref_ms:.2f} ms; last-position logits (max |logit| "
          f"{top:.3g}) from the f32 reference [{card}]")
    held = ~flipped_rows(torch, logs["prefill"], logs["reference"], n_layers)
    _, floor = hold_unflipped(
        f"zoo reference {name}", row_dists(flash, ref_logits), ~held,
        row_dists(plain_logits, ref_logits),
        flipped_rows(torch, logs["plain"], logs["reference"], n_layers),
        LM_BATCH // 2, card)
    agree, rows = argmax_agrees(flash[held], ref_logits[held], floor)
    print(f"zoo reference {name}: argmax agrees {agree} on the {rows} rows "
          f"held whose top-two gap exceeds 2x the floor [{card}]")
    check(agree, f"{name} K3 prefill argmax differs from the f32 reference "
          f"on a row whose top-two gap exceeds 2x the floor")
    err32 = dist(k32_logits, ref_logits)
    agree, rows = argmax_agrees(k32_logits, ref_logits, err32)
    print(f"zoo f32 kernels {name}: the K3 route in f32 with the f32 weights "
          f"{err32:.4g} from the f32 reference ({err32 / top:.3g} of "
          f"max|logit|, bound {REC_F32_TOL}); argmax agrees {agree} on the "
          f"{rows} of {LM_BATCH} rows whose top-two gap exceeds 2x that "
          f"[{card}]")
    check(err32 <= REC_F32_TOL * top and agree,
          f"{name} f32 K3 prefill {err32:.4g} from the f32 reference "
          f"(bound {REC_F32_TOL} x {top:.4g}), argmax agrees {agree}")

    serve = make_serve_step(cfg)
    cache_len = transformer.decode_cache_len(cfg, REC_CACHE)

    def replay(c, p):
        """The prompt fed token by token through ``c``'s serve step."""
        step = make_serve_step(c)
        states = transformer.init_decode_state(c, LM_BATCH, cache_len,
                                               device=DEVICE)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for pos in range(REC_PROMPT):
                nxt, logits, states = step(p, prompt[:, pos:pos + 1], states,
                                           pos)
            torch.cuda.synchronize()
        return nxt, logits, states, (time.perf_counter() - t0) / REC_PROMPT * 1e3

    # A dense model's decode is held against the f32 prefill of its
    # prompt by the rule above. An MoE decode step routes the batch's 8
    # tokens with a capacity of 8·k·1.25 // 16 = 1 an expert (the
    # prefill's: 1,280 or more): most assignments drop, by the JAX
    # package's semantics, and the 8 rows compete for the experts, so a
    # flip in one row can drop another row's assignment, and the flips
    # of earlier steps stay in the cache. So the replays are held in two
    # steps, each by the rule above. First at a capacity that drops
    # nothing (factor n_experts): the bf16 replay against an f32 replay
    # through the same serve step, on the rows whose last step the two
    # routed alike (at least half), within 2x the floor of the prompt's
    # bf16 prefill at that capacity; and the f32 replay within
    # REC_F32_TOL of the f32 prefill of the prompt (decode equals prefill
    # without drops, the moe case of tests/test_decode_consistency.py).
    # Then at capacity 1: the bf16 replay against the f32 replay on the
    # rows whose last step the two routed alike (at least 2), within 2x
    # the largest distance of a bf16 replay from an f32 one without drops
    # on the rows held there.
    nxt, logits, states, replay_ms = dropped(
        "decode", lambda: replay(cfg, params))
    if is_moe:
        _, logits32, _, ref_replay_ms = dropped(
            "f32 decode", lambda: replay(ref_cfg, params32))
        whole = dict(moe_capacity_factor=float(cfg.n_experts))
        c16, c32 = cfg.replace(**whole), ref_cfg.replace(**whole)
        with torch.no_grad():
            want = dropped("whole reference prompt", lambda: make_prefill_step(
                c32)(params32, {"tokens": prompt}))
            whole_plain = dropped("whole plain prompt", lambda: make_prefill_step(
                plain_cfg.replace(**whole))(params, {"tokens": prompt}))
        _, got16, _, _ = dropped("whole decode", lambda: replay(c16, params))
        _, got32, _, _ = dropped("whole f32 decode",
                                 lambda: replay(c32, params32))
        check(shares["whole decode"] == shares["whole f32 decode"] == 0.0,
              f"{name}: a replay at capacity factor {cfg.n_experts} dropped "
              f"assignments")
        del params32
        torch.cuda.empty_cache()
        print(f"zoo decode without drops {name}: capacity factor "
              f"{cfg.n_experts}, the replays' logits at position "
              f"{REC_PROMPT - 1}, bf16 from f32 [{card}]")
        whole_rows = row_dists(got16, got32)
        whole_flips = flipped_rows(torch, logs["whole decode"],
                                   logs["whole f32 decode"], n_layers)
        hold_unflipped(
            f"zoo decode without drops {name}", whole_rows, whole_flips,
            row_dists(whole_plain, want),
            flipped_rows(torch, logs["whole plain prompt"],
                         logs["whole reference prompt"], n_layers),
            LM_BATCH // 2, card)
        err32, top_p = dist(got32, want), want.abs().max().item()
        agree, rows = argmax_agrees(got32, want, err32)
        print(f"zoo decode without drops {name}: f32 from the f32 prefill of "
              f"the prompt {err32:.4g} ({err32 / top_p:.3g} of max|logit|, "
              f"bound {REC_F32_TOL}), argmax agrees {agree} on {rows} rows "
              f"[{card}]")
        check(err32 <= REC_F32_TOL * top_p and agree,
              f"{name} f32 decode without drops {err32:.4g} from the f32 "
              f"prefill (bound {REC_F32_TOL} x {top_p:.4g})")
        print(f"zoo decode replay {name}: {REC_PROMPT} prompt tokens one at a "
              f"time through make_serve_step (cache {cache_len}), "
              f"{replay_ms:.2f} ms/step; logits at position {REC_PROMPT - 1} "
              f"from an f32 replay ({ref_replay_ms:.2f} ms/step), the floor "
              f"the replays without drops; (step, layer) entries routed "
              f"otherwise, a row: {routing_diffs(torch, logs['decode'], logs['f32 decode'])}"
              f" of {REC_PROMPT * n_layers} [{card}]")
        held = ~flipped_rows(torch, logs["decode"], logs["f32 decode"],
                             n_layers)
        _, floor_d = hold_unflipped(
            f"zoo decode replay {name}", row_dists(logits, logits32), ~held,
            whole_rows, whole_flips, 2, card)
        agree, rows = argmax_agrees(logits[held], logits32[held], floor_d)
        print(f"zoo decode replay {name}: argmax agrees {agree} on the {rows} "
              f"rows held whose top-two gap exceeds 2x the floor [{card}]")
        check(agree, f"{name} decode argmax differs from the f32 replay on a "
              f"row held whose top-two gap exceeds 2x the floor")
    else:
        floor_p = dist(plain_prompt, ref_prompt)
        err_p = dist(logits, ref_prompt)
        agree, rows = argmax_agrees(logits, ref_prompt, floor_p)
        print(f"zoo decode replay {name}: {REC_PROMPT} prompt tokens one at a "
              f"time through make_serve_step (cache {cache_len}), "
              f"{replay_ms:.2f} ms/step; logits at position {REC_PROMPT - 1} "
              f"from the f32 reference prefill of those tokens {err_p:.4g} "
              f"(<= 2x the floor {floor_p:.4g}); argmax agrees {agree} on the "
              f"{rows} rows above 2x the floor [{card}]")
        check(err_p <= 2 * floor_p, f"{name} decode at position "
              f"{REC_PROMPT - 1}: {err_p:.4g} from the f32 reference, above "
              f"2x the floor {floor_p:.4g}")
        check(agree, f"{name} decode argmax differs from the f32 reference "
              f"on a row whose top-two gap exceeds 2x the floor")

    tok, first = nxt[:, None], []
    # The ep phase's one-rank run: phi3.5's greedy steps' routing too.
    moe.routing_log = [] if name == EP_MODEL else None
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(REC_PROMPT, REC_PROMPT + REC_GREEDY):
            nxt, logits, states = serve(params, tok, states, pos)
            tok = nxt[:, None]
            first.append(nxt)
        torch.cuda.synchronize()
        greedy_ms = (time.perf_counter() - t0) / REC_GREEDY * 1e3
    greedy_log, moe.routing_log = moe.routing_log, None
    if name == EP_MODEL:
        ep_keep(torch, flash, logs["prefill"],
                logs["decode"] + greedy_log[:EP_GREEDY * n_layers],
                torch.stack(first[:EP_GREEDY]), floor, shares["prefill"])
    check(bool(torch.isfinite(logits).all()), f"{name} decode logits not finite")
    print(f"zoo decode {name}: {REC_GREEDY} greedy steps at positions "
          f"{REC_PROMPT}..{REC_PROMPT + REC_GREEDY - 1}, {greedy_ms:.2f} ms/step "
          f"({LM_BATCH * 1e3 / greedy_ms:.0f} tokens/s); tokens of row 0: "
          f"{[int(t[0]) for t in first[:8]]} [{card}]")
    if is_moe:
        t_pre = LM_BATCH * LM_SEQ
        caps = [int(max(1, (t * cfg.top_k * cfg.moe_capacity_factor)
                        // cfg.n_experts)) for t in (t_pre, LM_BATCH)]
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        uniform = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), device=DEVICE,
                                generator=gen)
        with torch.no_grad():
            dropped("uniform", lambda: prefill(params, {"tokens": uniform}))
        print(f"zoo moe dispatch {name}: dropped (token, k) assignments: K3 "
              f"prefill {100 * shares['prefill']:.2f} %, f32 reference prefill "
              f"{100 * shares['reference']:.2f} %, K3 prefill of uniform "
              f"tokens {100 * shares['uniform']:.2f} % (capacity {caps[0]} an "
              f"expert of {t_pre * cfg.top_k} assignments); decode replay "
              f"{100 * shares['decode']:.2f} %, f32 replay "
              f"{100 * shares['f32 decode']:.2f} % (capacity {caps[1]} of "
              f"{LM_BATCH * cfg.top_k} a step) [{card}]")
        for label, text in (("prefill", "Zipf-Markov"), ("uniform", "uniform")):
            layers = dispatch_layers(torch, logs[label], cfg.n_experts)
            print(f"zoo moe dispatch {name}: the K3 prefill of {text} tokens, "
                  f"each layer's dropped share | busiest expert's load over "
                  f"the mean | experts used: " + ", ".join(
                      f"{100 * d:.1f} % | {m:.2f} | {u}" for d, m, u in layers)
                  + f" [{card}]")
        check(all(u == cfg.n_experts for _, _, u in layers),
              f"{name}: a layer of the uniform tokens' prefill left an "
              f"expert idle")
        check(shares["prefill"] < ZOO_MAX_DROPPED
              and shares["uniform"] < ZOO_MAX_UNIFORM_DROPPED,
              f"{name}: the prefill dropped {shares['prefill']:.3f} of its "
              f"assignments, {shares['uniform']:.3f} of uniform tokens'")
    if name == ZOO_PROFILED:
        with torch.no_grad():
            moe_profile(torch, f"zoo prefill {name}",
                        lambda: prefill(params, {"tokens": tokens}), card)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"zoo phase {name}: peak device memory {peak:.2f} GB; "
          f"{time.perf_counter() - t0_model:.1f} s [{card}]")
    del params, states
    torch.cuda.empty_cache()
    return launches


def zoo_phase(torch, rt, fa_ops, card):
    """minitron-4b, deepseek-coder-33b, command-r-35b, phi3.5-moe and
    llama4-scout served at full width (random bf16 weights from seed 0),
    each at the depth of ``ZOO_MODELS``: K3 once a layer a prefill."""
    phase_t0 = time.perf_counter()
    counts = {name: zoo_model(torch, rt, fa_ops, card, name, *rest)
              for name, *rest in ZOO_MODELS}
    print(f"zoo phase: took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    return counts


# Multimodal phase: qwen2-vl-2b (M-RoPE, vision tokens) and whisper-tiny
# (the encoder-decoder) at full width and depth: name, K3 launches a
# prefill (one a causal self-attention layer; whisper's encoder and
# cross attention take the plain attention, as in the JAX package),
# parameters, the prefill's length and the decode cache's slots.
# whisper's text context is 448 tokens and its encoder 1,500 frames
# [arXiv:2212.04356]; qwen2-vl's vision tokens are 256 (its config).
MM_MODELS = (
    ("qwen2-vl-2b", 28, 1_777_675_776, LM_SEQ, REC_CACHE),
    ("whisper-tiny", 4, 56_398_080, 448, 448),
)
MM_TIMED = 4


def mm_positions(torch, nv, s):
    """Qwen2-VL's three position rows (temporal, height, width) for a
    sequence whose first ``nv`` tokens are a square grid of patches at
    time 0, the text after it at ``side + i`` in all three rows:
    (3, LM_BATCH, s)."""
    side = math.isqrt(nv)
    check(side * side == nv, f"{nv} vision tokens are no square grid")
    grid = torch.arange(nv, device=DEVICE)
    text = side + torch.arange(s - nv, device=DEVICE)
    rows = torch.stack([torch.cat([r, text]) for r in (
        torch.zeros_like(grid), grid // side, grid % side)])
    return rows[:, None].expand(3, LM_BATCH, s)


def mm_model(torch, rt, fa_ops, card, name, n_k3, n_params, seq, cache):
    """One multimodal config at full width and depth: the K3 prefill (with
    vision embeddings or frames) counted and timed, the plain bf16, f32
    reference and f32 K3-route prefills held by the rule on every row;
    qwen2-vl again with three distinct position rows; whisper's encoder
    alone; decode replay and greedy decode (whisper through the encoder's
    memory); one prefill profiled. Returns the counted K3 launches."""
    import numpy as np

    from repro_torch._tree import tree_map
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer

    cfg = rt.configs.get_config(name).replace(use_flash=True)
    plain_cfg = cfg.replace(use_flash=False)
    ref_cfg = plain_cfg.replace(dtype_name="float32")
    t0_model = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = timed(torch, lambda: transformer.init_lm(
        rt.random.PRNGKey(0, device=DEVICE), cfg))
    count = rt.models.count_params(params)
    check(count == n_params, f"{name} has {count} parameters, not {n_params}")
    layers = (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers"
              if cfg.enc_dec else f"{cfg.n_layers} layers")
    print(f"mm init: {name} at full width and depth ({layers}, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv heads "
          f"of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"{count:,} parameters ({2 * count / 1e9:.2f} GB bf16) in "
          f"{init_ms / 1e3:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")

    data = rt.data.make_lm_tokens(0, LM_BATCH, seq, cfg.vocab).tokens
    tokens = torch.from_numpy(data[:, :seq]).to(DEVICE)
    prompt = tokens[:, :REC_PROMPT]
    rng = np.random.default_rng(1)
    if cfg.enc_dec:
        # Frame embeddings of the stub frontend, unit scale.
        extra = {"audio_feats": torch.from_numpy(rng.standard_normal(
            (LM_BATCH, cfg.enc_len, cfg.d_model)).astype(np.float32)).to(DEVICE)}
        what = f"{cfg.enc_len} frames"
    else:
        # Patch embeddings at the token embedding's scale, d_model**-0.5.
        extra = {"vision_embeds": torch.from_numpy((rng.standard_normal(
            (LM_BATCH, cfg.n_vision_tokens, cfg.d_model))
            * cfg.d_model ** -0.5).astype(np.float32)).to(DEVICE)}
        what = f"{cfg.n_vision_tokens} vision tokens"
    batch = {"tokens": tokens, **extra}
    # The decode prompt: text alone for qwen2-vl (the JAX package's decode
    # step takes no vision tokens), with the frames for whisper.
    prompt_batch = {"tokens": prompt, **(extra if cfg.enc_dec else {})}
    prefill = make_prefill_step(cfg)
    plain = make_prefill_step(plain_cfg)
    reference = make_prefill_step(ref_cfg)
    kernel32 = make_prefill_step(cfg.replace(dtype_name="float32"))

    with torch.no_grad():
        # The main path: one K3 prefill, counted from 0.
        fa_ops.reset_launch_counts()
        flash, first_ms = timed(torch, lambda: prefill(params, batch))
        launches = fa_ops.launch_counts["flash_attention"]
        check(launches == n_k3, f"{name} prefill: {launches} K3 launches, "
              f"expected {n_k3}")
        check(flash.shape == (LM_BATCH, cfg.vocab)
              and bool(torch.isfinite(flash).all()),
              f"{name} K3 prefill logits not finite or of the wrong shape")
        ms = sorted(timed(torch, lambda: prefill(params, batch))[1]
                    for _ in range(MM_TIMED))
        print(f"mm prefill {name} (use_flash: K3) with {what}: B={LM_BATCH} "
              f"S={seq}: first (counted: {launches} K3 launches) "
              f"{first_ms:.2f} ms, then {MM_TIMED} timed: median "
              f"{(ms[1] + ms[2]) / 2:.2f} ms (spread {ms[0]:.2f}-{ms[-1]:.2f}),"
              f" {LM_BATCH * seq / ms[0] * 1e3:,.0f} tokens/s (best) [{card}]")
        plain_logits, plain_ms = timed(torch, lambda: plain(params, batch))
        plain_prompt = plain(params, prompt_batch)
        params32 = tree_map(lambda x: x.float(), params)
        ref_logits, ref_ms = timed(torch, lambda: reference(params32, batch))
        ref_prompt = reference(params32, prompt_batch)
        k32_logits = kernel32(params32, batch)
        if cfg.m_rope:
            # The same prefill with three distinct position rows: the
            # vision tokens on a 16 x 16 grid, the text after it.
            pos3 = mm_positions(torch, cfg.n_vision_tokens, seq)

            def last(c, p):
                x, _ = transformer.hidden_states(
                    p, c, tokens, positions=pos3, **extra)
                return transformer._head(p, c, x[:, -1:])[:, 0]

            fa_ops.reset_launch_counts()
            flash3, ms3 = timed(torch, lambda: last(cfg, params))
            launches3 = fa_ops.launch_counts["flash_attention"]
            check(launches3 == n_k3, f"{name} prefill with 3-row positions: "
                  f"{launches3} K3 launches, expected {n_k3}")
            plain3 = last(plain_cfg, params)
            ref3 = last(ref_cfg, params32)
        if cfg.enc_dec:
            memory, enc_ms = timed(torch, lambda: transformer.encode(
                params, cfg, extra["audio_feats"]))
        del params32
    torch.cuda.empty_cache()
    zeros = torch.zeros(LM_BATCH, dtype=torch.bool, device=DEVICE)
    top = ref_logits.abs().max().item()
    print(f"mm reference {name}: plain bf16 prefill {plain_ms:.2f} ms, f32 "
          f"reference {ref_ms:.2f} ms; last-position logits (max |logit| "
          f"{top:.3g}) from the f32 reference [{card}]")
    _, floor = hold_unflipped(f"mm reference {name}", row_dists(flash, ref_logits),
                              zeros, row_dists(plain_logits, ref_logits), zeros,
                              LM_BATCH, card)
    agree, rows = argmax_agrees(flash, ref_logits, floor)
    print(f"mm reference {name}: argmax agrees {agree} on the {rows} rows "
          f"whose top-two gap exceeds 2x the floor [{card}]")
    check(agree, f"{name} K3 prefill argmax differs from the f32 reference "
          f"on a row whose top-two gap exceeds 2x the floor")
    err32 = dist(k32_logits, ref_logits)
    agree, rows = argmax_agrees(k32_logits, ref_logits, err32)
    print(f"mm f32 kernels {name}: the K3 route in f32 with the f32 weights "
          f"{err32:.4g} from the f32 reference ({err32 / top:.3g} of "
          f"max|logit|, bound {REC_F32_TOL}); argmax agrees {agree} on the "
          f"{rows} of {LM_BATCH} rows whose top-two gap exceeds 2x that "
          f"[{card}]")
    check(err32 <= REC_F32_TOL * top and agree,
          f"{name} f32 K3 prefill {err32:.4g} from the f32 reference "
          f"(bound {REC_F32_TOL} x {top:.4g}), argmax agrees {agree}")
    if cfg.m_rope:
        moved = dist(ref3, ref_logits)
        side = math.isqrt(cfg.n_vision_tokens)
        print(f"mm m-rope {name}: a K3 prefill with 3 distinct position rows "
              f"(a {side} x {side} grid, text from {side}) in {ms3:.2f} ms, "
              f"{launches3} K3 "
              f"launches; its f32 reference {moved:.4g} from the default "
              f"positions' (> the floor {floor:.4g}) [{card}]")
        check(moved > floor, f"{name}: 3 distinct position rows moved the f32 "
              f"reference by {moved:.4g}, not above the floor {floor:.4g}")
        _, floor3 = hold_unflipped(f"mm m-rope {name}", row_dists(flash3, ref3),
                                   zeros, row_dists(plain3, ref3), zeros,
                                   LM_BATCH, card)
        agree, rows = argmax_agrees(flash3, ref3, floor3)
        check(agree, f"{name} K3 prefill with 3-row positions: argmax differs "
              f"from the f32 reference above 2x the floor")
        del flash3, plain3, ref3
    if cfg.enc_dec:
        print(f"mm encode {name}: {cfg.n_enc_layers} bidirectional layers "
              f"over B={LM_BATCH} x {cfg.enc_len} frames in {enc_ms:.2f} ms "
              f"(plain attention, as in the JAX package) [{card}]")

    serve = make_serve_step(cfg)
    mem = (memory,) if cfg.enc_dec else ()
    states = transformer.init_decode_state(
        cfg, LM_BATCH, transformer.decode_cache_len(cfg, cache), device=DEVICE)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(REC_PROMPT):
            nxt, logits, states = serve(params, prompt[:, pos:pos + 1], states,
                                        pos, *mem)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) / REC_PROMPT * 1e3
    _, floor_p = hold_unflipped(
        f"mm decode replay {name}", row_dists(logits, ref_prompt), zeros,
        row_dists(plain_prompt, ref_prompt), zeros, LM_BATCH, card)
    agree, rows = argmax_agrees(logits, ref_prompt, floor_p)
    print(f"mm decode replay {name}: {REC_PROMPT} prompt tokens one at a time "
          f"through make_serve_step (cache {cache}"
          f"{', the memory of the frames' if mem else ', text'}), "
          f"{replay_ms:.2f} ms/step; logits at position {REC_PROMPT - 1} held "
          f"against the f32 reference prefill of the prompt; argmax agrees "
          f"{agree} on the {rows} rows above 2x the floor [{card}]")
    check(agree, f"{name} decode argmax differs from the f32 reference on a "
          f"row whose top-two gap exceeds 2x the floor")

    tok, first = nxt[:, None], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(REC_PROMPT, REC_PROMPT + REC_GREEDY):
            nxt, logits, states = serve(params, tok, states, pos, *mem)
            tok = nxt[:, None]
            first.append(nxt)
        torch.cuda.synchronize()
        greedy_ms = (time.perf_counter() - t0) / REC_GREEDY * 1e3
    check(bool(torch.isfinite(logits).all()), f"{name} decode logits not finite")
    print(f"mm decode {name}: {REC_GREEDY} greedy steps at positions "
          f"{REC_PROMPT}..{REC_PROMPT + REC_GREEDY - 1}, {greedy_ms:.2f} ms/step "
          f"({LM_BATCH * 1e3 / greedy_ms:.0f} tokens/s); tokens of row 0: "
          f"{[int(t[0]) for t in first[:8]]} [{card}]")

    with torch.no_grad():
        rows_p, busy_us = profile(torch, f"mm prefill {name}", "prefill",
                                  lambda: prefill(params, batch), 1, cpu=False)
    k3_share = 100 * sum(us for n, us, _ in rows_p
                         if "flash_attention" in n) / busy_us
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"mm phase {name}: K3 {k3_share:.1f} % of the prefill's device "
          f"time; peak device memory {peak:.2f} GB; "
          f"{time.perf_counter() - t0_model:.1f} s [{card}]")
    del params, states
    torch.cuda.empty_cache()
    return launches


def mm_phase(torch, rt, fa_ops, card):
    """qwen2-vl-2b and whisper-tiny served at full width and depth (random
    bf16 weights from seed 0): K3 once a causal self-attention layer a
    prefill."""
    phase_t0 = time.perf_counter()
    counts = {name: mm_model(torch, rt, fa_ops, card, name, *rest)
              for name, *rest in MM_MODELS}
    print(f"mm phase: took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    return counts


# Zoo train phase: five more families trained through the driver at full
# width, random bf16 weights from seed 0: name, layers (0: all), sequence
# length, timed steps and parameters. whisper trains on its decoder's
# context of 448 tokens [arXiv:2212.04356] beside 1,500 zero frames.
# The timed steps are cut to fit the script's time limit: zamba2's and
# xlstm's steps take ~4–6 s. phi3.5-moe keeps 1 of its 32 layers:
# an adamw step holds about 28 bytes a parameter at once (the old state's
# bf16 params and f32 moments, the bf16 gradients and their f32 copy, the
# new moments, the update and the new params), 80.2 GB at 2 layers, 43.8
# GB at 1.
ZOO_TRAIN = (
    ("whisper-tiny", 0, 448, TRAIN_TIMED, 56_398_080),
    ("qwen2-vl-2b", 0, TRAIN_SEQ, 3, 1_777_675_776),
    ("zamba2-2.7b", 0, TRAIN_SEQ, 2, 2_063_676_080),
    ("xlstm-1.3b", 0, TRAIN_SEQ, 2, 2_012_002_640),
    ("phi3.5-moe-42b-a6.6b", 1, TRAIN_SEQ, TRAIN_TIMED, 1_562_980_352),
)
# The config whose flat SGD route runs through K2 in this phase, and its
# steps (a step of each route takes ~6 s at zamba2's size).
ZOO_TRAIN_FLAT, ZOO_FLAT_STEPS = "zamba2-2.7b", 1
# Step 0's batch loss in bf16 against the same weights upcast to f32,
# relative: a side input or a recurrent state that trains on the wrong
# tensor moves it by far more than bf16's rounding.
ZOO_TRAIN_BF16_TOL = 1e-2


def patch_inputs(cfg, batch_size, device):
    """Synthetic patch embeddings for a vision config's batches, the same
    every step: normal at the token embedding's scale (d_model**-0.5), as
    the mm phase serves qwen2-vl. The driver's own zero vision tokens
    (the JAX driver's) keep those rows exactly 0 through every layer of a
    random model, whose biases start at 0, and each RMSNorm multiplies
    their gradient by rsqrt(eps) = 1,000: at qwen2-vl-2b's width it grows
    ~1,000-fold a layer and overflows f32 before layer 28, in both
    packages (ROADMAP R5)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    return {"vision_embeds": (torch.randn(
        (batch_size, cfg.n_vision_tokens, cfg.d_model), device=device,
        generator=gen) * cfg.d_model ** -0.5).to(cfg.dtype)}
RECURRENT_KINDS = ("mamba2", "mlstm", "slstm")


def driver_batch(rt, cfg, seq):
    """The driver's step-0 token rows and client ids at ``--seed 0``: its
    key schedule (the last of five keys, then the second of three) and
    its batcher over ``make_lm_tokens``."""
    *_, k_batch = rt.random.split(rt.random.PRNGKey(0, device=DEVICE), 5)
    _, kb, _ = rt.random.split(k_batch, 3)
    lm = rt.data.make_lm_tokens(0, 512, seq, cfg.vocab)
    drawn = rt.data.GlobalBatcher({"raw": lm.tokens}, TRAIN_CLIENTS,
                                  TRAIN_BATCH, device=DEVICE).sample(kb)
    return drawn["raw"], drawn["client_ids"]


def zoo_train_model(torch, rt, ops, peaks, card, masked, decisions, k_draw,
                    name, n_layers, seq, timed, n_params):
    """One config trained at full width (``n_layers`` of its layers, or
    all): the driver's run timed and profiled; step 0's loss in bf16
    against f32; a masked client's tokens leave the adamw update bitwise
    the same (an MoE config at a capacity where nothing drops; at its own
    capacity the move is printed); for ZOO_TRAIN_FLAT the flat SGD route
    through K2. Returns that route's K2 launches, or None."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.launch import train as train_mod
    from repro_torch.models import moe, ssm, transformer

    t0_model = time.perf_counter()
    full = rt.configs.get_config(name)
    cfg = full.replace(n_layers=n_layers) if n_layers else full
    is_moe = cfg.n_experts > 0
    scans = any(k in RECURRENT_KINDS for k, _, _ in cfg.resolved_superblock)

    def init():
        return transformer.init_lm(rt.random.PRNGKey(0, device=DEVICE), cfg)

    # The driver holds the only reference to its weights: they go when
    # its first step replaces them.
    box = [init()]
    count = rt.models.count_params(box[0])
    check(count == n_params, f"{name} has {count} parameters, not {n_params}")
    flops, weights = train_flop(cfg, box[0], TRAIN_BATCH, seq)
    drops = []

    def count_drops(step, state, metrics):
        drops.append(moe.dropped_share())
        moe.reset_dispatch_counts()

    side = (patch_inputs if cfg.n_vision_tokens
            else train_mod.zero_side_inputs)
    moe.reset_dispatch_counts()
    run = driver_run(
        torch, lambda steps: train_argv(steps, arch=name, seq=seq), cfg,
        box.pop(), timed, f"zoo train {name}",
        on_step=count_drops if is_moe else None, cpu=False, side_inputs=side)
    losses, ms, med = run["losses"], run["ms"], run["med"]
    tokens = TRAIN_BATCH * seq
    mfu = flops / (med / 1e3) / peaks[2]
    with_side = (f" + {cfg.n_vision_tokens} synthetic patch embeddings a row"
                 if cfg.n_vision_tokens else
                 f" + {cfg.enc_len} zero frames a row" if cfg.enc_dec else "")
    depth = (f"{cfg.n_layers} of {full.n_layers} layers (cut: one card does "
             f"not hold more)" if n_layers else
             f"all {cfg.total_layers + cfg.n_enc_layers} layers")
    moe_text = (f", {cfg.n_experts} experts top-{cfg.top_k} at capacity "
                f"factor {cfg.moe_capacity_factor}" if is_moe else "")
    print(f"zoo train run: {name} at full width, {depth} (d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}{moe_text}, bf16, remat "
          f"{cfg.remat_policy if cfg.remat else 'off'}), {count:,} parameters,"
          f" through repro_torch.launch.train.main, B={TRAIN_BATCH} x S={seq}"
          f"{with_side} ({tokens:,} tokens a step), {TRAIN_CLIENTS} clients, alg1 "
          f"on periodic arrivals, adamw {TRAIN_LR}: {TRAIN_WARMUP} warm-up "
          f"step, {timed} timed: median {med:.1f} ms/step (spread "
          f"{min(ms):.1f}..{max(ms):.1f}), {tokens / med * 1e3:,.0f} tokens/s; "
          f"model FLOP a step {flops:.4g} ({weights:,} matmul weights"
          f"{'; the scans not counted' if scans else ''}), mfu {mfu:.3f} of "
          f"{peaks[2] / 1e12:.0f} TFLOP/s dense bf16; peak device memory "
          f"{run['peak']:.2f} GB [{card}]")
    print(f"zoo train losses {name}: {[round(x, 4) for x in losses]}; active "
          f"clients {run['active']}; weight sums "
          f"{[round(x, 3) for x in run['wsum']]}"
          + (f"; dropped share of (token, k) assignments a step "
             f"{[round(x, 4) for x in drops]}" if is_moe else ""))
    profile_report(torch, f"zoo train {name}", "step", run["prof"],
                   run["wall_us"], 1)
    del run
    torch.cuda.empty_cache()

    # bf16 against f32: step 0's batch loss at the driver's first weights.
    params = init()
    raw, ids = driver_batch(rt, cfg, seq)
    cfg32 = cfg.replace(dtype_name="float32")
    with torch.no_grad():
        l16 = transformer.per_example_loss(params, cfg, lm_batch(
            raw, ids, side(cfg, TRAIN_BATCH, DEVICE)))[0].mean().item()
        params32 = tree_map(lambda x: x.float(), params)
        l32 = transformer.per_example_loss(params32, cfg32, lm_batch(
            raw, ids, side(cfg32, TRAIN_BATCH, DEVICE)))[0].mean().item()
        del params32
    torch.cuda.empty_cache()
    gap = abs(l16 - l32) / abs(l32)
    check(abs(l16 - losses[0]) <= 1e-4 * abs(losses[0]),
          f"zoo train {name}: step 0's batch rebuilt gives loss {l16}, the "
          f"driver's step 0 {losses[0]}")
    check(gap <= ZOO_TRAIN_BF16_TOL, f"zoo train {name}: bf16 loss {l16} "
          f"from the f32 loss {l32} by {gap:.3g} relative")
    print(f"zoo train bf16 {name}: step 0's batch loss in bf16 {l16:.6f} "
          f"(the driver's {losses[0]:.6f}), upcast to f32 {l32:.6f}: "
          f"{gap:.3g} relative (<= {ZOO_TRAIN_BF16_TOL}) [{card}]")

    # A masked client's tokens change nothing, deterministic algorithms
    # on: the adamw update bitwise the same. An MoE config's tokens are
    # coupled across clients, as in the JAX package: the dispatch's
    # capacity is counted over the whole batch (a masked client's tokens
    # can change which others drop), the load-balance aux loss averages
    # the router over every token, and a token routed elsewhere moves
    # every later token's slot in the expert buffers, so the experts'
    # weight gradients sum in another order. So the client is the last
    # masked one, whose rows end the batch, and its update is held
    # bitwise at E / top_k, where every expert's capacity holds every
    # token, with the aux loss off; the move at the config's capacity and
    # at E / top_k with the aux loss is printed beside it.
    deterministic(torch, True)
    mask, scale = masked
    client = int((mask == 0).nonzero()[-1])
    other, n_rows = replace_rows(torch, raw, ids, client, cfg.vocab)
    check(not is_moe or bool((ids[-n_rows:] == client).all()),
          f"zoo train {name}: masked client {client}'s rows do not end the "
          f"batch")
    extra = side(cfg, TRAIN_BATCH, DEVICE)
    cases = [(cfg, None, True)]
    if is_moe:
        no_drop = cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.top_k)
        cases = [(cfg, None, False), (no_drop, None, False),
                 (no_drop, 0.0, True)]
    for c, aux, held in cases:
        t0 = time.perf_counter()
        moe.reset_dispatch_counts()
        kept, got, loss_a, loss_b = two_updates(
            torch, rt, c, params, lm_batch(raw, ids, extra),
            lm_batch(other, ids, extra), mask, scale, aux)
        dropped = moe.dropped_share()
        (p_differ, p_err), (m_differ, m_err) = update_moved(kept, got)
        n_el = sum(x.numel() for x in kept[0])
        top = max(x.abs().max().item() for x in got[1])
        del kept, got
        if held:
            check(dropped == 0.0, f"zoo train {name}: {dropped} of the "
                  f"assignments dropped at capacity factor "
                  f"{c.moe_capacity_factor}")
            check(p_differ == m_differ == 0, f"zoo train {name}: client "
                  f"{client} is masked, yet its tokens changed the update "
                  f"({p_differ} params, max {p_err:.3g}; {m_differ} first "
                  f"moment elements, max {m_err:.3g})")
        moved = ("the adamw update (params and first moment) bitwise the same"
                 if held else
                 f"the adamw update's params: {p_differ:,} of {n_el:,} moved, "
                 f"by at most {p_err:.3g}; its first moment: {m_differ:,} "
                 f"moved, by at most {m_err:.3g} = {m_err / top:.3g} of its "
                 f"largest value")
        if is_moe:
            moved += (f"; capacity factor {c.moe_capacity_factor}, dropped "
                      f"share {dropped:.4f}, aux-loss weight "
                      f"{0.01 if aux is None else aux}")
        print(f"zoo train masked client {name}: mask {mask.tolist()}, client "
              f"{client}'s {n_rows} sequences replaced by other random tokens "
              f"(mean loss {loss_a:.4f} -> {loss_b:.4f}): {moved}; "
              f"deterministic algorithms on; 2 steps in "
              f"{time.perf_counter() - t0:.1f} s [{card}]")

    launches = None
    if name == ZOO_TRAIN_FLAT:
        # The flat route ravels every leaf into one buffer of one dtype,
        # in both packages (ravel_spec refuses a mixed tree); zamba2 keeps
        # its SSM's a_log, dt_bias and d_skip in f32, so they go in bf16.
        cast = sum(x.numel() for x in tree_leaves(params)
                   if x.dtype != cfg.dtype)
        params = tree_map(lambda x: x.to(cfg.dtype), params)
        print(f"zoo train flat sgd: {name}'s {cast:,} parameters outside "
              f"{cfg.dtype} cast to it for the one-dtype flat buffer")
        lm = rt.data.make_lm_tokens(0, 512, seq, cfg.vocab)
        batcher = rt.data.GlobalBatcher({"raw": lm.tokens}, TRAIN_CLIENTS,
                                        TRAIN_BATCH, device=DEVICE)
        batches = [lm_batch(b["raw"], b["client_ids"], extra)
                   for b in (batcher.sample(rt.random.fold_in(k_draw, 2000 + i))
                             for i in range(ZOO_FLAT_STEPS))]
        launches, _ = flat_sgd_check(torch, rt, ops, cfg, params, batches,
                                     decisions, "zoo train", card)
    deterministic(torch, False)
    del params
    ssm.release_slstm_graphs()
    torch.cuda.empty_cache()
    print(f"zoo train phase {name}: took {time.perf_counter() - t0_model:.1f} "
          f"s, peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB [{card}]")
    return launches


def zoo_train_phase(torch, rt, ops, peaks, card):
    """whisper-tiny, qwen2-vl-2b, zamba2-2.7b, xlstm-1.3b and phi3.5-moe
    trained through the driver at full width, one after another, each
    freed before the next. Returns the K2 launches of the flat SGD
    route, under its config's name."""
    phase_t0 = time.perf_counter()
    masked, decisions, k_draw = alg1_decisions(torch, rt, ZOO_FLAT_STEPS)
    counts = {}
    for name, *rest in ZOO_TRAIN:
        launches = zoo_train_model(torch, rt, ops, peaks, card, masked,
                                   decisions, k_draw, name, *rest)
        if launches is not None:
            counts[name] = launches
    print(f"zoo train phase: took {time.perf_counter() - phase_t0:.1f} s "
          f"[{card}]")
    return counts


# Ep phase: phi3.5-moe served with its experts split over ranks
# (repro_torch.models.moe's expert-parallel path). One card: two ranks
# sharing it over gloo, at the zoo phase's depth, on (data 2, model 1),
# each rank the whole model (one draw), then (data 1, model 2), each
# rank its half of the experts cut from that (place_params). Four cards:
# a rank a card over NCCL, (1, 4) at full depth and (2, 2) at the zoo
# phase's depth, each rank drawing its experts alone (init_lm(mesh=)),
# each layer held on the ranks against the one-rank layer on its input.
# An entry: the mesh's shape, the layers, and whether each layer is held
# on the ranks.
EP_MODEL = ZOO_PROFILED
EP_DEPTH = dict((m[0], m[1]) for m in ZOO_MODELS)[EP_MODEL]
EP_ONE = (((2, 1), EP_DEPTH, False), ((1, 2), EP_DEPTH, False))
EP_FOUR = (((1, 4), 32, True), ((2, 2), EP_DEPTH, True))
# Greedy decode steps after the 64-token replay (REC_PROMPT), timed
# prefills after the counted one, and all_reduce repeats timed.
EP_GREEDY, EP_TIMED, EP_REDUCE_REPEATS = 8, 2, 5
# A layer held on the ranks: its output within 2**-7 of the largest
# |output| of the one-rank layer on the same input (one bf16 rounding of
# the largest value, twice), and every token routed alike.
EP_LAYER_TOL = 2 ** -7
# The one-rank run the one-card (1, 2) mesh is held against: the zoo
# phase's phi3.5 prefill and decode (ep_keep).
EP_REFERENCE = {}


def ep_tag(shape):
    return "x".join(map(str, shape))


def ep_train_tag(shape, layers):
    """A training run's name: its mesh's, and its depth past one layer."""
    return ep_tag(shape) + (f" at {layers} layers" if layers > 1 else "")


def ep_decode(torch, serve, params, cfg, tokens):
    """The zoo phase's decode on ``tokens``' rows: the first REC_PROMPT
    tokens fed one at a time through ``serve``, then EP_GREEDY greedy
    steps, every step's routing logged. Returns the greedy tokens
    (steps, rows), the log, and the replay's and greedy steps' ms."""
    from repro_torch.models import moe, transformer

    prompt = tokens[:, :REC_PROMPT]
    states = transformer.init_decode_state(
        cfg, tokens.shape[0], transformer.decode_cache_len(cfg, REC_CACHE),
        device=tokens.device)
    moe.routing_log = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(REC_PROMPT):
            nxt, _, states = serve(params, prompt[:, pos:pos + 1], states, pos)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok, greedy = nxt[:, None], []
        for pos in range(REC_PROMPT, REC_PROMPT + EP_GREEDY):
            nxt, _, states = serve(params, tok, states, pos)
            tok = nxt[:, None]
            greedy.append(nxt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log = moe.routing_log
    finally:
        moe.routing_log = None
    return (torch.stack(greedy), log, (t1 - t0) / REC_PROMPT * 1e3,
            (t2 - t1) / EP_GREEDY * 1e3)


def ep_keep(torch, logits, prefill_log, decode_log, greedy, floor, share):
    """Keep a one-rank phi3.5 run on the host for the ep phase."""
    host = lambda log: [(e.cpu(), k.cpu()) for e, k in log]  # noqa: E731
    EP_REFERENCE.update(logits=logits.float().cpu(), prefill=host(prefill_log),
                        decode=host(decode_log), greedy=greedy.cpu(),
                        floor=floor, dropped=share)


def ep_tokens(torch, rt, cfg, device):
    """The zoo phase's tokens: B = 8 x S = 2,048 Zipf-Markov ids, seed 0."""
    data = rt.data.make_lm_tokens(0, LM_BATCH, LM_SEQ, cfg.vocab).tokens
    return torch.from_numpy(data[:, :LM_SEQ]).to(device)


def ep_bmm_bitwise(torch, device, n_experts, rows, d_model, d_ff):
    """Whether cuBLAS gives a batch of the first n/2 experts (and the
    first half of the capacity rows) the bits the whole batch gives
    them, at the expert products' shapes: (gate/up, down)."""
    gen = torch.Generator(device=device).manual_seed(0)
    buf = torch.randn(n_experts, rows, d_model, device=device,
                      generator=gen).to(torch.bfloat16)
    w = torch.randn(n_experts, d_model, d_ff, device=device,
                    generator=gen).to(torch.bfloat16)
    h = torch.randn(n_experts, rows, d_ff, device=device,
                    generator=gen).to(torch.bfloat16)
    wd = w.transpose(1, 2).contiguous()
    half, r = n_experts // 2, rows // 2
    whole = (torch.bmm(buf, w), torch.bmm(h, wd))
    experts = (torch.equal(torch.bmm(buf[:half], w[:half]), whole[0][:half])
               and torch.equal(torch.bmm(h[:half], wd[:half]), whole[1][:half]))
    capacity = (torch.equal(torch.bmm(buf[:, :r], w), whole[0][:, :r])
                and torch.equal(torch.bmm(h[:, :r], wd), whole[1][:, :r]))
    return {"experts": experts, "rows": capacity}


def ep_all_reduce_ms(torch, mesh, n_tokens, d_model, device):
    """The median ms of one all_reduce of a (tokens, d_model) bf16 tensor
    over this rank's "model" row, the expert-parallel layer's sum (None
    for a one-rank row)."""
    import torch.distributed as tdist

    if mesh.row_group is None:
        return None
    buf = torch.ones(n_tokens, d_model, dtype=torch.bfloat16, device=device)
    ms = []
    for _ in range(EP_REDUCE_REPEATS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tdist.all_reduce(buf, group=mesh.row_group)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms[1:])[len(ms[1:]) // 2]


def ep_held_prefill(torch, mesh, prefill, params, tokens):
    """One prefill with each MoE layer held on the ranks: the layer's
    expert-parallel output against the one-rank ``apply_moe`` (off the
    mesh, the layer's experts gathered from the row) on the same input,
    the gathered experts freed after. Returns each layer's largest
    distance, the one-rank output's largest magnitude and the tokens
    routed otherwise."""
    import torch.distributed as tdist

    from repro_torch.models import blocks, moe
    from repro_torch.models.common import use_mesh

    real, layers = blocks.apply_moe, []

    def gather(w):
        parts = [torch.empty_like(w) for _ in range(mesh.shape["model"])]
        tdist.all_gather(parts, w.contiguous(), group=mesh.row_group)
        return torch.cat(parts)

    def held(p, x, **kw):
        moe.routing_log = []
        y, aux = real(p, x, **kw)
        whole = dict(p, **{k: gather(p[k]) for k in moe.EXPERT_LEAVES})
        with use_mesh(None):
            y1, _ = real(whole, x, **kw)
        (e0, k0), (e1, k1) = moe.routing_log
        layers.append({
            "dist": (y.float() - y1.float()).abs().max().item(),
            "top": y1.float().abs().max().item(),
            "flips": int(((e0 != e1) | (k0 != k1)).any(-1).sum())})
        del whole, y1
        return y, aux

    blocks.apply_moe = held
    try:
        prefill(params, {"tokens": tokens})
    finally:
        blocks.apply_moe = real
        moe.routing_log = None
    return layers


def ep_log_arrays(torch, arrays, prefix, log):
    """A routing log as two stacked arrays (entries, T, K)."""
    arrays[f"{prefix}top_e"] = torch.stack([e for e, _ in log]).cpu().numpy()
    arrays[f"{prefix}keep"] = torch.stack([k for _, k in log]).cpu().numpy()


def ep_mesh(torch, rt, mesh, cfg, params, held, tokens, device, reference):
    """One mesh of the ep phase on this rank, with this rank's ``params``:
    the counted and timed prefill on its rows, the aux, the all_reduce's
    ms, decode; with ``held``, a prefill held layer by layer; with
    ``reference`` on rank 0, the one-rank global path at the mesh's data
    shards (a ("data",) layout, no expert axis: JAX's global path with ds
    = the data shards) over all rows, and each data shard's rows
    prefilled alone (their aux). Returns (numbers, arrays)."""
    import numpy as np
    import torch.distributed as tdist

    from repro_torch.experiments import placement
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import moe, transformer
    from repro_torch.models.common import data_rows, use_mesh

    rank = tdist.get_rank()
    rows = data_rows(LM_BATCH, mesh)
    mine = tokens[rows]
    leaves = list(named_leaves(params))
    nbytes = lambda ls: sum(x.numel() * x.element_size() for x in ls)  # noqa: E731
    experts = [x for p, x in leaves
               if p[-2:-1] == ("moe",) and p[-1] in moe.EXPERT_LEAVES]
    out = {"rows": [rows.start, rows.stop], "layers": cfg.n_layers,
           "experts_a_layer": int(experts[0].shape[-3]),
           "expert_bytes": nbytes(experts),
           "param_bytes": nbytes(x for _, x in leaves)}
    arrays = {}
    prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
    with use_mesh(mesh, batch=LM_BATCH), torch.no_grad():
        fa_ops.reset_launch_counts()
        moe.reset_dispatch_counts()
        moe.routing_log = []
        logits, first_ms = timed(torch, lambda: prefill(params,
                                                        {"tokens": mine}))
        out["launches"] = fa_ops.launch_counts["flash_attention"]
        log, moe.routing_log = moe.routing_log, None
        out["assigned"] = int(moe.dispatch_counts["assigned"])
        out["dropped"] = int(moe.dispatch_counts["dropped"])
        out["prefill_ms"] = [first_ms] + [
            timed(torch, lambda: prefill(params, {"tokens": mine}))[1]
            for _ in range(EP_TIMED)]
        _, aux = transformer.hidden_states(params, cfg, mine)
        out["aux"] = aux.item()
        out["all_reduce_ms"] = ep_all_reduce_ms(torch, mesh, mine.numel(),
                                                cfg.d_model, device)
        greedy, dec_log, out["replay_ms"], out["greedy_ms"] = ep_decode(
            torch, serve, params, cfg, mine)
        if held:
            out["held"] = ep_held_prefill(torch, mesh, prefill, params, mine)
    arrays["logits"] = logits.float().cpu().numpy()
    arrays["greedy"] = greedy.cpu().numpy()
    ep_log_arrays(torch, arrays, "prefill_", log)
    ep_log_arrays(torch, arrays, "decode_", dec_log)
    if reference and rank == 0:
        layout = placement.Mesh(("data",), np.arange(mesh.shape["data"]))
        with use_mesh(layout), torch.no_grad():
            moe.routing_log = []
            ref = prefill(params, {"tokens": tokens})
            ref_log, moe.routing_log = moe.routing_log, None
            ref_greedy, ref_dec, _, _ = ep_decode(torch, serve, params, cfg,
                                                  tokens)
        # Each data shard's rows prefilled alone (the prefill step's own
        # calls): the shard's capacity and the rank's products' shapes.
        n, shard_logits, shard_log, out["shard_aux"] = (
            LM_BATCH // mesh.shape["data"], [], [], [])
        with torch.no_grad():
            for i in range(mesh.shape["data"]):
                moe.routing_log = []
                x, aux = transformer.hidden_states(params, cfg,
                                                   tokens[i * n:(i + 1) * n])
                shard_logits.append(transformer._head(params, cfg,
                                                      x[:, -1:])[:, 0])
                shard_log.append(moe.routing_log)
                moe.routing_log = None
                out["shard_aux"].append(aux.item())
        arrays["shard_logits"] = torch.cat(shard_logits).float().cpu().numpy()
        ep_log_arrays(torch, arrays, "shard_prefill_", [
            tuple(torch.cat(parts) for parts in zip(*layer))
            for layer in zip(*shard_log)])
        arrays["ref_logits"] = ref.float().cpu().numpy()
        arrays["ref_greedy"] = ref_greedy.cpu().numpy()
        ep_log_arrays(torch, arrays, "ref_prefill_", ref_log)
        ep_log_arrays(torch, arrays, "ref_decode_", ref_dec)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out, arrays


# Ep phase training, after the serving meshes: phi3.5-moe trained with
# its experts split over the ranks (make_train_step / make_sgd_train_step
# under use_mesh). An entry: the mesh, the layers (cut from the ranks'
# serving weights), the optimizer, the steps, and whether the mesh is held
# against a one-rank step on the same weights and batch. One card: (2, 1)
# SGD (each rank all 16 experts and half the rows), then (1, 2) adamw.
# Four cards: (1, 4) adamw at 1 layer, held against the one-rank step on
# the experts gathered from the row, then at EP_TRAIN_DEEP layers (no card
# holds that one-rank model), (2, 2) adamw at 1.
# 6 layers is the deepest a card holds at B 16: an adamw step holds ≈ 28
# B a parameter, 0.357e9 a layer a rank (4 of 16 experts) beside 0.263e9
# of embeddings, so 2.40e9 x 28 B ≈ 67 GB plus ≈ 6 GB of activations
# (4 layers peaked at 53.42 GB, PERF.md §6, PR 30); a 7th adds 10 GB.
EP_SGD_STEPS, EP_ADAMW_STEPS, EP_TRAIN_DEEP = 2, 3, 6
# At 6 layers adamw 1e-4 (no warm-up) swung the loss 10.78, 12.94, 11.20,
# 12.46, 10.84 over five steps (PERF.md §6, PR 30): 3e-5 there, five steps.
EP_DEEP_STEPS, EP_DEEP_LR = 5, 3e-5
# SGD at 0.01, not make_sgd_train_step's default 0.05 (the paper's CNN
# step): at phi3.5's full width 0.05's first step threw the loss from
# 10.79 up to 11.93 at (2, 1) (PERF.md §6, PR 30).
EP_SGD_LR = 0.01
EP_TRAIN_ONE = (((2, 1), 1, ("sgd", EP_SGD_LR), EP_SGD_STEPS, True),
                ((1, 2), 1, ("adamw", TRAIN_LR), EP_ADAMW_STEPS, True))
EP_TRAIN_FOUR = (
    ((1, 4), 1, ("adamw", TRAIN_LR), EP_ADAMW_STEPS, True),
    ((1, 4), EP_TRAIN_DEEP, ("adamw", EP_DEEP_LR), EP_DEEP_STEPS, False),
    ((2, 2), 1, ("adamw", TRAIN_LR), EP_ADAMW_STEPS, True))
# The global batch a world trains on (x TRAIN_SEQ tokens), TRAIN_CLIENTS
# clients, the masked one's rows last. One card holds B 8 beside the two
# ranks' adamw states (≈ 26 GB each at 1 layer).
EP_TRAIN_BATCH = {2: 8, 4: 16}


def ep_cut(params, layers):
    """The first ``layers`` layers of a stack, each leaf a copy (the rest
    of the serving weights can go); the other leaves as they are."""
    from repro_torch._tree import tree_map

    return dict(params, stack=tree_map(lambda x: x[:layers].clone(),
                                       params["stack"]))


def ep_whole_experts(torch, params, mesh):
    """``params`` with each expert leaf gathered from the rank's row: the
    one-rank model (four cards, where no rank holds the whole)."""
    import torch.distributed as tdist

    from repro_torch._tree import tree_flatten_with_path, tree_unflatten
    from repro_torch.models import moe

    if mesh.row_group is None:
        return params

    def gather(w):
        parts = [torch.empty_like(w) for _ in range(mesh.shape["model"])]
        tdist.all_gather(parts, w.contiguous(), group=mesh.row_group)
        return torch.cat(parts, dim=-3)

    leaves, treedef = tree_flatten_with_path(params)
    return tree_unflatten(treedef, [
        gather(x) if p[-2:-1] == ("moe",) and p[-1] in moe.EXPERT_LEAVES
        else x for p, x in leaves])


def ep_train_batch(torch, rt, cfg, b, masked):
    """B = ``b`` Zipf-Markov rows of TRAIN_SEQ + 1 tokens (seed 1), each of
    the TRAIN_CLIENTS clients b / TRAIN_CLIENTS rows, the last masked
    client's rows last; the same rows with that client's tokens replaced;
    and the number replaced."""
    mask, _ = masked
    client = int((mask == 0).nonzero()[-1])
    order = [c for c in range(TRAIN_CLIENTS) if c != client] + [client]
    ids = torch.tensor(order, device=DEVICE).repeat_interleave(
        b // TRAIN_CLIENTS).to(torch.int32)
    raw = torch.from_numpy(rt.data.make_lm_tokens(
        1, b, TRAIN_SEQ, cfg.vocab).tokens).to(DEVICE)
    other, n_rows = replace_rows(torch, raw, ids, client, cfg.vocab)
    return lm_batch(raw, ids), lm_batch(other, ids), n_rows


class EpCollectives:
    """Every ``torch.distributed.all_reduce`` while it is entered (the MoE
    layer's, the trainer's data-group sum, the aux's): count, bytes and
    wall ms, the card synchronised on both sides of each."""

    def __init__(self, torch):
        import torch.distributed as tdist

        self.torch, self.dist, self.calls = torch, tdist, []

    def __enter__(self):
        real = self.real = self.dist.all_reduce

        def timed_all_reduce(t, *args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(t, *args, **kw)
            self.torch.cuda.synchronize()
            self.calls.append((t.numel() * t.element_size(),
                               (time.perf_counter() - t0) * 1e3))
            return out

        self.dist.all_reduce = timed_all_reduce
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.real


def ep_optimizer(rt, opt):
    """The optimizer of an ``(kind, lr)`` pair."""
    kind, lr = opt
    return rt.optim.sgd(lr) if kind == "sgd" else rt.optim.adamw(lr)


def ep_step_fn(rt, cfg, opt, cf=None, aux=None):
    """(init, step) of the mesh's optimizer ``opt``, ``(kind, lr)``:
    ``make_sgd_train_step`` or ``make_train_step`` (adamw); with ``aux``,
    ``build_energy_train_step`` at that aux-loss weight and capacity
    factor ``cf``."""
    from repro_torch.core.trainer import build_energy_train_step
    from repro_torch.launch.steps import make_sgd_train_step, make_train_step
    from repro_torch.models import transformer

    if aux is not None:
        c = cfg.replace(moe_capacity_factor=cf)
        return build_energy_train_step(
            per_example_loss_fn=lambda p, b: transformer.per_example_loss(
                p, c, b), optimizer=ep_optimizer(rt, opt),
            n_clients=TRAIN_CLIENTS, aux_loss_weight=aux)
    kind, lr = opt
    if kind == "sgd":
        return make_sgd_train_step(cfg, TRAIN_CLIENTS, lr=lr)
    return make_train_step(cfg, TRAIN_CLIENTS, lr=lr)


def ep_held_leaves(kind, state):
    """What the hold compares after a step: SGD's new params, adamw's
    first moment (0.1 of the gradient)."""
    return state.params if kind == "sgd" else state.opt_state.mu


def ep_reference(torch, rt, cfg, opt, params, batch, mask, scale, dp):
    """The mesh's function stepped once on one rank with no collective:
    every row off a mesh when ``dp`` is 1, else each data shard's rows
    alone (a ``(dp, 1)`` layout of no process group: its rows, the
    global batch's coefficients, its capacity) at 1/dp of the aux-loss
    weight, their gradients summed; then the optimizer's first step.
    Returns the held leaves (:func:`ep_held_leaves`) and the metrics of
    the step off the mesh (dp 1)."""
    import numpy as np

    from repro_torch._tree import tree_map
    from repro_torch.core.trainer import build_energy_train_step
    from repro_torch.experiments import placement
    from repro_torch.models import transformer
    from repro_torch.models.common import use_mesh

    keep = rt.optim.Optimizer(
        init=lambda p: (), update=lambda g, s, p=None: (
            tree_map(torch.zeros_like, g), g))
    init, step = build_energy_train_step(
        per_example_loss_fn=lambda p, b: transformer.per_example_loss(
            p, cfg, b), optimizer=keep, n_clients=TRAIN_CLIENTS,
        aux_loss_weight=0.01 / dp)
    metrics, grads = None, None
    for d in range(dp):
        layout = placement.Mesh(("data", "model"),
                                np.arange(dp).reshape(dp, 1), (d, 0))
        with use_mesh(layout if dp > 1 else None,
                      batch=batch["client_ids"].shape[0]):
            state, m = step(init(params), batch, mask, scale)
        metrics = m if dp == 1 else None
        grads = state.opt_state if grads is None else tree_map(
            torch.add, grads, state.opt_state)
        del state
    # The optimizer's first step leaf by leaf: a whole adamw state of the
    # one-rank model would not fit beside the other rank.
    optimizer = ep_optimizer(rt, opt)

    def first_step(g, p):
        updates, state = optimizer.update(g, optimizer.init(p), p)
        return (rt.optim.apply_updates(p, updates) if opt[0] == "sgd"
                else state.mu)

    held = tree_map(first_step, grads, params)
    del grads
    return held, metrics


def ep_floors(torch, rt, mesh, cfg, opt, whole, batches, masked, ref):
    """Each held leaf's floor, on rank 0, sent to every rank: the bf16
    reference's (``ref``, on the host) largest distance from the same
    reference in f32."""
    import torch.distributed as tdist

    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.models.common import data_shards

    box = [None]
    if tdist.get_rank() == 0:
        deterministic(torch, True)
        whole32 = tree_map(lambda x: x.float(), whole)
        held32, _ = ep_reference(torch, rt, cfg.replace(dtype_name="float32"),
                                 opt, whole32, batches[0], *masked,
                                 data_shards(mesh))
        del whole32
        box = [[(a.to(b.device).float() - b).abs().max().item()
                for (_, a), b in zip(ref, tree_leaves(held32))]]
        del held32
        deterministic(torch, False)
        torch.cuda.empty_cache()
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def ep_mine(torch, mesh, path, x):
    """This rank's block of a whole-model leaf: an expert leaf's slice
    over "model" when the mesh cuts the experts."""
    from repro_torch.models import moe

    if path[-2:-1] == ("moe",) and path[-1] in moe.EXPERT_LEAVES:
        rows = moe.expert_slice(x.shape[-3], mesh)
        if rows is not None:
            return x[..., rows, :, :]
    return x


def ep_train_reference(torch, rt, mesh, cfg, opt, whole, batches, masked):
    """The one-rank step a training mesh is held against, on this rank:
    :func:`ep_reference` on the whole model ``whole``, its leaves moved to
    the host. Returns (leaves, the step's loss or None, s)."""
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.models.common import data_shards

    t0 = time.perf_counter()
    deterministic(torch, True)
    ref, metrics = ep_reference(torch, rt, cfg, opt, whole, batches[0],
                                *masked, data_shards(mesh))
    ref = [(p, x.cpu()) for p, x in tree_flatten_with_path(ref)[0]]
    loss = None if metrics is None else metrics["loss"].item()
    deterministic(torch, False)
    torch.cuda.empty_cache()
    return ref, loss, time.perf_counter() - t0


def ep_hold_leaves(torch, mesh, got, ref):
    """The mesh's held leaves after its first step against the
    reference's (this rank's block of each), leaf by leaf on the card:
    the leaves, and the largest distance of each that is not bitwise
    (by its index)."""
    from repro_torch._tree import tree_flatten_with_path

    got = tree_flatten_with_path(got)[0]
    dists = {}
    for i, ((path, x), (rpath, r)) in enumerate(zip(got, ref)):
        check(path == rpath, f"ep train: leaf {path} against {rpath}")
        r = ep_mine(torch, mesh, path, r).to(x.device)
        if not torch.equal(x, r):
            dists[i] = (x.float() - r.float()).abs().max().item()
    return {"leaves": len(got), "dists": dists}


def ep_judge(held, ref, floors):
    """The hold's verdict: bitwise leaves, the largest distance over its
    leaf's floor and that leaf, the leaves past 2x their floor."""
    worst, bad = (0.0, ""), []
    for i, dist in held["dists"].items():
        name = "/".join(map(str, ref[i][0]))
        ratio = dist / floors[i] if floors[i] > 0 else math.inf
        worst = max(worst, (ratio, name))
        if ratio > 2:
            bad.append((name, dist, floors[i]))
    return {"leaves": held["leaves"],
            "bitwise": held["leaves"] - len(held["dists"]),
            "worst": list(worst), "past": bad}


def ep_train_mesh(torch, rt, mesh, cfg, opt, steps, params, ref, batches,
                  masked, decisions):
    """One training mesh on this rank (module docstring): the mesh's
    ``steps`` steps with their collectives, the first held against the
    reference (``ep_train_reference``, or None), the leaves' sha256 after
    them, and the masked client's rows. Returns the numbers."""
    from repro_torch._tree import tree_flatten_with_path, tree_leaves
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import moe
    from repro_torch.models.common import data_shards, use_mesh

    batch, other, n_rows = batches
    mask, scale = masked
    b = batch["client_ids"].shape[0]
    dp, tp = data_shards(mesh), mesh.shape["model"]
    kind = opt[0]
    out = {"kind": kind, "lr": opt[1], "layers": cfg.n_layers, "batch": b,
           "mesh": list(mesh.shape.values()),
           "rows": b // dp, "n_rows_replaced": n_rows,
           "params": sum(x.numel() for x in tree_leaves(params)),
           "experts_a_layer": int(next(
               x for p, x in tree_flatten_with_path(params)[0]
               if p[-1] == "w_gate").shape[-3])}
    deterministic(torch, True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init, step = ep_step_fn(rt, cfg, opt)
    losses, ms, calls = [], [], []
    fa_ops.reset_launch_counts()
    with use_mesh(mesh, batch=b):
        state = init(params)
        for i in range(steps):
            m_i, s_i = ((mask, scale) if i == 0
                        else decisions[(i - 1) % len(decisions)])
            with EpCollectives(torch) as coll:
                (state, metrics), step_ms = timed(
                    torch, lambda: step(state, batch, m_i, s_i))
            ms.append(step_ms)
            calls.append(coll.calls)
            losses.append(metrics["loss"].item())
            if i == 0:
                out["first_metrics"] = {k: v.item()
                                        for k, v in metrics.items()}
                if ref is not None:
                    out["held"] = ep_hold_leaves(
                        torch, mesh, ep_held_leaves(kind, state), ref[0])
    out["step_ms"] = ms
    out["losses"] = losses
    out["collectives"] = [[(n, round(t, 3)) for n, t in c] for c in calls]
    out["k3_launches"] = fa_ops.launch_counts["flash_attention"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # Each leaf's sha256 after the steps: a leaf whole on every rank of a
    # row must be the same bits on every rank (the rows' gradients summed
    # over the data shards), an expert leaf on the ranks of a column.
    out["sha256"] = {"/".join(map(str, p)): params_sha256(torch, x)
                     for p, x in tree_flatten_with_path(state.params)[0]}
    out["expert_leaves"] = [
        "/".join(map(str, p)) for p, _ in tree_flatten_with_path(
            state.params)[0]
        if tp > 1 and p[-2:-1] == ("moe",) and p[-1] in moe.EXPERT_LEAVES]
    del state, ref
    torch.cuda.empty_cache()
    # The masked client's rows: capacity factor E / top_k (every token
    # kept), the aux loss off; the first update waits on the host.
    t0 = time.perf_counter()
    init, step = ep_step_fn(rt, cfg, opt, cf=cfg.n_experts / cfg.top_k,
                            aux=0.0)
    # SGD's held leaves are its params, compared once, on the card.
    kept = ((lambda s: [tree_leaves(s.params)]) if kind == "sgd" else
            (lambda s: [tree_leaves(s.params), tree_leaves(s.opt_state.mu)]))
    with use_mesh(mesh, batch=b):
        moe.reset_dispatch_counts()
        first = kept(step(init(params), batch, mask, scale)[0])
        if kind != "sgd":
            first = [[x.cpu() for x in xs] for xs in first]
        second = kept(step(init(params), other, mask, scale)[0])
        out["masked_dropped"] = moe.dropped_share()
    out["masked_moved"] = update_moved(first, second)
    out["masked_cf"] = cfg.n_experts / cfg.top_k
    out["masked_s"] = time.perf_counter() - t0
    del first, second
    deterministic(torch, False)
    torch.cuda.empty_cache()
    return out



def ep_any_rank(torch, flag):
    """Whether ``flag`` holds on any rank of the world (collective)."""
    import torch.distributed as tdist

    t = torch.tensor([int(flag)], device=DEVICE)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return bool(t.item())


def ep_train(torch, rt, cfg, plan, cuts, size):
    """The ep phase's training on this rank (module docstring), mesh by
    mesh of ``plan``, on the weights cut from the serving meshes
    (``cuts``: on one card the whole model's first layer, which every
    mesh starts from; on four each mesh's own rank weights, whose experts
    the held mesh gathers from its row for the one-rank model). Returns
    each mesh's numbers."""
    from repro_torch.experiments import placement
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    masked, decisions, _ = alg1_decisions(torch, rt, EP_ADAMW_STEPS - 1)
    b = EP_TRAIN_BATCH[size]
    batches = ep_train_batch(torch, rt, cfg, b, masked)
    runs = {"batch_s": time.perf_counter() - t0}
    one = cuts.pop("whole", None)
    # A mesh's serving weights serve each of its runs, the deepest last.
    uses = {}
    for shape, *_ in plan:
        uses[ep_tag(shape)] = uses.get(ep_tag(shape), 0) + 1
    for shape, layers, opt, steps, held in plan:
        tag = ep_train_tag(shape, layers)
        mesh = placement.make_mesh(shape)
        tcfg = cfg.replace(n_layers=layers, use_flash=False)
        t0 = time.perf_counter()
        if one is not None:
            params, whole = transformer.place_params(one, mesh), one
            if shape[-1] > 1:
                one = None  # the last mesh to start from the whole model
        else:
            uses[ep_tag(shape)] -= 1
            params = (ep_cut(cuts[ep_tag(shape)], layers)
                      if uses[ep_tag(shape)] else cuts.pop(ep_tag(shape)))
            whole = ep_whole_experts(torch, params, mesh) if held else None
        ref = (ep_train_reference(torch, rt, mesh, tcfg, opt, whole, batches,
                                  masked) if held else None)
        run = ep_train_mesh(torch, rt, mesh, tcfg, opt, steps, params, ref,
                            batches, masked, decisions)
        if ref is not None:
            run["reference_loss"], run["reference_s"] = ref[1], ref[2]
            # The floors in f32 only where a leaf on some rank is not the
            # reference's bits.
            t1 = time.perf_counter()
            floors = [0.0] * run["held"]["leaves"]
            if ep_any_rank(torch, bool(run["held"]["dists"])):
                floors = ep_floors(torch, rt, mesh, tcfg, opt, whole,
                                   batches, masked, ref[0])
            run["held"] = ep_judge(run["held"], ref[0], floors)
            run["floors_s"] = time.perf_counter() - t1
        run["s"] = time.perf_counter() - t0
        runs[tag] = run
        del params, ref, whole
        torch.cuda.empty_cache()
    return runs


def ep_child(out):
    """A rank of the ep phase (``--ep-child``, started by
    ``launch_simulated``; the rank from the ``REPRO_DIST_*`` environment):
    loads the port and K3 (built by the parent), builds the meshes of
    EP_ONE (2 ranks) or EP_FOUR (4) and runs each (``ep_mesh``) with this
    rank's parameters: on one card the whole model drawn once for ``(2,
    1)``, then its half of the experts cut from it for ``(1, 2)``
    (``place_params``); on four, each rank's experts drawn alone
    (``init_lm(mesh=)``). Writes ``<mesh>_p<rank>.npz`` and its report
    to ``out``."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    t_setup = time.perf_counter()
    # The training's peaks on two ranks sharing the card: no memory held
    # in segments too small for the next block.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    rt = load_port()
    from repro_torch.experiments import placement
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import distributed as D
    from repro_torch.models import transformer

    device = D.init_from_env()
    size, rank = placement._world()
    # The ranks' work is on the card; the cores are the parent's phases'.
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa_ops.load()
    plan = EP_FOUR if size == 4 else EP_ONE
    meshes = [placement.make_mesh(shape) for shape, _, _ in plan]
    torch.zeros((), device=device)
    cfg = rt.configs.get_config(EP_MODEL)
    report = {"rank": rank, "world": size, "device": str(device),
              "backend": tdist.get_backend(),
              "n_experts": cfg.n_experts, "d_model": cfg.d_model,
              "setup_s": time.perf_counter() - t_setup, "meshes": {}}
    t_run = time.perf_counter()
    tokens = ep_tokens(torch, rt, cfg, device)
    train_plan = EP_TRAIN_FOUR if size == 4 else EP_TRAIN_ONE
    train_layers = {}
    for shape, layers, *_ in train_plan:
        train_layers[ep_tag(shape)] = max(
            layers, train_layers.get(ep_tag(shape), 0))
    whole, cuts = None, {}
    for mesh, (shape, layers, held) in zip(meshes, plan):
        tag = ep_tag(shape)
        layer_cfg = cfg.replace(n_layers=layers, use_flash=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if whole is not None:
            # The training's one-card model: the whole model's first
            # layer, before the rest of it goes.
            cuts["whole"] = ep_cut(whole, 1)
            params = transformer.place_params(whole, mesh)
            how = "place_params: its experts cut from the whole model"
        else:
            params = transformer.init_lm(rt.random.PRNGKey(0, device=device),
                                         layer_cfg, mesh=mesh)
            how = ("init_lm: the whole model" if shape[-1] == 1 else
                   "init_lm(mesh=): its experts drawn alone")
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        whole = params if size == 2 and shape[-1] == 1 else None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run, arrays = ep_mesh(torch, rt, mesh, layer_cfg, params, held,
                              tokens, device,
                              reference=size == 2 and shape[0] > 1)
        report["meshes"][tag] = dict(run, init_ms=init_ms, init=how)
        if size == 4 and tag in train_layers:
            cuts[tag] = ep_cut(params, train_layers[tag])
        del params
        np.savez(os.path.join(out, f"{tag}_p{rank}.npz"), **arrays)
    if size == 2 and rank == 0:
        d = cfg.d_model
        rows = LM_BATCH * LM_SEQ * cfg.top_k * cfg.moe_capacity_factor
        report["bmm_bitwise"] = ep_bmm_bitwise(
            torch, device, cfg.n_experts, int(rows // cfg.n_experts), d,
            cfg.d_ff)
    report["serve_s"] = time.perf_counter() - t_run
    report["train"] = ep_train(torch, rt, cfg, train_plan, cuts, size)
    report["run_s"] = time.perf_counter() - t_run
    with open(os.path.join(out, f"report_p{rank}.json"), "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    tdist.destroy_process_group()
    return 0


def ep_start(torch):
    """Start the ep phase's ranks (2 sharing the card, or 4 on four
    cards); they run beside this process's phases."""
    from repro_torch.launch import distributed as D

    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else 2
    directory = tempfile.mkdtemp(prefix="chip_smoke_ep_")
    pool = ThreadPoolExecutor(max_workers=1)
    ep = {"dir": directory, "world": world, "cards": cards,
          "t0": time.perf_counter()}
    ep["future"] = pool.submit(D.launch_simulated, world, command=[
        sys.executable, str(ROOT / "chip_smoke.py"), "--ep-child"],
        argv=[directory], timeout=900)
    ep["future"].add_done_callback(
        lambda _: ep.setdefault("t_end", time.perf_counter()))
    pool.shutdown(wait=False)
    return ep


def ep_wait(ep):
    """Wait for the ranks to exit (a failed rank raises its stderr)."""
    ep["future"].result()


def ep_load(ep):
    """The ranks' reports and arrays: ([report a rank], {mesh: [arrays a
    rank]})."""
    import numpy as np

    reports = []
    for rank in range(ep["world"]):
        with open(os.path.join(ep["dir"], f"report_p{rank}.json")) as f:
            reports.append(json.load(f))
    arrays = {tag: [dict(np.load(os.path.join(ep["dir"],
                                              f"{tag}_p{r}.npz")))
                    for r in range(ep["world"])]
              for tag in reports[0]["meshes"]}
    return reports, arrays


def ep_hold(torch, label, got, want, bitwise, floor, n_layers, card):
    """The ep phase's rule on ``got`` and ``want``, each (logits, prefill
    log, decode log, greedy tokens): with ``bitwise`` (cuBLAS gives the
    products the one-rank bits) every logit, routing choice and token
    equal; else the zoo phase's rule: a row whose last token routed
    otherwise in a layer is not held (at least half are), a held row's
    logits within 2x the zoo phase's floor (when known), and the greedy
    tokens equal on the rows whose decode routed alike; the tokens
    routed otherwise are printed. Returns how it held."""
    logits, log, dec_log, greedy = got
    w_logits, w_log, w_dec, w_greedy = want
    flips = flipped_rows(torch, log, w_log, n_layers)
    diffs = routing_diffs(torch, log, w_log)
    dec_diffs = routing_diffs(torch, dec_log, w_dec)
    rows = row_dists(logits, w_logits)
    same_tokens = (greedy == w_greedy).all(0)
    print(f"{label}: prefill logits' distance a row "
          f"{[round(x, 4) for x in rows.tolist()]}; (layer, token) entries "
          f"routed otherwise a row {diffs}, the last token in rows "
          f"{flips.nonzero()[:, 0].tolist()}; decode (step, layer) entries "
          f"routed otherwise a row {dec_diffs}; greedy tokens equal a row "
          f"{same_tokens.tolist()} [{card}]")
    exact = (torch.equal(logits, w_logits) and not any(diffs)
             and not any(dec_diffs) and bool(same_tokens.all()))
    if bitwise or exact:
        check(exact, f"{label}: cuBLAS gives the one-rank bits, so every "
              f"logit, routing choice and greedy token must be the one-rank "
              f"run's")
        return "bitwise"
    held = ~flips
    check(int(held.sum()) >= LM_BATCH // 2,
          f"{label}: routing flips moved {int(flips.sum())} of {LM_BATCH} rows")
    if floor is not None:
        err = rows[held].max().item()
        check(err <= 2 * floor, f"{label}: {err:.4g} on the held rows, above "
              f"2x the zoo phase's floor {floor:.4g}")
    for row, n in enumerate(dec_diffs):
        check(n or bool(same_tokens[row]), f"{label}: row {row} routed alike "
              f"in decode but its greedy tokens differ")
    return (f"the rule: rows {held.nonzero()[:, 0].tolist()} held, the floor "
            + ("unknown (--ep-only)" if floor is None else f"{floor:.4g}"))


def ep_arrays(torch, ranks, prefix, decode=True):
    """(logits, prefill log, decode log, greedy tokens) of ``prefix`` on
    the card: the ranks' rows concatenated in rank order (one rank's when
    ``ranks`` holds one); without ``decode``, (logits, prefill log)."""
    import numpy as np

    def cat(key, axis):
        return torch.from_numpy(np.concatenate([a[prefix + key] for a in ranks],
                                               axis=axis)).to(DEVICE)

    def log(kind):
        return list(zip(cat(f"{kind}_top_e", 1).unbind(0),
                        cat(f"{kind}_keep", 1).unbind(0)))

    if not decode:
        return cat("logits", 0), log("prefill")
    return cat("logits", 0), log("prefill"), log("decode"), cat("greedy", 1)


def ep_phase(torch, ep, card):
    """The ep phase's report (module docstring): the ranks' runs held
    against the one-rank runs, their times, memory and dropped shares.
    Returns K3's launches a prefill by rank and mesh."""
    reports, arrays = ep_load(ep)
    shared = ep["cards"] < ep["world"]
    tag_card = f"[{card}{', shared card' if shared else ''}]"
    rep0 = reports[0]
    n_experts, d_model = rep0["n_experts"], rep0["d_model"]
    print(f"ep: {ep['world']} ranks over {rep0['backend']} on {ep['cards']} "
          f"card(s), {'shared by the ranks' if shared else 'one a rank'}; "
          f"set-up {max(r['setup_s'] for r in reports):.1f} s a rank, the "
          f"meshes {max(r['run_s'] for r in reports):.1f} s a rank, "
          f"{ep['t_end'] - ep['t0']:.1f} s wall from their start to their "
          f"exit; one torch thread a rank"
          + ("; gloo sums CUDA tensors through the host, so its times are "
             "not those of a card a rank" if rep0["backend"] == "gloo" else "")
          + f" {tag_card}")
    check(all(r["backend"] == ("gloo" if shared else "nccl") for r in reports),
          f"ep: backends {[r['backend'] for r in reports]}")
    if "bmm_bitwise" in rep0:
        print(f"ep: cuBLAS gives a batch of {n_experts // 2} experts the bits "
              f"of {n_experts}: {rep0['bmm_bitwise']['experts']}; half the "
              f"capacity rows the bits of all: {rep0['bmm_bitwise']['rows']} "
              f"(the expert products' shapes, bf16) {tag_card}")
    launches = {}
    for tag in rep0["meshes"]:
        runs = [r["meshes"][tag] for r in reports]
        ranks = arrays[tag]
        n_layers, tp = runs[0]["layers"], int(tag.split("x")[1])
        for r, run in zip(reports, runs):
            launches.setdefault(f"rank{r['rank']}", {})[tag] = run["launches"]
            check(run["launches"] == n_layers,
                  f"ep {tag} rank {r['rank']}: {run['launches']} K3 launches "
                  f"a prefill, expected {n_layers}")
            check(run["experts_a_layer"] * tp == n_experts,
                  f"ep {tag} rank {r['rank']}: {run['experts_a_layer']} "
                  f"experts a layer")
            reduce_ms = run["all_reduce_ms"]
            n_rows = run["rows"][1] - run["rows"][0]
            print(f"ep {tag} rank {r['rank']}: rows {run['rows'][0]}.."
                  f"{run['rows'][1] - 1}, {n_layers} layers, "
                  f"{run['experts_a_layer']} of {n_experts} experts a layer "
                  f"({run['expert_bytes'] / 1e9:.2f} GB of experts, "
                  f"{run['param_bytes'] / 1e9:.2f} GB of parameters; "
                  f"{run['init']}, {run['init_ms'] / 1e3:.1f} s); prefill "
                  + " ".join(f"{m:.1f}" for m in run["prefill_ms"])
                  + f" ms (the first counted: {run['launches']} K3 launches); "
                  f"one all_reduce of a layer's {n_rows * LM_SEQ:,} x "
                  f"{d_model} bf16 partial outputs "
                  + ("none (one rank a row)" if reduce_ms is None
                     else f"{reduce_ms:.2f} ms") + f"; decode "
                  f"{run['replay_ms']:.1f} ms/step replayed, "
                  f"{run['greedy_ms']:.1f} ms/step greedy; peak "
                  f"{run['peak_gb']:.2f} GB; aux {run['aux']:.6f} {tag_card}")
        assigned = sum(run["assigned"] for run in runs)
        dropped = sum(run["dropped"] for run in runs)
        print(f"ep {tag}: dropped {100 * dropped / assigned:.2f} % of the "
              f"prefill's {assigned:,} assignments (each rank counts those to "
              f"its own experts) {tag_card}")
        if "held" in runs[0]:
            for r, run in zip(reports, runs):
                print(f"ep {tag} rank {r['rank']} held layer by layer "
                      f"(largest |expert-parallel - one-rank| / largest "
                      f"|one-rank|, tokens routed otherwise): " + ", ".join(
                          f"{x['dist']:.3g}/{x['top']:.3g} {x['flips']}"
                          for x in run["held"]) + f" {tag_card}")
                for i, x in enumerate(run["held"]):
                    check(x["flips"] == 0 and x["dist"] <= EP_LAYER_TOL
                          * x["top"], f"ep {tag} rank {r['rank']} layer {i}: "
                          f"{x}")
            continue
        if tag == "1x2":
            # Both ranks hold every row: the same bits.
            check(all((ranks[0][k] == ranks[1][k]).all() for k in ranks[0]),
                  f"ep {tag}: the two ranks differ")
            ref = EP_REFERENCE
            if not ref:
                print(f"ep {tag}: no one-rank run to hold it against "
                      f"{tag_card}")
                continue
            want = (ref["logits"].to(DEVICE),
                    [(e.to(DEVICE), k.to(DEVICE)) for e, k in ref["prefill"]],
                    [(e.to(DEVICE), k.to(DEVICE)) for e, k in ref["decode"]],
                    ref["greedy"].to(DEVICE))
            how = ep_hold(torch, f"ep {tag} against the one-rank run",
                          ep_arrays(torch, ranks[:1], ""), want,
                          rep0["bmm_bitwise"]["experts"], ref["floor"],
                          n_layers, card)
            if how == "bitwise":
                check(dropped / assigned == ref["dropped"],
                      f"ep {tag}: dropped share {dropped / assigned} against "
                      f"one rank's {ref['dropped']}")
            print(f"ep {tag}: held against the one-rank prefill and decode "
                  f"({how}); the one rank dropped {100 * ref['dropped']:.2f} "
                  f"% {tag_card}")
        else:
            got = ep_arrays(torch, ranks, "")
            # The data shards' rows prefilled alone on rank 0: the same
            # products at the same shapes as the ranks', so bit for bit.
            alone = ep_arrays(torch, ranks[:1], "shard_", decode=False)
            flips = flipped_rows(torch, got[1], alone[1], n_layers)
            same = torch.equal(got[0], alone[0]) and not flips.any() and \
                not any(routing_diffs(torch, got[1], alone[1]))
            print(f"ep {tag} against each data shard's rows prefilled alone "
                  f"on rank 0: logits and routing bitwise {same}; logits' "
                  f"distance a row {[round(x, 4) for x in row_dists(got[0], alone[0]).tolist()]}"
                  f" {tag_card}")
            check(same, f"ep {tag}: not the bits of the shards' rows "
                  f"prefilled alone")
            how = ep_hold(torch, f"ep {tag} against rank 0's one-rank global "
                          f"path at ds = 2", got,
                          ep_arrays(torch, ranks[:1], "ref_"), False,
                          EP_REFERENCE.get("floor"), n_layers, card)
            aux = [run["aux"] for run in runs]
            shard = runs[0]["shard_aux"]
            want = sum(shard) / len(shard)
            print(f"ep {tag}: held against the one-rank global path at ds = 2 "
                  f"({how}); aux on the ranks {aux}, the mean of the data "
                  f"shards' own {want:.7f} ({shard}) {tag_card}")
            check(all(abs(x - want) <= 1e-6 * max(1.0, abs(want)) for x in aux),
                  f"ep {tag}: aux {aux} against the shards' mean {want}")
    for rank, counts in ep_train_report(reports, n_experts, tag_card).items():
        launches[rank].update(counts)
    return launches


def ep_train_report(reports, n_experts, tag_card):
    """The ep phase's training (module docstring), each mesh's lines and
    checks. Returns K3's launches in the training steps, by rank and
    mesh (``train <mesh>``)."""
    import numpy as np

    launches, fails = {}, []

    def want(cond, what):
        # Every line prints before any check fails.
        if not cond:
            fails.append(what)

    for tag in (t for t in reports[0]["train"] if "x" in t):
        runs = [r["train"][tag] for r in reports]
        r0 = runs[0]
        tp = r0["mesh"][-1]
        opt = (f"make_sgd_train_step, sgd {r0['lr']}" if r0["kind"] == "sgd"
               else f"make_train_step, adamw {r0['lr']}")
        for r, run in zip(reports, runs):
            launches.setdefault(f"rank{r['rank']}", {})[f"train {tag}"] = \
                run["k3_launches"]
            ms = run["step_ms"]
            med = float(np.median(ms[1:])) if len(ms) > 1 else ms[0]
            colls = "; ".join(
                f"step {i + 1}: {len(c)} all_reduce, "
                f"{sum(n for n, _ in c) / 1e6:.1f} MB, "
                f"{sum(t for _, t in c):.1f} ms"
                for i, c in enumerate(run["collectives"]))
            print(f"ep train {tag} rank {r['rank']}: {opt}, {len(ms)} steps, "
                  f"phi3.5-moe at {run['layers']} of 32 layers (d_model "
                  f"{reports[0]['d_model']}, bf16, remat, plain attention), "
                  f"B {run['batch']} x S {TRAIN_SEQ} ({run['rows']} rows a "
                  f"rank), {run['experts_a_layer']} of {n_experts} experts a "
                  f"layer, {run['params']:,} parameters a rank; step ms "
                  + " ".join(f"{x:.1f}" for x in ms) + f" (median after the "
                  f"first {med:.1f}); peak {run['peak_gb']:.2f} GB; losses "
                  f"{[round(x, 4) for x in run['losses']]}; {colls} (each "
                  f"timed with the card synchronised around it); "
                  f"{run['k3_launches']} K3 launches; {run['s']:.1f} s with "
                  f"the reference and the masked check {tag_card}")
            want(run["k3_launches"] == 0, f"ep train {tag}: K3 launched "
                  f"{run['k3_launches']} times in training")
            losses = run["losses"]
            want(all(math.isfinite(x) for x in losses)
                  and losses[-1] < losses[0],
                  f"ep train {tag} rank {r['rank']}: losses {losses}")
        # The leaves whole on every rank are the same bits on all of them
        # (a row's ranks compute them alike, the data shards' gradients
        # are summed); the experts on the ranks of a column.
        split = set(r0["expert_leaves"])
        differ = sorted(
            name for name in r0["sha256"]
            for group in ([runs[m::tp] for m in range(tp)] if name in split
                          else [runs])
            if len({run["sha256"][name] for run in group}) > 1)
        want(not differ, f"ep train {tag}: leaves that differ across the "
              f"ranks that should hold the same bits: {differ}")
        held = "held" in r0
        if held:
            for r, run in zip(reports, runs):
                h = run["held"]
                print(f"ep train {tag} rank {r['rank']} held against the "
                      f"one-rank step ({'every row off a mesh' if run['rows'] == run['batch'] else 'each data shard stepped alone, the gradients summed'}; "
                      f"{'params after SGD' if run['kind'] == 'sgd' else 'adamw first moment'}"
                      f", this rank's block of each leaf): {h['bitwise']} of "
                      f"{h['leaves']} leaves bitwise, the largest distance "
                      f"{h['worst'][0]:.3g}x its floor ({h['worst'][1] or '-'}"
                      f"); loss {run['first_metrics']['loss']:.6f}, the "
                      f"one-rank step's "
                      + ("-" if run["reference_loss"] is None
                         else f"{run['reference_loss']:.6f}")
                      + f"; the reference {run['reference_s']:.1f} s, its "
                      f"f32 floors {run['floors_s']:.1f} s (0 where every "
                      f"leaf is bitwise) {tag_card}")
                want(not h["past"], f"ep train {tag} rank {r['rank']}: "
                      f"leaves past 2x their floor {h['past']}")
                if run["reference_loss"] is not None:
                    want(run["first_metrics"]["loss"] == run["reference_loss"],
                          f"ep train {tag}: step 0's loss "
                          f"{run['first_metrics']['loss']} against the "
                          f"one-rank step's {run['reference_loss']}")
        for r, run in zip(reports, runs):
            moved = run["masked_moved"]
            want(run["masked_dropped"] == 0.0 and all(
                n == 0 for n, _ in moved), f"ep train {tag} rank {r['rank']}: "
                f"the masked client's rows moved the update {moved} (dropped "
                f"{run['masked_dropped']})")
        print(f"ep train {tag}: the leaves whole on every rank bit-equal "
              f"across the {len(runs)} ranks after the steps (sha256), the "
              f"experts across each column; "
              + ("every held leaf within 2x its floor; " if held else
                 "not held (no card holds the one-rank model); ")
              + f"the masked client's {r0['n_rows_replaced']} rows (last) "
              f"given other tokens leave the update bitwise the same on "
              f"every rank (capacity factor {r0['masked_cf']}, nothing "
              f"dropped, the aux loss off; "
              f"{max(run['masked_s'] for run in runs):.1f} s) {tag_card}")
    check(not fails, "; ".join(fails))
    return launches


def ep_only(torch, rt, fa_ops, card, kind, phase, seconds):
    """``--ep-only``: the ep phase alone, for four cards (K3 built, the
    ranks started; on one card without the zoo phase's one-rank run to
    hold ``(1, 2)`` against). It prints the ep lines and the phases'
    seconds, and no result line."""
    phase("build", fa_ops.load)
    ep = ep_start(torch)
    phase("ep wait", ep_wait, ep)
    launches = phase("ep", ep_phase, torch, ep, card)
    print(f"ep only: K3 launches a prefill, and in training, "
          f"{json.dumps(launches)}; phase "
          f"seconds: {json.dumps(seconds)} on {kind} [{card}]")
    return 0


def load_port():
    """Import the port from ``./src``."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    import repro_torch.checkpoint
    import repro_torch.configs
    import repro_torch.core
    import repro_torch.data
    import repro_torch.experiments
    import repro_torch.kernels.aggregate
    import repro_torch.models
    import repro_torch.optim
    import repro_torch.random
    import repro_torch.serve
    return rt


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--resume-child"]:
        return resume_child(sys.argv[2])
    if sys.argv[1:2] == ["--serve-child"]:
        return serve_child(sys.argv[2])
    if sys.argv[1:2] == ["--train-child"]:
        return train_child(sys.argv[2])
    if sys.argv[1:2] == ["--dist-child"]:
        return dist_child(sys.argv[2])
    if sys.argv[1:2] == ["--ep-child"]:
        return ep_child(sys.argv[2])
    rt = load_port()
    from repro_torch.kernels import _build
    from repro_torch.kernels.aggregate import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    from repro_torch.models.ssm import chunked_gla

    # Full f32 everywhere: no TF32 in matmuls or cuDNN convolutions, so
    # the kernel path and the matvec reference differ only in the order
    # of the client sum, and the LM reference prefill is full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    sm_clock_hz = float(clock.stdout.strip().splitlines()[0]) * 1e6
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
          f"peaks used for the bound: {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s f32, {peaks[2] / 1e12:.0f} TFLOP/s "
          f"bf16, {peaks[3] / 1e12:.0f} TFLOP/s TF32")

    seconds = {}

    def phase(name, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    if sys.argv[1:2] == ["--ep-only"]:
        return ep_only(torch, rt, fa_ops, card, kind, phase, seconds)

    # One nvcc process for each source, all started at once. The phases
    # up to the dist phase need only the aggregate kernels, so the
    # flash-attention and scan sources go on building beside them.
    pool = ThreadPoolExecutor(max_workers=3)
    builds = [pool.submit(m.load) for m in (ops, fa_ops, ssm_ops)]
    phase("build", builds[0].result)
    print(f"build: the aggregate kernels in {seconds['build']:.1f} s; the "
          f"flash-attention and scan kernels build on beside the phases up "
          f"to the dist phase (one nvcc process for each source, all started "
          f"at once)")

    errs, timing = phase("kernel", kernel_phase, torch, ops, ref, peaks)
    launches, fig1_data, legacy = phase("fig1", fig1_phase, torch, rt)
    legacy_k1 = phase("legacy k1", legacy_k1_phase, torch, ops, ref, peaks,
                      timing["k1"]["ms"])
    # The ep phase's ranks need K3 and run beside the engine, faults and
    # serve phases, which keep the card idle most of a step; the dist
    # phase times K1 and K2 after them, so it waits for the ranks.
    phase("k3 build wait", builds[1].result)
    ep = ep_start(torch)
    engine_counts, legacy_engine_s = phase("engine", engine_phase, torch,
                                           rt, fig1_data)
    print(f"legacy carry: {legacy['seconds'] + seconds['legacy k1'] + legacy_engine_s:.1f} s "
          f"added (fig-1 runs {legacy['seconds']:.1f}, K1 leaf timings "
          f"{seconds['legacy k1']:.1f}, engine study {legacy_engine_s:.1f}) "
          f"[{card}]")
    fault_counts = phase("faults", faults_phase, torch, rt, fig1_data, card)
    serve_counts = phase("serve", serve_phase, torch, rt, fig1_data, card)
    del fig1_data
    phase("ep wait", ep_wait, ep)
    dist_counts, dist_shapes = phase("dist", dist_phase, torch, rt, ops, ref,
                                     peaks, card)

    def build_rest():
        for f in builds[1:]:
            f.result()
        pool.shutdown()

    phase("build wait", build_rest)
    print(f"build: the flash-attention and scan kernels ready "
          f"{time.perf_counter() - T0:.1f} s after the script started "
          f"(waited {seconds['build wait']:.1f} s for them)")
    k3_build_report(_build, fa_ops)
    k4_build_report(torch, _build, ssm_ops)
    k3_err, k3_timing = phase("k3", k3_phase, torch, fa_ops, fa_ref, peaks,
                              sm_clock_hz)
    launches["gla_scan"], k4_err, k4_timing = phase(
        "k4", k4_phase, torch, ssm_ops, ssm_ref, chunked_gla, peaks)
    launches["flash_attention"], lm_params = phase("lm", lm_phase, torch, rt,
                                                   fa_ops)
    train_counts, k2_train, resume = phase("train", train_phase, torch, rt,
                                           lm_params, ops, ref, peaks, card)
    del lm_params
    rec_counts = phase("rec", recurrent_phase, torch, rt, fa_ops, ssm_ops,
                       card)
    phase("resume end", finish_resume, resume, card)
    zoo_counts = phase("zoo", zoo_phase, torch, rt, fa_ops, card)
    # The ranks' runs, held against the zoo phase's phi3.5 run.
    ep_launches = phase("ep", ep_phase, torch, ep, card)
    mm_counts = phase("mm", mm_phase, torch, rt, fa_ops, card)
    train_counts.update(phase("zoo train", zoo_train_phase, torch, rt, ops,
                              peaks, card))
    print(f"phase seconds: {json.dumps(seconds)}; {sum(seconds.values()):.1f} "
          f"s in all, {time.perf_counter() - T0:.1f} s since the script "
          f"started [{card}]")

    errs["k1"] = max(errs["k1"], legacy_k1["max_abs_err"])
    names = {"k1": ("masked_scaled_aggregate", SOURCE,
                    "src/repro/kernels/aggregate/aggregate.py:77"),
             "k2": ("masked_scaled_aggregate_update", SOURCE,
                    "src/repro/kernels/aggregate/aggregate.py:128"),
             "k3": ("flash_attention", K3_SOURCE,
                    "src/repro/kernels/flash_attention/flash_attention.py:95")}
    # K3's main path is the stablelm prefill, so its line carries the
    # prefill shape's numbers; each timed shape's own follow.
    timing["k3"] = k3_timing["prefill shape"]
    errs["k3"] = k3_err
    kernels = []
    for key, (name, source, replaces) in names.items():
        t = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[key], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "warm_ms": t["warm_ms"],
            "plain_warm_ms": t["plain_warm_ms"],
            "library_warm_ms": t["library_warm_ms"]})
        if key in ("k1", "k2"):
            # The engine and faults phases' runs, each counted from 0.
            kernels[-1]["engine_launches"] = {
                label: c[name] for label, c in engine_counts.items()}
            kernels[-1]["faults_launches"] = {
                label: c[name] for label, c in fault_counts.items()}
            kernels[-1]["serve_launches"] = {
                label: c[name] for label, c in serve_counts.items()}
            # The dist phase's ranks, each counted from 0 before each
            # combination's first run, and the kernel at a shard's rows.
            kernels[-1]["dist_launches"] = {
                rank: {tag: c[name] for tag, c in combos.items()}
                for rank, combos in dist_counts.items()}
            kernels[-1]["sharded_shapes"] = {
                label: t for label, t in dist_shapes.items()
                if label.startswith(key)}
        if key == "k1":
            # The legacy per-leaf carry: the Fig-1 phase's runs and the
            # engine's legacy study, each counted from 0, and K1 at each
            # leaf shape with a step's 8 launches summed.
            kernels[-1]["legacy_launches"] = {
                **{f"fig1 {label}": c[name]
                   for label, c in legacy["launches"].items()},
                **{f"engine {label}": engine_counts[label][name]
                   for label in ("legacy", "legacy resumed")}}
            kernels[-1]["legacy_shapes"] = legacy_k1["shapes"]
            kernels[-1]["legacy_step_ms"] = legacy_k1["step_ms"]
            kernels[-1]["legacy_step_bound_ms"] = legacy_k1["step_bound_ms"]
        if key == "k2":
            # The train phases' flat SGD route: one launch a step on a
            # one-row stack of a model's P parameters (stablelm's under
            # "flat_sgd", zamba2's under its name), timed at stablelm's.
            kernels[-1]["train_launches"] = train_counts
            kernels[-1]["train_shape"] = k2_train
        if key == "k3":
            kernels[-1]["shapes"] = k3_timing
            # The recurrent phase's prefills, each counted from 0.
            kernels[-1]["recurrent_launches"] = {
                name: c["flash_attention"] for name, c in rec_counts.items()}
            # The zoo phase's prefills, each counted from 0.
            kernels[-1]["zoo_launches"] = zoo_counts
            # The multimodal phase's prefills, each counted from 0.
            kernels[-1]["mm_launches"] = mm_counts
            # The ep phase's ranks: a prefill on each mesh, counted from 0.
            kernels[-1]["ep_launches"] = ep_launches
    # K4's main path is the two recurrent models' prefills: its launches
    # are theirs, counted from 0 before each. Its times and bound are the
    # K4 phase's, one scan at each layer's shape (the sums over both; each
    # shape's own numbers follow), whose count is "phase_launches".
    total = lambda key: sum(t[key] for t in k4_timing.values())
    kernels.append({
        "name": "gla_scan", "route": "cuda", "source": K4_SOURCE,
        "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:65",
        "launches": sum(c["gla_scan"] for c in rec_counts.values()),
        "recurrent_launches": {name: c["gla_scan"]
                               for name, c in rec_counts.items()},
        "phase_launches": launches["gla_scan"], "max_abs_err": k4_err,
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"), "bound_by": max(
            k4_timing.values(), key=lambda t: t["bound_ms"])["bound_by"],
        "library_ms": None, "warm_ms": total("warm_ms"),
        "plain_warm_ms": total("plain_warm_ms"),
        "comparator": "repro_torch.models.ssm.chunked_gla",
        "comparator_ms": total("comparator_ms"),
        "comparator_warm_ms": total("comparator_warm_ms"),
        "shapes": k4_timing})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
