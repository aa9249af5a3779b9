#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kgcn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced on its own line; any failure ends the run with a
non-zero exit and no result line:

1. environment — the card (nvidia-smi name and power limit), torch, CUDA;
2. build — every CUDA kernel of the port (gconv.cu, tiled.cu, stream.cu, ell.cu)
   and the tiled backend's host library (tiled_host.cc), from
   kgcn_tpu_torch/ops/csrc, one compiler process per source, in parallel;
3. kernel check: gconv — against its plain PyTorch version on the card at
   the serving path's shapes, a misaligned toy, a reaction-scale batch,
   dense graphs of 600 and 1024 nodes, 70 000 graphs of 8 nodes (more
   than a grid dimension's 65 535) and phase 17's first GraphConv (32
   graphs padded to 64 atoms, 81 features) (float32, rtol = atol = 1e-4: the sums
   run over ≤ 2 048 terms in another order; the distance of both from an
   f64 sum is printed), two launches bitwise equal, the kernels a call
   launches as the wrapper counts them equal to those torch.profiler
   records, with its device time (torch.profiler), the plain version's, one
   library call's, and the least time the card could take (bytes at
   3.35 TB/s vs FLOP at 67 TFLOP/s FP32); at the configs phase's shapes
   (node_label.json's first and last GraphConv; IG's 100 stacked copies of
   a 10-node and a 47-node molecule) also the backward, dA included,
   against autograd through the plain version (1e-4);
4. kernel check: tiled SpMM (forward and on the transpose structure, the
   backward's dx) and SDDMM — against their plain versions on the card, with
   the float32 and the bf16 payload, rtol = atol = 1e-4 (both versions apply
   the same bf16 roundings; only the order of the f32 sums differs), on the
   solubility training batch (F 81 and 50), the GAT batch of synthetic.jbl
   (F 50), a rectangular case, one with edge-free receiver tiles, a
   budget-padded, a locality-relabelled and a wide-tile case (sums in the
   output), and a uniform random graph of 100 000 nodes and 1 000 000
   edges at F 128 tiled by choose_tiling; each case's SpMM plans (built by
   the host library csrc/tiled_host.cc, as the move to the card builds
   them), with their shape and host ms; the SDDMM per edge (it walks the
   forward plan's real entries into an [E] output) against the plain
   version's per-edge form; two launches of the SpMM and of the SDDMM
   bitwise equal; device times as in phase 3, the library calls being
   torch.sparse.mm and torch.sparse.sampled_addmm;
5. train — ``python -m kgcn_tpu_torch.cli.main train`` in this process,
   the streaming loop (the dense runs with ``device_resident`` false; phase
   11 runs the resident default):
   the tiled solubility GCN and the tiled GAT for 2 epochs (finite, falling
   training cost, the [SAVE] and [restore] lines, every file written, and
   kernel launches = 6 SpMM per GCN step, 6 SpMM + 3 SDDMM per GAT step,
   3 SpMM per evaluated batch), the dense solubility GCN for 1 epoch (3 gconv
   kernels per step and per evaluated batch), the dense GCN of synth.json
   for 1 epoch on 32 ring graphs of 700 nodes (``make_ring_dataset(
   num_pairs=16, num_nodes=700)``, 768 padded; per step and evaluated batch
   the gconv kernels of one forward at that shape, at least one a
   GraphConv), and
   the solubility GCN with dropout 0 and the f32 payload on the GPU and on
   the CPU from one seed (per-epoch training costs within 1e-3 relative);
   3 dense GCN steps on the 700-node graphs, GPU vs CPU (1e-3); two GPU
   runs of 3 steps from one seed bitwise equal, for GAT on the tiled backend,
   GIN with xla and GIN with pallas on ring6 graphs (phase 10's data: the
   ELL kernel and its dx kernel); ``segment_sum``'s and
   ``segment_softmax``'s values and gradients on the card with no host sync
   (with a GAT batch's segments, sorted on the host, and with ids on the
   card alone), and so the ELL aggregation's value and dx on a ring6 batch;
   then one epoch of each timed step by step (host batch
   assembly and tiled-structure building, step wall time and the SpMM plans
   that the move to the card builds within it, device busy time and idle
   share);
6. serve — the port's HTTP server (cli/serve.build_server) answers /predict
   requests of 1, 8, 32 and 100 real molecules of
   examples/solubility/solubility_cls.jbl with a seeded GCN at the config's
   full width (example_config/solubility_cls.json: hidden 50, batch 32,
   47 nodes, 81 features); answers are checked (rows sum to 1, finite,
   equal to the same model run on the CPU to 1e-4) and the kernel launch
   counts read back;
7. kernel check: stream — the stream backend's three kernels (the
   iota-route scatter, the one-hot scatter, the weight gradient), forward
   and on the transpose structure (dx), against their plain versions run on
   CPU copies of the inputs, with the float32 and the bf16 payload,
   rtol = atol = 1e-4, on the KG path's largest and smallest relation
   channels (F 128), a uniform random graph of 100 000 nodes and 1 000 000
   edges at F 128 with choose_stream's parameters, a hub graph (the KG's
   40 960 nodes, 81 920 uniform edges and 50 000 more into one receiver,
   weighted as the KG's channels are, F 128), the same hub graph with
   weights of order 1, a rectangular (F 64 and 200) and a
   macro-budget-padded case (F 40 and 133: the scatters' scalar path, F not
   a multiple of 4, and more than one 128-column group); on the hub cases
   the scatters are also held against an f64 sum, each row within 1e-4 +
   sqrt(n)·2^-24·Σ|message| (n its messages), and with order-1 weights
   against that alone (the plain version's own f32 error on the hub row
   passes 1e-4); the weight gradient's padding slots exactly 0, its dy
   row reads at F 128 counted (one per run of a receiver in a span), and on
   the rectangular case its other lane layouts (F 5, 16, 27, 32, 33, and
   128 off 16-byte alignment), each held as above; two launches of each
   scatter and of the weight gradient bitwise equal; one weight-gradient
   launch under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
   device times as in phase 3, the library calls being torch.sparse.mm and
   torch.sparse.sampled_addmm, and the weight gradient's also with the L2
   flushed before each call (``device_ms(cold=True)``); bounds over the
   rows of x and dy that the edges touch (``stream_bound``);
8. kg — a knowledge graph of WN18RR's published shape (40 943 entities, 11
   relations with its training-set relation shares, 89 969 distinct
   triples, power-law entity frequency) generated from a seed as a triple
   TSV, preprocessed by ``python -m kgcn_tpu_torch.cli.kg``, then
   ``cli.main train`` (KG GCN encoder, width 128, label batch 1024, 2 epochs,
   spmm_backend auto → stream, bf16 payload) and ``cli.main infer`` in this
   process: finite falling cost, the checkpoint, finite ranking metrics, and
   exact launch counts (training runs the scanned epoch, each step replayed
   from a captured CUDA graph: the wrappers count the warm-up and the
   capture, 4·C × 3 one-hot scatters, and torch.profiler records 4·C a
   step over the steps and the 2 warm-up steps, one graph launch a step;
   2·C per infer; no weight gradient); the same with the float32 payload
   for 1 epoch (4·C iota-route scatters per step); the first 3 steps of
   the float32 run on
   the GPU and on the CPU from one seed (costs within 1e-3 relative); and a
   step breakdown (the graph batch's host build and its stream structures,
   host ms per step, step wall time, device busy time and idle share);
9. kernel check: ELL — the pallas backend's ELL gather kernel and its dx
   kernel against their plain versions run on CPU copies of the inputs
   (float32 rtol = atol = 1e-4, bf16 x 1e-2: the einsum sums in another
   order, and bf16 rounds the output once; dx is the plain index_add_,
   whose CPU order the kernel keeps, so f32 is printed as bitwise equal or
   not), on the ELL path's batch of 25 ring graphs (V 150, K 5; F 3 and
   50), 1 024 ring graphs (F 50), uniform degree 8 (V 16 384, F 128), V
   100 000 with K 10 (10⁶ slots, F 128), a skewed case (K 16, mean degree
   5, most slots padding) and K 1 at F 81, each with its transposed slot
   lists (the Batcher's for the ring6 batches); two dx launches bitwise
   equal; C = 3 (three ring6 batches as channels, F 50, shared and
   per-channel x): the fused forward against the per-channel plain sum and,
   in f32, bitwise against three one-channel launches added in channel
   order, dx against the plain dx, and the card's transpose against the
   host's; the autograd wrapper's value, dx and dw on the card against the
   CPU; device times as in phase 3, the library call being torch.sparse.mm
   on a CSR of the same slots (its transpose for dx);
10. ell — a ring dataset of 6-node graphs (``make_ring_dataset(num_pairs=
   1000, num_nodes=6, seed=0)``, which the ELL gate admits) written as a
   pickle, then ``cli.main train`` (the streaming loop, ``device_resident``
   false) for gin (example_config/gin.json's
   settings, spmm_backend pallas, 2 epochs) and ``cli.main infer``, and gcn
   for 1 epoch: exact launch counts (one forward launch per aggregation,
   whatever C: 2 per GIN forward, 3 per GCN forward; one dx launch per
   backward aggregation whose input needs a gradient: 1 per GIN step, 3 per
   GCN step), falling cost, every file; 3 f32
   GIN steps on the GPU and on the CPU from one seed (1e-3); ROADMAP
   C.11's probe: 2 epochs of ``cli.main train`` of GIN (pallas, f32) on
   the card and on the CPU from one seed, per-epoch costs within 1e-3,
   per-step costs printed with where the two part; a step
   breakdown with the idle share; then gin on example_config/gin.json
   itself with pallas and with xla, where the gate refuses ELL: 0 ELL
   launches and, on pallas, the JAX package's fallback message;
11. runners — the whole-epoch runners (``runtime/resident.py``,
   ``runtime/runner.py``) at full width: for the dense solubility GCN, the
   dense GAT (example_config/gat.json) and GIN with pallas on ring6 (the
   training split of each), 2 epochs of the resident runner eager
   (``Trainer(capture=False)``) and captured from seed 0 with dropout 0:
   per-step costs and every parameter bitwise equal; the captured epochs,
   capture and replays, under ``torch.cuda.set_sync_debug_mode("error")``;
   the kernels torch.profiler records in them equal to the eager runner's
   per-step launches (the wrappers' counts) over the replayed steps and the
   2 warm-up steps, and one CUDA graph launch a step; GPU (captured) vs CPU
   the first epoch's cost within 1e-3; for the GCN with dropout 0.2, two captured
   epochs from one state differ at every step (fresh masks each replay)
   and the captured epoch against the eager one; one epoch's step wall,
   device busy and idle share of the streaming loop, the resident runner
   eager and captured, in turns; then ``cli.main train`` (2 epochs) and
   ``infer`` with ``device_resident`` at its default: one graph launch a
   training step and evaluated batch, the profiler's kernel launches as
   predicted.  The KG (bf16, WN18RR-shaped): 2 scanned epochs eager and
   captured, bitwise equal, the same launch and sync checks; one f32
   epoch of 3 label slices GPU vs CPU, its mean cost within 1e-3, with
   the per-step gap (ROADMAP C.9's probe); the per-batch loop,
   the scanned epoch eager and captured timed in turns;
12. configs — the shipped configs' models and subcommands through
   ``python -m kgcn_tpu_torch.cli.main`` in this process, at full width,
   only ``epoch`` cut: ``train_cv`` of solubility_reg.json (gcn_regression,
   3 folds x 2 epochs: finite r2 and mse a fold, the JAX run's keys, the
   folds of ``kfold_indices``, one graph launch a step and evaluated
   batch); node_label.json ``train`` and ``infer`` (2 epochs, captured:
   falling cost, 3 gconv kernels a forward, GPU vs CPU costs within 1e-3);
   synth.json as examples/run_synth.sh runs it (``train`` 2 epochs with
   ``make_plot`` where matplotlib is installed, ``infer``, ``visualize``
   of 4 molecules at 100 steps: valid_metrics and test_metrics, each IG
   dump's completeness, its arrays against the CPU's IG of the same
   checkpoint within rtol 1e-3, atol 1e-6, 6 gconv launches a molecule,
   IG's ms a molecule, the median of 5 passes; then ``visualize`` of one
   molecule on the tiled and the stream backend, f32 payload: their
   kernels and weight gradients launched, no gconv, the IG within the
   same tolerance of the dense run's); gcn in node-embedding mode on
   featureless ring graphs (1 epoch captured, a finite embedding
   gradient); the phase's wall;
13. launches — every kernel launched on the main path of phases 5-12;
14. serving and interop, at full width: the checkpoint that kgcn_tpu's
   ``train`` wrote (tests/fixtures/jax_gcn_solubility, a flax-msgpack
   file) through ``cli.main infer`` (``load_model``) and the HTTP server
   over its directory, both against kgcn_tpu's recorded answers to 32
   molecules (TOL), and ``retrain`` from it for one epoch (its step
   resumed); dynamic batching (``--dynamic-batching``) over that model
   against the plain server, 64 concurrent clients of 1 molecule and 16 of
   4: replies equal (1e-5), each device call 3 gconv launches a batch of
   32, p50/p99 latency and graphs/s of both, a malformed request among
   good ones answered 400 alone; ``train`` with ``export_model`` (2
   epochs) and ``--export`` over HTTP against the Predictor on the same
   weights (1e-5), with torch.profiler recording the 3 gconv kernels of
   the exported program's batch; example_config/multimodal.json ``train``
   (2 epochs, captured: one graph launch a step, 1 gconv kernel a forward)
   and ``infer``, GPU vs CPU per-epoch costs (1e-3), and dynamic batching
   of 16 clients of one compound–protein pair against solo replies
   (1e-5); the phase's wall;
15. engines — the three engines beside ``cli.main``, at full width:
   ``cli.sparse`` on the reaction workload (2 048 chain-and-ring molecules
   of 20-203 atoms, mean degree ≈ 2.2, 81 features, 20 014 classes, batch
   128, the SparseGCN defaults), written as 4 TFRecord shards by the
   port's writer and read through the host parser (timed): ``train`` 2
   epochs (the captured resident runner: one graph launch a step, gconv
   launches as one forward's over the replays, warm-ups and eager
   validation batches, the _report keys), one captured epoch's step
   wall, device busy, idle share, graphs/s and device time by kernel, the
   captured runner bitwise equal to its eager steps, ``infer`` of every graph
   (probabilities that sum to 1), and 3 streaming steps on the card and on
   the CPU from one seed (TRAJECTORY_RTOL); ``cli.sparse train`` (1 epoch)
   on 256 graphs of 257-600 atoms at batch 32, which ``auto`` sends
   through the tiled kernel (6 SpMM launches a step, 3 an evaluated
   batch, no gconv); ``cli.pair train`` (2 epochs, captured: both towers
   gathered on the card) and ``infer`` of example_config/pair.json with
   dropout 0, the checkpoint's scores on the card against the CPU (1e-5),
   two GPU runs of a pair step bitwise equal, the captured runner bitwise
   equal to its eager steps; ``cli.gen train`` (2 epochs, captured: ε
   drawn on the card), ``reconstruct`` and ``generate`` of
   example_config/vae.json, the reconstruction from one checkpoint with
   the streaming ε on the card against the CPU (1e-5), the captured
   runner bitwise equal to its eager steps (the same ε), and the resident
   evaluation's dict predictions captured bitwise equal to eager; the
   phase's wall;
16. precision and explain, in a process of its own (``--phase16 WORKDIR``,
   started and waited for by this one, ``phase_in_child``: torch.profiler,
   whose records the phase's launch counts come from, has been seen to
   record nothing late in a long process) — ``"precision": "bfloat16"`` and the rest of
   ``visualize``: the count of tensor-core instructions (HMMA, from
   ``cuobjdump -sass``) in the built gconv library's bf16 kernels (more
   than 0) and its float32 ones (0); the bf16 gconv kernel
   (``kgcn_gconv_bf16``) at phase 3's shapes (the serving path's, a
   misaligned toy, reaction scale, N 600 and 1024 with their split runs,
   70 000 graphs of 8 nodes) and the reaction engine's three call shapes
   (``ENGINE_GCONV``) against its plain
   version (``gconv_reference`` widened to f32, rounded once), kernel and
   plain each within one bf16 rounding of an f64 sum, two launches bitwise
   equal, its launches as the wrapper counts them equal to
   torch.profiler's (no f32 copy of an operand: no other kernel), with
   device, plain, library (``torch.einsum`` on the bf16 tensors) and bound
   times (bf16 bytes at 3.35 TB/s vs FLOP at 989 TFLOP/s, the bf16 tensor
   cores); the ELL kernel and its dx with bf16 slot weights at phase 9's
   ring6 batch (F 3 and 50, x f32 and bf16) against their plain versions;
   ``cli.main train`` at bf16 (2 epochs; finite, falling costs) on the
   dense solubility GCN (resident, captured: 3 bf16 gconv kernels a step
   and an evaluated batch in the profiler) and GAT on ``tiled``, GIN on
   ``pallas`` (ring6: the ELL kernel with bf16 weights; finite costs, and
   the same run with TF32 off falling: ``precision_gin`` says why), and
   the WN18RR-shaped KG for 1 epoch (stream); 3 steps at bf16 GPU vs CPU
   (2e-2, on batches spread over the dataset, with the card's launches)
   for the dense GCN, GIN ``pallas``, GAT ``tiled`` and the KG; the
   captured bf16 runner bitwise equal to its eager steps; the captured
   step's wall, device busy and idle share at bf16 beside float32 (GCN
   dense, and the reaction step through ``cli.sparse``, which also trains
   2 epochs at bf16, with the bf16 gconv held at the engine's own operands
   (one bf16 rounding; its backward's bf16 einsums within 2e-2 of the
   largest gradient) and 3 reaction steps at bf16 GPU vs CPU (2e-2));
   ``visualize`` on the KG with phase 8's
   checkpoint (2 targets, ``ig_divide_number`` 30; the CSVs written, ms a
   target) and one target's embedding IG at 5 steps GPU vs CPU (f32
   payload, 1e-3 of its largest value); ``embedded_layer_ig`` of
   multimodal.json's model GPU vs CPU (1e-4); ``python -m
   kgcn_tpu_torch.cli.gcnv`` on a dump (``ImportError`` where matplotlib
   is missing, as ``make_plot``'s);
17. chemistry, in a process of its own as phase 16 (``--phase17
   WORKDIR``) — the port makes a dataset and trains on it: 2 048 seeded
   drug-like SMILES (``make_smiles``: 10-60 heavy atoms, chains and
   branches, double and triple bonds, rings of 5-7 atoms, benzene,
   pyridine, pyrrole, furan, thiophene, fused bicycles, charged bracket
   atoms, salts) with class labels, an assay CSV of 4 tasks with blanks
   and a V2000 SDF of the first 256 (``write_sdf``); ``python -m
   kgcn_tpu_torch.cli.chem`` on the SMILES (atom limit 64, Morgan
   fingerprints; molecules/s on the host), on the SDF (adjacencies equal
   to the SMILES route's, features equal but the hydrogen one-hots of
   bracket-H atoms, which V2000 does not carry), on the assay CSV with
   ``--pseudo-negative`` and with ``--tfrecords`` (read back by the host
   parser); ``chem_summary``, ``cv_splitter`` (5 folds) and ``data_join``
   of a fold's two files (the dataset back in fold order); ``cli.main
   train`` (2 epochs, solubility_cls.json's GCN at full width, captured:
   one graph launch a step, the gconv kernels of a forward as predicted in
   the profiler's records, the first GraphConv at phase 3's "chem layer 1"
   shape) and ``infer``; the first epoch GPU vs CPU from one seed (dropout
   0, 1e-3); a captured epoch's step wall, busy and idle share; the KNIME
   helpers on the SDF (features equal to ``chem``'s) and one epoch of
   ``cli.main train`` on their dataset with exact launch counts;
18. tools and export, in a process of its own as phases 16 and 17
   (``--phase18 WORKDIR``) — ``python -m kgcn_tpu_torch.cli.opt`` on
   solubility_cls.json at full width (dropout 0, 4 trials of 2 epochs over
   a seeded domain of ``learning_rate`` and ``batch_size``): finite values,
   gconv launched in every trial (the first and last trial in the
   profiler's records, the others by the wrapper's count), each trial's peak
   device memory (reset per trial) not growing (trial 4 within 5 % of
   trial 1), trial 0 against the same trial on this machine's CPU
   (``TRAJECTORY_RTOL``); ``tools/nas.search`` on the solubility split (3
   candidates of 2 epochs, the first 4 GraphConv of 128) with the first
   against the CPU's; ``cli.gk`` (WL, SVM CV) on solubility_cls.jbl and
   the SVC active-learning loop on phase 17's Morgan fingerprints, on the
   host without scikit-learn (seconds, accuracies); ``runtime/timing.
   chain_time`` of gconv at the serving shape beside its device time;
   ``train`` with ``export_model`` (1 epoch) and the ``ExportPredictor`` on
   the card for synth.json's GCN on 700-node rings with ``tiled`` and with
   ``stream`` at batch 1 and gin.json on ring6 with ``pallas`` (float32
   payload): the backend's kernel launched inside the exported program,
   answers within 1e-5 of the checkpoint's ``Predictor`` and 1e-4 of the
   same artifact on this machine's CPU, and so are the logits before the
   softmax (the 700-node rings' answers are pinned at 0 and 1), relative
   to the largest logit, against the port's model run eagerly;
19. parallel, in a rank of its own: ``phase_in_child`` starts
   ``python -m kgcn_tpu_torch.parallel.launch --nprocs 1 -- python3
   chip_smoke.py --phase19 WORKDIR`` (the NCCL group of one rank on this
   card; alone: that command after phases 1, 2 and 8 on WORKDIR) —
   ``train`` of solubility_cls.json's GCN at full width (dropout 0, 2
   epochs) with ``mesh {"data": 1}`` bitwise equal (per-epoch costs, final
   parameters) to the same config without ``mesh``, its gconv launches
   exact (the data-parallel steps run eagerly: a forward's kernels a step
   and an evaluated batch), its costs within TRAJECTORY_RTOL of the same
   run on this machine's CPU (gloo), one epoch at ``"precision":
   "bfloat16"`` (the bf16 gconv launched); the same for gin.json on ring6
   with ``pallas`` (the ELL kernel and its dx kernel, phase 10's counts);
   the shard ingest: gin.json on ring6 (``pallas``) through
   ``ShardedBatcher(mode="shard")`` over ``shard_for_host(ds, 0, 1)``, 2
   epochs, bitwise the single-device Trainer's streaming run, both with
   exact ELL and dx launches; the resume: solubility_cls.json's GCN at
   dropout 0.2 with ``mesh {"data": 1}`` (sharded resident batcher), 2
   epochs, ``save_tree``, a third (continued) against a fresh DPTrainer
   restored from the file (resumed), bitwise, gconv launches exact; the
   two walls on their ``-- shard ingest`` and ``-- resume`` lines;
   the big-graph KG trainer on phase 8's KG (``mesh``, gcn, dim 128):
   one step's loss and gradients against ``KGLinkPredictor`` on the same
   weights (stream kernels, f32 payload) within 1e-4 of the largest
   magnitude, ring equal to allgather, ``fit_resident`` 2 epochs, the
   sharded checkpoint restored bitwise, ``cli.main train``/``retrain``/
   ``infer``, a step's wall and the peak device memory; ``train_cv`` with
   ``fold_parallel: "force"`` (5 folds of 320 molecules, 2 epochs) GPU vs
   CPU per fold (TRAJECTORY_RTOL); the trial pool on ``cuda:0`` twice
   (each trial bitwise equal to itself alone); ``tools/bench_scaling``
   (kg step, world 1) prints its line; the phase's wall;
20. tensor and pipeline parallel and kgcn_tpu's orbax checkpoints, in a
   rank of its own as phase 19 (``--phase20 WORKDIR``) —
   ``parallel/tp.TPTrainer`` at ``{"model": 1}`` on solubility_mt.json's
   multitask tower (its three 256-wide layers sharded at min_dim 128,
   column-parallel over the NCCL group of one; dropout 0, 2 streaming
   epochs) bitwise equal to the single-device Trainer run eagerly
   (per-epoch costs, final parameters), a forward's gconv kernels a step,
   within TRAJECTORY_RTOL of the same run on this machine's CPU, one epoch
   at ``"precision": "bfloat16"`` (the bf16 entry); ``parallel/pp.PPTrainer``
   at ``{"pipe": 1}`` (k 4, hidden 64, M 4) on 32 solubility molecules of
   both classes: the logits within 1e-5 of ``sequential_logits`` on the
   CPU (the plain gconv; of the largest), k·M gconv calls a forward, 20 Adam steps at lr 0.02 within
   TRAJECTORY_RTOL of the CPU's; the committed orbax checkpoint of
   kgcn_tpu's big-graph trainer (tests/fixtures/jax_orbax_big_graph,
   written over 4 devices) restored into BigGraphKGTrainer by
   ``runtime/orbax.py`` bitwise against its ``.npy`` arrays (the read's
   MB/s), ``cli.main train`` with ``retrain`` (1 epoch) and ``infer`` (the
   stream scatter); the phase's wall;
21. summary — one JSON line of kernel numbers, then the result line.

Kernel launch counts are set to 0 just before each run of a path (phases
5, 6, 8, 10, 11, 12, 14, 15, 16, 17, 18, 19 and 20) and read just after; the summary's
``launches`` add up the tiled GCN, tiled GAT and dense GCN training runs
and the serve run, the KG runs (train and infer) for the stream kernels,
the ring runs (train and infer) for the ELL kernel, phase 11's resident
``train`` and ``infer`` runs, phase 12's runs (with IG on the tiled and
stream backends, the stream weight gradient's one main-path run) and
phase 14's (gconv: the served kgcn_tpu checkpoint, the dynamic batcher's
device calls, the export and its program's run, multimodal training) and
phase 15's (gconv: the sparse, pair and VAE engines' training and
inference; the tiled SpMM: the sparse engine beyond 256 nodes) and
phase 19's (gconv and its bf16 entry, the ELL kernel and its dx kernel:
the data-parallel runs; the stream scatter: the big-graph checkpoint's
``infer``; the fold-parallel and pool runs' warm-up and capture) and
phase 20's (gconv and its bf16 entry: the TP and PP runs; the stream
scatter: the ``infer`` after the orbax restore) and
phase 16's (the bf16 runs; gconv_bf16 counts them alone) and phase 17's
(gconv: the chem dataset's captured ``train`` and ``infer``, the KNIME
dataset's streaming ``train``) and phase 18's (gconv: the HPO trials, the
first and last in the profiler's records, and the NAS candidates; the tiled SpMM, the
stream scatter and the ELL kernel inside the exported programs).
A step replayed from a captured
CUDA graph launches its kernels from the graph, where no wrapper counts:
for those runs (the KG training, phase 11's and phase 12's resident
runs, phase 15's engine training) the launches are torch.profiler's
records, and the wrappers' counts (the warm-up and the capture) only show
that the kernels are in the graph; IG's eager launches are the wrapper's.
Exits non-zero without a CUDA device and outside a checkout of the repo.
``SCALE`` and ``KG_SHRINK`` cut the scale case and the KG for a rehearsal
on the CPU, with ``DEVICE = "cpu"`` and the kernels' launch functions
swapped for counted plain versions.
"""
import contextlib
import io
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "example_config", "solubility_cls.json")
GAT_CONFIG = os.path.join(ROOT, "example_config", "gat.json")
DATASET = os.path.join(ROOT, "examples", "solubility", "solubility_cls.jbl")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, FP32 outside tensor cores
TOL = 1e-4
TRAJECTORY_RTOL = 1e-3      # GPU vs CPU training cost, tests/test_reference_parity.py:434-441
DEVICE = "cuda"
SCALE = (100_000, 1_000_000, 128)  # uniform random graph: nodes, edges, F
HUB_EDGES = 50_000   # in-edges of the hub case's one hub receiver
KG_CONFIG = os.path.join(ROOT, "example_config", "kg.json")
# WN18RR (Dettmers et al. 2018): entities, and the training-set triple count
# of each of its 11 relations; train 86 835 + test 3 134 distinct triples
WN18RR_ENTITIES = 40_943
WN18RR_RELATION_COUNTS = (34_796, 29_715, 7_402, 4_816, 3_116, 2_921, 1_299,
                          1_138, 923, 629, 80)
WN18RR_TRIPLES = 86_835 + 3_134
KG_TEST_RATE = 0.035
KG_OVERRIDES = dict(kg_encoder="gcn", embedding_dim=128, label_batch_size=1024,
                    epoch=2)
KG_SHRINK = 1        # divide entities and triples (CPU rehearsal only)
KG_PROBE_SLICES = 3   # label slices an epoch of the KG GPU-vs-CPU run (f32)
ZIPF_EXPONENT = 0.75  # entity frequency ∝ (rank + 1)^-0.75

# (C, B, N, Fin, Fout): the serving path's three GraphConv calls per batch,
# a misaligned toy (tests/test_kernels.py:89), a reaction-scale batch, dense
# graphs of 600 and 1024 nodes (the two-launch design at mid sizes), and more
# small graphs than a grid dimension's 65 535 (the one-launch design)
GCONV_SHAPES = [
    ("path layer 1", (1, 32, 47, 81, 50)),
    ("path layer 2", (1, 32, 47, 50, 50)),
    ("path layer 3", (1, 32, 47, 50, 50)),
    ("misaligned", (2, 2, 10, 7, 5)),
    ("reaction-scale", (3, 128, 203, 81, 128)),
    ("N 600", (1, 8, 600, 64, 64)),
    ("N 1024", (2, 4, 1024, 81, 50)),
    ("B 70 000", (1, 70_000, 8, 16, 16)),
    # the configs phase: node_label.json's first and last GraphConv, and
    # IG's 100 stacked copies of one molecule (synthetic.jbl, and a
    # solubility molecule of full size), whose backward asks for dA
    ("node_label 1", (1, 2, 10, 3, 64)),
    ("node_label 3", (1, 2, 10, 64, 2)),
    ("IG synthetic", (1, 100, 10, 3, 50)),
    ("IG solubility", (1, 100, 47, 81, 50)),
    # phase 17: the first GraphConv of the solubility GCN on the dataset the
    # port's chem makes (batch 32, padded to --atom-num-limit 64, 81 features)
    ("chem layer 1", (1, 32, 64, 81, 50)),
]
# the shapes whose backward is asked for the adjacency's gradient (IG)
DADJ_SHAPES = ("node_label 1", "node_label 3", "IG synthetic", "IG solubility")
# the dense train on large graphs: ring graphs of 700 nodes (768 padded)
RING700 = dict(num_pairs=16, num_nodes=700, seed=0)
REQUEST_SIZES = (1, 8, 32, 100)
GIN_CONFIG = os.path.join(ROOT, "example_config", "gin.json")
GCN_RING_CONFIG = os.path.join(ROOT, "example_config", "synth.json")
RING6 = dict(num_pairs=1000, num_nodes=6, seed=0)  # 2 000 graphs, ELL K 5
ELL_TOL = {"float32": TOL, "bfloat16": 1e-2}


def say(msg):
    print(msg, flush=True)


def phase(n, name):
    say(f"== phase {n}: {name}")


def call_ms(fn, iters):
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls from
    this host loop (CUDA events, after a warm-up): what a Python caller
    pays, launch overhead included."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_events(prof):
    """({kernel name: [launches, device µs]}, CUDA graph launches) of a
    finished torch.profiler window, read from its raw kineto events:
    ``key_averages`` builds every event's tree in Python first, seconds a
    window on the H100's host for the same counts and times."""
    from torch.autograd import DeviceType

    kernels, graphs = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0, 0.0])
            k[0] += 1
            k[1] += e.duration_ns() / 1e3
        elif e.name() == "cudaGraphLaunch":
            graphs += 1
    return kernels, graphs


# set once torch.profiler has recorded no kernel of the L2 flush in 10
# windows: the process's later cold timings go to _cold_call_ms directly
_FLUSH_UNSEEN = []


def _cold_call_ms(fn, flush, iters):
    """Mean ms of ``fn`` with the L2 evicted before each call (``flush``
    zeroed), from CUDA events around each call alone: torch.profiler on
    the H100 has recorded nothing for ten windows in a row (§7 of
    PERF.md).  Said so on the log."""
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    fn()
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sum(start.elapsed_time(end) for start, end in pairs) / iters
    say(f"  device time with the L2 flushed from CUDA events around each call instead: "
        f"{ms:.6f} ms")
    return ms


def device_ms(fn, iters, attempts=5, cold=False):
    """Device time per call of ``fn`` in ms from torch.profiler: the mean
    duration of the CUDA kernels it recorded over ``iters`` calls, times the
    kernels a call launches (the records over the calls, rounded up: on the
    H100 a window of many calls has been seen to lose one record).  A
    profiling window that records no device time at all (seen once on the
    H100 for a 1.5 µs kernel), or fewer kernels a call than the port's
    wrappers counted in it (seen on the H100: a reaction-scale gconv window
    that kept the records of one of its two kernels and read half the
    time; a window short of a record or two, which many windows are, still
    rounds up to the count), is taken again, after a pause that grows with
    each attempt, up to ``attempts`` times, and
    then the time comes from CUDA events around the calls (``call_ms``:
    launch overhead included, so an upper bound), said so on the log.
    ``cold``: before each call a 128 MB write (over twice the H100's 50 MB
    L2) evicts what the last call left in the L2; its kernels are left out
    by name (where the profiler records none, the time comes from CUDA
    events around each call after its flush, ``_cold_call_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof, skip=()):
        return {k: v for k, v in cuda_events(prof)[0].items() if k not in skip}

    flush = torch.empty(32 << 20, dtype=torch.float32, device=DEVICE) if cold else None
    skip = set()
    # the flush's kernel names; an empty window (they come in runs on the
    # H100, see kernels_in) is taken again after a growing pause
    for attempt in range(10 if cold and not _FLUSH_UNSEEN else 0):
        time.sleep(0.1 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                flush.zero_()
            torch.cuda.synchronize()
        skip = set(kernels(prof))
        if skip:
            break
    if cold and not skip:
        if not _FLUSH_UNSEEN:
            say("  torch.profiler recorded no kernel of the L2 flush in 10 windows; the "
                "process's cold timings come from CUDA events")
            _FLUSH_UNSEEN.append(True)
        return _cold_call_ms(fn, flush, iters)
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        time.sleep(0.1 * attempt)
        before = _launched()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        counted = _launched() - before
        evs = kernels(prof, skip).values()
        total_us = sum(us for _, us in evs)
        n = sum(c for c, _ in evs)
        per_call = -(-n // iters)
        if total_us > 0 and per_call >= -(-counted // iters):
            return total_us / n * per_call / 1e3
        say(f"  torch.profiler recorded {n} kernel(s) of {counted} counted in {iters} "
            f"calls, device time {total_us:.3f} us; profiling again")
    if cold:
        return _cold_call_ms(fn, flush, iters)
    ms = call_ms(fn, iters)
    say(f"  device time from CUDA events instead (upper bound): {ms:.6f} ms")
    return ms


def kernels_in(fn, counted, attempts=10):
    """(CUDA kernels that torch.profiler records in one call of ``fn``, the
    launches that ``counted.launches`` added in that call).  Empty profiling
    windows come in runs (up to three in a row seen on the H100), and a
    window has been seen to lose one of a call's three records, so a
    window that records no kernel, or fewer than the wrapper counted, is
    taken again, after a pause that grows with each attempt; a count that
    disagrees in every window is returned as the last window read it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        time.sleep(0.1 * attempt)
        before = counted.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(c for c, _ in cuda_events(prof)[0].values())
        launched = counted.launches - before
        if n >= launched and n:
            return n, launched
        if n and attempt == attempts - 1:
            return n, launched
        say(f"  torch.profiler recorded {n} kernel(s) of {launched} counted; "
            "profiling again")
    raise AssertionError(f"torch.profiler recorded no kernel in {attempts} windows")


def library_ms(fn, iters):
    """``device_ms`` of a PyTorch library call used as a yardstick; None,
    with the reason printed, where the library refuses the inputs."""
    try:
        return device_ms(fn, iters)
    except RuntimeError as e:
        say(f"  library call refused: {str(e).splitlines()[0]}")
        return None


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes at the HBM rate and FLOP at
    the FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gconv_bound(C, B, N, Fin, Fout):
    """Every input read once and the output written once, against X W_c
    computed once per graph plus the aggregation."""
    nbytes = 4 * (C * B * N * N + B * N * Fin + C * Fin * Fout + C * Fout + B * N * Fout)
    flops = 2 * C * B * N * (Fin * Fout + N * Fout) + 2 * C * B * N * Fout
    return bound(nbytes, flops)


def phase_environment():
    import torch

    phase(1, "environment")
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this run needs one GPU")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"nvidia-smi: {smi}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    sys.path.insert(0, ROOT)
    import kgcn_tpu_torch  # noqa: F401  (fails outside a checkout)
    return smi


def phase_build():
    from kgcn_tpu_torch.ops import _build

    phase(2, "build")
    t0 = time.time()
    paths = _build.build(log=say)
    say(f"built {sorted(paths)} in {time.time() - t0:.2f} s")


def phase_gconv_check():
    import torch

    from kgcn_tpu_torch.ops.gconv import gconv, gconv_reference

    phase(3, "kernel check: gconv (kgcn_tpu_torch/ops/csrc/gconv.cu)")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    dadj_s = 0.0  # wall time of the DADJ_SHAPES cases, their backward included
    for label, (C, B, N, Fin, Fout) in GCONV_SHAPES:
        t_case = time.time()
        # operands at the model's scales: a normalised adjacency (rows sum
        # ~1), features in [0, 1), Glorot-sized weights
        adj = torch.rand((C, B, N, N), device=DEVICE, generator=gen) * (2.0 / N)
        x = torch.rand((B, N, Fin), device=DEVICE, generator=gen)
        w = torch.randn((C, Fin, Fout), device=DEVICE, generator=gen) / math.sqrt(Fin)
        b = torch.randn((C, Fout), device=DEVICE, generator=gen) * 0.1
        got = gconv(adj, x, w, b)
        want = gconv_reference(adj, x, w, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise AssertionError(f"gconv {label} {(C, B, N, Fin, Fout)}: "
                                 f"max |kernel - plain| = {err}")
        if not torch.equal(got, gconv(adj, x, w, b)):
            raise AssertionError(f"gconv {label}: two launches differ")
        kernels, counted = kernels_in(lambda: gconv(adj, x, w, b), gconv)
        if counted != kernels:
            raise AssertionError(f"gconv {label}: the wrapper counted {counted} "
                                 f"kernels, torch.profiler recorded {kernels}")
        exact = gconv_reference(*(t.double() for t in (adj, x, w, b)))
        err64 = float((got.double() - exact).abs().max())
        plain64 = float((want.double() - exact).abs().max())
        del exact

        def library():
            return (torch.einsum("cbnm,bmi,cif->bnf", adj, x, w)
                    + torch.einsum("cbn,cf->bnf", adj.sum(-1), b))

        lib_err = float((library() - want).abs().max())
        iters = 20 if B * N > 10000 else 100
        plain_ms = device_ms(lambda: gconv_reference(adj, x, w, b), iters)
        kernel_ms = device_ms(lambda: gconv(adj, x, w, b), iters)
        library_ms = device_ms(library, iters)
        host_ms = call_ms(lambda: gconv(adj, x, w, b), iters)
        bound_ms, bound_by = gconv_bound(C, B, N, Fin, Fout)
        rows.append(dict(label=label, shape=(C, B, N, Fin, Fout), err=err,
                         kernel_ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        say(f"gconv {label:15s} C,B,N,Fin,Fout={(C, B, N, Fin, Fout)}: "
            f"max_abs_err={err:.3g} (library {lib_err:.3g}; against f64: kernel "
            f"{err64:.3g}, plain {plain64:.3g}); two launches bitwise equal; {kernels} "
            "kernel(s) a call, as counted; device time: "
            f"kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
            f"library_ms={library_ms:.6f} bound_us={bound_ms * 1e3:.3f} "
            f"({bound_by}); host-loop ms per gconv call={host_ms:.5f}")
        if label in DADJ_SHAPES:
            gconv_gradients_check(label, adj, x, w, b, gen)
            dadj_s += time.time() - t_case
    say(f"gconv: the {len(DADJ_SHAPES)} shapes with the backward check took {dadj_s:.1f} s")
    return rows


def gconv_gradients_check(label, adj, x, w, b, gen):
    """``_GConv.backward`` on the card, all four gradients (dA among them,
    which IG asks for) for a random upstream gradient, against autograd
    through ``gconv_reference`` on the same operands (rtol = atol = 1e-4;
    on bf16 operands, whose backward runs its einsums in bf16 where the
    plain version's autograd runs in f32, within BF16_EINSUM_TOL of the
    gradient's largest magnitude)."""
    import torch

    from kgcn_tpu_torch.ops.gconv import gconv, gconv_reference

    bf16 = x.dtype == torch.bfloat16
    g = torch.randn(x.shape[:2] + (w.shape[2],), device=DEVICE, generator=gen).to(x.dtype)
    grads = []
    for fn in (gconv, gconv_reference):
        ops = [t.detach().clone().requires_grad_(True) for t in (adj, x, w, b)]
        grads.append(torch.autograd.grad(fn(*ops), ops, g))
    errs = []
    for name, got, want in zip(("dadj", "dx", "dw", "db"), *grads):
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        ok = (err <= BF16_EINSUM_TOL * float(want.abs().max()) if bf16
              else torch.allclose(got, want, rtol=TOL, atol=TOL))
        if not ok:
            raise AssertionError(f"gconv {label}: {name} max |kernel - autograd| = {err}")
        errs.append(f"{name} {err:.3g}" + (f" of {float(want.abs().max()):.3g}" if bf16 else ""))
    limit = (f"bf16: within {BF16_EINSUM_TOL} of the largest magnitude" if bf16
             else f"rtol = atol = {TOL}")
    say(f"gconv {label}: backward against autograd through the plain version "
        f"({limit}): max_abs_err {', '.join(errs)}")


# ---------------------------------------------------------------------------
# phase 4: the tiled kernels


def _load_config(path, **over):
    from kgcn_tpu_torch.runtime.config import load_config

    cfg = load_config(path, over)
    cfg["dataset"] = os.path.join(ROOT, cfg["dataset"])
    return cfg


def _path_batch(config_path, compute_dtype="bfloat16"):
    """The first training batch of a shipped config on the tiled backend:
    (TiledCOO of channel 0, its edge weights)."""
    import numpy as np

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = _load_config(config_path)
    ds, info = load_jbl(cfg["dataset"], cfg)
    bs = int(cfg["batch_size"])
    g = Batcher(ds, info, bs, backend=Backend("tiled", compute_dtype)).make_batch(
        np.arange(bs)).graph
    return g.tiled_adj[0], g.edge_weights[0]


def tiled_cases():
    """(label, TiledCOO on the CPU, weights [E], widths, on the main path)."""
    import numpy as np
    import torch

    from kgcn_tpu_torch.ops import tiled_spmm as tt

    def uniform(V, E, seed, vs=None):
        rng = np.random.RandomState(seed)
        return (rng.randint(0, vs or V, E), rng.randint(0, V, E),
                (rng.random_sample(E) + 0.1).astype(np.float32))

    cases = []
    te, w = _path_batch(CONFIG)
    cases.append(("solubility batch", te, w, (81, 50), True))
    te, w = _path_batch(GAT_CONFIG)
    cases.append(("GAT batch", te, w, (50,), True))
    s, r, w = uniform(3000, 30000, seed=1, vs=5000)
    cases.append(("rectangular 5000->3000", tt.build_tiled(
        s, r, 3000, weights=w, num_sender_nodes=5000, ts=256, tr=128, chunk=128),
        torch.from_numpy(w), (64,), False))
    s, r, w = uniform(4000, 16000, seed=6)
    r[r >= 900] = 3100 + r[r >= 900] % 900  # receiver tiles 4-11 get no edge
    cases.append(("empty receiver tiles", tt.build_tiled(
        s, r, 4000, weights=w, ts=256, tr=256, chunk=256),
        torch.from_numpy(w), (48,), False))
    s, r, w = uniform(2000, 12000, seed=2)
    w[::5] = 0.0  # padding edges, dropped from the structure
    need = tt.build_tiled(s, r, 2000, weights=w, ts=256, tr=256, chunk=512)
    budget = 2 * max(need.meta.n_chunks, need.transpose.meta.n_chunks)
    cases.append((f"budget-padded ({budget} chunks)", tt.build_tiled(
        s, r, 2000, weights=w, ts=256, tr=256, chunk=512, chunk_budget=budget),
        torch.from_numpy(w), (40,), False))
    rng = np.random.RandomState(3)
    V, E = 20000, 200000
    s = np.minimum((rng.pareto(1.2, E) * 40).astype(np.int64), V - 1)  # hubs
    r = rng.randint(0, V, E)
    w = (rng.random_sample(E) + 0.1).astype(np.float32)
    cases.append(("locality-relabelled", tt.build_tiled(
        s, r, V, weights=w, ts=512, tr=512, chunk=512, locality=True),
        torch.from_numpy(w), (64,), False))
    s, r, w = uniform(6000, 60000, seed=4)  # 8 row slices per receiver tile
    cases.append(("wide tiles (tr 2048)", tt.build_tiled(
        s, r, 6000, weights=w, ts=2048, tr=2048, chunk=256),
        torch.from_numpy(w), (96,), False))
    V, E, F = SCALE
    s, r, w = uniform(V, E, seed=5)
    ts, tr, chunk = tt.choose_tiling(s, r, V, F)
    cases.append((f"scale V={V} E={E}", tt.build_tiled(
        s, r, V, weights=w, ts=ts, tr=tr, chunk=chunk),
        torch.from_numpy(w), (F,), False))
    return cases


def _csr(te, weights):
    """The structure's sparse matrix (receiver rows, sender columns) as CSR,
    and its 0/1 pattern, built from the same slots the kernels walk."""
    import torch

    from kgcn_tpu_torch.ops import tiled_spmm as tt

    m = te.meta
    valid, send, recv = tt._slot_rows(te)
    w_ext = torch.cat([weights, weights.new_zeros(1)])
    vals = w_ext[te.slot_src.reshape(-1).long()][valid]
    idx = torch.stack([recv[valid], send[valid]])
    shape = (m.num_receivers, m.num_senders)
    mat = torch.sparse_coo_tensor(idx, vals, shape).coalesce().to_sparse_csr()
    pat = torch.sparse_coo_tensor(idx, torch.ones_like(vals), shape).coalesce()
    pat = torch.sparse_coo_tensor(pat.indices(), torch.ones_like(pat.values()),
                                  shape).to_sparse_csr()
    return mat, pat


def tiled_bound(te, F):
    """(bound_ms, bound_by) of the SpMM on this structure's real edges: the
    [num_senders, F] x read once and the [num_receivers, F] output written
    once, per edge its sender, receiver, edge index and weight, 2·F FLOP
    per edge.  Padding slots and filler chunks are not work the function
    needs."""
    m = te.meta
    n_edges = int((te.slot_src < m.num_edges).sum())
    nbytes = 4 * ((m.num_senders + m.num_receivers) * F + 4 * n_edges)
    return bound(nbytes, 2 * n_edges * F)


def sddmm_bound(te, F):
    """(bound_ms, bound_by) of the SDDMM: x [num_senders, F] and g
    [num_receivers, F] read once, each real edge's (edge id, receiver,
    sender) read once, dw [E] written once, 2·F FLOP per real edge."""
    m = te.meta
    n_edges = int((te.slot_src < m.num_edges).sum())
    nbytes = 4 * ((m.num_senders + m.num_receivers) * F + 3 * n_edges + m.num_edges)
    return bound(nbytes, 2 * n_edges * F)


def _check(what, got, want, tol=TOL):
    """max |got - want| (compared in f32, on got's device); raises past
    rtol = atol = ``tol``."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float(), want.float().to(got.device)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: max |kernel - plain| = {err} (limit {tol})")
    return err


def _tiled_errors(label, te, te_cpu, w, w_cpu, x, g, sddmm=True):
    """The tiled kernels on one structure (``te`` on the card, ``te_cpu``
    its host copy) against their plain versions on CPU copies of the same
    inputs, f32 and bf16 payload, rtol = atol = TOL: the SpMM on ``x``, its
    transpose on ``g`` and (``sddmm``) the SDDMM; two launches of each
    bitwise equal.  Returns {kernel and payload: max |kernel - plain|}."""
    import torch

    from kgcn_tpu_torch.ops import tiled_spmm as tt

    # The plain versions run on CPU copies of the same inputs: there
    # index_add_ sums each row in slot order (the kernel sums a row in
    # slot order too, a split row piece by piece).  On the card its
    # atomics reorder the f32 sums, which moves hub rows of thousands
    # of edges (the locality case) by up to ~2e-4.
    xc, gc = x.cpu(), g.cpu()
    errs = {}
    for dt in ("float32", "bfloat16"):
        bf16 = dt == "bfloat16"
        errs[f"spmm {dt}"] = _check(
            f"tiled_spmm {label} {dt}", tt._spmm_launch(te, w, x, bf16),
            tt.tiled_spmm_reference(te_cpu, w_cpu, xc, dt).to(DEVICE))
        errs[f"spmm^T {dt}"] = _check(
            f"tiled_spmm (transpose) {label} {dt}", tt._spmm_launch(te.transpose, w, g, bf16),
            tt.tiled_spmm_reference(te_cpu.transpose, w_cpu, gc, dt).to(DEVICE))
        if sddmm:
            errs[f"sddmm {dt}"] = _check(
                f"tiled_sddmm {label} {dt}", tt._sddmm_launch(te, x, g, bf16),
                tt.tiled_sddmm_edges_reference(te_cpu, xc, gc, dt).to(DEVICE))
    for dt in ("float32", "bfloat16"):
        bf16 = dt == "bfloat16"
        for name, st, op in (("spmm", te, x), ("spmm^T", te.transpose, g)):
            if not torch.equal(tt._spmm_launch(st, w, op, bf16),
                               tt._spmm_launch(st, w, op, bf16)):
                raise AssertionError(f"tiled {name} {label} {dt}: two launches differ")
        if sddmm and not torch.equal(tt._sddmm_launch(te, x, g, bf16),
                                     tt._sddmm_launch(te, x, g, bf16)):
            raise AssertionError(f"tiled sddmm {label} {dt}: two launches differ")
    return errs


def phase_tiled_check():
    import torch

    from kgcn_tpu_torch.ops import tiled_spmm as tt

    phase(4, "kernel check: tiled SpMM and SDDMM (kgcn_tpu_torch/ops/csrc/tiled.cu)")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.time()
    cases = tiled_cases()
    say(f"structures built on the host in {time.time() - t0:.2f} s")
    # the SpMM plans, as the move to the card builds them
    cases = [(label, tt.with_plan(te), *rest) for label, te, *rest in cases]
    rows = []
    for label, te_cpu, w_cpu, widths, on_path in cases:
        te, w = te_cpu.to(DEVICE), w_cpu.to(DEVICE, torch.float32)
        m, mt = te.meta, te.transpose.meta
        n_edges = int((te_cpu.slot_src < m.num_edges).sum())
        say(f"tiled {label}: {m.num_senders} -> {m.num_receivers} nodes, "
            f"{n_edges} edges of {m.num_edges}, (ts, tr, chunk) = "
            f"{(m.ts, m.tr, m.chunk)}, chunks {m.n_chunks} (transpose "
            f"{mt.n_chunks}), locality {te.node_perm is not None}; plans: "
            + "; ".join(f"{d} piece {p.piece}, {p.pieces.shape[0]} pieces, "
                        f"{p.splits.shape[0]} split rows (longest "
                        f"{int(p.splits[:, 2].max()) if p.splits.shape[0] else 0} "
                        "partials)"
                        for d, p in (("forward", te_cpu.plan),
                                     ("transpose", te_cpu.transpose.plan)))
            + "; host ms (both directions) "
            f"{1e3 * (te_cpu.plan.seconds + te_cpu.transpose.plan.seconds):.4f}")
        mat, pat = _csr(te, w)
        for F in widths:
            x = torch.randn((m.num_senders, F), device=DEVICE, generator=gen)
            g = torch.randn((m.num_receivers, F), device=DEVICE, generator=gen)
            # The plain versions run on CPU copies of the same inputs: there
            # index_add_ sums each row in slot order (the kernel sums a row in
            # slot order too, a split row piece by piece).  On the card its
            # atomics reorder the f32 sums, which moves hub rows of thousands
            # of edges (the locality case) by up to ~2e-4.
            errs = _tiled_errors(f"{label} F={F}", te, te_cpu, w, w_cpu, x, g)
            lib_err = float((torch.sparse.mm(mat, x)
                             - tt.tiled_spmm_reference(te, w, x, "float32")).abs().max())
            iters = 10 if n_edges > 500_000 else 50
            xt = x.t().contiguous()
            t = dict(
                spmm=device_ms(lambda: tt._spmm_launch(te, w, x, True), iters),
                spmm_f32=device_ms(lambda: tt._spmm_launch(te, w, x, False), iters),
                spmm_T=device_ms(lambda: tt._spmm_launch(te.transpose, w, g, True), iters),
                spmm_plain=device_ms(
                    lambda: tt.tiled_spmm_reference(te, w, x, "bfloat16"), iters),
                spmm_library=library_ms(lambda: torch.sparse.mm(mat, x), iters),
                sddmm=device_ms(lambda: tt._sddmm_launch(te, x, g, True), iters),
                sddmm_f32=device_ms(lambda: tt._sddmm_launch(te, x, g, False), iters),
                sddmm_plain=device_ms(
                    lambda: tt.tiled_sddmm_edges_reference(te, x, g, "bfloat16"), iters),
                sddmm_library=library_ms(
                    lambda: torch.sparse.sampled_addmm(pat, g, xt, beta=0.0), iters),
            )
            b, by = tiled_bound(te_cpu, F)
            sb, sby = sddmm_bound(te_cpu, F)
            rows.append(dict(label=label, F=F, on_path=on_path,
                             spmm_err=max(v for k, v in errs.items() if "spmm" in k),
                             sddmm_err=max(v for k, v in errs.items() if "sddmm" in k),
                             bound=b, bound_by=by, sddmm_bound=sb, sddmm_bound_by=sby, **t))
            say(f"  F={F}: max |kernel - plain| "
                + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f" (library spmm vs plain f32 {lib_err:.3g}); two launches of "
                "spmm, spmm^T and sddmm (per edge) bitwise equal, f32 and bf16")
            say(f"  F={F} device ms (bf16 payload unless marked): spmm kernel "
                f"{t['spmm']:.6f} (f32 {t['spmm_f32']:.6f}; transpose {t['spmm_T']:.6f}) "
                f"plain {t['spmm_plain']:.6f} "
                f"library {t['spmm_library']}; sddmm kernel "
                f"{t['sddmm']:.6f} (f32 {t['sddmm_f32']:.6f}; with its zeroed [E] "
                f"output) plain {t['sddmm_plain']:.6f} library {t['sddmm_library']}; "
                f"bound spmm {b:.6f} ({by}), sddmm {sb:.6f} ({sby})")
    _check_wrapper_gradients(cases)
    return rows


def _check_wrapper_gradients(cases):
    """The public ``tiled_spmm`` of the GAT batch and the locality case on
    the card against the same call on the CPU (``wrapper_gradients``)."""
    for label, te_cpu, w_cpu, widths, _ in cases:
        if label.startswith(("GAT batch", "locality")):
            wrapper_gradients(label, te_cpu, w_cpu, widths[0])


def wrapper_gradients(label, te_cpu, w_cpu, F, x0=None, compute_dtype="bfloat16"):
    """The public ``tiled_spmm`` (locality permutation in and out, the
    autograd Function) on the card against the same call on the CPU: value,
    dx and d(weights), on ``x0`` (else a random ``[num_senders, F]``) and a
    random cotangent, bf16 payload unless ``compute_dtype`` says otherwise."""
    import torch

    from kgcn_tpu_torch.ops import tiled_spmm as tt

    gen = torch.Generator().manual_seed(1)
    if x0 is None:
        x0 = torch.randn((te_cpu.meta.num_senders, F), generator=gen)
    cot = torch.randn((te_cpu.meta.num_receivers, F), generator=gen)
    res = []
    for dev, te in ((DEVICE, te_cpu.to(DEVICE)), ("cpu", te_cpu)):
        w = w_cpu.to(dev, torch.float32).requires_grad_(True)
        x = x0.to(dev).requires_grad_(True)
        out = tt.tiled_spmm(te, w, x, compute_dtype=compute_dtype)
        (out * cot.to(dev)).sum().backward()
        res.append([t.detach().cpu() for t in (out, x.grad, w.grad)])
    errs = []
    for name, a, b in zip(("value", "dx", "dw"), *res):
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=TOL, atol=TOL):
            raise AssertionError(f"tiled_spmm {label} {name}: GPU vs CPU {err}")
        errs.append(f"{name} {err:.3g}")
    say(f"tiled_spmm {label}: GPU vs CPU ({compute_dtype} payload) max |diff| "
        + ", ".join(errs))


# ---------------------------------------------------------------------------
# phase 5: training through the CLI


class _Tee(io.TextIOBase):
    """stdout that is also kept, so the run's lines can be checked."""

    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.stream.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.stream.flush()


def _counted():
    """{kernel name: (the wrapper function that carries its launch count,
    the count's attribute)}; the bf16 gconv's launches are counted in
    ``gconv.launches`` and, alone, in ``gconv.bf16_launches``."""
    from kgcn_tpu_torch.ops import ell_spmm as te
    from kgcn_tpu_torch.ops import gconv as gconv_mod
    from kgcn_tpu_torch.ops import stream_spmm as ts
    from kgcn_tpu_torch.ops import tiled_spmm as tt

    counted = {"gconv": gconv_mod.gconv, "tiled_spmm": tt.tiled_spmm,
               "tiled_sddmm": tt.tiled_sddmm, "stream_scatter": ts.stream_scatter,
               "stream_scatter_mat": ts.stream_scatter_mat, "stream_dw": ts.stream_dw,
               "ell_spmm": te.spmm_ell_gpu, "ell_spmm_dx": te.spmm_ell_dx_gpu}
    out = {k: (fn, "launches") for k, fn in counted.items()}
    out["gconv_bf16"] = (gconv_mod.gconv, "bf16_launches")
    return out


def _counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counted().items()}


def _launched():
    """The kernels the port's wrappers have launched so far, each once."""
    return sum(v for k, v in _counts().items() if k != "gconv_bf16")


def _zero_counts():
    for fn, attr in _counted().values():
        setattr(fn, attr, 0)


def _write_config(workdir, name, src, **over):
    with open(src) as f:
        cfg = json.load(f)
    cfg.update(over)
    d = os.path.join(workdir, name)
    os.makedirs(d)
    cfg.update(dataset=os.path.join(ROOT, cfg["dataset"]),
               save_model_path=os.path.join(d, "model"),
               save_info_train=os.path.join(d, "info_train.json"),
               save_info_valid=os.path.join(d, "info_valid.json"),
               save_result_valid=os.path.join(d, "result_valid.csv"))
    path = os.path.join(d, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def _schedule(cfg, epochs):
    """(training steps, evaluated batches) of a ``train`` run: the split of
    cmd_train, one validation pass per epoch and the final one."""
    from kgcn_tpu_torch.data.dataset import load_jbl

    num = load_jbl(cfg["dataset"], cfg)[0].num
    n_valid = int(num * float(cfg.get("validation_data_rate", 0.3)))
    bs = int(cfg["batch_size"])
    return (epochs * -(-(num - n_valid) // bs), (epochs + 1) * -(-n_valid // bs))


def train_run(workdir, name, src, epochs, cpu=False, falling=True, **over):
    """One ``cli.main train`` run; checks its lines and files and returns
    (per-epoch training costs, launch counts, steps, evaluated batches, the
    run's stdout)."""
    import numpy as np

    from kgcn_tpu_torch.cli import main as cli

    cfg, path = _write_config(workdir, name, src, epoch=epochs, save_interval=1, **over)
    steps, evals = _schedule(cfg, epochs)
    say(f"-- train {name}: {os.path.relpath(src, ROOT)} with {over}, {epochs} "
        f"epoch(s) on the {'CPU' if cpu else 'GPU'}: {steps} steps, {evals} "
        "evaluated batches")
    tee = _Tee(sys.stdout)
    _zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        cli.main(["train", "--config", path] + (["--cpu"] if cpu else []))
    wall = time.time() - t0
    counts = _counts()
    out = tee.buf.getvalue()
    model = cfg["save_model_path"]
    want_lines = ["[restore] best epoch"] + [
        f"[SAVE] {os.path.join(model, f'model.{e:05d}.ckpt')}" for e in range(1, epochs + 1)
    ] + [f"[SAVE] {cfg[k]}" for k in ("save_result_valid", "save_info_valid",
                                       "save_info_train")]
    for line in want_lines:
        if line not in out:
            raise AssertionError(f"train {name}: no line '{line}'")
    want_files = {f"model.{e:05d}.ckpt" for e in range(1, epochs + 1)} | {
        "model.best.ckpt", "model.last.ckpt", "serve_info.json"}
    if set(os.listdir(model)) != want_files:
        raise AssertionError(f"train {name}: files {sorted(os.listdir(model))}")
    with open(cfg["save_info_train"]) as f:
        costs = json.load(f)["training_cost"]
    if len(costs) != epochs or not np.isfinite(costs).all():
        raise AssertionError(f"train {name}: training costs {costs}")
    if falling and not costs[-1] < costs[0]:
        raise AssertionError(f"train {name}: training cost did not fall: {costs}")
    say(f"-- train {name}: {wall:.2f} s, training costs {costs}, launches {counts}")
    return costs, counts, steps, evals, out


def _expect(name, counts, want):
    """The run's launch counts equal ``want``; kernels it does not name
    must not have launched."""
    want = {k: want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want}")
    say(f"-- {name}: launch counts as predicted: {want}")


def phase_train(workdir):
    phase(5, "train: cli.main train on the tiled and dense backends")
    launches = {k: 0 for k in _counted()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    _, counts, steps, evals, _ = train_run(workdir, "gcn_tiled", CONFIG, 2,
                                           spmm_backend="tiled")
    _expect("train gcn_tiled", counts, {"tiled_spmm": 6 * steps + 3 * evals})
    add(counts)
    _, counts, steps, evals, _ = train_run(workdir, "gat_tiled", GAT_CONFIG, 2,
                                           spmm_backend="tiled")
    _expect("train gat_tiled", counts, {"tiled_spmm": 6 * steps + 3 * evals,
                                        "tiled_sddmm": 3 * steps})
    add(counts)
    # the streaming loop (device_resident false); phase 11 runs the default,
    # the resident runners
    _, counts, steps, evals, _ = train_run(workdir, "gcn_dense", CONFIG, 1,
                                           falling=False, device_resident=False)
    _expect("train gcn_dense", counts, {"gconv": 3 * steps + 3 * evals})
    add(counts)
    ring = dict(dataset=ring700_file(workdir), spmm_backend="dense")
    per_forward = gconv_kernels_a_forward(_load_config(GCN_RING_CONFIG, **ring))
    _, counts, steps, evals, _ = train_run(
        workdir, "gcn_dense_ring700", GCN_RING_CONFIG, 1, falling=False,
        make_plot=False, device_resident=False, **ring)
    _expect("train gcn_dense_ring700", counts, {"gconv": per_forward * (steps + evals)})
    add(counts)

    exact = dict(spmm_backend="tiled", tiled_compute_dtype="float32", dropout_rate=0.0)
    gpu, counts, steps, evals, _ = train_run(workdir, "gcn_f32_gpu", CONFIG, 2, **exact)
    _expect("train gcn_f32_gpu", counts, {"tiled_spmm": 6 * steps + 3 * evals})
    cpu, counts, _, _, _ = train_run(workdir, "gcn_f32_cpu", CONFIG, 2, cpu=True, **exact)
    _expect("train gcn_f32_cpu", counts, {})
    rel = [abs(a - b) / abs(b) for a, b in zip(gpu, cpu)]
    say(f"GPU vs CPU per-epoch training cost: GPU {gpu} CPU {cpu} relative "
        f"difference {rel} (limit {TRAJECTORY_RTOL})")
    if max(rel) > TRAJECTORY_RTOL:
        raise AssertionError(f"GPU and CPU training costs differ by {max(rel)}")
    # dense graphs of 768 padded nodes (the gconv's two-launch design), dropout 0
    cfg = _load_config(GCN_RING_CONFIG, dropout_rate=0.0, **ring)
    per_forward = gconv_kernels_a_forward(cfg, bs=10)
    steps_gpu_vs_cpu("dense GCN (700-node rings, batch 10)", cfg, 3,
                     lambda info: {"gconv": 3 * per_forward}, bs=10)
    steps_repeat_bitwise(workdir)
    segments_without_sync(workdir)
    step_breakdown()
    return launches


def ring700_file(workdir):
    """The ring dataset of 700-node graphs (``RING700``: 32 graphs, padded to
    768 nodes a graph) as a pickle ``.jbl``, written on the first call."""
    path = os.path.join(workdir, "ring700.jbl")
    if not os.path.exists(path):
        from kgcn_tpu_torch.data.synthetic import make_ring_dataset

        with open(path, "wb") as f:
            pickle.dump(make_ring_dataset(**RING700), f, protocol=4)
    return path


def gconv_kernels_a_forward(cfg, bs=None):
    """The gconv kernels that one forward of ``cfg``'s model launches on a
    batch of ``bs`` graphs, as the wrapper counts them (phase 3 holds the
    count to torch.profiler's); at least one for each of its 3 GraphConv
    calls.  Launched before a run's counts are set to 0."""
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.ops.gconv import gconv
    from kgcn_tpu_torch.runtime.train import Trainer

    info, (batch,) = _trainer_batches(cfg, 1, bs)
    trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info, device=DEVICE)
    state = trainer.init_state(seed=0)
    before = gconv.launches
    trainer.eval_step(state.params, state.batch_stats, batch)
    n = gconv.launches - before
    if n < 3:
        raise AssertionError(f"a forward of 3 GraphConv layers launched {n} gconv kernels")
    say(f"-- {os.path.basename(cfg['dataset'])}, batch {bs or cfg['batch_size']}: "
        f"{n} gconv kernels a forward")
    return n


def _trainer_batches(cfg, steps, bs=None, spread=False):
    """(model info, ``steps`` batches of ``bs`` graphs) of a config on its
    resolved backend: the first ones, or with ``spread`` batches that each
    take every ``steps``-th of ``steps·bs`` graphs spread evenly over the
    dataset (a dataset sorted by class gives each batch every class)."""
    import numpy as np

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.runtime import backend

    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    bs = bs or int(cfg["batch_size"])
    tb = Batcher(ds, info, bs, backend=be)
    if spread:
        idx = np.linspace(0, ds.num - 1, steps * bs).astype(np.int64)
        return info, [tb.make_batch(idx[i::steps]) for i in range(steps)]
    return info, [tb.make_batch(np.arange(i * bs, (i + 1) * bs)) for i in range(steps)]


def steps_gpu_vs_cpu(label, cfg, steps, launches, bs=None, rtol=TRAJECTORY_RTOL):
    """``steps`` training steps of ``cfg`` on the GPU and on the CPU from
    one seed, on batches spread over the dataset: costs within ``rtol``
    (TRAJECTORY_RTOL) of the CPU's, and the GPU run's kernel launches equal
    to ``launches(info)``."""
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    info, batches = _trainer_batches(cfg, steps, bs, spread=True)
    costs = {}
    for dev in (DEVICE, "cpu"):
        trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info, device=dev)
        state = trainer.init_state(seed=0)
        _zero_counts()
        c = []
        for batch in batches:
            state, cost, _ = trainer.train_step(state, batch)
            c.append(float(cost))
        costs[dev] = c
        _expect(f"{label} steps on {dev}", _counts(),
                launches(info) if dev == DEVICE else {})
    rel = [abs(a - b) / abs(b) for a, b in zip(costs[DEVICE], costs["cpu"])]
    say(f"GPU vs CPU {label} step costs: GPU {costs[DEVICE]} CPU {costs['cpu']} "
        f"relative difference {rel} (limit {rtol})")
    if max(rel) > rtol:
        raise AssertionError(f"GPU and CPU {label} step costs differ by {max(rel)}")


def steps_repeat_bitwise(workdir, steps=3):
    """Two GPU runs of the first ``steps`` training steps from one seed give
    the same bits, costs and every parameter: GAT on the tiled backend (the
    edge softmax's segment sums, the tiled SpMM and SDDMM), GIN on
    example_config/gin.json with xla (the edge-list scatter's segment sum)
    and GIN on the ring6 data with pallas (the ELL kernel and its dx kernel,
    which must have run)."""
    import torch

    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    for name, src, over in (("gat tiled", GAT_CONFIG, {"spmm_backend": "tiled"}),
                            ("gin xla", GIN_CONFIG, {"spmm_backend": "xla"}),
                            ("gin pallas (ring6)", GIN_CONFIG,
                             {"spmm_backend": "pallas", "dataset": ring6_file(workdir)})):
        cfg = _load_config(src, **over)
        info, batches = _trainer_batches(cfg, steps)
        dx_before = _counts()["ell_spmm_dx"]
        runs = []
        for _ in range(2):
            trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info,
                              device=DEVICE)
            state = trainer.init_state(seed=0)
            costs = []
            for batch in batches:
                state, cost, _ = trainer.train_step(state, batch)
                costs.append(cost.detach().clone())
            runs.append((costs, {k: v.detach().clone() for k, v in state.params.items()}))
        (c1, p1), (c2, p2) = runs
        if "pallas" in name and _counts()["ell_spmm_dx"] == dx_before:
            raise AssertionError(f"{name}: the ELL dx kernel did not run")
        differ = [k for k in p1 if not torch.equal(p1[k], p2[k])]
        if differ or not all(torch.equal(a, b) for a, b in zip(c1, c2)):
            raise AssertionError(f"{name}: two runs of {steps} steps differ: costs "
                                 f"{[float(c) for c in c1]} vs {[float(c) for c in c2]}, "
                                 f"parameters {differ}")
        say(f"{name}: two runs of {steps} GPU steps from seed 0 bitwise equal (costs "
            f"{[float(c) for c in c1]}, {len(p1)} parameters)")


def segments_without_sync(workdir, iters=200):
    """``ops/segment``'s ``segment_sum`` (the xla scatter) and
    ``segment_softmax`` (GAT's edge softmax, masked), their values and
    gradients at a GAT (tiled) batch's shape, with the batch's segments
    (``GraphBatch.receiver_segments``: sorted on the host, sent with one
    copy) and with ids on the card alone, and the ELL aggregation's value
    and dx on a ring6 batch (pallas: the forward kernel, then the dx kernel
    over the batch's transposed slot lists), all without a host sync: under
    ``torch.cuda.set_sync_debug_mode("error")`` a synchronising call
    raises.  Values against ``index_add_`` and a plain softmax (1e-5), the
    ELL ones against the same call on the CPU (1e-5); at the GAT batch's
    shape it also times a value and
    gradient on the host clock against ``index_add_`` (whose atomics do not
    repeat bitwise): the step is host-bound, so this is its cost."""
    import torch

    from kgcn_tpu_torch.ops.segment import segment_softmax, segment_sum
    from kgcn_tpu_torch.ops.spmm import ell_aggregate

    _, (host_batch,) = _trainer_batches(_load_config(GAT_CONFIG, spmm_backend="tiled"), 1)
    moved = host_batch.graph.to(DEVICE)
    V = moved.total_nodes
    segments = moved.receiver_segments(0)
    ids = moved.receivers[0].long()
    E = ids.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    data = torch.randn((E,), device=DEVICE, generator=gen).requires_grad_()
    mask = moved.edge_mask()[0]

    def index_add(d, i, n):
        return torch.zeros((n,), device=d.device, dtype=d.dtype).index_add_(0, i, d)

    def batch_sum(d, i, n):
        return segment_sum(d, i, n, segments)

    def softmax(d, i, n):
        return segment_softmax(d, i, n, mask=mask, sorted_segments=segments)

    def value_and_grad(fn):
        out = fn(data, ids, V)
        return out, torch.autograd.grad(out, data, torch.ones_like(out))[0]

    ell_host = _ring6_batch(workdir, 25).graph
    ell_graph = ell_host.to(DEVICE)
    gen_cpu = torch.Generator().manual_seed(2)
    ell_x = torch.randn((ell_graph.total_nodes, 50), generator=gen_cpu)
    ell_g = torch.randn((ell_graph.total_nodes, 50), generator=gen_cpu)

    def ell_value_and_grad(graph, x, g):
        x = x.clone().requires_grad_(True)
        out = ell_aggregate(graph.ell_senders, graph.ell_weights, x, backend="pallas",
                            transpose=graph.ell_transpose())
        return out, torch.autograd.grad(out, x, g)[0]

    ell_in = (ell_x.to(DEVICE), ell_g.to(DEVICE))
    torch.cuda.synchronize()
    dx_before = _counts()["ell_spmm_dx"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, grad = value_and_grad(batch_sum)
        out_card, grad_card = value_and_grad(segment_sum)  # sorted on the card
        alpha, _ = value_and_grad(softmax)
        ell_out, ell_dx = ell_value_and_grad(ell_graph, *ell_in)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if _counts()["ell_spmm_dx"] != dx_before + 1:
        raise AssertionError("the ELL backward did not launch its dx kernel once")
    for name, a, b in zip(("value", "dx"), (ell_out, ell_dx),
                          ell_value_and_grad(ell_host, ell_x, ell_g)):
        if not torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"ELL aggregation {name} on the card vs CPU: "
                                 f"{float((a.cpu() - b).abs().max())}")
    want = index_add(data.detach(), ids, V)
    for o, g in ((out, grad), (out_card, grad_card)):
        if not torch.allclose(o, want, rtol=1e-5, atol=1e-5) or not torch.equal(
                g, torch.ones_like(data)):
            raise AssertionError("segment_sum on the card: wrong value or gradient")
    if not torch.equal(out, out_card):
        raise AssertionError("segment_sum: the batch's segments and a sort on the "
                             "card sum in different orders")
    e = torch.exp(data.detach() - data.detach().max()) * mask
    want = e / index_add(e, ids, V)[ids].clamp(min=1e-30)
    if not torch.allclose(alpha, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"segment_softmax on the card: off by "
                             f"{float((alpha - want).abs().max())}")
    value_and_grad(index_add)  # warm-up
    host = {}
    for name, fn in (("segment_sum", batch_sum), ("index_add_", index_add)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            value_and_grad(fn)
        torch.cuda.synchronize()
        host.setdefault(name, []).append((time.perf_counter() - t0) / iters * 1e3)
    say(f"segment_sum "
        "(the batch's segments and a sort on the card, equal), segment_softmax and "
        "the ELL aggregation (ring6 batch, its dx kernel): values and gradients on "
        "the card with no host sync (sync debug mode "
        f"error); host ms per segment_sum value and gradient at {E} edges, "
        f"{V} nodes (two rounds): "
        + ", ".join(f"{k} {v}" for k, v in host.items()))


MOLECULE_RUNS = (("gcn_tiled", CONFIG, {"spmm_backend": "tiled"}),
                 ("gat_tiled", GAT_CONFIG, {"spmm_backend": "tiled"}),
                 ("gcn_dense", CONFIG, {}))


def step_breakdown(runs=MOLECULE_RUNS):
    """One epoch of each run's training split (name, config, overrides),
    step by step: host batch assembly (and its tiled-structure or ELL-array
    part), the step's wall time to a synchronise, and, in a second profiled
    epoch, the device's busy time (every CUDA kernel and copy) against the
    epoch's wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl, split_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.train import Trainer

    for name, src, over in runs:
        cfg = _load_config(src, **over)
        ds, info = load_jbl(cfg["dataset"], cfg)
        be = backend.resolve(cfg, info, log=False)
        train, _, _, _ = split_dataset(ds, cfg["validation_data_rate"],
                                       seed=int(cfg["seed"]), shuffle=bool(cfg["shuffle_data"]))
        bs = int(cfg["batch_size"])
        tb = Batcher(train, info, bs, backend=be)
        trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info, device=DEVICE)
        state = trainer.init_state(seed=0)
        state, _, _, _ = trainer.run_epoch(state, tb, epoch=0)  # warm-up
        torch.cuda.synchronize()
        idx = tb.epoch_indices(shuffle=False)
        host, tiled, move, plans, step = [], [], [], [], []
        for start in range(0, len(idx), bs):
            t0, tiled0 = time.perf_counter(), tb.tiled_seconds + tb.ell_seconds
            batch = tb.make_batch(idx[start:start + bs])
            t1 = time.perf_counter()
            # the step's own move to the card, which builds the tiled SpMM plans
            batch = batch.to(DEVICE)
            move.append(time.perf_counter() - t1)
            state, _, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append(t1 - t0)
            tiled.append(tb.tiled_seconds + tb.ell_seconds - tiled0)
            plans.append(sum(d.plan.seconds for t in batch.graph.tiled_adj or ()
                             for d in (t, t.transpose) if d.plan is not None))
            step.append(t2 - t1)
        n = len(step)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _, _, _ = trainer.run_epoch(state, tb, epoch=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(us for _, us in cuda_events(prof)[0].values()) / 1e6
        payload = f", payload {be.compute_dtype}" if be.name == "tiled" else ""
        part = "ELL arrays" if be.name in ("xla", "pallas") else "tiled structures"
        plan = (f", its tiled SpMM plans {np.mean(plans) * 1e3:.4f}" if be.name == "tiled"
                else "")
        say(f"step time {name} ({be.name}{payload}, batch {bs}, "
            f"{n} steps): host batch ms {np.mean(host) * 1e3:.4f} (of which {part} "
            f"{np.mean(tiled) * 1e3:.4f}), step wall ms to sync "
            f"{np.mean(step) * 1e3:.4f} (median {np.median(step) * 1e3:.4f}; of which the "
            f"move to the card {np.mean(move) * 1e3:.4f}{plan}); "
            f"profiled epoch: wall ms/step {wall / n * 1e3:.4f}, device busy "
            f"ms/step {busy / n * 1e3:.4f}, idle share {1 - busy / wall:.4f}")


# ---------------------------------------------------------------------------
# phase 6: serving


def _post(url, payload):
    body = json.dumps(payload).encode()
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, resp = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:  # the body says why
        code, resp = e.code, json.loads(e.read())
    return code, resp, (time.perf_counter() - t0) * 1e3


def _payload(data, idx):
    """Molecules ``idx`` of the dataset as a /predict body (COO ``adj``)."""
    import numpy as np

    return {
        "feature": np.asarray(data["feature"])[idx].tolist(),
        "adj": [[[np.asarray(data["adj"][i][0]).tolist(),
                  np.asarray(data["adj"][i][1]).tolist(),
                  [int(s) for s in data["adj"][i][2]]]] for i in idx],
        "max_node_num": int(data["max_node_num"]),
    }


def phase_serve(workdir):
    import numpy as np
    import torch

    from kgcn_tpu_torch.cli.serve import build_server
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.ops.gconv import gconv
    from kgcn_tpu_torch.runtime import checkpoint as ckpt
    from kgcn_tpu_torch.runtime.config import load_config
    from kgcn_tpu_torch.runtime.serve import Predictor
    from kgcn_tpu_torch.runtime.train import Trainer

    phase(6, "serve: solubility_cls GCN over HTTP")
    data = jbl.load(DATASET)
    cfg = load_config(CONFIG, {"save_model_path": os.path.join(workdir, "model"),
                               "label_dim": 2})
    ds, info = build_dataset(dict(data), cfg)
    say(f"dataset: {ds.num} molecules, {info.graph_node_num} nodes max, "
        f"{info.feature_dim} features, {info.adj_channel_num} channel(s); "
        f"model {cfg['model.py']}, batch {cfg['batch_size']}")
    model = build_model(cfg["model.py"], info, cfg)
    trainer = Trainer(model, cfg, info, device="cpu")
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(1)  # non-trivial BN statistics
    stats = {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).abs() + 0.05
             for k, v in state.batch_stats.items()}
    path = ckpt.save_checkpoint(ckpt.ckpt_name(cfg["save_model_path"], "best"),
                                state.params, stats)
    say(f"checkpoint: {path} ({sum(v.numel() for v in state.params.values())} "
        "parameters, seeded)")

    server, predictor = build_server(cfg, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    offsets = np.cumsum((0,) + REQUEST_SIZES)
    requests = [list(range(int(offsets[i]), int(offsets[i + 1])))
                for i in range(len(REQUEST_SIZES))]
    payloads = [_payload(data, idx) for idx in requests]
    answers = []
    try:
        _zero_counts()
        for idx, body in zip(requests, payloads):
            code, resp, ms = _post(url + "/predict", body)
            if code != 200:
                raise AssertionError(
                    f"/predict {len(idx)} molecules: HTTP {code} {resp}")
            answers.append(resp)
            say(f"request {len(idx):3d} molecules: HTTP {code}, {ms:.2f} ms "
                f"round trip, {resp['latency_ms']:.2f} ms in the predictor")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        launches = gconv.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    say(f"healthz: {json.dumps(health)}")
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    if not (health["ready"] and health["requests"] == len(requests)
            and health["backend"] == torch.cuda.get_device_name(0)):
        raise AssertionError(f"unexpected health {health}")

    bs = int(cfg["batch_size"])
    batches = 1 + sum(-(-len(idx) // bs) for idx in requests)  # + warm-up
    say(f"gconv launches: {launches} for {batches} batches "
        f"(incl. the predictor's one warm-up batch), 3 GraphConv each")
    if launches != 3 * batches:
        raise AssertionError(f"gconv launched {launches} times, want {3 * batches}")

    cpu = Predictor(cfg, checkpoint=path, device="cpu")
    worst = 0.0
    for idx, body, resp in zip(requests, payloads, answers):
        pred = np.asarray(resp["prediction"], np.float64)
        if resp["num"] != len(idx) or pred.shape != (len(idx), 2):
            raise AssertionError(f"{len(idx)} molecules: got shape {pred.shape}")
        if not np.isfinite(pred).all():
            raise AssertionError(f"{len(idx)} molecules: non-finite rows")
        if not np.allclose(pred.sum(axis=1), 1.0, atol=1e-5):
            raise AssertionError(f"{len(idx)} molecules: rows do not sum to 1")
        ref = np.asarray(cpu.predict(body)["prediction"], np.float64)
        worst = max(worst, float(np.abs(pred - ref).max()))
    say(f"GPU vs CPU predictions: max |diff| = {worst:.3g} (limit {TOL})")
    if worst > TOL:
        raise AssertionError(f"GPU and CPU predictions differ by {worst}")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the stream kernels


def make_kg_triples(path, seed=0):
    """Write a triple TSV of WN18RR's published shape (``KG_SHRINK`` 1):
    its entity count, 11 relations with its training-set shares, its number
    of distinct triples; heads and tails Zipf-distributed over a random
    ranking of the entities, every entity at least once, no duplicate and no
    self triple.  Returns the triple count."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = WN18RR_ENTITIES // KG_SHRINK
    total = WN18RR_TRIPLES // KG_SHRINK
    shares = np.asarray(WN18RR_RELATION_COUNTS, np.float64)
    per_rel = np.maximum((shares / shares.sum() * total).astype(np.int64), 1)
    per_rel[0] += total - per_rel.sum()
    R = len(per_rel)
    p = (np.arange(n) + 1.0) ** -ZIPF_EXPONENT
    p /= p.sum()
    rank_to_id = rng.permutation(n)

    def draw(k):
        return rank_to_id[rng.choice(n, k, p=p)]

    rel = np.repeat(np.arange(R), per_rel)
    heads, tails = draw(total), draw(total)
    tails[rng.choice(total, n, replace=False)] = rng.permutation(n)  # cover all
    while True:
        key = (heads * R + rel) * n + tails
        _, first = np.unique(key, return_index=True)
        bad = np.ones(total, bool)
        bad[first] = False
        bad |= heads == tails
        if not bad.any():
            break
        heads[bad] = draw(int(bad.sum()))
    order = rng.permutation(total)
    with open(path, "w") as f:
        f.writelines(f"e{h}\tr{r}\te{t}\n"
                     for h, r, t in zip(heads[order], rel[order], tails[order]))
    return total


def kg_files(workdir):
    """(tsv, jbl): the WN18RR-shaped triples and their ``cli.kg`` output,
    made on the first call."""
    from kgcn_tpu_torch.cli import kg as kg_cli

    d = os.path.join(workdir, "kg_data")
    tsv, jbl_path = os.path.join(d, "triples.tsv"), os.path.join(d, "kg.jbl")
    if not os.path.exists(jbl_path):
        os.makedirs(d, exist_ok=True)
        t0 = time.time()
        n = make_kg_triples(tsv)
        say(f"WN18RR-shaped triple TSV: {n} triples ({time.time() - t0:.2f} s)")
        t0 = time.time()
        kg_cli.main(["--input", tsv, "--output", jbl_path,
                     "--test-rate", str(KG_TEST_RATE)])
        say(f"python -m kgcn_tpu_torch.cli.kg: {time.time() - t0:.2f} s")
    return tsv, jbl_path


def kg_config(workdir, name, **over):
    """The KG config of the main path (example_config/kg.json with
    ``KG_OVERRIDES``) on the generated dataset, its outputs in its own
    directory: (config dict, path)."""
    _, jbl_path = kg_files(workdir)
    with open(KG_CONFIG) as f:
        cfg = json.load(f)
    cfg.update(KG_OVERRIDES)
    cfg.update(over)
    d = os.path.join(workdir, name)
    os.makedirs(d, exist_ok=True)
    cfg.update(dataset=jbl_path, save_model_path=os.path.join(d, "model"),
               save_info_train=os.path.join(d, "info_train.json"),
               save_info_test=os.path.join(d, "info_test.json"),
               save_edge_result=os.path.join(d, "edges.csv"))
    path = os.path.join(d, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return _load_config(path, dataset=jbl_path), path


def kg_batcher(cfg, device=None, seed=0):
    """(KGBatcher, info, backend) of a KG config, graph batch built on the
    host and moved to ``device``."""
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.kg import KGBatcher
    from kgcn_tpu_torch.runtime import backend

    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    kb = KGBatcher(ds, info, label_batch_size=cfg["label_batch_size"], seed=seed,
                   backend=be, device=device)
    return kb, info, be


def stream_cases(workdir):
    """(label, StreamCOO on the CPU, widths, on the main path)."""
    import numpy as np

    from kgcn_tpu_torch.ops import stream_spmm as ts

    def uniform(V, E, seed, vs=None):
        rng = np.random.RandomState(seed)
        return (rng.randint(0, vs or V, E), rng.randint(0, V, E),
                (rng.random_sample(E) + 0.1).astype(np.float32))

    cfg, _ = kg_config(workdir, "kg_structures")
    kb, info, be = kg_batcher(cfg)
    if be.name != "stream":
        raise AssertionError(f"the KG resolved to {be.name}, want stream")
    sts = kb.graph_batch.graph.stream_adj
    real = [int((st.slot_src < st.meta.num_edges).sum()) for st in sts]
    say(f"KG graph batch: {info.all_node_num} entities ({sts[0].meta.num_receivers} "
        f"padded), {len(sts)} channels, {sum(real)} edges, built in "
        f"{kb.host_seconds:.2f} s (stream structures {kb.stream_seconds:.2f} s)")
    F = int(cfg["embedding_dim"])
    big, small = int(np.argmax(real)), int(np.argmin(real))
    cases = [(f"KG channel {big} (largest)", sts[big], (F,), True),
             (f"KG channel {small} (smallest)", sts[small], (F,), True)]
    V, E, Fs = SCALE
    s, r, w = uniform(V, E, seed=5)
    cases.append((f"scale V={V} E={E}", ts.build_stream(
        s, r, V, weights=w, **ts.choose_stream(s, r, V, Fs)), (Fs,), False))
    V = sts[0].meta.num_receivers
    s, r, _ = uniform(V, 2 * V + HUB_EDGES, seed=3)
    r[2 * V:] = V // 3  # one receiver with HUB_EDGES in-edges
    w = hub_weights(s, r, V)
    cases.append((f"hub V={V} E={len(s)}", ts.build_stream(
        s, r, V, weights=w, **ts.choose_stream(s, r, V, F)), (F,), False))
    w = (np.random.RandomState(4).random_sample(len(s)) + 0.1).astype(np.float32)
    cases.append((f"hub V={V} E={len(s)}, order-1 weights", ts.build_stream(
        s, r, V, weights=w, **ts.choose_stream(s, r, V, F)), (F,), False))
    s, r, w = uniform(3000, 30000, seed=1, vs=5000)
    cases.append(("rectangular 5000->3000", ts.build_stream(
        s, r, 3000, weights=w, num_sender_nodes=5000), (64, 200), False))
    s, r, w = uniform(2000, 12000, seed=2)
    w[::5] = 0.0  # padding edges, dropped from the structure
    need = ts.build_stream(s, r, 2000, weights=w)
    budget = 2 * max(need.meta.n_macros, need.transpose.meta.n_macros)
    cases.append((f"budget-padded ({budget} macros)", ts.build_stream(
        s, r, 2000, weights=w, macro_budget=budget), (40, 133), False))
    return cases


def hub_weights(s, r, V):
    """Edge weights as the KG's channels carry them (cli.kg's symmetric
    normalisation): 1 / sqrt(d(r) d(s)), d the in-degree (at least 1).
    With weights of order 1 instead (the second hub case), the plain
    version's own f32 rounding over the hub row's 50 000 terms in slot order
    (~2e-3 from the exact sum of a row of magnitude ~150) exceeds the 1e-4
    check, whatever order the kernel sums in: there the scatters are held
    against an f64 sum (``_exact_rows``)."""
    import numpy as np

    deg = np.maximum(np.bincount(r, minlength=V), 1)
    return (1.0 / np.sqrt(deg[r] * deg[s])).astype(np.float32)


def _stream_csr(ss):
    """The structure's matrix (receiver rows, sender columns, baked
    weights) as CSR, and its 0/1 pattern, from the slots the kernels walk."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    m = ss.meta
    valid, send, recv = ts._slot_rows(ss)
    idx = torch.stack([recv[valid], send[valid]])
    vals = ss.w_slots[valid]
    shape = (m.num_receivers, m.num_senders)
    mat = torch.sparse_coo_tensor(idx, vals, shape).coalesce().to_sparse_csr()
    pat = torch.sparse_coo_tensor(idx, torch.ones_like(vals), shape).coalesce()
    pat = torch.sparse_coo_tensor(pat.indices(), torch.ones_like(pat.values()),
                                  shape).to_sparse_csr()
    return mat, pat


def stream_bound(ss, F, kind, touched=True):
    """(bound_ms, bound_by) on this structure's real edges: the rows of the
    [num_senders, F] x and [num_receivers, F] dy that the edges touch, each
    read once, and the output written once (the scatters' [num_receivers, F]
    out, every row; the weight gradient's [slots], padding included); per
    edge its sender and, by kind, its receiver row and weight (scatter), its
    one-hot row of tr_w bf16 (scatter_mat) or its slot and receiver row
    (dw); 2·F FLOP per edge.  Padding slots are not needed work.
    ``touched=False``: every row of x and dy instead, as PRs 3-8 counted."""
    import torch

    m = ss.meta
    slot, row, send = ss.plan.entries.long()
    n_edges = len(slot)
    per_edge = {"scatter": 12, "scatter_mat": 4 + 2 * m.tr_w, "dw": 12}[kind]
    senders = torch.unique(send).numel() if touched else m.num_senders
    receivers = torch.unique(row).numel() if touched else m.num_receivers
    if kind == "dw":
        nbytes = 4 * (senders + receivers) * F + 4 * m.slots
    else:
        nbytes = 4 * (senders + m.num_receivers) * F
    return bound(nbytes + per_edge * n_edges, 2 * n_edges * F)


def phase_stream_check(workdir):
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    phase(7, "kernel check: stream scatter, one-hot scatter and weight gradient "
          "(kgcn_tpu_torch/ops/csrc/stream.cu)")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.time()
    cases = stream_cases(workdir)
    say(f"structures built on the host in {time.time() - t0:.2f} s")
    rows = []
    synced = False
    for label, ss_cpu, widths, on_path in cases:
        ss = ss_cpu.to(DEVICE)
        m, mt = ss.meta, ss.transpose.meta
        n_edges = int((ss_cpu.slot_src < m.num_edges).sum())
        say(f"stream {label}: {m.num_senders} -> {m.num_receivers} nodes, {n_edges} "
            f"edges of {m.num_edges}, (tr_w, chunk, mc, wb) = "
            f"{(m.tr_w, m.chunk, m.mc, m.wb)}, slots {m.slots} (transpose "
            f"{mt.slots}), one-hots {ss.oh is not None}; the weight gradient reads "
            f"{dw_dy_reads(ss_cpu)} dy rows at F 128 for its {n_edges} edges")
        mat, pat = _stream_csr(ss)
        padding = ss.slot_sender >= m.num_senders
        for F in widths:
            x = torch.randn((m.num_senders, F), device=DEVICE, generator=gen)
            g = torch.randn((m.num_receivers, F), device=DEVICE, generator=gen)
            # plain versions on CPU copies: index_add_ sums in slot order there
            xc, gc = x.cpu(), g.cpu()
            hub = label.startswith("hub")
            if not synced:
                dw_without_sync(ss, x, g)
                synced = True

            def held(what, got, ss_c, w_c, x_c, mode, plain):
                """The kernel against its plain version (1e-4) and, on the hub
                cases, against an f64 sum; the order-1 hub against the f64 sum
                alone, the plain version's own error there being larger."""
                plain = plain()
                if not hub:
                    return _check(what, got, plain.to(DEVICE))
                exact, tol = _exact_rows(ss_c, w_c, x_c, mode)
                err = _check_exact(what, got, exact, tol)
                say(f"  {what}: against an f64 sum kernel {err:.3g}, plain "
                    f"{float((plain.double() - exact).abs().max()):.3g} (tolerance "
                    f"up to {float(tol.max()):.3g})")
                if "order-1" not in label:
                    _check(what, got, plain.to(DEVICE))
                return err

            errs = {}
            for dt in ("float32", "bfloat16"):
                bf16 = dt == "bfloat16"
                errs[f"scatter {dt}"] = held(
                    f"stream_scatter {label} F={F} {dt}",
                    ts._scatter_launch(ss, ss.w_slots, x, bf16), ss_cpu, ss_cpu.w_slots,
                    xc, dt, lambda: ts.stream_scatter_reference(ss_cpu, ss_cpu.w_slots,
                                                                xc, dt))
                errs[f"scatter^T {dt}"] = held(
                    f"stream_scatter (transpose) {label} F={F} {dt}",
                    ts._scatter_launch(ss.transpose, ss.transpose.w_slots, g, bf16),
                    ss_cpu.transpose, ss_cpu.transpose.w_slots, gc, dt,
                    lambda: ts.stream_scatter_reference(
                        ss_cpu.transpose, ss_cpu.transpose.w_slots, gc, dt))
                dw = ts._dw_launch(ss, x, g, bf16)
                errs[f"dw {dt}"] = _check(f"stream_dw {label} F={F} {dt}", dw,
                                          ts.stream_dw_reference(ss_cpu, xc, gc, dt))
                if bool(dw[padding].ne(0).any()):
                    raise AssertionError(f"stream_dw {label} F={F} {dt}: a padding "
                                         "slot is not 0")
            errs["scatter_mat"] = held(
                f"stream_scatter_mat {label} F={F}", ts._scatter_mat_launch(ss, x),
                ss_cpu, ss_cpu.oh, xc, "onehot",
                lambda: ts.stream_scatter_mat_reference(ss_cpu, ss_cpu.oh, xc))
            errs["scatter_mat^T"] = held(
                f"stream_scatter_mat (transpose) {label} F={F}",
                ts._scatter_mat_launch(ss.transpose, g), ss_cpu.transpose,
                ss_cpu.transpose.oh, gc, "onehot",
                lambda: ts.stream_scatter_mat_reference(ss_cpu.transpose,
                                                        ss_cpu.transpose.oh, gc))
            _check_repeatable(label, F, ss, x, g)
            lib_err = float((torch.sparse.mm(mat, x) - ts.stream_scatter_reference(
                ss, ss.w_slots, x, "float32")).abs().max())
            iters = 10 if n_edges > 500_000 else 50
            xt = x.t().contiguous()
            w = ss.w_slots
            t = dict(
                scatter=device_ms(lambda: ts._scatter_launch(ss, w, x, False), iters),
                scatter_bf16=device_ms(lambda: ts._scatter_launch(ss, w, x, True), iters),
                scatter_plain=device_ms(
                    lambda: ts.stream_scatter_reference(ss, w, x, "float32"), iters),
                scatter_mat=device_ms(lambda: ts._scatter_mat_launch(ss, x), iters),
                scatter_mat_plain=device_ms(
                    lambda: ts.stream_scatter_mat_reference(ss, ss.oh, x), iters),
                spmm_library=library_ms(lambda: torch.sparse.mm(mat, x), iters),
                dw=device_ms(lambda: ts._dw_launch(ss, x, g, True), iters),
                dw_f32=device_ms(lambda: ts._dw_launch(ss, x, g, False), iters),
                dw_cold=device_ms(lambda: ts._dw_launch(ss, x, g, True), iters, cold=True),
                dw_plain=device_ms(
                    lambda: ts.stream_dw_reference(ss, x, g, "bfloat16"), iters),
                dw_library=library_ms(
                    lambda: torch.sparse.sampled_addmm(pat, g, xt, beta=0.0), iters),
            )
            bounds = {k: stream_bound(ss_cpu, F, k) for k in ("scatter", "scatter_mat", "dw")}
            bounds["dw, every row"] = stream_bound(ss_cpu, F, "dw", touched=False)
            rows.append(dict(label=label, F=F, on_path=on_path, bounds=bounds,
                             scatter_err=max(v for k, v in errs.items()
                                             if k.startswith("scatter ")
                                             or k.startswith("scatter^T")),
                             mat_err=max(errs["scatter_mat"], errs["scatter_mat^T"]),
                             dw_err=max(v for k, v in errs.items() if k.startswith("dw")),
                             **t))
            say(f"  F={F}: max |kernel - plain| "
                + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f" (library spmm vs plain f32 {lib_err:.3g})")
            say(f"  F={F} device ms: scatter f32 {t['scatter']:.6f} (bf16 "
                f"{t['scatter_bf16']:.6f}) plain f32 {t['scatter_plain']:.6f}; "
                f"scatter_mat {t['scatter_mat']:.6f} plain {t['scatter_mat_plain']:.6f}; "
                f"library spmm {t['spmm_library']}; dw bf16 {t['dw']:.6f} (f32 "
                f"{t['dw_f32']:.6f}; bf16 with the L2 cold {t['dw_cold']:.6f}) plain "
                f"{t['dw_plain']:.6f} library {t['dw_library']}; "
                "bounds " + ", ".join(f"{k} {b:.6f} ({by})" for k, (b, by) in bounds.items()))
        if label.startswith("rectangular"):
            rows[-1]["dw_err"] = max(rows[-1]["dw_err"], _check_dw_layouts(label, ss_cpu, ss,
                                                                           gen))
    _check_stream_gradients(cases)
    return rows


def _exact_rows(ss, w, x, mode):
    """(f64 sums, tolerance) of a stream scatter's output rows on the CPU:
    the messages of the kernel's payload (``mode`` float32, bfloat16 or
    onehot, ``w`` the slot weights or the one-hots) summed in float64, and
    per row 1e-4 + sqrt(n)·2^-24·Σ|message|, n the row's messages — the
    probabilistic bound of an f32 sum of n terms in any order (Higham and
    Mary, SIAM J. Sci. Comput. 41(5), 2019), so a row's tolerance grows with
    its length as its rounding error does."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    m = ss.meta
    valid, send, recv = ts._slot_rows(ss)
    slot = valid.nonzero().squeeze(1)
    x = x.to(torch.float32)
    if mode == "onehot":
        wv, xs = w[slot, ss.r_loc.reshape(-1)[slot].long()].float(), ts._rb(x[send[slot]])
    else:
        wv, xs = w[slot], x[send[slot]]
        if mode == "bfloat16":
            wv, xs = ts._rb(wv), ts._rb(xs)
    msg = wv.double()[:, None] * xs.double()
    rows = recv[slot]
    exact = torch.zeros((m.num_receivers, x.shape[1]), dtype=torch.float64)
    exact.index_add_(0, rows, msg)
    mag = torch.zeros_like(exact).index_add_(0, rows, msg.abs())
    n = torch.bincount(rows, minlength=m.num_receivers).double()
    return exact, TOL + n.sqrt()[:, None] * 2.0 ** -24 * mag


def _check_exact(what, got, exact, tol):
    """max |got - exact|; raises where a row's entry passes its tolerance."""
    diff = (got.cpu().double() - exact).abs()
    if (diff > tol).any():
        raise AssertionError(f"{what}: kernel off the f64 sum by {float(diff.max())} "
                             f"(tolerance {float(tol.max())})")
    return float(diff.max())


def dw_dy_reads(ss):
    """The dy rows the weight-gradient kernel reads at F 128, where a warp
    walks a span of the plan's entries holding dy from one entry to the
    next: one per run of a receiver row in a span."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    plan = ss.plan
    row = plan.entries[1].long()
    span = torch.arange(len(row)) // ts._dw_span(plan, 128)
    return torch.unique_consecutive(span * ss.meta.num_receivers + row).numel()


def _check_dw_layouts(label, ss_cpu, ss, gen):
    """The weight-gradient kernel's lane layouts that the cases' widths
    leave out, on one structure, both payloads: 4 consecutive columns a
    lane in groups of 4 (F 16) and 8 (F 32); 4 strided in groups of 4 (F 5),
    8 (F 27) and 16 (F 33); and F 128 with x and dy off 16-byte alignment (4
    strided in a group of 32).  Each within 1e-4 of the plain version, its
    padding slots exactly 0, two launches bitwise equal.  Returns the
    largest error."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    m = ss.meta
    padding = ss.slot_sender >= m.num_senders
    errs = []
    for F, off in ((5, 0), (16, 0), (27, 0), (32, 0), (33, 0), (128, 1)):
        # off: the rows start a float past a 16-byte boundary
        x = torch.randn(m.num_senders * F + off, device=DEVICE, generator=gen)[off:]
        g = torch.randn(m.num_receivers * F + off, device=DEVICE, generator=gen)[off:]
        x, g = x.view(m.num_senders, F), g.view(m.num_receivers, F)
        what = f"stream_dw {label} F={F}" + (" unaligned" if off else "")
        for dt in ("float32", "bfloat16"):
            dw = ts._dw_launch(ss, x, g, dt == "bfloat16")
            errs.append(_check(f"{what} {dt}", dw,
                               ts.stream_dw_reference(ss_cpu, x.cpu(), g.cpu(), dt)))
            if bool(dw[padding].ne(0).any()):
                raise AssertionError(f"{what} {dt}: a padding slot is not 0")
            if not torch.equal(dw, ts._dw_launch(ss, x, g, dt == "bfloat16")):
                raise AssertionError(f"{what} {dt}: two launches differ")
    say(f"  stream_dw lane layouts at F 5, 16, 27, 32, 33 and unaligned 128: max |kernel - "
        f"plain| {max(errs):.3g}, padding 0, two launches bitwise equal")
    return max(errs)


def dw_without_sync(ss, x, g):
    """One weight-gradient launch under ``torch.cuda.set_sync_debug_mode(
    "error")``, where a synchronising call raises."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts._dw_launch(ss, x, g, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say("  stream_dw launched under sync debug mode \"error\": no host sync")


def _check_repeatable(label, F, ss, x, g):
    """Two launches of each scatter and of the weight gradient on the same
    inputs give the same bits (each sum runs in a fixed order; no atomics on
    values)."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    runs = {
        "scatter f32": lambda: ts._scatter_launch(ss, ss.w_slots, x, False),
        "scatter bf16": lambda: ts._scatter_launch(ss, ss.w_slots, x, True),
        "scatter^T f32": lambda: ts._scatter_launch(ss.transpose, ss.transpose.w_slots,
                                                    g, False),
        "scatter_mat": lambda: ts._scatter_mat_launch(ss, x),
        "scatter_mat^T": lambda: ts._scatter_mat_launch(ss.transpose, g),
        "dw f32": lambda: ts._dw_launch(ss, x, g, False),
        "dw bf16": lambda: ts._dw_launch(ss, x, g, True),
    }
    for name, run in runs.items():
        if not torch.equal(run(), run()):
            raise AssertionError(f"{name} {label} F={F}: two launches differ")
    say(f"  F={F}: two launches bitwise equal: {', '.join(runs)}")


def _check_stream_gradients(cases):
    """The public ``stream_spmm_edges`` (the autograd Function: dx on the
    transpose, dw by the weight-gradient kernel) and the static route's dx,
    on the card against the same calls on the CPU, both payloads."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    for label, ss_cpu, widths, _ in cases:
        if "smallest" not in label and not label.startswith("rectangular"):
            continue
        F, m = widths[0], ss_cpu.meta
        gen = torch.Generator().manual_seed(1)
        x0 = torch.randn((m.num_senders, F), generator=gen)
        cot = torch.randn((m.num_receivers, F), generator=gen)
        w0 = torch.rand(m.num_edges, generator=gen) + 0.1
        for dt in ("float32", "bfloat16"):
            res = []
            for dev, ss in ((DEVICE, ss_cpu.to(DEVICE)), ("cpu", ss_cpu)):
                # fresh leaves on both devices (.to("cpu") would alias x0)
                w = w0.to(dev).clone().requires_grad_(True)
                x = x0.to(dev).clone().requires_grad_(True)
                out = ts.stream_spmm_edges(ss, w, x, compute_dtype=dt)
                (out * cot.to(dev)).sum().backward()
                xs = x0.to(dev).clone().requires_grad_(True)
                (ts.stream_spmm(ss, x=xs, compute_dtype=dt) * cot.to(dev)).sum().backward()
                res.append([t.detach().cpu() for t in (out, x.grad, w.grad, xs.grad)])
            for name, a, b in zip(("value", "dx", "dw", "baked dx"), *res):
                err = float((a - b).abs().max())
                if not torch.allclose(a, b, rtol=TOL, atol=TOL):
                    raise AssertionError(f"stream_spmm {label} {dt} {name}: GPU vs CPU {err}")
                say(f"stream_spmm {label} {dt}: {name} GPU vs CPU max |diff| {err:.3g}")


# ---------------------------------------------------------------------------
# phase 8: knowledge-graph link prediction through the CLIs


def _cli(argv, cpu=False, cli=None):
    """One run of ``cli.main`` (or of the module ``cli``'s ``main``) in this
    process: (stdout text, returned value, launch counts, wall seconds)."""
    if cli is None:
        from kgcn_tpu_torch.cli import main as cli

    tee = _Tee(sys.stdout)
    _zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        result = cli.main(argv + (["--cpu"] if cpu else []))
    return tee.buf.getvalue(), result, _counts(), time.time() - t0


def kg_run(workdir, name, **over):
    """``train`` then ``infer`` of one KG config on the GPU, lines, files
    and launch counts checked; returns (launches, training costs, infer
    result)."""
    import numpy as np

    from kgcn_tpu_torch.data.dataset import load_jbl

    cfg, path = kg_config(workdir, name, **over)
    ds, info = load_jbl(cfg["dataset"], cfg)
    C = info.adj_channel_num
    epochs = int(cfg["epoch"])
    L = int(cfg["label_batch_size"])
    n_train = len(ds.label_list[0])
    steps = epochs * -(-n_train // L)
    payload = cfg.get("tiled_compute_dtype", "bfloat16")
    kernel = "stream_scatter_mat" if payload == "bfloat16" else "stream_scatter"
    say(f"-- kg {name}: {info.all_node_num} entities, {C} relations, {n_train} "
        f"training triples, label batch {L}, {epochs} epoch(s) = {steps} steps, "
        f"payload {payload}")
    from kgcn_tpu_torch.runtime.runner import WARMUP_STEPS

    launches = {k: 0 for k in _counted()}
    want = {k: 0 for k in _counted()}
    want[kernel] = 4 * C * (steps + WARMUP_STEPS)
    # the scanned epoch, each step replayed from a captured graph: the
    # wrappers count the warm-up and the capture, the profiler the launches
    # (a run whose records fall short, _short, is taken again)
    for attempt in range(PROFILER_ATTEMPTS):
        (out, _, counts, wall), kernels, graphs, busy, pwall = profiled(
            lambda: _cli(["train", "--config", path]))
        kernels = _profiler_launches(kernels, counts)
        if not _short(kernels, want, graphs, steps) or attempt == PROFILER_ATTEMPTS - 1:
            break
        say(f"  torch.profiler recorded {kernels} of {want}; the training is taken again")
    if "[spmm] backend: stream" not in out:
        raise AssertionError(f"kg {name}: the run did not take the stream backend")
    costs = [float(line.split("training cost ")[1].split()[0])
             for line in out.splitlines() if line.startswith("epoch ")]
    if len(costs) != epochs or not np.isfinite(costs).all():
        raise AssertionError(f"kg {name}: training costs {costs}")
    if epochs > 1 and not costs[-1] < costs[0]:
        raise AssertionError(f"kg {name}: training cost did not fall: {costs}")
    model = cfg["save_model_path"]
    if os.listdir(model) != ["model.last.ckpt"] or not os.path.exists(cfg["save_info_train"]):
        raise AssertionError(f"kg {name}: files {os.listdir(model)}")
    say(f"-- kg {name} train: {wall:.2f} s, training costs {costs}")
    _expect(f"kg {name} train (warm-up and capture)", counts,
            {kernel: 4 * C * (WARMUP_STEPS + 1)})
    if kernels != want or graphs != steps:
        raise AssertionError(f"kg {name} train: profiler launches {kernels}, {graphs} graph "
                             f"launches; want {want}, {steps}")
    say(f"-- kg {name} train: {graphs} graph launches (one a step), {want[kernel]} "
        f"{kernel} launches in the profiler = 4·C x ({steps} steps + {WARMUP_STEPS} "
        f"warm-up); device busy {busy:.3f} s of {pwall:.3f} s")
    for k, v in kernels.items():
        launches[k] += v
    out, result, counts, wall = _cli(["infer", "--config", path])
    n_test = int(WN18RR_TRIPLES // KG_SHRINK * KG_TEST_RATE)
    ok = (np.isfinite(list(result.values())).all() and 1.0 <= result["mean_rank"]
          <= info.all_node_num and all(0.0 <= result[k] <= 1.0
                                       for k in ("mrr", "hits@1", "hits@10")))
    if not ok or result["num_test_triples"] != n_test:
        raise AssertionError(f"kg {name}: infer result {result}, want {n_test} triples")
    for f in (cfg["save_info_test"], cfg["save_edge_result"]):
        if not os.path.exists(f):
            raise AssertionError(f"kg {name}: infer wrote no {f}")
    say(f"-- kg {name} infer: {wall:.2f} s, {json.dumps(result)}")
    _expect(f"kg {name} infer", counts, {kernel: 2 * C})
    for k, v in counts.items():
        launches[k] += v
    return launches, costs, result


def kg_gpu_vs_cpu(workdir, steps=3, precision="float32"):
    """The KG training's first steps on the GPU and on the CPU, from one
    seed (weights drawn on the CPU, the same label slices and negatives):
    per-step costs within TRAJECTORY_RTOL with the float32 payload, or at
    ``"precision": "bfloat16"`` with its default bf16 payload (the one-hot
    route) within BF16_STEP_RTOL."""
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    bf16 = precision == "bfloat16"
    kernel, rtol = (("stream_scatter_mat", BF16_STEP_RTOL) if bf16
                    else ("stream_scatter", TRAJECTORY_RTOL))
    over = dict(precision=precision) if bf16 else dict(tiled_compute_dtype="float32")
    cfg, _ = kg_config(workdir, f"kg_gpu_vs_cpu_{precision}", **over)
    costs = {}
    for dev in (DEVICE, "cpu"):
        kb, info, _ = kg_batcher(cfg, device=dev)
        trainer = Trainer(build_model("kg_distmult", info, cfg), cfg, info, device=dev)
        state = trainer.init_state(seed=0)
        _zero_counts()
        c = []
        for _, batch in zip(range(steps), kb.batches()):
            state, cost, _ = trainer.train_step(state, batch)
            c.append(float(cost))
        costs[dev] = c
        want = {kernel: 4 * info.adj_channel_num * steps} if dev == DEVICE else {}
        _expect(f"kg steps at {precision} on {dev}", _counts(), want)
    rel = [abs(a - b) / abs(b) for a, b in zip(costs[DEVICE], costs["cpu"])]
    say(f"GPU vs CPU KG step costs ({precision}, {cfg.get('tiled_compute_dtype', 'bfloat16')} "
        f"payload): GPU {costs[DEVICE]} CPU {costs['cpu']} relative difference {rel} "
        f"(limit {rtol})")
    if max(rel) > rtol:
        raise AssertionError(f"GPU and CPU KG step costs at {precision} differ by {max(rel)}")


def kg_step_breakdown(workdir, steps=20):
    """The bf16 KG training step by step: the graph batch's one-time host
    build (and its stream structures), then per step the host time of the
    label slice and its negatives, the step's wall time to a synchronise,
    and over a profiled window the device's busy time and idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg, _ = kg_config(workdir, "kg_breakdown")
    t0 = time.perf_counter()
    kb, info, be = kg_batcher(cfg, device=DEVICE)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    trainer = Trainer(build_model("kg_distmult", info, cfg), cfg, info, device=DEVICE)
    state = trainer.init_state(seed=0)
    t0 = time.perf_counter()
    lls, lvs = kb._epoch_label_lists(True)
    lists = (time.perf_counter() - t0) / len(lls)
    S = len(lls)
    for i in range(3):  # warm-up
        state, _, _ = trainer.train_step(state, kb._with_labels(lls[i % S], lvs[i % S]))
    torch.cuda.synchronize()
    host, step = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        batch = kb._with_labels(lls[i % S], lvs[i % S])
        t1 = time.perf_counter()
        state, _, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        host.append(lists + t1 - t0)
        step.append(time.perf_counter() - t1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _, _ = trainer.train_step(state, kb._with_labels(lls[i % S], lvs[i % S]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = cuda_events(prof)[0]
    busy = sum(us for _, us in events.values()) / 1e6
    top = sorted(events.items(), key=lambda kv: -kv[1][1])[:10]
    for key, (count, us) in top:
        t = us / 1e3 / steps
        say(f"  kg step device ms {t:.4f} ({t / (busy * 1e3 / steps):.3f} of busy) "
            f"in {count / steps:.1f} launches a step: {key[:90]}")
    scatter = [v for k, v in events.items() if "stream_scatter" in k]
    t = sum(us for _, us in scatter) / 1e3 / steps
    share = t / (busy * 1e3 / steps) if busy else float("nan")
    say(f"  kg step: the stream scatter kernel {t:.4f} device ms a step "
        f"({share:.3f} of busy) in "
        f"{sum(c for c, _ in scatter) / steps:.1f} launches a step")
    say(f"step time kg ({be.name}, payload {be.compute_dtype}, {info.adj_channel_num} "
        f"channels, label batch {cfg['label_batch_size']}, {steps} steps): graph "
        f"batch host build ms {build * 1e3:.2f} (of which stream structures "
        f"{kb.stream_seconds * 1e3:.2f}); host ms per step {np.mean(host) * 1e3:.4f}, "
        f"step wall ms to sync {np.mean(step) * 1e3:.4f} (median "
        f"{np.median(step) * 1e3:.4f}); profiled: wall ms/step {wall / steps * 1e3:.4f}, "
        f"device busy ms/step {busy / steps * 1e3:.4f}, idle share {1 - busy / wall:.4f}")


def phase_kg(workdir):
    phase(8, "kg: cli.kg, cli.main train and infer on a WN18RR-shaped knowledge graph")
    kg_files(workdir)
    launches = {k: 0 for k in _counted()}
    for name, over in (("kg_bf16", {}),
                       ("kg_f32", {"tiled_compute_dtype": "float32", "epoch": 1})):
        counts, _, _ = kg_run(workdir, name, **over)
        for k, v in counts.items():
            launches[k] += v
    kg_gpu_vs_cpu(workdir)
    kg_step_breakdown(workdir)
    return launches


# ---------------------------------------------------------------------------
# phase 9: the ELL kernel


def ring6_file(workdir):
    """The ring dataset of 6-node graphs (``RING6``) as a pickle ``.jbl``,
    written on the first call."""
    path = os.path.join(workdir, "ring6.jbl")
    if not os.path.exists(path):
        from kgcn_tpu_torch.data.synthetic import make_ring_dataset

        with open(path, "wb") as f:
            pickle.dump(make_ring_dataset(**RING6), f, protocol=4)
    return path


def _ring6_batch(workdir, bs, first=0):
    """The ring6 batch of ``bs`` graphs from graph ``first`` on the pallas
    backend (host tensors; the Batcher's ELL arrays and their transpose)."""
    import numpy as np

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = _load_config(GIN_CONFIG, dataset=ring6_file(workdir))
    ds, info = load_jbl(cfg["dataset"], cfg)
    batch = Batcher(ds, info, bs, backend=Backend("pallas")).make_batch(
        np.arange(first, first + bs))
    if batch.graph.ell_senders is None:
        raise AssertionError("the ELL gate refused the ring6 dataset")
    return batch



def ell_cases(workdir):
    """(label, idx [V, K] int32, w [V, K] f32 on the CPU, widths, on the
    main path, the transpose (offsets [1, V + 1], slots): the batch's own
    for the ring6 batches, ``ell_transpose``'s for the others)."""
    import numpy as np
    import torch

    from kgcn_tpu_torch.ops.ell import ell_transpose

    rng = np.random.RandomState(0)

    def uniform(V, K):
        return (torch.from_numpy(rng.randint(0, V, (V, K)).astype(np.int32)),
                torch.from_numpy((rng.random_sample((V, K)) + 0.1).astype(np.float32)))

    def ring6(bs):  # one channel: the batch's arrays and transpose
        g = _ring6_batch(workdir, bs).graph
        return g.ell_senders[0], g.ell_weights[0]

    cases = [("ring6 batch (25 graphs)", *ring6(25), (3, 50), True),
             ("ring6 1024 graphs", *ring6(1024), (50,), False),
             ("uniform degree 8", *uniform(16384, 8), (128,), False),
             ("V=100000 K=10", *uniform(100_000, 10), (128,), False)]
    V, K = 16384, 16
    idx, w = uniform(V, K)
    deg = np.minimum(rng.poisson(4.0, V) + 1, K)  # mean degree ~5 of K 16
    pad = torch.from_numpy(np.arange(K)[None, :] >= deg[:, None])
    idx[pad], w[pad] = 0, 0.0
    cases.append(("skewed K=16 mean degree 5", idx, w, (128,), False))
    cases.append(("K=1", *uniform(1504, 1), (81,), False))
    out = []
    for c in cases:
        if c[0].startswith("ring6"):
            t = _ring6_batch(workdir, c[1].shape[0] // 6).graph.ell_transpose()
        else:
            t = tuple(torch.from_numpy(a) for a in ell_transpose(
                c[1].numpy(), c[2].numpy(), c[1].shape[0]))
        out.append((*c, t))
    return out


def _ell_csr(idx, w, n_cols, transpose=False):
    """The ELL matrix (row v, column idx[v, k], value w[v, k]; padding
    slots left out), or its transpose, as CSR."""
    import torch

    V, K = idx.shape
    rows = torch.arange(V, device=idx.device).repeat_interleave(K)
    keep = w.reshape(-1) != 0
    ij = torch.stack([rows[keep], idx.reshape(-1).long()[keep]])
    shape = (V, n_cols)
    if transpose:
        ij, shape = ij.flip(0), shape[::-1]
    coo = torch.sparse_coo_tensor(ij, w.reshape(-1)[keep], shape)
    return coo.coalesce().to_sparse_csr()


def ell_bound(idx, w, F, elem=4):
    """(bound_ms, bound_by) of the forward: idx and w read once (8 B a
    slot), x read once and the output written once (V·F each), 2·F FLOP
    per real slot."""
    V, K = idx.shape[-2:]
    C = idx.numel() // (V * K)
    nnz = int((w != 0).sum())
    return bound(C * V * K * 8 + (C + 1) * V * F * elem, 2 * nnz * F)


def ell_dx_bound(n_slots, V, N, F, C=1, elem=4):
    """(bound_ms, bound_by) of dx: each real slot's id and weight read once
    (8 B), the offsets once, g [V, F] read once, dx ([N, F] per channel
    group) written once, 2·F FLOP per real slot."""
    return bound(8 * n_slots + 4 * C * (N + 1) + (V + C * N) * F * elem, 2 * n_slots * F)


def phase_ell_check(workdir):
    import torch

    from kgcn_tpu_torch.ops import ell_spmm as te

    phase(9, "kernel check: ELL gather and its dx (kgcn_tpu_torch/ops/csrc/ell.cu)")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    cases = ell_cases(workdir)
    for label, idx_c, w_c, widths, on_path, (off_c, slots_c) in cases:
        idx, w = idx_c.to(DEVICE), w_c.to(DEVICE)
        off, slots = off_c.to(DEVICE), slots_c.to(DEVICE)
        V, K = idx.shape
        real = int((w_c != 0).sum())
        say(f"ell {label}: V {V}, K {K}, {real} real slots of {V * K}; transpose: "
            f"largest out-degree {int((off_c[0, 1:] - off_c[0, :-1]).max())}")
        mat, mat_t = _ell_csr(idx, w, V), _ell_csr(idx, w, V, transpose=True)
        for F in widths:
            x = torch.randn((V, F), device=DEVICE, generator=gen)
            g = torch.randn((V, F), device=DEVICE, generator=gen)
            errs, dx_equal = {}, None
            for dt in ("float32", "bfloat16"):
                xd, gd = x.to(getattr(torch, dt)), g.to(getattr(torch, dt))
                errs[dt] = _check(
                    f"ell_spmm {label} F={F} {dt}", te._launch(idx, w, xd),
                    te.spmm_ell_reference(idx_c, w_c, xd.cpu()), ELL_TOL[dt])
                got = te._dx_launch(off, slots, w, gd, (V, F))
                want = te.spmm_ell_dx_reference(idx_c, w_c, gd.cpu(), (V, F))
                errs[f"dx {dt}"] = _check(f"ell dx {label} F={F} {dt}", got, want,
                                                ELL_TOL[dt])
                if dt == "float32":  # the CPU's index_add_ adds in the kernel's order
                    dx_equal = torch.equal(got.cpu(), want)
            if not torch.equal(te._dx_launch(off, slots, w, g, (V, F)),
                               te._dx_launch(off, slots, w, g, (V, F))):
                raise AssertionError(f"ell dx {label} F={F}: two launches differ")
            lib_err = float((torch.sparse.mm(mat, x) - te.spmm_ell_reference(idx, w, x))
                            .abs().max())
            iters = 10 if V * K > 500_000 else 50
            xb = x.to(torch.bfloat16)
            t = dict(
                kernel=device_ms(lambda: te._launch(idx, w, x), iters),
                kernel_bf16=device_ms(lambda: te._launch(idx, w, xb), iters),
                plain=device_ms(lambda: te.spmm_ell_reference(idx, w, x), iters),
                library=library_ms(lambda: torch.sparse.mm(mat, x), iters),
                dx=device_ms(lambda: te._dx_launch(off, slots, w, g, (V, F)), iters),
                dx_plain=device_ms(lambda: te.spmm_ell_dx_reference(idx, w, g, (V, F)),
                                   iters),
                dx_library=library_ms(lambda: torch.sparse.mm(mat_t, g), iters),
            )
            b, by = ell_bound(idx_c, w_c, F)
            db, dby = ell_dx_bound(real, V, V, F)
            rows.append(dict(label=label, F=F, on_path=on_path, err=errs["float32"],
                             err_bf16=errs["bfloat16"], dx_err=errs["dx float32"],
                             dx_on_path=on_path and F > 3, bound=b, bound_by=by,
                             dx_bound=db, dx_bound_by=dby, **t))
            say(f"  F={F}: max |kernel - plain| "
                + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f" (library vs plain f32 {lib_err:.3g}); dx f32 bitwise equal to the "
                f"CPU's index_add_: {dx_equal}; two dx launches bitwise equal; device ms: "
                f"kernel f32 {t['kernel']:.6f} (bf16 {t['kernel_bf16']:.6f}) plain "
                f"{t['plain']:.6f} library {t['library']}; bound {b:.6f} ({by}); dx "
                f"kernel {t['dx']:.6f} plain {t['dx_plain']:.6f} library "
                f"{t['dx_library']}; bound {db:.6f} ({dby})")
    rows += _check_ell_channels(workdir, gen)
    _check_ell_gradients(cases)
    return rows


def _check_ell_channels(workdir, gen, F=50):
    """C = 3 (the channels: three ring6 batches' ELL arrays): the fused
    forward against the per-channel plain sum (and, f32, bitwise against
    three one-channel launches added in channel order), dx against the
    plain index_add_ dx, shared and per-channel x; the card's transpose
    (``ell_transpose_device``) against the host's."""
    import torch

    from kgcn_tpu_torch.ops import ell_spmm as te
    from kgcn_tpu_torch.ops.ell import ell_transpose

    graphs = [_ring6_batch(workdir, 25, first=25 * c).graph for c in range(3)]
    idx_c = torch.stack([g.ell_senders[0] for g in graphs])
    w_c = torch.stack([g.ell_weights[0] for g in graphs])
    C, V, K = idx_c.shape
    off_c, slots_c = (torch.from_numpy(a) for a in ell_transpose(idx_c.numpy(),
                                                                  w_c.numpy(), V))
    idx, w, off, slots = (t.to(DEVICE) for t in (idx_c, w_c, off_c, slots_c))
    d_off, d_slots = (t.cpu() for t in te.ell_transpose_device(idx, w, V))
    for c in range(C):
        if not (torch.equal(d_off[c].diff(), off_c[c].diff()) and torch.equal(
                d_slots[d_off[c, 0]:d_off[c, -1]], slots_c[off_c[c, 0]:off_c[c, -1]])):
            raise AssertionError(f"ell_transpose_device channel {c} differs from the host's")
    real = int(slots_c.numel())
    rows = []
    for shared in (True, False):
        x_shape = (V, F) if shared else (C, V, F)
        x = torch.randn(x_shape, device=DEVICE, generator=gen)
        g = torch.randn((V, F), device=DEVICE, generator=gen)
        xs = (x,) * C if shared else x.unbind(0)
        errs = {}
        for dt in ("float32", "bfloat16"):
            xd, gd = x.to(getattr(torch, dt)), g.to(getattr(torch, dt))
            got = te._launch(idx, w, xd)
            errs[dt] = _check(f"ell_spmm C=3 shared={shared} {dt}", got,
                                    te.spmm_ell_reference(idx_c, w_c, xd.cpu()), ELL_TOL[dt])
            if dt == "float32":
                per = [te._launch(idx[c], w[c], xs[c].contiguous()) for c in range(C)]
                if not torch.equal(got, per[0] + per[1] + per[2]):
                    raise AssertionError("ell_spmm C=3: the fused launch differs from "
                                         "three one-channel launches added in order")
            errs[f"dx {dt}"] = _check(
                f"ell dx C=3 shared={shared} {dt}", te._dx_launch(off, slots, w, gd, x_shape),
                te.spmm_ell_dx_reference(idx_c, w_c, gd.cpu(), x_shape), ELL_TOL[dt])
        t = dict(
            kernel=device_ms(lambda: te._launch(idx, w, x), 50),
            per_channel=device_ms(lambda: [te._launch(idx[c], w[c], xs[c])
                                           for c in range(C)], 50),
            plain=device_ms(lambda: te.spmm_ell_reference(idx, w, x), 50),
            dx=device_ms(lambda: te._dx_launch(off, slots, w, g, x_shape), 50),
            dx_plain=device_ms(lambda: te.spmm_ell_dx_reference(idx, w, g, x_shape), 50),
        )
        b, by = ell_bound(idx_c, w_c, F)
        db, dby = ell_dx_bound(real, V, V, F, C=1 if shared else C)
        label = f"C=3 ring6 batches, {'shared' if shared else 'per-channel'} x"
        rows.append(dict(label=label, F=F, on_path=False, err=errs["float32"],
                         err_bf16=errs["bfloat16"], dx_err=errs["dx float32"],
                         dx_on_path=False, bound=b, bound_by=by, dx_bound=db,
                         dx_bound_by=dby, library=None, dx_library=None, **t))
        say(f"ell {label} (V {V}, K {K}, F {F}): max |kernel - plain| "
            + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; f32 fused launch bitwise equal to three one-channel launches; "
            f"device ms: fused {t['kernel']:.6f} (one launch a channel "
            f"{t['per_channel']:.6f}) plain {t['plain']:.6f}; bound {b:.6f} ({by}); dx "
            f"{t['dx']:.6f} plain {t['dx_plain']:.6f}; bound {db:.6f} ({dby})")
    say("ell_transpose_device (the COO entry's) equals the host lists on the C=3 case")
    return rows


def _check_ell_gradients(cases):
    """``SpmmEll`` (the autograd Function: dx by the dx kernel over slot
    lists built on the card, dw asked for) on the card against the same
    call on the CPU."""
    import torch

    from kgcn_tpu_torch.ops import ell_spmm as te

    for label, idx_c, w_c, widths, _, _ in cases:
        if not label.startswith(("ring6 batch", "skewed")):
            continue
        F = widths[-1]
        gen = torch.Generator().manual_seed(1)
        x0 = torch.randn((idx_c.shape[0], F), generator=gen)
        cot = torch.randn((idx_c.shape[0], F), generator=gen)
        res = []
        for dev in (DEVICE, "cpu"):
            w = w_c.to(dev).clone().requires_grad_(True)
            x = x0.to(dev).clone().requires_grad_(True)
            out = te.SpmmEll.apply(idx_c.to(dev), w, x)
            (out * cot.to(dev)).sum().backward()
            res.append([t.detach().cpu() for t in (out, x.grad, w.grad)])
        for name, a, b in zip(("value", "dx", "dw"), *res):
            err = float((a - b).abs().max())
            if not torch.allclose(a, b, rtol=TOL, atol=TOL):
                raise AssertionError(f"SpmmEll {label} {name}: GPU vs CPU {err}")
            say(f"SpmmEll {label} F={F}: {name} GPU vs CPU max |diff| {err:.3g}")


# ---------------------------------------------------------------------------
# phase 10: GIN and GCN on the ELL path through the CLI


def ell_infer(workdir, name, n_graphs, per_forward):
    """``cli.main infer`` on a train run's config: result keys, files,
    predictions and the ELL launch count (``per_forward`` per batch)."""
    import numpy as np

    path = os.path.join(workdir, name, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    out, result, counts, wall = _cli(["infer", "--config", path])
    protocol = result["test_metrics_protocol"]
    if not (np.isfinite(result["test_cost"]) and protocol["test_count"] == n_graphs
            and 0.0 <= protocol["test_accuracy"] <= 1.0):
        raise AssertionError(f"infer {name}: {result}")
    with open(cfg["prediction_data"], "rb") as f:
        pred = pickle.load(f)
    if pred.shape != (n_graphs, 2) or not np.allclose(pred.sum(axis=1), 1.0, atol=1e-5):
        raise AssertionError(f"infer {name}: predictions {pred.shape}")
    for f in (cfg["save_info_test"], cfg["save_result_test"]):
        if not os.path.exists(f):
            raise AssertionError(f"infer {name}: no {f}")
    if "[LOAD]" not in out:
        raise AssertionError(f"infer {name}: no [LOAD] line")
    say(f"-- infer {name}: {wall:.2f} s, test cost {result['test_cost']:.6g}, accuracy "
        f"{protocol['test_accuracy']:.4g} over {n_graphs} graphs")
    bs = int(cfg["batch_size"])
    _expect(f"infer {name}", counts, {"ell_spmm": per_forward * -(-n_graphs // bs)})
    return counts


def phase_ell(workdir):
    from kgcn_tpu_torch.ops import spmm as tspmm

    phase(10, "ell: cli.main train and infer for gin and gcn on the pallas backend")
    tspmm._PALLAS_FALLBACK_WARNED[0] = False  # a fallback here must show
    data = ring6_file(workdir)
    n_graphs = 2 * RING6["num_pairs"]
    launches = {k: 0 for k in _counted()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # the streaming loop (device_resident false); phase 11 runs the default,
    # the resident runners
    outputs = dict(dataset=data, spmm_backend="pallas", make_plot=False,
                   device_resident=False)
    # one forward launch per ell_aggregate, whatever C; one dx launch per
    # aggregation whose input needs a gradient (GIN's first aggregates the
    # features, which need none; GCN's aggregate X W_c + b_c)
    for name, src, epochs, per_forward, dx_per_step in (
            ("gin_pallas", GIN_CONFIG, 2, 2, 1), ("gcn_pallas", GCN_RING_CONFIG, 1, 3, 3)):
        d = os.path.join(workdir, name)
        _, counts, steps, evals, out = train_run(
            workdir, name, src, epochs, falling=epochs > 1,
            save_info_test=os.path.join(d, "info_test.json"),
            save_result_test=os.path.join(d, "result_test.csv"),
            prediction_data=os.path.join(d, "prediction.jbl"), **outputs)
        if "[spmm] backend: pallas" not in out or "pallas backend requested" in out:
            raise AssertionError(f"train {name}: did not take the ELL route")
        _expect(f"train {name}", counts, {"ell_spmm": per_forward * (steps + evals),
                                           "ell_spmm_dx": dx_per_step * steps})
        add(counts)
        add(ell_infer(workdir, name, n_graphs, per_forward))
    steps_gpu_vs_cpu("GIN (pallas, ring6)", _load_config(
        GIN_CONFIG, dataset=ring6_file(workdir), spmm_backend="pallas"), 3,
        lambda info: {"ell_spmm": 2 * 3, "ell_spmm_dx": 3})
    gin_trajectory_probe(workdir)
    step_breakdown((("gin_pallas", GIN_CONFIG, dict(dataset=data, spmm_backend="pallas")),))

    # synthetic.jbl: the gate refuses ELL, so the data (not a fault of the
    # kernel) sends pallas to the edge-list scatter, with the JAX message
    for backend in ("pallas", "xla"):
        tspmm._PALLAS_FALLBACK_WARNED[0] = False
        _, counts, _, _, out = train_run(workdir, f"gin_synthetic_{backend}", GIN_CONFIG,
                                         1, falling=False, spmm_backend=backend,
                                         device_resident=False)
        said = out.count("[spmm] pallas backend requested")
        if said != (backend == "pallas"):
            raise AssertionError(f"gin on synthetic.jbl ({backend}): the fallback "
                                 f"message printed {said} times")
        _expect(f"train gin_synthetic_{backend}", counts, {})
        say(f"-- gin on synthetic.jbl ({backend}): the ELL gate refused the dataset; "
            f"0 ELL launches, fallback message printed {said} time(s)")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the whole-epoch runners

# (name, config, overrides): the resident paths, training split at full width
RUNNER_CASES = (("gcn dense", CONFIG, {}), ("gat dense", GAT_CONFIG, {}),
                ("gin pallas (ring6)", GIN_CONFIG, {"spmm_backend": "pallas"}))
# the kernels of kgcn_tpu_torch/ops/csrc by their names in torch.profiler's
# records, demangled ("(anonymous namespace)::ell_kernel<float, float, 4, 1,
# true, true>(...)") or mangled ("_ZN12_GLOBAL__N_110ell_kernelIffLi4ELi1ELb1ELb1E
# ..."), and the wrapper counts that count them (the stream scatter kernel
# runs both stream routes; _profiler_launches gives it to the route that
# ran; a bf16 gconv kernel counts as gconv and as gconv_bf16, as the
# wrappers count it)
_START = r"(?:^|void |\d|namespace\)::)"
KERNEL_COUNTERS = (
    (_START + r"(?:tc::)?(?:gconv_tc_\w+|sum_splits[^(]*__nv_bfloat16)",
     ("gconv", "gconv_bf16")),
    (_START + r"(?:gemm_kernel|small_graph_kernel|sum_splits)", "gconv"),
    (_START + r"ell_kernel(?:<[^,]*,[^,]*,[^,]*,[^,]*, *false|I\w*?Li\d+ELi\d+ELb0E)",
     "ell_spmm"),
    (_START + r"ell_kernel(?:<[^,]*,[^,]*,[^,]*,[^,]*, *true|I\w*?Li\d+ELi\d+ELb1E)",
     "ell_spmm_dx"),
    (_START + r"stream_scatter_kernel", "stream_scatter"),
    (_START + r"stream_dw_kernel", "stream_dw"),
    (_START + r"tiled_spmm_kernel", "tiled_spmm"),
    (_START + r"tiled_sddmm_kernel", "tiled_sddmm"),
)


def profiled(fn, cpu=True):
    """Run ``fn`` under torch.profiler: (its result, the launches of the
    port's kernels by wrapper count name, the CUDA graph launches, device
    busy seconds, wall seconds).  ``cpu``: record the CUDA runtime calls
    too (the graph launches)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {k: 0 for k in _counted()}
    events, graphs = cuda_events(prof)
    busy = 0.0
    for key, (count, us) in events.items():
        busy += us
        for pattern, counter in KERNEL_COUNTERS:
            if re.search(pattern, key):
                for name in (counter if isinstance(counter, tuple) else (counter,)):
                    kernels[name] += count
                break
    return out, kernels, graphs, busy / 1e6, wall


def _profiler_launches(kernels, python_counts):
    """The profiler's counts with the stream scatter kernel's launches given
    to the route whose wrapper counted (the one-hot or the iota route)."""
    kernels = dict(kernels)
    if python_counts.get("stream_scatter_mat", 0):
        if python_counts.get("stream_scatter", 0):
            raise AssertionError("both stream routes ran in one run")
        kernels["stream_scatter_mat"] = kernels.pop("stream_scatter")
        kernels["stream_scatter"] = 0
    return kernels


# runs of a path whose kernel counts torch.profiler must record exactly
PROFILER_ATTEMPTS = 3


def _short(got, want, graphs, want_graphs):
    """Whether torch.profiler's records of a run fall short of the launches
    it should hold and exceed them nowhere.  On the H100 it loses records
    now and then (22 of the 7568 kernel launches of phase 11's captured KG
    epochs in one run of a dozen, every other count and the bits right):
    such a run is taken again, up to PROFILER_ATTEMPTS runs, and only an
    exact count passes."""
    return ((got, graphs) != (want, want_graphs) and graphs <= want_graphs
            and all(got[k] <= want.get(k, 0) for k in got))


def _per_step(counts, steps, what):
    """{kernel: launches a step} from counts over ``steps`` steps."""
    per = {}
    for k, v in counts.items():
        if v % max(steps, 1):
            raise AssertionError(f"{what}: {k} launched {v} times in {steps} steps")
        per[k] = v // max(steps, 1)
    return per


def _resident_setup(cfg, device):
    """(info, resident batcher of the training split on ``device``, the
    streaming Batcher of the same split, its backend) of a config."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl, split_dataset
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.resident import ResidentBatcher

    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    train, _, _, _ = split_dataset(ds, cfg["validation_data_rate"], seed=int(cfg["seed"]),
                                   shuffle=bool(cfg["shuffle_data"]))
    bs = int(cfg["batch_size"])
    return (info, ResidentBatcher(train, info, bs, seed=0, backend=be, device=device),
            Batcher(train, info, bs, seed=0, backend=be), be)


def _trainer(cfg, info, device=None, capture=True, build=None):
    """A Trainer of the config's registry model, or of ``build(info, cfg)``."""
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    model = build(info, cfg) if build else build_model(cfg["model.py"], info, cfg)
    return Trainer(model, cfg, info, device=device or DEVICE, capture=capture)


def captured_vs_eager(label, cfg, info, make_batcher, epochs=2, build=None):
    """``epochs`` epochs of the whole-epoch runner from seed 0, eager
    (``capture=False``) and captured, each on a batcher from
    ``make_batcher()``: per-step costs and every parameter bitwise equal;
    the captured epochs under ``torch.cuda.set_sync_debug_mode("error")``
    (capture and replays: a host sync raises); the kernels the profiler
    records in the captured epochs equal the eager runner's per-step
    launches (the wrappers' counts) over the replayed steps and the
    warm-up steps; one CUDA graph launch a step (a captured run whose
    records fall short, ``_short``, is taken again from seed 0).  Returns
    (captured per-epoch mean costs, launches a step, steps an epoch)."""
    import torch

    from kgcn_tpu_torch.runtime.runner import WARMUP_STEPS

    def run(capture):
        batcher = make_batcher()
        trainer = _trainer(cfg, info, capture=capture, build=build)
        holder = [trainer.init_state(seed=0)]
        _zero_counts()

        def epochs_():
            costs = []
            for ep in range(epochs):
                if capture:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    holder[0], c, _ = trainer.epoch_on_device(holder[0], batcher, epoch=ep)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                costs.append(c)
            return costs

        # the eager runner's launches are its wrappers' counts; the captured
        # runner's, the profiler's
        costs, kernels, graphs = (profiled(epochs_)[:3] if capture
                                  else (epochs_(), None, None))
        return costs, holder[0].params, _counts(), kernels, graphs, batcher.valid_per_epoch

    t0 = time.time()
    ce, pe, eager_counts, _, _, n_valid = run(False)
    for attempt in range(PROFILER_ATTEMPTS):
        cc, pc, capture_counts, kernels, graphs, _ = run(True)
        S = len(cc[0])
        differ = [k for k in pe if not torch.equal(pe[k], pc[k])]
        if differ or not all(torch.equal(a, b) for a, b in zip(ce, cc)):
            raise AssertionError(f"{label}: captured and eager runners differ: costs "
                                 f"{[c.tolist() for c in cc]} vs {[c.tolist() for c in ce]}, "
                                 f"parameters {differ}")
        per = _per_step(eager_counts, epochs * S, f"{label} eager")
        got = _profiler_launches(kernels, capture_counts)
        want = {k: v * (epochs * S + WARMUP_STEPS) for k, v in per.items()}
        if not _short(got, want, graphs, epochs * S) or attempt == PROFILER_ATTEMPTS - 1:
            break
        say(f"  torch.profiler recorded {got} and {graphs} graph launches of {want} and "
            f"{epochs * S}; the captured run is taken again")
    at_capture = {k: v * (WARMUP_STEPS + 1) for k, v in per.items()}
    if got != want or capture_counts != at_capture or graphs != epochs * S:
        raise AssertionError(
            f"{label}: the profiler recorded {got} kernel launches and {graphs} graph "
            f"launches, want {want} and {epochs * S}; the wrappers counted "
            f"{capture_counts} at warm-up and capture, want {at_capture}")
    means = [float(c.sum()) / n_valid for c in cc]
    say(f"{label}: captured runner bitwise equal to the eager runner over {epochs} "
        f"epochs of {S} steps (per-epoch costs {means}, {len(pc)} parameters); no host "
        f"sync in capture and replays; profiler: {graphs} graph launches, kernel "
        f"launches {dict((k, v) for k, v in got.items() if v)} = per step "
        f"{dict((k, v) for k, v in per.items() if v)} x ({epochs * S} steps + "
        f"{WARMUP_STEPS} warm-up); {time.time() - t0:.1f} s")
    return means, per, S


def dropout_replays(cfg, info, make_batcher):
    """With dropout, two captured epochs from the same parameters and
    schedule draw different masks (costs differ: a mask frozen into the
    graph would repeat them), and the captured epoch equals the eager one
    drawn from the same generator (printed, bitwise or by how much)."""
    import dataclasses

    import torch

    batcher = make_batcher()
    cap = _trainer(cfg, info)
    s0 = cap.init_state(seed=0)
    _, c1, _ = cap.epoch_on_device(s0, batcher, epoch=0)
    _, c2, _ = cap.epoch_on_device(dataclasses.replace(s0), batcher, epoch=0)
    same = int((c1 == c2).sum())
    if same:
        raise AssertionError(f"dropout: {same} of {len(c1)} steps repeat their cost "
                             "in a second captured epoch (a mask frozen in the graph)")
    eager = _trainer(cfg, info, capture=False)
    _, ce, _ = eager.epoch_on_device(eager.init_state(seed=0), make_batcher(), epoch=0)
    gap = float((ce - c1).abs().max())
    say(f"dropout {cfg['dropout_rate']}: two captured epochs from one state differ at "
        f"every step ({len(c1)} steps, fresh masks each replay); captured vs eager "
        f"epoch from one seed: {'bitwise equal' if gap == 0 else f'max |diff| {gap}'}")


def runner_gpu_vs_cpu(label, cfg, gpu_means, make_cpu):
    """The runner's per-epoch mean costs on the CPU (eager) against the
    card's (captured), within TRAJECTORY_RTOL; ``gpu_means``: the epochs
    to compare (phase 11 gives the first)."""
    info, batcher = make_cpu()
    trainer = _trainer(cfg, info, device="cpu")
    state = trainer.init_state(seed=0)
    cpu = []
    for ep in range(len(gpu_means)):
        state, cost, _, _ = trainer.run_epoch(state, batcher, epoch=ep)
        cpu.append(cost)
    rel = [abs(a - b) / abs(b) for a, b in zip(gpu_means, cpu)]
    say(f"GPU (captured) vs CPU {label} runner costs: GPU {gpu_means} CPU {cpu} "
        f"relative difference {rel} (limit {TRAJECTORY_RTOL})")
    if max(rel) > TRAJECTORY_RTOL:
        raise AssertionError(f"GPU and CPU {label} runner costs differ by {max(rel)}")


def epoch_numbers(run, steps):
    """(wall ms a step unprofiled, wall ms and device busy ms a step
    profiled, idle share) of ``run()``, one epoch of ``steps`` steps, after
    a warm-up epoch."""
    import torch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, _, _, busy, pwall = profiled(run, cpu=False)
    return (wall / steps * 1e3, pwall / steps * 1e3, busy / steps * 1e3,
            1 - busy / pwall)


def runner_timing(label, cfg, info, rb, sb):
    """One epoch's step wall, device busy and idle share, old and new in one
    process: the streaming loop (host assembly, prefetched; one move to the
    card a step), the resident runner eager and captured."""
    S = rb.num_batches
    rows = []
    for name, batcher, capture in (("streaming loop", sb, False),
                                   ("resident eager", rb, False),
                                   ("resident captured", rb, True)):
        trainer = _trainer(cfg, info, capture=capture)
        holder = [trainer.init_state(seed=0)]

        def run():
            holder[0] = trainer.run_epoch(holder[0], batcher, epoch=0)[0]
        rows.append((name, *epoch_numbers(run, S)))
    for name, wall, pwall, busy, idle in rows:
        say(f"runner time {label} ({S} steps): {name}: step wall ms {wall:.4f} "
            f"(profiled {pwall:.4f}), device busy ms/step {busy:.4f}, idle share "
            f"{idle:.4f}")
    return rows


def resident_cli(workdir, name, src, epochs, per_step, per_eval, **over):
    """``cli.main train`` with ``device_resident`` at its default (``auto``)
    under torch.profiler, then ``infer``: the resident runners, each step
    replayed (one graph launch per training step and evaluated batch), the
    kernels the profiler records equal to ``per_step``/``per_eval`` over
    the replays and warm-ups.  A run whose records fall short (``_short``)
    is taken again, a training run in a directory of its own.  Returns the
    profiler's launches."""
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.runtime.runner import WARMUP_STEPS

    for attempt in range(PROFILER_ATTEMPTS):
        run = name if attempt == 0 else f"{name}_again_{attempt}"
        d = os.path.join(workdir, run)
        (_, counts, steps, evals, _), kernels, graphs, busy, wall = profiled(
            lambda: train_run(workdir, run, src, epochs, falling=epochs > 1,
                              save_info_test=os.path.join(d, "info_test.json"),
                              save_result_test=os.path.join(d, "result_test.csv"), **over))
        # one training runner and one evaluation runner, each warmed up once
        want = {k: per_step.get(k, 0) * (steps + WARMUP_STEPS)
                + per_eval.get(k, 0) * (evals + WARMUP_STEPS) for k in counts}
        kernels = _profiler_launches(kernels, counts)
        if (not _short(kernels, want, graphs, steps + evals)
                or attempt == PROFILER_ATTEMPTS - 1):
            break
        say(f"  torch.profiler recorded {kernels} of {want}; the run is taken again")
    if kernels != want or graphs != steps + evals:
        raise AssertionError(f"train {name}: profiler launches {kernels}, {graphs} graph "
                             f"launches; want {want}, {steps + evals}")
    say(f"-- train {name} (resident, captured): {graphs} graph launches = {steps} "
        f"steps + {evals} evaluated batches; kernel launches "
        f"{dict((k, v) for k, v in kernels.items() if v)} as predicted; device busy "
        f"{busy:.3f} s of {wall:.3f} s")
    launches = dict(kernels)
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    n = -(-load_jbl(cfg["dataset"], cfg)[0].num // int(cfg["batch_size"]))  # infer's batches
    want = {k: per_eval.get(k, 0) * (n + WARMUP_STEPS) for k in _counted()}
    for attempt in range(PROFILER_ATTEMPTS):
        (_, result, counts, _), kernels, graphs, _, _ = profiled(
            lambda: _cli(["infer", "--config", os.path.join(d, "config.json")]))
        kernels = _profiler_launches(kernels, counts)
        if not _short(kernels, want, graphs, n) or attempt == PROFILER_ATTEMPTS - 1:
            break
        say(f"  torch.profiler recorded {kernels} of {want}; infer is taken again")
    if kernels != want or graphs != n or not math.isfinite(result["test_cost"]):
        raise AssertionError(f"infer {name}: {result}, launches {kernels}, {graphs} "
                             f"graph launches; want {want}, {n}")
    say(f"-- infer {name} (resident, captured): {graphs} graph launches, test cost "
        f"{result['test_cost']:.6g}")
    for k, v in kernels.items():
        launches[k] += v
    return launches


def kg_runner(workdir):
    """The scanned KG epoch (bf16, the main path's KG): captured against
    eager over 2 epochs; GPU vs CPU with the f32 payload over one epoch of
    3 label slices (phase 8's 3 steps; Adam's normalisation turns the
    sums' last-bit differences on near-zero gradient components into
    larger ones in later steps; ``kg_trajectory_probe``, ROADMAP C.9's
    probe); old (the per-batch loop) and new step times."""
    cfg, _ = kg_config(workdir, "kg_runner")
    kb, info, _ = kg_batcher(cfg, device=DEVICE)
    captured_vs_eager("kg bf16 (scanned)", cfg, info,
                      lambda: kg_batcher(cfg, device=DEVICE)[0])
    # the scanned epoch (captured) against the per-batch loop of train_step
    # from one seed: the replayed step is the eager step, bit for bit
    import torch

    loop_tr, scan_tr = _trainer(cfg, info, capture=False), _trainer(cfg, info)
    st = loop_tr.init_state(seed=0)
    loop = []
    for batch in kg_batcher(cfg, device=DEVICE)[0].batches():
        st, c, _ = loop_tr.train_step(st, batch)
        loop.append(c)
    loop = torch.stack(loop)
    _, scan, _ = scan_tr.epoch_on_device(scan_tr.init_state(seed=0),
                                         kg_batcher(cfg, device=DEVICE)[0])
    rel = float(((scan - loop).abs() / loop.abs()).max())
    say(f"kg bf16: the scanned epoch (captured) against the per-batch loop, "
        f"{len(loop)} steps from seed 0: "
        f"{'bitwise equal' if torch.equal(scan, loop) else f'max relative diff {rel}'}"
        f" (epoch mean {float(scan.sum()) / len(scan)})")
    if not rel <= TRAJECTORY_RTOL:
        raise AssertionError(f"kg: the scanned epoch and the per-batch loop differ by {rel}")
    # GPU vs CPU, the f32 payload, epochs of the first 3 label slices
    kg_trajectory_probe(dict(cfg, tiled_compute_dtype="float32"))
    # old: the per-batch loop (slices and negatives on the host, one copy a
    # step); new: the scanned epoch, captured
    S = kb.valid_per_epoch
    rows = []
    for name, capture in (("per-batch loop", None), ("scanned eager", False),
                          ("scanned captured", True)):
        trainer = _trainer(cfg, info, capture=bool(capture))
        st = [trainer.init_state(seed=0)]

        def run():
            if capture is None:
                for batch in kb.batches():
                    st[0] = trainer.train_step(st[0], batch)[0]
            else:
                st[0] = trainer.run_epoch(st[0], kb)[0]
        rows.append((name, *epoch_numbers(run, S)))
    for name, wall, pwall, busy, idle in rows:
        say(f"runner time kg bf16 ({S} steps): {name}: step wall ms {wall:.4f} "
            f"(profiled {pwall:.4f}), device busy ms/step {busy:.4f}, idle share "
            f"{idle:.4f}")


def _kg_probe_run(cfg, dev):
    """(per-step costs, seconds) of one scanned f32 epoch of
    KG_PROBE_SLICES label slices from seed 0 on ``dev`` (captured on the
    card, eager on the CPU)."""
    import torch

    kb, inf, _ = kg_batcher(cfg, device=dev)
    kb.label_list = kb.label_list[:KG_PROBE_SLICES * int(cfg["label_batch_size"])]
    trainer = _trainer(cfg, inf, device=dev)
    state = trainer.init_state(seed=0)
    t0 = time.time()
    _, c, _ = trainer.epoch_on_device(state, kb, epoch=0)
    return c.detach().cpu().double(), time.time() - t0


def kg_trajectory_probe(cfg):
    """ROADMAP C.9, and phase 11's KG check GPU vs CPU: one f32 epoch of
    KG_PROBE_SLICES label slices of the KG (scanned; captured on the card,
    eager on the CPU) from seed 0.  Fails when the epoch's mean costs
    differ by more than TRAJECTORY_RTOL.  Prints the per-step relative
    cost gap GPU vs CPU."""
    t_probe = time.time()
    L = int(cfg["label_batch_size"])
    gc, gwall = _kg_probe_run(cfg, DEVICE)
    cc, cwall = _kg_probe_run(cfg, "cpu")
    S = KG_PROBE_SLICES
    means = [float(gc.mean()), float(cc.mean())]
    rel = abs(means[0] - means[1]) / abs(means[1])
    say(f"GPU (captured) vs CPU kg f32 (one epoch of {S} slices) runner costs: GPU "
        f"{means[0]} CPU {means[1]} relative difference {rel} (limit {TRAJECTORY_RTOL})")
    if rel > TRAJECTORY_RTOL:
        raise AssertionError(f"GPU and CPU kg f32 runner costs differ by {rel}")
    say(f"C.9 probe: kg f32, one epoch of {S} slices of {L} (GPU captured "
        f"{gwall:.1f} s, CPU eager {cwall:.1f} s); relative cost gap GPU vs CPU "
        + " ".join(f"{r:.2e}" for r in ((gc - cc).abs() / cc.abs()).tolist()))
    say(f"C.9 probe wall {time.time() - t_probe:.1f} s")


@contextlib.contextmanager
def recorded_steps():
    """Inside the block, every training step's summed cost of a Trainer is
    appended to the list it yields (the streaming loop's ``train_step`` and
    the whole-epoch runners' ``epoch_on_device``, cloned on the device and
    read at the end)."""
    import torch

    from kgcn_tpu_torch.runtime.train import Trainer

    rec = []
    real = (Trainer.train_step, Trainer.epoch_on_device)

    def train_step(self, state, batch):
        out = real[0](self, state, batch)
        rec.append(out[1].detach().reshape(1).clone())
        return out

    def epoch_on_device(self, state, batcher, shuffle=True, epoch=None):
        out = real[1](self, state, batcher, shuffle, epoch)
        rec.append(out[1].detach().reshape(-1).clone())
        return out

    Trainer.train_step, Trainer.epoch_on_device = train_step, epoch_on_device
    out = []
    try:
        yield out
    finally:
        Trainer.train_step, Trainer.epoch_on_device = real
        if rec:
            out.extend(torch.cat([r.cpu() for r in rec]).double().tolist())


GIN_PROBE_RTOL = 1e-6   # two step costs "part" beyond this relative gap


def _parting(a, b):
    """(first step whose relative cost gap exceeds GIN_PROBE_RTOL or None,
    the largest relative gap)."""
    rel = [abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)]
    first = next((i for i, r in enumerate(rel) if r > GIN_PROBE_RTOL), None)
    return first, max(rel) if rel else 0.0


def _sha(arrays):
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def gin_trajectory_probe(workdir, epochs=2):
    """ROADMAP C.11: GIN on ring6 (``pallas``, float32, TF32 off) from one
    seed through ``cli.main train`` on the card (the resident runner) and
    on the CPU.  Prints each run's per-step and per-epoch costs; the first
    step whose costs part by more than GIN_PROBE_RTOL, the median and
    largest relative step gap of each epoch, and the epochs' relative gap;
    and checksums of the initial parameters and the dataset (which tell two
    machines' draws apart).  Fails when the card's epochs differ from the
    CPU's by more than TRAJECTORY_RTOL.  Returns {run: (per-step costs,
    per-epoch costs)}."""
    import statistics as st

    import torch

    over = dict(dataset=ring6_file(workdir), spmm_backend="pallas", precision="float32",
                make_plot=False)
    cfg = _load_config(GIN_CONFIG, **over)
    info, _, sb, _ = _resident_setup(cfg, "cpu")
    init = _trainer(cfg, info, device="cpu").init_state(seed=int(cfg["seed"]))
    say(f"C.11 probe: torch {torch.__version__}, {torch.get_num_threads()} CPU threads; "
        f"initial parameters sha256 {_sha(init.params[k] for k in sorted(init.params))}; "
        f"training split features and labels sha256 "
        f"{_sha([sb.ds.features, sb.ds.labels])}")
    runs = {}
    for name, cpu in (("cli gpu", False), ("cli cpu", True)):
        with recorded_steps() as steps:
            costs = train_run(workdir, f"c11_{name.replace(' ', '_')}", GIN_CONFIG,
                              epochs, cpu=cpu, falling=False, **over)[0]
        say(f"C.11 probe {name}: TF32 {torch.backends.cuda.matmul.allow_tf32}; epochs "
            f"{costs}; {len(steps)} steps " + " ".join(f"{c:.9g}" for c in steps))
        runs[name] = (steps, costs)
    S = len(runs["cli cpu"][0]) // epochs
    (g_steps, gpu), (c_steps, cpu_) = runs["cli gpu"], runs["cli cpu"]
    first, worst = _parting(g_steps, c_steps)
    rel = [abs(x - y) / max(abs(y), 1e-30) for x, y in zip(g_steps, c_steps)]
    per_epoch = "; ".join(
        f"epoch {e + 1} median {st.median(rel[e * S:(e + 1) * S]):.3e} largest "
        f"{max(rel[e * S:(e + 1) * S]):.3e}" for e in range(epochs))
    say(f"C.11 probe cli gpu vs cli cpu: steps part (> {GIN_PROBE_RTOL}) first at step "
        f"{first} of {len(rel)}; relative step gaps {per_epoch}; largest {worst:.3e}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(gpu, cpu_))
    if rel > TRAJECTORY_RTOL:
        raise AssertionError(f"cli.main GIN (pallas, ring6) epochs GPU {gpu} vs CPU {cpu_}: "
                             f"relative gap {rel} > {TRAJECTORY_RTOL}")
    say(f"GPU vs CPU cli.main GIN (pallas, ring6) epochs: {gpu} vs {cpu_}, relative gap "
        f"{rel:.3e} (limit {TRAJECTORY_RTOL})")
    return runs


def phase_runners(workdir):
    phase(11, "runners: the resident and scanned whole-epoch runners, captured")
    t_phase = time.time()
    launches = {k: 0 for k in _counted()}
    ring6 = ring6_file(workdir)
    for name, src, over in RUNNER_CASES:
        over = dict(over, **({"dataset": ring6} if "ring6" in name else {}))
        cfg = _load_config(src, dropout_rate=0.0, **over)
        info, rb, sb, be = _resident_setup(cfg, DEVICE)
        means, per, S = captured_vs_eager(f"{name} (resident)", cfg, info,
                                          lambda: _resident_setup(cfg, DEVICE)[1])
        runner_gpu_vs_cpu(name, cfg, means[:1], lambda: _resident_setup(cfg, "cpu")[:2])
        if name == "gcn dense":
            dropout_replays(_load_config(src, **over), info,
                            lambda: _resident_setup(cfg, DEVICE)[1])
        runner_timing(name, cfg, info, rb, sb)
        per_eval = {"gconv": 3} if name == "gcn dense" else (
            {"ell_spmm": 2} if "pallas" in name else {})
        cli_name = name.split()[0] + "_resident"
        for k, v in resident_cli(workdir, cli_name, src, 2, per, per_eval,
                                 **over).items():
            launches[k] += v
        say(f"runners {name} done at {time.time() - t_phase:.1f} s of the phase")
    kg_runner(workdir)
    say(f"runners kg done at {time.time() - t_phase:.1f} s of the phase")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the shipped configs' models and subcommands

REG_CONFIG = os.path.join(ROOT, "example_config", "solubility_reg.json")
NODE_LABEL_CONFIG = os.path.join(ROOT, "example_config", "node_label.json")
CONFIG_EPOCHS = 2           # solubility_reg.json 100, node_label.json 10, synth.json 50
IG_MOLECULES = 4            # visualize_num of the run_synth.sh run
IG_TOL = dict(rtol=1e-3, atol=1e-6)  # sums of 100 gradients in another order
IG_PASSES = 5               # timed passes over the IG_MOLECULES molecules
EMBEDDING_RINGS = dict(num_pairs=200, num_nodes=10, seed=0)
EMBEDDING_VOCAB = 50


def _json(path):
    with open(path) as f:
        return json.load(f)


def configs_train_cv(workdir):
    """``train_cv`` of solubility_reg.json (gcn_regression, 3 folds) for
    CONFIG_EPOCHS epochs under torch.profiler: every fold's r2 and mse
    finite, the JAX run's keys in save_info_cv and save_result_cv, the fold
    sizes of ``kfold_indices``, each fold trained and validated through the
    captured resident runners (one graph launch a training step and
    evaluated batch), its test fold evaluated by the streaming loop; the
    gconv kernels the profiler records equal 2 a forward (two GraphConv)
    over the replays, warm-ups and test batches.  Returns the launches."""
    from kgcn_tpu_torch.data.dataset import kfold_indices, load_jbl
    from kgcn_tpu_torch.runtime.runner import WARMUP_STEPS

    d = os.path.join(workdir, "reg_cv")
    cfg, path = _write_config(workdir, "reg_cv", REG_CONFIG, epoch=CONFIG_EPOCHS,
                              save_info_cv=os.path.join(d, "info_cv.json"),
                              save_result_cv=os.path.join(d, "result_cv.json"))
    num = load_jbl(cfg["dataset"], cfg)[0].num
    k, bs = int(cfg["k-fold_num"]), int(cfg["batch_size"])
    folds = kfold_indices(num, k, seed=int(cfg.get("seed", 1234)))
    t0 = time.time()
    (out, summary, counts, _), kernels, graphs, busy, wall = profiled(
        lambda: _cli(["train_cv", "--config", path]))
    for f, (tr, te) in enumerate(folds):
        if f"[fold {f}] train={len(tr)} test={len(te)}" not in out:
            raise AssertionError(f"train_cv: no line for fold {f} of sizes "
                                 f"{len(tr)}/{len(te)}")
    for key in ("save_info_cv", "save_result_cv"):
        if set(_json(cfg[key])) != {"folds", "mean_mse", "std_mse"}:
            raise AssertionError(f"train_cv: {key} keys {sorted(_json(cfg[key]))}")
    for entry in summary["folds"]:
        tm = entry["test_metrics"]
        if set(entry) != {"fold", "test_cost", "test_mse", "test_metrics"} or not (
                set(tm) == {"r2", "mse", "gmfe"} and math.isfinite(tm["r2"])
                and math.isfinite(tm["mse"])):
            raise AssertionError(f"train_cv: fold entry {entry}")
    steps = sum(CONFIG_EPOCHS * -(-len(tr) // bs) for tr, _ in folds)
    evals = sum(CONFIG_EPOCHS * -(-len(te) // bs) for _, te in folds)
    tests = sum(-(-len(te) // bs) for _, te in folds)
    want = 2 * (steps + evals + tests + 2 * k * WARMUP_STEPS)
    if graphs != steps + evals or kernels["gconv"] != want or counts["gconv"] <= 0:
        raise AssertionError(f"train_cv: {graphs} graph launches, {kernels} kernels; want "
                             f"{steps + evals} and {want} gconv")
    say(f"-- train_cv solubility_reg.json: {k} folds x {CONFIG_EPOCHS} epochs, "
        f"{time.time() - t0:.2f} s ({wall / k:.3f} s a fold profiled), mse "
        f"{[round(e['test_metrics']['mse'], 5) for e in summary['folds']]}, r2 "
        f"{[round(e['test_metrics']['r2'], 5) for e in summary['folds']]}; fold sizes "
        f"{[len(te) for _, te in folds]}; {graphs} graph launches = {steps} steps + "
        f"{evals} evaluated batches; gconv {kernels['gconv']} as predicted; device busy "
        f"{busy:.3f} s of {wall:.3f} s")
    return {k_: v for k_, v in kernels.items()}


def configs_node_label(workdir):
    """node_label.json (gcn_node_label; no dropout) ``train`` then ``infer``
    for CONFIG_EPOCHS epochs through the captured resident runners (3 gconv
    kernels a forward over the replays and warm-ups, from the profiler),
    and the same training on the CPU: per-epoch costs within
    TRAJECTORY_RTOL; one epoch's step wall, busy and idle share (the
    streaming loop, the resident runner eager and captured, in turns).
    Returns the launches."""
    launches = resident_cli(workdir, "node_label", NODE_LABEL_CONFIG, CONFIG_EPOCHS,
                            {"gconv": 3}, {"gconv": 3})
    gpu = _json(os.path.join(workdir, "node_label", "info_train.json"))["training_cost"]
    cpu, _, _, _, _ = train_run(workdir, "node_label_cpu", NODE_LABEL_CONFIG,
                                CONFIG_EPOCHS, cpu=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(gpu, cpu)]
    say(f"GPU (captured) vs CPU node_label.json per-epoch costs: GPU {gpu} CPU {cpu} "
        f"relative difference {rel} (limit {TRAJECTORY_RTOL})")
    if max(rel) > TRAJECTORY_RTOL:
        raise AssertionError(f"node_label: GPU and CPU costs differ by {max(rel)}")
    cfg = _load_config(NODE_LABEL_CONFIG)
    info, rb, sb, _ = _resident_setup(cfg, DEVICE)
    runner_timing("node_label", cfg, info, rb, sb)
    return launches


def configs_synth(workdir):
    """synth.json as examples/run_synth.sh runs it: ``train``
    (CONFIG_EPOCHS epochs; ``make_plot`` as shipped where matplotlib is
    installed), ``infer``, then ``visualize`` of IG_MOLECULES molecules at
    ``ig_divide_number`` 100.  valid_metrics and test_metrics present, the
    cost and ROC plots written; each IG dump's completeness printed, its
    arrays held to the port's CPU IG of the same checkpoint (IG_TOL); the
    gconv launches a molecule counted (2 forwards of 3 GraphConv: the
    stacked copies, then F(1) and F(0)) and IG's ms a molecule.  Returns
    the launches."""
    import importlib.util

    import numpy as np
    import torch

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.explain import ig
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.train import Trainer
    from kgcn_tpu_torch.models.registry import build_model

    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        say("matplotlib is not installed here: make_plot would raise ImportError, as "
            "kgcn_tpu's does; the plot files are checked on the CPU "
            "(tests/test_torch_cv.py) only")
    d = os.path.join(workdir, "synth")
    extra = dict(plot_path=os.path.join(d, "result"),
                 visualize_path=os.path.join(d, "viz"), visualize_num=IG_MOLECULES,
                 ig_divide_number=100)
    if not plots:
        extra["make_plot"] = False
    # train and infer through the captured resident runners, launches from
    # the profiler
    launches = resident_cli(workdir, "synth", GCN_RING_CONFIG, CONFIG_EPOCHS,
                            {"gconv": 3}, {"gconv": 3}, **extra)
    path = os.path.join(d, "config.json")
    cfg = _json(path)
    if "valid_metrics" not in _json(cfg["save_info_valid"]):
        raise AssertionError("synth train: no valid_metrics")
    if "auc" not in _json(cfg["save_info_test"]).get("test_metrics", {}):
        raise AssertionError("synth infer: no test_metrics")
    if plots and sorted(os.listdir(cfg["plot_path"])) != ["auc.png", "cost.png"]:
        raise AssertionError(f"synth train: plots {os.listdir(cfg['plot_path'])}")
    _, paths, vcounts, vwall = _cli(["visualize", "--config", path])
    n = len(paths)
    if n != IG_MOLECULES or vcounts["gconv"] != n * 2 * 3:
        raise AssertionError(f"visualize: {n} dumps, gconv launches {vcounts['gconv']}; "
                             f"want {IG_MOLECULES} and {IG_MOLECULES * 6}")
    launches["gconv"] += vcounts["gconv"]
    cpu_cfg = dict(cfg, visualize_path=os.path.join(d, "viz_cpu"))
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_paths = ig.run_visualization(cpu_cfg, device="cpu")
    rels, errs = [], []
    for gp, cp in zip(paths, cpu_paths):
        with open(gp, "rb") as f:
            got = pickle.load(f)
        with open(cp, "rb") as f:
            want = pickle.load(f)
        rels.append(abs(got["sum_of_IG"] - got["check_score"]) / abs(got["check_score"]))
        for key in ("features_IG", "adjs_IG"):
            g, w = np.asarray(got[key]), np.asarray(want[key])
            errs.append(float(np.abs(g - w).max()))
            if g.shape != w.shape or not np.allclose(g, w, **IG_TOL):
                raise AssertionError(f"{os.path.basename(gp)} {key}: GPU vs CPU IG "
                                     f"max |diff| {errs[-1]}")
    # IG's time a molecule, eager on the card, after the visualize run's warm-up
    ds, info = load_jbl(cfg["dataset"], cfg)
    trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info, device=DEVICE)
    state = trainer.restore(os.path.join(cfg["save_model_path"], "model.best.ckpt"))
    variables = {**state.params, **state.batch_stats}
    b1 = Batcher(ds, info, 1, backend=backend.resolve(dict(cfg), info, log=False))
    batches = [b1.make_batch(np.asarray([i])).to(DEVICE) for i in range(IG_MOLECULES)]

    def run():
        for b in batches:
            ig.integrated_gradients(trainer.model, variables, b, steps=100)
    run()
    passes = []
    for _ in range(IG_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0) / IG_MOLECULES * 1e3)
    ms = statistics.median(passes)
    _, _, _, ig_busy, ig_wall = profiled(run, cpu=False)
    say(f"-- run_synth.sh steps: train {CONFIG_EPOCHS} epochs (valid_metrics "
        f"{sorted(_json(cfg['save_info_valid'])['valid_metrics'])}, plots "
        f"{'written' if plots else 'not drawn: no matplotlib'}), infer (test_metrics), "
        f"visualize {n} molecules at 100 steps ({vwall:.2f} s): |sum_of_IG - "
        f"check_score| / |check_score| {[f'{r:.3g}' for r in rels]}; GPU vs CPU IG max "
        f"|diff| {max(errs):.3g} (rtol {IG_TOL['rtol']}, atol {IG_TOL['atol']}); gconv "
        f"launches a molecule {vcounts['gconv'] // n}; IG ms a molecule: median "
        f"{ms:.4f} of {IG_PASSES} passes over the {n} molecules (min {min(passes):.4f}, "
        f"max {max(passes):.4f}; profiled wall {ig_wall / n * 1e3:.4f}, device busy "
        f"{ig_busy / n * 1e3:.4f}, idle share {1 - ig_busy / ig_wall:.4f})")
    for k, v in ig_backends(workdir, cfg, paths[0]).items():
        launches[k] += v
    return launches


def ig_backends(workdir, cfg, dense_dump):
    """``visualize`` of the first molecule with synth.json on the tiled and
    on the stream backend (f32 payload): IG's stacked copies through those
    kernels, their weight gradients giving the adjacency's IG (the tiled
    SDDMM, the stream dw; no gconv launch; the wrappers' counts exact),
    held to the dense run's dump (IG_TOL).  Returns the launches."""
    import numpy as np

    with open(dense_dump, "rb") as f:
        want = pickle.load(f)
    launches = {}
    for name, kernels in (("tiled", ("tiled_spmm", "tiled_sddmm")),
                          ("stream", ("stream_scatter", "stream_dw"))):
        bcfg = {k: v for k, v in cfg.items() if k != "_spmm_resolved"}
        bcfg.update(spmm_backend=name, tiled_compute_dtype="float32", visualize_num=1,
                    visualize_path=os.path.join(workdir, "synth", f"viz_{name}"))
        path = os.path.join(workdir, "synth", f"config_{name}.json")
        with open(path, "w") as f:
            json.dump(bcfg, f)
        out, paths, counts, wall = _cli(["visualize", "--config", path])
        # 3 GraphConv: the copies' forward and dx, the F(1)/F(0) forward,
        # and the copies' weight gradient
        if f"[spmm] backend: {name}" not in out or counts["gconv"] or [
                counts[k] for k in kernels] != [9, 3]:
            raise AssertionError(f"visualize on {name}: launches {counts}; want "
                                 f"9 and 3 of {kernels}, no gconv")
        with open(paths[0], "rb") as f:
            got = pickle.load(f)
        errs = []
        for key in ("features_IG", "adjs_IG", "sum_of_IG", "check_score"):
            g, w = np.asarray(got[key]), np.asarray(want[key])
            errs.append(float(np.abs(g - w).max()))
            if g.shape != w.shape or not np.allclose(g, w, **IG_TOL):
                raise AssertionError(f"visualize on {name}: {key} against the dense "
                                     f"run's, max |diff| {errs[-1]}")
        say(f"-- visualize on {name} (f32 payload, 1 molecule, {wall:.2f} s): IG against "
            f"the dense run's max |diff| {max(errs):.3g}; launches "
            f"{ {k: counts[k] for k in kernels} }")
        for k in kernels:
            launches[k] = counts[k]
    return launches


def featureless_rings_file(workdir):
    """Ring graphs (``EMBEDDING_RINGS``) without features, each node an id
    of EMBEDDING_VOCAB drawn from seed 0, as a pickle ``.jbl``."""
    import numpy as np

    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    path = os.path.join(workdir, "rings_featureless.jbl")
    data = make_ring_dataset(**EMBEDDING_RINGS)
    del data["feature"]
    rng = np.random.RandomState(0)
    data.update(node=rng.randint(0, EMBEDDING_VOCAB, data["dense_adj"].shape[:2]),
                node_num=EMBEDDING_VOCAB)
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=4)
    return path


def configs_embedding(workdir):
    """synth.json's gcn in node-embedding mode on a featureless ring
    dataset: 1 epoch of ``train`` and ``infer`` through the captured
    resident runners (3 gconv kernels a forward), the gradient of the
    ``NodeEmbedding`` table from one step on the card finite and not all
    zero, and one epoch's step times as for node_label.json.  Returns the
    launches."""
    import numpy as np
    import torch

    over = dict(dataset=featureless_rings_file(workdir), with_node_embedding=True,
                make_plot=False)
    launches = resident_cli(workdir, "gcn_embedding", GCN_RING_CONFIG, 1, {"gconv": 3},
                            {"gconv": 3}, **over)
    cfg = _load_config(GCN_RING_CONFIG, **over)
    info, (batch,) = _trainer_batches(cfg, 1)
    trainer = _trainer(cfg, info, capture=False)
    state = trainer.init_state(seed=0)
    name = "NodeEmbedding_0.Embed_0.embedding"
    table = state.params[name].detach().requires_grad_(True)
    params = dict(state.params, **{name: table})
    out = torch.func.functional_call(trainer.model, {**params, **state.batch_stats},
                                     (batch.to(DEVICE),), {"train": True})
    grad = torch.autograd.grad(out.cost_opt, table)[0].cpu().numpy()
    if not np.isfinite(grad).all() or not np.abs(grad).sum() > 0:
        raise AssertionError("gcn embedding: the NodeEmbedding gradient is not finite "
                             "or is zero")
    say(f"-- gcn node-embedding mode: table {tuple(grad.shape)}, gradient finite, "
        f"{int((np.abs(grad).sum(axis=1) > 0).sum())} rows reached")
    info, rb, sb, _ = _resident_setup(cfg, DEVICE)
    runner_timing("gcn embedding", cfg, info, rb, sb)
    return launches


def phase_configs(workdir):
    phase(12, "configs: train_cv, node labels, run_synth.sh with IG, node embeddings")
    t_phase = time.time()
    launches = {k: 0 for k in _counted()}
    for step in (configs_train_cv, configs_node_label, configs_synth, configs_embedding):
        for k, v in step(workdir).items():
            launches[k] += v
        say(f"configs {step.__name__} done at {time.time() - t_phase:.1f} s of the phase")
    say(f"configs phase wall {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: serving and interop

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "jax_gcn_solubility")
MULTIMODAL_CONFIG = os.path.join(ROOT, "example_config", "multimodal.json")
DYNAMIC_CLIENTS = ((64, 1), (16, 4))  # (concurrent clients, molecules each)
DYNAMIC_WINDOW_MS = 5.0               # kgcn-tpu-serve's default window
MULTIMODAL_CLIENTS = 16
SERVE_TOL = 1e-5                      # the same model on the card, other batches


def _serve(server):
    """``server`` answering from a thread: (its URL, a function that stops
    it)."""
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("server thread did not stop")
    return f"http://127.0.0.1:{server.server_address[1]}", stop


def _clients(url, bodies):
    """Every body POSTed to /predict at once, each from its own thread:
    ([(HTTP code, reply, round-trip ms)], wall seconds)."""
    out = [None] * len(bodies)

    def run(i):
        out[i] = _post(url + "/predict", bodies[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(o is None for o in out):
        raise AssertionError("a client got no answer")
    return out, wall


def _latency(label, results, wall, graphs, smi):
    ms = sorted(r[2] for r in results)
    p99 = ms[max(0, math.ceil(0.99 * len(ms)) - 1)]
    say(f"{label}: {len(ms)} concurrent requests, {graphs} graphs in {wall * 1e3:.1f} ms: "
        f"latency p50 {statistics.median(ms):.2f} ms, p99 {p99:.2f} ms, "
        f"{graphs / wall:.1f} graphs/s ({smi})")


def _device_calls(predictor):
    """Record (graphs, gconv launches) of each ``predict_data`` call of a
    Predictor (the DynamicBatcher's worker makes them one at a time)."""
    from kgcn_tpu_torch.ops.gconv import gconv

    calls, inner = [], predictor.predict_data

    def predict_data(data):
        before = gconv.launches
        resp = inner(data)
        calls.append((resp["num"], gconv.launches - before))
        return resp
    predictor.predict_data = predict_data
    return calls


def _gap(got, want):
    import numpy as np

    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def serving_fixture(workdir):
    """The checkpoint that kgcn_tpu's ``train`` wrote (the committed
    fixture): ``infer`` with ``load_model`` at it and the HTTP server over
    its directory answer the recorded 32 molecules within TOL; ``retrain``
    from it for one epoch resumes its step.  Returns the gconv launches."""
    import numpy as np

    from kgcn_tpu_torch.cli.serve import build_server
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.ops.gconv import gconv
    from kgcn_tpu_torch.runtime import checkpoint as ckpt
    from kgcn_tpu_torch.runtime import flax_msgpack

    recorded = _json(os.path.join(FIXTURE, "predictions.json"))
    want = np.asarray(recorded["prediction"])
    body = _payload(jbl.load(DATASET), recorded["molecules"])
    path = os.path.join(FIXTURE, "model.best.ckpt")
    raw = flax_msgpack.load(path)
    say(f"-- kgcn_tpu checkpoint {os.path.relpath(path, ROOT)}: "
        f"{os.path.getsize(path)} bytes, step {int(raw['step'])}, epoch {int(raw['epoch'])}")

    d = os.path.join(workdir, "fixture_infer")
    cfg, cpath = _write_config(workdir, "fixture_infer", CONFIG, load_model=path,
                               device_resident=False,
                               prediction_data=os.path.join(d, "prediction.pkl"))
    _, result, counts, wall = _cli(["infer", "--config", cpath])
    with open(cfg["prediction_data"], "rb") as f:
        pred = np.asarray(pickle.load(f))
    batches = -(-len(pred) // int(cfg["batch_size"]))
    _expect("infer of the kgcn_tpu checkpoint", counts, {"gconv": 3 * batches})
    gap_infer = _gap(pred[:len(want)], want)
    launches = counts["gconv"]

    server, predictor = build_server(_load_config(CONFIG, save_model_path=FIXTURE),
                                     host="127.0.0.1", port=0)
    url, stop = _serve(server)
    before = gconv.launches
    try:
        code, resp, ms = _post(url + "/predict", body)
    finally:
        stop()
    launches += gconv.launches - before
    if code != 200:
        raise AssertionError(f"/predict over the kgcn_tpu model directory: {code} {resp}")
    gap_serve = _gap(resp["prediction"], want)
    say(f"-- kgcn_tpu's answers to {len(want)} molecules vs the card's: infer "
        f"(load_model, {wall:.2f} s) max |diff| {gap_infer:.3g}, HTTP server over "
        f"the model directory ({ms:.2f} ms) max |diff| {gap_serve:.3g} (limit {TOL})")
    if max(gap_infer, gap_serve) > TOL or predictor.health()["checkpoint"] != path:
        raise AssertionError("the card's answers from the kgcn_tpu checkpoint differ")

    epoch = int(raw["epoch"]) + 2  # one epoch after the checkpoint's
    cfg, cpath = _write_config(workdir, "fixture_retrain", CONFIG, retrain=path,
                               epoch=epoch, save_interval=0)
    out, _, _, wall = _cli(["train", "--config", cpath])
    steps = _schedule(cfg, 1)[0]
    tree = ckpt.load_checkpoint(os.path.join(cfg["save_model_path"], "model.last.ckpt"))
    costs = _json(cfg["save_info_train"])["training_cost"]
    if (int(tree["step"]) != int(raw["step"]) + steps or len(costs) != 1
            or not math.isfinite(costs[0]) or f"[LOAD] {path}" not in out):
        raise AssertionError(f"retrain: step {int(tree['step'])}, want {int(raw['step'])} "
                             f"+ {steps}; costs {costs}")
    say(f"-- retrain from the kgcn_tpu checkpoint: epoch {epoch - 1}, training cost "
        f"{costs[0]:.6g}, step {int(raw['step'])} + {steps} = {int(tree['step'])} "
        f"({wall:.2f} s)")
    return launches


def serving_dynamic(workdir, smi):
    """Dynamic batching over the fixture's model against the plain server:
    64 clients of 1 molecule, then 16 of 4, all at once.  Every coalesced
    reply equals the plain server's (SERVE_TOL), each device call launches
    3 gconv kernels a batch of 32, and a malformed request among good ones
    gets 400 alone.  Returns the gconv launches."""
    from kgcn_tpu_torch.cli.serve import build_server
    from kgcn_tpu_torch.data import jbl

    data = jbl.load(DATASET)
    cfg = _load_config(CONFIG, save_model_path=FIXTURE)
    bs = int(cfg["batch_size"])
    solo_server, solo = build_server(cfg, host="127.0.0.1", port=0)
    dyn_server, dyn = build_server(cfg, host="127.0.0.1", port=0, dynamic_batching=True,
                                   window_ms=DYNAMIC_WINDOW_MS)
    solo_url, stop_solo = _serve(solo_server)
    dyn_url, stop_dyn = _serve(dyn_server)
    launches = 0
    try:
        warm = _payload(data, [0])
        for url in (solo_url, dyn_url):  # the models built, the kernels loaded
            if _post(url + "/predict", warm)[0] != 200:
                raise AssertionError("warm-up request failed")
        calls = _device_calls(dyn.p)
        for clients, per in DYNAMIC_CLIENTS:
            bodies = [_payload(data, list(range(i * per, (i + 1) * per)))
                      for i in range(clients)]
            solo_res, solo_wall = _clients(solo_url, bodies)
            del calls[:]
            dyn_res, dyn_wall = _clients(dyn_url, bodies)
            worst = 0.0
            for (c1, r1, _), (c2, r2, _) in zip(solo_res, dyn_res):
                if c1 != 200 or c2 != 200:
                    raise AssertionError(f"HTTP {c1}/{c2}: {r1} {r2}")
                worst = max(worst, _gap(r2["prediction"], r1["prediction"]))
            merged = [r[1].get("coalesced", 1) for r in dyn_res]
            wrong = [(g, n) for g, n in calls if n != 3 * -(-g // bs)]
            say(f"-- {clients} clients x {per} molecule(s): {len(calls)} device calls of "
                f"{[g for g, _ in calls]} graphs, gconv launches {[n for _, n in calls]}, "
                f"largest merge {max(merged)} requests; dynamic vs plain replies max "
                f"|diff| {worst:.3g} (limit {SERVE_TOL})")
            if wrong or worst > SERVE_TOL or sum(g for g, _ in calls) != clients * per:
                raise AssertionError(f"dynamic batching: calls {calls}, gap {worst}")
            launches += sum(n for _, n in calls)
            _latency(f"plain server, {clients} x {per}", solo_res, solo_wall,
                     clients * per, smi)
            _latency(f"dynamic batching, {clients} x {per}", dyn_res, dyn_wall,
                     clients * per, smi)
        bad = _payload(data, [3])
        bad["adj"][0][0][0][0] = [0, 90]  # an edge to node 90 of a 47-node graph
        bodies = [_payload(data, [i]) for i in range(8)]
        n_calls = len(calls)
        mixed, _ = _clients(dyn_url, bodies[:4] + [bad] + bodies[4:])
        codes = [c for c, _, _ in mixed]
        launches += sum(n for _, n in calls[n_calls:])
        if codes != [200] * 4 + [400] + [200] * 4:
            raise AssertionError(f"a malformed request among good ones: codes {codes}")
        health = dyn.health()["dynamic_batching"]
        say(f"-- a malformed request among 8 good ones: codes {codes}; "
            f"dynamic_batching {health}")
        if health["coalesced_calls"] < 1:
            raise AssertionError("no call was coalesced")
    finally:
        stop_solo()
        stop_dyn()
        dyn.close()
    return launches


def serving_export(workdir):
    """``train`` of solubility_cls.json for 2 epochs with ``export_model``,
    then ``--export`` over HTTP: 32 molecules equal to the Predictor on the
    same weights (SERVE_TOL), and torch.profiler records the gconv kernels
    (3 a batch) in the exported program's run.  Returns the launches."""
    from kgcn_tpu_torch.cli.serve import build_server
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.ops.gconv import gconv
    from kgcn_tpu_torch.runtime.serve import Predictor

    export = os.path.join(workdir, "export", "model.pt2")
    t0 = time.time()
    _, _, _, _, out = train_run(workdir, "export_train", CONFIG, 2, export_model=export)
    if f"[SAVE] {export}" not in out or not os.path.exists(export + ".params"):
        raise AssertionError("train with export_model wrote no artifact")
    say(f"-- export: {os.path.getsize(export)} bytes at {export} "
        f"(train + export {time.time() - t0:.2f} s)")
    cfg = _json(os.path.join(workdir, "export_train", "config.json"))
    body = _payload(jbl.load(DATASET), list(range(32)))
    server, ep = build_server(cfg, host="127.0.0.1", port=0, export=export)
    url, stop = _serve(server)
    before = gconv.launches
    try:
        code, resp, ms = _post(url + "/predict", body)
    finally:
        stop()
    launches = gconv.launches - before
    want = Predictor(cfg, checkpoint=export + ".params").predict(body)["prediction"]
    gap = _gap(resp["prediction"], want)
    say(f"-- --export over HTTP: HTTP {code}, {ms:.2f} ms, {resp.get('num')} molecules; "
        f"vs the Predictor on the same weights max |diff| {gap:.3g} (limit {SERVE_TOL}); "
        f"{launches} gconv launches")
    if code != 200 or gap > SERVE_TOL or launches != 3:
        raise AssertionError(f"--export: HTTP {code}, gap {gap}, launches {launches}")
    _, kernels, _, _, _ = profiled(lambda: ep.predict(body), cpu=False)
    say(f"-- the exported program's run under torch.profiler: gconv kernels "
        f"{kernels['gconv']} (want 3: one batch of 32)")
    if kernels["gconv"] != 3 or sum(kernels.values()) != 3:
        raise AssertionError(f"exported program: kernels {kernels}")
    return launches + kernels["gconv"]


def serving_multimodal(workdir):
    """example_config/multimodal.json: ``train`` (CONFIG_EPOCHS, captured)
    and ``infer`` through the resident runners (1 gconv kernel a forward),
    the same training on the CPU (per-epoch costs within TRAJECTORY_RTOL),
    then dynamic batching of 16 clients of one compound–protein pair
    against the Predictor's solo replies (SERVE_TOL).  Returns the
    launches."""
    from kgcn_tpu_torch.cli.serve import build_server
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.runtime.serve import Predictor

    launches = resident_cli(workdir, "multimodal", MULTIMODAL_CONFIG, CONFIG_EPOCHS,
                            {"gconv": 1}, {"gconv": 1})
    gpu = _json(os.path.join(workdir, "multimodal", "info_train.json"))["training_cost"]
    cpu, _, _, _, _ = train_run(workdir, "multimodal_cpu", MULTIMODAL_CONFIG,
                                CONFIG_EPOCHS, cpu=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(gpu, cpu)]
    say(f"GPU (captured) vs CPU multimodal.json per-epoch costs: GPU {gpu} CPU {cpu} "
        f"relative difference {rel} (limit {TRAJECTORY_RTOL})")
    if max(rel) > TRAJECTORY_RTOL:
        raise AssertionError(f"multimodal: GPU and CPU costs differ by {max(rel)}")
    cfg = _json(os.path.join(workdir, "multimodal", "config.json"))
    data = jbl.load(cfg["dataset"])

    def pair(i):
        import numpy as np

        return {"feature": np.asarray(data["feature"])[[i]].tolist(),
                "dense_adj": np.asarray(data["dense_adj"])[[i]].tolist(),
                "sequence": np.asarray(data["sequence"])[[i]].tolist(),
                "sequence_length": [int(data["sequence_length"][i])],
                "sequence_symbol_num": int(data["sequence_symbol_num"]),
                "max_node_num": int(data["max_node_num"])}

    bodies = [pair(i) for i in range(MULTIMODAL_CLIENTS)]
    solo = Predictor(cfg)
    want = [solo.predict(b)["prediction"] for b in bodies]
    server, dyn = build_server(cfg, host="127.0.0.1", port=0, dynamic_batching=True,
                               window_ms=DYNAMIC_WINDOW_MS)
    url, stop = _serve(server)
    try:
        _post(url + "/predict", bodies[0])  # the model built
        results, wall = _clients(url, bodies)
    finally:
        stop()
        dyn.close()
    worst = max(_gap(r[1]["prediction"], w) for r, w in zip(results, want))
    say(f"-- multimodal dynamic batching: {MULTIMODAL_CLIENTS} clients of one pair, "
        f"codes {sorted(set(r[0] for r in results))}, {dyn.coalesced_calls} coalesced "
        f"call(s), vs solo max |diff| {worst:.3g} (limit {SERVE_TOL}), {wall * 1e3:.1f} ms")
    if any(r[0] != 200 for r in results) or worst > SERVE_TOL or dyn.coalesced_calls < 1:
        raise AssertionError("multimodal dynamic batching failed")
    return launches


def phase_serving(workdir, smi):
    phase(14, "serving and interop: a kgcn_tpu checkpoint, dynamic batching, export, "
              "multimodal")
    t_phase = time.time()
    launches = {k: 0 for k in _counted()}
    launches["gconv"] += serving_fixture(workdir)
    say(f"serving fixture done at {time.time() - t_phase:.1f} s of the phase")
    launches["gconv"] += serving_dynamic(workdir, smi)
    say(f"serving dynamic done at {time.time() - t_phase:.1f} s of the phase")
    launches["gconv"] += serving_export(workdir)
    say(f"serving export done at {time.time() - t_phase:.1f} s of the phase")
    for k, v in serving_multimodal(workdir).items():
        launches[k] += v
    say(f"serving phase wall {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the engines — sparse (reaction scale and beyond 256 nodes), pair, VAE

PAIR_CONFIG = os.path.join(ROOT, "example_config", "pair.json")
VAE_CONFIG = os.path.join(ROOT, "example_config", "vae.json")
# the reaction workload (SURVEY.md:140, :345): 20 014 classes at batch 128,
# molecules of up to 203 atoms with 81 atom features
REACTION = dict(graphs=2048, lo=20, hi=203, features=81, classes=20014, batch=128,
                shards=4, seed=0)
# graphs beyond the dense threshold (block-diagonal batches: the tiled kernel)
BEYOND_256 = dict(graphs=256, lo=257, hi=600, features=81, classes=20014, batch=32,
                  shards=1, seed=1)
ENGINE_EPOCHS = 2
ENGINE_TOL = 1e-5  # the same checkpoint and ε on the card and on the CPU
# GPU vs CPU summed-CE costs of the first sparse training steps from one
# seed (costs near 1 300 at batch 128): the NVIDIA H100 80GB HBM3 (700 W)
# has shown 9.2e-8 at the reaction scale
ENGINE_STEP_RTOL = 1e-6


def molecule_graphs(n_graphs, lo, hi, features, classes, seed):
    """Chain-and-ring molecular graphs of ``lo``-``hi`` atoms: a chain
    closed into rings by one bond per ten atoms (mean degree ≈ 2.2), atom
    features a one-hot type among 44, a one-hot degree and a ring bit (of
    ``features`` columns), one class label each: (dense adjacency,
    features, label) triples."""
    import numpy as np

    rng = np.random.RandomState(seed)
    for _ in range(n_graphs):
        n = int(rng.randint(lo, hi + 1))
        a = np.zeros((n, n), np.float32)
        i = np.arange(n - 1)
        a[i, i + 1] = a[i + 1, i] = 1.0
        ring = rng.choice(n - 5, size=max(n // 10, 1), replace=False)
        a[ring, ring + 5] = a[ring + 5, ring] = 1.0
        f = np.zeros((n, features), np.float32)
        f[np.arange(n), rng.randint(0, 44, n)] = 1.0
        f[np.arange(n), 44 + a.sum(axis=1).astype(int)] = 1.0
        f[ring, features - 1] = f[ring + 5, features - 1] = 1.0
        yield a, f, [int(rng.randint(0, classes))]


def write_molecules(workdir, name, spec):
    """The spec's molecules as TFRecord shards written by the port's writer:
    (glob pattern, seconds)."""
    from kgcn_tpu_torch.data.tfrecord import example_from_graph, write_tfrecord

    t0 = time.perf_counter()
    d = os.path.join(workdir, name)
    os.makedirs(d)
    records = [example_from_graph(a, f, y, [1]) for a, f, y in molecule_graphs(
        spec["graphs"], spec["lo"], spec["hi"], spec["features"], spec["classes"],
        spec["seed"])]
    for k in range(spec["shards"]):
        write_tfrecord(os.path.join(d, f"part-{k:02d}.tfrecords"), records[k::spec["shards"]])
    return os.path.join(d, "part-*.tfrecords"), time.perf_counter() - t0


def sparse_config(workdir, name, pattern, spec, **over):
    """A ``cli.sparse`` config at the SparseGCN defaults (out_dims 256 × 3,
    dense_dim 256): (config, path)."""
    d = os.path.join(workdir, name)
    cfg = {"dataset": pattern, "test_dataset": pattern, "num_classes": spec["classes"],
           "batch_size": spec["batch"], "epoch": ENGINE_EPOCHS, "learning_rate": 0.001,
           "num_folds": 5, "task": "classification", "save_interval": 0,
           "shuffle_data": True, "seed": 0, "save_model_path": os.path.join(d, "model"),
           "save_info_valid": os.path.join(d, "valid.json"),
           "save_info_test": os.path.join(d, "test.json"),
           "prediction_output": os.path.join(d, "prediction.jbl")}
    cfg.update(over)
    path = os.path.join(d, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def _forward_launches(model, batch):
    """The kernel launches of one forward (the wrappers' counts)."""
    import torch

    _zero_counts()
    with torch.no_grad():
        model(batch)
    torch.cuda.synchronize()
    return {k: v for k, v in _counts().items() if v}


def kernel_breakdown(run, steps, top=8):
    """The device time of ``run()`` (``steps`` steps) by kernel name, ms a
    step, the ``top`` largest first, with the rest summed: [(name, ms)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((key, us / 1e3 / steps) for key, (_, us) in cuda_events(prof)[0].items()),
                  key=lambda r: -r[1])
    rest = sum(ms for _, ms in rows[top:])
    return [(name[:90], ms) for name, ms in rows[:top]] + [("the rest", rest)]


def _split(n, folds=5):
    """(training, validation) sizes of fold 0 of cli.sparse's modulo split."""
    valid = -(-n // folds)
    return n - valid, valid


def _recorded(module, name, run):
    """``run()`` with ``module.name`` replaced by a recorder that passes
    each call on: the calls' positional and keyword arguments."""
    calls, real = [], getattr(module, name)

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)
    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, real)
    return calls


def engine_gconv_check(label, model, batch):
    """Each GraphConv's gconv call in one forward of ``model`` on ``batch``
    (the engine's own operands: the batch's adjacency with its padded rows,
    its features and activations, the layer's weights) launched again on
    the card and held against the plain version (rtol = atol = TOL, as in
    phase 3), two launches bitwise equal, and the backward against autograd
    through the plain version.  Returns the shapes checked."""
    import torch

    from kgcn_tpu_torch.nn import layers
    from kgcn_tpu_torch.ops.gconv import gconv, gconv_reference

    def forward():
        with torch.no_grad():
            model(batch)
    t0 = time.time()
    calls = _recorded(layers, "gconv", forward)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    shapes = []
    for i, (args, _) in enumerate(calls):
        adj, x, w, b = (t.detach() for t in args)
        shape = (*adj.shape[:3], x.shape[2], w.shape[2])
        got = gconv(adj, x, w, b)
        if x.dtype == torch.bfloat16:
            err = within_one_bf16_rounding(f"gconv {label} layer {i} {shape}",
                                           (adj, x, w, b), got)
            limit = "kernel and plain each within one bf16 rounding of the f64 sum"
        else:
            err = _check(f"gconv {label} layer {i} {shape}", got,
                         gconv_reference(adj, x, w, b))
            limit = f"limit {TOL}"
        if not torch.equal(got, gconv(adj, x, w, b)):
            raise AssertionError(f"gconv {label} layer {i}: two launches differ")
        say(f"gconv {label} layer {i} C,B,N,Fin,Fout={shape} {x.dtype}: max |kernel - "
            f"plain| {err:.3g} ({limit}); two launches bitwise equal")
        gconv_gradients_check(f"{label} layer {i}", adj, x, w, b, gen)
        shapes.append(shape)
    if not calls:
        raise AssertionError(f"{label}: the forward made no gconv call")
    say(f"gconv {label}: {len(calls)} calls of the engine's forward checked in "
        f"{time.time() - t0:.1f} s")
    return shapes


def engine_tiled_check(label, model, host_batch, extra_widths=()):
    """Each GraphConv's tiled SpMM call in one forward of ``model`` on
    ``host_batch`` moved to the card (the batch's own structure, edge
    weights, projected features and payload), held against the plain
    versions on CPU copies (``_tiled_errors``: the SpMM and its transpose,
    f32 and bf16 payload, rtol = atol = TOL, two launches bitwise equal)
    and the public wrapper's value and gradients against the CPU's
    (``wrapper_gradients``); the same on random features of each of
    ``extra_widths``.  Returns the widths checked."""
    import torch

    from kgcn_tpu_torch.ops import spmm as spmm_mod
    from kgcn_tpu_torch.ops import tiled_spmm as tt

    t0 = time.time()
    batch = host_batch.to(DEVICE)

    def forward():
        with torch.no_grad():
            model(batch)
    calls = _recorded(spmm_mod, "tiled_spmm", forward)
    if not calls:
        raise AssertionError(f"{label}: the forward made no tiled SpMM call")
    cases = []
    for (te, w, x), kw in calls:
        c = next(c for c, t in enumerate(batch.graph.tiled_adj) if t is te)
        cases.append((c, x.detach().float().contiguous(), kw.get("compute_dtype", "bfloat16")))
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for F in extra_widths:
        x = torch.randn((calls[0][0][0].meta.num_senders, F), device=DEVICE, generator=gen)
        cases.append((0, x, cases[0][2]))
    structures = {}
    for i, (c, x, dt) in enumerate(cases):
        if c not in structures:
            structures[c] = tt.with_plan(host_batch.graph.tiled_adj[c])
        te_cpu, w_cpu = structures[c], host_batch.graph.edge_weights[c].float()
        te, w = batch.graph.tiled_adj[c], batch.graph.edge_weights[c].float()
        F = x.shape[1]
        what = f"{label} call {i} F={F}" if i < len(calls) else f"{label} F={F} (random x)"
        g = torch.randn((te.meta.num_receivers, F), device=DEVICE, generator=gen)
        errs = _tiled_errors(what, te, te_cpu, w, w_cpu, x, g, sddmm=False)
        say(f"tiled {what}: {te.meta.num_senders} nodes, {te.meta.num_edges} edges, path "
            f"payload {dt}; max |kernel - plain| "
            + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (limit {TOL}); two launches of spmm and spmm^T bitwise equal")
        wrapper_gradients(what, te_cpu, w_cpu, F, x0=x.cpu(), compute_dtype=dt)
    say(f"tiled {label}: {len(calls)} calls of the engine's forward and "
        f"{len(extra_widths)} more widths checked in {time.time() - t0:.1f} s")
    return [x.shape[1] for _, x, _ in cases]


def engine_steps_gpu_vs_cpu(label, cfg, info, batches, rtol=ENGINE_STEP_RTOL,
                           launches=None):
    """The first training steps of the sparse engine on ``batches``, on the
    card and on the CPU from one seed: summed-CE costs within ``rtol``
    (ENGINE_STEP_RTOL); with ``launches``, the card's kernel launches equal
    to it."""
    from kgcn_tpu_torch.cli import sparse as cli_sparse
    from kgcn_tpu_torch.runtime.train import Trainer

    t0, costs = time.time(), {}
    for dev in (DEVICE, "cpu"):
        t = Trainer(cli_sparse._model(cfg, info), cfg, info, device=dev)
        state = t.init_state(0)
        _zero_counts()
        got = []
        for batch in batches:
            state, c, _ = t.train_step(state, batch)
            got.append(float(c))
        costs[dev] = got
        if launches is not None:
            _expect(f"{label} steps on {dev}", _counts(), launches if dev == DEVICE else {})
    rel = [abs(a - b) / abs(b) for a, b in zip(costs[DEVICE], costs["cpu"])]
    say(f"GPU vs CPU {label} steps ({len(batches)}, one seed): GPU {costs[DEVICE]} CPU "
        f"{costs['cpu']} relative difference {rel} (limit {rtol}); "
        f"{time.time() - t0:.1f} s")
    if max(rel) > rtol:
        raise AssertionError(f"{label}: GPU and CPU step costs differ by {max(rel)}")
    return rel


def sparse_reaction(workdir):
    """The reaction workload through ``cli.sparse``: shards written, read
    through the host parser (timed), ``train`` 2 epochs (the captured
    resident runner: one graph launch a step; gconv launches as the
    forward's over replays, warm-ups and the eager validation), a timed
    captured epoch with its device time by kernel, the captured runner
    against its eager steps (bitwise), ``infer`` over every graph, the
    gconv kernel at the engine's shapes against its plain version
    (``engine_gconv_check``), and 3 streaming steps on the card and on the
    CPU from one seed (ENGINE_STEP_RTOL).  Returns the gconv launches and
    the numbers for PERF.md."""
    import glob

    import numpy as np

    from kgcn_tpu_torch.cli import sparse as cli_sparse
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.tfrecord import load_tfrecord_dataset
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.resident import ResidentBatcher
    from kgcn_tpu_torch.runtime.train import Trainer

    spec = REACTION
    pattern, write_s = write_molecules(workdir, "reaction", spec)
    cfg, path = sparse_config(workdir, "reaction", pattern, spec)
    paths = sorted(glob.glob(pattern))
    t0 = time.perf_counter()
    ds, info = load_tfrecord_dataset(paths, cfg)
    read_s = time.perf_counter() - t0
    be = backend.resolve(dict(cfg), info, log=False)
    nbytes = sum(os.path.getsize(p) for p in paths)
    say(f"reaction data: {ds.num} graphs of {ds.enabled_node_nums.min()}-"
        f"{ds.enabled_node_nums.max()} atoms (mean degree "
        f"{sum(len(a[0][0]) for a in ds.adjs) / ds.enabled_node_nums.sum():.3f}), "
        f"{info.feature_dim} features, {spec['classes']} classes; {len(paths)} shards, "
        f"{nbytes} bytes, written in {write_s:.3f} s, read through the host parser in "
        f"{read_s:.4f} s ({ds.num / read_s:.0f} graphs/s); backend {be.name}")
    if be.name != "dense" or ds.num != spec["graphs"] or info.feature_dim != spec["features"]:
        raise AssertionError(f"reaction data: backend {be.name}, {ds.num} graphs, "
                             f"{info.feature_dim} features")
    B = spec["batch"]
    n_train, n_valid = _split(ds.num)
    train_ds = ds.subset(np.arange(ds.num)[np.arange(ds.num) % 5 != 0])
    sb = Batcher(train_ds, info, B, seed=0, backend=be)
    probe = Trainer(cli_sparse._model(cfg, info), cfg, info, device=DEVICE)
    per_fwd = _forward_launches(probe.model, sb.make_batch(np.arange(B)).to(DEVICE))
    steps, evals = ENGINE_EPOCHS * -(-n_train // B), (ENGINE_EPOCHS + 1) * -(-n_valid // B)

    out, launches = _engine_train("cli.sparse (reaction, resident)", cli_sparse, path,
                                  per_fwd, steps, evals)
    valid = _json(cfg["save_info_valid"])
    if (set(valid) != {"valid_cost", "valid_accuracy", "valid_top30", "valid_top50"}
            or not all(math.isfinite(v) for v in valid.values())):
        raise AssertionError(f"sparse train: valid {valid}")
    say(f"-- cli.sparse train: {evals} eager validation batches, {per_fwd} a forward; "
        f"valid {valid}")

    # one captured epoch timed step by step, in the runner the CLI ran
    rb = ResidentBatcher(train_ds, info, B, seed=0, backend=be, device=DEVICE)
    tr = Trainer(cli_sparse._model(cfg, info), cfg, info, device=DEVICE)
    holder = [tr.init_state(0)]

    def run():
        holder[0] = tr.run_epoch(holder[0], rb, epoch=0)[0]
    S = rb.num_batches
    step_ms, pstep_ms, busy_ms, idle = epoch_numbers(run, S)
    say(f"reaction step (captured, {S} steps of {B} graphs, NVIDIA card above): wall "
        f"{step_ms:.4f} ms (profiled {pstep_ms:.4f}), device busy {busy_ms:.4f} ms, idle "
        f"share {idle:.4f}, {n_train / (step_ms * S / 1e3):.1f} graphs/s")
    breakdown = kernel_breakdown(run, S)
    say("reaction step by kernel, device ms a step: " + "; ".join(
        f"{name} {ms:.4f}" for name, ms in breakdown))
    captured_vs_eager("sparse reaction (resident)", cfg, info,
                      lambda: ResidentBatcher(train_ds, info, B, seed=0, backend=be,
                                              device=DEVICE),
                      build=lambda info, cfg: cli_sparse._model(cfg, info))

    out, ev, counts, infer_s = _cli(["infer", "--config", path], cli=cli_sparse)
    n_batches = -(-ds.num // B)
    with open(cfg["prediction_output"], "rb") as f:
        pred = pickle.load(f)
    want = {k: per_fwd.get(k, 0) * n_batches for k in counts}
    if (counts != want or pred.shape != (ds.num, spec["classes"])
            or not np.isfinite(pred).all()
            or np.abs(pred.sum(axis=1) - 1).max() > 1e-4
            or set(_json(cfg["save_info_test"])) != {"test_cost", "test_accuracy",
                                                     "test_top30", "test_top50"}):
        raise AssertionError(f"sparse infer: launches {counts} (want {want}), prediction "
                             f"{pred.shape}")
    say(f"-- cli.sparse infer: {ds.num} graphs in {infer_s:.3f} s ({n_batches} batches, "
        f"gconv launches {want['gconv']}), {_json(cfg['save_info_test'])}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v

    # the kernel at the engine's shapes, and 3 streaming steps from one
    # seed on the card and on the CPU
    batches = [sb.make_batch(np.arange(i * B, (i + 1) * B)) for i in range(3)]
    engine_gconv_check("reaction", probe.model, batches[0].to(DEVICE))
    engine_steps_gpu_vs_cpu("reaction", cfg, info, batches)
    return launches, dict(read_s=read_s, step_ms=step_ms, busy_ms=busy_ms, idle=idle)


def sparse_beyond_256(workdir):
    """Graphs of 257-600 atoms through ``cli.sparse train`` (1 epoch):
    ``auto`` resolves to the tiled backend, the streaming loop builds each
    batch's tiled structures; 6 SpMM launches a training step and 3 an
    evaluated batch, no gconv.  Then the tiled SpMM at the engine's shapes
    against its plain version (``engine_tiled_check``, the path's width
    and the input width 81) and 3 training steps on the card and on the
    CPU from one seed (ENGINE_STEP_RTOL).  Returns the launches."""
    import glob

    import numpy as np

    from kgcn_tpu_torch.cli import sparse as cli_sparse
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.tfrecord import load_tfrecord_dataset
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.train import Trainer

    spec = BEYOND_256
    pattern, write_s = write_molecules(workdir, "beyond256", spec)
    cfg, path = sparse_config(workdir, "beyond256", pattern, spec, epoch=1)
    n_train, n_valid = _split(spec["graphs"])
    B = spec["batch"]
    steps, evals = -(-n_train // B), 2 * -(-n_valid // B)
    out, _, counts, wall = _cli(["train", "--config", path], cli=cli_sparse)
    want = {k: 0 for k in counts}
    want["tiled_spmm"] = 6 * steps + 3 * evals
    if "[spmm] backend: tiled" not in out or counts != want:
        raise AssertionError(f"sparse beyond 256: launches {counts}, want {want}")
    valid = _json(cfg["save_info_valid"])
    if not all(math.isfinite(v) for v in valid.values()):
        raise AssertionError(f"sparse beyond 256: {valid}")
    say(f"-- cli.sparse train beyond 256 nodes ({spec['graphs']} graphs of {spec['lo']}-"
        f"{spec['hi']} atoms, batch {B}, written in {write_s:.3f} s): backend tiled, "
        f"{steps} steps and {evals} evaluated batches in {wall:.3f} s, tiled SpMM launches "
        f"{counts['tiled_spmm']} as predicted; valid {valid}")

    ds, info = load_tfrecord_dataset(sorted(glob.glob(pattern)), cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    train_ds = ds.subset(np.arange(ds.num)[np.arange(ds.num) % 5 != 0])
    sb = Batcher(train_ds, info, B, seed=0, backend=be)
    batches = [sb.make_batch(np.arange(i * B, (i + 1) * B)) for i in range(3)]
    model = Trainer(cli_sparse._model(cfg, info), cfg, info, device=DEVICE).model
    widths = engine_tiled_check("beyond 256", model, batches[0], extra_widths=(81,))
    engine_steps_gpu_vs_cpu("beyond 256 (tiled)", cfg, info, batches)
    say(f"sparse beyond 256: tiled SpMM checked at widths {widths} ({be.name}, payload "
        f"{be.compute_dtype})")
    return counts


def _engine_config(workdir, name, src, **over):
    """A copy of a shipped config with its dataset in the checkout and its
    outputs under ``workdir``: (the config as the engines load it, with
    the defaults, path)."""
    from kgcn_tpu_torch.runtime.config import load_config

    d = os.path.join(workdir, name)
    os.makedirs(d)
    with open(src) as f:
        cfg = json.load(f)
    cfg.update(dataset=os.path.join(ROOT, cfg["dataset"]), epoch=ENGINE_EPOCHS,
               save_model_path=os.path.join(d, "model"),
               save_result_test=os.path.join(d, "scores.csv"),
               reconstruction_output=os.path.join(d, "reconstruction.jbl"),
               generation_output=os.path.join(d, "generated.jbl"))
    cfg.update(over)
    path = os.path.join(d, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return load_config(path), path


def _engine_train(label, cli, path, per_fwd, steps, evals):
    """``train`` of an engine under torch.profiler, its epochs through a
    captured runner and ``evals`` eager forwards: one graph launch a step;
    the profiler records ``per_fwd`` over the replays, the warm-ups and the
    eager forwards, the wrappers over the warm-ups, the capture and the
    eager forwards (on the CPU, where nothing is captured, over every
    step).  Returns (stdout, the profiler's launches)."""
    import torch

    from kgcn_tpu_torch.runtime.runner import WARMUP_STEPS

    captured = torch.device(DEVICE).type == "cuda"
    warm = WARMUP_STEPS if captured else 0
    wrapped = WARMUP_STEPS + 1 if captured else steps
    want = {k: per_fwd.get(k, 0) * (steps + warm + evals) for k in _counted()}
    want_wrap = {k: per_fwd.get(k, 0) * (wrapped + evals) for k in _counted()}
    for attempt in range(PROFILER_ATTEMPTS):  # taken again while _short
        (out, _, counts, _), kernels, graphs, busy, wall = profiled(
            lambda: _cli(["train", "--config", path], cli=cli))
        got = _profiler_launches(kernels, counts)
        if not _short(got, want, graphs, steps) or attempt == PROFILER_ATTEMPTS - 1:
            break
        say(f"  torch.profiler recorded {got} of {want}; the training is taken again")
    if got != want or counts != want_wrap or graphs != steps:
        raise AssertionError(f"{label} train: profiler {got} (want {want}), wrappers "
                             f"{counts} (want {want_wrap}), {graphs} graph launches "
                             f"(want {steps})")
    say(f"-- {label} train (captured): {steps} steps in {graphs} graph launches, kernel "
        f"launches {dict((k, v) for k, v in got.items() if v)} as predicted "
        f"({dict((k, v) for k, v in per_fwd.items() if v)} a forward); device busy "
        f"{busy:.3f} s of {wall:.3f} s")
    return out, got


def _rel_gap(got, want):
    """The largest gap relative to ``want`` (1e-6 added below)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-6)))


def engine_pair(workdir):
    """pair.json: ``train`` (2 epochs, the resident pair batcher: both
    towers gathered on the card, captured), ``infer`` on the card and on
    the CPU from its checkpoint (scores within ENGINE_TOL), two GPU runs of
    a pair step bitwise equal (segment_max's max and its tied gradients),
    and the captured runner bitwise equal to its eager steps.  Returns the
    launches."""
    import re

    import numpy as np
    import torch

    from kgcn_tpu_torch.cli import pair as cli_pair
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.pair import GCNPairRanker, PairBatcher, ResidentPairBatcher
    from kgcn_tpu_torch.runtime import backend

    cfg, path = _engine_config(workdir, "pair", PAIR_CONFIG, dropout_rate=0.0)
    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    pairs = np.asarray(ds.graph_index_list)
    B = int(cfg["batch_size"])

    def build(info, cfg):
        return GCNPairRanker(in_features=info.feature_dim, label_dim=info.label_dim,
                             dropout_rate=float(cfg["dropout_rate"]))

    sb = PairBatcher(ds, info, pairs, B, backend=be)
    per_fwd = _forward_launches(build(info, cfg).to(DEVICE),
                                sb.make_batch(np.arange(B)).to(DEVICE))
    steps = ENGINE_EPOCHS * -(-len(pairs) // B)
    out, launches = _engine_train("cli.pair", cli_pair, path, per_fwd, steps, 0)
    accs = [float(a) for a in re.findall(r"pair acc=([\d.]+)", out)]
    gpu_ev = _cli(["infer", "--config", path], cli=cli_pair)
    cpu_ev = _cli(["infer", "--config", path], cpu=True, cli=cli_pair)
    for k, v in gpu_ev[2].items():
        launches[k] = launches.get(k, 0) + v
    gap = _rel_gap(gpu_ev[1]["prediction"], cpu_ev[1]["prediction"])
    with open(cfg["save_result_test"]) as f:
        lines = f.read().splitlines()
    if (lines[0] != "score0,score1" or len(lines) != len(pairs) + 1 or gap > ENGINE_TOL
            or len(accs) != ENGINE_EPOCHS):
        raise AssertionError(f"pair infer: {lines[:2]}, {len(lines)} lines, GPU vs CPU {gap}")
    say(f"-- cli.pair infer: {len(pairs)} pairs scored; the checkpoint's scores on the card "
        f"vs the CPU: max relative gap {gap:.3g} (limit {ENGINE_TOL}); pair accuracy by "
        f"epoch {accs}")

    # two GPU runs of one step bitwise equal
    runs = []
    for _ in range(2):
        t = _trainer(cfg, info, build=build)
        state, c, _ = t.train_step(t.init_state(0), sb.make_batch(np.arange(B)))
        runs.append((c, state.params))
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    if not same:
        raise AssertionError("pair: two GPU runs of one step differ")
    say("pair: two GPU runs of one training step bitwise equal (cost and every parameter)")
    captured_vs_eager("pair (resident)", cfg, info,
                      lambda: ResidentPairBatcher(ds, info, pairs, B, backend=be,
                                                  device=DEVICE), build=build)
    return launches


def engine_vae(workdir):
    """vae.json: ``train`` (2 epochs, the resident VAE batcher: ε drawn on
    the card each step, captured; validation with the streaming ε),
    ``reconstruct`` and ``generate`` (the dumps' keys and shapes),
    ``reconstruct`` on the card and on the CPU from one checkpoint with the
    streaming ε (ENGINE_TOL), the captured runner bitwise equal to its eager
    steps (the same ε: the generator's state restored), and the resident
    evaluation runner's dict predictions (ε 0) captured bitwise equal to
    eager.  Returns the launches."""
    import numpy as np

    from kgcn_tpu_torch.cli import gen as cli_gen
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl, split_dataset
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.resident import ResidentBatcher, ResidentVAEBatcher

    cfg, path = _engine_config(workdir, "vae", VAE_CONFIG)
    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    latent, B = int(cfg["latent_dim"]), int(cfg["batch_size"])
    train_ds, valid_ds, _, _ = split_dataset(ds, cfg["validation_data_rate"], seed=cfg["seed"])
    probe = _trainer(cfg, info)
    sample = Batcher(ds, info, B, epsilon_dim=latent, backend=be).make_batch(np.arange(B))
    per_fwd = _forward_launches(probe.model, sample.to(DEVICE))
    steps = ENGINE_EPOCHS * -(-train_ds.num // B)
    evals = ENGINE_EPOCHS * -(-valid_ds.num // B)  # one validation pass an epoch
    _, launches = _engine_train("cli.gen", cli_gen, path, per_fwd, steps, evals)
    gpu = _cli(["reconstruct", "--config", path], cli=cli_gen)
    cpu = _cli(["reconstruct", "--config", path], cpu=True, cli=cli_gen)
    gen = _cli(["generate", "--config", path], cli=cli_gen)
    for k, v in gpu[2].items():
        launches[k] = launches.get(k, 0) + v + gen[2][k]
    rec = gpu[1]["prediction"]
    gaps = {k: _rel_gap(rec[k], cpu[1]["prediction"][k]) for k in rec}
    with open(cfg["generation_output"], "rb") as f:
        generated = pickle.load(f)
    shapes = {k: v.shape for k, v in rec.items()}
    if (shapes != {"feature": (ds.num, 10, 3), "dense_adj": (ds.num, 1, 10, 10)}
            or {k: v.shape[0] for k, v in generated.items()} != {"feature": 10, "dense_adj": 10}
            or max(gaps.values()) > ENGINE_TOL):
        raise AssertionError(f"vae: reconstruction {shapes}, generated "
                             f"{ {k: v.shape for k, v in generated.items()} }, GPU vs CPU {gaps}")
    say(f"-- cli.gen reconstruct and generate: {shapes}, generated "
        f"{ {k: v.shape for k, v in generated.items()} }; the checkpoint's reconstruction "
        f"on the card vs the CPU (streaming ε): max relative gaps {gaps} (limit {ENGINE_TOL})")

    def make():
        return ResidentVAEBatcher(train_ds, info, B, latent, backend=be, device=DEVICE)

    captured_vs_eager("vae (resident, ε on the card)", cfg, info, make)
    # the evaluation runner's dict predictions (a ResidentBatcher: ε 0; the
    # VAE batcher itself evaluates through its host-ε batches)
    preds = []
    for capture in (False, True):
        t = _trainer(cfg, info, capture=capture)
        rb = ResidentBatcher(train_ds, info, B, backend=be, device=DEVICE)
        preds.append(t.evaluate(t.init_state(0), rb)["prediction"])
    if not all(np.array_equal(preds[0][k], preds[1][k]) for k in preds[0]):
        raise AssertionError("vae: the captured resident evaluation differs from the eager one")
    say(f"vae: the resident evaluation runner's dict predictions (ε 0) "
        f"{ {k: v.shape for k, v in preds[1].items()} } captured bitwise equal to eager")
    return launches


def phase_engines(workdir):
    phase(15, "engines: sparse, pair, VAE")
    t_phase = time.time()
    launches = {k: 0 for k in _counted()}

    def add(name, got):
        for k, v in got.items():
            launches[k] += v
        say(f"engines {name} done at {time.time() - t_phase:.1f} s of the phase")

    reaction, numbers = sparse_reaction(workdir)
    add("sparse reaction", reaction)
    add("sparse beyond 256", sparse_beyond_256(workdir))
    add("pair", engine_pair(workdir))
    add("vae", engine_vae(workdir))
    say(f"engines phase wall {time.time() - t_phase:.1f} s; launches {launches}")
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 16: precision and explain

BF16_FLOP_PER_S = 989e12   # H100 SXM data sheet, dense bf16 on the tensor cores
BF16_STEP_RTOL = 2e-2      # GPU vs CPU bf16 step costs (tests/test_torch_precision.py)
# bf16 einsums (XLA's in kgcn_tpu, the gconv backward's here) against f32
# sums: of the result's largest magnitude (tests/test_torch_precision.py)
BF16_EINSUM_TOL = 2e-2
ONE_BF16_ROUNDING = 2.0 ** -8
# phase 3's shapes the bf16 gconv is held at (N 600 and 1024 take the split
# runs, B 70 000 the grid-stride loop of the one-launch design), and the
# reaction engine's three GraphConv calls at batch 128 (graphs padded to 256)
PRECISION_GCONV = ("path layer 1", "path layer 2", "path layer 3", "misaligned",
                   "reaction-scale", "N 600", "N 1024", "B 70 000")
ENGINE_GCONV = [("engine layer 1", (1, 128, 256, 81, 256)),
                ("engine layer 2", (1, 128, 256, 256, 256)),
                ("engine layer 3", (1, 128, 256, 256, 256))]
KG_IG_TARGETS = 2          # visualize_num of the KG visualize run
KG_IG_STEPS = 30           # ig_divide_number's default on the KG route
KG_IG_CHECK_STEPS = 5      # the GPU-vs-CPU target's steps
KG_IG_TOL = 1e-3           # of the CPU IG's largest magnitude
EMBEDDED_IG_TOL = 1e-4


def gconv_bf16_bound(C, B, N, Fin, Fout):
    """(bound_ms, bound_by) of the bf16 gconv: every input read once and
    the output written once in bf16 (2 bytes), against its FLOP at the
    bf16 tensor-core rate (what the card could do for the same work)."""
    nbytes = 2 * (C * B * N * N + B * N * Fin + C * Fin * Fout + C * Fout + B * N * Fout)
    flops = 2 * C * B * N * (Fin * Fout + N * Fout) + 2 * C * B * N * Fout
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within_one_bf16_rounding(what, operands, got):
    """The bf16 gconv output ``got`` and the plain version on ``operands``
    each within one bf16 rounding of the f64 sum (2⁻⁸ of each value, plus
    1e-5 of the largest); both bf16.  Returns max |kernel - plain|."""
    import torch

    from kgcn_tpu_torch.ops.gconv import gconv_reference

    want = gconv_reference(*operands)
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: output {got.dtype}, plain {want.dtype}")
    exact = gconv_reference(*(t.double() for t in operands))
    lim = ONE_BF16_ROUNDING * exact.abs() + 1e-5 * float(exact.abs().max())
    for name, out in (("kernel", got), ("plain", want)):
        over = float(((out.double() - exact).abs() - lim).max())
        if over > 0:
            raise AssertionError(f"{what}: the {name} is more than one bf16 rounding from "
                                 f"the f64 sum (by {over})")
    return float((got.float() - want.float()).abs().max())


def hmma_counts():
    """(HMMA instructions in the built gconv library's bf16 kernels, in its
    float32 kernels), from ``cuobjdump -sass``: the bf16 entry runs on the
    tensor cores, the float32 one (JAX's ``highest``) on FP32 FMAs."""
    from kgcn_tpu_torch.ops import _build

    lib = _build.build(["gconv"])["gconv"]
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {"bf16": 0, "float32": 0}
    kernels = {"bf16": 0, "float32": 0}
    kind = None
    for line in sass.splitlines():
        if "Function :" in line:
            kind = "bf16" if "gconv_tc_" in line or "__nv_bfloat16" in line else "float32"
            kernels[kind] += 1
        elif kind and "HMMA" in line:
            counts[kind] += 1
    if not kernels["bf16"] or not kernels["float32"]:
        raise AssertionError(f"cuobjdump found kernels {kernels} in {lib}")
    return counts, kernels


def precision_gconv_check():
    """The bf16 gconv against its plain version at ``PRECISION_GCONV`` and
    the reaction engine's call shapes (``ENGINE_GCONV``), after the count of
    its tensor-core instructions."""
    import torch

    from kgcn_tpu_torch.ops.gconv import gconv, gconv_reference

    counts, kernels = hmma_counts()
    say(f"gconv HMMA instructions (cuobjdump -sass): bf16 kernels {counts['bf16']} "
        f"(in {kernels['bf16']}), float32 kernels {counts['float32']} "
        f"(in {kernels['float32']})")
    if counts["bf16"] <= 0 or counts["float32"] != 0:
        raise AssertionError(f"gconv HMMA counts {counts}: want bf16 > 0, float32 0")
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    shapes = dict(GCONV_SHAPES + ENGINE_GCONV)
    rows = []
    for label in PRECISION_GCONV + tuple(label for label, _ in ENGINE_GCONV):
        C, B, N, Fin, Fout = shapes[label]
        bf = torch.bfloat16
        adj = (torch.rand((C, B, N, N), device=DEVICE, generator=gen) * (2.0 / N)).to(bf)
        x = torch.rand((B, N, Fin), device=DEVICE, generator=gen).to(bf)
        w = (torch.randn((C, Fin, Fout), device=DEVICE, generator=gen)
             / math.sqrt(Fin)).to(bf)
        b = (torch.randn((C, Fout), device=DEVICE, generator=gen) * 0.1).to(bf)
        got = gconv(adj, x, w, b)
        err = within_one_bf16_rounding(f"gconv bf16 {label}", (adj, x, w, b), got)
        same = float((got == gconv_reference(adj, x, w, b)).float().mean())
        if not torch.equal(got, gconv(adj, x, w, b)):
            raise AssertionError(f"gconv bf16 {label}: two launches differ")
        kernels, counted = kernels_in(lambda: gconv(adj, x, w, b), gconv)
        if counted != kernels:
            raise AssertionError(f"gconv bf16 {label}: the wrapper counted {counted} "
                                 f"kernels, torch.profiler recorded {kernels}")

        def library():
            return (torch.einsum("cbnm,bmi,cif->bnf", adj, x, w)
                    + torch.einsum("cbn,cf->bnf", adj.sum(-1), b))

        iters = 20 if B * N > 10000 else 100
        kernel_ms = device_ms(lambda: gconv(adj, x, w, b), iters)
        plain_ms = device_ms(lambda: gconv_reference(adj, x, w, b), iters)
        lib_ms = library_ms(library, iters)
        bound_ms, bound_by = gconv_bf16_bound(C, B, N, Fin, Fout)
        rows.append(dict(label=label, shape=(C, B, N, Fin, Fout), err=err,
                         kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        say(f"gconv bf16 {label:15s} C,B,N,Fin,Fout={(C, B, N, Fin, Fout)}: kernel and "
            f"plain each within one bf16 rounding of the f64 sum; max |kernel - plain| "
            f"{err:.3g} ({same:.4f} of the outputs equal); two launches bitwise equal; "
            f"{kernels} kernel(s) a call, as counted; device ms: kernel {kernel_ms:.6f} "
            f"plain {plain_ms:.6f} library {lib_ms} bound {bound_ms:.6f} ({bound_by})")
    return rows


def precision_ell_check(workdir):
    """The ELL kernel and its dx on bf16 slot weights (the batch's under
    ``"precision": "bfloat16"``) at phase 9's ring6 batch, against their
    plain versions (ELL_TOL by x's type), with their device times beside
    the float32 weights'."""
    import torch

    from kgcn_tpu_torch.ops import ell_spmm as te

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    g0 = _ring6_batch(workdir, 25).graph
    idx_c, w_c = g0.ell_senders[0], g0.ell_weights[0].to(torch.bfloat16)
    off_c, slots_c = g0.ell_transpose()
    idx, w, w32 = idx_c.to(DEVICE), w_c.to(DEVICE), g0.ell_weights[0].to(DEVICE)
    off, slots = off_c.to(DEVICE), slots_c.to(DEVICE)
    V = idx.shape[0]
    for F in (3, 50):
        for dt in ("float32", "bfloat16"):
            x = torch.randn((V, F), device=DEVICE, generator=gen).to(getattr(torch, dt))
            g = torch.randn((V, F), device=DEVICE, generator=gen).to(getattr(torch, dt))
            err = _check(f"ell_spmm bf16 weights F={F} x {dt}", te._launch(idx, w, x),
                         te.spmm_ell_reference(idx_c, w_c, x.cpu()), ELL_TOL[dt])
            dx_err = _check(f"ell dx bf16 weights F={F} g {dt}",
                            te._dx_launch(off, slots, w, g, (V, F)),
                            te.spmm_ell_dx_reference(idx_c, w_c, g.cpu(), (V, F)),
                            ELL_TOL[dt])
            t = dict(fwd=device_ms(lambda: te._launch(idx, w, x), 50),
                     fwd_f32w=device_ms(lambda: te._launch(idx, w32, x), 50),
                     dx=device_ms(lambda: te._dx_launch(off, slots, w, g, (V, F)), 50),
                     dx_f32w=device_ms(lambda: te._dx_launch(off, slots, w32, g, (V, F)), 50))
            say(f"ell bf16 weights (ring6 batch, V {V}) F={F} x {dt}: max |kernel - plain| "
                f"{err:.3g}, dx {dx_err:.3g}; device ms: forward {t['fwd']:.6f} (f32 "
                f"weights {t['fwd_f32w']:.6f}), dx {t['dx']:.6f} (f32 weights "
                f"{t['dx_f32w']:.6f})")


@contextlib.contextmanager
def float32_after():
    """The float32 matmul setting back after the block: a CLI run at
    ``"precision": "bfloat16"`` allows TF32 for the process
    (``runtime/device.set_precision``), and the float32 runs and the
    GPU-vs-CPU checks after it must not inherit that."""
    from kgcn_tpu_torch.runtime.device import set_precision

    try:
        yield
    finally:
        set_precision("float32")


def precision_train(workdir, name, src, epochs, want=(), falling=True, **over):
    """``cli.main train`` of a config at ``"precision": "bfloat16"`` under
    torch.profiler (train_run's checks: lines, files, finite and, with
    ``falling``, falling costs): the launches the profiler records (replays
    included), each kernel of ``want`` among them.  Returns (launches,
    training costs)."""
    with float32_after():
        (costs, counts, _, _, _), kernels, _, busy, wall = profiled(
            lambda: train_run(workdir, name, src, epochs, falling=falling,
                              precision="bfloat16", **over))
    got = _profiler_launches(kernels, counts)
    missing = [k for k in want if got.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"train {name}: {missing} not launched ({got})")
    say(f"-- train {name} at bf16: kernel launches in the profiler "
        f"{dict((k, v) for k, v in got.items() if v)}; device busy {busy:.3f} s of "
        f"{wall:.3f} s")
    return got, costs


@contextlib.contextmanager
def float32_products():
    """The CLI's ``set_precision`` followed by TF32 off: the bf16 cast of
    ``"precision": "bfloat16"`` with full float32 library products, where
    that value otherwise allows TF32 (JAX's ``default`` on a GPU)."""
    import torch

    from kgcn_tpu_torch.cli import main as cli
    from kgcn_tpu_torch.runtime import device

    real = cli.set_precision

    def no_tf32(precision):
        real(precision)
        device._TF32[0] = False
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cli.set_precision = no_tf32
    try:
        yield
    finally:
        cli.set_precision = real


def precision_gin(workdir):
    """GIN on ``pallas`` (ring6) at bf16 through ``cli.main train``, 2
    epochs.  Its summed CE reaches ~0.1 in the first epoch and then moves
    by spikes, and the TF32 that ``"bfloat16"`` allows moves its costs by
    1e-3 from the third step, which those spikes grow: on an H100 the
    second epoch's cost was above the first's, where the CPU's (kgcn_tpu's
    and the port's) fall.  So the run as a user makes it is held to finite
    costs, and the same run with full float32 products (the bf16 cast, the
    ELL kernel and its dx with bf16 weights, no TF32) to falling ones.
    Returns the first run's launches."""
    over = dict(dataset=ring6_file(workdir), spmm_backend="pallas")
    got, costs = precision_train(workdir, "gin_pallas_bf16", GIN_CONFIG, 2,
                                 want=("ell_spmm", "ell_spmm_dx"), falling=False, **over)
    with float32_after(), float32_products():
        exact, counts, _, _, _ = train_run(workdir, "gin_pallas_bf16_no_tf32", GIN_CONFIG, 2,
                                           precision="bfloat16", **over)
    if counts["ell_spmm"] <= 0 or counts["ell_spmm_dx"] <= 0:
        raise AssertionError(f"train gin_pallas_bf16_no_tf32: launches {counts}")
    say(f"-- gin pallas at bf16, training costs: with TF32 (as \"bfloat16\" sets it) "
        f"{costs}; with full float32 products {exact} (falling)")
    return got


def captured_numbers(label, runs, S):
    """Step wall, device busy and idle share of captured epochs, in turns
    (a, b, b, a) in one process: {name: (wall ms, busy ms, idle)} of the
    two runs' means."""
    numbers = {}
    order = list(runs) + list(runs)[::-1]
    for name in order:
        wall, _, busy, idle = epoch_numbers(runs[name], S)
        numbers.setdefault(name, []).append((wall, busy, idle))
    out = {k: tuple(sum(v[i] for v in vals) / len(vals) for i in range(3))
           for k, vals in numbers.items()}
    say(f"captured step {label} ({S} steps an epoch; means of two epochs in turns "
        f"{' '.join(order)}): " + "; ".join(
            f"{k}: wall {w:.4f} ms, device busy {b:.4f} ms, idle share {i:.4f}"
            for k, (w, b, i) in out.items()))
    return out


def precision_steps(workdir):
    """3 training steps at bf16 on the GPU and on the CPU from one seed,
    on batches spread over each dataset, costs within BF16_STEP_RTOL, with
    the GPU run's launches: the dense solubility GCN (3 bf16 gconv kernels
    a step), GIN on ``pallas`` (ring6: the ELL kernel with bf16 weights and
    its dx), GAT on ``tiled`` and the WN18RR-shaped KG (bf16 payload)."""
    for label, src, over, launches in (
            ("dense GCN at bf16", CONFIG, {}, {"gconv": 9, "gconv_bf16": 9}),
            ("GIN (pallas, ring6) at bf16", GIN_CONFIG,
             dict(dataset=ring6_file(workdir), spmm_backend="pallas"),
             {"ell_spmm": 2 * 3, "ell_spmm_dx": 3}),
            ("GAT (tiled) at bf16", GAT_CONFIG, dict(spmm_backend="tiled"),
             {"tiled_spmm": 6 * 3, "tiled_sddmm": 3 * 3})):
        cfg = _load_config(src, dropout_rate=0.0, precision="bfloat16", **over)
        steps_gpu_vs_cpu(label, cfg, 3, lambda info, want=launches: want,
                         rtol=BF16_STEP_RTOL)
    kg_gpu_vs_cpu(workdir, precision="bfloat16")


def precision_gcn_steps():
    """The dense solubility GCN at bf16: the captured resident runner
    bitwise equal to its eager steps (3 bf16 gconv launches a step), and
    the captured step's numbers at bf16 beside float32."""
    cfg = _load_config(CONFIG, dropout_rate=0.0, precision="bfloat16")
    info, rb, _, _ = _resident_setup(cfg, DEVICE)
    _, per, _ = captured_vs_eager("gcn dense bf16 (resident)", cfg, info,
                                  lambda: _resident_setup(cfg, DEVICE)[1])
    if per["gconv_bf16"] != 3 or per["gconv"] != 3:
        raise AssertionError(f"gcn dense bf16: {per} launches a step, want 3 bf16 gconv")
    runs = {}
    for name, c in (("float32", _load_config(CONFIG, dropout_rate=0.0)), ("bfloat16", cfg)):
        trainer = _trainer(c, info)
        holder = [trainer, trainer.init_state(seed=0)]

        def run(h=holder):
            h[1] = h[0].run_epoch(h[1], rb, epoch=0)[0]
        runs[name] = run
    return captured_numbers("gcn dense solubility", runs, rb.num_batches)


def precision_reaction(workdir):
    """The reaction workload (phase 15's) through ``cli.sparse train`` at
    bf16 (2 epochs: finite costs, the valid keys; the bf16 gconv in the
    profiler); the bf16 gconv at the engine's own operands (a bf16-cast
    reaction batch, ``engine_gconv_check``) and 3 streaming steps at bf16
    on the card and on the CPU (BF16_STEP_RTOL, with the card's launches);
    then its captured step at bf16 beside float32."""
    import numpy as np
    import torch

    from kgcn_tpu_torch.cli import sparse as cli_sparse
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.tfrecord import load_tfrecord_dataset
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.resident import ResidentBatcher
    from kgcn_tpu_torch.runtime.train import Trainer

    spec = REACTION
    pattern = os.path.join(workdir, "reaction", "part-*.tfrecords")  # phase 15's shards
    os.makedirs(os.path.join(workdir, "reaction_bf16"))
    cfg, path = sparse_config(workdir, "reaction_bf16", pattern, spec, precision="bfloat16")
    with float32_after():
        (out, _, counts, wall), kernels, graphs, busy, pwall = profiled(
            lambda: _cli(["train", "--config", path], cli=cli_sparse))
    got = _profiler_launches(kernels, counts)
    valid = _json(cfg["save_info_valid"])
    if got["gconv_bf16"] <= 0 or not all(math.isfinite(v) for v in valid.values()):
        raise AssertionError(f"sparse bf16 train: launches {got}, valid {valid}")
    say(f"-- cli.sparse train at bf16 (reaction, 2 epochs): {wall:.2f} s, {graphs} graph "
        f"launches, kernel launches {dict((k, v) for k, v in got.items() if v)}, valid "
        f"{valid}; device busy {busy:.3f} s of {pwall:.3f} s")
    import glob

    ds, info = load_tfrecord_dataset(sorted(glob.glob(pattern)), cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    train_ds = ds.subset(np.arange(ds.num)[np.arange(ds.num) % 5 != 0])
    B = spec["batch"]
    sb = Batcher(train_ds, info, B, seed=0, backend=be)
    batches = [sb.make_batch(np.arange(i * B, (i + 1) * B)) for i in range(3)]
    probe = Trainer(cli_sparse._model(cfg, info), cfg, info, device=DEVICE)
    first = batches[0].cast_compute(torch.bfloat16).to(DEVICE)
    engine_gconv_check("reaction bf16", probe.model, first)
    per_fwd = _forward_launches(probe.model, first)
    if per_fwd.get("gconv_bf16", 0) != per_fwd.get("gconv", 0) or not per_fwd["gconv"]:
        raise AssertionError(f"reaction bf16: a forward launched {per_fwd}")
    engine_steps_gpu_vs_cpu("reaction at bf16", cfg, info, batches, rtol=BF16_STEP_RTOL,
                            launches={k: 3 * v for k, v in per_fwd.items()})
    rb = ResidentBatcher(train_ds, info, B, seed=0, backend=be, device=DEVICE)
    runs = {}
    for name, c in (("float32", dict(cfg, precision="float32")), ("bfloat16", cfg)):
        tr = Trainer(cli_sparse._model(c, info), c, info, device=DEVICE)
        holder = [tr, tr.init_state(0)]

        def run(h=holder):
            h[1] = h[0].run_epoch(h[1], rb, epoch=0)[0]
        runs[name] = run
    return got, captured_numbers(f"reaction (batch {spec['batch']}, N 256)", runs,
                                 rb.num_batches)


def explain_kg(workdir):
    """``visualize`` on the WN18RR-shaped KG from phase 8's bf16-payload
    checkpoint: KG_IG_TARGETS targets at KG_IG_STEPS steps, the node and
    edge CSVs written (ms a target); one target's embedding IG at
    KG_IG_CHECK_STEPS steps on the card and on the CPU with the float32
    payload, within KG_IG_TOL of the CPU's largest value.  Returns the
    stream launches of the visualize run."""
    import numpy as np

    from kgcn_tpu_torch.explain.kg_ig import embedding_ig
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    ckpt = os.path.join(workdir, "kg_bf16", "model", "model.last.ckpt")
    viz = os.path.join(workdir, "kg_visualize", "viz")
    cfg, path = kg_config(workdir, "kg_visualize", load_model=ckpt, visualize_path=viz,
                          visualize_num=KG_IG_TARGETS, ig_divide_number=KG_IG_STEPS)
    out, paths, counts, wall = _cli(["visualize", "--config", path])
    files = sorted(os.listdir(viz))
    if len(paths) != 2 * KG_IG_TARGETS or sorted(map(os.path.basename, paths)) != files:
        raise AssertionError(f"kg visualize: wrote {files}, returned {paths}")
    rows = 0
    for p in paths:
        with open(p) as f:
            lines = f.read().splitlines()
        if lines[0] not in ("node,name,ig_score,is_target", "source,target,ig_score") \
                or len(lines) < 2:
            raise AssertionError(f"kg visualize: {p} holds {lines[:2]}")
        rows += len(lines) - 1
    if counts["stream_scatter_mat"] + counts["stream_scatter"] <= 0:
        raise AssertionError(f"kg visualize: launches {counts}")
    say(f"-- kg visualize ({KG_IG_TARGETS} targets, {KG_IG_STEPS} steps, phase 8's "
        f"checkpoint): {len(files)} CSVs, {rows} rows, {wall:.2f} s "
        f"({wall / KG_IG_TARGETS * 1e3:.1f} ms a target, the model's load included); "
        f"launches {dict((k, v) for k, v in counts.items() if v)}")
    cfg32, _ = kg_config(workdir, "kg_ig_f32", tiled_compute_dtype="float32")
    igs, ms = {}, {}
    for dev in (DEVICE, "cpu"):
        kb, info, _ = kg_batcher(cfg32, device=dev)
        trainer = Trainer(build_model("kg_distmult", info, cfg32), cfg32, info, device=dev)
        state = trainer.restore(ckpt)
        variables = {**state.params, **state.batch_stats}
        triples = np.asarray(kb.label_list, dtype=np.int32)[:1, :3]
        t0 = time.perf_counter()
        igs[dev] = embedding_ig(trainer.model, variables, kb.init_batch(), triples,
                                steps=KG_IG_CHECK_STEPS)
        ms[dev] = (time.perf_counter() - t0) * 1e3
    scale = float(np.abs(igs["cpu"]).max())
    gap = float(np.abs(igs[DEVICE] - igs["cpu"]).max())
    say(f"kg embedding IG ({KG_IG_CHECK_STEPS} steps, one target, f32 payload) GPU vs "
        f"CPU: max |diff| {gap:.3g} of max |IG| {scale:.3g} (limit {KG_IG_TOL} of it); "
        f"{ms[DEVICE]:.1f} ms on the card, {ms['cpu']:.1f} ms on the CPU")
    if not scale > 0 or gap > KG_IG_TOL * scale:
        raise AssertionError(f"kg embedding IG: GPU and CPU differ by {gap} of {scale}")
    return counts


def explain_embedded():
    """``embedded_layer_ig`` of multimodal.json's model on one compound of
    example_jbl/multimodal.jbl, weights drawn on the CPU from seed 0, on the
    card and on the CPU: the embedded layer, its IG and the check within
    EMBEDDED_IG_TOL.  Returns its gconv launches."""
    import numpy as np

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.explain.ig import embedded_layer_ig
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg = _load_config(MULTIMODAL_CONFIG, dropout_rate=0.0)
    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    batch = Batcher(ds, info, 1, backend=be).make_batch(np.arange(1))
    res, ms = {}, {}
    for dev in (DEVICE, "cpu"):
        tr = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info, device=dev)
        state = tr.init_state(seed=0)
        _zero_counts()
        t0 = time.perf_counter()
        res[dev] = embedded_layer_ig(tr.model, {**state.params, **state.batch_stats},
                                     batch.to(dev), steps=100)
        ms[dev] = (time.perf_counter() - t0) * 1e3
        if dev == DEVICE:
            counts = _counts()
    (ge, gig, gc), (ce, cig, cc) = res[DEVICE], res["cpu"]
    gaps = [float(np.abs(ge - ce).max()), float(np.abs(gig - cig).max()),
            abs(gc["check_score"] - cc["check_score"])]
    # the check is a difference of two probabilities: held on the scale of 1
    scales = [float(np.abs(ce).max()), float(np.abs(cig).max()), 1.0]
    say(f"embedded_layer_ig (multimodal.json, 100 steps) GPU vs CPU: max |diff| embedded "
        f"{gaps[0]:.3g}, IG {gaps[1]:.3g} (of {scales[1]:.3g}), check {gaps[2]:.3g}; "
        f"sum_of_IG {gc['sum_of_IG']:.5f} vs F(emb) - F(0) {gc['check_score']:.5f}; "
        f"{ms[DEVICE]:.1f} ms on the card, {ms['cpu']:.1f} ms on the CPU; launches "
        f"{dict((k, v) for k, v in counts.items() if v)}")
    if not scales[1] > 0 or any(g > EMBEDDED_IG_TOL * s for g, s in zip(gaps, scales)):
        raise AssertionError(f"embedded_layer_ig: GPU and CPU differ by {gaps}")
    if counts["gconv"] <= 0:
        raise AssertionError(f"embedded_layer_ig launched {counts}")
    return counts


def explain_gcnv(workdir):
    """``python -m kgcn_tpu_torch.cli.gcnv`` on an IG dump: the heatmaps
    where matplotlib is installed, else ``ImportError`` as ``make_plot``
    raises (phase 12)."""
    import importlib.util

    import numpy as np

    from kgcn_tpu_torch.cli import gcnv

    rng = np.random.RandomState(0)
    dump = os.path.join(workdir, "gcnv", "mol_00000_max.jbl")
    os.makedirs(os.path.dirname(dump))
    with open(dump, "wb") as f:
        pickle.dump({"features": rng.rand(6, 3), "features_IG": rng.randn(6, 3),
                     "adjs": rng.rand(6, 6), "adjs_IG": rng.randn(6, 6),
                     "check_score": 0.5, "sum_of_IG": 0.48}, f, protocol=4)
    if importlib.util.find_spec("matplotlib") is None:
        try:
            gcnv.main([dump])
        except ImportError as e:
            say(f"gcnv: matplotlib is not installed here: ImportError ({e}), as make_plot "
                "raises; the rendered files are checked on the CPU "
                "(tests/test_torch_gcnv.py)")
            return
        raise AssertionError("gcnv rendered without matplotlib")
    gcnv.main([dump])
    made = sorted(f for f in os.listdir(os.path.dirname(dump)) if f.endswith(".png"))
    if len(made) != 4:
        raise AssertionError(f"gcnv wrote {made}")
    say(f"gcnv: {made}")


def phase_in_child(flag, workdir, timeout=900, ranks=None):
    """A phase in a process of its own (``python3 chip_smoke.py FLAG
    WORKDIR``, ``child_main``) on this card and ``workdir``: a fresh CUDA
    context.  In a process that has run phases 3-15, torch.profiler has
    been seen to record no kernel at all (on an H100: 0 of 3 matmuls in a
    window after phase 15, 1 of 3 after phase 8), and phases 16 and 17 read
    launch counts from it.  The child writes its results to
    ``workdir/<flag>.json``; it is waited for, and killed at ``timeout``.
    Returns those results.  ``ranks``: the child is started as that many
    ranks of ``kgcn-torch-launch`` (one GPU a rank, NCCL)."""
    out = os.path.join(workdir, f"{flag.strip('-')}.json")
    sys.stdout.flush()
    launcher = [] if ranks is None else [
        sys.executable, "-m", "kgcn_tpu_torch.parallel.launch", "--nprocs", str(ranks), "--"]
    proc = subprocess.run(launcher + [sys.executable, os.path.abspath(__file__), flag,
                                      workdir], timeout=timeout, cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"{flag} exited with code {proc.returncode}")
    with open(out) as f:
        return json.load(f)


def phase_precision_process(workdir, timeout=900):
    """Phase 16 in a process of its own (``phase_in_child``), on phase 8's KG
    and checkpoint and phase 15's reaction shards in ``workdir``.  Returns
    (bf16 gconv rows, launches)."""
    res = phase_in_child("--phase16", workdir, timeout)
    return res["rows"], res["launches"]


def child_main(flag, workdir):
    """The child of ``phase_in_child``: phase 16, 17, 18, 19 or 20 on
    ``workdir``."""
    import torch

    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false")
        sys.exit(2)
    if flag in ("--phase19", "--phase20"):
        from kgcn_tpu_torch.parallel import mesh as pmesh
        from kgcn_tpu_torch.parallel.launch import initialize_from_env

        if not initialize_from_env(cpu=False):
            raise AssertionError(f"{flag} runs as a rank of kgcn-torch-launch")
        run = phase_parallel if flag == "--phase19" else phase_parallel_models
        launches, numbers = run(workdir)
        with open(os.path.join(workdir, f"{flag.strip('-')}.json"), "w") as f:
            json.dump({"launches": launches, "numbers": numbers}, f)
        pmesh.finalize()
        return
    if flag == "--phase16":
        rows, launches = phase_precision(workdir)
        res = {"rows": rows, "launches": launches}
    elif flag == "--phase17":
        res = {"launches": phase_chemistry(workdir)}
    else:
        res = {"launches": phase_tools(workdir)}
    with open(os.path.join(workdir, f"{flag.strip('-')}.json"), "w") as f:
        json.dump(res, f)


def phase_precision(workdir):
    phase(16, "precision and explain: bf16 and the rest of visualize")
    t_phase = time.time()
    launches = {k: 0 for k in _counted()}

    def add(name, got):
        for k, v in got.items():
            launches[k] += v
        say(f"precision {name} done at {time.time() - t_phase:.1f} s of the phase")

    rows = precision_gconv_check()
    precision_ell_check(workdir)
    say(f"precision kernel checks done at {time.time() - t_phase:.1f} s of the phase")
    got, _ = precision_train(workdir, "gcn_dense_bf16", CONFIG, 2, want=("gconv_bf16",))
    add("gcn dense", got)
    add("gin pallas", precision_gin(workdir))
    got, _ = precision_train(workdir, "gat_tiled_bf16", GAT_CONFIG, 2,
                             want=("tiled_spmm", "tiled_sddmm"), spmm_backend="tiled")
    add("gat tiled", got)
    with float32_after():
        got, _, _ = kg_run(workdir, "kg_precision_bf16", precision="bfloat16", epoch=1)
    add("kg", got)
    precision_steps(workdir)
    say(f"precision GPU-vs-CPU steps done at {time.time() - t_phase:.1f} s of the phase")
    gcn_numbers = precision_gcn_steps()
    got, reaction_numbers = precision_reaction(workdir)
    add("reaction", got)
    add("kg visualize", explain_kg(workdir))
    add("embedded IG", explain_embedded())
    explain_gcnv(workdir)
    say(f"precision phase wall {time.time() - t_phase:.1f} s; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}; captured steps: gcn "
        f"{gcn_numbers}, reaction {reaction_numbers}")
    return rows, launches


# ---------------------------------------------------------------------------
# phase 17: chemistry — the port makes a dataset, and trains on it

CHEM_MOLECULES = 2048     # seeded SMILES (make_smiles)
CHEM_SDF_MOLECULES = 256  # the first ones, written as a V2000 SDF
CHEM_ATOM_LIMIT = 64      # --atom-num-limit: the largest molecule has 60 heavy atoms
CHEM_HEAVY = (10, 60)     # heavy atoms a molecule
CHEM_FOLDS = 5
CHEM_TASKS = 4            # assay CSV tasks
CHEM_BLANK = 0.2          # share of blank assay cells
# (SMILES, heavy atoms) pieces: a chain atom, optionally with branches; a
# terminal substituent; rings (5-7 atoms, aromatic and not, a fused
# bicycle), each closing its own ring bonds (digits 1 and 2 are free again
# after each piece); "{r}"/"{s}" are the ring-bond digits
_CHAIN = (("C", 1), ("C", 1), ("C", 1), ("CC", 2), ("N", 1), ("O", 1), ("S", 1),
          ("C=C", 2), ("C#C", 2), ("[NH2+]", 1), ("C(=O)", 2), ("C(=O)N", 3),
          ("N(C)", 2), ("C(C)(C)", 3))
_SUBSTITUENT = (("F", 1), ("Cl", 1), ("Br", 1), ("I", 1), ("O", 1), ("N", 1), ("C", 1),
                ("C(F)(F)F", 4), ("C#N", 2), ("C(=O)O", 3), ("C(=O)[O-]", 3),
                ("[N+](=O)[O-]", 3), ("[NH3+]", 1), ("OC", 2), ("S(=O)(=O)C", 4),
                ("C=O", 2), ("SC", 2))
_RINGS = (("c1ccccc1", 6), ("c1ccncc1", 6), ("c1cc[nH]c1", 5), ("c1ccoc1", 5),
          ("c1ccsc1", 5), ("C1CCCC1", 5), ("C1CCCCC1", 6), ("C1CCCCCC1", 7),
          ("C1CC=CCC1", 6), ("C1CCNCC1", 6), ("C1COCCN1", 6), ("c1ccc2ccccc2c1", 10),
          ("c1ccc2[nH]ccc2c1", 9), ("C1=CC=CC=C1", 6))
# pieces whose last atom (an sp3 C, or an amine N) takes one more branch
_BRANCHABLE = ("C", "CC", "N", "C1CCCC1", "C1CCCCC1", "C1CCCCCC1", "C1CC=CCC1",
               "C1CCNCC1")
_SALTS = (".[Na+]", ".[Cl-]", ".Cl", ".[K+]")


def make_smiles(n, seed=0):
    """``n`` drug-like SMILES drawn from ``seed``, each of CHEM_HEAVY heavy
    atoms: a backbone of chain atoms (C, N, O, S; double and triple bonds;
    charged bracket atoms with explicit H), branches of halogens and small
    groups, rings of 5-7 atoms (benzene, pyridine, pyrrole ``[nH]``, furan,
    thiophene, saturated and partly saturated rings, a Kekulé benzene) and
    fused bicycles (naphthalene, indole), and about 1 in 25 a salt (a
    ``.``-joined counter-ion).  Every one lies in the SMILES subset that
    ``data/molparse`` parses."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        target = int(rng.randint(CHEM_HEAVY[0], CHEM_HEAVY[1] + 1))
        parts, atoms = [], 0
        while True:
            u = rng.rand()
            if u < 0.5 or not parts:
                piece, k = _CHAIN[rng.randint(len(_CHAIN))]
            elif u < 0.75:
                piece, k = _RINGS[rng.randint(len(_RINGS))]
            elif parts[-1] in _BRANCHABLE:
                piece, k = _SUBSTITUENT[rng.randint(len(_SUBSTITUENT))]
                piece = f"({piece})"
            else:
                continue
            if atoms + k > CHEM_HEAVY[1] - 1:
                break
            parts.append(piece)
            atoms += k
            if atoms >= target:
                break
        if atoms < CHEM_HEAVY[0]:
            continue
        smi = "".join(parts)
        if smi.endswith((")", "[NH2+]")):   # end on an atom with its valence
            smi += "C"
            atoms += 1
        if rng.rand() < 0.04:
            smi += _SALTS[rng.randint(len(_SALTS))]
            atoms += 1
        if not CHEM_HEAVY[0] <= atoms <= CHEM_HEAVY[1]:
            continue
        out.append(smi)
    return out


def smiles_labels(smiles):
    """(one-hot class labels [M, 2]: a halogen among the atoms or not, an
    assay matrix [M, CHEM_TASKS] of 0/1: halogen, aromatic ring, charged
    atom, more than 30 heavy atoms), from the molecules themselves."""
    import numpy as np

    from kgcn_tpu_torch.data import molparse

    tasks = []
    for smi in smiles:
        mol = molparse.parse_smiles(smi)
        syms = {a.GetSymbol() for a in mol.GetAtoms()}
        tasks.append([bool(syms & {"F", "Cl", "Br", "I"}),
                      any(a.GetIsAromatic() for a in mol.GetAtoms()),
                      any(a.GetFormalCharge() for a in mol.GetAtoms()),
                      mol.GetNumAtoms() > 30])
    tasks = np.asarray(tasks, np.int64)
    return np.eye(2, dtype=np.int64)[tasks[:, 0]], tasks


def write_sdf(path, mols):
    """A V2000 SDF of molparse molecules: atoms at the origin, charges in
    ``M  CHG`` lines, bond types 1-3 and 4 (aromatic), the SMILES as the
    record's name."""
    lines = []
    for m in mols:
        lines += [m.name, "  kgcn_tpu_torch chip_smoke", "",
                  f"{len(m.atoms):3d}{len(m.bonds):3d}" + "  0" * 8 + "999 V2000"]
        lines += [f"{0.0:10.4f}{0.0:10.4f}{0.0:10.4f} {a.symbol:<3} 0  0  0  0  0  0"
                  for a in m.atoms]
        lines += [f"{i + 1:3d}{j + 1:3d}{4 if o == 12 else o:3d}  0" for i, j, o in m.bonds]
        charged = [(i + 1, a.charge) for i, a in enumerate(m.atoms) if a.charge]
        for k in range(0, len(charged), 8):
            chunk = charged[k:k + 8]
            lines.append(f"M  CHG{len(chunk):3d}" + "".join(f"{i:4d}{c:4d}" for i, c in chunk))
        lines += ["M  END", "$$$$"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def chem_files(workdir):
    """The phase's inputs in ``workdir/chem``: CHEM_MOLECULES SMILES
    (``mols.smi``), their class labels (``labels.txt``, one-hot rows), an
    assay CSV of CHEM_TASKS tasks with CHEM_BLANK of the cells blank
    (``assay.csv``), and the first CHEM_SDF_MOLECULES as a V2000 SDF
    (``mols.sdf``) with their labels as a headerless CSV (``sdf_labels.csv``,
    KNIME's label file).  Returns (directory, SMILES, labels, assay)."""
    import numpy as np

    from kgcn_tpu_torch.data import molparse

    d = os.path.join(workdir, "chem")
    os.makedirs(d, exist_ok=True)
    smiles = make_smiles(CHEM_MOLECULES)
    labels, tasks = smiles_labels(smiles)
    blank = np.random.RandomState(1).rand(*tasks.shape) < CHEM_BLANK
    with open(os.path.join(d, "mols.smi"), "w") as f:
        f.write("\n".join(smiles) + "\n")
    for name, rows in (("labels.txt", labels), ("sdf_labels.csv", labels[:CHEM_SDF_MOLECULES])):
        with open(os.path.join(d, name), "w") as f:
            f.write("".join(",".join(str(int(v)) for v in r) + "\n" for r in rows))
    with open(os.path.join(d, "assay.csv"), "w") as f:
        f.write("smiles," + ",".join(f"task{t}" for t in range(CHEM_TASKS)) + "\n")
        for smi, row, gaps in zip(smiles, tasks, blank):
            f.write(smi + "," + ",".join("" if g else str(int(v))
                                         for v, g in zip(row, gaps)) + "\n")
    write_sdf(os.path.join(d, "mols.sdf"),
              [molparse.parse_smiles(smi) for smi in smiles[:CHEM_SDF_MOLECULES]])
    return d, smiles, labels, np.where(blank, np.nan, tasks)


def _chem(argv, module="chem"):
    """``python -m kgcn_tpu_torch.cli.<module>`` in this process: (stdout,
    wall seconds)."""
    import importlib

    cli = importlib.import_module(f"kgcn_tpu_torch.cli.{module}")
    out, _, counts, wall = _cli(argv, cli=cli)
    if any(counts.values()):
        raise AssertionError(f"cli.{module} launched kernels: {counts}")
    return out, wall


def _check_chem_dataset(data, n, with_fp=True):
    """The dataset dict ``cli.chem`` writes: n molecules, features [n, 64,
    81] of the padded limit, COO triples of the true atom count, the int64
    limit, the port's Molecule objects in ``mol_info``."""
    import numpy as np

    from kgcn_tpu_torch.data import molparse

    if data["feature"].shape != (n, CHEM_ATOM_LIMIT, 81) or len(data["adj"]) != n:
        raise AssertionError(f"chem dataset: feature {data['feature'].shape}, "
                             f"{len(data['adj'])} adjacencies; want {n} molecules")
    if not isinstance(data["max_node_num"], np.int64) or data["max_node_num"] != CHEM_ATOM_LIMIT:
        raise AssertionError(f"chem dataset: max_node_num {data['max_node_num']!r}")
    mols = data["mol_info"]["obj_list"]
    if len(mols) != n or not all(type(m) is molparse.Molecule for m in mols):
        raise AssertionError("chem dataset: mol_info does not hold the port's Molecules")
    for m, (idx, val, shape) in zip(mols, data["adj"]):
        if shape != (m.GetNumAtoms(),) * 2 or idx.dtype != np.int32 or val.dtype != np.float32:
            raise AssertionError(f"chem dataset: adjacency {shape}, {idx.dtype}, {val.dtype}")
    if with_fp and data["chemical_fp"].shape != (n, 2048):
        raise AssertionError(f"chem dataset: chemical_fp {data['chemical_fp'].shape}")


def chem_sdf_route(d, data):
    """``cli.chem --sdf`` on the first CHEM_SDF_MOLECULES: adjacencies equal
    to the SMILES route's, features equal but on the atoms a SMILES bracket
    gives explicit hydrogens (``[nH]``, ``[NH2+]``, ``[NH3+]``): V2000 keeps
    no hydrogen count, so molparse derives them from the valence there, and
    only those atoms' implicit-valence and hydrogen-count one-hots (the JAX
    package's molparse gives the same on both routes) may differ."""
    import numpy as np

    from kgcn_tpu_torch.data import featurizer as fz
    from kgcn_tpu_torch.data import jbl

    n = CHEM_SDF_MOLECULES
    out, wall = _chem(["--sdf", os.path.join(d, "mols.sdf"), "--atom-num-limit",
                       str(CHEM_ATOM_LIMIT), "-o", os.path.join(d, "sdf.jbl")])
    sdf = jbl.load(os.path.join(d, "sdf.jbl"))
    _check_chem_dataset(sdf, n, with_fp=False)
    t = len(fz.ATOM_LIST) + fz.DEGREE_DIM
    may_differ = np.zeros(81, bool)
    may_differ[t:t + len(fz.VALENCE_SET)] = True
    may_differ[-len(fz.NUM_H_SET):] = True
    exact = bracket_atoms = 0
    for i in range(n):
        a, b = data["adj"][i], sdf["adj"][i]
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]):
            raise AssertionError(f"SDF route: molecule {i}'s adjacency differs")
        explicit = np.asarray([at.explicit_h is not None and at.explicit_h > 0
                               for at in data["mol_info"]["obj_list"][i].GetAtoms()])
        diff = data["feature"][i] != sdf["feature"][i]
        rows = diff.any(1)
        if rows[:len(explicit)][~explicit].any() or rows[len(explicit):].any() or \
                diff[:, ~may_differ].any():
            raise AssertionError(f"SDF route: molecule {i}'s features differ beyond the "
                                 "hydrogen slots of its bracket atoms")
        exact += not rows.any()
        bracket_atoms += int(rows.sum())
    say(f"-- chem --sdf ({n} molecules, {wall:.2f} s): adjacencies equal to the SMILES "
        f"route's; features equal on {exact} molecules, the rest differ only in the "
        f"valence and hydrogen one-hots of {bracket_atoms} bracket-H atoms")


def chem_assay_route(d, assay):
    """``cli.chem --assay-csv --pseudo-negative``: the label matrix with its
    blanks masked, and the pseudo negatives the run reports unmasked."""
    import re

    import numpy as np

    from kgcn_tpu_torch.data import jbl

    out, wall = _chem(["--assay-csv", os.path.join(d, "assay.csv"), "--atom-num-limit",
                       str(CHEM_ATOM_LIMIT), "--pseudo-negative", "-o",
                       os.path.join(d, "assay.jbl")])
    data = jbl.load(os.path.join(d, "assay.jbl"))
    added = int(re.search(r"pseudo negative count: (\d+)", out).group(1))
    mask = data["mask_label"]
    known = ~np.isnan(assay)
    if (data["label"].shape != assay.shape or mask.dtype != np.int64
            or int(mask.sum()) != int(known.sum()) + added
            or not (mask[known] == 1).all()
            or not (data["label"][known] == assay[known]).all()):
        raise AssertionError(f"assay route: labels {data['label'].shape}, mask "
                             f"{mask.dtype} sum {int(mask.sum())}, {added} added")
    say(f"-- chem --assay-csv --pseudo-negative ({len(assay)} molecules, {CHEM_TASKS} "
        f"tasks, {int((~known).sum())} blank cells, {wall:.2f} s): {added} pseudo "
        "negatives unmasked; the known cells kept")


def chem_tfrecord_route(d, data):
    """``cli.chem --tfrecords``, read back by the host parser: the same
    features (cut to each molecule's atoms), adjacencies and labels."""
    import numpy as np

    from kgcn_tpu_torch.data.tfrecord import load_tfrecord_dataset

    path = os.path.join(d, "chem.tfrecords")
    _, wall = _chem(["--smiles", os.path.join(d, "mols.smi"), "--label",
                     os.path.join(d, "labels.txt"), "--atom-num-limit", str(CHEM_ATOM_LIMIT),
                     "--tfrecords", "-o", path])
    ds, _ = load_tfrecord_dataset([path])
    n = len(data["adj"])
    sizes = np.asarray([a[2][0] for a in data["adj"]])
    if ds.num != n or not np.array_equal(ds.enabled_node_nums, sizes) or \
            not np.array_equal(ds.labels, data["label"]):
        raise AssertionError(f"tfrecord route: {ds.num} records")
    for i in range(n):
        k = sizes[i]
        if not np.array_equal(ds.features[i, :k], data["feature"][i, :k]):
            raise AssertionError(f"tfrecord route: molecule {i}'s features differ")
    say(f"-- chem --tfrecords ({n} records, {wall:.2f} s): read back by the host parser, "
        "features, sizes and labels equal to the .jbl's")


def chem_tools(d, data):
    """``chem_summary`` on the SMILES and on the dataset; ``cv_splitter``
    into CHEM_FOLDS folds (the folds of ``kfold_indices``); ``data_join``
    of fold 0's train and test files: the dataset back, row for row in
    fold order."""
    import numpy as np

    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.dataset import kfold_indices

    src = os.path.join(d, "chem.jbl")
    out, _ = _chem(["-p", os.path.join(d, "mols.smi")], "chem_summary")
    if "Histgram (atom number)" not in out or f"Dataset size: {CHEM_MOLECULES}" not in out:
        raise AssertionError("chem_summary on the SMILES: " + out[-500:])
    out, _ = _chem(["-p", src], "chem_summary")
    if f"Max node number: {CHEM_ATOM_LIMIT}" not in out or "Feature dim: 81" not in out:
        raise AssertionError("chem_summary on the dataset: " + out[-500:])
    folds = os.path.join(d, "folds")
    _, split_s = _chem(["--input", src, "--output-dir", folds, "--fold", str(CHEM_FOLDS)],
                       "cv_splitter")
    joined = os.path.join(d, "joined.jbl")
    _, join_s = _chem(["--input", os.path.join(folds, "chem.fold0.train.jbl"),
                       os.path.join(folds, "chem.fold0.test.jbl"), "--output", joined],
                      "data_join")
    train_idx, test_idx = kfold_indices(len(data["adj"]), CHEM_FOLDS)[0]
    order = np.concatenate([train_idx, test_idx])
    back = jbl.load(joined)
    for key in ("feature", "label", "chemical_fp"):
        if not np.array_equal(back[key], data[key][order]):
            raise AssertionError(f"data_join of fold 0: {key} differs")
    for i, j in enumerate(order):
        a, b = back["adj"][i], data["adj"][j]
        if not (np.array_equal(a[0], b[0]) and a[2] == b[2]) or \
                back["mol_info"]["obj_list"][i].__getstate__() != \
                data["mol_info"]["obj_list"][j].__getstate__():
            raise AssertionError(f"data_join of fold 0: row {i} differs")
    say(f"-- chem_summary on the SMILES and the dataset; cv_splitter: {CHEM_FOLDS} folds "
        f"({split_s:.2f} s); data_join of fold 0's train and test ({join_s:.2f} s): the "
        "dataset row for row in fold order")


def chem_first_gconv_shape(cfg):
    """The (C, B, N, Fin, Fout) of the first gconv call of one forward of
    the config's model on its first training batch."""
    from kgcn_tpu_torch.nn import layers

    info, (batch,) = _trainer_batches(cfg, 1)
    trainer = _trainer(cfg, info)
    state = trainer.init_state(seed=0)
    calls = _recorded(layers, "gconv", lambda: trainer.eval_step(
        state.params, state.batch_stats, batch))
    adj, x, w, _ = calls[0][0]
    return (int(adj.shape[0]), int(adj.shape[1]), int(adj.shape[2]), int(w.shape[1]),
            int(w.shape[2]))


def chem_knime(d, data, workdir, per_forward):
    """The KNIME nodes' helpers on the SDF: prep_mol_info → prep_adj →
    prep_feat → prep_label → prep_dataset → clean_dataset; its features
    equal ``cli.chem``'s of the same molecules; then one epoch of
    ``cli.main train`` (streaming: exactly ``per_forward`` gconv kernels a
    step and an evaluated batch).  Returns the run's launches."""
    import numpy as np

    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.knime import helpers as H

    k = os.path.join(d, "knime")
    os.makedirs(k, exist_ok=True)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        H.prep_mol_info(os.path.join(d, "mols.sdf"), CHEM_ATOM_LIMIT,
                        os.path.join(k, "mol_info.jbl"))
        H.prep_adj(os.path.join(k, "mol_info.jbl"), os.path.join(k, "adjacent.jbl"))
        H.prep_feat(os.path.join(k, "mol_info.jbl"), os.path.join(k, "atom_feature.jbl"))
        H.prep_label(os.path.join(d, "sdf_labels.csv"), os.path.join(k, "label.jbl"))
        H.prep_dataset(os.path.join(k, "label.jbl"), os.path.join(k, "adjacent.jbl"),
                       os.path.join(k, "atom_feature.jbl"), os.path.join(k, "dataset.jbl"))
        H.clean_dataset(os.path.join(k, "dataset.jbl"), os.path.join(k, "clean.jbl"))
    prep_s = time.time() - t0
    knime = jbl.load(os.path.join(k, "clean.jbl"))
    sdf = jbl.load(os.path.join(d, "sdf.jbl"))
    if not np.array_equal(np.asarray(knime["feature"], np.float32), sdf["feature"]):
        raise AssertionError("KNIME route: features differ from cli.chem's")
    costs, counts, steps, evals, _ = train_run(
        workdir, "chem_knime", CONFIG, 1, falling=False, device_resident=False,
        dataset=os.path.join(k, "clean.jbl"))
    _expect("train chem_knime", counts, {"gconv": per_forward * (steps + evals)})
    say(f"-- KNIME route ({CHEM_SDF_MOLECULES} molecules of the SDF, helpers {prep_s:.2f} "
        f"s): features equal to cli.chem's; 1 epoch of cli.main train, cost {costs[0]:.6g}")
    return counts


def phase_chemistry(workdir):
    """Phase 17: the port makes a dataset, and trains on it."""
    import numpy as np

    from kgcn_tpu_torch.data import jbl

    phase(17, "chemistry: cli.chem makes a dataset of seeded molecules, cli.main trains on it")
    t_phase = time.time()
    launches = {k: 0 for k in _counted()}
    t0 = time.time()
    d, smiles, labels, assay = chem_files(workdir)
    say(f"-- {len(smiles)} seeded SMILES of {CHEM_HEAVY[0]}-{CHEM_HEAVY[1]} heavy atoms, "
        f"{sum('.' in s for s in smiles)} salts, class 1 (a halogen) "
        f"{int(labels[:, 1].sum())}; files written in {time.time() - t0:.2f} s")
    src = os.path.join(d, "chem.jbl")
    _, wall = _chem(["--smiles", os.path.join(d, "mols.smi"), "--label",
                     os.path.join(d, "labels.txt"), "--atom-num-limit", str(CHEM_ATOM_LIMIT),
                     "--morgan-fingerprint", "-o", src])
    data = jbl.load(src)
    _check_chem_dataset(data, len(smiles))
    if not np.array_equal(data["label"], labels):
        raise AssertionError("chem dataset: labels differ from the label file")
    say(f"-- chem --smiles --label --morgan-fingerprint: {len(smiles)} molecules in "
        f"{wall:.2f} s, {len(smiles) / wall:.1f} molecules/s on the host")
    chem_sdf_route(d, data)
    chem_assay_route(d, assay)
    chem_tfrecord_route(d, data)
    chem_tools(d, data)
    say(f"chemistry preprocessing done at {time.time() - t_phase:.1f} s of the phase")

    cfg = _load_config(CONFIG, dataset=src)
    shape = chem_first_gconv_shape(cfg)
    if shape != dict(GCONV_SHAPES)["chem layer 1"]:
        raise AssertionError(f"the first GraphConv on the chem dataset is {shape}, phase 3 "
                             f"checked {dict(GCONV_SHAPES)['chem layer 1']}")
    # layer 1 (N 64, Fin 81) is beyond the one-launch design's shared memory:
    # the projection and the aggregation, two launches; layers 2 and 3 one
    per = gconv_kernels_a_forward(cfg)
    for k, v in resident_cli(workdir, "chem_gcn", CONFIG, 2, {"gconv": per}, {"gconv": per},
                             dataset=src).items():
        launches[k] += v
    gpu, counts, _, _, _ = train_run(workdir, "chem_gcn_gpu", CONFIG, 1, falling=False,
                                     dataset=src, dropout_rate=0.0)
    cpu, _, _, _, _ = train_run(workdir, "chem_gcn_cpu", CONFIG, 1, cpu=True, falling=False,
                                dataset=src, dropout_rate=0.0)
    rel = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    say(f"GPU vs CPU chem GCN (dropout 0) first epoch: {gpu[0]} vs {cpu[0]}, relative "
        f"difference {rel:.3e} (limit {TRAJECTORY_RTOL})")
    if rel > TRAJECTORY_RTOL:
        raise AssertionError(f"GPU and CPU chem GCN epochs differ by {rel}")
    info, rb, _, _ = _resident_setup(cfg, DEVICE)
    trainer = _trainer(cfg, info)
    holder = [trainer.init_state(seed=0)]

    def run():
        holder[0] = trainer.run_epoch(holder[0], rb, epoch=0)[0]
    wall, pwall, busy, idle = epoch_numbers(run, rb.num_batches)
    say(f"chem GCN captured epoch ({rb.num_batches} steps): step wall ms {wall:.4f} "
        f"(profiled {pwall:.4f}), epoch ms {wall * rb.num_batches:.3f}, device busy "
        f"ms/step {busy:.4f}, idle share {idle:.4f}")
    for k, v in chem_knime(d, data, workdir, per).items():
        launches[k] += v
    say(f"chemistry phase wall {time.time() - t_phase:.1f} s; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    return launches


# phase 18: the tools (HPO, NAS, graph kernels, active learning, timing) and
# export on the tiled, stream and ELL backends

HPO_DOMAIN = [{"name": "learning_rate", "type": "continuous", "domain": [1e-4, 1e-2]},
              {"name": "batch_size", "type": "discrete", "domain": [16, 32],
               "data_type": "int"}]
HPO_SEED = 4        # its bootstrap: batch 32 first (the domain's widest), then 32, 16
HPO_TRIALS = 4
HPO_EPOCHS = 2
HPO_MEMORY_SLACK = 0.05   # trial 4's peak device memory against trial 1's
NAS_SEED = 8        # its first bootstrap candidate: 4 GraphConv of 128, BN, tanh
NAS_CANDIDATES = 3
NAS_EPOCHS = 2
AL_POOL = 1536      # of the chem dataset's 2 048 molecules; the rest is the test set
AL_LOOP = dict(estimator_name="svc", strategy="entropy", initial=10, batch=10,
               iterations=10, seed=0)
EXPORT_TOL = 1e-5   # the exported program against the Predictor, on the card
EXPORT_CPU_TOL = 1e-4  # the card's answers against the same artifact run on the CPU
EXPORT_GRAPHS = 16  # graphs a request
# (label, config, overrides, the kernel the exported program launches); the
# float32 payload, so the dense float32 Predictor is the yardstick
EXPORT_RUNS = (
    ("gcn tiled ring700", GCN_RING_CONFIG,
     dict(spmm_backend="tiled", tiled_compute_dtype="float32"), "tiled_spmm"),
    ("gcn stream ring700 (batch 1)", GCN_RING_CONFIG,
     dict(spmm_backend="stream", tiled_compute_dtype="float32", batch_size=1),
     "stream_scatter"),
    ("gin pallas ring6", GIN_CONFIG, dict(spmm_backend="pallas"), "ell_spmm"),
)


def _peaks(out):
    """The per-trial peak device memory lines ``cli.opt`` prints, in bytes."""
    import re

    return [int(m) for m in re.findall(r"\[opt\] trial peak device memory: (\d+) bytes", out)]


def tools_hpo(workdir):
    """``kgcn_tpu_torch.cli.opt`` on solubility_cls.json at full width
    (dropout 0, HPO_EPOCHS epochs a trial, HPO_TRIALS trials over
    HPO_DOMAIN): finite values, gconv launched in every trial (the first
    and the last trial under torch.profiler, which also counts the
    replayed steps; the others by the wrapper's count, the warm-up steps
    and the captures: a profiler window costs seconds), the peak device
    memory not growing trial after trial, and trial 0 within
    TRAJECTORY_RTOL of the same trial on this machine's CPU.  Returns the
    gconv launches (the profiler's, and the wrapper's for the others)."""
    from kgcn_tpu_torch.cli import opt
    from kgcn_tpu_torch.runtime.config import load_config

    _, path = _write_config(workdir, "hpo", CONFIG, epoch=HPO_EPOCHS, dropout_rate=0.0,
                            save_interval=0, make_plot=False)
    dom = os.path.join(workdir, "hpo", "domain.json")
    with open(dom, "w") as f:
        json.dump(HPO_DOMAIN, f)
    per_trial = []
    run_trial = opt.run_trial

    def counted_trial(base, params, device=None):
        if len(per_trial) in (0, HPO_TRIALS - 1):
            # CUDA activity alone: the CPU's records would cost the window seconds
            value, kernels, _, busy, wall = profiled(
                lambda: run_trial(base, params, device), cpu=False)
            per_trial.append(("profiler", kernels["gconv"], f"device busy {busy:.3f} s of "
                              f"{wall:.2f} s"))
        else:
            _zero_counts()
            t0 = time.perf_counter()
            value = run_trial(base, params, device)
            per_trial.append(("wrapper", _counts()["gconv"],
                              f"{time.perf_counter() - t0:.2f} s"))
        return value

    tee = _Tee(sys.stdout)
    out_dir = os.path.join(workdir, "hpo", "out")
    opt.run_trial = counted_trial
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(tee):
            opt.main(["--config", path, "--domain", dom, "--max-itr", str(HPO_TRIALS),
                      "--seed", str(HPO_SEED), "--output-dir", out_dir])
    finally:
        opt.run_trial = run_trial
    wall = time.time() - t0
    hist = _json(os.path.join(out_dir, "history.json"))
    best = _json(os.path.join(out_dir, "best_param.json"))
    peaks = _peaks(tee.buf.getvalue())
    values = [h["value"] for h in hist]
    say(f"-- cli.opt: {len(hist)} trials in {wall:.2f} s; values {values}; best {best}")
    for i, (h, (by, g, tw), peak) in enumerate(zip(hist, per_trial, peaks)):
        say(f"   trial {i}: {h['params']} → {h['value']:.6g}; {g} gconv kernels counted "
            f"by the {by}, {tw}; peak device memory {peak} bytes")
    if (len(hist) != HPO_TRIALS or not all(math.isfinite(v) for v in values)
            or len(per_trial) != HPO_TRIALS or len(peaks) != HPO_TRIALS):
        raise AssertionError(f"cli.opt: history {hist}, {len(per_trial)} profiled trials, "
                             f"peaks {peaks}")
    if not all(g > 0 for _, g, _ in per_trial):
        raise AssertionError(f"cli.opt: a trial launched no gconv kernel: {per_trial}")
    if peaks[-1] > peaks[0] * (1 + HPO_MEMORY_SLACK):
        raise AssertionError(f"cli.opt: peak device memory grew trial after trial: {peaks}")
    base = load_config(path)
    cpu = run_trial(base, hist[0]["params"], "cpu")
    rel = abs(values[0] - cpu) / abs(cpu)
    say(f"-- cli.opt trial 0 on this machine's CPU: validation_cost {cpu:.8g} against the "
        f"card's {values[0]:.8g}, relative difference {rel:.3e} (limit {TRAJECTORY_RTOL}); "
        f"peak memory trial {HPO_TRIALS} / trial 1 {peaks[-1] / peaks[0]:.4f} (limit "
        f"{1 + HPO_MEMORY_SLACK})")
    if rel > TRAJECTORY_RTOL:
        raise AssertionError(f"cli.opt trial 0: GPU {values[0]} vs CPU {cpu}")
    return sum(g for _, g, _ in per_trial)


def tools_nas():
    """``tools/nas.search`` on the solubility split (NAS_CANDIDATES
    candidates of NAS_EPOCHS epochs, streamed), the first bootstrap
    candidate the domain's widest (hidden 128): finite values, the first
    within TRAJECTORY_RTOL of the CPU's.  Returns the gconv launches."""
    from kgcn_tpu_torch.data.dataset import load_jbl, split_dataset
    from kgcn_tpu_torch.tools import nas

    cfg = _load_config(CONFIG, dropout_rate=0.0)
    ds, info = load_jbl(cfg["dataset"], cfg)
    train, valid, _, _ = split_dataset(ds, 0.3, seed=0)
    conf = {"epoch": NAS_EPOCHS, "batch_size": int(cfg["batch_size"])}
    _zero_counts()
    t0 = time.time()
    _, best, hist = nas.search(train, valid, info, conf, max_iter=NAS_CANDIDATES,
                               seed=NAS_SEED, log=lambda s: None)
    wall = time.time() - t0
    launches = _counts()["gconv"]
    for h in hist:
        say(f"   candidate {h['iteration']}: {h['params']} → {h['value']:.6g}")
    values = [h["value"] for h in hist]
    if (len(hist) != NAS_CANDIDATES or not all(math.isfinite(v) for v in values)
            or hist[0]["params"]["hidden"] != 128 or launches <= 0):
        raise AssertionError(f"nas.search: {hist}, {launches} gconv launches")
    _, _, first = nas.search(train, valid, info, conf, max_iter=1, seed=NAS_SEED,
                             log=lambda s: None, device="cpu")
    rel = abs(values[0] - first[0]["value"]) / abs(first[0]["value"])
    say(f"-- nas.search: {NAS_CANDIDATES} candidates in {wall:.2f} s, best {best:.6g}, "
        f"{launches} gconv launches; the first (hidden 128) on the CPU "
        f"{first[0]['value']:.8g} against the card's {values[0]:.8g}, relative "
        f"difference {rel:.3e} (limit {TRAJECTORY_RTOL})")
    if first[0]["params"] != hist[0]["params"] or rel > TRAJECTORY_RTOL:
        raise AssertionError(f"nas.search first candidate: GPU {hist[0]} vs CPU {first[0]}")
    return launches


def chem_dataset(workdir):
    """Phase 17's chem dataset (``workdir/chem/chem.jbl``: Morgan
    fingerprints and labels of the seeded molecules), made here when phase
    17 has not run in ``workdir``."""
    from kgcn_tpu_torch.data import jbl

    src = os.path.join(workdir, "chem", "chem.jbl")
    if not os.path.exists(src):
        d, _, _, _ = chem_files(workdir)
        _chem(["--smiles", os.path.join(d, "mols.smi"), "--label",
               os.path.join(d, "labels.txt"), "--atom-num-limit", str(CHEM_ATOM_LIMIT),
               "--morgan-fingerprint", "-o", src])
    return jbl.load(src)


def tools_host(workdir):
    """The tools without scikit-learn, on the host: ``cli.gk`` (WL, SVM CV)
    on solubility_cls.jbl, and the active-learning loop (SVC, entropy) on
    the chem dataset's Morgan fingerprints."""
    import numpy as np

    from kgcn_tpu_torch.cli import gk
    from kgcn_tpu_torch.tools.active_learning import run_loop

    tee = _Tee(sys.stdout)
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        gk.main(["--dataset", DATASET, "--kernel", "wl"])
    wall = time.time() - t0
    res = json.loads(tee.buf.getvalue().strip().splitlines()[-1])
    say(f"-- cli.gk (WL, 5-fold SVM) on {os.path.relpath(DATASET, ROOT)}: {wall:.2f} s, {res}")
    if not 0.5 < res["cv_accuracy"] <= 1.0:
        raise AssertionError(f"cli.gk: {res}")
    data = chem_dataset(workdir)
    X = np.asarray(data["chemical_fp"], np.float64)
    y = np.argmax(np.asarray(data["label"]), axis=1)
    t0 = time.time()
    accs, learner = run_loop(X[:AL_POOL], y[:AL_POOL], X[AL_POOL:], y[AL_POOL:], **AL_LOOP)
    wall = time.time() - t0
    say(f"-- active learning ({AL_LOOP}) on {len(X)} Morgan fingerprints ({AL_POOL} pool, "
        f"{len(X) - AL_POOL} test): {wall:.2f} s, {len(learner.labeled_idx)} labelled, "
        f"accuracies {[round(a, 4) for a in accs]}")
    if len(accs) != AL_LOOP["iterations"] + 1 or not all(0 <= a <= 1 for a in accs):
        raise AssertionError(f"active learning: accuracies {accs}")


def tools_timing():
    """``runtime/timing.chain_time`` of gconv at the serving shape (the
    solubility batch's second GraphConv, 50 → 50), beside its device time
    (``device_ms``)."""
    import torch

    from kgcn_tpu_torch.ops.gconv import gconv
    from kgcn_tpu_torch.runtime.timing import chain_time

    C, B, N, Fin, Fout = dict(GCONV_SHAPES)["path layer 2"]
    g = torch.Generator(device=DEVICE).manual_seed(0)
    adj = torch.rand((C, B, N, N), generator=g, device=DEVICE) / N
    w = torch.randn((C, Fin, Fout), generator=g, device=DEVICE) / Fin ** 0.5
    b = torch.zeros((C, Fout), device=DEVICE)
    x0 = torch.randn((B, N, Fin), generator=g, device=DEVICE)
    before = gconv.launches
    per = chain_time(lambda x: gconv(adj, x, w, b), x0, iters=200)
    dev = device_ms(lambda: gconv(adj, x0, w, b), 50)
    say(f"-- timing.chain_time of gconv {(C, B, N, Fin, Fout)}: {per * 1e3:.6f} ms a call "
        f"(the host's launch included) beside its device time {dev:.6f} ms "
        f"(the kernel ms of PERF.md §6 row 1: 0.008345); {gconv.launches - before} launches "
        "timed (not counted on the main path)")
    if not 0 < per < 1:
        raise AssertionError(f"chain_time: {per} s a call")


def logits_module(gm):
    """A copy of an exported program's module that answers the logits: the
    softmax at its output replaced by the softmax's input."""
    import copy

    gm = copy.deepcopy(gm)
    out = gm.graph.output_node()
    sm = [n for n in out.all_input_nodes if str(n.target).startswith("aten.softmax")
          or str(n.target).startswith("aten._softmax")]
    if len(sm) != 1:
        raise AssertionError(f"the exported program's output is no softmax: {out.args}")
    out.replace_input_with(sm[0], sm[0].args[0])
    gm.recompile()
    return gm


def model_logits(cfg, params_path, data, idx, device):
    """The logits (``Dense_0``'s output) of the port's model with the
    weights at ``params_path``, run eagerly on graphs ``idx`` of ``data``
    on the dense float32 path on ``device``."""
    import numpy as np
    import torch

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.checkpoint import load_checkpoint

    sub = {k: (np.asarray(v)[idx] if k in ("feature", "dense_adj", "label") else v)
           for k, v in data.items()}
    ds, info = build_dataset(sub, dict(cfg, spmm_backend="dense"))
    model = build_model(cfg["model.py"], info, cfg)
    tree = load_checkpoint(params_path)
    model.load_state_dict({**tree["params"], **tree["batch_stats"]})
    model.to(device).eval()
    seen = []
    hook = model.Dense_0.register_forward_hook(lambda m, i, o: seen.append(o.detach()))
    bs = int(cfg["batch_size"])
    b = Batcher(ds, info, bs)
    try:
        with torch.no_grad():
            for start in range(0, ds.num, bs):
                rows = np.arange(start, min(start + bs, ds.num))
                model(b.make_batch(rows).to(device), train=False)
                seen[-1] = seen[-1][:len(rows)]
    finally:
        hook.remove()
    return torch.cat(seen).float().cpu().numpy()


def export_run(workdir, label, src, over, kernel):
    """``cli.main train`` (1 epoch) with ``export_model``, then the
    ``ExportPredictor`` on the card for EXPORT_GRAPHS graphs: the backend's
    kernel launched inside the exported program, answers within EXPORT_TOL
    of the checkpoint's ``Predictor`` and within EXPORT_CPU_TOL of the same
    artifact run on this machine's CPU.  The answers of the 700-node rings
    are softmax outputs pinned at 0 and 1 (their logits reach hundreds: the
    readout sums 700 nodes), so the same holds for the logits before the
    softmax (the program's with its softmax left out; the port's model
    from the same weights run eagerly on the dense float32 path), relative
    to the largest logit.  Returns the program's launches."""
    import numpy as np

    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.runtime.serve import ExportPredictor, Predictor

    name = "export_" + label.split(" (")[0].replace(" ", "_")
    path = os.path.join(workdir, name, "model.pt2")
    _, _, _, _, out = train_run(workdir, name, src, 1, falling=False, dropout_rate=0.0,
                                make_plot=False, export_model=path, **over)
    if f"[SAVE] {path}" not in out or not os.path.exists(path + ".params"):
        raise AssertionError(f"export {label}: no artifact")
    cfg = _json(os.path.join(workdir, name, "config.json"))
    data = jbl.load(cfg["dataset"])
    idx = list(range(EXPORT_GRAPHS))
    payload = {"feature": data["feature"][idx].tolist(),
               "dense_adj": data["dense_adj"][idx].tolist(),
               "max_node_num": int(data["max_node_num"])}
    ep = ExportPredictor(path, cfg)
    ep.predict(payload)  # the first call builds what the program needs
    _zero_counts()
    t0 = time.perf_counter()
    got = ep.predict(payload)["prediction"]
    ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    want = Predictor(cfg, checkpoint=path + ".params").predict(payload)["prediction"]
    ep_cpu = ExportPredictor(path, cfg, device="cpu")
    cpu = ep_cpu.predict(payload)["prediction"]
    # the logits: the program's (the predictors' answers with the softmax
    # left out of the graph) and the model's
    ep._fn, ep_cpu._fn = logits_module(ep._fn), logits_module(ep_cpu._fn)
    lg, lg_cpu = (np.asarray(p.predict(payload)["prediction"]) for p in (ep, ep_cpu))
    lg_model = model_logits(cfg, path + ".params", data, idx, DEVICE)
    scale = float(np.abs(lg_model).max())
    gaps = [_gap(got, want), _gap(got, cpu), _gap(lg, lg_model) / scale,
            _gap(lg, lg_cpu) / scale]
    say(f"-- export {label}: {os.path.getsize(path)} bytes; {EXPORT_GRAPHS} graphs in "
        f"{ms:.2f} ms on the card, launches {dict((k, v) for k, v in counts.items() if v)}; "
        f"answers in [{float(np.min(got)):.6g}, {float(np.max(got)):.6g}]: vs the Predictor "
        f"max |diff| {gaps[0]:.3g} (limit {EXPORT_TOL}), vs the artifact on this machine's "
        f"CPU {gaps[1]:.3g} (limit {EXPORT_CPU_TOL}); logits in [{float(lg_model.min()):.6g}, "
        f"{float(lg_model.max()):.6g}] (the model's): the program's vs the model's max "
        f"|diff| / max |logit| {gaps[2]:.3g} (limit {EXPORT_TOL}), vs the program on the CPU "
        f"{gaps[3]:.3g} (limit {EXPORT_CPU_TOL})")
    if (counts[kernel] <= 0 or gaps[0] > EXPORT_TOL or gaps[1] > EXPORT_CPU_TOL
            or gaps[2] > EXPORT_TOL or gaps[3] > EXPORT_CPU_TOL):
        raise AssertionError(f"export {label}: launches {counts}, gaps {gaps}")
    return counts


def phase_tools(workdir):
    """Phase 18: the tools and export.  Returns the launches on its paths:
    the HPO trials' gconv (``tools_hpo``), NAS's gconv (streamed: the wrapper's count) and the exported
    programs' tiled, stream and ELL launches (the wrappers')."""
    phase(18, "tools and export: kgcn-torch-opt, NAS, graph kernels, active learning, "
              "timing, export on tiled, stream and pallas")
    t_phase = time.time()
    launches = {k: 0 for k in _counted()}
    launches["gconv"] += tools_hpo(workdir)
    say(f"HPO done at {time.time() - t_phase:.1f} s of the phase")
    launches["gconv"] += tools_nas()
    say(f"NAS done at {time.time() - t_phase:.1f} s of the phase")
    tools_host(workdir)
    tools_timing()
    say(f"host tools and timing done at {time.time() - t_phase:.1f} s of the phase")
    for label, src, over, kernel in EXPORT_RUNS:
        if over.get("spmm_backend") != "pallas":
            over = dict(over, dataset=ring700_file(workdir))
        else:
            over = dict(over, dataset=ring6_file(workdir))
        for k, v in export_run(workdir, label, src, over, kernel).items():
            launches[k] += v
    say(f"tools and export phase wall {time.time() - t_phase:.1f} s; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    return launches


# ---------------------------------------------------------------------------
# phase 19: the parallel layer, its ranks started by kgcn-torch-launch

PARALLEL_CV_MOLECULES = 320   # solubility_cls.json's first molecules, spread
PARALLEL_CV_FOLDS = 5
POOL_TRIALS = ({"learning_rate": 0.01, "batch_size": 32},
               {"learning_rate": 0.003, "batch_size": 16})
BIG_GRAPH_TOL = 1e-4         # of the largest magnitude: stream kernels vs segment sums
BIG_GRAPH_STEPS = 5           # timed big-graph steps
BENCH_KG = ("40943", "86835", "128")  # bench_scaling's kg step: WN18RR's nodes, edges, dim
SHARD_EPOCHS = 2             # the shard-ingest run on ring6
RESUME_DROPOUT = 0.2         # the resume's dropout (the config's default)


def _same_bits(label, a, b):
    """Two trees (nested dicts of tensors, or lists of floats) equal bit for
    bit."""
    import torch

    bad = []

    def walk(x, y, at):
        if isinstance(x, dict):
            if set(x) != set(y):
                bad.append(f"{at} keys")
            for k in x:
                walk(x[k], y.get(k), f"{at}.{k}")
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and torch.equal(x.cpu(), y.cpu())):
                bad.append(at)
        elif isinstance(x, (list, tuple)):
            if len(x) != len(y) or any(p != q for p, q in zip(x, y)):
                bad.append(at)
        elif x != y:
            bad.append(at)

    walk(a, b, "")
    if bad:
        raise AssertionError(f"{label}: not bitwise equal at {bad[:5]}")


def _last_params(cfg):
    from kgcn_tpu_torch.runtime import checkpoint as ckpt

    return ckpt.load_checkpoint(os.path.join(cfg["save_model_path"],
                                             "model.last.ckpt"))["params"]


def _cfg_of(workdir, name):
    with open(os.path.join(workdir, name, "config.json")) as f:
        return json.load(f)


def parallel_dp(workdir, label, src, per_forward, dx_per_step, epochs, cpu_check, **over):
    """``train`` with ``mesh {"data": 1}`` (the data-parallel trainer over
    the NCCL group of one rank) against the same config without ``mesh``
    (the single-device trainer, captured): per-epoch training costs and the
    final parameters bitwise; the mesh run's kernel launches exact (its
    steps run eagerly: ``per_forward`` a step and an evaluated batch,
    ``dx_per_step`` ELL dx kernels a step); with ``cpu_check`` the mesh
    run's costs on this machine's CPU (gloo) within TRAJECTORY_RTOL."""
    name = f"dp_{label}"
    mesh, counts, steps, evals, out = train_run(workdir, name, src, epochs,
                                                mesh={"data": 1}, **over)
    if over.get("spmm_backend") == "pallas" and "[spmm] backend: pallas" not in out:
        raise AssertionError(f"{name}: did not take the ELL route")
    single, _, _, _, _ = train_run(workdir, f"{name}_single", src, epochs, **over)
    _same_bits(f"{name}: per-epoch training costs, mesh vs single device", mesh, single)
    _same_bits(f"{name}: final parameters, mesh vs single device",
               _last_params(_cfg_of(workdir, name)),
               _last_params(_cfg_of(workdir, f"{name}_single")))
    say(f"-- {name}: mesh {{'data': 1}} bitwise equal to the single-device run "
        f"(costs {mesh})")
    kernel = "gconv" if dx_per_step is None else "ell_spmm"
    want = {kernel: per_forward * (steps + evals)}
    if dx_per_step is not None:
        want["ell_spmm_dx"] = dx_per_step * steps
    _expect(f"train {name} (mesh, eager steps)", counts, want)
    if cpu_check:
        cpu, _, _, _, _ = train_run(workdir, f"{name}_cpu", src, epochs, cpu=True,
                                    mesh={"data": 1}, **over)
        rel = [abs(a - b) / abs(b) for a, b in zip(mesh, cpu)]
        say(f"-- {name}: GPU {mesh} CPU (gloo) {cpu} relative {rel}")
        if max(rel) > TRAJECTORY_RTOL:
            raise AssertionError(f"{name}: GPU and CPU costs differ by {max(rel)}")
    return counts


def parallel_shard_ingest(workdir, per_forward, dx_per_step):
    """gin.json on ring6 with ``pallas`` through the shard mode of the
    sharded batcher (the rank's slice ``shard_for_host(ds, 0, 1)``,
    SHARD_EPOCHS epochs) against the single-device Trainer's streaming loop
    on the same data: per-epoch costs and final parameters bitwise; each
    run's ELL launches exact (``per_forward`` forward and ``dx_per_step``
    dx kernels a step).  Returns the shard run's launches and wall."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl, shard_for_host
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.parallel import mesh as pmesh
    from kgcn_tpu_torch.parallel.dp import DPTrainer, ShardedBatcher
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg = _load_config(GIN_CONFIG, dataset=ring6_file(workdir), spmm_backend="pallas")
    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    bs = int(cfg["batch_size"])
    steps = SHARD_EPOCHS * -(-ds.num // bs)
    local = Batcher(shard_for_host(ds, 0, 1), info, bs, seed=0, backend=be)
    runs = {}
    for name, tr, batcher in (
            ("shard", DPTrainer(build_model("gin", info, cfg), cfg, info, device=DEVICE,
                                mesh=pmesh.make_mesh({"data": 1})),
             ShardedBatcher(local, 1, mode="shard", global_num=ds.num)),
            ("single", Trainer(build_model("gin", info, cfg), cfg, info, device=DEVICE),
             Batcher(ds, info, bs, seed=0, backend=be))):
        t0 = time.time()
        costs, state = _epochs(tr, batcher, SHARD_EPOCHS)
        runs[name] = (costs, state.params, _counts(), time.time() - t0)
        _expect(f"shard ingest: {name}", runs[name][2],
                {"ell_spmm": per_forward * steps, "ell_spmm_dx": dx_per_step * steps})
    _same_bits("shard ingest vs the single-device run (costs)", runs["shard"][0],
               runs["single"][0])
    _same_bits("shard ingest vs the single-device run (parameters)", runs["shard"][1],
               runs["single"][1])
    say(f"-- shard ingest (gin ring6 pallas, world 1, {SHARD_EPOCHS} epochs, {steps} steps): "
        f"bitwise equal to the single-device run, costs {runs['shard'][0]}; "
        f"{runs['shard'][3]:.2f} s (single {runs['single'][3]:.2f} s)")
    return runs["shard"][2], runs["shard"][3]


def parallel_resume(workdir, per_forward):
    """The distributed resume on the card: solubility_cls.json's GCN (full
    width, dropout RESUME_DROPOUT) with ``mesh {"data": 1}`` on the sharded
    resident batcher, 2 epochs, ``save_tree``, 1 more epoch (continued); a
    fresh DPTrainer of another seed restores the checkpoint and trains that
    epoch (resumed): bitwise equal, the generator restored; gconv launches
    exact (``per_forward`` a step, 4 epochs).  Returns the launches and
    wall."""
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.parallel import mesh as pmesh
    from kgcn_tpu_torch.parallel.dp import DPTrainer, ShardedResidentBatcher

    cfg = _load_config(CONFIG, dropout_rate=RESUME_DROPOUT)
    info, rb, _, _ = _resident_setup(cfg, DEVICE)
    sb = ShardedResidentBatcher(rb, 1, 0)
    mesh = pmesh.make_mesh({"data": 1})
    path = os.path.join(workdir, "dp_resume", "model.mp.ckpt")

    def trainer(c):
        return DPTrainer(build_model(c["model.py"], info, c), c, info, device=DEVICE,
                         mesh=mesh)

    t0 = time.time()
    tr = trainer(cfg)
    state = tr.init_state(seed=0)
    _zero_counts()
    for epoch in (0, 1):
        state, _, _, _ = tr.run_epoch(state, sb, shuffle=True, epoch=epoch)
    tr.save_tree(path, tr.state_tree(state, 1, float("inf")))
    saved_rng = state.rng.get_state()
    state, cont, _, _ = tr.run_epoch(state, sb, shuffle=True, epoch=2)
    fresh = trainer(dict(cfg, seed=123))
    fresh.init_state(seed=123)
    back = fresh.restore(path)
    _same_bits("resume: the restored generator", back.rng.get_state(), saved_rng)
    back, resumed, _, _ = fresh.run_epoch(back, sb, shuffle=True, epoch=back.epoch)
    wall = time.time() - t0
    counts = _counts()
    _same_bits("resume vs continued (cost)", [resumed], [cont])
    _same_bits("resume vs continued (parameters)", back.params, state.params)
    _same_bits("resume vs continued (BN statistics)", back.batch_stats, state.batch_stats)
    steps = 4 * -(-rb.ds.num // rb.batch_size)
    _expect("resume (mesh, eager steps)", counts, {"gconv": per_forward * steps})
    say(f"-- resume (solubility GCN, dropout {RESUME_DROPOUT}, mesh {{'data': 1}}): epoch 2 "
        f"resumed bitwise the continued one (cost {resumed}); 4 epochs {wall:.2f} s")
    return counts, wall


def parallel_big_graph(workdir):
    """The big-graph KG trainer on phase 8's WN18RR-shaped KG at world 1:
    one step's loss and gradients against the single-device
    ``KGLinkPredictor`` on the same weights (the stream kernels, float32
    payload) within BIG_GRAPH_TOL of the largest magnitude, the ring halo
    equal to the allgather one; ``fit_resident`` (2 epochs); the sharded
    checkpoint round trip bitwise; ``cli.main train`` (mesh), ``retrain``
    and ``infer``; a step's wall time and the peak device memory.  Returns
    the infer's launches."""
    import numpy as np
    import torch
    from torch.func import functional_call

    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.kg import sample_negatives
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.parallel.big_graph import EMBED, from_kg_dataset

    cfg, path = kg_config(workdir, "kg_big_graph", mesh={"data": 1},
                          tiled_compute_dtype="float32", epoch=2)
    cfg.pop("label_batch_size")
    with open(path, "w") as f:
        json.dump(cfg, f)
    ds, info = load_jbl(cfg["dataset"], cfg)
    L = KG_OVERRIDES["label_batch_size"]
    ll = sample_negatives(np.concatenate([ds.label_list[0][:L]] * 2, axis=1).astype(np.int32),
                          np.arange(info.all_node_num, dtype=np.int32),
                          np.random.RandomState(0))
    say(f"-- big graph: {info.all_node_num} entities, {info.adj_channel_num} relations, "
        f"{len(ds.label_list[0])} training triples, dim {cfg['embedding_dim']}, "
        f"{cfg['kg_encoder']} encoder")
    grads, losses = {}, {}
    for strategy in ("ring", "allgather"):
        bg = from_kg_dataset(ds, info, dict(cfg, halo_strategy=strategy))
        state = bg.init_state(seed=0)
        grads[strategy] = bg.gradients(state, ll)
        losses[strategy] = bg.evaluate(state, ll)["cost"]
    _same_bits("big graph: ring vs allgather gradients",
               {k: torch.from_numpy(v) for k, v in grads["ring"].items()},
               {k: torch.from_numpy(v) for k, v in grads["allgather"].items()})
    if losses["ring"] != losses["allgather"]:
        raise AssertionError(f"big graph: ring loss {losses}")
    kb, _, _ = kg_batcher(dict(cfg, label_batch_size=L), device=bg.device)
    model = build_model("kg_distmult", info, cfg).to(bg.device)
    params = {k: v.to(bg.device).requires_grad_(True)
              for k, v in bg.to_flax_variables(state)["params"].items()}
    dev_ll = torch.from_numpy(ll).to(bg.device)
    batch = kb.graph_batch.replace(label_list=dev_ll[None],
                                   label_valid=torch.ones(1, L, device=bg.device))
    out = functional_call(model, params, (batch,), {"train": True})
    names = list(params)
    want = dict(zip(names, [g.cpu().numpy() for g in torch.autograd.grad(
        out.cost_opt, [params[k] for k in names])]))
    cost = float(out.cost_opt.detach())
    loss_gap = abs(losses["ring"] - cost) / abs(cost)
    worst = 0.0
    for k, w in want.items():
        got = grads["ring"][k][:w.shape[0]] if k == EMBED else grads["ring"][k]
        gap = float(np.max(np.abs(got - w))) / max(float(np.max(np.abs(w))), 1e-30)
        worst = max(worst, gap)
    say(f"-- big graph vs KGLinkPredictor (stream, f32), one step: loss {losses['ring']} vs "
        f"{cost} (relative {loss_gap:.3g}); gradients' largest gap "
        f"{worst:.3g} of the largest magnitude (limit {BIG_GRAPH_TOL})")
    if loss_gap > BIG_GRAPH_TOL or worst > BIG_GRAPH_TOL:
        raise AssertionError("big graph: the step disagrees with KGLinkPredictor")
    bg = from_kg_dataset(ds, info, cfg)
    state = bg.init_state(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = bg.train_step(state, ll)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BIG_GRAPH_STEPS):
        state, m = bg.train_step(state, ll)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / BIG_GRAPH_STEPS
    peak = torch.cuda.max_memory_allocated()
    say(f"-- big graph step (label slice {L}, world 1): {step_ms:.3f} ms wall, peak device "
        f"memory {peak} bytes; cost {m['cost']:.6g}")
    state, hist = bg.fit_resident(state, ds.label_list[0], epochs=2, seed=0)
    if not np.isfinite([h["train_cost"] for h in hist]).all():
        raise AssertionError(f"big graph fit_resident: {hist}")
    ck = os.path.join(workdir, "kg_big_graph", "roundtrip.ckpt")
    bg.save(ck, state)
    back = bg.restore(ck, bg.init_state(seed=1))
    _same_bits("big graph: the sharded checkpoint", state, back)
    say(f"-- big graph fit_resident: {hist}; sharded checkpoint restored bitwise")
    out, _, _, wall = _cli(["train", "--config", path])
    if "model.big_graph.ckpt" not in out or not os.path.exists(
            os.path.join(cfg["save_model_path"], "model.last.ckpt")):
        raise AssertionError(f"big graph train: {out[-2000:]}")
    re_cfg = dict(cfg, retrain=os.path.join(cfg["save_model_path"], "model.big_graph.ckpt"),
                  save_model_path=cfg["save_model_path"] + "_retrain", epoch=1)
    re_path = os.path.join(workdir, "kg_big_graph", "retrain.json")
    with open(re_path, "w") as f:
        json.dump(re_cfg, f)
    re_out, _, _, _ = _cli(["train", "--config", re_path])
    if f"[LOAD] {re_cfg['retrain']}" not in re_out:
        raise AssertionError(f"big graph retrain: {re_out[-2000:]}")
    out, result, counts, iwall = _cli(["infer", "--config", path])
    if not 0.0 <= result["mrr"] <= 1.0 or result["num_test_triples"] <= 0:
        raise AssertionError(f"big graph infer: {result}")
    say(f"-- big graph cli: train {wall:.2f} s, retrain resumed, infer {iwall:.2f} s "
        f"{json.dumps(result)}")
    return counts, {"step_ms": step_ms, "peak_bytes": peak}


def parallel_fold_cv(workdir):
    """``train_cv`` with ``fold_parallel: "force"`` at world 1 on the GPU and
    on the CPU: each fold's test cost within TRAJECTORY_RTOL."""
    import numpy as np

    from kgcn_tpu_torch.data import jbl

    data = jbl.load(DATASET)
    idx = np.linspace(0, len(data["label"]) - 1, PARALLEL_CV_MOLECULES).astype(np.int64)
    sub = {k: ([v[i] for i in idx] if isinstance(v, list) else
               v[idx] if isinstance(v, np.ndarray) and v.ndim and len(v) == len(data["label"])
               else v) for k, v in data.items()}
    path = os.path.join(workdir, "cv_subset.jbl")
    with open(path, "wb") as f:
        pickle.dump(sub, f, protocol=4)
    results = {}
    for side, cpu in (("gpu", False), ("cpu", True)):
        cfg, cpath = _write_config(workdir, f"cv_force_{side}", CONFIG, epoch=2,
                                   dropout_rate=0.0, fold_parallel="force",
                                   **{"k-fold_num": PARALLEL_CV_FOLDS})
        cfg["dataset"] = path
        cfg["save_info_cv"] = os.path.join(os.path.dirname(cpath), "info_cv.json")
        with open(cpath, "w") as f:
            json.dump(cfg, f)
        out, results[side], counts, wall = _cli(["train_cv", "--config", cpath], cpu=cpu)
        if f"[fold_parallel] {PARALLEL_CV_FOLDS} folds over 1 rank(s)" not in out:
            raise AssertionError(f"train_cv force ({side}): {out[-2000:]}")
        say(f"-- train_cv fold_parallel force ({side}): {wall:.2f} s")
        if side == "gpu":
            gpu_counts = counts
    g = [f["test_cost"] for f in results["gpu"]["folds"]]
    c = [f["test_cost"] for f in results["cpu"]["folds"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(g, c)]
    say(f"-- fold-parallel per-fold test costs GPU {g} CPU {c} relative {rel}")
    if len(g) != PARALLEL_CV_FOLDS or max(rel) > TRAJECTORY_RTOL:
        raise AssertionError("fold-parallel CV: GPU and CPU folds differ")
    return gpu_counts


def parallel_trial_pool(workdir):
    """DeviceTrialPool with the card twice: each trial's objective bitwise
    equal to the same trial run alone."""
    from kgcn_tpu_torch.cli.main import _prepare
    from kgcn_tpu_torch.tools.parallel_trials import DeviceTrialPool

    cfg = _load_config(CONFIG, dropout_rate=0.0, epoch=2)
    ds, info, backend = _prepare(cfg)

    def pool(devices):
        return DeviceTrialPool(cfg, ds, info, devices=devices, backend=backend)

    _zero_counts()
    t0 = time.time()
    together = pool([DEVICE + ":0"] * 2).run_batch(list(POOL_TRIALS))
    wall = time.time() - t0
    counts = _counts()
    alone = [pool([DEVICE + ":0"]).run_batch([p])[0] for p in POOL_TRIALS]
    _same_bits("trial pool: two trials at once vs each alone", together, alone)
    say(f"-- trial pool (cuda:0 twice): objectives {together} bitwise equal to each "
        f"trial alone; {wall:.2f} s for the round")
    return counts


def phase_parallel(workdir):
    """Phase 19, in a rank started by ``kgcn-torch-launch --nprocs 1`` (the
    NCCL group of one rank).  Returns (launches, numbers)."""
    import torch.distributed as dist

    from kgcn_tpu_torch.parallel import mesh as pmesh
    from kgcn_tpu_torch.tools import bench_scaling

    phase(19, "parallel: kgcn-torch-launch (NCCL, world 1), data-parallel mesh training, "
              "the big-graph KG trainer, fold-parallel CV, the trial pool")
    t_phase = time.time()
    if pmesh.world_size() != 1 or "nccl" not in str(dist.get_backend()):
        raise AssertionError(f"phase 19 runs in a world of {pmesh.world_size()} over "
                             f"{dist.get_backend()}")
    launches = {k: 0 for k in _counted()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    per_forward = gconv_kernels_a_forward(_load_config(CONFIG))
    say(f"first forward done at {time.time() - t_phase:.1f} s of the phase")
    add(parallel_dp(workdir, "gcn", CONFIG, per_forward, None, 2, True, dropout_rate=0.0))
    _, counts, _, _, _ = train_run(workdir, "dp_gcn_bf16", CONFIG, 1, falling=False,
                                   mesh={"data": 1}, dropout_rate=0.0, precision="bfloat16")
    if counts["gconv_bf16"] <= 0:
        raise AssertionError(f"the bf16 mesh run launched {counts}")
    add(counts)
    say(f"dp done at {time.time() - t_phase:.1f} s of the phase")
    add(parallel_dp(workdir, "gin_pallas", GIN_CONFIG, 2, 1, 2, False,
                    dataset=ring6_file(workdir), spmm_backend="pallas", make_plot=False))
    say(f"dp gin done at {time.time() - t_phase:.1f} s of the phase")
    counts, shard_s = parallel_shard_ingest(workdir, 2, 1)
    add(counts)
    counts, resume_s = parallel_resume(workdir, per_forward)
    add(counts)
    say(f"shard ingest and resume done at {time.time() - t_phase:.1f} s of the phase")
    counts, numbers = parallel_big_graph(workdir)
    numbers.update(shard_ingest_s=shard_s, resume_s=resume_s)
    add(counts)
    say(f"big graph done at {time.time() - t_phase:.1f} s of the phase")
    add(parallel_fold_cv(workdir))
    say(f"fold-parallel CV done at {time.time() - t_phase:.1f} s of the phase")
    add(parallel_trial_pool(workdir))
    nodes, edges, dim = BENCH_KG
    bench_scaling.main(["--workload", "kg_step", "--nodes", nodes, "--edges", edges,
                        "--features", dim])
    numbers["wall_s"] = time.time() - t_phase
    say(f"parallel phase wall {numbers['wall_s']:.1f} s; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    return launches, numbers


TP_CONFIG = os.path.join(ROOT, "example_config", "solubility_mt.json")
TP_EPOCHS = 2
PP_SHAPE = dict(layers_per_stage=4, hidden=64, microbatches=4)  # PPConfig's width
PP_STEPS = 20
PP_LR = 0.02
PP_TOL = 1e-5                # the pipeline's logits vs sequential_logits, of the largest
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "jax_orbax_big_graph")


def _epochs(trainer, batcher, epochs):
    """(per-epoch training costs, the final state) of ``epochs`` streaming
    epochs from seed 0, counts set to 0 first."""
    state = trainer.init_state(seed=0)
    _zero_counts()
    costs = []
    for e in range(epochs):
        state, cost, _, _ = trainer.run_epoch(state, batcher, shuffle=True, epoch=e)
        costs.append(cost)
    return costs, state


def models_tp():
    """TPTrainer at ``{"model": 1}`` on solubility_mt.json's multitask
    tower (dropout 0): bitwise the single-device Trainer run eagerly, its
    gconv launches a forward's a step, within TRAJECTORY_RTOL of the same
    run on this machine's CPU, and one bf16 epoch.  Returns the launches."""
    import numpy as np
    import torch

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.parallel import mesh as pmesh
    from kgcn_tpu_torch.parallel.tp import TPTrainer
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg = _load_config(TP_CONFIG, dropout_rate=0.0)
    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    bs = int(cfg["batch_size"])
    steps = TP_EPOCHS * -(-ds.num // bs)
    mesh = pmesh.make_mesh({"model": 1})

    def tp(dev, c=cfg):
        return TPTrainer(build_model(c["model.py"], info, c), c, info, device=dev, mesh=mesh,
                         min_dim=128)

    per_forward = gconv_kernels_a_forward(cfg)
    trainer = tp(DEVICE)
    sharded = sorted(k for k, v in trainer.rules.items() if v is not None)
    state = trainer.init_state(seed=0)
    batch = Batcher(ds, info, bs, backend=be).make_batch(np.arange(bs))
    _zero_counts()
    trainer.eval_step(state.params, state.batch_stats, batch)
    if _counts()["gconv"] != per_forward:
        raise AssertionError(f"TP forward launched {_counts()}, want {per_forward} gconv")
    say(f"-- TP {{'model': 1}}, min_dim 128: {len(sharded)} sharded leaves {sharded}; "
        f"{per_forward} gconv kernels a forward")
    runs = {}
    for name, make in (("trainer", lambda: Trainer(build_model(cfg["model.py"], info, cfg),
                                                   cfg, info, device=DEVICE, capture=False)),
                       ("tp", lambda: tp(DEVICE)), ("tp_cpu", lambda: tp("cpu"))):
        tr = make()
        t0 = time.time()
        costs, state = _epochs(tr, Batcher(ds, info, bs, seed=0, backend=be), TP_EPOCHS)
        wall = time.time() - t0
        params = tr.whole_params(state) if hasattr(tr, "whole_params") else state.params
        runs[name] = (costs, params, _counts(), wall)
        say(f"-- {name}: {TP_EPOCHS} epochs ({steps} steps) {wall:.2f} s, costs {costs}")
    _same_bits("TP {'model': 1} vs the Trainer (costs)", runs["tp"][0], runs["trainer"][0])
    _same_bits("TP {'model': 1} vs the Trainer (parameters)", runs["tp"][1],
               runs["trainer"][1])
    launches = runs["tp"][2]
    _expect("TP training", launches, {"gconv": steps * per_forward})
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["tp"][0], runs["tp_cpu"][0]))
    say(f"-- TP bitwise equal to the Trainer; GPU vs CPU costs relative {rel:.3g} "
        f"(limit {TRAJECTORY_RTOL})")
    if rel > TRAJECTORY_RTOL:
        raise AssertionError("TP: GPU and CPU costs differ")
    bcfg = dict(cfg, precision="bfloat16")
    costs, _ = _epochs(tp(DEVICE, bcfg), Batcher(ds, info, bs, seed=0, backend=be), 1)
    bf16 = _counts()
    say(f"-- TP bf16: 1 epoch, cost {costs}, launches {bf16}")
    if bf16["gconv_bf16"] != bf16["gconv"] or bf16["gconv_bf16"] <= 0 or not np.isfinite(
            costs).all():
        raise AssertionError(f"TP bf16: {bf16}, {costs}")
    return {k: launches[k] + bf16[k] for k in launches}, runs["tp"][3]


def models_pp():
    """PPTrainer at ``{"pipe": 1}`` (k 4, hidden 64, M 4) on a batch of 32
    solubility molecules of both classes: the logits within PP_TOL of ``sequential_logits``
    on the CPU (the plain gconv; of the largest), k·M gconv calls a forward, 20 Adam steps within
    TRAJECTORY_RTOL of the CPU's.  Returns (launches, ms a step)."""
    import numpy as np
    import torch

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.ops.gconv import gconv
    from kgcn_tpu_torch.parallel import mesh as pmesh
    from kgcn_tpu_torch.parallel.pp import (PPConfig, PPTrainer, init_pipeline_params,
                                            sequential_logits)
    from kgcn_tpu_torch.runtime import backend

    cfg = _load_config(CONFIG)
    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    bs = int(cfg["batch_size"])
    # spread over the dataset (sorted by class): both classes in the batch
    idx = np.linspace(0, ds.num - 1, bs).astype(np.int64)
    batch = Batcher(ds, info, bs, backend=be).make_batch(idx)
    pcfg = PPConfig(stages=1, channels=info.adj_channel_num, label_dim=info.label_dim,
                    **PP_SHAPE)
    full = init_pipeline_params(torch.Generator().manual_seed(0), pcfg, info.feature_dim)
    mesh = pmesh.make_mesh({"pipe": 1})
    tr = PPTrainer(pcfg, mesh, learning_rate=PP_LR, device=DEVICE)
    state = tr.init_state(info.feature_dim, params=full)
    x, adj, nmask, _, _ = tr.prepare_batch(batch)
    H = pcfg.hidden
    probe = torch.zeros(adj.shape[2], adj.shape[3], H, device=x.device)
    before = gconv.launches
    gconv(adj[0], probe, state["params"]["body_w"][0], state["params"]["body_b"][0])
    per_call = gconv.launches - before
    _zero_counts()
    logits = tr.logits(state, batch)
    calls = pcfg.layers_per_stage * pcfg.microbatches
    _expect("PP forward", _counts(), {"gconv": calls * per_call})
    # the plain network on CPU copies: the CPU's gconv is the plain version,
    # so this holds the card's gconv kernel at PP's shapes
    g = batch.graph.to("cpu")
    want = sequential_logits(full, g.nodes.reshape(bs, g.max_nodes, -1).to(torch.float32),
                             g.dense_adjacency(torch.float32).transpose(0, 1),
                             g.mask_batched(), cfg=pcfg)
    gap = float((logits.cpu() - want).abs().max() / want.abs().max())
    say(f"-- PP {{'pipe': 1}} k {pcfg.layers_per_stage} M {pcfg.microbatches} H {H}: "
        f"{calls} gconv calls a forward ({per_call} kernel(s) a call); logits vs "
        f"sequential_logits on the CPU {gap:.3g} of the largest (limit {PP_TOL})")
    if gap > PP_TOL:
        raise AssertionError("PP: the pipeline's logits differ from sequential_logits")
    costs, launches, wall = {}, None, 0.0
    for dev in (DEVICE, "cpu"):
        t = PPTrainer(pcfg, mesh, learning_rate=PP_LR, device=dev)
        st = t.init_state(info.feature_dim, params=full)
        _zero_counts()
        t0 = time.time()
        c = []
        for _ in range(PP_STEPS):
            st, cost, _ = t.train_step(st, batch)
            c.append(float(cost))
        if dev == DEVICE:
            launches, wall = _counts(), time.time() - t0
        costs[dev] = c
    _expect("PP steps", launches, {"gconv": PP_STEPS * calls * per_call})
    rel = max(abs(a - b) / abs(b) for a, b in zip(costs[DEVICE], costs["cpu"]))
    say(f"-- PP {PP_STEPS} Adam steps (lr {PP_LR}): GPU {costs[DEVICE][0]:.6g} → "
        f"{costs[DEVICE][-1]:.6g}, vs CPU relative {rel:.3g} (limit {TRAJECTORY_RTOL}); "
        f"{wall * 1e3 / PP_STEPS:.2f} ms a step")
    if rel > TRAJECTORY_RTOL or not costs[DEVICE][-1] < costs[DEVICE][0]:
        raise AssertionError(f"PP steps: {costs}")
    return launches, wall * 1e3 / PP_STEPS


def models_orbax(workdir):
    """kgcn_tpu's orbax big-graph checkpoint (the committed fixture, written
    over 4 devices): restored into BigGraphKGTrainer bitwise against its
    ``.npy`` arrays (the read's MB/s), then ``cli.main train`` with
    ``retrain`` (1 epoch) and ``infer``.  Returns (infer's launches,
    MB/s)."""
    import numpy as np
    import torch

    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.data.synthetic import make_kg_dataset
    from kgcn_tpu_torch.parallel.big_graph import EMBED, from_kg_dataset
    from kgcn_tpu_torch.runtime import orbax

    with open(os.path.join(ORBAX_FIXTURE, "config.json")) as f:
        cfg = json.load(f)
    d = os.path.join(workdir, "orbax_kg")
    os.makedirs(d)
    with open(os.path.join(d, "kg.jbl"), "wb") as f:
        pickle.dump(make_kg_dataset(**cfg.pop("kg")), f, protocol=4)
    ckpt = os.path.join(ORBAX_FIXTURE, "model.big_graph.ckpt")
    # the float32 payload: the stream scatter with slot weights (kernel 4)
    cfg.update(dataset=os.path.join(d, "kg.jbl"), save_model_path=os.path.join(d, "model"),
               mesh={"data": 1}, epoch=1, retrain=ckpt, tiled_compute_dtype="float32",
               save_info_test=os.path.join(d, "test.json"))
    path = os.path.join(d, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    ds, info = load_jbl(cfg["dataset"], cfg)
    bg = from_kg_dataset(ds, info, cfg)
    fresh = bg.init_state(seed=0)
    orbax.bytes_read = 0
    t0 = time.perf_counter()
    state = bg.restore(ckpt, fresh)
    secs = time.perf_counter() - t0
    mbs = orbax.bytes_read / secs / 1e6

    def npy(name):
        return torch.from_numpy(np.load(os.path.join(ORBAX_FIXTURE, "arrays", f"{name}.npy")))

    names = {EMBED: "embed", "distmult.kernel": "theta.distmult"}
    for i in range(2):
        names[f"conv{i + 1}.kernel"], names[f"conv{i + 1}.bias"] = f"theta.w{i}", f"theta.b{i}"
    want = {"params": {k: npy(f"params.{v}") for k, v in names.items()}}
    got = {"params": state["params"]}
    for m in ("mu", "nu"):
        want[m] = {k: npy(f"opt_state.0.{m}.{v}") for k, v in names.items()}
        got[m] = state["opt_state"]["0"]["0"][m]
    _same_bits("orbax restore vs the fixture's arrays", got, want)
    if state["step"] != int(npy("step")[0]):
        raise AssertionError(f"orbax restore: step {state['step']}")
    say(f"-- orbax: kgcn_tpu's model.big_graph.ckpt (D 4) restored at world 1 bitwise, "
        f"step {state['step']}; {orbax.bytes_read} bytes in {secs * 1e3:.1f} ms, "
        f"{mbs:.1f} MB/s (warm page cache)")
    out, _, _, wall = _cli(["train", "--config", path])
    if f"[LOAD] {ckpt}" not in out:
        raise AssertionError(f"orbax retrain: {out[-2000:]}")
    out, result, counts, iwall = _cli(["infer", "--config", path])
    if counts["stream_scatter"] <= 0 or not 0.0 <= result["mrr"] <= 1.0:
        raise AssertionError(f"orbax infer: {counts}, {result}")
    say(f"-- orbax: retrain 1 epoch {wall:.2f} s, infer {iwall:.2f} s {json.dumps(result)}; "
        f"launches {counts}")
    return counts, mbs


def phase_parallel_models(workdir):
    """Phase 20, in a rank started by ``kgcn-torch-launch --nprocs 1`` (the
    NCCL group of one rank).  Returns (launches, numbers)."""
    import torch.distributed as dist

    from kgcn_tpu_torch.parallel import mesh as pmesh

    phase(20, "tensor and pipeline parallel, and kgcn_tpu's orbax checkpoints "
              "(kgcn-torch-launch, NCCL, world 1)")
    t_phase = time.time()
    if pmesh.world_size() != 1 or "nccl" not in str(dist.get_backend()):
        raise AssertionError(f"phase 20 runs in a world of {pmesh.world_size()} over "
                             f"{dist.get_backend()}")
    tp, tp_s = models_tp()
    say(f"TP done at {time.time() - t_phase:.1f} s of the phase")
    pp, pp_ms = models_pp()
    say(f"PP done at {time.time() - t_phase:.1f} s of the phase")
    ob, mbs = models_orbax(workdir)
    launches = {k: tp[k] + pp[k] + ob[k] for k in _counted()}
    numbers = {"tp_epochs_s": tp_s, "pp_step_ms": pp_ms, "orbax_read_mb_s": mbs,
               "wall_s": time.time() - t_phase}
    say(f"tensor/pipeline/orbax phase wall {numbers['wall_s']:.1f} s; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    return launches, numbers


def summary_rows(gconv_rows, tiled_rows, stream_rows, ell_rows, launches, bf16_rows):
    """The ``kernels`` line: each kernel at the main path's shapes (gconv:
    the served batch's three GraphConv calls, float32 and, for its bf16
    entry, bf16 (phase 16); tiled: the solubility batch at
    F 81 and 50 and the GAT batch, bf16 payload; stream: the KG's largest
    and smallest relation channels at F 128 — the iota-route scatter with
    the float32 payload of its KG run, the one-hot scatter and the weight
    gradient with bf16; ELL: the ring6 batch at F 3 and 50, float32),
    errors over every shape (float32)."""
    def mean(rows, key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(vals) / len(vals)

    path = gconv_rows[:3]
    bf16_path = [r for r in bf16_rows if r["label"].startswith("path layer")]
    on_path = [r for r in tiled_rows if r["on_path"]]
    gat = [r for r in on_path if r["label"] == "GAT batch"]
    return [{
        "name": "gconv",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/gconv.cu",
        "replaces": "kgcn_tpu/ops/pallas_gconv.py:33",
        "launches": launches["gconv"],
        "max_abs_err": max(r["err"] for r in gconv_rows),
        "ms": mean(path, "kernel_ms"),
        "plain_ms": mean(path, "plain_ms"),
        "bound_ms": mean(path, "bound_ms"),
        "bound_by": path[0]["bound_by"],
        "library_ms": mean(path, "library_ms"),
    }, {
        "name": "gconv_bf16",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/gconv.cu",
        "replaces": "kgcn_tpu/ops/pallas_gconv.py:33",
        "launches": launches["gconv_bf16"],
        "max_abs_err": max(r["err"] for r in bf16_rows),
        "ms": mean(bf16_path, "kernel_ms"),
        "plain_ms": mean(bf16_path, "plain_ms"),
        "bound_ms": mean(bf16_path, "bound_ms"),
        "bound_by": bf16_path[0]["bound_by"],
        "library_ms": mean(bf16_path, "library_ms"),
    }, {
        "name": "tiled_spmm",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/tiled.cu",
        "replaces": "kgcn_tpu/ops/tiled_spmm.py:320",
        "launches": launches["tiled_spmm"],
        "max_abs_err": max(r["spmm_err"] for r in tiled_rows),
        "ms": mean(on_path, "spmm"),
        "plain_ms": mean(on_path, "spmm_plain"),
        "bound_ms": mean(on_path, "bound"),
        "bound_by": on_path[0]["bound_by"],
        "library_ms": mean(on_path, "spmm_library"),
    }, {
        "name": "tiled_sddmm",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/tiled.cu",
        "replaces": "kgcn_tpu/ops/tiled_spmm.py:353",
        "launches": launches["tiled_sddmm"],
        "max_abs_err": max(r["sddmm_err"] for r in tiled_rows),
        "ms": mean(gat, "sddmm"),
        "plain_ms": mean(gat, "sddmm_plain"),
        "bound_ms": mean(gat, "sddmm_bound"),
        "bound_by": gat[0]["sddmm_bound_by"],
        "library_ms": mean(gat, "sddmm_library"),
    }] + stream_summary_rows(stream_rows, launches, mean) + ell_summary_rows(
        ell_rows, launches, mean)


def ell_summary_rows(rows, launches, mean):
    """Kernel 7's two rows: the forward (the ring6 batch at F 3 and 50) and
    its dx kernel (the ring6 batch at F 50, the width the path's backward
    gives it), both float32."""
    on_path = [r for r in rows if r["on_path"]]
    dx_path = [r for r in rows if r["dx_on_path"]]
    return [{
        "name": "ell_spmm",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/ell.cu",
        "replaces": "kgcn_tpu/ops/pallas_spmm.py:30",
        "launches": launches["ell_spmm"],
        "max_abs_err": max(r["err"] for r in rows),
        "ms": mean(on_path, "kernel"),
        "plain_ms": mean(on_path, "plain"),
        "bound_ms": mean(on_path, "bound"),
        "bound_by": on_path[0]["bound_by"],
        "library_ms": mean(on_path, "library"),
    }, {
        "name": "ell_spmm_dx",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/ell.cu",
        "replaces": "kgcn_tpu/ops/pallas_spmm.py:30",
        "launches": launches["ell_spmm_dx"],
        "max_abs_err": max(r["dx_err"] for r in rows),
        "ms": mean(dx_path, "dx"),
        "plain_ms": mean(dx_path, "dx_plain"),
        "bound_ms": mean(dx_path, "dx_bound"),
        "bound_by": dx_path[0]["dx_bound_by"],
        "library_ms": mean(dx_path, "dx_library"),
    }]


def stream_summary_rows(rows, launches, mean):
    kg = [r for r in rows if r["on_path"]]
    out = []
    for name, line, key, kind, err in (
            ("stream_scatter", 335, "scatter", "scatter", "scatter_err"),
            ("stream_scatter_mat", 374, "scatter_mat", "scatter_mat", "mat_err"),
            ("stream_dw", 448, "dw", "dw", "dw_err")):
        bounds = [r["bounds"][kind] for r in kg]
        out.append({
            "name": name,
            "route": "cuda",
            "source": "kgcn_tpu_torch/ops/csrc/stream.cu",
            "replaces": f"kgcn_tpu/ops/stream_spmm.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(r[err] for r in rows),
            "ms": mean(kg, key),
            "plain_ms": mean(kg, f"{key}_plain"),
            "bound_ms": sum(b for b, _ in bounds) / len(bounds),
            "bound_by": bounds[0][1],
            "library_ms": mean(kg, "dw_library" if kind == "dw" else "spmm_library"),
        })
    return out


def main():
    t_start = time.time()
    smi = phase_environment()
    phase_build()
    gconv_rows = phase_gconv_check()
    tiled_rows = phase_tiled_check()
    say(f"kernel checks done at {time.time() - t_start:.1f} s")
    with tempfile.TemporaryDirectory(prefix="kgcn_smoke_") as workdir:
        launches = phase_train(workdir)
        say(f"train done at {time.time() - t_start:.1f} s")
        launches["gconv"] += phase_serve(workdir)
        say(f"serve done at {time.time() - t_start:.1f} s")
        stream_rows = phase_stream_check(workdir)
        say(f"stream check done at {time.time() - t_start:.1f} s")
        for k, v in phase_kg(workdir).items():
            launches[k] += v
        say(f"kg done at {time.time() - t_start:.1f} s")
        ell_rows = phase_ell_check(workdir)
        say(f"ell check done at {time.time() - t_start:.1f} s")
        for k, v in phase_ell(workdir).items():
            launches[k] += v
        say(f"ell done at {time.time() - t_start:.1f} s")
        for k, v in phase_runners(workdir).items():
            launches[k] += v
        say(f"runners done at {time.time() - t_start:.1f} s")
        for k, v in phase_configs(workdir).items():
            launches[k] += v
        say(f"configs done at {time.time() - t_start:.1f} s")
        phase(13, "launches: every kernel launched on the main path (phases 5-12)")
        for k, v in launches.items():
            if v <= 0 and k != "gconv_bf16":  # the bf16 path is phase 16's
                raise AssertionError(f"{k} was not launched on the main path")
        say(f"launches so far: {launches}")
        serving = phase_serving(workdir, smi)
        for k, v in serving.items():
            launches[k] += v
        say(f"serving done at {time.time() - t_start:.1f} s")
        engines, numbers = phase_engines(workdir)
        for k, v in engines.items():
            launches[k] += v
        say(f"engines done at {time.time() - t_start:.1f} s")
        bf16_rows, precision = phase_precision_process(workdir)
        for k, v in precision.items():
            launches[k] += v
        say(f"precision and explain done at {time.time() - t_start:.1f} s")
        chemistry = phase_in_child("--phase17", workdir)["launches"]
        for k, v in chemistry.items():
            launches[k] += v
        say(f"chemistry done at {time.time() - t_start:.1f} s")
        tools = phase_in_child("--phase18", workdir)["launches"]
        for k, v in tools.items():
            launches[k] += v
        say(f"tools and export done at {time.time() - t_start:.1f} s")
        parallel = phase_in_child("--phase19", workdir, ranks=1)
        for k, v in parallel["launches"].items():
            launches[k] += v
        say(f"parallel done at {time.time() - t_start:.1f} s: {parallel['numbers']}")
        models = phase_in_child("--phase20", workdir, ranks=1)
        for k, v in models["launches"].items():
            launches[k] += v
        say(f"tensor/pipeline parallel and orbax done at {time.time() - t_start:.1f} s: "
            f"{models['numbers']}")

    import torch

    phase(21, "summary")
    if min(models["launches"][k] for k in ("gconv", "gconv_bf16", "stream_scatter")) <= 0:
        raise AssertionError(f"the TP, PP and orbax paths launched {models['launches']}")
    if min(parallel["launches"][k] for k in ("gconv", "gconv_bf16", "ell_spmm",
                                              "ell_spmm_dx")) <= 0:
        raise AssertionError(f"the parallel paths launched {parallel['launches']}")
    if tools["gconv"] <= 0 or min(tools[k] for k in ("tiled_spmm", "stream_scatter",
                                                     "ell_spmm")) <= 0:
        raise AssertionError(f"the tools and export paths launched {tools}")
    if chemistry["gconv"] <= 0:
        raise AssertionError("gconv was not launched on the chemistry path")
    if precision["gconv_bf16"] <= 0:
        raise AssertionError("the bf16 gconv kernel was not launched on the bf16 path")
    if serving["gconv"] <= 0:
        raise AssertionError("gconv was not launched on the serving path")
    if engines["gconv"] <= 0 or engines["tiled_spmm"] <= 0:
        raise AssertionError(f"the engines launched {engines}")
    say(f"reaction scale: {numbers}")
    kernels = summary_rows(gconv_rows, tiled_rows, stream_rows, ell_rows, launches,
                           bf16_rows)
    say(f"total {time.time() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in ("--phase16", "--phase17", "--phase18",
                                              "--phase19", "--phase20"):
        child_main(sys.argv[1], sys.argv[2])
    else:
        main()
