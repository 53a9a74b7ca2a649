#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/csrc/ (one nvcc per
source, all at once), prints what the compiler reports for each (``-Xptxas
-v``: registers, shared memory, spills) and, where the toolkit has
``cuobjdump``, how many HGMMA (wgmma) instructions the bf16 flash kernels
hold and how many HMMA the bf16 instances of the SSD kernel's chunk_scan
hold (each must be above 0), holds each kernel against its plain torch
version, then drives each main path through the entry points a user
calls, with the launch counts set to 0 just before it and read just
after:

  * HPL prediction: the max-min fair allocation of Frontera's panel
    broadcast (``waterfill``, which runs ``masked_min_rows`` once per
    iteration); ``get_workload("hpl").predict(get_platform(p))`` for
    bdw-local, tpu-v5e-pod, syn-mp-2pod-v5e and Frontera (N=9,282,848,
    88x91 grid, 24,175 panels) against the reference package's simulated
    times; the 64-row Frontera what-if grid through ``whatif_grid``
    against the reference's rows and the single run, and a mixed-geometry
    forced-bucket sweep through ``sweep_hpl`` against the single runs.
    Then the kernel's rates for the whole broadcast (8,008 flows)
    against the DES ``Network``'s progressive filling of the same flows
    started together.
  * The DES and gradient calibration: ``HPLSim`` on Frontera's spec at
    N=65,536, nb=384, 16x16 (1,381,183 events), untraced and traced,
    equal to the reference bit for bit, with its Chrome export validated
    and its host wall time and events per second printed;
    ``predict_des`` on bdw-local, equal to the reference; and
    ``fit_fastsim_to_des(get_platform("bdw-local"))`` with the fit on the
    card: DES probe times bit-equal, fitted scales and final loss within
    1e-6 of the reference's, with the wall time and CUDA launches of one
    fit step.  No kernel of the port runs on this path.
  * The transformer step model, fault sweeps, representative regions,
    per-scale contention and the TOP500 fleet, each against the reference
    package's answers (the ``REFERENCE_*`` constants, which
    tests/test_torch_chip_constants.py holds to the reference):
    ``get_workload("transformer").predict`` on four torus and multipod
    platforms and an 18-scenario step sweep run twice (the second builds
    no program), within 1e-12, and d step / d link_bw through autograd
    within 1e-9; ``sweep_faults`` on tpu-v5e-pod for HPL at the
    registry's N=619,520 nb=512 16x16 run and for the transformer, one
    scenario of each closed-form kind and a combined one, within 1e-12,
    and fail-stop and node-scoped link faults raising; ``RegionHPLSim``
    on the 16x16 Frontera DES above with 12 of its 171 panels simulated
    (the prefix's events and panel marks bit-equal, the result within
    1e-12, its error against the exact run printed);
    ``fit_contention_at_scale`` at 16 ranks with its fit on the card
    (within 1e-6); and ``predict_fleet(load_sample())`` at the library's
    default tuning, one forced-bucket sweep of 51 machines (4,096 loop
    steps), every machine's predicted and calibrated Rmax and the family
    factors within 1e-12, the same bucket and splits, one bucket program
    built and the held-out median error the reference's (<= 15%), with
    the sweep's wall time and CUDA launches per loop step.  Each prints
    its host wall time, and no kernel of the port runs on these paths.
  * The prediction service and the campaign layer, against the reference
    package's answers as above: ``PredictionService(cache=True)`` serves
    one mixed wave (HPL on bdw-local, tpu-v5e-pod and syn-mp-2pod-v5e,
    the transformer on tpu-v5e-pod and syn-torus-fugaku-4k, a straggler,
    a DES breakdown on bdw-local) in two sweeps, every time within 1e-12
    and ``stats`` equal; the same wave again from the cache (all hits,
    payloads unchanged); 8 identical requests coalesce onto one;
    ``request_key`` digests equal the reference's; after ``warm()`` a
    4 + 4 wave adds no compile; ``HPLPredictionService.predict_platforms``
    gives the reference times; one budgeted breakdown (``timeout_s=1e-9``)
    degrades to its fastsim answer.  ``run_campaign`` runs the
    reference's 36-run acceptance matrix (one fastsim and one stepsim
    dispatch, two service sweeps; journal records equal apart from
    floats, which are within 1e-12; a rerun's run lines byte-equal) and
    the two-edition TOP500 study (``--limit 12 --max-ranks 256``: drift
    table within 1e-12, at most one fleet program per edition).  Each
    prints its host walls; no kernel of the port runs on these paths.
  * The dry-run-record predictions and the fault-tolerance layer, on
    synthetic records in the reference's schema (the repository holds
    none) written under a temporary ``experiments/dryrun``:
    ``predict_cell`` on five records (a train and a prefill kind, all five
    collective ops), ``whatif`` with sec5's ICI, HBM and peak doublings
    on qwen3-moe-235b-a22b, ``predict_cell_des`` on the 256-rank mesh at
    full depth for qwen2-0.5b (train and prefill) and qwen3-moe-235b-a22b
    (94 layers) and on the two-pod 512-rank mesh for qwen2-0.5b,
    ``simulate_straggler_impact`` (a 3x-slow chip), ``simulate_fault_impact``
    on fastsim (on the card) and on the DES (a fail-stop), and
    ``restart_plan_for_faults``; every answer equal to the reference's
    (the fastsim one within 1e-12), with its host wall and the DES's
    events per second.  No kernel of the port runs on this path.
  * LM serving: ``ServeEngine`` on qwen2-0.5b at full width (24 layers,
    d_model 896, 14 query heads in 2 KV groups, vocab 151,936) with seeded
    random weights, 8 requests of 128 prompt tokens and 32 new tokens in
    4 slots; prefill runs ``flash_attention_fwd`` once per layer.  The
    same requests then go through the engine built without the kernel
    (the reference engine's build), in bfloat16 and in float32, and the
    greedy tokens must agree.  Then a 4 x 2048 prefill and 16 decode steps
    with and without the kernel, compared in float32 and bfloat16, and two
    planted faults that the comparison must catch.  The bf16 kernel is
    timed beside scaled_dot_product_attention at the prefill shape and at
    the served shape.
  * Mamba-2 scoring and serving: the SSD chunk-scan kernel against its
    plain version at the kernel tests' shapes, mamba2-780m's 4 x 2048
    forward shape, a ragged S and an S below the chunk, in float32 and
    bfloat16, and element by element against its own function evaluated
    in float64 within a derived rounding bound, with two planted faults
    that must break both, timed at the model's shape on per-head B and C
    and on one group's B and C shared by all heads, as the model passes
    them (with each of its three passes' device time from torch.profiler),
    all of it also at zamba2-2.7b's scan shape (4, 2048, 80, 64, 64, 256);
    ``Model.loss`` of mamba2-780m at full width (48 layers, d_model
    1536, 48 heads of 64, N 128, vocab 50,280, seeded weights) on
    4 x 2048 tokens with the kernel (48 launches a forward) against the
    plain chunked scan: in float32 at the logits, the loss and every
    layer's scan, in bfloat16 at every layer's scan (and each bf16 path's
    logits against the float32 ones), with the same two faults planted in
    the model; then ``ServeEngine`` on the same model (4 requests of 128
    prompt and 16 new tokens, 4 slots), which runs prefill and decode
    without the kernel, as the reference's engine does, and a float32
    check that prefill's last logits equal the kernel forward's.
  * MoE serving and scoring: phi3.5-moe-42b-a6.6b at full width (d_model
    4096, 32 query heads in 8 KV groups of 128, 16 experts of 6,400,
    top-2, vocab 32,064, seeded weights) cut to 8 of its 32 layers, under
    both ``moe_impl`` values: ``ServeEngine`` in bfloat16 (4 requests of
    128 prompt and 16 new tokens, 4 slots; ``flash_attention_fwd`` once a
    layer a prefill), then the same requests against the engine built
    without the kernel in float32, and in bfloat16 with the kernel run
    replaying the plain run's routing decisions (the router is discrete:
    a bf16 rounding that flips a near-tied expert moves a token by O(1),
    which is not what the kernel changes).  Then a 2 x 2048 prefill, 16
    decode steps and ``Model.loss``, kernel against plain with the plain
    run's routing replayed: in float32 over the logits, the K/V cache,
    the decode steps and the loss; in bfloat16 over each layer's
    attention output and output, each layer also fed the plain run's
    input (bf16 rounds the stream of this MoE far more coarsely than a
    layer's attention moves it, which the "stream rounding" line
    measures without the kernel; with the inputs replayed the cache and
    decode steps equal the plain run's by construction).  Every layer's
    kernel attention output is held element by element against its
    float64 function, and two planted faults (a middle layer's attention
    zeroed, the causal mask off) must read above every limit the kernel
    passes; the number of routing decisions that flip without replay is
    printed.
  * VLM serving and scoring: llava-next-mistral-7b at full width and
    depth (32 layers, 32 query heads in 8 KV groups of 128, 2,880 image
    tokens, seeded weights): ``ServeEngine`` (2 requests of 128 prompt and
    16 new tokens behind a zero image prefix) against the plain engine in
    bfloat16 and float32, and a teacher-forced prefill of 2,880 seeded
    image embeddings and 128 tokens (3,008 positions, ragged at the hd-128
    tile) with 4 decode steps and ``Model.loss``, compared, bounded and
    faulted as for the MoE model.
  * head_dim 80: the flash kernel at zamba2-2.7b's loss shape (4, 2048,
    32, 1, 80), stablelm-3b's served shape (1, 128, 32, 1, 80) and a
    ragged shape with Sk != Sq, in float32 and bfloat16, causal and full,
    against the plain version and its float64 element bound, with the two
    tile faults at the zamba2 shape, timed beside SDPA.  stablelm-3b at
    full width and depth (32 layers, d_model 2560, 32 heads of 80,
    LayerNorm, vocab 50,304, seeded weights) served as qwen2-0.5b is
    (flash once a layer a prefill, 256 launches) against the plain
    engine in bfloat16 and float32.
  * The hybrid family: zamba2-2.7b at full width and depth (54 Mamba-2
    layers of d_model 2560, 80 heads of 64, N 64; one shared attention +
    MLP block of 32 heads of 80 after every 6 layers; vocab 32,000; seeded
    weights).  ``Model.loss`` on 4 x 2048 tokens with the kernels (54
    scans and 9 flash calls a loss) against the plain path in float32
    and bfloat16: the logits and loss, every layer's scan and every
    shared-block attention output (each against its plain version on the
    same inputs) and every flash call's float64 element bound, with four
    planted faults (the two scan faults in every layer, the middle group's
    shared attention zeroed, the causal mask off), each above every limit
    of the kernel it is planted in; then ``ServeEngine`` (4 requests of
    128 prompt and 16 new tokens, 4 slots), which launches no kernel, as
    the reference's engine does, against the plain engine in bfloat16
    and float32.
  * The encdec family: whisper-medium at full width (d_model 1024, 16
    heads of 64, 1500 encoder frames, vocab 51,865, seeded weights), its
    24 encoder and 24 decoder layers cut to 8 each, on which no kernel of
    the port runs (the reference runs every encdec attention plain; the
    three launch counts must stay 0 over the phase).  ``Model.loss`` and
    ``forward`` on 4 sequences of 448 tokens, each behind its own 1500
    seeded frames, in float32 and bfloat16, and ``ServeEngine`` (4
    requests of 128 prompt and 16 new tokens, 4 slots) in both, held to
    baselines the card does not produce: G1 the first sequence's float32
    logits and loss against the host CPU's (1e-4); G2 a prefill of 432
    tokens and 16 teacher-forced decode steps against ``forward`` (1e-4);
    G3 every bfloat16 layer fed the float32 run's input against the
    float32 run (5e-2); G4 the float32 served tokens and stats equal the
    host CPU engine's, the bfloat16 ones equal or a near-tie.  Four faults
    planted on the card side (the middle decoder layer's cross-attention
    zeroed, a causal encoder, the decode position row off by one, the
    cross-attention cache rolled along the batch in decode) must each read
    above the limits of the gates they pass through.
  * The serving launcher: L1 runs ``python -m repro_torch.launch.serve
    --arch qwen2-0.5b --requests 8`` (full width, the launcher's own
    seed-0 weights) in a child process, whose printed counts and stats
    must be the schedule's (8 requests, 128 tokens, 30 decode steps);
    then its ``serve`` on the same weights in bfloat16 and float32 (192
    flash launches each) against the host CPU's run: tokens equal in
    float32, equal or a near-tie in bfloat16.  L2 serves each of the ten
    archs at ``--smoke --requests 2 --batch-slots 2`` likewise, and holds
    the logits of llava-next's six decode steps past the launcher's cache
    (its image prefix is not in ``max_len``) against the host's.  Three
    faults planted on the card side (the decode write wrapping to row
    ``cache_len % max_len``, RoPE at the clamped row, the middle qwen2
    layer's flash output zeroed in every prefill) must each break the
    gates ``LAUNCH_FAULTS`` lists and no other.
  * The host side of training: C1 the data pipeline's global batches
    of qwen2-0.5b's vocabulary (4 x 2048 tokens, steps 0 and 1) against
    the reference's SHA-256 digests, every dp of 1, 2 and 4 tiling them;
    then ``make_train_state`` of qwen2-0.5b at full width (494,147,456
    float32 parameters and AdamW's m and v, 5.93 GB, moments filled from
    the seed) on the card, ``Model.loss`` on step 0's batch (flash once a
    layer), a host snapshot, ``save_checkpoint`` of step 1,
    ``AsyncCheckpointer.save`` of step 2 with a second loss while it
    writes and every m leaf updated in place before ``wait``, every live
    leaf zeroed, and both steps restored on the card: C2 the restores
    equal the snapshot and their files, in the reference's key order and
    on storage of their own; C3 the loss on the restored parameters
    equals the first bit for bit; C4 step 2's file is the state as
    ``save`` found it.  Save, async and restore seconds and GB/s, the
    write's overlap with the loss and the disk's free space are printed.
    Three faults planted on reduced qwen2-0.5b (a bit flipped in a saved
    file, m and v restored crosswise, the async host copy left to its
    thread) must each break the gates ``CKPT_FAULTS`` lists and no other.
  * The training step: full-width qwen2-0.5b (494,147,456 parameters,
    AdamW, remat "dots_nb") on one global batch of 4 x 256 tokens from
    the data pipeline, from ``make_train_state`` (seed 0) after one
    ``train_step``, with every kernel's launch count held at 0 (training
    runs the plain paths).  T4 the float32 loss and gradients under remat
    "none", "full" and "dots_nb" (1e-6, each one's peak memory); the host
    CPU's float32 step on a copy of the state; T1 the card's loss, grad
    norm (1e-5) and every gradient leaf (1e-4 of the host's scale)
    against the host's; T2 the card's AdamW update on the host's
    gradients against the host's update (1e-6, the count equal); T3
    microbatches 2 against 1 (1e-5), each int8-compressed leaf within
    half a step, and two steps at lr 1e-3 with the loss falling; T5 the
    step in bfloat16 as configured (finite, its loss within 5e-2 of
    float32, every gradient leaf's norm gap to float32 between 1e-3 and
    0.25); T6 ``make_train_step(use_kernel=True)`` raising, and both
    kernel wrappers refusing inputs that require grad.  Five faults
    planted in the code under test (the middle layer's attention output
    detached, in every dtype or in bf16 only; AdamW's bias corrections at
    the old count; microbatch gradients summed and not divided; the bf16
    step built in float32) must each break the gate ``TRAIN_FAULTS``
    lists and no other.  The bf16 gradient pass is then timed at 4 x 2048
    tokens under each remat policy, with its peak device memory.
  * The training loop: ``train`` on full-width qwen2-0.5b as configured
    (bf16 compute, AdamW) on the data pipeline's 4 x 256-token stream
    (seed 0, lr 3e-4), every kernel's launch count held at 0.  TL1 four
    steps straight against ``make_train_step``'s function called four
    times by hand on the same seed's state and batches: the losses equal
    and every leaf of the final state bit-equal; TL2 two steps with a
    checkpoint, then a resume to four: the resume logged, the final state
    and its step-4 checkpoint bit-equal to the straight run's; TL3 the
    loss falling; TL4 ``python -m repro_torch.launch.train --arch
    qwen2-0.5b --steps 3 --global-batch 4 --seq-len 256`` in a child
    process beside TL5 and the faults' runs, whose printed losses must be
    TL1's to four decimals; TL5 all
    ten archs reduced, in float32, three steps with a resume after the
    first (qwen3-moe-235b-a22b, Adafactor, in 2 microbatches), on the card
    against the host CPU from the same weights (each loss within 1e-5).
    Three faults planted in the loop on reduced qwen2-0.5b (the stream
    restarting at a resume, the optimizer state dropped at a resume, every
    step fed the next step's batch) must each break the gates
    ``LOOP_FAULTS`` lists and no other.  The runs' step times, how long
    each checkpoint save held the loop and the restores are printed.
  * The dry-run's mesh-free inputs (``models.api``), every kernel's
    launch count held at 0: A1 ``abstract_params``, ``abstract_state``,
    ``abstract_cache`` and ``input_specs`` of all ten archs at full width
    and every applicable shape (32 cells; qwen3-moe-235b-a22b's 940 GB of
    parameters among them) allocate nothing on the card (its peak
    allocation does not rise) and hold only meta tensors, each cell's
    logical bytes printed; A2 a real ``make_train_state`` of qwen2-0.5b
    and its ``init_cache`` at prefill_32k (~12.9 GB) on the card have the
    abstract trees' keys, shapes and dtypes leaf for leaf; A3
    ``make_batch`` on the card for every arch at prefill_32k and
    qwen2-0.5b at its three shapes has ``input_specs``' shapes and
    dtypes, tokens in range and a float std within 5% of its scale, and
    equals the host CPU's batch bit for bit.  Three faults planted in
    ``models.api`` (the parameters drawn on the card and moved to meta,
    one leaf cast to bfloat16, the batch drawn on a CUDA generator) must
    each break the gate ``API_FAULTS`` lists and no other.
  * The sharding rules and the logical spec trees (``repro_torch.sharding``,
    ``launch.mesh``, ``Model.param_specs`` / ``cache_specs``,
    ``state_specs``), every kernel's launch count held at 0: S1 the
    persistent bytes per device of all 32 cells on the 16x16 and 2x16x16
    production meshes, from the abstract trees, equal to the reference's
    (``REFERENCE_SHARDED_BYTES``), with no rise of the card's peak
    allocation; S2 qwen2-0.5b's real train state (5.93 GB) and its
    parameters in bfloat16 with the real prefill_32k cache (12.9 GB) cut
    on the card into every device's block on both meshes: each block has
    ``shard_shape``'s shape, each device's blocks sum to S1's figure, and
    a coverage counter raised by one over every block equals everywhere
    the product of the mesh axes the leaf's spec leaves unused.  Three
    faults planted in the rules, the resolution and a spec tree must each
    break the gates ``SHARDING_FAULTS`` lists and no other.
  * The dry-run launcher (``python -m repro_torch.launch.dryrun``), every
    kernel's launch count held at 0: D1 the CLI's ``main`` in one child
    process a held cell (DRYRUN_CELLS: qwen2-0.5b train_4k on both
    meshes and with ``force_scheme=dp``, its prefill_32k and decode_32k,
    mamba2-780m decode_32k, qwen3-moe-235b-a22b train_4k), all at once,
    each with its wall time, a device rise of 0 bytes and 0 launches;
    each record's exact fields equal to the reference's and its FLOPs,
    bytes, collectives and ``predict_cell`` step time within
    DRYRUN_LIMITS of the reference's record (REFERENCE_DRYRUN, from the
    reference's ``run_cell`` under jax 0.9.0), and long_500k's skip
    record; D2 sec5's three what-ifs on the port's qwen3-moe-235b-a22b
    record and ``predict_cell_des`` on its qwen2-0.5b train_4k record,
    within the step-time limit of the reference records' answers.
    Three faults planted in the count and the collectives (the train step
    counted forward only, the totals not divided over the chips, one
    layer's collectives) must each break the gate ``DRYRUN_FAULTS``
    lists.

Any failure exits non-zero.  The line before the last is a JSON object of
the kernels' measurements; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's src/ beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import hashlib
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Simulated seconds of get_workload("hpl").predict(get_platform(p)) from the
# reference package (JAX, float64 on the CPU).
REFERENCE_TIME_S = {
    "bdw-local": 0.058538299545155895,
    "tpu-v5e-pod": 88.82483519304056,
    "syn-mp-2pod-v5e": 168.19366046372835,
    "frontera": 23516.763203358445,
}
# 1e-12 relative for the short runs; Frontera's 24k panels add rounding
# differences (about n_panels * eps at worst), so 1e-10 there.
TOL = {"bdw-local": 1e-12, "tpu-v5e-pod": 1e-12, "syn-mp-2pod-v5e": 1e-12,
       "frontera": 1e-10}
# The 64-row Frontera what-if grid: link_bw scales x gemm_eff values
# (None: Frontera's own), rows in itertools.product order
GRID_LINK_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 3.0, 4.0)
GRID_GEMM_EFF = (0.80, 0.83, 0.86, 0.89, None, 0.94, 0.96, 0.98)
# whatif_grid(get_workload("hpl"), "frontera", axes, mode="abs") from the
# reference package: each row's simulated seconds
REFERENCE_GRID_TIME_S = [
    27512.467452621582, 26576.509984786633, 25706.510829365383,
    24895.815577058594, 24138.63693649391, 23661.068161711064,
    23203.70272250879, 22765.29576974001, 27097.876674362888,
    26161.919661596723, 25291.921268850037, 24481.226289988965,
    23724.052200552105, 23246.493933436057, 22789.13331356019,
    22350.73095195183, 26890.586280754997, 25954.629641811673,
    25084.631938832055, 24273.936914803064, 23516.763203358445,
    23039.210225460865, 22581.852099933323, 22143.45211786345,
    26766.214149818483, 25830.25762983079, 24960.26002173654,
    24149.564978973525, 23392.391189698064, 22914.841357305082,
    22457.48470389512, 22019.08612605648, 26683.300062895687,
    25747.343807149646, 24877.346612194087, 24066.65175408344,
    23309.47786298947, 22831.930096082648, 22374.574393880826,
    21936.176723225217, 26579.65745424214, 25643.70152879786,
    24773.704850265993, 23963.010319835437, 23205.836567677023,
    22728.291550660797, 22270.937198500327, 21832.540816282442,
    26476.015033365304, 25540.05933238852, 24670.063088337225,
    23859.368885586864, 23102.195272364843, 22624.653005238768,
    22167.300003120174, 21728.904909340523, 26424.194419788666,
    25488.238883962233, 24618.242881615424, 23807.548750891812,
    23050.375121312296, 22572.833732529194, 22115.48140543094,
    21677.08695587026]
# The discrete-event HPL at a size users run: Frontera's spec on a 16 x 16
# grid.  Simulated seconds and event count from the reference package
# (pure Python, so the port must equal them bit for bit).
DES_CFG = dict(N=65536, nb=384, P=16, Q=16, lookahead=0)
REFERENCE_DES = {"time_s": 3.394701127703015, "events": 1381183}
# get_workload("hpl").predict_des(get_platform("bdw-local")), reference
REFERENCE_PREDICT_DES = {"time_s": 0.05864729600365412, "events": 10597}
# fit_fastsim_to_des(get_platform("bdw-local")), reference: the DES probe
# times (bit-equal), the fitted scales and the final loss (within 1e-6
# relative: the fit's float64 gradients agree with JAX's to ~1e-9)
REFERENCE_BRIDGE = {
    "probes": [0.012735053669038208, 0.02011167951747036,
               0.021918354342872204],
    "calibration": {"bcast_bw_scale": 13.322869489029895,
                    "swap_bw_scale": 14.250587362886163},
    "loss": 0.0019838668967092524}
BRIDGE_RTOL = 1e-6
# ---- slices 5 and 6 (the transformer step model, fault sweeps,
# representative regions, per-scale contention, the TOP500 fleet).  Every
# REFERENCE_* value below is the reference package's answer (JAX, float64
# on the CPU) for the inputs above it; tests/test_torch_chip_constants.py
# recomputes each one with the reference and holds these copies to it.
# get_workload("transformer").predict(get_platform(p))["step_s"] at the
# workload's default spec, the 18-scenario sweep over tpu-v5e-pod's step
# (link_bw x (1 + 0.1 i), n_layers 2 + i, flops_per_layer x (1 + 0.05 i))
# and d step_s / d link_bw there.
STEP_PLATFORMS = ("tpu-v5e-pod", "syn-torus-fugaku-4k", "syn-torus-bgq-8k",
                  "syn-mp-2pod-v5e")
STEP_GRID_LANES = 18
# One fault scenario of each closed-form kind and one combined, swept by
# sweep_faults on tpu-v5e-pod for HPL (the registry's N=619,520, nb=512,
# 16 x 16 run) and for the transformer (lane 0 is the healthy run).
FAULT_SPECS = [
    {"name": "straggler",
     "faults": [{"kind": "straggler", "rank": 5, "factor": 2.0}]},
    {"name": "link_degrade", "seed": 7,
     "faults": [{"kind": "link_degrade", "link_frac": 0.05, "factor": 0.5}]},
    {"name": "link_flap",
     "faults": [{"kind": "link_flap", "link_frac": 0.1, "factor": 0.5,
                 "period": 0.001, "duty": 0.5, "cycles": 3}]},
    {"name": "latency_jitter",
     "faults": [{"kind": "latency_jitter", "sigma": 0.3}]},
    {"name": "combined", "seed": 7,
     "faults": [{"kind": "straggler", "rank": 3, "factor": 3.0},
                {"kind": "link_degrade", "link_frac": 0.1, "factor": 0.25},
                {"kind": "latency_jitter", "sigma": 0.2}]},
]
# RegionHPLSim on DES_CFG (Frontera's spec): the first REGION panels of
# 171 on the DES, the rest priced by fastsim (time, events, panel marks).
REGION = 12
# fit_contention_at_scale(frontera, 16 ranks, RegionSpec(8, 2), one
# region probe, 12 steps): the fitted overrides and the provenance note.
CONTENTION_FIT = {"at_ranks": 16, "panels": 8, "warmup": 2,
                  "probe": {"N": 3072, "nb": 128, "P": 4, "Q": 4,
                            "lookahead": 0},
                  "steps": 12}
REFERENCE_STEP_S = {
    "tpu-v5e-pod": 0.004003977542605753,
    "syn-torus-fugaku-4k": 0.03162865609031491,
    "syn-torus-bgq-8k": 0.2080447044705882,
    "syn-mp-2pod-v5e": 0.00791175620927242,
}
REFERENCE_STEP_GRID_S = [
    0.002302287437969543, 0.002923560799650515, 0.0034705619635329948,
    0.003961164384162436, 0.004408134814785593, 0.004820835541116751,
    0.005206288277441624, 0.005569862569978699, 0.005915734732453468,
    0.006247201854649212, 0.006566901608392554, 0.006876969251828861,
    0.007179151814349791, 0.007474892494148459, 0.007765393956385786,
    0.008051666439796955, 0.008334564761773265, 0.008614817100092499]
REFERENCE_STEP_GRAD = {"step_s": 0.004003977542605753,
                       "d_link_bw": -7.281777777777778e-14}
REFERENCE_FAULT_SWEEP = {
    "hpl": {
        "time_s": [
            88.82483519304056, 89.66776909211858, 89.75154890016452,
            89.39753525055386, 88.82483519304056, 95.665003508809],
        "slowdown_vs_healthy": [
            1.0, 1.0094898447854825, 1.0104330473015792, 1.006447521757498,
            1.0, 1.0770073853883646]},
    "transformer": {
        "time_s": [
            0.004003977542605753, 0.0041311550852115055, 0.004611803462605753,
            0.00437960804927242, 0.004003977542605753, 0.007639007187817258],
        "slowdown_vs_healthy": [
            1.0, 1.0317628011776976, 1.1518055267623786, 1.0938143390340322,
            1.0, 1.9078546536616838]},
}
REFERENCE_REGION = {
    "time_s": 3.492313662762151, "events": 100803,
    "marks": [
        0.05267713864718719, 0.08755134061158291, 0.1228064075359786,
        0.15661709286037412, 0.1930398777847695, 0.2271212446691648,
        0.2619523146979091, 0.2970067008779572, 0.3323052323623529,
        0.36708017280674904, 0.40075040456173155, 0.43046109697615065]}
REFERENCE_CONTENTION = {
    "overrides": {"bcast_bw_scale": 2.9829309453194837,
                  "swap_bw_scale": 2.9829277449834914},
    "note": "region-fit panels=8 warmup=2 probes=1 fields="
            "bcast_bw_scale,swap_bw_scale"}
# predict_fleet(load_sample()) at the library's default FleetTuning():
# the bucket, the family factors, the medians and, per machine in the
# report's order, [name, split, predicted TFLOP/s, calibrated TFLOP/s].
REFERENCE_FLEET = {
    "bucket": [4091, 32, 32], "compiles": 1,
    "median_abs_err": 0.05632630580837526,
    "heldout_median_abs_err": 0.07712678548482028,
    "factors": {
        "__global__": 1.020883645165437,
        "aries": 1.0133394527587665,
        "bluegene": 1.0305713659772109,
        "custom": 1.067121619308929,
        "ethernet": 0.7659216099159046,
        "infiniband": 0.9999477064944579,
        "omnipath": 1.086683243262083,
        "slingshot": 0.881070980318537,
        "tofu": 1.0342017257178084,
    },
    "machines": [
        ["r001-fugaku", "train", 399557.44582924026, 413223.00000000006],
        ["r002-summit", "train", 132984.87206420163, 132977.91781905733],
        ["r003-sierra", "test", 88119.77291037035, 88115.16481853729],
        ["r004-sunway-taihulight", "train",
         80297.57063959278, 85687.27360749537],
        ["r005-tianhe-2a", "test", 75677.913582269, 80757.53768783208],
        ["r006-hpc5", "train", 36784.161744681405, 36782.23817191535],
        ["r007-selene", "test", 22785.969377606874, 22784.777819390943],
        ["r008-frontera", "train", 22758.567463590472, 22757.377338316684],
        ["r009-marconi-100", "test", 20101.202363217977, 20100.15120088079],
        ["r010-piz-daint", "train", 19935.38214130081, 20201.30922960265],
        ["r011-trinity", "test", 21427.642702984656, 21713.475730552847],
        ["r012-ai-bridging-cloud-infrastructure-abci", "train",
         20993.37367094304, 20992.27585384063],
        ["r013-supermuc-ng", "train", 17321.346241278596, 18822.816711138115],
        ["r014-lassen", "test", 16308.18595123026, 16307.333139017837],
        ["r015-pangea-iii", "train", 17860.934010851684, 17860.0],
        ["r016-sequoia", "train", 16663.765913693893, 17173.2],
        ["r017-cori", "train", 14418.044346889523, 14610.373168328655],
        ["r018-nurion", "test", 12334.145718196021, 13403.309471916386],
        ["r019-oakforest-pacs", "train",
         12190.086460560258, 13246.762690606827],
        ["r020-hpc4", "test", 13299.138106123079, 13298.44264757082],
        ["r021-tera-1000-2", "train", 12261.373515885172, 13084.376761223002],
        ["r022-stampede2", "test", 8015.338283094995, 8710.133801316406],
        ["r023-k-computer", "test", 9590.015447972863, 9918.010525953976],
        ["r024-taiwania-2", "train", 8587.303815419293, 8586.854755199629],
        ["r025-mira", "test", 8331.882956846946, 8586.6],
        ["r026-tsubame-3.0", "train", 8244.125680394416, 8958.75323223123],
        ["r027-aimos", "test", 7869.558216314093, 7869.1466895278945],
        ["r028-belenos", "train", 7882.845574812285, 7882.433353183531],
        ["r029-marenostrum", "test", 6714.039622325841, 7296.034352179176],
        ["r030-flow", "train", 6053.900694382428, 6260.954545454546],
        ["r031-marconi-intel-xeon-phase-a3", "train",
         6193.390716427888, 6730.253910517133],
        ["r032-juwels-module-1", "test", 5465.676836055642, 5465.391016653723],
        ["r033-theta", "test", 5728.072321276118, 5804.481671404578],
        ["r034-cloud-hpc-cluster-a", "train",
         6689.333815835788, 5123.5053254898485],
        ["r035-hazel-hen", "train", 5565.953229833137, 5640.2],
        ["r036-cobra", "test", 5840.458309074888, 6346.728177442481],
        ["r037-shaheen-ii", "test", 5481.66011500576, 5554.782461149494],
        ["r038-electra", "train", 5657.25698193954, 5656.961144140202],
        ["r039-mahti", "test", 5534.59446277098, 5534.3050394247675],
        ["r040-cheyenne", "train", 4020.6842339414243, 4020.4739782681536],
        ["r041-eagle", "test", 4136.1168667315205, 4135.900574681227],
        ["r042-vulcan", "train", 4165.941478423473, 4293.3],
        ["r043-hosting-services-cluster", "test",
         4374.602132122674, 3350.602307776948],
        ["r044-niagara", "train", 2748.019907030217, 2747.876203435979],
        ["r045-quartz", "train", 2422.048942338593, 2632.0],
        ["r046-mistral", "test", 2522.708347428164, 2522.5764261652166],
        ["r047-lomonosov-2", "train", 2893.035116356007, 2892.8838294081165],
        ["r048-cloud-hpc-cluster-b", "train",
         3760.555233681396, 2880.290518758936],
        ["r049-web-services-cluster", "test",
         2883.8187786034555, 2208.7791216136766],
        ["r050-shasta-early-access-system", "train",
         1793.2720919133853, 1580.0],
        ["r051-astra", "test", 1666.5150955179356, 1666.427947601552],
    ]}
# ---- slice 7 (the prediction service and the campaign layer).  As
# above, every REFERENCE_* value is the reference package's answer and
# tests/test_torch_chip_constants.py holds these copies to it.
# One mixed wave through PredictionService(cache=True): HPL on three
# shape buckets, the transformer on two fabrics, a straggler and one DES
# breakdown; the requests whose request_key digests are held to the
# reference's; the reference's acceptance campaign (tests/test_campaign.py:
# 2 workloads x 3 platforms x N in {1536, 1920} x {no fault, straggler
# 1.5} x seeds {0, 1}, 36 runs); the two-edition TOP500 study as the CLI
# runs it (--limit 12 --max-ranks 256).
SERVE_WAVE = [
    {"rid": 0, "platform": "bdw-local"},
    {"rid": 1, "platform": "tpu-v5e-pod"},
    {"rid": 2, "platform": "syn-mp-2pod-v5e"},
    {"rid": 3, "workload": "transformer", "platform": "tpu-v5e-pod"},
    {"rid": 4, "workload": "transformer", "platform": "syn-torus-fugaku-4k"},
    {"rid": 5, "platform": "bdw-local",
     "faults": {"seed": 0, "name": "", "faults": [
         {"kind": "straggler", "start": 0.0, "duration": 0.0, "rank": 0,
          "node": -1, "link_frac": 0.0, "factor": 1.5, "period": 0.0,
          "duty": 0.5, "cycles": 0, "sigma": 0.0}]}},
    {"rid": 6, "platform": "bdw-local", "breakdown": True},
]
SERVE_KEY_RIDS = (1, 4, 5)
CAMPAIGN_ACCEPT = {
    "workloads": ["hpl", "transformer"],
    "platforms": ["tpu-v5e-pod", "syn-torus-fugaku-4k", "syn-torus-bgq-8k"],
    "axes": {"N": [1536, 1920]},
    "faults": [None, {"seed": 0, "name": "", "faults": [
        {"kind": "straggler", "start": 0.0, "duration": 0.0, "rank": 0,
         "node": -1, "link_frac": 0.0, "factor": 1.5, "period": 0.0,
         "duty": 0.5, "cycles": 0, "sigma": 0.0}]}],
    "seeds": [0, 1]}
EDITION_STUDY = {"editions": ["2020_06", "2020_11"], "limit": 12,
                 "max_ranks": 256, "panels_cap": 2048}
# The wave's times, stats (first pass, resubmitted, 8 identical requests)
# and digests; each campaign's run records as a sha256 over the records
# with their result floats nulled (chip_smoke.result_floats) plus those
# floats in order, the acceptance campaign's dispatch gates, and the
# study's drift table (predicted and published drift per machine, the
# calibration factor per fabric family in each edition).
REFERENCE_SERVE = {
    "time_s": [
        0.058538299545155895, 88.82483519304056, 168.19366046372835,
        0.004003977542605753, 0.03162865609031491, 0.06038860573751427,
        0.058538299545155895],
    "stats": {
        "requests": 7,
        "batches": 1,
        "scenarios": 7,
        "sweeps": 2,
        "des_breakdowns": 1,
        "retries": 0,
        "fallbacks": 0,
        "errors": 0,
        "cache_hits": 0,
        "cache_misses": 7,
        "coalesced": 0,
    },
    "cached_stats": {
        "requests": 14,
        "batches": 2,
        "scenarios": 14,
        "sweeps": 2,
        "des_breakdowns": 1,
        "retries": 0,
        "fallbacks": 0,
        "errors": 0,
        "cache_hits": 7,
        "cache_misses": 7,
        "coalesced": 0,
    },
    "coalesced_stats": {
        "requests": 8,
        "batches": 1,
        "scenarios": 8,
        "sweeps": 1,
        "des_breakdowns": 0,
        "retries": 0,
        "fallbacks": 0,
        "errors": 0,
        "cache_hits": 0,
        "cache_misses": 8,
        "coalesced": 7,
    },
    "keys": {
        "1": ("7497d87cb2d766f1552990361d9568c6"
              "f33e25bf9dcea5fbb1dbb7d9dc902c60"),
        "4": ("b689526dfd5eb3633b002cda75b6c3f5"
              "d9fe135e42a9279b65e9aa4904282282"),
        "5": ("4d54a5a34304b779d32e93e58352d0eb"
              "541577e987e411d16d65cd77b91ff2db"),
    },
}
REFERENCE_CAMPAIGN = {
    "skeleton_sha256": ("61787c917b733475bf647b6729f7c311"
                        "34d08960f82e9f32efd6a57a66fe0742"),
    "dispatches": {
        "fastsim_dispatches": 1,
        "stepsim_dispatches": 1,
        "serve_sweeps": 2,
    },
    "floats": [
        68.90027956830352, 0.06890027956830351, 0.035115358938442295,
        68.90027956830352, 0.06890027956830351, 0.035115358938442295,
        68.86420968694777, 0.06886420968694777, 0.03513375175579157,
        68.86420968694777, 0.06886420968694777, 0.03513375175579157,
        111.97785875955144, 0.11197785875955144, 0.04218799727313989,
        111.97785875955144, 0.11197785875955144, 0.04218799727313989,
        111.92208780673303, 0.11192208780673303, 0.04220901961869769,
        111.92208780673303, 0.11192208780673303, 0.04220901961869769,
        44.69062409772786, 0.04469062409772786, 0.0541379337802313,
        44.69062409772786, 0.04469062409772786, 0.0541379337802313,
        44.69049714725104, 0.04469049714725104, 0.05413808756765695,
        44.69049714725104, 0.04469049714725104, 0.05413808756765695,
        72.27060734752075, 0.07227060734752075, 0.06536712189623049,
        72.27060734752075, 0.07227060734752075, 0.06536712189623049,
        72.27039419486927, 0.07227039419486926, 0.06536731468852819,
        72.27039419486927, 0.07227039419486926, 0.06536731468852819,
        21.719732517279233, 0.021719732517279232, 0.11139446796019192,
        21.719732517279233, 0.021719732517279232, 0.11139446796019192,
        21.71957146571576, 0.021719571465715758, 0.11139529395499828,
        21.71957146571576, 0.021719571465715758, 0.11139529395499828,
        35.14762613741561, 0.0351476261374156, 0.1344079848104178,
        35.14762613741561, 0.0351476261374156, 0.1344079848104178,
        35.14735567029729, 0.03514735567029729, 0.1344090191112816,
        35.14735567029729, 0.03514735567029729, 0.1344090191112816,
        0.02858652105992789, 0.004003977542605753, 0.004003977542605753,
        16367724.169938715, 0.02858652105992789, 0.004003977542605753,
        0.004003977542605753, 16367724.169938715, 0.042209436618326567,
        0.004067566313908629, 0.004067566313908629, 16111845.497369353,
        0.042209436618326567, 0.004067566313908629, 0.004067566313908629,
        16111845.497369353, 0.21097185870251517, 0.03162865609031491,
        0.03162865609031491, 33152720.65325238, 0.21097185870251517,
        0.03162865609031491, 0.03162865609031491, 33152720.65325238,
        0.28325807545825826, 0.035335742959001784, 0.035335742959001784,
        29674655.524198484, 0.28325807545825826, 0.035335742959001784,
        0.035335742959001784, 29674655.524198484, 0.5292154889506702,
        0.2080447044705882, 0.2080447044705882, 10080295.027631812,
        0.5292154889506702, 0.2080447044705882, 0.2080447044705882,
        10080295.027631812, 0.6053696932903697, 0.27280969270588235,
        0.27280969270588235, 7687234.200512631, 0.6053696932903697,
        0.27280969270588235, 0.27280969270588235, 7687234.200512631],
}
REFERENCE_EDITION_STUDY = {
    "skeleton_sha256": ("4306b319c0fcaede50c681049d2ffab0"
                        "fcf95bcbf45f4bdd9c64cbccad377382"),
    "machines": {
        "selene": [1.3197877718348794, 1.3009427121102248],
        "fugaku": [0.0637258441027122, 0.0637258441027122],
        "frontera": [0.0412860056978696, 0.0],
        "summit": [0.041286005697869464, 0.0],
        "sierra": [0.04128600569786945, 0.0],
        "hpc5": [0.041286005697869374, 0.0],
        "marconi-100": [0.041286005697869305, 0.0],
        "piz-daint": [0.0, 0.0],
        "sunway-taihulight": [0.0, 0.0],
        "tianhe-2a": [0.0, 0.0],
    },
    "factors": {
        "__global__": [1.0383398945659839, 1.062648202404732],
        "aries": [1.062648202404732, 1.062648202404732],
        "custom": [1.1546113964996114, 1.1546113964996114],
        "infiniband": [0.9963240706414308, 1.0374583118988574],
        "tofu": [1.0383398945659839, 1.0564868512121692],
    },
    "floats": [
        415530.0, 400186.8773169768, 594.0, 415530.0, 0.0, 132817.8378251317,
        133307.8681313239, 18.0, 148600.0, -0.10620566739480693,
        87956.91029808264, 88281.42658588607, 16.875, 94640.0,
        -0.07061590978357309, 93014.6, 80559.22562516584, 160.0, 93014.6, 0.0,
        87524.49975988809, 75804.29227117675, 62.5, 61444.5,
        0.4244480752530835, 36783.53598544582, 36919.24853503206, 7.109375,
        35450.0, 0.037617376176186795, 22067.172972166503, 22148.58962301264,
        1.09375, 27580.0, -0.19988495387358582, 22693.67243918194,
        22777.40055459246, 31.28125, 23516.4, -0.03498526818807558,
        20074.23860157536, 20148.302337663703, 3.828125, 21640.0,
        -0.07235496295862485, 21230.0, 19978.38979255536, 11.140625, 21230.0,
        0.0, 22788.375342373143, 21444.891442721993, 56.2421875, 20158.7,
        0.13044865702516245, 21001.14483710227, 21078.62838602483, 4.25,
        19880.0, 0.05639561554840396, 442010.0, 418377.18992229394, 621.0,
        442010.0, 0.0, 138301.35583435878, 133307.8681313239, 18.0, 148600.0,
        -0.06930446948614549, 91588.29979781627, 88281.42658588607, 16.875,
        94640.0, -0.032245352939388475, 93014.6, 80559.22562516584, 160.0,
        93014.6, 0.0, 51191.158019797, 49342.85786009266, 2.1875, 63460.0,
        -0.19333189379456345, 87524.49975988809, 75804.29227117675, 62.5,
        61444.5, 0.4244480752530835, 51053.221618438176, 49209.90176944613,
        6.5625, 44120.0, 0.15714464230367578, 38302.18126172872,
        36919.24853503206, 7.109375, 35450.0, 0.08045645308120512,
        23630.603528811593, 22777.40055459246, 31.28125, 23516.4,
        0.0048563355280396335, 40909.359802058425, 39432.29268382083,
        7.92578125, 22400.0, 0.8263107054490368, 20903.023730860386,
        20148.302337663703, 3.828125, 21640.0, -0.03405620467373446, 21230.0,
        19978.38979255536, 11.140625, 21230.0, 0.0],
}
# ---- slice 8c-p (the dry-run-record predictions and the fault-tolerance
# layer).  The repository holds no dry-run record and the port cannot
# compile one yet, so the phase writes these synthetic records in the
# reference's schema (launch/dryrun.py: per-cell totals over all chips,
# ring wire bytes per collective op) into a temporary directory:
# (a) the record of tests/test_system.py:124-130; (b) qwen2-0.5b's train
# cell on one pod and on two, with an all-reduce (the gradient, split
# between the layers and the tail), an all-gather and a reduce-scatter;
# (c) qwen3-moe-235b-a22b's train cell, which benchmarks/sec5_whatif.py
# asks for, at all 94 layers, with the experts' all-to-all; (d) a
# qwen2-0.5b prefill cell (no tail: its all-reduce stays in the layers)
# with a collective-permute.  Totals are of the order 6 N T (train) or
# 2 N T (prefill) for the shape's 1,048,576 tokens; they need only be
# the same on both sides.  As above, every REFERENCE_RECORD_* value is
# the reference package's answer on these records and
# tests/test_torch_chip_constants.py holds these copies to it.
DRYRUN_RECORDS = {
    "x__train_4k__16x16": {
        "arch": "x", "shape": "train_4k", "mesh": "16x16", "chips": 256,
        "kind": "train",
        "roofline": {"hlo_flops_total": 2.56e17, "hlo_bytes_total": 2.56e14},
        "collectives": {"all-reduce": {"count": 10, "wire_bytes": 1e9}}},
    "qwen2-0.5b__train_4k__16x16": {
        "arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16",
        "chips": 256, "kind": "train",
        "roofline": {"hlo_flops_total": 4.2e15, "hlo_bytes_total": 3.0e14},
        "collectives": {
            "all-reduce": {"count": 48, "wire_bytes": 3.9e9},
            "all-gather": {"count": 96, "wire_bytes": 1.2e9},
            "reduce-scatter": {"count": 48, "wire_bytes": 1.2e9}}},
    "qwen2-0.5b__train_4k__2x16x16": {
        "arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "2x16x16",
        "chips": 512, "kind": "train",
        "roofline": {"hlo_flops_total": 4.2e15, "hlo_bytes_total": 3.0e14},
        "collectives": {
            "all-reduce": {"count": 48, "wire_bytes": 3.9e9},
            "all-gather": {"count": 96, "wire_bytes": 1.2e9},
            "reduce-scatter": {"count": 48, "wire_bytes": 1.2e9}}},
    "qwen3-moe-235b-a22b__train_4k__16x16": {
        "arch": "qwen3-moe-235b-a22b", "shape": "train_4k", "mesh": "16x16",
        "chips": 256, "kind": "train",
        "roofline": {"hlo_flops_total": 1.5e17, "hlo_bytes_total": 2.0e16},
        "collectives": {"all-reduce": {"count": 188, "wire_bytes": 2.0e10},
                        "all-to-all": {"count": 376, "wire_bytes": 6.0e10}}},
    "qwen2-0.5b__prefill_32k__16x16": {
        "arch": "qwen2-0.5b", "shape": "prefill_32k", "mesh": "16x16",
        "chips": 256, "kind": "prefill",
        "roofline": {"hlo_flops_total": 2.5e15, "hlo_bytes_total": 1.0e14},
        "collectives": {
            "all-reduce": {"count": 48, "wire_bytes": 2.0e9},
            "collective-permute": {"count": 24, "wire_bytes": 2.5e8}}},
}
# the three what-ifs of benchmarks/sec5_whatif.py:47-49 on (c); the DES
# cells (each a 256- or 512-rank mesh at the arch's full depth); sec5's
# straggler call; tests/test_faults.py:374-386's two fault-impact calls
# (the fastsim one on the default transformer, a fail-stop on the DES)
# and :390-393's restart scenario
RECORD_WHATIF_CELL = ("qwen3-moe-235b-a22b", "train_4k", "16x16")
RECORD_WHATIF = {"ici_x2": {"link_bw_scale": 2.0},
                 "hbm_x2": {"hbm_bw_scale": 2.0},
                 "peak_x2": {"peak_scale": 2.0}}
RECORD_DES = [("qwen2-0.5b", "train_4k", "16x16"),
              ("qwen2-0.5b", "train_4k", "2x16x16"),
              ("qwen3-moe-235b-a22b", "train_4k", "16x16"),
              ("qwen2-0.5b", "prefill_32k", "16x16")]
RECORD_STRAGGLER = {"arch": "qwen2-0.5b", "shape": "train_4k",
                    "slowdown": 3.0}
FAULT_IMPACT = {
    "fastsim": {"workload": {}, "platform": "tpu-v5e-pod", "des": False,
                "faults": {"seed": 0, "name": "", "faults": [
                    {"kind": "straggler", "start": 0.0, "duration": 0.0,
                     "rank": 0, "node": -1, "link_frac": 0.0, "factor": 3.0,
                     "period": 0.0, "duty": 0.5, "cycles": 0,
                     "sigma": 0.0}]}},
    "fail_stop": {"workload": {"mesh": [2, 4], "num_layers": 3},
                  "platform": "tpu-v5e-pod", "des": True,
                  "faults": {"seed": 0, "name": "", "faults": [
                      {"kind": "fail_stop", "start": 0.0, "duration": 0.0,
                       "rank": 3, "node": -1, "link_frac": 0.0,
                       "factor": 1.0, "period": 0.0, "duty": 0.5,
                       "cycles": 0, "sigma": 0.0}]}},
}
RESTART_SCENARIO = {
    "faults": {"seed": 0, "name": "", "faults": [
        {"kind": "fail_stop", "start": 0.0, "duration": 0.0, "rank": 18,
         "node": -1, "link_frac": 0.0, "factor": 1.0, "period": 0.0,
         "duty": 0.5, "cycles": 0, "sigma": 0.0},
        {"kind": "fail_stop", "start": 0.0, "duration": 0.0, "rank": -1,
         "node": 1, "link_frac": 0.0, "factor": 1.0, "period": 0.0,
         "duty": 0.5, "cycles": 0, "sigma": 0.0}]},
    "global_batch": 1792, "resume_step": 500, "old_mesh": [16, 16],
    "ranks_per_node": 4}
# The reference's answers: predict_cell's StepPrediction on every record
# (as dataclasses.asdict), whatif's what-if part (its baseline and
# baseline_s are RECORD_WHATIF_CELL's predict_cell answer and step_s, so
# record_phase adds them from REFERENCE_RECORD_PREDICT), the DES results,
# the straggler what-if (its baseline_s is REFERENCE_RECORD_DES's 16x16
# cell's step_s, which record_phase adds),
# both fault impacts (the fail-stop one's blowup is inf, checked apart)
# and the restart plan.
REFERENCE_RECORD_PREDICT = {
    "x__train_4k__16x16": {
        "compute_s": 5.640157924421884,
        "memory_s": 0.4788240082357729,
        "collective_s": 0.011141111111111112,
        "step_s": 5.643500257755218,
        "bound_s": 5.640157924421884,
        "breakdown": {
            "all-reduce": 0.011141111111111112,
            "compute": 5.640157924421884,
            "memory": 0.4788240082357729,
        },
    },
    "qwen2-0.5b__train_4k__16x16": {
        "compute_s": 0.09253384094754653,
        "memory_s": 0.5611218846512964,
        "collective_s": 0.07006000000000001,
        "step_s": 0.5821398846512964,
        "bound_s": 0.5611218846512964,
        "breakdown": {
            "all-reduce": 0.04336333333333334,
            "all-gather": 0.013348333333333334,
            "reduce-scatter": 0.013348333333333334,
            "compute": 0.09253384094754653,
            "memory": 0.5611218846512964,
        },
    },
    "qwen2-0.5b__train_4k__2x16x16": {
        "compute_s": 0.04626692047377327,
        "memory_s": 0.2805609423256482,
        "collective_s": 0.07006000000000001,
        "step_s": 0.3015789423256482,
        "bound_s": 0.2805609423256482,
        "breakdown": {
            "all-reduce": 0.04336333333333334,
            "all-gather": 0.013348333333333334,
            "reduce-scatter": 0.013348333333333334,
            "compute": 0.04626692047377327,
            "memory": 0.2805609423256482,
        },
    },
    "qwen3-moe-235b-a22b__train_4k__16x16": {
        "compute_s": 3.3047800338409474,
        "memory_s": 37.408125643419766,
        "collective_s": 0.8889338888888888,
        "step_s": 37.67480581008643,
        "bound_s": 37.408125643419766,
        "breakdown": {
            "all-reduce": 0.2222522222222222,
            "all-to-all": 0.6666816666666666,
            "compute": 3.3047800338409474,
            "memory": 37.408125643419766,
        },
    },
    "qwen2-0.5b__prefill_32k__16x16": {
        "compute_s": 0.05507966723068246,
        "memory_s": 0.1870406282170988,
        "collective_s": 0.025031,
        "step_s": 0.1945499282170988,
        "bound_s": 0.1870406282170988,
        "breakdown": {
            "all-reduce": 0.022252222222222222,
            "collective-permute": 0.002778777777777778,
            "compute": 0.05507966723068246,
            "memory": 0.1870406282170988,
        },
    },
}
REFERENCE_RECORD_WHATIF = {
    "ici_x2": {
        "whatif_s": 37.5414724767531,
        "speedup": 1.0035516276943026,
        "whatif": {
            "compute_s": 3.3047800338409474,
            "memory_s": 37.408125643419766,
            "collective_s": 0.4444894444444444,
            "step_s": 37.5414724767531,
            "bound_s": 37.408125643419766,
            "breakdown": {
                "all-reduce": 0.11114111111111111,
                "all-to-all": 0.3333483333333333,
                "compute": 3.3047800338409474,
                "memory": 37.408125643419766,
            },
        },
    },
    "hbm_x2": {
        "whatif_s": 18.97074298837655,
        "speedup": 1.9859425555008539,
        "whatif": {
            "compute_s": 3.3047800338409474,
            "memory_s": 18.704062821709883,
            "collective_s": 0.8889338888888888,
            "step_s": 18.97074298837655,
            "bound_s": 18.704062821709883,
            "breakdown": {
                "all-reduce": 0.2222522222222222,
                "all-to-all": 0.6666816666666666,
                "compute": 3.3047800338409474,
                "memory": 18.704062821709883,
            },
        },
    },
    "peak_x2": {
        "whatif_s": 37.67480581008643,
        "speedup": 1.0,
        "whatif": {
            "compute_s": 1.6523900169204737,
            "memory_s": 37.408125643419766,
            "collective_s": 0.8889338888888888,
            "step_s": 37.67480581008643,
            "bound_s": 37.408125643419766,
            "breakdown": {
                "all-reduce": 0.2222522222222222,
                "all-to-all": 0.6666816666666666,
                "compute": 1.6523900169204737,
                "memory": 37.408125643419766,
            },
        },
    },
}
REFERENCE_RECORD_DES = {
    "qwen2-0.5b__train_4k__16x16": {
        "step_s": 0.7070018846512504,
        "events": 1911520,
        "min_finish": 0.7070018846512504,
    },
    "qwen2-0.5b__train_4k__2x16x16": {
        "step_s": 1.0576398561523,
        "events": 4883064,
        "min_finish": 0.4265072914300458,
    },
    "qwen3-moe-235b-a22b__train_4k__16x16": {
        "step_s": 39.20294342119574,
        "events": 5545280,
        "min_finish": 39.20294342119574,
    },
    "qwen2-0.5b__prefill_32k__16x16": {
        "step_s": 0.24001662821708708,
        "events": 970624,
        "min_finish": 0.24001662821708708,
    },
}
REFERENCE_RECORD_STRAGGLER = {
    "straggler_s": 1.8292456539539146,
    "blowup": 2.5873278327344833,
    "verdict": "evict",
}
REFERENCE_RECORD_FAULTS = {
    "fastsim": {
        "baseline_s": 0.004003977542605753,
        "faulted_s": 0.004258332627817259,
        "backend": "fastsim",
        "blowup": 1.0635256023553954,
        "verdict": "tolerate",
    },
    "fail_stop": {
        "baseline_s": 0.003094623472261704,
        "faulted_s": 0.002612938850039482,
        "backend": "des",
        "failed": True,
        "n_finished": 0,
        "verdict": "restart",
    },
}
REFERENCE_RECORD_PLAN = {
    "old_mesh": (16, 16),
    "new_mesh": (14, 16),
    "resume_step": 500,
    "dp_size_old": 16,
    "dp_size_new": 14,
    "per_device_batch_new": 128,
    "notes": ("evicted dp rows [0, 1] (5 dead chips); same global "
              "batch; data pipeline replays from resume_step with "
              "dp_size_new shards; params re-sharded at restore"),
}
# Published HBM rate of one H100 SXM (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
# Published dense peaks of one H100 SXM (NVIDIA data sheet), FLOP/s: bf16 on
# the tensor cores, float32 on the CUDA cores.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (F, L, density): tests/test_kernels.py's shapes, then a ragged one
TEST_SHAPES = [(64, 128, 0.1), (256, 256, 0.03), (8, 128, 0.5),
               (1000, 300, 0.05)]
LM_ARCH = "qwen2-0.5b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_SLOTS = 8, 128, 32, 4
SERVE_SPEC = (SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_SLOTS)
# (B, S, G, R, hd): tests/test_kernels.py's flash shapes, a ragged one, the
# shape ServeEngine gives the kernel (one 128-token prompt at a time), and
# qwen2-0.5b's 4 x 2048 prefill
FLASH_SERVED = (1, SERVE_PROMPT, 2, 7, 64)
MOE_ARCH, VLM_ARCH = "phi3.5-moe-42b-a6.6b", "llava-next-mistral-7b"
# phi3.5-moe keeps 8 of its 32 layers: the whole model (~84 GB even in
# bf16, ~170 GB of float32 weights) does not fit one 80 GB card
MOE_LAYERS = 8
# (requests, prompt, new tokens, slots) of the MoE and VLM serve phases
MOE_SERVE = (4, 128, 16, 4)
VLM_SERVE = (2, 128, 16, 2)
MOE_B, MOE_S, MOE_DECODE = 2, 2048, 16
VLM_PROMPT, VLM_DECODE = 128, 4
# the flash shapes of their prefills: phi3.5-moe's 2 x 2048, and llava's
# 2,880 image + 128 text positions (not a multiple of the 128-row tile)
FLASH_MOE = (MOE_B, MOE_S, 8, 4, 128)
FLASH_VLM = (1, 2880 + VLM_PROMPT, 8, 4, 128)
# R = 16 and R = 48 query heads a group at hd 128, reduced widths: the
# group ratios of qwen3-moe-235b-a22b (64 heads in 4 KV groups) and
# granite-34b (MQA), both archs the serving launcher takes
FLASH_WIDE_R = [(1, 256, 4, 16, 128), (1, 256, 1, 48, 128)]
FLASH_SHAPES = [(1, 128, 1, 1, 64), (2, 256, 2, 4, 64), (1, 256, 1, 7, 32),
                (1, 512, 4, 2, 128), (1, 200, 2, 7, 64), FLASH_SERVED,
                FLASH_MOE, FLASH_VLM] + FLASH_WIDE_R
FLASH_PREFILL = (4, 2048, 2, 7, 64)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# head_dim 80: stablelm-3b (dense, 32 heads of 80, served as qwen2-0.5b is)
# and zamba2-2.7b (hybrid: 54 Mamba-2 layers, one shared attention block
# of 32 heads of 80 after every 6, scored on HYBRID_B x HYBRID_S tokens and
# served on HYBRID_SERVE), both at full width and depth
STABLELM_ARCH, HYBRID_ARCH = "stablelm-3b", "zamba2-2.7b"
HYBRID_B, HYBRID_S = 4, 2048
HYBRID_SERVE = (4, 128, 16, 4)
# their flash shapes: zamba2's loss (G = 32, R = 1) and stablelm-3b's served
# prompt, and a ragged shape: (B, Sq, G, R, hd) and Sk, Sq and Sk neither a
# multiple of the 128-key tile nor equal
FLASH_HYBRID = (HYBRID_B, HYBRID_S, 32, 1, 80)
FLASH_STABLELM = (1, SERVE_PROMPT, 32, 1, 80)
FLASH_RAGGED_80 = ((2, 300, 4, 3, 80), 177)
# launches on the new paths, as the configs give them: zamba2's Model.loss
# runs the scan once an ssm layer and flash once a group of 6; stablelm-3b's
# engine runs flash once a layer a prefill, 8 prefills
HYBRID_LOSS_LAUNCHES = {"ssd_scan": 54, "flash_attention_fwd": 9}
STABLELM_SERVE_LAUNCHES = 32 * SERVE_REQUESTS
# the encdec family: whisper-medium at full width, its 24 encoder and 24
# decoder layers cut to ENCDEC_LAYERS each, scored on ENCDEC_B sequences of
# Whisper's 448-token text context, each behind its own 1500 seeded encoder
# frames (the config's encoder_seq; arXiv:2212.04356 gives both contexts);
# G2's cached path prefills the first ENCDEC_S - ENCDEC_DECODE tokens and
# decodes the rest teacher-forced.  Most of the phase's wall is the host
# CPU's float32 baselines (one loss, a 4-request engine), which scale with
# depth; the cut keeps the whole script well inside its time limit
ENCDEC_ARCH = "whisper-medium"
ENCDEC_LAYERS = 8
ENCDEC_B, ENCDEC_S, ENCDEC_DECODE = 4, 448, 16
ENCDEC_SERVE = (4, 128, 16, 4)
# the faults planted on the card side, and the gates each must break
ENCDEC_FAULTS = {"cross_attention_zeroed": ("G1", "G3"),
                 "encoder_causal": ("G1", "G3"),
                 "decode_position_off_by_one": ("G2",),
                 "cross_cache_rolled": ("G2",)}
# the serving launcher (``python -m repro_torch.launch.serve``): L1 serves
# LAUNCH_ARCH at full width at the launcher's defaults, (requests, prompt,
# new tokens, slots) = LAUNCH_L1 with a cache of prompt + new + 1; L2 every
# arch at ``--smoke --requests 2 --batch-slots 2``.  llava's 8-token image
# prefix puts L2's last six decode steps past that cache
LAUNCH_ARCH = "qwen2-0.5b"
LAUNCH_L1 = (8, 32, 16, 4)
LAUNCH_L2 = (2, 32, 16, 2)
LAUNCH_PAST = "llava-next-mistral-7b"
# the faults planted on the card side: (the check they run in, the gates
# each must break; every other gate of that run must pass).  All run in
# float32, where the tokens must equal the host's: the decode faults on
# LAUNCH_PAST in L2, the flash fault in L1
LAUNCH_FAULTS = {"decode_row_wrapped": ("L2", ("logits", "tokens")),
                 "rope_at_clamped_row": ("L2", ("logits", "tokens")),
                 "flash_layer_zeroed": ("L1", ("tokens",))}
LAUNCH_LINE = re.compile(r"\[serve\] (\d+) requests, (\d+) tokens in "
                         r"([\d.]+)s \(([\d.]+) tok/s\) — stats (\{.*\})$")
# The host side of training: the data pipeline and checkpoints of a
# full-width qwen2-0.5b train state (494,147,456 float32 parameters and
# AdamW's m and v).  C1: the SHA-256 of each global batch's int64 bytes,
# computed from the reference's ``repro.data``
# (tests/test_torch_data.py recomputes them)
CKPT_ARCH = "qwen2-0.5b"
CKPT_DATA = {"vocab_size": 151936, "seq_len": 2048, "global_batch": 4,
             "seed": 0}
REFERENCE_CKPT_BATCH_SHA256 = {
    0: "aef5d2593f50c4fc503d860e088fe3fc8e76d9e40b6c4ada59e6fa2aaed4dd3a",
    1: "882a7b9d1d54fabd5ad63f77e19dde3f1cd3a6d4bc5470f31fb30979d0574b88"}
CKPT_DP = (1, 2, 4)
# the faults' runs: reduced qwen2-0.5b on batches of this pipeline
CKPT_FAULT_DATA = {"vocab_size": 512, "seq_len": 256, "global_batch": 4,
                   "seed": 0}
# the step count a saved state carries (a state mid-run: its moments are
# filled from the seed as well, so that m and v differ)
CKPT_MID_STEP = 7
# the faults planted in the code under test, each with the gates it must
# break (every other gate of that run must pass): a high exponent bit of
# one element of the final norm's scale flipped in step 1's file after the
# save; restore handing back m and v crosswise; the async save taking its
# host copy in its thread
CKPT_FAULTS = {"flip_bit": ("C2", "C3"), "swap_moments": ("C2",),
               "lazy_snapshot": ("C4",)}
CKPT_FLIP = (".params/final_norm/scale", 0, 29)
# The training step: full-width qwen2-0.5b (AdamW, remat "dots_nb") on one
# global batch of 4 x 256 tokens from the data pipeline, seed 0, from a
# state one step in (count 1, so that AdamW's bias corrections and moments
# matter); the host CPU runs the same step on the same state and batch
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_DATA = {"vocab_size": 151936, "seq_len": 256, "global_batch": 4,
              "seed": 0}
TRAIN_LR = 3e-4          # make_train_step's default
TRAIN_LR_FALL = 1e-3     # T3's two steps on one batch
# T1 card vs host in float32 (loss, pre-clip grad norm: relative; every
# gradient leaf: max |diff| over the host's max |g|); T2 the card's AdamW
# update on the host's gradients vs the host's (params, m, v: relative to
# each leaf's scale); T3 microbatches 2 vs 1 (loss and gradients); T4
# remat policies vs "none"; T5 the step as configured (bf16 compute) vs
# the same run's float32 one: its loss (relative), and every gradient
# leaf's ||g_bf16 - g_f32|| / ||g_f32|| (a stacked leaf layer by layer),
# whose largest must lie between a floor (a step that ran in float32
# reads ~0) and a ceiling (a leaf that lost its gradient reads 1).  bf16
# rounds every element, so a leaf's largest elementwise gap reads its
# worst element; the norm reads the leaf.
TRAIN_LIMITS = {"T1 loss": 1e-5, "T1 grad_norm": 1e-5, "T1 grad": 1e-4,
                "T2": 1e-6, "T3 microbatch": 1e-5, "T4": 1e-6,
                "T5 loss": 5e-2, "T5 grad": 0.25, "T5 grad floor": 1e-3}
# int8 compression: a dequantized element within scale / 2 of the
# gradient, scale = max|g| / 127, up to the float32 roundings of g / scale
# and q * scale (each at most 127 ulps of scale at the largest q)
TRAIN_INT8_SLACK = 1 + 254 * 2.0 ** -23
TRAIN_REMAT = ("none", "full", "dots_nb")
# the gradient pass timed at a training sequence length, as configured
# (bf16), under each policy ("none" last: its saved attention scores may
# not fit the card beside the state)
TRAIN_LONG_DATA = dict(TRAIN_DATA, seq_len=2048)
TRAIN_LONG_REMAT = ("full", "dots_nb", "dots", "none")
# the faults planted in the code under test, each with the gates it must
# break (every other gate of that run must pass): the middle layer's
# attention output detached (its attention leaves lose their gradient);
# AdamW's bias corrections taken at the count before the step;
# microbatch gradients summed and not divided; the middle layer's
# attention output detached in bf16 only; the configured bf16 step built
# in float32
TRAIN_FAULTS = {"attention_cut": ("T1",), "stale_bias_correction": ("T2",),
                "microbatch_sum": ("T3",), "bf16_attention_cut": ("T5",),
                "bf16_as_float32": ("T5",)}
# The training loop: ``train`` on TRAIN_ARCH at full width as configured
# (bf16 compute) on TRAIN_DATA's stream, LOOP_STEPS steps straight (TL1
# against a hand-driven sequence of the step, TL3 the loss falling), and
# LOOP_RESUME_AT steps then a resume to LOOP_STEPS (TL2, bit-equal to the
# straight run); TL4 the launcher's first LOOP_LAUNCH_STEPS steps in a
# child process
LOOP_STEPS, LOOP_RESUME_AT, LOOP_LAUNCH_STEPS = 4, 2, 3
LOOP_DATA = {"global_batch": TRAIN_DATA["global_batch"],
             "seq_len": TRAIN_DATA["seq_len"], "seed": TRAIN_DATA["seed"],
             "lr": TRAIN_LR}
# TL5: every arch reduced, in float32, LOOP_FAMILY_STEPS steps with a
# resume after the first, on the card and on the host CPU from the same
# CPU-generator weights; LOOP_MICROBATCH_ARCH (Adafactor) in 2 microbatches.
# Its limit on each loss, relative: train_phase's T1 read the full-width
# float32 loss 8.5e-8 off the host's and the gradients 3.3e-6 of scale;
# an AdamW or Adafactor step moves each weight by at most ~lr, normalised
# by the gradient's own size, so two updates built on such gradients move
# the loss by far less than T1's 1e-5 loss limit, which TL5 keeps
LOOP_FAMILY_STEPS = 3
LOOP_FAMILY_DATA = {"global_batch": 2, "seq_len": 32, "seed": 0,
                    "lr": TRAIN_LR}
LOOP_MICROBATCH_ARCH = "qwen3-moe-235b-a22b"
LOOP_TL5_LIMIT = 1e-5
# the faults' runs: reduced TRAIN_ARCH on this stream, at T3's larger lr:
# four steps of the reduced model at lr 3e-4 move its loss less than the
# batches' spread does (host CPU: 6.2610 -> 6.2591), at 1e-3 by 0.02
LOOP_FAULT_DATA = {"global_batch": 4, "seq_len": 64, "seed": 0,
                   "lr": TRAIN_LR_FALL}
# the faults planted in the loop on the card's side (the host's TL5 run and
# the hand-driven TL1 baseline never run them), each with the gates it
# must break (every other gate of that run must pass): after a restore,
# the stream fed from its first batch again; after a restore, the
# optimizer state started afresh; every step fed the next step's batch.
# TL5 resumes after its first step, so it reads the two resume faults too;
# TL2 compares two runs of the same loop, so it cannot read the third
LOOP_FAULTS = {"stream_restarts_on_resume": ("TL2", "TL5"),
               "moments_dropped_on_resume": ("TL2", "TL5"),
               "batch_of_next_step": ("TL1", "TL5")}
LOOP_LINE = re.compile(r"\[train\] step +(\d+) loss (\S+) \((\d+) ms"
                       r"( STRAGGLER)?\)$")
LOOP_DONE = re.compile(r"\[train\] done: loss (\S+) -> (\S+) \(median step "
                       r"(\d+) ms\)$")
# The dry-run's abstract trees (``models.api``): A1 every arch at every
# applicable shape; A2 API_ARCH's real state and its cache at
# API_CACHE_SHAPE; A3 ``make_batch`` for every arch at API_CACHE_SHAPE and
# API_ARCH at each of its shapes, its float inputs' std within API_STD_TOL
# of API_SCALE (millions of draws a batch: the std's own spread is ~1e-3)
API_ARCH, API_CACHE_SHAPE = "qwen2-0.5b", "prefill_32k"
API_SCALE, API_STD_TOL = 0.02, 0.05
# faults planted in the code under test, each with the gate it must break
# (the others must pass in that run), run on API_ARCH's cells alone: the
# parameters drawn on the card and then moved to meta; one parameter leaf
# cast to bfloat16; the card's batch drawn on a CUDA generator
API_FAULTS = {"params_built_on_card": ("A1",), "leaf_cast_bf16": ("A2",),
              "batch_on_card_generator": ("A3",)}
# The sharding rules and spec trees (``repro_torch.sharding``): S1 the
# persistent bytes per device of every (arch, shape) cell on both
# production meshes, from the abstract trees, against the reference's
# (REFERENCE_SHARDED_BYTES); S2 SHARDING_ARCH's real train state (for
# SHARDING_TRAIN_SHAPE), and its parameters in bfloat16 with its cache at
# API_CACHE_SHAPE, cut on the card into every device's block on both meshes
SHARDING_ARCH, SHARDING_TRAIN_SHAPE = API_ARCH, "train_4k"
SHARDING_MESHES = {"16x16": False, "2x16x16": True}
# faults planted in the code under test, each with the gates it must break
# (the others must pass in that run): the rule choice reads every "sp"
# arch as "tp" (``scheme_for``); ``resolve`` keeps a mesh axis that an
# earlier dim of the spec already took; Adafactor's column means take the
# row means' spec (``opt_state_specs``, reached through ``state_specs``;
# only qwen3-moe-235b-a22b trains with Adafactor, so S2 cannot see it)
SHARDING_FAULTS = {"scheme_sp_read_as_tp": ("S1", "S2"),
                   "resolve_keeps_duplicate_axes": ("S1", "S2"),
                   "adafactor_vc_from_row_dims": ("S1",)}
# Persistent bytes per device of each "arch__shape__mesh" cell: the
# reference's ``sharded_bytes`` as ``repro.launch.dryrun.run_cell``
# computes it (the train state; else the parameters in bfloat16 plus the
# cache), from its ``tree_shardings`` on ``make_production_mesh`` over 512
# forced host devices; tests/test_torch_chip_constants.py recomputes it.
REFERENCE_SHARDED_BYTES = {
    "granite-34b__train_4k__16x16": 2_325_159_944,
    "granite-34b__train_4k__2x16x16": 2_325_159_944,
    "granite-34b__prefill_32k__16x16": 6_352_351_236,
    "granite-34b__prefill_32k__2x16x16": 6_260_076_548,
    "granite-34b__decode_32k__16x16": 6_905_999_364,
    "granite-34b__decode_32k__2x16x16": 6_536_900_612,
    "llava-next-mistral-7b__train_4k__16x16": 342_638_600,
    "llava-next-mistral-7b__train_4k__2x16x16": 342_638_600,
    "llava-next-mistral-7b__prefill_32k__16x16": 1_442_586_628,
    "llava-next-mistral-7b__prefill_32k__2x16x16": 1_174_151_172,
    "llava-next-mistral-7b__decode_32k__16x16": 3_053_199_364,
    "llava-next-mistral-7b__decode_32k__2x16x16": 1_979_457_540,
    "mamba2-780m__train_4k__16x16": 59_968_520,
    "mamba2-780m__train_4k__2x16x16": 59_968_520,
    "mamba2-780m__prefill_32k__16x16": 163_072_516,
    "mamba2-780m__prefill_32k__2x16x16": 156_436_996,
    "mamba2-780m__decode_32k__16x16": 202_885_636,
    "mamba2-780m__decode_32k__2x16x16": 176_343_556,
    "mamba2-780m__long_500k__16x16": 156_436_996,
    "mamba2-780m__long_500k__2x16x16": 156_436_996,
    "minitron-8b__train_4k__16x16": 466_403_336,
    "minitron-8b__train_4k__2x16x16": 466_403_336,
    "minitron-8b__prefill_32k__16x16": 1_772_625_924,
    "minitron-8b__prefill_32k__2x16x16": 1_504_190_468,
    "minitron-8b__decode_32k__16x16": 3_383_238_660,
    "minitron-8b__decode_32k__2x16x16": 2_309_496_836,
    "phi3.5-moe-42b-a6.6b__train_4k__16x16": 1_994_293_256,
    "phi3.5-moe-42b-a6.6b__train_4k__2x16x16": 1_994_293_256,
    "phi3.5-moe-42b-a6.6b__prefill_32k__16x16": 5_776_097_284,
    "phi3.5-moe-42b-a6.6b__prefill_32k__2x16x16": 5_507_661_828,
    "phi3.5-moe-42b-a6.6b__decode_32k__16x16": 7_386_710_020,
    "phi3.5-moe-42b-a6.6b__decode_32k__2x16x16": 6_312_968_196,
    "qwen2-0.5b__train_4k__16x16": 275_615_240,
    "qwen2-0.5b__train_4k__2x16x16": 275_615_240,
    "qwen2-0.5b__prefill_32k__16x16": 112_234_244,
    "qwen2-0.5b__prefill_32k__2x16x16": 87_068_420,
    "qwen2-0.5b__decode_32k__16x16": 263_229_188,
    "qwen2-0.5b__decode_32k__2x16x16": 162_565_892,
    "qwen3-moe-235b-a22b__train_4k__16x16": 4_058_750_968,
    "qwen3-moe-235b-a22b__train_4k__2x16x16": 4_058_750_968,
    "qwen3-moe-235b-a22b__prefill_32k__16x16": 31_008_464_900,
    "qwen3-moe-235b-a22b__prefill_32k__2x16x16": 30_614_200_324,
    "qwen3-moe-235b-a22b__decode_32k__16x16": 33_374_052_356,
    "qwen3-moe-235b-a22b__decode_32k__2x16x16": 31_796_994_052,
    "stablelm-3b__train_4k__16x16": 135_045_128,
    "stablelm-3b__train_4k__2x16x16": 135_045_128,
    "stablelm-3b__prefill_32k__16x16": 1_692_313_604,
    "stablelm-3b__prefill_32k__2x16x16": 1_021_224_964,
    "stablelm-3b__decode_32k__16x16": 5_718_845_444,
    "stablelm-3b__decode_32k__2x16x16": 3_034_490_884,
    "whisper-medium__train_4k__16x16": 41_017_352,
    "whisper-medium__train_4k__2x16x16": 41_017_352,
    "whisper-medium__prefill_32k__16x16": 799_449_092,
    "whisper-medium__prefill_32k__2x16x16": 450_666_500,
    "whisper-medium__decode_32k__16x16": 2_892_144_644,
    "whisper-medium__decode_32k__2x16x16": 1_497_014_276,
    "zamba2-2.7b__train_4k__16x16": 140_369_288,
    "zamba2-2.7b__train_4k__2x16x16": 140_369_288,
    "zamba2-2.7b__prefill_32k__16x16": 750_764_612,
    "zamba2-2.7b__prefill_32k__2x16x16": 554_196_548,
    "zamba2-2.7b__decode_32k__16x16": 1_930_172_996,
    "zamba2-2.7b__decode_32k__2x16x16": 1_143_900_740,
    "zamba2-2.7b__long_500k__16x16": 3_385_351_748,
    "zamba2-2.7b__long_500k__2x16x16": 3_385_351_748,
}
# The dry-run (``repro_torch.launch.dryrun``): D1 runs its CLI in one child
# process a held cell, all at once, on the card's machine; each record is
# held to the reference's record of the cell (REFERENCE_DRYRUN) within
# DRYRUN_LIMITS, its exact fields equal.  (arch, shape, multi_pod,
# overrides, tag) of each held cell:
DRYRUN_CELLS = [
    ("qwen2-0.5b", "train_4k", False, {}, ""),
    ("qwen2-0.5b", "train_4k", True, {}, ""),
    ("qwen2-0.5b", "train_4k", False, {"force_scheme": "dp"}, "dp"),
    ("qwen2-0.5b", "prefill_32k", False, {}, ""),
    ("qwen2-0.5b", "decode_32k", False, {}, ""),
    ("mamba2-780m", "decode_32k", False, {}, ""),
    ("qwen3-moe-235b-a22b", "train_4k", False, {}, ""),
]
# the skip record of an attention arch at long_500k (no file is written)
DRYRUN_SKIP = ("qwen2-0.5b", "long_500k")
REFERENCE_DRYRUN_SKIP = {
    "arch": "qwen2-0.5b", "shape": "long_500k", "skipped": True,
    "reason": "long_500k requires sub-quadratic attention (see DESIGN.md §5)"}
# port / reference: FLOPs (and the kernel-adjusted FLOPs where the
# reference has them); bytes (kernel-adjusted, or raw for decode and where
# the reference's matcher removed no tile); collective wire bytes per
# device, summed over every op kind; and
# ``predict_cell``'s step time on the port's record against the
# reference's record
DRYRUN_LIMITS = {"flops": (0.8, 1.25), "bytes": (1 / 3, 3.0),
                 "collectives": (1 / 3, 3.0), "step_s": (1 / 3, 3.0)}
# D2: sec5's three what-ifs on this cell's port record (the what-if
# step time against the reference record's, within the step_s limit), and
# the DES on this one
DRYRUN_WHATIF_CELL = ("qwen3-moe-235b-a22b", "train_4k", "16x16")
DRYRUN_DES_CELL = ("qwen2-0.5b", "train_4k", "16x16")
# faults planted in the code under test, each with the gate it must break
# on its cell: the train step counted forward only (no gradient, no
# update); the count's totals not divided over the chips; the collectives
# of one layer (every term over the layer count)
DRYRUN_FAULTS = {
    "train_forward_only": (("qwen2-0.5b", "train_4k", False, {}, ""),
                           "flops"),
    "count_not_per_chip": (("qwen2-0.5b", "decode_32k", False, {}, ""),
                           "flops"),
    "one_layer_collectives": (("qwen2-0.5b", "decode_32k", False, {}, ""),
                              "collectives"),
}
# The reference's records of the held cells, summarised by
# ``dryrun_summary``: its ``run_cell`` under jax 0.9.0 on 512 forced host
# devices (XLA:CPU), in a child that aliases ``jax.experimental.enable_x64``
# to ``jax.enable_x64`` and makes ``jax.make_mesh`` default to Auto axes;
# ``step_s`` is ``predict_cell`` on the record, the what-ifs and the DES
# are those of DRYRUN_WHATIF_CELL and DRYRUN_DES_CELL;
# tests/test_torch_dryrun.py recomputes them all.
REFERENCE_DRYRUN = {
    "qwen2-0.5b__train_4k__16x16": {
        "exact": {"arch": "qwen2-0.5b",
                  "shape": "train_4k",
                  "tag": "",
                  "overrides": {},
                  "mesh": "16x16",
                  "chips": 256,
                  "kind": "train",
                  "scheme": "sp",
                  "ok": True,
                  "persistent_bytes_per_device": 275615240,
                  "roofline_chips": 256,
                  "model_flops": 3108191059574784.0},
        "flops": 4586200438407168.0,
        "bytes": 449467143714816.0,
        "kadj_flops": 4586200438407168.0,
        "kadj_bytes": 449467143714816.0,
        "removed_tile_bytes": 0.0,
        "coll": 40919665938.5,
        "collectives": {"all-gather": [821.0, 12285723648.0],
                        "all-reduce": [174.0, 8420411602.5],
                        "all-to-all": [50.0, 19963969536.0],
                        "collective-permute": [3.0, 249561152.0]},
        "step_s": 0.9771033556953088,
    },
    "qwen2-0.5b__train_4k__2x16x16": {
        "exact": {"arch": "qwen2-0.5b",
                  "shape": "train_4k",
                  "tag": "",
                  "overrides": {},
                  "mesh": "2x16x16",
                  "chips": 512,
                  "kind": "train",
                  "scheme": "sp",
                  "ok": True,
                  "persistent_bytes_per_device": 275615240,
                  "roofline_chips": 512,
                  "model_flops": 3108191059574784.0},
        "flops": 4586200438407168.0,
        "bytes": 458983691814912.0,
        "kadj_flops": 4586200438407168.0,
        "kadj_bytes": 458983691814912.0,
        "removed_tile_bytes": 0.0,
        "coll": 24977261266.75,
        "collectives": {"all-gather": [823.0, 8131094528.0],
                        "all-reduce": [201.0, 6511860402.75],
                        "all-to-all": [50.0, 10092085248.0],
                        "collective-permute": [3.0, 242221088.0]},
        "step_s": 0.5125188278481554,
    },
    "qwen2-0.5b__train_4k__16x16__dp": {
        "exact": {"arch": "qwen2-0.5b",
                  "shape": "train_4k",
                  "tag": "dp",
                  "overrides": {"force_scheme": "dp"},
                  "mesh": "16x16",
                  "chips": 256,
                  "kind": "train",
                  "scheme": "sp",
                  "ok": True,
                  "persistent_bytes_per_device": 275615240,
                  "roofline_chips": 256,
                  "model_flops": 3108191059574784.0},
        "flops": 4586200438407168.0,
        "bytes": 374388114633728.0,
        "kadj_flops": 4309123508207616.0,
        "kadj_bytes": 128802408108032.0,
        "removed_tile_bytes": 959319166116.0,
        "coll": 9681084303.46875,
        "collectives": {"all-gather": [340.0, 3230745600.0],
                        "all-reduce": [78.0, 6421879695.46875],
                        "all-to-all": [1.0, 13762560.0],
                        "collective-permute": [2.0, 14696448.0]},
        "step_s": 0.7325464625926394,
    },
    "qwen2-0.5b__prefill_32k__16x16": {
        "exact": {"arch": "qwen2-0.5b",
                  "shape": "prefill_32k",
                  "tag": "",
                  "overrides": {},
                  "mesh": "16x16",
                  "chips": 256,
                  "kind": "prefill",
                  "scheme": "sp",
                  "ok": True,
                  "persistent_bytes_per_device": 112234244,
                  "roofline_chips": 256,
                  "model_flops": 1036063686524928.0},
        "flops": 3705912661377024.0,
        "bytes": 485196145688064.0,
        "kadj_flops": 2967040847511552.0,
        "kadj_bytes": 160266298916352.0,
        "removed_tile_bytes": 1269257213952.0,
        "coll": 3362754688.0,
        "collectives": {"all-gather": [217.0, 3362734080.0],
                        "all-reduce": [1.0, 13440.0],
                        "collective-permute": [1.0, 7168.0]},
        "step_s": 0.9187369012734382,
    },
    "qwen2-0.5b__decode_32k__16x16": {
        "exact": {"arch": "qwen2-0.5b",
                  "shape": "decode_32k",
                  "tag": "",
                  "overrides": {},
                  "mesh": "16x16",
                  "chips": 256,
                  "kind": "decode",
                  "scheme": "sp",
                  "ok": True,
                  "persistent_bytes_per_device": 263229188,
                  "roofline_chips": 256,
                  "model_flops": 126472617984.0},
        "flops": 487260684288.0,
        "bytes": 1461988861952.0,
        "kadj_flops": None,
        "kadj_bytes": None,
        "removed_tile_bytes": None,
        "coll": 17081340.0,
        "collectives": {"all-gather": [1.0, 26880.0],
                        "all-reduce": [170.0, 17054460.0]},
        "step_s": 0.0028049509518590344,
    },
    "mamba2-780m__decode_32k__16x16": {
        "exact": {"arch": "mamba2-780m",
                  "shape": "decode_32k",
                  "tag": "",
                  "overrides": {},
                  "mesh": "16x16",
                  "chips": 256,
                  "kind": "decode",
                  "scheme": "tp",
                  "ok": True,
                  "persistent_bytes_per_device": 202885636,
                  "roofline_chips": 256,
                  "model_flops": 219448541184.0},
        "flops": 204510068736.0,
        "bytes": 348035919872.0,
        "kadj_flops": None,
        "kadj_bytes": None,
        "removed_tile_bytes": None,
        "coll": 28590912.0,
        "collectives": {"all-gather": [385.0, 21934080.0],
                        "all-reduce": [97.0, 4518720.0],
                        "collective-permute": [1248.0, 2138112.0]},
        "step_s": 0.0007600716109497475,
    },
    "qwen3-moe-235b-a22b__train_4k__16x16": {
        "exact": {"arch": "qwen3-moe-235b-a22b",
                  "shape": "train_4k",
                  "tag": "",
                  "overrides": {},
                  "mesh": "16x16",
                  "chips": 256,
                  "kind": "train",
                  "scheme": "tp",
                  "ok": True,
                  "persistent_bytes_per_device": 4058750968,
                  "roofline_chips": 256,
                  "model_flops": 1.3961208666469171e+17},
        "flops": 4.713892221298934e+17,
        "bytes": 1.1073463642110976e+16,
        "kadj_flops": 4.6146722920084275e+17,
        "kadj_bytes": 6693407223247872.0,
        "removed_tile_bytes": 17109595386184.0,
        "coll": 1236819805718.5,
        "collectives": {"all-gather": [4328.0, 124528111680.0],
                        "all-reduce": [1714.0, 1109982467542.5],
                        "all-to-all": [2.0, 2013265920.0],
                        "collective-permute": [565.0, 295960576.0]},
        "step_s": 24.834626947324736,
    },
}
REFERENCE_DRYRUN_WHATIF = {
    "ici_x2": 22.773260604460567,
    "hbm_x2": 16.858178664686488,
    "peak_x2": 24.834626947324736,
}
REFERENCE_DRYRUN_DES = {"step_s": 1.7559880789781328,
                        "events": 1942624}
# unit roundoff of bfloat16 (8 significand bits)
BF16_U = 2.0 ** -8
PREFILL_B, PREFILL_S, PREFILL_DECODE = 4, 2048, 16
# Kernel against plain path, largest gap over the plain path's largest
# magnitude, across prefill logits, the K/V cache and 16 decode steps.
# float32: the kernel agrees with its plain version to ~1e-6, so 1e-4
# leaves room for 24 layers of growth; bfloat16 rounds activations to 8
# mantissa bits at other places in the two paths.
PREFILL_LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}
SSM_ARCH = "mamba2-780m"
# (B, S, H, P, N, chunk): tests/test_kernels.py's SSD shapes; mamba2-780m's
# 4 x 2048 forward; a ragged S and an S below the chunk at the model's widths
SSD_SHAPES = [(1, 64, 1, 8, 4, 16), (2, 128, 3, 16, 8, 32),
              (1, 256, 2, 64, 16, 64), (1, 128, 2, 32, 128, 128)]
SSD_MODEL = (4, 2048, 48, 64, 128, 256)
# zamba2-2.7b's 4 x 2048 loss: 80 heads of 64, N 64 (the 128-wide template
# with columns n >= 64 masked)
SSD_HYBRID = (HYBRID_B, HYBRID_S, 80, 64, 64, 256)
SSD_RAGGED = [(1, 300, 48, 64, 128, 256), (2, 100, 48, 64, 128, 256)]
# rtol, atol of the reference's kernel test (tests/test_kernels.py)
SSD_TOL = {torch.float32: (2e-4, 2e-3), torch.bfloat16: (5e-2, 5e-1)}
# unit roundoff of float32 (24 significand bits)
F32_U = 2.0 ** -24
SSM_B, SSM_S = 4, 2048
SSM_SERVE_REQUESTS, SSM_SERVE_PROMPT, SSM_SERVE_NEW, SSM_SERVE_SLOTS = (
    4, 128, 16, 4)
# Kernel against plain path for mamba2-780m, each gap over the plain
# output's largest magnitude.  float32: the logits, the loss and every
# layer's scan output, which differ only in summation order (1e-4 leaves
# room for 48 layers).  bfloat16: every layer's scan output, where the
# plain path rounds the scan's (Q, Q) tiles to bf16 while the kernel stays
# float32, as in the reference; the limit is the reference kernel test's
# bf16 rtol.  The bf16 logits carry the whole model's bf16 rounding (each
# bf16 path read 6.5e-2 and 6.8e-2 from the float32 logits), so they are
# held against the float32 kernel path's logits and loss, within 1e-1,
# and their kernel-vs-plain gap is printed, not gated.
SSM_LIMIT = 1e-4
SSM_SCAN_LIMIT_BF16 = 5e-2
SSM_BF16_FROM_F32 = 1e-1


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b) -> float:
    """|a - b| / |b|: 0 where ``a == b`` (zeros and None included), inf
    against a zero or None ``b`` that ``a`` does not equal."""
    if a == b:
        return 0.0
    if a is None or b is None or b == 0:
        return math.inf
    return abs(a - b) / abs(b)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one ``fn()`` between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def frontera_incidence(dev):
    """Flow x link incidence of Frontera's 1-ring panel broadcast in every
    process row at once: rank (p, q) sits on node p + q*P (column-major)
    and sends to (p, (q+1) % Q), routed over the port's fat tree. Returns
    the incidence, the link capacities and the (src, dst) pairs in row
    order."""
    from repro_torch.kernels.maxmin_fair import flow_incidence
    from repro_torch.platforms import get_platform
    plat = get_platform("frontera")
    P, Q = plat.scale.grid
    pairs = [(p + q * P, p + ((q + 1) % Q) * P)
             for q in range(Q) for p in range(P)]
    adj, caps = flow_incidence(plat.topology(), pairs)
    return (torch.from_numpy(adj).to(dev), torch.from_numpy(caps).to(dev),
            pairs)


def first_share(adj, caps):
    """The per-link fair share of waterfill's first iteration: the values
    the main path hands the row-min kernel."""
    from repro_torch.kernels.maxmin_fair import INF
    nl = adj.to(torch.float32).sum(dim=0)
    return torch.where(nl > 0, caps / torch.clamp(nl, min=1.0), INF)


def check_minrows(name, adj, vals):
    """Kernel against plain version: exactly equal (a min does no
    arithmetic); returns the timing record."""
    from repro_torch.kernels.maxmin_fair import (masked_min_rows,
                                                 masked_min_rows_ref)
    out_k = masked_min_rows(adj, vals)
    out_p = masked_min_rows_ref(adj, vals)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max()) if out_k.numel() else 0.0
    check(torch.equal(out_k, out_p),
          f"masked_min_rows {name}: kernel != plain (max abs err {err})")
    F, L = adj.shape
    ms = cuda_ms(lambda: masked_min_rows(adj, vals))
    plain_ms = cuda_ms(lambda: masked_min_rows_ref(adj, vals))
    bound_ms = (F * L + 4 * L + 4 * F) / HBM_BYTES_PER_S * 1e3
    print(f"masked_min_rows {name} F={F} L={L}: equal=True "
          f"max_abs_err={err} ms={ms:.6f} plain_ms={plain_ms:.6f} "
          f"bound_ms={bound_ms:.6f} (bytes) "
          f"launches={masked_min_rows.launches}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "max_abs_err": err}


def kernel_phase(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    for F, L, density in TEST_SHAPES:
        adj = (torch.rand(F, L, generator=g, device=dev)
               < density).to(torch.int8)
        if (F, L) == (1000, 300):
            # ragged rows (300 % 16 != 0) with non-positive entries, which
            # cross no link
            adj = adj - (torch.rand(F, L, generator=g, device=dev)
                         < 0.05).to(torch.int8)
        vals = torch.rand(L, generator=g, device=dev) * 100
        check_minrows(f"{F}x{L}", adj, vals)
    adj, caps, pairs = frontera_incidence(dev)
    check(tuple(adj.shape) == (8008, 18200),
          f"Frontera incidence shape {tuple(adj.shape)} != (8008, 18200)")
    return adj, caps, pairs, check_minrows("frontera", adj,
                                           first_share(adj, caps))


def predict_phase(dev, name):
    from repro_torch.core.fastsim import bucket_key
    from repro_torch.platforms import get_platform
    from repro_torch.workloads import get_workload
    plat = get_platform(name)
    wl = get_workload("hpl")
    t0 = time.perf_counter()
    t = wl.predict(plat, device=dev)["time_s"]
    wall = time.perf_counter() - t0
    cfg = wl.config(plat)
    steps = bucket_key(cfg)[0]
    err = rel_err(t, REFERENCE_TIME_S[name])
    print(f"predict {name}: time_s={t!r} reference="
          f"{REFERENCE_TIME_S[name]!r} rel_err={err:.3e} (tol {TOL[name]}) "
          f"wall_s={wall:.3f} panels={cfg.n_panels} loop_steps={steps} "
          f"panels_per_s={cfg.n_panels / wall:.1f}", flush=True)
    check(err <= TOL[name], f"predict {name}: rel err {err} > {TOL[name]}")
    return t


def grid_phase(dev, frontera_t):
    """8 link_bw x 8 gemm_eff what-if rows over Frontera's run, through
    ``whatif_grid`` (one batch: the 64 rows and the unmodified baseline),
    against the reference's rows and the single run."""
    from repro_torch.core import whatif_grid
    from repro_torch.platforms import get_platform
    from repro_torch.workloads import get_workload
    plat = get_platform("frontera")
    wl = get_workload("hpl")
    base = wl.fastsim_model(plat).params
    axes = {"link_bw": [base.link_bw * f for f in GRID_LINK_SCALES],
            "gemm_eff": [base.gemm_eff if e is None else e
                         for e in GRID_GEMM_EFF]}
    t0 = time.perf_counter()
    rows = whatif_grid(wl, "frontera", axes, mode="abs", device=dev)
    wall = time.perf_counter() - t0
    out = [r["time_s"] for r in rows]
    check(len(out) == len(REFERENCE_GRID_TIME_S),
          f"grid: {len(out)} rows != {len(REFERENCE_GRID_TIME_S)}")
    ref_err = max(rel_err(t, r) for t, r in zip(out, REFERENCE_GRID_TIME_S))
    ref_lane = rows[2 * 8 + 4]           # link_bw x 1.0, gemm_eff as is
    err = rel_err(ref_lane["time_s"], frontera_t)
    n_panels = wl.config(plat).n_panels
    print(f"whatif_grid frontera {len(rows)} rows + baseline: "
          f"wall_s={wall:.3f} "
          f"lane_panels_per_s={(len(rows) + 1) * n_panels / wall:.1f} "
          f"min_time_s={min(out)!r} max_time_s={max(out)!r} "
          f"max_rel_err_vs_reference_rows={ref_err:.3e} "
          f"(tol {TOL['frontera']}) "
          f"unmodified_row={ref_lane['time_s']!r} "
          f"speedup={ref_lane['speedup']!r} rel_err_vs_single={err:.3e}",
          flush=True)
    check(all(t > 0 and t < float("inf") for t in out),
          "grid: non-finite lane time")
    check(ref_err <= TOL["frontera"],
          f"grid: rows differ from the reference's by {ref_err} > "
          f"{TOL['frontera']}")
    check(err <= 1e-12, f"grid: unmodified row rel err {err} > 1e-12")
    check(ref_lane["speedup"] == 1.0,
          f"grid: unmodified row speedup {ref_lane['speedup']!r} != 1.0")
    return wall


def forced_bucket_phase(dev, singles):
    """The three small platforms in one mixed-geometry forced bucket."""
    from repro_torch.platforms import get_platform
    from repro_torch.workloads import HPLFastModel, get_workload
    names = ["bdw-local", "tpu-v5e-pod", "syn-mp-2pod-v5e"]
    wl = get_workload("hpl")
    models = [wl.fastsim_model(get_platform(n)) for n in names]
    t0 = time.perf_counter()
    out = HPLFastModel.sweep_models(models, device=dev)
    wall = time.perf_counter() - t0
    panels = sum(m.cfg.n_panels for m in models)
    for n, r in zip(names, out):
        err = rel_err(r["time_s"], singles[n])
        print(f"forced bucket {n}: time_s={r['time_s']!r} "
              f"rel_err_vs_single={err:.3e}", flush=True)
        check(err <= 1e-12, f"forced bucket {n}: rel err {err} > 1e-12")
    print(f"forced bucket: wall_s={wall:.3f} "
          f"panels_per_s={panels / wall:.1f}", flush=True)


def host_cpu() -> str:
    """The host CPU's model name (from /proc/cpuinfo) and core count: the
    DES runs on the host, not the card."""
    name = "model not named"
    try:
        with open("/proc/cpuinfo") as f:
            name = next((line.partition(":")[2].strip() for line in f
                         if line.lower().startswith("model name")), name)
    except OSError:
        pass
    return f"{name}, {os.cpu_count()} cores"


def des_phase():
    """HPLSim on Frontera's spec at 16 x 16, untraced and traced, and
    predict_des on bdw-local, each equal to the reference bit for bit."""
    from repro_torch.core.apps.hpl import HPLConfig, HPLSim
    from repro_torch.platforms import get_platform
    from repro_torch.trace import to_chrome_json, validate_chrome_events
    from repro_torch.workloads import get_workload
    cfg = HPLConfig(**DES_CFG)
    plat = get_platform("frontera")
    t0 = time.perf_counter()
    res = HPLSim(cfg, plat).run()
    wall = time.perf_counter() - t0
    print(f"DES frontera 16x16 N={cfg.N} nb={cfg.nb}: time_s={res.time_s!r} "
          f"events={res.events} reference={REFERENCE_DES['time_s']!r}/"
          f"{REFERENCE_DES['events']} host_wall_s={wall:.3f} "
          f"events_per_s={res.events / wall:.0f} host_cpu={host_cpu()!r}",
          flush=True)
    check(res.time_s == REFERENCE_DES["time_s"]
          and res.events == REFERENCE_DES["events"],
          f"DES frontera: ({res.time_s!r}, {res.events}) != reference")
    t0 = time.perf_counter()
    traced = HPLSim(cfg, plat, trace=True).run()
    traced_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    doc = to_chrome_json(traced.trace)
    validate_chrome_events(doc)
    chrome_wall = time.perf_counter() - t0
    summ = traced.trace.summary()
    print(f"DES frontera traced: time_s={traced.time_s!r} "
          f"events={traced.events} host_wall_s={traced_wall:.3f} "
          f"spans={len(traced.trace.spans)} "
          f"chrome_events={len(doc['traceEvents'])} "
          f"chrome_validate_wall_s={chrome_wall:.3f} "
          f"critical_path_coverage={summ['critical_path_coverage']:.4f}",
          flush=True)
    check(traced.time_s == res.time_s and traced.events == res.events,
          "DES frontera: the traced run differs from the untraced one")
    out = get_workload("hpl").predict_des(get_platform("bdw-local"))
    print(f"predict_des bdw-local: time_s={out['time_s']!r} "
          f"events={out['events']}", flush=True)
    check(out["time_s"] == REFERENCE_PREDICT_DES["time_s"]
          and out["events"] == REFERENCE_PREDICT_DES["events"],
          f"predict_des bdw-local: ({out['time_s']!r}, {out['events']}) != "
          "reference")
    return {"wall_s": wall, "events_per_s": res.events / wall}


def fit_step_profile(runs, init, fields, dev):
    """CUDA kernels launched per fit step and the device busy share,
    from torch.profiler: a 2-step fit less a 1-step one (each also
    evaluates the final loss once)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.calibrate import fit_fastsim_params
    counts, busy, walls = [], [], []
    for steps in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fit_fastsim_params(runs, init, fields=fields, steps=steps,
                               device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        counts.append(len(kernels))
        busy.append(sum(e.time_range.elapsed_us() for e in kernels) * 1e-6)
    if not counts[1]:
        print("profiler recorded no device kernels: device time not "
              "measured", flush=True)
        return None, None
    step_wall = walls[1] - walls[0]
    return counts[1] - counts[0], ((busy[1] - busy[0]) / step_wall
                                   if step_wall > 0 else None)


def bridge_phase(dev):
    """fit_fastsim_to_des on bdw-local with the fit on the card: probes
    bit-equal to the reference, scales and final loss within 1e-6."""
    import dataclasses

    from repro_torch.platforms import (des_probe_runs, fit_fastsim_to_des,
                                       get_platform)
    plat = get_platform("bdw-local")
    t0 = time.perf_counter()
    des_probe_runs(plat)
    probe_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit = fit_fastsim_to_des(plat, device=dev)
    wall = time.perf_counter() - t0
    steps = fit.fit.steps
    probes = [t for _, t in fit.probes]
    cal_err = max(rel_err(fit.calibration[k], v)
                  for k, v in REFERENCE_BRIDGE["calibration"].items())
    loss_err = rel_err(fit.fit.loss, REFERENCE_BRIDGE["loss"])
    step_s = (wall - probe_wall) / steps
    init = dataclasses.replace(plat.fastsim(calibrated=False), lookahead=0.0)
    launches, busy = fit_step_profile(fit.probes, init, fit.fields, dev)
    print(f"bridge bdw-local: probes={probes!r} "
          f"calibration={fit.calibration!r} loss0={fit.fit.loss0!r} "
          f"loss={fit.fit.loss!r} max_rel_err_scales={cal_err:.3e} "
          f"rel_err_loss={loss_err:.3e} (tol {BRIDGE_RTOL}) "
          f"wall_s={wall:.3f} probe_wall_s={probe_wall:.3f} steps={steps} "
          f"fit_s_per_step={step_s:.4f} launches_per_step={launches} "
          f"device_busy_share={busy}", flush=True)
    check(probes == REFERENCE_BRIDGE["probes"],
          f"bridge: probe times {probes!r} != reference")
    check(cal_err <= BRIDGE_RTOL, f"bridge: scales rel err {cal_err} > "
          f"{BRIDGE_RTOL}")
    check(loss_err <= BRIDGE_RTOL, f"bridge: loss rel err {loss_err} > "
          f"{BRIDGE_RTOL}")
    return {"s_per_step": step_s, "launches_per_step": launches,
            "busy": busy}


def transformer_phase(dev):
    """The transformer step model on the card: the four torus/multipod
    platforms' step times, the 18-scenario sweep twice (the second adds
    no lane shape to ``trace_count``; the port builds no step program, so
    this is the reference's compile-once bookkeeping, not a measured
    rebuild), and d step / d link_bw through autograd."""
    from repro_torch.platforms import get_platform
    from repro_torch.workloads import (get_workload, step_time_traced,
                                       trace_count)
    t0 = time.perf_counter()
    for name in STEP_PLATFORMS:
        t = get_workload("transformer").predict(get_platform(name),
                                                device=dev)["step_s"]
        err = rel_err(t, REFERENCE_STEP_S[name])
        print(f"transformer {name}: step_s={t!r} "
              f"reference={REFERENCE_STEP_S[name]!r} rel_err={err:.3e} "
              "(tol 1e-12)", flush=True)
        check(err <= 1e-12, f"transformer {name}: rel err {err} > 1e-12")
    model = get_workload("transformer").fastsim_model(
        get_platform("tpu-v5e-pod"))
    base = model.params
    grid = [dataclasses.replace(
        base, link_bw=base.link_bw * (1 + 0.1 * i), n_layers=float(2 + i),
        flops_per_layer=base.flops_per_layer * (1 + 0.05 * i))
        for i in range(STEP_GRID_LANES)]
    c0 = trace_count()
    first = model.sweep(grid, device=dev)
    c1 = trace_count()
    again = model.sweep(grid, device=dev)
    rebuilt = trace_count() - c1
    err = max(rel_err(r["step_s"], w)
              for r, w in zip(again, REFERENCE_STEP_GRID_S))
    check(len(again) == len(REFERENCE_STEP_GRID_S),
          f"step sweep: {len(again)} rows")
    check(rebuilt == 0, f"step sweep: the second call saw {rebuilt} new "
          "lane shapes")
    check(first == again, "step sweep: the two calls differ")
    check(err <= 1e-12, f"step sweep: rel err {err} > 1e-12")
    lb = torch.tensor(base.link_bw, dtype=torch.float64, device=dev,
                      requires_grad=True)
    t = step_time_traced(dataclasses.replace(base, link_bw=lb), device=dev)
    t.backward()
    g = float(lb.grad)
    gerr = rel_err(g, REFERENCE_STEP_GRAD["d_link_bw"])
    verr = rel_err(float(t.detach()), REFERENCE_STEP_GRAD["step_s"])
    wall = time.perf_counter() - t0
    print(f"transformer sweep tpu-v5e-pod {len(grid)} lanes: new lane "
          f"shapes {c1 - c0} then {rebuilt}; max_rel_err={err:.3e} (tol "
          f"1e-12); d step_s/d link_bw={g!r} reference="
          f"{REFERENCE_STEP_GRAD['d_link_bw']!r} rel_err={gerr:.3e} (tol "
          f"1e-9); host_wall_s={wall:.3f}", flush=True)
    check(gerr <= 1e-9, f"step gradient: rel err {gerr} > 1e-9")
    check(verr <= 1e-12, f"step gradient value: rel err {verr} > 1e-12")


def fault_phase(dev):
    """sweep_faults on tpu-v5e-pod for HPL at the registry's geometry and
    for the transformer, against the reference; fail-stop and
    node-scoped link faults must raise, as the reference's do."""
    from repro_torch.core.fastsim import bucket_key
    from repro_torch.faults import Fault, FaultSpec, as_fault_spec
    from repro_torch.faults import sweep_faults
    from repro_torch.platforms import get_platform
    from repro_torch.workloads import get_workload
    specs = [as_fault_spec(d) for d in FAULT_SPECS]
    plat = get_platform("tpu-v5e-pod")
    cfg = get_workload("hpl").config(plat)
    check((cfg.N, cfg.nb, cfg.P, cfg.Q) == (619520, 512, 16, 16),
          f"fault sweep: tpu-v5e-pod geometry {cfg}")
    for kind in ("hpl", "transformer"):
        t0 = time.perf_counter()
        out = sweep_faults(get_workload(kind), plat, specs, device=dev)
        wall = time.perf_counter() - t0
        want = REFERENCE_FAULT_SWEEP[kind]
        errs = {key: max(rel_err(r[key], w) for r, w in zip(out, want[key]))
                for key in want}
        rows = " ".join(
            f"{s}={r['time_s']!r}/{r['slowdown_vs_healthy']!r}"
            for s, r in zip(["healthy"] + [d["name"] for d in FAULT_SPECS],
                            out))
        geometry = (f" N={cfg.N} nb={cfg.nb} {cfg.P}x{cfg.Q} "
                    f"bucket={bucket_key(cfg)}" if kind == "hpl" else "")
        print(f"fault sweep {kind} tpu-v5e-pod{geometry}: {rows} "
              f"max_rel_err time_s={errs['time_s']:.3e} slowdown="
              f"{errs['slowdown_vs_healthy']:.3e} (tol 1e-12) "
              f"host_wall_s={wall:.3f}", flush=True)
        check(len(out) == len(specs) + 1, f"fault sweep {kind}: {len(out)}")
        check(max(errs.values()) <= 1e-12,
              f"fault sweep {kind}: rel err {errs} > 1e-12")
    for bad, why in ((FaultSpec.fail_stop(rank=0), "fail_stop"),
                     (FaultSpec(faults=(Fault("link_degrade", node=3,
                                              factor=0.5),)), "DES-only")):
        for kind in ("hpl", "transformer"):
            try:
                sweep_faults(get_workload(kind), plat, [bad], device=dev)
                raised = ""
            except ValueError as exc:
                raised = str(exc)
            check(why in raised, f"fault sweep {kind}: {bad} did not raise "
                  f"({raised!r})")
    print("fault sweep: fail_stop and node-scoped link faults raise "
          "ValueError on both workloads", flush=True)


def region_phase(dev):
    """RegionHPLSim on DES_CFG: the prefix's events and panel marks
    bit-equal to the reference's, the region result within 1e-12 (the
    tail is fastsim on the card), fewer events than the exact run."""
    from repro_torch.core.apps.hpl import HPLConfig
    from repro_torch.platforms import get_platform
    from repro_torch.scale import RegionHPLSim
    cfg = HPLConfig(**DES_CFG)
    t0 = time.perf_counter()
    sim = RegionHPLSim(cfg, get_platform("frontera"), region=REGION,
                       device=dev)
    res = sim.run()
    wall = time.perf_counter() - t0
    marks = [sim._marks[k] for k in sorted(sim._marks)]
    err = rel_err(res.time_s, REFERENCE_REGION["time_s"])
    vs_exact = (res.time_s - REFERENCE_DES["time_s"]) / REFERENCE_DES[
        "time_s"]
    print(f"region frontera 16x16 N={cfg.N} nb={cfg.nb}: {REGION} of "
          f"{cfg.n_panels} panels on the DES, time_s={res.time_s!r} "
          f"reference={REFERENCE_REGION['time_s']!r} rel_err={err:.3e} "
          f"(tol 1e-12) events={res.events} (exact run "
          f"{REFERENCE_DES['events']}) marks_equal="
          f"{marks == REFERENCE_REGION['marks']} error_vs_exact_des="
          f"{vs_exact:+.4%} (not gated) host_wall_s={wall:.3f}", flush=True)
    check(res.region_approx and res.region_panels == REGION,
          "region: the result is not a region run")
    check(res.events == REFERENCE_REGION["events"]
          and marks == REFERENCE_REGION["marks"],
          f"region: prefix ({res.events} events, marks {marks!r}) differs "
          "from the reference's")
    check(res.events < REFERENCE_DES["events"],
          "region: no fewer events than the exact run")
    check(err <= 1e-12, f"region: rel err {err} > 1e-12")


def contention_phase(dev):
    """fit_contention_at_scale on Frontera at 16 ranks with one region
    probe and its fit on the card: overrides within 1e-6, note equal."""
    from repro_torch.core.apps.hpl import HPLConfig
    from repro_torch.platforms import get_platform
    from repro_torch.scale import RegionSpec, fit_contention_at_scale
    fit = CONTENTION_FIT
    plat = get_platform("frontera")
    t0 = time.perf_counter()
    sf = fit_contention_at_scale(
        plat, fit["at_ranks"],
        region=RegionSpec(panels=fit["panels"], warmup=fit["warmup"]),
        probe_configs=[HPLConfig(bcast=plat.mpi.bcast, **fit["probe"])],
        steps=fit["steps"], device=dev)
    wall = time.perf_counter() - t0
    want = REFERENCE_CONTENTION
    err = max(rel_err(sf.overrides[k], v)
              for k, v in want["overrides"].items())
    note = dict(sf.platform.provenance)[f"contention@{fit['at_ranks']}"]
    print(f"contention frontera at {fit['at_ranks']} ranks: "
          f"overrides={sf.overrides!r} max_rel_err={err:.3e} (tol "
          f"{BRIDGE_RTOL}) note={note!r} host_wall_s={wall:.3f}", flush=True)
    check(set(sf.overrides) == set(want["overrides"]),
          f"contention: fields {sorted(sf.overrides)}")
    check(err <= BRIDGE_RTOL, f"contention: rel err {err} > {BRIDGE_RTOL}")
    check(note == want["note"], f"contention: note {note!r} != reference")
    check(sf.platform.contention_dict[fit["at_ranks"]] == sf.overrides,
          "contention: the entry is not in the platform's table")


def fleet_step_profile(rep, dev):
    """CUDA kernels launched per panel-loop step of the fleet's bucket
    and the device busy share, from torch.profiler: the fleet's 51
    geometries cut to 32 and to 64 panels in buckets of that depth and
    the fleet's P and Q, the difference over 32 steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fastsim import sweep_hpl
    prms = [e.platform.fastsim() for e in rep.entries]
    counts, busy, walls = [], [], []
    for panels in (32, 64):
        cfgs = [dataclasses.replace(e.cfg, N=min(e.cfg.N, panels * e.cfg.nb))
                for e in rep.entries]
        bucket = (panels, rep.bucket[1], rep.bucket[2])
        sweep_hpl(cfgs, prms, bucket=bucket, device=dev)     # builds
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sweep_hpl(cfgs, prms, bucket=bucket, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        counts.append(len(kernels))
        busy.append(sum(e.time_range.elapsed_us() for e in kernels) * 1e-6)
    if not counts[1]:
        print("profiler recorded no device kernels: device time not "
              "measured", flush=True)
        return None, None
    return (counts[1] - counts[0]) / 32, busy[1] / walls[1]


def fleet_phase(dev):
    """predict_fleet(load_sample()) at the default FleetTuning(): one
    forced-bucket sweep on the card; bucket, splits, every machine's
    predicted and calibrated Rmax, the family factors and the held-out
    median error against the reference's."""
    from repro_torch.core.fastsim import _bucket, trace_count
    from repro_torch.obs import MetricsRegistry
    from repro_torch.top500 import FleetTuning, load_sample, predict_fleet
    want = REFERENCE_FLEET
    m = MetricsRegistry()
    c0 = trace_count()
    t0 = time.perf_counter()
    rep = predict_fleet(load_sample(), metrics=m, device=dev)
    wall = time.perf_counter() - t0
    built = trace_count() - c0
    hist = m.snapshot()["histograms"]
    sweep_wall = hist['fleet.phase_wall_s{phase="sweep"}']["sum"]
    steps = _bucket(rep.bucket[0])
    names = [[e.platform.name, e.split] for e in rep.entries]
    pred_err = max(rel_err(e.predicted_tflops, w[2])
                   for e, w in zip(rep.entries, want["machines"]))
    cal_err = max(rel_err(e.calibrated_tflops, w[3])
                  for e, w in zip(rep.entries, want["machines"]))
    factors = rep.calibration.factors
    fac_err = max(rel_err(factors[k], v) for k, v in want["factors"].items())
    held = rep.calibration.heldout_median_abs_err
    held_err = rel_err(held, want["heldout_median_abs_err"])
    med_err = rel_err(rep.median_abs_err(), want["median_abs_err"])
    launches, busy = fleet_step_profile(rep, dev)
    print(f"fleet top500 2020_06 at {FleetTuning()}: machines="
          f"{len(rep.entries)} bucket={rep.bucket} loop_steps={steps} "
          f"new_bucket_shapes={built} compiles={rep.compiles} "
          f"max_rel_err predicted={pred_err:.3e} calibrated={cal_err:.3e} "
          f"factors={fac_err:.3e} heldout_median={held_err:.3e} "
          f"median={med_err:.3e} (tol "
          f"1e-12) heldout_median_abs_err={held!r} (<= 0.15) "
          f"median_abs_err={rep.median_abs_err()!r} sweep_wall_s="
          f"{sweep_wall:.3f} ms_per_loop_step={sweep_wall / steps * 1e3:.3f} "
          f"host_wall_s={wall:.3f} launches_per_loop_step={launches} "
          f"device_busy_share_64_panel_cut={busy}", flush=True)
    for e, w in zip(rep.entries, want["machines"]):
        print(f"fleet {e.platform.name}: split={e.split} predicted_tflops="
              f"{e.predicted_tflops!r} calibrated_tflops="
              f"{e.calibrated_tflops!r} published_tflops="
              f"{e.published_tflops!r} rel_err_vs_reference="
              f"{rel_err(e.calibrated_tflops, w[3]):.3e}", flush=True)
    check(list(rep.bucket) == want["bucket"],
          f"fleet: bucket {rep.bucket} != {want['bucket']}")
    check(names == [w[:2] for w in want["machines"]],
          "fleet: machines or splits differ from the reference's")
    check(built == 1 and rep.compiles == 1,
          f"fleet: {built} new bucket shapes (want 1)")
    check(set(factors) == set(want["factors"]), "fleet: family set differs")
    worst = max(pred_err, cal_err, fac_err, held_err, med_err)
    check(worst <= 1e-12, f"fleet: rel err {worst} > 1e-12")
    check(held <= 0.15, f"fleet: held-out median error {held} > 0.15")


def result_floats(records):
    """The sha256 of ``campaign_run`` records with every float under
    ``meta.result`` replaced by null, and those floats in sorted-key
    order: the records' identity compares exactly, the answers within a
    tolerance (tests/test_torch_chip_constants.py computes the same)."""
    floats = []

    def strip(x):
        if isinstance(x, float):
            floats.append(x)
            return None
        if isinstance(x, dict):
            return {k: strip(x[k]) for k in sorted(x)}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x

    recs = json.loads(json.dumps(records))
    for rec in recs:
        rec["meta"]["result"] = strip(rec["meta"]["result"])
    digest = hashlib.sha256(
        json.dumps(recs, sort_keys=True).encode()).hexdigest()
    return digest, floats


def wave_requests(specs):
    """``WorkloadRequest``s from the JSON form of ``SERVE_WAVE``."""
    from repro_torch.faults import FaultSpec
    from repro_torch.serve import WorkloadRequest
    return [WorkloadRequest(
        rid=d["rid"], workload=d.get("workload", "hpl"),
        platform=d["platform"],
        faults=(None if d.get("faults") is None
                else FaultSpec.from_dict(d["faults"])),
        breakdown=d.get("breakdown", False)) for d in specs]


def predict_service_phase(dev):
    """Slice 7's serving layer on the card: ``PredictionService`` with
    its result cache serves ``SERVE_WAVE`` (one sweep per family, one DES
    breakdown), the wave again from the cache, 8 identical requests
    (coalesced onto one), the warm pool then a 4 + 4 wave (no new shape),
    ``HPLPredictionService.predict_platforms`` and one budgeted breakdown
    whose DES cannot start (``timeout_s=1e-9``), which must degrade to its
    fastsim answer."""
    from repro_torch.core import fastsim
    from repro_torch.serve import (HPLPredictionService, PredictionService,
                                   WorkloadRequest)
    from repro_torch.workloads import stepsim
    want = REFERENCE_SERVE
    n = len(SERVE_WAVE)
    svc = PredictionService(cache=True, device=dev)
    t0 = time.perf_counter()
    out = svc.predict_batch(wave_requests(SERVE_WAVE))
    wall = time.perf_counter() - t0
    stats = dict(svc.stats)
    times = [out[d["rid"]]["time_s"] for d in SERVE_WAVE]
    err = max(rel_err(t, w) for t, w in zip(times, want["time_s"]))
    print(f"serve wave: {n} requests (HPL on 3 buckets, transformer on 2, "
          f"a straggler, a DES breakdown) host_wall_s={wall:.3f} "
          f"predictions_per_s={n / wall:.2f} max_rel_err={err:.3e} "
          f"(tol 1e-12) stats={stats}", flush=True)
    check(err <= 1e-12, f"serve wave: rel err {err} > 1e-12")
    check(stats == want["stats"], f"serve wave: stats {stats} != "
          f"reference {want['stats']}")
    check(stats["sweeps"] == 2 and stats["des_breakdowns"] == 1
          and stats["retries"] == stats["errors"] == stats["fallbacks"] == 0,
          "serve wave: sweeps, breakdowns or hardening counts off")
    check(not any(r.get("degraded") for r in out.values()),
          "serve wave: a result is degraded")
    check("breakdown" in out[6], "serve wave: no DES breakdown")

    t0 = time.perf_counter()
    hits = svc.predict_batch(wave_requests(SERVE_WAVE))
    cwall = time.perf_counter() - t0
    stamped = all(hits[r].pop("cached", False) is True for r in hits)
    same = all({k: v for k, v in hits[r].items() if k != "latency_s"}
               == {k: v for k, v in out[r].items() if k != "latency_s"}
               for r in out)
    print(f"serve cached wave: host_wall_s={cwall:.6f} "
          f"cached_predictions_per_s={n / cwall:.1f} "
          f"cache_speedup={wall / cwall:.1f}x stats={dict(svc.stats)}",
          flush=True)
    check(stamped and same, "serve cached wave: payloads differ from the "
          "first pass or lack the cached stamp")
    check(dict(svc.stats) == want["cached_stats"],
          f"serve cached wave: stats {dict(svc.stats)}")

    dup = PredictionService(cache=True, device=dev)
    dup.predict_batch(wave_requests(
        [dict(SERVE_WAVE[0], rid=i) for i in range(8)]))
    print(f"serve 8 identical requests: stats={dict(dup.stats)}", flush=True)
    check(dict(dup.stats) == want["coalesced_stats"]
          and dup.stats["coalesced"] == 7, "serve: 8 requests did not "
          "coalesce onto one")
    for rid in SERVE_KEY_RIDS:
        req = wave_requests([SERVE_WAVE[rid]])[0]
        svc._resolve(req)
        check(svc._cache_key(req) == want["keys"][str(rid)],
              f"serve: request_key of request {rid} differs from the "
              "reference's")

    wsvc = PredictionService(device=dev)
    t0 = time.perf_counter()
    report = wsvc.warm(["hpl", "transformer"], ["tpu-v5e-pod"], count=4)
    warm_wall = time.perf_counter() - t0
    pre = fastsim.trace_count() + stepsim.trace_count()
    t0 = time.perf_counter()
    served = wsvc.predict_batch([
        WorkloadRequest(rid=i, workload=w, platform="tpu-v5e-pod")
        for i, w in enumerate(["hpl", "transformer"] * 4)])
    after = fastsim.trace_count() + stepsim.trace_count() - pre
    print(f"serve warm pool: report={report} warm_wall_s={warm_wall:.3f}; "
          f"4 + 4 wave: compiles={after} host_wall_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    check(len(served) == 8 and after == 0,
          f"serve warm pool: the wave after warm() saw {after} compiles")

    hsvc = HPLPredictionService(device=dev)
    t0 = time.perf_counter()
    got = hsvc.predict_platforms(
        ["bdw-local", "tpu-v5e-pod", "syn-mp-2pod-v5e"])
    errs = {k: rel_err(v["time_s"], REFERENCE_TIME_S[k])
            for k, v in got.items()}
    print(f"HPLPredictionService.predict_platforms: rel_err={errs} "
          f"stats={hsvc.stats} host_wall_s={time.perf_counter() - t0:.3f}",
          flush=True)
    check(all(e <= TOL[k] for k, e in errs.items()),
          f"predict_platforms: {errs}")

    dsvc = PredictionService(device=dev)
    late = dsvc.predict_batch([WorkloadRequest(
        rid=0, workload="hpl", platform="bdw-local", breakdown=True,
        timeout_s=1e-9)])[0]
    reason = late.get("fallback_reason", "")
    print(f"serve planted degradation (timeout_s=1e-9, breakdown): "
          f"degraded={late.get('degraded')} reason={reason!r} "
          f"time_s={late['time_s']!r}", flush=True)
    check(late.get("degraded") is True and "breakdown" not in late
          and reason.startswith(("deadline_exceeded", "wall_deadline"))
          and dsvc.stats["fallbacks"] == 1,
          "serve: the budgeted breakdown did not degrade")
    check(rel_err(late["time_s"], REFERENCE_TIME_S["bdw-local"]) <= 1e-12,
          "serve: the degraded answer is not the fastsim answer")


def campaign_phase(dev):
    """Slice 7's campaign layer on the card: the reference's acceptance
    matrix (36 runs, one sweep per family), twice (byte-equal run lines),
    and the two-edition TOP500 study as the CLI drives it, each against
    the reference's journal records and drift table."""
    from repro_torch.campaign import (CampaignSpec, campaign_report,
                                      edition_study_spec, run_campaign)
    from repro_torch.top500 import FleetTuning
    spec = CampaignSpec.make("accept", **CAMPAIGN_ACCEPT)
    want = REFERENCE_CAMPAIGN
    t0 = time.perf_counter()
    res = run_campaign(spec, device=dev)
    wall = time.perf_counter() - t0
    d = res.summary["meta"]["dispatches"]
    digest, floats = result_floats(res.run_records)
    err = max(rel_err(a, b) for a, b in zip(floats, want["floats"]))
    print(f"campaign accept: {len(res.run_records)} runs host_wall_s="
          f"{wall:.3f} dispatches={d} records_equal="
          f"{digest == want['skeleton_sha256']} result_floats="
          f"{len(floats)} max_rel_err={err:.3e} (tol 1e-12)", flush=True)
    check({k: d[k] for k in want["dispatches"]} == want["dispatches"],
          f"campaign: dispatches {d}")
    check(digest == want["skeleton_sha256"],
          "campaign: run records differ from the reference's")
    check(len(floats) == len(want["floats"]) and err <= 1e-12,
          f"campaign: result floats off by {err}")
    again = run_campaign(spec, device=dev)
    lines = [[l for l in r.lines() if '"campaign_run"' in l]
             for r in (res, again)]
    check(lines[0] == lines[1], "campaign: a rerun's run lines differ")

    study = EDITION_STUDY
    want = REFERENCE_EDITION_STUDY
    t0 = time.perf_counter()
    res = run_campaign(
        edition_study_spec(study["editions"], limit=study["limit"]),
        tuning=FleetTuning(max_ranks=study["max_ranks"],
                           panels_cap=study["panels_cap"]), device=dev)
    swall = time.perf_counter() - t0
    drift = campaign_report(res.records)["drift"]
    machines = {m["machine"]: [m["predicted_drift"], m["published_drift"]]
                for m in drift["machines"]}
    factors = {f["family"]: [f[f"factor_{drift['from']}"],
                             f[f"factor_{drift['to']}"]]
               for f in drift["calibration_factors"]}
    digest, floats = result_floats(res.run_records)
    ok = (machines.keys() == want["machines"].keys()
          and factors.keys() == want["factors"].keys()
          and all(rel_err(a, b) <= 1e-12 for k in machines
                  for a, b in zip(machines[k], want["machines"][k]))
          and all(rel_err(a, b) <= 1e-12 for k in factors
                  for a, b in zip(factors[k], want["factors"][k]))
          and len(floats) == len(want["floats"])
          and all(rel_err(a, b) <= 1e-12
                  for a, b in zip(floats, want["floats"])))
    compiles = {e: m["compiles"]
                for e, m in res.summary["meta"]["editions"].items()}
    print(f"campaign edition study {study}: {len(res.run_records)} runs "
          f"host_wall_s={swall:.3f} new bucket shapes per edition={compiles} "
          f"fugaku predicted/published drift={machines.get('fugaku')} "
          f"records_equal={digest == want['skeleton_sha256']} "
          f"drift_and_floats_within_1e-12={ok}", flush=True)
    check(digest == want["skeleton_sha256"] and ok,
          "campaign edition study: records or drift differ from the "
          "reference's")
    check(all(c <= 1 for c in compiles.values()),
          f"campaign edition study: new bucket shapes {compiles}")


# One call of the port's host Python (the DES) in a child interpreter: it
# prints the call's result and wall seconds as JSON.  The DES is
# single-threaded Python, so record_phase runs its cells in several such
# children at once
HOST_CALL = r"""
import importlib, json, sys, time
module, name, args, kwargs = json.loads(sys.argv[1])
call = getattr(importlib.import_module(module), name)
t0 = time.perf_counter()
got = call(*args, **kwargs)
print(json.dumps({"got": got, "wall": time.perf_counter() - t0}))
"""


@contextlib.contextmanager
def host_calls(calls):
    """Start one child interpreter per ``(module, function, args, kwargs)``
    of ``calls`` (``HOST_CALL``), all at once, in the working directory,
    and yield a function that waits for them and returns each one's
    (result, wall seconds) in order.  A child still running when the block
    ends is killed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []

    def results():
        out = []
        for proc, call in zip(procs, calls):
            stdout, stderr = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"{call[0]}.{call[1]}{tuple(call[2])}"
                  f" exited {proc.returncode}: {stderr[-2000:]}")
            res = json.loads(stdout.strip().splitlines()[-1])
            out.append((res["got"], res["wall"]))
        return out
    try:
        for call in calls:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", HOST_CALL, json.dumps(call)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env))
        yield results
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


def record_phase(dev):
    """Slice 8c-p: the dry-run-record predictions and the fault-tolerance
    layer on ``DRYRUN_RECORDS``, written in the reference's schema into
    ``experiments/dryrun`` (the default ``DRYRUN_DIR``, relative to the
    working directory) under a temporary directory.  ``predict_cell`` on
    every record, sec5's three what-ifs, the full-depth DES cells, sec5's
    straggler call, both fault impacts and the restart plan, each against
    the reference's answer: equal (copied host Python), the fastsim fault
    impact within 1e-12.  Only ``simulate_fault_impact`` takes ``dev``
    (its fastsim backend); the rest runs on the host, as the reference's
    does: the DES cells and the straggler call each in a child interpreter
    of its own, all at once (``host_calls``)."""
    from repro_torch.core import predict_cell, whatif
    t_phase = time.perf_counter()
    des_events = des_wall = 0
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        root = os.path.join("experiments", "dryrun")
        os.makedirs(root)
        for name, rec in DRYRUN_RECORDS.items():
            with open(os.path.join(root, name + ".json"), "w") as f:
                json.dump(rec, f)

        for name, want in REFERENCE_RECORD_PREDICT.items():
            t0 = time.perf_counter()
            got = dataclasses.asdict(predict_cell(*name.split("__")))
            wall = time.perf_counter() - t0
            print(f"predict_cell {name}: step_s={got['step_s']!r} "
                  f"compute_s={got['compute_s']!r} memory_s="
                  f"{got['memory_s']!r} collective_s="
                  f"{got['collective_s']!r} equal={got == want} "
                  f"host_wall_s={wall:.6f}", flush=True)
            check(got == want, f"predict_cell {name}: {got} != the "
                  f"reference's {want}")

        base = REFERENCE_RECORD_PREDICT["__".join(RECORD_WHATIF_CELL)]
        for key, kw in RECORD_WHATIF.items():
            t0 = time.perf_counter()
            w = whatif(*RECORD_WHATIF_CELL, **kw)
            wall = time.perf_counter() - t0
            got = dict(w, baseline=dataclasses.asdict(w["baseline"]),
                       whatif=dataclasses.asdict(w["whatif"]))
            want = dict(REFERENCE_RECORD_WHATIF[key],
                        baseline_s=base["step_s"], baseline=base)
            print(f"whatif {'__'.join(RECORD_WHATIF_CELL)} {key}: "
                  f"baseline_s={got['baseline_s']!r} whatif_s="
                  f"{got['whatif_s']!r} speedup={got['speedup']!r} "
                  f"equal={got == want} host_wall_s={wall:.6f}", flush=True)
            check(got == want, f"whatif {key}: {got} != the reference's "
                  f"{want}")

        # the DES cells and the straggler call (two DES runs), each in a
        # child of its own, all at once, while the fault impacts and the
        # restart plan run here
        s = RECORD_STRAGGLER
        des_children = host_calls(
            [("repro_torch.core", "predict_cell_des", list(cell), {})
             for cell in RECORD_DES]
            + [("repro_torch.ft", "simulate_straggler_impact",
                [s["arch"], s["shape"]], {"slowdown": s["slowdown"]})])
        with des_children as des_results:
            record_faults_and_plan(dev)
            *cells, (slow, slow_wall) = des_results()
        for cell, (got, wall) in zip(RECORD_DES, cells):
            name = "__".join(cell)
            want = REFERENCE_RECORD_DES[name]
            des_events += got["events"]
            des_wall += wall
            print(f"predict_cell_des {name}: step_s={got['step_s']!r} "
                  f"min_finish={got['min_finish']!r} events="
                  f"{got['events']} equal={got == want} host_wall_s="
                  f"{wall:.3f} events_per_s={got['events'] / wall:,.0f}",
                  flush=True)
            check(got == want, f"predict_cell_des {name}: {got} != the "
                  f"reference's {want}")

        want = dict(REFERENCE_RECORD_STRAGGLER, baseline_s=REFERENCE_RECORD_DES[
            "__".join((s["arch"], s["shape"], "16x16"))]["step_s"])
        print(f"simulate_straggler_impact {s}: {slow} equal={slow == want} "
              f"host_wall_s={slow_wall:.3f} (two DES runs)", flush=True)
        check(slow == want, f"simulate_straggler_impact: {slow} != the "
              f"reference's {want}")
    print(f"record phase: host_wall_s={time.perf_counter() - t_phase:.3f} "
          f"des_events={des_events} des_host_wall_s={des_wall:.3f} (summed "
          f"over the cells, {len(RECORD_DES)} of them and the straggler "
          f"call run at once) des_events_per_s={des_events / des_wall:,.0f}",
          flush=True)


def record_faults_and_plan(dev):
    """``record_phase``'s fault impacts (fastsim on ``dev``, the DES) and
    restart plan against the reference's answers."""
    from repro_torch.faults import FaultSpec
    from repro_torch.ft import restart_plan_for_faults, simulate_fault_impact
    from repro_torch.workloads import get_workload
    for key, f in FAULT_IMPACT.items():
        wl = get_workload("transformer", **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in f["workload"].items()})
        t0 = time.perf_counter()
        got = simulate_fault_impact(wl, f["platform"],
                                    FaultSpec.from_dict(f["faults"]),
                                    des=f["des"], device=dev)
        wall = time.perf_counter() - t0
        want = REFERENCE_RECORD_FAULTS[key]
        if f["des"]:
            blowup = got.pop("blowup")
            ok = got == want and blowup == math.inf
            err = 0.0
        else:
            err = max(rel_err(got[k], want[k]) for k in want
                      if isinstance(want[k], float))
            ok = (got.keys() == want.keys() and err <= 1e-12
                  and all(got[k] == want[k] for k in want
                          if not isinstance(want[k], float)))
        print(f"simulate_fault_impact {key}: {got} max_rel_err="
              f"{err:.3e} ok={ok} host_wall_s={wall:.3f}", flush=True)
        check(ok, f"simulate_fault_impact {key}: {got} != the "
              f"reference's {want}")

    r = RESTART_SCENARIO
    plan = dataclasses.asdict(restart_plan_for_faults(
        FaultSpec.from_dict(r["faults"]), global_batch=r["global_batch"],
        resume_step=r["resume_step"], old_mesh=tuple(r["old_mesh"]),
        ranks_per_node=r["ranks_per_node"]))
    print(f"restart_plan_for_faults: {plan} "
          f"equal={plan == REFERENCE_RECORD_PLAN}", flush=True)
    check(plan == REFERENCE_RECORD_PLAN, f"restart plan: {plan} != the "
          f"reference's {REFERENCE_RECORD_PLAN}")


def network_phase(rates_k, pairs):
    """The kernel's max-min rates (waterfill on the card, from the main
    path, one per pair of ``frontera_incidence``) against the DES
    Network's progressive filling for every flow of Frontera's 1-ring
    broadcast started together, rtol 1e-4 (the reference kernel test's
    bound)."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.hardware.network import Network
    from repro_torch.platforms import get_platform
    topo = get_platform("frontera").topology()
    eng = Engine()
    net = Network(eng, topo)
    t0 = time.perf_counter()
    for src, dst in pairs:
        net.send(src, dst, 1e12)
    # every flow starts within its route latency (< 1e-3 s); none of them
    # (1e12 bytes at <= 12.5 GB/s) finishes before 1e-3 s
    eng.run(until=1e-3)
    wall = time.perf_counter() - t0
    by_route = {tuple(map(id, f.links)): f.rate for f in net.flows}
    des = torch.tensor([by_route[tuple(map(id, topo.route(s, d)))]
                        for s, d in pairs], dtype=torch.float64)
    kern = rates_k.double().cpu()
    err = float(((kern - des).abs() / des).max())
    print(f"waterfill vs DES Network, frontera 1-ring broadcast: "
          f"flows={len(pairs)} of {len(pairs)} active={len(net.flows)} "
          f"des_alloc_wall_s={wall:.3f} max_rel_err={err:.3e} (rtol 1e-4) "
          f"rates={sorted(set(des.tolist()))}", flush=True)
    check(len(net.flows) == len(pairs), "Network: not every flow started")
    check(err <= 1e-4, f"waterfill vs Network: rel err {err} > 1e-4")


def flash_bound_ms(shape, causal, dtype):
    """The least time for the attention products at ``shape``: the FLOPs
    this call needs (the causal key count of each row, 2 x 2 per element
    of q.k and p.v) at the peak rate for ``dtype``, or q, k, v and the
    output moved once at the HBM rate, whichever is larger."""
    b, s, g, r, hd = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * g * r * hd * pairs
    nbytes = (2 * b * s * g * r * hd + 2 * b * s * g * hd) * (
        torch.finfo(dtype).bits // 8)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_inputs(shape, dtype, dev, seed, sk=None):
    """q (B, S, G, R, hd) and k, v (B, Sk, G, hd), Sk = S unless given."""
    b, s, g, r, hd = shape
    sk = s if sk is None else sk
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, s, g, r, hd, generator=gen, device=dev).to(dtype),
            torch.randn(b, sk, g, hd, generator=gen, device=dev).to(dtype),
            torch.randn(b, sk, g, hd, generator=gen, device=dev).to(dtype))


def visible_mask(sq, sk, causal, dev):
    """(sq, sk) bool: the keys each query position sees."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=dev)
    return (torch.arange(sk, device=dev)[None, :]
            <= torch.arange(sq, device=dev)[:, None])


def bf16_exact(q, k, v, mask):
    """What the bf16 kernel computes, in float64 on its own inputs (q scaled
    and rounded to bfloat16 as the kernel does it), over the keys ``mask``
    allows.  Returns (out, P @ |V|)."""
    qs = (q.float() * (1.0 / math.sqrt(q.shape[4]))).to(q.dtype).double()
    s = torch.einsum("bqgrk,bsgk->bgrqs", qs, k.double())
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return (torch.einsum("bgrqs,bsgk->bqgrk", p, v.double()),
            torch.einsum("bgrqs,bsgk->bqgrk", p, v.double().abs()))


def bf16_excess(out, exact, mag):
    """The largest |out - exact| over its bound, element by element.  The
    bf16 kernel rounds each probability to bfloat16 before P @ V (at most
    u * (P @ |V|) in all) and its output once (at most one ulp of the
    value it rounds); 1.05 leaves room for float32 sums.  At most 1:
    within the bound."""
    slack = BF16_U * mag
    _, e = torch.frexp(exact.abs() + slack)
    ulp = torch.ldexp(torch.ones_like(exact), e - 8)
    return float(((out.double() - exact).abs() / (1.05 * slack + ulp)).max())


def check_flash(shape, causal, dtype, dev, seed, sk=None, f32_bound=False):
    """Kernel against plain version on the same inputs (Sk keys, S unless
    given), and in bf16 also element by element against ``bf16_exact``
    within ``bf16_excess``'s bound (in float32 against ``f32_excess``'s
    with ``f32_bound``); returns the inputs, the max abs error and, in
    bf16, the exact output and P @ |V|."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    q, k, v = flash_inputs(shape, dtype, dev, seed, sk)
    if sk is not None:
        shape = f"{shape} Sk={sk}"
    mask = visible_mask(q.shape[1], k.shape[1], causal, dev)
    out_k = flash_attention_fwd(q, k, v, causal=causal)
    out_p = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(out_k.shape == q.shape and out_k.dtype == dtype,
          f"flash_attention {shape}: output {tuple(out_k.shape)} "
          f"{out_k.dtype}")
    check(bool(torch.isfinite(out_k.float()).all()),
          f"flash_attention {shape}: non-finite output")
    err = float((out_k.float() - out_p.float()).abs().max())
    tol = FLASH_TOL[dtype]
    print(f"flash_attention {shape} causal={causal} {dtype}: "
          f"max_abs_err={err} (tol {tol})", flush=True)
    check(torch.allclose(out_k.float(), out_p.float(), atol=tol, rtol=tol),
          f"flash_attention {shape} causal={causal} {dtype}: kernel != "
          f"plain (max abs err {err})")
    exact = None
    if dtype == torch.float32 and f32_bound:
        excess = f32_excess(out_k, q, k, v, mask)
        print(f"flash_attention {shape} causal={causal} {dtype}: element "
              f"bound max |err| / bound = {excess:.4f} (limit 1)", flush=True)
        check(excess <= 1.0, f"flash_attention {shape} causal={causal} "
                             f"{dtype}: an element is {excess} x its bound")
    if dtype == torch.bfloat16:
        exact = bf16_exact(q, k, v, mask)
        excess = bf16_excess(out_k, *exact)
        print(f"flash_attention {shape} causal={causal} {dtype}: element "
              f"bound max |err| / bound = {excess:.4f} (limit 1)", flush=True)
        check(excess <= 1.0, f"flash_attention {shape} causal={causal} "
                             f"{dtype}: an element is {excess} x its bound")
    return (q, k, v), err, exact


def planted_tile_faults(q, k, v, exact):
    """A bf16 check at a causal prefill shape must reject a kernel that
    loses one 64-key tile for the last 64 query positions: its diagonal
    tile, or the first tile.  Such outputs move by far less than the 2e-2
    absolute limit; the element bound must catch them."""
    s = q.shape[1]
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    causal, late = kpos <= qpos, qpos >= s - 64
    faults = {
        "last_rows_skip_diagonal_tile": causal & ~(late & (kpos >= s - 64)),
        "last_rows_skip_first_tile": causal & ~(late & (kpos < 64))}
    for name, mask in faults.items():
        out = bf16_exact(q, k, v, mask)[0].to(q.dtype)
        excess = bf16_excess(out, *exact)
        err = float((out.double() - exact[0]).abs().max())
        print(f"flash_attention planted fault {name}: max_abs_err={err:.4e} "
              f"(absolute limit {FLASH_TOL[q.dtype]}) element bound max "
              f"|err| / bound = {excess:.4f}", flush=True)
        check(excess > 1.0, f"flash_attention: planted fault {name} reads "
                            f"{excess} x the bound, within it")


def planted_head_fault(q, k, v, exact, causal):
    """At a wide query group the bf16 check must reject a kernel that maps
    the flattened q * R rows to the wrong heads: its output with the R
    heads of each group rotated by one must read above the element
    bound."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    out = flash_attention_fwd(q, k, v, causal=causal).roll(1, dims=3)
    excess = bf16_excess(out, *exact)
    print(f"flash_attention planted fault heads_rotated at "
          f"{tuple(q.shape)} causal={causal}: element bound max |err| / "
          f"bound = {excess:.4f}", flush=True)
    check(excess > 1.0, f"flash_attention: planted fault heads_rotated "
                        f"reads {excess} x the bound, within it")


def sdpa_inputs(q, k, v):
    """q, k, v in scaled_dot_product_attention's (B, heads, S, hd) layout,
    the G x R query heads in group order."""
    b, s, g, r, hd = q.shape
    return (q.reshape(b, s, g * r, hd).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2))


def time_flash(shape, dev, label="the shape ServeEngine's prefill gives it"):
    """The bf16 kernel at ``shape`` causal, timed beside
    scaled_dot_product_attention (the library yardstick) in turns: kernel,
    library, library, kernel; then the plain version."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    q, k, v = flash_inputs(shape, torch.bfloat16, dev, 98)
    qs, ks, vs = sdpa_inputs(q, k, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        return flash_attention_fwd(q, k, v, causal=True)

    def library():
        return sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
    ms = [cuda_ms(kernel)]
    library_ms = [cuda_ms(library), cuda_ms(library)]
    ms.append(cuda_ms(kernel))
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v))
    bound_ms, bound_by = flash_bound_ms(shape, True, torch.bfloat16)
    print(f"flash_attention {shape} causal torch.bfloat16 ({label}): "
          f"ms={ms[0]:.6f},{ms[1]:.6f} plain_ms={plain_ms:.6f} "
          f"library_ms(sdpa)={library_ms[0]:.6f},{library_ms[1]:.6f} "
          f"bound_ms={bound_ms:.6f} ({bound_by})", flush=True)


def flash_phase(dev):
    """(a) the flash kernel against its plain version at the test shapes,
    the MoE and VLM prefill shapes (with the planted tile faults at the
    ragged VLM one) and the wide query groups (R = 16 and 48, with a
    planted head fault in bf16), then timed at qwen2-0.5b's prefill shape beside
    the plain version and scaled_dot_product_attention (the library
    yardstick, never on the port's path), and at the served and the MoE
    and VLM prefill shapes."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    seed = 0
    for shape in FLASH_SHAPES:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                (q, k, v), _, exact = check_flash(shape, causal, dtype, dev,
                                                  seed)
                if (shape, causal, dtype) == (FLASH_VLM, True,
                                              torch.bfloat16):
                    planted_tile_faults(q, k, v, exact)
                if shape in FLASH_WIDE_R and dtype == torch.bfloat16:
                    planted_head_fault(q, k, v, exact, causal)
                del q, k, v, exact
    time_flash(FLASH_SERVED, dev)
    time_flash(FLASH_MOE, dev, f"{MOE_ARCH}'s {MOE_B} x {MOE_S} prefill")
    time_flash(FLASH_VLM, dev, f"{VLM_ARCH}'s 2,880 image + {VLM_PROMPT} "
               "token prefill")
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v), err, exact = check_flash(FLASH_PREFILL, True, dtype, dev,
                                            99)
        if dtype == torch.bfloat16:
            planted_tile_faults(q, k, v, exact)
        del exact
        qs, ks, vs = sdpa_inputs(q, k, v)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True))
        library_ms = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                          enable_gqa=True))
        bound_ms, bound_by = flash_bound_ms(FLASH_PREFILL, True, dtype)
        print(f"flash_attention {FLASH_PREFILL} causal {dtype}: "
              f"ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"library_ms(sdpa)={library_ms:.6f} bound_ms={bound_ms:.6f} "
              f"({bound_by}) max_abs_err={err}", flush=True)
        if dtype == torch.bfloat16:
            rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
    return rec


def lm_params(cfg, dev):
    from repro_torch.models import build_model
    return build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))


def serve_requests(cfg, n=SERVE_REQUESTS, prompt=SERVE_PROMPT,
                   new=SERVE_NEW):
    """The seeded requests of a serve phase (fresh objects each call)."""
    import numpy as np

    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, prompt).astype(np.int32),
        max_new_tokens=new) for i in range(n)]


def serve_max_len(cfg, prompt, new):
    """The engine's cache length: image prefix (vlm), prompt, new tokens."""
    return cfg.n_image_tokens + prompt + new


@contextlib.contextmanager
def served_logits():
    """Every ``ServeEngine`` built inside the block keeps, in the list it
    yields, each prefill and decode call of its model: (kind, the tokens
    fed, the float32 logits over the real vocabulary)."""
    from repro_torch.serve import engine
    real = engine.ServeEngine.__init__
    rows = []

    def recording(self, *args, **kwargs):
        real(self, *args, **kwargs)
        vocab = self.cfg.vocab_size

        def keep(fn, kind):
            def call(*a, **k):
                cache, logits = fn(*a, **k)
                fed = a[1]["tokens"] if kind == "prefill" else a[2]
                rows.append((kind, fed.reshape(-1).tolist(),
                             logits[:, :vocab].float()))
                return cache, logits
            return call
        self.model.prefill = keep(self.model.prefill, "prefill")
        self.model.decode = keep(self.model.decode, "decode")
    engine.ServeEngine.__init__ = recording
    try:
        yield rows
    finally:
        engine.ServeEngine.__init__ = real


def logits_by_request(cfg, rows, reqs, out, slots, new):
    """Request id -> the logits from which the engine chose each of its
    tokens ``out``, read off its model calls ``rows``: per wave of
    ``slots`` requests, each request's prefill, then one decode step over
    the wave per further token.  Each call must be the one that schedule
    expects, told by the tokens it was fed (a prefill the request's
    prompt, decode step t each wave member's token t), or it raises
    ``SmokeFailure``."""
    logits, it = {}, iter(rows)

    def take(kind, fed):
        got = next(it, None)
        check(got is not None and got[:2] == (kind, fed),
              f"serve {cfg.name}: the engine's model calls do not "
              f"follow its waves (expected a {kind} fed {fed[:8]}, got "
              f"{None if got is None else (got[0], got[1][:8])})")
        return got[2]
    for w in range(0, len(reqs), slots):
        wave = reqs[w:w + slots]
        for r in wave:
            logits[r.rid] = [take("prefill", r.prompt.tolist())[0]]
        for t in range(new - 1):
            row = take("decode", [out[r.rid][t] for r in wave])
            for i, r in enumerate(wave):
                logits[r.rid].append(row[i])
    check(next(it, None) is None, f"serve {cfg.name}: the engine made "
                                  "more model calls than its waves")
    return logits


def plain_serve(dev, cfg, params, spec):
    """The requests of ``spec`` (requests, prompt, new tokens, slots)
    served by the engine built without the kernel (the reference engine's
    build).  Returns its tokens and, per request, the logits over the real
    vocabulary from which it chose each token (``logits_by_request``)."""
    from repro_torch.serve import ServeEngine
    n, prompt, new, slots = spec
    reqs = serve_requests(cfg, n, prompt, new)
    with served_logits() as rows:
        ref = ServeEngine(cfg, params, batch_slots=slots,
                          max_len=serve_max_len(cfg, prompt, new),
                          use_kernel=False, device=dev).run(reqs)
    return ref, logits_by_request(cfg, rows, reqs, ref, slots, new)


def compare_served(dev, cfg, params, out, spec=None, plain=None, label=""):
    """The tokens ``out`` under test against a baseline serving the same
    requests: the engine built without the kernel (``plain_serve``), or
    the result ``plain`` of such a run.  Each request's tokens must be
    equal, or part where the baseline's two candidates are a near-tie:
    their logits, in the baseline's own step, within ``PREFILL_LIMIT``
    (the kernel-vs-plain gap allowed for the dtype) of the logits' largest
    magnitude."""
    spec = spec or SERVE_SPEC
    ref, logits = plain or plain_serve(dev, cfg, params, spec)
    check(sorted(out) == sorted(ref) and all(
        len(out[r]) == len(ref[r]) for r in ref),
        f"serve {cfg.dtype}: token counts differ")
    limit = PREFILL_LIMIT[cfg.dtype]
    same = 0
    for rid in sorted(ref):
        t = next((t for t, (a, b) in enumerate(zip(out[rid], ref[rid]))
                  if a != b), None)
        if t is None:
            same += 1
            continue
        lg = logits[rid][t]
        a, b = ref[rid][t], out[rid][t]
        tie = float((lg[a] - lg[b]).abs() / lg.abs().max())
        print(f"serve {cfg.name}{label} {cfg.dtype}: request {rid} first "
              f"differs at token {t} (baseline {a}, tested {b}); their "
              f"logits differ by {tie:.3e} of scale (near-tie limit "
              f"{limit})", flush=True)
        check(tie <= limit, f"serve {cfg.dtype}: tested and baseline "
                            f"engines differ at request {rid} token {t}, "
                            f"not a near-tie ({tie} > {limit})")
    print(f"serve {cfg.name}{label} {cfg.dtype}: tested and baseline "
          f"engines served the same tokens for {same} of {len(ref)} "
          "requests", flush=True)


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.name`` is ``fn`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def planted(fault, layer=12, every=None):
    """A fault in the kernel path: the attention output of ``layer`` (the
    ``layer``-th flash call from 0; with ``every``, each call ``layer``
    modulo ``every``: that layer in every prefill) zeroed, or, for
    "no_causal_mask", the causal mask off in every layer."""
    from repro_torch.kernels.flash_attention import ops
    real = ops.flash_attention
    calls = []

    def faulty(q, k, v, causal=True):
        calls.append(None)
        if fault == "no_causal_mask":
            return real(q, k, v, causal=False)
        out = real(q, k, v, causal=causal)
        hit = ((len(calls) - 1) % every == layer if every
               else len(calls) == layer + 1)
        return torch.zeros_like(out) if hit else out
    with swapped(ops, "flash_attention", faulty):
        yield


def run_prefill(cfg, params, dev, use_kernel, tokens, steps):
    """4 x 2048 prefill then ``steps`` decode steps on fixed tokens;
    returns the prefill wall seconds and every tensor to compare (logits
    over the real vocabulary: the padded entries are -1e30 in both paths
    and would set the scale of the comparison)."""
    from repro_torch.models import build_model
    model = build_model(cfg, use_kernel=use_kernel, device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, {"tokens": tokens[:, :-steps]},
                                      max_len=tokens.shape[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        v = cfg.vocab_size
        outs = [logits[:, :v], cache["k"].clone(), cache["v"].clone()]
        for i in range(steps):
            n = tokens.shape[1] - steps + i
            cache, logits = model.decode(params, cache, tokens[:, n:n + 1])
            outs.append(logits[:, :v])
        outs += [cache["k"], cache["v"]]
    check(all(bool(torch.isfinite(t.float()).all()) for t in outs),
          f"prefill {cfg.dtype} use_kernel={use_kernel}: non-finite output")
    return wall, outs


def gap(outs, ref):
    """Largest gap over the reference's largest magnitude, across all."""
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max()) for a, b in zip(outs, ref))


def prefill_phase(dev, cfg, params):
    """(c) full-width prefill with the kernel against the plain path, in
    float32 and bfloat16, and two planted faults that must read above the
    limit that passes the kernel."""
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size,
                           (PREFILL_B, PREFILL_S + PREFILL_DECODE),
                           generator=gen, device=dev)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        limit = PREFILL_LIMIT[dtype]
        run_prefill(c, params, dev, True, tokens, PREFILL_DECODE)   # warm
        plain_wall, ref = run_prefill(c, params, dev, False, tokens,
                                      PREFILL_DECODE)
        kern_wall, outs = run_prefill(c, params, dev, True, tokens,
                                      PREFILL_DECODE)
        plain_wall2, _ = run_prefill(c, params, dev, False, tokens,
                                     PREFILL_DECODE)
        kern_wall2, _ = run_prefill(c, params, dev, True, tokens,
                                    PREFILL_DECODE)
        g = gap(outs, ref)
        faults = {}
        for fault in ("layer_12_attention_zeroed", "no_causal_mask"):
            with planted(fault):
                faults[fault] = gap(run_prefill(c, params, dev, True, tokens,
                                                PREFILL_DECODE)[1], ref)
        print(f"prefill {cfg.name} {PREFILL_B}x{PREFILL_S} {dtype}: "
              f"wall_s kernel={kern_wall:.4f},{kern_wall2:.4f} "
              f"plain={plain_wall:.4f},{plain_wall2:.4f}; kernel vs plain "
              f"gap={g:.3e} (limit {limit}) over logits, K/V cache and "
              f"{PREFILL_DECODE} decode steps; planted faults read "
              + ", ".join(f"{k}={v:.3e}" for k, v in faults.items()),
              flush=True)
        check(g <= limit, f"prefill {dtype}: kernel vs plain gap {g} > "
                          f"{limit}")
        for k, v in faults.items():
            check(v > limit, f"prefill {dtype}: planted fault {k} reads "
                             f"{v}, within the limit {limit}")


class RoutingLog:
    """The MoE routing decisions of a run (each ``repro_torch.models.moe.
    route`` call's chosen experts, in call order).  ``record()`` keeps the
    decisions of the run inside it; ``replay()`` makes the run inside it
    take them instead, call by call: each call's shape must match, and
    every recorded call must be used, or it raises ``SmokeFailure``.  The
    gate weights stay the replaying run's own probabilities."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def _route(self, fn):
        from repro_torch.models import moe
        real = moe.route
        moe.route = lambda probs, top_k: fn(real, probs, top_k)
        try:
            yield self
        finally:
            moe.route = real

    def record(self):
        self.calls = []

        def recording(real, probs, top_k):
            idx = real(probs, top_k)
            self.calls.append(idx.clone())
            return idx
        return self._route(recording)

    @contextlib.contextmanager
    def replay(self):
        it = iter(self.calls)
        used = []

        def replaying(real, probs, top_k):
            idx = next(it, None)
            check(idx is not None, f"routing replay: call {len(used)} has "
                                   f"no decision ({len(self.calls)} "
                                   "recorded)")
            want = tuple(probs.shape[:-1]) + (top_k,)
            check(tuple(idx.shape) == want,
                  f"routing replay: call {len(used)} routes {want}, the "
                  f"recorded decision is {tuple(idx.shape)}")
            used.append(None)
            return idx.to(probs.device)
        with self._route(replaying):
            yield self
        check(len(used) == len(self.calls),
              f"routing replay: {len(used)} calls of {len(self.calls)} "
              "recorded")

    def flips(self, other):
        """(decisions that differ from ``other``'s, decisions): one per
        token and routing call, in choice order; the runs must make the
        same calls."""
        check(len(self.calls) == len(other.calls)
              and all(a.shape == b.shape
                      for a, b in zip(self.calls, other.calls)),
              "routing: the two runs made different routing calls")
        n = sum(int((a != b).any(dim=-1).sum())
                for a, b in zip(self.calls, other.calls))
        return n, sum(a[..., 0].numel() for a in self.calls)


class StreamLog:
    """The residual stream in a run: every ``Model._dense_layer_fwd`` call's
    (one a layer, in prefill and in the loss's forward; the encdec
    family's encoder layers too) and ``Model._cross_layer_fwd`` call's (an
    encdec decoder layer) input, self-attention output and output, in call
    order, and for the latter the encoder output it reads (``encoded``)
    and its cross-attention output (``cross``).  ``record()`` keeps them;
    ``replay(log)`` also feeds each call the input (and encoder output)
    ``log`` recorded for it, in the call's own dtype, in place of its own:
    each shape must match and every recorded input must be used, or it
    raises ``SmokeFailure``."""

    def __init__(self):
        self.inputs, self.attention, self.outputs = [], [], []
        self.encoded, self.cross = [], []

    @contextlib.contextmanager
    def _hooked(self, source):
        from repro_torch.models import layers, lm
        fwd, attn = lm.Model._dense_layer_fwd, layers.apply_attention
        xfwd, xattn = lm.Model._cross_layer_fwd, layers.apply_cross_attention
        self.inputs, self.attention, self.outputs = [], [], []
        self.encoded, self.cross = [], []
        feed = iter(source.inputs) if source is not None else None
        feed_enc = iter(source.encoded) if source is not None else None

        def take(it, x):
            if it is None:
                return x
            want = next(it, None)
            check(want is not None and want.shape == x.shape,
                  f"stream replay: layer call {len(self.inputs)} takes "
                  f"{tuple(x.shape)}, recorded "
                  f"{None if want is None else tuple(want.shape)}")
            return want.to(x.dtype)

        def layer(model, p_l, x, positions, **kwargs):
            x = take(feed, x)
            self.inputs.append(x)
            out = fwd(model, p_l, x, positions, **kwargs)
            self.outputs.append(out[0])
            return out

        def cross_layer(model, p_l, x, positions, enc_out):
            x, enc_out = take(feed, x), take(feed_enc, enc_out)
            self.inputs.append(x)
            self.encoded.append(enc_out)
            out = xfwd(model, p_l, x, positions, enc_out)
            self.outputs.append(out[0])
            return out

        def attention(*args, **kwargs):
            out = attn(*args, **kwargs)
            self.attention.append(out[0])
            return out

        def cross(*args, **kwargs):
            out = xattn(*args, **kwargs)
            self.cross.append(out)
            return out
        hooks = {(lm.Model, "_dense_layer_fwd"): layer,
                 (lm.Model, "_cross_layer_fwd"): cross_layer,
                 (layers, "apply_attention"): attention,
                 (layers, "apply_cross_attention"): cross}
        with contextlib.ExitStack() as stack:
            for (owner, name), fn in hooks.items():
                stack.enter_context(swapped(owner, name, fn))
            yield self
        if feed is not None:
            check(next(feed, None) is None and next(feed_enc, None) is None,
                  f"stream replay: {len(self.inputs)} layer calls of "
                  f"{len(source.inputs)} recorded")

    def record(self):
        return self._hooked(None)

    def replay(self, log):
        return self._hooked(log)

    def compared(self):
        """Each layer call's attention output and output."""
        return self.attention + self.outputs


def f32_excess(out, q, k, v, mask):
    """The float32 kernel's output against its function evaluated in
    float64 on the same inputs, element by element: the largest
    |out - exact| over its bound (at most 1: within).  The kernel rounds
    q * scale once and sums each score in hd fused steps, so a score is off
    by at most (hd + 1) u sum_i |q_i k_i| <= (hd + 1) u |q| max_j |k_j|,
    and s - m by twice that more; expf is within 2 ulps (4 u).  A score
    error e moves each softmax weight by at most 2e relative, so the
    output by at most 2e (P @ |V|).  The sums of p v and of p over Sk keys,
    rescaled once a 32-key tile, add (Sk + Sk / 32 + 2) u (P @ |V|) each,
    and the division one rounding (u |out|); 1.05 leaves room for
    second-order terms."""
    hd, sk = q.shape[4], k.shape[1]
    qs = q.double() * (1.0 / math.sqrt(hd))
    kd = k.double()
    p = torch.softmax(torch.einsum("bqgrk,bsgk->bgrqs", qs, kd)
                      .masked_fill(~mask, -math.inf), dim=-1)
    exact = torch.einsum("bgrqs,bsgk->bqgrk", p, v.double())
    mag = torch.einsum("bgrqs,bsgk->bqgrk", p, v.double().abs())
    del p
    reach = qs.norm(dim=-1) * kd.norm(dim=-1).amax(dim=1)[:, None, :, None]
    weight = 2 * ((hd + 3) * F32_U * reach + 4 * F32_U)
    rel = weight + 2 * (sk + sk // 32 + 2) * F32_U
    bound = 1.05 * (rel[..., None] * mag + F32_U * exact.abs()) + 1e-300
    return float(((out.double() - exact).abs() / bound).max())


@contextlib.contextmanager
def layer_bounds(excess, gaps=None):
    """Every flash call in the block (one a layer, through
    ``ops.flash_attention``) is held element by element against its own
    function in float64 on the same inputs and mask (``bf16_excess`` in
    bfloat16, ``f32_excess`` in float32); appends each call's largest
    |err| / bound, and, given ``gaps``, its largest gap against
    ``attention_ref`` over the plain output's largest magnitude.  Entered
    inside ``planted``, it sees the fault's output."""
    from repro_torch.kernels.flash_attention import attention_ref, ops
    inner = ops.flash_attention

    def checking(q, k, v, causal=True):
        out = inner(q, k, v, causal=causal)
        mask = visible_mask(q.shape[1], k.shape[1], causal, q.device)
        if q.dtype == torch.bfloat16:
            excess.append(bf16_excess(out, *bf16_exact(q, k, v, mask)))
        else:
            excess.append(f32_excess(out, q, k, v, mask))
        if gaps is not None:
            ref = attention_ref(q, k, v, causal=causal).float()
            gaps.append(float((out.float() - ref).abs().max()
                              / ref.abs().max()))
        return out
    with swapped(ops, "flash_attention", checking):
        yield


def run_scored(cfg, params, dev, use_kernel, tokens, steps, image=None):
    """``run_prefill`` for the MoE and VLM phases: the prefill of
    ``tokens[:, :-steps]`` (behind ``image``, for the vlm family), then
    ``steps`` decode steps, then ``Model.loss`` on the prefill's batch.
    Returns the prefill wall seconds and every tensor to compare: the
    logits over the real vocabulary, the K/V cache after prefill and after
    the last step, and the loss (and, with MoE, its balance term)."""
    from repro_torch.models import build_model
    model = build_model(cfg, use_kernel=use_kernel, device=dev)
    batch = {"tokens": tokens[:, :-steps]}
    if image is not None:
        batch["image_embeds"] = image
    n_img = cfg.n_image_tokens if image is not None else 0
    v = cfg.vocab_size
    with torch.inference_mode():
        (cache, logits), wall = timed(lambda: model.prefill(
            params, batch, max_len=n_img + tokens.shape[1]))
        outs = [logits[:, :v], cache["k"].clone(), cache["v"].clone()]
        for i in range(steps):
            n = tokens.shape[1] - steps + i
            cache, logits = model.decode(params, cache, tokens[:, n:n + 1])
            outs.append(logits[:, :v])
        outs += [cache["k"], cache["v"]]
        loss, met = model.loss(params, batch)
        outs.append(loss)
        if cfg.family == "moe":
            outs.append(met["aux"])
    check(all(bool(torch.isfinite(t.float()).all()) for t in outs),
          f"{cfg.name} {cfg.dtype} use_kernel={use_kernel}: non-finite "
          "output")
    return wall, outs


def scored_phase(dev, cfg, params, tokens, steps, image=None):
    """Teacher-forced prefill, decode and ``Model.loss`` with the kernel
    against the plain path, in float32 and bfloat16: the largest gap over
    the compared outputs within ``PREFILL_LIMIT``, every layer's kernel
    attention output within its element bound (limit 1), and two planted
    faults (the middle layer's attention zeroed, the causal mask off)
    each above both limits.  The compared outputs are the logits, the K/V
    cache, the decode steps and the loss (with MoE, its balance term).

    With MoE every kernel run replays the plain run's routing decisions
    (``RoutingLog``): the router is discrete, and how many decisions
    differ when the kernel run routes on its own is printed with no limit
    beside it.  In bfloat16 each layer is also fed the plain run's input
    to it (``StreamLog``), and the compared outputs are each layer's
    attention output and output, and nothing else: with every layer's
    input replayed the K/V cache and the decode steps (which run no
    flash) equal the plain run's by construction, and the logits and the
    loss follow from the last layer's output.  An MoE layer's output
    dwarfs its attention's (the expert weights' fan-in is the expert
    count, as in the reference's init), so bf16 rounds the stream far
    more coarsely than a layer's attention moves it, and the rounding
    compounds through the stack: the line "stream rounding" prints how
    far the plain path with the kernel's plain version in place of the
    kernel lands from the plain path over the whole model, routing
    replayed (no kernel involved)."""
    from repro_torch.kernels.flash_attention import attention_ref, ops
    moe = cfg.family == "moe"
    mid = cfg.num_layers // 2
    faults = (f"layer_{mid}_attention_zeroed", "no_causal_mask")
    name = f"{cfg.name}" + (f" {cfg.moe_impl}" if moe else "")
    whole = "logits, K/V cache, decode steps and the loss"
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        limit = PREFILL_LIMIT[dtype]
        by_layer = moe and dtype == "bfloat16"
        routes, stream = RoutingLog(), StreamLog()

        def run(*contexts):
            """(prefill wall, compared outputs) of a kernel run inside
            ``contexts``, replaying the plain run's routing (MoE) and
            layer inputs (bf16 MoE)."""
            own = StreamLog()
            with contextlib.ExitStack() as stack:
                for cm in contexts:
                    stack.enter_context(cm)
                if moe:
                    stack.enter_context(routes.replay())
                if by_layer:
                    stack.enter_context(own.replay(stream))
                wall, outs = run_scored(c, params, dev, True, tokens, steps,
                                        image)
            return wall, own.compared() if by_layer else outs
        run_scored(c, params, dev, True, tokens, steps, image)  # warm
        with contextlib.ExitStack() as stack:
            if moe:
                stack.enter_context(routes.record())
            if by_layer:
                stack.enter_context(stream.record())
            plain_wall, base = run_scored(c, params, dev, False, tokens,
                                          steps, image)
        ref = stream.compared() if by_layer else base
        free = RoutingLog()
        with free.record():
            kern_wall = run_scored(c, params, dev, True, tokens, steps,
                                   image)[0]
        kern_wall2 = run()[0]
        reads = {}
        for fault in (None,) + faults:
            excess = []
            outs = run(*([planted(fault, mid)] if fault else []),
                       layer_bounds(excess))[1]
            check(len(excess) == 2 * c.num_layers,
                  f"{name} {dtype}: {len(excess)} flash calls checked, not "
                  f"{c.num_layers} in prefill and {c.num_layers} in loss")
            reads[fault or "kernel"] = (gap(outs, ref), max(excess))
            del outs
        what, routing = whole, ""
        if moe:
            n, total = free.flips(routes)
            what += ", the plain run's routing replayed"
            routing = (f"; {n} of {total} (token, layer) routing decisions "
                       "differ when the kernel run routes on its own")
        if by_layer:
            what = (f"each layer's attention output and output ({len(ref)}"
                    " tensors, prefill and the loss's forward), each layer "
                    "fed the plain run's input and routing (the K/V cache "
                    "and decode steps then equal the plain run's by "
                    "construction, and the logits and loss follow from the "
                    "last layer)")
            with swapped(ops, "flash_attention", attention_ref), \
                    routes.replay():
                floor = gap(run_scored(c, params, dev, True, tokens,
                                       steps, image)[1], base)
            print(f"{name} {dtype} stream rounding, no kernel: the plain "
                  f"path with attention_ref in place of the kernel, routing "
                  f"replayed and the stream free, reads {floor:.3e} from the "
                  f"plain path over {whole}", flush=True)
        g, ex = reads.pop("kernel")
        print(f"{name} {dtype} {tuple(tokens.shape)} teacher-forced: "
              f"wall_s prefill kernel={kern_wall:.4f},{kern_wall2:.4f} "
              f"plain={plain_wall:.4f}; kernel vs plain gap={g:.3e} "
              f"(limit {limit}) over {what}; {2 * c.num_layers} kernel "
              f"attention outputs, largest element |err| / bound {ex:.4f} "
              f"(limit 1){routing}", flush=True)
        print(f"{name} {dtype} planted faults against the limits the kernel "
              f"passes (gap {limit}, element bound 1): " + "; ".join(
                  f"{k} gap={v[0]:.3e} bound={v[1]:.4f}"
                  for k, v in reads.items()), flush=True)
        check(g <= limit, f"{name} {dtype}: kernel vs plain gap {g} > "
                          f"{limit}")
        check(ex <= 1.0, f"{name} {dtype}: a layer's kernel attention "
                         f"output is {ex} x its element bound")
        for k, (fg, fex) in reads.items():
            check(fg > limit and fex > 1.0,
                  f"{name} {dtype}: planted fault {k} reads gap {fg} and "
                  f"element bound {fex}, not above {limit} and 1")


def serve_phase(dev, cfg, params, spec=None):
    """(b) the main path of a dense-stack model (qwen2-0.5b at full width;
    phi3.5-moe, llava-next, stablelm-3b; and zamba2-2.7b's engine):
    ``ServeEngine`` with the kernel in the config's bf16 on ``spec``
    (requests, prompt, new tokens, slots), every port kernel's count 0 just
    before the run and read just after (flash once a layer a prefill, the
    others 0; for the hybrid family every count 0).  Then the same requests
    against the engine built without the kernel in float32 and in
    bfloat16, with MoE routing replayed from the plain run.  Returns the
    run's flash launches."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.serve import ServeEngine
    spec = spec or SERVE_SPEC
    n, prompt, new, slots = spec
    max_len = serve_max_len(cfg, prompt, new)
    name = f"{cfg.name}" + (f" {cfg.moe_impl}" if cfg.moe else "")
    eng = ServeEngine(cfg, params, batch_slots=slots, max_len=max_len,
                      device=dev)
    eng.warm(prompt)
    reqs = serve_requests(cfg, n, prompt, new)
    before = dict(eng.stats)
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    for kernel in counted:
        kernel.launches = 0
    out, wall = timed(lambda: eng.run(reqs))
    launches = {k.__name__: k.launches for k in counted}
    stats = {k: eng.stats[k] - before[k] for k in eng.stats}
    tokens = sum(len(t) for t in out.values())
    print(f"serve {name}: {n} requests x prompt {prompt} + {new} new, "
          f"{slots} slots: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s, stats {stats}, launches "
          f"{launches}", flush=True)
    waves = -(-n // slots)
    check(stats == {"prefills": n, "decode_steps": waves * (new - 1),
                    "tokens_out": n * new}, f"serve {name}: stats {stats}")
    check(all(len(t) == new and all(0 <= x < cfg.vocab_size for x in t)
              for t in out.values()),
          f"serve {name}: a request's tokens are missing or outside the "
          "vocab")
    # the hybrid family's prefill runs plain attention, as the reference's
    flash = 0 if cfg.family == "hybrid" else cfg.num_layers * n
    check(launches == {"masked_min_rows": 0, "ssd_scan": 0,
                       "flash_attention_fwd": flash},
          f"serve {name}: launches {launches}, not flash {flash} "
          f"({cfg.family}: {cfg.num_layers} layers, {n} prefills) and no "
          "other kernel")
    c32 = dataclasses.replace(cfg, dtype="float32")
    out32 = ServeEngine(c32, params, batch_slots=slots, max_len=max_len,
                        device=dev).run(serve_requests(c32, n, prompt, new))
    compare_served(dev, c32, params, out32, spec)
    if cfg.moe is None:
        compare_served(dev, cfg, params, out, spec)
        return launches["flash_attention_fwd"]
    log = RoutingLog()
    with log.record():
        plain = plain_serve(dev, cfg, params, spec)
    with log.replay():
        out_r = ServeEngine(cfg, params, batch_slots=slots, max_len=max_len,
                            device=dev).run(serve_requests(cfg, n, prompt,
                                                           new))
    compare_served(dev, cfg, params, out_r, spec, plain,
                   label=f" {cfg.moe_impl} (routing replayed)")
    return launches["flash_attention_fwd"]


def param_count(tree):
    return sum(param_count(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


def moe_phase(dev):
    """(g) phi3.5-moe-42b-a6.6b at full width, ``MOE_LAYERS`` of its 32
    layers, seeded weights, under each ``moe_impl``: serving, then the
    teacher-forced comparison on ``MOE_B`` x ``MOE_S`` tokens and
    ``MOE_DECODE`` decode steps.  Returns each serve run's flash
    launches, by kernel and path."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    params = lm_params(cfg, dev)
    print(f"{MOE_ARCH} cut to {MOE_LAYERS} of "
          f"{get_config(MOE_ARCH).num_layers} layers: "
          f"{param_count(params)} parameters", flush=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_B, MOE_S + MOE_DECODE),
                           generator=gen, device=dev)
    launches = {}
    for impl in ("einsum", "scatter"):
        c = dataclasses.replace(cfg, moe_impl=impl)
        t0 = time.perf_counter()
        launches[("flash_attention_fwd", f"{MOE_ARCH} {impl} serve")] = \
            serve_phase(dev, c, params, MOE_SERVE)
        scored_phase(dev, c, params, tokens, MOE_DECODE)
        print(f"{MOE_ARCH} {impl}: host wall {time.perf_counter() - t0:.3f} "
              "s", flush=True)
    return launches


def vlm_phase(dev):
    """(h) llava-next-mistral-7b at full width and depth, seeded weights:
    serving behind the zero image prefix, then the teacher-forced
    comparison on 2,880 seeded image embeddings (x 0.1, as the reference's
    smoke tests draw them) and ``VLM_PROMPT`` tokens with ``VLM_DECODE``
    decode steps.  Returns the serve run's flash launches, by kernel and
    path."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    params = lm_params(cfg, dev)
    print(f"{VLM_ARCH}: {param_count(params)} parameters", flush=True)
    launches = {("flash_attention_fwd", f"{VLM_ARCH} serve"): serve_phase(
        dev, cfg, params, VLM_SERVE)}
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, VLM_PROMPT + VLM_DECODE),
                           generator=gen, device=dev)
    image = torch.randn(1, cfg.n_image_tokens, cfg.d_model, generator=gen,
                        device=dev) * 0.1
    scored_phase(dev, cfg, params, tokens, VLM_DECODE, image)
    return launches


def ssd_inputs(shape, dtype, dev, seed, shared=False):
    """x, B, C normal in ``dtype``; dt = softplus(normal) and A = -exp(normal)
    in float32: the reference kernel test's distributions.  With ``shared``,
    B and C are one group's (B, S, 1, N) broadcast to every head as a view
    with head stride 0, as the model's ``_heads_bc`` gives them for
    mamba2-780m (one group)."""
    b, s, h, p, n, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*size):
        return torch.randn(*size, generator=gen, device=dev)
    x = normal(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(normal(b, s, h))
    A = -torch.exp(normal(h))
    if shared:
        return x, dt, A, *(normal(b, s, 1, n).to(dtype).expand(b, s, h, n)
                           for _ in range(2))
    return x, dt, A, normal(b, s, h, n).to(dtype), normal(b, s, h, n).to(dtype)


def ssd_exact(xh, dt, A, Bh, Ch, chunk):
    """The kernel's function in float64 on its own inputs (dt * A rounded to
    float32 as the kernel forms it), and a bound on how far the kernel's
    float32 arithmetic may land from it before the output is rounded.

    The bound follows the kernel's operations, with u = 2^-24: each dot
    product of length K is off by at most K u of its sum of absolute terms
    (C B^T and C h^T over N, the output sum over the chunk's Q positions,
    the state sum over Q); each exp by 2 ulp (4 u) plus its argument's
    error; each product or sum by u.  The exponents come from the chunk's
    cumulative sum of dt * A, which the kernel forms by a two-level scan
    (at most 13 roundings on any path, all terms of one sign):
    |d cum| <= 16 u |cum|.  Errors
    carried in the state are tracked from chunk to chunk.  Returns
    (y, bound), both (B, S, H, P) float64."""
    b, s, h, p = xh.shape
    n = Bh.shape[-1]
    q = min(chunk, s)
    u = F32_U

    def heads_first(t):
        return t.double().movedim(2, 1)
    x, Bd, Cd = heads_first(xh), heads_first(Bh), heads_first(Ch)
    adt, dtd = heads_first(dt * A), heads_first(dt)
    state = torch.zeros(b, h, p, n, dtype=torch.float64, device=xh.device)
    s_abs, s_err = torch.zeros_like(state), torch.zeros_like(state)
    ys, errs = [], []
    for c0 in range(0, s, q):
        sl = slice(c0, min(c0 + q, s))
        m = sl.stop - c0
        xq, Bq, Cq, dq = x[:, :, sl], Bd[:, :, sl], Cd[:, :, sl], dtd[:, :, sl]
        cum = torch.cumsum(adt[:, :, sl], dim=-1)                 # (B,H,m)
        ac = cum.abs()
        ecum = 16 * u * ac + u * ac         # scan error + the subtraction's
        last, elast = cum[..., -1:], ecum[..., -1:]
        causal = torch.ones(m, m, dtype=torch.bool,
                            device=xh.device).tril()
        L = torch.where(causal, torch.exp(cum[..., :, None]
                                          - cum[..., None, :]), 0.0)
        W = L * dq[..., None, :]
        K = (Cq.abs() @ Bq.abs().transpose(-1, -2)) * W           # |M| terms
        xa = xq.abs()
        Ce = Cq * torch.exp(cum)[..., None]
        inter_mag = Ce.abs() @ s_abs.transpose(-1, -2)
        y = ((Cq @ Bq.transpose(-1, -2)) * W) @ xq + Ce @ state.transpose(
            -1, -2)
        Kx = K @ xa
        err = (Kx * ((n + 8) * u + ecum[..., None])
               + (K * ecum[..., None, :]) @ xa
               + inter_mag * ((n + 8) * u + ecum[..., None])
               + Ce.abs() @ s_err.transpose(-1, -2)
               + (q + 1) * u * (Kx + inter_mag))
        ys.append(y)
        errs.append(err)
        dec = torch.exp(last - cum) * dq                          # (B,H,m)
        Sq = xq.transpose(-1, -2) @ (Bq * dec[..., None])
        Sa = xa.transpose(-1, -2) @ (Bq.abs() * dec[..., None])
        Se = xa.transpose(-1, -2) @ (Bq.abs() * (dec * ecum)[..., None])
        el, eel = torch.exp(last)[..., None], elast[..., None]
        new_abs = el * s_abs + Sa
        s_err = (el * s_err + el * s_abs * (6 * u + eel)
                 + Sa * ((q + 8) * u + eel) + Se + u * new_abs)
        state = el * state + Sq
        s_abs = new_abs
    return (torch.cat(ys, dim=2).movedim(1, 2),
            torch.cat(errs, dim=2).movedim(1, 2))


def ssd_excess(out, exact, bound):
    """The largest |out - exact| over its bound plus one ulp of the output
    dtype at the exact value (the kernel rounds y once).  At most 1: within
    the bound."""
    bits = {torch.float32: 24, torch.bfloat16: 8}[out.dtype]
    _, e = torch.frexp(exact.abs() + bound)
    ulp = torch.ldexp(torch.ones_like(exact), e - bits)
    return float(((out.double() - exact).abs() / (bound + ulp)).max())


def ssd_plain_excess(out, plain):
    """The largest |out - plain| over the test's limit atol + rtol |plain|.
    At most 1: within the limit."""
    rtol, atol = SSD_TOL[plain.dtype]
    return float(((out.float() - plain.float()).abs()
                  / (atol + rtol * plain.float().abs())).max())


def ssd_bound_ms(shape, dtype, groups):
    """The least time for the scan at ``shape`` with B and C given for
    ``groups`` groups (``groups`` = H: one per head; 1: one shared by every
    head): the larger of its operations' time and its bytes' time.

    Operations, with causal skipping (C B^T and M x over the Q(Q+1)/2 pairs
    i >= j of each chunk, C h^T and x^T B over all positions).  C B^T
    depends on the group only, so it is counted once per group; its
    operands are the inputs, so in bfloat16 it is priced at the bf16
    tensor-core peak (bf16 products are exact in float32 and accumulate in
    float32) and in float32 at the CUDA-core peak (TF32 would round them).
    The other three products take a float32 operand (M, the state, B's
    decay-weighted rows) and are priced at the float32 peak.  The
    exponentials are not counted.  Bytes: x, B and C (one per group), dt,
    A read once and y written once.  Returns (ms, bound_by, C B^T FLOPs,
    the other products' FLOPs, bytes)."""
    b, s, h, p, n, chunk = shape
    q = min(chunk, s)
    cb = rest = 0
    for c0 in range(0, s, q):
        m = min(q, s - c0)
        cb += m * (m + 1) * n
        rest += m * (m + 1) * p + 4 * m * n * p
    cb *= b * groups
    rest *= b * h
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * s * h * p + 2 * b * s * groups * n) * size + 4 * (
        b * s * h + h)
    t_ops = cb / PEAK_FLOPS[dtype] + rest / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", cb, rest, nbytes)


def check_ssd(shape, dtype, dev, seed, shared=False):
    """Kernel against plain version within the test limits, and element by
    element against ``ssd_exact`` within its bound; returns the inputs, the
    max abs error, the plain output and the exact output with its bound."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    inputs = ssd_inputs(shape, dtype, dev, seed, shared)
    label = f"{shape} {dtype}" + (" B/C shared" if shared else "")
    chunk = shape[-1]
    out = ssd_scan(*inputs, chunk)
    plain = ssd_scan_ref(*inputs, chunk)
    torch.cuda.synchronize()
    check(out.shape == inputs[0].shape and out.dtype == dtype,
          f"ssd_scan {shape}: output {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out.float()).all()),
          f"ssd_scan {shape} {dtype}: non-finite output")
    err = float((out.float() - plain.float()).abs().max())
    within = ssd_plain_excess(out, plain)
    exact = ssd_exact(*inputs, chunk)
    excess = ssd_excess(out, *exact)
    print(f"ssd_scan {label}: max_abs_err={err:.4e} vs plain "
          f"(|err| / test limit {within:.4f}, limit 1); element bound max "
          f"|err| / bound = {excess:.4f} (limit 1)", flush=True)
    check(within <= 1.0, f"ssd_scan {label}: kernel != plain "
                         f"({within} x the test limit)")
    check(excess <= 1.0, f"ssd_scan {label}: an element is {excess} x its "
                         "bound")
    return inputs, err, plain, exact


SSD_FAULTS = ("state_dropped_mid_sequence", "head_0_decay_doubled")


def faulty_scan(scan, fault):
    """``scan`` with a fault planted around the call: the state dropped at
    the middle of S (the scan run on the two halves), or head 0's decay
    rate A doubled."""
    def run(xh, dt, A, Bh, Ch, chunk=256):
        if fault == "state_dropped_mid_sequence":
            half = xh.shape[1] // 2
            return torch.cat([scan(xh[:, sl], dt[:, sl], A, Bh[:, sl],
                                   Ch[:, sl], chunk)
                              for sl in (slice(0, half), slice(half, None))],
                             dim=1)
        A2 = A.clone()
        A2[0] *= 2
        return scan(xh, dt, A2, Bh, Ch, chunk)
    return run


def ssd_pass_times(inputs, chunk):
    """Each of the kernel's three passes' mean device time, by kernel name,
    from torch.profiler captures of 5 calls each.  On the H100 machine,
    once a CPU + CUDA profile has run in the process (the bridge's and the
    fleet's) and a minute or more has passed, a capture can lose whole
    calls' kernel records (kineto's raw records lose them too), so records
    are gathered over up to five captures until every pass has 5, and
    each of the three passes must have 5 or more.  Returns the means and
    the number of records each covers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_scan import ssd_scan
    ssd_scan(*inputs, chunk)
    torch.cuda.synchronize()
    times = {}
    for capture in range(1, 6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                ssd_scan(*inputs, chunk)
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type.name == "CUDA":
                name = next((n for n in ("chunk_state", "state_passing",
                                         "chunk_scan") if n in e.name),
                            e.name)
                times.setdefault(name, []).append(e.time_range.elapsed_us())
        if len(times) == 3 and min(map(len, times.values())) >= 5:
            break
    counts = {k: len(v) for k, v in times.items()}
    print(f"ssd_scan passes: {capture} profiler captures of 5 calls, "
          f"records per pass {counts}", flush=True)
    check(len(times) == 3 and min(counts.values()) >= 5,
          f"ssd_scan passes: the profiler saw {counts} records, not 5 of "
          "each of the three passes")
    return {k: statistics.mean(v) * 1e-3 for k, v in times.items()}, counts


def ssd_phase(dev):
    """(d) the SSD kernel against its plain version and its float64 function
    at every checked shape, two planted faults at each model's shape
    (mamba2-780m's and zamba2-2.7b's), and times there on per-head B and C
    and on one group's B and C shared by all heads (head stride 0), as
    ``Model.loss`` passes them; mamba2-780m's shared bf16 run (the config's
    dtype and the main path's layout) goes in the record."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    seed = 200
    for shape in SSD_SHAPES + SSD_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            check_ssd(shape, dtype, dev, seed)
    rec = {}
    for model, dtype in ((m, d) for m in (SSD_MODEL, SSD_HYBRID)
                         for d in (torch.float32, torch.bfloat16)):
        chunk = model[-1]
        seed = 299 if model == SSD_MODEL else 297
        inputs, err, plain, exact = check_ssd(model, dtype, dev, seed)
        for name in SSD_FAULTS:
            out = faulty_scan(ssd_scan, name)(*inputs, chunk)
            excess = ssd_excess(out, *exact)
            within = ssd_plain_excess(out, plain)
            print(f"ssd_scan {model} planted fault {name} {dtype}: element "
                  f"bound max |err| / bound = {excess:.4e}; |err| / test "
                  f"limit {within:.4e}", flush=True)
            check(excess > 1.0 and within > 1.0,
                  f"ssd_scan: planted fault {name} ({dtype}) reads {excess} "
                  f"x the bound and {within} x the test limit, not above "
                  "both")
        del exact, plain, out
        for shared in (False, True):
            if shared:
                del inputs
                inputs, err, plain, exact = check_ssd(model, dtype, dev,
                                                      seed - 1, shared=True)
                del exact, plain
            groups = 1 if shared else model[2]
            ms = cuda_ms(lambda: ssd_scan(*inputs, chunk))
            plain_ms = cuda_ms(lambda: ssd_scan_ref(*inputs, chunk))
            bound_ms, bound_by, cb, rest, nbytes = ssd_bound_ms(
                model, dtype, groups)
            print(f"ssd_scan {model} {dtype} B/C "
                  f"{'shared by all heads' if shared else 'per head'}: "
                  f"ms={ms:.6f} plain_ms={plain_ms:.6f} "
                  f"bound_ms={bound_ms:.6f} ({bound_by}: C B^T {cb:.4e} "
                  f"FLOPs at the {str(dtype)[6:]} peak + {rest:.4e} at the "
                  f"float32 peak, with causal skipping; {nbytes:.4e} bytes) "
                  f"bound/ms={bound_ms / ms:.4f} max_abs_err={err}",
                  flush=True)
            if dtype == torch.bfloat16 and shared:
                if model == SSD_MODEL:
                    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": None}
                passes, counts = ssd_pass_times(inputs, chunk)
                print(f"ssd_scan {model} {dtype} B/C shared by all "
                      "heads, each pass's mean device ms (torch.profiler, "
                      "mean of the records counted): " + ", ".join(
                          f"{k}={v:.6f} over {counts[k]}"
                          for k, v in passes.items()), flush=True)
    return rec


@contextlib.contextmanager
def planted_ssd(fault):
    """``faulty_scan``'s fault in the model's kernel path, in every
    layer."""
    from repro_torch.kernels.ssd_scan import ops
    with swapped(ops, "ssd", faulty_scan(ops.ssd, fault)):
        yield


@contextlib.contextmanager
def scan_gaps(gaps):
    """Every ``ops.ssd`` call in the block (one a layer) also runs the
    plain path's chunked scan on the same inputs; appends each layer's
    largest gap over the plain output's largest magnitude, and prints the
    scan's share of the mixer (its RMS over that of x, the D skip term's
    input: D is 1 at init)."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.mamba2 import ssd_chunked
    inner = ops.ssd
    shares = []

    def recording(xh, dt, A, Bh, Ch, chunk=256):
        y = inner(xh, dt, A, Bh, Ch, chunk)
        ref = ssd_chunked(xh, dt, A, Bh, Ch, chunk)[0].float()
        gaps.append(float((y.float() - ref).abs().max() / ref.abs().max()))
        shares.append(float(ref.square().mean().sqrt()
                            / xh.float().square().mean().sqrt()))
        return y
    with swapped(ops, "ssd", recording):
        yield
    if shares:
        print(f"ssm scan share of the mixer (RMS of the scan over RMS of x) "
              f"across {len(shares)} layers: min {min(shares):.3e} max "
              f"{max(shares):.3e}", flush=True)


def logits_gap(logits, ref_logits, vocab):
    """The logits' largest gap over their largest magnitude, over the real
    vocabulary (the padded entries are -1e30 in both)."""
    a, b = logits[..., :vocab].float(), ref_logits[..., :vocab].float()
    return float((a - b).abs().max() / b.abs().max())


def ssm_gap(logits, loss, ref_logits, ref_loss, vocab):
    """The larger of the logits' gap and the loss's relative gap."""
    return max(logits_gap(logits, ref_logits, vocab),
               abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ssm_loss_phase(dev, cfg, params):
    """(e) the main path of the kernel: ``Model.loss`` of mamba2-780m on
    4 x 2048 tokens with the kernel, its launch count read around the
    bfloat16 run (the config's dtype), against the plain chunked scan in
    float32 and bfloat16; two planted faults; in float32, prefill's last
    logits against the kernel forward's last position.  The comparison
    covers each layer's scan output besides the logits and the loss: with
    the reference's init the scan is under 1% of each mixer's output (dt is
    about 0.016 and D is 1), so its faults move the logits far less than
    the scan itself.  Limits: ``SSM_LIMIT`` (float32) and
    ``SSM_SCAN_LIMIT_BF16``, ``SSM_BF16_FROM_F32`` (bfloat16)."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import build_model
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SSM_B, SSM_S),
                                     generator=gen, device=dev)}
    vocab = cfg.vocab_size
    launches = None
    f32 = None
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        kern = build_model(c, use_kernel=True, device=dev)
        plain = build_model(c, use_kernel=False, device=dev)
        kern.loss(params, batch)                        # warm
        ssd_scan.launches = 0
        (loss_k, met_k), wall_k = timed(lambda: kern.loss(params, batch))
        n = ssd_scan.launches
        print(f"ssm loss {cfg.name} {SSM_B}x{SSM_S} {dtype}: ssd_scan "
              f"launches={n} loss={float(loss_k)!r} "
              f"tokens={float(met_k['tokens'])}", flush=True)
        check(n == cfg.num_layers, f"ssm loss {dtype}: ssd_scan launched "
                                   f"{n} times, not {cfg.num_layers}")
        if dtype == cfg.dtype:
            launches = n
        (loss_p, _), wall_p = timed(lambda: plain.loss(params, batch))
        _, wall_k2 = timed(lambda: kern.loss(params, batch))
        _, wall_p2 = timed(lambda: plain.loss(params, batch))
        with torch.inference_mode():
            logits_p = plain.forward(params, batch)[0]
            layers = []
            with scan_gaps(layers):
                logits_k = kern.forward(params, batch)[0]
            check(bool(torch.isfinite(logits_k.float()).all())
                  and bool(torch.isfinite(loss_k)),
                  f"ssm loss {dtype}: non-finite output")
            # (logits and loss gap, largest layer scan gap)
            gaps = {"kernel": (ssm_gap(logits_k, loss_k, logits_p, loss_p,
                                       vocab), max(layers))}
            for fault in SSD_FAULTS:
                with planted_ssd(fault):
                    loss_f, _ = kern.loss(params, batch)
                    layers = []
                    with scan_gaps(layers):
                        lf = kern.forward(params, batch)[0]
                gaps[fault] = (ssm_gap(lf, loss_f, logits_p, loss_p, vocab), max(layers))
                del lf
            for k, (out, scan) in gaps.items():
                print(f"ssm loss {dtype}: {k} vs plain: logits and loss "
                      f"{out:.3e}; largest layer scan gap {scan:.3e}",
                      flush=True)
            if dtype == "bfloat16":
                # each bf16 path against the float32 kernel path
                to32 = [ssm_gap(t, l, *f32, vocab)
                        for t, l in ((logits_k, loss_k), (logits_p, loss_p))]
                print(f"ssm loss bfloat16 against the float32 kernel path's "
                      f"logits and loss: kernel {to32[0]:.3e}, plain "
                      f"{to32[1]:.3e} (limit {SSM_BF16_FROM_F32})",
                      flush=True)
                del f32
            else:
                f32 = (logits_k[..., :vocab].clone(), loss_k)
                last_k = logits_k[:, -1, :vocab]
                del logits_k, logits_p
                _, last_p = kern.prefill(params, batch, max_len=SSM_S)
                cross = float((last_p[:, :vocab].float() - last_k.float())
                              .abs().max() / last_k.float().abs().max())
                print(f"ssm prefill vs forward(use_kernel=True) last "
                      f"position, float32: gap={cross:.3e} (limit 1e-4)",
                      flush=True)
                check(cross <= 1e-4, f"ssm: prefill's last logits differ "
                                     f"from the kernel forward's by {cross}")
        print(f"ssm loss {cfg.name} {SSM_B}x{SSM_S} {dtype}: wall_s "
              f"kernel={wall_k:.4f},{wall_k2:.4f} plain={wall_p:.4f},"
              f"{wall_p2:.4f}", flush=True)
        out, scan = gaps.pop("kernel")
        if dtype == "float32":
            check(max(out, scan) <= SSM_LIMIT,
                  f"ssm loss float32: kernel vs plain gap {max(out, scan)} "
                  f"> {SSM_LIMIT}")
            for k, v in gaps.items():
                check(min(v) > SSM_LIMIT,
                      f"ssm loss float32: planted fault {k} reads {v}, not "
                      f"above the limit {SSM_LIMIT} at the logits and loss "
                      "and at the scans")
        else:
            check(scan <= SSM_SCAN_LIMIT_BF16,
                  f"ssm loss bfloat16: a layer's scan gap {scan} > "
                  f"{SSM_SCAN_LIMIT_BF16}")
            check(max(to32) <= SSM_BF16_FROM_F32,
                  f"ssm loss bfloat16: logits and loss {to32} from the "
                  f"float32 path, > {SSM_BF16_FROM_F32}")
            for k, v in gaps.items():
                check(v[1] > SSM_SCAN_LIMIT_BF16,
                      f"ssm loss bfloat16: planted fault {k} reads {v[1]} "
                      f"at the scans, within {SSM_SCAN_LIMIT_BF16}")
    return launches


def ssm_serve_phase(dev, cfg, params):
    """(f) ServeEngine on full-width mamba2-780m in bf16: prefill and
    decode run no SSD kernel (as in the reference), so launches stay 0."""
    import numpy as np

    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, batch_slots=SSM_SERVE_SLOTS,
                      max_len=SSM_SERVE_PROMPT + SSM_SERVE_NEW, device=dev)
    eng.warm(SSM_SERVE_PROMPT)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, SSM_SERVE_PROMPT).astype(np.int32),
        max_new_tokens=SSM_SERVE_NEW) for i in range(SSM_SERVE_REQUESTS)]
    before = dict(eng.stats)
    ssd_scan.launches = 0
    out, wall = timed(lambda: eng.run(reqs))
    launches = ssd_scan.launches
    stats = {k: eng.stats[k] - before[k] for k in eng.stats}
    tokens = sum(len(t) for t in out.values())
    print(f"serve {cfg.name}: {SSM_SERVE_REQUESTS} requests x prompt "
          f"{SSM_SERVE_PROMPT} + {SSM_SERVE_NEW} new, {SSM_SERVE_SLOTS} "
          f"slots: {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
          f"tokens/s, stats {stats}, ssd_scan launches={launches}",
          flush=True)
    waves = -(-SSM_SERVE_REQUESTS // SSM_SERVE_SLOTS)
    check(stats == {"prefills": SSM_SERVE_REQUESTS,
                    "decode_steps": waves * (SSM_SERVE_NEW - 1),
                    "tokens_out": SSM_SERVE_REQUESTS * SSM_SERVE_NEW},
          f"serve {cfg.name}: stats {stats}")
    check(all(len(t) == SSM_SERVE_NEW and all(0 <= x < cfg.vocab_size
                                              for x in t)
              for t in out.values()),
          f"serve {cfg.name}: a request's tokens are missing or outside the "
          "vocab")
    check(launches == 0, f"serve {cfg.name}: ssd_scan launched {launches} "
                         "times; prefill and decode do not run it")


def flash80_phase(dev):
    """(g) the flash kernel at head_dim 80: zamba2-2.7b's loss shape,
    stablelm-3b's served shape and a ragged shape (Sq and Sk neither equal
    nor multiples of the 128-key tile), in float32 and bfloat16, causal and
    full, against the plain version and element by element against the
    float64 function (``f32_excess``, ``bf16_excess``); the two tile
    faults at the zamba2 shape; then timed at both model shapes beside the
    plain version and scaled_dot_product_attention.  No model runs here,
    so it returns no launches."""
    seed = 500
    for shape, sk in ((FLASH_HYBRID, None), (FLASH_STABLELM, None),
                      FLASH_RAGGED_80):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                (q, k, v), _, exact = check_flash(shape, causal, dtype, dev,
                                                  seed, sk, f32_bound=True)
                if (shape, causal, dtype) == (FLASH_HYBRID, True,
                                              torch.bfloat16):
                    planted_tile_faults(q, k, v, exact)
                del q, k, v, exact
    time_flash(FLASH_HYBRID, dev, f"{HYBRID_ARCH}'s {HYBRID_B} x {HYBRID_S} "
               "loss")
    time_flash(FLASH_STABLELM, dev, f"{STABLELM_ARCH}'s served prompt")
    return {}


def stablelm_phase(dev):
    """(h) stablelm-3b at full width and depth, seeded weights: the dense
    family at head_dim 80, served as qwen2-0.5b is (``SERVE_SPEC``, flash
    once a layer a prefill) and compared with the plain engine in
    bfloat16 and float32.  Returns its flash launches, by kernel and
    path."""
    from repro_torch.configs import get_config
    cfg = get_config(STABLELM_ARCH)
    check(cfg.num_layers * SERVE_REQUESTS == STABLELM_SERVE_LAUNCHES,
          f"{STABLELM_ARCH}: {cfg.num_layers} layers x {SERVE_REQUESTS} "
          f"prefills != {STABLELM_SERVE_LAUNCHES}")
    params = lm_params(cfg, dev)
    print(f"{STABLELM_ARCH}: {param_count(params)} parameters", flush=True)
    n = serve_phase(dev, cfg, params)
    return {("flash_attention_fwd", f"{STABLELM_ARCH} serve"): n}


def hybrid_fault(fault, group):
    """Plants ``fault`` in zamba2's kernel path: an SSD fault in every
    layer's scan, the shared block's application in ``group`` (its flash
    call, from 0) zeroed, or the causal mask off in every one."""
    if fault is None:
        return contextlib.nullcontext()
    if fault in SSD_FAULTS:
        return planted_ssd(fault)
    return planted(fault, group)


def hybrid_run(model, params, batch, fault=None, group=0):
    """``Model.loss`` and ``Model.forward`` with ``fault`` planted (each in
    a planting of its own, so a fault counted by flash call hits the same
    call in both).  Returns the logits, the loss and, from the forward,
    each ssm layer's scan gap and each shared-block application's
    attention gap against the plain versions on the same inputs, and each
    flash call's largest element |err| / bound."""
    with hybrid_fault(fault, group):
        loss, _ = model.loss(params, batch)
    scans, attn, excess = [], [], []
    with hybrid_fault(fault, group), scan_gaps(scans), \
            layer_bounds(excess, attn), torch.inference_mode():
        logits = model.forward(params, batch)[0]
    return logits, loss, scans, attn, excess


def hybrid_loss_phase(dev, cfg, params):
    """(i) zamba2-2.7b's ``Model.loss`` on ``HYBRID_B`` x ``HYBRID_S``
    tokens with the kernels (``ssd_scan`` once an ssm layer, flash once a
    group, read around the run) against the plain path, in float32 and
    bfloat16, and four planted faults: the two ``SSD_FAULTS`` in every
    layer's scan, the shared block zeroed in the middle group and the
    causal mask off.  Each run is read at the logits and loss (against the
    plain path), at every layer's scan and every shared-block
    application's attention (each against its plain version on the same
    inputs) and at every flash call's float64 element bound.

    Gates.  float32: the logits and loss, every scan and every attention
    output within ``SSM_LIMIT``; every element bound within 1.  bfloat16:
    every scan within ``SSM_SCAN_LIMIT_BF16`` and every element bound
    within 1, layer by layer on each kernel call's own inputs.  A fault
    in one kernel must read above every limit that kernel passes (and, in
    float32, the logits' limit), while the other kernel's checks, which
    hold that kernel to its plain version on its own inputs, still pass.
    The bf16 logits are not gated: the "stream rounding" line prints how
    far the kernels' plain versions (``attention_ref``, ``ssd_split_ref``)
    land from the plain path at the logits and loss with no kernel
    involved, and a scan fault moves the float32 logits by less (the scan
    is under 1% of each mixer's output at the reference's init; the share
    line prints it).  In float32, prefill's last logits are held against
    the kernel forward's last position.  Returns the launches of the
    config's dtype."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_split_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    counted = (ssd_scan, flash_attention_fwd)
    want = {"ssd_scan": cfg.num_layers,
            "flash_attention_fwd": cfg.num_layers // cfg.hybrid_period}
    check(want == HYBRID_LOSS_LAUNCHES, f"{cfg.name}: the config gives "
                                        f"{want}, not {HYBRID_LOSS_LAUNCHES}")
    mid = want["flash_attention_fwd"] // 2
    faults = SSD_FAULTS + (f"group_{mid}_attention_zeroed", "no_causal_mask")
    own = {"ssd": ("scan",), "flash": ("attention", "bound")}
    gen = torch.Generator(device=dev).manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (HYBRID_B, HYBRID_S),
                                     generator=gen, device=dev)}
    vocab = cfg.vocab_size
    launches = None
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        kern = build_model(c, use_kernel=True, device=dev)
        plain = build_model(c, use_kernel=False, device=dev)
        kern.loss(params, batch)                        # warm
        for k in counted:
            k.launches = 0
        (loss_k, met), wall_k = timed(lambda: kern.loss(params, batch))
        n = {k.__name__: k.launches for k in counted}
        print(f"hybrid loss {cfg.name} {HYBRID_B}x{HYBRID_S} {dtype}: "
              f"launches {n} loss={float(loss_k)!r} "
              f"tokens={float(met['tokens'])}", flush=True)
        check(n == want, f"hybrid loss {dtype}: launches {n}, not {want}")
        if dtype == cfg.dtype:
            launches = n
        (loss_p, _), wall_p = timed(lambda: plain.loss(params, batch))
        _, wall_k2 = timed(lambda: kern.loss(params, batch))
        _, wall_p2 = timed(lambda: plain.loss(params, batch))
        print(f"hybrid loss {cfg.name} {HYBRID_B}x{HYBRID_S} {dtype}: wall_s "
              f"kernel={wall_k:.4f},{wall_k2:.4f} plain={wall_p:.4f},"
              f"{wall_p2:.4f}", flush=True)
        with torch.inference_mode():
            logits_p = plain.forward(params, batch)[0]
        with swapped(fa_ops, "flash_attention", attention_ref), \
                swapped(ssd_ops, "ssd", ssd_split_ref):
            with torch.inference_mode():
                logits_f = kern.forward(params, batch)[0]
            loss_f, _ = kern.loss(params, batch)
        floor = ssm_gap(logits_f, loss_f, logits_p, loss_p, vocab)
        del logits_f
        print(f"hybrid loss {dtype} stream rounding, no kernel: the plain "
              f"path with attention_ref and ssd_split_ref in place of the "
              f"kernels reads {floor:.3e} from the plain path at the logits "
              "and loss", flush=True)
        reads = {}
        for fault in (None,) + faults:
            logits, loss, scans, attn, excess = hybrid_run(
                kern, params, batch, fault, mid)
            check(len(scans) == want["ssd_scan"]
                  and len(attn) == len(excess) == want["flash_attention_fwd"],
                  f"hybrid loss {dtype}: {len(scans)} scans and {len(attn)} "
                  f"flash calls read, not {want}")
            check(bool(torch.isfinite(logits.float()).all())
                  and bool(torch.isfinite(loss)),
                  f"hybrid loss {dtype} {fault}: non-finite output")
            reads[fault or "kernel"] = {
                "logits": ssm_gap(logits, loss, logits_p, loss_p, vocab),
                "scan": max(scans), "attention": max(attn),
                "bound": max(excess)}
            if fault is None and dtype == "float32":
                last_k = logits[:, -1, :vocab].clone()
            del logits
        del logits_p
        if dtype == "float32":
            with torch.inference_mode():
                _, last_p = kern.prefill(params, batch, max_len=HYBRID_S)
            cross = float((last_p[:, :vocab].float() - last_k.float())
                          .abs().max() / last_k.float().abs().max())
            print(f"hybrid prefill vs forward(use_kernel=True) last "
                  f"position, float32: gap={cross:.3e} (limit 1e-4)",
                  flush=True)
            check(cross <= 1e-4, f"hybrid: prefill's last logits differ "
                                 f"from the kernel forward's by {cross}")
            limits = {"logits": SSM_LIMIT, "scan": SSM_LIMIT,
                      "attention": SSM_LIMIT, "bound": 1.0}
        else:
            limits = {"scan": SSM_SCAN_LIMIT_BF16, "bound": 1.0}
        got = reads.pop("kernel")
        print(f"hybrid loss {dtype} kernel: " + ", ".join(
            f"{g}={got[g]:.3e} (limit {lim})" for g, lim in limits.items()),
            flush=True)
        check(all(got[g] <= lim for g, lim in limits.items()),
              f"hybrid loss {dtype}: kernel reads {got}, limits {limits}")
        for fault, r in reads.items():
            mine = own["ssd" if fault in SSD_FAULTS else "flash"]
            above = [g for g in limits if g in mine or g == "logits"]
            print(f"hybrid loss {dtype} planted fault {fault}: " + ", ".join(
                f"{g}={r[g]:.3e} ({'above' if g in above else 'within'} "
                f"{lim})" for g, lim in limits.items()), flush=True)
            check(all((r[g] > lim) == (g in above)
                      for g, lim in limits.items()),
                  f"hybrid loss {dtype}: planted fault {fault} reads {r}; "
                  f"it must read above {above} and within the rest of "
                  f"{limits}")
    return launches


def hybrid_phase(dev):
    """(i)-(j) zamba2-2.7b at full width and depth, seeded weights: the
    scored loss of ``hybrid_loss_phase``, then ``ServeEngine`` on
    ``HYBRID_SERVE`` in bfloat16 (prefill and decode run no kernel, as in
    the reference) against the plain engine in bfloat16 and float32.
    Returns the loss's launches, by kernel and path."""
    from repro_torch.configs import get_config
    cfg = get_config(HYBRID_ARCH)
    params = lm_params(cfg, dev)
    print(f"{HYBRID_ARCH}: {param_count(params)} parameters", flush=True)
    t0 = time.perf_counter()
    launches = hybrid_loss_phase(dev, cfg, params)
    print(f"{HYBRID_ARCH} loss: host wall {time.perf_counter() - t0:.3f} s",
          flush=True)
    serve_phase(dev, cfg, params, HYBRID_SERVE)
    return {(k, f"{HYBRID_ARCH} loss"): n for k, n in launches.items()}


@contextlib.contextmanager
def encdec_fault(fault, cfg):
    """Plants one of ``ENCDEC_FAULTS`` (None: nothing) in the encdec path:
    the middle decoder layer's cross-attention output zeroed (in every
    forward, prefill and decode step: the entry point runs once a layer, in
    layer order), the encoder's self-attention run causal, the decode
    step's position row taken one row on, or the cross-attention K/V
    rolled by one sequence along the batch inside ``decode``."""
    from repro_torch.models import layers, lm
    if fault is None:
        patch = contextlib.nullcontext()
    elif fault == "cross_attention_zeroed":
        real_x, calls = layers.apply_cross_attention, []

        def zeroed(*args, **kwargs):
            out = real_x(*args, **kwargs)
            calls.append(None)
            mid = (len(calls) - 1) % cfg.num_layers == cfg.num_layers // 2
            return torch.zeros_like(out) if mid else out
        patch = swapped(layers, "apply_cross_attention", zeroed)
    elif fault == "encoder_causal":
        real_a = layers.apply_attention

        def causal(*args, **kwargs):
            return real_a(*args, **dict(kwargs, causal=True))
        patch = swapped(layers, "apply_attention", causal)
    elif fault == "decode_position_off_by_one":
        real_row = lm.decode_position_row
        patch = swapped(lm, "decode_position_row",
                        lambda pos, d, device: real_row(pos + 1, d, device))
    elif fault == "cross_cache_rolled":
        real_dec, real_x = lm.Model.decode, layers.apply_cross_attention

        def rolled(p, x, c, enc_k, enc_v):
            return real_x(p, x, c, enc_k.roll(1, 0), enc_v.roll(1, 0))

        def decode(model, *args, **kwargs):
            with swapped(layers, "apply_cross_attention", rolled):
                return real_dec(model, *args, **kwargs)
        patch = swapped(lm.Model, "decode", decode)
    else:
        raise ValueError(fault)
    with patch:
        yield


def encdec_batch(cfg, dev, seed=6):
    """``ENCDEC_B`` seeded sequences of ``ENCDEC_S`` tokens, each behind its
    own ``encoder_seq`` frames of normals x 0.1 (as the reference's model
    tests draw encoder inputs)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (ENCDEC_B, ENCDEC_S),
                                    generator=gen, device=dev),
            "encoder_embeds": torch.randn(
                ENCDEC_B, cfg.encoder_seq, cfg.d_model, generator=gen,
                device=dev) * 0.1}


def encdec_score(cfg, params, dev, batch, fault=None):
    """``Model.forward``'s logits over the real vocabulary and
    ``Model.loss`` of ``batch`` on ``dev`` (the model built with
    ``use_kernel``, which this family ignores, as the reference does),
    ``fault`` planted; returns (logits, loss, the loss's wall s)."""
    from repro_torch.models import build_model
    model = build_model(cfg, use_kernel=True, device=dev)
    with encdec_fault(fault, cfg):
        (loss, _), wall = timed(lambda: model.loss(params, batch))
        with torch.inference_mode():
            logits = model.forward(params, batch)[0][..., :cfg.vocab_size]
    check(bool(torch.isfinite(logits.float()).all())
          and bool(torch.isfinite(loss)),
          f"{cfg.name} {cfg.dtype}: non-finite logits or loss")
    return logits, loss, wall


def encdec_cached(cfg, params, dev, batch, fault=None):
    """G2's cached path on ``dev``, ``fault`` planted: a prefill of the
    first ``ENCDEC_S - ENCDEC_DECODE`` tokens of every sequence behind its
    encoder frames, then ``ENCDEC_DECODE`` teacher-forced decode steps.
    Returns the logits (B, ENCDEC_DECODE + 1, V) at positions
    ``ENCDEC_S - ENCDEC_DECODE - 1`` to ``ENCDEC_S - 1`` and the prefill's
    wall s."""
    from repro_torch.models import build_model
    model = build_model(cfg, use_kernel=True, device=dev)
    n, v = ENCDEC_S - ENCDEC_DECODE, cfg.vocab_size
    tokens = batch["tokens"]
    with encdec_fault(fault, cfg), torch.inference_mode():
        (cache, last), wall = timed(lambda: model.prefill(params, {
            "tokens": tokens[:, :n],
            "encoder_embeds": batch["encoder_embeds"]}, max_len=ENCDEC_S))
        rows = [last[:, :v]]
        for t in range(n, ENCDEC_S):
            cache, logits = model.decode(params, cache, tokens[:, t:t + 1])
            rows.append(logits[:, :v])
    return torch.stack(rows, 1), wall


def encdec_layer_gaps(cfg, params, dev, batch, log32, fault=None):
    """G3: ``Model.forward`` in bfloat16 with every encoder and decoder
    layer fed the float32 run's input (and each decoder layer its encoder
    output) from ``log32``, ``fault`` planted.  Returns, for each of the
    encoder layers' self-attention and output and the decoder layers'
    self-attention, cross-attention and output, the largest gap over the
    layers against the float32 run, each over the float32 tensor's largest
    magnitude."""
    from repro_torch.models import build_model
    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    log = StreamLog()
    with encdec_fault(fault, cfg), log.replay(log32), torch.inference_mode():
        build_model(c16, use_kernel=True, device=dev).forward(params, batch)
    n = cfg.num_encoder_layers
    pairs = {"encoder self-attention": (log.attention[:n],
                                        log32.attention[:n]),
             "encoder layer": (log.outputs[:n], log32.outputs[:n]),
             "decoder self-attention": (log.attention[n:],
                                        log32.attention[n:]),
             "cross-attention": (log.cross, log32.cross),
             "decoder layer": (log.outputs[n:], log32.outputs[n:])}
    check(all(len(a) == len(b) == (n if k.startswith("encoder")
                                   else cfg.num_layers)
              for k, (a, b) in pairs.items()),
          f"{cfg.name}: the layer replay saw "
          f"{ {k: len(a) for k, (a, _) in pairs.items()} } calls")
    return {k: max(gap([x], [y]) for x, y in zip(a, b))
            for k, (a, b) in pairs.items()}


def encdec_gates(dev, cfg, params, batch, host):
    """The baselines of G1-G3 (see ``encdec_checks``) for ``batch`` on
    ``dev``, and one reading per gate: {gate: (read, limit)}, where
    ``read(fault)`` runs the gate's side under test with ``fault`` planted
    (None: none) and returns its gap.  Also returns the baselines' float32
    logits and loss of the whole batch and the host's wall s."""
    from repro_torch.models import build_model
    c32 = dataclasses.replace(cfg, dtype="float32")
    first = {k: t[:1] for k, t in batch.items()}
    host_params = _to(params, host)
    hl, hloss, host_wall = encdec_score(
        c32, host_params, host, {k: t.to(host) for k, t in first.items()})

    def g1(fault=None):
        logits, loss, _ = encdec_score(c32, params, dev, first, fault)
        return max(gap([logits.to(host)], [hl]),
                   gap([loss.to(host)], [hloss]))

    encdec_score(c32, params, dev, batch)                        # warm
    logits32, loss32, wall32 = encdec_score(c32, params, dev, batch)
    want2 = logits32[:, ENCDEC_S - ENCDEC_DECODE - 1:]

    def g2(fault=None):
        return gap([encdec_cached(c32, params, dev, batch, fault)[0]],
                   [want2])

    log32 = StreamLog()
    with log32.record(), torch.inference_mode():
        build_model(c32, device=dev).forward(params, batch)

    def g3(fault=None):
        return max(encdec_layer_gaps(cfg, params, dev, batch, log32,
                                     fault).values())
    lim32, lim16 = PREFILL_LIMIT["float32"], PREFILL_LIMIT["bfloat16"]
    gates = {"G1": (g1, lim32), "G2": (g2, lim32), "G3": (g3, lim16)}
    return gates, (logits32, loss32, wall32, host_wall, log32)


def encdec_checks(dev, cfg, params, host=torch.device("cpu")):
    """Scoring, the cached path and serving of an encdec model on ``dev``
    against baselines the code under test does not produce there, with
    every port kernel's launch count held at 0 over all of it:

      G1  the first sequence's float32 logits and loss on ``dev`` against
          the same on the ``host`` CPU, the weights copied over (1e-4);
      G2  the float32 cached path (``encdec_cached``) against
          ``Model.forward`` at the same positions (1e-4); the distinct
          encoder inputs of the batch let it see a cross-cache row mix-up,
          which the engine's shared zero frames cannot;
      G3  every bfloat16 layer fed the float32 run's input, against the
          float32 run (``encdec_layer_gaps``; 5e-2); the whole-model bf16
          logits' gap from the float32 ones is printed as the "stream
          rounding", not gated;
      G4  ``ServeEngine`` on ``ENCDEC_SERVE``: the float32 tokens and
          ``stats`` on ``dev`` equal the host CPU engine's, and the
          bfloat16 tokens equal the float32 ones or part at a near-tie in
          the float32 engine's own step (``compare_served``).

    Each of ``ENCDEC_FAULTS``, planted on the ``dev`` side only, must read
    above the limit of every gate it is listed for."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.serve import ServeEngine
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    for kernel in counted:
        kernel.launches = 0
    c32 = dataclasses.replace(cfg, dtype="float32")
    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    name, n = cfg.name, ENCDEC_S - ENCDEC_DECODE
    batch = encdec_batch(cfg, dev)
    gates, (logits32, loss32, wall32, host_wall, log32) = encdec_gates(
        dev, cfg, params, batch, host)
    encdec_score(c16, params, dev, batch)                        # warm
    logits16, loss16, wall16 = encdec_score(c16, params, dev, batch)
    stream = gap([logits16], [logits32])
    pre = {c.dtype: [encdec_cached(c, params, dev, batch)[1]
                     for _ in range(2)][-1] for c in (c32, c16)}
    reads = {g: read() for g, (read, _) in gates.items()}
    layer_gaps = encdec_layer_gaps(cfg, params, dev, batch, log32)
    lim32, lim16 = gates["G1"][1], gates["G3"][1]
    print(f"{name} scoring {ENCDEC_B} x ({cfg.encoder_seq} frames + "
          f"{ENCDEC_S} tokens): Model.loss wall_s float32={wall32:.4f} "
          f"bfloat16={wall16:.4f}, loss {float(loss32):.6f} / "
          f"{float(loss16):.6f}; host CPU float32 Model.loss on one "
          f"sequence {host_wall:.4f} s; prefill of {ENCDEC_B} x {n} wall_s "
          f"float32={pre['float32']:.4f} bfloat16={pre['bfloat16']:.4f}",
          flush=True)
    print(f"{name} G1 card vs host CPU, float32, sequence 0: "
          f"gap={reads['G1']:.3e} (limit {lim32}) over the logits and the "
          "loss", flush=True)
    print(f"{name} G2 prefill of {n} + {ENCDEC_DECODE} decode steps vs "
          f"forward, float32: gap={reads['G2']:.3e} (limit {lim32}) over "
          f"{ENCDEC_DECODE + 1} positions' logits", flush=True)
    print(f"{name} G3 bfloat16 layer by layer on the float32 run's inputs: "
          + ", ".join(f"{k} {v:.3e}" for k, v in layer_gaps.items())
          + f" (limit {lim16})", flush=True)
    print(f"{name} bfloat16 stream rounding: the whole model's bf16 logits "
          f"read {stream:.3e} from the float32 ones (not gated)", flush=True)
    for g, v in reads.items():
        check(v <= gates[g][1], f"{name} {g}: gap {v} > {gates[g][1]}")
    for fault, listed in ENCDEC_FAULTS.items():
        got = {g: gates[g][0](fault) for g in listed}
        print(f"{name} planted fault {fault}: " + ", ".join(
            f"{g} {v:.3e} (limit {gates[g][1]})" for g, v in got.items()),
            flush=True)
        for g, v in got.items():
            check(v > gates[g][1], f"{name}: planted fault {fault} reads "
                                   f"{g} {v}, within the limit "
                                   f"{gates[g][1]}")

    # G4: serving
    spec = ENCDEC_SERVE
    nreq, prompt, new, slots = spec
    max_len = serve_max_len(cfg, prompt, new)
    plain = plain_serve(dev, c32, params, spec)
    host_eng = ServeEngine(c32, _to(params, host), batch_slots=slots,
                           max_len=max_len, device=host)
    host_out = host_eng.run(serve_requests(c32, nreq, prompt, new))
    served = {}
    for c in (c32, c16):
        eng = ServeEngine(c, params, batch_slots=slots, max_len=max_len,
                          device=dev)
        eng.warm(prompt)
        before = dict(eng.stats)
        out, wall = timed(lambda: eng.run(serve_requests(c, nreq, prompt,
                                                         new)))
        stats = {k: eng.stats[k] - before[k] for k in eng.stats}
        tokens = sum(len(t) for t in out.values())
        served[c.dtype] = (out, stats)
        print(f"serve {name} {c.dtype}: {nreq} requests x prompt {prompt} "
              f"+ {new} new, {slots} slots: {tokens} tokens in {wall:.3f} s "
              f"= {tokens / wall:.1f} tokens/s, stats {stats}", flush=True)
    out32, stats32 = served["float32"]
    check(out32 == host_out and stats32 == host_eng.stats,
          f"serve {name} G4: the card's float32 tokens or stats "
          f"{stats32} differ from the host CPU engine's {host_eng.stats}")
    print(f"serve {name} G4: card and host CPU float32 engines served "
          f"equal tokens for all {nreq} requests, stats equal", flush=True)
    compare_served(dev, c16, params, served["bfloat16"][0], spec, plain,
                   label=" (against the float32 engine)")
    launches = {k.__name__: k.launches for k in counted}
    print(f"{name} phase launches: {launches}", flush=True)
    check(not any(launches.values()),
          f"{name}: a kernel of the port was launched on the encdec path "
          f"{launches}")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def encdec_phase(dev):
    """(k) whisper-medium at full width (d_model 1024, 16 heads of 64,
    1500 frames, vocab 51,865; seeded weights), ``ENCDEC_LAYERS`` encoder
    and decoder layers: ``encdec_checks``.  No kernel runs on this path,
    as in the reference, so it returns no launches."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ENCDEC_ARCH),
                              num_layers=ENCDEC_LAYERS,
                              num_encoder_layers=ENCDEC_LAYERS)
    params = lm_params(cfg, dev)
    print(f"{ENCDEC_ARCH}: {param_count(params)} parameters; card "
          f"{card_line()}", flush=True)
    encdec_checks(dev, cfg, params)
    return {}


@contextlib.contextmanager
def launch_fault(fault, cfg):
    """A fault in the code under test, for the card's side only: the
    decode step's K/V write at row ``cache_len % Smax`` (wrapping to the
    first rows) in place of the clamp to the last row; RoPE at the clamped
    row in place of ``cache_len``; or the middle layer's flash output
    zeroed in every prefill (``planted``)."""
    from repro_torch.models import layers as L
    if fault == "flash_layer_zeroed":
        with planted(fault, cfg.num_layers // 2, every=cfg.num_layers):
            yield
        return

    def decode(p, x, cfg, k_cache, v_cache, cache_len):
        clamped = min(cache_len, k_cache.shape[1] - 1)
        row = (cache_len % k_cache.shape[1]
               if fault == "decode_row_wrapped" else clamped)
        pos = clamped if fault == "rope_at_clamped_row" else cache_len
        q, k, v = L._qkv(p, x, cfg, torch.full(
            (x.shape[0], 1), pos, dtype=torch.long, device=x.device))
        k_cache[:, row] = k[:, 0].to(k_cache.dtype)
        v_cache[:, row] = v[:, 0].to(v_cache.dtype)
        out = L.mha(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                    causal=False, kv_len=cache_len + 1, block_size=None)
        return L._out_proj(p, out, x.dtype), (k_cache, v_cache)
    with swapped(L, "apply_attention_decode", decode):
        yield


def launcher_line(line):
    """(requests, tokens, stats, wall s, tokens/s) of the launcher's line."""
    m = LAUNCH_LINE.match(line)
    check(m is not None, f"launcher: not its line: {line!r}")
    return (int(m[1]), int(m[2]), ast.literal_eval(m[5]), float(m[3]),
            float(m[4]))


def launch_run(dev, cfg, params, spec, fault=None, routing=None):
    """``launch.serve.serve`` on ``spec`` (requests, prompt, new tokens,
    slots) on ``dev``, with ``fault`` planted (``launch_fault``), inside
    ``routing()`` where given (a ``RoutingLog``'s record or replay), and
    every port kernel's count 0 just before.  Its printed line must match
    what it returns.  Returns its tokens, stats, wall s, launches and each
    request's logits (``logits_by_request``)."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve as launcher
    n, prompt, new, slots = spec
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    for kernel in counted:
        kernel.launches = 0
    printed = io.StringIO()
    with contextlib.ExitStack() as stack:
        if fault:
            stack.enter_context(launch_fault(fault, cfg))
        if routing:
            stack.enter_context(routing())
        rows = stack.enter_context(served_logits())
        with contextlib.redirect_stdout(printed):
            out, stats, wall = launcher.serve(
                cfg, params, requests=n, prompt_len=prompt, max_new=new,
                batch_slots=slots, device=dev)
    line = launcher_line(printed.getvalue().strip().splitlines()[-1])
    check(line[:3] == (len(out), sum(map(len, out.values())), stats),
          f"launcher {cfg.name}: printed {line[:3]}, served {len(out)} "
          f"requests, stats {stats}")
    return {"out": out, "stats": stats, "wall": wall,
            "launches": {k.__name__: k.launches for k in counted},
            "logits": logits_by_request(cfg, rows, serve_requests(
                cfg, n, prompt, new), out, slots, new)}


def past_cache_gap(cfg, spec, run, host):
    """The largest gap, over the host's largest magnitude, between the
    run's and the host's logits at every decode step that wrote past the
    launcher's cache (prompt + new + 1 positions behind the image prefix),
    in each request whose tokens up to that step equal the host's; and
    how many steps it compared."""
    _, prompt, new, _ = spec
    # token t comes from the decode step at position image + prompt + t - 1
    max_len = prompt + new + 1
    first = max_len - cfg.n_image_tokens - prompt + 1
    gaps = [gap([run["logits"][rid][t].cpu()], [host["logits"][rid][t]])
            for rid in host["out"] for t in range(first, new)
            if run["out"][rid][:t] == host["out"][rid][:t]]
    return max(gaps, default=0.0), len(gaps)


def launch_gates(cfg, spec, run, host, label):
    """Each gate of a card run against the host CPU's run of the same
    weights: {gate: None if it passes, else why not}.
      stats     the engine's stats equal the host's and the schedule's;
      launches  flash once a layer a prefill on the dense stack (dense,
                moe, vlm), no other kernel;
      tokens    float32 equal; bf16 equal or a near-tie in the host's own
                step (``compare_served``);
      logits    (llava) every decode step past the cache within
                ``PREFILL_LIMIT`` of the host's."""
    n, prompt, new, slots = spec
    want = {"prefills": n, "decode_steps": -(-n // slots) * (new - 1),
            "tokens_out": n * new}
    flash = cfg.num_layers * n if cfg.family in ("dense", "moe",
                                                 "vlm") else 0
    launches = {"masked_min_rows": 0, "flash_attention_fwd": flash,
                "ssd_scan": 0}
    gates = {
        "stats": None if run["stats"] == host["stats"] == want else
        f"stats {run['stats']}, host {host['stats']}, schedule {want}",
        "launches": None if run["launches"] == launches else
        f"launches {run['launches']}, not {launches}"}
    if cfg.dtype == "float32":
        gates["tokens"] = None if run["out"] == host["out"] else \
            "float32 tokens differ from the host CPU's"
    else:
        try:
            compare_served(None, cfg, None, run["out"], spec,
                           (host["out"], host["logits"]),
                           f"{label} (card vs host CPU)")
            gates["tokens"] = None
        except SmokeFailure as exc:
            gates["tokens"] = str(exc)
    if cfg.name.startswith(LAUNCH_PAST):
        read, steps = past_cache_gap(cfg, spec, run, host)
        limit = PREFILL_LIMIT[cfg.dtype]
        print(f"launcher {cfg.name} {cfg.dtype}: logits of the decode steps "
              f"past the cache, card vs host CPU: gap={read:.3e} (limit "
              f"{limit}) over {steps} steps", flush=True)
        gates["logits"] = None if steps and read <= limit else \
            f"logits past the cache read {read} over {steps} steps"
    return gates


def launch_check(dev, cfg, params, host_params, spec, check_name,
                 faults=()):
    """``cfg`` served on ``spec`` on ``dev`` and on the host CPU (the code
    as it stands, the same weights; an MoE card run replays the host's
    routing, as the serve phases replay the plain run's): every gate of
    ``launch_gates`` must pass; then each fault of ``faults``, planted on the card's side only,
    must break the gates ``LAUNCH_FAULTS`` lists for it and no other.
    Returns the card run."""
    # an MoE card run takes the host run's routing (RoutingLog)
    log = RoutingLog() if cfg.moe else None
    host = launch_run(torch.device("cpu"), cfg, host_params, spec,
                      routing=log and log.record)
    run = launch_run(dev, cfg, params, spec, routing=log and log.replay)
    tokens = sum(map(len, run["out"].values()))
    label = f" launcher {check_name}"
    print(f"launcher {check_name} {cfg.name} {cfg.dtype}: {tokens} tokens "
          f"in {run['wall']:.3f} s = {tokens / run['wall']:.1f} tokens/s on "
          f"the card, {host['wall']:.3f} s on the host CPU; stats "
          f"{run['stats']}, launches {run['launches']}", flush=True)
    gates = launch_gates(cfg, spec, run, host, label)
    failed = {g: why for g, why in gates.items() if why}
    check(not failed, f"launcher {check_name} {cfg.name} {cfg.dtype}: "
                      f"gates failed: {failed}")
    for fault in faults:
        want = LAUNCH_FAULTS[fault][1]
        faulted = launch_run(dev, cfg, params, spec, fault,
                             log and log.replay)
        got = launch_gates(cfg, spec, faulted, host, label)
        broken = sorted(g for g, why in got.items() if why)
        print(f"launcher {check_name} {cfg.name} {cfg.dtype} planted fault "
              f"{fault}: broke {broken} (must break {sorted(want)}); its "
              f"run took {faulted['wall']:.3f} s", flush=True)
        check(broken == sorted(want), f"launcher: planted fault {fault} "
                                      f"broke {broken}, not {sorted(want)}")
    return run


def launch_faults(where):
    """The faults ``LAUNCH_FAULTS`` plants in check ``where`` (L1 or L2)."""
    return [f for f, (at, _) in LAUNCH_FAULTS.items() if at == where]


def launch_checks(dev, l1_cfg, l1_args, archs):
    """The serving launcher on ``dev``:

      L1  ``python -m repro_torch.launch.serve`` with ``l1_args`` in a
          child process: its printed request and token counts and stats
          are the schedule's.  Then ``launch.serve.serve`` on ``l1_cfg``'s
          launcher weights (``seed_params``), in bf16 and float32, against
          the host CPU's run on the same weights (``launch_check``), with
          the flash fault planted in float32;
      L2  every arch of ``archs`` at the launcher's ``--smoke`` sizes
          (``LAUNCH_L2``) likewise, in float32 and bf16; ``LAUNCH_PAST``'s
          decode steps past the cache also against the host's logits,
          with the decode faults planted in float32.

    Returns the flash launches of L1's bf16 run."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve as launcher
    n, prompt, new, slots = LAUNCH_L1
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"] + l1_args,
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    child_wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"launcher L1: python -m "
                                f"repro_torch.launch.serve exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    got_n, got_tokens, stats, wall, rate = launcher_line(line)
    print(f"launcher L1 {' '.join(l1_args)}: {line!r}; the process took "
          f"{child_wall:.3f} s", flush=True)
    want = {"prefills": n, "decode_steps": -(-n // slots) * (new - 1),
            "tokens_out": n * new}
    check((got_n, got_tokens, stats) == (n, n * new, want),
          f"launcher L1: printed {got_n} requests, {got_tokens} tokens, "
          f"stats {stats}; the schedule gives {n}, {n * new}, {want}")

    params = launcher.seed_params(l1_cfg, dev)
    host_params = _to(params, torch.device("cpu"))
    flash = 0
    for cfg in (l1_cfg, dataclasses.replace(l1_cfg, dtype="float32")):
        faults = launch_faults("L1") if cfg.dtype == "float32" else ()
        run = launch_check(dev, cfg, params, host_params, LAUNCH_L1, "L1",
                           faults)
        if cfg.dtype == "bfloat16":
            flash = run["launches"]["flash_attention_fwd"]
    del params, host_params

    for arch in archs:
        base = reduced(get_config(arch))
        host_params = launcher.seed_params(base, "cpu")
        params = _to(host_params, dev)
        for dtype in ("float32", "bfloat16"):
            faults = (launch_faults("L2") if arch == LAUNCH_PAST
                      and dtype == "float32" else ())
            launch_check(dev, dataclasses.replace(base, dtype=dtype), params,
                         host_params, LAUNCH_L2, "L2", faults)
    return flash


def launch_phase(dev):
    """(l) the serving launcher: L1 at full width on ``LAUNCH_ARCH``
    (``launch_checks``), L2 on every arch at its ``--smoke`` sizes.
    Returns L1's bf16 flash launches, by kernel and path."""
    from repro_torch.configs import ARCHS, get_config
    print(f"launcher: card {card_line()}", flush=True)
    flash = launch_checks(dev, get_config(LAUNCH_ARCH),
                          ["--arch", LAUNCH_ARCH, "--requests",
                           str(LAUNCH_L1[0])], sorted(ARCHS))
    return {("flash_attention_fwd", f"{LAUNCH_ARCH} launcher"): flash}


def ckpt_leaves(state):
    """{key: leaf} of a train state in the reference's flatten order (the
    ``NamedTuple``'s fields as ``.params``, ``.opt``, ``.step``; dict keys
    sorted), written here apart from the port's own flatten so that the
    file's key order is held to an independent one."""
    out = {}

    def walk(tree, key):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{key}/{k}")
        else:
            out[key] = tree
    for field in state._fields:
        walk(getattr(state, field), f".{field}")
    return out


def ckpt_data_gate():
    """C1: the port's pipeline at ``CKPT_DATA``: each global batch's SHA-256
    equals the reference's, and the shards of every dp in ``CKPT_DP``
    concatenate to it.  Returns the batches by step."""
    import numpy as np
    from repro_torch.data import DataConfig, SyntheticLM
    t0 = time.perf_counter()
    ds = SyntheticLM(DataConfig(**CKPT_DATA))
    batches = {}
    for step, want in REFERENCE_CKPT_BATCH_SHA256.items():
        batch = ds.global_batch_at(step)
        digest = hashlib.sha256(batch.tobytes()).hexdigest()
        check(batch.dtype == np.int64 and digest == want,
              f"ckpt C1: step {step}'s batch ({batch.dtype}) has SHA-256 "
              f"{digest}, the reference's {want}")
        for dp in CKPT_DP:
            parts = np.concatenate([ds.shard_at(step, r, dp)
                                    for r in range(dp)])
            check(np.array_equal(parts, batch),
                  f"ckpt C1: step {step}'s {dp} shards differ from the "
                  "global batch")
        batches[step] = batch
    print(f"ckpt C1 data {CKPT_DATA}: steps {sorted(batches)} SHA-256 equal "
          f"to the reference's, dp {CKPT_DP} shards tile each; "
          f"{time.perf_counter() - t0:.3f} s on the host", flush=True)
    return batches


def device_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ckpt_loss(model, params, tokens, dev):
    """``Model.loss`` of ``tokens`` and its flash launches."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    flash_attention_fwd.launches = 0
    loss = model.loss(params, {"tokens": tokens})[0]
    device_sync(dev)
    return loss, flash_attention_fwd.launches


def flip_bit(npz, key, index, bit):
    """Flip bit ``bit`` of element ``index`` of the float32 leaf ``key``
    in a checkpoint's ``arrays.npz``."""
    import numpy as np
    with np.load(npz) as data:
        arrays = {k: data[k] for k in data.files}
    arrays[key].reshape(-1).view(np.uint32)[index] ^= np.uint32(1 << bit)
    np.savez(npz, **arrays)


@contextlib.contextmanager
def ckpt_fault(fault):
    """A fault in the code under test (``flip_bit`` is planted in the file
    by ``ckpt_run``): restore handing back the m and v trees crosswise,
    or ``AsyncCheckpointer.save`` leaving the host copy to its thread
    (which writes the live state as it finds it then)."""
    import repro_torch.checkpoint as ckpt
    from repro_torch.checkpoint import checkpoint as impl
    if fault == "swap_moments":
        real = ckpt.restore_checkpoint

        def crossed(*args, **kwargs):
            out = real(*args, **kwargs)
            return out._replace(opt=dict(out.opt, m=out.opt["v"],
                                         v=out.opt["m"]))
        with swapped(ckpt, "restore_checkpoint", crossed):
            yield
    elif fault == "lazy_snapshot":
        def lazy(self, step, state):
            self.wait()

            def work():
                try:
                    impl.save_checkpoint(self.ckpt_dir, step, state,
                                         keep_last=self.keep_last)
                except BaseException as e:
                    self._error = e
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        with swapped(impl.AsyncCheckpointer, "save", lazy):
            yield
    else:
        yield


def ckpt_gates(dev, tmp, live, snap, r1, r2, losses):
    """{gate: None if it passes, else why not}:
      C2  the synchronous save and restore round-trip the state: step 1's
          manifest lists the leaves in the reference's order with the
          snapshot's shapes and dtypes; each leaf restored from step 1
          equals the snapshot in dtype and value, and each from step 2
          equals its file's array; none shares storage with the live
          state;
      C3  the loss on the restored step 1 parameters, and the second loss
          on the live ones, equal the first bit for bit;
      C4  the async save wrote the state as it was when ``save`` returned:
          step 2's file equals the snapshot leaf for leaf and its manifest
          lists what step 1's does."""
    import numpy as np
    c2, c4 = [], []
    m1 = json.loads((tmp / "step_1" / "manifest.json").read_text())
    m2 = json.loads((tmp / "step_2" / "manifest.json").read_text())
    if list(m1["leaves"]) != list(snap):
        c2.append("step 1's manifest lists its leaves out of order")
    live_ptrs = {t.untyped_storage().data_ptr() for t in live.values()}
    got1, got2 = ckpt_leaves(r1), ckpt_leaves(r2)
    with np.load(tmp / "step_2" / "arrays.npz") as file2:
        for key, want in snap.items():
            meta = {"shape": list(want.shape),
                    "dtype": str(want.dtype).removeprefix("torch.")}
            if m1["leaves"].get(key) != meta:
                c2.append(f"{key}: step 1's manifest {m1['leaves'].get(key)}")
            for got in (got1[key], got2[key]):
                if got.device != dev or \
                        got.untyped_storage().data_ptr() in live_ptrs:
                    c2.append(f"{key}: restored on {got.device}, or on the "
                              "live state's storage")
            t1 = got1[key].cpu()
            if t1.dtype != want.dtype or not torch.equal(t1, want):
                c2.append(f"{key}: step 1 restored differs from the "
                          "snapshot")
            arr = torch.from_numpy(file2[key])
            t2 = got2[key].cpu()
            if t2.dtype != arr.dtype or not torch.equal(t2, arr):
                c2.append(f"{key}: step 2 restored differs from its file")
            if arr.dtype != want.dtype or not torch.equal(arr, want):
                c4.append(f"{key}: step 2's file differs from the snapshot")
    if m2["leaves"] != m1["leaves"]:
        c4.append("step 2's manifest differs from step 1's")
    l0, l1, l2 = losses
    c3 = [] if torch.equal(l0, l2) and torch.equal(l0, l1) else [
        f"losses {float(l0)!r} (live), {float(l1)!r} (live, during the "
        f"async write), {float(l2)!r} (restored step 1)"]
    return {gate: (f"{len(why)} failures, first {why[:3]}" if why else None)
            for gate, why in (("C2", c2), ("C3", c3), ("C4", c4))}


def ckpt_run(dev, cfg, tokens, tmp, fault=None, hold=False):
    """One round trip of ``cfg``'s train state through checkpoints under
    ``tmp`` on ``dev``, with ``fault`` planted: the state is made by
    ``make_train_state`` (its moments and counts then filled from the
    seed, as a state mid-run); the first loss, a host snapshot; a
    synchronous save of step 1; an async save of step 2, a second loss
    while it writes, then every ``.opt/m`` leaf updated in place (+1)
    before ``wait``; every live leaf zeroed; steps 1 and 2 restored on
    ``dev``, and a third loss on the restored parameters.  With ``hold``
    the writer thread starts its write only after the in-place update, so
    a host copy left to the thread reads it.  Returns the gates
    (``ckpt_gates``) and the measurements."""
    import repro_torch.checkpoint as ckpt
    from repro_torch.checkpoint import checkpoint as impl
    from repro_torch.models import build_model
    from repro_torch.train import make_train_state
    gen = torch.Generator(device=dev).manual_seed(0)
    state = make_train_state(cfg, gen, device=dev)
    live = ckpt_leaves(state)
    for key, leaf in live.items():
        if key.startswith(".opt/m/"):
            leaf.normal_(generator=gen).mul_(1e-3)
        elif key.startswith(".opt/v/"):
            leaf.uniform_(generator=gen).mul_(1e-6)
    state.opt["count"].fill_(CKPT_MID_STEP)
    state.step.fill_(CKPT_MID_STEP)
    model = build_model(cfg, use_kernel=True, device=dev)
    tokens = torch.from_numpy(tokens).to(dev)
    out = {"bytes": sum(t.numel() * t.element_size() for t in live.values()),
           "leaves": len(live)}
    l0, n0 = ckpt_loss(model, state.params, tokens, dev)
    t0 = time.perf_counter()
    snap = {k: v.detach().to("cpu").clone() for k, v in live.items()}
    out["snapshot_s"] = time.perf_counter() - t0

    writes, released = [], threading.Event()
    write = impl.save_checkpoint

    def timed_write(*args, **kwargs):
        if hold:
            released.wait(600)
        writes.append(time.perf_counter())
        try:
            return write(*args, **kwargs)
        finally:
            writes.append(time.perf_counter())
    with ckpt_fault(fault):
        t0 = time.perf_counter()
        ckpt.save_checkpoint(tmp, 1, state)
        out["save_s"] = time.perf_counter() - t0
        if fault == "flip_bit":
            flip_bit(tmp / "step_1" / "arrays.npz", *CKPT_FLIP)
        with swapped(impl, "save_checkpoint", timed_write):
            ck = ckpt.AsyncCheckpointer(tmp)
            t0 = time.perf_counter()
            ck.save(2, state)
            t1 = time.perf_counter()
            l1, n1 = ckpt_loss(model, state.params, tokens, dev)
            t2 = time.perf_counter()
            for key, leaf in live.items():
                if key.startswith(".opt/m/"):
                    leaf.add_(1)
            device_sync(dev)
            released.set()
            ck.wait()
            t3 = time.perf_counter()
        for leaf in live.values():
            leaf.zero_()
        device_sync(dev)
        t4 = time.perf_counter()
        r1 = ckpt.restore_checkpoint(tmp, 1, state, device=dev)
        device_sync(dev)
        t5 = time.perf_counter()
        r2 = ckpt.restore_checkpoint(tmp, 2, state, device=dev)
        device_sync(dev)
        t6 = time.perf_counter()
    l2, n2 = ckpt_loss(model, r1.params, tokens, dev)
    w0, w1 = writes
    out.update({
        "async_return_s": t1 - t0, "async_write_s": w1 - w0,
        "async_s": t3 - t0, "loss_s": t2 - t1,
        "overlap_s": max(0.0, min(t2, w1) - max(t1, w0)),
        "restore1_s": t5 - t4, "restore2_s": t6 - t5,
        "losses": (float(l0), float(l1), float(l2)),
        "launches": (n0, n1, n2)})
    out["gates"] = ckpt_gates(dev, tmp, live, snap, r1, r2, (l0, l1, l2))
    return out


def ckpt_checks(dev, cfg, tokens, fault_cfg, fault_tokens, root):
    """The checkpoint round trip (``ckpt_run``) of ``cfg`` on ``tokens``
    under ``root``: gates C2-C4 must pass, each loss must launch flash
    once a layer, and the rates are printed.  Then on ``fault_cfg`` and
    ``fault_tokens``, with the writer held (``hold``): a clean run must
    pass every gate, and each fault of ``CKPT_FAULTS`` must break the
    gates listed for it and no other.  Returns the first run's flash
    launches: (the two losses on the live state, the loss on the restored
    parameters)."""
    from pathlib import Path
    root = Path(root)
    usage = shutil.disk_usage(root)
    print(f"ckpt disk under the temporary directory: {usage.free} bytes "
          f"free of {usage.total}", flush=True)
    run = ckpt_run(dev, cfg, tokens, root / "full")
    gb = run["bytes"] / 1e9
    print(f"ckpt {cfg.name}: state {run['bytes']} bytes ({gb:.3f} GB) in "
          f"{run['leaves']} leaves; card {card_line()}", flush=True)
    print(f"ckpt {cfg.name}: host snapshot {run['snapshot_s']:.3f} s; save "
          f"step 1 {run['save_s']:.3f} s = {gb / run['save_s']:.3f} GB/s; "
          f"async save step 2: save() returned in "
          f"{run['async_return_s']:.3f} s, the thread wrote for "
          f"{run['async_write_s']:.3f} s, save() to wait() "
          f"{run['async_s']:.3f} s = {gb / run['async_s']:.3f} GB/s; the "
          f"second loss took {run['loss_s']:.4f} s, {run['overlap_s']:.4f} s "
          f"of it under the write "
          f"({run['overlap_s'] / max(run['async_write_s'], 1e-9):.4f} of the "
          f"write); restore step 1 {run['restore1_s']:.3f} s = "
          f"{gb / run['restore1_s']:.3f} GB/s, step 2 "
          f"{run['restore2_s']:.3f} s = {gb / run['restore2_s']:.3f} GB/s",
          flush=True)
    shutil.rmtree(root / "full")
    flash = cfg.num_layers
    print(f"ckpt {cfg.name}: gates {run['gates']}; losses "
          f"{run['losses']}; flash launches {run['launches']} (each "
          f"{flash})", flush=True)
    failed = {g: why for g, why in run["gates"].items() if why}
    check(not failed, f"ckpt {cfg.name}: gates failed: {failed}")
    check(run["launches"] == (flash,) * 3,
          f"ckpt {cfg.name}: flash launches {run['launches']}, not "
          f"{flash} a loss")
    for fault in (None,) + tuple(CKPT_FAULTS):
        t0 = time.perf_counter()
        got = ckpt_run(dev, fault_cfg, fault_tokens, root / f"{fault}",
                       fault, hold=True)
        shutil.rmtree(root / f"{fault}")
        broken = sorted(g for g, why in got["gates"].items() if why)
        want = sorted(CKPT_FAULTS.get(fault, ()))
        print(f"ckpt {fault_cfg.name} planted fault {fault}: broke {broken} "
              f"(must break {want}); {got['gates']}; "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        check(broken == want, f"ckpt: planted fault {fault} broke {broken}, "
                              f"not {want}")
        check(got["launches"] == (fault_cfg.num_layers,) * 3,
              f"ckpt {fault_cfg.name}: flash launches {got['launches']}")
    return run["launches"]


def ckpt_phase(dev):
    """(m) the host side of training: C1 on the data pipeline, then
    ``ckpt_checks`` on a full-width ``CKPT_ARCH`` train state (~5.93 GB)
    on step 0's global batch, its faults on the reduced config under a
    temporary directory removed at the end.  Returns the flash launches by
    path."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    batches = ckpt_data_gate()
    fault_tokens = SyntheticLM(DataConfig(**CKPT_FAULT_DATA)).global_batch_at(0)
    root = tempfile.mkdtemp(prefix="ckpt_phase_")
    try:
        n0, n1, n2 = ckpt_checks(dev, get_config(CKPT_ARCH), batches[0],
                                 reduced(get_config(CKPT_ARCH)),
                                 fault_tokens, root)
    finally:
        shutil.rmtree(root)
    return {("flash_attention_fwd", f"{CKPT_ARCH} ckpt loss"): n0 + n1,
            ("flash_attention_fwd", f"{CKPT_ARCH} ckpt restored loss"): n2}


def keyed(tree):
    """{key: leaf} of a tree in the port's flatten order."""
    from repro_torch._tree import map_with_keys
    out = {}
    map_with_keys(out.__setitem__, tree)
    return out


def leaf_gaps(got, want):
    """{key: max |got - want| / max |want|} over two trees of one layout
    (either may be flat, {key: leaf}; ``want``'s leaves tensors or numpy
    arrays), on ``want``'s device (a leaf of zeros: max |got|).  The keys
    and each leaf's shape must agree."""
    got, want = keyed(got), keyed(want)
    check(sorted(got) == sorted(want),
          f"leaf_gaps: {sorted(set(got) ^ set(want))} in one tree only")
    out = {}
    for key, w in want.items():
        w = torch.as_tensor(w)
        g = got[key].detach().to(w.device)
        check(g.shape == w.shape, f"leaf_gaps: {key} {tuple(g.shape)} vs "
                                  f"{tuple(w.shape)}")
        diff = float((g.float() - w.float()).abs().max()) if w.numel() else 0.0
        scale = float(w.float().abs().max()) if w.numel() else 0.0
        out[key] = diff / scale if scale > 0 else diff
    return out


def leaf_norm_gaps(got, want):
    """{key: ||got - want|| / ||want||} over two trees of one layout, in
    float32 on ``want``'s device (a leaf of zeros: ||got||); a leaf
    stacked on the layer axis (under ``layers``) layer by layer, as
    ``key[i]``, so that one layer's fault is not diluted by the others."""
    got = keyed(got)
    out = {}
    for key, w in keyed(want).items():
        w = w.float()
        d = got[key].to(w.device).float() - w
        if key.startswith("layers/"):
            diffs = torch.linalg.vector_norm(d.flatten(1), dim=1).tolist()
            scales = torch.linalg.vector_norm(w.flatten(1), dim=1).tolist()
            keys = [f"{key}[{i}]" for i in range(len(scales))]
        else:
            diffs, scales = [float(torch.linalg.vector_norm(d))], [
                float(torch.linalg.vector_norm(w))]
            keys = [key]
        for k, diff, scale in zip(keys, diffs, scales):
            out[k] = diff / scale if scale > 0 else diff
    return out


def worst(gaps):
    """The largest gap and its key."""
    key = max(gaps, key=gaps.get)
    return gaps[key], key


@contextlib.contextmanager
def train_fault(fault, cfg):
    """A fault in the code under test (``TRAIN_FAULTS``): the attention
    output of layer ``num_layers // 2`` detached (found by its ``wq``
    slice's place in the stacked leaf, so a remat recompute cuts it too),
    in every dtype or in bf16 only; AdamW's bias corrections at the count
    before the step; the microbatch gradients left summed; or
    ``make_train_step`` building its model in float32 whatever the
    config's dtype."""
    from repro_torch.models import layers
    from repro_torch.train import optimizer, step
    if fault in ("attention_cut", "bf16_attention_cut"):
        real = layers.apply_attention
        cut = cfg.num_layers // 2
        bf16_only = fault == "bf16_attention_cut"

        def detached(p, x, *args, **kwargs):
            out, kv = real(p, x, *args, **kwargs)
            wq = p["wq"]
            if wq.storage_offset() == cut * wq.numel() and (
                    not bf16_only or out.dtype == torch.bfloat16):
                out = out.detach()
            return out, kv
        with swapped(layers, "apply_attention", detached):
            yield
    elif fault == "bf16_as_float32":
        real = step.build_model
        with swapped(step, "build_model", lambda c, **kw: real(
                dataclasses.replace(c, dtype="float32"), **kw)):
            yield
    elif fault == "stale_bias_correction":
        real = optimizer._bias_correction
        with swapped(optimizer, "_bias_correction",
                     lambda b, count, device: real(b, count - 1, device)):
            yield
    elif fault == "microbatch_sum":
        with swapped(step, "_microbatch_mean", lambda total, n: list(total)):
            yield
    else:
        yield


def train_host_run(cfg, state, batch, host):
    """The host's float32 step on ``state`` (on ``host``): the gradients
    (``loss_and_grads``) and the AdamW update, as ``train_step`` takes
    them.  Returns them with the loss, the pre-clip norm and the wall."""
    from repro_torch.train import adamw_update
    from repro_torch.train.step import loss_and_grads
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(cfg, device=host)
    loss, _, grads = loss_and_grads(model, state.params, batch)
    params, opt, gn = adamw_update(state.params, grads, state.opt,
                                   lr=TRAIN_LR)
    return {"loss": float(loss), "grad_norm": float(gn), "grads": grads,
            "new": {"params": params, "m": opt["m"], "v": opt["v"]},
            "count": int(opt["count"]), "wall_s": time.perf_counter() - t0}


def train_bf16(dev, cfg, state, batch, grads, loss, r):
    """T5 into ``r``: two steps of ``make_train_step(cfg)`` as configured
    (bf16 compute) on ``state`` (each timed, each finite), and its loss
    and gradients against this run's float32 ``loss`` and ``grads``."""
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads
    step16, model16 = make_train_step(cfg, lr=TRAIN_LR, device=dev)
    r["bf16 walls"], r["T5 finite"] = [], True
    for _ in range(2):
        device_sync(dev)
        t0 = time.perf_counter()
        new, metrics = step16(state, batch)
        device_sync(dev)
        r["bf16 walls"].append(time.perf_counter() - t0)
        r["T5 finite"] &= all(
            bool(torch.isfinite(t).all()) for t in keyed(new).values()) \
            and all(math.isfinite(float(v)) for v in metrics.values())
        del new
    r["bf16 loss"] = float(metrics["loss"])
    r["T5 loss"] = rel_err(r["bf16 loss"], loss)
    _, _, g16 = loss_and_grads(model16, state.params, batch)
    gaps = leaf_norm_gaps(g16, grads)
    r["T5 grad"], r["T5 worst"] = worst(gaps)
    r["T5 grad median"] = statistics.median(gaps.values())


def train_card_run(dev, cfg, state, batch, host, fault=None):
    """T1-T3 and T5 on ``dev`` with ``fault`` planted, against ``host``'s
    float32 run (its gradients and update already on ``dev``); ``cfg`` as
    configured, T1-T3 in float32.  Returns (gates: {gate: None if it
    passes, else why}, readings)."""
    from repro_torch.train import adamw_update, make_train_step
    from repro_torch.train.step import compress_grads, loss_and_grads
    lim, r = TRAIN_LIMITS, {}
    cfg16, cfg = cfg, dataclasses.replace(cfg, dtype="float32")
    with train_fault(fault, cfg):
        step, model = make_train_step(cfg, lr=TRAIN_LR, device=dev)
        device_sync(dev)
        t0 = time.perf_counter()
        new, metrics = step(state, batch)
        device_sync(dev)
        r["step_s"] = time.perf_counter() - t0
        r["loss"] = float(metrics["loss"])
        del new
        # T1: the gradients against the host's
        _, _, grads = loss_and_grads(model, state.params, batch)
        r["T1 loss"] = rel_err(r["loss"], host["loss"])
        r["T1 grad_norm"] = rel_err(float(metrics["grad_norm"]),
                                    host["grad_norm"])
        gaps = leaf_gaps(grads, host["grads"])
        r["T1 grad"], r["T1 worst"] = worst(gaps)
        cut = cfg.num_layers // 2
        r["T1 layer attn"] = max(
            float((grads["layers"]["attn"][k][cut]
                   - w[cut]).abs().max() / w.abs().max())
            for k, w in host["grads"]["layers"]["attn"].items())
        train_bf16(dev, cfg16, state, batch, grads, r["loss"], r)
        # T2: the card's update on the host's gradients
        params, opt, _ = adamw_update(state.params, host["grads"], state.opt,
                                      lr=TRAIN_LR)
        r["T2"], r["T2 worst"] = worst(leaf_gaps(
            {"params": params, "m": opt["m"], "v": opt["v"]}, host["new"]))
        r["T2 count"] = (int(opt["count"]), host["count"])
        del params, opt
        # T3: microbatches, int8 compression, two steps at a larger lr
        loss2, _, grads2 = loss_and_grads(model, state.params, batch,
                                          microbatches=2)
        r["T3 microbatch"] = max(rel_err(float(loss2), r["loss"]),
                                 worst(leaf_gaps(grads2, grads))[0])
        del grads2
        comp = keyed(compress_grads(grads))
        r["T3 int8"] = max(
            float((comp[k] - g).abs().max() / (g.abs().max() / 254.0))
            for k, g in keyed(grads).items() if float(g.abs().max()) > 0)
        del comp, grads
        fall, _ = make_train_step(cfg, lr=TRAIN_LR_FALL, device=dev)
        s1, m1 = fall(state, batch)
        _, m2 = fall(s1, batch)
        r["T3 losses"] = (float(m1["loss"]), float(m2["loss"]))
        del s1
    t1 = [f"{k} {r[k]:.3e} > {lim[k]}" for k in
          ("T1 loss", "T1 grad_norm", "T1 grad") if not r[k] <= lim[k]]
    t2 = [f"T2 {r['T2']:.3e} > {lim['T2']} at {r['T2 worst']}"] \
        if not r["T2"] <= lim["T2"] else []
    if r["T2 count"][0] != r["T2 count"][1]:
        t2.append(f"count {r['T2 count']}")
    t3 = [f"microbatches 2 vs 1 {r['T3 microbatch']:.3e} > "
          f"{lim['T3 microbatch']}"] \
        if not r["T3 microbatch"] <= lim["T3 microbatch"] else []
    if not r["T3 int8"] <= TRAIN_INT8_SLACK:
        t3.append(f"int8 {r['T3 int8']:.6f} x scale/2")
    if not r["T3 losses"][1] < r["T3 losses"][0]:
        t3.append(f"losses {r['T3 losses']} do not fall")
    t5 = [] if r["T5 finite"] else ["a bf16 step is not finite"]
    if not r["T5 loss"] <= lim["T5 loss"]:
        t5.append(f"loss {r['T5 loss']:.3e} > {lim['T5 loss']}")
    if not lim["T5 grad floor"] <= r["T5 grad"] <= lim["T5 grad"]:
        t5.append(f"worst gradient leaf {r['T5 grad']:.3e} at "
                  f"{r['T5 worst']} outside [{lim['T5 grad floor']}, "
                  f"{lim['T5 grad']}]")
    gates = {g: ("; ".join(why) if why else None)
             for g, why in (("T1", t1), ("T2", t2), ("T3", t3), ("T5", t5))}
    return gates, r


def train_remat(dev, cfg, state, batch):
    """T4: the float32 loss and gradients under each of ``TRAIN_REMAT``
    against "none" (within ``TRAIN_LIMITS["T4"]``), with each policy's
    wall and peak device memory (GiB, on a card; None on the CPU)."""
    from repro_torch.models import build_model
    from repro_torch.train.step import loss_and_grads
    base, out = None, {}
    for policy in TRAIN_REMAT:
        model = build_model(dataclasses.replace(cfg, remat=policy),
                            device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(model, state.params, batch)
        device_sync(dev)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else None)
        if base is None:
            base, gap = (loss, grads), 0.0
        else:
            gap = max(rel_err(float(loss), float(base[0])),
                      worst(leaf_gaps(grads, base[1]))[0])
        out[policy] = {"gap": gap, "peak_gib": peak, "wall_s": wall}
        del grads
    return out


def train_long(dev, cfg, state, tokens):
    """The gradient pass as configured (``cfg``: bf16 compute) on the
    global batch ``tokens`` of a training sequence length, under each of
    ``TRAIN_LONG_REMAT`` on the card: {policy: its second pass's wall,
    the first's, and the peak device memory in GiB (the resident train
    state included), or None where it ran out of memory}.  Timed, not
    gated: the loss must be finite."""
    from repro_torch.models import build_model
    from repro_torch.train.step import loss_and_grads
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    out = {}
    for policy in TRAIN_LONG_REMAT:
        model = build_model(dataclasses.replace(cfg, remat=policy),
                            device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        try:
            for _ in range(2):
                t0 = time.perf_counter()
                loss, _, grads = loss_and_grads(model, state.params, batch)
                torch.cuda.synchronize(dev)
                walls.append(time.perf_counter() - t0)
                del grads
        except torch.cuda.OutOfMemoryError:
            out[policy] = None
        else:
            check(math.isfinite(float(loss)),
                  f"train long {policy}: loss {float(loss)}")
            out[policy] = {"wall_s": walls[1], "first_s": walls[0],
                           "peak_gib": torch.cuda.max_memory_allocated(dev)
                           / 2**30}
        torch.cuda.empty_cache()
    return out


def train_checks(dev, cfg, tokens, host=torch.device("cpu"),
                 long_tokens=None):
    """The training step's gates on ``cfg`` (float32 unless said) and the
    global batch ``tokens``: the input state is ``make_train_state`` on
    ``dev`` (seed 0) after one ``train_step``; T4 remat; the host's step
    on a copy of it; T1-T3 (``train_card_run``) clean, then with each of
    ``TRAIN_FAULTS`` planted, each of which must break exactly its gates;
    T5 the bf16 step (``cfg`` as configured) in the same runs; T6 the
    kernels refused.  With ``long_tokens`` (a card only), ``train_long``
    times the gradient pass on them.  Returns the measurements."""
    from repro_torch._tree import map_with_keys
    from repro_torch.train import make_train_state, make_train_step
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(0)
    step, _ = make_train_step(cfg32, device=dev)
    state, _ = step(make_train_state(cfg32, gen, device=dev), batch)
    out = {"remat": train_remat(dev, cfg32, state, batch)}
    for policy, got in out["remat"].items():
        peak = got["peak_gib"]
        print(f"train T4 {cfg.name} remat {policy}: loss and gradients "
              f"{got['gap']:.3e} off remat none (limit "
              f"{TRAIN_LIMITS['T4']}); loss and gradients in "
              f"{got['wall_s']:.4f} s, peak device memory "
              + (f"{peak:.2f} GiB" if peak is not None else "not measured"),
              flush=True)
        check(got["gap"] <= TRAIN_LIMITS["T4"],
              f"train T4: remat {policy} {got['gap']:.3e} off remat none")
    if dev.type == "cuda":
        out["remat_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if long_tokens is not None:
        out["long"] = train_long(dev, cfg, state, long_tokens)
        for policy, got in out["long"].items():
            print(f"train {cfg.name} {cfg.dtype} gradient pass at "
                  f"{tuple(long_tokens.shape)} tokens, remat {policy}: "
                  + ("out of memory" if got is None else
                     f"{got['wall_s']:.4f} s (first {got['first_s']:.4f} "
                     f"s), peak device memory {got['peak_gib']:.2f} GiB "
                     "with the train state"), flush=True)
        out["remat_peak_gib"] = max(
            [out["remat_peak_gib"]] + [got["peak_gib"] for got in
                                       out["long"].values() if got])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    host_state = map_with_keys(lambda _, t: t.to(host), state)
    host_batch = {"tokens": torch.from_numpy(tokens).to(host)}
    out["to_host_s"] = time.perf_counter() - t0
    hrun = train_host_run(cfg32, host_state, host_batch, host)
    del host_state
    out["host_step_s"] = hrun["wall_s"]
    t0 = time.perf_counter()
    hrun["grads"] = _to(hrun["grads"], dev)
    hrun["new"] = _to(hrun["new"], dev)
    device_sync(dev)
    out["to_card_s"] = time.perf_counter() - t0
    print(f"train {cfg.name} host step (float32, {tuple(tokens.shape)} "
          f"tokens): {hrun['wall_s']:.3f} s; state to the host "
          f"{out['to_host_s']:.3f} s, its results back "
          f"{out['to_card_s']:.3f} s; loss {hrun['loss']!r} grad_norm "
          f"{hrun['grad_norm']!r}", flush=True)

    for fault in (None,) + tuple(TRAIN_FAULTS):
        t0 = time.perf_counter()
        gates, r = train_card_run(dev, cfg, state, batch, hrun, fault)
        broken = sorted(g for g, why in gates.items() if why)
        want = sorted(TRAIN_FAULTS.get(fault, ()))
        if fault is None:
            out["f32_step_s"], out["f32_loss"] = r["step_s"], r["loss"]
            print(f"train T1 {cfg.name} float32 card vs host: loss "
                  f"{r['T1 loss']:.3e}, grad_norm {r['T1 grad_norm']:.3e}, "
                  f"gradient leaves {r['T1 grad']:.3e} of scale at "
                  f"{r['T1 worst']} (limits {TRAIN_LIMITS['T1 loss']}, "
                  f"{TRAIN_LIMITS['T1 grad_norm']}, "
                  f"{TRAIN_LIMITS['T1 grad']}); card step "
                  f"{r['step_s']:.4f} s, loss {r['loss']!r}", flush=True)
            print(f"train T2 {cfg.name} AdamW on the host's gradients: "
                  f"params, m, v {r['T2']:.3e} of scale at {r['T2 worst']} "
                  f"(limit {TRAIN_LIMITS['T2']}); count {r['T2 count']}",
                  flush=True)
            print(f"train T3 {cfg.name}: microbatches 2 vs 1 "
                  f"{r['T3 microbatch']:.3e} (limit "
                  f"{TRAIN_LIMITS['T3 microbatch']}); int8 worst leaf "
                  f"{r['T3 int8']:.6f} x scale/2 (limit "
                  f"{TRAIN_INT8_SLACK:.6f}); two steps at lr "
                  f"{TRAIN_LR_FALL}: losses {r['T3 losses']}", flush=True)
            out["bf16_step_s"], out["bf16_loss"] = (r["bf16 walls"][-1],
                                                    r["bf16 loss"])
            print(f"train T5 {cfg.name} {cfg.dtype} step: finite "
                  f"{r['T5 finite']}, loss {r['bf16 loss']!r} vs float32 "
                  f"{r['loss']!r}: {r['T5 loss']:.3e} (limit "
                  f"{TRAIN_LIMITS['T5 loss']}); gradient leaves' norm gap "
                  f"to float32: worst {r['T5 grad']:.3e} at {r['T5 worst']},"
                  f" median {r['T5 grad median']:.3e} (limits "
                  f"[{TRAIN_LIMITS['T5 grad floor']}, "
                  f"{TRAIN_LIMITS['T5 grad']}]); step "
                  f"{r['bf16 walls'][-1]:.4f} s (first "
                  f"{r['bf16 walls'][0]:.4f} s)", flush=True)
        print(f"train {cfg.name} planted fault {fault}: broke {broken} (must "
              f"break {want}); {gates}; T1 grad {r['T1 grad']:.3e}, layer "
              f"{cfg.num_layers // 2} attention {r['T1 layer attn']:.3e}, T2 "
              f"{r['T2']:.3e}, T3 microbatch {r['T3 microbatch']:.3e}, T5 "
              f"grad {r['T5 grad']:.3e} at {r['T5 worst']}; "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        check(broken == want, f"train: planted fault {fault} broke {broken}, "
                              f"not {want}")

    # T6: no kernel on the path (the caller holds the counts at 0); the
    # step and the kernels refuse what has no backward
    refused = []
    try:
        make_train_step(cfg, use_kernel=True, device=dev)
    except RuntimeError as e:
        refused.append(f"make_train_step(use_kernel=True): {e}")
    check(len(refused) == 1, "train T6: make_train_step(use_kernel=True) "
                             "did not raise")
    if dev.type == "cuda":
        from repro_torch.kernels.flash_attention import flash_attention_fwd
        from repro_torch.kernels.ssd_scan import ssd_scan
        q = torch.randn(1, 64, 1, 2, 64, device=dev, requires_grad=True)
        k = torch.randn(1, 64, 1, 64, device=dev)
        x = torch.randn(1, 64, 2, 8, device=dev, requires_grad=True)
        dt = torch.rand(1, 64, 2, device=dev)
        a = -torch.ones(2, device=dev)
        bc = torch.randn(1, 64, 2, 16, device=dev)
        for name, call in (
                ("flash_attention_fwd",
                 lambda: flash_attention_fwd(q, k, k.clone())),
                ("ssd_scan", lambda: ssd_scan(x, dt, a, bc, bc.clone(), 64))):
            try:
                call()
            except RuntimeError as e:
                refused.append(f"{name}: {e}")
            else:
                check(False, f"train T6: {name} took inputs that require "
                             "grad")
    print("train T6 refusals: " + " | ".join(refused), flush=True)
    return out


def train_phase(dev):
    """(n) the training step: ``train_checks`` on full-width ``TRAIN_ARCH``
    (494,147,456 parameters, AdamW) and step 0's global batch of
    ``TRAIN_DATA``, with every kernel's launch count held at 0 over the
    phase (training runs the plain paths).  Returns the launches by path
    (0 each)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    for kernel in counted:
        kernel.launches = 0
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    tokens = SyntheticLM(DataConfig(**TRAIN_DATA)).global_batch_at(0)
    long_tokens = SyntheticLM(
        DataConfig(**TRAIN_LONG_DATA)).global_batch_at(0)
    out = train_checks(dev, cfg, tokens, long_tokens=long_tokens)
    torch.cuda.synchronize(dev)
    launches = {k.__name__: k.launches for k in counted}
    peak = max(out["remat_peak_gib"],
               torch.cuda.max_memory_allocated(dev) / 2**30)
    print(f"train {cfg.name}: card step {out['f32_step_s']:.4f} s float32, "
          f"{out['bf16_step_s']:.4f} s {cfg.dtype}; host CPU step "
          f"{out['host_step_s']:.3f} s ({host_cpu()}); peak device memory "
          f"{peak:.2f} GiB; phase wall {time.perf_counter() - t0:.3f} s; "
          f"kernel launches {launches}; card {card_line()}", flush=True)
    check(not any(launches.values()),
          f"train T6: a kernel was launched on the training path {launches}")
    return {(k, f"{TRAIN_ARCH} train"): 0
            for k in ("flash_attention_fwd", "ssd_scan")}


def bits(t):
    """``t``'s bits: a floating tensor viewed as integers of its width."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def unequal_leaves(got, want):
    """The keys of two trees' leaves that differ in key, dtype, shape or
    any bit (compared on ``got``'s device)."""
    got, want = keyed(got), keyed(want)
    out = sorted(set(got) ^ set(want))
    for key in sorted(set(got) & set(want)):
        g, w = got[key], want[key].to(got[key].device)
        if g.dtype != w.dtype or g.shape != w.shape or \
                not torch.equal(bits(g), bits(w)):
            out.append(key)
    return out


@contextlib.contextmanager
def loop_fault(fault, cfg):
    """A fault in the training loop (``LOOP_FAULTS``): after a restore, the
    data stream fed from its first batch again (``shard_at(step -
    start)``); after a restore, the optimizer state started afresh
    (``opt_init`` of the restored parameters); or every step fed the next
    step's batch (``shard_at(step + 1)``)."""
    from repro_torch.train import loop, opt_init
    if fault == "batch_of_next_step":
        class NextBatch(loop.SyntheticLM):
            def shard_at(self, step, dp_rank, dp_size):
                return super().shard_at(step + 1, dp_rank, dp_size)
        with swapped(loop, "SyntheticLM", NextBatch):
            yield
    elif fault == "stream_restarts_on_resume":
        streams, real = [], loop.latest_step

        class Restarted(loop.SyntheticLM):
            start = 0

            def __init__(self, dcfg):
                super().__init__(dcfg)
                streams.append(self)

            def shard_at(self, step, dp_rank, dp_size):
                return super().shard_at(step - self.start, dp_rank, dp_size)

        def latest(ckpt_dir):
            last = real(ckpt_dir)
            streams[-1].start = last or 0
            return last
        with swapped(loop, "SyntheticLM", Restarted), \
                swapped(loop, "latest_step", latest):
            yield
    elif fault == "moments_dropped_on_resume":
        real = loop.restore_checkpoint

        def fresh(*args, **kwargs):
            out = real(*args, **kwargs)
            return out._replace(opt=opt_init(cfg.optimizer)(out.params))
        with swapped(loop, "restore_checkpoint", fresh):
            yield
    else:
        yield


@contextlib.contextmanager
def loop_timers(times):
    """Append to ``times`` ("save", "wait", "restore") the seconds of each
    ``AsyncCheckpointer.save`` (how long it held the loop: the wait for the
    previous write, then the host copy), each ``wait`` (``save``'s own
    included) and each restore ``train`` makes."""
    from repro_torch.checkpoint import checkpoint as impl
    from repro_torch.train import loop

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                times.setdefault(name, []).append(time.perf_counter() - t0)
        return call
    saver = impl.AsyncCheckpointer
    with swapped(saver, "save", timed("save", saver.save)), \
            swapped(saver, "wait", timed("wait", saver.wait)), \
            swapped(loop, "restore_checkpoint",
                    timed("restore", loop.restore_checkpoint)):
        yield


def loop_train(cfg, dev, data, steps, fault=None, **kw):
    """``train(cfg, steps=steps)`` on ``dev`` with ``data``'s keywords
    (global_batch, seq_len, seed, lr) and ``kw``, ``fault`` planted.
    Returns its result with its printed lines and wall seconds."""
    from repro_torch.train import train
    lines = []
    with loop_fault(fault, cfg):
        t0 = time.perf_counter()
        res = train(cfg, steps=steps, log_fn=lines.append, device=dev,
                    **data, **kw)
        device_sync(dev)
    res.update(lines=lines, wall_s=time.perf_counter() - t0)
    return res


def loop_by_hand(cfg, dev, data, steps):
    """TL1's baseline, without the loop: ``make_train_state`` from a CPU
    generator seeded ``data["seed"]`` and ``make_train_step``'s function
    called ``steps`` times on the pipeline's global batches in order.
    Returns (the losses, the final state)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import make_train_state, make_train_step
    ds = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=data["seq_len"],
        global_batch=data["global_batch"], seed=data["seed"]))
    step, _ = make_train_step(cfg, lr=data["lr"], device=dev)
    state = make_train_state(
        cfg, torch.Generator().manual_seed(data["seed"]), device=dev)
    losses = []
    for s in range(steps):
        tokens = torch.from_numpy(ds.global_batch_at(s)).to(dev)
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
    return losses, state


def loop_families(archs):
    """TL5's cases: (arch, the arch reduced in float32, microbatches)."""
    from repro_torch.configs import get_config, reduced
    return [(arch, dataclasses.replace(reduced(get_config(arch)),
                                       dtype="float32"),
             2 if arch == LOOP_MICROBATCH_ARCH else 1) for arch in archs]


def loop_resumed(cfg, dev, root, fault=None, **kw):
    """TL5's run of ``cfg`` on ``dev``: ``train`` for one step under a new
    directory in ``root``, then resumed there to ``LOOP_FAMILY_STEPS``.
    Returns the losses of both runs in order."""
    d = tempfile.mkdtemp(dir=root)
    try:
        first = loop_train(cfg, dev, LOOP_FAMILY_DATA, 1, fault, ckpt_dir=d,
                           **kw)
        rest = loop_train(cfg, dev, LOOP_FAMILY_DATA, LOOP_FAMILY_STEPS,
                          fault, ckpt_dir=d, **kw)
    finally:
        shutil.rmtree(d)
    return first["losses"] + rest["losses"]


def loop_gates(dev, cfg, data, root, fault=None):
    """The training loop's own gates on ``dev`` ({gate: None if it passes,
    else why}, readings), with ``fault`` planted in the loop:
      TL1  ``train`` for ``LOOP_STEPS`` steps straight on ``data`` against
           ``loop_by_hand``: the losses equal, every leaf of the final
           state (parameters, both moments, the count, ``step``) bit-equal;
      TL2  ``train`` for ``LOOP_RESUME_AT`` steps under a new checkpoint
           directory in ``root`` (one save, at its end), then resumed there
           to ``LOOP_STEPS``: it logs the resume, its final state is
           bit-equal to TL1's straight run, the latest step on disk is
           ``LOOP_STEPS``, and that checkpoint restored is bit-equal to
           the final state;
      TL3  the straight run's last loss below its first."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    r, times = {}, {}
    by_hand, want = loop_by_hand(cfg, dev, data, LOOP_STEPS)
    with loop_timers(times):
        straight = loop_train(cfg, dev, data, LOOP_STEPS, fault)
    tl1 = [] if straight["losses"] == by_hand else [
        f"losses {straight['losses']}, by hand {by_hand}"]
    bad = unequal_leaves(straight["state"], want)
    if bad:
        tl1.append(f"{len(bad)} leaves differ from the hand-driven state, "
                   f"first {bad[:3]}")
    del want
    r.update(losses=straight["losses"], lines=straight["lines"],
             median_step_s=straight["median_step_s"],
             straight_s=straight["wall_s"])
    tl3 = [] if straight["final_loss"] < straight["first_loss"] else [
        f"losses {straight['losses']} do not fall"]

    d = tempfile.mkdtemp(dir=root)
    try:
        with loop_timers(times):
            first = loop_train(cfg, dev, data, LOOP_RESUME_AT, fault,
                               ckpt_dir=d, ckpt_every=100)
            del first["state"]
            resumed = loop_train(cfg, dev, data, LOOP_STEPS, fault,
                                 ckpt_dir=d)
        r.update(first_s=first["wall_s"], resumed_s=resumed["wall_s"],
                 resumed_losses=first["losses"] + resumed["losses"],
                 times=times)
        tl2 = [] if (f"[train] resumed from step {LOOP_RESUME_AT}"
                     in resumed["lines"]) else [
            f"no resume logged: {resumed['lines']}"]
        bad = unequal_leaves(resumed["state"], straight["state"])
        if bad:
            tl2.append(f"{len(bad)} leaves differ from the straight run, "
                       f"first {bad[:3]}")
        del straight
        last = latest_step(d)
        if last != LOOP_STEPS:
            tl2.append(f"latest step {last}")
        else:
            back = restore_checkpoint(d, last, resumed["state"], device=dev)
            bad = unequal_leaves(back, resumed["state"])
            if bad:
                tl2.append(f"step {last} restored: {len(bad)} leaves differ "
                           f"from the final state, first {bad[:3]}")
            del back
        del resumed
    finally:
        shutil.rmtree(d)
    gates = {g: ("; ".join(why) if why else None)
             for g, why in (("TL1", tl1), ("TL2", tl2), ("TL3", tl3))}
    return gates, r


def loop_family_gate(dev, families, root, host, host_losses, fault=None):
    """TL5: each case of ``families`` through ``loop_resumed`` on ``dev``,
    with ``fault`` planted in the loop there, against the host's run
    (``host_losses``, {arch: losses}, filled on first use; the host never
    runs a fault): every loss within ``LOOP_TL5_LIMIT`` relative.  Returns
    (None if it passes, else why; {arch: its largest gap})."""
    gaps = {}
    for arch, fcfg, micro in families:
        if arch not in host_losses:
            host_losses[arch] = loop_resumed(fcfg, host, root,
                                             microbatches=micro)
        got = loop_resumed(fcfg, dev, root, fault, microbatches=micro)
        want = host_losses[arch]
        gaps[arch] = (max(rel_err(g, w) for g, w in zip(got, want))
                      if len(got) == len(want) == LOOP_FAMILY_STEPS
                      else math.inf)
    gap, arch = worst(gaps)
    why = None if gap <= LOOP_TL5_LIMIT else (
        f"{gap:.3e} > {LOOP_TL5_LIMIT} at {arch}")
    return why, gaps


@contextlib.contextmanager
def launcher_child(argv):
    """``python -m repro_torch.launch.train`` with ``argv`` in a child
    process started now, beside what the block runs; yields a function
    that waits for it and returns (its exit code, its output lines, the
    end of its errors, seconds since its start).  A child still running
    when the block ends is killed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)

    def finish():
        out, err = proc.communicate(timeout=600)
        return (proc.returncode, out.strip().splitlines(), err[-2000:],
                time.perf_counter() - t0)
    try:
        yield finish
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def loop_launch_gate(argv, child, losses):
    """TL4 on the launcher's child (``launcher_child``'s result) run with
    ``argv``: it exits 0, and its step lines and its ``done`` line carry
    ``losses`` (a straight run's on the same config and data) to four
    decimals; the ``ms`` fields are not compared.  None if it passes,
    else why."""
    code, lines, err, _ = child
    if code != 0:
        return f"exited {code}: {err}"
    steps = int(argv[argv.index("--steps") + 1])
    want = {s: f"{losses[s]:.4f}" for s in range(steps)
            if s % 10 == 0 or s == steps - 1}
    got, done = {}, None
    for line in lines:
        if m := LOOP_LINE.match(line):
            got[int(m[1])] = m[2]
        elif m := LOOP_DONE.match(line):
            done = (m[1], m[2])
    why = [] if got == want else [f"step lines {got}, the straight run's "
                                  f"{want}"]
    if done != (want[0], want[steps - 1]):
        why.append(f"done line {done}, the straight run's "
                   f"{(want[0], want[steps - 1])}")
    return "; ".join(why) or None


def loop_checks(dev, cfg, archs, fault_arch, root, data=LOOP_DATA,
                host=torch.device("cpu"), launch_argv=None):
    """The training loop on ``dev``: ``loop_gates`` (TL1-TL3) on ``cfg``
    and ``data``, then TL5 (``loop_family_gate``) on every arch of
    ``archs``; every gate must pass.  Then ``loop_gates`` and TL5 on
    ``fault_arch`` reduced and ``LOOP_FAULT_DATA``: a clean run must pass
    every gate, and each fault of ``LOOP_FAULTS`` must break the gates
    listed for it and no other.  With ``launch_argv``, TL4
    (``loop_launch_gate``) holds the launcher's child, started after TL2
    and run beside TL5 and the faults, against the straight run.  Returns
    the clean run's readings."""
    from repro_torch.configs import get_config, reduced
    fault_cfg = reduced(get_config(fault_arch))
    host_losses = {}
    gates, r = loop_gates(dev, cfg, data, root)
    times = r["times"]
    tl1 = gates["TL1"] or "equal to the hand-driven step's, every leaf " \
        "bit-equal"
    tl2 = gates["TL2"] or "final state and its checkpoint bit-equal to " \
        "the straight run's"
    print(f"loop TL1 {cfg.name} {cfg.dtype} {LOOP_STEPS} steps of "
          f"{data}: losses {r['losses']} ({tl1}); the run "
          f"{r['straight_s']:.3f} s, median step {r['median_step_s']:.4f} s; "
          f"lines {r['lines']}", flush=True)
    print(f"loop TL2 {cfg.name}: {LOOP_RESUME_AT} steps, then resumed to "
          f"{LOOP_STEPS}: losses {r['resumed_losses']} ({tl2}); runs "
          f"{r['first_s']:.3f} + "
          f"{r['resumed_s']:.3f} s; each save held the loop "
          f"{[round(t, 4) for t in times.get('save', [])]} s, waits "
          f"{[round(t, 4) for t in times.get('wait', [])]} s, restore "
          f"{[round(t, 4) for t in times.get('restore', [])]} s", flush=True)
    print(f"loop TL3 {cfg.name}: {r['losses'][0]!r} -> {r['losses'][-1]!r} "
          f"({gates['TL3'] or 'falls'})", flush=True)
    with (launcher_child(launch_argv) if launch_argv is not None
          else contextlib.nullcontext()) as finish:
        gates["TL5"], gaps = loop_family_gate(
            dev, loop_families(archs), root, host, host_losses)
        gap, arch = worst(gaps)
        print(f"loop TL5 {len(archs)} archs reduced, float32, "
              f"{LOOP_FAMILY_STEPS} steps of {LOOP_FAMILY_DATA}, resumed "
              f"after one, card vs host ({host_cpu()}): worst {gap:.3e} at "
              f"{arch} (limit {LOOP_TL5_LIMIT}); "
              + ", ".join(f"{a} {g:.3e}" for a, g in gaps.items()),
              flush=True)
        failed = {g: why for g, why in gates.items() if why}
        check(not failed, f"loop {cfg.name}: gates failed: {failed}")
        for fault in (None,) + tuple(LOOP_FAULTS):
            t0 = time.perf_counter()
            got, _ = loop_gates(dev, fault_cfg, LOOP_FAULT_DATA, root, fault)
            got["TL5"], _ = loop_family_gate(
                dev, loop_families([fault_arch]), root, host, host_losses,
                fault)
            broken = sorted(g for g, why in got.items() if why)
            want = sorted(LOOP_FAULTS.get(fault, ()))
            print(f"loop {fault_cfg.name} planted fault {fault}: broke "
                  f"{broken} (must break {want}); {got}; "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            check(broken == want, f"loop: planted fault {fault} broke "
                                  f"{broken}, not {want}")
        if launch_argv is not None:
            child = finish()
            why = loop_launch_gate(launch_argv, child, r["losses"])
            r["launch_s"] = child[3]
            verdict = why or "the losses TL1's, to four decimals"
            print(f"loop TL4 python -m repro_torch.launch.train "
                  f"{' '.join(launch_argv)}: {child[1]} ({verdict}); the "
                  f"process took {child[3]:.3f} s, beside TL5 and the "
                  "faults' runs", flush=True)
            check(why is None, f"loop TL4: {why}")
    return r


def train_loop_phase(dev):
    """(o) the training loop: ``loop_checks`` on full-width ``TRAIN_ARCH``
    as configured (494,147,456 parameters, AdamW, bf16 compute) on
    ``LOOP_DATA``, TL5 on every arch, TL4 through ``python -m
    repro_torch.launch.train`` at full width, its faults on the reduced
    config, under a temporary directory removed at the end; TL6 every
    kernel's launch count held at 0 over the phase (training runs the
    plain paths).  Returns the launches by path (0 each)."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    for kernel in counted:
        kernel.launches = 0
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    root = tempfile.mkdtemp(prefix="train_loop_phase_")
    try:
        out = loop_checks(dev, cfg, sorted(ARCHS), TRAIN_ARCH, root,
                          launch_argv=[
                              "--arch", TRAIN_ARCH, "--steps",
                              str(LOOP_LAUNCH_STEPS), "--global-batch",
                              str(LOOP_DATA["global_batch"]), "--seq-len",
                              str(LOOP_DATA["seq_len"])])
    finally:
        shutil.rmtree(root)
    torch.cuda.synchronize(dev)
    launches = {k.__name__: k.launches for k in counted}
    print(f"loop {cfg.name}: median step {out['median_step_s']:.4f} s; "
          f"each save held the loop {out['times'].get('save')} s; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB; phase wall {time.perf_counter() - t0:.3f} s; kernel "
          f"launches {launches}; card {card_line()}", flush=True)
    check(not any(launches.values()),
          f"loop TL6: a kernel was launched on the training loop's path "
          f"{launches}")
    return {(k, f"{TRAIN_ARCH} train loop"): 0
            for k in ("flash_attention_fwd", "ssd_scan")}


def tree_desc(tree):
    """{key: (shape, dtype)} of a tree's leaves; a Python int leaf (the
    real cache's ``len``) reads as a 0-d int32, the abstract cache's."""
    return {key: ((), torch.int32) if isinstance(leaf, int)
            else (tuple(leaf.shape), leaf.dtype)
            for key, leaf in keyed(tree).items()}


def tree_bytes(tree) -> int:
    """The bytes a tree's tensor leaves would hold (meta ones included)."""
    return sum(t.numel() * t.element_size() for t in keyed(tree).values()
               if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def device_rise(dev):
    """{"bytes": the device's peak allocation inside the block above what
    was allocated when it began}, filled when the block ends."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    yield out
    torch.cuda.synchronize(dev)
    out["bytes"] = torch.cuda.max_memory_allocated(dev) - base


@contextlib.contextmanager
def api_fault(fault, dev):
    """A fault in ``models.api`` (``API_FAULTS``): the parameters drawn on
    ``dev`` by ``Model.init`` and then moved to meta; the final norm's
    scale cast to bfloat16; ``make_batch`` for ``dev`` drawn on a
    generator of ``dev`` seeded as the default CPU one is."""
    from repro_torch.models import api, build_model
    if fault == "params_built_on_card":
        def on_card(cfg):
            return _to(build_model(cfg, device=dev).init(
                torch.Generator(dev).manual_seed(0)), "meta")
        with swapped(api, "abstract_params", on_card):
            yield
    elif fault == "leaf_cast_bf16":
        real = api.abstract_params

        def cast(cfg):
            params = real(cfg)
            norm = params["final_norm"]
            norm["scale"] = norm["scale"].to(torch.bfloat16)
            return params
        with swapped(api, "abstract_params", cast):
            yield
    elif fault == "batch_on_card_generator":
        real = api.make_batch

        def on_card(cfg, shape, generator=None, scale=0.02, *, device):
            if generator is None and torch.device(device).type == "cuda":
                generator = torch.Generator(device).manual_seed(0)
            return real(cfg, shape, generator, scale, device=device)
        with swapped(api, "make_batch", on_card):
            yield
    else:
        yield


def api_abstract_gate(dev, cells):
    """A1: every abstract tree of every cell (``abstract_params`` and
    ``abstract_state`` once an arch, ``abstract_cache`` and
    ``input_specs`` a cell) allocates nothing on ``dev`` and has only
    meta leaves.  Returns (why or None, each cell's logical bytes, the
    device's rise in bytes, the wall in s)."""
    from repro_torch.models import api
    rows, not_meta, states = [], [], {}
    t0 = time.perf_counter()
    with device_rise(dev) as rise:
        for cfg, shape in cells:
            if cfg.name not in states:
                states[cfg.name] = api.abstract_state(cfg)
            state = states[cfg.name]
            trees = {"params": state.params, "state": state,
                     "cache": api.abstract_cache(cfg, shape),
                     "inputs": api.input_specs(cfg, shape)}
            for name, tree in trees.items():
                not_meta += [f"{cfg.name} {shape.name} {name}/{key}"
                             for key, leaf in keyed(tree).items()
                             if not (isinstance(leaf, torch.Tensor)
                                     and leaf.is_meta)]
            rows.append((cfg.name, shape.name,
                         {k: tree_bytes(t) for k, t in trees.items()}))
    wall = time.perf_counter() - t0
    why = []
    if rise["bytes"] > 0:
        why.append(f"the device's peak rose by {rise['bytes']} bytes")
    if not_meta:
        why.append(f"{len(not_meta)} leaves not meta: {not_meta[:4]}")
    return "; ".join(why) or None, rows, rise["bytes"], wall


def api_real_trees(dev, cfg, shape):
    """The real trees A2 holds the abstract ones to, built on ``dev``:
    ``make_train_state`` (drawn on a generator of ``dev``) and
    ``init_cache`` at ``shape``.  Returns them ("trees") with their
    descriptions and bytes."""
    from repro_torch.models import build_model
    from repro_torch.train import make_train_state
    state = make_train_state(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    cache = build_model(cfg, device=dev).init_cache(
        shape.global_batch, shape.seq_len, enc_len=cfg.encoder_seq or 0)
    check(isinstance(cache["len"], int), "init_cache's len is not an int")
    return {"trees": (state, cache), "state": tree_desc(state),
            "cache": tree_desc(cache), "state_bytes": tree_bytes(state),
            "cache_bytes": tree_bytes(cache)}


def api_real_gate(cfg, shape, real):
    """A2: ``abstract_state`` and ``abstract_cache`` have the real trees'
    keys, shapes and dtypes, leaf for leaf.  Returns why or None."""
    from repro_torch.models import api
    got = {"state": tree_desc(api.abstract_state(cfg)),
           "cache": tree_desc(api.abstract_cache(cfg, shape))}
    bad = [f"{name}/{key}" for name in got
           for key in sorted(set(got[name]) | set(real[name]))
           if got[name].get(key) != real[name].get(key)]
    return f"{len(bad)} leaves differ: {bad[:4]}" if bad else None


def api_batch_gate(dev, cells):
    """A3 on each cell: ``make_batch`` on ``dev`` (the default generator)
    has ``input_specs``' keys, shapes and dtypes (gate 1), tokens in
    ``[0, vocab_size)`` and float inputs with a std within API_STD_TOL of
    API_SCALE (gate 2), and equals the host CPU's ``make_batch`` bit for
    bit (gate 3).  Returns (why or None, each cell's readings)."""
    from repro_torch.models import api
    why, rows = [], []
    for cfg, shape in cells:
        t0 = time.perf_counter()
        batch = api.make_batch(cfg, shape, scale=API_SCALE, device=dev)
        host = api.make_batch(cfg, shape, scale=API_SCALE, device="cpu")
        specs = api.input_specs(cfg, shape)
        where = f"{cfg.name} {shape.name}"
        if {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} != \
                {k: (tuple(v.shape), v.dtype) for k, v in specs.items()}:
            why.append(f"{where}: shapes or dtypes are not input_specs'")
        reads = {}
        for key, t in batch.items():
            if t.dtype.is_floating_point:
                reads[key] = float(t.std()) / API_SCALE - 1.0
                if abs(reads[key]) > API_STD_TOL:
                    why.append(f"{where} {key}: std off scale by "
                               f"{reads[key]:.3e}")
            else:
                lo, hi = int(t.min()), int(t.max())
                reads[key] = (lo, hi)
                if lo < 0 or hi >= cfg.vocab_size:
                    why.append(f"{where} {key}: tokens in [{lo}, {hi}]")
            if t.device.type != dev.type or \
                    not torch.equal(bits(t), bits(host[key].to(t.device))):
                why.append(f"{where} {key}: not the host's batch bit for bit")
        rows.append((where, tree_bytes(batch), reads,
                     time.perf_counter() - t0))
        del batch, host
    return "; ".join(why) or None, rows


def api_checks(dev, cells, real, batch_cells, faults=tuple(API_FAULTS)):
    """The dry-run's abstract trees on ``dev``: A1 over ``cells`` ((cfg,
    shape) pairs), A2 on ``real`` (cfg, shape), A3 on ``batch_cells``;
    every gate must pass.  Then A1-A3 on the cells of ``real``'s config
    alone, clean and under each fault of ``faults``: the clean run must
    pass every gate, and each fault break the gate ``API_FAULTS`` lists
    for it and no other.  The real trees stay allocated to the end, so
    every later peak reading includes them.  Returns the clean run's
    readings (on a card, "peak_gib": the peak allocation over A2 and A3)."""
    cfg, shape = real
    real_trees = api_real_trees(dev, cfg, shape)
    gates, out = {}, {}
    gates["A1"], rows, out["rise"], out["a1_s"] = api_abstract_gate(dev,
                                                                    cells)
    for arch, sname, nbytes in rows:
        print(f"api A1 {arch} {sname}: logical bytes " + ", ".join(
            f"{k} {v:,}" for k, v in nbytes.items()), flush=True)
    print(f"api A1 {len(cells)} cells: device rise {out['rise']} bytes, "
          f"every leaf meta: {gates['A1'] or 'yes'}; {out['a1_s']:.4f} s",
          flush=True)
    gates["A2"] = api_real_gate(cfg, shape, real_trees)
    print(f"api A2 {cfg.name}: real make_train_state "
          f"({len(real_trees['state'])} leaves, "
          f"{real_trees['state_bytes']:,} bytes) and init_cache at "
          f"{shape.name} ({len(real_trees['cache'])} leaves, "
          f"{real_trees['cache_bytes']:,} bytes) against abstract_state and "
          f"abstract_cache: {gates['A2'] or 'every leaf equal'}", flush=True)
    t0 = time.perf_counter()
    gates["A3"], rows = api_batch_gate(dev, batch_cells)
    out["a3_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    for where, nbytes, reads, secs in rows:
        print(f"api A3 {where}: {nbytes:,} bytes, {reads} (std / scale - 1; "
              f"token range), {secs:.3f} s", flush=True)
    print(f"api A3 {len(batch_cells)} batches: "
          f"{gates['A3'] or 'specs, ranges and host bits equal'}; "
          f"{out['a3_s']:.3f} s", flush=True)
    failed = {g: why for g, why in gates.items() if why}
    check(not failed, f"api: gates failed: {failed}")
    own = [(c, s) for c, s in cells if c == cfg]
    for fault in (None,) + tuple(faults):
        t0 = time.perf_counter()
        with api_fault(fault, dev):
            got = {"A1": api_abstract_gate(dev, own)[0],
                   "A2": api_real_gate(cfg, shape, real_trees),
                   "A3": api_batch_gate(dev, own)[0]}
        broken = sorted(g for g, why in got.items() if why)
        want = sorted(API_FAULTS.get(fault, ()))
        print(f"api {cfg.name} planted fault {fault}: broke {broken} "
              f"(must break {want}); {got}; {time.perf_counter() - t0:.3f} "
              "s", flush=True)
        check(broken == want, f"api: planted fault {fault} broke {broken}, "
                              f"not {want}")
    return out


def api_phase(dev):
    """(p) the dry-run's mesh-free inputs: ``api_checks`` on every arch at
    full width, every kernel's launch count held at 0 over the phase (the
    abstract trees run none).  A1 every arch at every applicable shape (32
    cells), A2 ``API_ARCH`` at ``API_CACHE_SHAPE``, A3 every arch at
    ``API_CACHE_SHAPE`` and ``API_ARCH`` at each of its shapes.  Returns
    the launches by path (0 each)."""
    from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    for kernel in counted:
        kernel.launches = 0
    t0 = time.perf_counter()
    cells = [(get_config(a), shape) for a in sorted(ARCHS)
             for shape in SHAPES.values()
             if shape_applicable(get_config(a), shape)]
    out = api_checks(
        dev, cells, (get_config(API_ARCH), SHAPES[API_CACHE_SHAPE]),
        [(c, s) for c, s in cells if s.name == API_CACHE_SHAPE]
        + [(c, s) for c, s in cells
           if c.name == API_ARCH and s.name != API_CACHE_SHAPE])
    torch.cuda.synchronize(dev)
    launches = {k.__name__: k.launches for k in counted}
    print(f"api: A1 {out['a1_s']:.4f} s, A3 {out['a3_s']:.3f} s; phase wall "
          f"{time.perf_counter() - t0:.3f} s; peak device memory over A2 "
          f"and A3 {out['peak_gib']:.2f} GiB; kernel launches {launches}; "
          f"card {card_line()}", flush=True)
    check(not any(launches.values()),
          f"api: a kernel was launched on the abstract trees' path "
          f"{launches}")
    return {(k, "api"): 0 for k in ("flash_attention_fwd", "ssd_scan")}


def sharding_key(cfg, shape, mesh_name) -> str:
    return f"{cfg.name}__{shape.name}__{mesh_name}"


def bf16_floats(tree):
    """The dry-run's ``bf16_params``: every floating leaf in bfloat16."""
    from repro_torch._tree import map_with_keys
    return map_with_keys(lambda _, t: t.to(torch.bfloat16)
                         if t.dtype.is_floating_point else t, tree)


def cell_layout(cfg, shape, multi_pod, trees):
    """What the dry-run lays out for a cell, as ``run_cell`` does: the
    production mesh and [(tree, its legalized specs)], the tree taken from
    ``trees``: the train state for a train cell, else the parameters (in
    bfloat16) and the cache."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import make_rules, tree_shardings
    from repro_torch.train.step import state_specs
    mesh = make_production_mesh(multi_pod=multi_pod)
    train = shape.kind == "train"
    rules = make_rules(cfg, multi_pod=multi_pod,
                       mode="train" if train else "serve",
                       global_batch=shape.global_batch)
    model = build_model(cfg, device="meta")
    pairs = ([(trees["state"], state_specs(cfg, model))] if train else
             [(trees["params"], model.param_specs()),
              (trees["cache"], model.cache_specs())])
    return mesh, [(tree, tree_shardings(spec, mesh, rules, tree))
                  for tree, spec in pairs]


def abstract_cell_trees(cfg, shape):
    """S1's trees for a cell: ``abstract_state``, or ``abstract_params``
    in bfloat16 and ``abstract_cache``."""
    from repro_torch.models import api
    if shape.kind == "train":
        return {"state": api.abstract_state(cfg)}
    return {"params": bf16_floats(api.abstract_params(cfg)),
            "cache": api.abstract_cache(cfg, shape)}


def sharding_bytes_gate(dev, cells, want):
    """S1: every cell of ``cells`` ((cfg, shape) pairs) on both production
    meshes, from the abstract trees: ``sharded_bytes`` of its layout must
    equal ``want``'s figure, and the device's peak allocation must not
    rise.  Returns (why or None, [(key, bytes, wanted)], the rise in
    bytes, the wall in s)."""
    from repro_torch.sharding import sharded_bytes
    rows, bad = [], []
    t0 = time.perf_counter()
    with device_rise(dev) as rise:
        for cfg, shape in cells:
            trees = abstract_cell_trees(cfg, shape)
            for mesh_name, multi_pod in SHARDING_MESHES.items():
                key = sharding_key(cfg, shape, mesh_name)
                try:
                    mesh, laid = cell_layout(cfg, shape, multi_pod, trees)
                    got = sum(sharded_bytes(tree, specs, mesh)
                              for tree, specs in laid)
                except ValueError as exc:
                    got = f"ValueError: {exc}"
                rows.append((key, got, want.get(key)))
                if got != want.get(key):
                    bad.append(key)
    wall = time.perf_counter() - t0
    why = []
    if rise["bytes"] > 0:
        why.append(f"the device's peak rose by {rise['bytes']} bytes")
    if bad:
        why.append(f"{len(bad)} of {len(rows)} cells differ from the "
                   f"reference: {bad[:4]}")
    return "; ".join(why) or None, rows, rise["bytes"], wall


def spec_axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def device_blocks(spec, shape, mesh):
    """Each device's block of an array of ``shape`` laid out by ``spec``
    on ``mesh``, as index tuples in device order (row-major over the mesh
    axes): a dim split over axes (a1, a2, ...) falls into the product of
    their sizes parts, a1 major, as jax lays out a ``NamedSharding``.
    Computed here from the mesh coordinates, not by the port."""
    out = []
    for coords in itertools.product(*(range(n) for n in mesh.axis_sizes)):
        at = dict(zip(mesh.axis_names, coords))
        idx = []
        for i, dim in enumerate(shape):
            part, parts = 0, 1
            for a in spec_axes(spec[i] if i < len(spec) else None):
                part = part * mesh.shape[a] + at[a]
                parts *= mesh.shape[a]
            block = dim // parts
            idx.append(slice(part * block, (part + 1) * block))
        out.append(tuple(idx))
    return out


def cut_leaf(leaf, spec, mesh):
    """Cut ``leaf`` into every device's block (views, no copy) and raise a
    coverage counter of the leaf's shape, on the leaf's device, by one
    over each block.  Returns (each device's block bytes, how many blocks
    lack ``shard_shape``'s shape, whether the counter equals everywhere
    the product of the mesh axes the spec leaves unused)."""
    from repro_torch.sharding import shard_shape
    shape = tuple(leaf.shape)
    try:
        want = shard_shape(spec, shape, mesh)
    except ValueError:
        want = None
    counter = torch.zeros(shape, dtype=torch.int16, device=leaf.device)
    nbytes, off = [], 0
    for idx in device_blocks(spec, shape, mesh):
        block = leaf[idx]
        off += tuple(block.shape) != want
        nbytes.append(block.numel() * block.element_size())
        counter[idx] += 1
    used = {a for entry in spec for a in spec_axes(entry)}
    unused = math.prod(n for a, n in mesh.shape.items() if a not in used)
    low, high = torch.aminmax(counter)  # no leaf-sized temporary
    covered = int(low) == int(high) == unused
    del counter
    return nbytes, off, covered


def sharding_cut_gate(cfg, shapes, real, want):
    """S2: the real trees of ``real`` ({"state", "params" (bfloat16),
    "cache"}) laid out for ``cfg`` at each shape of ``shapes`` on both
    meshes and cut into every device's block (``cut_leaf``): every block
    has ``shard_shape``'s shape, every device's blocks sum to ``want``'s
    figure for the cell, and every leaf's coverage counter is even.
    Returns (why or None, [(key, device 0's bytes, leaves, blocks,
    s)])."""
    from repro_torch.sharding import map_specs
    why, rows = [], []
    for shape in shapes:
        for mesh_name, multi_pod in SHARDING_MESHES.items():
            t0 = time.perf_counter()
            key = sharding_key(cfg, shape, mesh_name)
            mesh, laid = cell_layout(cfg, shape, multi_pod, real)
            per_device = [0] * mesh.chips
            off, uneven, n_leaves = 0, [], 0
            for tree, specs in laid:
                leaves, spec_list = keyed(tree), []
                map_specs(spec_list.append, specs)
                check(len(leaves) == len(spec_list),
                      f"sharding S2 {key}: {len(leaves)} leaves for "
                      f"{len(spec_list)} specs")
                for (name, leaf), spec in zip(leaves.items(), spec_list):
                    nbytes, bad, covered = cut_leaf(leaf, spec, mesh)
                    per_device = [a + b for a, b in zip(per_device, nbytes)]
                    off += bad
                    if not covered:
                        uneven.append(name)
                    n_leaves += 1
            if off:
                why.append(f"{key}: {off} blocks lack shard_shape's shape")
            wrong = sum(b != want.get(key) for b in per_device)
            if wrong:
                why.append(f"{key}: {wrong} devices hold other than "
                           f"{want.get(key)} bytes (device 0: "
                           f"{per_device[0]})")
            if uneven:
                why.append(f"{key}: uneven coverage of {uneven[:4]}")
            rows.append((key, per_device[0], n_leaves,
                         n_leaves * mesh.chips, time.perf_counter() - t0))
    return "; ".join(why) or None, rows


@contextlib.contextmanager
def sharding_fault(fault):
    """A fault in the sharding rules or the spec trees
    (``SHARDING_FAULTS``)."""
    from repro_torch.sharding import map_specs, specs
    from repro_torch.train import step
    if fault == "scheme_sp_read_as_tp":
        real = specs.scheme_for

        def scheme_for(cfg, tp_size):
            got = real(cfg, tp_size)
            return "tp" if got == "sp" else got
        with swapped(specs, "scheme_for", scheme_for):
            yield
    elif fault == "resolve_keeps_duplicate_axes":
        def resolve(logical, rules):
            if logical is None:
                return ()
            out = []
            for name in logical:
                axes = tuple(rules.get(name, ())) if name is not None else ()
                out.append(None if not axes else
                           axes[0] if len(axes) == 1 else axes)
            return tuple(out)
        with swapped(specs, "resolve", resolve):
            yield
    elif fault == "adafactor_vc_from_row_dims":
        real = step.opt_state_specs

        def opt_state_specs(name, param_specs):
            if name != "adafactor":
                return real(name, param_specs)

            def one(spec):
                if len(spec) >= 2:
                    return {"vr": spec[:-1], "vc": spec[:-1]}
                return {"v": spec}
            return {"f": map_specs(one, param_specs), "count": None}
        with swapped(step, "opt_state_specs", opt_state_specs):
            yield
    else:
        yield


def sharding_checks(dev, cells, want, real, faults=tuple(SHARDING_FAULTS)):
    """The sharding rules and spec trees on ``dev``: S1 over ``cells``
    against ``want`` ({"arch__shape__mesh": bytes}); S2 on ``real`` (cfg,
    train shape, serve shape), its real trees built on ``dev`` as
    ``api_real_trees`` builds them, the cache's ``len`` made the 0-d int32
    ``abstract_cache`` has; every gate must pass.  Then S1 and S2 under
    each fault of ``faults``: each must break the gates
    ``SHARDING_FAULTS`` lists for it and no other.  Returns the clean
    run's readings (on a card, "peak_gib": the peak allocation over
    S2)."""
    cfg, train_shape, serve_shape = real
    state, cache = api_real_trees(dev, cfg, serve_shape)["trees"]
    trees = {"state": state, "params": bf16_floats(state.params),
             "cache": {**cache, "len": torch.tensor(
                 cache["len"], dtype=torch.int32, device=dev)}}
    shapes = (train_shape, serve_shape)
    gates, out = {}, {}
    gates["S1"], rows, out["rise"], out["s1_s"] = sharding_bytes_gate(
        dev, cells, want)
    for key, got, wanted in rows:
        print(f"sharding S1 {key}: {got:,} bytes a device (reference "
              f"{wanted:,})" if isinstance(got, int) else
              f"sharding S1 {key}: {got} (reference {wanted})", flush=True)
    print(f"sharding S1 {len(rows)} cells: device rise {out['rise']} bytes, "
          f"{gates['S1'] or 'every cell equal to the reference'}; "
          f"{out['s1_s']:.4f} s", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gates["S2"], rows = sharding_cut_gate(cfg, shapes, trees, want)
    out["s2_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    for key, nbytes, n_leaves, blocks, secs in rows:
        print(f"sharding S2 {key}: {n_leaves} leaves cut into {blocks:,} "
              f"blocks, device 0 holds {nbytes:,} bytes; {secs:.3f} s",
              flush=True)
    print(f"sharding S2: {gates['S2'] or 'every block shard_shape, every '
          'device the reference bytes, coverage even'}; {out['s2_s']:.3f} s",
          flush=True)
    failed = {g: why for g, why in gates.items() if why}
    check(not failed, f"sharding: gates failed: {failed}")
    for fault in faults:
        t0 = time.perf_counter()
        with sharding_fault(fault):
            got = {"S1": sharding_bytes_gate(dev, cells, want)[0],
                   "S2": sharding_cut_gate(cfg, shapes, trees, want)[0]}
        broken = sorted(g for g, why in got.items() if why)
        wanted = sorted(SHARDING_FAULTS[fault])
        print(f"sharding {cfg.name} planted fault {fault}: broke {broken} "
              f"(must break {wanted}); {got}; "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        check(broken == wanted, f"sharding: planted fault {fault} broke "
                                f"{broken}, not {wanted}")
    return out


def sharding_phase(dev):
    """(q) the sharding rules and the logical spec trees:
    ``sharding_checks`` with S1 over every arch at full width and every
    applicable shape (32 cells x 2 meshes) against
    REFERENCE_SHARDED_BYTES and S2 on SHARDING_ARCH's real trees, every
    kernel's launch count held at 0 over the phase.  Returns the
    launches by path (0 each)."""
    from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    for kernel in counted:
        kernel.launches = 0
    t0 = time.perf_counter()
    cells = [(get_config(a), shape) for a in sorted(ARCHS)
             for shape in SHAPES.values()
             if shape_applicable(get_config(a), shape)]
    out = sharding_checks(
        dev, cells, REFERENCE_SHARDED_BYTES,
        (get_config(SHARDING_ARCH), SHAPES[SHARDING_TRAIN_SHAPE],
         SHAPES[API_CACHE_SHAPE]))
    torch.cuda.synchronize(dev)
    launches = {k.__name__: k.launches for k in counted}
    print(f"sharding: S1 {out['s1_s']:.4f} s, S2 {out['s2_s']:.3f} s; phase "
          f"wall {time.perf_counter() - t0:.3f} s; peak device memory over "
          f"S2 {out['peak_gib']:.2f} GiB; kernel launches {launches}; card "
          f"{card_line()}", flush=True)
    check(not any(launches.values()),
          f"sharding: a kernel was launched on the sharding path {launches}")
    return {(k, "sharding"): 0 for k in ("flash_attention_fwd", "ssd_scan")}


DRYRUN_EXACT = ("arch", "shape", "tag", "overrides", "mesh", "chips", "kind",
                "scheme", "ok", "persistent_bytes_per_device")

DRYRUN_CHILD = r"""
import json, sys, time
import torch
dev = torch.device("cuda", 0)
torch.cuda.init()
torch.cuda.synchronize(dev)
base = torch.cuda.memory_allocated(dev)
torch.cuda.reset_peak_memory_stats(dev)
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.maxmin_fair import masked_min_rows
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import dryrun
t0 = time.perf_counter()
dryrun.main(sys.argv[1:])
wall = time.perf_counter() - t0
torch.cuda.synchronize(dev)
print(json.dumps({"wall": wall,
                  "rise": torch.cuda.max_memory_allocated(dev) - base,
                  "launches": sum(k.launches for k in (
                      flash_attention_fwd, masked_min_rows, ssd_scan))}))
"""


def dryrun_key(cell) -> str:
    arch, shape, multi_pod, _, tag = cell
    mesh = "2x16x16" if multi_pod else "16x16"
    return f"{arch}__{shape}__{mesh}" + (f"__{tag}" if tag else "")


def dryrun_summary(rec) -> dict:
    """What D1 compares of a dry-run record: the exact fields, the totals
    over all chips, the kernel-adjusted ones (None for decode), the
    collective wire bytes per device, and each op's count and bytes."""
    ro, ka = rec["roofline"], rec["roofline_kernel_adjusted"]
    return {
        "exact": dict({k: rec[k] for k in DRYRUN_EXACT},
                      roofline_chips=ro["chips"],
                      model_flops=ro["model_flops"]),
        "flops": ro["hlo_flops_total"], "bytes": ro["hlo_bytes_total"],
        "kadj_flops": ka and ka["hlo_flops_total"],
        "kadj_bytes": ka and ka["hlo_bytes_total"],
        "removed_tile_bytes": ka and ka["removed_tile_bytes"],
        "coll": ro["coll_bytes_per_device"],
        "collectives": {op: [v["count"], v["wire_bytes"]]
                        for op, v in sorted(rec["collectives"].items())}}


def dryrun_gates(got, want) -> dict:
    """{gate: (port / reference ratios, passed)} for one cell's summaries
    (``dryrun_summary``, each with its ``step_s``) within DRYRUN_LIMITS;
    "exact" compares the exact fields."""
    def within(gate, ratios):
        lo, hi = DRYRUN_LIMITS[gate]
        return ratios, all(lo <= r <= hi for r in ratios)
    flops = [got["flops"] / want["flops"]]
    if want["kadj_flops"] is not None:
        flops.append(got["kadj_flops"] / want["kadj_flops"])
    key = "kadj_bytes" if want["removed_tile_bytes"] else "bytes"
    return {"exact": ([], got["exact"] == want["exact"]),
            "flops": within("flops", flops),
            "bytes": within("bytes", [got[key] / want[key]]),
            "collectives": within("collectives", [got["coll"] / want["coll"]]),
            "step_s": within("step_s", [got["step_s"] / want["step_s"]])}


def dryrun_step_s(rec) -> float:
    """``predict_cell`` on one record (written under its untagged name)."""
    from repro_torch.core import predict_cell
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, f"{rec['arch']}__{rec['shape']}__"
                               f"{rec['mesh']}.json"), "w") as f:
            json.dump(rec, f)
        return predict_cell(rec["arch"], rec["shape"], rec["mesh"],
                            dryrun_dir=tmp).step_s


@contextlib.contextmanager
def dryrun_fault(fault):
    """A fault in the dry-run (``DRYRUN_FAULTS``)."""
    from repro_torch.roofline import count as count_mod
    from repro_torch.sharding import collectives
    from repro_torch.train import step as step_mod
    if fault == "train_forward_only":
        def forward_only(model, params, batch, *, microbatches=1):
            with torch.no_grad():
                loss, metrics = model.loss(params, batch)
            return loss, metrics, params
        with swapped(step_mod, "loss_and_grads", forward_only), \
                swapped(step_mod, "opt_update",
                        lambda name: lambda p, g, s, lr: (p, s, lr)):
            yield
    elif fault == "count_not_per_chip":
        real = count_mod.count
        with swapped(count_mod, "count",
                     lambda fn, *a, chips=1, **kw: real(fn, *a, **kw)):
            yield
    elif fault == "one_layer_collectives":
        real = collectives.step_collectives

        def one_layer(cfg, *args, **kw):
            return {op: {k: v / cfg.num_layers for k, v in agg.items()}
                    for op, agg in real(cfg, *args, **kw).items()}
        with swapped(collectives, "step_collectives", one_layer):
            yield
    else:
        yield


def dryrun_checks(records, want) -> None:
    """D1's gates on ``records`` (``{key: record}``, the port's records of
    DRYRUN_CELLS) against ``want`` (REFERENCE_DRYRUN), each cell's ratios
    printed, the ungated ones too; then each planted fault, run here in
    this process on its cell, must break its gate."""
    from repro_torch.launch.dryrun import run_cell
    for cell in DRYRUN_CELLS:
        key = dryrun_key(cell)
        got = dict(dryrun_summary(records[key]),
                   step_s=dryrun_step_s(records[key]))
        w = want[key]
        gates = dryrun_gates(got, w)
        print(f"dryrun D1 {key}: " + " ".join(
            f"{g}={'ok' if ok else 'FAILED'}"
            + (f" {[round(r, 4) for r in rs]}" if rs else "")
            for g, (rs, ok) in gates.items())
            + f"; ungated: raw_bytes={got['bytes'] / w['bytes']:.4f}"
            + (f" kadj_bytes={got['kadj_bytes'] / w['kadj_bytes']:.4f}"
               f" removed_tile_bytes port={got['removed_tile_bytes']!r}"
               f" reference={w['removed_tile_bytes']!r}"
               if w["kadj_bytes"] is not None else "")
            + f" collectives port={got['collectives']} reference="
            f"{w['collectives']}", flush=True)
        failed = [g for g, (_, ok) in gates.items() if not ok]
        check(not failed, f"dryrun D1 {key}: gates {failed} failed: "
              f"{gates}")
    with tempfile.TemporaryDirectory() as tmp:
        for fault, (cell, gate) in DRYRUN_FAULTS.items():
            key = dryrun_key(cell)
            arch, shape, multi_pod, overrides, tag = cell
            with dryrun_fault(fault), \
                    contextlib.redirect_stdout(io.StringIO()):
                rec = run_cell(arch, shape, multi_pod, tmp,
                               overrides=overrides or None, tag=tag)
            got = dict(dryrun_summary(rec), step_s=dryrun_step_s(rec))
            gates = dryrun_gates(got, want[key])
            broke = sorted(g for g, (_, ok) in gates.items() if not ok)
            print(f"dryrun planted fault {fault} on {key}: broke {broke} "
                  f"({gate}: {gates[gate][0]})", flush=True)
            check(gate in broke, f"dryrun fault {fault}: the {gate} gate "
                  f"held: {gates[gate]}")


def dryrun_d2(records) -> None:
    """D2: ``record_phase``'s consumers on the port's own records, beside
    the synthetic DRYRUN_RECORDS: ``predict_cell`` on every held cell (in
    D1), sec5's three what-ifs on DRYRUN_WHATIF_CELL and one
    ``predict_cell_des`` (DRYRUN_DES_CELL), each against the reference
    record's answer within the step_s limit."""
    from repro_torch.core import predict_cell_des, whatif
    lo, hi = DRYRUN_LIMITS["step_s"]
    with tempfile.TemporaryDirectory() as tmp:
        for key in (dryrun_key(c) for c in DRYRUN_CELLS if not c[4]):
            with open(os.path.join(tmp, key + ".json"), "w") as f:
                json.dump(records[key], f)
        for name, kw in RECORD_WHATIF.items():
            w = whatif(*DRYRUN_WHATIF_CELL, dryrun_dir=tmp, **kw)
            r = w["whatif_s"] / REFERENCE_DRYRUN_WHATIF[name]
            print(f"dryrun D2 whatif {name}: whatif_s={w['whatif_s']!r} "
                  f"speedup={w['speedup']!r} ratio={r:.4f}", flush=True)
            check(lo <= r <= hi, f"dryrun D2 whatif {name}: ratio {r}")
        t0 = time.perf_counter()
        des = predict_cell_des(*DRYRUN_DES_CELL, dryrun_dir=tmp)
        r = des["step_s"] / REFERENCE_DRYRUN_DES["step_s"]
        print(f"dryrun D2 predict_cell_des {'__'.join(DRYRUN_DES_CELL)}: "
              f"step_s={des['step_s']!r} events={des['events']} ratio="
              f"{r:.4f} host_wall_s={time.perf_counter() - t0:.3f}",
              flush=True)
        check(lo <= r <= hi, f"dryrun D2 predict_cell_des: ratio {r}")


def dryrun_phase(dev):
    """(r) the dry-run launcher: D1 ``python -m repro_torch.launch.dryrun``'s
    ``main`` for every DRYRUN_CELLS cell, one child process a cell, all at
    once, each reporting its wall time, its card's rise in allocation (0
    bytes) and the kernels' launches (0); the records against
    REFERENCE_DRYRUN and the skip record (``dryrun_checks``), with
    DRYRUN_FAULTS planted here; D2 the record consumers on the records
    (``dryrun_d2``).  Returns the launches by path (0 each)."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.dryrun import run_cell
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    for kernel in counted:
        kernel.launches = 0
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for cell in DRYRUN_CELLS:
            arch, shape, multi_pod, overrides, tag = cell
            argv = ["--arch", arch, "--shape", shape, "--out", tmp]
            argv += ["--multi-pod"] if multi_pod else []
            argv += ["--tag", tag] if tag else []
            for k, v in overrides.items():
                argv += ["--set", f"{k}={v}"]
            procs.append(subprocess.Popen(
                [sys.executable, "-c", DRYRUN_CHILD, *argv],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env))
        records = {}
        try:
            for cell, proc in zip(DRYRUN_CELLS, procs):
                stdout, stderr = proc.communicate(timeout=600)
                key = dryrun_key(cell)
                check(proc.returncode == 0, f"dryrun D1 {key}: the CLI "
                      f"exited {proc.returncode}: {stderr[-2000:]}")
                res = json.loads(stdout.strip().splitlines()[-1])
                print(f"dryrun D1 {key}: CLI child wall {res['wall']:.3f} s,"
                      f" device rise {res['rise']} bytes, kernel launches "
                      f"{res['launches']}", flush=True)
                check(res["rise"] == 0 and res["launches"] == 0,
                      f"dryrun D1 {key}: the card was used: {res}")
                with open(os.path.join(tmp, key + ".json")) as f:
                    records[key] = json.load(f)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.communicate()
        skip = run_cell(*DRYRUN_SKIP, False, tmp)
        check(skip == REFERENCE_DRYRUN_SKIP and not os.path.exists(
            os.path.join(tmp, dryrun_key((*DRYRUN_SKIP, False, {}, ""))
                         + ".json")), f"dryrun skip record: {skip}")
    for key, rec in records.items():
        print(f"dryrun D1 {key}: count_s={rec['count_s']:.3f}", flush=True)
    with device_rise(dev) as rise:
        dryrun_checks(records, REFERENCE_DRYRUN)
        dryrun_d2(records)
    launches = {k.__name__: k.launches for k in counted}
    print(f"dryrun: phase wall {time.perf_counter() - t_phase:.3f} s, "
          f"device rise over the checks {rise['bytes']} bytes, kernel "
          f"launches {launches}; card {card_line()}", flush=True)
    check(rise["bytes"] == 0 and not any(launches.values()),
          f"dryrun: the card was used: {rise} {launches}")
    return {(k, "dryrun"): 0 for k in ("flash_attention_fwd", "ssd_scan")}


def sass_counts(build):
    """What the tensor cores run: ``cuobjdump -sass`` counts of HGMMA (wgmma)
    in the bf16 flash kernels and of HMMA (mma.sync) and HGMMA in the bf16
    instances of the SSD kernel's chunk_scan; each must be above 0.  Where
    the toolkit has no cuobjdump, it says so and checks the PTX of the
    flash source for wgmma instead."""
    import re
    import shutil
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = next((t for t in (os.path.join(home, "bin", "cuobjdump"),
                             shutil.which("cuobjdump") or "")
                 if t and os.path.isfile(t)), None)
    if tool is None:
        ptx = subprocess.run(
            [build._nvcc(), "-gencode", "arch=compute_90a,code=compute_90a",
             "-std=c++17", "-ptx", "-o", "-",
             str(build.CSRC / "flash_attention.cu")],
            capture_output=True, text=True, check=True).stdout
        n = ptx.count("wgmma.mma_async")
        print(f"cuobjdump not found in the toolkit: no SASS counts; the PTX "
              f"of flash_attention.cu holds {n} wgmma.mma_async", flush=True)
        check(n > 0, "flash_attention.cu: no wgmma in its PTX")
        return
    for lib, want in (("flash_attention", "flash_fwd_bf16"),
                      ("ssd_scan", "chunk_scanI13__nv_bfloat16")):
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1) if want in m.group(1) else None
                if fn:
                    counts[fn] = {"HMMA": 0, "HGMMA": 0}
            elif fn:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        counts[fn][op] += 1
        for fn, c in counts.items():
            print(f"sass {lib} {fn}: HGMMA={c['HGMMA']} HMMA={c['HMMA']}",
                  flush=True)
        op = "HGMMA" if lib == "flash_attention" else "HMMA"
        check(counts and all(c[op] > 0 for c in counts.values()),
              f"{lib}: a bf16 kernel without {op} in its SASS: {counts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    print(card_line(), flush=True)
    # both float32 matmul and cuDNN in full float32: waterfill's link
    # counts need it (TF32 keeps 10 mantissa bits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    sources = ["maxmin_fair", "flash_attention", "ssd_scan"]
    _build.build_libraries(sources)
    for name in sources:
        _build.load_library(name)
    print(f"kernel build: {', '.join(n + '.cu' for n in sources)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in sources:
        print(_build.build_log(name).strip(), flush=True)
    sass_counts(_build)

    from repro_torch.core.apps.hpl import HPLConfig
    from repro_torch.core.fastsim import FastSimParams, simulate_hpl_fast
    from repro_torch.core.hardware.node import local_node
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import (masked_min_rows, waterfill,
                                                 waterfill_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)

    adj, caps, pairs, frontera_rec = kernel_phase(dev)

    # ---- the main path: launch counts start at 0 here
    masked_min_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rates_k = waterfill(adj, caps)
    torch.cuda.synchronize()
    wf_wall = time.perf_counter() - t0
    wf_iters = masked_min_rows.launches
    print(f"waterfill frontera 8008x18200: iterations={wf_iters} "
          f"wall_s={wf_wall:.4f}", flush=True)

    t0 = time.perf_counter()
    anchor = simulate_hpl_fast(HPLConfig(N=4096, nb=128, P=4, Q=4),
                               FastSimParams.from_node(
                                   local_node(), link_bw=100e9 / 8),
                               device=dev)["time_s"]
    err = rel_err(anchor, REFERENCE_TIME_S["bdw-local"])
    print(f"simulate_hpl_fast bdw-local anchor: time_s={anchor!r} "
          f"rel_err={err:.3e} wall_s={time.perf_counter() - t0:.3f}",
          flush=True)
    check(err <= 1e-12, f"anchor rel err {err} > 1e-12")
    singles = {"bdw-local": anchor}
    for name in ("tpu-v5e-pod", "syn-mp-2pod-v5e", "frontera"):
        singles[name] = predict_phase(dev, name)
    grid_phase(dev, singles["frontera"])
    forced_bucket_phase(dev, singles)
    torch.cuda.synchronize()
    launches = masked_min_rows.launches
    print(f"main path launches: masked_min_rows={launches}", flush=True)
    check(launches > 0, "masked_min_rows was not launched on the main path")

    # ---- waterfill: kernel against plain, and link conservation
    rates_p = waterfill_ref(adj, caps)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rates_k).all()), "waterfill: non-finite rate")
    check(torch.allclose(rates_k, rates_p, rtol=1e-4, atol=0.0),
          "waterfill: kernel and plain differ beyond rtol 1e-4")
    flows, links = adj.nonzero(as_tuple=True)
    usage = torch.zeros(adj.shape[1], dtype=torch.float64, device=dev)
    usage.index_add_(0, links, torch.clamp(rates_k.double(), max=1e30)[flows])
    check(bool((usage <= caps.double() * (1 + 1e-3)).all()),
          "waterfill: link usage exceeds capacity")
    wf_err = float((rates_k - rates_p).abs().max())
    print(f"waterfill: kernel vs plain max_abs_err={wf_err} (rtol 1e-4 ok), "
          f"conservation ok, min_rate={float(rates_k.min())!r} "
          f"max_rate={float(rates_k.max())!r}", flush=True)
    network_phase(rates_k, pairs)

    # ---- the DES and gradient calibration: the discrete-event HPL, the
    # DES -> fastsim bridge with its fit on the card (no kernel of the
    # port's runs on this path; the counts must stay 0)
    for kernel in counted:
        kernel.launches = 0
    des_phase()
    bridge_phase(dev)
    torch.cuda.synchronize()
    print("DES/calibration path launches: " + " ".join(
        f"{k.__name__}={k.launches}" for k in counted), flush=True)
    check(all(k.launches == 0 for k in counted),
          "a kernel of the port was launched on the DES/calibration path")

    # ---- slices 5 to 7 and 8c-p: the transformer step model, fault
    # sweeps, a representative region, per-scale contention, the TOP500
    # fleet, the prediction service, the campaign layer, the dry-run-record
    # predictions and the fault-tolerance layer (no kernel of the port's
    # runs on these paths; the counts must stay 0)
    for phase in (transformer_phase, fault_phase, region_phase,
                  contention_phase, fleet_phase, predict_service_phase,
                  campaign_phase, record_phase):
        for kernel in counted:
            kernel.launches = 0
        phase(dev)
        torch.cuda.synchronize()
        print(f"{phase.__name__} launches: " + " ".join(
            f"{k.__name__}={k.launches}" for k in counted), flush=True)
        check(all(k.launches == 0 for k in counted),
              f"a kernel of the port was launched in {phase.__name__}")

    # ---- LM serving: qwen2-0.5b at full width, flash attention in prefill
    from repro_torch.configs import get_config
    flash_rec = flash_phase(dev)
    cfg = get_config(LM_ARCH)
    params = lm_params(cfg, dev)
    flash_launches = serve_phase(dev, cfg, params)
    by_path = {"flash_attention_fwd": {f"{LM_ARCH} serve": flash_launches}}
    prefill_phase(dev, cfg, params)
    del params

    # ---- Mamba-2: the SSD kernel, mamba2-780m scoring and serving
    ssd_rec = ssd_phase(dev)
    scfg = get_config(SSM_ARCH)
    sparams = lm_params(scfg, dev)
    ssd_launches = ssm_loss_phase(dev, scfg, sparams)
    by_path["ssd_scan"] = {f"{SSM_ARCH} loss": ssd_launches}
    ssm_serve_phase(dev, scfg, sparams)
    del sparams

    # ---- the moe and vlm families: phi3.5-moe (8 of 32 layers) and
    # llava-next-mistral-7b, flash attention in each prefill at hd 128;
    # then head_dim 80: the flash kernel there, stablelm-3b's serving and
    # the hybrid family (zamba2-2.7b: its loss runs both kernels); then the
    # encdec family (whisper-medium), on which no kernel runs; then the
    # serving launcher (qwen2-0.5b at full width, every arch at --smoke);
    # then the data pipeline and a full-width qwen2-0.5b checkpoint round
    # trip (flash in each of its three losses); then a full-width
    # qwen2-0.5b training step against the host CPU's (no kernel); then
    # the training loop at full width, resumed, and its launcher (no kernel);
    # then the dry-run's abstract trees and batches (no kernel); then the
    # sharding rules and spec trees, per-device bytes and blocks (no kernel)
    for phase in (moe_phase, vlm_phase, flash80_phase, stablelm_phase,
                  hybrid_phase, encdec_phase, launch_phase, ckpt_phase,
                  train_phase, train_loop_phase, api_phase, sharding_phase,
                  dryrun_phase):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for (kernel, path), n in phase(dev).items():
            by_path[kernel][path] = n
        torch.cuda.synchronize()
        print(f"{phase.__name__}: host wall {time.perf_counter() - t0:.3f} "
              f"s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)

    kernels = [{
        "name": "masked_min_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/maxmin_fair.cu",
        "replaces": "src/repro/kernels/maxmin_fair/kernel.py:41",
        "launches": launches, "max_abs_err": frontera_rec["max_abs_err"],
        "ms": frontera_rec["ms"], "plain_ms": frontera_rec["plain_ms"],
        "bound_ms": frontera_rec["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": flash_launches,
        "launches_by_path": by_path["flash_attention_fwd"], **flash_rec}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:67",
        "launches": ssd_launches, "launches_by_path": by_path["ssd_scan"],
        **ssd_rec}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
