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

Any failure exits non-zero.  The line before the last is a JSON object of
the kernels' measurements; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's src/ beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
FLASH_SHAPES = [(1, 128, 1, 1, 64), (2, 256, 2, 4, 64), (1, 256, 1, 7, 32),
                (1, 512, 4, 2, 128), (1, 200, 2, 7, 64), FLASH_SERVED,
                FLASH_MOE, FLASH_VLM]
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
    does."""
    from repro_torch.core import predict_cell, predict_cell_des, whatif
    from repro_torch.faults import FaultSpec
    from repro_torch.ft import (restart_plan_for_faults,
                                simulate_fault_impact,
                                simulate_straggler_impact)
    from repro_torch.workloads import get_workload
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

        for cell in RECORD_DES:
            name = "__".join(cell)
            want = REFERENCE_RECORD_DES[name]
            t0 = time.perf_counter()
            got = predict_cell_des(*cell)
            wall = time.perf_counter() - t0
            des_events += got["events"]
            des_wall += wall
            print(f"predict_cell_des {name}: step_s={got['step_s']!r} "
                  f"min_finish={got['min_finish']!r} events="
                  f"{got['events']} equal={got == want} host_wall_s="
                  f"{wall:.3f} events_per_s={got['events'] / wall:,.0f}",
                  flush=True)
            check(got == want, f"predict_cell_des {name}: {got} != the "
                  f"reference's {want}")

        s = RECORD_STRAGGLER
        t0 = time.perf_counter()
        got = simulate_straggler_impact(s["arch"], s["shape"],
                                        slowdown=s["slowdown"])
        wall = time.perf_counter() - t0
        want = dict(REFERENCE_RECORD_STRAGGLER, baseline_s=REFERENCE_RECORD_DES[
            "__".join((s["arch"], s["shape"], "16x16"))]["step_s"])
        print(f"simulate_straggler_impact {s}: {got} equal={got == want} "
              f"host_wall_s={wall:.3f} (two DES runs)", flush=True)
        check(got == want, f"simulate_straggler_impact: {got} != the "
              f"reference's {want}")

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
    print(f"record phase: host_wall_s={time.perf_counter() - t_phase:.3f} "
          f"des_events={des_events} des_host_wall_s={des_wall:.3f} "
          f"des_events_per_s={des_events / des_wall:,.0f}", flush=True)


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
    """(a) the flash kernel against its plain version at the test shapes
    and the MoE and VLM prefill shapes (with the planted tile faults at
    the ragged VLM one), then timed at qwen2-0.5b's prefill shape beside
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


def plain_serve(dev, cfg, params, spec):
    """The requests of ``spec`` (requests, prompt, new tokens, slots)
    served by the engine built without the kernel (the reference engine's
    build).  Returns its tokens and, per request, the logits over the real
    vocabulary from which it chose each token, read off the engine's own
    prefill and decode calls: per wave of ``slots`` requests, each
    request's prefill, then one decode step over the wave per further
    token.  Each call must be the one that schedule expects, told by the
    tokens it was fed (a prefill the request's prompt, decode step t each
    wave member's token t), or it raises ``SmokeFailure``."""
    from repro_torch.serve import ServeEngine
    n, prompt, new, slots = spec
    plain = ServeEngine(cfg, params, batch_slots=slots,
                        max_len=serve_max_len(cfg, prompt, new),
                        use_kernel=False, device=dev)
    model, rows = plain.model, []

    def keep(fn, kind):
        def call(*args, **kwargs):
            cache, logits = fn(*args, **kwargs)
            fed = args[1]["tokens"] if kind == "prefill" else args[2]
            rows.append((kind, fed.reshape(-1).tolist(),
                         logits[:, :cfg.vocab_size].float()))
            return cache, logits
        return call
    model.prefill = keep(model.prefill, "prefill")
    model.decode = keep(model.decode, "decode")
    reqs = serve_requests(cfg, n, prompt, new)
    ref = plain.run(reqs)
    logits, it = {}, iter(rows)

    def take(kind, fed):
        got = next(it, None)
        check(got is not None and got[:2] == (kind, fed),
              f"serve {cfg.name}: the plain engine's model calls do not "
              f"follow its waves (expected a {kind} fed {fed[:8]}, got "
              f"{None if got is None else (got[0], got[1][:8])})")
        return got[2]
    for w in range(0, n, slots):
        wave = reqs[w:w + slots]
        for r in wave:
            logits[r.rid] = [take("prefill", r.prompt.tolist())[0]]
        for t in range(new - 1):
            row = take("decode", [ref[r.rid][t] for r in wave])
            for i, r in enumerate(wave):
                logits[r.rid].append(row[i])
    check(next(it, None) is None, f"serve {cfg.name}: the plain engine made "
                                  "more model calls than its waves")
    return ref, logits


def compare_served(dev, cfg, params, out, spec=None, plain=None, label=""):
    """The tokens ``out`` served with the kernel against the same requests
    served by the engine built without it (``plain_serve``, or its result
    ``plain``).  Each request's tokens must be equal, or part where the
    plain path's two candidates are a near-tie: their logits, in the plain
    engine's own step, within ``PREFILL_LIMIT`` (the kernel-vs-plain gap
    allowed for the dtype) of the logits' largest magnitude."""
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
              f"differs at token {t} (plain {a}, kernel {b}); their logits "
              f"differ by {tie:.3e} of scale (near-tie limit {limit})",
              flush=True)
        check(tie <= limit, f"serve {cfg.dtype}: kernel and plain engines "
                            f"differ at request {rid} token {t}, not a "
                            f"near-tie ({tie} > {limit})")
    print(f"serve {cfg.name}{label} {cfg.dtype}: kernel and plain engines "
          f"served the same tokens for {same} of {len(ref)} requests",
          flush=True)


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
def planted(fault, layer=12):
    """A fault in the kernel path: the attention output of ``layer`` (the
    ``layer``-th flash call from 0) zeroed, or, for "no_causal_mask", the
    causal mask off in every layer."""
    from repro_torch.kernels.flash_attention import ops
    real = ops.flash_attention
    calls = []

    def faulty(q, k, v, causal=True):
        calls.append(None)
        if fault == "no_causal_mask":
            return real(q, k, v, causal=False)
        out = real(q, k, v, causal=causal)
        return torch.zeros_like(out) if len(calls) == layer + 1 else out
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
            return idx
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
    """The dense stack's residual stream in a run: every
    ``Model._dense_layer_fwd`` call's (one a layer, in prefill and in the
    loss's forward) input, attention output and output, in call order.
    ``record()`` keeps them; ``replay(log)`` also feeds each call the input
    ``log`` recorded for it in place of its own: each shape must match
    and every recorded input must be used, or it raises
    ``SmokeFailure``."""

    def __init__(self):
        self.inputs, self.attention, self.outputs = [], [], []

    @contextlib.contextmanager
    def _hooked(self, source):
        from repro_torch.models import layers, lm
        fwd, attn = lm.Model._dense_layer_fwd, layers.apply_attention
        self.inputs, self.attention, self.outputs = [], [], []
        feed = iter(source.inputs) if source is not None else None

        def layer(model, p_l, x, positions, **kwargs):
            if feed is not None:
                want = next(feed, None)
                check(want is not None and want.shape == x.shape,
                      f"stream replay: layer call {len(self.inputs)} takes "
                      f"{tuple(x.shape)}, recorded "
                      f"{None if want is None else tuple(want.shape)}")
                x = want
            self.inputs.append(x)
            out = fwd(model, p_l, x, positions, **kwargs)
            self.outputs.append(out[0])
            return out

        def attention(*args, **kwargs):
            out = attn(*args, **kwargs)
            self.attention.append(out[0])
            return out
        lm.Model._dense_layer_fwd, layers.apply_attention = layer, attention
        try:
            yield self
        finally:
            lm.Model._dense_layer_fwd, layers.apply_attention = fwd, attn
        if feed is not None:
            check(next(feed, None) is None,
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
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
    # the hybrid family (zamba2-2.7b: its loss runs both kernels)
    for phase in (moe_phase, vlm_phase, flash80_phase, stablelm_phase,
                  hybrid_phase):
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
