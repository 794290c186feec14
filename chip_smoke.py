#!/usr/bin/env python3
"""GPU smoke run of diffwdf_tpu_torch's main paths: batched diode-clipper
serving, in-circuit training of the clipper (engine="fused"), single-stream
serving through the streaming processor (engine="deer" and "scan"), batched
serving of the generic circuits (generated kernels) and the distilled
clipper, generic in-circuit training (engine="fused_generic": generated
forward and adjoint kernels) of the Tube Screamer and the clippers,
single-stream serving of the plugin's circuit set and the HPF clipper
(engine="deer": the generated DEER kernel), pretraining of the zoo's
neural roots, circuit sweeps and model-zoo ensembles on the generated
kernel, the DEER kernels against the parallel-in-time oracle, the deploy
artifact with its custom ops, every subcommand of the command line, the
multi-device layer at one rank (NCCL) and two ranks sharing the card
(gloo), and the roots the generated kernels took last: the distilled
root's training and parallel-in-time serving (B8, B9) and a general MLP
root's serving and export (B7).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

It builds the CUDA kernels from ``diffwdf_tpu_torch/ops/csrc`` and prints
one line per phase:

  toolchain  the card (name, power limit), torch, CUDA and nvcc versions
  build      nvcc compile of the kernel library, timed as set-up, the
             registers and spills ptxas reports per kernel, and the SASS of
             the serving kernels B1 (its lane and one-thread forms), B2, B5
             and the distilled clipper's B6 (instructions, transcendental
             units, branches, calls to the division's slow path, local
             memory)
  kernels    each serving kernel against its plain PyTorch version on the
             card at the served shape (8192 streams x 2048 samples), beside
             its budget; B1's lane form against its one-thread form, bit for
             bit; B2 at B = 1 too; no spill in the lane and paired kernels
  serve      serving as a user drives it: zoo roots 4 (neural 2x16,
             pretrained) and 0 (analytic, quality "best") in the LPF clipper
             answer four consecutive (8192, 2048) request blocks with the
             capacitor state carried between them; the launch counters must
             rise, the output must be finite and equal one (8192, 8192) run
  reference  serving kernels against the circuit's sequential
             Circuit.process on a small input
  timing     CUDA-event medians of each serving kernel and its plain
             version at (8192, 2048), in turns; B1's lanes per stream K (1,
             8, 16) at B = 1, 2048 and 8192
  kernels    the training forward and adjoint kernels against their plain
             versions at the training shape (1337 chunks x 2048 samples),
             pretrained 2x16, the train split's four source resistances;
             the forward's lane form (each K it can take) against its
             one-thread form, bit for bit; ptxas registers and spills of the
             lane form and the adjoint's two passes (no spill allowed)
  grad       the fused training op's loss and gradients against the scan
             engine (autograd through Circuit.process) at (1024, 256): a
             seeded random-init 2x16 at the JAX suite's budgets, and the
             pretrained 2x16 per leaf against an f64 run of the scan engine
  train      training as a user drives it (the train-clipper sequence):
             synthesize the 18-second, five-resistance measurement set of
             the 1U-2D diode pair at 48 kHz, load and chunk it, warm-start
             the pretrained 1U-1D 2x16 root
             and train only the root with train_clipper(engine="fused") for
             a few epochs with validation; the loss must fall, the launch
             counters must rise, and the trained root, saved and reloaded as
             JSON, must serve a (8192, 2048) block through the serving kernel
  timing     CUDA-event medians of the training kernels, the adjoint's two
             passes apart and its scratch, the forward's lanes per stream
             (1, 8, 16) at the training and validation batches, the plain
             versions, and the parts of one fused training step (forward
             kernel, loss, adjoint kernel, parameter VJP, Adam) and the
             whole step
  kernels deer  the single-stream DEER kernel (a cluster of 16 CTAs)
             against its plain version and against the exact recursion (the
             analytic kernel at B=1) at T = 2048 and 16384, for the "toms"
             (8 sweeps, 3 omega iterations) and "approx" (4, 1)
             configurations, hard overdrive, and the residual certificate at
             R = 180 Ohm; ptxas of the cluster kernel (no spill)
  stream     single-stream serving as a plugin drives it: one second of a
             seeded stereo strum at 96 kHz in 47 blocks of 2048 through
             make_clipper_processor(engine="deer") and (engine="scan"),
             with model hot-swaps, gain and cutoff changes; deer against
             scan block for block, one kernel launch per served block, the
             residual fallback at the cutoff that maps to 180 Ohm, a
             1000-sample block, and the scan group with its neural member
             against the same processor on the CPU
  warmup     host wall ms of a cold first block, the first block after
             warmup([2048]) and the steady median, per engine
  timing deer  CUDA-event medians (10 calls back to back) and device
             times (launches queued back to back) of the DEER kernel at 16
             CTAs, with cudaOccupancyMaxActiveClusters, the device time with
             no sweep and no relaxation, a relaxation pass and a sweep, and
             its plain version; the exact engine's kernels B1 and B2 at B=1
             with the SM clock and cycles per sample, process_block wall ms
             and real-time factor per engine, and the device work of one
             served block from a profiler trace (taken again until it holds
             one kernel event per counted launch; the line says whether it
             does)
  build circuits  the generated kernels of seven circuits (Tube Screamer
             analytic "best" and "low" and pretrained 2x16, HPF clipper
             analytic and HPF-trained 2x16, LPF clipper, RC lowpass), the K
             sweep's builds of the two 2x16 roots (every K that divides H)
             and the other block size of the diode pair's lane form (TS and
             LPF), one nvcc each, all started together: seconds cold and
             cached, ptxas registers and spills per kernel (none allowed in
             the lane-cooperative ones), slots and operations per sample,
             the SASS of the diode pair's one-thread and lane kernels
  kernels distilled  the 1N4148 root distilled at the clipper's port R (fit
             error), the distilled clipper kernel (one Chebyshev segment a
             lane) against its plain version and against the analytic kernel
             (ESR) at (8192, 2048); ptxas of its every (degree, K) (no
             spill)
  kernels circuit  omega() against omega_select on the card over a grid
             (the generated forward's omega); every generated kernel
             against its plain version at (8192, 2048), the LPF clipper's
             also against the analytic kernel, the lane-cooperative form of
             the NxH roots and of the diode pair (K = 2) also against the
             one-thread kernel (the same bits)
  serve circuit  serving as a user drives it: the Tube Screamer (analytic
             and 2x16), the HPF 2x16 and the distilled clipper answer two
             (8192, 2048) request blocks with the state carried; the launch
             counters must rise and the blocks equal one run; the drive pot
             from 0 to 1 moves the gain without an nvcc run
  timing circuit  CUDA-event medians of the distilled and generated kernels,
             the wrapper calls, the plain versions and the LPF clipper's own
             kernels on the same streams; B7 at B = 1 (the plugin's TS
             "low", the HPF "toms") and B6 at B = 1, device time, with the SM
             clock; the diode pair's lane form in blocks of 64 and
             128 threads in turns; the lanes per stream K of the NxH
             roots' kernel (1, the one-thread kernel, 4, 8, 16; the sweep's
             build) for the TS 2x16 and the HPF 2x16 at B = 8192, 4096,
             2048 and 1024, T = 2048
  build generic  the generated forward and adjoint kernels of the generic
             training path's four cases and the train phase's circuits, and
             the sweep's build of the training form, one nvcc each, all
             started together:
             ptxas registers and spills per kernel (none allowed in the lane
             form and the adjoint's two passes), operations per sample of
             each pass, the adjoint's scratch
  kernels generic  at (1024, 2048), the JAX bench's shape: the generated
             forward with its state trajectory and the generated adjoint
             against their plain versions for the Tube Screamer with the
             pretrained 2x16 (no pot, and a per-row drive pot R6), the HPF
             clipper (analytic) and the training clipper with a per-sample
             random-walk source R (random-init 2x16); the lane form against
             the one-thread kernel (the same bits); the Tube Screamer 2x16's
             root streams (a, G) and its parameter pass on them
  grad generic  the fused_generic op's gradients against the scan engine
             (autograd through Circuit.process) at (1024, 256), leaf by leaf
  train generic  training as a user drives it (scripts/train_ts.py): 16 s and
             4 s of synthetic Tube Screamer measurements (1U-2D pair) at 48
             kHz, drive 0.5, chunked into 375 and 93 chunks of 2048; the
             pretrained 1U-1D 2x16 fine-tuned in the TS with train_clipper(engine="fused_generic")
             for 10 epochs, the loss must fall; 2 steps with a per-row drive
             pot (pot_node="R6"); joint_fit_clipper of C and a 1x4 root on the
             training clipper with one R per row at (1024, 2048), C from 6.5 nF
             toward the true 4.7 nF; launches counted
  timing generic  CUDA-event medians of one fused_generic step of the TS
             2x16 at (1024, 2048), part by part (forward with trajectory,
             loss, adjoint, parameter pass, Adam) and whole; both kernels
             alone beside their bounds, the adjoint's two passes apart and
             at (375, 2048), the training form's lanes per stream, the
             scratch
  build deer  the generated DEER kernels (B9) of eleven circuits (the Tube
             Screamer analytic best and low and 2x16, the HPF clipper
             analytic best and low and 2x16, the LPF clipper with the five
             1U-1D neural sizes) and their exact recursions (B7), one nvcc
             each, all started together: seconds cold and cached; the cold
             nvcc seconds of one source alone (the Tube Screamer's and its
             2x16's, B5's); ptxas registers and spills and the SASS of the
             cluster kernel (no spill), operations per sample
  kernels deer circuit  each B9 against its plain version and the exact
             recursion (B7 at B=1) at T = 2048 and 16384, at the JAX suite's
             budgets, with as many sweeps run; the adaptive HPF's early exit
             at JAX's count; two chained 2x8-clipper blocks against one
             solve; the residual flagging a hard-overdrive block; a drive
             change with no nvcc run
  stream plugin  single-stream serving as a plugin drives it: the same strum
             through make_plugin_processor(engine="deer") and (engine="scan"),
             hot-swapping all 14 members with cutoff, drive and gain changes,
             deer against scan block for block, one launch per served block
             (a block the residual flags: one more, the exact engine's), a
             1000-sample block on B7; the HPF processor's four members and the
             clipper processor's neural member, deer against scan; warmup
             builds every member's kernels first
  timing deer circuit  CUDA-event medians and device times of B9's
             launch alone (arguments and outputs prepared once), at 16 CTAs,
             with cudaOccupancyMaxActiveClusters (and for the TS bench and the
             fixed HPF the time of a relaxation pass and of a sweep), for
             the TS at T = 2048 and at the JAX
             bench's T = 16384 with 10 sweeps and 4 relaxations, the TS 2x16,
             the HPF at 48 fixed and adaptive sweeps and the 2x16 clipper,
             beside their bounds and plain versions, and
             process_block wall ms, real-time factor and a profile of one
             block per group and engine (the trace checked as in timing
             deer); the B7 launches of the diode pair's lane form on the
             plugin stream

  pretrain   pretraining as a user drives it: the 2x16 1N4148 (1U-1D) root
             at the reference grid (20 x 1000 points, 625 steps of 32 an
             epoch, Adam 2e-5) for a few epochs, replayed from CUDA graphs
             and again eagerly (the same bits), and eight seeds at once
             (seed 0 the single run's curve within 5e-4); evaluate, the
             transconductance error, the model saved, loaded and served by
             B1 at B = 1 against its plain version
  timing pretrain  CUDA-event ms an epoch, steps a second and a 2,000-epoch
             run's time, graph-replayed and eager, one seed and eight
  sweep      BASELINE configuration 4: the LPF clipper (analytic 1U-1D
             pair) with 1,024 source resistances from 1 to 100 kOhm over one
             2,048-sample input through sweep_process: one B7 launch, every
             row against the plain version, the output energy falling with R
  timing sweep  the sweep_process call and its B7 launch alone (CUDA events),
             samples a second, the bound and the plain version
  ensemble   the seven checked-in 2x16 zoo roots over one input through
             ensemble_process: one B7 launch of the NxH lane form an expert,
             each against its plain version, the experts distinct
  oracle     B5 (the LPF clipper) and B9 (the Tube Screamer) at T = 2,048
             against the parallel-in-time oracle ops/parallel_time.py (the
             circuit's own step in torch ops) on the card, at the JAX
             suite's budgets, with the oracle's residual below its bound
  artifact   the deploy artifact (runtime/artifact.py, torch.export) and the
             three torch.library ops it holds (ops/registry.py): the
             export-artifact command's zoo 0 (B2's op), zoo 4 (B1's) and Tube
             Screamer (B7's) exported; each artifact's first load on the card
             and on the CPU in a fresh build directory and again cached (nvcc
             and c++ runs, seconds); each op against its direct wrapper call,
             bit for bit, at B = 1 and 8192, and against its plain version at
             B = 1; eight served blocks per artifact (one op launch each, in
             the wrappers' counters, set to 0 before); the blocks against the stream's
             exact runner bit for bit, chunked against one call; an artifact
             block's host wall against the exact runner's in turns, and each
             op's CUDA-event time beside its bound and its plain version
  cli        every subcommand of python -m diffwdf_tpu_torch.cli in a
             subprocess on the card, eight at a time (bench alone after):
             pretrain (5 epochs), train-clipper on the fused and fused_generic
             engines (synthetic set, 2 epochs, 32 chunks), simulate with each
             of the four engines on the clipper and the Tube Screamer (within
             5e-5 of each other), process --engine deer --warmup on a seeded
             stereo WAV, params, export-artifact --check (zoo 0, zoo 4, the
             Tube Screamer) and run-artifact, fit-components, plot (where
             matplotlib imports; the line says so) and bench (the JAX bench's
             headline on B1); each command's JSON line parsed and checked,
             its wall printed
  parallel   the multi-device layer (diffwdf_tpu_torch/parallel/): B3 and B4
             at a rank's DP rows, B7 at a time-block rank's block (B = 1)
             and B8 at a time-block training rank's, each against its plain
             version, timed, with its bound; the single-process references;
             then one rank under NCCL (the one-card deployment) and two
             ranks sharing the card under gloo, each run spawned on a
             FileStore: the DP step of the clipper (fused, 1,336 x 2,048,
             pretrained 2x16) and of the TS 2x16 (fused_generic, 1,024 x
             2,048) against the single-process step (loss, reduced
             gradient, params after a step; replicas the same bits),
             time-block serving of 16,384 samples a rank (W 256) and its
             exact handoff against B7 over the whole signal, with two ranks
             the time-block training step (4,096 a rank, W 192) against
             the generic engine over the whole row and the 1,024-R sweep
             sharded against one run, with one rank the step times against
             the single-process step, B7 alone, and run_scaling_suite; the
             launches of B3, B4, B7 and B8 read in every rank
  distilled_path  the 1N4148 1U-1D pair ("best") distilled at the LPF
             clipper's port R (96 kHz, 47 kOhm, 2.2 nF): the new generated
             sources in one parallel nvcc, ptxas of every new kernel (no spill
             in B8's pass 1, B9's cluster kernel and B7's lane forms); B9 at
             T = 2,048 and 16,384 on stream_path's DEER inputs (and a quiet
             one) against its plain version and B6's scan (1e-6), at 2,048 the
             oracle (1e-4), its residual and device time; B7's lane forms
             against its one-thread form, the same bits, in turns with it (10
             calls and the device time): the distilled root (one Chebyshev
             segment a lane, K = 4) in the training form at (1024, 2048) and
             at B = 1 (faster than one thread there, checked) and served at
             (8192, 2048) beside B6, the general MLP roots (K = 8, and the
             relu root's K = 4) at B = 1 and at (8192, 2048) with plain
             there (2e-5); B7's training form and B8 at (1024, 2048) against
             their plain versions (2e-5, 1e-4 relative), the fused_generic
             gradients against the scan engine at (1024, 256), 5e-4 a leaf;
             B7's general MLP root (a relu-mixed and a sigmoid 2x8 JSON root)
             against its plain version at B = 1; then, the counters set to 0:
             B9 serving two blocks, five fused_generic steps training C from
             20% off (the target from B2), the time-block training step at one
             rank under NCCL against the single-process step, and both JSON
             roots served 47 blocks of 2,048 by the exact runner (block walls
             beside Circuit.process's, in turns, 2e-5) and by an artifact (the
             relu one by export-artifact --check in a subprocess started
             first); every B7 launch of the training steps, the time-block
             rank and the served blocks on the lane form
             (``fused_circuit_process.lane_launches``)

Each path's seconds follow it on a "phase seconds" line.  Then a JSON line
with every kernel's (and op's) launches, error, times and bound, the card's
name and power limit, and finally ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero and prints no result;
so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from diffwdf_tpu_torch.analysis import transconductance_error
from diffwdf_tpu_torch.data.dataimport import load_diode_data
from diffwdf_tpu_torch.data.synthetic import make_synthetic_dataset_dir, synth_ts_measurement
from diffwdf_tpu_torch.models.diode_clipper import (
    cutoff_to_resistance,
    make_diode_clipper,
    make_hpf_diode_clipper,
    make_hpf_root_from_zoo,
    make_root_from_zoo,
    make_training_clipper,
    pretrained_model_path,
)
from diffwdf_tpu_torch.models.simple_circuits import make_rc_lowpass
from diffwdf_tpu_torch.models.tube_screamer import drive_to_r6, make_tube_screamer
from diffwdf_tpu_torch.nn.serialization import load_model_json, save_model_json
from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops import circuit_codegen as cg
from diffwdf_tpu_torch.ops import clipper_train as ct
from diffwdf_tpu_torch.ops import deer_circuit as dc
from diffwdf_tpu_torch.ops import fused_circuit as fcirc
from diffwdf_tpu_torch.ops import fused_clipper as fc
from diffwdf_tpu_torch.ops import parallel_bptt as pb
from diffwdf_tpu_torch.ops import registry
from diffwdf_tpu_torch.ops.parallel_time import parallel_time_process
from diffwdf_tpu_torch.ops import parallel_time_deer as pd
from diffwdf_tpu_torch.parallel.data_parallel import make_dp_train_step
from diffwdf_tpu_torch.parallel.distributed import spawn
from diffwdf_tpu_torch.parallel.mesh import make_mesh
from diffwdf_tpu_torch.parallel.scaling_bench import run_scaling_suite
from diffwdf_tpu_torch.parallel.sweep import ensemble_process, stack_mlp_params, sweep_process
from diffwdf_tpu_torch.parallel.time_block import (
    make_time_block_train_step,
    time_block_process,
    time_block_process_exact,
)
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d, diode_1n4148_1u2d
from diffwdf_tpu_torch.roots.distilled import PiecewiseChebRoot, distill_root
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.runtime.artifact import load_artifact, save_artifact
from diffwdf_tpu_torch.runtime.stream import (
    HPF_DEER,
    _diode_pair_args,
    _generic_exact_runner,
    _lpf_exact_runner,
    make_clipper_processor,
    make_hpf_processor,
    make_plugin_processor,
)
from diffwdf_tpu_torch.training.circuit_train import (
    CircuitTrainConfig,
    joint_fit_clipper,
    make_clipper_batches,
    make_loss_fn,
    make_train_step,
    train_clipper,
)
from diffwdf_tpu_torch.training.losses import esr, mse
from diffwdf_tpu_torch.training.metrics import MetricsLogger
from diffwdf_tpu_torch.training import pretrain as tp

FS = 96000.0
B, T, BLOCKS = 8192, 2048, 4
REPS = 10  # timed runs per version, after warm-up
WALL_REPS = 30  # served blocks per host-wall timing
BUDGET = {"analytic": 5e-6, "neural": 2e-5}  # the JAX suite's kernel-vs-scan budgets
SOURCE = "diffwdf_tpu_torch/ops/csrc/fused_clipper.cu"
REPLACES = {
    "analytic": "diffwdf_tpu/ops/fused_clipper.py:168",
    "neural": "diffwdf_tpu/ops/fused_clipper.py:336",
}

# in-circuit training: the reference's measured-data workload (clipper_pot.py)
# at the size of the train-clipper command's synthetic data set.  The
# measurements are of the 1U-2D diode pair and the warm start is the 1U-1D
# pretrained root: on its own 1U-1D data that root is already at Adam's noise
# floor for lr 1e-4 (the loss rises after the first step), while adapting it
# to the 1U-2D pair is a task whose loss falls from the first epoch.
TRAIN_FS, TRAIN_CAP, TRAIN_SECONDS = 48000.0, 4.7e-9, 18.0
TRAIN_DIODE = diode_1n4148_1u2d
R_KOHMS = (10.0, 25.0, 45.2, 75.0, 99.0)  # 45.2k is the validation split
CHUNK = 2048
TRAIN_CHUNKS, VAL_CHUNKS = 1337, 335  # 4 (1) files x 686,400 samples, mixed-R chunks dropped
EPOCHS = 10
GRAD_B, GRAD_T = 1024, 256
TRAIN_SOURCE = "diffwdf_tpu_torch/ops/csrc/clipper_train.cu"
TRAIN_REPLACES = {
    "train_fwd": "diffwdf_tpu/ops/fused_clipper.py:496",
    "adjoint": "diffwdf_tpu/ops/clipper_train.py:84",
}

# single-stream serving: the plugin's real-time regime (one mono stream,
# blocks of 2048, DiodeClipper.cpp's cutoff and gain parameters)
DEER_T = (2048, 16384)
DEER_CFG = {"toms": (8, 3), "approx": (4, 1)}  # (sweeps, omega iterations), stream.py:619
DEER_BUDGET = {"toms": 1e-6, "approx": 5e-6}  # vs the exact recursion (the JAX suite's)
STREAM_BLOCK, STREAM_BLOCKS = 2048, 47  # one second at 96 kHz, padded to whole blocks
# (first block, model, gain dB, cutoff Hz) of each segment of the stream
STREAM_SCHEDULE = ((0, "toms", 0.0, 4000.0), (8, "toms", 6.0, 4000.0),
                   (16, "approx", 6.0, 4000.0), (24, "approx", 6.0, 8000.0),
                   (32, "toms", 12.0, 2000.0), (40, "approx", 0.0, 2000.0))
BAD_CUTOFF = 1.0 / (2.0 * np.pi * 180.0 * 2.2e-9)  # maps to R = 180 Ohm
DEER_SOURCE = "diffwdf_tpu_torch/ops/csrc/parallel_time_deer.cu"
DEER_REPLACES = "diffwdf_tpu/ops/parallel_time_deer.py:238"

# batched serving of the generic circuits (the JAX bench's batch-serving
# section after the headline, bench.py:364-453): the distilled clipper
# through B6 and the Tube Screamer, the HPF clipper, the LPF clipper and the
# RC lowpass through generated B7 kernels, at the serving shape with the
# state carried over two request blocks
CIRCUIT_BLOCKS = 2
CHEB_SOURCE = "diffwdf_tpu_torch/ops/csrc/cheb.cu"
CHEB_REPLACES = "diffwdf_tpu/ops/fused_clipper.py:674"
CIRCUIT_SOURCE = "diffwdf_tpu_torch/ops/circuit_codegen.py"
CIRCUIT_REPLACES = "diffwdf_tpu/ops/fused_circuit.py:325"
R_SRC, CAP = 47.0e3, 2.2e-9

# generic in-circuit training (engine="fused_generic"): scripts/train_ts.py's
# workload (the Tube Screamer's pretrained 2x16 fine-tuned in its own
# topology) and the JAX bench's generic-training shape (bench.py:521-640)
GEN_FS, GEN_DRIVE = 48000.0, 0.5
# the measurements are of the 1U-2D pair in the TS and the warm start is the
# 1U-1D pretrained root, as in the clipper's train phase: on its own 1U-1D
# TS data that root is at Adam's noise floor for lr 1e-4 (the loss rises
# after the first step), while the 1U-2D pair is a task whose loss falls
GEN_DIODE = diode_1n4148_1u2d
GEN_TRAIN_S, GEN_VAL_S = 16.0, 4.0
GEN_TRAIN_CHUNKS, GEN_VAL_CHUNKS = 375, 93
GEN_EPOCHS, GEN_POT_STEPS, JOINT_EPOCHS = 10, 2, 12
GEN_B, GEN_T = 1024, 2048
GEN_GRAD_B, GEN_GRAD_T = 1024, 256
GEN_CASES = ("ts_2x16", "ts_2x16_row", "hpf", "clipper_sample")
GEN_BUDGET = {"ts_2x16": 1e-4, "ts_2x16_row": 3e-4, "hpf": 1e-4, "clipper_sample": 3e-4}
GEN_GRAD_BUDGET = {"ts_2x16": 5e-4, "ts_2x16_row": 1e-3, "hpf": 1e-3, "clipper_sample": 1e-3}
BPTT_REPLACES = "diffwdf_tpu/ops/parallel_bptt.py:350"

# single-stream serving of the circuits the clipper's DEER kernel cannot
# serve (diffwdf_tpu/runtime/stream.py:643-959): the Tube Screamer, the HPF
# clipper and the neural clippers through the generic DEER kernel (B9), in
# the plugin's circuit set, the HPF processor and the clipper processor
DC_CASES = ("ts", "ts_low", "ts_2x16", "hpf", "hpf_low", "hpf_2x16",
            "clip_2x4", "clip_2x8", "clip_2x16", "clip_4x4", "clip_4x8")
DC_T = (2048, 16384)
DC_BUDGET = {"ts": 1e-4, "hpf": 3e-4, "clip": 5e-6}  # vs the exact recursion (the JAX suite's)
#: B9 against its plain version on a block that the sweeps do not converge:
#: the same algorithm on the same trajectory, the order of the scan's
#: roundings apart (JAX and the port's plain version: 2.3e-5 on such a TS
#: block, tests/test_torch_deer_circuit.py::test_flagged_block_diverges_as_in_jax)
DC_UNCONVERGED_BUDGET = 1e-3
DC_REPLACES = {"circuit": "diffwdf_tpu/ops/deer_circuit.py:56",
               "neural": "diffwdf_tpu/ops/deer_circuit.py:431"}
#: numpy seeds of the HPF's kernel inputs (see _dc_input)
HPF_SEED = {2048: 202, 16384: 210}
PLUGIN_BUDGET, HPF_BUDGET, NEURAL_BUDGET = 2e-4, 5e-4, 1e-5  # deer vs scan, block for block
PLUGIN_MEMBERS = tuple([("clipper", i) for i in range(7)]
                       + [("multi_diode_clipper", i) for i in range(5)]
                       + [("tube_screamer", 0), ("tube_screamer", 1)])
#: the plugin stream's blocks (index: member) whose DEER residual exceeds
#: the fallback tolerance at --seed 0, each by over 500x: the strum's
#: attack through the 2x4 and 4x4 clippers and the Tube Screamer 2x16
PLUGIN_FLAGGED_SEED0 = {6: "clipper/2", 15: "clipper/5", 41: "tube_screamer/1",
                        43: "tube_screamer/1", 44: "tube_screamer/1"}

# the bound: the larger of the operations over the card's f32 peak (outside
# the tensor cores) and the bytes over its memory rate (NVIDIA's data sheet,
# H100 SXM).  Operations are counted from each kernel's source, one per f32
# add, multiply, compare, select, division or transcendental call (expf,
# logf, tanhf) and two per fused multiply-add; bytes count each input read
# once and each output written once.
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12


def _bound(ops: float, nbytes: float):
    """(bound_ms, bound_by) of work of ``ops`` operations and ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _omega_ops(iters: int) -> int:
    # region guess (two compares, the longest branch 7) + per Newton step
    # expf, two adds, a subtract, a division, an update + the final expf
    return 10 + 6 * iters


def _step_ops(iters: int) -> int:
    """One analytic clipper step z' = f(z, v): b_temp, a, sign, six selects,
    the two omega arguments and b_root around two omega solves."""
    return 25 + 2 * _omega_ops(iters)


def _analytic_ops(iters: int) -> int:
    return _step_ops(iters) + 2  # + the output (z' + z) / 2


def _neural_ops(h: int, n_hidden: int) -> int:
    """One NxH clipper step: first layer (FMA + tanh), hidden layers (H x H
    FMAs, bias, tanh), linear head, and the clipper's 8 around the root."""
    return 3 * h + n_hidden * (2 * h * h + 2 * h) + 2 * h + 8


def _adjoint_ops(h: int, n_hidden: int) -> int:
    """One reverse step: the forward MLP at a_t, its closed-form tangent
    (first layer 3H, hidden 2H^2 + 3H, head 2H) and the lambda recursion
    with its outputs (13)."""
    tangent = 3 * h + n_hidden * (2 * h * h + 3 * h) + 2 * h
    return _neural_ops(h, n_hidden) - 7 + tangent + 13


def _scan_ops(S: int) -> int:
    """One sweep's block scan at S states, as the function needs it
    whatever the kernel's layout: the exclusive scan of the 1024 block
    totals (1023 compositions, S^2 (2S - 1) + 2 S^2 operations each) and
    each block's start state (1024 applications, 2 S^2 each)."""
    return 1023 * (S * S * (2 * S - 1) + 2 * S * S) + 1024 * 2 * S * S


def _deer_ops(T: int, sweeps: int, relax: int, iters: int) -> int:
    """The DEER kernel on T samples: the max|v| pass, relax_passes true
    steps, per sweep a step with its Jacobian (14 more), the affine row
    (3 + 2) and the fix-up with its clamp (4), the emit pass (a step and 5),
    and per sweep the block scan (``_scan_ops``)."""
    f = _step_ops(iters)
    return T * (2 + relax * f + sweeps * (f + 23) + f + 5) + sweeps * _scan_ops(1)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _max_err(x: torch.Tensor, y: torch.Tensor) -> float:
    return float((x - y).abs().max())


def _zoo_circuit(index: int, device):
    root, root_params = make_root_from_zoo(index, device=device)
    ckt = make_diode_clipper(root, FS)
    return ckt, {**ckt.init_params(device), **root_params}


def block_server(ckt, params):
    """The serving function of the LPF clipper ``ckt``: its block-rate
    scalars (source R, C, diode physics) are read to the host once, so that
    answering a block launches one kernel and never waits on the card.
    Returns serve(vin, z, plain=False) -> (out, z_final), with ``plain``
    selecting the kernel's plain PyTorch version."""
    root = ckt.root
    r_source, cap = float(params["Vs"]["R"]), float(params["C"]["C"])
    if isinstance(root, NeuralDiodeRoot):
        mlp = params[root.name]

        def serve(vin, z, plain=False):
            fn = fc.fused_clipper_neural_plain if plain else fc.fused_clipper_neural
            return fn(vin, z, mlp, r_source, cap, fs=ckt.fs)

        return serve
    p = {k: float(v) for k, v in params[root.name].items()}
    args = (r_source, cap, p["Is"], p["nabla"] * p["Vt"], p["N_up"], p["N_down"])

    def serve(vin, z, plain=False):
        fn = fc.fused_clipper_analytic_plain if plain else fc.fused_clipper_analytic
        return fn(vin, z, *args, fs=ckt.fs, quality_iters=root.iters)

    return serve


def _cuda_ms(fn, runs: int, calls: int = 1) -> list:
    """CUDA-event time of ``calls`` back-to-back calls of fn, per call, for
    each of ``runs`` runs."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def _timed(fn, runs: int = REPS):
    """Median and spread of CUDA-event times of fn, one call per run, after
    one warm-up call."""
    _cuda_ms(fn, 1)
    ms = _cuda_ms(fn, runs)
    return statistics.median(ms), min(ms), max(ms)


#: the DEER kernels' names in a profiler trace (B5's cluster kernel, B9's)
DEER_KERNEL_NAMES = ("deer_clipper_cluster_kernel", "deer_cluster_kernel")


def _device_ms(fn, calls: int = 10) -> float:
    """Device ms per launch of the kernel that fn launches: CUDA events
    between ``calls`` launches queued behind a ~10-ms spin of the card, so
    that they run back to back whatever the host takes to issue them (the
    median of the gaps).  A profiler trace missed most launches of the
    generated kernels on some runs, so it is not read for this."""
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    torch.cuda._sleep(20_000_000)
    evs[0].record()
    for ev in evs[1:]:
        fn()
        ev.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(evs, evs[1:]))


def _forms_in_turns(forms: dict, launch_only: Optional[dict] = None) -> dict:
    """label -> (median, min, max of the per-call CUDA-event ms of 10 calls
    back to back, over REPS runs in turns; the median of REPS device times
    a launch, ``_device_ms`` of the same label in ``launch_only``, default
    ``forms``): each fn launches one DEER kernel."""
    launch_only = launch_only or forms
    for fn in forms.values():  # warm-up
        _cuda_ms(fn, 1, 2)
    ms = {label: [] for label in forms}
    dev = {label: [] for label in forms}
    labels = list(forms)
    for rep in range(REPS):
        for label in (labels if rep % 2 else labels[::-1]):
            ms[label] += _cuda_ms(forms[label], 1, 10)
            dev[label].append(_device_ms(launch_only[label]))
    return {label: (statistics.median(v), min(v), max(v), statistics.median(dev[label]))
            for label, v in ms.items()}


def _breakdown(make, sweeps: int, relax: int) -> str:
    """Where a DEER launch's device time goes: ``make(sweeps, relax)`` gives
    a call that launches the kernel with that many sweeps and relaxation
    passes; the time with neither (stage, emit, launch), then each
    relaxation pass and each sweep, from the differences."""
    base, with_relax, whole = (_device_ms(make(s, r)) for s, r in
                               ((0, 0), (0, relax), (sweeps, relax)))
    return (f"no_sweep_no_relaxation_ms={base:.4f} per_relaxation_ms="
            f"{(with_relax - base) / relax:.4f} per_sweep_ms={(whole - with_relax) / sweeps:.4f}")


def _forms_line(times: dict) -> str:
    return " ".join(f"{label}_ms={m:.4f} [{lo:.4f}, {hi:.4f}] {label}_device_ms={d:.4f}"
                    for label, (m, lo, hi, d) in times.items())


@contextlib.contextmanager
def _sm_clock():
    """Sample card 0's SM clock (MHz) every 50 ms while the block runs;
    yields a list that holds the samples when the block has ended."""
    proc = subprocess.Popen(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    samples = []
    try:
        yield samples
    finally:
        proc.terminate()
        samples += [float(v) for v in proc.communicate()[0].split() if v.isdigit()]


def _wall_ms(serve) -> list:
    """Host wall ms of WALL_REPS served blocks (the caller has served one
    to warm up)."""
    wall = []
    for _ in range(WALL_REPS):
        t0 = time.perf_counter()
        serve()
        wall.append((time.perf_counter() - t0) * 1e3)
    return wall


#: (pattern of the mangled name, label) of the serving kernels whose SASS
#: the build phase summarises: B1 (its one-thread and lane forms), B2, B5
#: and B6
SASS_KERNELS = ((r"\d+analytic_pair_kernelILi3EE", "analytic_pair_kernel<3>"),
                (r"\d+neural_kernelILi16EE", "neural_kernel<16>"),
                (r"\d+neural_lanes_kernelILi16ELi16ELi2EE", "neural_lanes_kernel<16,16,2>"),
                (r"\d+neural_lanes_kernelILi16ELi8ELi2EE", "neural_lanes_kernel<16,8,2>"),
                (r"\d+deer_clipper_cluster_kernelILi16EE", "deer_clipper_cluster_kernel<16>"),
                (r"\d+cheb_lanes_kernelILi24ELi4EE", "cheb_lanes_kernel<24,4>"))
#: the generated DEER kernel's SASS, summarised for each B9 source
DEER_SASS_KERNELS = ((r"\d+deer_cluster_kernelILi16EE", "deer_cluster_kernel<16>"),)
#: the SASS opcodes counted: the transcendental unit, branches, convergence
#: barriers, calls (the IEEE division's slow path), local memory (spills),
#: global and shared loads, shuffles
SASS_OPS = ("MUFU", "BRA", "BSSY", "CALL", "LDL", "STL", "LDG", "LDS", "SHFL", "FFMA")


def _sass_summary(lib: Optional[Path] = None, kernels=SASS_KERNELS) -> list:
    """One line per kernel of ``kernels`` from ``cuobjdump -sass`` of a
    library (default: the kernel library): its instructions and the count
    of each of SASS_OPS."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib or _build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    lines = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        label = next((lab for pat, lab in kernels if re.search(pat, name)), None)
        if label is None:
            continue
        ops = [m.split(".")[0] for m in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", part)]
        lines.append(f"{label}: {len(ops)} instructions, "
                     + ", ".join(f"{op} {ops.count(op)}" for op in SASS_OPS))
    return lines


def _ptxas_lines() -> list:
    """The compiler's per-kernel lines (entry function, registers, spills)."""
    log = _build.library_path().with_suffix(".log")
    keep = ("Compiling entry function", "registers", "spill")
    return [l.strip() for l in log.read_text().splitlines()
            if any(k in l for k in keep)] if log.exists() else []


def serve_path(dev, card: str, seed: int) -> list:
    """Batched serving: kernels, serve, reference and timing phases.
    Returns the two serving kernels' records for the JSON line."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    signal = 2.0 * torch.randn(B, BLOCKS * T, generator=gen, device=dev)
    blocks = [signal[:, i * T:(i + 1) * T].contiguous() for i in range(BLOCKS)]
    z0 = torch.zeros(B, device=dev)

    circuits = {"neural": _zoo_circuit(4, dev), "analytic": _zoo_circuit(0, dev)}
    servers = {name: block_server(*c) for name, c in circuits.items()}
    _check(isinstance(circuits["neural"][0].root, NeuralDiodeRoot)
           and circuits["neural"][0].root.layer_size == 16, "zoo entry 4 is the 2x16 net")
    _check(circuits["analytic"][0].root.diode == diode_1n4148_1u1d
           and circuits["analytic"][0].root.quality == "best", "zoo entry 0 is 1U-1D best")

    # --- kernels vs plain at the served shape --------------------------------
    max_err = {}
    cases = [("neural", "2x16 pretrained", servers["neural"])]
    for diode in (diode_1n4148_1u1d, diode_1n4148_1u2d):
        root, rp = make_root_from_zoo(0, diode=diode, device=dev)
        ckt = make_diode_clipper(root, FS)
        cases.append(("analytic", f"best {diode.name}",
                      block_server(ckt, {**ckt.init_params(dev), **rp})))
    mlp = circuits["neural"][1]["dp"]
    # the served call's constants (block_server reads them from the params)
    served_rc = (float(circuits["neural"][1]["Vs"]["R"]), float(circuits["neural"][1]["C"]["C"]))
    for name, label, serve in cases:
        got, got_z = serve(blocks[0], z0)
        want, want_z = serve(blocks[0], z0, plain=True)
        torch.cuda.synchronize()
        err = max(_max_err(got, want), _max_err(got_z, want_z))
        max_err[name] = max(max_err.get(name, 0.0), err)
        bits = ""
        if name == "neural":  # the lane form keeps the one-thread kernel's bits
            one, one_z = fc.launch_neural(blocks[0], z0, mlp, *served_rc, fs=FS, lanes=1)
            equal = torch.equal(got, one) and torch.equal(got_z, one_z)
            bits = f" vs_one_thread_form bits_equal={equal}"
        print(f"phase kernels {name} {label} shape=({B}, {T}) max_abs_err={err:.3e} "
              f"budget={BUDGET[name]:.0e}{bits}", flush=True)
        _check(bool(torch.isfinite(got).all()) and err <= BUDGET[name],
               f"{name} kernel {label} within {BUDGET[name]} of its plain version")
        if name == "neural":
            _check(equal, "B1's lane form gives its one-thread form's bits")
    # B2 at B = 1 (the scan engine's blocks), at the low and the best quality
    one = blocks[0][:1].contiguous()
    for quality in ("low", "best"):
        root = DiodePairRoot(name="dp", quality=quality)
        ckt = make_diode_clipper(root, FS)
        serve = block_server(ckt, {**ckt.init_params(dev), **root.init_params(dev)})
        got, got_z = serve(one, z0[:1])
        want, want_z = serve(one, z0[:1], plain=True)
        err = max(_max_err(got, want), _max_err(got_z, want_z))
        max_err["analytic"] = max(max_err["analytic"], err)
        print(f"phase kernels analytic {quality} iters={root.iters} shape=(1, {T}) "
              f"max_abs_err={err:.3e} budget={BUDGET['analytic']:.0e}", flush=True)
        _check(err <= BUDGET["analytic"], f"B2 at B = 1, {quality}, within budget of plain")
    new_ptxas = _ptxas_kernels("", _build.library_path().with_suffix(".log"), SERVE_KERNELS)
    new_ptxas = {k: v for k, v in new_ptxas.items() if k.startswith(SERVE_NEW)}
    print("phase kernels ptxas fused_clipper " + " | ".join(
        f"{k}: {r} registers, {ss}/{sl} bytes spilled (stores/loads)"
        for k, (r, ss, sl) in new_ptxas.items()), flush=True)
    _check(len(new_ptxas) == 12 and all(ss == sl == 0 for _, ss, sl in new_ptxas.values()),
           f"no spills in B1's lane kernels and B2's paired kernels (8 + 4): {new_ptxas}")

    # --- serve: the main path, counted -------------------------------------
    fc.fused_clipper_neural.launches = fc.fused_clipper_neural.one_thread_launches = 0
    fc.fused_clipper_analytic.launches = 0
    served, wall_ms = {}, {}
    for name, serve in servers.items():
        t0 = time.perf_counter()
        z, outs = z0, []
        for blk in blocks:
            out, z = serve(blk, z)
            outs.append(out)
        torch.cuda.synchronize()
        wall_ms[name] = (time.perf_counter() - t0) * 1e3 / BLOCKS
        served[name] = (torch.cat(outs, dim=1), z)
    launches = {"neural": fc.fused_clipper_neural.launches,
                "analytic": fc.fused_clipper_analytic.launches}
    one_thread = fc.fused_clipper_neural.one_thread_launches
    for name, serve in servers.items():
        out, z = served[name]
        whole, whole_z = serve(signal, z0)
        torch.cuda.synchronize()
        carry_err = max(_max_err(out, whole), _max_err(z, whole_z))
        finite = bool(torch.isfinite(out).all() and torch.isfinite(z).all())
        print(f"phase serve {name} zoo={4 if name == 'neural' else 0} blocks={BLOCKS}x({B}, {T}) "
              f"launches={launches[name]}"
              + (f" one_thread_launches={one_thread} (K={fc.nxh_lanes(16, B)} lanes a stream)"
                 if name == "neural" else "")
              + f" finite={finite} shape={tuple(out.shape)} "
              f"wall_ms_per_block={wall_ms[name]:.4f} "
              f"carry_vs_one_run_max_abs={carry_err:.3e} budget=1e-06", flush=True)
        _check(launches[name] >= BLOCKS, f"{name} kernel launched on the main path")
        _check(finite and tuple(out.shape) == (B, BLOCKS * T), f"{name} output finite, shaped")
        _check(carry_err <= 1e-6, f"{name} blocks with carried state equal one run")
    _check(one_thread == 0, "the 2x16 is served by B1's lane kernel")

    # --- reference: kernels vs the circuit's sequential loop ----------------
    small = blocks[1][:256, :256].contiguous()
    for name, (ckt, params) in circuits.items():
        got, _ = servers[name](small, z0[:256])
        want, _ = ckt.process(params, ckt.init_state(dev), {"Vs": {"v": small.T}})
        err = _max_err(got, want.T)
        print(f"phase reference {name} shape=(256, 256) vs Circuit.process "
              f"max_abs_err={err:.3e} budget={BUDGET[name]:.0e}", flush=True)
        _check(err <= BUDGET[name], f"{name} kernel within budget of Circuit.process")

    # --- timing: each kernel and its plain version ----------------------------
    times = {}
    for name, serve in servers.items():
        def kernel():
            serve(blocks[0], z0)

        def plain():
            serve(blocks[0], z0, plain=True)

        runs = {"kernel": kernel, "plain": plain}
        for fn in runs.values():  # warm-up
            _cuda_ms(fn, 1, 2)
        ms = {label: [] for label in runs}
        for rep in range(REPS):  # in turns, alternating which goes first
            for label in (runs if rep % 2 else reversed(runs)):
                if label == "plain":
                    ms[label] += _cuda_ms(plain, 1)
                else:  # back-to-back launches keep the card busy
                    ms[label] += _cuda_ms(runs[label], 1, 10)
        times[name] = {label: statistics.median(v) for label, v in ms.items()}
        print(f"phase timing {name} shape=({B}, {T}) runs={REPS} in turns "
              + " ".join(f"{k}_ms={times[name][k]:.4f} [{min(v):.4f}, {max(v):.4f}] "
                         f"({B * T / times[name][k] / 1e3:.1f} Msamples/s)"
                         for k, v in ms.items())
              + f" (kernels: 10 launches per run) card={card!r}", flush=True)
    # B1's lanes per stream, the pretrained 2x16 at T = 2048
    for rows in (1, 2048, B):
        vin = blocks[0][:rows].contiguous()
        sweep = {}
        for lanes in (1,) + fc.nxh_lane_counts(16):
            fn = (lambda lanes=lanes: fc.launch_neural(vin, z0[:rows], mlp, R_SRC, CAP, fs=FS,
                                                       lanes=lanes))
            _cuda_ms(fn, 1, 2)
            sweep[lanes] = statistics.median(_cuda_ms(fn, REPS, 10))
        print(f"phase timing lanes B1 2x16 shape=({rows}, {T}) runs={REPS} "
              + " ".join(f"K={k}:{v:.4f}" for k, v in sweep.items())
              + f" ms (10 launches per run) fastest=K{min(sweep, key=sweep.get)} "
              f"chosen=K{fc.nxh_lanes(16, rows)} card={card!r}", flush=True)

    ops = {"neural": _neural_ops(16, 2) * B * T, "analytic": _analytic_ops(3) * B * T}
    nbytes = 8 * B * T + 8 * B  # vin in, out out; z0 in, z_final out
    forms = {"neural": f"neural_lanes_kernel<16,{fc.nxh_lanes(16, B)},2>",
             "analytic": "analytic_pair_kernel<3>"}
    return [{"name": f"fused_clipper_{name}", "route": "cuda", "source": SOURCE,
             "replaces": REPLACES[name], "launches": launches[name],
             "max_abs_err": max_err[name], "ms": times[name]["kernel"],
             "plain_ms": times[name]["plain"],
             **dict(zip(("bound_ms", "bound_by"), _bound(ops[name], nbytes))),
             "library_ms": None, "form": forms[name]}
            for name in ("neural", "analytic")]


#: the serving kernels of csrc/fused_clipper.cu, as the profiler names them
SERVE_KERNEL_NAMES = ("analytic_pair_kernel", "neural_lanes_kernel", "neural_kernel")
#: the ptxas entries of the serving kernels redesigned for the H100
SERVE_KERNELS = r"\d+((?:neural_lanes|analytic_pair)_kernel)"
SERVE_NEW = ("neural_lanes_kernel", "analytic_pair_kernel")


def _pretrained_2x16(dev):
    mlp, acts, _ = load_model_json(Path(__file__).resolve().parent
                                   / pretrained_model_path(2, 16), device=dev)
    return NeuralDiodeRoot.from_mlp("dp", mlp, acts)


def _scaled_err(x: torch.Tensor, y: torch.Tensor) -> float:
    return _max_err(x, y) / max(float(y.abs().max()), 1e-8)


def train_path(dev, card: str, seed: int) -> list:
    """In-circuit training: kernels, grad, train and timing phases.
    Returns the two training kernels' records for the JSON line."""
    root, frag = _pretrained_2x16(dev)
    mlp = frag["dp"]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = 2.0 * torch.randn(TRAIN_CHUNKS, CHUNK, generator=gen, device=dev)
    z0 = torch.zeros(TRAIN_CHUNKS, device=dev)
    r_train = torch.tensor([rk * 1e3 for rk in R_KOHMS if rk != 45.2], device=dev)
    r_rows = r_train[torch.arange(TRAIN_CHUNKS, device=dev) * len(r_train) // TRAIN_CHUNKS]
    shape = f"({TRAIN_CHUNKS}, {CHUNK})"
    fwd_args = (x, z0, mlp, r_rows, TRAIN_CAP)

    # --- kernels vs plain at the training shape -------------------------------
    got = got_fwd = fc.fused_clipper_neural_train_fwd(*fwd_args, fs=TRAIN_FS)
    want = fc.fused_clipper_neural_train_fwd_plain(*fwd_args, fs=TRAIN_FS)
    torch.cuda.synchronize()
    errs = [_max_err(g, w) for g, w in zip(got, want)]
    max_err = {"train_fwd": max(errs)}
    print(f"phase kernels train_fwd 2x16 pretrained shape={shape} "
          f"max_abs_err out={errs[0]:.3e} z_final={errs[1]:.3e} a_seq={errs[2]:.3e} "
          f"budget=2e-05", flush=True)
    _check(all(bool(torch.isfinite(g).all()) for g in got) and max(errs) <= 2e-5,
           "training forward kernel within 2e-5 of its plain version")
    a_seq = want[2]
    g_out = torch.randn(TRAIN_CHUNKS, CHUNK, generator=gen, device=dev) / (TRAIN_CHUNKS * CHUNK)
    g_zf = torch.randn(TRAIN_CHUNKS, generator=gen, device=dev) / TRAIN_CHUNKS
    adj_args = (a_seq, g_out, g_zf, r_rows, mlp, TRAIN_CAP)
    got = ct.clipper_adjoint(*adj_args, fs=TRAIN_FS)
    want = ct.clipper_adjoint_plain(*adj_args, fs=TRAIN_FS)
    torch.cuda.synchronize()
    scaled = [_scaled_err(g, w) for g, w in zip(got, want)]
    max_err["adjoint"] = max(_max_err(g, w) for g, w in zip(got, want))
    print(f"phase kernels adjoint 2x16 pretrained shape={shape} max_abs_err="
          f"{max_err['adjoint']:.3e} scaled g_vin={scaled[0]:.3e} G={scaled[1]:.3e} "
          f"g_z0={scaled[2]:.3e} budget=2e-05 (after dividing by scale)", flush=True)
    _check(all(bool(torch.isfinite(g).all()) for g in got) and max(scaled) <= 2e-5,
           "adjoint kernel within 2e-5 (scaled) of its plain version")
    # B3 on K lanes a stream against its one-thread form, bit for bit: the
    # wrapper's result above and B3 at each K it can take for H = 16
    old_fwd = fc.launch_train_fwd(*fwd_args, fs=TRAIN_FS, lanes=1)
    lanes_equal = {K: all(torch.equal(a, b) for a, b in zip(
        fc.launch_train_fwd(*fwd_args, fs=TRAIN_FS, lanes=K), old_fwd))
        for K in fc.nxh_lane_counts(16)}
    lanes_equal["wrapper"] = all(torch.equal(a, b) for a, b in zip(got_fwd, old_fwd))
    print(f"phase kernels train_fwd lanes vs one-thread kernel shape={shape} bits_equal "
          + " ".join(f"K={k}:{v}" for k, v in lanes_equal.items())
          + f" (wrapper K={fc.nxh_lanes(16, TRAIN_CHUNKS)})", flush=True)
    _check(all(lanes_equal.values()), "B3's lane form gives its one-thread form's bits")
    new_ptxas = _ptxas_kernels("", _build.library_path().with_suffix(".log"), CLIPPER_KERNELS)
    new_ptxas = {k: v for k, v in new_ptxas.items() if k.startswith(CLIPPER_NEW)}
    print("phase kernels ptxas clipper_train " + " | ".join(
        f"{k}: {r} registers, {ss}/{sl} bytes spilled (stores/loads)"
        for k, (r, ss, sl) in new_ptxas.items()), flush=True)
    _check(len(new_ptxas) == 12 and all(ss == sl == 0 for _, ss, sl in new_ptxas.values()),
           f"no spills in the lane form and the two passes (8 + 3 + 1 kernels): {new_ptxas}")
    param_record = _param_pass(dev, card, mlp, adj_args, got[1])

    # --- grad: the fused op against the scan engine ---------------------------
    ckt = make_training_clipper(root, TRAIN_FS, cap=TRAIN_CAP)
    fused = ct.make_fused_clipper_train(root.activations, TRAIN_CAP, TRAIN_FS)
    xg = x[:GRAD_B, :GRAD_T]
    rg = r_train[torch.arange(GRAD_B, device=dev) * len(r_train) // GRAD_B]
    zg = 0.1 * torch.randn(GRAD_B, generator=gen, device=dev)
    yg = torch.tanh(0.5 * xg)

    def scan(v, z, m):
        p = {k: {f: t.to(v.dtype) for f, t in d.items()}
             for k, d in ckt.init_params(dev).items() if k != "dp"}
        out, st = ckt.process({**p, "dp": m}, {"C": {"z": z}}, {"Vs": {"v": v.T}},
                              static_controls={"Vs": {"R": rg.to(v.dtype)}})
        return out.T, st["C"]["z"]

    def loss_and_grads(run, m, dtype=torch.float32):
        leaves = [t.detach().clone().to(dtype).requires_grad_(True) for t in ct.mlp_leaves(m)]
        v = xg.clone().to(dtype).requires_grad_(True)
        z = zg.clone().to(dtype).requires_grad_(True)
        out, zf = run(v, z, ct.mlp_tree(leaves))
        o, t = out[:, 50:], yg.to(dtype)[:, 50:]
        loss = mse(t, o) + esr(t, o) + 0.1 * torch.mean(zf ** 2)
        loss.backward()
        return loss.item(), [v.grad, z.grad] + [t.grad for t in leaves]

    def leaf_errs(got, want):
        return [_scaled_err(a.double(), b.double()) for a, b in zip(got, want)]

    # the JAX suite's configuration (tests/test_clipper_train.py): a seeded
    # random-init 2x16, held at its budgets
    random_mlp = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16).init_params(
        dev, torch.Generator().manual_seed(seed + 3))["dp"]
    lf, gf = loss_and_grads(lambda v, z, m: fused(v, z, m, rg), random_mlp)
    ls, gs = loss_and_grads(scan, random_mlp)
    loss_rel = abs(lf - ls) / abs(ls)
    grad_err = max(leaf_errs(gf, gs))
    print(f"phase grad random 2x16 fused vs scan engine shape=({GRAD_B}, {GRAD_T}) "
          f"loss={lf:.8g} scan_loss={ls:.8g} loss_rel={loss_rel:.3e} budget=1e-05 "
          f"grad_max_scaled_err={grad_err:.3e} budget=2e-05 leaves={len(gf)}", flush=True)
    _check(loss_rel <= 1e-5 and grad_err <= 2e-5, "fused gradients within budget of scan")
    # the pretrained 2x16, against an f64 run of the scan engine: per leaf
    # (vin, z0, then kernel and bias of each layer), scaled by the leaf's
    # largest |gradient|.  Here the f32 rounding of the dense layers and of
    # tanh, amplified by the head bias's cancelling sum over every (b, t),
    # puts even the f32 scan engine up to ~2e-4 of scale from f64, so each
    # leaf of the fused op is held to twice the scan engine's distance
    lf, gf = loss_and_grads(lambda v, z, m: fused(v, z, m, rg), mlp)
    ls, gs = loss_and_grads(scan, mlp)
    l64, g64 = loss_and_grads(scan, mlp, torch.float64)
    fused_64, scan_64 = leaf_errs(gf, g64), leaf_errs(gs, g64)
    print(f"phase grad pretrained 2x16 vs f64 scan shape=({GRAD_B}, {GRAD_T}) "
          f"loss_rel fused={abs(lf - l64) / abs(l64):.3e} scan={abs(ls - l64) / abs(l64):.3e} "
          f"fused_vs_f64={[float(f'{e:.2e}') for e in fused_64]} "
          f"scan_vs_f64={[float(f'{e:.2e}') for e in scan_64]} "
          f"fused_vs_scan={max(leaf_errs(gf, gs)):.3e} "
          f"budget: fused_vs_f64 <= 2 x scan_vs_f64, leaf by leaf", flush=True)
    _check(all(f <= 2 * s for f, s in zip(fused_64, scan_64)),
           "fused gradients of the pretrained net, leaf by leaf, as close to f64 as the "
           "f32 scan engine's")

    # --- train: the slice as a user drives it ---------------------------------
    with tempfile.TemporaryDirectory(prefix="diffwdf_smoke_") as tmp:
        t0 = time.perf_counter()
        make_synthetic_dataset_dir(tmp, TRAIN_DIODE, R_KOHMS, cap=TRAIN_CAP, fs=TRAIN_FS,
                                   duration_s=TRAIN_SECONDS, device=dev)
        synth_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        train, val, fs = load_diode_data(TRAIN_DIODE, tmp)
        tb = make_clipper_batches(train, CHUNK, drop_mixed_r=True, device=dev)
        vb = make_clipper_batches(val, CHUNK, drop_mixed_r=True, device=dev)
        load_s = time.perf_counter() - t0
        n_train, n_val = tb["x"].shape[0], vb["x"].shape[0]
        print(f"phase train setup diode={TRAIN_DIODE.name!r} synth_seconds={synth_s:.2f} "
              f"load_seconds={load_s:.2f} fs={fs} train_samples={len(train['x'])} val_samples={len(val['x'])} "
              f"train_chunks={n_train} val_chunks={n_val} (expect {TRAIN_CHUNKS}, "
              f"{VAL_CHUNKS})", flush=True)
        _check((n_train, n_val) == (TRAIN_CHUNKS, VAL_CHUNKS) and fs == TRAIN_FS
               and "r0" in tb and "r0" in vb, "full-size data set, every chunk hoisted")

        circuit = make_training_clipper(root, fs, cap=TRAIN_CAP)
        params = {**circuit.init_params(dev), **frag}
        cfg = CircuitTrainConfig(epochs=EPOCHS, batch_size=CHUNK, engine="fused", log_every=1)
        logger = MetricsLogger(os.path.join(tmp, "train_clipper.jsonl"))

        epoch_ends = []

        def on_epoch(epoch, p, hist):
            epoch_ends.append(time.perf_counter())
            logger.log(epoch, samples=n_train * CHUNK, **{k: v[-1] for k, v in hist.items() if v})

        counters = (fc.fused_clipper_neural_train_fwd, ct.clipper_adjoint,
                    fc.fused_clipper_neural, fc.fused_clipper_analytic, ct.mlp_param_vjp)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        trained, hist = train_clipper(circuit, params, tb, vb, cfg,
                                      trainable_filter=lambda p: p["dp"], on_epoch=on_epoch)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"train_fwd": counters[0].launches, "adjoint": counters[1].launches,
                    "param_vjp": counters[4].launches}
        logger.close()
        epoch_ms = [(b - a) * 1e3 for a, b in zip([t0] + epoch_ends, epoch_ends)]
        losses = hist["loss"] + hist["val_loss"]
        print(f"phase train engine=fused epochs={EPOCHS} chunks={n_train}x{CHUNK} "
              f"seconds={train_s:.3f} epoch_wall_ms={[round(v, 1) for v in epoch_ms]} "
              f"loss={[round(v, 8) for v in hist['loss']]} "
              f"val_loss={[round(v, 8) for v in hist['val_loss']]} "
              f"launches train_fwd={launches['train_fwd']} adjoint={launches['adjoint']} "
              f"param_vjp={launches['param_vjp']} "
              f"serve_kernels={counters[2].launches + counters[3].launches}", flush=True)
        _check(bool(torch.isfinite(torch.tensor(losses)).all()), "every loss finite")
        _check(hist["loss"][-1] < hist["loss"][0], "train loss falls")
        _check(launches["train_fwd"] >= 2 * EPOCHS
               and launches["adjoint"] == launches["param_vjp"] == EPOCHS,
               "training kernels launched on the main path (train + validation)")

        # the trained root back to serving: JSON out and in, then kernel B1
        path = os.path.join(tmp, "circuit_trained.json")
        save_model_json(trained["dp"], root.activations, path)
        served_mlp, acts, _ = load_model_json(path, device=dev)
        _check(acts == root.activations and all(torch.equal(a, b) for a, b in zip(
            ct.mlp_leaves(served_mlp), ct.mlp_leaves(trained["dp"]))),
            "trained root survives its JSON round trip")
        vin = 2.0 * torch.randn(B, T, generator=gen, device=dev)
        out, zf = fc.fused_clipper_neural(vin, torch.zeros(B, device=dev), served_mlp,
                                          float(params["Vs"]["R"]), TRAIN_CAP, fs=TRAIN_FS)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(zf).all())
        print(f"phase train serve_trained shape={tuple(out.shape)} finite={finite}", flush=True)
        _check(finite and tuple(out.shape) == (B, T), "trained root serves a finite block")

    # --- timing ----------------------------------------------------------------
    samples = TRAIN_CHUNKS * CHUNK
    plain_ms = {name: _timed(fn)[0] for name, fn in (
        ("train_fwd", lambda: fc.fused_clipper_neural_train_fwd_plain(*fwd_args, fs=TRAIN_FS)),
        ("adjoint", lambda: ct.clipper_adjoint_plain(*adj_args, fs=TRAIN_FS)))}
    # the kernels alone, 10 calls back to back a run: the wrappers (B3 on K
    # lanes, B4's two passes) and B4's passes as launch-only calls on a
    # scratch allocated once
    pass1, pass2, scratch_bytes = _clipper_adjoint_passes(*adj_args[:5])
    kernel_ms = {}
    for label, fn in (
        ("B3", lambda: fc.fused_clipper_neural_train_fwd(*fwd_args, fs=TRAIN_FS)),
        ("B4", lambda: ct.clipper_adjoint(*adj_args, fs=TRAIN_FS)),
        ("B4 pass 1", pass1),
        ("B4 pass 2", pass2),
    ):
        _cuda_ms(fn, 1, 2)
        k = _cuda_ms(fn, REPS, 10)
        kernel_ms[label] = statistics.median(k)
        print(f"phase timing kernel {label} 2x16 shape={shape} runs={REPS} "
              f"kernel_ms={kernel_ms[label]:.4f} [{min(k):.4f}, {max(k):.4f}] "
              f"({samples / kernel_ms[label] / 1e3:.1f} Msamples/s; 10 calls per run) "
              f"card={card!r}", flush=True)
    print(f"phase timing scratch B4 bytes={scratch_bytes} shape={shape} (the pair (m, go) of "
          f"every sample, groups of {ct.ADJOINT_GROUP} streams)", flush=True)
    # B3's lanes per stream at the training and the validation batch
    for rows in (TRAIN_CHUNKS, VAL_CHUNKS):
        args = (x[:rows], z0[:rows], mlp, r_rows[:rows], TRAIN_CAP)
        sweep = {}
        for lanes in (1,) + fc.nxh_lane_counts(16):
            fn = (lambda lanes=lanes: fc.launch_train_fwd(*args, fs=TRAIN_FS, lanes=lanes))
            _cuda_ms(fn, 1, 2)
            sweep[lanes] = statistics.median(_cuda_ms(fn, REPS, 10))
        print(f"phase timing lanes B3 2x16 shape=({rows}, {CHUNK}) runs={REPS} "
              + " ".join(f"K={k}:{v:.4f}" for k, v in sweep.items())
              + f" ms fastest=K{min(sweep, key=sweep.get)} chosen=K{fc.nxh_lanes(16, rows)} "
              f"card={card!r}", flush=True)

    # one fused training step of the trained params, part by part, on the
    # real batches
    cfg = CircuitTrainConfig(batch_size=CHUNK, engine="fused")
    make_optimizer, train_step, _ = make_train_step(circuit, cfg, lambda p: p["dp"])
    opt = make_optimizer(trained)
    leaves, acts = ct.mlp_leaves(trained["dp"]), root.activations
    xs, r0, ys = tb["x"], tb["r0"], tb["y"]
    zs = torch.zeros(xs.shape[0], device=dev)
    state = {}

    def part_forward():
        state["fwd"] = fc.fused_clipper_neural_train_fwd(xs, zs, trained["dp"], r0, TRAIN_CAP,
                                                         fs=TRAIN_FS)

    def part_loss():
        o = state["fwd"][0].detach().requires_grad_(True)
        t, oo = ys[:, cfg.skip_samples:], o[:, cfg.skip_samples:]
        state["g_out"], = torch.autograd.grad(mse(t, oo) + esr(t, oo), o)

    def part_adjoint():
        state["adj"] = ct.clipper_adjoint(state["fwd"][2], state["g_out"], zs, r0, trained["dp"],
                                          TRAIN_CAP, fs=TRAIN_FS)

    def part_vjp():
        _, log_r = fc.row_constants(r0, TRAIN_CAP, TRAIN_FS)
        state["grads"] = ct.mlp_param_vjp(trained["dp"], acts, state["fwd"][2], log_r,
                                          state["adj"][1])

    def part_adam():
        for t, g in zip(leaves, state["grads"]):
            t.grad = g
        opt.step()

    def step_parts():
        parts = {}
        for name, fn in (("forward_kernel", part_forward), ("loss", part_loss),
                         ("adjoint_kernel", part_adjoint), ("param_vjp", part_vjp),
                         ("adam", part_adam)):
            parts[name] = _timed(fn)[0]
        return parts, _timed(lambda: train_step(trained, opt, tb))

    parts, step = step_parts()
    print(f"phase timing train_step shape={shape} runs={REPS} "
          f"step_ms={step[0]:.4f} [{step[1]:.4f}, {step[2]:.4f}] "
          f"({samples / step[0] / 1e3:.3f} Msamples/s) "
          + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items())
          + f" parts_sum_ms={sum(parts.values()):.4f} card={card!r}", flush=True)

    wrappers = {"train_fwd": "fused_clipper_neural_train_fwd", "adjoint": "clipper_adjoint"}
    ops = {"train_fwd": _neural_ops(16, 2) * samples, "adjoint": _adjoint_ops(16, 2) * samples}
    # train_fwd: vin in, out and a_seq out (z0, r in, z_final out per row);
    # adjoint: a_seq and g_out in, g_vin and G out (g_zf, r in, g_z0 out),
    # and the scratch between its passes written once and read once
    nbytes = {"train_fwd": 12 * samples + 12 * TRAIN_CHUNKS,
              "adjoint": 16 * samples + 12 * TRAIN_CHUNKS + 2 * scratch_bytes}
    bounds = {name: _bound(ops[name], nbytes[name]) for name in ("train_fwd", "adjoint")}
    for name, label in (("train_fwd", "B3"), ("adjoint", "B4")):
        print(f"phase timing bound {label} kernel_ms={kernel_ms[label]:.4f} "
              f"bound_ms={bounds[name][0]:.6f} ({bounds[name][1]}) "
              f"share={bounds[name][0] / kernel_ms[label]:.4f} plain_ms={plain_ms[name]:.4f} "
              f"launches_on_main_path={launches[name]} card={card!r}", flush=True)
    return [{"name": wrappers[name], "route": "cuda", "source": TRAIN_SOURCE,
             "replaces": TRAIN_REPLACES[name], "launches": launches[name],
             "max_abs_err": max_err[name], "ms": kernel_ms[label], "plain_ms": plain_ms[name],
             **dict(zip(("bound_ms", "bound_by"), bounds[name])), "library_ms": None}
            for name, label in (("train_fwd", "B3"), ("adjoint", "B4"))] + [
        {**param_record, "launches": launches["param_vjp"]}]


#: operations a sample of the MLP parameters' cotangents, 2x16: the forward at
#: a and its backward (wdfbench/work/clipper_2x16.json, torch stage param_vjp)
PARAM_OPS = 3521
#: the shapes pass 3 is timed at: the paper's training set and the benchmark's
PARAM_SHAPES = ((TRAIN_CHUNKS, CHUNK), (8192, CHUNK))


def _param_pass(dev, card: str, mlp, adj_args, G) -> dict:
    """B4's pass 3 (``mlp_param_vjp`` on the card) at the training shape:
    against autograd of the plain MLP (every leaf within 1e-4 of its largest
    magnitude), the same bits on two calls, no spills; then timed beside its
    bound and the plain path at PARAM_SHAPES (CUDA-event medians, 10 calls
    a run for the kernel).  Returns its record for the JSON line."""
    a_seq, _, _, r_rows, _, _ = adj_args
    acts = ("tanh",) * 3 + ("",)
    _, log_r = fc.row_constants(r_rows, TRAIN_CAP, TRAIN_FS)
    got = ct.mlp_param_vjp(mlp, acts, a_seq, log_r, G)
    again = ct.mlp_param_vjp(mlp, acts, a_seq, log_r, G)
    want = ct.mlp_param_vjp_plain(mlp, acts, a_seq, log_r, G)
    torch.cuda.synchronize()
    scaled = [_scaled_err(g, w) for g, w in zip(got, want)]
    same = all(torch.equal(g, h) for g, h in zip(got, again))
    print(f"phase kernels param_vjp 2x16 pretrained shape={tuple(a_seq.shape)} scaled_err="
          f"{[float(f'{e:.2e}') for e in scaled]} budget=1e-04 same_bits_twice={same}",
          flush=True)
    _check(max(scaled) <= 1e-4 and same, "pass 3 within 1e-4 (scaled) of plain, the same bits")
    ptxas = _ptxas_kernels("", _build.library_path().with_suffix(".log"),
                           r"\d+(param_\w+?_kernel)")
    ptxas = {k: v for k, v in ptxas.items() if k.startswith("param_")}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("phase kernels ptxas param_vjp " + " | ".join(
        f"{k}: {r} registers, {ss}/{sl} bytes spilled" for k, (r, ss, sl) in ptxas.items())
        + f" | 2x16: {ct._param_ctas(dev.index or 0, 16, 2) // sms} blocks an SM", flush=True)
    _check(len(ptxas) == 4 and all(ss == sl == 0 for _, ss, sl in ptxas.values()),
           f"no spills in pass 3 (3 widths + the sum): {ptxas}")
    times = {}
    for b, t in PARAM_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(b)
        a = 2.0 * torch.rand(b, t, generator=gen, device=dev) - 1.0
        g = torch.randn(b, t, generator=gen, device=dev) / (b * t)
        lr = log_r[torch.arange(b, device=dev) % len(log_r)]
        args = (mlp, acts, a, lr, g)
        kern = lambda: ct.mlp_param_vjp(*args)
        _cuda_ms(kern, 1, 2)
        k = _cuda_ms(kern, REPS, 10)
        plain = _timed(lambda: ct.mlp_param_vjp_plain(*args))[0]
        bound = _bound(PARAM_OPS * b * t, 8 * b * t + 4 * b)
        times[b] = (statistics.median(k), plain, bound)
        print(f"phase timing param_vjp 2x16 shape=({b}, {t}) runs={REPS} "
              f"kernel_ms={statistics.median(k):.4f} [{min(k):.4f}, {max(k):.4f}] "
              f"plain_ms={plain:.4f} bound_ms={bound[0]:.6f} ({bound[1]}) "
              f"share={bound[0] / statistics.median(k):.4f} card={card!r}", flush=True)
    ms, plain, bound = times[TRAIN_CHUNKS]
    return {"name": "mlp_param_vjp", "route": "cuda", "source": TRAIN_SOURCE,
            "replaces": "none (the JAX package leaves it to XLA: "
                        "diffwdf_tpu/ops/clipper_train.py:272-282)",
            "max_abs_err": max(_max_err(g, w) for g, w in zip(got, want)), "ms": ms,
            "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


#: the ptxas entries of the clipper's redesigned training kernels
CLIPPER_KERNELS = r"\d+((?:train_fwd_lanes|adjoint_tangent|adjoint_recursion)_kernel)"
CLIPPER_NEW = ("train_fwd_lanes_kernel", "adjoint_tangent_kernel", "adjoint_recursion_kernel")


def _clipper_adjoint_passes(a_seq, g_out, g_zf, r_rows, mlp):
    """(pass 1, pass 2, scratch bytes): launch-only calls of B4's two
    kernels on a scratch allocated once, so that each is timed alone."""
    lib = _build.library()
    H, L, w = fc.train_weights(mlp, a_seq.device)
    B, T = a_seq.shape
    p1r, log_r = fc.row_constants(r_rows, TRAIN_CAP, TRAIN_FS)
    scratch = torch.empty(ct.adjoint_scratch_floats(B, T), device=a_seq.device)
    g_vin, G, g_z0 = torch.empty_like(a_seq), torch.empty_like(a_seq), torch.empty_like(g_zf)

    def pass1():
        _build.check(lib.clipper_tangent_launch(
            a_seq.data_ptr(), g_out.data_ptr(), log_r.data_ptr(), scratch.data_ptr(), B, T,
            w.data_ptr(), H, L, torch.cuda.current_stream().cuda_stream), "B4 pass 1")

    def pass2():
        _build.check(lib.clipper_recursion_launch(
            scratch.data_ptr(), g_zf.data_ptr(), p1r.data_ptr(), g_vin.data_ptr(), G.data_ptr(),
            g_z0.data_ptr(), B, T, torch.cuda.current_stream().cuda_stream), "B4 pass 2")

    return pass1, pass2, 4 * scratch.numel()


def _strum(seed: int, n: int) -> np.ndarray:
    """(2, n) test audio at FS: two strums of a six-string chord (decaying
    harmonics, strings alternating between the channels, seeded onsets and
    phases) plus a little noise, peak 0.5."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    y = np.zeros((2, n))
    for strum in (0.0, 0.5):
        for i, f0 in enumerate((82.41, 110.0, 146.83, 196.0, 246.94, 329.63)):
            on = strum + 0.012 * i + 0.004 * rng.random()
            tt = np.clip(t - on, 0.0, None)
            env = (t >= on) * np.exp(-tt / 0.4)
            for h in range(1, 9):
                y[i % 2] += env * np.sin(2 * np.pi * f0 * h * tt + 2 * np.pi * rng.random()) / h
    y += 0.01 * rng.standard_normal(y.shape)
    return (0.5 * y / np.abs(y).max()).astype(np.float32)


def _segment(i: int):
    """(model, gain dB, cutoff Hz) of stream block i."""
    return next(s for s in reversed(STREAM_SCHEDULE) if s[0] <= i)[1:]


def _launch_counts() -> dict:
    """Launch counters of the kernels that serve a single-stream block."""
    return {"B5": pd.fused_deer_clipper.launches, "B2": fc.fused_clipper_analytic.launches,
            "B1": fc.fused_clipper_neural.launches}


def _launches_of(fn) -> dict:
    """Call fn(); the kernel launches it made, by kernel."""
    before = _launch_counts()
    fn()
    return {k: v - before[k] for k, v in _launch_counts().items()}


#: the kernels that serve a block, in a profiler trace (B1, B2, B5, B7, B9)
SERVED_KERNEL_NAMES = (DEER_KERNEL_NAMES + SERVE_KERNEL_NAMES
                       + ("circuit_kernel", "circuit_lanes_kernel"))


def _profiled_blocks(serve, blocks: int = 10, tries: int = 3):
    """A profiler trace of ``blocks`` calls of serve, taken again (up to
    ``tries`` times) until it holds one event of SERVED_KERNEL_NAMES for
    each launch the wrappers counted, so that a device busy share read from
    it leaves no kernel out.  The card is synchronised before the trace
    starts and before it ends: a kernel still running when it ends is not
    in it (the last block's, where a block ends without a host read), and
    with earlier blocks' work still queued at its start one launch of the
    traced blocks went missing.  (prof, "kernels_traced=a/b
    trace_complete=...")."""
    for _ in range(tries):
        before = sum(_all_launches().values())
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(blocks):
                serve()
            torch.cuda.synchronize()
        launched = sum(_all_launches().values()) - before
        traced = sum(1 for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and any(k in ev.name for k in SERVED_KERNEL_NAMES))
        if traced == launched:
            break
    return prof, f"kernels_traced={traced}/{launched} trace_complete={traced == launched}"


def _deer_case(vin, r_src, fs, sweeps, iters, relax=2):
    """The DEER kernel on vin against its plain version and against the
    exact recursion (the analytic kernel at B=1, same constants)."""
    d = diode_1n4148_1u1d
    args = (r_src, 2.2e-9, d.Is, d.Vt * d.nabla, d.N_up, d.N_down)
    kw = dict(fs=fs, sweeps=sweeps, relax_passes=relax, quality_iters=iters)
    out, zf, res = pd.fused_deer_clipper(vin, *args, **kw)
    p_out, p_zf, p_res = pd.fused_deer_clipper_plain(vin, *args, **kw)
    e_out, e_zf = fc.fused_clipper_analytic(vin[None], torch.zeros(1, device=vin.device), *args,
                                            fs=fs, quality_iters=iters)
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(out).all()) and out.shape == vin.shape, "DEER output finite, shaped")
    return {"plain": max(_max_err(out, p_out), _max_err(zf, p_zf)),
            "exact": max(_max_err(out, e_out[0]), _max_err(zf, e_zf[0])),
            "plain_exact": max(_max_err(p_out, e_out[0]), _max_err(p_zf, e_zf[0])),
            "res": float(res), "plain_res": float(p_res)}


def stream_path(dev, card: str, seed: int) -> list:
    """Single-stream serving: kernels deer, stream, warmup and timing deer
    phases.  Returns the DEER kernel's record for the JSON line."""
    gen = torch.Generator(device=dev).manual_seed(seed + 5)

    # --- kernels deer: B5 against plain and the exact recursion ---------------
    plain_errs = []
    for T in DEER_T:
        vin = 2.0 * torch.randn(T, generator=gen, device=dev)
        for name, (sweeps, iters) in DEER_CFG.items():
            e = _deer_case(vin, 47e3, FS, sweeps, iters)
            plain_errs.append(e["plain"])
            converged = name == "toms" or T > 2048
            print(f"phase kernels deer {name} sweeps={sweeps} iters={iters} T={T} "
                  f"vs_plain={e['plain']:.3e} budget=1e-06 vs_exact={e['exact']:.3e} "
                  + (f"budget={DEER_BUDGET[name]:.0e}" if converged else
                     f"plain_vs_exact={e['plain_exact']:.3e} (4 sweeps at L=2 leave the "
                     f"DEER algorithm unconverged: the kernel must reproduce the plain "
                     f"version's distance, within 1e-06)")
                  + f" residual={e['res']:.3e} plain_residual={e['plain_res']:.3e}", flush=True)
            _check(e["plain"] <= 1e-6, f"DEER kernel {name} T={T} within 1e-6 of its plain version")
            _check(e["exact"] <= DEER_BUDGET[name] if converged
                   else abs(e["exact"] - e["plain_exact"]) <= 1e-6,
                   f"DEER kernel {name} T={T} against the exact recursion")
    # approx at the JAX suite's own operating point for its 5e-6 budget
    # (tests/test_deer_circuit.py:200: 48 kHz, cutoff 4 kHz, amplitude 1.5)
    vin = 1.5 * torch.randn(2048, generator=gen, device=dev)
    e = _deer_case(vin, cutoff_to_resistance(4000.0, 2.2e-9), 48000.0, *DEER_CFG["approx"])
    plain_errs.append(e["plain"])
    print(f"phase kernels deer approx fs=48000 cutoff=4000 amplitude=1.5 T=2048 "
          f"vs_plain={e['plain']:.3e} budget=1e-06 vs_exact={e['exact']:.3e} budget=5e-06 "
          f"residual={e['res']:.3e}", flush=True)
    _check(e["plain"] <= 1e-6 and e["exact"] <= 5e-6, "DEER approx at the JAX suite's point")
    vin = 10.0 * torch.randn(16384, generator=gen, device=dev)
    e = _deer_case(vin, 47e3, FS, 8, 3, relax=4)
    print(f"phase kernels deer hard_overdrive amplitude=10 relax_passes=4 T=16384 "
          f"vs_plain={e['plain']:.3e} vs_exact={e['exact']:.3e} budget=2e-06 "
          f"residual={e['res']:.3e}", flush=True)
    _check(e["plain"] <= 2e-6 and e["exact"] <= 2e-6, "DEER hard overdrive within 2e-6")
    vin = 2.0 * torch.randn(2048, generator=gen, device=dev)
    e = _deer_case(vin, 180.0, FS, 8, 3)
    print(f"phase kernels deer r_source=180 T=2048 residual={e['res']:.3e} (must exceed 1e-02) "
          f"plain_residual={e['plain_res']:.3e} vs_exact={e['exact']:.3e}", flush=True)
    _check(e["res"] > 1e-2, "the residual certificate flags R = 180 Ohm")
    cluster_ptxas = {k: v for k, v in _ptxas_kernels(
        "", _build.library_path().with_suffix(".log"),
        r"\d+(deer_clipper_cluster_kernel)").items() if k.startswith("deer_clipper")}
    print("phase kernels ptxas deer " + " | ".join(
        f"{k}: {r} registers, {ss}/{sl} bytes spilled (stores/loads)"
        for k, (r, ss, sl) in cluster_ptxas.items()), flush=True)
    _check(len(cluster_ptxas) == 1 and all(ss == sl == 0 for _, ss, sl in cluster_ptxas.values()),
           f"no spills in B5's cluster kernel (16 CTAs): {cluster_ptxas}")

    # --- stream: the main path, counted ----------------------------------------
    n = STREAM_BLOCKS * STREAM_BLOCK
    audio = np.zeros((2, n), np.float32)
    audio[:, :int(FS)] = _strum(seed, int(FS))
    blocks = [audio[:, i * STREAM_BLOCK:(i + 1) * STREAM_BLOCK] for i in range(STREAM_BLOCKS)]
    deer = make_clipper_processor(FS, models=("toms", "approx"), engine="deer", device=dev)
    scan = make_clipper_processor(FS, engine="scan", device=dev)
    pd.fused_deer_clipper.launches = 0
    fc.fused_clipper_analytic.launches = fc.fused_clipper_neural.launches = 0
    one = {"deer": {"B5": 1, "B2": 0, "B1": 0}, "scan": {"B5": 0, "B2": 1, "B1": 0}}
    errs, residuals, wrong_launches, outs = [], [], [], {}
    t0 = time.perf_counter()
    for i, blk in enumerate(blocks):
        model, gain_db, cutoff = _segment(i)
        for name, proc in (("deer", deer), ("scan", scan)):
            got = _launches_of(lambda: outs.__setitem__(name, proc.process_block(
                blk, "clipper", model=model, gain_db=gain_db, cutoff_hz=cutoff)))
            if got != one[name]:
                wrong_launches.append((i, name, got))
        errs.append(float(np.abs(outs["deer"] - outs["scan"]).max()))
        residuals.append(deer.last_residual[model])
        _check(outs["deer"].shape == (2, STREAM_BLOCK) and np.isfinite(outs["deer"]).all()
               and np.array_equal(outs["deer"][0], outs["deer"][1]),
               "served block finite, stereo, fanned out from mono")
    stream_s = time.perf_counter() - t0
    seg_err = {f"{m}/{g:g}dB/{c:g}Hz": max(errs[s:(STREAM_SCHEDULE[k + 1][0] if k + 1 <
                                                 len(STREAM_SCHEDULE) else STREAM_BLOCKS)])
               for k, (s, m, g, c) in enumerate(STREAM_SCHEDULE)}
    print(f"phase stream deer+scan blocks={STREAM_BLOCKS}x{STREAM_BLOCK} stereo fs={FS:g} "
          f"seconds={stream_s:.3f} deer_vs_scan max_abs_err={max(errs):.3e} budget=5e-06 "
          f"by_segment={ {k: float(f'{v:.3e}') for k, v in seg_err.items()} } "
          f"max_residual={max(residuals):.3e} launches={_launch_counts()} "
          f"wrong_launch_blocks={wrong_launches}", flush=True)
    _check(max(errs) <= 5e-6, "deer engine serves the scan engine's output, block for block")
    _check(not wrong_launches, "every served block is exactly one kernel launch")
    _check(deer.fallbacks == {}, "no fallback on the audio stream")

    # the cutoff that maps to 180 Ohm: the residual flags the block and the
    # exact engine serves it, from the same state as the scan processor's
    deer.reset()
    scan.reset()
    noise = np.random.default_rng(seed + 21).standard_normal(STREAM_BLOCK).astype(np.float32) * 2
    fb = {}
    fb_launch = {name: _launches_of(lambda name=name, proc=proc: fb.__setitem__(
        name, proc.process_block(noise, "clipper", model="toms", cutoff_hz=BAD_CUTOFF)))
        for name, proc in (("deer", deer), ("scan", scan))}
    fb_err = float(np.abs(fb["deer"] - fb["scan"]).max())
    print(f"phase stream fallback cutoff={BAD_CUTOFF:.1f}Hz r_source="
          f"{cutoff_to_resistance(BAD_CUTOFF, 2.2e-9):.1f} residual="
          f"{deer.last_residual['toms']:.3e} fallback_tol={deer.fallback_tol:g} "
          f"fallbacks={deer.fallbacks} served_vs_scan={fb_err:.3e} budget=1e-06 "
          f"launches={fb_launch}", flush=True)
    _check(deer.fallbacks == {"toms": 1, "clipper": 1}
           and deer.last_residual["toms"] > deer.fallback_tol and fb_err <= 1e-6
           and fb_launch == {"deer": {"B5": 1, "B2": 1, "B1": 0}, "scan": one["scan"]},
           "residual-triggered fallback serves the exact block")
    odd = blocks[3][:, :1000]
    odd_launch = {name: _launches_of(lambda name=name, proc=proc: fb.__setitem__(
        name, proc.process_block(odd, "clipper", model="approx", gain_db=3.0)))
        for name, proc in (("deer", deer), ("scan", scan))}
    odd_err = float(np.abs(fb["deer"] - fb["scan"]).max())
    print(f"phase stream odd_block T=1000 residual={deer.last_residual['approx']} "
          f"served_vs_scan={odd_err:.3e} budget=1e-06 launches={odd_launch}", flush=True)
    _check(deer.last_residual["approx"] == 0.0 and odd_err <= 1e-6
           and odd_launch == {"deer": one["scan"], "scan": one["scan"]},
           "a 1000-sample block is served by the exact engine")

    # the scan group with its neural member, hot-swapped, against the same
    # processor on the CPU (the kernels' plain versions)
    on_card, on_host = (make_clipper_processor(FS, engine="scan", device=d) for d in (dev, "cpu"))
    swaps = ("toms", "toms", "neural_2x16", "neural_2x16", "neural_2x16", "neural_2x16",
             "approx", "approx")
    n_err, n_launch = [], {"B5": 0, "B2": 0, "B1": 0}
    for i, model in enumerate(swaps):
        kw = dict(model=model, gain_db=6.0, cutoff_hz=4000.0)
        got = _launches_of(lambda: fb.__setitem__("card", on_card.process_block(
            blocks[i], "clipper", **kw)))
        n_launch = {k: n_launch[k] + v for k, v in got.items()}
        _check(sum(got.values()) == 1 and got["B1" if model.startswith("neural") else "B2"] == 1,
               f"one kernel launch serves {model}")
        n_err.append(float(np.abs(fb["card"] - on_host.process_block(
            blocks[i], "clipper", **kw)).max()))
    print(f"phase stream scan_group card_vs_cpu models={swaps} max_abs_err={max(n_err):.3e} "
          f"budget=2e-05 launches={n_launch}", flush=True)
    _check(max(n_err) <= 2e-5, "the card's scan group serves what the CPU's does")
    launches = _launch_counts()  # the main path's count
    print(f"phase stream launches={launches}", flush=True)
    _check(all(v > 0 for v in launches.values()), "every serving kernel launched on the path")

    # --- warmup: cold first block, warmed first block, steady ------------------
    x0 = blocks[1]
    for engine, models in (("deer", ("toms", "approx")),
                           ("scan", ("toms", "approx", "neural_2x16"))):
        def serve(proc):
            t0 = time.perf_counter()
            proc.process_block(x0, "clipper", cutoff_hz=4000.0)
            return (time.perf_counter() - t0) * 1e3

        cold = serve(make_clipper_processor(FS, models=models, engine=engine, device=dev))
        warm = make_clipper_processor(FS, models=models, engine=engine, device=dev)
        info = warm.warmup([STREAM_BLOCK])
        first = serve(warm)
        steady = [serve(warm) for _ in range(WALL_REPS)]
        variants = 2 if engine == "deer" else 1  # the exact fallback variant
        print(f"phase warmup engine={engine} models={models} block={STREAM_BLOCK} "
              f"cold_first_ms={cold:.3f} warmup_seconds={info['seconds']:.3f} "
              f"n_compiled={info['n_compiled']} warmed_first_ms={first:.3f} "
              f"steady_median_ms={statistics.median(steady):.3f} "
              f"[{min(steady):.3f}, {max(steady):.3f}] card={card!r}", flush=True)
        _check(info["n_compiled"] == len(models) * variants * 2, "warmup ran every variant")

    # --- timing deer --------------------------------------------------------
    d = diode_1n4148_1u1d
    args = (47e3, 2.2e-9, d.Is, d.Vt * d.nabla, d.N_up, d.N_down)
    mlp = scan.circuits["neural_2x16"][1]["dp"]
    z1 = torch.zeros(1, device=dev)
    times = {}
    clusters = pd.max_active_clusters()
    for T in DEER_T:
        vin = 2.0 * torch.randn(T, generator=gen, device=dev)

        def wrapper():
            pd.fused_deer_clipper(vin, *args, fs=FS)

        def launch(sweeps=8, relax=2):
            """B5's launch alone, on outputs allocated once."""
            out, zf, res, s0 = (torch.empty_like(vin), *(torch.zeros((), device=dev)
                                                          for _ in range(3)))
            consts = pd._analytic_constants(*args[:2], FS, *args[2:])
            return lambda: pd.launch(vin, s0, out, zf, res, T // 1024, consts, sweeps, relax, 3)

        label = f"C{pd.CLUSTER}"
        forms = _forms_in_turns({label: wrapper}, {label: launch()})
        parts = _breakdown(launch, DEER_CFG["toms"][0], 2)
        p = _timed(lambda: pd.fused_deer_clipper_plain(vin, *args, fs=FS))
        times[T] = (forms[label][3], p[0])
        bound = _bound(_deer_ops(T, DEER_CFG["toms"][0], 2, DEER_CFG["toms"][1]), 8 * T + 12)
        print(f"phase timing deer T={T} runs={REPS} (10 wrapper calls per run; "
              f"device: launches back to back) {_forms_line(forms)} plain_ms={p[0]:.4f} "
              f"[{p[1]:.4f}, {p[2]:.4f}] bound_ms={bound[0]:.7f} ({bound[1]}) "
              f"max_active_clusters={clusters} card={card!r}", flush=True)
        print(f"phase timing deer T={T} breakdown {label} (device, toms) {parts} "
              f"card={card!r}", flush=True)
        # the exact engine's kernels at B = 1, in turns, 10 launches a run,
        # with the SM clock sampled meanwhile
        exact = {"B2": lambda: fc.fused_clipper_analytic(vin[None], z1, *args, fs=FS),
                 "B1": lambda: fc.fused_clipper_neural(vin[None], z1, mlp, 47e3, 2.2e-9, fs=FS)}
        ms = {name: [] for name in exact}
        for fn in exact.values():  # warm-up
            _cuda_ms(fn, 1, 2)
        with _sm_clock() as mhz:
            for _ in range(REPS):
                for name, fn in exact.items():
                    ms[name] += _cuda_ms(fn, 1, 10)
        clock = statistics.median(mhz) if mhz else float("nan")
        for name, v in ms.items():
            print(f"phase timing deer exact_engine {name}"
                  f"{' 2x16' if name == 'B1' else ' best'} B=1 T={T} runs={REPS} "
                  f"ms={statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}] "
                  f"({statistics.median(v) * clock * 1e3 / T:.0f} cycles/sample) "
                  f"(10 launches per run) sm_clock_mhz={clock:g} ({len(mhz)} samples) "
                  f"card={card!r}", flush=True)
    block_audio_ms = STREAM_BLOCK / FS * 1e3
    for engine, proc, model in (("deer", deer, "toms"), ("deer", deer, "approx"),
                                ("scan", scan, "toms"), ("scan", scan, "neural_2x16")):
        def serve():
            proc.process_block(x0, "clipper", model=model, cutoff_hz=4000.0)

        serve()
        wall = _wall_ms(serve)
        ms = statistics.median(wall)
        prof, traced = _profiled_blocks(serve)
        dev_events = [ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA]
        ours = [ev for ev in dev_events if any(k in ev.name for k in SERVED_KERNEL_NAMES)]
        copies = [ev for ev in dev_events if "Memcpy" in ev.name or "Memset" in ev.name]
        dev_us = sum(ev.time_range.elapsed_us() for ev in dev_events) / 10
        print(f"phase timing stream engine={engine} model={model} block={STREAM_BLOCK} "
              f"process_block_wall_ms={ms:.4f} [{min(wall):.4f}, "
              f"{max(wall):.4f}] real_time_factor={block_audio_ms / ms:.2f} "
              f"per block (profiled, 10 blocks): "
              f"serving_kernel_launches={len(ours) / 10:g} {traced} other_device_ops="
              f"{(len(dev_events) - len(ours) - len(copies)) / 10:g} copies={len(copies) / 10:g} "
              f"device_us={dev_us:.1f} device_busy_share={dev_us / 1e3 / ms:.3f} "
              f"card={card!r}", flush=True)

    sweeps, iters = DEER_CFG["toms"]
    bound = _bound(_deer_ops(STREAM_BLOCK, sweeps, 2, iters), 8 * STREAM_BLOCK + 12)
    return [{"name": f"fused_deer_clipper (deer_clipper_cluster_kernel<{pd.CLUSTER}>)",
             "route": "cuda", "source": DEER_SOURCE,
             "replaces": DEER_REPLACES, "launches": launches["B5"],
             "max_abs_err": max(plain_errs), "ms": times[STREAM_BLOCK][0],
             "plain_ms": times[STREAM_BLOCK][1], "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": None}]


def _circuits(dev) -> dict:
    """name -> (circuit, params, input node, amplitude, MLP served through
    the ``_neural`` entry or None): the circuits of the batch-serving path."""
    root0, rp0 = make_root_from_zoo(0, device=dev)  # 1N4148 1U-1D, quality "best"
    root1, rp1 = make_root_from_zoo(1, device=dev)  # quality "low" (the plugin's TS/0)
    root4, rp4 = make_root_from_zoo(4, device=dev)  # pretrained 2x16
    out = {}
    for name, root, rp, mlp in (("ts", root0, rp0, None), ("ts_low", root1, rp1, None),
                                ("ts_2x16", root4, rp4, rp4["dp"])):
        ts = make_tube_screamer(root, FS, drive=0.5)
        out[name] = (ts, {**ts.init_params(dev), **rp}, "Vin", 0.2, mlp)
    for name, index in (("hpf", 0), ("hpf_2x16", 3)):
        root, rp = make_hpf_root_from_zoo(index, device=dev)
        hpf = make_hpf_diode_clipper(root, FS)
        out[name] = (hpf, {**hpf.init_params(dev), **rp}, "Vs", 1.5, None)
    lpf = make_diode_clipper(root0, FS, R_SRC, CAP)
    out["lpf"] = (lpf, {**lpf.init_params(dev), **rp0}, "Vs", 1.5, None)
    rc = make_rc_lowpass(FS)
    out["rc"] = (rc, rc.init_params(dev), "Vs", 1.0, None)
    return out


def circuit_server(ckt, params, node, mlp):
    """serve(vin, state, plain=False) -> (out, final state) of a circuit
    through fused_circuit_process (or its ``_neural`` entry)."""
    def serve(vin, state, plain=False):
        if mlp is not None:
            fn = (fcirc.fused_circuit_process_neural_plain if plain
                  else fcirc.fused_circuit_process_neural)
            return fn(ckt, params, mlp, vin, state, input_node=node)
        fn = fcirc.fused_circuit_process_plain if plain else fcirc.fused_circuit_process
        return fn(ckt, params, vin, state, input_node=node)

    return serve


def _state_err(got, want) -> float:
    return max([_max_err(got[k][f], z) for k, d in want.items() for f, z in d.items()],
               default=0.0)


#: the SASS summarised for the diode pair's generated forward: the one-thread
#: kernel and the lane form
CIRCUIT_SASS = ((r"\d+circuit_kernelILb0EE", "circuit_kernel<false>"),
                (r"\d+circuit_lanes_kernelILb0ELi2EE", "circuit_lanes_kernel<false,2>"))
#: the block sizes of the diode pair's lane form that the timing phase
#: measures in turns (the emitter's ``lane_threads`` is the faster)
LANE_SHAPES = (64, 128)


def _other_shape(prog) -> int:
    """The block size of LANE_SHAPES that ``prog``'s lane form does not use."""
    return next(t for t in LANE_SHAPES if t != prog.emitter.lane_threads)


def circuit_path(dev, card: str, seed: int) -> list:
    """Batched serving of the generic circuits: build, kernels distilled,
    kernels circuit, serve circuits and timing circuit phases.  Returns the
    records of B6 and B7 for the JSON line."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    circuits = _circuits(dev)
    servers = {name: circuit_server(ckt, p, node, mlp)
               for name, (ckt, p, node, _, mlp) in circuits.items()}
    n = torch.arange(CIRCUIT_BLOCKS * T, device=dev, dtype=torch.float32)
    tone = torch.sin(2 * np.pi * 1000.0 * n / FS)[None, :]
    noise = torch.randn(B, CIRCUIT_BLOCKS * T, generator=gen, device=dev)
    signals = {name: amp * tone + 0.1 * noise for name, (_, _, _, amp, _) in circuits.items()}
    first = {name: sig[:, :T].contiguous() for name, sig in signals.items()}

    def zero_state(ckt):
        return {k: {f: torch.zeros(B, device=dev) for f in d}
                for k, d in ckt.init_state("cpu").items()}

    # --- build: one generated kernel per circuit, nvcc in parallel ----------
    progs = {name: fcirc.prepare(ckt, p, dev, input_node=node, neural_mlp=mlp)[0]
             for name, (ckt, p, node, _, mlp) in circuits.items()}
    # the K sweep's builds of the NxH roots: every K that divides H
    sweeps = {name: cg.sweep_program(circuits[name][0], progs[name])
              for name in ("ts_2x16", "hpf_2x16")}
    # the diode pair's lane form in the block size of LANE_SHAPES that its
    # emitter does not take, for the block-shape measurement
    shapes = {name: cg.shape_program(circuits[name][0], progs[name],
                                     _other_shape(progs[name]))
              for name in ("ts", "lpf")}
    sources = ([prog.source for prog in progs.values()] + [p.source for p in sweeps.values()]
               + [p.source for p in shapes.values()])
    builds = _build.build_generated.builds
    t0 = time.perf_counter()
    _build.build_generated(sources)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.build_generated(sources)
    cached_s = time.perf_counter() - t0
    print(f"phase build circuits sources={len(set(sources))} nvcc_runs="
          f"{_build.build_generated.builds - builds} cold_seconds={cold_s:.2f} "
          f"cached_seconds={cached_s:.4f}", flush=True)
    for name, prog in progs.items():
        print(f"  ptxas {name} states={len(prog.state_order)} slots={prog.n_coeffs} "
              f"ops_per_sample={prog.ops_per_sample} lanes={prog.lanes} "
              f"{_generated_ptxas(prog.source)}", flush=True)
        _check_no_spills(prog.source, f"the forward of {name}")
    for name, prog in sweeps.items():
        print(f"  ptxas {name} sweep lanes={prog.lanes} {_generated_ptxas(prog.source)}",
              flush=True)
        _check_no_spills(prog.source, f"the sweep's forward of {name}")
    for name, prog in shapes.items():
        print(f"  ptxas {name} block shape {_other_shape(progs[name])} threads "
              f"{_generated_ptxas(prog.source)}", flush=True)
        _check_no_spills(prog.source, f"the block-shape build of {name}")
    for name in ("ts", "lpf"):  # the diode pair's kernels, one-thread and lane form
        for line in _sass_summary(_build.generated_path(progs[name].source), CIRCUIT_SASS):
            print(f"  sass {name} {line}", flush=True)

    # --- kernels distilled: B6 against its plain version and against B2 -------
    d = diode_1n4148_1u1d
    aroot = DiodePairRoot(name="dp", diode=d, quality="best")
    r_port = 1.0 / (1.0 / R_SRC + 2.0 * CAP * FS)  # bench.py:369-371
    droot, fit_err = distill_root(aroot, aroot.init_params("cpu"), r_port)
    vin = 2.0 * torch.randn(B, CIRCUIT_BLOCKS * T, generator=gen, device=dev)
    cheb_blocks = [vin[:, i * T:(i + 1) * T].contiguous() for i in range(CIRCUIT_BLOCKS)]
    z0 = torch.zeros(B, device=dev)
    cheb_args = (droot, R_SRC, CAP)
    got, got_z = fc.fused_clipper_cheb(cheb_blocks[0], z0, *cheb_args, fs=FS)
    want, want_z = fc.fused_clipper_cheb_plain(cheb_blocks[0], z0, *cheb_args, fs=FS)
    analytic_args = (R_SRC, CAP, d.Is, d.Vt * d.nabla, d.N_up, d.N_down)
    y2, _ = fc.fused_clipper_analytic(cheb_blocks[0], z0, *analytic_args, fs=FS)
    torch.cuda.synchronize()
    cheb_err = max(_max_err(got, want), _max_err(got_z, want_z))
    esr = float(((y2 - got) ** 2).sum() / (y2 ** 2).sum())
    print(f"phase kernels distilled root=1N4148 1U-1D best r_port={r_port:.3f} "
          f"degrees={tuple(len(c) - 1 for c in droot.coeffs)} fit_max_abs_err={fit_err:.3e} "
          f"budget=1e-04 shape=({B}, {T}) vs_plain={cheb_err:.3e} budget=1e-05 "
          f"esr_vs_analytic_kernel={esr:.3e} budget=1e-07 "
          f"lanes={fc.cheb_lanes(len(droot.coeffs))}", flush=True)
    _check(fit_err < 1e-4, "distilled root within 1e-4 of the analytic root")
    _check(bool(torch.isfinite(got).all()) and cheb_err <= 1e-5, "B6 within 1e-5 of plain")
    _check(esr < 1e-7, "distilled clipper ESR below 1e-7 against B2")
    cheb_ptxas = {k: v for k, v in _ptxas_kernels(
        "", _build.library_path().with_suffix(".log"), r"\d+(cheb_lanes_kernel)").items()
        if k.startswith("cheb_lanes_kernel")}
    print("phase kernels ptxas distilled " + " | ".join(
        f"{k}: {r} registers, {ss}/{sl} bytes spilled (stores/loads)"
        for k, (r, ss, sl) in sorted(cheb_ptxas.items())), flush=True)
    _check(len(cheb_ptxas) == 2 * len(fc.CHEB_DEGREES)
           and all(ss == sl == 0 for _, ss, sl in cheb_ptxas.values()),
           f"no spills in B6's lane kernels (every degree at K = 4 and 8): {cheb_ptxas}")

    # --- kernels circuit: B7 against its plain version -------------------------
    # omega() against omega_select on the card: the generated forward solves
    # the diode pair with omega_select (omega_pair, omega_pair_lanes); where
    # the two agree, its bits are those of the earlier two omega() calls
    grid = torch.cat([torch.linspace(-120.0, 200.0, 2_000_001), torch.linspace(-1.5, 2.5, 2_000_001),
                      torch.tensor([-1.0, 2.0, -0.99999994, 1.9999999, 0.0, 88.0, 89.0, -1e30,
                                    1e30])]).to(dev)
    differ = {}
    for iters in (1, 2, 3):
        w_omega, w_select = fcirc.omega_forms(grid, iters)
        torch.cuda.synchronize()
        differ[iters] = int((w_omega.view(torch.int32) != w_select.view(torch.int32)).sum())
    print(f"phase kernels circuit omega_vs_omega_select points={grid.numel()} (-120..200, "
          f"-1.5..2.5, the region edges, both tails) differing_bits_by_iters={differ}", flush=True)
    circuit_err = {}
    for name, serve in servers.items():
        ckt = circuits[name][0]
        got, got_state = serve(first[name], zero_state(ckt))
        want, want_state = serve(first[name], zero_state(ckt), plain=True)
        torch.cuda.synchronize()
        circuit_err[name] = max(_max_err(got, want), _state_err(got_state, want_state))
        line = (f"phase kernels circuit {name} shape=({B}, {T}) states={len(want_state)} "
                f"vs_plain={circuit_err[name]:.3e} budget=2e-05")
        if name == "lpf":  # the same circuit through B2
            y2, z2 = fc.fused_clipper_analytic(first[name], z0, *analytic_args, fs=FS)
            torch.cuda.synchronize()
            b2_err = max(_max_err(got, y2), _max_err(got_state["C"]["z"], z2))
            line += f" vs_analytic_kernel={b2_err:.3e} budget=2e-05"
            _check(b2_err <= 2e-5, "B7 on the LPF clipper within 2e-5 of B2")
        prep = fcirc.prepare(ckt, circuits[name][1], dev, input_node=circuits[name][2],
                             neural_mlp=circuits[name][4])
        if prep.prog.lanes != (1,):  # a root with a lane form, and the one-thread kernel
            z = torch.zeros(len(prep.prog.state_order), B, device=dev)
            lanes = fcirc.lanes_for(prep.prog, B)
            one = fcirc.launch(prep, first[name], z, lanes=1)
            torch.cuda.synchronize()
            same = torch.equal(got, one[0])
            line += f" lanes={lanes} equals_one_thread_kernel={same}"
            _check(same, f"B7 {name}: the lane form has the one-thread kernel's bits")
        print(line, flush=True)
        _check(bool(torch.isfinite(got).all()) and circuit_err[name] <= 2e-5,
               f"B7 {name} within 2e-5 of its plain version")

    # --- serve circuits: the main path, counted --------------------------------
    served = ("ts", "ts_2x16", "hpf_2x16")
    fc.fused_clipper_cheb.launches = 0
    fcirc.fused_circuit_process.launches = fcirc.fused_circuit_process.pair_launches = 0
    outs = {}
    for name in served:
        state, parts = zero_state(circuits[name][0]), []
        for i in range(CIRCUIT_BLOCKS):
            out, state = servers[name](signals[name][:, i * T:(i + 1) * T].contiguous(), state)
            parts.append(out)
        outs[name] = (torch.cat(parts, dim=1), state)
    z, parts = z0, []
    for blk in cheb_blocks:
        out, z = fc.fused_clipper_cheb(blk, z, *cheb_args, fs=FS)
        parts.append(out)
    outs["distilled"] = (torch.cat(parts, dim=1), z)
    torch.cuda.synchronize()
    launches = {"B6": fc.fused_clipper_cheb.launches, "B7": fcirc.fused_circuit_process.launches}
    pair_launches = fcirc.fused_circuit_process.pair_launches
    for name in served + ("distilled",):
        out, state = outs[name]
        if name == "distilled":
            whole, whole_z = fc.fused_clipper_cheb(vin, z0, *cheb_args, fs=FS)
            carry = max(_max_err(out, whole), _max_err(state, whole_z))
        else:
            whole, whole_state = servers[name](signals[name], zero_state(circuits[name][0]))
            carry = max(_max_err(out, whole), _state_err(state, whole_state))
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all())
        print(f"phase serve circuit {name} blocks={CIRCUIT_BLOCKS}x({B}, {T}) finite={finite} "
              f"shape={tuple(out.shape)} carry_vs_one_run_max_abs={carry:.3e} budget=1e-06",
              flush=True)
        _check(finite and tuple(out.shape) == (B, CIRCUIT_BLOCKS * T), f"{name} output shaped")
        _check(carry <= 1e-6, f"{name}: two blocks with carried state equal one run")
    print(f"phase serve circuit launches={launches} (B7 diode-pair lane form: {pair_launches})",
          flush=True)
    _check(launches["B6"] >= CIRCUIT_BLOCKS and launches["B7"] >= len(served) * CIRCUIT_BLOCKS,
           "B6 and B7 launched on the main path")

    # the drive pot: a new coefficient vector, no new build
    ts, ts_params = circuits["ts"][0], circuits["ts"][1]
    small = 0.02 * torch.sin(2 * np.pi * 440.0 * n[:T] / FS)[None, :].repeat(B, 1)
    builds, gains = _build.build_generated.builds, []
    for drive in (0.0, 1.0):
        ts_d = make_tube_screamer(ts.root, FS, drive=drive)
        out, _ = fcirc.fused_circuit_process(ts_d, {**ts_d.init_params(dev), "dp": ts_params["dp"]},
                                             small, zero_state(ts_d))
        torch.cuda.synchronize()
        gains.append(float(out[:, T // 2:].abs().max() / small.abs().max()))
    print(f"phase serve circuit drive 0.0->1.0 peak_gain={gains[0]:.3f}->{gains[1]:.3f} "
          f"nvcc_runs={_build.build_generated.builds - builds}", flush=True)
    _check(_build.build_generated.builds == builds, "a drive change does not rebuild")
    _check(gains[1] > 2.0 * gains[0], "more drive, more gain")

    # --- timing circuit -------------------------------------------------------
    def launch_only(name, rows=B, prog=None):
        """The generated kernel's launch alone, on arguments prepared once
        (``prog``: another build of the circuit's forward)."""
        ckt, p, node, _, mlp = circuits[name]
        prep = fcirc.prepare(ckt, p, dev, input_node=node, neural_mlp=mlp)
        prep = prep if prog is None else prep._replace(prog=prog)
        x = first[name][:rows].contiguous()
        z = torch.zeros(len(prep.prog.state_order), rows, device=dev)
        return lambda: fcirc.launch(prep, x, z)

    times = {}
    cases = [("B6", lambda: fc.fused_clipper_cheb(cheb_blocks[0], z0, *cheb_args, fs=FS),
              lambda: fc.fused_clipper_cheb_plain(cheb_blocks[0], z0, *cheb_args, fs=FS))]
    for name in ("ts", "ts_low", "ts_2x16", "hpf", "hpf_2x16", "lpf"):
        ckt = circuits[name][0]
        cases.append((f"B7 {name}", launch_only(name),
                      lambda name=name, ckt=ckt: servers[name](first[name], zero_state(ckt),
                                                               plain=True)))
    for label, kernel, plain in cases:
        _cuda_ms(kernel, 1, 2)
        k = _cuda_ms(kernel, REPS, 10)
        wrapper = ""
        if label.startswith("B7"):  # the user's call: adaptation, vector, launch
            name = label.split()[1]
            state = zero_state(circuits[name][0])
            w_ms = statistics.median(_cuda_ms(lambda: servers[name](first[name], state), 3, 10))
            wrapper = f" wrapper_ms={w_ms:.4f} (10 calls per run)"
        p_ms = _cuda_ms(plain, 1)[0] if label in ("B6", "B7 ts", "B7 ts_2x16") else float("nan")
        times[label] = (statistics.median(k), p_ms)
        print(f"phase timing circuit {label} shape=({B}, {T}) runs={REPS} "
              f"kernel_ms={statistics.median(k):.4f} [{min(k):.4f}, {max(k):.4f}] "
              f"(10 launches per run){wrapper} plain_ms={p_ms:.4f} "
              f"(one run) card={card!r}", flush=True)
    # B7 at B = 1, the kernel a single-stream scan block waits on: the
    # plugin's Tube Screamer (analytic "low") and the HPF clipper's "toms";
    # and B6 at B = 1; device time
    one_row, z1 = cheb_blocks[0][:1].contiguous(), z0[:1].contiguous()
    b1_cases = {"B7 ts_low": launch_only("ts_low", rows=1), "B7 hpf": launch_only("hpf", rows=1),
                "B6": lambda: fc.fused_clipper_cheb(one_row, z1, *cheb_args, fs=FS)}
    for name, fn in b1_cases.items():
        with _sm_clock() as mhz:
            dev_ms = statistics.median(_device_ms(fn) for _ in range(REPS))
        clock = statistics.median(mhz) if mhz else float("nan")
        print(f"phase timing circuit {name} B=1 T={T} runs={REPS} device lanes_ms={dev_ms:.4f} "
              f"({dev_ms * clock * 1e3 / T:.0f} cycles/sample) "
              f"sm_clock_mhz={clock:g} card={card!r}", flush=True)
    # the block shape of the diode pair's lane form at (8192, 2048): 64 and
    # 128 threads, in turns (the emitter keeps the faster as its lane_threads)
    for name in ("ts", "lpf"):
        forms = {progs[name].emitter.lane_threads: launch_only(name),
                 _other_shape(progs[name]): launch_only(name, prog=shapes[name])}
        shape_ms = {t: [] for t in forms}
        for rep in range(REPS):
            for t in (sorted(forms) if rep % 2 else sorted(forms, reverse=True)):
                shape_ms[t] += _cuda_ms(forms[t], 1, 10)
        med = {t: statistics.median(v) for t, v in shape_ms.items()}
        print(f"phase timing circuit block_shape {name} shape=({B}, {T}) runs={REPS} in turns "
              + " ".join(f"threads={t}:{med[t]:.4f}" for t in sorted(med))
              + f" ms (10 launches per run) fastest={min(med, key=med.get)} "
              f"chosen={progs[name].emitter.lane_threads} card={card!r}", flush=True)
    # the lanes per stream of the NxH roots' lane form (B7), on the sweep's
    # build, at the serving shape, the generic training batch and two
    # batches between them (where lanes_for switches K), no trajectory;
    # lanes = 1 is the one-thread kernel
    for name in ("ts_2x16", "hpf_2x16"):
        ckt, p, node, _, mlp = circuits[name]
        prep = fcirc.prepare(ckt, p, dev, input_node=node, neural_mlp=mlp)
        prep = prep._replace(prog=sweeps[name])
        for rows in (B, 4096, 2048, GEN_B):
            x = first[name][:rows].contiguous()
            z = torch.zeros(len(prep.prog.state_order), rows, device=dev)
            sweep = {}
            for lanes in prep.prog.lanes:
                fn = (lambda lanes=lanes: fcirc.launch(prep, x, z, lanes=lanes))
                _cuda_ms(fn, 1, 2)
                sweep[lanes] = statistics.median(_cuda_ms(fn, REPS, 10))
            best = min(sweep, key=sweep.get)
            print(f"phase timing circuit lanes {name} shape=({rows}, {T}) runs={REPS} "
                  + " ".join(f"K={k}:{v:.4f}" for k, v in sweep.items())
                  + f" ms (10 launches per run) fastest=K{best} "
                  f"chosen=K{fcirc.lanes_for(prep.prog, rows)} card={card!r}", flush=True)

    # the LPF clipper's own kernels on the same streams: B2 beside B7 on the
    # analytic root, B1 (the pretrained 2x16) beside B7 on the TS 2x16
    mlp = circuits["ts_2x16"][4]
    refs = {"B2": lambda: fc.fused_clipper_analytic(first["lpf"], z0, *analytic_args, fs=FS),
            "B1": lambda: fc.fused_clipper_neural(first["lpf"], z0, mlp, R_SRC, CAP, fs=FS)}
    ref_ms = {}
    for name, fn in refs.items():
        _cuda_ms(fn, 1, 2)
        ref_ms[name] = statistics.median(_cuda_ms(fn, REPS, 10))
    print(f"phase timing circuit references shape=({B}, {T}) runs={REPS} "
          f"B2_ms={ref_ms['B2']:.4f} B1_2x16_ms={ref_ms['B1']:.4f} (10 launches per run) "
          f"B7_lpf_over_B2={times['B7 lpf'][0] / ref_ms['B2']:.3f} "
          f"B7_ts_2x16_over_B1={times['B7 ts_2x16'][0] / ref_ms['B1']:.3f} card={card!r}",
          flush=True)

    # bounds: operations counted from the sources, bytes = in + out + state
    # B6 per sample: the clipper's b_temp, a, z' and output (6) around the root
    cheb_ops = (fc.cheb_root_ops(len(droot.coeffs), fc.cheb_parameters(droot)[1]) + 6) * B * T
    bounds = {"B6": _bound(cheb_ops, 8 * B * T + 8 * B)}
    for name in ("ts", "ts_low", "ts_2x16", "hpf", "hpf_2x16", "lpf"):
        prog = progs[name]
        bounds[f"B7 {name}"] = _bound(prog.ops_per_sample * B * T,
                                      8 * B * T + 8 * len(prog.state_order) * B)
    for label, (bound_ms, by) in bounds.items():
        print(f"phase timing circuit bound {label} kernel_ms={times[label][0]:.4f} "
              f"bound_ms={bound_ms:.6f} ({by}) share={bound_ms / times[label][0]:.4f} "
              f"launches_on_main_path={launches[label.split()[0]]} card={card!r}", flush=True)
    return [
        {"name": "fused_clipper_cheb", "route": "cuda", "source": CHEB_SOURCE,
         "replaces": CHEB_REPLACES, "launches": launches["B6"], "max_abs_err": cheb_err,
         "ms": times["B6"][0], "plain_ms": times["B6"][1],
         **dict(zip(("bound_ms", "bound_by"), bounds["B6"])), "library_ms": None},
        {"name": "fused_circuit_process", "route": "cuda", "source": CIRCUIT_SOURCE,
         "replaces": CIRCUIT_REPLACES, "launches": launches["B7"],
         "max_abs_err": max(circuit_err.values()), "ms": times["B7 ts"][0],
         "plain_ms": times["B7 ts"][1],
         **dict(zip(("bound_ms", "bound_by"), bounds["B7 ts"])), "library_ms": None},
    ]


def _gen_case(name: str, dev, b: int, t: int, pretrained: bool = True):
    """(circuit, params, input node, MLP for the ``_neural`` entry or None,
    pot (node, field) or None, pot values or None, input amplitude) of a
    case of the generic training path at (b, t): the Tube Screamer with the
    pretrained (or a seeded random-init) 2x16, with no pot or one drive per
    row (R6 = 51k + drive 500k, drive uniform on [0, 1], seed 3,
    bench.py:560-604); the HPF clipper with the analytic root; the training
    clipper with a seeded random-init 2x16 and a random-walk source R per
    sample (step 0.003, seed 5, bench.py:610-622)."""
    if name.startswith("ts_2x16"):
        if pretrained:
            root, frag = _pretrained_2x16(dev)
        else:
            root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
            frag = root.init_params(dev, torch.Generator().manual_seed(13))
        ckt = make_tube_screamer(root, GEN_FS, drive=GEN_DRIVE)
        params = {**ckt.init_params(dev), **frag}
        if name == "ts_2x16":
            return ckt, params, "Vin", frag["dp"], None, None, 0.5
        r6 = drive_to_r6(np.random.default_rng(3).uniform(0.0, 1.0, b)).astype(np.float32)
        return (ckt, params, "Vin", frag["dp"], ("R6", "R"), torch.from_numpy(r6).to(dev), 0.5)
    if name == "hpf":
        root, rp = make_hpf_root_from_zoo(0, device=dev)
        ckt = make_hpf_diode_clipper(root, GEN_FS)
        return ckt, {**ckt.init_params(dev), **rp}, "Vs", None, None, None, 1.0
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    ckt = make_training_clipper(root, GEN_FS)
    params = {**ckt.init_params(dev), **root.init_params(dev, torch.Generator().manual_seed(1))}
    walk = np.cumsum(0.003 * np.random.default_rng(5).standard_normal((b, t)), axis=1)
    r = torch.from_numpy(np.exp(np.log(45e3) + walk).astype(np.float32)).to(dev)
    return ckt, params, "Vs", None, ("Vs", "R"), r, 1.0


def _gen_forward(case, vin, plain: bool = False):
    """(out, final state, trajectory) of the generated forward (or its plain
    version) with the case's pot streams."""
    ckt, params, node, mlp, pot, values, _ = case
    kw = dict(input_node=node, return_state_seq=True,
              row_controls={pot[0]: {pot[1]: values}} if pot else None)
    if mlp is not None:
        tree = {k: v for k, v in params.items() if k != "dp"}
        fn = (fcirc.fused_circuit_process_neural_plain if plain
              else fcirc.fused_circuit_process_neural)
        return fn(ckt, tree, mlp, vin, _zero_state(ckt, vin), **kw)
    fn = fcirc.fused_circuit_process_plain if plain else fcirc.fused_circuit_process
    return fn(ckt, params, vin, _zero_state(ckt, vin), **kw)


def _zero_state(ckt, vin):
    return {k: {f: torch.zeros(vin.shape[0], device=vin.device) for f in d}
            for k, d in ckt.init_state("cpu").items()}


def _gen_backward(case, vin, g_out, seq, lam_T, plain: bool = False):
    ckt, params, node, mlp, pot, values, _ = case
    tree = {k: v for k, v in params.items() if k != "dp"} if mlp is not None else params
    fn = pb.fused_backward_plain if plain else pb.fused_backward
    return fn(ckt, tree, vin, g_out, seq, lam_T, input_node=node, neural_mlp=mlp,
              row_controls={pot[0]: {pot[1]: values}} if pot else None)


def _gen_prepare(case, dev, shape):
    ckt, params, node, mlp, pot, values, _ = case
    tree = {k: v for k, v in params.items() if k != "dp"} if mlp is not None else params
    return fcirc.prepare(ckt, tree, dev, input_node=node, neural_mlp=mlp, shape=shape,
                         row_controls={pot[0]: {pot[1]: values}} if pot else None)


def _leaf_names(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _rel_err(x, y) -> float:
    return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)


def _gen_grads(case, vin, y, fused: bool):
    """({leaf: gradient}, g_vin) of mean((out - y)^2) through the
    fused_generic op or through the scan engine (Circuit.process, the rows
    as a trailing batch axis; a per-row pot as a static control, a
    per-sample pot as a driven input)."""
    ckt, params, node, mlp, pot, values, _ = case
    leaves, rebuild = pb._flatten(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    p = rebuild(leaves)
    v = vin.clone().requires_grad_(True)
    if fused:
        f = pb.make_fused_circuit_train_generic(ckt, input_node=node,
                                                row_fields=(pot,) if pot else ())
        z0 = [torch.zeros(vin.shape[0], device=vin.device) for _ in cg.state_order(ckt)]
        out = (f(p, v, z0, (values,)) if pot else f(p, v, z0))[0]
    else:
        inputs, static = {node: {"v": v.T}}, None
        if pot is not None and values.dim() == 2:
            inputs.setdefault(pot[0], {})[pot[1]] = values.T
        elif pot is not None:
            static = {pot[0]: {pot[1]: values}}
        out = ckt.process(p, ckt.init_state(vin.device), inputs, static_controls=static)[0].T
    ((out - y) ** 2).mean().backward()
    return ({n: (x.grad if x.grad is not None else torch.zeros_like(x))
             for n, x in zip(_leaf_names(params), leaves)}, v.grad)


def _ptxas_kernels(source: str, log: Optional[Path] = None,
                   kernel: str = r"\d+(circuit_\w*?kernel)") -> dict:
    """{kernel<template args>: (registers, spill store bytes, spill load
    bytes)} from the ``-Xptxas -v`` log of a generated source, or from
    ``log`` (the kernel library's), each entry named by ``kernel``'s group
    where it matches."""
    out, name = {}, None
    log = log or _build.generated_path(source).with_suffix(".log")
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            k = re.search(kernel, mangled)
            args = [a.replace("n", "-") for a in re.findall(
                r"L[bi](n?\d+)E", mangled[k.end():].split("Ev", 1)[0])] if k else []
            name = (k.group(1) if k else mangled) + (f"<{','.join(args)}>" if args else "")
            out[name] = [0, 0, 0]
        elif name and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            out[name][1:] = [int(n) for n, _ in nums][:2]
        elif name and "registers" in line:
            out[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return {k: tuple(v) for k, v in out.items()}


def _generated_ptxas(source: str, kernel: str = r"\d+(circuit_\w*?kernel)") -> str:
    return " | ".join(f"{k}: {r} registers, {ss}/{sl} bytes spilled (stores/loads)"
                      for k, (r, ss, sl) in _ptxas_kernels(source, kernel=kernel).items())


#: the generated DEER kernel in a ptxas log: deer_cluster_kernel<C>
DEER_PTXAS = r"\d+(deer_\w*?kernel)"


def _scratch_bytes(adj, B: int, T: int) -> str:
    """B8's scratch at (B, T) as its wrapper allocates it: bytes, stream
    group of pass 2 and time chunk."""
    tc = adj.chunk(B, T)
    return f"{4 * adj.scratch_floats(B, tc)} (group {adj.GROUP}, chunk {tc})"


def _adjoint_passes(circuit, prep, vin, g_out, zseq, lam_t):
    """(pass 1, pass 2): launch-only calls of B8's two kernels over all T on
    a scratch allocated once (writing the root's streams where the program
    has them, as the main path does), so that each is timed alone."""
    adj = cg.adjoint_program(circuit, prep.prog)
    lib = _build.generated_library(adj.source)
    B, T = vin.shape
    _check(adj.chunk(B, T) == T, "one chunk at the timed shape")
    jac = torch.empty(adj.scratch_floats(B, T), device=vin.device)
    lam_seq, g_vin, g_z0 = torch.empty_like(zseq), torch.empty_like(vin), torch.empty_like(lam_t)
    a_seq, gseq = torch.empty_like(vin), torch.empty_like(vin)
    a_ptr, g_ptr = (a_seq.data_ptr(), gseq.data_ptr()) if adj.root_streams else (None, None)
    rows = prep.rows if prep.rows.numel() else prep.vec
    times = prep.times if prep.times.numel() else prep.vec
    n_w = 0 if prep.warr is None else prep.warr.numel()
    w = prep.warr if prep.warr is not None else prep.vec

    def pass1():
        _build.check(lib.circuit_jacobian_launch(
            vin.data_ptr(), g_out.data_ptr(), zseq.data_ptr(), jac.data_ptr(), a_ptr, B, T, 0, T,
            prep.vec.data_ptr(), rows.data_ptr(), times.data_ptr(), w.data_ptr(), n_w,
            torch.cuda.current_stream().cuda_stream), "pass 1", lib.circuit_error_string)

    def pass2():
        _build.check(lib.circuit_recursion_launch(
            jac.data_ptr(), lam_t.data_ptr(), g_z0.data_ptr(), lam_seq.data_ptr(),
            g_vin.data_ptr(), g_ptr, B, T, 0, T, torch.cuda.current_stream().cuda_stream), "pass 2",
            lib.circuit_error_string)

    return pass1, pass2


def _check_no_spills(source: str, what: str) -> None:
    """The redesigned kernels (lane forward, the adjoint's two passes) must
    not spill."""
    new = {k: v for k, v in _ptxas_kernels(source).items()
           if k.startswith(("circuit_lanes_kernel", "circuit_jacobian", "circuit_recursion"))}
    _check(all(ss == sl == 0 for _, ss, sl in new.values()), f"no spills in {what}: {new}")


def generic_train_path(dev, card: str, seed: int) -> list:
    """Generic in-circuit training: build generic, kernels generic, grad
    generic, train generic and timing generic phases.  Returns the records
    of B7 (training form) and B8 for the JSON line."""
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    shape = f"({GEN_B}, {GEN_T})"
    cases = {name: _gen_case(name, dev, GEN_B, GEN_T) for name in GEN_CASES}
    # the Tube Screamer's input at guitar level, as the serving path drives
    # it (0.2 sin 1 kHz + 0.1 N(0, 1)); the clippers N(0, 1)
    n = torch.arange(GEN_T, device=dev, dtype=torch.float32)
    tone = torch.sin(2 * np.pi * 1000.0 * n / GEN_FS)[None, :]
    inputs = {name: (0.2 * tone + 0.1 * torch.randn(GEN_B, GEN_T, generator=gen, device=dev)
                     if name.startswith("ts") else
                     torch.randn(GEN_B, GEN_T, generator=gen, device=dev))
              for name in GEN_CASES}

    # --- build generic: every generated source the path runs, in parallel -----
    preps = {name: _gen_prepare(c, dev, (GEN_B, GEN_T)) for name, c in cases.items()}
    adjs = {name: cg.adjoint_program(c[0], preps[name].prog) for name, c in cases.items()}
    # the train phase's other circuits: the TS with the low-quality analytic
    # root (its data), and the training clipper with one R per row, analytic
    # (the joint fit's targets) and with a 1x4 root (the joint fit)
    aroot = DiodePairRoot(name="dp", diode=GEN_DIODE, quality="low")
    ts_low = make_tube_screamer(aroot, GEN_FS, drive=GEN_DRIVE)
    extra = [fcirc.prepare(ts_low, {**ts_low.init_params(dev), **aroot.init_params(dev)}, dev,
                           input_node="Vin").prog.source]
    r_rows = {"Vs": {"R": torch.full((GEN_B,), 45e3, device=dev)}}
    clip_a = make_training_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), GEN_FS)
    extra.append(fcirc.prepare(clip_a, {**clip_a.init_params(dev), **clip_a.root.init_params(dev)},
                               dev, input_node="Vs", row_controls=r_rows,
                               shape=(GEN_B, GEN_T)).prog.source)
    joint_root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    clip_n = make_training_clipper(joint_root, GEN_FS)
    joint_prog = fcirc.prepare(clip_n, {**clip_n.init_params(dev), **joint_root.init_params(dev)},
                               dev, input_node="Vs", row_controls=r_rows,
                               shape=(GEN_B, GEN_T)).prog
    extra += [joint_prog.source, cg.adjoint_program(clip_n, joint_prog).source]
    # the K sweep's build of the training form (every K that divides H)
    ts_sweep = cg.sweep_program(cases["ts_2x16"][0], preps["ts_2x16"].prog)
    extra.append(ts_sweep.source)
    sources = ([p.prog.source for p in preps.values()] + [a.source for a in adjs.values()]
               + extra)
    builds = _build.build_generated.builds
    t0 = time.perf_counter()
    _build.build_generated(sources)
    print(f"phase build generic sources={len(set(sources))} nvcc_runs="
          f"{_build.build_generated.builds - builds} cold_seconds={time.perf_counter() - t0:.2f}",
          flush=True)
    for name in GEN_CASES:
        prog, adj = preps[name].prog, adjs[name]
        print(f"  ptxas {name} forward states={len(prog.state_order)} slots={prog.n_coeffs}/"
              f"{prog.n_rows}/{prog.n_times} ops_per_sample={prog.ops_per_sample} "
              f"lanes={prog.lanes} {_generated_ptxas(prog.source)}", flush=True)
        print(f"  ptxas {name} adjoint ops_per_sample={adj.ops_per_sample} (pass 1 "
              f"{adj.jacobian_ops}, pass 2 {adj.recursion_ops}) entries={adj.n_entries} "
              f"scratch_bytes={_scratch_bytes(adj, GEN_B, GEN_T)} "
              f"{_generated_ptxas(adj.source)}", flush=True)
        _check_no_spills(prog.source, f"the forward of {name}")
        _check_no_spills(adj.source, f"the adjoint of {name}")

    # --- kernels generic: B7 with its trajectory and B8 against plain ----------
    fwd_err, bwd_err, plain_ms, roots = {}, {}, {}, {}
    for name, case in cases.items():
        vin = inputs[name]
        got = _gen_forward(case, vin)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = _gen_forward(case, vin, plain=True)
        torch.cuda.synchronize()
        plain_fwd = (time.perf_counter() - t0) * 1e3
        errs = [_max_err(got[0], want[0]), _state_err(got[1], want[1]),
                max(_max_err(a, w) for a, w in zip(got[2], want[2]))]
        fwd_err[name] = max(errs)
        prep = preps[name]
        lanes = fcirc.lanes_for(prep.prog, GEN_B)
        same = True
        if lanes != 1:  # the lane form has the one-thread kernel's bits
            one = fcirc.launch(prep, vin, fcirc._state_stack(prep.prog, _zero_state(case[0], vin),
                                                             vin), True, lanes=1)
            same = torch.equal(got[0], one[0]) and torch.equal(torch.stack(got[2]), one[2])
        print(f"phase kernels generic {name} forward shape={shape} lanes={lanes} "
              f"max_abs_err out={errs[0]:.3e} z_final={errs[1]:.3e} trajectory={errs[2]:.3e} "
              f"budget=2e-05 equals_one_thread_kernel={same}", flush=True)
        _check(all(bool(torch.isfinite(x).all()) for x in [got[0], *got[2]])
               and fwd_err[name] <= 2e-5, f"B7 {name} with trajectory within 2e-5 of plain")
        _check(same, f"B7 {name}: the lane form has the one-thread kernel's bits")
        g_out = torch.randn(GEN_B, GEN_T, generator=gen, device=dev) / (GEN_B * GEN_T)
        lam_T = [torch.randn(GEN_B, generator=gen, device=dev) / GEN_B for _ in got[2]]
        seq = [x.contiguous() for x in got[2]]
        b_got = _gen_backward(case, vin, g_out, seq, lam_T)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b_want = _gen_backward(case, vin, g_out, seq, lam_T, plain=True)
        torch.cuda.synchronize()
        plain_ms[name] = (plain_fwd, (time.perf_counter() - t0) * 1e3)
        rel = ([_rel_err(b_got[1], b_want[1])]
               + [_rel_err(a, w) for a, w in zip(b_got[0], b_want[0])]
               + [_rel_err(a, w) for a, w in zip(b_got[2], b_want[2])])
        bwd_err[name] = max([_max_err(b_got[1], b_want[1])]
                            + [_max_err(a, w) for a, w in zip(b_got[0] + b_got[2],
                                                               b_want[0] + b_want[2])])
        print(f"phase kernels generic {name} adjoint shape={shape} relative g_vin={rel[0]:.3e} "
              f"lam={max(rel[1:1 + len(seq)]):.3e} g_z0={max(rel[1 + len(seq):]):.3e} "
              f"max_abs_err={bwd_err[name]:.3e} budget={GEN_BUDGET[name]:g} (relative) "
              f"plain_ms forward={plain_ms[name][0]:.1f} adjoint={plain_ms[name][1]:.1f} (host "
              f"clock, one run)", flush=True)
        _check(all(bool(torch.isfinite(x).all()) for x in [b_got[1], *b_got[0]])
               and max(rel) < GEN_BUDGET[name], f"B8 {name} within budget of plain")
        # the root's streams (an NxH root, R_up one value or one per row)
        root, p_root = b_got[3], b_want[3]
        _check((root is None) == (p_root is None) == (not adjs[name].root_streams),
               f"B8 {name}: the root's streams where the program has them")
        if root is not None:
            a_err, g_rel = _max_err(root.a_seq, p_root.a_seq), _rel_err(root.G, p_root.G)
            same_r = torch.equal(root.log_r, p_root.log_r)
            print(f"phase kernels generic {name} root streams shape={shape} a max_abs_err="
                  f"{a_err:.3e} budget=2e-05 G relative={g_rel:.3e} budget={GEN_BUDGET[name]:g} "
                  f"log_r_equal={same_r}", flush=True)
            _check(a_err <= 2e-5 and g_rel < GEN_BUDGET[name] and same_r,
                   f"B8 {name}: the root's a and G within budget of plain")
            roots[name] = root
    pass3 = _root_pass3(card, cases["ts_2x16"][3], roots["ts_2x16"])

    # --- grad generic: the fused_generic op against the scan engine ------------
    gb, gt = GEN_GRAD_B, GEN_GRAD_T
    for name in GEN_CASES:
        case = _gen_case(name, dev, gb, gt, pretrained=False)
        vin = case[6] * torch.randn(gb, gt, generator=gen, device=dev)
        y = torch.randn(gb, gt, generator=gen, device=dev)
        got, g_vin = _gen_grads(case, vin, y, fused=True)
        want, w_vin = _gen_grads(case, vin, y, fused=False)
        errs = {n: _rel_err(got[n], want[n]) for n in want}
        worst = max(errs, key=errs.get)
        line = (f"phase grad generic {name} fused_generic vs scan engine shape=({gb}, {gt}) "
                f"leaves={len(errs)} worst={worst}:{errs[worst]:.3e} "
                f"budget={GEN_GRAD_BUDGET[name]:g} g_vin={_rel_err(g_vin, w_vin):.3e}")
        ok = errs[worst] < GEN_GRAD_BUDGET[name]
        if name == "ts_2x16":  # tests/test_parallel_bptt.py:74-81
            line += (f" dp.layers.0.kernel={errs['dp.layers.0.kernel']:.3e} budget=1e-04 "
                     "g_vin budget=1e-04")
            ok = ok and errs["dp.layers.0.kernel"] < 1e-4 and _rel_err(g_vin, w_vin) < 1e-4
        print(line, flush=True)
        _check(ok, f"fused_generic gradients of {name} within budget of the scan engine")

    # --- train generic: the slice as a user drives it --------------------------
    t0 = time.perf_counter()
    vin_tr, vout_tr = synth_ts_measurement(GEN_DIODE, GEN_DRIVE, GEN_FS,
                                           duration_s=GEN_TRAIN_S, seed=0, device=dev)
    vin_va, vout_va = synth_ts_measurement(GEN_DIODE, GEN_DRIVE, GEN_FS,
                                           duration_s=GEN_VAL_S, seed=7, device=dev)
    tb = make_clipper_batches({"x": vin_tr, "y": vout_tr}, CHUNK, device=dev)
    vb = make_clipper_batches({"x": vin_va, "y": vout_va}, CHUNK, device=dev)
    synth_s = time.perf_counter() - t0
    n_train, n_val = tb["x"].shape[0], vb["x"].shape[0]
    print(f"phase train generic setup synth_ts_measurement diode={GEN_DIODE.name!r} "
          f"drive={GEN_DRIVE} seconds={synth_s:.2f} "
          f"train_chunks={n_train} val_chunks={n_val} (expect {GEN_TRAIN_CHUNKS}, "
          f"{GEN_VAL_CHUNKS}) peak_out={float(tb['y'].abs().max()):.4f}", flush=True)
    _check((n_train, n_val) == (GEN_TRAIN_CHUNKS, GEN_VAL_CHUNKS)
           and bool(torch.isfinite(tb["y"]).all()), "full-size TS data set")
    root, frag = _pretrained_2x16(dev)
    circuit = make_tube_screamer(root, GEN_FS, drive=GEN_DRIVE)
    params = {**circuit.init_params(dev), **frag}
    cfg = CircuitTrainConfig(epochs=GEN_EPOCHS, batch_size=CHUNK, engine="fused_generic",
                             log_every=1)
    epoch_ends = []
    fcirc.fused_circuit_process.launches = 0
    pb.fused_backward.launches = pb.root_param_vjp.launches = 0
    t0 = time.perf_counter()
    trained, hist = train_clipper(circuit, params, tb, vb, cfg, trainable_filter=lambda p: p["dp"],
                                  on_epoch=lambda e, p, h: epoch_ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    epoch_ms = [(b - a) * 1e3 for a, b in zip([t0] + epoch_ends, epoch_ends)]
    train_launches = (fcirc.fused_circuit_process.launches, pb.fused_backward.launches,
                      pb.root_param_vjp.launches)
    print(f"phase train generic engine=fused_generic circuit=tube_screamer root=2x16 pretrained "
          f"epochs={GEN_EPOCHS} chunks={n_train}x{CHUNK} seconds={train_s:.3f} "
          f"epoch_wall_ms={[round(v, 1) for v in epoch_ms]} "
          f"loss={[round(v, 8) for v in hist['loss']]} "
          f"val_loss={[round(v, 8) for v in hist['val_loss']]} "
          f"launches B7={train_launches[0]} B8={train_launches[1]} "
          f"B8.pass3={train_launches[2]}", flush=True)
    _check(bool(np.isfinite(hist["loss"] + hist["val_loss"]).all()), "every loss finite")
    _check(hist["loss"][-1] < hist["loss"][0], "TS train loss falls")
    _check(train_launches == (2 * GEN_EPOCHS, GEN_EPOCHS, GEN_EPOCHS),
           "B7 once per step and validation, B8 and the root's pass 3 once per step")

    # the per-row drive pot (bench.py:560-604): two steps
    r6 = drive_to_r6(np.random.default_rng(3).uniform(0.0, 1.0, n_train)).astype(np.float32)
    pot_cfg = CircuitTrainConfig(batch_size=CHUNK, engine="fused_generic", pot_node="R6")
    make_optimizer, pot_step, _ = make_train_step(circuit, pot_cfg, lambda p: p["dp"])
    pot_params = {**params, "dp": ct.mlp_tree([x.detach().clone()
                                              for x in ct.mlp_leaves(trained["dp"])])}
    opt = make_optimizer(pot_params)
    pot_losses = [float(pot_step(pot_params, opt, {**tb, "r0": torch.from_numpy(r6).to(dev)})[
        "loss"]) for _ in range(GEN_POT_STEPS)]
    print(f"phase train generic pot_node=R6 per row, drive uniform [0, 1] steps={GEN_POT_STEPS} "
          f"loss={[round(v, 8) for v in pot_losses]}", flush=True)
    _check(bool(np.isfinite(pot_losses).all()), "per-row drive pot losses finite")

    # joint_fit_clipper: C and a 1x4 root on the training clipper, one R per
    # row (tests/test_parallel_bptt.py:418-457 at the bench's shape)
    rng = np.random.default_rng(seed + 31)
    xj = torch.from_numpy((0.9 * rng.standard_normal((GEN_B, GEN_T))).astype(np.float32)).to(dev)
    r0 = torch.from_numpy(np.exp(rng.uniform(np.log(36e3), np.log(73e3), GEN_B))
                          .astype(np.float32)).to(dev)
    yj, _ = fcirc.fused_circuit_process(
        clip_a, {**clip_a.init_params(dev), **clip_a.root.init_params(dev)}, xj,
        _zero_state(clip_a, xj), input_node="Vs", row_controls={"Vs": {"R": r0}})
    jparams = {**clip_n.init_params(dev), **joint_root.init_params(dev)}
    jparams["C"]["C"] = torch.tensor(6.5e-9, device=dev)
    jcfg = CircuitTrainConfig(epochs=JOINT_EPOCHS, batch_size=GEN_T, engine="fused_generic")
    t0 = time.perf_counter()
    fitted, jhist = joint_fit_clipper(clip_n, jparams, {"x": xj, "y": yj, "r0": r0},
                                      component_lrs={"C.C": 2e-10}, cfg=jcfg, mlp_lr=3e-3)
    torch.cuda.synchronize()
    c_fit = float(fitted["C"]["C"])
    print(f"phase train generic joint_fit_clipper shape={shape} epochs={JOINT_EPOCHS} "
          f"seconds={time.perf_counter() - t0:.3f} loss={jhist['loss'][0]:.6g}->"
          f"{jhist['loss'][-1]:.6g} C={6.5e-9:.4e}->{c_fit:.4e} (true 4.7000e-09)", flush=True)
    _check(jhist["loss"][-1] < jhist["loss"][0], "joint fit loss falls")
    _check(abs(c_fit - 4.7e-9) < abs(6.5e-9 - 4.7e-9), "C moves toward 4.7 nF")
    launches = {"B7": fcirc.fused_circuit_process.launches, "B8": pb.fused_backward.launches,
                "B8.pass3": pb.root_param_vjp.launches}
    print(f"phase train generic launches={launches} (train {train_launches}, "
          f"pot steps and joint fit after)", flush=True)
    _check(launches["B8"] == launches["B8.pass3"] == GEN_EPOCHS + GEN_POT_STEPS + JOINT_EPOCHS,
           "B8 and the root's pass 3 once per training step on the main path")

    # --- timing generic: one fused_generic step of the TS 2x16 ----------------
    x = torch.randn(GEN_B, GEN_T, generator=gen, device=dev)
    ys = torch.randn(GEN_B, GEN_T, generator=gen, device=dev)
    batches = {"x": x, "y": ys}
    tree = {k: v for k, v in trained.items() if k != "dp"}
    mlp = trained["dp"]
    state = {}

    def part_forward():
        state["fwd"] = fcirc.fused_circuit_process_neural(
            circuit, tree, mlp, x, _zero_state(circuit, x), input_node="Vin",
            return_state_seq=True)

    def part_loss():
        o = state["fwd"][0].detach().requires_grad_(True)
        t, oo = ys[:, cfg.skip_samples:], o[:, cfg.skip_samples:]
        state["g_out"], = torch.autograd.grad(mse(t, oo) + esr(t, oo), o)

    def part_adjoint():
        state["adj"] = pb.fused_backward(circuit, tree, x, state["g_out"], state["fwd"][2],
                                         [torch.zeros(GEN_B, device=dev)] * 3, input_node="Vin",
                                         neural_mlp=mlp)

    make_optimizer, step_fn, _ = make_train_step(circuit, cfg, lambda p: p["dp"])
    opt = make_optimizer(trained)
    leaves = pb._flatten(trained)[0]
    root_ids = {id(t) for t in ct.mlp_leaves(mlp)}
    needs = [id(t) in root_ids for t in leaves]  # the step trains the root alone

    def part_params():  # the root's pass 3 on B8's streams
        state["grads"] = pb.parameter_cotangents(circuit, trained, x, state["fwd"][2],
                                                 state["g_out"], state["adj"][0],
                                                 input_node="Vin", root=state["adj"][3],
                                                 needs=needs)

    def part_adam():
        for t, g in zip(leaves, state["grads"]):
            if t.requires_grad:
                t.grad = g
        opt.step()

    def step_parts():
        parts = {}
        for name, fn in (("forward_with_trajectory", part_forward), ("loss", part_loss),
                         ("adjoint", part_adjoint), ("parameter_pass", part_params),
                         ("adam", part_adam)):
            parts[name] = _timed(fn)[0]
        return parts, _timed(lambda: step_fn(trained, opt, batches))

    samples = GEN_B * GEN_T
    parts, step = step_parts()
    print(f"phase timing generic train_step circuit=tube_screamer 2x16 "
          f"shape={shape} runs={REPS} step_ms={step[0]:.4f} [{step[1]:.4f}, {step[2]:.4f}] "
          f"({samples / step[0] / 1e3:.3f} Msamples/s) "
          + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items())
          + f" parts_sum_ms={sum(parts.values()):.4f} card={card!r}", flush=True)

    # both kernels alone, on arguments prepared once
    ts_case = (circuit, trained, "Vin", mlp, None, None, 0.5)
    prep = _gen_prepare(ts_case, dev, (GEN_B, GEN_T))
    z0 = torch.zeros(3, GEN_B, device=dev)
    _, _, zseq = fcirc.launch(prep, x, z0, with_seq=True)
    g_out, lam_t = state["g_out"].contiguous(), torch.zeros(3, GEN_B, device=dev)
    rows375 = GEN_TRAIN_CHUNKS
    x375, g375 = x[:rows375].contiguous(), g_out[:rows375].contiguous()
    z375, l375 = zseq[:, :rows375].contiguous(), lam_t[:, :rows375].contiguous()
    pass1, pass2 = _adjoint_passes(circuit, prep, x, g_out, zseq, lam_t)
    streams, s375 = (torch.empty_like(x), torch.empty_like(x)), (torch.empty_like(x375),
                                                                 torch.empty_like(x375))
    kernel_ms = {}
    for label, fn in (
        ("B7", lambda: fcirc.launch(prep, x, z0, with_seq=True)),
        ("B8", lambda: pb.launch_adjoint(circuit, prep, x, g_out, zseq, lam_t, streams)),
        ("B8 pass 1", pass1),
        ("B8 pass 2", pass2),
        ("B8 375", lambda: pb.launch_adjoint(circuit, prep, x375, g375, z375, l375, s375)),
    ):
        _cuda_ms(fn, 1, 2)
        k = _cuda_ms(fn, REPS, 10)
        kernel_ms[label] = statistics.median(k)
        rows = rows375 if "375" in label else GEN_B
        print(f"phase timing generic kernel {label} shape=({rows}, {GEN_T}) runs={REPS} "
              f"kernel_ms={kernel_ms[label]:.4f} [{min(k):.4f}, {max(k):.4f}] "
              f"(10 launches per run) card={card!r}", flush=True)
    sweep = {}
    sprep = prep._replace(prog=cg.sweep_program(circuit, prep.prog))
    for lanes in sprep.prog.lanes:  # the training form's lanes per stream
        fn = (lambda lanes=lanes: fcirc.launch(sprep, x, z0, with_seq=True, lanes=lanes))
        _cuda_ms(fn, 1, 2)
        sweep[lanes] = statistics.median(_cuda_ms(fn, REPS, 10))
    print(f"phase timing generic lanes B7 training form shape={shape} runs={REPS} "
          + " ".join(f"K={k}:{v:.4f}" for k, v in sweep.items())
          + f" ms fastest=K{min(sweep, key=sweep.get)} chosen=K{fcirc.lanes_for(prep.prog, GEN_B)} "
          f"card={card!r}", flush=True)
    S = 3
    adj = cg.adjoint_program(circuit, prep.prog)
    print(f"phase timing generic scratch B8 entries={adj.n_entries} bytes="
          f"{_scratch_bytes(adj, GEN_B, GEN_T)} {shape}, "
          f"{_scratch_bytes(adj, rows375, GEN_T)} ({rows375}, {GEN_T}); cap "
          f"{adj.SCRATCH_CAP_BYTES}", flush=True)
    # bytes: B7 reads vin and writes out and the S trajectories; B8 reads
    # vin, obar and the trajectories (the TS streams no pot) and writes the S
    # lam streams, g_vin and the root's a and G; both read and write S
    # values per row
    bounds = {"B7": _bound(prep.prog.ops_per_sample * samples,
                           (2 + S) * 4 * samples + 8 * S * GEN_B)}
    for label, rows in (("B8", GEN_B), ("B8 375", rows375)):
        bounds[label] = _bound(adj.ops_per_sample * rows * GEN_T,
                               (3 + 2 * S + 2) * 4 * rows * GEN_T + 8 * S * rows)
    for label in ("B7", "B8", "B8 375"):
        plain = f"{plain_ms['ts_2x16'][0 if label == 'B7' else 1]:.1f}" if label != "B8 375" \
            else "not run"
        print(f"phase timing generic bound {label} kernel_ms={kernel_ms[label]:.4f} "
              f"bound_ms={bounds[label][0]:.6f} "
              f"({bounds[label][1]}) share={bounds[label][0] / kernel_ms[label]:.4f} "
              f"plain_ms={plain} launches_on_main_path={launches[label.split()[0]]} "
              f"card={card!r}", flush=True)
    return [
        {"name": "fused_circuit_process (training form: pot streams, state trajectory)",
         "route": "cuda", "source": CIRCUIT_SOURCE, "replaces": CIRCUIT_REPLACES,
         "launches": launches["B7"], "max_abs_err": max(fwd_err.values()),
         "ms": kernel_ms["B7"], "plain_ms": plain_ms["ts_2x16"][0],
         **dict(zip(("bound_ms", "bound_by"), bounds["B7"])), "library_ms": None},
        {"name": "fused_backward", "route": "cuda", "source": CIRCUIT_SOURCE,
         "replaces": BPTT_REPLACES, "launches": launches["B8"],
         "max_abs_err": max(bwd_err.values()), "ms": kernel_ms["B8"],
         "plain_ms": plain_ms["ts_2x16"][1],
         **dict(zip(("bound_ms", "bound_by"), bounds["B8"])), "library_ms": None},
        {**pass3, "launches": launches["B8.pass3"]},
    ]


def _root_pass3(card: str, mlp, root) -> dict:
    """B4's pass 3 on the root streams B8 wrote (``root_param_vjp``) at the
    generic training shape: against ``mlp_param_vjp_plain`` on the same
    streams (every leaf within 1e-4 of its largest magnitude but the head's
    bias, which sums -G over every sample and cancels: within 16 float32
    epsilon of sum |G| of the exact sum), the same bits on two calls; then
    timed beside its bound and the plain path.  Returns its record."""
    acts = ("tanh",) * (len(mlp["layers"]) - 1) + ("",)
    args = (mlp, acts, root.a_seq, root.log_r, root.G)
    got, again = pb.root_param_vjp(*args), pb.root_param_vjp(*args)
    want = ct.mlp_param_vjp_plain(*args)
    torch.cuda.synchronize()
    scaled = [_scaled_err(g, w) for g, w in zip(got[:-1], want[:-1])]
    G = root.G.double()
    bias_gap = abs(float(got[-1]) + float(G.sum())) / (float(torch.finfo(torch.float32).eps)
                                                       * float(G.abs().sum()))
    same = all(torch.equal(g, h) for g, h in zip(got, again))
    kern = lambda: pb.root_param_vjp(*args)
    _cuda_ms(kern, 1, 2)
    k = _cuda_ms(kern, REPS, 10)
    plain = _timed(lambda: ct.mlp_param_vjp_plain(*args))[0]
    b, t = root.a_seq.shape
    bound = _bound(PARAM_OPS * b * t, 8 * b * t + 4 * b)
    ms = statistics.median(k)
    print(f"phase kernels generic root pass3 ts_2x16 shape=({b}, {t}) scaled_err="
          f"{[float(f'{e:.2e}') for e in scaled]} budget=1e-04 head_bias_gap={bias_gap:.3f} "
          f"budget=16 (float32 epsilon x sum |G|) same_bits_twice={same} runs={REPS} "
          f"kernel_ms={ms:.4f} [{min(k):.4f}, {max(k):.4f}] plain_ms={plain:.4f} "
          f"bound_ms={bound[0]:.6f} ({bound[1]}) share={bound[0] / ms:.4f} card={card!r}",
          flush=True)
    _check(max(scaled) <= 1e-4 and bias_gap < 16 and same,
           "the root's pass 3 within 1e-4 (scaled) of plain on B8's streams, the same bits")
    return {"name": "root_param_vjp (B4's pass 3 on B8's root streams)", "route": "cuda",
            "source": TRAIN_SOURCE,
            "replaces": "none (the JAX package leaves it to XLA: "
                        "diffwdf_tpu/ops/parallel_bptt.py:621-645)",
            "max_abs_err": max(_max_err(g, w) for g, w in zip(got, want)), "ms": ms,
            "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


def _dc_case(name: str, dev):
    """(circuit, params, input node, neural root?, solver keywords, fs) of a
    case of the generic DEER path: the Tube Screamer (drive 0.5) with the
    best and low analytic roots and the pretrained 2x16, the HPF clipper
    with the same three (the HPF-trained 2x16) under the HPF processor's
    damped adaptive settings, and the LPF clipper at 48 kHz with the five
    1U-1D neural sizes of the plugin's zoo (entries 2-6)."""
    kind = name.split("_")[0]
    if kind == "ts":
        index = {"ts": 0, "ts_low": 1, "ts_2x16": 4}[name]
        root, rp = make_root_from_zoo(index, device=dev)
        ckt = make_tube_screamer(root, FS, drive=0.5)
        return ckt, {**ckt.init_params(dev), **rp}, "Vin", index == 4, {}, FS
    if kind == "hpf":
        index = {"hpf": 0, "hpf_low": 1, "hpf_2x16": 3}[name]
        root, rp = make_hpf_root_from_zoo(index, device=dev)
        ckt = make_hpf_diode_clipper(root, FS)
        return ckt, {**ckt.init_params(dev), **rp}, "Vs", index == 3, dict(HPF_DEER), FS
    index = {"clip_2x4": 2, "clip_2x8": 3, "clip_2x16": 4, "clip_4x4": 5, "clip_4x8": 6}[name]
    root, rp = make_root_from_zoo(index, device=dev)
    ckt = make_diode_clipper(root, 48000.0)
    return ckt, {**ckt.init_params(dev), **rp}, "Vs", True, {}, 48000.0


def _dc_input(name: str, T: int, seed: int, dev) -> torch.Tensor:
    """The case's input: the Tube Screamer at guitar level (0.2 sin 1 kHz +
    0.1 N(0, 1), as the circuit path drives it), the HPF clipper 0.5 N(0, 1),
    the clippers 2 N(0, 1) (the JAX suite's neural operating point).  The
    HPF's noise has fixed seeds (HPF_SEED): its adaptive loop compares the
    largest update with adapt_tol, and on these blocks the update at each
    exit test is at least twice or at most half the tolerance, so that the
    sweeps run do not hang on rounding."""
    kind = name.split("_")[0]
    rng = np.random.default_rng(HPF_SEED[T] if kind == "hpf" else seed)
    if kind == "ts":
        x = 0.2 * np.sin(2 * np.pi * 1000.0 * np.arange(T) / FS) + 0.1 * rng.standard_normal(T)
    else:
        x = (0.5 if kind == "hpf" else 2.0) * rng.standard_normal(T)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _dc_solve(case, vin, plain: bool = False, **kw):
    """B9 (or its plain version) on one case: (out, state, residual, sweeps run)."""
    ckt, params, node, neural, skw, _ = case
    if neural:
        fn = dc.fused_deer_neural_plain if plain else dc.fused_deer_neural
    else:
        fn = dc.fused_deer_circuit_plain if plain else dc.fused_deer_circuit
    return fn(ckt, params, vin, input_node=node, return_info=True, **{**skw, **kw})


def _dc_exact(case, vin):
    """The exact recursion of a case: B7 at B=1 (out (T,), final state)."""
    ckt, params, node = case[:3]
    out, st = fcirc.fused_circuit_process(ckt, params, vin[None], _zero_state(ckt, vin[None]),
                                          input_node=node)
    return out[0], {k: {f: z[0] for f, z in d.items()} for k, d in st.items()}


def _dc_ops(deer, T: int, sweeps: int, relax: int, damping: float, adapt_tol: float) -> int:
    """Operations of one B9 solve of T samples, counted from the generated
    code as this call runs it: relax_passes run the forward step
    (step_ops), the emit pass the forward step and the residual (2 S); a
    sweep runs per row the DEER step (ops_per_sample), the affine map
    c = f - J z (2 S^2), the composition onto the block's prefix
    (S^2 (2S - 1) + 2 S^2) and the fix-up: apply (2 S^2) and clamp (2 S),
    the damping (3 S) only when damping != 1, the update (2 S) only when
    adapt_tol > 0; per sweep the block scan (``_scan_ops``)."""
    S = deer.n_state
    compose = S * S * (2 * S - 1) + 2 * S * S
    row = (deer.ops_per_sample + 2 * S * S + compose + 2 * S * S + 2 * S
           + (3 * S if damping != 1.0 else 0) + (2 * S if adapt_tol > 0 else 0))
    per_sweep = T * row + _scan_ops(S)
    return T * ((relax + 1) * deer.step_ops + 2 * S) + sweeps * per_sweep


def _plugin_block(i: int):
    """(group, model, gain dB, block params) of plugin stream block i: three
    blocks per member, every member of every group in turn, then the Tube
    Screamer 2x16 to the end; cutoff and drive change every block."""
    group, model = PLUGIN_MEMBERS[min(i // 3, len(PLUGIN_MEMBERS) - 1)]
    gain = (0.0, 3.0, 6.0)[(i // 3) % 3]
    if group == "tube_screamer":
        return group, model, gain, {"drive": (0.2, 0.5, 0.8)[i % 3]}
    return group, model, gain, {"cutoff_hz": (2000.0, 4000.0, 8000.0)[i % 3]}


def _all_launches() -> dict:
    """Launch counters of every kernel that serves a single-stream block."""
    return {"B9": dc.fused_deer_circuit.launches, "B9n": dc.fused_deer_neural.launches,
            "B5": pd.fused_deer_clipper.launches, "B7": fcirc.fused_circuit_process.launches,
            "B2": fc.fused_clipper_analytic.launches, "B1": fc.fused_clipper_neural.launches}


def _counted(fn) -> dict:
    """Call fn(); the kernel launches it made, by kernel (nonzero only)."""
    before = _all_launches()
    fn()
    return {k: v - before[k] for k, v in _all_launches().items() if v != before[k]}


def _nvcc_seconds(jobs: dict) -> dict:
    """label -> source text: the wall seconds of one cold nvcc of each into
    a shared library (ops/_build.py's flags, csrc/ on the include path) in a
    temporary directory, all started together."""
    nvcc = _build._nvcc()
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for i, (label, text) in enumerate(jobs.items()):
                cu = Path(tmp) / f"source{i}.cu"
                cu.write_text(text)
                procs[label] = (time.perf_counter(), subprocess.Popen(
                    [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-shared", "-o",
                     str(cu.with_suffix(".so")), str(cu)],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
            while len(seconds) < len(procs):
                for label, (t0, proc) in procs.items():
                    if label not in seconds and proc.poll() is not None:
                        seconds[label] = time.perf_counter() - t0
                        _check(proc.returncode == 0, f"nvcc of {label}")
                time.sleep(0.02)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return seconds


def deer_circuit_path(dev, card: str, seed: int) -> list:
    """Single-stream serving of the generic circuits: build deer, kernels
    deer circuit, stream plugin and timing deer circuit phases.  Returns the
    records of B9 (both entries) for the JSON line."""
    cases = {name: _dc_case(name, dev) for name in DC_CASES}

    # --- build deer: one nvcc per generated DEER source, all together ---------
    progs = {name: fcirc.prepare(c[0], c[1], dev, input_node=c[2]).prog
             for name, c in cases.items()}
    deers = {name: cg.deer_program(cases[name][0], prog) for name, prog in progs.items()}
    # the DEER sources, and the exact recursion's (B7) that the phase holds
    # them against
    sources = [d.source for d in deers.values()] + [prog.source for prog in progs.values()]
    builds = _build.build_generated.builds
    t0 = time.perf_counter()
    _build.build_generated(sources)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.build_generated(sources)
    cached_s = time.perf_counter() - t0
    nvcc_runs = _build.build_generated.builds - builds
    print(f"phase build deer sources={len(set(sources))} (B9 {len(deers)}, B7 {len(progs)}) "
          f"nvcc_runs={nvcc_runs} cold_seconds={cold_s:.2f} cached_seconds={cached_s:.4f}",
          flush=True)
    # one cold nvcc of a DEER source, each alone in its process, all started
    # together: B9's sources of the Tube Screamer and its 2x16, and B5's
    jobs = {f"{name}_served": deers[name].source for name in ("ts", "ts_2x16")}
    jobs["b5_served"] = (_build.CSRC_DIR / "parallel_time_deer.cu").read_text()
    seconds = _nvcc_seconds(jobs)
    print("phase build deer nvcc_seconds (cold, one source a process, "
          f"{len(jobs)} started together) " + " ".join(
              f"{label}={sec:.2f}" for label, sec in seconds.items()), flush=True)
    spilled = {}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:  # one cuobjdump a library
        sass = {d.source: pool.submit(_sass_summary, _build.generated_path(d.source),
                                      DEER_SASS_KERNELS) for d in deers.values()}
    for name, d in deers.items():
        ptxas = _ptxas_kernels(d.source, kernel=DEER_PTXAS)
        print(f"  ptxas deer {name} states={d.n_state} deer_step_ops={d.ops_per_sample} "
              f"forward_step_ops={d.step_ops} " + " | ".join(
                  f"{k}: {r} registers, {ss}/{sl} bytes spilled (stores/loads)"
                  for k, (r, ss, sl) in ptxas.items()), flush=True)
        for line in sass[d.source].result():
            print(f"  sass deer {name} {line}", flush=True)
        cluster_ptxas = {k: v for k, v in ptxas.items() if k.startswith("deer_cluster_kernel")}
        _check(len(cluster_ptxas) == 1, f"B9 {name}: the cluster kernel alone")
        spilled.update({f"{name}/{k}": v for k, v in cluster_ptxas.items() if v[1] or v[2]})
    _check(not spilled, f"no spills in B9's cluster kernels: {spilled}")

    def launch_only(case, vin, **kw):
        """B9's launch alone, on arguments and outputs prepared once."""
        s0 = kw.pop("s0", None)
        ckt, params, node, neural, skw, _ = case
        skw = {**skw, **kw}
        mlp = params[ckt.root.name] if neural else None
        prep = fcirc.prepare(ckt, params, dev, input_node=node, neural_mlp=mlp)
        s0 = dc._state_vector(prep, ckt, None, vin) if s0 is None else s0
        return dc.launcher(ckt, prep, vin, s0, vin.shape[0] // dc.NB,
                           skw.get("sweeps", 8), skw.get("relax_passes", 2),
                           skw.get("damping", 1.0), skw.get("adapt_tol", 0.0),
                           dc.fused_deer_neural if neural else dc.fused_deer_circuit)

    # --- kernels deer circuit: B9 against plain and the exact recursion --------
    builds = _build.build_generated.builds
    plain_errs = {"circuit": [], "neural": []}
    unconverged = []
    k = 0
    for name, case in cases.items():
        kind = name.split("_")[0]
        for T in DC_T:
            k += 1
            vin = _dc_input(name, T, seed + 100 + k, dev)
            out, st, res, n = _dc_solve(case, vin)
            p_out, p_st, p_res, p_n = _dc_solve(case, vin, plain=True)
            e_out, e_st = _dc_exact(case, vin)
            torch.cuda.synchronize()
            vs_plain = max(_max_err(out, p_out), _state_err(st, p_st))
            vs_exact = max(_max_err(out, e_out), _state_err(st, e_st))
            plain_exact = max(_max_err(p_out, e_out), _state_err(p_st, e_st))
            res, p_res, n, p_n = (float(x) for x in (res, p_res, n, p_n))
            budget = DC_BUDGET[kind]
            converged = p_res < 1e-3
            plain_errs["neural" if case[3] else "circuit"].append(vs_plain)
            print(f"phase kernels deer circuit {name} T={T} sweeps_run={n:g} plain_sweeps_run="
                  f"{p_n:g} vs_plain={vs_plain:.3e} vs_exact={vs_exact:.3e} plain_vs_exact="
                  f"{plain_exact:.3e} budget={budget:g} residual={res:.3e} plain_residual="
                  f"{p_res:.3e} converged={converged}", flush=True)
            _check(bool(torch.isfinite(out).all()) and out.shape == vin.shape,
                   f"B9 {name} T={T} output finite, shaped")
            _check(n == p_n, f"B9 {name} T={T} runs as many sweeps as its plain version")
            if converged:
                _check(vs_plain <= budget and vs_exact <= budget and res < 1e-3,
                       f"B9 {name} T={T} within {budget:g} of plain and of the exact "
                       "recursion")
            else:  # same algorithm: the same trajectory, flagged in both versions
                unconverged.append(f"{name}/{T}")
                _check(vs_plain <= DC_UNCONVERGED_BUDGET and res > 1e-3,
                       f"B9 {name} T={T} within {DC_UNCONVERGED_BUDGET:g} of plain, flagged "
                       "by its residual as plain is")
    print(f"phase kernels deer circuit cases={k} unconverged(plain residual >= 1e-3)="
          f"{unconverged}", flush=True)
    # adaptive: the HPF exits early, at the granularity of 4, after the JAX
    # kernel's count on the same block (tests/test_torch_deer_circuit.py:
    # numpy seed 2, 0.5 N(0, 1): the update drops from 4e-5 to 2.5e-6 at 20)
    hpf = cases["hpf"]
    quiet = torch.from_numpy((0.5 * np.random.default_rng(2).standard_normal(2048))
                             .astype(np.float32)).to(dev)
    _, _, res, n = _dc_solve(hpf, quiet)
    _, _, p_res, p_n = _dc_solve(hpf, quiet, plain=True)
    n, p_n = float(n), float(p_n)
    print(f"phase kernels deer circuit hpf adaptive numpy_seed=2 amplitude=0.5 T=2048 "
          f"sweeps_run={n:g} plain_sweeps_run={p_n:g} (JAX kernel: 20) cap=48", flush=True)
    _check(n == p_n == 20, "the adaptive HPF exits early as its plain version and JAX's")
    # two chained blocks against one solve: the 2x8 clipper on the card
    # test's input (numpy seed 115, 2 N(0, 1), then the same reversed)
    half = torch.from_numpy((2.0 * np.random.default_rng(115).standard_normal(2048))
                            .astype(np.float32)).to(dev)
    x = torch.cat([half, half.flip(0)])
    full = launch_only(cases["clip_2x8"], x)()[0].clone()
    a_out, a_zf = (t.clone() for t in launch_only(cases["clip_2x8"], x[:2048])()[:2])
    b_out = launch_only(cases["clip_2x8"], x[2048:], s0=a_zf)()[0]
    chained = _max_err(torch.cat([a_out, b_out]), full)
    print(f"phase kernels deer circuit clip_2x8 chained T=2x2048 two_blocks_vs_one_solve "
          f"C{dc.CLUSTER}={chained:.3e} budget=2e-06 (the JAX suite's for chained DEER blocks)",
          flush=True)
    _check(chained <= 2e-6, "two chained B9 blocks equal one solve")
    # hard overdrive: the Tube Screamer on 4 N(0, 1), 8 sweeps
    vin = 4.0 * torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(2048)
                                 .astype(np.float32)).to(dev)
    out, st, res, _ = _dc_solve(cases["ts"], vin)
    p_out, p_st, p_res, _ = _dc_solve(cases["ts"], vin, plain=True)
    e_out, _ = _dc_exact(cases["ts"], vin)
    err = _max_err(out, e_out)
    vs_plain = max(_max_err(out, p_out), _state_err(st, p_st))
    print(f"phase kernels deer circuit ts hard_overdrive amplitude=4 T=2048 residual="
          f"{float(res):.3e} plain_residual={float(p_res):.3e} (must exceed the fallback "
          f"tolerance 1e-03) vs_exact={err:.3e} vs_plain={vs_plain:.3e} "
          f"budget={DC_UNCONVERGED_BUDGET:g}", flush=True)
    _check(float(res) > 1e-3 and float(p_res) > 1e-3 and float(res) > err / 100,
           "the residual certificate flags a hard-overdrive block")
    _check(vs_plain <= DC_UNCONVERGED_BUDGET, "B9 holds to its plain version on a flagged block")
    # a drive change: a new slot value, no nvcc (a 440 Hz tone at 0.02, as
    # the circuit path's drive check)
    ts, ts_params = cases["ts"][:2]
    tone = 0.02 * torch.sin(2 * np.pi * 440.0 * torch.arange(2048, device=dev) / FS)
    dc.fused_deer_circuit(ts, ts_params, tone, static_controls={"R6": {"R": drive_to_r6(0.5)}})
    drive_builds, gains = _build.build_generated.builds, []
    for drive in (0.0, 1.0):
        out = dc.fused_deer_circuit(ts, ts_params, tone,
                                    static_controls={"R6": {"R": drive_to_r6(drive)}})[0]
        gains.append(float(out[1024:].abs().max() / tone.abs().max()))
    print(f"phase kernels deer circuit ts drive 0.0->1.0 peak_gain={gains[0]:.3f}->{gains[1]:.3f} "
          f"nvcc_runs={_build.build_generated.builds - drive_builds} (kernels phase nvcc_runs="
          f"{drive_builds - builds}: the static-control source)", flush=True)
    _check(_build.build_generated.builds == drive_builds, "a drive change runs no nvcc")
    _check(drive_builds - builds == 1, "the kernels phase ran only built kernels")
    _check(gains[1] > 2.0 * gains[0], "more drive, more gain")

    # --- stream plugin: the main path, counted ---------------------------------
    n_samples = STREAM_BLOCKS * STREAM_BLOCK
    audio = np.zeros((2, n_samples), np.float32)
    audio[:, :int(FS)] = _strum(seed, int(FS))
    blocks = [audio[:, i * STREAM_BLOCK:(i + 1) * STREAM_BLOCK] for i in range(STREAM_BLOCKS)]
    procs = {"plugin": {e: make_plugin_processor(FS, engine=e, device=dev)
                        for e in ("deer", "scan")},
             "hpf": {e: make_hpf_processor(FS, engine=e, device=dev) for e in ("deer", "scan")},
             "clipper": {e: make_clipper_processor(FS, engine=e, device=dev)
                         for e in ("deer", "scan")}}
    builds = _build.build_generated.builds
    t0 = time.perf_counter()
    warm = {(k, e): p.warmup([STREAM_BLOCK]) for k, d in procs.items() for e, p in d.items()}
    print(f"phase stream plugin warmup seconds={time.perf_counter() - t0:.2f} nvcc_runs="
          f"{_build.build_generated.builds - builds} n_compiled="
          f"{ {f'{k}/{e}': w['n_compiled'] for (k, e), w in warm.items()} }", flush=True)
    builds = _build.build_generated.builds
    for c in (dc.fused_deer_circuit, dc.fused_deer_neural, pd.fused_deer_clipper,
              fcirc.fused_circuit_process, fc.fused_clipper_analytic, fc.fused_clipper_neural):
        c.launches = 0
    fcirc.fused_circuit_process.pair_launches = 0
    deer, scan = procs["plugin"]["deer"], procs["plugin"]["scan"]
    scan_of = {(g, m): ({"B2": 1} if g == "clipper" and m < 2 else
                        {"B7": 1} if g == "tube_screamer" else {"B1": 1})
               for g, m in PLUGIN_MEMBERS}
    deer_of = {(g, m): ({"B5": 1} if g == "clipper" and m < 2 else
                        {"B9": 1} if (g, m) == ("tube_screamer", 0) else {"B9n": 1})
               for g, m in PLUGIN_MEMBERS}
    errs, wrong, outs, residuals, flagged = {}, [], {}, {}, []
    t0 = time.perf_counter()
    for i, blk in enumerate(blocks):
        group, model, gain, knobs = _plugin_block(i)
        key = f"{group}/{model}"
        fallbacks = deer.fallbacks.get(key, 0)
        got = {name: _counted(lambda name=name, proc=proc: outs.__setitem__(
            name, proc.process_block(blk, group, model=model, gain_db=gain, **knobs)))
            for name, proc in (("deer", deer), ("scan", scan))}
        # a block whose residual the kernel flags is served again by the
        # exact engine from the same state (the JAX processor's contract):
        # its one DEER launch, then the exact engine's one
        want = dict(deer_of[(group, model)])
        if deer.fallbacks.get(key, 0) > fallbacks:
            flagged.append((i, key, float(f"{deer.last_residual[key]:.3e}")))
            want.update(scan_of[(group, model)])
        if got != {"deer": want, "scan": scan_of[(group, model)]}:
            wrong.append((i, got))
        errs[key] = max(errs.get(key, 0.0), float(np.abs(outs["deer"] - outs["scan"]).max()))
        residuals[key] = max(residuals.get(key, 0.0), deer.last_residual[key])
        _check(outs["deer"].shape == (2, STREAM_BLOCK) and np.isfinite(outs["deer"]).all()
               and np.array_equal(outs["deer"][0], outs["deer"][1]),
               "served block finite, stereo, fanned out from mono")
    stream_s = time.perf_counter() - t0
    print(f"phase stream plugin deer+scan blocks={STREAM_BLOCKS}x{STREAM_BLOCK} stereo fs={FS:g} "
          f"members={len(errs)} seconds={stream_s:.3f} deer_vs_scan max_abs_err="
          f"{max(errs.values()):.3e} budget={PLUGIN_BUDGET:g} by_member="
          f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } max_residual_by_member="
          f"{ {k: float(f'{v:.3e}') for k, v in residuals.items()} } flagged_blocks(block, "
          f"member, residual)={flagged} wrong_launch_blocks={wrong}", flush=True)
    _check(len(errs) == len(PLUGIN_MEMBERS), "every plugin member served")
    _check(max(errs.values()) <= PLUGIN_BUDGET, "plugin deer serves the scan's output")
    _check(not wrong, "every served block is one kernel launch (a flagged block: one more, the "
                      "exact engine's)")
    _check(sum(v for k, v in deer.fallbacks.items() if "/" in k) == len(flagged)
           <= len(PLUGIN_FLAGGED_SEED0), "the exact engine serves only the flagged blocks, a few")
    if seed == 0:
        _check({i: key for i, key, _ in flagged} == PLUGIN_FLAGGED_SEED0,
               "the flagged blocks are the strum's attack through the known members")
    odd = blocks[5][:, :1000]
    odd_launch = {name: _counted(lambda name=name, proc=proc: outs.__setitem__(
        name, proc.process_block(odd, "tube_screamer", model=0, gain_db=3.0)))
        for name, proc in (("deer", deer), ("scan", scan))}
    print(f"phase stream plugin odd_block T=1000 tube_screamer/0 residual="
          f"{deer.last_residual['tube_screamer/0']} launches={odd_launch}", flush=True)
    _check(deer.last_residual["tube_screamer/0"] == 0.0
           and odd_launch == {"deer": {"B7": 1}, "scan": {"B7": 1}},
           "a 1000-sample block is served by B7 at B=1")
    # the HPF processor's four members, two blocks each
    hd, hs = procs["hpf"]["deer"], procs["hpf"]["scan"]
    h_err, h_launch = {}, []
    for i, member in enumerate(("toms", "approx", "extrapolated", "trained")):
        for j in range(2):
            blk = blocks[2 * i + j + 1]
            got = {name: _counted(lambda name=name, proc=proc: outs.__setitem__(
                name, proc.process_block(blk, "hpf", model=member, gain_db=3.0,
                                         cutoff_hz=(200.0, 800.0)[j])))
                   for name, proc in (("deer", hd), ("scan", hs))}
            h_launch.append(got == {"deer": {"B9n" if i > 1 else "B9": 1}, "scan": {"B7": 1}})
            h_err[member] = max(h_err.get(member, 0.0),
                                float(np.abs(outs["deer"] - outs["scan"]).max()))
    print(f"phase stream hpf deer_vs_scan by_member="
          f"{ {k: float(f'{v:.3e}') for k, v in h_err.items()} } budget={HPF_BUDGET:g} "
          f"residuals={ {k: float(f'{v:.3e}') for k, v in hd.last_residual.items()} } "
          f"fallbacks={hd.fallbacks} one_launch_per_block={all(h_launch)}", flush=True)
    _check(max(h_err.values()) <= HPF_BUDGET and all(h_launch) and hd.fallbacks == {},
           "the HPF processor's deer engine serves the scan's output in one launch")
    # the clipper processor's neural member under deer
    nd, ns = procs["clipper"]["deer"], procs["clipper"]["scan"]
    n_err = []
    for j in range(3):
        blk = blocks[j + 2]
        got = {name: _counted(lambda name=name, proc=proc: outs.__setitem__(
            name, proc.process_block(blk, "clipper", model="neural_2x16", gain_db=6.0,
                                     cutoff_hz=3000.0)))
               for name, proc in (("deer", nd), ("scan", ns))}
        _check(got == {"deer": {"B9n": 1}, "scan": {"B1": 1}}, "one launch serves neural_2x16")
        n_err.append(float(np.abs(outs["deer"] - outs["scan"]).max()))
    print(f"phase stream clipper neural_2x16 deer_vs_scan={max(n_err):.3e} "
          f"budget={NEURAL_BUDGET:g} residual={nd.last_residual['neural_2x16']:.3e} "
          f"fallbacks={nd.fallbacks}", flush=True)
    _check(max(n_err) <= NEURAL_BUDGET and nd.fallbacks == {}
           and nd.last_residual["neural_2x16"] < 1e-4, "the neural clipper under deer")
    launches = _all_launches()  # the main path's count
    print(f"phase stream plugin launches={launches} (B7 diode-pair lane form at B = 1: "
          f"{fcirc.fused_circuit_process.pair_launches}) nvcc_runs="
          f"{_build.build_generated.builds - builds}", flush=True)
    _check(all(v > 0 for v in launches.values()), "every single-stream kernel launched")
    _check(_build.build_generated.builds == builds, "no served block ran nvcc after warmup")

    # --- timing deer circuit ----------------------------------------------------
    timing = {}
    bench = torch.from_numpy((2.0 * np.random.default_rng(seed + 9).standard_normal(16384))
                             .astype(np.float32)).to(dev)  # bench.py:647-651, 723-726
    rows = [("ts", "ts", _dc_input("ts", 2048, seed + 4, dev), {}),
            ("ts bench", "ts", bench, {"sweeps": 10, "relax_passes": 4}),
            ("ts_2x16", "ts_2x16", _dc_input("ts", 2048, seed + 4, dev), {}),
            ("hpf fixed", "hpf", _dc_input("hpf", 16384, seed + 5, dev), {"adapt_tol": 0.0}),
            ("hpf adaptive", "hpf", _dc_input("hpf", 16384, seed + 5, dev), {}),
            ("clip_2x16", "clip_2x16", _dc_input("clip", 2048, seed + 6, dev), {})]
    for label, name, vin, kw in rows:
        case = cases[name]
        forms = _forms_in_turns({f"C{dc.CLUSTER}": launch_only(case, vin, **kw)})
        ckt, params, node, neural = case[:4]
        prep = fcirc.prepare(ckt, params, dev, input_node=node,
                             neural_mlp=params[ckt.root.name] if neural else None)
        clusters = dc.max_active_clusters(ckt, prep)
        t0 = time.perf_counter()
        _, _, p_res, p_n = _dc_solve(case, vin, plain=True, **kw)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        _, _, res, n = _dc_solve(case, vin, **kw)
        res, n = float(res), float(n)
        skw = {**case[4], **kw}
        d = deers[name]
        T = vin.shape[0]
        ops = _dc_ops(d, T, int(n), skw.get("relax_passes", 2), skw.get("damping", 1.0),
                      skw.get("adapt_tol", 0.0))
        bound = _bound(ops, 8 * T + 8 * d.n_state + 8)
        dev_ms = forms[f"C{dc.CLUSTER}"][3]
        timing[label] = (dev_ms, p_ms, bound)
        print(f"phase timing deer circuit {label} T={T} sweeps_run={n:g} runs={REPS} "
              f"(10 launches per run; device: launches back to back) "
              f"{_forms_line(forms)} plain_ms={p_ms:.1f} (host clock, one run) residual="
              f"{res:.3e} ops={ops} bound_ms={bound[0]:.6f} ({bound[1]}) "
              f"share={bound[0] / dev_ms:.5f} max_active_clusters={clusters} "
              f"card={card!r}", flush=True)
        if label in ("ts bench", "hpf fixed"):
            parts = _breakdown(lambda sw, r: launch_only(case, vin, **{
                **kw, "sweeps": sw, "relax_passes": r, "adapt_tol": 0.0}), int(n),
                skw.get("relax_passes", 2))
            print(f"phase timing deer circuit {label} breakdown C{dc.CLUSTER} (device) {parts} "
                  f"card={card!r}", flush=True)
    block_audio_ms = STREAM_BLOCK / FS * 1e3
    x0 = blocks[1]
    served = [("plugin", e, g, m, kw) for e in ("deer", "scan")
              for g, m, kw in (("clipper", 0, {"cutoff_hz": 4000.0}),
                               ("clipper", 4, {"cutoff_hz": 4000.0}),
                               ("multi_diode_clipper", 0, {"cutoff_hz": 4000.0}),
                               ("tube_screamer", 0, {"drive": 0.5}),
                               ("tube_screamer", 1, {"drive": 0.5}))]
    served += [("hpf", e, "hpf", m, {"cutoff_hz": 4000.0}) for e in ("deer", "scan")
               for m in ("toms", "trained")]
    served += [("clipper", e, "clipper", "neural_2x16", {"cutoff_hz": 4000.0})
               for e in ("deer", "scan")]
    for proc_name, engine, group, model, kw in served:
        proc = procs[proc_name][engine]
        member = model if isinstance(model, str) else f"{group}/{model}"

        def serve():
            proc.process_block(x0, group, model=model, **kw)

        serve()
        fallbacks = proc.fallbacks.get(member, 0)
        wall = _wall_ms(serve)
        ms = statistics.median(wall)
        fell = proc.fallbacks.get(member, 0) - fallbacks
        # where a block's time goes: the device's share, and the host's
        # largest self-time operations
        prof, traced = _profiled_blocks(serve)
        dev_events = [ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(ev.time_range.elapsed_us() for ev in dev_events) / 10
        kernel_us = sum(ev.time_range.elapsed_us() for ev in dev_events if any(
            k in ev.name for k in SERVED_KERNEL_NAMES)) / 10
        host = sorted((ev for ev in prof.key_averages() if ev.self_cpu_time_total > 0),
                      key=lambda ev: -ev.self_cpu_time_total)[:3]
        print(f"phase timing stream {proc_name} engine={engine} {member} "
              f"block={STREAM_BLOCK} process_block_wall_ms={ms:.4f} [{min(wall):.4f}, "
              f"{max(wall):.4f}] real_time_factor={block_audio_ms / ms:.2f} "
              f"fallbacks={fell}/{WALL_REPS} residual={proc.last_residual[member]:.3e} per block (profiled, "
              f"10 blocks): device_ops={len(dev_events) / 10:g} device_us={dev_us:.1f} "
              f"serving_kernels_us={kernel_us:.1f} {traced} "
              f"device_busy_share={dev_us / 1e3 / ms:.3f} host_top_self_us="
              f"{ {ev.key: round(ev.self_cpu_time_total / 10, 1) for ev in host} } "
              f"card={card!r}", flush=True)
    records = []
    for entry, label in (("circuit", "ts bench"), ("neural", "clip_2x16")):
        kms, p_ms, bound = timing[label]
        records.append({
            "name": f"fused_deer_{entry} (deer_cluster_kernel<{dc.CLUSTER}>)", "route": "cuda",
            "source": CIRCUIT_SOURCE,
            "replaces": DC_REPLACES[entry],
            "launches": launches["B9" if entry == "circuit" else "B9n"],
            "max_abs_err": max(plain_errs[entry]), "ms": kms, "plain_ms": p_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None})
    return records


# --- pretraining, circuit sweeps, model-zoo ensembles, the DEER oracle ------

PRETRAIN_DIODE = diode_1n4148_1u1d
PRETRAIN_EPOCHS = 5  # epochs of each pretraining run (the reference runs 2,000)
PRETRAIN_SEEDS = 8
PRETRAIN_TIMED = 3  # epochs timed after one warm-up epoch
HIST_RTOL = 5e-4  # the JAX suite's training-history tolerance (tests/test_clipper_train.py:186)
SWEEP_N, SWEEP_T = 1024, 2048  # BASELINE.json configuration 4
GEN_BUDGET_B7 = 2e-5  # the generated circuit kernel's (tests/test_fused_circuit.py:55-118)
ORACLE_T = 2048
ORACLE_BUDGET = {"clipper": (1e-4, 1e-5), "ts": (5e-4, 1e-4)}  # (error, residual),
# tests/test_parallel_time.py:28,63 and :26,62
ORACLE_ITERS = {"clipper": 16, "ts": 20}  # the JAX suite's Newton sweeps for each


def _pretrain_epoch_ms(cfg, seeds, dev, graph: bool):
    """(median ms of an epoch, capture seconds) of a pretraining run of
    ``seeds`` at ``cfg``: CUDA events around PRETRAIN_TIMED epochs after a
    warm-up epoch, replayed from the captured graphs or stepped eagerly."""
    cfg = tp.PretrainConfig(**{**cfg.__dict__, "epochs": PRETRAIN_TIMED + 1})
    tr = tp._Trainer(PRETRAIN_DIODE, cfg, seeds, dev)
    with tp._matmul_precision(cfg.matmul_precision):
        capture_s, graphs = 0.0, None
        if graph:
            t0 = time.perf_counter()
            graphs = tr._capture()
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
        tr.epoch(graphs)
        ms = _cuda_ms(lambda: tr.epoch(graphs), PRETRAIN_TIMED)
    return statistics.median(ms), capture_s


def pretrain_path(dev, card: str, seed: int) -> list:
    """Pretraining as a user drives it (the reference ladder's 2x16 1U-1D
    rung at the full grid, a few epochs): graph-replayed epochs against
    eager ones bit for bit, eight seeds at once against one, the epoch's
    time, and the trained root saved, reloaded and served by B1."""
    cfg = tp.PretrainConfig(n_layers=2, layer_size=16, epochs=PRETRAIN_EPOCHS, seed=seed)
    n = cfg.n_r * cfg.n_a
    n_batches = n // cfg.batch_size
    t0 = time.perf_counter()
    params, acts, hist = tp.pretrain_diode(PRETRAIN_DIODE, cfg, device=dev)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    eager = tp._Trainer(PRETRAIN_DIODE, cfg, [seed], dev)
    e_hist = eager.run(False)
    e_params = eager.params(False)
    same = all(np.array_equal(hist[k], e_hist[k][0]) for k in hist) and all(
        torch.equal(a[k], b[k]) for a, b in zip(params["layers"], e_params["layers"])
        for k in ("kernel", "bias"))
    seeds = tuple(range(seed, seed + PRETRAIN_SEEDS))
    s_params, _, s_hist = tp.pretrain_diode_multiseed(PRETRAIN_DIODE, cfg, seeds, device=dev)
    seed0 = max(float(np.max(np.abs(s_hist[k][0] / hist[k] - 1.0))) for k in hist)
    print(f"phase pretrain {cfg.n_layers}x{cfg.layer_size} {PRETRAIN_DIODE.name} grid={n} "
          f"steps_per_epoch={n_batches} batch={cfg.batch_size} lr={cfg.learning_rate} "
          f"epochs={cfg.epochs} loss={hist['loss'].tolist()} mse_last={hist['mse'][-1]:.4e} "
          f"esr_last={hist['esr'][-1]:.4e} graph_equals_eager={same} "
          f"seeds={len(seeds)} seed0_vs_single_rel={seed0:.3e} "
          f"loss_last_per_seed={[float(f'{x:.4e}') for x in s_hist['loss'][:, -1]]} "
          f"wall_s={graph_s:.2f} card={card!r}", flush=True)
    _check(same, "graph-replayed pretraining epochs equal eager ones bit for bit")
    _check(seed0 <= HIST_RTOL, "multiseed seed 0 matches the single-seed run")
    _check(all(np.isfinite(v).all() for v in (*hist.values(), *s_hist.values())),
           "pretraining histories finite")
    _check(hist["loss"][-1] < hist["loss"][0], "pretraining loss falls")

    timing = {}
    for label, s, graph in (("1 seed graph", (seed,), True), ("1 seed eager", (seed,), False),
                            (f"{PRETRAIN_SEEDS} seeds graph", seeds, True)):
        timing[label] = _pretrain_epoch_ms(cfg, s, dev, graph)
    for label, (ms, cap_s) in timing.items():
        print(f"phase timing pretrain {label} epoch_ms={ms:.3f} steps_per_s={n_batches / ms * 1e3:.0f} "
              f"seed_steps_per_s={n_batches * int(label.split()[0]) / ms * 1e3:.0f} "
              f"capture_s={cap_s:.2f} extrapolated_2000_epochs_s={cap_s + 2.0 * ms:.1f} "
              f"card={card!r}", flush=True)

    final = tp.evaluate_pretrained(params, acts, PRETRAIN_DIODE, cfg, device=dev)
    tc = {r: transconductance_error(params, acts, PRETRAIN_DIODE, r=r) for r in (1e3, 47e3)}
    _check(all(np.isfinite(v) for v in (*final.values(), *tc.values())),
           "evaluate_pretrained and transconductance_error finite")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "pretrained_2x16.json"
        save_model_json(params, acts, path)
        mlp, acts_back, _ = load_model_json(path, device=dev)
    _check(tuple(acts_back) == tuple(acts) and all(
        torch.equal(a[k], b[k]) for a, b in zip(mlp["layers"], params["layers"])
        for k in ("kernel", "bias")), "the saved model loads back to the same weights")
    vin = torch.from_numpy((2.0 * np.random.default_rng(seed).standard_normal((1, 2048)))
                           .astype(np.float32)).to(dev)
    z0 = torch.zeros(1, device=dev)
    out, zf = fc.fused_clipper_neural(vin, z0, mlp, R_SRC, CAP, fs=FS)
    want, want_z = fc.fused_clipper_neural_plain(vin, z0, mlp, R_SRC, CAP, fs=FS)
    err = max(_max_err(out, want), _max_err(zf, want_z))
    print(f"phase pretrain evaluate mse={final['mse']:.4e} esr={final['esr']:.4e} "
          f"transconductance_error_1k={tc[1e3]:.4f} transconductance_error_47k={tc[47e3]:.4f} "
          f"served_by_B1_b1_err={err:.2e} budget={BUDGET['neural']:g} card={card!r}", flush=True)
    _check(err <= BUDGET["neural"], "the pretrained root served by B1 matches its plain version")
    return []


def full_pretrain(dev, card: str, seed: int, epochs: int) -> None:
    """The reference ladder's 2x16 1U-1D rung trained in full: ``epochs``
    epochs of PRETRAIN_SEEDS seeds at once at the full grid; the wall
    seconds and each seed's final MSE and ESR on the grid."""
    cfg = tp.PretrainConfig(n_layers=2, layer_size=16, epochs=epochs, seed=seed)
    seeds = tuple(range(seed, seed + PRETRAIN_SEEDS))
    t0 = time.perf_counter()
    stacked, acts, hist = tp.pretrain_diode_multiseed(PRETRAIN_DIODE, cfg, seeds, device=dev)
    wall_s = time.perf_counter() - t0  # the histories came back to the host: the card is done
    finals = [tp.evaluate_pretrained({"layers": [{k: v[i] for k, v in layer.items()}
                                                 for layer in stacked["layers"]]},
                                     acts, PRETRAIN_DIODE, cfg, device=dev)
              for i in range(len(seeds))]
    mses, esrs = [f["mse"] for f in finals], [f["esr"] for f in finals]
    best = int(np.argmin(mses))
    print(f"phase full pretrain {cfg.n_layers}x{cfg.layer_size} {PRETRAIN_DIODE.name} "
          f"grid={cfg.n_r * cfg.n_a} epochs={epochs} seeds={list(seeds)} wall_s={wall_s:.1f} "
          f"mse={[float(f'{m:.4e}') for m in mses]} "
          f"esr={[float(f'{e:.4e}') for e in esrs]} "
          f"loss_last={[float(f'{x:.4e}') for x in hist['loss'][:, -1]]} "
          f"median_mse={float(np.median(mses)):.4e} best_seed={seeds[best]} "
          f"best_mse={mses[best]:.4e} best_esr={esrs[best]:.4e} card={card!r}",
          flush=True)
    _check(all(np.isfinite(m) for m in mses), "full pretraining finite")


def sweep_path(dev, card: str, seed: int) -> list:
    """Circuit sweeps and model-zoo ensembles: BASELINE configuration 4 (the
    LPF clipper with 1,024 source resistances, one B7 launch) and the seven
    checked-in 2x16 roots over one input (one NxH launch each).  Returns
    B7's record in this form for the JSON line."""
    ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), FS,
                             r_source=R_SRC, cap=CAP)
    params = ckt.init_params(dev)
    r = torch.from_numpy(np.geomspace(1e3, 1e5, SWEEP_N).astype(np.float32)).to(dev)
    rng = np.random.default_rng(seed)
    n = np.arange(SWEEP_T)
    vin = torch.from_numpy((2.0 * np.sin(2 * np.pi * 440.0 * n / FS)
                            + 0.1 * rng.standard_normal(SWEEP_T)).astype(np.float32)).to(dev)
    inputs = {"Vs": {"v": vin}}

    fcirc.fused_circuit_process.launches = 0
    out = sweep_process(ckt, params, {"Vs.R": r}, inputs, device=dev)
    torch.cuda.synchronize()
    sweep_launches = fcirc.fused_circuit_process.launches
    _check(sweep_launches == 1, "a sweep of 1,024 instances is one B7 launch")
    _check(bool(torch.isfinite(out).all()) and out.shape == (SWEEP_N, SWEEP_T),
           "sweep output finite, shaped")
    vin_n = vin.expand(SWEEP_N, -1).contiguous()
    z0 = {"C": {"z": torch.zeros(SWEEP_N, device=dev)}}
    rows = {"Vs": {"R": r}}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want, _ = fcirc.fused_circuit_process_plain(ckt, params, vin_n, z0, input_node="Vs",
                                                row_controls=rows)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    held = torch.linspace(0, SWEEP_N - 1, 64, device=dev).long()
    sweep_err = _max_err(out[held, :256], want[held, :256])
    full_err = _max_err(out, want)
    e = (out[:, 32:] ** 2).mean(dim=1)
    falls = bool(e[0] > e[-1])
    sweep_ms = statistics.median(_cuda_ms(
        lambda: sweep_process(ckt, params, {"Vs.R": r}, inputs, device=dev), REPS))
    prep = fcirc.prepare(ckt, params, dev, input_node="Vs", row_controls=rows,
                         shape=(SWEEP_N, SWEEP_T))
    zs = torch.zeros(1, SWEEP_N, device=dev)
    launch_ms = statistics.median(_cuda_ms(lambda: fcirc.launch(prep, vin_n, zs), REPS, 10))
    # the function's bytes: the shared input and the N resistances read, the
    # (N, T) output written; operations: the generated step per sample
    bound = _bound(prep.prog.ops_per_sample * SWEEP_N * SWEEP_T,
                   4 * SWEEP_T + 4 * SWEEP_N + 4 * SWEEP_N * SWEEP_T)
    print(f"phase sweep clipper Vs.R=1k..100k N={SWEEP_N} T={SWEEP_T} launches={sweep_launches} "
          f"held_64x256_err={sweep_err:.2e} all_rows_err={full_err:.2e} "
          f"budget={GEN_BUDGET_B7:g} energy_falls_with_R={falls} "
          f"energy_1k={float(e[0]):.4f} energy_100k={float(e[-1]):.4f} card={card!r}", flush=True)
    _check(sweep_err <= GEN_BUDGET_B7 and full_err <= GEN_BUDGET_B7, "sweep matches plain")
    _check(falls, "output energy falls with the source resistance")
    print(f"phase timing sweep sweep_process_ms={sweep_ms:.4f} launch_ms={launch_ms:.4f} "
          f"samples_per_s={SWEEP_N * SWEEP_T / launch_ms * 1e3:.4e} plain_ms={plain_ms:.1f} "
          f"bound_ms={bound[0]:.6f} ({bound[1]}) share={bound[0] / launch_ms:.4f} "
          f"(10 launches per run, {REPS} runs) card={card!r}", flush=True)

    zoo = sorted((Path(__file__).resolve().parent / "models" / "pretrained")
                 .glob("*_2x16_pretrained_model.json"))
    loaded = [load_model_json(p, device=dev) for p in zoo]
    acts = loaded[0][1]
    _check(len(loaded) == 7 and all(tuple(a) == tuple(acts) for _, a, _ in loaded),
           "seven checked-in 2x16 roots of one architecture")
    stack = stack_mlp_params([m for m, _, _ in loaded])
    evin = torch.from_numpy((2.0 * rng.standard_normal(SWEEP_T)).astype(np.float32)).to(dev)
    factory = lambda root: make_diode_clipper(root, FS, r_source=R_SRC, cap=CAP)  # noqa: E731
    fcirc.fused_circuit_process.launches = 0
    t0 = time.perf_counter()
    eout = ensemble_process(factory, stack, acts, {"Vs": {"v": evin}}, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0  # the first call builds the NxH program
    ens_launches = fcirc.fused_circuit_process.launches
    ens_ms = statistics.median(_cuda_ms(
        lambda: ensemble_process(factory, stack, acts, {"Vs": {"v": evin}}, device=dev), REPS))
    _check(ens_launches == len(zoo), "one B7 launch per expert")
    eckt = factory(NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16, activations=tuple(acts)))
    ens_err = 0.0
    for i, (mlp, _, _) in enumerate(loaded):
        w, _ = fcirc.fused_circuit_process_neural_plain(
            eckt, eckt.init_params(dev), mlp, evin[None], {"C": {"z": torch.zeros(1, device=dev)}},
            input_node="Vs")
        ens_err = max(ens_err, _max_err(eout[i], w[0]))
    spread = min(_max_err(eout[i], eout[j]) for i in range(len(zoo)) for j in range(i))
    print(f"phase ensemble {len(zoo)} zoo 2x16 roots T={SWEEP_T} launches={ens_launches} "
          f"err={ens_err:.2e} budget={GEN_BUDGET_B7:g} least_pairwise_diff={spread:.3e} "
          f"ensemble_process_ms={ens_ms:.3f} first_call_s={first_s:.2f} "
          f"members={[p.name.split('_')[0] for p in zoo]} "
          f"card={card!r}", flush=True)
    _check(ens_err <= GEN_BUDGET_B7, "every expert matches its plain version")
    _check(spread > 1e-4, "the experts differ from each other")
    return [{"name": "fused_circuit_process (sweep: 1,024 rows of row controls; ensemble: NxH "
                     "lane form a member)", "route": "cuda", "source": CIRCUIT_SOURCE,
             "replaces": CIRCUIT_REPLACES, "launches": sweep_launches + ens_launches,
             "max_abs_err": max(full_err, ens_err), "ms": launch_ms, "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}]


def oracle_path(dev, card: str, seed: int) -> list:
    """B5 (the LPF clipper) and B9 (the Tube Screamer) against the
    parallel-in-time oracle (ops/parallel_time.py: the circuit's own step,
    plain torch ops) on the card, at the same circuit and input, the oracle
    at the JAX suite's sweeps and budgets with its residual below bound."""
    d = diode_1n4148_1u1d
    rng = np.random.default_rng(seed)
    n = np.arange(ORACLE_T)
    vin = torch.from_numpy((2.0 * np.sin(2 * np.pi * 330.0 * n / FS)
                            + 0.1 * rng.standard_normal(ORACLE_T)).astype(np.float32)).to(dev)
    out, _, res = pd.fused_deer_clipper(vin, R_SRC, CAP, d.Is, d.Vt * d.nabla, d.N_up, d.N_down,
                                        fs=FS)
    ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=d), FS, r_source=R_SRC, cap=CAP)
    cases = {"clipper": (ckt, ckt.init_params(dev), "Vs", vin, out, res)}
    ts = _dc_case("ts", dev)
    tvin = _dc_input("ts", ORACLE_T, seed, dev)
    tout, _, tres, _ = _dc_solve(ts, tvin)
    cases["ts"] = (ts[0], ts[1], ts[2], tvin, tout, tres)
    for name, (c, p, node, x, kernel_out, kernel_res) in cases.items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want, resid = parallel_time_process(c, p, {node: {"v": x}}, n_iters=ORACLE_ITERS[name],
                                            return_residual=True, device=dev)
        end.record()
        end.synchronize()
        err = _max_err(kernel_out, want)
        budget, res_bound = ORACLE_BUDGET[name]
        kernel = "B5 fused_deer_clipper" if name == "clipper" else "B9 fused_deer_circuit"
        print(f"phase oracle {name} {kernel} T={ORACLE_T} vs parallel_time_process "
              f"n_iters={ORACLE_ITERS[name]} err={err:.2e} budget={budget:g} "
              f"oracle_residual={float(resid):.2e} bound={res_bound:g} "
              f"kernel_residual={float(kernel_res):.2e} oracle_ms={start.elapsed_time(end):.1f} "
              f"card={card!r}", flush=True)
        _check(float(resid) < res_bound, f"the {name} oracle converged")
        _check(err <= budget, f"{kernel} within the JAX suite's budget of the oracle")
    return []


# ---------------------------------------------------------------------------
# The deploy artifact (runtime/artifact.py) and its ops (ops/registry.py)
# ---------------------------------------------------------------------------

#: the export-artifact command's defaults (48 kHz, block 2,048, cutoff 4 kHz)
ART_FS, ART_BLOCK, ART_BLOCKS, ART_CUTOFF = 48000.0, 2048, 8, 4000.0
ART_CASES = ("zoo0", "zoo4", "ts")
#: op -> (kernel, the artifact it serves, budget against the plain version:
#: the JAX suite's kernel-vs-scan budgets)
OPS = {"clipper_analytic": ("B2", "zoo0", 5e-6), "clipper_neural": ("B1", "zoo4", 2e-5),
       "circuit_forward": ("B7", "ts", 2e-5)}
OP_REPLACES = {"clipper_analytic": REPLACES["analytic"], "clipper_neural": REPLACES["neural"],
               "circuit_forward": CIRCUIT_REPLACES}
OP_SOURCE = "diffwdf_tpu_torch/ops/registry.py"


def _art_case(name: str, dev):
    """(circuit, params, input node, input amplitude) of an artifact case:
    the export-artifact command's clipper (zoo 0, zoo 4 at its cutoff) and
    Tube Screamer (analytic, drive 0.5)."""
    if name == "ts":
        root = DiodePairRoot(name="dp")
        ckt = make_tube_screamer(root, ART_FS, drive=0.5)
        return ckt, {**ckt.init_params(dev), **root.init_params(dev)}, "Vin", 0.5
    root, frag = make_root_from_zoo(int(name[3:]), device=dev)
    ckt = make_diode_clipper(root, ART_FS, r_source=cutoff_to_resistance(ART_CUTOFF, CAP),
                             cap=CAP)
    return ckt, {**ckt.init_params(dev), **frag}, "Vs", 2.0


def _op_call(op: str, case, vin, z0):
    """(the op's result, the direct wrapper call's result, the plain
    version's result or None) on vin (B, T), z0 (B,) or (S, B)."""
    ckt, params, node, _ = case
    if op == "clipper_analytic":
        args = _diode_pair_args(params, {}, ckt.root.name)
        return (lambda: registry.clipper_analytic(vin, z0, *args, ckt.fs, ckt.root.iters),
                lambda: fc.fused_clipper_analytic(vin, z0, *args, fs=ckt.fs,
                                                  quality_iters=ckt.root.iters),
                lambda: fc.fused_clipper_analytic_plain(vin, z0, *args, fs=ckt.fs,
                                                        quality_iters=ckt.root.iters))
    if op == "clipper_neural":
        r, cap = float(params["Vs"]["R"]), float(params["C"]["C"])
        mlp = params[ckt.root.name]
        return (lambda: registry.clipper_neural(vin, z0, registry.mlp_layers(mlp), r, cap,
                                                ckt.fs),
                lambda: fc.fused_clipper_neural(vin, z0, mlp, r, cap, fs=ckt.fs),
                lambda: fc.fused_clipper_neural_plain(vin, z0, mlp, r, cap, fs=ckt.fs))
    prep = fcirc.prepare(ckt, params, vin.device, input_node=node)
    order = prep.prog.state_order
    st = {}
    for k, (n, f) in enumerate(order):
        st.setdefault(n, {})[f] = z0[k]

    def wrapper(plain=False):
        fn = fcirc.fused_circuit_process_plain if plain else fcirc.fused_circuit_process
        out, zf = fn(ckt, params, vin, st, input_node=node)
        return out, torch.stack([zf[n][f] for n, f in order])

    return (lambda: registry.circuit_forward(prep.prog.source, prep.prog.host_source, vin, z0,
                                             prep.vec, prep.rows, prep.times, prep.warr,
                                             fcirc.lanes_for(prep.prog, vin.shape[0])),
            wrapper, lambda: wrapper(True))


def _wrapper_launches() -> dict:
    return {"B1": fc.fused_clipper_neural.launches, "B2": fc.fused_clipper_analytic.launches,
            "B7": fcirc.fused_circuit_process.launches}


def _reset_wrapper_launches() -> None:
    fc.fused_clipper_neural.launches = fc.fused_clipper_analytic.launches = 0
    fcirc.fused_circuit_process.launches = 0


def artifact_path(dev, card: str, seed: int) -> list:
    """The deploy artifact and the ops it holds: build, ops, serve, exact,
    chunks and timing artifact phases.  Returns the three ops' records."""
    rng = np.random.default_rng(seed)
    cases = {name: _art_case(name, dev) for name in ART_CASES}
    signal = (rng.standard_normal(ART_BLOCKS * ART_BLOCK) * 0.5).astype(np.float32)
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        paths, meta = {}, {}
        for name, (ckt, params, node, _) in cases.items():
            paths[name] = str(Path(tmp) / f"{name}.pt2")
            t0 = time.perf_counter()
            meta[name] = save_artifact(paths[name], ckt, params, input_node=node,
                                       block_len=ART_BLOCK, fs=ART_FS)
            print(f"phase artifact export {name} kernel={meta[name]['kernel']!r} "
                  f"bytes={os.path.getsize(paths[name])} export_s={time.perf_counter() - t0:.3f} "
                  f"card={card!r}", flush=True)

        # --- build: each artifact's first load, in a fresh build directory
        # (cold) and again with its libraries on disk (cached); B1 and B2
        # launch the package's kernel library (phase build), the CPU runs
        # their plain versions
        saved_dir, build = _build.BUILD_DIR, {}
        try:
            _build.BUILD_DIR = Path(tmp) / "build"
            for cache in ("cold", "cached"):
                _build._generated_libs.clear()
                _build._host_libs.clear()
                for name in ART_CASES:
                    for where in ("cuda", "cpu"):
                        n0, h0 = _build.build_generated.builds, _build.build_host.builds
                        t0 = time.perf_counter()
                        art = load_artifact(paths[name], device=where)
                        art.process(art.init_state, np.zeros(ART_BLOCK, np.float32))
                        torch.cuda.synchronize()
                        build[name, where, cache] = (time.perf_counter() - t0,
                                                     _build.build_generated.builds - n0,
                                                     _build.build_host.builds - h0)
        finally:
            _build.BUILD_DIR = saved_dir
            _build._generated_libs.clear()
            _build._host_libs.clear()
        for name in ART_CASES:
            for where, tool in (("cuda", "nvcc"), ("cpu", "c++")):
                (cold, nv, cx), (cached, nv2, cx2) = (build[name, where, c]
                                                      for c in ("cold", "cached"))
                runs = nv + cx
                print(f"phase artifact build {name} device={where} first_load_cold_s={cold:.3f} "
                      f"{tool}_runs={runs} first_load_cached_s={cached:.3f} "
                      f"cached_compiler_runs={nv2 + cx2} card={card!r}", flush=True)
                _check(nv2 + cx2 == 0, f"a cached load of {name} runs no compiler")
                _check(runs == (1 if name == "ts" else 0),
                       f"{name}'s first load on {where} builds only its generated kernel")

        # --- ops: each op against its direct wrapper call, bit for bit, and
        # against its plain version at the served shape
        errs, plain_ms = {}, {}
        for op, (kernel, name, budget) in OPS.items():
            S = len(cg.state_order(cases[name][0]))
            for b in (1, B):
                gen = torch.Generator(device=dev).manual_seed(seed + b)
                vin = cases[name][3] * torch.randn(b, ART_BLOCK, generator=gen, device=dev)
                z0 = torch.zeros((S, b) if op == "circuit_forward" else (b,), device=dev)
                call, wrapper, plain = _op_call(op, cases[name], vin, z0)
                got, want = call(), wrapper()
                equal = all(torch.equal(x, y) for x, y in zip(got, want))
                line = f"phase artifact ops {op} ({kernel}) shape=({b}, {ART_BLOCK}) " \
                       f"equals_wrapper={equal}"
                if b == 1:  # the plain version's one run, timed by CUDA events
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    ref = plain()
                    end.record()
                    end.synchronize()
                    plain_ms[op] = start.elapsed_time(end)
                    errs[op] = max(_max_err(x, y) for x, y in zip(got, ref))
                    line += f" max_abs_err_vs_plain={errs[op]:.3e} budget={budget:g}"
                print(f"{line} card={card!r}", flush=True)
                _check(equal, f"op {op} equals its wrapper bit for bit at B = {b}")
            _check(errs[op] <= budget, f"op {op} within its budget of the plain version")

        # --- serve: the main path of the ops, each artifact loaded on the
        # card answering ART_BLOCKS blocks with the state carried; each op
        # counts in its wrapper's counter, set to 0 just before
        _reset_wrapper_launches()
        arts = {name: load_artifact(paths[name], device="cuda") for name in ART_CASES}
        served = {}
        for name, art in arts.items():
            x = cases[name][3] / 0.5 * signal
            served[name] = art.run(x)
        launches = _wrapper_launches()
        print(f"phase artifact serve blocks={ART_BLOCKS}x{ART_BLOCK} launches={launches} "
              f"finite={all(np.isfinite(y).all() for y in served.values())} card={card!r}",
              flush=True)
        _check(all(launches[kernel] == ART_BLOCKS for kernel, _, _ in OPS.values()),
               "one op launch per served block")
        _check(all(np.isfinite(y).all() for y in served.values()), "artifact outputs finite")

        # --- exact: the artifact's blocks against the stream's exact runner,
        # bit for bit; chunks against one call over the whole signal
        for name, art in arts.items():
            ckt, params, node, _ = cases[name]
            run = _lpf_exact_runner(ckt) if node == "Vs" else _generic_exact_runner(ckt, node)
            x = cases[name][3] / 0.5 * signal
            state, st, equal, blocks = art.init_state, ckt.init_state(dev), True, []
            for i in range(0, len(x), ART_BLOCK):
                v = torch.from_numpy(x[i: i + ART_BLOCK]).to(dev)
                y, state = art.process(state, v)
                want, st = run(params, st, {node: {"v": v}}, {})
                equal = equal and torch.equal(y, want)
                blocks.append(y.cpu().numpy())
            one, _ = run(params, ckt.init_state(dev), {node: {"v": torch.from_numpy(x).to(dev)}},
                         {})
            whole = np.array_equal(served[name], one.cpu().numpy())
            manual = np.array_equal(served[name], np.concatenate(blocks))
            scan, _ = ckt.process(params, ckt.init_state(dev),
                                  {node: {"v": torch.from_numpy(x[:ART_BLOCK]).to(dev)}})
            scan_err = float(np.max(np.abs(served[name][:ART_BLOCK] - scan.cpu().numpy())))
            print(f"phase artifact exact {name} blocks_equal_exact_runner={equal} "
                  f"chunked_equals_one_call={whole} run_equals_process_loop={manual} "
                  f"first_block_vs_scan={scan_err:.3e} card={card!r}", flush=True)
            _check(equal, f"{name}: the artifact's blocks are the exact runner's, bit for bit")
            _check(whole and manual, f"{name}: chunked output equals one-shot output")

        # --- timing: an artifact block's host wall against the exact
        # runner's, in turns; each op at (1, block) (its plain version was
        # timed once in the ops check)
        for name, art in arts.items():
            ckt, params, node, amp = cases[name]
            run = _lpf_exact_runner(ckt) if node == "Vs" else _generic_exact_runner(ckt, node)
            v = torch.from_numpy(amp * signal[:ART_BLOCK]).to(dev)
            st0 = ckt.init_state(dev)
            fns = {"artifact": lambda: art.process(art.init_state, v),
                   "exact_runner": lambda: run(params, st0, {node: {"v": v}}, {})}
            walls = {k: [] for k in fns}
            for k in fns:
                fns[k]()
            for rep in range(WALL_REPS):
                for k in (fns if rep % 2 else reversed(list(fns))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fns[k]()
                    torch.cuda.synchronize()
                    walls[k].append((time.perf_counter() - t0) * 1e3)
            print(f"phase timing artifact {name} block={ART_BLOCK} reps={WALL_REPS} "
                  + " ".join(f"{k}_wall_ms={statistics.median(w):.4f}" for k, w in walls.items())
                  + f" card={card!r}", flush=True)
        for op, (kernel, name, budget) in OPS.items():
            ckt = cases[name][0]
            S = len(cg.state_order(ckt))
            vin = torch.from_numpy(cases[name][3] * signal[None, :ART_BLOCK]).to(dev)
            z0 = torch.zeros((S, 1) if op == "circuit_forward" else (1,), device=dev)
            call, _, _ = _op_call(op, cases[name], vin, z0)
            ms = _timed(call)[0]
            if op == "clipper_analytic":
                ops = _analytic_ops(ckt.root.iters) * ART_BLOCK
            elif op == "clipper_neural":
                ops = _neural_ops(16, 2) * ART_BLOCK
            else:
                prog = fcirc.prepare(ckt, cases[name][1], dev, input_node=cases[name][2]).prog
                ops = prog.ops_per_sample * ART_BLOCK
            bound_ms, by = _bound(ops, 8 * ART_BLOCK + 8 * S)
            print(f"phase timing artifact op {op} ({kernel}) shape=(1, {ART_BLOCK}) "
                  f"op_ms={ms:.4f} plain_ms={plain_ms[op]:.2f} bound_ms={bound_ms:.7f} ({by}) "
                  f"launches_on_main_path={launches[kernel]} card={card!r}", flush=True)
            records.append({
                "name": f"diffwdf_torch::{op} (torch.library op over {kernel})", "route": "cuda",
                "source": OP_SOURCE, "replaces": OP_REPLACES[op], "launches": launches[kernel],
                "max_abs_err": errs[op], "ms": ms, "plain_ms": plain_ms[op], "bound_ms": bound_ms,
                "bound_by": by, "library_ms": None})
    return records


# ---------------------------------------------------------------------------
# The command line (diffwdf_tpu_torch/cli.py), one subprocess a command
# ---------------------------------------------------------------------------

CLI_PARALLEL = 8  # subcommands at once (the machine's cores)
CLI_TIMEOUT_S = 400
CLI_SIM_S = 0.02  # seconds of the simulate commands' sine (tests/test_cli.py:185): over
# 0.05 s the parallel-in-time engine (12 Newton sweeps) leaves the Tube
# Screamer 2.4e-4 from the scan, in the JAX package as in the port
ENGINES_BUDGET = 5e-5  # the simulate engines against each other (tests/test_cli.py:189-191)
#: export-artifact --check against Circuit.process on its 2-V sine: 1e-5 for
#: the clippers (tests/test_artifact.py:46); the Tube Screamer's generated
#: kernel lies 2.289e-05 from the scan there, as the JAX package's own kernel
#: does on the CPU (tests/test_torch_cli.py), so it gets the engines' budget
CHECK_BUDGET = {"export_0": 1e-5, "export_4": 1e-5, "export_ts": ENGINES_BUDGET}


def _cli_wave(jobs: dict, cwd: Path, card: str) -> dict:
    """name -> argv: run ``python -m diffwdf_tpu_torch.cli argv`` for each,
    CLI_PARALLEL at a time, in ``cwd``.  Returns name -> (its last JSON
    line, wall seconds); a command that fails fails the run."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH")) if p)}
    todo, running, done = list(jobs.items()), {}, {}
    t_start = time.perf_counter()
    try:
        while todo or running:
            while todo and len(running) < CLI_PARALLEL:
                name, argv = todo.pop(0)
                log = open(cwd / f"{name}.log", "w")
                running[name] = (time.perf_counter(), log, subprocess.Popen(
                    [sys.executable, "-m", "diffwdf_tpu_torch.cli", *argv], cwd=cwd, env=env,
                    stdout=log, stderr=subprocess.STDOUT))
            for name, (t0, log, proc) in list(running.items()):
                if proc.poll() is not None:
                    log.close()
                    done[name] = (time.perf_counter() - t0, proc.returncode)
                    del running[name]
            _check(time.perf_counter() - t_start < CLI_TIMEOUT_S, "the cli phase's time limit")
            time.sleep(0.05)
    finally:
        for _, log, proc in running.values():
            proc.kill()
            proc.wait()
            log.close()
    out = {}
    for name, argv in jobs.items():
        wall, rc = done[name]
        text = (cwd / f"{name}.log").read_text()
        lines = [l for l in text.splitlines() if l.startswith("{")]
        if rc != 0 or not lines:
            print(f"phase cli {name} FAILED rc={rc} argv={argv}\n{text[-3000:]}", flush=True)
        _check(rc == 0 and bool(lines), f"cli {' '.join(argv[:1])} ({name}) exits 0 with JSON")
        out[name] = (json.loads(lines[-1]), wall)
        rec = {k: v for k, v in out[name][0].items() if not isinstance(v, (list, dict))}
        print(f"phase cli {name} wall_s={wall:.2f} argv={' '.join(argv)!r} {json.dumps(rec)} "
              f"card={card!r}", flush=True)
    return out


def cli_path(dev, card: str, seed: int) -> list:
    """Every subcommand of the command line in a subprocess on the card at a
    small but real size, its JSON line parsed and checked (finite output,
    the simulate engines within 5e-5, the artifacts' checks)."""
    import importlib.util

    from scipy.io import wavfile

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as tmp:
        cwd = Path(tmp)
        wavfile.write(cwd / "strum.wav", int(FS), _strum(seed, int(FS)).T)
        np.save(cwd / "signal.npy", (0.8 * _strum(seed + 1, int(FS))[0]).astype(np.float32))
        engines = ("scan", "fused", "pint", "native")
        circuits = ("clipper", "tube_screamer")
        wave_a = {
            "pretrain": ["pretrain", "--epochs", "5", "--out", "pre.json"],
            "train_fused": ["train-clipper", "--synthetic", "--data-dir", "data", "--epochs", "2",
                            "--max-chunks", "32", "--engine", "fused", "--out", "tf.json",
                            "--log", "tf.jsonl", "--log-every", "1"],
            **{f"simulate_{c}_{e}": ["simulate", "--circuit", c, "--seconds", str(CLI_SIM_S),
                                     "--engine", e, "--out", f"sim_{c}_{e}.npy"]
               for c in circuits for e in engines},
            "process": ["process", "--input", "strum.wav", "--engine", "deer", "--warmup",
                        "--out", "proc.wav"],
            "params": ["params"],
            "export_0": ["export-artifact", "--model", "0", "--block", "512", "--check",
                         "--out", "a0.pt2"],
            "export_4": ["export-artifact", "--model", "4", "--block", "512", "--check",
                         "--out", "a4.pt2"],
            "export_ts": ["export-artifact", "--circuit", "tube_screamer", "--block", "512",
                          "--check", "--out", "ats.pt2"],
            "fit_components": ["fit-components", "--epochs", "30"],
        }
        wave_b = {
            "train_fused_generic": ["train-clipper", "--data-dir", "data", "--epochs", "2",
                                    "--max-chunks", "32", "--engine", "fused_generic",
                                    "--out", "tg.json"],
            **{f"run_artifact_{a}": ["run-artifact", "--artifact", f"a{a}.pt2",
                                     "--input", "signal.npy", "--out", f"run_{a}.npy"]
               for a in ("0", "4", "ts")},
        }
        if has_mpl:
            wave_b["plot_history"] = ["plot", "history", "--history", "tf.jsonl",
                                      "--out", "history.png"]
            wave_b["plot_transconductance"] = ["plot", "transconductance", "--model-json",
                                               "pre.json", "--out", "tc.png"]
        print(f"phase cli matplotlib={'yes: plot runs' if has_mpl else 'no: plot skipped'} "
              f"parallel={CLI_PARALLEL} card={card!r}", flush=True)
        res = _cli_wave(wave_a, cwd, card)
        res.update(_cli_wave(wave_b, cwd, card))
        res.update(_cli_wave({"bench": ["bench"]}, cwd, card))  # alone on the card

        _check(all(r.get("device") == "cuda" for r, _ in res.values()), "every command on cuda")
        _check(np.isfinite(res["pretrain"][0]["mse"]) and np.isfinite(res["pretrain"][0]["esr"]),
               "pretrain finite")
        for name in ("train_fused", "train_fused_generic"):
            rec = res[name][0]
            _check(rec["train_chunks"] > 0 and np.all(np.isfinite(rec["loss"])),
                   f"{name} trains on finite losses")
        for c in circuits:
            outs = {e: np.load(cwd / f"sim_{c}_{e}.npy") for e in engines}
            errs = {e: float(np.max(np.abs(outs[e] - outs["scan"]))) for e in engines[1:]}
            print(f"phase cli simulate {c} engines_vs_scan={errs} budget={ENGINES_BUDGET:g} "
                  f"samples={len(outs['scan'])} card={card!r}", flush=True)
            _check(all(np.isfinite(o).all() and o.shape == (int(CLI_SIM_S * 48000),)
                       for o in outs.values()), f"simulate {c} outputs finite")
            _check(max(errs.values()) <= ENGINES_BUDGET, f"simulate {c}: the engines agree")
        rec = res["process"][0]
        _check(rec["blocks"] == -(-int(FS) // 2048) and rec["warmup_s"] > 0
               and np.isfinite(rec["peak"]), "process --engine deer --warmup")
        _check(set(res["params"][0]["circuits"]) ==
               {"clipper", "multi_diode_clipper", "tube_screamer"}, "params reflects the plugin")
        for name, budget in CHECK_BUDGET.items():
            _check(res[name][0]["check_max_abs_err"] <= budget, f"{name} --check")
        for a in ("0", "4", "ts"):
            y = np.load(cwd / f"run_{a}.npy")
            _check(y.shape == (int(FS),) and np.isfinite(y).all(), f"run-artifact {a} finite")
        rec = res["fit_components"][0]
        _check(np.isfinite(rec["loss"]), "fit-components finite")
        if has_mpl:
            _check((cwd / "history.png").stat().st_size > 0 and (cwd / "tc.png").stat().st_size
                   > 0 and np.isfinite(res["plot_transconductance"][0]["physics_rms_rel_err"]),
                   "plots written")
        rec = res["bench"][0]
        print(f"phase cli bench headline {rec['metric']} value={rec['value']:.1f} {rec['unit']} "
              f"ms={rec['ms']:.4f} B={rec['B']} T={rec['T']} card={rec['card']!r}", flush=True)
        _check(np.isfinite(rec["value"]) and rec["value"] > 0, "bench headline")
    return []


# ---------------------------------------------------------------------------
# The multi-device layer (parallel/): one rank under NCCL, two ranks sharing
# the card under gloo
# ---------------------------------------------------------------------------

#: the clipper's training batch less one chunk (1,337 - 1), so that one and
#: two ranks divide its rows; the TS 2x16's generic-training batch
PAR_ROWS, PAR_GEN_ROWS = TRAIN_CHUNKS - 1, GEN_B
#: time_block_scaling's and time_block_training_scaling's shapes, a rank
#: (samples, warm-up W), at 48 kHz
PAR_TB, PAR_TBT, PAR_FS = (16384, 256), (4096, 192), 48000.0
#: tests/test_parallel.py:128-213 (DP against one process) and :218-315 (the
#: time-block step against the whole row); time_block against B7 over the
#: whole signal, the exact handoff, and the sharded sweep against one run
PAR_LOSS_RTOL, PAR_GRAD_REL, PAR_PARAM_ATOL, PAR_TBT_GRAD = 1e-5, 1e-4, 5e-6, 1e-3
PAR_TB_BUDGET, PAR_EXACT_BUDGET, PAR_SWEEP_BUDGET = 1e-5, 1e-6, 1e-6
PAR_REPS = 5  # host-clock repetitions of a step in a rank
PAR_TIMEOUT_S = 420
PAR_SOURCE = "diffwdf_tpu_torch/parallel/"


def _root_leaves(params):
    return params["dp"]


def _par_counts() -> dict:
    return {"B3": fc.fused_clipper_neural_train_fwd.launches, "B4": ct.clipper_adjoint.launches,
            "B7": fcirc.fused_circuit_process.launches, "B8": pb.fused_backward.launches,
            "B7_lanes": fcirc.fused_circuit_process.lane_launches}


def _par_reset() -> None:
    fc.fused_clipper_neural_train_fwd.launches = ct.clipper_adjoint.launches = 0
    fcirc.fused_circuit_process.launches = pb.fused_backward.launches = 0
    fcirc.fused_circuit_process.lane_launches = 0


def _par_dp_case(name: str, dev, seed: int, rows: int):
    """(circuit, params, batches, config) of a DP case: the clipper's fused
    step (the pretrained 2x16 at 48 kHz, the train split's four source
    resistances one per row) or the TS 2x16's fused_generic step, each on
    ``rows`` rows of 2,048 samples made from ``seed``."""
    rng = np.random.default_rng(seed + (41 if name == "fused" else 42))
    x = rng.standard_normal((rows, CHUNK)).astype(np.float32)
    if name == "fused":
        root, frag = _pretrained_2x16(dev)
        ckt = make_training_clipper(root, TRAIN_FS, cap=TRAIN_CAP)
        r_train = np.array([rk * 1e3 for rk in R_KOHMS if rk != 45.2], np.float32)
        x *= 2.0
        batches = {"x": x, "y": np.tanh(0.5 * x), "r0": r_train[np.arange(rows) * 4 // rows]}
        params = {**ckt.init_params(dev), **frag}
    else:
        ckt, params, *_ = _gen_case("ts_2x16", dev, rows, CHUNK)
        x *= 0.5
        batches = {"x": x, "y": np.tanh(2.0 * x)}
    cfg = CircuitTrainConfig(batch_size=CHUNK, engine=name)
    return ckt, params, {k: torch.from_numpy(v) for k, v in batches.items()}, cfg


def _par_signal(seed: int, n: int) -> np.ndarray:
    return (1.5 * np.random.default_rng(seed + 43).standard_normal(n)).astype(np.float32)


def _par_lpf(dev):
    ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), PAR_FS)
    return ckt, ckt.init_params(dev)


def _par_train_clipper(dev):
    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    ckt = make_training_clipper(root, PAR_FS)
    return ckt, {**ckt.init_params(dev), **root.init_params(dev)}


def _par_tbt_data(seed: int, n: int):
    x = (0.8 * np.random.default_rng(seed + 44).standard_normal(n)).astype(np.float32)
    return x, np.tanh(x)


def _flat_np(tree) -> dict:
    """{leaf name: a numpy copy} of a params tree."""
    return {n: x.detach().cpu().numpy().copy()
            for n, x in zip(_leaf_names(tree), pb._flatten(tree)[0])}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _host_ms(fn, dev, reps: int = PAR_REPS) -> float:
    """Median host-clock ms of fn() ending in a synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _parallel_rank(rank: int, world: int, seed: int, sizes: dict) -> dict:
    """One rank of the parallel path (spawned): DP steps, time-block serving
    and its exact handoff, and with two ranks the time-block training step
    and the sharded sweep, with one rank the scaling suite.  Returns each
    phase's results and launches as numpy and numbers."""
    dev = torch.device(sizes["device"], torch.cuda.current_device()) \
        if sizes["device"] == "cuda" else torch.device("cpu")
    out = {"rank": rank, "world": world}
    data_mesh = make_mesh((world, 1), device=dev.type)
    time_mesh = make_mesh((1, world), device=dev.type)
    for name, rows in (("fused", sizes["rows"]), ("fused_generic", sizes["gen_rows"])):
        ckt, params, batches, cfg = _par_dp_case(name, dev, seed, rows)
        make_optimizer, dp_train, dp_eval, prepare = make_dp_train_step(
            ckt, cfg, data_mesh, _root_leaves, device=dev.type)
        _par_reset()
        p, b = prepare(params, batches)
        loss, _, grads = dp_train.grads_fn(p, b)
        opt = make_optimizer(p)
        dp_train(p, opt, b)
        _sync(dev)
        rec = {"loss": float(loss), "grads": _flat_np(grads), "p1": _flat_np(p["dp"]),
               "launches": _par_counts(), "rows": int(b["x"].shape[0])}
        rec["step_ms"] = _host_ms(lambda: dp_train(p, opt, b), dev, sizes["reps"])
        if world == 1:  # the single-process step on the same rows, in turns
            make_opt1, step1, _ = make_train_step(ckt, cfg, _root_leaves)
            leaves, rebuild = pb._flatten(p)
            p_one = rebuild([x.detach().clone() for x in leaves])
            opt1 = make_opt1(p_one)
            ms = {"dp": [], "single": []}
            for turn in ("single", "dp", "dp", "single"):
                fn = (lambda: step1(p_one, opt1, b)) if turn == "single" else \
                    (lambda: dp_train(p, opt, b))
                ms[turn].append(_host_ms(fn, dev, sizes["reps"]))
            rec["turns_ms"] = {k: min(v) for k, v in ms.items()}
        out[name] = rec

    ckt, params = _par_lpf(dev)
    T, W = sizes["tb"]
    x = _par_signal(seed, world * T)
    _par_reset()
    got = time_block_process(ckt, params, {"Vs": {"v": x}}, time_mesh, warmup=W,
                             device=dev.type)
    exact = time_block_process_exact(ckt, params, {"Vs": {"v": x}}, time_mesh, device=dev.type)
    out["tb"] = {"out": got.cpu().numpy(), "exact": exact.cpu().numpy(),
                 "launches": _par_counts()}
    xs = torch.from_numpy(x).to(dev)
    out["tb"]["ms"] = _host_ms(lambda: time_block_process(
        ckt, params, {"Vs": {"v": xs}}, time_mesh, warmup=W, device=dev.type), dev, sizes["reps"])
    if world == 1:  # the same T samples through B7 with no warm-up and no gather
        z0 = {"C": {"z": torch.zeros(1, device=dev)}}
        out["tb"]["control_ms"] = _host_ms(lambda: fcirc.fused_circuit_process(
            ckt, params, xs[None], z0, input_node="Vs"), dev, sizes["reps"])
        out["scaling"] = run_scaling_suite(device=dev.type)
        return out

    T, W = sizes["tbt"]
    ckt, params = _par_train_clipper(dev)
    x, y = _par_tbt_data(seed, world * T)
    cfg = CircuitTrainConfig(learning_rate=1e-3, skip_samples=50)
    make_optimizer, step, _ = make_time_block_train_step(ckt, cfg, time_mesh, warmup=W,
                                                         device=dev.type)
    _par_reset()
    loss, _, grads = step.grads_fn(params, x, y)
    out["tbt"] = {"loss": float(loss), "grads": _flat_np(grads), "launches": _par_counts()}
    opt = make_optimizer(params)
    out["tbt"]["step_ms"] = _host_ms(lambda: step(params, opt, x, y), dev, sizes["reps"])

    sckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), FS,
                              r_source=R_SRC, cap=CAP)
    sparams = sckt.init_params(dev)
    r = torch.from_numpy(np.geomspace(1e3, 1e5, sizes["sweep"][0]).astype(np.float32)).to(dev)
    n = np.arange(sizes["sweep"][1])
    vin = torch.from_numpy((2.0 * np.sin(2 * np.pi * 440.0 * n / FS)).astype(np.float32)).to(dev)
    _par_reset()
    sharded = sweep_process(sckt, sparams, {"Vs.R": r}, {"Vs": {"v": vin}}, data_mesh,
                            device=dev)
    launches = _par_counts()
    one = sweep_process(sckt, sparams, {"Vs.R": r}, {"Vs": {"v": vin}}, device=dev)
    out["sweep"] = {"err": _max_err(sharded, one), "shape": tuple(sharded.shape),
                    "launches": launches}
    return out


def _par_dp_reference(name: str, dev, seed: int, rows: int) -> dict:
    """The single-process step of a DP case on all its rows: the loss, the
    gradient of the root's leaves and the root after one Adam step."""
    ckt, params, batches, cfg = _par_dp_case(name, dev, seed, rows)
    batches = {k: v.to(dev) for k, v in batches.items()}
    make_optimizer, step, _ = make_train_step(ckt, cfg, _root_leaves)
    leaves, rebuild = pb._flatten(params["dp"])
    mlp = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss, _ = make_loss_fn(ckt, cfg)({**params, "dp": rebuild(mlp)}, batches)
    grads = torch.autograd.grad(loss, mlp)
    opt = make_optimizer(params)
    step(params, opt, batches)
    return {"loss": float(loss.detach()), "grads": dict(zip(_leaf_names(params["dp"]),
                                                   (g.cpu().numpy() for g in grads))),
            "p1": _flat_np(params["dp"])}


def _par_tbt_reference(dev, seed: int, n: int, skip: int = 50, make=_par_train_clipper):
    """The loss and gradient of the time-block step's loss over the whole
    row: the generic engine from zero state over n samples, the masked MSE +
    ESR from sample ``skip`` (tests/test_parallel.py:252-258), on the
    circuit and params of ``make(dev)``."""
    ckt, params = make(dev)
    x, y = (torch.from_numpy(a).to(dev) for a in _par_tbt_data(seed, n))
    f = pb.make_fused_circuit_train_generic(ckt, input_node="Vs")
    leaves, rebuild = pb._flatten(params)
    leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    z0 = [torch.zeros(1, device=dev) for _ in cg.state_order(ckt)]
    o = f(rebuild(leaves), x[None], z0)[0][0, skip:]
    t = y[skip:]
    se, te = torch.sum((o - t) ** 2), torch.sum(t ** 2)
    loss = se / t.numel() + torch.sqrt(se / (te + float(np.finfo(np.float32).eps)) / t.numel())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    zero = np.zeros(1, np.float32)
    return float(loss.detach()), {k: (g.cpu().numpy() if g is not None else zero)
                                  for k, g in zip(_leaf_names(params), grads)}


def _np_rel(got: dict, want: dict) -> float:
    _check(set(got) == set(want), f"the same leaves: {sorted(got)} / {sorted(want)}")
    return max(float(np.abs(got[k] - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-30)
               for k in want)


def _par_kernels(dev, card: str, seed: int, sizes: dict) -> dict:
    """B3 and B4 at a rank's DP shape (two ranks), B7 at a sharded-sweep
    rank's (the diode pair, half the source resistances as impedance rows;
    its plain version walks the rows' samples together, where at a
    time-block rank's B = 1 it takes ~30 s) and B8 (with B7's training form)
    at a time-block training rank's (the 1x8 clipper at B = 1), each
    wrapper against its plain version on the same inputs, timed beside it,
    with its bound.  Returns {kernel: (max_abs_err, ms, plain_ms, (bound_ms,
    by))}."""
    res = {}
    rows = sizes["rows"] // 2
    n_sw, t_sw = sizes["sweep"][0] // 2, sizes["sweep"][1]
    shapes = {"B3": (rows, CHUNK), "B4": (rows, CHUNK), "B7": (n_sw, t_sw),
              "B8": (1, sum(sizes["tbt"]))}
    root, frag = _pretrained_2x16(dev)
    rng = np.random.default_rng(seed + 45)
    x = torch.from_numpy((2.0 * rng.standard_normal((rows, CHUNK))).astype(np.float32)).to(dev)
    z0 = torch.zeros(rows, device=dev)
    r0 = torch.full((rows,), 25e3, device=dev)
    fwd_args = (x, z0, frag["dp"], r0, TRAIN_CAP)
    samples = rows * CHUNK

    def pair(fn, plain):
        """(max_abs_err, scaled error, kernel ms, plain ms): the plain
        version runs once, timed as it gives its result."""
        got, box = _tensors(fn()), []
        plain_ms = _cuda_ms(lambda: box.append(plain()), 1)[0]
        want = _tensors(box[0])
        err = max(_max_err(g, w) for g, w in zip(got, want))
        rel = max(_scaled_err(g, w) for g, w in zip(got, want))
        _cuda_ms(fn, 1, 2)
        return err, rel, statistics.median(_cuda_ms(fn, REPS, 10)), plain_ms

    b3 = pair(lambda: fc.fused_clipper_neural_train_fwd(*fwd_args, fs=TRAIN_FS),
              lambda: fc.fused_clipper_neural_train_fwd_plain(*fwd_args, fs=TRAIN_FS))
    res["B3"] = b3 + (_bound(_neural_ops(16, 2) * samples, 12 * samples + 12 * rows),)
    a_seq = fc.fused_clipper_neural_train_fwd(*fwd_args, fs=TRAIN_FS)[2]
    g_out = torch.from_numpy(rng.standard_normal((rows, CHUNK)).astype(np.float32)).to(dev)
    adj_args = (a_seq, g_out / samples, torch.zeros(rows, device=dev), r0, frag["dp"], TRAIN_CAP)
    b4 = pair(lambda: ct.clipper_adjoint(*adj_args, fs=TRAIN_FS),
              lambda: ct.clipper_adjoint_plain(*adj_args, fs=TRAIN_FS))
    res["B4"] = b4 + (_bound(_adjoint_ops(16, 2) * samples, 16 * samples + 12 * rows),)

    ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), FS,
                             r_source=R_SRC, cap=CAP)
    params = ckt.init_params(dev)
    r = torch.from_numpy(np.geomspace(1e3, 1e5, 2 * n_sw).astype(np.float32)[:n_sw]).to(dev)
    v = torch.from_numpy(_par_signal(seed, t_sw)).to(dev)[None].expand(n_sw, -1).contiguous()
    zs, rc = {"C": {"z": torch.zeros(n_sw, device=dev)}}, {"Vs": {"R": r}}
    b7 = pair(lambda: fcirc.fused_circuit_process(ckt, params, v, zs, input_node="Vs",
                                                  row_controls=rc),
              lambda: fcirc.fused_circuit_process_plain(ckt, params, v, zs, input_node="Vs",
                                                        row_controls=rc))
    prog = fcirc.prepare(ckt, params, dev, input_node="Vs", row_controls=rc,
                         shape=(n_sw, t_sw)).prog
    # as sweep_path's: the shared input and the resistances read, (N, T) written
    res["B7"] = b7 + (_bound(prog.ops_per_sample * n_sw * t_sw,
                             4 * t_sw + 4 * n_sw + 4 * n_sw * t_sw),)

    ckt, params = _par_train_clipper(dev)
    n = sum(sizes["tbt"])
    xv, _ = _par_tbt_data(seed, n)
    v = torch.from_numpy(xv).to(dev)[None]
    zs = {"C": {"z": torch.zeros(1, device=dev)}}
    _, _, seq = fcirc.fused_circuit_process(ckt, params, v, zs, input_node="Vs",
                                            return_state_seq=True)
    g = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).to(dev) / n
    lam = [torch.zeros(1, device=dev)]
    b8 = pair(lambda: pb.fused_backward(ckt, params, v, g, seq, lam, input_node="Vs")[:3],
              lambda: pb.fused_backward_plain(ckt, params, v, g, seq, lam, input_node="Vs")[:3])
    prog = fcirc.prepare(ckt, params, dev, input_node="Vs").prog
    adj = cg.adjoint_program(ckt, prog)
    res["B8"] = b8 + (_bound(adj.ops_per_sample * n, (3 + 2) * 4 * n + 8),)
    budgets = {"B3": ("abs", 2e-5), "B4": ("scaled", 2e-5), "B7": ("abs", GEN_BUDGET_B7),
               "B8": ("scaled", 1e-4)}
    for k, (err, rel, ms, plain_ms, bound) in res.items():
        kind, budget = budgets[k]
        print(f"phase kernels parallel {k} shape={shapes[k]} max_abs_err={err:.3e} "
              f"scaled_err={rel:.3e} budget={budget:g} ({kind}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.1f} bound_ms={bound[0]:.6f} ({bound[1]}) card={card!r}",
              flush=True)
        _check((err if kind == "abs" else rel) <= budget,
               f"{k} within its budget of its plain version at the parallel path's shape")
    return res


def _tensors(x) -> list:
    """The tensors of a result of tuples, lists and dicts (in key order)."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return [x]


def parallel_path(dev, card: str, seed: int) -> list:
    """The multi-device layer: the parallel phase's kernels against their
    plain versions, the single-process references here, then one rank under
    NCCL (the one-card deployment: DP fused and fused_generic steps,
    time-block serving and its exact handoff, the scaling suite) and two
    ranks sharing the card under gloo (the same, the time-block training
    step and the sharded sweep), each a spawned run with the launch counters
    of B3, B4, B7 and B8 read in every rank.  Returns the four kernels'
    records for the JSON line."""
    sizes = {"device": dev.type, "rows": PAR_ROWS, "gen_rows": PAR_GEN_ROWS, "tb": PAR_TB,
             "tbt": PAR_TBT, "sweep": (SWEEP_N, SWEEP_T), "reps": PAR_REPS}
    kern = _par_kernels(dev, card, seed, sizes)
    # the single-process references, which also build every generated source
    # the ranks load (a spawned rank finds each library built)
    t0 = time.perf_counter()
    refs = {name: _par_dp_reference(name, dev, seed, rows)
            for name, rows in (("fused", PAR_ROWS), ("fused_generic", PAR_GEN_ROWS))}
    ckt, params = _par_lpf(dev)
    serial = {}
    for world in (1, 2):
        x = torch.from_numpy(_par_signal(seed, world * PAR_TB[0])).to(dev)[None]
        serial[world] = fcirc.fused_circuit_process(
            ckt, params, x, {"C": {"z": torch.zeros(1, device=dev)}},
            input_node="Vs")[0][0].cpu().numpy()
    tbt_loss, tbt_grads = _par_tbt_reference(dev, seed, 2 * PAR_TBT[0])
    sckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), FS,
                              r_source=R_SRC, cap=CAP)
    half = torch.from_numpy(np.geomspace(1e3, 1e5, SWEEP_N // 2).astype(np.float32)).to(dev)
    sweep_process(sckt, sckt.init_params(dev), {"Vs.R": half},
                  {"Vs": {"v": torch.zeros(SWEEP_T, device=dev)}}, device=dev)
    torch.cuda.synchronize()
    print(f"phase parallel references seconds={time.perf_counter() - t0:.1f} (single-process "
          f"DP steps, B7 over the whole signals, the generic engine over the whole row)",
          flush=True)

    backends = {1: "nccl" if dev.type == "cuda" else "gloo", 2: "gloo"}
    runs = {}
    for world in (1, 2):
        t0 = time.perf_counter()
        runs[world] = spawn(_parallel_rank, world, seed, sizes, backend=backends[world],
                            device=dev.type, timeout_s=PAR_TIMEOUT_S)
        print(f"phase parallel spawn world={world} backend={backends[world]} seconds="
              f"{time.perf_counter() - t0:.1f}", flush=True)

    total = dict.fromkeys(("B3", "B4", "B7", "B8"), 0)
    for world, ranks in runs.items():
        label = ("one rank, NCCL" if world == 1
                 else "two ranks sharing one card, gloo (not scaling)")
        for name, kernels in (("fused", ("B3", "B4")), ("fused_generic", ("B7", "B8"))):
            ref = refs[name]
            for r in ranks:
                rec = r[name]
                loss_rel = abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])
                grad_rel = _np_rel(rec["grads"], ref["grads"])
                p_err = max(float(np.abs(rec["p1"][k] - ref["p1"][k]).max()) for k in ref["p1"])
                print(f"phase parallel dp {name} world={world} rank={r['rank']} rows="
                      f"{rec['rows']}x{CHUNK} loss={rec['loss']:.6e} loss_rel={loss_rel:.2e} "
                      f"(rtol {PAR_LOSS_RTOL:g}) grad_rel={grad_rel:.2e} ({PAR_GRAD_REL:g}) "
                      f"params_err={p_err:.2e} ({PAR_PARAM_ATOL:g}) launches={rec['launches']} "
                      f"step_ms={rec['step_ms']:.3f} ({label}) card={card!r}", flush=True)
                _check(loss_rel <= PAR_LOSS_RTOL and grad_rel <= PAR_GRAD_REL
                       and p_err <= PAR_PARAM_ATOL,
                       f"DP {name} at world {world} matches the single-process step")
                _check(all(rec["launches"][k] > 0 for k in kernels),
                       f"DP {name} launched {kernels} in rank {r['rank']} of {world}")
                for k in kernels:
                    total[k] += rec["launches"][k]
                if "turns_ms" in rec:
                    t = rec["turns_ms"]
                    print(f"phase timing parallel dp {name} world=1 dp_step_ms={t['dp']:.3f} "
                          f"single_process_step_ms={t['single']:.3f} ratio="
                          f"{t['dp'] / t['single']:.3f} ({rec['rows'] * CHUNK / t['dp'] / 1e3:.1f}"
                          f" Msamples/s; best of two turns, median of {PAR_REPS}) card={card!r}",
                          flush=True)
            for r in ranks[1:]:
                _check(all(r[name]["p1"][k].tobytes() == ranks[0][name]["p1"][k].tobytes()
                           for k in ref["p1"]), f"DP {name} replicas hold the same bits")
        T, W = PAR_TB
        for r in ranks:
            tb = r["tb"]
            err, exact_err = (_max_err(torch.from_numpy(tb[k]), torch.from_numpy(serial[world]))
                              for k in ("out", "exact"))
            print(f"phase parallel time_block world={world} rank={r['rank']} T={world}x{T} W={W} "
                  f"err={err:.2e} (budget {PAR_TB_BUDGET:g}) exact_err={exact_err:.2e} "
                  f"({PAR_EXACT_BUDGET:g}) launches={tb['launches']} ms={tb['ms']:.3f} "
                  f"samples_per_s={world * T / tb['ms'] * 1e3:.4e} ({label}) card={card!r}",
                  flush=True)
            _check(err <= PAR_TB_BUDGET and exact_err <= PAR_EXACT_BUDGET,
                   f"time-block serving at world {world} matches B7 over the whole signal")
            _check(tb["launches"]["B7"] > 0, f"time-block serving launched B7 in rank {r['rank']}")
            total["B7"] += tb["launches"]["B7"]
            if "control_ms" in tb:
                print(f"phase timing parallel time_block world=1 ms={tb['ms']:.3f} "
                      f"b7_alone_ms={tb['control_ms']:.3f} (the same {T} samples with no "
                      f"warm-up and no gather; W overhead {tb['ms'] / tb['control_ms']:.3f}x) "
                      f"card={card!r}", flush=True)
        if world == 1:
            suite = ranks[0]["scaling"]
            for curve in ("dp_training", "dp_control", "time_block", "time_block_control",
                          "time_block_training"):
                rec = suite[curve][1]
                rate = rec.get("items_per_s", rec.get("samples_per_s"))
                print(f"phase parallel scaling {curve} n=1 mean_s={rec['mean_s']:.6f} "
                      f"per_s={rate:.4e} efficiency={rec['efficiency']:.3f} env={suite['env']} "
                      f"card={card!r}", flush=True)
                _check(np.isfinite(rec["mean_s"]) and rec["mean_s"] > 0, f"scaling {curve}")
            continue
        for r in ranks:
            tbt = r["tbt"]
            loss_rel = abs(tbt["loss"] - tbt_loss) / abs(tbt_loss)
            grad_rel = _np_rel(tbt["grads"], tbt_grads)
            print(f"phase parallel time_block_train world=2 rank={r['rank']} T=2x{PAR_TBT[0]} "
                  f"W={PAR_TBT[1]} loss_rel={loss_rel:.2e} (rtol {PAR_LOSS_RTOL:g}) "
                  f"grad_rel={grad_rel:.2e} ({PAR_TBT_GRAD:g}, against the generic engine over "
                  f"the whole row) launches={tbt['launches']} step_ms={tbt['step_ms']:.3f} "
                  f"({label}) card={card!r}", flush=True)
            _check(loss_rel <= PAR_LOSS_RTOL and grad_rel <= PAR_TBT_GRAD,
                   "the time-block training step matches the whole row")
            _check(tbt["launches"]["B7"] > 0 and tbt["launches"]["B8"] > 0,
                   f"time-block training launched B7 and B8 in rank {r['rank']}")
            sw = r["sweep"]
            print(f"phase parallel sweep world=2 rank={r['rank']} shape={sw['shape']} "
                  f"sharded_vs_one_err={sw['err']:.2e} (budget {PAR_SWEEP_BUDGET:g}) "
                  f"launches={sw['launches']} card={card!r}", flush=True)
            _check(sw["err"] <= PAR_SWEEP_BUDGET and sw["shape"] == (SWEEP_N, SWEEP_T)
                   and sw["launches"]["B7"] > 0, "the sharded sweep equals the unsharded one")
            for k in ("B7", "B8"):
                total[k] += tbt["launches"][k]
            total["B7"] += sw["launches"]["B7"]

    names = {"B3": ("fused_clipper_neural_train_fwd", TRAIN_SOURCE, TRAIN_REPLACES["train_fwd"]),
             "B4": ("clipper_adjoint", TRAIN_SOURCE, TRAIN_REPLACES["adjoint"]),
             "B7": ("fused_circuit_process", CIRCUIT_SOURCE, CIRCUIT_REPLACES),
             "B8": ("fused_backward", CIRCUIT_SOURCE, BPTT_REPLACES)}
    return [{"name": f"{names[k][0]} (parallel path: {PAR_SOURCE}, every rank)", "route": "cuda",
             "source": names[k][1], "replaces": names[k][2], "launches": total[k],
             "max_abs_err": kern[k][0], "ms": kern[k][2], "plain_ms": kern[k][3],
             "bound_ms": kern[k][4][0], "bound_by": kern[k][4][1], "library_ms": None}
            for k in ("B3", "B4", "B7", "B8")]


# ---------------------------------------------------------------------------
# The roots the generated kernels took last (distilled_path): the distilled
# root's slope in B8 and B9, a general MLP root in B7's forward
# ---------------------------------------------------------------------------

#: B9 on the distilled clipper: within 1e-6 of its plain version and of B6's
#: scan (tests/test_deer_circuit.py:57), 1e-4 of the oracle (as B5's)
DIST_BUDGET, DIST_ORACLE_BUDGET = 1e-6, 1e-4
#: the fused_generic steps: (rows, samples), steps, the grad check's shape
DIST_B, DIST_T, DIST_STEPS = GEN_B, GEN_T, 5
DIST_GRAD_B, DIST_GRAD_T = GEN_GRAD_B, GEN_GRAD_T
DIST_ADJ_BUDGET, DIST_GRAD_BUDGET = 1e-4, 5e-4  # tests/test_parallel_bptt.py:537, :76-81
DIST_LR = 8e-11  # Adam's step on C (farads): 20% off the true 2.2 nF is 4.4e-10
#: the general MLP roots saved and loaded as JSON (2x8): activations
DIST_MLP = {"relu": ("tanh", "relu", "tanh", ""), "sigmoid": ("sigmoid", "sigmoid", "sigmoid", "")}
DIST_BLOCKS, DIST_TURNS = 47, 3  # served blocks of CHUNK; Circuit.process blocks in turns
DIST_MLP_BUDGET = 2e-5  # the generic forward's (tests/test_fused_circuit.py:55)
#: B7's lane forms of both roots also at the JAX bench's serving shape
DIST_SERVE = (B, T)
#: the general MLP root whose lane form is also timed at every K (the sweep)
DIST_MLP_SWEEP = "relu"


def _distilled(fs: float, r_source: float, cap: float):
    """The 1N4148 1U-1D pair, quality "best", distilled at the port R of the
    LPF clipper Vs(r_source) || C(cap) at fs (bench.py:364-371): (root, fit
    error)."""
    diode = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d, quality="best")
    return distill_root(diode, diode.init_params("cpu"), 1.0 / (1.0 / r_source + 2.0 * cap * fs))


def _dist_train_clipper(dev, cheb):
    """The training clipper (48 kHz, 45 kOhm, 4.7 nF: the time-block phase's
    circuit) with the distilled root of ``cheb`` = (a_max, breaks,
    coefficients)."""
    a_max, breaks, coeffs = cheb
    root = PiecewiseChebRoot(name="dp", a_max=a_max, breaks=breaks, coeffs=coeffs)
    ckt = make_training_clipper(root, PAR_FS)
    return ckt, ckt.init_params(dev)


def _dist_tbt_rank(rank: int, world: int, cheb, seed: int, device: str) -> dict:
    """One rank of the distilled root's time-block training step (spawned):
    the loss, the reduced gradient, the launches and the step's ms."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device("cpu")
    ckt, params = _dist_train_clipper(dev, cheb)
    T, W = PAR_TBT
    x, y = _par_tbt_data(seed, world * T)
    cfg = CircuitTrainConfig(learning_rate=1e-3, skip_samples=50)
    make_optimizer, step, _ = make_time_block_train_step(
        ckt, cfg, make_mesh((1, world), device=device), warmup=W, device=device)
    _par_reset()
    loss, _, grads = step.grads_fn(params, x, y)
    rec = {"loss": float(loss), "grads": _flat_np(grads), "launches": _par_counts()}
    opt = make_optimizer(params)
    rec["step_ms"] = _host_ms(lambda: step(params, opt, x, y), dev)
    return rec


def _mlp_root(name: str, dev, folder: Path):
    """A general 2x8 MLP root, seeded random weights, saved with
    save_model_json and loaded back as a user would: (root, params, path)."""
    seeded = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8, activations=DIST_MLP[name])
    frag = seeded.init_params(dev, torch.Generator().manual_seed(len(name)))
    path = folder / f"{name}.json"
    save_model_json(frag["dp"], seeded.activations, str(path))
    mlp, acts, _ = load_model_json(str(path), device=dev)
    root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    return root, frag, path


def _lanes_in_turns(forms: dict, x, z0, with_seq: bool, ref: str) -> dict:
    """label -> (median, min, max per-call CUDA-event ms of 10 calls, median
    device ms a launch) of B7's forms (label -> (prepared program, lanes)),
    in turns (``_forms_in_turns``), after a check that every form gives the
    ``ref`` form's bits: output, final state and the trajectory."""
    want = fcirc.launch(forms[ref][0], x, z0, with_seq, lanes=forms[ref][1])
    for label, (prep, lanes) in forms.items():
        got = fcirc.launch(prep, x, z0, with_seq, lanes=lanes)
        torch.cuda.synchronize()
        _check(all(torch.equal(g, w) for g, w in zip(got, want) if w is not None),
               f"B7's {label} form gives the {ref} form's bits at {tuple(x.shape)}")
    return _forms_in_turns({label: (lambda p=prep, k=lanes: fcirc.launch(p, x, z0, with_seq,
                                                                         lanes=k))
                            for label, (prep, lanes) in forms.items()})


def _lanes_line(times: dict, ref: str) -> str:
    return " ".join(f"{label}_ms={m:.4f} [{lo:.4f}, {hi:.4f}] {label}_device_ms={d:.4f}"
                    + ("" if label == ref else f" ({times[ref][0] / m:.3f}x)")
                    for label, (m, lo, hi, d) in times.items())


def _dist_lane_forms(dev, card, ckt, params, msweep, x, zs, fwd_err, mlp_ckts, seed) -> dict:
    """kernels distilled_path, B7's lane forms: each against the one-thread
    form (the same bits) and in turns with it; the distilled root's training
    form with the trajectory at (DIST_B, DIST_T) and at B = 1 (the time-block
    rank's), and served at DIST_SERVE beside B6; the general MLP roots at
    B = 1 (device time) and DIST_SERVE, DIST_MLP_SWEEP's at every K of
    ``msweep`` (its sweep program), and against their plain versions there.
    Returns the figures of the JSON records."""
    prep = fcirc.prepare(ckt, params, dev, input_node="Vs")
    k = fcirc.lanes_for(prep.prog, DIST_B)
    _check(fcirc.lanes_for(prep.prog, 1) == k, "the distilled root's lane form at every B")
    forms = {"one_thread": (prep, 1), f"k{k}": (prep, k)}
    train = _lanes_in_turns(forms, x, fcirc._state_stack(prep.prog, zs, x), True, "one_thread")
    print(f"phase kernels distilled_path B7 lanes distilled training form ({DIST_B}, {DIST_T}) "
          f"with trajectory, bits of one_thread, vs_plain={fwd_err:.3e} budget="
          f"{GEN_BUDGET_B7:g}: {_lanes_line(train, 'one_thread')} card={card!r}", flush=True)
    x1 = x[:1, :CHUNK].contiguous()
    one = _lanes_in_turns(forms, x1, fcirc._state_stack(prep.prog, _zero_state(ckt, x1), x1),
                          True, "one_thread")
    print(f"phase kernels distilled_path B7 lanes distilled training form (1, {CHUNK}) with "
          f"trajectory, bits of one_thread: {_lanes_line(one, 'one_thread')} card={card!r}",
          flush=True)
    _check(one[f"k{k}"][3] < one["one_thread"][3],
           "the distilled root's lane form is faster than one thread at B = 1 (device time)")
    rng = np.random.default_rng(seed + 48)
    xs = torch.from_numpy((2.0 * rng.standard_normal(DIST_SERVE)).astype(np.float32)).to(dev)
    z0 = torch.zeros(1, DIST_SERVE[0], device=dev)
    serve = _lanes_in_turns(forms, xs, z0, False, "one_thread")
    b6_ms = statistics.median(_cuda_ms(lambda: fc.fused_clipper_cheb(
        xs, z0[0], ckt.root, R_SRC, CAP, fs=FS), REPS, 10))
    print(f"phase kernels distilled_path B7 lanes distilled served {DIST_SERVE}, bits of "
          f"one_thread: {_lanes_line(serve, 'one_thread')} b6_ms={b6_ms:.4f} card={card!r}",
          flush=True)
    out = {"distilled": (k, train, fwd_err)}
    for name, (c, p) in mlp_ckts.items():
        mprep = fcirc.prepare(c, p, dev, input_node="Vs")
        k = fcirc.lanes_for(mprep.prog, 1)
        mforms = {"one_thread": (mprep, 1), f"k{k}": (mprep, k)}
        if name == DIST_MLP_SWEEP:
            mforms.update({f"k{j}": (mprep._replace(prog=msweep), j) for j in msweep.lanes[1:]
                           if j != k})
        v = torch.from_numpy(_strum(seed, CHUNK)[0]).to(dev)[None]
        one = _lanes_in_turns(mforms, v, torch.zeros(1, 1, device=dev), False, "one_thread")
        vs = torch.from_numpy((1.5 * rng.standard_normal(DIST_SERVE)).astype(np.float32)).to(dev)
        zs0 = _zero_state(c, vs)
        got, _ = fcirc.fused_circuit_process(c, p, vs, zs0, input_node="Vs")
        box = []
        plain_ms = _cuda_ms(lambda: box.append(fcirc.fused_circuit_process_plain(
            c, p, vs, zs0, input_node="Vs")), 1)[0]
        err = _max_err(got, box[0][0])
        many = _lanes_in_turns(mforms, vs, torch.zeros(1, DIST_SERVE[0], device=dev), False,
                               "one_thread")
        print(f"phase kernels distilled_path B7 lanes mlp {name} {DIST_MLP[name]} bits of "
              f"one_thread; (1, {CHUNK}): {_lanes_line(one, 'one_thread')}; {DIST_SERVE}: "
              f"{_lanes_line(many, 'one_thread')} vs_plain={err:.3e} budget="
              f"{DIST_MLP_BUDGET:g} plain_ms={plain_ms:.1f} card={card!r}", flush=True)
        _check(err <= DIST_MLP_BUDGET, f"B7's {name} lane form within 2e-5 of plain at "
                                       f"{DIST_SERVE}")
        out[name] = (k, one, many, err)
    return out


def distilled_path(dev, card: str, seed: int) -> list:
    """The roots that the generated kernels took last: build distilled (the
    new generated sources in one parallel nvcc, ptxas of every new kernel,
    the lane forms' spill check); kernels distilled_path (B9 on the distilled
    clipper against its plain version, B6 and the oracle; B7's lane forms
    against its one-thread form, in turns; B7's training form and B8 against theirs;
    the fused_generic gradients against the scan engine; B7's general MLP
    root against its plain version); then the path as a user drives it,
    the launch counters set to 0 before and read after: B9 serving the
    distilled clipper, five fused_generic steps training C, the time-block
    training step at one rank under NCCL, and a relu and a sigmoid JSON
    root served 47 blocks by the exact runner and by an artifact (one
    exported in-process, one by the export-artifact command, started first
    in a subprocess).  Returns the new forms' records for the JSON line."""
    t_path = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH")) if p)}
    with tempfile.TemporaryDirectory(prefix="distilled_path_") as tmp:
        folder = Path(tmp)
        mlps = {name: _mlp_root(name, dev, folder) for name in DIST_MLP}
        with open(folder / "export.log", "w") as cli_log:
            cli = subprocess.Popen(
                [sys.executable, "-m", "diffwdf_tpu_torch.cli", "export-artifact", "--model",
                 "3", "--model-json", str(mlps["relu"][2]), "--fs", str(FS), "--block",
                 str(CHUNK), "--check", "--out", str(folder / "relu.pt2")],
                cwd=folder, env=env, stdout=cli_log, stderr=subprocess.STDOUT)
            try:
                return _distilled_path(dev, card, seed, mlps, cli, folder, t_path)
            finally:
                if cli.poll() is None:
                    cli.kill()
                    cli.wait()


def _distilled_path(dev, card, seed, mlps, cli, folder, t_path) -> list:
    # --- build distilled ----------------------------------------------------
    droot, fit_err = _distilled(FS, R_SRC, CAP)
    ckt = make_diode_clipper(droot, FS, r_source=R_SRC, cap=CAP)
    params = ckt.init_params(dev)
    prog = fcirc.prepare(ckt, params, dev, input_node="Vs").prog
    adj, deer = cg.adjoint_program(ckt, prog), cg.deer_program(ckt, prog)
    mlp_ckts = {}
    for name, (root, frag, _) in mlps.items():  # at the export-artifact command's cutoff
        c = make_diode_clipper(root, FS, r_source=cutoff_to_resistance(ART_CUTOFF, CAP), cap=CAP)
        mlp_ckts[name] = (c, {**c.init_params(dev), **frag})
    mlp_progs = {name: fcirc.prepare(c, p, dev, input_node="Vs").prog
                 for name, (c, p) in mlp_ckts.items()}
    # one general MLP root's K sweep (a comparison build)
    msweep = cg.sweep_program(mlp_ckts[DIST_MLP_SWEEP][0], mlp_progs[DIST_MLP_SWEEP])
    sources = {"B7": prog.source, "B8": adj.source, "B9": deer.source,
               **{f"B7_{n}": p.source for n, p in mlp_progs.items()},
               f"B7_{DIST_MLP_SWEEP}_sweep": msweep.source}
    t0 = time.perf_counter()
    before = _build.build_generated.builds
    _build.build_generated(list(sources.values()))
    print(f"phase build distilled seconds={time.perf_counter() - t0:.2f} nvcc_runs="
          f"{_build.build_generated.builds - before} fit_err={fit_err:.3e} degrees="
          f"{tuple(len(c) - 1 for c in droot.coeffs)} slope_ops={prog.emitter.slope_ops} "
          f"root_ops={prog.emitter.ops} adjoint pass1_ops={adj.jacobian_ops} "
          f"deer_ops_per_sample={deer.ops_per_sample} "
          + " ".join(f"mlp_{n}_ops={p.ops_per_sample}" for n, p in mlp_progs.items()),
          flush=True)
    for label, src in sources.items():
        kernel = DEER_PTXAS if label == "B9" else r"\d+(circuit_\w*?kernel)"
        print(f"  ptxas {label} {_generated_ptxas(src, kernel=kernel)}", flush=True)
    pass1 = {k: v for k, v in _ptxas_kernels(adj.source).items()
             if k.startswith("circuit_jacobian")}
    cluster = {k: v for k, v in _ptxas_kernels(deer.source, kernel=DEER_PTXAS).items()
               if k.startswith("deer_cluster")}
    _check(pass1 and all(ss == sl == 0 for _, ss, sl in {**pass1, **cluster}.values()),
           f"no spill in B8's pass 1 and B9's cluster kernel: {pass1} {cluster}")
    for label, src in sources.items():
        if label.startswith("B7"):
            _check("circuit_lanes_kernel" in src, f"{label} has a lane form")
            _check_no_spills(src, f"{label}'s lane form")

    # --- kernels distilled_path: B9 --------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(seed + 5)  # stream_path's DEER inputs
    b9 = {}
    for T in DEER_T:
        vin = 2.0 * torch.randn(T, generator=gen, device=dev)
        out, st, res, n = dc.fused_deer_circuit(ckt, params, vin, input_node="Vs",
                                                return_info=True)
        box = []
        plain_ms = _cuda_ms(lambda: box.append(dc.fused_deer_circuit_plain(
            ckt, params, vin, input_node="Vs", return_info=True)), 1)[0]
        p_out, p_st, p_res, p_n = box[0]
        scan, z = fc.fused_clipper_cheb(vin[None], torch.zeros(1, device=dev), droot, R_SRC,
                                        CAP, fs=FS)
        errs = {"plain": max(_max_err(out, p_out), abs(float(st["C"]["z"] - p_st["C"]["z"]))),
                "b6": max(_max_err(out, scan[0]), abs(float(st["C"]["z"] - z[0])))}
        if T == ORACLE_T:
            want, resid = parallel_time_process(ckt, params, {"Vs": {"v": vin}},
                                                n_iters=ORACLE_ITERS["clipper"],
                                                return_residual=True, device=dev)
            errs["oracle"] = _max_err(out, want)
            _check(float(resid) < ORACLE_BUDGET["clipper"][1], "the oracle converged")
        prep = fcirc.prepare(ckt, params, dev, input_node="Vs")
        s0 = dc._state_vector(prep, ckt, None, vin)
        launch = dc.launcher(ckt, prep, vin, s0, T // dc.NB, 8, 2, 1.0, 0.0,
                             dc.fused_deer_circuit)
        dev_ms = statistics.median(_device_ms(launch) for _ in range(3))
        calls_ms = statistics.median(_cuda_ms(launch, REPS, 10))
        bound = _bound(_dc_ops(deer, T, 8, 2, 1.0, 0.0), 8 * T)
        b9[T] = (errs["plain"], dev_ms, plain_ms, bound)
        print(f"phase kernels distilled_path B9 T={T} input=2 N(0,1) vs_plain={errs['plain']:.3e} "
              f"vs_b6={errs['b6']:.3e} budget={DIST_BUDGET:g}"
              + (f" vs_oracle={errs['oracle']:.3e} budget={DIST_ORACLE_BUDGET:g} "
                 f"oracle_residual={float(resid):.2e}" if "oracle" in errs else "")
              + f" residual={float(res):.3e} plain_residual={float(p_res):.3e} sweeps="
              f"{int(n)} device_ms={dev_ms:.4f} launch_ms_10_calls={calls_ms:.4f} "
              f"plain_ms={plain_ms:.1f} bound_ms={bound[0]:.6f} ({bound[1]}) card={card!r}",
              flush=True)
        _check(bool(torch.isfinite(out).all()) and float(res) < 1e-5,
               f"B9 on the distilled clipper converged at T={T}")
        _check(errs["plain"] <= DIST_BUDGET and errs["b6"] <= DIST_BUDGET
               and errs.get("oracle", 0.0) <= DIST_ORACLE_BUDGET,
               f"B9 on the distilled root within its budgets at T={T}")
    quiet = 0.5 * torch.randn(DEER_T[0], generator=gen, device=dev)
    q_out, _, q_res = dc.fused_deer_circuit(ckt, params, quiet, input_node="Vs")
    q_plain, _, _ = dc.fused_deer_circuit_plain(ckt, params, quiet, input_node="Vs")
    q_err = _max_err(q_out, q_plain)
    print(f"phase kernels distilled_path B9 T={DEER_T[0]} input=0.5 N(0,1) vs_plain={q_err:.3e} "
          f"residual={float(q_res):.3e} card={card!r}", flush=True)
    _check(q_err <= DIST_BUDGET and float(q_res) < 1e-5, "B9 distilled on a quiet input")

    # --- kernels distilled_path: B7's training form and B8 --------------------
    rng = np.random.default_rng(seed + 47)
    x = torch.from_numpy((1.5 * rng.standard_normal((DIST_B, DIST_T))).astype(np.float32)).to(dev)
    zs = _zero_state(ckt, x)
    kw = dict(input_node="Vs", return_state_seq=True)
    out, _, seq = fcirc.fused_circuit_process(ckt, params, x, zs, **kw)
    box = []
    fwd_plain_ms = _cuda_ms(lambda: box.append(fcirc.fused_circuit_process_plain(
        ckt, params, x, zs, **kw)), 1)[0]
    p_out, _, p_seq = box[0]
    fwd_err = max(_max_err(out, p_out), _max_err(seq[0], p_seq[0]))
    lanes = _dist_lane_forms(dev, card, ckt, params, msweep, x, zs, fwd_err, mlp_ckts, seed)
    fwd_ms = lanes["distilled"][1]["one_thread"][0]  # in turns with the lane forms
    g_out = torch.from_numpy(rng.standard_normal((DIST_B, DIST_T)).astype(np.float32)).to(dev)
    g_out /= DIST_B * DIST_T
    lam = [torch.zeros(DIST_B, device=dev)]
    got = pb.fused_backward(ckt, params, x, g_out, seq, lam, input_node="Vs")
    box = []
    adj_plain_ms = _cuda_ms(lambda: box.append(pb.fused_backward_plain(
        ckt, params, x, g_out, seq, lam, input_node="Vs")), 1)[0]
    want = box[0]
    adj_err = max(_rel_err(got[1], want[1]), _rel_err(got[0][0], want[0][0]),
                  _rel_err(got[2][0], want[2][0]))
    adj_abs = max(_max_err(got[1], want[1]), _max_err(got[0][0], want[0][0]))
    adj_ms = statistics.median(_cuda_ms(lambda: pb.fused_backward(
        ckt, params, x, g_out, seq, lam, input_node="Vs"), REPS, 10))
    passes = _adjoint_passes(ckt, fcirc.prepare(ckt, params, dev, input_node="Vs"), x, g_out,
                             torch.stack(seq).contiguous(), torch.stack(lam).contiguous())
    pass_ms = [statistics.median(_cuda_ms(fn, REPS, 10)) for fn in passes]
    samples = DIST_B * DIST_T
    fwd_bound = _bound(prog.ops_per_sample * samples, (1 + 1 + 1) * 4 * samples + 8 * DIST_B)
    adj_bound = _bound(adj.ops_per_sample * samples, (3 + 2) * 4 * samples + 8 * DIST_B)
    print(f"phase kernels distilled_path B7 training form ({DIST_B}, {DIST_T}) vs_plain="
          f"{fwd_err:.3e} budget={GEN_BUDGET_B7:g} one_thread_ms={fwd_ms:.4f} plain_ms="
          f"{fwd_plain_ms:.1f} bound_ms={fwd_bound[0]:.6f} ({fwd_bound[1]}) card={card!r}",
          flush=True)
    print(f"phase kernels distilled_path B8 ({DIST_B}, {DIST_T}) vs_plain_rel={adj_err:.3e} "
          f"budget={DIST_ADJ_BUDGET:g} max_abs_err={adj_abs:.3e} kernel_ms={adj_ms:.4f} "
          f"pass1_ms={pass_ms[0]:.4f} pass2_ms={pass_ms[1]:.4f} plain_ms={adj_plain_ms:.1f} "
          f"bound_ms={adj_bound[0]:.6f} ({adj_bound[1]}) scratch_bytes="
          f"{_scratch_bytes(adj, DIST_B, DIST_T)} card={card!r}", flush=True)
    _check(fwd_err <= GEN_BUDGET_B7 and adj_err <= DIST_ADJ_BUDGET,
           "B7's training form and B8 on the distilled root within their budgets of plain")

    # --- grad distilled_path: the fused_generic op against the scan engine ----
    case = (ckt, params, "Vs", None, None, None, 1.5)
    gx = x[:DIST_GRAD_B, :DIST_GRAD_T].contiguous()
    gy = torch.tanh(gx)
    fused, fused_gv = _gen_grads(case, gx, gy, fused=True)
    scan, scan_gv = _gen_grads(case, gx, gy, fused=False)
    leaf_err = {k: _rel_err(fused[k], scan[k]) for k in scan}
    print(f"phase grad distilled_path ({DIST_GRAD_B}, {DIST_GRAD_T}) vs_scan_engine "
          + " ".join(f"{k}={e:.3e}" for k, e in leaf_err.items())
          + f" g_vin={_rel_err(fused_gv, scan_gv):.3e} budget={DIST_GRAD_BUDGET:g} per leaf "
          f"card={card!r}", flush=True)
    _check(all(e <= DIST_GRAD_BUDGET for e in leaf_err.values()),
           "the fused_generic gradients on the distilled root within 5e-4 of the scan engine")

    # --- kernels distilled_path: B7's general MLP root ---------------------------
    mlp_rec = {}
    for name, (c, p) in mlp_ckts.items():
        v = torch.from_numpy(_strum(seed, CHUNK)[0]).to(dev)[None]
        z1 = _zero_state(c, v)
        k_out, _ = fcirc.fused_circuit_process(c, p, v, z1, input_node="Vs")
        box = []
        plain_ms = _cuda_ms(lambda: box.append(fcirc.fused_circuit_process_plain(
            c, p, v, z1, input_node="Vs")), 1)[0]
        err = _max_err(k_out, box[0][0])
        dev_ms = lanes[name][1]["one_thread"][3]  # device time, in turns with the lane forms
        bound = _bound(mlp_progs[name].ops_per_sample * CHUNK, 8 * CHUNK)
        mlp_rec[name] = [err, dev_ms, plain_ms, bound]
        print(f"phase kernels distilled_path B7 mlp {name} {DIST_MLP[name]} (1, {CHUNK}) "
              f"vs_plain={err:.3e} budget={DIST_MLP_BUDGET:g} one_thread_device_ms={dev_ms:.4f} "
              f"plain_ms={plain_ms:.1f} bound_ms={bound[0]:.6f} ({bound[1]}) card={card!r}",
              flush=True)
        _check(err <= DIST_MLP_BUDGET, f"B7's general MLP root ({name}) within 2e-5 of plain")

    # --- the path as a user drives it, the counters set to 0 first -------------
    dc.fused_deer_circuit.launches = 0
    fcirc.fused_circuit_process.launches = pb.fused_backward.launches = 0
    outs = [dc.fused_deer_circuit(ckt, params, 2.0 * torch.randn(T, generator=gen, device=dev),
                                  input_node="Vs") for T in DEER_T]
    torch.cuda.synchronize()
    b9_launches = dc.fused_deer_circuit.launches
    _check(b9_launches == len(DEER_T) and all(bool(torch.isfinite(o[0]).all()) and
                                              float(o[2]) < 1e-5 for o in outs),
           "B9 served the distilled clipper, one launch a block, converged")

    # five fused_generic steps training C from 20% off, the target from B2
    d = diode_1n4148_1u1d
    y, _ = fc.fused_clipper_analytic(x, torch.zeros(DIST_B, device=dev), R_SRC, CAP, d.Is,
                                     d.Vt * d.nabla, d.N_up, d.N_down, fs=FS, quality_iters=3)
    start = {**params, "C": {"C": torch.tensor(1.2 * CAP, device=dev)}}
    cfg = CircuitTrainConfig(epochs=DIST_STEPS, batch_size=DIST_B, learning_rate=DIST_LR,
                             engine="fused_generic", log_every=1)
    step_ms = []

    def on_epoch(epoch, p, hist):
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - on_epoch.t0) * 1e3)
        on_epoch.t0 = time.perf_counter()

    fcirc.fused_circuit_process.launches = pb.fused_backward.launches = 0
    fcirc.fused_circuit_process.lane_launches = 0
    torch.cuda.synchronize()
    on_epoch.t0 = time.perf_counter()
    trained, hist = train_clipper(ckt, start, {"x": x, "y": y}, cfg=cfg,
                                  trainable_filter=lambda q: q["C"], on_epoch=on_epoch)
    train_launches = {"B7": fcirc.fused_circuit_process.launches,
                      "B8": pb.fused_backward.launches,
                      "B7_lanes": fcirc.fused_circuit_process.lane_launches}
    c1 = float(trained["C"]["C"])
    print(f"phase train distilled_path fused_generic ({DIST_B}, {DIST_T}) steps={DIST_STEPS} "
          f"loss={' '.join(f'{l:.6e}' for l in hist['loss'])} C={1.2 * CAP:.4e}->{c1:.4e} "
          f"(true {CAP:g}) step_ms={' '.join(f'{m:.2f}' for m in step_ms)} "
          f"launches={train_launches} card={card!r}", flush=True)
    _check(all(np.isfinite(hist["loss"])) and hist["loss"][-1] < hist["loss"][0]
           and abs(c1 - CAP) < 0.2 * CAP, "fused_generic trains C on the distilled root")
    _check(train_launches["B7"] >= DIST_STEPS and train_launches["B8"] >= DIST_STEPS,
           "the training steps launched B7 and B8")
    _check(train_launches["B7_lanes"] == train_launches["B7"],
           "every B7 launch of the training steps took the distilled root's lane form")

    # the time-block training step at one rank under NCCL
    troot, _ = _distilled(PAR_FS, 45e3, 4.7e-9)
    cheb = (float(troot.a_max), tuple(troot.breaks), tuple(troot.coeffs))
    make = functools.partial(_dist_train_clipper, cheb=cheb)
    tbt_loss, tbt_grads = _par_tbt_reference(dev, seed, PAR_TBT[0], make=make)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = spawn(_dist_tbt_rank, 1, cheb, seed, dev.type, backend=backend, device=dev.type,
                 timeout_s=PAR_TIMEOUT_S)[0]
    loss_rel = abs(rank["loss"] - tbt_loss) / abs(tbt_loss)
    grad_rel = _np_rel(rank["grads"], tbt_grads)
    print(f"phase train distilled_path time_block world=1 backend={backend} T={PAR_TBT[0]} "
          f"W={PAR_TBT[1]} loss_rel={loss_rel:.2e} (rtol {PAR_LOSS_RTOL:g}) grad_rel="
          f"{grad_rel:.2e} ({PAR_TBT_GRAD:g}, against the single-process step over the row) "
          f"launches={rank['launches']} step_ms={rank['step_ms']:.3f} spawn_s="
          f"{time.perf_counter() - t0:.1f} card={card!r}", flush=True)
    _check(loss_rel <= PAR_LOSS_RTOL and grad_rel <= PAR_TBT_GRAD,
           "the distilled root's time-block step matches the single-process step")
    _check(rank["launches"]["B7"] > 0 and rank["launches"]["B8"] > 0,
           "the time-block step launched B7 and B8")
    _check(rank["launches"]["B7_lanes"] == rank["launches"]["B7"],
           "every B7 launch of the time-block step took the lane form")

    # the export-artifact command's relu artifact (started first)
    cli.wait(timeout=max(1.0, CLI_TIMEOUT_S - (time.perf_counter() - t_path)))
    text = (folder / "export.log").read_text()
    lines = [l for l in text.splitlines() if l.startswith("{")]
    if cli.returncode != 0 or not lines:
        print(f"phase cli export relu FAILED rc={cli.returncode}\n{text[-3000:]}", flush=True)
    _check(cli.returncode == 0 and bool(lines), "export-artifact --model-json relu.json --check")
    rec = json.loads(lines[-1])
    print(f"phase cli distilled_path export-artifact --model-json relu.json --check "
          f"kernel={rec.get('kernel')!r} check_max_abs_err={rec['check_max_abs_err']:.3e} "
          f"(budget {DIST_MLP_BUDGET:g}) card={card!r}", flush=True)
    _check(rec.get("kernel") == "B7 circuit_forward"
           and rec["check_max_abs_err"] <= DIST_MLP_BUDGET, "the relu root's artifact checks")

    # the general MLP roots served by the exact runner, and by artifacts
    signal = _strum(seed, DIST_BLOCKS * CHUNK)[0]
    serve_launches = serve_lane_launches = 0
    for name, (c, p) in mlp_ckts.items():
        run = _lpf_exact_runner(c)
        blocks = [torch.from_numpy(signal[i * CHUNK:(i + 1) * CHUNK]).to(dev)
                  for i in range(DIST_BLOCKS)]
        fcirc.fused_circuit_process.launches = fcirc.fused_circuit_process.lane_launches = 0
        st, served, walls = c.init_state(dev), [], []
        for blk in blocks:
            t0 = time.perf_counter()
            o, st = run(p, st, {"Vs": {"v": blk}}, {})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            served.append(o)
        launches = fcirc.fused_circuit_process.launches
        lane_launches = fcirc.fused_circuit_process.lane_launches
        served = torch.cat(served)
        whole, _ = fcirc.fused_circuit_process(c, p, torch.cat(blocks)[None],
                                               _zero_state(c, served[None]), input_node="Vs")
        # the first blocks again through the runner and Circuit.process, in turns
        st_r, st_p, err, ms = c.init_state(dev), c.init_state(dev), 0.0, {"b7": [], "process": []}
        for i in range(DIST_TURNS):
            for label in (("b7", "process") if i % 2 == 0 else ("process", "b7")):
                t0 = time.perf_counter()
                if label == "b7":
                    o_r, st_r = run(p, st_r, {"Vs": {"v": blocks[i]}}, {})
                else:
                    o_p, st_p = c.process(p, st_p, {"Vs": {"v": blocks[i]}})
                torch.cuda.synchronize()
                ms[label].append((time.perf_counter() - t0) * 1e3)
            err = max(err, _max_err(o_r, o_p))
        art = load_artifact(str(folder / "relu.pt2"), device="cuda") if name == "relu" else None
        if art is None:
            save_artifact(str(folder / f"{name}.pt2"), c, p, input_node="Vs", block_len=CHUNK,
                          fs=FS)
            art = load_artifact(str(folder / f"{name}.pt2"), device="cuda")
        fcirc.fused_circuit_process.launches = fcirc.fused_circuit_process.lane_launches = 0
        served_art = torch.from_numpy(art.run(signal)).to(dev)
        art_launches = fcirc.fused_circuit_process.launches
        lane_launches += fcirc.fused_circuit_process.lane_launches
        serve_launches += launches + art_launches
        serve_lane_launches += lane_launches
        print(f"phase serve distilled_path mlp {name} {DIST_MLP[name]} blocks={DIST_BLOCKS}x"
              f"{CHUNK} fs={FS:g} exact_runner_launches={launches} lane_form_launches="
              f"{lane_launches} (runner and artifact) block_wall_ms_median="
              f"{statistics.median(walls):.3f} vs_one_launch={_max_err(served, whole[0]):.3e} "
              f"vs_circuit_process={err:.3e} budget={DIST_MLP_BUDGET:g} (first {DIST_TURNS} "
              f"blocks in turns: b7_ms={' '.join(f'{m:.3f}' for m in ms['b7'])} "
              f"circuit_process_ms={' '.join(f'{m:.1f}' for m in ms['process'])}) "
              f"artifact={art.meta['kernel']!r} launches={art_launches} vs_runner="
              f"{_max_err(served_art, served):.3e} card={card!r}", flush=True)
        _check(launches == DIST_BLOCKS and art_launches == DIST_BLOCKS,
               f"one B7 launch a block for the {name} root, runner and artifact")
        _check(lane_launches == 2 * DIST_BLOCKS,
               f"every served block of the {name} root took the lane form")
        _check(err <= DIST_MLP_BUDGET and _max_err(served, whole[0]) <= 1e-6
               and _max_err(served_art, served) <= 1e-6 and bool(torch.isfinite(served).all()),
               f"the {name} root's served blocks")
        mlp_rec[name][0] = max(mlp_rec[name][0], err)
    b7_launches = train_launches["B7"] + rank["launches"]["B7"]
    b7_lanes = train_launches["B7_lanes"] + rank["launches"]["B7_lanes"]
    b8_launches = train_launches["B8"] + rank["launches"]["B8"]
    common = {"route": "cuda", "source": CIRCUIT_SOURCE, "library_ms": None}
    k, times, _ = lanes["distilled"]
    records = [
        {"name": f"fused_deer_circuit (distilled root: cheb_root_value_tangent, "
                 f"T={DEER_T[-1]}, device time)",
         **common, "replaces": DC_REPLACES["circuit"], "launches": b9_launches,
         "max_abs_err": b9[DEER_T[-1]][0], "ms": b9[DEER_T[-1]][1],
         "plain_ms": b9[DEER_T[-1]][2], "bound_ms": b9[DEER_T[-1]][3][0],
         "bound_by": b9[DEER_T[-1]][3][1]},
        {"name": f"fused_circuit_process (distilled root, training form, {DIST_B}x{DIST_T}; "
                 f"ms: the one-thread form, in turns with the lane form; launches: the "
                 f"wrapper's)",
         **common, "replaces": CIRCUIT_REPLACES, "launches": b7_launches, "max_abs_err": fwd_err,
         "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1]},
        {"name": f"fused_circuit_process (distilled root lane form: cheb_root_lanes, K = {k}, "
                 f"training form, {DIST_B}x{DIST_T})",
         **common, "replaces": CIRCUIT_REPLACES, "launches": b7_lanes, "max_abs_err": fwd_err,
         "ms": times[f"k{k}"][0], "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1]},
        {"name": f"fused_backward (distilled root: cheb_root_tangent in pass 1, "
                 f"{DIST_B}x{DIST_T}; ms: pass 1 + pass 2, the wrapper's call in the "
                 f"phase line)", **common, "replaces": BPTT_REPLACES,
         "launches": b8_launches, "max_abs_err": adj_abs, "ms": sum(pass_ms),
         "plain_ms": adj_plain_ms, "bound_ms": adj_bound[0], "bound_by": adj_bound[1]},
    ]
    err, ms, plain_ms, bound = mlp_rec["relu"]
    k, one, _, _ = lanes["relu"]
    records.append({"name": "fused_circuit_process (general MLP root: mlp_dense.cuh, the relu "
                            "and sigmoid 2x8 JSON roots, B=1; ms: relu, the one-thread form's "
                            "device time in turns with the lane form; launches: the wrapper's)",
                    **common, "replaces": CIRCUIT_REPLACES, "launches": serve_launches,
                    "max_abs_err": max(r[0] for r in mlp_rec.values()), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1]})
    records.append({"name": f"fused_circuit_process (general MLP root lane form: "
                            f"mlp_dense_lanes.cuh, K = {k}, the relu and sigmoid 2x8 JSON roots, "
                            f"B=1; ms: relu, device time)", **common,
                    "replaces": CIRCUIT_REPLACES, "launches": serve_lane_launches,
                    "max_abs_err": max(r[0] for r in mlp_rec.values()),
                    "ms": one[f"k{k}"][3], "plain_ms": plain_ms, "bound_ms": bound[0],
                    "bound_by": bound[1]})
    return records


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the input signals")
    parser.add_argument("--full-pretrain", type=int, default=0, metavar="EPOCHS",
                        help="instead of the smoke, pretrain the 2x16 rung for EPOCHS epochs "
                             "at eight seeds and print each seed's final MSE and ESR")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    kind = torch.cuda.get_device_name(0)
    if args.full_pretrain:
        full_pretrain(dev, card, args.seed, args.full_pretrain)
        print(card, flush=True)
        return

    # --- toolchain ---------------------------------------------------------
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"phase toolchain card={card!r} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc={nvcc!r}", flush=True)

    # --- build (set-up) ----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"phase build seconds={build_s:.2f} lib={_build.library_path().name}", flush=True)
    for line in _ptxas_lines():
        print(f"  ptxas {line}", flush=True)
    sass = _sass_summary()
    for line in sass:
        print(f"  sass {line}", flush=True)
    _check(len(sass) == len(SASS_KERNELS), "the SASS of every summarised serving kernel")

    kernels = []
    for path in (serve_path, train_path, stream_path, circuit_path, generic_train_path,
                 deer_circuit_path, pretrain_path, sweep_path, oracle_path, artifact_path,
                 cli_path, parallel_path, distilled_path):
        t0 = time.perf_counter()
        kernels += path(dev, card, args.seed)
        print(f"phase seconds {path.__name__} s={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
