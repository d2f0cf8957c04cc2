"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py                  # the full run, on the card
    python3 chip_smoke.py --rehearse       # control flow only, tiny, on the CPU

Phases (each raises on failure; nothing is caught):

1. environment: torch, nvcc, the card's name and power limit;
2. build: the fourteen CUDA kernels of ``gecco_tpu_torch/csrc`` (eight
   forward, six backward), the WMMA bodies beside the Hopper forwards and
   backwards (the rect attention's two included), the projective gather's
   SIMT bodies beside its Hopper ones, and the pool backward's v1, v2 and
   v2j bodies, Hopper (one library) and WMMA (two), and the fp32 routes'
   SIMT kernels (``csrc/f32_simt.cu``) (thirty libraries, the projective
   gather's forward and backward in one, their SIMT bodies in another)
   with nvcc for sm_90a,
   one process per source, all at once, with ``ptxas -v``'s registers and
   spills;
3. forward kernels: each set-transformer kernel against its plain PyTorch
   version on the card, in bf16, at the sampler's flagship shapes (batch
   64; ordinary and drifted operands), the pool also at the 8k width; each
   one's time beside its plain version's, its bound and, for pool and
   unpool, per-head ``scaled_dot_product_attention`` on the unfolded q/k/v
   as the library yardstick (used nowhere in the port);
4. backward kernels: each against autograd of its plain version on the
   card, in bf16, at the flagship's training shapes (batch 48; ordinary and
   drifted operands, nonzero sums cotangents), the pool's and the unpool's
   also at the 8k width; each output against its own tolerance (the pool's
   drifted dbe beside a witness of its looser one); times, bounds and, for
   pool and unpool, the backward of per-head ``scaled_dot_product_attention``;
   the unpool backward's WMMA body beside its Hopper body at both widths;
   the pool and unpool backwards' Hopper bodies at the demo model's and
   three heads' shapes (dqf, dkf and dvf the same bits in two calls), each
   timed in turns with its WMMA body forced on the same operands beside
   SDPA's backward and the bound, the WMMA bodies held at 48 inducers of
   the demo's width; the MLP backward's bodies there; the
   pool backward's v1, v2 and v2j algebras (``GECCO_POOL_BWD``) at both
   widths and at three heads, ordinary and drifted, each in its Hopper
   body and its WMMA body, against their plain versions, the Hopper body's
   passes against their plain pieces, and through the wrapper against
   autograd of the plain version; the two bodies and the v3 body timed in
   turns beside SDPA's backward; the WMMA body at the demo's C 128;
5. projective gather: the forward against its plain version and the
   backward against autograd of the plain version, at the 256^2 pyramid of
   the image-conditional model (batch 48, 2048 points) on coordinates in
   [-0.1, 1.1] and on the model's own (``diffusion_to_hw`` of
   ``make_conditional_batch``'s clean clouds), and at the 137^2 pyramid of
   the dataset's renders; at the model's pyramid, on both coordinate sets,
   the Hopper forward the same bits as its SIMT body, the Hopper backward
   the same bits in two calls and within 1.25x the SIMT body's error, each
   function's two bodies timed in turns with their device time, the
   host's time to make a call, the bound from the set's touched bytes and
   ``grid_sample`` (forward, and its autograd backward) as the library
   yardstick; then ``lookup_pyramid(..., impl="pallas")`` forward and
   backward at widths only the SIMT bodies take (C 36, 68, 132), each SIMT
   body launched once; then the SIMT bodies' other instances (the model's
   pyramid in fp32, odd C 3, 35 and 131, a 2-byte-aligned level, six
   levels: two launches each way) forward and backward with the coordinate
   gradient against the plain version in fp32, the launches exact, the
   Hopper bodies still taking the model's bf16 pyramid, each instance
   timed in turns with the bf16 SIMT body beside its bound;
6. per-head attention and megakernel: the rect attention's Hopper and
   WMMA bodies on the same operands, forward (o and lse) against its plain
   version in both directions of the per-head model (pool: 64 inducer
   queries against 2048 points; unpool: the reverse) at the sampler's
   batch 64, ordinary and drifted, at D 48 (the flagship), D 128 (three
   heads), the 8k width and D 128 at 8192 points; the backward (dq, dk,
   dv) against autograd of the plain version and against the TPU
   algebra's witness (``rect_bwd_tpu_algebra``) there at the training
   batch 48; the Hopper bodies' outputs the same bits in two calls, the
   switch picking them at those shapes; each direction's two bodies timed
   in turns at D 48 and D 128 with their device time
   (``torch.profiler``), ``scaled_dot_product_attention`` (forward, and
   its backward) on the same q/k/v as the yardstick and the bound; the
   WMMA body's instances at D 80-112 checked and timed, D 256 timed beside
   its bound and SDPA's (forward and backward); the unpool + MLP
   megakernel's Hopper body (``csrc/unpool_mlp.cu``) against the plain
   composition and the two separate kernels at the sampler's shapes,
   ordinary and drifted, at N 2048 and 2000, the same bits in two calls,
   its WMMA body (``csrc/unpool_mlp_wmma.cu``) forced on the same operands
   at N 2048; the two bodies timed in turns with their device time, beside
   the separate kernels', the plain version's and the bound;
7. sampler path: the flagship (6 x 384, 64 inducers, 8 heads, bf16,
   ``attn_impl="folded_pallas"``) from the port's seeded init samples
   2048-point clouds with the 128-step Heun grid through
   ``Diffusion.sample``; every set-transformer forward kernel's launch
   count must equal 6 layers x 2 x 127 evaluations and no other kernel may
   launch; then, from one latent on an 8-step grid, the kernel path against
   the plain path (``attn_impl="xla"``);
8. training path: the same flagship trains on procedural clouds (batch 48
   x 2048 points) with the config's optimizer (global-norm clip 1,
   AdaBelief, warmup-cosine learning rate) and EMA 0.999: one step's
   gradient of the kernel path against the plain path's from the same
   weights, batch, sigma and noise, per parameter group; then 3 warm-up and
   20 timed steps through ``make_train_step``, every set-transformer kernel
   launched exactly 6 times per step, losses and parameters finite;
9. conditional sampler path: the image-conditional model of
   ``configs/shapenet_vol_conditional.py`` (UVL reparam, ConvNeXt-tiny
   pyramid, ``RayNetwork(lookup_impl="pallas")`` over the same backbone with
   ``remat=True``) from the port's seeded init samples 2048-point clouds for
   48 images of 256^2 through ``Diffusion.sample``: the ConvNeXt once, the
   gather once per evaluation (254), each set-transformer forward kernel
   6 x 254 times, no backward kernel; then, from one latent on an 8-step
   grid, the kernel path against the plain path (``attn_impl="xla"``,
   ``lookup_impl="xla"``) in diffusion space;
10. conditional training path: one step's gradient of the kernel path
   against the plain path per parameter group (the ConvNeXt's stem, stages
   and downsamples and ``ctx_dim_reductor`` among them), then 3 warm-up and
   20 timed steps at batch 48 with the config's optimizer (clip 1, AdaBelief
   at 3e-4) and EMA 0.999: per step the gather forward and backward once,
   each set-transformer forward kernel 12 times (``remat`` recomputes every
   layer) and each backward kernel 6 times; a ``torch.profiler`` split of
   the device time (gather, set-transformer kernels, the ConvNeXt's
   convolutions, the rest);
11. per-head sampler path: the flagship with ``attn_impl="pallas"`` (the
   per-head modules, their attention through the rect-attention kernel)
   samples as in phase 7: the rect attention's Hopper forward 6 x 2 x 254
   times, its WMMA body and every other kernel never; then the 8-step
   sample against the plain path;
12. per-head training path: the same model trains at batch 48 as in phase
   8: one step's gradient against the plain path per parameter group, then
   3 + 20 steps, the rect attention's Hopper forward and backward 12 times
   each per step and no other kernel (their WMMA bodies never), finite
   losses and parameters, peak memory;
13. megakernel sampler path: the flagship of phase 7 with
   ``GECCO_UNPOOL_MLP_MEGAKERNEL=1`` set in the process samples at batch
   64: per sample the megakernel's Hopper body, the pool and the h-side 6
   x 254 times each, its WMMA body and the separate unpool and MLP never;
   then the upsample demo's model (3 x 128) at batch 48 the same way
   through the WMMA body (3 x 254); each 8-step sample against the
   separate kernels' path and against the plain path; the variable is
   restored;
14. resident pool: ``folded_pool_layer``'s Hopper body (``csrc/pool.cu``)
   against its plain version with and without its pre-norm (h0, and the
   GroupNorm statistics it computes), ordinary and drifted, at the
   sampler's batch 64 and at the 8k width (batch 2 at N 8192, batch 64 at
   N 2048), the body held by its counter; each of its passes against its
   plain piece on the kernel's own inputs and every output the same bits
   in two calls (``probes.pool_layer``); its WMMA body
   (``csrc/pool_wmma.cu``) at the sampler's shapes, the two timed in
   turns; the backward, on the Hopper forward's saved tensors, against
   autograd of the plain version, nonzero mean/inv cotangents (the
   drifted dbias beside the witness of its looser tolerance): its Hopper
   body (``csrc/pool_bwd.cu``) at the training batch 48 and the 8k width,
   each pass against its plain piece and every output the same bits in
   two calls (``probes.pool_layer_bwd``), its WMMA body
   (``csrc/pool_bwd_wmma.cu``) forced at batch 48 and at its own three
   heads, each call held to its body, the two timed in turns with device
   times beside SDPA's backward; the unpool forward and backward with
   both flags off at the flagship's shapes; times, bounds and, without the
   pre-norm, per-head SDPA as the yardstick;
15. module-level folded path at the flagship's width: a ``Broadcast`` on
   ``folded_pallas`` (the resident pool without its pre-norm, the flag-free
   unpool) forward at batch 64 against ``xla`` and ``folded``, one gradient
   at batch 48 per parameter group and for x against the plain path in
   fp32 (the plain bf16 path printed beside it); a ``BroadcastingLayer``
   called without channel sums under ``torch.no_grad`` (the resident pool
   with its statistics) against the plain layer; a ``Broadcast`` with
   three heads (the resident pool's WMMA bodies forward and backward, the
   unpool forward's WMMA body and its backward's Hopper body) against
   ``xla`` and its gradient against the plain path in fp32; each run's
   launches exact;
16. upsample path: the flagship on ``folded_pallas`` upsamples one
   2048-point observation to 102,400 points through ``Diffusion.upsample``
   on ``scripts/demo_upsample_100k.py``'s protocol (64-step extended grid, 5
   substeps, churn 0.5): the pool and the h-side 6 x 64 times (one cache
   refresh per transition), the unpool and the MLP 6 x (64 + 63 x 5 x 2 +
   5) times, no other kernel; a finite cloud of the right shape; then a
   4-step, 2-substep upsample of two clouds to 4096 points, the kernel path
   against the plain path from one generator seed;
17. validation: ``gecco_tpu_torch.validate``'s loop (the trained-magnitude
   gate's) for 20 steps of the flagship at batch 48 on the procedural
   mixture, then one eval of 16 clouds with the 8-step Heun sampler scored
   against 16 held-out clouds: finite losses, 1-NN accuracy and COV in
   [0, 1], MMD finite and non-negative;
18. demo sampler path: ``scripts/demo_upsample_100k.py``'s default model (3 x
   128, 4 heads of 32 channels, 64 inducers) samples 48 2048-point clouds
   with the 128-step Heun grid: the Hopper pool and unpool, the MLP's
   WMMA body and the h-side kernel 3 x 254 times each, the pool's and
   unpool's WMMA bodies and the Hopper MLP never; then the 8-step sample
   against the plain path;
19. demo training path: the same model trains at batch 48 as in phase 8
   (ROADMAP.md C4): one step's gradient against the plain path, then 3 +
   20 steps, per step and layer the Hopper pool and unpool forwards and
   backwards, the h-side and the MLP's WMMA bodies (forward and backward)
   once each; then one gradient of the flagship with three heads (C 384,
   D 128) against the plain path, which runs the pool and unpool
   forwards' WMMA bodies, their backwards' Hopper bodies and the Hopper
   MLP forward and backward;
20. pool backward bodies on the training path: the flagship of phase 8
   trains under ``GECCO_POOL_BWD`` forced to v1, v2 and v2j in turn (the
   module global it sets at import, restored after): per body one step's
   gradient against the plain path, then 3 + 5 steps, each layer's pool
   backward through that body's Hopper kernel once per step, and the device's
   busy time per step from the profiler beside the v3 step's (the wall
   time of so few host-bound steps is reported, not compared);
21. the wider kernel instances on a model's path (ROADMAP C1): the
   flagship with 32 inducers on ``folded_pallas`` (the h-side's I 32
   instance, the pool's and unpool's WMMA bodies) and the per-head
   flagship with three heads (the rect attention's D 128 instances): each
   samples 8 steps from one latent against the plain path and takes one
   gradient against it, every function through a kernel, the launch
   counts exact; then the shapes ROADMAP C1 listed as raising on the card,
   at batch 8: the resident pool's Hopper body at 24, 128 and 256 inducers
   and its WMMA body's column blocks (three heads, 256), its backward at
   256 inducers at the flagship's and the 8k width (the Hopper body's four
   column blocks) and with three heads (the WMMA body's 32-point tile),
   the pool forward and backward at 24 and 256 and with
   three heads at 256 (the fold in 64-row blocks), the unpool forward at
   24, 192 and 256 and backward at 24, 128 and 256, the h-side at 24, the
   rect attention at D 40, 192 and 256 (its WMMA bodies; the backward's
   two column slices at 256)
   and the pool backward's v1, v2 and v2j bodies at N 2000 and three heads
   (J 192, D 128; Hopper) and the demo's C 128 (WMMA), each against its
   plain version with the expected body; then one model per item at two
   layers (128, 256 and 24 inducers, three heads with 256; per head at D
   40, 192 and 256; N 2000, three heads and the demo's width under each
   forced body): 8 steps from
   one latent and one gradient at batch 16 against the plain path, every
   function through a kernel, the launch counts exact; and a ``Broadcast``
   with 256 inducers (the resident pool's only gradient path) forward and
   gradient against the plain path;
22. ragged point counts (ROADMAP C1): every body of the point-tiled
   functions (the pool, unpool and MLP forwards and backwards, Hopper and
   WMMA bodies, the pool and unpool backwards' Hopper bodies at the
   flagship's, the demo's and three heads' widths and their WMMA bodies at
   48 inducers of the demo's width, and the resident pool with and without
   its pre-norm) at N
   2000 (padded to 2048 on the card), the pools' also at N 2050 (a 64-point
   chunk of padding alone), ordinary and drifted, against its plain
   version at the unpadded N with the tolerance of its N 2048 check,
   failing unless the expected body ran; the flagship on ``folded_pallas``
   at N 2000 samples 8 steps from one latent against the plain path and
   takes one gradient at batch 48 against it, every function through a
   kernel, the launch counts exact; one evaluation at batch 64 timed at N
   2000 and at N 2048, in turns; the resident pool's launches exact;
23. other samplers: the flagship of phase 7 at batch 64 and 2048 points
   through ``sample_stochastic`` (the config's 128 steps on the extended
   grid, churn 0.5: 255 evaluations, each forward kernel 6 x 255 times),
   ``sample_inpaint`` (1024 known points completed by 1024, 2 substeps,
   churn 0.5: 510 evaluations), ``sample(..., temperature=0.8)`` on an
   8-step grid (its latent 0.8 times the draw) and ``score``, no backward
   kernel; the conditional model's ``sample_stochastic`` at batch 48 (the
   ConvNeXt once, the gather forward 255 times); each against the plain
   path from the same draws on an 8-step grid, wall time and clouds/s;
24. likelihood: ``LogpMetric(n_solver_steps=24)`` (``evaluate_logp``) of
   48 clouds of 2048 points, on the flagship (23 transitions, 46
   evaluations and VJPs: each forward and each backward kernel 6 x 46
   times) and on the conditional model with remat (each forward kernel 12
   x 46, each backward 6 x 46, the gather forward 46 times and its Hopper
   backward 46 times with the coordinate gradient, its SIMT bodies never,
   the ConvNeXt once); no parameter gets a ``.grad``; seconds per batch
   and a ``torch.profiler`` split (forward kernels, backward kernels and
   their weight-gradient passes apart, the gather, PyTorch's own); then
   from one Rademacher draw on a 4-step grid at batch 8 the kernel path
   against the plain path, every ``LogpDetails`` field to its own
   tolerance, the plain path in fp32 printed beside as the witness.
25. fp32 routes (ROADMAP C5): each of the eleven wrappers with a route
   of its own (the rect attention's forward and backward, the pool,
   h-side, unpool and MLP forwards, the three folded backwards, the
   resident pool and its backward) on fp32 operands at the flagship's
   shapes (batch 8), ordinary and drifted, against its plain version in
   fp32 or in fp64 (|err| <= 1e-5 + 1e-4 |ref|, the absolute term 2e-5 of
   max |ref| for drifted operands; not for the channel sums and gradients
   of ordinary operands), every output's error against the plain version
   in fp64 at most 4x the plain fp32 version's own; its ``launches_f32``
   advancing; each timed in
   turns with its bf16 body on bf16 operands of the same shapes, beside
   its plain version in fp32, the bound at the fp32 peak and, for the
   rect attention, SDPA in fp32; the megakernel's fp32 case (the unpool's
   and the MLP's routes, once each) likewise; then two-layer fp32
   flagships on ``folded_pallas`` and per head each sample 8 steps at
   batch 8 (within 1e-5 of the plain path) and take 3 train steps, and a
   module-level ``Broadcast`` (forward and gradient) and a sums-less layer
   run, every launch on the fp32 route, the counts exact;
26. the Trainer: the port's flagship config
   (``gecco_tpu_torch/configs/shapenet_airplane_unconditional.py``: 6 x
   384, bf16, ``folded_pallas``, batch 48, 2048 points) trains through
   ``gecco_tpu_torch.train.train`` on a PointFlow-layout tree of 96 + 96
   procedural clouds written to a temporary directory: the validation smoke
   test, 30 steps with a checkpoint and a validation (SupervisedMetric,
   LogpMetric(24), the loss, BenchmarkCallback) every 15, on one batch (the
   cuts printed); then a fresh Trainer resumes from the newest checkpoint
   at step 30 and takes 30 steps (each set-transformer kernel 6 times a
   step, exactly), and ``gecco_tpu_torch.infer`` samples 64 clouds from the
   final checkpoint's EMA weights; the steady ms/step (the 19 steps after
   the resumed run's first two loss fetches: the loader's start and the
   first fetch window left out) and the validations' seconds.

Phase 3 holds the h-side's Hopper body (``csrc/hside.cu``) at the
flagship's, the 8k width's and the demo's shapes and at 16, 32 and 48
inducers, ordinary and drifted, every output the same bits in two calls,
each pass against its plain piece on the kernel's own inputs, and its WMMA
body (``csrc/hside_wmma.cu``) at the flagship's operands and at C 192 (a
width only it takes), the two bodies timed in turns; the h-side's chain
yardstick is GroupNorm, Linear, the Gaussian, Linear, GroupNorm and the k
and v projections as PyTorch calls.
Phase 3 also holds the pool's, unpool's and MLP's WMMA bodies (the shapes
the Hopper designs do not take) against their plain versions at the demo's
shapes, where it times them, the pool's and unpool's with three heads at
the flagship's width (the MLP there: its Hopper body, the MLP seeing no
heads), and fails unless those checks ran the expected bodies; it holds
the MLP forward's Hopper body and WMMA body at the 8k width and times
both in turns at the flagship's operands. Phase 4 holds the
pool backward at both widths, ordinary and drifted, times it at both
(median, min and max of 20 calls), and requires dqf (through dind2) to be
the same bits in two calls; it holds the unpool backward's Hopper and
WMMA bodies at both widths, ordinary and drifted, times both at both
(median, min and max of 20 calls each, in turns), and requires dkf and dvf
(through dk and dv) to be the same bits in two calls of the Hopper body;
it holds the MLP backward's Hopper and WMMA bodies at both widths,
ordinary and drifted, times both at both in turns, and requires every
gradient of the Hopper body (dw1t and dw2t among them) to be the same bits
in two calls; and it holds the pool and unpool backwards' Hopper bodies
(the demo, three heads) and WMMA bodies (48 inducers at the demo's
width), the MLP backward's WMMA body (the demo's C 128) and Hopper body
(three heads' C 384), and fails unless those checks ran the expected
bodies; it times each pool and unpool backward's Hopper body in turns with
its WMMA body at the demo's and three heads' shapes, beside the SDPA
backward and the bound there.

Phases 3, 4 and 14 also time, beside the SDPA yardstick of the pools and
unpools, the whole function as a chain of PyTorch calls (pre-norm,
projections, SDPA, output projection; the unpool's residual and sums; the
backwards under autograd): ``library_chain_ms`` in the kernels' JSON line
(null elsewhere).

It prints the kernels' JSON line, then the card's name and power limit, then
the device line, last. The resident pool's entries there (each body's, and
the backward's) hold the variant without the pre-norm, the module-level
``Broadcast``'s, with its launches and SDPA yardstick; the pre-norm variant (the sums-less layer's)
sits under each one's ``prenorm`` key with its own launches and times. It imports nothing of JAX or of gecco_tpu, and fails
without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gecco_tpu_torch import (  # noqa: E402
    Context3d,
    Diffusion,
    GaussianReparam,
    LogUniformSchedule,
    UVLReparam,
)
from gecco_tpu_torch.config import load_config  # noqa: E402
from gecco_tpu_torch.data import make_clouds, make_conditional_batch  # noqa: E402
from gecco_tpu_torch.infer import __main__ as infer_main  # noqa: E402
from gecco_tpu_torch.metrics import LogpMetric  # noqa: E402
from gecco_tpu_torch.models import (  # noqa: E402
    ConvNeXtExtractor,
    RayNetwork,
    SetTransformer,
    UnconditionalPointNetwork,
)
from gecco_tpu_torch.models.set_transformer import Broadcast, BroadcastingLayer  # noqa: E402
from gecco_tpu_torch import validate  # noqa: E402
from gecco_tpu_torch.ops import kernels  # noqa: E402
from gecco_tpu_torch.ops.norms import group_norm_stats  # noqa: E402
from gecco_tpu_torch.train import (  # noqa: E402
    conditional_optimizer,
    flagship_optimizer,
    make_ema,
    make_train_step,
)
from gecco_tpu_torch.ops.kernels import _build  # noqa: E402
from gecco_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from gecco_tpu_torch.utils.logging import JsonlWriter  # noqa: E402
from gecco_tpu_torch.ops.kernels import folded_attention as fa  # noqa: E402
from gecco_tpu_torch.ops.kernels import hside as hs  # noqa: E402
from gecco_tpu_torch.ops.kernels import induced_attention as ia  # noqa: E402
from gecco_tpu_torch.probes.hside import passes as hside_passes  # noqa: E402
from gecco_tpu_torch.probes.pool_bwd import launch_split  # noqa: E402
from gecco_tpu_torch.probes.pool_bwd_twopass import pass_failures as twopass_pass_failures  # noqa: E402,E501
from gecco_tpu_torch.probes.pool_bwd_twopass import passes as twopass_passes  # noqa: E402
from gecco_tpu_torch.probes.pool_layer import check_shape as pool_layer_passes  # noqa: E402
from gecco_tpu_torch.probes.pool_layer_bwd import check_shape as pool_layer_bwd_passes  # noqa: E402,E501
from gecco_tpu_torch.ops.kernels.projective_gather import (  # noqa: E402
    _gather_body,
    _gather_bwd_ref,
    _gather_bwd_simt as pg_simt_bwd,
    _gather_ref,
    _gather_simt as pg_simt_fwd,
    projective_gather,
    projective_gather_bwd,
)
from gecco_tpu_torch.ops.projective import lookup_pyramid  # noqa: E402
from gecco_tpu_torch.probes import gather as gather_probe  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(n_layers=6, feature_dim=384, num_inducers=64, num_heads=8, n_points=2048)
SCALED_8K = dict(feature_dim=768, num_inducers=64, num_heads=16, n_points=8192)
# scripts/demo_upsample_100k.py's default model (3 x 128, 4 heads of 32
# channels; trained and upsampled at batch 48): the forwards' WMMA bodies
DEMO = dict(n_layers=3, feature_dim=128, num_inducers=64, num_heads=4, n_points=2048)
DEMO_BATCH = 48
N_STEPS = 128
BATCH = 64  # the flagship protocol of bench.py
TRAIN_BATCH = 48  # configs/shapenet_airplane_unconditional.py
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
# timed steps of the flagship under each forced pool backward body
TWOPASS_STEPS = 5
GROUPS = 32
# the image-conditional model (configs/shapenet_vol_conditional.py): batch
# 48 for sampling (bench.py's conditional protocol) and training, 256^2
# images (bench.py), the ConvNeXt-tiny pyramid's channels
COND_BATCH = 48
IMAGE_SIZE = 256
CTX_DIMS = (96, 192, 384)
# the dataset's 137^2 renders give the pyramid 34^2, 17^2, 8^2
RENDER_SIZE = 137
# kernel vs plain version, both bf16: max |kernel - plain| / max |plain|.
# Both round to bf16 (relative step 2^-8 = 3.9e-3) at their own points (the
# unpool folds se into wq before rounding, its plain twin normalises x
# first) and sum in other orders, so a few bf16 steps of the largest value.
TOL_OUT = 2e-2
# channel sums: fp32 over N points, with fp32 atomics across point tiles
TOL_SUMS = 1e-2
# sample_data after an 8-step grid, kernel path vs plain (xla) path, bf16
TOL_PATH = 5e-2
# backward kernel vs autograd of its plain version, both bf16 operands:
# max |kernel - plain| / max |plain| per output. The kernels round e, p, ds,
# d_attn, g' and dh to bf16 before their products (as the TPU kernels do)
# and take the cotangent in bf16; the plain autograd rounds at its own
# casts. dx and the weight gradients: a few bf16 steps (2^-8) of the
# largest value, summed over up to 98304 rows in other orders (fp32
# atomics across blocks).
TOL_GRAD = 3e-2
# dse/dbe: per-channel sums over N points of dy * x and dy, held
# separately (chip readings up to 1.4e-2).
TOL_AFFINE = 3e-2
# projective gather backward against autograd of the plain version run in
# fp32 on the same bf16 inputs (the plain bf16 autograd accumulates dF in
# bf16, tens of adds per pixel, and rounds each corner's dot product): dF is
# summed in fp32 (atomics, in an order that changes from run to run) and
# rounded to bf16 once, so a few bf16 steps (2^-8) of the largest value;
# the coordinate gradient is fp32 throughout in both, summed in other orders
TOL_GATHER_DF = 1e-2
TOL_GATHER_DCOORD = 1e-3
# the gather's fp32 SIMT instance against the plain version in fp32: the
# same sums in other orders (the backward's fp32 atomics in no order)
TOL_GATHER_F32 = 1e-4
# the pool's dbe with drifted logits only. The softmax over the points is
# invariant to a shift of every point, so the sum over N of its ds term
# cancels exactly in the plain version; the TPU kernel's algebra (v3, which
# the CUDA kernel keeps) rounds ds, e, eTy and W2 to bf16, so the sum leaves
# a residue. With near one-hot columns (large ds) it reaches a few percent
# of max |dbe| (chip readings 5.6e-2 at the flagship, 6.8e-2 at the 8k
# width). The witness: the same algebra in plain PyTorch, against which the
# kernel's dbe is held at TOL_AFFINE. The resident pool's dbias with drifted
# logits likewise: its TPU algebra rounds p to bf16 before the softmax
# backward, so sum_n p departs from 1 in a near one-hot column and the sum
# over N of ds keeps t (1 - sum_n p) (chip reading 3.2e-2 at the flagship);
# its witness is pool_layer_bwd_tpu_algebra.
TOL_POOL_DRIFT_DBE = 1e-1
# the resident pool's GroupNorm statistics: fp32 sums of the same bf16
# stream, in other orders (the kernel's tile partials, then its groups)
TOL_STATS = 1e-4
# the upsample protocol of scripts/demo_upsample_100k.py: one 2048-point
# observation upsampled to 102,400 points over the 64-step extended grid
# (65 sigmas, 64 transitions), 5 substeps, churn 0.5
UPSAMPLE_NEW, UPSAMPLE_STEPS, UPSAMPLE_SUBSTEPS = 102_400, 64, 5
# the rect attention's lse: fp32 throughout in both, summed in other orders
# (and, where the keys span several tiles, through a running max and sum)
TOL_LSE = 1e-5
# the megakernel's 8-step sample against the separate kernels' path: the
# same algebra (the WMMA body's unpool is unpool.cuh's WMMA form of
# unpool.cu's), but fp32 sums in other orders (the logits; the mlp_norm
# statistics in rank order, or by the WMMA body's fp32 atomics) and
# rsqrtf, which move bf16 roundings of the pre-norm
TOL_MEGA_PATH = 3e-2
# one train step's gradient, kernel path vs plain (xla) path from the same
# weights, batch, sigma and noise, bf16 activations through 6 layers:
# ||kernel - plain|| / ||plain|| per parameter group (the two paths round
# at different points in every layer, forward and backward; measured on
# the CPU at small shapes: up to 1.4e-2 max-relative against the JAX
# package). The per-head path reads 4.7e-2 in the unpool's q/k
# projections: the TPU backward algebra's delta from the bf16 o, which
# its fp32 and algebra witnesses separate from the kernel (ROADMAP.md C)
TOL_TRAIN_GRAD = 5e-2
# the per-head path's gradient against the same path with the backward
# swapped for a plain PyTorch copy of the TPU kernel's algebra: the same
# roundings, summed in other orders
TOL_ALGEBRA_GRAD = 1e-2
# phase 22's ragged point counts: 2000 pads to 2048 (the last 64-point chunk
# holds 16 points); 2050 pads to 2176, its last chunk all padding
RAGGED_NS = (2000, 2050)

# phase 24: the configs' LogpMetric(n_solver_steps=24); the kernel path
# against the plain path from one Rademacher draw on a 4-step grid at batch
# 8, bf16 activations, each field to its largest value on the plain path.
# The reverse ODE's first transition leaves sigma_min, where the field
# (x - D(x)) / sigma divides the bf16 denoiser's error by 0.002, and carries
# it to sigma_max: chip readings (H100, 700 W) of the plain bf16 path against
# the plain fp32 path on the conditional model: latent 6.9e-2, delta_jacobian
# 2.4e-2 (the flagship: 6.1e-3, 2.7e-4), the kernel path's about twice
# (the kernels round e, p, ds and dh to bf16 as the TPU kernels do). So:
# the latent and the trajectory (diffusion space) 2e-1; delta_jacobian
# (e^T J e integrated) 5e-2; prior_logp (the latent's sum of squares, its
# error averaged over the cloud) 1e-3; delta_reparam the same plain code on
# both paths, 1e-6; logp, the sum of three terms of ~1e4-5e4 that cancel to
# a few thousand, to the largest sum of its terms' magnitudes, 5e-2;
# trajectory_data on the states at sigma <= 1 only (above, the UVL map's
# exp of the depth overflows or amplifies the state's error beyond meaning),
# 2e-1. The plain fp32 path is printed beside as the witness of both.
LOGP_STEPS = 24
TOL_LOGP = dict(logp=5e-2, prior_logp=1e-3, delta_reparam=1e-6, delta_jacobian=5e-2,
                trajectory_diff=2e-1, trajectory_data=2e-1, latent=2e-1)
# phase 23: inpainting completes clouds of 1024 known points by 1024
INPAINT_KNOWN = 1024

SOURCES = {
    "folded_pool_ext": ("gecco_tpu_torch/csrc/pool_ext.cu",
                        "gecco_tpu/ops/pallas/folded_attention.py:1154"),
    "fused_h_side": ("gecco_tpu_torch/csrc/hside.cu", "gecco_tpu/ops/pallas/hside.py:52"),
    # the WMMA body beside it, for the shapes it does not take
    "fused_h_side_wmma": ("gecco_tpu_torch/csrc/hside_wmma.cu",
                          "gecco_tpu/ops/pallas/hside.py:52"),
    "folded_unpool": ("gecco_tpu_torch/csrc/unpool.cu",
                      "gecco_tpu/ops/pallas/folded_attention.py:2222"),
    "fused_mlp_residual": ("gecco_tpu_torch/csrc/mlp.cu",
                           "gecco_tpu/ops/pallas/folded_attention.py:2798"),
    "folded_pool_ext_bwd": ("gecco_tpu_torch/csrc/pool_ext_bwd.cu",
                            "gecco_tpu/ops/pallas/folded_attention.py:1843"),
    "folded_unpool_bwd": ("gecco_tpu_torch/csrc/unpool_bwd.cu",
                          "gecco_tpu/ops/pallas/folded_attention.py:2457"),
    "fused_mlp_residual_bwd": ("gecco_tpu_torch/csrc/mlp_bwd.cu",
                               "gecco_tpu/ops/pallas/folded_attention.py:2902"),
    "projective_gather": ("gecco_tpu_torch/csrc/projective_gather.cu",
                          "gecco_tpu/ops/pallas/projective_gather.py:40"),
    "projective_gather_bwd": ("gecco_tpu_torch/csrc/projective_gather.cu",
                              "gecco_tpu/ops/pallas/projective_gather.py:86"),
    # the gather's SIMT bodies, for the shapes its Hopper bodies do not take
    "projective_gather_simt": ("gecco_tpu_torch/csrc/projective_gather_simt.cu",
                               "gecco_tpu/ops/pallas/projective_gather.py:40"),
    "projective_gather_bwd_simt": ("gecco_tpu_torch/csrc/projective_gather_simt.cu",
                                   "gecco_tpu/ops/pallas/projective_gather.py:86"),
    "rect_attention_fwd": ("gecco_tpu_torch/csrc/induced_attention.cu",
                           "gecco_tpu/ops/pallas/induced_attention.py:67"),
    "rect_attention_bwd": ("gecco_tpu_torch/csrc/induced_attention_bwd.cu",
                           "gecco_tpu/ops/pallas/induced_attention.py:241"),
    # the rect attention's WMMA bodies, for the head widths and layouts its
    # Hopper bodies do not take
    "rect_attention_fwd_wmma": ("gecco_tpu_torch/csrc/induced_attention_wmma.cu",
                                "gecco_tpu/ops/pallas/induced_attention.py:67"),
    "rect_attention_bwd_wmma": ("gecco_tpu_torch/csrc/induced_attention_bwd_wmma.cu",
                                "gecco_tpu/ops/pallas/induced_attention.py:241"),
    "fused_unpool_mlp": ("gecco_tpu_torch/csrc/unpool_mlp.cu",
                         "gecco_tpu/ops/pallas/folded_attention.py:3176"),
    # the megakernel's WMMA body, for the shapes its Hopper body does not take
    "fused_unpool_mlp_wmma": ("gecco_tpu_torch/csrc/unpool_mlp_wmma.cu",
                              "gecco_tpu/ops/pallas/folded_attention.py:3176"),
    "folded_pool_layer": ("gecco_tpu_torch/csrc/pool.cu",
                          "gecco_tpu/ops/pallas/folded_attention.py:526"),
    # the resident pool's WMMA body, for the shapes its Hopper body does not take
    "folded_pool_layer_wmma": ("gecco_tpu_torch/csrc/pool_wmma.cu",
                               "gecco_tpu/ops/pallas/folded_attention.py:526"),
    "folded_pool_layer_bwd": ("gecco_tpu_torch/csrc/pool_bwd.cu",
                              "gecco_tpu/ops/pallas/folded_attention.py:696"),
    # the resident pool backward's WMMA body, for the shapes its Hopper body
    # does not take
    "folded_pool_layer_bwd_wmma": ("gecco_tpu_torch/csrc/pool_bwd_wmma.cu",
                                   "gecco_tpu/ops/pallas/folded_attention.py:696"),
    # the WMMA bodies beside the two Hopper forwards, chosen by shape
    "folded_pool_ext_wmma": ("gecco_tpu_torch/csrc/pool_ext_wmma.cu",
                             "gecco_tpu/ops/pallas/folded_attention.py:1154"),
    "folded_unpool_wmma": ("gecco_tpu_torch/csrc/unpool_wmma.cu",
                           "gecco_tpu/ops/pallas/folded_attention.py:2222"),
    "fused_mlp_residual_wmma": ("gecco_tpu_torch/csrc/mlp_wmma.cu",
                                "gecco_tpu/ops/pallas/folded_attention.py:2798"),
    # the WMMA bodies beside the Hopper pool, unpool and MLP backwards,
    # chosen by shape
    "folded_pool_ext_bwd_wmma": ("gecco_tpu_torch/csrc/pool_ext_bwd_wmma.cu",
                                 "gecco_tpu/ops/pallas/folded_attention.py:1843"),
    "folded_unpool_bwd_wmma": ("gecco_tpu_torch/csrc/unpool_bwd_wmma.cu",
                               "gecco_tpu/ops/pallas/folded_attention.py:2457"),
    "fused_mlp_residual_bwd_wmma": ("gecco_tpu_torch/csrc/mlp_bwd_wmma.cu",
                                    "gecco_tpu/ops/pallas/folded_attention.py:2902"),
    # the pool backward's opt-in bodies, forced by GECCO_POOL_BWD: the
    # Hopper body at the flagship's and the 8k width and three heads
    "folded_pool_ext_bwd_v1": ("gecco_tpu_torch/csrc/pool_ext_bwd_twopass.cu",
                               "gecco_tpu/ops/pallas/folded_attention.py:1428"),
    "folded_pool_ext_bwd_v2": ("gecco_tpu_torch/csrc/pool_ext_bwd_twopass.cu",
                               "gecco_tpu/ops/pallas/folded_attention.py:1563"),
    "folded_pool_ext_bwd_v2j": ("gecco_tpu_torch/csrc/pool_ext_bwd_twopass.cu",
                                "gecco_tpu/ops/pallas/folded_attention.py:1718"),
    # and their WMMA body, for every other shape (the demo's C 128)
    "folded_pool_ext_bwd_v1_wmma": ("gecco_tpu_torch/csrc/pool_ext_bwd_v1.cu",
                                    "gecco_tpu/ops/pallas/folded_attention.py:1428"),
    "folded_pool_ext_bwd_v2_wmma": ("gecco_tpu_torch/csrc/pool_ext_bwd_v2.cu",
                                    "gecco_tpu/ops/pallas/folded_attention.py:1563"),
    "folded_pool_ext_bwd_v2j_wmma": ("gecco_tpu_torch/csrc/pool_ext_bwd_v2.cu",
                                     "gecco_tpu/ops/pallas/folded_attention.py:1718"),
}
# the fp32 routes (csrc/f32_simt.cu), each replacing for fp32 operands the
# TPU kernel its wrapper's bf16 bodies replace
SOURCES.update({
    f"{name}_f32": ("gecco_tpu_torch/csrc/f32_simt.cu", SOURCES[name][1])
    for name in ("rect_attention_fwd", "rect_attention_bwd", "folded_pool_ext", "fused_h_side",
                 "folded_unpool", "fused_mlp_residual", "folded_pool_ext_bwd",
                 "folded_unpool_bwd", "fused_mlp_residual_bwd", "folded_pool_layer",
                 "folded_pool_layer_bwd")
})
SET_FORWARD = ("folded_pool_ext", "fused_h_side", "folded_unpool", "fused_mlp_residual")
BACKWARD = ("folded_pool_ext_bwd", "folded_unpool_bwd", "fused_mlp_residual_bwd",
            "rect_attention_bwd")
FOLDED_BACKWARD = BACKWARD[:3]
WMMA_FORWARD = ("folded_pool_ext_wmma", "folded_unpool_wmma", "fused_mlp_residual_wmma")
WMMA_BACKWARD = ("folded_pool_ext_bwd_wmma", "folded_unpool_bwd_wmma",
                 "fused_mlp_residual_bwd_wmma")
GATHER = ("projective_gather", "projective_gather_bwd")
# and their SIMT bodies, for the profiles' split
GATHER_KERNELS = (*GATHER, "projective_gather_simt", "projective_gather_bwd_simt")


def sh(*cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps=10, warmup=2) -> float:
    """Median milliseconds of one call: CUDA events around each call on the
    card, the host clock around each synchronised call elsewhere."""
    return statistics.median(time_all(fn, device, reps, warmup))


def time_all(fn, device, reps=10, warmup=2) -> list:
    """Milliseconds of each of ``reps`` calls, timed as ``time_ms`` does."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return times


def rel_err(a, ref) -> float:
    a, ref = a.float(), ref.float()
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def abs_err(a, ref) -> float:
    return float((a.float() - ref.float()).abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, bytes_: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, bytes_ / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------- operands --


def head_scales(c, heads, drift, device):
    """Per-channel scale: 1, or per head 60, 1, 0.1, 0.01 repeated, so one
    head's logits are ~60x another's and the heads' maxima sit >80 apart."""
    if not drift:
        return torch.ones(c, device=device)
    pattern = torch.tensor([60.0, 1.0, 0.1, 0.01], device=device)
    return pattern.repeat(heads // 4 + 1)[:heads].repeat_interleave(c // heads)


def pool_operands(g, b, n, c, heads, i, drift, device, dt):
    d = c // heads
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    x = r(b, n, c).to(dt)
    se = torch.ones(b, c, device=device) if drift else 1.0 + 0.1 * r(b, c)
    be = torch.zeros(b, c, device=device) if drift else 0.1 * r(b, c)
    kvw = r(2 * c, c) / c**0.5
    kvw[:c] *= head_scales(c, heads, drift, device)[:, None]
    return (x, se, be, r(heads * i, d).to(dt), kvw.to(dt), (r(c, c) / c**0.5).to(dt))


def hside_operands(g, b, i, c, w, drift, device, dt):
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    h0 = r(b, i, c) * (head_scales(c, 8, True, device) if drift else 1.0)
    aff = [1.0 + 0.2 * r(b, c), 0.2 * r(b, c), 1.0 + 0.2 * r(b, c), 0.2 * r(b, c)]
    return (h0.to(dt), *aff, fa.group_indicator(c, GROUPS, device),
            (r(c, w) / c**0.5).to(dt), 0.1 * r(1, w), (r(w, c) / w**0.5).to(dt), 0.1 * r(1, c),
            (r(c, c) / c**0.5).to(dt), (r(c, c) / c**0.5).to(dt))


def unpool_operands(g, b, n, c, heads, i, drift, device, dt):
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    se = torch.ones(b, c, device=device) if drift else 1.0 + 0.1 * r(b, c)
    be = torch.zeros(b, c, device=device) if drift else 0.1 * r(b, c)
    k = r(b, i, c) * head_scales(c, heads, drift, device)
    return (r(b, n, c).to(dt), se, be, k.to(dt), r(b, i, c).to(dt),
            (r(c, c) / c**0.5).to(dt), (r(c, c) / c**0.5).to(dt))


def mlp_operands(g, b, n, c, w, drift, device, dt):
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    x = r(b, n, c) * (head_scales(c, 8, True, device) if drift else 1.0)
    return (x.to(dt), 1.0 + 0.1 * r(b, c), 0.1 * r(b, c), (r(c, w) / c**0.5).to(dt),
            0.1 * r(1, w), (r(w, c) / w**0.5).to(dt), 0.1 * r(1, c))


def mlp_wmma_fwd(ops):
    """The MLP forward's WMMA body on any shape it takes (on the CPU, the
    plain version)."""
    return fa._mlp_wmma(*ops) if ops[0].is_cuda else fa._mlp_ref(*ops)


def mlp_wmma_bwd(ops, gg, gs):
    """The MLP backward's WMMA body, its weight gradients cast as
    ``fused_mlp_residual_bwd`` casts them (on the CPU, the plain version)."""
    if not ops[0].is_cuda:
        return fa._mlp_bwd_ref(*ops, gg, gs)
    dx, dse, dbe, dw1t, db1, dw2t, db2 = fa._mlp_bwd_wmma(*ops, gg, gs)
    return dx, dse, dbe, dw1t.to(ops[3].dtype), db1, dw2t.to(ops[5].dtype), db2


def device_ms(fn, device):
    """Device milliseconds of one call (``torch.profiler``: the kernels'
    own time, without the host's time to launch them), None off the card."""
    return sum(launch_split(fn).values()) if device.type == "cuda" else None


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.3f} ms"


def bodies_in_turns(hopper, wmma, device, reps, names=("hopper", "wmma")) -> dict:
    """Two bodies of one function timed in turns: reps / 2 of the second
    (by default the WMMA body), reps of the first (the Hopper body), reps /
    2 of the second -> sorted milliseconds per body, keyed by ``names``."""
    half = max(1, reps // 2)
    t_w = time_all(wmma, device, half)
    t_h = time_all(hopper, device, half) + time_all(hopper, device, half)
    return {names[0]: sorted(t_h), names[1]: sorted(t_w + time_all(wmma, device, half))}


@contextlib.contextmanager
def pool_bwd_forced(body):
    """``GECCO_POOL_BWD`` forced to ``body`` in this process: the module
    global that the variable sets at import, as the JAX package's tests
    set theirs; restored after."""
    keep = fa._POOL_BWD_ENV
    fa._POOL_BWD_ENV = body
    try:
        yield
    finally:
        fa._POOL_BWD_ENV = keep



# ------------------------------------------------------------ yardsticks --


def sdpa_pool(ops, heads):
    """Per-head SDPA of the inducer queries over the unfolded k/v."""
    x, se, be, ind2, kvw, _ = ops
    b, n, c = x.shape
    d = c // heads
    y = (x.float() * se[:, None] + be[:, None]).to(x.dtype)
    k, v = (y @ kvw.T).chunk(2, dim=-1)
    split = lambda t: t.reshape(b, -1, heads, d).transpose(1, 2).contiguous()
    q = ind2.reshape(heads, -1, d)[None].expand(b, -1, -1, -1).contiguous()
    k, v = split(k), split(v)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


def sdpa_unpool(ops, heads):
    x, se, be, k, v, wq, _ = ops
    b, n, c = x.shape
    d = c // heads
    y = (x.float() * se[:, None] + be[:, None]).to(x.dtype)
    split = lambda t: t.reshape(b, -1, heads, d).transpose(1, 2).contiguous()
    q, kk, vv = split(y @ wq.T), split(k), split(v)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, kk, vv)


def _split_heads(t, heads):
    b, m, c = t.shape
    return t.reshape(b, m, heads, c // heads).transpose(1, 2)


def chain_pool(ops, heads):
    """The whole pool as PyTorch calls (the fair yardstick: SDPA alone
    leaves out the projections, most of the function's products): the
    pre-norm, y @ kvw^T, per-head SDPA of the inducer queries, @ Wo^T."""
    x, se, be, ind2, kvw, wo = ops
    b, _, c = x.shape
    q = ind2.reshape(heads, -1, c // heads)[None].expand(b, -1, -1, -1).contiguous()

    def run():
        y = (x.float() * se[:, None] + be[:, None]).to(x.dtype)
        k, v = (y @ kvw.T).chunk(2, dim=-1)
        o = torch.nn.functional.scaled_dot_product_attention(
            q, _split_heads(k, heads), _split_heads(v, heads))
        return o.transpose(1, 2).reshape(b, -1, c) @ wo.T

    return run


def chain_unpool(ops, heads):
    """The whole unpool as PyTorch calls: the pre-norm, y @ wq^T, per-head
    SDPA over the inducer tokens, @ Wo^T, the residual and the channel
    sums."""
    x, se, be, k, v, wq, wo = ops
    b, n, c = x.shape
    kk, vv = _split_heads(k, heads).contiguous(), _split_heads(v, heads).contiguous()

    def run():
        y = (x.float() * se[:, None] + be[:, None]).to(x.dtype)
        o = torch.nn.functional.scaled_dot_product_attention(_split_heads(y @ wq.T, heads), kk, vv)
        o = x.float() + (o.transpose(1, 2).reshape(b, n, c) @ wo.T).float()
        return o.to(x.dtype), torch.stack([o.sum(1), (o * o).sum(1)], dim=1)

    return run


def chain_hside(ops):
    """The whole h-side as PyTorch calls: the set-level GroupNorm (over the
    tokens and a group's channels) with the AdaGN affine, Linear, the
    Gaussian activation, Linear, the second GroupNorm and affine, and the k
    and v projections."""
    h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv = ops
    groups = gind.shape[1]
    w1, w2, bb1, bb2 = w1t.t(), w2t.t(), b1[0].to(h0.dtype), b2[0].to(h0.dtype)
    f = torch.nn.functional

    def norm(z, s, b):
        zn = f.group_norm(z.transpose(1, 2), groups).transpose(1, 2)
        return zn * s[:, None].to(z.dtype) + b[:, None].to(z.dtype)

    def run():
        a = f.linear(norm(h0, s1, b1n), w1, bb1)
        h = norm(f.linear(torch.exp(-0.5 * a * a), w2, bb2), s2, b2n)
        return h, f.linear(h, wk), f.linear(h, wv)

    return run


def chain_backward(make_chain, ops, heads, cots):
    """The backward of a chain yardstick alone under autograd, to every
    operand (its forward run once, outside the timed call), against the
    cotangents ``cots`` of its outputs."""
    leaves = [a.detach().requires_grad_(True) for a in ops]
    outs = make_chain(leaves, heads)()
    outs = outs if isinstance(outs, tuple) else (outs,)
    return lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True)


# ---------------------------------------------------------------- phases --


def check(name, err, tol, what="max|err|/max|ref|"):
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: {what} = {err:.3e} (tol {tol:.0e}) {status}")
    if err > tol:
        raise AssertionError(f"{name}: error {err:.3e} above tolerance {tol:.0e}")


def hside_checks(device, g, shapes, big, demo, dt, reps, hopper_rec) -> dict:
    """The h-side's Hopper body at the flagship's, the 8k width's and the
    demo's shapes and at 16, 32 and 48 inducers, ordinary and drifted,
    against the plain version (every output the same bits in two calls);
    its passes against their plain pieces on the kernel's own inputs; the
    WMMA body against the plain version on the flagship's operands and at
    C 192 (a width only it takes), timed in turns with the Hopper body;
    each check's body by its launch counts. Returns the WMMA body's record
    and adds the Hopper body's I 16-48, 8k and demo times to
    ``hopper_rec``."""
    b, c, i = shapes["batch"], shapes["feature_dim"], shapes["num_inducers"]
    cases = {"flagship": (b, i, c, 2 * c),
             "8k width": (big["batch"], big["num_inducers"], big["feature_dim"],
                          2 * big["feature_dim"]),
             "demo": (demo["batch"], demo["num_inducers"], demo["feature_dim"],
                      2 * demo["feature_dim"]),
             **{f"I {ii}": (b, ii, c, 2 * c) for ii in (16, 32, 48)}}
    hopper = device.type == "cuda"
    for name, (bb, ii, cc, ww) in cases.items():
        for drift in (False, True):
            tag = f"{name}, {'drift' if drift else 'ordinary'}"
            args = hside_operands(g, bb, ii, cc, ww, drift, device, dt)
            first, want = hs.fused_h_side(*args), hs._hside_ref(*args)
            sync(device)
            for q, (a, r) in enumerate(zip(first, want)):
                check(f"fused_h_side [{tag}] out{q}", rel_err(a, r), TOL_OUT)
            again = hs.fused_h_side(*args)
            if not all(torch.equal(x, y) for x, y in zip(first, again)):
                raise AssertionError(f"fused_h_side [{tag}]: two calls differ")
            if hopper and not drift:
                # each pass against its plain piece on the kernel's inputs
                for piece, err in hside_passes(args).items():
                    check(f"fused_h_side [{tag}] pass output {piece}", err,
                          TOL_STATS if piece in ("hh", "slabs") else TOL_OUT)
        if name != "flagship":
            args = hside_operands(g, bb, ii, cc, ww, False, device, dt)
            key = f"ms_{name.replace(' ', '_')}"
            hopper_rec[key] = time_ms(lambda: hs.fused_h_side(*args), device, reps)
            print(f"  fused_h_side at the {name} ({bb} x {ii} x {cc}, W {ww}): "
                  f"{hopper_rec[key]:.3f} ms")
    counts = kernels.launch_counts()
    if hopper and (counts["fused_h_side"] == 0 or counts["fused_h_side_wmma"]):
        raise AssertionError(f"the h-side checks did not run the Hopper body: {counts}")

    # the WMMA body: on the flagship's operands (timed in turns with the
    # Hopper body) and at C 192, which only it takes
    wmma = hs._hside_wmma if hopper else hs._hside_ref
    for drift in (False, True):
        for bb, cc in ((b, c), (b, 192)):
            tag = f"C {cc}, {'drift' if drift else 'ordinary'}"
            args = hside_operands(g, bb, i, cc, 2 * cc, drift, device, dt)
            fn = hs.fused_h_side if cc == 192 else wmma
            for q, (a, r) in enumerate(zip(fn(*args), hs._hside_ref(*args))):
                check(f"fused_h_side WMMA body [{tag}] out{q}", rel_err(a, r), TOL_OUT)
    counts = kernels.launch_counts()
    if hopper and counts["fused_h_side_wmma"] == 0:
        raise AssertionError(f"the WMMA h-side did not run: {counts}")
    args = hside_operands(g, b, i, c, 2 * c, False, device, dt)
    turns = bodies_in_turns(lambda: hs.fused_h_side(*args), lambda: wmma(*args), device, reps)
    for body, t in turns.items():
        print(f"  fused_h_side, {body} body, at the flagship: median {statistics.median(t):.3f} "
              f"ms of {len(t)} calls (min {t[0]:.3f}, max {t[-1]:.3f})")
    hopper_rec["ms_in_turns"] = statistics.median(turns["hopper"])
    hopper_rec["ms_min_max"] = [turns["hopper"][0], turns["hopper"][-1]]
    w_args = hside_operands(g, b, i, 192, 384, False, device, dt)
    return {"fused_h_side_wmma": dict(
        max_abs_err=max(abs_err(a, r) for a, r in zip(wmma(*args), hs._hside_ref(*args))),
        ms=statistics.median(turns["wmma"]), ms_min_max=[turns["wmma"][0], turns["wmma"][-1]],
        plain_ms=hopper_rec["plain_ms"], bound_ms=hopper_rec["bound_ms"],
        bound_by=hopper_rec["bound_by"], library_ms=None,
        library_chain_ms=hopper_rec["library_chain_ms"],
        ms_c192=time_ms(lambda: hs.fused_h_side(*w_args), device, reps))}


def kernel_phase(device, shapes, big, demo, heads3, dt, reps):
    """Every kernel against its plain version; returns per-kernel records.
    The pool and unpool forwards' Hopper and WMMA bodies at the ``demo``
    model's shapes (each timed, then both in turns), the MLP's WMMA body
    there, and the WMMA bodies at their own shapes, ``heads3``'s three
    heads."""
    g = torch.Generator(device=device).manual_seed(1)
    b, n, c, heads, i = shapes["batch"], shapes["n_points"], shapes["feature_dim"], \
        shapes["num_heads"], shapes["num_inducers"]
    w = 2 * c
    rec = {}

    def run(name, fn, ref, ops, nouts, flops, in_out, library=None, chain=None):
        errs = []
        for drift in (False, True):
            args = ops(drift)
            got, want = fn(*args), ref(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            sync(device)
            tag = "drift" if drift else "ordinary"
            for q, (a, r) in enumerate(zip(got, want)):
                is_sums = q == 1 and nouts == 2
                check(f"{name} [{tag}] {'sums' if is_sums else f'out{q}'}",
                      rel_err(a, r), TOL_SUMS if is_sums else TOL_OUT)
                if not is_sums:
                    errs.append(abs_err(a, r))
        args = ops(False)
        ms = time_ms(lambda: fn(*args), device, reps)
        plain_ms = time_ms(lambda: ref(*args), device, max(2, reps // 4))
        lib_ms = time_ms(library(args), device, reps) if library else None
        chain_ms = time_ms(chain(args), device, reps) if chain else None
        bms, by = bound(flops, nbytes(*[a for a in args if torch.is_tensor(a)],
                                      *in_out(args)))
        rec[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib_ms, library_chain_ms=chain_ms)
        lib_txt = f"{lib_ms:.3f}" if lib_ms is not None else "n/a"
        chain_txt = f", chain {chain_ms:.3f} ms" if chain_ms is not None else ""
        print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_txt} ms"
              f"{chain_txt}, bound {bms:.3f} ms ({by})")

    d = c // heads
    j = heads * i
    run("folded_pool_ext", lambda *a: fa.folded_pool_ext(*a, heads),
        lambda *a: fa._pool_ext_ref(*a, heads),
        lambda drift: pool_operands(g, b, n, c, heads, i, drift, device, dt), 1,
        2 * b * n * c * j + 2 * b * n * c * c + 2 * b * n * j * d + 2 * b * i * c * c,
        lambda a: [torch.empty(b, i, c, dtype=dt)],
        lambda a: sdpa_pool(a, heads), lambda a: chain_pool(a, heads))
    kernels.reset_launch_counts()
    run("fused_h_side", hs.fused_h_side, hs._hside_ref,
        lambda drift: hside_operands(g, b, i, c, w, drift, device, dt), 3,
        4 * b * i * c * w + 4 * b * i * c * c,
        lambda a: [torch.empty(3, b, i, c, dtype=dt)], chain=chain_hside)
    rec.update(hside_checks(device, g, dict(shapes), big, demo, dt, reps, rec["fused_h_side"]))
    run("folded_unpool", lambda *a: fa.folded_unpool(*a, heads),
        lambda *a: fa._unpool_ref(*a, heads),
        lambda drift: unpool_operands(g, b, n, c, heads, i, drift, device, dt), 2,
        4 * b * n * c * j + 4 * b * j * c * d,
        lambda a: [a[0], torch.empty(b, 2, c)],
        lambda a: sdpa_unpool(a, heads), lambda a: chain_unpool(a, heads))
    run("fused_mlp_residual", fa.fused_mlp_residual, fa._mlp_ref,
        lambda drift: mlp_operands(g, b, n, c, w, drift, device, dt), 2,
        4 * b * n * c * w,
        lambda a: [a[0], torch.empty(b, 2, c)])
    # the MLP forward's two bodies on the flagship's operands, in turns (10
    # WMMA, 20 Hopper, 10 WMMA calls), each time with its spread
    mlp_rec, mlp_wm = rec["fused_mlp_residual"], {}
    args = mlp_operands(g, b, n, c, w, False, device, dt)
    for body, t in bodies_in_turns(lambda: fa.fused_mlp_residual(*args),
                                       lambda: mlp_wmma_fwd(args), device, reps).items():
        out = mlp_rec if body == "hopper" else mlp_wm
        out["ms"], out["ms_min_max"] = statistics.median(t), [t[0], t[-1]]
        print(f"  fused_mlp_residual, {body} body, at the flagship: median "
              f"{statistics.median(t):.3f} ms of {len(t)} calls (min {t[0]:.3f}, max {t[-1]:.3f})")

    # the pool at the 8k width (C = 768, 16 heads, 8192 points)
    bb, nn_, cc, hh, ii = big["batch"], big["n_points"], big["feature_dim"], \
        big["num_heads"], big["num_inducers"]
    for drift in (False, True):
        args = pool_operands(g, bb, nn_, cc, hh, ii, drift, device, dt)
        err = rel_err(fa.folded_pool_ext(*args, hh), fa._pool_ext_ref(*args, hh))
        check(f"folded_pool_ext 8k width [{'drift' if drift else 'ordinary'}] out0", err, TOL_OUT)
    # the unpool at the 8k width
    for drift in (False, True):
        args = unpool_operands(g, bb, nn_, cc, hh, ii, drift, device, dt)
        got, want = fa.folded_unpool(*args, hh), fa._unpool_ref(*args, hh)
        sync(device)
        tag = "drift" if drift else "ordinary"
        check(f"folded_unpool 8k width [{tag}] out0", rel_err(got[0], want[0]), TOL_OUT)
        check(f"folded_unpool 8k width [{tag}] sums", rel_err(got[1], want[1]), TOL_SUMS)
    # the MLP at the 8k width (C 768, W 1536): the Hopper body, and the WMMA
    # body on the same operands; the Hopper body timed there
    for drift in (False, True):
        args = mlp_operands(g, bb, nn_, cc, 2 * cc, drift, device, dt)
        tag = "drift" if drift else "ordinary"
        want = fa._mlp_ref(*args)
        for body, got in (("", fa.fused_mlp_residual(*args)), (" WMMA body", mlp_wmma_fwd(args))):
            sync(device)
            check(f"fused_mlp_residual{body} 8k width [{tag}] out0", rel_err(got[0], want[0]),
                  TOL_OUT)
            check(f"fused_mlp_residual{body} 8k width [{tag}] sums", rel_err(got[1], want[1]),
                  TOL_SUMS)
    args = mlp_operands(g, bb, nn_, cc, 2 * cc, False, device, dt)
    mlp_rec["ms_8k"] = time_ms(lambda: fa.fused_mlp_residual(*args), device, reps)
    mlp_rec["bound_ms_8k"] = bound(4 * bb * nn_ * cc * 2 * cc, 2 * nbytes(args[0]))[0]
    print(f"  fused_mlp_residual at the 8k width: {mlp_rec['ms_8k']:.3f} ms (bound "
          f"{mlp_rec['bound_ms_8k']:.3f} ms)")

    # the pool and unpool forwards at the upsample demo's shapes (C 128, four
    # heads of 32): the Hopper bodies, which take them, and the WMMA bodies
    # forced there through the launchers' private body argument, each held
    # against its plain version and timed; then both in turns on the same
    # operands (the WMMA bodies' own shapes: three heads, below)
    db, dn, dc, dh, di = (demo[k] for k in ("batch", "n_points", "feature_dim", "num_heads",
                                            "num_inducers"))
    dd, dj = dc // dh, dh * di
    cuda = device.type == "cuda"
    pool_wmma = (lambda *a: fa._pool_ext_launch(*a, dh, False, body="wmma")[0]) if cuda else \
        (lambda *a: fa.folded_pool_ext(*a, dh))
    unpool_wmma = (lambda *a: fa._unpool_launch(*a, dh, True, True, body="wmma")) if cuda else \
        (lambda *a: fa.folded_unpool(*a, dh))
    demo_pool = dict(
        ref=lambda *a: fa._pool_ext_ref(*a, dh),
        ops=lambda drift: pool_operands(g, db, dn, dc, dh, di, drift, device, dt), nouts=1,
        flops=2 * db * dn * dc * dj + 2 * db * dn * dc * dc + 2 * db * dn * dj * dd
        + 2 * db * di * dc * dc,
        in_out=lambda a: [torch.empty(db, di, dc, dtype=dt)],
        library=lambda a: sdpa_pool(a, dh), chain=lambda a: chain_pool(a, dh))
    demo_unpool = dict(
        ref=lambda *a: fa._unpool_ref(*a, dh),
        ops=lambda drift: unpool_operands(g, db, dn, dc, dh, di, drift, device, dt), nouts=2,
        flops=4 * db * dn * dc * dj + 4 * db * dj * dc * dd,
        in_out=lambda a: [a[0], torch.empty(db, 2, dc)],
        library=lambda a: sdpa_unpool(a, dh), chain=lambda a: chain_unpool(a, dh))
    demo_ran = {}
    for name, hopper, wmma, kw in (
            ("folded_pool_ext", lambda *a: fa.folded_pool_ext(*a, dh), pool_wmma, demo_pool),
            ("folded_unpool", lambda *a: fa.folded_unpool(*a, dh), unpool_wmma, demo_unpool)):
        for body, fn in ((f"{name}_wmma", wmma), (f"{name} (demo)", hopper)):
            kernels.reset_launch_counts()
            run(body, fn, **kw)
            demo_ran[body] = kernels.launch_counts()
        # the Hopper body's demo record goes beside its flagship numbers
        demo_rec = rec.pop(f"{name} (demo)")
        rec[name].update({f"{k}_demo": v for k, v in demo_rec.items()})
        args = kw["ops"](False)
        turns = bodies_in_turns(lambda: hopper(*args), lambda: wmma(*args), device, reps)
        for body, t in turns.items():
            out = rec[name] if body == "hopper" else rec[f"{name}_wmma"]
            key = "ms_in_turns_demo" if body == "hopper" else "ms"
            out[key], out[f"{key}_min_max"] = statistics.median(t), [t[0], t[-1]]
            print(f"  {name}, {body} body, at the demo: median {statistics.median(t):.3f} ms of "
                  f"{len(t)} calls in turns (min {t[0]:.3f}, max {t[-1]:.3f})")
        if cuda:
            rec[f"{name}_wmma"]["device_ms_demo"] = device_ms(lambda: wmma(*args), device)
            rec[name]["device_ms_demo"] = device_ms(lambda: hopper(*args), device)
            print(f"  {name} at the demo, device time: Hopper body "
                  f"{fmt_ms(rec[name]['device_ms_demo'])}, WMMA body "
                  f"{fmt_ms(rec[f'{name}_wmma']['device_ms_demo'])}")
    if cuda:
        for body, counts in demo_ran.items():
            fn = body.split(" ")[0]
            hop = fn.removesuffix("_wmma")
            want, other = (fn, hop) if fn.endswith("_wmma") else (hop, f"{hop}_wmma")
            if counts[want] == 0 or counts[other]:
                raise AssertionError(f"{body} at the demo did not run its body alone: {counts}")
    kernels.reset_launch_counts()
    run("fused_mlp_residual_wmma", fa.fused_mlp_residual, fa._mlp_ref,
        lambda drift: mlp_operands(g, db, dn, dc, 2 * dc, drift, device, dt), 2,
        4 * db * dn * dc * 2 * dc,
        lambda a: [a[0], torch.empty(db, 2, dc)])
    rec["fused_mlp_residual_wmma"].update(
        {"ms_flagship": mlp_wm["ms"], "ms_min_max_flagship": mlp_wm["ms_min_max"]})
    hb, hn, hc, hh3, hi = (heads3[k] for k in ("batch", "n_points", "feature_dim", "num_heads",
                                               "num_inducers"))
    for drift in (False, True):
        tag = f"num_heads={hh3}, {'drift' if drift else 'ordinary'}"
        args = pool_operands(g, hb, hn, hc, hh3, hi, drift, device, dt)
        check(f"folded_pool_ext [{tag}] out0",
              rel_err(fa.folded_pool_ext(*args, hh3), fa._pool_ext_ref(*args, hh3)), TOL_OUT)
        args = unpool_operands(g, hb, hn, hc, hh3, hi, drift, device, dt)
        got, want = fa.folded_unpool(*args, hh3), fa._unpool_ref(*args, hh3)
        sync(device)
        check(f"folded_unpool [{tag}] out0", rel_err(got[0], want[0]), TOL_OUT)
        check(f"folded_unpool [{tag}] sums", rel_err(got[1], want[1]), TOL_SUMS)
        # the MLP sees no heads: at three heads its width is the flagship's
        # (the Hopper body)
        args = mlp_operands(g, hb, hn, hc, 2 * hc, drift, device, dt)
        got, want = fa.fused_mlp_residual(*args), fa._mlp_ref(*args)
        sync(device)
        check(f"fused_mlp_residual [{tag}] out0", rel_err(got[0], want[0]), TOL_OUT)
        check(f"fused_mlp_residual [{tag}] sums", rel_err(got[1], want[1]), TOL_SUMS)
    counts = kernels.launch_counts()
    print(f"  launches of the forwards' bodies in these checks: "
          f"{ {k: counts[k] for k in SET_FORWARD[::2] + ('fused_mlp_residual',) + WMMA_FORWARD} }")
    if device.type == "cuda" and (counts["folded_pool_ext_wmma"] == 0
                                  or counts["folded_unpool_wmma"] == 0
                                  or counts["fused_mlp_residual_wmma"] == 0
                                  or counts["folded_pool_ext"] or counts["folded_unpool"]
                                  or counts["fused_mlp_residual"] != 2):
        raise AssertionError(f"the demo's MLP and the num_heads=3 shapes did not run the "
                             f"expected bodies: {counts}")
    return rec


def sdpa_backward(q, k, v, g):
    """The backward of per-head ``scaled_dot_product_attention`` alone (the
    forward is run once, outside the timed call)."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    go = torch.randn(out.shape, generator=g, device=out.device).to(out.dtype)
    return lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True)


def sdpa_pool_bwd(ops, heads, g):
    x, se, be, ind2, kvw, _ = ops
    b, n, c = x.shape
    d = c // heads
    y = (x.float() * se[:, None] + be[:, None]).to(x.dtype)
    k, v = (y @ kvw.T).chunk(2, dim=-1)
    split = lambda t: t.reshape(b, -1, heads, d).transpose(1, 2).contiguous()
    q = ind2.reshape(heads, -1, d)[None].expand(b, -1, -1, -1).contiguous()
    return sdpa_backward(q, split(k), split(v), g)


def sdpa_unpool_bwd(ops, heads, g):
    x, se, be, k, v, wq, _ = ops
    b, n, c = x.shape
    d = c // heads
    y = (x.float() * se[:, None] + be[:, None]).to(x.dtype)
    split = lambda t: t.reshape(b, -1, heads, d).transpose(1, 2).contiguous()
    return sdpa_backward(split(y @ wq.T), split(k), split(v), g)


def pool_bwd_v3_affine(x, se, be, ind2, kvw, wo, g_h0, heads):
    """dse, dbe of the pool backward by the TPU kernel's own algebra (v3,
    the header of ``csrc/pool_ext_bwd.cu``) in plain PyTorch, fp32 with
    that algebra's bf16 roundings of e, eTy, DMs, W2/W3 and ds: the witness
    of the pool's drifted dbe tolerance."""
    bf = torch.bfloat16
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // heads
    y = (x.float() * se[:, None] + be[:, None]).to(bf).float()
    qf = fa.fold_qf(ind2, kvw, heads).float()
    s = y @ qf
    z = s - s.amax(1, keepdim=True)
    e = torch.exp(z.clamp_min(-80.0))
    inv = 1.0 / e.sum(1).reshape(b, heads, i, 1)
    ety = (e.to(bf).float().transpose(1, 2) @ y).to(bf).float().reshape(b, heads, i, c)
    wv = kvw[c:].float().reshape(heads, d, c)
    dms = (g_h0.float() @ wo.float()).reshape(b, i, heads, d).transpose(1, 2)
    dms = (dms * inv).to(bf).float()
    tacc = (dms * torch.einsum("bhic,hdc->bhid", ety, wv)).sum(-1, keepdim=True) * inv
    w3 = torch.einsum("bhid,hdc->bhic", dms, wv).to(bf).float().reshape(b, j, c)
    ds = torch.where(z > -80.0, e * (y @ w3.transpose(1, 2) - tacc.reshape(b, 1, j)), 0.0)
    dy = ds.to(bf).float() @ qf.T + e.to(bf).float() @ w3
    return (dy * x.float()).sum(1), dy.sum(1)


def pool_layer_bwd_tpu_algebra(x, scale, bias, ind2, kvw, wo, gind, g_h0, heads):
    """dscale, dbias of the resident pool's backward (with its pre-norm) by
    the TPU kernel's own algebra (``_pool_bwd_kernel``, the header of
    ``csrc/pool_bwd.cu``) in plain PyTorch, fp32 with that algebra's bf16
    roundings of y, p, v, dpool, dv and ds: the witness of the resident
    pool's drifted dbias tolerance."""
    bf = torch.bfloat16
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // heads
    mean, inv = group_norm_stats(x, gind.shape[1])
    xc = x.float() - mean[:, None]
    y = (xc * (inv * scale)[:, None] + bias[:, None]).to(bf).float()
    qf = fa.fold_qf(ind2, kvw, heads).float()
    wv = kvw[c:].float()
    s = y @ qf
    z = (s - s.amax(1, keepdim=True)).reshape(b, n, heads, i)
    e = torch.exp(z.clamp_min(-80.0))
    p = (e / e.sum(1, keepdim=True)).to(bf).float()
    v = (y @ wv.T).to(bf).float().reshape(b, n, heads, d)
    pacc = torch.einsum("bnhi,bnhd->bihd", p, v)
    dpool = (g_h0.float() @ wo.float()).to(bf).float().reshape(b, i, heads, d)
    t = (dpool * pacc).sum(-1).transpose(1, 2)[:, None]
    dp = torch.einsum("bnhd,bihd->bnhi", v, dpool)
    dv = torch.einsum("bnhi,bihd->bnhd", p, dpool).to(bf).float().reshape(b, n, c)
    ds = torch.where(z > -80.0, p * (dp - t), 0.0).to(bf).float().reshape(b, n, j)
    dy = ds @ qf.T + dv @ wv
    return (dy * xc).sum(1) * inv, dy.sum(1)


def twopass_checks(device, widths, own, g, dt, reps, pool_rec, compare) -> dict:
    """The pool backward's v1, v2 and v2j algebras (``GECCO_POOL_BWD``) at
    ``widths`` (the flagship's and the 8k width, three heads), ordinary and
    drifted, each in its two bodies (the Hopper body, which the switch
    takes there, and the WMMA body, forced): each body's outputs (dx, dse, dbe, dqf,
    dWv, dWo) against its plain version, the same algebra and roundings,
    at TOL_ALGEBRA_GRAD, dse and dbe at TOL_AFFINE (the drifted dbe is a
    residue of cancelling terms, summed over N in another order: chip
    readings up to 1.41e-2); each pass of the Hopper body against its
    plain piece on the kernel's own inputs (``probes.pool_bwd_twopass``);
    each algebra through ``folded_pool_ext_bwd`` (the Hopper body) against
    autograd of the plain version as the v3 bodies are held (the drifted
    dbe against the body's own algebra, its witness); v2j the same bits
    as v2 in each body, and every output the same bits in two calls.
    Times each algebra's Hopper body, its WMMA body, the v3 Hopper body
    and SDPA's backward (the yardstick) in turns at both widths (median,
    min and max of 20 calls each), reads each one's device time, and its
    plain version at the flagship's; the bound, library and chain times
    are row 8's (``pool_rec``: the same function at the same shapes), the
    bound at three heads this function's. Each width's readings carry its
    suffix (none, ``_8k``, ``_3h``). The WMMA body also at its own shapes
    ``own`` (the demo's C 128), where its record's time, plain time, bound
    and yardstick are taken. Returns one record per body."""
    bodies = kernels.TWOPASS_BODIES
    r = lambda *sh: torch.randn(*sh, generator=g, device=device)
    outs_named = ("dx", "dse", "dbe", "dqf", "dwv", "dwo")
    impls = ("hopper", "wmma")
    key = lambda body, impl: body if impl == "hopper" else f"{body}_wmma"
    suffix = {"flagship": "", "8k width": "_8k", "three heads": "_3h"}

    def bound_at(shape, ops, outs):
        """The bound at ``shape``: row 8's products and bytes (each input
        read once, the cotangent and the statistics too, each gradient
        written once)."""
        bb, nn_, cc, hh, ii = shape
        return bound(6 * 2 * bb * nn_ * cc * hh * ii + 6 * 2 * bb * hh * ii * (cc // hh) * cc,
                     nbytes(*[a for a in ops if torch.is_tensor(a)], *outs)
                     + 2 * bb * ii * cc + 2 * 4 * bb * hh * ii)

    def case(bb, nn_, cc, hh, ii, drift):
        ops = pool_operands(g, bb, nn_, cc, hh, ii, drift, device, dt)
        x, se, be, ind2, kvw, wo = ops
        if device.type == "cuda":
            _, qft, macc, sacc = fa._pool_ext_launch(*ops, hh, True)
        else:
            qft = fa._fold_qft_ref(ind2, kvw, hh)
            _, macc, sacc = fa._pool_merge_ref(*fa._pool_partials_ref(x, se, be, qft, kvw, hh),
                                               wo, hh)
        gh = (0.1 * r(bb, ii, cc)).to(dt)
        raw = (x, se, be, qft, kvw, wo, gh, macc, sacc, hh)
        return ops, (qft, macc, sacc), gh, raw

    def body_raw(body, raw, impl):
        """The body's outputs (on the CPU its plain version)."""
        if device.type != "cuda":
            return fa._TWOPASS_REFS[body](*raw)
        return fa._pool_ext_bwd_twopass(*raw, body, impl)

    errs = {key(body, m): [] for body in bodies for m in impls}
    kernels.reset_launch_counts()
    for width, shape in widths.items():
        for drift in (False, True):
            tag = f"{width}, {'drift' if drift else 'ordinary'}"
            ops, stats, gh, raw = case(*shape, drift)
            hh = shape[3]
            got = {}
            for body in bodies:
                want = fa._TWOPASS_REFS[body](*raw)
                for impl in impls:
                    name = f"folded_pool_ext_bwd_{key(body, impl)}"
                    first, again = body_raw(body, raw, impl), body_raw(body, raw, impl)
                    sync(device)
                    for out, a, ref in zip(outs_named, first, want):
                        tol = TOL_AFFINE if out in ("dse", "dbe") else TOL_ALGEBRA_GRAD
                        check(f"{name} [{tag}] {out} against its plain version", rel_err(a, ref),
                              tol)
                        errs[key(body, impl)].append(abs_err(a, ref))
                    same = all(torch.equal(p, q) for p, q in zip(first, again))
                    print(f"  {name} [{tag}]: every output of two calls "
                          f"{'the same bits' if same else 'DIFFER'}")
                    if device.type == "cuda" and not same:
                        raise AssertionError(f"{name}'s outputs differ between two calls")
                    got[body, impl] = first
                if device.type == "cuda":
                    p = twopass_passes(raw, body)
                    print(f"  folded_pool_ext_bwd_{body} [{tag}] passes against their pieces: "
                          + ", ".join(f"{k} {v:.3e}" for k, v in p.items()))
                    bad = twopass_pass_failures(p)
                    if bad:
                        raise AssertionError(f"folded_pool_ext_bwd_{body} [{tag}] passes: "
                                             + "; ".join(bad))
                witness = (lambda b_=body: fa._TWOPASS_REFS[b_](*raw)[1:3]) if drift else None
                with pool_bwd_forced(body):
                    compare("folded_pool_ext_bwd", f"{body} body, {tag}",
                            lambda: fa.folded_pool_ext_bwd(*ops, *stats, gh, hh),
                            lambda: fa._pool_ext_bwd_ref(*ops, gh, hh), witness, body)
            for impl in impls:
                same = all(torch.equal(p, q) for p, q in zip(got["v2", impl], got["v2j", impl]))
                print(f"  [{tag}] {impl} v2j against v2: {'the same bits' if same else 'DIFFER'}")
                if device.type == "cuda" and not same:
                    raise AssertionError(f"the {impl} v2j body's outputs differ from v2's")
    counts = kernels.launch_counts()
    print(f"  launches of the v1, v2 and v2j bodies in these checks: "
          f"{ {k: counts[k] for k in counts if k.startswith('folded_pool_ext_bwd')} }")
    # per algebra, width and operands: two calls of each body, one of the
    # wrapper and one of the passes (the Hopper body's)
    want = {b_: 4 * 2 * len(widths) for b_ in bodies}
    want.update({f"{b_}_wmma": 2 * 2 * len(widths) for b_ in bodies})
    if device.type == "cuda" and not (
            all(counts[f"folded_pool_ext_bwd_{k}"] == n_ for k, n_ in want.items())
            and counts["folded_pool_ext_bwd"] == 0):
        raise AssertionError(f"the forced pool backward did not run the forced bodies: {counts}")

    rec = {k: dict(max_abs_err=max(e), bound_ms=pool_rec["bound_ms"],
                   bound_by=pool_rec["bound_by"], bound_ms_8k=pool_rec["bound_ms_8k"],
                   library_ms=pool_rec["library_ms"],
                   library_chain_ms=pool_rec["library_chain_ms"]) for k, e in errs.items()}
    label = {"v3": "the v3 Hopper body", "sdpa": "SDPA's backward",
             "hopper": "the hopper body", "wmma": "the wmma body"}
    for width, shape in widths.items():
        wk = suffix[width]
        ops, stats, gh, raw = case(*shape, False)
        hh = shape[3]
        v3 = lambda: fa.folded_pool_ext_bwd(*ops, *stats, gh, hh)
        if wk == "_3h":
            b3 = bound_at(shape, ops, v3())
            for rr in rec.values():
                rr.update(bound_ms_3h=b3[0], bound_by_3h=b3[1])
        lib = sdpa_pool_bwd(ops, hh, g)
        dev = {"v3": device_ms(v3, device), "sdpa": device_ms(lib, device)}
        for body in bodies:
            fns = {"v3": v3, "sdpa": lib,
                   **{impl: (lambda b_=body, m=impl: body_raw(b_, raw, m)) for impl in impls}}
            turns = {k: [] for k in fns}
            for order in (list(fns), list(fns)[::-1]):
                for k in order:
                    turns[k] += time_all(fns[k], device, max(1, reps // 2))
            turns = {k: sorted(t) for k, t in turns.items()}
            dev.update({impl: device_ms(fns[impl], device) for impl in impls})
            for impl in impls:
                rr = rec[key(body, impl)]
                for name, field in (("v3", "v3_ms"), ("hopper", "hopper_ms"), ("wmma", "wmma_ms"),
                                    ("sdpa", "library_turns_ms"), (impl, "ms")):
                    rr[field + wk] = statistics.median(turns[name])
                    rr[field + "_min_max" + wk] = [turns[name][0], turns[name][-1]]
                rr.update({"device_ms" + wk: dev[impl], "v3_device_ms" + wk: dev["v3"],
                           "library_device_ms" + wk: dev["sdpa"]})
            print(f"  folded_pool_ext_bwd at the {width}, {body} in turns (median, min, max of "
                  f"{len(turns['v3'])} calls): "
                  + ", ".join(f"{label[k]} {statistics.median(t):.3f} ({t[0]:.3f}, {t[-1]:.3f}) ms"
                              for k, t in turns.items())
                  + "; device time a call: " + ", ".join(f"{label[k]} {fmt_ms(v)}"
                                                       for k, v in dev.items()))
            if not wk:
                plain_ms = time_ms(lambda: fa._TWOPASS_REFS[body](*raw), device,
                                   max(2, reps // 4))
                for impl in impls:
                    rec[key(body, impl)]["plain_ms"] = plain_ms

    # the WMMA body at its own shapes (the demo's C 128, where phase 21's
    # demo-width models run it): its time, device time, plain version,
    # bound and SDPA backward yardstick there are the ``_wmma`` entries' (the
    # flagship-shape readings above kept as ``*_flagship``)
    bb, nn_, cc, hh, ii = own
    ops, stats, gh, raw = case(*own, False)
    lib = sdpa_pool_bwd(ops, hh, g)
    own_bound = bound_at(own, ops, fa.folded_pool_ext_bwd(*ops, *stats, gh, hh))
    own_lib = dict(library_ms=time_ms(lib, device, reps), library_device_ms=device_ms(lib, device),
                   library_chain_ms=None)
    for body in bodies:
        fn = lambda b_=body: body_raw(b_, raw, "wmma")
        t = sorted(time_all(fn, device, reps))
        rr = rec[key(body, "wmma")]
        for k in ("ms", "ms_min_max", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "library_chain_ms", "device_ms", "library_device_ms"):
            rr[k + "_flagship"] = rr.pop(k)
        rr.update(ms=statistics.median(t), ms_min_max=[t[0], t[-1]],
                  device_ms=device_ms(fn, device), bound_ms=own_bound[0], bound_by=own_bound[1],
                  plain_ms=time_ms(lambda b_=body: fa._TWOPASS_REFS[b_](*raw), device,
                                   max(2, reps // 4)), **own_lib)
        print(f"  folded_pool_ext_bwd_{body}_wmma at its own shapes (B {bb}, N {nn_}, C {cc}, "
              f"{hh} heads, I {ii}; the demo's width): median {rr['ms']:.3f} ({t[0]:.3f}, {t[-1]:.3f}) ms of "
              f"{len(t)} calls, device {fmt_ms(rr['device_ms'])}, plain {rr['plain_ms']:.3f} "
              f"ms, bound {own_bound[0]:.3f} ms ({own_bound[1]}), sdpa backward "
              f"{own_lib['library_ms']:.3f} ms (device {fmt_ms(own_lib['library_device_ms'])})")
    return {f"folded_pool_ext_bwd_{k}": v for k, v in rec.items()}


def backward_phase(device, shapes, big, demo, heads3, dt, reps):
    """Every backward kernel against autograd of its plain version, each
    output against its own tolerance; returns per-kernel records. The
    unpool backward's two bodies at both widths; the bodies that the
    ``demo`` model's and ``heads3``'s shapes take."""
    g = torch.Generator(device=device).manual_seed(2)
    r = lambda *sh: torch.randn(*sh, generator=g, device=device)
    # the chain yardsticks' cotangents, apart from the checks' draws
    g_chain = torch.Generator(device=device).manual_seed(3)
    rc = lambda *sh: torch.randn(*sh, generator=g_chain, device=device)
    b, n, c, heads, i = shapes["batch"], shapes["n_points"], shapes["feature_dim"], \
        shapes["num_heads"], shapes["num_inducers"]
    w = 2 * c
    rec = {}

    def pool_case(bb, nn_, cc, hh, ii, drift):
        ops = pool_operands(g, bb, nn_, cc, hh, ii, drift, device, dt)
        if device.type == "cuda":
            _, qft, macc, sacc = fa._pool_ext_launch(*ops, hh, True)
        else:
            qft = macc = sacc = None
        gh = (0.1 * r(bb, ii, cc)).to(dt)
        kernel = lambda: fa.folded_pool_ext_bwd(*ops, qft, macc, sacc, gh, hh)
        plain = lambda: fa._pool_ext_bwd_ref(*ops, gh, hh)
        witness = lambda: pool_bwd_v3_affine(*ops, gh, hh)
        return ops, kernel, plain, witness

    def unpool_case(drift):
        ops = unpool_operands(g, b, n, c, heads, i, drift, device, dt)
        gg, gs = (0.1 * r(b, n, c)).to(dt), 1e-3 * r(b, 2, c)
        return (ops, lambda: fa.folded_unpool_bwd(*ops, gg, gs, heads),
                lambda: fa._unpool_bwd_ref(*ops, gg, gs, heads))

    def mlp_case(drift):
        ops = mlp_operands(g, b, n, c, w, drift, device, dt)
        gg, gs = (0.1 * r(b, n, c)).to(dt), 1e-3 * r(b, 2, c)
        return (ops, lambda: fa.fused_mlp_residual_bwd(*ops, gg, gs),
                lambda: fa._mlp_bwd_ref(*ops, gg, gs))

    names = {
        "folded_pool_ext_bwd": ("dx", "dse", "dbe", "dind2", "dkvw", "dwo"),
        "folded_unpool_bwd": ("dx", "dse", "dbe", "dk", "dv", "dwq", "dwo"),
        "fused_mlp_residual_bwd": ("dx", "dse", "dbe", "dw1t", "db1", "dw2t", "db2"),
    }

    def compare(name, tag, kernel, plain, witness=None, algebra="v3"):
        got, want = kernel(), plain()
        sync(device)
        errs = []
        for out, a, ref in zip(names[name], got, want):
            tol = TOL_AFFINE if out in ("dse", "dbe") else TOL_GRAD
            if witness is not None and out == "dbe":
                tol = TOL_POOL_DRIFT_DBE
                v3 = witness()[1]
                print(f"    witness: dbe by the {algebra} algebra in plain PyTorch against the "
                      f"plain version: {rel_err(v3, ref):.3e}")
                # on the CPU the "kernel" is the plain version itself
                if device.type == "cuda":
                    check(f"{name} [{tag}] dbe against the {algebra} algebra", rel_err(a, v3),
                          TOL_AFFINE)
            check(f"{name} [{tag}] {out}", rel_err(a, ref), tol)
            errs.append(abs_err(a, ref))
        return max(errs)

    d, j = c // heads, heads * i
    # per kernel: the products the gradient needs (a recompute of the
    # kernel's own design is not counted) and the bytes of the inputs that
    # are not operands of the forward: the cotangents, and the pool's
    # softmax statistics [B, J] fp32 (twice)
    cases = {
        "folded_pool_ext_bwd": (lambda drift: pool_case(b, n, c, heads, i, drift),
                                # s, e^T y, y W2, ds qf^T, e W3, y^T ds; the
                                # per-head fold: DMs, pacc, dWo, W2, W3, dWv
                                6 * 2 * b * n * c * j + 6 * 2 * b * j * d * c,
                                2 * b * i * c + 2 * 4 * b * j,
                                lambda ops: sdpa_pool_bwd(ops, heads, g),
                                lambda ops: chain_backward(chain_pool, ops, heads,
                                                           ((0.1 * rc(b, i, c)).to(dt),))),
        "folded_unpool_bwd": (unpool_case,
                              # logits, p vf, dp, ds kft, dkf, dvf; the fold
                              6 * 2 * b * n * c * j + 2 * 2 * b * j * d * c,
                              2 * b * n * c + 4 * 2 * b * c,
                              lambda ops: sdpa_unpool_bwd(ops, heads, g),
                              lambda ops: chain_backward(chain_unpool, ops, heads,
                                                         ((0.1 * rc(b, n, c)).to(dt),
                                                          1e-3 * rc(b, 2, c)))),
        "fused_mlp_residual_bwd": (mlp_case,
                                   # h, o, da, dy, dw1t, dw2t
                                   6 * 2 * b * n * c * w,
                                   2 * b * n * c + 4 * 2 * b * c, None, None),
    }
    for name, (make, flops, cot_bytes, library, chain) in cases.items():
        errs = []
        for drift in (False, True):
            _, kernel, plain, *witness = make(drift)
            errs.append(compare(name, "drift" if drift else "ordinary", kernel, plain,
                                witness[0] if witness and drift else None))
        ops, kernel, plain, *_ = make(False)
        ms = time_ms(kernel, device, reps)
        plain_ms = time_ms(plain, device, max(2, reps // 4))
        lib_ms = time_ms(library(ops), device, reps) if library else None
        chain_ms = time_ms(chain(ops), device, reps) if chain else None
        outs = kernel()
        # each input read once (operands and the cotangents), each gradient written once
        in_bytes = nbytes(*[a for a in ops if torch.is_tensor(a)])
        bms, by = bound(flops, in_bytes + cot_bytes + nbytes(*outs))
        rec[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib_ms, library_chain_ms=chain_ms)
        lib_txt = f"{lib_ms:.3f}" if lib_ms is not None else "none"
        chain_txt = f", chain {chain_ms:.3f} ms" if chain_ms is not None else ""
        print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_txt} ms"
              f"{chain_txt}, bound {bms:.3f} ms ({by})")

    # the pool backward at both widths: the 8k width (C = 768, 16 heads,
    # 8192 points) against its plain version, ordinary and drifted, its
    # drifted dbe against the v3 witness; each width's time with its spread
    # (20 calls) and the 8k width's bound; and dqf (through dind2, which
    # only dqf feeds) the same bits in two calls
    widths = {"flagship": (b, n, c, heads, i),
              "8k width": tuple(big[k] for k in ("batch", "n_points", "feature_dim", "num_heads",
                                                 "num_inducers"))}
    for drift in (False, True):
        _, kernel, plain, witness = pool_case(*widths["8k width"], drift)
        compare("folded_pool_ext_bwd", f"8k width, {'drift' if drift else 'ordinary'}",
                kernel, plain, witness if drift else None)
    pool_rec = rec["folded_pool_ext_bwd"]
    for width, shape in widths.items():
        ops, kernel, *_ = pool_case(*shape, False)
        t = sorted(time_all(kernel, device, reps))
        key = "" if width == "flagship" else "_8k"
        pool_rec["ms" + key] = statistics.median(t)
        pool_rec["ms_min_max" + key] = [t[0], t[-1]]
        print(f"  folded_pool_ext_bwd at the {width}: median {statistics.median(t):.3f} ms of "
              f"{len(t)} calls (min {t[0]:.3f}, max {t[-1]:.3f})")
        if key:
            bb, nn_, cc, hh, ii = shape
            outs = kernel()
            flops = 6 * 2 * bb * nn_ * cc * hh * ii + 6 * 2 * bb * hh * ii * (cc // hh) * cc
            bms, by = bound(flops, nbytes(*[a for a in ops if torch.is_tensor(a)], *outs)
                            + 2 * bb * ii * cc + 2 * 4 * bb * hh * ii)
            pool_rec["bound_ms_8k"] = bms
            print(f"  folded_pool_ext_bwd bound at the 8k width: {bms:.3f} ms ({by})")
    _, kernel, *_ = pool_case(b, n, c, heads, i, True)
    first, again = kernel(), kernel()
    sync(device)
    same = torch.equal(first[3], again[3])
    print(f"  folded_pool_ext_bwd: dind2 (from dqf) of two calls "
          f"{'the same bits' if same else 'DIFFER'}")
    if device.type == "cuda" and not same:
        raise AssertionError("the pool backward's dqf differs between two calls")
    dims = ("batch", "n_points", "feature_dim", "num_heads", "num_inducers")
    hshape = tuple(heads3[k] for k in dims)
    # the two-pass bodies at three heads too (their Hopper body's D 128
    # instance); their WMMA body's own shapes the demo's, at the training
    # batch
    dshape = tuple(dict(demo, batch=b)[k] for k in dims)
    rec.update(twopass_checks(device, dict(widths, **{"three heads": hshape}), dshape, g, dt,
                              reps, pool_rec, compare))

    # the unpool backward's two bodies at both widths on the same operands,
    # ordinary and drifted (the flagship's Hopper body is checked above);
    # each body's time with its spread (20 calls each, in turns: 10 WMMA,
    # 20 Hopper, 10 WMMA); dkf and dvf (through dk and dv, which only
    # they feed) the same bits in two calls of the Hopper body. On the CPU
    # both "bodies" are the plain version.
    def unpool_bodies(shape, drift):
        """-> (operands, the wrapper, the WMMA body forced on the same
        operands, the plain version)."""
        bb, nn_, cc, hh, ii = shape
        ops = unpool_operands(g, bb, nn_, cc, hh, ii, drift, device, dt)
        gg, gs = (0.1 * r(bb, nn_, cc)).to(dt), 1e-3 * r(bb, 2, cc)
        plain = lambda: fa._unpool_bwd_ref(*ops, gg, gs, hh)
        if device.type != "cuda":
            return ops, plain, plain, plain

        def wmma():
            dx, dse, dbe, dkf, dvf = fa._unpool_bwd_wmma(*ops, gg, gs, hh, True, True)
            return (dx, dse, dbe, *fa._chain_unpool(dkf, dvf, *ops[3:], hh))

        return ops, lambda: fa.folded_unpool_bwd(*ops, gg, gs, hh), wmma, plain

    un_rec = rec["folded_unpool_bwd"]
    wm_rec = dict(un_rec)  # the same function at the same shapes: bound and yardsticks
    wm_errs = []
    for width, shape in widths.items():
        key = "" if width == "flagship" else "_8k"
        if device.type == "cuda" and fa._unpool_bwd_body(*shape) != "hopper":
            raise AssertionError(f"the unpool backward at the {width} is not the Hopper body's")
        for drift in (False, True):
            _, hopper, wmma, plain = unpool_bodies(shape, drift)
            tag = f"{width}, {'drift' if drift else 'ordinary'}"
            if key:
                compare("folded_unpool_bwd", f"Hopper body, {tag}", hopper, plain)
            wm_errs.append(compare("folded_unpool_bwd", f"WMMA body, {tag}", wmma, plain))
        _, hopper, wmma, _ = unpool_bodies(shape, False)
        turns = bodies_in_turns(hopper, wmma, device, reps)
        for out, t, body in ((un_rec, turns["hopper"], "Hopper"), (wm_rec, turns["wmma"], "WMMA")):
            out["ms" + key] = statistics.median(t)
            out["ms_min_max" + key] = [t[0], t[-1]]
            print(f"  folded_unpool_bwd, {body} body, at the {width}: median "
                  f"{statistics.median(t):.3f} ms of {len(t)} calls (min {t[0]:.3f}, max "
                  f"{t[-1]:.3f})")
        first, again = hopper(), hopper()
        sync(device)
        same = torch.equal(first[3], again[3]) and torch.equal(first[4], again[4])
        print(f"  folded_unpool_bwd at the {width}: dk and dv (from dkf and dvf) of two calls "
              f"{'the same bits' if same else 'DIFFER'}")
        if device.type == "cuda" and not same:
            raise AssertionError("the unpool backward's dkf/dvf differ between two calls")

    # the MLP backward's two bodies at both widths on the same operands,
    # ordinary and drifted (the flagship's Hopper body is checked above);
    # each body's time with its spread (in turns: 10 WMMA, 20 Hopper, 10
    # WMMA calls); every output of the Hopper body, dw1t and dw2t among
    # them, the same bits in two calls
    mlp_rec, mlp_wm, mlp_wm_errs = rec["fused_mlp_residual_bwd"], {}, []
    for width, (bb, nn_, cc) in {"flagship": (b, n, c),
                                 "8k width": (big["batch"], big["n_points"],
                                              big["feature_dim"])}.items():
        key, ww = ("" if width == "flagship" else "_8k"), 2 * cc
        if device.type == "cuda" and fa._mlp_bwd_body(bb, nn_, cc, ww) != "hopper":
            raise AssertionError(f"the MLP backward at the {width} is not the Hopper body's")
        for drift in (False, True):
            ops = mlp_operands(g, bb, nn_, cc, ww, drift, device, dt)
            gg, gs = (0.1 * r(bb, nn_, cc)).to(dt), 1e-3 * r(bb, 2, cc)
            tag = f"{width}, {'drift' if drift else 'ordinary'}"
            plain = lambda: fa._mlp_bwd_ref(*ops, gg, gs)
            if key:
                compare("fused_mlp_residual_bwd", f"Hopper body, {tag}",
                        lambda: fa.fused_mlp_residual_bwd(*ops, gg, gs), plain)
            mlp_wm_errs.append(compare("fused_mlp_residual_bwd", f"WMMA body, {tag}",
                                       lambda: mlp_wmma_bwd(ops, gg, gs), plain))
        ops = mlp_operands(g, bb, nn_, cc, ww, False, device, dt)
        gg, gs = (0.1 * r(bb, nn_, cc)).to(dt), 1e-3 * r(bb, 2, cc)
        hopper = lambda: fa.fused_mlp_residual_bwd(*ops, gg, gs)
        turns = bodies_in_turns(hopper, lambda: mlp_wmma_bwd(ops, gg, gs), device, reps)
        for body, t in turns.items():
            # the WMMA body's own "ms" is the demo's, its serving width
            out, suffix = (mlp_rec, key) if body == "hopper" else (mlp_wm, key or "_flagship")
            out["ms" + suffix] = statistics.median(t)
            out["ms_min_max" + suffix] = [t[0], t[-1]]
            print(f"  fused_mlp_residual_bwd, {body} body, at the {width}: median "
                  f"{statistics.median(t):.3f} ms of {len(t)} calls (min {t[0]:.3f}, max "
                  f"{t[-1]:.3f})")
        first, again = hopper(), hopper()
        sync(device)
        if key:
            mlp_rec["bound_ms_8k"] = bound(6 * 2 * bb * nn_ * cc * ww,
                                           nbytes(*ops, gg, gs, *first))[0]
            print(f"  fused_mlp_residual_bwd bound at the 8k width: {mlp_rec['bound_ms_8k']:.3f} ms")
        same = all(torch.equal(p, q) for p, q in zip(first, again))
        print(f"  fused_mlp_residual_bwd at the {width}: every gradient (dw1t and dw2t among them) "
              f"of two calls {'the same bits' if same else 'DIFFER'}")
        if device.type == "cuda" and not same:
            raise AssertionError("the MLP backward's gradients differ between two calls")

    # the pool and unpool backwards at the demo model's shapes (C 128, 4
    # heads of 32) and with three heads at the flagship's width (D 128, J
    # 192), which their Hopper bodies take: each against autograd of its
    # plain version, ordinary and drifted (the pool's drifted dbe also
    # against the v3 witness); dqf (through dind2) and dkf, dvf (through dk,
    # dv) the same bits in two calls; then each Hopper body and its WMMA body
    # forced on the same operands, in turns (10 WMMA, 20 Hopper, 10 WMMA
    # calls), with both bodies' device times, SDPA's backward and the bound
    # beside them. The WMMA bodies are held where they still serve: 48
    # inducers at the demo's width. The MLP backward at the demo's C 128
    # (its WMMA body) and at three heads' width (the flagship's C 384: the
    # Hopper body, the MLP sees no heads).
    db, dn, dc, dh, di = (demo[k] for k in ("batch", "n_points", "feature_dim", "num_heads",
                                            "num_inducers"))
    new_shapes = {"demo": (db, dn, dc, dh, di), "heads3": hshape}
    wshape = (db, dn, dc, dh, 48)  # the WMMA bodies' own: another I
    cuda = device.type == "cuda"

    def pool_bodies(shape, drift):
        """-> (operands, the wrapper, the WMMA body forced on the same
        operands (on the CPU the plain version), the plain version, the v3
        witness)."""
        bb, nn_, cc, hh, ii = shape
        ops = pool_operands(g, bb, nn_, cc, hh, ii, drift, device, dt)
        gh = (0.1 * r(bb, ii, cc)).to(dt)
        plain = lambda: fa._pool_ext_bwd_ref(*ops, gh, hh)
        witness = lambda: pool_bwd_v3_affine(*ops, gh, hh)
        if not cuda:
            return ops, plain, plain, plain, witness
        x, se, be, ind2, kvw, wo = ops
        _, qft, macc, sacc = fa._pool_ext_launch(*ops, hh, True)

        def wmma():
            dx, dse, dbe, dqf, dwv, dwo = fa._pool_ext_bwd_wmma(x, se, be, qft, kvw, wo, gh, macc,
                                                                sacc, hh)
            return (dx, dse, dbe, *fa._chain_dqf(dqf, dwv, ind2, kvw, hh), dwo.to(wo.dtype))

        return (ops, lambda: fa.folded_pool_ext_bwd(*ops, qft, macc, sacc, gh, hh), wmma, plain,
                witness)

    def bwd_bound(name, shape, ops, outs):
        """The bound at ``shape``: the products and bytes of ``cases``."""
        bb, nn_, cc, hh, ii = shape
        jj, dd = hh * ii, cc // hh
        if name == "folded_pool_ext_bwd":
            flops = 6 * 2 * bb * nn_ * cc * jj + 6 * 2 * bb * jj * dd * cc
            cot = 2 * bb * ii * cc + 2 * 4 * bb * jj
        else:
            flops = 6 * 2 * bb * nn_ * cc * jj + 2 * 2 * bb * jj * dd * cc
            cot = 2 * bb * nn_ * cc + 4 * 2 * bb * cc
        return bound(flops, nbytes(*[a for a in ops if torch.is_tensor(a)], *outs) + cot)

    kernels.reset_launch_counts()
    for shape in new_shapes.values():
        for drift in (False, True):
            tag = f"Hopper body, C {shape[2]}, {shape[3]} heads, {'drift' if drift else 'ordinary'}"
            _, hopper, _, plain, witness = pool_bodies(shape, drift)
            compare("folded_pool_ext_bwd", tag, hopper, plain, witness if drift else None)
            _, hopper, _, plain = unpool_bodies(shape, drift)
            compare("folded_unpool_bwd", tag, hopper, plain)
    pw_errs = []
    for drift in (False, True):
        tag = f"WMMA body, C {dc}, {dh} heads, I {wshape[4]}, {'drift' if drift else 'ordinary'}"
        _, kernel, _, plain, witness = pool_bodies(wshape, drift)
        pw_errs.append(compare("folded_pool_ext_bwd", tag, kernel, plain,
                               witness if drift else None))
        _, kernel, _, plain = unpool_bodies(wshape, drift)
        wm_errs.append(compare("folded_unpool_bwd", tag, kernel, plain))
    mlp_demo_errs = []
    for (mb, mn, mc), what in (((db, dn, dc), "WMMA body, "), (hshape[:3], "three heads' width, ")):
        for drift in (False, True):
            ops = mlp_operands(g, mb, mn, mc, 2 * mc, drift, device, dt)
            gg, gs = (0.1 * r(mb, mn, mc)).to(dt), 1e-3 * r(mb, 2, mc)
            err = compare("fused_mlp_residual_bwd",
                          f"{what}C {mc}, {'drift' if drift else 'ordinary'}",
                          lambda: fa.fused_mlp_residual_bwd(*ops, gg, gs),
                          lambda: fa._mlp_bwd_ref(*ops, gg, gs))
            if mc == dc:
                mlp_demo_errs.append(err)
    counts = kernels.launch_counts()
    print(f"  launches of the backwards' bodies in these checks: "
          f"{ {k: counts[k] for k in FOLDED_BACKWARD + WMMA_BACKWARD} }")
    if cuda and not (counts["folded_pool_ext_bwd"] == 4 and counts["folded_pool_ext_bwd_wmma"] == 2
                     and counts["folded_unpool_bwd"] == 4
                     and counts["folded_unpool_bwd_wmma"] == 2
                     and counts["fused_mlp_residual_bwd_wmma"] == 2
                     and counts["fused_mlp_residual_bwd"] == 2):
        raise AssertionError(f"the demo, num_heads=3 and I 48 shapes did not run the expected "
                             f"backward bodies: {counts}")

    # each Hopper body against its WMMA body, in turns, at the new shapes
    pool_rec, pw_rec = rec["folded_pool_ext_bwd"], {}
    for width, shape in new_shapes.items():
        sfx = f"_{width}"
        ops, hopper, wmma, _, _ = pool_bodies(shape, False)
        uops, u_hopper, u_wmma, _ = unpool_bodies(shape, False)
        first, again = hopper(), hopper()
        u_first, u_again = u_hopper(), u_hopper()
        sync(device)
        same = (torch.equal(first[3], again[3]) and torch.equal(u_first[3], u_again[3])
                and torch.equal(u_first[4], u_again[4]))
        print(f"  at the {width}'s shapes: the pool's dind2 (from dqf), the unpool's dk and dv "
              f"(from dkf and dvf) of two calls {'the same bits' if same else 'DIFFER'}")
        if cuda and not same:
            raise AssertionError(f"a backward's weight gradients differ between two calls at "
                                 f"the {width}'s shapes")
        for name, h_rec, w_rec, hop, wm, args, lib, outs in (
                ("folded_pool_ext_bwd", pool_rec, pw_rec, hopper, wmma, ops,
                 sdpa_pool_bwd(ops, shape[3], g), first),
                ("folded_unpool_bwd", un_rec, wm_rec, u_hopper, u_wmma, uops,
                 sdpa_unpool_bwd(uops, shape[3], g), u_first)):
            turns = bodies_in_turns(hop, wm, device, reps)
            for out, t in ((h_rec, turns["hopper"]), (w_rec, turns["wmma"])):
                out["ms" + sfx], out["ms_min_max" + sfx] = statistics.median(t), [t[0], t[-1]]
            h_rec["device_ms" + sfx] = device_ms(hop, device)
            w_rec["device_ms" + sfx] = device_ms(wm, device)
            h_rec["library_ms" + sfx] = time_ms(lib, device, reps)
            h_rec["library_device_ms" + sfx] = device_ms(lib, device)
            h_rec["bound_ms" + sfx], h_rec["bound_by" + sfx] = bwd_bound(name, shape, args, outs)
            print(f"  {name} at the {width}'s shapes {shape}, in turns (median, min, max of "
                  f"{len(turns['hopper'])} calls): Hopper body {h_rec['ms' + sfx]:.3f} "
                  f"({turns['hopper'][0]:.3f}, {turns['hopper'][-1]:.3f}) ms, WMMA body "
                  f"{w_rec['ms' + sfx]:.3f} ({turns['wmma'][0]:.3f}, {turns['wmma'][-1]:.3f}) "
                  f"ms; device time a call: Hopper {fmt_ms(h_rec['device_ms' + sfx])}, WMMA "
                  f"{fmt_ms(w_rec['device_ms' + sfx])}, sdpa backward "
                  f"{fmt_ms(h_rec['library_device_ms' + sfx])} (event time "
                  f"{h_rec['library_ms' + sfx]:.3f} ms); bound {h_rec['bound_ms' + sfx]:.3f} ms "
                  f"({h_rec['bound_by' + sfx]})")

    # the WMMA bodies' own records at the shape they serve (I 48 at the
    # demo's width); the unpool's flagship readings above kept as
    # ``*_flagship``
    for k in ("ms", "ms_min_max", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "library_chain_ms"):
        wm_rec[k + "_flagship"] = wm_rec.pop(k)
    wb, wn, wc, wh, wi = wshape
    pool_w = pool_bodies(wshape, False)
    unpool_w = unpool_bodies(wshape, False)
    for name, w_rec, errs, (ops, kernel, plain), library, chain in (
            ("folded_pool_ext_bwd", pw_rec, pw_errs, (pool_w[0], pool_w[1], pool_w[3]),
             sdpa_pool_bwd(pool_w[0], wh, g),
             chain_backward(chain_pool, pool_w[0], wh, ((0.1 * rc(wb, wi, wc)).to(dt),))),
            ("folded_unpool_bwd", wm_rec, wm_errs, (unpool_w[0], unpool_w[1], unpool_w[3]),
             sdpa_unpool_bwd(unpool_w[0], wh, g),
             chain_backward(chain_unpool, unpool_w[0], wh,
                            ((0.1 * rc(wb, wn, wc)).to(dt), 1e-3 * rc(wb, 2, wc))))):
        w_rec.update(max_abs_err=max(errs), ms=time_ms(kernel, device, reps),
                     plain_ms=time_ms(plain, device, max(2, reps // 4)),
                     library_ms=time_ms(library, device, reps),
                     library_chain_ms=time_ms(chain, device, reps))
        w_rec["bound_ms"], w_rec["bound_by"] = bwd_bound(name, wshape, ops, kernel())
        print(f"  {name}, WMMA body, at its own shapes {wshape}: {w_rec['ms']:.3f} ms (plain "
              f"{w_rec['plain_ms']:.3f}, library {w_rec['library_ms']:.3f}, chain "
              f"{w_rec['library_chain_ms']:.3f}, bound {w_rec['bound_ms']:.3f} "
              f"({w_rec['bound_by']}))")
    ops = mlp_operands(g, db, dn, dc, 2 * dc, False, device, dt)
    gg, gs = (0.1 * r(db, dn, dc)).to(dt), 1e-3 * r(db, 2, dc)
    kernel = lambda: fa.fused_mlp_residual_bwd(*ops, gg, gs)
    mlp_wm.update(max_abs_err=max(mlp_demo_errs), ms=time_ms(kernel, device, reps),
                  plain_ms=time_ms(lambda: fa._mlp_bwd_ref(*ops, gg, gs), device,
                                   max(2, reps // 4)), library_ms=None)
    mlp_wm["bound_ms"], mlp_wm["bound_by"] = bound(
        6 * 2 * db * dn * dc * 2 * dc,
        nbytes(*[a for a in ops if torch.is_tensor(a)], *kernel()) + 2 * db * dn * dc
        + 4 * 2 * db * dc)
    rec["fused_mlp_residual_bwd_wmma"] = mlp_wm
    print(f"  fused_mlp_residual_bwd, WMMA body: {mlp_wm['ms']:.3f} ms at the demo's shapes "
          f"(plain {mlp_wm['plain_ms']:.3f}, bound {mlp_wm['bound_ms']:.3f} "
          f"({mlp_wm['bound_by']}))")
    rec["folded_pool_ext_bwd_wmma"] = pw_rec
    rec["folded_unpool_bwd_wmma"] = wm_rec
    return rec


# ------------------------------------------------------ projective gather --


def gather_operands(g, b, n, image_size, dt, device, coords="uniform"):
    """The ConvNeXt-tiny pyramid of ``image_size``^2 images (strides 4, 8,
    16; VALID convolutions, so 137 gives 34, 17, 8) and hw01: uniform in
    [-0.1, 1.1], so that corners fall outside the image on every side, or
    ("model") the coordinates the conditional model hands the gather,
    ``diffusion_to_hw`` of ``make_conditional_batch``'s clean clouds, which
    crowd onto the objects' silhouettes."""
    levels, size = [], (image_size - 4) // 4 + 1
    for c in CTX_DIMS:
        levels.append(torch.randn(b, size, size, c, generator=g, device=device).to(dt))
        size = (size - 2) // 2 + 1
    if coords == "model":
        return levels, gather_probe.model_hw01(b, n, device)
    hw01 = -0.1 + 1.2 * torch.rand(b, n, 2, generator=g, device=device)
    return levels, hw01


def touched_bytes(levels, hw01) -> int:
    """Bytes of the distinct in-image corner pixels that ``hw01`` reads in
    each level: what this data needs the lookup to read."""
    total = 0
    bidx = torch.arange(hw01.shape[0], device=hw01.device)[:, None]
    for lv in levels:
        _, h, w, c = lv.shape
        h0 = torch.floor(hw01[..., 0] * h).clamp(-2, h + 1).long()
        w0 = torch.floor(hw01[..., 1] * w).clamp(-2, w + 1).long()
        idx = []
        for dh in (0, 1):
            for dw in (0, 1):
                hi, wi = h0 + dh, w0 + dw
                ok = (hi >= 0) & (hi < h) & (wi >= 0) & (wi < w)
                idx.append(((bidx * h + hi) * w + wi)[ok])
        total += torch.unique(torch.cat(idx)).numel() * c * lv.element_size()
    return total


def grid_sample_yardstick(levels, hw01):
    """The library yardstick: one ``grid_sample`` per level (bilinear, zero
    padding, ``align_corners=False``) on fp32 NCHW copies, the grid
    ``(2 p + 1) / size - 1`` in grid_sample's (w, h) order, so that it
    samples pixel p = hw01 * size with no half-pixel offset, as the
    gather. fp32, because grid_sample takes its grid in the input's dtype
    and a bf16 grid puts a 64-pixel level's samples up to a tenth of a pixel
    off (chip reading: 1.0e-1 of max |ref|). Returns (xs, run): the NCHW
    copies, and ``run(xs)`` -> the per-level outputs [B, C, 1, N]."""
    import torch.nn.functional as F

    xs = [lv.permute(0, 3, 1, 2).float().contiguous() for lv in levels]
    grids = []
    for x in xs:
        size = torch.tensor([x.shape[3], x.shape[2]], dtype=torch.float32, device=hw01.device)
        grids.append(((2 * hw01.flip(-1) * size + 1) / size - 1)[:, None])
    run = lambda inputs: [F.grid_sample(x, gr, mode="bilinear", padding_mode="zeros",
                                        align_corners=False) for x, gr in zip(inputs, grids)]
    return xs, run


# the gather's SIMT-only widths (C % 8 != 0) for the entry point's path
SIMT_CTX_DIMS = (36, 68, 132)
# the SIMT bodies' single-channel instances: odd C; and a pyramid of six
# levels (the model's three, then three smaller ones), two launches each way
SIMT_ODD_DIMS = (3, 35, 131)
SIX_LEVEL_DIMS = (*CTX_DIMS, 48, 24, 16)


def gather_checks(device, g, levels, hw01, dt, tag):
    """The default bodies through the wrappers on one operand set: the
    forward against its plain version (and ``grid_sample``), the backward,
    with and without the coordinate gradient, against autograd of the plain
    version in fp32. Returns (the forward's output, its max abs error, the
    backward's, the cotangent, the yardstick)."""
    with torch.no_grad():
        got, want = projective_gather(levels, hw01), _gather_ref(hw01, *levels)
        sync(device)
        check(f"projective_gather {tag}", rel_err(got, want), TOL_OUT)
        fwd_err = abs_err(got, want)
        xs, lib = grid_sample_yardstick(levels, hw01)
        lib_out = torch.cat([o[:, :, 0].transpose(1, 2) for o in lib(xs)], dim=-1)
        check(f"  grid_sample (the yardstick) {tag} against the plain version",
              rel_err(lib_out, want), TOL_OUT)
    cot = torch.randn(got.shape, generator=g, device=device).to(dt)
    dhw, dlv = projective_gather_bwd(levels, hw01, cot, coords_grad=True)
    _, dlv_only = projective_gather_bwd(levels, hw01, cot, coords_grad=False)
    ref32 = _gather_bwd_ref([lv.float() for lv in levels], hw01, cot.float())
    ref16 = _gather_bwd_ref(levels, hw01, cot)
    sync(device)
    bwd_err = 0.0
    for q, (a, a_only, r32, r16) in enumerate(zip(dlv, dlv_only, ref32[1], ref16[1])):
        check(f"projective_gather_bwd {tag} dF level {q}", rel_err(a, r32), TOL_GATHER_DF)
        check(f"projective_gather_bwd {tag} dF level {q} (no coordinate gradient)",
              rel_err(a_only, r32), TOL_GATHER_DF)
        print(f"    against the plain version's own bf16 autograd: {rel_err(a, r16):.3e}")
        bwd_err = max(bwd_err, abs_err(a, r32))
    check(f"projective_gather_bwd {tag} d hw01", rel_err(dhw, ref32[0]), TOL_GATHER_DCOORD)
    print(f"    against the plain version's own bf16 autograd: {rel_err(dhw, ref16[0]):.3e}")
    return got, fwd_err, bwd_err, cot, (xs, lib)


def gather_bodies(levels, hw01, cot, tag) -> dict:
    """On the card, the two bodies of each function on one operand set: the
    Hopper forward the same bits as the SIMT body; the Hopper backward the
    same bits in two calls, and within TOL_GATHER_DF / TOL_GATHER_DCOORD of
    autograd of the plain version in fp32 and no further than 1.25x the
    SIMT body's error, per output."""
    rec = gather_probe.check_bodies(levels, hw01, cot)
    print(f"  {tag}: the Hopper forward "
          f"{'the same bits as' if rec['fwd_equal'] else 'DIFFERS from'} the SIMT body; the "
          f"Hopper backward "
          f"{'the same bits' if rec['bwd_same_bits'] else 'DIFFERENT bits'} in two calls")
    if not (rec["fwd_equal"] and rec["bwd_same_bits"] and rec["bwd_only_equal"]):
        raise AssertionError(f"projective gather {tag}: {rec}")
    for k, err in rec["bwd_err"].items():
        old = rec["bwd_err_simt"][k]
        check(f"projective_gather_bwd {tag} {k}, Hopper body (SIMT body {old:.3e})", err,
              TOL_GATHER_DCOORD if k == "dhw01" else TOL_GATHER_DF)
        check("  its error over the SIMT body's, at most 1.25", err / max(old, 1e-30), 1.25,
              what="ratio")
    return rec


def gather_times(device, levels, hw01, cot, yardstick, reps, tag) -> tuple:
    """Each function's two bodies in turns on one operand set, with their
    device time (``torch.profiler``), the host's time to make a call, the
    bound from this set's touched bytes, the plain version and
    ``grid_sample`` (forward, and its autograd backward) -> the forward's
    and the backward's records, Hopper and SIMT."""
    b, n = hw01.shape[:2]
    c_tot = sum(lv.shape[3] for lv in levels)
    read = touched_bytes(levels, hw01)
    xs, lib = yardstick
    t = gather_probe.time_bodies(levels, hw01, cot, reps)
    with torch.no_grad():
        plain_ms = time_ms(lambda: _gather_ref(hw01, *levels), device, max(2, reps // 4))
        lib_ms = time_ms(lambda: lib(xs), device, reps)
        lib_dev = device_ms(lambda: lib(xs), device)
    out = projective_gather(levels, hw01)
    # four fp32 multiply-adds per channel and point
    bms, by = bound(8 * b * n * c_tot, read + nbytes(hw01, out), PEAK_FP32_FLOPS)
    fwd = {}
    for body in ("new", "old"):
        r = t["forward"][body]
        fwd[body] = dict(ms=r["ms"], ms_min_max=r["ms_min_max"], device_ms=r["device_ms"],
                         host_ms=r["host_ms"], plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib_ms, library_device_ms=lib_dev)
    print(f"  projective_gather {tag}, in turns: Hopper {fwd['new']['ms']:.4f} ms (device "
          f"{fwd['new']['device_ms']:.4f}, host {fwd['new']['host_ms']:.4f}), SIMT "
          f"{fwd['old']['ms']:.4f} ms (device {fwd['old']['device_ms']:.4f}, host "
          f"{fwd['old']['host_ms']:.4f}); plain {plain_ms:.3f} ms, grid_sample {lib_ms:.3f} ms "
          f"(device {fmt_ms(lib_dev)}), bound {bms:.4f} ms ({by}; {read / 1e6:.1f} MB of the "
          f"{nbytes(*levels) / 1e6:.1f} MB pyramid read)")

    plain_ms = time_ms(lambda: _gather_bwd_ref(levels, hw01, cot), device, max(2, reps // 4))
    leaves = [x.detach().requires_grad_(True) for x in xs]
    lib_outs = lib(leaves)
    lib_cots = [torch.randn(o.shape, device=o.device).to(o.dtype) for o in lib_outs]
    lib_bwd = lambda: torch.autograd.grad(lib_outs, leaves, lib_cots, retain_graph=True)
    lib_ms, lib_dev = time_ms(lib_bwd, device, reps), device_ms(lib_bwd, device)
    # dF: a multiply-add per corner and channel, each level's gradient
    # written whole; the coordinates' dot products are not part of the
    # train step's call
    bms, by = bound(8 * b * n * c_tot, nbytes(cot, hw01, *levels), PEAK_FP32_FLOPS)
    # with the coordinate gradient: also the corners read and d hw01 written
    bms_c, _ = bound(16 * b * n * c_tot, nbytes(cot, *levels) + 2 * nbytes(hw01) + read,
                     PEAK_FP32_FLOPS)
    bwd = {}
    for body in ("new", "old"):
        r, rc = t["backward"][body], t["backward_coords"][body]
        bwd[body] = dict(ms=r["ms"], ms_min_max=r["ms_min_max"], device_ms=r["device_ms"],
                         per_launch_ms=r["per_launch_ms"], host_ms=r["host_ms"],
                         ms_coords=rc["ms"], device_ms_coords=rc["device_ms"],
                         bound_ms_coords=bms_c, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib_ms, library_device_ms=lib_dev)
    for what, sfx in (("dF only, as in training", ""), ("with the coordinate gradient", "_coords")):
        print(f"  projective_gather_bwd {tag} ({what}), in turns: Hopper "
              f"{bwd['new']['ms' + sfx]:.4f} ms (device {bwd['new']['device_ms' + sfx]:.4f}), "
              f"SIMT {bwd['old']['ms' + sfx]:.4f} ms (device {bwd['old']['device_ms' + sfx]:.4f});"
              f" bound {bwd['new']['bound_ms' + sfx]:.4f} ms")
    print(f"    Hopper backward by launch: " + ", ".join(
        f"{k} {v:.4f}" for k, v in bwd["new"]["per_launch_ms"].items())
        + f"; host {bwd['new']['host_ms']:.4f} ms (SIMT {bwd['old']['host_ms']:.4f}); plain "
        f"{plain_ms:.3f} ms, grid_sample backward {lib_ms:.3f} ms (device {fmt_ms(lib_dev)})")
    return fwd, bwd


def gather_simt_path(device, g, b, n, image_size, dt):
    """The entry point a model calls, ``lookup_pyramid(..., impl="pallas")``,
    forward and backward under autograd at widths only the SIMT bodies take
    (``SIMT_CTX_DIMS``, C % 8 != 0): each SIMT body launched once and
    nothing else, against the plain version. Returns the launch counts."""
    levels, size = [], (image_size - 4) // 4 + 1
    for c in SIMT_CTX_DIMS:
        levels.append(torch.randn(b, size, size, c, generator=g, device=device).to(dt))
        size = (size - 2) // 2 + 1
    hw01 = -0.1 + 1.2 * torch.rand(b, n, 2, generator=g, device=device)
    leaves = [lv.detach().requires_grad_(True) for lv in levels]
    coords = hw01.detach().requires_grad_(True)
    cot = torch.randn(b, n, sum(SIMT_CTX_DIMS), generator=g, device=device).to(dt)
    sync(device)
    kernels.reset_launch_counts()
    out = lookup_pyramid(leaves, coords, impl="pallas")
    torch.autograd.backward(out, cot)
    sync(device)
    counts = kernels.launch_counts()
    check_counts("gather entry point at SIMT-only widths", counts,
                 expected_counts(dict(projective_gather_simt=1, projective_gather_bwd_simt=1)),
                 device)
    with torch.no_grad():
        check(f"projective_gather SIMT body, C {SIMT_CTX_DIMS}",
              rel_err(out, _gather_ref(hw01, *levels)), TOL_OUT)
    ref = _gather_bwd_ref([lv.float() for lv in levels], hw01, cot.float())
    for q, (a, r) in enumerate(zip(leaves, ref[1])):
        check(f"projective_gather_bwd SIMT body, C {SIMT_CTX_DIMS}, dF level {q}",
              rel_err(a.grad, r), TOL_GATHER_DF)
    check(f"projective_gather_bwd SIMT body, C {SIMT_CTX_DIMS}, d hw01",
          rel_err(coords.grad, ref[0]), TOL_GATHER_DCOORD)
    return counts


def simt_instances(device, g, b, n, image_size, dt) -> tuple:
    """The operands only the SIMT bodies take, beside the model's own bf16
    pyramid ``base`` and its coordinates: the pyramid in fp32; odd C
    (``SIMT_ODD_DIMS``); the first level 2-byte aligned (one bf16 element
    past an aligned allocation); six levels (``SIX_LEVEL_DIMS``). Returns
    (hw01, base, {name: (levels, launches per call)})."""
    base, hw01 = gather_operands(g, b, n, image_size, dt, device)

    def pyramid(dims, size):
        out = []
        for c in dims:
            out.append(torch.randn(b, size, size, c, generator=g, device=device).to(dt))
            size = max(1, (size - 2) // 2 + 1)
        return out

    buf = torch.empty(base[0].numel() + 1, dtype=dt, device=device)
    shifted = buf[1:].view(base[0].shape)
    shifted.copy_(base[0])
    six = base + pyramid(SIX_LEVEL_DIMS[3:], max(1, (base[-1].shape[1] - 2) // 2 + 1))
    return hw01, base, {
        "fp32": ([lv.float() for lv in base], 1),
        f"odd C {SIMT_ODD_DIMS}": (pyramid(SIMT_ODD_DIMS, base[0].shape[1]), 1),
        "2-byte aligned": ([shifted, *base[1:]], 1),
        "six levels": (six, 2),
    }


def gather_simt_instances(device, g, b, n, image_size, dt, reps) -> dict:
    """The SIMT bodies' new instances (``simt_instances``) through the
    wrappers, forward and backward with the coordinate gradient, against
    the plain version run in fp32 on the same inputs: each picked by the
    switch, launched as often as its levels' groups (one launch a group of
    four levels each way) and nothing else; the Hopper bodies still take
    the model's bf16 pyramid. On the card each instance is timed in turns
    with the bf16 SIMT body on the model's pyramid, beside its bound.
    Returns the SIMT rows' records, keyed by instance."""
    hw01, base, cases = simt_instances(device, g, b, n, image_size, dt)
    cot_base = torch.randn(b, n, sum(CTX_DIMS), generator=g, device=device).to(dt)
    if device.type == "cuda":
        want = ("hopper", "hopper")
        got = (_gather_body(base, hw01), _gather_body(base, hw01, cot_base))
        if got != want:
            raise AssertionError(f"the model's bf16 pyramid went to {got}, not the Hopper bodies")
        kernels.reset_launch_counts()
        with torch.no_grad():
            projective_gather(base, hw01)
        projective_gather_bwd(base, hw01, cot_base, True)
        sync(device)
        check_counts("gather at the model's bf16 pyramid", kernels.launch_counts(),
                     expected_counts(dict(projective_gather=1, projective_gather_bwd=1)), device)
    fwd, bwd = {}, {}
    for name, (levels, launches) in cases.items():
        f32 = levels[0].dtype == torch.float32
        cot = torch.randn(b, n, sum(lv.shape[3] for lv in levels), generator=g,
                          device=device).to(levels[0].dtype)
        body = (_gather_body(levels, hw01), _gather_body(levels, hw01, cot))
        if body != ("simt", "simt"):
            raise AssertionError(f"gather {name}: the switch picked {body}")
        sync(device)
        kernels.reset_launch_counts()
        with torch.no_grad():
            out = projective_gather(levels, hw01)
        dhw, dlv = projective_gather_bwd(levels, hw01, cot, True)
        sync(device)
        check_counts(f"gather SIMT body, {name}", kernels.launch_counts(),
                     expected_counts(dict(projective_gather_simt=launches,
                                          projective_gather_bwd_simt=launches)), device)
        lv32 = [lv.float() for lv in levels]
        with torch.no_grad():
            want = _gather_ref(hw01, *lv32)
        ref = _gather_bwd_ref(lv32, hw01, cot.float())
        sync(device)
        check(f"projective_gather SIMT body, {name}", rel_err(out, want),
              TOL_GATHER_F32 if f32 else TOL_OUT)
        for q, (a, r) in enumerate(zip(dlv, ref[1])):
            check(f"projective_gather_bwd SIMT body, {name}, dF level {q}", rel_err(a, r),
                  TOL_GATHER_F32 if f32 else TOL_GATHER_DF)
        check(f"projective_gather_bwd SIMT body, {name}, d hw01", rel_err(dhw, ref[0]),
              TOL_GATHER_F32 if f32 else TOL_GATHER_DCOORD)
        fwd[name] = dict(max_abs_err=abs_err(out, want))
        bwd[name] = dict(max_abs_err=max(abs_err(a, r) for a, r in zip(dlv, ref[1])))
        if device.type != "cuda":
            continue
        read = touched_bytes(levels, hw01)
        c_tot = sum(lv.shape[3] for lv in levels)
        t = gather_probe.in_turns(lambda: pg_simt_fwd(hw01, levels),
                                  lambda: pg_simt_fwd(hw01, base), reps)
        bms, by = bound(8 * b * n * c_tot, read + nbytes(hw01, out), PEAK_FP32_FLOPS)
        fwd[name].update(ms=gather_probe.med(t["new"]), bf16_simt_ms=gather_probe.med(t["old"]),
                         bound_ms=bms, bound_by=by)
        t = gather_probe.in_turns(lambda: pg_simt_bwd(levels, hw01, cot, True),
                                  lambda: pg_simt_bwd(base, hw01, cot_base, True), reps)
        bms, by = bound(16 * b * n * c_tot, nbytes(cot, *levels) + 2 * nbytes(hw01) + read,
                        PEAK_FP32_FLOPS)
        bwd[name].update(ms=gather_probe.med(t["new"]), bf16_simt_ms=gather_probe.med(t["old"]),
                         bound_ms=bms, bound_by=by)
        print(f"  SIMT {name}, in turns with the bf16 SIMT body on the model's pyramid: forward "
              f"{fwd[name]['ms']:.4f} ms (bf16 {fwd[name]['bf16_simt_ms']:.4f}; bound "
              f"{fwd[name]['bound_ms']:.4f}), backward with the coordinate gradient "
              f"{bwd[name]['ms']:.4f} ms (bf16 {bwd[name]['bf16_simt_ms']:.4f}; bound "
              f"{bwd[name]['bound_ms']:.4f})")
    return {"projective_gather_simt": {"instances": fwd},
            "projective_gather_bwd_simt": {"instances": bwd}}


def gather_phase(device, b, n, image_size, render_size, dt, reps):
    """The gather's default bodies through its wrappers: the forward against
    its plain version and the backward against autograd of the plain
    version (run in fp32 on the same inputs), at the model's pyramid on
    uniform coordinates and on the model's own, and at the renders' pyramid.
    On the card, at the model's pyramid and on both coordinate sets, the
    Hopper and SIMT bodies against each other (``gather_bodies``) and timed
    in turns (``gather_times``). Then the entry point at the SIMT bodies'
    widths. On the CPU the gather runs its plain version, so the rehearsal
    holds it in fp32. Returns the records and the SIMT path's counts."""
    g = torch.Generator(device=device).manual_seed(3)
    dt = dt if device.type == "cuda" else torch.float32
    rec = {}
    for size, coords in ((image_size, "uniform"), (image_size, "model"), (render_size, "uniform")):
        levels, hw01 = gather_operands(g, b, n, size, dt, device, coords)
        shapes = [tuple(lv.shape[1:]) for lv in levels]
        tag = f"{size}^2 pyramid {shapes}, {coords} coordinates"
        got, fwd_err, bwd_err, cot, yardstick = gather_checks(device, g, levels, hw01, dt, tag)
        if size != image_size:
            continue
        sfx = "" if coords == "uniform" else "_model"
        if device.type != "cuda":
            # the rehearsal: the wrappers' plain versions, no bodies to compare
            ms = time_ms(lambda: projective_gather(levels, hw01), device, reps)
            for name, err in (("projective_gather", fwd_err), ("projective_gather_simt", fwd_err),
                              ("projective_gather_bwd", bwd_err),
                              ("projective_gather_bwd_simt", bwd_err)):
                rec.setdefault(name, {}).update({k + sfx: v for k, v in dict(
                    max_abs_err=err, ms=ms, plain_ms=ms, bound_ms=0.0, bound_by="bytes",
                    library_ms=None).items()})
            continue
        bodies = gather_bodies(levels, hw01, cot, tag)
        fwd, bwd = gather_times(device, levels, hw01, cot, yardstick, reps, tag)
        for name, r, err in (
                ("projective_gather", fwd["new"], bodies["fwd_abs_err"]),
                ("projective_gather_simt", fwd["old"], bodies["fwd_abs_err"]),
                ("projective_gather_bwd", bwd["new"], bodies["bwd_abs_err"]),
                ("projective_gather_bwd_simt", bwd["old"], bodies["bwd_abs_err_simt"])):
            rec.setdefault(name, {}).update({k + sfx: v for k, v in
                                             dict(r, max_abs_err=err).items()})
    print(f"  the entry point at the SIMT bodies' widths C {SIMT_CTX_DIMS}:")
    simt_counts = gather_simt_path(device, g, b, n, image_size, dt)
    print("  the SIMT bodies' fp32, odd-C, 2-byte-aligned and six-level instances:")
    for name, r in gather_simt_instances(device, g, b, n, image_size, dt, reps).items():
        rec.setdefault(name, {}).update(r)
    return rec, simt_counts


# ----------------------------------------- per-head attention, megakernel --


def attn_operands(g, b, n, c, heads, i, direction, drift, device, dt):
    """q, k, v as the per-head modules hand them to the kernel: [B, H, *, D]
    views of their [B, *, C] projections (the pool: the [H, I, D] inducers
    broadcast over the batch against the two halves of the [B, N, 2C] kv
    projection; the unpool: N point queries against I inducer tokens); with
    ``drift`` the keys carry ``head_scales``, logits in the hundreds."""
    d = c // heads
    r = lambda *sh: torch.randn(*sh, generator=g, device=device)
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)
    scales = head_scales(c, heads, drift, device)
    if direction == "pool":
        q = r(heads, i, d).to(dt)[None].expand(b, -1, -1, -1)
        kv = r(b, n, 2 * c)
        kv[..., :c] *= scales
        k, v = (split(t) for t in kv.to(dt).chunk(2, dim=-1))
        return q, k, v
    return split(r(b, n, c).to(dt)), split((r(b, i, c) * scales).to(dt)), split(r(b, i, c).to(dt))


def WIDE_HEADS(batch):
    """(C, heads, batch, drifts) of the rect attention's checks at heads
    wider than 64 that its WMMA body takes: D 80, 96 and 112 (four heads,
    batch 4, ordinary). D 128, three heads at C 384, both bodies take:
    ``attention_phase`` holds and times it beside the flagship's D 48."""
    return ((320, 4, 4, (False,)), (384, 4, 4, (False,)), (448, 4, 4, (False,)))


# the rect attention's widest instance, (C, heads): D 256 (phase 21's);
# and D 128, three heads at the flagship's width (both bodies take it)
D256 = (768, 3)
D128 = (384, 3)
# its bodies, by the name of their entry points
RECT_BODIES = ("hopper", "wmma")


def merged_randn(g, like):
    """Normal draws of ``like``'s shape [B, H, rows, D] in the merged-heads
    layout [B, rows, H, D] that the per-head modules' cotangents have (the
    gradient of ``_merge_heads``), in ``like``'s dtype."""
    b, h, m, d = like.shape
    return torch.randn(b, m, h, d, generator=g, device=like.device).to(like.dtype).transpose(1, 2)


def q_bytes(q) -> int:
    """Bytes of q's distinct elements (the pool's inducers once)."""
    return (q[0] if q.stride(0) == 0 else q).numel() * q.element_size()


def rect_fwd_body(body):
    """The rect attention forward's ``body`` ("hopper", "wmma") on the
    card; the plain version on the CPU."""
    fn = ia._rect_attention_fwd_hopper if body == "hopper" else ia._rect_attention_fwd_wmma
    return lambda q, k, v: fn(q, k, v) if q.is_cuda else ia._rect_attention_ref(q, k, v)


def rect_bwd_body(body):
    """The rect attention backward's ``body`` on the card, from (q, k, v,
    o, lse, g); autograd of the plain version on the CPU."""
    fn = ia._rect_attention_bwd_hopper if body == "hopper" else ia._rect_attention_bwd_wmma
    return lambda *ops: fn(*ops) if ops[0].is_cuda else ia._rect_attention_bwd_ref(*ops[:3],
                                                                                    ops[5])


def attention_phase(device, shapes, train_batch, big, dt, reps, ragged_n):
    """The rect attention's forward and backward, each body (Hopper and
    WMMA) on the same operands, and the unpool + MLP megakernel's two
    bodies (also at the ragged N ``ragged_n``) against their plain
    versions; returns per-kernel records. A rect-attention
    record sums a layer's two calls (pool and unpool) at the flagship's
    shapes: ``rect_attention_fwd`` / ``_bwd`` the Hopper body's,
    ``..._wmma`` the WMMA body's, the two timed in turns on the same
    operands."""
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(4)
    b, n, c, heads, i = shapes["batch"], shapes["n_points"], shapes["feature_dim"], \
        shapes["num_heads"], shapes["num_inducers"]
    d, j, w = c // heads, heads * i, 2 * c
    on_card = device.type == "cuda"
    rec = {}
    suffix = {"hopper": "", "wmma": "_wmma"}

    def tag(direction, drift, width=""):
        return f"{direction}{width}, {'drift' if drift else 'ordinary'}"

    def same_bits(what, first, second):
        if on_card and not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"{what}: not the same bits in two calls")

    def hopper_picked(what, body):
        if on_card and body != "hopper":
            raise AssertionError(f"{what}: the switch picked the {body} body, not the Hopper one")

    def fwd_hold(label, q, k, v, body):
        """The forward's ``body`` against the plain version, o and lse (the
        Hopper body's the same bits in two calls) -> max |err| of o."""
        run = rect_fwd_body(body)
        got, want, again = run(q, k, v), ia._rect_attention_ref(q, k, v), run(q, k, v)
        sync(device)
        name = f"rect_attention_fwd{suffix[body]} [{label}]"
        check(f"{name} o", rel_err(got[0], want[0]), TOL_OUT)
        check(f"{name} lse", rel_err(got[1], want[1]), TOL_LSE)
        if body == "hopper":
            same_bits(name, got, again)
        return abs_err(got[0], want[0])

    def fwd_times(q, k, v):
        """Each body's median ms (in turns) and device ms, the plain
        version's and SDPA's ms, the operations and the bytes."""
        runs = {body: (lambda body=body: rect_fwd_body(body)(q, k, v)) for body in RECT_BODIES}
        turns = bodies_in_turns(runs["hopper"], runs["wmma"], device, reps)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        bb, hh, m_rows, dd = q.shape
        return dict(**{f"{body}_ms": statistics.median(turns[body]) for body in RECT_BODIES},
                    **{f"{body}_device_ms": device_ms(runs[body], device) for body in RECT_BODIES},
                    plain_ms=time_ms(lambda: ia._rect_attention_ref(q, k, v), device,
                                     max(2, reps // 4)),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc),
                                       device, reps),
                    # q once, k, v; o (bf16) and lse (fp32) written
                    flops=4 * bb * hh * m_rows * k.shape[2] * dd,
                    bytes=q_bytes(q) + nbytes(k, v) + bb * hh * m_rows * (2 * dd + 4))

    def show(name, what, t):
        bms, by = bound(t["flops"], t["bytes"])
        print(f"  {name} {what}: Hopper {t['hopper_ms']:.3f} ms (device "
              f"{fmt_ms(t['hopper_device_ms'])}), WMMA {t['wmma_ms']:.3f} ms (device "
              f"{fmt_ms(t['wmma_device_ms'])}), in turns; plain {t['plain_ms']:.3f} ms, sdpa "
              f"{t['library_ms']:.3f} ms, bound {bms:.3f} ms ({by})")
        return dict(t, bound_ms=bms, bound_by=by)

    def records(name, times, errs, **extra):
        """The Hopper and WMMA records of one function from its directions'
        times at the flagship."""
        tot = lambda key: sum(t[key] for t in times.values())
        dev = lambda body: (None if not on_card else tot(f"{body}_device_ms"))
        bms, by = bound(tot("flops"), tot("bytes"))
        for body in RECT_BODIES:
            rec[name + suffix[body]] = dict(
                max_abs_err=max(errs[body]), ms=tot(f"{body}_ms"), device_ms=dev(body),
                plain_ms=tot("plain_ms"), bound_ms=bms, bound_by=by,
                library_ms=tot("library_ms"),
                directions={k: {key: t[key] for key in (f"{body}_ms", f"{body}_device_ms",
                                                         "plain_ms", "library_ms", "bound_ms")}
                            for k, t in times.items()},
                **(extra if body == "hopper" else {}))

    # forward: both bodies against the plain version at the sampler's batch
    # (the switch picks the Hopper body there), at the 8k width and at D 128
    # (three heads), ordinary and drifted; each direction's bodies timed in
    # turns at the flagship and at D 128
    errs = {body: [] for body in RECT_BODIES}
    times, times128 = {}, {}
    for cc, hh, where in ((c, heads, times), (*D128, times128)):
        for direction in ("pool", "unpool"):
            width = "" if where is times else f" D {cc // hh}"
            for drift in (False, True):
                q, k, v = attn_operands(g, b, n, cc, hh, i, direction, drift, device, dt)
                hopper_picked(f"rect_attention_fwd at {tag(direction, drift, width)}",
                              ia._rect_fwd_body(q, k, v))
                for body in RECT_BODIES:
                    err = fwd_hold(tag(direction, drift, width), q, k, v, body)
                    if where is times:
                        errs[body].append(err)
            q, k, v = attn_operands(g, b, n, cc, hh, i, direction, False, device, dt)
            where[direction] = show("rect_attention_fwd",
                                    f"{direction}{width} (q {tuple(q.shape)}, k/v "
                                    f"{tuple(k.shape)})", fwd_times(q, k, v))
    # the 8k width, and D 128 at its point count (the pool forward's k tiles
    # too many to stay resident: streamed twice)
    long_cases = ((big["feature_dim"], big["num_heads"], " 8k width"),
                  (*D128, " 8k points, D 128"))
    for cc, hh, width in long_cases:
        for direction in ("pool", "unpool"):
            for drift in (False, True):
                q, k, v = attn_operands(g, big["batch"], big["n_points"], cc, hh,
                                        big["num_inducers"], direction, drift, device, dt)
                hopper_picked(f"rect_attention_fwd at {tag(direction, drift, width)}",
                              ia._rect_fwd_body(q, k, v))
                for body in RECT_BODIES:
                    fwd_hold(tag(direction, drift, width), q, k, v, body)
    # the WMMA body's instances for heads wider than 64 that the Hopper body
    # does not take: D 80, 96 and 112 (four heads, batch 4, ordinary),
    # through the switch, each timed
    wide_ms = {}
    for cc, hh, bb, drifts in WIDE_HEADS(b):
        for direction in ("pool", "unpool"):
            for drift in drifts:
                q, k, v = attn_operands(g, bb, n, cc, hh, i, direction, drift, device, dt)
                if ia._rect_fwd_body(q, k, v) != "wmma":
                    raise AssertionError(f"rect_attention_fwd at D {cc // hh}: not the WMMA body")
                fwd_hold(tag(direction, drift, f" D {cc // hh}"), q, k, v, "wmma")
                if not drift:
                    wide_ms[f"D{cc // hh}_B{bb}_{direction}"] = time_ms(
                        lambda: ia.rect_attention_fwd(q, k, v), device, reps)
    print("  rect_attention_fwd's WMMA body at the wider heads: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in wide_ms.items()))
    # the widest instance, D 256 (three heads at C 768, phase 21's; the WMMA
    # body): each direction's time at the sampler's batch beside its bound
    # and SDPA's
    d256 = {}
    for direction in ("pool", "unpool"):
        q, k, v = attn_operands(g, b, n, D256[0], D256[1], i, direction, False, device, dt)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        m_rows, n_keys, dd = q.shape[2], k.shape[2], q.shape[3]
        bms, by = bound(4 * b * D256[1] * m_rows * n_keys * dd,
                        q_bytes(q) + nbytes(k, v) + b * D256[1] * m_rows * (2 * dd + 4))
        d256[direction] = dict(
            ms=time_ms(lambda: ia.rect_attention_fwd(q, k, v), device, reps), bound_ms=bms,
            bound_by=by, library_ms=time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc),
                                            device, reps))
    print(f"  rect_attention_fwd at D 256 (batch {b}, the WMMA body): "
          + ", ".join(f"{k} kernel {v['ms']:.3f} ms, sdpa {v['library_ms']:.3f} ms, bound "
                      f"{v['bound_ms']:.3f} ms ({v['bound_by']})" for k, v in d256.items()))
    records("rect_attention_fwd", times, errs, d128=times128)
    rec["rect_attention_fwd_wmma"].update(ms_wide_heads=wide_ms, d256=d256, d128=times128)

    # backward: both bodies against autograd of the plain version and
    # against the TPU algebra's witness at the training batch, the 8k width
    # and D 128, ordinary and drifted; timed in turns at the flagship and D 128
    def bwd_case(bb, nn_, cc, hh, ii, direction, drift):
        q, k, v = attn_operands(g, bb, nn_, cc, hh, ii, direction, drift, device, dt)
        o, lse = ia.rect_attention_fwd(q, k, v)
        return (q, k, v, o, lse, merged_randn(g, o))

    def bwd_hold(label, ops, body):
        """The backward's ``body`` against autograd of the plain version and
        against the TPU algebra's witness (the Hopper body's dq, dk, dv the
        same bits in two calls) -> max |err|."""
        run = rect_bwd_body(body)
        got, again = run(*ops), run(*ops)
        want, alg = ia._rect_attention_bwd_ref(*ops[:3], ops[5]), ia._rect_bwd_tpu_algebra(*ops)
        sync(device)
        name = f"rect_attention_bwd{suffix[body]} [{label}]"
        for key, a, ref, wit in zip(("dq", "dk", "dv"), got, want, alg):
            check(f"{name} {key}", rel_err(a, ref), TOL_GRAD)
            # on the CPU the "body" is the plain version, not the TPU algebra
            if on_card:
                check(f"{name} {key} against the TPU algebra in plain PyTorch", rel_err(a, wit),
                      TOL_GRAD)
        if body == "hopper":
            same_bits(name, got, again)
        return max(abs_err(a, ref) for a, ref in zip(got, want))

    def bwd_times(ops):
        q, k, v, o, lse, gg = ops
        runs = {body: (lambda body=body: rect_bwd_body(body)(*ops)) for body in RECT_BODIES}
        turns = bodies_in_turns(runs["hopper"], runs["wmma"], device, reps)
        bb, hh, m_rows, dd = q.shape
        return dict(**{f"{body}_ms": statistics.median(turns[body]) for body in RECT_BODIES},
                    **{f"{body}_device_ms": device_ms(runs[body], device) for body in RECT_BODIES},
                    plain_ms=time_ms(lambda: ia._rect_attention_bwd_ref(q, k, v, gg), device,
                                     max(2, reps // 4)),
                    library_ms=time_ms(sdpa_backward(*(t.contiguous() for t in (q, k, v)), g),
                                       device, reps),
                    # s (p from lse), dp, dq, dk, dv
                    flops=10 * bb * hh * m_rows * k.shape[2] * dd,
                    # q once, k, v, o, g, lse read; dq, dk, dv written
                    bytes=q_bytes(q) + nbytes(k, v, o, gg, lse) + nbytes(q.expand_as(o), k, v))

    errs = {body: [] for body in RECT_BODIES}
    times, times128 = {}, {}
    for cc, hh, where in ((c, heads, times), (*D128, times128)):
        for direction in ("pool", "unpool"):
            width = "" if where is times else f" D {cc // hh}"
            for drift in (False, True):
                ops = bwd_case(train_batch, n, cc, hh, i, direction, drift)
                hopper_picked(f"rect_attention_bwd at {tag(direction, drift, width)}",
                              ia._rect_bwd_body(*ops[:4], ops[5]))
                for body in RECT_BODIES:
                    err = bwd_hold(tag(direction, drift, width), ops, body)
                    if where is times:
                        errs[body].append(err)
            ops = bwd_case(train_batch, n, cc, hh, i, direction, False)
            where[direction] = show("rect_attention_bwd",
                                    f"{direction}{width} (batch {train_batch})", bwd_times(ops))
    for cc, hh, width in long_cases:
        for direction in ("pool", "unpool"):
            for drift in (False, True):
                ops = bwd_case(big["batch"], big["n_points"], cc, hh, big["num_inducers"],
                               direction, drift)
                hopper_picked(f"rect_attention_bwd at {tag(direction, drift, width)}",
                              ia._rect_bwd_body(*ops[:4], ops[5]))
                for body in RECT_BODIES:
                    bwd_hold(tag(direction, drift, width), ops, body)
    # a cotangent in fp32: the Hopper backward takes delta from the wrapper,
    # formed from that cotangent (as the JAX package forms it), against the
    # plain pieces given it (on the CPU the pieces themselves)
    for direction in ("pool", "unpool"):
        q, k, v, o, lse, gg = bwd_case(train_batch, n, c, heads, i, direction, False)
        g32 = gg.float()
        want = ia._rect_bwd_pieces(q, k, v, o, lse, g32, (g32 * o.float()).sum(-1))
        got = ia._rect_attention_bwd_hopper(q, k, v, o, lse, g32) if on_card else want
        sync(device)
        for key, a, ref in zip(("dq", "dk", "dv"), got, want):
            check(f"rect_attention_bwd [{direction}, fp32 cotangent] {key} against the plain "
                  f"pieces", rel_err(a, ref), TOL_GRAD)
    wide_ms = {}
    for cc, hh, bb, drifts in WIDE_HEADS(train_batch):
        for direction in ("pool", "unpool"):
            for drift in drifts:
                ops = bwd_case(bb, n, cc, hh, i, direction, drift)
                if ia._rect_bwd_body(*ops[:4], ops[5]) != "wmma":
                    raise AssertionError(f"rect_attention_bwd at D {cc // hh}: not the WMMA body")
                bwd_hold(tag(direction, drift, f" D {cc // hh}"), ops, "wmma")
                if not drift:
                    wide_ms[f"D{cc // hh}_B{bb}_{direction}"] = time_ms(
                        lambda: ia.rect_attention_bwd(*ops), device, reps)
    print("  rect_attention_bwd's WMMA body at the wider heads: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in wide_ms.items()))
    # D 256 at the training batch (the WMMA body): time, bound and SDPA's
    # backward
    d256 = {}
    for direction in ("pool", "unpool"):
        ops = bwd_case(train_batch, n, D256[0], D256[1], i, direction, False)
        q, k, v, o, lse, gg = ops
        m_rows, n_keys, dd = q.shape[2], k.shape[2], q.shape[3]
        bms, by = bound(10 * train_batch * D256[1] * m_rows * n_keys * dd,
                        q_bytes(q) + nbytes(k, v, o, gg, lse) + nbytes(q.expand_as(o), k, v))
        d256[direction] = dict(
            ms=time_ms(lambda: ia.rect_attention_bwd(*ops), device, reps), bound_ms=bms,
            bound_by=by,
            library_ms=time_ms(sdpa_backward(*(t.contiguous() for t in (q, k, v)), g), device,
                               reps))
    print(f"  rect_attention_bwd at D 256 (batch {train_batch}, the WMMA body): "
          + ", ".join(f"{k} kernel {v['ms']:.3f} ms, sdpa backward {v['library_ms']:.3f} ms, "
                      f"bound {v['bound_ms']:.3f} ms ({v['bound_by']})" for k, v in d256.items()))
    records("rect_attention_bwd", times, errs, d128=times128)
    rec["rect_attention_bwd_wmma"].update(ms_wide_heads=wide_ms, d256=d256, d128=times128)

    # the megakernel at the sampler's shapes: its Hopper body against the
    # plain composition and the separate unpool and MLP kernels, ordinary
    # and drifted, at N 2048 and the ragged 2000, the same bits in two
    # calls; its WMMA body forced on the same operands at N 2048
    def mega_ops(drift, n_pts):
        r = lambda *sh: torch.randn(*sh, generator=g, device=device)
        ops = unpool_operands(g, b, n_pts, c, heads, i, drift, device, dt)
        mlp = mlp_operands(g, 1, 64, c, w, False, device, dt)[3:]
        return (*ops, 1.0 + 0.2 * r(b, c), 0.2 * r(b, c)), mlp

    gind = fa.group_indicator(c, GROUPS, device)

    def mega_body(body, ops, mlp, n_pts):
        """One body of the megakernel forced (on the CPU the plain version)."""
        if not on_card:
            return fa._unpool_mlp_ref(*ops, *mlp, heads, GROUPS, n_pts)
        return fa._unpool_mlp_launch(*ops, gind, *mlp, heads, GROUPS, n_pts, body=body)

    errs = {"hopper": [], "wmma": []}
    with torch.no_grad():
        for n_pts in (n, ragged_n):
            for drift in (False, True):
                ops, mlp = mega_ops(drift, n_pts)
                got = fa.fused_unpool_mlp(*ops, gind, *mlp, heads, GROUPS, n_pts)
                same_bits(f"fused_unpool_mlp at N {n_pts}",
                          got, fa.fused_unpool_mlp(*ops, gind, *mlp, heads, GROUPS, n_pts))
                want = fa._unpool_mlp_ref(*ops, *mlp, heads, GROUPS, n_pts)
                sep = fa._unpool_mlp_composed(*ops, *mlp, heads, GROUPS, n_pts)
                sync(device)
                t_ = f"N {n_pts}, {'drift' if drift else 'ordinary'}"
                check(f"fused_unpool_mlp [{t_}] out", rel_err(got[0], want[0]), TOL_OUT)
                check(f"fused_unpool_mlp [{t_}] sums", rel_err(got[1], want[1]), TOL_SUMS)
                check(f"  against the separate unpool and MLP kernels [{t_}] out",
                      rel_err(got[0], sep[0]), TOL_OUT)
                check(f"  against the separate unpool and MLP kernels [{t_}] sums",
                      rel_err(got[1], sep[1]), TOL_SUMS)
                errs["hopper"].append(abs_err(got[0], want[0]))
                if n_pts % 64 == 0:
                    wm = mega_body("wmma", ops, mlp, n_pts)
                    sync(device)
                    check(f"  its WMMA body [{t_}] out", rel_err(wm[0], want[0]), TOL_OUT)
                    check(f"  its WMMA body [{t_}] sums", rel_err(wm[1], want[1]), TOL_SUMS)
                    errs["wmma"].append(abs_err(wm[0], want[0]))
        ops, mlp = mega_ops(False, n)
        runs = {"hopper": lambda: fa.fused_unpool_mlp(*ops, gind, *mlp, heads, GROUPS, n),
                "wmma": lambda: mega_body("wmma", ops, mlp, n)}
        turns = bodies_in_turns(runs["hopper"], runs["wmma"], device, reps)
        separate = lambda: fa._unpool_mlp_composed(*ops, *mlp, heads, GROUPS, n)
        sep_ms = time_ms(separate, device, reps)
        plain_ms = time_ms(lambda: fa._unpool_mlp_ref(*ops, *mlp, heads, GROUPS, n), device,
                           max(2, reps // 4))
        dev_ms = {k: device_ms(fn, device) for k, fn in (*runs.items(), ("separate", separate))}
    # the unpool's products and fold, and the MLP's; every input read once,
    # out and the sums written once
    flops = 4 * b * n * c * j + 4 * b * j * c * d + 4 * b * n * c * w
    bms, by = bound(flops, nbytes(*ops, *mlp) + nbytes(ops[0]) + 4 * b * 2 * c)
    for body in ("hopper", "wmma"):
        rec[f"fused_unpool_mlp{suffix[body]}"] = dict(
            max_abs_err=max(errs[body]), ms=statistics.median(turns[body]), plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=None, device_ms=dev_ms[body],
            separate_ms=sep_ms, separate_device_ms=dev_ms["separate"])
    ms_dev = lambda k: "not measured" if dev_ms[k] is None else f"{dev_ms[k]:.3f} ms"
    print(f"  fused_unpool_mlp (B {b}, N {n}), in turns: Hopper body "
          f"{statistics.median(turns['hopper']):.3f} ms (device {ms_dev('hopper')}), WMMA body "
          f"{statistics.median(turns['wmma']):.3f} ms (device {ms_dev('wmma')}); the separate "
          f"unpool + MLP kernels {sep_ms:.3f} ms (device {ms_dev('separate')}), plain "
          f"{plain_ms:.3f} ms, library none, bound {bms:.3f} ms ({by})")
    return rec


# ------------------------------------------------------------ resident pool --


def resident_pool_phase(device, shapes, train_batch, big, dt, reps):
    """The resident pool's forward against its plain version (prenorm on
    and off, ordinary and drifted): its Hopper body at the sampler's shapes
    and the 8k width (B 2 at N 8192 and the sampler's batch at N 2048),
    pass by pass against its plain pieces with the same bits in two calls,
    and its WMMA body at the sampler's shapes, the two timed in turns; its
    backward on the Hopper forward's saved tensors against autograd of the
    plain version (nonzero mean/inv cotangents): the Hopper body at the
    training batch and the 8k width, pass by pass against its plain pieces
    with the same bits in two calls (``probes.pool_layer_bwd``), the WMMA
    body forced at the training batch and at its own shapes (three heads),
    the two timed in turns, each beside SDPA's backward in device time; and
    the unpool with both flags off at the flagship's shapes. Returns the
    resident pool's records (each body's): each without its pre-norm (the
    module-level Broadcast's route), with the pre-norm variant (the
    sums-less layer's route) nested under ``prenorm``."""
    g = torch.Generator(device=device).manual_seed(6)
    r = lambda *sh: torch.randn(*sh, generator=g, device=device)
    b, n, c, heads, i = shapes["batch"], shapes["n_points"], shapes["feature_dim"], \
        shapes["num_heads"], shapes["num_inducers"]
    d, j = c // heads, heads * i
    rec = {}

    def ops_for(bb, nn_, cc, hh, ii, drift):
        """pool_operands (se/be as the AdaGN scale/bias) with per-channel
        offsets on the stream, so that the group means are not 0, and the
        group indicator."""
        x, sc, bi, ind2, kvw, wo = pool_operands(g, bb, nn_, cc, hh, ii, drift, device, dt)
        x = (1.5 * x.float() + 0.3 * r(1, 1, cc)).to(dt)
        return x, sc, bi, ind2, kvw, wo, fa.group_indicator(cc, GROUPS, device)

    def unfolded(ops):
        """The same operands without a pre-norm, for the SDPA yardstick."""
        ones = torch.ones(ops[1].shape, device=device)
        return (ops[0], ones, torch.zeros_like(ones), *ops[3:6])

    def tag(prenorm, drift, width=""):
        norm = "prenorm" if prenorm else "no pre-norm"
        return f"{norm}{width}, {'drift' if drift else 'ordinary'}"

    def variant_rec(fwd_name, prenorm, errs, **timed):
        """The record of one variant (``errs``: its max |err| per pre-norm
        flag); the variant that gave the module-level path most of its
        launches (no pre-norm) at the top, the other nested under
        ``prenorm``."""
        r_ = dict(max_abs_err=max(errs[prenorm]), **timed)
        entry = rec.setdefault(fwd_name, {})
        if prenorm:
            entry["prenorm"] = r_
        else:
            entry.update(r_)

    # forward: the Hopper body at the flagship's width and at the 8k width
    # (B 2 at N 8192, and the sampler's batch at N 2048), each call held to
    # its body by the counters; the WMMA body at the flagship's width
    errs = {body: {True: [], False: []} for body in ("hopper", "wmma")}
    big_dims = (big["batch"], big["n_points"], big["feature_dim"], big["num_heads"],
                big["num_inducers"])
    big_b = (b, n, big["feature_dim"], big["num_heads"], big["num_inducers"])
    fwd_cases = (((b, n, c, heads, i), "", "hopper"), (big_dims, " 8k width", "hopper"),
                 (big_b, f" 8k width, batch {b}", "hopper"), ((b, n, c, heads, i), "", "wmma"))
    counter = {"hopper": "folded_pool_layer", "wmma": "folded_pool_layer_wmma"}
    for dims, width, body in fwd_cases:
        for prenorm in (True, False):
            for drift in (False, True):
                ops = ops_for(*dims, drift)
                kernels.reset_launch_counts()
                with torch.no_grad():
                    if device.type == "cuda":
                        got = fa._pool_layer_launch(*ops, dims[3], prenorm, False, body=body)[:3]
                    else:
                        got = fa.folded_pool_layer(*ops, dims[3], prenorm)
                    want = fa._pool_ref(*ops[:6], GROUPS, dims[3], prenorm)
                sync(device)
                counts = kernels.launch_counts()
                other = counter["wmma" if body == "hopper" else "hopper"]
                if device.type == "cuda" and (body == "hopper"
                                              and fa._pool_layer_body(*dims) != "hopper"
                                              or counts[counter[body]] != 1 or counts[other]):
                    raise AssertionError(f"folded_pool_layer{width}: expected its {body} body, "
                                         f"got {counts}")
                what = f"folded_pool_layer{'_wmma' if body == 'wmma' else ''}"
                for name, a, ref, tol in zip(("h0", "mean_c", "inv_c"), got, want,
                                             (TOL_OUT, TOL_STATS, TOL_STATS)):
                    check(f"{what} [{tag(prenorm, drift, width)}] {name}", rel_err(a, ref), tol)
                if not width:
                    errs[body][prenorm].append(abs_err(got[0], want[0]))
    # the Hopper body pass by pass against its plain pieces on its own
    # inputs, and the same bits in two calls (probes.pool_layer)
    if device.type == "cuda":
        failed = []
        for dims, width in (((b, n, c, heads, i), ""), (big_b, f" 8k width, batch {b}")):
            for drift in (False, True):
                pool_layer_passes(ops_for(*dims, drift), dims[3], failed,
                                  f"folded_pool_layer passes{width}, "
                                  f"{'drift' if drift else 'ordinary'}")
        if failed:
            raise AssertionError("folded_pool_layer passes: " + "; ".join(failed))
    ops = ops_for(b, n, c, heads, i, False)
    # the products: logits (twice), values, p^T v, the output projection
    flops = 2 * b * n * c * j + 2 * b * n * c * c + 2 * b * n * j * d + 2 * b * i * c * c
    for prenorm in (True, False):
        with torch.no_grad():
            if device.type == "cuda":
                run = lambda body: (lambda: fa._pool_layer_launch(*ops, heads, prenorm, False,
                                                                  body=body))
            else:
                run = lambda body: (lambda: fa.folded_pool_layer(*ops, heads, prenorm))
            turns = bodies_in_turns(run("hopper"), run("wmma"), device, reps)
            plain_ms = time_ms(lambda: fa._pool_ref(*ops[:6], GROUPS, heads, prenorm), device,
                               max(2, reps // 4))
            lib_ms = None if prenorm else time_ms(sdpa_pool(unfolded(ops), heads), device, reps)
            chain_ms = None if prenorm else time_ms(chain_pool(unfolded(ops)[:6], heads), device,
                                                    reps)
        # each input read once, and with the pre-norm the stream once more:
        # its statistics must be complete before the first logit and it does
        # not fit on the chip; h0 and the statistics written once
        bms, by = bound(flops, nbytes(*ops) + prenorm * nbytes(ops[0]) + 2 * b * i * c
                        + 2 * 4 * b * c)
        lib_txt = (f"sdpa {lib_ms:.3f} ms, chain {chain_ms:.3f}" if lib_ms is not None
                   else "library none")
        t_h, t_w = turns["hopper"], turns["wmma"]
        ms, wmma_ms = statistics.median(t_h), statistics.median(t_w)
        print(f"  folded_pool_layer ({tag(prenorm, False)}): Hopper body {ms:.3f} ms "
              f"({t_h[0]:.3f}-{t_h[-1]:.3f}), WMMA body {wmma_ms:.3f} ms ({t_w[0]:.3f}-"
              f"{t_w[-1]:.3f}) in turns, plain {plain_ms:.3f} ms, {lib_txt} ms, bound {bms:.3f} "
              f"ms ({by})")
        for name, body, t_ms, t in (("folded_pool_layer", "hopper", ms, t_h),
                                    ("folded_pool_layer_wmma", "wmma", wmma_ms, t_w)):
            rec_errs = {k: v for k, v in errs[body].items()}
            variant_rec(name, prenorm, rec_errs, ms=t_ms, ms_min_max=[t[0], t[-1]],
                        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                        library_chain_ms=chain_ms)

    # backward: the Hopper body (the switch's pick at the flagship's and
    # the 8k width) and the WMMA body (forced at the flagship's shapes; the
    # switch's pick at three heads, D 128), each call held to its body by
    # the counters, against autograd of the plain version
    names = ("dx", "dscale", "dbias", "dind2", "dkvw", "dwo")
    bwd_counter = {"hopper": "folded_pool_layer_bwd", "wmma": "folded_pool_layer_bwd_wmma"}

    def bwd_case(dims, drift, prenorm, body=None):
        """The backward's operands at ``dims`` -> (operands, the forward's
        results and the cotangents, the kernel (``body`` forced on the
        card), the plain version, the TPU algebra's witness)."""
        ops = ops_for(*dims, drift)
        bb, _, cc, hh, ii = dims
        if device.type == "cuda":
            _, mean, inv, fwd = fa._pool_layer_launch(*ops, hh, prenorm, True)
        else:
            mean = inv = None
            fwd = (None, None, None, None)
        cot = ((0.1 * r(bb, ii, cc)).to(dt), 1e-2 * r(bb, cc), 1e-2 * r(bb, cc))
        if device.type == "cuda" and body is not None:
            kernel = lambda: fa._pool_layer_bwd_launch(*ops, mean, inv, *fwd, *cot, hh, prenorm,
                                                       body=body)
        else:
            kernel = lambda: fa.folded_pool_layer_bwd(*ops, mean, inv, *fwd, *cot, hh, prenorm)
        plain = lambda: fa._pool_layer_bwd_ref(*ops, *cot, hh, prenorm)
        witness = lambda: pool_layer_bwd_tpu_algebra(*ops, cot[0], hh)
        # the forward's results and the cotangents (y is x without the pre-norm)
        extra = [t for t in (mean, inv, *fwd, *cot) if t is not None and t is not ops[0]]
        return ops, extra, kernel, plain, witness

    def bwd_check(label, kernel, plain, witness=None, body="hopper"):
        what = bwd_counter[body]
        kernels.reset_launch_counts()
        got, want = kernel(), plain()
        sync(device)
        counts = kernels.launch_counts()
        other = bwd_counter["wmma" if body == "hopper" else "hopper"]
        if device.type == "cuda" and (counts[what] != 1 or counts[other]):
            raise AssertionError(f"{what} [{label}]: expected its {body} body, got {counts}")
        for name, a, ref in zip(names, got, want):
            tol = TOL_AFFINE if name in ("dscale", "dbias") else TOL_GRAD
            if witness is not None and name == "dbias":
                tol = TOL_POOL_DRIFT_DBE
                alg = witness()[1]
                print(f"    witness: dbias by the TPU algebra in plain PyTorch against the plain "
                      f"version: {rel_err(alg, ref):.3e}")
                # on the CPU the "kernel" is the plain version itself
                if device.type == "cuda":
                    check(f"{what} [{label}] dbias against the TPU algebra", rel_err(a, alg),
                          TOL_AFFINE)
            check(f"{what} [{label}] {name}", rel_err(a, ref), tol)
        return max(abs_err(a, ref) for a, ref in zip(got, want))

    errs = {body: {True: [], False: []} for body in ("hopper", "wmma")}
    train_dims = (train_batch, n, c, heads, i)
    big_dims = (big["batch"], big["n_points"], big["feature_dim"], big["num_heads"],
                big["num_inducers"])
    # the WMMA body's own shapes: three heads (D 128 at the flagship's C;
    # two on a width that three do not divide)
    h3 = 3 if c % 48 == 0 else 2
    own_dims = (train_batch, n, c, h3, i)
    # (shapes, label, body, the body forced, whether its record's max |err|)
    bwd_cases = ((train_dims, "", "hopper", None, True),
                 (big_dims, " 8k width", "hopper", None, False),
                 (train_dims, "", "wmma", "wmma", False),
                 (own_dims, f" {h3} heads", "wmma", None, True))
    for dims, width, body, forced, recorded in bwd_cases:
        for prenorm in (True, False):
            for drift in (False, True):
                _, _, kernel, plain, witness = bwd_case(dims, drift, prenorm, forced)
                err = bwd_check(tag(prenorm, drift, width), kernel, plain,
                                witness if prenorm and drift else None, body)
                if recorded:
                    errs[body][prenorm].append(err)
    # the Hopper body pass by pass against its plain pieces on its own
    # inputs, the whole against the TPU algebra's pieces composed, and the
    # same bits in two calls (probes.pool_layer_bwd)
    if device.type == "cuda":
        failed = []
        for dims, width in ((train_dims, ""), (big_dims, " 8k width")):
            for drift in (False, True):
                pool_layer_bwd_passes(ops_for(*dims, drift), dims[3], g, failed,
                                      f"folded_pool_layer_bwd passes{width}, "
                                      f"{'drift' if drift else 'ordinary'}", drift)
        if failed:
            raise AssertionError("folded_pool_layer_bwd passes: " + "; ".join(failed))
    tb = train_batch

    def bwd_flops(hh):
        # the products the gradient needs: logits and values (p and v), dp,
        # dv, ds qf^T, dv Wv, dqf, dWv; dpool and dWo
        jj, dd = hh * i, c // hh
        return tb * (2 * n * (3 * c * jj + 3 * c * c + 2 * jj * dd) + 4 * i * c * c)

    for prenorm in (True, False):
        # both bodies at the flagship's shapes, in turns, with their device
        # times (no host time to launch a lone call) beside SDPA's backward's
        ops, extra, hopper, plain, _ = bwd_case(train_dims, False, prenorm, "hopper")
        wmma = bwd_case(train_dims, False, prenorm, "wmma")[2]
        turns = bodies_in_turns(hopper, wmma, device, reps)
        plain_ms = time_ms(plain, device, max(2, reps // 4))
        lib = None if prenorm else sdpa_pool_bwd(unfolded(ops), heads, g)
        lib_ms = None if lib is None else time_ms(lib, device, reps)
        lib_dev = None if lib is None else device_ms(lib, device)
        dev = {k: device_ms(f, device) for k, f in (("hopper", hopper), ("wmma", wmma))}
        # each input read once (the operands, the forward's statistics and
        # the cotangents), each gradient written once
        bms, by = bound(bwd_flops(heads), nbytes(*ops) + nbytes(*extra) + nbytes(*hopper()))
        t_h, t_w = turns["hopper"], turns["wmma"]
        lib_txt = f"sdpa backward {lib_ms:.3f}" if lib_ms is not None else "library none"
        print(f"  folded_pool_layer_bwd ({tag(prenorm, False)}, batch {tb}): Hopper body "
              f"{statistics.median(t_h):.3f} ms ({t_h[0]:.3f}-{t_h[-1]:.3f}), WMMA body "
              f"{statistics.median(t_w):.3f} ms ({t_w[0]:.3f}-{t_w[-1]:.3f}) in turns, plain "
              f"{plain_ms:.3f} ms, {lib_txt} ms, bound {bms:.3f} ms ({by}); device: Hopper "
              f"{fmt_ms(dev['hopper'])}, WMMA {fmt_ms(dev['wmma'])}, sdpa backward "
              f"{fmt_ms(lib_dev)}")
        variant_rec("folded_pool_layer_bwd", prenorm, errs["hopper"],
                    ms=statistics.median(t_h), ms_min_max=[t_h[0], t_h[-1]],
                    device_ms=dev["hopper"], wmma_ms=statistics.median(t_w),
                    wmma_ms_min_max=[t_w[0], t_w[-1]], wmma_device_ms=dev["wmma"],
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                    library_device_ms=lib_dev)
        # the WMMA body at its own shapes (three heads), its record's
        ops, extra, kernel, plain, _ = bwd_case(own_dims, False, prenorm)
        t = sorted(time_all(kernel, device, reps))
        lib = None if prenorm else sdpa_pool_bwd(unfolded(ops), h3, g)
        bms, by = bound(bwd_flops(h3), nbytes(*ops) + nbytes(*extra) + nbytes(*kernel()))
        own = dict(ms=statistics.median(t), ms_min_max=[t[0], t[-1]],
                   device_ms=device_ms(kernel, device),
                   plain_ms=time_ms(plain, device, max(2, reps // 4)), bound_ms=bms, bound_by=by,
                   library_ms=None if lib is None else time_ms(lib, device, reps),
                   library_device_ms=None if lib is None else device_ms(lib, device),
                   flagship_ms=statistics.median(t_w), flagship_device_ms=dev["wmma"])
        print(f"  folded_pool_layer_bwd_wmma ({tag(prenorm, False)}, batch {tb}, {h3} heads): "
              f"{own['ms']:.3f} ms ({t[0]:.3f}-{t[-1]:.3f}), device {fmt_ms(own['device_ms'])}, "
              f"plain {own['plain_ms']:.3f} ms, bound {bms:.3f} ms ({by}), sdpa backward "
              + (f"{own['library_ms']:.3f} ms, device {fmt_ms(own['library_device_ms'])}"
                 if lib is not None else "none"))
        variant_rec("folded_pool_layer_bwd_wmma", prenorm, errs["wmma"], **own)

    # the unpool with both flags off (the module-level unpool)
    with torch.no_grad():
        for drift in (False, True):
            uops = unpool_operands(g, b, n, c, heads, i, drift, device, dt)
            got = fa.folded_unpool(*uops, heads, False, False)
            want = fa._unpool_ref(*uops, heads, False, False)
            sync(device)
            t_ = "drift" if drift else "ordinary"
            check(f"folded_unpool, no residual, no pre-norm [{t_}] out", rel_err(got[0], want[0]),
                  TOL_OUT)
            check(f"folded_unpool, no residual, no pre-norm [{t_}] sums",
                  rel_err(got[1], want[1]), TOL_SUMS)
        uops = unpool_operands(g, b, n, c, heads, i, False, device, dt)
        ms = time_ms(lambda: fa.folded_unpool(*uops, heads, False, False), device, reps)
        plain_ms = time_ms(lambda: fa._unpool_ref(*uops, heads, False, False), device,
                           max(2, reps // 4))
    print(f"  folded_unpool, no residual, no pre-norm: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    unames = ("dx", "dse", "dbe", "dk", "dv", "dwq", "dwo")
    for drift in (False, True):
        uops = unpool_operands(g, tb, n, c, heads, i, drift, device, dt)
        gg, gs = (0.1 * r(tb, n, c)).to(dt), 1e-3 * r(tb, 2, c)
        got = fa.folded_unpool_bwd(*uops, gg, gs, heads, False, False)
        want = fa._unpool_bwd_ref(*uops, gg, gs, heads, False, False)
        sync(device)
        for name, a, ref in zip(unames, got, want):
            t_ = "drift" if drift else "ordinary"
            check(f"folded_unpool_bwd, no residual, no pre-norm [{t_}] {name}", rel_err(a, ref),
                  TOL_AFFINE if name in ("dse", "dbe") else TOL_GRAD)
    ms = time_ms(lambda: fa.folded_unpool_bwd(*uops, gg, gs, heads, False, False), device, reps)
    print(f"  folded_unpool_bwd, no residual, no pre-norm (batch {tb}): kernel {ms:.3f} ms")
    return rec


def module_phase(device, shapes, train_batch, dt):
    """The module-level folded path at the flagship's width: a Broadcast
    on ``folded_pallas`` (the resident pool without its pre-norm and the
    unpool without pre-norm or residual) forward at the sampler's batch
    against ``xla`` and ``folded``, one gradient at the training batch
    per parameter group and for x, then a BroadcastingLayer
    called without channel sums under ``torch.no_grad`` (the resident pool
    with its statistics) against the plain layer; each run's launches
    exact. The gradient is held against the plain path in fp32: at init
    the unpool's q/k gradients pass through the softmax backward's dp - t,
    a difference of near-equal numbers that the plain bf16 path takes
    after rounding dp (chip reading: 5.6e-2 between the two bf16 paths).
    Then a Broadcast with three heads forward and gradient (the resident
    pool's and the unpool forward's WMMA bodies, the unpool backward's
    Hopper body). Returns the launch counts of the runs together,
    and those of the sums-less layer's run alone (the resident pool with
    its pre-norm)."""
    b, n, c, heads, i = shapes["batch"], shapes["n_points"], shapes["feature_dim"], \
        shapes["num_heads"], shapes["num_inducers"]
    tb = train_batch
    gen = torch.Generator().manual_seed(5)
    kw = dict(device=device, generator=gen)
    bc = Broadcast(c, i, 1, heads, **kw)
    layer = BroadcastingLayer(c, i, 1, heads, **kw)
    # move the AdaGN embed weights off their 0 init, so the embed matters
    for name, p in [*bc.named_parameters(), *layer.named_parameters()]:
        if name.endswith(("scale_linear.weight", "bias_linear.weight")):
            with torch.no_grad():
                p.add_(0.002 * torch.randn(p.shape, generator=gen).to(device))
    g = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(b, n, c, generator=g, device=device).to(dt)
    embed = (80.0 * torch.rand(b, 1, generator=g, device=device)).to(dt)
    total = {}

    def run(fn, expected, what):
        kernels.reset_launch_counts()
        out = fn()
        sync(device)
        counts = kernels.launch_counts()
        check_counts(what, counts, expected_counts(expected), device)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out

    with torch.no_grad():
        got = run(lambda: bc(x, embed, attn_impl="folded_pallas"),
                  {"folded_pool_layer": 1, "folded_unpool": 1}, "module-level Broadcast")
        for impl in ("xla", "folded"):
            ref = bc(x, embed, attn_impl=impl)
            for name, a, rr in zip(("out", "h"), got, ref):
                check(f"Broadcast (batch {b}) {name}, folded_pallas vs {impl}", rel_err(a, rr),
                      TOL_PATH)

    # the gradient on the kernel path against the plain path in fp32
    broadcast_gradient(bc, x[:tb], embed[:tb], dt, run,
                       {"folded_pool_layer": 1, "folded_unpool": 1, "folded_pool_layer_bwd": 1,
                        "folded_unpool_bwd": 1}, f"Broadcast gradient (batch {tb})")

    # the resident pool's WMMA bodies: a Broadcast with three heads (D 128
    # at the flagship's C; two on a width that three do not divide),
    # forward and gradient
    h3 = 3 if c % 48 == 0 else 2
    bc3 = Broadcast(c, i, 1, h3, **kw)
    with torch.no_grad():
        got = run(lambda: bc3(x, embed, attn_impl="folded_pallas"),
                  {"folded_pool_layer_wmma": 1, "folded_unpool_wmma": 1},
                  f"module-level Broadcast with {h3} heads")
        ref = bc3(x, embed, attn_impl="xla")
        for name, a, rr in zip(("out", "h"), got, ref):
            check(f"Broadcast with {h3} heads (batch {b}) {name}, folded_pallas vs xla",
                  rel_err(a, rr), TOL_PATH)
    broadcast_gradient(bc3, x[:tb], embed[:tb], dt, run,
                       {"folded_pool_layer_wmma": 1, "folded_unpool_wmma": 1,
                        "folded_pool_layer_bwd_wmma": 1, "folded_unpool_bwd": 1},
                       f"Broadcast with {h3} heads gradient (batch {tb})")

    with torch.no_grad():
        before = dict(total)
        got = run(lambda: layer(x, embed, "folded_pallas"),
                  {"folded_pool_layer": 1, "fused_h_side": 1, "folded_unpool": 1,
                   "fused_mlp_residual": 1}, "sums-less BroadcastingLayer")
        ref = layer(x, embed, "xla")
        for name, a, rr in zip(("out", "h"), got, ref):
            check(f"BroadcastingLayer without sums (batch {b}) {name}, folded_pallas vs xla",
                  rel_err(a, rr), TOL_PATH)
    return total, {k: v - before.get(k, 0) for k, v in total.items()}


def broadcast_gradient(bc, xb, eb, dt, run, expected, what) -> None:
    """One gradient of a ``Broadcast`` (for x and every parameter) on the
    kernel path (``run`` holds its launch counts to ``expected``), the
    plain path and the plain path in fp32, the reference both bf16 paths
    are held against (TOL_TRAIN_GRAD, worst group)."""
    grads = []
    for impl, pdt in (("folded_pallas", dt), ("xla", dt), ("xla", torch.float32)):
        bc.zero_grad(set_to_none=True)
        xg = xb.to(pdt).clone().requires_grad_(True)

        def step():
            out, _ = bc(xg, eb.to(pdt), attn_impl=impl)
            (out.float() ** 2).sum().backward()

        if impl == "folded_pallas":
            run(step, expected, f"module-level {what}")
        else:
            step()
        grads.append({"x": xg.grad.flatten().float(),
                      **{k: p.grad.flatten().float() for k, p in bc.named_parameters()}})
    bc.zero_grad(set_to_none=True)
    rel = lambda a, ref: float((a - ref).norm() / ref.norm().clamp_min(1e-30))
    worst = worst_plain = 0.0
    for k, ref in grads[2].items():
        k32, p32, kp = rel(grads[0][k], ref), rel(grads[1][k], ref), rel(grads[0][k], grads[1][k])
        worst, worst_plain = max(worst, k32), max(worst_plain, p32)
        print(f"    grad {k}: against fp32: kernel {k32:.3e}, plain {p32:.3e}; kernel against "
              f"plain {kp:.3e}")
    print(f"  the plain bf16 path's worst group against fp32: {worst_plain:.3e}")
    check(f"{what}, folded_pallas vs the plain path in fp32 (worst group)", worst,
          TOL_TRAIN_GRAD, "||err||/||ref||")


def broadcast_case(device, shapes, train_batch, dt) -> tuple:
    """A ``Broadcast`` at ``shapes`` on ``folded_pallas`` (the resident pool
    without its pre-norm, the flag-free unpool), as phase 15 holds the
    flagship's: its forward against the plain path (TOL_PATH) and its
    gradient at ``train_batch`` against the plain path in fp32
    (``broadcast_gradient``), each run's launch counts exact, the bodies
    those the switches pick -> (forward counts, gradient counts)."""
    b, n, c, heads, i = shapes["batch"], shapes["n_points"], shapes["feature_dim"], \
        shapes["num_heads"], shapes["num_inducers"]
    gen = torch.Generator().manual_seed(6)
    bc = Broadcast(c, i, 1, heads, device=device, generator=gen)
    for name, p in bc.named_parameters():
        if name.endswith(("scale_linear.weight", "bias_linear.weight")):
            with torch.no_grad():
                p.add_(0.002 * torch.randn(p.shape, generator=gen).to(device))
    g = torch.Generator(device=device).manual_seed(8)
    x = torch.randn(b, n, c, generator=g, device=device).to(dt)
    embed = (80.0 * torch.rand(b, 1, generator=g, device=device)).to(dt)
    pick = lambda name, switch: (name if device.type != "cuda" or switch(b, n, c, heads, i)
                                 == "hopper" else f"{name}_wmma")
    pool, unpool = pick("folded_pool_layer", fa._pool_layer_body), \
        pick("folded_unpool", fa._unpool_body)
    unpool_bwd = pick("folded_unpool_bwd", fa._unpool_bwd_body)
    pool_bwd = pick("folded_pool_layer_bwd", fa._pool_layer_bwd_body)
    counts = []

    def run(fn, expected, what):
        kernels.reset_launch_counts()
        out = fn()
        sync(device)
        got = kernels.launch_counts()
        check_counts(what, got, expected_counts(expected), device)
        counts.append(got)
        return out

    what = f"Broadcast with {i} inducers"
    with torch.no_grad():
        got = run(lambda: bc(x, embed, attn_impl="folded_pallas"), {pool: 1, unpool: 1},
                  f"module-level {what}")
        ref = bc(x, embed, attn_impl="xla")
        for name, a, rr in zip(("out", "h"), got, ref):
            check(f"{what} (batch {b}) {name}, folded_pallas vs xla", rel_err(a, rr), TOL_PATH)
    broadcast_gradient(bc, x[:train_batch], embed[:train_batch], dt, run,
                       {pool: 1, unpool: 1, pool_bwd: 1, unpool_bwd: 1},
                       f"{what} gradient (batch {train_batch})")
    return counts[0], counts[1]


def upsample_path(device, n_layers, n_points, n_new, n_steps, n_substeps, compare_new):
    """The flagship on ``folded_pallas`` upsamples one ``n_points``
    observation to ``n_new`` points through ``Diffusion.upsample`` (churn
    0.5) on the ``n_steps``-step extended grid; every launch count exact:
    the pool side once per layer and transition (the cache refresh), the
    unpool side once per layer and evaluation. Then a 4-step, 2-substep
    upsample of two clouds to ``compare_new`` points, the kernel path
    against the plain path from the same generator seed (the same draws).
    Returns the counts and a record."""
    model = build_flagship(device, torch.Generator().manual_seed(0), n_layers, n_steps=n_steps)
    rng = np.random.default_rng(2)
    data = torch.from_numpy(make_clouds(rng, 1, n_points)).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    full = model.schedule
    model.schedule = dataclasses.replace(full, n_solver_steps=2)
    model.upsample(gen, data, 256, n_substeps=1)  # warm-up: first launches, allocator
    model.schedule = full
    sync(device)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.upsample(gen, data, n_new, n_substeps=n_substeps, s_churn=0.5)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if tuple(out.shape) != (1, n_new, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"upsample: shape {tuple(out.shape)} or non-finite values")
    cached = (n_steps - 1) * n_substeps * 2 + n_substeps
    print(f"  upsampled one {n_points}-point cloud to {tuple(out.shape)} in {seconds:.3f} s: "
          f"{n_new / seconds:.1f} new points/s ({n_steps} full evaluations of the observation, "
          f"{cached} cached evaluations of the new points)")
    pool_side = {k: n_layers * n_steps for k in ("folded_pool_ext", "fused_h_side")}
    unpool_side = {k: n_layers * (n_steps + cached)
                   for k in ("folded_unpool", "fused_mlp_residual")}
    check_counts("upsample", counts, expected_counts({**pool_side, **unpool_side}), device)

    model.schedule = dataclasses.replace(full, n_solver_steps=4)
    data2 = torch.from_numpy(make_clouds(rng, 2, n_points)).to(device)
    outs = []
    for fused in (True, False):
        set_path(model, fused)
        outs.append(model.upsample(torch.Generator(device=device).manual_seed(3), data2,
                                   compare_new, n_substeps=2))
    set_path(model, True)
    check(f"4-step upsample of 2 clouds to {compare_new} points, kernel path vs plain path",
          rel_err(*outs), TOL_PATH)
    return counts, dict(seconds=seconds, points_per_s=n_new / seconds, cached_evals=cached)


def param_groups(model) -> dict:
    """Parameters grouped by their name without the layer index (e.g. all
    layers' ``broadcast.pool.kv_proj.weight`` in one group); the ConvNeXt's
    by part: its stem, each stage and each downsample."""
    groups = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if "layers" in parts:
            k = parts.index("layers")
            parts = parts[k + 2:]  # drop "...layers.<L>"
        elif parts[0] == "cond":
            k = parts.index("backbone") + 1
            part = parts[k:k + 2] if parts[k] in ("stages", "downs") else ["stem"]
            parts = parts[:k] + part
        groups.setdefault(".".join(parts), []).append(p)
    return groups


def expected_counts(nonzero: dict) -> dict:
    """Every kernel's (and WMMA body's) expected launch count: ``nonzero``'s,
    else 0."""
    return {k: nonzero.get(k, 0) for k in kernels.launch_counts()}


def check_counts(what, counts, expected, device):
    print(f"  launches per kernel on the {what} path: {counts}")
    if device.type == "cuda" and counts != expected:
        raise AssertionError(f"{what} launch counts {counts} != expected {expected}")


def check_finite(losses, *models):
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    for m in models:
        for name, p in m.named_parameters():
            if not bool(torch.isfinite(p).all()):
                raise AssertionError(f"non-finite parameter {name} after training")


# the TPU kernel's own backward algebra in plain PyTorch (the witness of the
# per-head path's unpool q/k gradients), kept here under its old name
rect_bwd_tpu_algebra = ia._rect_bwd_tpu_algebra


def compare_grads(model, loss_fn, tol, impl="folded_pallas", witness=False, against="plain"):
    """One step's gradient per parameter group, the kernel path (on
    ``impl``) against the plain path, same weights and inputs
    (``loss_fn()``). ``witness`` (the per-head path): both also against
    the plain path with the backbone computing in fp32; on the card the
    kernel path against itself with the rect-attention backward swapped
    for ``rect_bwd_tpu_algebra`` (TOL_ALGEBRA_GRAD: the backward kernel
    alone), and against the TPU algebra's witness, the per-head path with
    the rect attention's forward its plain version and its backward
    ``rect_bwd_tpu_algebra``, in which no kernel runs (``tol``).
    ``against="witness"`` holds the kernel path to that witness in place of
    the plain path, whose reading is printed: the per-head model at D 256,
    where the JAX kernel's own algebra (delta from the bf16 o) departs from
    fp32 more than the plain path does (``tests/test_torch_attention.py``,
    ``test_rect_bwd_witness_departs_from_fp32_at_d256``; PERF.md)."""
    backbone = model.network.backbone
    grads, losses = [], []
    passes = [(True, backbone.compute_dtype, None, None),
              (False, backbone.compute_dtype, None, None)]
    if witness:
        passes += [(False, torch.float32, None, None),
                   (True, backbone.compute_dtype, None, rect_bwd_tpu_algebra),
                   (True, backbone.compute_dtype, ia._rect_attention_ref, rect_bwd_tpu_algebra)]
    for fused, dtype, fwd, bwd in passes:
        set_path(model, fused, impl)
        backbone.compute_dtype, keep = dtype, backbone.compute_dtype
        keep_fwd, keep_bwd = ia.rect_attention_fwd, ia.rect_attention_bwd
        ia.rect_attention_fwd, ia.rect_attention_bwd = fwd or keep_fwd, bwd or keep_bwd
        model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        backbone.compute_dtype = keep
        ia.rect_attention_fwd, ia.rect_attention_bwd = keep_fwd, keep_bwd
        losses.append(float(loss.detach()))
        grads.append({k: torch.cat([p.grad.flatten().float() for p in ps])
                      for k, ps in param_groups(model).items()})
    set_path(model, True, impl)
    model.zero_grad(set_to_none=True)
    print(f"  loss at one batch: kernel path {losses[0]:.6f}, plain path {losses[1]:.6f}"
          + (f", plain path in fp32 {losses[2]:.6f}, the TPU algebra's witness "
             f"{losses[4]:.6f}" if witness else ""))
    rel = lambda a, ref: float((a - ref).norm() / ref.norm().clamp_min(1e-30))
    worst = {"plain": 0.0, "algebra": 0.0, "witness": 0.0}
    for k, ref in grads[1].items():
        err = rel(grads[0][k], ref)
        worst["plain"] = max(worst["plain"], err)
        line = (f"    grad {k}: ||kernel - plain|| / ||plain|| = {err:.3e} "
                f"(||plain|| = {float(ref.norm()):.3e})")
        if witness:
            k32, p32, w32 = (rel(grads[q][k], grads[2][k]) for q in (0, 1, 4))
            alg, wit = rel(grads[0][k], grads[3][k]), rel(grads[0][k], grads[4][k])
            worst["algebra"] = max(worst["algebra"], alg)
            worst["witness"] = max(worst["witness"], wit)
            line += (f"; against fp32: kernel {k32:.3e}, plain {p32:.3e}, the TPU algebra's "
                     f"witness {w32:.3e}; kernel against that witness {wit:.3e}, against its "
                     f"own forward with the algebra's backward {alg:.3e}")
        print(line)
    # on the CPU the "kernel" is the plain version itself: it is held to
    # the plain path
    on_card = witness and next(model.parameters()).device.type == "cuda"
    if not on_card or against == "plain":
        check("train-step gradient, kernel path vs plain path (worst group)", worst["plain"],
              tol, "||err||/||ref||")
    else:
        print(f"  the kernel path against the plain path (worst group): "
              f"{worst['plain']:.3e}, held to the TPU algebra's witness instead")
    if on_card:
        check("train-step gradient, kernel path vs the TPU algebra's witness, no kernel in it "
              "(worst group)", worst["witness"], tol, "||err||/||ref||")
        check("train-step gradient, kernel path vs its own forward with the TPU algebra's "
              "backward in plain PyTorch (worst group)", worst["algebra"], TOL_ALGEBRA_GRAD,
              "||err||/||ref||")


def train_phase(device, n_layers, batch, n_points, card, steps, attn_impl="folded_pallas",
                dims=FLAGSHIP, expect=None):
    """The flagship's (or the model of ``dims``') train step on procedural
    clouds, the set transformer on ``attn_impl``: the gradient of the
    kernel path against the plain path, then ``steps`` = (warm-up, timed)
    steps, whose launch counts must be ``expect(timed)`` (by default each
    set-transformer kernel once per layer and step); returns the
    per-kernel launch counts of the timed steps and a record."""
    warmup, timed = steps
    model = build_flagship(device, torch.Generator().manual_seed(0), n_layers,
                           attn_impl=attn_impl, dims=dims)
    gen = torch.Generator(device=device).manual_seed(1)
    rng = np.random.default_rng(0)
    data = [torch.from_numpy(make_clouds(rng, batch, n_points)).to(device) for _ in range(4)]

    # one step's gradient, kernel path vs plain path, same weights, batch and draws
    sigma, noise = model.draw_sigma_noise(gen, data[0])
    compare_grads(model, lambda: model.loss_from(data[0], sigma, noise), TOL_TRAIN_GRAD, attn_impl,
                  witness=attn_impl == "pallas")

    ema = make_ema(model)
    opt = flagship_optimizer()
    opt_state = opt.init(list(model.parameters()))
    step = make_train_step(opt, ema_alpha=0.999)
    for q in range(warmup):
        loss, opt_state = step(model, ema, opt_state, data[q % len(data)], gen)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for q in range(timed):
        loss, opt_state = step(model, ema, opt_state, data[q % len(data)], gen)
        losses.append(loss)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    losses = [float(v) for v in losses]
    ms = 1e3 * seconds / timed
    print(f"  {timed} steps at batch {batch}: {ms:.3f} ms/step, "
          f"{batch * timed / seconds:.3f} clouds/s trained on {card}; peak memory "
          + (f"{peak_gb:.3f} GiB" if peak_gb is not None else "not measured (no card)"))
    print(f"  losses: {' '.join(f'{v:.4f}' for v in losses)}")
    check_finite(losses, model, ema)
    if expect is not None:
        expected = expect(timed)
    elif attn_impl == "pallas":
        # the per-head path: each layer's pool and unpool, forward and backward
        expected = {k: 2 * n_layers * timed for k in ("rect_attention_fwd", "rect_attention_bwd")}
    else:
        expected = {k: n_layers * timed for k in SET_FORWARD + FOLDED_BACKWARD}
    check_counts(f"{attn_impl} training", counts,
                 expected_counts(expected), device)

    def run():
        nonlocal opt_state
        _, opt_state = step(model, ema, opt_state, data[0], gen)

    busy = profile_steps(run, PROFILE_STEPS, device)
    return counts, dict(ms_per_step=ms, clouds_per_s=batch * timed / seconds,
                        device_ms_per_step=busy, losses=losses, peak_gb=peak_gb)


def demo_train_phase(device, demo_dims, batch, heads3_dims, card, steps):
    """ROADMAP C4's two models train on the card: the upsample demo's
    model (3 x 128, 4 heads) through ``train_phase`` (its gradient against
    the plain path, then timed steps: the Hopper pool and unpool forwards,
    the MLP forward's WMMA body, the Hopper pool and unpool backwards and
    the MLP backward's WMMA body, each once per layer and step); then one
    gradient of the flagship with three heads (C 384, D 128) against the
    plain path, whose kernel path runs the pool and unpool forwards' WMMA
    bodies, their backwards' Hopper bodies and the Hopper MLP (the MLP sees
    no heads). Returns both runs' launch counts and the demo's record."""
    n_layers = demo_dims["n_layers"]
    layers = lambda k: {name: k * n_layers for name in (
        "folded_pool_ext", "fused_h_side", "folded_unpool", "fused_mlp_residual_wmma",
        "folded_pool_ext_bwd", "folded_unpool_bwd", "fused_mlp_residual_bwd_wmma")}
    counts, rec = train_phase(device, n_layers, batch, demo_dims["n_points"], card, steps,
                              dims=demo_dims, expect=layers)

    h_layers = heads3_dims["n_layers"]
    model = build_flagship(device, torch.Generator().manual_seed(0), h_layers, dims=heads3_dims)
    gen = torch.Generator(device=device).manual_seed(1)
    data = torch.from_numpy(make_clouds(np.random.default_rng(0), batch,
                                        heads3_dims["n_points"])).to(device)
    sigma, noise = model.draw_sigma_noise(gen, data)
    print(f"  num_heads=3 ({heads3_dims}), batch {batch}: one gradient, kernel path vs plain path")
    kernels.reset_launch_counts()
    compare_grads(model, lambda: model.loss_from(data, sigma, noise), TOL_TRAIN_GRAD)
    h_counts = kernels.launch_counts()
    check_counts("num_heads=3 gradient", h_counts, expected_counts(
        {k: h_layers for k in ("folded_pool_ext_wmma", "fused_h_side", "folded_unpool_wmma",
                               "fused_mlp_residual", "fused_mlp_residual_bwd",
                               "folded_pool_ext_bwd", "folded_unpool_bwd")}), device)
    return counts, h_counts, rec


def twopass_train_phase(device, n_layers, batch, n_points, card, steps) -> tuple:
    """The flagship's train step with ``GECCO_POOL_BWD`` forced to v1, v2
    and v2j in turn (``train_phase``: one step's gradient against the plain
    path, then ``steps``), each layer's pool backward through that body's
    kernel once per step and no other pool backward. Returns per body the
    launch counts of its timed steps and its record."""
    out = {}
    for body in kernels.TWOPASS_BODIES:
        print(f"  GECCO_POOL_BWD={body}:")
        names = SET_FORWARD + (f"folded_pool_ext_bwd_{body}",) + FOLDED_BACKWARD[1:]
        with pool_bwd_forced(body):
            out[body] = train_phase(device, n_layers, batch, n_points, card, steps,
                                    expect=lambda timed, k=names: {n: n_layers * timed
                                                                   for n in k})
    return out


def shapes_phase(device, n_layers, batch, compare_batch, cases) -> dict:
    """The shapes that ROADMAP C1 brought onto the card. Per case (name ->
    (dims, attn_impl, names launched per layer and evaluation, names
    launched per layer in a gradient[, options: ``pool_bwd``, the pool
    backward's body that ``GECCO_POOL_BWD`` forces; ``against``,
    ``compare_grads``' reference of the gradient])): an 8-step sample
    of ``compare_batch`` clouds from one latent, the kernel path against
    the plain path (TOL_PATH), then one gradient at ``batch`` against the
    plain path (TOL_TRAIN_GRAD), each run's launch counts exact: every
    function through a kernel. Returns each case's counts."""
    out = {}
    for name, (dims, impl, per_eval, per_grad, *opts) in cases.items():
        opts = opts[0] if opts else {}
        with pool_bwd_forced(opts.get("pool_bwd", fa._POOL_BWD_ENV)):
            out[name] = shape_case(device, n_layers, batch, compare_batch, name, dims, impl,
                                   per_eval, per_grad, opts.get("against", "plain"))
    return out


def shape_case(device, n_layers, batch, compare_batch, name, dims, impl, per_eval,
               per_grad, against="plain") -> tuple:
    """One case of ``shapes_phase`` -> its sample's and gradient's counts."""
    print(f"  {name} ({dims}, {impl}):")
    model = build_flagship(device, torch.Generator().manual_seed(0), n_layers,
                           attn_impl=impl, dims=dims)
    gen = torch.Generator(device=device).manual_seed(1)
    n = dims["n_points"]
    latent = model.schedule.sample_latent(gen, (compare_batch, n, 3), device)
    kernels.reset_launch_counts()
    fused = model.sample_from_latent(latent, n_solver_steps=8)
    counts = kernels.launch_counts()
    if tuple(fused.shape) != (compare_batch, n, 3) or not bool(torch.isfinite(fused).all()):
        raise AssertionError(f"{name}: sample of shape {tuple(fused.shape)} or non-finite")
    evals = 2 * (8 - 1)
    check_counts(f"{name} 8-step sample", counts,
                 expected_counts({k: m * n_layers * evals for k, m in per_eval.items()}),
                 device)
    set_path(model, False)
    plain = model.sample_from_latent(latent, n_solver_steps=8)
    set_path(model, True, impl)
    check(f"{name}: 8-step sample, kernel path vs plain path", rel_err(fused, plain), TOL_PATH)
    data = torch.from_numpy(make_clouds(np.random.default_rng(0), batch, n)).to(device)
    sigma, noise = model.draw_sigma_noise(gen, data)
    kernels.reset_launch_counts()
    compare_grads(model, lambda: model.loss_from(data, sigma, noise), TOL_TRAIN_GRAD, impl,
                  witness=impl == "pallas", against=against)
    grad_counts = kernels.launch_counts()
    check_counts(f"{name} gradient", grad_counts,
                 expected_counts({k: m * n_layers for k, m in per_grad.items()}), device)
    return counts, grad_counts


def ragged_phase(device, shapes, train_batch, demo, heads3, dt, reps, ns, n_layers):
    """Phase 22: every body of the point-tiled functions at ragged point
    counts ``ns`` (N 2000 pads to 2048; N 2050 pads to 2176, whose last
    64-point chunk holds no point: the pools also take it), forward and
    backward, ordinary and drifted, against its plain version at the
    unpadded N with the tolerances of its N 2048 check, failing unless the
    expected body ran; then the flagship on ``folded_pallas`` at ``ns[0]``
    (an 8-step sample against the plain path, a gradient at
    ``train_batch``, the launch counts exact) and one evaluation's time at
    ``ns[0]`` beside one at the padded count. Returns the times."""
    g = torch.Generator(device=device).manual_seed(9)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    c, heads, i = shapes["feature_dim"], shapes["num_heads"], shapes["num_inducers"]
    dc, dh, di = demo["feature_dim"], demo["num_heads"], demo["num_inducers"]
    hc, hh = heads3["feature_dim"], heads3["num_heads"]
    sb, db, tb = shapes["batch"], demo["batch"], train_batch
    tags = lambda n, drift: f"N {n}, {'drift' if drift else 'ordinary'}"

    def ran(what, body, other):
        counts = kernels.launch_counts()
        print(f"    launches: {body} {counts[body]}, {other} {counts[other]}")
        if device.type == "cuda" and (counts[body] == 0 or counts[other]):
            raise AssertionError(f"{what}: expected the {body} body, got {counts}")

    # forwards: (name, the body's counter, the other body's, operands at N,
    # kernel, plain): the Hopper pool and unpool at the flagship's and the
    # demo's widths, their WMMA bodies at three heads
    fwd = (
        ("folded_pool_ext", "folded_pool_ext_wmma", ns,
         lambda n, d: pool_operands(g, sb, n, c, heads, i, d, device, dt),
         lambda *a: fa.folded_pool_ext(*a, heads), lambda *a: fa._pool_ext_ref(*a, heads)),
        ("folded_pool_ext", "folded_pool_ext_wmma", ns,
         lambda n, d: pool_operands(g, db, n, dc, dh, di, d, device, dt),
         lambda *a: fa.folded_pool_ext(*a, dh), lambda *a: fa._pool_ext_ref(*a, dh)),
        ("folded_pool_ext_wmma", "folded_pool_ext", ns,
         lambda n, d: pool_operands(g, sb, n, hc, hh, i, d, device, dt),
         lambda *a: fa.folded_pool_ext(*a, hh), lambda *a: fa._pool_ext_ref(*a, hh)),
        ("folded_unpool", "folded_unpool_wmma", ns[:1],
         lambda n, d: unpool_operands(g, sb, n, c, heads, i, d, device, dt),
         lambda *a: fa.folded_unpool(*a, heads), lambda *a: fa._unpool_ref(*a, heads)),
        ("folded_unpool", "folded_unpool_wmma", ns[:1],
         lambda n, d: unpool_operands(g, db, n, dc, dh, di, d, device, dt),
         lambda *a: fa.folded_unpool(*a, dh), lambda *a: fa._unpool_ref(*a, dh)),
        ("folded_unpool_wmma", "folded_unpool", ns[:1],
         lambda n, d: unpool_operands(g, sb, n, hc, hh, i, d, device, dt),
         lambda *a: fa.folded_unpool(*a, hh), lambda *a: fa._unpool_ref(*a, hh)),
        ("fused_mlp_residual", "fused_mlp_residual_wmma", ns[:1],
         lambda n, d: mlp_operands(g, sb, n, c, 2 * c, d, device, dt),
         fa.fused_mlp_residual, fa._mlp_ref),
        ("fused_mlp_residual_wmma", "fused_mlp_residual", ns[:1],
         lambda n, d: mlp_operands(g, db, n, dc, 2 * dc, d, device, dt),
         fa.fused_mlp_residual, fa._mlp_ref),
    )
    with torch.no_grad():
        for body, other, counts_ns, ops, kernel, plain in fwd:
            kernels.reset_launch_counts()
            for n in counts_ns:
                for drift in (False, True):
                    args = ops(n, drift)
                    got, want = kernel(*args), plain(*args)
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    sync(device)
                    for q, (a, ref) in enumerate(zip(got, want)):
                        if q == 0 and tuple(a.shape) != tuple(ref.shape):
                            raise AssertionError(f"{body}: shape {tuple(a.shape)}")
                        check(f"{body} [{tags(n, drift)}] {'sums' if q else 'out'}",
                              rel_err(a, ref), TOL_SUMS if q else TOL_OUT)
            ran(body, body, other)

    # backwards
    def pool_bwd(bb, cc, hh_, ii):
        def make(n, drift):
            ops = pool_operands(g, bb, n, cc, hh_, ii, drift, device, dt)
            if device.type == "cuda":
                _, qft, macc, sacc = fa._pool_ext_launch(*ops, hh_, True)
            else:
                qft = macc = sacc = None
            gh = (0.1 * r(bb, ii, cc)).to(dt)
            return (lambda: fa.folded_pool_ext_bwd(*ops, qft, macc, sacc, gh, hh_),
                    lambda: fa._pool_ext_bwd_ref(*ops, gh, hh_),
                    lambda: pool_bwd_v3_affine(*ops, gh, hh_))
        return make

    def unpool_bwd(bb, cc, hh_, ii):
        def make(n, drift):
            ops = unpool_operands(g, bb, n, cc, hh_, ii, drift, device, dt)
            gg, gs = (0.1 * r(bb, n, cc)).to(dt), 1e-3 * r(bb, 2, cc)
            return (lambda: fa.folded_unpool_bwd(*ops, gg, gs, hh_),
                    lambda: fa._unpool_bwd_ref(*ops, gg, gs, hh_), None)
        return make

    def mlp_bwd(bb, cc):
        def make(n, drift):
            ops = mlp_operands(g, bb, n, cc, 2 * cc, drift, device, dt)
            gg, gs = (0.1 * r(bb, n, cc)).to(dt), 1e-3 * r(bb, 2, cc)
            return (lambda: fa.fused_mlp_residual_bwd(*ops, gg, gs),
                    lambda: fa._mlp_bwd_ref(*ops, gg, gs), None)
        return make

    pool_names = ("dx", "dse", "dbe", "dind2", "dkvw", "dwo")
    # the pool and unpool backwards' Hopper bodies at the flagship's, the
    # demo's and three heads' widths, their WMMA bodies at 48 inducers of
    # the demo's width
    unpool_names = ("dx", "dse", "dbe", "dk", "dv", "dwq", "dwo")
    bwd = (
        ("folded_pool_ext_bwd", "folded_pool_ext_bwd_wmma", ns, pool_bwd(tb, c, heads, i),
         pool_names),
        ("folded_pool_ext_bwd", "folded_pool_ext_bwd_wmma", ns, pool_bwd(tb, dc, dh, di),
         pool_names),
        ("folded_pool_ext_bwd", "folded_pool_ext_bwd_wmma", ns[:1], pool_bwd(tb, hc, hh, i),
         pool_names),
        ("folded_pool_ext_bwd_wmma", "folded_pool_ext_bwd", ns[:1], pool_bwd(tb, dc, dh, 48),
         pool_names),
        ("folded_unpool_bwd", "folded_unpool_bwd_wmma", ns[:1], unpool_bwd(tb, c, heads, i),
         unpool_names),
        ("folded_unpool_bwd", "folded_unpool_bwd_wmma", ns[:1], unpool_bwd(tb, hc, hh, i),
         unpool_names),
        ("folded_unpool_bwd_wmma", "folded_unpool_bwd", ns[:1], unpool_bwd(tb, dc, dh, 48),
         unpool_names),
        ("fused_mlp_residual_bwd", "fused_mlp_residual_bwd_wmma", ns[:1], mlp_bwd(tb, c),
         ("dx", "dse", "dbe", "dw1t", "db1", "dw2t", "db2")),
        ("fused_mlp_residual_bwd_wmma", "fused_mlp_residual_bwd", ns[:1], mlp_bwd(tb, dc),
         ("dx", "dse", "dbe", "dw1t", "db1", "dw2t", "db2")),
    )
    for body, other, counts_ns, make, names in bwd:
        kernels.reset_launch_counts()
        for n in counts_ns:
            for drift in (False, True):
                kernel, plain, witness = make(n, drift)
                got, want = kernel(), plain()
                sync(device)
                for out, a, ref in zip(names, got, want):
                    tol = TOL_AFFINE if out in ("dse", "dbe") else TOL_GRAD
                    if witness is not None and drift and out == "dbe":
                        # the v3 algebra's residue, as in phase 4
                        tol = TOL_POOL_DRIFT_DBE
                        if device.type == "cuda":
                            check(f"{body} [{tags(n, drift)}] dbe against the v3 algebra",
                                  rel_err(a, witness()[1]), TOL_AFFINE)
                    check(f"{body} [{tags(n, drift)}] {out}", rel_err(a, ref), tol)
        ran(body, body, other)

    # the resident pool, with and without its pre-norm
    def layer_ops(bb, n, drift):
        x, sc, bi, ind2, kvw, wo = pool_operands(g, bb, n, c, heads, i, drift, device, dt)
        x = (1.5 * x.float() + 0.3 * r(1, 1, c)).to(dt)
        return x, sc, bi, ind2, kvw, wo, fa.group_indicator(c, GROUPS, device)

    kernels.reset_launch_counts()
    for n in ns:
        for prenorm in (True, False):
            for drift in (False, True):
                tag = f"{tags(n, drift)}, {'prenorm' if prenorm else 'no pre-norm'}"
                ops = layer_ops(sb, n, drift)
                with torch.no_grad():
                    got = fa.folded_pool_layer(*ops, heads, prenorm)
                    want = fa._pool_ref(*ops[:6], GROUPS, heads, prenorm)
                sync(device)
                for name, a, ref, tol in zip(("h0", "mean_c", "inv_c"), got, want,
                                             (TOL_OUT, TOL_STATS, TOL_STATS)):
                    check(f"folded_pool_layer [{tag}] {name}", rel_err(a, ref), tol)
                ops = layer_ops(tb, n, drift)
                if device.type == "cuda":
                    _, mean, inv, fwd_ = fa._pool_layer_launch(*ops, heads, prenorm, True)
                else:
                    mean = inv = None
                    fwd_ = (None, None, None, None)
                cot = ((0.1 * r(tb, i, c)).to(dt), 1e-2 * r(tb, c), 1e-2 * r(tb, c))
                got = fa.folded_pool_layer_bwd(*ops, mean, inv, *fwd_, *cot, heads, prenorm)
                want = fa._pool_layer_bwd_ref(*ops, *cot, heads, prenorm)
                sync(device)
                for name, a, ref in zip(("dx", "dscale", "dbias", "dind2", "dkvw", "dwo"), got,
                                        want):
                    tol = TOL_AFFINE if name in ("dscale", "dbias") else TOL_GRAD
                    if prenorm and drift and name == "dbias":
                        # the TPU algebra's residue, as in phase 14
                        tol = TOL_POOL_DRIFT_DBE
                        if device.type == "cuda":
                            alg = pool_layer_bwd_tpu_algebra(*ops, cot[0], heads)[1]
                            check(f"folded_pool_layer_bwd [{tag}] dbias against the TPU "
                                  f"algebra", rel_err(a, alg), TOL_AFFINE)
                    check(f"folded_pool_layer_bwd [{tag}] {name}", rel_err(a, ref), tol)
    counts = kernels.launch_counts()
    print(f"    launches: folded_pool_layer {counts['folded_pool_layer']}, folded_pool_layer_wmma "
          f"{counts['folded_pool_layer_wmma']}, folded_pool_layer_bwd "
          f"{counts['folded_pool_layer_bwd']}")
    # per N, flag and operands: the forward, the backward's forward, the backward
    cases = len(ns) * 2 * 2
    if device.type == "cuda" and (counts["folded_pool_layer"] != 2 * cases
                                  or counts["folded_pool_layer_wmma"]
                                  or counts["folded_pool_layer_bwd"] != cases
                                  or counts["folded_pool_layer_bwd_wmma"]):
        raise AssertionError(f"the resident pool's Hopper body and backward did not run "
                             f"exactly: {counts}")

    # the flagship at the ragged N: every function through a kernel
    n = ns[0]
    every = dict(folded_pool_ext=1, fused_h_side=1, folded_unpool=1, fused_mlp_residual=1)
    shapes_phase(device, n_layers, train_batch, 8, {
        f"the flagship at N {n}": (dict(FLAGSHIP, n_points=n), "folded_pallas", every,
                                   dict(every, folded_pool_ext_bwd=1, folded_unpool_bwd=1,
                                        fused_mlp_residual_bwd=1))})
    # one evaluation at the ragged N and at its padded count, in turns
    model = build_flagship(device, torch.Generator().manual_seed(0), n_layers)
    n_pad = fa._n_pad(n)
    x = {m: model.schedule.sample_latent(torch.Generator(device=device).manual_seed(2),
                                         (sb, m, 3), device) for m in (n, n_pad)}
    sigma = torch.full((sb,), 10.0, device=device)
    times = {m: [] for m in (n, n_pad)}
    with torch.no_grad():
        for m in (n, n_pad, n_pad, n):
            times[m] += time_all(lambda: model.denoise(sigma, x[m]), device, max(1, reps // 2))
    out = {f"eval_ms_n{m}": statistics.median(t) for m, t in times.items()}
    print(f"  one flagship evaluation at batch {sb}: N {n} {out[f'eval_ms_n{n}']:.3f} ms, "
          f"N {n_pad} {out[f'eval_ms_n{n_pad}']:.3f} ms (median of {len(times[n])} each, "
          f"in turns)")
    return out


def c1_phase(device, dt, shapes, n_points, rehearse) -> dict:
    """Phase 21's checks of the shapes that ROADMAP C1 listed as raising on
    the card (the JAX package runs its kernels there), each function
    against its plain version at the tolerances of its checks at the
    flagship's shapes, ordinary and drifted, failing unless the expected
    body ran: the resident pool's Hopper body at 24, 128 and 256 inducers
    and its WMMA body's column blocks (three heads, 256); the pool forward
    and backward at 24 and 256 inducers; the unpool forward at 24, 192 and
    256 and its backward at 24, 128 and 256; the h-side at 24; the rect
    attention at D 40 and 192, both directions; the resident pool's
    backward at 256 inducers (both bodies); the pool backward's v1, v2 and
    v2j bodies at N 2000, at three heads (their Hopper body) and at the
    demo's width (their WMMA body). Then one model per item at two layers
    (``shapes_phase``): an 8-step sample and a gradient, every function
    through a kernel. Returns the models' launch counts."""
    g = torch.Generator(device=device).manual_seed(11)
    r = lambda *sh: torch.randn(*sh, generator=g, device=device)
    n, c, heads = shapes["n_points"], shapes["feature_dim"], shapes["num_heads"]
    b = 2 if rehearse else 8
    # the rect attention's widths, (C, H): D 40, D 192 and D 256
    rect = ((160, 4), (192, 1), (256, 1)) if rehearse else ((320, 8), (384, 2), (768, 3))
    tags = lambda what, drift: f"{what}, {'drift' if drift else 'ordinary'}"

    def ran(what, body, other=None):
        """The expected body ran (and the other did not), then the counters
        are reset."""
        counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        if device.type == "cuda" and (counts[body] == 0 or (other and counts[other])):
            raise AssertionError(f"{what}: expected the {body} body, got {counts}")

    def hold(what, got, want, names, tols):
        sync(device)
        for name, a, ref, tol in zip(names, got, want, tols):
            if tuple(a.shape) != tuple(ref.shape):
                raise AssertionError(f"{what} {name}: shape {tuple(a.shape)}, "
                                     f"expected {tuple(ref.shape)}")
            check(f"{what} {name}", rel_err(a, ref), tol)

    kernels.reset_launch_counts()
    # the resident pool: (C, H, I, the body's counter)
    h3 = 3 if c % 48 == 0 else 2  # the WMMA body's heads: D 128 at the flagship's C
    layer_cases = ((c, heads, 24, "folded_pool_layer"), (c, heads, 128, "folded_pool_layer"),
                   (c, heads, 256, "folded_pool_layer"), (c, h3, 256, "folded_pool_layer_wmma"))
    for cc, hh, ii, body in layer_cases:
        for drift in (False, True):
            x, sc, bi, ind2, kvw, wo = pool_operands(g, b, n, cc, hh, ii, drift, device, dt)
            x = (1.5 * x.float() + 0.3 * r(1, 1, cc)).to(dt)
            ops = (x, sc, bi, ind2, kvw, wo, fa.group_indicator(cc, GROUPS, device))
            for prenorm in (True, False):
                with torch.no_grad():
                    got = fa.folded_pool_layer(*ops, hh, prenorm)
                    want = fa._pool_ref(*ops[:6], GROUPS, hh, prenorm)
                hold(f"folded_pool_layer [{tags(f'{hh} heads, I {ii}', drift)}, "
                     f"{'prenorm' if prenorm else 'no pre-norm'}]", got, want,
                     ("h0", "mean_c", "inv_c"), (TOL_OUT, TOL_STATS, TOL_STATS))
        ran(f"folded_pool_layer at {hh} heads, I {ii}", body)

    # the resident pool's backward at 256 inducers at the flagship's and the
    # 8k width (its Hopper body: four blocks of 64 inducer columns a head)
    # and at three heads (its WMMA body: the main kernel's 32-point tile),
    # with and without the pre-norm, on the forward's saved tensors, as
    # phase 14 holds it at 64 (the drifted dbias with the pre-norm beside
    # its witness)
    lnames = ("dx", "dscale", "dbias", "dind2", "dkvw", "dwo")
    for cc, hh, body in ((c, heads, "folded_pool_layer_bwd"),
                         (2 * c, 2 * heads, "folded_pool_layer_bwd"),
                         (c, h3, "folded_pool_layer_bwd_wmma")):
        for drift in (False, True):
            x, sc, bi, ind2, kvw, wo = pool_operands(g, b, n, cc, hh, 256, drift, device, dt)
            x = (1.5 * x.float() + 0.3 * r(1, 1, cc)).to(dt)
            ops = (x, sc, bi, ind2, kvw, wo, fa.group_indicator(cc, GROUPS, device))
            for prenorm in (True, False):
                if device.type == "cuda":
                    _, mean, inv, fwd = fa._pool_layer_launch(*ops, hh, prenorm, True)
                else:
                    mean = inv = None
                    fwd = (None, None, None, None)
                cot = ((0.1 * r(b, 256, cc)).to(dt), 1e-2 * r(b, cc), 1e-2 * r(b, cc))
                kernels.reset_launch_counts()
                got = fa.folded_pool_layer_bwd(*ops, mean, inv, *fwd, *cot, hh, prenorm)
                want = fa._pool_layer_bwd_ref(*ops, *cot, hh, prenorm)
                what = (f"{body} [{tags(f'{hh} heads, I 256', drift)}, "
                        f"{'prenorm' if prenorm else 'no pre-norm'}]")
                tols = [TOL_AFFINE if k in ("dscale", "dbias") else TOL_GRAD for k in lnames]
                if prenorm and drift:
                    tols[2] = TOL_POOL_DRIFT_DBE
                    if device.type == "cuda":
                        alg = pool_layer_bwd_tpu_algebra(*ops, cot[0], hh)[1]
                        check(f"{what} dbias against the TPU algebra", rel_err(got[2], alg),
                              TOL_AFFINE)
                hold(what, got, want, lnames, tols)
                ran(f"{body} at {hh} heads, I 256", body,
                    "folded_pool_layer_bwd_wmma" if body == "folded_pool_layer_bwd"
                    else "folded_pool_layer_bwd")

    # the pool forward and backward (their WMMA bodies), three heads' at 256
    # inducers through the fold's 64-row blocks
    for hh, ii in ((heads, 24), (heads, 256), (h3, 256)):
        for drift in (False, True):
            what = tags(f"{hh} heads, I {ii}", drift)
            ops = pool_operands(g, b, n, c, hh, ii, drift, device, dt)
            with torch.no_grad():
                got, want = fa.folded_pool_ext(*ops, hh), fa._pool_ext_ref(*ops, hh)
            hold(f"folded_pool_ext [{what}]", (got,), (want,), ("h0",), (TOL_OUT,))
            ran(f"folded_pool_ext at {hh} heads, I {ii}", "folded_pool_ext_wmma",
                "folded_pool_ext")
            if device.type == "cuda":
                _, qft, macc, sacc = fa._pool_ext_launch(*ops, hh, True)
            else:
                qft = macc = sacc = None
            kernels.reset_launch_counts()
            gh = (0.1 * r(b, ii, c)).to(dt)
            got = fa.folded_pool_ext_bwd(*ops, qft, macc, sacc, gh, hh)
            want = fa._pool_ext_bwd_ref(*ops, gh, hh)
            names = ("dx", "dse", "dbe", "dind2", "dkvw", "dwo")
            tols = [TOL_AFFINE if k in ("dse", "dbe") else TOL_GRAD for k in names]
            if drift:
                # the v3 algebra's residue in the drifted dbe, as in phase 4:
                # held against the algebra itself
                tols[2] = TOL_POOL_DRIFT_DBE
                if device.type == "cuda":
                    check(f"folded_pool_ext_bwd [{what}] dbe against the v3 algebra",
                          rel_err(got[2], pool_bwd_v3_affine(*ops, gh, hh)[1]), TOL_AFFINE)
            hold(f"folded_pool_ext_bwd [{what}]", got, want, names, tols)
            ran(f"folded_pool_ext_bwd at {hh} heads, I {ii}", "folded_pool_ext_bwd_wmma",
                "folded_pool_ext_bwd")

    # the unpool forward and backward (their WMMA bodies)
    unames = ("dx", "dse", "dbe", "dk", "dv", "dwq", "dwo")
    for ii in (24, 128, 192, 256):
        for drift in (False, True):
            ops = unpool_operands(g, b, n, c, heads, ii, drift, device, dt)
            if ii != 128:
                with torch.no_grad():
                    got, want = fa.folded_unpool(*ops, heads), fa._unpool_ref(*ops, heads)
                hold(f"folded_unpool [{tags(f'I {ii}', drift)}]", got, want, ("out", "sums"),
                     (TOL_OUT, TOL_SUMS))
                ran(f"folded_unpool at I {ii}", "folded_unpool_wmma", "folded_unpool")
            if ii != 192:
                gg, gs = (0.1 * r(b, n, c)).to(dt), 1e-3 * r(b, 2, c)
                got = fa.folded_unpool_bwd(*ops, gg, gs, heads)
                want = fa._unpool_bwd_ref(*ops, gg, gs, heads)
                hold(f"folded_unpool_bwd [{tags(f'I {ii}', drift)}]", got, want, unames,
                     [TOL_AFFINE if k in ("dse", "dbe") else TOL_GRAD for k in unames])
                ran(f"folded_unpool_bwd at I {ii}", "folded_unpool_bwd_wmma",
                    "folded_unpool_bwd")

    # the h-side at a ragged I (its Hopper body, the padding masked)
    for drift in (False, True):
        ops = hside_operands(g, b, 24, c, 2 * c, drift, device, dt)
        with torch.no_grad():
            got, want = hs.fused_h_side(*ops), hs._hside_ref(*ops)
        hold(f"fused_h_side [{tags('I 24', drift)}]", got, want, ("h", "k", "v"),
             (TOL_OUT,) * 3)
    ran("fused_h_side at I 24", "fused_h_side", "fused_h_side_wmma")

    # the rect attention at D 40 (8 heads at C 320), D 192 (2 heads at C
    # 384) and D 256 (3 heads at C 768: the backward's two column slices),
    # both directions, forward and backward
    for cc, hh in rect:
        for direction in ("pool", "unpool"):
            for drift in (False, True):
                q, k, v = attn_operands(g, b, n, cc, hh, 64, direction, drift, device, dt)
                what = tags(f"D {cc // hh}, {direction}", drift)
                o, lse = ia.rect_attention_fwd(q, k, v)
                hold(f"rect_attention_fwd [{what}]", (o, lse), ia._rect_attention_ref(q, k, v),
                     ("o", "lse"), (TOL_OUT, TOL_LSE))
                gg = torch.randn(o.shape, generator=g, device=device).to(dt)
                hold(f"rect_attention_bwd [{what}]", ia.rect_attention_bwd(q, k, v, o, lse, gg),
                     ia._rect_attention_bwd_ref(q, k, v, gg), ("dq", "dk", "dv"),
                     (TOL_GRAD,) * 3)
        ran(f"rect_attention_fwd at D {cc // hh}", "rect_attention_fwd_wmma",
            "rect_attention_fwd")

    # the pool backward's v1, v2 and v2j bodies at a ragged N and at three
    # heads (J 192: the S product's 64-column tiles and the weight
    # gradients' 64-column tail; D 128) (the Hopper body), and at the demo's
    # width (the WMMA body), against their plain versions (the same algebra)
    outs = ("dx", "dse", "dbe", "dqf", "dwv", "dwo")
    twopass_cases = ((b, n - 48, c, heads, ""), (b, n, 128, 4, "_wmma"), (b, n, c, h3, ""))
    for bb, nn_, cc, hh, impl in twopass_cases:
        for drift in (False, True):
            ops = pool_operands(g, bb, nn_, cc, hh, 64, drift, device, dt)
            x, se, be, ind2, kvw, wo = ops
            if device.type == "cuda":
                _, qft, macc, sacc = fa._pool_ext_launch(*ops, hh, True)
            else:
                qft = fa._fold_qft_ref(ind2, kvw, hh)
                xp = fa._pad_points(x, fa._n_pad(nn_))
                _, macc, sacc = fa._pool_merge_ref(
                    *fa._pool_partials_ref(xp, se, be, qft, kvw, hh, nn_), wo, hh)
            kernels.reset_launch_counts()
            gh = (0.1 * r(bb, 64, cc)).to(dt)
            raw = (x, se, be, qft, kvw, wo, gh, macc, sacc, hh)
            for body in kernels.TWOPASS_BODIES:
                if device.type == "cuda":
                    with pool_bwd_forced(body):
                        picked = fa._pool_ext_bwd_body(bb, nn_, cc, hh, 64)
                    if picked != body + impl:
                        raise AssertionError(f"GECCO_POOL_BWD={body} at N {nn_}, C {cc}, "
                                             f"{hh} heads: {picked}")
                got = (fa._pool_ext_bwd_twopass(*raw, body) if device.type == "cuda"
                       else fa._TWOPASS_REFS[body](*raw))
                what = tags(f"N {nn_}, C {cc}, {hh} heads", drift)
                hold(f"folded_pool_ext_bwd_{body}{impl} [{what}]", got,
                     fa._TWOPASS_REFS[body](*raw), outs,
                     [TOL_AFFINE if k in ("dse", "dbe") else TOL_ALGEBRA_GRAD for k in outs])
                ran(f"folded_pool_ext_bwd_{body}{impl} at N {nn_}, C {cc}, {hh} heads",
                    f"folded_pool_ext_bwd_{body}{impl}")

    # one model per item, two layers: every function through a kernel
    wmma = dict(folded_pool_ext_wmma=1, fused_h_side=1, folded_unpool_wmma=1,
                fused_mlp_residual=1)
    wmma_grad = dict(wmma, folded_pool_ext_bwd_wmma=1, folded_unpool_bwd_wmma=1,
                     fused_mlp_residual_bwd=1)
    demo = dict(folded_pool_ext=1, fused_h_side=1, folded_unpool=1, fused_mlp_residual_wmma=1)
    every = dict(folded_pool_ext=1, fused_h_side=1, folded_unpool=1, fused_mlp_residual=1)
    # the per-head models at D 40, 192 and 256: the rect attention's WMMA bodies
    per_head = (dict(rect_attention_fwd_wmma=2),
                dict(rect_attention_fwd_wmma=4, rect_attention_bwd_wmma=2))
    base = dict(FLAGSHIP, feature_dim=c, num_heads=heads, n_points=n_points)
    cases = {f"the flagship with {ii} inducers": (dict(base, num_inducers=ii), "folded_pallas",
                                                  wmma, wmma_grad)
             for ii in (128, 256, 24)}
    cases[f"the flagship with {h3} heads and 256 inducers"] = (
        dict(base, num_heads=h3, num_inducers=256), "folded_pallas", wmma, wmma_grad)
    for cc, hh in rect:
        # at D 256 the TPU algebra's own gradient departs from the plain
        # path beyond TOL_TRAIN_GRAD (PERF.md §6): the gradient is held
        # to that algebra's kernel-free witness, the plain reading printed
        cases[f"the per-head flagship at D {cc // hh} ({hh} heads at C {cc})"] = (
            dict(base, feature_dim=cc, num_heads=hh), "pallas", *per_head,
            dict(against="witness" if cc // hh > 192 else "plain"))
    for body in kernels.TWOPASS_BODIES:
        cases[f"the flagship at N {n_points - 48} under GECCO_POOL_BWD={body}"] = (
            dict(base, n_points=n_points - 48), "folded_pallas", every,
            dict(every, folded_unpool_bwd=1, fused_mlp_residual_bwd=1,
                 **{f"folded_pool_ext_bwd_{body}": 1}), dict(pool_bwd=body))
        cases[f"the flagship with {h3} heads under GECCO_POOL_BWD={body}"] = (
            dict(base, num_heads=h3), "folded_pallas", wmma,
            dict(wmma, folded_unpool_bwd=1, fused_mlp_residual_bwd=1,
                 **{f"folded_pool_ext_bwd_{body}": 1}), dict(pool_bwd=body))
        # the demo's width (C 128, four heads): the WMMA two-pass body
        cases[f"the demo's width under GECCO_POOL_BWD={body}"] = (
            dict(base, feature_dim=128, num_heads=4), "folded_pallas", demo,
            dict(demo, folded_unpool_bwd=1, fused_mlp_residual_bwd_wmma=1,
                 **{f"folded_pool_ext_bwd_{body}_wmma": 1}), dict(pool_bwd=body))
    out = shapes_phase(device, 2, b if rehearse else 16, 8, cases)
    # the resident pool runs on no model's path: its backward at 256
    # inducers is held as the module-level Broadcast's (its only gradient
    # path), forward and gradient against the plain path
    out["a Broadcast with 256 inducers"] = broadcast_case(
        device, dict(batch=8, n_points=n, feature_dim=c, num_inducers=256, num_heads=heads),
        b if rehearse else 16, dt)
    return out


def validate_phase(device, rehearse):
    """``gecco_tpu_torch.validate``'s loop, short: 20 steps of the flagship at
    batch 48 and one eval of 16 clouds with 8 Heun steps on the card (a
    3-step, 2-layer cut at 64 points on the CPU); raises unless every loss
    is finite, 1-NN and COV lie in [0, 1] and MMD is finite and >= 0."""
    out = Path(__file__).resolve().parent / "runs" / "chip_smoke_validate.jsonl"
    if out.exists():
        out.unlink()
    if rehearse:
        argv = ["--device", "cpu", "--steps", "3", "--n-layers", "2", "--feature-dim", "64",
                "--num-inducers", "16", "--num-heads", "4", "--n-points", "64", "--batch", "4",
                "--eval-every", "3", "--eval-clouds", "4", "--sampler-steps", "2"]
    else:
        argv = ["--device", "cuda", "--steps", "20", "--batch", str(TRAIN_BATCH),
                "--eval-every", "20", "--eval-clouds", "16", "--sampler-steps", "8"]
    t0 = time.perf_counter()
    records = validate.run(validate.parser().parse_args(argv + ["--log-every", "10",
                                                               "--out", str(out)]),
                           emit=lambda line: print(f"  {line}"))
    seconds = time.perf_counter() - t0
    check_finite([r["loss"] for r in records])
    last = records[-1]
    ok = (0.0 <= last["one_nn"] <= 1.0 and 0.0 <= last["cov"] <= 1.0
          and np.isfinite(last["mmd"]) and last["mmd"] >= 0.0)
    print(f"  {len(records)} records in {seconds:.1f} s; scores "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"validate: scores out of range: {last}")
    return dict(seconds=seconds, **last)


# the kernels of each wrapper, by the function names in gecco_tpu_torch/csrc
KERNEL_FUNCTIONS = {
    # linear_nt_kernel (pool.cuh) is the resident pool's output projection too
    "folded_pool_ext": ("pool_fold_kernel", "pool_chunk_kernel", "pool_merge_kernel",
                        "linear_nt_kernel"),
    "fused_h_side": ("hside_norm_kernel", "hside_act_kernel", "hside_out_kernel",
                     "hside_kv_kernel"),
    "fused_h_side_wmma": ("hside_kernel",),
    "folded_unpool": ("unpool_tile_kernel",),
    "unpool_bq/fold_k/fold_v_kernel (the Hopper unpool's and the megakernel's shared fold)": (
        "unpool_bq_kernel", "unpool_fold_k_kernel", "unpool_fold_v_kernel"),
    "fused_mlp_residual": ("mlp_act_kernel", "mlp_out_kernel"),
    "fused_mlp_residual_wmma": ("mlp_kernel",),
    "folded_pool_ext_bwd": ("pool_bwd_ety_kernel", "pool_bwd_dy_kernel"),
    "pool_bwd_fold_kernel (the pool backwards' fold)": ("pool_bwd_fold_kernel",),
    "folded_pool_ext_bwd_wmma": ("pool_bwd_e_kernel", "pool_bwd_ety_cast_kernel",
                                 "pool_bwd_dy_wmma_kernel"),
    "folded_pool_ext_wmma": ("pool_kernel",),
    "folded_unpool_wmma": ("unpool_fold_kernel", "unpool_kernel"),
    "folded_unpool_bwd": ("unpool_bwd_heads_kernel", "unpool_bwd_rows_kernel"),
    "unpool_bwd_fold_kernel (the unpool backwards' fold)": ("unpool_bwd_fold_kernel",),
    "folded_unpool_bwd_wmma": ("unpool_bwd_kernel",),
    "prenorm_kernel and wgrad_kernel (the Hopper backwards' shared pre-norm and weight "
    "gradients)": ("prenorm_kernel", "wgrad_kernel", "wgrad_sum_kernel"),
    "fused_mlp_residual_bwd": ("mlp_bwd_act_kernel", "mlp_bwd_grad_kernel", "mlp_bwd_dh_kernel",
                               "mlp_bwd_dx_kernel"),
    "mlp_colsum_kernel (the Hopper MLP bodies' fixed-order column sums)": ("mlp_colsum_kernel",),
    "fused_mlp_residual_bwd_wmma": ("mlp_bwd_kernel",),
    "folded_pool_ext_bwd_v1/_v2/_v2j (the pool backward's two-pass Hopper body)": (
        "twopass_s_kernel", "twopass_s64_kernel", "twopass_v_kernel", "twopass_range_kernel",
        "twopass_merge_kernel", "twopass_tile_kernel", "twopass_dy_kernel"),
    "folded_pool_ext_bwd_v1/_v2/_v2j_wmma (the pool backward's two-pass WMMA body)": (
        "twopass_pass0_kernel", "twopass_pass1_kernel"),
    "twopass_fold/colsum_kernel (both two-pass bodies' fold and column sums)": (
        "twopass_fold_kernel", "twopass_colsum_kernel"),
    "atb_kernel (the weight-gradient products of the WMMA backwards)": ("atb_kernel",),
    "projective_gather": ("gather_fwd_kernel",),
    "projective_gather_bwd": ("gather_bin_kernel", "gather_pixel_kernel", "gather_coord_kernel"),
    "projective_gather_simt": ("gather_kernel",),
    "projective_gather_bwd_simt": ("gather_bwd_kernel",),
    "rect_attention_fwd": ("rect_fwd_hopper_kernel",),
    "rect_attention_fwd_wmma": ("rect_attn_fwd_kernel",),
    "rect_attention_bwd": ("rect_bwd_hopper_kernel",),
    "rect_attention_bwd_wmma": ("rect_attn_bwd_kernel",),
    "fused_unpool_mlp": ("unpool_mlp_cluster_kernel",),
    "fused_unpool_mlp_wmma": ("unpool_mlp_kernel",),
    "folded_pool_layer": ("pool_layer_pass_kernel", "pool_layer_merge_kernel",
                          "pool_layer_sum_kernel"),
    "folded_pool_layer_wmma": ("pool_layer_kernel",),
    "pool_layer_sums/stats/norm_kernel (the resident pool bodies' shared pre-norm)": (
        "pool_layer_sums_kernel", "pool_layer_stats_kernel", "pool_layer_norm_kernel"),
    "folded_pool_layer_bwd": ("layer_bwd_dpool_kernel", "layer_bwd_t_kernel",
                              "layer_bwd_pass_kernel", "layer_bwd_dy_kernel",
                              "layer_bwd_dx_kernel"),
    "folded_pool_layer_bwd_wmma": ("pool_layer_bwd_fold_kernel", "pool_layer_bwd_kernel",
                                   "pool_layer_bwd_dx_kernel"),
    "the fp32 routes' SIMT kernels (csrc/f32_simt.cu)": (
        "gemm_kernel", "softmax_kernel", "softmax_rows_kernel", "softmax_bwd_kernel",
        "softmax_bwd_rows_kernel", "reduce_kernel", "affine_kernel"),
}
PROFILE_STEPS = 3
# cuDNN's and PyTorch's convolution kernels and cuDNN's layout transforms
# (the ConvNeXt's), by name; cuBLAS's GEMMs ("..._xmma_gemm_...") are not
CONV_KERNEL = re.compile(r"conv|cudnn|fprop|dgrad|wgrad|depthwise|nchw|nhwc", re.IGNORECASE)


def kernel_function(name: str) -> str:
    """The function's identifier in a demangled kernel name."""
    ids = [m for m in re.findall(r"(\w+)(?:<[^()]*>)?\(", name) if m != "void"]
    return ids[0] if ids else name


def device_events(run, n, device) -> tuple:
    """``n`` calls of ``run`` under ``torch.profiler`` -> (wall ms per call,
    the profiler's own overhead included; {device event name: ms per
    call}), the device's own events (kernels, copies) only: a host-side
    range (an aten op, an autograd Function) also carries the device time of
    the kernels it launched as its "self" time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    events = {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if evt.device_type == DeviceType.CUDA and us > 0:
            events[evt.key] = events.get(evt.key, 0.0) + us / 1e3 / n
    return wall_ms, events


def profile_steps(run, n, device):
    """``n`` train steps under ``torch.profiler``: device time per wrapper's
    kernels, the rest (PyTorch's own kernels: the plain glue, the h-side
    backward, the optimizer) by name, and the device's busy share of the
    wall time (the profiler's own overhead included in the wall time).
    Returns the device's busy milliseconds per step (None without device
    events)."""
    wall_ms, events = device_events(run, n, device)
    owner = {f: k for k, fs in KERNEL_FUNCTIONS.items() for f in fs}
    groups, other = {}, {}
    for key, ms in events.items():
        k = owner.get(kernel_function(key))
        if k is None:
            other[key] = other.get(key, 0.0) + ms
        else:
            groups[k] = groups.get(k, 0.0) + ms
    total = sum(groups.values()) + sum(other.values())
    print(f"  profile of {n} steps (torch.profiler): {wall_ms:.3f} ms/step wall, device busy "
          f"{total:.3f} ms/step ({100 * total / wall_ms:.1f}% of the wall time)")
    if total == 0:
        print("  (no device time recorded)")
        return None
    for k, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.3f} ms/step  {100 * ms / total:5.1f}%  {k}")
    rest = sum(other.values())
    print(f"    {rest:9.3f} ms/step  {100 * rest / total:5.1f}%  PyTorch's own kernels, of which:")
    for k, ms in sorted(other.items(), key=lambda kv: -kv[1])[:10]:
        print(f"      {ms:9.3f} ms/step  {k[:100]}")
    gather = sum(v for k, v in groups.items() if k in GATHER_KERNELS)
    conv = sum(v for k, v in other.items() if CONV_KERNEL.search(k))
    split = {"projective gather": gather, "set-transformer kernels": sum(groups.values()) - gather,
             "convolutions (the ConvNeXt)": conv, "the rest": rest - conv}
    print("  split: " + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                                  for k, v in split.items()))
    return total


def build_flagship(device, generator, n_layers, dt=torch.bfloat16, attn_impl="folded_pallas",
                   n_steps=N_STEPS, dims=FLAGSHIP):
    f = dims
    backbone = SetTransformer(
        n_layers, f["feature_dim"], f["num_inducers"], embed_dim=1, num_heads=f["num_heads"],
        compute_dtype=dt, attn_impl=attn_impl, device=device, generator=generator,
    )
    net = UnconditionalPointNetwork(backbone, f["feature_dim"], device=device, generator=generator)
    sched = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=n_steps)
    return Diffusion(net, sched, reparam=GaussianReparam([0.0] * 3, [0.35] * 3, device=device))


def build_conditional(device, generator, n_layers, dt=torch.bfloat16):
    """The image-conditional model of configs/shapenet_vol_conditional.py:
    UVL reparam, ConvNeXt-tiny (three stages), RayNetwork with the gather
    kernels over the 6 x 384 backbone with remat."""
    f = FLAGSHIP
    reparam = UVLReparam(device=device)
    backbone = SetTransformer(
        n_layers, f["feature_dim"], f["num_inducers"], embed_dim=1, num_heads=f["num_heads"],
        compute_dtype=dt, attn_impl="folded_pallas", remat=True, device=device,
        generator=generator,
    )
    net = RayNetwork(backbone, reparam, f["feature_dim"], sum(CTX_DIMS), lookup_impl="pallas",
                     device=device, generator=generator)
    cond = ConvNeXtExtractor(dt, device=device, generator=generator)
    # move each block's layer scale off its 1e-6 init (as the CPU parity
    # tests do), so that the blocks, not only the stem and downsamples,
    # shape the pyramid and its gradient
    for name, p in cond.named_parameters():
        if name.endswith("layer_scale"):
            with torch.no_grad():
                p.add_(0.3 * torch.randn(p.shape, generator=generator).to(device))
    sched = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=N_STEPS)
    return Diffusion(net, sched, reparam=reparam, cond=cond)


def set_path(model, fused: bool, impl: str = "folded_pallas") -> None:
    """The kernel path (the set transformer on ``impl``, and the gather
    where the network looks up a pyramid) or the plain path."""
    model.network.backbone.attn_impl = impl if fused else "xla"
    if hasattr(model.network, "lookup_impl"):
        model.network.lookup_impl = "pallas" if fused else "xla"


def conditional_batches(device, count, batch, n_points, image_size, seed):
    """Procedural conditional batches on the device: (points, Context3d)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        pts, images, K = make_conditional_batch(rng, batch, n_points, image_size)
        out.append((torch.from_numpy(pts).to(device),
                    Context3d(image=torch.from_numpy(images).to(device),
                              K=torch.from_numpy(K).to(device))))
    return out


def conditional_sample_path(device, batch, n_points, n_layers, n_steps, image_size,
                            compare_batch, reps):
    """The conditional sampler through ``Diffusion.sample``: the ConvNeXt
    once, the gather at every evaluation; then the kernel path against the
    plain path from one latent, in diffusion space."""
    model = build_conditional(device, torch.Generator().manual_seed(0), n_layers)
    (_, raw), = conditional_batches(device, 1, batch, n_points, image_size, seed=0)
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (batch, n_points, 3)
    model.sample(gen, shape, raw_ctx=raw, n_solver_steps=2)  # warm-up
    with torch.no_grad():
        convnext_ms = time_ms(lambda: model.cond(raw), device, reps)
    sync(device)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.sample(gen, shape, raw_ctx=raw, n_solver_steps=n_steps, return_details=True)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()

    for name in ("sample_diff", "sample_data"):
        v = getattr(out, name)
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: shape {tuple(v.shape)} or non-finite values")
    evals = 2 * (n_steps - 1)
    eval_ms = (1e3 * seconds - convnext_ms) / evals
    print(f"  sampled {shape} in {seconds:.3f} s: {batch / seconds:.3f} clouds/s; ConvNeXt "
          f"{convnext_ms:.3f} ms per batch of {batch} images (once per call); {evals} denoiser "
          f"evals, {eval_ms:.3f} ms each")
    expected = {k: n_layers * evals for k in SET_FORWARD}
    check_counts("conditional sampler", counts,
                 expected_counts(dict(expected, projective_gather=evals)), device)

    latent = model.schedule.sample_latent(gen, (compare_batch, n_points, 3), device)
    small = Context3d(image=raw.image[:compare_batch], K=raw.K[:compare_batch])
    diffs = []
    for fused in (True, False):
        set_path(model, fused)
        diffs.append(model.sample_from_latent(latent, raw_ctx=small, n_solver_steps=8,
                                              return_details=True).sample_diff)
    set_path(model, True)
    check("8-step conditional sample (diffusion space), kernel path vs plain path",
          rel_err(*diffs), TOL_PATH)
    return counts, dict(batch=batch, seconds=seconds, clouds_per_s=batch / seconds,
                        convnext_ms=convnext_ms, eval_ms=eval_ms)


def conditional_train_phase(device, n_layers, batch, n_points, image_size, card, steps):
    """The conditional train step: the gradient of the kernel path against
    the plain path, then ``steps`` = (warm-up, timed) steps with the
    config's optimizer; returns the launch counts of the timed steps and a
    record."""
    warmup, timed = steps
    model = build_conditional(device, torch.Generator().manual_seed(0), n_layers)
    gen = torch.Generator(device=device).manual_seed(1)
    data = conditional_batches(device, 2, batch, n_points, image_size, seed=1)

    pts, raw = data[0]
    sigma, noise = model.draw_sigma_noise(gen, pts)
    compare_grads(model, lambda: model.loss_from(pts, sigma, noise, raw), TOL_TRAIN_GRAD)

    ema = make_ema(model)
    opt = conditional_optimizer()
    opt_state = opt.init(list(model.parameters()))
    step = make_train_step(opt, ema_alpha=0.999)

    def run(q):
        nonlocal opt_state
        pts, raw = data[q % len(data)]
        loss, opt_state = step(model, ema, opt_state, pts, gen, raw_ctx=raw)
        return loss

    for q in range(warmup):
        run(q)
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [run(q) for q in range(timed)]
    sync(device)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses = [float(v) for v in losses]
    ms = 1e3 * seconds / timed
    print(f"  {timed} steps at batch {batch}: {ms:.3f} ms/step, "
          f"{batch * timed / seconds:.3f} clouds/s trained on {card}")
    print(f"  losses: {' '.join(f'{v:.4f}' for v in losses)}")
    check_finite(losses, model, ema)
    # remat: every set-transformer forward kernel runs again in the backward
    expected = {k: 2 * n_layers * timed for k in SET_FORWARD}
    expected.update({k: n_layers * timed for k in FOLDED_BACKWARD})
    expected.update({k: timed for k in GATHER})
    check_counts("conditional training", counts, expected_counts(expected), device)
    profile_steps(lambda: run(0), PROFILE_STEPS, device)

    # the ConvNeXt alone, forward and backward at the step's batch (its
    # LayerNorms, GELUs and GEMMs too, which the profile's split leaves in
    # "the rest")
    def convnext_step():
        feats = model.cond(data[0][1]).features
        torch.autograd.backward(feats, [torch.ones_like(f) for f in feats])

    convnext_ms = time_ms(convnext_step, device, reps=5, warmup=1)
    model.zero_grad(set_to_none=True)
    print(f"  the ConvNeXt alone: forward + backward {convnext_ms:.3f} ms per batch of {batch}")
    return counts, dict(ms_per_step=ms, losses=losses, convnext_ms=convnext_ms)


def main_path(device, batch, n_points, n_layers, n_steps, compare_batch,
              attn_impl="folded_pallas", what="kernel path", expect=None, dims=FLAGSHIP):
    """The flagship (or the model of ``dims``) on ``attn_impl`` samples
    through ``Diffusion.sample``;
    ``expect(evals)`` gives the launch counts the sample must show (by
    default each set-transformer forward kernel once per layer and
    evaluation); then the 8-step sample against the plain path. Returns
    the counts, a record, the model and the 8-step latent and sample."""
    model = build_flagship(device, torch.Generator().manual_seed(0), n_layers,
                           attn_impl=attn_impl, dims=dims)
    gen = torch.Generator(device=device).manual_seed(0)
    # warm-up: one 2-step sample (first launches, allocator)
    model.sample(gen, (batch, n_points, 3), n_solver_steps=2)
    sync(device)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.sample(gen, (batch, n_points, 3), n_solver_steps=n_steps)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()

    if tuple(out.shape) != (batch, n_points, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sample: shape {tuple(out.shape)} or non-finite values")
    evals = 2 * (n_steps - 1)
    eval_ms = 1e3 * seconds / evals
    print(f"  sampled {tuple(out.shape)} in {seconds:.3f} s: {batch / seconds:.3f} clouds/s "
          f"({evals} denoiser evals, {eval_ms:.3f} ms each)")
    expected = expect(evals) if expect else {k: n_layers * evals for k in SET_FORWARD}
    check_counts(f"{attn_impl} sampler", counts, expected_counts(expected), device)

    latent = model.schedule.sample_latent(gen, (compare_batch, n_points, 3), device)
    fused = model.sample_from_latent(latent, n_solver_steps=8)
    set_path(model, False)
    plain = model.sample_from_latent(latent, n_solver_steps=8)
    set_path(model, True, attn_impl)
    check(f"8-step sample, {what} vs plain path", rel_err(fused, plain), TOL_PATH)
    return counts, dict(batch=batch, seconds=seconds, clouds_per_s=batch / seconds,
                        eval_ms=eval_ms), (model, latent, fused)


def megakernel_path(device, batch, n_points, n_layers, n_steps, compare_batch, demo_dims,
                    demo_batch):
    """The folded flagship sampler with ``GECCO_UNPOOL_MLP_MEGAKERNEL=1``
    set in this process (restored after): per sample the megakernel's
    Hopper body, the pool and the h-side once per layer and evaluation, its
    WMMA body and the separate unpool and MLP never; then the upsample
    demo's model (C 128, whose shapes only the WMMA body takes) the same
    way with the WMMA body. Each 8-step sample against the plain path, then
    against the separate kernels' path from the same latent. Returns the
    flagship's counts and record and the demo's counts and record."""
    key = "GECCO_UNPOOL_MLP_MEGAKERNEL"
    before = os.environ.get(key)
    os.environ[key] = "1"
    runs = {}
    what = {"flagship": "megakernel path", "demo model": "the demo model's megakernel path"}
    try:
        for name, b, dims, body in (("flagship", batch, FLAGSHIP, "fused_unpool_mlp"),
                                    ("demo model", demo_batch, demo_dims,
                                     "fused_unpool_mlp_wmma")):
            layers = n_layers if name == "flagship" else dims["n_layers"]
            runs[name] = main_path(
                device, b, n_points if name == "flagship" else dims["n_points"], layers, n_steps,
                compare_batch, what=what[name], dims=dims,
                expect=lambda evals, layers=layers, body=body: {
                    k: layers * evals for k in ("folded_pool_ext", "fused_h_side", body)})
            print(f"  {name}: {runs[name][1]['clouds_per_s']:.3f} clouds/s (batch {b})")
        os.environ.pop(key)
        separate = {name: model.sample_from_latent(latent, n_solver_steps=8)
                    for name, (_, _, (model, latent, _)) in runs.items()}
    finally:
        if before is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = before
    for name, (_, _, (_, _, mega)) in runs.items():
        check(f"8-step sample, {what[name]} vs the separate kernels' path",
              rel_err(mega, separate[name]), TOL_MEGA_PATH)
    return (*runs["flagship"][:2], *runs["demo model"][:2])


def sampler_run(what, run, device, shape, expected) -> tuple:
    """One sampler call on a clean count: finite clouds of ``shape``, the
    launch counts ``expected`` exactly -> (clouds, counts, seconds)."""
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    sync(device)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if tuple(out.shape) != tuple(shape) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: shape {tuple(out.shape)} or non-finite values")
    check_counts(what, counts, expected_counts(expected), device)
    print(f"  {what}: {tuple(out.shape)} in {seconds:.3f} s, {shape[0] / seconds:.3f} clouds/s")
    return out, counts, seconds


def both_paths(model, run, fused_impl="folded_pallas") -> list:
    """``run()`` on the kernel path, then on the plain path (set back after)."""
    outs = []
    for fused in (True, False):
        set_path(model, fused, fused_impl)
        outs.append(run())
    set_path(model, True, fused_impl)
    return outs


def samplers_phase(device, batch, cond_batch, n_points, n_layers, n_steps, image_size,
                   compare_batch, compare_steps=8) -> dict:
    """Phase 23: the flagship's stochastic sampler (churn 0.5, the extended
    grid: 2 (n_steps - 1) + 1 evaluations), inpainting (1024 known points
    completed by n_points - 1024, 2 substeps, churn 0.5: twice that),
    ``sample(..., temperature=0.8)`` on a ``compare_steps`` grid and ``score``, each
    forward kernel launched once per layer and evaluation and no other
    kernel; then the conditional model's stochastic sampler (the ConvNeXt
    once, the gather once per evaluation). Each against the plain path from
    the same generator seed (the same draws) on a ``compare_steps`` grid
    at ``compare_batch``. Returns the wall times and clouds/s."""
    model = build_flagship(device, torch.Generator().manual_seed(0), n_layers, n_steps=n_steps)
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (batch, n_points, 3)
    model.sample_stochastic(gen, shape, s_churn=0.5, n_solver_steps=2)  # warm-up
    evals = 2 * (n_steps - 1) + 1
    forward = lambda e, layers=n_layers: {k: layers * e for k in SET_FORWARD}
    rec = {}
    _, _, sec = sampler_run("flagship sample_stochastic", lambda: model.sample_stochastic(
        gen, shape, s_churn=0.5), device, shape, forward(evals))
    rec["stochastic"] = dict(batch=batch, seconds=sec, clouds_per_s=batch / sec, evals=evals)

    rng = np.random.default_rng(6)
    known_n = min(INPAINT_KNOWN, n_points // 2)
    known = torch.from_numpy(make_clouds(rng, batch, known_n)).to(device)
    m_new = n_points - known_n
    _, _, sec = sampler_run("flagship sample_inpaint", lambda: model.sample_inpaint(
        gen, known, m_new, s_churn=0.5, n_substeps=2), device, (batch, m_new, 3),
        forward(2 * evals))
    rec["inpaint"] = dict(batch=batch, seconds=sec, clouds_per_s=batch / sec, evals=2 * evals,
                          known=known_n, new=m_new)

    out, _, sec = sampler_run(
        f"flagship sample(temperature=0.8), {compare_steps} steps", lambda: model.sample(
            gen, shape, n_solver_steps=compare_steps, temperature=0.8), device, shape,
        forward(2 * (compare_steps - 1)))
    details = model.sample(torch.Generator(device=device).manual_seed(4), (2, n_points, 3),
                           n_solver_steps=2, temperature=0.8, return_details=True)
    latent = model.schedule.sample_latent(torch.Generator(device=device).manual_seed(4),
                                          (2, n_points, 3), device)
    if not torch.equal(details.latent, 0.8 * latent):
        raise AssertionError("sample(temperature=0.8) did not draw 0.8 times the latent")

    x = model.reparam.data_to_diffusion(out, None)
    with torch.no_grad():
        sync(device)
        kernels.reset_launch_counts()
        score = model.score(1.0, x)
        sync(device)
        check_counts("flagship score", kernels.launch_counts(), expected_counts(forward(1)),
                     device)
        plain = both_paths(model, lambda: model.score(1.0, x))[1]
    check("score at sigma 1 of the tempered clouds, kernel path vs plain path",
          rel_err(score, plain), TOL_OUT)

    cb = compare_batch
    full = model.schedule
    model.schedule = dataclasses.replace(full, n_solver_steps=compare_steps)
    seeded = lambda: torch.Generator(device=device).manual_seed(3)
    for what, run in (
            ("sample_stochastic", lambda: model.sample_stochastic(seeded(), (cb, n_points, 3),
                                                                  s_churn=0.5)),
            ("sample_inpaint", lambda: model.sample_inpaint(seeded(), known[:cb], m_new,
                                                            s_churn=0.5, n_substeps=2)),
            ("sample(temperature=0.8)", lambda: model.sample(seeded(), (cb, n_points, 3),
                                                             temperature=0.8))):
        check(f"{compare_steps}-step {what} of {cb} clouds, kernel path vs plain path",
              rel_err(*both_paths(model, run)), TOL_PATH)
    model.schedule = full
    del model

    cond = build_conditional(device, torch.Generator().manual_seed(0), n_layers)
    cond.schedule = dataclasses.replace(cond.schedule, n_solver_steps=n_steps)
    (_, raw), = conditional_batches(device, 1, cond_batch, n_points, image_size, seed=5)
    cshape = (cond_batch, n_points, 3)
    cond.sample_stochastic(gen, cshape, raw_ctx=raw, s_churn=0.5, n_solver_steps=2)  # warm-up
    calls = []
    hook = cond.cond.register_forward_hook(lambda *a: calls.append(1))
    _, _, sec = sampler_run("conditional sample_stochastic", lambda: cond.sample_stochastic(
        gen, cshape, raw_ctx=raw, s_churn=0.5), device, cshape,
        dict(forward(evals), projective_gather=evals))
    hook.remove()
    if len(calls) != 1:
        raise AssertionError(f"the ConvNeXt ran {len(calls)} times in one sample_stochastic")
    rec["conditional_stochastic"] = dict(batch=cond_batch, seconds=sec,
                                         clouds_per_s=cond_batch / sec, evals=evals)
    small = Context3d(image=raw.image[:cb], K=raw.K[:cb])
    outs = both_paths(cond, lambda: cond.sample_stochastic(seeded(), (cb, n_points, 3),
                                                           raw_ctx=small, s_churn=0.5,
                                                           n_solver_steps=compare_steps))
    diffs = [cond.reparam.data_to_diffusion(o, small) for o in outs]
    check(f"{compare_steps}-step conditional sample_stochastic (diffusion space), kernel path "
          "vs plain path",
          rel_err(*diffs), TOL_PATH)
    return rec


# the logp profile's classes, by kernel function (KERNEL_FUNCTIONS' names)
WGRAD_FUNCTIONS = ("wgrad_kernel", "wgrad_sum_kernel")
LOGP_CLASSES = {
    "forward kernels": ("folded_pool_ext", "fused_h_side", "folded_unpool",
                        "fused_mlp_residual",
                        "unpool_bq/fold_k/fold_v_kernel (the Hopper unpool's and the "
                        "megakernel's shared fold)"),
    "backward kernels": ("folded_pool_ext_bwd", "pool_bwd_fold_kernel (the pool backwards' fold)",
                         "folded_unpool_bwd",
                         "unpool_bwd_fold_kernel (the unpool backwards' fold)",
                         "fused_mlp_residual_bwd"),
    "gather": GATHER_KERNELS,
}


def logp_profile(run, device) -> dict:
    """One likelihood batch under ``torch.profiler``: device ms by class.
    The backward kernels' weight-gradient passes (``wgrad.cuh``: dqf, dkf,
    dvf, dw1t, dw2t) apart from their other passes; ``prenorm_kernel``
    (the backwards' pre-norm) with the backward kernels; the MLP bodies'
    column sums (the forward's channel sums, the backward's bias and
    affine gradients) in a class of their own; PyTorch's own kernels (the
    glue, the h-side's backward, the ConvNeXt) the rest."""
    wall_ms, events = device_events(run, 1, device)
    owner = {f: cls for cls, names in LOGP_CLASSES.items() for k in names
             for f in KERNEL_FUNCTIONS[k]}
    owner.update({f: "backward kernels: weight-gradient passes (wgrad.cuh)"
                  for f in WGRAD_FUNCTIONS})
    owner["prenorm_kernel"] = "backward kernels"
    owner["mlp_colsum_kernel"] = "MLP column sums (forward sums, backward bias gradients)"
    split = {}
    for key, ms in events.items():
        cls = owner.get(kernel_function(key), "PyTorch's own kernels")
        split[cls] = split.get(cls, 0.0) + ms
    total = sum(split.values())
    print(f"  profile of one batch (torch.profiler): {wall_ms:.1f} ms wall, device busy "
          f"{total:.1f} ms")
    if total == 0:
        print("  (no device time recorded)")
        return {}
    for cls, ms in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:10.1f} ms  {100 * ms / total:5.1f}%  {cls}")
    return dict(wall_ms=wall_ms, device_ms=total, split_ms=split)


def logp_field_err(field, a, ref, sigmas) -> float:
    """One ``LogpDetails`` field of ``a`` against ``ref``: max |a - ref| over
    the entries finite in both (their non-finite entries must agree), to
    max |ref|; logp to the largest sum of its terms' magnitudes;
    trajectory_data on the states at sigma <= 1 (``sigmas``: the
    trajectory's)."""
    x, r = getattr(a, field), getattr(ref, field)
    if field == "trajectory_data":
        keep = sigmas <= 1.0
        x, r = x[keep], r[keep]
    finite = torch.isfinite(r)
    if not torch.equal(torch.isfinite(x), finite):
        raise AssertionError(f"likelihood {field}: the paths' non-finite entries differ")
    err = float((x[finite] - r[finite]).abs().max())
    if field == "logp":
        scale = ref.prior_logp.abs() + ref.delta_jacobian.abs() + ref.delta_reparam.abs()
    else:
        scale = r[finite].abs()
    return err / max(float(scale.max()), 1e-30)


def logp_phase(device, batch, n_points, n_layers, n_steps, image_size, compare_batch) -> dict:
    """Phase 24: ``LogpMetric(n_solver_steps=n_steps)`` (``evaluate_logp``)
    on one batch of the flagship and of the conditional model (remat): per
    evaluation each forward kernel once per layer (twice under remat), each
    backward kernel once per layer, the conditional model's gather forward
    and its Hopper backward with the coordinate gradient once, the ConvNeXt
    once a batch; no parameter gets a ``.grad``; then each path against the
    plain path from one Rademacher draw on a 4-step grid at
    ``compare_batch``, every ``LogpDetails`` field within ``TOL_LOGP``
    (``logp_field_err``), the plain path in fp32 printed beside as the
    witness of both. Returns seconds per batch and the profile's split, by
    model."""
    pgm = sys.modules[_gather_body.__module__]
    evals = 2 * (n_steps - 1)
    metric = LogpMetric(n_solver_steps=n_steps)
    rec = {}
    for name in ("flagship", "conditional"):
        conditional = name == "conditional"
        if conditional:
            model = build_conditional(device, torch.Generator().manual_seed(0), n_layers)
            (data, raw), = conditional_batches(device, 1, batch, n_points, image_size, seed=6)
            small = Context3d(image=raw.image[:compare_batch], K=raw.K[:compare_batch])
        else:
            model = build_flagship(device, torch.Generator().manual_seed(0), n_layers)
            data = torch.from_numpy(make_clouds(np.random.default_rng(7), batch, n_points))
            data, raw, small = data.to(device), None, None
        gen = torch.Generator(device=device).manual_seed(0)
        if device.type == "cuda":
            model.evaluate_logp(gen, data, raw_ctx=raw, n_solver_steps=2)  # warm-up
        calls, coords = [], []
        hook = model.cond.register_forward_hook(lambda *a: calls.append(1))
        real = pgm._gather_bwd_hopper

        def spy(levels, hw01, g, coords_grad=True):
            coords.append(coords_grad)
            return real(levels, hw01, g, coords_grad)

        pgm._gather_bwd_hopper = spy
        try:
            sync(device)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            terms = metric(model, data, raw, gen)
            sync(device)
            seconds = time.perf_counter() - t0
            counts = kernels.launch_counts()
        finally:
            pgm._gather_bwd_hopper = real
            hook.remove()
        layers_fwd = 2 * n_layers if conditional else n_layers
        expected = {k: layers_fwd * evals for k in SET_FORWARD}
        expected.update({k: n_layers * evals for k in FOLDED_BACKWARD})
        if conditional:
            expected.update(projective_gather=evals, projective_gather_bwd=evals)
        check_counts(f"{name} likelihood", counts, expected_counts(expected), device)
        if device.type == "cuda" and coords != [True] * (evals if conditional else 0):
            raise AssertionError(f"{name} likelihood: the Hopper gather backward's coordinate "
                                 f"gradient flags {coords}")
        if conditional and len(calls) != 1:
            raise AssertionError(f"the ConvNeXt ran {len(calls)} times in one likelihood batch")
        for k, v in terms.items():
            if tuple(v.shape) != (batch,) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{name} likelihood {k}: {v}")
        if any(p.grad is not None for p in model.parameters()):
            raise AssertionError(f"{name} likelihood wrote a parameter's .grad")
        print(f"  {name}: LogpMetric(n_solver_steps={n_steps}) of {batch} clouds in "
              f"{seconds:.3f} s ({evals} evaluations and VJPs; total logp mean "
              f"{float(terms['total'].mean()):.1f}, det-jac {float(terms['det-jac'].mean()):.1f})")
        prof = (logp_profile(lambda: metric(model, data, raw, gen), device)
                if device.type == "cuda" else {})

        eps = torch.randint(0, 2, (1, compare_batch, n_points, 3), device=device,
                            generator=torch.Generator(device=device).manual_seed(8))
        eps = (2.0 * eps - 1.0)
        run = lambda m: m.evaluate_logp_from(data[:compare_batch], eps, raw_ctx=small,
                                             n_solver_steps=4, return_details=True)
        kernel, plain = both_paths(model, lambda: run(model))
        if any(p.grad is not None for p in model.parameters()):
            raise AssertionError(f"{name} likelihood wrote a parameter's .grad")
        # the trajectory's states: after each transition of the increasing grid
        sigmas = model.schedule.solver_grid(4, device=device).flip(0)[1:]
        del model
        build = build_conditional if conditional else build_flagship
        witness = build(device, torch.Generator().manual_seed(0), n_layers, dt=torch.float32)
        set_path(witness, False)
        fp32 = run(witness)
        del witness
        failed = []
        for field, tol in TOL_LOGP.items():
            errs = [logp_field_err(field, d, plain, sigmas) for d in (kernel, fp32)]
            errs.append(logp_field_err(field, plain, fp32, sigmas))
            ok = errs[0] <= tol
            failed += [] if ok else [field]
            print(f"  {name} 4-step likelihood {field}, kernel path vs plain path: {errs[0]:.3e} "
                  f"(tol {tol:.0e}) {'ok' if ok else 'FAIL'}; the fp32 plain path vs the kernel "
                  f"path {logp_field_err(field, kernel, fp32, sigmas):.3e}, vs the bf16 plain "
                  f"path {errs[2]:.3e}")
        if failed:
            raise AssertionError(f"{name} likelihood, kernel path vs plain path: {failed}")
        rec[name] = dict(batch=batch, seconds=seconds, evals=evals, counts=counts, **prof)
    return rec



# ----------------------------------------------- phase 25: the fp32 route --

# the eleven wrappers that count an fp32 route (csrc/f32_simt.cu), each
# under ``<name>_f32`` in the kernels line; which TPU kernel each replaces.
# The megakernel's fp32 case runs the unpool's and the MLP's routes
# (F32_MEGA_CHECK)
F32_WRAPPERS = ("rect_attention_fwd", "rect_attention_bwd", "folded_pool_ext", "fused_h_side",
                "folded_unpool", "fused_mlp_residual", "folded_pool_ext_bwd",
                "folded_unpool_bwd", "fused_mlp_residual_bwd", "folded_pool_layer",
                "folded_pool_layer_bwd")
F32_MEGA_CHECK = "fused_unpool_mlp"
# Each output of an fp32 route is held two ways:
# - the JAX tests' fp32 tolerance, |err| <= atol + rtol |ref| elementwise,
#   rtol 1e-4, atol 1e-5 or 2e-5 of max |ref| on drifted operands, against
#   the plain version in fp32 or in fp64 (``fp64_plain``), whichever reads
#   lower: where the route is nearer exact than the fp32 plain version,
#   their difference is that version's own error. Not for the channel sums
#   (F32_SUMS) and the gradients of ordinary operands: they sum over 2048
#   to 16384 rows, where no fp32 order comes within 1e-5 of the exact sum;
# - every output, the witness: the route's largest error against the fp64
#   plain version at most F32_WITNESS times the fp32 plain version's own
#   (both are fixed-order fp32 sums, the route's in runs of 64).
F32_RTOL, F32_ATOL, F32_SHARE, F32_WITNESS = 1e-4, 1e-5, 2e-5, 4.0
# the wrappers whose second output is the channel sums of the first over
# the points
F32_SUMS = ("folded_unpool", "fused_mlp_residual", "fused_unpool_mlp")
# an fp32 model's 8-step sample, the kernel path (the fp32 route) against
# the plain path: fp32 sums in other orders through every layer and step
# (chip readings 8.8e-8 to 8.6e-7 of max |ref|)
TOL_F32_PATH = 1e-5


class _Fp64Plain(torch.overrides.TorchFunctionMode):
    """The plain versions with fp32 promoted to fp64: their fp32 casts
    (``.float()``, ``.to(torch.float32)``) and fp32 buffers become fp64,
    and any op that still yields a narrower float is recorded."""

    def __init__(self):
        super().__init__()
        self.narrow = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        wide = lambda a: torch.float64 if a is torch.float32 else a
        if func is torch.Tensor.float and args[0].dtype == torch.float64:
            return args[0]
        if func is torch.Tensor.to:
            args = tuple(wide(a) for a in args)
        if "dtype" in kwargs:
            kwargs["dtype"] = wide(kwargs["dtype"])
        out = func(*args, **kwargs)
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if torch.is_tensor(t) and t.is_floating_point() and t.dtype != torch.float64:
                self.narrow.add(f"{getattr(func, '__name__', func)} -> {t.dtype}")
        return out


def fp64_plain(fn, *args):
    """``fn`` (a plain version) on fp64 copies of ``args``' float tensors,
    its fp32 arithmetic in fp64 (``_Fp64Plain``): the witness of how far
    an fp32 result is from exact. Raises where an op stays narrower."""
    wide = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    mode = _Fp64Plain()
    with mode:
        out = fn(*wide)
    if mode.narrow:
        raise AssertionError(f"fp64 witness of {getattr(fn, '__name__', fn)}: "
                             f"{sorted(mode.narrow)}")
    return out


def f32_close(name, got, ref, ref64, drift: bool, grads=False, sums=False) -> float:
    """Each output of ``got`` (the route) held to the tolerance against
    ``ref`` (the plain version in fp32) or ``ref64`` (in fp64), atol
    F32_SHARE of max |ref| where ``drift``, except on ordinary operands the
    gradients (``grads``: every output) and the channel sums (``sums``: the
    second output); and every output to the witness, F32_WITNESS times the
    fp32 plain version's largest error against ``ref64``. Returns the
    largest absolute error against the fp32 plain version outside the
    channel sums."""
    as_list = lambda t: list(t) if isinstance(t, (tuple, list)) else [t]
    worst = 0.0
    for q, (a, r, r64) in enumerate(zip(as_list(got), as_list(ref), as_list(ref64))):
        a, r, r64 = a.float(), r.float(), r64.double()
        atol = max(F32_ATOL, F32_SHARE * float(r.abs().max())) if drift else F32_ATOL
        ratio = lambda want: (float(((a.double() - want.double()).abs()
                                     / (atol + F32_RTOL * want.double().abs())).max())
                              if r.numel() else 0.0)
        r32, r64_ = ratio(r), ratio(r64)
        e_route = float((a.double() - r64).abs().max()) if r.numel() else 0.0
        e_plain = float((r.double() - r64).abs().max()) if r.numel() else 0.0
        times = e_route / e_plain if e_plain else (0.0 if e_route == 0 else float("inf"))
        toleranced = drift or not (grads or (sums and q == 1))
        ok = times <= F32_WITNESS and (min(r32, r64_) <= 1.0 or not toleranced)
        print(f"  {name} out{q}: max |err| / (atol {atol:.1e} + rtol |ref|) = {r32:.3e} against "
              f"fp32, {r64_:.3e} against fp64 ({'limit 1' if toleranced else 'not held'}); "
              f"largest error against fp64: route {e_route:.3e}, plain fp32 {e_plain:.3e}, "
              f"{times:.3f}x (limit {F32_WITNESS:g}x) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} out{q}: {times:.3f}x the plain fp32 version's error "
                                 f"against fp64; max |err| / (atol + rtol |ref|) {r32:.3e} "
                                 f"against fp32, {r64_:.3e} against fp64")
        if not (sums and q == 1):  # as phase 3, the sums' error is not the kernel line's
            worst = max(worst, abs_err(a, r))
    return worst


def f32_cases(device, g, b, n, c, heads, i, groups):
    """name -> (make(dt, drift) -> (run, ref, ref64, tensors), forward
    flops): each wrapper at the shapes given, its operands in ``dt`` (fp32:
    the route; bf16: its bf16 body), ``run`` the wrapper's call, ``ref``
    its plain version's and ``ref64`` the plain version's in fp64 on the
    same operands (``fp64_plain``), ``tensors`` the inputs whose bytes
    bound it."""
    w = 2 * c
    d = c // heads
    j = heads * i

    def cot(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=device))

    def plain(fn, *args):
        """``ref`` and ``ref64``: the plain version ``fn`` on ``args``."""
        return (lambda: fn(*args)), (lambda: fp64_plain(fn, *args))

    def rect(direction, bwd):
        def make(dt, drift):
            q, k, v = attn_operands(g, b, n, c, heads, i, direction, drift, device, dt)
            if not bwd:
                return (lambda: ia.rect_attention_fwd(q, k, v),
                        *plain(ia._rect_attention_ref, q, k, v), [q, k, v])
            o, lse = ia.rect_attention_fwd(q, k, v)
            go = merged_randn(g, o)
            return (lambda: ia.rect_attention_bwd(q, k, v, o, lse, go),
                    *plain(ia._rect_attention_bwd_ref, q, k, v, go), [q, k, v, o, go])
        return make

    def pool(bwd):
        def make(dt, drift):
            ops = pool_operands(g, b, n, c, heads, i, drift, device, dt)
            if not bwd:
                return (lambda: fa.folded_pool_ext(*ops, heads),
                        *plain(fa._pool_ext_ref, *ops, heads), list(ops))
            # the forward's folded query and statistics (on the CPU the
            # plain backward takes none)
            _, qft, macc, sacc = (fa._pool_ext_launch(*ops, heads, True) if device.type == "cuda"
                                  else (None,) * 4)
            gh = cot(b, i, c).to(dt)
            return (lambda: fa.folded_pool_ext_bwd(*ops, qft, macc, sacc, gh, heads),
                    *plain(fa._pool_ext_bwd_ref, *ops, gh, heads), [*ops, gh])
        return make

    def layer(bwd):
        gind = fa.group_indicator(c, groups, device)

        def make(dt, drift):
            ops = pool_operands(g, b, n, c, heads, i, drift, device, dt)
            if not bwd:
                return (lambda: fa.folded_pool_layer(*ops, gind, heads, True),
                        *plain(fa._pool_ref, *ops, groups, heads, True), list(ops))
            h0, mean, inv, saved = (fa._pool_layer_launch(*ops, gind, heads, True, True)
                                    if device.type == "cuda" else (None, None, None, (None,) * 4))
            gs = (cot(b, i, c).to(dt), cot(b, c, scale=1e-2), cot(b, c, scale=1e-2))
            return (lambda: fa.folded_pool_layer_bwd(*ops, gind, mean, inv, *saved, *gs, heads,
                                                     True),
                    *plain(fa._pool_layer_bwd_ref, *ops, gind, *gs, heads, True),
                    [*ops, *gs])
        return make

    def hside(dt, drift):
        ops = hside_operands(g, b, i, c, w, drift, device, dt)
        return (lambda: hs.fused_h_side(*ops), *plain(hs._hside_ref, *ops), list(ops))

    def unpool(bwd):
        def make(dt, drift):
            ops = unpool_operands(g, b, n, c, heads, i, drift, device, dt)
            if not bwd:
                return (lambda: fa.folded_unpool(*ops, heads),
                        *plain(fa._unpool_ref, *ops, heads), list(ops))
            go, gs = cot(b, n, c).to(dt), cot(b, 2, c, scale=1e-2)
            return (lambda: fa.folded_unpool_bwd(*ops, go, gs, heads),
                    *plain(fa._unpool_bwd_ref, *ops, go, gs, heads), [*ops, go, gs])
        return make

    def mlp(bwd):
        def make(dt, drift):
            ops = mlp_operands(g, b, n, c, w, drift, device, dt)
            if not bwd:
                return (lambda: fa.fused_mlp_residual(*ops), *plain(fa._mlp_ref, *ops),
                        list(ops))
            go, gs = cot(b, n, c).to(dt), cot(b, 2, c, scale=1e-2)
            return (lambda: fa.fused_mlp_residual_bwd(*ops, go, gs),
                    *plain(fa._mlp_bwd_ref, *ops, go, gs), [*ops, go, gs])
        return make

    def mega(dt, drift):
        up = unpool_operands(g, b, n, c, heads, i, drift, device, dt)
        ml = mlp_operands(g, b, n, c, w, False, device, dt)[3:]
        sc2, bi2 = 1.0 + 0.2 * cot(b, c), 0.2 * cot(b, c)
        gind = fa.group_indicator(c, groups, device)
        return (lambda: fa.fused_unpool_mlp(*up, sc2, bi2, gind, *ml, heads, groups, n),
                *plain(fa._unpool_mlp_ref, *up, sc2, bi2, *ml, heads, groups, n),
                [*up, sc2, bi2, *ml])

    rect_flops = 4 * b * heads * i * n * d
    pool_flops = 2 * b * n * c * j + 2 * b * n * c * c + 2 * b * n * j * d + 2 * b * i * c * c
    unpool_flops = 4 * b * n * c * j + 4 * b * j * c * d
    mlp_flops = 4 * b * n * c * w
    # a backward's gradient products: twice its forward's
    return {
        "rect_attention_fwd": (rect("pool", False), rect_flops),
        "rect_attention_bwd": (rect("pool", True), 2 * rect_flops),
        "folded_pool_ext": (pool(False), pool_flops),
        "fused_h_side": (hside, 4 * b * i * c * w + 4 * b * i * c * c),
        "folded_unpool": (unpool(False), unpool_flops),
        "fused_mlp_residual": (mlp(False), mlp_flops),
        "folded_pool_ext_bwd": (pool(True), 2 * pool_flops),
        "folded_unpool_bwd": (unpool(True), 2 * unpool_flops),
        "fused_mlp_residual_bwd": (mlp(True), 2 * mlp_flops),
        "folded_pool_layer": (layer(False), pool_flops),
        "folded_pool_layer_bwd": (layer(True), 2 * pool_flops),
        "fused_unpool_mlp": (mega, unpool_flops + mlp_flops),
    }


def f32_library(name, make, heads, g):
    """The one PyTorch call computing the same function, where there is
    one, on the route's fp32 operands: per-head
    ``scaled_dot_product_attention`` (and its backward) for the attentions,
    the pools' and unpools' as phases 3 and 4 time it for their bf16
    bodies."""
    ops = make(torch.float32, False)[-1]
    if name.startswith("rect_attention"):
        q, k, v = ops[:3]
        if name.endswith("bwd"):
            return sdpa_backward(q, k, v, g)
        return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
    if name in ("folded_pool_ext", "folded_pool_layer"):
        return sdpa_pool(ops[:6], heads)
    if name in ("folded_pool_ext_bwd", "folded_pool_layer_bwd"):
        return sdpa_pool_bwd(ops[:6], heads, g)
    if name == "folded_unpool":
        return sdpa_unpool(ops[:7], heads)
    if name == "folded_unpool_bwd":
        return sdpa_unpool_bwd(ops[:7], heads, g)
    return None


def f32_phase(device, shapes, reps, n_layers, batch, n_points, rehearse) -> tuple:
    """Phase 25: every fp32 route against its plain version in fp32 at the
    flagship's shapes (batch ``shapes['batch']``), ordinary and drifted, its
    launch counter advancing; each timed in turns with its bf16 body on bf16
    operands of the same shapes beside the plain version, the bound and the
    library call; the megakernel's fp32 case (the unpool's and the MLP's
    routes) against its plain version; then an fp32 flagship of
    ``n_layers`` layers on
    ``folded_pallas`` and one on the per-head ``pallas`` path each sample 8
    steps (against the plain path) and take 3 train steps, and a
    module-level ``Broadcast`` (the resident pool, forward and gradient)
    and a sums-less layer (its pre-norm) run, all on the fp32 route.
    Returns (records, the launch counts of those model runs)."""
    g = torch.Generator(device=device).manual_seed(25)
    b, n, c, heads, i = (shapes[k] for k in ("batch", "n_points", "feature_dim", "num_heads",
                                             "num_inducers"))
    cases = f32_cases(device, g, b, n, c, heads, i, GROUPS)
    rec = {}
    for name in F32_WRAPPERS:
        make, flops = cases[name]
        errs = []
        for drift in (False, True):
            run, ref, ref64, _ = make(torch.float32, drift)
            before = kernels.launch_counts()[f"{name}_f32"]
            got = run()
            if device.type == "cuda" and kernels.launch_counts()[f"{name}_f32"] != before + 1:
                raise AssertionError(f"{name}: the fp32 route did not run")
            errs.append(f32_close(f"{name} fp32 [{'drift' if drift else 'ordinary'}]", got,
                                  ref(), ref64(), drift, grads=name.endswith("bwd"),
                                  sums=name in F32_SUMS))
        run, ref, _, tensors = make(torch.float32, False)
        run16 = make(torch.bfloat16, False)[0]
        turns = bodies_in_turns(run, run16, device, reps, ("f32", "bf16"))
        ms, ms16 = (statistics.median(turns[k]) for k in ("f32", "bf16"))
        plain_ms = time_ms(ref, device, max(2, reps // 4))
        library = f32_library(name, make, heads, g)
        lib_ms = time_ms(library, device, reps) if library else None
        out = run()
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        bms, by = bound(flops, nbytes(*{id(t): t for t in tensors}.values(),
                                      *[t for t in outs if torch.is_tensor(t)]),
                        PEAK_FP32_FLOPS)
        rec[f"{name}_f32"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                  bound_by=by, library_ms=lib_ms, bf16_body_ms=ms16)
        print(f"  {name}_f32: route {ms:.3f} ms (its bf16 body {ms16:.3f} ms, in turns), plain "
              f"fp32 {plain_ms:.3f} ms, library {fmt_ms(lib_ms)}, bound {bms:.3f} ms ({by})")

    # the megakernel's fp32 case: the unpool's and the MLP's routes, once each
    for drift in (False, True):
        run, ref, ref64, _ = cases[F32_MEGA_CHECK][0](torch.float32, drift)
        before = kernels.launch_counts()
        got = run()
        moved = {k: v - before[k] for k, v in kernels.launch_counts().items() if v != before[k]}
        if device.type == "cuda" and moved != {"folded_unpool_f32": 1,
                                               "fused_mlp_residual_f32": 1}:
            raise AssertionError(f"{F32_MEGA_CHECK} fp32: launches {moved}, expected the "
                                 "unpool's and the MLP's fp32 routes once each")
        f32_close(f"{F32_MEGA_CHECK} fp32 [{'drift' if drift else 'ordinary'}]", got, ref(),
                  ref64(), drift, sums=True)

    counts = {}

    def add(got):
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v

    for impl, what in (("folded_pallas", "fp32 flagship"), ("pallas", "fp32 per-head flagship")):
        model = build_flagship(device, torch.Generator().manual_seed(25), n_layers,
                               dt=torch.float32, attn_impl=impl)
        gen = torch.Generator(device=device).manual_seed(26)
        kernels.reset_launch_counts()
        latent = model.schedule.sample_latent(gen, (batch, n_points, 3), device)
        fused = model.sample_from_latent(latent, n_solver_steps=8)
        sync(device)
        got = kernels.launch_counts()
        evals = 2 * 7
        names = (("rect_attention_fwd",) if impl == "pallas" else
                 ("folded_pool_ext", "fused_h_side", "folded_unpool", "fused_mlp_residual"))
        per_layer = 2 if impl == "pallas" else 1
        check_counts(f"{what} sampler", got, expected_counts(
            {f"{k}_f32": per_layer * n_layers * evals for k in names}), device)
        add(got)
        set_path(model, False)
        plain = model.sample_from_latent(latent, n_solver_steps=8)
        set_path(model, True, impl)
        check(f"{what}: 8-step sample, fp32 route vs plain path", rel_err(fused, plain),
              TOL_F32_PATH)
        opt = flagship_optimizer()
        ema, state = make_ema(model), opt.init(list(model.parameters()))
        step = make_train_step(opt, ema_alpha=0.999)
        data = torch.from_numpy(make_clouds(np.random.default_rng(25), batch, n_points)).to(device)
        kernels.reset_launch_counts()
        losses = []
        for _ in range(3):
            loss, state = step(model, ema, state, data, gen)
            losses.append(float(loss))
        got = kernels.launch_counts()
        bwd = (("rect_attention_bwd",) if impl == "pallas" else
               ("folded_pool_ext_bwd", "folded_unpool_bwd", "fused_mlp_residual_bwd"))
        check_counts(f"{what} training", got, expected_counts(
            {f"{k}_f32": per_layer * n_layers * 3 for k in names + bwd}), device)
        check_finite(losses, model, ema)
        add(got)
        print(f"  {what}: 8-step sample at batch {batch} and 3 train steps (losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}) on the fp32 route")

    gen = torch.Generator().manual_seed(28)
    bc = Broadcast(c, i, 1, heads, device=device, generator=gen)
    layer = BroadcastingLayer(c, i, 1, heads, device=device, generator=gen)
    x = torch.randn(batch, n_points, c, generator=g, device=device)
    embed = 80.0 * torch.rand(batch, 1, generator=g, device=device)
    kernels.reset_launch_counts()
    xg = x.clone().requires_grad_(True)
    out, _ = bc(xg, embed, attn_impl="folded_pallas")
    (out**2).sum().backward()
    with torch.no_grad():
        lay = layer(x, embed, "folded_pallas")[0]
        lay_plain = layer(x, embed, "xla")[0]
    got = kernels.launch_counts()
    check_counts("fp32 module-level Broadcast (forward and gradient) and sums-less layer", got,
                 expected_counts({"folded_pool_layer_f32": 2, "folded_unpool_f32": 2,
                                  "folded_pool_layer_bwd_f32": 1, "folded_unpool_bwd_f32": 1,
                                  "fused_h_side_f32": 1, "fused_mlp_residual_f32": 1}), device)
    add(got)
    check("fp32 sums-less BroadcastingLayer, folded_pallas vs xla", rel_err(lay, lay_plain),
          TOL_F32_PATH)
    if not bool(torch.isfinite(xg.grad).all()):
        raise AssertionError("fp32 Broadcast: non-finite gradient")
    return rec, counts



# --------------------------------------------- phase 26: the Trainer --

CONFIG = "gecco_tpu_torch/configs/shapenet_airplane_unconditional.py"
# the rehearsal's cuts of the config (its text, copied): two layers of 64
# channels, 16 inducers, 4 heads, 64 points, batch 4, 3-step samplers and a
# 2-step likelihood
REHEARSAL_CUTS = (("n_layers=6", "n_layers=2"), ("feature_dim=384", "feature_dim=64"),
                  ("num_inducers=64", "num_inducers=16"), ("num_heads=8", "num_heads=4"),
                  ("n_solver_steps=128", "n_solver_steps=3"),
                  ("LogpMetric(n_solver_steps=24)", "LogpMetric(n_solver_steps=2)"),
                  ("N_POINTS = 2048", "N_POINTS = 64"), ("BATCH = 48", "BATCH = 4"))
# phase 25's batch of the routes' checks and of its fp32 models, and their
# depth
F32_BATCH, F32_LAYERS = 8, 2
# the Trainer phase's cuts of the config's run: 30 steps with a checkpoint
# and validation every 15, one validation batch (8 in the config), 96
# training and 96 validation clouds (the callback scores as many), then 30
# steps resumed from the last checkpoint (the Trainer fetching the loss
# every 10, its default) and 64 clouds sampled by the CLI
TRAINER_STEPS, TRAINER_SAVE_EVERY, TRAINER_VAL_BATCHES = 30, 15, 1
TRAINER_CLOUDS, TRAINER_RESUMED, TRAINER_INFER, TRAINER_LOSS_SYNC = 96, 30, 64, 10


def write_pointflow_tree(root, n_clouds, n_points, seed) -> None:
    """A PointFlow-layout tree of procedural clouds under ``root``: the
    airplane synset's train and val splits, one .npy a cloud."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        d = Path(root) / "02691156" / split
        d.mkdir(parents=True)
        for q, cloud in enumerate(make_clouds(rng, n_clouds, n_points)):
            np.save(d / f"cloud{q:04d}.npy", cloud)


def trainer_phase(device, n_points, steps, save_every, val_batches, n_clouds, resumed,
                  loss_sync, n_infer, infer_batch, n_steps, rehearse) -> tuple:
    """Phase 26: the port's flagship config trains through
    ``gecco_tpu_torch.train.train`` on a PointFlow-layout tree of procedural
    clouds: ``steps`` steps at the config's width and batch, a checkpoint
    and a validation (SupervisedMetric, LogpMetric(24), the loss and
    BenchmarkCallback) every ``save_every``, after the smoke test; then a
    fresh Trainer resumes from the newest checkpoint at the right step and
    takes ``resumed`` more, fetching the loss every ``loss_sync``, each
    set-transformer kernel 6 times a step, and ``python -m
    gecco_tpu_torch.infer`` samples ``n_infer`` clouds from its EMA
    weights. The steady ms/step: from the end of the resumed run's second
    loss fetch (its first step's, then ``loss_sync`` steps' later) to its
    last, on the host clock at each fetch's return. Returns (the resumed
    run's launch counts, a record)."""
    tmp = Path(tempfile.mkdtemp(prefix="gecco-trainer-"))
    key = "SHAPENET_PF_ROOT"
    keep_root = os.environ.get(key)
    keep_val = trainer_mod.Trainer.validation_phase
    keep_writer = trainer_mod.make_writer
    keep_save = trainer_mod.Trainer.save
    val_seconds, save_seconds = [], []
    fetched = {}  # step -> host clock when its loss came back from the card

    def timed_writer(path):
        writer = JsonlWriter(path) if rehearse else keep_writer(path)
        add = writer.add_scalar

        def add_scalar(tag, scalar_value=None, global_step=0, **kw):
            if tag == "train/loss":
                fetched[global_step] = time.perf_counter()
            add(tag, scalar_value=scalar_value, global_step=global_step, **kw)

        writer.add_scalar = add_scalar
        return writer

    def timed_save(self, *a, **kw):
        sync(device)
        t0 = time.perf_counter()
        keep_save(self, *a, **kw)
        save_seconds.append(time.perf_counter() - t0)

    def timed_validation(self, *a, **kw):
        t0 = time.perf_counter()
        keep_val(self, *a, **kw)
        sync(device)
        val_seconds.append(time.perf_counter() - t0)

    try:
        write_pointflow_tree(tmp / "data", n_clouds, n_points, 26)
        os.environ[key] = str(tmp / "data")
        config_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), CONFIG)
        if rehearse:
            text = Path(config_path).read_text()
            for a, b in REHEARSAL_CUTS:
                if a not in text:
                    raise AssertionError(f"rehearsal: {a!r} not in {CONFIG}")
                text = text.replace(a, b)
            config_path = str(tmp / "config.py")
            Path(config_path).write_text(text)
        config = load_config(config_path)
        run_dir = tmp / "run"
        run_dir.mkdir()
        trainer_mod.Trainer.validation_phase = timed_validation
        if rehearse:
            # the JSONL writer: TensorBoard's imports TensorFlow where that
            # is installed, seconds of the rehearsal's time
            trainer_mod.make_writer = JsonlWriter
        cut = dict(num_steps=steps - 1, save_every=save_every, n_validation_batches=val_batches,
                   device=device)
        print(f"  cuts: {steps} steps (config {config.NUM_STEPS}), checkpoint and validation "
              f"every {save_every} (config 10000), {val_batches} validation batch(es) (config 8), "
              f"{n_clouds} train and {n_clouds} validation clouds of {n_points} points; batch "
              f"{config.BATCH}")
        t0 = time.perf_counter()
        first = config.train(config.make_model, config.make_train_loader(),
                             config.make_val_loader(), str(run_dir), **cut)
        sync(device)
        first_s = time.perf_counter() - t0
        names = sorted(os.listdir(run_dir))
        print(f"  first run: {first_s:.1f} s for {steps} steps, {len(val_seconds)} validations "
              f"and the smoke test; run dir {names}")
        for want in (f"checkpoint-step-{steps - 1}", f"final-checkpoint-{steps - 1}",
                     "benchmark-checkpoints", "best-checkpoints"):
            if want not in names:
                raise AssertionError(f"trainer: {want} missing from the run dir {names}")
        trainer_mod.Trainer.validation_phase = keep_val
        trainer_mod.Trainer.save = timed_save
        trainer_mod.make_writer = timed_writer
        resume = trainer_mod.Trainer(
            model=config.make_model, train_dataloader=config.make_train_loader(),
            val_dataloader=config.make_val_loader(), save_path=str(run_dir),
            save_every=save_every * 100, num_steps=steps + resumed - 1,
            optimizer=flagship_optimizer(config.NUM_STEPS), skip_smoke_test=True,
            loss_sync_every=loss_sync, device=device)
        resume.recover_from_checkpoint(fail_if_unavailable=True)
        if resume.initial_step_number != steps:
            raise AssertionError(f"trainer resumed at step {resume.initial_step_number}, "
                                 f"expected {steps}")
        sync(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        resume.fit()
        sync(device)
        resumed_s = time.perf_counter() - t0
        trainer_mod.Trainer.save = keep_save
        counts = kernels.launch_counts()
        if not rehearse:
            check_counts("resumed Trainer", counts, expected_counts(
                {k: FLAGSHIP["n_layers"] * resumed for k in SET_FORWARD + FOLDED_BACKWARD}),
                device)
        if f"final-checkpoint-{steps + resumed - 1}" not in os.listdir(run_dir):
            raise AssertionError("trainer: the resumed run wrote no final checkpoint")
        out = tmp / "samples.npz"
        t0 = time.perf_counter()
        argv = [config_path, str(run_dir / f"final-checkpoint-{steps + resumed - 1}"), "--n-samples",
                str(n_infer), "--batch-size", str(infer_batch), "--n-points", str(n_points),
                "--output", str(out), "--device", str(device)]
        if n_steps is not None:
            argv += ["--n-solver-steps", str(n_steps)]
        samples = infer_main.main(argv)
        infer_s = time.perf_counter() - t0
        if samples.shape != (n_infer, n_points, 3) or not np.isfinite(samples).all():
            raise AssertionError(f"infer: samples {samples.shape} or non-finite values")
        # the steady steps: from the second fetch's return to the last's
        first, last = steps + loss_sync, steps + resumed - 1
        if sorted(fetched) != list(range(steps, last + 1)) or last <= first:
            raise AssertionError(f"trainer: losses fetched for steps {sorted(fetched)}, "
                                 f"expected {steps}..{last} over more than {loss_sync} steps")
        ms = 1e3 * (fetched[last] - fetched[first]) / (last - first)
        # the whole resumed run's, less its final checkpoint's write: the
        # loader's start and the first step's fetch inside
        whole_ms = 1e3 * (resumed_s - sum(save_seconds)) / resumed
        val = statistics.median(val_seconds) if val_seconds else float("nan")
        print(f"  resumed at step {steps}: {resumed} steps, the loss fetched every {loss_sync}; "
              f"steady {ms:.3f} ms/step over steps {first + 1}-{last} (host clock between the "
              f"fetches' returns); the whole run {whole_ms:.3f} ms/step ({resumed_s:.3f} s with "
              f"the loader's start, less the final checkpoint's {sum(save_seconds):.3f} s); "
              f"validation {val:.3f} s each ({', '.join(f'{v:.3f}' for v in val_seconds)} s: "
              f"the smoke test's two batches, then one batch and the callback); infer "
              f"{n_infer} clouds in {infer_s:.3f} s")
        return counts, dict(ms_per_step=ms, whole_ms_per_step=whole_ms, val_seconds=val_seconds,
                            first_s=first_s, infer_s=infer_s, save_s=sum(save_seconds))
    finally:
        trainer_mod.Trainer.validation_phase = keep_val
        trainer_mod.Trainer.save = keep_save
        trainer_mod.make_writer = keep_writer
        if keep_root is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = keep_root
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny shapes on the CPU (plain versions), then exit 1 without a result")
    args = ap.parse_args()

    if args.rehearse:
        device = torch.device("cpu")
        torch.set_num_threads(2)  # the tests run it beside other workers
        shapes = dict(batch=2, n_points=128, feature_dim=64, num_inducers=16, num_heads=4)
        big = dict(batch=1, n_points=256, feature_dim=128, num_inducers=16, num_heads=8)
        # 2 channels a group of 32 (at 1 a group, the GroupNorms zero some
        # gradients outright, and the train check compares noise)
        demo_dims = dict(DEMO, feature_dim=64, num_inducers=16, n_points=128)
        demo = dict(demo_dims, batch=2)
        heads3 = dict(shapes, feature_dim=48, num_heads=3)
        heads3_dims = dict(demo_dims, n_layers=2, feature_dim=96, num_heads=3)
        dt, reps, n_layers, batch, n_points, n_steps = torch.bfloat16, 1, 2, 2, 128, 3
        train_batch = cond_batch = 2
        image_size, render_size = 32, 37
        train_steps = twopass_steps = (1, 2)
        upsample = dict(n_new=300, n_steps=3, n_substeps=2, compare_new=200)
        ragged_ns = (100, 130)
        logp_steps = 3
        f32_batch, f32_layers = 2, 2
        trainer_cfg = dict(steps=4, save_every=2, val_batches=1, n_clouds=8, resumed=3,
                           loss_sync=1, n_infer=3, infer_batch=2, n_steps=2)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device")
        device = torch.device("cuda")
        shapes = dict(FLAGSHIP, batch=64)
        big = dict(SCALED_8K, batch=2)
        demo_dims = DEMO
        demo = dict(DEMO, batch=DEMO_BATCH)
        heads3 = dict(shapes, num_heads=3)
        heads3_dims = dict(FLAGSHIP, num_heads=3)
        dt, reps, n_layers, batch, n_points, n_steps = (
            torch.bfloat16, 20, FLAGSHIP["n_layers"], BATCH, FLAGSHIP["n_points"], N_STEPS)
        train_batch, cond_batch = TRAIN_BATCH, COND_BATCH
        image_size, render_size = IMAGE_SIZE, RENDER_SIZE
        train_steps = (TRAIN_WARMUP, TRAIN_STEPS)
        twopass_steps = (TRAIN_WARMUP, TWOPASS_STEPS)
        upsample = dict(n_new=UPSAMPLE_NEW, n_steps=UPSAMPLE_STEPS, n_substeps=UPSAMPLE_SUBSTEPS,
                        compare_new=4096)
        ragged_ns = RAGGED_NS
        logp_steps = LOGP_STEPS
        f32_batch, f32_layers = F32_BATCH, F32_LAYERS
        trainer_cfg = dict(steps=TRAINER_STEPS, save_every=TRAINER_SAVE_EVERY,
                           val_batches=TRAINER_VAL_BATCHES, n_clouds=TRAINER_CLOUDS,
                           resumed=TRAINER_RESUMED, loss_sync=TRAINER_LOSS_SYNC,
                           n_infer=TRAINER_INFER,
                           infer_batch=TRAINER_INFER, n_steps=None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== environment")
    print(f"  torch {torch.__version__}, cuda {torch.version.cuda}")
    card = "cpu rehearsal"
    if device.type == "cuda":
        print("  " + sh(_build._nvcc(), "--version").splitlines()[-1])
        card = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
        card = card.splitlines()[0]

    print("== build")
    if device.type == "cuda":
        t0 = time.perf_counter()
        reports = _build.build_all()
        print(f"  nvcc sm_90a: {len(reports)} libraries built in {time.perf_counter() - t0:.1f} s")
        for name, text in reports.items():
            entry = "?"
            for line in text.splitlines():
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    # a mangled name holds "<length><identifier>"
                    entry = next((f for fs in KERNEL_FUNCTIONS.values() for f in fs
                                  if f"{len(f)}{f}" in m.group(1)), m.group(1))
                elif "registers" in line or "spill" in line:
                    print(f"  {name} {entry}: {line.strip()}")

    print(f"== forward kernels vs plain versions ({shapes}; 8k pool {big}; both pool and "
          f"unpool bodies at {demo}, the WMMA bodies at {heads3}) on {card}")
    rec = kernel_phase(device, shapes, big, demo, heads3, dt, reps)

    train_shapes = dict(shapes, batch=train_batch)
    print(f"== backward kernels vs autograd of the plain versions ({train_shapes}; "
          f"8k pool {big}; the Hopper and WMMA pool and unpool backwards at {demo} and "
          f"{dict(heads3, batch=train_batch)}) on {card}")
    rec.update(backward_phase(device, train_shapes, big, demo, dict(heads3, batch=train_batch),
                              dt, reps))

    print(f"== projective gather vs plain versions (batch {cond_batch}, {n_points} points; "
          f"pyramids of {image_size}^2 and {render_size}^2 images) on {card}")
    gather_rec, gather_simt_counts = gather_phase(device, cond_batch, n_points, image_size,
                                                  render_size, dt, reps)
    rec.update(gather_rec)

    print(f"== per-head attention and megakernel vs plain versions (sampler batch "
          f"{shapes['batch']}, training batch {train_batch}; 8k {big}) on {card}")
    rec.update(attention_phase(device, shapes, train_batch, big, dt, reps, ragged_ns[0]))

    print(f"== resident pool and flag-free unpool vs plain versions (sampler batch "
          f"{shapes['batch']}, training batch {train_batch}; 8k {big}) on {card}")
    rec.update(resident_pool_phase(device, shapes, train_batch, big, dt, reps))

    print(f"== sampler path: flagship x{n_layers} layers, batch {batch}, {n_points} points, "
          f"{n_steps}-step Heun, on {card}")
    counts, path, _ = main_path(device, batch, n_points, n_layers, n_steps, compare_batch=8)
    print(f"  {path['clouds_per_s']:.3f} clouds/s on {card}")

    print(f"== training path: flagship x{n_layers} layers, batch {train_batch}, {n_points} "
          f"points, {train_steps[0]} + {train_steps[1]} steps, on {card}")
    train_counts, train = train_phase(device, n_layers, train_batch, n_points, card, train_steps)

    print(f"== conditional sampler path: ConvNeXt-tiny + RayNetwork + x{n_layers} layers, "
          f"batch {cond_batch}, {image_size}^2 images, {n_points} points, {n_steps}-step Heun, "
          f"on {card}")
    cond_counts, cond_path = conditional_sample_path(
        device, cond_batch, n_points, n_layers, n_steps, image_size, compare_batch=min(8, cond_batch),
        reps=reps)
    print(f"  {cond_path['clouds_per_s']:.3f} clouds/s on {card}")

    print(f"== conditional training path: x{n_layers} layers with remat, batch {cond_batch}, "
          f"{image_size}^2 images, {n_points} points, {train_steps[0]} + {train_steps[1]} steps, "
          f"on {card}")
    cond_train_counts, cond_train = conditional_train_phase(
        device, n_layers, cond_batch, n_points, image_size, card, train_steps)

    print(f"== per-head sampler path: flagship x{n_layers} layers, attn_impl=\"pallas\", batch "
          f"{batch}, {n_points} points, {n_steps}-step Heun, on {card}")
    ph_counts, ph_path, _ = main_path(
        device, batch, n_points, n_layers, n_steps, compare_batch=8, attn_impl="pallas",
        what="per-head kernel path",
        expect=lambda evals: {"rect_attention_fwd": 2 * n_layers * evals})
    print(f"  {ph_path['clouds_per_s']:.3f} clouds/s on {card}")

    print(f"== per-head training path: flagship x{n_layers} layers, attn_impl=\"pallas\", batch "
          f"{train_batch}, {n_points} points, {train_steps[0]} + {train_steps[1]} steps, on {card}")
    ph_train_counts, ph_train = train_phase(device, n_layers, train_batch, n_points, card,
                                            train_steps, attn_impl="pallas")

    print(f"== megakernel sampler path: flagship x{n_layers} layers, folded_pallas with "
          f"GECCO_UNPOOL_MLP_MEGAKERNEL=1, batch {batch}, {n_points} points, {n_steps}-step Heun, "
          f"on {card}")
    mega_counts, mega_path, mega_demo_counts, mega_demo_path = megakernel_path(
        device, batch, n_points, n_layers, n_steps, compare_batch=8, demo_dims=demo_dims,
        demo_batch=demo["batch"])
    print(f"  {mega_path['clouds_per_s']:.3f} clouds/s on {card} (the demo model through the "
          f"WMMA body: {mega_demo_path['clouds_per_s']:.3f} clouds/s)")

    print(f"== module-level folded path: Broadcast and BroadcastingLayer at C "
          f"{shapes['feature_dim']}, {shapes['num_heads']} heads, {shapes['num_inducers']} "
          f"inducers, {n_points} points (batch {shapes['batch']}, gradient at {train_batch}) "
          f"on {card}")
    module_counts, prenorm_counts = module_phase(device, dict(shapes, n_points=n_points),
                                                 train_batch, dt)

    print(f"== upsample path: flagship x{n_layers} layers, one {n_points}-point cloud to "
          f"{upsample['n_new']} points, {upsample['n_steps']}-step extended grid, "
          f"{upsample['n_substeps']} substeps, churn 0.5, on {card}")
    up_counts, up_path = upsample_path(device, n_layers, n_points, **upsample)

    print(f"== validation: gecco_tpu_torch.validate's loop, then one eval of the EMA model's "
          f"samples against held-out clouds, on {card}")
    val = validate_phase(device, args.rehearse)

    print(f"== demo sampler path: scripts/demo_upsample_100k.py's model ({demo_dims}), batch "
          f"{demo['batch']}, {n_steps}-step Heun (the Hopper pool and unpool, the MLP's WMMA "
          f"body), on {card}")
    demo_counts, demo_path, _ = main_path(
        device, demo["batch"], demo_dims["n_points"], demo_dims["n_layers"], n_steps,
        compare_batch=8, what="demo model's kernel path", dims=demo_dims,
        expect=lambda evals: {k: demo_dims["n_layers"] * evals for k in
                              ("folded_pool_ext", "fused_h_side", "folded_unpool",
                               "fused_mlp_residual_wmma")})
    print(f"  {demo_path['clouds_per_s']:.3f} clouds/s on {card}")

    print(f"== demo training path: scripts/demo_upsample_100k.py's model ({demo_dims}), batch "
          f"{train_batch}, {train_steps[0]} + {train_steps[1]} steps (the Hopper pool and unpool "
          f"backwards, the MLP backward's WMMA body); then one gradient with three heads "
          f"({heads3_dims}), on {card}")
    demo_train_counts, heads3_counts, demo_train = demo_train_phase(
        device, demo_dims, train_batch, heads3_dims, card, train_steps)

    print(f"== training path with the pool backward forced to v1, v2 and v2j: flagship "
          f"x{n_layers} layers, batch {train_batch}, {n_points} points, {twopass_steps[0]} + "
          f"{twopass_steps[1]} steps each, on {card}")
    twopass_train = twopass_train_phase(device, n_layers, train_batch, n_points, card,
                                        twopass_steps)
    for body, (_, tp) in twopass_train.items():
        # the comparison with v3 is the device's busy time per step; the
        # wall time of so few host-bound steps is kept, labelled, as read
        rec[f"folded_pool_ext_bwd_{body}"].update(
            train_device_ms_per_step=tp["device_ms_per_step"],
            v3_train_device_ms_per_step=train["device_ms_per_step"],
            train_wall_ms_per_step_host_bound=tp["ms_per_step"])

    print(f"== shapes of the wider kernel instances (ROADMAP C1): x{n_layers} layers, 8-step "
          f"samples of 8 clouds and gradients at batch {train_batch}, on {card}")
    shape_cases = {
        "the flagship with 32 inducers": (
            dict(FLAGSHIP, num_inducers=32, n_points=n_points), "folded_pallas",
            dict(folded_pool_ext_wmma=1, fused_h_side=1, folded_unpool_wmma=1,
                 fused_mlp_residual=1),
            dict(folded_pool_ext_wmma=1, fused_h_side=1, folded_unpool_wmma=1,
                 fused_mlp_residual=1, folded_pool_ext_bwd_wmma=1, folded_unpool_bwd_wmma=1,
                 fused_mlp_residual_bwd=1)),
        "the per-head flagship with three heads (D 128)": (
            dict(FLAGSHIP, num_heads=3, n_points=n_points), "pallas",
            # the gradient: the kernel pass and the witness's TPU-algebra pass
            # both run the forward kernel, only the first the backward's (the
            # kernel-free witness neither)
            dict(rect_attention_fwd=2), dict(rect_attention_fwd=4, rect_attention_bwd=2)),
    }
    shape_counts = shapes_phase(device, n_layers, train_batch, 8, shape_cases)

    print(f"== ROADMAP C1's shapes: every function at the shapes it raised at on the card "
          f"(batch {shapes['batch']}), then one model per shape at two layers, on {card}")
    c1_counts = c1_phase(device, dt, shapes, n_points, args.rehearse)
    shape_counts.update(c1_counts)

    print(f"== ragged point counts (ROADMAP C1): every point-tiled body at N {ragged_ns} "
          f"(forwards at batch {shapes['batch']}, backwards at {train_batch}; at the widths of "
          f"{demo} and {heads3}), then the flagship at N {ragged_ns[0]}, on {card}")
    ragged = ragged_phase(device, shapes, train_batch, demo, heads3, dt, reps, ragged_ns,
                          n_layers)

    print(f"== other samplers: the flagship x{n_layers} layers at batch {batch}, {n_points} "
          f"points, the {n_steps}-step extended grid, churn 0.5: sample_stochastic, "
          f"sample_inpaint (2 substeps), sample(temperature=0.8), score; the conditional "
          f"model's sample_stochastic at batch {cond_batch}, on {card}")
    samplers = samplers_phase(device, batch, cond_batch, n_points, n_layers, n_steps, image_size,
                              compare_batch=min(8, batch), compare_steps=5 if args.rehearse else 8)

    print(f"== likelihood: LogpMetric(n_solver_steps={logp_steps}) at batch {cond_batch} x "
          f"{n_points} points, the flagship x{n_layers} layers and the conditional model "
          f"(remat), on {card}")
    logp = logp_phase(device, cond_batch, n_points, n_layers, logp_steps, image_size,
                      compare_batch=min(8, cond_batch))

    f32_shapes = dict(shapes, batch=f32_batch)
    print(f"== fp32 routes: each against its plain version in fp32 at {f32_shapes}, timed in "
          f"turns with its bf16 body; then fp32 models of {f32_layers} layers ({f32_batch} x "
          f"{n_points} points) on folded_pallas and per head sample 8 steps and take 3 train "
          f"steps, a module-level Broadcast and a sums-less layer, "
          f"on {card}")
    f32_rec, f32_counts = f32_phase(device, f32_shapes, reps, f32_layers, f32_batch, n_points,
                                    args.rehearse)
    rec.update(f32_rec)

    print(f"== Trainer: {CONFIG} through gecco_tpu_torch.train.train on a PointFlow tree of "
          f"procedural {n_points}-point clouds, then a resumed Trainer and the infer CLI, on "
          f"{card}")
    trainer_counts, trainer_rec = trainer_phase(device, n_points, **trainer_cfg,
                                                rehearse=args.rehearse)

    print("== summary")
    print(f"  launches on the sampler path: {counts}")
    print(f"  launches on the training path: {train_counts}")
    print(f"  launches on the conditional sampler path: {cond_counts}")
    print(f"  launches on the conditional training path: {cond_train_counts}")
    print(f"  launches on the per-head sampler path: {ph_counts}")
    print(f"  launches on the per-head training path: {ph_train_counts}")
    print(f"  launches on the megakernel sampler path: {mega_counts}")
    print(f"  launches on the demo model's megakernel sampler path: {mega_demo_counts}")
    print(f"  launches on the module-level folded path: {module_counts}")
    print(f"  launches on the upsample path: {up_counts}")
    print(f"  launches on the fp32 models' paths (phase 25): {f32_counts}")
    print(f"  launches on the resumed Trainer's {trainer_cfg['resumed']} steps: {trainer_counts}")
    print(f"  launches on the demo sampler path: {demo_counts}")
    print(f"  launches on the demo training path: {demo_train_counts}")
    print(f"  launches in the num_heads=3 gradient: {heads3_counts}")
    for body, (tp_counts, _) in twopass_train.items():
        print(f"  launches on the training path under GECCO_POOL_BWD={body}: {tp_counts}")
    for name, (s_counts, g_counts) in shape_counts.items():
        print(f"  launches of {name}: 8-step sample {s_counts}; gradient {g_counts}")
    busy = lambda t: "not measured" if t is None else f"{t:.3f} ms"
    print("  train step with the pool backward forced, device busy per step (torch.profiler): "
          + ", ".join(f"{body} {busy(tp['device_ms_per_step'])}" for body, (_, tp) in
                      twopass_train.items())
          + f" (v3, the default: {busy(train['device_ms_per_step'])}, phase 8 of this run); "
          + f"wall per step of {twopass_steps[1]} host-bound steps, not a comparison of the "
          + "bodies: " + ", ".join(f"{body} {tp['ms_per_step']:.3f} ms" for body, (_, tp) in
                                   twopass_train.items()))
    print(f"  sampler {path['clouds_per_s']:.3f} clouds/s (batch {batch}); train step "
          f"{train['ms_per_step']:.3f} ms (batch {train_batch}); conditional sampler "
          f"{cond_path['clouds_per_s']:.3f} clouds/s (batch {cond_batch}; ConvNeXt "
          f"{cond_path['convnext_ms']:.3f} ms, {cond_path['eval_ms']:.3f} ms per evaluation); "
          f"conditional train step {cond_train['ms_per_step']:.3f} ms (batch {cond_batch}; "
          f"ConvNeXt forward + backward {cond_train['convnext_ms']:.3f} ms); per-head sampler "
          f"{ph_path['clouds_per_s']:.3f} clouds/s ({ph_path['eval_ms']:.3f} ms per evaluation); "
          f"per-head train step {ph_train['ms_per_step']:.3f} ms (batch {train_batch}); "
          f"megakernel sampler {mega_path['clouds_per_s']:.3f} clouds/s "
          f"({mega_path['eval_ms']:.3f} ms per evaluation; the demo model's through the WMMA "
          f"body {mega_demo_path['clouds_per_s']:.3f}); upsample to {upsample['n_new']} "
          f"points {up_path['seconds']:.3f} s ({up_path['points_per_s']:.1f} new points/s); "
          f"validation phase {val['seconds']:.1f} s (1-NN {val['one_nn']:.4f}, MMD "
          f"{val['mmd']:.4g}, COV {val['cov']:.4f}); demo sampler {demo_path['clouds_per_s']:.3f} "
          f"clouds/s (batch {demo['batch']}); demo train step {demo_train['ms_per_step']:.3f} ms "
          f"(batch {train_batch}); one flagship evaluation at batch {shapes['batch']}: "
          + ", ".join(f"{k[len('eval_ms_n'):]} points {v:.3f} ms" for k, v in ragged.items())
          + f"; {card}")
    print("  other samplers: " + ", ".join(
        f"{k} {v['clouds_per_s']:.3f} clouds/s ({v['seconds']:.3f} s, batch {v['batch']}, "
        f"{v['evals']} evaluations)" for k, v in samplers.items()) + f"; {card}")
    print("  likelihood per batch: " + ", ".join(
        f"{k} {v['seconds']:.3f} s (batch {v['batch']}, {v['evals']} evaluations and VJPs"
        + (f"; device busy {v['device_ms']:.1f} ms, of which the discarded weight-gradient "
           f"passes {v['split_ms'].get(next(c for c in v['split_ms'] if 'weight' in c), 0):.1f}"
           f" ms" if v.get("split_ms") else "") + ")" for k, v in logp.items())
          + f"; {card}")
    print(f"  Trainer (phase 26): steady {trainer_rec['ms_per_step']:.3f} ms/step (the "
          f"resumed run's {trainer_rec['whole_ms_per_step']:.3f} with the loader's start) at "
          f"batch {TRAIN_BATCH if not args.rehearse else 4}; "
          f"validation " + ", ".join(f"{v:.3f}" for v in trainer_rec["val_seconds"])
          + f" s; the first run {trainer_rec['first_s']:.1f} s; infer "
          f"{trainer_rec['infer_s']:.3f} s; {card}")
    # launches: each kernel's count on the path that first brought it in
    # (printed above): the flagship sampler's for a set-transformer forward
    # kernel, the flagship training path's for a backward one, the
    # conditional sampler's for the gather and the conditional training
    # path's for its backward, the per-head paths' for the rect attention,
    # the megakernel sampler's for the megakernel and the module-level
    # folded path's for the resident pool and its backward (their WMMA
    # bodies': the three-head Broadcast's), split by variant: the sums-less
    # layer's run gave the pre-norm launches (nested under "prenorm", as
    # their times are), the Broadcast's runs the rest; the demo sampler's
    # for the MLP forward's WMMA body, the num_heads=3 gradient's for the
    # pool and unpool forwards' WMMA bodies, the demo training path's for
    # the MLP backward's WMMA body, the gradient of the flagship with 32
    # inducers (phase 21) for the pool and unpool backwards' WMMA bodies;
    # the forced-body training paths' for the pool backward's v1, v2 and
    # v2j (their Hopper body), phase 21's demo-width model's gradient under
    # each for their WMMA body
    per_head_d40 = next(k for k in shape_counts if k.startswith("the per-head flagship at D 40"))
    pool_counts = {}
    for name in ("folded_pool_layer", "folded_pool_layer_wmma", "folded_pool_layer_bwd",
                 "folded_pool_layer_bwd_wmma"):
        rec[name]["prenorm"]["launches"] = prenorm_counts.get(name, 0)
        pool_counts[name] = module_counts.get(name, 0) - prenorm_counts.get(name, 0)
    source_counts = {"projective_gather": cond_counts, "projective_gather_bwd": cond_train_counts,
                     # the gather's SIMT bodies: the entry point at their
                     # widths (phase 5)
                     "projective_gather_simt": gather_simt_counts,
                     "projective_gather_bwd_simt": gather_simt_counts,
                     "rect_attention_fwd": ph_counts, "rect_attention_bwd": ph_train_counts,
                     # the rect attention's WMMA bodies: the per-head model at
                     # D 40's sample and gradient (phase 21)
                     "rect_attention_fwd_wmma": shape_counts[per_head_d40][0],
                     "rect_attention_bwd_wmma": shape_counts[per_head_d40][1],
                     "fused_unpool_mlp": mega_counts,
                     "fused_unpool_mlp_wmma": mega_demo_counts, "folded_pool_layer": pool_counts,
                     "folded_pool_layer_wmma": pool_counts, "folded_pool_layer_bwd": pool_counts,
                     "folded_pool_layer_bwd_wmma": pool_counts,
                     "folded_pool_ext_wmma": heads3_counts,
                     "folded_unpool_wmma": heads3_counts, "fused_mlp_residual_wmma": demo_counts,
                     "folded_pool_ext_bwd_wmma": shape_counts["the flagship with 32 inducers"][1],
                     "folded_unpool_bwd_wmma": shape_counts["the flagship with 32 inducers"][1],
                     "fused_mlp_residual_bwd_wmma": demo_train_counts,
                     **{f"folded_pool_ext_bwd_{body}": tp_counts
                        for body, (tp_counts, _) in twopass_train.items()},
                     # the WMMA two-pass bodies: the demo-width model's
                     # gradient under each forced body (phase 21)
                     **{f"folded_pool_ext_bwd_{body}_wmma":
                        shape_counts[f"the demo's width under GECCO_POOL_BWD={body}"][1]
                        for body in kernels.TWOPASS_BODIES},
                     # the fp32 routes: phase 25's fp32 models
                     **{name: f32_counts for name in SOURCES if name.endswith("_f32")}}
    line = {"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
             launches=source_counts.get(name, train_counts if name in BACKWARD else counts)[name],
             **{"library_chain_ms": None, **rec[name]})
        for name in SOURCES
    ]}
    if args.rehearse:
        print("rehearsal finished: no result on the CPU")
        sys.exit(1)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
