#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA
              versions; fails without a CUDA device.
2. build    — nvcc compiles the package's csrc/*.cu, one compiler per
              source in parallel (timed), in a thread: since PR 15 the
              population checks that launch no kernel of the repo ((a),
              (b), (d), (e), (f) below) run meanwhile, and the library is
              loaded after them (it must not have been loaded before);
              the ptxas report of each kernel. Each later phase prints
              its seconds.
3. kernels  — each kernel against its plain PyTorch version on the card, on
              the same inputs at the main paths' shapes, with the tolerance
              stated beside each check; both timed with CUDA events. The
              MLP forward (#2) runs at every MLP_SHAPES row (simple_ode's,
              heat's and heat2d's grids, H = 32 to 1 024, and a 1024 ×
              1024 grid), and it and its plain version are timed by their
              device time (events around calls queued behind a spin
              kernel), each shape beside its bound. The
              heat-streams kernel (#3) runs at heat's shape and at a ragged
              B = 1000 for tanh, sigmoid and relu, and its gradient through
              the rematerialised backward is held against the Taylor taps'
              autograd; #3 and its plain version are timed by their device
              time (events around calls queued behind a spin kernel), since
              one call's host work outlasts it. The generic engine runs at
              each of its 7 MLP specs' default shapes and at volterra's
              (51 groups folded into one stream), uat's (the Perceptron at
              L = 0, H = 3) and inverse_heat's (log κ̂ an extra trainable
              tensor; both take a const operand), each of these three also
              timed at 1 000 steps, and #2 at uat's and inverse_heat's
              evaluation shapes;
              the DGM engine at FitzHugh–Nagumo's and Fredholm's, and the
              packed-replica kernel (#5) at the ensembles' shapes (wave
              N=8, FitzHugh–Nagumo N=16, Fredholm N=4), where every
              replica must also equal the single-replica chunk bit for bit.
              The chunks of the heat kernel (#1) and both engines replay a
              captured CUDA graph of graphs.GRAPH_STEPS steps: its capture
              and instantiation are timed apart from the chunks (the first
              call of a shape), and 1 000-step chunks (FitzHugh–Nagumo
              single and N=16, heat2d single, wave N=8) give the
              steady-state time per step; a heat2d chunk and a heat (#1)
              chunk at hidden width 256, and #3 at H = 256 and 512 for each
              activation, are held against their plain versions. The five
              hard-constraint specs (simple_ode, heat, heat2d, wave,
              poisson: a HardConstraint's raw net, interior streams only)
              get the same #6 and 50-step #4 checks and a 1 000-step
              chunk each, and hard heat a packed N = 4 chunk (every
              replica bit for bit against the single chunk). Then
              #3's trial axis (STREAM_TRIALS: T nets in one launch under
              torch.func.vmap, the population's call): each trial bit
              for bit its own one-trial launch and within #3's tolerance
              of the plain version, T = 8 at B = 64 timed by device time
              beside its bound (its JSON row). Causal
              advection (c = 50, ε = 5: the cross-point loss kernel) gets
              the same #6, 50- and 1 000-step checks and a packed N = 2
              chunk (bit for bit per replica). #2's row
              carries the time of the cuBLAS addmm + tanh chain (TF32
              off) on the same inputs as its library yardstick. Since PR
              13 the "default" precision's bf16 tensor-core instances
              (BF16_CHECKS): one step and a 50-step chunk of #1 at heat,
              of the MLP engine at heat2d and volterra and of the DGM
              engine at FitzHugh–Nagumo and Fredholm, each trainable
              tensor against its plain version at "default" and several
              times as far from its own "highest" (BF16_STEP_TOL,
              BF16_SEPARATION, BF16_CHUNK_TOL, BF16_CHUNK_SEPARATION);
              the packed kernel at wave N = 8, Fredholm N = 4 (the shapes
              of the bf16 ensemble solves) and FitzHugh–Nagumo N = 16
              (every replica bit for bit against the single chunk);
              1 000-step chunks at "default" beside "highest" in turns
              (#1, heat2d, wave N = 8, FitzHugh–Nagumo N = 16); each row
              with the cuBLAS bf16 torch.matmul at its layer product's
              shape as its library yardstick.
4. solve    — each main path through ``solve(..., engine="fused")`` at its
              equation's reference defaults (seed 0): constant-lr heat on
              the heat kernel, heat with a cosine schedule and the nine
              other MLP-engine equations (volterra, uat 100 000 steps,
              inverse_heat with its κ̂ error under 0.15 among them) on the
              generic engine, FitzHugh–Nagumo (150 000
              steps) and Fredholm on the DGM engine; then the packed
              ensembles: FitzHugh–Nagumo with causal_eps=0 (16 replicas and
              the 200-step L-BFGS polish the JAX package picks for it),
              wave with 8 replicas and Fredholm with 4; then three solves
              on the scan trainer (``engine="scan"``, the default): heat
              with ``taps="pallas"`` (kernel #3 once per step plus the
              warm-up), heat with its default jvp taps, simple_ode,
              volterra and Fredholm with Monte-Carlo quadrature. Each: a
              finite loss history of the right length, a finite solution of
              the problem's shape, MAE under its bound, and its kernels
              launched by that run (counts set to 0 just before it and read
              just after). Two fused solves run at hidden width 256:
              heat2d on the generic engine and heat on the heat kernel.
              Then ``constraint="hard"`` at the JAX package's TPU smoke
              configuration (5 000 steps, seed 42, no polish, MAE < 0.05):
              the five hard specs on the generic engine (constant-lr heat
              too, never on kernel #1), hard heat as a 4-replica ensemble,
              simple_ode on the scan trainer, and FitzHugh–Nagumo's DGM on
              the scan trainer at 1 000 steps (no MAE bound: a finite
              history and s(0) = y_ic); every hard solve's grid holds its
              IC and BC rows to 1e-6. Then causal advection at the JAX
              package's TPU smoke configuration (c = 50, causal_eps = 5,
              30 000 steps, seed 42, MAE < 0.05) on the fused engine, as a
              2-replica ensemble, and on the scan trainer. Every scan solve
              replays one captured CUDA graph per whole 256-step block of
              each chunk (a replay count), and runs the rest eagerly.
              Since PR 13 the bf16 precisions (PRECISION_SOLVES): heat at
              "mixed" and "default", heat2d, wave × 8 and FitzHugh–Nagumo
              (150 000 steps) at "mixed", Fredholm × 4 at "mixed", each
              under its equation's MAE bound, through the "default"
              instances (a "mixed" run through both), printed beside the
              same configuration's "highest" run; a "highest" run launches
              no "default" instance.
   Then the sweep phase (the fused sweep tier, since PR 14) and the rest
   of the population phase (parallel/population.py on the scan engine,
   since PR 15). Its checks: (a) the reference's batch-size ablation as
   one population of 55 trials (a bs 1 024 trial held to its standalone
   train()), (b) the BatchNorm ablation and a pre-BN train() (its
   statistics moved, its eval-mode grid its own), (d) FitzHugh–Nagumo's
   fourier_mlp at 30 000 steps, (e) successive halving, random search
   and TPE on populations (each winner's score and best_params() read
   back from its last population, and in each population it trained in,
   its first steps re-run standalone from the state that population
   started it from), (f) a ResNet on the scan trainer, all during the
   build; after the sweep phase the headline population's step timed
   alone (55 heat trials x 1 024 rows: host draws, an eager step, a
   graph replay), (c) solve("heat", engine="scan", ensemble=8) and (g)
   the same with taps="pallas" (kernel #3 with T = 8 once a population
   step, inside the population graph; its steps/s beside (c)'s); the
   cuts of depth on an earlier line; peak memory, captures and replays
   printed. Since PR 15 heat's two scan solves run SCAN_HEAT_STEPS steps
   (under their MAE bound), the other scan solves run whole scan-graph
   blocks, and phase 3's bf16 1 000-step timings take one call per turn.
   Then the mesh phase (parallel/): a one-rank NCCL group in
   this process, each sharded driver against its unsharded call: (a)
   solve("wave", engine="fused", ensemble=8, mesh=make_mesh({"pop": 1}))
   at wave's reference width, depth and budget, under its bound, its
   replicas bit for bit the packed ensemble's; (b) FitzHugh–Nagumo's DGM
   ensemble (kernel #5) bit for bit the sequential runs of mesh=None
   (kernel #4); (c) fused halving on heat and on Fredholm with a
   batch-size space, sharded rungs against packed rungs (bit for bit
   where the tiles match, MESH_TILE_RTOL where they differ); (d)
   data-parallel train() of heat, jvp and pallas taps (kernel #3), with
   the NCCL all-reduce inside the captured graph, bit for bit, and of a
   pre-BN heat MLP and causal advection (rows coupled across ranks; at
   one rank no gather on the path), bit for bit; (e) a
   population on {"pop": 1}, bit for bit; (f) dryrun_multichip(1). Each
   check prints its launches.
   Then the CLI phase (CLI_* above ``phase_cli``): (a) ``heat
   --solve --engine fused --export`` at heat's CLI defaults (the
   reference's), MAE under 0.05, #1 and #2 launched; (b) the same cut at
   7 530 steps (``--checkpoint``) and resumed for 7 470 (``--restore``),
   bit for bit (a)'s solution and loss tail; (c) the scan engine's 1 000
   steps against 300 + 700, bit for bit; (d) ``--plot`` on (a)'s arrays
   prints (a)'s MAE (``--savefig`` writes the figure, or exits naming
   matplotlib where it is not installed); (e) a ``python -I`` process
   that cannot import the port loads (a)'s export on cuda and serves the
   1 600 grid points and n = 1 and 17 within 1e-5 of #2's grid; (f)
   ``python -m differential_equations_dnn_tpu_torch heat --solve --engine
   fused --niters 500`` exits 0; (g) Fredholm fused (#4/#7), MAE under
   0.0134; (h) the tpe-fused and asha-fused sweeps (#4/#5 in the sweep
   mode), a finite best score. Each run prints its launches.
5. result   — the smoke's total seconds, a JSON line of the kernels,
              then as the last line {"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "differential_equations_dnn_tpu_torch"
JAX_KERNELS = "differential_equations_dnn_tpu/kernels"
CHUNK_STEPS = 50   # steps of each chunk comparison
STEP0 = 100        # the engine chunks' first step
HORIZON = 200      # their schedule's horizon: lr falls by tens of percent
REPS = 20          # timed calls per measurement, after one warm-up call
PLAIN_REPS = 2     # timed calls of a plain K-step chunk (slow: 50 steps)
STEADY_STEPS = 1000  # the DGM chunks' steady state: 20 graph replays
STEADY_REPS = 3
SPIN_CYCLES = 500_000_000  # about 0.3 s of the card's clock: device_ms
# Calls device_ms queues behind one spin: the launch queue holds about a
# thousand launches, and a plain heat-streams call makes about 80.
SPIN_REPS = 5
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
ENGINE = ["simple_ode", "heat", "burgers", "wave", "advection", "poisson",
          "heat2d"]
DGM = ["fitzhugh_nagumo", "fredholm"]
# The MLP-engine specs past the plain MLP layout: a folded const-operand
# spec, the L = 0 Perceptron, an extra trainable tensor. Their rows nest
# under the engine kernels' rows ("specs").
LAST = ["volterra", "uat", "inverse_heat"]
# The hard-constraint specs (fused_engine.HARD_SPECS): their rows nest under
# the engine kernels' rows too, and their solves run at the JAX package's
# TPU smoke configuration (benchmarks/smoke_tpu.py:101-109): 5 000 steps,
# seed 42, no polish, MAE bound 0.05.
HARD = ["simple_ode", "heat", "heat2d", "wave", "poisson"]
HARD_SOLVE = dict(constraint="hard", iterations=5000, seed=42, finetune=0)
HARD_BOUND = 0.05
# The packed hard case: heat's hard spec at N = 4 (its replicas bit for bit
# against the single chunk), and the ensemble solve that launches it.
HARD_PACKED = ("heat", 4, 1e-5)
# The grid rows on which each hard trial function holds its IC or BC
# exactly: (axis of solution_shape, index); held to the ground truth there
# to atol HARD_ATOL, as the JAX package's
# test_hard_constraint_trains_on_fused_engine holds them.
HARD_ROWS = {"simple_ode": [(0, 0)], "fitzhugh_nagumo": [(0, 0)],
             "heat": [(0, 0), (1, 0), (1, -1)],
             "wave": [(0, 0), (1, 0), (1, -1)],
             "poisson": [(0, 0), (0, -1), (1, 0), (1, -1)],
             "heat2d": [(0, 0), (1, 0), (1, -1), (2, 0), (2, -1)]}
HARD_ATOL = 1e-6
# Causal advection: the JAX package's high-speed transport case
# (benchmarks/smoke_tpu.py:59-62): c = 50, causal_eps = 5, 30 000 steps,
# seed 42, MAE bound 0.05 (the plain loss settles on a damped branch at
# MAE about 0.2 there). Its spec's rows nest under the engine kernels'
# rows, its packed N = 2 chunk under #5's; it solves on the fused engine,
# as a 2-replica ensemble and on the scan trainer.
CAUSAL = dict(c=50.0, causal_eps=5.0)
CAUSAL_SOLVE = dict(iterations=30_000, seed=42, **CAUSAL)
# The scan solve takes the same bound: the JAX package's own scan solve at
# this configuration reached MAE 0.00872 on the CPU.
CAUSAL_BOUND = 0.05
# Its packed chunk's losses to rtol 1e-4, as its single chunk's.
CAUSAL_PACKED = ("advection", 2, 1e-4)
# The scan trainer's hard solves: simple_ode at 5 000 steps under the MAE
# bound, and FitzHugh–Nagumo's DGM at 1 000 steps with no MAE bound (None):
# 1 000 steps cannot reach the reference's 0.0088, so only a finite history
# and s(0) = y_ic are held.
HARD_SCAN = [("simple_ode", dict(constraint="hard", iterations=5120), 0.05),
             ("fitzhugh_nagumo", dict(constraint="hard", iterations=1024),
              None)]
# inverse_heat's κ̂ error bound, the JAX package's own
# (tests/test_equations.py:208).
KAPPA_BOUND = 0.15
# (equation, schedule or None for its default, MAE bound). The bounds are
# the JAX package's TPU smoke bounds (benchmarks/smoke_tpu.py); heat's
# 0.05 is the reference's published 0.0529 at this budget, and
# FitzHugh–Nagumo's 0.0088 and Fredholm's 0.0134 are the reference's
# published MAEs (BASELINE.md).
SOLVES = [("heat", None, 0.05), ("heat", "cosine", 0.05),
          ("simple_ode", None, 0.01), ("burgers", None, 0.05),
          ("wave", None, 0.05), ("advection", None, 0.05),
          ("poisson", None, 0.05), ("heat2d", None, 0.05),
          ("volterra", None, 0.05), ("uat", None, 0.05),
          ("inverse_heat", None, 0.05),
          ("fitzhugh_nagumo", None, 0.0088), ("fredholm", None, 0.0134)]
# The packed ensembles: (equation, solve's extra arguments, MAE bound).
# FitzHugh–Nagumo with causal_eps=0 takes the JAX package's automatic 16
# replicas and 200-step polish; the bounds are the single runs'.
ENSEMBLES = [("fitzhugh_nagumo", {"causal_eps": 0.0}, 0.0088),
             ("wave", {"ensemble": 8}, 0.05),
             ("fredholm", {"ensemble": 4}, 0.0134)]
# Fused solves at hidden width 256, which the first designs refused (the
# MLP engine for heat2d's 11 streams, the heat kernel #1): (equation, model
# widths (D, O, H, L), MAE bound as for the default width).
WIDE_SOLVES = [("heat2d", (3, 1, 256, 3), 0.05),
               ("heat", (2, 1, 256, 3), 0.05)]
# Kernel #2's shapes: (grid, D, H, L, activation), output width 1. The
# grids of simple_ode, of heat (and burgers, wave, advection, poisson: the
# same 40 × 40) for the three activations, and of heat2d (24³); the
# WIDE_SOLVES widths on heat's and heat2d's grids; the widest width tested;
# a 1024 × 1024 grid, large-batch inference; uat's grid through its
# Perceptron (L = 0, H = 3) and inverse_heat's through its net.
MLP_SHAPES = [("simple_ode", 1, 32, 1, "tanh"), ("heat", 2, 128, 3, "tanh"),
              ("heat", 2, 128, 3, "relu"), ("heat", 2, 128, 3, "sigmoid"),
              ("heat2d", 3, 128, 3, "tanh"), ("heat", 2, 256, 3, "tanh"),
              ("heat2d", 3, 256, 3, "tanh"), ("heat", 2, 1024, 3, "tanh"),
              ("1024x1024", 2, 128, 3, "tanh"), ("uat", 1, 3, 0, "tanh"),
              ("inverse_heat", 2, 128, 3, "tanh")]
# Widths past the first designs of kernels #1 (H = 221) and #3 (H = 191).
HEAT_WIDE = 256
STREAMS_WIDE = (256, 512)
# Kernel #3's trial axis (T, B, H): the population's shape (8 trials of
# heat's 64 rows at H = 128, the JSON row), a large batch, a ragged one.
STREAM_TRIALS = [(8, 64, 128), (3, 1000, 128), (2, 37, 256)]
# The scan trainer's solves: (equation, solve's extra arguments, MAE bound),
# the bounds as for the fused solves. Since PR 15 heat's two scan solves
# run SCAN_HEAT_STEPS of their 15 000 steps, under the same bound (they
# reached 0.0025 and 0.0028 at that depth: PR 15's call 7), and the other
# scan solves run whole blocks of the scan graph (simple_ode 5 120 of its
# 5 000 steps, volterra's and Fredholm's 3 072 of 3 000, the hard
# simple_ode 5 120 and FitzHugh–Nagumo 1 024 of 5 000 and 1 000): an eager
# tail step costs a graph's replay many times over.
SCAN_HEAT_STEPS = 5120
SCAN_SOLVES = [("heat", {"taps": "pallas", "iterations": SCAN_HEAT_STEPS},
                0.05),
               ("heat", {"iterations": SCAN_HEAT_STEPS}, 0.05),
               ("simple_ode", {"iterations": 5120}, 0.01),
               ("volterra", {"quadrature": "montecarlo", "iterations": 3072},
                0.05),
               ("fredholm", {"quadrature": "montecarlo", "iterations": 3072},
                0.05)]
ACTIVATIONS = ("tanh", "sigmoid", "relu")
# (equation, replicas, rtol of the losses against the plain version) of
# the packed-kernel checks; the first two give the JSON rows. Fredholm's
# losses are not held to a tolerance (None) but printed per replica: at lr
# 3e-3 they fall steeply within these 50 steps, and on the H100 the fp32
# reassociation drift between kernel and plain version (1.05e-6) exceeded
# rtol 1e-4 of them. Its parameters are held to the plain version, and
# every replica to the single chunk bit for bit, as in the other cases.
PACKED = [("wave", 8, 1e-5), ("fitzhugh_nagumo", 16, 1e-5),
          ("fredholm", 4, None)]
# The "default" precision's checks (PR 13), tensor by tensor (w_in, b_in,
# w_h, ...: the small input and output tensors too, which a norm of the
# whole flat gradient would hardly see), by relative L2 norms. Both the
# kernel and the plain version round the same operands to bf16, but they
# compute the operands of later products an fp32 ulp apart, and such an
# operand can round to the next bf16 value (a 2^-8 change). One step: each
# tensor's gradient within BF16_STEP_TOL of the plain version's and at
# least BF16_SEPARATION times as far from the kernel's own "highest" (on the
# H100 at every checked shape, tests/test_torch_gpu.py's too: at most
# 1.04e-3 from the plain version, inverse_heat's b_in; at least 8.6 times as
# far from "highest", FitzHugh–Nagumo's Wh).
BF16_STEP_TOL = 2e-3
BF16_SEPARATION = 4
# 50 steps: each tensor's update p_K − p_0, where Adam carries the flips
# forward: within BF16_CHUNK_TOL of the plain version's and at least
# BF16_CHUNK_SEPARATION times as far from "highest" (on the H100: at most
# 1.45e-2 from the plain version and 2.6 times as far from "highest",
# Fredholm × 4's Uh). A tensor of fewer than BF16_CHUNK_ENTRIES entries (the
# output bias, O ≤ 2 entries; inverse_heat's κ̂) is held by the one-step
# check alone: Adam moves each entry by about lr a step whatever its
# gradient, so its 50-step update hardly depends on the precision
# (FitzHugh–Nagumo's s_out.b: 1.47e-3 from the plain version, 2.02e-3 from
# "highest").
BF16_CHUNK_TOL = 2e-2
BF16_CHUNK_SEPARATION = 2
BF16_CHUNK_ENTRIES = 8
# (route, equation, replicas): one step and a 50-step chunk each; the
# packed cases against the single chunk bit for bit per replica. The first
# case of each kernel gives its JSON row: the shape its PRECISION_SOLVES run
# launches it at (the packed DGM kernel at Fredholm N = 4).
BF16_CHECKS = [("heat", "heat", 1), ("engine", "heat2d", 1),
               ("engine", "volterra", 1), ("engine", "wave", 8),
               ("dgm", "fitzhugh_nagumo", 1), ("dgm", "fredholm", 4),
               ("dgm", "fitzhugh_nagumo", 16), ("dgm", "fredholm", 1)]
# The 1 000-step timings at "default" beside "highest": (equation, N).
BF16_STEADY = [("heat", 1), ("heat2d", 1), ("wave", 8),
               ("fitzhugh_nagumo", 16)]
# The bf16 solves: (equation, solve's extra arguments, MAE bound as for the
# equation's "highest" run).
PRECISION_SOLVES = [("heat", {"precision": "mixed"}, 0.05),
                    ("heat", {"precision": "default"}, 0.05),
                    ("heat2d", {"precision": "mixed"}, 0.05),
                    ("wave", {"ensemble": 8, "precision": "mixed"}, 0.05),
                    ("fitzhugh_nagumo", {"precision": "mixed"}, 0.0088),
                    ("fredholm", {"ensemble": 4, "precision": "mixed"},
                     0.0134)]


# The sweep mode (the JAX kernels' run-time batch mask, step budget
# and trial horizon of #4, the per-slot vectors of #5, the masked losses of
# #6 and #7). Phase 3 holds each masked and gated chunk against its plain
# version over CHUNK_STEPS steps from STEP0 under a cosine schedule, at
# "highest" (losses rtol 1e-4, parameters rtol 1e-4 plus 2·lr, as the chunk
# checks above; the losses past the budget 0 in both) and at "default"
# (each tensor's update within BF16_CHUNK_TOL of the plain version's and
# BF16_CHUNK_SEPARATION times as far from "highest"): (route, equation,
# problem arguments, tile B, masked batch bs, budget, horizons). Tile 512
# is the sweep phase's: its heat and Fredholm trials of bs 257-511 (the
# best heat TPE trial's bs 485, Fredholm's 370) run there, at other layer
# and weight-gradient instances than tile 64's.
MASKED_CHECKS = [
    ("engine", "heat", {}, 64, 37, 30, ("trial", "fixed")),
    ("engine", "heat", {}, 512, 485, 30, ("trial", "fixed")),
    ("engine", "inverse_heat", {}, 128, 77, CHUNK_STEPS, ("trial",)),
    ("engine", "volterra", {}, 64, 41, 40, ("trial",)),
    ("dgm", "fitzhugh_nagumo", {"causal_eps": 0.0}, 256, 150, 30,
     ("trial",)),
    ("dgm", "fredholm", {"k": 16}, 64, 37, 30, ("trial",)),
    ("dgm", "fredholm", {"k": 16}, 512, 370, 30, ("trial",)),
]
# The packed per-slot checks: (route, equation, problem arguments, tile,
# per-slot lr, bs (None: no row mask), budget). A budget of 0 is a pruned
# slot, which must come back as it went in with losses 0; every slot must
# equal the single chunk of its values bit for bit. Heat at tile 512 with
# 5 slots is a q = 5 TPE round's call (its halving rungs of 27 slots take
# the same instances); FitzHugh–Nagumo at tile 100 with 9 slots and no
# mask is its halving rungs' call (lr-only: 9, then 3, then 1 live).
PER_SLOT_CHECKS = [
    ("engine", "heat", {}, 64, (1e-3, 3e-3, 1e-2, 1e-4), (64, 37, 1, 20),
     (50, 30, 0, 7)),
    ("engine", "heat", {}, 512, (1e-3, 3e-4, 3e-3, 1e-2, 1e-4),
     (485, 429, 348, 300, 1), (50, 30, 45, 7, 0)),
    ("dgm", "fitzhugh_nagumo", {"causal_eps": 0.0}, 256, (1e-4, 1e-3, 3e-3),
     (256, 100, 17), (50, 0, 23)),
    ("dgm", "fitzhugh_nagumo", {"causal_eps": 0.0}, 100,
     (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 2e-4, 5e-4, 2e-3, 5e-3), None,
     (50, 0, 0, 50, 0, 0, 30, 0, 0)),
    ("dgm", "fredholm", {"k": 16}, 64, (3e-3, 1e-3, 1e-2), (64, 37, 9),
     (50, 0, 23)),
]
# A halving rung's cost against its live slots: heat at tile 64, RUNG_SLOTS
# slots of which the first k train RUNG_STEPS steps (the rest pruned).
RUNG_SLOTS, RUNG_LIVE, RUNG_STEPS = 27, (27, 9, 3, 1), 500
# The sweep phase (the fused sweep tier, sweep/search.py) on the reference's
# slice (optimize_heat_ray.py:173-181: heat, 2 -> 128x3 -> 1 tanh, 10
# samples, 5 concurrent): n_iters ~ randint[1000, SWEEP_MAX_ITERS), cut from
# the reference's 50 000 to keep the smoke's time; halving over 27 heat
# trials (eta 3, budgets 500 to 15 000); FitzHugh–Nagumo's DGM (lr only,
# causal_eps 0) over 9 trials to 5 000 steps, cut from its 150 000; Fredholm
# (gauss, k = 16) on the full space at its 3 000-step budget.
SWEEP_SEED = 0
SWEEP_MAX_ITERS = 10_000
HEAT_HALVING = dict(num_samples=27, eta=3, min_budget=500,
                    max_budget=15_000)
FN_HALVING = dict(num_samples=9, eta=3, min_budget=500, max_budget=5_000)
FREDHOLM_TPE = dict(num_samples=4, max_iters=3_000)
# Check (a): a trial's score against a standalone unmasked chunk of its
# config on the first bs rows of its tile's stream (the chunk tolerance).
SWEEP_RTOL = 1e-4

# The population phase (parallel/population.py on the scan engine, since
# PR 15). (a) the reference's batch-size ablation (batchsize_effect_heat.py:
# 186-205): heat, 2 -> 128x3 -> 1 tanh, lr 1e-4, batch sizes 2^0..2^10 x 5
# runs = 55 trials of max_batch_size 1 024, its 15 000 steps cut to
# POP_STEPS; (b) batchnorm_effect, 3 populations of 5 (relu 2 -> 128x3 ->
# 1, none/pre/post, B = 64) and one pre-BN train() beside it, cut the same
# way; (c) solve("heat", engine="scan", ensemble=8) at the reference
# defaults (15 000 steps, seed 0); (d) solve("fitzhugh_nagumo",
# arch="fourier_mlp", seed=42, iterations=30 000) on the scan trainer, the
# JAX TPU smoke's configuration and bound (benchmarks/smoke_tpu.py:31-32);
# (e) the population sweeps on heat: successive_halving over 27 trials (eta
# 3, HALVING_MIN -> HALVING_MAX steps: 500 -> 4 500 on whole graph blocks,
# the 15 000 cut), random_search and
# tpe_search over 10 trials of POP_STEPS steps; (f) a ResNet on heat for
# POP_STEPS scan steps. POP_STEPS is a whole number of the population's
# and the scan trainer's graph blocks (32, 256 steps): no eager tail.
POP_STEPS = 2048
POP_SEED = 0
HALVING_MIN, HALVING_MAX = 512, 4608
POP_BOUND = 0.05
# A trial against its standalone train() (the same init, stream, lr and
# batch; the population's vmapped step and optax-form Adam against the scan
# trainer's step and torch's fused Adam): fp32 reassociation, carried over
# the steps: losses to POP_RTOL of each other. A sweep winner trains at lr
# up to 1e-1 down to losses of 1e-5, where two fp32 trajectories part
# within a few thousand steps (a first run: the halving winner's last loss
# 91 % apart after 4 500 steps, its parameters 2.7e-3): in each population
# it trained in it is re-run over its first POP_REPLAY_STEPS steps from the
# state that population started it from, and its score and parameters are
# read back exactly from its last population. A population that started
# it from its init is re-run over POP_REPLAY_STEPS steps, one that took it
# on from an earlier rung over POP_CARRIED_STEPS: over 256 steps the
# halving winner's third rung (lr 9.2e-4, losses near 4e-6) parted by
# 1.83e-2 while its first two rungs stayed within 4.2e-5.
POP_RTOL = 1e-3
POP_REPLAY_STEPS = 256
POP_CARRIED_STEPS = 64


def cuda_ms(fn, reps=REPS):
    """Mean milliseconds per call of ``fn`` on the card, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=SPIN_REPS):
    """Mean milliseconds per call of ``fn`` on the card alone, after a
    warm-up: for a call whose host work outlasts its device work, where CUDA
    events around the calls would time the host. A spin kernel holds the
    card while the host queues all ``reps`` calls, so the events time them
    back to back; it fails if the spin ended before the host was done. It
    takes no profiler, so nothing of a profiler session stays in the
    process for the solves after it."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise AssertionError("the spin kernel ended before the host had "
                             "queued the timed calls (a full launch queue "
                             "waits for it): lower SPIN_REPS or raise "
                             "SPIN_CYCLES")
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn(), its milliseconds on the card): one call between CUDA events,
    for a plain packed chunk too slow to repeat."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def check_close(name, got, want, rtol, atol):
    import torch

    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel and plain version differ by "
                             f"{max_abs(got, want):.3g} (rtol {rtol}, "
                             f"atol {atol:.3g})")


def bound(flops, nbytes):
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the HBM rate."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def n_params(D, H, L, O=1):
    return D * H + H + L * H * H + L * H + H * O + O


def step_flops(R, B, D, H, L):
    """One step of an R-stream PINN: the forward, the weight gradients and
    the data gradients (none into the input), 2 flops per multiply-add."""
    fwd = 2 * R * B * (D * H + L * H * H + H)
    return fwd + fwd + 2 * R * B * (L * H * H + H)


def chunk_bound(K, R, B, D, H, L, U, n_const=0, cross=0):
    """K steps plus Adam (about 12 flops per parameter); p, m, v read and
    written once, the uniforms and the const operand read once, K losses
    written. ``cross``: a cross-point loss's operations per step (causal
    advection's B² comparisons and their sums, 2·B²)."""
    n = n_params(D, H, L)
    return bound(K * (step_flops(R, B, D, H, L) + 12 * n + cross),
                 4 * (6 * n + K * B * U + K + n_const))


def grad_bound(R, B, D, H, L, U, n_const=0, cross=0):
    """One step: params, uniforms and the const operand read once, the
    gradient and the loss written once (``cross`` as for chunk_bound)."""
    n = n_params(D, H, L)
    return bound(step_flops(R, B, D, H, L) + cross,
                 4 * (2 * n + B * U + 1 + n_const))


def dgm_step_flops(R, B, H, L, O):
    """One DGM step (D = 1): the gate and H products forward, their weight
    and data gradients backward, the input and output layers; 2 flops per
    multiply-add, the elementwise stream rules not counted."""
    N = R * B
    fwd = 2 * N * (H + L * (3 * H * H + 3 * H + H * H + H) + H * O)
    bwd = 2 * N * (L * ((H + 1) * 3 * H + (H + 1) * H + H * H + 3 * H * H)
                   + 2 * H * O + H)
    return fwd + bwd


def dgm_n_params(H, L, O):
    return 2 * H + L * (4 * H * H + 8 * H) + H * O + O


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    print(smi.stdout.strip())
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}")


def start_build():
    """nvcc on every kernel source (one process each, all started
    together), in a thread, so that the population runs that launch no
    kernel of the repo go on meanwhile. Returns (the thread, its record)."""
    import threading

    from differential_equations_dnn_tpu_torch.kernels import build

    record = {}

    def run():
        t0 = time.perf_counter()
        try:
            build.build()
        except BaseException as err:  # re-raised by phase_build
            record["error"] = err
        record["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, record


def phase_build(builder):
    """Wait for the build, then load the library: nothing loaded it while
    it built (the runs beside it launch no kernel of the repo)."""
    from differential_equations_dnn_tpu_torch.kernels import build

    thread, record = builder
    t0 = time.perf_counter()
    thread.join()
    waited = time.perf_counter() - t0
    if "error" in record:
        raise record["error"]
    if build.library.cache_info().currsize:
        raise AssertionError("the kernels were loaded while they built")
    build.library()
    print(f"build: {record['seconds']:.2f} s (beside the population runs; "
          f"{waited:.2f} s waited for it after them) -> "
          f"{build.library_path().name}")
    log = build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  ptxas: {line.split(':', 1)[-1].strip()}")


def mlp_grid(name, D, H, L, act):
    """Kernel #2's inputs at one MLP_SHAPES row: the named grid's points
    and a D → H×L → 1 MLP from generator(1)."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.equations import PROBLEMS
    from differential_equations_dnn_tpu_torch.models import MLP, Perceptron

    dev = torch.device("cuda")
    if name == "1024x1024":
        axis = torch.linspace(0.0, 1.0, 1024, device=dev)
        x = torch.cartesian_prod(axis, axis)
    else:
        prob = PROBLEMS[name]()
        x = prob.grid_inputs(prob.defaults.nodes, device=dev)
    if name == "uat":
        return Perceptron(D, 1, H, generator=generator(1), device=dev), x
    return MLP(D, 1, H, L, act, generator=generator(1), device=dev), x


def addmm_chain(model, x):
    """#2's function as a chain of library calls: cuBLAS addmm per layer
    and tanh (TF32 is off: core.precision)."""
    import torch

    h = torch.tanh(torch.addmm(model.fc_in.b, x, model.fc_in.w))
    for l in range(model.num_layers):
        h = torch.tanh(torch.addmm(model.hidden.b[l], h, model.hidden.w[l]))
    return torch.addmm(model.fc_out.b, h, model.fc_out.w)


def check_mlp_forward():
    """Kernel #2 against its plain version at every MLP_SHAPES row, both
    timed by their device time (events around calls queued behind a spin
    kernel: one call's host work outlasts a small grid's device work).
    Returns the JSON row: heat's 40 × 40 grid through heat's default model
    (generator(1)), with every shape's numbers under "shapes", and as its
    library time the device time of :func:`addmm_chain` there."""
    import torch

    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp as tm

    shapes = []
    for name, D, H, L, act in MLP_SHAPES:
        model, x = mlp_grid(name, D, H, L, act)
        N = x.shape[0]
        label = f"{N}x{D} -> {H}x{L} -> 1, {act}"
        # Tolerance: fp32 reassociation of H-term dot products through L + 2
        # layers, outputs of order 1.
        with torch.no_grad():
            got = tm.mlp_forward(model, x)
            want = tm.mlp_forward_plain(model, x)
            check_close(f"mlp_forward [{label}]", got, want, rtol=1e-5,
                        atol=1e-5)
            kernel = lambda: tm.mlp_forward(model, x)  # noqa: E731
            plain = lambda: tm.mlp_forward_plain(model, x)  # noqa: E731
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            wall = cuda_ms(kernel)
        shapes.append(dict(
            shape=label, grid=name, max_abs_err=max_abs(got, want), ms=ms,
            plain_ms=plain_ms,
            **bound(2 * N * (D * H + L * H * H + H),
                    4 * (N * D + n_params(D, H, L) + N))))
        print(f"mlp_forward [{label}] ({name} grid): max|diff| "
              f"{shapes[-1]['max_abs_err']:.3g}; device time: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{shapes[-1]['bound_ms']:.3g} ms "
              f"({shapes[-1]['bound_by']}); per call on the stream (CUDA "
              f"events): kernel {wall:.4f} ms; plan "
              f"{tm.mlp_forward_plan(N, D, H, 1)}")
    row = next(r for r in shapes if r["shape"] == "1600x2 -> 128x3 -> 1, tanh")
    model, x = mlp_grid(*MLP_SHAPES[1])
    with torch.no_grad():
        # The same function to fp32 reassociation (tolerance as above).
        check_close("addmm chain", addmm_chain(model, x),
                    tm.mlp_forward_plain(model, x), rtol=1e-5, atol=1e-5)
        library_ms = device_ms(lambda: addmm_chain(model, x))
    print(f"mlp_forward's library yardstick (cuBLAS addmm + tanh, TF32 off) "
          f"at the heat grid: device time {library_ms:.4f} ms")
    return dict(name="mlp_forward", route="cuda",
                source=f"{PKG}/csrc/mlp_forward.cu",
                replaces=f"{JAX_KERNELS}/taylor_mlp.py:195",
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], library_ms=library_ms,
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                shapes=shapes)


def check_heat_kernels(model):
    """Kernel #1 at the heat route's shapes."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import step_uniforms
    from differential_equations_dnn_tpu_torch.kernels import fused_train as ft

    dev = torch.device("cuda")
    rows = []
    # One step's loss and gradient (the training kernel without Adam) at
    # B=64. Tolerance: fp32 reassociation of the 448-row weight-gradient
    # sums; each gradient tensor is held to 1e-5 of its own largest entry.
    p = ft.pack_params(model)
    u = step_uniforms(0, 0, 1, 64, dev)[0]
    loss_k, grad_k = ft.heat_loss_grad(model, p, u)
    loss_p, grad_p = ft.heat_loss_grad_plain(model, p, u)
    check_close("step loss", loss_k, loss_p, rtol=1e-5, atol=0.0)
    for name, gk, gp in zip(("w_in", "b_in", "w_hid", "b_hid", "w_out",
                             "b_out"), ft.unpack_params(model, grad_k),
                            ft.unpack_params(model, grad_p)):
        check_close(f"grad {name}", gk, gp, rtol=1e-4,
                    atol=1e-5 * float(gp.abs().max()))
    ms = cuda_ms(lambda: ft.heat_loss_grad(model, p, u))
    plain_ms = cuda_ms(lambda: ft.heat_loss_grad_plain(model, p, u))
    print(f"heat step loss+grad [B=64, H=128, L=3]: loss {float(loss_k):.6g} "
          f"vs {float(loss_p):.6g}, max|dgrad| {max_abs(grad_k, grad_p):.3g}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # K Adam steps. Tolerances: the loss history to fp32 reassociation
    # (rtol 1e-4 after K steps); parameters to rtol 1e-4 plus 2·lr, since an
    # Adam step on a gradient within rounding of zero can move a parameter
    # by up to 2·lr in either implementation.
    lr = 1e-4
    zeros = torch.zeros_like(p)
    uk = step_uniforms(0, 0, CHUNK_STEPS, 64, dev)
    pk, mk, vk, lk = ft.heat_fused_train_chunk(model, p, zeros, zeros, uk, 0,
                                               lr)
    pp, mp, vp, lp = ft.heat_fused_train_chunk_plain(model, p, zeros, zeros,
                                                     uk, 0, lr)
    check_close("chunk losses", lk, lp, rtol=1e-4, atol=0.0)
    check_close("chunk params", pk, pp, rtol=1e-4, atol=2 * lr)
    ms = cuda_ms(lambda: ft.heat_fused_train_chunk(model, p, zeros, zeros,
                                                   uk, 0, lr))
    plain_ms = cuda_ms(lambda: ft.heat_fused_train_chunk_plain(
        model, p, zeros, zeros, uk, 0, lr), reps=PLAIN_REPS)
    n_far = int(((pk - pp).abs() > 1e-5).sum())
    rows.append(dict(
        name="heat_fused_train_chunk", route="cuda",
        source=f"{PKG}/csrc/heat_train.cu",
        replaces=f"{JAX_KERNELS}/fused_train.py:237",
        max_abs_err=max(max_abs(lk, lp), max_abs(pk, pp)), ms=ms,
        plain_ms=plain_ms, library_ms=None,
        **chunk_bound(CHUNK_STEPS, 7, 64, 2, 128, 3, 2)))
    print(f"heat_fused_train_chunk [K={CHUNK_STEPS}, B=64]: max|dloss| "
          f"{max_abs(lk, lp):.3g}, max|dparam| {max_abs(pk, pp):.3g} "
          f"({n_far} of {p.numel()} params differ by > 1e-5); kernel "
          f"{ms:.4f} ms ({ms / CHUNK_STEPS * 1e3:.1f} us/step), plain "
          f"{plain_ms:.4f} ms ({plain_ms / CHUNK_STEPS * 1e3:.1f} us/step)")

    # The same chunk at H = HEAT_WIDE, a width the first design refused;
    # the same tolerances.
    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.models import MLP

    wide = MLP(2, 1, HEAT_WIDE, 3, "tanh", generator=generator(1), device=dev)
    pw = ft.pack_params(wide)
    zw = torch.zeros_like(pw)
    pk, _, _, lk = ft.heat_fused_train_chunk(wide, pw, zw, zw, uk, 0, lr)
    pp, _, _, lp = ft.heat_fused_train_chunk_plain(wide, pw, zw, zw, uk, 0,
                                                   lr)
    check_close(f"chunk losses H={HEAT_WIDE}", lk, lp, rtol=1e-4, atol=0.0)
    check_close(f"chunk params H={HEAT_WIDE}", pk, pp, rtol=1e-4,
                atol=2 * lr)
    ms = cuda_ms(lambda: ft.heat_fused_train_chunk(wide, pw, zw, zw, uk, 0,
                                                   lr))
    print(f"heat_fused_train_chunk [K={CHUNK_STEPS}, B=64, H={HEAT_WIDE}]: "
          f"max|dloss| {max_abs(lk, lp):.3g}, max|dparam| "
          f"{max_abs(pk, pp):.3g}; kernel {ms:.4f} ms "
          f"({ms / CHUNK_STEPS * 1e3:.1f} us/step)")
    return rows


def check_heat_streams():
    """Kernel #3 against its plain version: at heat's shape (B = 64, H =
    128, L = 3, tanh; the JSON row) and at a ragged B = 1000 for each
    activation, all seven streams; then the gradient of the pallas-taps
    loss through the kernel's Function against the Taylor taps' autograd.
    Returns the kernel's row."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp as tm
    from differential_equations_dnn_tpu_torch.models import MLP

    dev = torch.device("cuda")
    H, L, O = 128, 3, 1
    row = None
    for act, B in [("tanh", 64)] + [(a, 1000) for a in ACTIVATIONS]:
        model = MLP(2, O, H, L, act, generator=generator(1), device=dev)
        b = Heat1D().sample(B, generator(2), dev)
        pts = (b["xt"], b["x0"], b["xb1"], b["xb2"])
        # Tolerance: the JAX package's for its kernel against the plain
        # streams (tests/test_kernels.py:45-53), fp32 reassociation of
        # 128-term dot products through 4 layers.
        with torch.no_grad():
            got = tm.heat_fused_streams(model, *pts)
            want = tm.heat_fused_streams_plain(model, *pts)
            for s, (g, w) in enumerate(zip(got, want)):
                check_close(f"heat_fused_streams {act} B={B} stream {s}", g,
                            w, rtol=1e-5, atol=1e-5)
            err = max(max_abs(g, w) for g, w in zip(got, want))
            # One call's device work (tens of microseconds) is shorter than
            # its host work, so the row takes the device time of each; the
            # CUDA-event time per call is printed beside it.
            kernel = lambda: tm.heat_fused_streams(model, *pts)  # noqa: E731
            plain = lambda: tm.heat_fused_streams_plain(  # noqa: E731
                model, *pts)
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            wall, plain_wall = cuda_ms(kernel), cuda_ms(plain)
        print(f"heat_fused_streams [{act}, B={B}, H={H}, L={L}]: max|diff| "
              f"{err:.3g}; device time: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; per call on the stream (CUDA events): "
              f"kernel {wall:.4f} ms, plain {plain_wall:.4f} ms")
        if row is None:
            row = dict(
                name="heat_fused_streams", route="cuda",
                source=f"{PKG}/csrc/heat_streams.cu",
                replaces=f"{JAX_KERNELS}/taylor_mlp.py:65",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound(2 * 7 * B * (2 * H + L * H * H + H * O),
                        4 * (4 * B * 2 + n_params(2, H, L, O) + 7 * B * O)))
            print(f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    # Widths past the first design's H = 191, at heat's batch, with the
    # same tolerance.
    for H_wide in STREAMS_WIDE:
        for act in ACTIVATIONS:
            model = MLP(2, O, H_wide, L, act, generator=generator(1),
                        device=dev)
            b = Heat1D().sample(64, generator(2), dev)
            pts = (b["xt"], b["x0"], b["xb1"], b["xb2"])
            with torch.no_grad():
                got = tm.heat_fused_streams(model, *pts)
                want = tm.heat_fused_streams_plain(model, *pts)
            for s, (g, w) in enumerate(zip(got, want)):
                check_close(f"heat_fused_streams {act} H={H_wide} stream "
                            f"{s}", g, w, rtol=1e-5, atol=1e-5)
            ms = device_ms(lambda: tm.heat_fused_streams(model, *pts))
            print(f"heat_fused_streams [{act}, B=64, H={H_wide}, L={L}]: "
                  f"max|diff| "
                  f"{max(max_abs(g, w) for g, w in zip(got, want)):.3g}; "
                  f"device time {ms:.4f} ms; plan "
                  f"{tm.heat_streams_plan(H_wide, O)}")
    # The gradient through the Function's rematerialised backward against
    # autograd through the Taylor taps, at heat's shape. Tolerance: rtol
    # 1e-4 / atol 1e-6, the two forwards differing by fp32 reassociation.
    model = Heat1D().default_model(generator=generator(1), device=dev)
    b = Heat1D().sample(64, generator(2), dev)
    params = list(model.parameters())
    grads = [torch.autograd.grad(Heat1D(taps=taps).loss(model, b), params)
             for taps in ("pallas", "taylor")]
    for gp, gt in zip(*grads):
        check_close("heat_fused_streams gradient", gp, gt, rtol=1e-4,
                    atol=1e-6)
    print(f"heat pallas-taps gradient vs taylor taps: max|diff| "
          f"{max(max_abs(a, c) for a, c in zip(*grads)):.3g}")
    return row


def trial_streams(model, plain=False):
    """``fn(stacked, points)``: kernel #3's wrapper (or its plain version)
    over the trials of ``stacked`` weights of ``model``'s architecture,
    through ``functional_call`` under ``torch.func.vmap``, as the
    population trainer calls it."""
    import torch

    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp as tm

    class Streams(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, *points):
            fn = (tm.heat_fused_streams_plain if plain
                  else tm.heat_fused_streams)
            return fn(self.model, *points)

    mod = Streams()
    return lambda stacked, points: torch.func.vmap(
        lambda p, *x: torch.func.functional_call(
            mod, {f"model.{k}": v for k, v in p.items()}, x))(stacked,
                                                               *points)


def check_heat_streams_trials():
    """Kernel #3 over T trials in one launch (grid y = T), at each
    STREAM_TRIALS shape: each trial bit for bit its own one-trial launch,
    and within #3's tolerance of the plain version (vmapped over the
    trials). The T = 8, B = 64 shape (the population's) timed by device
    time beside its bound; returns its row."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp as tm
    from differential_equations_dnn_tpu_torch.models import MLP

    dev = torch.device("cuda")
    L, O = 3, 1
    keys = ("xt", "x0", "xb1", "xb2")
    row = None
    for T, B, H in STREAM_TRIALS:
        models = [MLP(2, O, H, L, "tanh", generator=generator(10 + t),
                      device=dev) for t in range(T)]
        stacked = {k: torch.stack([dict(m.named_parameters())[k].detach()
                                   for m in models])
                   for k, _ in models[0].named_parameters()}
        batches = [Heat1D().sample(B, generator(20 + t), dev)
                   for t in range(T)]
        pts = [torch.stack([b[k] for b in batches]) for k in keys]
        kernel_fn, plain_fn = (trial_streams(models[0], plain)
                               for plain in (False, True))
        with torch.no_grad():
            before = tm.heat_fused_streams.launches
            got = kernel_fn(stacked, pts)
            if tm.heat_fused_streams.launches - before != 1:
                raise AssertionError(f"heat_fused_streams T={T}: not one "
                                     f"launch for {T} trials")
            want = plain_fn(stacked, pts)
            for t, model in enumerate(models):
                one = tm.heat_fused_streams(model, *(p[t] for p in pts))
                for s, (g, o) in enumerate(zip(got, one)):
                    if not torch.equal(g[t], o):
                        raise AssertionError(
                            f"heat_fused_streams T={T} B={B} H={H}: trial "
                            f"{t} stream {s} differs from its one-trial "
                            f"launch (max {max_abs(g[t], o):.3g})")
            # Tolerance: #3's against its plain streams (check_heat_streams).
            for s, (g, w) in enumerate(zip(got, want)):
                check_close(f"heat_fused_streams T={T} B={B} H={H} stream "
                            f"{s}", g, w, rtol=1e-5, atol=1e-5)
            err = max(max_abs(g, w) for g, w in zip(got, want))
            ms = device_ms(lambda: kernel_fn(stacked, pts))
            plain_ms = device_ms(lambda: plain_fn(stacked, pts))
        flops = 2 * 7 * B * T * (2 * H + L * H * H + H * O)
        nbytes = 4 * T * (4 * B * 2 + n_params(2, H, L, O) + 7 * B * O)
        b = bound(flops, nbytes)
        print(f"heat_fused_streams trial axis [T={T}, B={B}, H={H}, L={L}]: "
              f"each trial bit for bit its one-trial launch; max|diff| from "
              f"the plain version {err:.3g}; device time: kernel {ms:.4f} "
              f"ms, plain (vmapped) {plain_ms:.4f} ms; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        if row is None:
            row = dict(name="heat_fused_streams[trials]", route="cuda",
                       source=f"{PKG}/csrc/heat_streams.cu",
                       replaces=f"{JAX_KERNELS}/taylor_mlp.py:65 "
                                f"(under jax.vmap, call :134)",
                       trials=T, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=None, **b)
    return row


def check_engine_kernels(name, hard=False, causal=False):
    """Kernels #6 and #4 (and #2 on the equation's grid) at one spec's
    default shapes, with the spec's const operand where it has one; for the
    LAST, the hard and the causal specs also the per-step time of a
    STEADY_STEPS-step chunk. ``hard`` takes the equation's hard spec (its
    model a HardConstraint, #2 on its raw net), ``causal`` advection's
    causal spec at CAUSAL (its cross-point loss kernel). Returns the rows of
    the two engine kernels."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import (
        generator,
        step_uniforms,
    )
    from differential_equations_dnn_tpu_torch.equations import PROBLEMS
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp as tm

    dev = torch.device("cuda")
    variant = ({"constraint": "hard"} if hard else CAUSAL if causal else {})
    prob = PROBLEMS[name](**variant)
    spec = fe.spec_for(prob)
    model = prob.default_model(generator=generator(1), device=dev)
    d = prob.defaults
    R, B, U = fe._n_rows(spec.groups), d.batch_size, spec.n_uniform
    cross = 2 * B * B if causal else 0
    D, H, L = spec.dims(model)
    const = spec.make_const(B, dev)
    n_const = 0 if const is None else const.numel()
    shape = (f"R={R}, B={B}, D={D}, H={H}, L={L}, U={U}"
             + (f", kernel streams {spec.kernel_streams}"
                if spec.kernel_streams != R else ""))

    # The evaluation grid through mlp_forward (tolerance as for heat's); a
    # HardConstraint's raw net, as Problem.evaluate runs it.
    x = prob.grid_inputs(d.nodes, device=dev)
    net = model.net if hard else model
    with torch.no_grad():
        check_close(f"{name} mlp_forward", tm.mlp_forward(net, x),
                    tm.mlp_forward_plain(net, x), rtol=1e-5, atol=1e-5)
    if hard:
        name = f"{name} (hard)"
    if causal:
        name = f"{name} (causal)"

    # One step's loss and gradient. Tolerance: fp32 reassociation of the
    # R·B-row sums; the loss to rtol 1e-5, each gradient tensor to 1e-5 of
    # its own largest entry.
    p = fe.pack_state(spec, model)
    u = step_uniforms(0, STEP0, CHUNK_STEPS, B, dev, U)
    loss_k, grad_k = fe.engine_loss_grad(spec, model, p, u[0], const)
    loss_p, grad_p = fe.engine_loss_grad_plain(spec, model, p, u[0], const)
    check_close(f"{name} step loss", loss_k, loss_p, rtol=1e-5, atol=0.0)
    parts = ("w_in", "b_in", "w_hid", "b_hid", "w_out", "b_out",
             "log_kappa")
    for part, gk, gp in zip(parts, fe.unpack_state(spec, model, grad_k),
                            fe.unpack_state(spec, model, grad_p)):
        if gp.numel():  # uat's hidden stack has none
            check_close(f"{name} grad {part}", gk, gp, rtol=1e-4,
                        atol=1e-5 * float(gp.abs().max()))
    ms = cuda_ms(lambda: fe.engine_loss_grad(spec, model, p, u[0], const))
    plain_ms = cuda_ms(lambda: fe.engine_loss_grad_plain(spec, model, p,
                                                         u[0], const))
    grad_row = dict(
        name="engine_loss_grad", route="cuda",
        source=f"{PKG}/csrc/engine_train.cu",
        replaces=f"{JAX_KERNELS}/fused_engine.py:235",
        max_abs_err=max(max_abs(loss_k, loss_p), max_abs(grad_k, grad_p)),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **grad_bound(R, B, D, H, L, U, n_const, cross))
    print(f"{name} engine_loss_grad [{shape}]: loss {float(loss_k):.6g} vs "
          f"{float(loss_p):.6g}, max|dgrad| {max_abs(grad_k, grad_p):.3g}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{grad_row['bound_ms']:.4g} ms ({grad_row['bound_by']})")

    # K Adam steps from STEP0 under the equation's default schedule
    # (exponential for burgers, so that all three schedules run) over a
    # horizon of HORIZON steps, so that a decaying lr is 0.55-0.23 (cosine)
    # or 0.32-0.18 (exponential) of the constant one over the chunk and a
    # kernel that got the schedule wrong fails. Tolerances as for the heat
    # chunk: losses rtol 1e-4; parameters rtol 1e-4 plus 2·lr, since an
    # Adam step on a gradient within rounding of zero can move a parameter
    # by up to 2·lr.
    lr = d.lrate
    kw = dict(schedule="exponential" if name == "burgers" else d.schedule,
              total_steps=HORIZON, const=const)
    zeros = torch.zeros_like(p)
    pk, mk, vk, lk = fe.fused_engine_chunk(spec, model, p, zeros, zeros, u,
                                           STEP0, lr, **kw)
    pp, mp, vp, lp = fe.fused_engine_chunk_plain(spec, model, p, zeros,
                                                 zeros, u, STEP0, lr, **kw)
    check_close(f"{name} chunk losses", lk, lp, rtol=1e-4, atol=0.0)
    check_close(f"{name} chunk params", pk, pp, rtol=1e-4, atol=2 * lr)
    ms = cuda_ms(lambda: fe.fused_engine_chunk(spec, model, p, zeros, zeros,
                                               u, STEP0, lr, **kw))
    plain_ms = cuda_ms(lambda: fe.fused_engine_chunk_plain(
        spec, model, p, zeros, zeros, u, STEP0, lr, **kw), reps=PLAIN_REPS)
    chunk_row = dict(
        name="fused_engine_chunk", route="cuda",
        source=f"{PKG}/csrc/engine_train.cu",
        replaces=f"{JAX_KERNELS}/engine_core.py:48",
        max_abs_err=max(max_abs(lk, lp), max_abs(pk, pp)), ms=ms,
        plain_ms=plain_ms, library_ms=None,
        **chunk_bound(CHUNK_STEPS, R, B, D, H, L, U, n_const, cross))
    print(f"{name} fused_engine_chunk [K={CHUNK_STEPS}, {kw['schedule']}]: "
          f"max|dloss| {max_abs(lk, lp):.3g}, max|dparam| "
          f"{max_abs(pk, pp):.3g}; kernel {ms:.4f} ms "
          f"({ms / CHUNK_STEPS * 1e3:.1f} us/step), plain {plain_ms:.4f} ms "
          f"({plain_ms / CHUNK_STEPS * 1e3:.1f} us/step); bound "
          f"{chunk_row['bound_ms']:.4f} ms ({chunk_row['bound_by']})")
    if name == "heat2d":
        steady_state(name, spec, model, p[None], B, 1, lr, kw)
        check_wide_engine(name, spec, u, lr, kw)
    if name in LAST or hard or causal:
        steady_ms = steady_state(name, spec, model, p[None], B, 1, lr, kw)
        chunk_row.update(
            steady_steps=STEADY_STEPS, steady_ms=steady_ms,
            steady_bound_ms=chunk_bound(STEADY_STEPS, R, B, D, H, L, U,
                                        n_const, cross)["bound_ms"])
        for row in (grad_row, chunk_row):
            row.update(spec=prob.name, shape=shape, **variant)
    return grad_row, chunk_row


def check_wide_engine(name, spec, u, lr, kw, hidden=256):
    """A CHUNK_STEPS-step chunk of NAME at hidden width 256 (a width the
    MLP engine's first design refused for heat2d's 11 streams) against its
    plain version, tolerances as for the default width."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
    from differential_equations_dnn_tpu_torch.kernels import fused_train as ft
    from differential_equations_dnn_tpu_torch.models import MLP

    model = MLP(spec.input_dim, 1, hidden, 3, "tanh", generator=generator(1),
                device=u.device)
    p = ft.pack_params(model)
    z = torch.zeros_like(p)
    pk, _, _, lk = fe.fused_engine_chunk(spec, model, p, z, z, u, STEP0, lr,
                                         **kw)
    pp, _, _, lp = fe.fused_engine_chunk_plain(spec, model, p, z, z, u,
                                               STEP0, lr, **kw)
    check_close(f"{name} H={hidden} chunk losses", lk, lp, rtol=1e-4,
                atol=0.0)
    check_close(f"{name} H={hidden} chunk params", pk, pp, rtol=1e-4,
                atol=2 * lr)
    ms = cuda_ms(lambda: fe.fused_engine_chunk(spec, model, p, z, z, u,
                                               STEP0, lr, **kw))
    print(f"{name} fused_engine_chunk at H={hidden} [K={CHUNK_STEPS}]: "
          f"max|dloss| {max_abs(lk, lp):.3g}, max|dparam| "
          f"{max_abs(pk, pp):.3g}; kernel {ms:.4f} ms "
          f"({ms / CHUNK_STEPS * 1e3:.1f} us/step)")


def check_dgm_kernels(name):
    """Kernels #7 and #4 (the DGM layout) at one DGM equation's default
    shapes. Returns the rows of the two kernels."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import (
        generator,
        step_uniforms,
    )
    from differential_equations_dnn_tpu_torch.equations import PROBLEMS
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd

    dev = torch.device("cuda")
    prob = PROBLEMS[name]()
    d = prob.defaults
    B = d.batch_size
    spec = fd.spec_for(prob, B)
    const = fd.const_for(spec, prob, B, dev)
    model = prob.default_model(generator=generator(1), device=dev)
    R, _ = fd._layout(spec)
    H, L, O = model.hidden_size, model.num_layers, model.output_dim
    n = dgm_n_params(H, L, O)
    n_const = 0 if const is None else const.numel()
    shape = f"R={R}, B={B}, H={H}, L={L}, O={O}, {spec.act}"

    # One step's loss and gradient. Tolerance: fp32 reassociation of the
    # R·B-row sums; the loss to rtol 1e-5, each gradient tensor to 1e-5 of
    # its own largest entry.
    p = fd.pack_dgm(model)
    u = step_uniforms(0, STEP0, CHUNK_STEPS, B, dev, spec.n_uniform)
    loss_k, grad_k = fd.dgm_loss_grad(spec, model, p, u[0], const)
    loss_p, grad_p = fd.dgm_loss_grad_plain(spec, model, p, u[0], const)
    check_close(f"{name} step loss", loss_k, loss_p, rtol=1e-5, atol=0.0)
    for part, gk, gp in zip(("w_in", "b_in", "Wzgr", "Uzgr", "bzgr", "Wh",
                             "Uh", "bh", "w_out", "b_out"),
                            fd.unpack_dgm(model, grad_k),
                            fd.unpack_dgm(model, grad_p)):
        check_close(f"{name} grad {part}", gk, gp, rtol=1e-4,
                    atol=1e-5 * float(gp.abs().max()))
    ms = cuda_ms(lambda: fd.dgm_loss_grad(spec, model, p, u[0], const))
    plain_ms = cuda_ms(lambda: fd.dgm_loss_grad_plain(spec, model, p, u[0],
                                                      const))
    grad_row = dict(
        name="dgm_loss_grad", route="cuda",
        source=f"{PKG}/csrc/dgm_train.cu",
        replaces=f"{JAX_KERNELS}/fused_dgm.py:197",
        max_abs_err=max(max_abs(loss_k, loss_p), max_abs(grad_k, grad_p)),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(dgm_step_flops(R, B, H, L, O),
                4 * (2 * n + B + n_const + 1)))
    print(f"{name} dgm_loss_grad [{shape}]: loss {float(loss_k):.6g} vs "
          f"{float(loss_p):.6g}, max|dgrad| {max_abs(grad_k, grad_p):.3g}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # K Adam steps from STEP0 under a cosine schedule over HORIZON steps
    # (lr 0.55-0.23 of constant across the chunk, so a kernel that got the
    # schedule wrong fails), with Fredholm's const. Tolerances as for the
    # engine chunks: losses rtol 1e-4; parameters rtol 1e-4 plus 2·lr.
    lr = d.lrate
    kw = dict(const=const, schedule="cosine", total_steps=HORIZON)
    zeros = torch.zeros_like(p)
    pk, mk, vk, lk = fd.fused_dgm_chunk(spec, model, p, zeros, zeros, u,
                                        STEP0, lr, **kw)
    pp, mp, vp, lp = fd.fused_dgm_chunk_plain(spec, model, p, zeros, zeros,
                                              u, STEP0, lr, **kw)
    check_close(f"{name} chunk losses", lk, lp, rtol=1e-4, atol=0.0)
    check_close(f"{name} chunk params", pk, pp, rtol=1e-4, atol=2 * lr)
    ms = cuda_ms(lambda: fd.fused_dgm_chunk(spec, model, p, zeros, zeros, u,
                                            STEP0, lr, **kw))
    plain_ms = cuda_ms(lambda: fd.fused_dgm_chunk_plain(
        spec, model, p, zeros, zeros, u, STEP0, lr, **kw), reps=PLAIN_REPS)
    chunk_row = dict(
        name="fused_dgm_chunk", route="cuda",
        source=f"{PKG}/csrc/dgm_train.cu",
        replaces=f"{JAX_KERNELS}/engine_core.py:48",
        max_abs_err=max(max_abs(lk, lp), max_abs(pk, pp)), ms=ms,
        plain_ms=plain_ms, library_ms=None,
        **bound(CHUNK_STEPS * (dgm_step_flops(R, B, H, L, O) + 12 * n),
                4 * (6 * n + CHUNK_STEPS * B + CHUNK_STEPS + n_const)))
    print(f"{name} fused_dgm_chunk [K={CHUNK_STEPS}, cosine]: max|dloss| "
          f"{max_abs(lk, lp):.3g}, max|dparam| {max_abs(pk, pp):.3g}; kernel "
          f"{ms:.4f} ms ({ms / CHUNK_STEPS * 1e3:.1f} us/step), plain "
          f"{plain_ms:.4f} ms ({plain_ms / CHUNK_STEPS * 1e3:.1f} us/step); "
          f"bound {chunk_row['bound_ms']:.4f} ms ({chunk_row['bound_by']})")
    if name == "fitzhugh_nagumo":
        steady_state(name, spec, model, p[None], B, 1, lr, kw)
    return grad_row, chunk_row


def steady_state(name, spec, model, p, B, n_replicas, lr, kw):
    """Milliseconds of a STEADY_STEPS-step chunk (20 replays of the captured
    graph) of N replicas on NAME's engine, after a warm-up call, and the µs
    per step."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import step_uniforms
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe

    u = step_uniforms(0, STEP0, STEADY_STEPS, B, p.device, spec.n_uniform)
    z = torch.zeros_like(p)
    single, packed = ((fd.fused_dgm_chunk, fd.fused_dgm_packed_chunk)
                      if name in DGM else
                      (fe.fused_engine_chunk, fe.fused_engine_packed_chunk))
    if n_replicas == 1:
        run = lambda: single(  # noqa: E731
            spec, model, p[0], z[0], z[0], u, STEP0, lr, **kw)
    else:
        run = lambda: packed(  # noqa: E731
            spec, model, p, z, z, u, STEP0, lr, n_replicas, **kw)
    ms = cuda_ms(run, reps=STEADY_REPS)
    print(f"{name} steady state [N={n_replicas}, K={STEADY_STEPS}]: "
          f"{ms:.4f} ms per chunk, {ms / STEADY_STEPS * 1e3:.2f} us per "
          f"{'packed ' if n_replicas > 1 else ''}step")
    return ms


def check_packed_kernels(name, n_replicas, loss_rtol, hard=False,
                         causal=False):
    """Kernel #5 at one ensemble's shapes: the packed chunk (N replicas
    drawn from replica_generator(0, r), CHUNK_STEPS steps from STEP0 under a
    cosine schedule over HORIZON steps, so a wrong schedule fails): every
    replica against the single-replica chunk on its own state, bit for bit,
    then all against the plain version (the losses to ``loss_rtol``, or,
    where it is None, each replica's loss drift printed).
    ``hard`` takes the equation's hard spec, ``causal`` advection's causal
    spec at CAUSAL. Returns the kernel's row."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import (
        replica_generator,
        step_uniforms,
    )
    from differential_equations_dnn_tpu_torch.equations import PROBLEMS
    from differential_equations_dnn_tpu_torch.kernels import engine_core
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
    from differential_equations_dnn_tpu_torch.kernels import fused_train as ft

    dev = torch.device("cuda")
    variant = ({"constraint": "hard"} if hard else CAUSAL if causal else {})
    prob = PROBLEMS[name](**variant)
    d = prob.defaults
    B, lr, N = d.batch_size, d.lrate, n_replicas
    models = [prob.default_model(generator=replica_generator(0, r),
                                 device=dev) for r in range(N)]
    model = models[0]
    H, L = model.hidden_size, model.num_layers
    kw = dict(schedule="cosine", total_steps=HORIZON)
    if name in DGM:
        spec = fd.spec_for(prob, B)
        kw["const"] = fd.const_for(spec, prob, B, dev)
        R, _ = fd._layout(spec)
        O = model.output_dim
        n = dgm_n_params(H, L, O)
        n_const = 0 if kw["const"] is None else kw["const"].numel()
        flops = dgm_step_flops(R, B, H, L, O)
        in_bytes = 4 * (CHUNK_STEPS * B + n_const)
        pack, packed, plain, single = (
            fd.pack_dgm, fd.fused_dgm_packed_chunk,
            fd.fused_dgm_packed_chunk_plain, fd.fused_dgm_chunk)
        row_name, source = "fused_dgm_packed_chunk", "dgm_train.cu"
        shape = f"R={R}, B={B}, H={H}, L={L}, O={O}, {spec.act}"
    else:
        spec = fe.spec_for(prob)
        R, D = fe._n_rows(spec.groups), model.input_dim
        n = n_params(D, H, L)
        flops = step_flops(R, B, D, H, L) + (2 * B * B if causal else 0)
        in_bytes = 4 * CHUNK_STEPS * B * spec.n_uniform
        pack, packed, plain, single = (
            (lambda m: fe.pack_state(spec, m)) if hard else ft.pack_params,
            fe.fused_engine_packed_chunk,
            fe.fused_engine_packed_chunk_plain, fe.fused_engine_chunk)
        row_name, source = "fused_engine_packed_chunk", "engine_train.cu"
        shape = f"R={R}, B={B}, D={D}, H={H}, L={L}"
        if hard:
            name = f"{name} (hard)"
        if causal:
            name = f"{name} (causal)"
    label = f"{name} {row_name} [N={N}, {shape}, K={CHUNK_STEPS}, cosine]"
    p = engine_core.stack_replicas([pack(m) for m in models])
    z = torch.zeros_like(p)
    u = step_uniforms(0, STEP0, CHUNK_STEPS, B, dev, spec.n_uniform)

    def run():
        return packed(spec, model, p, z, z, u, STEP0, lr, N, **kw)

    pk, mk, vk, lk = run()
    # Every replica runs the single-replica code on its own copy, so it
    # must equal the one-replica chunk on its state exactly.
    for r in range(N):
        p1, m1, v1, l1 = single(spec, model, p[r].contiguous(),
                                z[r].clone(), z[r].clone(), u, STEP0, lr,
                                **kw)
        if not (torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
                and torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])):
            raise AssertionError(f"{label}: packed replica {r} differs from "
                                 f"the single-replica chunk")
    ms = cuda_ms(run)
    # Tolerances: the losses to loss_rtol; parameters to rtol 1e-4 plus
    # 2·lr, as for the single chunks (an Adam step on a gradient within
    # rounding of zero can move a parameter by up to 2·lr).
    (pp, _, _, lp), plain_ms = timed_once(
        lambda: plain(spec, model, p, z, z, u, STEP0, lr, N, **kw))
    if loss_rtol is not None:
        check_close(f"{name} packed losses", lk, lp, rtol=loss_rtol, atol=0.0)
    check_close(f"{name} packed params", pk, pp, rtol=1e-4, atol=2 * lr)
    step_us = ms / CHUNK_STEPS * 1e3
    row = dict(
        name=row_name, route="cuda", source=f"{PKG}/csrc/{source}",
        replaces=f"{JAX_KERNELS}/engine_core.py:202",
        max_abs_err=max(max_abs(lk, lp), max_abs(pk, pp)), ms=ms,
        plain_ms=plain_ms, library_ms=None,
        **bound(N * CHUNK_STEPS * (flops + 12 * n),
                in_bytes + 4 * N * (6 * n + CHUNK_STEPS)))
    if hard or causal:
        row.update(spec=prob.name, shape=shape, **variant)
    print(f"{label}: max|dloss| {max_abs(lk, lp):.3g}, max|dparam| "
          f"{max_abs(pk, pp):.3g}; all {N} replicas equal the single chunk "
          f"bit for bit; kernel {ms:.4f} ms ({step_us:.1f} us per packed "
          f"step, {step_us / N:.2f} us per replica-step), plain "
          f"{plain_ms:.4f} ms; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})")
    if name in ("fitzhugh_nagumo", "wave"):
        steady_state(name, spec, model, p, B, N, lr, kw)
    for r in range(N):
        drift = (lk[r] - lp[r]).abs()
        rel = drift / lp[r].abs()
        k = int(drift.argmax())
        print(f"  replica {r}: max|dloss| {float(drift[k]):.3g} at step "
              f"{STEP0 + k + 1} (loss {float(lp[r, k]):.6g}), max relative "
              f"{float(rel.max()):.3g}, final loss {float(lp[r, -1]):.6g}, "
              f"max|dparam| {max_abs(pk[r], pp[r]):.3g}")
    return row


def bound_bf16(product_flops, other_flops, nbytes):
    """The least time the card could take at "default": the products on the
    bf16 tensor cores, the rest (the stream rules, Adam) on the fp32
    pipes, against the bytes over the HBM rate."""
    t_ops = product_flops / BF16_FLOPS + other_flops / FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def rel_l2(a, b) -> float:
    """|a − b| / |b|; 0 where both are zero."""
    diff, ref = float((a - b).norm()), float(b.norm())
    return diff / ref if ref else (0.0 if diff == 0 else math.inf)


MLP_TENSORS = ("w_in", "b_in", "w_h", "b_h", "w_out", "b_out")
DGM_TENSORS = ("s_in.w", "s_in.b", "Wzgr", "Uzgr", "bzgr", "Wh", "Uh", "bh",
               "s_out.w", "s_out.b")


def bf16_tensors(c, flat):
    """{name: tensor} of case c's trainable tensors inside a flat gradient
    or update ([P]; packed [N, P]: each tensor over all N replicas); the
    empty tensors of an L = 0 layout left out."""
    import torch

    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
    from differential_equations_dnn_tpu_torch.kernels import fused_train as ft

    unpack = {"heat": lambda x: ft.unpack_params(c["model"], x),
              "engine": lambda x: fe.unpack_state(c["spec"], c["model"], x),
              "dgm": lambda x: fd.unpack_dgm(c["model"], x)}[c["route"]]
    tensors = (unpack(flat) if flat.dim() == 1 else
               [torch.stack(ts) for ts in zip(*map(unpack, flat))])
    names = DGM_TENSORS if c["route"] == "dgm" else MLP_TENSORS
    return {names[i] if i < len(names) else f"extra{i - len(names)}": t
            for i, t in enumerate(tensors) if t.numel()}


def bf16_readings(c, got, plain, highest):
    """{name: (relative L2 of got against plain, against highest, entries
    per replica)} over case c's tensors."""
    g, p, h = (bf16_tensors(c, x) for x in (got, plain, highest))
    return {k: (rel_l2(g[k], p[k]), rel_l2(g[k], h[k]),
                g[k].numel() // c["N"]) for k in g}


def check_by_tensor(label, what, readings, tol, separation, min_entries=1):
    """Print each tensor's relative L2 against the plain version and against
    the kernel's own "highest"; fail unless every tensor of at least
    min_entries entries lies within tol of the plain version and at least
    ``separation`` times as far from "highest". Returns (the largest
    distance from the plain version, the smallest from "highest") of the
    tensors checked."""
    print(f"{label} {what} by tensor, relative L2 against the plain version "
          f"/ against \"highest\" (tolerance {tol}, separation "
          f"{separation}x, tensors of at least {min_entries} entries): "
          + ", ".join(f"{k} {m:.3g} / {h:.3g}"
                      for k, (m, h, _) in readings.items()))
    held = {k: r for k, r in readings.items() if r[2] >= min_entries}
    bad = [k for k, (m, h, _) in held.items()
           if not (m <= tol and separation * m < h)]
    if bad:
        raise AssertionError(f"{label}: {what} outside its tolerance at "
                             f"{bad}")
    return (max(m for m, _, _ in held.values()),
            min(h for _, h, _ in held.values()))


def bf16_matmul_ms(shape_a, shape_b):
    """The library yardstick of a "default" row: one cuBLAS bf16
    torch.matmul at the layer product's shape (batched for N replicas),
    never called by the port; its milliseconds on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand(shape_a, device="cuda", generator=g).bfloat16()
    b = torch.rand(shape_b, device="cuda", generator=g).bfloat16()
    return cuda_ms(lambda: torch.matmul(a, b))


def bf16_route(route, name, N):
    """One BF16_CHECKS case: (spec or None, model(s), p, the step and chunk
    callables by precision, lr, shapes for the bound and the library
    yardstick)."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import (
        generator,
        replica_generator,
        step_uniforms,
    )
    from differential_equations_dnn_tpu_torch.equations import PROBLEMS
    from differential_equations_dnn_tpu_torch.kernels import engine_core
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
    from differential_equations_dnn_tpu_torch.kernels import fused_train as ft

    dev = torch.device("cuda")
    prob = PROBLEMS[name]()
    d = prob.defaults
    B, lr = d.batch_size, d.lrate
    gens = ([generator(1)] if N == 1 else
            [replica_generator(0, r) for r in range(N)])
    models = [prob.default_model(generator=g, device=dev) for g in gens]
    model = models[0]
    c = dict(route=route, name=name, N=N, lr=lr, B=B)
    if route == "heat":
        p = ft.pack_params(model)
        u = step_uniforms(0, 0, STEADY_STEPS, B, dev)
        c.update(p=p, U=2, R=7, D=2, H=model.hidden_size,
                 L=model.num_layers, n_const=0, model=model)
        c["step"] = (lambda pr: ft.heat_loss_grad(model, p, u[0],
                                                  precision=pr),
                     lambda pr: ft.heat_loss_grad_plain(model, p, u[0],
                                                        precision=pr))
        c["chunk"] = lambda fn, pr, k=CHUNK_STEPS: fn(
            model, p, torch.zeros_like(p), torch.zeros_like(p), u[:k], 0,
            lr, precision=pr)
        c["fns"] = (ft.heat_fused_train_chunk,
                    ft.heat_fused_train_chunk_plain)
        c["shape"] = ((7 * B, c["H"]), (c["H"], c["H"]))
        return c
    u = None
    if route == "engine":
        spec = fe.spec_for(prob)
        const = spec.make_const(B, dev)
        pack = lambda m: fe.pack_state(spec, m)  # noqa: E731
        kw = dict(schedule=d.schedule, total_steps=HORIZON, const=const)
        D, H, L = spec.dims(model)
        R, U = fe._n_rows(spec.groups), spec.n_uniform
        fns = ((fe.fused_engine_chunk, fe.fused_engine_chunk_plain) if N == 1
               else (fe.fused_engine_packed_chunk,
                     fe.fused_engine_packed_chunk_plain))
        grad = (fe.engine_loss_grad, fe.engine_loss_grad_plain)
        rows = spec.kernel_streams * B * (spec.fold if spec.fold > 1 else 1)
        c["shape"] = ((rows, H), (H, H))
        c.update(D=D, single=fe.fused_engine_chunk,
                 n_const=0 if const is None else const.numel())
    else:
        spec = fd.spec_for(prob, B)
        const = fd.const_for(spec, prob, B, dev)
        pack = fd.pack_dgm
        kw = dict(schedule="cosine", total_steps=HORIZON, const=const)
        H, L, O = model.hidden_size, model.num_layers, model.output_dim
        R, U = fd._layout(spec)[0], spec.n_uniform
        fns = ((fd.fused_dgm_chunk, fd.fused_dgm_chunk_plain) if N == 1
               else (fd.fused_dgm_packed_chunk,
                     fd.fused_dgm_packed_chunk_plain))
        grad = (fd.dgm_loss_grad, fd.dgm_loss_grad_plain)
        c["shape"] = ((R * B, H), (H, 3 * H))
        c.update(O=O, single=fd.fused_dgm_chunk,
                 n_const=0 if const is None else const.numel())
    u = step_uniforms(0, STEP0, STEADY_STEPS, B, dev, U)
    p = (pack(model) if N == 1 else
         engine_core.stack_replicas([pack(m) for m in models]))
    c.update(p=p, R=R, U=U, H=H, L=L, spec=spec, kw=kw, fns=fns, u=u)
    if N == 1:
        c["step"] = tuple(
            (lambda f: lambda pr: f(spec, model, p, u[0], const,
                                    precision=pr))(f) for f in grad)
        c["chunk"] = lambda fn, pr, k=CHUNK_STEPS: fn(
            spec, model, p, torch.zeros_like(p), torch.zeros_like(p), u[:k],
            STEP0, lr, precision=pr, **kw)
    else:
        c["shape"] = ((N,) + c["shape"][0], (N,) + c["shape"][1])
        c["chunk"] = lambda fn, pr, k=CHUNK_STEPS: fn(
            spec, model, p, torch.zeros_like(p), torch.zeros_like(p), u[:k],
            STEP0, lr, N, precision=pr, **kw)
    c["model"] = model
    return c


def bf16_flops(c):
    """(product flops, other flops, parameters) of one step of case c, all
    N replicas: the step's products (step_flops, dgm_step_flops) and Adam's
    12 flops per parameter."""
    if c["route"] == "dgm":
        n = dgm_n_params(c["H"], c["L"], c["O"])
        prod = dgm_step_flops(c["R"], c["B"], c["H"], c["L"], c["O"])
    else:
        n = n_params(c["D"], c["H"], c["L"])
        prod = step_flops(c["R"], c["B"], c["D"], c["H"], c["L"])
    return c["N"] * prod, c["N"] * 12 * n, n


def check_bf16_case(route, name, N):
    """One BF16_CHECKS case at "default": one step (single runs) and a
    CHUNK_STEPS-step chunk against the plain versions at "default" and
    against the kernel's own "highest", tensor by tensor (BF16_STEP_TOL,
    BF16_SEPARATION; BF16_CHUNK_TOL, BF16_CHUNK_SEPARATION);
    packed cases every replica bit for bit against the single chunk.
    Returns the JSON rows of its kernels."""
    import torch

    c = bf16_route(route, name, N)
    label = f"{name} [N={N}, \"default\"]"
    kernel_fn, plain_fn = c["fns"]
    prod, other, n = bf16_flops(c)
    library_ms = bf16_matmul_ms(*c["shape"])
    rows = []
    kinds = {"heat": ("heat_fused_train_chunk", "heat_train.cu",
                      "fused_train.py:237"),
             "engine": ("fused_engine_chunk", "engine_train_bf16.cu",
                        "engine_core.py:48"),
             "dgm": ("fused_dgm_chunk", "dgm_train.cu",
                     "engine_core.py:48")}
    chunk_name, source, replaces = kinds[route]
    if N > 1:
        chunk_name = chunk_name.replace("_chunk", "_packed_chunk")
        replaces = "engine_core.py:202"
    if N == 1 and route != "heat":
        (lkd, gkd), (lkh, gkh) = (c["step"][0](pr)
                                  for pr in ("default", "highest"))
        lpd, gpd = c["step"][1]("default")
        check_close(f"{label} step loss", lkd, lpd, rtol=1e-3, atol=0.0)
        print(f"{label} one step: loss {float(lkd):.7g} (plain "
              f"{float(lpd):.7g}, \"highest\" {float(lkh):.7g})")
        e_match, e_prec = check_by_tensor(
            label, "one step's gradient", bf16_readings(c, gkd, gpd, gkh),
            BF16_STEP_TOL, BF16_SEPARATION)
        ms = cuda_ms(lambda: c["step"][0]("default"))
        plain_ms = cuda_ms(lambda: c["step"][1]("default"))
        grad_name = ("engine_loss_grad" if route == "engine"
                     else "dgm_loss_grad")
        rows.append(dict(
            name=f"{grad_name}[default]", route="cuda",
            source=f"{PKG}/csrc/{source}",
            replaces=(f"{JAX_KERNELS}/fused_engine.py:235" if route == "engine"
                      else f"{JAX_KERNELS}/fused_dgm.py:197"),
            max_abs_err=max_abs(gkd, gpd), rel_l2_err=e_match,
            rel_l2_to_highest=e_prec, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms,
            library_call=f"torch.matmul bf16 {c['shape']}",
            **bound_bf16(prod, 0, 4 * (2 * n + c["B"] * c["U"] + 1
                                       + c["n_const"]))))
    elif route == "heat":
        (lkd, gkd), (lkh, gkh) = (c["step"][0](pr)
                                  for pr in ("default", "highest"))
        lpd, gpd = c["step"][1]("default")
        check_close(f"{label} step loss", lkd, lpd, rtol=1e-3, atol=0.0)
        print(f"{label} one step (heat_loss_grad): loss {float(lkd):.7g} "
              f"(plain {float(lpd):.7g}, \"highest\" {float(lkh):.7g})")
        check_by_tensor(label, "one step's gradient",
                        bf16_readings(c, gkd, gpd, gkh), BF16_STEP_TOL,
                        BF16_SEPARATION)

    # The chunk.
    p0 = c["p"]
    pk, mk, vk, lk = c["chunk"](kernel_fn, "default")
    ph, _, _, lh = c["chunk"](kernel_fn, "highest")
    (pp, _, _, lp), plain_ms = timed_once(
        lambda: c["chunk"](plain_fn, "default"))
    drift = float(((lk - lp) / lp).abs().max())
    print(f"{label} {chunk_name} [K={CHUNK_STEPS}]: loss drift from the "
          f"plain version {drift:.3g} relative, from \"highest\" "
          f"{float(((lk - lh) / lh).abs().max()):.3g}")
    e_match, e_prec = check_by_tensor(
        label, f"{chunk_name}'s update", bf16_readings(c, pk - p0, pp - p0,
                                                       ph - p0),
        BF16_CHUNK_TOL, BF16_CHUNK_SEPARATION, BF16_CHUNK_ENTRIES)
    if N > 1:
        spec, model, u = c["spec"], c["model"], c["u"][:CHUNK_STEPS]
        for r in range(N):
            z = torch.zeros_like(p0[r])
            p1, m1, v1, l1 = c["single"](spec, model, p0[r].contiguous(), z,
                                         z.clone(), u, STEP0, c["lr"],
                                         precision="default", **c["kw"])
            if not (torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
                    and torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])):
                raise AssertionError(f"{label}: packed replica {r} differs "
                                     f"from the single-replica chunk")
        print(f"{label}: all {N} replicas equal the single chunk at "
              f"\"default\" bit for bit")
    ms = cuda_ms(lambda: c["chunk"](kernel_fn, "default"))
    nbytes = 4 * (6 * n * N + CHUNK_STEPS * (c["B"] * c["U"] + N)
                  + c["n_const"])
    rows.append(dict(
        name=f"{chunk_name}[default]", route="cuda",
        source=f"{PKG}/csrc/{source}",
        replaces=f"{JAX_KERNELS}/{replaces}",
        max_abs_err=max(max_abs(lk, lp), max_abs(pk, pp)),
        rel_l2_err=e_match, rel_l2_to_highest=e_prec, ms=ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library_call=f"torch.matmul bf16 {c['shape']}",
        **bound_bf16(CHUNK_STEPS * prod, CHUNK_STEPS * other, nbytes)))
    print(f"{label} {chunk_name}: kernel {ms:.4f} ms "
          f"({ms / CHUNK_STEPS * 1e3:.1f} us per step), plain {plain_ms:.4f}"
          f" ms; bound {rows[-1]['bound_ms']:.4g} ms "
          f"({rows[-1]['bound_by']}); cuBLAS bf16 matmul at "
          f"{c['shape']} {library_ms:.4f} ms")
    if (name, N) in BF16_STEADY:
        times = {}
        for pr in ("highest", "default", "default", "highest"):
            times.setdefault(pr, []).append(cuda_ms(
                lambda: c["chunk"](kernel_fn, pr, STEADY_STEPS), reps=1))
        for row in rows[-1:]:
            row.update(steady_steps=STEADY_STEPS,
                       steady_ms=times["default"],
                       steady_ms_highest=times["highest"],
                       steady_bound_ms=bound_bf16(
                           STEADY_STEPS * prod, STEADY_STEPS * other,
                           nbytes)["bound_ms"])
        print(f"{label} steady state [K={STEADY_STEPS}], timed in turns "
              f"(highest, default, default, highest): "
              + "; ".join(f"{pr} " + ", ".join(
                  f"{t:.4f} ms ({t / STEADY_STEPS * 1e3:.2f} us per step)"
                  for t in times[pr]) for pr in ("highest", "default")))
    return rows


def masked_setup(route, name, extra, tile, gen_seeds):
    """What a sweep-mode check needs at one tile: the problem, spec, const,
    models from generator(1) (``gen_seeds`` None) or replica_generator(0,
    r), the single and packed wrappers and plain versions, the pack and
    unpack functions and the bound's step flops and operand counts."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import (
        generator,
        replica_generator,
    )
    from differential_equations_dnn_tpu_torch.equations import PROBLEMS
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe

    dev = torch.device("cuda")
    prob = PROBLEMS[name](**extra)
    gens = ([generator(1)] if gen_seeds is None
            else [replica_generator(0, r) for r in gen_seeds])
    models = [prob.default_model(generator=g, device=dev) for g in gens]
    model = models[0]
    c = dict(route=route, name=name, prob=prob, model=model, models=models,
             N=1, lr=prob.defaults.lrate, B=tile)
    if route == "engine":
        spec = fe.spec_for(prob)
        D, H, L = spec.dims(model)
        c.update(spec=spec, const=spec.make_const(tile, dev), D=D, H=H, L=L,
                 R=fe._n_rows(spec.groups), U=spec.n_uniform,
                 pack=lambda m: fe.pack_state(spec, m),
                 unpack=lambda x: fe.unpack_state(spec, model, x),
                 fns=(fe.fused_engine_chunk, fe.fused_engine_chunk_plain,
                      fe.fused_engine_packed_chunk,
                      fe.fused_engine_packed_chunk_plain),
                 source="engine_train.cu",
                 n=n_params(D, H, L) + sum(
                     math.prod(s) for s in spec.extra_shapes))
        c["flops"] = lambda bs: step_flops(c["R"], bs, D, H, L)
    else:
        spec = fd.spec_for(prob, tile)
        H, L, O = model.hidden_size, model.num_layers, model.output_dim
        R = fd._layout(spec)[0]
        k = getattr(prob, "k", 0) if name == "fredholm" else 0
        c.update(spec=spec, const=fd.const_for(spec, prob, tile, dev), H=H,
                 L=L, O=O, R=R, U=spec.n_uniform, pack=fd.pack_dgm,
                 unpack=lambda x: fd.unpack_dgm(model, x),
                 fns=(fd.fused_dgm_chunk, fd.fused_dgm_chunk_plain,
                      fd.fused_dgm_packed_chunk,
                      fd.fused_dgm_packed_chunk_plain),
                 source="dgm_train.cu", n=dgm_n_params(H, L, O))
        # The rows this run's data needs: the bs live points' R streams, or
        # Fredholm's bs points and its k nodes.
        c["flops"] = lambda bs: (dgm_step_flops(1, bs + k, H, L, O) if k
                                 else dgm_step_flops(R, bs, H, L, O))
    c["n_const"] = 0 if c["const"] is None else c["const"].numel()
    return c


def masked_bound(c, bss, budgets, K):
    """The least time of a sweep-mode call (fp32): what the data needs, each
    slot's budget of steps at its own bs rows (None: the tile's) plus Adam,
    p, m, v read and written once per slot, the uniforms of the steps run
    and the losses."""
    bss = [c["B"]] * len(budgets) if bss is None else bss
    flops = sum(n * (c["flops"](bs) + 12 * c["n"])
                for bs, n in zip(bss, budgets))
    nbytes = 4 * (6 * c["n"] * len(bss) + K * c["B"] * c["U"]
                  + K * len(bss) + c["n_const"])
    return bound(flops, nbytes)


def check_masked_case(route, name, extra, tile, bs, budget, horizons):
    """One MASKED_CHECKS case: the masked and gated chunk against its plain
    version at "highest" for each horizon and at "default" (trial
    horizon). Returns (the readings of the first horizon at "highest",
    kernel ms, plain ms) for the JSON row."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import step_uniforms

    c = masked_setup(route, name, extra, tile, None)
    single, plain = c["fns"][:2]
    spec, model, lr = c["spec"], c["model"], c["lr"]
    p = c["pack"](model)
    z = torch.zeros_like(p)
    u = step_uniforms(0, STEP0, CHUNK_STEPS, tile, p.device, c["U"])
    label = f"{name} [tile {tile}, bs {bs}, budget {budget} of {CHUNK_STEPS}]"
    first = None
    for horizon in horizons:
        kw = dict(schedule="cosine", total_steps=HORIZON, const=c["const"],
                  runtime_bs=bs, runtime_steps=budget,
                  trial_horizon=horizon == "trial")

        def run(fn, pr="highest", kw=kw):
            return fn(spec, model, p, z, z, u, STEP0, lr, precision=pr, **kw)

        pk, mk, vk, lk = run(single)
        pp, mp, vp, lp = run(plain)
        check_close(f"{label} {horizon} losses", lk[:budget], lp[:budget],
                    rtol=1e-4, atol=0.0)
        if lk[budget:].any() or lp[budget:].any():
            raise AssertionError(f"{label}: a loss past the budget is not 0")
        check_close(f"{label} {horizon} params", pk, pp, rtol=1e-4,
                    atol=2 * lr)
        err = max(max_abs(lk, lp), max_abs(pk, pp))
        print(f"{label} {horizon} horizon: max|dloss| {max_abs(lk, lp):.3g},"
              f" max|dparam| {max_abs(pk, pp):.3g}")
        if first is None:
            ms = cuda_ms(lambda: run(single))
            plain_ms = cuda_ms(lambda: run(plain), reps=PLAIN_REPS)
            first = (err, ms, plain_ms, c)
        if horizon == "trial":
            pd, _, _, _ = run(single, "default")
            ppd, _, _, _ = run(plain, "default")
            check_by_tensor(f"{label} \"default\"", "the chunk's update",
                            bf16_readings(c, pd - p, ppd - p, pk - p),
                            BF16_CHUNK_TOL, BF16_CHUNK_SEPARATION,
                            BF16_CHUNK_ENTRIES)
    return first


def masked_steady(c, bs):
    """µs per step of STEADY_STEPS-step chunks at the tile, masked at bs
    (every step live) and unmasked, timed in turns (unmasked, masked,
    masked, unmasked)."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import step_uniforms

    single = c["fns"][0]
    p = c["pack"](c["model"])
    z = torch.zeros_like(p)
    u = step_uniforms(0, STEP0, STEADY_STEPS, c["B"], p.device, c["U"])
    kw = dict(schedule="cosine", total_steps=HORIZON, const=c["const"])
    calls = {
        "unmasked": lambda: single(c["spec"], c["model"], p, z, z, u, STEP0,
                                   c["lr"], **kw),
        "masked": lambda: single(c["spec"], c["model"], p, z, z, u, STEP0,
                                 c["lr"], runtime_bs=bs,
                                 runtime_steps=STEADY_STEPS, **kw)}
    times = {}
    for what in ("unmasked", "masked", "masked", "unmasked"):
        times.setdefault(what, []).append(
            cuda_ms(calls[what], reps=STEADY_REPS) / STEADY_STEPS * 1e3)
    us = {k: sum(v) / len(v) for k, v in times.items()}
    cost = 100 * (us["masked"] / us["unmasked"] - 1)
    print(f"{c['name']} steady state at tile {c['B']} [K={STEADY_STEPS}], "
          f"in turns: unmasked " + ", ".join(f"{t:.2f}" for t in
                                            times["unmasked"])
          + " us/step; masked at bs " + str(bs) + " "
          + ", ".join(f"{t:.2f}" for t in times["masked"])
          + f" us/step: the mask costs {cost:.2f} %")
    return us


def check_per_slot_case(route, name, extra, tile, lrs, bss, budgets):
    """One PER_SLOT_CHECKS case: the packed call with per-slot vectors
    against its plain version (as the masked chunk), a pruned slot's state
    bit for bit as it went in with losses 0, and every slot bit for bit
    against the single chunk of its values (masked, unless bss is None).
    Returns (max error, ms, plain ms, the case) for the JSON row."""
    import numpy as np
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import step_uniforms
    from differential_equations_dnn_tpu_torch.kernels import engine_core

    N = len(lrs)
    c = masked_setup(route, name, extra, tile, range(N))
    single, _, packed, plain = c["fns"]
    spec, model = c["spec"], c["model"]
    p = engine_core.stack_replicas([c["pack"](m) for m in c["models"]])
    z = torch.zeros_like(p)
    u = step_uniforms(0, STEP0, CHUNK_STEPS, tile, p.device, c["U"])
    kw = dict(schedule="cosine", total_steps=HORIZON, const=c["const"],
              lr_vec=np.asarray(lrs, np.float32),
              bs_vec=None if bss is None else np.asarray(bss),
              steps_vec=np.asarray(budgets), mask_rows=bss is not None)

    def run(fn):
        return fn(spec, model, p, z, z, u, STEP0, 0.0, N, **kw)

    pk, mk, vk, lk = run(packed)
    (pp, _, _, lp), plain_ms = timed_once(lambda: run(plain))
    label = (f"{name} per-slot [N={N}, tile {tile}, lr {lrs}, bs {bss}, "
             f"budgets {budgets}]")
    check_close(f"{label} losses", lk, lp, rtol=1e-4, atol=0.0)
    check_close(f"{label} params", pk, pp, rtol=1e-4, atol=2 * max(lrs))
    for r in range(N):
        p1, m1, v1, l1 = single(spec, model, p[r].contiguous(),
                                z[r].clone(), z[r].clone(), u, STEP0,
                                float(np.float32(lrs[r])),
                                schedule="cosine", total_steps=HORIZON,
                                const=c["const"],
                                runtime_bs=None if bss is None else bss[r],
                                runtime_steps=budgets[r])
        if not (torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
                and torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])):
            raise AssertionError(f"{label}: slot {r} differs from the single "
                                 f"chunk")
        if budgets[r] == 0 and not (torch.equal(pk[r], p[r])
                                    and not lk[r].any()):
            raise AssertionError(f"{label}: pruned slot {r} changed")
    ms = cuda_ms(lambda: run(packed))
    print(f"{label}: max|dloss| {max_abs(lk, lp):.3g}, max|dparam| "
          f"{max_abs(pk, pp):.3g}; every slot equals the single chunk of its "
          f"values bit for bit, the pruned ones their input; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    return max(max_abs(lk, lp), max_abs(pk, pp)), ms, plain_ms, c


def rung_costs():
    """A packed call of RUNG_SLOTS heat slots at tile 64 with the first k
    slots live for RUNG_STEPS steps and the rest pruned, for each k of
    RUNG_LIVE, beside the unmasked packed call of the same N: ms per call
    and µs per live slot-step."""
    import numpy as np
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import step_uniforms
    from differential_equations_dnn_tpu_torch.kernels import engine_core

    N = RUNG_SLOTS
    c = masked_setup("engine", "heat", {}, 64, range(N))
    _, _, packed, _ = c["fns"]
    p = engine_core.stack_replicas([c["pack"](m) for m in c["models"]])
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, RUNG_STEPS, 64, p.device, c["U"])
    out = {}

    def call(k=None):
        kw = {} if k is None else dict(
            lr_vec=np.full(N, 1e-3, np.float32), bs_vec=np.full(N, 64),
            steps_vec=np.asarray([RUNG_STEPS] * k + [0] * (N - k)),
            mask_rows=True)
        return packed(c["spec"], c["model"], p, z, z, u, 0, 1e-3, N,
                      schedule="constant", const=None, **kw)

    out["unmasked"] = cuda_ms(call, reps=STEADY_REPS)
    for k in RUNG_LIVE:
        out[k] = cuda_ms(lambda: call(k), reps=STEADY_REPS)
    full = out["unmasked"] / (N * RUNG_STEPS) * 1e3
    print(f"heat rung of {N} slots at tile 64, {RUNG_STEPS} steps: unmasked "
          f"{out['unmasked']:.3f} ms ({full:.2f} us per slot-step); "
          + "; ".join(f"{k} live {out[k]:.3f} ms ("
                      f"{out[k] / (k * RUNG_STEPS) * 1e3:.2f} us per live "
                      f"slot-step)" for k in RUNG_LIVE))
    return out


def check_masked_kernels():
    """The sweep mode on the card: MASKED_CHECKS, PER_SLOT_CHECKS,
    the mask's cost per step and a rung's cost against its live slots.
    Returns the rows of the kernels the sweep phase drives in their sweep
    mode, each measured at a shape (tile B, replicas N) the sweep phase
    launches it at, whose launches it counts (main()): the masked #4
    (fused_engine_chunk[masked], heat at tile 512, the heat TPE's q = 1
    trial of bs 370), the per-slot #5 (fused_engine_packed_chunk[per-slot],
    heat at tile 512 with 5 slots, a q = 5 round), the masked #7
    (fused_dgm_chunk[masked], Fredholm at tile 512) and the per-slot #5
    around #7 (fused_dgm_packed_chunk[per-slot], FitzHugh–Nagumo's halving
    rungs: tile 100, 9 slots); the other cases are printed."""
    readings = {}
    for route, name, extra, tile, bs, budget, horizons in MASKED_CHECKS:
        readings[name, tile] = check_masked_case(
            route, name, extra, tile, bs, budget, horizons) + (bs, budget)
    steady = {key: masked_steady(readings[key][3], readings[key][4])
              for key in (("heat", 64), ("heat", 512),
                          ("fitzhugh_nagumo", 256))}
    slots = {(case[1], case[3]): check_per_slot_case(*case)
             for case in PER_SLOT_CHECKS}
    rung = rung_costs()

    def masked_row(key, kernel, wrapper, replaces):
        err, ms, plain_ms, c, bs, budget = readings[key]
        return dict(
            name=f"{wrapper}[masked]", kernel=kernel, route="cuda",
            source=f"{PKG}/csrc/{c['source']}",
            replaces=f"{JAX_KERNELS}/{replaces}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
            spec=key[0], tile=c["B"], n_replicas=1, bs=bs, budget=budget,
            steps=CHUNK_STEPS,
            **masked_bound(c, [bs], [budget], CHUNK_STEPS))

    engine = masked_row(("heat", 512), "4 masked", "fused_engine_chunk",
                        "engine_core.py:48")
    engine.update(steady_us_per_step={
        f"tile {key[1]}": steady[key] for key in (("heat", 64),
                                                  ("heat", 512))})
    dgm = masked_row(("fredholm", 512), "7 masked", "fused_dgm_chunk",
                     "fused_dgm.py:197")
    dgm.update(fitzhugh_nagumo_steady_us_per_step=steady[
        "fitzhugh_nagumo", 256])

    def slot_row(key, wrapper):
        route, name, _, tile, lrs, bss, budgets = next(
            case for case in PER_SLOT_CHECKS if (case[1], case[3]) == key)
        err, ms, plain_ms, c = slots[key]
        return dict(
            name=f"{wrapper}[per-slot]", kernel="5 per-slot", route="cuda",
            source=f"{PKG}/csrc/{c['source']}",
            replaces=f"{JAX_KERNELS}/engine_core.py:202",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
            spec=name, tile=tile, n_replicas=len(lrs), lr=list(lrs),
            bs=None if bss is None else list(bss), budgets=list(budgets),
            steps=CHUNK_STEPS, **masked_bound(c, bss, budgets, CHUNK_STEPS))

    packed = slot_row(("heat", 512), "fused_engine_packed_chunk")
    packed.update(rung_slots=RUNG_SLOTS, rung_tile=64, rung_steps=RUNG_STEPS,
                  rung_ms={str(k): v for k, v in rung.items()})
    return [engine, packed, dgm,
            slot_row(("fitzhugh_nagumo", 100), "fused_dgm_packed_chunk")]


def check_bf16_kernels():
    """Every BF16_CHECKS case; returns the rows of the "default" kernels at
    the first case of each (#1 at heat; #6 and #4 at heat2d; #5 at wave N =
    8; #7 and #4 at FitzHugh–Nagumo; #5 at Fredholm N = 4), the shapes at
    which the PRECISION_SOLVES drive them; the other cases are printed."""
    rows = {}
    for route, name, N in BF16_CHECKS:
        for row in check_bf16_case(route, name, N):
            rows.setdefault(row["name"], row)
    return list(rows.values())


def phase_kernels():
    """Each kernel against its plain version at the main paths' shapes.
    Returns the JSON rows: #2, #1 and #3 at the heat shapes, #6 and #4 at the
    widest spec (heat2d; volterra's, uat's, inverse_heat's and the five hard
    specs' numbers under their "specs"), #7 and #4 at the DGM layout at the
    widest DGM equation (FitzHugh–Nagumo), #5 at the wave and
    FitzHugh–Nagumo ensembles (hard heat's N = 4 under the first's
    "specs")."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.equations import Heat1D

    prob = Heat1D()
    model = prob.default_model(generator=generator(1),
                               device=torch.device("cuda"))
    rows = ([check_mlp_forward()] + check_heat_kernels(model)
            + [check_heat_streams(), check_heat_streams_trials()])
    for name in ENGINE:
        engine_rows = check_engine_kernels(name)
    nested = ([check_engine_kernels(name) for name in LAST]
              + [check_engine_kernels(name, hard=True) for name in HARD]
              + [check_engine_kernels("advection", causal=True)])
    for row, specs in zip(engine_rows, zip(*nested)):
        row["specs"] = list(specs)
    dgm_rows = [check_dgm_kernels(name) for name in DGM][0]
    packed_rows = [check_packed_kernels(*case) for case in PACKED][:2]
    packed_rows[0]["specs"] = [
        check_packed_kernels(*HARD_PACKED, hard=True),
        check_packed_kernels(*CAUSAL_PACKED, causal=True)]
    bf16_rows = check_bf16_kernels()
    masked_rows = check_masked_kernels()
    report_graphs()
    return (rows + list(engine_rows) + list(dgm_rows) + packed_rows
            + bf16_rows + masked_rows)


def graph_counts(trainer):
    """(captures, replays) of ``trainer``'s CUDA graphs ("scan",
    "population", "heat", "engine", "dgm") counted in this process
    (utils/trace.py; the fused trainers replay inside their kernels'
    library and count no replay)."""
    from differential_equations_dnn_tpu_torch.utils import trace

    counts = trace.counters()
    return (counts.get(f"graph.captures.{trainer}", 0),
            counts.get(f"graph.replays.{trainer}", 0))


def fused_captures():
    """The fused trainers' graph captures so far, and the cached shapes
    freed to make room."""
    from differential_equations_dnn_tpu_torch.utils import trace

    return (sum(graph_counts(t)[0] for t in ("heat", "engine", "dgm")),
            trace.counters().get("graph.evictions", 0))


def graph_reuses(trainer):
    """The calls of ``trainer`` ("scan", "population") served by a cached
    graph in this process (utils/trace.py)."""
    from differential_equations_dnn_tpu_torch.utils import trace

    return trace.counters().get(f"graph.reuses.{trainer}", 0)


def capture_seconds(trainer, since_ns=0):
    """Host seconds of each capture of ``trainer``'s graphs that began at
    or after ``since_ns`` (``time.perf_counter_ns()``): its
    ``graph.capture`` spans."""
    from differential_equations_dnn_tpu_torch.utils import trace

    return [1e-9 * (sp.end_ns - sp.start_ns) for sp in trace.spans()
            if sp.name == "graph.capture" and sp.start_ns >= since_ns
            and sp.attrs.get("trainer") == trainer]


def report_graphs():
    """The graphs the fused trainers captured so far: their capture and
    instantiation, in host seconds, apart from the chunks' times (each
    chunk time above was taken after a warm-up call, which captured its
    shape's graph)."""
    from differential_equations_dnn_tpu_torch.kernels import graphs

    for engine, what in (("engine", "MLP engine"), ("dgm", "DGM"),
                         ("heat", "heat kernel (#1)")):
        secs = capture_seconds(engine)
        if not secs:
            raise AssertionError(f"no {what} chunk captured a CUDA graph")
        print(f"{what} CUDA graphs of {graphs.GRAPH_STEPS} steps: "
              f"{len(secs)} captured and instantiated, "
              + ", ".join(f"{t:.4f}" for t in secs) + " s each")


# The training wrappers that report their step-math runs (#6, #7; inside
# the packed kernel, replica-steps), by name.
STEP_MATH = {"engine_step_math": "fused_engine_chunk",
             "dgm_step_math": "fused_dgm_chunk",
             "engine_packed_step_math": "fused_engine_packed_chunk",
             "dgm_packed_step_math": "fused_dgm_packed_chunk"}


def reset_counts():
    from differential_equations_dnn_tpu_torch.utils.trace import wrappers

    for fn in wrappers():
        fn.launches = 0
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0
        if hasattr(fn, "sweep_launches"):
            fn.sweep_launches = 0
            fn.sweep_shapes = {}
        if fn.__name__ in STEP_MATH.values():
            fn.step_math_runs = 0
            fn.bf16_step_math_runs = 0


def read_counts():
    """Each wrapper's launches, and ``*_step_math``: the (replica-)steps
    whose step math (#6, #7) ``engine_train_packed`` / ``dgm_train_packed``
    enqueued for each wrapper, as the library reports them; under
    ``name[default]`` those of the "default" precision's instances, under
    ``name[sweep]`` the launches in the sweep mode. Read from
    ``utils.trace.counters()``."""
    from differential_equations_dnn_tpu_torch.utils import trace

    counters = trace.counters()
    names = [fn.__name__ for fn in trace.wrappers()]
    counts = {name: counters[f"launches.{name}"] for name in names}
    for name in names:
        for attr, tag in (("bf16_launches", "default"),
                          ("sweep_launches", "sweep")):
            if f"{attr}.{name}" in counters:
                counts[f"{name}[{tag}]"] = counters[f"{attr}.{name}"]
    for counter, name in STEP_MATH.items():
        counts[counter] = counters[f"step_math_runs.{name}"]
        counts[f"{counter}[default]"] = \
            counters[f"bf16_step_math_runs.{name}"]
    return counts


# (equation, engine, schedule, solve's extras but precision) ->
# {precision: (MAE, it/s)}: the bf16 solves beside the same
# configuration's "highest" run.
SOLVED = {}


def short(value):
    """A solve argument as a label shows it (a model by its widths)."""
    if hasattr(value, "hidden_size"):
        return (f"MLP({value.input_dim}, {value.output_dim}, "
                f"{value.hidden_size}, {value.num_layers})")
    return repr(value)


def solve_once(name, schedule, mae_bound, engine="fused", **extra):
    """One main path through the entry point a user calls; returns the
    launches of each kernel in that run. ``extra`` (ensemble, causal_eps,
    taps, constraint, iterations, seed, finetune) goes to solve; an
    ensemble must go through its packed kernel and no single-replica
    trainer; a scan solve through no training kernel, through one captured
    CUDA graph replayed once per whole block of GRAPH_STEPS steps of each
    chunk, and with pallas taps through kernel #3 once per step plus the
    two warm-ups (the build's, and the capture's). A hard solve must
    hold its IC and BC exactly on the grid (HARD_ROWS) and, on the fused
    engine, train on the generic engine (constant-lr heat too); a
    ``mae_bound`` of None holds no MAE. A fused solve at ``precision``
    "default" must launch only its kernels' "default" instances, at
    "mixed" both those and the "highest" ones, at "highest" no "default"
    one."""
    import numpy as np

    from differential_equations_dnn_tpu_torch import solve
    from differential_equations_dnn_tpu_torch.api import _auto_defaults
    from differential_equations_dnn_tpu_torch.train import trainer

    graphs, reuses = graph_counts("scan"), graph_reuses("scan")
    reset_counts()
    t0 = time.perf_counter()
    since = time.perf_counter_ns()
    res = solve(name, engine=engine, schedule=schedule, **extra)
    total = time.perf_counter() - t0
    launches = read_counts()
    captures, replays = (now - was for now, was
                         in zip(graph_counts("scan"), graphs))
    reused = graph_reuses("scan") - reuses

    d = res.problem.defaults
    ensemble, finetune = _auto_defaults(res.problem, None)
    ensemble = extra.get("ensemble", ensemble)
    finetune = extra.get("finetune", finetune)
    steps = extra.get("iterations", d.iterations)
    hard = extra.get("constraint") == "hard"
    precision = extra.get("precision", "highest")
    label = (f"solve({name!r}, engine={engine!r}, "
             f"schedule={schedule or d.schedule!r}"
             + "".join(f", {k}={short(v)}" for k, v in extra.items()) + ")")
    rate = (f"{res.iters_per_sec:.1f} it/s warm ({ensemble} replicas: "
            f"{ensemble * res.iters_per_sec:.1f} replica-steps/s)"
            if ensemble > 1 else f"{res.iters_per_sec:.1f} it/s warm")
    print(f"{label}: {steps} steps, batch {d.batch_size}, "
          f"{finetune} L-BFGS steps, MAE {res.mae:.6g} (bound {mae_bound}), "
          f"final loss {res.loss_history[-1]:.4g}, {rate} (wall "
          f"{res.wall_time:.3f} s), build + warm-up {res.compile_time:.3f} s"
          + (f" (graph capture {capture_seconds('scan', since)[-1]:.3f}"
             f" s), {replays} graph replays" if captures else "")
          + (f" (cached graph), {replays} graph replays" if reused else "")
          + f", total {total:.2f} s; launches {launches}")
    if res.loss_history.shape != (steps + finetune,):
        raise AssertionError(f"{label}: loss history "
                             f"{res.loss_history.shape}")
    if not np.all(np.isfinite(res.loss_history)):
        raise AssertionError(f"{label}: loss history is not finite")
    want = res.problem.solution_shape(d.nodes)
    if res.solution.shape != want or not np.all(np.isfinite(res.solution)):
        raise AssertionError(f"{label}: solution is not a finite {want} "
                             f"grid")
    if mae_bound is not None and not res.mae <= mae_bound:
        raise AssertionError(f"{label}: MAE {res.mae} above {mae_bound}")
    if hard:
        exact = res.problem.exact(d.nodes)
        for axis, index in HARD_ROWS[name]:
            err = float(np.max(np.abs(np.take(res.solution, index, axis)
                                      - np.take(exact, index, axis))))
            print(f"{label}: constraint rows (axis {axis}, index {index}) "
                  f"max|u - exact| {err:.3g} (atol {HARD_ATOL})")
            if not err <= HARD_ATOL:
                raise AssertionError(f"{label}: the trial function misses "
                                     f"its constraint by {err} on axis "
                                     f"{axis}, index {index}")
    if name == "inverse_heat":
        err = res.problem.kappa_error(res.params)
        print(f"{label}: kappa {float(res.params.kappa().detach()):.6g}, "
              f"error {err:.6g} (bound {KAPPA_BOUND})")
        if not err < KAPPA_BOUND:
            raise AssertionError(f"{label}: kappa error {err} above "
                                 f"{KAPPA_BOUND}")
    on_heat = (name == "heat" and (schedule or d.schedule) == "constant"
               and not hard)
    trainers = ("fused_engine_chunk", "fused_dgm_chunk",
                "heat_fused_train_chunk", "fused_engine_packed_chunk",
                "fused_dgm_packed_chunk")
    if engine == "scan":
        # A DGM (Fredholm's) evaluates through its own forward, no kernel.
        pallas = extra.get("taps") == "pallas"
        grid = 0 if name in DGM else 1
        path = (["mlp_forward"] * grid
                + (["heat_fused_streams"] if pallas else []))
        for kernel in trainers:
            if launches[kernel]:
                raise AssertionError(f"{label}: the scan solve ran {kernel}")
        n_full, rem = divmod(steps, trainer.TrainConfig.chunk_size)
        want = (n_full * (trainer.TrainConfig.chunk_size
                          // trainer.GRAPH_STEPS)
                + rem // trainer.GRAPH_STEPS)
        # One graph, captured or from the cache; a capture's two warm-up
        # steps (train's and the capture's) launch #3 too.
        if (captures + reused, replays) != (1, want):
            raise AssertionError(f"{label}: {captures} graph captures, "
                                 f"{reused} cached graphs and {replays} "
                                 f"replays, not 1 and {want}")
        expected = {"mlp_forward": grid,
                    "heat_fused_streams": (steps + 2 * captures if pallas
                                           else 0)}
        for kernel, n in expected.items():
            if launches[kernel] != n:
                raise AssertionError(f"{label}: {kernel} launched "
                                     f"{launches[kernel]} times, not {n}")
    elif ensemble > 1:
        path = (["fused_dgm_packed_chunk", "dgm_packed_step_math"]
                if name in DGM else
                ["mlp_forward", "fused_engine_packed_chunk",
                 "engine_packed_step_math"])
        for kernel in trainers[:3]:
            if launches[kernel]:
                raise AssertionError(f"{label}: the ensemble ran the "
                                     f"single-replica {kernel}")
    else:
        path = (["fused_dgm_chunk", "dgm_step_math"] if name in DGM else
                ["mlp_forward", "heat_fused_train_chunk"] if on_heat else
                ["mlp_forward", "fused_engine_chunk", "engine_step_math"])
        if hard and launches["heat_fused_train_chunk"]:
            raise AssertionError(f"{label}: a hard solve ran the soft heat "
                                 f"kernel (#1)")
    for kernel in path:
        if launches[kernel] <= 0:
            raise AssertionError(f"{label}: {kernel} was not launched")
        bf16 = launches.get(f"{kernel}[default]")
        if engine == "scan" or bf16 is None:
            continue
        want = {"highest": bf16 == 0, "default": bf16 == launches[kernel],
                "mixed": 0 < bf16 < launches[kernel]}[precision]
        if not want:
            raise AssertionError(f"{label}: {kernel} launched {bf16} of its "
                                 f"{launches[kernel]} times at \"default\"")
    key = (name, engine, schedule or d.schedule,
           tuple(sorted((k, v) for k, v in extra.items()
                        if k != "precision")))
    SOLVED.setdefault(key, {})[precision] = (res.mae, res.iters_per_sec)
    return launches


def phase_solve():
    """Each main path; returns {(name, schedule or "ensemble"), (name,
    "scan", taps), or (name, "hard" | "hard ensemble" | "hard scan"):
    launches}."""
    print(f"scan solves: heat's (pallas and jvp taps) cut to "
          f"{SCAN_HEAT_STEPS} of 15000 steps, under their MAE bound; the "
          f"other scan solves run whole scan-graph blocks (5120, 3072, 1024 "
          f"steps); the bf16 1000-step timings one call per turn")
    out = {(name, schedule): solve_once(name, schedule, mae_bound)
           for name, schedule, mae_bound in SOLVES}
    for name, extra, mae_bound in ENSEMBLES:
        out[(name, "ensemble")] = solve_once(name, None, mae_bound, **extra)
    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.models import MLP

    for name, (D, O, H, L), mae_bound in WIDE_SOLVES:
        out[(name, "wide")] = solve_once(
            name, None, mae_bound,
            model=MLP(D, O, H, L, "tanh", generator=generator(0)))
    for name, extra, mae_bound in SCAN_SOLVES:
        out[(name, "scan", extra.get("taps"))] = solve_once(
            name, None, mae_bound, engine="scan", **extra)
    for name in HARD:
        out[(name, "hard")] = solve_once(name, None, HARD_BOUND, **HARD_SOLVE)
    name, n_replicas, _ = HARD_PACKED
    out[(name, "hard ensemble")] = solve_once(
        name, None, HARD_BOUND, ensemble=n_replicas, **HARD_SOLVE)
    for name, extra, mae_bound in HARD_SCAN:
        out[(name, "hard scan")] = solve_once(name, None, mae_bound,
                                              engine="scan", **extra)
    out[("advection", "causal")] = solve_once("advection", None,
                                              CAUSAL_BOUND, **CAUSAL_SOLVE)
    out[("advection", "causal ensemble")] = solve_once(
        "advection", None, CAUSAL_BOUND, ensemble=CAUSAL_PACKED[1],
        **CAUSAL_SOLVE)
    out[("advection", "causal scan")] = solve_once(
        "advection", None, CAUSAL_BOUND, engine="scan", **CAUSAL_SOLVE)
    for name, extra, mae_bound in PRECISION_SOLVES:
        kind = extra["precision"] + (" ensemble" if "ensemble" in extra
                                     else "")
        out[(name, kind)] = solve_once(name, None, mae_bound, **extra)
    for (name, _, _, extra), runs in SOLVED.items():
        if len(runs) > 1:
            print(f"precisions of solve({name!r}"
                  + "".join(f", {k}={v!r}" for k, v in extra) + "): "
                  + "; ".join(f"{p}: MAE {mae:.6g}, {rate:.1f} it/s"
                              for p, (mae, rate) in runs.items()))
    return out


def sweep_trial_state(prob, t, pack):
    """Trial t's initial flat state, as every sweep evaluator draws it."""
    import torch

    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe

    return fe.trial_state(prob, None, SWEEP_SEED, [t], pack,
                          torch.device("cuda"))[0]


def check_standalone(label, prob, route, result, tile):
    """(a): the best trial's score against a standalone unmasked chunk of
    its config (trial horizon, constant lr) on the first bs rows of its
    tile's stream, to SWEEP_RTOL."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import step_uniforms
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe

    t, cfg = result.best_index, result.best_config
    bs, n, lr = cfg["batch_size"], cfg["n_iters"], cfg["lrate"]
    model = prob.default_model()
    if route == "engine":
        spec = fe.spec_for(prob)
        p = sweep_trial_state(prob, t, lambda m: fe.pack_state(spec, m))
        run, const = fe.fused_engine_chunk, spec.make_const(bs, p.device)
    else:
        spec = fd.spec_for(prob, bs)
        p = sweep_trial_state(prob, t, fd.pack_dgm)
        run, const = fd.fused_dgm_chunk, fd.const_for(spec, prob, bs,
                                                      p.device)
    u = step_uniforms(SWEEP_SEED, 0, n, tile, p.device,
                      spec.n_uniform)[:, :bs].contiguous()
    z = torch.zeros_like(p)
    _, _, _, losses = run(spec, model.to(p.device), p, z, z, u, 0, lr,
                          schedule="constant", total_steps=n, const=const)
    got = float(losses[-1])
    rel = abs(got - result.best_score) / abs(result.best_score)
    print(f"(a) {label}: trial {t} {cfg}, score {result.best_score:.8g}; "
          f"standalone unmasked chunk on its first {bs} rows "
          f"{got:.8g} (relative {rel:.3g}, tolerance {SWEEP_RTOL})")
    if not rel <= SWEEP_RTOL:
        raise AssertionError(f"(a) {label}: the best trial's score and its "
                             f"standalone run differ by {rel:.3g}")


def check_same(label, what, got, want):
    import torch

    if not torch.equal(got, want):
        raise AssertionError(f"{label}: {what} differ "
                             f"(max {max_abs(got, want):.3g})")


def phase_sweep():
    """The fused sweep tier (sweep/search.py) on the card: TPE over the
    reference's slice (heat, q = 5 and q = 1), halving over heat, the DGM
    route (FitzHugh–Nagumo halving, Fredholm TPE), lr_sweep; then the
    identities (a) a best trial equals a standalone run of its config, (b)
    a packed slot equals the sequential evaluator's trial, bit for bit,
    (c) halving's winner equals a standalone max_budget run, bit for bit;
    and the best heat trial's grid MAE through kernel #2. Returns the
    launches of the drivers' run (counts set to 0 just before it) and the
    sweep-mode wrappers' launches by shape ({name: {(B, N): count}})."""
    import numpy as np
    import torch

    from differential_equations_dnn_tpu_torch.equations import (
        FitzHughNagumo,
        Fredholm2,
        Heat1D,
    )
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
    from differential_equations_dnn_tpu_torch.sweep import (
        BUCKET_TILES,
        SearchSpace,
        halving_search_fused,
        heat_search_space,
        randint,
        tpe_search_fused,
    )
    from differential_equations_dnn_tpu_torch.sweep.search import _tiles_for

    dev = torch.device("cuda")
    space = heat_search_space()
    space = SearchSpace({**space.specs,
                         "n_iters": randint(1000, SWEEP_MAX_ITERS)})
    print(f"sweep: heat's space with n_iters ~ randint[1000, "
          f"{SWEEP_MAX_ITERS}) (the reference's 50 000 cut); FitzHugh–"
          f"Nagumo's halving to {FN_HALVING['max_budget']} steps (its "
          f"150 000 cut)")
    heat, fn = Heat1D(), FitzHughNagumo(arch="dgm", causal_eps=0.0)
    fred = Fredholm2(quadrature="gauss", k=16)
    from differential_equations_dnn_tpu_torch.utils.trace import wrappers

    builds, evictions = fused_captures()
    reset_counts()
    runs = {}

    def timed(label, fn_, trials):
        torch.cuda.synchronize()
        captured = fused_captures()[0]
        t0 = time.perf_counter()
        out = fn_()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs[label] = (out, secs)
        best = out.best_config
        print(f"sweep {label}: {trials} trials in {secs:.2f} s, "
              f"{60 * trials / secs:.1f} trials per minute, "
              f"{fused_captures()[0] - captured} CUDA graphs "
              f"captured; best {best}, score {out.best_score:.6g}")
        if best is not None and not math.isfinite(out.best_score):
            raise AssertionError(f"sweep {label}: no finite score")
        return out

    tpe5 = timed("tpe q=5 heat", lambda: tpe_search_fused(
        heat, seed=SWEEP_SEED, num_samples=10, space=space, q=5), 10)
    tpe1 = timed("tpe q=1 heat", lambda: tpe_search_fused(
        heat, seed=SWEEP_SEED, num_samples=4, space=space), 4)
    halv = timed("halving heat", lambda: halving_search_fused(
        heat, seed=SWEEP_SEED, **HEAT_HALVING), HEAT_HALVING["num_samples"])
    fnh = timed("halving fitzhugh_nagumo", lambda: halving_search_fused(
        fn, seed=SWEEP_SEED, **FN_HALVING), FN_HALVING["num_samples"])
    fred_res = timed("tpe fredholm", lambda: tpe_search_fused(
        fred, seed=SWEEP_SEED, space=heat_search_space(), **FREDHOLM_TPE),
        FREDHOLM_TPE["num_samples"])
    lrs = (1e-3, 3e-3, 1e-2)
    (finals, states), secs = timed_once(lambda: fe.lr_sweep(
        heat, SWEEP_SEED, lrs, 2000, device="cuda"))
    print(f"sweep lr_sweep heat {lrs} x 2000 steps: final losses "
          f"{[f'{x:.4g}' for x in finals]} ({secs / 1e3:.2f} s)")
    if not np.all(np.isfinite(finals)):
        raise AssertionError("lr_sweep: a non-finite final loss")
    launches = read_counts()
    shapes = {fn.__name__: dict(fn.sweep_shapes) for fn in wrappers()
              if hasattr(fn, "sweep_shapes")}
    print(f"sweep: {fused_captures()[0] - builds} CUDA graphs "
          f"captured, {fused_captures()[1] - evictions} cached "
          f"shapes freed; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + "; in the sweep mode by tile x replicas: "
          + "; ".join(f"{name} " + ", ".join(
              f"{B}x{N} {n}" for (B, N), n in sorted(by.items()))
                      for name, by in shapes.items() if by))

    # Halving heat's work: live slot-steps per second of its rungs.
    iters = np.asarray([c["n_iters"] for c in halv.configs])
    slot_steps = int(iters.sum())
    print(f"sweep halving heat: {slot_steps} live slot-steps in "
          f"{runs['halving heat'][1]:.2f} s, "
          f"{runs['halving heat'][1] / slot_steps * 1e6:.2f} us per live "
          f"slot-step")

    heat_tiles = _tiles_for(511, BUCKET_TILES)
    tile_of = lambda bs: next(t for t in heat_tiles if t >= bs)  # noqa: E731
    # (a) at "highest": the best trials of the heat TPE and of Fredholm's.
    check_standalone("tpe q=5 heat", heat, "engine", tpe5,
                     tile_of(tpe5.best_config["batch_size"]))
    fred_tiles = _tiles_for(511, BUCKET_TILES, 64)
    check_standalone("tpe fredholm", fred, "dgm", fred_res,
                     next(t for t in fred_tiles
                          if t >= fred_res.best_config["batch_size"]))
    # (b): the q = 5 TPE's best slot against the sequential evaluator.
    cfg, t = tpe5.best_config, tpe5.best_index
    ev = fe.make_sweep_evaluator(heat, SWEEP_SEED, SWEEP_MAX_ITERS - 1,
                                 max_batch=tile_of(cfg["batch_size"]),
                                 schedule="constant")
    losses, p = ev(t, cfg["lrate"], cfg["batch_size"], cfg["n_iters"])
    if losses[-1] != tpe5.best_score:
        raise AssertionError(f"(b) the packed slot's score "
                             f"{tpe5.best_score!r} and the sequential "
                             f"trial's {losses[-1]!r} differ")
    check_same("(b) tpe q=5 heat", "the packed slot's and the sequential "
               "trial's parameters", tpe5.params[0], p)
    print(f"(b) tpe q=5 heat: trial {t}'s packed slot equals the sequential "
          f"evaluator's trial bit for bit")
    # (c): each halving winner against a standalone max_budget run.
    cfg, t = halv.best_config, halv.best_index
    ev = fe.make_sweep_evaluator(heat, SWEEP_SEED,
                                 HEAT_HALVING["max_budget"],
                                 max_batch=tile_of(cfg["batch_size"]),
                                 schedule="constant", horizon="fixed")
    losses, p = ev(t, cfg["lrate"], cfg["batch_size"],
                   HEAT_HALVING["max_budget"])
    pos = int(np.where(halv.param_indices == t)[0][0])
    check_same("(c) halving heat", "the winner's and the standalone run's "
               "parameters", halv.params[pos], p)
    if losses[-1] != halv.best_score:
        raise AssertionError("(c) halving heat: the winner's score and the "
                             "standalone run's differ")
    cfg, t = fnh.best_config, fnh.best_index
    ev = fd.make_sweep_evaluator(fn, SWEEP_SEED, FN_HALVING["max_budget"],
                                 batch_size=fn.defaults.batch_size,
                                 schedule="constant", horizon="fixed")
    losses, p = ev(t, cfg["lrate"], FN_HALVING["max_budget"])
    pos = int(np.where(fnh.param_indices == t)[0][0])
    check_same("(c) halving fitzhugh_nagumo", "the winner's and the "
               "standalone run's parameters", fnh.params[pos], p)
    if losses[-1] != fnh.best_score:
        raise AssertionError("(c) halving fitzhugh_nagumo: the winner's "
                             "score and the standalone run's differ")
    print(f"(c) both halving winners (heat trial {halv.best_index}, "
          f"FitzHugh–Nagumo trial {fnh.best_index}) equal standalone "
          f"max_budget runs bit for bit")
    # The best heat trial's grid MAE through kernel #2 (mlp_forward).
    model = heat.default_model(device=dev)
    fe.load_state(fe.spec_for(heat), model, tpe5.params[0])
    mae = heat.mae(model, heat.defaults.nodes)
    print(f"sweep tpe q=5 heat: best trial's grid MAE {mae:.6g} "
          f"(kernel #2 on its {heat.defaults.nodes}² grid)")
    if not math.isfinite(mae):
        raise AssertionError("the best heat trial's MAE is not finite")
    return launches, shapes


def standalone_trial(prob, model, seed, t, lr, bs, steps, params=None,
                     opt_state=None):
    """Trial ``t`` of a population seeded ``seed`` run again as a
    standalone ``train()`` of ``steps`` steps on its own stream
    (``trial_seed(seed, t)``) at batch ``bs`` (the first ``bs`` of the
    population's drawn rows are that batch) and lr ``lr``: from its init
    (``replica_generator(seed, t)``), or from the stacked ``params`` and
    ``opt_state`` the population started from (a halving rung's
    survivors). Returns its loss history."""
    from differential_equations_dnn_tpu_torch.core.prng import (
        replica_generator,
        trial_seed,
    )
    from differential_equations_dnn_tpu_torch.parallel import population as pop
    from differential_equations_dnn_tpu_torch.train import TrainConfig, train

    if params is None:
        net = model.fresh(generator=replica_generator(seed, t),
                          device="cuda")
        opt_state = None
    else:
        net = pop.trial_model(model, params, t)
        opt_state = pop.trial_opt_state(net, opt_state, t)
    res = train(prob, trial_seed(seed, t),
                TrainConfig(iterations=steps, batch_size=int(bs),
                            lrate=float(lr), verbose=False),
                model=net, opt_state=opt_state)
    return res.loss_history


def check_trial(label, got, want):
    """A population trial's losses against its standalone run, to
    POP_RTOL."""
    import numpy as np

    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                       1e-30)))
    print(f"{label}: against its standalone train(), losses max rel diff "
          f"{rel:.3g} (rtol {POP_RTOL})")
    if not rel <= POP_RTOL:
        raise AssertionError(f"{label}: the population trial and its "
                             f"standalone run differ")


def population_run(launches, label, fn):
    """``fn()`` with the counted wrappers' launches set to 0 just before
    and read just after (into ``launches[label]``); prints its seconds and
    the population graphs it captured, took from the cache and replayed.
    Returns (its result,
    its seconds)."""
    import torch

    captures, reuses = graph_counts("population"), graph_reuses("population")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    since = time.perf_counter_ns()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches[label] = read_counts()
    n, r = (now - was for now, was
            in zip(graph_counts("population"), captures))
    cap = sum(capture_seconds("population", since))
    print(f"population {label}: {secs:.2f} s, {n} population graphs "
          f"captured ({cap:.2f} s), "
          f"{graph_reuses('population') - reuses} from the cache, {r} "
          f"replays; launches "
          + ", ".join(f"{k} {v}" for k, v in launches[label].items() if v))
    return out, secs


def population_headline():
    """The headline population's step (55 trials x 1 024 rows, heat
    2 -> 128x3 -> 1): host draws, an eager step and a graph replay, each
    timed alone; returns their ms per step."""
    import numpy as np
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import trial_seed
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.parallel import population as pop

    dev = torch.device("cuda")
    prob = Heat1D()
    model = prob.default_model(device=dev)
    bss = np.repeat([2**i for i in range(11)], 5)
    params, _ = pop.init_trials(model, POP_SEED, len(bss), dev)
    opt = pop._adam_init(params, len(bss), dev)
    mask = (torch.arange(1024, device=dev)[None, :]
            < torch.as_tensor(bss, device=dev)[:, None])
    lr = torch.full((len(bss),), 1e-4, device=dev)
    step = pop.make_population_step(prob, model, params, None, opt, lr, mask)
    seeds = [trial_seed(POP_SEED, t) for t in range(len(bss))]
    t0 = time.perf_counter()
    block = pop.draw_trial_batches(prob, seeds, 0, pop.GRAPH_STEPS, 1024, dev)
    torch.cuda.synchronize()
    draw = (time.perf_counter() - t0) * 1e3 / pop.GRAPH_STEPS
    first = {k: v[0] for k, v in block.items()}
    eager = cuda_ms(lambda: step(first), reps=10)
    tensors = [*params.values(), opt["count"], *opt["mu"].values(),
               *opt["nu"].values()]
    t0 = time.perf_counter()
    graph = pop._PopulationGraph(step, block, tensors, len(bss), "heat")
    capture = time.perf_counter() - t0
    replay = cuda_ms(lambda: graph.replay(block), reps=3) / pop.GRAPH_STEPS
    print(f"population step at the headline (55 trials x 1 024 rows): graph "
          f"replay {replay * 1e3:.1f} us, eager {eager * 1e3:.1f} us, host "
          f"draws {draw * 1e3:.1f} us per step (a share of "
          f"{draw / (draw + replay):.3f} of draw + replay, overlapped with "
          f"the replay in the loop); capture of {pop.GRAPH_STEPS} steps "
          f"{capture:.2f} s")
    return dict(replay_ms=replay, eager_ms=eager, draw_ms=draw)


def phase_population():
    """The population tier's checks that launch no kernel of the repo,
    (a), (b), (d), (e) and (f): they run while nvcc builds the kernels
    (``main``), so their seconds include that contention; each check
    raises on failure. Returns the launches of the counted wrappers in each
    run."""
    import numpy as np
    import torch

    from differential_equations_dnn_tpu_torch import solve
    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.models import MLP, ResNet
    from differential_equations_dnn_tpu_torch.sweep import (
        batch_size_effect,
        batchnorm_effect,
        search,
    )
    from differential_equations_dnn_tpu_torch.train import TrainConfig, train

    dev = torch.device("cuda")
    heat = Heat1D()
    print(f"population: iterations cut to {POP_STEPS} (the ablations' "
          f"15 000, the sweeps' budgets, the ResNet run), halving to "
          f"{HALVING_MIN} -> {HALVING_MAX} (its 500 -> 15 000); (a), (b), "
          f"(d), (e) and (f) run while nvcc builds the kernels, so their "
          f"seconds include its load on the host")
    launches = {}

    def run(label, fn):
        return population_run(launches, label, fn)

    # (a) the batch-size ablation at the headline shape.
    torch.cuda.reset_peak_memory_stats()
    res, secs = run("(a) batch_size_effect", lambda: batch_size_effect(
        seed=POP_SEED, iterations=POP_STEPS, device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if res.all_losses.shape != (11, 5, POP_STEPS) or not np.all(
            np.isfinite(res.all_losses)):
        raise AssertionError("(a) batch_size_effect: curves not finite of "
                             "shape [11, 5, POP_STEPS]")
    print(f"(a) batch_size_effect: 55 trials x {POP_STEPS} steps, "
          f"{POP_STEPS / secs:.1f} population steps/s, peak memory "
          f"{peak:.2f} GiB; final mean loss by batch size "
          + ", ".join(f"{b}: {c[-1]:.4g}" for b, c in res.as_dict().items()))
    t = 10 * 5  # run 0 of bs 1 024: no mask at max_batch_size 1 024
    want = standalone_trial(heat, heat.default_model(), POP_SEED, t, 1e-4,
                            1024, POP_STEPS)
    check_trial("(a) trial 50 (bs 1 024)", res.all_losses[10, 0], want)

    # (b) the BatchNorm ablation, and a pre-BN train() beside it.
    res, _ = run("(b) batchnorm_effect", lambda: batchnorm_effect(
        seed=POP_SEED, iterations=POP_STEPS, device="cuda"))
    if res.all_losses.shape != (3, 5, POP_STEPS) or not np.all(
            np.isfinite(res.all_losses)):
        raise AssertionError("(b) batchnorm_effect: curves not finite")
    print("(b) batchnorm_effect: final mean loss "
          + ", ".join(f"{k}: {c[-1]:.4g}" for k, c in res.as_dict().items()))
    m = MLP(2, 1, 128, 3, "relu", "pre", generator=generator(0), device=dev)
    out, _ = run("(b) pre-BN train()", lambda: train(
        heat, POP_SEED, TrainConfig(iterations=POP_STEPS, batch_size=64,
                                    verbose=False), model=m))
    moved = (float(m.bn.mean.abs().max()), float((m.bn.var - 1).abs().max()))
    grid = heat.evaluate(m, heat.defaults.nodes)
    with torch.no_grad():
        train_grid = m(heat.grid_inputs(heat.defaults.nodes, dev)).cpu()
    gap = float(np.max(np.abs(grid - train_grid.numpy().reshape(grid.shape))))
    print(f"(b) pre-BN train(): final loss {out.loss_history[-1]:.4g}, "
          f"running mean max|.| {moved[0]:.4g}, |var - 1| max {moved[1]:.4g}; "
          f"eval-mode grid against the train-mode forward max|diff| "
          f"{gap:.4g}")
    if not (min(moved) > 1e-3 and np.all(np.isfinite(grid)) and gap > 1e-4
            and m.training):
        raise AssertionError("(b) pre-BN train(): statistics did not move "
                             "or the eval-mode grid is not its own")

    # (d) FitzHugh–Nagumo's Fourier-feature arch on the scan trainer.
    res, _ = run("(d) fitzhugh_nagumo fourier_mlp", lambda: solve(
        "fitzhugh_nagumo", arch="fourier_mlp", seed=42, iterations=30_000))
    print(f"(d) solve('fitzhugh_nagumo', arch='fourier_mlp', seed=42, "
          f"iterations=30000): MAE {res.mae:.6g} (bound {POP_BOUND}), "
          f"{res.iters_per_sec:.1f} it/s")
    if not res.mae < POP_BOUND:
        raise AssertionError(f"(d) fourier_mlp: MAE {res.mae}")

    # (e) the population sweeps; each winner checked against the
    # populations it trained in.
    calls = []
    real = search.train_population

    def spy(problem, model, seed, lrates, batch_sizes=None, config=None,
            **kw):
        out = real(problem, model, seed, lrates, batch_sizes, config, **kw)
        calls.append(dict(seed=seed, lrs=np.asarray(lrates),
                          bss=np.asarray(batch_sizes), losses=out[2],
                          params_in=kw.get("params"),
                          opt_in=kw.get("opt_state"), params_out=out[0]))
        return out

    search.train_population = spy
    results = {}
    try:
        for label, fn in (
                ("successive_halving", lambda: search.successive_halving(
                    heat, POP_SEED, num_samples=27, eta=3,
                    min_budget=HALVING_MIN, max_budget=HALVING_MAX)),
                ("random_search", lambda: search.random_search(
                    heat, POP_SEED, num_samples=10, max_iters=POP_STEPS)),
                ("tpe_search", lambda: search.tpe_search(
                    heat, POP_SEED, num_samples=10, max_iters=POP_STEPS))):
            calls[:] = []
            out, secs = run(f"(e) {label}", fn)
            results[label] = (out, list(calls))
            n_trials = len(out.configs)
            print(f"(e) {label}: best {out.best_config}, score "
                  f"{out.best_score:.9g}; {n_trials} trials in {secs:.2f} s, "
                  f"{60 * n_trials / secs:.1f} trials per minute")
            if not math.isfinite(out.best_score):
                raise AssertionError(f"(e) {label}: no finite winner")
    finally:
        search.train_population = real
    for label, (out, rounds) in results.items():
        check_winner(label, heat, out, rounds)

    # (f) a ResNet on the scan trainer.
    net = ResNet(generator=generator(0), device=dev)
    out, _ = run("(f) ResNet train()", lambda: train(
        heat, POP_SEED, TrainConfig(iterations=POP_STEPS, batch_size=64,
                                    verbose=False), model=net))
    grid = heat.evaluate(net, heat.defaults.nodes)
    first, last = out.loss_history[:100].mean(), out.loss_history[-100:].mean()
    print(f"(f) ResNet() on heat: mean loss of the first 100 steps "
          f"{first:.4g}, of the last 100 {last:.4g}; eval-mode grid "
          f"max|u| {np.abs(grid).max():.4g}")
    if not (last < first and np.all(np.isfinite(grid))):
        raise AssertionError("(f) ResNet: the loss did not fall or the grid "
                             "is not finite")
    return launches


def check_winner(label, prob, out, rounds):
    """(e): a sweep's winner against the populations it trained in (a
    halving rung each; the random search's one; its TPE round), found by
    its lr and batch: its score is its loss in the last of them at its
    n_iters, exactly; ``best_params()`` are its parameters at the end of
    that population, exactly; and in each population its first losses
    (POP_REPLAY_STEPS from its init, POP_CARRIED_STEPS from a carried
    state) equal, to POP_RTOL, a standalone train() from the state that
    population started it from (its init, or the parameters and Adam
    state ``take_trials`` carried into the rung) on that population's
    stream for it."""
    import numpy as np
    import torch

    cfg = out.best_config
    found = []
    for call in rounds:
        where = np.flatnonzero((call["lrs"] == np.float32(cfg["lrate"]))
                               & (call["bss"] == cfg["batch_size"]))
        if len(where):
            found.append((int(where[0]), call))
    n = cfg["n_iters"] - sum(c["losses"].shape[0] for _, c in found[:-1])
    t, last = found[-1]
    if last["losses"][n - 1, t] != out.best_score:
        raise AssertionError(f"(e) {label}: the winner's score is not its "
                             f"population's loss at its n_iters")
    best = out.best_params()
    if not all(torch.equal(best[k][0], last["params_out"][k][t])
               for k in last["params_out"]):
        raise AssertionError(f"(e) {label}: best_params() are not the "
                             f"winner's parameters")
    model, rels = prob.default_model(), []
    for t, call in found:
        k = (POP_REPLAY_STEPS if call["params_in"] is None
             else POP_CARRIED_STEPS)
        want = standalone_trial(prob, model, call["seed"], t, cfg["lrate"],
                                cfg["batch_size"], k, call["params_in"],
                                call["opt_in"])
        got = call["losses"][:k, t]
        rels.append((float(np.max(np.abs(got - want) / np.abs(want))), k))
    print(f"(e) {label}: the score is the winner's loss at its n_iters and "
          f"best_params() its parameters at the end of its last population, "
          f"exactly; in each of its {len(found)} population(s), re-run "
          f"standalone from the state it started from (its init, or the "
          f"carried parameters and Adam state), its first losses max rel "
          f"diff " + ", ".join(f"{r:.3g} over {k}" for r, k in rels)
          + f" steps (rtol {POP_RTOL})")
    if not max(r for r, _ in rels) <= POP_RTOL:
        raise AssertionError(f"(e) {label}: the winner's standalone re-run "
                             f"parts from its population trial")


# The population card's pallas-taps run (g): the launches of its kernel #3
# rows are read from it.
PALLAS_POP = "(g) heat ensemble=8 pallas"


def phase_population_card(launches):
    """The population checks that need the built kernels or a quiet host,
    after the build: the headline's step timed alone, (c), whose
    picked replica's grid goes through kernel #2, and (g), (c) with
    pallas taps: kernel #3 with T = 8 once a population step. Then every
    population run's launches: none but (c)'s and (g)'s one of kernel #2
    and (g)'s of #3."""
    from differential_equations_dnn_tpu_torch import solve

    population_headline()
    res, _ = population_run(launches, "(c) heat ensemble=8", lambda: solve(
        "heat", engine="scan", ensemble=8, seed=0))
    print(f"(c) solve('heat', engine='scan', ensemble=8): MAE {res.mae:.6g} "
          f"(bound {POP_BOUND}), {res.iters_per_sec:.1f} population steps/s "
          f"({8 * res.iters_per_sec:.1f} trial-steps/s), wall "
          f"{res.wall_time:.2f} s, build + warm-up + capture "
          f"{res.compile_time:.2f} s")
    if not (res.mae < POP_BOUND and res.loss_history.shape == (15_000,)):
        raise AssertionError(f"(c) heat ensemble: MAE {res.mae}")
    if launches["(c) heat ensemble=8"]["mlp_forward"] != 1:
        raise AssertionError("(c) the picked replica's grid did not go "
                             "through kernel #2 once")
    # (g) the slice's path: the reference heat configuration's 8 trials
    # through kernel #3's trial axis, inside the population graph.
    captured = graph_counts("population")[0]
    res_g, _ = population_run(launches, PALLAS_POP, lambda: solve(
        "heat", engine="scan", ensemble=8, taps="pallas", seed=0))
    captured = graph_counts("population")[0] - captured
    steps = res_g.loss_history.shape[0]
    print(f"(g) solve('heat', engine='scan', ensemble=8, taps='pallas'): "
          f"MAE {res_g.mae:.6g} (bound {POP_BOUND}), "
          f"{res_g.iters_per_sec:.1f} population steps/s against (c)'s "
          f"{res.iters_per_sec:.1f} with jvp taps, wall "
          f"{res_g.wall_time:.2f} s, build + warm-up + capture "
          f"{res_g.compile_time:.2f} s")
    if not (res_g.mae < POP_BOUND and steps == 15_000):
        raise AssertionError(f"(g) heat pallas ensemble: MAE {res_g.mae}")
    counts = launches[PALLAS_POP]
    # One T = 8 launch a population step and the graph capture's warm-up
    # step's (none where the graph came from the cache), then one T = 1
    # launch per trial for the pick's validation residual (api.solve's
    # selection).
    want = steps + captured + 8
    if counts["heat_fused_streams"] != want:
        raise AssertionError(f"(g) kernel #3 launched "
                             f"{counts['heat_fused_streams']} times, not "
                             f"once a step, the warm-up and the pick's 8 "
                             f"({want})")
    if counts["mlp_forward"] != 1:
        raise AssertionError("(g) the picked replica's grid did not go "
                             "through kernel #2 once")
    for label, counts in launches.items():
        allowed = ({"mlp_forward", "heat_fused_streams"}
                   if label == PALLAS_POP
                   else {"mlp_forward"} if "(c)" in label else set())
        ran = {k for k, v in counts.items() if v and k not in allowed}
        if ran:
            raise AssertionError(f"population {label}: launched {ran}")
    print(f"population: {graph_counts('population')[0]} population graphs "
          f"captured, {graph_counts('population')[1]} replays in all")


# The mesh phase (parallel/): one rank of NCCL in this
# process (the card's machine has one GPU; two NCCL ranks cannot share a
# card), each sharded driver held to its unsharded call. (a) wave's
# sharded ensemble of 8 at its reference width, depth and budget through
# solve(mesh=), under wave's bound; (b) FitzHugh–Nagumo's DGM ensemble of
# MESH_DGM_REPLICAS over MESH_DGM_STEPS against the sequential whole runs
# of mesh=None; (c) fused halving on heat (its reference space) and on
# Fredholm with a batch-size space, MESH_HALVING's rungs; (d) data-parallel
# train() of heat, jvp and pallas taps (kernel #3), MESH_TRAIN_STEPS steps
# with the graph, and of a pre-BN heat MLP and causal advection (rows
# coupled across data ranks); (e) a population of MESH_POP_TRIALS x
# MESH_POP_STEPS;
# (f) dryrun_multichip(1).
MESH_DGM_REPLICAS, MESH_DGM_STEPS = 4, 2000
MESH_HALVING = dict(num_samples=8, eta=2, min_budget=250, max_budget=1000)
MESH_TRAIN_STEPS = 1024
MESH_POP_TRIALS, MESH_POP_STEPS = 8, 256
# (c) With a mesh the rungs run on one tile, the sweep's largest batch
# rounded up to 64 rows (the JAX package's design), without one on the
# smallest bucket tile that holds each trial's batch. A trial whose tiles
# match is held bit for bit. One whose tiles differ trains on the same
# rows (a tile's first rows are the narrower tile's: the draws are hashed
# per lane) with its masked rows adding zeros, so only the order of the
# loss's and the gradients' sums over the rows differs: fp32
# reassociation, carried by Adam over at most max_budget steps, as the
# population phase's POP_RTOL holds a trial against its standalone run.
MESH_TILE_RTOL = POP_RTOL


def phase_mesh():
    """The sharded drivers at one rank against their unsharded calls (see
    MESH_* above); each check's kernel launches printed. Returns them."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from differential_equations_dnn_tpu_torch import solve
    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.equations import (
        Advection1D,
        FitzHughNagumo,
        Fredholm2,
        Heat1D,
        Wave1D,
    )
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
    from differential_equations_dnn_tpu_torch.parallel import (
        PopulationConfig,
        make_mesh,
        train_population,
    )
    from differential_equations_dnn_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )
    from differential_equations_dnn_tpu_torch.sweep import (
        BUCKET_TILES,
        SearchSpace,
        halving_search_fused,
        loguniform,
        randint,
    )
    from differential_equations_dnn_tpu_torch.models import MLP
    from differential_equations_dnn_tpu_torch.sweep.search import _tiles_for
    from differential_equations_dnn_tpu_torch.train import (
        TrainConfig,
        train,
    )

    launches = {}

    def run(label, fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[label] = read_counts()
        print(f"mesh {label}: {time.perf_counter() - t0:.2f} s; launches "
              + (", ".join(f"{k} {v}" for k, v in launches[label].items()
                           if v) or "none"))
        return out

    def flat(models):
        return torch.stack([torch.cat([p.detach().reshape(-1)
                                       for p in m.parameters()])
                            for m in models])

    def same(label, got, want):
        for i, pair in enumerate(zip(got, want)):
            a, b = (x.cpu() if torch.is_tensor(x)
                    else torch.as_tensor(np.asarray(x)) for x in pair)
            if not torch.equal(a, b):
                raise AssertionError(f"mesh {label}: output {i} differs from "
                                     f"the unsharded call (max "
                                     f"{max_abs(a, b):.3g})")

    pop = make_mesh({"pop": 1})
    data = make_mesh({"data": 1})
    print(f"mesh: one-rank NCCL group ({dist.get_backend()}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}), meshes "
          f"{dict(zip(pop.mesh_dim_names, pop.shape))} and "
          f"{dict(zip(data.mesh_dim_names, data.shape))}")
    try:
        # (a) wave x 8 through solve(mesh=): the sharded ensemble's training
        # outputs, captured as solve receives them, against the packed one.
        wave = Wave1D()
        d = wave.defaults
        caught = {}
        sharded = fe.train_fused_ensemble

        def catch(*args, **kw):
            caught["out"] = sharded(*args, **kw)
            return caught["out"]

        fe.train_fused_ensemble = catch
        try:
            res = run("(a) solve wave ensemble=8 pop mesh", lambda: solve(
                "wave", engine="fused", ensemble=8, mesh=pop, seed=0))
        finally:
            fe.train_fused_ensemble = sharded
        packed = run("(a) wave packed ensemble",
                     lambda: fe.train_fused_ensemble_packed(
                         wave, 0, d.iterations, 8, batch_size=d.batch_size,
                         lrate=d.lrate, schedule=d.schedule))
        models, losses = caught["out"]
        same("(a) wave x 8", (losses, flat(models)),
             (packed.loss_history, flat(packed.params)))
        bound = dict((e, b) for e, _, b in ENSEMBLES)["wave"]
        print(f"(a) solve('wave', ensemble=8, mesh={{'pop': 1}}): MAE "
              f"{res.mae:.6g} (bound {bound}), {res.iters_per_sec:.1f} "
              f"population steps/s; the 8 replicas' losses and parameters "
              f"equal the packed ensemble's bit for bit")
        if not (res.mae < bound and losses.shape == (8, d.iterations)):
            raise AssertionError(f"(a) wave x 8 on a mesh: MAE {res.mae}")

        # (b) FitzHugh–Nagumo's DGM ensemble: sharded (packed) against the
        # sequential whole runs of mesh=None.
        fn = FitzHughNagumo(causal_eps=0.0)
        kw = dict(batch_size=fn.defaults.batch_size, lrate=fn.defaults.lrate)
        got = run("(b) fitzhugh_nagumo dgm ensemble pop mesh",
                  lambda: fd.train_dgm_fused_ensemble(
                      fn, 0, MESH_DGM_STEPS, MESH_DGM_REPLICAS, mesh=pop,
                      **kw))
        want = run("(b) fitzhugh_nagumo dgm ensemble sequential",
                   lambda: fd.train_dgm_fused_ensemble(
                       fn, 0, MESH_DGM_STEPS, MESH_DGM_REPLICAS, **kw))
        same("(b) fitzhugh_nagumo", (got[1], flat(got[0])),
             (want[1], flat(want[0])))
        print(f"(b) FitzHugh–Nagumo x {MESH_DGM_REPLICAS}, {MESH_DGM_STEPS} "
              f"steps: sharded equals sequential bit for bit (final losses "
              f"{[f'{x:.4g}' for x in got[1][:, -1]]})")

        # (c) fused halving, sharded rungs against packed rungs.
        fred = Fredholm2(quadrature="gauss", k=16)
        for label, prob, extra, floor in (
                ("heat", Heat1D(), {}, 1),
                ("fredholm", fred, dict(space=SearchSpace({
                    "lrate": loguniform(1e-4, 1e-1),
                    "batch_size": randint(16, 512)})), 64)):
            got = run(f"(c) halving {label} pop mesh",
                      lambda: halving_search_fused(prob, seed=0, mesh=pop,
                                                   **MESH_HALVING, **extra))
            want = run(f"(c) halving {label}", lambda: halving_search_fused(
                prob, seed=0, **MESH_HALVING, **extra))
            if (got.best_index != want.best_index or not np.array_equal(
                    got.param_indices, want.param_indices)
                    or got.configs != want.configs):
                raise AssertionError(f"(c) halving {label}: the rungs kept "
                                     f"other trials on the mesh")
            tiles = _tiles_for(511, BUCKET_TILES, floor)
            top = tiles[-1]
            exact, worst = 0, 0.0
            for t, cfg in enumerate(got.configs):
                tile = next(x for x in tiles if x >= cfg["batch_size"])
                a, b = got.scores[t], want.scores[t]
                if tile == top:
                    exact += 1
                    if a != b:
                        raise AssertionError(f"(c) halving {label}: trial "
                                             f"{t} (tile {tile}) differs")
                else:
                    worst = max(worst, abs(a - b) / abs(b))
            if worst > MESH_TILE_RTOL:
                raise AssertionError(f"(c) halving {label}: a trial on "
                                     f"another tile parts by {worst:.3g}")
            pos = int(np.where(got.param_indices == got.best_index)[0][0])
            if next(x for x in tiles if x >= got.best_config["batch_size"]) \
                    == top:
                check_same(f"(c) halving {label}", "the winner's states",
                           got.params[pos], want.params[pos])
            print(f"(c) halving {label}: the same winner (trial "
                  f"{got.best_index}, score {got.best_score:.6g}) and "
                  f"survivors; {exact} trials on the mesh's tile {top} bit "
                  f"for bit, the others within {worst:.3g} (rtol "
                  f"{MESH_TILE_RTOL})")

        # (d) data-parallel train() with the graph, jvp and pallas taps.
        cfg = TrainConfig(iterations=MESH_TRAIN_STEPS, batch_size=64,
                          lrate=1e-4, verbose=False)
        for taps in ("jvp", "pallas"):
            prob = Heat1D(taps=taps)
            before = graph_counts("scan")[0]
            got = run(f"(d) train heat {taps} data mesh",
                      lambda: train(prob, 0, cfg, mesh=data))
            captures = graph_counts("scan")[0] - before
            want = run(f"(d) train heat {taps}", lambda: train(prob, 0, cfg))
            same(f"(d) train heat {taps}",
                 (got.loss_history, flat([got.params])),
                 (want.loss_history, flat([want.params])))
            if captures != 1:
                raise AssertionError(f"(d) {taps}: {captures} graphs "
                                     f"captured")
            print(f"(d) train(Heat1D(taps={taps!r}), mesh={{'data': 1}}): "
                  f"{MESH_TRAIN_STEPS} steps, the step with its NCCL "
                  f"all-reduce captured in one CUDA graph; "
                  f"{got.iters_per_sec:.1f} it/s against "
                  f"{want.iters_per_sec:.1f} without a mesh; bit for bit")
        if launches["(d) train heat pallas data mesh"][
                "heat_fused_streams"] <= 0:
            raise AssertionError("(d) pallas taps did not launch kernel #3")
        # Rows coupled across the data axis: a pre-BN heat MLP (heat's
        # widths, jvp taps) and causal advection (c = 50, eps = 5, its
        # batch and lr); at one rank no gather is on the path.
        for label, prob, make, batch, lr in (
                ("pre-BN heat", Heat1D(), lambda: MLP(
                    2, 1, 128, 3, "tanh", batch_norm="pre",
                    generator=generator(0)), 64, 1e-4),
                ("causal advection", Advection1D(**CAUSAL), lambda: None,
                 128, 1e-3)):
            cfg = TrainConfig(iterations=MESH_TRAIN_STEPS, batch_size=batch,
                              lrate=lr, verbose=False)
            before = graph_counts("scan")[0]
            got = run(f"(d) train {label} data mesh",
                      lambda: train(prob, 0, cfg, model=make(), mesh=data))
            captures = graph_counts("scan")[0] - before
            want = run(f"(d) train {label}",
                       lambda: train(prob, 0, cfg, model=make()))
            same(f"(d) train {label}",
                 (got.loss_history, flat([got.params]),
                  *got.params.buffers()),
                 (want.loss_history, flat([want.params]),
                  *want.params.buffers()))
            if captures != 1:
                raise AssertionError(f"(d) {label}: {captures} graphs "
                                     f"captured")
            print(f"(d) train({label}, mesh={{'data': 1}}): "
                  f"{MESH_TRAIN_STEPS} steps, final loss "
                  f"{got.loss_history[-1]:.6g}; {got.iters_per_sec:.1f} it/s "
                  f"against {want.iters_per_sec:.1f} without a mesh; bit "
                  f"for bit")

        # (e) a population sharded over pop.
        heat = Heat1D()
        lrs = np.geomspace(1e-4, 1e-2, MESH_POP_TRIALS)
        pc = PopulationConfig(iterations=MESH_POP_STEPS, max_batch_size=64)
        model = heat.default_model()
        got = run("(e) population pop mesh", lambda: train_population(
            heat, model, 0, lrs, config=pc, mesh=pop))
        want = run("(e) population", lambda: train_population(
            heat, model, 0, lrs, config=pc))
        same("(e) population", (got[2], *got[0].values()),
             (want[2], *want[0].values()))
        print(f"(e) population of {MESH_POP_TRIALS} x {MESH_POP_STEPS} "
              f"steps on {{'pop': 1}}: bit for bit")

        # (f) the multi-rank dry run at this world's one rank.
        run("(f) dryrun_multichip(1)", lambda: dryrun_multichip(1))
    finally:
        dist.destroy_process_group()
    return launches


# The CLI phase (python -m differential_equations_dnn_tpu_torch): heat's
# fused run at its reference defaults (the CLI's), resumed at a split that
# is not a multiple of the 50-step graph, and the scan engine at a split
# that cuts a 256-step graph block.
CLI_HEAT_STEPS = 15_000   # heat's CLI default
CLI_SPLIT = (7530, 7470)
CLI_SCAN = (300, 700)
CLI_HEAT_BOUND = 0.05
CLI_FREDHOLM_BOUND = 0.0134
CLI_SERVE_ATOL = 1e-5   # the exported program (torch ops) against #2
CLI_MODULE_STEPS = 500
CLI_SWEEPS = [("tpe-fused", ["--num-samples", "8", "--concurrent", "4"]),
              ("asha-fused", ["--num-samples", "9"])]
CLI_SWEEP_ITERS = 1000

# (e) A fresh ``python -I`` in which the port cannot be imported serves the
# exported heat solution on the card.
SERVE_CHILD = """
import json
import sys

sys.modules["differential_equations_dnn_tpu_torch"] = None
sys.modules["differential_equations_dnn_tpu"] = None
sys.modules["jax"] = None

import io
import numpy as np
import torch
from torch.export.passes import move_to_device_pass

program, grid, out = sys.argv[1:4]
program = torch.export.load(io.BytesIO(open(program, "rb").read()))
fn = move_to_device_pass(program, "cuda").module()
x = torch.from_numpy(np.load(grid)).cuda()
answers = {}
with torch.no_grad():
    for n in (x.shape[0], 1, 17):
        y = fn(x[:n])
        assert y.device.type == "cuda" and y.shape == (n, 1), y.shape
        answers[str(n)] = y.cpu().numpy()
np.savez(out, **answers)
print(json.dumps({"served": sorted(int(n) for n in answers)}))
"""


def phase_cli():
    """The command line, in this process and in two child processes; see
    CLI_* above. Each run's kernel launches are counted (set to 0 just
    before it, read just after) and printed; returns them."""
    import contextlib
    import io
    import os
    import shutil

    import numpy as np
    import torch

    from differential_equations_dnn_tpu_torch import cli
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.train.metrics import (
        mean_absolute_error,
    )

    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches = {}

    def run(label, argv, out):
        """``cli.main(argv)`` writing to ``work/out``; its printed lines
        (the scan trainer's per-100-step lines left out) and launches."""
        reset_counts()
        torch.cuda.synchronize()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv + ["--results-dir", str(work / out)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[label] = {k: v for k, v in read_counts().items() if v}
        text = buf.getvalue()
        for line in text.splitlines():
            if not line.startswith("Iteration:"):
                print(f"  {line}")
        print(f"cli {label}: {seconds:.2f} s; launches "
              + (", ".join(f"{k} {v}" for k, v in launches[label].items())
                 or "none"))
        return text

    def arrays(out, names):
        return [np.load(work / out / f"{n}.npy") for n in names]

    def manifest(out, name):
        return json.loads((work / out / f"{name}_run.json").read_text())[
            "params"]

    sol, loss, exact, fig = cli.ARTIFACTS["heat"]
    heat = ["heat", "--solve", "--engine", "fused"]

    # (a) heat at its reference defaults on #1, the grid on #2, exported.
    pt2 = work / "heat.pt2"
    run("(a) heat --solve --engine fused", heat + ["--export", str(pt2)], "a")
    u_a, l_a, y = arrays("a", (sol, loss, exact))
    mae_a = mean_absolute_error(y, u_a)
    rate_a = manifest("a", "heat")["iters_per_sec"]
    got = launches["(a) heat --solve --engine fused"]
    print(f"(a) heat fused, CLI defaults (15 000 steps, batch 64, lr 1e-4, "
          f"40x40 grid): MAE {mae_a:.6g} (bound {CLI_HEAT_BOUND}), "
          f"{rate_a} it/s, #1 {got.get('heat_fused_train_chunk', 0)} "
          f"launches, #2 {got.get('mlp_forward', 0)}")
    if not (u_a.shape == (40, 40) and l_a.shape == (CLI_HEAT_STEPS,)
            and np.all(np.isfinite(u_a)) and np.all(np.isfinite(l_a))):
        raise AssertionError(f"(a) shapes {u_a.shape}, {l_a.shape}")
    if not mae_a <= CLI_HEAT_BOUND:
        raise AssertionError(f"(a) MAE {mae_a} above {CLI_HEAT_BOUND}")
    for kernel in ("heat_fused_train_chunk", "mlp_forward"):
        if got.get(kernel, 0) <= 0:
            raise AssertionError(f"(a) {kernel} was not launched")

    # (b) the same run cut at a step that is not a multiple of the graph.
    first, second = CLI_SPLIT
    ck = work / "ck_fused"
    run(f"(b) heat fused --niters {first} --checkpoint",
        heat + ["--niters", str(first), "--checkpoint", str(ck)], "b")
    run(f"(b) heat fused --niters {second} --restore",
        heat + ["--niters", str(second), "--restore", str(ck)], "b")
    u_b, l_b = arrays("b", (sol, loss))
    if not (np.array_equal(u_b, u_a) and np.array_equal(l_b, l_a[first:])):
        raise AssertionError(f"(b) resumed fused run differs from (a): "
                             f"solution {np.max(np.abs(u_b - u_a)):.3g}")
    print(f"(b) {first} + {second} steps on #1: the solution and the "
          f"resumed {second} losses equal (a)'s bit for bit")

    # (c) the scan engine, cut inside a 256-step graph block.
    first, second = CLI_SCAN
    scan = ["heat", "--solve"]
    run(f"(c) heat scan --niters {first + second}",
        scan + ["--niters", str(first + second)], "c1")
    ck = work / "ck_scan"
    run(f"(c) heat scan --niters {first} --checkpoint",
        scan + ["--niters", str(first), "--checkpoint", str(ck)], "c2")
    run(f"(c) heat scan --niters {second} --restore",
        scan + ["--niters", str(second), "--restore", str(ck)], "c2")
    (u_c1, l_c1), (u_c2, l_c2) = arrays("c1", (sol, loss)), \
        arrays("c2", (sol, loss))
    if not (np.array_equal(u_c1, u_c2)
            and np.array_equal(l_c1[first:], l_c2)):
        raise AssertionError(f"(c) resumed scan run differs: solution "
                             f"{np.max(np.abs(u_c1 - u_c2)):.3g}")
    print(f"(c) scan {first} + {second} steps: bit for bit the "
          f"{first + second}-step run (MAE "
          f"{mean_absolute_error(arrays('c1', (exact,))[0], u_c1):.6g})")

    # (d) the plot phase reads (a)'s arrays. The card's machine may have no
    # matplotlib: then --savefig must exit naming it, and --plot alone
    # still prints the MAE.
    try:
        import matplotlib  # noqa: F401
        figures = True
    except ModuleNotFoundError:
        figures = False
    cwd = os.getcwd()
    os.chdir(work)
    try:
        if figures:
            text = run("(d) heat --plot --savefig",
                       ["heat", "--plot", "--savefig"], "a")
        else:
            try:
                run("(d) heat --plot --savefig",
                    ["heat", "--plot", "--savefig"], "a")
            except SystemExit as refusal:
                if "matplotlib" not in str(refusal.code):
                    raise
                print(f"(d) no matplotlib here: --savefig exits "
                      f"({refusal.code!r})")
            else:
                raise AssertionError("(d) --savefig without matplotlib "
                                     "did not exit")
            text = run("(d) heat --plot", ["heat", "--plot"], "a")
    finally:
        os.chdir(cwd)
    printed = float(text.split("DGM MAE:")[-1].split()[0])
    if printed != float(np.round(mae_a, 6)):
        raise AssertionError(f"(d) plot printed MAE {printed}, (a) {mae_a}")
    if figures and not (work / fig).exists():
        raise AssertionError(f"(d) {fig} not written")
    print(f"(d) printed MAE {printed} = (a)'s; "
          + (f"{fig} written" if figures else
             "no figure: matplotlib is not installed on this machine"))

    # (e) serve the export from a process that cannot import the port.
    grid = work / "grid.npy"
    np.save(grid, Heat1D().grid_inputs(40).numpy())
    served = work / "served.npz"
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-I", "-c", SERVE_CHILD, str(pt2), str(grid),
         str(served)], capture_output=True, text=True, timeout=300,
        cwd=work)
    if child.returncode != 0:
        raise AssertionError(f"(e) serving process failed:\n"
                             f"{child.stderr[-3000:]}")
    answers = np.load(served)
    full = answers["1600"].reshape(-1)
    err = float(np.max(np.abs(full - u_a.reshape(-1))))
    sub = max(float(np.max(np.abs(answers[str(n)].reshape(-1)
                                  - u_a.reshape(-1)[:n]))) for n in (1, 17))
    print(f"(e) python -I without the port: {pt2.stat().st_size} bytes "
          f"loaded on cuda, 1 600 grid points and n = 1, 17 served in "
          f"{time.perf_counter() - t0:.2f} s; max |served - #2's grid| "
          f"{err:.3g}, at n = 1 and 17 {sub:.3g} (atol {CLI_SERVE_ATOL})")
    if not (err <= CLI_SERVE_ATOL and sub <= CLI_SERVE_ATOL):
        raise AssertionError(f"(e) served solution parts from #2's by "
                             f"{max(err, sub)}")

    # (f) the module entry point, as a user runs it.
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", PKG, *heat, "--niters",
         str(CLI_MODULE_STEPS), "--results-dir", str(work / "f")],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if child.returncode != 0:
        raise AssertionError(f"(f) python -m {PKG} exited "
                             f"{child.returncode}:\n{child.stderr[-3000:]}")
    l_f = arrays("f", (loss,))[0]
    print(f"(f) python -m {PKG} heat --solve --engine fused --niters "
          f"{CLI_MODULE_STEPS}: exit 0 in {time.perf_counter() - t0:.2f} s, "
          f"{l_f.shape[0]} losses; its last line: "
          f"{child.stdout.strip().splitlines()[-1]}")
    if l_f.shape != (CLI_MODULE_STEPS,):
        raise AssertionError(f"(f) loss history {l_f.shape}")

    # (g) Fredholm on the DGM engine (#4 with #7) at its defaults.
    label = "(g) fredholm --solve --engine fused"
    run(label, ["fredholm", "--solve", "--engine", "fused"], "g")
    names = cli.ARTIFACTS["fredholm"]
    u_g, y_g = arrays("g", (names[0], names[2]))
    mae_g = mean_absolute_error(y_g, u_g)
    print(f"(g) fredholm fused: MAE {mae_g:.6g} (bound "
          f"{CLI_FREDHOLM_BOUND}), {manifest('g', 'fredholm')['iters_per_sec']}"
          f" it/s")
    if not mae_g <= CLI_FREDHOLM_BOUND:
        raise AssertionError(f"(g) MAE {mae_g} above {CLI_FREDHOLM_BOUND}")
    for kernel in ("fused_dgm_chunk", "dgm_step_math"):
        if launches[label].get(kernel, 0) <= 0:
            raise AssertionError(f"(g) {kernel} was not launched")

    # (h) the fused sweep tier through the CLI (#4/#5 in the sweep mode).
    for scheduler, extra in CLI_SWEEPS:
        label = f"(h) sweep --scheduler {scheduler}"
        run(label, ["sweep", "--equation", "heat", "--scheduler", scheduler,
                    "--max-iters", str(CLI_SWEEP_ITERS), *extra],
            f"h_{scheduler}")
        data = json.loads((work / f"h_{scheduler}" / "sweep_heat.json")
                          .read_text())
        print(f"(h) {scheduler}: {len(data['configs'])} trials, best "
              f"{data['best_score']:.6g} at {data['best_config']}")
        if not math.isfinite(data["best_score"]):
            raise AssertionError(f"(h) {scheduler}: best score "
                                 f"{data['best_score']}")
        if not any(v for k, v in launches[label].items()
                   if k.endswith("[sweep]")):
            raise AssertionError(f"(h) {scheduler} launched no kernel in "
                                 f"the sweep mode")
    return launches


def timed(phase, *args):
    """``phase(*args)``, its seconds printed after it."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    phase_device()
    import torch

    builder = start_build()
    try:
        pop_launches = timed(phase_population)
    finally:
        builder[0].join()  # no nvcc outlives a failed run
    phase_build(builder)
    rows = timed(phase_kernels)
    launches = timed(phase_solve)
    launches[("sweep",)], sweep_shapes = timed(phase_sweep)
    timed(phase_population_card, pop_launches)
    launches[("heat", "ensemble", "pallas")] = pop_launches[PALLAS_POP]
    timed(phase_mesh)
    timed(phase_cli)
    # Launches from each kernel's own path: #2 and #1 from constant-lr
    # heat, #3 from the scan solve of heat with pallas taps, #6 and #4 from
    # heat2d, #7 and #4 at the DGM layout from
    # FitzHugh–Nagumo, #5 from the wave and FitzHugh–Nagumo ensembles (the
    # shapes of their rows). On the main path #6 and #7 run inside #4's
    # launches, once per step: their rows count those runs, as
    # engine_train_packed and dgm_train_packed report them.
    source = {"mlp_forward": (("heat", None), "mlp_forward"),
              "heat_fused_train_chunk": (("heat", None),
                                         "heat_fused_train_chunk"),
              "heat_fused_streams": (("heat", "scan", "pallas"),
                                     "heat_fused_streams"),
              # #3's trial axis, from the population card's (g).
              "heat_fused_streams[trials]": (("heat", "ensemble", "pallas"),
                                             "heat_fused_streams"),
              "engine_loss_grad": (("heat2d", None), "engine_step_math"),
              "fused_engine_chunk": (("heat2d", None), "fused_engine_chunk"),
              "dgm_loss_grad": (("fitzhugh_nagumo", None), "dgm_step_math"),
              "fused_dgm_chunk": (("fitzhugh_nagumo", None),
                                  "fused_dgm_chunk"),
              "fused_engine_packed_chunk": (("wave", "ensemble"),
                                            "fused_engine_packed_chunk"),
              "fused_dgm_packed_chunk": (("fitzhugh_nagumo", "ensemble"),
                                         "fused_dgm_packed_chunk"),
              # The "default" instances (PR 13), from the bf16 solves.
              "heat_fused_train_chunk[default]": (
                  ("heat", "mixed"), "heat_fused_train_chunk[default]"),
              "engine_loss_grad[default]": (("heat2d", "mixed"),
                                            "engine_step_math[default]"),
              "fused_engine_chunk[default]": (
                  ("heat2d", "mixed"), "fused_engine_chunk[default]"),
              "dgm_loss_grad[default]": (("fitzhugh_nagumo", "mixed"),
                                         "dgm_step_math[default]"),
              "fused_dgm_chunk[default]": (("fitzhugh_nagumo", "mixed"),
                                           "fused_dgm_chunk[default]"),
              "fused_engine_packed_chunk[default]": (
                  ("wave", "mixed ensemble"),
                  "fused_engine_packed_chunk[default]"),
              "fused_dgm_packed_chunk[default]": (
                  ("fredholm", "mixed ensemble"),
                  "fused_dgm_packed_chunk[default]"),
              # The sweep mode, from the sweep phase's drivers.
              "fused_engine_chunk[masked]": (("sweep",),
                                             "fused_engine_chunk[sweep]"),
              "fused_engine_packed_chunk[per-slot]": (
                  ("sweep",), "fused_engine_packed_chunk[sweep]"),
              "fused_dgm_chunk[masked]": (("sweep",),
                                          "fused_dgm_chunk[sweep]"),
              "fused_dgm_packed_chunk[per-slot]": (
                  ("sweep",), "fused_dgm_packed_chunk[sweep]")}
    inside = {"engine_step_math": "fused_engine_chunk",
              "dgm_step_math": "fused_dgm_chunk",
              "engine_step_math[default]": "fused_engine_chunk[default]",
              "dgm_step_math[default]": "fused_dgm_chunk[default]"}
    for row in rows:
        # The LAST, hard and causal specs' own solves (the packed row's:
        # their ensemble solves).
        for spec_row in row.get("specs", ()):
            kind = ("hard" if "constraint" in spec_row else
                    "causal" if "causal_eps" in spec_row else None)
            run = ((spec_row["spec"], kind) if kind is None
                   or row["name"] != "fused_engine_packed_chunk" else
                   (spec_row["spec"], f"{kind} ensemble"))
            spec_row["launches"] = launches[run][source[row["name"]][1]]
            if spec_row["launches"] <= 0:
                raise AssertionError(f"{row['name']} at {spec_row['spec']} "
                                     f"has no launches")
        run, counter = source[row["name"]]
        row["launches"] = launches[run][counter]
        if counter.endswith("[sweep]"):
            # The sweep phase's launches at the row's own shape; all its
            # shapes beside them.
            by_shape = sweep_shapes[counter.split("[")[0]]
            row["launches"] = by_shape.get((row["tile"], row["n_replicas"]),
                                           0)
            row["sweep_launches_by_shape"] = {
                f"{B}x{N}": n for (B, N), n in sorted(by_shape.items())}
            row["launches_counted_as"] = (
                f"launches in the sweep mode in the sweep phase at tile "
                f"{row['tile']} with {row['n_replicas']} replicas")
        elif row["name"] == "heat_fused_streams[trials]":
            # (g)'s launches less the pick's 8 one-trial ones.
            row["launches"] -= 8
            row["launches_counted_as"] = (
                "launches with T = 8 in the population card's (g): one a "
                "population step and the graph capture's warm-up step")
        elif counter != row["name"]:
            row["launches_counted_as"] = (f"step-math runs inside "
                                          f"{inside[counter]}")
        if not all(math.isfinite(row[k]) for k in ("max_abs_err", "ms",
                                                   "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite measurement in {row}")
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} has no launches")
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
