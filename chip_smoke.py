#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
``--phases 1,2,12,18-21`` runs only those phases (phase 1 always; 7 adds 5,
15 adds 14 and 31 adds 27 and 28, whose flows they take) and ends with the
device line alone; with no argument every phase runs. It builds the hand-written CUDA kernels
from ``normalizingflows_torch/csrc`` and drives the port's paths through
them: reverse-KL ELBO training of the
neural spline flow (K1 forward, K2), its density path, maximum-likelihood
training through `log_prob` (K1 inverse, K3), and RealNVP (K4, K5, from
phase 12 on). The trainers run their step from a CUDA graph on the card
by default; phases 5, 6, 10, 11, 14, 16 and 17 pass ``graph=False`` and
drive the eager loop, phases 22-25 the graph. Launch counts come from
`normalizingflows_torch/ops/launches.py`, which counts a trainer's graph
at each replay:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc of csrc/*.cu, one process per source, its seconds and
   ptxas's registers and spill bytes of every kernel instantiation (K1–K6:
   K1 in both directions, staged and direct, K2/K3 staged and direct, K4
   on its lane and row tiles, K4, K5 and K6 in float32/float64 × H 16/32,
   K4 and K5 in both directions, the bf16 policy's tensor-core K4/K5 in
   both directions × H 16/32); a float32 or bfloat16 K1–K5, or any K6,
   that spills fails; a
   static count of the SASS instructions of K1's float32 K=10 forward
   staged instantiation (cuobjdump -sass) and the time that count would
   take to issue for each of N = 131072 elements on all the SMs'
   schedulers at the SM's top clock (a static estimate, not a floor); the
   HMMA instructions of each of the policy's kernels in the same SASS (a
   policy kernel without one fails);
3. kernels against their plain torch versions on the card: K1 forward and
   inverse, K2's and K3's gx/graw, at N = 64 (demo), 256 (MLE demo), 257
   (one live thread in the last CTA), 1000 (ragged) and 131072 (wide), K 8
   and 10, float32 and float64, raw read elem-major and param-major; every kernel on elem-major raw
   through its staged path and the direct read, with identical bits; raw
   padded to P = 3K−1+3 through K1/K2/K3 (pad gradient exactly 0, the rest
   equal to the unpadded call); the Pallas rows view (R=8, N/R=16384)
   through K1, equal to the flat param-major call; median device times of
   kernel, its direct read and plain version at N = 64, 256 and 131072
   beside the bound and its share, warm, and at 131072 with a cold L2;
4. one `elbo_from_samples` value-and-grad on the demo model with
   backend="cuda" and backend="plain" from identical parameters and draws;
5. the ELBO path: `train_flow` on the demo slice (nsf on Banana(2, 1, 100),
   64 samples, Adam(5e-4)) for 300 steps, with launch counts;
6. the wide configuration (d=64, hdims (128, 128), K=10, 10 layers, batch
   4096, float32) for 20 steps: steps/s and peak memory;
7. round trip: `log_prob(y)` through the inverse (K1) against
   `sample_and_log_prob`'s value on the trained demo flow;
8. one `loglikelihood` value-and-grad on the MLE demo flow, "cuda" against
   "plain" (K1 inverse and K3, no K2);
9. one `elbo_stl` value-and-grad on the ELBO demo, "cuda" against "plain"
   (K1 both directions, K2 and K3);
10. the density path: `train_flow_mle` on the MLE demo (the demo nsf on
    65,536 exact draws of Banana(2, 1, 10), batch 256, Adam(1e-3)) for 300
    steps: held-out mean log-likelihood before and after beside the
    target's E_p[log p], steps/s, launch counts;
11. MLE wide (d=64, hdims (128, 128), K=10, 10 layers, batch 4096, 65,536
    draws of Banana(64, 1, 10)) for 20 steps: steps/s and peak memory.

Then RealNVP (the fused coupling-stack kernels K4 `coupling_fwd` and K5
`coupling_bwd`, and the unfused module path beside them):

12. K4 and K5 against their plain versions (`tile_flow`, `tile_flow_bwd`)
    on the card: the demo model (d=2, [16,16]x3) at N 16, 300 (a ragged
    last lane tile) and 262,144 (K4's and K5's lane tiles, then their row
    tiles), at the last N of K4's lane tile (64 tiles of R rows: 4,096 in
    float32, 2,048 in float64) and one past it (the row tile, its last
    tile one row), the reference default ([32,32]x10) at N 256, d=5 with
    [8,8]x2 at N 300; float32 and float64, forward and inverse; y, ld, gx
    and every weight gradient, on rows drawn off the leaky ReLU's kink (no
    pre-activation within 1e-6 of 0, where gx has two one-sided values);
    K4 and K5 twice with identical bits, and K4 on its lane tile and its
    row tile (whatever the batch picks) with identical bits. Device times
    at N 16, 256, 262,144 and the two N around K4's switch of K4, K5 (both
    passes), the plain versions and the unfused `CouplingPairStack` forward
    and forward+backward on the same weights; K4 on each tile at N 1,024 to
    65,536 (where the switch belongs);
13. one `elbo_from_samples` value-and-grad on the demo through
    `realnvp(fused=True)` on the card, the same flow with backend "plain",
    and the unfused `realnvp` of the same seed (same weights);
14. the slice's main path: `train_flow` on `realnvp(2, (16, 16), nlayers=3,
    fused=True)` on Banana(2, 1, 100), `elbo_batch`, 16 samples,
    Adam(5e-4), 1,000 steps, with launch counts (one K4 and one K5 a
    step); then 1,000 steps of the unfused `realnvp` of the same seed;
15. sampling: `sample_and_log_prob` at batch 262,144 through K4 and through
    the unfused path (samples/s), and the round trip `log_prob(y)` (K4
    inverse) against `sample_and_log_prob`'s value;
16. the reference default `realnvp(2)` ([32,32]x10), batch 256, fused, 50
    steps: steps/s and launch counts;
17. wide unfused RealNVP (d=128, [256,256]x10, batch 4096, remat=True,
    float32) for 20 steps after 2: steps/s and peak memory, no kernel.

Then the whole-run training kernel K6 `realnvp_train` (many Adam/ELBO steps
of the fused stack a launch):

18. K6 against its plain version (`adam_train_plain`) on the card: 25 steps
    of the demo at batch 16, the reference default at batch 256 (8 row
    tiles in float32) and at batch 16 (one tile of 16 rows on 32 lanes
    each), and d=5 [8,8]x2 at batch 100 (a ragged tile), float32 and
    float64; the losses and every trained weight; K6 twice, and in chunks
    of 8 against one launch, with identical bits; the plain version's
    device time a step;
19. K6 against the eager K4/K5 step (`elbo_from_samples`, torch.optim.Adam)
    on the same 25 draws of the demo: the first loss and the trajectory;
20. the main path: `train_realnvp_fused` on the demo (1,000 steps, batch 16,
    Adam(5e-4)) in two K6 launches and no K4/K5 launch, steps/s and the
    device time of each launch (CUDA events), the ELBO beside phase 14's;
    then the reference default (batch 256, 50 steps);
21. the yardstick: one eager K4/K5 train step of the demo (base draws,
    forward, ELBO, backward, Adam(capturable=True)) captured in a CUDA
    graph and replayed 1,000 times: steps/s and device time a step.

Then the trainers' default on the card, the step captured once in a CUDA
graph and replayed (`train.py`), each cell graphed and then eagerly in the
same call (steps/s after the first chunk and overall, peak memory, launch
counts by replay, one capture):

22. `train_flow`: the NSF demo (phase 5's recipe, 300 steps) and wide
    (phase 6's shape, 40 steps in chunks of 20), K1 and K2 20 a step;
    graphed against eager on the same presampled draws (50 steps in
    chunks of 20, 20 and 10, both Adam(capturable=True)): per-step losses
    and final parameters within GRAPH_TOL, and whether the bits agree;
    the caller's generator draws anew at every replay (10 steps, 10
    distinct draws); a launch refused inside the capture raises, naming
    graph=False;
23. `train_flow_mle`: phase 10's recipe (300 steps; the held-out
    log-likelihood must rise) and phase 11's (40 steps), K1 and K3 20 a
    step; graphed against eager on the same batches;
24. `train_flow` on the fused RealNVP: the demo (1,000 steps) and the
    reference default (batch 256, 50 steps), one K4 and one K5 a step;
    graphed against eager on the same draws (100 steps); the draws differ
    between replays; steps/s beside phases 21 and 20;
25. `train_flow_annealed`: the NSF demo, β = 1/4, 2/4, 3/4 for 100 steps
    each and β = 1 for 200, one capture for all segments, the β column
    and K1/K2 20 a step; then graphed against eager on the same draws
    (20 steps a segment, β filled in place);
26. the graphed steps of the NSF demo and wide, the MLE demo and wide and
    the fused RealNVP demo and reference default under torch.profiler,
    over a chunk of replays: kernels a step, device busy time a step, the
    idle share, device time by category (run after phases 27-31, with
    their cells' profiles: a profiler run slows the host after it).

Then the classic flows, whose paths launch none of K1-K6 (each phase
resets the counts and asserts zero launches): each training cell graphed
(the default), then eagerly (graph=False), one capture, and graphed
against eager on the same presampled draws with identical bits (losses
and final parameters), then profiled as phase 26 profiles its cells (the
parity rows of benchmarks/PARITY.md, float64):

27. the planar demo: `planarflow(DiagNormal.standard(2), 10)` on
    Banana(2, 1, 10), `elbo_batch` with 32 samples, Adam(1e-2), 2,000
    graphed steps (a fifth of the parity row's; the port's parity
    harness runs the row at its full length) and 200 eager; the ELBO
    from 65,536 draws before and after beside the parity row's -0.3164
    (fails only if it is not finite or did not rise);
28. the radial demo: `radialflow` alike on `WarpedGauss(1, 0.12)`, beside
    -0.2255;
29. the Hamiltonian demo: `hamiltonian_flow(2, Funnel(2, -8, 5).score, 15,
    L=3, eps0=0.05)` on `joint_logp(Funnel.log_prob, 2)`, `elbo` with 16
    samples, Adam(3e-4), 2,000 graphed steps (a tenth of the parity row's)
    and 50 eager; the ELBO must rise (parity row -2.4701 at 20,000);
30. the double backward under the graph: `hamiltonian_flow` with
    Banana(2, 1, 10)'s autograd score and 3 blocks, 50 steps graphed and
    eager on the same presampled draws; if the capture is refused,
    train_flow raises naming graph=False, and the phase says so and runs
    that case with graph=False;
31. on the card, the planar and radial demo flows phases 27 and 28
    trained: the round trip at 65,536 rows in float64 and cast to float32
    (the JAX suite's criterion, tests/test_flows.py: |x - T^-1(T(x))| <=
    rtol * max(max|x|, 1), rtol 1e-4 float32 and 1e-9 float64, and the
    log-dets alike); `log_prob` and its gradient (through the root
    solver) against the same flow on the CPU in float64 (rtol 1e-9, atol
    1e-12). A flow at its random init can hold a planar layer near
    singular (w'u_hat near -1), where float32 loses the criterion at a few
    of 65,536 rows in both packages alike.

Then the rest of the flow zoo, float32, each training cell graphed, then
eagerly, one capture, and graphed against eager on the same presampled
draws or batches with identical bits (strict), profiled after every
other phase as phase 26 profiles its cells:

32. nsf_banana_hard's model (benchmarks/parity.py:222-241):
    `nsf(2, identity_init=True, affine_wrap=True)` (an ActNorm each side
    of the spline stack) on Banana(2, 1, 100), `elbo_batch` 64,
    Adam(5e-4), 300 graphed and 20 eager steps, K1 and K2 20 a step, no
    K3; `evaluate_flow` from 65,536 draws before and after (ELBO ± SEM,
    log Z estimate, ESS/n; the ELBO must rise). No parity claim: the
    row's warmup-cosine schedule is not ported;
33. NSF wide (phase 6's shape) with `remat=True` and without, 20 steps
    each graphed and eagerly on the same draws and weights: K1 and K2 20
    a step in all four runs (the selective remat never runs K1 again),
    remat against no remat within GRAPH_TOL with its bits reported, peak
    allocated memory and steps/s of each; then steps/s of the default
    graphed run (60 steps, chunks of 20) in turns: no remat, remat,
    remat, no remat;
34. the MLE demo (phase 10's recipe) with `remat=True`, 50 steps: K1
    (inverse) and K3 20 a step, no K2; the held-out log-likelihood must
    rise; remat against no remat on the same batches within GRAPH_TOL;
35. the glow demo (benchmarks/parity.py:332-345): `glow(2, (32, 32),
    nlayers=6)`, `glow_init_actnorms` on 1,024 base draws, `Cross()`,
    `elbo_batch` 64, Adam(2e-3), 1,000 graphed and 50 eager steps, no
    K1-K6 launch; the ELBO must rise; the trained flow's round trip at
    65,536 rows through the triangular solves (phase 31's criterion,
    float32 rtol 1e-4);
36. the IAF demo (:347-359): `iaf(2, (32, 32), nlayers=5)` on
    Banana(2, 1, 10), `elbo_batch` 64, Adam(2e-3), 1,000 graphed and 50
    eager steps, no K1-K6 launch; the round trip through the sequential
    inverse at 65,536 rows;
37. the MAF demo (:361-373): `maf(2, (32, 32), nlayers=5)` by
    `train_flow_mle` on phase 10's 65,536 exact draws of Banana(2, 1, 10),
    batch 256, Adam(1e-3), 300 graphed and 50 eager steps, no K1-K6
    launch; the held-out log-likelihood before and after beside the
    target's E_p[log p]; `sample` (the sequential direction) and the round
    trip at 65,536 rows.

Then the experiment path, float32, each run graphed (the default):

38. the NSF wide configuration (phase 6's shape,
    benchmarks/roofline.py:245-258, with the config's random init) as a
    TrainConfig through config_from_json(config_to_json(...)):
    `TrainConfig.run` for 40 steps in chunks of 10, against 20 steps →
    `save_train_state` (with the training generator) → a fresh flow,
    Adam and generator built from the same JSON → `load_train_state` →
    20 steps: identical bits in the losses, the parameters, the Adam
    state and the generator (strict), K1 = K2 = 20 a step by replay in
    each run; the resume made three times from the one checkpoint, each
    with the first's bits; the generator after 20 replayed steps equals 20
    eager steps'; the checkpoint's size, save and load times, and each
    run's first chunk (3 eager steps and the capture) against the later
    ones;
39. `FlowConfig(family="realnvp", fused=True)` at the demo shape from
    JSON, 1,000 steps, one K4 and one K5 a step; `save_pytree` →
    `load_pytree` into a flow of another seed: sampling 262,144 rows from
    one seed gives identical bits;
40. MLE wide from a raw float32 file of 65,536 exact draws of
    Banana(64, 1, 10) (16.8 MB, written under build/chip_smoke/) through
    `TrainConfig(objective="mle", data_path=...)`, batch 4,096, 20 steps:
    K1 (inverse) and K3 20 a step; the batches on the card (a spy on the
    step runner's input buffer) equal the same seed's `NativeLoader`
    batches read on the host; a chunk's host time in the loader and the
    copy, `NativeLoader` against `NumpyLoader` and page-locked against
    pageable, beside the chunk's device time (CUDA events);
41. `utils.profiling`: `time_scan_steps` on the graphed NSF demo step
    (300 and 600 steps) beside phase 22's steps/s, and `trace` around 20
    graphed steps writing a Chrome trace that holds K1/K2's kernels (run
    after phase 42: a profiler run slows the host after it);
42. SGD under the trainers' graph: a config with optimizer "sgd" (no
    capturable mode, no step count) captures, K1/K2 20 a step by replay,
    and graphed against eager on the same draws gives identical bits
    (strict).

Then the demos and the parity rows, float32 unless the recipe says
otherwise:

43. the learning-rate schedule inside the graphed step: nsf_banana_hard's
    model (`affine_wrap`, identity init, batch 64) under
    `optim.adam(warmup_cosine_decay_schedule(0, 5e-4, 100, 600, 1e-5))`,
    600 steps graphed and then eagerly on the same draws, identical bits
    (strict); at each chunk boundary the group's lr equals the CPU port's
    schedule at that count within 1 ulp; K1 = K2 = 20 a step by replay;
    resumed from `save_train_state` at step 50 (the warmup) and 300 (the
    decay) into a fresh flow, optimizer and generator, the straight run's
    bits; a float lr a callback writes under the graph raises; graphed
    steps/s with and without the schedule in turns, and the scheduled step
    profiled as phase 26 profiles its cells;
44. the seven demos (`normalizingflows_torch/examples/demo_*.py`) through
    their `main()`, graphed: the NSF demo (400 steps, and 400 with
    `--affine-wrap`'s schedule) with K1 and K2 20 a step, the RealNVP,
    planar, radial, Hamiltonian, Glow and MAF (`to_raw_file`, the native
    loader) demos with none of K1-K6; each training ELBO rises, and each
    printed one but the Hamiltonian demo's heavy-tailed 512-draw estimate;
45. the parity harness (`normalizingflows_torch/examples/parity.py`) at
    its quick counts: the eight rows of benchmarks/parity.py and the fused
    (one K4 and one K5 a step) and K6 (a launch per 512 steps) routes of
    the RealNVP row, each row's fields finite and its ELBO rising by more
    than twice the SEMs (the Hamiltonian row at 100 steps reported), and
    its launches.

Then bfloat16: the bf16 ``compute_dtype`` policy (bfloat16 operands,
float32 sums; the conditioners' products are cuBLAS calls,
``torch.mm(..., out_dtype=float32)``) and bfloat16 parameters, with the
kernels' bfloat16 instantiations (csrc/rqs_bf16.cu, csrc/coupling_bf16.cu),
whose launches count apart (``rqs_fwd_f32_rbf16``, ``coupling_fwd_bf16``,
...):

46. K1–K3 on (x float32, raw bfloat16) and (x, raw bfloat16) against
    their plain versions, bit for bit, at N 64/256/257/131,072, K 8/10:
    staged elem-major, the direct read, param-major and padded (exact-zero
    pad gradients); device times at K=10 warm and cold beside the byte
    bound with two-byte raw;
47. K4/K5's policy (its tensor-core kernels, csrc/coupling_mma.cuh) and
    bfloat16-storage instantiations against their plain versions at the
    demo's N 16/300/262,144, forward and inverse, within CPL_BF16_TOL,
    and the policy on d=8 [32,32,32]x10 (a stack staged a coupling at a
    time) at N 4,096 against a float64-summed witness; each twice with
    identical bits; bfloat16 storage's two
    K4 tiles with identical bits; the policy's rows split at a 16-row
    boundary into two launches of K4 and K5 with identical bits (N 300 and
    262,144); device times beside the float32 kernels';
48. the slice's main path: wide RealNVP (d=128, [256,256]x10, remat, batch
    4096, Adam(1e-3), Banana(128, 1, 100)) under the policy through the
    graphed `train_flow`: graphed against eager identical bits (strict),
    no K1-K6 launch, the first loss within 5 % of float32's from the same
    init and draws and both falling, steps/s in turns against float32,
    peak memory, a profile;
    the product's bits against `allow_bf16_reduced_precision_reduction`;
49. NSF wide under the policy, with and without remat: K1 and K2 on
    bfloat16 raw 20 a step, graphed against eager identical bits, remat
    against no remat, the loss against float32's, steps/s in turns, a
    profile; the MLE demo under the policy (K1 inverse and K3 on bfloat16
    raw);
50. bfloat16 parameters: `FlowConfig(dtype="bfloat16")` from JSON for
    realnvp (unfused and fused: K4/K5 ``_bf16``), nsf (ELBO: K1/K2
    ``_bf16``; MLE: K1 inverse and K3 ``_bf16``), glow, maf and iaf
    through `TrainConfig.run`, 200 graphed steps each: launches, falling
    finite losses, bfloat16 parameters, a checkpoint round trip;
51. the fused RealNVP demo under the policy, 1,000 graphed steps, one K4
    and one K5 ``_f32_cbf16`` a step, graphed against eager identical
    bits; the reference default under the policy (batch 256, 50 graphed
    and eager steps, the H = 32 tile); `sample_and_log_prob` at 262,144
    under the policy (K4 once a call) and its round trip; the demo's
    graphed steps/s in turns against the float32 fused demo; both cells
    profiled after every other phase.

Then K6 on the targets JAX's kernel takes besides Banana, and on bfloat16
parameters (``realnvp_train_bf16``, csrc/train_bf16.cu, counted apart):

52. K6 against `adam_train_plain` on Funnel(d, -8, 5) at every phase-18
    shape, WarpedGauss(1.0, 0.12) at the d=2 shapes and WarpedGauss with
    ``ref_compat`` on the demo, float32 and float64, 25 steps: the losses
    and every trained weight; K6 twice, and in chunks of 8, with identical
    bits;
53. the slice's main path: `train_realnvp_fused` on the RealNVP demo
    (1,000 steps, batch 16, Adam(5e-4), two K6 launches) on the radial
    demo's WarpedGauss(1.0, 0.12) and the Hamiltonian demo's
    Funnel(2, -8, 5), each ELBO rising (the mean of the first 100 steps'
    against the last 100's), steps/s and the device time of each launch
    (CUDA events); the reference default (batch 256, 50 steps, one launch)
    on each; and on each target K6 against the eager K4/K5 step with
    torch.optim.Adam on the same 25 draws (first loss, trajectory);
54. `realnvp_train_bf16` against its plain version (the demo at batch 16,
    the reference default at batch 256, 25 steps) within TRAIN_BF16_TOL,
    twice and in chunks of 8 with identical bits; the bfloat16 demo on
    Banana(2, 1, 100) through `train_realnvp_fused` (1,000 steps, two
    launches, the ELBO rising); K6 in bfloat16 against the eager bfloat16
    step (K4/K5 ``_bf16`` and torch.optim.Adam) on the same 25 draws.

Then the sharded path (`normalizingflows_torch/parallel/`: the launcher,
the 1-D batch mesh, `shard_objective` with JAX's replicated gradient,
`sample_sharded`) and the multi-rank checkpoint (``backend="dcp"``):

55. the slice's main path: `parallel.initialize()` through its NF_*
    variables (one NCCL rank), `batch_mesh()`, and the graphed
    `train_flow(per_shard_key(55), shard_objective(elbo_batch, mesh),
    ...)` on the NSF demo (300 steps, K1 and K2 20 a step) and the fused
    RealNVP demo (1,000 steps, one K4 and one K5 a step), in turns with
    the unwrapped run from a generator in the same state (sharded,
    unwrapped, unwrapped, sharded): every loss, gradient norm and final
    parameter identical bits (strict), equal launch counts by replay, one
    capture each, steps/s of each; each cell's replays profiled with and
    without the wrapper after every rate of the call (kernels a step, the
    kernels the wrapper adds, NCCL's own kernels and their device time);
56. NSF wide (phase 6's shape, 20 graphed steps) through the wrapper,
    against the unwrapped run bit for bit as in 55; `sample_sharded` of
    the NSF demo flow at 262,144 rows: finite, global shape (262,144, 2),
    placed [Shard(0)], equal to `flow.sample` from the same generator
    state, K1 20 times;
57. two ranks on the one card (spawned processes, gloo, each on cuda:0,
    eager: gloo cannot be captured): the NSF demo at `elbo_batch` 64 (32 a
    rank) for 20 steps, K1 and K2 20 a step in each rank, both ranks
    identical bits in every loss, gradient norm and final parameter; the
    first step's value and gradients on 64 shared rows (each rank its 32)
    against one rank's on all 64 within FIRST_RANK_TOL; `sample_sharded`
    at 262,144 rows (131,072 a rank), the ranks' blocks differ;
58. the DCP round trip on the two ranks: the NSF demo flow and a
    [Shard(0)] DTensor of 262,144 samples through `save_pytree(...,
    backend="dcp")`, `barrier()`, `load_pytree` into a template of another
    seed: each rank's local shard and the parameters equal to what was
    saved bit for bit, the ranks' checksums equal, the bytes and the save
    and load times.

Any failure raises, so the exit code is not 0. Without a CUDA device, or
outside a checkout of the repository, it fails before printing a result.
The last line of standard output is the device JSON; the line before it the
per-kernel JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import json
import math
import os
import re
import statistics
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

DEVICE = "cuda"
B = 30.0              # the NSF box half-width (nsf default)
# phase 3: N of the comparisons (257 leaves one live thread in its last
# CTA, 1000 a ragged one) and of the timings (the NSF demo's 64, the MLE
# demo's 256, wide 131072)
SIZES = (64, 256, 257, 1000, 131072)
RQS_TIMED = (64, 256, 131072)
FLUSH_BYTES = 64 << 20  # written between calls for a cold 50 MB L2
DEMO = dict(q0=2, hdims=(32, 32), K=10, B=B, nlayers=10, identity_init=True)
WIDE = dict(q0=64, hdims=(128, 128), K=10, B=B, nlayers=10,
            identity_init=True)
DEMO_STEPS, DEMO_BATCH, DEMO_LR = 300, 64, 5e-4
WIDE_STEPS, WIDE_BATCH, WIDE_LR = 20, 4096, 1e-3
# the density path: MLE on exact draws of Banana(d, 1, 10)
MLE_ROWS, MLE_HELD_OUT, MLE_LR = 65536, 8192, 1e-3
MLE_STEPS, MLE_BATCH = 300, 256
MLE_WIDE_STEPS, MLE_WIDE_BATCH = 20, 4096
# the card's published peaks (H100 SXM datasheet, at 700 W, dense):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s,
# bfloat16 operands summed in float32 on the tensor cores 989 TFLOP/s
PEAK_BYTES_PER_S, PEAK_F32_PER_S, PEAK_BF16_PER_S = 3.35e12, 67e12, 989e12
# RealNVP: the demo (bench.py:37-43, example/demo_RealNVP.jl), the
# reference default (`realnvp` defaults, Agrawal–Sheldon–Domke) and the wide
# GEMM-bound shape of the unfused path (benchmarks/roofline.py:180-193)
RNVP_DEMO = dict(q0=2, hdims=(16, 16), nlayers=3)
RNVP_REF = dict(q0=2, hdims=(32, 32), nlayers=10)
RNVP_ODD = dict(q0=5, hdims=(8, 8), nlayers=2)
RNVP_WIDE = dict(q0=128, hdims=(256, 256), nlayers=10, remat=True)
RNVP_STEPS, RNVP_BATCH, RNVP_LR = 1000, 16, 5e-4
RNVP_REF_STEPS, RNVP_REF_BATCH = 50, 256
RNVP_WIDE_STEPS, RNVP_WIDE_BATCH, RNVP_WIDE_LR = 20, 4096, 1e-3
SAMPLE_BATCH, SAMPLE_REPS = 262144, 10
# (model, N) of the phase-12 comparisons, and the (model, N) timed
CPL_SHAPES = (("demo", 16), ("demo", 300), ("demo", 262144), ("ref", 256),
              ("odd", 300))
CPL_TIMED = (("demo", 16), ("ref", 256), ("demo", 262144))
# K4 timed on each tile at these N (demo and reference default, float32)
FWD_SWEEP = (1024, 2048, 4096, 8192, 16384, 32768, 65536)
# phase 12 draws a row of x again where a leaky-ReLU pre-activation of the
# stack lies within KINK of 0 (`_kink_rows`)
KINK = 1e-6
CPL_CFG = {"demo": RNVP_DEMO, "ref": RNVP_REF, "odd": RNVP_ODD}
KERNELS = ("rqs_fwd", "rqs_bwd_fwddir", "rqs_bwd_invdir")
CPL_KERNELS = ("coupling_fwd", "coupling_bwd")
# K6: (model, batch) of the phase-18 comparisons, their steps, and the
# reference default's steps on phase 20
TRAIN_SHAPES = (("demo", RNVP_BATCH), ("ref", RNVP_REF_BATCH),
                ("ref", RNVP_BATCH), ("odd", 100))
TRAIN_CMP_STEPS, TRAIN_REF_STEPS, GRAPH_STEPS = 25, 50, 1000
REPLACES = {
    "rqs_fwd": "normalizingflows/jl_tpu/ops/rqs_pallas.py:649, :541, :685",
    "rqs_bwd_fwddir": "normalizingflows/jl_tpu/ops/rqs_pallas.py:717, :576 "
                      "(forward direction)",
    "rqs_bwd_invdir": "normalizingflows/jl_tpu/ops/rqs_pallas.py:717, :576 "
                      "(inverse direction)",
    "coupling_fwd": "normalizingflows/jl_tpu/experimental/coupling_pallas.py"
                    ":371",
    "coupling_bwd": "normalizingflows/jl_tpu/experimental/coupling_pallas.py"
                    ":438",
    "realnvp_train": "normalizingflows/jl_tpu/experimental/train_pallas.py"
                     ":254",
}
REPLACES["realnvp_train_bf16"] = REPLACES["realnvp_train"] + ", bfloat16"
# the bfloat16 instantiations replace the same Pallas kernels: their bf16
# raw feed (K1–K3) and `compute_dtype` (K4/K5)
for _k in KERNELS:
    for _s in ("f32_rbf16", "bf16"):
        REPLACES[f"{_k}_{_s}"] = REPLACES[_k] + ", bfloat16"
for _k in CPL_KERNELS:
    for _s in ("f32_cbf16", "bf16"):
        REPLACES[f"{_k}_{_s}"] = REPLACES[_k] + ", bfloat16"
# Kernel against plain version. f32: tests/test_rqs_kernel.py:43-44 (values
# rtol/atol 1e-5; log-dets rtol 1e-4, atol 1e-5) and :78-79 (gradients rtol
# 2e-3, atol 1e-4). f64: rtol 1e-9, atol 1e-10, the same differences at f64
# precision. Built without contraction, the kernel rounds as the plain
# version does; these bound what exp/log implementations may still move.
TOL = {
    torch.float32: dict(y=(1e-5, 1e-5), ld=(1e-4, 1e-5), g=(2e-3, 1e-4)),
    torch.float64: dict(y=(1e-9, 1e-10), ld=(1e-9, 1e-10), g=(1e-9, 1e-10)),
}
# Same train step on the two backends (float32): the gradient tolerance
# above, over 20 couplings whose differences add up.
STEP_TOL = (2e-3, 1e-4)
# Round trip log_prob(y) vs sample_and_log_prob (float32, log-densities of
# order 1-10 nats through 20 couplings each way, the inverse amplifying
# roundings where a spline's slope nears its 1e-3 floor; a CPU run of the
# plain path reached 1e-3): rtol 1e-3, atol 1e-2.
ROUND_TRIP_TOL = (1e-3, 1e-2)
# K4/K5 against their plain versions use TOL too: in float32 they are also
# the JAX suite's fused-coupling tolerances (tests/test_coupling_kernel.py
# :35-36, 65, 80). Not bit for bit here: the plain version's matmuls go
# through cuBLAS and sum in another order. The cotangents are those of a
# mean over the batch (scaled by 1/N), as the ELBO's are, so the weight
# gradients' batch sums stay of order 1 at every N.
# K6 against its plain version: the training tolerances of
# tests/test_torch_coupling.py:54 (losses and trained weights); against the
# eager K4/K5 step with torch.optim.Adam: the bounds of
# tests/test_train_kernel.py:83-85 (first loss rel 1e-6, trajectory max
# |Δ|/(|loss| + 1) 5e-5).
TRAIN_TOL = {torch.float32: (1e-4, 1e-5), torch.float64: (1e-8, 1e-12)}
FIRST_LOSS_REL, TRAJECTORY_REL = 1e-6, 5e-5
# phases 22-25: the trainers' CUDA graph. Graphed and eager runs on the same
# inputs, both with Adam(capturable=True), must agree per step and in the
# final parameters within GRAPH_TOL (the same kernels in the same order
# should give identical bits, which is printed); SAME_STEPS of them in
# chunks of SAME_CHECK (20, 20, 10: a short last chunk); DRAW_STEPS steps
# whose base draws must all differ; annealing: ANNEAL_BETAS segments of
# ANNEAL_ITERS steps, the last twice as long
GRAPH_TOL = (1e-5, 1e-6)
SAME_STEPS, SAME_CHECK, DRAW_STEPS = 50, 20, 10
ANNEAL_BETAS, ANNEAL_ITERS = 4, 100
# phases 27-31: the classic flows (benchmarks/parity.py's planar, radial
# and hamiltonian rows, float64). Graphed and eager steps a cell, batch,
# learning rate, and the parity row's final ELBO (benchmarks/PARITY.md);
# the ELBO of a flow from ELBO_DRAWS draws (the same before and after);
# the round trip and the log_prob check of phase 31 at ROWS rows; phase
# 30's steps; profiled replays a cell (phase 26's method)
CLASSIC = {
    "planar": dict(steps=2_000, eager=200, batch=32, lr=1e-2,
                   parity=-0.3164, parity_steps=10_000, profile=100),
    "radial": dict(steps=2_000, eager=200, batch=32, lr=1e-2,
                   parity=-0.2255, parity_steps=10_000, profile=100),
    "hamiltonian": dict(steps=2_000, eager=50, batch=16, lr=3e-4,
                        parity=-2.4701, parity_steps=20_000, profile=20),
}
CLASSIC_LAYERS, HAM_BLOCKS, HAM_DOUBLE_BLOCKS = 10, 15, 3
ELBO_DRAWS, ROWS, DOUBLE_STEPS = 65_536, 65_536, 50
CLASSIC_ROUND_TRIP = {torch.float32: 1e-4, torch.float64: 1e-9}
CPU_TOL = (1e-9, 1e-12)
CLASSIC_KINDS = {27: "planar", 28: "radial", 29: "hamiltonian"}
# what phase 26's method reports of a profiled cell
PROFILE_KEYS = ("kernels_per_step", "device_busy_ms_per_step",
                "wall_ms_per_step", "device_idle_share",
                "ms_per_step_by_category")
# phases 32-37: the rest of the flow zoo, float32. nsf_banana_hard's model
# (benchmarks/parity.py:222-241, without its warmup-cosine schedule) for
# WRAP_STEPS graphed and WRAP_EAGER eager steps; NSF wide with and without
# remat for WIDE_STEPS steps each in chunks of WIDE_STEPS // 2, on the same
# draws; the MLE demo with remat for MLE_REMAT_STEPS; the glow, iaf and maf
# demos (benchmarks/parity.py:332-373): graphed and eager steps, batch,
# learning rate, the parity row (benchmarks/PARITY.md) and its steps, and
# the profiled replays; the diagnostics from ELBO_DRAWS draws, the round
# trips at ROWS rows within CLASSIC_ROUND_TRIP
NSF_WRAP = dict(DEMO, affine_wrap=True)
WRAP_STEPS, WRAP_EAGER, MLE_REMAT_STEPS, RATE_CHUNK = 300, 20, 50, 20
GLOW_INIT_ROWS = 1024
ZOO = {
    "glow": dict(steps=1_000, eager=50, batch=64, lr=2e-3, parity=-0.0674,
                 parity_steps=10_000, profile=100),
    "iaf": dict(steps=1_000, eager=50, batch=64, lr=2e-3, parity=-0.0506,
                parity_steps=10_000, profile=100),
    "maf": dict(steps=300, eager=50, batch=MLE_BATCH, lr=1e-3,
                parity=-4.0476, parity_steps=3_000, profile=100),
}
ZOO_KINDS = {35: "glow", 36: "iaf", 37: "maf"}
# phases 38-42: the experiment path. The NSF wide and fused RealNVP demo
# configurations run EXP_STEPS / RNVP_STEPS graphed steps from JSON (chunks
# of EXP_CHECK for the wide ones); checkpoints, raw data and the trace go to
# EXP_DIR in the checkout (.gitignore lists build/); a chunk's loader and
# copy timed over LOADER_CHUNKS chunks; time_scan_steps at SCAN_STEPS and
# twice as many; SGD_STEPS steps of SGD(SGD_LR) under the graph
EXP_STEPS, EXP_CHECK, EXP_DIR = 40, 10, Path("build") / "chip_smoke"
RESUMES = 3  # phase 38 resumes from its checkpoint this many times
LOADER_CHUNKS, SCAN_STEPS, SGD_STEPS, SGD_LR = 5, 300, 50, 1e-4
# phase 43: nsf_banana_hard's model under optim.adam(warmup_cosine(SCHED)),
# SCHED_STEPS steps in chunks of SCHED_CHECK, resumed at SCHED_RESUMES;
# the rate a step with and without the schedule, in turns (without, with,
# with, without) of RATE_STEPS steps
SCHED = (0.0, 5e-4, 100, 600, 1e-5)
SCHED_STEPS, SCHED_CHECK, SCHED_RESUMES = 600, 50, (50, 300)
RATE_STEPS = 300
# phase 44: the seven demos through their main() (module, keywords, steps,
# K1/K2 launches a step); the NSF demo's 100-step endpoint is chaotic, so
# 400 (SKILL.md)
DEMO_RUNS = (("demo_neural_spline_flow", {}, 400, 20),
             ("demo_neural_spline_flow", {"affine_wrap": True}, 400, 20),
             ("demo_realnvp", {}, 1000, 0),
             ("demo_planar_flow", {}, 1000, 0),
             ("demo_radial_flow", {}, 1000, 0),
             ("demo_hamiltonian_flow", {}, 300, 0),
             ("demo_glow", {}, 500, 0),
             ("demo_maf_mle", {}, 300, 0))
# phase 45: the parity harness at its quick counts; the row whose quick
# count is too short for a significant rise in either package (the JAX
# harness's own hamiltonian(100): -6.2408±1.0214 -> -4.8034±0.2549 on the
# CPU) is reported, not held to it
PARITY_NOT_SIGNIFICANT = ("hamiltonian_funnel",)
# phases 46-51: bfloat16. Phase 46: K1–K3's (x, raw) instantiations and
# their sizes; phase 47: K4/K5's variants ((dtype, compute_dtype)), their
# N, and their tolerances against the plain versions. The policy rounds
# the same operands on both sides but sums in other orders (cuBLAS against
# FMA chains), so a float32 difference of an ulp can round a later operand
# to the neighbouring bfloat16 (2^-8 apart); a row holds hundreds of such
# roundings, so some rows flip one, and an exp, a small output or a
# leaky-ReLU pre-activation near 0 (slope 1 or 0.01) can make that a
# large relative change (on the card at 262,144 rows: 1 of 524,288 y
# elements moved 0.0265 at |y| 0.0045, and 2 gx elements 1.77 times the
# cotangents' scale, 1/N). So two levels: every y and ld element within
# JAX's own bf16 policy bound against float32, rtol/atol 0.05
# (tests/test_dtype_policy.py), every gx element within rtol 0.05 and 4
# times the cotangents' scale (atol 4/N), every weight gradient within
# rtol 0.05 and 0.05 times its largest element; and at most FLIP_SHARE
# of y, ld and gx outside FLIP_TOL, the float32 plain version's roundoff.
# A weight gradient is a sum over the N rows, whose conditioning varies
# with the leaf and the direction (the float32 K5 itself is 1e-6 to 1e-3
# off its plain version, relative L2, at 262,144 rows), so each leaf's
# relative L2 error is held to LEAF_FACTOR times the float32 K5's on the
# same inputs, plus LEAF_FLOOR (`_leaf_check`). Readings on the card: the
# policy at most 59 times float32's; K5 summing unrounded gW operands
# 2,081 to 23,000 times at N 16, 300 and 262,144 inverse (14 to 78 times
# at 262,144 forward, where the sums cancel most). bfloat16 storage
# rounds one float32 value once on each side: the float32 tolerances
# (TOL) plus 2^-7, each weight gradient's atol scaled by its largest
# element where that is below 1.
RQS_BF16_SIZES = (64, 256, 257, 131072)
RQS_BF16_TYPES = ((torch.float32, "f32_rbf16"), (torch.bfloat16, "bf16"))
CPL_BF16_VARIANTS = {"f32_cbf16": (torch.float32, torch.bfloat16),
                     "bf16": (torch.bfloat16, None)}
CPL_BF16_N = (16, 300, 262144)
# the policy's rows split at a 16-row boundary into two launches at these N
# (300: 18 whole tiles of 16 and 12 rows); its kernels also on a stack at
# the kernels' bounds, d = 8 (n_A = n_B = 4: the head's whole n8 tile) and
# [32,32,32] conditioners, whose 10 blocks are too many to stage whole, at
# CPL_DEEP_N rows. Its 20 perturbed couplings amplify roundoff: y reaches
# thousands, and the plain version with its products summed in float64
# (`_dot_witness`: the same roundings, another order) is itself past the
# elementwise tolerances (y by up to 63 on the card at 4,096 rows). So it
# is held to that witness: each output's and gradient's relative L2 error
# from the plain version at most DEEP_WITNESS_FACTOR times the witness's,
# plus LEAF_FLOOR (`_witness_check`). On the card, two draws, both
# directions: the kernels at most 4.87 times; two faulty products on the
# plain version (`WITNESS_CONTROLS`: sums rounded to bfloat16, operands not
# rounded) at least 78.0 times in their largest output, which the phase
# requires past the factor. The reference default (20 couplings of H = 32)
# runs at its batch, RNVP_REF_BATCH, within CPL_BF16_TOL; its flipped
# share and weight-gradient ratio are read beside the witness's, which is
# past FLIP_SHARE (up to 1.6 %) and LEAF_FACTOR (up to 2,391 times) there
# too. At 256 rows a flipped rounding is a rare event, so the witness
# ratio swings (the kernels up to 311 times on the card); at CPL_REF_N it
# also holds the witness check (at 4,096 rows the kernels at most 11.0
# times, the controls at least 211).
CPL_SPLIT_N = (300, 262144)
RNVP_DEEP, CPL_DEEP_N = dict(q0=8, hdims=(32, 32, 32), nlayers=10), 4096
CPL_REF_N = 16384
DEEP_WITNESS_FACTOR = 20.0
FLIP_TOL, FLIP_SHARE = (1e-4, 1e-4), 1e-3
LEAF_FACTOR, LEAF_FLOOR = 300.0, 1e-6
CPL_BF16_TOL = {
    "f32_cbf16": dict(y=(5e-2, 5e-2), ld=(5e-2, 5e-2), g=(5e-2, 5e-2),
                      gx=(5e-2, 4.0)),
    "bf16": dict(y=(1e-5 + 2 ** -7, 1e-3), ld=(1e-4 + 2 ** -7, 1e-3),
                 g=(2e-3 + 2 ** -7, 1e-3)),
}
# phases 48-49: POLICY_STEPS graphed and eager steps of wide RealNVP under
# the policy (and NSF wide's WIDE_STEPS); the policy's first loss within
# POLICY_BAND relative of float32's from the same init and draws (JAX's
# policy bound), the last POLICY_LAST steps' mean loss of each below its
# first (`_policy_band`); the first step's gradient on the draws times
# FIRST_STEP_SCALE within POLICY_BAND of float32's and within
# WITNESS_SHARE of that distance of a float64-summed witness of the
# policy (`_first_step`; readings on the card, wide RealNVP: 4.1e-3 and
# 1.0e-3; on the raw draws at init 0.57 and 0.19, ill-conditioned);
# `_MixedMatmul` at the main path's shapes within MIXED_BAND of the
# witness (`_mixed_check`); POLICY_MLE_STEPS steps of the
# MLE demo under the policy. Phase 50: bfloat16 parameters, (label,
# family, fused, objective) from JSON, BF16_STEPS graphed steps of
# BF16_NLAYERS layers, the loss's mean over BF16_MEAN steps at each end.
# Phase 51: the fused demo under the policy, RNVP_STEPS graphed and
# POLICY_FUSED_EAGER eager steps.
POLICY_STEPS, POLICY_LAST, POLICY_BAND = 40, 10, 0.05
FIRST_STEP_SCALE, WITNESS_SHARE, MIXED_BAND = 0.1, 0.5, 1e-4
POLICY_MLE_STEPS, POLICY_FUSED_EAGER = 100, 100
# phase 51's rates in turns: chunks of POLICY_RATE_CHUNK steps
POLICY_RATE_CHUNK = 200
BF16_FAMILIES = (("realnvp", "realnvp", False, "elbo_batch"),
                 ("realnvp_fused", "realnvp", True, "elbo_batch"),
                 ("nsf", "nsf", False, "elbo_batch"),
                 ("nsf_mle", "nsf", False, "mle"),
                 ("glow", "glow", False, "elbo_batch"),
                 ("maf", "maf", False, "mle"),
                 ("iaf", "iaf", False, "elbo_batch"))
BF16_STEPS, BF16_MEAN, BF16_NLAYERS = 200, 20, 5
# phases 52-54: K6 on the other targets (the radial demo's WarpedGauss,
# benchmarks/parity.py:200; the Hamiltonian demo's Funnel(2, -8, 5), :253,
# at the flow's d) and in bfloat16. K6 in bfloat16 against its plain
# version: each stored value is rounded once a step, and a float32
# difference of an ulp (FMA, sum order) can move a rounding by one
# bfloat16 spacing, at most 2^-7 relative; two such moves of one value in
# 25 steps are allowed, and 1e-3 absolute (the spacing near 0.125), beside
# CPL_BF16_TOL's bf16 rows. Against the eager bfloat16 step (its loss a
# bfloat16 mean, its Adam bfloat16 torch ops): the first loss within two
# spacings, the trajectory within four (the CPU's plain versions over 20
# seeds: at most one spacing of a loss of 4,900 in each, 0.0066 and
# 0.0071; the card sums the mean in another order).
TRAIN_BF16_TOL = (1e-4 + 2 * 2 ** -7, 1e-3)
# Phase 52 in float32: TRAIN_TOL is tighter than float32's own error at the
# reference default over 25 steps (on the CPU the float32 plain run is up
# to 14x TRAIN_TOL from the float64 one on Banana, 5-8x on WarpedGauss,
# 2x on Funnel; Adam turns a near-zero gradient's roundoff into a step of
# up to lr). An output with elements outside TRAIN_TOL is held to the
# float64 plain run on the same values: K6's relative L2 error at most
# K6_WITNESS_FACTOR times the float32 plain version's, plus LEAF_FLOOR.
K6_WITNESS_FACTOR = 4.0
BF16_FIRST_LOSS_REL, BF16_TRAJECTORY_REL = 2 * 2 ** -7, 4 * 2 ** -7
ALL_PHASES = tuple(range(1, 59))


def parse_phases(text: str) -> tuple:
    """"1,2,12,18-21" -> (1, 2, 12, 18, 19, 20, 21); anything else than
    phases or ranges of phases in ALL_PHASES raises ValueError."""
    out = set()
    for part in text.split(","):
        lo, dash, hi = part.strip().partition("-")
        if not (lo.isdigit() and (hi.isdigit() or not dash)):
            raise ValueError(f"not a phase or a range of phases: {part!r}")
        a, b = int(lo), int(hi) if dash else int(lo)
        if not 1 <= a <= b <= ALL_PHASES[-1]:
            raise ValueError(f"phases run from 1 to {ALL_PHASES[-1]}: "
                             f"{part!r}")
        out.update(range(a, b + 1))
    return tuple(sorted(out))


def say(phase: int, msg: str):
    print(f"[phase {phase}] {msg}", flush=True)


def compare(name, got, want, tol, quiet=False) -> float:
    """Max abs error; raises if any element is outside rtol/atol."""
    got, want = got.detach().double(), want.detach().double()
    err = (got - want).abs()
    bound = tol[1] + tol[0] * want.abs()
    bad = int((err > bound).sum())
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    max_abs = float(err.max()) if err.numel() else 0.0
    rel = err / want.abs().clamp_min(1e-30)
    max_rel = float(rel.max()) if rel.numel() else 0.0
    if not quiet or bad or not finite:
        print(f"    {name}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
              f"outside tol {bad}/{err.numel()}", flush=True)
    if bad or not finite:
        raise AssertionError(f"{name}: {bad} elements outside rtol "
                             f"{tol[0]} atol {tol[1]} (finite={finite})")
    return max_abs


@functools.cache
def _warmup_stream() -> torch.cuda.Stream:
    """One side stream for every capture's warmup: cuBLAS keeps a
    workspace for each stream it has run on, for the life of the process."""
    return torch.cuda.Stream()


def device_ms(fn, reps=7, inner=20) -> float:
    """Median over ``reps`` of the device time of one call of ``fn``.
    After a warmup, ``inner`` calls are captured once into a CUDA graph,
    which is replayed between two CUDA events: the time is the card's, not
    the host's launch cost (tens of µs a call, more than the kernel)."""
    side = _warmup_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants the warmup off-stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def bound_ms(kernel: str, n: int, K: int, word_bytes: int,
             raw_bytes: int | None = None):
    """The least time the card could take for one call on these inputs:
    bytes moved (each input read once, each output written once) over the
    memory rate, against operations over the float32 rate. K1 reads x and
    3K−1 raw words and writes y, ld: 3K+2 words an element; K2/K3 read x,
    raw, gy, gld and write gx, graw: 6K+2. x's words are ``word_bytes``
    each, raw's ``raw_bytes`` (default the same). Operations are counted
    from csrc/rqs_device.cuh (each add, multiply, divide, compare, select,
    exp, log and sqrt as one): about 32K+35 an element for K1 (tables,
    bin, spline) and 65K+100 for K2/K3 (the same tables, the closed-form
    reverse, two softmax/cumsum reverses, the softplus reverse)."""
    rb = word_bytes if raw_bytes is None else raw_bytes
    x_words, raw_words, ops = ((3, 3 * K - 1, 32 * K + 35)
                               if kernel == "rqs_fwd"
                               else (4, 2 * (3 * K - 1), 65 * K + 100))
    t_bytes = n * (x_words * word_bytes + raw_words * rb) / PEAK_BYTES_PER_S
    t_ops = n * ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rqs_counts() -> tuple:
    """(K1, K2, K3) launches since the last reset."""
    return tuple(all_counts()[k] for k in KERNELS)


def all_counts() -> dict:
    """Every kernel's launch count (`ops/launches.py`): the RQS, the
    coupling and the training ones. A graph made by `train_flow` or
    `train_flow_mle` counts its kernels at each replay; one captured here
    by `torch.cuda.graph` counts them at its capture."""
    from normalizingflows_torch.ops import launches

    return launches.counts()


def reset_counts():
    """Every kernel's launch count, and the graphs captured, to 0."""
    from normalizingflows_torch.ops import launches

    launches.reset()


def expect_counts(label: str, **want):
    """Raise unless every kernel's count since the last reset is ``want``'s
    (0 for a kernel it does not name)."""
    got = all_counts()
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{label}: launches {got}, expected {full}")
    return got


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    say(1, f"{name}, {torch.cuda.device_count()} device(s), torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi


# a kernel's mangled name in ptxas's report: its name, its types (f, d,
# 13__nv_bfloat16, or S.._ repeating one), then its bool (Lb0/Lb1) and int
# (Li16: H, or K for RQS) template arguments in order, and for K4/K5 the
# storage (Exact, Bf16Storage; Bf16Operands, the bf16 policy's before it
# had kernels of its own); the bools are INVERSE, then STAGED for K1, and
# STAGED for K2/K3. The policy's tensor-core kernels (coupling_fwd_mma,
# coupling_bwd_mma) take no type: INVERSE, then H.
_KERNEL_NAME = re.compile(r"(coupling_fwd_mma|coupling_bwd_mma|"
                          r"coupling_bwd_reduce|coupling_bwd_rows|"
                          r"coupling_bwd|coupling_fwd_lanes|coupling_fwd|"
                          r"realnvp_train|rqs_fwd|rqs_bwd_fwddir|"
                          r"rqs_bwd_invdir)I")
_TYPES = (("f", "f32"), ("d", "f64"), ("13__nv_bfloat16", "bf16"))
_BOOLS = {"rqs_fwd": (("fwd", "inv"), ("direct", "staged")),
          "rqs_bwd_fwddir": (("direct", "staged"),),
          "rqs_bwd_invdir": (("direct", "staged"),)}
# K1's float32 K=10 forward staged instantiation, whose SASS phase 2 counts
K1_SASS = "rqs_fwdIffLi10ELb0ELb1E"


def _kernel_variant(kind: str, rest: str):
    """(types, the instantiation's C entry suffix, the template arguments
    after the types) of a mangled name's tail ``rest``, after its kernel's
    name and ``I``: "f32", "f64", K1–K3's "f32_rbf16" (bfloat16 raw) and
    "bf16", K4/K5's "f32_cbf16" (the policy) and "bf16" (storage)."""
    types = []
    while True:
        for code, t in _TYPES:
            if rest.startswith(code):
                types.append(t)
                rest = rest[len(code):]
                break
        else:
            m = re.match(r"S\d*_", rest)
            if not (m and types):
                break
            types.append(types[-1])
            rest = rest[m.end():]
    seg = rest.split("EEv")[0]
    if kind.endswith("_mma") or "Bf16Operands" in seg:
        sfx = "f32_cbf16"
    elif "Bf16Storage" in seg or (kind == "coupling_bwd_reduce"
                                  and types[-1:] == ["bf16"]):
        sfx = "bf16"
    elif kind.startswith("rqs") and types == ["f32", "bf16"]:
        sfx = "f32_rbf16"
    else:
        sfx = types[0] if types else "?"
    return types, sfx, seg


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    entry function in nvcc's -Xptxas -v log, the kernel spelled as
    name<type, K=.., fwd/inv, direct/staged, H=..>."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _KERNEL_NAME.search(line)
            name = None
            if m:
                kind = m.group(1)
                _, sfx, seg = _kernel_variant(kind, line[m.end():])
                args = [sfx]
                bools = iter(_BOOLS.get(kind, (("fwd", "inv"),)))
                for flag, value in re.findall(r"L([bi])(\d+)E", seg):
                    args.append(next(bools)[value == "1"] if flag == "b" else
                                f"{'K' if kind.startswith('rqs') else 'H'}"
                                f"={value}")
                name = f"{kind}<{', '.join(args)}>"
            spills = (0, 0)
        elif "spill stores" in line and name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            spills = (int(m.group(1)), int(m.group(2)))
        elif "Used" in line and "registers" in line and name:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((name, regs, *spills))
            name = None
    return out


def sass_counts(sass: str, kernel: str):
    """(all, main) SASS instructions, NOPs left out, of the first function
    in ``cuobjdump -sass`` output whose mangled name contains ``kernel``:
    main runs from the function's start to its last EXIT, so the slow-path
    subroutines of division, exp and log after it are left out. A static
    count: each instruction once, whether it runs once, several times (a
    copy loop) or not at all (a branch not taken). None where there is no
    such function."""
    ops, current = [], None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if ops:
                break
            current = m.group(1)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and current and kernel in current:
            words = m.group(2).split()
            op = words[1] if words[0].startswith("@") else words[0]
            if not op.startswith("NOP"):
                ops.append(op)
    if not ops:
        return None
    exits = [i for i, op in enumerate(ops) if op.startswith("EXIT")]
    return len(ops), (exits[-1] + 1 if exits else len(ops))


def hmma_counts(sass: str) -> dict:
    """The HMMA instructions (tensor-core products) of each function of
    ``cuobjdump -sass`` output that `_KERNEL_NAME` names, by its name as
    phase 2 spells it (`ptxas_report`); a static count, each once."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            k = _KERNEL_NAME.search(m.group(1))
            name = None
            if k:
                report = ptxas_report(f"Compiling entry function "
                                      f"'{m.group(1)}'\nUsed 0 registers")
                name = report[0][0] if report else None
                if name:
                    out.setdefault(name, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(\S+)", line)
        if m and name and m.group(1).startswith("HMMA"):
            out[name] += 1
    return out


def _sass(path: Path):
    """``cuobjdump -sass`` of the built library, or None where the toolkit
    has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def static_issue_estimate(sass: str):
    """K1's float32 K=10 forward staged instantiation: its main-line SASS
    count (`sass_counts`) in ``sass`` and the time that many warp
    instructions for each of N = 131072 elements would take to issue, one
    an issue slot, over the SMs × 4 schedulers at the SM's top clock
    (nvidia-smi clocks.max.sm). A static estimate, not a floor: the count
    is not what an element executes."""
    counts = sass_counts(sass, K1_SASS)
    if counts is None:
        raise AssertionError(f"no {K1_SASS} in cuobjdump's SASS")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = 131072
    ms = 1e3 * counts[1] * (n / 32) / (sms * 4 * mhz * 1e6)
    return {"static_instructions": counts[1], "instructions_all": counts[0],
            "n": n, "sms": sms, "sm_mhz": mhz, "ms": ms}


def phase_build():
    """The build, ptxas's report, K1's static issue estimate and the HMMA
    counts of the bf16 policy's tensor-core kernels (all returned)."""
    from normalizingflows_torch.ops import _build

    build = _build.build()
    say(2, f"nvcc {build.seconds:.1f} s -> {build.path.name}")
    report = ptxas_report(build.log)
    for kernel, regs, stores, loads in sorted(set(report)):
        print(f"    {kernel}: {regs} registers, {stores} bytes spill stores, "
              f"{loads} bytes spill loads", flush=True)
    for k in ("coupling_fwd<", "coupling_fwd_lanes<", "coupling_bwd<",
              "rqs_fwd<", "rqs_bwd_fwddir<", "rqs_bwd_invdir<"):
        if build.log and not any(r[0].startswith(k) for r in report):
            raise AssertionError(f"no {k[:-1]} in ptxas's report")
    spilled = [k for k, _, stores, _ in report if stores and (
        k.startswith("realnvp_train<") or (
            ("f32" in k or "bf16" in k)
            and k.startswith(("coupling_fwd", "coupling_bwd", "rqs_"))))]
    if spilled:
        raise AssertionError(f"float32 and bfloat16 K1–K5, or K6, spill "
                             f"registers: {spilled}")
    for k in ("rqs_fwd<f32_rbf16", "rqs_fwd<bf16", "rqs_bwd_fwddir<bf16",
              "coupling_fwd_mma<f32_cbf16", "coupling_bwd_mma<f32_cbf16",
              "coupling_bwd<bf16", "realnvp_train<f64", "realnvp_train<bf16"):
        if build.log and not any(r[0].startswith(k) for r in report):
            raise AssertionError(f"no {k}> in ptxas's report")
    _build.library()
    sass = _sass(build.path)
    est, hmma = None, {}
    if sass is None:
        say(2, "K1 static issue estimate and HMMA counts: not measured (no "
               "cuobjdump)")
    else:
        est = static_issue_estimate(sass)
        hmma = {k: v for k, v in hmma_counts(sass).items()
                if k.startswith(("coupling_fwd_mma<", "coupling_bwd_mma<"))}
        if len(hmma) != 8 or not all(hmma.values()):
            raise AssertionError(f"the bf16 policy's kernels (fwd/bwd x "
                                 f"fwd/inv x H 16/32) must each hold HMMA "
                                 f"instructions: {hmma}")
        for k, v in sorted(hmma.items()):
            say(2, f"{k}: {v} HMMA instructions (static count)")
        say(2, f"K1 static issue estimate: rqs_fwd<f32, K=10, fwd, staged> "
               f"{est['static_instructions']} SASS instructions in its main "
               f"line, each counted once ({est['instructions_all']} in the "
               f"function); once an element at N={est['n']}, "
               f"{est['sms']} SMs x 4 schedulers at {est['sm_mhz']:.0f} "
               f"MHz: {est['ms']:.5f} ms")
    return report, est, hmma


def _same(name, got, want):
    """Bit-for-bit equality of two tensors of one computation."""
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not identical")


def _grads(fused, x, raw, gy, gld):
    """(y, ld, gx, graw) of ``fused(x, raw)`` under cotangents (gy, gld)."""
    xg = x.detach().requires_grad_()
    rg = raw.detach().requires_grad_()
    y, ld = fused(xg, rg)
    return (y.detach(), ld.detach()) + torch.autograd.grad(
        (y, ld), (xg, rg), (gy.reshape(y.shape), gld.reshape(y.shape)))


@contextlib.contextmanager
def direct_read(rqs_cuda):
    """K1, K2 and K3 on elem-major raw forced off their staged tiles onto
    the direct read (each thread its own row in device memory),
    param-major's path."""
    fwd, bwd = rqs_cuda.fwd_plan, rqs_cuda.bwd_plan
    rqs_cuda.fwd_plan = lambda *a: rqs_cuda.FwdPlan(False, 0, 0)
    rqs_cuda.bwd_plan = lambda *a: rqs_cuda.BwdPlan(False, rqs_cuda.BWD_ROWS,
                                                    0, 0)
    try:
        yield
    finally:
        rqs_cuda.fwd_plan, rqs_cuda.bwd_plan = fwd, bwd


@contextlib.contextmanager
def fwd_tile(cc, lanes: bool):
    """K4 forced onto its lane tile (``lanes``) or its row tile whatever
    the batch, through `fwd_plan`'s switch (the C entry's ``lanes``), to
    hold the two tiles against each other."""
    switch = cc.FWD_LANE_MAX_TILES
    cc.FWD_LANE_MAX_TILES = 1 << 62 if lanes else -1
    try:
        yield
    finally:
        cc.FWD_LANE_MAX_TILES = switch


def phase_kernels(gen):
    """K1 (forward, inverse), K2 and K3 against the plain tiles on the
    card; K2/K3 staged and direct; padded elem-major raw and the rows
    view; device times, warm and with a cold L2."""
    from normalizingflows_torch.ops import rqs_cuda

    results = {k: {"err": 0.0} for k in KERNELS}
    errs = []  # every kernel-vs-plain comparison's max abs error
    bwd_tile = {False: ("K2", "rqs_bwd_fwddir", rqs_cuda.tile_bwd_analytic),
                True: ("K3", "rqs_bwd_invdir",
                       rqs_cuda.tile_bwd_analytic_inverse)}
    checks = 0
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        for K in (8, 10):
            P = 3 * K - 1
            for n in SIZES:
                # the main path's layout: x (batch, n_t), raw a view of the
                # conditioner's (batch, n_t·(3K−1)) output
                n_t = 32 if n == 131072 else 1
                batch = n // n_t
                x = (torch.rand((batch, n_t), generator=gen, device=DEVICE,
                                dtype=dtype) * 3.0 - 1.5) * B
                raw = 3.0 * torch.randn((batch, n_t * P), generator=gen,
                                        device=DEVICE, dtype=dtype)
                raw3 = raw.view(batch, n_t, P)
                xf, rawf = x.reshape(-1), raw.view(-1, P)
                gy = torch.randn((n,), generator=gen, device=DEVICE,
                                 dtype=dtype)
                gld = torch.randn((n,), generator=gen, device=DEVICE,
                                  dtype=dtype)
                # the same raw padded to P + 3 columns, read elem-major
                raw_pad = torch.cat([rawf, torch.randn(
                    (n, 3), generator=gen, device=DEVICE, dtype=dtype)], 1)
                tag = f"{str(dtype)[6:]} K={K} N={n}"
                main = dtype == torch.float32 and K == 10 and n in RQS_TIMED
                for inverse in (False, True):
                    d = "inv" if inverse else "fwd"
                    y, ld = rqs_cuda.rqs_fused(x, raw3, B, inverse=inverse,
                                               backend="cuda")
                    y_p, ld_p = rqs_cuda.tile_transform(xf, rawf, B, inverse)
                    errs += [compare(f"K1 {d} y  {tag}", y.reshape(-1), y_p,
                                     tol["y"]),
                             compare(f"K1 {d} ld {tag}", ld.reshape(-1),
                                     ld_p, tol["ld"])]
                    e = max(errs[-2:])
                    if main:
                        results["rqs_fwd"]["err"] = max(
                            results["rqs_fwd"]["err"], e)
                    with direct_read(rqs_cuda):
                        y_d, ld_d = rqs_cuda._launch_fwd(xf, rawf, B, K,
                                                         inverse)
                    _same(f"K1 {d} {tag} direct y", y_d, y.reshape(-1))
                    _same(f"K1 {d} {tag} direct ld", ld_d, ld.reshape(-1))

                    kname, kkey, tile = bwd_tile[inverse]
                    gx, graw = _grads(lambda a, r: rqs_cuda.rqs_fused(
                        a, r, B, inverse=inverse, backend="cuda"),
                        x, raw3, gy, gld)[2:]
                    gx_p, graw_p = tile(xf, rawf, gy, gld, B)
                    errs += [compare(f"{kname} gx   {tag}", gx.reshape(-1),
                                     gx_p, tol["g"]),
                             compare(f"{kname} graw {tag}",
                                     graw.reshape(-1, P), graw_p, tol["g"])]
                    e = max(errs[-2:])
                    if main:
                        results[kkey]["err"] = max(results[kkey]["err"], e)
                    # the direct read of the same elem-major raw gives the
                    # staged tile's bits
                    with direct_read(rqs_cuda):
                        gx_d, graw_d = rqs_cuda._launch_bwd(
                            xf, rawf, gy, gld, B, K, inverse)
                    _same(f"{kname} {tag} direct gx", gx_d, gx.reshape(-1))
                    _same(f"{kname} {tag} direct graw", graw_d,
                          graw.reshape(-1, P))

                    # param-major read of the same numbers (rqs_fused_t):
                    # identical values, graw back param-major
                    y_t, ld_t, gx_t, graw_t = _grads(
                        lambda a, r: rqs_cuda.rqs_fused_t(
                            a, r, B, inverse=inverse, backend="cuda"),
                        xf, rawf.T.contiguous(), gy, gld)
                    _same(f"K1 {d} {tag} param-major y", y_t, y.reshape(-1))
                    _same(f"K1 {d} {tag} param-major ld", ld_t,
                          ld.reshape(-1))
                    _same(f"{kname} {tag} param-major gx", gx_t,
                          gx.reshape(-1))
                    _same(f"{kname} {tag} param-major graw", graw_t.T,
                          graw.reshape(-1, P))

                    # padded elem-major (rqs_fused_e): pad ignored, its
                    # gradient written as exact zeros over poisoned memory
                    del graw_t
                    poison = torch.full_like(raw_pad, float("nan"))
                    del poison  # the allocator hands this block to graw
                    y_e, ld_e, gx_e, graw_e = _grads(
                        lambda a, r: rqs_cuda.rqs_fused_e(
                            a, r, B, K, inverse=inverse, backend="cuda"),
                        xf, raw_pad, gy, gld)
                    _same(f"K1 {d} {tag} padded y", y_e, y.reshape(-1))
                    _same(f"K1 {d} {tag} padded ld", ld_e, ld.reshape(-1))
                    _same(f"{kname} {tag} padded gx", gx_e, gx.reshape(-1))
                    _same(f"{kname} {tag} padded graw", graw_e[:, :P],
                          graw.reshape(-1, P))
                    if torch.count_nonzero(graw_e[:, P:]) or not bool(
                            torch.isfinite(graw_e[:, P:]).all()):
                        raise AssertionError(f"{kname} {tag}: pad columns "
                                             "of graw are not exact zeros")
                    checks += 16
            # the Pallas rows view (`_call_fwd_rows`): x (R, N/R), raw
            # (3K−1, R, N/R); K1 over its flattened and its permuted view
            R, L = 8, 131072 // 8
            x_rows = (torch.rand((R, L), generator=gen, device=DEVICE,
                                 dtype=dtype) * 3.0 - 1.5) * B
            raw_rows = 3.0 * torch.randn((P, R, L), generator=gen,
                                         device=DEVICE, dtype=dtype)
            for inverse in (False, True):
                flat = rqs_cuda.rqs_fused_t(
                    x_rows.reshape(-1), raw_rows.reshape(P, -1), B,
                    inverse=inverse, backend="cuda")
                view = rqs_cuda.rqs_fused(x_rows, raw_rows.permute(1, 2, 0),
                                          B, inverse=inverse, backend="cuda")
                tag = f"{str(dtype)[6:]} K={K} rows {R}x{L}"
                _same(f"K1 {tag} y", view[0].reshape(-1), flat[0])
                _same(f"K1 {tag} ld", view[1].reshape(-1), flat[1])
                checks += 2
    torch.cuda.synchronize()
    say(3, f"{sum(e == 0.0 for e in errs)} of {len(errs)} kernel-vs-plain "
           f"comparisons exact (max abs err 0), all within tolerance; "
           f"{checks} layout checks identical: K1–K3 staged and direct, "
           f"param-major read, padded elem-major (pad gradient exactly 0), "
           f"rows view")

    # device times, float32, K=10, at the demo, MLE-demo and wide shapes:
    # warm (20 calls on the same inputs, which stay in the 50 MB L2, as
    # after the conditioner's write) and, at the wide shape, cold (a 64 MiB
    # buffer written before each call, its own time subtracted)
    K, P = 10, 29
    flush = torch.empty(FLUSH_BYTES // 4, device=DEVICE)
    flush_ms = device_ms(flush.zero_)
    for n in RQS_TIMED:
        n_t = 32 if n == 131072 else 1
        x = (torch.rand((n,), generator=gen, device=DEVICE) * 3 - 1.5) * B
        raw = 3.0 * torch.randn((n // n_t, n_t * P), generator=gen,
                                device=DEVICE).view(n, P)
        gy = torch.randn((n,), generator=gen, device=DEVICE)
        gld = torch.randn((n,), generator=gen, device=DEVICE)
        calls = {
            "rqs_fwd": (lambda: rqs_cuda._launch_fwd(x, raw, B, K, False),
                        lambda: rqs_cuda.tile_transform(x, raw, B)),
            "rqs_fwd inverse": (
                lambda: rqs_cuda._launch_fwd(x, raw, B, K, True),
                lambda: rqs_cuda.tile_transform(x, raw, B, True)),
            "rqs_bwd_fwddir": (
                lambda: rqs_cuda._launch_bwd(x, raw, gy, gld, B, K, False),
                lambda: rqs_cuda.tile_bwd_analytic(x, raw, gy, gld, B)),
            "rqs_bwd_invdir": (
                lambda: rqs_cuda._launch_bwd(x, raw, gy, gld, B, K, True),
                lambda: rqs_cuda.tile_bwd_analytic_inverse(x, raw, gy, gld,
                                                           B)),
        }
        for name, (launch, plain) in calls.items():
            kernel = name.split()[0]
            ms, plain_ms = device_ms(launch), device_ms(plain)
            bms, by = bound_ms(kernel, n, K, 4)
            line = (f"{name} N={n} f32 K=10: kernel {ms:.5f} ms, plain "
                    f"{plain_ms:.5f} ms, bound {bms:.5f} ms ({by}), "
                    f"{100 * bms / ms:.1f} % of it")
            r = (results[kernel] if name in results
                 else results[kernel].setdefault("inverse", {}))
            r.setdefault("ms_by_n", {})[n] = ms
            r.setdefault("plain_ms_by_n", {})[n] = plain_ms
            r.setdefault("bound_ms_by_n", {})[n] = bms
            r.setdefault("bound_share_by_n", {})[n] = bms / ms
            # the kernel ran its staged path; the direct read beside it
            with direct_read(rqs_cuda):
                direct = device_ms(launch)
            r.setdefault("direct_ms_by_n", {})[n] = direct
            line += f"; direct read {direct:.5f} ms"
            if n == 131072:
                cold = device_ms(lambda: (flush.zero_(), launch())) - flush_ms
                r.update(cold_ms=cold, cold_bound_share=bms / cold)
                line += (f"; cold L2 {cold:.5f} ms ({100 * bms / cold:.1f} % "
                         f"of the bound)")
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            say(3, line + " (device time a call: median of 7 CUDA-graph "
                          "replays of 20 calls, CUDA events)")
    return results


def _demo_flow(backend="auto", seed=0):
    import normalizingflows_torch as nft

    # no device argument: the port builds on the card by default
    return nft.nsf(torch.Generator().manual_seed(seed), backend=backend,
                   **DEMO)


def _perturbed(flow):
    """Noise 0.1 on every parameter: off the identity, where every term of
    the gradient is non-zero."""
    with torch.no_grad():
        noise = torch.Generator(device=DEVICE).manual_seed(2)
        for p in flow.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=noise, device=DEVICE))
    return flow


def _both_backends(phase, flow_c, objective, want):
    """One value-and-grad of ``objective(flow)`` on the "cuda" flow and on
    its copy with backend "plain": same value and gradients within
    STEP_TOL, and the launch counts (K1, K2, K3) ``want`` and none."""
    flow_p = copy.deepcopy(flow_c)
    flow_p.bijector.bijectors[0].backend = "plain"
    out = {}
    for label, flow in (("cuda", flow_c), ("plain", flow_p)):
        reset_counts()
        loss = -objective(flow)
        loss.backward()
        torch.cuda.synchronize()
        launched = rqs_counts()
        expected = want if label == "cuda" else (0, 0, 0)
        if launched != expected:
            raise AssertionError(f"{label} backend launched (K1, K2, K3) "
                                 f"{launched} times, expected {expected}")
        out[label] = (loss.detach(), {n: p.grad for n, p in
                                      flow.named_parameters()
                                      if p.grad is not None})
    compare("loss", out["cuda"][0].reshape(1), out["plain"][0].reshape(1),
            STEP_TOL)
    grads_c, grads_p = out["cuda"][1], out["plain"][1]
    # every conditioner W and b, and the base's loc and scale
    if set(grads_c) != set(grads_p) or len(grads_c) != 10 * 2 * 3 * 2 + 2:
        raise AssertionError("the two backends differ in which parameters "
                             "got gradients")
    worst = max(compare(f"grad {n}", grads_c[n], grads_p[n], STEP_TOL,
                        quiet=True) for n in sorted(grads_c))
    say(phase, f"loss {float(out['cuda'][0]):.6f} on both backends; "
               f"{len(grads_c)} gradients agree (max abs err {worst:.3e}); "
               f"the cuda pass launched (K1, K2, K3) {want}, the plain pass "
               f"none")


def phase_same_step(gen):
    """One ELBO value-and-grad, kernels against plain, same everything."""
    import normalizingflows_torch as nft

    flow = _perturbed(_demo_flow("cuda", seed=1))
    xs = flow.base.sample(gen, (DEMO_BATCH,)).detach()
    target = nft.Banana(2, 1.0, 100.0)
    per_step = 2 * DEMO["nlayers"]
    _both_backends(4, flow, lambda f: nft.elbo_from_samples(
        xs, f, target.log_prob), (per_step, per_step, 0))


def phase_main_path(gen, name):
    """train_flow on the demo slice, eagerly (graph=False)."""
    import normalizingflows_torch as nft

    flow = _demo_flow()
    target = nft.Banana(2, 1.0, 100.0)
    stamps = []

    def callback(it, stat, f):
        stamps.append((it, time.perf_counter()))  # after the chunk's fetch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = nft.train_flow(
        gen, nft.elbo_batch, flow, target.log_prob, DEMO_BATCH,
        max_iters=DEMO_STEPS, check_every=100, callback=callback,
        optimizer=lambda p: torch.optim.Adam(p, lr=DEMO_LR), graph=False)
    t1 = time.perf_counter()
    launches = all_counts()

    losses = res.stats["loss"]
    if len(losses) != DEMO_STEPS or not torch.isfinite(
            torch.from_numpy(losses)).all():
        raise AssertionError("demo training gave non-finite losses")
    first, last = losses[:20].mean(), losses[-20:].mean()
    if not last < first:
        raise AssertionError(f"demo loss did not fall: {first} -> {last}")
    per_step = 2 * DEMO["nlayers"]
    want = {**dict.fromkeys(launches, 0), "rqs_fwd": per_step * DEMO_STEPS,
            "rqs_bwd_fwddir": per_step * DEMO_STEPS}
    if launches != want:
        raise AssertionError(f"launches {launches} in {DEMO_STEPS} steps, "
                             f"expected {want}")
    steady = (stamps[-1][0] - stamps[0][0]) / (stamps[-1][1] - stamps[0][1])
    say(5, f"ELBO {-losses[0]:.4f} -> {-losses[-1]:.4f} (mean of first 20 "
           f"{-first:.4f}, last 20 {-last:.4f}); {DEMO_STEPS} steps in "
           f"{t1 - t0:.2f} s = {DEMO_STEPS / (t1 - t0):.1f} steps/s overall, "
           f"{steady:.1f} steps/s after the first chunk, on {name}")
    say(5, f"launches: rqs_fwd {launches['rqs_fwd']}, rqs_bwd_fwddir "
           f"{launches['rqs_bwd_fwddir']} ({per_step} each per step), "
           f"rqs_bwd_invdir {launches['rqs_bwd_invdir']}")
    return flow, launches


def phase_wide(gen, name):
    import normalizingflows_torch as nft

    flow = nft.nsf(torch.Generator().manual_seed(3), **WIDE)
    target = nft.Banana(64, 1.0, 100.0)
    kw = dict(optimizer=lambda p: torch.optim.Adam(p, lr=WIDE_LR),
              graph=False)
    warm = nft.train_flow(gen, nft.elbo_batch, flow, target.log_prob,
                          WIDE_BATCH, max_iters=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = nft.train_flow(gen, nft.elbo_batch, flow, target.log_prob,
                         WIDE_BATCH, max_iters=WIDE_STEPS,
                         check_every=WIDE_STEPS, resume_state=warm.state, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = res.stats["loss"]
    if not torch.isfinite(torch.from_numpy(losses)).all():
        raise AssertionError("wide training gave non-finite losses")
    if rqs_counts() != (20 * WIDE_STEPS, 20 * WIDE_STEPS, 0):
        raise AssertionError("wide training did not launch K1 and K2 20x "
                             "each per step and K3 never")
    say(6, f"wide f32 d=64 [128,128]x10 K=10 batch {WIDE_BATCH}: "
           f"{WIDE_STEPS} steps in {dt:.3f} s = {WIDE_STEPS / dt:.2f} steps/s"
           f", peak memory {peak / 2**20:.1f} MiB, loss {losses[0]:.2f} -> "
           f"{losses[-1]:.2f}, on {name}")


def phase_round_trip(flow, gen):
    with torch.no_grad():
        y, lq = flow.sample_and_log_prob(gen, (4096,))
        lp = flow.log_prob(y)
    e = compare("log_prob(y) vs sample_and_log_prob", lp, lq, ROUND_TRIP_TOL)
    say(7, f"round trip on the trained demo flow, 4096 samples: max abs "
           f"err {e:.3e}")


def phase_loglikelihood(gen):
    """One `loglikelihood` value-and-grad on the MLE demo flow."""
    import normalizingflows_torch as nft

    ys = nft.Banana(2, 1.0, 10.0).sample(gen, (MLE_BATCH,))
    per_step = 2 * DEMO["nlayers"]
    _both_backends(8, _perturbed(_demo_flow("cuda", seed=4)),
                   lambda f: nft.loglikelihood(f, ys), (per_step, 0, per_step))


def phase_stl():
    """One `elbo_stl` value-and-grad on the ELBO demo: both backends draw
    the same base samples from generators of one seed."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    per_step = 2 * DEMO["nlayers"]
    _both_backends(9, _perturbed(_demo_flow("cuda", seed=5)),
                   lambda f: nft.elbo_stl(
                       torch.Generator(device=DEVICE).manual_seed(6), f,
                       target.log_prob, DEMO_BATCH),
                   (2 * per_step, per_step, per_step))


def _mle_data(gen, dim):
    """Exact draws of Banana(dim, 1, 10), made on the card: the training
    set (as the loader's numpy array) and a held-out set."""
    import normalizingflows_torch as nft

    target = nft.Banana(dim, 1.0, 10.0)
    train = target.sample(gen, (MLE_ROWS,)).cpu().numpy()
    return target, train, target.sample(gen, (MLE_HELD_OUT,))


def phase_mle(gen, name):
    """train_flow_mle on the MLE demo: the density path, eagerly
    (graph=False)."""
    import normalizingflows_torch as nft

    target, train, held = _mle_data(gen, 2)
    flow = _demo_flow()
    with torch.no_grad():
        ceiling = float(target.log_prob(held).mean())
        before = float(flow.log_prob(held).mean())
    stamps = []

    def callback(it, stat, f):
        stamps.append((it, time.perf_counter()))  # after the chunk's fetch

    loader = nft.utils.data.make_loader(train, MLE_BATCH, seed=0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = nft.train_flow_mle(
        flow, loader, max_iters=MLE_STEPS, check_every=100,
        callback=callback,
        optimizer=lambda p: torch.optim.Adam(p, lr=MLE_LR), graph=False)
    t1 = time.perf_counter()
    launches = all_counts()
    with torch.no_grad():
        after = float(flow.log_prob(held).mean())

    losses = res.stats["loss"]
    if len(losses) != MLE_STEPS or not torch.isfinite(
            torch.from_numpy(losses)).all():
        raise AssertionError("MLE training gave non-finite losses")
    if not (torch.isfinite(torch.tensor([before, after])).all()
            and after > before):
        raise AssertionError(f"held-out log-likelihood did not rise: "
                             f"{before} -> {after}")
    per_step = 2 * DEMO["nlayers"]
    want = {**dict.fromkeys(launches, 0), "rqs_fwd": per_step * MLE_STEPS,
            "rqs_bwd_invdir": per_step * MLE_STEPS}
    if launches != want:
        raise AssertionError(f"launches {launches} in {MLE_STEPS} steps, "
                             f"expected {want}")
    steady = (stamps[-1][0] - stamps[0][0]) / (stamps[-1][1] - stamps[0][1])
    say(10, f"held-out mean log-likelihood ({MLE_HELD_OUT} fresh draws) "
            f"{before:.4f} -> {after:.4f}; the target's E_p[log p] on them "
            f"{ceiling:.4f} (the ceiling); train loss, mean of the first 20 "
            f"batches {losses[:20].mean():.4f}, of the last 20 "
            f"{losses[-20:].mean():.4f}; {MLE_STEPS} steps in "
            f"{t1 - t0:.2f} s = {MLE_STEPS / (t1 - t0):.1f} steps/s overall, "
            f"{steady:.1f} "
            f"steps/s after the first chunk, on {name}")
    say(10, f"launches: rqs_fwd {launches['rqs_fwd']}, rqs_bwd_invdir "
            f"{launches['rqs_bwd_invdir']} ({per_step} each per step), "
            f"rqs_bwd_fwddir {launches['rqs_bwd_fwddir']}")
    return launches


def phase_mle_wide(gen, name):
    import normalizingflows_torch as nft

    _, train, _ = _mle_data(gen, 64)
    flow = nft.nsf(torch.Generator().manual_seed(7), **WIDE)
    loader = nft.utils.data.make_loader(train, MLE_WIDE_BATCH, seed=0)
    kw = dict(optimizer=lambda p: torch.optim.Adam(p, lr=MLE_LR),
              graph=False)
    warm = nft.train_flow_mle(flow, loader, max_iters=2, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = nft.train_flow_mle(flow, loader, max_iters=MLE_WIDE_STEPS,
                             check_every=MLE_WIDE_STEPS,
                             resume_state=warm.state, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = rqs_counts()
    losses = res.stats["loss"]
    if not torch.isfinite(torch.from_numpy(losses)).all():
        raise AssertionError("MLE wide training gave non-finite losses")
    if launches != (20 * MLE_WIDE_STEPS, 0, 20 * MLE_WIDE_STEPS):
        raise AssertionError(f"MLE wide launched (K1, K2, K3) {launches}, "
                             "expected 20 K1 and 20 K3 per step")
    say(11, f"MLE wide f32 d=64 [128,128]x10 K=10 batch {MLE_WIDE_BATCH}: "
            f"{MLE_WIDE_STEPS} steps in {dt:.3f} s = "
            f"{MLE_WIDE_STEPS / dt:.2f} steps/s, peak memory "
            f"{peak / 2**20:.1f} MiB, loss {losses[0]:.2f} -> "
            f"{losses[-1]:.2f}, launches (K1, K2, K3) {launches}, on {name}")


# ---------------------------------------------------------------------------
# RealNVP: the fused coupling-stack kernels K4/K5 and the unfused path
# ---------------------------------------------------------------------------

def rnvp_n_params(cfg: dict) -> int:
    """The weights of a RealNVP stack of ``cfg``: per coupling and net, a
    Dense chain n_B → hidden... → n_A."""
    d, hdims, L = cfg["q0"], cfg["hdims"], cfg["nlayers"]
    n = 0
    for n_a in ((d + 1) // 2, d // 2):
        widths = [d - n_a, *hdims, n_a]
        n += L * 2 * sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    return n


def _coupling_ops(kernel: str, cfg: dict):
    """(MAC operations, other operations) one row of K4 or K5 needs,
    counted from csrc/coupling.cu. Per coupling and net: a multiply and an
    add per weight (the MACs), a bias add and an activation per unit; per
    transformed element an exp, a multiply, an add and the log-det add.
    K5's work is the VJP's: one forward (the kernel runs it twice, once
    keeping each coupling's input and once rebuilding its caches, but the
    second is its choice, not the function's), then per layer the weight
    gradient Hᵀ·G and the input cotangent G·Wᵀ (a MAC each per weight and
    row), the slope and the bias gradient per unit, and ~6 operations per
    transformed element."""
    d, hdims, L = cfg["q0"], cfg["hdims"], cfg["nlayers"]
    mac_ops = other = 0
    for n_a in ((d + 1) // 2, d // 2):
        widths = [d - n_a, *hdims, n_a]
        macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        units = sum(widths[1:])
        mac_ops += L * 2 * 2 * macs
        other += L * (2 * 2 * units + 4 * n_a)
        if kernel != "coupling_fwd":
            mac_ops += L * 2 * 4 * macs
            other += L * (2 * 2 * units + 6 * n_a)
    return mac_ops, other


def coupling_work(kernel: str, cfg: dict, n: int, word_bytes: int):
    """(operations, bytes) one call of K4 or K5 needs on n rows
    (`_coupling_ops`). Bytes: K4 reads x and the weights and writes y and
    ld; K5 reads x, gy, gld and the weights and writes gx and the weight
    gradients."""
    d, n_params = cfg["q0"], rnvp_n_params(cfg)
    if kernel == "coupling_fwd":
        words = n * (2 * d + 1) + n_params
    else:
        words = n * (3 * d + 1) + 2 * n_params
    return n * sum(_coupling_ops(kernel, cfg)), words * word_bytes


def coupling_bound_ms(kernel: str, cfg: dict, n: int, word_bytes: int = 4,
                      policy: bool = False):
    """(bound in ms, what bounds it) of one call of K4 or K5 on n rows:
    the larger of its bytes over the memory rate and its operations over
    the peak for their type. In float32 (and in bfloat16 storage, whose
    arithmetic is float32) every operation counts at the float32 rate.
    Under the bf16 policy the MACs multiply bfloat16 operands and sum in
    float32, which the tensor cores run at PEAK_BF16_PER_S: the MACs count
    at that rate and the rest at the float32 rate, and since the two units
    run side by side the larger of the two times is the operations' bound.
    The kernel itself runs its MACs on the CUDA cores."""
    macs, other = _coupling_ops(kernel, cfg)
    t_bytes = coupling_work(kernel, cfg, n, word_bytes)[1] / PEAK_BYTES_PER_S
    if policy:
        t_ops = max(n * macs / PEAK_BF16_PER_S, n * other / PEAK_F32_PER_S)
    else:
        t_ops = n * (macs + other) / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _rnvp(cfg: dict, seed: int, fused: bool, dtype=torch.float32):
    import normalizingflows_torch as nft

    # no device argument: the port builds on the card by default
    return nft.realnvp(torch.Generator().manual_seed(seed), fused=fused,
                       dtype=dtype, **cfg)


def _stack_grads(stack, grp: str, net: str, li: int):
    """The unfused stack's (W, b) gradients of one conditioner layer,
    stacked over blocks like the fused flow's."""
    return [torch.stack([getattr(m.layers[li], k).grad
                         for m in stack.stacked[f"{net}_{grp}"]])
            for k in ("W", "b")]


def _unfused_like(fb, cfg: dict, dtype):
    """An unfused `CouplingPairStack` holding the fused flow's weights."""
    stack = _rnvp(cfg, 0, False, dtype).bijector.bijectors[0]
    with torch.no_grad():
        for grp in ("even", "odd"):
            for net in ("s", "t"):
                for li, (W, b) in enumerate(fb.groups[grp][net]):
                    for i, m in enumerate(stack.stacked[f"{net}_{grp}"]):
                        m.layers[li].W.copy_(W[i])
                        m.layers[li].b.copy_(b[i])
    return stack


def _cpl_run(cc, x, fb, gy, gld, inverse):
    """(y, ld, gx, *weight grads) through `coupling_stack_fused` on the
    card: one K4 launch and one K5 call."""
    leaves = cc._leaves(fb.groups)
    xg = x.detach().requires_grad_()
    y, ld = cc.coupling_stack_fused(xg, fb.groups, fb.idx_even, fb.idx_odd,
                                    inverse=inverse, backend="cuda")
    grads = torch.autograd.grad((y, ld), [xg] + leaves, (gy, gld))
    return [y.detach(), ld.detach(), *grads]


def _kink_rows(cc, x, groups, sels, cd=None):
    """Rows of x (n, d) at which a leaky-ReLU pre-activation of the stack,
    forward or inverse, lies within KINK of 0 (computed in float64; under
    the bf16 policy ``cd`` from the operands rounded as it rounds them).
    There the slope is 1 on one side and 0.01 on the other, and two correct
    computations whose roundings put the pre-activation on different sides
    (K5 and cuBLAS, or the plain version in float32 and in float64) give
    that row's gx different one-sided derivatives."""
    def rnd(t):
        return t if cd is None else t.to(cd).double()

    g64 = {grp: {net: [(layer[0].double(), layer[1].double())
                       for layer in groups[grp][net]] for net in ("s", "t")}
           for grp in ("even", "odd")}
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for inverse in (False, True):
        h_x = x.double()
        ld = h_x.new_zeros(x.shape[0])
        for (_, _, idx_a, idx_b, s_w, t_w) in cc._couplings(g64, sels,
                                                            inverse):
            for net in (s_w, t_w):
                h = cc._pick(h_x, idx_b)
                for W, b in net[:-1]:
                    z = rnd(h) @ rnd(W) + b
                    near |= (z.abs() < KINK).any(1)
                    h = cc._leaky_relu(z)
            h_x, ld = cc._apply_coupling(h_x, ld, idx_a, idx_b, s_w, t_w,
                                         inverse, cd)
    return near


def _off_kinks(cc, x, groups, sels, gen, cd=None):
    """(x, draws): x with every row that `_kink_rows` flags drawn again
    from ``gen`` until none is, so that K5 is held to its plain version
    where the derivative is defined, and the rows drawn again."""
    draws = 0
    while bool((near := _kink_rows(cc, x, groups, sels, cd)).any()):
        draws += int(near.sum())
        x[near] = torch.randn((int(near.sum()), x.shape[1]), generator=gen,
                              device=x.device, dtype=x.dtype)
    return x, draws


def fwd_switch(cc, dtype, cfg=RNVP_DEMO) -> int:
    """The last N on K4's lane tile for ``cfg``'s stack in ``dtype``."""
    word = torch.finfo(dtype).bits // 8
    return cc.bwd_rows(word, max(cfg["hdims"])) * cc.FWD_LANE_MAX_TILES


def phase_coupling_kernels(gen):
    """K4 and K5 against their plain versions on the card; K4's two tiles
    against each other; device times."""
    from normalizingflows_torch.experimental import coupling_cuda as cc

    results = {k: {"err": 0.0, "ms_by_n": {}, "plain_ms_by_n": {},
                   "bound_ms_by_n": {}, "unfused_ms_by_n": {}}
               for k in CPL_KERNELS}
    n_cmp = n_tiles = redrawn = 0
    flows = {}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        switch = fwd_switch(cc, dtype)
        for model, n in CPL_SHAPES + (("demo", switch),
                                      ("demo", switch + 1)):
            cfg = CPL_CFG[model]
            if (model, dtype) not in flows:
                flow = _perturbed(_rnvp(cfg, 30, True, dtype))
                flows[(model, dtype)] = flow.bijector.bijectors[0]
            fb = flows[(model, dtype)]
            d = cfg["q0"]
            sels = cc._sels(fb.idx_even, fb.idx_odd, d)
            x, draws = _off_kinks(cc, torch.randn((n, d), generator=gen,
                                                  device=DEVICE, dtype=dtype),
                                  fb.groups, sels, gen)
            redrawn += draws
            gy = torch.randn((n, d), generator=gen, device=DEVICE,
                             dtype=dtype) / n
            gld = torch.randn((n,), generator=gen, device=DEVICE,
                              dtype=dtype) / n
            tag = f"{str(dtype)[6:]} {model} N={n}"
            for inverse in (False, True):
                dr = "inv" if inverse else "fwd"
                got = _cpl_run(cc, x, fb, gy, gld, inverse)
                again = _cpl_run(cc, x, fb, gy, gld, inverse)
                for i, (a, b) in enumerate(zip(got, again)):
                    _same(f"K4/K5 {dr} {tag} output {i}, two runs", a, b)
                for lanes in (True, False):
                    with fwd_tile(cc, lanes):
                        y_t, ld_t = cc._launch_fwd(
                            x, cc._leaves(fb.groups), sels,
                            len(cfg["hdims"]) + 1, inverse)
                    tile = "lane" if lanes else "row"
                    _same(f"K4 {dr} {tag} y, {tile} tile", y_t, got[0])
                    _same(f"K4 {dr} {tag} ld, {tile} tile", ld_t, got[1])
                    n_tiles += 2
                y_p, ld_p = cc.tile_flow(x, fb.groups, sels, inverse)
                gx_p, tree = cc.tile_flow_bwd(x, fb.groups, gy, gld, sels,
                                              inverse)
                e4 = max(compare(f"K4 {dr} y  {tag}", got[0], y_p, tol["y"]),
                         compare(f"K4 {dr} ld {tag}", got[1], ld_p,
                                 tol["ld"]))
                # gy and gld are scaled by 1/n (the weight gradients are
                # means); gx is per row, so its atol is scaled with them
                gx_tol = (tol["g"][0], tol["g"][1] / n)
                e5 = max(compare(f"K5 {dr} {tag} {name}", a, b,
                                 gx_tol if name == "gx" else tol["g"],
                                 quiet=name != "gx")
                         for name, a, b in zip(
                             ["gx"] + [f"leaf {i}" for i in
                                       range(len(got) - 3)],
                             got[2:], [gx_p] + cc._leaves(tree)))
                n_cmp += len(got)
                if dtype == torch.float32 and model == "demo":
                    results["coupling_fwd"]["err"] = max(
                        results["coupling_fwd"]["err"], e4)
                    results["coupling_bwd"]["err"] = max(
                        results["coupling_bwd"]["err"], e5)
    torch.cuda.synchronize()
    say(12, f"{n_cmp} K4/K5-vs-plain comparisons within tolerance (float32 "
            f"and float64, forward and inverse, y, ld, gx and every weight "
            f"gradient); K4 (y, ld) and K5 (gx, every weight gradient) gave "
            f"identical bits on two runs each; K4's lane and row tiles gave "
            f"the bits of the tile the batch picks ({n_tiles} outputs); "
            f"{redrawn} rows drawn again off the leaky ReLU's kink")

    switch = fwd_switch(cc, torch.float32)
    for model, n in CPL_TIMED + (("demo", switch), ("demo", switch + 1)):
        cfg = CPL_CFG[model]
        fb = flows[(model, torch.float32)]
        d, depth = cfg["q0"], len(cfg["hdims"]) + 1
        sels = cc._sels(fb.idx_even, fb.idx_odd, d)
        leaves = cc._leaves(fb.groups)
        stack = _unfused_like(fb, cfg, torch.float32)
        params = list(stack.parameters())
        x = torch.randn((n, d), generator=gen, device=DEVICE)
        xg = x.clone().requires_grad_()
        gy = torch.randn((n, d), generator=gen, device=DEVICE) / n
        gld = torch.randn((n,), generator=gen, device=DEVICE) / n

        def unfused_fwd():
            with torch.no_grad():
                return stack.forward_and_log_det(x)

        def unfused_fwd_bwd():
            y, ld = stack.forward_and_log_det(xg)
            return torch.autograd.grad((y, ld), [xg] + params, (gy, gld))

        t = {"coupling_fwd": (
                 device_ms(lambda: cc._launch_fwd(x, leaves, sels, depth,
                                                  False)),
                 device_ms(lambda: cc.tile_flow(x, fb.groups, sels)),
                 device_ms(unfused_fwd)),
             "coupling_bwd": (
                 device_ms(lambda: cc._launch_bwd(x, leaves, gy, gld, sels,
                                                  depth, False)),
                 device_ms(lambda: cc.tile_flow_bwd(x, fb.groups, gy, gld,
                                                    sels)),
                 device_ms(unfused_fwd_bwd))}
        for k, (ms, plain_ms, unfused_ms) in t.items():
            bms, by = coupling_bound_ms(k, cfg, n)
            key = str(n)
            results[k]["ms_by_n"][key] = ms
            results[k]["plain_ms_by_n"][key] = plain_ms
            results[k]["bound_ms_by_n"][key] = bms
            results[k]["unfused_ms_by_n"][key] = unfused_ms
            results[k].setdefault("bound_by_n", {})[key] = by
            what = ("forward" if k == "coupling_fwd"
                    else "forward+backward")
            say(12, f"{k} {model} N={n} f32: kernel {ms:.5f} ms, plain "
                    f"{plain_ms:.5f} ms, unfused {what} {unfused_ms:.5f} ms, "
                    f"bound {bms:.5f} ms ({by}) (device time a call: median "
                    f"of 7 CUDA-graph replays of 20 calls, CUDA events)")
    # K4 on each tile, whatever the batch: where the switch belongs
    sweep = results["coupling_fwd"]["tile_ms_by_n"] = {}
    for model in ("demo", "ref"):
        cfg = CPL_CFG[model]
        fb = flows[(model, torch.float32)]
        d, depth = cfg["q0"], len(cfg["hdims"]) + 1
        sels = cc._sels(fb.idx_even, fb.idx_odd, d)
        leaves = cc._leaves(fb.groups)
        for n in FWD_SWEEP:
            x = torch.randn((n, d), generator=gen, device=DEVICE)
            ms = {}
            for lanes in (True, False):
                with fwd_tile(cc, lanes):
                    ms["lane" if lanes else "row"] = device_ms(
                        lambda: cc._launch_fwd(x, leaves, sels, depth, False))
            picked = "lane" if cc.fwd_plan(leaves[0].shape[0], depth,
                                           max(cfg["hdims"]), 4,
                                           n).lanes else "row"
            sweep[f"{model} N={n}"] = {**ms, "picked": picked}
            say(12, f"coupling_fwd {model} N={n} f32: lane tile "
                    f"{ms['lane']:.5f} ms, row tile {ms['row']:.5f} ms "
                    f"(the batch picks the {picked} tile)")
    for k in CPL_KERNELS:
        r = results[k]
        main = str(RNVP_BATCH)
        r.update(ms=r["ms_by_n"][main], plain_ms=r["plain_ms_by_n"][main],
                 bound_ms=r["bound_ms_by_n"][main],
                 bound_by=r["bound_by_n"][main],
                 unfused_ms=r["unfused_ms_by_n"][main])
    return results


def phase_rnvp_same_step(gen):
    """One ELBO value-and-grad through the fused flow on the card, the same
    flow on the plain versions, and the unfused flow of the same seed."""
    import normalizingflows_torch as nft

    fused = _rnvp(RNVP_DEMO, 21, True)
    plain = copy.deepcopy(fused)
    plain.bijector.bijectors[0].backend = "plain"
    unfused = _rnvp(RNVP_DEMO, 21, False)
    fb, stack = fused.bijector.bijectors[0], unfused.bijector.bijectors[0]
    for grp in ("even", "odd"):
        for net in ("s", "t"):
            for li, (W, _) in enumerate(fb.groups[grp][net]):
                for i, m in enumerate(stack.stacked[f"{net}_{grp}"]):
                    _same(f"weights {grp} {net} {li} block {i}", W[i],
                          m.layers[li].W)
    xs = fused.base.sample(gen, (RNVP_BATCH,)).detach()
    target = nft.Banana(2, 1.0, 100.0)
    out = {}
    for label, flow, want in (
            ("fused cuda", fused, dict(coupling_fwd=1, coupling_bwd=1)),
            ("fused plain", plain, {}), ("unfused", unfused, {})):
        reset_counts()
        loss = -nft.elbo_from_samples(xs, flow, target.log_prob)
        loss.backward()
        torch.cuda.synchronize()
        expect_counts(f"phase 13, {label}", **want)
        out[label] = loss.detach()
    for label in ("fused plain", "unfused"):
        compare(f"loss, fused cuda vs {label}",
                out["fused cuda"].reshape(1), out[label].reshape(1), STEP_TOL)
    worst, count = 0.0, 0
    fbp = plain.bijector.bijectors[0]
    for grp in ("even", "odd"):
        for net in ("s", "t"):
            for li in range(len(fb.groups[grp][net])):
                ref = _stack_grads(stack, grp, net, li)
                for k in (0, 1):
                    got = fb.groups[grp][net][li][k].grad
                    for want in (fbp.groups[grp][net][li][k].grad, ref[k]):
                        worst = max(worst, compare(
                            f"grad {grp} {net} {li} {k}", got, want,
                            STEP_TOL, quiet=True))
                    count += 1
    for name in ("loc", "scale"):
        got = getattr(fused.base, name).grad
        for flow in (plain, unfused):
            worst = max(worst, compare(f"grad base.{name}", got,
                                       getattr(flow.base, name).grad,
                                       STEP_TOL, quiet=True))
        count += 1
    say(13, f"loss {float(out['fused cuda']):.6f} on the three paths; "
            f"{count} gradients agree (max abs err {worst:.3e}); the fused "
            f"pass launched K4 once and K5 once, the others no kernel")


def _stamped(train):
    """``train(callback)`` with a callback that stamps each chunk's end:
    (result, seconds, steps/s over the chunks after the first, or overall
    where there is one chunk)."""
    stamps = []

    def callback(it, stat, f):
        stamps.append((it, time.perf_counter()))  # after the chunk's fetch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train(callback)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steady = ((stamps[-1][0] - stamps[0][0]) / (stamps[-1][1] - stamps[0][1])
              if len(stamps) > 1 else len(res.stats["loss"]) / dt)
    return res, dt, steady


def _train_rate(flow, gen, target, batch, steps, lr, check_every):
    """train_flow with elbo_batch, eagerly (graph=False): (result, seconds,
    steps/s after the first chunk)."""
    import normalizingflows_torch as nft

    res, dt, steady = _stamped(lambda callback: nft.train_flow(
        gen, nft.elbo_batch, flow, target.log_prob, batch, max_iters=steps,
        check_every=check_every, callback=callback,
        optimizer=lambda p: torch.optim.Adam(p, lr=lr), graph=False))
    losses = res.stats["loss"]
    if len(losses) != steps or not torch.isfinite(
            torch.from_numpy(losses)).all():
        raise AssertionError("training gave non-finite losses")
    return res, dt, steady


def phase_rnvp_main(name):
    """The slice's main path: fused RealNVP demo training, then the unfused
    flow of the same seed on the same draws. Returns the flows, the fused
    run's launches and its ELBO and rate (for phase 20)."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    flows, launches, summary = {}, None, None
    for fused in (True, False):
        flow = _rnvp(RNVP_DEMO, 0, fused)
        gen = torch.Generator(device=DEVICE).manual_seed(40)
        reset_counts()
        res, dt, steady = _train_rate(flow, gen, target, RNVP_BATCH,
                                      RNVP_STEPS, RNVP_LR, 100)
        want = (dict(coupling_fwd=RNVP_STEPS, coupling_bwd=RNVP_STEPS)
                if fused else {})
        counts = expect_counts("phase 14", **want)
        losses = res.stats["loss"]
        first, last = losses[:100].mean(), losses[-100:].mean()
        if not last < first:
            raise AssertionError(f"ELBO did not rise: {-first} -> {-last}")
        label = "fused" if fused else "unfused"
        say(14, f"{label}: ELBO {-losses[0]:.4f} -> {-losses[-1]:.4f} (mean "
                f"of first 100 {-first:.4f}, last 100 {-last:.4f}); "
                f"{RNVP_STEPS} steps in {dt:.2f} s = {RNVP_STEPS / dt:.1f} "
                f"steps/s overall, {steady:.1f} steps/s after the first "
                f"chunk, on {name}; launches {counts}")
        flows[label] = flow
        if fused:
            launches = counts
            summary = dict(first=-losses[0], last=-losses[-1],
                           first100=-first, last100=-last, steady=steady)
    return flows, launches, summary


def phase_rnvp_sampling(flows, gen, name):
    """sample_and_log_prob at batch 262,144 through K4 and unfused, and the
    round trip through K4's inverse."""
    rates = {}
    with torch.no_grad():
        for label, flow in flows.items():
            flow.sample_and_log_prob(gen, (SAMPLE_BATCH,))  # warm
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            for _ in range(SAMPLE_REPS):
                flow.sample_and_log_prob(gen, (SAMPLE_BATCH,))
            torch.cuda.synchronize()
            rates[label] = SAMPLE_REPS * SAMPLE_BATCH / (
                time.perf_counter() - t0)
            expect_counts(f"phase 15 {label}", **(
                dict(coupling_fwd=SAMPLE_REPS) if label == "fused" else {}))
        fused = flows["fused"]
        y, lq = fused.sample_and_log_prob(gen, (SAMPLE_BATCH,))
        lp = fused.log_prob(y)
        if y.shape != (SAMPLE_BATCH, 2) or not bool(torch.isfinite(y).all()):
            raise AssertionError("samples are not finite (262144, 2)")
    e = compare("log_prob(y) vs sample_and_log_prob", lp, lq, ROUND_TRIP_TOL)
    say(15, f"sample_and_log_prob, batch {SAMPLE_BATCH}, {SAMPLE_REPS} "
            f"calls: fused (K4) {rates['fused']:.4g} samples/s, unfused "
            f"{rates['unfused']:.4g} samples/s, on {name}; round trip "
            f"through K4's inverse: max abs err {e:.3e}")


def phase_rnvp_ref(gen, name):
    """The reference default realnvp(2): [32,32]x10, batch 256, fused."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    flow = _rnvp(RNVP_REF, 50, True)
    _train_rate(flow, gen, target, RNVP_REF_BATCH, 5, RNVP_LR, 5)  # warm
    reset_counts()
    res, dt, _ = _train_rate(flow, gen, target, RNVP_REF_BATCH,
                             RNVP_REF_STEPS, RNVP_LR, RNVP_REF_STEPS)
    counts = expect_counts("phase 16", coupling_fwd=RNVP_REF_STEPS,
                           coupling_bwd=RNVP_REF_STEPS)
    losses = res.stats["loss"]
    say(16, f"reference default [32,32]x10, batch {RNVP_REF_BATCH}, fused: "
            f"{RNVP_REF_STEPS} steps in {dt:.3f} s = "
            f"{RNVP_REF_STEPS / dt:.1f} steps/s, loss {losses[0]:.2f} -> "
            f"{losses[-1]:.2f}, launches {counts}, on {name}")


def phase_rnvp_wide(gen, name):
    """Wide unfused RealNVP with remat: the GEMM-bound default path."""
    import normalizingflows_torch as nft

    target = nft.Banana(RNVP_WIDE["q0"], 1.0, 100.0)
    flow = _rnvp(RNVP_WIDE, 60, False)
    _train_rate(flow, gen, target, RNVP_WIDE_BATCH, 2, RNVP_WIDE_LR, 2)
    gc.collect()  # earlier phases' reference cycles (CUDA graphs, flows)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    res, dt, _ = _train_rate(flow, gen, target, RNVP_WIDE_BATCH,
                             RNVP_WIDE_STEPS, RNVP_WIDE_LR, RNVP_WIDE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    expect_counts("phase 17")
    losses = res.stats["loss"]
    cfg = RNVP_WIDE
    say(17, f"wide unfused f32 d={cfg['q0']} {list(cfg['hdims'])}x"
            f"{cfg['nlayers']} batch {RNVP_WIDE_BATCH} remat: "
            f"{RNVP_WIDE_STEPS} steps in {dt:.3f} s = "
            f"{RNVP_WIDE_STEPS / dt:.2f} steps/s, peak memory "
            f"{peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB of it held "
            f"before the run: the flow's weights and what earlier phases "
            f"keep), loss {losses[0]:.2f} -> "
            f"{losses[-1]:.2f}, no kernel launched, on {name}")


# ---------------------------------------------------------------------------
# The whole-run training kernel K6 and its yardsticks
# ---------------------------------------------------------------------------

def train_bound_ms(cfg: dict, n: int, launch_steps, word_bytes: int = 4):
    """The bound of one K6 step on n rows, for a run made of launches of
    ``launch_steps`` steps each, its values stored in ``word_bytes`` (2 for
    bfloat16 parameters, whose arithmetic is float32): what each launch's
    function must move and do, over the run's steps. Bytes: its steps'
    draws read, one loss a step written, the weights and both Adam moments
    read once and written once (6 words a weight); the cotangents, the
    input cotangent and the weight gradients never leave the launch.
    Operations, at the float32 peak: K5's a step (one forward and the
    backward, `coupling_work`) plus Adam's 14 a weight (the two moments,
    the bias corrections, the square root and the update); the target's
    few a row are left out."""
    d, n_params = cfg["q0"], rnvp_n_params(cfg)
    steps = sum(launch_steps)
    ops = steps * (coupling_work("coupling_bwd", cfg, n, 4)[0]
                   + 14 * n_params)
    words = steps * (n * d + 1) + len(launch_steps) * 6 * n_params
    t_bytes = word_bytes * words / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops) / steps, (
        "bytes" if t_bytes >= t_ops else "operations")


def _k6_target(kind: str, d: int):
    """K6's targets by name at dimension d: "banana" Banana(d, 1, 100),
    "funnel" the Hamiltonian demo's Funnel(d, -8, 5), "warped" the radial
    demo's WarpedGauss(1.0, 0.12) and "warped_ref" with ref_compat."""
    import normalizingflows_torch as nft

    return {"banana": lambda: nft.Banana(d, 1.0, 100.0),
            "funnel": lambda: nft.Funnel(d, -8.0, 5.0),
            "warped": lambda: nft.WarpedGauss(1.0, 0.12),
            "warped_ref": lambda: nft.WarpedGauss(1.0, 0.12,
                                                  ref_compat=True)}[kind]()


def _train_args(cfg: dict, dtype, batch: int, steps: int, seed: int, gen,
                perturb=True, target="banana"):
    """adam_train_realnvp_fused's arguments for a fused flow of ``cfg`` on
    the card, ``steps`` draws of its base and the target named
    ``target`` (`_k6_target`): (flow, args)."""
    flow = _rnvp(cfg, seed, True, dtype)
    if perturb:
        flow = _perturbed(flow)
    fb = flow.bijector.bijectors[0]
    xs = flow.base.sample(gen, (steps, batch)).detach()
    return flow, (xs, fb.groups, fb.idx_even, fb.idx_odd,
                  _k6_target(target, cfg["q0"]), flow.base.loc,
                  flow.base.scale, RNVP_LR)


def _train_outputs(res):
    from normalizingflows_torch.experimental import coupling_cuda as cc

    groups, losses = res
    return [losses] + cc._leaves(groups)


def _as_f64(args):
    """adam_train_realnvp_fused's arguments with the draws, weights and
    base in float64 (the same values)."""
    xs, groups, idx_even, idx_odd, target, loc, scale, lr = args
    groups = {g: {n: [(W.double(), b.double()) for W, b in groups[g][n]]
                  for n in groups[g]} for g in groups}
    return (xs.double(), groups, idx_even, idx_odd, target, loc.double(),
            scale.double(), lr)


def _k6_against_plain(tag, args, tol, witness=False):
    """K6 on ``args`` twice and in chunks of 8, with identical bits, and
    against `adam_train_plain` within ``tol``: (the max abs error of the
    losses and every trained weight, the outputs compared). With
    ``witness`` (float32), an output with elements outside ``tol`` is held
    instead to the float64 plain run on the same values: its relative L2
    error against it at most K6_WITNESS_FACTOR times the float32 plain
    version's own, plus LEAF_FLOOR."""
    from normalizingflows_torch.experimental import train_cuda as tc

    got = _train_outputs(tc.adam_train_realnvp_fused(*args, backend="cuda"))
    again = _train_outputs(tc.adam_train_realnvp_fused(*args,
                                                       backend="cuda"))
    chunked = _train_outputs(tc.adam_train_realnvp_fused(
        *args, chunk=8, backend="cuda"))
    for i, (a, b, c) in enumerate(zip(got, again, chunked)):
        _same(f"K6 {tag} output {i}, two runs", a, b)
        _same(f"K6 {tag} output {i}, chunks of 8", a, c)
    want = _train_outputs(tc.adam_train_plain(*args))
    f64 = (_train_outputs(tc.adam_train_plain(*_as_f64(args))) if witness
           else None)
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        name = f"K6 {tag} {'losses' if i == 0 else f'leaf {i}'}"
        diff = (a.double() - b.double()).abs()
        out = int((diff > tol[1] + tol[0] * b.double().abs()).sum())
        if out and witness:
            e, e32 = _rel([a], [f64[i]]), _rel([b], [f64[i]])
            print(f"    {name}: {out}/{a.numel()} elements outside tol, max "
                  f"abs {float(diff.max()):.3e}; relative L2 against "
                  f"float64 {e:.3e}, the float32 plain version's {e32:.3e}",
                  flush=True)
            if not e <= K6_WITNESS_FACTOR * e32 + LEAF_FLOOR:
                raise AssertionError(
                    f"{name}: relative L2 error {e:.3e} against the float64 "
                    f"plain run, the float32 plain version's {e32:.3e} "
                    f"(limit {K6_WITNESS_FACTOR} times it plus "
                    f"{LEAF_FLOOR})")
            err = max(err, float(diff.max()))
        else:
            err = max(err, compare(name, a, b, tol, quiet=i > 0))
    return err, len(got)


def phase_train_kernel(gen):
    """K6 against its plain version on the card; identical bits on two runs
    and across chunk sizes; the plain version's device time a step."""
    from normalizingflows_torch.experimental import train_cuda as tc

    err, n_cmp = 0.0, 0
    for dtype in (torch.float32, torch.float64):
        for model, batch in TRAIN_SHAPES:
            _, args = _train_args(CPL_CFG[model], dtype, batch,
                                  TRAIN_CMP_STEPS, 31, gen)
            e, n = _k6_against_plain(f"{str(dtype)[6:]} {model} batch "
                                     f"{batch}", args, TRAIN_TOL[dtype])
            n_cmp += n
            if dtype == torch.float32 and model == "demo":
                err = e
    torch.cuda.synchronize()
    say(18, f"{n_cmp} K6-vs-plain comparisons within tolerance (losses and "
            f"every trained weight, {TRAIN_CMP_STEPS} steps, float32 and "
            f"float64, demo, reference default at batch 256 and 16, d=5); K6 "
            f"gave identical bits on two runs and in chunks of 8 against one "
            f"launch")

    # the plain version's device time a step: 10 steps a call
    _, args = _train_args(RNVP_DEMO, torch.float32, RNVP_BATCH, 10, 32, gen)
    plain_ms = device_ms(lambda: tc.adam_train_plain(*args), reps=5,
                         inner=2) / 10
    say(18, f"adam_train_plain demo batch {RNVP_BATCH} f32: {plain_ms:.5f} ms "
            f"a step (device time: median of 5 CUDA-graph replays of 2 "
            f"calls of 10 steps, CUDA events)")
    return {"err": err, "plain_ms": plain_ms}


def _k6_against_eager(phase, label, dtype, target, seed, gen, bounds,
                      counts):
    """K6 against the eager K4/K5 step with torch.optim.Adam on the same
    TRAIN_CMP_STEPS draws of the demo (``dtype``, ``target`` by name),
    launch counts asserted for both (``counts``: K6's name, then the eager
    step's K4 and K5 names); (first loss relative difference, trajectory
    max |Δ|/(|loss| + 1)), each below its bound in ``bounds``."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.experimental import train_cuda as tc

    flow, args = _train_args(RNVP_DEMO, dtype, RNVP_BATCH, TRAIN_CMP_STEPS,
                             seed, gen, perturb=False, target=target)
    xs, logp = args[0], args[4].log_prob
    k6, fwd, bwd = counts
    reset_counts()
    _, losses = tc.adam_train_realnvp_fused(*args)
    torch.cuda.synchronize()
    expect_counts(f"phase {phase}, K6 {label}", **{k6: 1})
    fb = flow.bijector.bijectors[0]
    opt = torch.optim.Adam(fb.parameters(), lr=RNVP_LR)
    eager = []
    reset_counts()
    for x in xs:
        opt.zero_grad(set_to_none=True)
        loss = -nft.elbo_from_samples(x, flow, logp)
        loss.backward()
        opt.step()
        eager.append(loss.detach())
    torch.cuda.synchronize()
    expect_counts(f"phase {phase}, eager {label}",
                  **{fwd: TRAIN_CMP_STEPS, bwd: TRAIN_CMP_STEPS})
    eager = torch.stack(eager).double()
    losses = losses.double()
    first = float((losses[0] - eager[0]).abs() / eager[0].abs())
    traj = float(((losses - eager).abs() / (eager.abs() + 1.0)).max())
    if not (first < bounds[0] and traj < bounds[1]):
        raise AssertionError(f"K6 {label} against the eager step: first "
                             f"loss rel {first:.3e} (< {bounds[0]}), "
                             f"trajectory {traj:.3e} (< {bounds[1]})")
    say(phase, f"K6 {label} against the eager K4/K5 step + "
               f"torch.optim.Adam, {TRAIN_CMP_STEPS} steps of the demo on "
               f"the same draws: first loss rel {first:.3e}, trajectory "
               f"max |Δ|/(|loss|+1) {traj:.3e}; loss {float(eager[0]):.4f} "
               f"-> {float(eager[-1]):.4f}")
    return first, traj


def phase_train_vs_eager(gen):
    """K6 against the eager K4/K5 step on the same draws."""
    _k6_against_eager(19, "f32 banana", torch.float32, "banana", 33, gen,
                      (FIRST_LOSS_REL, TRAJECTORY_REL),
                      ("realnvp_train", "coupling_fwd", "coupling_bwd"))


def _timed_train(flow, gen, target, batch, steps):
    """train_realnvp_fused with CUDA events around each K6 launch: (result,
    host seconds, [device ms of each launch], [steps of each launch])."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.experimental import train_cuda as tc

    events, launch_steps = [], []
    launch = tc._launch_chunk

    def timed(fn, xs, w, m, v, grad, losses, run, step0, n, args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(fn, xs, w, m, v, grad, losses, run, step0, n, args)
        stop.record()
        events.append((start, stop))
        launch_steps.append(n)

    tc._launch_chunk = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = nft.train_realnvp_fused(gen, flow, target, batch,
                                      max_iters=steps, learning_rate=RNVP_LR)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        tc._launch_chunk = launch
    losses = res.stats["loss"]
    if losses.shape != (steps,) or not torch.isfinite(
            torch.from_numpy(losses)).all():
        raise AssertionError("whole-run training gave non-finite losses")
    return res, dt, [a.elapsed_time(b) for a, b in events], launch_steps


def phase_train_main(name, eager):
    """The slice's main path: the demo through train_realnvp_fused, then the
    reference default."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    flow = _rnvp(RNVP_DEMO, 0, True)
    gen = torch.Generator(device=DEVICE).manual_seed(80)
    reset_counts()
    res, dt, launch_ms, launch_steps = _timed_train(
        flow, gen, target, RNVP_BATCH, RNVP_STEPS)
    counts = expect_counts("phase 20", realnvp_train=2)
    losses = res.stats["loss"]
    first, last = losses[:100].mean(), losses[-100:].mean()
    if not last < first:
        raise AssertionError(f"ELBO did not rise: {-first} -> {-last}")
    step_ms = sum(launch_ms) / RNVP_STEPS
    bms, by = train_bound_ms(RNVP_DEMO, RNVP_BATCH, launch_steps)
    say(20, f"train_realnvp_fused demo: ELBO {-losses[0]:.4f} -> "
            f"{-losses[-1]:.4f} (mean of first 100 {-first:.4f}, last 100 "
            f"{-last:.4f}); {RNVP_STEPS} steps in {dt:.4f} s = "
            f"{RNVP_STEPS / dt:.1f} steps/s; K6 launches of {launch_steps} "
            f"steps {launch_ms} ms (CUDA events) = {step_ms:.5f} ms a step "
            f"on the device, bound {bms:.3e} ms a step ({by}); launches "
            f"{counts}, on {name}")
    if eager:
        say(20, f"phase 14 (eager K4/K5, other draws): ELBO "
                f"{eager['first']:.4f} -> {eager['last']:.4f} (mean of first "
                f"100 {eager['first100']:.4f}, last 100 "
                f"{eager['last100']:.4f}), {eager['steady']:.1f} steps/s "
                f"after the first chunk")

    flow = _rnvp(RNVP_REF, 50, True)
    reset_counts()
    res_ref, dt_ref, ref_ms, ref_steps = _timed_train(
        flow, gen, target, RNVP_REF_BATCH, TRAIN_REF_STEPS)
    ref_counts = expect_counts("phase 20, reference default",
                               realnvp_train=1)
    ref_bms, ref_by = train_bound_ms(RNVP_REF, RNVP_REF_BATCH, ref_steps)
    losses = res_ref.stats["loss"]
    say(20, f"reference default [32,32]x10, batch {RNVP_REF_BATCH}: "
            f"{TRAIN_REF_STEPS} steps in {dt_ref:.4f} s = "
            f"{TRAIN_REF_STEPS / dt_ref:.1f} steps/s, K6 {ref_ms[0]:.3f} ms "
            f"= {ref_ms[0] / TRAIN_REF_STEPS:.5f} ms a step on the device, "
            f"bound {ref_bms:.3e} ms a step ({ref_by}), loss "
            f"{losses[0]:.2f} -> {losses[-1]:.2f}, launches {ref_counts}, "
            f"on {name}")
    return counts, {"ms": step_ms, "ms_per_launch": launch_ms,
                    "steps_per_s": RNVP_STEPS / dt, "bound_ms": bms,
                    "bound_by": by, "ref_ms": ref_ms[0] / TRAIN_REF_STEPS,
                    "ref_steps_per_s": TRAIN_REF_STEPS / dt_ref,
                    "ref_bound_ms": ref_bms, "ref_bound_by": ref_by}


def phase_graph_step(name):
    """One eager K4/K5 train step of the demo captured in a CUDA graph and
    replayed: the yardstick of K6. The capture is the profiler's
    (benchmarks/torch_profile.py), so both time the same graph."""
    import normalizingflows_torch as nft

    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    from torch_profile import capture_train_step

    flow = _rnvp(RNVP_DEMO, 0, True)
    reset_counts()
    graph, loss = capture_train_step(flow, nft.Banana(2, 1.0, 100.0),
                                     RNVP_BATCH, RNVP_LR, _warmup_stream())
    # the counters count at capture: 3 warm steps and the captured one
    expect_counts("phase 21, capture", coupling_fwd=4, coupling_bwd=4)
    reset_counts()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(GRAPH_STEPS):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = start.elapsed_time(stop) / GRAPH_STEPS
    if not bool(torch.isfinite(loss)):
        raise AssertionError("the graphed step gave a non-finite loss")
    say(21, f"CUDA graph of one eager K4/K5 demo step, {GRAPH_STEPS} "
            f"replays: {GRAPH_STEPS / dt:.1f} steps/s, {step_ms:.5f} ms a "
            f"step on the device (CUDA events), last loss {float(loss):.4f},"
            f" on {name}")
    return {"graph_step_ms": step_ms, "graph_steps_per_s": GRAPH_STEPS / dt}


# ---------------------------------------------------------------------------
# The trainers' default on the card: the step replayed from a CUDA graph
# ---------------------------------------------------------------------------

def _graph_and_eager(phase, label, make, train, steps, per_step, name,
                     eager_steps=None):
    """One cell graphed, then eagerly: ``make()`` builds its flow (one seed
    both times), ``train(flow, graph, callback)`` trains it ``steps`` steps
    graphed and ``eager_steps`` (default ``steps``) eagerly. Each run's
    launch counts must be ``per_step`` (kernel -> launches a step; an
    empty dict: no kernel of ours) times its steps, the graphed run's by
    replay, with one capture; its losses finite. Returns both runs' flow,
    result, steps/s overall and after the first chunk, peak memory and
    counts."""
    from normalizingflows_torch.ops import launches

    out = {}
    for graph in (True, False):
        steps_here = steps if graph else (eager_steps or steps)
        flow = make()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        res, dt, steady = _stamped(lambda cb: train(flow, graph, cb))
        peak = torch.cuda.max_memory_allocated()
        path = "graph" if graph else "eager"
        counts = expect_counts(
            f"phase {phase}, {label}, {path}",
            **{k: n * steps_here for k, n in per_step.items()})
        captures = launches.captures()
        if captures != int(graph):
            raise AssertionError(f"phase {phase}, {label}, {path}: "
                                 f"{captures} captures, expected "
                                 f"{int(graph)}")
        losses = res.stats["loss"]
        if len(losses) != steps_here or not torch.isfinite(
                torch.from_numpy(losses)).all():
            raise AssertionError(f"phase {phase}, {label}, {path}: "
                                 "non-finite losses")
        out[path] = dict(flow=flow, res=res, steps_per_s=steps_here / dt,
                         steady=steady, peak_mib=peak / 2**20,
                         held_mib=held / 2**20, counts=counts)
    g, e = out["graph"], out["eager"]
    say(phase, f"{label}, {steps} / {eager_steps or steps} steps graphed / "
               f"eager: graph {g['steady']:.1f} steps/s "
               f"after the first chunk ({g['steps_per_s']:.1f} overall, "
               f"one capture), eager {e['steady']:.1f} "
               f"({e['steps_per_s']:.1f} overall); peak memory graph "
               f"{g['peak_mib']:.1f} MiB, eager {e['peak_mib']:.1f} MiB "
               f"({g['held_mib']:.1f} / {e['held_mib']:.1f} held before); "
               f"launches a step {per_step or 'none of K1-K6'} on both "
               f"paths, by replay on the graph's; loss "
               f"{g['res'].stats['loss'][0]:.3f} -> "
               f"{g['res'].stats['loss'][-1]:.3f} graphed, on {name}")
    return out


def _agree(phase, label, a, b, strict=False, what="graphed against eager"):
    """Two runs' per-step losses and final parameters, ``a`` and ``b``
    each (losses, parameters), within GRAPH_TOL. Returns whether every bit
    agrees; ``strict`` raises unless they do."""
    (la, pa), (lb, pb) = a, b
    la, lb = torch.from_numpy(la), torch.from_numpy(lb)
    e = compare(f"{label}: {what}, losses", la, lb, GRAPH_TOL)
    ep = max(compare(f"{label}: {what}, parameters", x, y, GRAPH_TOL,
                     quiet=True) for x, y in zip(pa, pb))
    same = bool(torch.equal(la, lb)
                and all(torch.equal(x, y) for x, y in zip(pa, pb)))
    say(phase, f"{label}, {len(la)} steps on the same inputs: {what}, "
               f"losses max abs err {e:.3e}, final parameters {ep:.3e} "
               f"(rtol {GRAPH_TOL[0]}, atol {GRAPH_TOL[1]}); identical "
               f"bits: {same}")
    if strict and not same:
        raise AssertionError(f"phase {phase}, {label}: {what} on the same "
                             "inputs differ in their bits")
    return same


def _outcome(res, flow):
    """A run's per-step losses and final parameters, for `_agree`."""
    return (res.stats["loss"],
            [p.detach().clone() for p in flow.parameters()])


def _same_inputs(phase, label, make, train, steps, strict=False):
    """``train(flow, graph)`` graphed and eagerly on flows from ``make()``
    (one seed), on the same inputs, both with Adam(capturable=True):
    per-step losses and final parameters within GRAPH_TOL (`_agree`).
    Returns whether every bit agrees; ``strict`` raises unless they do."""
    runs = {}
    for graph in (True, False):
        flow = make()
        runs[graph] = _outcome(train(flow, graph), flow)
    if len(runs[True][0]) != steps:
        raise AssertionError(f"phase {phase}, {label}: "
                             f"{len(runs[True][0])} steps")
    return _agree(phase, label, runs[True], runs[False], strict,
                  "both with Adam(capturable=True), graphed against eager")


def _draws_differ(phase, make, batch, lr):
    """The caller's generator under a graph draws anew at each replay: an
    objective that keeps each step's first base draw, over DRAW_STEPS
    steps (WARM_STEPS eager, one capture, the rest replays), must keep
    DRAW_STEPS distinct draws."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import launches
    from normalizingflows_torch.train import WARM_STEPS

    flow = make()
    target = nft.Banana(flow.event_dim, 1.0, 100.0)
    kept = torch.zeros((DRAW_STEPS, flow.event_dim), device=DEVICE)

    def objective(g, f, logp, n):
        xs = f.base.sample(g, (n,))
        kept.copy_(torch.cat([xs[:1], kept[:-1]]))
        return nft.elbo_from_samples(xs, f, logp)

    reset_counts()
    nft.train_flow(torch.Generator(device=DEVICE).manual_seed(phase),
                   objective, flow, target.log_prob, batch,
                   max_iters=DRAW_STEPS, check_every=DRAW_STEPS,
                   optimizer=lambda p: torch.optim.Adam(p, lr=lr))
    distinct = torch.unique(kept, dim=0).shape[0]
    if launches.captures() != 1 or distinct != DRAW_STEPS:
        raise AssertionError(f"phase {phase}: {distinct} distinct draws in "
                             f"{DRAW_STEPS} steps, {launches.captures()} "
                             "captures: replays reuse a draw")
    say(phase, f"the caller's generator under the graph: {DRAW_STEPS} steps "
               f"({WARM_STEPS} eager, {DRAW_STEPS - WARM_STEPS} replays) "
               f"drew {distinct} distinct base samples")


def _capture_failure_raises(phase, gen):
    """A launch refused inside the capture raises, with a message that
    names graph=False, and nothing runs in its place: while the stream is
    capturing, K1 gets an even staged row stride, which its C entry refuses
    before any CUDA call."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import rqs_cuda

    plan = rqs_cuda.fwd_plan

    def refused(stride_elem, K, word):
        p = plan(stride_elem, K, word)
        if p.staged and torch.cuda.is_current_stream_capturing():
            return p._replace(stride=p.stride + 1)
        return p

    target = nft.Banana(2, 1.0, 100.0)
    rqs_cuda.fwd_plan = refused
    try:
        nft.train_flow(gen, nft.elbo_batch, _demo_flow(), target.log_prob,
                       DEMO_BATCH, max_iters=DRAW_STEPS,
                       check_every=DRAW_STEPS)
    except RuntimeError as err:
        message = str(err)
    else:
        raise AssertionError("a launch refused inside the capture did not "
                             "raise")
    finally:
        rqs_cuda.fwd_plan = plan
    if "graph=False" not in message or "rqs_fwd" not in message:
        raise AssertionError(f"the capture failure said: {message}")
    say(phase, f"a launch refused inside the capture raised: {message}")


def _presampled_train(logp, batch, lr, steps):
    """``train(flow, graph)`` for `_same_inputs`: ELBO steps on
    presample_base draws from one seed, Adam(capturable=True)."""
    import normalizingflows_torch as nft

    def train(flow, graph):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(7),
            nft.elbo_from_samples, flow, logp,
            max_iters=steps, check_every=SAME_CHECK,
            scan_inputs=nft.presample_base(batch),
            optimizer=lambda p: torch.optim.Adam(p, lr=lr, capturable=True),
            graph=graph)

    return train


def phase_graph_elbo(gen, name):
    """`train_flow`'s default on the card: the NSF demo's and the wide
    ELBO step replayed from a CUDA graph, beside the eager loop."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    wide_target = nft.Banana(WIDE["q0"], 1.0, 100.0)

    def want(cfg):
        return dict.fromkeys(("rqs_fwd", "rqs_bwd_fwddir"), 2 * cfg["nlayers"])

    def demo(flow, graph, callback):
        return nft.train_flow(
            gen, nft.elbo_batch, flow, target.log_prob, DEMO_BATCH,
            max_iters=DEMO_STEPS, check_every=100, callback=callback,
            optimizer=lambda p: torch.optim.Adam(p, lr=DEMO_LR), graph=graph)

    def wide(flow, graph, callback):
        return nft.train_flow(
            gen, nft.elbo_batch, flow, wide_target.log_prob, WIDE_BATCH,
            max_iters=2 * WIDE_STEPS, check_every=WIDE_STEPS,
            callback=callback,
            optimizer=lambda p: torch.optim.Adam(p, lr=WIDE_LR), graph=graph)

    out = {"demo": _graph_and_eager(22, "NSF demo", _demo_flow, demo,
                                    DEMO_STEPS, want(DEMO), name)}
    losses = out["demo"]["graph"]["res"].stats["loss"]
    if not losses[-20:].mean() < losses[:20].mean():
        raise AssertionError("the graphed demo's loss did not fall")
    out["wide"] = _graph_and_eager(
        22, "NSF wide", lambda: nft.nsf(torch.Generator().manual_seed(3),
                                        **WIDE),
        wide, 2 * WIDE_STEPS, want(WIDE), name)
    out["identical"] = _same_inputs(
        22, "NSF demo", _demo_flow,
        _presampled_train(target.log_prob, DEMO_BATCH, DEMO_LR, SAME_STEPS),
        SAME_STEPS)
    _draws_differ(22, _demo_flow, DEMO_BATCH, DEMO_LR)
    _capture_failure_raises(22, gen)
    return out


def phase_graph_mle(gen, name):
    """`train_flow_mle`'s default on the card: phase 10's and 11's recipes
    replayed from a CUDA graph, beside the eager loop."""
    import normalizingflows_torch as nft

    target, train, held = _mle_data(gen, 2)
    _, wide_train, _ = _mle_data(gen, WIDE["q0"])
    def want(cfg):
        return dict.fromkeys(("rqs_fwd", "rqs_bwd_invdir"), 2 * cfg["nlayers"])

    def mle(data, batch, steps, check_every):
        def train(flow, graph, callback=None, capturable=False):
            return nft.train_flow_mle(
                flow, nft.utils.data.make_loader(data, batch, seed=0),
                max_iters=steps, check_every=check_every, callback=callback,
                optimizer=lambda p: torch.optim.Adam(
                    p, lr=MLE_LR, capturable=capturable), graph=graph)
        return train

    with torch.no_grad():
        before = float(_demo_flow().log_prob(held).mean())
        ceiling = float(target.log_prob(held).mean())
    out = {"demo": _graph_and_eager(23, "MLE demo", _demo_flow,
                                    mle(train, MLE_BATCH, MLE_STEPS, 100),
                                    MLE_STEPS, want(DEMO), name)}
    with torch.no_grad():
        after = float(out["demo"]["graph"]["flow"].log_prob(held).mean())
    if not after > before:
        raise AssertionError(f"graphed MLE: held-out log-likelihood did not "
                             f"rise: {before} -> {after}")
    say(23, f"graphed MLE demo: held-out mean log-likelihood "
            f"{before:.4f} -> {after:.4f} (the target's E_p[log p] "
            f"{ceiling:.4f})")
    out["wide"] = _graph_and_eager(
        23, "MLE wide", lambda: nft.nsf(torch.Generator().manual_seed(7),
                                        **WIDE),
        mle(wide_train, MLE_WIDE_BATCH, 2 * MLE_WIDE_STEPS, MLE_WIDE_STEPS),
        2 * MLE_WIDE_STEPS, want(WIDE), name)
    same = mle(train, MLE_BATCH, SAME_STEPS, SAME_CHECK)
    out["identical"] = _same_inputs(
        23, "MLE demo", _demo_flow,
        lambda flow, graph: same(flow, graph, capturable=True), SAME_STEPS)
    return out


def phase_graph_rnvp(name, k6=None, yardstick=None):
    """`train_flow`'s default on the fused RealNVP (K4, K5): the demo and
    the reference default replayed from a CUDA graph, beside the eager
    loop, phase 21's hand-captured step and phase 20's K6 (``k6``,
    ``yardstick``: their steps/s, where those phases ran)."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    want = {"coupling_fwd": 1, "coupling_bwd": 1}

    def rnvp(batch, steps, check_every):
        def train(flow, graph, callback):
            return nft.train_flow(
                torch.Generator(device=DEVICE).manual_seed(40),
                nft.elbo_batch, flow, target.log_prob, batch,
                max_iters=steps, check_every=check_every, callback=callback,
                optimizer=lambda p: torch.optim.Adam(p, lr=RNVP_LR),
                graph=graph)
        return train

    out = {"demo": _graph_and_eager(
        24, "fused RealNVP demo", lambda: _rnvp(RNVP_DEMO, 0, True),
        rnvp(RNVP_BATCH, RNVP_STEPS, 100), RNVP_STEPS, want, name)}
    losses = out["demo"]["graph"]["res"].stats["loss"]
    if not losses[-100:].mean() < losses[:100].mean():
        raise AssertionError("the graphed RealNVP demo's ELBO did not rise")
    out["ref"] = _graph_and_eager(
        24, "fused reference default", lambda: _rnvp(RNVP_REF, 50, True),
        rnvp(RNVP_REF_BATCH, RNVP_REF_STEPS, RNVP_REF_STEPS // 2),
        RNVP_REF_STEPS, want, name)
    out["identical"] = _same_inputs(
        24, "fused RealNVP demo", lambda: _rnvp(RNVP_DEMO, 0, True),
        _presampled_train(target.log_prob, RNVP_BATCH, RNVP_LR,
                          2 * SAME_STEPS),
        2 * SAME_STEPS)
    _draws_differ(24, lambda: _rnvp(RNVP_DEMO, 0, True), RNVP_BATCH, RNVP_LR)
    say(24, f"fused RealNVP demo through train_flow's graph "
            f"{out['demo']['graph']['steady']:.1f} steps/s, beside phase "
            f"21's hand-captured step "
            f"{'not run' if yardstick is None else f'{yardstick:.1f}'} and "
            f"phase 20's K6 {'not run' if k6 is None else f'{k6:.1f}'}")
    return out


def phase_annealed(gen, name):
    """`train_flow_annealed` on the card: the NSF demo on Banana(2, 1,
    100), β = 1/4, 2/4, 3/4 for ANNEAL_ITERS steps each and β = 1 for
    twice that, from one capture; then the same schedule, shorter,
    graphed against eager on the same draws (β filled in place)."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import launches

    target = nft.Banana(2, 1.0, 100.0)
    flow = _demo_flow()
    kw = dict(n_betas=ANNEAL_BETAS, iters_per_beta=ANNEAL_ITERS,
              final_iters=2 * ANNEAL_ITERS)
    total = (ANNEAL_BETAS + 1) * ANNEAL_ITERS
    reset_counts()
    res, dt, steady = _stamped(lambda cb: nft.train_flow_annealed(
        gen, nft.elbo_batch, flow, target.log_prob, DEMO_BATCH,
        optimizer=lambda p: torch.optim.Adam(p, lr=DEMO_LR),
        check_every=ANNEAL_ITERS, callback=cb, **kw))
    per_step = 2 * DEMO["nlayers"]
    counts = expect_counts("phase 25", rqs_fwd=per_step * total,
                           rqs_bwd_fwddir=per_step * total)
    beta, losses = res.stats["beta"], res.stats["loss"]
    if not (len(beta) == len(losses) == total == res.state.iteration
            and beta[0] == 1 / ANNEAL_BETAS and beta[-1] == 1.0
            and beta[ANNEAL_ITERS] == 2 / ANNEAL_BETAS
            and launches.captures() == 1
            and torch.isfinite(torch.from_numpy(losses)).all()):
        raise AssertionError(f"phase 25: {len(beta)} steps of β {beta[0]} .. "
                             f"{beta[-1]}, {launches.captures()} captures")

    def anneal(flow, graph):
        return nft.train_flow_annealed(
            torch.Generator(device=DEVICE).manual_seed(8),
            lambda xs, f, lp, n: nft.elbo_from_samples(xs, f, lp), flow,
            target.log_prob, DEMO_BATCH, n_betas=ANNEAL_BETAS,
            iters_per_beta=SAME_CHECK, final_iters=2 * SAME_CHECK,
            check_every=SAME_CHECK, scan_inputs=nft.presample_base(
                DEMO_BATCH),
            optimizer=lambda p: torch.optim.Adam(p, lr=DEMO_LR,
                                                 capturable=True),
            graph=graph)

    identical = _same_inputs(25, "annealed NSF demo", _demo_flow, anneal,
                             (ANNEAL_BETAS + 1) * SAME_CHECK)
    say(25, f"train_flow_annealed, NSF demo: {total} steps over β "
            f"{beta[0]} .. {beta[-1]} in {dt:.2f} s ({steady:.1f} steps/s "
            f"after the first chunk), one capture for every segment, "
            f"launches {counts}; loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
            f"on {name}")
    return {"counts": counts, "identical": identical, "steady": steady}


def profile_cell(phase, label, p, train, name, by_name=False) -> dict:
    """A graphed cell under torch.profiler: ``train(p, callback)`` trains
    2 × P steps in chunks of P from a fresh flow, and the profiler covers
    the second chunk, P replays: kernels a step, device busy ms a step
    (the union of the kernels' intervals), the idle share of the window's
    wall time and the device time by category
    (`benchmarks/torch_profile.py`'s breakdown); with ``by_name`` also
    every kernel's (launches a step, device ms a step) by name."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    from torch_profile import _breakdown, _kernel_events

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    t0 = []

    def callback(it, stat, f):
        if not t0:  # after the first chunk: warm steps, capture
            torch.cuda.synchronize()
            prof.start()
            t0.append(time.perf_counter())

    train(p, callback)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0[0]
    prof.stop()
    r = _breakdown(prof, p, wall)
    if by_name:
        names = {}
        for e in _kernel_events(prof):
            row = names.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us()
        r["by_name"] = {k: (n / p, us / p / 1e3) for k, (n, us) in
                        names.items()}
    say(phase, f"{label}, {p} replays under the profiler: "
               f"{r['kernels_per_step']:.1f} kernels a step, device busy "
               f"{r['device_busy_ms_per_step']:.4f} ms of "
               f"{r['wall_ms_per_step']:.4f} ms a step (idle "
               f"{100 * r['device_idle_share']:.1f} %), by category "
               f"{r['ms_per_step_by_category']}, on {name}")
    return r


def phase_graph_profile(gen, name):
    """The graphed steps under torch.profiler (`profile_cell`). After
    every other phase, because a profiler run slows the host's launches
    after it."""
    import normalizingflows_torch as nft

    banana = nft.Banana(2, 1.0, 100.0)
    wide_banana = nft.Banana(WIDE["q0"], 1.0, 100.0)
    _, mle_rows, _ = _mle_data(gen, 2)
    _, mle_wide_rows, _ = _mle_data(gen, WIDE["q0"])

    def elbo(make, target, batch, lr):
        return lambda p, cb: nft.train_flow(
            gen, nft.elbo_batch, make(), target.log_prob, batch,
            max_iters=2 * p, check_every=p, callback=cb,
            optimizer=lambda q: torch.optim.Adam(q, lr=lr))

    def mle(rows, batch, make):
        return lambda p, cb: nft.train_flow_mle(
            make(), nft.utils.data.make_loader(rows, batch, seed=0),
            max_iters=2 * p, check_every=p, callback=cb,
            optimizer=lambda q: torch.optim.Adam(q, lr=MLE_LR))

    def wide_nsf():
        return nft.nsf(torch.Generator().manual_seed(3), **WIDE)

    cells = (
        ("demo", 50, elbo(_demo_flow, banana, DEMO_BATCH, DEMO_LR)),
        ("wide", 10, elbo(wide_nsf, wide_banana, WIDE_BATCH, WIDE_LR)),
        ("mle_demo", 50, mle(mle_rows, MLE_BATCH, _demo_flow)),
        ("mle_wide", 10, mle(mle_wide_rows, MLE_WIDE_BATCH, wide_nsf)),
        ("rnvp_demo", 100, elbo(lambda: _rnvp(RNVP_DEMO, 0, True), banana,
                                RNVP_BATCH, RNVP_LR)),
        ("rnvp_ref", 20, elbo(lambda: _rnvp(RNVP_REF, 50, True), banana,
                              RNVP_REF_BATCH, RNVP_LR)))
    return {label: profile_cell(26, label, p, train, name)
            for label, p, train in cells}


# ---------------------------------------------------------------------------
# The classic flows: planar, radial and Hamiltonian (no kernel of ours)
# ---------------------------------------------------------------------------

def _classic_cell(kind, dtype=torch.float64):
    """(make, logp, objective) of a classic demo: ``make()`` builds its
    flow on the card, the same weights at every call (seed 0)."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.models.hamiltonian import joint_logp

    if kind == "hamiltonian":
        funnel = nft.Funnel(2, -8.0, 5.0)
        return (lambda: nft.hamiltonian_flow(
                    2, funnel.score, HAM_BLOCKS, L=3, eps0=0.05, dtype=dtype,
                    device=DEVICE),
                joint_logp(funnel.log_prob, 2), nft.elbo)
    build, target = ((nft.planarflow, nft.Banana(2, 1.0, 10.0))
                     if kind == "planar"
                     else (nft.radialflow, nft.WarpedGauss(1.0, 0.12)))
    return (lambda: build(torch.Generator().manual_seed(0),
                          nft.DiagNormal.standard(2, dtype, DEVICE),
                          CLASSIC_LAYERS, dtype, DEVICE),
            target.log_prob, nft.elbo_batch)


def _elbo_of(flow, logp) -> float:
    """The ELBO from ELBO_DRAWS base draws of one seed (the same draws for
    every flow of a dimension: common random numbers for before/after)."""
    import normalizingflows_torch as nft

    with torch.no_grad():
        return float(nft.elbo_batch(
            torch.Generator(device=DEVICE).manual_seed(99), flow, logp,
            ELBO_DRAWS))


def phase_classic(phase, kind, name):
    """A classic demo (phases 27-29): ``CLASSIC[kind]``'s steps graphed,
    then eagerly, with no K1-K6 launch and one capture; the ELBO before
    and after beside the parity row's; graphed against eager on the same
    draws, which must give identical bits. Returns the cell (for
    `graph_cells`), and its ELBOs and a thunk that profiles it."""
    import normalizingflows_torch as nft

    cfg = CLASSIC[kind]
    make, logp, objective = _classic_cell(kind)

    def train(flow, graph, callback, steps=None, check_every=None,
              seed=phase):
        steps = steps or (cfg["steps"] if graph else cfg["eager"])
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(seed), objective,
            flow, logp, cfg["batch"], max_iters=steps,
            check_every=check_every or (100 if graph else cfg["eager"] // 2),
            callback=callback, graph=graph,
            optimizer=lambda p: torch.optim.Adam(p, lr=cfg["lr"]))

    before = _elbo_of(make(), logp)
    out = {"demo": _graph_and_eager(phase, f"{kind} demo", make, train,
                                    cfg["steps"], {}, name,
                                    eager_steps=cfg["eager"])}
    after = _elbo_of(out["demo"]["graph"]["flow"], logp)
    if not (math.isfinite(after) and after > before):
        raise AssertionError(f"phase {phase}, {kind} demo: the ELBO went "
                             f"{before} -> {after}")
    say(phase, f"{kind} demo: ELBO from {ELBO_DRAWS} draws {before:.4f} -> "
               f"{after:.4f} after {cfg['steps']} graphed steps; the parity "
               f"row (benchmarks/PARITY.md, the JAX package, "
               f"{cfg['parity_steps']} steps) {cfg['parity']}; no K1-K6 "
               f"launch on either path")
    reset_counts()
    out["identical"] = _same_inputs(
        phase, f"{kind} demo", make,
        _presampled_train(logp, cfg["batch"], cfg["lr"], SAME_STEPS),
        SAME_STEPS, strict=True)
    expect_counts(f"phase {phase}, {kind} demo on the same inputs")
    info = {"elbo_before": before, "elbo_after": after,
            "profile": lambda: profile_cell(
                phase, f"{kind} demo", cfg["profile"],
                lambda p, cb: train(make(), None, cb, 2 * p, p, seed=0),
                name)}
    return out, info


def phase_double_backward(name):
    """The Hamiltonian flow with Banana(2, 1, 10)'s autograd score, whose
    step takes a double backward: DOUBLE_STEPS steps graphed and eagerly on
    the same draws (identical bits), no K1-K6 launch, one capture. If the
    capture is refused, train_flow raises naming graph=False; the phase
    says so and runs that case with graph=False."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.models.hamiltonian import joint_logp
    from normalizingflows_torch.ops import launches

    banana = nft.Banana(2, 1.0, 10.0)
    cfg = CLASSIC["hamiltonian"]
    logp = joint_logp(banana.log_prob, 2)

    def make():
        return nft.hamiltonian_flow(2, banana.score, HAM_DOUBLE_BLOCKS, L=3,
                                    eps0=0.05, dtype=torch.float64,
                                    device=DEVICE)

    train = _presampled_train(logp, cfg["batch"], cfg["lr"], DOUBLE_STEPS)
    label = "Hamiltonian flow with Banana's autograd score"
    reset_counts()
    try:
        identical = _same_inputs(30, label, make, train, DOUBLE_STEPS,
                                 strict=True)
    except RuntimeError as err:
        if "graph=False" not in str(err):
            raise
        say(30, f"the graphed step with a double backward raised: {err}")
        reset_counts()
        losses = train(make(), False).stats["loss"]
        expect_counts("phase 30, eager")
        if not torch.isfinite(torch.from_numpy(losses)).all():
            raise AssertionError("phase 30: non-finite eager losses")
        say(30, f"{label}: ran {DOUBLE_STEPS} steps with graph=False, loss "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        return {"captured": False}
    captures = launches.captures()
    expect_counts("phase 30")
    if captures != 1:
        raise AssertionError(f"phase 30: {captures} captures, expected 1")
    say(30, f"{label}: the double backward captured (one capture), "
            f"identical bits graphed and eager: {identical}, no K1-K6 "
            f"launch")

    def profile_train(p, cb):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(0), nft.elbo, make(),
            logp, cfg["batch"], max_iters=2 * p, check_every=p, callback=cb,
            optimizer=lambda q: torch.optim.Adam(q, lr=cfg["lr"]))

    return {"captured": True, "identical": identical,
            "profile": lambda: profile_cell(30, label, 10, profile_train,
                                            name)}


def _round_trip(phase, kind, flow, gen):
    """T then T⁻¹ on ROWS base draws, with no K1-K6 launch: the JAX
    suite's criterion (tests/test_flows.py), |x - T^-1(T(x))| <= rtol *
    max(max|x|, 1) and the log-dets alike, rtol CLASSIC_ROUND_TRIP of the
    flow's dtype."""
    dtype = next(flow.parameters()).dtype
    reset_counts()
    with torch.no_grad():
        x = flow.base.sample(gen, (ROWS,))
        y, ld = flow.bijector.forward_and_log_det(x)
        back, ild = flow.bijector.inverse_and_log_det(y)
    expect_counts(f"phase {phase}, {kind} round trip")
    rtol = CLASSIC_ROUND_TRIP[dtype]
    err = float((back - x).abs().max())
    bound = rtol * max(float(x.abs().max()), 1.0)
    ld_err = float((ld + ild).abs().max())
    ld_bound = rtol * max(float(ld.abs().max()), 1.0)
    say(phase, f"{kind} round trip, {ROWS} rows, {dtype}: max |x - "
               f"T^-1(T(x))| {err:.3e} (bound {bound:.3e}), max |ld + "
               f"ld_inv| {ld_err:.3e} (bound {ld_bound:.3e})")
    if not (err <= bound and ld_err <= ld_bound):
        raise AssertionError(f"phase {phase}: {kind} {dtype} round trip "
                             "outside its bound")
    return {"round_trip_err": err, "round_trip_bound": bound}


def phase_classic_round_trip(trained, name):
    """The planar and radial demo flows phases 27 and 28 trained
    (``trained``: kind -> flow) on the card at ROWS rows: the round trip
    through the root solver in float64 and cast to float32 (the JAX
    suite's criterion), and log_prob with its gradient against the same
    float64 flow on the CPU. No K1-K6 launch."""
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    for kind, trained_flow in trained.items():
        for dtype in (torch.float32, torch.float64):
            _round_trip(31, kind, copy.deepcopy(trained_flow).to(dtype), gen)
        flow = copy.deepcopy(trained_flow)
        flow.zero_grad(set_to_none=True)  # the training's last gradients
        cpu = copy.deepcopy(flow).to("cpu")
        with torch.no_grad():
            y = flow.sample(gen, (ROWS,))
        reset_counts()
        lp = flow.log_prob(y)
        lp.mean().backward()
        expect_counts(f"phase 31, {kind} log_prob")
        lp_cpu = cpu.log_prob(y.cpu())
        lp_cpu.mean().backward()
        e = compare(f"{kind} log_prob, card vs CPU (float64)", lp.cpu(),
                    lp_cpu, CPU_TOL)
        # the trainable parameters: the demo froze the base
        eg = max(compare(f"{kind} d log_prob / d {n}", p.grad.cpu(),
                         q.grad, CPU_TOL, quiet=True)
                 for (n, p), q in zip(flow.named_parameters(),
                                      cpu.parameters()) if p.requires_grad)
        say(31, f"{kind}: log_prob of {ROWS} rows and its gradient through "
                f"the inverse on the card against the CPU, float64: max abs "
                f"err {e:.3e} / {eg:.3e} (rtol {CPU_TOL[0]}, atol "
                f"{CPU_TOL[1]}), on {name}")


# ---------------------------------------------------------------------------
# The rest of the flow zoo: NSF's affine envelope and selective remat (K1,
# K2/K3 under them), then Glow, IAF and MAF (no kernel of ours)
# ---------------------------------------------------------------------------

def _diagnose(phase, label, flow, logp) -> dict:
    """`evaluate_flow` from ELBO_DRAWS draws of one seed (the same draws
    for every flow of a dimension): ELBO ± SEM, log Ẑ and ESS/n, finite."""
    import normalizingflows_torch as nft

    with torch.no_grad():
        d = nft.evaluate_flow(torch.Generator(device=DEVICE).manual_seed(99),
                              flow, logp, ELBO_DRAWS)
    out = {"elbo": float(d.elbo), "elbo_sem": float(d.elbo_sem),
           "log_normalizer": float(d.log_normalizer),
           "ess_per_n": float(d.ess)}
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"phase {phase}, {label}: diagnostics {out}")
    say(phase, f"{label}: evaluate_flow from {ELBO_DRAWS} draws: ELBO "
               f"{out['elbo']:.4f} ± {out['elbo_sem']:.4f} (SEM), log Z "
               f"estimate {out['log_normalizer']:.4f}, ESS/n "
               f"{out['ess_per_n']:.4f}")
    return out


def phase_nsf_wrap(gen, name):
    """Phase 32: nsf_banana_hard's model, `nsf(affine_wrap=True)` (an
    ActNorm each side of the spline stack), graphed WRAP_STEPS steps and
    eagerly WRAP_EAGER, K1 and K2 20 a step; `evaluate_flow` before and
    after; graphed against eager on the same draws, identical bits.
    Returns the cell and its numbers."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    per_step = dict.fromkeys(("rqs_fwd", "rqs_bwd_fwddir"),
                             2 * NSF_WRAP["nlayers"])

    def make():
        return nft.nsf(torch.Generator().manual_seed(0), **NSF_WRAP)

    def train(flow, graph, callback, steps=None, check_every=None):
        return nft.train_flow(
            gen, nft.elbo_batch, flow, target.log_prob, DEMO_BATCH,
            max_iters=steps or (WRAP_STEPS if graph else WRAP_EAGER),
            check_every=check_every or (100 if graph else WRAP_EAGER // 2),
            callback=callback, graph=graph,
            optimizer=lambda p: torch.optim.Adam(p, lr=DEMO_LR))

    before = _diagnose(32, "nsf_banana_hard at init", make(),
                       target.log_prob)
    out = {"nsf_wrap": _graph_and_eager(32, "nsf_banana_hard", make, train,
                                        WRAP_STEPS, per_step, name,
                                        eager_steps=WRAP_EAGER)}
    after = _diagnose(32, f"nsf_banana_hard after {WRAP_STEPS} graphed "
                          "steps", out["nsf_wrap"]["graph"]["flow"],
                      target.log_prob)
    if not after["elbo"] > before["elbo"]:
        raise AssertionError(f"phase 32: the ELBO went {before['elbo']} -> "
                             f"{after['elbo']}")
    say(32, "no parity claim: the parity row (benchmarks/PARITY.md, "
            "-0.2163 at 50,000 steps) trains with a warmup-cosine schedule")
    out["identical"] = _same_inputs(
        32, "nsf_banana_hard", make,
        _presampled_train(target.log_prob, DEMO_BATCH, DEMO_LR, SAME_STEPS),
        SAME_STEPS, strict=True)
    return out, {"cell": "nsf_wrap",
                 "numbers": {"before": before, "after": after},
                 "profile": lambda: profile_cell(
                     32, "nsf_banana_hard", 50,
                     lambda p, cb: train(make(), None, cb, 2 * p, p), name)}


def phase_nsf_wide_remat(name):
    """Phase 33: NSF wide with and without the selective remat, WIDE_STEPS
    steps each graphed and eagerly on the same draws and weights (Adam
    with capturable=True): K1 and K2 20 a step in all four runs (remat
    never runs K1 again), graphed against eager identical bits, remat
    against no remat within GRAPH_TOL (its bits reported), peak memory
    and steps/s of each; then steps/s of each in turns."""
    import normalizingflows_torch as nft

    target = nft.Banana(WIDE["q0"], 1.0, 100.0)
    per_step = dict.fromkeys(("rqs_fwd", "rqs_bwd_fwddir"),
                             2 * WIDE["nlayers"])

    def train(flow, graph, callback):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(33),
            nft.elbo_from_samples, flow, target.log_prob,
            max_iters=WIDE_STEPS, check_every=WIDE_STEPS // 2,
            callback=callback, scan_inputs=nft.presample_base(WIDE_BATCH),
            optimizer=lambda p: torch.optim.Adam(p, lr=WIDE_LR,
                                                 capturable=True),
            graph=graph)

    out, runs = {}, {}
    for remat in (False, True):
        cell = "nsf_wide_remat" if remat else "nsf_wide"
        out[cell] = _graph_and_eager(
            33, f"NSF wide, remat={remat}",
            lambda: nft.nsf(torch.Generator().manual_seed(3), remat=remat,
                            **WIDE), train, WIDE_STEPS, per_step, name)
        runs[cell] = {path: _outcome(r["res"], r["flow"])
                      for path, r in out[cell].items()}
        _agree(33, f"NSF wide, remat={remat}", runs[cell]["graph"],
               runs[cell]["eager"], strict=True)
    out["identical"] = True
    remat_same = _agree(33, "NSF wide", runs["nsf_wide_remat"]["graph"],
                        runs["nsf_wide"]["graph"], what="remat against no "
                        "remat, graphed")
    # steps/s of the default graphed run (elbo_batch, the generator's
    # draws), RATE_RUNS runs in turns: no remat, remat, remat, no remat
    rates = {False: [], True: []}
    for remat in (False, True, True, False):
        flow = nft.nsf(torch.Generator().manual_seed(3), remat=remat, **WIDE)
        reset_counts()
        _, _, steady = _stamped(lambda cb: nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(35), nft.elbo_batch,
            flow, target.log_prob, WIDE_BATCH, max_iters=3 * RATE_CHUNK,
            check_every=RATE_CHUNK, callback=cb,
            optimizer=lambda p: torch.optim.Adam(p, lr=WIDE_LR)))
        expect_counts(f"phase 33, remat={remat}, timed",
                      **{k: n * 3 * RATE_CHUNK for k, n in per_step.items()})
        rates[remat].append(steady)
    say(33, f"NSF wide, graphed, steps/s over chunks 2-3 of {RATE_CHUNK} "
            f"steps, in turns (no remat, remat, remat, no remat): no remat "
            f"{rates[False][0]:.1f}, {rates[False][1]:.1f}; remat "
            f"{rates[True][0]:.1f}, {rates[True][1]:.1f}, on {name}")
    peak = {cell: {path: out[cell][path]["peak_mib"]
                   for path in ("graph", "eager")}
            for cell in ("nsf_wide", "nsf_wide_remat")}
    say(33, f"NSF wide, {WIDE_STEPS} steps, batch {WIDE_BATCH}: peak "
            f"allocated MiB graph / eager: no remat "
            f"{peak['nsf_wide']['graph']:.1f} / "
            f"{peak['nsf_wide']['eager']:.1f}, remat "
            f"{peak['nsf_wide_remat']['graph']:.1f} / "
            f"{peak['nsf_wide_remat']['eager']:.1f}; steps/s after the "
            f"first chunk graph / eager: no remat "
            f"{out['nsf_wide']['graph']['steady']:.1f} / "
            f"{out['nsf_wide']['eager']['steady']:.1f}, remat "
            f"{out['nsf_wide_remat']['graph']['steady']:.1f} / "
            f"{out['nsf_wide_remat']['eager']['steady']:.1f}, on {name}")
    return out, {"cell": "nsf_wide_remat",
                 "numbers": {"remat_identical_bits": remat_same,
                             "graph_steady_in_turns": {
                                 "no_remat": rates[False],
                                 "remat": rates[True]}},
                 "profile": lambda: profile_cell(
                     33, "NSF wide, remat", 10,
                     lambda p, cb: _profiled_wide_remat(target, p, cb),
                     name)}


def _profiled_wide_remat(target, p, callback):
    import normalizingflows_torch as nft

    return nft.train_flow(
        torch.Generator(device=DEVICE).manual_seed(34), nft.elbo_batch,
        nft.nsf(torch.Generator().manual_seed(3), remat=True, **WIDE),
        target.log_prob, WIDE_BATCH, max_iters=2 * p, check_every=p,
        callback=callback,
        optimizer=lambda q: torch.optim.Adam(q, lr=WIDE_LR))


def phase_nsf_mle_remat(gen, name):
    """Phase 34: `train_flow_mle` on the MLE demo with remat=True,
    MLE_REMAT_STEPS steps graphed and eagerly: K1 (inverse) and K3 20 a
    step, no K2; graphed against eager on the same batches, identical
    bits; remat against no remat on the same batches within GRAPH_TOL."""
    import normalizingflows_torch as nft

    target, rows, held = _mle_data(gen, 2)
    per_step = dict.fromkeys(("rqs_fwd", "rqs_bwd_invdir"),
                             2 * DEMO["nlayers"])

    def make(remat=True):
        return nft.nsf(torch.Generator().manual_seed(0), remat=remat,
                       **DEMO)

    def train(flow, graph, callback=None, steps=MLE_REMAT_STEPS,
              check_every=MLE_REMAT_STEPS // 2, capturable=False):
        return nft.train_flow_mle(
            flow, nft.utils.data.make_loader(rows, MLE_BATCH, seed=0),
            max_iters=steps, check_every=check_every, callback=callback,
            optimizer=lambda p: torch.optim.Adam(p, lr=MLE_LR,
                                                 capturable=capturable),
            graph=graph)

    with torch.no_grad():
        before = float(make().log_prob(held).mean())
    out = {"nsf_mle_remat": _graph_and_eager(34, "MLE demo, remat", make,
                                             train, MLE_REMAT_STEPS,
                                             per_step, name)}
    with torch.no_grad():
        after = float(out["nsf_mle_remat"]["graph"]["flow"].log_prob(
            held).mean())
    if not after > before:
        raise AssertionError(f"phase 34: held-out log-likelihood {before} "
                             f"-> {after}")
    say(34, f"MLE demo, remat: held-out mean log-likelihood {before:.4f} "
            f"-> {after:.4f} in {MLE_REMAT_STEPS} graphed steps")

    def same(flow, graph):
        return train(flow, graph, steps=SAME_STEPS, check_every=SAME_CHECK,
                     capturable=True)

    out["identical"] = _same_inputs(34, "MLE demo, remat", make, same,
                                    SAME_STEPS, strict=True)
    runs = {}
    for remat in (True, False):
        flow = make(remat)
        runs[remat] = _outcome(same(flow, True), flow)
    remat_same = _agree(34, "MLE demo", runs[True], runs[False],
                        what="remat against no remat, graphed")
    return out, {"cell": "nsf_mle_remat",
                 "numbers": {"held_out_before": before,
                             "held_out_after": after,
                             "remat_identical_bits": remat_same}}


def phase_zoo(phase, kind, gen, name):
    """Phases 35-37: the glow, iaf and maf demos (ZOO[kind]), graphed and
    then eagerly, with no K1-K6 launch and one capture; the quality before
    and after (`evaluate_flow`; maf: the held-out log-likelihood beside
    the target's E_p[log p]), which must rise; graphed against eager on
    the same inputs, identical bits; the trained flow's round trip at ROWS
    rows (glow: the triangular solves; iaf and maf: the sequential
    direction). Returns the cell and its numbers."""
    import normalizingflows_torch as nft

    cfg = ZOO[kind]
    gen_seed = torch.Generator().manual_seed
    if kind == "glow":
        target = nft.Cross(device=DEVICE)

        def make():
            flow = nft.glow(gen_seed(0), 2, (32, 32), nlayers=6,
                            device=DEVICE)
            return nft.glow_init_actnorms(flow, flow.base.sample(
                torch.Generator(device=DEVICE).manual_seed(1),
                (GLOW_INIT_ROWS,)))
    else:
        if kind == "iaf":
            target = nft.Banana(2, 1.0, 10.0)
        else:
            target, rows, held = _mle_data(gen, 2)
        build = nft.iaf if kind == "iaf" else nft.maf

        def make():
            return build(gen_seed(0), 2, (32, 32), nlayers=5, device=DEVICE)

    def train(flow, graph, callback=None, steps=None, check_every=None,
              capturable=False, seed=phase):
        steps = steps or (cfg["steps"] if graph else cfg["eager"])
        check_every = check_every or (100 if graph else cfg["eager"] // 2)

        def adam(p):
            return torch.optim.Adam(p, lr=cfg["lr"], capturable=capturable)

        if kind == "maf":
            return nft.train_flow_mle(
                flow, nft.utils.data.make_loader(rows, cfg["batch"], seed=0),
                max_iters=steps, check_every=check_every, callback=callback,
                optimizer=adam, graph=graph)
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(seed), nft.elbo_batch,
            flow, target.log_prob, cfg["batch"], max_iters=steps,
            check_every=check_every, callback=callback, optimizer=adam,
            graph=graph)

    numbers = {"before": _diagnose(phase, f"{kind} demo at init", make(),
                                   target.log_prob)}
    if kind == "maf":
        with torch.no_grad():
            numbers["held_out_before"] = float(make().log_prob(held).mean())
            numbers["ceiling"] = float(target.log_prob(held).mean())
    out = {kind: _graph_and_eager(phase, f"{kind} demo", make, train,
                                  cfg["steps"], {}, name,
                                  eager_steps=cfg["eager"])}
    trained = out[kind]["graph"]["flow"]
    numbers["after"] = _diagnose(
        phase, f"{kind} demo after {cfg['steps']} graphed steps", trained,
        target.log_prob)
    if kind == "maf":
        with torch.no_grad():
            numbers["held_out_after"] = float(trained.log_prob(held).mean())
        rise = (numbers["held_out_before"], numbers["held_out_after"])
        say(phase, f"maf demo: held-out mean log-likelihood {rise[0]:.4f} "
                   f"-> {rise[1]:.4f} (the target's E_p[log p] "
                   f"{numbers['ceiling']:.4f}; the parity row "
                   f"{cfg['parity']} at {cfg['parity_steps']} steps)")
    else:
        rise = (numbers["before"]["elbo"], numbers["after"]["elbo"])
        say(phase, f"{kind} demo: ELBO {rise[0]:.4f} -> {rise[1]:.4f} (the "
                   f"parity row {cfg['parity']} at {cfg['parity_steps']} "
                   "steps; other draws and init, no parity claim)")
    if not rise[1] > rise[0]:
        raise AssertionError(f"phase {phase}, {kind} demo: {rise[0]} -> "
                             f"{rise[1]}")
    reset_counts()

    def same(flow, graph):  # the MLE batches: the loader's, seed 0
        return train(flow, graph, steps=SAME_STEPS, check_every=SAME_CHECK,
                     capturable=True)

    if kind != "maf":
        same = _presampled_train(target.log_prob, cfg["batch"], cfg["lr"],
                                 SAME_STEPS)
    out["identical"] = _same_inputs(phase, f"{kind} demo", make, same,
                                    SAME_STEPS, strict=True)
    expect_counts(f"phase {phase}, {kind} demo on the same inputs")
    sample_gen = torch.Generator(device=DEVICE).manual_seed(phase)
    numbers.update(_round_trip(phase, f"{kind} demo", trained, sample_gen))
    if kind == "maf":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            ys = trained.sample(sample_gen, (ROWS,))
        torch.cuda.synchronize()
        numbers["sample_s"] = time.perf_counter() - t0
        if ys.shape != (ROWS, 2) or not torch.isfinite(ys).all():
            raise AssertionError(f"phase 37: maf samples {tuple(ys.shape)}")
        expect_counts("phase 37, maf sample")
        say(37, f"maf sample (the sequential direction, 2 masked passes a "
                f"layer): {ROWS} rows in {numbers['sample_s']:.4f} s, "
                f"finite, no K1-K6 launch")
    return out, {"cell": kind, "numbers": numbers,
                 "profile": lambda: profile_cell(
                     phase, f"{kind} demo", cfg["profile"],
                     lambda p, cb: train(make(), None, cb, 2 * p, p, seed=0),
                     name)}


# ---------------------------------------------------------------------------
# The experiment path: configs from JSON, checkpoints with an exact resume,
# the native prefetching loader into page-locked buffers, the profiling
# utilities, SGD under the graph
# ---------------------------------------------------------------------------


def _exp_dir() -> Path:
    """Where phases 38-41 write their checkpoints, raw data and trace: a
    directory of the checkout that .gitignore lists."""
    d = Path(__file__).resolve().parent / EXP_DIR
    d.mkdir(parents=True, exist_ok=True)
    return d


def _nsf_wide_config(objective, **kw):
    """The NSF wide shape (phase 6's, benchmarks/roofline.py:245-258) as a
    TrainConfig, through config_from_json(config_to_json(...)). The
    config's nsf has the constructor's default init (random weights, as
    the JAX package's FlowConfig builds it)."""
    import normalizingflows_torch as nft

    cfg = nft.TrainConfig(
        flow=nft.FlowConfig(family="nsf", dim=WIDE["q0"],
                            hdims=WIDE["hdims"], nlayers=WIDE["nlayers"],
                            K=WIDE["K"], B=WIDE["B"]),
        objective=objective, **kw)
    text = nft.config_to_json(cfg)
    back = nft.config_from_json(text)
    if back != cfg:
        raise AssertionError(f"the config's JSON round trip changed it: "
                             f"{back} != {cfg}")
    return back, text


def _chunk_times(train):
    """``train(callback)``: (result, first chunk ms, mean ms of the chunks
    after it), each chunk ending at its losses' fetch."""
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train(lambda it, stat, f: stamps.append(time.perf_counter()))
    later = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    return res, 1e3 * (stamps[0] - t0), (statistics.mean(later) if later
                                         else float("nan"))


def _adam_tensors(opt):
    """An optimizer's per-parameter state as (name, tensor) pairs."""
    return [(k, v) for s in opt.state_dict()["state"].values()
            for k, v in sorted(s.items())]


def phase_exp_resume(name):
    """Phase 38: the NSF wide configuration from JSON, graphed EXP_STEPS
    steps in chunks of EXP_CHECK, against EXP_STEPS/2 steps →
    save_train_state → a fresh flow, optimizer and generator from the same
    JSON → load_train_state → EXP_STEPS/2 steps: identical bits in the
    losses, the parameters, the Adam state and the generator. K1 = K2 = 20
    a step by replay in each run. The generator after EXP_STEPS/2 graphed
    steps against EXP_STEPS/2 eager steps; the checkpoint's size, save and
    load times; the resumed run's first chunk against the later ones,
    over RESUMES resumes from the one checkpoint."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import launches
    from normalizingflows_torch.train import TrainState
    from normalizingflows_torch.utils import checkpoint
    from normalizingflows_torch.utils.pytree import trainable_parameters

    cfg, text = _nsf_wide_config(
        "elbo_batch", optimizer=nft.OptimizerConfig(learning_rate=WIDE_LR),
        max_iters=EXP_STEPS, n_samples=WIDE_BATCH, check_every=EXP_CHECK,
        seed=38)
    target = nft.Banana(WIDE["q0"], 1.0, 100.0)
    half = EXP_STEPS // 2
    per_step = 2 * WIDE["nlayers"]
    out = {}

    def run(label, steps, *, generator, graph=None, **kw):
        reset_counts()
        res, first, later = _chunk_times(lambda cb: cfg.run(
            target.log_prob, generator=generator, max_iters=steps,
            callback=cb, graph=graph, **kw))
        if graph is None:
            expect_counts(f"phase 38, {label}", rqs_fwd=per_step * steps,
                          rqs_bwd_fwddir=per_step * steps)
            if launches.captures() != 1:
                raise AssertionError(f"phase 38, {label}: "
                                     f"{launches.captures()} captures")
        losses = res.stats["loss"]
        if len(losses) != steps or not torch.isfinite(
                torch.from_numpy(losses)).all():
            raise AssertionError(f"phase 38, {label}: non-finite losses")
        out[label] = dict(first_chunk_ms=first, later_chunk_ms=later,
                          counts=all_counts())
        return res

    _, gen_a = cfg.generators()
    res_a = run("straight", EXP_STEPS, generator=gen_a)
    _, gen_b = cfg.generators()
    res_b1 = run("first half", half, generator=gen_b)
    path = _exp_dir() / "nsf_wide_state.pt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_train_state(str(path), res_b1.state, generator=gen_b)
    save_ms = 1e3 * (time.perf_counter() - t0)
    size = path.stat().st_size
    n_params = sum(p.numel() for p in res_b1.flow.parameters())

    def resume(label):
        """A fresh flow, Adam and generator from the JSON, the checkpoint
        loaded into them (timed), then `half` steps."""
        cfg2 = nft.config_from_json(text)
        flow = cfg2.flow.build(torch.Generator().manual_seed(999))
        opt = cfg2.optimizer.build()(trainable_parameters(flow,
                                                          cfg2.train_base))
        _, gen = cfg2.generators()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = checkpoint.load_train_state(
            str(path), TrainState(flow, opt, 0), generator=gen)
        torch.cuda.synchronize()
        load_ms.append(1e3 * (time.perf_counter() - t0))
        if state.iteration != half:
            raise AssertionError(f"phase 38: resumed at {state.iteration}")
        res = run(label, half, generator=gen, resume_state=state)
        resumed_ms.append(out[label]["first_chunk_ms"])
        return res, flow, opt, gen

    load_ms, resumed_ms = [], []
    res_b2, flow, opt, gen_c = resume("resumed")
    same_loss = bool(np.array_equal(
        np.concatenate([res_b1.stats["loss"], res_b2.stats["loss"]]),
        res_a.stats["loss"]))
    same_params = all(torch.equal(a, b) for a, b in zip(
        res_a.flow.state_dict().values(), flow.state_dict().values()))
    adam_a, adam_c = _adam_tensors(res_a.state.opt_state), _adam_tensors(opt)
    same_adam = len(adam_a) == len(adam_c) and all(
        ka == kc and torch.equal(a, c)
        for (ka, a), (kc, c) in zip(adam_a, adam_c))
    same_gen = torch.equal(gen_a.get_state(), gen_c.get_state())
    say(38, f"NSF wide from JSON, {EXP_STEPS} graphed steps against {half} "
            f"→ save_train_state → fresh flow, Adam and generator from the "
            f"JSON → load_train_state → {half}: identical bits: losses "
            f"{same_loss}, parameters {same_params}, Adam state "
            f"{same_adam}, generator {same_gen}; K1 = K2 = {per_step} a step "
            f"by replay in all three runs")
    if not (same_loss and same_params and same_adam and same_gen):
        raise AssertionError("phase 38: the resumed run left the "
                             "uninterrupted run's trajectory")
    # the resume again, timed: each must give the first resume's bits
    for i in range(1, RESUMES):
        again = resume(f"resumed {i}")[0].stats["loss"]
        if not np.array_equal(again, res_b2.stats["loss"]):
            raise AssertionError(f"phase 38: resume {i} differs")
    # the generator after `half` graphed steps (3 eager, replays) against
    # `half` eager ones from the same seed
    _, gen_e = cfg.generators()
    run("eager half", half, generator=gen_e, graph=False)
    _, gen_b = cfg.generators()
    gen_b.set_state(torch.load(path, weights_only=True)["generator"])
    if not torch.equal(gen_e.get_state(), gen_b.get_state()):
        raise AssertionError("phase 38: the generator's state after "
                             f"{half} replayed steps differs from {half} "
                             "eager steps'")
    numbers = dict(
        checkpoint_bytes=size, n_params=n_params, save_ms=save_ms,
        load_ms=load_ms,
        straight_first_chunk_ms=out["straight"]["first_chunk_ms"],
        straight_later_chunk_ms=out["straight"]["later_chunk_ms"],
        resumed_first_chunk_ms=resumed_ms,
        resumed_later_chunk_ms=out["resumed"]["later_chunk_ms"],
        identical_bits=True)
    say(38, f"checkpoint {size / 1e6:.3f} MB ({n_params} parameters and "
            f"both Adam moments), save {save_ms:.1f} ms, load "
            f"{', '.join(f'{t:.1f}' for t in load_ms)} ms ({RESUMES} "
            f"resumes); chunks of {EXP_CHECK} steps: straight run first "
            f"{numbers['straight_first_chunk_ms']:.1f} ms, later "
            f"{numbers['straight_later_chunk_ms']:.1f} ms; resumed runs "
            f"first {', '.join(f'{t:.1f}' for t in resumed_ms)} ms (3 "
            f"eager steps and the capture), later "
            f"{numbers['resumed_later_chunk_ms']:.1f} ms; the generator "
            f"after {half} replayed steps equals {half} eager steps', on "
            f"{name}")
    return numbers, out["straight"]["counts"]


def phase_exp_fused(gen, name):
    """Phase 39: FlowConfig(family="realnvp", fused=True) at the demo
    shape from JSON, RNVP_STEPS graphed steps, one K4 and one K5 a step;
    save_pytree → a flow of another seed → load_pytree: sampling at
    SAMPLE_BATCH from one seed gives identical bits."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.utils import checkpoint

    cfg = nft.config_from_json(nft.config_to_json(nft.TrainConfig(
        flow=nft.FlowConfig(family="realnvp", dim=RNVP_DEMO["q0"],
                            hdims=RNVP_DEMO["hdims"],
                            nlayers=RNVP_DEMO["nlayers"], fused=True),
        optimizer=nft.OptimizerConfig(learning_rate=RNVP_LR),
        max_iters=RNVP_STEPS, n_samples=RNVP_BATCH, check_every=100,
        seed=39)))
    target = nft.Banana(2, 1.0, 100.0)
    reset_counts()
    res, dt, steady = _stamped(lambda cb: cfg.run(target.log_prob,
                                                  callback=cb))
    counts = expect_counts("phase 39", coupling_fwd=RNVP_STEPS,
                           coupling_bwd=RNVP_STEPS)
    losses = res.stats["loss"]
    if not (np.isfinite(losses).all()
            and losses[-100:].mean() < losses[:100].mean()):
        raise AssertionError(f"phase 39: the loss went {losses[:100].mean()}"
                             f" -> {losses[-100:].mean()}")
    path = _exp_dir() / "rnvp_flow.pt"
    checkpoint.save_pytree(str(path), res.flow)
    other = checkpoint.load_pytree(str(path), cfg.flow.build(
        torch.Generator().manual_seed(1)))
    with torch.no_grad():
        draws = [f.sample_and_log_prob(torch.Generator(
            device=DEVICE).manual_seed(5), (SAMPLE_BATCH,))
            for f in (res.flow, other)]
    same = all(torch.equal(a, b) for a, b in zip(*draws))
    say(39, f"fused RealNVP demo from JSON: {RNVP_STEPS} graphed steps, "
            f"{steady:.1f} steps/s after the first chunk "
            f"({RNVP_STEPS / dt:.1f} overall), loss {losses[:100].mean():.3f} -> "
            f"{losses[-100:].mean():.3f} (means of 100), K4 and K5 one a "
            f"step ({counts['coupling_fwd']}, {counts['coupling_bwd']}); "
            f"save_pytree/load_pytree: {SAMPLE_BATCH} samples and "
            f"log-densities identical bits {same}, on {name}")
    if not same:
        raise AssertionError("phase 39: the loaded flow samples otherwise")
    return dict(steady=steady, steps_per_s=RNVP_STEPS / dt,
                identical_bits=same), counts


def _loader_times(loader, buf, dev) -> dict:
    """Median ms, over LOADER_CHUNKS chunks, of ``loader`` writing a
    chunk into ``buf`` and of its copy to ``dev`` (non_blocking, then a
    sync: asynchronous only from a page-locked buffer)."""
    fill, copy_ = [], []
    for _ in range(LOADER_CHUNKS):
        t0 = time.perf_counter()
        loader.next_batches(len(buf), out=buf)
        t1 = time.perf_counter()
        dev.copy_(buf, non_blocking=True)
        torch.cuda.synchronize()
        fill.append(1e3 * (t1 - t0))
        copy_.append(1e3 * (time.perf_counter() - t1))
    return {"fill_ms": statistics.median(fill),
            "copy_ms": statistics.median(copy_)}


def phase_exp_mle_raw(gen, name):
    """Phase 40: MLE wide from a raw float32 file of MLE_ROWS exact draws
    of Banana(64, 1, 10) through TrainConfig(objective="mle",
    data_path=...), MLE_WIDE_STEPS steps in chunks of EXP_CHECK: K1
    (inverse) and K3 20 a step; the batches that reached the card equal
    the same seed's NativeLoader batches read on the host; then a chunk's
    host time in the loader and the copy, NativeLoader against
    NumpyLoader and page-locked against pageable, against the chunk's
    device time."""
    import normalizingflows_torch as nft
    from normalizingflows_torch import train as train_mod
    from normalizingflows_torch.utils import data

    dim = WIDE["q0"]
    rows = nft.Banana(dim, 1.0, 10.0).sample(gen, (MLE_ROWS,)).cpu().numpy()
    raw = data.to_raw_file(str(_exp_dir() / "banana64.f32"), rows)
    cfg, _ = _nsf_wide_config(
        "mle", optimizer=nft.OptimizerConfig(learning_rate=MLE_LR),
        max_iters=MLE_WIDE_STEPS, check_every=EXP_CHECK, data_path=raw,
        batch_size=MLE_WIDE_BATCH, seed=40)

    # a spy on the step runner: what each chunk left in the card's input
    # buffer, and CUDA events around each chunk (its copy and its steps)
    seen, events, run = [], [], train_mod._Steps.run

    def spy(steps, chunk, inputs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        r = run(steps, chunk, inputs)
        stop.record()
        seen.append(steps.inputs[:chunk].clone())
        events.append((start, stop))
        return r

    train_mod._Steps.run = spy
    reset_counts()
    try:
        res, first, later = _chunk_times(lambda cb: cfg.run(callback=cb))
    finally:
        train_mod._Steps.run = run
    per_step = 2 * WIDE["nlayers"]
    counts = expect_counts("phase 40", rqs_fwd=per_step * MLE_WIDE_STEPS,
                           rqs_bwd_invdir=per_step * MLE_WIDE_STEPS)
    losses = res.stats["loss"]
    if not np.isfinite(losses).all():
        raise AssertionError("phase 40: non-finite losses")
    host = data.NativeLoader(raw, MLE_ROWS, dim, MLE_WIDE_BATCH, seed=40)
    want = host.next_batches(MLE_WIDE_STEPS)
    host.close()
    same = torch.equal(torch.cat(seen).cpu(), torch.from_numpy(want))
    mb = Path(raw).stat().st_size / 1e6
    say(40, f"MLE wide from a raw float32 file ({mb:.1f} MB, {MLE_ROWS} "
            f"rows of {dim}) through TrainConfig: "
            f"{MLE_WIDE_STEPS} graphed steps, loss {losses[0]:.2f} -> "
            f"{losses[-1]:.2f}, K1 (inverse) and K3 {per_step} a step "
            f"({counts['rqs_fwd']}, {counts['rqs_bwd_invdir']}); the "
            f"batches on the card equal the same seed's NativeLoader "
            f"batches read on the host: {same}")
    if not same:
        raise AssertionError("phase 40: the card trained on other batches")
    torch.cuda.synchronize()
    device_ms = [s.elapsed_time(e) for s, e in events]
    shape = (EXP_CHECK, MLE_WIDE_BATCH, dim)
    dev = torch.empty(shape, device=DEVICE)
    bufs = {"pinned": torch.empty(shape, pin_memory=True),
            "pageable": torch.empty(shape)}
    loaders = {"native": data.NativeLoader(raw, MLE_ROWS, dim,
                                           MLE_WIDE_BATCH, seed=1),
               "numpy": data.NumpyLoader(rows, MLE_WIDE_BATCH, seed=1)}
    times = {f"{lk}_{bk}": _loader_times(loader, buf, dev)
             for lk, loader in loaders.items() for bk, buf in bufs.items()}
    loaders["native"].close()
    chunk_ms = device_ms[-1]
    mb = math.prod(shape) * 4 / 1e6
    say(40, f"a chunk of {EXP_CHECK} batches ({mb:.1f} MB): device time (CUDA events around its copy and "
            f"steps) first {device_ms[0]:.2f} ms, then {chunk_ms:.2f} ms; "
            f"host ms to fill / copy, median of {LOADER_CHUNKS}: "
            + ", ".join(f"{k} {v['fill_ms']:.2f} / {v['copy_ms']:.2f}"
                        for k, v in times.items())
            + f"; the training run's chunks (host clock): first "
            f"{first:.1f} ms, then {later:.1f} ms, on {name}")
    return dict(chunk_device_ms=device_ms, chunk_host_ms=[first, later],
                loader_ms=times, batches_equal=same), counts


def phase_exp_profiling(gen, name, graphed_rate=None):
    """Phase 41: `utils.profiling`: `time_scan_steps` (the slope between
    SCAN_STEPS and twice as many steps, each call a graphed `train_flow`
    run ending in its losses' fetch) on the NSF demo, beside phase 22's
    graphed steps/s (``graphed_rate``, where it ran); `trace` around 20
    graphed steps writes a Chrome trace that holds the card's kernels."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.utils import profiling

    target = nft.Banana(2, 1.0, 100.0)
    flow = _demo_flow()
    state = [None]

    def run_steps(m):
        res = nft.train_flow(
            gen, nft.elbo_batch, flow, target.log_prob, DEMO_BATCH,
            max_iters=m, check_every=m, resume_state=state[0],
            optimizer=lambda p: torch.optim.Adam(p, lr=DEMO_LR))
        state[0] = res.state
        return res.stats["loss"][-1:]

    per_step = profiling.time_scan_steps(run_steps, n=SCAN_STEPS, reps=3)
    d = _exp_dir() / "trace"
    shutil.rmtree(d, ignore_errors=True)
    with profiling.trace(str(d)) as prof:
        run_steps(20)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    from torch_profile import _kernel_events

    files = [f for f in d.iterdir() if f.is_file()]
    kernels = _kernel_events(prof)
    rqs = sum(1 for e in kernels if "rqs_" in e.name)
    kernels = len(kernels)
    size = files[0].stat().st_size if len(files) == 1 else 0
    say(41, f"time_scan_steps on the graphed NSF demo step ({SCAN_STEPS} "
            f"and {2 * SCAN_STEPS} steps, best of 3): {1e3 * per_step:.4f}"
            f" ms a step = {1 / per_step:.1f} steps/s"
            + (f" (phase 22, after the first chunk: {graphed_rate:.1f})"
               if graphed_rate else "")
            + f"; trace of 20 steps: {len(files)} file, {size} bytes, "
            f"{kernels} kernel events ({rqs} of K1/K2), on {name}")
    if size == 0 or rqs == 0:
        raise AssertionError(f"phase 41: trace wrote {files}, {kernels} "
                             f"kernel events, {rqs} of K1/K2")
    return dict(scan_ms_per_step=1e3 * per_step,
                scan_steps_per_s=1 / per_step, trace_bytes=size,
                trace_kernel_events=kernels)


def phase_exp_sgd(name):
    """Phase 42: SGD under the trainers' graph: TrainConfig's optimizer
    "sgd" (no capturable mode, no step count) captures, K1 and K2 20 a
    step by replay, and graphed against eager on the same draws gives
    identical bits."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import launches

    target = nft.Banana(2, 1.0, 100.0)
    opt = nft.OptimizerConfig(name="sgd", learning_rate=SGD_LR)
    cfg = nft.config_from_json(nft.config_to_json(nft.TrainConfig(
        flow=nft.FlowConfig(family="nsf", nlayers=DEMO["nlayers"],
                            hdims=DEMO["hdims"]),
        optimizer=opt, max_iters=SGD_STEPS, n_samples=DEMO_BATCH,
        check_every=SAME_CHECK, seed=42)))
    reset_counts()
    res = cfg.run(target.log_prob)
    per_step = 2 * DEMO["nlayers"]
    expect_counts("phase 42", rqs_fwd=per_step * SGD_STEPS,
                  rqs_bwd_fwddir=per_step * SGD_STEPS)
    if launches.captures() != 1 or not np.isfinite(res.stats["loss"]).all():
        raise AssertionError(f"phase 42: {launches.captures()} captures, "
                             f"losses {res.stats['loss']}")

    def train(flow, graph):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(7),
            nft.elbo_from_samples, flow, target.log_prob,
            max_iters=SGD_STEPS, check_every=SAME_CHECK,
            scan_inputs=nft.presample_base(DEMO_BATCH),
            optimizer=opt.build(), graph=graph)

    runs = {}
    for graph in (True, False):
        flow = _demo_flow(seed=42)
        runs[graph] = _outcome(train(flow, graph), flow)
    same = _agree(42, "NSF demo, SGD", runs[True], runs[False], strict=True)
    say(42, f"SGD({SGD_LR}) from a config, graphed by default: one capture, "
            f"K1 and K2 {per_step} a step by replay; graphed against eager "
            f"on the same draws, identical bits: {same}, on {name}")
    return {"captured": True, "identical_bits": same}


@contextlib.contextmanager
def _trainer_calls():
    """The trainers a demo or the parity harness calls as ``nft.<name>``,
    each call's launches and captures recorded: counts are reset before the
    call and read after it, so the evaluations and sampling around it do
    not count. Yields the list of calls."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import launches

    names = ("train_flow", "train_flow_mle", "train_realnvp_fused")
    real = {n: getattr(nft, n) for n in names}
    calls = []

    def spy(n):
        def run(*args, **kw):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real[n](*args, **kw)
            torch.cuda.synchronize()
            calls.append(dict(trainer=n, steps=len(res.stats["loss"]),
                              seconds=time.perf_counter() - t0,
                              counts=all_counts(),
                              captures=launches.captures(),
                              losses=res.stats["loss"]))
            return res
        return run

    for n in names:
        setattr(nft, n, spy(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(nft, n, real[n])


def _sched_train(opt_box, steps, gen, graph=None, resume_state=None,
                 callback=None):
    """Phase 43's run: nsf_banana_hard's model (``resume_state``'s flow, or
    a fresh one of seed 0) under optim.adam(warmup_cosine(SCHED)), steps
    on presample_base draws of ``gen`` in chunks of SCHED_CHECK. The
    optimizer lands in ``opt_box``."""
    import normalizingflows_torch as nft

    def factory(params):
        opt_box[:] = [nft.optim.adam(
            nft.optim.warmup_cosine_decay_schedule(*SCHED))(params)]
        return opt_box[0]

    flow = (resume_state.flow if resume_state is not None
            else nft.nsf(torch.Generator().manual_seed(0), **NSF_WRAP))
    target = nft.Banana(2, 1.0, 100.0)
    return nft.train_flow(
        gen, nft.elbo_from_samples, flow, target.log_prob, max_iters=steps,
        check_every=SCHED_CHECK, scan_inputs=nft.presample_base(DEMO_BATCH),
        optimizer=None if resume_state is not None else factory,
        resume_state=resume_state, graph=graph, callback=callback)


def phase_schedule(name):
    """Phase 43: nsf_banana_hard's model (NSF_WRAP, batch 64) under
    optim.adam(warmup_cosine_decay_schedule(*SCHED)), the rate inside the
    captured step: SCHED_STEPS steps graphed, then eagerly, on the same
    draws, identical bits (strict); at each chunk boundary the group's rate
    equals the CPU port's schedule at the last step's count within 1 ulp;
    K1 = K2 = 20 a step by replay, one capture; resumed from
    save_train_state at each of SCHED_RESUMES (in the warmup, in the decay)
    into a fresh flow, optimizer and generator, the straight run's bits; a
    float lr a callback writes under the graph raises; steps/s graphed
    with and without the schedule in turns, and the scheduled step
    profiled (after every other phase)."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.ops import launches
    from normalizingflows_torch.train import TrainState
    from normalizingflows_torch.utils import checkpoint
    from normalizingflows_torch.utils.pytree import trainable_parameters

    cpu_sched = nft.optim.warmup_cosine_decay_schedule(*SCHED)
    per_step = 2 * NSF_WRAP["nlayers"]
    runs, lr_seen, opt_box = {}, [], []

    def lr_at_boundary(it, stat, flow):
        lr = float(opt_box[0].param_groups[0]["lr"])
        want = float(cpu_sched(torch.tensor(float(it - 1))))
        lr_seen.append((it, lr, want))

    for graph in (True, False):
        reset_counts()

        def train(stamp):
            def callback(it, stat, flow):
                lr_at_boundary(it, stat, flow)
                stamp(it, stat, flow)

            return _sched_train(
                opt_box, SCHED_STEPS,
                torch.Generator(device=DEVICE).manual_seed(43), graph=graph,
                callback=callback)

        res, dt, steady = _stamped(train)
        if graph:
            counts = expect_counts("phase 43, graphed",
                                   rqs_fwd=per_step * SCHED_STEPS,
                                   rqs_bwd_fwddir=per_step * SCHED_STEPS)
            if launches.captures() != 1:
                raise AssertionError(f"phase 43: {launches.captures()} "
                                     "captures")
        runs[graph] = dict(outcome=_outcome(res, res.flow), steady=steady,
                           steps_per_s=SCHED_STEPS / dt, res=res)
    same = _agree(43, "nsf_banana_hard under the schedule",
                  runs[True]["outcome"], runs[False]["outcome"], strict=True)
    ulps = [abs(lr - want) / np.spacing(np.float32(abs(want)))
            for _, lr, want in lr_seen]
    say(43, f"the group's rate at {len(lr_seen)} chunk boundaries (graphed "
            f"and eager) against the CPU port's schedule: max "
            f"{max(ulps):.1f} ulp; at steps "
            + ", ".join(f"{it}: {lr:.6e}" for it, lr, _ in
                        lr_seen[:SCHED_STEPS // SCHED_CHECK]))
    if max(ulps) > 1:
        raise AssertionError(f"phase 43: the rate on the card left the "
                             f"schedule: {lr_seen}")
    straight = runs[True]["outcome"]

    # resumes: a checkpoint at each of SCHED_RESUMES steps, loaded into a
    # fresh flow, optimizer and generator
    resumed = {}
    for at in SCHED_RESUMES:
        gen = torch.Generator(device=DEVICE).manual_seed(43)
        first = _sched_train(opt_box, at, gen)
        path = _exp_dir() / f"nsf_sched_{at}.pt"
        checkpoint.save_train_state(str(path), first.state, generator=gen)
        flow = nft.nsf(torch.Generator().manual_seed(1), **NSF_WRAP)
        opt = nft.optim.adam(cpu_sched)(trainable_parameters(flow))
        gen2 = torch.Generator(device=DEVICE).manual_seed(0)
        state = checkpoint.load_train_state(str(path), TrainState(flow, opt,
                                                                  0),
                                            generator=gen2)
        reset_counts()
        rest = _sched_train(opt_box, SCHED_STEPS - at, gen2,
                            resume_state=state)
        expect_counts(f"phase 43, resumed at {at}",
                      rqs_fwd=per_step * (SCHED_STEPS - at),
                      rqs_bwd_fwddir=per_step * (SCHED_STEPS - at))
        losses = np.concatenate([first.stats["loss"], rest.stats["loss"]])
        resumed[at] = bool(np.array_equal(losses, straight[0]) and all(
            torch.equal(a, b) for a, b in zip(
                straight[1], [p.detach() for p in flow.parameters()])))
    say(43, f"resumed from save_train_state at steps "
            f"{', '.join(map(str, SCHED_RESUMES))} (fresh flow, Adam and "
            f"generator; the loaded lr tensor is another than the one the "
            f"optimizer was built with): the straight run's bits "
            f"{resumed}")
    if not all(resumed.values()):
        raise AssertionError(f"phase 43: a resumed run left the straight "
                             f"run's trajectory: {resumed}")

    # a float rate written by a callback under the graph raises
    def bump(it, stat, flow):
        for g in opt_box[0].param_groups:
            g["lr"] = 1e-5

    def float_adam(params):
        opt_box[:] = [torch.optim.Adam(params, lr=DEMO_LR)]
        return opt_box[0]

    target = nft.Banana(2, 1.0, 100.0)
    try:
        nft.train_flow(torch.Generator(device=DEVICE).manual_seed(1),
                       nft.elbo_batch,
                       nft.nsf(torch.Generator().manual_seed(0), **NSF_WRAP),
                       target.log_prob, DEMO_BATCH, max_iters=20,
                       check_every=10, optimizer=float_adam, callback=bump)
    except RuntimeError as err:
        message = str(err)
    else:
        raise AssertionError("phase 43: a float lr changed under the graph "
                             "did not raise")
    if "optim.adam(warmup_cosine_decay_schedule" not in message:
        raise AssertionError(f"phase 43: the raise said {message}")
    say(43, f"a float lr changed by a callback under the graph raised: "
            f"{message}")

    # the schedule's cost: graphed steps/s with and without it, in turns
    def rate(scheduled):
        def factory(params):
            if scheduled:
                return nft.optim.adam(cpu_sched)(params)
            return torch.optim.Adam(params, lr=DEMO_LR)

        res, dt, steady = _stamped(lambda cb: nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(2), nft.elbo_batch,
            nft.nsf(torch.Generator().manual_seed(0), **NSF_WRAP),
            target.log_prob, DEMO_BATCH, max_iters=RATE_STEPS,
            check_every=RATE_CHUNK, optimizer=factory, callback=cb))
        return steady

    turns = {"float": [], "schedule": []}
    for kind in ("float", "schedule", "schedule", "float"):
        turns[kind].append(rate(kind == "schedule"))
    ms = {k: 1e3 / statistics.mean(v) for k, v in turns.items()}
    say(43, f"graphed steps/s after the first chunk, {RATE_STEPS} steps a "
            f"run in turns: Adam(lr={DEMO_LR}) "
            f"{', '.join(f'{v:.1f}' for v in turns['float'])}; under the "
            f"schedule {', '.join(f'{v:.1f}' for v in turns['schedule'])}: "
            f"{ms['schedule'] - ms['float']:+.4f} ms a step, on {name}")
    g = runs[True]
    say(43, f"{SCHED_STEPS} graphed steps {g['steady']:.1f} steps/s after "
            f"the first chunk ({g['steps_per_s']:.1f} overall), eager "
            f"{runs[False]['steady']:.1f}; K1 = K2 = {per_step} a step by "
            f"replay ({counts['rqs_fwd']}, {counts['rqs_bwd_fwddir']}); loss "
            f"{g['res'].stats['loss'][0]:.2f} -> "
            f"{g['res'].stats['loss'][-1]:.4f}")
    numbers = dict(graph_steady=g["steady"],
                   graph_steps_per_s=g["steps_per_s"],
                   eager_steady=runs[False]["steady"], identical_bits=same,
                   lr_max_ulp=float(max(ulps)), resumed_identical=resumed,
                   steps_per_s_in_turns=turns,
                   schedule_ms_per_step=ms["schedule"] - ms["float"])
    return numbers, counts, lambda: profile_cell(
        43, "nsf_banana_hard under the schedule", 50,
        lambda p, cb: nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(3), nft.elbo_batch,
            nft.nsf(torch.Generator().manual_seed(0), **NSF_WRAP),
            target.log_prob, DEMO_BATCH, max_iters=2 * p, check_every=p,
            optimizer=nft.optim.adam(cpu_sched), callback=cb), name)


_PRINTED = re.compile(r"before:\s*(-?[\d.]+).*?after[^:]*:\s*(-?[\d.]+)")


def phase_demos(name):
    """Phase 44: the seven demos through their main() on the card
    (DEMO_RUNS; the NSF demo also with --affine-wrap), graphed by default:
    each trainer call launches K1 and K2 20 a step (the NSF demos) or none
    of K1-K6 (the others, as unfused as the JAX demos), one capture; the
    training ELBO (the negated loss) rises from the first tenth of the
    steps to the last, and so does the demo's printed ELBO, except the
    Hamiltonian demo's, whose 512-draw estimate of the funnel's ELBO is
    heavy-tailed (its before and after come from other draws)."""
    import importlib
    import io

    out = {}
    for module, kw, steps, per_step in DEMO_RUNS:
        mod = importlib.import_module(
            f"normalizingflows_torch.examples.{module}")
        label = module + ("_affine_wrap" if kw.get("affine_wrap") else "")
        if module == "demo_maf_mle":
            kw = dict(kw, data_path=_exp_dir() / "maf_mle_banana.raw")
        text = io.StringIO()
        with _trainer_calls() as calls, contextlib.redirect_stdout(text):
            mod.main(steps, show_progress=False, **kw)
        line = text.getvalue().strip().splitlines()[-1]
        (call,) = calls
        want = ({"rqs_fwd": per_step * steps,
                 "rqs_bwd_fwddir": per_step * steps} if per_step else {})
        full = {k: want.get(k, 0) for k in call["counts"]}
        if call["counts"] != full or call["captures"] != 1:
            raise AssertionError(f"phase 44, {label}: launches "
                                 f"{call['counts']}, {call['captures']} "
                                 f"captures, expected {full} and 1")
        losses = call["losses"]
        k = max(steps // 10, 1)
        head, tail = -float(losses[:k].mean()), -float(losses[-k:].mean())
        m = _PRINTED.search(line)
        before, after = float(m.group(1)), float(m.group(2))
        say(44, f"{label}, {steps} steps: {line}; training objective (mean "
                f"of a tenth of the steps) {head:.4f} -> {tail:.4f}; "
                f"{steps / call['seconds']:.1f} steps/s with the capture; "
                f"K1/K2 {per_step} a step")
        if not (math.isfinite(tail) and tail > head):
            raise AssertionError(f"phase 44, {label}: the training "
                                 f"objective went {head} -> {tail}")
        if module != "demo_hamiltonian_flow" and not after > before:
            raise AssertionError(f"phase 44, {label}: {line}")
        out[label] = dict(steps=steps, before=before, after=after,
                          train_elbo_head=head, train_elbo_tail=tail,
                          steps_per_s=steps / call["seconds"],
                          counts=call["counts"])
    say(44, f"the seven demos ran through their main() on {name}")
    return out


def phase_parity_quick(name):
    """Phase 45: the parity harness (normalizingflows_torch/examples/
    parity.py) at its quick counts: the eight rows of benchmarks/parity.py
    and the fused and K6 routes of the RealNVP row. Each row's fields
    finite and its ELBO rising by more than twice the two SEMs
    (improved_significant; the rows in PARITY_NOT_SIGNIFICANT are
    reported); each training call's launches: K1 = K2 = 20 a step for the
    NSF row, one K4 and one K5 a step on the fused route, one K6 launch a
    512 steps on the K6 route, none of K1-K6 elsewhere. The band against
    the JAX row (at its full count) is printed, not held."""
    from normalizingflows_torch.examples import parity

    fig_dir = _exp_dir() / "parity_figures"
    reference = json.loads(parity.REFERENCE.read_text())
    out, t0 = {}, time.perf_counter()
    for key, (fn, _, quick) in parity.WORKLOADS.items():
        with _trainer_calls() as calls:
            row = fn(quick, torch.device(DEVICE), fig_dir)
        (call,) = calls
        want = {"nsf": {"rqs_fwd": 20 * quick, "rqs_bwd_fwddir": 20 * quick},
                "realnvp_fused": {"coupling_fwd": quick,
                                  "coupling_bwd": quick},
                "realnvp_k6": {"realnvp_train": -(-quick // 512)}}.get(key,
                                                                       {})
        full = {k: want.get(k, 0) for k in call["counts"]}
        captures = 0 if key == "realnvp_k6" else 1
        if call["counts"] != full or call["captures"] != captures:
            raise AssertionError(f"phase 45, {key}: launches "
                                 f"{call['counts']}, {call['captures']} "
                                 f"captures, expected {full}, {captures}")
        numbers = [v for v in row.values() if isinstance(v, float)] + [
            x for v in row.values() if isinstance(v, list) for x in v]
        if not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"phase 45, {key}: {row}")
        band = parity.band(row, reference[parity.JAX_ROW.get(
            row["workload"], row["workload"])])
        say(45, f"{row['workload']} ({quick} steps): ELBO "
                f"{row['elbo_before']}±{row.get('elbo_before_sem', 0)} -> "
                f"{row['elbo_after']}±{row.get('elbo_after_sem', 0)}, train "
                f"tail {row['elbo_train_tail']}, {row['iters_per_s']} "
                f"iters/s, SW2 {row['sliced_w2']} ({row['sliced_w2_floor']}),"
                f" TV {row['grid_tv']} ({row['grid_tv_floor']}), improved "
                f"significantly {row['improved_significant']}; launches "
                f"{want or 'none of K1-K6'}; the JAX row at "
                f"{band['jax_iters']} steps {band['jax']}")
        if (not row["improved_significant"]
                and row["workload"] not in PARITY_NOT_SIGNIFICANT):
            raise AssertionError(f"phase 45, {key}: no significant rise: "
                                 f"{row}")
        out[key] = {k: row[k] for k in (
            "workload", "iters", "elbo_before", "elbo_after",
            "elbo_train_tail", "iters_per_s", "improved_significant")}
        out[key].update(elbo_after_sem=row.get("elbo_after_sem"),
                        train_steps_per_s=quick / call["seconds"],
                        counts={k: v for k, v in call["counts"].items() if v},
                        jax_elbo_after=band["jax"])
    seconds = time.perf_counter() - t0
    say(45, f"the parity harness at its quick counts: {len(out)} rows in "
            f"{seconds:.1f} s, on {name}")
    return out, seconds


# ---------------------------------------------------------------------------
# Phases 46-51: bfloat16 (the bf16 compute_dtype policy and bfloat16
# parameters)
# ---------------------------------------------------------------------------

def _bf16_rqs_case(gen, xdt, K, n):
    """Phase 46's inputs at N = n: x (batch, n_t) in ``xdt``, raw a
    bfloat16 view of the conditioner's (batch, n_t·(3K−1)) output, its
    padded copy, and the cotangents, drawn in float32 and rounded."""
    P = 3 * K - 1
    n_t = 32 if n == 131072 else 1
    batch = n // n_t
    x = ((torch.rand((batch, n_t), generator=gen, device=DEVICE) * 3.0
          - 1.5) * B).to(xdt)
    raw = (3.0 * torch.randn((batch, n_t * P), generator=gen,
                             device=DEVICE)).to(torch.bfloat16)
    gy = torch.randn((n,), generator=gen, device=DEVICE).to(xdt)
    gld = torch.randn((n,), generator=gen, device=DEVICE).to(xdt)
    rawf = raw.view(-1, P)
    pad = torch.cat([rawf, torch.randn((n, 3), generator=gen, device=DEVICE
                                       ).to(torch.bfloat16)], 1)
    return x, raw.view(batch, n_t, P), x.reshape(-1), rawf, pad, gy, gld


def phase_rqs_bf16(gen):
    """Phase 46: K1–K3's bfloat16 instantiations against their plain
    versions on the card, bit for bit: (x float32, raw bfloat16), the
    policy's NSF, and (x, raw bfloat16), bfloat16 parameters; K 8 and 10,
    N in RQS_BF16_SIZES; raw elem-major through the staged tile, forced
    onto the direct read, param-major, and padded elem-major (the pad's
    gradient exact zeros); graw in bfloat16. Then device times at K=10 and
    N in RQS_TIMED, warm, and at 131072 with a cold L2, beside the byte
    bound with two-byte raw."""
    from normalizingflows_torch.ops import rqs_cuda

    bf = torch.bfloat16
    results = {}
    checks = 0
    for xdt, sfx in RQS_BF16_TYPES:
        for k in KERNELS:
            results[f"{k}_{sfx}"] = {"err": 0.0}
        for K in (8, 10):
            P = 3 * K - 1
            for n in RQS_BF16_SIZES:
                x, raw3, xf, rawf, pad, gy, gld = _bf16_rqs_case(gen, xdt, K,
                                                                 n)
                tag = f"{sfx} K={K} N={n}"
                for inverse in (False, True):
                    d = "inv" if inverse else "fwd"
                    kname = "K3" if inverse else "K2"
                    tile = (rqs_cuda.tile_bwd_analytic_inverse if inverse
                            else rqs_cuda.tile_bwd_analytic)
                    y, ld, gx, graw = _grads(lambda a, r: rqs_cuda.rqs_fused(
                        a, r, B, inverse=inverse, backend="cuda"),
                        x, raw3, gy, gld)
                    if y.dtype != xdt or graw.dtype != bf:
                        raise AssertionError(f"{tag}: outputs in {y.dtype}, "
                                             f"graw in {graw.dtype}")
                    y_p, ld_p = rqs_cuda.tile_transform(xf, rawf, B, inverse)
                    gx_p, graw_p = tile(xf, rawf, gy, gld, B)
                    _same(f"K1 {d} y {tag}", y.reshape(-1), y_p)
                    _same(f"K1 {d} ld {tag}", ld.reshape(-1), ld_p)
                    _same(f"{kname} gx {tag}", gx.reshape(-1), gx_p)
                    _same(f"{kname} graw {tag}", graw.reshape(-1, P), graw_p)
                    with direct_read(rqs_cuda):
                        y_d, ld_d = rqs_cuda._launch_fwd(xf, rawf, B, K,
                                                         inverse)
                        gx_d, graw_d = rqs_cuda._launch_bwd(
                            xf, rawf, gy, gld, B, K, inverse)
                    _same(f"K1 {d} {tag} direct y", y_d, y_p)
                    _same(f"K1 {d} {tag} direct ld", ld_d, ld_p)
                    _same(f"{kname} {tag} direct gx", gx_d, gx_p)
                    _same(f"{kname} {tag} direct graw", graw_d, graw_p)
                    y_t, ld_t, gx_t, graw_t = _grads(
                        lambda a, r: rqs_cuda.rqs_fused_t(
                            a, r, B, inverse=inverse, backend="cuda"),
                        xf, rawf.T.contiguous(), gy, gld)
                    _same(f"K1 {d} {tag} param-major y", y_t, y_p)
                    _same(f"K1 {d} {tag} param-major ld", ld_t, ld_p)
                    _same(f"{kname} {tag} param-major gx", gx_t, gx_p)
                    _same(f"{kname} {tag} param-major graw", graw_t.T,
                          graw_p)
                    del graw_t
                    poison = torch.full_like(pad, float("nan"))
                    del poison  # the allocator hands this block to graw
                    y_e, ld_e, gx_e, graw_e = _grads(
                        lambda a, r: rqs_cuda.rqs_fused_e(
                            a, r, B, K, inverse=inverse, backend="cuda"),
                        xf, pad, gy, gld)
                    _same(f"K1 {d} {tag} padded y", y_e, y_p)
                    _same(f"{kname} {tag} padded gx", gx_e, gx_p)
                    _same(f"{kname} {tag} padded graw", graw_e[:, :P],
                          graw_p)
                    if torch.count_nonzero(graw_e[:, P:]) or not bool(
                            torch.isfinite(graw_e[:, P:]).all()):
                        raise AssertionError(f"{kname} {tag}: pad columns "
                                             "of graw are not exact zeros")
                    checks += 16
    torch.cuda.synchronize()
    say(46, f"K1–K3 bfloat16 (x float32 or bfloat16, raw bfloat16): "
            f"{checks} outputs identical to the plain versions' bits "
            f"(staged, direct read, param-major, padded with exact-zero pad "
            f"gradients; graw bfloat16), K 8/10, N {RQS_BF16_SIZES}")

    K, P = 10, 29
    flush = torch.empty(FLUSH_BYTES // 4, device=DEVICE)
    flush_ms = device_ms(flush.zero_)
    for xdt, sfx in RQS_BF16_TYPES:
        xb = torch.finfo(xdt).bits // 8
        for n in RQS_TIMED:
            _, _, x, raw, _, gy, gld = _bf16_rqs_case(gen, xdt, K, n)
            calls = {
                "rqs_fwd": (
                    lambda: rqs_cuda._launch_fwd(x, raw, B, K, False),
                    lambda: rqs_cuda.tile_transform(x, raw, B)),
                "rqs_bwd_fwddir": (
                    lambda: rqs_cuda._launch_bwd(x, raw, gy, gld, B, K,
                                                 False),
                    lambda: rqs_cuda.tile_bwd_analytic(x, raw, gy, gld, B)),
                "rqs_bwd_invdir": (
                    lambda: rqs_cuda._launch_bwd(x, raw, gy, gld, B, K, True),
                    lambda: rqs_cuda.tile_bwd_analytic_inverse(
                        x, raw, gy, gld, B)),
            }
            for kernel, (launch, plain) in calls.items():
                r = results[f"{kernel}_{sfx}"]
                ms, plain_ms = device_ms(launch), device_ms(plain)
                bms, by = bound_ms(kernel, n, K, xb, raw_bytes=2)
                r.setdefault("ms_by_n", {})[n] = ms
                r.setdefault("plain_ms_by_n", {})[n] = plain_ms
                r.setdefault("bound_ms_by_n", {})[n] = bms
                line = (f"{kernel}_{sfx} N={n} K=10: kernel {ms:.5f} ms, "
                        f"plain {plain_ms:.5f} ms, bound {bms:.5f} ms ({by}, "
                        f"{xb}-byte x, 2-byte raw), {100 * bms / ms:.1f} % of "
                        f"it")
                if n == 131072:
                    cold = device_ms(lambda: (flush.zero_(), launch())) \
                        - flush_ms
                    r.update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, cold_ms=cold)
                    line += f"; cold L2 {cold:.5f} ms"
                say(46, line + " (device time a call: median of 7 CUDA-graph "
                               "replays of 20 calls, CUDA events)")
    return results


def _flipped_share(name, got, want, limit=None):
    """The share of elements outside FLIP_TOL (a float32 roundoff rounding
    a later operand to the neighbouring bfloat16); raises past ``limit``
    (None: a reading)."""
    got, want = got.detach().double(), want.detach().double()
    out = (got - want).abs() > FLIP_TOL[1] + FLIP_TOL[0] * want.abs()
    share = float(out.double().mean()) if out.numel() else 0.0
    if limit is not None and share > limit:
        raise AssertionError(f"{name}: {100 * share:.3f} % of the elements "
                             f"outside rtol/atol {FLIP_TOL}, over "
                             f"{100 * limit:.3f} %")
    return share


def _rel(a, b):
    """‖a − b‖ / ‖b‖ over lists of tensors, in float64 (0 where both are
    zero, inf where only b is)."""
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.double() ** 2).sum()) for y in b)
    return math.sqrt(num / den) if den else (0.0 if num == 0 else math.inf)


def _leaf_check(cc, fb, x, gy, gld, sels, inverse, got, wants, tag,
                gate=True):
    """The policy's weight gradients from K5 (``got``) against its plain
    version's (``wants``), each leaf's relative L2 error held to
    LEAF_FACTOR times the float32 K5's against the float32 plain version
    on the same inputs and weights, plus LEAF_FLOOR (without ``gate``, a
    reading). The sums are the same in the same orders; the policy adds
    roundings that float32 roundoff can flip, and an ill-conditioned sum
    amplifies both alike. Returns the largest ratio of the two errors."""
    xg = x.detach().requires_grad_()
    y32, ld32 = cc.coupling_stack_fused(xg, fb.groups, fb.idx_even,
                                        fb.idx_odd, inverse=inverse,
                                        backend="cuda")
    g32 = torch.autograd.grad((y32, ld32), cc._leaves(fb.groups), (gy, gld))
    t32 = cc._leaves(cc.tile_flow_bwd(x, fb.groups, gy, gld, sels,
                                      inverse)[1])
    worst = 0.0
    for i, (a, b, a32, b32) in enumerate(zip(got, wants, g32, t32)):
        err, err32 = _rel([a], [b]), _rel([a32], [b32])
        if gate and err > LEAF_FACTOR * err32 + LEAF_FLOOR:
            raise AssertionError(
                f"K5 {tag} leaf {i}: relative L2 error {err:.3e} against "
                f"the plain version, float32's {err32:.3e} (limit "
                f"{LEAF_FACTOR} times it plus {LEAF_FLOOR})")
        worst = max(worst, err / max(err32, LEAF_FLOOR))
    return worst


def _bf16_fused(cfg, variant, seed=30):
    """A perturbed fused RealNVP stack of ``cfg`` for a bf16 variant:
    "f32_cbf16" (float32 weights, the policy) or "bf16" (bfloat16
    weights)."""
    import normalizingflows_torch as nft

    dtype, cd = CPL_BF16_VARIANTS[variant]
    flow = nft.realnvp(torch.Generator().manual_seed(seed), fused=True,
                       dtype=dtype, compute_dtype=cd, **cfg)
    return _perturbed(flow).bijector.bijectors[0]


def _split_bits(cc, x, leaves, gy, gld, sels, depth, inverse, cd, got,
                tag):
    """A row's K4 and K5 outputs under the policy do not depend on where
    it lands: x's rows split at a 16-row boundary into two launches of
    each kernel give the bits of one launch (``got``: y, ld, gx)."""
    n = x.shape[0]
    m = 16 * (n // 32)
    outs = []
    for a, b in ((0, m), (m, n)):
        xp = x[a:b].contiguous()
        y, ld = cc._launch_fwd(xp, leaves, sels, depth, inverse,
                               compute_dtype=cd)
        gx, _ = cc._launch_bwd(xp, leaves, gy[a:b].contiguous(),
                               gld[a:b].contiguous(), sels, depth, inverse,
                               cd)
        outs.append((y, ld, gx))
    for i, nm in enumerate(("y", "ld", "gx")):
        _same(f"{tag} {nm}, rows split at {m} into two launches",
              torch.cat([o[i] for o in outs]), got[i])


def _dot_witness(a, b, cd=None):
    """`coupling_cuda._dot` with the policy's products summed in float64:
    the same roundings of the operands, another summation order."""
    if cd is None:
        return a @ b
    return (a.to(cd).double() @ b.to(cd).double()).to(a.dtype)


def _dot_bf16_sums(a, b, cd=None):
    """A faulty policy product, one of `_witness_check`'s controls: the
    float32 sum rounded to ``cd`` (a kernel keeping its sums in
    bfloat16)."""
    if cd is None:
        return a @ b
    return (a.to(cd).float() @ b.to(cd).float()).to(cd).to(a.dtype)


def _dot_unrounded(a, b, cd=None):
    """Another: the operands not rounded (a kernel skipping the policy)."""
    return a @ b


WITNESS_CONTROLS = {"bf16 sums": _dot_bf16_sums, "unrounded": _dot_unrounded}


def _plain_on(cc, dot, fb, x, gy, gld, sels, inverse, cd):
    """The plain versions' [y, ld, gx, *weight gradients] with
    `coupling_cuda._dot` replaced by ``dot`` (None: as it is)."""
    real = cc._dot
    cc._dot = dot or real
    try:
        y, ld = cc.tile_flow(x, fb.groups, sels, inverse, cd)
        gx, tree = cc.tile_flow_bwd(x, fb.groups, gy, gld, sels, inverse,
                                    cd)
    finally:
        cc._dot = real
    return [t.detach() for t in (y, ld, gx, *cc._leaves(tree))]


def _witness_check(cc, fb, x, gy, gld, sels, inverse, cd, got, tag, seen,
                   key):
    """The policy's outputs and gradients from K4/K5 (``got``), each within
    DEEP_WITNESS_FACTOR times `_dot_witness`'s relative L2 error from the
    plain version, plus LEAF_FLOOR; and each of WITNESS_CONTROLS (the plain
    version on a faulty product) past that limit in some output, so that
    the factor tells such a fault from the roundoff. Keeps in ``seen``,
    under ``key``, the kernel's largest ratio to the witness's error by
    output (y, ld, gx, the weight gradients) and each control's largest,
    its smallest over the cases; returns what failed."""
    args = (fb, x, gy, gld, sels, inverse, cd)
    plain = _plain_on(cc, None, *args)
    witness = _plain_on(cc, _dot_witness, *args)
    names = ["y", "ld", "gx"] + ["leaves"] * (len(plain) - 3)

    def ratios(outs):
        return [(nm, _rel([a.detach()], [b]), _rel([w], [b]))
                for nm, a, b, w in zip(names, outs, plain, witness)]

    def ratio(err, err_w):
        return err / max(err_w, LEAF_FLOOR)

    def over(err, err_w):
        return err > DEEP_WITNESS_FACTOR * err_w + LEAF_FLOOR

    failed, mine = [], seen["witness"].setdefault(key, {})
    for nm, err, err_w in ratios(got):
        mine[nm] = max(mine.get(nm, 0.0), ratio(err, err_w))
        if over(err, err_w):
            failed.append(f"{tag} {nm}: relative L2 error {err:.3e} from the "
                          f"plain version, its float64-summed witness's "
                          f"{err_w:.3e} (limit {DEEP_WITNESS_FACTOR} times "
                          f"it plus {LEAF_FLOOR})")
    for label, dot in WITNESS_CONTROLS.items():
        rs = ratios(_plain_on(cc, dot, *args))
        top = max(ratio(err, err_w) for _, err, err_w in rs)
        ctl = seen["controls"].setdefault(key, {})
        ctl[label] = min(ctl.get(label, math.inf), top)
        if not any(over(err, err_w) for _, err, err_w in rs):
            failed.append(f"{tag}: the faulty control '{label}' at most "
                          f"{top:.2f} times the witness's error, within "
                          f"DEEP_WITNESS_FACTOR {DEEP_WITNESS_FACTOR}: the "
                          f"witness check would not see that fault")
    return failed


def _bf16_case(cc, variant, cfg, n, gen, results, seen):
    """One phase-47 case: K4/K5's ``variant`` on ``cfg``'s perturbed stack
    at N = n, forward and inverse, against its plain version within
    CPL_BF16_TOL (RNVP_DEEP: against a witness only, `_witness_check`),
    twice with identical bits; bfloat16 storage on its two K4 tiles with
    identical bits, the policy on rows split into two launches (at
    CPL_SPLIT_N) with identical bits, the share of its elements outside
    FLIP_TOL and its weight gradients against the float32 K5's error
    (`_leaf_check`; on RNVP_REF both read beside the float64-summed
    witness's, and past its batch the witness check). ``seen`` gathers the
    counts and extremes."""
    dtype, cd = CPL_BF16_VARIANTS[variant]
    tol = CPL_BF16_TOL[variant]
    fb = _bf16_fused(cfg, variant)
    d, depth = cfg["q0"], len(cfg["hdims"]) + 1
    sels = cc._sels(fb.idx_even, fb.idx_odd, d)
    leaves = cc._leaves(fb.groups)
    x, draws = _off_kinks(cc, torch.randn(
        (n, d), generator=gen, device=DEVICE, dtype=dtype),
        fb.groups, sels, gen, cd)
    seen["redrawn"] += draws
    gy = (torch.randn((n, d), generator=gen, device=DEVICE) / n).to(dtype)
    gld = (torch.randn((n,), generator=gen, device=DEVICE) / n).to(dtype)
    tag = f"{variant} d={d} {cfg['hdims']}x{cfg['nlayers']} N={n}"

    def run(inverse):
        xg = x.detach().requires_grad_()
        y, ld = cc.coupling_stack_fused(
            xg, fb.groups, fb.idx_even, fb.idx_odd, inverse=inverse,
            backend="cuda", compute_dtype=cd)
        return [y.detach(), ld.detach(), *torch.autograd.grad(
            (y, ld), [xg] + leaves, (gy, gld))]

    for inverse in (False, True):
        dr = "inv" if inverse else "fwd"
        got, again = run(inverse), run(inverse)
        for i, (a, b) in enumerate(zip(got, again)):
            _same(f"K4/K5 {dr} {tag} output {i}, two runs", a, b)
        if any(t.dtype != dtype for t in got):
            raise AssertionError(f"{tag}: outputs not in {dtype}")
        if cd is None:
            for lanes in (True, False):
                with fwd_tile(cc, lanes):
                    y_t, ld_t = cc._launch_fwd(x, leaves, sels, depth,
                                               inverse, compute_dtype=cd)
                _same(f"K4 {dr} {tag} y, tile {lanes}", y_t, got[0])
                _same(f"K4 {dr} {tag} ld, tile {lanes}", ld_t, got[1])
        elif n in CPL_SPLIT_N:
            _split_bits(cc, x, leaves, gy, gld, sels, depth, inverse, cd,
                        got, f"K4/K5 {dr} {tag}")
            seen["split"] += 1
        if cfg is RNVP_DEEP:
            seen["witness_failed"] += _witness_check(
                cc, fb, x, gy, gld, sels, inverse, cd, got, f"{dr} {tag}",
                seen, "deep")
            seen["n_cmp"] += len(got)
            continue
        y_p, ld_p = cc.tile_flow(x, fb.groups, sels, inverse, cd)
        gx_p, tree = cc.tile_flow_bwd(x, fb.groups, gy, gld, sels, inverse,
                                      cd)
        e4 = max(compare(f"K4 {dr} y  {tag}", got[0], y_p, tol["y"]),
                 compare(f"K4 {dr} ld {tag}", got[1], ld_p, tol["ld"]))
        gx_tol = tol.get("gx", tol["g"])
        e5 = compare(f"K5 {dr} {tag} gx", got[2], gx_p,
                     (gx_tol[0], gx_tol[1] / n))
        wants = cc._leaves(tree)
        for i, (a, b) in enumerate(zip(got[3:], wants)):
            scale = min(1.0, float(b.detach().abs().max()))
            e5 = max(e5, compare(f"K5 {dr} {tag} leaf {i}", a, b,
                                 (tol["g"][0], tol["g"][1] * scale),
                                 quiet=True))
        seen["n_cmp"] += len(got)
        if cd is not None and cfg is RNVP_REF:
            # its 20 couplings: the float64-summed witness itself puts up
            # to 1.6 % of y, ld and gx outside FLIP_TOL and its weight
            # gradients up to 2,391 times float32's error on the card, so
            # both are readings beside the witness's, and past 256 rows the
            # witness check holds the case
            witness = _plain_on(cc, _dot_witness, fb, x, gy, gld, sels,
                                inverse, cd)
            ref = seen["ref"].setdefault(n, dict(
                flips=dict(kernel=0.0, witness=0.0),
                leaf_ratio=dict(kernel=0.0, witness=0.0)))
            for who, o in (("kernel", got), ("witness", witness)):
                ref["flips"][who] = max(ref["flips"][who], *(
                    _flipped_share(f"{dr} {tag}", a, b) for a, b in (
                        (o[0], y_p), (o[1], ld_p), (o[2] * n, gx_p * n))))
                ref["leaf_ratio"][who] = max(ref["leaf_ratio"][who],
                                             _leaf_check(
                    cc, fb, x, gy, gld, sels, inverse, o[3:], wants,
                    f"{dr} {tag}", gate=False))
            if n > RNVP_REF_BATCH:
                seen["witness_failed"] += _witness_check(
                    cc, fb, x, gy, gld, sels, inverse, cd, got,
                    f"{dr} {tag}", seen, "ref")
        elif cd is not None:
            shares = [_flipped_share(f"{nm} {dr} {tag}", a, b, FLIP_SHARE)
                      for nm, a, b in (("y", got[0], y_p),
                                       ("ld", got[1], ld_p),
                                       ("gx", got[2] * n, gx_p * n))]
            seen["flips"] = max(seen["flips"], max(shares))
            seen["leaf_ratio"] = max(seen["leaf_ratio"], _leaf_check(
                cc, fb, x, gy, gld, sels, inverse, got[3:], wants,
                f"{dr} {tag}"))
        for k, e in (("coupling_fwd", e4), ("coupling_bwd", e5)):
            r = results[f"{k}_{variant}"]
            r["err"] = max(r["err"], e)


def phase_coupling_bf16(gen):
    """Phase 47: K4 and K5's bfloat16 instantiations, the policy's
    ("f32_cbf16", the tensor-core kernels) and bfloat16 storage ("bf16"),
    against their plain versions on the card at the demo's N 16, 300 and
    262,144, forward and inverse, and the policy also on the reference
    default at its batch and at CPL_REF_N (H = 32, the whole stack staged,
    K5's partial sums in device memory, at CPL_REF_N several tiles a CTA)
    and on RNVP_DEEP at N CPL_DEEP_N (d = 8: the head's
    whole n8 tile; 4 layers of 32; a stack staged a coupling at a time,
    held to a float64-summed witness only), within CPL_BF16_TOL
    (`_bf16_case`); K4 and K5
    twice with identical bits; bfloat16 storage's two K4 tiles with
    identical bits; the policy's rows split into two launches with
    identical bits. Then device times at CPL_TIMED beside the float32
    kernels in this call."""
    from normalizingflows_torch.experimental import coupling_cuda as cc

    results = {f"{k}_{v}": {"err": 0.0, "ms_by_n": {}, "plain_ms_by_n": {},
                            "bound_ms_by_n": {}, "f32_ms_by_n": {}}
               for v in CPL_BF16_VARIANTS for k in CPL_KERNELS}
    seen = dict(n_cmp=0, redrawn=0, split=0, flips=0.0, leaf_ratio=0.0,
                witness={}, controls={}, witness_failed=[], ref={})
    cases = [(v, RNVP_DEMO, n) for v in CPL_BF16_VARIANTS
             for n in CPL_BF16_N] + [("f32_cbf16", RNVP_REF, n)
                                     for n in (RNVP_REF_BATCH, CPL_REF_N)] + [
        ("f32_cbf16", RNVP_DEEP, CPL_DEEP_N)]
    for variant, cfg, n in cases:
        _bf16_case(cc, variant, cfg, n, gen, results, seen)
    torch.cuda.synchronize()
    for key, mine in seen["witness"].items():
        say(47, f"policy {key}: the kernels' relative L2 error at most "
                + ", ".join(f"{nm} {r:.2f}" for nm, r in mine.items())
                + " times the float64-summed witness's; the faulty controls' "
                  "largest, their least over the cases: "
                + ", ".join(f"{nm} {r:.2f}" for nm, r in
                            seen["controls"][key].items())
                + f" (DEEP_WITNESS_FACTOR {DEEP_WITNESS_FACTOR})")
    for n, ref in seen["ref"].items():
        say(47, f"policy ref N={n}: at most {100 * ref['flips']['kernel']:.4f}"
                f" % of y, ld and gx outside {FLIP_TOL} (the float64-summed "
                f"witness {100 * ref['flips']['witness']:.4f} %), weight "
                f"gradients at most {ref['leaf_ratio']['kernel']:.1f} times "
                f"float32's error (the witness "
                f"{ref['leaf_ratio']['witness']:.1f}): readings")
    if seen["witness_failed"]:
        raise AssertionError("; ".join(seen["witness_failed"]))
    say(47, f"K4/K5 bfloat16: {seen['n_cmp']} comparisons with the plain "
            f"versions within tolerance (policy and bfloat16 storage, "
            f"forward and inverse, demo N {CPL_BF16_N}, the policy also on "
            f"the reference default at N {RNVP_REF_BATCH} and {CPL_REF_N} "
            f"(the latter held to the float64-summed witness too) and on "
            f"d=8 {RNVP_DEEP['hdims']}x{RNVP_DEEP['nlayers']} N={CPL_DEEP_N}"
            f" (to the witness only)); under "
            f"the policy at most {100 * seen['flips']:.4f} % of y, ld and gx "
            f"outside {FLIP_TOL}, and its weight gradients at most "
            f"{seen['leaf_ratio']:.1f} times float32's error (LEAF_FACTOR "
            f"{LEAF_FACTOR}); K4 and K5 identical bits on two runs, the "
            f"policy's rows split into two launches identical bits "
            f"({seen['split']} cases, N {CPL_SPLIT_N}), bfloat16 storage's "
            f"lane and row tiles identical bits; {seen['redrawn']} rows "
            f"drawn again off the kink")

    for model, n in CPL_TIMED:
        cfg = CPL_CFG[model]
        d, depth = cfg["q0"], len(cfg["hdims"]) + 1
        f32 = _bf16_fused(cfg, "f32_cbf16")
        for variant, (dtype, cd) in CPL_BF16_VARIANTS.items():
            fb = _bf16_fused(cfg, variant)
            sels = cc._sels(fb.idx_even, fb.idx_odd, d)
            leaves = cc._leaves(fb.groups)
            x = torch.randn((n, d), generator=gen, device=DEVICE).to(dtype)
            gy = (torch.randn((n, d), generator=gen, device=DEVICE)
                  / n).to(dtype)
            gld = (torch.randn((n,), generator=gen, device=DEVICE)
                   / n).to(dtype)
            fl = cc._leaves(f32.groups)
            xf, gyf, gldf = x.float(), gy.float(), gld.float()
            t = {"coupling_fwd": (
                     device_ms(lambda: cc._launch_fwd(
                         x, leaves, sels, depth, False, compute_dtype=cd)),
                     device_ms(lambda: cc.tile_flow(x, fb.groups, sels,
                                                    False, cd)),
                     device_ms(lambda: cc._launch_fwd(xf, fl, sels, depth,
                                                      False))),
                 "coupling_bwd": (
                     device_ms(lambda: cc._launch_bwd(
                         x, leaves, gy, gld, sels, depth, False, cd)),
                     device_ms(lambda: cc.tile_flow_bwd(
                         x, fb.groups, gy, gld, sels, False, cd)),
                     device_ms(lambda: cc._launch_bwd(xf, fl, gyf, gldf,
                                                      sels, depth, False)))}
            word = 2 if dtype == torch.bfloat16 else 4
            for k, (ms, plain_ms, f32_ms) in t.items():
                r = results[f"{k}_{variant}"]
                bms, by = coupling_bound_ms(k, cfg, n, word,
                                            policy=cd is not None)
                key = str(n)
                r["ms_by_n"][key], r["plain_ms_by_n"][key] = ms, plain_ms
                r["bound_ms_by_n"][key], r["f32_ms_by_n"][key] = bms, f32_ms
                r.setdefault("bound_by_n", {})[key] = by
                say(47, f"{k}_{variant} {model} N={n}: kernel {ms:.5f} ms, "
                        f"plain {plain_ms:.5f} ms, float32 kernel {f32_ms:.5f}"
                        f" ms, bound {bms:.5f} ms ({by}) (device time a "
                        f"call: median of 7 CUDA-graph replays of 20 calls, "
                        f"CUDA events)")
    for r in results.values():
        main = str(RNVP_BATCH)
        r.update(ms=r["ms_by_n"][main], plain_ms=r["plain_ms_by_n"][main],
                 bound_ms=r["bound_ms_by_n"][main],
                 bound_by=r["bound_by_n"][main])
    return results


def _mm_flag_check(name):
    """The policy's product on the card, `torch.mm(a, b,
    out_dtype=float32)` on bfloat16 operands, at the wide RealNVP's
    shapes: its bits with `allow_bf16_reduced_precision_reduction` on and
    off (restored after), and its distance from the float64 product."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    g = torch.Generator(device=DEVICE).manual_seed(48)
    out = {"allow_bf16_reduced_precision_reduction": flag}
    same = True
    for m, k, n in ((4096, 64, 256), (4096, 256, 256), (256, 4096, 256)):
        a = torch.randn((m, k), generator=g, device=DEVICE).bfloat16()
        b = torch.randn((k, n), generator=g, device=DEVICE).bfloat16()
        try:
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = True
            p1 = torch.mm(a, b, out_dtype=torch.float32)
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
            p0 = torch.mm(a, b, out_dtype=torch.float32)
        finally:
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = flag
        same &= bool(torch.equal(p0, p1))
        err = float((p1.double() - a.double() @ b.double()).abs().max())
        out[f"{m}x{k}x{n}_max_abs_err_f64"] = err
    out["bits_independent_of_flag"] = same
    say(48, f"the policy's product torch.mm(bf16, bf16, out_dtype=float32): "
            f"allow_bf16_reduced_precision_reduction is {flag} (left so); "
            f"bits with it on and off identical: {same}; {out}, on {name}")
    if not same:
        raise AssertionError("phase 48: the policy's product depends on "
                             "allow_bf16_reduced_precision_reduction")
    return out


def _rnvp_wide(cd, seed=48):
    import normalizingflows_torch as nft

    return nft.realnvp(torch.Generator().manual_seed(seed), compute_dtype=cd,
                       **RNVP_WIDE)


def _rates_in_turns(phase, label, make, train_rate, per_step, name,
                    chunk=RATE_CHUNK):
    """Steps/s of the default graphed run (`elbo_batch`, the generator's
    draws) of the policy and float32 flows in turns (policy, float32,
    float32, policy), over chunks 2-3 of ``chunk`` steps, with the launch
    counts ``per_step[cd]`` a step."""
    rates = {"bf16": [], "f32": []}
    for key in ("bf16", "f32", "f32", "bf16"):
        cd = torch.bfloat16 if key == "bf16" else None
        flow = make(cd)
        reset_counts()
        _, _, steady = _stamped(lambda cb: train_rate(flow, cb))
        expect_counts(f"phase {phase}, {label} {key}, timed",
                      **{k: v * 3 * chunk
                         for k, v in per_step[key].items()})
        rates[key].append(steady)
    say(phase, f"{label}, graphed, steps/s over chunks 2-3 of {chunk} "
               f"steps, in turns (policy, float32, float32, policy): policy "
               f"{rates['bf16'][0]:.1f}, {rates['bf16'][1]:.1f}; float32 "
               f"{rates['f32'][0]:.1f}, {rates['f32'][1]:.1f}, on {name}")
    return rates


def _policy_band(phase, label, runs):
    """The policy run against the float32 run from the same init and
    draws: the first step's loss within POLICY_BAND relative (JAX's bf16
    policy bound against float32, tests/test_dtype_policy.py), and each
    run's mean loss over its last POLICY_LAST steps below its first loss
    (both train). Later steps are reported, not held to the band: on
    these targets the loss falls by orders of magnitude in the first
    steps, where the first step's difference compounds."""
    first = float(abs(runs["bf16"][0] - runs["f32"][0])
                  / abs(runs["f32"][0]))
    last = {k: float(np.mean(v[-POLICY_LAST:])) for k, v in runs.items()}
    ratio = last["bf16"] / last["f32"]
    say(phase, f"{label}: the policy against float32 from the same init and "
               f"draws: first loss {runs['bf16'][0]:.6g} against "
               f"{runs['f32'][0]:.6g} (rel {first:.2e}, band {POLICY_BAND});"
               f" mean loss of the last {POLICY_LAST} of "
               f"{len(runs['f32'])} steps {last['bf16']:.6g} against "
               f"{last['f32']:.6g} (ratio {ratio:.3f})")
    if not first <= POLICY_BAND:
        raise AssertionError(f"phase {phase}, {label}: the policy's first "
                             f"loss is {first:.3f} from float32's")
    for k, v in runs.items():
        if not (np.isfinite(v).all() and last[k] < v[0]):
            raise AssertionError(f"phase {phase}, {label}, {k}: the loss "
                                 f"went {v[0]} -> {last[k]}")
    return {"first_rel": first, "last_mean_bf16": last["bf16"],
            "last_mean_f32": last["f32"], "last_ratio": ratio}


def _f32_witness(phase, label, make, train, scan_inputs, f32_losses):
    """A float32 run on the same draws as ``f32_losses``' run, each step's
    rows in another order (``scan_inputs``): sum order alone. Its losses
    against the float32 run's show how far two correct programs part on
    this cell after the first steps (reported, not held)."""
    res = train(make(), True, None, scan_inputs)
    losses = res.stats["loss"]
    first = float(abs(losses[0] - f32_losses[0]) / abs(f32_losses[0]))
    last = float(np.mean(losses[-POLICY_LAST:])
                 / np.mean(f32_losses[-POLICY_LAST:]))
    say(phase, f"{label}, float32 against float32 with each step's rows "
               f"permuted (sum order alone): first loss rel {first:.2e}, "
               f"mean loss of the last {POLICY_LAST} of {len(losses)} steps "
               f"{np.mean(losses[-POLICY_LAST:]):.6g} against "
               f"{np.mean(f32_losses[-POLICY_LAST:]):.6g} (ratio {last:.3f})")
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase {phase}, {label}: the permuted float32 "
                             "run's loss is not finite")
    return {"first_rel": first, "last_ratio": last}


class _WitnessMatmul(torch.autograd.Function):
    """The bf16 policy's product written apart from the port's
    `nets._MixedMatmul`, the witness of `_first_step` and `_mixed_check`:
    the same bfloat16 operands (x, W and the cotangent each rounded once)
    multiplied and summed in float64, each result cast once to its
    operand's dtype."""

    @staticmethod
    def forward(ctx, x, W, cd):
        xc = x.reshape(-1, x.shape[-1]).to(cd).double()
        Wc = W.to(cd).double()
        ctx.save_for_backward(xc, Wc)
        ctx.meta = x.shape, x.dtype, W.dtype, cd
        return (xc @ Wc).to(W.dtype).reshape(x.shape[:-1] + (W.shape[1],))

    @staticmethod
    def backward(ctx, g):
        xc, Wc = ctx.saved_tensors
        shape, x_dtype, w_dtype, cd = ctx.meta
        gc = g.reshape(-1, g.shape[-1]).to(cd).double()
        return ((gc @ Wc.T).to(x_dtype).reshape(shape),
                (xc.T @ gc).to(w_dtype), None)


def _elbo_grads(flow, logp, draws):
    """The gradient of −`elbo_from_samples(draws, flow, logp)` with
    respect to the bijector's parameters (train_base=False), as
    `train_flow`'s step takes it."""
    import normalizingflows_torch as nft

    loss = -nft.elbo_from_samples(draws, flow, logp)
    return torch.autograd.grad(loss, list(flow.bijector.parameters()))


def _with_witness(fn):
    """``fn()`` with the port's policy product replaced by
    `_WitnessMatmul`."""
    from normalizingflows_torch.models import nets

    real = nets._MixedMatmul
    nets._MixedMatmul = _WitnessMatmul
    try:
        return fn()
    finally:
        nets._MixedMatmul = real


def _first_step(phase, label, make, target, draws, graphed_norm):
    """The main path's first step held to a number a wrong gradient moves.
    The policy flow ``make(bf16)``'s gradient on the first step's
    ``draws``: its global norm against the graphed run's first
    `gradient_norm` within 1e-6 relative (the program checked is the one
    the graphed step ran); then, on the draws times FIRST_STEP_SCALE,
    where the flow is well conditioned, against the same flow's gradient
    through `_WitnessMatmul` (the policy written apart, float64 sums) and
    the float32 flow's (``make(None)``): relative L2 from float32 within
    POLICY_BAND (JAX's bf16 policy bound), and from the witness within
    WITNESS_SHARE of that (the card's bf16 sums are not float32's to the
    ulp, so a few later roundings flip, but a policy program is nearer
    the policy than float32 is: a wrong scale, a missing term or a
    rounding left out moves it to float32's distance or past). On the
    draws themselves both are reported: at init a few rows there reach
    huge outputs, and one flipped rounding moves the whole gradient."""
    from normalizingflows_torch.utils.pytree import global_norm

    flow, f32_flow = make(torch.bfloat16), make(None)
    logp = target.log_prob
    pol = _elbo_grads(flow, logp, draws)
    out = {"graphed_rel": float(abs(global_norm(pol) - graphed_norm)
                                / graphed_norm),
           "norm": float(global_norm(pol)), "graphed_norm": graphed_norm,
           "raw_witness_rel": _rel(pol, _with_witness(
               lambda: _elbo_grads(flow, logp, draws))),
           "raw_f32_rel": _rel(pol, _elbo_grads(f32_flow, logp, draws))}
    small = draws * FIRST_STEP_SCALE
    pol = _elbo_grads(flow, logp, small)
    wit = _with_witness(lambda: _elbo_grads(flow, logp, small))
    out.update(witness_rel=_rel(pol, wit),
               witness_rel_max_tensor=max(_rel([a], [b])
                                          for a, b in zip(pol, wit)),
               f32_rel=_rel(pol, _elbo_grads(f32_flow, logp, small)))
    say(phase, f"{label}, the first step's gradient under the policy: norm"
               f" {out['norm']:.8g} against the graphed step's "
               f"{graphed_norm:.8g} (rel {out['graphed_rel']:.2e}); on the "
               f"draws times {FIRST_STEP_SCALE}, rel L2 against the float64"
               f"-summed witness {out['witness_rel']:.3e} (at most "
               f"{WITNESS_SHARE} of float32's; worst tensor "
               f"{out['witness_rel_max_tensor']:.3e}), against float32 "
               f"{out['f32_rel']:.3e} (band {POLICY_BAND}); on the draws "
               f"themselves {out['raw_witness_rel']:.3e} and "
               f"{out['raw_f32_rel']:.3e} (reported)")
    if not (out["graphed_rel"] <= 1e-6 and out["f32_rel"] <= POLICY_BAND
            and out["witness_rel"] <= WITNESS_SHARE * out["f32_rel"]):
        raise AssertionError(f"phase {phase}, {label}: the policy's first "
                             f"step is outside its bands: {out}")
    return out


def _mixed_check(phase, shapes, name):
    """`nets._MixedMatmul` on the card at the main path's product shapes,
    (rows, in, out), against `_WitnessMatmul` on the same float32 x, W
    and cotangent: the value, gx and gW relative L2 within MIXED_BAND. One
    product rounds the same operands on both sides, so only the float32
    sums differ (`_mm_flag_check` reads them against float64)."""
    from normalizingflows_torch.models import nets

    g = torch.Generator(device=DEVICE).manual_seed(phase)
    worst = 0.0
    for m, k, n in shapes:
        x, W, gy = (torch.randn(s, generator=g, device=DEVICE)
                    for s in ((m, k), (k, n), (m, n)))
        outs = []
        for fn in (nets._MixedMatmul, _WitnessMatmul):
            xg, Wg = x.clone().requires_grad_(), W.clone().requires_grad_()
            y = fn.apply(xg, Wg, torch.bfloat16)
            outs.append([y, *torch.autograd.grad(y, (xg, Wg), gy)])
        errs = [_rel([a], [b]) for a, b in zip(*outs)]
        worst = max(worst, *errs)
        if max(errs) > MIXED_BAND:
            raise AssertionError(f"phase {phase}: _MixedMatmul {m}x{k}x{n} "
                                 f"(value, gx, gW) rel L2 {errs} against the"
                                 f" float64-summed witness, band {MIXED_BAND}")
    say(phase, f"_MixedMatmul at {shapes}: value, gx and gW within "
               f"{worst:.3e} relative L2 of the float64-summed witness "
               f"(band {MIXED_BAND}), on {name}")
    return worst


def _permuted(batch, seed):
    """`presample_base(batch)` with each step's rows in a fixed permuted
    order: the same draws, summed in another order."""
    import normalizingflows_torch as nft

    perm = torch.randperm(batch, generator=torch.Generator().manual_seed(
        seed)).to(DEVICE)
    base = nft.presample_base(batch)
    return lambda gen, flow, chunk: base(gen, flow, chunk)[:, perm]


def phase_rnvp_wide_policy(name):
    """Phase 48, the slice's main path: wide RealNVP (d=128, [256,256]x10,
    remat, batch 4096, Adam(1e-3) on Banana(128, 1, 100);
    benchmarks/roofline.py:178-191) under the bf16 policy through the
    graphed `train_flow`, at full width: graphed then eagerly
    (POLICY_STEPS steps each on the same draws, identical bits strict, no
    K1-K6 launch), the policy's loss against the float32 run's from the
    same init and draws (`_policy_band`), steps/s in turns against float32,
    peak memory; the profile after every other phase."""
    import normalizingflows_torch as nft

    flag = _mm_flag_check(name)
    d, (h1, h2) = RNVP_WIDE["q0"], RNVP_WIDE["hdims"]
    flag["mixed_matmul_rel"] = _mixed_check(
        48, ((RNVP_WIDE_BATCH, d - d // 2, h1), (RNVP_WIDE_BATCH, h1, h2),
             (RNVP_WIDE_BATCH, h2, d // 2)), name)
    target = nft.Banana(RNVP_WIDE["q0"], 1.0, 100.0)

    def train(flow, graph, callback, scan_inputs=None):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(48),
            nft.elbo_from_samples, flow, target.log_prob,
            max_iters=POLICY_STEPS, check_every=POLICY_STEPS // 2,
            callback=callback, scan_inputs=scan_inputs or nft.presample_base(
                RNVP_WIDE_BATCH),
            optimizer=lambda p: torch.optim.Adam(p, lr=RNVP_WIDE_LR,
                                                 capturable=True),
            graph=graph)

    out = {"rnvp_wide_bf16": _graph_and_eager(
        48, "wide RealNVP, bf16 policy", lambda: _rnvp_wide(torch.bfloat16),
        train, POLICY_STEPS, {}, name)}
    runs = {p: _outcome(r["res"], r["flow"])
            for p, r in out["rnvp_wide_bf16"].items()}
    _agree(48, "wide RealNVP, bf16 policy", runs["graph"], runs["eager"],
           strict=True)
    out["identical"] = True
    f32 = _graph_and_eager(48, "wide RealNVP, float32",
                           lambda: _rnvp_wide(None), train, POLICY_STEPS, {},
                           name, eager_steps=POLICY_STEPS)
    band = _policy_band(48, "wide RealNVP", {
        "bf16": out["rnvp_wide_bf16"]["graph"]["res"].stats["loss"],
        "f32": f32["graph"]["res"].stats["loss"]})
    draws = nft.presample_base(RNVP_WIDE_BATCH)(
        torch.Generator(device=DEVICE).manual_seed(48), f32["graph"]["flow"],
        POLICY_STEPS // 2)[0]
    band["first_step"] = _first_step(
        48, "wide RealNVP", _rnvp_wide, target, draws, float(
            out["rnvp_wide_bf16"]["graph"]["res"].stats["gradient_norm"][0]))
    del draws
    band["f32_witness"] = _f32_witness(
        48, "wide RealNVP", lambda: _rnvp_wide(None), train,
        _permuted(RNVP_WIDE_BATCH, 48), f32["graph"]["res"].stats["loss"])

    def rate(flow, cb):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(49), nft.elbo_batch,
            flow, target.log_prob, RNVP_WIDE_BATCH,
            max_iters=3 * RATE_CHUNK, check_every=RATE_CHUNK, callback=cb,
            optimizer=lambda p: torch.optim.Adam(p, lr=RNVP_WIDE_LR))

    rates = _rates_in_turns(48, "wide RealNVP", _rnvp_wide, rate,
                            {"bf16": {}, "f32": {}}, name)
    peak = {k: r["graph"]["peak_mib"]
            for k, r in (("bf16", out["rnvp_wide_bf16"]), ("f32", f32))}

    def profiled(cd):
        return lambda p, cb: nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(50), nft.elbo_batch,
            _rnvp_wide(cd), target.log_prob, RNVP_WIDE_BATCH,
            max_iters=2 * p, check_every=p, callback=cb,
            optimizer=lambda q: torch.optim.Adam(q, lr=RNVP_WIDE_LR))

    return out, {"cell": "rnvp_wide_bf16", "numbers": {
        "mm": flag, "band": band, "graph_steady_in_turns": rates,
        "peak_mib_graph": peak},
        "profile": lambda: {
            "bf16": profile_cell(48, "wide RealNVP, bf16 policy", 10,
                                 profiled(torch.bfloat16), name),
            "f32": profile_cell(48, "wide RealNVP, float32", 10,
                                profiled(None), name)}}


def phase_nsf_wide_policy(gen, name):
    """Phase 49: NSF wide (d=64, [128,128]x10, K=10, identity init, batch
    4096; benchmarks/roofline.py:244-258) under the bf16 policy, with and
    without remat, graphed then eagerly on the same draws: K1 and K2 on
    bfloat16 raw (`_f32_rbf16`) 20 a step in every run, graphed against
    eager identical bits (strict), remat against no remat (reported), the
    loss against float32's from the same init and draws; steps/s of the
    remat flow in turns against float32; the MLE demo under the policy
    (K1 inverse and K3 on bfloat16 raw, 20 a step)."""
    import normalizingflows_torch as nft

    bf = torch.bfloat16
    target = nft.Banana(WIDE["q0"], 1.0, 100.0)
    per_step = {"bf16": dict.fromkeys(
        ("rqs_fwd_f32_rbf16", "rqs_bwd_fwddir_f32_rbf16"),
        2 * WIDE["nlayers"]),
        "f32": dict.fromkeys(("rqs_fwd", "rqs_bwd_fwddir"),
                             2 * WIDE["nlayers"])}

    def make(cd, remat=True):
        return nft.nsf(torch.Generator().manual_seed(3), remat=remat,
                       compute_dtype=cd, **WIDE)

    def train(flow, graph, callback):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(49),
            nft.elbo_from_samples, flow, target.log_prob,
            max_iters=WIDE_STEPS, check_every=WIDE_STEPS // 2,
            callback=callback, scan_inputs=nft.presample_base(WIDE_BATCH),
            optimizer=lambda p: torch.optim.Adam(p, lr=WIDE_LR,
                                                 capturable=True),
            graph=graph)

    out, runs = {}, {}
    for remat in (False, True):
        cell = "nsf_wide_bf16_remat" if remat else "nsf_wide_bf16"
        out[cell] = _graph_and_eager(
            49, f"NSF wide, bf16 policy, remat={remat}",
            lambda: make(bf, remat), train, WIDE_STEPS, per_step["bf16"],
            name)
        runs[cell] = {p: _outcome(r["res"], r["flow"])
                      for p, r in out[cell].items()}
        _agree(49, f"NSF wide, bf16 policy, remat={remat}",
               runs[cell]["graph"], runs[cell]["eager"], strict=True)
    out["identical"] = True
    remat_same = _agree(49, "NSF wide, bf16 policy",
                        runs["nsf_wide_bf16_remat"]["graph"],
                        runs["nsf_wide_bf16"]["graph"],
                        what="remat against no remat, graphed")
    f32 = _graph_and_eager(49, "NSF wide, float32, remat=True",
                           lambda: make(None), train, WIDE_STEPS,
                           per_step["f32"], name)
    band = _policy_band(49, "NSF wide", {
        "bf16": out["nsf_wide_bf16_remat"]["graph"]["res"].stats["loss"],
        "f32": f32["graph"]["res"].stats["loss"]})
    draws = nft.presample_base(WIDE_BATCH)(
        torch.Generator(device=DEVICE).manual_seed(49), f32["graph"]["flow"],
        WIDE_STEPS // 2)[0]
    band["first_step"] = _first_step(
        49, "NSF wide", make, target, draws, float(
            out["nsf_wide_bf16_remat"]["graph"]["res"].stats[
                "gradient_norm"][0]))
    del draws

    def rate(flow, cb):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(35), nft.elbo_batch,
            flow, target.log_prob, WIDE_BATCH, max_iters=3 * RATE_CHUNK,
            check_every=RATE_CHUNK, callback=cb,
            optimizer=lambda p: torch.optim.Adam(p, lr=WIDE_LR))

    rates = _rates_in_turns(49, "NSF wide (remat)", make, rate, per_step,
                            name)
    # the density path under the policy: K1 inverse and K3 on bf16 raw
    mle_target = nft.Banana(2, 1.0, 10.0)
    data = mle_target.sample(gen, (MLE_ROWS,)).cpu().numpy()
    flow = nft.nsf(torch.Generator().manual_seed(4), compute_dtype=bf,
                   **DEMO)
    reset_counts()
    res = nft.train_flow_mle(
        flow, nft.utils.data.make_loader(data, MLE_BATCH, dim=2, seed=4),
        max_iters=POLICY_MLE_STEPS, check_every=POLICY_MLE_STEPS // 2,
        optimizer=lambda p: torch.optim.Adam(p, lr=MLE_LR, capturable=True))
    mle_counts = expect_counts(
        "phase 49, MLE demo, bf16 policy",
        rqs_fwd_f32_rbf16=2 * DEMO["nlayers"] * POLICY_MLE_STEPS,
        rqs_bwd_invdir_f32_rbf16=2 * DEMO["nlayers"] * POLICY_MLE_STEPS)
    losses = res.stats["loss"]
    if not np.isfinite(losses).all():
        raise AssertionError("phase 49: the MLE demo's loss is not finite")
    say(49, f"MLE demo under the bf16 policy, {POLICY_MLE_STEPS} graphed "
            f"steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches "
            f"{ {k: v for k, v in mle_counts.items() if v} }, on {name}")
    return out, {"cell": "nsf_wide_bf16_remat", "numbers": {
        "remat_identical_bits": remat_same, "band": band,
        "graph_steady_in_turns": rates,
        "peak_mib_graph": {
            "bf16_remat": out["nsf_wide_bf16_remat"]["graph"]["peak_mib"],
            "bf16": out["nsf_wide_bf16"]["graph"]["peak_mib"],
            "f32_remat": f32["graph"]["peak_mib"]},
        "mle_counts": mle_counts},
        "profile": lambda: {
            "bf16": profile_cell(49, "NSF wide, remat, bf16 policy", 10,
                                 lambda p, cb: nft.train_flow(
                                     torch.Generator(device=DEVICE)
                                     .manual_seed(36), nft.elbo_batch,
                                     make(bf), target.log_prob, WIDE_BATCH,
                                     max_iters=2 * p, check_every=p,
                                     callback=cb,
                                     optimizer=lambda q: torch.optim.Adam(
                                         q, lr=WIDE_LR)), name)}}


def phase_bf16_params(gen, name):
    """Phase 50: bfloat16 parameters. `FlowConfig(dtype="bfloat16")` from
    JSON for each of BF16_FAMILIES through `TrainConfig.run`, BF16_STEPS
    graphed steps each: the launches (nsf: K1/K2 `_bf16`, and K1 inverse
    and K3 `_bf16` on the MLE path; fused realnvp: K4/K5 `_bf16`, one a
    step; none for the others), finite losses that fall (the mean of the
    last BF16_MEAN against the first), bfloat16 parameters after Adam, and
    a `save_pytree`/`load_pytree` round trip with identical bits."""
    import normalizingflows_torch as nft
    from normalizingflows_torch.utils import checkpoint

    L = BF16_NLAYERS
    want = {"nsf": dict(rqs_fwd_bf16=2 * L, rqs_bwd_fwddir_bf16=2 * L),
            "nsf_mle": dict(rqs_fwd_bf16=2 * L, rqs_bwd_invdir_bf16=2 * L),
            "realnvp_fused": dict(coupling_fwd_bf16=1, coupling_bwd_bf16=1)}
    target = nft.Banana(2, 1.0, 10.0)
    data = target.sample(gen, (MLE_ROWS,)).cpu().numpy()
    out, counts = {}, {}
    for label, family, fused, objective in BF16_FAMILIES:
        cfg = nft.config_from_json(nft.config_to_json(nft.TrainConfig(
            flow=nft.FlowConfig(family=family, dim=2, nlayers=L,
                                fused=fused, dtype="bfloat16", B=8.0),
            optimizer=nft.OptimizerConfig(learning_rate=1e-3),
            max_iters=BF16_STEPS, n_samples=64, batch_size=MLE_BATCH,
            objective=objective, check_every=BF16_STEPS // 4, seed=50)))
        reset_counts()
        res, dt, steady = _stamped(lambda cb: cfg.run(
            target.log_prob, data=data if objective == "mle" else None,
            callback=cb))
        counts[label] = expect_counts(
            f"phase 50, {label}",
            **{k: v * BF16_STEPS for k, v in want.get(label, {}).items()})
        losses = res.stats["loss"]
        first = float(losses[:BF16_MEAN].mean())
        last = float(losses[-BF16_MEAN:].mean())
        dtypes = {p.dtype for p in res.flow.parameters()}
        path = _exp_dir() / f"bf16_{label}.pt"
        checkpoint.save_pytree(str(path), res.flow)
        back = checkpoint.load_pytree(str(path), cfg.flow.build(
            torch.Generator().manual_seed(1)))
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(res.flow.state_dict().values(),
                                   back.state_dict().values()))
        say(50, f"{label} bfloat16 from JSON, {BF16_STEPS} graphed steps: "
                f"{steady:.1f} steps/s after the first chunk, loss {first:.4f}"
                f" -> {last:.4f} (means of {BF16_MEAN}), parameters {dtypes},"
                f" launches {({k: v for k, v in counts[label].items() if v})}"
                f", checkpoint round trip identical bits {same}, on {name}")
        if not (np.isfinite(losses).all() and last < first
                and dtypes == {torch.bfloat16} and same):
            raise AssertionError(f"phase 50, {label}: losses finite "
                                 f"{np.isfinite(losses).all()}, {first} -> "
                                 f"{last}, {dtypes}, round trip {same}")
        out[label] = dict(steady=steady, steps_per_s=BF16_STEPS / dt,
                          loss_first=first, loss_last=last,
                          identical_bits=same)
    return out, counts


def _policy_sampling(flow, name):
    """`sample_and_log_prob` at SAMPLE_BATCH rows under the policy, K4 once
    a call (samples/s over SAMPLE_REPS calls), and the round trip
    `log_prob(y)` through K4's inverse, once, against its value within the
    policy's elementwise bound (CPL_BF16_TOL's ld, JAX's 0.05): the
    inverse recovers each coupling's input to float32 roundoff, and a
    bfloat16 rounding of the next coupling's x_B can flip on it (on the
    card, 9 of 262,144 log-densities of the trained demo past float32's
    ROUND_TRIP_TOL)."""
    gen = torch.Generator(device=DEVICE).manual_seed(51)
    with torch.no_grad():
        flow.sample_and_log_prob(gen, (SAMPLE_BATCH,))  # warm
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(SAMPLE_REPS):
            y, lq = flow.sample_and_log_prob(gen, (SAMPLE_BATCH,))
        torch.cuda.synchronize()
        rate = SAMPLE_REPS * SAMPLE_BATCH / (time.perf_counter() - t0)
        expect_counts("phase 51, sampling under the policy",
                      coupling_fwd_f32_cbf16=SAMPLE_REPS)
        if y.shape != (SAMPLE_BATCH, 2) or not bool(torch.isfinite(y).all()):
            raise AssertionError("phase 51: samples are not finite "
                                 f"({SAMPLE_BATCH}, 2)")
        reset_counts()
        lp = flow.log_prob(y)
        expect_counts("phase 51, log_prob under the policy",
                      coupling_fwd_f32_cbf16=1)
    e = compare("phase 51: log_prob(y) vs sample_and_log_prob, bf16 policy",
                lp, lq, CPL_BF16_TOL["f32_cbf16"]["ld"])
    say(51, f"sample_and_log_prob under the policy, batch {SAMPLE_BATCH}, "
            f"{SAMPLE_REPS} calls (one K4 each): {rate:.4g} samples/s; the "
            f"round trip through K4's inverse: max abs err {e:.3e}, on "
            f"{name}")
    return {"samples_per_s": rate, "round_trip_err": e}


def phase_fused_policy(name):
    """Phase 51: the fused RealNVP demo under the bf16 policy
    (`realnvp(2, (16, 16), nlayers=3, fused=True,
    compute_dtype=bfloat16)`, Banana(2, 1, 100), 16 samples, Adam(5e-4)),
    RNVP_STEPS graphed steps and POLICY_FUSED_EAGER eager, one K4 and one
    K5 `_f32_cbf16` a step; graphed against eager on the same draws,
    identical bits (strict); the reference default under the policy
    ([32,32]x10, batch 256, the H = 32 tile), RNVP_REF_STEPS graphed and
    eager; `sample_and_log_prob` at SAMPLE_BATCH under the policy (K4 once
    a call) and its round trip; the demo's graphed steps/s in turns against
    the float32 fused demo; the profiles of the demo and the reference
    default under the policy after every other phase."""
    import normalizingflows_torch as nft

    target = nft.Banana(2, 1.0, 100.0)
    policy = dict(coupling_fwd_f32_cbf16=1, coupling_bwd_f32_cbf16=1)

    def make(cd=torch.bfloat16, cfg=RNVP_DEMO, seed=51):
        return nft.realnvp(torch.Generator().manual_seed(seed), fused=True,
                           compute_dtype=cd, **cfg)

    def train(flow, graph, callback):
        steps = RNVP_STEPS if graph else POLICY_FUSED_EAGER
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(51), nft.elbo_batch,
            flow, target.log_prob, RNVP_BATCH, max_iters=steps,
            check_every=100 if graph else steps // 2, callback=callback,
            optimizer=lambda p: torch.optim.Adam(p, lr=RNVP_LR), graph=graph)

    out = {"realnvp_demo_bf16": _graph_and_eager(
        51, "fused RealNVP demo, bf16 policy", make, train, RNVP_STEPS,
        policy, name, eager_steps=POLICY_FUSED_EAGER)}

    def same_inputs(flow, graph):
        return nft.train_flow(
            torch.Generator(device=DEVICE), nft.elbo_from_samples, flow,
            target.log_prob, max_iters=SAME_STEPS, check_every=SAME_CHECK,
            scan_inputs=nft.presample_base(RNVP_BATCH),
            optimizer=lambda p: torch.optim.Adam(p, lr=RNVP_LR,
                                                 capturable=True),
            graph=graph)

    out["identical"] = _same_inputs(51, "fused RealNVP demo, bf16 policy",
                                    make, same_inputs, SAME_STEPS,
                                    strict=True)
    losses = out["realnvp_demo_bf16"]["graph"]["res"].stats["loss"]
    if not losses[-100:].mean() < losses[:100].mean():
        raise AssertionError("phase 51: the loss did not fall")

    def train_ref(flow, graph, callback, steps=RNVP_REF_STEPS):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(52), nft.elbo_batch,
            flow, target.log_prob, RNVP_REF_BATCH, max_iters=steps,
            check_every=steps // 2, callback=callback,
            optimizer=lambda p: torch.optim.Adam(p, lr=RNVP_LR), graph=graph)

    out["realnvp_ref_bf16"] = _graph_and_eager(
        51, "reference default, bf16 policy",
        lambda: make(cfg=RNVP_REF, seed=52), train_ref, RNVP_REF_STEPS,
        policy, name)
    sampling = _policy_sampling(out["realnvp_demo_bf16"]["graph"]["flow"],
                                name)

    def rate(flow, cb):
        return nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(53), nft.elbo_batch,
            flow, target.log_prob, RNVP_BATCH,
            max_iters=3 * POLICY_RATE_CHUNK, check_every=POLICY_RATE_CHUNK,
            callback=cb, optimizer=lambda p: torch.optim.Adam(p, lr=RNVP_LR))

    rates = _rates_in_turns(
        51, "fused RealNVP demo", lambda cd: make(cd), rate,
        {"bf16": policy, "f32": dict(coupling_fwd=1, coupling_bwd=1)}, name,
        chunk=POLICY_RATE_CHUNK)

    def profiled(cfg, batch, seed):
        return lambda p, cb: nft.train_flow(
            torch.Generator(device=DEVICE).manual_seed(seed), nft.elbo_batch,
            make(cfg=cfg, seed=seed), target.log_prob, batch,
            max_iters=2 * p, check_every=p, callback=cb,
            optimizer=lambda q: torch.optim.Adam(q, lr=RNVP_LR))

    return out, {"cell": "realnvp_demo_bf16", "numbers": {
        "sampling": sampling, "graph_steady_in_turns": rates},
        "profile": lambda: {
            "demo": profile_cell(51, "fused RealNVP demo, bf16 policy", 100,
                                 profiled(RNVP_DEMO, RNVP_BATCH, 54), name),
            "ref": profile_cell(51, "reference default, bf16 policy", 20,
                                profiled(RNVP_REF, RNVP_REF_BATCH, 55),
                                name)}}


# ---------------------------------------------------------------------------
# K6 on the other targets and on bfloat16 parameters
# ---------------------------------------------------------------------------

def _k6_cases():
    """(model, batch, target) of phase 52: Funnel at every phase-18 shape,
    WarpedGauss (2-D) at the d=2 ones, WarpedGauss with ref_compat on the
    demo."""
    cases = []
    for model, batch in TRAIN_SHAPES:
        cases.append((model, batch, "funnel"))
        if CPL_CFG[model]["q0"] == 2:
            cases.append((model, batch, "warped"))
    return cases + [("demo", RNVP_BATCH, "warped_ref")]


def phase_train_targets(gen):
    """K6 against its plain version on Funnel and WarpedGauss, float32 and
    float64; identical bits on two runs and across chunk sizes. Returns
    the float32 demo's max abs error a target."""
    err, n_cmp = {}, 0
    for dtype in (torch.float32, torch.float64):
        for model, batch, kind in _k6_cases():
            _, args = _train_args(CPL_CFG[model], dtype, batch,
                                  TRAIN_CMP_STEPS, 52, gen, target=kind)
            e, n = _k6_against_plain(f"{str(dtype)[6:]} {model} batch "
                                     f"{batch} {kind}", args,
                                     TRAIN_TOL[dtype],
                                     witness=dtype == torch.float32)
            n_cmp += n
            if dtype == torch.float32 and model == "demo":
                err[kind] = e
    torch.cuda.synchronize()
    say(52, f"{n_cmp} K6-vs-plain comparisons within tolerance on Funnel "
            f"(every phase-18 shape) and WarpedGauss (d=2; ref_compat on the "
            f"demo), {TRAIN_CMP_STEPS} steps, float32 (against float64 where "
            f"elements fall outside TRAIN_TOL) and float64; identical bits on "
            f"two runs and in chunks of 8 against one launch")
    return err


def _whole_run(phase, label, cfg, dtype, kind, batch, steps, seed, gen,
               launches_name, rise=True):
    """`train_realnvp_fused` on a fused flow of ``cfg``: its launches
    counted (one per 512 steps) and, with ``rise``, the ELBO rising (the
    mean of the first 100 steps' loss against the last 100's); (counts,
    numbers)."""
    flow = _rnvp(cfg, seed, True, dtype)
    reset_counts()
    res, dt, launch_ms, launch_steps = _timed_train(
        flow, gen, _k6_target(kind, cfg["q0"]), batch, steps)
    counts = expect_counts(f"phase {phase}, {label}",
                           **{launches_name: -(-steps // 512)})
    losses = res.stats["loss"]
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    if rise and not last < first:
        raise AssertionError(f"{label}: the ELBO did not rise: {-first} -> "
                             f"{-last}")
    step_ms = sum(launch_ms) / steps
    bms, by = train_bound_ms(cfg, batch, launch_steps,
                             2 if dtype == torch.bfloat16 else 4)
    say(phase, f"train_realnvp_fused {label}: ELBO {-losses[0]:.4f} -> "
               f"{-losses[-1]:.4f} (mean of first 100 {-first:.4f}, last "
               f"100 {-last:.4f}); {steps} steps in {dt:.4f} s = "
               f"{steps / dt:.1f} steps/s; K6 launches of {launch_steps} "
               f"steps {launch_ms} ms (CUDA events) = {step_ms:.5f} ms a step "
               f"on the device, bound {bms:.3e} ms a step ({by}); launches "
               f"{ {k: v for k, v in counts.items() if v} }")
    return counts, {"ms": step_ms, "ms_per_launch": launch_ms,
                    "steps_per_s": steps / dt, "bound_ms": bms,
                    "bound_by": by, "elbo_first100": -first,
                    "elbo_last100": -last}


def phase_train_targets_main(name):
    """The slice's main path: the demo through train_realnvp_fused on the
    radial demo's WarpedGauss and the Hamiltonian demo's Funnel, then the
    reference default on each, then K6 against the eager step on each."""
    gen = torch.Generator(device=DEVICE).manual_seed(530)
    counts, out = {}, {}
    for kind in ("warped", "funnel"):
        counts[kind], out[kind] = _whole_run(
            53, f"demo {kind}", RNVP_DEMO, torch.float32, kind, RNVP_BATCH,
            RNVP_STEPS, 0, gen, "realnvp_train")
        _, ref = _whole_run(53, f"reference default {kind}, batch "
                                f"{RNVP_REF_BATCH}", RNVP_REF, torch.float32,
                            kind, RNVP_REF_BATCH, TRAIN_REF_STEPS, 50, gen,
                            "realnvp_train", rise=False)
        out[kind].update({f"ref_{k}": ref[k] for k in
                          ("ms", "steps_per_s", "bound_ms", "bound_by")})
        out[kind]["first_loss_rel"], out[kind]["trajectory"] = (
            _k6_against_eager(53, f"f32 {kind}", torch.float32, kind, 33,
                              gen, (FIRST_LOSS_REL, TRAJECTORY_REL),
                              ("realnvp_train", "coupling_fwd",
                               "coupling_bwd")))
    say(53, f"on {name}")
    return counts, out


def phase_train_bf16(gen, name):
    """K6 in bfloat16: against its plain version, twice and in chunks with
    identical bits; the bfloat16 demo through train_realnvp_fused, its
    device time in turns with the float32 demo's; against the eager
    bfloat16 step. Returns (the demo's launch counts, its kernels-line
    numbers, the float32 demo's device time beside it)."""
    from normalizingflows_torch.experimental import train_cuda as tc

    err = {}
    for model, batch in (("demo", RNVP_BATCH), ("ref", RNVP_REF_BATCH)):
        _, args = _train_args(CPL_CFG[model], torch.bfloat16, batch,
                              TRAIN_CMP_STEPS, 54, gen)
        err[model], _ = _k6_against_plain(f"bf16 {model} batch {batch}",
                                          args, TRAIN_BF16_TOL)
    torch.cuda.synchronize()
    say(54, f"realnvp_train_bf16 against its plain version within "
            f"{TRAIN_BF16_TOL} (demo batch {RNVP_BATCH}, reference default "
            f"batch {RNVP_REF_BATCH}, {TRAIN_CMP_STEPS} steps), max abs "
            f"{err}; identical bits on two runs and in chunks of 8")
    _, args = _train_args(RNVP_DEMO, torch.bfloat16, RNVP_BATCH, 10, 55, gen)
    plain_ms = device_ms(lambda: tc.adam_train_plain(*args), reps=5,
                         inner=2) / 10
    # the bfloat16 demo, in turns with the float32 one: f32, bf16, bf16, f32
    runs = {torch.float32: [], torch.bfloat16: []}
    counts = None
    for dtype in (torch.float32, torch.bfloat16, torch.bfloat16,
                  torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        c, r = _whole_run(54, f"demo {tag} banana", RNVP_DEMO, dtype,
                          "banana", RNVP_BATCH, RNVP_STEPS, 0,
                          torch.Generator(device=DEVICE).manual_seed(540),
                          "realnvp_train_bf16" if tag == "bf16"
                          else "realnvp_train")
        runs[dtype].append(r)
        if tag == "bf16":
            counts = c
    first, traj = _k6_against_eager(
        54, "bf16 banana", torch.bfloat16, "banana", 33, gen,
        (BF16_FIRST_LOSS_REL, BF16_TRAJECTORY_REL),
        ("realnvp_train_bf16", "coupling_fwd_bf16", "coupling_bwd_bf16"))
    bf, f32 = runs[torch.bfloat16], runs[torch.float32]
    say(54, f"K6 a demo step in turns (f32, bf16, bf16, f32): bf16 "
            f"{[r['ms'] for r in bf]} ms against f32 "
            f"{[r['ms'] for r in f32]} ms; adam_train_plain bf16 "
            f"{plain_ms:.5f} ms a step, on {name}")
    numbers = dict(bf[0], err=err["demo"], plain_ms=plain_ms,
                   ms_in_turns=[r["ms"] for r in bf],
                   f32_ms_in_turns=[r["ms"] for r in f32],
                   ref_max_abs_err=err["ref"], first_loss_rel=first,
                   trajectory=traj)
    return counts, numbers


# ---------------------------------------------------------------------------
# The sharded path (parallel/) and the multi-rank checkpoint
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one_rank_mesh():
    """Phases 55-56's group: one NCCL rank started through the launcher's
    NF_* path (once; `initialize` returns if a group runs), and its batch
    mesh. The variables are set only around the call."""
    from normalizingflows_torch import parallel

    env = {"NF_COORDINATOR": f"localhost:{_free_port()}",
           "NF_NUM_PROCESSES": "1", "NF_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        parallel.initialize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"the group is {dist.get_backend()} of "
                             f"{dist.get_world_size()} ranks, not one NCCL "
                             "rank")
    return parallel.batch_mesh()


def _sharded_turns(phase, label, make, target, batch, steps, lr, check,
                   per_step, mesh, name):
    """``make()``'s flow trained by the graphed `train_flow` with
    `shard_objective(elbo_batch, mesh)` from `per_shard_key(phase)` and
    unwrapped (`elbo_batch`) from a generator in the same state, in turns
    (sharded, unwrapped, unwrapped, sharded): every run's losses, gradient
    norms and final parameters equal the first sharded run's bit for bit
    (strict); each run launches ``per_step`` kernels a step by replay
    (equal counts) with one capture. Returns the steps/s of each path
    after the first chunk and the counts."""
    import normalizingflows_torch as nft
    from normalizingflows_torch import parallel
    from normalizingflows_torch.ops import launches

    objectives = {"sharded": parallel.shard_objective(nft.elbo_batch, mesh),
                  "unwrapped": nft.elbo_batch}
    rates = {"sharded": [], "unwrapped": []}
    first, counts = None, {}
    for path in ("sharded", "unwrapped", "unwrapped", "sharded"):
        flow = make()
        reset_counts()
        res, _, steady = _stamped(lambda cb: nft.train_flow(
            parallel.per_shard_key(phase), objectives[path], flow,
            target.log_prob, batch, max_iters=steps, check_every=check,
            callback=cb, optimizer=lambda p: torch.optim.Adam(p, lr=lr)))
        counts[path] = expect_counts(
            f"phase {phase}, {label}, {path}",
            **{k: n * steps for k, n in per_step.items()})
        if launches.captures() != 1:
            raise AssertionError(f"phase {phase}, {label}, {path}: "
                                 f"{launches.captures()} captures")
        rates[path].append(steady)
        run = (res.stats["loss"], res.stats["gradient_norm"],
               [p.detach().clone() for p in flow.parameters()])
        if first is None:
            first = run
            if not np.isfinite(run[0]).all():
                raise AssertionError(f"phase {phase}, {label}: non-finite "
                                     "losses")
            continue
        differ = {
            what: float(np.max(np.abs(a - b))) for what, a, b in (
                ("losses", run[0], first[0]),
                ("gradient norms", run[1], first[1]),
                ("parameters", *(torch.cat([t.reshape(-1) for t in r[2]])
                                 .double().cpu().numpy()
                                 for r in (run, first))))
            if not np.array_equal(a, b)}
        if differ:
            raise AssertionError(f"phase {phase}, {label}: the {path} run "
                                 "differs from the sharded run's bits "
                                 f"(max abs difference) {differ}")
    say(phase, f"{label}, {steps} graphed steps, sharded over one NCCL rank "
               f"and unwrapped from generators in the same state: losses, "
               f"gradient norms and final parameters identical bits in all "
               f"four runs; launches a step {per_step or 'none'} on both "
               f"paths, by replay, one capture each; steps/s after the first"
               f" chunk in turns (sharded, unwrapped, unwrapped, sharded): "
               f"sharded {rates['sharded'][0]:.1f}, {rates['sharded'][1]:.1f};"
               f" unwrapped {rates['unwrapped'][0]:.1f}, "
               f"{rates['unwrapped'][1]:.1f}; loss {first[0][0]:.4f} -> "
               f"{first[0][-1]:.4f}, on {name}")
    return {"steps_per_s_sharded": rates["sharded"],
            "steps_per_s_unwrapped": rates["unwrapped"],
            "counts": counts["sharded"]}


def _sharded_profile(phase, label, p, make, target, batch, lr, mesh, name):
    """`profile_cell` of the sharded and the unwrapped cell: kernels a step
    of the replay, the kernels the sharded step adds (by name, a step),
    the collectives' own kernels (NCCL's) and their device ms a step."""
    import normalizingflows_torch as nft
    from normalizingflows_torch import parallel

    out = {}
    for path, objective in (
            ("sharded", parallel.shard_objective(nft.elbo_batch, mesh)),
            ("unwrapped", nft.elbo_batch)):
        out[path] = profile_cell(phase, f"{label} {path}", p, (
            lambda q, cb, objective=objective: nft.train_flow(
                parallel.per_shard_key(phase), objective, make(),
                target.log_prob, batch, max_iters=2 * q, check_every=q,
                callback=cb, optimizer=lambda r: torch.optim.Adam(r, lr=lr))),
            name, by_name=True)
    s, u = out["sharded"]["by_name"], out["unwrapped"]["by_name"]
    added = {k: (round(s[k][0] - u.get(k, (0, 0))[0], 3),
                 round(s[k][1] - u.get(k, (0, 0))[1], 5))
             for k in s if s[k][0] != u.get(k, (0, 0))[0]}
    nccl = {k: v for k, v in s.items() if "nccl" in k.lower()}
    nccl_ms = sum(v[1] for v in nccl.values())
    added_ms = sum(v[1] for v in added.values())
    busy = {k: r["device_busy_ms_per_step"] for k, r in out.items()}
    say(phase, f"{label}: the sharded step runs "
               f"{out['sharded']['kernels_per_step']:.1f} kernels a step "
               f"against {out['unwrapped']['kernels_per_step']:.1f} "
               f"unwrapped; busy {busy['sharded']:.4f} against "
               f"{busy['unwrapped']:.4f} ms a step; added (name: a step, "
               f"ms a step) {added}, {added_ms:.5f} ms a step in all; "
               f"the collectives' (NCCL's) kernels {nccl or 'none'}, "
               f"{nccl_ms:.5f} ms a step, on {name}")
    return {path: {k: r[k] for k in PROFILE_KEYS} for path, r in
            out.items()} | {"added_kernels": added,
                            "added_ms_per_step": added_ms,
                            "collective_kernels": nccl,
                            "collective_ms_per_step": nccl_ms}


def phase_sharded_main(name):
    """The slice's main path: `train_flow` with the sharded objective on
    one NCCL rank, graphed, on the NSF demo and the fused RealNVP demo,
    against the unwrapped run (`_sharded_turns`). The profile is returned
    as a closure, run after every rate of the call."""
    import normalizingflows_torch as nft

    mesh = _one_rank_mesh()
    banana = nft.Banana(2, 1.0, 100.0)
    nsf_step = dict.fromkeys(("rqs_fwd", "rqs_bwd_fwddir"),
                             2 * DEMO["nlayers"])
    rnvp_step = dict(coupling_fwd=1, coupling_bwd=1)
    out = {
        "nsf_demo": _sharded_turns(55, "NSF demo", _demo_flow, banana,
                                   DEMO_BATCH, DEMO_STEPS, DEMO_LR, 100,
                                   nsf_step, mesh, name),
        "realnvp_demo": _sharded_turns(
            55, "fused RealNVP demo", lambda: _rnvp(RNVP_DEMO, 0, True),
            banana, RNVP_BATCH, RNVP_STEPS, RNVP_LR, 100, rnvp_step, mesh,
            name)}

    def profile():
        return {
            "nsf_demo": _sharded_profile(55, "NSF demo", 50, _demo_flow,
                                         banana, DEMO_BATCH, DEMO_LR, mesh,
                                         name),
            "realnvp_demo": _sharded_profile(
                55, "fused RealNVP demo", 100,
                lambda: _rnvp(RNVP_DEMO, 0, True), banana, RNVP_BATCH,
                RNVP_LR, mesh, name)}

    out["profile"] = profile
    return out


def phase_sharded_wide(name):
    """NSF wide through the wrapper, graphed, against the unwrapped run bit
    for bit; then `sample_sharded` of the NSF demo flow at SAMPLE_BATCH
    rows on the one rank, against `flow.sample` from a generator in the
    same state."""
    import normalizingflows_torch as nft
    from normalizingflows_torch import parallel

    mesh = _one_rank_mesh()
    per_step = dict.fromkeys(("rqs_fwd", "rqs_bwd_fwddir"),
                             2 * WIDE["nlayers"])
    out = {"nsf_wide": _sharded_turns(
        56, "NSF wide", lambda: nft.nsf(torch.Generator().manual_seed(3),
                                        **WIDE),
        nft.Banana(WIDE["q0"], 1.0, 100.0), WIDE_BATCH, WIDE_STEPS,
        WIDE_LR, WIDE_STEPS // 2, per_step, mesh, name)}
    flow = _perturbed(_demo_flow())
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys = parallel.sample_sharded(flow, parallel.per_shard_key(56),
                                     SAMPLE_BATCH, mesh)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = expect_counts("phase 56, sample_sharded",
                               rqs_fwd=2 * DEMO["nlayers"])
        want = flow.sample(parallel.per_shard_key(56), (SAMPLE_BATCH,))
    local = ys.to_local()
    if (tuple(ys.shape) != (SAMPLE_BATCH, 2)
            or [str(p) for p in ys.placements] != ["S(0)"]
            or tuple(local.shape) != (SAMPLE_BATCH, 2)
            or not bool(torch.isfinite(local).all())
            or not torch.equal(local, want)):
        raise AssertionError(f"phase 56: sample_sharded gave {ys.shape} "
                             f"placed {ys.placements}, local "
                             f"{tuple(local.shape)}, not finite rows equal "
                             "to flow.sample's")
    say(56, f"sample_sharded of the NSF demo flow: global shape "
            f"{tuple(ys.shape)} placed {list(ys.placements)}, finite, equal "
            f"to flow.sample from the same generator state; {ms:.2f} ms on "
            f"the host clock (the first call); launches {counts}, on {name}")
    out["sample"] = {"ms": ms, "counts": counts}
    return out


# Phases 57-58's ranks: RANKS processes sharing the one card through gloo,
# all killed once RANK_TIMEOUT seconds have passed; the first step of the
# sharded objective against one rank's on the same shared rows within
# FIRST_RANK_TOL, the relative L2 error of the value and of each gradient
# leaf (`_rel`: the two sum in different orders).
RANKS, RANK_TIMEOUT, RANK_STEPS, FIRST_RANK_TOL = 2, 300, 20, 1e-5
_RANK_MAIN = ("import sys, chip_smoke; "
              "sys.exit(chip_smoke.rank_worker(sys.argv[1:]))")


def _rank_train(mesh, out: dict):
    """Phase 57 in one rank: the first step on shared rows, 20 eager steps
    of the NSF demo through the sharded objective, sample_sharded."""
    import normalizingflows_torch as nft
    from normalizingflows_torch import parallel

    target = nft.Banana(2, 1.0, 100.0)
    rank = mesh.get_local_rank()
    draws = torch.from_numpy(np.random.default_rng(57).standard_normal(
        (DEMO_BATCH, 2)).astype(np.float32)).to(DEVICE)

    def rows(generator, flow, logp, n):
        return nft.elbo_from_samples(draws[rank * n:(rank + 1) * n], flow,
                                     logp)

    flow = _perturbed(_demo_flow())
    grads = {}
    for path, fn in (
            ("sharded", lambda: parallel.shard_objective(rows, mesh)(
                None, flow, target.log_prob, DEMO_BATCH)),
            ("one_rank", lambda: nft.elbo_from_samples(draws, flow,
                                                       target.log_prob))):
        flow.zero_grad(set_to_none=True)
        value = fn()
        value.backward()
        grads[path] = (value.detach(), {n: p.grad.clone() for n, p in
                                        flow.named_parameters()
                                        if p.grad is not None})
    (vs, gs), (v1, g1) = grads["sharded"], grads["one_rank"]
    if set(gs) != set(g1):
        raise AssertionError("the sharded and one-rank steps differ in "
                             "which parameters got gradients")
    out["first_value_rel"] = _rel([vs], [v1])
    out["first_grad_rel"] = max(_rel([gs[k]], [g1[k]]) for k in g1)

    flow = _demo_flow()
    reset_counts()
    res = nft.train_flow(
        parallel.per_shard_key(57, mesh),
        parallel.shard_objective(nft.elbo_batch, mesh), flow,
        target.log_prob, DEMO_BATCH, max_iters=RANK_STEPS, check_every=10,
        optimizer=lambda p: torch.optim.Adam(p, lr=DEMO_LR), graph=False)
    torch.cuda.synchronize()
    out["train_counts"] = json.dumps(all_counts())
    out["loss"] = res.stats["loss"]
    out["gradient_norm"] = res.stats["gradient_norm"]
    for i, p in enumerate(flow.parameters()):
        out[f"param{i}"] = p.detach().cpu().numpy()
    with torch.no_grad():
        reset_counts()
        ys = parallel.sample_sharded(flow, parallel.per_shard_key(570, mesh),
                                     SAMPLE_BATCH, mesh)
        torch.cuda.synchronize()
    local = ys.to_local()
    out["sample_counts"] = json.dumps(all_counts())
    out["sample_shape"] = np.asarray(ys.shape)
    out["sample_local_shape"] = np.asarray(local.shape)
    out["sample_placements"] = json.dumps([str(p) for p in ys.placements])
    out["sample_finite"] = np.asarray(bool(torch.isfinite(local).all()))
    out["sample_head"] = local[:1024].cpu().numpy()


def _rank_checkpoint(mesh, directory: Path, out: dict):
    """Phase 58 in one rank: the NSF demo flow and a [Shard(0)] DTensor of
    SAMPLE_BATCH samples through save_pytree(backend="dcp"), a barrier,
    and load_pytree into a template of another seed."""
    import hashlib

    from torch.distributed.tensor import DTensor

    from normalizingflows_torch import parallel
    from normalizingflows_torch.utils import checkpoint as ckpt

    flow = _perturbed(_demo_flow())
    with torch.no_grad():
        ys = parallel.sample_sharded(flow, parallel.per_shard_key(58, mesh),
                                     SAMPLE_BATCH, mesh)
    path = str(directory / "dcp58")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_pytree(path, {"flow": flow, "samples": ys}, backend="dcp")
    out["save_ms"] = 1e3 * (time.perf_counter() - t0)
    parallel.barrier()
    template = {"flow": _demo_flow(seed=42),
                "samples": DTensor.from_local(
                    torch.zeros_like(ys.to_local()),
                    *parallel.batch_sharding(mesh), shape=ys.shape,
                    stride=ys.stride())}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = ckpt.load_pytree(path, template, backend="dcp")
    torch.cuda.synchronize()
    out["load_ms"] = 1e3 * (time.perf_counter() - t0)
    got = loaded["samples"]
    out["shard_equal"] = np.asarray(
        got is template["samples"] and torch.equal(got.to_local(),
                                                   ys.to_local())
        and got.placements == ys.placements)
    digest = hashlib.sha256()
    same = True
    for (k, a), b in zip(flow.state_dict().items(),
                         loaded["flow"].state_dict().values()):
        same = same and torch.equal(a, b)
        digest.update(b.detach().cpu().numpy().tobytes())
    out["params_equal"] = np.asarray(same)
    out["checksum"] = digest.hexdigest()
    parallel.barrier()
    out["bytes"] = sum(f.stat().st_size for f in Path(path).rglob("*")
                       if f.is_file())


def rank_worker(argv) -> int:
    """One of phases 57-58's ranks, spawned by `phase_two_ranks` as
    ``python -c _RANK_MAIN PORT WORLD RANK DIR PHASES``: joins the gloo
    group through the launcher (tcp://localhost:PORT), runs its phases on
    the card and writes its results to DIR/rank{RANK}.npz."""
    from normalizingflows_torch import parallel

    port, world, rank, directory, phases = argv
    directory = Path(directory)
    torch.cuda.set_device(0)  # every rank on the one card
    parallel.initialize(f"localhost:{port}", int(world), int(rank),
                        device="cpu")
    try:
        mesh = parallel.batch_mesh()
        out = {}
        if "57" in phases.split(","):
            _rank_train(mesh, out)
        if "58" in phases.split(","):
            _rank_checkpoint(mesh, directory, out)
        np.savez(directory / f"rank{rank}.npz", **out)
        parallel.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_two_ranks(phases, name):
    """Phases 57-58: RANKS gloo ranks on the one card, spawned after the
    parent builds the kernels (the ranks load build/torch_kernels/). 57:
    the ranks agree bit for bit on every loss, gradient norm and final
    parameter of 20 eager sharded NSF demo steps (K1/K2 20 a step in each
    rank), the first step matches one rank's on the same rows, and the
    ranks' sample blocks differ; 58: the DCP round trip."""
    from normalizingflows_torch.ops import _build

    _build.library()
    directory = _exp_dir() / "ranks"
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    port = _free_port()
    wanted = ",".join(str(p) for p in (57, 58) if p in phases)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_MAIN, str(port), str(RANKS), str(r),
         str(directory), wanted], cwd=Path(__file__).resolve().parent,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)]
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=max(
                    1.0, RANK_TIMEOUT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phases {wanted}: the ranks ran past "
                                     f"{RANK_TIMEOUT} s") from None
            if p.returncode != 0:
                raise AssertionError(f"phases {wanted}: rank {r} exited "
                                     f"{p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    ranks = [dict(np.load(directory / f"rank{r}.npz")) for r in range(RANKS)]
    out = {"seconds": seconds}
    if 57 in phases:
        out["train"] = _check_two_ranks_train(ranks, name)
    if 58 in phases:
        out["checkpoint"] = _check_two_ranks_checkpoint(ranks, name)
    return out


def _check_two_ranks_train(ranks, name) -> dict:
    want = 2 * DEMO["nlayers"]
    for r, d in enumerate(ranks):
        counts = json.loads(str(d["train_counts"]))
        full = {k: 0 for k in counts} | {"rqs_fwd": want * RANK_STEPS,
                                         "rqs_bwd_fwddir": want * RANK_STEPS}
        if counts != full:
            raise AssertionError(f"phase 57, rank {r}: launches {counts}, "
                                 f"expected {full}")
        sample = json.loads(str(d["sample_counts"]))
        if sample != {k: 0 for k in sample} | {"rqs_fwd": want}:
            raise AssertionError(f"phase 57, rank {r}: sample_sharded "
                                 f"launched {sample}")
        if (tuple(d["sample_shape"]) != (SAMPLE_BATCH, 2)
                or tuple(d["sample_local_shape"]) != (SAMPLE_BATCH // RANKS,
                                                      2)
                or json.loads(str(d["sample_placements"])) != ["S(0)"]
                or not bool(d["sample_finite"])):
            raise AssertionError(f"phase 57, rank {r}: sample_sharded gave "
                                 f"{d['sample_shape']} placed "
                                 f"{d['sample_placements']}, local "
                                 f"{d['sample_local_shape']}")
        for k in ("first_value_rel", "first_grad_rel"):
            if not float(d[k]) <= FIRST_RANK_TOL:
                raise AssertionError(f"phase 57, rank {r}: {k} "
                                     f"{float(d[k]):.3e} against one rank's "
                                     f"step on the same rows")
        if not np.isfinite(d["loss"]).all():
            raise AssertionError(f"phase 57, rank {r}: non-finite losses")
    keys = [k for k in ranks[0] if k in ("loss", "gradient_norm")
            or k.startswith("param")]
    for d in ranks[1:]:
        for k in keys:
            if not np.array_equal(ranks[0][k], d[k]):
                raise AssertionError(f"phase 57: the ranks differ in {k}")
    if np.array_equal(ranks[0]["sample_head"], ranks[1]["sample_head"]):
        raise AssertionError("phase 57: the ranks' sample blocks are equal")
    first = {k: max(float(d[k]) for d in ranks)
             for k in ("first_value_rel", "first_grad_rel")}
    say(57, f"{RANKS} gloo ranks on one card, NSF demo, elbo_batch "
            f"{DEMO_BATCH} ({DEMO_BATCH // RANKS} a rank), {RANK_STEPS} eager "
            f"steps: losses, gradient norms and {len(keys) - 2} parameters "
            f"identical bits in both ranks, loss {ranks[0]['loss'][0]:.4f} -> "
            f"{ranks[0]['loss'][-1]:.4f}; K1 and K2 {2 * DEMO['nlayers']} a "
            f"step in each rank; the first step against one rank's on the "
            f"same {DEMO_BATCH} rows: value {first['first_value_rel']:.2e}, "
            f"gradients {first['first_grad_rel']:.2e} relative (limit "
            f"{FIRST_RANK_TOL}); sample_sharded {SAMPLE_BATCH} rows placed "
            f"[S(0)], {SAMPLE_BATCH // RANKS} a rank, the blocks differ; on "
            f"{name}")
    return first


def _check_two_ranks_checkpoint(ranks, name) -> dict:
    for r, d in enumerate(ranks):
        if not (bool(d["shard_equal"]) and bool(d["params_equal"])):
            raise AssertionError(f"phase 58, rank {r}: the loaded shard or "
                                 "parameters differ from the saved ones")
    if len({str(d["checksum"]) for d in ranks}) != 1:
        raise AssertionError("phase 58: the ranks' checksums differ")
    out = {"bytes": int(ranks[0]["bytes"]),
           "save_ms": [float(d["save_ms"]) for d in ranks],
           "load_ms": [float(d["load_ms"]) for d in ranks]}
    say(58, f"DCP round trip over {RANKS} gloo ranks of the NSF demo flow and"
            f" a [Shard(0)] DTensor of {SAMPLE_BATCH} samples: every local "
            f"shard and parameter restored bit for bit into a template of "
            f"another seed, checksums equal ({str(ranks[0]['checksum'])[:16]}"
            f"); {out['bytes']} bytes; save {out['save_ms']} ms, load "
            f"{out['load_ms']} ms by rank (host clock), on {name}")
    return out


def graph_cells(phase: int, out: dict) -> dict:
    """A graphed phase's cells as numbers: steps/s graphed and eager,
    after the first chunk and overall, peak MiB, and whether graphed and
    eager agreed bit for bit on the same inputs."""
    cells = {}
    for cell, runs in out.items():
        if cell == "identical":
            continue
        cells[f"{cell}_{phase}"] = {
            f"{path}_{key}": runs[path][key] for path in ("graph", "eager")
            for key in ("steady", "steps_per_s", "peak_mib", "held_mib")}
        cells[f"{cell}_{phase}"]["identical_bits"] = out["identical"]
    return cells


def selected_phases(argv=None) -> set:
    """The phases a command line asks for, with phase 1 and the phases
    whose results a selected one takes: 7 takes 5's flow, 15 takes 14's,
    31 takes 27's and 28's."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", type=parse_phases, default=ALL_PHASES,
                        help="phases to run, e.g. 1,2,12,18-21 (default: "
                             "all)")
    phases = set(parser.parse_args(argv).phases) | {1}
    phases |= {5} if 7 in phases else set()
    phases |= {14} if 15 in phases else set()
    phases |= {27, 28} if 31 in phases else set()
    return phases


def main(argv=None) -> int:
    phases = selected_phases(argv)
    t_start = time.perf_counter()
    smi = phase_device()
    import normalizingflows_torch  # noqa: F401  (fails outside a checkout)

    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    if 2 in phases:
        report, estimate, hmma = phase_build()
    if 3 in phases:
        kernels = phase_kernels(gen)
    if 4 in phases:
        phase_same_step(gen)
    if 5 in phases:
        flow, elbo_launches = phase_main_path(gen, name)
    if 6 in phases:
        phase_wide(gen, name)
    if 7 in phases:
        phase_round_trip(flow, gen)
    if 8 in phases:
        phase_loglikelihood(gen)
    if 9 in phases:
        phase_stl()
    if 10 in phases:
        mle_launches = phase_mle(gen, name)
    if 11 in phases:
        phase_mle_wide(gen, name)
    if 12 in phases:
        cpl = phase_coupling_kernels(gen)
    if 13 in phases:
        phase_rnvp_same_step(gen)
    rnvp_summary = None
    if 14 in phases:
        rnvp_flows, rnvp_launches, rnvp_summary = phase_rnvp_main(name)
    if 15 in phases:
        phase_rnvp_sampling(rnvp_flows, gen, name)
    if 16 in phases:
        phase_rnvp_ref(gen, name)
    if 17 in phases:
        phase_rnvp_wide(gen, name)
    if 18 in phases:
        train = phase_train_kernel(gen)
    if 19 in phases:
        phase_train_vs_eager(gen)
    if 20 in phases:
        train_launches, train_main = phase_train_main(name, rnvp_summary)
    if 21 in phases:
        graph = phase_graph_step(name)
    graphed = {}  # phases 22-24's cells
    if 22 in phases:
        graphed[22] = phase_graph_elbo(gen, name)
    if 23 in phases:
        graphed[23] = phase_graph_mle(gen, name)
    if 24 in phases:
        graphed[24] = phase_graph_rnvp(
            name, k6=train_main["steps_per_s"] if 20 in phases else None,
            yardstick=graph["graph_steps_per_s"] if 21 in phases else None)
    if 25 in phases:
        annealed = phase_annealed(gen, name)
    classic = {}  # phases 27-29's cells and their ELBOs
    for phase, kind in CLASSIC_KINDS.items():
        if phase in phases:
            classic[phase] = phase_classic(phase, kind, name)
    if 30 in phases:
        double = phase_double_backward(name)
    if 31 in phases:
        phase_classic_round_trip(
            {CLASSIC_KINDS[p]: classic[p][0]["demo"]["graph"]["flow"]
             for p in (27, 28)}, name)
    zoo = {}  # phases 32-37's cells and their numbers
    if 32 in phases:
        zoo[32] = phase_nsf_wrap(gen, name)
    if 33 in phases:
        zoo[33] = phase_nsf_wide_remat(name)
    if 34 in phases:
        zoo[34] = phase_nsf_mle_remat(gen, name)
    for phase, kind in ZOO_KINDS.items():
        if phase in phases:
            zoo[phase] = phase_zoo(phase, kind, gen, name)
    experiment, exp_counts = {}, {}  # phases 38-42
    if 38 in phases:
        (experiment["nsf_wide_resume_38"],
         exp_counts["nsf_wide_config_graph"]) = phase_exp_resume(name)
    if 39 in phases:
        (experiment["rnvp_config_39"],
         exp_counts["realnvp_config_graph"]) = phase_exp_fused(gen, name)
    if 40 in phases:
        (experiment["mle_wide_raw_40"],
         exp_counts["mle_wide_raw_graph"]) = phase_exp_mle_raw(gen, name)
    if 42 in phases:
        experiment["sgd_42"] = phase_exp_sgd(name)
    if 43 in phases:
        schedule, sched_counts, sched_profile = phase_schedule(name)
    if 44 in phases:
        demos = phase_demos(name)
    if 45 in phases:
        parity_rows, parity_seconds = phase_parity_quick(name)
    bf16 = {}  # phases 48, 49 and 51's cells and their numbers
    if 46 in phases:
        rqs16 = phase_rqs_bf16(gen)
    if 47 in phases:
        cpl16 = phase_coupling_bf16(gen)
    if 48 in phases:
        bf16[48] = phase_rnvp_wide_policy(name)
    if 49 in phases:
        bf16[49] = phase_nsf_wide_policy(gen, name)
    if 50 in phases:
        params16, params16_counts = phase_bf16_params(gen, name)
    if 51 in phases:
        bf16[51] = phase_fused_policy(name)
    k6 = {}  # phases 52-54
    if 52 in phases:
        k6["err_by_target"] = phase_train_targets(gen)
    if 53 in phases:
        k6_counts, k6["by_target"] = phase_train_targets_main(name)
    if 54 in phases:
        k6_bf16_counts, train16 = phase_train_bf16(gen, name)
        k6["bf16"] = train16
    sharded = {}  # phases 55-58
    if 55 in phases:
        sharded["main"] = phase_sharded_main(name)
    if 56 in phases:
        sharded["wide"] = phase_sharded_wide(name)
    if 57 in phases or 58 in phases:
        sharded["ranks"] = phase_two_ranks(phases, name)
    if 41 in phases:  # its trace is a profiler run: after the rates
        experiment["profiling_41"] = phase_exp_profiling(
            gen, name, graphed[22]["demo"]["graph"]["steady"]
            if 22 in phases else None)
    # the profiles last: a profiler run slows the host's launches after it
    if 26 in phases:
        profiled = phase_graph_profile(gen, name)
    for phase, (_, info) in classic.items():
        info["profiled"] = info.pop("profile")()
    if 30 in phases and double["captured"]:
        double["profiled"] = double.pop("profile")()
    for phase, (_, info) in zoo.items():
        if "profile" in info:
            info["profiled"] = info.pop("profile")()
    if 43 in phases:
        schedule["profiled"] = {k: v for k, v in sched_profile().items()
                                if k in PROFILE_KEYS}
    if 55 in phases:
        sharded["main"]["profiled"] = sharded["main"].pop("profile")()
    if dist.is_initialized():  # phases 55-56's one NCCL rank
        dist.destroy_process_group()
    for phase, (_, info) in bf16.items():
        info["profiled"] = {
            k: {key: r[key] for key in PROFILE_KEYS + (
                "kernels_per_step_by_category", "top_kernels")}
            for k, r in info.pop("profile")().items()}
    cells = {}
    for phase, out in graphed.items():
        cells.update(graph_cells(phase, out))
    for phase, (out, info) in classic.items():
        cell = graph_cells(phase, out)[f"demo_{phase}"]
        cell.update(elbo_before=info["elbo_before"],
                    elbo_after=info["elbo_after"],
                    **{k: info["profiled"][k] for k in PROFILE_KEYS})
        cells[f"{CLASSIC_KINDS[phase]}_{phase}"] = cell
    if 30 in phases:
        cells["double_backward_30"] = {
            "captured": double["captured"],
            "identical_bits": double.get("identical"),
            **{k: double["profiled"][k] for k in PROFILE_KEYS
               if "profiled" in double}}
    for phase, (out, info) in zoo.items():
        zoo_cells = graph_cells(phase, out)
        main = zoo_cells[f"{info['cell']}_{phase}"]
        main.update(info["numbers"])
        if "profiled" in info:
            main.update({k: info["profiled"][k] for k in PROFILE_KEYS})
        cells.update(zoo_cells)
    if 25 in phases:
        cells["annealed_demo"] = {"graph_steady": annealed["steady"],
                                  "identical_bits": annealed["identical"]}
    if 26 in phases:
        for label, r in profiled.items():
            cells.setdefault(f"profile_{label}", {}).update(
                {k: r[k] for k in PROFILE_KEYS})
    if cells:
        # the graphed cells beside the eager ones, measured in this call
        print(json.dumps({"graph_cells": cells}), flush=True)
    if experiment:
        print(json.dumps({"experiment": experiment}), flush=True)
    if 43 in phases:
        print(json.dumps({"schedule": schedule}), flush=True)
    if 44 in phases:
        print(json.dumps({"demos": demos}), flush=True)
    if 45 in phases:
        print(json.dumps({"parity": {"quick_rows": parity_rows,
                                     "seconds": parity_seconds}}),
              flush=True)
    bf16_line = {}
    for phase, (out, info) in bf16.items():
        bf16_line.update(graph_cells(phase, out))
        bf16_line[f"{info['cell']}_{phase}"].update(
            info["numbers"], profiled=info["profiled"])
    if 50 in phases:
        bf16_line["bf16_parameters_50"] = params16
    if bf16_line:
        print(json.dumps({"bf16": bf16_line}), flush=True)
    if k6:
        print(json.dumps({"k6": k6}), flush=True)
    if sharded:
        print(json.dumps({"sharded": sharded}), flush=True)
    torch.cuda.synchronize()
    device_line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}})
    if phases != set(ALL_PHASES):
        print(f"chip_smoke.py: phases {sorted(phases)} passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        print(f"card: {smi}", flush=True)
        print(device_line, flush=True)
        return 0
    train.update(train_main, **graph,
                 eager_step_ms=1e3 / rnvp_summary["steady"],
                 err_by_target=k6["err_by_target"],
                 by_target=k6["by_target"])

    # each kernel's launches on the path it serves, the trainers' default
    # (graphed) runs: K2 on the ELBO path, K1 and K3 on the density path
    # (K1 runs on both), K4 and K5 on the RealNVP demo's, K6 on the demo's
    # whole-run training; the eager runs beside them
    paths = {"elbo_demo": elbo_launches, "mle_demo": mle_launches,
             "realnvp_demo": rnvp_launches,
             "realnvp_train_demo": train_launches,
             "elbo_demo_graph": graphed[22]["demo"]["graph"]["counts"],
             "mle_demo_graph": graphed[23]["demo"]["graph"]["counts"],
             "realnvp_demo_graph": graphed[24]["demo"]["graph"]["counts"],
             "annealed_demo_graph": annealed["counts"],
             **{f"{CLASSIC_KINDS[p]}_demo_graph":
                out["demo"]["graph"]["counts"]
                for p, (out, _) in classic.items()},
             "nsf_wrap_demo_graph": zoo[32][0]["nsf_wrap"]["graph"]["counts"],
             "nsf_wide_remat_graph":
                 zoo[33][0]["nsf_wide_remat"]["graph"]["counts"],
             "nsf_mle_remat_graph":
                 zoo[34][0]["nsf_mle_remat"]["graph"]["counts"],
             **{f"{kind}_demo_graph": zoo[p][0][kind]["graph"]["counts"]
                for p, kind in ZOO_KINDS.items()},
             **exp_counts, "nsf_wrap_schedule_graph": sched_counts,
             **{f"{label}_main": d["counts"] for label, d in demos.items()},
             **{f"parity_{k}_quick": {c: r["counts"].get(c, 0)
                                      for c in sched_counts}
                for k, r in parity_rows.items()},
             "nsf_wide_bf16_remat_graph":
                 bf16[49][0]["nsf_wide_bf16_remat"]["graph"]["counts"],
             "mle_demo_bf16_graph": bf16[49][1]["numbers"]["mle_counts"],
             "realnvp_demo_bf16_graph":
                 bf16[51][0]["realnvp_demo_bf16"]["graph"]["counts"],
             **{f"{label}_bf16_config_graph": c
                for label, c in params16_counts.items()},
             **{f"realnvp_train_{kind}_demo": c
                for kind, c in k6_counts.items()},
             "realnvp_train_bf16_demo": k6_bf16_counts,
             **{f"{cell}_sharded_graph": sharded[key][cell]["counts"]
                for key, cell in (("main", "nsf_demo"),
                                  ("main", "realnvp_demo"),
                                  ("wide", "nsf_wide"))}}
    own = {"rqs_fwd": "mle_demo_graph", "rqs_bwd_fwddir": "elbo_demo_graph",
           "rqs_bwd_invdir": "mle_demo_graph",
           "coupling_fwd": "realnvp_demo_graph",
           "coupling_bwd": "realnvp_demo_graph",
           "realnvp_train": "realnvp_train_demo",
           # the bfloat16 instantiations: the policy's NSF wide (K1/K2) and
           # MLE demo (K3) and fused demo (K4/K5); bfloat16 parameters'
           # configs
           "rqs_fwd_f32_rbf16": "nsf_wide_bf16_remat_graph",
           "rqs_bwd_fwddir_f32_rbf16": "nsf_wide_bf16_remat_graph",
           "rqs_bwd_invdir_f32_rbf16": "mle_demo_bf16_graph",
           "rqs_fwd_bf16": "nsf_bf16_config_graph",
           "rqs_bwd_fwddir_bf16": "nsf_bf16_config_graph",
           "rqs_bwd_invdir_bf16": "nsf_mle_bf16_config_graph",
           "coupling_fwd_f32_cbf16": "realnvp_demo_bf16_graph",
           "coupling_bwd_f32_cbf16": "realnvp_demo_bf16_graph",
           "coupling_fwd_bf16": "realnvp_fused_bf16_config_graph",
           "coupling_bwd_bf16": "realnvp_fused_bf16_config_graph",
           "realnvp_train_bf16": "realnvp_train_bf16_demo"}

    # K1's registers, from ptxas's report, and its static issue estimate
    # (phase 2)
    kernels["rqs_fwd"].update(
        registers={k: regs for k, regs, _, _ in sorted(set(report))
                   if k.startswith("rqs_fwd<")},
        static_issue_estimate=estimate)
    # the bf16 policy's tensor-core kernels: their registers and HMMA
    # instructions (phase 2)
    for k in CPL_KERNELS:
        mma = f"{k}_mma<"
        cpl16[f"{k}_f32_cbf16"].update(
            registers={n: regs for n, regs, _, _ in sorted(set(report))
                       if n.startswith(mma)},
            hmma={n: c for n, c in hmma.items() if n.startswith(mma)})

    def entry(k, source, r, extra):
        return {"name": k, "route": "cuda",
                "source": f"normalizingflows_torch/csrc/{source}",
                "replaces": REPLACES[k], "launches": paths[own[k]][k],
                "launches_by_path": {p: c[k] for p, c in paths.items()},
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                **{key: r[key] for key in extra if key in r}}

    print(f"chip_smoke.py: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [
        entry(k, "rqs.cu", kernels[k],
              ("ms_by_n", "plain_ms_by_n", "bound_ms_by_n",
               "bound_share_by_n", "cold_ms", "cold_bound_share",
               "direct_ms_by_n", "inverse", "registers",
               "static_issue_estimate"))
        for k in KERNELS] + [
        entry(k, "coupling.cu", cpl[k],
              ("unfused_ms", "ms_by_n", "plain_ms_by_n", "bound_ms_by_n",
               "unfused_ms_by_n", "tile_ms_by_n"))
        for k in CPL_KERNELS] + [
        entry("realnvp_train", "train.cu", train,
              ("ms_per_launch", "steps_per_s", "graph_step_ms",
               "graph_steps_per_s", "eager_step_ms", "ref_ms",
               "ref_steps_per_s", "ref_bound_ms", "ref_bound_by",
               "err_by_target", "by_target")),
        entry("realnvp_train_bf16", "train_bf16.cu", train16,
              ("ms_per_launch", "steps_per_s", "ms_in_turns",
               "f32_ms_in_turns", "ref_max_abs_err", "first_loss_rel",
               "trajectory", "elbo_first100", "elbo_last100"))] + [
        entry(k, "rqs_bf16.cu", r, ("ms_by_n", "plain_ms_by_n",
                                    "bound_ms_by_n", "cold_ms"))
        for k, r in rqs16.items()] + [
        entry(k, "coupling_mma.cuh" if k.endswith("_f32_cbf16")
              else "coupling_bf16.cu", r,
              ("ms_by_n", "plain_ms_by_n", "bound_ms_by_n", "f32_ms_by_n",
               "registers", "hmma"))
        for k, r in cpl16.items()]}),
          flush=True)
    print(device_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
