"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It imports only the port (code_robchar_tpu_torch),
never jax, and fails — non-zero exit, no result line — when any phase
fails, when no CUDA device is present, or when the package is missing.

Phases:

0. device: require CUDA; print the nvidia-smi name and power limit.
1. build: compile csrc/*.cu with nvcc (utils/build.py, one nvcc per source,
   all started together) and print the build seconds and the compiler's
   register / stack / spill report per kernel instance.
2. Hermitian kernel vs plain: the CUDA Jacobi fidelity kernel against the
   plain torch version on the card (max abs <= 3e-5) and against a float64
   torch.linalg.eigh oracle (<= 3e-5), on random Hermitian batches from
   numpy seed 0 (n in {4, 7, 10}, a ragged B = 5000, the main path's chunk
   width B = 131000 at n = 7, in/out in {(0, n-1), (1, 2)}).  The kernel
   takes a stage's angles by written-out fast paths of division and sqrtf
   (csrc/jacobi_common.cuh herm_angles_fast): through
   csrc/angles_probe.cu they must equal herm_angles, the IEEE arithmetic,
   bit for bit wherever they report their operands in range, and the share
   in range is printed (normal entries, A[P][Q] = 0, magnitudes over
   2^-45..2^45).  Then both timed at n = 7, B = 131072 with CUDA events,
   the kernel card-paced.
3. MC path at full size: engine.mc_metric_sweep on the bench.py workload
   (N=7 chain, 10,000 controllers x 11 noise levels x 100 bootstrap reps,
   seed 0, in 0 -> out 6, complex couplings, alpha 0.05): one warm-up with
   key(0), three timed runs with key(1..3).  Prints the median wall
   seconds, Hamiltonians/s, the kernel launches of those runs (must be
   > 0) and rim_checksum = sum of the RIM tensor of the key(1) run, which
   must lie within 1.0 of the JAX package's value for the same key and
   inputs (109979.109).  All 15 metric tensors must be finite, of shape
   (11, 10000), and agree on a 16-controller slice with the float64 plain
   path on the CPU (RIM, std, worst case within 1e-3: float32 rounding of
   phases lam*t up to a few hundred radians).
4. zoo kernels vs plain: every kernel of the amplitude and of the exact
   gradient (each has two hand-written ones: sym_jacobi_amp and
   sym_jacobi_grad with one thread per matrix, sym_jacobi_amp_group and
   sym_jacobi_grad_group with a group of lanes per matrix;
   ops/cuda_jacobi.py routes a shape to one) against the plain torch
   versions on the card (amplitude <= 3e-5; infidelity atol 2e-6 + rtol
   1e-5; gradient atol 2e-5 + rtol 1e-4, the bars of tests/test_pallas.py)
   and against a float64 eigh oracle (fidelity <= 3e-5, gradient <= 1e-4),
   on random symmetric batches from numpy seed 0 (n in {4, 7, 10}, ragged
   B = 5000, in/out in {(0, n-1), (1, 2)}; phases lam*T below ~25 rad, so
   the oracle bars measure the algorithm rather than float32 rounding of
   large phases) and on the ring's exactly degenerate spectra at n = 5, 6
   (biases of scale 0, 1e-4, 1e-2).  Against the plain versions at the same
   bars also on the zoo path's first inputs at n = 7 (the L-BFGS lanes'
   first gradient batch, B = 1024 pool starts across the bounds; the first
   NM round's batch, the initial simplices of those starts, B = 9216) and
   on the timed tensors.  The written-out fast paths of division and
   sqrtf in the lane-group kernels' angle chain (csrc/jacobi_common.cuh
   sym_angles_fast) against `/`, sqrtf and sym_angles through
   csrc/angles_probe.cu: equal bit for bit wherever the operands are in
   the ranges the fast paths check.  Then launch_floor_ms, an empty kernel
   through the kernels' ctypes entry, and every kernel timed at n = 7 and
   B = 1024 (the L-BFGS lane width), 9216 (1024 NM lanes x 9 slots) and
   131072 (the lanes of the one-thread gradient kernel's path) with CUDA
   events, card-paced: 100 launches enqueued behind a ~30 ms spin, so that
   they run back to back (a launch shorter than the host takes to enqueue
   it would otherwise read as the host's pace; that host-paced time is
   printed beside it), with the plain version and the bound, and with eigh
   at the batches the kernels line reads (LINE_BATCH).
5. zoo path at full width, the bench.py configuration: LBFGS and NMPlus
   (N=7, 0 -> 6, landscape exploration, float32 on the card), one warm-up
   and three timed _run_batch calls each on 8192-restart pools from
   init_points (keys split from key(5), key(7..9) for L-BFGS; key(15),
   key(16..18) for NM).  Prints the median wall, restarts/s, rounds, trials
   and host syncs per run and each kernel's launches; every fidelity
   finite and in [0, 1].  The path must take the kernels its shapes are
   routed to: the L-BFGS lanes' gradient batches (B = 1024) the lane-group
   gradient kernel and not the other, the NM rounds (B = 9216) the
   lane-group amplitude kernel.  Then the one-thread gradient kernel's
   own path: LBFGS with 131072 lanes (a width that fills the card) takes
   three iterations on a pool of 131072 restarts; the kernel is first held
   against the plain version on those starts, then its count is set to 0
   just before the run.  (The one-thread amplitude kernel's path is phase
   8: PPO's true fidelities, 512,000 matrices a launch.)  Then one
   budget-mode
   LBFGS.run() at N=7 with a 200000-fcall budget: it must end with a
   non-empty record["controllers"] and func_calls + 1 >= 200000.  Last,
   the kernels at the optimizers' 8192 end states (T up to 30, fidelities
   near 1; the lane-group kernels, which that batch is routed to, at both
   optimizers', the one-thread kernels at L-BFGS's), held with the plain
   versions against the float64 oracle: each kernel's worst error within
   the oracle bars or within 3x the plain version's.
6. zoo outcome gates on the card (float32, kernels): 512 restarts at
   (N, out) in {(4, 2), (5, 2)}, seed 7 — L-BFGS fidelities against
   artifacts/scipy_lbfgs_dist.json (KS < 0.12), NM against
   artifacts/scipy_nm_dist.json (KS < 0.12, mean nfev within 15); and a
   32-restart N=4 pool of each optimizer on the card against the CPU, over
   their first iterations (L-BFGS maxiter 3, NM maxfev 30): 28 of 32
   restarts within 1e-3.  Over whole runs it prints how many restarts end
   apart, beside the same count for the plain versions on the card and for
   starts moved by one ulp on either device (not gated).
7. PPO kernels vs plain (N=7, h=100, float32, weights from the port's
   init, carries near the wrap bounds): the rollout kernel against its
   plain version on the card at A = 1024 and a ragged 1000, T = 64,
   ham_noisy on and off, max_ep_len 40 < T, and at the path's shapes
   (A = 1024, T = 500, max_ep_len 1000, ham_noisy); bar 1e-4 on actions,
   fidelities and obs, step by step: each plain step starts from the
   kernel's own carry, since free-running trajectories amplify rounding
   through the accumulated action (at T = 64 that parting is printed
   beside the plain version against itself with the carry one ulp up);
   the same step by step at h = 64 (A = 1000, T = 64, ham_noisy), which
   takes the generic kernel of csrc/actor_env_rollout.cu (W2 in shared
   memory) instead of the path's (h = 100, W2 in registers).  Each of the
   two kernels has its own count: every hold must have launched the one
   its width takes, once, and not the other.
   Agents whose raw action or time comes within 1e-5 of a wrap boundary
   may part (a rounding-level difference picks the other branch); they
   are counted, and the phase fails if any other agent parts or more than
   1% do.  The float32 critic kernel against its plain version at
   A = 1024, T = 500, iters = 7 and 200 (the path's count) at
   test_pallas's bars (atol 2e-6 + rtol 1e-5; an element past them must
   stay within 2 lr iters, the step Adam takes when a gradient within
   rounding of zero flips sign, and such elements may be at most the share
   CRITIC_SHARE gives of all), and after 7 iterations at the shapes of
   CRITIC_F32_SHAPES: a ragged one (A = 130, T = 300, h = 30: T no
   multiple of the 100-row tile, h none of 4) and the widest width the
   kernel takes at d + 1 = 9 (h = 157, A = 132, T = 129: a 10-row tile,
   the gradient summed in shared memory).  The bf16 critic kernel
   (fast_dot=True: bfloat16 operands, float32 sums, wgmma) against
   critic_train_plain(fast_dot=True) at those shapes and at a ragged one
   (A = 130, T = 300, h = 30: T no multiple of the 128-row tile, h none of
   8).  At iters = 1 from zero moments mu = 0.1 g, so this reads the
   gradient: max |dmu| at most CRITIC_BF16_GRAD of the largest |mu| (the
   sums differ in order, and an operand that lands on the other side of a
   bf16 rounding boundary moves one term of a sum by 2^-8 of itself).  At
   iters = 7 and 200 the count must be equal, every element within
   2 lr iters, and the share of elements past atol 2e-6 + rtol 1e-5 at
   most twice the witness's plus CRITIC_BF16_MARGIN; the witness, printed
   beside it, is the plain bf16 version against itself with theta moved
   one ulp: the roundings to bfloat16 amplify such a difference and Adam
   carries it on.  A functional gate on one line: the value loss
   mean((v - ret)^2) over the 1024 agents after 200 iterations from the
   bf16 kernel, the plain bf16 version and the float32 kernel; the bf16
   kernel's within CRITIC_BF16_LOSS (relative) of the plain bf16 version's,
   the float32 kernel's within as much of CRITIC_F32_LOSS, the reading of
   the kernel it replaced on the same inputs.
   Then all three kernels timed with CUDA events at the path's shapes
   (rollout A = 1024, T = 500, sweeps 4, ham_noisy, card-paced: the
   instance at h = 100 keeps each thread's column of W2 in registers; both
   critic kernels A = 1024, T = 500, iters 200) against their plain
   versions.
8. PPO path at full width, the bench.py configuration: PPO_en(7, 0, 6,
   ham_noisy, 1024 agents, rollout_sweeps 4, float32 on the card), epochs
   of 500 steps with 200 / 200 pi / v iterations and target_kl 0.01; two
   warm-up and three timed epochs.  Prints env-steps/s, the epoch split by
   CUDA events (rollout, true fid, values + logps + GAE, pi loop, critic),
   mean pi_iters and the launches of the amplitude, rollout and bf16
   critic kernels over the five epochs (the last two once per epoch: the
   rollout through its kernel of the path's width, never its generic one;
   the float32 critic kernel must not be launched: on the card the epoch
   asks for fast_dot=True); rewards finite and in [0, 1].  Then the one-thread
   amplitude kernel on the last epoch's own true-fidelity batch (512,000
   matrices, 4 sweeps, assembled anew from the visited controllers):
   against the plain version (amplitude <= 3e-5) and against the epoch's
   own fidelities, and timed there card-paced beside the plain version,
   eigh and the bound.  Then the float32 critic kernel's own path, its launches counted from just before:
   ops.critic.critic_train(fast_dot=False), the entry point of a
   full-precision regression on the card, takes 200 Adam steps from the
   epochs' final state (1024 agents, full width) on the last epoch's
   visited controllers and rewards; one launch, count advanced by 200,
   finite parameters and a lower value loss than before.
9. PPO on the card beyond the timed path: one budget-mode run() (N=7, 64
   agents, 100-step epochs, a 12800-fcall budget) must end with a
   non-empty record["controllers"] and func_calls + 1 >= 12800; and one
   epoch at N=4, 256 agents, T=64 through the kernels on the card against
   the plain versions on the CPU (float32) from one state: the first 16
   steps' rewards within 1e-4 on at least 99% of the agents.  Over the
   whole epoch a rounding-level difference (the kernels differ from the
   plain versions by ~4e-6 a step) is amplified through the accumulated
   actions, as it is between two runs of the CPU whose carried actions
   differ by 4e-6 (the witness): the agents apart by more than 1e-4 over
   all 64 steps may be at most the witness's count or 1%, whichever is
   more, plus 1%.
10. the probe path (code_robchar_tpu_torch/perf/probes.py, the counterpart
    of artifacts/perf/roofline.py's ALU probe and
    artifacts/perf/tanh_microbench.py): csrc/alu_probe.cu at B = 2^19
    lanes of the reference's input, streams 1, 4, 8 and K 1024, 2048, 4096,
    and csrc/tanh_probe.cu on a (512, 128) normal array, ops mul, tanh and
    rational, K 1024 and 8192, each launch held against its plain version
    (bit-equal; tanhf against torch.tanh within K * 2^-24); then the
    path's sweeps, their launches counted from just before: card-paced times by
    K, the marginal cost of a step (ns and SM cycles per step per 1024
    lanes; ps per element per step) as JSON lines, and both kernels timed
    for the kernels line beside their plain versions and their
    issue-slot bounds (one operation a lane and cycle: both probes round
    each multiply and add on its own, so no FFMA halves the count).
11. shot noise (fid_noisy, draws 10) on the card: the N=7 NM and L-BFGS
    pools (NOISY_POOL restarts, a quarter of the noiseless pools' size; the
    cut is printed) in the plain and the
    adaptive protocol (adp_tol 0.05), NOISY_PPO_EPOCHS PPO epochs (one
    since phases 17 and 18 were added; two before) at N=7, 1024 agents,
    T=500 on the per-step loop (the fused rollout gated off);
    restarts/s and env-steps/s, the seconds the draws take (ms a trial, a
    round, an epoch), the amplitude kernel's launches, which must rise on
    every path; fidelities and rewards must be whole shot counts in the
    plain protocol.  Then 1M float32 binomials on the card against the
    same call on the CPU (one key with a shape, a batch of keys; both
    samplers): at most 1e-3 of the draws may differ.
12. Adam and SNOB at full width (N=7, 0 -> 6, landscape exploration,
    float32 on the card).  First the zoo kernels held against their plain
    versions at this path's shapes: Adam's 64 streams, SNOB's round of
    ZOO_POOL x 10 = 81,920 candidates (Sobol points across the box) and
    run()'s 128 x 10 = 1,280.  Then, each with the four zoo kernels'
    launches counted from just before to just after: Adam.run() with its 64
    streams and 1000-step segments on a budget of 64 x 5000 fcalls (five
    segments, the fifth a restart segment), noiseless, then one segment
    under ham noise (sigma 0.05): segments/s, steps/s, probes per stream,
    best_fid, the top-c store's size; the gradient's lane-group kernel
    must be launched once a step and a probe round, the amplitude's once a
    step and once for the true fidelities, the one-thread kernels never.
    SNOB._run_batch on ZOO_POOL restarts (key(25) a warm-up, key(26..28)
    timed; median, restarts/s): the rounds' 81,920 lanes take the
    one-thread amplitude kernel 30 times a run, the starts' evaluation and
    the true fidelities the lane-group one twice.  SNOB.run() at its batch
    of 128 on a budget of 128 x 300 x 3: the lane-group amplitude kernel
    32 times a batch.  Last,
    card against CPU at N=4, float32 (256 Adam streams over a 50-step
    segment and a 50-step restart segment, whose probes a stream and table
    pointers must be equal on both devices; 256 SNOB restarts): the
    restarts ending > 1e-3 apart beside the CPU against itself with the
    starts moved one ulp, and the fidelities' two-sample KS < 0.12 (the
    zoo's gate).
13. the single-point objectives and their callers (N=7, 0 -> 6, float32
    on the card).  (a) Every single-point builder on 64 points of real
    fidelity (biases in (-0.5, 0.5), times in (3, 7): fidelity ~0.28
    median) with fixed keys, the kernels on the card against the plain
    versions on the CPU on the same keys: make_infidelity noiseless,
    ham_noisy, fid_noisy, adaptive, fixed ensemble (100 members) and
    fixed + fid_noisy (fidelities within 3e-5, under shot noise equal;
    the call counts equal), make_exact_gradient (fidelities within 3e-5,
    gradients within 1e-4), make_fd_gradient under ham noise (eps 1e-3, a
    float32-sized step; f0 and the probes' values within 3e-5, calls
    equal) and make_wass_cost (30 reps, within 3e-5); each call moves its
    routed kernel's count by one launch (the Wasserstein cost by one a
    chunk), and the median of the held values (fidelity, largest |grad|,
    1 - cost) must be at least 100 times its bar.  Then ngd's launch, the
    gradient kernel at B=1 on one ham-noisy draw (same bars), and one ngd
    step from the first of those points (fidelity and w within 3e-5 and
    1e-4; a coordinate moves ~0.03).  (b) NMPlus.run_accelerated with 600
    objective calls, noiseless and ham-noisy (sigma 0.05), from the
    reference's start (a regular simplex around a uniform point) in the
    box biases (-1, 1), times (0, 8), where float32 resolves the
    landscape (in the default box (-10, 10) x (0, 30) a uniform point's
    fidelity is ~2e-7): wall, iterations/s, restarts, launches and host
    syncs an iteration, the best fidelity of the first simplex, of the
    run (a recorder around make_infidelity keeps the least value on the
    card) and of the last simplex (a restart can leave it anywhere): the
    run's at least 3e-3 and, noiseless, above the first simplex's; the
    lane-group amplitude kernel once an iteration, once the
    first simplex and once a restart, nothing else.  In the default box,
    from a warm start (a regular simplex around the best of 1024 uniform
    points), 36 calls must raise the best fidelity with no restart.  Then
    card against CPU at N=4 (8 streams, one regular simplex each on both
    devices): over the first 40 calls 7 of 8 within 1e-3; whole runs of
    SP_WHOLE_CALLS calls (150; 300 before phases 17 and 18) apart beside
    the witness, the CPU against itself with the simplex one ulp up.  (c) PPO
    at bench.py's configuration with the Wasserstein value targets (N=7,
    1024 agents, T=500, ham_noisy, rollout_sweeps 4, 30 bootstrap reps):
    one warm-up and two timed epochs, env-steps/s, the epoch split by CUDA
    events at the stage hook (the targets at "wass_targets"), the
    one-thread amplitude kernel's launches (the true fidelities and the
    targets' chunks of at most objectives.WASS_LANES Hamiltonians), the
    rollout and bf16 critic kernels once an epoch, and the peak of
    torch.cuda.max_memory_allocated; 4096 of the last epoch's targets
    against the CPU plain version from the same keys within 3e-5.  (d) ngd
    for 200 steps (the lane-group gradient kernel once a step, B=1) and
    one wass_cost: walls and launches.
15. the pipeline, run before the kernels line of 14 (N=7, 0 -> 6, float32
    on the card), from a temporary working directory.  (a) The collect
    driver in-process, drivers.run_experiments_single_controller_set_with_le
    with 1000 controllers, noise_res 3 and max_noise 0.1
    (training noises 0, 0.05, 0.1), ham_noisy, fid_threshold (0.0, see
    PIPE_FID_THRESHOLD) and the rest at the CLI's defaults, and a budget of
    PIPE_BUDGET fcalls a run, cut from the paper's 1,000,000 (the paper
    also sets fid_threshold 0.1): each family's run() wrapped so that every
    kernel's launches are counted from just before to just after; the wall, the
    objective calls per second and the launches of each run; L-BFGS (its
    forward differences of the ham-noisy objective), NM and SNOB must
    launch an amplitude kernel, PPO the rollout kernel, the bf16 critic
    kernel and an amplitude kernel.  Each run's stored controllers must
    beat its starts: the best noiseless fidelity (float64, the CPU plain
    version) of the controllers its record stores must exceed that of its
    starting points (the zoo families' restart starts, PPO's first
    epoch); Nelder-Mead under ham noise ranks its store by the noisy
    estimate and, as the JAX package's does, may store nothing above its
    best start, so there the gate is that under half of its stored
    controllers are starts.  The
    .le store must hold exactly lbfgs under "7" and nmplus, snob and ppo
    under "0.0", "0.05" and "0.1", each cell 1 to 1000 finite controllers
    of width 8.  Then the collect's PPO kernels at its shapes against
    their plain versions at phase 8's bars: the rollout at A=1,
    T=COLLECT_HOLD_STEPS (a cut of the collect's 500; phase 7 holds
    T=500), h=100, ham noise, 5 sweeps, max_ep_len 1000; the bf16 critic at
    A=1,
    T=500, h=100 and iters 1, 7, 200.  (b) MCDataSim on that store (noises linspace(0, 0.1, 11),
    bootreps 100, seed 0, 1000 controllers): get_metrics_dict for the ten
    sets, 11M Hamiltonians; kernel 1's count must rise by at least the
    sweeps' chunks of 131072, every metric tensor be (11, 1000) and
    finite where the set has controllers, and the native codec be the one
    that ran; each stage timed, synchronised (the sweeps, metric_tensors,
    the .mc writes and their native encode, the .mc reads, the .mcm JSON),
    and the bytes written.  (c) A fresh MCDataSim returns equal dicts with
    no launch, and load_mc with the sidecar off returns the tensors last
    written bit for bit.  (d) The shipped store
    artifacts/selfgen/experiments/pipeline_selfgen/ppo_spin_7_0-6_c_1000.le,
    set (ppo, "0.05"), characterised the same way: its RIM tensor's sum
    within 0.1 of the JAX package's at float32 (ANCHOR_RIM_SUM; the
    float64 value is printed beside it: its draws are other samples); a
    16-controller slice (zero-noise fidelity median ~0.29) within 1e-3
    (RIM, std, worst case) of the float32 plain path on the CPU on every
    noise level and of the float64 one on the zero-noise level.  (e)
    ``python -m code_robchar_tpu_torch.exp.drivers`` with no command must
    exit 2 with its usage line, and a process that imports the drivers
    and datasim must hold no jax and nothing of the JAX package.
16. the figures, run after 15 and before 17 and the kernels line of 14 (N=5,
    0 -> 2, float32 on the card, noises linspace(0, 0.1, 11), seed 0), on
    copies of the in-repo selfgen stores in a temporary directory; each
    stage's launches counted from just before, timed by the port's
    utils.trace.Stopwatch and ``timed`` (synchronising a CUDA tensor).
    (a) The characterised figures at the paper's size (1000 controllers,
    100 bootreps, the ten sets: 11M Hamiltonians):
    IndividualContComparisons._rim_bands of every set fills the .mc / .mcm
    caches (kernel 1 at least once a chunk of 131072);
    KTRConsistency.pairwise_taus on _rim, ARIMGenerator.arim_curve and
    ExploringRIMK.rim_k_tensor (ppo at the index of "0.05") reload them
    with no launch.  (b) NStochOpt.get_arims over every (marker, algo,
    nlvl) of the scaling store (100 controllers a checkpoint: one launch of
    110,000 Hamiltonians each): checkpoints, launches, seconds; a second
    pass loads every pickle with no launch and equal values.  (c)
    CDFAreaExample.get_sd_results on legacy stores written from the
    1000-controller store (100 controllers, noises linspace(0, 1, 11),
    100 bootreps; ppo's "0.05"), then joint_ecdfs at sigma 0.5.  (d) fig
    8's row FIG8_CELL and fig 5's ARIM curve (snob, "0.05") against the
    port's float32 plain version on the CPU from the same keys and against
    the JAX package's float32 values (JAX_FIG8_ROW, JAX_FIG5_ARIM): within
    FIG_TOL; every value printed by (a)-(c) finite, each ARIM curve at
    sigma 0 at most its value at sigma 0.1.  (e) A PPO actor-critic's
    parameters and Adam states through utils.checkpoint, restored onto the
    card bit-equal.
17. the exact-SNOBFIT adapter and the env's reference methods, after 16
    and before the kernels line (N=7, 0 -> 6, float32 on the card).
    SNOBSkquant.run() on the vendored engine (models/snobfit_core.py) in
    budget mode: SNOBFIT_RESTARTS restarts of budget SNOBFIT_BUDGET,
    landscape exploration, fid_threshold 0, noiseless and then ham-noisy
    (sigma 0.05), each with the four zoo kernels' launches counted
    from just before to just after.  Each run must reach its budget
    (func_calls = restarts x budget); the lane-group amplitude kernel must
    be launched once a scored batch (n + 6 = 14 points in SNOBFIT's 8
    dimensions, fewer at a restart's end, and the start alone) plus once a
    restart for the noiseless re-evaluation, and no other kernel.
    Noiseless, the best noiseless fidelity (float64, the CPU plain version)
    of the stored controllers must beat that of the restarts' starts;
    under ham noise the search must leave its starts (under half the
    stored at a start).  Every amplitude launch of the runs is recorded and
    held afterwards against the plain version on the card (amplitude
    <= 3e-5, phase 4's bar).  Prints restarts/s, the scored batches, the
    seconds spent scoring them and the host's share of the wall (SNOBFIT's
    suggest is host numpy).  Then Environment(device="cuda"):
    structured_perturabation on the card, Hermitian and real off the
    diagonal; state_vector, input_state, output_state.
18. the mesh on the card, after 17 (parallel/mesh.py; a MESH_ENTRIES-entry
    mesh that repeats cuda:0, the number of CUDA devices printed; the
    blocks run one after another from the host), each stage's launches
    counted from just before to just after; every wall host-paced,
    beside the unsharded one.  (a) sharded_mc_metrics at the MC headline's
    full width (10,000 controllers, 2,500 a block, x 11 x 100, key(1)): all
    15 tensors bit-equal to phase 3's key(1) run and the same
    rim_checksum.  (b) sharded_run_batch for L-BFGS and NM on MESH_POOL
    restarts (keys from key(31), key(32)): twice, bit-equal; on a one-entry
    mesh bit-equal to _run_batch; the mean true fidelity within 5e-2 of the
    unsharded pool's.  (c) PPO_en at N=7, PPO_AGENTS agents (a quarter a
    block), T=500, ham_noisy, mesh= the entries: two epochs through run(),
    the rollout, bf16 critic and one-thread amplitude kernels once a block
    an epoch; the rollout and bf16 critic kernels first held against their
    plain versions at a block's shape (A=256) at phase 7's bars; the same
    run unsharded beside it.  (d) Adam with ADAM_STREAMS streams, one
    1000-step segment sharded: the lane-group gradient kernel once a step
    and block, the lane-group amplitude kernel once a step and block plus
    the true fidelities; its kernels held at a block's 16 streams first.
    (e) parallel/dryrun.dryrun_multichip on a MESH_ENTRIES-entry mesh.
14. the kernels JSON line (eleven kernels, named by C entry: launches on
    their paths, the max abs error against the plain version, ms and
    plain_ms from CUDA events (kernel 1's and the draw kernel's launches on
    phases 3, 15, 16 and 18, the four zoo
    kernels' on the paths of phases 5, 8, 12, 13, 15, 17 and 18, the
    rollout and bf16 critic kernels' on phases 8, 13, 15 and 18, timed
    at the batch of their path: 9216 and
    1024 for the lane-group ones, 131072 for the one-thread gradient
    kernel, the PPO epoch's 512,000 for the one-thread amplitude kernel),
    bound_ms from this run's shapes and the hand counts of
    artifacts/perf/roofline.py:56-99 against 67 TFLOP/s float32 (the bf16
    critic kernel's products against 989 TFLOP/s) and 3.35 TB/s, and
    library_ms: batched torch.linalg.eigh on the same matrices for kernels
    1-3, which computes the eigendecomposition only, none for the rollout
    and critic kernels; the probes' bounds are their issue-slot bounds,
    "bound_by": "issue slots", phase 10 printing the 67 TFLOP/s bound
    beside them), the launches JSON line (every C entry's launches in the
    process, the holds' and the timing loops' included), then {"ok": true,
    "device": {...}} as the last line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

from code_robchar_tpu_torch.utils import build

JAX_RIM_CHECKSUM = 109979.109   # JAX package, same key and inputs
#: the repository root (this file's directory) and the RIM's key in the
#: metric dicts
REPO = os.path.dirname(os.path.abspath(__file__))
RIM = r"$W(.,\delta(x-1))$"
TOL_KERNEL = 3e-5
TOL_SLICE = 1e-3
TOL_GRAD_ORACLE = 1e-4
KS_GATE = 0.12
ZOO_POOL = 8192
#: restarts of phase 18's sharded zoo pools, a quarter of ZOO_POOL: on one
#: card each block repeats the lanes' straggler tail, and the bit-equalities
#: the stage holds do not depend on the pool's size
MESH_POOL = ZOO_POOL // 4
#: the H100's float32 rate outside the tensor cores and its HBM rate (SXM
#: part, 700 W)
F32_PEAK = 67e12
HBM_RATE = 3.35e12
#: its dense bf16 tensor-core rate
BF16_PEAK = 989e12
#: cycles of the spin that card-paced timings are enqueued behind (~30 ms)
SPIN_CYCLES = 50_000_000
#: both hand-written kernels of each real symmetric function: one thread
#: per matrix, a group of lanes per matrix
AMP_KERNELS = ("sym_jacobi_amp", "sym_jacobi_amp_group")
GRAD_KERNELS = ("sym_jacobi_grad", "sym_jacobi_grad_group")
ZOO_KERNELS = AMP_KERNELS + GRAD_KERNELS
#: a lane width above the gradient's route threshold, for the one-thread
#: gradient kernel's own path
WIDE_LANES = 131072
#: the batch of phase 4 whose times go into the kernels line: the one the
#: kernel's path launches it with (the one-thread amplitude kernel is held
#: and timed in phase 8 instead, on the PPO epoch's own 512,000 matrices)
LINE_BATCH = {"sym_jacobi_amp_group": 9216, "sym_jacobi_grad_group": 1024,
              "sym_jacobi_grad": WIDE_LANES}
TOL_PPO = 1e-4
PPO_AGENTS, PPO_STEPS = 1024, 500
#: the critic kernel against its plain version: per iteration count, the
#: largest share of elements (theta, mu, nu) past atol 2e-6 + rtol 1e-5
CRITIC_SHARE = {7: 1e-5, 200: 1e-5}
#: the float32 critic kernel's other holds, at CRITIC_SHARE[7] after 7
#: iterations: (label, A, T, h, seed); d + 1 = 9
CRITIC_F32_SHAPES = (
    ("ragged", 130, 300, 30, 22),       # T, h no multiple of the tiles
    ("widest", 132, 129, 157, 23))      # the widest h at d + 1 = 9
#: the float32 critic kernel's value loss after 200 iterations on phase 7's
#: inputs, as the kernel before its register-tiled redesign read it; the
#: kernel must stay within CRITIC_BF16_LOSS of it (relative)
CRITIC_F32_LOSS = 0.658637
#: the bf16 critic kernel against the plain bf16 version: the gradient
#: (iters = 1) relative to its largest element (3.3e-5 measured at the
#: path's shapes, 6.7e-6 at the ragged one); the margin over twice the
#: witness's share of elements past the bars (iters = 7, 200; the kernel's
#: share was 5.8e-4 and 0.49 where the witness's was 7.6e-3 and 0.50); the
#: value loss after 200 iterations, relative (3e-6 measured)
CRITIC_BF16_GRAD = 2e-4
CRITIC_BF16_MARGIN = 5e-3
CRITIC_BF16_LOSS = 1e-3


# hand counts per element of artifacts/perf/roofline.py:56-99 (sqrt,
# division and tanh count one operation each)
def _pairs(n):
    return n * (n - 1) // 2


def _sym_rot_flops(n, vrows):
    return 27 + 6 * (n - 2) + 6 + 6 * vrows


def _herm_flops(n, sweeps):
    return sweeps * _pairs(n) * (34 + 26 * (n - 2) + 7 + 48) + 14 * n + 3


def _amp_flops(n, sweeps):
    return sweeps * _pairs(n) * _sym_rot_flops(n, 2) + 6 * n + 2


def _grad_flops(n, sweeps):
    return (sweeps * _pairs(n) * _sym_rot_flops(n, n) + 7 * n + 4
            + 12 * n * n + n * n * (5 * n + 5) + 5 * n + 6 * n)


def _rollout_step_flops(n, h, sweeps):
    d = n + 1
    return 2 * (d * h + h * h + h * d) + 2 * h + _amp_flops(n, sweeps) + 30


def _critic_iter_ops(d1, h, t_len):
    """One Adam iteration of one agent, (product flops, other flops): 2
    flops per multiply-add of the forward and backward products; ~9h + 2
    elementwise flops per row and ~13 per parameter for Adam."""
    macs = 2 * d1 * h + 2 * (h + 1) * h + h * h + 2 * (h + 1) + h
    params = d1 * h + (h + 1) * h + (h + 1)
    return t_len * 2 * macs, t_len * (9 * h + 2) + 13 * params


def _critic_iter_flops(d1, h, t_len):
    return sum(_critic_iter_ops(d1, h, t_len))


def _bound(flops, nbytes, bf16_flops=0.0):
    """(bound_ms, bound_by): the larger of operations over their peak
    (``flops`` over the float32 rate plus ``bf16_flops`` over the bf16
    tensor-core rate) and bytes over the HBM rate."""
    t_ops = (flops / F32_PEAK + bf16_flops / BF16_PEAK) * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA device and has no CPU mode")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    res = build.build()
    print(f"build: {res.seconds:.2f} s (cached={res.cached}) -> {res.path}")
    for line in res.log.splitlines():
        if any(w in line for w in ("Function", "registers", "spill", "stack",
                                   "warning", "$ ")):
            print(f"  nvcc: {line.strip()}")
    return res


def _hermitian_batch(rng, n, b):
    a = rng.normal(size=(b, n, n))
    sym = (a + a.transpose(0, 2, 1)) / 2
    s = rng.normal(size=(b, n, n))
    skew = (s - s.transpose(0, 2, 1)) / 2
    t = rng.uniform(1, 5, b)
    return (np.moveaxis(sym, 0, -1).astype(np.float32).copy(),
            np.moveaxis(skew, 0, -1).astype(np.float32).copy(),
            t.astype(np.float32))


def _oracle(ar, ai, t, i, o):
    h = torch.as_tensor(np.moveaxis(ar, -1, 0), dtype=torch.float64) \
        + 1j * torch.as_tensor(np.moveaxis(ai, -1, 0), dtype=torch.float64)
    lam, v = torch.linalg.eigh(h)
    tt = torch.as_tensor(t, dtype=torch.float64)[:, None]
    ph = (v[:, o, :] * v[:, i, :].conj() * torch.exp(-1j * lam * tt)).sum(-1)
    return (ph.abs() ** 2).numpy()


def _time_ms(fn, reps, warm=True, behind_spin=False):
    """Milliseconds per call of ``fn`` between two CUDA events around
    ``reps`` calls.  With ``behind_spin`` the calls are enqueued behind a
    spin of ~30 ms on the card, so that they run back to back (card-paced);
    without it a call shorter than the host takes to enqueue it reads as
    the host's pace."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if behind_spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _eigh_ms(mats):
    """(ms, backend) of one batched torch.linalg.eigh on ``mats`` (B, n, n),
    the library yardstick of the Jacobi kernels (it computes the
    eigendecomposition only).  cuSOLVER's batched eigh refuses batches
    above ~10k matrices of this size (CUSOLVER_STATUS_INVALID_VALUE at
    32768 on the H100); the same call then runs with MAGMA as torch's
    linear-algebra backend."""
    try:
        return _time_ms(lambda: torch.linalg.eigh(mats), 5), "cusolver"
    except torch.linalg.LinAlgError:
        torch.backends.cuda.preferred_linalg_library("magma")
        try:
            return _time_ms(lambda: torch.linalg.eigh(mats), 1), "magma"
        finally:
            torch.backends.cuda.preferred_linalg_library("default")


def _hold_herm_fast_angles(dev):
    """The Hermitian kernel takes a stage's angles by written-out fast paths
    of division and sqrtf (csrc/jacobi_common.cuh herm_angles_fast).
    csrc/angles_probe.cu runs them beside herm_angles, the IEEE arithmetic:
    no output may differ in any bit where the fast paths report their
    operands in range.  The share in range is printed for standard normal
    entries (at least 99.9%), for A[P][Q] = 0 (every pivot an earlier
    rotation zeroed: all of them) and for magnitudes spread over
    2^-45..2^45 with zeros and equal diagonals among them."""
    from code_robchar_tpu_torch.ops import cuda_jacobi

    rng = np.random.default_rng(9)
    count = 1 << 22
    normal = rng.normal(size=(4, count))
    zero = normal.copy()
    zero[2:] = 0.0
    wide = (rng.choice([-1.0, 1.0], (4, count)) * rng.uniform(1, 2, (4, count))
            * 2.0 ** rng.integers(-45, 46, (4, count)))
    wide[0, ::7] = wide[1, ::7]
    wide[2, ::11] = 0.0
    wide[3, ::5] = 0.0
    wide[0, ::13] = 0.0
    for label, x, least in (("normal", normal, 0.999), ("r = 0", zero, 1.0),
                            ("wide", wide, 0.3)):
        exact, fast = cuda_jacobi.herm_angles_probe(
            torch.as_tensor(x.astype(np.float32), device=dev))
        ok = fast[7] != 0
        same = (exact.view(torch.int32) == fast[:7].view(torch.int32)).all(0)
        apart = int((~same & ok).sum())
        share = float(ok.float().mean())
        good = apart == 0 and share >= least and \
            bool(torch.isfinite(exact).all())
        print(f"Hermitian fast angle paths vs herm_angles ({label} operands, "
              f"{count} pivots): in range {share:.6f} (at least {least:g}); "
              f"differing in any bit there {apart} "
              f"{'ok' if good else 'FAIL'}")
        if not good:
            raise RuntimeError("the Hermitian fast angle paths differ from "
                               "IEEE division and sqrtf inside their ranges")


def phase_kernel():
    from code_robchar_tpu_torch.ops import cuda_jacobi, realform

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    worst = 0.0
    cases = [(n, b) for n in (4, 7, 10) for b in (5000,)] + [(7, 131000)]
    for n, b in cases:
        ar, ai, t = _hermitian_batch(rng, n, b)
        gar, gai, gt = (torch.as_tensor(x, device=dev) for x in (ar, ai, t))
        for i, o in ((0, n - 1), (1, 2)):
            got = cuda_jacobi.fidelity_herm(gar, gai, gt, i, o)
            plain = realform.fidelity_herm_lanes(gar, gai, gt, i, o)
            torch.cuda.synchronize()
            got = got.cpu().numpy()
            err_plain = float(np.abs(got - plain.cpu().numpy()).max())
            err_oracle = float(np.abs(got - _oracle(ar, ai, t, i, o)).max())
            ok = (np.isfinite(got).all() and err_plain <= TOL_KERNEL
                  and err_oracle <= TOL_KERNEL)
            print(f"kernel n={n} B={b} in={i} out={o}: max|kernel-plain| "
                  f"{err_plain:.3e}, max|kernel-f64 eigh| {err_oracle:.3e} "
                  f"(tol {TOL_KERNEL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"kernel disagrees at n={n} B={b} "
                                   f"in={i} out={o}")
            worst = max(worst, err_plain)
    _hold_herm_fast_angles(dev)

    n, b = 7, 131072
    ar, ai, t = _hermitian_batch(rng, n, b)
    gar, gai, gt = (torch.as_tensor(x, device=dev) for x in (ar, ai, t))
    timings = {}
    for label, fn, reps in (
            ("plain", lambda: realform.fidelity_herm_lanes(gar, gai, gt, 0, 6),
             3),
            ("kernel", lambda: cuda_jacobi.fidelity_herm(gar, gai, gt, 0, 6),
             100),
            ("kernel", lambda: cuda_jacobi.fidelity_herm(gar, gai, gt, 0, 6),
             100),
            ("plain", lambda: realform.fidelity_herm_lanes(gar, gai, gt, 0, 6),
             3)):
        timings.setdefault(label, []).append(
            _time_ms(fn, reps, behind_spin=label == "kernel"))
    ms = min(timings["kernel"])
    plain_ms = min(timings["plain"])
    herm = torch.complex(gar.permute(2, 0, 1), gai.permute(2, 0, 1))
    lib_ms, lib = _eigh_ms(herm.contiguous())
    bound = _bound(b * _herm_flops(n, 5), 4 * b * (2 * n * n + 2))
    print(f"timing n=7 B=131072: kernel {timings['kernel']} ms "
          f"(card-paced), plain "
          f"{timings['plain']} ms (min: {ms:.4f} vs {plain_ms:.3f} ms, "
          f"{b / ms / 1e3:.1f} M Hams/s in the kernel); torch.linalg.eigh "
          f"(complex64, {lib}, eigendecomposition only) {lib_ms:.4f} ms; "
          f"bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    return worst, ms, plain_ms, lib_ms, bound


MC_N, MC_CONTROLLERS, MC_NOISES, MC_BOOTREPS = 7, 10_000, 11, 100


def _mc_inputs():
    """The MC headline's drift, controllers (numpy seed 0) and noise
    levels, float32."""
    from code_robchar_tpu_torch.ops import chain

    n, n_ctrl = MC_N, MC_CONTROLLERS
    rng = np.random.default_rng(0)
    h0 = chain.xx_hamiltonian_real(n, dtype=torch.float32)
    ctrl = np.column_stack([rng.uniform(-10, 10, (n_ctrl, n)),
                            rng.uniform(0, 30, n_ctrl)]).astype(np.float32)
    noises = np.linspace(0, 0.1, MC_NOISES).astype(np.float32)
    return h0, ctrl, noises


def _hold_draw_kernel():
    """The chunk draw kernel (csrc/mc_draw_lanes.cu) against its plain
    version, the torch route on the card: (ar, ai, t) bit for bit at n=7 on
    headline chunks (the first, one mid-lattice, the partial last, a mesh
    block's) with complex and real couplings; then both timed on a full
    chunk of 131,072 (the kernel card-paced), bound by the bytes it writes,
    2 n^2 + 1 floats a matrix, at the HBM rate.  Returns (max |kernel -
    plain|, (kernel ms, plain ms, bound))."""
    from code_robchar_tpu_torch.ops import mc_draws, prng

    dev = torch.device("cuda")
    h0, ctrl, noises = _mc_inputs()
    h0, ctrl, noises = (torch.as_tensor(x, device=dev).contiguous()
                        for x in (h0, ctrl, noises))
    key = prng.fold_in(prng.key(2**33 + 7, device=dev), 3)
    n, b, reps = MC_N, 131072, MC_BOOTREPS
    total = MC_NOISES * MC_CONTROLLERS * reps
    half = MC_CONTROLLERS // 2
    cases = (("first", ctrl, 0, b, 0), ("mid", ctrl, 5_000_037, b, 0),
             ("last", ctrl, total - 12_345, 12_345, 0),
             ("block", ctrl[half:].contiguous(), 3_000_001, b, half))
    worst = 0.0
    for label, block, start, count, offset in cases:
        for cx in (True, False):
            args = (h0, block, noises, key, start, count, reps, cx, offset,
                    MC_CONTROLLERS)
            got = mc_draws.draw_lanes_cuda(*args)
            want = mc_draws.draw_lanes_plain(*args)
            torch.cuda.synchronize()
            apart = sum(int((g.view(torch.int32) != w.view(torch.int32))
                            .sum()) for g, w in zip(got, want))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            worst = max(worst, err)
            print(f"draw kernel n={n} {label} chunk (start {start}, "
                  f"{count} elements, c_offset {offset}, complex {cx}): "
                  f"values differing in any bit {apart}, max|kernel-plain| "
                  f"{err:.3e} {'ok' if apart == 0 else 'FAIL'}")
            if apart:
                raise RuntimeError(f"the draw kernel differs from the torch "
                                   f"route ({label}, complex {cx})")
    args = (h0, ctrl, noises, key, 0, b, reps, True, 0, MC_CONTROLLERS)
    before = build.LAUNCHES["mc_draw_lanes"]
    timings = {}
    for label, fn, reps_t in (
            ("plain", lambda: mc_draws.draw_lanes_plain(*args), 3),
            ("kernel", lambda: mc_draws.draw_lanes_cuda(*args), 100),
            ("kernel", lambda: mc_draws.draw_lanes_cuda(*args), 100),
            ("plain", lambda: mc_draws.draw_lanes_plain(*args), 3)):
        timings.setdefault(label, []).append(
            _time_ms(fn, reps_t, behind_spin=label == "kernel"))
    launched = build.LAUNCHES["mc_draw_lanes"] - before
    ms, plain_ms = min(timings["kernel"]), min(timings["plain"])
    bound = _bound(0.0, 4 * b * (2 * n * n + 1))
    print(f"timing draw kernel n={n} B={b}: kernel {timings['kernel']} ms "
          f"(card-paced), plain {timings['plain']} ms (min {ms:.4f} vs "
          f"{plain_ms:.3f} ms); bound {bound[0]:.4f} ms ({bound[1]}, "
          f"{2 * n * n + 1} floats a matrix written), share "
          f"{100 * bound[0] / ms:.1f}%; launches {launched} (202 timed)")
    if launched != 202:
        raise RuntimeError(f"the timed draw kernel launched {launched} times")
    return worst, (ms, plain_ms, bound)


def phase_main_path():
    from code_robchar_tpu_torch.mc import engine
    from code_robchar_tpu_torch.ops import prng

    draw = _hold_draw_kernel()
    n, n_ctrl, n_noise, bootreps = MC_N, MC_CONTROLLERS, MC_NOISES, \
        MC_BOOTREPS
    total = n_ctrl * n_noise * bootreps
    h0, ctrl, noises = _mc_inputs()
    kwargs = dict(complex_offdiag=True, alpha=0.05, device="cuda")

    def run(k):
        return engine.mc_metric_sweep(h0, ctrl, noises, prng.key(k),
                                      bootreps, 0, 6, **kwargs)

    before = build.LAUNCHES.copy()
    warm = run(0)
    float(warm[engine.RIM_NAME].sum())
    times, checksum, first = [], None, None
    for i in range(3):
        start = time.perf_counter()
        metrics = run(1 + i)
        cs = float(metrics[engine.RIM_NAME].sum(dtype=torch.float64))
        times.append(time.perf_counter() - start)
        if checksum is None:
            checksum, first = cs, metrics
    used = build.LAUNCHES - before
    launches, draws = used["herm_jacobi_fidelity"], used["mc_draw_lanes"]
    wall = statistics.median(times)
    print(f"main path: N={n} {n_ctrl} controllers x {n_noise} noise levels x "
          f"{bootreps} bootreps = {total} Hamiltonians; wall {times} s, "
          f"median {wall:.4f} s, {total / wall:.1f} Hams/s; kernel launches "
          f"{launches} over 4 runs, draw kernel launches {draws}")
    if launches <= 0 or draws != launches:
        raise RuntimeError(f"the main path launched kernel 1 {launches} "
                           f"times and the draw kernel {draws} times: one "
                           f"of each a chunk expected")

    for name, v in first.items():
        if v.shape != (n_noise, n_ctrl) or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"metric {name!r}: shape {tuple(v.shape)}, "
                               f"finite {bool(torch.isfinite(v).all())}")
    delta = checksum - JAX_RIM_CHECKSUM
    print(f"rim_checksum {checksum:.3f} vs JAX {JAX_RIM_CHECKSUM} "
          f"(delta {delta:+.4f}, tol 1.0)")
    if abs(delta) > 1.0:
        raise RuntimeError(f"rim_checksum {checksum} misses the JAX value "
                           f"{JAX_RIM_CHECKSUM} by {delta}")

    # the same slice through the float64 plain path on the CPU
    sl = 16
    ref = engine.mc_metric_sweep(h0.double(), ctrl[:sl].astype(np.float64),
                                 noises.astype(np.float64), prng.key(1),
                                 bootreps, 0, 6, complex_offdiag=True,
                                 alpha=0.05, device="cpu")
    part = engine.mc_metric_sweep(h0, ctrl[:sl], noises, prng.key(1),
                                  bootreps, 0, 6, **kwargs)
    for name in (engine.RIM_NAME, "std", "worst case fid"):
        err = float((part[name].cpu().double() - ref[name]).abs().max())
        print(f"slice {name!r}: max|cuda f32 - cpu f64| {err:.3e} "
              f"(tol {TOL_SLICE:g})")
        if err > TOL_SLICE:
            raise RuntimeError(f"main path disagrees with the f64 plain "
                               f"path on {name!r}: {err}")
    return used, wall, total / wall, checksum, first, draw


def _sym_cases(rng, n, b):
    """Random symmetric amplitude inputs a (n, n, B), t (B,) and gradient
    inputs h0 (n, n), xs (B, n+1), float32, from ``rng``."""
    a = rng.normal(size=(b, n, n))
    a = (a + a.transpose(0, 2, 1)) / 2
    h0 = rng.normal(size=(n, n))
    xs = np.column_stack([rng.uniform(-2, 2, (b, n)), rng.uniform(0.5, 5, b)])
    return (np.moveaxis(a, 0, -1).astype(np.float32).copy(),
            rng.uniform(1, 5, b).astype(np.float32),
            ((h0 + h0.T) / 2).astype(np.float32), xs.astype(np.float32))


def _ring_cases(rng, n, per_scale=200):
    ring = np.eye(n, k=1) + np.eye(n, k=-1)
    ring[0, n - 1] = ring[n - 1, 0] = 1.0
    xs = np.asarray([np.concatenate([rng.uniform(-s, s, n),
                                     rng.uniform(2.0, 20.0, 1)])
                     for s in (0.0, 1e-4, 1e-2) for _ in range(per_scale)])
    a = ring[None] + np.eye(n)[None] * xs[:, None, :n]
    return (np.moveaxis(a, 0, -1).astype(np.float32).copy(),
            np.abs(xs[:, n]).astype(np.float32), ring.astype(np.float32),
            xs.astype(np.float32))


def _sym_oracle(a, t, i, o):
    """Float64 eigh: |sum_k V[o,k] V[i,k] e^{-i t lam_k}|^2 per batch
    element of a (n, n, B)."""
    lam, v = np.linalg.eigh(np.moveaxis(a, -1, 0).astype(np.float64))
    ph = (v[:, o, :] * v[:, i, :]
          * np.exp(-1j * lam * t.astype(np.float64)[:, None])).sum(-1)
    return np.abs(ph) ** 2


def _grad_oracle(h0, xs, i, o):
    """Float64 eigh and the Daleckii-Krein formula: (err (B,),
    grad (B, n+1)) of 1 - |<o| exp(-i T (h0 + diag x)) |i>|^2."""
    xs = xs.astype(np.float64)
    n = h0.shape[0]
    t = np.abs(xs[:, n])
    lam, v = np.linalg.eigh(h0.astype(np.float64)[None]
                            + np.eye(n)[None] * xs[:, None, :n])
    vin, vout = v[:, i, :], v[:, o, :]
    f = np.exp(-1j * lam * t[:, None])
    phi = (vout * vin * f).sum(-1)
    dl = lam[:, :, None] - lam[:, None, :]
    mid = 0.5 * (lam[:, :, None] + lam[:, None, :])
    gam = -1j * t[:, None, None] * np.exp(-1j * t[:, None, None] * mid) \
        * np.sinc(t[:, None, None] * dl / (2 * np.pi))
    dphi = np.einsum("blj,bj,bjk,blk,bk->bl", v, vout, gam, v, vin)
    grad = np.empty_like(xs)
    grad[:, :n] = -2.0 * (dphi * phi.conj()[:, None]).real
    grad[:, n] = -2.0 * ((lam * vout * vin * f).sum(-1) * phi.conj()).imag
    return 1.0 - np.abs(phi) ** 2, grad


def _hold_zoo_kernels(label, a, t, h0, xs, i, o, worst):
    """Every kernel of both real symmetric functions (one thread per
    matrix, a group of lanes per matrix) against the plain versions on the
    card, at the bars of tests/test_pallas.py: amplitude a (n, n, B),
    t (B,); gradient h0 (n, n), xs (B', n+1).  Raises on a disagreement or
    a non-finite value, folds each kernel's max abs errors into ``worst``
    and returns {kernel: (phr, phi)} and {kernel: (err, grad)}."""
    from code_robchar_tpu_torch.ops import cuda_jacobi, realform

    pr, pi = realform.transfer_amp_sym_lanes(a, t, i, o)
    perr, pgrad = realform.infidelity_and_gradient_sym_lanes(h0, xs, i, o)
    amps, grads = {}, {}
    for kernel in AMP_KERNELS:
        phr, phi = amps[kernel] = cuda_jacobi.transfer_amp_sym_kernel(
            kernel, a, t, i, o)
        e_amp = max(float((phr - pr).abs().max()),
                    float((phi - pi).abs().max()))
        ok = (bool(torch.isfinite(phr).all() & torch.isfinite(phi).all())
              and e_amp <= TOL_KERNEL)
        print(f"zoo kernel {kernel} {label} n={a.shape[0]} B={a.shape[-1]} "
              f"in={i} out={o}: amp-plain {e_amp:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{kernel} disagrees with its plain version "
                               f"({label} in={i} out={o})")
        worst[kernel] = max(worst[kernel], e_amp)
    for kernel in GRAD_KERNELS:
        err, grad = grads[kernel] = \
            cuda_jacobi.infidelity_and_gradient_sym_kernel(kernel, h0, xs, i,
                                                           o)
        e_err = float((err - perr).abs().max())
        e_grad = float((grad - pgrad).abs().max())
        ok = (bool(torch.isfinite(err).all() & torch.isfinite(grad).all())
              and bool(((err - perr).abs() <= 2e-6 + 1e-5 * perr.abs()).all())
              and bool(((grad - pgrad).abs()
                        <= 2e-5 + 1e-4 * pgrad.abs()).all()))
        print(f"zoo kernel {kernel} {label} n={a.shape[0]} B={xs.shape[0]} "
              f"in={i} out={o}: err-plain {e_err:.3e}, grad-plain "
              f"{e_grad:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{kernel} disagrees with its plain version "
                               f"({label} in={i} out={o})")
        worst[kernel] = max(worst[kernel], e_grad, e_err)
    return amps, grads


def _hold_fast_angles(dev):
    """The lane-group kernels take a pivot's angles by written-out fast
    paths of division and sqrtf (csrc/jacobi_common.cuh sym_angles_fast).
    csrc/angles_probe.cu runs them beside `/`, sqrtf and sym_angles: they
    must agree bit for bit wherever the operands are in the ranges the fast
    paths check (the sign of a zero quotient aside, which the angles do not
    read), on magnitudes spread over 2^-45..2^45 with zeros and equal
    diagonals among them, and on the entries of standard normal matrices,
    which must all but be in range."""
    from code_robchar_tpu_torch.ops import cuda_jacobi

    rng = np.random.default_rng(5)
    count = 1 << 22
    wide = (rng.choice([-1.0, 1.0], (3, count)) * rng.uniform(1, 2, (3, count))
            * 2.0 ** rng.integers(-45, 46, (3, count)))
    wide[0, ::7] = wide[1, ::7]
    wide[2, ::11] = 0.0
    wide[0, ::13] = 0.0
    for label, x, least in (("wide", wide, 0.3),
                            ("matrix", rng.normal(size=(3, count)), 0.999)):
        exact, fast = cuda_jacobi.angles_probe(
            torch.as_tensor(x.astype(np.float32), device=dev))
        flags = fast[6].to(torch.int32)
        same = exact.view(torch.int32) == fast[:6].view(torch.int32)
        in_range = [(flags & m) != 0 for m in (1, 2, 4)]
        apart = (int((~same[:4].all(0) & in_range[0]).sum()),
                 int(((exact[4] != fast[4]) & in_range[1]).sum()),
                 int((~same[5] & in_range[2]).sum()))
        shares = [float(r.float().mean()) for r in in_range]
        ok = apart == (0, 0, 0) and shares[0] >= least and \
            bool(torch.isfinite(exact[:4]).all())
        print(f"fast angle paths vs `/`, sqrtf, sym_angles ({label} "
              f"operands, {count} pivots): in range angles {shares[0]:.4f}, "
              f"division {shares[1]:.4f}, sqrt {shares[2]:.4f}; differing in "
              f"any bit there: angles {apart[0]}, division {apart[1]}, sqrt "
              f"{apart[2]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the fast angle paths differ from IEEE "
                               "division and sqrtf inside their ranges")


def _lanes_of(opt, xs):
    """The amplitude kernel's inputs for the controllers xs (K, n+1) of
    ``opt``, as the noiseless objective assembles them."""
    from code_robchar_tpu_torch.models import objectives

    n = opt.Nspin
    return objectives._assemble_lanes(opt.HH, xs), xs[:, n].abs()


def phase_zoo_kernels():
    from code_robchar_tpu_torch.models import LBFGS, NMPlus
    from code_robchar_tpu_torch.ops import cuda_jacobi, realform

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    worst = dict.fromkeys(AMP_KERNELS + GRAD_KERNELS, 0.0)
    cases = [("random", n, *_sym_cases(rng, n, 5000)) for n in (4, 7, 10)]
    cases += [("ring", n, *_ring_cases(rng, n)) for n in (5, 6)]
    for label, n, a, t, h0, xs in cases:
        ga, gt, gh, gx = (torch.as_tensor(x, device=dev)
                          for x in (a, t, h0, xs))
        for i, o in ((0, n - 1), (1, 2)):
            amps, grads = _hold_zoo_kernels(label, ga, gt, gh, gx, i, o,
                                            worst)
            o_fid = _sym_oracle(a, t, i, o)
            oerr, ograd = _grad_oracle(h0, xs, i, o)
            for kernel, (phr, phi) in amps.items():
                fid = (phr * phr + phi * phi).cpu().numpy()
                e_fid = float(np.abs(fid - o_fid).max())
                ok = e_fid <= TOL_KERNEL
                print(f"zoo kernel {kernel} {label} n={n} in={i} out={o} vs "
                      f"f64 eigh: fid {e_fid:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(f"{kernel} disagrees with the f64 "
                                       f"oracle ({label} n={n} in={i} "
                                       f"out={o})")
            for kernel, (err, grad) in grads.items():
                e_oerr = float(np.abs(err.cpu().numpy() - oerr).max())
                e_ograd = float(np.abs(grad.cpu().numpy() - ograd).max())
                ok = e_oerr <= TOL_KERNEL and e_ograd <= TOL_GRAD_ORACLE
                print(f"zoo kernel {kernel} {label} n={n} in={i} out={o} vs "
                      f"f64 eigh: err {e_oerr:.3e}, grad {e_ograd:.3e} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(f"{kernel} disagrees with the f64 "
                                       f"oracle ({label} n={n} in={i} "
                                       f"out={o})")

    # the zoo path's own first inputs: the L-BFGS lanes' first gradient
    # batch (1024 pool starts across the bounds, T up to 30) and the first
    # NM round's batch (the initial simplices of 1024 starts, 9216 points)
    lb, nm = _zoo_optimizer(LBFGS), _zoo_optimizer(NMPlus)
    x0 = torch.as_tensor(lb.init_points(1024), dtype=torch.float32,
                         device=dev)
    simplices = nm.initial_simplices(x0).reshape(-1, x0.shape[1])
    _hold_zoo_kernels("path starts", *_lanes_of(nm, simplices), lb.HH, x0, 0,
                      6, worst)

    _hold_fast_angles(dev)

    # what a launch costs when the kernel does nothing, through the
    # binding and the call of the kernels: the bound of the gradient at
    # B = 1024 (0.0002 ms) lies far under it
    floor = {"card-paced": _time_ms(lambda: cuda_jacobi.launch_floor(dev),
                                    100, behind_spin=True),
             "host-paced": _time_ms(lambda: cuda_jacobi.launch_floor(dev),
                                    100)}
    print(f"launch_floor_ms (an empty kernel through the kernels' ctypes "
          f"entry, 100 launches): card-paced "
          f"{floor['card-paced']:.5f} ms, host-paced "
          f"{floor['host-paced']:.5f} ms a launch")

    # every kernel at n = 7 and the batches of the paths (1024 L-BFGS
    # lanes, 9216 = 1024 NM lanes x 9 slots, 131072), card-paced; the
    # host-paced time and the plain version's beside it
    timings = {}
    a_all, t_all, h0, xs_all = (torch.as_tensor(x, device=dev) for x in
                                _sym_cases(rng, 7, 131072))
    for b in (1024, 9216, 131072):
        a, t, xs = a_all[..., :b].contiguous(), t_all[:b], xs_all[:b]
        _hold_zoo_kernels("timed", a, t, h0, xs, 0, 6, worst)
        # the library call only where the kernels line reads it
        mats = {"amp": lambda: a.permute(2, 0, 1).contiguous(),
                "grad": lambda: (h0 + torch.diag_embed(xs[:, :7]))
                .contiguous()}
        lib = {kind: _eigh_ms(mats[kind]()) if any(
            LINE_BATCH.get(k) == b for k in names) else (None, "not timed")
            for kind, names in (("amp", AMP_KERNELS), ("grad", GRAD_KERNELS))}
        bound = {"amp": _bound(b * _amp_flops(7, 5), 4 * b * (49 + 1 + 2)),
                 "grad": _bound(b * _grad_flops(7, 5),
                                4 * (49 + b * (8 + 1 + 8)))}
        plain = {"amp": lambda: realform.transfer_amp_sym_lanes(a, t, 0, 6),
                 "grad": lambda: realform.infidelity_and_gradient_sym_lanes(
                     h0, xs, 0, 6)}
        plain_ms = {k: min(_time_ms(fn, 3), _time_ms(fn, 3))
                    for k, fn in plain.items()}
        kerns = [(k, "amp", lambda k=k: cuda_jacobi.transfer_amp_sym_kernel(
            k, a, t, 0, 6)) for k in AMP_KERNELS]
        kerns += [(k, "grad", lambda k=k:
                   cuda_jacobi.infidelity_and_gradient_sym_kernel(
                       k, h0, xs, 0, 6)) for k in GRAD_KERNELS]
        runs = {k: [] for k, _, _ in kerns}
        host = {}
        for k, _, fn in kerns + kerns[::-1]:       # one, group, group, one
            runs[k].append(_time_ms(fn, 100, behind_spin=True))
            host[k] = _time_ms(fn, 100)
        routed = {"amp": cuda_jacobi.amp_route(7, b),
                  "grad": cuda_jacobi.grad_route(7, b)}
        for k, kind, _ in kerns:
            timings[k, b] = (min(runs[k]), plain_ms[kind], lib[kind][0],
                             bound[kind])
            print(f"timing {k} n=7 B={b}: card-paced {runs[k]} ms, "
                  f"host-paced {host[k]:.5f} ms, plain {plain_ms[kind]:.3f} "
                  f"ms; torch.linalg.eigh ({lib[kind][1]}, "
                  f"eigendecomposition only) {lib[kind][0]} ms; bound "
                  f"{bound[kind][0]:.5f} ms ({bound[kind][1]}); route at "
                  f"this shape: {routed[kind]}")
    return worst, timings, floor


def _zoo_optimizer(cls, n=7, out=6, **kw):
    return cls(n, 0, out, testing=True, fid_threshold=2.0, repeats=10**9,
               run_until_told_to_stop=True, run_until_completion_its=10**12,
               landscape_exploration=True, save_topc=64, device="cuda",
               dtype=torch.float32, **kw)


def phase_zoo_path(worst):
    from code_robchar_tpu_torch.models import LBFGS, NMPlus
    from code_robchar_tpu_torch.ops import cuda_jacobi, prng, realform

    out, ends = {}, {}
    start_counts = build.LAUNCHES.copy()
    for cls, warm, timed in ((LBFGS, 5, (7, 8, 9)), (NMPlus, 15, (16, 17, 18))):
        opt = _zoo_optimizer(cls)
        before = build.LAUNCHES.copy()

        def run(seed):
            x0s = torch.as_tensor(opt.init_points(ZOO_POOL),
                                  dtype=torch.float32, device="cuda")
            res = opt._run_batch(x0s, prng.split(prng.key(seed), ZOO_POOL))
            float(res.fid.sum())
            return res

        run(warm)
        times, stats = [], []
        for seed in timed:
            start = time.perf_counter()
            res = run(seed)
            times.append(time.perf_counter() - start)
            stats.append(dict(opt.stats))
            fid = res.fid.cpu().numpy()
            if fid.shape != (ZOO_POOL,) or not np.isfinite(fid).all() or \
                    fid.min() < -1e-5 or fid.max() > 1 + 1e-5 or \
                    int(res.nfev.min()) <= 0:
                raise RuntimeError(f"{cls.name}: bad batch result")
        used = build.LAUNCHES - before
        wall = statistics.median(times)
        print(f"zoo path {cls.name}: N=7 pool {ZOO_POOL}, lanes "
              f"{opt.lane_width}; wall {times} s, median {wall:.4f} s, "
              f"{ZOO_POOL / wall:.1f} restarts/s; per run {stats}; launches "
              f"over 4 runs: {used}; best fid {fid.max():.6f}")
        # the path must take the kernel its shapes are routed to, and for
        # the lanes' gradient batches and the NM rounds no other
        if cls is LBFGS:
            want = cuda_jacobi.grad_route(7, opt.lane_width)
            other = GRAD_KERNELS[want == GRAD_KERNELS[0]]
            taken = used[want] > 0 and used[other] == 0 and \
                used["sym_jacobi_amp"] + used["sym_jacobi_amp_group"] > 0
        else:
            want = cuda_jacobi.amp_route(7, opt.lane_width * 9)
            taken = used[want] > 0
        if not taken:
            raise RuntimeError(f"{cls.name}: the zoo path did not take "
                               f"{want}, the kernel its shapes are routed "
                               f"to: {used}")
        out[cls.name] = (wall, ZOO_POOL / wall, stats[0])
        ends[cls.name] = res.x
    launches = build.LAUNCHES - start_counts

    # the one-thread gradient kernel's own path: L-BFGS lanes wide enough
    # to fill the card (a pool of WIDE_LANES restarts in WIDE_LANES lanes,
    # three iterations), its launches counted from just before
    opt = _zoo_optimizer(LBFGS, lane_width=WIDE_LANES, maxiter=3)
    if cuda_jacobi.grad_route(7, WIDE_LANES) != "sym_jacobi_grad":
        raise RuntimeError(f"{WIDE_LANES} lanes are not routed to the "
                           f"one-thread gradient kernel")
    x0s = torch.as_tensor(opt.init_points(WIDE_LANES), dtype=torch.float32,
                          device="cuda")
    got = cuda_jacobi.infidelity_and_gradient_sym_kernel("sym_jacobi_grad",
                                                         opt.HH, x0s, 0, 6)
    want = realform.infidelity_and_gradient_sym_lanes(opt.HH, x0s, 0, 6)
    e_err, e_grad = (float((g - w).abs().max()) for g, w in zip(got, want))
    ok = all(bool(((g - w).abs() <= atol + rtol * w.abs()).all())
             for g, w, atol, rtol in zip(got, want, (2e-6, 2e-5),
                                         (1e-5, 1e-4)))
    print(f"zoo kernel sym_jacobi_grad at the wide path's starts n=7 "
          f"B={WIDE_LANES}: err-plain {e_err:.3e}, grad-plain {e_grad:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("sym_jacobi_grad disagrees with its plain version "
                           "at the wide path's starts")
    worst["sym_jacobi_grad"] = max(worst["sym_jacobi_grad"], e_err, e_grad)
    before = build.LAUNCHES.copy()
    start = time.perf_counter()
    res = opt._run_batch(x0s, prng.split(prng.key(21), WIDE_LANES))
    fid = res.fid.cpu().numpy()
    wide = build.LAUNCHES - before
    launches["sym_jacobi_grad"] = wide["sym_jacobi_grad"]
    print(f"wide L-BFGS path: N=7 pool {WIDE_LANES} in {WIDE_LANES} lanes, "
          f"maxiter 3: {time.perf_counter() - start:.2f} s, {opt.stats}; "
          f"sym_jacobi_grad launches {launches['sym_jacobi_grad']} "
          f"(sym_jacobi_grad_group {wide['sym_jacobi_grad_group']}); best "
          f"fid {fid.max():.6f}")
    if launches["sym_jacobi_grad"] <= 0 or not np.isfinite(fid).all() or \
            fid.min() < -1e-5 or fid.max() > 1 + 1e-5:
        raise RuntimeError("the wide L-BFGS path failed or launched no "
                           "one-thread gradient kernel")

    # the same configuration with a budget, and fid_threshold 0 so that
    # the first batch's best is recorded (2.0 above never records)
    opt = _zoo_optimizer(LBFGS)
    opt.run_until_completion_its = 200_000
    opt.fid_threshold = 0.0
    start = time.perf_counter()
    opt.run()
    rec = opt.record
    print(f"zoo budget run: LBFGS N=7 budget 200000: func_calls "
          f"{rec['func_calls']}, repeats {rec['repeats']}, best_fid "
          f"{rec['best_fid']!r} (the last batch's best), controllers "
          f"{len(rec.get('controllers', []))}, "
          f"{time.perf_counter() - start:.2f} s")
    if not rec.get("controllers") or rec["func_calls"] + 1 < 200_000:
        raise RuntimeError("the budget-mode run did not finish its budget")

    # the routed (lane-group) kernels at both optimizers' end states, the
    # one-thread kernels at the first's
    pairs = list(zip(AMP_KERNELS, GRAD_KERNELS))
    for name, xs in ends.items():
        _hold_zoo_ends(name, opt, xs, worst, pairs)
        pairs = pairs[1:]
    return launches, out


def _hold_zoo_ends(name, opt, xs, worst, pairs):
    """The zoo kernels ``pairs`` (amplitude kernel, gradient kernel) at the
    path's end states: an optimizer's last pool of
    results, where T reaches 30, phases lam*T a few hundred radians and
    the best restarts sit near fidelity 1.  There float32 itself misses the
    float64 values by up to ~1e-5 in fidelity and ~1e-4 in gradient (the
    plain versions on the CPU do), so kernel and plain version differ by
    more than test_pallas's bars; both are held against the float64 eigh
    oracle instead: each kernel's worst error must lie within the oracle
    bars (fidelity 3e-5, gradient 1e-4) or within 3x the plain version's
    own worst error."""
    from code_robchar_tpu_torch.ops import cuda_jacobi, realform

    a, t = _lanes_of(opt, xs)
    h0 = opt.HH
    pr, pi = realform.transfer_amp_sym_lanes(a, t, 0, 6)
    plain = (pr * pr + pi * pi,
             *realform.infidelity_and_gradient_sym_lanes(h0, xs, 0, 6))
    xs_np = xs.cpu().numpy()
    oracle = (_sym_oracle(a.cpu().numpy(), t.cpu().numpy(), 0, 6),
              *_grad_oracle(h0.cpu().numpy(), xs_np, 0, 6))
    for amp_kernel, grad_kernel in pairs:
        phr, phi = cuda_jacobi.transfer_amp_sym_kernel(amp_kernel, a, t, 0,
                                                       6)
        kern = (phr * phr + phi * phi,
                *cuda_jacobi.infidelity_and_gradient_sym_kernel(
                    grad_kernel, h0, xs, 0, 6))
        report, ok = [], True
        for what, k, p, o, bar in zip(
                ("fid", "err", "grad"), kern, plain, oracle,
                (TOL_KERNEL, TOL_KERNEL, TOL_GRAD_ORACLE)):
            e_kp = float((k - p).abs().max())
            e_k = float(np.abs(k.cpu().numpy() - o).max())
            e_p = float(np.abs(p.cpu().numpy() - o).max())
            ok &= bool(torch.isfinite(k).all()) and e_k <= max(bar, 3 * e_p)
            report.append(f"{what}: kernel-plain {e_kp:.3e}, kernel-f64 "
                          f"{e_k:.3e}, plain-f64 {e_p:.3e}")
            name_k = amp_kernel if what == "fid" else grad_kernel
            worst[name_k] = max(worst[name_k], e_kp)
        print(f"zoo kernels {amp_kernel}, {grad_kernel} at the {name} end "
              f"states (n=7 B={xs.shape[0]}, 0->6): " + "; ".join(report)
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{amp_kernel} or {grad_kernel} at the "
                               f"{name} end states is less accurate than "
                               f"the plain version")


def _parted(a, b):
    """How many restarts of two batch results end more than 1e-3 apart."""
    return int(((a.x.cpu() - b.x.cpu()).abs().amax(1) > 1e-3).sum())


def _starts_runs(x0, keys, make, drive=None):
    """The runs of a card-vs-CPU hold: ``run(device, nudge=False, **kw)``
    is ``drive(opt, x, keys)`` (one ``_run_batch`` by default) for ``opt =
    make(device, **kw)`` on the float32 starts ``x0``, moved one ulp up
    when ``nudge`` (the witness of how far a rounding parts the runs).
    Also returns ``last``, the optimizer of the last run on each device."""
    last = {}

    def run(device, nudge=False, **kw):
        x = torch.as_tensor(x0, dtype=torch.float32, device=device)
        if nudge:
            x = torch.nextafter(x, torch.full_like(x, float("inf")))
        opt = last[device] = make(device, **kw)
        return (drive or type(opt)._run_batch)(opt, x, keys)

    return run, last


def _zoo_card_vs_cpu(cls):
    """32 restarts at N=4, float32, through the kernels on the card against
    the plain versions on the CPU.  Over their first iterations (L-BFGS
    maxiter 3, NM maxfev 30) 28 of 32 must end within 1e-3.  Over whole
    runs a rounding-level difference flips line-search and simplex
    comparisons and the trajectories part; that reading is printed beside
    three witnesses of it: the plain versions on the card in place of the
    kernels, and the starts moved by one ulp on the card and on the CPU."""
    from unittest import mock

    from code_robchar_tpu_torch.models import LBFGS
    from code_robchar_tpu_torch.ops import cuda_jacobi, prng, realform

    x0 = cls(4, 0, 2, testing=True, seed=2, device="cpu").init_points(32)
    run, _ = _starts_runs(x0, prng.split(prng.key(0), 32), lambda device, **kw:
                          cls(4, 0, 2, testing=True, seed=2, lane_width=16,
                              device=device, **kw))

    first = {"maxiter": 3} if cls is LBFGS else {"maxfev": 30}
    got, want = run("cuda", **first), run("cpu", **first)
    close = 32 - _parted(got, want)
    print(f"zoo {cls.name} card vs cpu (N=4, 32 restarts, f32, first "
          f"iterations {first}): {close}/32 restarts within 1e-3, max |dfid| "
          f"{float((got.fid.cpu() - want.fid).abs().max()):.3e}")
    if close < 28:
        raise RuntimeError(f"{cls.name}: card and CPU runs disagree")

    card, cpu = run("cuda"), run("cpu")
    with mock.patch.multiple(
            cuda_jacobi,
            transfer_amp_sym_cuda=realform.transfer_amp_sym_lanes,
            infidelity_and_gradient_sym_cuda=realform
            .infidelity_and_gradient_sym_lanes):
        card_plain = run("cuda")
    readings = {
        "kernels on the card vs the CPU": _parted(card, cpu),
        "plain versions on the card vs the CPU": _parted(card_plain, cpu),
        "the card vs itself, starts moved one ulp":
            _parted(card, run("cuda", nudge=True)),
        "the CPU vs itself, starts moved one ulp":
            _parted(cpu, run("cpu", nudge=True)),
    }
    print(f"zoo {cls.name} whole runs (N=4, 32 restarts, f32), restarts "
          f"ending > 1e-3 apart: " + "; ".join(
              f"{k} {v}/32" for k, v in readings.items())
          + f"; max |dfid| card vs cpu "
          f"{float((card.fid.cpu() - cpu.fid).abs().max()):.3e}")


def phase_zoo_gates():
    import scipy.stats

    from code_robchar_tpu_torch.models import LBFGS, NMPlus
    from code_robchar_tpu_torch.ops import prng

    stats = {}
    for cls, art_name in ((LBFGS, "scipy_lbfgs_dist.json"),
                          (NMPlus, "scipy_nm_dist.json")):
        with open(f"artifacts/{art_name}") as f:
            art = json.load(f)
        for n, out in ((4, 2), (5, 2)):
            ref = art[f"{n}_{out}"]
            opt = cls(n, 0, out, testing=True, seed=7, device="cuda",
                      dtype=torch.float32)
            x0s = torch.as_tensor(opt.init_points(512), dtype=torch.float32,
                                  device="cuda")
            res = opt._run_batch(x0s, prng.split(prng.key(0), 512))
            ks = float(scipy.stats.ks_2samp(res.fid.cpu().numpy(),
                                            np.asarray(ref["fids"]))[0])
            nfev = float(res.nfev.double().mean())
            ok = ks < KS_GATE and (cls is LBFGS or
                                   abs(nfev - ref["mean_nfev"]) < 15)
            print(f"zoo gate {cls.name} N={n} 0->{out}: KS {ks:.4f} (gate "
                  f"{KS_GATE}), mean nfev {nfev:.1f} (scipy "
                  f"{ref.get('mean_nfev', float('nan')):.1f}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{cls.name} N={n}: outcome gate failed")
            stats[cls.name, n] = ks

        _zoo_card_vs_cpu(cls)
    return stats


def _rollout_inputs(a_cnt, t_len, ham_noisy, seed, hid=100):
    """The rollout kernel's inputs at N=7, hidden width ``hid`` on the card:
    actor weights from the port's init, carries spread up to the wrap
    bounds, threefry noise (sigma 0.05 on the Hamiltonian)."""
    from code_robchar_tpu_torch.models import actor_critic as ac
    from code_robchar_tpu_torch.ops import chain, prng, rollout

    n, d = 7, 8
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    params = ac.init_params(prng.split(prng.key(seed), a_cnt).to(dev), d, d,
                            hidden=(hid, hid), device=dev)
    k_eps, k_zd, k_zn = prng.split(prng.key(seed + 1).to(dev), 3)
    noisy = {}
    if ham_noisy:
        noisy = dict(zdiag=prng.normal(k_zd, (t_len, n, a_cnt)) * 0.05,
                     znn=prng.normal(k_zn, (t_len, n - 1, a_cnt)) * 0.05)
    return (*rollout.fold_actor_weights(params),
            chain.xx_hamiltonian_real(n, dtype=torch.float32, device=dev),
            torch.as_tensor(rng.uniform(-9.5, 9.5, (n, a_cnt)), **f32),
            torch.as_tensor(rng.uniform(0, 30, a_cnt), **f32),
            torch.as_tensor(rng.integers(0, 40, a_cnt), dtype=torch.int32,
                            device=dev),
            prng.normal(k_eps, (t_len, d, a_cnt)),
            noisy.get("zdiag"), noisy.get("znn"))


def _near_wrap(raw, n, bmax, maxtime, tol=1e-5):
    """(A,) bool: raw (d, A) pre-wrap actions and time within ``tol`` of a
    wrap boundary (a multiple of bmax or maxtime, or a time of 0, where
    done flips)."""
    def close(x, period):
        m = torch.round(x.abs() / period)
        return (m >= 1) & ((x.abs() - m * period).abs() < tol)

    return (close(raw[:n], bmax).any(0) | close(raw[n], maxtime)
            | (raw[n].abs() < tol))


def _rollouts_parted(x, y):
    """(A,) bool: agents whose trajectories (a RolloutOut each) differ by
    more than TOL_PPO anywhere, or in a done or timeout flag."""
    err = torch.stack([(x.a - y.a).abs().amax((0, 1)),
                       (x.fid - y.fid).abs().amax(0),
                       (x.obs2 - y.obs2).abs().amax((0, 1))]).amax(0)
    flags = ((x.done != y.done) | (x.timeout != y.timeout)).any(0)
    return (err > TOL_PPO) | flags | ~torch.isfinite(err)


def _hold_rollout(label, args, kw, free=True):
    """The rollout kernel against its plain version on the card, step by
    step: each step of the plain version starts from the kernel's own
    carry (rebuilt from its obs2, done and timeout), so a rounding
    difference of one step is not amplified by the next ones.  Free
    running, the accumulated action feeds back through the MLP and the
    trajectories part; with ``free`` that count is printed beside a
    witness, the plain version against itself with the carry moved one
    ulp.  Returns the max abs error of the agents that agree."""
    from code_robchar_tpu_torch.ops import rollout

    w1, w2, w3, ls, h0, action, tstep, ep_len, eps, zd, zn = args
    reg = w2.shape[-1] == rollout.REG_HIDDEN
    before = build.LAUNCHES.copy()
    got = rollout.actor_env_rollout(*args, **kw)
    torch.cuda.synchronize()
    took = build.LAUNCHES - before
    entry = "actor_env_rollout_reg" if reg else "actor_env_rollout"
    if took != Counter({entry: 1}):
        raise RuntimeError(f"rollout {label}: launches {took}, expected one "
                           f"of {entry} alone")
    n = action.shape[0]
    t_len, a_cnt = got.fid.shape
    err = torch.zeros(a_cnt, device=h0.device)
    flags = torch.zeros(a_cnt, dtype=torch.bool, device=h0.device)
    near = torch.zeros_like(flags)
    act, t, ep = action, tstep, ep_len
    for s in range(t_len):
        one = rollout.actor_env_rollout_plain(
            w1, w2, w3, ls, h0, act, t, ep, eps[s:s + 1],
            None if zd is None else zd[s:s + 1],
            None if zn is None else zn[s:s + 1], **kw)
        err = torch.maximum(err, torch.stack([
            (got.a[s] - one.a[0]).abs().amax(0),
            (got.fid[s] - one.fid[0]).abs(),
            (got.obs2[s] - one.obs2[0]).abs().amax(0)]).amax(0))
        flags |= (got.done[s] != one.done[0]) | \
            (got.timeout[s] != one.timeout[0])
        near |= _near_wrap(torch.cat([act, t[None]]) + one.a[0], n,
                           kw["bmax"], kw["maxtime"])
        term = got.done[s] | got.timeout[s]
        act = torch.where(term[None], 0.0, got.obs2[s, :n])
        t = torch.where(term, 0.0, got.obs2[s, n])
        ep = torch.where(term, 0, ep + 1)
    parted = (err > TOL_PPO) | flags | ~torch.isfinite(err)
    n_parted, n_other = int(parted.sum()), int((parted & ~near).sum())
    worst = float(err[~parted].max()) if n_parted < a_cnt else float("nan")

    ok = n_other == 0 and n_parted <= 0.01 * a_cnt
    report = ""
    if free:
        plain = rollout.actor_env_rollout_plain(*args, **kw)
        nudged = list(args)
        nudged[5] = torch.nextafter(action, torch.full_like(action, np.inf))
        witness = rollout.actor_env_rollout_plain(*nudged, **kw)
        report = (f"; free running, agents > {TOL_PPO:g} apart: kernel vs "
                  f"plain {int(_rollouts_parted(got, plain).sum())}, plain "
                  f"vs plain with the carry one ulp up "
                  f"{int(_rollouts_parted(plain, witness).sum())}")
    print(f"rollout kernel {label} ({entry}): A={a_cnt} T={t_len}, step "
          f"by step from "
          f"the kernel's carry: max |kernel-plain| {worst:.3e} (tol "
          f"{TOL_PPO:g}); parted {n_parted}/{a_cnt}, of them away from a "
          f"wrap boundary {n_other} {'ok' if ok else 'FAIL'}{report}; "
          f"timeouts {int(got.timeout.sum())}, dones {int(got.done.sum())}")
    if not ok:
        raise RuntimeError(f"rollout kernel disagrees with its plain version "
                           f"({label})")
    return worst


def _critic_inputs(a_cnt, t_len, seed, hid=100):
    """Critic weights of width ``hid`` from the port's init, zero moments,
    and a batch of visited controllers and returns, float32 on the card."""
    from code_robchar_tpu_torch.models import actor_critic as ac
    from code_robchar_tpu_torch.ops import critic, prng

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    params = ac.init_params(prng.split(prng.key(seed), a_cnt).to(dev), 8, 8,
                            hidden=(hid, hid), device=dev)
    theta = critic.pack_critic(params, a_cnt)
    obs = np.concatenate([rng.uniform(-10, 10, (a_cnt, t_len, 7)),
                          rng.uniform(0, 30, (a_cnt, t_len, 1))], axis=2)
    return (theta, torch.zeros_like(theta), torch.zeros_like(theta),
            torch.zeros(a_cnt, dtype=torch.int32, device=dev),
            torch.as_tensor(obs, dtype=torch.float32, device=dev),
            torch.as_tensor(rng.uniform(0, 5, (a_cnt, t_len)),
                            dtype=torch.float32, device=dev))


def _hold_critic_f32(label, inputs, h, lr, shares):
    """The float32 critic kernel against critic_train_plain on the card at
    each iteration count of ``shares`` (the gates of phase 7 in the module
    docstring).  Returns (the worst max abs error of theta, mu, nu, the
    kernel's theta after the last count)."""
    from code_robchar_tpu_torch.ops import critic

    a_cnt, t_len = inputs[5].shape
    worst = 0.0
    for iters, share in shares.items():
        got = critic.critic_train_packed(*inputs, h=h, iters=iters, lr=lr)
        want = critic.critic_train_plain(*inputs, h=h, iters=iters, lr=lr)
        torch.cuda.synchronize()
        errs = [float((g - w).abs().max()) for g, w in zip(got[:3], want[:3])]
        over = sum(int(((g - w).abs() > 2e-6 + 1e-5 * w.abs()).sum())
                   for g, w in zip(got[:3], want[:3]))
        total = 3 * got[0].numel()
        ok = (torch.equal(got[3], want[3]) and max(errs) <= 2 * lr * iters
              and over <= share * total)
        print(f"critic kernel {label} A={a_cnt} T={t_len} h={h} "
              f"iters={iters}: max |kernel-plain| theta, mu, nu {errs}; past "
              f"atol 2e-6 + rtol 1e-5: {over} of {total} (at most {share:g} "
              f"of them) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"critic kernel disagrees with its plain "
                               f"version ({label}, iters={iters})")
        worst = max(worst, *errs)
    return worst, got[0]


def _hold_critic_bf16(label, inputs, h, lr):
    """The bf16 critic kernel against critic_train_plain(fast_dot=True) on
    the card at iters 1, 7 and 200 (the gates of phase 7 in the module
    docstring).  Returns (the worst max abs error of theta, mu, nu over
    the three counts, the kernel's and the plain version's theta after 200
    iterations)."""
    from code_robchar_tpu_torch.ops import critic

    def share_past(xs, ys):
        over = sum(int(((x - y).abs() > 2e-6 + 1e-5 * y.abs()).sum())
                   for x, y in zip(xs, ys))
        return over / sum(y.numel() for y in ys)

    a_cnt, t_len = inputs[5].shape
    worst = 0.0
    for iters in (1, 7, 200):
        kw = dict(h=h, iters=iters, lr=lr, fast_dot=True)
        got = critic.critic_train_packed(*inputs, **kw)
        want = critic.critic_train_plain(*inputs, **kw)
        torch.cuda.synchronize()
        errs = [float((g - w).abs().max()) for g, w in zip(got[:3], want[:3])]
        ok = torch.equal(got[3], want[3]) and max(errs) <= 2 * lr * iters
        head = (f"critic bf16 kernel {label} A={a_cnt} T={t_len} h={h} "
                f"iters={iters}: max |kernel-plain| theta, mu, nu {errs}")
        if iters == 1:
            scale = float(want[1].abs().max())
            ok = ok and errs[1] <= CRITIC_BF16_GRAD * scale
            print(f"{head}; largest |mu| {scale:.3e} (max |dmu| at most "
                  f"{CRITIC_BF16_GRAD:g} of it) {'ok' if ok else 'FAIL'}")
        else:
            moved = torch.nextafter(inputs[0],
                                    torch.full_like(inputs[0], np.inf))
            witness = critic.critic_train_plain(moved, *inputs[1:], **kw)
            share = share_past(got[:3], want[:3])
            wit = share_past(witness[:3], want[:3])
            ok = ok and share <= 2 * wit + CRITIC_BF16_MARGIN
            print(f"{head}; share past atol 2e-6 + rtol 1e-5: {share:.3e} "
                  f"(at most twice the witness's plus "
                  f"{CRITIC_BF16_MARGIN:g}); witness, plain vs plain with "
                  f"theta one ulp up: {wit:.3e}, max "
                  f"{float((witness[0] - want[0]).abs().max()):.3e} "
                  f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"the bf16 critic kernel disagrees with its "
                               f"plain version ({label}, iters={iters})")
        worst = max(worst, *errs)
    return worst, got[0], want[0]


def phase_ppo_kernels():
    from code_robchar_tpu_torch.ops import critic, rollout

    kw = dict(in_spin=0, out_spin=6, sweeps=4, bmax=10.0, maxtime=30.0,
              max_ep_len=40)
    worst = {"rollout": 0.0, "critic": 0.0, "critic_bf16": 0.0}
    for a_cnt in (1024, 1000):
        for noisy in (True, False):
            args = _rollout_inputs(a_cnt, 64, noisy, seed=a_cnt + noisy)
            worst["rollout"] = max(worst["rollout"], _hold_rollout(
                f"ham_noisy={noisy}", args, dict(kw, ham_noisy=noisy)))
    # the generic instance (W2 in shared memory) at a width off the path's
    args = _rollout_inputs(1000, 64, True, seed=3, hid=64)
    worst["rollout"] = max(worst["rollout"], _hold_rollout(
        "generic instance h=64, ham_noisy=True", args,
        dict(kw, ham_noisy=True), free=False))

    lr = 1e-3
    inputs = _critic_inputs(PPO_AGENTS, PPO_STEPS, seed=21)
    worst["critic"], f32_theta = _hold_critic_f32(
        "at the path's shapes", inputs, 100, lr, CRITIC_SHARE)
    for label, a_cnt, t_len, hid, seed in CRITIC_F32_SHAPES:
        worst["critic"] = max(worst["critic"], _hold_critic_f32(
            label, _critic_inputs(a_cnt, t_len, seed=seed, hid=hid), hid, lr,
            {7: CRITIC_SHARE[7]})[0])

    worst["critic_bf16"], _, _ = _hold_critic_bf16(
        "ragged", _critic_inputs(130, 300, seed=22, hid=30), 30, lr)
    worst_path, bf16_theta, plain_theta = _hold_critic_bf16(
        "at the path's shapes", inputs, 100, lr)
    worst["critic_bf16"] = max(worst["critic_bf16"], worst_path)
    losses = [critic.value_loss(th, inputs[4], inputs[5], 100)
              for th in (inputs[0], bf16_theta, plain_theta, f32_theta)]
    ok = abs(losses[1] - losses[2]) <= CRITIC_BF16_LOSS * losses[2]
    ok32 = abs(losses[3] - CRITIC_F32_LOSS) <= \
        CRITIC_BF16_LOSS * CRITIC_F32_LOSS
    print(f"critic value loss mean((v - ret)^2), A={PPO_AGENTS} "
          f"T={PPO_STEPS}: start {losses[0]:.6f}; after 200 iterations bf16 "
          f"kernel {losses[1]:.6f}, plain bf16 {losses[2]:.6f}, float32 "
          f"kernel {losses[3]:.6f} (bf16 kernel within "
          f"{CRITIC_BF16_LOSS:g} of plain bf16, relative; float32 kernel "
          f"within as much of {CRITIC_F32_LOSS}) "
          f"{'ok' if ok and ok32 else 'FAIL'}")
    if not ok:
        raise RuntimeError("the bf16 critic kernel's value loss is off its "
                           "plain version's")
    if not ok32:
        raise RuntimeError("the float32 critic kernel's value loss is off "
                           "the earlier kernel's")

    # the path's shapes, held step by step as above (one plain pass), then
    # timed; the plain version is warm from the holds, so its one timed
    # pass needs no warm-up
    timings = {}
    args = _rollout_inputs(PPO_AGENTS, PPO_STEPS, True, seed=5)
    kwt = dict(kw, max_ep_len=1000, ham_noisy=True)
    worst["rollout"] = max(worst["rollout"], _hold_rollout(
        "at the path's shapes, ham_noisy=True", args, kwt, free=False))
    runs = {"plain": [], "kernel": []}
    for label, fn, reps, warm in (
            ("kernel", lambda: rollout.actor_env_rollout(*args, **kwt), 10,
             True),
            ("kernel", lambda: rollout.actor_env_rollout(*args, **kwt), 10,
             True),
            ("plain", lambda: rollout.actor_env_rollout_plain(*args, **kwt),
             1, False)):
        runs[label].append(_time_ms(fn, reps, warm,
                                    behind_spin=label == "kernel"))
    n, h, d, a, t = 7, 100, 8, PPO_AGENTS, PPO_STEPS
    nbytes = 4 * (a * ((d + 1) * h + (h + 1) * h + (h + 1) * d + d)
                  + t * a * (d + n + n - 1) + t * a * (2 * d + 1)
                  + 2 * a * (n + 2) + n * n) + 2 * t * a
    timings["rollout"] = (min(runs["kernel"]), min(runs["plain"]),
                          _bound(a * t * _rollout_step_flops(n, h, 4),
                                 nbytes))
    print(f"timing rollout A={a} T={t} sweeps 4: kernel {runs['kernel']} "
          f"ms (card-paced, actor_env_rollout_reg_kernel), plain "
          f"{runs['plain']} ms; bound "
          f"{timings['rollout'][2][0]:.4f} ms ({timings['rollout'][2][1]})")

    runs = {"plain": [], "kernel": []}
    ck = dict(h=100, iters=200, lr=lr)
    for label, fn, reps in (
            ("plain", lambda: critic.critic_train_plain(*inputs, **ck), 1),
            ("kernel", lambda: critic.critic_train_packed(*inputs, **ck), 2),
            ("kernel", lambda: critic.critic_train_packed(*inputs, **ck), 2),
            ("plain", lambda: critic.critic_train_plain(*inputs, **ck), 1)):
        runs[label].append(_time_ms(fn, reps))
    p = critic.n_params(9, 100)
    timings["critic"] = (min(runs["kernel"]), min(runs["plain"]), _bound(
        a * 200 * _critic_iter_flops(9, 100, t),
        4 * (6 * a * p + a * t * d + a * t) + 8 * a))
    print(f"timing critic A={a} T={t} iters 200: kernel {runs['kernel']} ms, "
          f"plain {runs['plain']} ms; bound {timings['critic'][2][0]:.3f} ms "
          f"({timings['critic'][2][1]})")

    # the same work through the bf16 kernel: its products against the
    # tensor-core rate, the rest against the float32 rate
    runs = {"plain": [], "kernel": []}
    cb = dict(ck, fast_dot=True)
    for label, fn, reps in (
            ("plain", lambda: critic.critic_train_plain(*inputs, **cb), 1),
            ("kernel", lambda: critic.critic_train_packed(*inputs, **cb), 3),
            ("kernel", lambda: critic.critic_train_packed(*inputs, **cb), 3),
            ("plain", lambda: critic.critic_train_plain(*inputs, **cb), 1)):
        runs[label].append(_time_ms(fn, reps))
    mac_flops, other_flops = _critic_iter_ops(9, 100, t)
    timings["critic_bf16"] = (min(runs["kernel"]), min(runs["plain"]), _bound(
        a * 200 * other_flops, 4 * (6 * a * p + a * t * d + a * t) + 8 * a,
        bf16_flops=a * 200 * mac_flops))
    print(f"timing critic bf16 A={a} T={t} iters 200: kernel "
          f"{runs['kernel']} ms, plain {runs['plain']} ms; bound "
          f"{timings['critic_bf16'][2][0]:.3f} ms "
          f"({timings['critic_bf16'][2][1]}); float32 kernel / bf16 kernel "
          f"{timings['critic'][0] / timings['critic_bf16'][0]:.2f}")
    return worst, timings


def phase_ppo_path():
    from code_robchar_tpu_torch.models import PPO_en
    from code_robchar_tpu_torch.ops import critic, prng

    a_cnt, t_len = PPO_AGENTS, PPO_STEPS
    ppo = PPO_en(7, 0, 6, testing=True, fid_threshold=0.0, ham_noisy=True,
                 run_until_told_to_stop=True, run_until_completion_its=10**12,
                 landscape_exploration=True, save_topc=100,
                 num_agents=a_cnt, rollout_sweeps=4, device="cuda",
                 dtype=torch.float32)
    epoch_fn = ppo._build_epoch(t_len, 0.2, 3e-3, 1e-3, 1000, 200, 200, 0.01)
    st = ppo._init_agent(prng.split(prng.key(0), a_cnt))
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    ppo.stage_hook = mark
    before = build.LAUNCHES.copy()
    for _ in range(2):
        st, out = epoch_fn(st)
        float(out.rewards.sum())
    marks.clear()
    start = time.perf_counter()
    pi_iters, rewards = [], []
    for _ in range(3):
        st, out = epoch_fn(st)
        rewards.append(out.rewards)
        pi_iters.append(float(out.pi_iters.double().mean()))
        float(out.rewards.sum())
    wall = time.perf_counter() - start
    used = build.LAUNCHES - before
    launches = Counter({k: used[k] for k in (
        "actor_env_rollout_reg", "critic_train_bf16", "sym_jacobi_amp")})
    f32_launches = used["critic_train"]
    generic_launches = used["actor_env_rollout"]
    torch.cuda.synchronize()
    split = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if name != "start":
            split[name] = split.get(name, 0.0) + a.elapsed_time(b) / 3
    rate = a_cnt * t_len * 3 / wall
    rew = torch.stack(rewards)
    print(f"ppo path: N=7 {a_cnt} agents x {t_len} steps, 200/200 iters: "
          f"3 epochs {wall:.4f} s, {rate:.1f} env-steps/s; per epoch (ms, "
          f"CUDA events): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                        split.items())
          + f"; mean pi_iters {pi_iters}; launches over 5 epochs "
          f"{dict(launches)} (the generic rollout kernel "
          f"{generic_launches}); best reward {float(rew.max()):.6f}")
    if launches["sym_jacobi_amp"] <= 0 or \
            launches["critic_train_bf16"] != 5 or \
            launches["actor_env_rollout_reg"] != 5 or f32_launches != 0 or \
            generic_launches != 0:
        raise RuntimeError(f"the PPO path missed a kernel, or did not take "
                           f"the rollout kernel of its width and the bf16 "
                           f"critic kernel once per epoch and those alone: "
                           f"{dict(launches)}, generic rollout kernel "
                           f"{generic_launches}, float32 critic kernel "
                           f"{f32_launches}")
    if not bool(torch.isfinite(rew).all()) or float(rew.min()) < -1e-5 or \
            float(rew.max()) > 1 + 1e-5:
        raise RuntimeError("PPO rewards outside [0, 1]")

    amp_err, amp_ms = _hold_true_fid_kernel(ppo, out)

    # the float32 critic kernel's path: a full-precision regression from
    # the final state on the last epoch's visited controllers and rewards
    obs, rets = out.stores.contiguous(), out.rewards.contiguous()
    loss0 = critic.value_loss(critic.pack_critic(st.params, a_cnt), obs,
                              rets, 100)
    before = build.LAUNCHES.copy()
    params, vf_opt = critic.critic_train(st.params, st.vf_opt, obs, rets,
                                         iters=200, lr=1e-3, fast_dot=False)
    torch.cuda.synchronize()
    used = build.LAUNCHES - before
    launches["critic_train"] = used["critic_train"]
    theta = critic.pack_critic(params, a_cnt)
    after = critic.value_loss(theta, obs, rets, 100)
    print(f"float32 critic path: critic_train(fast_dot=False) on the final "
          f"state, {a_cnt} agents x {t_len} rows, 200 iterations: launches "
          f"{launches['critic_train']} (bf16 kernel "
          f"{used['critic_train_bf16']}), value loss {loss0:.6f} -> "
          f"{after:.6f}")
    if launches["critic_train"] != 1 or used["critic_train_bf16"] or \
            not torch.equal(vf_opt.count, st.vf_opt.count + 200) or \
            not bool(torch.isfinite(theta).all()) or not after < loss0:
        raise RuntimeError("the float32 critic path failed")
    return launches, rate, amp_err, amp_ms


def _hold_true_fid_kernel(ppo, out):
    """The one-thread amplitude kernel at the shape and on the inputs its
    path gives it: the last epoch's 512,000 visited controllers, whose true
    fidelities the epoch took in one launch (n = 7, 4 sweeps).  The
    matrices are assembled anew as the epoch assembles them; the kernel
    must agree with the plain version on them (amplitude <= 3e-5) and
    reproduce the epoch's own fidelities; then kernel, plain version and
    torch.linalg.eigh are timed on them.  Returns the max abs error and
    (ms, plain_ms, library_ms, (bound_ms, bound_by))."""
    from code_robchar_tpu_torch.ops import cuda_jacobi, realform, rollout

    n, sweeps = 7, ppo.rollout_sweeps
    stores = out.stores.transpose(0, 1).reshape(-1, n + 1)
    a = rollout.hamiltonian_lanes(ppo.env.sys.to(torch.float32),
                                  stores[:, :n].T).contiguous()
    t = stores[:, n].contiguous()
    b = t.shape[0]

    def kernel():
        return cuda_jacobi.transfer_amp_sym_kernel("sym_jacobi_amp", a, t, 0,
                                                   6, sweeps)

    def plain():
        return realform.transfer_amp_sym_lanes(a, t, 0, 6, sweeps)

    (phr, phi), (pr, pi) = kernel(), plain()
    e_amp = max(float((phr - pr).abs().max()), float((phi - pi).abs().max()))
    e_path = float((phr * phr + phi * phi
                    - out.true_fids.T.reshape(-1)).abs().max())
    routed = cuda_jacobi.amp_route(n, b)
    k_ms = min(_time_ms(kernel, 100, behind_spin=True),
               _time_ms(kernel, 100, behind_spin=True))
    p_ms = min(_time_ms(plain, 3), _time_ms(plain, 3))
    lib_ms, backend = _eigh_ms(a.permute(2, 0, 1).contiguous())
    bound = _bound(b * _amp_flops(n, sweeps), 4 * b * (n * n + 1 + 2))
    ok = e_amp <= TOL_KERNEL and e_path <= TOL_KERNEL and \
        routed == "sym_jacobi_amp" and bool(torch.isfinite(phr).all()
                                            & torch.isfinite(phi).all())
    print(f"zoo kernel sym_jacobi_amp on the PPO epoch's true-fidelity batch "
          f"n={n} B={b} sweeps={sweeps} (route at this shape: {routed}): "
          f"amp-plain {e_amp:.3e}, fidelity against the epoch's own "
          f"{e_path:.3e} {'ok' if ok else 'FAIL'}; card-paced {k_ms:.5f} ms, "
          f"plain {p_ms:.3f} ms, torch.linalg.eigh ({backend}, "
          f"eigendecomposition only) {lib_ms:.4f} ms, bound {bound[0]:.5f} "
          f"ms ({bound[1]})")
    if not ok:
        raise RuntimeError("sym_jacobi_amp disagrees with its plain version "
                           "or with the epoch on the PPO path's batch")
    return e_amp, (k_ms, p_ms, lib_ms, bound)


def phase_ppo_checks():
    from code_robchar_tpu_torch.models import PPO_en, ppo
    from code_robchar_tpu_torch.ops import prng

    budget = 12800
    p = PPO_en(7, 0, 6, testing=True, fid_threshold=0.0, ham_noisy=True,
               run_until_told_to_stop=True, run_until_completion_its=budget,
               landscape_exploration=True, save_topc=64, num_agents=64,
               rollout_sweeps=4, device="cuda")
    start = time.perf_counter()
    best = p.run(steps_per_epoch=100, train_pi_iters=20, train_v_iters=20)
    rec = p.record
    print(f"ppo budget run: N=7 64 agents, budget {budget}: func_calls "
          f"{rec['func_calls']}, best {best:.6f}, controllers "
          f"{len(rec.get('controllers', []))}, "
          f"{time.perf_counter() - start:.2f} s")
    if not rec.get("controllers") or rec["func_calls"] + 1 < budget:
        raise RuntimeError("the PPO budget-mode run did not finish")

    # one epoch of 256 agents at N=4, T=64, card against CPU from one state
    a_cnt, first = 256, 16
    args = (64, 0.2, 3e-3, 1e-3, 1000, 10, 10, 0.01)
    cpu, card = (PPO_en(4, 0, 2, testing=True, num_agents=a_cnt, seed=3,
                        ham_noisy=True, device=dev) for dev in ("cpu", "cuda"))
    st = cpu._init_agent(prng.split(prng.key(1), a_cnt))
    _, want = cpu._build_epoch(*args)(st)
    _, got = card._build_epoch(*args)(ppo.state_to(st, "cuda"))
    err = (got.rewards.cpu() - want.rewards).abs()
    close = int((err[:, :first].amax(1) <= TOL_PPO).sum())

    # witness: the CPU against itself with the carried actions moved by
    # 4e-6, the kernels' step-by-step difference (phase 7)
    _, moved = cpu._build_epoch(*args)(st._replace(
        env=st.env._replace(action=st.env.action + 4e-6)))
    wit = int(((moved.rewards - want.rewards).abs().amax(1)
               > TOL_PPO).sum())
    apart = int((err.amax(1) > TOL_PPO).sum())
    pct = -(-a_cnt // 100)
    bar = max(wit, pct) + pct
    ok = close >= 0.99 * a_cnt and apart <= bar
    print(f"ppo card vs cpu (N=4, {a_cnt} agents, T=64, f32): the first "
          f"{first} steps' rewards within {TOL_PPO:g} on {close}/{a_cnt} "
          f"agents (at least 99%); over all 64 steps apart on "
          f"{apart}/{a_cnt} (at most {bar}: the witness or 1%, whichever is "
          f"more, plus 1%; max {float(err.max()):.3e}), the witness, the CPU "
          f"against itself with the carried actions 4e-6 up, on "
          f"{wit}/{a_cnt}; pi_iters equal on "
          f"{int((got.pi_iters.cpu() == want.pi_iters).sum())}/{a_cnt} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the PPO epoch on the card disagrees with the CPU")


#: the tanh probe's tanhf against torch.tanh on the card: every step moves
#: a value below 1 by an ulp or two and the chain damps it by 0.999 (the
#: bar of tests/test_torch_probes.py)
def _tanh_tol(k):
    return k * 2.0 ** -24


def phase_probes():
    """The probe path: both probe kernels held against their plain versions
    at every shape of the path, then the path itself
    (code_robchar_tpu_torch/perf/probes.py's sweeps) with the counts set to
    0 just before.  Returns the path's launches and (worst error, (ms,
    plain_ms, bound)) per kernel."""
    from code_robchar_tpu_torch.ops import probes
    from code_robchar_tpu_torch.perf import probes as path

    dev = torch.device("cuda")
    x, xt = path.alu_input(dev), path.tanh_input(dev)
    worst = {"alu_probe": 0.0, "tanh_probe": 0.0}
    for s in probes.ALU_STREAMS:
        for k in path.ALU_KS:
            got, want = probes.alu_probe(x, s, k), \
                probes.alu_probe_plain(x, s, k)
            ok = torch.equal(got, want)
            print(f"alu_probe streams={s} K={k} B={x.shape[1]}: bit-equal to "
                  f"its plain version {ok}")
            if not ok:
                raise RuntimeError("alu_probe differs from its plain version")
    for op in probes.TANH_OPS:
        for k in path.TANH_KS:
            got, want = probes.tanh_probe(xt, op, k), \
                probes.tanh_probe_plain(xt, op, k)
            err = float((got - want).abs().max())
            worst["tanh_probe"] = max(worst["tanh_probe"], err)
            ok = torch.equal(got, want) if op != "tanh" else \
                err <= _tanh_tol(k) and bool(torch.isfinite(got).all())
            print(f"tanh_probe op={op} K={k} {tuple(xt.shape)}: max|kernel - "
                  f"plain| {err:.3e} ("
                  + ("bit-equal" if op != "tanh" else
                     f"tanhf vs torch.tanh, bar {_tanh_tol(k):.2e}")
                  + f") {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"tanh_probe op {op} disagrees with its "
                                   f"plain version")

    before = build.LAUNCHES.copy()
    alu, tanh = path.alu_sweep(x), path.tanh_sweep(xt)
    launches = build.LAUNCHES - before
    for s, res in alu.items():
        print(json.dumps({f"alu_probe_{s}_streams": res}))
    for op, res in tanh.items():
        print(json.dumps({f"tanh_probe_{op}": res}))
    print(f"probe path launches: {dict(launches)}")
    if not launches["alu_probe"] or not launches["tanh_probe"]:
        raise RuntimeError(f"the probe path missed a kernel: {launches}")

    # the kernels line: the largest shape of each sweep (alu: 8 streams,
    # K = 4096; tanh: the rational op, K = 8192), timed in the path's run
    b, k_alu, k_tanh = x.shape[1], path.ALU_KS[-1], path.TANH_KS[-1]
    alu_ms = alu[8]["times_ms_by_K"][str(k_alu)]
    tanh_ms = tanh["rational"]["times_ms_by_K"][str(k_tanh)]
    alu_plain = _time_ms(lambda: probes.alu_probe_plain(x, 8, k_alu), 1)
    tanh_plain = _time_ms(
        lambda: probes.tanh_probe_plain(xt, "rational", k_tanh), 1)
    alu_flops = _bound(probes.alu_ops(b, k_alu), 4 * b * (8 + 3))
    tanh_flops = _bound(probes.tanh_ops(xt.numel(), "rational", k_tanh),
                        2 * 4 * xt.numel())
    # The bound is the issue-slot one: both probes round every multiply and
    # every add on its own, to stay bit-equal to the TPU bodies (no FFMA can
    # fuse a pair and halve the count), so each operation takes one issue
    # slot of an FP32 lane: 132 SMs x 128 lanes x 1.98 GHz.  For the tanh
    # probe it is still a floor: its IEEE division issues more than one
    # instruction.  The 67 TFLOP/s bound (two operations an FFMA) is
    # printed beside it for reference.
    slots = 132 * 128 * 1.98e9
    alu_bound = (probes.alu_ops(b, k_alu) / slots * 1e3, "issue slots")
    tanh_bound = (probes.tanh_ops(xt.numel(), "rational", k_tanh) / slots
                  * 1e3, "issue slots")
    print(f"probe kernels: alu_probe 8 streams K={k_alu} B={b} {alu_ms:.5f} "
          f"ms (plain {alu_plain:.3f} ms; bound {alu_bound[0]:.5f} ms at one "
          f"operation an issue slot, {alu_flops[0]:.5f} ms ({alu_flops[1]}, "
          f"67 TFLOP/s)); tanh_probe rational K={k_tanh} {tuple(xt.shape)} "
          f"{tanh_ms:.5f} ms (plain {tanh_plain:.3f} ms; bound "
          f"{tanh_bound[0]:.5f} ms at one operation an issue slot, "
          f"{tanh_flops[0]:.5f} ms ({tanh_flops[1]}, 67 TFLOP/s))")
    return launches, {
        "alu_probe": (worst["alu_probe"], (alu_ms, alu_plain, alu_bound)),
        "tanh_probe": (worst["tanh_probe"], (tanh_ms, tanh_plain,
                                             tanh_bound))}


#: restarts of the shot-noise phase's zoo pools (the width stays N = 7):
#: a quarter of ZOO_POOL (half of it once phases 17 and 18 were added, all
#: of it before), to keep the whole run near half its limit
NOISY_POOL = ZOO_POOL // 4
#: the shot-noise phase's PPO epochs: 2 until phases 17 and 18 were added
NOISY_PPO_EPOCHS = 1
#: the largest share of binomial draws on the card that may differ from the
#: same call on the CPU
CARD_CPU_SHARE = 1e-3


class _DrawClock:
    """Host seconds spent in the shot-noise draws (ops/noise's two
    protocols), each call bracketed by synchronisations; installed on the
    module, which every caller reads at call time."""

    def __init__(self):
        from code_robchar_tpu_torch.ops import noise

        self.noise, self.seconds, self.calls = noise, 0.0, 0
        self.saved = (noise.shot_noise_fidelity, noise.adaptive_shot_fidelity)

    def _wrap(self, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - start
            self.calls += 1
            return out
        return timed

    def __enter__(self):
        self.noise.shot_noise_fidelity = self._wrap(self.saved[0])
        self.noise.adaptive_shot_fidelity = self._wrap(self.saved[1])
        return self

    def __exit__(self, *exc):
        self.noise.shot_noise_fidelity, self.noise.adaptive_shot_fidelity = \
            self.saved


def _hold_binomial_card_vs_cpu():
    """1M float32 binomials on the card against the same call on the CPU:
    2^19 under one key with a shape and 2^19 under a batch of keys, counts
    10, 100 and 1000 over p in [0, 1], so both samplers run."""
    from code_robchar_tpu_torch.ops import prng

    rng = np.random.default_rng(4)
    size = 1 << 19
    p = torch.as_tensor(rng.uniform(0, 1, size).astype(np.float32))
    count = torch.as_tensor(rng.choice([10, 100, 1000], size)
                            .astype(np.float32))
    inv = float((count * torch.minimum(p, 1 - p) <= 10).double().mean())
    # the first draws on the card load torch's kernels; keep that out of
    # the times below
    prng.binomial(prng.key(0).cuda(), count[:64].cuda(), p[:64].cuda())
    for form, key in (("one key", prng.key(1)),
                      ("a batch of keys", prng.split(prng.key(1), size))):
        start = time.perf_counter()
        got = prng.binomial(key.cuda(), count.cuda(), p.cuda())
        torch.cuda.synchronize()
        card_s = time.perf_counter() - start
        want = prng.binomial(key, count, p)
        share = float((got.cpu() != want).double().mean())
        ok = share <= CARD_CPU_SHARE and bool(torch.isfinite(got).all())
        print(f"binomial card vs cpu, {form}: {size} float32 draws "
              f"({inv:.3f} by inversion, the rest BTRS), {share:.3e} differ "
              f"(at most {CARD_CPU_SHARE:g}); card {card_s:.3f} s "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("binomial on the card differs from the CPU")


def phase_shot_noise():
    """Shot noise (fid_noisy) on the card: the N=7 NM and L-BFGS pools with
    draws 10, the plain and the adaptive protocol (adp_tol 0.05); two PPO
    epochs at N=7, 1024 agents, T=500 on the per-step loop; the amplitude
    kernel's count must rise on every path; 1M binomials card vs CPU."""
    from code_robchar_tpu_torch.models import LBFGS, NMPlus, PPO_en
    from code_robchar_tpu_torch.ops import prng

    rates = {}
    if NOISY_POOL < ZOO_POOL:
        print(f"noisy zoo pools cut to {NOISY_POOL} restarts a run from the "
              f"noiseless phase's {ZOO_POOL}, to fit the phase's time; N = 7 "
              f"kept")
    for cls in (NMPlus, LBFGS):
        for adaptive in (False, True):
            opt = _zoo_optimizer(cls, fid_noisy=True, draws=10,
                                 adaptive=adaptive, adp_tol=0.05)
            x0s = torch.as_tensor(opt.init_points(NOISY_POOL),
                                  dtype=torch.float32, device="cuda")
            keys = prng.split(prng.key(31), NOISY_POOL)
            before = build.LAUNCHES.copy()
            with _DrawClock() as clock:
                start = time.perf_counter()
                res = opt._run_batch(x0s, keys)
                fid = res.fid.cpu().numpy()
                wall = time.perf_counter() - start
            used = sum((build.LAUNCHES - before)[k] for k in AMP_KERNELS)
            rounds = opt.stats.get("trials", opt.stats.get("rounds"))
            name = f"{cls.name}{' adaptive' if adaptive else ''}"
            print(f"noisy zoo {name}: N=7 pool {NOISY_POOL}, draws 10: "
                  f"{wall:.2f} s, {NOISY_POOL / wall:.1f} restarts/s; "
                  f"{opt.stats}; amplitude kernel launches {used}; shot "
                  f"draws {clock.seconds:.3f} s in {clock.calls} calls, "
                  f"{clock.seconds / rounds * 1e3:.3f} ms a "
                  f"{'trial' if cls is LBFGS else 'round'}; mean nfev "
                  f"{float(res.nfev.double().mean()):.1f}; best fid "
                  f"{fid.max():.4f}")
            if used <= 0 or not np.isfinite(fid).all() or fid.min() < 0 or \
                    fid.max() > 1 or (not adaptive and not np.allclose(
                        fid * 10, np.round(fid * 10), atol=1e-5)):
                raise RuntimeError(f"noisy {name}: no amplitude launch or "
                                   f"fidelities that are not shot counts")
            rates[name] = NOISY_POOL / wall

    ppo = PPO_en(7, 0, 6, testing=True, fid_threshold=0.0, ham_noisy=True,
                 fid_noisy=True, draws=10, num_agents=PPO_AGENTS,
                 rollout_sweeps=4, device="cuda", dtype=torch.float32)
    if not ppo.fused_rollout_fallback_reasons():
        raise RuntimeError("the fused rollout is not gated off under shot "
                           "noise")
    epoch_fn = ppo._build_epoch(PPO_STEPS, 0.2, 3e-3, 1e-3, 1000, 200, 200,
                                0.01)
    st = ppo._init_agent(prng.split(prng.key(0), PPO_AGENTS))
    before = build.LAUNCHES.copy()
    walls = []
    with _DrawClock() as clock:
        for _ in range(NOISY_PPO_EPOCHS):
            start = time.perf_counter()
            st, out = epoch_fn(st)
            rew = out.rewards.cpu().numpy()
            walls.append(time.perf_counter() - start)
    used = sum((build.LAUNCHES - before)[k] for k in AMP_KERNELS)
    rate = PPO_AGENTS * PPO_STEPS / statistics.mean(walls)
    print(f"noisy ppo: N=7 {PPO_AGENTS} agents x {PPO_STEPS} steps, draws "
          f"10, per-step loop, {NOISY_PPO_EPOCHS} epoch(s) (cut from 2 to "
          f"fit the run's time): epochs {walls} s, {rate:.1f} env-steps/s; "
          f"amplitude kernel launches {used}; shot draws "
          f"{clock.seconds / NOISY_PPO_EPOCHS * 1e3:.1f} ms an epoch in "
          f"{clock.calls // NOISY_PPO_EPOCHS} calls; best reward "
          f"{rew.max():.1f}")
    if used < NOISY_PPO_EPOCHS * PPO_STEPS or not np.isfinite(rew).all() or \
            not np.allclose(rew * 10, np.round(rew * 10), atol=1e-5):
        raise RuntimeError("the noisy PPO epoch missed the amplitude kernel "
                           "or its rewards are not shot counts")
    rates["ppo"] = rate
    _hold_binomial_card_vs_cpu()
    return rates


#: Adam's streams (its default batch) and the segments of its noiseless
#: run: five of 1000 steps, the fifth ending on the 5000-update restart
#: boundary
ADAM_STREAMS = 64
ADAM_SEGMENTS = 5
#: SNOB.run()'s budget: three batches of its default 128 restarts
SNOB_RUN_BUDGET = 128 * 300 * 3


def _expect_counts(label, used, want):
    """Fail unless the four zoo kernels' counts in ``used`` (launches by C
    entry) are those of ``want``, a list of (kernel, launches) (the
    kernels not named there: 0)."""
    used = {k: used[k] for k in ZOO_KERNELS}
    full = dict.fromkeys(ZOO_KERNELS, 0)
    for k, n_launch in want:
        full[k] += n_launch
    print(f"{label}: zoo kernel launches {used} (expected {full})")
    if used != full:
        raise RuntimeError(f"{label} did not launch the kernels its shapes "
                           f"are routed to: {used}, expected {full}")


def _adam_run(label, segments, **kw):
    """Adam.run() at N=7 on the card with its 64 streams on a budget of
    ``segments`` segments; returns the optimizer, the steps a stream took,
    the wall seconds and the counts of its launches."""
    from code_robchar_tpu_torch.models import Adam

    opt = _zoo_optimizer(Adam, **kw)
    budget = ADAM_STREAMS * segments * opt.segment_its
    opt.run_until_completion_its = budget
    opt.fid_threshold = 0.0
    before = build.LAUNCHES.copy()
    start = time.perf_counter()
    opt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    used = build.LAUNCHES - before
    rec = opt.record
    steps = segments * opt.segment_its
    probes = rec["func_calls"] - ADAM_STREAMS * steps
    fid = rec["best_fid"]
    print(f"adam path {label}: N=7, {ADAM_STREAMS} streams, segments of "
          f"{opt.segment_its} steps, budget {budget}: {wall:.2f} s, "
          f"{segments / wall:.3f} segments/s, {steps / wall:.1f} steps/s; "
          f"func_calls {rec['func_calls']}, iterations {rec['iterations']}, "
          f"probes {probes} ({probes / ADAM_STREAMS:.2f} a stream, "
          f"{opt.stats['probe_rounds']} probe rounds in the last segment); "
          f"best_fid {fid!r}, top-c store {len(rec.get('controllers', []))}")
    if rec["func_calls"] + 1 < budget or not rec.get("controllers") or \
            fid is None or not 0.0 <= fid <= 1.0 + 1e-5:
        raise RuntimeError(f"adam {label}: the run did not finish its budget "
                           f"or recorded no finite fidelity")
    return opt, steps, wall, used


def _adam_restart_segment(opt, x, keys):
    """A plain segment, then the streams' step counts set one segment
    short of the restart cadence, then the restart segment."""
    from code_robchar_tpu_torch.models import adam

    opt._run_batch(x, keys)
    w, m, v, it, ptr = opt._stream
    opt._stream = (w, m, v, torch.full_like(
        it, adam._RESTART_EVERY - opt.segment_its), ptr)
    return opt._run_batch(x, keys)


def _adam_snob_card_vs_cpu():
    """256 Adam streams over a 50-step segment and a 50-step restart
    segment, and 256 SNOB restarts, at N=4, float32, through the kernels
    on the card and the plain versions on the CPU; gated on the
    fidelities' two-sample KS, the restarts ending apart printed beside
    the CPU against itself with the starts moved one ulp.  Adam's restart
    probes Sobol candidates that are the same numbers on both devices, so
    its probes a stream and its table pointers must agree exactly."""
    import scipy.stats

    from code_robchar_tpu_torch.models import SNOB, Adam
    from code_robchar_tpu_torch.ops import prng

    kw = dict(testing=True, seed=2, fid_threshold=0.0,
              run_until_told_to_stop=True, run_until_completion_its=10**9,
              landscape_exploration=True, dtype=torch.float32)
    ks_all = {}
    for cls, extra, drive in ((Adam, dict(segment_its=50),
                               _adam_restart_segment), (SNOB, {}, None)):
        x0 = cls(4, 0, 2, device="cpu", **kw, **extra).init_points(256)
        run, last = _starts_runs(x0, prng.split(prng.key(0), 256),
                                 lambda device: cls(4, 0, 2, device=device,
                                                    **kw, **extra), drive)
        card, cpu = run("cuda"), run("cpu")
        ok = True
        if cls is Adam:
            ptrs = [last[dev]._stream[4].cpu() for dev in ("cuda", "cpu")]
            probes = card.nfev.cpu() - 50
            ok = bool((card.nfev.cpu() == cpu.nfev).all()) and \
                bool((ptrs[0] == ptrs[1]).all()) and \
                bool((ptrs[0] == probes).all()) and int(probes.min()) >= 1
            print(f"adam restart segment card vs cpu: probes a stream "
                  f"{int(probes.min())}..{int(probes.max())}, total "
                  f"{int(probes.sum())}; probes and table pointers equal "
                  f"on all 256 streams: {'ok' if ok else 'FAIL'}")
        ks = float(scipy.stats.ks_2samp(card.fid.cpu().numpy(),
                                        cpu.fid.numpy())[0])
        witness = _parted(cpu, run("cpu", nudge=True))
        ok = ok and ks < KS_GATE and bool(torch.isfinite(card.fid).all())
        print(f"{cls.name} card vs cpu (N=4, 256 restarts, f32): "
              f"{_parted(card, cpu)}/256 ending > 1e-3 apart (the CPU vs "
              f"itself, starts moved one ulp: {witness}/256); max |dfid| "
              f"{float((card.fid.cpu() - cpu.fid).abs().max()):.3e}; KS "
              f"{ks:.4f} (gate {KS_GATE}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{cls.name}: card and CPU outcomes differ")
        ks_all[cls.name] = ks
    return ks_all


def phase_adam_snob(worst):
    from code_robchar_tpu_torch.models import SNOB, Adam
    from code_robchar_tpu_torch.ops import cuda_jacobi, prng

    dev = torch.device("cuda")
    launches = Counter()

    # the kernels at this path's shapes, before the counted runs
    adam = _zoo_optimizer(Adam)
    xs = torch.as_tensor(adam.init_points(ADAM_STREAMS), dtype=torch.float32,
                         device=dev)
    _hold_zoo_kernels("adam streams", *_lanes_of(adam, xs), adam.HH, xs, 0,
                      6, worst)
    snob = _zoo_optimizer(SNOB)
    for label, b in (("snob pool round", ZOO_POOL * 10),
                     ("snob run() round", 128 * 10)):
        xs = torch.as_tensor(snob.init_points(b), dtype=torch.float32,
                             device=dev)
        _hold_zoo_kernels(label, *_lanes_of(snob, xs), snob.HH, xs[:1024],
                          0, 6, worst)

    grad_at = cuda_jacobi.grad_route(7, ADAM_STREAMS)
    amp_at = cuda_jacobi.amp_route(7, ADAM_STREAMS)
    opt, steps, wall, used = _adam_run("noiseless", ADAM_SEGMENTS)
    _expect_counts("adam path noiseless", used, [
        (grad_at, steps + opt.stats["probe_rounds"]),
        (amp_at, steps + ADAM_SEGMENTS)])
    launches += used
    if opt.stats["probe_rounds"] < 1:
        raise RuntimeError("adam: the fifth segment did not restart")
    out = {"adam_steps_s": steps / wall}
    opt, steps, wall, used = _adam_run("ham_noisy sigma 0.05", 1,
                                       ham_noisy=True, noise=0.05)
    _expect_counts("adam path ham_noisy", used, [(grad_at, steps),
                                                 (amp_at, steps + 1)])
    launches += used
    out["adam_noisy_steps_s"] = steps / wall

    rounds = snob.budget // 10

    def run(seed):
        x0s = torch.as_tensor(snob.init_points(ZOO_POOL), dtype=torch.float32,
                              device=dev)
        res = snob._run_batch(x0s, prng.split(prng.key(seed), ZOO_POOL))
        fid = res.fid.cpu().numpy()
        if fid.shape != (ZOO_POOL,) or not np.isfinite(fid).all() or \
                fid.min() < -1e-5 or fid.max() > 1 + 1e-5 or \
                not bool((res.nfev == snob.budget).all()):
            raise RuntimeError("snob: bad batch result")
        return fid

    before = build.LAUNCHES.copy()
    run(25)
    times = []
    for seed in (26, 27, 28):
        start = time.perf_counter()
        fid = run(seed)
        times.append(time.perf_counter() - start)
    used = build.LAUNCHES - before
    wall = statistics.median(times)
    print(f"snob path: N=7 pool {ZOO_POOL}, {rounds} rounds of "
          f"{ZOO_POOL * 10} lanes: wall {times} s, median {wall:.4f} s, "
          f"{ZOO_POOL / wall:.1f} restarts/s; best fid {fid.max():.6f}")
    # the rounds' lanes (the one-thread kernel at ZOO_POOL = 8192) and the
    # starts' first evaluation and the true fidelities (the lane-group one)
    _expect_counts("snob path, 4 runs", used, [
        (cuda_jacobi.amp_route(7, ZOO_POOL * 10), 4 * rounds),
        (cuda_jacobi.amp_route(7, ZOO_POOL), 4 * 2)])
    launches += used
    out["snob_restarts_s"] = ZOO_POOL / wall

    ropt = _zoo_optimizer(SNOB)
    ropt.run_until_completion_its = SNOB_RUN_BUDGET
    ropt.fid_threshold = 0.0
    before = build.LAUNCHES.copy()
    start = time.perf_counter()
    ropt.run()
    torch.cuda.synchronize()
    rec = ropt.record
    print(f"snob budget run: N=7, batch {ropt._batch_size()}, budget "
          f"{SNOB_RUN_BUDGET}: {time.perf_counter() - start:.2f} s, "
          f"func_calls {rec['func_calls']}, repeats {rec['repeats']}, "
          f"best_fid {rec['best_fid']!r}, top-c store "
          f"{len(rec.get('controllers', []))}")
    if not rec.get("controllers") or rec["func_calls"] + 1 < SNOB_RUN_BUDGET:
        raise RuntimeError("the SNOB budget run did not finish its budget")
    used = build.LAUNCHES - before
    batches = rec["repeats"] // 128
    _expect_counts("snob budget run", used, [
        (cuda_jacobi.amp_route(7, 128 * 10), batches * rounds),
        (cuda_jacobi.amp_route(7, 128), batches * 2)])
    launches += used

    out["ks"] = _adam_snob_card_vs_cpu()
    return launches, out


#: the single-point phase: points a builder is held on, objective calls of
#: the accelerated NM's rate runs, the PPO epoch's bootstrap reps and the
#: targets held against the CPU, ngd's steps
SP_POINTS = 64
SP_NM_CALLS = 600
#: objective calls of the whole runs of the N=4 card-vs-CPU reading (~37
#: iterations; its CPU runs lead the phase's time): 300 until phases 17
#: and 18 were added
SP_WHOLE_CALLS = 150
SP_WASS_REPS = 30
SP_WASS_HELD = 4096
SP_NGD_STEPS = 200
#: the box of run_accelerated's rate runs at N=7 (the constructor's bmin =
#: -SP_NM_BOX, bmax and max_time): a uniform point there has a transfer
#: fidelity of ~0.07 (median), which float32 resolves; in the default box
#: (-10, 10) x (0, 30) it has ~2e-7 and the landscape is flat in float32
SP_NM_BOX, SP_NM_TIME = 1.0, 8.0
#: objective calls of the warm-start run in the default box: its first
#: simplex takes 8, so at most 28 iterations follow, fewer than the 30
#: stagnant ones a restart needs
SP_WARM_CALLS = 36


def _sp_points(k):
    """k controllers at N=7 with a transfer fidelity float32 resolves:
    biases in (-0.5, 0.5), times in (3, 7) (fidelity ~0.28 median, ~2e-3
    least, noiseless), float32 on the CPU."""
    rng = np.random.default_rng(40)
    xs = np.column_stack([rng.uniform(-0.5, 0.5, (k, 7)),
                          rng.uniform(3, 7, k)])
    return torch.as_tensor(xs, dtype=torch.float32)


def _resolved(label, values, bar):
    """The median of |values|, which must be at least 100 times the bar
    they are held at: a hold of values near 0 (or of 1 - values near 1 in
    float32) cannot tell a wrong kernel from a right one."""
    med = float(values.abs().median())
    if not med >= 100 * bar:
        raise RuntimeError(f"{label}: held values of median {med:.3e}, "
                           f"less than 100 x the bar {bar:g}")
    return med


def _sp_specs(device):
    """The single-point objective specs of every regime at N=7, 0 -> 6
    (noise 0.05, draws 10, adp_tol 0.05; the fixed ensemble of 100 members
    under key(4)), on ``device``, float32."""
    from code_robchar_tpu_torch.models import objectives
    from code_robchar_tpu_torch.ops import chain, noise, prng

    h0 = chain.xx_hamiltonian_real(7, device=device)
    fixed, _ = noise.fixed_hamiltonian_ensemble(prng.key(4), h0, 0.05,
                                                train_size=100, test_size=1)
    base = dict(h0=h0, in_spin=0, out_spin=6, noise=0.05,
                fid_noisy=False, ham_noisy=False, draws=10, adaptive=False,
                adp_tol=0.05, fixed_hams=None, mul_fac=1)
    regimes = {"noiseless": {}, "ham_noisy": dict(ham_noisy=True),
               "fid_noisy": dict(fid_noisy=True),
               "adaptive": dict(fid_noisy=True, adaptive=True),
               "fixed": dict(fixed_hams=fixed),
               "fixed_fid_noisy": dict(fixed_hams=fixed, fid_noisy=True)}
    return {k: objectives.ObjectiveSpec(**dict(base, **v))
            for k, v in regimes.items()}


def _wass_chunks(k, reps):
    """(launches, Hamiltonians of the largest) of make_wass_cost on k
    controllers: chunks of WASS_LANES // reps controllers."""
    from code_robchar_tpu_torch.models import objectives

    per = max(1, objectives.WASS_LANES // reps)
    return -(-k // per), min(k, per) * reps


def _hold_single_point_builders():
    """(a) every single-point builder at N=7 on SP_POINTS points of real
    fidelity (_sp_points) with fixed keys, the card's kernels against the
    CPU plain versions on the same keys; each call's launches against the
    routed kernel; then one ngd step (the gradient kernel at B=1)."""
    from code_robchar_tpu_torch.models import NMPlus, objectives
    from code_robchar_tpu_torch.ops import cuda_jacobi, noise, prng

    n, k = 7, SP_POINTS
    x_cpu = _sp_points(k)
    x_card = x_cpu.cuda()
    keys = prng.split(prng.key(41), k)
    card, cpu = _sp_specs("cuda"), _sp_specs("cpu")

    def counted(label, fn, want):
        before = build.LAUNCHES.copy()
        out = fn()
        torch.cuda.synchronize()
        _expect_counts(f"single-point {label}", build.LAUNCHES - before,
                       want)
        return out

    for name in card:
        r = 100 if name.startswith("fixed") else 1
        (f_card, c_card) = counted(
            f"make_infidelity {name}",
            lambda: objectives.make_infidelity(card[name])(x_card, keys),
            [(cuda_jacobi.amp_route(n, k * r), 1)])
        f_cpu, c_cpu = objectives.make_infidelity(cpu[name])(x_cpu, keys)
        fid_card, fid_cpu = 1 - f_card.cpu(), 1 - f_cpu
        med = _resolved(f"make_infidelity {name}", fid_cpu, TOL_KERNEL)
        err = float((fid_card - fid_cpu).abs().max())
        # under shot noise the counts, and so the values, must be equal
        shot = cpu[name].fid_noisy
        ok = err <= TOL_KERNEL and (err == 0.0 or not shot) and \
            bool(torch.equal(c_card.cpu(), c_cpu)) and \
            bool(torch.isfinite(f_card).all())
        print(f"single-point make_infidelity {name}: N=7, {k} points"
              f"{f' x {r} members' if r > 1 else ''} (fidelity median "
              f"{med:.4f}), card vs cpu max |dfid| {err:.3e}"
              f"{' (shot noise: must be 0)' if shot else ''}, calls equal "
              f"{bool(torch.equal(c_card.cpu(), c_cpu))} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"make_infidelity {name}: card and CPU "
                               f"disagree")

    e_card, g_card = counted(
        "make_exact_gradient",
        lambda: objectives.make_exact_gradient(card["noiseless"])(x_card),
        [(cuda_jacobi.grad_route(n, k), 1)])
    e_cpu, g_cpu = objectives.make_exact_gradient(cpu["noiseless"])(x_cpu)
    g_med = _resolved("make_exact_gradient", g_cpu.abs().amax(1),
                      TOL_GRAD_ORACLE)
    e_err = float(((1 - e_card.cpu()) - (1 - e_cpu)).abs().max())
    g_err = float((g_card.cpu() - g_cpu).abs().max())
    # float32 probes need a float32-sized step: eps = 1e-3
    eps = 1e-3
    f0_card, gfd_card, cfd_card = counted(
        "make_fd_gradient ham_noisy",
        lambda: objectives.make_fd_gradient(objectives.make_infidelity(
            card["ham_noisy"]), n + 1, eps)(x_card, keys),
        [(cuda_jacobi.amp_route(n, k * (n + 2)), 1)])
    f0_cpu, gfd_cpu, cfd_cpu = objectives.make_fd_gradient(
        objectives.make_infidelity(cpu["ham_noisy"]), n + 1, eps)(x_cpu, keys)
    fd_err = max(float((f0_card.cpu() - f0_cpu).abs().max()),
                 float((gfd_card.cpu() - gfd_cpu).abs().max()) * eps / 2)
    w_card = counted(
        "make_wass_cost",
        lambda: objectives.make_wass_cost(card["ham_noisy"], SP_WASS_REPS)(
            x_card, keys),
        [(cuda_jacobi.amp_route(n, k * SP_WASS_REPS),
          _wass_chunks(k, SP_WASS_REPS)[0])])
    w_cpu = objectives.make_wass_cost(cpu["ham_noisy"], SP_WASS_REPS)(
        x_cpu, keys)
    w_med = _resolved("make_wass_cost", 1 - w_cpu, TOL_KERNEL)
    w_err = float((w_card.cpu() - w_cpu).abs().max())
    ok = e_err <= TOL_KERNEL and g_err <= TOL_GRAD_ORACLE and \
        fd_err <= TOL_KERNEL and w_err <= TOL_KERNEL and \
        bool(torch.equal(cfd_card.cpu(), cfd_cpu)) and \
        bool(torch.isfinite(g_card).all() & torch.isfinite(w_card).all())
    print(f"single-point make_exact_gradient: |dfid| {e_err:.3e}, |dgrad| "
          f"{g_err:.3e} (bar {TOL_GRAD_ORACLE:g}; median of the largest "
          f"|grad| {g_med:.4f}); make_fd_gradient ham_noisy (eps {eps:g}): "
          f"f0 and the probes' values within {fd_err:.3e}, calls equal; "
          f"make_wass_cost ({SP_WASS_REPS} reps): |dcost| {w_err:.3e} "
          f"(median 1 - cost {w_med:.4f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("a single-point builder disagrees card vs CPU")

    # ngd's step: the gradient kernel at B=1 on one ham-noisy draw, then
    # one step of ngd from a point of real fidelity, card against CPU
    h0 = card["noiseless"].h0
    zr, _ = noise.structured_perturbation_parts(prng.key(42), n, 0.05,
                                                complex_offdiag=False)
    err1_card, g1_card = counted(
        "gradient kernel at B=1",
        lambda: cuda_jacobi.infidelity_and_gradient_sym(
            h0 + zr.cuda(), x_card[:1], 0, 6),
        [(cuda_jacobi.grad_route(n, 1), 1)])
    err1_cpu, g1_cpu = cuda_jacobi.infidelity_and_gradient_sym(
        h0.cpu() + zr, x_cpu[:1], 0, 6)
    _resolved("gradient kernel at B=1", g1_cpu.abs().amax(1),
              TOL_GRAD_ORACLE)
    d_err1 = float((err1_card.cpu() - err1_cpu).abs().max())
    d_g1 = float((g1_card.cpu() - g1_cpu).abs().max())
    walk = {}
    for dev in ("cuda", "cpu"):
        opt = NMPlus(7, 0, 6, testing=True, seed=5, noise=0.05, device=dev,
                     dtype=torch.float32)
        opt.init_points = lambda kk: x_cpu[:kk].numpy()
        walk[dev] = opt.ngd(1)
    d_fid = abs(walk["cuda"][1] - walk["cpu"][1])
    d_w = float(np.abs(walk["cuda"][0] - walk["cpu"][0]).max())
    moved = float(np.median(np.abs(walk["cpu"][0] - x_cpu[0].numpy())))
    ok = d_err1 <= TOL_KERNEL and d_g1 <= TOL_GRAD_ORACLE and \
        d_fid <= TOL_KERNEL and d_w <= TOL_GRAD_ORACLE and \
        walk["cpu"][1] >= 100 * TOL_KERNEL and moved >= 100 * TOL_GRAD_ORACLE
    print(f"single-point gradient kernel at B=1 (ngd's launch): |derr| "
          f"{d_err1:.3e}, |dgrad| {d_g1:.3e}; ngd one step from a point "
          f"of fidelity {walk['cpu'][1]:.4f}: |dfid| {d_fid:.3e}, |dw| "
          f"{d_w:.3e} (bar {TOL_GRAD_ORACLE:g}; a coordinate moved "
          f"{moved:.4f} (median)) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("ngd's step disagrees card vs CPU")


def _sp_nm_card_vs_cpu():
    """run_accelerated at N=4, float32, card against CPU on 8 streams (seeds
    0..7, the same regular simplex on both): over the first iterations
    (40 objective calls) 7 of 8 must end within 1e-3; over whole runs
    (SP_WHOLE_CALLS calls) the streams ending apart are printed beside the
    witness, the CPU against itself with the simplex moved one ulp."""
    from code_robchar_tpu_torch.models import NMPlus, nmplus

    def run(device, seed, calls, nudge=False):
        ref = NMPlus(4, 0, 2, testing=True, seed=seed, device="cpu")
        key = ref.next_key()
        x0 = torch.as_tensor(ref.init_points(1)[0])
        simplex = nmplus.regular_simplex(x0, ref._lower, ref._upper, key)
        if nudge:
            simplex = torch.nextafter(simplex,
                                      torch.full_like(simplex, math.inf))
        opt = NMPlus(4, 0, 2, testing=True, seed=seed, device=device)
        f, x = opt.run_accelerated(calls, simplex=simplex.to(device))
        return f, x

    def apart(a, b):
        return sum(int(np.abs(x - y).max() > 1e-3) for (_, x), (_, y)
                   in zip(a, b))

    seeds = range(8)
    first = [[run(dev, s, 40) for s in seeds] for dev in ("cuda", "cpu")]
    close = 8 - apart(*first)
    whole = [[run(dev, s, SP_WHOLE_CALLS) for s in seeds]
             for dev in ("cuda", "cpu")]
    witness = apart(whole[1], [run("cpu", s, SP_WHOLE_CALLS, nudge=True)
                               for s in seeds])
    dfid = max(abs(a[0] - b[0]) for a, b in zip(*whole))
    print(f"run_accelerated card vs cpu (N=4, 8 streams, f32): first 40 "
          f"calls {close}/8 within 1e-3 (at least 7); whole runs of "
          f"{SP_WHOLE_CALLS} calls apart {apart(*whole)}/8, the CPU vs itself "
          f"with the simplex one ulp up {witness}/8; max |dinfid| "
          f"{dfid:.3e}")
    if close < 7:
        raise RuntimeError("run_accelerated: card and CPU disagree")


def phase_single_point():
    """(a) the single-point builders card vs CPU; (b) run_accelerated at
    N=7; (c) the PPO epoch with the Wasserstein value targets at bench.py's
    configuration; (d) ngd and wass_cost.  Returns the launches of the
    paths (b)-(d) by kernel and the readings."""
    from code_robchar_tpu_torch.models import NMPlus, PPO_en, nmplus
    from code_robchar_tpu_torch.models import objectives
    from code_robchar_tpu_torch.ops import cuda_jacobi, prng

    clock = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        print(f"phase_single_point {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    _hold_single_point_builders()
    part("(a) builders card vs cpu")
    launches = Counter()
    out = {}

    # (b) the accelerated single-stream NM.  The rate runs take the
    # reference's start (a regular simplex around a uniform point) in the
    # box SP_NM_BOX x SP_NM_TIME, where float32 resolves the landscape
    # everywhere.  The stagnation restarts (every ~30 stagnant iterations,
    # the reference's counter) may leave the last simplex anywhere, even at
    # t ~ 0, so a recorder keeps the least objective value on the card (no
    # sync): the first simplex's and the run's
    make = objectives.make_infidelity
    seen = {}

    def recording(spec):
        infid = make(spec)

        def record(xs, keys):
            f, calls = infid(xs, keys)
            low = f.min()
            seen.setdefault("first", low)
            seen["least"] = torch.minimum(seen.get("least", low), low)
            return f, calls
        return record

    for label, kw in (("noiseless", {}), ("ham_noisy", dict(ham_noisy=True,
                                                            noise=0.05))):
        opt = NMPlus(7, 0, 6, testing=True, seed=3, bmin=-SP_NM_BOX,
                     bmax=SP_NM_BOX, max_time=SP_NM_TIME, device="cuda",
                     dtype=torch.float32, **kw)
        opt.run_accelerated(60)          # warm-up
        seen.clear()
        objectives.make_infidelity = recording
        before = build.LAUNCHES.copy()
        try:
            t0 = time.perf_counter()
            f, x = opt.run_accelerated(SP_NM_CALLS)
            wall = time.perf_counter() - t0
        finally:
            objectives.make_infidelity = make
        used = build.LAUNCHES - before
        st = opt.stats
        it = st["iterations"]
        first, best = (1 - float(seen[k]) for k in ("first", "least"))
        print(f"run_accelerated {label}: N=7, box +-{SP_NM_BOX:g} x "
              f"(0, {SP_NM_TIME:g}), {SP_NM_CALLS} objective calls: "
              f"{wall:.3f} s, {it} iterations, {it / wall:.1f} "
              f"iterations/s, {st['restarts']} restarts, launches "
              f"{st['launches'] / it:.3f} and host syncs "
              f"{st['syncs'] / it:.3f} an iteration; best fidelity: first "
              f"simplex {first:.4g}, the run {best:.4g}, the last simplex "
              f"{1 - f:.4g}")
        _expect_counts(f"run_accelerated {label}", used, [
            (cuda_jacobi.amp_route(7, 13), st["launches"])])
        progress = best > first or label != "noiseless"
        if not (np.isfinite(x).all() and 0.0 <= 1 - f <= 1 + 1e-5 and
                best >= 100 * TOL_KERNEL and progress):
            raise RuntimeError("run_accelerated: the search made no "
                               "progress that float32 resolves")
        launches += used
        out[f"nm_{label}_it_s"] = it / wall
    # the default box (-10, 10) x (0, 30), flat in float32 around a uniform
    # point: from a warm start (a regular simplex around the best of 1024
    # uniform points) the noiseless search must improve on its start
    # before any restart can throw the start away
    opt = NMPlus(7, 0, 6, testing=True, seed=3, device="cuda",
                 dtype=torch.float32)
    xs = torch.as_tensor(opt.init_points(1024), dtype=torch.float32,
                         device="cuda")
    fids = objectives.fidelity_batch(opt.HH, xs, 0, 6)
    warm = nmplus.regular_simplex(xs[int(torch.argmax(fids))], opt._lower,
                                  opt._upper, prng.key(44))
    start_fid = float(objectives.fidelity_batch(opt.HH, warm, 0, 6).max())
    before = build.LAUNCHES.copy()
    f, x = opt.run_accelerated(SP_WARM_CALLS, simplex=warm)
    used = build.LAUNCHES - before
    st = opt.stats
    print(f"run_accelerated noiseless, default box, warm start: "
          f"{SP_WARM_CALLS} objective calls, {st['iterations']} iterations, "
          f"{st['restarts']} restarts; best fidelity {start_fid:.4f} -> "
          f"{1 - f:.4g}")
    _expect_counts("run_accelerated warm start", used, [
        (cuda_jacobi.amp_route(7, 13), st["launches"])])
    if st["restarts"] or not 1 - f > start_fid:
        raise RuntimeError("run_accelerated made no progress from its "
                           "warm start")
    launches += used
    part("(b) run_accelerated")
    _sp_nm_card_vs_cpu()
    part("(b) run_accelerated card vs cpu")

    # (c) PPO with the Wasserstein value targets, bench.py's configuration
    a_cnt, t_len = PPO_AGENTS, PPO_STEPS
    ppo = PPO_en(7, 0, 6, testing=True, fid_threshold=0.0, ham_noisy=True,
                 num_agents=a_cnt, rollout_sweeps=4,
                 use_wass_value_targets=True,
                 wass_bootstrap_reps=SP_WASS_REPS, device="cuda",
                 dtype=torch.float32)
    epoch_fn = ppo._build_epoch(t_len, 0.2, 3e-3, 1e-3, 1000, 200, 200, 0.01)
    st = ppo._init_agent(prng.split(prng.key(0), a_cnt))
    st, _ = epoch_fn(st)                 # warm-up
    marks, held = [], {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    make = objectives.make_wass_cost

    def recording(spec, reps):
        cost = make(spec, reps)

        def record(xs, keys):
            c = cost(xs, keys)
            held.update(xs=xs[:SP_WASS_HELD].clone(),
                        keys=keys[:SP_WASS_HELD].clone(),
                        cost=c[:SP_WASS_HELD].clone(), spec=spec)
            return c
        return record

    ppo.stage_hook = mark
    objectives.make_wass_cost = recording
    before = build.LAUNCHES.copy()
    torch.cuda.reset_peak_memory_stats()
    try:
        start = time.perf_counter()
        for _ in range(2):
            st, res = epoch_fn(st)
            float(res.rewards.sum())
        wall = time.perf_counter() - start
    finally:
        objectives.make_wass_cost = make
    used = build.LAUNCHES - before
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.synchronize()
    split = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if name != "start":
            split[name] = split.get(name, 0.0) + a.elapsed_time(b) / 2
    rate = a_cnt * t_len * 2 / wall
    hams = a_cnt * t_len * SP_WASS_REPS
    chunks, chunk = _wass_chunks(a_cnt * t_len, SP_WASS_REPS)
    print(f"ppo wass path: N=7 {a_cnt} agents x {t_len} steps, "
          f"{SP_WASS_REPS} bootstrap reps ({hams} Hamiltonians an epoch in "
          f"{chunks} launches of at most {chunk}): 2 epochs {wall:.4f} s, "
          f"{rate:.1f} env-steps/s; per epoch (ms, CUDA events): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f"; launches over 2 epochs {dict(used)}; peak memory "
          f"{peak:.3f} GiB (torch.cuda.max_memory_allocated)")
    # per epoch: the true fidelities and the targets' chunks on the
    # one-thread amplitude kernel, the rollout and the bf16 critic once
    _expect_counts("ppo wass path", used, [
        (cuda_jacobi.amp_route(7, a_cnt * t_len), 2),
        (cuda_jacobi.amp_route(7, chunk), 2 * chunks)])
    if used["actor_env_rollout_reg"] != 2 or used["critic_train_bf16"] != 2:
        raise RuntimeError("the Wasserstein PPO epoch missed the rollout or "
                           "critic kernel")
    launches += used
    out.update(ppo_wass_rate=rate, wass_ms=split.get("wass_targets"),
               peak_gib=peak)
    cpu_cost = make(held["spec"]._replace(h0=held["spec"].h0.cpu()),
                    SP_WASS_REPS)(held["xs"].cpu(), held["keys"].cpu())
    err = float((held["cost"].cpu() - cpu_cost).abs().max())
    tgt = -held["cost"]
    print(f"ppo wass targets: {SP_WASS_HELD} of the last epoch's targets "
          f"against the CPU plain version from the same keys: max |d| "
          f"{err:.3e} (bar {TOL_KERNEL:g}); targets in "
          f"[{float(tgt.min()):.4f}, {float(tgt.max()):.4f}]")
    if err > TOL_KERNEL or not bool(torch.isfinite(held["cost"]).all()) or \
            float(held["cost"].min()) < 0.0:
        raise RuntimeError("the Wasserstein targets disagree card vs CPU")
    part("(c) ppo wass path and hold")

    # (d) ngd and wass_cost
    opt = NMPlus(7, 0, 6, testing=True, seed=5, noise=0.05, device="cuda",
                 dtype=torch.float32)
    before = build.LAUNCHES.copy()
    start = time.perf_counter()
    w, fid = opt.ngd(SP_NGD_STEPS)
    ngd_wall = time.perf_counter() - start
    used_ngd = build.LAUNCHES - before
    start = time.perf_counter()
    cost = opt.wass_cost(w, SP_WASS_REPS)
    wass_wall = time.perf_counter() - start
    used = build.LAUNCHES - before
    print(f"ngd: N=7, {SP_NGD_STEPS} steps {ngd_wall:.3f} s "
          f"({SP_NGD_STEPS / ngd_wall:.1f} steps/s), best fidelity "
          f"{fid:.6f}; wass_cost ({SP_WASS_REPS} reps) {wass_wall * 1e3:.2f} "
          f"ms, cost {cost:.6f}; launches {dict(used)}")
    _expect_counts("ngd", used_ngd, [(cuda_jacobi.grad_route(7, 1),
                                      SP_NGD_STEPS)])
    _expect_counts("ngd + wass_cost", used, [
        (cuda_jacobi.grad_route(7, 1), SP_NGD_STEPS),
        (cuda_jacobi.amp_route(7, SP_WASS_REPS), 1)])
    if not (np.isfinite(w).all() and 0.0 <= fid <= 1 + 1e-5 and
            0.0 <= cost <= 1.0):
        raise RuntimeError("ngd or wass_cost: bad result")
    launches += used
    part("(d) ngd, wass_cost")
    return launches, out


#: phase 15, the pipeline: the collect's fcall budget a run, cut from the
#: paper's 1,000,000 (scripts/get_paper_data.sh:14) to keep the whole run
#: near half its limit: PPO runs one agent under Experiment, ~0.1 s a
#: 500-step epoch on the card, so ~6 s a noise level at this budget (the
#: runs' walls and rates are printed); 100,000 until phase 16 was added,
#: 50,000 until phases 17 and 18 were
PIPE_BUDGET = 25_000
#: steps of the collect-shaped rollout hold (A=1, the collect's width), cut
#: from the collect's T=500 (which phase 7 holds at A=1024): the hold's
#: step-by-step plain pass took most of the phase's holds
COLLECT_HOLD_STEPS = 125
PAPER_BUDGET = 1_000_000
PIPE_N, PIPE_OUT, PIPE_CONTROLLERS = 7, 6, 1000
PIPE_NOISES = np.linspace(0, 0.1, 11)
PIPE_BOOTREPS = 100
#: the collect's --fid_threshold: the CLI's default 0.0, not the paper's
#: 0.1.  A landscape-exploration run offers every batch's points to its
#: top-1000 store and writes that store from its first batch whose best
#: reaches the threshold on, so the threshold decides only whether a cell
#: is written at all: where 0.1 fills a cell, 0.0 fills it with the same
#: controllers.  At the cut budget 0.1 leaves zoo cells empty on the card:
#: L-BFGS at sigma 0 (the same Sobol starts every run) ends its one batch
#: below it, and Nelder-Mead under ham noise reaches it in few runs.  As
#: 0.0 passes any search, each run is gated on beating its starts instead
PIPE_FID_THRESHOLD = 0.0
PIPE_SETS = [("lbfgs", None)] + [(a, tn) for a in ("nmplus", "snob", "ppo")
                                 for tn in ("0.0", "0.05", "0.1")]
#: the RIM tensor's sum on (ppo, "0.05") of the shipped store
#: artifacts/selfgen/experiments/pipeline_selfgen/ppo_spin_7_0-6_c_1000.le:
#: the JAX package's MCDataSim on the CPU, use_jacobi=True, seed 0,
#: noises linspace(0, 0.1, 11), bootreps 100, 1000 controllers, on a copy
#: of the store, at float32 (jax_enable_x64 off).  The card sweeps in
#: float32, whose normal draws take one 32-bit threefry word an element;
#: at float64 (two words an element) the draws are other samples and the
#: same call gives ANCHOR_RIM_SUM_F64, 0.66 away.  The bar is phase 3's
#: 1.0 on 110,000 entries scaled to this tensor's 11,000.
ANCHOR_RIM_SUM = 7841.659901872277
ANCHOR_RIM_SUM_F64 = 7842.319102361715
ANCHOR_TOL = 0.1
ANCHOR_STORE = ("artifacts/selfgen/experiments/pipeline_selfgen/"
                "ppo_spin_7_0-6_c_1000.le")
#: the families' kernels under the collect's noise (ham_noisy, the CLI's
#: default): each run must have launched one of every group.  L-BFGS
#: takes forward differences of the noisy objective through the amplitude
#: kernel (its gradient kernel is the noiseless route, phases 5, 12, 13)
PIPE_KERNELS = {"lbfgs": [AMP_KERNELS], "nmplus": [AMP_KERNELS],
                "snob": [AMP_KERNELS],
                "ppo": [("actor_env_rollout_reg",), ("critic_train_bf16",),
                        AMP_KERNELS]}


class _FamilyRuns:
    """Wraps run() of every family of the port's registry for the
    collect: each run's wall, func_calls and launches (by C entry) are read
    just after it, synchronised.  It also keeps each run's starting points,
    for the progress gate: the zoo families' restart starts (the x0s of
    every ``_run_batch``) and PPO's first epoch (the first points it offers
    to its top store)."""

    def __init__(self):
        from code_robchar_tpu_torch.models import MODEL_REGISTRY
        from code_robchar_tpu_torch.utils.record import TopControllers

        self.registry = MODEL_REGISTRY
        self.top = TopControllers
        self.own = {n: c.__dict__.get("run") for n, c in
                    MODEL_REGISTRY.items()}
        self.own_batch = {n: c.__dict__.get("_run_batch") for n, c in
                          MODEL_REGISTRY.items()}
        self.own_offer = TopControllers.offer_many
        self.runs = []
        self.family = None
        self.starts = []

    def _wrap(self, name, fn):
        def run(model, *args, **kwargs):
            torch.cuda.synchronize()
            self.family, self.starts = name, []
            before = build.LAUNCHES.copy()
            start = time.perf_counter()
            out = fn(model, *args, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            counts = build.LAUNCHES - before
            self.family = None
            noise = model.env.noise if name == "ppo" else model.noise
            h0 = (model.Monte_env if name == "ppo" else model).HH
            self.runs.append(dict(
                family=name, noise=float(noise), wall=wall,
                fcalls=model.record["func_calls"], counts=counts,
                h0=h0.detach().cpu(), io=(model.In, model.Out),
                starts=np.concatenate(self.starts),
                stored=np.asarray(model.record.get("controllers") or [],
                                  dtype=np.float64)))
            return out
        return run

    def _wrap_batch(self, fn):
        def run_batch(model, x0s, keys):
            if self.family is not None:
                self.starts.append(x0s.detach().cpu().numpy())
            return fn(model, x0s, keys)
        return run_batch

    def _offer_many(self, top, fids, controllers):
        if self.family == "ppo" and not self.starts:
            self.starts.append(np.asarray(controllers, dtype=np.float64))
        return self.own_offer(top, fids, controllers)

    def __enter__(self):
        for name, cls in self.registry.items():
            cls.run = self._wrap(name, cls.run)
            if self.own_batch[name] is not None:
                cls._run_batch = self._wrap_batch(self.own_batch[name])
        runs = self

        def offer_many(top, fids, controllers):
            return runs._offer_many(top, fids, controllers)

        self.top.offer_many = offer_many
        return self

    def __exit__(self, *exc):
        self.top.offer_many = self.own_offer
        for name, cls in self.registry.items():
            for attr, own in (("run", self.own[name]),
                              ("_run_batch", self.own_batch[name])):
                if own is None:
                    if attr in cls.__dict__:
                        delattr(cls, attr)
                else:
                    setattr(cls, attr, own)


def _share_of_starts(stored, starts, tol=1e-6):
    """The share of the stored controllers that are (within ``tol``) one
    of the run's starts: 1 for a search that never left them."""
    if len(stored) == 0:
        return 1.0
    dist = np.abs(np.asarray(stored, dtype=np.float64)[:, None, :] -
                  np.asarray(starts, dtype=np.float64)[None, :, :])
    return float((dist.max(-1).min(1) <= tol).mean())


def _true_fids(h0, xs, io):
    """Noiseless fidelities of controllers xs (K, n+1) under the drift h0,
    by the plain version on the CPU at float64: the progress gate's
    measure, independent of the card's kernels and of their counts."""
    from code_robchar_tpu_torch.models import objectives

    if len(xs) == 0:
        return np.zeros(0)
    return objectives.fidelity_batch(
        h0.to(torch.float64), torch.as_tensor(xs, dtype=torch.float64),
        *io).numpy()


class _StageClock:
    """Synchronised host seconds, calls and bytes written of the cache
    layer's stages, installed on the modules that MCDataSim calls through
    (it reads each function from its module at call time)."""

    def __init__(self):
        from code_robchar_tpu_torch.mc import engine
        from code_robchar_tpu_torch.utils import io, native_io

        self.targets = {"sweep": (engine, "mc_fidelity_sweep"),
                        "metric_tensors": (engine, "metric_tensors"),
                        "mc write": (native_io, "dump_mc"),
                        "mc encode": (native_io, "_encode_native_bytes"),
                        "mc read": (native_io, "load_mc"),
                        "mcm write": (io, "dump_json"),
                        "mcm read": (io, "load_json")}
        self.saved = {k: getattr(m, a) for k, (m, a) in self.targets.items()}
        self.seconds = dict.fromkeys(self.targets, 0.0)
        self.calls = dict.fromkeys(self.targets, 0)
        self.bytes = {"mc": 0, "mcb": 0, "mcm": 0}
        self.written = {}      # .mc path -> the tensors last written there

    def _wrap(self, label, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            if label == "metric_tensors":
                for v in out.values():
                    v.sum().item()
            torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - start
            self.calls[label] += 1
            if label == "mc write":
                tensors, path = args
                self.written[path] = {k: np.array(v, dtype=np.float64)
                                      for k, v in tensors.items()}
                self.bytes["mc"] += os.path.getsize(path)
                if os.path.exists(path + ".mcb"):
                    self.bytes["mcb"] += os.path.getsize(path + ".mcb")
            if label == "mcm write":
                self.bytes["mcm"] += os.path.getsize(args[1])
            return out
        return timed

    def __enter__(self):
        for label, (module, attr) in self.targets.items():
            setattr(module, attr, self._wrap(label, self.saved[label]))
        return self

    def __exit__(self, *exc):
        for label, (module, attr) in self.targets.items():
            setattr(module, attr, self.saved[label])


def _pipe_sim(name, root, numcontrollers=None, device="cuda",
              dtype=torch.float32):
    from code_robchar_tpu_torch.mc import MCDataSim

    return MCDataSim(name, Nspin=PIPE_N, inspin=0, outspin=PIPE_OUT,
                     noises=PIPE_NOISES, bootreps=PIPE_BOOTREPS,
                     numcontrollers=numcontrollers or PIPE_CONTROLLERS,
                     filemarker=".le",
                     seed=0, global_experiments_directory=root,
                     device=device, dtype=dtype)


def _same_metrics(a, b):
    return set(a) == set(b) and all(
        np.array_equal(np.asarray(a[k], dtype=float),
                       np.asarray(b[k], dtype=float), equal_nan=True)
        for k in a)


def _collect():
    """(a): the collect driver at full width, in-process, from the working
    directory (it writes ./experiments/)."""
    from code_robchar_tpu_torch.exp import drivers

    argv = ["--exp_name", "pipeline_smoke", "--nspin", str(PIPE_N),
            "--inspin", "0", "--outspin", str(PIPE_OUT),
            "--num_controllers", str(PIPE_CONTROLLERS),
            "--fid_threshold", str(PIPE_FID_THRESHOLD), "--noise_res", "3",
            "--max_noise", "0.1",
            "--run_until_completion_its", str(PIPE_BUDGET)]
    print(f"(a) collect: drivers.run_experiments_single_controller_set_with_"
          f"le {' '.join(argv)} (ham_noisy and the other flags at the CLI's "
          f"defaults); budget {PIPE_BUDGET} fcalls a run, cut from the "
          f"paper's {PAPER_BUDGET} (scripts/get_paper_data.sh:14)")
    start = time.perf_counter()
    with _FamilyRuns() as fam:
        exp = drivers.run_experiments_single_controller_set_with_le(argv)
    wall = time.perf_counter() - start
    stalled = []
    for r in fam.runs:
        rate = (f"{r['fcalls'] / r['wall']:.1f} objective calls/s"
                if r["fcalls"] else "no controller reached the threshold")
        first = float(_true_fids(r["h0"], r["starts"], r["io"]).max())
        kept = _true_fids(r["h0"], r["stored"], r["io"])
        best = float(kept.max()) if kept.size else float("nan")
        at_starts = _share_of_starts(r["stored"], r["starts"])
        print(f"  collect {r['family']} noise {r['noise']:g}: wall "
              f"{r['wall']:.3f} s, func_calls {r['fcalls']}, {rate}, "
              f"launches {dict(r['counts'])}; noiseless fidelity (float64, "
              f"cpu): best "
              f"of the {len(r['starts'])} "
              f"{'first-epoch points' if r['family'] == 'ppo' else 'starts'}"
              f" {first:.4f}, best of the {len(kept)} stored {best:.4f}, "
              f"stored median "
              f"{float(np.median(kept)) if kept.size else float('nan'):.4f}"
              f"; share of the stored that are starts {at_starts:.3f}")
        for group in PIPE_KERNELS[r["family"]]:
            if sum(r["counts"][k] for k in group) <= 0:
                raise RuntimeError(f"collect {r['family']} launched none of "
                                   f"{group}: {r['counts']}")
        # Nelder-Mead under ham noise ranks its store by the noisy
        # estimate: the JAX package's runs too may store nothing above the
        # best start's noiseless fidelity (tests/test_torch_nm_ham_noise.py),
        # so there the gate is that the search left its starts
        noisy_nm = r["family"] == "nmplus" and r["noise"] > 0
        if not (at_starts < 0.5 if noisy_nm else best > first):
            stalled.append((r["family"], r["noise"], first, best, at_starts))
    if stalled:
        raise RuntimeError(f"collect runs whose stored controllers do not "
                           f"beat their starts (family, noise, starts' "
                           f"best, stored best, share of the stored that "
                           f"are starts): {stalled}")
    runs = [(r["family"], r["noise"]) for r in fam.runs]
    want = [("lbfgs", 0.0)] + [(f, n) for n in (0.0, 0.05, 0.1)
                               for f in ("ppo", "nmplus", "snob")]
    print(f"  collect: {len(runs)} runs, wall {wall:.2f} s; retries 0 (the "
          f"collector has no retry loop: a failed run fails the phase)")
    if sorted(runs) != sorted(want):
        raise RuntimeError(f"collect ran {runs}, expected {want}")

    with open(exp.filename) as f:
        store = json.load(f)
    cells = {}
    for algo, tn in PIPE_SETS:
        key = str(PIPE_N) if algo == "lbfgs" else tn
        ctrl = np.asarray(store[algo][key]["controller"], dtype=float)
        cells[algo, tn] = len(ctrl)
        if not (1 <= len(ctrl) <= PIPE_CONTROLLERS and ctrl.ndim == 2
                and ctrl.shape[1] == PIPE_N + 1
                and np.isfinite(ctrl).all()):
            raise RuntimeError(f"store cell ({algo}, {key}): shape "
                               f"{ctrl.shape}")
    keys = {a: sorted(v) for a, v in store.items()}
    print(f"  store {exp.filename}: {keys}; controllers a cell {cells}")
    if keys != {"lbfgs": [str(PIPE_N)], "nmplus": ["0.0", "0.05", "0.1"],
                "snob": ["0.0", "0.05", "0.1"],
                "ppo": ["0.0", "0.05", "0.1"]}:
        raise RuntimeError(f"store keys {keys}")
    launched = sum((r["counts"] for r in fam.runs), Counter())
    return cells, launched, wall


def _hold_collect_kernels():
    """The collect's PPO kernels at the shapes it gives them, against
    their plain versions at phase 8's bars: one agent (Experiment passes
    no num_agents), T=COLLECT_HOLD_STEPS (the collect's 500 steps, cut;
    phase 7 holds T=500), h=100, ham noise, the float32 sweep count at
    N=7 and max_ep_len 1000 for the rollout; A=1, T=500, h=100 and 200
    iterations at vf_lr for the bf16 critic.  These launches are made
    outside the collect's count windows."""
    from code_robchar_tpu_torch.ops import realform

    kw = dict(in_spin=0, out_spin=PIPE_OUT,
              sweeps=realform._sweeps_for(torch.float32, PIPE_N), bmax=10.0,
              maxtime=30.0, max_ep_len=1000, ham_noisy=True)
    rollout_err = _hold_rollout(
        "collect-shaped, ham_noisy=True",
        _rollout_inputs(1, COLLECT_HOLD_STEPS, True, seed=31), kw,
        free=False)
    critic_err, _, _ = _hold_critic_bf16(
        "collect-shaped", _critic_inputs(1, PPO_STEPS, seed=32), 100, 1e-3)
    return {"rollout": rollout_err, "critic_bf16": critic_err}


def _characterise(cells):
    """(b) and (c): every set of the collected store through MCDataSim on
    the card, then a fresh MCDataSim that must load every result.
    Returns the launches of (b) and its wall."""
    from code_robchar_tpu_torch.utils import native_io

    total = len(PIPE_NOISES) * PIPE_CONTROLLERS * PIPE_BOOTREPS
    sim = _pipe_sim("pipeline_smoke", "experiments")
    before = build.LAUNCHES.copy()
    start = time.perf_counter()
    with _StageClock() as clock:
        dicts = {(a, tn): sim.get_metrics_dict(tn, algoname=a)[a]
                 for a, tn in PIPE_SETS}
    wall = time.perf_counter() - start
    used = build.LAUNCHES - before
    launches = used["herm_jacobi_fidelity"]
    chunks = len(PIPE_SETS) * -(-total // 131072)
    print(f"(b) characterise: {len(PIPE_SETS)} sets x {total} Hamiltonians "
          f"= {len(PIPE_SETS) * total} through MCDataSim (N={PIPE_N}, "
          f"float32 on the card, use_jacobi=True); wall {wall:.3f} s; "
          f"kernel 1 launches {launches} (at least {chunks}: chunks of "
          f"131072); native codec {native_io.native_available()}")
    stages = ", ".join(f"{k} {clock.seconds[k]:.3f} s ({clock.calls[k]})"
                       for k in clock.targets)
    print(f"  stages (synced, calls): {stages}; .mc writes less encode "
          f"{clock.seconds['mc write'] - clock.seconds['mc encode']:.3f} s "
          f"(file writes and the .mcb sidecar)")
    print(f"  bytes written: .mc {clock.bytes['mc']}, .mcb sidecar "
          f"{clock.bytes['mcb']}, .mcm {clock.bytes['mcm']}")
    if not native_io.native_available():
        raise RuntimeError("the native .mc codec did not build or load")
    if launches < chunks:
        raise RuntimeError(f"kernel 1 launched {launches} times, fewer "
                           f"than the sweeps' {chunks} chunks")
    for (a, tn), md in dicts.items():
        n_real = min(cells[a, tn], PIPE_CONTROLLERS)
        for k, v in md.items():
            v = np.asarray(v, dtype=float)
            if v.shape != (len(PIPE_NOISES), PIPE_CONTROLLERS) or \
                    not np.isfinite(v[:, :n_real]).all():
                raise RuntimeError(f"({a}, {tn}) {k!r}: shape {v.shape}")

    # (c) a fresh MCDataSim loads every result; no kernel launches
    before = build.LAUNCHES.copy()
    start = time.perf_counter()
    again = _pipe_sim("pipeline_smoke", "experiments")
    same = all(_same_metrics(again.get_metrics_dict(tn, algoname=a)[a],
                             dicts[a, tn]) for a, tn in PIPE_SETS)
    reload_s = time.perf_counter() - start
    path, wrote = sorted(clock.written.items())[-1]
    saved, native_io.SIDECAR = native_io.SIDECAR, False
    try:
        start = time.perf_counter()
        read = native_io.load_mc(path)
        json_s = time.perf_counter() - start
    finally:
        native_io.SIDECAR = saved
    exact = list(read) == list(wrote) and all(
        read[k].tobytes() == wrote[k].tobytes() for k in wrote)
    reloaded = build.LAUNCHES - before
    print(f"(c) reload: {len(PIPE_SETS)} metric dicts equal {same} in "
          f"{reload_s:.3f} s, launches {dict(reloaded)}; load_mc without "
          f"the sidecar {json_s:.3f} s: {sorted(read)} bit-equal to what "
          f"was written {exact}")
    if not same or reloaded or not exact:
        raise RuntimeError("the reload recomputed or changed a result")
    return used, wall


def _anchor(root):
    """(d): the shipped store's (ppo, "0.05") set against the JAX
    package's RIM sum, and a 16-controller slice against the plain path on
    the CPU: at float32 (the same draws) on every noise level, at float64
    on the zero-noise level (no draws: the same Hamiltonians).  Returns
    the launches of the anchor and the slice on the card."""
    import shutil


    name = "pipeline_selfgen"
    for sub, width in (("anchor", PIPE_CONTROLLERS), ("slice_cuda", 16),
                       ("slice_cpu", 16), ("slice_cpu64", 16)):
        os.makedirs(os.path.join(root, sub, name))
        shutil.copy(os.path.join(REPO, ANCHOR_STORE), os.path.join(
            root, sub, name, f"ppo_spin_7_0-6_c_{width}.le"))
    before = build.LAUNCHES.copy()
    start = time.perf_counter()
    sim = _pipe_sim(name, os.path.join(root, "anchor"))
    md = sim.get_metrics_dict("0.05", algoname="ppo")["ppo"]
    wall = time.perf_counter() - start
    rim = np.asarray(md[RIM], dtype=np.float64)
    fid0 = sim.get_fid_dists("0.05", algoname="ppo")["ppo"][0]
    delta = float(rim.sum()) - ANCHOR_RIM_SUM
    anchor_n = (build.LAUNCHES - before)["herm_jacobi_fidelity"]
    print(f"(d) anchor {ANCHOR_STORE} (ppo, 0.05): RIM tensor {rim.shape} "
          f"sum {rim.sum():.6f} vs the JAX package's {ANCHOR_RIM_SUM} at "
          f"float32 (delta {delta:+.6f}, tol {ANCHOR_TOL}; its float64 "
          f"draws give {ANCHOR_RIM_SUM_F64}, delta "
          f"{float(rim.sum()) - ANCHOR_RIM_SUM_F64:+.6f}); zero-noise "
          f"fidelity median {np.median(fid0):.4f}; wall {wall:.3f} s, "
          f"kernel 1 launches {anchor_n}")
    if rim.shape != (len(PIPE_NOISES), PIPE_CONTROLLERS) or \
            not np.isfinite(rim).all() or abs(delta) > ANCHOR_TOL:
        raise RuntimeError(f"anchor RIM sum {rim.sum()} misses "
                           f"{ANCHOR_RIM_SUM} by {delta}")
    card = _pipe_sim(name, os.path.join(root, "slice_cuda"), 16)
    got = card.get_metrics_dict("0.05", algoname="ppo")["ppo"]
    for sub, dtype, rows in (("slice_cpu", torch.float32, slice(None)),
                             ("slice_cpu64", torch.float64, slice(0, 1))):
        cpu = _pipe_sim(name, os.path.join(root, sub), 16, device="cpu",
                        dtype=dtype)
        ref = cpu.get_metrics_dict("0.05", algoname="ppo")["ppo"]
        for k in (RIM, "std", "worst case fid"):
            a, b = (np.asarray(m[k])[rows] for m in (got, ref))
            err = float(np.abs(a - b).max())
            print(f"  slice 16 controllers, noise levels {a.shape[0]}, "
                  f"{k!r}: max|cuda f32 - cpu {str(dtype)[6:]}| {err:.3e} "
                  f"(tol {TOL_SLICE:g}; held values' median "
                  f"{np.median(np.abs(b)):.4f})")
            if not err <= TOL_SLICE:
                raise RuntimeError(f"the pipeline slice disagrees with the "
                                   f"{dtype} plain path on {k!r}: {err}")
    return build.LAUNCHES - before


def _entry_point_alone():
    """(e): the CLI in a process of its own, and the pipeline's modules'
    imports free of jax and of the JAX package."""
    proc = subprocess.run([sys.executable, "-m",
                           "code_robchar_tpu_torch.exp.drivers"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    usage = proc.stdout.strip()
    print(f"(e) python -m code_robchar_tpu_torch.exp.drivers: exit "
          f"{proc.returncode}, {usage!r}")
    if proc.returncode != 2 or not usage.startswith(
            "usage: python -m code_robchar_tpu_torch.exp.drivers"):
        raise RuntimeError(f"the CLI without a command: {proc}")
    probe = ("import json, sys\n"
             "import code_robchar_tpu_torch.exp.drivers\n"
             "import code_robchar_tpu_torch.mc.datasim\n"
             "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
             "or m.startswith('jax.') or m == 'code_robchar_tpu' or "
             "m.startswith('code_robchar_tpu.'))))\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    found = proc.stdout.strip()
    print(f"  modules of jax or the JAX package after importing drivers and "
          f"datasim: {found} (exit {proc.returncode})")
    if proc.returncode != 0 or found != "[]":
        raise RuntimeError(f"the pipeline imports {found}: {proc.stderr}")


def phase_pipeline():
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="robchar_pipeline_")
    here = os.getcwd()
    os.chdir(root)
    try:
        cells, launched, collect_s = _collect()
        start = time.perf_counter()
        held = _hold_collect_kernels()
        print(f"  the collect's PPO kernels held: "
              f"{time.perf_counter() - start:.1f} s")
        char, char_s = _characterise(cells)
        launched += char + _anchor(root)
    finally:
        os.chdir(here)
        shutil.rmtree(root, ignore_errors=True)
    _entry_point_alone()
    return launched, dict(collect_s=collect_s, characterise_s=char_s,
                          held=held)


#: phase 16, the figures: the in-repo selfgen stores (N=5, 0 -> 2) at the
#: paper's size, copied to a temporary directory: the characterised
#: figures on the 1000-controller store (ten sets), fig 8 on the
#: fcall-checkpointed 100-controller sets, fig 1 on legacy stores written
#: from the 1000-controller one
FIG_ROOT = "artifacts/selfgen/experiments"
FIG_EXP, FIG_SCALING = "pipeline_selfgen", "pipeline_selfgen_scaling"
FIG_N, FIG_OUT = 5, 2
FIG_NOISES = np.linspace(0, 0.1, 11)
FIG_BOOTREPS = 100
FIG_SETS = [("lbfgs", None)] + [(a, tn) for a in ("nmplus", "snob", "ppo")
                                for tn in ("0.0", "0.05", "0.1")]
FIG1_NOISES = np.linspace(0, 1, 11)
#: fig 1's noise level for joint_ecdfs (sigma 0.5 of the ten left once
#: get_sd_results drops sigma 0)
FIG1_ECDF_LEVEL = 4
#: the holds' bar: card against the port's float32 plain version on the
#: CPU, and both against the JAX package's float32 values below
FIG_TOL = 1e-5
#: fig 8's held checkpoint: (algo, training noise, fcall key) of .le_sh
FIG8_CELL = ("snob", "0.05", "2000100")
#: the JAX package's float32 values (jax_enable_x64 off) on the CPU, from
#: copies of the two stores, by this program run from the repository root
#: with PYTHONPATH=. and JAX_PLATFORMS=cpu (about 80 s):
#:   import shutil, tempfile, numpy as np, jax
#:   jax.config.update("jax_platforms", "cpu")
#:   from code_robchar_tpu.figs import ARIMGenerator, NStochOpt
#:   root = tempfile.mkdtemp()
#:   for d in ("pipeline_selfgen", "pipeline_selfgen_scaling"):
#:       shutil.copytree("artifacts/selfgen/experiments/" + d,
#:                       f"{root}/{d}")
#:   kw = dict(Nspin=5, inspin=0, outspin=2,
#:             noises=np.linspace(0, 0.1, 11), bootreps=100,
#:             filemarker=".le", seed=0, fig_dir=root + "/figs",
#:             global_experiments_directory=root)
#:   a = ARIMGenerator("pipeline_selfgen", numcontrollers=1000,
#:                     use_jacobi=True, **kw)
#:   arim, err = a.arim_curve("snob", "0.05")      # JAX_FIG5_ARIM, _ERR
#:   s = NStochOpt("pipeline_selfgen_scaling", numcontrollers=100, **kw)
#:   cell = s.c_dict_sh["snob"]["0.05"]
#:   row, _ = s.get_arims("snob", "0.05", "",       # JAX_FIG8_ROW
#:                        {"snob": {"0.05": {"2000100": cell["2000100"]}}})
#:   print(arim.tolist(), err.tolist(), row[0].tolist())
JAX_FIG5_ARIM = [0.018670380115509033, 0.02222132682800293,
                 0.03210794925689697, 0.047656476497650146,
                 0.06610137224197388, 0.08907568454742432,
                 0.11143505573272705, 0.13332247734069824,
                 0.16199827194213867, 0.18391108512878418,
                 0.20717507600784302]
JAX_FIG5_ERR = [0.0007913141162134707, 0.0010290646459907293,
                0.002069538924843073, 0.003682431997731328,
                0.005564894527196884, 0.007781440857797861,
                0.009776478633284569, 0.010811696760356426,
                0.012691951356828213, 0.013841859064996243,
                0.015440787188708782]
JAX_FIG8_ROW = [0.1433788686990738, 0.14856328070163727,
                0.1638457179069519, 0.18289032578468323,
                0.21461281180381775, 0.23918171226978302,
                0.27957049012184143, 0.3076113760471344,
                0.33734130859375, 0.3745536506175995,
                0.39976418018341064]


def _fig_kwargs(root, **kw):
    return dict(dict(Nspin=FIG_N, inspin=0, outspin=FIG_OUT,
                     noises=FIG_NOISES, bootreps=FIG_BOOTREPS,
                     numcontrollers=1000, filemarker=".le", seed=0,
                     global_experiments_directory=root), **kw)


def _fig_stores(root):
    import shutil

    for d in (FIG_EXP, FIG_SCALING):
        shutil.copytree(os.path.join(REPO, FIG_ROOT, d),
                        os.path.join(root, d))


def _finite(label, *arrays):
    for a in arrays:
        a = np.asarray(a, dtype=np.float64)
        if a.size == 0 or not np.isfinite(a).all():
            raise RuntimeError(f"{label}: {a.size} values, not all finite")


def _fig_stage(watch, name, sync_on, fn):
    """``fn()`` timed by the Stopwatch and ``timed``; returns its result
    and its launches."""
    from code_robchar_tpu_torch.utils.trace import timed

    before = build.LAUNCHES.copy()
    with watch.section(name), timed(name, sync_on=sync_on):
        out = fn()
    return out, build.LAUNCHES - before


def _fig_characterised(root, watch):
    """(a): figs 3, 4, 5 and rimk on the ten sets of the N=5 store; the
    first class fills the .mc / .mcm caches, the others reload them."""
    import contextlib
    import io

    from code_robchar_tpu_torch import figs

    kw = _fig_kwargs(root, fig_dir=os.path.join(root, "figs"))
    probe = torch.zeros(1, device="cuda")      # timed's sync target
    total = len(FIG_NOISES) * 1000 * FIG_BOOTREPS
    chunks = len(FIG_SETS) * -(-total // 131072)

    def fig3():
        sim = figs.IndividualContComparisons(FIG_EXP, **kw)
        return {s: sim._rim_bands(s[0], s[1], FIG_NOISES, sim.topk)
                for s in FIG_SETS}

    bands, fig3_used = _fig_stage(watch, "(a) fig3 _rim_bands", probe, fig3)
    fig3_n = fig3_used["herm_jacobi_fidelity"]
    rim0 = [float(np.median(c[0])) for c, _, _ in bands.values()]
    rim1 = [float(np.median(c[-1])) for c, _, _ in bands.values()]
    print(f"(a) fig3 _rim_bands: {len(FIG_SETS)} sets x {total} "
          f"Hamiltonians (N={FIG_N}, 1000 controllers, float32 on the "
          f"card), top-k bands {bands[FIG_SETS[0]][0].shape}; median RIM at "
          f"sigma 0 {min(rim0):.4f}..{max(rim0):.4f}, at sigma 0.1 "
          f"{min(rim1):.4f}..{max(rim1):.4f}; kernel 1 launches {fig3_n} "
          f"(at least {chunks}: chunks of 131072)")
    for s, (c, u, l) in bands.items():
        _finite(f"fig3 {s}", c, u, l)
    if fig3_n < chunks:
        raise RuntimeError(f"fig 3 launched kernel 1 {fig3_n} times")

    def fig4():
        sim = figs.KTRConsistency(FIG_EXP, **kw)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            taus = {s: sim.pairwise_taus(sim._rim(s[0], s[1], sim.topk))
                    for s in FIG_SETS}
        return taus, sim.vn_failures, buf.getvalue().count("\n")

    (taus, vn, warned), used = _fig_stage(watch, "(a) fig4 pairwise_taus",
                                          probe, fig4)
    fig4_n = used["herm_jacobi_fidelity"]
    t0 = [float(t[0, -1]) for t in taus.values()]
    print(f"(a) fig4 pairwise_taus: {len(taus)} tau matrices "
          f"{taus[FIG_SETS[0]].shape}, tau(sigma 0, sigma 0.1) "
          f"{min(t0):.4f}..{max(t0):.4f}, diagonal min "
          f"{min(float(np.diag(t).min()) for t in taus.values()):.4f}; VN "
          f"failures {vn} ({warned} warning lines); kernel 1 launches "
          f"{fig4_n}")
    for s, t in taus.items():
        _finite(f"fig4 {s}", t)

    def fig5():
        sim = figs.ARIMGenerator(FIG_EXP, **kw)
        return {s: sim.arim_curve(s[0], s[1]) for s in FIG_SETS}

    curves, used = _fig_stage(watch, "(a) fig5 arim_curve", probe, fig5)
    fig5_n = used["herm_jacobi_fidelity"]
    print(f"(a) fig5 arim_curve: " + "; ".join(
        f"{a}{'' if tn is None else ' ' + tn} {v[0]:.5f} -> {v[-1]:.5f} "
        f"(+-{e[-1]:.5f})" for (a, tn), (v, e) in curves.items())
          + f"; kernel 1 launches {fig5_n}")
    for s, (v, e) in curves.items():
        _finite(f"fig5 {s}", v, e)
        if not v[0] <= v[-1]:
            raise RuntimeError(f"fig5 {s}: ARIM at sigma 0 {v[0]} above "
                               f"sigma 0.1's {v[-1]}")

    at = [str(x) for x in FIG_NOISES].index("0.05")

    def rimk():
        sim = figs.ExploringRIMK(FIG_EXP, **_fig_kwargs(root))
        return sim.rim_k_tensor("ppo", noise_index=at)

    rk, used = _fig_stage(watch, "(a) rimk rim_k_tensor", probe, rimk)
    rimk_n = used["herm_jacobi_fidelity"]
    print(f"(a) rimk rim_k_tensor(ppo, noise_index={at} -> \"0.05\"): "
          + ", ".join(f"{k} {v.shape} mean {float(v.mean()):.5f}"
                      for k, v in rk.items())
          + f"; kernel 1 launches {rimk_n}")
    _finite("rimk", *rk.values())
    if fig4_n or fig5_n or rimk_n:
        raise RuntimeError(f"a reload launched kernel 1: fig4 {fig4_n}, "
                           f"fig5 {fig5_n}, rimk {rimk_n}")
    return curves, fig3_used


def _fig8_pass(root, watch, label):
    from code_robchar_tpu_torch import figs

    def run():
        s = figs.NStochOpt(FIG_SCALING, **_fig_kwargs(
            root, numcontrollers=100, fig_dir=os.path.join(root, "figs")))
        return {(marker, algo, nlvl): s.get_arims(algo, nlvl, marker, cd)
                for marker, cd in (("nonstoch", s.c_dict_nsh),
                                   ("", s.c_dict_sh))
                for algo in cd for nlvl in cd[algo]}

    return _fig_stage(watch, label, torch.zeros(1, device="cuda"), run)


def _fig8(root, watch):
    """(b): fig 8's ARIMs over every (marker, algo, nlvl) of the scaling
    store, then a second pass that must load every pickle."""
    start = time.perf_counter()
    rows, launched = _fig8_pass(root, watch, "(b) fig8 get_arims")
    wall = time.perf_counter() - start
    n = launched["herm_jacobi_fidelity"]
    ckpts = sum(len(a) for a, _ in rows.values())
    print(f"(b) fig8 get_arims: {len(rows)} (marker, algo, nlvl) cells, "
          f"{ckpts} checkpoints of 100 controllers x {len(FIG_NOISES)} x "
          f"{FIG_BOOTREPS} = 110000 Hamiltonians; kernel 1 launches {n} "
          f"(one a checkpoint); {wall:.3f} s, "
          f"{ckpts * 110000 / wall:.1f} Hamiltonians/s; mean ARIM of the "
          f"last checkpoint " + ", ".join(
              f"{m or 'stoch'} {a} {nl} {arims[-1].mean():.4f}"
              for (m, a, nl), (arims, _) in rows.items()
              if nl == "0.05" and len(arims)))
    for cell, (arims, _) in rows.items():
        if len(arims):
            _finite(f"fig8 {cell}", arims)
    if n != ckpts:
        raise RuntimeError(f"fig 8: {n} launches for {ckpts} checkpoints")
    start = time.perf_counter()
    again, used = _fig8_pass(root, watch, "(b) fig8 pickles")
    n2 = used["herm_jacobi_fidelity"]
    same = list(again) == list(rows) and all(
        np.array_equal(again[c][0], rows[c][0]) and again[c][1] == rows[c][1]
        for c in rows)
    print(f"(b) fig8 second pass: every pickle loaded, equal {same}; "
          f"kernel 1 launches {n2}; {time.perf_counter() - start:.3f} s")
    if n2 or not same:
        raise RuntimeError("fig 8's second pass swept or changed a cell")
    return rows, launched


def _fig1(root, watch):
    """(c): fig 1 on legacy stores written from the N=5 store."""
    from code_robchar_tpu_torch import figs
    from code_robchar_tpu_torch.utils import io

    store = io.load_json(os.path.join(
        root, FIG_EXP, f"ppo_spin_{FIG_N}_0-{FIG_OUT}_c_1000.le"))
    legacy = os.path.join(root, "noisy_analysis")
    for algo in ("lbfgs", "ppo"):
        io.dump_json({algo: store[algo]}, os.path.join(
            legacy, f"{algo}_spin_{FIG_N}_0-{FIG_OUT}_in"))

    def run():
        ex = figs.CDFAreaExample(legacy, spin=FIG_N, inspin=0,
                                 outspin=FIG_OUT, bootreps=FIG_BOOTREPS,
                                 controllers=100)
        return ex, ex.get_sd_results(FIG1_NOISES)

    (ex, (noises, fl, fp)), launched = _fig_stage(
        watch, "(c) fig1 get_sd_results", torch.zeros(1, device="cuda"), run)
    n = launched["herm_jacobi_fidelity"]
    xs, ca, cb = ex.joint_ecdfs(fl[FIG1_ECDF_LEVEL, 0], fp[FIG1_ECDF_LEVEL, 0])
    print(f"(c) fig1 get_sd_results: lbfgs and ppo {ex.rlc_index!r}, "
          f"{fl.shape} {fl.dtype} each over sigma {noises[0]:.1f}.."
          f"{noises[-1]:.1f}; median fidelity lbfgs {np.median(fl[0]):.4f} "
          f"-> {np.median(fl[-1]):.4f}, ppo {np.median(fp[0]):.4f} -> "
          f"{np.median(fp[-1]):.4f}; kernel 1 launches {n}; joint_ecdfs at "
          f"sigma {noises[FIG1_ECDF_LEVEL]:.1f}, controller 0: "
          f"{xs.shape[0]} points, ECDFs at the middle {ca[len(ca) // 2]:.3f}"
          f" / {cb[len(cb) // 2]:.3f}")
    _finite("fig1", fl, fp, xs, ca, cb)
    if ex.rlc_index != "0.05" or fl.shape != (10, 100, FIG_BOOTREPS) or \
            fp.shape != fl.shape or n < 2:
        raise RuntimeError(f"fig 1: {ex.rlc_index} {fl.shape} {n}")
    if (np.diff(ca) < 0).any() or (np.diff(cb) < 0).any():
        raise RuntimeError("fig 1's joint ECDFs are not monotone")
    return launched


def _fig_holds(root, curves, rows):
    """(d): the fig 8 row and the fig 5 curve against the port's float32
    plain version on the CPU and the JAX package's float32 values."""
    from code_robchar_tpu_torch import figs

    cpu = os.path.join(root, "cpu")
    _fig_stores(cpu)
    algo, nlvl, key = FIG8_CELL
    arims, keys = rows["", algo, nlvl]
    card8 = arims[keys.index(key)]
    s = figs.NStochOpt(FIG_SCALING, **_fig_kwargs(
        cpu, numcontrollers=100, fig_dir=os.path.join(cpu, "figs"),
        device="cpu", dtype=torch.float32))
    start = time.perf_counter()
    cpu8 = s.get_arims(algo, nlvl, "", {algo: {nlvl: {
        key: s.c_dict_sh[algo][nlvl][key]}}})[0][0]
    cpu8_s = time.perf_counter() - start
    card5 = curves["snob", "0.05"][0]
    start = time.perf_counter()
    a = figs.ARIMGenerator(FIG_EXP, **_fig_kwargs(
        cpu, fig_dir=os.path.join(cpu, "figs"), device="cpu",
        dtype=torch.float32))
    cpu5, cpu5_err = a.arim_curve("snob", "0.05")
    cpu5_s = time.perf_counter() - start
    worst = 0.0
    for label, card, plain, ref in (
            (f"fig8 ARIM row {FIG8_CELL}", card8, cpu8, JAX_FIG8_ROW),
            ("fig5 ARIM curve (snob, 0.05)", card5, cpu5, JAX_FIG5_ARIM)):
        d_cpu = float(np.abs(card - plain).max())
        d_jax = float(np.abs(card - np.asarray(ref)).max())
        d_cpu_jax = float(np.abs(plain - np.asarray(ref)).max())
        worst = max(worst, d_cpu, d_jax, d_cpu_jax)
        print(f"(d) {label}: max|card - cpu f32 plain| {d_cpu:.3e}, "
              f"max|card - JAX f32| {d_jax:.3e}, max|cpu - JAX f32| "
              f"{d_cpu_jax:.3e} (tol {FIG_TOL:g}; values "
              f"{card[0]:.6f}..{card[-1]:.6f})")
    card5_err = curves["snob", "0.05"][1]
    print(f"  fig5 bootstrap std (not held): max|card - cpu| "
          f"{float(np.abs(card5_err - cpu5_err).max()):.3e}, max|card - "
          f"JAX| {float(np.abs(card5_err - np.asarray(JAX_FIG5_ERR)).max()):.3e}"
          f"; the CPU's plain version: fig8 row {cpu8_s:.2f} s (110000 "
          f"Hamiltonians), fig5 curve {cpu5_s:.2f} s (1.1M)")
    if not worst <= FIG_TOL:
        raise RuntimeError(f"the figure holds miss {FIG_TOL}: {worst}")
    return worst


def _fig_checkpoint(root):
    """(e): one PPO actor-critic's parameters and Adam states round-trip
    through utils.checkpoint onto the card, bit-equal."""
    from code_robchar_tpu_torch.models import PPO_en
    from code_robchar_tpu_torch.ops import prng
    from code_robchar_tpu_torch.utils import checkpoint

    ppo = PPO_en(FIG_N, 0, FIG_OUT, testing=True, num_agents=16)
    st = ppo._init_agent(prng.split(prng.key(3), 16))
    path = checkpoint.save_state(os.path.join(root, "ckpt", "agent"), st)
    back = checkpoint.restore_state(path, template=st)
    pairs = []
    checkpoint._map(lambda t, like: pairs.append((t, like)) or t, back, st)
    equal = type(back) is type(st) and len(pairs) > 10 and all(
        t.device == like.device and t.dtype == like.dtype and
        torch.equal(t, like) for t, like in pairs)
    print(f"(e) checkpoint: PPO_en(N={FIG_N}, 16 agents) params, pi and vf "
          f"Adam states: {len(pairs)} tensors, "
          f"{sum(t.numel() * t.element_size() for t, _ in pairs)} bytes, "
          f"{os.path.getsize(path)} on disk; restored onto "
          f"{sorted({str(t.device) for t, _ in pairs})}, bit-equal {equal}")
    if not equal:
        raise RuntimeError("the checkpoint round trip changed the state")


def phase_figures():
    import shutil
    import tempfile

    from code_robchar_tpu_torch.utils.trace import Stopwatch

    root = tempfile.mkdtemp(prefix="robchar_figures_")
    watch = Stopwatch()
    try:
        _fig_stores(root)
        curves, launched = _fig_characterised(root, watch)
        rows, fig8 = _fig8(root, watch)
        launched += fig8 + _fig1(root, watch)
        worst = _fig_holds(root, curves, rows)
        _fig_checkpoint(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("  stopwatch: " + watch.report().replace("\n", "; "))
    print(f"  launches in phase 16: {dict(launched)}")
    return launched, dict(fig_worst=worst, fig8_s=watch.totals[
        "(b) fig8 get_arims"])


SNOBFIT_RESTARTS, SNOBFIT_BUDGET = 16, 300


class _SnobfitRecorder:
    """Stands in for SNOBSkquant's engine namespace: keeps each restart's
    start and history, the scored batches' sizes and the seconds spent
    scoring them (launches, the copy back, the key split)."""

    def __init__(self, engine):
        self.engine = engine
        self.starts, self.batches, self.score_s = [], [], 0.0

    def minimize(self, objective, x0, objective_batch=None, **kw):
        def scored(xs):
            start = time.perf_counter()
            vals = objective_batch(xs)
            self.score_s += time.perf_counter() - start
            self.batches.append(len(xs))
            return vals
        self.starts.append(np.asarray(x0, dtype=float))
        return self.engine.minimize(objective, x0, objective_batch=scored,
                                    **kw)


def _snobfit_run(label, worst, **kw):
    """SNOBSkquant.run() at N=7 on the vendored engine, budget mode
    (SNOBFIT_RESTARTS restarts of SNOBFIT_BUDGET), its launches counted;
    then every amplitude launch of the run held against the plain version
    on the card.  Returns (the optimizer, the recorder, the wall, the
    launches)."""
    from code_robchar_tpu_torch.models import SNOBSkquant
    from code_robchar_tpu_torch.ops import cuda_jacobi, realform

    budget = SNOBFIT_RESTARTS * SNOBFIT_BUDGET
    opt = SNOBSkquant(7, 0, 6, testing=True, fid_threshold=0.0,
                      run_until_told_to_stop=True,
                      run_until_completion_its=budget,
                      landscape_exploration=True, save_topc=100,
                      budget=SNOBFIT_BUDGET, backend="vendored",
                      device="cuda", dtype=torch.float32, **kw)
    if opt.backend_name != "vendored":
        raise RuntimeError(f"SNOBSkquant resolved {opt.backend_name}")
    rec = opt._skq = _SnobfitRecorder(opt._skq)
    held = []
    entry = cuda_jacobi.transfer_amp_sym

    def recorded(a, t, i, o, sweeps=None):
        phr, phi = entry(a, t, i, o, sweeps)
        held.append((a.clone(), t.clone(), i, o, sweeps, phr, phi))
        return phr, phi

    cuda_jacobi.transfer_amp_sym = recorded
    before = build.LAUNCHES.copy()
    try:
        start = time.perf_counter()
        opt.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    finally:
        cuda_jacobi.transfer_amp_sym = entry
    used = build.LAUNCHES - before

    # every launch of the run against the plain version on the card, at
    # phase 4's bar; the run's batches in one plain call a shape group
    err = 0.0
    for (i, o, sweeps) in {(h[2], h[3], h[4]) for h in held}:
        part = [h for h in held if h[2:5] == (i, o, sweeps)]
        a = torch.cat([h[0] for h in part], dim=-1)
        t = torch.cat([h[1] for h in part])
        pr, pi = realform.transfer_amp_sym_lanes(a, t, i, o, sweeps)
        kr = torch.cat([h[5] for h in part])
        ki = torch.cat([h[6] for h in part])
        if not bool(torch.isfinite(kr).all() & torch.isfinite(ki).all()):
            raise RuntimeError(f"snobfit {label}: a non-finite amplitude")
        err = max(err, float((kr - pr).abs().max()),
                  float((ki - pi).abs().max()))
    ok = err <= TOL_KERNEL
    print(f"snobfit {label}: every amplitude launch of the run ({len(held)}: "
          f"{sum(h[0].shape[-1] for h in held)} matrices) against the plain "
          f"version on the card: max abs {err:.3e} (tol {TOL_KERNEL:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"snobfit {label}: the amplitude kernel "
                           f"disagrees with its plain version")
    worst["sym_jacobi_amp_group"] = max(worst["sym_jacobi_amp_group"], err)
    return opt, rec, wall, used


def phase_snobfit(worst):
    """Phase 17: the exact-SNOBFIT adapter and the env's reference methods
    on the card."""
    from code_robchar_tpu_torch.models.env import Environment
    from code_robchar_tpu_torch.ops import cuda_jacobi

    launches = Counter()
    # SNOBFIT suggests n + 6 points a round in its n = 8 dimensions
    route = cuda_jacobi.amp_route(7, 8 + 6)
    out = {}
    for label, kw in (("noiseless", {}),
                      ("ham_noisy sigma 0.05", dict(ham_noisy=True,
                                                    noise=0.05))):
        opt, rec, wall, used = _snobfit_run(label, worst, **kw)
        r = opt.record
        n_batches = len(rec.batches)
        sizes = sorted(set(rec.batches))
        host_s = wall - rec.score_s
        stored = r.get("controllers") or []
        h0 = opt.HH.cpu()
        best_start = float(_true_fids(h0, np.asarray(rec.starts), (0, 6))
                           .max())
        best_stored = float(_true_fids(h0, np.asarray(stored), (0, 6)).max()
                            ) if stored else 0.0
        share = _share_of_starts(stored, rec.starts)
        print(f"snobfit {label}: N=7, {len(rec.starts)} restarts of budget "
              f"{SNOBFIT_BUDGET}, landscape exploration: {wall:.2f} s, "
              f"{len(rec.starts) / wall:.2f} restarts/s; func_calls "
              f"{r['func_calls']}; scored batches {n_batches} (sizes "
              f"{sizes}), {sum(rec.batches)} points; scoring "
              f"{rec.score_s:.2f} s, host (SNOBFIT's numpy) {host_s:.2f} s, "
              f"host share {host_s / wall:.3f}; launches {dict(used)}; "
              f"best_fid "
              f"{r['best_fid']!r}; stored {len(stored)}, best noiseless "
              f"fidelity stored {best_stored:.6f} against the starts' "
              f"{best_start:.6f}, share of stored at a start {share:.3f}")
        _expect_counts(f"snobfit {label}", used,
                       [(route, n_batches + len(rec.starts))])
        if r["func_calls"] != SNOBFIT_RESTARTS * SNOBFIT_BUDGET or \
                len(rec.starts) != SNOBFIT_RESTARTS:
            raise RuntimeError(f"snobfit {label}: the run did not reach its "
                               f"budget")
        if used[route] < n_batches or max(rec.batches) != 8 + 6:
            raise RuntimeError(f"snobfit {label}: fewer launches than "
                               f"scored batches")
        if kw:
            if share >= 0.5:
                raise RuntimeError(f"snobfit {label}: the search never left "
                                   f"its starts")
        elif not best_stored > best_start:
            raise RuntimeError(f"snobfit {label}: the stored controllers do "
                               f"not beat their starts")
        launches += used
        out[label] = len(rec.starts) / wall

    env = Environment(7, 0, 6, device="cuda")
    z = env.structured_perturabation(0.05)
    sv = env.state_vector(3)
    ok = (z.device.type == "cuda" and z.shape == (7, 7) and
          torch.equal(z, z.mH) and float(z.imag.abs().max()) == 0.0 and
          float(z.abs().max()) > 0.0 and sv.shape == (7,) and sv[3] == 1.0
          and float(np.abs(sv).sum()) == 1.0 and
          env.input_state()[0, 0] == 1 and env.output_state()[6, 6] == 1 and
          float(env.input_state().sum() + env.output_state().sum()) == 2.0)
    print(f"env reference methods on the card: structured_perturabation "
          f"{tuple(z.shape)} {z.dtype} on {z.device}, Hermitian, real off "
          f"the diagonal, max |z| {float(z.abs().max()):.4f}; state_vector, "
          f"input_state, output_state {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the env's reference methods failed on the card")
    return launches, out


MESH_ENTRIES = 4


def _sharded_pool(mesh, cls, seed):
    """One N=7 pool of MESH_POOL restarts: the unsharded batch, the batch
    sharded over ``mesh`` twice, and over a one-entry mesh; each compared
    as the JAX package's tests/test_parallel.py does.  Returns the
    launches of the two sharded runs."""
    from code_robchar_tpu_torch.ops import prng
    from code_robchar_tpu_torch.parallel import Mesh, sharded_run_batch

    opt = _zoo_optimizer(cls)
    x0s = torch.as_tensor(opt.init_points(MESH_POOL), dtype=torch.float32,
                          device="cuda")
    keys = prng.split(prng.key(seed), MESH_POOL)

    def timed(fn):
        start = time.perf_counter()
        res = fn()
        float(res.fid.sum())
        return res, time.perf_counter() - start

    ref, wall0 = timed(lambda: opt._run_batch(x0s, keys))
    before = build.LAUNCHES.copy()
    got, wall = timed(lambda: sharded_run_batch(mesh, opt, x0s, keys))
    stats = dict(opt.stats)
    again, wall2 = timed(lambda: sharded_run_batch(mesh, opt, x0s, keys))
    used = build.LAUNCHES - before
    one, _ = timed(lambda: sharded_run_batch(Mesh(["cuda:0"]), opt, x0s,
                                             keys))
    same = all(torch.equal(getattr(got, k), getattr(again, k))
               for k in ("x", "fid", "true_fid", "nfev", "nit"))
    one_same = all(torch.equal(getattr(one, k), getattr(ref, k))
                   for k in ("x", "fid", "true_fid", "nfev", "nit"))
    gap = abs(float(got.true_fid.mean() - ref.true_fid.mean()))
    fid = got.fid.cpu().numpy()
    ok = (same and one_same and gap < 5e-2 and np.isfinite(fid).all() and
          fid.min() >= -1e-5 and fid.max() <= 1 + 1e-5 and
          int(got.nfev.min()) > 0)
    moved = int((got.x != ref.x).any(1).sum())
    print(f"mesh (b) {cls.name}: N=7 pool {MESH_POOL} over {mesh.size} "
          f"entries ({MESH_POOL // mesh.size} a block): sharded {wall:.3f} / "
          f"{wall2:.3f} s against unsharded {wall0:.3f} s (host-paced); two "
          f"sharded runs bit-equal {same}; one-entry mesh bit-equal to "
          f"_run_batch {one_same}; mean true fid sharded "
          f"{float(got.true_fid.mean()):.6f} vs unsharded "
          f"{float(ref.true_fid.mean()):.6f} (gap {gap:.2e}, bar 5e-2); "
          f"restarts apart from the unsharded {moved}; stats {stats}; "
          f"launches of the two sharded runs {dict(used)} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"mesh (b) {cls.name}: the sharded pool failed")
    return used


def phase_mesh(mc_first, mc_wall, worst, ppo_err):
    """Phase 18: the mesh on the card (a MESH_ENTRIES-entry mesh of
    cuda:0)."""
    from code_robchar_tpu_torch.mc import engine
    from code_robchar_tpu_torch.models import LBFGS, Adam, NMPlus, PPO_en
    from code_robchar_tpu_torch.ops import cuda_jacobi, prng
    from code_robchar_tpu_torch.parallel import (Mesh, dryrun,
                                                 sharded_mc_metrics,
                                                 sharded_run_batch)

    print(f"mesh: torch.cuda.device_count() {torch.cuda.device_count()}; "
          f"a {MESH_ENTRIES}-entry mesh of cuda:0 (the blocks run one after "
          f"another from the host on the one card)")
    mesh = Mesh(["cuda:0"] * MESH_ENTRIES)
    total = Counter()

    # (a) the MC headline at full width, sharded
    h0, ctrl, noises = _mc_inputs()
    before = build.LAUNCHES.copy()
    start = time.perf_counter()
    md = sharded_mc_metrics(mesh, h0.to("cuda"), ctrl, noises, prng.key(1),
                            MC_BOOTREPS, 0, 6, complex_offdiag=True,
                            alpha=0.05)
    checksum = float(md[engine.RIM_NAME].sum(dtype=torch.float64))
    wall = time.perf_counter() - start
    used = build.LAUNCHES - before
    total += used
    equal = sorted(k for k in md if torch.equal(md[k], mc_first[k]))
    want = float(mc_first[engine.RIM_NAME].sum(dtype=torch.float64))
    ok = (len(md) == 15 and len(equal) == 15 and checksum == want and
          used["herm_jacobi_fidelity"] > 0)
    print(f"mesh (a) sharded_mc_metrics: N=7 {MC_CONTROLLERS} controllers "
          f"({MC_CONTROLLERS // MESH_ENTRIES} a block) x {MC_NOISES} x "
          f"{MC_BOOTREPS}, key(1): {wall:.4f} s against the unsharded "
          f"median {mc_wall:.4f} s; kernel 1 launches "
          f"{used['herm_jacobi_fidelity']}; tensors bit-equal to phase 3's "
          f"key(1) run {len(equal)} of {len(md)}; rim_checksum "
          f"{checksum:.3f} (phase 3: {want:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("mesh (a): the sharded metrics differ from the "
                           "unsharded run")

    # (b) the zoo pools, sharded
    for cls, seed in ((LBFGS, 31), (NMPlus, 32)):
        total += _sharded_pool(mesh, cls, seed)

    # (c) PPO at bench.py's configuration, the agents sharded, two epochs
    # through run(); beside it the same unsharded; the block shapes' kernels
    # held first
    # (phase 7 holds the rollout kernel over T=500 at A=1024; here the
    # block's agent count over phase 7's T=64)
    a_blk = PPO_AGENTS // MESH_ENTRIES
    kw = dict(in_spin=0, out_spin=6, sweeps=4, bmax=10.0, maxtime=30.0,
              max_ep_len=40, ham_noisy=True)
    ppo_err["rollout"] = max(ppo_err["rollout"], _hold_rollout(
        "a sharded block", _rollout_inputs(a_blk, 64, True, seed=41), kw,
        free=False))
    ppo_err["critic_bf16"] = max(ppo_err["critic_bf16"], _hold_critic_bf16(
        "a sharded block", _critic_inputs(a_blk, PPO_STEPS, seed=42), 100,
        1e-3)[0])
    walls = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        ppo = PPO_en(7, 0, 6, testing=True, fid_threshold=0.0,
                     ham_noisy=True, run_until_told_to_stop=True,
                     run_until_completion_its=10**12, num_agents=PPO_AGENTS,
                     rollout_sweeps=4, mesh=m, device="cuda",
                     dtype=torch.float32)
        before = build.LAUNCHES.copy()
        start = time.perf_counter()
        best = ppo.run(epochs=2, steps_per_epoch=PPO_STEPS)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - start
        used = build.LAUNCHES - before
        if m is not None:
            total += used
            blocks = 2 * MESH_ENTRIES
            ok = (used["actor_env_rollout_reg"] == blocks and
                  used["critic_train_bf16"] == blocks and
                  used["sym_jacobi_amp"] == blocks and
                  used["critic_train"] == 0 and 0 <= best <= 1 + 1e-5)
            print(f"mesh (c) PPO_en N=7 {PPO_AGENTS} agents ({a_blk} a "
                  f"block) x {PPO_STEPS} steps, ham_noisy, 2 epochs through "
                  f"run(): {walls['sharded']:.3f} s against unsharded "
                  f"{walls['unsharded']:.3f} s (host-paced); "
                  f"{2 * PPO_AGENTS * PPO_STEPS / walls['sharded']:.1f} "
                  f"env-steps/s; launches {dict(used)} (rollout, bf16 "
                  f"critic and "
                  f"the true fidelities once a block an epoch: {blocks}); "
                  f"best reward {best:.6f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("mesh (c): the sharded PPO epoch did not "
                                   "launch its kernels once a block")

    # (d) Adam, 64 streams, one segment sharded; its block shape held
    xs = None
    walls = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        opt = _zoo_optimizer(Adam)
        opt.fid_threshold = 0.0
        x0s = opt.init_points(ADAM_STREAMS)
        keys = prng.split(prng.key(43), ADAM_STREAMS)
        if xs is None:
            xs = torch.as_tensor(x0s[:ADAM_STREAMS // MESH_ENTRIES],
                                 dtype=torch.float32, device="cuda")
            _hold_zoo_kernels("adam sharded block", *_lanes_of(opt, xs),
                              opt.HH, xs, 0, 6, worst)
        before = build.LAUNCHES.copy()
        start = time.perf_counter()
        if m is None:
            res = opt._run_batch(torch.as_tensor(x0s, dtype=torch.float32,
                                                 device="cuda"), keys)
        else:
            res = sharded_run_batch(m, opt, x0s, keys)
        float(res.fid.sum())
        walls[name] = time.perf_counter() - start
        used = build.LAUNCHES - before
        if m is not None:
            total += used
            blk = ADAM_STREAMS // MESH_ENTRIES
            steps = opt.segment_its
            _expect_counts("mesh (d) adam", used, [
                (cuda_jacobi.grad_route(7, blk), MESH_ENTRIES * steps),
                (cuda_jacobi.amp_route(7, blk), MESH_ENTRIES * (steps + 1))])
            ok = bool(torch.isfinite(res.fid).all()) and \
                res.x.shape == (ADAM_STREAMS, 8)
            print(f"mesh (d) adam: N=7 {ADAM_STREAMS} streams ({blk} a "
                  f"block), one {steps}-step segment: {walls['sharded']:.3f} "
                  f"s against unsharded {walls['unsharded']:.3f} s "
                  f"(host-paced); best fid {float(res.fid.max()):.6f} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("mesh (d): the sharded Adam segment "
                                   "failed")

    # (e) the dry run
    before = build.LAUNCHES.copy()
    start = time.perf_counter()
    dryrun.dryrun_multichip(MESH_ENTRIES)
    used = build.LAUNCHES - before
    total += used
    print(f"mesh (e) dry run: {time.perf_counter() - start:.2f} s, "
          f"launches {dict(used)}")
    print(f"  kernel launches in phase 18: {dict(total)}")
    return total


def _run(phase, *args):
    """Run one phase and print the seconds it took."""
    start = time.perf_counter()
    out = phase(*args)
    print(f"{phase.__name__}: {time.perf_counter() - start:.1f} s")
    return out


def main():
    smi = _run(phase_device)
    res = _run(phase_build)
    err, ms, plain_ms, lib_ms, bound = _run(phase_kernel)
    mc_launches, wall, rate, checksum, mc_first, draw = \
        _run(phase_main_path)
    zoo_err, zoo_ms, floor = _run(phase_zoo_kernels)
    zoo_launches, zoo = _run(phase_zoo_path, zoo_err)
    ks = _run(phase_zoo_gates)
    ppo_err, ppo_ms = _run(phase_ppo_kernels)
    ppo_launches, ppo_rate, amp_err, amp_ms = _run(phase_ppo_path)
    _run(phase_ppo_checks)
    probe_launches, probe = _run(phase_probes)
    noisy = _run(phase_shot_noise)
    adam_snob_launches, adam_snob = _run(phase_adam_snob, zoo_err)
    sp_launches, sp = _run(phase_single_point)
    pipe_launches, pipe = _run(phase_pipeline)
    fig_launches, fig = _run(phase_figures)
    snobfit_launches, snobfit = _run(phase_snobfit, zoo_err)
    mesh_launches = _run(phase_mesh, mc_first, wall, zoo_err, ppo_err)
    # the launches on the paths of phases 3, 5, 8, 10, 12, 13 and 15-18, by
    # C entry; the holds' and the timing loops' are not among them
    path = (mc_launches + zoo_launches + ppo_launches + probe_launches
            + adam_snob_launches + sp_launches + pipe_launches + fig_launches
            + snobfit_launches + mesh_launches)
    src = "code_robchar_tpu_torch/csrc/"

    def entry(name, replaces, max_err, times, lib, source=None):
        k_ms, p_ms, (b_ms, b_by) = times
        return {"name": name, "route": "cuda",
                "source": src + (source or name) + ".cu",
                "replaces": replaces, "launches": path[name],
                "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}

    def zoo_entry(name, replaces, times=None):
        # timed at the batch that the kernel's path gives it
        k_ms, p_ms, lib, bnd = times or zoo_ms[name, LINE_BATCH[name]]
        return entry(name, replaces, zoo_err[name], (k_ms, p_ms, bnd), lib,
                     name.replace("_group", ""))

    amp_at, grad_at = "code_robchar_tpu/ops/pallas_jacobi.py:356", \
        "code_robchar_tpu/ops/pallas_jacobi.py:408"
    # the one-thread amplitude kernel's error and times from the PPO
    # path's own batch (phase 8)
    for name, held in pipe["held"].items():
        ppo_err[name] = max(ppo_err[name], held)
    zoo_err["sym_jacobi_amp"] = max(zoo_err["sym_jacobi_amp"], amp_err)
    kernels = [
        entry("herm_jacobi_fidelity",
              "code_robchar_tpu/ops/pallas_jacobi.py:209", err,
              (ms, plain_ms, bound), lib_ms),
        entry("mc_draw_lanes", "none (XLA ops: code_robchar_tpu/mc/"
              "engine.py:69)", *draw, None),
        zoo_entry("sym_jacobi_amp_group", amp_at),
        zoo_entry("sym_jacobi_amp", amp_at, amp_ms),
        zoo_entry("sym_jacobi_grad_group", grad_at),
        zoo_entry("sym_jacobi_grad", grad_at),
        entry("actor_env_rollout_reg",
              "code_robchar_tpu/ops/pallas_rollout.py:127",
              ppo_err["rollout"], ppo_ms["rollout"], None,
              "actor_env_rollout"),
        entry("critic_train", "code_robchar_tpu/ops/pallas_critic.py:54",
              ppo_err["critic"], ppo_ms["critic"], None),
        entry("critic_train_bf16", "code_robchar_tpu/ops/pallas_critic.py:54",
              ppo_err["critic_bf16"], ppo_ms["critic_bf16"], None),
        entry("alu_probe", "artifacts/perf/roofline.py:272",
              *probe["alu_probe"], None),
        entry("tanh_probe", "artifacts/perf/tanh_microbench.py:31",
              *probe["tanh_probe"], None)]
    print(f"summary: build {res.seconds:.2f} s; MC path {wall:.4f} s, "
          f"{rate:.1f} Hams/s, rim_checksum {checksum:.3f}; L-BFGS "
          f"{zoo['lbfgs'][1]:.1f} restarts/s, NM {zoo['nmplus'][1]:.1f} "
          f"restarts/s (N=7, pool {ZOO_POOL}); KS {ks}; PPO "
          f"{ppo_rate:.1f} env-steps/s (N=7, {PPO_AGENTS} agents), "
          f"one-thread amplitude launches on the PPO path "
          f"{ppo_launches['sym_jacobi_amp']}; launch_floor_ms {floor}; shot "
          f"noise "
          + ", ".join(f"{k} {v:.1f}" for k, v in noisy.items())
          + f" restarts/s (PPO env-steps/s); Adam (N=7, 64 streams) "
          f"{adam_snob['adam_steps_s']:.1f} steps/s, ham_noisy "
          f"{adam_snob['adam_noisy_steps_s']:.1f}; SNOB "
          f"{adam_snob['snob_restarts_s']:.1f} restarts/s (N=7, pool "
          f"{ZOO_POOL}); card vs cpu KS {adam_snob['ks']}; run_accelerated "
          f"(N=7, box +-{SP_NM_BOX:g} x (0, {SP_NM_TIME:g})) "
          f"{sp['nm_noiseless_it_s']:.1f} iterations/s, ham_noisy "
          f"{sp['nm_ham_noisy_it_s']:.1f}; PPO with Wasserstein targets "
          f"{sp['ppo_wass_rate']:.1f} env-steps/s (targets {sp['wass_ms']:.2f} "
          f"ms an epoch, peak {sp['peak_gib']:.3f} GiB); pipeline (N=7) "
          f"collect {pipe['collect_s']:.2f} s at {PIPE_BUDGET} fcalls a run, "
          f"characterise {pipe['characterise_s']:.3f} s for "
          f"{len(PIPE_SETS)} sets of 1.1M Hamiltonians; figures (N=5) "
          f"fig 8 {fig['fig8_s']:.2f} s, holds within "
          f"{fig['fig_worst']:.2e}; SNOBSkquant (N=7, vendored) "
          + ", ".join(f"{k} {v:.2f}" for k, v in snobfit.items())
          + f" restarts/s; card {smi}")
    print(json.dumps({"kernels": kernels}))
    # every C entry's launches in this process, the holds' and the timing
    # loops' too
    print(json.dumps({"launches": dict(sorted(build.LAUNCHES.items()))}))
    draws, launches = path["mc_draw_lanes"], path["herm_jacobi_fidelity"]
    if draws != launches:
        raise RuntimeError(f"the path phases launched the draw kernel "
                           f"{draws} times and kernel 1 {launches} times")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
