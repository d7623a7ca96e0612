#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py          # needs one CUDA card; exits non-zero without
    python3 chip_smoke.py --ab DIR [PART ...]
                                   # A/B: the checkout at DIR (an earlier
                                   # tree) and this one, alternated
    python3 chip_smoke.py --lm     # phases 0, 1, 15, 16 and 17 alone
                                   # (no result)
    python3 chip_smoke.py --tune   # phases 0, 1 and 18 alone (no result)
    python3 chip_smoke.py --mesh   # phases 0, 1, 4 and 19 alone (no result)
    python3 chip_smoke.py --gemm   # phases 0, 1 and 10b alone (no result)

Phases, each asserting (any failure exits non-zero and prints no result):

  0. device    -- a CUDA card is present; print its name and power limit
                  (nvidia-smi), the torch / CUDA versions and nvcc's;
  1. build     -- build the kernel library from src/repro_torch/kernels/csrc,
                  one nvcc per source in parallel; print ptxas's registers,
                  spills and notes for each flash-attention kernel: the six
                  bf16 / f16 wgmma instantiations must spill nothing and
                  carry no (C75xx) note of a serialised wgmma; the nine
                  float32 ones (the forward, the backward's dK/dV and dQ
                  kernels, D 64/128/256) must spill nothing and their SASS
                  (cuobjdump -sass) must hold TF32 tensor-core instructions
                  (HMMA ... TF32): split TF32, not FMAs;
  2. kernels   -- the fused local-update + L1-prox kernel against its plain
                  PyTorch version on the card, compared as integer bit
                  patterns (-0.0 and NaN included), in float32, bfloat16 and
                  float64 at (30, 4,194,304), and float64 at the main path's
                  shapes (30, 21) and (30, 112,395) and at (1, 21); median
                  kernel and plain times (CUDA events) beside the bound;
  3. main path -- the paper's Fig. 2 problem (n 30, m 100, d 20, float64)
                  through repro_torch.fed.simulator.run on the card, DProx
                  tau = 10 and tau = 1, 500 rounds: the kernel runs exactly
                  rounds * tau times, and the optimality sequence matches the
                  same run on the CPU (plain step) at rtol 1e-6 above 1e-9;
                  then Fig. 2's baselines FedDA, FedMid and FastFedDA at tau
                  10 and 1 with Fig. 2's step sizes, 200 rounds each on the
                  card and on the CPU, optimality equal the same way and no
                  kernel launched; and DProx at tau = 1 (kernel 1) == FedDA
                  (plain ops) on the card, x_bar at atol 1e-12 after 10
                  rounds;
  4. wide      -- the same model and generator at d = 112,394 (the federated
                  state width of the paper's Fig. 4 CNN), features cached on
                  the card, tau = 10 for 20 rounds: launches == rounds * tau,
                  optimality finite and decreasing; s/round and the kernel's
                  share of the round's device time, no cat kernel launched
                  once a local step (the leaves are read in place); and, for
                  the record of its two departures from the reference's
                  set-up, the gradient at zero against the paper's lam and
                  the trajectory with the reference's L;
  5. compressed paper path -- the Fig. 2 problem, tau = 10, with the uplink
                  compressed on the flat plane (EngineConfig(plane=True)):
                  TopK(0.25, global) and Quantize(8, global) (its draws made
                  on the CPU by one seeded generator and copied to the card),
                  200 rounds each on the card and on the CPU: optimality
                  equal at rtol 1e-6 above 1e-9, and each plane kernel
                  launched exactly once per round;
  6. wide compressed path -- phase 4's set-up with TopK(0.1, global) and
                  Quantize(8, global) on the plane, tau = 10, 20 rounds each
                  (draws from the card's own generator): launches, finite
                  optimality, uplink bytes per client per round, s/round and
                  each kernel's share of a round's device time;
  7. paper async -- the quickstart's two async configurations on the Fig. 2
                  problem, tau = 10, 200 commits each, on the card and on
                  the CPU with the clock's draws made on the CPU: (a)
                  StragglerClock(4.0), buffer 15 of 30, Staleness("poly",
                  correct=True); (b) the same on the plane with TopK(0.25)
                  up and down and queue_depth=2.  Optimality at every eval
                  point equal at rtol 1e-6 above 1e-9, the staleness ledger
                  (age histogram, mean and max age) equal commit by commit;
                  in (b) the commit kernel launched once per commit;
  8. wide async -- phase 4's set-up on the plane with TopK(0.1, global),
                  StragglerClock(4.0), buffer 15 of 30, Staleness("poly",
                  correct=True), queue_depth=2, 20 commits (draws from the
                  card's own generators): the commit kernel launched 20
                  times, finite optimality, s/commit after a warm chunk, one
                  profiled commit's busy time, idle share and top kernels,
                  and the commit kernel's share of the busy time;
  9. cohort      -- the quickstart's cohort run: population 3,000, cohort 30,
                  TopK(0.25), chunk 16, 200 rounds on the Fig. 2 problem, on
                  the card and on the CPU: the final loss at rtol 1e-6 and
                  the population store's touched rows equal;
 10. flash     -- the flash-attention kernel against its plain version at
                  the serving path's shapes, twice: inputs scaled by 0.5,
                  max abs error 3e-2 (bf16) / 2e-5 (f32) (the reference's
                  check); then q, k scaled to logits of std 16, where the
                  softcap bends and the softmax is peaked, against the plain
                  version in f32, max row error ||got - exp|| / ||exp||
                  1e-2 (bf16) / 1e-4 (f32), with controls (softcap dropped,
                  window moved by 32 keys, causal flipped) that must move
                  the plain version by 10x that; first, the compiled
                  kernel's own tile plan (flash_attention.kernel_tile_plan)
                  equals the Python one the CPU tests hold to a brute-force
                  mask; gemma2-9b prefill
                  (1, 4608, 16/8, 256) bf16 softcap 50, global and window
                  4,096; (2, 1000, 16/8, 256) (ragged S); mistral-nemo
                  (1, 4096, 32/8, 128) bf16; stablelm (2, 512, 32/32, 64)
                  f32; (2, 1000, 32/8, 128) bf16 not causal; stablelm's
                  training shape (16, 128, 32/32, 64) f32.  float32 runs as
                  training calls it, with the rows' log-sum-exp, held to
                  lse_plain at 1e-5 of max |lse|.  Kernel ms (CUDA events
                  and profiler), plain ms, the bound (causal FLOPs at 989
                  TFLOP/s bf16, 165 split-TF32 f32 -- 67 on the CUDA cores
                  beside it -- against the bytes), and
                  F.scaled_dot_product_attention's ms (events and profiler)
                  where it computes the same function (no softcap, no
                  window);
 10b. split GEMM -- the split-TF32 GEMM kernel (csrc/split_gemm.cu) at
                  every product of a local step of the stablelm cell (4
                  clients x 512 tokens; forward, dX and dW of q/k/v/o,
                  gate/up, down and the tied head), operands laid out as
                  the autograd Function hands them over, and at the 320-row
                  float32 prefill products of phases 11a, 16a and 17a:
                  read in place (no copy), one launch each, computed as
                  C^T exactly where gemm.transposed says
                  (split_gemms_transposed), its error
                  against a float64 product at most twice torch.matmul's at
                  "highest" (float32 on the CUDA cores); kernel ms (CUDA
                  events and profiler), the bound (operations at 165
                  TFLOP/s split TF32) and the events' ms's share of it
                  (the profiler can miss records after the smoke's earlier
                  profiling), the SM clock and
                  power drawn meanwhile (nvidia-smi), the plain version's ms
                  and torch.matmul's at "highest" (events and profiler) at
                  the cell's products, and the sums over a local step's 87
                  products;
 11. gemma2-9b serving -- (a) full width, one local+global period, float32,
                  window 96, 2 x 160-token prompts and 8 teacher-forced
                  decode steps (the ring cache rolls at prefill and wraps in
                  decode): the card's logits equal the CPU port's within
                  1e-4 x max|logit|, the caches within 1e-4 x max|cache|;
                  serve == sequential generate greedily on the card (a
                  flip only where the top-2 margin is below the logits'
                  tolerance); (b) full width and depth
                  (42 layers, 9.24 B random bf16 params from a seed):
                  generate 2 x 1024 + 32, then serve 4 requests (prompts
                  4,608 / 1,024 / 2,500 / 640, 32 new each) on 2 slots,
                  segment 8, max_len 8,192: every request finishes with
                  finite logprobs, the flash kernel launched 42 times per
                  prefill and nothing else; prefill ms per request, decode
                  ms per token, and for one profiled decode step and
                  prefills of 4,608 and 1,024 tokens the device busy time,
                  the idle share and the kernel's share of busy time;
 13. Fig. 4    -- run after phase 9, before phase 10 (no torch.compile before
                  it): the paper's CNN (d = 112,394, float32) on the
                  procedural MNIST split over 10 clients, minibatches of 10,
                  L1 1e-4, eta 0.005, params0 from seed 0 on the CPU. (a)
                  DProx and FedDA, tau 5, eta_g 1.5, 2 rounds on the card and
                  on the CPU port: x_bar within 1e-4 of max |x_bar|, TF32 off
                  inside the model (asserted; the logits with TF32 allowed
                  are printed beside); (b) the reference test's gate
                  (tests/test_paper_experiments.py:43-65): 3,000 / 800
                  images, tau 5, 40 rounds, DProx accuracy > 0.7 and >=
                  FedDA's - 0.02; (c) Fig. 4 in full (fig4_cnn.py):
                  12,000 / 2,500 images, 150 rounds, tau 5 and 10, DProx and
                  FedDA at eta_g 1.0, 11 evals: final and best test accuracy
                  and s/round; kernel 1 launched rounds * tau times in every
                  DProx run, never in a FedDA run, no copy; (d) one profiled
                  DProx round at tau 10: busy time, idle share, top kernels
                  and kernel 1's share;
 14. runtime   -- run after phase 13, before phase 10: the multi-process
                  runtime (repro_torch.fed.runtime) at phase 4's width (n 30,
                  m 100, d = 112,394, float64, tau 10, 20 rounds, chunks of
                  4), each run through run_pair (a server subprocess, rank 0
                  in this process, on the card): (a) dense blocking and
                  overlapped (both traced), plane top-k 0.1, quantize 8 bits:
                  the server's fields bitwise run_local on the card, replay
                  drift <= 1e-12, rank 0's launches (kernel 1 rounds * tau,
                  kernel 2 or 3 once per compressed leaf a round), wall,
                  send_wait, sender_busy and bytes; (b) two workers and a
                  replica at d = 4,096: finite loss, 5 commits of each worker
                  in the server's JSONL log, and the replica subprocess exits
                  0 only on a BITWISE reconstruction; (c) the traced runs'
                  merged Chrome traces pass validate_chrome, and obs.report's
                  hidden fraction is printed; (d) the wide DProxState saved
                  (checkpoint.ckpt) and restored to the card through a meta
                  template, bitwise;
 12. flex      -- the library yardstick of phase 10's softcap cases, which
                  SDPA cannot compute: torch.compile'd flex_attention (the
                  softcap as score_mod, the causal window as the block mask)
                  on the same inputs, its compile seconds, ms (CUDA events)
                  and device ms (a CUDA-graph replay of the compiled call,
                  whose output must equal the eager call's bitwise), held
                  to the kernel at the bf16 tolerance (fatal).  Only a failure to
                  import, compile or first call it is logged and carries on,
                  as "not measured": the port never calls it.  It runs last
                  so that no torch.compile precedes the serving phase's
                  host-clock timings.  The same at grok-1's softcap shape
                  (phase 17), and for kernel 5b's softcap cases the
                  compiled backward's device time: a CUDA-graph replay of
                  forward + backward less one of the forward.  (SDPA's
                  device time, where the profiler keeps no record of its
                  kernels, is a CUDA-graph replay too.)

 15. LM training -- run after phase 11, before 12: (a) the flash-attention
                  backward kernel (5b) against its plain version computed
                  in float64, each of dq, dk, dv within 1e-4 of its max
                  |.| at logits of std 16, with controls (softcap dropped,
                  window moved by 32 keys, causal flipped) that must move
                  the plain gradients by 10x that: stablelm (16, 128,
                  32/32, 64) and (2, 2048, 32/32, 64), mistral-nemo (2,
                  512, 32/8, 128), gemma2-9b (1, 512, 16/8, 256) softcap
                  50, global and window 256; kernel ms, plain ms, the bound
                  (10 D operations an admitted pair at 165 TFLOP/s split
                  TF32 -- 67 f32 beside it -- against the bytes) and SDPA's
                  backward, events and profiler (phase 12: flex_attention's
                  for the softcap cases); (b) the smoke
                  stablelm, mistral-nemo, gemma2, phi3 and recurrentgemma
                  (head_dim 64), mamba2 (no attention), grok (head_dim 32)
                  and deepseek (MLA, Dk 24 / Dv 16) through
                  the trainer's set-up (repro_torch.launch.train.build),
                  hubert and internvl2 (head_dim 32) through
                  core.algorithm's round on launch.specs.train_batches, 2
                  clients, tau 2, 4 rounds, on the card and on the CPU port
                  with params from one seed and PyTorch's TF32 allowed:
                  train_loss at rtol 1e-5 and x_bar within 1e-4 x max
                  |x_bar| every round, kernels 5 and 5b (attention layers)
                  x tau x rounds times (recurrentgemma-smoke 1 of 3
                  layers, mamba2 none), kernel 1 tau x rounds; (c)
                  stablelm-1.6b at
                  full width (depth cut from 24 to 4 layers, 411 M float32
                  params) through the trainer's build and train: 4 clients,
                  batch 4, seq 128, tau 4, chunk 4, 8 rounds: finite loss,
                  the same launch counts and no copy, s/round after the
                  first chunk, peak memory, one profiled round (busy, idle
                  share, top kernels, the shares of 5 and 5b); then global
                  top-k 0.1 on the plane for 4 rounds, kernel 2 once a
                  round; (d) ``python -m repro_torch.launch.train --scale
                  100m --rounds 4 --tau 2 --clients 2`` in a subprocess
                  exits 0.
 16. model zoo -- run after phase 15, before 12: the recurrent and
                  state-space families and phi3.  (c) first, on an empty
                  card: kernel 5 (bf16, causal) at the new prefill shapes
                  -- recurrentgemma-9b's local layers (1, 4096, 16/1, 256)
                  window 2,048, phi3-medium-14b's long-context variant (1,
                  12288, 40/10, 128) window 8,192 and full attention (1,
                  4096, 40/10, 128) -- through phase 10's checks: the
                  reference's 3e-2, then the sharp check at logit std 16
                  (max row error 1e-2, the controls window +-32 and causal
                  flipped), against the plain version (the blocked one at
                  S 12,288, where the dense one's logits do not fit);
                  kernel ms (events, profiler), the bound (admitted causal
                  pairs x 4 D x H at 989 TFLOP/s), the plain version's ms
                  and SDPA's (is_causal; with a window a boolean (S, S)
                  mask on kv heads repeated to H), the backend it took
                  named by trial.  (a) card vs CPU port in float32 at full
                  width: recurrentgemma-9b's one period (rec, rec, local;
                  window cut to 96), phi3-medium-14b's one layer under its
                  long-context variant at window 96, mamba2-130m's 24
                  layers: 2 x 160-token prompts and 8 teacher-forced decode
                  steps (the rings roll at prefill and wrap in decode),
                  logits within 1e-4 x max|logit|, each cache leaf within
                  1e-4 of its max, kernel 5 once per attention layer.  (b)
                  full width and depth in bf16, random params from a seed:
                  recurrentgemma-9b (38 layers, window 2,048; prompts 4,096
                  / 1,024 / 640), phi3-medium-14b under its long-context
                  variant (40 layers, window 8,192; prompts 12,288 / 2,048
                  / 700) and mamba2-130m (24 layers; 4,096 / 1,024 / 640):
                  generate 2 x 1,024 + 16, then serve the three requests
                  (16 new each) on 2 slots, segment 8: finite logprobs,
                  kernel 5 launched 12 / 40 / 0 times per prefill and
                  nothing else; prefill ms per prompt length, decode ms per
                  token, peak memory; one profiled prefill of the first
                  prompt (busy, idle share, kernel 5's share, the device
                  time of the RG-LRU scan and of the SSD inside profiler
                  ranges, and each timed alone at that shape) and one
                  profiled decode step (busy, idle share).
 17. the rest of the zoo -- run after phase 16, before 12: hubert-xlarge,
                  internvl2-26b, grok-1-314b and deepseek-v3-671b.  (c)
                  first, on an empty card: kernel 5 in bf16 through phase
                  10's checks at hubert's (8, 1500, 16/16, 80) not causal,
                  deepseek-v3's MLA prefill (1, 4096, 128/128, Dk 192 / Dv
                  128) causal (the blocked plain version) and grok-1's (1,
                  4096, 48/8, 128) softcap 30; then kernel 5 in float32
                  with the lse and kernel 5b (against the plain versions in
                  float64, with controls) at (4, 512, 16/16, 80) not causal
                  and (4, 512, 16/16, 192/128) causal.  Head dims the
                  kernels are not built at run padded to the next width
                  (128, 256): the kernel alone on inputs padded beforehand
                  is timed beside the call.  The bound: admitted pairs x
                  2 (Dk + Dv) x H at 989 TFLOP/s (bf16) or 165 (split
                  TF32), at the true head dims; SDPA's time where it takes
                  the shape, its backend named by trial.  (a) card vs CPU
                  port in float32 at full width on cuts, params from one
                  seed: hubert's 2 of 48 layers on features (2, 160, 512)
                  (every frame's logits, the caches and the masked loss),
                  internvl2's 1 layer on patches (2, 40, 3200) + 120
                  tokens, then 8 teacher-forced decode steps, grok-1's 1
                  layer with d_ff_expert cut 32,768 -> 4,096, deepseek-v3's
                  1 dense MLA layer + 1 MLA / MoE layer with 16 of 256
                  experts (top-8 and the shared expert kept): 160-token
                  prompts and 8 decode steps; logits within 1e-4 x
                  max|logit|, each cache leaf within 1e-4 of its max, one
                  kernel-5 launch per attention layer, and for the MoE
                  cases the smallest top-k margin of the router
                  probabilities on each side.  (b) full width in bf16,
                  random params from a seed: hubert-xlarge's 48 layers
                  encode (8, 1500) frames (48 launches; the serving engine
                  refuses it); internvl2-26b's 48 layers generate 2 x
                  (1,024 patches + 3,072 tokens) + 16; grok-1 (depth 4 of
                  64) and deepseek-v3 (depth 4 of 61: 3 dense MLA layers +
                  1 MLA / MoE) prefill 4,096 and 1,024 tokens and generate
                  2 x 1,024 + 16, grok's greedy serve of 3 requests equal
                  to sequential generate bitwise at lossless capacity
                  (deepseek's recorded beside it: MLA's batched decode
                  rounds apart from batch 1, as the reference says):
                  launches, peak memory, prefill ms, decode ms per token,
                  one profiled prefill (busy, idle share, kernel 5's share,
                  the MoE's route / dispatch / expert GEMMs / combine inside
                  profiler ranges) and one profiled decode step.
 18. tuning    -- run after phase 14, before 10: the autotuner
                  (repro_torch.tune) on the card, every record in a
                  temporary directory and every subprocess in a temporary
                  working directory.  (a) tune(Workload(), budget 6, 16
                  rounds a trial, device "cuda"): each trial's counters
                  set to 0 before it and held after it to what its point
                  implies (kernel 1 tau per round of the warm chunk and the
                  timed repetitions; top-k's select and the quantizer once
                  a round per compressed leaf; the commit once a plane
                  commit under asynchrony), then the same call again: a
                  cache hit, no trial, the same best; (b) top-k 0.25 on
                  the plane and per-leaf quantize measured on the card and
                  on the CPU: bytes per client and round equal; (c) the
                  straggler workload with every sampled point on the plane,
                  budget 4: the commit kernel launched, the winner's
                  staleness (and, where it is zero, the first aged
                  trial's) equal to the CPU's within one float32 ulp; (d)
                  one multi-process trial (a worker process, overlapped):
                  hidden fraction in [0, 1], then ``python -m
                  repro_torch.obs.report TRACE --bw 1e9`` on its trace
                  prints the roofline block; (e) ``python -m
                  repro_torch.launch.train --autotune 3 --arch
                  stablelm_1_6b --scale smoke --rounds 2`` in a subprocess
                  (run as ``__main__`` by a wrapper that prints the
                  counters): it adopts the winner, and kernels 5 and 5b
                  launch once per attention layer and local step.
 19. the mesh  -- (a) run after phase 8, on its wide problem: the placed
                  engine (EngineConfig(mesh=...), repro_torch.launch) on a
                  one-rank NCCL (1, 1) CUDA mesh, plan A, d = 112,394, n 30,
                  tau 10, float64, 20 rounds: x_bar and c bitwise the
                  unplaced engine's, kernel 1 launched 200 times in each;
                  then the Fig. 2 problem placed with quickstart (b)'s
                  top-k + asynchrony on the plane, 40 commits: every state
                  leaf bitwise the unplaced run's and kernels 1, 2 and 4
                  launched as often as unplaced (each > 0); s/round placed
                  and unplaced.  (b) run after phase 17: the expert-parallel
                  MoE (repro_torch.models.moe_ep, two all-to-alls on the
                  one-rank mesh) against layers.moe on the same weights at
                  lossless capacity: full width in bf16 at grok-1's layer
                  (d 6,144, 8 experts, top-2, d_ff 32,768; 4,096 tokens)
                  and deepseek-v3's (d 7,168, 256 experts, top-8, d_ff
                  2,048; 2,048 tokens: the lossless buffers are E x T x d),
                  error over max |out| printed with the times, then an f32
                  cut held to 1e-4 on out and aux.  (c) the dry run
                  (python -m repro_torch.launch.dryrun) in subprocesses on
                  a fake 512-rank world: stablelm-1.6b x train_4k x single
                  with probes and deepseek-v3-671b x decode_32k x multi
                  with --no-probes, each exiting 0 with a report whose
                  FLOPs are > 0 (useful ratio, dominant term and seconds
                  printed).

Phase 2 also holds the two plane kernels (global top-k's threshold select,
the stochastic quantizer) against their plain versions, bit for bit, at
(30, 112,512), (30, 128) and (1, 112,512) float64 -- the compressed paths'
planes -- and at (30, 4,194,304) in float32, bfloat16 and float64, with
NaN, +-0, +-inf, |x| == thresh and a zero-scale row injected, and times
``torch.topk`` at the wide plane beside the select.  It holds the weighted
commit kernel against its plain version, bit for bit, at (30, 128) and
(30, 112,512) float64 and at (30, 4,194,304) in float32, bfloat16 and
float64 (float64 weights), with float32 weights (the main path's) on the
two float64 planes, a plane 8 bytes off a 16-byte boundary and 300 rows,
with NaN, +-0 and +-inf injected and zero weights for undelivered clients,
and times ``torch.mv(buf.t(), w)`` and the plain-load commit kernel
(``weighted_commit_2d(..., loads=True)``, bitwise checked too) beside it.  It runs the fused update's
tree entry (``ops.fused_local_update``) on the paper tree {w: (30, 20),
b: (30,)} and the wide tree {w: (30, 112,394), b: (30,)} float64, and on
the Fig. 4 CNN's 10-leaf tree (2-D to 5-D leaves, 10 clients, float32), from
contiguous leaves and from views of a previous output plane: bitwise
equal to the plain version, one launch and one kernel a call (profiler),
no copy.  Then the host cost of a wrapper call by parts (10,000 calls of
each piece).

``--ab DIR [PART ...]`` runs, in four processes (DIR, this tree, this
tree, DIR), each with its own package and kernels, the parts named (all by
default): ``kernels`` -- kernel 1 on phase 2's planes and on the two
trees, kernel 4 at its record's shapes, phase 3's 500-round paths, phase
4's wide round and phase 7b's commits; ``attention`` -- kernel 5 at phase
10's float32 shapes and kernel 5b at phase 15a's five, each beside SDPA;
``gemm`` -- kernel 6 at phase 10b's products and prefill products, with
the SM clock and power; the results go to ``chiprun_out/ab.json``.

Each kernel's launches and the fused update's copies in the kernels'
registry, ``kernels/_build.COUNTS``, are read as what they moved over each
path of phases 3-9, 11, 13-19; no path may copy before kernel 1.  The
split GEMM (kernel 6) counts on every float32 model path on the card: one
launch a product with the weights in a forward over
``layers.KERNEL_MIN_ROWS`` rows or more, three under ``vmap(grad)``, none
in a decode step (``_dense_products``); its launches as C^T and its
operand copies are checked product by product in 10b, and 15c holds the
cell's path to no copy.  The
line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  A copy of the summary goes to
``chip_smoke.json`` in the output directory that ``main`` names.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ETA, THRESH = 0.37, 0.21
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# peak rate of the elementwise kernels' arithmetic (vector units, no tensor
# cores) per compute type, H100 SXM data sheet: FP32 67 TFLOP/s, FP64 34
# TFLOP/s
PEAK_OPS = {"float32": 67e12, "bfloat16": 67e12, "float64": 34e12}
# float32 attention (kernels 5 and 5b) runs its products on the tensor cores
# in split TF32 (x = hi + lo, three TF32 products for each float32 one): a
# third of the dense TF32 rate, 495 / 3 TFLOP/s.  Its bound is taken at this
# rate; the 67 TFLOP/s of float32 on the CUDA cores is kept beside it
SPLIT_TF32_OPS = 495e12 / 3
OPS_PER_ELEMENT = 10  # add, mul, sub, abs, sub, max, 2 compares, sub, mul
# the plane kernels' operations per element: select -- abs, compare,
# select; quantize -- div, mul, floor, sub, compare, add, div, mul
PLANE_OPS = {"threshold_select": 3, "quantize": 8}
COMMIT_OPS = 2  # the commit: a multiply and an add per element
SPECIALS = [float("nan"), -0.0, 0.0, float("inf"), -float("inf")]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# the counts of kernels/_build.COUNTS at the last reset_counts()
_ZERO: dict = {}
# kernel 6's events that follow its operands' layouts, not launches: phase
# 10b checks both product by product and 15c holds the cell's path to no
# copy; elsewhere a copy is the wrapper's way with such an operand (15b's
# hubert smoke config copies 32)
_BY_LAYOUT = ("split_gemms_transposed", "split_gemm_copies")


def reset_counts() -> None:
    """Take the kernels' registry (``kernels/_build.COUNTS``) as it stands
    for the zero of :func:`read_counts`."""
    from repro_torch.kernels import _build

    _ZERO.clear()
    _ZERO.update(_build.COUNTS)


def read_counts() -> dict:
    """What each count of the registry, the launches and the fused update's
    copies, moved since :func:`reset_counts` (since import before the
    first)."""
    from repro_torch.kernels import _build

    return {k: v - _ZERO.get(k, 0) for k, v in _build.COUNTS.items()
            if k not in _BY_LAYOUT}


def _expect(**counts) -> dict:
    """Expected :func:`read_counts`: the given counts (by the registry's
    keys), every other at 0."""
    out = dict.fromkeys(read_counts(), 0)
    check(set(counts) <= set(out), f"no such count: {set(counts) - set(out)}")
    out.update(counts)
    return out


# -- phase 0 ------------------------------------------------------------------

def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"devices {torch.cuda.device_count()}")
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    check(nvcc.returncode == 0, f"nvcc --version failed: {nvcc.stderr}")
    log(f"[device] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return card


# -- phase 1 ------------------------------------------------------------------

# the float32 attention kernels, which must run their products on the
# tensor cores (split TF32): the forward and the backward's dK/dV and dQ
# kernels at each head dim (the backward's delta pre-pass is a row sum)
TF32_KERNELS = tuple(f"{k}<{d}>" for k in (
    "flash_tf32_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
    for d in (64, 128, 256))


def phase_build(tf32: bool = True):
    """Phase 1; ``tf32``: also hold the float32 attention kernels to the
    tensor cores (off for an earlier tree's side of an A/B)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    each = ", ".join(f"{k} {v:.2f} s" for k, v in _build.build.seconds.items())
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s (nvcc in "
        f"parallel: {each or 'already built'})")
    report = {}
    for name, rec in sorted(_build.build.ptxas.items()):
        if not name:
            continue
        short = _kernel_name(name)
        report[short] = rec
        log(f"[build] ptxas {short}: {rec.get('registers')} registers, spill "
            f"stores {rec.get('spill_stores')} / loads "
            f"{rec.get('spill_loads')} bytes, stack {rec.get('stack')} bytes"
            + "".join(f"; {w[:160]}" for w in rec["warnings"]))
    wgmma = {k: r for k, r in report.items()
             if k.startswith("flash_wgmma_kernel")}
    check(len(wgmma) == 6, f"ptxas reported the tensor-core flash kernels "
          f"{sorted(wgmma)}, expected bf16 and f16 at D 64, 128 and 256")
    for k, r in wgmma.items():
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"ptxas: {k} spills ({r.get('spill_stores')} bytes stored, "
              f"{r.get('spill_loads')} loaded)")
        check(not any("(C75" in w for w in r["warnings"]),
              f"ptxas: {k} has a serialised wgmma: {r['warnings']}")
    gemm = {k: r for k, r in report.items()
            if k.startswith("split_tf32_gemm_kernel")}
    if tf32:  # an earlier tree's side of an A/B has other ones
        check(len(gemm) == 4, f"ptxas reported the split GEMM kernels "
              f"{sorted(gemm)}, expected the four layouts of A and B")
    for k, r in gemm.items():
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"ptxas: {k} spills ({r.get('spill_stores')} bytes stored, "
              f"{r.get('spill_loads')} loaded)")
        check(not any("(C75" in w for w in r["warnings"]),
              f"ptxas: {k} has a serialised wgmma: {r['warnings']}")
    out = {"seconds": dict(_build.build.seconds), "ptxas": report}
    if tf32:
        out["tf32_mma"] = _check_tf32(lib, report)
    return out


def _check_tf32(lib, report: dict) -> dict:
    """Each of :data:`TF32_KERNELS` spills nothing (ptxas) and its SASS
    (``cuobjdump -sass`` on the built library) holds TF32 tensor-core
    instructions (``HMMA ... TF32``), so a build that stayed on the CUDA
    cores' FMAs fails; returns their count by kernel."""
    from repro_torch.kernels import _build

    for k in TF32_KERNELS:
        r = report.get(k)
        check(r is not None, f"ptxas reported no {k}: {sorted(report)}")
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"ptxas: {k} spills ({r.get('spill_stores')} bytes stored, "
              f"{r.get('spill_loads')} loaded)")
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump -sass failed: {proc.stderr}")
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
        elif name in TF32_KERNELS and "HMMA" in line and "TF32" in line:
            counts[name] = counts.get(name, 0) + 1
    for k in TF32_KERNELS:
        check(counts.get(k, 0) > 0, f"{k}: no TF32 HMMA in its SASS: its "
              f"products are not on the tensor cores")
    log("[build] TF32 HMMA instructions: " + ", ".join(
        f"{k} {counts[k]}" for k in TF32_KERNELS) + "; no spills")
    return counts


def _kernel_name(mangled: str) -> str:
    """``flash_wgmma_kernel<bf16, 256>`` from ptxas's mangled name: the
    template ``..._kernel`` whose length prefix (``17flash_tf32_kernelI``)
    spans it exactly."""
    for m in re.finditer(r"_kernelI", mangled):
        end = m.start() + len("_kernel")
        name = next((mangled[i:end] for i in range(end - 7, 0, -1)
                     if mangled[:i].endswith(str(end - i))
                     and not mangled[i].isdigit()), None)
        if name is None:
            continue
        targs = mangled[end + 1:]
        ty = ("bf16" if "bfloat16" in targs else
              "f16" if "__half" in targs else None)
        d = re.search(r"Li(\d+)E", targs)
        args = [x for x in (ty, d.group(1) if d else None) if x]
        args += re.findall(r"Lb([01])E", targs)  # split_gemm's layouts
        return f"{name}<{', '.join(args)}>"
    return mangled


# -- phase 2 ------------------------------------------------------------------

def _time_ms(fn, reps: int, batch: int) -> float:
    """Device time of one ``fn()``: CUDA events around ``batch`` back-to-back
    calls, divided by ``batch``; the median over ``reps`` such batches."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _kernel_case(shape, dtype, card: str, seed: int):
    import torch

    from repro_torch.kernels import fused_prox as fp

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    zh, g, c = (torch.randn(shape, generator=gen, device="cuda",
                            dtype=mk_dtype).to(dtype) for _ in range(3))
    # special values: NaN, -0.0, +-inf, and exactly the threshold
    specials = [float("nan"), -0.0, float("inf"), -float("inf"), THRESH,
                -THRESH, 0.0]
    k = min(len(specials), zh.shape[-1])
    zh[0, :k] = torch.tensor(specials[:k], dtype=dtype)
    g[0, :k] = 0
    c[0, :k] = 0

    k_zh, k_z = fp.fused_local_update_2d(zh, g, c, ETA, THRESH)
    p_zh, p_z = fp.fused_local_update_plain(zh, g, c, ETA, THRESH)
    torch.cuda.synchronize()
    same_zh, same_z = _bit_diff(k_zh, p_zh), _bit_diff(k_z, p_z)
    err = max(_finite_err(k_zh, p_zh), _finite_err(k_z, p_z))
    check(same_zh == 0 and same_z == 0,
          f"kernel != plain bitwise at {shape} {dtype}: "
          f"{same_zh} z_hat' and {same_z} z' elements differ")

    n = zh.numel()
    batch = 1 if n > 1e8 else 10
    ms = _time_ms(lambda: fp.fused_local_update_2d(zh, g, c, ETA, THRESH),
                  15, batch)
    plain_ms = _time_ms(
        lambda: fp.fused_local_update_plain(zh, g, c, ETA, THRESH), 15, batch)
    device_ms = _device_ms(
        lambda: fp.fused_local_update_2d(zh, g, c, ETA, THRESH))
    nbytes = 5 * n * zh.element_size()
    work = str(dtype).replace("torch.", "")
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                         OPS_PER_ELEMENT * n / PEAK_OPS[work])
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= OPS_PER_ELEMENT * n / PEAK_OPS[work] else "operations")
    row = {"shape": list(shape), "dtype": work, "bitwise_equal": True,
           "max_abs_err": err, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "GB_per_s": nbytes / (ms * 1e-3) / 1e9}
    log(f"[kernels] {tuple(shape)} {work}: bitwise equal; kernel "
        f"{ms:.4f} ms ({row['GB_per_s']:.0f} GB/s; device {device_ms:.4f} "
        f"ms), bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms"
        f"  [{card}]")
    del zh, g, c, k_zh, k_z, p_zh, p_z
    torch.cuda.empty_cache()
    return row


def phase_kernels(card: str):
    import torch

    cases = [((30, 4_194_304), torch.float32), ((30, 4_194_304), torch.bfloat16),
             ((30, 4_194_304), torch.float64), ((30, 112_395), torch.float64),
             ((30, 21), torch.float64), ((1, 21), torch.float64)]
    return [_kernel_case(shape, dt, card, seed)
            for seed, (shape, dt) in enumerate(cases)]


def _profile_kernels(fn, calls: int, sessions: int = 3) -> dict:
    """Device ms by kernel name over ``calls`` calls of ``fn`` from
    ``torch.profiler``, taken from the session (of ``sessions``) that
    recorded the most kernels: on the H100 machine a session now and then
    loses some or all of its kernel records (the same three calls profiled
    80 times over recorded 2 or 0 kernels a few times), which would read as
    less device time.
    ``_profile_kernels.records`` holds that session's record count by
    name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, best_n = {}, -1
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name, counts, n = {}, {}, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n += 1
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
                counts[e.name] = counts.get(e.name, 0) + 1
        if n > best_n:
            best, best_n = by_name, n
            _profile_kernels.records = counts
    return best


def _device_ms(fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` from ``torch.profiler``: every CUDA
    kernel's time over ``calls`` calls, divided by ``calls`` (0 when the
    profiler saw no kernel).  Unlike :func:`_time_ms` it leaves out the
    host's gaps between launches, which set the pace of back-to-back calls
    on a small plane."""
    return sum(_profile_kernels(fn, calls).values()) / calls


def _bit_diff(a, b) -> int:
    import torch

    ity = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return int((a.view(ity) != b.view(ity)).sum())


def _finite_err(a, b) -> float:
    """Largest |a - b| where the plain result ``b`` is finite."""
    import torch

    fin = torch.isfinite(b)
    return float((a.double() - b.double())[fin].abs().max()) if bool(
        fin.any()) else 0.0


def _plane_case(shape, dtype, card: str, seed: int):
    """Both plane kernels against their plain versions at one shape."""
    import torch

    from repro_torch.kernels import plane_ops as po

    gen = torch.Generator(device="cuda").manual_seed(seed)
    work = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(shape, generator=gen, device="cuda", dtype=work).to(dtype)
    u = torch.rand(shape, generator=gen, device="cuda", dtype=work).to(dtype)
    # thresholds: a real magnitude of each row, which is then exactly at
    # the threshold (kept); a negative copy of it beside; the specials
    thresh = x[:, shape[1] // 2].abs()
    k = min(len(SPECIALS), shape[1])
    x[0, :k] = torch.tensor(SPECIALS[:k], dtype=dtype)
    if shape[1] > k + 1:
        x[:, k] = -thresh
    # the quantizer gets the finite plane (a NaN would poison its row's
    # scale), +-0 kept, and one zero-scale row when there are several
    xq = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    scale = torch.amax(torch.abs(xq), dim=1)
    if shape[0] > 1:
        scale[-1] = 0

    runs = {
        "threshold_select": (lambda: po.threshold_select_2d(x, thresh),
                             lambda: po.threshold_select_plain(x, thresh)),
        "quantize": (lambda: po.quantize_2d(xq, u, scale, 255),
                     lambda: po.quantize_plain(xq, u, scale, 255)),
    }
    n = x.numel()
    item = x.element_size()
    wname = str(dtype).replace("torch.", "")
    peak = PEAK_OPS[wname]
    rows = []
    for name, (kern, plain) in runs.items():
        got, exp = kern(), plain()
        torch.cuda.synchronize()
        diff = _bit_diff(got, exp)
        check(diff == 0, f"{name} kernel != plain bitwise at {shape} "
              f"{dtype}: {diff} elements differ")
        err = _finite_err(got, exp)
        del got, exp
        batch = 1 if n > 1e8 else 10
        ms = _time_ms(kern, 15, batch)
        plain_ms = _time_ms(plain, 15, batch)
        device_ms = _device_ms(kern)
        plain_device_ms = _device_ms(plain)
        if name == "threshold_select":  # x, thresh in; out
            nbytes = 2 * n * item + shape[0] * item
        else:  # x, u, scale in; out
            nbytes = 3 * n * item + shape[0] * (8 if work == torch.float64
                                                else 4)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = PLANE_OPS[name] * n / peak
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        row = {"kernel": name, "shape": list(shape), "dtype": wname,
               "bitwise_equal": True, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "device_ms": device_ms,
               "plain_device_ms": plain_device_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "GB_per_s": nbytes / (ms * 1e-3) / 1e9}
        log(f"[kernels] {name} {tuple(shape)} {wname}: bitwise equal; "
            f"kernel {ms:.4f} ms ({row['GB_per_s']:.0f} GB/s; device "
            f"{device_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by}), "
            f"plain {plain_ms:.4f} ms (device {plain_device_ms:.4f} ms)  "
            f"[{card}]")
        rows.append(row)
    del x, u, xq
    torch.cuda.empty_cache()
    return rows


def phase_plane_kernels(card: str):
    """The plane kernels at the compressed paths' planes and at 4M wide;
    ``torch.topk`` (the k-th magnitude global top-k takes before the
    select) at the wide plane."""
    import torch

    cases = [((30, 112_512), torch.float64), ((30, 128), torch.float64),
             ((1, 112_512), torch.float64), ((30, 4_194_304), torch.float32),
             ((30, 4_194_304), torch.bfloat16),
             ((30, 4_194_304), torch.float64)]
    rows = []
    for seed, (shape, dt) in enumerate(cases):
        rows += _plane_case(shape, dt, card, 100 + seed)
    gen = torch.Generator(device="cuda").manual_seed(7)
    mag = torch.randn((30, 112_512), generator=gen, device="cuda",
                      dtype=torch.float64).abs()
    k = 11_240  # round(0.1 * 112,395)
    topk_ms = _time_ms(lambda: torch.topk(mag, k, dim=1), 15, 10)
    topk_device_ms = _device_ms(lambda: torch.topk(mag, k, dim=1))
    log(f"[kernels] torch.topk (30, 112512) float64 k={k}: {topk_ms:.4f} ms "
        f"(device {topk_device_ms:.4f} ms)  [{card}]")
    return rows, {"shape": [30, 112_512], "dtype": "float64", "k": k,
                  "ms": topk_ms, "device_ms": topk_device_ms}


# -- phase 3 ------------------------------------------------------------------

# Fig. 2's baselines (benchmarks/fig2_fullgrad.py:37-42)
FIG2_BASELINES = ("fedda", "fedmid", "fast_fedda")


def _fig2_alg(name: str, reg, tau: int, eta: float, eta_g: float):
    """DProx or one of Fig. 2's baselines at Fig. 2's step sizes."""
    from repro_torch.core import baselines
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.fed import simulator

    if name == "dprox":
        return simulator.DProxAlgorithm(reg, DProxConfig(tau=tau, eta=eta,
                                                         eta_g=eta_g))
    return {"fedda": lambda: baselines.FedDA(reg, tau, eta, eta_g),
            "fedmid": lambda: baselines.FedMid(reg, tau, eta * eta_g, 1.0),
            "fast_fedda": lambda: baselines.FastFedDA(
                reg, tau, eta0=eta * eta_g, eta_g=eta_g)}[name]()


def _fig2_run(tau: int, device: str, rounds: int, eval_every: int,
              transport=None, draws=None, alg: str = "dprox"):
    """The Fig. 2 run of ``alg``; with ``transport`` its uplink goes through
    it on the flat plane (``draws``: the engine's draw source)."""
    from repro_torch.data.synthetic import make_round_batches
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed import problems, simulator

    data, reg, grad_fn, full_g, params0, L = problems.logreg_problem(
        device=device)
    eta_g = 15.0
    eta_tilde = 0.5 / L
    eta = eta_tilde / (eta_g * tau)
    alg = _fig2_alg(alg, reg, tau, eta, eta_g)
    engine = None
    if transport is not None:
        engine = RoundEngine(alg, grad_fn, 30, EngineConfig(
            chunk_rounds=8, plane=True, transport=transport), device=device,
            draws=draws)
    return simulator.run(
        alg, params0, grad_fn,
        lambda r, rng: make_round_batches(data, tau, None, rng), 30, rounds,
        reg=reg, eta_tilde=eta_tilde, full_grad_fn=full_g,
        eval_every=eval_every, device=device, engine=engine)


def _cpu_run(fn, threads: int = 1):
    """``fn()`` with ``threads`` CPU threads (one: the small CPU reference
    runs faster so; 0: every core, for the full-width runs); the kernel
    counters must not move."""
    import torch

    before = read_counts()
    old = torch.get_num_threads()
    torch.set_num_threads(threads or os.cpu_count() or old)
    try:
        out = fn()
    finally:
        torch.set_num_threads(old)
    check(read_counts() == before, "the CPU run launched a kernel")
    return out


def _check_opt_match(tag: str, opt, ref, n_points: int) -> float:
    """Card optimality == CPU optimality at rtol 1e-6 above 1e-9; returns
    the largest relative difference."""
    check(len(opt) == len(ref) == n_points, f"{tag}: {len(opt)} eval points")
    check(all(math.isfinite(v) for v in opt), f"{tag}: non-finite")
    for i, (a, b) in enumerate(zip(opt, ref)):
        if b > 1e-9:
            check(abs(a - b) <= 1e-6 * abs(b),
                  f"{tag} eval {i}: cuda {a!r} vs cpu {b!r}")
        else:
            check(a <= 1e-9, f"{tag} eval {i}: cuda {a!r} > 1e-9")
    return max((abs(a - b) / b for a, b in zip(opt, ref) if b > 1e-9),
               default=0.0)


def phase_main_path(card: str):
    import torch

    rounds, every = 500, 25
    out = {}
    for tau in (10, 1):
        reset_counts()
        t0 = time.perf_counter()
        h = _fig2_run(tau, "cuda", rounds, every)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        launches = counts["fused_local_updates"]
        check(counts == _expect(fused_local_updates=rounds * tau),
              f"tau={tau}: launches {counts}, expected {rounds * tau} "
              "fused and no plane kernel")
        h_cpu = _cpu_run(lambda: _fig2_run(tau, "cpu", rounds, every))
        opt, ref = h.optimality, h_cpu.optimality
        max_rel = _check_opt_match(f"tau={tau}", opt, ref,
                                   rounds // every + 1)
        log(f"[main] fig2 tau={tau}: {rounds} rounds in {secs:.2f} s, "
            f"{launches} launches, final optimality {opt[-1]:.6e} "
            f"(cpu {ref[-1]:.6e}, max rel diff {max_rel:.2e})  [{card}]")
        out[f"tau{tau}"] = {"rounds": rounds, "launches": counts,
                            "seconds": secs, "final_optimality": opt[-1],
                            "final_optimality_cpu": ref[-1],
                            "max_rel_diff": max_rel}
    out["baselines"] = _fig2_baselines(card)
    out["tau1_dprox_vs_fedda"] = _tau1_dprox_is_fedda(card)
    return out


def _fig2_baselines(card: str) -> dict:
    """Fig. 2's baselines on the card and on the CPU, 200 rounds at tau 10
    and 1: optimality equal at rtol 1e-6 above 1e-9; no kernel launched
    (their prox runs through ``reg.prox``)."""
    import torch

    rounds, every = 200, 25
    out = {}
    for tau in (10, 1):
        for name in FIG2_BASELINES:
            reset_counts()
            t0 = time.perf_counter()
            h = _fig2_run(tau, "cuda", rounds, every, alg=name)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            check(counts == _expect(), f"{name} tau={tau}: launches {counts}"
                  ", expected none")
            h_cpu = _cpu_run(lambda: _fig2_run(tau, "cpu", rounds, every,
                                               alg=name))
            opt, ref = h.optimality, h_cpu.optimality
            max_rel = _check_opt_match(f"{name} tau={tau}", opt, ref,
                                       rounds // every + 1)
            log(f"[main] fig2 {name} tau={tau}: {rounds} rounds in "
                f"{secs:.2f} s, no kernel launched, final optimality "
                f"{opt[-1]:.6e} (cpu {ref[-1]:.6e}, max rel diff "
                f"{max_rel:.2e})  [{card}]")
            out[f"{name}_tau{tau}"] = {
                "rounds": rounds, "launches": counts, "seconds": secs,
                "optimality": opt, "optimality_cpu": ref,
                "max_rel_diff": max_rel}
    return out


def _tau1_dprox_is_fedda(card: str) -> dict:
    """On the card, DProx at tau = 1 (kernel 1) and FedDA (plain ops) give
    the same x_bar after 10 rounds, atol 1e-12 (the reference's
    tests/test_algorithm.py:86)."""
    import numpy as np

    from repro_torch.data.synthetic import make_round_batches
    from repro_torch.fed import problems

    data, reg, grad_fn, _, params0, L = problems.logreg_problem(
        device="cuda")
    eta_g = 15.0
    eta = 0.5 / L / eta_g
    dprox, fedda = (_fig2_alg(n, reg, 1, eta, eta_g)
                    for n in ("dprox", "fedda"))
    rf, rf_da = dprox.make_round_fn(grad_fn), fedda.make_round_fn(grad_fn)
    s, s_da = dprox.init(params0, 30), fedda.init(params0, 30)
    rng = np.random.default_rng(0)
    reset_counts()
    for _ in range(10):
        b = make_round_batches(data, 1, None, rng)
        s, _ = rf(s, b)
        s_da, _ = rf_da(s_da, b)
    counts = read_counts()
    check(counts == _expect(fused_local_updates=10),
          f"tau=1 dprox vs fedda: launches {counts}")
    gap = max(float((s.x_bar[k] - s_da.x_bar[k]).abs().max())
              for k in s.x_bar)
    check(gap <= 1e-12, f"tau=1: dprox x_bar != fedda x_bar ({gap:.3e})")
    log(f"[main] fig2 tau=1, 10 rounds on the card: dprox (kernel 1, 10 "
        f"launches) == fedda (plain ops), max |dx_bar| {gap:.3e}  [{card}]")
    return {"rounds": 10, "launches": counts, "max_abs_diff": gap}


# -- phase 5 ------------------------------------------------------------------

def phase_compressed_paper(card: str):
    """The Fig. 2 problem with a compressed uplink on the flat plane."""
    import torch

    from repro_torch.comm import GeneratorDraws, Quantize, TopK

    tau, rounds, every = 10, 200, 25
    out = {}
    for name, kernel, make in (
            ("topk", "threshold_selects",
             lambda: TopK(0.25, granularity="global")),
            ("quantize", "quantizes",
             lambda: Quantize(8, granularity="global"))):
        stochastic = name == "quantize"
        reset_counts()
        t0 = time.perf_counter()
        h = _fig2_run(tau, "cuda", rounds, every, make(),
                      GeneratorDraws(11, "cpu") if stochastic else None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        expect = _expect(fused_local_updates=rounds * tau, **{kernel: rounds})
        check(counts == expect, f"compressed {name}: launches {counts}, "
              f"expected {expect}")
        h_cpu = _cpu_run(lambda: _fig2_run(
            tau, "cpu", rounds, every, make(),
            GeneratorDraws(11, "cpu") if stochastic else None))
        opt, ref = h.optimality, h_cpu.optimality
        max_rel = _check_opt_match(f"compressed {name}", opt, ref,
                                   rounds // every + 1)
        log(f"[compressed] fig2 tau={tau} {name} (global, plane): {rounds} "
            f"rounds in {secs:.2f} s, launches {counts}, optimality "
            f"{['%.6e' % v for v in opt]} (cpu final {ref[-1]:.6e}, max rel "
            f"diff {max_rel:.2e}), {h.uplink_mbytes_per_round * 1e6:.0f} "
            f"uplink bytes/round  [{card}]")
        out[name] = {"rounds": rounds, "launches": counts, "seconds": secs,
                     "optimality": opt, "optimality_cpu": ref,
                     "max_rel_diff": max_rel,
                     "uplink_bytes_per_round": h.uplink_mbytes_per_round
                     * 1e6}
    return out


# -- phase 4 ------------------------------------------------------------------

WIDE_D, WIDE_TAU = 112_394, 10


def _wide_problem():
    """Phase 4's set-up: the Fig. 2 model and generator at d = 112,394,
    features cached on the card; DProx at tau = 10."""
    import torch

    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.exec import ArraySupplier
    from repro_torch.fed import problems, simulator

    d, tau = WIDE_D, WIDE_TAU
    # features normalized to unit max row norm shrink each coordinate, and
    # so each |df/dw_j|, by about sqrt(20/d) against the paper's d = 20; at
    # lam = 0.003 every |df/dw_j(0)| is below lam, so the first prox steps
    # leave every weight at zero and only the bias moves; lam shrinks with
    # them
    lam = 0.003 * math.sqrt(20 / d)
    t0 = time.perf_counter()
    data, reg, grad_fn, full_g, params0, L_ref = problems.logreg_problem(
        d=d, lam=lam, device="cuda")
    # the step needs L with the bias column at this width (see smoothness)
    L = problems.smoothness(data.features, "cuda", bias=True)
    supplier = ArraySupplier.from_dataset(data, tau, None, device_cache=True,
                                          device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eta_g = 15.0
    eta_tilde = 0.5 / L
    eta = eta_tilde / (eta_g * tau)
    alg = simulator.DProxAlgorithm(reg, DProxConfig(tau=tau, eta=eta,
                                                    eta_g=eta_g))
    return {"data": data, "reg": reg, "grad_fn": grad_fn, "full_g": full_g,
            "params0": params0, "L_ref": L_ref, "L": L, "lam": lam,
            "supplier": supplier, "alg": alg, "eta_g": eta_g,
            "eta_tilde": eta_tilde, "setup_s": setup_s}


def phase_wide(card: str, kernel_ms: float):
    import torch

    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed import simulator

    d, tau, rounds, every = WIDE_D, WIDE_TAU, 20, 5
    w = _wide_problem()
    data, reg, grad_fn, full_g = w["data"], w["reg"], w["grad_fn"], w["full_g"]
    params0, L_ref, L, lam = w["params0"], w["L_ref"], w["L"], w["lam"]
    supplier, alg, eta_g = w["supplier"], w["alg"], w["eta_g"]
    eta_tilde, setup_s = w["eta_tilde"], w["setup_s"]
    feat_gb = data.features.nbytes / 1e9
    log(f"[wide] d={d}: lam={lam:.6e}, set-up {setup_s:.1f} s, L={L:.6e}, features "
        f"{feat_gb:.2f} GB on the card")

    reset_counts()
    h = simulator.run(alg, params0, grad_fn, supplier, 30, rounds, reg=reg,
                      eta_tilde=eta_tilde, full_grad_fn=full_g,
                      eval_every=every, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["fused_local_updates"]
    check(counts == _expect(fused_local_updates=rounds * tau),
          f"wide: launches {counts}, expected {rounds * tau} fused only")
    opt = h.optimality
    check(all(math.isfinite(v) for v in opt), f"wide: non-finite {opt}")
    check(all(b < a for a, b in zip(opt, opt[1:])),
          f"wide: optimality not decreasing {opt}")
    log(f"[wide] tau={tau}: {rounds} rounds, {launches} launches, "
        f"optimality {['%.6e' % v for v in opt]}")

    # the two departures from the reference's set-up, measured: the gradient
    # at zero against the paper's lam, and the run with the reference's L
    # (no bias column)
    grad0 = full_g(params0)
    grad0_w = float(grad0["w"].abs().max())
    grad0_b = float(grad0["b"].abs())
    ref_eta_tilde = 0.5 / L_ref
    ref_alg = simulator.DProxAlgorithm(reg, DProxConfig(
        tau=tau, eta=ref_eta_tilde / (eta_g * tau), eta_g=eta_g))
    opt_ref_L = simulator.run(
        ref_alg, params0, grad_fn, supplier, 30, rounds, reg=reg,
        eta_tilde=ref_eta_tilde, full_grad_fn=full_g, eval_every=every,
        device="cuda").optimality
    log(f"[wide] at zero: max |df/dw_j| {grad0_w:.6e}, |df/db| {grad0_b:.6e} "
        f"(paper's lam 0.003); with the reference's L={L_ref:.6e}: "
        f"optimality {['%.6e' % v for v in opt_ref_L]}")

    eng = RoundEngine(alg, grad_fn, 30, EngineConfig(chunk_rounds=4),
                      device="cuda")
    s_per_round, round_ms, by_name = _time_and_profile(eng, params0,
                                                       supplier)
    busy_ms = sum(by_name.values())
    ours_ms = sum(v for k, v in by_name.items()
                  if any(f in k for f in _ROUND_PARTS["fused_local_update"]))
    if busy_ms > 0:
        share = ours_ms / busy_ms
        source = "torch.profiler"
    else:  # the profiler saw no device time: estimate from phase 2
        share = tau * kernel_ms / round_ms
        source = "CUDA events (phase-2 kernel time x tau / round time)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # the local step reads its leaves in place: no cat launched per step
    cats = {k[:60]: (_time_and_profile.counts[k], v)
            for k, v in by_name.items() if "cat" in k.lower()}
    check(all(n < tau for n, _ in cats.values()),
          f"wide: a cat kernel launched tau or more times a round: {cats}")
    log(f"[wide] {s_per_round:.4f} s/round after the first chunk; one round "
        f"{round_ms:.3f} ms on the card, device busy {busy_ms:.3f} ms "
        f"(idle share {1 - busy_ms / round_ms:.3f}); kernel share "
        f"{share:.4f} ({source}); cat kernels in the round (launches, ms): "
        f"{cats or 'none'}  [{card}]")
    for name, ms in top:
        log(f"[wide]   {ms:9.3f} ms  {name[:110]}")
    ctx = {"alg": alg, "reg": reg, "grad_fn": grad_fn, "full_g": full_g,
           "params0": params0, "supplier": supplier, "eta_tilde": eta_tilde}
    return {"d": d, "tau": tau, "rounds": rounds, "launches": counts,
            "optimality": opt, "setup_s": setup_s, "features_gb": feat_gb,
            "L": L, "L_reference": L_ref, "grad0_w_abs_max": grad0_w,
            "grad0_b_abs": grad0_b,
            "optimality_with_reference_L": opt_ref_L,
            "s_per_round": s_per_round, "round_ms": round_ms,
            "device_busy_ms": busy_ms, "kernel_ms_per_round": ours_ms,
            "kernel_share": share, "share_source": source,
            "cat_kernels": cats, "top_kernels_ms": top}, ctx


def _time_and_profile(eng, params0, supplier):
    """s/round of ``eng`` over 8 rounds after a warm chunk of 4, then one
    profiled round: (s/round, the round's ms on CUDA events, device ms by
    kernel name from ``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = eng.init(params0)
    state, _ = eng.run(state, supplier, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = eng.run(state, supplier, 8)
    torch.cuda.synchronize()
    s_per_round = (time.perf_counter() - t0) / 8

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        state, _ = eng.run(state, supplier, 1)
        end.record()
        torch.cuda.synchronize()
    by_name: dict = {}
    counts: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            counts[e.name] = counts.get(e.name, 0) + 1
    _time_and_profile.counts = counts
    return s_per_round, start.elapsed_time(end), by_name


# -- phase 6 ------------------------------------------------------------------

# kernel-name fragments of each part of a compressed round, for the shares
_ROUND_PARTS = {
    # (the older kernels' names too, for a run of an earlier tree)
    "fused_local_update": ("fused_leaves_kernel", "fused_prox_kernel"),
    "threshold_select": ("threshold_select_kernel",),
    "quantize": ("quantize_kernel",),
    "torch.topk": ("topk", "TopK", "sort", "Sort"),
    "weighted_commit": ("commit_bulk_kernel", "commit_scalar_kernel",
                        "weighted_commit_kernel"),
}


def phase_wide_compressed(card: str, ctx: dict):
    """Phase 4's wide set-up with the uplink compressed on the plane."""
    import torch

    from repro_torch.comm import Quantize, TopK
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed import simulator

    tau, rounds, every = 10, 20, 5
    expect_bytes = {"topk": 134_880, "quantize": 126_453}
    out = {}
    for name, kernel, make in (
            ("topk", "threshold_selects",
             lambda: TopK(0.1, granularity="global")),
            ("quantize", "quantizes",
             lambda: Quantize(8, granularity="global"))):
        def engine():
            return RoundEngine(ctx["alg"], ctx["grad_fn"], 30, EngineConfig(
                chunk_rounds=4, plane=True, transport=make()), device="cuda")

        eng = engine()
        reset_counts()
        h = simulator.run(ctx["alg"], ctx["params0"], ctx["grad_fn"],
                          ctx["supplier"], 30, rounds, reg=ctx["reg"],
                          eta_tilde=ctx["eta_tilde"],
                          full_grad_fn=ctx["full_g"], eval_every=every,
                          engine=eng)
        torch.cuda.synchronize()
        counts = read_counts()
        expect = _expect(fused_local_updates=rounds * tau, **{kernel: rounds})
        check(counts == expect, f"wide {name}: launches {counts}, expected "
              f"{expect}")
        opt = h.optimality
        check(all(math.isfinite(v) for v in opt),
              f"wide {name}: non-finite {opt}")
        up = eng.uplink_bytes_per_client_round
        check(up == expect_bytes[name],
              f"wide {name}: {up} uplink bytes/client/round, expected "
              f"{expect_bytes[name]}")

        s_per_round, round_ms, by_name = _time_and_profile(
            engine(), ctx["params0"], ctx["supplier"])
        busy_ms = sum(by_name.values())
        parts = {part: sum(v for k, v in by_name.items()
                           if any(f in k for f in frags))
                 for part, frags in _ROUND_PARTS.items()}
        shares = {part: (ms / busy_ms if busy_ms > 0 else None)
                  for part, ms in parts.items()}
        log(f"[wide-compressed] {name} (global, plane) tau={tau}: {rounds} "
            f"rounds, launches {counts}, optimality "
            f"{['%.6e' % v for v in opt]}, {up} uplink bytes/client/round "
            f"(dense 899160)  [{card}]")
        log(f"[wide-compressed] {name}: {s_per_round:.4f} s/round after the "
            f"first chunk; one round {round_ms:.3f} ms on the card, device "
            f"busy {busy_ms:.3f} ms (idle share "
            f"{1 - busy_ms / round_ms:.3f}); device ms by part "
            + ", ".join(f"{p} {parts[p]:.4f} ({shares[p] or 0:.4f})"
                        for p in parts) + f"  [{card}]")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"[wide-compressed]   {ms:9.3f} ms  {kname[:110]}")
        out[name] = {"rounds": rounds, "launches": counts, "optimality": opt,
                     "uplink_bytes_per_client_round": up,
                     "s_per_round": s_per_round, "round_ms": round_ms,
                     "device_busy_ms": busy_ms, "device_ms_by_part": parts,
                     "share_of_busy_by_part": shares}
    return out


# -- phase 2: the weighted commit ---------------------------------------------

def _commit_case(shape, dtype, card: str, seed: int, w_dtype=None,
                 offset: bool = False):
    """The commit kernel against its plain version at one shape, timed
    beside ``torch.mv(buf.t(), w)`` (the same function in one library
    call) and beside the plain-load kernel (``loads=True``, where the
    package has it; bitwise checked as well).  ``w_dtype``: the weights'
    dtype (float64 by default); ``offset``: the plane is a contiguous view
    8 bytes off a 16-byte boundary (the scalar kernel)."""
    import inspect

    import torch

    from repro_torch.kernels import plane_ops as po

    gen = torch.Generator(device="cuda").manual_seed(seed)
    work = torch.float64 if dtype == torch.float64 else torch.float32
    n = shape[0] * shape[1]
    flat = torch.randn((n + 1,), generator=gen, device="cuda",
                       dtype=work).to(dtype)
    x = (flat[1:] if offset else flat[:n]).view(shape)
    w = (torch.rand((shape[0],), generator=gen, device="cuda",
                    dtype=torch.float64) + 0.5).to(w_dtype or torch.float64)
    w[::4] = 0.0  # undelivered clients
    k = min(len(SPECIALS), shape[1])
    x[1, :k] = torch.tensor(SPECIALS[:k], dtype=dtype)
    kern = lambda: po.weighted_commit_2d(x, w)
    plain = lambda: po.weighted_commit_plain(x, w)
    got, exp = kern(), plain()
    torch.cuda.synchronize()
    diff = _bit_diff(got, exp)
    check(diff == 0, f"weighted_commit kernel != plain bitwise at {shape} "
          f"{dtype} (weights {w.dtype}): {diff} elements differ")
    check(bool(torch.isnan(got[0])), "a NaN under a nonzero weight vanished")
    err = _finite_err(got, exp)
    loads = None
    if "loads" in inspect.signature(po.weighted_commit_2d).parameters:
        loads = lambda: po.weighted_commit_2d(x, w, loads=True)
        diff = _bit_diff(loads(), exp)
        check(diff == 0, f"weighted_commit plain-load kernel != plain bitwise "
              f"at {shape} {dtype} (weights {w.dtype}): {diff} differ")
    del got, exp
    xt, wl = x.t(), w.to(dtype)
    library = lambda: torch.mv(xt, wl)
    batch = 1 if n > 1e8 else 10
    ms = _time_ms(kern, 15, batch)
    plain_ms = _time_ms(plain, 5, 1)
    library_ms = _time_ms(library, 15, batch)
    device_ms = _device_ms(kern)
    kernels_per_call = sum(_profile_kernels.records.values()) / 20
    plain_device_ms = _device_ms(plain, 5)
    library_device_ms = _device_ms(library)
    loads_ms = _time_ms(loads, 15, batch) if loads else None
    loads_device_ms = _device_ms(loads) if loads else None
    item = x.element_size()
    nbytes = n * item + shape[1] * item + shape[0] * w.element_size()
    wname = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = COMMIT_OPS * n / PEAK_OPS[wname]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    tag = str(w.dtype).replace("torch.", "") + (", offset 8 B" if offset
                                                 else "")
    row = {"kernel": "weighted_commit", "shape": list(shape), "dtype": wname,
           "weights": tag, "bitwise_equal": True, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
           "kernels_per_call": kernels_per_call,
           "plain_device_ms": plain_device_ms, "library_ms": library_ms,
           "library_device_ms": library_device_ms,
           "loads_ms": loads_ms, "loads_device_ms": loads_device_ms,
           "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes,
           "GB_per_s": nbytes / (ms * 1e-3) / 1e9}
    log(f"[kernels] weighted_commit {tuple(shape)} {wname} (weights {tag}): "
        f"bitwise equal; kernel {ms:.4f} ms (device {device_ms:.4f} ms, "
        f"{kernels_per_call:g} kernels a call, "
        f"{nbytes / (max(device_ms, 1e-9) * 1e-3) / 1e9:.0f} GB/s), bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), plain "
        f"{plain_ms:.4f} ms (device {plain_device_ms:.4f}), torch.mv "
        f"{library_ms:.4f} ms (device {library_device_ms:.4f})"
        + (f", plain loads {loads_ms:.4f} ms (device {loads_device_ms:.4f})"
           if loads else "") + f"  [{card}]")
    del x, xt, wl, flat
    torch.cuda.empty_cache()
    return row


# the commit kernel's cases: the five shapes of the record (float64
# weights), the main path's float32 weights on the two float64 planes, a
# view 8 bytes off 16 (the scalar kernel) and 300 rows (the ring walked)
COMMIT_CASES = [((30, 128), "float64", None, False),
                ((30, 112_512), "float64", None, False),
                ((30, 4_194_304), "float32", None, False),
                ((30, 4_194_304), "bfloat16", None, False),
                ((30, 4_194_304), "float64", None, False),
                ((30, 128), "float64", "float32", False),
                ((30, 112_512), "float64", "float32", False),
                ((30, 1024), "float64", "float32", True),
                ((300, 16_384), "float64", "float32", False)]


def phase_commit_kernel(card: str, cases=COMMIT_CASES):
    import torch

    dt = lambda name: getattr(torch, name) if name else None
    return [_commit_case(shape, dt(d), card, 200 + i, dt(wd), off)
            for i, (shape, d, wd, off) in enumerate(cases)]


# the Fig. 4 CNN's leaves (repro_torch.models.cnn, d = 112,394), in the
# sorted-key order the kernel's table takes them
CNN_LEAVES = {"conv1_b": (32,), "conv1_w": (3, 3, 1, 32), "conv2_b": (32,),
              "conv2_w": (3, 3, 32, 32), "fc1_b": (64,),
              "fc1_w": (7 * 7 * 32, 64), "fc2_b": (32,), "fc2_w": (64, 32),
              "fc3_b": (10,), "fc3_w": (32, 10)}
# the fused local update on the trees of the main paths, (clients, leaves,
# dtype): the paper's {w: (30, 20), b: (30,)}, the wide {w: (30, 112,394),
# b: (30,)} and the Fig. 4 CNN's 10 leaves over 10 clients
TREES = {"paper": (30, {"w": (20,), "b": ()}, "float64"),
         "wide": (30, {"w": (112_394,), "b": ()}, "float64"),
         "cnn": (10, CNN_LEAVES, "float32")}


def _tree_case(name: str, card: str, seed: int):
    """``ops.fused_local_update`` on one of ``TREES``, fed twice: contiguous
    leaves, then z_hat as views of the first call's output plane (as the
    tau loop feeds it).  Bitwise against the plain version on the
    flattened planes; per call the events ms, the device ms of every
    kernel the call launches and their number (profiler)."""
    import torch

    from repro_torch.core import plane as pln
    from repro_torch.kernels import fused_prox as fp
    from repro_torch.kernels import ops

    n_rows, leaves, dt = TREES[name]
    dtype = getattr(torch, dt)
    d = sum(math.prod(s) for s in leaves.values())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: {k: torch.randn((n_rows,) + s, generator=gen, device="cuda",
                                 dtype=torch.float64).to(dtype)
                  for k, s in leaves.items()}
    zh, g, c = mk(), mk(), mk()
    first = next(iter(leaves))
    zh[first].view(n_rows, -1)[0, :7] = torch.tensor(
        [float("nan"), -0.0, float("inf"), -float("inf"), THRESH, -THRESH,
         0.0], dtype=dtype)

    def plain(zh_):
        spec = pln.SegmentSpec.from_tree(zh_, batch_dims=1, tile=1)
        planes = [pln.flatten(spec, t) for t in (zh_, g, c)]
        a, b = fp.fused_local_update_plain(*planes, ETA, THRESH)
        return pln.unflatten(spec, a), pln.unflatten(spec, b)

    rows = []
    views = None
    for feed in ("contiguous", "views"):
        z_in = zh if feed == "contiguous" else views
        kern = lambda: ops.fused_local_update(z_in, g, c, ETA, THRESH,
                                              batch_dims=1)
        before = read_counts()
        got = kern()
        after = read_counts()
        exp = plain(z_in)
        torch.cuda.synchronize()
        for a, b in zip(got, exp):
            for k in b:
                diff = _bit_diff(a[k], b[k])
                check(diff == 0, f"fused tree {name} ({feed}) != plain "
                      f"bitwise: {diff} elements of {k} differ")
        launches = (after["fused_local_updates"]
                    - before["fused_local_updates"])
        copies = (after["fused_local_update_copies"]
                  - before["fused_local_update_copies"])
        check(copies == 0, f"fused tree {name} ({feed}): {copies} copies")
        err = max(_finite_err(a[k], b[k]) for a, b in zip(got, exp)
                  for k in b)
        if views is None:
            views = got[0]
        ms = _time_ms(kern, 15, 10)
        plain_ms = _time_ms(lambda: plain(z_in), 15, 10)
        calls = 20
        device_ms = _device_ms(kern, calls)
        records = dict(_profile_kernels.records)
        kernels_per_call = sum(records.values()) / calls
        # the same with the 50 MB L2 flushed before each call (a 128 MB
        # write): the tree's inputs are read from HBM
        flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
        cold = _profile_kernels(lambda: (flush.zero_(), kern()), calls)
        cold_ms = sum(v for k, v in cold.items()
                      if "fused_leaves_kernel" in k) / calls
        del flush
        n = n_rows * d
        nbytes = 5 * n * zh[first].element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = OPS_PER_ELEMENT * n / PEAK_OPS[dt]
        bound_ms = 1e3 * max(t_bytes, t_ops)
        row = {"tree": name, "feed": feed, "shape": [n_rows, d],
               "leaves": len(leaves), "dtype": dt, "bitwise_equal": True,
               "max_abs_err": err, "launches_per_call": launches,
               "kernels_per_call": kernels_per_call,
               "kernels": {k[:60]: v / calls for k, v in records.items()},
               "ms": ms, "device_ms": device_ms,
               "device_ms_l2_flushed": cold_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"[kernels] fused_local_update tree {name} ({n_rows} clients x "
            f"{d}, {len(leaves)} leaves, {dt}), {feed}: bitwise equal; "
            f"{ms:.4f} ms a call "
            f"(device {device_ms:.4f} ms in {kernels_per_call:g} kernels: "
            + ", ".join(f"{k[:40]} x{v / calls:g}" for k, v in
                        records.items())
            + f"; {cold_ms:.4f} ms with the L2 flushed), bound "
            f"{bound_ms:.6f} ms, plain {plain_ms:.4f} ms  "
            f"[{card}]")
        rows.append(row)
    return rows


def phase_tree_kernel(card: str):
    """Kernel 1 on the main paths' trees: one launch a call, and the
    profiler sees the fused kernel and nothing else (at most one kernel a
    call: a profiler session now and then drops a record, see
    ``_profile_kernels``)."""
    rows = [r for i, name in enumerate(TREES)
            for r in _tree_case(name, card, 300 + i)]
    for r in rows:
        check(r["launches_per_call"] == 1 and 0 < r["kernels_per_call"] <= 1
              and all("fused_leaves_kernel" in k for k in r["kernels"]),
              f"fused tree {r['tree']} ({r['feed']}): "
              f"{r['launches_per_call']} launches, kernels a call "
              f"{r['kernels']}, expected the fused kernel once")
    return rows


def _per_call_us(fn, calls: int = 10_000) -> float:
    """Host microseconds per ``fn()`` over ``calls`` back-to-back calls
    (synchronised every 1,000, outside the clock's sum)."""
    import torch

    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // 1000):
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e6 * total / calls


def phase_host_parts(card: str):
    """The host cost of a wrapper call by parts, at the paper's shapes:
    each piece alone over 10,000 calls.  The old launch path's pieces (a
    device context, a Stream object, the weights' cast launch) beside the
    new one's (the raw stream handle of the current card)."""
    import torch

    from repro_torch.core import plane as pln
    from repro_torch.kernels import _build, fused_prox as fp, ops
    from repro_torch.kernels import plane_ops as po
    from repro_torch.utils import tree as tu

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn(30, 128, dtype=torch.float64, device=dev)
    w = torch.rand(30, dtype=torch.float32, device=dev)
    out = torch.empty(128, dtype=torch.float64, device=dev)
    lib = _build.load_library()
    stream = _build.stream_handle(dev.index)
    tree = {"w": torch.randn(30, 20, dtype=torch.float64, device=dev),
            "b": torch.randn(30, dtype=torch.float64, device=dev)}
    spec = pln.SegmentSpec.from_tree(tree, batch_dims=1, tile=1)
    plane = pln.flatten(spec, tree)

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "checks (commit)": lambda: (po._check_plane("weighted_commit", x, w),
                                    po._check_rows("weighted_commit", x, w)),
        "torch.empty": lambda: torch.empty((128,), dtype=torch.float64,
                                           device=dev),
        "old: w.to(float64).contiguous() (a cast launch)":
            lambda: w.to(torch.float64).contiguous(),
        "old: with torch.cuda.device(dev)": context,
        "old: torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "new: current_device() + raw stream handle":
            lambda: (torch.cuda.current_device(),
                     _build.stream_handle(dev.index)),
        "ctypes call (the commit's launch)":
            lambda: lib.repro_weighted_commit(
                1, 0, x.data_ptr(), w.data_ptr(), out.data_ptr(), 30, 128,
                128, stream),
        "new: weighted_commit_2d, whole": lambda: po.weighted_commit_2d(x, w),
        "tree: tu.tree_flatten (one tree)": lambda: tu.tree_flatten(tree),
        "tree: pln.flatten (one tree, a cat launch; the old path made 3)":
            lambda: pln.flatten(spec, tree),
        "tree: pln.unflatten (one plane)": lambda: pln.unflatten(spec, plane),
        "new: ops.fused_local_update paper tree, whole":
            lambda: ops.fused_local_update(tree, tree, tree, ETA, THRESH,
                                           batch_dims=1),
    }
    us = {}
    for name, fn in parts.items():
        us[name] = _per_call_us(fn)
        log(f"[host] {name}: {us[name]:.2f} us a call  [{card}]")
    return us


# -- phase 7 ------------------------------------------------------------------

def _async_config(plane: bool):
    """Quickstart (a) (``examples/quickstart.py:100-104``) or, with
    ``plane``, (b) (``:191-198``)."""
    from repro_torch.comm import TopK
    from repro_torch.exec import EngineConfig
    from repro_torch.sched import Staleness, StragglerClock

    kw = dict(chunk_rounds=16, clock=StragglerClock(slowdown=4.0),
              buffer_size=15, staleness=Staleness("poly", correct=True))
    if plane:
        kw.update(plane=True, transport=TopK(ratio=0.25),
                  downlink=TopK(ratio=0.25), queue_depth=2)
    return EngineConfig(**kw)


def _async_paper_run(device: str, plane: bool, commits: int, every: int):
    """(relative optimality per eval point, metrics per commit)."""
    import numpy as np

    from repro_torch.comm import GeneratorDraws
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.core.metrics import prox_gradient_norm
    from repro_torch.data.synthetic import make_round_batches
    from repro_torch.exec import RoundEngine
    from repro_torch.fed import problems, simulator

    tau = 10
    data, reg, grad_fn, full_g, params0, L = problems.logreg_problem(
        device=device)
    eta_g, eta_tilde = 15.0, 0.5 / L
    alg = simulator.DProxAlgorithm(reg, DProxConfig(
        tau=tau, eta=eta_tilde / (eta_g * tau), eta_g=eta_g))
    eng = RoundEngine(alg, grad_fn, 30, _async_config(plane), device=device,
                      clock_draws=GeneratorDraws(21, "cpu"),
                      draws=GeneratorDraws(22, "cpu"))
    state = eng.init(params0)
    rng = np.random.default_rng(0)
    opt, metrics, g0 = [], {}, None
    for r0 in range(0, commits + 1, every):
        g = float(prox_gradient_norm(reg, full_g, eng.global_params(state),
                                     eta_tilde))
        g0 = g if g0 is None else g0
        opt.append(g / g0)
        if r0 == commits:
            break
        state, m = eng.run(state, lambda r, g_: make_round_batches(
            data, tau, None, g_), every, rng=rng, start_round=r0)
        for k, v in m.items():
            metrics.setdefault(k, []).extend(v)
    return opt, metrics


def phase_async_paper(card: str):
    import numpy as np
    import torch

    commits, every, tau = 200, 25, 10
    out = {}
    for name, plane in (("a", False), ("b", True)):
        reset_counts()
        t0 = time.perf_counter()
        opt, m = _async_paper_run("cuda", plane, commits, every)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        # (b): the uplink's and the downlink's top-k select the 20-wide w
        # leaf each commit (the 1-wide bias keeps its one coordinate)
        expect = (_expect(fused_local_updates=commits * tau,
                          threshold_selects=2 * commits,
                          weighted_commits=commits) if plane
                  else _expect(fused_local_updates=commits * tau))
        check(counts == expect, f"async ({name}): launches {counts}, "
              f"expected {expect}")
        opt_cpu, m_cpu = _cpu_run(lambda: _async_paper_run(
            "cpu", plane, commits, every))
        max_rel = _check_opt_match(f"async ({name})", opt, opt_cpu,
                                   commits // every + 1)
        hist = np.stack(m["report_age_hist"])
        check(np.array_equal(hist, np.stack(m_cpu["report_age_hist"])),
              f"async ({name}): the age histograms differ from the CPU's")
        for k in ("staleness_mean", "staleness_max"):
            check(m[k] == m_cpu[k], f"async ({name}): {k} differs from the "
                  "CPU's")
        vt = max(abs(a - b) / b for a, b in zip(m["vtime"], m_cpu["vtime"]))
        check(vt <= 1e-6, f"async ({name}): vtime differs by {vt:.3e}")
        log(f"[async] fig2 ({name}) {'plane, top-k up+down, queue 2' if plane else 'per-leaf, dense'}: "
            f"{commits} commits in {secs:.2f} s, launches {counts}, "
            f"optimality {['%.6e' % v for v in opt]} (cpu final "
            f"{opt_cpu[-1]:.6e}, max rel diff {max_rel:.2e}), mean age "
            f"{np.mean(m['staleness_mean']):.3f}, max age "
            f"{max(m['staleness_max']):.0f}, vtime {m['vtime'][-1]:.2f} "
            f"(max rel diff to cpu {vt:.2e})  [{card}]")
        out[name] = {"commits": commits, "launches": counts,
                     "seconds": secs, "optimality": opt,
                     "optimality_cpu": opt_cpu, "max_rel_diff": max_rel,
                     "mean_age": float(np.mean(m["staleness_mean"])),
                     "max_age": max(m["staleness_max"]),
                     "vtime": m["vtime"][-1], "vtime_max_rel_diff": vt,
                     "age_hist_total": hist.sum(axis=0).tolist()}
    return out


# -- phase 8 ------------------------------------------------------------------

def phase_wide_async(card: str, ctx: dict):
    """Phase 4's wide set-up under asynchrony on the plane."""
    import numpy as np
    import torch

    from repro_torch.comm import TopK
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed import simulator
    from repro_torch.sched import Staleness, StragglerClock

    tau, commits, every = 10, 20, 5

    def engine():
        return RoundEngine(ctx["alg"], ctx["grad_fn"], 30, EngineConfig(
            chunk_rounds=4, plane=True, transport=TopK(0.1,
                                                       granularity="global"),
            clock=StragglerClock(slowdown=4.0), buffer_size=15,
            staleness=Staleness("poly", correct=True), queue_depth=2),
            device="cuda")

    eng = engine()
    reset_counts()
    h = simulator.run(ctx["alg"], ctx["params0"], ctx["grad_fn"],
                      ctx["supplier"], 30, commits, reg=ctx["reg"],
                      eta_tilde=ctx["eta_tilde"], full_grad_fn=ctx["full_g"],
                      eval_every=every, engine=eng)
    torch.cuda.synchronize()
    counts = read_counts()
    expect = _expect(fused_local_updates=commits * tau,
                     threshold_selects=commits, weighted_commits=commits)
    check(counts == expect, f"wide async: launches {counts}, expected "
          f"{expect}")
    opt = h.optimality
    check(all(math.isfinite(v) for v in opt), f"wide async: non-finite {opt}")
    sd = eng._sched_state
    mean_age = float(sd.last_age.float().mean())

    s_per_commit, commit_ms, by_name = _time_and_profile(
        engine(), ctx["params0"], ctx["supplier"])
    busy_ms = sum(by_name.values())
    parts = {part: sum(v for k, v in by_name.items()
                       if any(f in k for f in frags))
             for part, frags in _ROUND_PARTS.items()}
    shares = {part: (ms / busy_ms if busy_ms > 0 else None)
              for part, ms in parts.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[wide-async] d=112,394 plane, top-k 10% global, stragglers 4x, "
        f"buffer 15/30, poly+correct, queue 2: {commits} commits, launches "
        f"{counts}, optimality {['%.6e' % v for v in opt]}, mean last age "
        f"{mean_age:.2f}  [{card}]")
    log(f"[wide-async] {s_per_commit:.4f} s/commit after the first chunk; "
        f"one commit {commit_ms:.3f} ms on the card, device busy "
        f"{busy_ms:.3f} ms (idle share {1 - busy_ms / commit_ms:.3f}); "
        "device ms by part "
        + ", ".join(f"{p} {parts[p]:.4f} ({shares[p] or 0:.4f})"
                    for p in parts) + f"  [{card}]")
    for kname, ms in top:
        log(f"[wide-async]   {ms:9.3f} ms  {kname[:110]}")
    return {"commits": commits, "launches": counts, "optimality": opt,
            "s_per_commit": s_per_commit, "commit_ms": commit_ms,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / commit_ms,
            "device_ms_by_part": parts, "share_of_busy_by_part": shares,
            "top_kernels_ms": top, "mean_last_age": mean_age}


# -- phase 9 ------------------------------------------------------------------

def _cohort_run(device: str, rounds: int):
    import numpy as np

    from repro_torch.comm import TopK
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.data.synthetic import make_round_batches
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed import problems, simulator

    tau, population, cohort = 10, 3000, 30
    data, reg, grad_fn, full_g, params0, L = problems.logreg_problem(
        device=device)
    eta_g, eta_tilde = 15.0, 0.5 / L
    alg = simulator.DProxAlgorithm(reg, DProxConfig(
        tau=tau, eta=eta_tilde / (eta_g * tau), eta_g=eta_g))

    def batches(r, rng, *, client_ids=None):
        ids = (np.arange(population) if client_ids is None
               else np.asarray(client_ids))
        full = make_round_batches(data, tau, None, rng)
        return {k: np.asarray(v)[ids % 30] for k, v in full.items()}

    eng = RoundEngine(alg, grad_fn, population, EngineConfig(
        chunk_rounds=16, population=population, cohort=cohort,
        transport=TopK(ratio=0.25)), device=device)
    state, m = eng.run(eng.init(params0), batches, rounds, seed=0)
    store = eng.population_store
    return m["train_loss"], store.touched, store.nbytes


def phase_cohort(card: str):
    import torch

    rounds, tau = 200, 10
    reset_counts()
    t0 = time.perf_counter()
    loss, touched, nbytes = _cohort_run("cuda", rounds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    check(counts == _expect(fused_local_updates=rounds * tau,
                            threshold_selects=rounds),
          f"cohort: launches {counts}")
    loss_cpu, touched_cpu, _ = _cpu_run(lambda: _cohort_run("cpu", rounds))
    check(abs(loss[-1] - loss_cpu[-1]) <= 1e-6 * abs(loss_cpu[-1]),
          f"cohort: final loss {loss[-1]!r} vs cpu {loss_cpu[-1]!r}")
    check(touched == touched_cpu, f"cohort: store touched {touched} vs cpu "
          f"{touched_cpu}")
    log(f"[cohort] population 3000, cohort 30, top-k 25%: {rounds} rounds in "
        f"{secs:.2f} s, launches {counts}, final loss {loss[-1]:.6f} (cpu "
        f"{loss_cpu[-1]:.6f}), store {touched}/3000 rows, "
        f"{nbytes / 1e3:.0f} KB host  [{card}]")
    return {"rounds": rounds, "launches": counts, "seconds": secs,
            "final_loss": loss[-1], "final_loss_cpu": loss_cpu[-1],
            "touched": touched, "store_bytes": nbytes}


# -- phase 13 -----------------------------------------------------------------

# Fig. 4 (benchmarks/fig4_cnn.py, tests/test_paper_experiments.py:43-65):
# L1 lam 1e-4, eta 0.005, minibatches of 10, 10 clients
FIG4_LAM, FIG4_ETA, FIG4_B, FIG4_CLIENTS = 1e-4, 0.005, 10, 10
# card vs CPU: max |dx_bar| / max |x_bar| after 2 rounds; measured on an
# H100 80GB HBM3 (700 W): 7.4e-8 (DProx) and 3.7e-8 (FedDA)
FIG4_GAP = 1e-6
# (b) the reference test's (n_train, n_test, rounds); (c) fig4_cnn.py's
# non-QUICK (n_train, n_test, rounds, eval every)
FIG4_GATE = (3000, 800, 40)
FIG4_FULL = (12_000, 2_500, 150, 15)


def _fig4_data(n_train: int, n_test: int):
    from repro_torch.data import mnist_like

    tx, ty, sx, sy = mnist_like.generate(n_train=n_train, n_test=n_test,
                                         seed=0)
    return mnist_like.heterogeneous_split(tx, ty, sx, sy,
                                          n_clients=FIG4_CLIENTS)


def _fig4_engine(name: str, data, tau: int, eta_g: float, device: str,
                 chunk_rounds: int = 1):
    """DProx or FedDA on the CNN at Fig. 4's settings: (engine, params0 on
    ``device`` -- built on the CPU from seed 0 and copied --, supplier)."""
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.core.baselines import FedDA
    from repro_torch.core.prox import L1
    from repro_torch.data import mnist_like
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed import simulator
    from repro_torch.models import cnn

    reg = L1(lam=FIG4_LAM)
    alg = (simulator.DProxAlgorithm(reg, DProxConfig(tau=tau, eta=FIG4_ETA,
                                                     eta_g=eta_g))
           if name == "dprox" else FedDA(reg, tau, FIG4_ETA, eta_g))
    params0 = {k: v.to(device) for k, v in
               cnn.init_params(0, device="cpu").items()}
    eng = RoundEngine(alg, cnn.make_grad_fn(), FIG4_CLIENTS,
                      EngineConfig(chunk_rounds=chunk_rounds), device=device)
    supplier = (lambda r, rng: mnist_like.sample_round_batches(
        data, tau, FIG4_B, rng))
    return eng, params0, supplier


def _fig4_run(name: str, data, tau: int, eta_g: float, rounds: int,
              every: int):
    """Fig. 4 through ``simulator.run`` on the card with the test accuracy
    as ``eval_fn``: (history, seconds, launch counts)."""
    import torch

    from repro_torch.fed import simulator
    from repro_torch.models import cnn

    eng, params0, supplier = _fig4_engine(name, data, tau, eta_g, "cuda")
    test_x = torch.as_tensor(data.test_x, device="cuda")
    test_y = torch.as_tensor(data.test_y, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    h = simulator.run(eng.algorithm, params0, eng.grad_fn, supplier,
                      FIG4_CLIENTS, rounds, eval_every=every, engine=eng,
                      eval_fn=lambda p: {"test_acc": cnn.accuracy(
                          p, test_x, test_y)})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    launches = rounds * tau if name == "dprox" else 0
    check(counts == _expect(fused_local_updates=launches),
          f"fig4 {name} tau={tau}: launches {counts}, expected {launches} "
          "of kernel 1 and no copy")
    acc = h.extra["test_acc"]
    check(len(acc) == rounds // every + 1
          and all(math.isfinite(a) for a in acc + h.loss),
          f"fig4 {name} tau={tau}: accuracies {acc}")
    return h, secs, counts


def _fig4_card_vs_cpu(card: str, data) -> dict:
    """(a) DProx and FedDA, tau 5, eta_g 1.5, 2 rounds on the card and on
    the CPU port: x_bar within FIG4_GAP; the convolutions run without TF32
    (asserted, with the TF32 logits' gap beside for the record)."""
    import contextlib

    import torch

    from repro_torch.models import cnn

    with cnn.full_fp32():
        check(not torch.backends.cudnn.allow_tf32
              and torch.get_float32_matmul_precision() == "highest",
              "fig4: TF32 is on inside cnn.full_fp32")
    check(torch.backends.cudnn.allow_tf32,
          "fig4: cnn.full_fp32 did not restore cuDNN's TF32 setting")
    out = {"runs": {}}
    for name in ("dprox", "fedda"):
        states = {}
        for device in ("cuda", "cpu"):
            def run(device=device):
                eng, params0, supplier = _fig4_engine(name, data, 5, 1.5,
                                                      device)
                return eng.run(eng.init(params0), supplier, 2, seed=0)[0]

            reset_counts()
            states[device] = (run() if device == "cuda" else _cpu_run(run))
            if device == "cuda":
                launches = 10 if name == "dprox" else 0
                counts = read_counts()
                check(counts == _expect(fused_local_updates=launches),
                      f"fig4 (a) {name}: launches {counts}")
        xb, xb_cpu = states["cuda"].x_bar, states["cpu"].x_bar
        gap = (max(float((xb[k].cpu() - xb_cpu[k]).abs().max()) for k in xb)
               / max(float(xb_cpu[k].abs().max()) for k in xb))
        check(gap <= FIG4_GAP, f"fig4 (a) {name}: card vs cpu x_bar gap "
              f"{gap:.3e} > {FIG4_GAP}")
        out["runs"][name] = {"rel_gap": gap, "launches": counts}
        log(f"[fig4] (a) {name} tau=5, 2 rounds: card vs cpu max |dx_bar| / "
            f"max |x_bar| = {gap:.3e} (limit {FIG4_GAP})  [{card}]")
    # the record: the first-layer logits with TF32 allowed, against the CPU
    params = cnn.init_params(0, device="cpu")
    x = torch.as_tensor(data.test_x[:500])
    exp = cnn.forward(params, x)
    card_params = {k: v.cuda() for k, v in params.items()}
    got = cnn.forward(card_params, x.cuda()).cpu()
    real = cnn.full_fp32
    cnn.full_fp32 = contextlib.nullcontext  # TF32 as PyTorch leaves it
    try:
        got_tf32 = cnn.forward(card_params, x.cuda()).cpu()
    finally:
        cnn.full_fp32 = real
    scale = float(exp.abs().max())
    out["logits_gap"] = float((got - exp).abs().max()) / scale
    out["logits_gap_tf32"] = float((got_tf32 - exp).abs().max()) / scale
    check(out["logits_gap"] <= 1e-5, f"fig4: card logits off the cpu's by "
          f"{out['logits_gap']:.3e} of max |logit|")
    log(f"[fig4] (a) logits of 500 test images, card vs cpu: "
        f"{out['logits_gap']:.3e} of max |logit| without TF32, "
        f"{out['logits_gap_tf32']:.3e} with PyTorch's default TF32  [{card}]")
    return out


def phase_fig4(card: str) -> dict:
    """Phase 13: Fig. 4 on the card (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n_train, n_test, gate_rounds = FIG4_GATE
    t0 = time.perf_counter()
    small = _fig4_data(n_train, n_test)
    log(f"[fig4] mnist-like {n_train} / {n_test} in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {"card_vs_cpu": _fig4_card_vs_cpu(card, small)}

    # (b) the reference test's gate (tests/test_paper_experiments.py:43-65)
    acc = {}
    out["gate"] = {}
    for name in ("dprox", "fedda"):
        h, secs, counts = _fig4_run(name, small, 5, 1.5, gate_rounds,
                                    gate_rounds)
        acc[name] = h.extra["test_acc"][-1]
        out["gate"][name] = {"test_acc": h.extra["test_acc"],
                             "seconds": secs, "launches": counts}
        log(f"[fig4] (b) {name} tau=5, {gate_rounds} rounds: test accuracy "
            f"{acc[name]:.4f}, {secs / gate_rounds:.4f} s/round, launches "
            f"{counts['fused_local_updates']}  [{card}]")
    check(acc["dprox"] > 0.7, f"fig4 (b): the CNN failed to learn "
          f"(acc {acc['dprox']})")
    check(acc["dprox"] >= acc["fedda"] - 0.02,
          f"fig4 (b): dprox {acc['dprox']} < fedda {acc['fedda']} - 0.02")

    # (c) Fig. 4 in full (benchmarks/fig4_cnn.py, non-QUICK)
    n_train, n_test, rounds, every = FIG4_FULL
    eta_g = 1.0
    t0 = time.perf_counter()
    full = _fig4_data(n_train, n_test)
    log(f"[fig4] mnist-like {n_train} / {n_test} in "
        f"{time.perf_counter() - t0:.2f} s")
    out["full"] = {}
    for tau in (5, 10):
        for name in ("dprox", "fedda"):
            h, secs, counts = _fig4_run(name, full, tau, eta_g, rounds, every)
            accs = h.extra["test_acc"]
            out["full"][f"{name}_tau{tau}"] = {
                "test_acc": accs, "rounds": h.rounds, "final": accs[-1],
                "best": max(accs), "s_per_round": secs / rounds,
                "launches": counts}
            log(f"[fig4] (c) {name} tau={tau}: {rounds} rounds, final test "
                f"accuracy {accs[-1]:.4f}, best {max(accs):.4f}, "
                f"{secs / rounds:.4f} s/round ({len(accs)} evals included), "
                f"kernel 1 "
                f"x{counts['fused_local_updates']}  [{card}]")

    # (d) one profiled DProx round (tau 10)
    eng, params0, supplier = _fig4_engine("dprox", full, 10, eta_g, "cuda",
                                          chunk_rounds=4)
    s_round, round_ms, by_name = _time_and_profile(eng, params0, supplier)
    busy = sum(by_name.values())
    ours = sum(v for k, v in by_name.items()
               if any(f in k for f in _ROUND_PARTS["fused_local_update"]))
    n_ours = sum(n for k, n in _time_and_profile.counts.items()
                 if any(f in k for f in _ROUND_PARTS["fused_local_update"]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["profile"] = {"tau": 10, "s_per_round": s_round,
                      "round_ms": round_ms, "device_busy_ms": busy,
                      "idle_share": (1 - busy / round_ms) if busy else None,
                      "kernel_ms": ours,
                      "kernel_share": ours / busy if busy else None,
                      "kernel_launches": n_ours, "top_kernels_ms": top}
    log(f"[fig4] (d) dprox tau=10: {s_round:.4f} s/round after a warm "
        f"chunk; one round {round_ms:.3f} ms, device busy {busy:.3f} ms "
        f"(idle share {1 - busy / round_ms:.3f}), kernel 1 {ours:.4f} ms in "
        f"{n_ours} launches (share of busy "
        f"{ours / busy if busy else float('nan'):.4f})  [{card}]")
    for name, ms in top:
        log(f"[fig4]   {ms:9.3f} ms x{_time_and_profile.counts[name]:4d}  "
            f"{name[:100]}")
    return out


# -- phase 14 -----------------------------------------------------------------

RT_D = 112_394


def _rt_args(**kw):
    """Phase 14's runtime set-up: the Fig. 2 model and generator at phase 4's
    width (n 30, m 100, d = 112,394, float64), tau 10, 20 rounds in chunks of
    4, phase 4's lam; the runtime's own eta 0.05 and eta_g 2."""
    from repro_torch.fed.runtime import RuntimeArgs

    base = dict(clients=30, m=100, dim=RT_D, tau=10, rounds=20, chunk=4,
                lam=0.003 * math.sqrt(20 / RT_D), workers=1, timeout=120.0,
                device="cuda")
    base.update(kw)
    return RuntimeArgs(**base)


def _rt_expect(a) -> dict:
    """Rank 0's launches: kernel 1 once a local step, and per round the
    transport's kernel once per message leaf it compresses (w is (n, d), b
    is (n,); top-k keeps a width-1 leaf whole without a launch)."""
    from repro_torch.comm.transport import _k_of

    widths = (a.dim, 1)
    exp = {"fused_local_updates": a.rounds * a.tau}
    if a.transport == "topk":
        exp["threshold_selects"] = a.rounds * sum(_k_of(a.ratio, w) < w
                                                 for w in widths)
    elif a.transport == "quantize":
        exp["quantizes"] = a.rounds * len(widths)
    return _expect(**exp)


def _rt_run(tag: str, a, card: str, parity: bool = True) -> dict:
    """One ``run_pair`` (server subprocess, rank 0 here): counts read just
    after it, the server's fields against ``run_local`` on the card, the
    trace (if any) validated and attributed."""
    import dataclasses

    import numpy as np

    from repro_torch.fed import runtime as rt
    from repro_torch.obs import report, trace

    reset_counts()
    t0 = time.perf_counter()
    rep = rt.run_pair(a)
    pair_s = time.perf_counter() - t0
    counts = read_counts()
    res = rep["server_result"]
    loss = rep["metrics"]["train_loss"]
    check(all(math.isfinite(v) for v in loss), f"runtime {tag}: loss {loss}")
    check(all(np.all(np.isfinite(np.asarray(v)))
              for v in res["fields"]["x_bar"].values()),
          f"runtime {tag}: non-finite server fields")
    out = {"args": {k: v for k, v in dataclasses.asdict(a).items()
                    if k not in ("host", "port")},
           "launches": counts, "pair_s": pair_s, "wall_s": rep["wall_s"],
           "send_wait_s": rep["send_wait_s"],
           "sender_busy_s": rep["sender_busy_s"],
           "bytes_sent": rep["bytes_sent"], "chunks": rep["chunks"],
           "encoding": rep["encoding"],
           "max_replay_drift": res["max_replay_drift"],
           "version": res["version"], "ledger": res["ledger"],
           "final_loss": loss[-1]}
    if parity:
        check(counts == _rt_expect(a),
              f"runtime {tag}: rank 0 launches {counts}, expected "
              f"{_rt_expect(a)}")
        local = rt.run_local(dataclasses.replace(a, port=0, trace=None))
        out["bitwise_vs_local"] = rt._fields_bitwise(local["fields"],
                                                     res["fields"])
        out["local_wall_s"] = local["wall_s"]
        check(out["bitwise_vs_local"],
              f"runtime {tag}: server fields differ from run_local on the "
              "card")
        check(res["max_replay_drift"] <= 1e-12,
              f"runtime {tag}: replay drift {res['max_replay_drift']}")
    hidden = "not traced"
    if a.trace:
        doc = json.loads(Path(a.trace).read_text())
        errs = trace.validate_chrome(doc)
        check(errs == [], f"runtime {tag}: invalid merged trace {errs[:3]}")
        steady = report.overlap_report(doc)["steady"]
        out["trace_events"] = len(doc["traceEvents"])
        out["steady"] = steady
        out["hidden_fraction"] = report.hidden_fraction(doc)
        hidden = (f"hidden fraction {out['hidden_fraction']:.3f} (steady: "
                  f"compute {steady['compute_s']:.3f} s, wire "
                  f"{steady['wire_s']:.3f} s, wall {steady['wall_s']:.3f} s)")
    log(f"[runtime] {tag}: {a.rounds} rounds, wall {rep['wall_s']:.3f} s "
        f"(pair incl. server start {pair_s:.1f} s), {rep['bytes_sent']} B in "
        f"{rep['chunks']} chunks ({rep['encoding']}), send_wait "
        f"{rep['send_wait_s']:.3f} s, sender_busy {rep['sender_busy_s']:.3f} "
        f"s, drift {res['max_replay_drift']:.3e}, "
        + (f"bitwise == run_local (wall {out['local_wall_s']:.3f} s), "
           if parity else "")
        + f"launches {counts}; {hidden}  [{card}]")
    return out


def _rt_checkpoint(card: str) -> dict:
    """(d): a device state after 4 rounds, saved and restored to the card
    through a meta template, every leaf bitwise."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.fed import runtime as rt
    from repro_torch.utils import tree as tu

    a = _rt_args(rounds=4)
    reset_counts()
    eng, alg, _, data, params0 = rt._engine(a, a.clients)
    state, _ = eng.run(eng.init(params0), rt._supplier(a, data, 0, a.clients),
                       a.rounds)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == _expect(fused_local_updates=a.rounds * a.tau),
          f"runtime ckpt: launches {counts}")
    path = ROOT / "build" / "runtime_state.npz"
    t0 = time.perf_counter()
    ckpt.save(state, path, metadata={"round": a.rounds})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt.restore(path, tu.tree_map(lambda t: t.to("meta"), state),
                        device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    nbytes = path.stat().st_size
    path.unlink()
    leaves, got = tu.tree_leaves(state), tu.tree_leaves(back)
    check(type(back) is type(state) and len(leaves) == len(got)
          and all(g.device.type == "cuda" and g.dtype == x.dtype
                  and g.shape == x.shape and _bit_diff(g, x) == 0
                  for g, x in zip(got, leaves)),
          "runtime ckpt: the restored state differs from the saved one")
    log(f"[runtime] checkpoint: DProxState at d={a.dim} ({nbytes / 1e6:.1f} "
        f"MB npz) saved in {save_s:.2f} s, restored to the card in "
        f"{restore_s:.2f} s, bitwise  [{card}]")
    return {"launches": counts, "npz_bytes": nbytes, "save_s": save_s,
            "restore_s": restore_s}


def phase_runtime(card: str) -> dict:
    """Phase 14: the multi-process runtime on the card (see the module
    docstring)."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    runs = {}
    for mode in ("blocking", "overlapped"):
        runs[f"dense_{mode}"] = _rt_run(
            f"dense {mode}", _rt_args(
                mode=mode, trace=str(out_dir / f"runtime_{mode}.json")),
            card)
    runs["topk_plane"] = _rt_run(
        "plane top-k 0.1", _rt_args(plane=True, transport="topk",
                                    ratio=0.1), card)
    runs["quantize"] = _rt_run(
        "quantize 8 bits", _rt_args(transport="quantize", bits=8), card)
    # (b) the replica subprocess exits non-zero unless its reconstruction
    # is bitwise the server's final fields (run_pair raises then); the
    # server's commit log counts both workers' chunks
    two_d = 4096
    jsonl = out_dir / "runtime_two_workers.jsonl"
    jsonl.unlink(missing_ok=True)
    two_a = _rt_args(dim=two_d, lam=0.003 * math.sqrt(20 / two_d),
                     workers=2, replicas=1, mode="overlapped",
                     metrics_jsonl=str(jsonl))
    two = _rt_run(f"two workers + a replica (d={two_d})", two_a, card,
                  parity=False)
    commits = [json.loads(line) for line in jsonl.read_text().splitlines()]
    commits = [c for c in commits if c["event"] == "commit"]
    per_worker = {w: sum(c["worker"] == w for c in commits) for w in (0, 1)}
    chunks = -(-two_a.rounds // two_a.chunk)
    check(per_worker == {0: chunks, 1: chunks}, f"runtime two workers: "
          f"server commits per worker {per_worker}, expected {chunks} each")
    check(two["launches"] == _expect(
        fused_local_updates=two_a.rounds * two_a.tau),
          f"runtime two workers: rank 0 launches {two['launches']}")
    two["server_commits_per_worker"] = per_worker
    runs["two_workers"] = two
    ckpt_rec = _rt_checkpoint(card)
    secs = time.perf_counter() - t0
    b, o = runs["dense_blocking"], runs["dense_overlapped"]
    log(f"[runtime] dense, wall blocking {b['wall_s']:.3f} s / overlapped "
        f"{o['wall_s']:.3f} s; send_wait {b['send_wait_s']:.3f} / "
        f"{o['send_wait_s']:.3f} s; hidden {b['hidden_fraction']:.3f} / "
        f"{o['hidden_fraction']:.3f}; phase {secs:.1f} s  [{card}]")
    return {"runs": runs, "checkpoint": ckpt_rec, "seconds": secs}


# -- phase 10 -----------------------------------------------------------------

# phase 10's shapes: gemma2-9b prefill (global and local layers, a ragged
# S), mistral-nemo, stablelm in float32 (serving's and, last, training's
# shape: 4 clients x batch 4 folded into B), a non-causal case
FLASH_CASES = [
    dict(b=1, s=4608, h=16, kh=8, d=256, dtype="bfloat16", softcap=50.0),
    dict(b=1, s=4608, h=16, kh=8, d=256, dtype="bfloat16", softcap=50.0,
         window=4096),
    dict(b=2, s=1000, h=16, kh=8, d=256, dtype="bfloat16", softcap=50.0),
    dict(b=1, s=4096, h=32, kh=8, d=128, dtype="bfloat16"),
    dict(b=2, s=512, h=32, kh=32, d=64, dtype="float32"),
    dict(b=2, s=1000, h=32, kh=8, d=128, dtype="bfloat16", causal=False),
    dict(b=16, s=128, h=32, kh=32, d=64, dtype="float32"),
]
PEAK_BF16 = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels.py:120
# the float32 kernel's row log-sum-exp (the backward's input) against
# lse_plain on the same inputs: max |error| over max |lse|
LSE_RTOL = 1e-5
# The reference's check above (max abs error, inputs x 0.5) cannot see a
# dropped softcap or a shifted window at these shapes: its logits are ~0.25,
# the softcap of 50 never bends them and the softmax is near uniform, so an
# output row is ~0.01 in size.  The sharp check: q and k scaled so the scaled
# logits have a std of LOGIT_STD (the softcap bends the largest, the softmax
# is peaked), the kernel against the plain version in float32 on the same
# inputs, each output row's error against its own size, max over rows of
# ||got - exp|| / ||exp||.  ROW_TOL: bf16 -- the kernel rounds the
# probabilities and the output to bf16, 2^-8 each; f32 -- summation order of
# 256-term dots of size ~16 (~1e-5 of a logit).  Controls: the plain version
# with the softcap dropped, the window moved by a 32-key tile either way, or
# the causal flag flipped, must each differ from it by CONTROL x ROW_TOL.
LOGIT_STD = 16.0
ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
CONTROL = 10.0


def _admitted_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask admits in one head: the work the
    attention does on these inputs."""
    if not causal:
        return s * s
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _flash_plain_bshd(q, k, v, **kw):
    """The plain version on the (B, S, H, D) layout, kv heads repeated."""
    from repro_torch.kernels import flash_attention as fa

    rep = q.shape[2] // k.shape[2]
    return fa.flash_attention_plain(
        q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
        v.repeat_interleave(rep, 2).transpose(1, 2), **kw).transpose(1, 2)


def _flash_plain_blocked(q, k, v, *, causal=True, window=None,
                         softcap=None):
    """The port's blocked attention (``layers._blocked_sdpa``, a (512, S)
    logits tile at a time) on the (B, S, H, D) layout: the plain version
    where the dense one's (S, S) logits do not fit on the card."""
    from repro_torch.models import layers as L

    return L._blocked_sdpa(q, k, v, causal=causal, window=window,
                           cap=softcap, scale=1.0 / math.sqrt(q.shape[-1]),
                           block_q=512)


FLASH_PLAINS = {"dense": _flash_plain_bshd, "blocked": _flash_plain_blocked}


def _row_rel_err(got, exp) -> float:
    """max over output rows (b, s, h) of ||got - exp|| / ||exp||."""
    g, e = got.float().flatten(0, 2), exp.float().flatten(0, 2)
    return float(((g - e).norm(dim=1) / e.norm(dim=1)).max())


def _flash_sharp(b, s, h, kh, d, dtype, causal, window, softcap, seed,
                 plain=_flash_plain_bshd, dv=None):
    """The sharp check (see ROW_TOL) and its controls against the plain
    version ``plain``; returns (max row error, {control: its max row
    difference from the plain version}).  ``dv``: v's head dim (default
    ``d``)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = LOGIT_STD ** 0.5  # q.k / sqrt(D) has std sd * sd
    q, k, v = ((torch.randn((b, s, n, w), generator=gen, device="cuda")
                * f).to(dtype) for n, w, f in ((h, d, sd), (kh, d, sd),
                                               (kh, dv or d, 1.0)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa.flash_attention_bshd(q, k, v, **kw)
    q, k, v = q.float(), k.float(), v.float()
    exp = plain(q, k, v, **kw)
    err = _row_rel_err(got, exp)
    del got
    controls = {}
    if softcap is not None:
        controls["softcap dropped"] = dict(kw, softcap=None)
    if causal and window is not None:
        for w in (window - 32, window + 32):
            controls[f"window {w}"] = dict(kw, window=w)
    controls["causal flipped"] = dict(kw, causal=not causal)
    ctl = {}
    for name, ckw in controls.items():
        ctl[name] = _row_rel_err(plain(q, k, v, **ckw), exp)
        torch.cuda.empty_cache()
    return err, ctl


def _flash_inputs(b, s, h, kh, d, dtype, seed, dv=None):
    """q, k, v of the reference's check: standard normals times 0.5 (v of
    head dim ``dv``, default ``d``)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple((torch.randn((b, s, n, w), generator=gen, device="cuda")
                  * 0.5).to(dtype) for n, w in ((h, d), (kh, d), (kh, dv or d)))


def _sdpa_backend(call, out) -> str:
    """The SDPA backend ``call()`` took: the first of the backends, in
    the dispatcher's order, that gives ``out`` bitwise when it is the only
    one allowed (``None`` if none does)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                if _bit_diff(call(), out) == 0:
                    return backend.name
        except RuntimeError:  # the backend cannot take these inputs
            continue
    return None


def _flash_case(card: str, b, s, h, kh, d, dtype, causal=True, window=None,
                softcap=None, seed=0, plain="dense", dv=None):
    """The flash kernel against its plain version at one shape (the
    reference's check, then the sharp one with its controls); ``plain``
    names the plain version in FLASH_PLAINS, ``dv`` v's head dim (default
    ``d``).  Times the kernel, the plain version and, where it computes the
    same function (no softcap), ``F.scaled_dot_product_attention`` -- for a
    causal window with a boolean (S, S) mask and the kv heads repeated to
    H, so the call may leave the fused backends -- and names the backend
    SDPA took.  At head dims the kernel is not built at, the wrapper pads
    to its width: the kernel alone on inputs padded beforehand is timed
    too (``padded_ms``; the rest of ``ms`` is the pad and the slice)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    dv = dv or d
    q, k, v = _flash_inputs(b, s, h, kh, d, dtype, seed, dv)
    rep = h // kh
    # float32 is timed as training calls it: with the rows' log-sum-exp
    with_lse = dtype == torch.float32

    def kern():
        return fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                       softcap=softcap, with_lse=with_lse)

    plain_name, plain_fn = plain, FLASH_PLAINS[plain]

    def plain():
        return plain_fn(q, k, v, causal=causal, window=window,
                        softcap=softcap)

    got, exp = kern(), plain()
    torch.cuda.synchronize()
    wname = str(dtype).replace("torch.", "")
    dims = d if dv == d else f"{d}/{dv}"
    where = (f"{(b, s, h, kh, dims)} {wname} causal={causal} "
             f"window={window} softcap={softcap}")
    lse_err = None
    if with_lse:
        got, lse = got
        lse_exp = fa.lse_plain(q, k, causal=causal, window=window,
                               softcap=softcap)
        lse_err = float((lse - lse_exp).abs().max() / lse_exp.abs().max())
        check(lse_err <= LSE_RTOL, f"flash kernel's lse != lse_plain at "
              f"{where}: {lse_err:.3e} relative > {LSE_RTOL}")
        del lse, lse_exp
    err = float((got.float() - exp.float()).abs().max())
    check(bool(torch.isfinite(got).all()), f"flash {where}: non-finite output")
    check(err <= FLASH_TOL[wname], f"flash kernel != plain at {where}: max "
          f"abs err {err:.3e} > {FLASH_TOL[wname]}")
    del got, exp
    row_err, ctl = _flash_sharp(b, s, h, kh, d, dtype, causal, window,
                                softcap, seed + 1000, plain_fn, dv)
    row_tol = ROW_TOL[wname]
    check(row_err <= row_tol, f"flash kernel != plain at {where}, logit std "
          f"{LOGIT_STD}: max row error {row_err:.3e} > {row_tol}")
    for name, diff in ctl.items():
        check(diff >= CONTROL * row_tol, f"flash control at {where}: {name} "
              f"moves the plain version by only {diff:.3e} < {CONTROL} x "
              f"{row_tol}, so the check could not see it")
    ms = _time_ms(kern, 5, 3)
    # the kernel's mean over the records the profiler kept (None: it kept
    # none), so a lost record does not read as a faster kernel
    recs = {k: (v, _profile_kernels.records[k])
            for k, v in _profile_kernels(kern, 5).items() if "flash_" in k}
    device_ms = (sum(v for v, _ in recs.values())
                 / sum(n for _, n in recs.values())) if recs else None
    width = fa.kernel_width(d, dv)
    padded_ms = None
    if width != d or width != dv:
        (pq, pk, pv), _ = fa.to_kernel_width(q, k, v)
        padded_ms = _time_ms(lambda: fa.flash_attention_bshd(
            pq, pk, pv, causal=causal, window=window, softcap=softcap,
            with_lse=with_lse), 5, 3)
        del pq, pk, pv
    plain_ms = _time_ms(plain, 3, 2)
    library_ms = library_device_ms = yardstick = backend = None
    if softcap is None:
        # SDPA computes the same function; timed only, on the (B, H, S, D)
        # layout it takes
        qt = q.transpose(1, 2).contiguous()
        if window is None or not causal:
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            lib_kw = dict(is_causal=causal, enable_gqa=rep > 1)
            yardstick = "SDPA"
        else:
            kt, vt = (x.repeat_interleave(rep, 2).transpose(1, 2)
                      .contiguous() for x in (k, v))
            lib_kw = dict(attn_mask=L.causal_mask(s, s, window=window,
                                                  device="cuda"))
            yardstick = "SDPA, boolean (S, S) mask, kv heads repeated to H"
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, **lib_kw)
        try:
            got = kern()
            got = got[0] if with_lse else got
            lib_out = lib()
            lib_err = float((lib_out.transpose(1, 2).float()
                             - got.float()).abs().max())
        except TypeError as e:  # a PyTorch without enable_gqa
            log(f"[flash] SDPA not timed: {e}")
        else:
            check(lib_err <= FLASH_TOL[wname], f"SDPA disagrees with the "
                  f"kernel at {where} by {lib_err:.3e}")
            backend = _sdpa_backend(lib, lib_out)
            library_ms = _time_ms(lib, 5, 3)
            # the profiler now and then keeps no record of SDPA's kernels:
            # then a CUDA-graph replay of the call
            library_device_ms = (_device_ms(lib, 5)
                                 or _graph_replay_ms(lib, lib_out))
            del lib_out
        del qt, kt, vt, got
    pairs = _admitted_pairs(s, causal, window)
    flops = 2 * (d + dv) * h * b * pairs
    nbytes = b * s * (h + kh) * (d + dv) * q.element_size()
    peak = PEAK_BF16 if dtype != torch.float32 else SPLIT_TF32_OPS
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    row = {"kernel": "flash_attention", "shape": [b, s, h, kh, d],
           "dv": dv, "kernel_width": width, "padded_ms": padded_ms,
           "pad_flop_factor": 2 * width / (d + dv), "dtype": wname, "causal": causal, "window": window,
           "softcap": softcap, "seed": seed, "with_lse": with_lse,
           "max_abs_err": err, "tol": FLASH_TOL[wname],
           "lse_rel_err": lse_err, "lse_rtol": LSE_RTOL if with_lse else None,
           "max_row_rel_err": row_err, "row_tol": row_tol,
           "controls": ctl,
           "ms": ms, "device_ms": device_ms, "plain": plain_name,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_device_ms": library_device_ms, "library": yardstick,
           "library_backend": backend, "flex": None, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "bound_ms_fp32_cores": (1e3 * max(flops / PEAK_OPS["float32"],
                                             t_bytes)
                                   if dtype == torch.float32 else None),
           "gflop": flops / 1e9,
           "TFLOP_per_s": flops / ((device_ms or ms) * 1e-3) / 1e12}
    log(f"[flash] (B {b}, S {s}, H {h}/{kh}, D {dims}) {wname} "
        f"causal={causal} "
        f"window={window} softcap={softcap}: max abs err {err:.3e} (tol "
        f"{FLASH_TOL[wname]})"
        + (f", lse {lse_err:.3e} relative (tol {LSE_RTOL})" if with_lse
           else "")
        + f"; logit std {LOGIT_STD}: max row err "
        f"{row_err:.3e} (tol {row_tol}), controls "
        + ", ".join(f"{n} {c:.3e}" for n, c in ctl.items())
        + f"; kernel {ms:.4f} ms (device "
        f"{'%.4f ms' % device_ms if device_ms else 'not measured'}, "
        f"{row['TFLOP_per_s']:.1f} TFLOP/s)"
        + (f" at width {width}: the kernel alone on padded inputs "
           f"{padded_ms:.4f} ms, the pad and slice {ms - padded_ms:.4f} ms, "
           f"padded operations x{row['pad_flop_factor']:.3f}"
           if padded_ms is not None else "")
        + f", bound {bound_ms:.4f} ms ({bound_by}"
        + (f"; {row['bound_ms_fp32_cores']:.4f} at 67 TFLOP/s f32"
           if with_lse else "")
        + f"), plain ({plain_name}) {plain_ms:.4f} ms, "
        + (f"{yardstick}: {library_ms:.4f} ms (device "
           f"{'%.4f ms' % library_device_ms if library_device_ms else 'not measured'}"
           f"; backend {backend})"
           if library_ms is not None else "SDPA n/a")
        + f"  [{card}]")
    del q, k, v
    torch.cuda.empty_cache()
    return row


def _flex_yardstick(q, k, v, got, causal, window, softcap, tol,
                    where: str) -> dict:
    """``torch.nn.attention.flex_attention``, compiled once with the softcap
    as ``score_mod`` and the causal window as the block mask: one PyTorch
    call that computes the kernel's function where SDPA cannot (no softcap).
    Timed only -- the port never calls it -- and held to the kernel's output
    ``got`` at the reference's tolerance (fatal).  Only a failure to import,
    compile or first call it is logged and carries on: ms is then None,
    "not measured"."""
    import torch

    b, s, h, d = q.shape
    out = {"ms": None, "device_ms": None, "compile_s": None, "err": None,
           "error": None}
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def score_mod(score, b_, h_, qi, kv):
            return softcap * torch.tanh(score / softcap)

        def mask_mod(b_, h_, qi, kv):
            ok = kv <= qi if causal else kv >= 0
            if causal and window is not None:
                ok = ok & (kv > qi - window)
            return ok

        t0 = time.perf_counter()
        mask = create_block_mask(mask_mod, None, None, s, s, device="cuda")
        fn = _compile_static(flex_attention)

        def call():
            return fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                      enable_gqa=h != k.shape[2])

        res = call()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 -- the import, compile, first call
        out["error"] = f"{type(e).__name__}: {str(e)[:300]}"
        log(f"[flex] {where}: flex_attention yardstick not measured: "
            f"{out['error']}")
        return out
    out["compile_s"] = time.perf_counter() - t0
    out["err"] = float((res.transpose(1, 2).float() - got.float())
                       .abs().max())
    check(out["err"] <= tol, f"flex_attention disagrees with the kernel at "
          f"{where} by {out['err']:.3e} > {tol}")
    out["ms"] = _time_ms(call, 5, 3)
    out["device_ms"] = _graph_replay_ms(call, res)
    dev = ("not measured" if out["device_ms"] is None
           else f"{out['device_ms']:.4f} ms")
    log(f"[flex] {where}: flex_attention (softcap as score_mod, window as "
        f"block mask) compiled in {out['compile_s']:.1f} s, max abs diff "
        f"from the kernel {out['err']:.3e} (tol {tol}), {out['ms']:.4f} ms "
        f"(CUDA events), device {dev} (CUDA-graph replay)")
    del qt, kt, vt, res
    torch.cuda.empty_cache()
    return out


def _compile_static(fn):
    """``torch.compile(fn)`` for one shape: the caches are reset first and
    the shapes kept static.  After a few shapes in one process the compiler
    otherwise marks dims dynamic, and flex_attention then failed to lower
    ("unbacked_bindings") or to build its C++ wrapper."""
    import torch

    torch._dynamo.reset()
    return torch.compile(fn, dynamic=False)


def _graph_replay_ms(call, expect, replays: int = 20, check_out=None):
    """Device time of one ``call()`` without the host's launch gaps: the
    call captured once in a CUDA graph (after warm-up calls on a side
    stream), then timed over ``replays`` replays between CUDA events; the
    replay's output (a tensor or a tuple of them) must equal ``expect``
    bitwise (or pass ``check_out(out)``, where one is given).
    (``torch.profiler`` recorded no kernel of the compiled
    flex_attention once earlier phases had profiled in the same process,
    though it does in a fresh one, and now and then none of SDPA's.)
    None, logged, when the capture fails."""
    import torch

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"[flex] CUDA-graph capture failed: {str(e)[:200]}")
        return None
    if check_out is not None:
        check_out(out)
    else:
        check(_bit_diff(out, expect) == 0,
              "the graph replay differs from the eager call")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / replays


# -- phase 10b ----------------------------------------------------------------

SPLIT_TF32_FLOPS = 495e12 / 3  # three TF32 products per float32 one
GEMM_CLIENTS = 4
# (case, M, K, N, products of a local step of the stablelm cell): forward
# x W (4 layers x q, k, v, o; gate, up; down) and x E^T, their dX and dW
GEMM_CASES = [
    ("fwd", 512, 2048, 2048, 16), ("fwd", 512, 2048, 5632, 8),
    ("fwd", 512, 5632, 2048, 4), ("head", 512, 2048, 100_352, 1),
    ("dx", 512, 2048, 2048, 16), ("dx", 512, 5632, 2048, 8),
    ("dx", 512, 2048, 5632, 4), ("head_dx", 512, 100_352, 2048, 1),
    ("dw", 2048, 512, 2048, 16), ("dw", 2048, 512, 5632, 8),
    ("dw", 5632, 512, 2048, 4), ("dw", 100_352, 512, 2048, 1),
]


def _gemm_operands(case, m, k, n, seed, batch=GEMM_CLIENTS):
    """``(a, b)`` of one of the model's products as ``kernels/gemm.
    SplitGemm`` hands them to the kernel: ``fwd`` x W (A K-major, B
    N-major), ``head`` x E^T (B K-major), ``dx`` dY W^T (both K-major),
    ``head_dx`` dL E (B N-major), ``dw`` X^T dY (A M-major, B N-major; the
    head's dE as dL^T X, the embedding's own layout); ``prefill`` x W as
    ``fwd``; ``batch`` entries (the clients)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
    c = batch
    return {"fwd": lambda: (r(c, m, k), r(c, k, n)),
            "prefill": lambda: (r(c, m, k), r(c, k, n)),
            "head": lambda: (r(c, m, k), r(c, n, k).mT),
            "dx": lambda: (r(c, m, k), r(c, n, k).mT),
            "head_dx": lambda: (r(c, m, k), r(c, k, n)),
            "dw": lambda: (r(c, k, m).mT, r(c, k, n))}[case]()


def _highest_matmul(a, b):
    """torch.matmul in float32 on the CUDA cores (TF32 off): cuBLAS's
    SIMT sgemm, the yardstick."""
    import torch

    from repro_torch.device import full_fp32

    with full_fp32():
        return torch.matmul(a, b)


class _Smi:
    """The card's SM clock (MHz) and power draw (W), sampled every 100 ms by
    ``nvidia-smi`` in the background; :meth:`window` gives their medians
    over an interval of ``time.perf_counter``."""

    def __init__(self):
        import threading

        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                mhz, watts = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), mhz, watts))

    def window(self, t0: float, t1: float):
        """Medians over the samples taken in [t0, t1]; for an interval
        shorter than the sampling, the sample nearest its middle (None
        before the first sample)."""
        got = [(c, w) for t, c, w in self.samples if t0 <= t <= t1]
        if not got and self.samples:
            mid = (t0 + t1) / 2
            _, c, w = min(self.samples, key=lambda x: abs(x[0] - mid))
            return c, w
        if not got:
            return None, None
        return (statistics.median(c for c, _ in got),
                statistics.median(w for _, w in got))

    def close(self):
        self.proc.terminate()
        self.proc.wait(timeout=30)


def _gemm_transposed(gemm, a, b) -> bool:
    """Whether the wrapper computes ``a @ b`` as C^T."""
    return gemm.transposed(gemm._kernel_strides(a)[2] == 1,
                           gemm._kernel_strides(b)[1] == 1)


def _gemm_variant_check(gemm, case, a, b) -> None:
    """One launch of ``a @ b``, counted once, as a transposed product (C^T)
    exactly where :func:`gemm.transposed` says, with no operand copied."""
    from repro_torch.kernels import _build

    m, n = a.shape[1], b.shape[2]
    before = _build.COUNTS.copy()
    gemm.split_gemm(a, b)
    moved = dict(_build.COUNTS - before)
    want = {"split_gemms": 1}
    if _gemm_transposed(gemm, a, b):
        want["split_gemms_transposed"] = 1
    check(moved == want, f"split_gemm {case} {m}x{n}: the counts moved by "
          f"{moved}, not {want}")


def _gemm_case(card: str, case, m, k, n, per_step, seed, smi=None,
               batch=GEMM_CLIENTS, library: bool = True):
    import torch

    from repro_torch.kernels import gemm

    a, b = _gemm_operands(case, m, k, n, seed, batch)
    _gemm_variant_check(gemm, case, a, b)
    got = gemm.split_gemm(a, b)
    exp = torch.matmul(a.double(), b.double())
    rel = lambda x: float((x.double() - exp).norm() / exp.norm())
    err, lib_err = rel(got), rel(_highest_matmul(a, b))
    max_abs_err = float((got.double() - exp).abs().max())
    del got, exp
    check(err <= 2 * lib_err, f"split_gemm {case} {m}x{k}x{n}: error "
          f"{err:.3e} against float64 > twice cuBLAS float32's {lib_err:.3e}")
    flops = 2 * batch * m * k * n
    big = flops > 2e11
    reps, calls = (5, 2) if big else (9, 10)
    t0 = time.perf_counter()
    ms = _time_ms(lambda: gemm.split_gemm(a, b), reps, calls)
    t1 = time.perf_counter()
    mhz, watts = smi.window(t0, t1) if smi else (None, None)
    device_ms = _device_ms(lambda: gemm.split_gemm(a, b), 3 if big else 10)
    lib_ms = lib_device_ms = plain_ms = None
    if library:
        lib_ms = _time_ms(lambda: _highest_matmul(a, b), reps, calls)
        lib_device_ms = _device_ms(lambda: _highest_matmul(a, b),
                                   3 if big else 10)
        plain_ms = _time_ms(lambda: gemm.split_gemm_plain(a, b), 3, 1)
    bound_ms = 1e3 * flops / SPLIT_TF32_FLOPS
    row = {"case": case, "mkn": [m, k, n], "batch": batch,
           "per_local_step": per_step, "rel_err": err,
           "cublas_rel_err": lib_err, "max_abs_err": max_abs_err,
           "transposed": _gemm_transposed(gemm, a, b),
           "ms": ms, "device_ms": device_ms, "bound_ms": bound_ms,
           "bound_by": "operations",
           # of the events' time: after the smoke's earlier profiling the
           # profiler can miss this kernel's records (device 0, or part)
           "pct_of_bound": 100 * bound_ms / ms,
           "sm_mhz": mhz, "power_w": watts, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_device_ms": lib_device_ms,
           "tflops": flops / (ms * 1e-3) / 1e12}
    lib = (f"; plain {plain_ms:.4f} ms; torch.matmul highest {lib_ms:.4f} ms "
           f"(device {lib_device_ms:.4f})" if library else "")
    log(f"[gemm] {case} {batch} x ({m} x {k}) ({k} x {n})"
        f"{' as C^T' if row['transposed'] else ''}: "
        f"error {err:.3e} (cuBLAS f32 {lib_err:.3e}); kernel {ms:.4f} ms "
        f"(device {device_ms:.4f}), {row['tflops']:.1f} TFLOP/s, "
        f"{row['pct_of_bound']:.1f}% of the bound {bound_ms:.4f} (SM "
        f"{mhz} MHz, {watts} W){lib}  [{card}]")
    del a, b
    torch.cuda.empty_cache()
    return row


# the archs whose float32 prefill at 320 rows (2 x 160 positions) sends its
# products to kernel 6 in chip_smoke.py phases 11a, 16a and 17a
PREFILL_ARCHS = ("gemma2_9b", "recurrentgemma_9b", "phi3_medium_14b",
                 "mamba2_130m", "hubert_xlarge", "internvl2_26b",
                 "grok_1_314b", "deepseek_v3_671b")
PREFILL_ROWS = 320


def _prefill_products() -> list:
    """The distinct ``(K, N)`` of the products with the weights that one
    float32 prefill of :data:`PREFILL_ARCHS` over ``PREFILL_ROWS`` rows
    sends to the split GEMM (as :func:`_dense_products` counts them: q, k,
    v and o of an attention layer other than MLA's, a dense MLP's three and
    an MoE's shared expert's three, hubert's head over every frame), in
    order of first appearance.  A is the rows (K-major), B the weight
    (N-major), batch 1."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    out = []
    for arch in PREFILL_ARCHS:
        cfg = registry.get(arch)
        prefix, pattern, suffix = T._block_sequence(cfg)
        d, at = cfg.d_model, cfg.attn
        for kind, mlp_kind in prefix + pattern + suffix:
            if kind in ("attn", "local") and at.kind != "mla":
                hq = at.num_heads * at.head_dim
                out += [(d, hq), (d, at.num_kv_heads * at.head_dim), (hq, d)]
            if mlp_kind == "dense":
                out += [(d, cfg.d_ff), (cfg.d_ff, d)]
            if mlp_kind == "moe" and cfg.moe.num_shared:
                out += [(d, cfg.moe.d_ff_shared), (cfg.moe.d_ff_shared, d)]
        if not cfg.decode_supported:  # logits at every position
            out.append((d, cfg.vocab))
    return list(dict.fromkeys(out))


def _gemm_rows(card: str, library: bool = True) -> dict:
    """Kernel 6 at the stablelm cell's 12 products (:data:`GEMM_CASES`) and
    at the 320-row prefill products (:func:`_prefill_products`), each with
    the SM clock and power drawn while it was timed."""
    smi = _Smi()
    try:
        rows = [_gemm_case(card, *c, seed=i, smi=smi, library=library)
                for i, c in enumerate(GEMM_CASES)]
        prefill = [_gemm_case(card, "prefill", PREFILL_ROWS, k, n, 1,
                              seed=100 + i, smi=smi, batch=1, library=False)
                   for i, (k, n) in enumerate(_prefill_products())]
    finally:
        smi.close()
    step = {key: sum(r["per_local_step"] * r[key] for r in rows)
            for key in ("ms", "device_ms", "bound_ms")}
    if library:
        step["library_ms"] = sum(r["per_local_step"] * r["library_ms"]
                                 for r in rows)
    step["pct_of_bound"] = 100 * step["bound_ms"] / step["ms"]
    clocks = [r["sm_mhz"] for r in rows if r["sm_mhz"]]
    watts = [r["power_w"] for r in rows if r["power_w"]]
    step["sm_mhz"] = [min(clocks), max(clocks)] if clocks else None
    step["power_w"] = [min(watts), max(watts)] if watts else None
    log(f"[gemm] a local step's 87 products: kernel {step['ms']:.2f} ms "
        f"(device {step['device_ms']:.2f}; bound {step['bound_ms']:.2f}, "
        f"{step['pct_of_bound']:.1f}%; SM {step['sm_mhz']} MHz, "
        f"{step['power_w']} W)"
        + (f", torch.matmul highest {step['library_ms']:.2f} ms"
           if library else "")
        + f"; a round (4 local steps) {4 * step['ms']:.1f} ms  [{card}]")
    return {"cases": rows, "local_step": step, "prefill": prefill}


def phase_split_gemm(card: str) -> dict:
    """Phase 10b: the split-TF32 GEMM at the stablelm cell's products and
    at the 320-row prefill products of phases 11a, 16a and 17a."""
    return _gemm_rows(card)


def phase_flash_kernel(card: str):
    """Phase 10: the flash kernel at the serving path's shapes."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    # the compiled kernel's own tile sizes and kv_tiles / tile_masked, run on
    # the host, against the plan tests/test_torch_flash.py holds to a
    # brute-force mask
    for d in fa.HEAD_DIMS:
        for s in (1, 65, 129, 1000, 4096, 4608, 4609):
            for causal, window in ((True, None), (True, 1), (True, 33),
                                   (True, 4096), (False, None)):
                kw = dict(causal=causal, window=window)
                check(fa.kernel_tile_plan(s, d, **kw)
                      == fa.warpgroup_plan(s, d, **kw),
                      f"flash kernel's tile plan != tile_plan at D {d}, "
                      f"S {s}, {kw}")
    log("[flash] the kernel's tile plan equals tile_plan (D 64/128/256, 7 "
        "lengths, 5 masks)")
    return _flash_cases(card, FLASH_CASES)


def _flash_cases(card: str, cases) -> list:
    """:func:`_flash_case` at each of ``cases`` (entries of
    :data:`FLASH_CASES`), each with its seed."""
    import torch

    return [_flash_case(card, seed=200 + FLASH_CASES.index(c),
                        **dict(c, dtype=getattr(torch, c["dtype"])))
            for c in cases]


def _flex_bwd_yardstick(card: str, row: dict) -> None:
    """The library yardstick of a phase-15 kernel-5b row with a softcap:
    the compiled ``flex_attention``'s backward (``torch.autograd.grad`` of
    its output, the softcap as ``score_mod``, the window as the block mask)
    on that row's inputs, in float32, held to the kernel at LIB_BWD_TOL
    (fatal) and timed with CUDA events; fills ``library_ms``.  Only a
    failure to import, compile or call it is logged and carries on."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    b, s, h, kh, d = row["shape"]
    causal, window, softcap = row["causal"], row["window"], row["softcap"]
    gen = torch.Generator(device="cuda").manual_seed(row["seed"])
    sd = LOGIT_STD ** 0.5
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda") * f
               for n, f in ((h, sd), (kh, sd), (kh, 1.0)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.flash_attention_bshd(q, k, v, with_lse=True, **kw)
    do = torch.randn(out.shape, generator=gen, device="cuda")
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    where = f"5b {(b, s, h, kh, d)} {kw}"
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def score_mod(score, b_, h_, qi, kv):
            return softcap * torch.tanh(score / softcap)

        def mask_mod(b_, h_, qi, kv):
            ok = kv <= qi if causal else kv >= 0
            if causal and window is not None:
                ok = ok & (kv > qi - window)
            return ok

        t0 = time.perf_counter()
        mask = create_block_mask(mask_mod, None, None, s, s, device="cuda")
        # a compiled backward donates its saved buffers unless told not to,
        # and then refuses the retain_graph the timing loop needs; the
        # setting is read at every backward call, so it spans the timing
        with torch._functorch.config.patch(donated_buffer=False):
            compiled = _compile_static(flex_attention)

            def fwd(*xs):
                return compiled(*(xs or (qt, kt, vt)), score_mod=score_mod,
                                block_mask=mask, enable_gqa=h != kh)

            lib_out = fwd()

            def lib():
                return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                           retain_graph=True)

            res = lib()
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
            err = _bwd_grads_err([x.transpose(1, 2) for x in res], got)
            check(err <= LIB_BWD_TOL, f"flex_attention's backward disagrees "
                  f"with kernel 5b at {where} by {err:.3e} > {LIB_BWD_TOL}")
            ms = _time_ms(lib, 5, 3)
            device_ms = _flex_bwd_device_ms(fwd, (qt, kt, vt), dot, got,
                                            where)
    except Exception as e:  # noqa: BLE001 -- the import, compile, calls
        row["flex_bwd_error"] = f"{type(e).__name__}: {str(e)[:300]}"
        log(f"[flex] {where}: flex_attention backward not measured: "
            f"{row['flex_bwd_error']}")
        return
    row.update(library="flex_attention", library_err=err, library_ms=ms,
               library_device_ms=device_ms, library_compile_s=compile_s)
    dev = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
    log(f"[flex] {where}: flex_attention backward (compiled in "
        f"{compile_s:.1f} s) {ms:.4f} ms (CUDA events), device {dev}, "
        f"{err:.3e} of max |grad| from the kernel; kernel 5b "
        f"{row['ms']:.4f} ms  [{card}]")
    del q, k, v, qt, kt, vt, out, lse, do, dot, got, res, lib_out
    torch.cuda.empty_cache()


def _flex_bwd_device_ms(fwd, inputs, dot, got, where: str):
    """Device ms of the compiled flex_attention's backward: the profiler
    records none of its Triton kernels after the earlier phases'
    profiling, and a backward captured alone would run on the forward's
    stream, outside the capture.  So forward + backward and the forward
    alone are each captured in a CUDA graph and replayed (the replayed
    gradients held to kernel 5b at LIB_BWD_TOL, fatal), and the backward's
    time is their difference.  The inputs are fresh leaves, so no autograd
    node of an earlier graph (on another stream) is kept alive into the
    capture.  None, logged, when a capture fails."""
    import torch

    ins = tuple(x.detach().clone().requires_grad_() for x in inputs)

    def fwd_ins():
        return fwd(*ins)

    def both():
        return torch.autograd.grad(fwd_ins(), ins, dot)

    def check_grads(res):
        err = _bwd_grads_err([x.transpose(1, 2) for x in res], got)
        check(err <= LIB_BWD_TOL, f"flex_attention's replayed backward "
              f"disagrees with kernel 5b at {where} by {err:.3e}")

    try:
        t_both = _graph_replay_ms(both, None, check_out=check_grads)
        t_fwd = _graph_replay_ms(fwd_ins, fwd_ins().detach())
    except Exception as e:  # noqa: BLE001 -- a capture the stream refuses
        log(f"[flex] {where}: backward device time not measured: "
            f"{type(e).__name__}: {str(e)[:200]}")
        return None
    if t_both is None or t_fwd is None:
        return None
    return t_both - t_fwd


def phase_flex_yardstick(card: str, rows: list) -> None:
    """Phase 12: flex_attention beside the kernel at phase 10's softcap
    cases, on the same inputs; fills each row's ``library_ms``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    for row in rows:
        if row["softcap"] is None:
            continue
        b, s, h, kh, d = row["shape"]
        kw = dict(causal=row["causal"], window=row["window"],
                  softcap=row["softcap"])
        q, k, v = _flash_inputs(b, s, h, kh, d, getattr(torch, row["dtype"]),
                                row["seed"])
        where = f"{(b, s, h, kh, d)} {row['dtype']} {kw}"
        row["flex"] = _flex_yardstick(q, k, v, fa.flash_attention_bshd(
            q, k, v, **kw), tol=row["tol"], where=where, **kw)
        row["library_ms"] = row["flex"]["ms"]
        if row["library_ms"] is not None:
            log(f"[flex] kernel {row['ms']:.4f} ms (device "
                f"{row['device_ms'] or float('nan'):.4f} ms) vs "
                f"flex_attention {row['library_ms']:.4f} ms (device "
                f"{row['flex']['device_ms'] or float('nan'):.4f} ms)  "
                f"[{card}]")
        del q, k, v
        torch.cuda.empty_cache()


# -- phase 11 -----------------------------------------------------------------

def _gemma(**over):
    from repro_torch.configs import registry

    return registry.get("gemma2_9b").with_overrides(**over)


def _teacher_forced(params, cfg, prompts, steps, max_len):
    """Last-position prefill logits, then ``steps`` decode logits feeding
    the prompt's own continuation; returns ([logits...], caches)."""
    import torch

    toks = torch.as_tensor(prompts, device=params["embed"].device)
    return _forced(params, cfg, {"tokens": toks}, steps, max_len)


def _forced(params, cfg, batch, steps: int, max_len: int):
    """Prefill over ``batch`` (its last ``steps`` tokens held back), then
    ``steps`` teacher-forced decode steps on them; returns ([logits of the
    last prefill position, then each step], caches).  hubert (no decode):
    the prefill's logits at every frame and its caches."""
    import torch

    from repro_torch.models import transformer as T

    if not cfg.decode_supported:
        logits, caches, _ = T.prefill(params, cfg, batch, max_len=max_len)
        return [logits.float().cpu()], caches
    toks = batch["tokens"]
    s = toks.shape[1] - steps
    logits, caches, cache_len = T.prefill(params, cfg, dict(
        batch, tokens=toks[:, :s]), max_len=max_len, last_only=True)
    out = [logits[:, -1].float().cpu()]
    for i in range(steps):
        lg, caches = T.decode_step(params, cfg, caches,
                                   toks[:, s + i:s + i + 1], cache_len)
        out.append(lg[:, 0].float().cpu())
        cache_len = cache_len + 1
    del logits
    return out, caches


def phase_gemma_card_vs_cpu(card: str):
    """Phase 11a: gemma2-9b at full width, one local+global period, float32,
    window 96 and 168-token inputs (the ring cache rolls and wraps), card
    against CPU; then serve == sequential generate on the card."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.utils import tree as tu

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    cfg = _gemma(n_layers=2, window_local=96, param_dtype=torch.float32)
    steps, s_prompt, max_len = 8, 160, 256
    t0 = time.perf_counter()
    params_cpu = T.init_model(torch.Generator().manual_seed(0), cfg)
    params = tu.tree_map(lambda x: x.to("cuda"), params_cpu)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab, (2, s_prompt + steps), dtype=np.int32)

    reset_counts()
    got, caches = _teacher_forced(params, cfg, prompts, steps, max_len)
    torch.cuda.synchronize()
    counts = read_counts()
    # the prefill's products; decode none
    n_gemm = _dense_products(cfg, head=False, rows=2 * s_prompt)
    check(counts == _expect(flash_attentions=2, split_gemms=n_gemm),
          f"11a card: launches {counts}, expected 2 flash launches (one per "
          f"layer of one prefill) and {n_gemm} split GEMM (the prefill's "
          "products)")
    before = read_counts()
    t0 = time.perf_counter()
    exp, caches_cpu = _teacher_forced(params_cpu, cfg, prompts, steps,
                                      max_len)
    cpu_s = time.perf_counter() - t0
    check(read_counts() == before, "the CPU run launched a kernel")
    scale = max(float(e.abs().max()) for e in exp)
    errs = [float((g - e).abs().max()) for g, e in zip(got, exp)]
    tol = 1e-4 * scale
    check(all(math.isfinite(e) for e in errs) and max(errs) <= tol,
          f"11a: card vs CPU logits differ by {max(errs):.3e} > {tol:.3e} "
          f"(per step {errs})")
    cache_err = max(float((a.float().cpu() - c.float()).abs().max())
                    for a, c in zip(tu.tree_leaves(caches),
                                    tu.tree_leaves(caches_cpu)))
    cache_scale = max(float(c.abs().max()) for c in tu.tree_leaves(caches_cpu))
    tol_cache = 1e-4 * cache_scale
    check(math.isfinite(cache_err) and cache_err <= tol_cache,
          f"11a: card vs CPU caches differ by {cache_err:.3e} > "
          f"{tol_cache:.3e} (1e-4 x max|cache|)")
    ring = caches["stack"]["b0"]["k"].shape[2]
    log(f"[gemma-11a] full width, 2 layers (local window 96 + global), f32, "
        f"2 x {s_prompt}-token prompts + {steps} teacher-forced steps: max "
        f"|logit| {scale:.4f}, card vs CPU max abs diff {max(errs):.3e} (tol "
        f"1e-4 x max|logit| = {tol:.3e}; prefill {errs[0]:.3e}, decode "
        f"{max(errs[1:]):.3e}); caches {cache_err:.3e} (tol 1e-4 x max|cache|"
        f" = {tol_cache:.3e}; ring T = {ring}); "
        f"init {init_s:.1f} s, CPU run {cpu_s:.1f} s  [{card}]")
    del caches, caches_cpu, params_cpu

    # serve == sequential generate, greedy, on the card
    eng = ServingEngine(cfg, params, max_len=max_len, device="cuda")
    lens, news = (160, 100, 130), (12, 9, 12)
    reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, n,
                                              dtype=np.int32),
                    max_new_tokens=m) for i, (n, m) in enumerate(zip(lens,
                                                                     news))]
    reset_counts()
    served = eng.serve(reqs, slots=2, segment=4)
    torch.cuda.synchronize()
    n_flash = 2 * len(reqs)  # one launch per layer of each admission
    # each admission's prefill, one prompt's rows
    n_serve = sum(_dense_products(cfg, head=False, rows=n) for n in lens)
    check(read_counts() == _expect(flash_attentions=n_flash,
                                   split_gemms=n_serve),
          f"11a serve: launches {read_counts()}, expected {n_flash} flash "
          f"and {n_serve} split GEMM (the admissions' prefills)")
    flips = []
    for r in served:
        seq = eng.generate(reqs[r.id].prompt[None, :],
                           max_new_tokens=reqs[r.id].max_new_tokens)
        check(len(r.tokens) == reqs[r.id].max_new_tokens,
              f"11a serve: request {r.id} has {len(r.tokens)} tokens")
        diff = np.nonzero(r.tokens != seq.tokens[0])[0]
        if diff.size:
            i = int(diff[0])
            # the flip's top-2 margin, from the sequential trajectory
            toks = np.concatenate([reqs[r.id].prompt, seq.tokens[0][:i]])
            lg, _ = _teacher_forced(params, cfg, toks[None], i, max_len)
            top2 = torch.topk(lg[-1][0], 2).values
            margin = float(top2[0] - top2[1])
            flips.append((r.id, i, margin))
            check(margin <= tol, f"11a serve: request {r.id} flips at step "
                  f"{i} with top-2 margin {margin:.3e} > {tol:.3e}")
    log(f"[gemma-11a] serve (3 requests, 2 slots, segment 4) == sequential "
        f"generate on the card: {len(served)} requests, flips {flips}, "
        f"{n_flash} flash launches  [{card}]")
    del params, eng
    torch.cuda.empty_cache()
    return {"launches": _expect(flash_attentions=2 + n_flash,
                                split_gemms=n_gemm + n_serve),
            "max_abs_diff": max(errs), "tol": tol, "max_abs_logit": scale,
            "errs": errs, "cache_max_abs_diff": cache_err,
            "cache_tol": tol_cache, "flips": flips,
            "init_s": init_s, "cpu_s": cpu_s}


def _prefill_ms(params, cfg, b, s, rng, max_len):
    """A (b, s) random prompt's prefill: (host ms, synchronised; out)."""
    import torch

    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)), device="cuda")
    return _batch_prefill_ms(params, cfg, {"tokens": toks}, max_len)


def _batch_prefill_ms(params, cfg, batch, max_len):
    """``batch``'s prefill: (host ms, synchronised; prefill's output)."""
    import torch

    from repro_torch.models import transformer as T

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = T.prefill(params, cfg, batch, max_len=max_len, last_only=True)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def phase_gemma_full(card: str):
    """Phase 11b: gemma2-9b at full width and depth in bfloat16: generate,
    then continuous batching with mixed prompt lengths."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServingEngine

    cfg = _gemma()
    max_len, new = 8192, 32
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device="cuda").manual_seed(0),
                          cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = T.count_params(params)
    eng = ServingEngine(cfg, params, max_len=max_len, device="cuda")
    rng = np.random.default_rng(12)
    eng.generate(rng.integers(0, cfg.vocab, (1, 64), dtype=np.int32),
                 max_new_tokens=2)  # warm-up: cuBLAS handles, allocator

    prompts = rng.integers(0, cfg.vocab, (2, 1024), dtype=np.int32)
    lens = (4608, 1024, 2500, 640)
    reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, n,
                                              dtype=np.int32),
                    max_new_tokens=new) for i, n in enumerate(lens)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_gen = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=new)
    t_serve = time.perf_counter()
    served = eng.serve(reqs, slots=2, segment=8)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = read_counts()
    prefills = 1 + len(reqs)
    check(counts == _expect(flash_attentions=cfg.n_layers * prefills),
          f"11b: launches {counts}, expected {cfg.n_layers} flash launches "
          f"per prefill x {prefills} prefills and nothing else")
    check(gen.tokens.shape == (2, new) and np.isfinite(gen.logprobs).all(),
          "11b generate: bad shape or non-finite logprobs")
    check([r.id for r in served] == list(range(len(reqs))),
          f"11b serve: finished {[r.id for r in served]}")
    for r in served:
        check(len(r.tokens) == new and np.isfinite(r.logprobs).all()
              and ((0 <= r.tokens) & (r.tokens < cfg.vocab)).all(),
              f"11b serve: request {r.id} incomplete or non-finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[gemma-11b] gemma2-9b full width and depth ({cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B params, bf16, init {init_s:.1f} s): generate"
        f" 2 x 1024 + {new} in {t_serve - t_gen:.2f} s; serve {len(reqs)} "
        f"requests (prompts {lens}, {new} new each) on 2 slots, segment 8, "
        f"max_len {max_len} in {t_end - t_serve:.2f} s; launches {counts}; peak "
        f"{peak_gb:.1f} GB  [{card}]")

    # timings outside the counted path
    prefill_ms = {}
    for n in lens:
        prefill_ms[n], _ = _prefill_ms(params, cfg, 1, n, rng, max_len)
    prefill_ms["2x1024"], (logits, caches, cache_len) = _prefill_ms(
        params, cfg, 2, 1024, rng, max_len)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._segment(params, caches, tok, cache_len, new, 0.0, [None])
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / new
    decode_busy = sum(_profile_kernels(lambda: eng._segment(
        params, caches, tok, cache_len, 1, 0.0, [None]), 1, 2).values())
    del caches, logits
    log(f"[gemma-11b] prefill ms (host clock, synchronised, B=1): "
        + ", ".join(f"S={k}: {v:.1f}" for k, v in prefill_ms.items())
        + f"; decode {decode_ms:.2f} ms/token at batch 2, cache {max_len}, "
        f"one profiled step device busy {decode_busy:.2f} ms (idle share "
        f"{1 - decode_busy / decode_ms:.3f})  [{card}]")
    profiles = {}
    for n in lens[:2]:  # 4,608 and 1,024 tokens
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                               device="cuda")
        by_name = _profile_kernels(lambda: T.prefill(
            params, cfg, {"tokens": toks}, max_len=max_len, last_only=True),
            1, sessions=2)
        busy = sum(by_name.values())
        flash_ms = sum(v for k, v in by_name.items() if "flash_" in k)
        profiles[n] = {"device_busy_ms": busy, "flash_ms": flash_ms,
                       "flash_share": flash_ms / busy if busy > 0 else None,
                       "idle_share": 1 - busy / prefill_ms[n]}
        log(f"[gemma-11b] profiled prefill S={n}: device busy {busy:.2f} ms "
            f"(idle share {profiles[n]['idle_share']:.3f} of the host-clock "
            f"prefill), flash kernel {flash_ms:.2f} ms "
            f"({profiles[n]['flash_share'] or 0:.3f} of busy)  [{card}]")
        if n == lens[0]:
            for kname, ms in sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:8]:
                log(f"[gemma-11b]   {ms:9.3f} ms  {kname[:110]}")
    del params, eng
    torch.cuda.empty_cache()
    return {"launches": counts, "n_params": n_params, "init_s": init_s,
            "generate_s": t_serve - t_gen, "serve_s": t_end - t_serve,
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "decode_step_device_busy_ms": decode_busy,
            "prefill_profiles": profiles, "peak_gb": peak_gb,
            "serve_tokens": {r.id: r.tokens.tolist() for r in served}}


# -- phase 15 -----------------------------------------------------------------

# kernel 5b against its plain version computed in float64: each of dq, dk,
# dv within BWD_TOL x its max |.|; q, k scaled to logits of std LOGIT_STD
# (phase 10's sharp inputs: the softcap bends, the softmax is peaked).
# Controls: the softcap dropped, the window moved by 32 keys either way and
# the causal flag flipped must each move the plain gradients by CONTROL x
# BWD_TOL.  Measured by this phase on an H100 80GB HBM3 (700 W): <= 1.22e-5
# (the f32 kernel's summation order and its forward's log-sum-exp).
BWD_TOL = 1e-4
# the library's backward (SDPA or flex_attention) against the kernel: its
# own summation order and kernels, so held at 10x the kernel's tolerance
LIB_BWD_TOL = 1e-3
# (b): card vs CPU port, per round: train_loss at rtol LM_LOSS_RTOL, x_bar
# within LM_XBAR_TOL x max |x_bar|
LM_LOSS_RTOL, LM_XBAR_TOL = 1e-5, 1e-4
LM_ARCHS = ("stablelm_1_6b", "mistral_nemo_12b", "gemma2_9b",
            "phi3_medium_14b", "recurrentgemma_9b", "mamba2_130m",
            "grok_1_314b", "deepseek_v3_671b", "hubert_xlarge",
            "internvl2_26b")
# the archs whose smoke config keeps its own head dims on the card (32; MLA
# 24 / 16: the wrapper pads them to the kernel's 64); the older six run at
# head_dim 64, as before the pad
LM_OWN_DIMS = ("grok_1_314b", "deepseek_v3_671b", "hubert_xlarge",
               "internvl2_26b")
# (c): stablelm-1.6b at full width, its 24 layers cut to LM_LAYERS so that
# 4 clients' DProx state fits one 80 GB card
LM_LAYERS = 4
_BWD_PARTS = ("flash_bwd_delta_kernel", "flash_bwd_dkv_kernel",
              "flash_bwd_dq_kernel")


# phase 15a's shapes: stablelm's training shape and a long sequence,
# mistral-nemo, gemma2-9b's softcap (global and local layers)
BWD_CASES = [dict(b=16, s=128, h=32, kh=32, d=64),
             dict(b=2, s=2048, h=32, kh=32, d=64),
             dict(b=2, s=512, h=32, kh=8, d=128),
             dict(b=1, s=512, h=16, kh=8, d=256, softcap=50.0),
             dict(b=1, s=512, h=16, kh=8, d=256, softcap=50.0, window=256)]


def _bwd_cases(card: str) -> list:
    """:func:`_bwd_case` at each of :data:`BWD_CASES`, each with its seed."""
    return [_bwd_case(card, seed=500 + i, **c)
            for i, c in enumerate(BWD_CASES)]


def _bwd_grads_err(got, exp) -> float:
    """max over dq, dk, dv of max |got - exp| / max |exp|."""
    return max(float((g.double() - e).abs().max() / e.abs().max())
               for g, e in zip(got, exp))


def _bwd_case(card: str, b, s, h, kh, d, causal=True, window=None,
              softcap=None, seed=0, dv=None):
    """Kernel 5b at one shape (``dv``: v's head dim, default ``d``): against
    the plain version in float64, its controls, and its time beside the
    plain version's, the bound and SDPA's backward (where it computes the
    same function)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = LOGIT_STD ** 0.5
    dv = dv or d
    q, k, v = (torch.randn((b, s, n, w), generator=gen, device="cuda") * f
               for n, w, f in ((h, d, sd), (kh, d, sd), (kh, dv, 1.0)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.flash_attention_bshd(q, k, v, with_lse=True, **kw)
    do = torch.randn(out.shape, generator=gen, device="cuda")

    def kern():
        return fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)

    got = kern()
    torch.cuda.synchronize()
    dims = d if dv == d else f"{d}/{dv}"
    where = (f"{(b, s, h, kh, dims)} causal={causal} window={window} "
             f"softcap={softcap}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"flash bwd {where}: non-finite gradient")
    f64 = [t.double() for t in (q, k, v, out, do)]
    exp = fa.flash_attention_backward_plain(*f64, **kw)
    err = _bwd_grads_err(got, exp)
    check(err <= BWD_TOL, f"flash bwd kernel != plain (f64) at {where}: "
          f"{err:.3e} of max |grad| > {BWD_TOL}")
    controls = {}
    if softcap is not None:
        controls["softcap dropped"] = dict(kw, softcap=None)
    if causal and window is not None:
        for w in (window - 32, window + 32):
            controls[f"window {w}"] = dict(kw, window=w)
    controls["causal flipped"] = dict(kw, causal=not causal)
    ctl = {}
    for name, ckw in controls.items():
        ctl[name] = _bwd_grads_err(
            fa.flash_attention_backward_plain(*f64, **ckw), exp)
        check(ctl[name] >= CONTROL * BWD_TOL, f"flash bwd control at "
              f"{where}: {name} moves the plain gradients by only "
              f"{ctl[name]:.3e} < {CONTROL} x {BWD_TOL}")
        torch.cuda.empty_cache()
    del f64, exp
    torch.cuda.empty_cache()
    ms = _time_ms(kern, 5, 3)
    plain_ms = _time_ms(lambda: fa.flash_attention_backward_plain(
        q, k, v, out, do, lse, **kw), 3, 1)
    recs = {n: t for n, t in _profile_kernels(kern, 5).items()
            if any(p in n for p in _BWD_PARTS)}
    device_ms = sum(recs.values()) / 5 if recs else None
    library_ms = library_device_ms = lib_err = None
    if softcap is None and (window is None or not causal):
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=h != kh)
        dot = do.transpose(1, 2).contiguous()

        def lib():
            return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib_err = _bwd_grads_err([x.transpose(1, 2) for x in lib()], got)
        check(lib_err <= LIB_BWD_TOL, f"SDPA's backward disagrees with the "
              f"kernel at {where} by {lib_err:.3e}")
        library_ms = _time_ms(lib, 5, 3)
        library_device_ms = _device_ms(lib, 5) or None
        del qt, kt, vt, lib_out, dot
    pairs = _admitted_pairs(s, causal, window)
    # QK^T and dP = dO V^T are recomputed / computed (2 Dk and 2 Dv an
    # admitted pair), dV += P^T dO (2 Dv), dQ += dS K and dK += dS^T Q
    # (2 Dk each): 10 D when Dv = Dk
    flops = (6 * d + 4 * dv) * h * b * pairs
    # read q, k, v, out, dout, lse; write dq, dk, dv
    nbytes = 4 * (b * s * h * (2 * d + 2 * dv) + b * s * kh * (2 * d + 2 * dv)
                  + b * h * s)
    t_ops, t_bytes = flops / SPLIT_TF32_OPS, nbytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    row = {"kernel": "flash_attention_bwd", "shape": [b, s, h, kh, d],
           "dv": dv, "dtype": "float32", "causal": causal, "window": window,
           "softcap": softcap, "seed": seed, "max_abs_err": max(
               float((g - e).abs().max()) for g, e in zip(got, fa.
               flash_attention_backward_plain(q, k, v, out, do, lse, **kw))),
           "max_rel_err_f64": err, "tol": BWD_TOL, "controls": ctl,
           "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
           "library": "sdpa" if library_ms is not None else None,
           "library_ms": library_ms, "library_device_ms": library_device_ms,
           "library_err": lib_err, "bound_ms": bound_ms,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_ms_fp32_cores": 1e3 * max(flops / PEAK_OPS["float32"],
                                            t_bytes),
           "gflop": flops / 1e9,
           "TFLOP_per_s": flops / ((device_ms or ms) * 1e-3) / 1e12}
    log(f"[lm-a] 5b (B {b}, S {s}, H {h}/{kh}, D {dims}) causal={causal} "
        f"window={window} softcap={softcap}: vs plain f64 {err:.3e} of max "
        f"|grad| (tol {BWD_TOL}), controls "
        + ", ".join(f"{n} {c:.3e}" for n, c in ctl.items())
        + f"; kernel {ms:.4f} ms (device "
        f"{'%.4f ms' % device_ms if device_ms else 'not measured'}, "
        f"{row['TFLOP_per_s']:.2f} TFLOP/s), bound {bound_ms:.4f} ms "
        f"({row['bound_by']}; {row['bound_ms_fp32_cores']:.4f} at 67 "
        f"TFLOP/s f32), plain {plain_ms:.4f} ms, SDPA backward "
        + (f"{library_ms:.4f} ms (device "
           f"{'%.4f ms' % library_device_ms if library_device_ms else 'not measured'})"
           if library_ms is not None else "n/a")
        + f"  [{card}]")
    del q, k, v, out, lse, do, got
    torch.cuda.empty_cache()
    return row


def _lm_args(*extra):
    from repro_torch.launch import train as TR

    return TR.parser().parse_args(list(extra))


def _lm_smoke(card: str, arch: str) -> dict:
    """(b) one smoke config through the trainer's set-up on the card and on
    the CPU port, round by round: train_loss and x_bar compared."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree as tu

    smoke = registry.get_smoke(arch)
    # mamba2 attends nowhere
    attn = (smoke.attn if smoke.attn is None or arch in LM_OWN_DIMS
            else dataclasses.replace(smoke.attn, head_dim=64))
    cfg = smoke.with_overrides(param_dtype=torch.float32, attn=attn)
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    rounds, tau = 4, 2
    traj = {}
    for device in ("cuda", "cpu"):
        def go(device=device):
            if cfg.frontend is not None:
                return _lm_rounds(cfg, params, device, rounds, tau)
            args = _lm_args("--device", device, "--clients", "2", "--tau",
                            str(tau), "--rounds", str(rounds))
            run = TR.build(args, cfg=cfg, params=params)
            rng = np.random.default_rng(args.seed)
            state, losses, xbars = run.state, [], []
            for r in range(rounds):
                state, m = run.engine.run(state, run.supplier, 1, rng=rng,
                                          start_round=r)
                losses.append(m["train_loss"][0])
                xbars.append(tu.tree_map(lambda x: x.detach().cpu(),
                                         state.x_bar))
            run.close()
            return losses, xbars

        reset_counts()
        traj[device] = go() if device == "cuda" else _cpu_run(go)
        if device == "cuda":
            counts = read_counts()
            n = _attn_layers(cfg) * tau * rounds
            rows = (4 * 64 if cfg.frontend is not None
                    else TR.parser().get_default("batch")
                    * TR.parser().get_default("seq"))
            n_gemm = (3 * _dense_products(cfg, head=True, rows=rows) * tau
                      * rounds)
            check(counts == _expect(flash_attentions=n, flash_attention_bwds=n,
                                    fused_local_updates=tau * rounds,
                                    split_gemms=n_gemm),
                  f"lm (b) {arch}: launches {counts}, expected {n} of "
                  f"kernels 5 and 5b, {n_gemm} of the split GEMM")
    (lg, xg), (lc, xc) = traj["cuda"], traj["cpu"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    xbar_gap = max(
        max(float((a - b).abs().max()) for a, b in
            zip(tu.tree_leaves(ga), tu.tree_leaves(ca)))
        / max(float(b.abs().max()) for b in tu.tree_leaves(ca))
        for ga, ca in zip(xg, xc))
    check(loss_gap <= LM_LOSS_RTOL, f"lm (b) {arch}: card vs cpu train_loss "
          f"rel gap {loss_gap:.3e} > {LM_LOSS_RTOL}")
    check(xbar_gap <= LM_XBAR_TOL, f"lm (b) {arch}: card vs cpu x_bar gap "
          f"{xbar_gap:.3e} of max |x_bar| > {LM_XBAR_TOL}")
    hd = ("no attention" if cfg.attn is None
          else "MLA, Dk 24 / Dv 16" if cfg.attn.kind == "mla"
          else f"head_dim {cfg.attn.head_dim}")
    how = ("core.algorithm's round on specs.train_batches"
           if cfg.frontend is not None else "the trainer's set-up")
    log(f"[lm-b] {cfg.name} ({hd}; {how}), 2 clients, tau {tau}, {rounds} "
        f"rounds: card vs cpu train_loss rel gap {loss_gap:.3e} (tol "
        f"{LM_LOSS_RTOL}), x_bar gap {xbar_gap:.3e} of max |x_bar| (tol "
        f"{LM_XBAR_TOL}); losses {[round(x, 6) for x in lg]}; launches "
        f"{counts}  [{card}]")
    return {"arch": arch, "loss_rel_gap": loss_gap, "xbar_rel_gap": xbar_gap,
            "train_loss_card": lg, "train_loss_cpu": lc, "launches": counts}


def _lm_rounds(cfg, params, device: str, rounds: int, tau: int):
    """A front-end smoke config (hubert, internvl2) trained through
    ``core.algorithm``'s round function on ``launch.specs.train_batches``
    (the reference's ``launch/train.py`` makes token streams only, so its
    tests/test_arch_smoke.py trains them so): DProx, 2 clients, L1 1e-5,
    eta 1e-3, eta_g 2, one batch of 2 x 64 positions per client from seed
    ``r`` in round ``r``.  Returns (losses, x_bar on the CPU per round)."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import algorithm as talg
    from repro_torch.core.prox import L1
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree as tu

    fn = talg.make_round_fn(talg.DProxConfig(tau=tau, eta=1e-3, eta_g=2.0),
                            L1(lam=1e-5), T.make_grad_fn(cfg))
    state = talg.init_state(tu.tree_map(lambda x: x.to(device), params), 2)
    losses, xbars = [], []
    for r in range(rounds):
        batches = specs.train_batches(cfg, InputShape("smoke", "train", 64, 4),
                                      2, tau, seed=r, device=device)
        state, info = fn(state, batches)
        losses.append(float(info["train_loss"]))
        xbars.append(tu.tree_map(lambda x: x.detach().cpu(), state.x_bar))
    return losses, xbars


def _layer_kinds(cfg) -> list:
    """Every layer's mixer kind, in order (the model's own sequence)."""
    from repro_torch.models import transformer as T

    prefix, pattern, suffix = T._block_sequence(cfg)
    return [k for k, _ in prefix + pattern * cfg.n_periods + suffix]


def _attn_layers(cfg) -> int:
    """The model's attention layers: kernel 5 launches once on each per
    prefill or forward, 5b once on each per backward."""
    return sum(k in ("attn", "local") for k in _layer_kinds(cfg))


def _dense_products(cfg, head: bool, rows: int) -> int:
    """The products with the weights that one forward of ``cfg`` in float32
    on the card over ``rows`` rows (a client's, under ``vmap``) sends to
    the split GEMM (``models/layers._dense``), one launch each: none below
    ``layers.KERNEL_MIN_ROWS`` rows (a decode step); else q, k, v and o of
    an attention layer (not MLA's latent products), a dense MLP's three, an
    MoE layer's shared expert's three (its routed experts stay einsums),
    and the head if its logits are taken over those rows (``head``; a
    serving prefill takes the last position's only).  Under ``vmap(grad)``
    each product is three launches (forward, dX, dW)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    if rows < L.KERNEL_MIN_ROWS:
        return 0
    prefix, pattern, suffix = T._block_sequence(cfg)
    n = int(head)
    for kind, mlp_kind in prefix + pattern * cfg.n_periods + suffix:
        if kind in ("attn", "local") and cfg.attn.kind != "mla":
            n += 4
        if mlp_kind == "dense" or (mlp_kind == "moe" and cfg.moe.num_shared):
            n += 3
    return n


def _lm_full(card: str, extra=(), rounds: int = 8):
    """(c) stablelm-1.6b at full width (depth cut to LM_LAYERS), through the
    trainer's set-up and loop on the card: launches, finite loss, s/round
    after the first chunk, peak memory and one profiled round."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.launch import train as TR

    cfg = registry.get("stablelm_1_6b").with_overrides(
        n_layers=LM_LAYERS, param_dtype=torch.float32)
    args = _lm_args("--rounds", str(rounds), "--log-every", "1", *extra)
    tag = "topk" if args.transport else "dense"
    _free_card()
    held_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases hold
    log(f"[lm-c] {tag}: {held_gb:.2f} GB held by earlier phases")
    _expandable_segments(True)
    t0 = time.perf_counter()
    run = TR.build(args, cfg=cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stamps = []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    copies = _build.COUNTS["split_gemm_copies"]
    t0 = time.perf_counter()
    state, hist = TR.train(run, log=lambda m: stamps.append(
        (time.perf_counter(), m)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = cfg.n_layers * args.tau * rounds
    # the float32 products with the weights: 7 a layer and the tied head,
    # each forward, dX and dW, one launch for all clients
    expect = _expect(flash_attentions=n, flash_attention_bwds=n,
                     fused_local_updates=args.tau * rounds,
                     split_gemms=3 * _dense_products(
                         cfg, head=True, rows=args.batch * args.seq)
                     * args.tau * rounds)
    if args.transport == "topk":
        expect["threshold_selects"] = rounds
    losses = hist["train_loss"]
    check(len(losses) == rounds and all(math.isfinite(x) for x in losses),
          f"lm (c) {tag}: train_loss {losses}")
    check(counts == expect, f"lm (c) {tag}: launches {counts}, expected "
          f"{expect}")
    copied = _build.COUNTS["split_gemm_copies"] - copies
    check(copied == 0, f"lm (c) {tag}: the split GEMM copied {copied} "
          "operands")
    rt = [t for t, m in stamps if m.startswith("round")]
    c = args.chunk
    s_round = (rt[-1] - rt[c - 1]) / (rounds - c) if rounds > c else None
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "n_params": run.n_params, "args": vars(args), "setup_s": setup_s,
           "wall_s": wall, "s_per_round": s_round, "train_loss": losses,
           "launches": counts, "peak_gb": peak_gb, "held_before_gb": held_gb,
           "copies_per_local_step": (counts["fused_local_update_copies"]
                                     / (args.tau * rounds))}
    log(f"[lm-c] {cfg.name} {tag}: {run.n_params:,} params, 4 clients x "
        f"batch 4 x seq 128, tau {args.tau}, {rounds} rounds in {wall:.2f} s "
        f"(set-up {setup_s:.2f} s); "
        f"{'%.4f' % s_round if s_round else 'n/a'} s/round after the first "
        f"chunk; peak {peak_gb:.2f} GB ({held_gb:.2f} GB held before); "
        f"losses "
        f"{[round(x, 4) for x in losses]}; launches {counts}; kernel-1 "
        f"copies per local step {out['copies_per_local_step']:g}  [{card}]")
    # one profiled round
    rng = np.random.default_rng(1)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        state, _ = run.engine.run(state, run.supplier, 1, rng=rng,
                                  start_round=rounds)
        end.record()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    round_ms = start.elapsed_time(end)
    busy = sum(by_name.values())
    fwd = sum(v for k_, v in by_name.items() if "flash_tf32" in k_)
    bwd = sum(v for k_, v in by_name.items()
              if any(p in k_ for p in _BWD_PARTS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["profile"] = {
        "round_ms": round_ms, "device_busy_ms": busy,
        "idle_share": (1 - busy / round_ms) if busy else None,
        "flash_fwd_ms": fwd, "flash_bwd_ms": bwd,
        "flash_fwd_share": fwd / busy if busy else None,
        "flash_bwd_share": bwd / busy if busy else None,
        "top_kernels_ms": top}
    log(f"[lm-c] one profiled round: {round_ms:.2f} ms, device busy "
        f"{busy:.2f} ms (idle share "
        f"{(1 - busy / round_ms) if busy else float('nan'):.3f}); "
        f"kernel 5 {fwd:.3f} ms, 5b {bwd:.3f} ms (shares of busy "
        f"{fwd / busy if busy else float('nan'):.4f}, "
        f"{bwd / busy if busy else float('nan'):.4f})  [{card}]")
    for name, ms in top:
        log(f"[lm-c]   {ms:9.3f} ms  {name[:100]}")
    del run, state
    _free_card()
    _expandable_segments(False)
    return out


def _free_card() -> None:
    """Collect the engine's reference cycles (their tensors go only with
    the cycle) and hand the allocator's cached blocks back."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _expandable_segments(on: bool) -> None:
    """The caching allocator's expandable segments, for the full-width runs
    only: their client-width buffers (6.6 GB each) are freed and reused at
    smaller sizes every local step, and with fixed segments the pool
    fragmented after the earlier phases until a 6.1 GB request failed with
    19-25 GB reserved and unused (H100 80GB HBM3)."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings(
            f"expandable_segments:{'True' if on else 'False'}")


def _lm_cli(card: str) -> dict:
    """(d) the trainer's command line in a subprocess on the card."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--scale",
           "100m", "--rounds", "4", "--tau", "2", "--clients", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-3:]
    check(proc.returncode == 0, f"lm (d): {' '.join(cmd[1:])} exited "
          f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    check(any(line.startswith("done: final loss") for line in tail),
          f"lm (d): no final loss line in {tail}")
    log(f"[lm-d] python {' '.join(cmd[1:])}: exit 0 in {secs:.1f} s; "
        + " | ".join(tail) + f"  [{card}]")
    return {"cmd": cmd[1:], "seconds": secs, "tail": tail}


def phase_lm(card: str) -> dict:
    """Phase 15: federated LM training (see the module docstring)."""
    import torch

    from repro_torch import device as dev

    t0 = time.perf_counter()
    rows = _bwd_cases(card)
    # the model turns TF32 off itself: run (b) with PyTorch's TF32 allowed
    with dev.full_fp32():
        check(not torch.backends.cudnn.allow_tf32
              and torch.get_float32_matmul_precision() == "highest",
              "lm: TF32 is on inside device.full_fp32")
    tf32 = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        smoke = {arch: _lm_smoke(card, arch) for arch in LM_ARCHS}
    finally:
        torch.set_float32_matmul_precision(tf32)
    full = _lm_full(card)
    topk = _lm_full(card, ("--transport", "topk", "--compress-ratio", "0.1",
                           "--granularity", "global", "--plane"), rounds=4)
    cli = _lm_cli(card)
    secs = time.perf_counter() - t0
    log(f"[lm] phase 15 in {secs:.1f} s  [{card}]")
    return {"bwd_cases": rows, "smoke": smoke, "full": full, "topk": topk,
            "cli": cli, "seconds": secs}


# -- phase 16 -----------------------------------------------------------------

# (a): card vs CPU port in float32 at full width, per model: logits within
# ZOO_TOL x max |logit|, every cache leaf within ZOO_TOL x its own max |.|
ZOO_TOL = 1e-4
# (b): the models at full width and depth in bf16, each with its prompt
# lengths (the first is profiled), the generate batch's prompt length,
# max_len and new tokens per request
ZOO_FULL = [
    dict(arch="recurrentgemma_9b", lens=(4096, 1024, 640), gen_len=1024,
         max_len=8192),
    dict(arch="phi3_medium_14b", long_context=True, lens=(12288, 2048, 700),
         gen_len=1024, max_len=16384),
    dict(arch="mamba2_130m", lens=(4096, 1024, 640), gen_len=1024,
         max_len=8192),
]
ZOO_NEW = 16
# (c): kernel 5 at the new prefill shapes (bf16, causal): recurrentgemma-9b's
# local layers, phi3-medium-14b under its long-context variant and at full
# attention
ZOO_FLASH_CASES = [
    dict(b=1, s=4096, h=16, kh=1, d=256, dtype="bfloat16", window=2048),
    # the dense plain version's (40, S, S) float32 logits do not fit
    dict(b=1, s=12288, h=40, kh=10, d=128, dtype="bfloat16", window=8192,
         plain="blocked"),
    dict(b=1, s=4096, h=40, kh=10, d=128, dtype="bfloat16")]
# the port's plain-PyTorch recurrences, timed inside a profiled prefill
# (each wrapped in a profiler range while it runs)
ZOO_RANGES = ("_rglru_scan", "ssd_chunked_with_state")


def _zoo_cfg(arch: str, long_context: bool = False, **over):
    from repro_torch.configs import registry

    cfg = registry.get(arch).with_overrides(**over)
    return cfg.long_context_variant() if long_context else cfg


def _named_leaves(tree, prefix=""):
    """[(path, tensor)] of a cache tree in the reference's (sorted) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _named_leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _zoo_card_vs_cpu(card: str, tag: str, cfg) -> dict:
    """16a, one model: prefill and 8 teacher-forced decode steps on the
    card and on the CPU port from one seed's params, float32."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.utils import tree as tu

    steps, s_prompt, max_len = 8, 160, 256
    t0 = time.perf_counter()
    params_cpu = T.init_model(torch.Generator().manual_seed(0), cfg)
    params = tu.tree_map(lambda x: x.to("cuda"), params_cpu)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(16)
    prompts = rng.integers(0, cfg.vocab, (2, s_prompt + steps),
                           dtype=np.int32)
    n_flash = _attn_layers(cfg)
    reset_counts()
    got, caches = _teacher_forced(params, cfg, prompts, steps, max_len)
    torch.cuda.synchronize()
    counts = read_counts()
    # the prefill's products; decode none
    n_gemm = _dense_products(cfg, head=False, rows=2 * s_prompt)
    check(counts == _expect(flash_attentions=n_flash, split_gemms=n_gemm),
          f"16a {tag}: launches {counts}, expected {n_flash} flash launches "
          f"(one per attention layer of one prefill) and {n_gemm} split "
          "GEMM (the prefill's products)")
    before = read_counts()
    t0 = time.perf_counter()
    exp, caches_cpu = _teacher_forced(params_cpu, cfg, prompts, steps,
                                      max_len)
    cpu_s = time.perf_counter() - t0
    check(read_counts() == before, "the CPU run launched a kernel")
    scale = max(float(e.abs().max()) for e in exp)
    errs = [float((g - e).abs().max()) for g, e in zip(got, exp)]
    tol = ZOO_TOL * scale
    check(all(math.isfinite(e) for e in errs) and max(errs) <= tol,
          f"16a {tag}: card vs CPU logits differ by {max(errs):.3e} > "
          f"{tol:.3e} (per step {errs})")
    cache_errs = {}
    for (name, a), (_, c) in zip(_named_leaves(caches),
                                 _named_leaves(caches_cpu)):
        c_max = float(c.abs().max())
        err = float((a.float().cpu() - c.float()).abs().max())
        cache_errs[name] = err / c_max if c_max > 0 else err
        check(math.isfinite(err) and err <= ZOO_TOL * c_max,
              f"16a {tag}: card vs CPU cache {name} differs by {err:.3e} > "
              f"{ZOO_TOL} x max|cache| {c_max:.3e}")
    worst = max(cache_errs, key=cache_errs.get)
    log(f"[zoo-16a] {tag} ({cfg.name}, f32, {T.count_params(params):,} "
        f"params): 2 x {s_prompt}-token prompts + {steps} teacher-forced "
        f"steps: max |logit| {scale:.4f}, card vs CPU {max(errs):.3e} (tol "
        f"{ZOO_TOL} x max|logit| = {tol:.3e}; prefill {errs[0]:.3e}, decode "
        f"{max(errs[1:]):.3e}); caches, each leaf over its max: worst "
        f"{cache_errs[worst]:.3e} ({worst}; tol {ZOO_TOL}); launches "
        f"{n_flash} flash; init {init_s:.1f} s, CPU run {cpu_s:.1f} s  "
        f"[{card}]")
    del params, params_cpu, caches, caches_cpu
    _free_card()
    return {"model": tag, "arch": cfg.name, "launches": counts,
            "max_abs_diff": max(errs), "tol": tol, "max_abs_logit": scale,
            "errs": errs, "cache_rel_errs": cache_errs, "init_s": init_s,
            "cpu_s": cpu_s}


def _ranged(name: str, fn):
    """``fn`` inside a profiler range named ``name``."""
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapped


def _profile_with_ranges(fn, sessions: int = 2, names=ZOO_RANGES):
    """One call of ``fn`` profiled (of ``sessions``, the one with the most
    kernel records, as :func:`_profile_kernels`), with each of ``names``
    (functions of ``models/layers``) wrapped in a profiler range while it
    runs.  Returns (device ms by kernel name, {range: (device ms
    of the kernels launched inside it, calls)}, the profiled call's host
    ms ending in a synchronise).  The profiler marks each range on the
    device too, with a span (``zoo/...``) from the range's first kernel to
    its last; a span is not a kernel and is left out of the first, and a
    range's time is the sum of the kernels inside its spans (one stream,
    so they are the range's own).  Two other readings were tried and not
    kept: ``key_averages`` returned the span (with the host's gaps) in one
    run and the kernels in another, and summing each operator's kernels
    down the event tree read the scan 35% above its time alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import layers as L

    fn()
    torch.cuda.synchronize()
    orig = {n: getattr(L, n) for n in names}
    best, best_n, ranges, wall = {}, -1, {}, None
    try:
        for n in names:
            setattr(L, n, _ranged(f"zoo/{n}", orig[n]))
        for _ in range(sessions):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
            by_name, n_rec = {}, 0
            for e in prof.events():
                if (e.device_type == torch.autograd.DeviceType.CUDA
                        and not e.name.startswith("zoo/")):
                    n_rec += 1
                    by_name[e.name] = (by_name.get(e.name, 0.0)
                                       + e.time_range.elapsed_us() / 1e3)
            if n_rec > best_n:
                best, best_n, wall = by_name, n_rec, ms
                ranges = _range_device_ms(prof.events(), "zoo/")
    finally:
        for n, f in orig.items():
            setattr(L, n, f)
    return best, ranges, wall


def _range_device_ms(events, prefix: str) -> dict:
    """{range name less ``prefix``: (ms of the kernels inside its device
    spans, spans)} from a profiler's events: the device-side spans named
    ``prefix...`` and the kernels that start and end within one."""
    import torch

    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in cuda if e.name.startswith(prefix)]
    kernels = [e.time_range for e in cuda if not e.name.startswith(prefix)]
    out = {}
    for sp in spans:
        t0, t1 = sp.time_range.start, sp.time_range.end
        us = sum(k.end - k.start for k in kernels
                 if k.start >= t0 and k.end <= t1)
        name = sp.name[len(prefix):]
        total, n = out.get(name, (0.0, 0))
        out[name] = (total + us, n + 1)
    return {k: (us / 1e3, n) for k, (us, n) in out.items()}


def _standalone_recurrence_ms(cfg, s: int) -> dict:
    """The model's recurrence alone at a B = 1, ``s``-token prefill's shape
    (CUDA events around back-to-back calls, so the host's launch gaps
    count where its kernels are small): the RG-LRU scan at (1, s, width)
    float32, the SSD at (1, s, H, P) with state N; ms of one call and the
    layers that run it."""
    import torch

    from repro_torch.models import layers as L

    kinds = _layer_kinds(cfg)
    gen = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    if cfg.rglru is not None:
        w = cfg.rglru.width or cfg.d_model
        a = torch.rand((1, s, w), generator=gen, device="cuda") * 0.49 + 0.5
        b = torch.randn((1, s, w), generator=gen, device="cuda")
        out["_rglru_scan"] = (_time_ms(lambda: L._rglru_scan(a, b), 3, 2),
                              kinds.count("rec"))
    if cfg.ssm is not None:
        c = cfg.ssm
        x = torch.randn((1, s, c.num_heads, c.head_dim), generator=gen,
                        device="cuda")
        dt = torch.rand((1, s, c.num_heads), generator=gen, device="cuda")
        A = -torch.rand((c.num_heads,), generator=gen, device="cuda") * 15 - 1
        B, C = (torch.randn((1, s, c.state_dim), generator=gen,
                            device="cuda") for _ in range(2))
        D = torch.ones((c.num_heads,), device="cuda")
        out["ssd_chunked_with_state"] = (_time_ms(
            lambda: L.ssd_chunked_with_state(x, dt, A, B, C, D, c.chunk), 3,
            2), kinds.count("ssm"))
    return out


def _zoo_full(card: str, arch: str, lens, gen_len: int, max_len: int,
              long_context: bool = False) -> dict:
    """16b, one model at full width and depth in bf16: generate, then
    continuous batching with mixed prompt lengths; timings and profiles
    outside the counted path."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServingEngine

    cfg = _zoo_cfg(arch, long_context)
    new = ZOO_NEW
    _free_card()
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = T.count_params(params)
    eng = ServingEngine(cfg, params, max_len=max_len, device="cuda")
    rng = np.random.default_rng(16)
    eng.generate(rng.integers(0, cfg.vocab, (1, 64), dtype=np.int32),
                 max_new_tokens=2)  # warm-up: cuBLAS handles, allocator
    prompts = rng.integers(0, cfg.vocab, (2, gen_len), dtype=np.int32)
    reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, n,
                                              dtype=np.int32),
                    max_new_tokens=new) for i, n in enumerate(lens)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_gen = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=new)
    t_serve = time.perf_counter()
    served = eng.serve(reqs, slots=2, segment=8)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = read_counts()
    n_attn = _attn_layers(cfg)
    prefills = 1 + len(reqs)
    check(counts == _expect(flash_attentions=n_attn * prefills),
          f"16b {cfg.name}: launches {counts}, expected {n_attn} flash "
          f"launches per prefill x {prefills} prefills and nothing else")
    check(gen.tokens.shape == (2, new) and np.isfinite(gen.logprobs).all(),
          f"16b {cfg.name} generate: bad shape or non-finite logprobs")
    check([r.id for r in served] == list(range(len(reqs))),
          f"16b {cfg.name} serve: finished {[r.id for r in served]}")
    for r in served:
        check(len(r.tokens) == new and np.isfinite(r.logprobs).all()
              and ((0 <= r.tokens) & (r.tokens < cfg.vocab)).all(),
              f"16b {cfg.name} serve: request {r.id} incomplete or "
              "non-finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    window = (None if cfg.attn is None else
              cfg.window_local if "local" in cfg.block_pattern
              else cfg.attn.window)
    log(f"[zoo-16b] {cfg.name} full width and depth ({cfg.n_layers} layers, "
        f"{n_attn} attending, window {window}, {n_params / 1e9:.3f} B "
        f"params, bf16, init {init_s:.1f} s): generate 2 x {gen_len} + "
        f"{new} in {t_serve - t_gen:.2f} s; serve {len(reqs)} requests "
        f"(prompts {tuple(lens)}, {new} new each) on 2 slots, segment 8, "
        f"max_len {max_len} in {t_end - t_serve:.2f} s; launches {counts}; "
        f"peak {peak_gb:.1f} GB  [{card}]")

    # timings outside the counted path
    prefill_ms = {}
    for n in lens:
        prefill_ms[n], _ = _prefill_ms(params, cfg, 1, n, rng, max_len)
    prefill_ms[f"2x{gen_len}"], (logits, caches, cache_len) = _prefill_ms(
        params, cfg, 2, gen_len, rng, max_len)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._segment(params, caches, tok, cache_len, new, 0.0, [None])
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / new
    decode_busy = sum(_profile_kernels(lambda: eng._segment(
        params, caches, tok, cache_len, 1, 0.0, [None]), 1, 2).values())
    del caches, logits
    log(f"[zoo-16b] {cfg.name} prefill ms (host clock, synchronised, B=1): "
        + ", ".join(f"S={k}: {v:.1f}" for k, v in prefill_ms.items())
        + f"; decode {decode_ms:.2f} ms/token at batch 2, one profiled step "
        f"device busy {decode_busy:.2f} ms (idle share "
        f"{1 - decode_busy / decode_ms:.3f})  [{card}]")
    n = lens[0]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)), device="cuda")
    by_name, ranges, wall = _profile_with_ranges(lambda: T.prefill(
        params, cfg, {"tokens": toks}, max_len=max_len, last_only=True))
    busy = sum(by_name.values())
    flash_ms = sum(v for k, v in by_name.items() if "flash_" in k)
    alone = _standalone_recurrence_ms(cfg, n)
    prof = {"S": n, "device_busy_ms": busy, "flash_ms": flash_ms,
            "flash_share": flash_ms / busy if busy > 0 else None,
            "profiled_ms": wall, "idle_share": 1 - busy / wall,
            "ranges": {k: {"device_ms": ms, "calls": c,
                           "share": ms / busy if busy > 0 else None}
                       for k, (ms, c) in ranges.items()},
            "standalone": {k: {"ms_per_call": ms, "layers": c,
                               "ms_per_prefill": ms * c}
                           for k, (ms, c) in alone.items()},
            "top_kernels_ms": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:8]}
    rec = "; ".join(
        f"{k} {v['device_ms']:.2f} ms device in {v['calls']} calls "
        f"({v['share'] or 0:.3f} of busy)" for k, v in prof["ranges"].items())
    std = "; ".join(
        f"{k} alone {v['ms_per_call']:.3f} ms x {v['layers']} layers = "
        f"{v['ms_per_prefill']:.2f} ms" for k, v in prof["standalone"].items())
    log(f"[zoo-16b] {cfg.name} profiled prefill S={n}: {wall:.2f} ms "
        f"(host clock, synchronised), device busy {busy:.2f} ms (idle share "
        f"{prof['idle_share']:.3f}), flash kernel {flash_ms:.2f} ms "
        f"({prof['flash_share'] or 0:.3f} of busy); {rec or 'no recurrence'}"
        f"{'; ' + std if std else ''}  [{card}]")
    for kname, ms in prof["top_kernels_ms"]:
        log(f"[zoo-16b]   {ms:9.3f} ms  {kname[:110]}")
    del params, eng
    _free_card()
    return {"arch": cfg.name, "launches": counts, "n_params": n_params,
            "n_attn_layers": n_attn, "window": window, "init_s": init_s,
            "generate_s": t_serve - t_gen, "serve_s": t_end - t_serve,
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "decode_step_device_busy_ms": decode_busy,
            "prefill_profile": prof, "peak_gb": peak_gb,
            "serve_tokens": {r.id: r.tokens.tolist() for r in served}}


def phase_zoo(card: str) -> dict:
    """Phase 16: the recurrent and state-space families and phi3 (see the
    module docstring)."""
    import torch

    t0 = time.perf_counter()
    flash = [_flash_case(card, seed=1600 + i,
                         **dict(c, dtype=getattr(torch, c["dtype"])))
             for i, c in enumerate(ZOO_FLASH_CASES)]
    _free_card()
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    f32 = torch.float32
    card_vs_cpu = [
        _zoo_card_vs_cpu(card, "recurrentgemma-9b, one period (rec, rec, "
                         "local), window 96", _zoo_cfg(
                             "recurrentgemma_9b", n_layers=3,
                             suffix_blocks=(), window_local=96,
                             param_dtype=f32)),
        _zoo_card_vs_cpu(card, "phi3-medium-14b, one layer, long-context "
                         "variant at window 96", _zoo_cfg(
                             "phi3_medium_14b", True, n_layers=1,
                             long_window=96, param_dtype=f32)),
        _zoo_card_vs_cpu(card, "mamba2-130m, 24 layers",
                         _zoo_cfg("mamba2_130m", param_dtype=f32)),
    ]
    full = [_zoo_full(card, **c) for c in ZOO_FULL]
    secs = time.perf_counter() - t0
    log(f"[zoo] phase 16 in {secs:.1f} s  [{card}]")
    return {"flash_cases": flash, "card_vs_cpu": card_vs_cpu, "full": full,
            "seconds": secs}


# -- phase 17 -----------------------------------------------------------------

# (c): kernel 5 at the new prefill shapes, bf16: hubert-xlarge (30-s clips
# at 50 frames/s, not causal, D 80), deepseek-v3's MLA prefill (Dk 192 / Dv
# 128, causal; the blocked plain version: 128 heads of (S, S) float32 logits
# several times over would crowd the card), grok-1 (softcap 30)
ZOO2_FLASH_CASES = [
    dict(b=8, s=1500, h=16, kh=16, d=80, dtype="bfloat16", causal=False),
    dict(b=1, s=4096, h=128, kh=128, d=192, dv=128, dtype="bfloat16",
         plain="blocked"),
    dict(b=1, s=4096, h=48, kh=8, d=128, dtype="bfloat16", softcap=30.0)]
# then float32 with the row log-sum-exp (kernel 5) and kernel 5b at the two
# new head dims
ZOO2_F32_CASES = [dict(b=4, s=512, h=16, kh=16, d=80, causal=False),
                  dict(b=4, s=512, h=16, kh=16, d=192, dv=128)]
# (b): full width in bf16, random params from a seed; depth as given
ZOO2_NEW = 16
# the MoE's parts, timed inside a profiled prefill (each wrapped in a
# profiler range while it runs)
MOE_RANGES = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")


class _RouterMargins:
    """While entered, records each MoE router call's smallest top-k margin:
    over tokens, the k-th largest router probability less the (k+1)-th
    (a routing flip between the card and the CPU can only come from a
    margin at the level of their difference)."""

    def __enter__(self):
        from repro_torch.models import layers as L

        self.margins, self._orig = [], L.moe_route
        orig = self._orig

        def route(p, cfg, xf):
            import torch

            out = orig(p, cfg, xf)
            top = torch.topk(out[0], cfg.top_k + 1, dim=-1).values
            self.margins.append(float((top[:, -2] - top[:, -1]).min()))
            return out

        L.moe_route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L

        L.moe_route = self._orig

    @property
    def smallest(self):
        return min(self.margins) if self.margins else None


def _zoo2_card_vs_cpu(card: str, tag: str, cfg, batch, steps: int,
                      max_len: int) -> dict:
    """17a, one model at full width in float32 on a cut: prefill (and
    ``steps`` teacher-forced decode steps) on the card and on the CPU port
    from one seed's params (drawn on the card, copied to the CPU): logits
    within ZOO_TOL x max |logit|, each cache leaf within ZOO_TOL of its
    max; hubert's masked loss at rtol 1e-5; the MoE router's smallest
    top-k margin on each side."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.utils import tree as tu

    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    params_cpu = tu.tree_map(lambda x: x.cpu(), params)
    init_s = time.perf_counter() - t0
    n_params = T.count_params(params)
    on_card = tu.tree_map(lambda x: x.to("cuda"), batch)
    n_flash = _attn_layers(cfg)
    reset_counts()
    with _RouterMargins() as rm_card:
        got, caches = _forced(params, cfg, on_card, steps, max_len)
        torch.cuda.synchronize()
    counts = read_counts()
    # the prefill's products (hubert's logits at every frame; every cut
    # prefills 2 x 160 positions, _zoo2_cases_a); decode none
    n_gemm = _dense_products(cfg, head=not cfg.decode_supported, rows=320)
    check(counts == _expect(flash_attentions=n_flash, split_gemms=n_gemm),
          f"17a {tag}: launches {counts}, expected {n_flash} flash launches "
          f"(one per attention layer of one prefill) and {n_gemm} split "
          "GEMM (the prefill's products)")
    t0 = time.perf_counter()
    with _RouterMargins() as rm_cpu:
        exp, caches_cpu = _cpu_run(lambda: _forced(
            params_cpu, cfg, batch, steps, max_len), threads=0)
    cpu_s = time.perf_counter() - t0
    scale = max(float(e.abs().max()) for e in exp)
    errs = [float((g - e).abs().max()) for g, e in zip(got, exp)]
    tol = ZOO_TOL * scale
    margins = {"card": rm_card.smallest, "cpu": rm_cpu.smallest}
    check(all(math.isfinite(e) for e in errs) and max(errs) <= tol,
          f"17a {tag}: card vs CPU logits differ by {max(errs):.3e} > "
          f"{tol:.3e} (per step {errs}; smallest router top-k margin "
          f"{margins})")
    cache_errs = {}
    for (name, a), (_, c) in zip(_named_leaves(caches),
                                 _named_leaves(caches_cpu)):
        c_max = float(c.abs().max())
        err = float((a.float().cpu() - c.float()).abs().max())
        cache_errs[name] = err / c_max if c_max > 0 else err
        check(math.isfinite(err) and err <= ZOO_TOL * c_max,
              f"17a {tag}: card vs CPU cache {name} differs by {err:.3e} > "
              f"{ZOO_TOL} x max|cache| {c_max:.3e}")
    worst = max(cache_errs, key=cache_errs.get)
    loss = None
    if cfg.frontend == "audio":
        reset_counts()
        got_l = float(T.loss_fn(params, cfg, on_card))
        check(read_counts() == _expect(flash_attentions=n_flash,
                                       split_gemms=n_gemm),
              f"17a {tag}: loss launches {read_counts()}")
        exp_l = float(_cpu_run(lambda: T.loss_fn(params_cpu, cfg, batch),
                               threads=0))
        check(abs(got_l - exp_l) <= 1e-5 * abs(exp_l), f"17a {tag}: masked "
              f"loss card {got_l} vs CPU {exp_l}")
        loss = {"card": got_l, "cpu": exp_l}
        counts = {k: v + {"flash_attentions": n_flash,
                          "split_gemms": n_gemm}.get(k, 0)
                  for k, v in counts.items()}
    log(f"[zoo-17a] {tag} ({cfg.name}, f32, {n_params:,} params): "
        f"{len(got) - 1} teacher-forced steps after the prefill: max |logit| "
        f"{scale:.4f}, card vs CPU {max(errs):.3e} (tol {ZOO_TOL} x "
        f"max|logit| = {tol:.3e}; per step "
        + ", ".join(f"{e:.2e}" for e in errs)
        + f"); caches, each leaf over its max: worst {cache_errs[worst]:.3e} "
        f"({worst}; tol {ZOO_TOL})"
        + (f"; masked loss card {loss['card']:.7f} CPU {loss['cpu']:.7f}"
           if loss else "")
        + (f"; smallest router top-k margin card {margins['card']:.3e}, "
           f"CPU {margins['cpu']:.3e}" if margins["card"] is not None
           else "")
        + f"; launches {n_flash} flash a pass; init {init_s:.1f} s, CPU run "
        f"{cpu_s:.1f} s  [{card}]")
    del params, params_cpu, caches, caches_cpu, on_card
    _free_card()
    return {"model": tag, "arch": cfg.name, "n_params": n_params,
            "launches": counts, "max_abs_diff": max(errs), "tol": tol,
            "max_abs_logit": scale, "errs": errs,
            "cache_rel_errs": cache_errs, "loss": loss,
            "router_min_topk_margin": margins, "init_s": init_s,
            "cpu_s": cpu_s}


def _zoo2_cases_a() -> list:
    """17a's four cuts: (tag, config, CPU batch, decode steps, max_len)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch import specs
    from repro_torch.models.layers import MoECfg

    f32 = torch.float32
    rng = np.random.default_rng(17)
    hub = _zoo_cfg("hubert_xlarge", n_layers=2, param_dtype=f32)
    ivl = _zoo_cfg("internvl2_26b", n_layers=1, param_dtype=f32)
    grok = _zoo_cfg("grok_1_314b", n_layers=1, param_dtype=f32)
    grok = grok.with_overrides(moe=dataclasses.replace(grok.moe,
                                                       d_ff_expert=4096))
    ds = _zoo_cfg("deepseek_v3_671b", n_layers=2, prefix_blocks=("attn",),
                  param_dtype=f32)
    ds = ds.with_overrides(moe=dataclasses.replace(ds.moe, num_experts=16))
    hub_b = specs.example(hub, 2, 160, seed=17, device="cpu")
    ivl_b = {"patches": torch.from_numpy(rng.normal(size=(2, 40, 3200)).astype(
                 np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, ivl.vocab, (2, 128),
                                                     dtype=np.int32))}

    def toks(cfg):
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, 168), dtype=np.int32))}

    return [("hubert-xlarge, 2 of 48 layers, features (2, 160, 512), masked "
             "loss", hub, hub_b, 0, 160),
            ("internvl2-26b, 1 layer, patches (2, 40, 3200) + 120 tokens",
             ivl, ivl_b, 8, 256),
            ("grok-1-314b, 1 layer, d_ff_expert 4096 of 32768", grok,
             toks(grok), 8, 256),
            ("deepseek-v3-671b, 1 dense MLA layer + 1 MLA/MoE layer, 16 of "
             "256 experts (top-8, shared expert)", ds, toks(ds), 8, 256)]


def _zoo2_profile(card, params, cfg, batch, max_len) -> dict:
    """One profiled prefill of ``batch``: device busy, idle share, kernel
    5's share and the MoE's parts inside profiler ranges."""
    from repro_torch.models import transformer as T

    by_name, ranges, wall = _profile_with_ranges(lambda: T.prefill(
        params, cfg, batch, max_len=max_len, last_only=True),
        names=MOE_RANGES if cfg.moe is not None else ())
    busy = sum(by_name.values())
    flash_ms = sum(v for k, v in by_name.items() if "flash_" in k)
    prof = {"device_busy_ms": busy, "flash_ms": flash_ms,
            "flash_share": flash_ms / busy if busy > 0 else None,
            "profiled_ms": wall, "idle_share": 1 - busy / wall,
            "ranges": {k: {"device_ms": ms, "calls": c,
                           "share": ms / busy if busy > 0 else None}
                       for k, (ms, c) in ranges.items()},
            "top_kernels_ms": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:8]}
    rng_txt = "; ".join(
        f"{k} {v['device_ms']:.2f} ms device in {v['calls']} calls "
        f"({v['share'] or 0:.3f} of busy)" for k, v in prof["ranges"].items())
    log(f"[zoo-17b] {cfg.name} profiled prefill: {wall:.2f} ms (host clock, "
        f"synchronised), device busy {busy:.2f} ms (idle share "
        f"{prof['idle_share']:.3f}), flash kernel {flash_ms:.2f} ms "
        f"({prof['flash_share'] or 0:.3f} of busy)"
        + (f"; {rng_txt}" if rng_txt else "") + f"  [{card}]")
    for kname, ms in prof["top_kernels_ms"]:
        log(f"[zoo-17b]   {ms:9.3f} ms  {kname[:110]}")
    return prof


def _zoo2_full(card: str, arch: str, n_layers=None, lens=(), gen_len=1024,
               **kw) -> dict:
    """17b, one model at full width in bf16 (depth ``n_layers`` when cut):
    hubert encodes a batch of 30-s clips; internvl2 generates over patches
    and text; grok and deepseek prefill prompts of ``lens`` and generate 2
    x ``gen_len`` + ZOO2_NEW; at lossless capacity grok's greedy serve
    equals its sequential generate, deepseek's is recorded beside it.
    Peak memory, prefill ms per prompt,
    decode ms per token and one profiled prefill."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServingEngine

    over = {} if n_layers is None else {"n_layers": n_layers}
    if arch == "deepseek_v3_671b":
        over["prefix_blocks"] = ("attn",) * min(3, n_layers - 1)
    cfg = _zoo_cfg(arch, **over)
    new = ZOO2_NEW
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = T.count_params(params)
    n_attn = _attn_layers(cfg)
    rng = np.random.default_rng(17)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "n_params": n_params,
           "init_s": init_s, "init_peak_gb": init_peak_gb,
           "n_attn_layers": n_attn}
    max_len = kw.get("max_len", 4096 + 1024)
    if cfg.frontend == "audio":
        batch = specs.example(cfg, 8, 1500, seed=17, device="cuda")
        with torch.no_grad():
            T.forward(params, cfg, batch)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            logits, _, _ = T.forward(params, cfg, batch)
            torch.cuda.synchronize()
            enc_ms = 1e3 * (time.perf_counter() - t0)
        counts = read_counts()
        check(counts == _expect(flash_attentions=n_attn), f"17b {cfg.name}: "
              f"launches {counts}, expected {n_attn} flash")
        check(logits.shape == (8, 1500, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"17b {cfg.name}: bad or non-finite logits")
        try:
            ServingEngine(cfg, params, device="cuda")
            check(False, f"17b {cfg.name}: the serving engine took it")
        except ValueError as e:
            refusal = str(e)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        enc_ms_ev = _time_ms(lambda: T.forward(params, cfg, batch), 3, 1)
        out.update(launches=counts, encode_ms=enc_ms,
                   encode_ms_events=enc_ms_ev, peak_gb=peak_gb,
                   serve_refusal=refusal)
        log(f"[zoo-17b] {cfg.name} ({cfg.n_layers} layers, {n_params / 1e9:.3f}"
            f" B params, bf16, init {init_s:.1f} s): encode (8, 1500) frames "
            f"in {enc_ms:.1f} ms (host clock; {enc_ms_ev:.1f} ms CUDA events)"
            f", launches {counts}, peak {peak_gb:.1f} GB (init peak "
            f"{init_peak_gb:.1f} GB); the serving engine refuses it: "
            f"{refusal!r}  [{card}]")
        with torch.no_grad():
            out["prefill_profile"] = _zoo2_profile(card, params, cfg, batch,
                                                   1500)
        del params, batch, logits
        _free_card()
        return out

    eng = ServingEngine(cfg, params, max_len=max_len, device="cuda")
    if cfg.frontend == "vision":
        s_img, s_txt = 1024, 3072
        patches = torch.randn((2, s_img, cfg.frontend_dim), device="cuda",
                              generator=torch.Generator(device="cuda")
                              .manual_seed(17)).to(torch.bfloat16)
        prompts = rng.integers(0, cfg.vocab, (2, s_txt), dtype=np.int32)
        extra = {"patches": patches}
        eng.generate(prompts[:, :64], max_new_tokens=2,
                     extra_inputs={"patches": patches[:, :16]})  # warm-up
    else:
        prompts = rng.integers(0, cfg.vocab, (2, gen_len), dtype=np.int32)
        extra = None
        eng.generate(prompts[:, :64], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=new, extra_inputs=extra)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts == _expect(flash_attentions=n_attn), f"17b {cfg.name}: "
          f"launches {counts}, expected {n_attn} flash (one prefill)")
    check(gen.tokens.shape == (2, new) and np.isfinite(gen.logprobs).all()
          and ((0 <= gen.tokens) & (gen.tokens < cfg.vocab)).all(),
          f"17b {cfg.name} generate: bad shape, ids or non-finite logprobs")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out.update(launches=counts, generate_s=gen_s, peak_gb=peak_gb)
    shape = (f"2 x ({s_img} patches + {s_txt} tokens)" if extra
             else f"2 x {gen_len}")
    log(f"[zoo-17b] {cfg.name} full width ({cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B params, bf16, init {init_s:.1f} s, init peak"
        f" {init_peak_gb:.1f} GB): generate {shape} + {new} in {gen_s:.2f} s;"
        f" launches {counts}; peak {peak_gb:.1f} GB  [{card}]")

    # greedy serve against sequential generate at lossless capacity: grok
    # bitwise; deepseek (MLA) recorded -- the absorbed decode's products
    # round differently at batch 2 and 1 (the reference leaves MLA out of
    # its bitwise batched-decode parity), so a token may flip on a near tie
    if cfg.moe is not None:
        m = cfg.moe
        lossless = cfg.with_overrides(moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k + 0.1))
        leng = ServingEngine(lossless, params, max_len=max_len,
                             device="cuda")
        reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, n,
                                                  dtype=np.int32),
                        max_new_tokens=m_) for i, (n, m_) in
                enumerate(((700, 12), (300, 9), (520, 12)))]
        reset_counts()
        served = leng.serve(reqs, slots=2, segment=4)
        torch.cuda.synchronize()
        n_flash = n_attn * len(reqs)
        check(read_counts() == _expect(flash_attentions=n_flash),
              f"17b {cfg.name} serve: launches {read_counts()}, expected "
              f"{n_flash}")
        diffs, lp_gap = [], 0.0
        for r in served:
            seq = leng.generate(reqs[r.id].prompt[None, :],
                                max_new_tokens=reqs[r.id].max_new_tokens)
            check(len(r.tokens) == len(seq.tokens[0])
                  and np.isfinite(r.logprobs).all(), f"17b {cfg.name} "
                  f"serve: request {r.id} incomplete or non-finite")
            same = r.tokens == seq.tokens[0]
            diffs.append(int((~same).sum()))
            upto = int(np.argmin(same)) if not same.all() else len(same)
            if upto:  # logprobs along the common prefix
                lp_gap = max(lp_gap, float(np.abs(
                    r.logprobs[:upto] - seq.logprobs[0][:upto]).max()))
        if arch == "grok_1_314b":
            check(not any(diffs), f"17b {cfg.name}: greedy serve differs "
                  f"from sequential generate at lossless capacity: {diffs}")
        out["serve_vs_generate"] = {"requests": len(reqs),
                                    "differing_tokens": diffs,
                                    "max_logprob_diff": lp_gap,
                                    "launches": n_flash}
        out["launches"] = {k: v + (n_flash if k == "flash_attentions" else 0)
                           for k, v in out["launches"].items()}
        log(f"[zoo-17b] {cfg.name} lossless capacity (cf "
            f"{lossless.moe.capacity_factor}): serve 3 requests (2 slots, "
            f"segment 4) against sequential generate: differing tokens "
            f"{diffs}, max logprob difference on the common prefix "
            f"{lp_gap:.3e} ({'held bitwise' if arch == 'grok_1_314b' else 'recorded'}); "
            f"{n_flash} flash launches  [{card}]")
        del leng

    # timings outside the counted path
    prefill_ms = {}
    if extra:
        b1 = {"tokens": torch.as_tensor(prompts[:1], device="cuda"),
              "patches": patches[:1]}
        prefill_ms[f"{s_img}+{s_txt}"], _ = _batch_prefill_ms(params, cfg, b1,
                                                             max_len)
        b2 = {"tokens": torch.as_tensor(prompts, device="cuda"),
              "patches": patches}
        key = f"2x({s_img}+{s_txt})"
        prof_batch = b1
    else:
        for n in lens:
            b1 = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                                            device="cuda")}
            prefill_ms[n], _ = _batch_prefill_ms(params, cfg, b1, max_len)
        b2 = {"tokens": torch.as_tensor(prompts, device="cuda")}
        key = f"2x{gen_len}"
        prof_batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (1, lens[0])), device="cuda")}
    prefill_ms[key], (logits, caches, cache_len) = _batch_prefill_ms(
        params, cfg, b2, max_len)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._segment(params, caches, tok, cache_len, new, 0.0, [None])
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / new
    decode_busy = sum(_profile_kernels(lambda: eng._segment(
        params, caches, tok, cache_len, 1, 0.0, [None]), 1, 2).values())
    del caches, logits
    log(f"[zoo-17b] {cfg.name} prefill ms (host clock, synchronised): "
        + ", ".join(f"S={k}: {v:.1f}" for k, v in prefill_ms.items())
        + f"; decode {decode_ms:.2f} ms/token at batch 2, one profiled step "
        f"device busy {decode_busy:.2f} ms (idle share "
        f"{1 - decode_busy / decode_ms:.3f})  [{card}]")
    out.update(prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
               decode_step_device_busy_ms=decode_busy,
               prefill_profile=_zoo2_profile(card, params, cfg, prof_batch,
                                             max_len))
    del params, eng
    _free_card()
    return out


def phase_zoo2(card: str) -> dict:
    """Phase 17: the rest of the zoo (see the module docstring)."""
    import torch

    t0 = time.perf_counter()
    _free_card()
    flash = [_flash_case(card, seed=1700 + i,
                         **dict(c, dtype=getattr(torch, c["dtype"])))
             for i, c in enumerate(ZOO2_FLASH_CASES)]
    flash += [_flash_case(card, seed=1710 + i, dtype=torch.float32, **c)
              for i, c in enumerate(ZOO2_F32_CASES)]
    bwd = [_bwd_case(card, seed=1720 + i, **c)
           for i, c in enumerate(ZOO2_F32_CASES)]
    _free_card()
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    card_vs_cpu = [_zoo2_card_vs_cpu(card, *c) for c in _zoo2_cases_a()]
    full = [_zoo2_full(card, "hubert_xlarge"),
            _zoo2_full(card, "internvl2_26b", max_len=4096 + 64),
            _zoo2_full(card, "grok_1_314b", n_layers=4, lens=(4096, 1024)),
            _zoo2_full(card, "deepseek_v3_671b", n_layers=4,
                       lens=(4096, 1024))]
    secs = time.perf_counter() - t0
    log(f"[zoo2] phase 17 in {secs:.1f} s  [{card}]")
    return {"flash_cases": flash, "bwd_cases": bwd,
            "card_vs_cpu": card_vs_cpu, "full": full, "seconds": secs}


# -- phase 18 -----------------------------------------------------------------

TUNE_ROUNDS = 16  # measured rounds of a trial (a halving re-measure: 32)


def _tune_expect(point, workload, rounds: int) -> dict:
    """Launches of one in-process trial of ``point`` that runs ``rounds``
    rounds in all (the warm chunk and the timed repetitions): kernel 1 once
    a local step; top-k's select once a round per compressed leaf of the
    logreg message (w of width d and b of width 1: a fixed ratio keeps the
    1-wide leaf whole without a launch, the scheduled ratio selects it too;
    global granularity: one plane); the quantizer once a round per leaf
    (global: once); the weighted commit once a commit on the plane under
    asynchrony (phases 5-7)."""
    from repro_torch.comm.transport import _k_of

    widths = (workload.dim, 1)
    if point.granularity == "global":
        widths = (sum(widths),)
    exp = {"fused_local_updates": rounds * workload.tau}
    if point.transport == "topk":
        exp["threshold_selects"] = rounds * (
            len(widths) if point.schedule != "constant"
            else sum(_k_of(point.ratio, w) < w for w in widths))
    elif point.transport == "quantize":
        exp["quantizes"] = rounds * len(widths)
    if workload.is_async and point.plane:
        exp["weighted_commits"] = rounds
    return _expect(**exp)


def _counting_runner(workload, **kw):
    """A :class:`repro_torch.tune.TrialRunner` that sets the counters to 0
    before each measured trial, reads them after it and holds them to
    :func:`_tune_expect`; ``runner.trials`` keeps each trial's point,
    rounds, launches and result."""
    from repro_torch.tune import TrialRunner

    class CountingRunner(TrialRunner):
        def measure(self, point):
            reset_counts()
            res = super().measure(point)
            counts = read_counts()
            ran = point.chunk_rounds + self.reps * self.rounds
            expect = _tune_expect(point, self.workload, ran)
            check(counts == expect, f"tune trial {point.describe()} "
                  f"({ran} rounds): launches {counts}, expected {expect}")
            self.trials.append({"point": point, "rounds": self.rounds,
                                "launches": counts, "result": res})
            return res

    runner = CountingRunner(workload, **kw)
    runner.trials = []
    return runner


def _sum_launches(trials) -> dict:
    return {k: sum(t["launches"][k] for t in trials) for k in _expect()}


def _tune_search(card: str, tag: str, workload, space, budget: int,
                 cache: str) -> dict:
    """(a) / (c): one search on the card with every trial's launches held
    to its point, then the same call again: a cache hit, no trial.
    Returns the summary and the runner (its ``trials``)."""
    import torch

    from repro_torch.tune import TrialPoint, tune

    runner = _counting_runner(workload, rounds=TUNE_ROUNDS, device="cuda")
    t0 = time.perf_counter()
    rec = tune(workload, space=space, budget=budget, rounds=TUNE_ROUNDS,
               runner=runner, device="cuda", cache_dir=cache)
    secs = time.perf_counter() - t0
    check(rec["measured_trials"] == len(runner.trials) > 0
          and not rec["cached"], f"tune ({tag}): {rec['measured_trials']} "
          f"measured trials, {len(runner.trials)} run")
    check(rec["host"]["backend"] == "cuda"
          and rec["host"]["device_kind"] == torch.cuda.get_device_name(0),
          f"tune ({tag}): host signature {rec['host']}")
    reset_counts()
    again = tune(workload, space=space, budget=budget, rounds=TUNE_ROUNDS,
                 device="cuda", cache_dir=cache)
    check(again["cached"] and again["measured_trials"] == 0
          and again["best"] == rec["best"] and read_counts() == _expect(),
          f"tune ({tag}): the second call was no cache hit: "
          f"{again['measured_trials']} trials, best {again['best']}")
    best = TrialPoint.from_dict(rec["best"]["point"])
    trials = [{"point": t["point"].describe(), "rounds": t["rounds"],
               "round_us": t["result"].round_us,
               "bytes_per_client_round":
                   t["result"].bytes_per_client_round,
               "staleness_mean": t["result"].staleness_mean,
               "objective": t["result"].objective,
               "launches": {k: v for k, v in t["launches"].items() if v}}
              for t in runner.trials]
    for t in trials:
        log(f"[tune-{tag}] {t['point']:<40} {t['rounds']:>3} rounds: "
            f"{t['round_us']:.1f} us/round, {t['bytes_per_client_round']:g}"
            f" B/client/round, staleness {t['staleness_mean']:.4f}, "
            f"launches {t['launches']}  [{card}]")
    log(f"[tune-{tag}] winner {best.describe()} ({rec['best']['round_us']:.1f}"
        f" us/round, objective {rec['best']['objective']:.1f}; default "
        f"point {trials[0]['point']} {trials[0]['round_us']:.1f} us/round) "
        f"from {len(trials)} trials in {secs:.1f} s; the second call: cache "
        f"hit, 0 trials  [{card}]")
    return {"record": rec, "trials": trials, "seconds": secs,
            "launches": _sum_launches(runner.trials)}, runner


def _tune_card_vs_cpu(card: str) -> dict:
    """(b): top-k 0.25 on the plane, then quantize, measured on the card
    and on the CPU: the same bytes per client and round."""
    from repro_torch.tune import TrialPoint, TrialRunner, Workload

    out, launches = {}, []
    for name, point in (
            ("topk_plane", TrialPoint(transport="topk", ratio=0.25,
                                      granularity="global", plane=True)),
            ("quantize", TrialPoint(transport="quantize"))):
        runner = _counting_runner(Workload(), rounds=TUNE_ROUNDS,
                                  device="cuda")
        card_res = runner.measure(point)
        launches += runner.trials
        cpu_res = _cpu_run(lambda: TrialRunner(
            Workload(), rounds=TUNE_ROUNDS, device="cpu").measure(point))
        check(card_res.bytes_per_client_round
              == cpu_res.bytes_per_client_round > 0,
              f"tune (b) {name}: bytes/client/round card "
              f"{card_res.bytes_per_client_round} cpu "
              f"{cpu_res.bytes_per_client_round}")
        log(f"[tune-b] {point.describe()}: {card_res.bytes_per_client_round:g}"
            f" B/client/round on both; card {card_res.round_us:.1f} "
            f"us/round, cpu (1 thread) {cpu_res.round_us:.1f} us/round; "
            f"card launches { {k: v for k, v in runner.trials[0]['launches'].items() if v} }"
            f"  [{card}]")
        out[name] = {"bytes_per_client_round":
                     card_res.bytes_per_client_round,
                     "round_us": card_res.round_us,
                     "cpu_round_us": cpu_res.round_us}
    out["launches"] = _sum_launches(launches)
    return out


def _tune_async(card: str, cache: str) -> dict:
    """(c): the straggler workload, every sampled point on the plane: the
    commit kernel launches, and the winner's staleness equals the CPU's."""
    import numpy as np

    from repro_torch.tune import (SearchSpace, TrialPoint, TrialRunner,
                                  Workload)

    w = Workload(clock="straggler")
    res, runner = _tune_search(card, "c", w, SearchSpace(plane=(True,)), 4,
                               cache)
    check(res["launches"]["weighted_commits"] > 0,
          f"tune (c): the commit kernel never launched: {res['launches']}")
    best = res["record"]["best"]
    trials = runner.trials
    winner = next(t for t in trials
                  if t["point"] == TrialPoint.from_dict(best["point"])
                  and t["rounds"] == best["rounds"])
    held = [winner]
    if winner["result"].staleness_mean == 0.0:
        # the zero-delay regime (full buffer, one slot): also hold the
        # first trial whose reports aged
        held += [t for t in trials if t["result"].staleness_mean > 0][:1]
    pairs = []
    for t in held:
        a = t["result"].staleness_mean
        b = _cpu_run(lambda: TrialRunner(
            w, rounds=t["rounds"], device="cpu").measure(
                t["point"])).staleness_mean
        ulp = float(np.spacing(np.float32(max(abs(a), abs(b)))))
        check(abs(a - b) <= ulp, f"tune (c) {t['point'].describe()}: "
              f"staleness card {a!r} cpu {b!r}")
        log(f"[tune-c] {t['point'].describe()} ({t['rounds']} rounds): "
            f"staleness_mean card {a!r}, cpu {b!r} (one float32 ulp "
            f"{ulp:.3g})  [{card}]")
        pairs.append({"point": t["point"].describe(), "rounds": t["rounds"],
                      "card": a, "cpu": b})
    res["staleness_card_vs_cpu"] = pairs
    return res


def _tune_processes(card: str, tmp: str) -> dict:
    """(d): one multi-process trial (overlapped), its hidden fraction, and
    ``obs.report --bw`` on its trace."""
    from repro_torch.tune import TrialPoint, TrialRunner, Workload

    w = Workload()
    runner = TrialRunner(w, rounds=TUNE_ROUNDS, processes=1, device="cuda")
    point = TrialPoint(chunk_rounds=4)
    reset_counts()
    res = runner.measure(point)
    counts = read_counts()
    # rank 0 runs here: kernel 1 once a local step (a dense uplink)
    expect = _expect(fused_local_updates=TUNE_ROUNDS * w.tau)
    check(counts == expect, f"tune (d): rank 0 launches {counts}, expected "
          f"{expect}")
    hidden = res.snapshot["gauges"]["tune/hidden_fraction"]
    check(0.0 <= hidden <= 1.0, f"tune (d): hidden fraction {hidden}")
    path = Path(tmp) / "trial_trace.json"
    path.write_text(json.dumps(runner.last_trace))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                           str(path), "--bw", "1e9"], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=120)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines
          and lines[-1].startswith("roofline: predicted hidden="),
          f"tune (d): obs.report --bw exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    log(f"[tune-d] {point.describe()} across 1 worker process (overlapped):"
        f" {res.round_us:.1f} us/round, {res.bytes_per_client_round:g} "
        f"B/client/round on the socket, hidden fraction {hidden:.3f}, "
        f"launches {counts}; obs.report --bw 1e9: {lines[-1]}  [{card}]")
    return {"round_us": res.round_us, "hidden_fraction": hidden,
            "bytes_per_client_round": res.bytes_per_client_round,
            "report_roofline": lines[-1], "launches": counts}


def _tune_train_cli(card: str, tmp: str) -> dict:
    """(e): ``python -m repro_torch.launch.train --autotune 3`` in a
    subprocess on the card (run as ``__main__`` by a wrapper that prints
    the counters after it): it adopts the winner and trains through
    kernels 5 and 5b."""
    from repro_torch.configs import registry

    args = ["--autotune", "3", "--arch", "stablelm_1_6b", "--scale", "smoke",
            "--rounds", "2"]
    code = ("import json, runpy, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke\n"
            "runpy.run_module('repro_torch.launch.train', "
            "run_name='__main__', alter_sys=True)\n"
            "print('LAUNCHES ' + json.dumps(chip_smoke.read_counts()))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=tmp,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines and lines[-1].startswith("LAUNCHES"),
          f"tune (e): train {' '.join(args)} exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    adopt = [x for x in lines if x.startswith("autotune: adopting ")]
    check(len(adopt) == 1, f"tune (e): no adoption line in {lines[-12:]}")
    counts = json.loads(lines[-1][len("LAUNCHES "):])
    tau, rounds = 4, 2  # the trainer's default tau, --rounds
    n = _attn_layers(registry.get_smoke("stablelm_1_6b")) * tau * rounds
    check(counts["flash_attentions"] == counts["flash_attention_bwds"] == n
          and counts["fused_local_updates"] >= tau * rounds
          and counts["fused_local_update_copies"] == 0,
          f"tune (e): launches {counts}, expected {n} of kernels 5 and 5b")
    log(f"[tune-e] python -m repro_torch.launch.train {' '.join(args)}: exit "
        f"0 in {secs:.1f} s; {adopt[0]}; launches {counts} (the search's "
        f"trials and the training)  [{card}]")
    return {"cmd": args, "seconds": secs, "adopted": adopt[0],
            "launches": counts}


def phase_tune(card: str) -> dict:
    """Phase 18: tuning on the card (see the module docstring)."""
    import tempfile

    from repro_torch.tune import Workload

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        search, _ = _tune_search(card, "a", Workload(), None, 6,
                                 str(Path(tmp) / "records"))
        card_vs_cpu = _tune_card_vs_cpu(card)
        asyn = _tune_async(card, str(Path(tmp) / "records"))
        procs = _tune_processes(card, tmp)
        cli = _tune_train_cli(card, tmp)
    secs = time.perf_counter() - t0
    log(f"[tune] phase 18 in {secs:.1f} s  [{card}]")
    return {"search": search, "card_vs_cpu": card_vs_cpu, "async": asyn,
            "processes": procs, "train_cli": cli, "seconds": secs}


# -- phase 19 -----------------------------------------------------------------

MESH_PSPECS = {"w": ("mlp",), "b": ()}  # the logreg params' logical axes


def _placed_pair(tag: str, make_engine, params0, supplier, rounds: int,
                 **run_kw) -> dict:
    """The same run unplaced and placed on the one-rank mesh: every state
    leaf bitwise, the launches equal; each run's counters read just after
    it."""
    import torch

    from repro_torch.launch import sharding as shd
    from repro_torch.utils import tree as tu

    out = {}
    for name in ("unplaced", "placed"):
        eng = make_engine(name == "placed")
        state = eng.init(params0)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = eng.run(state, supplier, rounds, **run_kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = {"launches": read_counts(), "s_per_round": secs / rounds,
                     "stages": list(eng.stack.names()),
                     "state": shd.gather_tree(state)}
    a, b = out["unplaced"], out["placed"]
    leaves = list(zip(tu.tree_leaves(a.pop("state")),
                      tu.tree_leaves(b.pop("state"))))
    check(all(torch.equal(x, y) for x, y in leaves),
          f"{tag}: placed state differs from the unplaced run")
    check(a["launches"] == b["launches"],
          f"{tag}: launches placed {b['launches']} vs unplaced "
          f"{a['launches']}")
    log(f"[mesh] {tag}: placed == unplaced bitwise ({len(leaves)} leaves), "
        f"launches {b['launches']}, s/round unplaced "
        f"{a['s_per_round']:.4f} placed {b['s_per_round']:.4f} "
        f"(stages {b['stages']})")
    return out


def phase_placed(card: str, ctx: dict) -> dict:
    """Phase 19a: the placed engine on a one-rank CUDA mesh."""
    from repro_torch.comm import GeneratorDraws
    from repro_torch.core.algorithm import DProxConfig
    from repro_torch.data.synthetic import make_round_batches
    from repro_torch.exec import EngineConfig, RoundEngine
    from repro_torch.fed import problems, simulator
    from repro_torch.launch import mesh as M

    t0 = time.perf_counter()
    mesh = M.make_mesh((1, 1), ("data", "model"), "cuda")
    rounds = 20

    def wide_engine(placed):
        kw = dict(mesh=mesh, param_specs=MESH_PSPECS, plan="A") if placed \
            else {}
        return RoundEngine(ctx["alg"], ctx["grad_fn"], 30,
                           EngineConfig(chunk_rounds=4, **kw), device="cuda")

    wide = _placed_pair("wide dense", wide_engine, ctx["params0"],
                        ctx["supplier"], rounds, seed=0)
    exp = _expect(fused_local_updates=rounds * WIDE_TAU)
    check(wide["placed"]["launches"] == exp,
          f"mesh wide: launches {wide['placed']['launches']}, expected {exp}")

    tau, commits = 10, 40
    data, reg, grad_fn, _, params0, L = problems.logreg_problem(
        device="cuda")
    eta_g, eta_tilde = 15.0, 0.5 / L
    alg = simulator.DProxAlgorithm(reg, DProxConfig(
        tau=tau, eta=eta_tilde / (eta_g * tau), eta_g=eta_g))

    def async_engine(placed):
        cfg = _async_config(plane=True)
        if placed:
            import dataclasses

            cfg = dataclasses.replace(cfg, mesh=mesh,
                                      param_specs=MESH_PSPECS)
        return RoundEngine(alg, grad_fn, 30, cfg, device="cuda",
                           clock_draws=GeneratorDraws(21, "cpu"),
                           draws=GeneratorDraws(22, "cpu"))

    paper = _placed_pair(
        "paper top-k + async on the plane", async_engine, params0,
        lambda r, g: make_round_batches(data, tau, None, g), commits,
        seed=0)
    got = paper["placed"]["launches"]
    check(all(got[k] > 0 for k in ("fused_local_updates", "threshold_selects",
                                   "weighted_commits"))
          and got["fused_local_updates"] == commits * tau
          and got["weighted_commits"] == commits,
          f"mesh paper async: launches {got}")
    secs = time.perf_counter() - t0
    log(f"[mesh] phase 19a in {secs:.1f} s  [{card}]")
    return {"wide": wide, "paper_async": paper, "seconds": secs,
            "paths": [wide["unplaced"], wide["placed"], paper["unplaced"],
                      paper["placed"]]}


def _moe_ep_case(card: str, mesh, arch: str, tokens: int, dtype, cut=None):
    """moe_expert_parallel on the one-rank mesh against layers.moe on the
    same weights at lossless capacity (capacity factor E / K: no pair
    dropped); returns the errors and the times (CUDA events, ms)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models import layers as L
    from repro_torch.models.moe_ep import moe_expert_parallel

    arch_cfg = registry.get(arch)
    mcfg = dataclasses.replace(
        arch_cfg.moe, num_shared=0,
        capacity_factor=arch_cfg.moe.num_experts / arch_cfg.moe.top_k)
    d = arch_cfg.d_model
    if cut is not None:
        d, F = cut
        mcfg = dataclasses.replace(mcfg, d_ff_expert=F)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = L.init_moe(gen, mcfg, d, dtype)
    x = (torch.randn((tokens, d), generator=gen, device="cuda") * 0.5).to(
        dtype)
    reset_counts()

    def timed(fn, reps=3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps

    (ref, aux_ref), dense_ms = timed(lambda: L.moe(p, mcfg, x[None]))
    ref = ref[0]
    (out, aux), ep_ms = timed(lambda: moe_expert_parallel(p, mcfg, x, mesh))
    out = out.full_tensor()
    counts = read_counts()
    check(counts == _expect(), f"moe ep {arch}: kernels launched {counts}")
    scale = float(ref.float().abs().max())
    err = float((out.float() - ref.float()).abs().max())
    aux_err = abs(float(aux) - float(aux_ref))
    check(math.isfinite(err) and scale > 0, f"moe ep {arch}: non-finite")
    row = {"arch": arch, "tokens": tokens, "dtype": str(dtype), "d": d,
           "experts": mcfg.num_experts, "top_k": mcfg.top_k,
           "d_ff_expert": mcfg.d_ff_expert, "max_abs_err": err,
           "err_over_max_out": err / scale, "aux_err": aux_err,
           "dense_ms": dense_ms, "ep_ms": ep_ms, "launches": counts}
    log(f"[moe-ep] {arch} {tuple(x.shape)} {dtype}: max |err| / max |out| "
        f"{err / scale:.3e}, aux err {aux_err:.3e}; layers.moe "
        f"{dense_ms:.3f} ms, expert-parallel {ep_ms:.3f} ms  [{card}]")
    del p, x, ref, out
    torch.cuda.empty_cache()
    return row


def phase_moe_ep(card: str) -> dict:
    """Phase 19b: the expert-parallel MoE on the one-rank mesh."""
    import torch

    from repro_torch.launch import mesh as M

    t0 = time.perf_counter()
    mesh = M.make_mesh((1,), ("model",), "cuda")
    rows = [_moe_ep_case(card, mesh, "grok_1_314b", 4096, torch.bfloat16),
            _moe_ep_case(card, mesh, "deepseek_v3_671b", 2048,
                         torch.bfloat16)]
    for row in rows:
        check(row["err_over_max_out"] < 2e-2,
              f"moe ep {row['arch']} bf16: error {row['err_over_max_out']}")
    cuts = [_moe_ep_case(card, mesh, "grok_1_314b", 512, torch.float32,
                         cut=(512, 1024)),
            _moe_ep_case(card, mesh, "deepseek_v3_671b", 512, torch.float32,
                         cut=(512, 256))]
    for row in cuts:
        check(row["max_abs_err"] < 1e-4 and row["aux_err"] < 1e-4,
              f"moe ep {row['arch']} f32: {row['max_abs_err']}, "
              f"{row['aux_err']}")
    secs = time.perf_counter() - t0
    log(f"[moe-ep] phase 19b in {secs:.1f} s  [{card}]")
    return {"full": rows, "f32_cut": cuts, "seconds": secs}


def phase_dryrun(card: str) -> dict:
    """Phase 19c: the dry run in subprocesses (a fake 512-rank world: it
    owns its process, and never touches the card)."""
    out_dir = ROOT / "chiprun_out" / "dryrun_torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [("stablelm_1_6b", "train_4k", "single", []),
            ("deepseek_v3_671b", "decode_32k", "multi", ["--no-probes"])]
    t0 = time.perf_counter()
    rows = []
    for arch, shape, mesh, extra in runs:
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--outdir",
             str(out_dir), *extra], env=env, cwd=str(ROOT),
            capture_output=True, text=True, timeout=400)
        secs = time.perf_counter() - t1
        check(proc.returncode == 0,
              f"dry run {arch} x {shape} x {mesh}: exit {proc.returncode}\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        rep = json.loads((out_dir / f"{arch}_{shape}_{mesh}.json")
                         .read_text())
        check(rep["flops_per_dev"] > 0, f"dry run {arch}: no FLOPs")
        rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                     "seconds": secs, "flops_per_dev": rep["flops_per_dev"],
                     "bytes_per_dev": rep["bytes_per_dev"],
                     "coll_bytes_per_dev": rep["coll_bytes_per_dev"],
                     "useful_ratio": rep["useful_ratio"],
                     "dominant": rep["dominant"],
                     "replicated_ops": rep.get("replicated_ops")})
        log(f"[dryrun] {arch} x {shape} x {mesh}: {secs:.1f} s, "
            f"{rep['flops_per_dev']:.4e} FLOPs/dev, useful "
            f"{rep['useful_ratio']:.4f}, dominant {rep['dominant']}, "
            f"collectives {rep['n_collectives']}")
    secs = time.perf_counter() - t0
    log(f"[dryrun] phase 19c in {secs:.1f} s  [{card}]")
    return {"runs": rows, "seconds": secs}


# -- A/B against an earlier tree -------------------------------------------------

AB_COMMIT_CASES = COMMIT_CASES[:7]  # the record's five shapes, f32 weights


AB_PARTS = ("kernels", "attention", "gemm")


def ab_part(card: str, parts=AB_PARTS, tf32: bool = True) -> dict:
    """The measurements of one tree for an A/B (the package on
    ``sys.path`` is that tree's, its kernels built from its sources;
    ``tf32``: phase 1's tensor-core check, off for an earlier tree).
    ``kernels``: kernel 1 on phase 2's planes and on the two trees, kernel 4
    at its record's shapes, phase 3's 500-round paths, phase 4's wide round
    (s/round, busy, cat kernels) and phase 7b's commits.  ``attention``:
    kernel 5 at phase 10's float32 shapes and kernel 5b at phase 15a's, each
    beside SDPA (forward and backward).  ``gemm``: kernel 6 at phase 10b's
    products and the 320-row prefill products, with the SM clock and power
    of each."""
    out = {"build_s": phase_build(tf32)["seconds"]}
    if "gemm" in parts:
        out["gemm"] = _gemm_rows(card, library=False)
    if "attention" in parts:
        out["flash"] = _flash_cases(card, [c for c in FLASH_CASES
                                           if c["dtype"] == "float32"])
        out["bwd"] = _bwd_cases(card)
    if "kernels" in parts:
        out.update(_ab_kernels(card))
    return out


def _ab_kernels(card: str) -> dict:
    """The ``kernels`` part of :func:`ab_part`."""
    import torch

    planes = phase_kernels(card)
    trees = [r for i, name in enumerate(TREES)
             for r in _tree_case(name, card, 300 + i)]
    commits = phase_commit_kernel(card, AB_COMMIT_CASES)
    paper = {}
    for tau in (10, 1):
        t0 = time.perf_counter()
        h = _fig2_run(tau, "cuda", 500, 25)
        torch.cuda.synchronize()
        paper[f"tau{tau}_s_per_round"] = (time.perf_counter() - t0) / 500
        paper[f"tau{tau}_final_optimality"] = h.optimality[-1]
    from repro_torch.exec import EngineConfig, RoundEngine

    w = _wide_problem()
    eng = RoundEngine(w["alg"], w["grad_fn"], 30, EngineConfig(
        chunk_rounds=4), device="cuda")
    s_round, round_ms, by_name = _time_and_profile(eng, w["params0"],
                                                   w["supplier"])
    wide = {"s_per_round": s_round, "round_ms": round_ms,
            "device_busy_ms": sum(by_name.values()),
            "fused_ms": sum(v for k, v in by_name.items() if any(
                f in k for f in _ROUND_PARTS["fused_local_update"])),
            "cat_kernels": {k[:60]: (_time_and_profile.counts[k], v)
                            for k, v in by_name.items()
                            if "cat" in k.lower()}}
    del w, eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _async_paper_run("cuda", True, 200, 25)
    torch.cuda.synchronize()
    asyn = {"b_s_per_commit": (time.perf_counter() - t0) / 200}
    log(f"[ab] paper {paper}; wide {wide}; async (b) {asyn}  [{card}]")
    return {"planes": planes, "trees": trees, "commits": commits,
            "paper": paper, "wide": wide, "async": asyn}


def run_ab(parent: Path, parts=AB_PARTS) -> None:
    """Parent, this tree, this tree, parent: each in its own process with
    its own package and kernels, measuring ``parts`` (see
    :func:`ab_part`); the results side by side in ``chiprun_out/ab.json``."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    runs = []
    for i, (label, root) in enumerate((("parent", parent), ("tree", ROOT),
                                       ("tree", ROOT), ("parent", parent))):
        dest = out_dir / f"ab_{i}_{label}.json"
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--ab-part", str(root), str(dest), *parts],
                              timeout=900)
        check(proc.returncode == 0, f"A/B run {i} ({label}) failed")
        runs.append({"label": label, **json.loads(dest.read_text())})
    (out_dir / "ab.json").write_text(json.dumps(runs, indent=1))
    for r in runs:
        if "gemm" in r:
            g = r["gemm"]
            log(f"[ab] {r['label']}: kernel 6, a local step's 87 products "
                f"{g['local_step']['ms']:.3f} ms (device "
                f"{g['local_step']['device_ms']:.3f}) "
                f"({g['local_step']['pct_of_bound']:.1f}% of the bound; SM "
                f"{g['local_step']['sm_mhz']} MHz, "
                f"{g['local_step']['power_w']} W); prefill "
                + ", ".join(f"{p['mkn'][1]}x{p['mkn'][2]} "
                            f"{p['ms']:.4f}" for p in g["prefill"]))
        for row in r.get("flash", []) + r.get("bwd", []):
            log(f"[ab] {r['label']}: {row['kernel']} {tuple(row['shape'])} "
                f"softcap={row['softcap']} window={row['window']}: "
                f"{row['ms']:.4f} ms (device {row['device_ms'] or 0:.4f}); "
                f"SDPA {row['library_ms'] or 0:.4f} ms (device "
                f"{row['library_device_ms'] or 0:.4f})")
        if "planes" not in r:
            continue
        planes = ", ".join(
            f"{tuple(p['shape'])} {p['dtype']} {p['ms']:.4f} ms (device "
            f"{p['device_ms']:.4f})" for p in r["planes"])
        log(f"[ab] {r['label']}: fused planes {planes}")
        trees = ", ".join(
            f"{t['tree']}/{t['feed']} {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}, {t['kernels_per_call']:g} kernels)"
            for t in r["trees"])
        commits = ", ".join(
            f"{tuple(c['shape'])} {c['dtype']} w {c['weights']}: "
            f"{c['ms']:.4f} ms (device {c['device_ms']:.4f}, "
            f"{c['kernels_per_call']:g} kernels; mv {c['library_ms']:.4f} / "
            f"{c['library_device_ms']:.4f}"
            + (f"; loads {c['loads_ms']:.4f} / {c['loads_device_ms']:.4f}"
               if c.get("loads_ms") is not None else "") + ")"
            for c in r["commits"])
        log(f"[ab] {r['label']}: fused {trees}")
        log(f"[ab] {r['label']}: commit {commits}")
        log(f"[ab] {r['label']}: paper {r['paper']}; wide "
            f"{ {k: v for k, v in r['wide'].items()} }; {r['async']}")


def main(argv) -> None:
    """``chip_smoke.py``: every phase.  ``chip_smoke.py --ab PARENT``: the
    A/B of this tree against the checkout at PARENT (see :func:`run_ab`);
    ``--ab-part TREE OUT``: one side of it."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    tree = Path(argv[1]) if argv[:1] == ["--ab-part"] else ROOT
    src = tree / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch in {tree}: run {Path(__file__).name} "
             "from a checkout of the repository")
    sys.path.insert(0, str(src))
    if argv[:1] == ["--ab"]:
        run_ab(Path(argv[1]).resolve(), argv[2:] or AB_PARTS)
        return
    if argv[:1] == ["--ab-part"]:
        card = phase_device()
        Path(argv[2]).write_text(json.dumps(ab_part(
            card, argv[3:] or AB_PARTS, tf32=tree.resolve() == ROOT),
            indent=1))
        return
    if argv[:1] == ["--tune"]:  # phase 18 alone; no result
        card = phase_device()
        phase_build()
        phase_tune(card)
        return
    if argv[:1] == ["--mesh"]:  # phase 19 alone (on phase 4's problem)
        card = phase_device()
        phase_build()
        from repro_torch.launch import mesh as mesh_lib

        mesh_lib.real_world("cuda")
        _, ctx = phase_wide(card, 0.0)
        phase_placed(card, ctx)
        del ctx
        phase_moe_ep(card)
        mesh_lib.close_world()
        phase_dryrun(card)
        return
    if argv[:1] == ["--gemm"]:  # phase 10b alone; no result
        card = phase_device()
        phase_build()
        phase_split_gemm(card)
        return
    if argv[:1] == ["--lm"]:  # phases 15, 16 and 17 alone; no result
        card = phase_device()
        phase_build()
        phase_lm(card)
        phase_zoo(card)
        phase_zoo2(card)
        return
    # torch.compile (the flex_attention yardstick) caches inside the checkout
    # and compiles in this process: no pool of compile workers to outlive it
    cache = ROOT / "build"
    for var, val in (("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor")),
                     ("TRITON_CACHE_DIR", str(cache / "triton")),
                     ("TORCHINDUCTOR_COMPILE_THREADS", "1")):
        os.environ.setdefault(var, val)
    t_start = time.perf_counter()
    card = phase_device()
    build = phase_build()
    rows = phase_kernels(card)
    plane_rows, topk = phase_plane_kernels(card)
    commit_rows = phase_commit_kernel(card)
    tree_rows = phase_tree_kernel(card)
    host = phase_host_parts(card)
    main = phase_main_path(card)
    wide_row = next(r for r in rows if r["shape"] == [30, 112_395])
    wide, ctx = phase_wide(card, wide_row["ms"])
    comp = phase_compressed_paper(card)
    wide_comp = phase_wide_compressed(card, ctx)
    asyn = phase_async_paper(card)
    wide_async = phase_wide_async(card, ctx)
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.real_world("cuda")  # one NCCL rank: phase 19's mesh
    placed = phase_placed(card, ctx)
    del ctx  # the wide problem's features on the card (5.4 GB)
    cohort = phase_cohort(card)
    fig4 = phase_fig4(card)
    runtime = phase_runtime(card)
    tuning = phase_tune(card)
    flash_rows = phase_flash_kernel(card)
    split_gemm = phase_split_gemm(card)
    gemma_a = phase_gemma_card_vs_cpu(card)
    gemma_b = phase_gemma_full(card)
    lm = phase_lm(card)
    zoo = phase_zoo(card)
    zoo2 = phase_zoo2(card)
    moe_ep = phase_moe_ep(card)
    mesh_lib.close_world()
    dryrun = phase_dryrun(card)
    # phase 10's softcap shapes and grok-1's (phase 17)
    phase_flex_yardstick(card, flash_rows + zoo2["flash_cases"])
    for row in lm["bwd_cases"]:
        if row["softcap"] is not None:
            _flex_bwd_yardstick(card, row)

    # launches on the main paths: every path's counts, read just after it
    paths = [main["tau10"], main["tau1"], *main["baselines"].values(),
             main["tau1_dprox_vs_fedda"], wide, comp["topk"],
             comp["quantize"], wide_comp["topk"], wide_comp["quantize"],
             asyn["a"], asyn["b"], wide_async, cohort,
             *fig4["card_vs_cpu"]["runs"].values(), *fig4["gate"].values(),
             *fig4["full"].values(), *runtime["runs"].values(),
             runtime["checkpoint"], tuning["search"], tuning["card_vs_cpu"],
             tuning["async"], tuning["processes"], tuning["train_cli"],
             gemma_a, gemma_b,
             *lm["smoke"].values(), lm["full"], lm["topk"],
             *zoo["card_vs_cpu"], *zoo["full"], *zoo2["card_vs_cpu"],
             *zoo2["full"], *placed["paths"], *moe_ep["full"],
             *moe_ep["f32_cut"]]
    launches = {k: sum(p["launches"][k] for p in paths) for k in _expect()}

    def entry(name, source, replaces, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name + "s"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")}

    def plane_row(kernel, weights="float64"):  # the wide paths' plane
        return next(r for r in plane_rows + commit_rows
                    if r["kernel"] == kernel and r["shape"] == [30, 112_512]
                    and r.get("weights", "float64") == weights)

    # kernel 1 at the wide tree as the tau loop feeds it
    wide_tree = next(r for r in tree_rows
                     if r["tree"] == "wide" and r["feed"] == "views")
    plane_src = "src/repro_torch/kernels/csrc/plane_ops.cu"
    summary = {
        "card": card,
        "kernels": [
            entry("fused_local_update",
                  "src/repro_torch/kernels/csrc/fused_prox.cu",
                  "src/repro/kernels/fused_prox.py:29", wide_tree),
            entry("threshold_select", plane_src,
                  "src/repro/kernels/plane_ops.py:41",
                  plane_row("threshold_select")),
            entry("quantize", plane_src, "src/repro/kernels/plane_ops.py:68",
                  plane_row("quantize")),
            entry("weighted_commit", plane_src,
                  "src/repro/kernels/plane_ops.py:100",
                  plane_row("weighted_commit", "float32")),
            entry("flash_attention",
                  "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:30", flash_rows[0]),
            # no Pallas backward: the reference differentiates this jnp
            # attention with jax.value_and_grad
            entry("flash_attention_bwd",
                  "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                  "src/repro/models/layers.py:152", lm["bwd_cases"][0]),
            # no Pallas kernel: the reference leaves its products to XLA
            entry("split_gemm", "src/repro_torch/kernels/csrc/split_gemm.cu",
                  None, split_gemm["cases"][0]),
        ],
        "build": build,
        "kernel_cases": rows,
        "plane_kernel_cases": plane_rows,
        "commit_kernel_cases": commit_rows,
        "tree_kernel_cases": tree_rows,
        "host_us_per_call": host,
        "torch_topk": topk,
        "main_path": main,
        "wide": wide,
        "compressed_paper": comp,
        "wide_compressed": wide_comp,
        "async_paper": asyn,
        "wide_async": wide_async,
        "cohort": cohort,
        "fig4": fig4,
        "runtime": runtime,
        "tuning": tuning,
        "flash_kernel_cases": flash_rows,
        "split_gemm_cases": split_gemm,
        "gemma_card_vs_cpu": gemma_a,
        "gemma_full": gemma_b,
        "lm_training": lm,
        "zoo": zoo,
        "zoo2": zoo2,
        "placed": placed,
        "moe_ep": moe_ep,
        "dryrun": dryrun,
        "seconds": time.perf_counter() - t_start,
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    log(f"[done] {summary['seconds']:.1f} s  [{card}]")
    log(card)
    log(json.dumps({"kernels": summary["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
