#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives only the port (``src/repro_torch``; no JAX, nothing of ``repro``):

1. the card's name and power limit;
2. builds every CUDA kernel of the port from ``src/repro_torch/csrc``
   (``we_rounds``, ``linear_scan``, ``flash_attention``,
   ``expert_matmul``), one ``nvcc`` each, all started together (this is
   also phase 6's build), and prints ptxas's registers and spills of the
   bf16 tensor-core kernels (flash at d 64 and 256, the expert product's
   prefill and decode kernels), of both ``linear_scan`` designs (ring and
   direct) and of ``we_rounds``'s main-path instance (K <= 64) from the
   report kept beside each library (a cached build has it too), failing
   on a spill;
3. holds the kernel against its plain PyTorch version on the card at the
   Figure 5 shape (16,384 rows x 56 bucketed workers) in four modes --
   known, unknown, drift (an AR(1) rate schedule, R = 48) and the mixed
   panel: >= 99% of rows with equal iterations, t_comp within rtol 1e-4
   and n_comm within rtol 1e-3 on those rows, batch means within 6 SE;
   and, since the plain version sums rows in the kernel's order, bit for
   bit;
4. runs the main path at paper scale -- the Figure 5 grid (mu in {10, 20,
   50, 100} x sigma^2 in {0, mu^2/6}, K = 50, N = 1e6, 1000 trials) with
   the six schemes through ``mc_grid_panel(..., backend="cuda")`` -- with
   the launch counts zeroed just before and read just after, and checks
   the paper's Figure 5 claims;
5. times the kernel and its plain version (warm minimum of 3) at 16,384
   and 131,072 rows, with each size's bound (from that run's rounds) and
   the kernel's share of it, and the whole panel's wall time;
6. (the build of ``linear_scan`` and ``flash_attention``, done in 2);
7. holds each serving kernel against its plain version on the card:
   ``flash_attention`` at the main path's shape (4, 3000, 10 Q heads, 1
   KV head, d 256, causal, window 2048, bf16) and at small shapes (GQA,
   non-causal, Sq < Sk, ragged 1000, d 64, 128 and 256) in f32 (2e-5)
   and bf16 (2e-2), as ``tests/test_kernels.py`` holds the Pallas kernel,
   plus bf16 edges of the tensor-core tiles (Sq, Sk and windows no
   multiple of a tile, Sq < Sk and Sq > Sk); each launch must take its
   design (bf16: tensor cores, f32: FMA units), and two launches at the
   main shape must be bitwise equal;
   ``linear_scan`` bit for bit (the same rounded multiply and add in the
   same order) in both designs: the ring at (4, 3000, 2560), (1, 3000,
   2560), (3, 1001, 96) and (2, 65, 100), the direct design at (3, 1001,
   97) and at the main shape on pointers off a 16-byte boundary; each
   launch must take the design ``linear_scan_design`` names;
8. serves recurrentgemma-2b at its published width and depth in bf16
   (weights drawn on the card from a seeded ``torch.Generator``): 4
   requests x 3000-token prompts x 32 new tokens through
   ``greedy_generate``, with the launch counts zeroed just before and
   read just after (``flash_attention`` once per local-attention layer,
   ``linear_scan`` once per RG-LRU layer; every flash launch on the
   tensor-core design, every scan launch on the ring); then the same
   tokens
   teacher-forced through the plain path on the card (no kernel may
   launch there), whose logits must agree with the served ones;
9. times both kernels at the main path's shape (device time: CUDA events
   behind a device sleep) against their bounds, their plain versions and
   (flash) ``scaled_dot_product_attention``, with TFLOP/s and the ratio
   to the library call, and flash and sdpa again with the host's launch
   cost (no device sleep); the scan also at one request (1, 3000, 2560)
   and in its direct design at the main shape, with TB/s and the share
   of the bound,
   and the whole path: prefill wall, decode ms per token, tokens/s, peak
   memory and the device's busy share of one profiled generate;
10. holds ``expert_matmul`` against its plain version on the card at the
    granite-moe main path's four shapes in bf16 (prefill gate/up
    (40, 2000, 1536) x (40, 1536, 512), prefill down (40, 2000, 512) x
    (40, 512, 1536), and the two decode shapes at C = 8) and at small
    ragged shapes in f32 (1e-5) and bf16 (3e-2), as
    ``tests/test_kernels.py`` holds the Pallas kernel, plus bf16 edges of
    the tensor-core tiles (C 1, 8, 16, 17, 200; D and F no multiple of a
    tile; D and F no multiple of 8, which take the FMA design); each
    launch must take its design, and a second launch at each main shape
    must be bitwise equal; and
    ``flash_attention`` at granite's prefill shape (4, 2000, 24 Q heads,
    8 KV heads, d 64, causal, no window, bf16) at 2e-2, as in 7;
11. holds one granite-moe MoE layer at full width, (4, 2000, 1536) bf16,
    with the kernel against the same layer under the plain version (the
    routing is the same computation on the same x), and prints the share
    of (token, k) pairs dropped at C = 2000;
12. serves granite-moe-3b-a800m at its published width and depth in
    bf16 (weights drawn on the card from seed 0): 4 requests x
    2000-token prompts x 32 new tokens through ``greedy_generate``, with
    the launch counts zeroed just before and read just after
    (``flash_attention`` 32, ``expert_matmul`` 3072, the others 0; every
    one of them on the tensor-core designs); then
    the same prefill-then-decode schedule, fed the served tokens,
    through the plain path on the card (no kernel may launch there),
    whose logits must agree with the served ones step by step;
13. times ``expert_matmul`` at the main path's shapes against its bound,
    its plain version and ``torch.bmm`` (TFLOP/s, TB/s, and the ratio to
    ``torch.bmm``), the kernel and ``torch.bmm`` again with the host's
    launch cost and as the host's cost a call, ``flash_attention`` at
    granite's shape as in 9, and the whole path: prefill
    wall, decode ms per step, tokens/s, peak memory, the share of
    (token, k) pairs a prefill drops and the device's busy share of one
    profiled generate;
14. holds each kernel op's gradients on the card against autograd of its
    plain version: float32 at the shapes of ``tests/test_kernels.py``'s
    VJP tests (1e-4), and at the model's shapes on fixed cotangents --
    ``linear_scan`` (1, 2560, 2560) bitwise, ``flash_attention`` (1,
    2560, 10 Q heads, 1 KV head, d 256, window 2048, bf16) bitwise (its
    backward is the plain version's), ``expert_matmul`` at granite's two
    prefill shapes and at its two training shapes (granite at 1 x 4096
    tokens, C = 1024; the backward launches then take the four shapes
    (40, 1024, 512) x (40, 512, 1536), (40, 1536, 1024) x (40, 1024, 512),
    (40, 1024, 1536) x (40, 1536, 512) and (40, 512, 1024) x (40, 1024,
    1536)) in bf16 within a relative RMS of 2^-7, and ``flash_attention``
    at granite's training shape (1, 4096, 24 Q heads, 8 KV heads, d 64,
    causal): its forward at 2e-2 and each query row within a relative
    RMS of 2^-7 (``FLASH_ROW_REL_RMS``), its gradients bitwise; every CUDA
    output carries a ``grad_fn`` and each backward's launches are counted
    by design (the scan's one, on the ring; the expert product's two;
    flash's none); then times both training kernels at the training
    shapes and each op's whole backward, the expert product's two forward
    and four backward launches at granite's training shapes against their
    bounds, their plain versions and ``torch.bmm``, and flash at granite's
    training shape with its plain backward against SDPA ``is_causal``;
15. one gradient step of recurrentgemma-2b at full width and depth 3 (one
    (rec, rec, attn) period, 1 x 2560 tokens, bf16), with remat off and
    on and the launches counted against the layer plan, then the kernel
    path against the plain path on the card (no kernel may launch there):
    the loss within 1e-3 relative, each gradient leaf within a relative
    RMS of 2e-2;
16. trains recurrentgemma-2b at its published width and depth: four
    ``fit`` steps (AdamW with float32 state, constant lr 1e-4, remat per
    period) on one repeated 1 x 2560 structured batch, with the launch
    counts zeroed just before and read just after (``flash_attention`` 16
    and ``linear_scan`` 52 a step, all on the tensor-core / ring designs);
    every loss and grad norm finite and the last loss below the first;
    prints the step wall (warm minimum), tokens/s, peak memory, and one
    profiled step's busy share and device time by kind;
17. one gradient step of granite-moe-3b-a800m at full width and depth 3
    (1 x 4096 tokens, bf16, capacity factor 1.25), with remat off and on
    and the launches counted against the layer plan (flash 3 and 6, the
    expert product 27 and 36, all on the tensor-core designs), then the
    kernel path against the plain path on the card (no kernel may launch
    there): first the plain path routing for itself, for the share of
    (token, k) pairs the two route differently (at most 2e-2), then the
    plain path on the kernel path's routing replayed, with the loss and
    the router aux sum within 1e-3 relative and each gradient leaf within
    a relative RMS of 2e-2 (the reasoning above ``MOE_TRAIN_LOSS_RTOL``);
18. trains granite-moe-3b-a800m at its published width and depth: four
    ``fit`` steps (AdamW with float32 state, constant lr 1e-4, remat per
    layer) on one repeated 1 x 4096 structured batch, with the launch
    counts zeroed just before and read just after (``flash_attention`` 64
    and ``expert_matmul`` 384 a step, all on the tensor-core designs);
    every loss, aux sum and grad norm finite and the last loss below the
    first; prints the share of dropped (token, k) pairs, the step wall
    (warm minimum), tokens/s, peak memory, the AdamW update's time, one
    profiled step's busy share and device time by kind, and the device
    time of the 192 backward expert launches and of flash's 32 plain
    recomputes; then the same for steps on one 1 x 4096 batch of i.i.d.
    tokens, whose routing is closer to text's than the structured task's
    short cycle, with both batches' drop shares at the same weights;
19. the unit-group gradient engine (``repro_torch.hettrain.
    ScanGradEngine``) at granite's full width, on units of 1 x 2048
    i.i.d. tokens (phase 18's optimizer state freed first): two calls
    on the same ids bitwise equal, ``grad_sum`` of units [3, 0] bitwise
    equal to that of [0, 3], ``min_bucket=4`` bitwise equal to
    ``min_bucket=1`` (buckets [4] and [2]), and its counters and the
    kernel launches (32 flash and 288 expert launches a unit) matching
    the units summed;
20. the exact numpy engine at paper scale: the Figure 5 grid (K = 50, N =
    1e6, 8 points, 1000 trials) for ``mds``, ``work_exchange`` and
    ``work_exchange_unknown`` through ``mc_grid_panel(...,
    backend="numpy")``, the paper's claims checked on it as in 4, the
    ``cuda`` panel's and ``engine="loop"``'s (20 trials) mean ``t_comp``
    at each point within 6 combined standard errors (or 2e-3 relative)
    of the numpy one, and both panels' walls and the worst gap printed;
21. ``HetTrainer`` trains recurrentgemma-2b at its published width and
    depth (bf16, weights drawn on the card from seed 0, AdamW as in 16)
    on the training launcher's fleet (8 rates from seed 0), 16 units a
    step of 1 x 512 structured tokens, 2 steps, under each of the five
    policies, the weights drawn anew each time, and once more under
    ``work_exchange`` with worker 3 failing at step 1: the parameters
    after the last step bitwise equal across the six runs (a SHA-256 of
    each leaf's bytes), every loss finite and the last below the first,
    the launch counts zeroed just before each run and read just after
    (16 x a unit's: flash 8 and the scan 36 (18 forward, 18 backward) a
    unit, all on tc / ring), ``gradient_coded`` one iteration a step, and
    the paper's ordering of the policies' mean virtual step time
    (``work_exchange``, ``work_exchange_online`` and ``het_static``
    below ``equal_static``) over 300 virtual steps of each trainer's own
    schedulers and pool, whose first 2 are the trained steps' bit for
    bit; prints the step wall, the share outside ``grad_sum`` and the
    peak memory; both kernels are first held against their plain
    versions and timed at a unit's shapes;
22. the lossy path at full width and depth 3: ``HetTrainer`` dense, with
    ``Int8Compressor`` and with ``TopKCompressor(0.25)`` (both without
    error feedback: the fleet's 8 float32 residual trees would not fit)
    for 1 step (int8's wire bytes under 1.2 a parameter a unit, the
    reference's bound, every loss finite), top-k's second round-trip
    (with error feedback) of a tree of ones shaped like the params
    shipping at least the first's mass; then
    ``run_training_grid`` for the seven ported schemes at
    ``TrainConfig(model="small", steps=4)`` on the card (2 points x 2
    trials): loss curves bitwise equal across schemes and within 1e-3
    relative of the same call on the CPU plain path;
23. the experiment layer (``repro_torch.experiments``), every store it
    writes a temporary one: (i) each committed ``results/store`` entry's
    spec but the serving ones (phase 24's), read by the port, hashes to
    its file name (the live one is rerun in phase 25), and each batch
    Monte-Carlo entry (fig5,
    fig6, fig7, their
    ``-quick`` cuts, the ``mc`` demo-live; all numpy) rerun through
    ``run_experiment(..., device="cuda")`` gives every stored report
    field with ``==``; (ii) fig5, fig6 and fig7 at paper scale (K = 50,
    N = 1e6; the figures' own specs, seeds and trials, built by this
    script's copies of ``benchmarks/fig{5,6,7}.py``'s spec functions, held to
    hash to the stored entries) on ``cuda``: the 36 paper claims, each
    report's mean ``t_comp`` within 6 combined SE (or 2e-3 relative) of
    the stored numpy one, and fig5 with ``panel="fused"`` in one
    ``we_rounds`` launch, its other four tasks equal to ``per_scheme``'s;
    walls on ``cuda`` and numpy (host clock, warm minimum of 2) and the
    device's busy share of one profiled fig5 run; (iii) the ``drifting``
    and ``trace`` demos and the three ``hcmm_sweep`` specs on ``cuda``:
    every launch of a drifting grid carries its rate schedule,
    single-shot schemes are stamped ``nominal_rates_only``, the
    work-exchange rows within 6 SE of the same specs on numpy and the
    host-drawn ones (``hedged``, ``het_mds``, ``trace_replay``, ``fixed``)
    equal to them; (iv) the three ``fig-train-*`` entries on the card:
    every stored scheduling field exact (those in ``ULP_FIELDS`` within 8
    ulps, the worst gap of each printed), every field of the port's own
    run of the spec on the CPU but the losses exact (``steps_to_target``
    and ``wall_to_target`` included) and the losses within
    ``TRAIN_CURVE_RTOL`` (1e-5) of it, the loss curves bitwise equal
    across the five schemes (the stored curves come from the JAX
    package's own weights, which the port does not draw, so the fields
    that follow the loss are not held to the store); (v) ``python -m
    repro_torch.experiments --demo quick --check-cache`` in a subprocess
    on a fresh store, which must print ``computed in`` and then
    ``check-cache: OK``.  The launch counts
    are zeroed just before each run and read just after; every launch's
    inputs are recorded, and each path's largest ``we_rounds`` launch (and
    the training path's first flash launch) is replayed against the plain
    version and timed;
24. the serving subsystem (``repro_torch.serving``; no kernel: the
    reference's engine is a jitted ``lax.scan``, not a ``pallas_call``):
    (a) the four ``fig-load-*`` store entries hash to their names (and
    equal this script's copy of ``benchmarks/fig_load.py``'s specs) and
    rerun on the numpy engine on the card's host, the two full ones
    ``==`` field for field (in background processes), the two ``-quick``
    ones on every stored field, the three keys newer than them the only
    difference; (b) both full studies (K 16, N 150, 4 loads x 16 trials,
    2000 slots, 5 schemes) on the ``torch`` engine on the card: every
    report stamped ``torch`` with a closed ledger and ``units_admitted``
    equal to the stored numpy report's, ``t_comp`` within 6 combined SE
    of it, each percentile within 6 combined SE of its own (resampling
    the trials; see ``BOOT_RESAMPLES``), goodput and SLO misses within
    the reference conformance battery's bands, and every
    ``fig_load.validate`` check; printed beside them, the sign of torch
    minus numpy of each percentile over the 40 (scheme, load) rows, and
    the numpy engine at the next seed against the store (the oracle
    against itself) in SE of the mean and of the percentile's own; (c)
    the torch engine on the card against the same engine on the CPU on
    both ``-quick`` specs: at least 99% of rows with an equal integer
    ledger and histogram (the share printed), every report within 6 SE,
    and one pass a dispatch on the card (the queue tiers on the CPU
    only); (d) each full study's wall, one run on ``torch`` on the card
    and one on numpy run beside it; alone, one dispatch a study on each
    engine (one warm run), the queue tier on and off on the card and
    on the CPU, the CUDA launches a slot and the device's busy share of
    one profiled dispatch (the stationary ``-quick`` spec's
    ``work_exchange``), and one dispatch's wall at 4 loads x 1024 trials
    (4096 rows); (e) ``--demo serving`` and ``--demo serving-trace`` on
    the card in subprocesses: ``computed in``, then
    ``check-cache: OK``;
25. the live control plane (``repro_torch.control``; no kernel: the
    reference's payload is a jitted ``a @ x``, not a ``pallas_call``), the
    workers' matmul payload on the card: (a) the stored ``demo-live``
    entry hashes to its name and reruns through ``run_experiment(...,
    device="cuda")`` on a temporary store: each report's ``t_comp``
    within ``max(8 combined SE, 0.25 t_comp)`` of the stored one,
    ``mds``'s and ``hedged``'s ``n_comm`` the stored 668 and 267,
    ``fixed`` one iteration and ``n_comm`` 0, every ledger conserved,
    ``units_completed`` trials x N for the exchange schemes, every payload
    verified; (b) ``--demo live`` and ``--demo live-fault`` in
    subprocesses: ``computed in``, then ``check-cache: OK``, the fault run
    with ``workers_lost [0]``; (c) at the paper's scale (K 50, N 1e6, mu
    50, sigma^2 = mu^2/6, ``LiveConfig()``) ``work_exchange``,
    ``work_exchange_unknown`` and ``fixed`` over ``inproc``, 1 episode
    each: every unit completed, the ledger conserved, the payload
    verified, ``t_comp`` within the band of the port's numpy Monte Carlo
    at the same point (400 trials); (d) ``work_exchange`` once over
    ``tcp`` and once over ``flaky(inner="tcp", drop=0.05, seed=3)``, the
    same completion checks and retries on the flaky run, ``t_comp``
    printed against Monte Carlo, not held (the wire's encoding of 1e6
    unit ids is part of what is measured); (e) a payload-only loop of
    200 queues of N/K units under ``torch.cuda.set_sync_debug_mode
    ("error")``: no call waits for the device; (f) a ``tcp`` listener
    whose handlers never close their comms stops within 1 s.  Each run
    prints its episode wall, ``coordination_frac``, messages, retries and
    the payload's device milliseconds;
26. the rest of the model zoo at full width (bf16, seed-0 weights drawn
    on the card, requests drawn as ``launch/serve.py`` draws them):
    minicpm3-4b (MLA), xlstm-350m, seamless-m4t-medium (the
    encoder-decoder) and internvl2-26b (the vision frontend), 4 requests
    of 2048 tokens (seamless: 2048 frames and 4 decoder tokens;
    internvl2: 256 image embeddings and 2048 tokens), 32 new tokens
    through ``greedy_generate``.  For each, first the decode at full
    width and depth 3 (xlstm: 8, one period with its sLSTM layer, 257
    tokens so that the forward pass is whole mLSTM chunks) against the
    same model's teacher-forced forward pass on the card, within
    ``LOGIT_REL_RMS`` per step; then the full model with the launch
    counts zeroed just before a generate and read just after: flash
    launches by shape and design (MLA's heads padded to 128, the
    encoder's and the cross-attention's non-causal d 64, internvl2's
    2304-token d 128; every one on ``tc``; xlstm none), init peak,
    prefill wall, decode ms a step, new tokens/s and peak memory; for
    xlstm the device launches of a decode step and of a prefill; each
    flash shape replayed against its plain version and timed against
    its bound and SDPA at the heads' own dims.  Then phi3-mini-3.8b,
    phi4-mini-3.8b and h2o-danube-3-4b the same way, without the depth
    check;
27. the training launcher, ``python -m repro_torch.launch.train``, in
    subprocesses: the reduced default (phi4-mini smoke, 4 steps),
    xlstm-350m at full width under ``work_exchange`` for 4 steps with a
    checkpoint, and the same for 2 steps and then again for 4, which
    resumes, as soon as the 2 steps end (three chains at once; each run
    is host-bound on one host thread):
    every loss finite and the last below the first, the SHA-256 of every
    checkpoint leaf after step 3 and ``T_virtual``, ``I`` and ``moved``
    of every step equal between the straight and the resumed runs, the
    card's ``memory.used`` (sampled every 0.25 s, all processes) within
    the card;
28. the ``torch`` sampler backend, the row split and the examples: (a)
    the Figure 5 panel through ``mc_grid_panel(..., backend="torch")`` at
    paper scale -- the 28 claims, the work-exchange pair within 6 SE (or
    2e-3) of phase 20's numpy panel at each point, the same seed twice
    the same report, its warm wall beside phase 5's ``cuda`` wall, the
    device's busy share and the host reads a round; (b) the ``drifting``
    demo spec on ``torch`` against ``numpy``, 6 SE; (c) under
    ``grid_sharding`` over 4 shards of card 0: the ``cuda`` split's 4
    launches (counts zeroed just before, read just after), each bitwise
    its plain version on the same card tensors and the split's rows
    within phase 3's tolerance of the same split by the plain version on
    4 CPU shards; the ``torch`` split seed-deterministic and within 6 SE
    of numpy; the serving split over 2 shards giving the quick fig-load
    study bitwise the unsplit one and within phase 24's bands of the
    stored numpy entry (with several cards, (c) again over distinct
    cards); (d) ``examples/torch_quickstart.py``,
    ``torch_serve_batch.py --live`` and ``torch_train_het_sim.py`` with
    ``--device cuda`` in background processes beside (b) and (c), each
    exiting 0 with its healthy lines.  It adds a ``we_rounds`` entry for
    the row split to the kernel line;
29. the mesh, qwen3-moe-30b-a3b resolved for tp 4 (its published 32 Q /
    4 KV heads).  With 4 cards or more, 4 NCCL ranks (one process a
    card, ``repro_torch.launch.mesh.spawn``, the kernels built in 2) on
    the mesh (data 1, model 4): (a) one MoE layer at full width, (4,
    2048, 2048) bf16, through ``moe_apply_a2a`` (``expert_matmul`` on
    each rank's 32 experts, 3 launches a rank on ``tc``) against the plain
    emulation on card 0 (the same 4 token blocks, per-rank capacities and
    exchange by indexing, the plain expert products): relative RMS <=
    1e-3, the aux term within float32 rounding, the dropped pairs equal;
    (b) one tensor-parallel GQA layer (8 Q / 1 KV heads a card, the
    sequence all-gathered and the output reduce-scattered) against the
    layer unsharded on card 0: 2e-2 and each row's relative RMS <= 2^-7;
    (c) the model at full width and depth (48 layers), bf16, with the
    sharded init (seed 0), serving 4 x 2048 prompt tokens (drawn as
    ``launch/serve.py`` draws them) and 32 new ones through
    ``greedy_generate`` under the mesh: launches zeroed just before the
    generate and read just after (flash 48 at (4, 2048, 8/1, 128),
    ``expert_matmul`` 4608, all on ``tc``), the same tokens on every rank,
    the decode within ``LOGIT_REL_RMS`` per step of a teacher-forced pass
    over the generated tokens behind the prompt's cache, and per rank the
    init and generate peaks, the prefill wall, decode ms a step, new
    tok/s, the device's busy share and NCCL's share of device time in one
    profiled generate, and the collectives of a generate by op and group
    size; (d) on card 0 alone, flash and ``expert_matmul`` at each rank's
    shapes against their bounds, plain versions and SDPA / ``torch.bmm``,
    one kernel-line entry each.  With fewer cards: (a) emulated on card 0,
    the kernel against the plain version; (c) at world size 1, depth 12;
    (d) at those shapes; and one line naming the checks that need 4
    cards;
30. the sharded training step, granite-moe-3b-a800m (resolved for tp 2:
    its 24 / 8 heads split).  With 4 cards or more, 4 NCCL ranks in one
    world hold two meshes, (data 4, model 1) and (data 2, model 2): (a)
    one GQA + MoE block at full width, (2, 4096, 1536) bf16, trained on
    (data 2, model 2) as the training step runs it (each rank's
    training-layout blocks gathered by their specs, its (batch,
    sequence) block, the residual sequence-parallel, ``moe_apply_a2a``,
    ``train.loop``'s gradient reduction) against a plain one-process
    emulation of the 4 ranks on card 0 (each rank's heads, each block's
    routing and capacity, the exchange by indexing, the plain kernels,
    autograd): the pairs routed differently at most 2e-2, then on the
    mesh's routing replayed the loss and the aux term within 1e-3
    relative and each gradient leaf within a relative RMS of 2e-2; (b)
    the model at its published width and depth (32 layers), bf16, with
    the sharded init in the training layout (seed 0) and remat, 3 steps
    of ``make_train_step`` on one repeated batch of structured tokens,
    4 x 4096 on (data 4, model 1) and 2 x 4096 on (data 2, model 2):
    every loss, aux and grad norm finite and the same on every rank, the
    last loss below the first, every leaf (params and master weights)
    that several ranks hold the same bits on each, flash and
    ``expert_matmul`` launches by shape (all on ``tc``), and per rank
    the init and step peaks, the warm step wall, tokens/s a card, NCCL's
    share of device time and the device time outside it in one profiled
    step, and the collectives a step by op and group size; (c) on card 0
    alone, flash (forward, and its plain backward) and ``expert_matmul``
    (every forward and backward launch shape) at each rank's shapes
    against their bounds, plain versions and SDPA / ``torch.bmm``, one
    kernel-line entry each.  With fewer cards: (a) the emulation's
    kernel path against its plain version on card 0; (b) at world size 1
    and depth 3, bit for bit the unsharded ``make_train_step`` after one
    step; (c) at those shapes; and one line naming the checks that need
    4 cards;
31. the dry run (``launch/dryrun.py``, ``launch/op_analysis.py``)
    against the card: (a) granite-moe-3b-a800m at full width and depth 3,
    one training step at 1 x 4096 and a served prefill of 4 x 2000 then
    one decode step, each counted on the card (``StepCounter``, after
    ``reset_peak_memory_stats``) and as a dry run on ``meta``: dot FLOPs,
    op-boundary bytes and each kernel op's tally equal, the tally's calls
    the launches, and the dry run's peak within 2% of
    ``max_memory_allocated`` (less what the card held before the
    inputs); (b) inside phase 30 on 4 cards, each rank's counted step on
    (data 2, model 2) against the dry run of its own rank on a fake world
    of 4: the collectives by (op, group size) equal in calls and bytes,
    dot FLOPs equal, the peak within 2%; (c) three production cells on
    the card's host (qwen3-moe-30b-a3b x train_4k x single and
    granite-moe-3b-a800m x decode_32k x multi ``ok``, minicpm3-4b x
    prefill_32k x single ``not_ported``) with their counts a device; a
    kernel-line entry for each flash and ``expert_matmul`` shape of (a).

It prints the kernel line ``{"kernels": [...]}`` (one entry per kernel and
main path, named by ``path``: flash attention has one for each serving
path and one for each training path; on a training path each entry also
names its ``backward`` and times it, ``backward_ms``; the
heterogeneous-training path's entries also give ``launches_per_step``;
phase 23 adds ``we_rounds`` entries for ``experiments fig5``, ``fig6``,
``fig7`` and ``scenario families`` and a flash entry for ``experiments
fig-train``, each with ``runs``, the number of experiment runs it read:
a ``we_rounds`` entry's ``launches`` are those runs' sum, the flash
entry's those of one run, each of its 3 runs the same; phase 26 adds a
flash entry for each new served shape, with its ``shape``, ``head_dims``
and ``causal``) and, last, ``{"ok": true,
"device": {...}}``.  Any failed phase exits non-zero with no result line;
without a CUDA device it exits 1 at once.

    python3 chip_smoke.py --granite-serve

runs only phases 12 and 13's granite serving and prints its times as one
JSON line: run from the roots of two trees in turn, it compares their
``src`` on one card.

    python3 chip_smoke.py --mesh

builds the kernels and runs only phases 29 and 30 (on a machine with 4
cards: the NCCL meshes, and phase 31 (b) inside phase 30), then prints
their kernel line and the result line.

    python3 chip_smoke.py --dry-run

builds the kernels and runs only phase 31 (a) and (c) on one card, then
prints its kernel line and the result line.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

K_PAPER, N_PAPER, TRIALS = 50, 1_000_000, 1000
MUS = (10.0, 20.0, 50.0, 100.0)
SIGMA_FRACS = (("0", 0.0), ("mu^2/6", 1.0 / 6.0))
SCHEMES = ("oracle", "fixed", "uniform", "mds", "work_exchange",
           "work_exchange_unknown")
# H100 SXM int32 ALU rate: 132 SMs x 64 int32 lanes x 1.98 GHz boost
# (NVIDIA Hopper architecture white paper); HBM3 at 3.35 TB/s
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
THREEFRY_INT_OPS = 77       # 2 key adds + 20 x (add, rotate, xor) + 5 x 3
ROW_AGREE, T_RTOL, C_RTOL, C_ATOL, MEAN_SE = 0.99, 1e-4, 1e-3, 1.0, 6.0
# H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_STEPS = "recurrentgemma-2b", 4, \
    3000, 32
# flash against its plain version, as tests/test_kernels.py holds the
# Pallas kernel: the online softmax sums in another order (f32), and the
# bf16 output keeps 8 significand bits
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# flash at granite's training shape (S = 4096, causal) is also held row by
# row, since a late row averages ~i/e keys of N(0, 1) values and its
# outputs, ~0.03, are no larger than FLASH_TOL.  The plain version rounds
# once, float32 to bf16 at the end; the kernel also rounds the softmax
# weights to bf16 before its P V product.  A bf16 rounding errs by at most
# 2^-9 to 2^-8 of the value (RMS ~1.6e-3 of it), and a row's output sums
# weighted values of random sign, so each row's relative RMS difference
# (over its 24 x 64 elements) is some 2e-3 to 4e-3.  2^-7 allows twice
# that.  A row rescaled by 1 + e reads e, and a softmax scale off by e
# moves a row's weights by e x its N(0, 1) scores, so its output by ~e:
# a 1% error fails (phase 14 prints what a scale 1% off reads)
FLASH_ROW_REL_RMS = 2.0 ** -7
# a row over few keys (the enc-dec decoder's 4) moves by less than the
# limit under a 1% scale error; from one key tile (64) up a row moves by
# ~e, and there the row check must be shown to fail a scale 1% off
SCALE_SEEN_MIN_KEYS = 64
# served logits against the teacher-forced plain path, both bf16: every
# matrix product and the decode attention round to bf16 at other places
# in the two (decode one token at a time against a 3031-token forward).
# One bf16 rounding is <= 2^-9 relative; 26 layers of independent
# roundings compound to ~1.5% of the residual stream, so the relative
# RMS error of each step's logits must stay under 5e-2.
LOGIT_REL_RMS = 5e-2
MOE_ARCH, MOE_B, MOE_PROMPT, MOE_STEPS = "granite-moe-3b-a800m", 4, 2000, 32
# expert_matmul against its plain version, as tests/test_kernels.py holds
# the Pallas kernel: both sum in float32, in another order
GMM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# one MoE layer, kernel against plain: the products' bf16 outputs differ
# only where the two float32 sums straddle a rounding boundary, by one
# bf16 ulp (<= 2^-8 relative); if every element did, the relative RMS
# would be ~3e-3.  The plain fp32 product and the tensor cores' fp32
# accumulation agree to well under a bf16 ulp, so 1e-3 allows about a
# ninth of the elements to straddle
MOE_LAYER_REL_RMS = 1e-3
# served logits against the plain path on the same schedule, both bf16:
# bf16 roundings at other places in flash attention and the expert
# products compound through 32 layers as in phase 8 (~2.4% there, on
# recurrentgemma), and a perturbed hidden state flips some
# near-tied top-8 routing choices, each moving ~7% of the router weight
# of a token to another expert; 1e-1 bounds both
MOE_LOGIT_REL_RMS = 1e-1
SLEEP_CYCLES = 2_000_000        # ~1 ms of device time at the H100's clock
TRAIN_ARCH, TRAIN_S, TRAIN_STEPS, TRAIN_LR = "recurrentgemma-2b", 2560, 4, \
    1e-4
TRAIN_PATH = f"train-{TRAIN_ARCH}"
MOE_TRAIN_B, MOE_TRAIN_S = 1, 4096       # the Granite 3.0 context length
MOE_TRAIN_PATH = f"train-{MOE_ARCH}"
ENGINE_UNIT = (1, 2048)                  # phase 19: rows, tokens a unit
# phase 20: the exact engine's schemes and the per-trial loop's trials
EXACT_SCHEMES = ("mds", "work_exchange", "work_exchange_unknown")
EXACT_LOOP_TRIALS = 20
# phases 21-22: HetTrainer on recurrentgemma-2b; the fleet of the training
# launcher (K workers), units a step of 1 x HET_S tokens, steps a policy;
# the virtual steps the policies' ordering is held over; the lossy path's
# steps; the runner's config, units a step, trials and schemes
HET_PATH = "hettrain-recurrentgemma"
HET_K, HET_UNITS, HET_S, HET_STEPS = 8, 16, 512, 2
HET_VIRTUAL_STEPS = 300
LOSSY_STEPS = 1
RUNNER_STEPS, RUNNER_N, RUNNER_TRIALS = 4, 8, 2
RUNNER_SCHEMES = ("oracle", "fixed", "uniform", "mds", "work_exchange",
                  "work_exchange_unknown", "gradient_coded")
# the runner's float32 loss curve on the card against the same call on
# the CPU plain path: flash f32 is held at 2e-5 in phase 7, and the
# products and sums run in another order; four AdamW steps move the loss
# by far less than 1e-3 of itself
RUNNER_CPU_RTOL = 1e-3
# int8's wire bytes a parameter a unit.  The reference holds int8 below
# 0.3 of the dense path's bytes on float32 params (tests/test_hetsched.py),
# 1.2 bytes a parameter a unit; the dense path ships each unit's gradient
# in the params' dtype, so on bf16 params the same 0.3 would ask 0.6
# bytes, below int8's 1 byte a parameter for each of the ~15 worker
# groups of a step.  The bound is held in bytes: 0.3 x float32's 4
INT8_BYTES_PER_PARAM = 1.2
# phase 23: the experiment layer.  The paper's Figure 5 panel
# (``benchmarks/common.py``'s FIG_SCHEMES), the store entries' training
# specs, and the float32 rate outside the tensor cores (H100 SXM data
# sheet) that bounds the float32 FMA flash design on that path
FIG_SCHEMES = ("mds", "fixed", "work_exchange", "work_exchange_unknown",
               "het_mds", "hedged")
WE_PAIR = ("work_exchange", "work_exchange_unknown")
FIG_TRAIN = ("fig-train-stationary", "fig-train-drifting", "fig-train-trace")
FP32_FLOPS_PER_S = 67e12
# a stored training row's float fields that are means or deviations over
# trials or steps of host numpy sums: the host that wrote the store summed
# some of them in another order.  The JAX package rerun on a CPU host
# (numpy 2.0.2, as the store's) gives the port's bits, 1-2 ulps from the
# store's in the per-step means and up to 8 in a deviation
# (``tests/test_torch_experiments.py`` holds both), so these are held
# within 8 ulps of the store (the card's host, numpy 2.3.5, reads the
# same); every other scheduling field exactly.  The fields that follow
# the loss are held against the port's own CPU run
ULP_FIELDS = ("t_comp_std", "t_comp_per_step")
STORE_ULPS = 8
LOSS_FIELDS = ("loss_curve", "final_loss", "steps_to_target",
               "wall_to_target")
# the fig-train losses on the card against the port's CPU run of the same
# spec: read 2.801e-6 (float32 products and sums in another order)
TRAIN_CURVE_RTOL = 1e-5
# phase 24: the serving subsystem.  ``benchmarks/fig_load.py``'s
# dispatch-policy panel, loads, operating point and SLO (copied: benchmarks/
# imports the JAX package); the trials of the larger torch dispatch (64 x
# the study's, 4 loads x 1024 = 4096 rows); the bootstrap resamples of a
# percentile's standard error.  A sojourn percentile of a study pools
# ~300 completions a load over 16 trials, a few hundred jobs: its spread
# is set by the busy periods of the trials, not by the spread of the
# per-trial means the reports carry, so a percentile is held within 6
# combined SE of its own, resampling the trials of the torch run's
# per-trial histograms (the numpy run, same design and size, taken to
# have the same SE).  Against 6 SE of the mean, the reference's cell
# test's band (tests/test_torch_serving_engine.py holds that band at the
# reference's small cell), the torch run reads ~6.4 of them at load 0.5
# and ~2.7 of its own; the phase prints both, and the same two readings
# of the numpy engine at the next seed against the store
FIG_LOAD_SCHEMES = ("work_exchange", "work_exchange_unknown", "fixed",
                    "het_mds", "hedged")
FIG_LOAD_LOADS, FIG_LOAD_LOADS_QUICK = (0.5, 0.7, 0.85, 0.95), (0.6, 0.9)
FIG_LOAD_POINT = (30.0, 30.0 * 30.0 / 6.0, 7)
FIG_LOAD_K, FIG_LOAD_N, FIG_LOAD_TRIALS, FIG_LOAD_SLO = 16, 150, 16, 4.0
SERVE_BIG_TRIALS = 1024
BOOT_RESAMPLES = 400
# card against CPU: the share of rows whose integer ledger and histogram
# must be equal
SERVE_ROWS_EQUAL = 0.99
# phase 25: the live control plane.  A live mean is held against another
# mean within the reference battery's band (tests/test_control.py):
# 8 combined SE or a quarter of t_comp, whichever is wider -- an episode's
# t_comp carries the host's scheduling delays, which no SE of the service
# model covers.  The stored demo-live entry; its coded rows' n_comm
# (K * ceil(N / L) - N for mds at L = 3, the straggler's duplicated shard
# for hedged).  The full-size point is the paper's Figure 5 scale at one
# grid point (K 50, N 1e6, mu 50, sigma^2 = mu^2/6 from seed 0) with
# LiveConfig at its defaults: the payload's A is 1e6 x 4 x 64 float32, 1 GB
# on the card in every episode
LIVE_BAND_SE, LIVE_BAND_FRAC = 8.0, 0.25
LIVE_ENTRY = ("f8ff00118f49ebce9a9efb32b2f38d57202824878cea2972cbea8a9bd9"
              "37ce88")
LIVE_STORED_N_COMM = {"mds": 668.0, "hedged": 267.0}
LIVE_MU, LIVE_EPISODES, LIVE_MC_TRIALS, LIVE_SEED = 50.0, 1, 400, 1234
LIVE_FULL_SCHEMES = ("work_exchange", "work_exchange_unknown", "fixed")
LIVE_FLAKY = {"inner": "tcp", "drop": 0.05, "seed": 3}
LIVE_STOP_S = 1.0
LIVE_PAYLOAD_CALLS = 200
# phase 26: the rest of the model zoo served at full width, bf16, seed-0
# weights: 4 requests of 2048 prompt tokens (seamless: 2048 frames and 4
# decoder tokens; internvl2: 256 image embeddings and 2048 tokens), 32 new
# tokens each, as ``launch/serve.py`` draws them.  Each decode is held
# against the same model's teacher-forced forward pass on the card at full
# width and a depth of 3 (xlstm: 8, one period, so that its sLSTM layer is
# in it), within ``LOGIT_REL_RMS`` per step, as phase 8 holds
# recurrentgemma.  The mLSTM's chunkwise form takes a sequence of a
# multiple of its 256-step chunk, so xlstm's check decodes 257 tokens: the
# teacher-forced pass is then 2048 + 256 tokens, 9 chunks.  Then three
# dense configs served once each
ZOO_ARCHS = ("minicpm3-4b", "xlstm-350m", "seamless-m4t-medium",
             "internvl2-26b")
ZOO_DENSE = ("phi3-mini-3.8b", "phi4-mini-3.8b", "h2o-danube-3-4b")
ZOO_B, ZOO_PROMPT, ZOO_STEPS, ZOO_DEPTH = 4, 2048, 32, 3
# phase 27: the training launcher in subprocesses; its xlstm runs
LAUNCH_XLSTM = ("--arch", "xlstm-350m", "--full-config", "--policy",
                "work_exchange")
LAUNCH_STEPS, LAUNCH_FIRST = 4, 2
# phase 28: the torch backend, the row split and the examples.  The
# shards of the cuda and torch splits and of the serving split (all on
# card 0); the split's trials where its plain version runs on the CPU
# (1000 rows: the plain Threefry on the host is slow at paper scale); the
# trials of the serving split with geometric job sizes; the examples,
# their arguments (small step counts) and the lines a healthy run prints
SPLIT_D, SERVE_SPLIT_D, SPLIT_CPU_TRIALS, GEO_SPLIT_TRIALS = 4, 2, 125, 64
MESH_ARCH = "qwen3-moe-30b-a3b"        # phase 29
MESH_TP = 4                             # cards of the (data 1, model 4) mesh
MESH_B, MESH_PROMPT, MESH_STEPS = 4, 2048, 32
MESH_ONE_CARD_DEPTH = 12                # (c) at world size 1 on one card
MESH_LIMIT_S = 600                      # the 4-rank spawn's hard limit
# the a2a's aux term is NCCL's mean of 4 per-expert vectors against the
# emulation's torch mean of the same 4: float32 sums in two orders
MESH_AUX_RTOL = 1e-6
# a decode's expert that the routing-replayed forced pass ranks below its
# own top k must trail that pass's k-th router logit by at most this: the
# logits are ~N(0, 1) (d^-1/2 router on a unit-RMS input), the 8th and 9th
# of 128 lie ~0.04 apart, a routing fault (a wrong expert) ~1 below
MESH_TIE_LOGIT_GAP = 0.25
# phase 30: the sharded training step.  granite over 4 cards: the batch
# of the (data 4, model 1) mesh (1 x 4096 a rank, phase 18's step) and of
# the (data 2, model 2) mesh, the steps, the spawn's hard limit; (a)'s
# mesh and aux weight (lm_loss's); (b)'s depth on one card
TRAIN_MESH_ARCH, TRAIN_MESH_S, TRAIN_MESH_STEPS = MOE_ARCH, 4096, 3
TRAIN_MESH_B_DP, TRAIN_MESH_B_TP = 4, 2
TRAIN_MESH_LIMIT_S = 300
TRAIN_MESH_DP, TRAIN_MESH_TP, TRAIN_MESH_AUX_WEIGHT = 2, 2, 0.01
TRAIN_MESH_ONE_CARD_DEPTH = 3
# phase 31: the dry run against the card.  (a)'s depth (30 (b)'s on one
# card); the dry run's peak against the card's: what the card allocates
# below the dispatcher beyond ``op_analysis.WORKSPACE`` (cuBLAS's
# workspace, the reductions' and sorts' own scratch) is all it misses,
# -0.01% to -0.44% of the peaks on an H100 (PERF.md), while a missed
# transient of (a)'s train step, the softmax backward's, read -10.27%;
# (c)'s production cells and the status each must have
DRY_DEPTH = TRAIN_MESH_ONE_CARD_DEPTH
DRY_PEAK_RTOL = 0.02
DRY_CELLS = (("qwen3-moe-30b-a3b", "train_4k", False, "ok"),
             ("granite-moe-3b-a800m", "decode_32k", True, "ok"),
             ("minicpm3-4b", "prefill_32k", False, "not_ported"))
EXAMPLES = (
    ("torch_quickstart.py", ("--steps", "4"),
     ("oracle lower bound", "work exchange", "cache HIT")),
    ("torch_serve_batch.py", ("--live",),
     ("greedy, KV-cached", "streaming prefill batches", "  work_exchange ",
      "  work_exchange_unknown ", "  fixed ", "  uniform ", "SLO-miss",
      "MC-predicted")),
    ("torch_train_het_sim.py", ("--steps", "6"),
     ("final-loss  virtual-time", "(oracle bound)")))
REPLACES = {"linear_scan": "src/repro/kernels/linear_scan/kernel.py:22",
            "flash_attention":
            "src/repro/kernels/flash_attention/kernel.py:30",
            "expert_matmul": "src/repro/kernels/moe_gmm/kernel.py:20"}
BACKWARDS = {
    "linear_scan": "LinearScan.backward, src/repro_torch/kernels/"
                   "linear_scan/ops.py: the same kernel on reversed inputs "
                   "(the Pallas call of src/repro/kernels/linear_scan/"
                   "ops.py:33)",
    "flash_attention": "FlashAttention.backward, src/repro_torch/kernels/"
                       "flash_attention/ops.py: attention_ref recomputed "
                       "and differentiated, no kernel (as "
                       "src/repro/kernels/flash_attention/ops.py:32-38)",
    "expert_matmul": "ExpertMatmul.backward, src/repro_torch/kernels/"
                     "moe_gmm/ops.py: two more launches of the same kernel, "
                     "dX = dY W^T and dW = X^T dY on transposed contiguous "
                     "operands (XLA differentiates the einsums of "
                     "src/repro/models/moe.py:115-118)"}
# each op's gradients against autograd of its plain version.  float32 at
# the shapes of tests/test_kernels.py's VJP tests, loss sum(out ** 2): 1e-4,
# as those tests hold the JAX ops (the forwards differ within their own
# tolerances).  At the model's shapes, on a fixed cotangent: the scan
# bitwise (its reverse scan makes the plain loop's backward operations in
# the same order, each rounded) and attention bitwise (its backward is
# autograd of the plain version); the bf16 expert products within a
# relative RMS of 2^-7: both sides round one float32 sum per element to
# bf16, and the two sums, in another order, differ by far less than a bf16
# ulp, so an element differs by at most one ulp, <= 2^-7 of itself
GRAD_TOL = 1e-4
GMM_GRAD_REL_RMS = 2.0 ** -7
# one gradient step at full width and depth 3, kernel path against plain
# path on the card: the RG-LRU layers are bitwise equal on both paths, so
# the two differ only by flash's bf16 forward (phase 7: within 2e-2, about a
# bf16 ulp on some elements); that moves the loss by far less than 1e-3 of
# itself and each gradient leaf, through bf16 roundings downstream of it,
# by some 1e-3 (relative RMS) where the leaf sums over positions, more for
# the embedding, whose rows each hold one position's cotangent
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_REL_RMS = 2e-2
# one gradient step of granite at full width and depth 3, kernel path
# against plain path on the card.  The router reads a hidden state that
# bf16 roundings at other places perturb, so a near-tied 8th and 9th
# expert can swap (phase 12), and a swap into a full expert moves which
# pair is dropped: a routing swap is a different step, not a rounding.  So
# the plain path replays the kernel path's routing (its experts, slots and
# kept pairs; the weights and the aux loss from the plain path's own router
# logits), and the two differ only by bf16 roundings at other places:
# flash's forward (about a bf16 ulp on some elements, as in phase 15) and
# the expert products (phase 11: a layer's output within 1e-3 relative
# RMS; phase 14: their gradients within ~1e-4).  These keep the loss and
# the aux sum within far less than 1e-3 of themselves and each gradient
# leaf within phase 15's 2e-2.  The share of pairs routed differently when
# the plain path routes for itself is printed; above 2e-2 it is not
# rounding: fail.
MOE_TRAIN_LOSS_RTOL = 1e-3
MOE_AUX_RTOL = 1e-3
MOE_FLIP_MAX = 2e-2
# device kernels by kind, for a profiled step's breakdown (the first group
# whose word is in the kernel's name)
DEVICE_GROUPS = (("port kernels", ("linear_scan", "flash_",
                                    "expert_matmul")),
                 ("matrix products", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("copies and fills", ("copy", "Memcpy", "Memset", "fill")),
                 ("reductions", ("reduce",)),
                 ("elementwise", ("elementwise",)))


def ptxas_usage(report: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from the report of ``nvcc -Xptxas -v``."""
    usage, fn, spill = {}, None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)),) + spill
    return usage


def off16(torch, x):
    """A copy of ``x`` whose data starts one float past a 16-byte
    boundary."""
    return torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phase 23: the paper figures' spec functions, rows and claims, as
# benchmarks/fig5.py, fig6.py and fig7.py have them (benchmarks/ imports
# the JAX package, so the script keeps its own copy; phase 23 checks that
# each copy's numpy spec hashes to the figure's committed store entry)
# ---------------------------------------------------------------------------

def fig5_experiment(ex, backend=None, panel="per_scheme", quick=False):
    mus = MUS[:2] if quick else MUS
    points = [(mu, frac * mu * mu, int(mu)) for mu in mus
              for _, frac in SIGMA_FRACS]
    return ex.ExperimentSpec(
        name="fig5-quick" if quick else "fig5",
        grid=ex.ScenarioGrid(K=K_PAPER, points=points),
        schemes=tuple(ex.scheme_spec(name) for name in FIG_SCHEMES),
        N=N_PAPER, trials=20, seed=1234, backend=backend, panel=panel)


def fig5_rows(result):
    points = result.spec.grid.points
    hets = result.spec.grid.specs()
    n = result.spec.N
    rows = [{"mu": mu, "sigma2": "0" if sigma2 == 0 else "mu^2/6",
             "lambda_sum": het.lambda_sum, "oracle": n / het.lambda_sum}
            for (mu, sigma2, _), het in zip(points, hets)]
    for name in result.keys():
        for row, rep in zip(rows, result.report(name)):
            row[name] = rep.t_comp
            if "L" in rep.extra:
                row[f"{name}_L"] = int(rep.extra["L"])
    for row in rows:
        for old, new in (("mds_opt", "mds"), ("we_known", "work_exchange"),
                         ("we_unknown", "work_exchange_unknown")):
            if new in row:
                row[old] = row[new]
    return rows


def fig5_validate(rows):
    checks = []
    for r in rows:
        tag = f"fig5[mu={r['mu']},s2={r['sigma2']}]"
        checks.append((f"{tag} WE-known within 5% of oracle",
                       r["we_known"] <= 1.05 * r["oracle"]))
        checks.append((f"{tag} WE-unknown within 10% of oracle",
                       r["we_unknown"] <= 1.10 * r["oracle"]))
        if r["sigma2"] != "0":
            checks.append((f"fig5[mu={r['mu']}] MDS >= WE at high sigma^2",
                           r["mds_opt"] >= r["we_known"]))
        checks.append((f"{tag} fixed >= oracle",
                       r["fixed"] >= r["oracle"] * 0.999))
    return checks


FIG6_MU, FIG6_SIGMA2S = 50.0, (0.0, 166.0, 333.0, 500.0, 666.0, 833.0)
FIG6_VARIANTS = (("known", "work_exchange"),
                 ("unknown", "work_exchange_unknown"))


def fig6_experiment(ex, backend=None, quick=False):
    sigma2s = FIG6_SIGMA2S[::2] if quick else FIG6_SIGMA2S
    n_draws = 5 if quick else 20
    points = [(FIG6_MU, sigma2, 1000 + d)
              for sigma2 in sigma2s for d in range(n_draws)]
    return ex.ExperimentSpec(
        name="fig6-quick" if quick else "fig6",
        grid=ex.ScenarioGrid(K=K_PAPER, points=points),
        schemes=tuple(ex.scheme_spec(name, key=label, threshold_frac=0.01)
                      for label, name in FIG6_VARIANTS),
        N=N_PAPER, trials=4, seed=2024, backend=backend)


def fig6_rows(result):
    n = result.spec.N
    sigma2s = sorted({s2 for _, s2, _ in result.spec.grid.points})
    n_draws = len(result.spec.grid) // len(sigma2s)
    rows = []
    for i, sigma2 in enumerate(sigma2s):
        cell = slice(i * n_draws, (i + 1) * n_draws)
        comm = {lbl: np.array([r.n_comm / n
                               for r in result.report(lbl)[cell]])
                for lbl, _ in FIG6_VARIANTS}
        iters = {lbl: np.array([r.iterations
                                for r in result.report(lbl)[cell]])
                 for lbl, _ in FIG6_VARIANTS}
        rows.append({"sigma2": sigma2,
                     "comm_known": float(comm["known"].mean()),
                     "comm_unknown": float(comm["unknown"].mean()),
                     "iters_known": float(iters["known"].mean()),
                     "iters_unknown": float(iters["unknown"].mean())})
    return rows


def fig6_validate(rows):
    first, last = rows[0], rows[-1]
    return [("fig6a known-het comm ~ 0 at every sigma^2",
             all(r["comm_known"] < 0.02 for r in rows)),
            ("fig6a unknown-het comm grows with sigma^2",
             last["comm_unknown"] > first["comm_unknown"]),
            ("fig6b iterations grow with sigma^2 (unknown)",
             last["iters_unknown"] >= first["iters_unknown"]),
            ("fig6b known <= unknown iterations at high sigma^2",
             last["iters_known"] <= last["iters_unknown"] + 1)]


FIG7_MU, FIG7_SIGMA2S = 50.0, (0.0, 277.0, 833.0)
FIG7_THRESH_FRACS = (0.001, 0.005, 0.01, 0.05, 0.2, 0.5)


def fig7_experiment(ex, backend=None, quick=False):
    fracs = FIG7_THRESH_FRACS[::2] if quick else FIG7_THRESH_FRACS
    sigma2s = FIG7_SIGMA2S[::2] if quick else FIG7_SIGMA2S
    points = [(FIG7_MU, sigma2, int(sigma2) + 7) for sigma2 in sigma2s]
    return ex.ExperimentSpec(
        name="fig7-quick" if quick else "fig7",
        grid=ex.ScenarioGrid(K=K_PAPER, points=points),
        schemes=tuple(ex.scheme_spec("work_exchange_unknown",
                                     key=f"th={frac}", threshold_frac=frac,
                                     seed=int(frac * 1e6))
                      for frac in fracs),
        N=N_PAPER, trials=8, backend=backend)


def fig7_rows(result):
    n = result.spec.N
    hets = result.spec.grid.specs()
    sigma2s = [s2 for _, s2, _ in result.spec.grid.points]
    rows = []
    for key in result.keys():
        frac = float(key.split("=", 1)[1])
        for sigma2, het, rep in zip(sigma2s, hets, result.report(key)):
            rows.append({"sigma2": sigma2, "threshold_frac": frac,
                         "iters": rep.iterations,
                         "t_comp_over_oracle":
                             rep.t_comp / (n / het.lambda_sum)})
    return rows


def fig7_validate(rows):
    checks = []
    by_sigma = {}
    for r in rows:
        by_sigma.setdefault(r["sigma2"], []).append(r)
    for sigma2, rs in by_sigma.items():
        rs = sorted(rs, key=lambda r: r["threshold_frac"])
        checks.append((f"fig7[s2={sigma2}] I non-increasing in threshold",
                       all(rs[i]["iters"] >= rs[i + 1]["iters"] - 0.5
                           for i in range(len(rs) - 1))))
    default = [r for r in rows if r["threshold_frac"] == 0.01]
    if default:
        checks.append(("fig7 default threshold keeps T within 10% of oracle",
                       all(r["t_comp_over_oracle"] < 1.10 for r in default)))
    return checks


FIGURES = {"fig5": (fig5_experiment, fig5_rows, fig5_validate),
           "fig6": (fig6_experiment, fig6_rows, fig6_validate),
           "fig7": (fig7_experiment, fig7_rows, fig7_validate)}


# ---------------------------------------------------------------------------
# phase 24: the load-vs-latency study's spec, rows and checks, as
# benchmarks/fig_load.py has them (the script keeps its own copy; phase 24
# checks that each copy's numpy spec hashes to its committed store entry)
# ---------------------------------------------------------------------------

def fig_load_experiment(ex, scenario: str, quick: bool = False,
                        trials: int = FIG_LOAD_TRIALS,
                        backend: str = "numpy"):
    from repro_torch.scenarios import DriftingScenario
    if scenario == "stationary":
        grid = ex.ScenarioGrid(K=FIG_LOAD_K, points=[FIG_LOAD_POINT])
    else:
        grid = DriftingScenario(K=FIG_LOAD_K, points=(FIG_LOAD_POINT,),
                                kind="ar1", rounds=24)
    return ex.ExperimentSpec(
        name=f"fig-load-{scenario}" + ("-quick" if quick else ""),
        grid=grid,
        schemes=tuple(ex.scheme_spec(name) for name in FIG_LOAD_SCHEMES),
        N=FIG_LOAD_N, trials=(6 if quick else trials), seed=1234,
        backend="numpy",
        serving=ex.ServingConfig(
            loads=FIG_LOAD_LOADS_QUICK if quick else FIG_LOAD_LOADS,
            slots=400 if quick else 2000, deadline_slo=FIG_LOAD_SLO,
            backend=backend))


def fig_load_rows(result):
    spec = result.spec
    scenario = ("drifting" if spec.grid.family == "drifting"
                else "stationary")
    lam_sum = spec.grid.specs()[0].lambda_sum
    rows = []
    for name in result.keys():
        for rep in result.report(name):
            e = rep.extra
            rows.append({
                "scenario": scenario, "scheme": name,
                "load": e["offered_load"],
                "offered_jobs_per_s": e["offered_load"] * lam_sum / spec.N,
                "sojourn": rep.t_comp, "p50": e["p50"], "p95": e["p95"],
                "p99": e["p99"], "throughput_jobs": e["throughput_jobs"]})
    return rows


def fig_load_validate(rows) -> list:
    """``benchmarks/fig_load.py:validate`` at the full sweep scale."""
    checks = []
    by = {}
    for r in rows:
        by.setdefault((r["scenario"], r["scheme"]), []).append(r)
    for (scen, scheme), rs in sorted(by.items()):
        rs = sorted(rs, key=lambda r: r["load"])
        lo, hi = rs[0], rs[-1]
        tag = f"fig_load[{scen},{scheme}]"
        checks.append((f"{tag} percentile ordering p50<=p95<=p99",
                       all(r["p50"] <= r["p95"] + 1e-12
                           and r["p95"] <= r["p99"] + 1e-12 for r in rs)))
        checks.append((f"{tag} positive latency and throughput at every "
                       f"load",
                       all(r["sojourn"] > 0 and r["throughput_jobs"] > 0
                           for r in rs)))
        checks.append((f"{tag} sojourn non-decreasing with load (0.98x)",
                       hi["sojourn"] >= 0.98 * lo["sojourn"]))
        checks.append((f"{tag} throughput tracks offered load below knee",
                       lo["throughput_jobs"]
                       >= 0.75 * lo["offered_jobs_per_s"]))
    stat = {s: sorted(rs, key=lambda r: r["load"])
            for (scen, s), rs in by.items() if scen == "stationary"}
    if "work_exchange" in stat and "fixed" in stat:
        we = sum(r["sojourn"] for r in stat["work_exchange"])
        fx = sum(r["sojourn"] for r in stat["fixed"])
        checks.append(("fig_load[stationary] work_exchange mean sojourn "
                       "<= 1.10x fixed over the sweep", we <= 1.10 * fx))
    if "het_mds" in stat:
        rs = stat["het_mds"]
        checks.append(("fig_load[stationary] het_mds (r=1.25) saturates: "
                       "top-load sojourn >= 1.3x lightest-load",
                       rs[-1]["sojourn"] >= 1.3 * rs[0]["sojourn"]))
    return checks


def fig5_specs(HetSpec):
    """One HetSpec per Figure 5 grid point, seeded per mu as in
    ``benchmarks/common.py:make_het``."""
    points, specs = [], []
    for mu in MUS:
        for label, frac in SIGMA_FRACS:
            points.append((mu, label))
            specs.append(HetSpec.uniform_random(
                K_PAPER, mu, frac * mu * mu, np.random.default_rng(int(mu))))
    return points, specs


def fig5_table(points, specs, reports) -> list:
    """Print the Figure 5 panel's mean T_comp per point and scheme, and
    return the paper's claims on it: 28 ``(name, ok)`` checks."""
    print("  mu     sigma2   oracle_exact " + " ".join(
        f"{n[:14]:>14s}" for n in SCHEMES))
    checks = []
    for g, ((mu, label), het) in enumerate(zip(points, specs)):
        exact = N_PAPER / het.lambda_sum
        row = {n: reports[n][g].t_comp for n in SCHEMES}
        print(f"  {mu:5.0f}  {label:7s}  {exact:12.2f} " + " ".join(
            f"{row[n]:14.2f}" for n in SCHEMES))
        for n in SCHEMES:
            rep = reports[n][g]
            if rep.trials != TRIALS or not np.isfinite(rep.t_comp):
                checks.append((f"{n}[mu={mu},{label}] finite, "
                               f"{TRIALS} trials", False))
        tag = f"fig5[mu={mu:g},s2={label}]"
        checks.append((f"{tag} WE-known within 5% of oracle",
                       row["work_exchange"] <= 1.05 * exact))
        checks.append((f"{tag} WE-unknown within 10% of oracle",
                       row["work_exchange_unknown"] <= 1.10 * exact))
        if label != "0":
            checks.append((f"{tag} MDS >= WE",
                           row["mds"] >= row["work_exchange"]))
        checks.append((f"{tag} fixed >= oracle",
                       row["fixed"] >= 0.999 * exact))
    return checks


def panel_rows(specs, trials: int, samplers):
    """The fused panel's stacked rows exactly as ``work_exchange_panel_
    cuda`` launches them: known rows over unknown rows, K padded to its
    bucket, rows padded with copies of row 0 to the row bucket."""
    lam = np.stack([h.lambdas for h in specs]).astype(np.float32)
    half = np.repeat(samplers._pad_cols(lam, samplers.bucket_cols(
        lam.shape[1])), trials, axis=0)
    B = half.shape[0]
    rows, _ = samplers._pad_rows(np.concatenate([half, half]), bucket=128)
    flags = np.concatenate([np.ones(B), np.zeros(B),
                            np.ones(rows.shape[0] - 2 * B)])
    return rows, flags.astype(np.float32)


def ar1_schedule(rows: np.ndarray, R: int, seed: int) -> np.ndarray:
    """A made-up drift: each worker's rate follows an AR(1) log-walk
    (coefficient 0.8, innovation 0.1) from its nominal rate."""
    rng = np.random.default_rng(seed)
    B, K = rows.shape
    x = np.zeros((B, R, K), np.float32)
    eps = rng.standard_normal((B, R, K)).astype(np.float32)
    for r in range(1, R):
        x[:, r] = 0.8 * x[:, r - 1] + 0.1 * eps[:, r]
    return (rows[:, None, :] * np.exp(x)).astype(np.float32)


def cuda_ms(torch, fn, reps: int = 3, sleep: bool = True) -> float:
    """Warm minimum over ``reps`` runs, timed with CUDA events.  With
    ``sleep``, a device sleep of ~1 ms before each run keeps the card busy
    while the host enqueues the run, so the events time the device's
    work, not the host's launch cost (which would dominate a 0.03 ms
    kernel); without it the events start on an idle card and the time
    includes the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        if sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def host_ms(torch, fn, calls: int = 100, reps: int = 3) -> float:
    """The host's cost of one call: warm minimum over ``reps`` of the
    host clock across ``calls`` calls enqueued back to back, divided by
    ``calls`` (the card runs them behind; fewer than its queue holds)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / calls * 1e3


def compare(torch, got, want):
    """Row-level agreement of two (B, 3) [t_comp, iters, n_comm] tensors."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    eq = g[:, 1] == w[:, 1]
    frac = float(eq.mean())
    t_rel = float(np.max(np.abs(g[eq, 0] - w[eq, 0]) / np.abs(w[eq, 0])))
    t_abs = float(np.max(np.abs(g[eq, 0] - w[eq, 0])))
    c_err = np.abs(g[eq, 2] - w[eq, 2])
    c_rel = float(np.max(c_err / np.maximum(np.abs(w[eq, 2]), 1e-30)))
    c_ok = bool(np.all(c_err <= C_ATOL + C_RTOL * np.abs(w[eq, 2])))
    n = g.shape[0]
    se = np.hypot(g[:, 0].std(), w[:, 0].std()) / np.sqrt(n)
    gap = abs(g[:, 0].mean() - w[:, 0].mean()) / max(se, 1e-30)
    ok = frac >= ROW_AGREE and t_rel <= T_RTOL and c_ok and gap <= MEAN_SE
    return ok, dict(rows_equal_iters=frac, t_comp_max_rel=t_rel,
                    t_comp_max_abs=t_abs, n_comm_max_rel=c_rel,
                    mean_gap_se=float(gap))


def mean_gap(a, b):
    """|mean_a - mean_b| of two reports in combined standard errors, and
    whether it is within 6 of them or 2e-3 of b (``mean_close``'s rule)."""
    se = np.hypot(a.t_comp_std / np.sqrt(a.trials),
                  b.t_comp_std / np.sqrt(b.trials))
    d = abs(a.t_comp - b.t_comp)
    return d / max(se, 1e-300), d < max(MEAN_SE * se, 2e-3 * b.t_comp)


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one sequence and head: the work the
    attention function needs on these shapes."""
    q_pos = np.arange(Sq) + (Sk - Sq)
    hi = np.minimum(q_pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window > 0 else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_bound(q, k, window: int, causal: bool = True):
    """(bound ms, bound_by, flops, bytes) of windowed attention on q (B,
    Sq, Hq, d) and k, v (B, Sk, Hkv, d), at the tensor cores' bf16 rate
    or, for float32 inputs, the FMA units' rate."""
    import torch
    B, Sq, Hq, d = q.shape
    flops = 4.0 * d * Hq * B * attention_pairs(Sq, k.shape[1], causal,
                                               window)
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, o; k, v
    rate = FP32_FLOPS_PER_S if q.dtype == torch.float32 \
        else BF16_FLOPS_PER_S
    ops_ms = flops / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes


class DeviceRow:
    """A profiled run's device events of one name (kernel, copy or fill):
    the fields of ``key_averages()``'s device row that this script reads,
    times in us."""

    def __init__(self, key: str):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def device_rows(torch, prof, nodes: tuple = ()):
    """The device events of a finished ``torch.profiler.profile``, one
    ``DeviceRow`` a name, and {node: (calls, device ms of the kernels
    launched inside it)} for each autograd node named in ``nodes``: what
    ``prof.key_averages()`` gives, read from the raw trace.
    ``key_averages()`` first builds a Python event tree of every CPU op,
    which takes about 80 us an event, over a minute for a generate's
    hundreds of thousands.  A kernel is inside a node when the op that
    launched it (its ``linked_correlation_id``) started within the node's
    span on the node's thread."""
    import bisect
    cuda = torch.autograd.DeviceType.CUDA
    rows, launched, op_at, spans = {}, [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            row = rows.get(e.name()) or rows.setdefault(e.name(),
                                                        DeviceRow(e.name()))
            row.count += 1
            row.self_device_time_total += e.duration_ns() / 1e3
            if nodes:
                launched.append((e.linked_correlation_id(), e.duration_ns()))
        elif nodes:
            op_at[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            name = e.name()
            if "evaluate_function" in name:
                for node in nodes:
                    if name.endswith(node):
                        spans.setdefault(e.start_thread_id(), []).append(
                            (e.start_ns(), e.end_ns(), node))
    inside = {node: [0, 0] for node in nodes}
    for thread_spans in spans.values():
        thread_spans.sort()
        for _, _, node in thread_spans:
            inside[node][0] += 1
    starts = {t: [s[0] for s in sp] for t, sp in spans.items()}
    for corr, ns in launched:
        thread, at = op_at.get(corr, (None, None))
        if thread not in spans:
            continue
        i = bisect.bisect_right(starts[thread], at) - 1
        if i >= 0 and at <= spans[thread][i][1]:
            inside[spans[thread][i][2]][1] += ns
    return list(rows.values()), {node: (n, ns / 1e6)
                                 for node, (n, ns) in inside.items()}


def profile_generate(torch, generate, label: str = "generate",
                     nodes: tuple = ()):
    """One profiled run of ``generate``: wall, the device's busy share, and
    the ten device kernels that took the most time.  Returns the device
    events (kernels, copies) with their device time, and {node: (calls,
    device ms of the kernels launched inside it)} for each autograd node
    named in ``nodes`` (such as ``"FlashAttentionBackward"``)."""
    from torch.profiler import ProfilerActivity, profile
    # the host's ops are recorded only where a node's span is asked for
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if nodes else [])) as prof:
        t0 = time.perf_counter()
        generate()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows, inside = device_rows(torch, prof, nodes)
    dev_events = [e for e in rows if e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in dev_events)
    if dev_us > 0:
        print(f"profiled {label}: wall {prof_wall * 1e3:.3f} ms, device "
              f"busy {dev_us / 1e3:.3f} ms "
              f"({100 * dev_us / (prof_wall * 1e6):.2f}% of wall); top "
              f"device time:")
        for e in sorted(dev_events,
                        key=lambda e: -e.self_device_time_total)[:10]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<5d} {e.key[:70]}")
    else:
        print(f"profiled {label}: the profiler recorded no device time "
              f"(device busy share not measured)")
    return dev_events, inside


def print_device_kinds(events) -> None:
    """A profiled run's device time by kind (``DEVICE_GROUPS``)."""
    groups = {}
    for e in events:
        group = next((g for g, words in DEVICE_GROUPS
                      if any(w in e.key for w in words)), "other")
        n, us = groups.get(group, (0, 0.0))
        groups[group] = (n + e.count, us + e.self_device_time_total)
    print("  its device time by kind: " + "; ".join(
        f"{g} {us / 1e3:.3f} ms (x{n})" for g, (n, us) in sorted(
            groups.items(), key=lambda kv: -kv[1][1])))


def leaves(tree):
    """The tensors of a parameter tree."""
    if isinstance(tree, dict):
        for x in tree.values():
            yield from leaves(x)
    else:
        yield tree


def describe_params(params) -> tuple:
    """(parameter count, bytes) of a parameter tree."""
    return (sum(x.numel() for x in leaves(params)),
            sum(x.numel() * x.element_size() for x in leaves(params)))


def rel_rms(got, want, dims=None):
    """Relative RMS of ``got - want`` (over ``dims``, or all)."""
    d = (got.float() - want.float()).pow(2)
    w = want.float().pow(2)
    if dims is None:
        return float(d.mean().sqrt() / w.mean().sqrt())
    return d.mean(dims).sqrt() / w.mean(dims).sqrt()


def check_flash(torch, draw, case, row_rms=None):
    """Hold ``flash_attention_cuda`` against ``attention_ref`` on one
    case (B, Sq, Sk, Hq, Hkv, d, causal, window, dtype name) of inputs
    from ``draw``, at ``FLASH_TOL`` and, given ``row_rms``, each query
    row's relative RMS difference within it (which must also fail the
    plain version with its softmax scale 1% off, over ``SCALE_SEEN_MIN_KEYS``
    keys or more).  Returns (ok, max abs error, label, (q, k, v))."""
    from repro_torch.kernels._build import DESIGN_COUNTS
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda,
                                                     flash_attention_design)
    B, Sq, Sk, Hq, Hkv, d, causal, window, dt = case
    dtype = getattr(torch, dt)
    q = draw((B, Sq, Hq, d), dtype)
    k, v = draw((B, Sk, Hkv, d), dtype), draw((B, Sk, Hkv, d), dtype)
    design = flash_attention_design(dtype, d)
    before = DESIGN_COUNTS[("flash_attention", design)]
    got = flash_attention_cuda(q, k, v, causal, window)
    took = DESIGN_COUNTS[("flash_attention", design)] - before
    want = attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = FLASH_TOL[dt]
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    ok = ok and took == 1
    rows = ""
    if row_rms is not None:
        worst = float(rel_rms(got, want, (2, 3)).max())
        # what the check reads of a softmax scale 1% off, for scale
        off = float(rel_rms(attention_ref(q, k, v, causal, window,
                                          1.01 * d ** -0.5), want,
                            (2, 3)).max())
        seen = off > row_rms or Sk < SCALE_SEEN_MIN_KEYS
        ok = ok and worst <= row_rms and seen
        rows = f", worst row's relative RMS {worst:.3e} (limit " \
            f"{row_rms:.3e}; the plain version with its scale 1% off " \
            f"reads {off:.3e}{'' if seen else ', which the check MISSES'})"
    label = f"({B},{Sq},{Sk},{Hq},{Hkv},{d}) causal={causal} " \
        f"window={window} {dt}"
    print(f"  flash_attention {label}: {'ok' if ok else 'FAIL'} "
          f"max_abs_err={err:.3e} (tol {tol}){rows}, design {design} "
          f"({took} launch)")
    return ok, err, label, (q, k, v)


def time_flash(torch, qkv, window: int):
    """Causal flash attention on one main path's q, k, v: the kernel, its
    plain version and ``scaled_dot_product_attention`` (an explicit
    window mask, else ``is_causal``; ``enable_gqa``), warm min of 3 of
    device time, and the bound; the kernel and sdpa also with the host's
    launch cost.  Returns (ms, plain ms, library ms, bound ms,
    bound_by), all device times."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    q, k, v = qkv
    def kernel():
        return flash_attention_cuda(q, k, v, True, window)

    f_ms = cuda_ms(torch, kernel)
    f_plain = cuda_ms(torch, lambda: attention_ref(q, k, v, True, window))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window:
        pos = torch.arange(q.shape[1], device=q.device)
        kw = dict(attn_mask=(pos[None, :] <= pos[:, None])
                  & (pos[None, :] > pos[:, None] - window))
    else:
        kw = dict(is_causal=True)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw)

    lib_err = float((sdpa().transpose(1, 2).float()
                     - attention_ref(q, k, v, True, window).float()
                     ).abs().max())
    f_lib = cuda_ms(torch, sdpa)
    f_launch, lib_launch = (cuda_ms(torch, fn, sleep=False)
                            for fn in (kernel, sdpa))
    f_bound, f_by, f_flops, f_bytes = flash_bound(q, k, window)
    print(f"flash_attention at {tuple(q.shape)} kv {tuple(k.shape)} "
          f"{str(q.dtype).replace('torch.', '')}, window {window}: kernel "
          f"{f_ms:.4f} ms ({f_flops / f_ms / 1e9:.1f} TFLOP/s, "
          f"{f_bound / f_ms:.3f} of the bound), plain {f_plain:.4f} ms, sdpa "
          f"({'explicit mask' if window else 'is_causal'}, enable_gqa; max "
          f"|diff| {lib_err:.3e}) {f_lib:.4f} ms; kernel / sdpa "
          f"{f_ms / f_lib:.3f}; bound {f_bound:.4f} ms by "
          f"{f_by} ({f_flops:.4e} flops, {f_bytes} bytes); with the "
          f"host's launch cost (no device sleep): kernel {f_launch:.4f} ms, "
          f"sdpa {lib_launch:.4f} ms")
    return f_ms, f_plain, f_lib, f_bound, f_by


def we_rounds_bound(rows, out, extra=()):
    """(bound ms, bound_by, int ops, bytes) of one ``we_rounds`` launch on
    rates ``rows`` (B, K) that gave ``out`` (B, 3), from this run's
    rounds: every busy cell-round needs its Gamma and Binomial Threefry
    pairs (a loose floor: no boost pairs, transcendentals or reductions,
    every lane useful).  Bytes: the rows, the output and the ``extra``
    tensors (a rate schedule, panel flags; None skipped), each once."""
    rounds = float((out[:, 1].double()
                    * (rows > 0).sum(dim=1).double()).sum())
    ops = rounds * 2 * THREEFRY_INT_OPS
    nbytes = 4 * (rows.numel() + out.numel()
                  + sum(t.numel() for t in extra if t is not None))
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes", ops, nbytes


def gmm_bound(E: int, C: int, D: int, F: int, elem: int):
    """(bound ms, bound_by, flops, bytes) of (E, C, D) x (E, D, F): each
    operand read once and the output written once, 2 flops per
    multiply-add at the bf16 tensor-core rate."""
    flops = 2.0 * E * C * D * F
    nbytes = (E * C * D + E * D * F + E * C * F) * elem
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel ops to their plain versions, also on
    CUDA tensors: the plain path on the card that the served logits and
    the training step's gradients (autograd of the plain versions) are
    held against.  The launch counts show that no kernel ran inside."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.linear_scan import linear_scan_ref
    from repro_torch.kernels.moe_gmm import expert_matmul_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import recurrent as rec_mod
    saved = attn_mod.flash_attention, rec_mod.linear_scan, \
        moe_mod.expert_matmul
    attn_mod.flash_attention, rec_mod.linear_scan, moe_mod.expert_matmul = \
        attention_ref, linear_scan_ref, expert_matmul_ref
    try:
        yield
    finally:
        attn_mod.flash_attention, rec_mod.linear_scan, \
            moe_mod.expert_matmul = saved


def serve_phases(torch, dev):
    """Phases 7-9; returns the two serving kernels' JSON entries."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.linear_scan import (linear_scan_cuda,
                                                 linear_scan_design,
                                                 linear_scan_ref)
    from repro_torch.models import build_model
    from repro_torch.models.transformer import lm_prefill_hidden
    from repro_torch.train.serve import greedy_generate

    # the plain versions' float32 products stay full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(12)

    def draw(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    # 7. each serving kernel against its plain version on the card
    failed = []
    cfg = get_config(SERVE_ARCH)
    S, W = SERVE_PROMPT, cfg.window
    main_flash = (SERVE_B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd, True,
                  W, cfg.dtype)
    flash_cases = [main_flash] + [
        (B, Sq, Sk, Hq, Hkv, d, causal, window, dt)
        for dt in ("float32", "bfloat16")
        for (B, Sq, Sk, Hq, Hkv, d, causal, window) in [
            (2, 256, 256, 4, 2, 64, True, 0),        # GQA, g = 2
            (2, 200, 200, 4, 2, 128, False, 0),      # non-causal
            (1, 96, 300, 4, 1, 64, True, 0),         # Sq < Sk
            (1, 1000, 1000, 4, 2, 128, True, 300),   # ragged, window
            (1, 1000, 1000, 10, 1, 256, True, 512),  # MQA, d 256
        ]] + [
        # bf16 edges of the tensor-core design's 64-row query tiles and
        # 64-key (32 at d 256) key tiles: Sq and Sk no multiple of either,
        # windows no multiple of a key tile, Sq < Sk and Sq > Sk
        (B, Sq, Sk, Hq, Hkv, d, causal, window, "bfloat16")
        for (B, Sq, Sk, Hq, Hkv, d, causal, window) in [
            (1, 77, 190, 4, 2, 64, True, 50),        # Sq < Sk, window 50
            (2, 190, 77, 2, 1, 32, True, 0),         # Sq > Sk: rows see none
            (1, 300, 333, 10, 1, 256, True, 100),    # d 256, window 100
            (1, 257, 257, 3, 3, 16, False, 0),       # one row past a tile
            (1, 129, 200, 2, 2, 128, False, 70),     # non-causal window 70
        ]]
    flash_err = 0.0
    main_qkv = None
    for case in flash_cases:
        ok, err, label, qkv = check_flash(torch, draw, case)
        if case == main_flash:
            flash_err, main_qkv = err, qkv
        if not ok:
            failed.append(f"flash_attention {label}")
    q, k, v = main_qkv
    again = [flash_attention_cuda(q, k, v, True, W) for _ in range(2)]
    same = bool(torch.equal(again[0], again[1]))
    print(f"  flash_attention at the main shape, two launches: "
          f"{'bitwise equal' if same else 'DIFFER'}")
    if not same:
        failed.append("flash_attention is not deterministic")
    del again, q, k, v
    scan_err = 0.0
    main_ab = None
    main_scan = (SERVE_B, S, cfg.lru_width)
    # both designs: the ring where TMA can describe the rows (D a multiple
    # of 4, 16-byte aligned pointers), else direct; at the main shape once
    # more on pointers one float past a 16-byte boundary (direct)
    for shape, aligned in [(main_scan, True), (main_scan, False),
                           ((1, S, cfg.lru_width), True),
                           ((3, 1001, 96), True), ((3, 1001, 97), True),
                           ((2, 65, 100), True)]:
        a = torch.rand(shape, generator=gen, device=dev) * 0.5 + 0.5
        b = draw(shape, torch.float32)
        if not aligned:
            a, b = off16(torch, a), off16(torch, b)
        design = linear_scan_design(shape[2], aligned)
        before = _build.DESIGN_COUNTS[("linear_scan", design)]
        got = linear_scan_cuda(a, b)
        took = _build.DESIGN_COUNTS[("linear_scan", design)] - before
        want = linear_scan_ref(a, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.equal(got, want)) and took == 1
        print(f"  linear_scan {shape} design {design} ({took} launch): "
              f"{'ok' if ok else 'FAIL'} max_abs_err={err:.3e} (bitwise)")
        if shape == main_scan:
            scan_err = max(scan_err, err)
            if design == "ring":
                main_ab = (a, b)
        if not ok:
            failed.append(f"linear_scan {shape} {design}")
    if failed:
        fail("kernel vs plain: " + "; ".join(failed))

    # 8. the main path: recurrentgemma-2b at full width and depth, bf16
    model = build_model(cfg)
    kinds = cfg.layer_kinds()
    want_launches = {"flash_attention": kinds.count("attn"),
                     "linear_scan": kinds.count("rec")}
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params, n_bytes = describe_params(params)
    print(f"main path: {SERVE_ARCH} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"{n_params:.4e} parameters ({n_bytes / 1e9:.3f} GB), drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_B, S))).to(dev)
    s_max = S + SERVE_STEPS

    def generate():
        return greedy_generate(model, params, {"tokens": prompt},
                               model.init_cache(SERVE_B, s_max, dev),
                               SERVE_STEPS)

    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    toks, _ = generate()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: _build.LAUNCH_COUNTS[n] for n in want_launches}
    designs = dict(_build.DESIGN_COUNTS)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  served {SERVE_B} x {S} prompt tokens + {SERVE_STEPS} new "
          f"tokens in {first_s:.3f} s (first run); launches {launches} "
          f"(want {want_launches}); designs {designs}; peak memory "
          f"{peak_gb:.3f} GB")
    if launches != want_launches:
        fail(f"the main path's launches {launches} are not "
             f"{want_launches}")
    if designs[("flash_attention", "tc")] != want_launches["flash_attention"]:
        fail(f"the main path's bf16 flash launches did not all take the "
             f"tensor-core design: {designs}")
    if designs[("linear_scan", "ring")] != want_launches["linear_scan"]:
        fail(f"the main path's scan launches did not all take the ring "
             f"design: {designs}")
    if tuple(toks.shape) != (SERVE_B, SERVE_STEPS) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"generated tokens of shape {tuple(toks.shape)} outside "
             f"[0, {cfg.vocab_size})")

    # the served logits, step by step, with the generated tokens fed back
    cache = model.init_cache(SERVE_B, s_max, dev)
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    served = [logits[:, -1].float()]
    for j in range(SERVE_STEPS - 1):
        logits, cache = model.decode_step(params, cache, toks[:, j:j + 1])
        served.append(logits[:, -1].float())
    served = torch.stack(served, 1)                       # (B, steps, V)
    replay = float((served.argmax(-1) == toks).float().mean())
    # the same tokens teacher-forced through the plain path on the card
    full = torch.cat([prompt, toks[:, :-1]], 1)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_kernels():
        h, _ = lm_prefill_hidden(params, cfg, {"tokens": full},
                                 model.init_cache(SERVE_B, s_max, dev))
        plain = (h[:, S - 1:] @ params["lm_head"]).float()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if any(_build.LAUNCH_COUNTS.values()):
        fail(f"the plain path launched kernels: {_build.LAUNCH_COUNTS}")
    step_rms = rel_rms(served, plain, (0, 2))                 # per step
    max_abs = float((served - plain).abs().max())
    agree = float((plain.argmax(-1) == toks).float().mean())
    print(f"  teacher-forced plain path ({plain_s:.2f} s): logits max "
          f"|diff| {max_abs:.4e} (max |logit| "
          f"{float(plain.abs().max()):.4f}); relative RMS per step: prefill "
          f"{float(step_rms[0]):.3e}, decode max "
          f"{float(step_rms[1:].max()):.3e} (limit {LOGIT_REL_RMS}); greedy "
          f"tokens agreeing with the "
          f"plain path {agree:.4f}; served argmax replayed {replay:.4f}")
    if not bool(torch.isfinite(served).all()):
        fail("served logits are not finite")
    if float(step_rms.max()) > LOGIT_REL_RMS:
        fail(f"served logits differ from the plain path: relative RMS "
             f"{float(step_rms.max()):.3e} > {LOGIT_REL_RMS}")
    del served, plain, h, cache, logits

    # 9. times: both kernels at the main path's shape, then the path
    f_ms, f_plain, f_lib, f_bound, f_by = time_flash(torch, main_qkv, W)
    # the scan: the ring at the main shape and at one request, and the
    # direct design at the main shape (the same values one float past a
    # 16-byte boundary) for comparison
    a, b = main_ab
    scan_times = []
    for (x, y), design in [(main_ab, "ring"),
                           ((a[:1].clone(), b[:1].clone()), "ring"),
                           ((off16(torch, a), off16(torch, b)), "direct")]:
        k_ms = cuda_ms(torch, lambda: linear_scan_cuda(x, y))
        s_bytes = 3 * x.numel() * 4
        s_bound = s_bytes / HBM_BYTES_PER_S * 1e3
        scan_times.append((k_ms, s_bound))
        print(f"linear_scan at {tuple(x.shape)} f32, design {design}: "
              f"kernel {k_ms:.4f} ms ({s_bytes / k_ms / 1e9:.3f} TB/s, "
              f"{s_bound / k_ms:.3f} of the bound); bound {s_bound:.4f} ms "
              f"by bytes ({s_bytes} bytes); no single PyTorch call")
    s_plain = cuda_ms(torch, lambda: linear_scan_ref(a, b))
    s_ms, s_bound = scan_times[0]
    print(f"linear_scan plain version at {tuple(a.shape)}: {s_plain:.4f} ms")
    del x, y, a, b

    prefill_s = gen_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": prompt},
                      model.init_cache(SERVE_B, s_max, dev))
        torch.cuda.synchronize()
        prefill_s = min(prefill_s, time.perf_counter() - t0)
        t0 = time.perf_counter()
        generate()
        torch.cuda.synchronize()
        gen_s = min(gen_s, time.perf_counter() - t0)
    decode_ms = (gen_s - prefill_s) / (SERVE_STEPS - 1) * 1e3
    print(f"serve {SERVE_ARCH} {SERVE_B} x {S} + {SERVE_STEPS} (warm min "
          f"of 2): prefill {prefill_s * 1e3:.3f} ms "
          f"({SERVE_B * S / prefill_s:.1f} prompt tok/s), decode "
          f"{decode_ms:.3f} ms per step, generate {gen_s * 1e3:.3f} ms "
          f"({SERVE_B * SERVE_STEPS / gen_s:.2f} new tok/s); peak memory "
          f"{peak_gb:.3f} GB")
    profile_generate(torch, generate)
    return [
        {"name": "linear_scan", "path": SERVE_ARCH, "route": "cuda",
         "source": "src/repro_torch/csrc/linear_scan.cu",
         "replaces": "src/repro/kernels/linear_scan/kernel.py:22",
         "launches": launches["linear_scan"], "max_abs_err": scan_err,
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "flash_attention", "path": SERVE_ARCH, "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
         "launches": launches["flash_attention"], "max_abs_err": flash_err,
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": f_lib},
    ]


def time_serve(torch, model, params, prompt, generate, dev, reps: int):
    """Warm minimum of ``reps`` of a prefill of ``prompt`` and of a whole
    ``generate`` of ``MOE_STEPS`` tokens (host clock): (prefill s,
    generate s, decode ms a step)."""
    prefill_s = gen_s = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": prompt},
                      model.init_cache(prompt.shape[0],
                                       prompt.shape[1] + MOE_STEPS, dev))
        torch.cuda.synchronize()
        prefill_s = min(prefill_s, time.perf_counter() - t0)
        t0 = time.perf_counter()
        generate()
        torch.cuda.synchronize()
        gen_s = min(gen_s, time.perf_counter() - t0)
    return prefill_s, gen_s, (gen_s - prefill_s) / (MOE_STEPS - 1) * 1e3


def prefill_dropped(torch, model, params, prompt, dev) -> float:
    """Share of (token, k) pairs one prefill of ``prompt`` drops, over
    its MoE layers."""
    with torch.no_grad(), recorded_routes(torch) as routes:
        model.prefill(params, {"tokens": prompt},
                      model.init_cache(prompt.shape[0],
                                       prompt.shape[1] + MOE_STEPS, dev))
    return dropped_share(routes)


def granite_serve(torch, dev) -> None:
    """``python3 chip_smoke.py --granite-serve``: phases 12 and 13's
    serving of granite-moe-3b-a800m alone, to compare two trees' ``src``
    in one call (run the script from each tree's root in turn).  Builds
    flash and the expert product, serves phase 12's requests once with
    the launches counted, and prints one JSON line: the share of (token,
    k) pairs a prefill drops, and the prefill, generate and decode times
    (warm min of 3)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.moe_gmm import kernel as gk
    from repro_torch.models import build_model
    from repro_torch.train.serve import greedy_generate

    _build.build_all([fk.LIBRARY, gk.LIBRARY])
    cfg = get_config(MOE_ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_B, MOE_PROMPT))).to(dev)

    def generate():
        return greedy_generate(model, params, {"tokens": prompt},
                               model.init_cache(MOE_B, MOE_PROMPT + MOE_STEPS,
                                                dev), MOE_STEPS)

    _build.reset_launch_counts()
    generate()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCH_COUNTS.items() if v}
    want = {"flash_attention": cfg.n_layers,
            "expert_matmul": 3 * cfg.n_layers * MOE_STEPS}
    if launches != want:
        fail(f"granite serving launched {launches}, not {want}")
    prefill_s, gen_s, decode_ms = time_serve(torch, model, params, prompt,
                                             generate, dev, 3)
    print(json.dumps({"granite_serve": {
        "src": str(SRC), "launches": launches,
        "dropped": prefill_dropped(torch, model, params, prompt, dev),
        "prefill_ms": prefill_s * 1e3, "generate_ms": gen_s * 1e3,
        "decode_ms": decode_ms}}))


def moe_phases(torch, dev):
    """Phases 10-13; returns the JSON entries of expert_matmul and of
    flash_attention at granite's shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import (expert_matmul_cuda,
                                             expert_matmul_design,
                                             expert_matmul_ref)
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import _window
    from repro_torch.train.serve import greedy_generate

    cfg = get_config(MOE_ARCH)
    E, D, Ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    T = MOE_B * MOE_PROMPT
    C = moe_mod._capacity(T, cfg)
    C_dec = moe_mod._capacity(MOE_B, cfg)
    gen = torch.Generator(device=dev).manual_seed(13)

    def operands(E_, C_, D_, F_, dtype):
        buf = torch.randn((E_, C_, D_), generator=gen, device=dev).to(dtype)
        w = (torch.randn((E_, D_, F_), generator=gen, device=dev)
             * D_ ** -0.5).to(dtype)
        return buf, w

    def draw(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # 10. the kernel against its plain version on the card, and flash
    # attention at the shape of granite's prefill (GQA 24/8, d 64, ragged)
    flash_case = (MOE_B, MOE_PROMPT, MOE_PROMPT, cfg.n_heads,
                  cfg.n_kv_heads, cfg.hd, True, _window(cfg), cfg.dtype)
    flash_ok, flash_err, flash_label, flash_qkv = check_flash(
        torch, draw, flash_case)
    main_shapes = {"prefill gate/up": (E, C, D, Ff),
                   "prefill down": (E, C, Ff, D),
                   "decode gate/up": (E, C_dec, D, Ff),
                   "decode down": (E, C_dec, Ff, D)}
    cases = [(label, shape, "bfloat16")
             for label, shape in main_shapes.items()] + [
        ("ragged", shape, dt) for dt in ("float32", "bfloat16")
        for shape in [(1, 1, 24, 96), (3, 7, 200, 24), (8, 130, 96, 200),
                      (5, 130, 200, 200), (8, 7, 24, 24), (2, 1, 96, 200)]
    ] + [
        # bf16 edges of the tensor-core design: C of 1, 8, 16 (decode
        # tiles) and 17, 200 (no multiple of the 128-row tile); D of 40,
        # 72, 200, 1000 (no multiple of the 64-deep slab); F of 24, 136,
        # 264, 520 (no multiple of the 64- or 128-column tile); and D, F
        # no multiple of 8, which takes the FMA design
        ("edge", shape, "bfloat16")
        for shape in [(4, 1, 40, 72), (4, 8, 200, 136), (4, 16, 72, 24),
                      (4, 17, 200, 136), (3, 200, 1000, 264),
                      (2, 130, 72, 520), (2, 17, 1, 5)]]
    failed = [] if flash_ok else [f"flash_attention {flash_label}"]
    gmm_err = 0.0
    for label, (e, c, d, f), dt in cases:
        buf, w = operands(e, c, d, f, getattr(torch, dt))
        design = expert_matmul_design(buf.dtype, d, f)
        before = _build.DESIGN_COUNTS[("expert_matmul", design)]
        got = expert_matmul_cuda(buf, w)
        took = _build.DESIGN_COUNTS[("expert_matmul", design)] - before
        want = expert_matmul_ref(buf, w)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = GMM_TOL[dt]
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol)) and took == 1
        same = ""
        if label in main_shapes:
            gmm_err = max(gmm_err, err)
            again = expert_matmul_cuda(buf, w)
            ok = ok and bool(torch.equal(got, again))
            same = (", a second launch bitwise equal"
                    if torch.equal(got, again) else ", a second launch DIFFERS")
        print(f"  expert_matmul {label} ({e},{c},{d})x({e},{d},{f}) {dt}: "
              f"{'ok' if ok else 'FAIL'} max_abs_err={err:.3e} (tol {tol}), "
              f"design {design} ({took} launch){same}")
        if not ok:
            failed.append(f"expert_matmul {label} {(e, c, d, f)} {dt}")
    if failed:
        fail("kernel vs plain: " + "; ".join(failed))

    # 11. one MoE layer at full width: kernel against plain
    layer = moe_mod.moe_init(gen, cfg, torch.bfloat16, dev)
    x = torch.randn((MOE_B, MOE_PROMPT, D), generator=gen,
                    device=dev).to(torch.bfloat16)
    _build.reset_launch_counts()
    out_k, aux_k = moe_mod.moe_apply(layer, cfg, x)
    torch.cuda.synchronize()
    n_kernel = _build.LAUNCH_COUNTS["expert_matmul"]
    _build.reset_launch_counts()
    with plain_kernels():
        out_p, aux_p = moe_mod.moe_apply(layer, cfg, x)
    torch.cuda.synchronize()
    n_plain = sum(_build.LAUNCH_COUNTS.values())
    _, _, keep, C_x, _ = moe_mod.route(layer, cfg, x)
    dropped = float((~keep).float().mean())
    layer_rms = rel_rms(out_k, out_p)
    print(f"moe layer {tuple(x.shape)} bf16, E {E} top-{cfg.experts_per_token}"
          f" C {C_x}: kernel launches {n_kernel} (plain path {n_plain}); "
          f"output relative RMS {layer_rms:.3e} (limit {MOE_LAYER_REL_RMS}),"
          f" max |diff| {float((out_k - out_p).abs().max()):.4e}; aux "
          f"{float(aux_k):.6f} vs {float(aux_p):.6f}; (token, k) pairs "
          f"dropped {dropped:.6f}")
    if n_kernel != 3 or n_plain != 0:
        fail(f"moe layer launches: kernel path {n_kernel} (want 3), plain "
             f"path {n_plain} (want 0)")
    if not bool(torch.isfinite(out_k).all()) or \
            layer_rms > MOE_LAYER_REL_RMS or not bool(aux_k == aux_p):
        fail(f"moe layer: kernel against plain relative RMS "
             f"{layer_rms:.3e}, aux {float(aux_k)} vs {float(aux_p)}")
    del layer, x, out_k, out_p, keep

    # 12. the main path: granite-moe-3b-a800m at full width and depth
    model = build_model(cfg)
    want_launches = {"we_rounds": 0, "linear_scan": 0,
                     "flash_attention": cfg.n_layers,
                     "expert_matmul": 3 * cfg.n_layers * MOE_STEPS}
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params, n_bytes = describe_params(params)
    print(f"main path: {MOE_ARCH} {cfg.n_layers} layers, d_model {D}, "
          f"{E} experts top-{cfg.experts_per_token} d_ff {Ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {n_params:.4e} parameters "
          f"({n_bytes / 1e9:.3f} GB), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_B, MOE_PROMPT))).to(dev)
    s_max = MOE_PROMPT + MOE_STEPS

    def generate():
        return greedy_generate(model, params, {"tokens": prompt},
                               model.init_cache(MOE_B, s_max, dev),
                               MOE_STEPS)

    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    toks, _ = generate()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCH_COUNTS)
    designs = dict(_build.DESIGN_COUNTS)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  served {MOE_B} x {MOE_PROMPT} prompt tokens + {MOE_STEPS} new "
          f"tokens in {first_s:.3f} s (first run); launches {launches} "
          f"(want {want_launches}); designs {designs}; peak memory "
          f"{peak_gb:.3f} GB")
    if launches != want_launches:
        fail(f"the main path's launches {launches} are not {want_launches}")
    if designs[("flash_attention", "tc")] != want_launches["flash_attention"] \
            or designs[("expert_matmul", "tc")] \
            != want_launches["expert_matmul"]:
        fail(f"the main path's bf16 launches did not all take the "
             f"tensor-core designs: {designs}")
    if tuple(toks.shape) != (MOE_B, MOE_STEPS) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"generated tokens of shape {tuple(toks.shape)} outside "
             f"[0, {cfg.vocab_size})")

    V = cfg.vocab_size

    def schedule():
        """Prefill, then decode fed the served tokens: (B, steps, V), the
        logits of the real vocabulary (the padded slots are masked to
        bf16's lowest value, whose square overflows float32)."""
        cache = model.init_cache(MOE_B, s_max, dev)
        logits, cache = model.prefill(params, {"tokens": prompt}, cache)
        out = [logits[:, -1, :V].float()]
        for j in range(MOE_STEPS - 1):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, j:j + 1])
            out.append(logits[:, -1, :V].float())
        return torch.stack(out, 1)

    served = schedule()
    replay = float((served.argmax(-1) == toks).float().mean())
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_kernels():
        plain = schedule()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if any(_build.LAUNCH_COUNTS.values()):
        fail(f"the plain path launched kernels: {_build.LAUNCH_COUNTS}")
    step_rms = rel_rms(served, plain, (0, 2))                 # per step
    agree = float((plain.argmax(-1) == toks).float().mean())
    print(f"  plain path, same schedule ({plain_s:.2f} s): logits max "
          f"|diff| {float((served - plain).abs().max()):.4e} (max |logit| "
          f"{float(plain.abs().max()):.4f}); relative RMS per step: prefill "
          f"{float(step_rms[0]):.3e}, decode max "
          f"{float(step_rms[1:].max()):.3e}, mean "
          f"{float(step_rms[1:].mean()):.3e} (limit {MOE_LOGIT_REL_RMS}); "
          f"greedy tokens agreeing with the plain path {agree:.4f}; served "
          f"argmax replayed {replay:.4f}")
    if not bool(torch.isfinite(served).all()) or \
            not bool(torch.isfinite(step_rms).all()):
        fail("served logits or their relative RMS are not finite")
    if float(step_rms.max()) > MOE_LOGIT_REL_RMS:
        fail(f"served logits differ from the plain path: relative RMS "
             f"{float(step_rms.max()):.3e} > {MOE_LOGIT_REL_RMS}")
    if replay != 1.0:
        fail(f"replaying the served logits gives back {replay:.4f} of the "
             f"served tokens")
    del served, plain

    # 13. times: the kernel at the main path's shapes, then the path
    times = {}
    for label, shape in main_shapes.items():
        buf, w = operands(*shape, torch.bfloat16)
        def kernel():
            return expert_matmul_cuda(buf, w)

        def library():
            return torch.bmm(buf, w)

        k_ms = cuda_ms(torch, kernel)
        p_ms = cuda_ms(torch, lambda: expert_matmul_ref(buf, w))
        l_ms = cuda_ms(torch, library)
        k_launch, l_launch = (cuda_ms(torch, fn, sleep=False)
                              for fn in (kernel, library))
        k_host, l_host = (host_ms(torch, fn) for fn in (kernel, library))
        bound, by, flops, nbytes = gmm_bound(*buf.shape, w.shape[2],
                                             buf.element_size())
        times[label] = (k_ms, p_ms, l_ms, bound, by)
        print(f"expert_matmul {label} {tuple(buf.shape)}x{tuple(w.shape)} "
              f"bf16: kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.2f} "
              f"TFLOP/s, {nbytes / k_ms / 1e9:.3f} TB/s, {bound / k_ms:.3f} "
              f"of the bound), plain {p_ms:.4f} ms, torch.bmm {l_ms:.4f} ms; "
              f"kernel / torch.bmm {k_ms / l_ms:.3f}; bound {bound:.4f} ms by "
              f"{by} ({flops:.4e} flops, {nbytes} bytes); with the "
              f"host's launch cost (no device sleep): kernel {k_launch:.4f} "
              f"ms, torch.bmm {l_launch:.4f} ms; host cost a call: kernel "
              f"{k_host:.4f} ms, torch.bmm {l_host:.4f} ms")
    per_generate = sum(
        n * times[label][0] for label, n in (
            ("prefill gate/up", 2), ("prefill down", 1),
            ("decode gate/up", 2 * (MOE_STEPS - 1)),
            ("decode down", MOE_STEPS - 1))) * cfg.n_layers
    print(f"expert_matmul per generate: {per_generate:.3f} ms of kernel "
          f"time (the four shapes' times x their launches)")
    f_ms, f_plain, f_lib, f_bound, f_by = time_flash(torch, flash_qkv,
                                                     _window(cfg))
    del flash_qkv

    prefill_s, gen_s, decode_ms = time_serve(torch, model, params, prompt,
                                             generate, dev, 2)
    print(f"serve {MOE_ARCH} {MOE_B} x {MOE_PROMPT} + {MOE_STEPS} (warm min "
          f"of 2): prefill {prefill_s * 1e3:.3f} ms "
          f"({MOE_B * MOE_PROMPT / prefill_s:.1f} prompt tok/s), decode "
          f"{decode_ms:.3f} ms per step, generate {gen_s * 1e3:.3f} ms "
          f"({MOE_B * MOE_STEPS / gen_s:.2f} new tok/s); peak memory "
          f"{peak_gb:.3f} GB; (token, k) pairs a prefill drops "
          f"{prefill_dropped(torch, model, params, prompt, dev):.6f}")
    profile_generate(torch, generate)
    k_ms, p_ms, l_ms, bound, by = times["prefill gate/up"]
    return [
        {"name": "flash_attention", "path": MOE_ARCH, "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
         "launches": launches["flash_attention"], "max_abs_err": flash_err,
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": f_lib},
        {"name": "expert_matmul", "path": MOE_ARCH, "route": "cuda",
         "source": "src/repro_torch/csrc/expert_matmul.cu",
         "replaces": "src/repro/kernels/moe_gmm/kernel.py:20",
         "launches": launches["expert_matmul"], "max_abs_err": gmm_err,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
         "bound_by": by, "library_ms": l_ms}]


def named_leaves(tree, prefix: str = ""):
    """(path, tensor) of each leaf of a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def backward_of(torch, op, inputs, cot=None):
    """Gradients of ``sum(out * cot)`` (without ``cot``, of ``sum(out **
    2)``) in fresh leaves of ``inputs``, where ``out = op(*leaves)``:
    (grads, out, the launches the backward alone made, by kernel and by
    design)."""
    from repro_torch.kernels import _build
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    out = op(*leaves)
    loss = (out.float() ** 2).sum() if cot is None else \
        (out.float() * cot.float()).sum()
    _build.reset_launch_counts()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return grads, out, \
        {k: v for k, v in _build.LAUNCH_COUNTS.items() if v}, \
        {k: v for k, v in _build.DESIGN_COUNTS.items() if v}


def launches_per_step(cfg, remat: bool) -> dict:
    """The kernel launches of one gradient step, from the layer plan: a
    flash forward per attention layer, a scan forward and a scan backward
    per RG-LRU layer, three expert products forward and two launches each
    backward per MoE layer (an attention layer of an MoE config), and with
    ``remat`` each body period's forward once more inside the backward
    (the tail sits outside the checkpoint).  Kernels the step does not
    launch are left out."""
    from repro_torch.models.transformer import layer_plan
    period, full, tail = layer_plan(cfg)
    body = {k: full * period.count(k) for k in ("attn", "rec")}
    n = {k: body[k] + tail.count(k) for k in ("attn", "rec")}
    again = body if remat else {"attn": 0, "rec": 0}
    moe = cfg.is_moe
    want = {"flash_attention": n["attn"] + again["attn"],
            "linear_scan": 2 * n["rec"] + again["rec"],
            "expert_matmul": moe * (9 * n["attn"] + 3 * again["attn"])}
    return {k: v for k, v in want.items() if v}


def grad_phase(torch, dev, cfg):
    """Phase 14.  Returns {kernel: (max abs error, kernel ms, plain ms,
    bound ms, bound_by, library ms, whole backward ms)} of the two kernels
    of recurrentgemma's training path, at its shapes, and of
    ``expert_matmul`` and ``flash_attention granite`` at granite's (the
    expert product's also with its launch shapes' times and a step's
    backward launches' time)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.linear_scan import (linear_scan,
                                                 linear_scan_cuda,
                                                 linear_scan_ref)
    from repro_torch.kernels.moe_gmm import (expert_matmul,
                                             expert_matmul_cuda,
                                             expert_matmul_ref)
    from repro_torch.models import moe as moe_mod
    gen = torch.Generator(device=dev).manual_seed(14)

    def draw(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def coeffs(shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.49 + 0.5

    def flash_w(q, k, v):
        return flash_attention(q, k, v, True, cfg.window)

    def plain_w(q, k, v):
        return attention_ref(q, k, v, True, cfg.window)

    # (label, op, plain version, inputs, cotangent (None: sum(out ** 2)),
    # tolerance (a float for allclose, "bitwise" or a relative RMS limit
    # as ("rms", limit)), the backward's launches by design)
    S, R = TRAIN_S, cfg.lru_width
    scan_in = (coeffs((1, S, R)), draw((1, S, R)))
    qkv = (draw((1, S, cfg.n_heads, cfg.hd), torch.bfloat16),
           draw((1, S, cfg.n_kv_heads, cfg.hd), torch.bfloat16),
           draw((1, S, cfg.n_kv_heads, cfg.hd), torch.bfloat16))
    cases = [
        ("linear_scan f32 (1, 64, 8)", linear_scan, linear_scan_ref,
         (coeffs((1, 64, 8)), draw((1, 64, 8))), None, GRAD_TOL,
         {("linear_scan", "ring"): 1}),
        ("flash_attention f32 (1, 64, 2/1 heads, 16)", flash_attention,
         attention_ref, (draw((1, 64, 2, 16)), draw((1, 64, 1, 16)),
                         draw((1, 64, 1, 16))), None, GRAD_TOL, {}),
        ("expert_matmul f32 (2, 32, 32, 32)", expert_matmul,
         expert_matmul_ref,
         (draw((2, 32, 32)), draw((2, 32, 32), scale=32 ** -0.5)), None,
         GRAD_TOL, {("expert_matmul", "fma"): 2}),
        (f"linear_scan f32 {(1, S, R)}", linear_scan, linear_scan_ref,
         scan_in, draw((1, S, R)), "bitwise", {("linear_scan", "ring"): 1}),
        (f"flash_attention bf16 (1, {S}, {cfg.n_heads}/{cfg.n_kv_heads} "
         f"heads, {cfg.hd}) window {cfg.window}", flash_w, plain_w, qkv,
         draw(qkv[0].shape, torch.bfloat16), "bitwise", {}),
    ]
    moe = get_config(MOE_ARCH)
    E, D, Ff = moe.n_experts, moe.d_model, moe.d_ff
    C = moe_mod._capacity(MOE_B * MOE_PROMPT, moe)
    C_tr = moe_mod._capacity(MOE_TRAIN_B * MOE_TRAIN_S, moe)
    train_ops = {}
    for where, c in (("prefill", C), ("train", C_tr)):
        for label, (d_in, d_out) in (("gate/up", (D, Ff)),
                                     ("down", (Ff, D))):
            inputs = (draw((E, c, d_in), torch.bfloat16),
                      draw((E, d_in, d_out), torch.bfloat16, d_in ** -0.5))
            if where == "train":
                train_ops[label] = inputs
            cases.append((
                f"expert_matmul bf16 {where} {label} ({E}, {c}, {d_in}, "
                f"{d_out})", expert_matmul, expert_matmul_ref, inputs,
                draw((E, c, d_out), torch.bfloat16),
                ("rms", GMM_GRAD_REL_RMS), {("expert_matmul", "tc"): 2}))
    # flash at granite's training shape: the forward against its plain
    # version as in phase 10 and row by row (FLASH_ROW_REL_RMS), and its
    # gradients (the plain version's) bitwise
    g_case = (MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_S, moe.n_heads,
              moe.n_kv_heads, moe.hd, True, 0, "bfloat16")
    g_ok, g_err, g_label, g_qkv = check_flash(torch, draw, g_case,
                                              FLASH_ROW_REL_RMS)
    cases.append((f"flash_attention bf16 {g_label}", flash_attention,
                  attention_ref, g_qkv, draw(g_qkv[0].shape, torch.bfloat16),
                  "bitwise", {}))
    failed, errs = ([] if g_ok else [f"flash_attention {g_label}"]), {}
    train_err = 0.0
    for label, op, plain, inputs, cot, tol, want_designs in cases:
        got, out, launched, designs = backward_of(torch, op, inputs, cot)
        want, _, plain_launched, _ = backward_of(torch, plain, inputs, cot)
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        if tol == "bitwise":
            ok, told = all(torch.equal(g, w) for g, w in zip(got, want)), \
                "bitwise"
        elif isinstance(tol, tuple):
            rms = max(rel_rms(g, w) for g, w in zip(got, want))
            ok, told = rms <= tol[1], \
                f"relative RMS {rms:.3e}, limit {tol[1]:.3e}"
        else:
            ok, told = all(bool(torch.allclose(g, w, rtol=tol, atol=tol))
                           for g, w in zip(got, want)), f"tol {tol}"
        want_launches = {}
        for (kernel, _), n in want_designs.items():
            want_launches[kernel] = want_launches.get(kernel, 0) + n
        ok = ok and out.grad_fn is not None and not plain_launched \
            and launched == want_launches and designs == want_designs \
            and all(bool(torch.isfinite(g).all()) for g in got)
        name = label.split()[0]
        errs[name] = max(errs.get(name, 0.0), err)
        if " train " in label:
            train_err = max(train_err, err)
        print(f"  grad {label}: {'ok' if ok else 'FAIL'} max_abs_err "
              f"{err:.3e} ({told}); the backward's launches "
              f"{designs or 'none'}; output grad_fn "
              f"{type(out.grad_fn).__name__}")
        if not ok:
            failed.append(label)
        del got, want, out
    if failed:
        fail("op gradients against autograd of the plain versions: "
             + "; ".join(failed))

    # times at the training shapes: the scan kernel (its backward launch
    # is the same kernel at the same shape), flash's forward against its
    # plain version and SDPA, and each op's whole backward
    a, b = scan_in
    s_ms = cuda_ms(torch, lambda: linear_scan_cuda(a, b))
    s_plain = cuda_ms(torch, lambda: linear_scan_ref(a, b))
    s_bytes = 3 * a.numel() * 4
    s_bound = s_bytes / HBM_BYTES_PER_S * 1e3
    bwd_ms = {}
    for name, op, inputs in (("linear_scan", linear_scan, scan_in),
                             ("flash_attention", flash_w, qkv)):
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        out = op(*leaves)
        cot = torch.ones_like(out)
        bwd_ms[name] = cuda_ms(torch, lambda: torch.autograd.grad(
            out, leaves, cot, retain_graph=True))
        del leaves, out, cot
    print(f"linear_scan at {tuple(a.shape)} f32 (the training shape of its "
          f"forward and backward launches): kernel {s_ms:.4f} ms "
          f"({s_bytes / s_ms / 1e9:.3f} TB/s, {s_bound / s_ms:.3f} of the "
          f"bound), plain {s_plain:.4f} ms; bound {s_bound:.4f} ms by bytes "
          f"({s_bytes} bytes); the whole backward (the reverse scan's "
          f"launch, flips, shifts and da = db * h_prev) "
          f"{bwd_ms['linear_scan']:.4f} ms")
    f_ms, f_plain, f_lib, f_bound, f_by = time_flash(torch, qkv, cfg.window)
    print(f"flash_attention backward at {tuple(qkv[0].shape)} bf16, window "
          f"{cfg.window} (the plain version recomputed and differentiated): "
          f"{bwd_ms['flash_attention']:.4f} ms")
    del scan_in, qkv, a, b
    times = {"linear_scan": (errs["linear_scan"], s_ms, s_plain, s_bound,
                             "bytes", None, bwd_ms["linear_scan"]),
             "flash_attention": (errs["flash_attention"], f_ms, f_plain,
                                 f_bound, f_by, f_lib,
                                 bwd_ms["flash_attention"])}

    # granite's training shapes (1 x 4096 tokens, C = 1024): the expert
    # product's two forward and four backward launch shapes, each against
    # its bound, its plain version and torch.bmm; each product's whole
    # backward (two launches and two transposed copies); flash with its
    # plain backward against SDPA is_causal
    launch_shapes = {
        "forward gate/up": (E, C_tr, D, Ff), "forward down": (E, C_tr, Ff, D),
        "backward dX gate/up": (E, C_tr, Ff, D),
        "backward dW gate/up": (E, D, C_tr, Ff),
        "backward dX down": (E, C_tr, D, Ff),
        "backward dW down": (E, Ff, C_tr, D)}
    gmm_times = {}
    for label, (e, c, d_in, d_out) in launch_shapes.items():
        x = draw((e, c, d_in), torch.bfloat16)
        w = draw((e, d_in, d_out), torch.bfloat16, d_in ** -0.5)
        k_ms = cuda_ms(torch, lambda: expert_matmul_cuda(x, w))
        p_ms = cuda_ms(torch, lambda: expert_matmul_ref(x, w))
        l_ms = cuda_ms(torch, lambda: torch.bmm(x, w))
        bound, by, flops, nbytes = gmm_bound(e, c, d_in, d_out, 2)
        gmm_times[label] = (k_ms, p_ms, l_ms, bound, by)
        print(f"expert_matmul {label} at granite's training shape "
              f"({e}, {c}, {d_in})x({e}, {d_in}, {d_out}) bf16: kernel "
              f"{k_ms:.4f} ms ({flops / k_ms / 1e9:.2f} TFLOP/s, "
              f"{bound / k_ms:.3f} of the bound), plain {p_ms:.4f} ms, "
              f"torch.bmm {l_ms:.4f} ms; kernel / torch.bmm "
              f"{k_ms / l_ms:.3f}; bound {bound:.4f} ms by {by} "
              f"({flops:.4e} flops, {nbytes} bytes)")
        del x, w
    product_bwd = {}
    for label, inputs in train_ops.items():
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        out = expert_matmul(*leaves)
        cot = torch.ones_like(out)
        product_bwd[label] = cuda_ms(torch, lambda: torch.autograd.grad(
            out, leaves, cot, retain_graph=True))
        del leaves, out, cot
    layer_bwd = 2 * product_bwd["gate/up"] + product_bwd["down"]
    step_bwd = sum(n * gmm_times[f"backward {k}"][0] for k, n in (
        ("dX gate/up", 2), ("dW gate/up", 2), ("dX down", 1),
        ("dW down", 1))) * moe.n_layers
    print(f"expert_matmul whole backward at granite's training shapes: "
          f"gate/up {product_bwd['gate/up']:.4f} ms, down "
          f"{product_bwd['down']:.4f} ms, a layer's three products "
          f"{layer_bwd:.4f} ms; a step's {6 * moe.n_layers} backward "
          f"launches {step_bwd:.3f} ms at these times")
    del train_ops
    gf_ms, gf_plain, gf_lib, gf_bound, gf_by = time_flash(torch, g_qkv, 0)
    leaves = [x.detach().clone().requires_grad_() for x in g_qkv]
    out = flash_attention(*leaves, True, 0)
    cot = torch.ones_like(out)
    gf_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        out, leaves, cot, retain_graph=True))
    print(f"flash_attention backward at {tuple(g_qkv[0].shape)} bf16, causal "
          f"(the plain version recomputed and differentiated): "
          f"{gf_bwd:.4f} ms")
    del leaves, out, cot, g_qkv
    k_ms, p_ms, l_ms, bound, by = gmm_times["forward gate/up"]
    times["expert_matmul"] = (train_err, k_ms, p_ms, bound, by, l_ms,
                              layer_bwd, gmm_times, step_bwd)
    times["flash_attention granite"] = (g_err, gf_ms, gf_plain, gf_bound,
                                        gf_by, gf_lib, gf_bwd)
    return times


def train_phases(torch, dev):
    """Phases 14-16; returns the training path's JSON entries."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import structured_unit
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.train.loop import fit, make_grad_step, make_train_step

    cfg = get_config(TRAIN_ARCH)
    # 14. each op's gradients on the card against its plain version
    times = grad_phase(torch, dev, cfg)
    batch = structured_unit(0, 1, TRAIN_S, cfg.vocab_size)

    # 15. one gradient step at full width and depth 3, kernel against plain
    cfg3 = dataclasses.replace(cfg, n_layers=3)
    model3 = build_model(cfg3)
    params3 = model3.init(seed=0, device=dev)
    for remat in (False, True):
        _build.reset_launch_counts()
        loss_k, grads_k = make_grad_step(model3, remat=remat)(params3, batch)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCH_COUNTS.items() if v}
        designs = {k: v for k, v in _build.DESIGN_COUNTS.items() if v}
        want = launches_per_step(cfg3, remat)
        print(f"depth-3 {TRAIN_ARCH} gradient step (1 x {TRAIN_S}, bf16), "
              f"remat {remat}: launches {launches} (want {want}); designs "
              f"{designs}")
        if launches != want or designs != {
                ("flash_attention", "tc"): want["flash_attention"],
                ("linear_scan", "ring"): want["linear_scan"]}:
            fail(f"depth-3 step launches {launches}, designs {designs}; "
                 f"want {want}, all on tc / ring")
    _build.reset_launch_counts()
    with plain_kernels():
        loss_p, grads_p = make_grad_step(model3, remat=True)(params3, batch)
    torch.cuda.synchronize()
    if any(_build.LAUNCH_COUNTS.values()):
        fail(f"the plain training path launched kernels: "
             f"{_build.LAUNCH_COUNTS}")
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    finite = bool(torch.isfinite(loss_k))
    worst, worst_rms = "", -1.0
    for (path, g), (_, w) in zip(named_leaves(grads_k),
                                 named_leaves(grads_p)):
        finite = finite and bool(torch.isfinite(g).all())
        r = rel_rms(g, w)
        if not r <= worst_rms:          # a NaN is the worst
            worst, worst_rms = path, r
    print(f"  kernel path against the plain path (remat on): loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f}, relative "
          f"{loss_rel:.3e} (limit {TRAIN_LOSS_RTOL}); worst gradient leaf "
          f"{worst}: relative RMS {worst_rms:.3e} (limit "
          f"{TRAIN_GRAD_REL_RMS})")
    if not finite or not loss_rel <= TRAIN_LOSS_RTOL \
            or not worst_rms <= TRAIN_GRAD_REL_RMS:
        fail("the depth-3 training step's kernel path does not agree with "
             "its plain path")
    del params3, grads_k, grads_p, model3

    # 16. the slice: recurrentgemma-2b at full width and depth, four fit
    # steps on one repeated batch at a constant rate
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params, n_bytes = describe_params(params)
    print(f"train path: {TRAIN_ARCH} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype} weights "
          f"({n_params:.4e} parameters, {n_bytes / 1e9:.3f} GB, drawn in "
          f"{time.perf_counter() - t0:.2f} s), float32 AdamW state, remat "
          f"per period; batch 1 x {TRAIN_S} structured tokens, lr "
          f"{TRAIN_LR} constant")
    opt = AdamW(lr=constant(TRAIN_LR))
    per_step = launches_per_step(cfg, True)
    want = {n: TRAIN_STEPS * per_step.get(n, 0) for n in _build.LAUNCH_COUNTS}
    stamps = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    params, state, hist = fit(
        model, params, opt, [batch] * TRAIN_STEPS, remat=True, log_every=1,
        callback=lambda i, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    designs = dict(_build.DESIGN_COUNTS)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_s = np.diff([t0] + stamps)
    warm_s = float(step_s[1:].min())
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    print(f"  fit: losses {losses}; grad norms {norms}; step wall "
          f"{[round(float(s) * 1e3, 3) for s in step_s]} ms (the first with the "
          f"optimizer's init); launches {launches} (want {want}); designs "
          f"{designs}; peak memory {peak_gb:.3f} GB")
    if launches != want or \
            designs[("flash_attention", "tc")] != want["flash_attention"] \
            or designs[("linear_scan", "ring")] != want["linear_scan"]:
        fail(f"the training path's launches {launches} / designs {designs} "
             f"are not {want}, all on tc / ring")
    if not np.all(np.isfinite(losses + norms)) or \
            not losses[-1] < losses[0]:
        fail(f"training losses {losses}, grad norms {norms}: not finite, or "
             f"the last loss is not below the first")
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    print(f"train {TRAIN_ARCH} 1 x {TRAIN_S}: step {warm_s * 1e3:.3f} ms "
          f"(warm min of {TRAIN_STEPS - 1}), {TRAIN_S / warm_s:.1f} tokens/s;"
          f" peak memory {peak_gb:.3f} GB of {total_gb:.3f}")
    # the step's two halves, device time (CUDA events): the gradient
    # (forward, the remat recompute, backward) and the AdamW update
    grad_step = make_grad_step(model, remat=True)
    g_ms = cuda_ms(torch, lambda: grad_step(params, batch), reps=2)
    _, grads = grad_step(params, batch)
    u_ms = cuda_ms(torch, lambda: opt.update(grads, state, params), reps=2)
    del grads
    print(f"  the step's halves (warm min of 2): gradient {g_ms:.3f} ms, "
          f"AdamW update (its clip-norm pass included) {u_ms:.3f} ms")
    step = make_train_step(model, opt, remat=True)
    events, _ = profile_generate(torch, lambda: step(params, state, batch),
                                 "train step")
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  the profiled step's device time over the unprofiled warm "
          f"step: {100 * busy_ms / (warm_s * 1e3):.2f}%")
    print_device_kinds(events)
    scan = [e for e in events if "linear_scan" in e.key]
    scan_n = sum(e.count for e in scan)
    scan_us = sum(e.self_device_time_total for e in scan)
    n_rec = cfg.layer_kinds().count("rec")
    n_attn = cfg.layer_kinds().count("attn")
    print(f"  in that step: the scan kernel {scan_n} launches, "
          f"{scan_us / 1e3:.3f} ms; its {n_rec} backward launches (one per "
          f"RG-LRU layer, the forward's shape) "
          f"{n_rec * scan_us / max(scan_n, 1) / 1e3:.3f} ms at the step's "
          f"mean, {n_rec * times['linear_scan'][1]:.3f} ms at phase 14's "
          f"time; the {n_rec} whole scan backwards "
          f"{n_rec * times['linear_scan'][6]:.3f} ms; flash's {n_attn} plain "
          f"recomputes, differentiated, "
          f"{n_attn * times['flash_attention'][6]:.3f} ms (phase 14's times)")
    del params, state, model, step
    entries = []
    for name in ("linear_scan", "flash_attention"):
        err, ms, plain_ms, bound, by, lib, bwd = times[name]
        entries.append({
            "name": name, "path": TRAIN_PATH, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "backward": BACKWARDS[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib, "backward_ms": bwd})
    torch.cuda.empty_cache()
    return entries + moe_train_phases(torch, dev, times)


@contextlib.contextmanager
def recorded_routes(torch):
    """Record each MoE layer's routing as the model runs: a list of (map,
    top-1 expert, (top_e, slot, keep)) per layer call, the map (T, E)
    int8, 0 where the expert was not among the token's top k, 1 where its
    pair was dropped and 2 where it was kept.  A remat's recompute appends
    its layers again."""
    from repro_torch.models import moe as moe_mod
    route, seen = moe_mod.route, []

    def recording(p, cfg, x):
        out = route(p, cfg, x)
        with torch.no_grad():
            _, top_e, _ = moe_mod._router(p, cfg, x.reshape(-1, x.shape[-1]))
            kept = 1 + out[2].reshape(top_e.shape).to(torch.int8)
            m = torch.zeros((top_e.shape[0], cfg.n_experts),
                            dtype=torch.int8, device=x.device)
            seen.append((m.scatter_(1, top_e, kept), top_e[:, 0].clone(),
                         (top_e, out[1].clone(), out[2].clone())))
        return out

    moe_mod.route = recording
    try:
        yield seen
    finally:
        moe_mod.route = route


@contextlib.contextmanager
def pinned_routes(torch, recorded):
    """Replay ``recorded_routes``' records in order, one per MoE layer
    call: the call takes the record's experts, slots and kept pairs, and
    its weights and aux loss from its own float32 router logits as
    ``moe._router`` makes them (the recorded experts' probabilities,
    renormalised; the Switch term over the recorded top-1 experts), so
    the gradients reach the router as on an unpinned path.  Yields the
    records replayed so far."""
    from repro_torch.models import moe as moe_mod
    route, records, used = moe_mod.route, iter(recorded), []

    def pinned(p, cfg, x):
        used.append(next(records))
        top_e, slot, keep = used[-1][2]
        E = cfg.n_experts
        xf = x.reshape(-1, x.shape[-1])
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)
        top_p = probs.gather(1, top_e)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        ce = torch.nn.functional.one_hot(top_e[:, 0], E).float().mean(0)
        aux = E * torch.sum(probs.mean(0) * ce)
        return top_p, slot, keep, moe_mod._capacity(xf.shape[0], cfg), aux

    moe_mod.route = pinned
    try:
        yield used
    finally:
        moe_mod.route = route


def route_differences(got, want):
    """(share of (token, k) pairs routed differently -- another expert, or
    kept on one side and dropped on the other --, share of tokens whose
    top-1 expert differs), over the layers of two ``recorded_routes``."""
    pairs = differ = top1 = tokens = 0
    for (mg, tg, _), (mw, tw, _) in zip(got, want):
        chosen = mg > 0
        pairs += int(chosen.sum())
        differ += int((chosen & (mg != mw)).sum())
        top1 += int((tg != tw).sum())
        tokens += tg.numel()
    return differ / pairs, top1 / tokens


def dropped_share(routes) -> float:
    """Share of the recorded (token, k) pairs that were dropped."""
    return sum(int((m == 1).sum()) for m, _, _ in routes) / \
        sum(int((m > 0).sum()) for m, _, _ in routes)


def moe_train_phases(torch, dev, times):
    """Phases 17-19; returns granite's training path's JSON entries."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import UnitStore, structured_unit, unit_tokens
    from repro_torch.hettrain import ScanGradEngine, tree_bytes
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.models.moe import _capacity
    from repro_torch.optim import AdamW, constant
    from repro_torch.train.loop import (_grad_of, _on_device, fit,
                                        make_grad_step, make_train_step)

    cfg = get_config(MOE_ARCH)
    T, K = MOE_TRAIN_B * MOE_TRAIN_S, cfg.experts_per_token
    batch = structured_unit(0, MOE_TRAIN_B, MOE_TRAIN_S, cfg.vocab_size)
    on_card = _on_device(batch, dev)

    def tc_only(want):
        return {(k, "tc"): v for k, v in want.items()}

    # 17. one gradient step at full width and depth 3, kernel against plain
    cfg3 = dataclasses.replace(cfg, n_layers=3)
    model3 = build_model(cfg3)
    params3 = model3.init(seed=0, device=dev)
    for remat in (False, True):
        _build.reset_launch_counts()
        with recorded_routes(torch) as routes_k:
            loss_k, metrics_k, grads_k = _grad_of(model3, params3, on_card,
                                                  "scan", remat)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCH_COUNTS.items() if v}
        designs = {k: v for k, v in _build.DESIGN_COUNTS.items() if v}
        want = launches_per_step(cfg3, remat)
        print(f"depth-3 {MOE_ARCH} gradient step ({MOE_TRAIN_B} x "
              f"{MOE_TRAIN_S}, bf16, capacity factor {cfg.capacity_factor}),"
              f" remat {remat}: launches {launches} (want {want}); designs "
              f"{designs}; (token, k) pairs dropped "
              f"{dropped_share(routes_k[:cfg3.n_layers]):.6f}")
        if launches != want or designs != tc_only(want):
            fail(f"depth-3 {MOE_ARCH} step launches {launches}, designs "
                 f"{designs}; want {want}, all on tc")
    aux_k = float(metrics_k["moe_aux"])
    finite = bool(torch.isfinite(loss_k)) and np.isfinite(aux_k) and all(
        bool(torch.isfinite(g).all()) for g in leaves(grads_k))
    n = cfg3.n_layers

    def against_plain(label, pin):
        """The plain path (remat on) against the kernel path: (loss
        relative, aux relative, worst leaf, its relative RMS, the plain
        path's routes or, with ``pin``, the records it replayed)."""
        _build.reset_launch_counts()
        with plain_kernels(), (pinned_routes(torch, routes_k) if pin else
                               recorded_routes(torch)) as seen:
            loss_p, metrics_p, grads_p = _grad_of(model3, params3, on_card,
                                                  "scan", True)
        torch.cuda.synchronize()
        if any(_build.LAUNCH_COUNTS.values()):
            fail(f"the plain training path launched kernels: "
                 f"{_build.LAUNCH_COUNTS}")
        loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        aux_p = float(metrics_p["moe_aux"])
        aux_rel = abs(aux_k - aux_p) / abs(aux_p)
        worst, worst_rms, rows = "", -1.0, []
        for (path, g), (_, w) in zip(named_leaves(grads_k),
                                     named_leaves(grads_p)):
            r = rel_rms(g, w)
            rows.append(f"{path} {r:.3e}")
            if not r <= worst_rms:          # a NaN is the worst
                worst, worst_rms = path, r
        print(f"  kernel path against the plain path {label} (remat on): "
              f"loss {float(loss_k):.6f} vs {float(loss_p):.6f}, relative "
              f"{loss_rel:.3e}; xent {float(metrics_k['xent']):.6f} vs "
              f"{float(metrics_p['xent']):.6f}; moe_aux {aux_k:.6f} vs "
              f"{aux_p:.6f}, relative {aux_rel:.3e}; worst gradient leaf "
              f"{worst}: relative RMS {worst_rms:.3e}; relative RMS per "
              f"leaf: " + "; ".join(rows))
        return loss_rel, aux_rel, worst, worst_rms, seen

    # the plain path routing for itself: how often rounding swaps a pair
    # (a reading, and a limit on it), then the held comparison with the
    # kernel path's routing replayed
    *_, routes_p = against_plain("routing for itself", False)
    flip, top1 = route_differences(routes_k[:n], routes_p[:n])
    print(f"  (token, k) pairs routed differently by the two paths "
          f"{flip:.6f} (limit {MOE_FLIP_MAX}), tokens with another top-1 "
          f"expert {top1:.6f}")
    loss_rel, aux_rel, worst, worst_rms, replayed = against_plain(
        "on the kernel path's routing", True)
    print(f"  with the routing replayed ({len(replayed)} of the kernel "
          f"path's {len(routes_k)} layer calls): loss relative "
          f"{loss_rel:.3e} (limit {MOE_TRAIN_LOSS_RTOL}), moe_aux relative "
          f"{aux_rel:.3e} (limit {MOE_AUX_RTOL}), worst gradient leaf "
          f"{worst} {worst_rms:.3e} (limit {TRAIN_GRAD_REL_RMS})")
    if not finite or not flip <= MOE_FLIP_MAX \
            or len(replayed) != len(routes_k) \
            or not loss_rel <= MOE_TRAIN_LOSS_RTOL \
            or not aux_rel <= MOE_AUX_RTOL \
            or not worst_rms <= TRAIN_GRAD_REL_RMS:
        fail(f"the depth-3 {MOE_ARCH} training step's kernel path does not "
             f"agree with its plain path")
    del params3, grads_k, model3, routes_k, routes_p, replayed
    torch.cuda.empty_cache()

    # 18. the slice: granite-moe-3b-a800m at full width and depth, four fit
    # steps on one repeated batch at a constant rate
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params, n_bytes = describe_params(params)
    print(f"train path: {MOE_ARCH} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{K} d_ff {cfg.d_ff}, "
          f"capacity factor {cfg.capacity_factor}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype} weights, float32 router ({n_params:.4e} parameters, "
          f"{n_bytes / 1e9:.3f} GB, drawn in {time.perf_counter() - t0:.2f} "
          f"s), float32 AdamW state, remat per layer; batch {MOE_TRAIN_B} x "
          f"{MOE_TRAIN_S} structured tokens, lr {TRAIN_LR} constant")
    with torch.no_grad(), recorded_routes(torch) as routes:
        model.loss(params, on_card)
    print(f"  (token, k) pairs dropped at the first step's weights, C "
          f"{_capacity(T, cfg)}: "
          f"{dropped_share(routes):.6f} over the {len(routes)} layers "
          f"(most in one layer "
          f"{max(dropped_share([r]) for r in routes):.6f})")
    del routes
    opt = AdamW(lr=constant(TRAIN_LR))
    per_step = launches_per_step(cfg, True)
    want = {k: TRAIN_STEPS * per_step.get(k, 0) for k in _build.LAUNCH_COUNTS}
    stamps = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    params, state, hist = fit(
        model, params, opt, [batch] * TRAIN_STEPS, remat=True, log_every=1,
        callback=lambda i, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    fit_launches = dict(launches)
    designs = {k: v for k, v in _build.DESIGN_COUNTS.items() if v}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_s = np.diff([t0] + stamps)
    warm_s = float(step_s[1:].min())
    losses = [h["loss"] for h in hist]
    auxes = [h["moe_aux"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    print(f"  fit: losses {losses}; moe_aux {auxes}; grad norms {norms}; "
          f"step wall {[round(float(x) * 1e3, 3) for x in step_s]} ms (the "
          f"first with the optimizer's init); launches {launches} (want "
          f"{want}); designs {designs}; peak memory {peak_gb:.3f} GB")
    if launches != want or designs != tc_only(
            {k: v for k, v in want.items() if v}):
        fail(f"the training path's launches {launches} / designs {designs} "
             f"are not {want}, all on tc")
    if not np.all(np.isfinite(losses + auxes + norms)) or \
            not losses[-1] < losses[0]:
        fail(f"training losses {losses}, aux {auxes}, grad norms {norms}: "
             f"not finite, or the last loss is not below the first")
    if not peak_gb < 80:
        fail(f"the training step's peak memory {peak_gb:.3f} GB is not "
             f"under 80 GB")
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    print(f"train {MOE_ARCH} {MOE_TRAIN_B} x {MOE_TRAIN_S}: step "
          f"{warm_s * 1e3:.3f} ms (warm min of {TRAIN_STEPS - 1}), "
          f"{T / warm_s:.1f} tokens/s; peak memory {peak_gb:.3f} GB of "
          f"{total_gb:.3f}")
    grad_step = make_grad_step(model, remat=True)
    g_ms = cuda_ms(torch, lambda: grad_step(params, batch), reps=2)
    _, grads = grad_step(params, batch)
    u_ms = cuda_ms(torch, lambda: opt.update(grads, state, params), reps=2)
    del grads
    print(f"  the step's halves (warm min of 2): gradient {g_ms:.3f} ms, "
          f"AdamW update (its clip-norm pass included) {u_ms:.3f} ms")
    step = make_train_step(model, opt, remat=True)
    fwd_ms = 2 * cfg.n_layers * sum(times["expert_matmul"][7][k][0] for k in (
        "forward gate/up", "forward gate/up", "forward down"))
    n_attn = cfg.layer_kinds().count("attn")

    def profile_step(b, label, wall_s):
        """One profiled step on ``b``: its busy share of the unprofiled
        step's ``wall_s``, device time by kind, and the time inside the
        backward nodes and of the expert kernel's launches."""
        events, inside = profile_generate(
            torch, lambda: step(params, state, b), f"train step, {label}",
            nodes=("ExpertMatmulBackward", "FlashAttentionBackward"))
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        print(f"  the profiled step's device time over the unprofiled warm "
              f"step: {100 * busy_ms / (wall_s * 1e3):.2f}%")
        print_device_kinds(events)
        gmm = [e for e in events if "expert_matmul" in e.key]
        gmm_n = sum(e.count for e in gmm)
        gmm_ms = sum(e.self_device_time_total for e in gmm) / 1e3
        for node, (calls, ms) in inside.items():
            print(f"  in that step: {node} {calls} calls, {ms:.3f} ms of "
                  f"device time inside them"
                  if calls else f"  in that step: {node} not recorded by "
                  f"the profiler (not measured)")
        print(f"  in that step: the expert kernel {gmm_n} launches, "
              f"{gmm_ms:.3f} ms; its {6 * cfg.n_layers} backward launches "
              f"{gmm_ms - fwd_ms:.3f} ms (the step's kernel time less the "
              f"{6 * cfg.n_layers} forward and recomputed launches at phase "
              f"14's times, {fwd_ms:.3f} ms), "
              f"{times['expert_matmul'][8]:.3f} ms at phase 14's times; "
              f"flash's {n_attn} plain recomputes, differentiated, "
              f"{n_attn * times['flash_attention granite'][6]:.3f} ms at "
              f"phase 14's time")

    profile_step(batch, "the structured batch", warm_s)
    # the same step on i.i.d. tokens, whose routing is closer to text's
    # than the structured task's short cycle: both drop shares at these
    # weights, then the step's wall and its profile
    iid = unit_tokens(0, MOE_TRAIN_B, MOE_TRAIN_S, cfg.vocab_size)
    shares = {}
    for label, b in (("structured", batch), ("i.i.d.", iid)):
        with torch.no_grad(), recorded_routes(torch) as routes:
            model.loss(params, _on_device(b, dev))
        shares[label] = dropped_share(routes)
        del routes
    iid_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(params, state, iid)
        torch.cuda.synchronize()
        iid_s.append(time.perf_counter() - t0)
    iid_warm = min(iid_s[1:])
    print(f"  (token, k) pairs dropped at the weights after {TRAIN_STEPS} "
          f"steps: structured {shares['structured']:.6f}, i.i.d. "
          f"{shares['i.i.d.']:.6f}; steps on i.i.d. tokens "
          f"{[round(x * 1e3, 3) for x in iid_s]} ms, {iid_warm * 1e3:.3f} ms "
          f"(warm min of 2), {T / iid_warm:.1f} tokens/s")
    profile_step(iid, "i.i.d. tokens", iid_warm)
    del state, opt, step, grad_step, hist
    torch.cuda.empty_cache()

    # 19. the unit-group gradient engine at full width
    store = UnitStore(*ENGINE_UNIT, cfg.vocab_size)
    engine = ScanGradEngine(model, store)
    exact = ScanGradEngine(model, store, min_bucket=1)
    per_unit = launches_per_step(cfg, False)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()

    def first_difference(x, y, lx, ly):
        """None if the two grad_sum results are bitwise equal, else the
        first leaf that differs."""
        if not np.array_equal(lx, ly):
            return "losses"
        return next((path for (path, a), (_, b) in zip(
            named_leaves(x), named_leaves(y)) if not torch.equal(a, b)),
            None)

    t0 = time.perf_counter()
    a, la = engine.grad_sum(params, [3, 0])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    finite = np.all(np.isfinite(la)) and all(
        bool(torch.isfinite(x).all()) for x in leaves(a))
    checks = []
    for label, eng, ids in (("again [3, 0]", engine, [3, 0]),
                            ("[0, 3]", engine, [0, 3]),
                            ("min_bucket=1 [0, 3]", exact, [0, 3])):
        b, lb = eng.grad_sum(params, ids)
        checks.append((label, first_difference(a, b, la, lb)))
        del b
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCH_COUNTS.items() if v}
    want = {k: 4 * 2 * v for k, v in per_unit.items()}
    stats = (engine.stats(), exact.stats())
    want_stats = ({"dispatches": 3, "units": 6, "bucket_sizes": [4]},
                  {"dispatches": 1, "units": 2, "bucket_sizes": [2]})
    print(f"engine: {MOE_ARCH} at full width, units of {ENGINE_UNIT[0]} x "
          f"{ENGINE_UNIT[1]} tokens; grad_sum of [3, 0] in "
          f"{call_s * 1e3:.3f} ms (first call), losses {la.tolist()}, "
          f"float32 sum of {tree_bytes(a) / 1e9:.3f} GB; "
          + "; ".join(f"{label}: " + ("bitwise equal" if d is None else
                                      f"DIFFERS first at {d}")
                      for label, d in checks)
          + f"; stats {stats[0]} and {stats[1]} (want {want_stats[0]} and "
          f"{want_stats[1]}); launches {launches} (want {want}); peak "
          f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    if not finite or any(d is not None for _, d in checks) \
            or stats != want_stats or launches != want:
        fail("the gradient engine at full width: not finite, not bitwise, "
             "or its counters or launches are not the units'")
    del a, params, model, engine, exact
    torch.cuda.empty_cache()

    err, ms, plain_ms, bound, by, lib, bwd, _, _ = times["expert_matmul"]
    g_err, g_ms, g_plain, g_bound, g_by, g_lib, g_bwd = \
        times["flash_attention granite"]
    return [
        {"name": "flash_attention", "path": MOE_TRAIN_PATH, "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": REPLACES["flash_attention"],
         "backward": BACKWARDS["flash_attention"],
         "launches": fit_launches["flash_attention"], "max_abs_err": g_err,
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": g_lib, "backward_ms": g_bwd},
        {"name": "expert_matmul", "path": MOE_TRAIN_PATH, "route": "cuda",
         "source": "src/repro_torch/csrc/expert_matmul.cu",
         "replaces": REPLACES["expert_matmul"],
         "backward": BACKWARDS["expert_matmul"],
         "launches": fit_launches["expert_matmul"], "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
         "library_ms": lib, "backward_ms": bwd}]


def exact_oracle_phase(torch, dev, points, specs):
    """Phase 20: the Figure 5 grid through the exact numpy engine at paper
    scale, the ``cuda`` panel and the per-trial loop held against it.
    Returns the numpy panel's reports (phase 28 holds the ``torch``
    backend against them)."""
    from repro_torch.core import get_scheme, mc_grid_panel
    schemes = {name: get_scheme(name) for name in EXACT_SCHEMES}

    def panel(backend):
        t0 = time.perf_counter()
        out = mc_grid_panel(schemes, specs, N_PAPER, TRIALS,
                            np.random.default_rng(2020), backend=backend,
                            device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    exact, exact_s = panel("numpy")
    fluid, fluid_s = panel("cuda")
    loops, loop_s = {}, {}
    for i, name in enumerate(EXACT_SCHEMES[1:]):
        t0 = time.perf_counter()
        loops[name] = get_scheme(name, engine="loop").mc_grid(
            specs, N_PAPER, EXACT_LOOP_TRIALS,
            np.random.default_rng(2021 + i), device=dev)
        loop_s[name] = time.perf_counter() - t0
    print(f"exact oracle: fig5 grid, K={K_PAPER} N={N_PAPER}, "
          f"{len(specs)} points: numpy panel ({', '.join(EXACT_SCHEMES)}; "
          f"{TRIALS} trials) {exact_s * 1e3:.3f} ms, cuda panel "
          f"{fluid_s * 1e3:.3f} ms; engine='loop' ({EXACT_LOOP_TRIALS} "
          f"trials) "
          + ", ".join(f"{n} {s * 1e3:.3f} ms" for n, s in loop_s.items()))

    print("  mu     sigma2   oracle_exact " + " ".join(
        f"{n[:14]:>14s}" for n in EXACT_SCHEMES) + "   (numpy; cuda gap / "
        "loop gap in SE)")
    checks, worst = [], {"cuda": 0.0, "loop": 0.0}
    for g, ((mu, label), het) in enumerate(zip(points, specs)):
        oracle = N_PAPER / het.lambda_sum
        row = {n: exact[n][g].t_comp for n in EXACT_SCHEMES}
        gaps = []
        for n in EXACT_SCHEMES:
            pairs = [("cuda", fluid[n][g])]
            if n in loops:
                pairs.append(("loop", loops[n][g]))
            for kind, other in pairs:
                se_gap, ok = mean_gap(other, exact[n][g])
                worst[kind] = max(worst[kind], se_gap)
                gaps.append(f"{se_gap:.2f}" if kind == "cuda"
                            else f"/{se_gap:.2f}")
                checks.append((f"{kind} {n}[mu={mu:g},s2={label}] within "
                               f"{MEAN_SE:g} SE of numpy", ok))
        print(f"  {mu:5.0f}  {label:7s}  {oracle:12.2f} " + " ".join(
            f"{row[n]:14.2f}" for n in EXACT_SCHEMES) + "   "
            + " ".join(gaps))
        tag = f"fig5[mu={mu:g},s2={label}] numpy"
        checks.append((f"{tag} WE-known within 5% of oracle",
                       row["work_exchange"] <= 1.05 * oracle))
        checks.append((f"{tag} WE-unknown within 10% of oracle",
                       row["work_exchange_unknown"] <= 1.10 * oracle))
        if label != "0":
            checks.append((f"{tag} MDS >= WE",
                           row["mds"] >= row["work_exchange"]))
        for n in EXACT_SCHEMES:
            if exact[n][g].extra["backend"] != "numpy":
                checks.append((f"{tag} {n} ran on numpy", False))
    bad = [name for name, ok in checks if not ok]
    print(f"  exact-oracle checks: {len(checks) - len(bad)}/{len(checks)} "
          f"passed; worst gap cuda {worst['cuda']:.3f} SE, loop "
          f"{worst['loop']:.3f} SE")
    if bad:
        fail("exact-oracle checks failed: " + "; ".join(bad))
    return exact


def het_fleet() -> np.ndarray:
    """The training launcher's simulated fleet (``launch/train.py``):
    K rates ~ Normal(mu 5, 0.5 mu) from seed 0, clipped at 0.5."""
    rng = np.random.default_rng(0)
    return np.clip(rng.normal(5.0, 0.5 * 5.0, HET_K), 0.5, None)


def leaf_digests(torch, params, threads: int = 4) -> list:
    """(path, SHA-256 of the leaf's bytes) of each leaf, copied to the
    host in pieces, ``threads`` leaves at a time (the copies and the
    hashing release the GIL): what two runs' parameters are compared
    by."""
    from concurrent.futures import ThreadPoolExecutor

    def digest(x) -> str:
        flat = x.detach().reshape(-1).view(torch.uint8)
        h = hashlib.sha256()
        for i in range(0, flat.numel(), 1 << 28):
            h.update(flat[i:i + (1 << 28)].cpu().numpy())
        return h.hexdigest()

    named = list(named_leaves(params))
    with ThreadPoolExecutor(threads) as pool:
        digests = list(pool.map(digest, [x for _, x in named]))
    return [(path, d) for (path, _), d in zip(named, digests)]


def het_kernel_times(torch, dev, cfg):
    """Both kernels at a unit's shapes (1 x ``HET_S`` tokens): forward and
    gradients against their plain versions (flash's forward at
    ``FLASH_TOL``, the rest bitwise), then the kernel, its plain version,
    the library call, the bound and the whole backward, as phase 14 times
    them.  Returns {kernel: (max abs error, ms, plain ms, bound ms,
    bound_by, library ms, backward ms)}."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.linear_scan import (linear_scan,
                                                 linear_scan_cuda,
                                                 linear_scan_ref)
    gen = torch.Generator(device=dev).manual_seed(21)

    def draw(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    S, R = HET_S, cfg.lru_width
    scan_in = (torch.rand((1, S, R), generator=gen, device=dev) * 0.49
               + 0.5, draw((1, S, R)))
    qkv = (draw((1, S, cfg.n_heads, cfg.hd), torch.bfloat16),
           draw((1, S, cfg.n_kv_heads, cfg.hd), torch.bfloat16),
           draw((1, S, cfg.n_kv_heads, cfg.hd), torch.bfloat16))

    def flash_w(q, k, v):
        return flash_attention(q, k, v, True, cfg.window)

    def plain_w(q, k, v):
        return attention_ref(q, k, v, True, cfg.window)

    times, failed = {}, []
    for name, op, plain, inputs, fwd_tol in (
            ("linear_scan", linear_scan, linear_scan_ref, scan_in, 0.0),
            ("flash_attention", flash_w, plain_w, qkv,
             FLASH_TOL["bfloat16"])):
        cot = draw(op(*inputs).shape, inputs[0].dtype)
        got, out, launched, _ = backward_of(torch, op, inputs, cot)
        want, ref_out, _, _ = backward_of(torch, plain, inputs, cot)
        out, ref_out = out.detach(), ref_out.detach()
        fwd_err = float((out.float() - ref_out.float()).abs().max())
        err = max([fwd_err] + [float((g.float() - w.float()).abs().max())
                               for g, w in zip(got, want)])
        ok = bool(torch.allclose(out.float(), ref_out.float(), rtol=fwd_tol,
                                 atol=fwd_tol)) if fwd_tol \
            else torch.equal(out, ref_out)
        ok = ok and all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"  {name} at a unit's shape {tuple(inputs[0].shape)}: "
              f"{'ok' if ok else 'FAIL'} forward max_abs_err {fwd_err:.3e} "
              f"({'bitwise' if not fwd_tol else f'tol {fwd_tol}'}), "
              f"gradients {'bitwise' if ok else 'differ'}; the backward's "
              f"launches {launched or 'none'}")
        if not ok:
            failed.append(name)
        times[name] = [err]
        del got, want, out, ref_out, cot
    if failed:
        fail(f"kernels at the heterogeneous-training path's unit shape: "
             f"{failed}")
    a, b = scan_in
    s_ms = cuda_ms(torch, lambda: linear_scan_cuda(a, b))
    s_plain = cuda_ms(torch, lambda: linear_scan_ref(a, b))
    s_bytes = 3 * a.numel() * 4
    s_bound = s_bytes / HBM_BYTES_PER_S * 1e3
    bwd = {}
    for name, op, inputs in (("linear_scan", linear_scan, scan_in),
                             ("flash_attention", flash_w, qkv)):
        leaves_ = [x.detach().clone().requires_grad_() for x in inputs]
        out = op(*leaves_)
        cot = torch.ones_like(out)
        bwd[name] = cuda_ms(torch, lambda: torch.autograd.grad(
            out, leaves_, cot, retain_graph=True))
        del leaves_, out, cot
    print(f"linear_scan at {tuple(a.shape)} f32: kernel {s_ms:.4f} ms "
          f"({s_bytes / s_ms / 1e9:.3f} TB/s, {s_bound / s_ms:.3f} of the "
          f"bound), plain {s_plain:.4f} ms; bound {s_bound:.4f} ms by bytes "
          f"({s_bytes} bytes); the whole backward {bwd['linear_scan']:.4f} "
          f"ms")
    f_ms, f_plain, f_lib, f_bound, f_by = time_flash(torch, qkv, cfg.window)
    print(f"flash_attention backward at {tuple(qkv[0].shape)} bf16 (the "
          f"plain version recomputed and differentiated): "
          f"{bwd['flash_attention']:.4f} ms")
    times["linear_scan"] += [s_ms, s_plain, s_bound, "bytes", None,
                             bwd["linear_scan"]]
    times["flash_attention"] += [f_ms, f_plain, f_bound, f_by, f_lib,
                                 bwd["flash_attention"]]
    return times


def het_phases(torch, dev):
    """Phases 21-22; returns the heterogeneous-training path's entries."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import HetSpec
    from repro_torch.data import UnitStore
    from repro_torch.distributed import (POLICIES, HetTrainer,
                                         Int8Compressor, TopKCompressor)
    from repro_torch.hettrain import (TrainConfig, run_training_grid,
                                      run_virtual_step, tree_bytes)
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.optim.adamw import tree_map

    cfg = get_config(TRAIN_ARCH)
    rates = het_fleet()
    print(f"heterogeneous training: fleet of {HET_K} rates "
          f"{np.round(rates, 4).tolist()}; {HET_UNITS} units a step of 1 x "
          f"{HET_S} structured tokens")
    times = het_kernel_times(torch, dev, cfg)

    # 21. HetTrainer at full width under each policy, from the same seed
    model = build_model(cfg)
    store = UnitStore(1, HET_S, cfg.vocab_size, structured=True)
    per_unit = launches_per_step(cfg, False)
    per_step = {k: HET_UNITS * v for k, v in per_unit.items()}
    want = {k: HET_STEPS * v for k, v in per_step.items()}
    want_designs = {("flash_attention", "tc"): want["flash_attention"],
                    ("linear_scan", "ring"): want["linear_scan"]}

    def trainer_for(model_, policy, compressor=None):
        return HetTrainer(model_, AdamW(lr=constant(TRAIN_LR)), rates,
                          store, policy=policy, units_per_step=HET_UNITS,
                          compressor=compressor)

    runs = {}
    cases = [(p, p, None) for p in POLICIES] + [
        ("work_exchange, worker 3 failing at step 1", "work_exchange",
         {1: [3]})]
    for label, policy, failures in cases:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=dev)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        trainer = trainer_for(model, policy)
        grad_s = []
        grad_sum = trainer.engine.grad_sum

        def timed(p, ids, _grad_sum=grad_sum):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _grad_sum(p, ids)
            torch.cuda.synchronize()
            grad_s.append(time.perf_counter() - t)
            return out

        trainer.engine.grad_sum = timed
        _build.reset_launch_counts()
        step_s = []
        if failures is None:
            state = trainer.opt.init(params)
            hist = []
            for s in range(HET_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, state, rep = trainer.step(params, state, s)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                hist.append(rep)
        else:
            t = time.perf_counter()
            params, state, hist = trainer.train(params, HET_STEPS,
                                                failures=failures)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
        launches = {k: v for k, v in _build.LAUNCH_COUNTS.items() if v}
        designs = {k: v for k, v in _build.DESIGN_COUNTS.items() if v}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        digests = leaf_digests(torch, params)
        runs[label] = dict(hist=hist, step_s=step_s, grad_s=grad_s,
                           launches=launches, designs=designs, peak=peak,
                           digests=digests)
        warm = step_s[1:] if failures is None else step_s
        if policy == "work_exchange" and failures is None:
            # one more step, profiled: the device's busy share and kinds
            events, _ = profile_generate(
                torch, lambda: trainer.step(params, state, HET_STEPS),
                "HetTrainer step (work_exchange)")
            print_device_kinds(events)
            busy_ms = sum(e.self_device_time_total for e in events) / 1e3
            print(f"  the profiled step's device time over the unprofiled "
                  f"warm step: {100 * busy_ms / (min(warm) * 1e3):.2f}%")
        # one grad_sum a step (the canonical path; the profiled step
        # added one more)
        outside = 1.0 - sum(grad_s[1:HET_STEPS]) / sum(warm) \
            if failures is None else float("nan")
        print(f"  {label}: draw {draw_s:.2f} s; losses "
              f"{[round(h.loss, 6) for h in hist]}; t_virtual "
              f"{[round(h.t_virtual, 6) for h in hist]}; iterations "
              f"{[h.iterations for h in hist]}; n_comm "
              f"{[h.n_comm_units for h in hist]}; refetch tokens "
              f"{[h.refetch_tokens for h in hist]}; step wall "
              f"{[round(s * 1e3, 3) for s in step_s]} ms"
              + (f" (warm min {min(warm) * 1e3:.3f} ms, "
                 f"{100 * outside:.2f}% outside grad_sum)"
                 if failures is None else " (the whole train call)")
              + f"; launches {launches} (want {want}); peak {peak:.3f} GB")
        del params, state, trainer, hist
    torch.cuda.empty_cache()
    first = runs[POLICIES[0]]
    same = [label for label, r in runs.items()
            if r["digests"] == first["digests"]]
    n_leaves = len(first["digests"])
    print(f"  parameters after {HET_STEPS} steps: {len(same)} of "
          f"{len(runs)} runs bitwise equal to {POLICIES[0]}'s ({n_leaves} "
          f"leaves, SHA-256 of each leaf's bytes)")
    problems = []
    if len(same) != len(runs):
        problems.append(f"parameters differ: only {same} equal "
                        f"{POLICIES[0]}'s")
    for label, r in runs.items():
        losses = [h.loss for h in r["hist"]]
        if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            problems.append(f"{label}: losses {losses}")
        if r["launches"] != want or r["designs"] != want_designs:
            problems.append(f"{label}: launches {r['launches']}, designs "
                            f"{r['designs']}")
    if any(h.iterations != 1 for h in runs["gradient_coded"]["hist"]):
        problems.append("gradient_coded took more than 1 iteration a step")
    # the paper's ordering of the policies' virtual step times.  Over
    # the trained steps alone the ordering is noise (16 units on 8
    # workers: ~0.1 of the step's virtual time a step), so it is held over
    # HET_VIRTUAL_STEPS steps of the same schedulers and pool (each
    # HetTrainer's own; no gradient), whose first HET_STEPS steps are the
    # trained steps' clocks bit for bit
    virtual = {}
    for policy in POLICIES:
        trainer = trainer_for(None, policy)
        ts = []
        for s in range(HET_VIRTUAL_STEPS):
            ids = list(range(s * HET_UNITS, (s + 1) * HET_UNITS))
            ts.append(run_virtual_step(trainer._make_scheduler(ids),
                                       trainer.pool, ids,
                                       loader=trainer.loader).t_comp)
        virtual[policy] = np.array(ts)
        trained = [h.t_virtual for h in runs[policy]["hist"]]
        if trained != ts[:HET_STEPS]:
            problems.append(f"{policy}: the virtual run's first steps "
                            f"{ts[:HET_STEPS]} are not the trained steps' "
                            f"{trained}")
    means = {p: float(np.mean([h.t_virtual for h in runs[p]["hist"]]))
             for p in POLICIES}
    vmeans = {p: float(v.mean()) for p, v in virtual.items()}
    vse = {p: float(v.std() / np.sqrt(v.size)) for p, v in virtual.items()}
    print(f"  mean t_virtual over the {HET_STEPS} trained steps: "
          + ", ".join(f"{p} {means[p]:.6f}" for p in POLICIES))
    print(f"  mean t_virtual over {HET_VIRTUAL_STEPS} virtual steps (SE): "
          + ", ".join(f"{p} {vmeans[p]:.6f} ({vse[p]:.6f})"
                      for p in POLICIES))
    for p in ("work_exchange", "work_exchange_online", "het_static"):
        if not vmeans[p] < vmeans["equal_static"]:
            problems.append(f"{p}'s mean virtual step {vmeans[p]} is not "
                            f"below equal_static's {vmeans['equal_static']}")
    if problems:
        fail("HetTrainer at full width: " + "; ".join(problems))
    peak = max(r["peak"] for r in runs.values())
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    warm = min(min(r["step_s"][1:]) for label, r in runs.items()
               if label in POLICIES)
    print(f"hettrain {TRAIN_ARCH}: {HET_UNITS} x 1 x {HET_S} tokens a step, "
          f"warm step min {warm * 1e3:.3f} ms "
          f"({HET_UNITS * HET_S / warm:.1f} tokens/s); peak memory "
          f"{peak:.3f} GB of {total_gb:.3f}; launches a step {per_step}")

    # 22. the lossy path at depth 3, and the runner on the card
    cfg3 = dataclasses.replace(cfg, n_layers=3)
    model3 = build_model(cfg3)
    lossy = {}
    # without error feedback: a worker's float32 residual tree holds all
    # 1.57e9 parameters of the depth-3 model (the untied lm_head and the
    # embedding are 1.31e9 of them), so the fleet's 8 take 50 GB, which
    # beside the params, AdamW's state and the step's sums does not fit
    # on one 80 GB card; the residual path is held below on one worker at
    # this width, and against the reference on the CPU
    for label, comp in (("dense", None),
                        ("int8", Int8Compressor(error_feedback=False)),
                        ("top-k 0.25", TopKCompressor(
                            0.25, error_feedback=False))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = model3.init(seed=0, device=dev)
        n_params3 = describe_params(params)[0]
        trainer = trainer_for(model3, "work_exchange", comp)
        t0 = time.perf_counter()
        params, state, hist = trainer.train(params, LOSSY_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak3 = torch.cuda.max_memory_allocated(dev) / 1e9
        lossy[label] = hist
        print(f"  depth 3, {label}: losses {[round(h.loss, 6) for h in hist]}"
              f"; grad bytes {[h.grad_bytes for h in hist]}; "
              f"{LOSSY_STEPS} steps in {wall * 1e3:.3f} ms; peak "
              f"{peak3:.3f} GB")
        del params, state, trainer, comp
    torch.cuda.empty_cache()
    dense_b = lossy["dense"][0].grad_bytes
    problems = []
    int8_b = lossy["int8"][0].grad_bytes
    per_param = int8_b / (HET_UNITS * n_params3)
    print(f"  int8 ships {int8_b / dense_b:.4f} of the dense path's bytes "
          f"({dense_b / (HET_UNITS * n_params3):.4f} bytes a parameter a "
          f"unit): {per_param:.4f} bytes a parameter a unit (limit "
          f"{INT8_BYTES_PER_PARAM})")
    if not per_param < INT8_BYTES_PER_PARAM:
        problems.append(f"int8 ships {per_param} bytes a parameter a unit")
    if not all(np.isfinite(h.loss) for hs in lossy.values() for h in hs):
        problems.append("a loss is not finite")
    params = model3.init(seed=0, device=dev)
    ones = tree_map(lambda x: torch.ones(x.shape, device=dev), params)
    comp = TopKCompressor(0.25)
    del params
    out1, b1 = comp.roundtrip(ones, 0)
    m1 = sum(float(x.double().sum()) for x in leaves(out1))
    del out1
    out2, b2 = comp.roundtrip(ones, 0)
    m2 = sum(float(x.double().sum()) for x in leaves(out2))
    print(f"  top-k 0.25 on ones shaped like the depth-3 params "
          f"({tree_bytes(ones) / 1e9:.3f} GB float32): mass {m1:.6e} then "
          f"{m2:.6e} ({b1:.0f} and {b2:.0f} wire bytes)")
    if not m2 >= m1:
        problems.append(f"top-k's second round ships less mass ({m2}) than "
                        f"its first ({m1})")
    del ones, out2, comp
    torch.cuda.empty_cache()

    train = TrainConfig(model="small", steps=RUNNER_STEPS)
    specs = [HetSpec(rates), HetSpec.uniform_random(
        HET_K, 5.0, 5.0 ** 2 / 6, np.random.default_rng(1))]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    reports = {name: run_training_grid(name, {}, specs, train, RUNNER_N,
                                       RUNNER_TRIALS, 0, device=dev)
               for name in RUNNER_SCHEMES}
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    runner_launches = {k: v for k, v in _build.LAUNCH_COUNTS.items() if v}
    t0 = time.perf_counter()
    cpu = run_training_grid("work_exchange", {}, specs, train, RUNNER_N,
                            RUNNER_TRIALS, 0, device="cpu")
    cpu_s = time.perf_counter() - t0
    curves = [r.extra["training"]["loss_curve"]
              for reps in reports.values() for r in reps]
    cpu_curve = np.array(cpu[0].extra["training"]["loss_curve"])
    rel = float(np.max(np.abs(np.array(curves[0]) - cpu_curve)
                       / np.abs(cpu_curve)))
    print(f"  run_training_grid, {len(RUNNER_SCHEMES)} schemes, "
          f"TrainConfig(model='small', steps={RUNNER_STEPS}), {RUNNER_N} "
          f"units a step, {len(specs)} points x {RUNNER_TRIALS} trials: "
          f"{card_s * 1e3:.3f} ms on the card (launches "
          f"{runner_launches}), one scheme on the CPU {cpu_s * 1e3:.3f} ms;"
          f" loss curve {[round(x, 6) for x in curves[0]]}, "
          f"{len(curves)} curves bitwise equal: "
          f"{all(c == curves[0] for c in curves)}; against the CPU plain "
          f"path {rel:.3e} relative (limit {RUNNER_CPU_RTOL})")
    if not all(c == curves[0] for c in curves):
        problems.append("the runner's loss curves differ across schemes")
    if not rel <= RUNNER_CPU_RTOL:
        problems.append(f"the runner's curve is {rel} from the CPU's")
    if cpu[0].t_comp != reports["work_exchange"][0].t_comp:
        problems.append("the runner's virtual times differ card to CPU")
    if not runner_launches.get("flash_attention"):
        problems.append("the runner's trajectory launched no flash kernel")
    if problems:
        fail("lossy path and runner: " + "; ".join(problems))
    del model3

    entries = []
    main = runs["work_exchange"]
    for name in ("linear_scan", "flash_attention"):
        err, ms, plain_ms, bound, by, lib, bwd = times[name]
        entries.append({
            "name": name, "path": HET_PATH, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "backward": BACKWARDS[name],
            "launches": main["launches"][name],
            "launches_per_step": per_step[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib, "backward_ms": bwd})
    return entries


@contextlib.contextmanager
def recorded_calls(module, name: str):
    """Run every call of ``module.name`` -- a kernel wrapper as its op
    module binds it -- through, keeping each call's arguments: the inputs
    the main path handed the kernel.  The wrapper still counts its own
    launches."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def we_rounds_entry(torch, path: str, launches: int, runs: int,
                    calls) -> tuple:
    """(bitwise, the kernels line's ``we_rounds`` entry) for one
    experiment path of ``runs`` runs that made ``launches`` launches in
    all: the largest launch, replayed through the kernel and its plain
    version on the same inputs, timed (warm minimum of 3) against the
    bound from this run's rounds."""
    from repro_torch.kernels.we_rounds import kernel as wk
    from repro_torch.kernels.we_rounds import ref as wref
    (rows, seed, sched, flags), kw = max(calls,
                                         key=lambda c: c[0][0].shape[0])
    base = {k: kw[k] for k in ("n0", "threshold", "cap", "max_iter")}

    def kernel():
        return wk.we_rounds_cuda(rows, seed, sched, flags, **kw)

    def plain():
        if flags is not None:
            cols = wref.we_rounds_reference_panel(rows, seed, flags, sched,
                                                  **base)
        else:
            cols = wref.we_rounds_reference(rows, seed, sched,
                                            known=kw["known"], **base)
        return torch.stack(cols, dim=1)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain)
    bound, by, _, _ = we_rounds_bound(rows, got, (sched, flags))
    mode = ("panel" if flags is not None else
            "known" if kw["known"] else "unknown") \
        + (f", drift R={sched.shape[1]}" if sched is not None else "")
    print(f"  we_rounds on {path}: {launches} launches in {runs} runs; "
          f"the largest, "
          f"{tuple(rows.shape)} ({mode}), kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms by {by} "
          f"({bound / ms:.3f} of it); bitwise {bitwise}, max_abs_err "
          f"{err:.3e}")
    return bitwise, {
        "name": "we_rounds", "path": path, "route": "cuda",
        "source": "src/repro_torch/csrc/we_rounds.cu",
        "replaces": "src/repro/kernels/we_rounds/kernel.py:107",
        "launches": launches, "runs": runs, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}


def flash_entry(torch, path: str, launches: int, runs: int,
                calls) -> tuple:
    """(ok, the kernels line's ``flash_attention`` entry) for a training
    path of ``runs`` runs that made ``launches`` launches each: the
    path's first launch replayed through the kernel, its plain version
    and ``scaled_dot_product_attention`` on the same inputs, held at
    ``FLASH_TOL`` and timed (warm minimum of 3)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    (q, k, v, causal, window, scale), _ = calls[0]
    q, k, v = (x.detach() for x in (q, k, v))

    def kernel():
        return flash_attention_cuda(q, k, v, causal, window, scale)

    def plain():
        return attention_ref(q, k, v, causal, window, scale)

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    dt = str(q.dtype).replace("torch.", "")
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=FLASH_TOL[dt],
                             atol=FLASH_TOL[dt]))
    ms, plain_ms, lib_ms = (cuda_ms(torch, fn) for fn in (kernel, plain,
                                                           sdpa))
    bound, by, _, _ = flash_bound(q, k, window, causal)
    print(f"  flash_attention on {path}: {launches} launches a run "
          f"({runs} runs) at "
          f"{tuple(q.shape)} kv {tuple(k.shape)} {dt} causal={causal}: "
          f"{'ok' if ok else 'FAIL'} max_abs_err {err:.3e} (tol "
          f"{FLASH_TOL[dt]}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {bound:.6f} ms by {by}")
    return ok, {
        "name": "flash_attention", "path": path, "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": REPLACES["flash_attention"], "backward":
        BACKWARDS["flash_attention"], "launches": launches, "runs": runs,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def flat_fields(tree, prefix=""):
    """{dotted path: leaf} of a report's nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat_fields(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def losses_apart(reports: dict) -> tuple:
    """({dotted path: leaf} of a training spec's reports but the losses,
    the losses in path order)."""
    fields = flat_fields(reports)
    lost = sorted(p for p in fields
                  if set(p.split(".")) & set(LOSS_FIELDS[:2]))
    return ({p: v for p, v in fields.items() if p not in lost},
            np.array([fields[p] for p in lost]))


def train_row_problems(got: dict, want: dict, worst_ulps: dict) -> tuple:
    """A training spec's reports against the stored ones: every field
    exactly, ``ULP_FIELDS`` within ``STORE_ULPS`` ulps, and the fields
    that follow the loss (which the port's own weights set) left out.
    Keeps each ULP field's largest gap in ``worst_ulps``.  Returns
    (problems, fields held, fields bitwise equal)."""
    g, w = flat_fields(got), flat_fields(want)
    keep = [p for p in w if not set(p.split(".")) & set(LOSS_FIELDS)]
    problems, equal = [], 0
    for p in keep:
        a, b = g.get(p), w[p]
        field = next((f for f in ULP_FIELDS if f in p.split(".")), None)
        if a == b:
            equal += 1
        elif (field and isinstance(a, float) and isinstance(b, float)
              and abs(a - b) <= STORE_ULPS * np.spacing(abs(b))):
            worst_ulps[field] = max(worst_ulps.get(field, 0),
                                    abs(a - b) / np.spacing(abs(b)))
        else:
            problems.append(f"{p}: {a!r} against {b!r}")
    if set(g) != set(w):
        problems.append(f"fields differ: {sorted(set(g) ^ set(w))[:4]}")
    return problems, len(keep), equal


def experiment_phase(torch, dev):
    """Phase 23: the experiment layer on the card -- the store as oracle,
    fig5/6/7 at paper scale on ``cuda``, the other scenario families,
    training specs through ``run_experiment`` and the CLI.  Returns the
    kernels line's entries of its paths."""
    import tempfile

    import repro_torch.experiments as ex
    from repro_torch.experiments.__main__ import demo_spec, hcmm_demo_specs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.we_rounds import ops as wops
    problems, entries = [], []

    def run(spec):
        """One run of ``spec`` on the card, the launch counts zeroed just
        before and read just after, each launch's inputs recorded."""
        _build.reset_launch_counts()
        with recorded_calls(wops, "we_rounds_cuda") as we_calls, \
                recorded_calls(fops, "flash_attention_cuda") as fl_calls:
            t0 = time.perf_counter()
            result = ex.run_experiment(spec, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCH_COUNTS.items() if v}
        return result, wall, launches, we_calls, fl_calls

    def warm_wall(spec, device):
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            ex.run_experiment(spec, device=device)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    # 1. the committed store as oracle
    stored = {}
    print(f"experiment layer: numpy {np.__version__}, torch "
          f"{torch.__version__}")
    for path in sorted((ROOT / "results" / "store").glob("*.json")):
        d = json.loads(path.read_text())
        name = d["spec"]["name"]
        if "serving" in d["spec"]:
            continue        # phase 24
        spec = ex.ExperimentSpec.from_dict(d["spec"])
        if spec.execution == "live":
            ok = spec.spec_hash() == path.stem
            print(f"  store {path.stem[:12]} {name} (live): hash ok {ok}; "
                  f"rerun in phase 25")
            if not ok:
                problems.append(f"{name} (live): spec hash "
                                f"{spec.spec_hash()[:12]} is not its address")
            continue
        if spec.spec_hash() != path.stem:
            problems.append(f"{name}: spec hash {spec.spec_hash()[:12]} is "
                            f"not its address {path.stem[:12]}")
        stored[name] = (spec, d)
        if spec.training is not None:
            continue        # step 4
        t0 = time.perf_counter()
        got = ex.run_experiment(spec, device=dev).to_dict()["reports"]
        wall = time.perf_counter() - t0
        equal = got == d["reports"]
        print(f"  store {path.stem[:12]} {name} ({spec.backend}): hash ok "
              f"{spec.spec_hash() == path.stem}, reports bit for bit "
              f"{equal} ({wall * 1e3:.3f} ms)")
        if not equal:
            diffs = [p for p, v in flat_fields(got).items()
                     if flat_fields(d["reports"]).get(p) != v]
            problems.append(f"{name}: {len(diffs)} stored fields differ, "
                            f"first {diffs[:3]}")
    for fig, (build, _, _) in FIGURES.items():
        for quick in (False, True):
            spec = build(ex, backend="numpy", quick=quick)
            if stored.get(spec.name, (None,))[0] != spec:
                problems.append(f"the script's {spec.name} spec is not "
                                f"the stored one")

    # 2. the figures at paper scale on the cuda backend
    claims, on_cuda = [], {}
    for fig, (build, rows_from, validate) in FIGURES.items():
        spec = build(ex, backend="cuda")
        result, first_s, launches, we_calls, _ = run(spec)
        checks = validate(rows_from(result))
        claims += checks
        want = ex.ExperimentResult.from_dict(stored[fig][1])
        gaps = [mean_gap(a, b) for key in result.keys()
                for a, b in zip(result.report(key), want.report(key))]
        far = sum(not ok for _, ok in gaps)
        cuda_s = warm_wall(spec, dev)
        numpy_s = warm_wall(stored[fig][0], "cpu")
        print(f"  {fig} on cuda (K={K_PAPER} N={N_PAPER}, {len(spec.grid)} "
              f"points x {spec.trials} trials, {len(spec.schemes)} tasks): "
              f"launches {launches}; claims {sum(ok for _, ok in checks)}/"
              f"{len(checks)}; {len(gaps)} reports against the stored "
              f"numpy ones, worst {max(g for g, _ in gaps):.3f} SE, "
              f"{far} beyond 6 SE and 2e-3; wall cuda {cuda_s * 1e3:.3f} ms "
              f"(first {first_s * 1e3:.3f} ms), numpy {numpy_s * 1e3:.3f} "
              f"ms (host clock, warm min of 2)")
        if far:
            problems.append(f"{fig}: {far} reports beyond 6 SE of numpy")
        if launches.get("we_rounds", 0) < 1:
            problems.append(f"{fig} launched we_rounds no time")
        ok, entry = we_rounds_entry(torch, f"experiments {fig}",
                                    launches.get("we_rounds", 0), 1,
                                    we_calls)
        entries.append(entry)
        if not ok:
            problems.append(f"we_rounds on {fig}'s inputs is not bitwise "
                            f"its plain version")
        on_cuda[fig] = result
    bad = [name for name, ok in claims if not ok]
    print(f"  paper-claim checks through run_experiment on cuda: "
          f"{len(claims) - len(bad)}/{len(claims)} passed")
    problems += [f"claim failed: {name}" for name in bad]

    fused, fused_s, launches, we_calls, _ = run(
        fig5_experiment(ex, backend="cuda", panel="fused"))
    same = all([r.to_dict() for r in fused.report(k)]
               == [r.to_dict() for r in on_cuda["fig5"].report(k)]
               for k in FIG_SCHEMES if k not in WE_PAIR)
    want = ex.ExperimentResult.from_dict(stored["fig5"][1])
    pair_gaps = [mean_gap(a, b) for k in WE_PAIR
                 for a, b in zip(fused.report(k), want.report(k))]
    print(f"  fig5 panel='fused' on cuda: launches {launches} "
          f"({fused_s * 1e3:.3f} ms); the other four tasks equal "
          f"per_scheme's: {same}; the pair's worst gap to numpy "
          f"{max(g for g, _ in pair_gaps):.3f} SE")
    if launches.get("we_rounds") != 1:
        problems.append(f"the fused fig5 pair took {launches} launches")
    if not same or not all(ok for _, ok in pair_gaps):
        problems.append("the fused fig5 panel disagrees")
    from torch.profiler import ProfilerActivity, profile
    fig5_cuda = fig5_experiment(ex, backend="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.run_experiment(fig5_cuda, device=dev)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev_us = sum(e.self_device_time_total
                 for e in device_rows(torch, prof)[0])
    print(f"  profiled fig5 run on cuda: wall {prof_wall * 1e3:.3f} ms, "
          + (f"device busy {dev_us / 1e3:.3f} ms "
             f"({100 * dev_us / (prof_wall * 1e6):.2f}% of wall)"
             if dev_us > 0 else "the profiler recorded no device time "
             "(busy share not measured)"))

    # 3. the other scenario families on cuda, against numpy
    fams = [demo_spec("drifting"), demo_spec("trace")] + hcmm_demo_specs()
    we_total, sched_calls, fam_calls = 0, 0, []
    for spec in fams:
        result, wall, launches, we_calls, _ = run(spec)
        exact = ex.run_experiment(spec.replace(backend="numpy"),
                                  device="cpu")
        we_total += launches.get("we_rounds", 0)
        fam_calls += we_calls
        drifts = spec.grid.rate_schedules() is not None
        with_sched = sum(c[0][2] is not None for c in we_calls)
        sched_calls += with_sched
        notes = []
        scheme_of = {s.report_key: s.scheme for s in spec.schemes}
        for key in result.keys():
            sch = scheme_of[key]
            rows, ref_rows = result.report(key), exact.report(key)
            finite = all(np.isfinite(r.t_comp) for r in rows)
            if sch in WE_PAIR:
                gap_ok = all(mean_gap(a, b)[1]
                             for a, b in zip(rows, ref_rows))
            else:       # host draws: the numpy engine's bits
                gap_ok = ([r.to_dict() for r in rows]
                          == [r.to_dict() for r in ref_rows])
            nominal = all(r.extra.get("nominal_rates_only") == 1
                          for r in rows)
            if not (finite and gap_ok) or (drifts and nominal
                                           == (sch in WE_PAIR)):
                problems.append(f"{spec.name} {key}: finite {finite}, "
                                f"agrees with numpy {gap_ok}, stamped "
                                f"nominal {nominal}")
            notes.append(f"{key} {rows[0].t_comp:.4f}"
                         + (" [nominal]" if nominal else ""))
        if drifts and with_sched != launches.get("we_rounds", 0):
            problems.append(f"{spec.name}: {with_sched} of "
                            f"{launches.get('we_rounds', 0)} launches had "
                            f"the rate schedule")
        print(f"  {spec.name} ({spec.grid.family}) on cuda: launches "
              f"{launches}, {with_sched} with a rate schedule; "
              f"{wall * 1e3:.3f} ms; point 0: " + ", ".join(notes))
    ok, entry = we_rounds_entry(torch, "experiments scenario families",
                                we_total, len(fams), fam_calls)
    entries.append(entry)
    if not ok:
        problems.append("we_rounds on the families' inputs is not bitwise")
    if sched_calls < 4:
        problems.append(f"only {sched_calls} launches carried a schedule")

    # 4. the stored training specs through the layer
    fl_counts, fl_calls, worst_ulps = [], [], {}
    for name in FIG_TRAIN:
        spec, d = stored[name]
        result, wall, launches, _, calls = run(spec)
        fl_counts.append(launches.get("flash_attention", 0))
        fl_calls += calls[:1]
        got = result.to_dict()["reports"]
        bad_fields, held, equal = train_row_problems(got, d["reports"],
                                                     worst_ulps)
        curves = [rep.extra["training"]["loss_curve"]
                  for rows in result.reports.values() for rep in rows]
        t0 = time.perf_counter()
        on_cpu = ex.run_experiment(spec, device="cpu").to_dict()["reports"]
        cpu_s = time.perf_counter() - t0
        (fields, losses), (cpu_fields, cpu_losses) = map(
            losses_apart, (got, on_cpu))
        rel = float(np.max(np.abs(losses - cpu_losses) / np.abs(cpu_losses)))
        cpu_off = [p for p in cpu_fields if fields.get(p) != cpu_fields[p]]
        jax_curve = d["reports"][WE_PAIR[0]][0]["extra"]["training"][
            "loss_curve"]
        print(f"  {name} on cuda: {wall * 1e3:.3f} ms, launches {launches}; "
              f"{held} stored scheduling fields held, {equal} bitwise, "
              f"{len(bad_fields)} off; against the port's CPU run "
              f"({cpu_s * 1e3:.3f} ms): {len(cpu_fields)} fields but the "
              f"losses, {len(cpu_off)} off, the losses {rel:.3e} relative "
              f"(limit {TRAIN_CURVE_RTOL}); loss {curves[0][0]:.4f} -> "
              f"{curves[0][-1]:.4f} ({len(curves)} curves bitwise equal: "
              f"{all(c == curves[0] for c in curves)}; the stored curve, "
              f"from the JAX package's own weights, {jax_curve[0]:.4f} -> "
              f"{jax_curve[-1]:.4f})")
        problems += [f"{name}: {p}" for p in bad_fields[:5]]
        problems += [f"{name}: {p} {fields.get(p)!r} against the CPU's "
                     f"{cpu_fields[p]!r}" for p in cpu_off[:5]]
        if not all(c == curves[0] for c in curves):
            problems.append(f"{name}: loss curves differ across schemes")
        if not rel <= TRAIN_CURVE_RTOL:
            problems.append(f"{name}: losses {rel} from the CPU's")
    print("  stored fields off by ulps, the worst of each: "
          + (", ".join(f"{f} {u:.0f}" for f, u in sorted(worst_ulps.items()))
             or "none"))
    if min(fl_counts) < 1 or len(set(fl_counts)) > 1:
        problems.append(f"the training specs launched flash {fl_counts} "
                        f"times")
    ok, entry = flash_entry(torch, "experiments fig-train", fl_counts[0],
                            len(fl_counts), fl_calls)
    entries.append(entry)
    if not ok:
        problems.append("flash on the training specs' inputs disagrees")

    # 5. the CLI as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.experiments", "--demo",
             "quick", "--store", tmp, "--check-cache"], cwd=ROOT,
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(SRC)})
        cli_s = time.perf_counter() - t0
    tail = cli.stdout.strip().splitlines()[-1:] or [cli.stderr.strip()]
    print(f"  python -m repro_torch.experiments --demo quick --check-cache: "
          f"exit {cli.returncode} in {cli_s:.3f} s: {tail[0]}")
    # a fresh store: the first run computes, the second is the hit
    if cli.returncode != 0 or "computed in" not in cli.stdout \
            or "check-cache: OK" not in cli.stdout:
        problems.append(f"the CLI failed: {cli.stderr.strip()[-300:]}")
    if problems:
        fail("experiment layer: " + "; ".join(problems))
    return entries


@contextlib.contextmanager
def recorded_sweeps(scan):
    """Keep every ``scan.sweep_rows`` call's per-row outputs, in call order
    (one call a scheme task and grid point): ``(scheme, out, meta)``,
    with the call's host-clock wall as ``meta["wall_s"]``."""
    fn = scan.sweep_rows
    sweeps = []

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out, meta = fn(*args, **kw)
        meta["wall_s"] = time.perf_counter() - t0
        sweeps.append((meta["scheme"], out, meta))
        return out, meta

    scan.sweep_rows = wrapper
    try:
        yield sweeps
    finally:
        scan.sweep_rows = fn


def pooled_percentiles(pooled: np.ndarray, bin_vals: np.ndarray,
                       qs=(50.0, 95.0, 99.0)) -> np.ndarray:
    """``np.percentile`` (linear) of the sojourns each row of an (n, H)
    stack of pooled histograms holds, without expanding them."""
    cum = np.cumsum(pooled, axis=1)
    n = cum[:, -1]
    out = np.empty((pooled.shape[0], len(qs)))
    for i, q in enumerate(qs):
        pos = q / 100.0 * (n - 1)
        lo = np.floor(pos)
        v_lo = bin_vals[(cum <= lo[:, None]).sum(axis=1)]
        v_hi = bin_vals[(cum <= np.minimum(lo + 1, n - 1)[:, None]
                         ).sum(axis=1)]
        out[:, i] = v_lo + (v_hi - v_lo) * (pos - lo)
    return out


def percentile_se(hist: np.ndarray, bin_vals: np.ndarray,
                  rng) -> np.ndarray:
    """Standard errors of the pooled p50 / p95 / p99 of a load's (T, H)
    per-trial completion histograms, by resampling the trials."""
    T = hist.shape[0]
    idx = rng.integers(0, T, size=(BOOT_RESAMPLES, T))
    pooled = np.stack([hist[i].sum(axis=0) for i in idx])
    pooled = pooled[pooled.sum(axis=1) > 0]
    return pooled_percentiles(pooled, bin_vals).std(axis=0, ddof=1)


def stored_field_diffs(got: dict, want: dict) -> tuple:
    """(stored fields that differ, keys the rerun has that the store has
    not) of two reports dicts."""
    diffs, newer = [], set()
    for key, rows in want.items():
        for g, (mine, theirs) in enumerate(zip(got[key], rows)):
            for field, v in theirs.items():
                if field != "extra" and mine[field] != v:
                    diffs.append(f"{key}[{g}].{field}")
            for field, v in theirs["extra"].items():
                if mine["extra"].get(field) != v:
                    diffs.append(f"{key}[{g}].extra.{field}")
            newer |= set(mine["extra"]) - set(theirs["extra"])
        if len(got[key]) != len(rows):
            diffs.append(f"{key}: {len(got[key])} rows, not {len(rows)}")
    return diffs, newer


# phase 24's background run of a stored fig-load entry's spec on the numpy
# engine: ``python -c NUMPY_RERUN <entry.json> <out.json> [seed]`` runs the
# spec once on the host, at ``seed`` when one is given (the oracle's
# witness against itself), and writes its reports and wall
NUMPY_RERUN = """
import json, sys, time
import repro_torch.experiments as ex
spec = ex.ExperimentSpec.from_dict(json.load(open(sys.argv[1]))["spec"])
if len(sys.argv) > 3:
    spec = spec.replace(seed=int(sys.argv[3]))
t0 = time.perf_counter()
reports = ex.run_experiment(spec, device="cpu").to_dict()["reports"]
json.dump({"reports": reports, "wall": time.perf_counter() - t0},
          open(sys.argv[2], "w"))
"""
PERCENTILES = ("p50", "p95", "p99")


def percentile_deltas(got: dict, want: dict) -> tuple:
    """Over every (scheme, load) report of two reports dicts, in order:
    the (rows, 3) differences got - want of p50 / p95 / p99, each row's
    combined SE of the mean (the reference cell test's unit), and each
    row's ``scheme@load`` tag."""
    d, se, tags = [], [], []
    for key, rows in want.items():
        for a, b in zip(got[key], rows):
            d.append([a["extra"][q] - b["extra"][q] for q in PERCENTILES])
            se.append(max(np.hypot(a["t_comp_std"], b["t_comp_std"])
                          / np.sqrt(b["trials"]), 1e-9))
            tags.append(f"{key}@{b['extra']['offered_load']:g}")
    return np.array(d), np.array(se), tags


def worst_of(ratio: np.ndarray, tags: list) -> str:
    """``x (q, scheme@load)`` of the largest entry of a (rows, 3) stack."""
    i, j = np.unravel_index(np.argmax(ratio), ratio.shape)
    return f"{ratio[i, j]:.3f} ({PERCENTILES[j]}, {tags[i]})"


def sign_counts(d: np.ndarray) -> str:
    """``p50 +a/-b/=c, ...`` over the rows of a (rows, 3) stack."""
    return ", ".join(f"{q} +{int((d[:, i] > 0).sum())}/"
                     f"-{int((d[:, i] < 0).sum())}/="
                     f"{int((d[:, i] == 0).sum())}"
                     for i, q in enumerate(PERCENTILES))


def serving_checks(torch_result, want, sweeps, N: int) -> tuple:
    """Phase 24 (b): each (scheme, load) report of a torch run against the
    stored numpy one.  Returns (problems, the worst gaps printed, the
    (rows, 3) combined SE of each percentile, resampled from the torch
    run's trials)."""
    problems = []
    worst = {"t_comp": 0.0, "pct": 0.0, "pct_mean_se": 0.0}
    own_se = []
    rng = np.random.default_rng(0)
    for (scheme, out, meta), key in zip(sweeps, torch_result.keys()):
        T = meta["T"]
        bin_vals = np.arange(out["hist"].shape[1]) * meta["dt"]
        for li, (a, b) in enumerate(zip(torch_result.report(key),
                                        want.report(key))):
            tag = f"{key}@{b.extra['offered_load']:g}"
            e = a.extra
            if e.get("serving_backend") != "torch":
                problems.append(f"{tag}: stamped {e.get('serving_backend')}")
            if e["units_admitted"] != e["units_served"] \
                    + e["units_cancelled"] + e["units_backlog"]:
                problems.append(f"{tag}: the ledger does not close")
            if e["units_admitted"] != b.extra["units_admitted"]:
                problems.append(f"{tag}: admitted {e['units_admitted']} "
                                f"units, numpy {b.extra['units_admitted']}")
            se = max(np.hypot(a.t_comp_std, b.t_comp_std) / np.sqrt(T),
                     1e-9)
            d = abs(a.t_comp - b.t_comp) / se
            worst["t_comp"] = max(worst["t_comp"], d)
            if d > 6:
                problems.append(f"{tag}: t_comp {d:.2f} SE from numpy")
            pse = percentile_se(out["hist"][li * T:(li + 1) * T], bin_vals,
                                rng) * np.sqrt(2.0)
            own_se.append(pse)
            for q, s_q in zip(PERCENTILES, pse):
                gap = abs(e[q] - b.extra[q])
                worst["pct"] = max(worst["pct"], gap / max(s_q, 1e-9))
                worst["pct_mean_se"] = max(worst["pct_mean_se"], gap / se)
                if gap > 6 * s_q + 1e-12:
                    problems.append(f"{tag}: {q} {e[q]:.4f} against "
                                    f"{b.extra[q]:.4f}, {gap / s_q:.2f} "
                                    f"of its SE")
            g = b.extra["goodput_units"]
            if abs(g - e["goodput_units"]) > max(6 * 0.03 * g,
                                                 6 * se * N) + 1e-12:
                problems.append(f"{tag}: goodput {e['goodput_units']:.2f} "
                                f"against {g:.2f}")
            m = b.extra["slo_miss_rate"]
            ntot = max(b.extra["completed_jobs"] * T, 1.0)
            se_m = np.sqrt(max(m * (1 - m), 0.25 / ntot) / ntot)
            if abs(m - e["slo_miss_rate"]) > 6 * se_m + 1e-12:
                problems.append(f"{tag}: SLO misses {e['slo_miss_rate']:.4f}"
                                f" against {m:.4f}")
    return problems, worst, np.array(own_se)


def serving_dispatch_wall(ex, spec, scheme: str, backend: str,
                          device) -> float:
    """Host-clock wall of one scheme task of a serving spec (one dispatch:
    every load and trial of its grid point) on ``backend``."""
    import torch
    plan = ex.compile_plan(spec)
    task = next(t for t in plan.tasks if t.scheme == scheme)
    from repro_torch.serving import run_serving_grid
    t0 = time.perf_counter()
    run_serving_grid(task.scheme, task.params_dict, plan.het_specs,
                     spec.serving, spec.N, spec.trials, task.seed,
                     rate_schedules=plan.rate_schedules, backend=backend,
                     device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def serving_phase(torch, dev) -> None:
    """Phase 24: the serving subsystem on the card.  (a) the four stored
    ``fig-load-*`` entries hash to their names and rerun on the numpy
    engine on the card's host: the full ones ``==`` field for field, the
    ``-quick`` ones on every stored field; (b) both full studies on the
    torch engine on the card against the stored numpy reports, and
    ``fig_load.validate``; beside them the numpy oracle at the next seed
    against the store, the witness of the percentile band; (c) the torch
    engine on the card against the same engine on the CPU, row by row, on
    both ``-quick`` specs; (d) walls, alone: one dispatch a study on each
    engine, the queue tier on and off on the card and on the CPU, CUDA
    launches a slot and the device's busy share, one dispatch at 64 x the
    trials; (e) the CLI's ``serving`` and ``serving-trace`` demos on the
    card.  The numpy runs of the full studies and the CLI runs go in
    background processes beside (a)-(c); (d) runs after them, alone."""
    import tempfile

    import repro_torch.experiments as ex
    from repro_torch.serving import scan
    problems = []
    stored = {}
    for path in sorted((ROOT / "results" / "store").glob("*.json")):
        d = json.loads(path.read_text())
        if "serving" in d["spec"]:
            stored[d["spec"]["name"]] = (path.stem, d)
    scenarios = ("stationary", "drifting")
    full = tuple(f"fig-load-{s}" for s in scenarios)
    quick = tuple(f"{n}-quick" for n in full)
    if sorted(stored) != sorted(full + quick):
        fail(f"serving: the store's serving entries are {sorted(stored)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"serving subsystem: {card}; numpy {np.__version__}, torch "
          f"{torch.__version__}")

    t_phase = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    with tempfile.TemporaryDirectory() as tmp:
        background = {}
        for name in full:
            entry = str(ROOT / "results" / "store" / f"{stored[name][0]}.json")
            seed = stored[name][1]["spec"]["seed"]
            for tag, extra in ((name, []),
                               (f"{name}@witness", [str(seed + 1)])):
                background[tag] = subprocess.Popen(
                    [sys.executable, "-c", NUMPY_RERUN, entry,
                     str(Path(tmp) / f"{tag}.json")] + extra, cwd=ROOT,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=env)
        for demo in ("serving", "serving-trace"):
            background[demo] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.experiments", "--demo",
                 demo, "--store", str(Path(tmp) / demo), "--check-cache"],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env)

        def from_background(tag: str) -> dict:
            _, err = background[tag].communicate(timeout=900)
            if background[tag].returncode != 0:
                fail(f"serving: the numpy run {tag} failed: "
                     f"{err.strip()[-500:]}")
            return json.loads((Path(tmp) / f"{tag}.json").read_text())

        try:
            # (a) the stored entries: addresses, and the quick reruns
            specs = {}
            for name, (stem, d) in stored.items():
                spec = ex.ExperimentSpec.from_dict(d["spec"])
                scen = name.split("-")[2]
                mine = fig_load_experiment(ex, scen, name.endswith("quick"))
                specs[name] = spec
                if spec.spec_hash() != stem or mine != spec:
                    problems.append(f"{name}: hash {spec.spec_hash()[:12]} "
                                    f"for {stem[:12]}, the script's copy "
                                    f"equal {mine == spec}")
            for name in quick:
                got = ex.run_experiment(specs[name],
                                        device=dev).to_dict()["reports"]
                diffs, newer = stored_field_diffs(got, stored[name][1][
                    "reports"])
                print(f"  store {stored[name][0][:12]} {name} (numpy): hash "
                      f"ok, {len(diffs)} stored fields differ; the rerun's "
                      f"only other keys, newer than the entry: "
                      f"{sorted(newer)}")
                if diffs or newer != {"latency_censored", "q_hi_mean",
                                      "q_hi_peak"}:
                    problems.append(f"{name}: {diffs[:3]}, newer {newer}")

            # (c) the card against the CPU, on both quick specs (the CPU
            # tiers the queue, the card does not: the splice is exact)
            equal_rows = total_rows = 0
            for scen in scenarios:
                spec_t = fig_load_experiment(ex, scen, True, backend="torch")
                with recorded_sweeps(scan) as on_card:
                    res_card = ex.run_experiment(spec_t, device=dev)
                with recorded_sweeps(scan) as on_cpu:
                    res_cpu = ex.run_experiment(spec_t, device="cpu")
                same = []
                for (_, a, _), (_, b, _) in zip(on_card, on_cpu):
                    eq = np.ones(a["shipped"].shape[0], dtype=bool)
                    for k in scan.LEDGER_FIELDS + ("hist",):
                        e = a[k] == b[k]
                        eq &= e.all(axis=1) if e.ndim == 2 else e
                    same.append(eq)
                same = np.concatenate(same)
                equal_rows += int(same.sum())
                total_rows += same.size
                gaps = [mean_gap(a, b)[0] for k in res_card.keys()
                        for a, b in zip(res_card.report(k),
                                        res_cpu.report(k))]
                passes = ([m["passes"] for _, _, m in on_card],
                          [m["passes"] for _, _, m in on_cpu])
                print(f"  {spec_t.name} on torch, card against CPU: "
                      f"{int(same.sum())}/{same.size} rows with equal "
                      f"ledger and histogram, reports worst "
                      f"{max(gaps):.3f} SE; passes a dispatch, card "
                      f"{passes[0]}, CPU {passes[1]}")
                if same.mean() < SERVE_ROWS_EQUAL or max(gaps) > 6:
                    problems.append(f"{spec_t.name}: card against CPU, "
                                    f"{same.mean():.3f} of rows equal")
                if any(p != 1 for p in passes[0]):
                    problems.append(f"{spec_t.name}: the card tiered the "
                                    f"queue ({passes[0]} passes)")
            print(f"  card against CPU: {equal_rows}/{total_rows} rows "
                  f"bitwise equal ({100 * equal_rows / total_rows:.2f}%) "
                  f"[{time.perf_counter() - t_phase:.1f} s]")

            # (b) the full studies on the card
            walls, claims, deltas, own = {}, [], {}, {}
            for scen, name in zip(scenarios, full):
                spec_t = fig_load_experiment(ex, scen, backend="torch")
                t0 = time.perf_counter()
                with recorded_sweeps(scan) as sweeps:
                    res = ex.run_experiment(spec_t, device=dev)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
                want = ex.ExperimentResult.from_dict(stored[name][1])
                bad, worst, own[name] = serving_checks(res, want, sweeps,
                                                       spec_t.N)
                if list(res.keys()) != list(stored[name][1]["reports"]):
                    problems.append(f"{name}: tasks {list(res.keys())}")
                deltas[name] = percentile_deltas(
                    res.to_dict()["reports"], stored[name][1]["reports"])
                checks = fig_load_validate(fig_load_rows(res))
                claims += checks
                print(f"  {name} on torch on the card ({len(spec_t.schemes)}"
                      f" tasks x {len(FIG_LOAD_LOADS)} loads x "
                      f"{spec_t.trials} trials, {spec_t.serving.slots} "
                      f"slots): against the stored numpy reports, t_comp "
                      f"worst {worst['t_comp']:.3f} SE, percentiles worst "
                      f"{worst['pct']:.3f} of their own SE "
                      f"({worst['pct_mean_se']:.3f} SE of the mean); "
                      f"units_admitted equal; {len(bad)} problems; "
                      f"validate {sum(ok for _, ok in checks)}/"
                      f"{len(checks)}")
                problems += [f"{name}: {p}" for p in bad]
            bad = [n for n, ok in claims if not ok]
            print(f"  fig_load.validate on torch: {len(claims) - len(bad)}/"
                  f"{len(claims)} passed [{time.perf_counter() - t_phase:.1f}"
                  f" s]")
            problems += [f"check failed: {n}" for n in bad]
            d_all = np.concatenate([deltas[n][0] for n in full])
            print(f"  torch minus numpy over the {len(d_all)} (scheme, "
                  f"load) rows: {sign_counts(d_all)}")

            # (a) the full numpy reruns and (b)'s witness, from the
            # background: the oracle at the next seed against the store
            numpy_walls = {}
            for name in full:
                got = from_background(name)
                reports, numpy_walls[name] = got["reports"], got["wall"]
                equal = reports == stored[name][1]["reports"]
                print(f"  store {stored[name][0][:12]} {name} (numpy, "
                      f"background): reports == the store: {equal}")
                if not equal:
                    diffs, _ = stored_field_diffs(reports,
                                                  stored[name][1]["reports"])
                    problems.append(f"{name}: {len(diffs)} fields differ, "
                                    f"first {diffs[:3]}")
                wit = from_background(f"{name}@witness")["reports"]
                dw, sew, tags = percentile_deltas(
                    wit, stored[name][1]["reports"])
                dt_, set_, _ = deltas[name]
                print(f"  {name}, percentiles against the store: numpy at "
                      f"seed {specs[name].seed + 1} (other arrivals) worst "
                      f"{worst_of(np.abs(dw) / sew[:, None], tags)} SE of "
                      f"the mean, {worst_of(np.abs(dw) / own[name], tags)}"
                      f" of their own; torch (the same arrivals) worst "
                      f"{worst_of(np.abs(dt_) / set_[:, None], tags)} and "
                      f"{worst_of(np.abs(dt_) / own[name], tags)}; numpy "
                      f"at seed {specs[name].seed + 1} minus the store: "
                      f"{sign_counts(dw)}")

            # (e) the CLI, from the background
            for demo in ("serving", "serving-trace"):
                proc = background[demo]
                out, err = proc.communicate(timeout=600)
                tail = out.strip().splitlines()[-1:] or [err.strip()]
                print(f"  python -m repro_torch.experiments --demo {demo} "
                      f"--check-cache: exit {proc.returncode}: {tail[0]}")
                if proc.returncode != 0 or "computed in" not in out \
                        or "check-cache: OK" not in out:
                    problems.append(f"--demo {demo}: {err.strip()[-300:]}")
        finally:
            for proc in background.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    for name in full:
        print(f"  {name} wall, one run of each beside the other's: torch on"
              f" the card {walls[name]:.3f} s ({card}), numpy on the host "
              f"{numpy_walls[name]:.3f} s (with the witness and the demos "
              f"in background processes)")

    # (d) times, with nothing else running: one dispatch a study on each
    # engine, warm (work_exchange: every load and trial)
    one = {}
    for scen, name in zip(scenarios, full):
        spec_t = fig_load_experiment(ex, scen, backend="torch")
        one[name] = {
            engine: serving_dispatch_wall(ex, spec_t, "work_exchange",
                                          engine, where)
            for engine, where in (("torch", dev), ("numpy", "cpu"))}
        print(f"  {name}, the work_exchange dispatch alone (warm, one run): "
              f"torch on the card {one[name]['torch']:.3f} s ({card}), "
              f"numpy on the host {one[name]['numpy']:.3f} s")
    # the queue tier, on and off, on the card and on the CPU (one run each
    # of the stationary study's fixed dispatch)
    spec_t = fig_load_experiment(ex, "stationary", backend="torch")
    tier = {}
    for where in (dev, torch.device("cpu")):
        for on in (True, False):
            scan._TIER_DEVICES = (where.type,) if on else ()
            try:
                tier[where.type, on] = serving_dispatch_wall(
                    ex, spec_t, "fixed", "torch", where)
            finally:
                scan._TIER_DEVICES = ("cpu",)
    print("  the queue tier, fig-load-stationary's fixed dispatch: "
          + "; ".join(f"{w} on {tier[w, True]:.3f} s, off "
                      f"{tier[w, False]:.3f} s" for w in ("cuda", "cpu"))
          + f" ({card}); the tier runs on {scan._TIER_DEVICES}")
    from torch.profiler import ProfilerActivity, profile
    spec_q = fig_load_experiment(ex, "stationary", True, backend="torch")
    het = spec_q.grid.specs()[0]
    with recorded_sweeps(scan) as sweeps, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scan.scan_sweep(het, "work_exchange", {}, spec_q.serving,
                        spec_q.N, spec_q.trials, spec_q.seed, 0,
                        device=dev)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    meta = sweeps[0][2]
    kern = device_rows(torch, prof)[0]
    launches = sum(e.count for e in kern)
    dev_us = sum(e.self_device_time_total for e in kern)
    steps = meta["S"] * meta["passes"]
    print(f"  profiled dispatch ({spec_q.name}, work_exchange, "
          f"{meta['passes']} pass x {meta['S']} slots): wall "
          f"{prof_wall:.3f} s, {launches} device kernels, "
          f"{launches / steps:.1f} a slot; "
          + (f"device busy {dev_us / 1e3:.3f} ms "
             f"({100 * dev_us / (prof_wall * 1e6):.2f}% of wall)"
             if dev_us > 0 else "the profiler recorded no device time "
             "(busy share not measured)"))
    if launches == 0:
        problems.append("the profiled dispatch launched nothing on the card")

    # one dispatch at 64 x the study's trials: the host draws its service
    # budgets (S x 4096 x K Poisson), then the same slot loop
    loop_s = []
    run_rows = scan._run_rows

    def timed_rows(*args, **kw):
        t = time.perf_counter()
        out = run_rows(*args, **kw)
        loop_s.append(time.perf_counter() - t)
        return out

    spec_t = fig_load_experiment(ex, "stationary", backend="torch")
    scan._run_rows = timed_rows
    try:
        t0 = time.perf_counter()
        big = scan.scan_sweep(het, "work_exchange", {}, spec_t.serving,
                              spec_t.N, SERVE_BIG_TRIALS, spec_t.seed, 0,
                              device=dev)
        torch.cuda.synchronize()
        big_s = time.perf_counter() - t0
    finally:
        scan._run_rows = run_rows
    rows = len(FIG_LOAD_LOADS) * SERVE_BIG_TRIALS
    finite = all(np.isfinite(r.t_comp) for r in big)
    print(f"  fig-load-stationary's work_exchange dispatch at {rows} rows "
          f"({SERVE_BIG_TRIALS} trials) on torch on the card: {big_s:.3f} s"
          f", {sum(loop_s):.3f} s of it in {len(loop_s)} slot loop, the "
          f"rest host draws and copies; at 64 rows "
          f"{one[full[0]]['torch']:.3f} s ({card}); finite {finite}")
    if not finite:
        problems.append("the 4096-row run gave non-finite reports")
    print(f"  phase 24 took {time.perf_counter() - t_phase:.1f} s")
    if problems:
        fail("serving: " + "; ".join(problems[:12]))


def live_band(got, want, got_trials: int, want_trials: int) -> tuple:
    """(|gap|, combined SE, within the band) of two reports' t_comp; the
    quarter is of ``want``'s t_comp."""
    se = float(np.hypot(got.t_comp_std / np.sqrt(got_trials),
                        want.t_comp_std / np.sqrt(want_trials)))
    gap = abs(got.t_comp - want.t_comp)
    return gap, se, gap < max(LIVE_BAND_SE * se,
                              LIVE_BAND_FRAC * want.t_comp)


def live_report_line(label: str, rep) -> str:
    cp = rep.extra["control_plane"]
    counters = cp["timeline"]["counters"]
    dev_ms = cp["payload_device_ms"]
    return (f"{label}: T_comp {rep.t_comp:.4f} +- {rep.t_comp_std:.4f}, "
            f"I {rep.iterations:.2f}, N_comm {rep.n_comm:.1f}; episode "
            f"wall {cp['episode_wall_s']:.4f} s, coordination_frac "
            f"{cp['coordination_frac']:.4f}; last episode's messages sent "
            f"{counters.get('messages_sent', 0)}, received "
            f"{counters.get('messages_received', 0)}, retries "
            f"{counters.get('rpc_retries', 0)}; lost {cp['workers_lost']}; "
            f"payload device "
            + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
            + " an episode")


def live_ledger_problems(tag: str, rep, N: int, exchange: bool) -> list:
    """A report's ledger: conserved, and on the exchange path every unit
    of every episode completed exactly once."""
    led = rep.extra["control_plane"]["ledger"]
    out = []
    if led["units_dispatched"] != (led["units_completed"]
                                   + led["units_reassigned"]):
        out.append(f"{tag}: ledger not conserved {led}")
    if exchange and led["units_completed"] != rep.trials * N:
        out.append(f"{tag}: {led['units_completed']} units completed, not "
                   f"{rep.trials} x {N}")
    return out


async def stuck_tcp_stop(get_transport) -> float:
    """Seconds a ``tcp`` listener takes to stop while one handler blocks
    for ever and another has returned, neither closing its comm."""
    import asyncio

    async def stuck(comm):
        await comm.recv()
        await asyncio.sleep(3600)

    async def leaves(comm):
        await comm.recv()

    tr = get_transport("tcp")
    took = 0.0
    for handler in (stuck, leaves):
        listener = tr.listen(handler)
        await listener.start()
        client = await tr.connect(listener.address)
        await client.send({"go": 1})
        await asyncio.sleep(0.05)
        t0 = time.perf_counter()
        await asyncio.wait_for(listener.stop(), 10 * LIVE_STOP_S)
        took = max(took, time.perf_counter() - t0)
        await client.close()
    return took


def live_phase(torch, dev) -> None:
    """Phase 25: the live control plane with its payload on the card --
    (a) the stored demo-live entry rerun, (b) the CLI's live demos, (c)
    the paper's scale over inproc, (d) over tcp and flaky tcp, (e) the
    payload alone under the sync debug mode, (f) the tcp stop repair."""
    import asyncio
    import tempfile

    import repro_torch.experiments as ex
    from repro_torch.control import (LiveConfig, MatmulPayload,
                                     get_transport, run_live)
    from repro_torch.control.coordinator import live_supported
    from repro_torch.core import HetSpec, get_scheme
    problems = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    print(f"live control plane: {smi.stdout.strip()}; numpy "
          f"{np.__version__}, torch {torch.__version__}, python "
          f"{sys.version.split()[0]}")
    t_phase = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    with tempfile.TemporaryDirectory() as tmp:
        # (b) in the background while (a) runs
        clis = {demo: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.experiments", "--demo", demo,
             "--store", str(Path(tmp) / demo), "--check-cache"], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for demo in ("live", "live-fault")}

        # (a) the stored entry, rerun on the card
        d = json.loads((ROOT / "results" / "store"
                        / f"{LIVE_ENTRY}.json").read_text())
        spec = ex.ExperimentSpec.from_dict(d["spec"])
        if spec.spec_hash() != LIVE_ENTRY:
            problems.append(f"demo-live hashes to {spec.spec_hash()[:12]}")
        want = ex.ExperimentResult.from_dict(d)
        t0 = time.perf_counter()
        result = ex.run_experiment(spec, store=ex.ResultsStore(
            Path(tmp) / "rerun"), device=dev)
        wall = time.perf_counter() - t0
        print(f"  (a) store {LIVE_ENTRY[:12]} demo-live (K {spec.grid.K}, N "
              f"{spec.N}, {spec.trials} trials, {spec.live.transport}) on "
              f"{result.env['device']}: {wall:.3f} s, cache hit "
              f"{result.cache_hit}, at its address "
              f"{result.spec_hash == LIVE_ENTRY}")
        if result.cache_hit or result.spec_hash != LIVE_ENTRY:
            problems.append("demo-live: not a fresh run at its address")
        for s in spec.schemes:
            key = s.report_key
            [rep], [ref] = result.report(key), want.report(key)
            gap, se, ok = live_band(rep, ref, rep.trials, ref.trials)
            print(f"    {live_report_line(key, rep)}; stored "
                  f"{ref.t_comp:.4f}, gap {gap:.4f} = {gap / se:.3f} SE, "
                  f"{gap / ref.t_comp:.4f} of it ({'ok' if ok else 'FAIL'})")
            if not ok:
                problems.append(f"demo-live {key}: t_comp {rep.t_comp:.4f} "
                                f"beyond the band of the stored "
                                f"{ref.t_comp:.4f}")
            if key in LIVE_STORED_N_COMM and (
                    rep.n_comm != LIVE_STORED_N_COMM[key]
                    or ref.n_comm != LIVE_STORED_N_COMM[key]):
                problems.append(f"demo-live {key}: n_comm {rep.n_comm}")
            if key == "fixed" and (rep.iterations != 1 or rep.n_comm != 0):
                problems.append(f"demo-live fixed: {rep.iterations} "
                                f"iterations, n_comm {rep.n_comm}")
            exchange = live_supported(get_scheme(
                s.scheme, **s.params_dict)) == "exchange"
            problems += live_ledger_problems(f"demo-live {key}", rep,
                                             spec.N, exchange)
            if rep.extra["control_plane"]["payload_backend"] != "torch":
                problems.append(f"demo-live {key}: not the torch payload")
        print("    every payload verified against a float64 product on the "
              "card (run_live raises otherwise)")

        for demo, proc in clis.items():
            out, err = proc.communicate(timeout=600)
            lines = out.strip().splitlines()
            ok = (proc.returncode == 0 and "computed in" in out
                  and "check-cache: OK" in out
                  and out.index("computed in") < out.index("check-cache: OK"))
            print(f"  (b) python -m repro_torch.experiments --demo {demo} "
                  f"--check-cache: exit {proc.returncode}; "
                  + (" | ".join(line.strip() for line in lines[3:-1])
                     if ok else err.strip()[-400:]))
            if not ok:
                problems.append(f"--demo {demo} failed")
                continue
            if demo == "live-fault":
                [h] = [p.stem for p in (Path(tmp) / demo).glob("*.json")]
                got = ex.ResultsStore(Path(tmp) / demo).get(h)
                lost = [r.extra["control_plane"]["workers_lost"]
                        for r in got.report("work_exchange")]
                print(f"      workers_lost {lost}")
                if lost != [[0]]:
                    problems.append(f"live-fault lost {lost}, not [[0]]")

    # (c) the paper's scale over inproc
    het = HetSpec.uniform_random(K_PAPER, LIVE_MU, LIVE_MU ** 2 / 6,
                                 np.random.default_rng(0))
    mc = {}
    for name in LIVE_FULL_SCHEMES:
        t0 = time.perf_counter()
        mc[name] = get_scheme(name).mc(het, N_PAPER, LIVE_MC_TRIALS,
                                       np.random.default_rng(0),
                                       backend="numpy", device=dev)
        mc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = run_live(name, {}, het, N_PAPER, LiveConfig(), LIVE_EPISODES,
                       seed=LIVE_SEED, device=dev)
        wall = time.perf_counter() - t0
        gap, se, ok = live_band(rep, mc[name], LIVE_EPISODES, LIVE_MC_TRIALS)
        label = f"{name} (K {K_PAPER}, N {N_PAPER}, inproc)"
        print(f"  (c) {live_report_line(label, rep)}; "
              f"numpy MC {mc[name].t_comp:.4f} +- {mc[name].t_comp_std:.4f} "
              f"({LIVE_MC_TRIALS} trials, {mc_s:.3f} s), gap {gap:.4f} = "
              f"{gap / se:.3f} SE, {gap / mc[name].t_comp:.4f} of it "
              f"({'ok' if ok else 'FAIL'}); {LIVE_EPISODES} episodes in "
              f"{wall:.3f} s")
        if not ok:
            problems.append(f"full-size {name}: t_comp {rep.t_comp:.4f} "
                            f"beyond the band of MC {mc[name].t_comp:.4f}")
        problems += live_ledger_problems(f"full-size {name}", rep, N_PAPER,
                                         True)

    # (d) over tcp and flaky tcp
    for label, cfg in (("tcp", LiveConfig(transport="tcp")),
                       ("flaky tcp", LiveConfig(
                           transport="flaky",
                           transport_params=LIVE_FLAKY))):
        t0 = time.perf_counter()
        rep = run_live("work_exchange", {}, het, N_PAPER, cfg, 1,
                       seed=LIVE_SEED, device=dev)
        wall = time.perf_counter() - t0
        gap, se, ok = live_band(rep, mc["work_exchange"], 1, LIVE_MC_TRIALS)
        print(f"  (d) {live_report_line(f'work_exchange over {label}', rep)}"
              f"; against MC {gap / mc['work_exchange'].t_comp:.4f} of it "
              f"(printed, not held); 1 episode in {wall:.3f} s")
        problems += live_ledger_problems(f"{label} work_exchange", rep,
                                         N_PAPER, True)
        retries = rep.extra["control_plane"]["timeline"]["counters"].get(
            "rpc_retries", 0)
        if label == "flaky tcp" and retries == 0:
            problems.append("flaky tcp: no rpc retried")

    # (e) the payload alone, no call allowed to wait for the device
    t0 = time.perf_counter()
    payload = MatmulPayload(N_PAPER, 4, 64, seed=LIVE_SEED, device=dev)
    draw_s = time.perf_counter() - t0
    per = N_PAPER // K_PAPER
    payload.warmup(per)
    rng = np.random.default_rng(5)
    queues = [rng.integers(0, N_PAPER, per).tolist()
              for _ in range(LIVE_PAYLOAD_CALLS)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for q in queues:
            payload.compute(q)
        host_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dev_ms = payload.device_ms()
    verified = payload.verify()
    calls = LIVE_PAYLOAD_CALLS
    print(f"  (e) payload alone: A {tuple(payload.A.shape)} float32 drawn "
          f"and copied in {draw_s:.3f} s; {calls} calls of {per} units "
          f"under sync debug mode 'error': host "
          f"{host_s * 1e3 / calls:.4f} ms a call, device "
          + ("not measured" if dev_ms is None
             else f"{dev_ms / calls:.4f} ms a call")
          + f", verified {verified}")
    if not verified:
        problems.append("the payload alone did not verify")
    del payload

    # (f) the tcp stop repair
    took = asyncio.run(stuck_tcp_stop(get_transport))
    print(f"  (f) tcp listener with handlers that never close their comms: "
          f"stop in {took:.6f} s")
    if took >= LIVE_STOP_S:
        problems.append(f"tcp stop took {took:.3f} s")
    print(f"  phase 25 took {time.perf_counter() - t_phase:.1f} s")
    if problems:
        fail("live control plane: " + "; ".join(problems[:12]))


@contextlib.contextmanager
def flash_tally(keep: bool = True):
    """Count the flash kernel's launches by shape while the block runs:
    {(B, Sq, Sk, Hq, Hkv, d, causal, window): launches}, and (``keep``)
    keep the first call's inputs of each shape.  The wrapper still counts
    its launches."""
    from repro_torch.kernels.flash_attention import ops
    fn = ops.flash_attention_cuda
    tally, first = {}, {}

    def wrapper(q, k, v, causal=True, window=0, scale=None):
        key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
               q.shape[3], bool(causal), int(window))
        tally[key] = tally.get(key, 0) + 1
        if keep:
            first.setdefault(key, (q, k, v, causal, window, scale))
        return fn(q, k, v, causal, window, scale)

    ops.flash_attention_cuda = wrapper
    try:
        yield tally, first
    finally:
        ops.flash_attention_cuda = fn


def kernel_dim(d: int) -> int:
    """The flash kernel's head dim a head of ``d`` is padded to."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    return next(h for h in HEAD_DIMS if h >= d)


def head_dims(cfg) -> tuple:
    """(q.k dim, v dim) of a config's attention heads."""
    if cfg.attn_kind == "mla":
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return cfg.hd, cfg.hd


def want_flash(cfg, B: int, S: int) -> dict:
    """The flash launches a generate of B requests of S prompt tokens
    (frames for the encoder-decoder) must make, by shape."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.family == "encdec":
        return {(B, S, S, H, Hkv, hd, False, 0): cfg.n_enc_layers,
                (B, 4, 4, H, Hkv, hd, True, 0): cfg.n_dec_layers,
                (B, 4, S, H, H, hd, False, 0): cfg.n_dec_layers}
    if cfg.slstm_every:
        return {}
    S += cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    if cfg.attn_kind == "mla":
        Hkv = H
    window = cfg.window if cfg.attn_kind == "swa" else 0
    return {(B, S, S, H, Hkv, kernel_dim(max(head_dims(cfg))), True,
             window): cfg.n_layers}


def attention_bound(B, Sq, Sk, Hq, Hkv, dq, dv, causal, window):
    """(bound ms, bound_by) of bf16 attention at head dims dq (q.k) and dv
    (v): q and k read at dq, v read and the output written at dv, once
    each; 2 flops a multiply-add over this shape's unmasked pairs."""
    pairs = attention_pairs(Sq, Sk, causal, window)
    flops = 2.0 * (dq + dv) * Hq * B * pairs
    nbytes = 2 * (B * Sq * Hq * (dq + dv) + B * Sk * Hkv * (dq + dv))
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes"


def zoo_flash_entry(torch, draw, path: str, launches: int, call,
                    dims, per: str = "a generate") -> tuple:
    """(ok, the kernels line's entry) for one flash shape of a served
    path: the path's first call at that shape replayed through the kernel
    and its plain version, held at ``FLASH_TOL`` and row by row at
    ``FLASH_ROW_REL_RMS`` over the v dims (most of these rows average
    hundreds of keys, whose outputs are no larger than ``FLASH_TOL``),
    then the same shape on N(0, 1) inputs from ``draw`` through
    ``check_flash``, which also shows that a softmax scale 1% off fails;
    and timed (warm minimum of 3) against the bound at the heads' own
    dims ``dims`` (q.k, v) and ``scaled_dot_product_attention`` at those
    dims (the padding removed: SDPA takes any head dims)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    q, k, v, causal, window, scale = call
    dq, dv = dims
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]

    def kernel():
        return flash_attention_cuda(q, k, v, causal, window, scale)

    def plain():
        return attention_ref(q, k, v, causal, window, scale)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = FLASH_TOL["bfloat16"]
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    want_v = want[..., :dv]
    worst = float(rel_rms(got[..., :dv], want_v, (2, 3)).max())
    out_rms = float(want_v.float().pow(2).mean().sqrt())
    row_rms = want_v.float().pow(2).mean((2, 3)).sqrt()
    off = float(rel_rms(attention_ref(
        q, k, v, causal, window, 1.01 * (d ** -0.5 if scale is None
                                         else scale))[..., :dv],
        want_v, (2, 3)).max())
    ok = ok and worst <= FLASH_ROW_REL_RMS
    print(f"  flash_attention on {path}, the path's own inputs: output RMS "
          f"{out_rms:.3e} (rows {float(row_rms.min()):.3e} to "
          f"{float(row_rms.max()):.3e}) against tol {tol}; worst row's "
          f"relative RMS {worst:.3e} (limit {FLASH_ROW_REL_RMS:.3e}; the "
          f"plain version with its scale 1% off reads {off:.3e})")
    del got, want, want_v
    synth_ok, _, _, synth = check_flash(
        torch, draw, (B, Sq, Sk, Hq, Hkv, d, causal, window, "bfloat16"),
        FLASH_ROW_REL_RMS)
    ok = ok and synth_ok
    del synth
    qt, kt = (x[..., :dq].transpose(1, 2) for x in (q, k))
    vt = v[..., :dv].transpose(1, 2)
    kw = dict(is_causal=causal)
    if window and window < Sk:
        pos = torch.arange(Sk, device=q.device)
        qpos = pos[Sk - Sq:]
        kw = dict(attn_mask=(pos[None, :] <= qpos[:, None])
                  & (pos[None, :] > qpos[:, None] - window))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=scale, enable_gqa=True, **kw)

    lib_err = float((sdpa().transpose(1, 2).float()
                     - plain()[..., :dv].float()).abs().max())
    ms, plain_ms, lib_ms = (cuda_ms(torch, fn) for fn in (kernel, plain,
                                                           sdpa))
    bound, by = attention_bound(B, Sq, Sk, Hq, Hkv, dq, dv, causal, window)
    pad = "" if (dq, dv) == (d, d) else f" (heads {dq}/{dv} padded to {d})"
    print(f"  flash_attention on {path}: {launches} launches {per} at "
          f"({B}, {Sq}, {Sk}, {Hq}/{k.shape[2]}, {d}){pad} causal={causal} "
          f"window={window}: {'ok' if ok else 'FAIL'} max_abs_err {err:.3e} "
          f"(tol {tol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"at {dq}/{dv} {lib_ms:.4f} ms (max |diff| {lib_err:.3e}), kernel "
          f"/ sdpa {ms / lib_ms:.3f}; bound at {dq}/{dv} {bound:.4f} ms by "
          f"{by} ({bound / ms:.3f} of it)")
    return ok, {
        "name": "flash_attention", "path": path, "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": REPLACES["flash_attention"], "launches": launches,
        "shape": [B, Sq, Sk, Hq, k.shape[2], d], "head_dims": [dq, dv],
        "causal": causal, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": lib_ms}


def depth_cut(cfg):
    """``cfg`` at full width and the depth of the decode check: 3 layers
    (3 + 3 for the encoder-decoder), one period (8) for xLSTM."""
    import dataclasses
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=ZOO_DEPTH,
                                   n_enc_layers=ZOO_DEPTH,
                                   n_dec_layers=ZOO_DEPTH)
    return dataclasses.replace(cfg, n_layers=cfg.slstm_every or ZOO_DEPTH)


def served_logits(torch, model, params, batch, s_max: int, steps: int):
    """Greedy generation as ``greedy_generate`` runs it, keeping each
    step's logits over the real vocabulary: (tokens (B, steps), logits
    (B, steps, V) float32)."""
    V = model.cfg.vocab_size
    B = batch["tokens"].shape[0]
    logits, cache = model.prefill(params, batch,
                                  model.init_cache(B, s_max, params[
                                      "embed"].device))
    toks, out = [], []
    for j in range(steps):
        if j:
            logits, cache = model.decode_step(params, cache, toks[-1])
        out.append(logits[:, -1, :V].float())
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
    return torch.cat(toks, 1), torch.stack(out, 1)


def teacher_forced(torch, model, params, batch, toks, s_max: int):
    """The logits (B, steps, V) float32 of one forward pass over the
    prompt and the generated tokens (the last one left out) on the kernel
    path: what each decode step's logits should be."""
    from repro_torch.models.encdec import decoder_hidden
    from repro_torch.models.transformer import lm_prefill_hidden
    cfg = model.cfg
    n0 = batch["tokens"].shape[1]
    full = dict(batch, tokens=torch.cat([batch["tokens"], toks[:, :-1]], 1))
    if cfg.family == "encdec":
        h = decoder_hidden(params, cfg, full)
    else:
        h, _ = lm_prefill_hidden(params, cfg, full, model.init_cache(
            toks.shape[0], s_max, params["embed"].device))
        if "image_embeds" in batch:
            h = h[:, batch["image_embeds"].shape[1]:]
    return (h[:, n0 - 1:] @ params["lm_head"])[..., :cfg.vocab_size].float()


def device_launches(torch, fn) -> int:
    """Device launches (kernels, copies, fills) one call of ``fn`` makes,
    from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in device_rows(torch, prof)[0])


def zoo_serve(torch, dev, draw, arch: str, check: bool) -> list:
    """Phase 26 for one architecture: (with ``check``) the decode held
    against the teacher-forced forward pass at the cut depth, then the
    full model served once with its flash launches counted by shape and
    design, timed, and each flash shape replayed; returns its kernels-line
    entries."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model
    from repro_torch.train.serve import greedy_generate
    from repro_torch.models.xlstm import MLSTM_CHUNK
    t_arch = time.perf_counter()
    cfg = get_config(arch)
    F = cfg.n_frontend_tokens
    s_max = ZOO_PROMPT + ZOO_STEPS + F
    if check:
        cut = depth_cut(cfg)
        model = build_model(cut)
        params = model.init(seed=0, device=dev)
        batch = prompt_batch(cut, ZOO_B, ZOO_PROMPT, dev)
        steps = MLSTM_CHUNK + 1 if cfg.slstm_every else ZOO_STEPS
        with torch.no_grad():
            toks, served = served_logits(torch, model, params, batch,
                                         s_max + steps, steps)
            forced = teacher_forced(torch, model, params, batch, toks,
                                    s_max + steps)
        step_rms = rel_rms(served, forced, (0, 2))
        agree = float((forced.argmax(-1) == toks).float().mean())
        print(f"  {arch} at depth {cut.n_layers}, {steps} tokens: decode "
              f"against the teacher-forced forward pass, relative RMS per "
              f"step: first "
              f"{float(step_rms[0]):.3e}, decode max "
              f"{float(step_rms[1:].max()):.3e} (limit {LOGIT_REL_RMS}); "
              f"greedy tokens agreeing {agree:.4f}")
        if not bool(torch.isfinite(served).all()):
            fail(f"{arch}: served logits are not finite")
        if float(step_rms.max()) > LOGIT_REL_RMS:
            fail(f"{arch}: decode differs from the teacher-forced forward "
                 f"pass: relative RMS {float(step_rms.max()):.3e}")
        del model, params, batch, toks, served, forced
        torch.cuda.empty_cache()

    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    n_params, n_bytes = describe_params(params)
    batch = prompt_batch(cfg, ZOO_B, ZOO_PROMPT, dev)
    print(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}: {n_params:.4e} parameters ({n_bytes / 1e9:.3f} "
          f"GB), drawn on the card in {init_s:.2f} s; init peak "
          f"{init_peak:.3f} GB")

    def generate():
        return greedy_generate(model, params, batch, model.init_cache(
            ZOO_B, s_max, dev), ZOO_STEPS)

    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    with torch.no_grad(), flash_tally() as (tally, first):
        t0 = time.perf_counter()
        toks, _ = generate()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCH_COUNTS.items() if v}
    tc = _build.DESIGN_COUNTS[("flash_attention", "tc")]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    want = want_flash(cfg, ZOO_B, ZOO_PROMPT)
    print(f"  {arch} served {ZOO_B} x {ZOO_PROMPT} + {ZOO_STEPS} in "
          f"{first_s:.3f} s (first run); launches {launches}, flash on tc "
          f"{tc}; flash by (B, Sq, Sk, Hq, Hkv, d, causal, window) {tally} "
          f"(want {want}); peak {peak:.3f} GB")
    if tally != want:
        fail(f"{arch}: flash launches by shape {tally} are not {want}")
    if launches != ({"flash_attention": sum(want.values())} if want
                    else {}) or tc != sum(want.values()):
        fail(f"{arch}: launches {launches}, {tc} on tc: want every flash "
             f"launch of {want} on tc and no other kernel")
    if tuple(toks.shape) != (ZOO_B, ZOO_STEPS) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        fail(f"{arch}: tokens of shape {tuple(toks.shape)} outside "
             f"[0, {cfg.vocab_size})")
    with torch.no_grad():
        t0 = time.perf_counter()
        model.prefill(params, batch, model.init_cache(ZOO_B, s_max, dev))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        generate()
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        decode_ms = (gen_s - prefill_s) / (ZOO_STEPS - 1) * 1e3
        n_prompt = ZOO_B * (ZOO_PROMPT + (F if cfg.frontend == "vision"
                                          else 0))
        print(f"  serve {arch} (warm, one run each): prefill "
              f"{prefill_s * 1e3:.3f} ms ({n_prompt / prefill_s:.1f} prompt "
              f"tok/s), decode {decode_ms:.3f} ms a step, generate "
              f"{gen_s * 1e3:.3f} ms ({ZOO_B * ZOO_STEPS / gen_s:.2f} new "
              f"tok/s); peak {peak:.3f} GB")
        if cfg.slstm_every:
            # the whole prompt's prefill, counted from the raw trace
            out = []
            n_pre = device_launches(torch, lambda: out.append(model.prefill(
                params, batch, model.init_cache(ZOO_B, s_max, dev))))
            _, cache = out.pop()
            tok = toks[:, :1]
            n_dec = device_launches(torch, lambda: model.decode_step(
                params, cache, tok))
            n_sl = cfg.layer_kinds().count("slstm")
            print(f"  {arch} device launches (kernels, copies, fills): a "
                  f"decode step {n_dec}; a prefill of {ZOO_PROMPT} tokens "
                  f"{n_pre}: {n_pre / ZOO_PROMPT:.2f} a token "
                  f"({n_pre / (n_sl * ZOO_PROMPT):.2f} a token a sLSTM "
                  f"layer, the mLSTM chunks included)")
            del cache
    entries = []
    failed = []
    for key, call in sorted(first.items()):
        B, Sq, Sk, Hq, Hkv, d, causal, window = key
        role = ("encoder" if Sq == Sk and not causal else
                "cross" if not causal else
                "decoder" if cfg.family == "encdec" else "prefill")
        dims = head_dims(cfg) if cfg.family != "encdec" else (d, d)
        ok, entry = zoo_flash_entry(torch, draw, f"{arch} {role}",
                                    tally[key], call, dims)
        entries.append(entry)
        if not ok:
            failed.append(f"{arch} {role}")
    if failed:
        fail("flash at the zoo's shapes against plain: " + "; ".join(failed))
    del model, params, batch, first, toks
    torch.cuda.empty_cache()
    print(f"  {arch} took {time.perf_counter() - t_arch:.1f} s")
    return entries


def zoo_phase(torch, dev) -> list:
    """Phase 26; returns the new flash entries of the kernels line."""
    t_phase = time.perf_counter()
    print("phase 26: the rest of the model zoo served at full width")
    gen = torch.Generator(device=dev).manual_seed(26)

    def draw(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    entries = []
    for arch in ZOO_ARCHS:
        entries += zoo_serve(torch, dev, draw, arch, check=True)
    for arch in ZOO_DENSE:
        entries += zoo_serve(torch, dev, draw, arch, check=False)
    print(f"  phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return entries


TRAIN_LINE = re.compile(r"\[train\] step (\d+): loss=(\S+) T_virtual=(\S+)s "
                        r"I=(\d+) moved=(\d+)")


@contextlib.contextmanager
def card_memory_peak():
    """Sample the card's ``memory.used`` (MiB, every process on it) every
    0.25 s while the block runs; yields a one-element list holding the
    peak so far.  Fails after the block if a reading failed or none was
    read."""
    import threading
    peak, reads, errors = [0], [0], []
    done = threading.Event()

    def sample():
        try:
            while not done.is_set():
                r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                    "--format=csv,noheader,nounits", "-i",
                                    "0"], capture_output=True, text=True,
                                   timeout=30)
                if r.returncode != 0 or not r.stdout.strip():
                    raise RuntimeError(f"nvidia-smi exited {r.returncode}: "
                                       f"{r.stderr.strip()}")
                peak[0] = max(peak[0], int(r.stdout.strip()))
                reads[0] += 1
                done.wait(0.25)
        except Exception as e:            # handed to the main thread
            errors.append(e)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        yield peak
    finally:
        done.set()
        sampler.join()
    if errors or not reads[0]:
        fail(f"the card's memory.used was not read: {reads[0]} readings, "
             f"{errors!r}")


def run_launchers(chains: list) -> dict:
    """Run ``python -u -m repro_torch.launch.train *args`` for each
    (label, args) of each chain: the chains at once, a chain's runs one
    after another (a run starts when the one before it ends), each its
    own process on the card (the launcher is host-bound: one host thread
    each), each output line stamped as it arrives.  Returns {label:
    ({step: (loss, T_virtual, I, moved)}, stdout)}, and the card's
    ``memory.used`` peak over them under the key ``"peak"``.  A step's wall is the time between its ``[train]`` line
    and the line before it (the banner or the resume line for the first
    step), printed with the runs that shared the host with it."""
    import threading
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    # the host's cores shared out among the chains' CPU thread pools
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // len(chains)))
    out, spans, running = {}, {}, {}

    def pump(stream, sink):
        for line in stream:
            sink.append((time.perf_counter(), line))

    def start(chain: list) -> None:
        label, args = chain.pop(0)
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "repro_torch.launch.train", *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        lines, errs = [], []
        pumps = [threading.Thread(target=pump, args=(stream, sink),
                                  daemon=True)
                 for stream, sink in ((proc.stdout, lines),
                                      (proc.stderr, errs))]
        for t in pumps:
            t.start()
        spans[label] = [time.perf_counter(), None]
        running[label] = (proc, lines, errs, pumps, chain)

    def kill_all():
        for proc, *_ in running.values():
            proc.kill()

    def finish(label: str) -> None:
        proc, lines, errs, pumps, chain = running.pop(label)
        for t in pumps:
            t.join()
        spans[label][1] = time.perf_counter()
        begin, end = spans[label]
        stdout = "".join(line for _, line in lines)
        print(f"  launcher {label}: rc {proc.returncode}, {end - begin:.1f} "
              f"s, done {end - t0:.1f} s after the phase's first start")
        for line in stdout.strip().splitlines():
            print(f"    {line}")
        if proc.returncode != 0:
            kill_all()
            stderr = "".join(line for _, line in errs)
            fail(f"launcher {label} exited {proc.returncode}: "
                 f"{stderr.strip()[-2000:]}")
        beside = [other for other, (b, e) in spans.items() if other != label
                  and b < end and (e is None or e > begin)]
        walls = {int(m[1]): at - lines[i - 1][0]
                 for i, (at, line) in enumerate(lines)
                 if (m := TRAIN_LINE.match(line)) and i}
        print(f"  launcher {label}, "
              + (f"beside {', '.join(beside)}" if beside
                 else "alone on the host")
              + ": step walls "
              + ", ".join(f"{s} {w:.3f} s" for s, w in walls.items()))
        out[label] = ({int(m[1]): m.groups()[1:]
                       for m in TRAIN_LINE.finditer(stdout)}, stdout)
        if chain:
            start(chain)

    with card_memory_peak() as peak:
        t0 = time.perf_counter()
        for chain in chains:
            start(list(chain))
        while running:
            for label in [k for k, v in running.items()
                          if v[0].poll() is not None]:
                finish(label)
            if time.perf_counter() - t0 > 900:
                kill_all()
                fail(f"launchers {sorted(running)} ran past 900 s")
            time.sleep(0.05)
    out["peak"] = peak[0]
    print(f"  card memory.used peak over these runs {peak[0]} MiB")
    return out


def npz_digests(path: Path, threads: int = 4) -> list:
    """SHA-256 of each leaf of a checkpoint's ``arrays.npz``, a0 first;
    ``threads`` readers, each with its own handle on the file (reading
    and hashing release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    with np.load(path / "arrays.npz") as data:
        n = len(data.files)

    def part(first: int) -> dict:
        with np.load(path / "arrays.npz") as data:
            return {i: hashlib.sha256(data[f"a{i}"].tobytes()).hexdigest()
                    for i in range(first, n, threads)}

    out = {}
    with ThreadPoolExecutor(threads) as pool:
        for got in pool.map(part, range(threads)):
            out.update(got)
    return [out[i] for i in range(n)]


def launcher_phase(torch, dev) -> None:
    """Phase 27: the training launcher (``python -m
    repro_torch.launch.train``) on the card in subprocesses: the reduced
    default, xlstm-350m at full width under ``work_exchange`` straight,
    and the same stopped after 2 steps and then resumed from its
    checkpoint: three chains at once, the resumed run starting when the
    stopped one ends."""
    import shutil
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor
    t_phase = time.perf_counter()
    print("phase 27: the training launcher")
    torch.cuda.empty_cache()
    total = subprocess.run(["nvidia-smi", "--query-gpu=memory.total",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
    total_mib = int(total.stdout.strip())
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_launch_"))
    last = f"step_{LAUNCH_STEPS - 1:08d}"
    default = "default (phi4-mini smoke, float32)"
    straight_l = "xlstm-350m straight"
    first_l = f"xlstm-350m, {LAUNCH_FIRST} steps"
    resumed_l = "xlstm-350m, resumed"
    ended = threading.Event()

    def when_saved(ckpt: Path) -> list:
        """The digests of ``ckpt`` once the launcher has renamed it into
        place (a checkpoint appears whole); [] if the runs end first."""
        while not ckpt.exists():
            if ended.wait(0.5) and not ckpt.exists():
                return []
        return npz_digests(ckpt)

    try:
        with ThreadPoolExecutor(1) as pool:
            # the straight run's checkpoint is hashed while the resumed
            # run goes on
            want = pool.submit(when_saved, tmp / "a" / last)
            try:
                runs = run_launchers([
                    [(default, ["--steps", str(LAUNCH_STEPS)])],
                    [(straight_l, [*LAUNCH_XLSTM, "--steps",
                                   str(LAUNCH_STEPS), "--ckpt",
                                   str(tmp / "a")])],
                    [(first_l, [*LAUNCH_XLSTM, "--steps", str(LAUNCH_FIRST),
                                "--ckpt", str(tmp / "b")]),
                     (resumed_l, [*LAUNCH_XLSTM, "--steps",
                                  str(LAUNCH_STEPS), "--ckpt",
                                  str(tmp / "b")])]])
            finally:
                ended.set()
            got = npz_digests(tmp / "b" / last)
            want = want.result()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = runs[default][0]
    if sorted(steps) != list(range(LAUNCH_STEPS)) or not all(
            np.isfinite(float(v[0])) for v in steps.values()):
        fail(f"the default launcher run printed steps {steps}")
    straight = runs[straight_l][0]
    losses = [float(straight[s][0]) for s in sorted(straight)]
    if sorted(straight) != list(range(LAUNCH_STEPS)) or not all(
            np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"xlstm-350m straight: losses {losses} (want {LAUNCH_STEPS} "
             f"finite, the last below the first)")
    if "[train] resumed from" not in runs[resumed_l][1]:
        fail("the second xlstm-350m run did not resume")
    joined = {**runs[first_l][0], **runs[resumed_l][0]}
    sched = all(joined.get(s, (None,))[1:] == straight[s][1:]
                for s in straight)
    same_loss = all(joined.get(s, (None,))[0] == straight[s][0]
                    for s in straight)
    equal = sum(a == b for a, b in zip(got, want))
    print(f"  resumed against straight: {equal} of {len(want)} checkpoint "
          f"leaves (params, then AdamW's step, mu, nu, master) SHA-256 "
          f"equal after step {LAUNCH_STEPS - 1}; T_virtual, I and moved "
          f"{'equal' if sched else 'DIFFER'} at every step; printed losses "
          f"{'equal' if same_loss else 'differ'}; card memory.used peak "
          f"{runs['peak']} MiB of {total_mib}")
    if equal != len(want) or len(got) != len(want):
        fail("the resumed run's parameters are not the straight run's")
    if not sched or sorted(joined) != sorted(straight):
        fail(f"the resumed run's schedule {joined} is not the straight "
             f"run's {straight}")
    if runs["peak"] >= total_mib:
        fail("the launcher runs filled the card")
    print(f"  phase 27 took {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def gmm_tally():
    """Count ``expert_matmul``'s launches by operand shape while the block
    runs: {(E, C, D, F): launches}.  The wrapper still counts them."""
    from repro_torch.kernels.moe_gmm import ops
    fn = ops.expert_matmul_cuda
    tally = {}

    def wrapper(buf, w):
        key = (*buf.shape, w.shape[2])
        tally[key] = tally.get(key, 0) + 1
        return fn(buf, w)

    ops.expert_matmul_cuda = wrapper
    try:
        yield tally
    finally:
        ops.expert_matmul_cuda = fn


def a2a_emulated(torch, p, cfg, x, tp: int, matmul):
    """``moe_apply_a2a`` of ``tp`` model ranks (data 1) in one process:
    each rank's sequence block of x (B, S, D) routed with its own capacity
    ``c_send``, the two exchanges done by indexing, each owner's experts
    through ``matmul``.  Returns (out (B, S, D), aux, dropped pairs)."""
    import torch.nn.functional as F
    from repro_torch.models.moe import _local_rank_in_expert
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    E_pad = -(-E // tp) * tp
    E_loc = E_pad // tp
    routes, mes, ces = [], [], []
    for xb in x.reshape(B, tp, S // tp, D).unbind(1):
        t = xb.shape[0] * xb.shape[1]
        xf = xb.reshape(t, D)
        logits = F.pad(xf.float() @ p["router"], (0, E_pad - E),
                       value=-1e30)
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.topk(probs, K, dim=-1)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        mes.append(probs[:, :E].mean(0))
        ces.append(F.one_hot(top_e[:, 0], E_pad)[:, :E].float().mean(0))
        c_send = max(4, -(-int(t * K * cfg.capacity_factor / E_pad) // 4) * 4)
        ranks = _local_rank_in_expert(top_e.reshape(-1), E_pad)
        keep = ranks < c_send
        slot = torch.where(keep, top_e.reshape(-1) * c_send + ranks,
                           E_pad * c_send)
        send = torch.zeros((E_pad * c_send + 1, D), dtype=x.dtype,
                           device=x.device)
        send.index_copy_(0, slot, xf.repeat_interleave(K, dim=0))
        routes.append((top_p, slot, keep, send[:-1].reshape(
            tp, E_loc * c_send, D), t))
    me, ce = torch.stack(mes).mean(0), torch.stack(ces).mean(0)
    aux = E * torch.sum(me * ce)
    back = [[None] * tp for _ in range(tp)]
    for r in range(tp):                        # expert owner r
        recv = torch.stack([routes[j][3][r] for j in range(tp)])
        buf = recv.reshape(tp, E_loc, c_send, D).transpose(0, 1) \
            .reshape(E_loc, tp * c_send, D)
        wg, wu, wo = (p[k][r * E_loc:(r + 1) * E_loc]
                      for k in ("wi_gate", "wi_up", "wo"))
        ob = matmul(F.silu(matmul(buf, wg)) * matmul(buf, wu), wo)
        ob = ob.reshape(E_loc, tp, c_send, D)
        for j in range(tp):
            back[j][r] = ob[:, j].reshape(E_loc * c_send, D)
    outs = []
    for j, (top_p, slot, keep, _, t) in enumerate(routes):
        out_flat = torch.cat(back[j], 0)
        gathered = torch.where(
            keep[:, None], out_flat[slot.clamp_max(E_pad * c_send - 1)], 0.0)
        out = (gathered * top_p.reshape(-1, 1).to(x.dtype)).reshape(
            t, K, D).sum(dim=1)
        outs.append(out.reshape(B, S // tp, D))
    dropped = sum(int((~keep).sum()) for _, _, keep, _, _ in routes)
    return torch.cat(outs, 1), aux, dropped


def mesh_layer_weights(torch, dev, cfg, kind: str):
    """One full-width layer's weights (``kind`` "moe" or "attn"), drawn on
    ``dev`` from seed 29, the same on every rank."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    gen = torch.Generator(device=dev).manual_seed(29)
    init = moe_mod.moe_init if kind == "moe" else attn_mod.gqa_init
    return init(gen, cfg, torch.bfloat16, dev)


def mesh_input(torch, dev, D: int):
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randn((MESH_B, MESH_PROMPT, D), generator=gen, device=dev,
                       dtype=torch.float32).to(torch.bfloat16)


def mesh_moe_layer(torch, dev, mesh, cfg) -> dict:
    """29 (a) on a rank of the (1, tp) mesh: one MoE layer through
    ``moe_apply_a2a`` (``expert_matmul`` on this rank's experts) on this
    rank's sequence block, gathered; on rank 0 also the plain
    single-process emulation on the same blocks."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import expert_matmul_ref
    from repro_torch.models import moe as moe_mod
    tp = shd.mesh_shape(mesh)["model"]
    p = mesh_layer_weights(torch, dev, cfg, "moe")
    x = mesh_input(torch, dev, cfg.d_model)
    specs = shd.param_specs(cfg, {"mlp": p}, tp, fsdp=False)["mlp"]
    local = {k: shd.local_block(v, specs[k], mesh).contiguous()
             for k, v in p.items()}
    _build.reset_launch_counts()
    with torch.no_grad(), shd.use_mesh(mesh):
        x_loc = shd.maybe_shard(x, None, "model", None).contiguous()
        out, aux = moe_mod.moe_apply_a2a(local, cfg, x_loc)
        keep = moe_mod.route_local(local, cfg, x_loc)[2]
        dropped = int(coll.all_reduce((~keep).sum(), "model"))
        out = coll.all_gather(out, "model", dim=1)
    torch.cuda.synchronize()
    rec = {"a_launches": _build.LAUNCH_COUNTS["expert_matmul"],
           "a_tc": _build.DESIGN_COUNTS[("expert_matmul", "tc")],
           "a_aux": float(aux), "a_dropped": dropped,
           "a_pairs": x.shape[0] * x.shape[1] * cfg.experts_per_token}
    if shd.axis_index("model") == 0:
        with torch.no_grad():
            want, aux_p, dropped_p = a2a_emulated(torch, p, cfg, x, tp,
                                                  expert_matmul_ref)
        rec.update(a_rms=rel_rms(out, want), a_aux_plain=float(aux_p),
                   a_dropped_plain=dropped_p,
                   a_finite=bool(torch.isfinite(out).all()))
    return rec


def mesh_attention_layer(torch, dev, mesh, cfg) -> dict:
    """29 (b) on a rank: one tensor-parallel GQA layer on the prefill's
    sequence-parallel pattern (this rank's sequence block all-gathered,
    its heads, the output reduce-scattered), gathered on every rank and
    held against the layer unsharded (rank 0)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import attention as attn_mod
    tp = shd.mesh_shape(mesh)["model"]
    p = mesh_layer_weights(torch, dev, cfg, "attn")
    x = mesh_input(torch, dev, cfg.d_model)
    specs = shd.param_specs(cfg, {"attn": p}, tp, fsdp=False)["attn"]
    local = {k: shd.local_block(v, specs[k], mesh).contiguous()
             for k, v in p.items()}
    with torch.no_grad(), shd.use_mesh(mesh):
        xg = coll.all_gather(shd.maybe_shard(x, None, "model", None), "model",
                             dim=1)
        y = coll.reduce_scatter(attn_mod.gqa_forward(local, cfg, xg),
                                "model", dim=1)
        got = coll.all_gather(y, "model", dim=1)
    rec = {}
    if shd.axis_index("model") == 0:
        with torch.no_grad(), shd.use_mesh(None):
            want = attn_mod.gqa_forward(p, cfg, x)
        tol = FLASH_TOL["bfloat16"]
        rec.update(
            b_err=float((got.float() - want.float()).abs().max()),
            b_close=bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                        atol=tol)),
            b_worst_row=float(rel_rms(got, want, (2,)).max()),
            b_out_rms=float(want.float().pow(2).mean().sqrt()))
    return rec


@contextlib.contextmanager
def routes_seen(torch):
    """Record each MoE layer call's ``(slot, keep, C)`` as the model
    runs (no launch); ``seen_experts`` turns them into (T, K) experts."""
    from repro_torch.models import moe as moe_mod
    route, seen = moe_mod.route, []

    def recording(p, cfg, x):
        out = route(p, cfg, x)
        seen.append(out[1:4])
        return out

    moe_mod.route = recording
    try:
        yield seen
    finally:
        moe_mod.route = route


def seen_experts(torch, seen, K: int) -> list:
    """The (T, K) experts of each recorded call (-1 where a pair
    dropped)."""
    return [torch.where(keep, slot // C, -1).reshape(-1, K)
            for slot, keep, C in seen]


@contextlib.contextmanager
def routes_replayed(torch, top_es):
    """Route each MoE layer call to the next of ``top_es`` (T, K) experts
    instead of its own top k: weights from its own float32 router (the
    replayed experts' probabilities, renormalised), slots in token order
    under its capacity, as ``moe.route`` makes them.  Yields the list of
    each call's ``(router logits (T, E), replayed experts)``."""
    from repro_torch.models import moe as moe_mod
    route, it, calls = moe_mod.route, iter(top_es), []

    def replayed(p, cfg, x):
        top_e = next(it)
        E = cfg.n_experts
        xf = x.reshape(-1, x.shape[-1])
        logits = xf.float() @ p["router"]
        calls.append((logits, top_e))
        probs = torch.softmax(logits, dim=-1)
        top_p = probs.gather(1, top_e)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        C = moe_mod._capacity(xf.shape[0], cfg)
        ranks = moe_mod._local_rank_in_expert(top_e.reshape(-1), E)
        keep = ranks < C
        slot = torch.where(keep, top_e.reshape(-1) * C + ranks, E * C)
        aux = E * torch.sum(probs.mean(0) * torch.nn.functional.one_hot(
            top_e[:, 0], E).float().mean(0))
        return top_p, slot, keep, C, aux

    moe_mod.route = replayed
    try:
        yield calls
    finally:
        moe_mod.route = route


def route_ties(torch, calls, K: int) -> dict:
    """How near the replayed experts are to the forced pass's own choice:
    over every (token, k) pair of ``routes_replayed``'s calls, the share
    its own router ranks below its top k ("flipped"), the worst such rank
    (1-based), and the largest gap from its k-th logit down to a flipped
    expert's; beside them the median gap between its k-th and (k+1)-th
    logits, the spacing a rounding has to bridge."""
    ranks, gaps, spacing = [], [], []
    for logits, top_e in calls:
        srt, order = torch.sort(logits, dim=-1, descending=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(logits.shape[1], device=logits.device)
            .expand_as(order))
        ranks.append(rank.gather(1, top_e).flatten())
        gaps.append((srt[:, K - 1:K] - logits.gather(1, top_e)).flatten())
        spacing.append(srt[:, K - 1] - srt[:, K])
    rank, gap = torch.cat(ranks), torch.cat(gaps)
    flipped = rank >= K
    return {"tie_flips": float(flipped.float().mean()),
            "tie_worst_rank": int(rank.max()) + 1,
            "tie_max_gap": float(gap[flipped].max()) if bool(flipped.any())
            else 0.0,
            "tie_spacing": float(torch.cat(spacing).median())}


def forced_chunk(torch, model, params, cache, toks, P0: int):
    """The logits (B, n, V) float32 of one pass over ``toks`` (B, n) at
    positions P0.., teacher-forced behind the prompt's cache (its first
    P0 slots, which the decode steps never write): each layer's queries of
    the n tokens attend over the cached keys and their own in one flash
    launch (right-aligned, causal), and the MoE runs on the scatter path
    at a capacity that drops nothing, as a decode step's does.  What the
    decode steps' logits should be."""
    import dataclasses
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf_mod
    from repro_torch.models.common import rmsnorm
    cfg = model.cfg
    nodrop = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    B, n = toks.shape
    h = tf_mod._embed_tokens(params, cfg, {"tokens": toks})
    pos = torch.arange(P0, P0 + n, device=toks.device)[None]
    for j in range(cfg.n_layers):
        p, c = tf_mod._index(params["body"]["b0"], j), cache["body"]["b0"][j]
        q, k, v = attn_mod._project_qkv(p["attn"], cfg, rmsnorm(
            h, p["ln1"], cfg.norm_eps), pos)
        k = torch.cat([c["k"][:, :P0], k], 1)
        v = torch.cat([c["v"][:, :P0], v], 1)
        ctx = attn_mod.attention_ctx(
            q, *attn_mod._kv_of_local_q(cfg, q.shape[2], k, v),
            cfg.hd ** -0.5, q_offset=P0)
        h = h + tf_mod._tp_out(ctx.reshape(B, n, -1) @ p["attn"]["wo"],
                               False)
        h = h + moe_mod.moe_apply_scatter(
            p["mlp"], nodrop, rmsnorm(h, p["ln2"], cfg.norm_eps))[0]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return tf_mod._logits(params, cfg, h)[..., :cfg.vocab_size].float()


def decode_against_forced(torch, model, params, local, s_max: int) -> dict:
    """Prefill ``local`` and decode MESH_STEPS - 1 greedy tokens through
    the step factories (their walls, warm: the prefill's and the decode
    steps'), keeping each step's logits and each MoE layer's routing;
    then ``forced_chunk`` over the fed tokens twice: routing for itself
    (printed: the share of (token, k) pairs it routes to other experts
    than the decode did, and its relative RMS), and with the decode's
    routing replayed (held at ``LOGIT_REL_RMS`` a step): a near-tied
    top-k choice that one bf16 rounding flips is another computation, not
    a decode error (as in phase 17).  That every replayed expert is such
    a near tie is held by ``route_ties`` (``MESH_TIE_LOGIT_GAP``)."""
    from repro_torch.train.serve import make_decode_step, make_prefill_step
    cfg = model.cfg
    L, K, V = cfg.n_layers, cfg.experts_per_token, cfg.vocab_size
    cache = model.init_cache(MESH_B, s_max, local["tokens"].device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(model)(params, local, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode = make_decode_step(model)
    served, fed = [], []
    tok = logits[:, -1].argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    with routes_seen(torch) as seen:
        for _ in range(MESH_STEPS - 1):
            fed.append(tok)
            logits, cache = decode(params, cache, tok)
            served.append(logits[:, -1, :V].float())
            tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    seen = seen_experts(torch, seen, K)
    served, fed = torch.stack(served, 1), torch.cat(fed, 1)
    B, n = fed.shape
    # the decode's experts of each layer, in the forced pass's token order
    decoded = [torch.stack([seen[s * L + j] for s in range(n)], 1)
               .reshape(B * n, K) for j in range(L)]
    with routes_seen(torch) as own:
        free = forced_chunk(torch, model, params, cache, fed, MESH_PROMPT)
    own = seen_experts(torch, own, K)
    with routes_replayed(torch, decoded) as calls:
        forced = forced_chunk(torch, model, params, cache, fed, MESH_PROMPT)
    flips = sum(int((torch.sort(a, 1)[0] != torch.sort(b, 1)[0]).sum())
                for a, b in zip(own, decoded)) / (L * B * n * K)
    return {"prefill_s": prefill_s, "gen_s": prefill_s + decode_s,
            "step_rms": rel_rms(served, forced, (0, 2)).cpu(),
            "free_rms": rel_rms(served, free, (0, 2)).cpu(),
            "routed_differently": flips,
            "dropped_in_decode": sum(int((e < 0).sum()) for e in decoded),
            **route_ties(torch, calls, K),
            "forced_agree": float((forced.argmax(-1)[:, :-1]
                                   == fed[:, 1:]).float().mean()),
            "served_finite": bool(torch.isfinite(served).all())}


def mesh_serve(torch, dev, mesh, cfg, out: str) -> dict:
    """29 (c) on a rank: ``cfg`` served with the sharded init through
    ``greedy_generate`` under the mesh; launches (zeroed just before the
    counted generate, read just after) by kernel, design and shape, the
    collectives of a generate, memory, one profiled generate, then the
    step factories' warm walls and the decode held against
    ``forced_chunk``.  Rank 0 keeps the first
    flash call's inputs in ``out`` for the kernel line."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model
    from repro_torch.train.serve import greedy_generate
    model = build_model(cfg)
    s_max = MESH_PROMPT + MESH_STEPS
    rec = {}
    with torch.no_grad(), shd.use_mesh(mesh):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=dev)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["init_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        rec["param_gb"] = describe_params(params)[1] / 1e9
        batch = prompt_batch(cfg, MESH_B, MESH_PROMPT, dev)

        def generate():
            return greedy_generate(model, params, batch, model.init_cache(
                MESH_B, s_max, dev), MESH_STEPS)

        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        coll.reset_counts()
        with flash_tally() as (ftally, first), gmm_tally() as gtally:
            t0 = time.perf_counter()
            toks, _ = generate()
            torch.cuda.synchronize()
            rec["first_s"] = time.perf_counter() - t0
        rec.update(
            launches={k: v for k, v in _build.LAUNCH_COUNTS.items() if v},
            designs={f"{k}/{d}": v for (k, d), v in
                     _build.DESIGN_COUNTS.items() if v},
            flash_shapes=dict(ftally), gmm_shapes=dict(gtally),
            collectives=coll.counts(), toks=toks.cpu(),
            gen_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        if shd.axis_index("model") == 0 and first:
            (key, call), = first.items()
            torch.save({"key": key, "call": tuple(
                t.cpu() if isinstance(t, torch.Tensor) else t
                for t in call)}, os.path.join(out, "flash-call.pt"))
        del first
        # one profiled generate: the device's busy share and NCCL's share
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate()
            torch.cuda.synchronize()
            rec["prof_wall_s"] = time.perf_counter() - t0
        events = [e for e in device_rows(torch, prof)[0]
                  if e.self_device_time_total > 0]
        rec["busy_ms"] = sum(e.self_device_time_total for e in events) / 1e3
        rec["nccl_ms"] = sum(e.self_device_time_total for e in events
                             if "nccl" in e.key.lower()) / 1e3
        # the warm walls, and the decode against the teacher-forced
        # continuation
        rec.update(decode_against_forced(torch, model, params,
                                         shd.shard_batch(batch), s_max))
        del params
    torch.cuda.empty_cache()
    return rec


def mesh_rank(rank: int, out: str, tp: int, depth: int) -> None:
    """Phase 29's body on one rank of a (1, tp) NCCL mesh, card ``rank``:
    (a) and (b) where tp > 1, then (c); its record goes to ``out``."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, resolve_for_tp
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device("cuda", rank) if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    mesh = make_host_mesh(model=tp)
    cfg = resolve_for_tp(get_config(MESH_ARCH), tp)
    rec = {"card": torch.cuda.get_device_name(dev)}
    if tp > 1:
        t0 = time.perf_counter()
        rec.update(mesh_moe_layer(torch, dev, mesh, cfg))
        rec.update(mesh_attention_layer(torch, dev, mesh, cfg))
        rec["ab_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.perf_counter()
    rec.update(mesh_serve(torch, dev, mesh, cfg, out))
    rec["c_s"] = time.perf_counter() - t0
    torch.save(rec, os.path.join(out, f"mesh-r{rank}.pt"))


def gmm_entry(torch, dev, path: str, shape, launches: int,
              per: str = "a generate a rank") -> dict:
    """The kernels line's entry for ``expert_matmul`` at one (E, C, D, F)
    shape of a path, on N(0, 1) operands (weights scaled by D^-1/2): the
    kernel against its plain version (``GMM_TOL``), every launch on
    ``tc``, timed against its bound, the plain version and
    ``torch.bmm``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import (expert_matmul_cuda,
                                             expert_matmul_ref)
    E, C, D, F = shape
    gen = torch.Generator(device=dev).manual_seed(29)
    buf = torch.randn((E, C, D), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((E, D, F), generator=gen, device=dev)
         * D ** -0.5).to(torch.bfloat16)
    before = _build.DESIGN_COUNTS[("expert_matmul", "tc")]
    got = expert_matmul_cuda(buf, w)
    took = _build.DESIGN_COUNTS[("expert_matmul", "tc")] - before
    want = expert_matmul_ref(buf, w)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = GMM_TOL["bfloat16"]
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                             atol=tol)) and took == 1
    ms, plain_ms, lib_ms = (cuda_ms(torch, fn) for fn in (
        lambda: expert_matmul_cuda(buf, w), lambda: expert_matmul_ref(buf, w),
        lambda: torch.bmm(buf, w)))
    bound, by, flops, _ = gmm_bound(E, C, D, F, 2)
    print(f"  expert_matmul on {path} {(E, C, D)}x{(E, D, F)} bf16, "
          f"{launches} launches {per}: {'ok' if ok else 'FAIL'} "
          f"max_abs_err {err:.3e} (tol {tol}); kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"torch.bmm {lib_ms:.4f} ms (kernel / torch.bmm "
          f"{ms / lib_ms:.3f}); bound {bound:.4f} ms by {by} "
          f"({bound / ms:.3f} of it)")
    if not ok:
        fail(f"expert_matmul at {shape} against plain: {err:.3e}")
    return {"name": "expert_matmul", "path": path, "route": "cuda",
            "source": "src/repro_torch/csrc/expert_matmul.cu",
            "replaces": REPLACES["expert_matmul"], "launches": launches,
            "shape": [E, C, D, F], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def mesh_one_card_moe(torch, dev, cfg) -> None:
    """29 (a) on one card: the emulated tp-rank layer with the kernel
    against the same emulation with the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import (expert_matmul_cuda,
                                             expert_matmul_ref)
    p = mesh_layer_weights(torch, dev, cfg, "moe")
    x = mesh_input(torch, dev, cfg.d_model)
    _build.reset_launch_counts()
    with torch.no_grad():
        got, aux_k, drop_k = a2a_emulated(torch, p, cfg, x, MESH_TP,
                                          expert_matmul_cuda)
        n_k = _build.DESIGN_COUNTS[("expert_matmul", "tc")]
        want, aux_p, drop_p = a2a_emulated(torch, p, cfg, x, MESH_TP,
                                           expert_matmul_ref)
    rms = rel_rms(got, want)
    print(f"  (a) one {MESH_ARCH} MoE layer, ({MESH_B}, {MESH_PROMPT}, "
          f"{cfg.d_model}) bf16, {MESH_TP} ranks emulated on card 0: "
          f"kernel against plain relative RMS {rms:.3e} (limit "
          f"{MOE_LAYER_REL_RMS}); aux {float(aux_k)!r} / {float(aux_p)!r}; "
          f"dropped {drop_k} / {drop_p} of {x.shape[0] * x.shape[1] * 8} "
          f"pairs; {n_k} launches on tc")
    if not (rms <= MOE_LAYER_REL_RMS and float(aux_k) == float(aux_p)
            and drop_k == drop_p and n_k == 3 * MESH_TP
            and bool(torch.isfinite(got).all())):
        fail("phase 29 (a): the emulated a2a layer's kernel path differs "
             "from its plain version")


def mesh_report(torch, recs: list, cfg, tp: int) -> None:
    """Print and check the ranks' (c) records."""
    c = cfg
    want_flash = {(MESH_B, MESH_PROMPT, MESH_PROMPT, c.heads // tp,
                   max(1, c.kv_heads // tp), c.hd, True, 0): c.n_layers}
    want_gmm = 3 * c.n_layers * MESH_STEPS
    toks0 = recs[0]["toks"]
    for r, rec in enumerate(recs):
        dec_ms = (rec["gen_s"] - rec["prefill_s"]) / (MESH_STEPS - 1) * 1e3
        busy = rec["busy_ms"] / (rec["prof_wall_s"] * 1e3)
        nccl = rec["nccl_ms"] / max(rec["busy_ms"], 1e-9)
        prompt_tps = MESH_B * MESH_PROMPT / rec["prefill_s"]
        new_tps = MESH_B * MESH_STEPS / rec["gen_s"]
        print(f"  (c) rank {r}: init {rec['init_s']:.2f} s, weights "
              f"{rec['param_gb']:.3f} GB, init peak {rec['init_peak_gb']:.3f}"
              f" GB, generate peak {rec['gen_peak_gb']:.3f} GB; first "
              f"generate {rec['first_s']:.3f} s; warm, through the step "
              f"factories: prefill {rec['prefill_s'] * 1e3:.3f} ms "
              f"({prompt_tps:.1f} prompt tok/s), decode {dec_ms:.3f} ms a "
              f"step, both {rec['gen_s'] * 1e3:.3f} ms ({new_tps:.2f} new "
              f"tok/s); "
              f"profiled generate {rec['prof_wall_s'] * 1e3:.3f} ms, device "
              f"busy {rec['busy_ms']:.3f} ms ({100 * busy:.2f}%), NCCL "
              f"{rec['nccl_ms']:.3f} ms ({100 * nccl:.2f}% of device time)")
        print(f"      launches {rec['launches']}, designs {rec['designs']}; "
              f"flash by (B, Sq, Sk, Hq, Hkv, d, causal, window) "
              f"{rec['flash_shapes']} (want {want_flash}); expert_matmul by "
              f"(E, C, D, F) {rec['gmm_shapes']}")
        print(f"      collectives a generate (calls, bytes, ring wire bytes "
              f"a rank): {rec['collectives']}")
        rms = rec["step_rms"]
        print(f"      decode against the teacher-forced continuation with "
              f"the decode's routing replayed, relative RMS per step: max "
              f"{float(rms.max()):.3e}, mean {float(rms.mean()):.3e} (limit "
              f"{LOGIT_REL_RMS}); its argmax agreeing with the served "
              f"tokens {rec['forced_agree']:.4f}; routing for itself: "
              f"{rec['routed_differently']:.4f} of (token, k) pairs to "
              f"other experts, relative RMS max "
              f"{float(rec['free_rms'].max()):.3e}")
        print(f"      the replayed experts in the replayed pass's own "
              f"router: {rec['tie_flips']:.4f} of pairs below its top "
              f"{c.experts_per_token}, the worst at rank "
              f"{rec['tie_worst_rank']}, at most {rec['tie_max_gap']:.4f} "
              f"below its k-th logit (limit {MESH_TIE_LOGIT_GAP}; its k-th "
              f"and next logits lie a median {rec['tie_spacing']:.4f} "
              f"apart); pairs dropped in the decode "
              f"{rec['dropped_in_decode']}")
        problems = []
        if rec["flash_shapes"] != want_flash:
            problems.append(f"flash launches {rec['flash_shapes']}")
        if rec["launches"] != {"flash_attention": c.n_layers,
                               "expert_matmul": want_gmm}:
            problems.append(f"launches {rec['launches']}")
        if rec["designs"] != {"flash_attention/tc": c.n_layers,
                              "expert_matmul/tc": want_gmm}:
            problems.append(f"designs {rec['designs']}")
        if not torch.equal(rec["toks"], toks0):
            problems.append("tokens differ from rank 0's")
        if tuple(toks0.shape) != (MESH_B, MESH_STEPS) or \
                int(toks0.min()) < 0 or int(toks0.max()) >= c.vocab_size:
            problems.append(f"tokens of shape {tuple(toks0.shape)}")
        if not rec["served_finite"] or float(rms.max()) > LOGIT_REL_RMS:
            problems.append(f"decode relative RMS {float(rms.max()):.3e}")
        if rec["tie_max_gap"] > MESH_TIE_LOGIT_GAP or \
                rec["dropped_in_decode"]:
            problems.append(f"a replayed expert {rec['tie_max_gap']:.4f} "
                            f"below the k-th logit, "
                            f"{rec['dropped_in_decode']} decode pairs "
                            f"dropped")
        if problems:
            fail(f"phase 29 (c) rank {r}: " + "; ".join(problems))


def mesh_phase(torch, dev) -> list:
    """Phase 29; returns its kernels-line entries."""
    import dataclasses
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config, resolve_for_tp
    from repro_torch.launch.mesh import init_rank, spawn
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    tp = MESH_TP if n_cards >= MESH_TP else 1
    depth = 0 if tp > 1 else MESH_ONE_CARD_DEPTH
    cfg = resolve_for_tp(get_config(MESH_ARCH), tp)
    print(f"phase 29: the mesh -- {MESH_ARCH} ({cfg.heads}/{cfg.kv_heads} "
          f"heads at tp {tp}) over {tp} card(s), (data 1, model {tp})")
    out = tempfile.mkdtemp(prefix="mesh-")
    try:
        torch.cuda.empty_cache()
        if tp > 1:
            spawn(mesh_rank, tp, (out, tp, depth), backend="nccl",
                  timeout_s=MESH_LIMIT_S, store_dir=out)
        else:
            mesh_one_card_moe(torch, dev, resolve_for_tp(
                get_config(MESH_ARCH), MESH_TP))
            init_rank(0, 1, os.path.join(out, "store"), "nccl", 120)
            try:
                mesh_rank(0, out, 1, depth)
            finally:
                dist.destroy_process_group()
        recs = [torch.load(os.path.join(out, f"mesh-r{r}.pt"),
                           weights_only=False) for r in range(tp)]
        flash = torch.load(os.path.join(out, "flash-call.pt"),
                           weights_only=False)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if tp > 1:
        a = recs[0]
        n_tc = [r["a_tc"] for r in recs]
        print(f"  (a) one {MESH_ARCH} MoE layer, ({MESH_B}, {MESH_PROMPT}, "
              f"{cfg.d_model}) bf16, moe_apply_a2a over {tp} cards against "
              f"the plain emulation on card 0: relative RMS "
              f"{a['a_rms']:.3e} (limit {MOE_LAYER_REL_RMS}); aux "
              f"{[r['a_aux'] for r in recs]} / {a['a_aux_plain']!r}; dropped "
              f"{a['a_dropped']} / {a['a_dropped_plain']} of {a['a_pairs']} "
              f"pairs; expert_matmul launches on tc a rank {n_tc}; (a)+(b) "
              f"{a['ab_s']:.1f} s")
        aux_gap = max(abs(r["a_aux"] - a["a_aux_plain"]) for r in recs)
        if not (a["a_finite"] and a["a_rms"] <= MOE_LAYER_REL_RMS
                and aux_gap <= MESH_AUX_RTOL * abs(a["a_aux_plain"])
                and a["a_dropped"] == a["a_dropped_plain"]
                and n_tc == [3] * tp
                and [r["a_launches"] for r in recs] == [3] * tp):
            fail("phase 29 (a): the a2a layer differs from its plain "
                 "emulation")
        print(f"  (b) one tensor-parallel GQA layer ({cfg.heads // tp}/"
              f"{cfg.kv_heads // tp} heads a card) against the layer "
              f"unsharded on card 0: max |diff| {a['b_err']:.3e}, allclose "
              f"at rtol = atol = {FLASH_TOL['bfloat16']} "
              f"{'ok' if a['b_close'] else 'FAIL'} (output RMS "
              f"{a['b_out_rms']:.3e}); "
              f"worst row's relative RMS {a['b_worst_row']:.3e} (limit "
              f"{FLASH_ROW_REL_RMS:.3e})")
        if not (a["b_close"] and a["b_worst_row"] <= FLASH_ROW_REL_RMS):
            fail("phase 29 (b): the tensor-parallel attention layer differs "
                 "from the unsharded one")
    else:
        print(f"  phase 29 needs {MESH_TP} cards for: (a) moe_apply_a2a over "
              f"NCCL, (b) the tensor-parallel GQA layer, (c) {MESH_ARCH} at "
              f"full depth over {MESH_TP} cards; this machine has "
              f"{n_cards}: (a) ran emulated on card 0, (c) at world size 1 "
              f"and depth {depth}")
    c_cfg = dataclasses.replace(cfg, n_layers=depth or cfg.n_layers)
    mesh_report(torch, recs, c_cfg, tp)
    # (d) the kernels at each rank's shapes, on card 0 alone
    rec = recs[0]
    path = f"{MESH_ARCH} tp{tp}" + (f" depth {depth}" if depth else "")
    gen = torch.Generator(device=dev).manual_seed(29)

    def draw(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    key = flash["key"]
    call = tuple(t.to(dev) if isinstance(t, torch.Tensor) else t
                 for t in flash["call"])
    ok, f_entry = zoo_flash_entry(torch, draw, f"{path} prefill",
                                  rec["flash_shapes"][key], call,
                                  (c_cfg.hd, c_cfg.hd))
    if not ok:
        fail(f"phase 29 (d): flash at {key} against plain")
    entries = [f_entry] + [
        gmm_entry(torch, dev, path, shape, n)
        for shape, n in sorted(rec["gmm_shapes"].items())]
    print(f"  phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return entries


# ---------------------------------------------------------------------------
# phase 30: the sharded training step
# ---------------------------------------------------------------------------

def layer_emulated_moe(torch, p, cfg, x, dp: int, tp: int, replay=None):
    """``moe_apply_a2a`` of a (data ``dp``, model ``tp``) mesh in one
    process, differentiable: each (data, model) block of x (B, S, D) (the
    batch over data, the sequence over model) routed with its own
    capacity ``c_send`` (with ``replay``, to the given (t, K) experts of
    each block, the weights from its own router), the exchange within each
    data group done by indexing, each owner's experts through the model's
    expert op, and the aux term from the blocks' mean vectors.  Returns
    (out (B, S, D), aux, [(top_e, keep)] a block)."""
    import torch.nn.functional as F
    from repro_torch.models import moe as moe_mod
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    E_pad = -(-E // tp) * tp
    E_loc = E_pad // tp
    b, s = B // dp, S // tp
    t = b * s
    c_send = max(4, -(-int(t * K * cfg.capacity_factor / E_pad) // 4) * 4)
    blocks, routes, mes, ces = [], [], [], []
    for i in range(dp * tp):
        d, m = divmod(i, tp)
        xf = x[d * b:(d + 1) * b, m * s:(m + 1) * s].reshape(t, D)
        logits = F.pad(xf.float() @ p["router"], (0, E_pad - E), value=-1e30)
        probs = torch.softmax(logits, dim=-1)
        top_e = torch.topk(probs, K, dim=-1)[1] if replay is None \
            else replay[i]
        top_p = probs.gather(1, top_e)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        mes.append(probs[:, :E].mean(0))
        ces.append(F.one_hot(top_e[:, 0], E_pad)[:, :E].float().mean(0))
        ranks = moe_mod._local_rank_in_expert(top_e.reshape(-1), E_pad)
        keep = ranks < c_send
        slot = torch.where(keep, top_e.reshape(-1) * c_send + ranks,
                           E_pad * c_send)
        send = torch.zeros((E_pad * c_send + 1, D), dtype=x.dtype,
                           device=x.device).index_copy(
            0, slot, xf.repeat_interleave(K, dim=0))
        blocks.append((top_p, slot, keep, send[:-1].reshape(
            tp, E_loc * c_send, D)))
        routes.append((top_e.detach(), keep))
    aux = E * torch.sum(torch.stack(mes).mean(0) * torch.stack(ces).mean(0))
    pad = (0, 0, 0, 0, 0, E_pad - E)
    wg, wu, wo = (F.pad(p[k], pad) for k in ("wi_gate", "wi_up", "wo"))
    outs = []
    for d in range(dp):
        back = [[None] * tp for _ in range(tp)]
        for r in range(tp):                         # expert owner r
            recv = torch.stack([blocks[d * tp + j][3][r] for j in range(tp)])
            buf = recv.reshape(tp, E_loc, c_send, D).transpose(0, 1) \
                .reshape(E_loc, tp * c_send, D)
            ob = moe_mod._swiglu_experts(
                buf, *(w[r * E_loc:(r + 1) * E_loc] for w in (wg, wu, wo)))
            ob = ob.reshape(E_loc, tp, c_send, D)
            for j in range(tp):
                back[j][r] = ob[:, j].reshape(E_loc * c_send, D)
        row = []
        for j in range(tp):
            top_p, slot, keep, _ = blocks[d * tp + j]
            out_flat = torch.cat(back[j], 0)
            got = torch.where(keep[:, None], out_flat[moe_mod._combine_rows(
                out_flat, slot, keep)], 0.0)
            row.append((got * top_p.reshape(-1, 1).to(x.dtype)).reshape(
                t, K, D).sum(dim=1).reshape(b, s, D))
        outs.append(torch.cat(row, 1))
    return torch.cat(outs, 0), aux, routes


def layer_emulated(torch, p, cfg, x, dp: int, tp: int, replay=None):
    """One GQA + MoE block of a (data ``dp``, model ``tp``) mesh in one
    process: each data rank's attention as the sum of its ``tp`` model
    ranks' partial outputs (their heads' columns of ``wq``, ``wk``,
    ``wv`` and rows of ``wo``), then ``layer_emulated_moe``.  Returns
    (out, aux, routes)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.common import rmsnorm
    B = x.shape[0]
    hd, Hq, Hkv = cfg.hd, cfg.heads // tp, cfg.kv_heads // tp
    a = p["attn"]

    def heads(m):
        q, kv = slice(m * Hq * hd, (m + 1) * Hq * hd), \
            slice(m * Hkv * hd, (m + 1) * Hkv * hd)
        return {"wq": a["wq"][:, q], "wk": a["wk"][:, kv],
                "wv": a["wv"][:, kv], "wo": a["wo"][q]}

    hs = []
    for d in range(dp):
        xd = x[d * B // dp:(d + 1) * B // dp]
        xn = rmsnorm(xd, p["ln1"], cfg.norm_eps)
        y = attn_mod.gqa_forward(heads(0), cfg, xn)
        for m in range(1, tp):
            y = y + attn_mod.gqa_forward(heads(m), cfg, xn)
        hs.append(xd + y)
    h = torch.cat(hs, 0)
    y, aux, routes = layer_emulated_moe(
        torch, p["mlp"], cfg, rmsnorm(h, p["ln2"], cfg.norm_eps), dp, tp,
        replay)
    return h + y, aux, routes


def layer_objective(out, aux, cot):
    """The (a) layer's loss: the mean of out * cot over every element,
    plus the aux term at ``lm_loss``'s weight."""
    return (out.float() * cot).sum() / out.numel() + \
        TRAIN_MESH_AUX_WEIGHT * aux


def layer_inputs(torch, dev, cfg):
    """(a)'s weights (one GQA + MoE block at full width, bf16, seed 30),
    input x and cotangent (TRAIN_MESH_B_TP x TRAIN_MESH_S tokens), the
    same on every rank."""
    from repro_torch.models import transformer as tf_mod
    gen = torch.Generator(device=dev).manual_seed(30)
    p = tf_mod._block_init(gen, cfg, "attn", torch.bfloat16, dev)
    shape = (TRAIN_MESH_B_TP, TRAIN_MESH_S, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    cot = torch.randn(shape, generator=gen, device=dev)
    return p, x, cot


@contextlib.contextmanager
def local_routes_seen(torch):
    """Record each ``route_local`` call's (top_e (t, K), keep (t*K,)) on
    this rank."""
    import torch.nn.functional as F
    from repro_torch.models import moe as moe_mod
    route, seen = moe_mod.route_local, []

    def recording(p, cfg, x):
        out = route(p, cfg, x)
        with torch.no_grad():
            E_pad = out[4]
            logits = F.pad(x.reshape(-1, x.shape[-1]).float() @ p["router"],
                           (0, E_pad - cfg.n_experts), value=-1e30)
            top_e = torch.topk(torch.softmax(logits, -1),
                               cfg.experts_per_token, dim=-1)[1]
        seen.append((top_e, out[2].clone()))
        return out

    moe_mod.route_local = recording
    try:
        yield seen
    finally:
        moe_mod.route_local = route


def mesh_layer_train(torch, dev, mesh, cfg) -> dict:
    """30 (a) on a rank of the (data 2, model 2) mesh: the block's forward
    and backward as training runs it (the rank's training-layout blocks
    gathered by their specs, its (batch, sequence) block of x, the
    residual sequence-parallel, ``moe_apply_a2a``), its data group's loss
    counted once, then ``train.loop``'s reduction of the gradients.
    Returns the loss, aux, this rank's routes, its gradient blocks and
    the launches."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tf_mod
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.loop import _reduce_grads
    p, x, cot = layer_inputs(torch, dev, cfg)
    sizes = shd.mesh_shape(mesh)
    dp, tp = sizes["data"], sizes["model"]
    specs = shd.param_specs(cfg, p, tp, fsdp=True)
    with shd.use_mesh(mesh):
        local = shd.tree_map_with_path(
            lambda path, leaf: shd.local_block(leaf, shd.leaf_at(
                specs, path)).clone().requires_grad_(), p)
        x_loc, c_loc = (shd.local_block(t, ("data", "model", None))
                        for t in (x, cot))
        n = x.numel()
        del p, x, cot
        _build.reset_launch_counts()
        with local_routes_seen(torch) as seen:
            h, aux = tf_mod._block_fwd(
                tf_mod._gathered(local, specs), cfg, "attn", x_loc,
                torch.zeros((), dtype=torch.float32, device=dev), sp=True)
        # this data group's loss, counted once over 'model'; the data
        # ranks' mean is the whole layer's objective (train.loop)
        loss = coll.reduce_partial((h.float() * c_loc).sum() * (dp / n),
                                   "model") + TRAIN_MESH_AUX_WEIGHT * aux
        grads = iter(torch.autograd.grad(loss, list(tree_leaves(local))))
        grads = _reduce_grads(tree_map(lambda _: next(grads), local), specs)
        total = coll.all_reduce(loss.detach(), "data", "avg")
    torch.cuda.synchronize()
    return {"a_loss": float(total), "a_aux": float(aux.detach()),
            "a_routes": [(e.cpu(), k.cpu()) for e, k in seen],
            "a_grads": {k: g.cpu() for k, g in named_leaves(grads)},
            "a_launches": {k: v for k, v in _build.LAUNCH_COUNTS.items()
                           if v},
            "a_designs": {f"{k}/{d}": v for (k, d), v in
                          _build.DESIGN_COUNTS.items() if v}}


def assemble(torch, specs, blocks: list, sizes: dict) -> dict:
    """Whole tensors from the ranks' blocks: ``blocks`` holds (mesh
    coordinate {axis: index}, {path: block}) of each rank; each block goes
    where ``specs`` (a flat {path: spec}) places it."""
    out = {}
    for coord, tree in blocks:
        for path, blk in tree.items():
            spec = specs[path]
            if path not in out:
                shape = [n * int(np.prod([sizes.get(a, 1) for a in (
                    (e,) if isinstance(e, str) else (e or ()))]))
                    for n, e in zip(blk.shape, spec)]
                out[path] = torch.empty(shape, dtype=blk.dtype)
            view = out[path]
            for d, e in enumerate(spec):
                axes = (e,) if isinstance(e, str) else (e or ())
                idx = 0
                for a in axes:
                    idx = idx * sizes.get(a, 1) + coord.get(a, 0)
                view = view.narrow(d, idx * blk.shape[d], blk.shape[d])
            view.copy_(blk)
    return out


def layer_check(torch, label: str, got: dict, want: dict) -> bool:
    """Print and hold (a): the routes (pairs routed differently, at most
    ``MOE_FLIP_MAX``), then the loss, aux and each gradient leaf on the
    routing replayed.  ``got`` and ``want`` hold "loss", "aux", "routes"
    (a list of (top_e, keep) a block) and "grads" ({path: whole
    tensor}); ``want`` also "free_routes", its routes for itself."""
    pairs = differ = dropped = 0
    for (eg, kg), (ew, kw) in zip(got["routes"], want["free_routes"]):
        sg, sw = torch.sort(eg.cpu(), 1)[0], torch.sort(ew.cpu(), 1)[0]
        differ += int((sg != sw).sum()) + int((kg.cpu() != kw.cpu()).sum())
        pairs += eg.numel()
        dropped += int((~kg).sum())
    flip = differ / pairs
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    aux_rel = abs(got["aux"] - want["aux"]) / abs(want["aux"])
    worst, worst_rms, rows = "", -1.0, []
    for path in sorted(want["grads"]):
        r = rel_rms(got["grads"][path], want["grads"][path])
        rows.append(f"{path} {r:.3e}")
        if not r <= worst_rms:
            worst, worst_rms = path, r
    print(f"  (a) {label}: (token, k) pairs routed differently "
          f"{flip:.6f} (limit {MOE_FLIP_MAX}), dropped {dropped} of {pairs}"
          f"; on the routing replayed: loss {got['loss']:.6f} vs "
          f"{want['loss']:.6f}, relative {loss_rel:.3e} (limit "
          f"{MOE_TRAIN_LOSS_RTOL}); aux {got['aux']:.6f} vs "
          f"{want['aux']:.6f}, relative {aux_rel:.3e} (limit "
          f"{MOE_AUX_RTOL}); worst gradient leaf {worst} {worst_rms:.3e} "
          f"(limit {TRAIN_GRAD_REL_RMS}); per leaf: " + "; ".join(rows))
    finite = np.isfinite(got["loss"]) and all(
        bool(torch.isfinite(g).all()) for g in got["grads"].values())
    return bool(finite and flip <= MOE_FLIP_MAX
                and loss_rel <= MOE_TRAIN_LOSS_RTOL
                and aux_rel <= MOE_AUX_RTOL
                and worst_rms <= TRAIN_GRAD_REL_RMS
                and set(got["grads"]) == set(want["grads"]))


def layer_emulated_run(torch, dev, cfg, replay=None) -> dict:
    """(a)'s objective and whole gradients through ``layer_emulated`` of
    the (data 2, model 2) mesh on card ``dev``, with the kernels or (in
    ``plain_kernels``) their plain versions."""
    p, x, cot = layer_inputs(torch, dev, cfg)
    leaves = {k: v.requires_grad_() for k, v in named_leaves(p)}
    out, aux, routes = layer_emulated(torch, p, cfg, x, TRAIN_MESH_DP,
                                      TRAIN_MESH_TP, replay)
    loss = layer_objective(out, aux, cot)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    return {"loss": float(loss.detach()), "aux": float(aux.detach()),
            "routes": routes,
            "grads": {k: g.detach() for k, g in zip(leaves, grads)}}


def layer_phase(torch, dev, cfg, mesh_recs=None) -> dict:
    """30 (a) on card 0: with ``mesh_recs`` (the 4 ranks' records) the
    mesh's run against the plain emulation, else the emulation's kernel
    path against its plain version.  Returns the launches by (E, C, D,
    F) and flash shape the kernel path made."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    label = "one granite layer (GQA + MoE), (" + ", ".join(
        str(n) for n in (TRAIN_MESH_B_TP, TRAIN_MESH_S, cfg.d_model)) + \
        ") bf16, training, on (data 2, model 2)"
    tallies = {}
    if mesh_recs is None:
        _build.reset_launch_counts()
        with flash_tally() as (ftally, _), gmm_tally() as gtally:
            got = layer_emulated_run(torch, dev, cfg)
        tallies = {"flash": dict(ftally), "gmm": dict(gtally)}
        got["designs"] = {f"{k}/{d}": v for (k, d), v in
                          _build.DESIGN_COUNTS.items() if v}
        label += ", emulated on card 0: kernel path against plain"
    else:
        sizes = {"data": TRAIN_MESH_DP, "model": TRAIN_MESH_TP}
        p, _, _ = layer_inputs(torch, dev, cfg)
        specs = dict(named_leaves(shd.param_specs(cfg, p, TRAIN_MESH_TP,
                                                  fsdp=True)))
        del p
        blocks = [(r["coord"], r["a_grads"]) for r in mesh_recs]
        by_coord = {(r["coord"]["data"], r["coord"]["model"]): r
                    for r in mesh_recs}
        got = {"loss": mesh_recs[0]["a_loss"], "aux": mesh_recs[0]["a_aux"],
               "routes": [by_coord[divmod(i, TRAIN_MESH_TP)]["a_routes"][0]
                          for i in range(TRAIN_MESH_DP * TRAIN_MESH_TP)],
               "grads": assemble(torch, specs, blocks, sizes),
               "designs": mesh_recs[0]["a_designs"]}
        label += " over 4 cards against the plain emulation on card 0"
        losses = {(r["a_loss"], r["a_aux"]) for r in mesh_recs}
        if len(losses) != 1:
            fail(f"phase 30 (a): the ranks' loss and aux differ: {losses}")
    with plain_kernels():
        free = layer_emulated_run(torch, dev, cfg)
        want = layer_emulated_run(torch, dev, cfg, [
            e.to(dev) for e, _ in got["routes"]])
    want["free_routes"] = free["routes"]
    got["grads"] = {k: v.to(dev) for k, v in got["grads"].items()}
    ok = layer_check(torch, label, got, want)
    # a rank's forward and backward: one flash launch, three expert
    # products and two launches each backward; the emulation makes those
    # of all four ranks
    ranks = 1 if mesh_recs is not None else TRAIN_MESH_DP * TRAIN_MESH_TP
    designs = {"flash_attention/tc": ranks, "expert_matmul/tc": 9 * ranks}
    print(f"      the kernel path's launches (a rank's on the mesh) by "
          f"design: {got['designs']} (want {designs})")
    ok = ok and got["designs"] == designs
    del free, want, got
    torch.cuda.empty_cache()
    if not ok:
        fail("phase 30 (a): the sharded training layer does not agree with "
             "its plain emulation")
    return tallies


def leaf_checksums(torch, tree):
    """(leaf, 2) int64 on the leaves' device: each leaf's bits summed, and
    summed weighted by their position mod 65521, as integers (exact):
    equal bits give equal rows."""
    rows = []
    for _, leaf in named_leaves(tree):
        flat = leaf.detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2
                         else torch.int32)
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=leaf.device)
        for lo in range(0, bits.numel(), 1 << 25):
            b = bits[lo:lo + (1 << 25)].to(torch.int64)
            pos = torch.arange(lo, lo + b.numel(), device=b.device) % 65521
            s1 = s1 + b.sum()
            s2 = s2 + (b * (pos + 1)).sum()
        rows.append(torch.stack([s1, s2]))
    return torch.stack(rows)


def mesh_train_run(torch, dev, mesh, cfg, batch_b: int,
                   count: bool = False) -> dict:
    """30 (b) on a rank: ``cfg`` with the sharded init in the training
    layout, TRAIN_MESH_STEPS ``make_train_step`` steps (remat on) on one
    repeated batch of ``batch_b`` x TRAIN_MESH_S structured tokens, with
    the launches and the collectives counted over the steps; its init and
    step peaks, walls and metrics; the checksums of its params and master
    weights; one profiled step's device time and NCCL's share of it; and
    the first flash call's inputs (for the kernel line).  With ``count``
    one more step under ``op_analysis.StepCounter`` (phase 31 (b)): its
    counts, and its peak less what the card held before the init."""
    from repro_torch.data import structured_unit
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.train.loop import make_train_step
    import torch.distributed as dist
    model = build_model(cfg)
    rec = {}
    with shd.use_mesh(mesh):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=dev, fsdp=True)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["init_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        rec["param_gb"] = describe_params(params)[1] / 1e9
        opt = AdamW(lr=constant(TRAIN_LR))
        state = opt.init(params)
        step = make_train_step(model, opt, remat=True)
        batch = structured_unit(0, batch_b, TRAIN_MESH_S, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        coll.reset_counts()
        walls, metrics = [], []
        with flash_tally() as (ftally, first), gmm_tally() as gtally:
            for _ in range(TRAIN_MESH_STEPS):
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in m.items()})
        rec.update(
            walls=walls, metrics=metrics,
            step_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            launches={k: v for k, v in _build.LAUNCH_COUNTS.items() if v},
            designs={f"{k}/{d}": v for (k, d), v in
                     _build.DESIGN_COUNTS.items() if v},
            collectives=coll.counts(), flash_shapes=dict(ftally),
            gmm_shapes=dict(gtally), coord=dict(zip(
                mesh.mesh_dim_names, mesh.get_coordinate())))
        if dist.get_rank() == 0 and first:
            (key, call), = first.items()
            rec["flash_call"] = (key, tuple(
                t.detach().cpu() if isinstance(t, torch.Tensor) else t
                for t in call))
        del first
        rec["checksums"] = {
            "params": leaf_checksums(torch, params).cpu(),
            "master": leaf_checksums(torch, state.master).cpu()}
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, state, batch)
            torch.cuda.synchronize()
            rec["prof_wall_s"] = time.perf_counter() - t0
        events = [e for e in device_rows(torch, prof)[0]
                  if e.self_device_time_total > 0]
        rec["busy_ms"] = sum(e.self_device_time_total for e in events) / 1e3
        rec["nccl_ms"] = sum(e.self_device_time_total for e in events
                             if "nccl" in e.key.lower()) / 1e3
        if count:
            from repro_torch.launch.dryrun import count_train
            whole = {k: torch.as_tensor(v, device=dev).long()
                     for k, v in batch.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            rec["counts"] = count_train(model, opt, params, state, whole)
            torch.cuda.synchronize()
            rec["counted_peak"] = torch.cuda.max_memory_allocated(dev) \
                - base
            del whole
        del params, state, opt, step
    torch.cuda.empty_cache()
    return rec


def train_mesh_rank(rank: int, out: str) -> None:
    """Phase 30's body on one rank of the 4-card NCCL world, card
    ``rank``: (a) on the (data 2, model 2) mesh, then (b) on (data 4,
    model 1) and on (data 2, model 2); its record goes to ``out``."""
    import torch
    from repro_torch.configs import get_config, resolve_for_tp
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device("cuda", rank)
    flat = make_host_mesh(model=1)
    mesh = make_host_mesh(model=TRAIN_MESH_TP)
    cfg = resolve_for_tp(get_config(TRAIN_MESH_ARCH), TRAIN_MESH_TP)
    rec = {"card": torch.cuda.get_device_name(dev),
           "coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))}
    t0 = time.perf_counter()
    rec.update(mesh_layer_train(torch, dev, mesh, cfg))
    rec["a_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for label, m, c, b in (
            ("d4m1", flat, resolve_for_tp(get_config(TRAIN_MESH_ARCH), 1),
             TRAIN_MESH_B_DP),
            ("d2m2", mesh, cfg, TRAIN_MESH_B_TP)):
        t0 = time.perf_counter()
        rec[label] = mesh_train_run(torch, dev, m, c, b,
                                    count=label == "d2m2")
        rec[label]["s"] = time.perf_counter() - t0
    torch.save(rec, os.path.join(out, f"train-mesh-r{rank}.pt"))


def train_shapes(cfg, dp: int, tp: int, L: int) -> tuple:
    """The flash shape and the expert products' (E, C, D, F) launches that
    a rank's TRAIN_MESH_STEPS steps (remat on) make on a (data ``dp``,
    model ``tp``) mesh over ``dp`` x TRAIN_MESH_S tokens, ``L`` layers:
    each layer's forward (twice, with the remat's recompute) and backward,
    the latter's dX = dY W^T and dW = X^T dY.  Where tp > 1 the
    all-to-all's buffer (E/tp experts, tp x c_send rows); else the
    scatter path's C / dp block of every expert."""
    E, D, Ff, K = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.experts_per_token
    if tp > 1:
        e = -(-E // tp)
        t = TRAIN_MESH_S // tp
        rows = tp * max(4, -(-int(t * K * cfg.capacity_factor / (e * tp))
                                // 4) * 4)
    else:
        from repro_torch.models.moe import _capacity
        e, rows = E, _capacity(dp * TRAIN_MESH_S, cfg) // dp
    n = L * TRAIN_MESH_STEPS
    flash = (1, TRAIN_MESH_S, TRAIN_MESH_S, cfg.heads // tp,
             cfg.kv_heads // tp, cfg.hd, True, 0)
    return flash, {(e, rows, D, Ff): 5 * n, (e, rows, Ff, D): 4 * n,
                   (e, D, rows, Ff): 2 * n, (e, Ff, rows, D): n}


def train_report(torch, recs: list, cfg, label: str, batch_b: int,
                 dp: int, tp: int) -> None:
    """Print and hold (b) of one mesh from the 4 ranks' records."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build_model
    L, steps = cfg.n_layers, TRAIN_MESH_STEPS
    flash, gmm = train_shapes(cfg, dp, tp, L)
    want = {"flash_attention": 2 * L * steps, "expert_matmul": 12 * L * steps}
    specs = [s for _, s in named_leaves(shd.param_specs(
        cfg, build_model(cfg).param_specs(), tp, fsdp=True))]
    tokens = batch_b * TRAIN_MESH_S
    print(f"  (b) {TRAIN_MESH_ARCH} {L} layers on {label} (data {dp}, model "
          f"{tp}), {batch_b} x {TRAIN_MESH_S} structured tokens, bf16, "
          f"sharded init in the training layout, remat on, {steps} steps "
          f"on one batch:")
    problems = []
    for r, rec in enumerate(recs):
        warm = min(rec["walls"][1:])
        busy = rec["busy_ms"] / (rec["prof_wall_s"] * 1e3)
        per_step = {k: {f: v / steps for f, v in row.items()}
                    for k, row in rec["collectives"].items()}
        print(f"    rank {r} {rec['coord']}: init {rec['init_s']:.2f} s, "
              f"weights {rec['param_gb']:.3f} GB, init peak "
              f"{rec['init_peak_gb']:.3f} GB, step peak "
              f"{rec['step_peak_gb']:.3f} GB; step walls "
              f"{[round(w * 1e3, 3) for w in rec['walls']]} ms, warm "
              f"{warm * 1e3:.3f} ms (min of the last {steps - 1}), "
              f"{tokens / 4 / warm:.1f} tokens/s a card; losses "
              f"{[m['loss'] for m in rec['metrics']]}, moe_aux "
              f"{[m['moe_aux'] for m in rec['metrics']]}, grad norms "
              f"{[m['grad_norm'] for m in rec['metrics']]}")
        print(f"      profiled step {rec['prof_wall_s'] * 1e3:.3f} ms: "
              f"device busy {rec['busy_ms']:.3f} ms ({100 * busy:.2f}%), "
              f"NCCL {rec['nccl_ms']:.3f} ms "
              f"({100 * rec['nccl_ms'] / max(rec['busy_ms'], 1e-9):.2f}% "
              f"of device time), outside NCCL "
              f"{rec['busy_ms'] - rec['nccl_ms']:.3f} ms; launches "
              f"{rec['launches']}, designs {rec['designs']}; collectives a "
              f"step (calls, bytes, ring wire bytes a rank): {per_step}")
        if rec["launches"] != want or rec["designs"] != {
                f"{k}/tc": v for k, v in want.items()}:
            problems.append(f"rank {r} launches {rec['launches']}, designs "
                            f"{rec['designs']}; want {want}, all on tc")
        if rec["flash_shapes"] != {flash: want["flash_attention"]} or \
                rec["gmm_shapes"] != gmm:
            problems.append(f"rank {r} shapes {rec['flash_shapes']} "
                            f"{rec['gmm_shapes']}; want {flash} {gmm}")
        if rec["metrics"] != recs[0]["metrics"]:
            problems.append(f"rank {r}'s metrics differ from rank 0's")
    losses = [m["loss"] for m in recs[0]["metrics"]]
    values = [v for m in recs[0]["metrics"] for v in m.values()]
    if not np.all(np.isfinite(values)) or not losses[-1] < losses[0]:
        problems.append(f"metrics {recs[0]['metrics']}: not finite, or the "
                        f"last loss is not below the first")
    for part in ("params", "master"):
        for i, spec in enumerate(specs):
            axes = shd.spec_axes(spec)
            held = {}
            for rec in recs:
                block = tuple(rec["coord"].get(a, 0) for a in axes)
                held.setdefault(block, []).append(rec["checksums"][part][i])
            if not all(torch.equal(h[0], x) for h in held.values()
                       for x in h[1:]):
                problems.append(f"{part} leaf {i} ({spec}) differs between "
                                f"ranks that hold the same block")
    print(f"    every leaf that several ranks hold is the same bits on each "
          f"(params and master weights, {len(specs)} leaves): "
          f"{'yes' if not any('differs' in p for p in problems) else 'NO'}")
    if problems:
        fail(f"phase 30 (b) on {label}: " + "; ".join(problems))


def world_one_train(torch, dev, cfg) -> dict:
    """30 (b) on one card: ``cfg`` (cut in depth) at world size 1, the
    sharded init and one sharded step against the unsharded init and
    ``make_train_step``, bit for bit.  Returns the sharded run's
    launches by flash and (E, C, D, F) shape."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.data import structured_unit
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_rank, make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.train.loop import make_train_step
    model = build_model(cfg)
    batch = structured_unit(0, 1, TRAIN_MESH_S, cfg.vocab_size)
    out = tempfile.mkdtemp(prefix="train-w1-")
    runs, tallies = {}, {}
    init_rank(0, 1, os.path.join(out, "store"), "nccl", 120)
    try:
        for label, mesh in (("sharded", make_host_mesh()), ("plain", None)):
            with shd.use_mesh(mesh):
                params = model.init(seed=0, device=dev,
                                    fsdp=mesh is not None)
                opt = AdamW(lr=constant(TRAIN_LR))
                state = opt.init(params)
                _build.reset_launch_counts()
                with flash_tally() as (ftally, first), \
                        gmm_tally() as gtally:
                    params, state, metrics = make_train_step(
                        model, opt, remat=True)(params, state, batch)
                torch.cuda.synchronize()
                if mesh is not None:
                    tallies = {"flash": dict(ftally), "gmm": dict(gtally),
                               "call": tuple(
                                   t.detach() if isinstance(t, torch.Tensor)
                                   else t for t in next(iter(first.values()),
                                                        ())),
                               "designs": {f"{k}/{d}": v for (k, d), v in
                                           _build.DESIGN_COUNTS.items() if v}}
                del first
                runs[label] = (params, {k: float(v)
                                        for k, v in metrics.items()})
                del state, opt
    finally:
        dist.destroy_process_group()
        shutil.rmtree(out, ignore_errors=True)
    (ps, ms), (pp, mp) = runs["sharded"], runs["plain"]
    same = [torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(ps),
                                                        named_leaves(pp))]
    print(f"  (b) {TRAIN_MESH_ARCH} at depth {cfg.n_layers} (widths as "
          f"published), 1 x {TRAIN_MESH_S} structured tokens, at world size "
          f"1: the sharded init and step against the unsharded init and "
          f"make_train_step: metrics {ms} vs {mp}; {sum(same)} of "
          f"{len(same)} leaves bitwise equal after one step; launches "
          f"{tallies['designs']}")
    if ms != mp or not all(same) or not np.isfinite(ms["loss"]):
        fail("phase 30 (b): at world size 1 the sharded step is not the "
             "unsharded step bit for bit")
    del runs, ps, pp
    torch.cuda.empty_cache()
    return tallies


def train_flash_entry(torch, draw, path: str, launches: int, call,
                      per: str) -> tuple:
    """(ok, the kernels line's entry) for one flash shape of a training
    path: ``zoo_flash_entry``'s checks and times, and the backward (the
    plain version recomputed and differentiated) timed at the same
    inputs."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v, causal, window, scale = call
    ok, entry = zoo_flash_entry(torch, draw, path, launches, call,
                                (q.shape[-1], v.shape[-1]), per)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal, window, scale)
    cot = torch.ones_like(out)
    bwd = cuda_ms(torch, lambda: torch.autograd.grad(out, leaves, cot,
                                                     retain_graph=True))
    print(f"  flash_attention backward on {path} (the plain version "
          f"recomputed and differentiated): {bwd:.4f} ms")
    entry.update(backward=BACKWARDS["flash_attention"], backward_ms=bwd)
    return ok, entry


def train_mesh_phase(torch, dev) -> list:
    """Phase 30; returns its kernels-line entries."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs import get_config, resolve_for_tp
    from repro_torch.launch.mesh import spawn
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    cfg = resolve_for_tp(get_config(TRAIN_MESH_ARCH), TRAIN_MESH_TP)
    flat_cfg = resolve_for_tp(get_config(TRAIN_MESH_ARCH), 1)
    print(f"phase 30: the sharded training step -- {TRAIN_MESH_ARCH} "
          f"({cfg.heads}/{cfg.kv_heads} heads, {cfg.n_experts} experts) "
          f"over {min(n_cards, 4)} card(s)")
    gen = torch.Generator(device=dev).manual_seed(30)

    def draw(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    calls = {}
    if n_cards >= 4:
        out = tempfile.mkdtemp(prefix="train-mesh-")
        try:
            torch.cuda.empty_cache()
            spawn(train_mesh_rank, 4, (out,), backend="nccl",
                  timeout_s=TRAIN_MESH_LIMIT_S, store_dir=out)
            recs = [torch.load(os.path.join(out, f"train-mesh-r{r}.pt"),
                               weights_only=False) for r in range(4)]
        finally:
            shutil.rmtree(out, ignore_errors=True)
        print(f"  the 4 ranks took: (a) {recs[0]['a_s']:.1f} s, (b) on "
              f"(data 4, model 1) {recs[0]['d4m1']['s']:.1f} s, on (data 2, "
              f"model 2) {recs[0]['d2m2']['s']:.1f} s")
        layer_phase(torch, dev, cfg, recs)
        train_report(torch, [r["d4m1"] for r in recs], flat_cfg, "d4m1",
                     TRAIN_MESH_B_DP, 4, 1)
        train_report(torch, [r["d2m2"] for r in recs], cfg, "d2m2",
                     TRAIN_MESH_B_TP, 2, TRAIN_MESH_TP)
        dry_mesh_ranks(torch, cfg, [r["d2m2"] for r in recs])
        launched = {"d4m1": (recs[0]["d4m1"]["flash_shapes"],
                             recs[0]["d4m1"]["gmm_shapes"]),
                    "d2m2": (recs[0]["d2m2"]["flash_shapes"],
                             recs[0]["d2m2"]["gmm_shapes"])}
        for label in launched:
            key, call = recs[0][label].get("flash_call", (None, ()))
            calls[key] = tuple(t.to(dev) if isinstance(t, torch.Tensor)
                               else t for t in call)
        where = "on its rank of the 4-card mesh, over the path's 3 steps"
        per = dict.fromkeys(launched, f"over {TRAIN_MESH_STEPS} steps on a "
                                      f"rank")
    else:
        a = layer_phase(torch, dev, cfg)
        b = world_one_train(torch, dev, dataclasses.replace(
            flat_cfg, n_layers=TRAIN_MESH_ONE_CARD_DEPTH))
        launched = {"d2m2": (a["flash"], a["gmm"]),
                    "d4m1": (b["flash"], b["gmm"])}
        key = next(iter(b["flash"]))
        calls[key] = b["call"]
        where = ("on card 0: (data 2, model 2) in (a)'s emulation of its "
                 "4 ranks, (data 4, model 1) in (b)'s step at world size 1 "
                 f"and depth {TRAIN_MESH_ONE_CARD_DEPTH}")
        per = {"d2m2": "in (a)'s emulated forward and backward",
               "d4m1": "in (b)'s step at world size 1"}
        print(f"  phase 30 needs 4 cards for: (a) the layer over NCCL "
              f"against its plain emulation, (b) {TRAIN_MESH_ARCH} at full "
              f"depth on (data 4, model 1) and (data 2, model 2); this "
              f"machine has {n_cards}: (a) ran emulated on card 0, (b) at "
              f"world size 1 and depth {TRAIN_MESH_ONE_CARD_DEPTH}")
    # (c) the kernels at each rank's training shapes, on card 0 alone
    entries = []
    for label, (flash, gmm) in launched.items():
        path = f"train {TRAIN_MESH_ARCH} {label} a rank"
        per_run = per[label]
        for key, n in sorted(flash.items()):
            B, Sq, Sk, Hq, Hkv, d, causal, window = key
            call = calls.get(key) or (
                draw((B, Sq, Hq, d), torch.bfloat16),
                draw((B, Sk, Hkv, d), torch.bfloat16),
                draw((B, Sk, Hkv, d), torch.bfloat16), causal, window, None)
            ok, entry = train_flash_entry(torch, draw, path, n, call,
                                          per_run)
            if not ok:
                fail(f"phase 30 (c): flash at {key} against plain")
            entry["launched"] = where
            entries.append(entry)
        for shape, n in sorted(gmm.items()):
            entry = gmm_entry(torch, dev, path, shape, n, per_run)
            entry["launched"] = where
            entries.append(entry)
    print(f"  phase 30 took {time.perf_counter() - t_phase:.1f} s")
    return entries


# ---------------------------------------------------------------------------
# phase 31: the dry run held against the card
# ---------------------------------------------------------------------------

def count_gaps(card: dict, dry: dict, rows: int = 6) -> str:
    """The aten ops whose calls, FLOPs or bytes differ between two counts
    (``StepCounter``'s ``by_op``), for a failure's message."""
    gaps = [(k, card["by_op"].get(k), dry["by_op"].get(k))
            for k in sorted(set(card["by_op"]) | set(dry["by_op"]))
            if card["by_op"].get(k) != dry["by_op"].get(k)]
    return "; ".join(f"{k}: card {a}, dry run {b}"
                     for k, a, b in gaps[:rows]) or "no aten op differs"


def held_counts(label: str, card: dict, dry: dict, card_peak: int,
                launches: dict) -> list:
    """Print one step's counts on the card beside its dry run's; return
    the problems: dot FLOPs, op-boundary bytes and each kernel op's tally
    must be equal, the tally's calls the launches, and the dry run's peak
    within ``DRY_PEAK_RTOL`` of the card's."""
    problems = []
    rel = (dry["peak_bytes"] - card_peak) / card_peak
    print(f"  (a) {label}: dot FLOPs card {card['dot_flops']:.6e}, dry run "
          f"{dry['dot_flops']:.6e} (aten {dry['aten_flops']:.6e}); "
          f"op-boundary bytes card {card['mem_bytes']}, dry run "
          f"{dry['mem_bytes']}; peak card {card_peak / 1e9:.3f} GB "
          f"(max_memory_allocated less what the card held before the "
          f"inputs), dry run {dry['peak_bytes'] / 1e9:.3f} GB ({rel:+.2%}; "
          f"inputs {dry['input_bytes'] / 1e9:.3f} GB, the card's own "
          f"tracker {card['peak_bytes'] / 1e9:.3f} GB); kernel ops "
          f"{dry['kernel_ops']}; launches {launches}")
    for key in ("dot_flops", "mem_bytes", "kernel_ops"):
        if card[key] != dry[key]:
            problems.append(f"{label} {key}: card {card[key]}, dry run "
                            f"{dry[key]} ({count_gaps(card, dry)})")
    calls = {k: int(v["calls"]) for k, v in card["kernel_ops"].items()}
    if calls != {k: v for k, v in launches.items() if v}:
        problems.append(f"{label}: tally calls {calls}, launches {launches}")
    if abs(rel) > DRY_PEAK_RTOL:
        problems.append(f"{label}: the dry run's peak is {rel:+.2%} of the "
                        f"card's")
    return problems


def dry_one_card(torch, dev) -> tuple:
    """31 (a): granite at full width and depth ``DRY_DEPTH``, one training
    step at 1 x TRAIN_MESH_S and a served prefill of MOE_B x MOE_PROMPT
    then one decode step, each counted on the card and dry-run on
    ``meta``.  Returns (problems, {(kind, shape): launches} of the card's
    runs)."""
    import dataclasses
    from repro_torch.configs import get_config, resolve_for_tp
    from repro_torch.data import structured_unit
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun as D
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    cfg = dataclasses.replace(resolve_for_tp(get_config(MOE_ARCH), 1),
                              n_layers=DRY_DEPTH)
    model = build_model(cfg)
    meta = torch.device("meta")
    problems, shapes = [], {}

    def on_card(run):
        """``run()`` on the card with the peak and launches reset first;
        (its counts, peak, launches); shapes by kernel gathered."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        with flash_tally(keep=False) as (ftally, _), gmm_tally() as gtally:
            out = run()
            torch.cuda.synchronize()
        for key, n in ftally.items():
            shapes[("flash", key)] = shapes.get(("flash", key), 0) + n
        for key, n in gtally.items():
            shapes[("gmm", key)] = shapes.get(("gmm", key), 0) + n
        return out, torch.cuda.max_memory_allocated(dev) - base, \
            dict(_build.LAUNCH_COUNTS)

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    params = model.init(seed=0, device=dev)
    opt = AdamW(lr=constant(TRAIN_LR))
    state = opt.init(params)
    batch = {k: torch.as_tensor(v, device=dev).long() for k, v in
             structured_unit(0, 1, TRAIN_MESH_S, cfg.vocab_size).items()}
    card, peak, launches = on_card(lambda: D.count_train(
        model, opt, params, state, batch))
    del params, state, batch
    mp = model.param_specs()
    mstate = opt.init(mp)
    dry = D.count_train(model, opt, mp, mstate, {
        k: torch.empty((1, TRAIN_MESH_S), dtype=torch.int64, device=meta)
        for k in ("tokens", "labels")})
    problems += held_counts(f"train step 1 x {TRAIN_MESH_S}", card, dry,
                            peak, launches)
    torch.cuda.empty_cache()

    base = torch.cuda.memory_allocated(dev)
    s_max = MOE_PROMPT + MOE_STEPS
    params = model.init(seed=0, device=dev)
    cache = model.init_cache(MOE_B, s_max, device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (MOE_B, MOE_PROMPT),
                                      generator=gen, device=dev)}
    (card, cache), peak, launches = on_card(
        lambda: D.count_prefill(model, params, prompt, cache))
    del prompt
    tok = torch.randint(0, cfg.vocab_size, (MOE_B, 1), generator=gen,
                        device=dev)
    (card_d, cache), peak_d, launches_d = on_card(
        lambda: D.count_decode(model, params, cache, tok))
    del params, cache, tok
    dry, mcache = D.count_prefill(model, mp, {"tokens": torch.empty(
        (MOE_B, MOE_PROMPT), dtype=torch.int64, device=meta)},
        D.meta_cache(model, MOE_B, s_max))
    dry_d, _ = D.count_decode(model, mp, mcache, torch.empty(
        (MOE_B, 1), dtype=torch.int64, device=meta))
    problems += held_counts(f"prefill {MOE_B} x {MOE_PROMPT}", card, dry,
                            peak, launches)
    problems += held_counts(f"decode step at {MOE_PROMPT} of {s_max}",
                            card_d, dry_d, peak_d, launches_d)
    torch.cuda.empty_cache()
    return problems, shapes


def dry_mesh_ranks(torch, cfg, recs: list) -> None:
    """31 (b): each rank's counted step of phase 30 (b) on (data 2, model
    2) against the dry run of its own rank on a fake world of 4: the
    collectives by (op, group size) equal in calls and bytes, dot FLOPs
    equal, the peak within ``DRY_PEAK_RTOL``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    t0 = time.perf_counter()
    model = build_model(cfg)
    problems = []
    print(f"phase 31 (b): each rank's counted step of 30 (b) on (data 2, "
          f"model 2) against its own rank's dry run on a fake world of 4")
    for r, rec in enumerate(recs):
        card = rec["counts"]
        with D.fake_world(4, r):
            mesh = make_host_mesh(model=TRAIN_MESH_TP)
            with shd.use_mesh(mesh):
                params = D.meta_params(model, fsdp=True)
                opt = AdamW(lr=constant(TRAIN_LR))
                dry = D.count_train(model, opt, params, opt.init(params), {
                    k: torch.empty((TRAIN_MESH_B_TP, TRAIN_MESH_S),
                                   dtype=torch.int64, device="meta")
                    for k in ("tokens", "labels")})
        rel = (dry["peak_bytes"] - rec["counted_peak"]) / rec["counted_peak"]
        colls = {k: (int(v["calls"]), int(v["bytes"]))
                 for k, v in card["collectives"].items()}
        dry_colls = {k: (int(v["calls"]), int(v["bytes"]))
                     for k, v in dry["collectives"].items()}
        same = "the same" if colls == dry_colls else dry_colls
        print(f"  rank {r} {rec['coord']}: collectives (calls, bytes) card "
              f"{colls}, dry run {same}; "
              f"dot FLOPs card {card['dot_flops']:.6e}, dry run "
              f"{dry['dot_flops']:.6e}; op-boundary bytes card "
              f"{card['mem_bytes']}, dry run {dry['mem_bytes']}; peak card "
              f"{rec['counted_peak'] / 1e9:.3f} GB, dry run "
              f"{dry['peak_bytes'] / 1e9:.3f} GB ({rel:+.2%}); wire bytes "
              f"a step {card['total_collective_bytes']:.6e}")
        if colls != dry_colls:
            problems.append(f"rank {r} collectives {colls} vs {dry_colls}")
        if card["dot_flops"] != dry["dot_flops"]:
            problems.append(f"rank {r} dot FLOPs {card['dot_flops']} vs "
                            f"{dry['dot_flops']} ({count_gaps(card, dry)})")
        if abs(rel) > DRY_PEAK_RTOL:
            problems.append(f"rank {r}: the dry run's peak is {rel:+.2%} "
                            f"of the card's")
    print(f"  phase 31 (b) took {time.perf_counter() - t0:.1f} s")
    if problems:
        fail("phase 31 (b): " + "; ".join(problems))


def dry_run_phase(torch, dev) -> list:
    """Phase 31; returns its kernels-line entries."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun as D
    t_phase = time.perf_counter()
    print(f"phase 31: the dry run (launch/dryrun.py, op_analysis."
          f"StepCounter) held against the card -- {MOE_ARCH} at full width, "
          f"depth {DRY_DEPTH}")
    if dist.is_initialized():
        fail("phase 31: a process group is still initialised")
    problems, shapes = dry_one_card(torch, dev)
    if problems:
        fail("phase 31 (a): " + "; ".join(problems))
    print(f"  phase 31 needs 4 cards for (b), which python3 chip_smoke.py "
          f"--mesh runs with phase 30")
    for arch, shape, multi, want in DRY_CELLS:
        t0 = time.perf_counter()
        res = D.lower_cell(arch, shape, multi)
        got = D.status(res)
        line = (f"  (c) {arch} x {shape} x {'multi' if multi else 'single'}"
                f": {got} in {time.perf_counter() - t0:.1f} s")
        if got == "ok":
            h = res["hlo"]
            line += (f": peak {res['memory']['peak_bytes_est'] / 2**30:.3f}"
                     f" GiB a device, dot FLOPs {h['dot_flops']:.4e}, "
                     f"op-boundary bytes {h['mem_bytes'] / 2**30:.1f} GiB, "
                     f"collectives {h['total_collective_bytes'] / 2**30:.3f}"
                     f" GiB in {sum(h['collective_counts'].values())} calls "
                     f"{h['collective_counts']}")
        else:
            line += f" ({res.get('item')}: {res['reason'][:100]})"
        print(line)
        if got != want:
            fail(f"phase 31 (c): {arch} x {shape} is {got}; want {want}")
    gen = torch.Generator(device=dev).manual_seed(31)

    def draw(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    entries = []
    path = f"dry run check {MOE_ARCH} depth {DRY_DEPTH}"
    per = "in (a)'s train step, prefill and decode step"
    for (kind, key), n in sorted(shapes.items()):
        if kind == "gmm":
            entries.append(gmm_entry(torch, dev, path, key, n, per))
            continue
        B, Sq, Sk, Hq, Hkv, d, causal, window = key
        call = (draw((B, Sq, Hq, d), torch.bfloat16),
                draw((B, Sk, Hkv, d), torch.bfloat16),
                draw((B, Sk, Hkv, d), torch.bfloat16), causal, window, None)
        ok, entry = zoo_flash_entry(torch, draw, path, n, call, (d, d), per)
        if not ok:
            fail(f"phase 31: flash at {key} against plain")
        entries.append(entry)
    print(f"  phase 31 took {time.perf_counter() - t_phase:.1f} s")
    return entries


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def mesh_label(mesh) -> str:
    return ("cuda:0 x " + str(len(mesh)) if len(set(mesh)) == 1
            else ", ".join(str(d) for d in mesh))


def split_rows(reports) -> np.ndarray:
    """A grid's per-trial ``[t_comp, iterations, n_comm]`` rows."""
    return np.concatenate([np.stack([r.t_comp_trials, r.iterations_trials,
                                     r.n_comm_trials], 1) for r in reports])


def split_grid(dev, devices, specs, trials: int, backend: str, seed: int):
    """Figure 5's ``work_exchange_unknown`` grid at paper scale under
    ``grid_sharding(devices)``, its trials kept."""
    from repro_torch.core import get_scheme
    from repro_torch.core.samplers import grid_sharding
    with grid_sharding(devices, device=dev):
        return get_scheme("work_exchange_unknown").mc_grid(
            specs, N_PAPER, trials, np.random.default_rng(seed),
            keep_trials=True, backend=backend, device=dev)


def geo_serving(dev, devices, specs) -> list:
    """The fig-load point's ``work_exchange`` sweep on the torch serving
    engine with geometric job sizes (one generator stream a shard) under
    ``grid_sharding(devices)``: its reports."""
    from repro_torch.core.samplers import grid_sharding
    from repro_torch.serving import ServingConfig, run_serving_grid
    cfg = ServingConfig(loads=FIG_LOAD_LOADS_QUICK, slots=400,
                        deadline_slo=FIG_LOAD_SLO, job_units_dist="geometric",
                        backend="torch")
    with grid_sharding(devices, device=dev):
        return run_serving_grid("work_exchange", {}, specs, cfg, FIG_LOAD_N,
                                GEO_SPLIT_TRIALS, 17, device=dev)


def split_checks(torch, dev, mesh, specs, exact, card) -> tuple:
    """Phase 28 (c) over one device tuple: the ``cuda`` split (each shard
    one kernel launch, bitwise its plain version on the same card tensors,
    and within phase 3's row tolerance of the same split run by its plain
    version on the CPU), the ``torch`` split (seed-deterministic, within 6
    SE of phase 20's numpy panel) and the serving split over the first
    ``SERVE_SPLIT_D`` devices (a quick fig-load study, whose fixed job
    sizes draw nothing on the device, bitwise the unsplit one and within
    phase 24's bands of the stored numpy entry; and a sweep with geometric
    job sizes, one generator stream a shard, seed-deterministic and within
    6 combined SE of the unsplit sweep).  Returns (problems, the row
    split's ``we_rounds`` entry)."""
    import repro_torch.experiments as ex
    from repro_torch.core.samplers import grid_sharding
    from repro_torch.kernels.we_rounds import kernel as wk
    from repro_torch.kernels.we_rounds import ops as wops
    from repro_torch.kernels.we_rounds import ref as wref
    from repro_torch.serving import scan
    problems = []
    label = mesh_label(mesh)
    name = "work_exchange_unknown"

    def run(device, devices, trials, backend, seed):
        return split_grid(device, devices, specs, trials, backend, seed)

    wk.reset_launch_counts()
    with recorded_calls(wops, "we_rounds_cuda") as calls:
        t0 = time.perf_counter()
        run(dev, mesh, TRIALS, "cuda", 28)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = wk.LAUNCH_COUNTS["we_rounds"]
    bitwise = []
    for (rows, seed, sched, flags), kw in calls:
        got = wk.we_rounds_cuda(rows, seed, sched, flags, **kw)
        want = torch.stack(wref.we_rounds_reference(
            rows, seed, sched, known=kw["known"],
            **{k: kw[k] for k in ("n0", "threshold", "cap", "max_iter")}),
            dim=1)
        bitwise.append(bool(torch.equal(got, want)))
    shapes = sorted({tuple(c[0][0].shape) for c in calls})
    print(f"  (c) cuda split over {label}: {launches} we_rounds launches "
          f"({shapes} rows x workers each), {wall * 1e3:.3f} ms ({card}); "
          f"each launch bitwise its plain version on the card: {bitwise}")
    if launches != len(mesh) or len(calls) != len(mesh):
        problems.append(f"cuda split over {label}: {launches} launches")
    if not all(bitwise):
        problems.append(f"cuda split over {label}: a shard's launch is not "
                        f"bitwise its plain version")
    ok_b, entry = we_rounds_entry(torch, f"row split ({label})", launches,
                                  1, calls)
    small_card = split_rows(run(dev, mesh, SPLIT_CPU_TRIALS, "cuda", 29))
    small_cpu = split_rows(run("cpu", len(mesh), SPLIT_CPU_TRIALS, "cuda",
                               29))
    ok, stats = compare(torch, torch.from_numpy(small_card),
                        torch.from_numpy(small_cpu))
    print(f"  (c) the same split at {SPLIT_CPU_TRIALS} trials, card against "
          f"its plain version over {len(mesh)} CPU shards: "
          f"{'ok' if ok else 'FAIL'} " + " ".join(
              f"{k}={v:.3e}" for k, v in stats.items()))
    if not ok:
        problems.append(f"cuda split over {label}: card against CPU")

    a = run(dev, mesh, TRIALS, "torch", 30)
    b = run(dev, mesh, TRIALS, "torch", 30)
    same = np.array_equal(split_rows(a), split_rows(b))
    gaps = [mean_gap(r, exact[name][g]) for g, r in enumerate(a)]
    print(f"  (c) torch split over {label}: same seed twice bitwise "
          f"{same}; {name} against phase 20's numpy panel, worst "
          f"{max(gp for gp, _ in gaps):.3f} SE over {len(gaps)} points")
    if not same or not all(ok for _, ok in gaps):
        problems.append(f"torch split over {label}: deterministic {same}, "
                        f"gaps {[round(gp, 2) for gp, _ in gaps]}")

    serve_mesh = mesh[:SERVE_SPLIT_D]
    spec_t = fig_load_experiment(ex, "stationary", True, backend="torch")
    stored = json.loads(next(
        path for path in sorted((ROOT / "results" / "store").glob("*.json"))
        if json.loads(path.read_text())["spec"]["name"] == spec_t.name
    ).read_text())
    want = ex.ExperimentResult.from_dict(stored)
    whole = ex.run_experiment(spec_t, device=dev)
    with grid_sharding(serve_mesh, device=dev), \
            recorded_sweeps(scan) as sweeps:
        t0 = time.perf_counter()
        split = ex.run_experiment(spec_t, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    equal = split.to_dict()["reports"] == whole.to_dict()["reports"]
    bad, worst, _ = serving_checks(split, want, sweeps, spec_t.N)
    print(f"  (c) serving split over {', '.join(map(str, serve_mesh))}: "
          f"{spec_t.name} on torch {wall:.3f} s ({card}); reports == the "
          f"unsplit run's: {equal}; against the stored numpy entry t_comp "
          f"worst {worst['t_comp']:.3f} SE, percentiles worst "
          f"{worst['pct']:.3f} of their own SE; {len(bad)} problems")
    if not equal:
        problems.append("serving split: reports differ from the unsplit run")
    problems += [f"serving split: {p}" for p in bad]

    def serve(devices):
        return geo_serving(dev, devices, spec_t.grid.specs())

    whole = serve(1)
    t0 = time.perf_counter()
    a = serve(serve_mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = [r.to_dict() for r in a] == [r.to_dict() for r in serve(serve_mesh)]
    gaps = [abs(x.t_comp - y.t_comp) * np.sqrt(GEO_SPLIT_TRIALS)
            / np.hypot(x.t_comp_std, y.t_comp_std) for x, y in zip(whole, a)]
    print(f"  (c) serving split over {', '.join(map(str, serve_mesh))} with "
          f"geometric job sizes (work_exchange, {len(a)} loads x "
          f"{GEO_SPLIT_TRIALS} trials): {wall:.3f} s ({card}); same seed "
          f"twice bitwise {same}; against the unsplit sweep t_comp worst "
          f"{max(gaps):.3f} combined SE")
    if not same or not max(gaps) < MEAN_SE:
        problems.append(f"geometric serving split: deterministic {same}, "
                        f"gaps {[round(float(g), 2) for g in gaps]}")
    return problems, entry


def distinct_card_checks(torch, ex, dev, one, many, specs, card) -> list:
    """Phase 28 (c) where there are several cards: the ``cuda`` and
    ``torch`` splits over the distinct cards ``many`` and the geometric
    serving split over the first ``SERVE_SPLIT_D`` of them give the bits
    of the same shards on card 0 (``one``); prints the warm walls of both,
    the shards run one after another.  Returns the problems."""
    problems = []
    serve_specs = fig_load_experiment(ex, "stationary", True).grid.specs()
    pairs = [(f"{b} split", lambda m, b=b: split_rows(
        split_grid(dev, m, specs, TRIALS, b, 28)), one, many)
             for b in ("cuda", "torch")]
    pairs.append(("geometric serving split", lambda m: [
        r.to_dict() for r in geo_serving(dev, m, serve_specs)],
        one[:SERVE_SPLIT_D], many[:SERVE_SPLIT_D]))
    for what, go, a, b in pairs:
        got, walls = {}, {}
        for m in (a, b):
            go(m)
            t0 = time.perf_counter()
            got[m] = go(m)
            torch.cuda.synchronize()
            walls[m] = time.perf_counter() - t0
        same = (np.array_equal(got[a], got[b])
                if isinstance(got[a], np.ndarray) else got[a] == got[b])
        print(f"  (c) {what} over {mesh_label(b)}: the bits of the same "
              f"shards on card 0 {same}; warm {walls[b] * 1e3:.3f} ms "
              f"against {walls[a] * 1e3:.3f} ms on card 0, the shards one "
              f"after another ({card})")
        if not same:
            problems.append(f"{what} over {mesh_label(b)}: not the bits of "
                            f"card 0's shards")
    return problems


def fluid_phase(torch, dev, points, specs, exact, cuda_wall: float) -> list:
    """Phase 28: (a) the ``torch`` backend at paper scale, the Figure 5
    panel through ``mc_grid_panel(..., backend="torch")``: the 28 claims,
    the pair within 6 SE (or 2e-3) of phase 20's numpy panel, the same
    seed twice the same report, the panel's warm wall beside phase 5's
    ``cuda`` wall, the device's busy share and the host reads a round;
    (b) the ``drifting`` demo spec on ``torch`` against ``numpy``; (c)
    ``split_checks`` over 4 shards of card 0 (and, where there are
    several cards, over distinct cards and ``distinct_card_checks``); (d) the three examples with ``--device
    cuda``, side by side, once every timed part has had the card to
    itself.  Returns the row split's ``we_rounds`` entries."""
    import repro_torch.experiments as ex
    from repro_torch.core import fluid, get_scheme, mc_grid_panel
    from repro_torch.core.samplers import grid_devices
    from repro_torch.experiments.__main__ import demo_spec
    card = card_line()
    print(f"phase 28: the torch backend, the row split and the examples "
          f"({card})")
    t_phase = time.perf_counter()
    problems, entries = [], []
    # (c) the row split
    meshes = [(dev,) * SPLIT_D]
    if torch.cuda.device_count() > 1:
        meshes.append(grid_devices(SPLIT_D, dev))
        print(f"  {torch.cuda.device_count()} cards: (c) runs again "
              f"over {', '.join(map(str, meshes[1]))}")
    for mesh in meshes:
        bad, entry = split_checks(torch, dev, mesh, specs, exact, card)
        problems += bad
        entries.append(entry)
    if len(meshes) > 1:
        problems += distinct_card_checks(torch, ex, dev, *meshes, specs, card)

    # (b) one drifting spec on torch against numpy
    spec = demo_spec("drifting").replace(trials=TRIALS)
    t0 = time.perf_counter()
    fl = ex.run_experiment(spec.replace(backend="torch"), device=dev)
    torch.cuda.synchronize()
    fl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    npy = ex.run_experiment(spec.replace(backend="numpy"), device=dev)
    np_s = time.perf_counter() - t0
    gaps = {(k, g): mean_gap(a, b) for k in fl.keys()
            for g, (a, b) in enumerate(zip(fl.report(k),
                                           npy.report(k)))}
    worst = max(gp for gp, _ in gaps.values())
    print(f"  (b) {spec.name} ({len(spec.schemes)} schemes x "
          f"{len(spec.grid)} points x {spec.trials} trials): torch on "
          f"the card {fl_s:.3f} s ({card}), numpy {np_s:.3f} s; torch "
          f"against numpy worst {worst:.3f} SE")
    problems += [f"drifting {k}[{g}] {gp:.2f} SE from numpy"
                 for (k, g), (gp, ok) in gaps.items() if not ok]

    # (a) the torch backend at paper scale
    schemes = {n: get_scheme(n) for n in SCHEMES}

    def run_panel():
        out = mc_grid_panel(schemes, specs, N_PAPER, TRIALS,
                            np.random.default_rng(1234), backend="torch",
                            device=dev)
        torch.cuda.synchronize()
        return out

    fluid.reset_host_reads()
    t0 = time.perf_counter()
    reports = run_panel()
    first_s = time.perf_counter() - t0
    reads = dict(fluid.HOST_READS)
    print(f"  (a) fig5 panel on torch, K={K_PAPER} N={N_PAPER} trials="
          f"{TRIALS} grid={len(specs)}: {first_s:.3f} s (first run, "
          f"{card}); {reads['rounds']} rounds, {reads['reads']} host reads "
          f"({reads['reads'] / max(reads['rounds'], 1):.3f} a round)")
    checks = fig5_table(points, specs, reports)
    for g, ((mu, label), _) in enumerate(zip(points, specs)):
        for n in WE_PAIR:
            gap, ok = mean_gap(reports[n][g], exact[n][g])
            checks.append((f"torch {n}[mu={mu:g},s2={label}] within "
                           f"{MEAN_SE:g} SE of numpy ({gap:.2f})", ok))
    again = run_panel()
    same = all(a.to_dict() == b.to_dict() for n in SCHEMES
               for a, b in zip(reports[n], again[n]))
    checks.append(("torch panel: the same seed twice, the same report",
                   same))
    bad = [name for name, ok in checks if not ok]
    worst = max(mean_gap(reports[n][g], exact[n][g])[0]
                for n in WE_PAIR for g in range(len(specs)))
    print(f"  (a) paper-claim and numpy checks on torch: "
          f"{len(checks) - len(bad)}/{len(checks)} passed; the pair's worst "
          f"gap to numpy {worst:.3f} SE")
    problems += bad
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_panel()
        wall = min(wall, time.perf_counter() - t0)
    print(f"  (a) fig5 panel wall (6 schemes, 8 points x {TRIALS} trials): "
          f"torch {wall * 1e3:.3f} ms, cuda {cuda_wall * 1e3:.3f} ms "
          f"(phase 5) (warm min of 3, {card})")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_panel()
        prof_wall = time.perf_counter() - t0
    dev_us = sum(e.self_device_time_total for e in device_rows(torch, prof)[0]
                 if e.self_device_time_total > 0)
    share = 100 * dev_us / (prof_wall * 1e6)
    print(f"  (a) profiled torch panel: wall {prof_wall * 1e3:.3f} ms, "
          + (f"device busy {dev_us / 1e3:.3f} ms ({share:.2f}% of wall)"
             if dev_us > 0 else "the profiler recorded no device time "
             "(busy share not measured)") + f" ({card})")
    # (d) the examples, side by side, after every timed part
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    procs = {}
    try:
        for script, args, _ in EXAMPLES:
            procs[script] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, f"examples/{script}", "--device", dev.type,
                 *args], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env))
        for script, _, lines in EXAMPLES:
            t0, proc = procs[script]
            out, err = proc.communicate(timeout=600)
            missing = [x for x in lines if x not in out]
            tail = (out.strip().splitlines() or [err.strip()])[-1]
            print(f"  (d) examples/{script} --device {dev.type}: exit "
                  f"{proc.returncode} in {time.perf_counter() - t0:.1f} s "
                  f"({card}, the three side by side); healthy lines "
                  f"{len(lines) - len(missing)}/{len(lines)}; last: "
                  f"{tail[:90]}")
            if proc.returncode != 0 or missing:
                problems.append(f"examples/{script}: exit {proc.returncode}"
                                f", missing {missing}: {err.strip()[-300:]}")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"  phase 28 took {time.perf_counter() - t_phase:.1f} s")
    if problems:
        fail("phase 28: " + "; ".join(problems[:12]))
    return entries


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a repo checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.core import HetSpec, get_scheme, mc_grid_panel
    from repro_torch.core import samplers
    from repro_torch.kernels.we_rounds import kernel as wk
    from repro_torch.kernels.we_rounds import ref as wref

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    if sys.argv[1:] == ["--granite-serve"]:
        granite_serve(torch, dev)
        return
    if sys.argv[1:] not in ([], ["--mesh"], ["--dry-run"]):
        fail(f"unknown arguments {sys.argv[1:]}; the options are "
             f"--granite-serve, --mesh and --dry-run")

    # 2. build every kernel from the checkout's sources, all at once
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.linear_scan import kernel as lk
    from repro_torch.kernels.moe_gmm import kernel as gk
    t0 = time.perf_counter()
    built = _build.build_all([wk.LIBRARY, lk.LIBRARY, fk.LIBRARY,
                              gk.LIBRARY])
    for lib, build_s in built.values():
        print(f"build: {lib.relative_to(ROOT)} in {build_s:.2f} s")
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s wall")
    if sys.argv[1:] in (["--mesh"], ["--dry-run"]):
        if sys.argv[1:] == ["--mesh"]:
            alone = mesh_phase(torch, dev) + train_mesh_phase(torch, dev)
        else:
            alone = dry_run_phase(torch, dev)
        print(json.dumps({"kernels": alone}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    # the bf16 tensor-core kernels, both scan designs and the main path's
    # we_rounds instance: registers, and no spill
    for label, lib, part in [
            ("flash_attention tc d=64", fk.LIBRARY, "flash_tc_kernelILi64E"),
            ("flash_attention tc d=256", fk.LIBRARY,
             "flash_tc_kernelILi256E"),
            ("expert_matmul tc prefill (wgmma)", gk.LIBRARY,
             "expert_matmul_wgmma_kernel"),
            ("expert_matmul tc decode (mma.sync)", gk.LIBRARY,
             "expert_matmul_tc_kernel"),
            ("linear_scan ring", lk.LIBRARY, "linear_scan_ring_kernel"),
            ("linear_scan direct", lk.LIBRARY, "linear_scan_kernel"),
            ("we_rounds CPL 2 (K <= 64: the main path)", wk.LIBRARY,
             "we_rounds_kernelILi2EE")]:
        found = [u for fn, u in ptxas_usage(lib.report()).items()
                 if part in fn]
        if not found:
            fail(f"no ptxas report for {label} in {lib.name}'s build")
        for regs, st, ld in found:
            print(f"ptxas: {label}: {regs} registers, {st} bytes spill "
                  f"stores, {ld} bytes spill loads")
            if st or ld:
                fail(f"{label} spills registers")

    # 3. kernel against its plain version at the Figure 5 shape
    points, specs = fig5_specs(HetSpec)
    rows_np, flags_np = panel_rows(specs, TRIALS, samplers)
    rows = torch.from_numpy(rows_np).to(dev)
    flags = torch.from_numpy(flags_np).to(dev)
    sched = torch.from_numpy(ar1_schedule(rows_np, 48, seed=7)).to(dev)
    seed = [int(s) for s in np.random.default_rng(2024).integers(
        0, 2 ** 32, size=2, dtype=np.uint32)]
    threshold = 0.01 * N_PAPER / K_PAPER
    cap_u = float(np.ceil(N_PAPER / K_PAPER))
    base = dict(n0=float(N_PAPER), threshold=threshold, max_iter=10_000)
    modes = {
        "known": (None, None, dict(cap=float("inf"), known=True)),
        "unknown": (None, None, dict(cap=cap_u, known=False)),
        "drift": (sched, None, dict(cap=cap_u, known=False)),
        "panel": (None, flags, dict(cap=cap_u, known=False)),
    }
    print(f"kernel vs plain at {tuple(rows.shape)} rows x workers, "
          f"seed {seed}")
    max_abs_err = 0.0
    failed = []
    for mode, (s, f, kw) in modes.items():
        got = wk.we_rounds_cuda(rows, seed, s, f, **base, **kw)
        torch.cuda.synchronize()
        if f is not None:
            cols = wref.we_rounds_reference_panel(rows, seed, f, s, **base,
                                                  cap=kw["cap"])
        else:
            cols = wref.we_rounds_reference(rows, seed, s, **base, **kw)
        want = torch.stack(cols, dim=1)
        torch.cuda.synchronize()
        ok, stats = compare(torch, got, want)
        bitwise = bool(torch.equal(got, want))
        max_abs_err = max(max_abs_err, stats["t_comp_max_abs"])
        print(f"  {mode:8s} {'ok' if ok and bitwise else 'FAIL'} "
              + " ".join(f"{k}={v:.3e}" for k, v in stats.items())
              + f" bitwise={bitwise}")
        if not ok:
            failed.append(f"kernel vs plain, {mode} mode")
        if not bitwise:
            failed.append(f"kernel vs plain, {mode} mode, not bitwise")
    if failed:
        fail("; ".join(failed))

    # 4. the main path at paper scale
    schemes = {name: get_scheme(name) for name in SCHEMES}

    def run_panel():
        return mc_grid_panel(schemes, specs, N_PAPER, TRIALS,
                             np.random.default_rng(1234), backend="cuda",
                             device="cuda")

    wk.reset_launch_counts()
    t0 = time.perf_counter()
    reports = run_panel()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(wk.LAUNCH_COUNTS)
    print(f"main path: fig5 panel, K={K_PAPER} N={N_PAPER} trials={TRIALS} "
          f"grid={len(specs)}: {first_s:.3f} s (first run); launches "
          f"{launches}")
    if launches["we_rounds"] < 1:
        fail("the main path launched the we_rounds kernel no time")
    checks = fig5_table(points, specs, reports)
    bad = [name for name, ok in checks if not ok]
    print(f"paper-claim checks: {len(checks) - len(bad)}/{len(checks)} "
          f"passed")
    if bad:
        fail("claim checks failed: " + "; ".join(bad))

    # 5. times (warm minimum of 3)
    def kernel_fn(r, fl):
        return lambda: wk.we_rounds_cuda(r, seed, None, fl, **base,
                                         cap=cap_u, known=False)

    def plain_fn(r, fl):
        return lambda: wref.we_rounds_reference_panel(r, seed, fl, **base,
                                                      cap=cap_u)

    rows_big_np, flags_big_np = panel_rows(specs, 8 * TRIALS, samplers)
    bounds = {}
    sizes = {rows.shape[0]: (rows, flags),
             rows_big_np.shape[0]: (torch.from_numpy(rows_big_np).to(dev),
                                    torch.from_numpy(flags_big_np).to(dev))}
    times = {}
    for B, (r, fl) in sizes.items():
        times[B] = (cuda_ms(torch, kernel_fn(r, fl)),
                    cuda_ms(torch, plain_fn(r, fl)))
        # the bound from this run's rows
        out = kernel_fn(r, fl)()
        bound, by, ops, nbytes = we_rounds_bound(r, out, (fl,))
        bounds[B] = (bound, by)
        print(f"we_rounds at {B} rows: kernel {times[B][0]:.4f} ms, plain "
              f"{times[B][1]:.4f} ms; bound {bound:.4f} ms by {by} "
              f"({ops:.4e} int ops, {nbytes} bytes; "
              f"{float(out[:, 1].double().mean()):.3f} rounds a row); "
              f"{bound / times[B][0]:.3f} of the bound")
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_panel()
        torch.cuda.synchronize()
        wall = min(wall, time.perf_counter() - t0)
    print(f"fig5 panel wall (6 schemes, 8 points x {TRIALS} trials): "
          f"{wall * 1e3:.3f} ms (warm min of 3)")

    # where the panel's time goes: each scheme group alone (the pair is
    # one fused launch), then one profiled panel for the device's share
    groups = {n: (n,) for n in SCHEMES[:4]}
    groups["work_exchange pair"] = ("work_exchange", "work_exchange_unknown")
    for label, names in groups.items():
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            mc_grid_panel({n: schemes[n] for n in names}, specs, N_PAPER,
                          TRIALS, np.random.default_rng(1234),
                          backend="cuda", device="cuda")
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        print(f"  panel part {label:20s} {best * 1e3:9.3f} ms")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_panel()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev_events = [e for e in device_rows(torch, prof)[0]
                  if e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in dev_events)
    if dev_us > 0:
        print(f"profiled panel: wall {prof_wall * 1e3:.3f} ms, device busy "
              f"{dev_us / 1e3:.3f} ms ({100 * dev_us / (prof_wall * 1e6):.2f}"
              f"% of wall); top device time:")
        for e in sorted(dev_events, key=lambda e: -e.self_device_time_total
                        )[:6]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<4d} {e.key[:70]}")
    else:
        print("profiled panel: the profiler recorded no device time "
              "(device busy share not measured)")

    B0 = rows.shape[0]

    def clock(phases: str) -> None:
        print(f"[{phases} done {time.perf_counter() - t_start:.1f} s after "
              f"the start]")

    clock("phases 1-5")
    serve_kernels = serve_phases(torch, dev)
    clock("phases 7-9")
    moe_kernels = moe_phases(torch, dev)
    clock("phases 10-13")
    train_kernels = train_phases(torch, dev)
    clock("phases 14-19")
    exact = exact_oracle_phase(torch, dev, points, specs)
    clock("phase 20")
    het_kernels = het_phases(torch, dev)
    clock("phases 21-22")
    experiment_kernels = experiment_phase(torch, dev)
    clock("phase 23")
    serving_phase(torch, dev)
    clock("phase 24")
    live_phase(torch, dev)
    clock("phase 25")
    zoo_kernels = zoo_phase(torch, dev)
    clock("phase 26")
    launcher_phase(torch, dev)
    clock("phase 27")
    fluid_kernels = fluid_phase(torch, dev, points, specs, exact, wall)
    clock("phase 28")
    mesh_kernels = mesh_phase(torch, dev)
    clock("phase 29")
    train_mesh_kernels = train_mesh_phase(torch, dev)
    clock("phase 30")
    dry_kernels = dry_run_phase(torch, dev)
    clock("phase 31")
    print(json.dumps({"kernels": [{
        "name": "we_rounds", "path": "fig5 panel", "route": "cuda",
        "source": "src/repro_torch/csrc/we_rounds.cu",
        "replaces": "src/repro/kernels/we_rounds/kernel.py:65",
        "launches": launches["we_rounds"],
        "max_abs_err": max_abs_err,
        "ms": times[B0][0], "plain_ms": times[B0][1],
        "bound_ms": bounds[B0][0], "bound_by": bounds[B0][1],
        "library_ms": None}] + serve_kernels + moe_kernels
        + train_kernels + het_kernels + experiment_kernels
        + zoo_kernels + fluid_kernels + mesh_kernels
        + train_mesh_kernels + dry_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
