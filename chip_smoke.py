#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0):

1. build: every CUDA kernel of the port, compiled by nvcc from the
   checkout's sources, all at once (nos_tpu_torch/ops/_build.py);
1a. sharing (before this process makes its first CUDA call):
    nos_tpu_torch.demos.sharing at 1 and 3 clients, 3 s windows, each a
    process running ResNet-50 (bf16, B 8, 224², channels_last, seed 0):
    time-sliced rows; MPS rows under a private nvidia-cuda-mps-control
    daemon, each client held to SharedGpu's slice of 80 GB for N equal
    slices; MIG rows on MIG instances MigGpu carves, only if MIG mode is
    already on. Each client's first-batch logits against the solo
    client's (within 2e-2 of its largest); the mean and p50 latency a
    client and the aggregate images/s beside the solo figures; a row the
    machine forbids prints "not run: <reason>"; no MPS process may be
    left alive;
1b. nvml: nos_tpu_torch.device.nvml (ctypes over libnvidia-ml.so.1)
    against torch: the device count, name and UUID equal, the memory
    totals side by side, the MIG mode (current and pending); the H100
    MIG table (nos_tpu_torch.gpu.known) against NVML's profile info and
    placements field by field where NVML gives them ("not checked:
    <NVML's error>" where it refuses); a 1g.10gb instance created, read
    back and destroyed in a finally only if MIG mode is already on. The
    MIG mode is never changed;
1c. migagent: nos_tpu_torch.controllers.migagent over NVML must refuse
    a GPU whose MIG mode is off ("nvml_agent": "not run: MIG mode
    disabled (current c, pending p)", the refusal's text checked); only
    where MIG is on, the agent applies one more 1g.10gb on GPU 0, acks
    it and removes it (what it made deleted in a finally). Then the
    agent on its own thread over SimMigClient (an H100 80GB) through
    the re-carve 7g.80gb -> 3g.40gb + 3g.40gb: milliseconds from spec to
    ack, the instances, allocatable and status annotations; the
    kubelet's pod-resources client only where its socket exists;
1d. partitioner: the dynamic-partitioning loop (nos_tpu_torch.cluster)
    on two MIG nodes, the first with the card's own NVML identity (its
    product must be gpu/known.py's H100 row, its GPU count torch's; its
    instances live on the sim pool, MIG mode being off), the second of
    8 H100s, and an MPS node of 8: 40 seeded pending pods across
    1g.10gb ... 7g.80gb and gpu-10gb / gpu-20gb, run until idle, then
    every pod Running or unserved with a reason, every reported
    geometry allowed, every plan acknowledged, no GPU over-committed
    (pods placed, plans applied, steps, seconds); then cold plans at 64
    nodes x 8 H100s with 200 pending pods (bench_planner, 3 repeats,
    verdict cache on and off: p50 / p95 ms, forks a second, the hit
    rate, the host's CPU count) on a busy, fragmented cluster whose
    demand exceeds its free supply, the cache-on plan equal to the
    cache-off one and the cache answering some of its trials; the
    planner runs the simulation framework SimCluster plans with (the
    vanilla filters and CapacityScheduling's PreFilter, over a store of
    the cluster with a quota that admits every pod), and the vanilla
    filters alone in the same run, whose plans must agree;
1d1. kube: the kube substrate over HTTP (kube_phase): the port's stub
    API server on 127.0.0.1, two replicas each a KubeApiStore, a
    LeaderElector and, while it leads, a threaded Manager feeding a
    ClusterState (state-node / state-pod); through the API 32 MIG nodes
    of 8 H100s (256 GPUs, the first with the card's product as NVML
    names it), 400 pods, 300 bound through the binding subresource with
    an event a bind, the first leader releasing, 50 finished, 50
    deleted: every cache equal to the server, the leader's state equal
    to a whole sync of its cache, every kind delivered in resource
    version order, never two leaders and a handover, events deduplicated
    (counts summing to the binds); printed: a fresh store's list+watch
    sync, the HTTP writes' p50 / p99, the create-to-ClusterState lag and
    the handover, in ms;
1e. quota: elastic quotas and fair-share preemption (quota_phase) on a
    SimCluster of 20 nodes (the card's own MIG node, 15 more MIG nodes
    and 4 MPS nodes of 8 H100s); team-a, team-b and team-c hold quotas
    in nos.nebuly.com/gpu-memory of 40 / 30 / 30% of the fleet's GB
    (max unset / 60% / unset); team-a's 200 pods borrow past its min,
    then team-b's and team-c's 50 each, within their min, reclaim by
    preemption; team-b within its max and the quotas' use within the
    sum of their mins at every step, team-a's pods past its min labelled
    over-quota, every victim an over-quota pod of the borrowing quota,
    the second wave all Running (any pod of it that is not is listed
    with its reason) and within min plus its guaranteed share, and
    SimCluster.check() (the quotas'
    invariants among its own); pods placed and unserved, each quota's
    used against min and max, the preemptions and their victims by
    namespace, the loop's steps and seconds, and the p50 / p95 ms of
    binding, nominating (preempting) and failing cycles;
1f. gang: gangs, multi-node expansion, the drain reservation, topology
    scoring and the affinity and spread filters (gang_phase) on a
    SimCluster of 37 nodes: the card's own MIG node in a pool of its
    own, 32 MIG nodes of 8 H100s in 4 node pools of 8, 4 MPS nodes of
    8. Seeded waves: an F3 input built on purpose (the only free 20 GB
    slices on two MPS nodes, one with memory never carved, then a pod
    asking for 2 x gpu-20gb); a serving Deployment of 16 replicas spread
    by hostname (maxSkew 1) with required anti-affinity on its own
    label; multi-node jobs of 24, 32 and 16 nvidia.com/gpu (3, 4 and 2
    members of 8 x 7g.80gb) in that order, fault F6's input (job-16 must
    form whole in another pool than the first two), and a 16-GPU gang
    borrowing past its quota;
    an 80-GPU job no pool holds, watched through two Permit timeouts and
    cancelled; 300 single-pod jobs of the quota mix; the quota within its
    min reclaiming the borrowed GPUs; a single-node job of 8 x 7g.80gb
    that waits past min_wait, gets a drain, and binds once the drained
    node's jobs finish. SimCluster.check_gangs() (gangs whole, in one
    pool, ranks and coordinator, at most one drain, no stale reservation)
    at every step, the 80-GPU job never bound and waiting in one pool,
    the replicas' skew at most 1 and anti-affinity kept; at the end the
    F3 pod Running, every fitting gang bound in one pool, the reclaimed
    gang evicted whole, the drain's holder bound and released, and
    SimCluster.check(); the whole-GPU instances carved for the 80-GPU
    job, steps, seconds and cycle p50 / p95 ms by decision (bind, wait,
    nominate, fail);
1g. control_bench: bench.py's control-plane half
    (nos_tpu_torch.bench_control_plane.run_control_plane_bench at
    ControlPlaneSizes.quick(): 8 MIG nodes of 8 H100s in one pool, the
    stream cut to 8 virtual seconds; fill, stream, contention, churn,
    a 64-GPU multi-node job) with SimCluster.check_gangs() on every step;
    fails unless the borrow converges, the fair share is restored, the
    gang forms, every churn turn converges and SimCluster.check() holds
    after each phase; prints every key, the time keys on the cluster's
    virtual clock, each phase's wall seconds beside the card;
1h. pools: pool-sharded planning (pools_phase) on a SimCluster of 289
    H100s: 4 pools of 8 MIG nodes of 8, a fifth pool of 4 MPS nodes of 8
    and the card's own MIG node, three quotas with min = max. Wave 1
    (300 jobs of the quota mix pinned round-robin by node selector, a
    16-GPU gang pinned to one pool) runs unsharded, sharded on the
    serial backend and sharded on worker processes (one worker killed
    after the first plan); wave 2 adds one unpinned pod, which merges
    every pool; wave 3 restarts a controller from the warm-state file
    beside a cold one. Fails unless the serial and process runs end
    alike (placements, geometries, unserved reasons), each equals the
    unsharded run wherever the draw decomposed at every plan,
    check_gangs() holds at every step and check() at the end, the
    killed pool's next plan escalated and the one after ran on a
    respawned worker, wave 2 merged the pools, and the restart adopted
    and planned as the cold start; prints pools a plan, pool and merge
    ms, each worker's start-to-bootstrapped s, whether torch was in a
    worker, frame bytes a plan, adopted entries, each run's steps and s;
1i. components: the components on the Manager (components_phase).
    (a) build_cluster, every component threaded on one in-memory store
    in wall time: 16 MIG nodes of 8 H100s in 2 node pools and 4 MPS
    nodes of 8 (160 GPUs), 240 pods of 1g.10gb ... 7g.80gb and 10 / 20 /
    40 GB MPS slices in two quota namespaces (one borrowing) and the
    default one, a 2-member 7g.80gb gang, a plain nvidia.com/gpu: 12 pod
    for the multi-node expander and a ModelServing of 2 replicas, at
    about 84% of the fleet's GB: every pod Running within 60 s, the gangs
    in one pool, the quotas within max, /debug/explain for a pod made
    unschedulable on purpose, /healthz /readyz /metrics, SimCluster's
    invariants on the store, and the same description through the
    polled SimCluster; (b) one process a component (python -m
    nos_tpu_torch ...) on the stub API server through a JSON
    kubeconfig: operator, partitioner, autoscaler, two schedulers under
    leader election, a MIG and an MPS agent on the sim devices, and a
    MIG agent on NVML that must exit 1 with the MIG-off refusal: every
    /healthz 200, pods bound on advertised slices, a plan written for a
    profile nobody advertises, a bind within the lease and 5 s after
    SIGTERM to the leading scheduler, every process exiting 0 on
    SIGTERM; prints the wall s to all Running, reconciles by controller
    kind, plans applied, each process's start-to-healthy s and the bind
    after the handover;
1j. observability: the observability plane (observability_phase): the
    store and observability benches at reference() size, then the
    threaded suite of 1i's nodes and COMPONENTS_MIX's 240 pods in its two
    quotas, with the health timeline, the profiler, the flight recorder
    and the auditor at rate 1: the debug endpoints gated, no finding
    while healthy, a wedged worker's stall finding and HealthDegraded
    event;
1k. record: the flight recorder, the auditor and replay on 1j's log
    (record_phase): every record kind the suite makes, the ring within
    its capacity, no live audit violation, the components' events,
    /debug/record 401 / 200 with as many JSONL lines as the ring; the
    log replayed in process with 0 drift(s) and 0 audit violation(s)
    (host seconds and the audits' share printed), and a copy with one
    node's GPUs taken away replayed with drift and a nonzero exit code;
2. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the Llama-3-8B attention shapes (Hq 32, Hkv 8, hd 128,
   bf16), with CUDA-event times of the kernel, the plain version, one
   PyTorch library call (SDPA, a yardstick the port never calls) and the
   card's bound for the same work, the kernel's and SDPA's device time
   from torch.profiler (CUDA events around one call measure the host
   where it is the slower side, as at [2, 512]), plus untimed cases at
   the forward kernel's 128 x 128 tile edges (S 127 / 129 / 255, a
   window with offsets off the tile grid, Skv 1, hd 64, q as a
   transposed view, no GQA); the summary line carries each kernel's
   time and TFLOP/s at the training shape, ptxas's registers and spills
   of every instantiation and the build seconds. kernel_bwd: the dQ and
   dK/dV kernels against their plain version at the sixteen cases of
   tests/test_torch_cuda.py (among them the edges of their 64-row and
   128-key tiles, offsets off the tile grid with a window, hd 64, no
   GQA, Skv 1) and at the training shape (B 4, S 2048, causal), where
   each is timed beside its bound, the plain version and SDPA's
   backward (its forward+backward minus its forward). Then the three
   kernels at head_dim 256 (Gemma-2B's Hq 8, Hkv 1) against their plain
   versions at the edges of their tiles (S 63 / 64 / 65 / 127 / 129),
   Skv 1, offsets off the grid with a window, MQA and GQA, q as a
   transposed view and f32 gradient outputs, and timed at the prefill
   shape [2, 512] and the training shape [4, 2048];
then the model bench, ResNet and the checkpoint:

2m. model_bench: nos_tpu_torch.bench.run_model_bench at
    BenchSizes.quick() (bench.py's ~1B Llama and shapes, iterations
    cut: a train step at [8, 2048], dense and flash forwards, the
    attention op at Hq 16 / Hkv 8, decode per weight and cache format,
    three Engines, [1, 4096] dense / flash / 1024-window forwards, a
    256 + 1100-token stream through the physical and the rolling
    cache): finite train losses; flash against dense logits at
    [8, 2048], at [1, 4096] and under the window there, the [8, 4096]
    prefill and each decode step on the bf16 cache against a dense
    forward over the same tokens (FWD_* limits); the attention op's O
    and gradients against the dense path (BENCH_ATTN_REL_LIMIT); both
    streams, the rolling cache's past its wrap, against a windowed
    dense forward over their own tokens; every section's launches
    equal to the counts its shapes imply; the share of tokens the two
    streams share is reported;
2a. resnet: ResNet-50 (bf16, channels_last, random weights from a
    seed) at B 128, 224 x 224: logits against an f32 forward of the
    same weights on the card with TF32 off (relative Frobenius error
    and top-1 agreement within RESNET_REL_LIMIT / RESNET_TOP1_LIMIT), a
    tiny f32 config at 33 x 33 on the card against the CPU, forward and
    forward + backward (cross-entropy on random labels) images/s from
    CUDA-event medians beside the bound counted from the conv shapes,
    training peak memory, the profiler's top kernels and any layout
    transposes among them;
2b. hf_checkpoint: Llama-3-8B (llama_3_8b_config, full width and
    depth) drawn from seed 0 on the card, written as a transformers
    checkpoint (config.json, safetensors shards of at most 5 GB, the
    index) by this script's own writer, and loaded back with
    load_hf_llama(path): every tensor bit-equal, the config
    llama_3_8b_config(), write and load seconds and GB/s, the host's
    peak RSS during the load. The model phases below run on the
    loaded tree;
3. model: Llama-3-8B at full width (loaded from the checkpoint),
   attention="flash": llama_forward flash against dense on [1, 1024],
   generate() greedy on [2, 512] prompts (the kernel's launch count is
   zeroed just before and read just after: one launch per layer), one
   decode step's time beside the weight-read bound with a torch.profiler
   pass over eight steps (device-busy time, idle share, launches, top
   kernels), and a tiny config on the card against the same config on
   the CPU;
4. engine: the continuous-batching Engine serving six requests (padded
   and chunked admission, a shared-prefix cache hit), 32 tokens each;
4a. slo_serve: nos_tpu_torch.slo.bench_serve --card on the loaded tree
    (--duration 8 --rate 3): the virtual clock's tick and prefill-token
    costs measured on the card, the hot / cold drive, the report and
    its SLO verdicts (latencies virtual, from the calibrated clock), the
    drive's wall seconds; then nos_tpu_torch.slo.routing's
    ReplicaRouter on the calibrated clock, one model scaled from 0 to 2
    replicas: the backlog while it had none, the cold-start TTFT p95;
4a1. autoscale: nos_tpu_torch.bench_autoscale, reference() at 80
    virtual s on the reference's costs (its virtual keys' digest must be
    the one the CPU tests pin), then quick() (8 MIG nodes x 8 H100s, 16
    chat / batch pairs at 16 x 14 requests/s times 8 ms over the card's
    tick, the reference's load a replica) on slo_serve's calibrated
    clock: every batch-<i> scales to zero with the nodes it vacated held
    in the cold-start grace (GB-seconds > 0), one hold a vacated replica
    whose grace runs at every epoch (several on one 8-GPU node), every
    hold expires and its GPUs go back to no-demand, every chat-<i> scales
    up at least once,
    some chat scales back down, every replica is bound at each settled
    epoch, and SimCluster.check()
    with the capacity ledger's self_check holds at every epoch; the SLO
    compliance at peak, the chats' TTFT and the cold-start penalty are
    reported (autoscale_phase);
4a2. forecast: nos_tpu_torch.bench_forecast at reference(): the accuracy
    gate (p95 ETA error at most 25% of the gang's wait), a validated
    advisor proposal, no store write by the forecaster and the stage
    counts the CPU tests pin; each cycle's run_once wall ms beside an
    incremental plan's (forecast_phase);
4b. examples: serve_llama --real-weights <the checkpoint> (full width,
    int8, the Engine and a sampled generate), train_llama at its card
    config (head_dim 64, flash + remat, ClippedAdamW, 30 steps with
    checkpoints: launches 2L / L / L a step) and its resume for 5 more,
    finetune_lora at its tiny config;
4c. preempt_resume: the example's main() (the node re-carved on
    SimMigClient from one 7g.80gb to two 3g.40gb, 3 steps of
    card_config() with a checkpoint, the restore, 2 more steps):
    launches 2L / L / L a step, the resumed step, finite losses, the
    node's allocatable and status after the re-carve, and the resumed
    losses equal bit for bit to the same steps run on without the
    interruption;
5. train_grads: full width, 2 layers, [1, 1024]: llama_loss gradients
   through the kernels (flash) against autograd of the einsums (dense);
6. train: the trainer's main path, Llama-3-8B at full width and depth,
   flash + remat, bf16, built-in momentum SGD, batches of [4, 2048] from
   BatchLoader through prefetch_to_device: one warm-up and three timed
   steps, launches counted per step (forward 64 with the recompute, dQ
   32, dK/dV 32), step time, tokens/s, MFU, peak memory;
7. train_adamw: 4 layers at full width, the AdamW factory with
   accum_steps=2, two steps.

The serving extensions (after the engine phase, before training):

8. quantize: the full-width Llama-3-8B to int8 and to int4 (group 128)
   on the card: weight bytes, conversion seconds, peak memory; at 2
   layers, llama_forward on [1, 1024] with flash against the fake-quant
   oracle (dequantize_params, then the bf16 forward): max abs error,
   relative Frobenius error (limits 3e-2 int8, 5e-2 int4), top-1
   agreement;
9. generate_quant: full depth, generate() greedy on [2, 512] + 32 over
   int8 weights, int8 + kv_quant, int4 + kv_quant (forward launches
   zeroed before each and 32 after);
10. decode_quant: one decode step at batch 2, cache 544, for bf16 /
    int8 / int4 weights with kv_quant off and on, beside each format's
    weight-read bound; torch.profiler passes over the int8 and int4
    steps; KV bytes and one step at batch 4, max_len 4096, bf16 against
    int8 cache;
11. engine_quant_lora: the engine workload over int8 weights with
    kv_quant; a multi-LoRA Engine (two rank-8 adapters on wq / wv,
    seeded non-zero b) whose adapter-0 request must equal the bare
    base's tokens, token for token, in the same batch;
12. spec_engine: SpecEngine over the full-depth target and a 2-layer
    draft sharing its embedding and lm_head, and with the target as
    its own draft, k = 4, 4 requests x 32 tokens: rounds, mean accepted,
    tokens/s, agreement with the base Engine;

the MoE phases (after the serving extensions, once the Llama trees are
freed), on Mixtral-8x7B's shape with random weights from seeds:

13. moe_check: moe_mlp at full width (bf16, [1, 1024] hidden states,
    two layers of experts) at capacity factor 8 against a dense
    per-token oracle (relative Frobenius error <= 2e-2), the pairs
    dropped at the default factor 1.25, a zero router's ties picking
    experts [0, 1] on the card, a tiny f32 MoE on the card against the
    CPU (identical routing, outputs within 1e-5);
14. moe_train_grads: 2 layers at full width, [1, 1024]: llama_loss
    gradients (router, expert stacks, attention, embeddings, the aux
    term) flash against dense under the train_grads limits, launches
    2 / 2 / 2, held with tied (zero) routers; a random router's run is
    reported beside it (near-tied tokens can route differently on the
    two paths);
15. mixtral_int8: full depth in int8, built one layer at a time (weight
    bytes, conversion seconds, peak memory); at 2 layers the int8
    forward against the fake-quant oracle, and at full depth flash
    against dense, both held with tied routers and reported with the
    random ones; generate() greedy on [2, 512] + 32 (forward launches
    zeroed before and 32 after); one decode step at batch 2, cache 544,
    beside the weight-read bound, with a torch.profiler pass; an Engine
    with 4 slots serving 4 requests (padded and chunked admission), and
    a lone request in it against a solo generate() (reported);

and after training:

16. lora_train: make_lora_train_step on the full-depth bf16 base, rank 8
    on wq / wv, flash + remat, [4, 2048]: one warm-up and three timed
    steps (launches 64 / 32 / 32 a step), then merge_lora,
    quantize_params and generate() of 16 tokens;

and last the Gemma phases, Gemma-2B (gemma_2b_config: head_dim 256, one
kv head, tied embedding; random weights from seeds, bf16, flash) through
the hd-256 kernels:

17. gemma_model: full depth, llama_forward flash against dense on
    [1, 1024] under the model phase's limits, generate() greedy on
    [2, 512] + 32 (18 forward launches), one decode step beside the
    weight-read bound with a torch.profiler pass, and a tiny hd-256
    Gemma on the card against the CPU;
18. gemma_train_grads: 2 layers, [1, 1024], llama_loss gradients flash
    against dense under the train_grads limits (launches 2 / 2 / 2);
19. gemma_train: full depth, [4, 2048], flash + remat, momentum SGD, as
    the train phase: step time, tokens/s, MFU, peak memory, launches
    36 / 18 / 18 a step;

and after them the sequence- and data-parallel paths, on ranks spawned
as processes on the one card in a gloo group (NCCL refuses two ranks on
one device, so the ranks' collectives stage device tensors through
pinned host memory: every time that crosses a hop is labelled
gloo_host_staged and measures that staging, with the ranks
time-sharing the card, never a ring on NVLink). The parent has built
the kernels (the ranks only load them) and holds no card memory; a rank
that fails a check raises, and the spawn fails the script:

20. sp_ring_kernels: ring_flash_attention at Llama-3-8B's heads, B 1,
    S 16384, bf16, at sp 2 and sp 4, causal and with a 4096 window, and
    at Gemma-2B's heads (hd 256, one kv head), S 8192, sp 2; Ulysses
    (flash) at sp 4. Each rank's output and dQ/dK/dV against the
    one-process flash_attention forward and backward on the whole
    sequence (O_ATOL, BWD_ATOL + BWD_RTOL |want|); its launches of each
    kernel counted around the sp call alone (r + 1 on rank r, causal;
    1 for Ulysses); its transport; then, one rank at a time, each hop's
    kernels timed alone at the ring's shapes and offsets (f32 gradient
    outputs) beside the whole-sequence kernels (rank 0), the last rank's
    diagonal block and nearest other block held against their plain
    versions (forward, and the backward with f32 outputs and delta
    passed in, as the ring calls them), and a hop's host staging timed
    alone; then one shift of every rank at once, with no kernel running;
21. sp_forward: Llama-3-8B at full width and depth, llama_forward over
    sp 2 on [1, 8192] (4096 a rank) against the one-device flash forward
    under forward_check's limits, 32 (rank 0) and 64 (rank 1) forward
    launches;
22. sp_train: Llama-3-8B at full width, SP_TRAIN_LAYERS deep, one
    momentum-SGD step from zero velocity at dp 1 x sp 4 and at dp 2 x
    sp 2 with remat, on [2, 4096], against the one-device
    make_train_step(None) step on the same tokens and initial params:
    the loss within 2e-3, each leaf kind's gradient, read from the
    velocity and recovered from the parameter delta (lr 1e4), within 3%
    of the kind's largest, the replicas' agreement, launches L·(s + 1)
    of each kernel on sp index s (the forward's twice under remat), and
    the host-staged gradient sum timed apart from the rest of the step
    (at dp 2 the params are FSDP shards, gathered leaf by leaf for the
    comparison);

and last the tensor-parallel paths, on ranks spawned the same way:

23. tp_forward: Llama-3-8B's llama_forward over tp 2 at
    TP2_FORWARD_LAYERS layers on [1, 2048] (each rank at its Hq 16,
    Hkv 4) and over tp 4 at
    TP4_FORWARD_LAYERS layers (Hq 8, Hkv 2), against the one-device
    flash forward under forward_check's limits, one forward launch a
    layer on each rank, the gathered logits the same on every rank;
24. tp_generate / tp_engine: at full depth over tp 2, greedy generate()
    on [2, 512] + 16 (32 forward launches a rank in its prefill) and an
    Engine over the head-sharded cache answering four requests (padded
    and chunked admission), then the int8 tree through
    shard_for_serving: the same tokens on every rank, each request's
    first token held to the one-device Engine's (or a near tie), the
    share of equal tokens reported, each rank's weight and cache bytes;
25. tp_train: TP_TRAIN_LAYERS layers at full width on [4, 2048], dp 2 x
    tp 2 with FSDP and remat, one momentum-SGD step against the
    one-device step under the sp_train bars (loss within TP_LOSS_LIMIT),
    launches 2L / L / L a rank, a rank's params a quarter of the whole
    plus its norms, the step's host time split by collective kind
    (comm.timed_collectives) and a second step without the split;
26. checkpoint: that state saved as DTensor shards and restored onto a
    ('tp',) mesh of 4 and onto one device, every gathered leaf
    bit-identical to the saved one; save and restore seconds and bytes;
27. tp_lora_train (on the two tp ranks): make_lora_train_step over tp 2,
    Llama-3-8B at TP_LORA_LAYERS layers, rank 8 on wq / wv, flash +
    remat, three Adam steps on [4, 2048] against the one-device LoRA
    step: losses within TP_LOSS_LIMIT, the adapters' first moments
    within 3%, launches 2L / L / L a step;
28. tp_spec_engine: SpecEngine over tp 2, the full-depth target on its
    shards and a 2-layer draft whole on each rank, four requests x 16:
    the same tokens on both ranks, agreement with one device reported;

and last the expert- and pipeline-parallel paths, on four ranks spawned
the same way (the mixtral_int8 phase leaves the one-device logits and
tokens they are held against, and the parent frees its tree first):

29. ep_layer: one full-width bf16 Mixtral MoE layer (seeded router and
    experts, 2048 seeded hidden states sharing one component so that
    capacity 640 binds) over ep 4 on [1,
    2048] and over dp 2 x ep 2 on [2, 1024], against one device's
    moe_mlp: the kept-pair set exactly (the global capacity race), the
    output within EP_REL_LIMIT, the bytes each collective received;
30. ep_forward / ep_generate: Mixtral-8x7B in int8 at full depth over ep
    4, each rank drawing the one-device tree's layers from the same
    per-layer seeds and keeping its 2 experts of each (about 12.7 GB a
    rank): llama_forward on [1, 2048] (32 forward launches a rank, the
    same logits on every rank, held to forward_check's bars against one
    device's) and generate() on [2, 512] + EP_GENERATE_NEW (the same
    tokens on every rank, agreement reported);
31. ep_train: Mixtral at EP_TRAIN_LAYERS layers, [4, 2048], dp 2 x ep 2,
    FSDP and remat, one momentum-SGD step against the one-device step
    under the tp_train bars; launches 2L / L / L, param bytes, peak, the
    step split by collective kind;
32. pp_forward: Llama-3-8B at PP_FORWARD_LAYERS layers through
    pipeline_llama_forward over pp 4 (L/4 layers a stage, drawn layer by
    layer), [4, 2048] in 4 microbatches, against the one-device forward
    under forward_check's bars; M · L/pp forward launches a rank (the
    bubble ticks skip their compute), the hops' and the broadcast's
    times;
33. pp_train: PP_TRAIN_LAYERS layers, dp 2 x pp 2 with FSDP and remat, 2
    microbatches: pipeline_loss_and_grads against one device's llama_loss
    and gradients under the tp_train bars; launches 2 · M · L/pp / M · L/pp
    / M · L/pp a rank, the bubble share, the step split by collective
    kind.

Every line but the last two is a JSON object; the card's name and power
limit (nvidia-smi) come second to last, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU, or outside a checkout of the repository, it prints no
result and exits non-zero.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet), the bound's rates.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
O_ATOL = 2e-2      # bf16 O: about one bf16 ulp of values of order 1
LSE_ATOL = 1e-3    # f32 row statistics, different summation order
# Backward kernels against their plain version, elementwise
# |err| <= BWD_ATOL + BWD_RTOL * |want|: both round p and dS to bf16 at the
# same points, but on f32 values that differ in their last bits, and the
# bf16 gradients round once more.
BWD_ATOL = 1e-2
BWD_RTOL = 1e-2
# Two forwards of one bf16 model that differ only in how attention runs
# (flash against dense, the sp mesh against one device): the largest
# logit difference over the largest logit, the largest probability
# difference and the share of positions whose argmax agrees.
FWD_REL_LIMIT = 5e-2
FWD_PROB_LIMIT = 1e-2
FWD_ARGMAX_LIMIT = 0.8
# Flash against dense gradients of llama_loss (bf16 model), per leaf kind:
# max |g_flash - g_dense| over the kind's largest dense gradient, the
# forward check's own relative bar; the loss within 2e-2, the
# reference's flash-vs-dense loss bar (tests/ops/test_flash_attention.py).
GRAD_REL_LIMIT = FWD_REL_LIMIT
LOSS_LIMIT = 2e-2
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
# Quantized forward against its fake-quant oracle (the same quantized
# weights, dequantized to bf16), relative Frobenius error of the logits:
# the two round the bf16 products at other points (widen-multiply-scale
# against multiply-by-dequantized), and int4 also sums its groups in f32.
QUANT_REL_LIMIT = {"int8": 3e-2, "int4": 5e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def visible_pairs(sq, skv, q_off, kv_off, causal, window) -> int:
    """(query, key) pairs this call's masks leave visible, per (b, h)."""
    if not causal:
        return sq * skv
    total = 0
    for i in range(sq):
        hi = min(skv - 1, q_off + i - kv_off)
        lo = 0 if window is None else max(0, q_off + i - kv_off - window + 1)
        total += max(0, hi - lo + 1)
    return total


def attention_bound_ms(b, sq, skv, hq, hkv, hd, pairs):
    """Least time the card could take: QK^T and PV cost 4*hd operations
    per visible pair; q, k, v read once, O (bf16) and LSE (f32) written
    once. Returns (ms, "operations" | "bytes")."""
    flops = 4.0 * hd * pairs * b * hq
    nbytes = 2 * (b * sq * hq * hd + 2 * b * skv * hkv * hd + b * sq * hq * hd)
    nbytes += 4 * b * hq * sq
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_attention(card, name, b, sq, skv, q_off=0, kv_off=0, causal=True,
                    window=None, timed=True, hq=32, hkv=8, hd=128,
                    q_transposed=False):
    """One kernel-vs-plain case, by default at the 8B attention shapes.
    ``q_transposed`` hands q over as a [B, S, H, hd] view of [B, H, S, hd]
    storage (the kernel reads it through its strides, no copy)."""
    import torch
    import torch.nn.functional as F

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.util.cuda_timing import device_ms, event_ms

    gen = torch.Generator(device="cuda").manual_seed(sq * 7 + skv)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if q_transposed:
        q = randn(b, hq, sq, hd).transpose(1, 2)
    else:
        q = randn(b, sq, hq, hd)
    k, v = randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)

    def kernel():
        return fa.flash_attention_block(q, k, v, q_off, kv_off, causal=causal,
                                        window=window)

    def plain():
        return fa.flash_attention_reference(q, k, v, q_off, kv_off,
                                            causal=causal, window=window)

    out, lse = kernel()
    want, want_lse = plain()
    torch.cuda.synchronize()
    o_err = float((out.float() - want.float()).abs().max())
    neg_same = bool(torch.equal(torch.isneginf(lse), torch.isneginf(want_lse)))
    fin = torch.isfinite(want_lse)
    lse_err = float((lse[fin] - want_lse[fin]).abs().max()) if fin.any() else 0.0
    finite = bool(torch.isfinite(out.float()).all())
    empty_rows_zero = bool((out[torch.isneginf(lse).transpose(1, 2)[..., 0]] == 0).all())
    ok = (o_err <= O_ATOL and lse_err <= LSE_ATOL and neg_same and finite
          and empty_rows_zero)
    row = {
        "phase": "kernel", "case": name, "b": b, "sq": sq, "skv": skv,
        "hq": hq, "hkv": hkv, "hd": hd, "causal": causal, "window": window,
        "q_off": q_off, "kv_off": kv_off, "q_transposed": q_transposed,
        "empty_rows_zero": empty_rows_zero, "o_max_abs_err": o_err,
        "lse_max_abs_err": lse_err, "neg_inf_rows_match": neg_same,
        "o_atol": O_ATOL, "lse_atol": LSE_ATOL, "ok": ok, "card": card,
    }
    if timed:
        pairs = visible_pairs(sq, skv, q_off, kv_off, causal, window)
        bound, bound_by = attention_bound_ms(b, sq, skv, hq, hkv, hd, pairs)
        # SDPA wants [B, H, S, hd]; the layout change stays outside the timing
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if causal and (window is not None or q_off or kv_off):
            qpos = q_off + torch.arange(sq, device="cuda")
            kpos = kv_off + torch.arange(skv, device="cuda")
            mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True,
            )

        row.update(
            kernel_ms=event_ms(kernel), plain_ms=event_ms(plain, reps=10),
            library_ms=event_ms(library), bound_ms=bound, bound_by=bound_by,
            kernel_device_ms=device_ms(kernel),
            library_device_ms=device_ms(library),
            visible_pairs_per_head=pairs,
        )
        row["kernel_tflops"] = 4.0 * hd * pairs * b * hq / row["kernel_ms"] / 1e9
    emit(row)
    if not ok:
        raise SystemExit(f"kernel case {name} disagrees with its plain version: {row}")
    return row


def bwd_ptxas() -> dict:
    """ptxas's registers and spills of flash_bwd.cu's twelve
    instantiations, keyed "<dq|dkv>_hd<64|128|256>_<bf16|f32>"."""
    from nos_tpu_torch.ops import _build

    report = {}
    for entry, figures in _build.ptxas_report("flash_bwd").items():
        kind = ("dkv" if "flash_dkv_kernel" in entry
                else "dq" if "flash_dq_kernel" in entry else None)
        for hd in (64, 128, 256):
            if kind and f"ILi{hd}E" in entry:
                out = "f32" if f"ILi{hd}EfE" in entry else "bf16"
                report[f"{kind}_hd{hd}_{out}"] = figures
    return report


def counts():
    """(forward, dQ, dK/dV) kernel launches so far."""
    import nos_tpu_torch.ops.flash_attention as fa

    return fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES


def zero_counts() -> None:
    import nos_tpu_torch.ops.flash_attention as fa

    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0


def bwd_bound_ms(b, sq, skv, hq, hkv, hd, pairs, ops_per_pair, n_out_kv):
    """Least time for one backward kernel: ``ops_per_pair`` * hd
    operations per visible pair (dQ: S, dP, dQ products, 6; dK/dV: S, dP,
    dV, dK, 8) at the bf16 peak, against q, k, v, dO (bf16) and lse,
    delta (f32) read once and its outputs (bf16) written once: dQ's
    [b, sq, hq, hd], or dK and dV ([b, skv, hkv, hd] each, ``n_out_kv``
    2). Returns (ms, "operations" | "bytes")."""
    flops = ops_per_pair * hd * pairs * b * hq
    nbytes = 2 * (2 * b * sq * hq * hd + 2 * b * skv * hkv * hd) + 4 * 2 * b * hq * sq
    nbytes += 2 * (n_out_kv * b * skv * hkv * hd if n_out_kv else b * sq * hq * hd)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_backward(card, name, b, sq, skv, hq=32, hkv=8, hd=128, q_off=0,
                   kv_off=0, causal=True, window=None, timed=False, grad_dtype=None):
    """dQ and dK/dV kernels against their plain version on one case, the
    gradients written in bf16 or in ``grad_dtype`` (f32); at ``timed``,
    each kernel's time beside its bound, its profiler device time, the
    plain version and SDPA's backward."""
    import torch
    import torch.nn.functional as F

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.util.cuda_timing import device_ms, event_ms

    gen = torch.Generator(device="cuda").manual_seed(sq * 13 + skv + hd)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = randn(b, sq, hq, hd), randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)
    do = randn(b, sq, hq, hd)
    out, lse = fa.flash_attention_block(q, k, v, q_off, kv_off, causal=causal,
                                        window=window)
    delta = fa.flash_delta(do, out)
    kw = dict(causal=causal, window=window, delta=delta, grad_dtype=grad_dtype)
    got = fa.flash_block_grads(q, k, v, out, lse, do, q_off, kv_off, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, q_off, kv_off, **kw)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        ok = ok and g.dtype == (grad_dtype or torch.bfloat16)
        g, w = g.float(), w.float()
        errs[gname] = float((g - w).abs().max())
        ok = ok and bool(((g - w).abs() <= BWD_ATOL + BWD_RTOL * w.abs()).all())
        ok = ok and bool(torch.isfinite(g).all())
    if bool(torch.isneginf(lse).all()):  # no visible key anywhere: exact zeros
        ok = ok and all(bool((g == 0).all()) for g in got)
    row = {
        "phase": "kernel_bwd", "case": name, "b": b, "sq": sq, "skv": skv,
        "hq": hq, "hkv": hkv, "hd": hd, "causal": causal, "window": window,
        "q_off": q_off, "kv_off": kv_off,
        "grad_dtype": "f32" if grad_dtype == torch.float32 else "bf16",
        **{f"{g}_max_abs_err": e for g, e in errs.items()},
        "atol": BWD_ATOL, "rtol": BWD_RTOL, "ok": ok, "card": card,
    }
    if timed:
        pairs = visible_pairs(sq, skv, q_off, kv_off, causal, window)
        args = (q, k, v, lse, do, delta, q_off, kv_off, causal, window, grad_dtype)
        for kname, which in (("dq", (True, False)), ("dkv", (False, True))):
            row[f"{kname}_ms"] = event_ms(lambda: fa._flash_bwd_cuda(*args, *which))
            row[f"{kname}_device_ms"] = device_ms(lambda: fa._flash_bwd_cuda(*args, *which))
        row["dq_bound_ms"], row["dq_bound_by"] = bwd_bound_ms(
            b, sq, skv, hq, hkv, hd, pairs, 6, 0)
        row["dkv_bound_ms"], row["dkv_bound_by"] = bwd_bound_ms(
            b, sq, skv, hq, hkv, hd, pairs, 8, 2)
        row["plain_ms"] = event_ms(
            lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, q_off,
                                                     kv_off, **kw),
            reps=3, warmup=1)
        # SDPA (a yardstick the port never calls): forward+backward minus
        # forward, [B, H, S, hd] copies made outside the timing
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        row["sdpa_fwd_ms"] = event_ms(sdpa)
        row["sdpa_fwd_bwd_ms"] = event_ms(sdpa_fwd_bwd)
        row["library_ms"] = row["sdpa_fwd_bwd_ms"] - row["sdpa_fwd_ms"]
        row["visible_pairs"] = pairs * b * hq
        for kname, ops in (("dq", 6), ("dkv", 8)):
            row[f"{kname}_tflops"] = ops * hd * pairs * b * hq / row[f"{kname}_ms"] / 1e9
    emit(row)
    if not ok:
        raise SystemExit(f"backward case {name} disagrees with its plain version: {row}")
    return row


def logits_agreement(got, want) -> dict:
    """The statistics of ``got`` logits against ``want``'s that the FWD_*
    limits bound."""
    import torch

    diff = (got - want).abs()
    return {"logits_max_abs_diff": float(diff.max()),
            "logits_max_rel_diff": float(diff.max() / want.abs().max()),
            "probs_max_abs_diff": float((torch.softmax(got, -1)
                                         - torch.softmax(want, -1)).abs().max()),
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
            "finite": bool(torch.isfinite(got).all())}


def logits_hold(stats, probs_limit: float = FWD_PROB_LIMIT) -> bool:
    return (stats["finite"] and stats["logits_max_rel_diff"] <= FWD_REL_LIMIT
            and stats["probs_max_abs_diff"] <= probs_limit
            and stats["argmax_agreement"] >= FWD_ARGMAX_LIMIT)


def forward_check(card, phase, params, cfg, tokens, scale_prob_limit=False) -> dict:
    """llama_forward on ``tokens`` with flash (its launches counted, one a
    layer) against dense, held to the FWD_* limits. Both paths round their
    logits to bf16, whose spacing u at the largest logit grows with it;
    one spacing on each logit can move a probability by up to u / 2
    (|dp_i| <= 2 p_i (1 - p_i) u). With ``scale_prob_limit`` (Gemma: its
    scaled, tied embedding gives logits near 17, where u = 2^-3) the
    probability limit is max(FWD_PROB_LIMIT, u / 2)."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.models import llama

    with torch.no_grad():
        fa.LAUNCHES = 0
        flash_logits = llama.llama_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        forward_launches = fa.LAUNCHES
        dense_logits = llama.llama_forward(
            params, tokens, dataclasses.replace(cfg, attention="dense"))
        stats = logits_agreement(flash_logits, dense_logits)
        spacing = 2.0 ** (math.floor(math.log2(float(dense_logits.abs().max()))) - 7)
    p_limit = max(FWD_PROB_LIMIT, spacing / 2) if scale_prob_limit else FWD_PROB_LIMIT
    row = {"phase": phase, "tokens": list(tokens.shape),
           "flash_launches": forward_launches, **stats,
           "logits_bf16_spacing": spacing, "probs_limit": p_limit, "card": card}
    row["ok"] = forward_launches == cfg.n_layers and logits_hold(stats, p_limit)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"flash forward disagrees with dense: {row}")
    return row


def generate_check(card, phase, params, cfg, prompt, new_tokens=32):
    """The serving main path: greedy generate() with the forward kernel's
    count zeroed just before and read just after (one launch a layer, in
    the unpadded prefill). Returns (launches, tokens)."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.models import generate as gen_mod

    with torch.no_grad():
        torch.cuda.synchronize()
        fa.LAUNCHES = 0
        t0 = time.time()
        out = gen_mod.generate(params, prompt, cfg, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = fa.LAUNCHES
    ok = (tuple(out.shape) == (prompt.shape[0], new_tokens) and launches == cfg.n_layers
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    emit({"phase": phase, "prompt": list(prompt.shape), "new_tokens": new_tokens,
          "flash_launches": launches, "seconds": wall,
          "tokens_per_s": prompt.shape[0] * new_tokens / wall, "ok": ok, "card": card})
    if not ok:
        raise SystemExit(f"generate() failed: shape {tuple(out.shape)}, "
                         f"launches {launches}")
    return launches, out


def decode_check(card, phase, profile_phase, params, cfg, prompt, first,
                 n_params, new_tokens=32) -> dict:
    """One decode step at the generate shapes, beside the weight-read bound
    (bf16 weights read once), then a torch.profiler pass over eight."""
    import torch

    from nos_tpu_torch.models import generate as gen_mod

    b, s = prompt.shape
    with torch.no_grad():
        _, cache = gen_mod.prefill(params, prompt, cfg, s + new_tokens)

        def decode_steps(n, token=first):
            for i in range(n):
                logits, _ = gen_mod.decode_step(params, cache, s + i, token, cfg)
                token = logits.argmax(dim=-1)
            torch.cuda.synchronize()

        decode_steps(2)
        t0 = time.time()
        decode_steps(16)
        step_ms = (time.time() - t0) / 16 * 1e3
        row = {"phase": phase, "batch": b, "cache_len": s + new_tokens,
               "ms_per_step": step_ms,
               "weight_read_bound_ms": 2 * n_params / PEAK_HBM_BYTES_S * 1e3,
               "card": card}
        emit(row)
        row["profile"] = profile_steps(decode_steps, card, step_ms, phase=profile_phase)
        emit(row["profile"])
    return row


def tiny_check(card, phase, tiny, gen) -> dict:
    """A small input against a reference: the same tiny model (bf16,
    flash) on the card and on the CPU, logits within 1e-1."""
    import torch

    from nos_tpu_torch.models import llama

    tiny_gpu = llama.init_llama_params(tiny, seed=3, device="cuda")
    tiny_cpu = llama.tree_map(lambda x: x.cpu(), tiny_gpu)
    small = torch.randint(0, tiny.vocab_size, (2, 96), generator=gen, device="cuda")
    with torch.no_grad():
        a = llama.llama_forward(tiny_gpu, small, tiny).cpu()
        b = llama.llama_forward(tiny_cpu, small.cpu(), tiny)
    err = float((a - b).abs().max())
    row = {"phase": phase, "head_dim": tiny.head_dim, "logits_max_abs_diff": err,
           "atol": 1e-1, "ok": err <= 1e-1 and bool(torch.isfinite(a).all()),
           "card": card}
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"tiny model on the card disagrees with the CPU: {row}")
    return row


def gemma_kernel_phases(card) -> dict:
    """The three kernels at head_dim 256 (Gemma-2B's attention: Hq 8,
    Hkv 1) against their plain versions: the edges of the forward's
    64-key tiles, the backward's 64-row query tiles, 64-key dK/dV blocks
    and 32-key dQ tiles (S 63 / 64 / 65 / 127 / 129), Skv 1, offsets off
    the grid with a window, MQA and GQA, q as a transposed view, f32
    gradient outputs; timed at the generate() prefill shape [2, 512] and
    the training shape [4, 2048] (causal)."""
    g = dict(hd=256, hq=8, hkv=1)
    rows = {}
    for n in (63, 64, 65, 127, 129):
        check_attention(card, f"hd256_ragged_s{n}", 1, n, n, timed=False, **g)
    check_attention(card, "hd256_skv_1", 2, 50, 1, timed=False, **g)
    check_attention(card, "hd256_window200_offsets_off_tile", 1, 300, 400, q_off=333,
                    kv_off=45, window=200, timed=False, hd=256, hq=4, hkv=2)
    check_attention(card, "hd256_q_transposed_view", 2, 200, 200, q_transposed=True,
                    timed=False, **g)
    check_attention(card, "hd256_gqa_noncausal", 2, 77, 77, causal=False, timed=False,
                    hd=256, hq=8, hkv=2)
    rows["fwd_prefill"] = check_attention(card, "hd256_gemma_prefill_b2_s512", 2, 512,
                                          512, **g)
    rows["fwd_train"] = check_attention(card, "hd256_gemma_train_b4_s2048", TRAIN_BATCH,
                                        TRAIN_SEQ, TRAIN_SEQ, **g)
    for n in (63, 64, 65, 127, 129):
        check_backward(card, f"hd256_ragged_s{n}", 1, n, n, **g)
    check_backward(card, "hd256_skv_1", 2, 50, 1, **g)
    check_backward(card, "hd256_window200_offsets_off_tile", 1, 300, 400, q_off=333,
                   kv_off=45, window=200, hd=256, hq=4, hkv=2)
    check_backward(card, "hd256_gqa_s300", 2, 300, 300, hd=256, hq=8, hkv=2)
    check_backward(card, "hd256_gqa_noncausal", 2, 77, 77, causal=False, hd=256, hq=8,
                   hkv=2)
    import torch

    check_backward(card, "hd256_f32_grads_window37", 1, 200, 200, window=37,
                   grad_dtype=torch.float32, **g)
    check_backward(card, "hd256_f32_grads_offsets", 1, 64, 96, q_off=40, kv_off=20,
                   window=50, grad_dtype=torch.float32, **g)
    rows["bwd_train"] = check_backward(card, "hd256_gemma_train_b4_s2048", TRAIN_BATCH,
                                       TRAIN_SEQ, TRAIN_SEQ, timed=True, **g)
    return rows


def gemma_model_phase(card) -> dict:
    """Gemma-2B at full width and depth (random weights from a seed, bf16,
    attention="flash", the tied embedding as its unembedding):
    llama_forward flash against dense on [1, 1024], greedy generate() on
    [2, 512] + 32 (18 forward launches), one decode step beside the
    weight-read bound with a profile, and a tiny head_dim-256 Gemma on the
    card against the CPU."""
    import torch

    from nos_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.gemma_2b_config(), attention="flash")
    t0 = time.time()
    params = llama.init_llama_params(cfg, seed=21, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in llama.tree_leaves(params))
    emit({"phase": "gemma_init", "config": "gemma_2b", "params": n_params,
          "seconds": time.time() - t0, "gib": torch.cuda.memory_allocated() / 2**30,
          "card": card})
    gen = torch.Generator(device="cuda").manual_seed(21)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    forward = forward_check(card, "gemma_forward", params, cfg, tokens,
                            scale_prob_limit=True)
    prompt = torch.randint(1, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    launches, out = generate_check(card, "gemma_generate", params, cfg, prompt)
    decode = decode_check(card, "gemma_decode_step", "gemma_decode_profile", params, cfg,
                          prompt, out[:, 0], n_params)
    tiny_check(card, "gemma_tiny_card_vs_cpu", llama.tiny_config(
        d_model=256, n_heads=2, n_kv_heads=1, d_ff=512, qk_head_dim=256,
        hidden_act="gelu", norm_offset=True, scale_embeddings=True,
        tie_embeddings=True, attention="flash"), gen)
    return {"params": n_params, "forward": forward, "generate_launches": launches,
            "decode": decode}


def changed_fraction(before, after) -> float:
    """Share of elements that differ between two lists of tensors."""
    changed = sum(int((a != b).sum()) for a, b in zip(before, after))
    return changed / sum(a.numel() for a in before)


def named_leaves(params):
    """(kind, tensor) in the order of nos_tpu_torch.parallel.train.tree_leaves;
    a MoE layer's leaves are "moe.router", "moe.w_gate", ..."""
    for key, value in params.items():
        if key == "layers":
            for layer in value:
                for name, leaf in layer.items():
                    if isinstance(leaf, dict):
                        yield from ((f"{name}.{k}", v) for k, v in leaf.items())
                    else:
                        yield name, leaf
        else:
            yield key, value


def flash_dense_grads(params, tokens, cfg) -> dict:
    """llama_loss and its gradients on the flash path (the kernels)
    against the dense path (autograd of the einsums): the losses, each
    leaf kind's max |g_flash - g_dense| over its largest dense gradient,
    and the kernel launches of the flash pass alone."""
    import torch

    from nos_tpu_torch.models import llama

    named = list(named_leaves(params))
    leaves = [t.requires_grad_(True) for _, t in named]

    def loss_and_grads(c):
        loss = llama.llama_loss(params, tokens, c)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    torch.cuda.synchronize()
    zero_counts()
    loss_f, grads_f = loss_and_grads(cfg)
    torch.cuda.synchronize()
    launches = counts()
    loss_d, grads_d = loss_and_grads(dataclasses.replace(cfg, attention="dense"))
    diff, ref = {}, {}
    for (kind, _), gf, gd in zip(named, grads_f, grads_d):
        diff[kind] = max(diff.get(kind, 0.0), float((gf.float() - gd.float()).abs().max()))
        ref[kind] = max(ref.get(kind, 0.0), float(gd.float().abs().max()))
    return {"loss_flash": float(loss_f), "loss_dense": float(loss_d),
            "loss_abs_diff": abs(float(loss_f) - float(loss_d)),
            "grad_rel_err": {kind: diff[kind] / ref[kind] for kind in diff},
            "launches_fwd_dq_dkv": list(launches),
            "finite": all(bool(torch.isfinite(g.float()).all()) for g in grads_f)}


def grads_hold(res, n_layers) -> bool:
    return (res["finite"] and res["loss_abs_diff"] <= LOSS_LIMIT
            and max(res["grad_rel_err"].values()) <= GRAD_REL_LIMIT
            and res["launches_fwd_dq_dkv"] == [n_layers] * 3)


def train_grads_phase(card, base=None, phase="train_grads", seed=5) -> dict:
    """llama_loss gradients at full width (``base``, by default
    Llama-3-8B), 2 layers, [1, 1024]: the flash path (kernels) against the
    dense path (autograd of the einsums)."""
    import torch

    from nos_tpu_torch.models import llama

    cfg = dataclasses.replace(base or llama.llama_3_8b_config(), n_layers=2,
                              attention="flash")
    params = llama.init_llama_params(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    row = {"phase": phase, "layers": 2, "tokens": [1, 1024],
           **flash_dense_grads(params, tokens, cfg),
           "loss_limit": LOSS_LIMIT, "grad_rel_limit": GRAD_REL_LIMIT, "card": card}
    row["ok"] = grads_hold(row, cfg.n_layers)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"flash gradients disagree with dense: {row}")
    return row


def train_phase(card, base=None, config="llama_3_8b", phase="train", seed=7) -> dict:
    """The trainer's main path: ``base`` (by default Llama-3-8B) at full
    width and depth, flash + remat, built-in momentum SGD, batches from
    BatchLoader through prefetch_to_device."""
    import numpy as np
    import torch

    from nos_tpu_torch.data import BatchLoader, prefetch_to_device
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step

    cfg = dataclasses.replace(base or llama.llama_3_8b_config(), attention="flash",
                              remat=True)
    torch.cuda.reset_peak_memory_stats()
    # bf16 weights of order 2^-6 have a half-ulp of 6e-5: an SGD update
    # below that rounds away, and at lr 1e-3 none of the probed weights
    # moved in three steps from the random init. lr 1.0 makes the update
    # visible; the step's work is the same at any lr.
    step, shard_state = make_train_step(None, cfg, learning_rate=1.0)
    state = shard_state(llama.init_llama_params(cfg, seed=seed, device="cuda"),
                        donate=True)
    params = state[0]
    # a tied model's unembedding is its embedding
    unembed = params.get("lm_head", params["embed"])
    probes = [unembed, params["layers"][0]["wq"], params["layers"][-1]["w_down"]]
    before = [t.detach().clone() for t in probes]
    layer_mm = sum(params["layers"][0][key].numel() for key in
                   ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    matmul_params = layer_mm * cfg.n_layers + unembed.numel()
    corpus = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=1 << 22).astype(np.int32)
    loader = BatchLoader(corpus, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed)
    stream = prefetch_to_device(iter(loader))
    torch.cuda.synchronize()
    zero_counts()  # the main path: every launch from here on is the trainer's
    step_ms, losses, per_step = [], [], []
    for _ in range(4):  # one warm-up, three timed
        at_start = counts()
        t0 = time.perf_counter()
        state, loss = step(state, next(stream))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append(tuple(a - b for a, b in zip(counts(), at_start)))
    totals = counts()
    timed_ms = statistics.median(step_ms[1:])
    holder = [state]

    def more_steps(n):
        for _ in range(n):
            holder[0], _ = step(holder[0], next(stream))
        torch.cuda.synchronize()

    # one more step under torch.profiler, after the counts were read
    emit(profile_steps(more_steps, card, timed_ms, steps=1, phase=f"{phase}_profile"))
    stream.close()
    losses = [float(x) for x in losses]
    changed = changed_fraction(before, probes)
    del before
    tokens = TRAIN_BATCH * TRAIN_SEQ
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2 * TRAIN_BATCH * cfg.n_heads
    flops = 6.0 * matmul_params * tokens + 3 * 4.0 * cfg.head_dim * pairs * cfg.n_layers
    expect = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    row = {"phase": phase, "config": config, "layers": cfg.n_layers,
           "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "optimizer": "momentum_sgd(lr=1.0, momentum=0.9)",
           "remat": True, "step_ms": step_ms, "ms_per_step": timed_ms,
           "tokens_per_s": tokens / timed_ms * 1e3,
           "model_flops_per_step": flops,
           "mfu": flops / (timed_ms / 1e3) / PEAK_BF16_FLOPS,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step_fwd_dq_dkv": [list(x) for x in per_step],
           "launches_total_fwd_dq_dkv": list(totals), "losses": losses,
           "probed_params_changed_fraction": changed, "card": card}
    row["ok"] = (all(x == expect for x in per_step) and changed > 0
                 and all(np.isfinite(losses)))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"train phase failed: {row}")
    return row


def train_adamw_phase(card) -> dict:
    """4 layers at full width, the AdamW factory, accum_steps=2."""
    import numpy as np
    import torch

    from nos_tpu_torch.data import BatchLoader, prefetch_to_device
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step

    cfg = dataclasses.replace(llama.llama_3_8b_config(), n_layers=4,
                              attention="flash", remat=True)
    factory = functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=0.01)
    step, shard_state = make_train_step(None, cfg, optimizer=factory, accum_steps=2)
    state = shard_state(llama.init_llama_params(cfg, seed=9, device="cuda"),
                        donate=True)
    corpus = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=1 << 20).astype(np.int32)
    stream = prefetch_to_device(iter(BatchLoader(corpus, batch=4, seq_len=TRAIN_SEQ,
                                                 seed=9)))
    probe = state[0]["layers"][3]["w_down"]
    before = [probe.detach().clone()]
    zero_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(2):
        state, loss = step(state, next(stream))
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stream.close()
    losses = [float(x) for x in losses]
    launches = counts()
    expect = (2 * 2 * 2 * cfg.n_layers, 2 * 2 * cfg.n_layers, 2 * 2 * cfg.n_layers)
    changed = changed_fraction(before, [probe])
    row = {"phase": "train_adamw", "layers": cfg.n_layers, "batch": [4, TRAIN_SEQ],
           "accum_steps": 2, "optimizer": "torch.optim.AdamW(lr=1e-4, wd=0.01)",
           "losses": losses, "seconds": wall, "launches_fwd_dq_dkv": list(launches),
           "probed_params_changed_fraction": changed, "card": card}
    row["ok"] = bool(all(np.isfinite(losses)) and changed > 0 and launches == expect)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"train_adamw phase failed: {row}")
    return row


def quantize_phase(card, params, cfg) -> dict:
    """int8 and int4 trees of the full model, and their 2-layer parity
    against the fake-quant oracle."""
    import torch

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models import quantize as tq

    trees = {"bf16": params}
    seconds = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fmt, fn in (("int8", tq.quantize_params),
                    ("int4", lambda p: tq.quantize_params_int4(p, group=128))):
        t0 = time.time()
        trees[fmt] = fn(params)
        torch.cuda.synchronize()
        seconds[fmt] = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    row = {"phase": "quantize", "config": "llama_3_8b",
           "weight_bytes": {k: tq.weight_bytes(v) for k, v in trees.items()},
           "seconds": seconds, "conversion_peak_gib": peak, "int4_group": 128,
           "parity_layers": 2, "parity_tokens": [1, 1024],
           "rel_limit": QUANT_REL_LIMIT, "card": card}
    two = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    ok = True
    with torch.no_grad():
        for fmt in ("int8", "int4"):
            sliced = dict(trees[fmt], layers=trees[fmt]["layers"][:2])
            got = llama.llama_forward(sliced, tokens, two)
            want = llama.llama_forward(tq.dequantize_params(sliced, cfg.dtype), tokens, two)
            rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
            row[fmt] = {
                "max_abs_err": float((got - want).abs().max()),
                "rel_frobenius_err": rel,
                "top1_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
                "finite": bool(torch.isfinite(got).all()),
            }
            ok = ok and row[fmt]["finite"] and rel <= QUANT_REL_LIMIT[fmt]
            del got, want
    row["ok"] = ok
    emit(row)
    if not ok:
        raise SystemExit(f"quantized forward disagrees with its oracle: {row}")
    return trees


def generate_quant_phase(card, trees, cfg, prompt) -> list:
    """generate() on [2, 512] + 32 over quantized weights, forward
    launches counted around each run."""
    import torch

    from nos_tpu_torch.models import generate as gen_mod

    rows = []
    for fmt, kv_quant in (("int8", False), ("int8", True), ("int4", True)):
        with torch.no_grad():
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.time()
            out = gen_mod.generate(trees[fmt], prompt, cfg, max_new_tokens=32,
                                   kv_quant=kv_quant)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = counts()[0]
            peak = torch.cuda.max_memory_allocated()
        # peak_gib includes every resident tree (bf16, int8, int4);
        # above_resident_gib is what this generate() itself allocated at
        # its peak (the prefill's activations, the int4 [rows, G, out]
        # partials, the cache)
        row = {"phase": "generate_quant", "weights": fmt, "kv_quant": kv_quant,
               "prompt": list(prompt.shape), "new_tokens": 32,
               "flash_launches": launches, "seconds": wall,
               "tokens_per_s": prompt.shape[0] * 32 / wall,
               "peak_gib": peak / 2**30, "above_resident_gib": (peak - resident) / 2**30,
               "card": card}
        row["ok"] = (tuple(out.shape) == (prompt.shape[0], 32)
                     and launches == cfg.n_layers
                     and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
        emit(row)
        if not row["ok"]:
            raise SystemExit(f"quantized generate() failed: {row}")
        rows.append(row)
    return rows


def decode_quant_phase(card, trees, cfg, prompt, first) -> list:
    """One decode step per weight format and cache kind, beside the
    weight-read bound; the int8 step under torch.profiler; a large cache."""
    import torch

    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import quantize as tq
    from nos_tpu_torch.models.decode_bench import time_decode

    rows = []
    with torch.no_grad():
        for fmt in ("bf16", "int8", "int4"):
            wbytes = tq.weight_bytes(trees[fmt])
            for kv_quant in (False, True):
                ms, run = time_decode(trees[fmt], cfg, prompt, first, kv_quant,
                                      max_len=prompt.shape[1] + 32)
                row = {"phase": "decode_quant", "weights": fmt, "kv_quant": kv_quant,
                       "batch": prompt.shape[0], "cache_len": prompt.shape[1] + 32,
                       "ms_per_step": ms, "weight_bytes": wbytes,
                       "weight_read_bound_ms": wbytes / PEAK_HBM_BYTES_S * 1e3,
                       "card": card}
                emit(row)
                rows.append(row)
                if fmt != "bf16" and not kv_quant:
                    row = profile_steps(run, card, ms, phase="decode_quant_profile")
                    emit(dict(row, weights=fmt))
                del run
        # a long cache: batch 4, max_len 4096, random contents (the port's
        # cache attention reads every slot whatever the frontier)
        gen = torch.Generator(device="cuda").manual_seed(13)
        token = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
        for kv_quant in (False, True):
            cache = gen_mod.init_kv_cache(cfg, 4, 4096, quant=kv_quant)
            for layer in cache:
                for key, buf in layer.items():
                    if buf.dtype == torch.int8:
                        buf.random_(-127, 128, generator=gen)
                    elif key.endswith("scale"):
                        buf.uniform_(0.005, 0.02, generator=gen)
                    else:
                        buf.normal_(generator=gen)
            kv_bytes = sum(b.numel() * b.element_size() for layer in cache
                           for b in layer.values())
            pos = torch.full((4,), 4000, device="cuda")

            def step():
                gen_mod.decode_step(trees["bf16"], cache, pos, token, cfg)

            step()
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(4):
                step()
            torch.cuda.synchronize()
            row = {"phase": "decode_long_cache", "weights": "bf16",
                   "kv_quant": kv_quant, "batch": 4, "max_len": 4096,
                   "kv_bytes": kv_bytes, "ms_per_step": (time.time() - t0) / 4 * 1e3,
                   "kv_read_bound_ms": kv_bytes / PEAK_HBM_BYTES_S * 1e3, "card": card}
            emit(row)
            rows.append(row)
            del cache
    return rows


def engine_quant_lora_phase(card, trees, cfg, prompts) -> None:
    """(a) the engine workload over int8 weights and an int8 cache; (b) a
    multi-LoRA Engine against the bare base in the same batch shape."""
    import torch

    from nos_tpu_torch.models import lora as tlora
    from nos_tpu_torch.serve import Engine, GenRequest
    from nos_tpu_torch.util import metrics

    hits0 = metrics.SERVE_PREFIX_HITS.value
    eng = Engine(trees["int8"], cfg, max_slots=4, max_len=1024, prefill_chunk=256,
                 prefix_cache_entries=2, kv_quant=True)
    with torch.no_grad():
        t0 = time.time()
        ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32)) for p in prompts]
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    hits = metrics.SERVE_PREFIX_HITS.value - hits0
    row = {"phase": "engine_quant", "weights": "int8", "kv_quant": True,
           "requests": len(ids), "prompt_tokens": [len(p) for p in prompts],
           "new_tokens": 32, "prefix_hits": hits, "seconds": wall,
           "tokens_per_s": 32 * len(ids) / wall, "card": card}
    row["ok"] = hits >= 1 and all(
        len(results[i]) == 32 and all(0 <= t < cfg.vocab_size for t in results[i])
        for i in ids)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"int8 engine failed: {row}")
    del eng

    lora = tlora.LoraConfig(rank=8, targets=("wq", "wv"))
    adapters = []
    for seed in (21, 22):
        ad = tlora.init_lora_params(cfg, lora, seed=seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for layer in ad["layers"]:
            for ab in layer.values():
                ab["b"].normal_(0.0, 0.05, generator=gen)
        adapters.append(ad)
    stacked = tlora.stack_lora_adapters(trees["bf16"], adapters, lora, rows=3)
    lora_prompts = [prompts[0], prompts[4], prompts[5]]
    out = {}
    for name, params, adapter_ids in (("lora", stacked, (0, 1, 2)),
                                      ("base", trees["bf16"], (0, 0, 0))):
        eng = Engine(params, cfg, max_slots=3, max_len=512)
        with torch.no_grad():
            t0 = time.time()
            ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32, adapter=a))
                   for p, a in zip(lora_prompts, adapter_ids)]
            got = eng.run()
            torch.cuda.synchronize()
            out[name] = ([got[i] for i in ids], time.time() - t0)
    (lora_toks, lora_s), (base_toks, base_s) = out["lora"], out["base"]
    row = {"phase": "engine_multi_lora", "adapters": 2, "rank": 8,
           "targets": list(lora.targets), "requests_adapters": [0, 1, 2],
           "prompt_tokens": [len(p) for p in lora_prompts], "new_tokens": 32,
           "seconds": lora_s, "tokens_per_s": 96 / lora_s,
           "base_engine_tokens_per_s": 96 / base_s,
           "adapter0_equals_base": lora_toks[0] == base_toks[0],
           "adapter_differs_from_base": [lora_toks[i] != base_toks[i] for i in (1, 2)],
           "card": card}
    row["ok"] = (row["adapter0_equals_base"] and all(row["adapter_differs_from_base"])
                 and all(len(x) == 32 for x in lora_toks))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"multi-LoRA engine failed: {row}")


def spec_engine_phase(card, params, cfg, prompts, k=4, chunk=16) -> None:
    """SpecEngine over the full-depth target with two drafts: its first
    two layers (sharing the embedding and lm_head), and the target
    itself (every draft should be accepted, up to chunk-vs-step drift).
    Two base Engines serve the same requests for comparison: one admits
    through padded dense prefill (every prompt here fits one bucket),
    the other through the same ``chunk``-token pieces as SpecEngine, so
    that its agreement leaves only the verify-vs-step drift."""
    import torch

    from nos_tpu_torch.serve import Engine, GenRequest, SpecEngine

    def serve(eng):
        with torch.no_grad():
            t0 = time.time()
            ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32)) for p in prompts]
            got = eng.run()
            torch.cuda.synchronize()
        return [got[i] for i in ids], time.time() - t0

    def agreement(toks, ref):
        same = sum(a == b for s_, r_ in zip(toks, ref) for a, b in zip(s_, r_))
        # tokens up to each request's first divergence
        prefix = [next((i for i, (a, b) in enumerate(zip(s_, r_)) if a != b), 32)
                  for s_, r_ in zip(toks, ref)]
        return same / (32 * len(prompts)), prefix

    assert all(len(p) > chunk for p in prompts), "every prompt must span pieces"
    base_toks, base_s = serve(Engine(params, cfg, max_slots=4, max_len=512))
    chunked_toks, _ = serve(Engine(params, cfg, max_slots=4, max_len=512,
                                   prefill_chunk=chunk))
    share, prefix = agreement(chunked_toks, base_toks)
    emit({"phase": "spec_engine_witness", "prefill_chunk": chunk,
          "chunked_base_share_equal_to_padded_base": share,
          "tokens_before_first_divergence": prefix, "card": card})
    drafts = (("first_2_layers", dict(params, layers=params["layers"][:2]),
               dataclasses.replace(cfg, n_layers=2)),
              ("target_itself", params, cfg))
    for name, draft, draft_cfg in drafts:
        spec = SpecEngine(params, cfg, draft, draft_cfg, k=k, max_slots=4, max_len=512,
                          prefill_chunk=chunk)
        spec_toks, spec_s = serve(spec)
        stats = spec.stats()
        share, prefix = agreement(spec_toks, base_toks)
        share_chunked, prefix_chunked = agreement(spec_toks, chunked_toks)
        row = {"phase": "spec_engine", "draft": name, "draft_layers": draft_cfg.n_layers,
               "k": k, "prefill_chunk": chunk, "requests": len(prompts),
               "prompt_tokens": [len(p) for p in prompts],
               "new_tokens": 32, "rounds": stats["rounds"],
               "mean_accepted": stats["mean_accepted"], "seconds": spec_s,
               "tokens_per_s": 32 * len(prompts) / spec_s,
               "base_engine_tokens_per_s": 32 * len(prompts) / base_s,
               "share_equal_to_base_engine": share,
               "tokens_before_first_divergence": prefix,
               "share_equal_to_chunked_base_engine": share_chunked,
               "tokens_before_first_divergence_chunked": prefix_chunked,
               "card": card}
        row["ok"] = (all(len(x) == 32 for x in spec_toks)
                     and all(0 <= t < cfg.vocab_size for x in spec_toks for t in x)
                     and 0.0 <= stats["mean_accepted"] <= k)
        emit(row)
        if not row["ok"]:
            raise SystemExit(f"spec engine failed: {row}")
        del spec


def base_checksums(params) -> list:
    """Two integers per leaf of a bf16 params tree: the sums of its bits
    read as int16 and of their squares (a cheap witness that no frozen
    leaf was written, without a second copy of the weights)."""
    import torch

    from nos_tpu_torch.models.llama import tree_leaves

    sums = []
    for leaf in tree_leaves(params):
        bits = leaf.view(torch.int16).int()
        sums += [bits.sum(dtype=torch.int64), (bits * bits).sum(dtype=torch.int64)]
        del bits
    return torch.stack(sums).tolist()


def lora_train_phase(card) -> dict:
    """LoRA fine-tuning at full width and depth, then finetune_lora.py's
    serving path: merge, int8, generate."""
    import numpy as np
    import torch

    from nos_tpu_torch.data import BatchLoader, prefetch_to_device
    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models import lora as tlora
    from nos_tpu_torch.models.quantize import quantize_params

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash", remat=True)
    torch.cuda.reset_peak_memory_stats()
    base = llama.init_llama_params(cfg, seed=17, device="cuda")
    lora = tlora.LoraConfig(rank=8, targets=("wq", "wv"))
    step, shard = tlora.make_lora_train_step(None, cfg, lora, learning_rate=1e-3)
    state = shard(tlora.init_lora_params(cfg, lora, seed=17))
    b_before = [state[0]["layers"][i]["wq"]["b"].detach().clone() for i in (0, -1)]
    base_before = base_checksums(base)
    corpus = np.random.default_rng(17).integers(
        0, cfg.vocab_size, size=1 << 22).astype(np.int32)
    stream = prefetch_to_device(iter(BatchLoader(corpus, batch=TRAIN_BATCH,
                                                 seq_len=TRAIN_SEQ, seed=17)))
    torch.cuda.synchronize()
    zero_counts()
    step_ms, losses, per_step = [], [], []
    for _ in range(4):  # one warm-up, three timed
        at_start = counts()
        t0 = time.perf_counter()
        state, loss = step(state, base, next(stream))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append(tuple(a - b for a, b in zip(counts(), at_start)))
    stream.close()
    timed_ms = statistics.median(step_ms[1:])
    b_moved = all(not torch.equal(state[0]["layers"][i]["wq"]["b"].detach(), before)
                  for i, before in zip((0, -1), b_before))
    base_same = base_checksums(base) == base_before
    tokens = TRAIN_BATCH * TRAIN_SEQ
    expect = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    row = {"phase": "lora_train", "config": "llama_3_8b", "layers": cfg.n_layers,
           "rank": 8, "targets": list(lora.targets), "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "optimizer": "torch.optim.Adam(lr=1e-3)", "remat": True,
           "step_ms": step_ms, "ms_per_step": timed_ms,
           "tokens_per_s": tokens / timed_ms * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step_fwd_dq_dkv": [list(x) for x in per_step],
           "losses": losses, "adapter_b_moved": b_moved,
           "base_leaves_checked": len(base_before) // 2,
           "base_bit_identical": base_same, "card": card}
    row["ok"] = (all(x == expect for x in per_step) and b_moved and base_same
                 and all(np.isfinite(losses)))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"lora_train phase failed: {row}")
    # finetune_lora.py's serving path: merge, quantize, generate
    with torch.no_grad():
        adapters = {"layers": [{t: {k: v.detach() for k, v in ab.items()}
                                for t, ab in layer.items()}
                               for layer in state[0]["layers"]]}
        del state
        merged = tlora.merge_lora(base, adapters, lora)
        served = quantize_params(merged)
        del merged, base
        gen = torch.Generator(device="cuda").manual_seed(18)
        prompt = torch.randint(1, cfg.vocab_size, (2, 128), generator=gen, device="cuda")
        zero_counts()
        t0 = time.time()
        out = gen_mod.generate(served, prompt, cfg, max_new_tokens=16)
        torch.cuda.synchronize()
        wall = time.time() - t0
    serve = {"phase": "lora_merge_int8_generate", "prompt": [2, 128], "new_tokens": 16,
             "seconds": wall, "flash_launches": counts()[0], "card": card}
    serve["ok"] = (tuple(out.shape) == (2, 16) and serve["flash_launches"] == cfg.n_layers
                   and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    emit(serve)
    if not serve["ok"]:
        raise SystemExit(f"merged int8 serving failed: {serve}")
    return row


def mixtral_config(**overrides):
    """Mixtral-8x7B's shape (mistralai/Mixtral-8x7B-v0.1, config.json):
    vocab 32000, d 4096, 32 layers, 32 / 8 heads, d_ff 14336, 8 experts,
    top-2, rope_theta 1e6, rms eps 1e-5, no sliding window, untied; the
    reference's default capacity factor 1.25; the flash kernel."""
    from nos_tpu_torch.models.llama import LlamaConfig

    shape = dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                 d_ff=14336, n_experts=8, moe_top_k=2, rope_theta=1e6, norm_eps=1e-5,
                 attention="flash")
    return LlamaConfig(**{**shape, **overrides})


def tied_routers(params):
    """The same tree with every router zero: each token's experts tie,
    so routing is [0, 1] for every token whatever the rounding upstream.
    Shares every other tensor with ``params``."""
    import torch

    return dict(params, layers=[
        dict(layer, moe=dict(layer["moe"], router=torch.zeros_like(layer["moe"]["router"])))
        for layer in params["layers"]])


def dense_moe_oracle(params, x, top_k):
    """A plain per-token MoE: each token's top-k experts by f32 router
    probability (renormalised), every expert applied densely to the
    tokens that chose it, no capacity."""
    import torch
    import torch.nn.functional as F

    flat = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(flat.float() @ params["router"], dim=-1)
    weight, expert = torch.topk(probs, top_k, dim=-1)
    weight = weight / weight.sum(dim=-1, keepdim=True)
    out = torch.zeros(flat.shape, dtype=torch.float32, device=x.device)
    for e in range(params["router"].shape[1]):
        rows, slot = (expert == e).nonzero(as_tuple=True)
        h = flat[rows]
        y = (F.silu(h @ params["w_gate"][e]) * (h @ params["w_up"][e])) @ params["w_down"][e]
        out.index_add_(0, rows, y.float() * weight[rows, slot, None])
    return out.to(x.dtype).reshape(x.shape)


def rel_frobenius(got, want) -> float:
    import torch

    return float(torch.linalg.vector_norm((got - want).float())
                 / torch.linalg.vector_norm(want.float()))


def moe_check_phase(card) -> None:
    """moe_mlp at Mixtral width (bf16, [1, 1024] hidden states, two
    layers of random experts) against the dense per-token oracle at
    capacity factor 8 (nothing dropped); the pairs dropped at the
    default factor; a zero router's ties on the card; a tiny f32 MoE on
    the card against the CPU."""
    import torch

    from nos_tpu_torch.models import moe as tm

    cfg = mixtral_config()
    mc = cfg.moe_config()
    wide = dataclasses.replace(mc, capacity_factor=8.0)
    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
    flat = x.reshape(1024, cfg.d_model)
    layers = []
    with torch.no_grad():
        for _ in range(2):
            params = tm.init_moe_params(gen, mc)
            got = tm.moe_mlp(params, x, wide)
            want = dense_moe_oracle(params, x, cfg.moe_top_k)
            keep = tm._route(flat, params["router"], mc)[4]
            layers.append({"rel_frobenius_err": rel_frobenius(got, want),
                           "max_abs_err": float((got - want).abs().max()),
                           "dropped_pairs_default_factor": int((~keep).sum()),
                           "finite": bool(torch.isfinite(got).all())})
            del params, got, want
        tie_experts = tm._route(flat, torch.zeros((cfg.d_model, mc.n_experts), device="cuda"),
                                mc)[1]
        ties_ok = bool((tie_experts == torch.tensor([0, 1], device="cuda")).all())
        # tiny f32 MoE: the card against the CPU
        tiny = tm.MoeConfig(d_model=64, d_ff=128, n_experts=8, top_k=2, dtype=torch.float32)
        cpu_gen = torch.Generator().manual_seed(32)
        cpu_p = tm.init_moe_params(cpu_gen, tiny)
        cpu_x = torch.randn((2, 48, 64), generator=cpu_gen)
        card_p = {k: v.cuda() for k, v in cpu_p.items()}
        want_route = tm._route(cpu_x.reshape(96, 64), cpu_p["router"], tiny)
        got_route = tm._route(cpu_x.reshape(96, 64).cuda(), card_p["router"], tiny)
        same_routing = all(torch.equal(got_route[i].cpu(), want_route[i]) for i in (1, 3, 4))
        tiny_err = float((tm.moe_mlp(card_p, cpu_x.cuda(), tiny).cpu()
                          - tm.moe_mlp(cpu_p, cpu_x, tiny)).abs().max())
    row = {"phase": "moe_check", "config": "mixtral_8x7b", "hidden": [1, 1024],
           "capacity_factor_checked": 8.0, "capacity_factor_default": mc.capacity_factor,
           "capacity_default": tm.capacity_per_expert(1024, mc),
           "layers": layers, "rel_limit": 2e-2,
           "zero_router_experts_0_1": ties_ok, "tiny_same_routing": same_routing,
           "tiny_max_abs_err": tiny_err, "tiny_atol": 1e-5, "card": card}
    row["ok"] = (all(r["finite"] and r["rel_frobenius_err"] <= 2e-2 for r in layers)
                 and ties_ok and same_routing and tiny_err <= 1e-5)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"moe_mlp disagrees on the card: {row}")


def moe_train_grads_phase(card) -> dict:
    """llama_loss gradients of a 2-layer Mixtral-width model, [1, 1024],
    bf16: flash (the three kernels) against dense, held with tied
    routers. A random router's near-ties can route a token to another
    expert on the two paths (their bf16 attention rounds differently),
    which moves one token's share of the stacks' gradients: that run is
    reported beside it, not held."""
    import torch

    from nos_tpu_torch.models import llama

    cfg = mixtral_config(n_layers=2)
    params = llama.init_llama_params(cfg, seed=41, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(41)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    held = flash_dense_grads(tied_routers(params), tokens, cfg)
    random_router = flash_dense_grads(params, tokens, cfg)
    with torch.no_grad():
        _, aux = llama.llama_forward(params, tokens, cfg, with_aux=True)
    row = {"phase": "moe_train_grads", "config": "mixtral_8x7b", "layers": 2,
           "tokens": [1, 1024], **held, "random_router": random_router,
           "aux_random_router": float(aux), "loss_limit": LOSS_LIMIT,
           "grad_rel_limit": GRAD_REL_LIMIT, "card": card}
    row["ok"] = grads_hold(held, cfg.n_layers) and bool(torch.isfinite(aux))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"MoE flash gradients disagree with dense: {row}")
    return row


def mixtral_int8_tree(cfg, seed=51):
    """The int8 serving tree of a random Mixtral, built one layer at a
    time (the bf16 tree, 93 GB, does not fit on the card): a one-layer
    model drawn from its own seed, quantized, its layer kept; embedding,
    lm_head and final norm come from the first draw."""
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.quantize import quantize_params

    one = dataclasses.replace(cfg, n_layers=1)
    tree = None
    for i in range(cfg.n_layers):
        q = quantize_params(llama.init_llama_params(one, seed=seed + i, device="cuda"))
        if tree is None:
            tree = q
        else:
            tree["layers"].append(q["layers"][0])
    return tree


def mixtral_int8_phase(card, ep_ref=None) -> dict:
    """Mixtral-8x7B at full width and depth in int8: conversion, the
    2-layer oracle check, flash against dense, generate(), one decode
    step beside its weight-read bound, the Engine, a lone request. With
    ``ep_ref`` (a directory) it also leaves there what the ep phases are
    held against: the flash logits of [1, EP_FORWARD_SEQ] seeded tokens
    (``logits.pt``) and generate()'s prompt and tokens (``serve.pt``)."""
    import torch

    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models import quantize as tq
    from nos_tpu_torch.models.decode_bench import time_decode
    from nos_tpu_torch.serve import Engine, GenRequest

    cfg = mixtral_config()
    t_start = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tree = mixtral_int8_tree(cfg)
    torch.cuda.synchronize()
    wbytes = tq.weight_bytes(tree)
    emit({"phase": "mixtral_int8_convert", "config": "mixtral_8x7b", "weights": "int8",
          "layers": cfg.n_layers, "weight_bytes": wbytes, "seconds": time.time() - t0,
          "conversion_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "resident_gib": torch.cuda.memory_allocated() / 2**30, "card": card})
    tied = tied_routers(tree)
    gen = torch.Generator(device="cuda").manual_seed(52)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device="cuda")
    checks = {}
    with torch.no_grad():
        # 2 layers: int8 against the fake-quant oracle (held tied, as above)
        two = dataclasses.replace(cfg, n_layers=2)
        for name, params in (("tied", tied), ("random_router", tree)):
            sliced = dict(params, layers=params["layers"][:2])
            got = llama.llama_forward(sliced, tokens, two)
            want = llama.llama_forward(tq.dequantize_params(sliced, cfg.dtype), tokens, two)
            checks[f"oracle_{name}"] = {
                "rel_frobenius_err": rel_frobenius(got, want),
                "top1_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
                "finite": bool(torch.isfinite(got).all())}
            del got, want
        # full depth: flash against dense (held tied, the Llama phase's limits)
        for name, params in (("tied", tied), ("random_router", tree)):
            flash = llama.llama_forward(params, tokens, cfg)
            dense = llama.llama_forward(params, tokens, dataclasses.replace(cfg, attention="dense"))
            checks[f"flash_dense_{name}"] = logits_agreement(flash, dense)
            del flash, dense
        if ep_ref is not None:
            ep_tokens = torch.randint(0, cfg.vocab_size, (1, EP_FORWARD_SEQ),
                                      generator=torch.Generator(device="cuda").manual_seed(53),
                                      device="cuda")
            torch.save(llama.llama_forward(tree, ep_tokens, cfg).cpu(),
                       os.path.join(ep_ref, "logits.pt"))
            del ep_tokens
    oracle, fd = checks["oracle_tied"], checks["flash_dense_tied"]
    row = {"phase": "mixtral_int8_checks", "tokens": [1, 1024], **checks,
           "rel_limit": QUANT_REL_LIMIT["int8"], "card": card}
    row["ok"] = (oracle["finite"] and oracle["rel_frobenius_err"] <= QUANT_REL_LIMIT["int8"]
                 and logits_hold(fd))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"Mixtral int8 checks failed: {row}")
    del tied

    # the main path: generate() with the launch counts zeroed just before
    with torch.no_grad():
        prompt = torch.randint(1, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        out = gen_mod.generate(tree, prompt, cfg, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = counts()[0]
    row = {"phase": "mixtral_generate", "weights": "int8", "prompt": [2, 512],
           "new_tokens": 32, "flash_launches": launches, "seconds": wall,
           "tokens_per_s": 2 * 32 / wall, "card": card}
    row["ok"] = (tuple(out.shape) == (2, 32) and launches == cfg.n_layers
                 and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"Mixtral generate() failed: {row}")
    if ep_ref is not None:
        torch.save({"prompt": prompt.cpu(), "generated": out.cpu()},
                   os.path.join(ep_ref, "serve.pt"))

    # the prefill alone, and one decode step at the generate shapes beside
    # the weight-read bound
    with torch.no_grad():
        t0 = time.perf_counter()
        gen_mod.prefill(tree, prompt, cfg, 544)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        ms, run = time_decode(tree, cfg, prompt, out[:, 0], False, steps=4, max_len=544)
        emit({"phase": "mixtral_decode_step", "weights": "int8", "batch": 2,
              "prefill_ms": prefill_ms, "cache_len": 544, "ms_per_step": ms,
              "weight_bytes": wbytes,
              "weight_read_bound_ms": wbytes / PEAK_HBM_BYTES_S * 1e3, "card": card})
        emit(profile_steps(run, card, ms, steps=2, phase="mixtral_decode_profile"))
        del run

    # the Engine: padded (20, 100) and chunked (300, 600) admission
    rng_tokens = torch.randint(1, cfg.vocab_size, (1020,), generator=gen,
                               device="cuda").tolist()
    prompts = [rng_tokens[:20], rng_tokens[20:120], rng_tokens[120:420], rng_tokens[420:]]

    def serve(reqs):
        eng = Engine(tree, cfg, max_slots=4, max_len=1024, prefill_chunk=256)
        with torch.no_grad():
            t0 = time.time()
            ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32)) for p in reqs]
            got = eng.run()
            torch.cuda.synchronize()
        return [got[i] for i in ids], time.time() - t0

    results, wall = serve(prompts)
    row = {"phase": "mixtral_engine", "weights": "int8", "slots": 4,
           "requests": len(prompts), "prompt_tokens": [len(p) for p in prompts],
           "new_tokens": 32, "seconds": wall, "tokens_per_s": 32 * len(prompts) / wall,
           "card": card}
    row["ok"] = all(len(r) == 32 and all(0 <= t < cfg.vocab_size for t in r)
                    for r in results)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"Mixtral engine failed: {row}")
    # a lone request in the 4-slot engine against a solo generate(): bf16
    # in other batch shapes and admission paths drifts, so only reported
    (lone,), lone_s = serve(prompts[1:2])
    with torch.no_grad():
        solo = gen_mod.generate(tree, torch.tensor([prompts[1]], device="cuda"), cfg,
                                max_new_tokens=32)[0].tolist()
    first_diff = next((i for i, (a, b) in enumerate(zip(lone, solo)) if a != b), 32)
    emit({"phase": "mixtral_engine_lone", "prompt_tokens": len(prompts[1]),
          "seconds": lone_s, "tokens_per_s": 32 / lone_s,
          "share_equal_to_solo_generate": sum(a == b for a, b in zip(lone, solo)) / 32,
          "tokens_before_first_divergence": first_diff,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "phase_seconds": time.time() - t_start, "card": card})
    return {"launches_generate": launches}


def profile_steps(run_steps, card, step_ms: float, steps: int = 8,
                  phase: str = "decode_profile") -> dict:
    """torch.profiler over ``run_steps(steps)``: device-busy time, the
    idle share of the wall time (profiled, and against the unprofiled
    ``step_ms``), kernel launches, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_steps(steps)
        wall_us = (time.time() - t0) * 1e6
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us, ev.count, ev.key))
    busy_us = sum(us for us, _, _ in kernels)
    copy_us = sum(us for us, _, key in kernels if "copy" in key.lower())
    kernels.sort(reverse=True)
    return {
        "phase": phase, "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        # dtype conversions and copies (the int8 -> bf16 widening among them)
        "copy_kernels_ms_per_step": copy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_idle_share_unprofiled": 1.0 - busy_us / steps / 1e3 / step_ms,
        "kernel_launches_per_step": sum(n for _, n, _ in kernels) / steps,
        "top_kernels": [{"name": k[:80], "ms_per_step": us / steps / 1e3,
                         "launches_per_step": n / steps}
                        for us, n, k in kernels[:12]],
        "card": card,
    }


# ---------------------------------------------------------- the model bench
# The attention op alone (bf16, one layer), flash against the model's
# dense path: relative Frobenius error of O and of each gradient. Both
# round the probabilities to bf16 (about 0.4% a rounding) at other
# points, and the gradients round once more.
BENCH_ATTN_REL_LIMIT = 2e-2


def teacher_forced(params, cfg, context, fed):
    """Dense ``llama_forward`` logits [B, ctx + n, vocab] over ``context``
    [B, ctx] followed by ``fed`` [B, n]: what a prefill of the context
    and n decode steps fed those tokens should give at each position."""
    import torch

    from nos_tpu_torch.models import llama

    seq = torch.cat([context, fed], dim=1)
    with torch.no_grad():
        return llama.llama_forward(params, seq, dataclasses.replace(cfg, attention="dense"))


def stream_against_forward(params, cfg, prompt, stream, wrap_at: int) -> dict:
    """A greedy stream held against the dense forward over prompt +
    stream: at each position the share of tokens that are the forward's
    argmax, and the largest gap between the forward's top logit and the
    stream token's, over max |logits|. Logits within FWD_REL_LIMIT of the
    forward's (the bound a flash-against-dense forward holds) can only
    choose a token within 2 x FWD_REL_LIMIT of the top; a cache that
    served the wrong keys picks tokens the forward ranks anywhere. Also
    the share among the tokens at positions > ``wrap_at`` (a rolling
    cache's modulus: tokens from steps whose writes wrapped)."""
    import torch

    from nos_tpu_torch.models import llama

    device = llama.params_device(params)
    context = torch.tensor([list(prompt)], device=device)
    fed = torch.tensor([list(stream[:-1])], device=device)
    logits = teacher_forced(params, cfg, context, fed)[0, len(prompt) - 1:]
    tok = torch.tensor(list(stream), device=device)
    gap = (logits.max(-1).values - logits.gather(-1, tok[:, None])[:, 0]) / logits.abs().max()
    hit = logits.argmax(-1) == tok
    wrapped = hit[max(0, wrap_at + 1 - len(prompt)):]
    return {"argmax_share": float(hit.float().mean()), "max_gap_rel": float(gap.max()),
            "wrapped_tokens": int(wrapped.numel()),
            "wrapped_argmax_share": float(wrapped.float().mean()) if wrapped.numel() else None,
            "finite": bool(torch.isfinite(logits).all())}


def stream_holds(stats) -> bool:
    return (stats["finite"] and stats["argmax_share"] >= FWD_ARGMAX_LIMIT
            and stats["max_gap_rel"] <= 2 * FWD_REL_LIMIT)


def model_bench_phase(card) -> dict:
    """``nos_tpu_torch.bench.run_model_bench`` at ``BenchSizes.quick()``:
    every section once at bench.py's shapes, then its outputs checked:
    the train losses finite; flash against dense logits (the FWD_*
    limits) at the train batch, at [1, 4096] and under the 1024 window
    there; the [8, 4096] flash prefill's last logits and each decode
    step's on the bf16 cache against a dense forward over the context
    and the tokens the steps were fed (FWD_*; the int8 cache's
    reported); the
    attention op's O and gradients (BENCH_ATTN_REL_LIMIT); both rolling
    streams, physical and rolling cache, against a windowed dense
    forward over their own tokens (``stream_holds``; the rolling cache's
    writes wrap for the stream's last ~75 tokens); each section's
    launches against the counts its shapes imply. The share of tokens
    the two streams share is reported (bf16 drift parts them)."""
    import torch

    from nos_tpu_torch import bench
    from nos_tpu_torch.models import llama

    sizes = bench.BenchSizes.quick()
    cfg = sizes.config
    outs = {}
    zero_counts()
    t0 = time.time()
    result = bench.run_model_bench("cuda", sizes, outputs=outs)
    seconds = time.time() - t0
    totals = counts()
    t_check = time.time()
    params = outs["params"]
    losses = outs["train"]["losses"]
    forward = logits_agreement(outs["forward_flash"]["logits"], outs["forward"]["logits"])
    att = outs["attention"]
    attn_errs = {"o": rel_frobenius(att["flash"], att["dense"])}
    for name, got, want in zip(("dq", "dk", "dv"), att["flash_grads"], att["dense_grads"]):
        attn_errs[name] = rel_frobenius(got, want)
    ctx_tokens = outs["decode"]["ctx_tokens"]
    ctx = {}
    for kind, run in outs["decode"]["ctx"].items():
        want = teacher_forced(params, cfg, ctx_tokens, run["fed"])[:, ctx_tokens.shape[1] - 1:]
        ctx[kind] = {"prefill": logits_agreement(run["logits"][:, 0], want[:, 0]),
                     "prefill_and_steps": logits_agreement(run["logits"], want)}
        del want
    seq = sizes.long_seqs[0]
    long_ctx = outs["long_context"][seq]
    long_flash = logits_agreement(long_ctx["flash"], long_ctx["dense"])
    with torch.no_grad():
        window_dense = llama.llama_forward(
            params, long_ctx["tokens"], dataclasses.replace(cfg, sliding_window=sizes.window))
    window = logits_agreement(long_ctx["window"], window_dense)
    del window_dense
    rolling = outs["rolling"]
    prompt = rolling["prompt"]
    modulus = sizes.window + len(prompt)  # the rolling cache's
    wcfg = dataclasses.replace(cfg, sliding_window=sizes.window)
    streams = {name: stream_against_forward(params, wcfg, prompt, rolling[name], modulus)
               for name in ("physical", "rolling")}
    lens_ok = len(rolling["physical"]) == len(rolling["rolling"]) == sizes.rolling_new
    first_diff = next((i for i, (a, b) in enumerate(zip(rolling["physical"],
                                                         rolling["rolling"])) if a != b),
                      None)
    row = {"phase": "model_bench", "sizes": "BenchSizes.quick()", "seconds": seconds,
           "check_seconds": time.time() - t_check, "result": result,
           "train_losses": losses, "flash_vs_dense_forward": forward,
           "long_flash_vs_dense": long_flash, "window_flash_vs_dense": window,
           "window": sizes.window, "long_seq": seq, "ctx_decode_vs_dense": ctx,
           "attention_op_rel_err": attn_errs, "attention_op_limit": BENCH_ATTN_REL_LIMIT,
           "streams_vs_windowed_dense": streams, "stream_gap_limit": 2 * FWD_REL_LIMIT,
           "rolling_vs_physical_token_share": agreement([rolling["rolling"]],
                                                        [rolling["physical"]]),
           "rolling_first_differing_token": first_diff,
           "launches": outs["launches"], "expected_launches": outs["expected_launches"],
           "launches_total_fwd_dq_dkv": list(totals), "card": card}
    row["ok"] = (all(math.isfinite(x) for x in losses)
                 and logits_hold(forward) and logits_hold(long_flash) and logits_hold(window)
                 and logits_hold(ctx["bf16"]["prefill_and_steps"])
                 and ctx["int8"]["prefill_and_steps"]["finite"]
                 and max(attn_errs.values()) <= BENCH_ATTN_REL_LIMIT
                 and lens_ok and all(stream_holds(v) for v in streams.values())
                 and streams["rolling"]["wrapped_tokens"] > 0
                 and outs["launches"] == outs["expected_launches"])
    del outs, params
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"model_bench failed: {row}")
    return row


def bench_launches(model_bench, index: int) -> dict:
    """Launches of kernel ``index`` (0 forward, 1 dQ, 2 dK/dV) in each
    section of the model bench that launched it."""
    return {name: c[index] for name, c in model_bench["launches"].items() if c[index]}


# ----------------------------------------- ResNet, checkpoints, SLO, examples
RESNET_BATCH, RESNET_SIZE = 128, 224
# bf16 ResNet-50 against an f32 forward of the same weights (TF32 off):
# relative Frobenius error of the logits and top-1 agreement. bf16 keeps
# 8 mantissa bits (about 0.4% a rounding) and the error of ~50 rounded
# layers averages down over each conv's sums (0.27% on the CPU at B 8).
RESNET_REL_LIMIT = 2e-2
RESNET_TOP1_LIMIT = 0.9
# a tiny f32 ResNet on the card against the CPU: cuDNN may pick other
# f32 algorithms (FFT, Winograd) than the CPU's direct sums
RESNET_CPU_RTOL = 1e-4
HF_SHARD_BYTES = 5 * 10**9  # transformers' default max_shard_size, 5 GB
SLO_SMOKE_ARGS = ["--card", "--duration", "8", "--rate", "3"]


def resnet_flops(cfg, size: int) -> tuple:
    """(forward, forward + backward) operations of one image through ResNet
    ``cfg`` at ``size`` x ``size``, counted from the conv shapes: 2 per
    multiply-add of every conv and the head; the backward computes each
    weight's gradient and each conv's input gradient but the stem's
    (the images take none). Elementwise ops (norms, relu, adds, the
    pool) are left out: under 1% of the total."""
    def conv(n, k, cin, cout, stride):
        out = -(-n // stride)
        return out, 2 * out * out * k * k * cin * cout

    n, stem = conv(size, 7, 3, cfg.width, 2)
    n = -(-n // 2)  # the 3x3/2 max-pool
    fwd, dgrad = stem, 0
    cin = cfg.width
    for stage, blocks in enumerate(cfg.stage_sizes):
        width = cfg.width * 2 ** stage
        for block in range(blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            _, f1 = conv(n, 1, cin, width, 1)
            m, f2 = conv(n, 3, width, width, stride)
            _, f3 = conv(m, 1, width, width * 4, 1)
            fp = conv(n, 1, cin, width * 4, stride)[1] if block == 0 else 0
            fwd += f1 + f2 + f3 + fp
            dgrad += f1 + f2 + f3 + fp
            n, cin = m, width * 4
    head = 2 * cin * cfg.num_classes
    fwd += head
    # backward: every weight's gradient (the forward's operations again)
    # and every input gradient but the stem's
    return fwd, fwd + fwd + dgrad + head


def resnet_phase(card) -> dict:
    """ResNet-50 (bf16, channels_last) at B 128, 224 x 224: logits against
    an f32 forward on the card, a tiny f32 config on the card against the
    CPU at 33 x 33, forward and forward + backward images/s beside the
    bound, peak memory, the profiler's top kernels."""
    import torch
    import torch.nn.functional as F

    from nos_tpu_torch.models import resnet
    from nos_tpu_torch.models.llama import tree_leaves, tree_map
    from nos_tpu_torch.util.cuda_timing import event_ms

    t_phase = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = resnet.ResNetConfig()
    params = resnet.init_resnet_params(torch.Generator(device="cuda").manual_seed(11), cfg)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    gen = torch.Generator(device="cuda").manual_seed(12)
    images = torch.randn((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3), generator=gen,
                         device="cuda")
    labels = torch.randint(0, cfg.num_classes, (RESNET_BATCH,), generator=gen, device="cuda")

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        got = resnet.resnet_forward(params, images, cfg)
        want = resnet.resnet_forward(tree_map(torch.Tensor.float, params), images, cfg32)
    rel = float((got - want).norm() / want.norm())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(got).all())

    tiny = dataclasses.replace(resnet.tiny_resnet_config(), dtype=torch.float32)
    tiny_gpu = resnet.init_resnet_params(torch.Generator(device="cuda").manual_seed(13), tiny)
    small = torch.randn((4, 33, 33, 3), generator=gen, device="cuda")
    with torch.no_grad():
        a = resnet.resnet_forward(tiny_gpu, small, tiny).cpu()
        b = resnet.resnet_forward(tree_map(torch.Tensor.cpu, tiny_gpu), small.cpu(), tiny)
    tiny_err = float((a - b).abs().max() / b.abs().max())

    def forward():
        with torch.no_grad():
            resnet.resnet_forward(params, images, cfg)

    for t in leaves:
        t.requires_grad_(True)

    def forward_backward():
        loss = F.cross_entropy(resnet.resnet_forward(params, images, cfg), labels)
        torch.autograd.grad(loss, leaves)

    fwd_ms = event_ms(forward, reps=10)
    torch.cuda.reset_peak_memory_stats()
    train_ms = event_ms(forward_backward, reps=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30

    def run_steps(n):
        for _ in range(n):
            forward_backward()
        torch.cuda.synchronize()

    profile = profile_steps(run_steps, card, train_ms, steps=3, phase="resnet_profile")
    transposes = [k for k in profile["top_kernels"]
                  if any(s in k["name"].lower() for s in ("nchwtonhwc", "nhwctonchw", "transpose"))]
    fwd_flops, train_flops = resnet_flops(cfg, RESNET_SIZE)
    io_bytes = images.numel() * 4 + 2 * n_params + RESNET_BATCH * cfg.num_classes * 4
    bound = {kind: max(flops * RESNET_BATCH / PEAK_BF16_FLOPS, io_bytes / PEAK_HBM_BYTES_S) * 1e3
             for kind, flops in (("forward", fwd_flops), ("train", train_flops))}
    row = {"phase": "resnet", "config": "resnet50", "params": n_params,
           "batch": RESNET_BATCH, "size": RESNET_SIZE, "dtype": "bf16",
           "memory_format": "channels_last",
           "logits_rel_frobenius_vs_f32": rel, "rel_limit": RESNET_REL_LIMIT,
           "top1_agreement_vs_f32": top1, "top1_limit": RESNET_TOP1_LIMIT,
           "f32_reference": "the same weights in f32 on the card, cudnn.allow_tf32 False",
           "tiny_card_vs_cpu_max_rel": tiny_err, "tiny_rtol": RESNET_CPU_RTOL,
           "gflop_per_image_forward": fwd_flops / 1e9,
           "gflop_per_image_train": train_flops / 1e9,
           "forward_ms": fwd_ms, "forward_images_per_s": RESNET_BATCH / fwd_ms * 1e3,
           "forward_bound_ms": bound["forward"], "forward_bound_by": "operations",
           "forward_tflops": fwd_flops * RESNET_BATCH / fwd_ms / 1e9,
           "train_ms": train_ms, "train_images_per_s": RESNET_BATCH / train_ms * 1e3,
           "train_bound_ms": bound["train"], "train_bound_by": "operations",
           "train_tflops": train_flops * RESNET_BATCH / train_ms / 1e9,
           "train_peak_gib": peak, "layout_transpose_kernels": transposes,
           "seconds": time.time() - t_phase, "card": card}
    row["ok"] = (finite and rel <= RESNET_REL_LIMIT and top1 >= RESNET_TOP1_LIMIT
                 and tiny_err <= RESNET_CPU_RTOL)
    emit(row)
    emit(profile)
    if not row["ok"]:
        raise SystemExit(f"resnet failed: {row}")
    return row


def hf_tensors(params, cfg):
    """The transformers names of a Llama params tree, in checkpoint
    order, each with a function giving its tensor ([out, in] for a
    matrix) when the writer reaches it."""
    out = [("model.embed_tokens.weight", lambda: params["embed"])]
    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}."
        out += [
            (pre + "input_layernorm.weight", lambda l=layer: l["attn_norm"]),
            (pre + "self_attn.q_proj.weight", lambda l=layer: l["wq"].T),
            (pre + "self_attn.k_proj.weight", lambda l=layer: l["wk"].T),
            (pre + "self_attn.v_proj.weight", lambda l=layer: l["wv"].T),
            (pre + "self_attn.o_proj.weight", lambda l=layer: l["wo"].T),
            (pre + "post_attention_layernorm.weight", lambda l=layer: l["mlp_norm"]),
            (pre + "mlp.gate_proj.weight", lambda l=layer: l["w_gate"].T),
            (pre + "mlp.up_proj.weight", lambda l=layer: l["w_up"].T),
            (pre + "mlp.down_proj.weight", lambda l=layer: l["w_down"].T),
        ]
    out += [("model.norm.weight", lambda: params["final_norm"])]
    if not cfg.tie_embeddings:
        out += [("lm_head.weight", lambda: params["lm_head"].T)]
    return out


def write_hf_checkpoint(path, params, cfg, shard_bytes) -> dict:
    """``params`` (bf16) as a transformers Llama checkpoint under ``path``:
    ``config.json``, safetensors shards of at most ``shard_bytes`` and
    ``model.safetensors.index.json``. The package has no writer (the
    reference has none); this one writes only what ``save_pretrained``
    would, tensor by tensor from the card."""
    import struct

    import torch

    named = hf_tensors(params, cfg)
    shapes = {name: tuple(fn().shape) for name, fn in named}
    sizes = {name: 2 * math.prod(shape) for name, shape in shapes.items()}
    shards, current, used = [], [], 0
    for name, _ in named:
        if current and used + sizes[name] > shard_bytes:
            shards.append(current)
            current, used = [], 0
        current.append(name)
        used += sizes[name]
    shards.append(current)
    fns = dict(named)
    weight_map = {}
    for k, names in enumerate(shards):
        file = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        header, at = {"__metadata__": {"format": "pt"}}, 0
        for name in names:
            header[name] = {"dtype": "BF16", "shape": list(shapes[name]),
                            "data_offsets": [at, at + sizes[name]]}
            at += sizes[name]
            weight_map[name] = file
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        with open(os.path.join(path, file), "wb") as f:
            f.write(struct.pack("<Q", len(blob)) + blob)
            for name in names:
                t = fns[name]().contiguous().cpu()
                f.write(t.view(torch.uint8).numpy().data)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes.values())},
                   "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
            "intermediate_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "hidden_act": "silu", "rms_norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta, "rope_scaling": None,
            "tie_word_embeddings": cfg.tie_embeddings, "torch_dtype": "bfloat16",
        }, f)
    return {"shards": len(shards), "bytes": sum(sizes.values()), "tensors": len(named)}


class RssPeak:
    """The process's peak resident set above its level at entry, sampled
    from /proc every 20 ms on a thread of its own."""

    def __enter__(self):
        import threading

        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    @property
    def above_base_gb(self) -> float:
        return (self.peak - self.base) / 1e9


def hf_checkpoint_phase(card, path) -> tuple:
    """Llama-3-8B at full width and depth, drawn from seed 0 on the card,
    written under ``path`` as a sharded transformers checkpoint and
    loaded back with ``load_hf_llama(path)``: every tensor bit-equal to
    what was written, the config ``llama_3_8b_config()``. Returns the
    loaded (params, config): the model phases run on it."""
    import torch

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.convert import load_hf_llama

    cfg = llama.llama_3_8b_config()
    t0 = time.time()
    drawn = llama.init_llama_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.time() - t0
    t0 = time.time()
    written = write_hf_checkpoint(path, drawn, cfg, HF_SHARD_BYTES)
    write_s = time.time() - t0
    with RssPeak() as rss:
        t0 = time.time()
        params, loaded_cfg = load_hf_llama(path, torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        load_s = time.time() - t0
    got, want = llama.tree_leaves(params), llama.tree_leaves(drawn)
    bit_equal = len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        for g, w in zip(got, want))
    del drawn, want
    torch.cuda.empty_cache()
    largest = max(t.numel() * 2 for t in got)
    row = {"phase": "hf_checkpoint", "config": "llama_3_8b", "params": sum(t.numel() for t in got),
           "layers": cfg.n_layers, **written, "shard_limit_bytes": HF_SHARD_BYTES,
           "draw_s": draw_s, "write_s": write_s, "write_gb_per_s": written["bytes"] / write_s / 1e9,
           "load_s": load_s, "load_gb_per_s": written["bytes"] / load_s / 1e9,
           "write_goes_to": "the page cache (no sync; the machine has 100 GB of RAM)",
           "load_reads": "the page cache, just after the write",
           "host_peak_rss_above_start_gb": rss.above_base_gb,
           "largest_tensor_gb": largest / 1e9, "bit_equal": bit_equal,
           "config_equal": loaded_cfg == cfg, "card": card}
    row["ok"] = bit_equal and loaded_cfg == cfg and written["shards"] >= 2
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"checkpoint round trip failed: {row}")
    return params, loaded_cfg


ROUTER_EPOCH_S = 4.0
ROUTER_COLD_START_S = 2.0


def router_drive(clock) -> dict:
    """nos_tpu_torch.slo.routing.ReplicaRouter on the calibrated clock's
    costs: one model at 3 requests a second, no replica for the first
    epoch (its arrivals wait in the backlog), then 2 replicas that come
    up ROUTER_COLD_START_S into the second. The backlog and the queue
    depth the signal registry saw, the cold-start TTFT p95 (the
    requests that arrived with no replica) beside every request's, and
    the wall seconds of the drive (virtual latencies, no device)."""
    from nos_tpu_torch.slo import ModelProfile, WorkloadConfig, build_arrivals
    from nos_tpu_torch.slo.driver import percentiles
    from nos_tpu_torch.slo.routing import ReplicaRouter
    from nos_tpu_torch.controllers.autoscaler.signals import SignalRegistry

    arrivals = build_arrivals(WorkloadConfig(seed=0, duration_s=2 * ROUTER_EPOCH_S,
                                             rate_rps=3.0, models=(ModelProfile("llama"),)))
    done, registry = [], SignalRegistry()
    router = ReplicaRouter(registry, max_slots=4, tick_cost_s=clock["tick_cost_s"],
                           prefill_token_cost_s=clock["prefill_token_cost_s"],
                           on_complete={"llama": done.append})
    t0 = time.perf_counter()
    router.sync_replicas("llama", [], ready_t=0.0)
    router.drive("llama", [a for a in arrivals if a.t < ROUTER_EPOCH_S], ROUTER_EPOCH_S)
    backlog = len(router.backlog["llama"])
    queue_depth = registry.get("llama").queue_depth
    router.sync_replicas("llama", ["llama-0", "llama-1"],
                         ready_t=ROUTER_EPOCH_S + ROUTER_COLD_START_S)
    router.drive("llama", [a for a in arrivals if a.t >= ROUTER_EPOCH_S], 2 * ROUTER_EPOCH_S)
    wall = time.perf_counter() - t0
    cold = [r.ttft_s for r in done if r.submit_t < ROUTER_EPOCH_S]
    row = {"replicas": "0 -> 2", "arrivals": len(arrivals), "backlog_with_no_replica": backlog,
           "queue_depth_signal": queue_depth, "completed": len(done),
           "cold_start_ttft_s": percentiles(cold),
           "ttft_s": percentiles([r.ttft_s for r in done]), "wall_s": wall}
    row["ok"] = (0 < backlog == queue_depth and len(done) == len(arrivals)
                 and row["cold_start_ttft_s"]["p95"] >= ROUTER_COLD_START_S and wall < 1.0)
    return row


def slo_serve_phase(card, params, cfg) -> dict:
    """The serving SLO bench (nos_tpu_torch.slo.bench_serve --card) on the
    loaded Llama-3-8B: the virtual clock calibrated on the card, a short
    workload; the report and the SLO verdicts; then the replica router
    on the calibrated clock (``router_drive``)."""
    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.slo import bench_serve, build_arrivals

    args = bench_serve.parse_args(SLO_SMOKE_ARGS)
    fa.LAUNCHES = 0
    report = bench_serve.run(args, params=params, model_config=cfg)
    agg = report["aggregate"]
    arrivals = len(build_arrivals(bench_serve.workload(args)))
    numbers = [agg[k][p] for k in ("ttft_s", "tpot_s", "e2e_s", "queue_wait_s")
               for p in ("p50", "p95", "p99")]
    router = router_drive(report["clock"])
    row = {"phase": "slo_serve", "args": SLO_SMOKE_ARGS, "arrivals": arrivals,
           "clock": report["clock"], "wall": report["wall"],
           "aggregate": agg, "models": report["models"], "slo": report["slo"],
           "flash_launches": fa.LAUNCHES, "router": router, "card": card}
    row["ok"] = (agg["requests"] == arrivals and agg["tokens"] > 0
                 and all(math.isfinite(x) and x >= 0 for x in numbers)
                 and report["clock"]["tick_cost_s"] > 0 and router["ok"])
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"slo_serve failed: {row}")
    return row


def autoscale_phase(card, clock) -> dict:
    """The autoscaler bench (nos_tpu_torch.bench_autoscale): reference()
    at 80 virtual s on the reference's costs, whose virtual keys must
    give the digest the CPU tests pin; then quick() (64 H100s, 16 model
    pairs) on the clock slo_serve calibrated on the card, its rate scaled
    by the reference's tick over the card's so that the load a replica
    sees stays the reference's. Held: every batch-<i> scales to zero, the
    nodes it vacated come under the grace hold (GB-seconds > 0), the
    nodes carry one hold a vacated replica whose grace runs at every
    epoch (F10: several on one 8-GPU node at once), every hold expires
    and the GPUs go back to no-demand, every chat-<i> scales
    up at least once, some chat scales back down, every replica is
    bound at each settled epoch, and SimCluster.check() with the
    ledger's self_check holds at every epoch. Reported: the SLO
    compliance at peak, the chats' TTFT and the cold-start penalty on
    the card's tick."""
    from nos_tpu_torch import bench_autoscale as ba
    from nos_tpu_torch.slo.routing import TICK_COST_S

    t0 = time.time()
    ref = ba.run_bench(ba.AutoscaleSizes.reference(), duration_s=80.0)
    ref_digest = ba.virtual_digest(ref)
    t_ref = time.time() - t0
    t1 = time.time()
    sizes = ba.AutoscaleSizes.quick()
    # the reference's operating point: the arrival rate over the tick's
    # slowdown, so a replica sees the load it sees on the 8 ms tick
    rate_rps = sizes.rate_rps * TICK_COST_S / clock["tick_cost_s"]
    quick = ba.run_bench(sizes, rate_rps=rate_rps, tick_cost_s=clock["tick_cost_s"],
                         prefill_token_cost_s=clock["prefill_token_cost_s"])
    t_quick = time.time() - t1
    chats = [c for c, _ in ba.model_names(sizes.pairs)]
    batches = [b for _, b in ba.model_names(sizes.pairs)]
    scaled_up = {c: any(row[c]["verdict"] == "scale-up" for row in quick["timeline"])
                 for c in chats}
    grace = quick["grace"]
    idle = quick["capacity"]["idle_gb_seconds"]
    checks = {
        "reference_digest": ref_digest == ba.REFERENCE_80S_DIGEST,
        "every_batch_scaled_to_zero": sorted(grace["scaled_to_zero"]) == sorted(batches)
        and all(quick["replicas"]["final"][b] == 0 for b in batches),
        "vacated_nodes_held_in_grace": grace["vacated_nodes_held"]
        and idle["autoscaler-grace"] > 0,
        # one hold a vacated replica whose grace runs, at every epoch (F10)
        "one_hold_per_vacated_replica": grace["holds_match_vacated_replicas"]
        and grace["holds_peak"] >= len(batches),
        "grace_reclaimed_to_no_demand": grace["nodes_held_at_end"] == 0
        and (grace["no_demand_gb_seconds_after_release"] or 0) > 0,
        "every_chat_scaled_up": all(scaled_up.values()),
        "chats_scaled_down": quick["scale_events"].get("scale-down", 0) > 0,
        "invariants_every_epoch": quick["invariants_hold"],
    }
    chat_ttft = {c: quick["models"][c]["ttft_s"] for c in chats}
    row = {"phase": "autoscale", "reference_digest": ref_digest,
           "reference_seconds": t_ref, "quick_seconds": t_quick,
           "clock": clock, "rate_rps": rate_rps, "sizes": quick["sizes"],
           "scale_events": quick["scale_events"],
           "scale_downs": quick["scale_events"].get("scale-down", 0),
           "peak_slos_compliant": quick["peak"]["slos_compliant"],
           "peak_noncompliant_models": sorted(m for m, v in quick["peak"]["by_model"].items()
                                              if not v["compliant"]),
           "chat_ttft_p50_s_median": sorted(v["p50"] for v in chat_ttft.values())[
               len(chats) // 2],
           "chat_ttft_p95_s_max": max(v["p95"] for v in chat_ttft.values()),
           "cold_start": quick["cold_start"], "capacity": quick["capacity"],
           "grace": grace, "settle_steps": quick["settle_steps"], "wall_s": quick["wall_s"],
           "checks": checks, "ok": all(checks.values()), "seconds": time.time() - t0,
           "card": card}
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"autoscale failed: {checks}")
    return row


def forecast_phase(card) -> dict:
    """The forecaster bench (nos_tpu_torch.bench_forecast) at reference():
    the accuracy gate (p95 ETA error at most 25% of the wait), a
    validated advisor proposal, zero store writes by the forecaster and
    the stage counts the CPU tests pin; each cycle's run_once wall ms
    beside an incremental plan's of the same pending pods."""
    from nos_tpu_torch import bench_forecast as bf

    t0 = time.time()
    report = bf.run_bench()
    checks = {"gate_and_writes": bf.failures(report) == [],
              "stages": report["stages"] == bf.REFERENCE_STAGES}
    row = {"phase": "forecast", "stages": report["stages"], "accuracy": report["accuracy"],
           "overhead": report["overhead"], "advisor": {
               k: report["advisor"][k] for k in ("validated_cycles",
                                                 "max_predicted_savings_chip_seconds")},
           "wall_ms": report["wall_ms"], "checks": checks, "ok": all(checks.values()),
           "seconds": time.time() - t0, "card": card}
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"forecast failed: {checks} {bf.failures(report)}")
    return row


def examples_phase(card, ckpt_path) -> dict:
    """The three examples' main() on the card: serve_llama on the
    checkpoint directory (full width, int8), train_llama at its card
    config (flash + remat, launches of the three kernels a step) with its
    checkpoints and a resume, finetune_lora at its small config."""
    import contextlib
    import shutil
    import tempfile

    import torch

    from nos_tpu_torch.examples import finetune_lora, serve_llama, train_llama

    # the examples' own printed lines go to stderr: stdout stays JSON
    quiet = functools.partial(contextlib.redirect_stdout, sys.stderr)
    t0 = time.time()
    with quiet():
        serve = serve_llama.main(["--real-weights", ckpt_path])
    torch.cuda.empty_cache()
    serve_s = time.time() - t0
    run_dir = tempfile.mkdtemp(prefix="nos-train-example-")
    steps = train_llama.STEPS
    try:
        zero_counts()
        t0 = time.time()
        with quiet():
            train = train_llama.main(["--ckpt-dir", run_dir])
        torch.cuda.synchronize()
        train_s = time.time() - t0
        per_step = [n / steps for n in counts()]
        with quiet():
            resumed = train_llama.main(["--ckpt-dir", run_dir, "--steps", str(steps + 5)])
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.time()
    with quiet():
        tune = finetune_lora.main([])
    tune_s = time.time() - t0
    losses = list(train["losses"].values()) + list(resumed["losses"].values())
    row = {"phase": "examples",
           "serve_llama": {k: serve[k] for k in ("int8_bytes", "dense_bytes", "engine",
                                                 "sampled")} | {"seconds": serve_s},
           "train_llama": {k: train[k] for k in ("config", "mesh", "latest_checkpoint")}
           | {"first_loss": train["losses"][1], "last_loss": train["losses"][steps],
              "grad_norm_first": train["grad_norms"][1], "seconds": train_s,
              "launches_per_step_fwd_dq_dkv": per_step,
              "resumed_from": resumed["start_step"],
              "resumed_last_loss": resumed["losses"][steps + 5]},
           "finetune_lora": {"first_loss": tune["losses"][0], "last_loss": tune["losses"][-1],
                             "trainable": tune["trainable"], "tokens": tune["tokens"],
                             "seconds": tune_s},
           "card": card}
    n = train["config"]["n_layers"]
    row["ok"] = (serve["engine"]["tokens"] == 8 * 16 and len(serve["sampled"]) == 12
                 and per_step == [2 * n, n, n] and resumed["start_step"] == steps
                 and all(math.isfinite(x) for x in losses + tune["losses"])
                 and train["losses"][steps] < train["losses"][1]
                 and tune["losses"][-1] < tune["losses"][0])
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"examples failed: {row}")
    return row


def preempt_resume_phase(card) -> dict:
    """The preempt_resume example's main() on the card (its printed lines
    to stderr): the re-carve on the simulator, 3 steps, a checkpoint, 2
    resumed steps of card_config() through the three kernels. Checks the
    launches a step (2L / L / L), the resumed step, finite losses, the
    node after the re-carve (two 3g.40gb instances, advertised in
    allocatable, reported and acknowledged) and the resumed steps' losses
    against the same steps run on without the interruption, bit for bit
    (one process)."""
    import contextlib
    import shutil
    import tempfile

    import torch

    from nos_tpu_torch.examples import preempt_resume as pr
    from nos_tpu_torch.gpu.node import RESOURCE_GPU, mig_resource
    from nos_tpu_torch.models.llama import init_llama_params

    quiet = functools.partial(contextlib.redirect_stdout, sys.stderr)
    run_dir = tempfile.mkdtemp(prefix="nos-preempt-resume-")
    try:
        zero_counts()
        t0 = time.time()
        with quiet():
            out = pr.main(["--ckpt-dir", run_dir])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = counts()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    steps = pr.STEPS_BEFORE + pr.STEPS_AFTER
    cfg = pr.trainer_config(torch.device("cuda"))
    straight = pr.uninterrupted_losses(cfg, init_llama_params(cfg, seed=0, device="cuda"),
                                       pr.batch_tokens(cfg), torch.device("cuda"))
    resumed = range(pr.STEPS_BEFORE + 1, steps + 1)
    p2, p3 = out["node"]["phase2"], out["node"]["phase3"]
    n = cfg.n_layers
    per_step = [c / steps for c in launches]
    row = {"phase": "preempt_resume", "config": out["config"], "steps": steps,
           "launches_per_step_fwd_dq_dkv": per_step, "losses": out["losses"],
           "saved_step": out["saved_step"], "resumed_from": out["resumed_from"],
           "uninterrupted_losses": straight,
           "resumed_bit_for_bit": all(out["losses"][s] == straight[s] for s in resumed),
           "resumed_max_abs_diff": max(abs(out["losses"][s] - straight[s]) for s in resumed),
           "recarve": {"before": out["node"]["phase1"]["instances"],
                       "after": p2["instances"], "chosen": out["recarve_chosen"],
                       "allocatable": p2["allocatable"], "status": p2["status"],
                       "used_after_resume": p3["used"],
                       "plan_acked": [out["node"][f"phase{i}"]["status_plan"] for i in (1, 2)]},
           "spec_to_ack_ms": out["spec_to_ack_ms"], "seconds": seconds,
           "mig": "simulated (SimMigClient): the card's MIG mode is off", "card": card}
    row["ok"] = (per_step == [2 * n, n, n] and out["resumed_from"] == out["saved_step"]
                 and sorted(out["losses"]) == list(range(1, steps + 1))
                 and all(math.isfinite(v) for v in out["losses"].values())
                 and p2["instances"] == out["recarve_chosen"] == {0: {"3g.40gb": 2}}
                 and p2["allocatable"] == {RESOURCE_GPU: 0, mig_resource("3g.40gb"): 2}
                 and p2["status"] == p2["instances"] and p2["status_plan"] == p2["spec_plan"]
                 and p3["used"] == {0: {"3g.40gb": 2}} and row["resumed_bit_for_bit"])
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"preempt_resume failed: {row}")
    return row


# ---------------------------------------------------------------- sp paths
# Sequence- and data-parallel ranks run as processes on the one card, in a
# gloo group: NCCL refuses two ranks on one device. Their collectives
# stage device tensors through pinned host memory, so any time that
# crosses a hop measures that staging (and the ranks time-share the
# card), never a ring on NVLink.
SP_RING_SEQ = 16384      # Llama-3-8B's attention heads, sp 2 and 4
SP_GEMMA_SEQ = 8192      # Gemma-2B's heads (hd 256, one kv head), sp 2
SP_WINDOW = 4096
SP_FORWARD_SEQ = 8192    # Llama-3-8B at full depth, sp 2
# Four replicas of weights, gradients and velocity (6 bytes a parameter)
# plus each rank's activations: at 8 layers (2.01 B parameters) a rank
# peaks at 15.75 GiB and the card kept 6.3 and 1.6 GiB free after the
# step in two runs of this phase (NVIDIA H100 80GB HBM3, 700 W). 4 layers
# (6 until the expert and pipeline phases joined the script) keep the
# script inside its time budget.
SP_TRAIN_LAYERS = 4
SP_TRAIN_TOKENS = (2, 4096)
# One step from zero velocity moves each weight by lr * g. At lr 1e4 every
# update outgrows the weight it moves, so the bf16 parameter delta carries
# the gradient to bf16's relative precision (2^-8) and not to the weight's
# spacing, which at lr 1.0 swamps it (4-36% apart per leaf kind where the
# velocities stood 2% apart, 8 layers on an NVIDIA H100 80GB HBM3, 700 W).
# The step's work is the same at any lr; the loss is taken before the
# update.
SP_TRAIN_LR = 1e4
# the sp train step against the one-device step: the loss, and each leaf
# kind's gradient, read from the velocity (v = g after one step from zero)
# and recovered from the parameter delta, as max |g_mesh - g_one| over the
# kind's largest |g_one|
SP_LOSS_LIMIT = 2e-3
SP_GRAD_REL_LIMIT = 3e-2


def sp_spawn(world: int, plan, card) -> list:
    """Run ``plan``, a list of (function name, kwargs), on ``world`` ranks
    spawned on cuda:0 in one gloo group; each rank's list of rows, in
    plan order. A rank that raises fails the call (and the script)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="nos-sp-")
    try:
        mp.spawn(sp_rank, args=(world, work, card, plan), nprocs=world)
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ranks


def sp_rank(rank, world, work, card, plan) -> None:
    """One spawned rank: joins the gloo group, runs the plan, writes its
    rows for the parent."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        rows = []
        for name, kwargs in plan:
            rows.append(globals()[name](rank, world, card, **kwargs))
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def sp_fail(row, what: str):
    raise RuntimeError(f"{what} failed on rank {row.get('rank')}: {json.dumps(row)}")


def grads_close(got, want) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= BWD_ATOL + BWD_RTOL * want.abs()).all()
                and torch_isfinite(got))


def torch_isfinite(x) -> bool:
    import torch

    return bool(torch.isfinite(x).all())


def wall_ms(fn, reps: int = 3) -> float:
    """Median host wall time of ``fn`` (the card synchronized after each
    call) over ``reps`` runs after one warm-up: for calls that block the
    host, such as a gloo exchange. Every rank of a collective calls it the
    same number of times."""
    import statistics

    import torch

    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def block_against_plain(q, k, v, do, q_off, kv_off, window) -> dict:
    """One ring block's kernels against their plain versions on the same
    inputs, as the ring calls them: flash_attention_block against
    flash_attention_reference (O_ATOL, LSE_ATOL), and flash_block_grads
    with f32 outputs and ``delta`` passed in against
    flash_attention_bwd_reference (BWD_ATOL + BWD_RTOL |want|)."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa

    out, lse = fa.flash_attention_block(q, k, v, q_off, kv_off, window=window)
    want, want_lse = fa.flash_attention_reference(q, k, v, q_off, kv_off, window=window)
    kw = dict(window=window, grad_dtype=torch.float32, delta=fa.flash_delta(do, out))
    got = fa.flash_block_grads(q, k, v, out, lse, do, q_off, kv_off, **kw)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, q_off, kv_off, **kw)
    fin = torch.isfinite(want_lse)
    row = {"q_off": q_off, "kv_off": kv_off,
           "o_max_abs_err": float((out.float() - want.float()).abs().max()),
           "lse_max_abs_err": float((lse[fin] - want_lse[fin]).abs().max()) if fin.any()
           else 0.0,
           "neg_inf_rows_match": bool(torch.equal(torch.isneginf(lse),
                                                  torch.isneginf(want_lse))),
           "grad_dtype": "f32",
           **{f"{g}_max_abs_err": float((a - b).abs().max())
              for g, a, b in zip(("dq", "dk", "dv"), got, ref)}}
    row["ok"] = (row["o_max_abs_err"] <= O_ATOL and row["lse_max_abs_err"] <= LSE_ATOL
                 and row["neg_inf_rows_match"] and torch_isfinite(out.float())
                 and all(a.dtype == torch.float32 and grads_close(a, b)
                         for a, b in zip(got, ref)))
    return row


def sp_ring_case(rank, world, card, case, s, hq, hkv, hd, window=None,
                 strategy="ring") -> dict:
    """This rank's ring_flash_attention (or Ulysses through flash_attention)
    over ``world`` sp ranks, output and dQ/dK/dV against the one-process
    flash_attention forward and backward on the whole sequence; launches
    counted around the sp call alone; then, one rank at a time while the
    others wait, each of its hops' kernels timed at the ring's shapes and
    offsets (rank 0 also times the whole-sequence kernels); on the ring,
    the last rank also holds its diagonal block's kernels and its nearest
    other block's against their plain versions (``block_against_plain``),
    each rank times the host staging of one hop's K/V alone, and then all
    ranks time one shift together with no kernel running."""
    import torch
    import torch.distributed as dist

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel.ring_attention import ring_flash_attention
    from nos_tpu_torch.parallel.ulysses import ulysses_attention
    from nos_tpu_torch.util.cuda_timing import event_ms

    mesh = pm.mesh_from_devices((1, world), ("dp", "sp"))
    gen = torch.Generator(device="cuda").manual_seed(s + hd + (window or 0))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(1, s, hq, hd), randn(1, s, hkv, hd), randn(1, s, hkv, hd), \
        randn(1, s, hq, hd)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = fa.flash_attention(*leaves, window=window)
    wdq, wdk, wdv = torch.autograd.grad(want, leaves, do)
    n = s // world
    rows = slice(rank * n, (rank + 1) * n)
    local = [x[:, rows].contiguous().requires_grad_(True) for x in (q, k, v)]
    d_local = do[:, rows].contiguous()
    if strategy == "ring":
        fn = ring_flash_attention
        blocks = [(rank - i) % world for i in range(world)
                  if visible_pairs(n, n, rank * n, ((rank - i) % world) * n, True, window)]
        expect = [len(blocks)] * 3
    else:
        fn = functools.partial(ulysses_attention, attention="flash")
        blocks, expect = [], [1, 1, 1]
    torch.cuda.synchronize()
    dist.barrier()
    zero_counts()  # the sp path: every launch from here to the read is its own
    t0 = time.perf_counter()
    out = fn(*local, mesh, window=window)
    torch.cuda.synchronize()
    fwd_wall = (time.perf_counter() - t0) * 1e3
    fwd_launches = counts()
    zero_counts()
    t0 = time.perf_counter()
    grads = torch.autograd.grad(out, local, d_local.reshape(out.shape))
    torch.cuda.synchronize()
    bwd_wall = (time.perf_counter() - t0) * 1e3
    bwd_launches = counts()
    got, want = out.detach().reshape(1, n, hq, hd), want.detach()
    o_err = float((got.float() - want[:, rows].float()).abs().max())
    errs = {g: float((a.float() - b[:, rows].float()).abs().max())
            for g, a, b in zip(("dq", "dk", "dv"), grads, (wdq, wdk, wdv))}
    close = all(grads_close(a, b[:, rows]) for a, b in zip(grads, (wdq, wdk, wdv)))
    launches = [fwd_launches[0], bwd_launches[1], bwd_launches[2]]
    row = {"phase": "sp_ring_kernels", "case": case, "strategy": strategy, "rank": rank,
           "sp": world, "shape": {"b": 1, "s": s, "s_rank": n, "hq": hq, "hkv": hkv,
                                  "hd": hd},
           "window": window, "transport": comm.transport(mesh.get_group("sp"), "cuda"),
           "kv_blocks_run": blocks, "launches_fwd_dq_dkv": launches,
           "expected_launches": expect,
           "stray_launches": [fwd_launches[1], fwd_launches[2], bwd_launches[0]],
           "o_max_abs_err": o_err, **{f"{g}_max_abs_err": e for g, e in errs.items()},
           "o_atol": O_ATOL, "atol": BWD_ATOL, "rtol": BWD_RTOL,
           "fwd_wall_ms_gloo_host_staged": fwd_wall,
           "bwd_wall_ms_gloo_host_staged": bwd_wall, "card": card}
    row["ok"] = (o_err <= O_ATOL and close and torch_isfinite(got)
                 and launches == expect and row["stray_launches"] == [0, 0, 0])
    if not row["ok"]:
        sp_fail(row, f"sp ring case {case}")
    # each hop's kernels alone, one rank at a time (the others wait)
    hops, whole, plain, staging = [], None, [], None
    for turn in range(world):
        dist.barrier()
        if turn != rank:
            continue
        q_loc = local[0].detach()
        for j in blocks:
            kb, vb = k[:, j * n:(j + 1) * n].contiguous(), v[:, j * n:(j + 1) * n].contiguous()
            offs = (rank * n, j * n)
            o_b, lse_b = fa.flash_attention_block(q_loc, kb, vb, *offs, window=window)
            args = (q_loc, kb, vb, lse_b, d_local, fa.flash_delta(d_local, o_b), *offs,
                    True, window, torch.float32)
            pairs = visible_pairs(n, n, *offs, True, window)
            hops.append({
                "kv_block": j, "q_off": offs[0], "kv_off": offs[1],
                "pairs_per_head": pairs,
                "fwd_ms": event_ms(lambda: fa.flash_attention_block(
                    q_loc, kb, vb, *offs, window=window)),
                "dq_f32_ms": event_ms(lambda: fa._flash_bwd_cuda(*args, True, False)),
                "dkv_f32_ms": event_ms(lambda: fa._flash_bwd_cuda(*args, False, True)),
                "fwd_bound_ms": attention_bound_ms(1, n, n, hq, hkv, hd, pairs)[0],
            })
            if rank == world - 1 and j in blocks[:2]:  # the diagonal, the nearest other
                plain.append(block_against_plain(q_loc, kb, vb, d_local, *offs, window))
        if blocks:
            staging = hop_staging_ms(local[1].detach(), local[2].detach())
        if rank == 0 and strategy == "ring":
            qd, kd, vd = (x.detach() for x in (q, k, v))
            o_w, lse_w = fa.flash_attention_block(qd, kd, vd, 0, 0, window=window)
            args = (qd, kd, vd, lse_w, do, fa.flash_delta(do, o_w), 0, 0, True, window, None)
            whole = {"pairs_per_head": visible_pairs(s, s, 0, 0, True, window),
                     "fwd_ms": event_ms(lambda: fa.flash_attention_block(
                         qd, kd, vd, 0, 0, window=window), reps=5),
                     "dq_ms": event_ms(lambda: fa._flash_bwd_cuda(*args, True, False), reps=5),
                     "dkv_ms": event_ms(lambda: fa._flash_bwd_cuda(*args, False, True), reps=5)}
    dist.barrier()
    row["hops_alone"] = hops
    if whole is not None:
        row["whole_sequence_one_process"] = whole
    if strategy == "ring":
        group = mesh.get_group("sp")
        kv = [local[1].detach(), local[2].detach()]
        row["hop_staging_alone_ms"] = staging
        # every rank shifts at once, as in the ring, with no kernel running
        row["shift_all_ranks_no_kernels_ms_gloo_host_staged"] = wall_ms(
            lambda: comm.ring_shift(kv, group))
        row["blocks_against_plain"] = plain
        if rank == world - 1 and (len(plain) != min(2, len(blocks))
                                  or not all(p["ok"] for p in plain)):
            sp_fail(row, f"sp ring case {case}: a block's kernels against plain")
    return row


def hop_staging_ms(k, v) -> dict:
    """What one forward hop's K/V costs a rank before and after gloo moves
    it, timed with no other rank using the card: packing both into one
    buffer on the card, its copy into pinned host memory and the copy
    back (comm.ring_shift's staging)."""
    import torch

    from nos_tpu_torch.parallel import comm

    packed = comm._pack([k, v])
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    return {"bytes": packed.numel(),
            "pack_ms": wall_ms(lambda: comm._pack([k, v])),
            "to_pinned_host_ms": wall_ms(lambda: host.copy_(packed)),
            "from_pinned_host_ms": wall_ms(lambda: host.to(k.device))}


def sp_forward_case(rank, world, card, seq) -> dict:
    """Llama-3-8B at full width and depth (random weights from a seed,
    bf16, flash): llama_forward over an sp mesh on this rank's [1, seq/sp]
    block against the one-device flash forward on the whole [1, seq]."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash")
    params = llama.init_llama_params(cfg, seed=31, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(31)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen, device="cuda")
    mesh = pm.mesh_from_devices((1, world), ("dp", "sp"))
    n = seq // world
    blocks = sum(1 for j in range(world) if visible_pairs(n, n, rank * n, j * n, True, None))
    with torch.no_grad():
        want = llama.llama_forward(params, tokens, cfg)[:, rank * n:(rank + 1) * n].clone()
        torch.cuda.synchronize()
        dist.barrier()
        zero_counts()  # the sp path
        t0 = time.perf_counter()
        got = llama.llama_forward(params, llama_data_sharding(mesh, tokens), cfg, mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
        stats = logits_agreement(got, want)
    from nos_tpu_torch.parallel.comm import transport

    row = {"phase": "sp_forward", "config": "llama_3_8b", "rank": rank, "sp": world,
           "transport": transport(mesh.get_group("sp"), "cuda"),
           "tokens": [1, seq], "tokens_rank": [1, n], "layers": cfg.n_layers,
           "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [blocks * cfg.n_layers, 0, 0], **stats,
           "rel_limit": FWD_REL_LIMIT, "probs_limit": FWD_PROB_LIMIT,
           "argmax_limit": FWD_ARGMAX_LIMIT, "wall_ms_gloo_host_staged": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    row["ok"] = list(launches) == row["expected_launches"] and logits_hold(stats)
    if not row["ok"]:
        sp_fail(row, "sp_forward")
    return row


def mesh_against_one_device(state, loss: float, ref, mesh, lr: float) -> dict:
    """A mesh step's state against the one-device step's (``ref``, on rank
    0: its loss, and host copies of the initial params, the updated params
    and the velocity), leaf by leaf: each shard gathered whole over the
    mesh (a collective: every rank calls this), then on rank 0 each leaf
    kind's gradient read from the velocity and recovered from the
    parameter delta, as max |g_mesh - g_one| over the kind's largest
    |g_one|. The gathered velocity's checksum, the same on every rank,
    shows the ranks' shards make one state. A function of its own, so its
    device temporaries are gone before the next mesh's step."""
    import torch

    from nos_tpu_torch.models.llama import tree_leaves
    from nos_tpu_torch.parallel.sharding import gather_shard, rule_leaves, tree_rules

    g_diff, g_ref, d_diff, d_ref = {}, {}, {}, {}
    specs = rule_leaves(tree_rules(state[0], mesh))
    checksum, finite = 0.0, True
    for i, ((kind, p1), v, spec) in enumerate(zip(named_leaves(state[0]),
                                                  tree_leaves(state[1]), specs)):
        v = gather_shard(v, spec, mesh)
        p1 = gather_shard(p1.detach(), spec, mesh)
        checksum += float(v.double().sum())
        finite = finite and bool(torch.isfinite(v).all())
        if ref is None:
            continue
        v_ref = ref["v"][i].cuda().float()
        g_diff[kind] = max(g_diff.get(kind, 0.0), float((v.float() - v_ref).abs().max()))
        g_ref[kind] = max(g_ref.get(kind, 0.0), float(v_ref.abs().max()))
        p0 = ref["p0"][i].cuda().float()
        delta = (p0 - p1.float()) / lr
        delta_ref = (p0 - ref["p1"][i].cuda().float()) / lr
        d_diff[kind] = max(d_diff.get(kind, 0.0), float((delta - delta_ref).abs().max()))
        d_ref[kind] = max(d_ref.get(kind, 0.0), float(delta_ref.abs().max()))
    out = {"velocity_checksum": checksum, "finite": finite}
    if ref is not None:
        out.update({"one_device_loss": ref["loss"], "one_device_step_ms": ref["ms"],
                    "loss_abs_diff": abs(loss - ref["loss"]),
                    "grad_rel_err": {k: g_diff[k] / g_ref[k] for k in g_diff},
                    "grad_from_param_delta_rel_err": {
                        k: d_diff[k] / d_ref[k] if d_ref[k] else None for k in d_diff}})
    return out


def one_device_step(cfg, tokens, seed, lr) -> dict:
    """The one-device make_train_step(None) step (no remat) from the
    params of ``seed``: its loss and ms, and host copies of the initial
    params, the updated params and the velocity."""
    import torch

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import make_train_step

    step, shard = make_train_step(None, cfg, learning_rate=lr)
    state = shard(llama.init_llama_params(cfg, seed=seed, device="cuda"), donate=True)
    p0 = [p.detach().to("cpu", copy=True) for p in llama.tree_leaves(state[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, tokens)
    torch.cuda.synchronize()
    ref = {"loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3, "p0": p0,
           "p1": [p.detach().cpu() for p in llama.tree_leaves(state[0])],
           "v": [x.cpu() for x in llama.tree_leaves(state[1])]}
    del state
    torch.cuda.empty_cache()
    return ref


def held_to_one_device(row, limit_loss: float) -> bool:
    from_delta = list(row["grad_from_param_delta_rel_err"].values())
    return (row["finite"] and row["loss_abs_diff"] <= limit_loss
            and max(row["grad_rel_err"].values()) <= SP_GRAD_REL_LIMIT
            and None not in from_delta and max(from_delta) <= SP_GRAD_REL_LIMIT)


def sp_train_case(rank, world, card, layers, tokens_shape, meshes) -> list:
    """Llama-3-8B at full width and ``layers`` deep (bf16, flash), one
    momentum-SGD step from zero velocity on each ``(dp, sp, remat)`` of
    ``meshes`` against the one-device make_train_step(None) step (no
    remat) on the same tokens and initial params (rank 0 runs it first,
    alone): the loss, each leaf kind's gradient read from the velocity
    (v = g after one step from zero) and the one recovered from the
    parameter delta, the launches of the sp step, the replicas' agreement.
    With remat each block's backward first replays its forward, ring
    shifts and ring kernels included, so the forward kernel runs twice.
    The gradient sum over the mesh (host-staged) is timed apart from the
    rest of the step."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, make_train_step, mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding
    from nos_tpu_torch.parallel.sp_bench import timed_grad_sum

    cfg = dataclasses.replace(llama.llama_3_8b_config(), n_layers=layers,
                              attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(41)
    tokens = torch.randint(0, cfg.vocab_size, tokens_shape, generator=gen, device="cuda")
    ref = one_device_step(cfg, tokens, 41, SP_TRAIN_LR) if rank == 0 else None
    dist.barrier()
    rows = []
    for *dims, remat in meshes:
        mesh = pm.mesh_from_devices(tuple(dims), ("dp", "sp"))
        sp_idx = pm.axis_index(mesh, "sp")
        n = tokens_shape[1] // dims[1]
        blocks = sum(1 for j in range(dims[1])
                     if visible_pairs(n, n, sp_idx * n, j * n, True, None))
        step, shard = make_train_step(mesh, dataclasses.replace(cfg, remat=remat),
                                      learning_rate=SP_TRAIN_LR)
        state = shard(llama.init_llama_params(cfg, seed=41, device="cuda"), donate=True)
        block = llama_data_sharding(mesh, tokens).contiguous()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        zero_counts()  # the sp path
        with timed_grad_sum() as sum_ms:
            t0 = time.perf_counter()
            state, loss = step(state, block)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
        compared = mesh_against_one_device(state, float(loss), ref, mesh, SP_TRAIN_LR)
        sums = [None] * world
        dist.all_gather_object(sums, compared.pop("velocity_checksum"))
        row = {"phase": "sp_train", "config": "llama_3_8b", "layers": layers,
               "mesh": {"dp": dims[0], "sp": dims[1]}, "remat": remat, "rank": rank,
               "transport": comm.transport(mesh.get_group("sp"), "cuda"),
               "tokens": list(tokens_shape), "tokens_rank": list(block.shape),
               "optimizer": f"momentum_sgd(lr={SP_TRAIN_LR}, momentum=0.9)",
               "loss": float(loss), "launches_fwd_dq_dkv": list(launches),
               "expected_launches": [(2 if remat else 1) * blocks * layers,
                                     blocks * layers, blocks * layers],
               "replicas_agree": len(set(sums)) == 1,
               "step_wall_ms_gloo_host_staged": wall,
               "grad_sum_ms_gloo_host_staged": sum(sum_ms),
               "step_without_grad_sum_ms": wall - sum(sum_ms),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "card_free_gib_after_step": torch.cuda.mem_get_info()[0] / 2**30,
               "card": card}
        row.update(compared)
        ok = row["replicas_agree"] and list(launches) == row["expected_launches"]
        if rank == 0:
            row["grad_rel_limit"] = SP_GRAD_REL_LIMIT
            row["loss_limit"] = SP_LOSS_LIMIT
            ok = ok and held_to_one_device(row, SP_LOSS_LIMIT)
        row["ok"] = ok
        if not ok:
            sp_fail(row, f"sp_train {dims}")
        rows.append(row)
        del state
        torch.cuda.empty_cache()
        dist.barrier()
    return rows


def sp_phases(card) -> dict:
    """The three sp phases on spawned ranks: sp_ring_kernels (Llama-3-8B's
    attention at S 16384, sp 2 and 4, causal and a 4096 window; Gemma-2B's
    heads at S 8192, sp 2; Ulysses at sp 4), sp_forward (Llama-3-8B at full
    depth, sp 2, [1, 8192]) and sp_train (SP_TRAIN_LAYERS layers at full
    width, dp 1 x sp 4, and dp 2 x sp 2 with remat). Two spawns: the sp-2 work on two
    ranks, the sp-4 work on four. The kernels are built already (the ranks
    load them), and the parent holds no card memory of its own."""
    import torch

    torch.cuda.empty_cache()
    emit({"phase": "sp_spawn", "parent_gib_allocated": torch.cuda.memory_allocated() / 2**30,
          "parent_gib_reserved": torch.cuda.memory_reserved() / 2**30, "card": card})
    llama_heads = dict(hq=32, hkv=8, hd=128)
    t0 = time.time()
    two = sp_spawn(2, [
        ("sp_ring_case", dict(case="llama_causal_sp2", s=SP_RING_SEQ, **llama_heads)),
        ("sp_ring_case", dict(case="llama_window4096_sp2", s=SP_RING_SEQ,
                              window=SP_WINDOW, **llama_heads)),
        ("sp_ring_case", dict(case="gemma_hd256_causal_sp2", s=SP_GEMMA_SEQ, hq=8, hkv=1,
                              hd=256)),
        ("sp_forward_case", dict(seq=SP_FORWARD_SEQ)),
    ], card)
    t_two = time.time() - t0
    t0 = time.time()
    four = sp_spawn(4, [
        ("sp_ring_case", dict(case="llama_causal_sp4", s=SP_RING_SEQ, **llama_heads)),
        ("sp_ring_case", dict(case="llama_window4096_sp4", s=SP_RING_SEQ,
                              window=SP_WINDOW, **llama_heads)),
        ("sp_ring_case", dict(case="ulysses_llama_causal_sp4", s=SP_RING_SEQ,
                              strategy="ulysses", **llama_heads)),
        ("sp_train_case", dict(layers=SP_TRAIN_LAYERS, tokens_shape=SP_TRAIN_TOKENS,
                               meshes=[(1, 4, False), (2, 2, True)])),
    ], card)
    t_four = time.time() - t0
    ring_rows = [rows[i] for i in range(3) for rows in two] + \
        [rows[i] for i in range(3) for rows in four]
    for row in ring_rows:
        emit(row)
    forward_rows = [rows[3] for rows in two]
    for row in forward_rows:
        emit(row)
    train_rows = [rows[3][i] for i in range(2) for rows in four]
    for row in train_rows:
        emit(row)
    emit({"phase": "sp_phases", "seconds_two_ranks": t_two, "seconds_four_ranks": t_four,
          "card": card})
    launches = {f"sp_ring_kernels.{row['case']}": [] for row in ring_rows}
    for row in ring_rows:
        launches[f"sp_ring_kernels.{row['case']}"].append(row["launches_fwd_dq_dkv"])
    launches["sp_forward"] = [row["launches_fwd_dq_dkv"] for row in forward_rows]
    for row in train_rows:
        key = f"sp_train.dp{row['mesh']['dp']}_sp{row['mesh']['sp']}" + (
            "_remat" if row["remat"] else "")
        launches.setdefault(key, []).append(row["launches_fwd_dq_dkv"])
    return {"launches": launches, "ring": ring_rows}


# Tensor parallelism and FSDP, on ranks sharing the card over gloo
TP_FORWARD_SEQ = 2048    # Llama-3-8B, tp 2 (Hq 16, Hkv 4 a rank)
TP2_FORWARD_LAYERS = 16  # half depth: each rank inits the whole tree first
TP4_FORWARD_LAYERS = 4   # tp 4 (Hq 8, Hkv 2): four ranks each init the whole tree
TP_ENGINE_NEW = 16       # tokens a request, four requests
TP_TRAIN_LAYERS = 4
TP_TRAIN_TOKENS = (4, 2048)
TP_LOSS_LIMIT = 1e-3


def local_heads(shards, cfg) -> list:
    """The rank's (query, kv) heads, read off its wq / wk shards."""
    layer = shards["layers"][0]

    def columns(leaf):
        return (leaf if hasattr(leaf, "shape") else leaf.q).shape[-1]

    return [columns(layer["wq"]) // cfg.head_dim, columns(layer["wk"]) // cfg.head_dim]


def same_on_every_rank(value, world: int) -> bool:
    import torch.distributed as dist

    got = [None] * world
    dist.all_gather_object(got, value)
    return all(g == got[0] for g in got)


def tp_forward_case(rank, world, card, seq, layers=None) -> dict:
    """Llama-3-8B at full width (``layers`` deep; all 32 by default,
    random weights from a seed, bf16, flash): llama_forward over a
    ``('tp',)`` mesh of ``world`` ranks on [1, seq], each rank on its
    shards (its n_heads/tp and n_kv_heads/tp heads), against the
    one-device flash forward of the whole tree (rank 0) under
    forward_check's limits; the forward kernel's launches on each rank
    (one a layer at the local heads), the gathered logits the same bytes
    on every rank."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.quantize import weight_bytes
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash",
                              **({"n_layers": layers} if layers else {}))
    params = llama.init_llama_params(cfg, seed=61, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(61)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen, device="cuda")
    mesh = pm.mesh_from_devices((world,), ("tp",))
    with torch.no_grad():
        want = llama.llama_forward(params, tokens, cfg) if rank == 0 else None
        shards = shard_params(params, mesh, cfg)
        del params
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        dist.barrier()
        zero_counts()  # the tp path
        t0 = time.perf_counter()
        got = llama.llama_forward(shards, tokens, cfg, mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
    row = {"phase": "tp_forward", "config": "llama_3_8b", "rank": rank, "tp": world,
           "layers": cfg.n_layers, "tokens": [1, seq],
           "transport": comm.transport(mesh.get_group("tp"), "cuda"),
           "local_heads_q_kv": local_heads(shards, cfg),
           "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [cfg.n_layers, 0, 0],
           "same_logits_every_rank": same_on_every_rank(float(got.double().sum()), world),
           "weight_bytes_rank": weight_bytes(shards),
           "wall_ms_gloo_host_staged": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    ok = (list(launches) == row["expected_launches"] and row["same_logits_every_rank"]
          and row["local_heads_q_kv"] == [cfg.n_heads // world, cfg.n_kv_heads // world])
    if rank == 0:
        stats = logits_agreement(got, want)
        row.update(stats, rel_limit=FWD_REL_LIMIT, probs_limit=FWD_PROB_LIMIT,
                   argmax_limit=FWD_ARGMAX_LIMIT)
        ok = ok and logits_hold(stats)
    row["ok"] = ok
    if not ok:
        sp_fail(row, f"tp_forward tp {world}")
    return row


def serve_requests(tree, cfg, prompts, new_tokens, mesh=None) -> dict:
    """An Engine (4 slots, max_len 512, 256-token pieces) over ``tree``
    answering ``prompts``: completions in submit order, seconds, and the
    engine's weight and cache bytes on this rank."""
    import torch

    from nos_tpu_torch.models.quantize import weight_bytes
    from nos_tpu_torch.serve import Engine, GenRequest

    eng = Engine(tree, cfg, max_slots=4, max_len=512, prefill_chunk=256, mesh=mesh)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=new_tokens)) for p in prompts]
        got = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    cache = sum(t.numel() * t.element_size() for layer in eng._cache for t in layer.values())
    return {"tokens": [got[i] for i in ids], "seconds": seconds,
            "weight_bytes": weight_bytes(tree), "cache_bytes": cache,
            "cache_heads": eng._cache[0]["k"].shape[2]}


def first_token_held(tokens, first_probs) -> list:
    """Per request: its first token is the one-device argmax, or within
    FWD_PROB_LIMIT of the argmax's probability there (a near tie that
    bf16 summation order may break either way)."""
    return [bool(p[t[0]] >= p.max() - FWD_PROB_LIMIT) for t, p in zip(tokens, first_probs)]


def agreement(got, want) -> float:
    pairs = [(a, b) for x, y in zip(got, want) for a, b in zip(x, y)]
    return sum(a == b for a, b in pairs) / len(pairs)


def tp_engine_case(rank, world, card, new_tokens) -> list:
    """Llama-3-8B at full width and depth (bf16, flash) served over a
    ``('tp',)`` mesh of ``world`` ranks: greedy generate() on [2, 512]
    (its unpadded prefill launches the forward kernel once a layer at the
    local heads) and an Engine over the head-sharded cache answering four
    requests (padded and chunked admission), then the same Engine over
    the int8 tree through shard_for_serving. Every rank's completions are
    the same; against the one-device Engine (rank 0) the share of equal
    tokens is reported, bf16 summation order differing, and each
    request's first token is held (the one-device argmax or a near tie)."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.quantize import quantize_params
    from nos_tpu_torch.parallel import mesh as pm
    from nos_tpu_torch.serve import shard_for_serving

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash")
    params = llama.init_llama_params(cfg, seed=63, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(63)
    pool = torch.randint(1, cfg.vocab_size, (700,), generator=gen, device="cuda").tolist()
    prompts = [pool[:20], pool[20:120], pool[120:320], pool[320:620]]
    prompt = torch.randint(1, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    mesh = pm.mesh_from_devices((world,), ("tp",))
    one, first_probs = {}, None
    if rank == 0:
        with torch.no_grad():
            one["generate"] = gen_mod.generate(params, prompt, cfg, new_tokens).tolist()
            first_probs = [torch.softmax(gen_mod.prefill(
                params, torch.tensor([p], device="cuda"), cfg, len(p))[0][0, -1], -1).cpu()
                for p in prompts]
        one["bf16"] = serve_requests(params, cfg, prompts, new_tokens)
    dist.barrier()
    q8 = quantize_params(params)
    if rank == 0:
        one["int8"] = serve_requests(q8, cfg, prompts, new_tokens)
    dist.barrier()
    trees = {"int8": shard_for_serving(q8, mesh, cfg)}
    del q8
    trees["bf16"] = shard_for_serving(params, mesh, cfg)
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    with torch.no_grad():
        zero_counts()  # the tp serving path
        t0 = time.perf_counter()
        out = gen_mod.generate(trees["bf16"], prompt, cfg, new_tokens, mesh=mesh).tolist()
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = counts()
    rows = [{"phase": "tp_generate", "config": "llama_3_8b", "rank": rank, "tp": world,
             "prompt": [2, 512], "new_tokens": new_tokens,
             "local_heads_q_kv": local_heads(trees["bf16"], cfg),
             "launches_fwd_dq_dkv": list(launches),
             "expected_launches": [cfg.n_layers, 0, 0],
             "same_tokens_every_rank": same_on_every_rank(out, world),
             "seconds_gloo_host_staged": gen_s, "card": card}]
    for fmt in ("bf16", "int8"):
        dist.barrier()
        got = serve_requests(trees[fmt], cfg, prompts, new_tokens, mesh)
        rows.append({"phase": "tp_engine", "config": "llama_3_8b", "format": fmt,
                     "rank": rank, "tp": world, "requests": len(prompts),
                     "prompt_tokens": [len(p) for p in prompts], "new_tokens": new_tokens,
                     "same_tokens_every_rank": same_on_every_rank(got["tokens"], world),
                     "seconds_gloo_host_staged": got["seconds"],
                     "weight_bytes_rank": got["weight_bytes"],
                     "cache_bytes_rank": got["cache_bytes"],
                     "cache_heads_rank": got["cache_heads"], "card": card})
        if rank == 0:
            rows[-1].update(
                one_device_seconds=one[fmt]["seconds"],
                one_device_weight_bytes=one[fmt]["weight_bytes"],
                one_device_cache_bytes=one[fmt]["cache_bytes"],
                token_agreement_with_one_device=agreement(got["tokens"], one[fmt]["tokens"]),
                first_token_equal=[a[0] == b[0] for a, b in
                                   zip(got["tokens"], one[fmt]["tokens"])])
            if fmt == "bf16":
                rows[-1]["first_token_held"] = first_token_held(got["tokens"], first_probs)
        rows[-1]["tokens_ok"] = all(len(seq) == new_tokens and all(
            0 <= t < cfg.vocab_size for t in seq) for seq in got["tokens"])
    if rank == 0:
        rows[0]["token_agreement_with_one_device"] = agreement(out, one["generate"])
    ok = (list(launches) == rows[0]["expected_launches"]
          and rows[0]["same_tokens_every_rank"]
          and rows[0]["local_heads_q_kv"] == [cfg.n_heads // world, cfg.n_kv_heads // world]
          and all(r["same_tokens_every_rank"] and r["tokens_ok"]
                  and r["cache_heads_rank"] == cfg.n_kv_heads // world
                  and all(r.get("first_token_held", [True])) for r in rows[1:]))
    for r in rows:
        r["ok"] = ok
    if not ok:
        sp_fail(rows[0], f"tp_engine: {json.dumps(rows)}")
    return rows


def tp_train_case(rank, world, card, layers, tokens_shape, ckpt_dir) -> list:
    """Llama-3-8B at full width and ``layers`` deep (bf16, flash): one
    momentum-SGD step from zero velocity on a ``('dp', 'tp')`` 2 x 2 mesh
    with FSDP and remat, against the one-device make_train_step(None) step
    (rank 0 runs it first, alone) under the sp_train bars (the loss within
    TP_LOSS_LIMIT); the launches of each kernel (forward 2·L with the
    replay, dQ L, dK/dV L); the rank's param bytes and peak; the step's
    host wall time split by the collectives' kinds (timed_collectives: tp
    all-reduces and gathers, FSDP gathers and reduce-scatters, the
    gradient sum) and a second step without the split. Then the
    checkpoint: the state saved (DTensor shards staged on the host),
    restored onto a ('tp',) mesh of 4 and onto one device (rank 0), every
    leaf gathered whole and held bit-identical to the saved one; save and
    restore seconds and bytes."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, make_train_step, mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    cfg = dataclasses.replace(llama.llama_3_8b_config(), n_layers=layers,
                              attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(71)
    tokens = torch.randint(0, cfg.vocab_size, tokens_shape, generator=gen, device="cuda")
    ref = one_device_step(cfg, tokens, 71, SP_TRAIN_LR) if rank == 0 else None
    dist.barrier()
    mesh = pm.mesh_from_devices((2, 2), ("dp", "tp"))
    remat_cfg = dataclasses.replace(cfg, remat=True)
    step, shard = make_train_step(mesh, remat_cfg, learning_rate=SP_TRAIN_LR)
    state = shard(llama.init_llama_params(cfg, seed=71, device="cuda"), donate=True)
    torch.cuda.empty_cache()
    leaves = llama.tree_leaves(state[0])
    param_bytes = sum(p.numel() * p.element_size() for p in leaves)
    replicated = sum(p.numel() * p.element_size() for p in leaves if p.dim() == 1)
    block = llama_data_sharding(mesh, tokens).contiguous()
    import torch._dynamo  # noqa: F401  (the first checkpointed step imports it)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    zero_counts()  # the tp x FSDP training path
    with comm.timed_collectives() as times:
        t0 = time.perf_counter()
        state, loss = step(state, block)
        torch.cuda.synchronize()
        wall_split = (time.perf_counter() - t0) * 1e3
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    compared = mesh_against_one_device(state, float(loss), ref, mesh, SP_TRAIN_LR)
    agree = same_on_every_rank(compared.pop("velocity_checksum"), world)
    collective_ms = {k: sum(v) for k, v in times.items()}
    row = {"phase": "tp_train", "config": "llama_3_8b", "layers": layers,
           "mesh": {"dp": 2, "tp": 2}, "fsdp": True, "remat": True, "rank": rank,
           "transport": comm.transport(mesh.get_group("tp"), "cuda"),
           "tokens": list(tokens_shape), "tokens_rank": list(block.shape),
           "local_heads_q_kv": local_heads(state[0], cfg),
           "optimizer": f"momentum_sgd(lr={SP_TRAIN_LR}, momentum=0.9)",
           "loss": float(loss), "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [2 * layers, layers, layers],
           "replicas_agree": agree, "param_bytes_rank": param_bytes,
           "replicated_bytes_rank": replicated, "peak_gib": peak,
           "step_ms_with_split_gloo_host_staged": wall_split,
           "collective_ms_gloo_host_staged": collective_ms,
           "collective_calls": {k: len(v) for k, v in times.items()},
           "rest_ms": wall_split - sum(collective_ms.values()), **compared,
           "card_free_gib_after_step": torch.cuda.mem_get_info()[0] / 2**30, "card": card}
    dist.barrier()
    t0 = time.perf_counter()
    state, loss2 = step(state, block)
    torch.cuda.synchronize()
    row["second_step_ms_gloo_host_staged"] = (time.perf_counter() - t0) * 1e3
    row["second_step_loss"] = float(loss2)
    ok = (agree and list(launches) == row["expected_launches"]
          and row["local_heads_q_kv"] == [cfg.n_heads // 2, cfg.n_kv_heads // 2])
    if rank == 0:
        whole = sum(2 * math.prod(p.shape) for p in ref["p0"])
        row.update(param_bytes_whole=whole, grad_rel_limit=SP_GRAD_REL_LIMIT,
                   loss_limit=TP_LOSS_LIMIT)
        ok = ok and held_to_one_device(row, TP_LOSS_LIMIT) and \
            param_bytes <= whole / 4 + replicated
        del ref
    row["ok"] = ok
    if not ok:
        sp_fail(row, "tp_train")
    rows = [row, tp_checkpoint(rank, world, card, state, mesh, remat_cfg, ckpt_dir)]
    return rows


def tp_checkpoint(rank, world, card, state, mesh, cfg, ckpt_dir) -> dict:
    """Save ``state`` (the dp x tp shards), restore it onto a ('tp',)
    mesh of 4 and onto one device, and hold every gathered leaf
    bit-identical to the saved one."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import checkpoint as ck
    from nos_tpu_torch.parallel import make_train_step, mesh as pm
    from nos_tpu_torch.parallel.sharding import gather_shard, rule_leaves, tree_rules

    path = os.path.join(ckpt_dir, "state")
    dist.barrier()
    t0 = time.perf_counter()
    ck.save_checkpoint(path, state, 1, mesh=mesh)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for root, _, files in os.walk(path) for f in files)
    tp4 = pm.mesh_from_devices((world,), ("tp",))
    _, shard_b = make_train_step(tp4, cfg, learning_rate=SP_TRAIN_LR)
    target = shard_b(llama.init_llama_params(cfg, seed=72, device="cuda"), donate=True)
    torch.cuda.empty_cache()
    dist.barrier()
    t0 = time.perf_counter()
    onto, step_b = ck.restore_checkpoint(path, target, mesh=tp4)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    single, one_s = None, None
    if rank == 0:
        _, shard_1 = make_train_step(None, cfg, learning_rate=SP_TRAIN_LR)
        single = shard_1(llama.init_llama_params(cfg, seed=73, device="cuda"), donate=True)
        t0 = time.perf_counter()
        single, _ = ck.restore_checkpoint(path, single)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
    dist.barrier()
    specs_a = rule_leaves(tree_rules(state[0], mesh))
    specs_b = rule_leaves(tree_rules(onto[0], tp4))
    trees_a = [state[0], state[1]]
    trees_b = [onto[0], onto[1]]
    mismatched_tp4, mismatched_one, n = 0, 0, 0
    for t, (ta, tb) in enumerate(zip(trees_a, trees_b)):
        ones = llama.tree_leaves(single[t]) if single is not None else None
        for i, (a, b, sa, sb) in enumerate(zip(llama.tree_leaves(ta), llama.tree_leaves(tb),
                                               specs_a, specs_b)):
            wa = gather_shard(a.detach(), sa, mesh)
            wb = gather_shard(b.detach(), sb, tp4)
            mismatched_tp4 += int(not torch.equal(wa, wb))
            if ones is not None:
                mismatched_one += int(not torch.equal(wa, ones[i].detach()))
            n += 1
            del wa, wb
    row = {"phase": "checkpoint", "config": "llama_3_8b", "rank": rank,
           "saved_mesh": {"dp": 2, "tp": 2}, "restored_mesh": {"tp": world},
           "leaves": n, "bytes_on_disk": nbytes, "save_s": save_s,
           "restore_tp4_s": restore_s, "restored_step": step_b,
           "leaves_differing_tp4": mismatched_tp4, "card": card}
    ok = mismatched_tp4 == 0 and step_b == 1
    if rank == 0:
        row.update(restore_one_device_s=one_s, leaves_differing_one_device=mismatched_one)
        ok = ok and mismatched_one == 0
    row["ok"] = ok
    if not ok:
        sp_fail(row, "checkpoint")
    return row


def tp_phases(card) -> dict:
    """The tensor-parallel phases on spawned ranks: tp_forward at tp 2
    (TP2_FORWARD_LAYERS deep) and tp_generate / tp_engine (bf16 and
    int8) on two ranks; tp_forward at tp 4 (TP4_FORWARD_LAYERS deep),
    tp_train (dp 2 x tp 2, FSDP, remat) and checkpoint (saved, restored
    onto tp 4 and onto one device) on four. The parent holds no card
    memory."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.time()
    two = sp_spawn(2, [
        ("tp_forward_case", dict(seq=TP_FORWARD_SEQ, layers=TP2_FORWARD_LAYERS)),
        ("tp_engine_case", dict(new_tokens=TP_ENGINE_NEW)),
        ("tp_lora_train_case", {}),
        ("tp_spec_engine_case", {}),
    ], card)
    t_two = time.time() - t0
    ckpt_dir = tempfile.mkdtemp(prefix="nos-ckpt-")
    try:
        t0 = time.time()
        four = sp_spawn(4, [
            ("tp_forward_case", dict(seq=TP_FORWARD_SEQ, layers=TP4_FORWARD_LAYERS)),
            ("tp_train_case", dict(layers=TP_TRAIN_LAYERS, tokens_shape=TP_TRAIN_TOKENS,
                                   ckpt_dir=ckpt_dir)),
        ], card)
        t_four = time.time() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    forward = [rows[0] for rows in two] + [rows[0] for rows in four]
    serving = [row for i in range(3) for rows in two for row in [rows[1][i]]]
    train = [rows[1][0] for rows in four]
    checkpoint = [rows[1][1] for rows in four]
    lora = [rows[2] for rows in two]
    spec = [rows[3] for rows in two]
    for row in forward + serving + train + checkpoint + lora + spec:
        emit(row)
    emit({"phase": "tp_phases", "seconds_two_ranks": t_two, "seconds_four_ranks": t_four,
          "card": card})
    launches = {f"tp_forward.tp{row['tp']}": [] for row in forward}
    for row in forward:
        launches[f"tp_forward.tp{row['tp']}"].append(row["launches_fwd_dq_dkv"])
    launches["tp_generate.tp2"] = [row["launches_fwd_dq_dkv"] for row in serving
                                   if row["phase"] == "tp_generate"]
    launches["tp_train.dp2_tp2_fsdp_remat"] = [row["launches_fwd_dq_dkv"] for row in train]
    launches["tp_lora_train.tp2_remat_per_step"] = [row["launches_per_step_fwd_dq_dkv"][-1]
                                                    for row in lora]
    return {"launches": launches}


# Expert and pipeline parallelism, LoRA and SpecEngine under a mesh, on
# ranks sharing the card over gloo
EP_LAYER_TOKENS = 2048   # one Mixtral MoE layer: [1, 2048] over ep 4, [2, 1024] over dp 2 x ep 2
EP_FORWARD_SEQ = 2048    # Mixtral-8x7B int8 at full depth over ep 4
# Depths and lengths below were cut to keep the script inside its time
# budget: 16 new tokens, 32 and 8 Llama layers before the sharing phase
# joined it
EP_GENERATE_NEW = 8      # the first 8 of the one-device generate()'s 32 tokens
EP_TRAIN_LAYERS = 2
EP_TRAIN_TOKENS = (4, 2048)  # Mixtral at EP_TRAIN_LAYERS layers, dp 2 x ep 2
PP_FORWARD_LAYERS = 16
PP_FORWARD_TOKENS = (4, 2048)  # Llama-3-8B over pp 4, M 4
PP_TRAIN_LAYERS = 4
PP_TRAIN_TOKENS = (4, 2048)  # dp 2 x pp 2, M 2
EP_REL_LIMIT = 1e-2      # one MoE layer over ep against one device, rel. Frobenius
EP_LAYER_SKEW = 0.5      # scale of the hidden states' shared component (load skew)
TP_LORA_LAYERS = 4
TP_LORA_TOKENS = (4, 2048)
TP_SPEC_NEW = 16


def layered_params(cfg, seed, layers=None, top_fn=None):
    """A random model of ``cfg`` drawn one layer at a time: layer i is the
    layer of a one-layer model drawn from ``seed + i``, the embedding,
    final norm and head those of the draw of ``seed``. Only ``layers``
    (all by default) are drawn and kept, each draw through ``top_fn``
    first (optional), so a rank draws just its own layers and experts and
    every rank's share of one model is the same whatever the split."""
    from nos_tpu_torch.models import llama

    one = dataclasses.replace(cfg, n_layers=1)
    keep = list(range(cfg.n_layers)) if layers is None else list(layers)
    tree = None
    for i in sorted(set(keep) | {0}):
        draw = llama.init_llama_params(one, seed=seed + i, device="cuda")
        if top_fn is not None:
            draw = top_fn(draw)
        if tree is None:
            tree = dict(draw, layers=[])
        if i in keep:
            tree["layers"].append(draw["layers"][0])
        del draw
    return tree


def moe_slice(mesh):
    """A layer's ``moe`` node cut to this rank's experts (and d_ff /
    d_model shards) by the sharding rules."""
    from nos_tpu_torch.parallel.sharding import _zip_map, take_shard, tree_rules

    def cut(layer):
        rules = tree_rules({"moe": layer["moe"]}, mesh)["moe"]
        return dict(layer, moe=_zip_map(lambda x, s: take_shard(x, s, mesh),
                                        layer["moe"], rules))

    return cut


def mixtral_int8_rank_tree(cfg, mesh, seed=51):
    """The rank's share over ``mesh`` of ``mixtral_int8_tree(cfg, seed)``,
    drawn layer by layer: its E/ep experts of every layer (cut from the
    bf16 draw before quantizing: an int8 stack's scales are per expert
    and output column, so cutting first gives the same bytes), the rest
    whole."""
    from nos_tpu_torch.models.quantize import quantize_params

    cut = moe_slice(mesh)

    def rank_share(draw):
        return quantize_params(dict(draw, layers=[cut(draw["layers"][0])]))

    return layered_params(cfg, seed, top_fn=rank_share)


def ep_layer_case(rank, world, card) -> dict:
    """One full-width bf16 Mixtral MoE layer (seeded random router and
    experts, seeded hidden states of 2048 tokens sharing one component,
    so that at the default capacity factor capacity binds: held) over ep
    4 on [1, 2048] and over dp 2 x
    ep 2 on [2, 1024] (the same 2048 tokens), against the one-device
    moe_mlp on the same input: the kept-pair set exactly, the output
    within EP_REL_LIMIT (relative Frobenius); the bytes each collective
    received on this rank, and its host-staged time."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import moe as tm
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    cfg = mixtral_config()
    mc = cfg.moe_config()
    d, k, e = cfg.d_model, mc.top_k, mc.n_experts
    gen = torch.Generator(device="cuda").manual_seed(81)
    params = tm.init_moe_params(gen, mc)
    # a component shared by every token skews the router's load, so the
    # default capacity binds (about 18% of the pairs dropped)
    shared = EP_LAYER_SKEW * torch.randn((d,), generator=gen, device="cuda")
    x = (torch.randn((1, EP_LAYER_TOKENS, d), generator=gen, device="cuda")
         + shared).to(cfg.dtype)
    cap = tm.capacity_per_expert(EP_LAYER_TOKENS, mc)
    with torch.no_grad():
        want = tm.moe_mlp(params, x, mc)
        keep_one = tm._route(x.reshape(-1, d), params["router"], mc)[4]
    dropped = int((~keep_one).sum())
    rows = []
    for dims, names, shape in (((4,), ("ep",), (1, EP_LAYER_TOKENS)),
                               ((2, 2), ("dp", "ep"), (2, EP_LAYER_TOKENS // 2))):
        mesh = pm.mesh_from_devices(dims, names)
        ep, dp = pm.axis_size(mesh, "ep"), pm.axis_size(mesh, "dp")
        block = llama_data_sharding(mesh, x.reshape(*shape, d)).contiguous()
        shards = moe_slice(mesh)({"moe": params})["moe"]
        want_block = llama_data_sharding(mesh, want.reshape(*shape, d))
        keep_want = llama_data_sharding(mesh, keep_one.reshape(*shape, k)).reshape(-1)
        torch.cuda.synchronize()
        dist.barrier()
        with torch.no_grad(), comm.timed_collectives() as times:
            t0 = time.perf_counter()
            got = tm.moe_mlp(shards, block, mc, mesh)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            keep = tm._route(block.reshape(-1, d), shards["router"], mc, None, mesh,
                             block.shape[0])[4]
        row = {"phase": "ep_layer", "config": "mixtral_8x7b", "rank": rank,
               "mesh": dict(zip(names, dims)), "hidden": list(shape),
               "hidden_rank": list(block.shape[:2]), "capacity": cap,
               "capacity_factor": mc.capacity_factor,
               "kept_pairs_rank": int(keep.sum()), "pairs_rank": int(keep.numel()),
               "dropped_pairs_one_device": dropped,
               "kept_set_equal": bool(torch.equal(keep, keep_want)),
               "rel_frobenius_err": rel_frobenius(got, want_block),
               "rel_limit": EP_REL_LIMIT,
               "experts_rank": int(shards["w_gate"].shape[0]),
               # received on this rank: the other ep ranks' expert outputs
               # [E/ep, C, d] bf16, and the per-row routing counts [B/dp, E]
               # int64 of the other dp ranks
               "bytes_received": {
                   "ep_gather_out_e": (ep - 1) * (e // ep) * cap * d * 2,
                   "ep_race_counts": (dp - 1) * block.shape[0] * e * 8},
               "collective_calls": {kk: len(v) for kk, v in times.items()},
               "collective_ms_gloo_host_staged": {kk: sum(v) for kk, v in times.items()},
               "wall_ms_gloo_host_staged": wall, "card": card}
        row["ok"] = row["kept_set_equal"] and row["rel_frobenius_err"] <= EP_REL_LIMIT \
            and row["experts_rank"] == e // ep and dropped > 0
        if not row["ok"]:
            sp_fail(row, "ep_layer")
        rows.append(row)
    return rows


def ep_serve_case(rank, world, card, ref_path) -> list:
    """Mixtral-8x7B in int8 at full depth over ep 4: each rank draws the
    one-device tree's layers from the same per-layer seeds and keeps its 2
    experts of each, one rank after another. ep_forward: llama_forward on
    [1, EP_FORWARD_SEQ]
    (one forward launch a layer), the same logits on every rank, against
    the one-device logits (random routers, reported and held to the
    forward_check bars). ep_generate: generate() on [2, 512] +
    EP_GENERATE_NEW, the same tokens on every rank, against the
    one-device tokens (reported)."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import generate as gen_mod
    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models.quantize import weight_bytes
    from nos_tpu_torch.parallel import comm, mesh as pm

    cfg = mixtral_config()
    mesh = pm.mesh_from_devices((world,), ("ep",))
    torch.cuda.reset_peak_memory_stats()
    # one rank draws at a time: a draw holds a whole bf16 layer (2.8 GB)
    # beside the shares already built
    for r in range(world):
        if r == rank:
            t0 = time.perf_counter()
            tree = mixtral_int8_rank_tree(cfg, mesh)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
        dist.barrier()
    ref = torch.load(os.path.join(ref_path, "serve.pt"))
    gen = torch.Generator(device="cuda").manual_seed(53)
    tokens = torch.randint(0, cfg.vocab_size, (1, EP_FORWARD_SEQ), generator=gen, device="cuda")
    dist.barrier()
    with torch.no_grad(), comm.timed_collectives() as times:
        zero_counts()  # the ep forward path
        t0 = time.perf_counter()
        got = llama.llama_forward(tree, tokens, cfg, mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
    row = {"phase": "ep_forward", "config": "mixtral_8x7b", "weights": "int8",
           "rank": rank, "ep": world, "tokens": [1, EP_FORWARD_SEQ],
           "experts_rank": int(tree["layers"][0]["moe"]["w_gate"].q.shape[0]),
           "weight_bytes_rank": weight_bytes(tree), "build_s": build_s,
           "transport": comm.transport(mesh.get_group("ep"), "cuda"),
           "launches_fwd_dq_dkv": list(launches), "expected_launches": [cfg.n_layers, 0, 0],
           "same_logits_every_rank": same_on_every_rank(float(got.double().sum()), world),
           "collective_calls": {k: len(v) for k, v in times.items()},
           "collective_ms_gloo_host_staged": {k: sum(v) for k, v in times.items()},
           "wall_ms_gloo_host_staged": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    ok = list(launches) == row["expected_launches"] and row["same_logits_every_rank"] \
        and row["experts_rank"] == cfg.n_experts // world
    if rank == 0:
        want = torch.load(os.path.join(ref_path, "logits.pt")).cuda()
        stats = logits_agreement(got, want)
        row.update(stats, bit_identical_to_one_device=bool(torch.equal(got, want)),
                   rel_limit=FWD_REL_LIMIT, probs_limit=FWD_PROB_LIMIT,
                   argmax_limit=FWD_ARGMAX_LIMIT)
        ok = ok and logits_hold(stats)
        del want
    row["ok"] = ok
    if not ok:
        sp_fail(row, "ep_forward")
    del got
    torch.cuda.empty_cache()
    prompt = ref["prompt"].cuda()
    dist.barrier()
    with torch.no_grad():
        zero_counts()
        t0 = time.perf_counter()
        out = gen_mod.generate(tree, prompt, cfg, EP_GENERATE_NEW, mesh=mesh).tolist()
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        g_launches = counts()
    grow = {"phase": "ep_generate", "config": "mixtral_8x7b", "weights": "int8",
            "rank": rank, "ep": world, "prompt": [2, 512], "new_tokens": EP_GENERATE_NEW,
            "launches_fwd_dq_dkv": list(g_launches),
            "expected_launches": [cfg.n_layers, 0, 0],
            "same_tokens_every_rank": same_on_every_rank(out, world),
            "seconds_gloo_host_staged": gen_s,
            "tokens_per_s": 2 * EP_GENERATE_NEW / gen_s, "card": card}
    if rank == 0:
        one = ref["generated"][:, :EP_GENERATE_NEW].tolist()
        grow.update(token_agreement_with_one_device=agreement(out, one),
                    first_token_equal=[a[0] == b[0] for a, b in zip(out, one)])
    grow["ok"] = (grow["same_tokens_every_rank"] and list(g_launches) ==
                  grow["expected_launches"] and all(len(r) == EP_GENERATE_NEW for r in out))
    if not grow["ok"]:
        sp_fail(grow, "ep_generate")
    return [row, grow]


def ep_train_case(rank, world, card) -> dict:
    """Mixtral-8x7B at full width, EP_TRAIN_LAYERS deep (bf16, flash,
    random routers):
    one momentum-SGD step from zero velocity over dp 2 x ep 2 with FSDP and
    remat on [4, 2048], against the one-device make_train_step(None) step
    (rank 0 runs it first, alone) under the tp_train bars; the launches
    of each kernel (forward 2·L with the replay, dQ L, dK/dV L), the
    rank's param bytes (a quarter of the experts, half of the FSDP-sharded
    rest, the replicated norms and routers), its peak, and the step's
    host time split by collective kind."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, make_train_step, mesh as pm
    from nos_tpu_torch.parallel.sharding import llama_data_sharding

    cfg = mixtral_config(n_layers=EP_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(83)
    tokens = torch.randint(0, cfg.vocab_size, EP_TRAIN_TOKENS, generator=gen, device="cuda")
    ref = one_device_step(cfg, tokens, 83, SP_TRAIN_LR) if rank == 0 else None
    dist.barrier()
    mesh = pm.mesh_from_devices((2, 2), ("dp", "ep"))
    step, shard = make_train_step(mesh, dataclasses.replace(cfg, remat=True),
                                  learning_rate=SP_TRAIN_LR)
    state = shard(llama.init_llama_params(cfg, seed=83, device="cuda"), donate=True)
    torch.cuda.empty_cache()
    leaves = llama.tree_leaves(state[0])
    param_bytes = sum(p.numel() * p.element_size() for p in leaves)
    block = llama_data_sharding(mesh, tokens).contiguous()
    import torch._dynamo  # noqa: F401  (the first checkpointed step imports it)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    zero_counts()  # the ep x FSDP training path
    with comm.timed_collectives() as times:
        t0 = time.perf_counter()
        state, loss = step(state, block)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    compared = mesh_against_one_device(state, float(loss), ref, mesh, SP_TRAIN_LR)
    agree = same_on_every_rank(compared.pop("velocity_checksum"), world)
    collective_ms = {k: sum(v) for k, v in times.items()}
    layers = cfg.n_layers
    row = {"phase": "ep_train", "config": "mixtral_8x7b", "layers": layers,
           "mesh": {"dp": 2, "ep": 2}, "fsdp": True, "remat": True, "rank": rank,
           "tokens": list(EP_TRAIN_TOKENS), "tokens_rank": list(block.shape),
           "optimizer": f"momentum_sgd(lr={SP_TRAIN_LR}, momentum=0.9)",
           "loss": float(loss), "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [2 * layers, layers, layers], "replicas_agree": agree,
           "experts_rank": int(state[0]["layers"][0]["moe"]["w_gate"].shape[0]),
           "param_bytes_rank": param_bytes, "peak_gib": peak,
           "step_ms_with_split_gloo_host_staged": wall,
           "collective_ms_gloo_host_staged": collective_ms,
           "collective_calls": {k: len(v) for k, v in times.items()},
           "rest_ms": wall - sum(collective_ms.values()), **compared, "card": card}
    ok = agree and list(launches) == row["expected_launches"] and row["experts_rank"] == 4
    if rank == 0:
        whole = sum(2 * math.prod(p.shape) for p in ref["p0"])
        row.update(param_bytes_whole=whole, grad_rel_limit=SP_GRAD_REL_LIMIT,
                   loss_limit=TP_LOSS_LIMIT)
        ok = ok and held_to_one_device(row, TP_LOSS_LIMIT)
        del ref
    row["ok"] = ok
    if not ok:
        sp_fail(row, "ep_train")
    return row


def stage_shards(stage_tree, mesh, cfg):
    """This rank's shards of a stacked tree that holds only its stage's
    layers: the pipeline rules with pp taken as already applied."""
    from nos_tpu_torch.parallel.pipeline import pipeline_param_sharding
    from nos_tpu_torch.parallel.sharding import _zip_map, take_shard

    def no_pp(rule):
        if isinstance(rule, tuple):
            return tuple(None if a == "pp" else a for a in rule)
        return {k: no_pp(v) for k, v in rule.items()}

    rules = no_pp(pipeline_param_sharding(mesh, cfg))
    return _zip_map(lambda x, s: take_shard(x, s, mesh), stage_tree, rules)


def pp_forward_case(rank, world, card) -> dict:
    """Llama-3-8B at full width, PP_FORWARD_LAYERS deep (bf16, flash,
    random weights drawn layer by layer) through pipeline_llama_forward
    over pp 4 (PP_FORWARD_LAYERS / 4 layers a stage), [4, 2048] in 4 microbatches, against the one-device
    flash forward (rank 0 runs it first, alone) under forward_check's
    limits; M · L/pp forward launches a rank (the bubble ticks skip their
    compute), the same logits on every rank, the hops' and the
    broadcast's host-staged time."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel import pipeline as pl

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash",
                              n_layers=PP_FORWARD_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(91)
    tokens = torch.randint(0, cfg.vocab_size, PP_FORWARD_TOKENS, generator=gen, device="cuda")
    want = None
    if rank == 0:
        whole = layered_params(cfg, 91)
        with torch.no_grad():
            want = llama.llama_forward(whole, tokens, cfg)
        del whole
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = pm.mesh_from_devices((world,), ("pp",))
    per = cfg.n_layers // world
    stage = pl.stack_layer_params(layered_params(cfg, 91, range(rank * per, (rank + 1) * per)))
    m = world
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    with torch.no_grad(), comm.timed_collectives() as times:
        zero_counts()  # the pipeline forward path
        t0 = time.perf_counter()
        got = pl.pipeline_llama_forward(stage, tokens, cfg, mesh, m)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = counts()
    row = {"phase": "pp_forward", "config": "llama_3_8b", "rank": rank, "pp": world,
           "microbatches": m, "tokens": list(PP_FORWARD_TOKENS), "layers_rank": per,
           "launches_fwd_dq_dkv": list(launches), "expected_launches": [m * per, 0, 0],
           "ticks": m + world - 1, "bubble_share": (world - 1) / (m + world - 1),
           "hop_bytes": 2 * (PP_FORWARD_TOKENS[0] // m) * PP_FORWARD_TOKENS[1] * cfg.d_model,
           "same_logits_every_rank": same_on_every_rank(float(got.double().sum()), world),
           "collective_calls": {k: len(v) for k, v in times.items()},
           "collective_ms_gloo_host_staged": {k: sum(v) for k, v in times.items()},
           "wall_ms_gloo_host_staged": wall,
           "param_bytes_rank": sum(p.numel() * p.element_size()
                                   for p in llama.tree_leaves(stage)),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    ok = list(launches) == row["expected_launches"] and row["same_logits_every_rank"]
    if rank == 0:
        stats = logits_agreement(got, want)
        row.update(stats, rel_limit=FWD_REL_LIMIT, probs_limit=FWD_PROB_LIMIT,
                   argmax_limit=FWD_ARGMAX_LIMIT)
        ok = ok and logits_hold(stats)
    row["ok"] = ok
    if not ok:
        sp_fail(row, "pp_forward")
    return row


def pp_train_case(rank, world, card) -> dict:
    """Llama-3-8B at full width, PP_TRAIN_LAYERS deep (bf16, flash, drawn
    layer by layer), pipeline_loss_and_grads over dp 2 x pp 2 with FSDP
    and remat, [4, 2048] in 2 microbatches, against the one-device
    llama_loss and its gradients (rank 0, first, alone) under the
    tp_train bars (each leaf kind's gradient within 3% of its largest);
    the launches of each kernel a rank (forward 2 · M · L/pp with the
    replay, dQ and dK/dV M · L/pp), the bubble share, and the step's
    host time split by collective kind (the hops under "pp")."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel import pipeline as pl

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash",
                              n_layers=PP_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(93)
    tokens = torch.randint(0, cfg.vocab_size, PP_TRAIN_TOKENS, generator=gen, device="cuda")
    ref = None
    if rank == 0:
        whole = layered_params(cfg, 93)
        leaves = [p.requires_grad_(True) for p in llama.tree_leaves(whole)]
        loss_one = llama.llama_loss(whole, tokens, cfg)
        grads = torch.autograd.grad(loss_one, leaves)
        it = iter(grads)
        g_tree = llama.tree_map(lambda _: next(it), whole)
        ref = {"loss": float(loss_one),
               "g": [g.cpu() for g in llama.tree_leaves(pl.stack_layer_params(g_tree))]}
        del whole, leaves, grads, g_tree, loss_one
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = pm.mesh_from_devices((2, 2), ("dp", "pp"))
    pp, s = pm.axis_size(mesh, "pp"), pm.axis_index(mesh, "pp")
    per = cfg.n_layers // pp
    m = 2
    remat = dataclasses.replace(cfg, remat=True)
    stage = pl.stack_layer_params(layered_params(cfg, 93, range(s * per, (s + 1) * per)))
    shards = stage_shards(stage, mesh, remat)
    del stage
    torch.cuda.empty_cache()
    rows = pl.pipeline_data_sharding(mesh, tokens, m).contiguous()
    import torch._dynamo  # noqa: F401  (the first checkpointed step imports it)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    zero_counts()  # the pipeline training path
    with comm.timed_collectives() as times:
        t0 = time.perf_counter()
        loss, grads = pl.pipeline_loss_and_grads(shards, rows, remat, mesh, m)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    it = iter(grads)
    whole = pl.gather_pipeline_params(llama.tree_map(lambda _: next(it), shards), mesh, remat)
    g_whole = llama.tree_leaves(whole)
    checksum = sum(float(g.double().sum()) for g in g_whole)
    agree = same_on_every_rank(checksum, world)
    collective_ms = {k: sum(v) for k, v in times.items()}
    row = {"phase": "pp_train", "config": "llama_3_8b", "layers": cfg.n_layers,
           "mesh": {"dp": 2, "pp": 2}, "fsdp": True, "remat": True, "rank": rank,
           "microbatches": m, "tokens": list(PP_TRAIN_TOKENS), "tokens_rank": list(rows.shape),
           "layers_rank": per, "loss": float(loss),
           "launches_fwd_dq_dkv": list(launches),
           "expected_launches": [2 * m * per, m * per, m * per],
           "ticks": m + pp - 1, "bubble_share": (pp - 1) / (m + pp - 1),
           "replicas_agree": agree,
           "param_bytes_rank": sum(p.numel() * p.element_size()
                                   for p in llama.tree_leaves(shards)),
           "peak_gib": peak, "step_ms_with_split_gloo_host_staged": wall,
           "collective_ms_gloo_host_staged": collective_ms,
           "collective_calls": {k: len(v) for k, v in times.items()},
           "rest_ms": wall - sum(collective_ms.values()), "card": card}
    ok = agree and list(launches) == row["expected_launches"] and \
        bool(all(torch.isfinite(g).all() for g in g_whole))
    if rank == 0:
        diff, top = {}, {}
        for (kind, _), g, w in zip(named_stacked(whole), g_whole, ref["g"]):
            w = w.cuda().float()
            diff[kind] = max(diff.get(kind, 0.0), float((g.float() - w).abs().max()))
            top[kind] = max(top.get(kind, 0.0), float(w.abs().max()))
        row.update(one_device_loss=ref["loss"], loss_abs_diff=abs(float(loss) - ref["loss"]),
                   grad_rel_err={k: diff[k] / top[k] for k in diff},
                   loss_limit=TP_LOSS_LIMIT, grad_rel_limit=SP_GRAD_REL_LIMIT)
        ok = ok and row["loss_abs_diff"] <= TP_LOSS_LIMIT and \
            max(row["grad_rel_err"].values()) <= SP_GRAD_REL_LIMIT
    row["ok"] = ok
    if not ok:
        sp_fail(row, "pp_train")
    return row


def named_stacked(tree):
    """(kind, tensor) of a stacked tree in tree_leaves order."""
    for key, value in tree.items():
        if key == "layers":
            for name, leaf in value.items():
                if isinstance(leaf, dict):
                    yield from ((f"{name}.{k}", v) for k, v in leaf.items())
                else:
                    yield name, leaf
        else:
            yield key, value


def tp_lora_train_case(rank, world, card) -> dict:
    """make_lora_train_step over tp 2: Llama-3-8B at full width,
    TP_LORA_LAYERS deep (bf16, flash, remat), rank 8 on wq / wv, three
    Adam steps on [4, 2048], against the one-device LoRA step (rank 0,
    first, alone): the losses within TP_LOSS_LIMIT, and each adapter's
    first moment after the three steps (Adam's exp_avg, a weighted sum of
    the steps' whole gradients: a tp x or 1/tp gradient would miss by
    50-100%) within SP_GRAD_REL_LIMIT (relative Frobenius; the largest
    elementwise error over the leaf's largest reported). B starts from a
    seeded 0.01-scale draw, not zeros, so A's gradient is live and well
    conditioned from the first step. The adapters' change over the steps
    is reported beside it, not held: Adam's first steps move each element
    by about lr whatever its gradient's size, so bf16 rounding flips the
    step of elements whose gradient is near zero. The launches a step,
    the step's host time split by collective kind."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.models import lora as tlora
    from nos_tpu_torch.parallel import comm, mesh as pm
    from nos_tpu_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash", remat=True,
                              n_layers=TP_LORA_LAYERS)
    lc = tlora.LoraConfig(rank=8, targets=("wq", "wv"))
    gen = torch.Generator(device="cuda").manual_seed(101)
    tokens = torch.randint(0, cfg.vocab_size, TP_LORA_TOKENS, generator=gen, device="cuda")

    def adapters():
        tree = tlora.init_lora_params(cfg, lc, seed=101)
        b_gen = torch.Generator(device="cuda").manual_seed(102)
        for layer in tree["layers"]:
            for ab in layer.values():
                ab["b"] = 0.01 * torch.randn(ab["b"].shape, generator=b_gen, device="cuda")
        return tree

    def three_steps(mesh, base):
        step, shard = tlora.make_lora_train_step(mesh, cfg, lc, learning_rate=1e-3)
        state = shard(adapters())
        start = [t.detach().clone() for t in llama.tree_leaves(state[0])]
        losses, ms, per_step = [], [], []
        for _ in range(3):
            at = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, base, tokens)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            per_step.append([a - b for a, b in zip(counts(), at)])
        leaves = llama.tree_leaves(state[0])
        moved = [(t.detach() - s).float() for t, s in zip(leaves, start)]
        moments = [state[1].state[p]["exp_avg"].float() for p in leaves]
        return losses, ms, per_step, moved, moments

    one = None
    if rank == 0:
        base = llama.init_llama_params(cfg, seed=101, device="cuda")
        one = three_steps(None, base)
        del base
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = pm.mesh_from_devices((world,), ("tp",))
    base = shard_params(llama.init_llama_params(cfg, seed=101, device="cuda"), mesh, cfg)
    torch.cuda.empty_cache()
    dist.barrier()
    zero_counts()  # the tp LoRA training path
    with comm.timed_collectives() as times:
        losses, ms, per_step, moved, moments = three_steps(mesh, base)
    checksum = sum(float(t.double().sum()) for t in moved + moments)
    row = {"phase": "tp_lora_train", "config": "llama_3_8b", "layers": cfg.n_layers,
           "rank": rank, "tp": world, "lora_rank": 8, "targets": list(lc.targets),
           "tokens": list(TP_LORA_TOKENS), "optimizer": "torch.optim.Adam(lr=1e-3)",
           "remat": True, "losses": losses, "step_ms_gloo_host_staged": ms,
           "launches_per_step_fwd_dq_dkv": per_step,
           "expected_launches": [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers],
           "adapters_agree_every_rank": same_on_every_rank(checksum, world),
           "collective_ms_gloo_host_staged": {k: sum(v) for k, v in times.items()},
           "collective_calls": {k: len(v) for k, v in times.items()}, "card": card}
    ok = row["adapters_agree_every_rank"] and \
        all(s == row["expected_launches"] for s in per_step)
    if rank == 0:
        w_losses, w_ms, _, w_moved, w_moments = one
        frob = [float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
                for g, w in zip(moved, w_moved)]
        first = [float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
                 for g, w in zip(moments, w_moments)]
        first_max = [float((g - w).abs().max() / w.abs().max())
                     for g, w in zip(moments, w_moments)]
        row.update(one_device_losses=w_losses, one_device_step_ms=w_ms,
                   loss_abs_diff=max(abs(a - b) for a, b in zip(losses, w_losses)),
                   first_moment_rel_frobenius_max=max(first),
                   first_moment_rel_elementwise_max=max(first_max),
                   adapter_change_rel_frobenius_max=max(frob),
                   loss_limit=TP_LOSS_LIMIT, first_moment_limit=SP_GRAD_REL_LIMIT)
        ok = ok and row["loss_abs_diff"] <= TP_LOSS_LIMIT and max(first) <= SP_GRAD_REL_LIMIT
    row["ok"] = ok
    if not ok:
        sp_fail(row, "tp_lora_train")
    return row


def tp_spec_engine_case(rank, world, card) -> dict:
    """SpecEngine over tp 2: the Llama-3-8B target at full depth (bf16,
    flash) on the rank's shard_for_serving shards and head-sharded cache,
    a 2-layer draft (its first layers, sharing the embedding and head)
    whole on every rank, k = 4, four requests of TP_SPEC_NEW tokens
    admitted in 16-token pieces: the same tokens on every rank; against
    the one-device SpecEngine (rank 0, first) the share of equal tokens
    is reported."""
    import torch
    import torch.distributed as dist

    from nos_tpu_torch.models import llama
    from nos_tpu_torch.parallel import mesh as pm
    from nos_tpu_torch.serve import GenRequest, SpecEngine, shard_for_serving

    cfg = dataclasses.replace(llama.llama_3_8b_config(), attention="flash")
    params = llama.init_llama_params(cfg, seed=103, device="cuda")
    draft = dict(params, layers=params["layers"][:2])
    dcfg = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(103)
    pool = torch.randint(1, cfg.vocab_size, (600,), generator=gen, device="cuda").tolist()
    prompts = [pool[:20], pool[20:120], pool[120:320], pool[320:530]]

    def serve(tree, mesh):
        eng = SpecEngine(tree, cfg, draft, dcfg, k=4, max_slots=4, max_len=512,
                         prefill_chunk=16, mesh=mesh)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=TP_SPEC_NEW))
                   for p in prompts]
            got = eng.run()
            torch.cuda.synchronize()
        return [got[i] for i in ids], time.perf_counter() - t0, eng.stats()

    one = serve(params, None) if rank == 0 else None
    dist.barrier()
    mesh = pm.mesh_from_devices((world,), ("tp",))
    shards = shard_for_serving(params, mesh, cfg)
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    zero_counts()
    toks, seconds, stats = serve(shards, mesh)
    row = {"phase": "tp_spec_engine", "config": "llama_3_8b", "rank": rank, "tp": world,
           # admission is chunked (decode_chunk's einsum attention): no kernel
           "launches_fwd_dq_dkv": list(counts()),
           "draft_layers": 2, "k": 4, "prefill_chunk": 16, "requests": len(prompts),
           "prompt_tokens": [len(p) for p in prompts], "new_tokens": TP_SPEC_NEW,
           "rounds": stats["rounds"], "mean_accepted": stats["mean_accepted"],
           "same_tokens_every_rank": same_on_every_rank(toks, world),
           "seconds_gloo_host_staged": seconds,
           "tokens_per_s": TP_SPEC_NEW * len(prompts) / seconds, "card": card}
    ok = row["same_tokens_every_rank"] and all(
        len(t) == TP_SPEC_NEW and all(0 <= x < cfg.vocab_size for x in t) for t in toks)
    if rank == 0:
        row.update(one_device_seconds=one[1], one_device_mean_accepted=one[2]["mean_accepted"],
                   token_agreement_with_one_device=agreement(toks, one[0]),
                   first_token_equal=[a[0] == b[0] for a, b in zip(toks, one[0])])
    row["ok"] = ok
    if not ok:
        sp_fail(row, "tp_spec_engine")
    return row


def ep_pp_phases(card, ref_path) -> dict:
    """The expert- and pipeline-parallel phases on four spawned ranks, one
    spawn: ep_layer, ep_forward and ep_generate (Mixtral int8 over ep 4,
    against the one-device results the mixtral_int8 phase left in
    ``ref_path``), ep_train (dp 2 x ep 2), pp_forward and pp_train. Each
    case frees its card memory before the next. The parent holds no card
    memory."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = sp_spawn(4, [("ep_layer_case", {}), ("ep_serve_case", dict(ref_path=ref_path)),
                         ("ep_train_case", {}), ("pp_forward_case", {}),
                         ("pp_train_case", {})], card)
    seconds = time.time() - t0
    layer = [r for rows in ranks for r in rows[0]]
    forward = [rows[1][0] for rows in ranks]
    generate = [rows[1][1] for rows in ranks]
    train = [rows[2] for rows in ranks]
    pp_forward = [rows[3] for rows in ranks]
    pp_train = [rows[4] for rows in ranks]
    for row in layer + forward + generate + train + pp_forward + pp_train:
        emit(row)
    emit({"phase": "ep_pp_phases", "seconds_four_ranks": seconds, "card": card})
    return {"launches": {
        "ep_forward.ep4": [r["launches_fwd_dq_dkv"] for r in forward],
        "ep_generate.ep4": [r["launches_fwd_dq_dkv"] for r in generate],
        "ep_train.dp2_ep2_fsdp_remat": [r["launches_fwd_dq_dkv"] for r in train],
        "pp_forward.pp4": [r["launches_fwd_dq_dkv"] for r in pp_forward],
        "pp_train.dp2_pp2_fsdp_remat": [r["launches_fwd_dq_dkv"] for r in pp_train]}}


def sp_launches(sp, index: int, hd256: bool) -> dict:
    """Per-rank launches of kernel ``index`` (0 forward, 1 dQ, 2 dK/dV) on
    each sp path, at head_dim 256 or at 128."""
    return {path: [r[index] for r in per_rank] for path, per_rank in sp["launches"].items()
            if ("gemma" in path) == hd256}


# The device layer and the sharing comparison (run first, before this
# process makes its first CUDA call, so an MPS server meets no other
# context of the script)
SHARING_PODS = (1, 3)
SHARING_SECONDS = 3.0
MIG_MEMORY_SLACK = 0.9   # NVML's MB of a profile against its nominal GB x 1024


def sharing_phase(card) -> dict:
    """nos_tpu_torch.demos.sharing at SHARING_PODS clients, SHARING_SECONDS
    windows: time-sliced and MPS rows (MIG only if MIG mode is already
    on), each client's first-batch logits held against the solo client's
    (raises otherwise); a row the machine forbids says "not run: <reason>".
    No MPS process the sweep started may outlive it."""
    from nos_tpu_torch.demos import sharing

    t0 = time.time()

    def log(row):
        status = f"not run: {row['not_run']}" if "not_run" in row else "ran"
        emit({"phase": "sharing", **row, "status": status, "card": card})

    result = sharing.run_sweep("cuda", SHARING_PODS, SHARING_SECONDS, log=log)
    left = result["mps_left"]
    ran = {(r["discipline"], r["pods"]) for r in result["rows"] if "not_run" not in r}
    ok = all(("time-sliced", n) in ran for n in SHARING_PODS) and not left
    emit({"phase": "sharing", "seconds": time.time() - t0, "sweep_s": result["sweep_s"],
          "rows_run": sorted(f"{d} x{n}" for d, n in ran),
          "not_run": sorted({f"{r['discipline']}: {r['not_run']}" for r in result["rows"]
                             if "not_run" in r}),
          "mps_processes_left": left, "ok": ok, "card": card})
    if not ok:
        raise SystemExit(f"sharing failed: rows run {sorted(ran)}, MPS processes left {left}")
    return result


def nvml_phase(card) -> dict:
    """NVML (nos_tpu_torch.device.nvml) against torch: the same count,
    name and UUID, memory totals side by side; the MIG mode, current and
    pending; the H100 table against NVML's profile info and placements
    where NVML gives them (only "Not Supported" with MIG mode off may
    leave it unchecked; any other NVML error fails the phase); the write
    path (a 1g.10gb instance created, read back, destroyed in a finally)
    only if MIG mode is already on. The MIG mode itself is never
    changed."""
    import torch

    from nos_tpu_torch.device.nvml import (NVML_DEVICE_MIG_ENABLE, NVML_ERROR_NOT_SUPPORTED,
                                           Nvml, NvmlError, NvmlMigClient)
    from nos_tpu_torch.device.client import MigPlacementError
    from nos_tpu_torch.gpu.known import H100_80GB, KNOWN_GPUS

    props = torch.cuda.get_device_properties(0)
    with Nvml() as nv:
        row = {"phase": "nvml", "count": nv.device_count(),
               "torch_count": torch.cuda.device_count(), "name": nv.name(0),
               "torch_name": torch.cuda.get_device_name(0),
               "torch_uuid": str(props.uuid), "memory_total": nv.memory_total(0),
               "torch_total_memory": props.total_memory}
        row["uuid_equal"] = nv.uuid(0) == f"GPU-{props.uuid}"
        current, pending = nv.mig_mode(0)
        row["mig_mode"] = {"current": current, "pending": pending}
        identity = (row["count"] == row["torch_count"] and row["name"] == row["torch_name"]
                    and row["uuid_equal"])
        if not identity:
            emit({**row, "ok": False, "card": card})
            raise SystemExit("nvml: NVML's card is not torch's")
        table, mismatches = [], []
        try:
            for p in KNOWN_GPUS[H100_80GB].profiles:
                info = nv.profile_info(0, p.nvml_profile)
                placements = nv.possible_placements(0, info["id"])
                got = {"name": info["name"], "compute_slices": info["slice_count"],
                       "max_instances": info["instance_count"], "placements": placements,
                       "memory_mb": info["memory_mb"]}
                want = {"name": f"MIG {p.name}", "compute_slices": p.compute_slices,
                        "max_instances": p.max_instances,
                        "placements": [(s, p.memory_slices) for s in p.starts]}
                bad = [k for k in want if got[k] != want[k]]
                if not MIG_MEMORY_SLACK <= got["memory_mb"] / (p.memory_gb * 1024) <= 1.0:
                    bad.append("memory_mb")
                table.append({"profile": p.name, "nvml": got, "mismatched": bad})
                mismatches += [f"{p.name}.{k}" for k in bad]
            row["table"] = "checked"
        except NvmlError as e:
            # a wrong struct layout or version gives another code: a failure
            if current == NVML_DEVICE_MIG_ENABLE or e.code != NVML_ERROR_NOT_SUPPORTED:
                emit({**row, "table_error": str(e), "ok": False, "card": card})
                raise
            row["table"] = f"not checked: {e.text}"
        row["table_rows"] = table
        if current == NVML_DEVICE_MIG_ENABLE:
            client = NvmlMigClient(nv)
            created = []
            try:
                created = client.create_mig_devices(0, {"1g.10gb": 1})
                seen = {d.uuid for d in client.get_mig_devices()}
                row["write_path"] = {"created": [d.profile for d in created],
                                     "read_back": all(d.uuid in seen for d in created)}
            except MigPlacementError as e:
                row["write_path"] = f"not run: {e}"
            finally:
                for d in created:
                    client.delete_mig_device(d.uuid)
            if created:
                seen = {d.uuid for d in client.get_mig_devices()}
                row["write_path"]["destroyed"] = not any(d.uuid in seen for d in created)
        else:
            row["write_path"] = (f"not run: MIG mode disabled (current {current}, "
                                 f"pending {pending})")
    wrote = row["write_path"]
    ok = not mismatches and (isinstance(wrote, str) or (wrote["read_back"] and wrote["destroyed"]))
    emit({**row, "table_mismatches": mismatches, "ok": ok, "card": card})
    if not ok:
        raise SystemExit(f"nvml failed: table mismatches {mismatches}, write path {wrote}")
    return row


MIGAGENT_INTERVAL_S = 0.005
MIGAGENT_ACK_TIMEOUT_S = 10.0


def _await_ack(store, node, plan, step=None) -> float:
    """Milliseconds until the node's status plan is ``plan``; ``step``
    drives the agent in this thread, else its own loop does."""
    from nos_tpu_torch.gpu import annotations as annot

    t0 = time.perf_counter()
    while store.get("Node", node).annotations.get(annot.STATUS_PARTITIONING_PLAN) != plan:
        if time.perf_counter() - t0 > MIGAGENT_ACK_TIMEOUT_S:
            raise SystemExit(f"migagent: plan {plan} not acknowledged in "
                             f"{MIGAGENT_ACK_TIMEOUT_S} s")
        if step is not None:
            step()
        else:
            time.sleep(0.0002)
    return 1e3 * (time.perf_counter() - t0)


def migagent_phase(card) -> dict:
    """The MIG node agent. Over NVML (nos_tpu_torch.device.nvml),
    build_migagent must refuse a GPU whose MIG mode is off, naming it and
    both modes ("nvml_agent": "not run: MIG mode disabled ..."); where MIG
    is on, the agent applies a spec of one more 1g.10gb on GPU 0, the
    reporter acknowledges it, a spec without it removes it, and whatever
    it created is deleted in a finally. Then the same loop, on its own
    thread every MIGAGENT_INTERVAL_S, over SimMigClient (an H100 80GB)
    through the re-carve 7g.80gb -> 3g.40gb + 3g.40gb: milliseconds from
    each spec to its ack, the instances, allocatable and status. The
    kubelet's pod-resources client runs only where its socket exists."""
    from nos_tpu_torch.controllers.migagent import build_migagent
    from nos_tpu_torch.device.client import GpuClient
    from nos_tpu_torch.device.nvml import (NVML_DEVICE_MIG_ENABLE, MigModeDisabledError, Nvml,
                                           NvmlMigClient)
    from nos_tpu_torch.device.podresources import DEFAULT_SOCKET, KubeletPodResourcesClient
    from nos_tpu_torch.device.sim import (DevicePluginAdvertiser, SimDevicePlugin,
                                          SimMigClient, SimMigPool, SimPodResourcesClient)
    from nos_tpu_torch.device.types import device_geometry
    from nos_tpu_torch.gpu import annotations as annot
    from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB
    from nos_tpu_torch.gpu.node import RESOURCE_GPU, mig_resource
    from nos_tpu_torch.kube.store import Node, NodeStore
    from nos_tpu_torch.partitioning.mig import MigPartitioner

    t0 = time.time()
    row = {"phase": "migagent"}
    checks = {}
    with Nvml() as nv:
        current, pending = nv.mig_mode(0)
        store = NodeStore()
        store.create(Node("card", labels={GPU_PRODUCT_LABEL: H100_80GB},
                          capacity={RESOURCE_GPU: nv.device_count()}))
        client = NvmlMigClient(nv)
        gpu_client = GpuClient(client, SimPodResourcesClient(store, "card",
                                                             client.get_mig_devices))
        plugin = DevicePluginAdvertiser(
            store, lambda node: device_geometry(client.get_mig_devices()))
        try:
            agent, refusal = build_migagent(store, "card", gpu_client, plugin), None
        except MigModeDisabledError as e:
            agent, refusal = None, str(e)
        row["mig_mode"] = {"current": current, "pending": pending}
        if current != NVML_DEVICE_MIG_ENABLE:
            why = f"MIG mode disabled (current {current}, pending {pending})"
            row["nvml_agent"] = f"not run: {why}"
            row["refusal"] = refusal
            checks["nvml_refused"] = refusal is not None and f"GPU 0: {why}" in refusal
        else:
            checks["nvml_built"] = refusal is None
            before = {d.uuid for d in client.get_mig_devices()}
            base = device_geometry(client.get_mig_devices())
            more = {g: dict(p) for g, p in base.items()}
            gpu0 = more.setdefault(0, {})
            gpu0["1g.10gb"] = gpu0.get("1g.10gb", 0) + 1
            partitioner = MigPartitioner(store)
            try:
                partitioner.apply_partitioning("card", "nvml-1", more)
                ack_ms = [_await_ack(store, "card", "nvml-1", agent.step)]
                added = [d.profile for d in client.get_mig_devices() if d.uuid not in before]
                partitioner.apply_partitioning("card", "nvml-2", base)
                ack_ms.append(_await_ack(store, "card", "nvml-2", agent.step))
                left = [d.uuid for d in client.get_mig_devices() if d.uuid not in before]
                row["nvml_agent"] = {"created": added, "left_after_removal": left,
                                     "spec_to_ack_ms": ack_ms}
                checks["nvml_write_path"] = added == ["1g.10gb"] and not left
            finally:
                for d in client.get_mig_devices():
                    if d.uuid not in before:
                        client.delete_mig_device(d.uuid)

    store = NodeStore()
    store.create(Node("h100-sim", labels={GPU_PRODUCT_LABEL: H100_80GB},
                      capacity={RESOURCE_GPU: 1}, allocatable={RESOURCE_GPU: 1}))
    pool = SimMigPool()
    sim = SimMigClient(pool, "h100-sim")
    agent = build_migagent(store, "h100-sim",
                           GpuClient(sim, SimPodResourcesClient(store, "h100-sim",
                                                                sim.get_mig_devices)),
                           SimDevicePlugin(store, pool), interval=MIGAGENT_INTERVAL_S)
    partitioner = MigPartitioner(store)
    ack_ms = []
    agent.start()
    try:
        for plan, geometry in (("1", {0: {"7g.80gb": 1}}), ("2", {0: {"3g.40gb": 2}})):
            partitioner.apply_partitioning("h100-sim", plan, geometry)
            ack_ms.append(_await_ack(store, "h100-sim", plan))
    finally:
        agent.stop()
    node = store.get("Node", "h100-sim")
    _, status = annot.parse_node_annotations(node.annotations)
    row["sim"] = {"recarve": "7g.80gb -> 3g.40gb x 2", "interval_s": MIGAGENT_INTERVAL_S,
                  "spec_to_ack_ms": ack_ms, "instances": pool.geometry("h100-sim"),
                  "allocatable": node.allocatable,
                  "status": annot.status_geometries(status)}
    checks["sim_recarve"] = (agent.error is None
                             and pool.geometry("h100-sim") == {0: {"3g.40gb": 2}}
                             and row["sim"]["status"] == {0: {"3g.40gb": 2}}
                             and node.allocatable == {RESOURCE_GPU: 0,
                                                      mig_resource("3g.40gb"): 2})
    if os.path.exists(DEFAULT_SOCKET):
        try:
            kubelet = KubeletPodResourcesClient(timeout_seconds=5)
            try:
                row["kubelet"] = {"used_device_ids": kubelet.get_used_device_ids()}
            finally:
                kubelet.close()
        except ImportError as e:
            row["kubelet"] = f"not run: {e}"
    else:
        row["kubelet"] = f"not run: no kubelet pod-resources socket at {DEFAULT_SOCKET}"
    row.update(checks=checks, ok=all(checks.values()), seconds=time.time() - t0, card=card)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"migagent failed: {row}")
    return row


PARTITIONER_PODS = 40
PARTITIONER_MAX_STEPS = 500
PARTITIONER_PLAN_SIZE = (64, 200)  # nodes x pending pods, 8 H100s a node
PARTITIONER_PLAN_REPEATS = 3
# the cache-on p50 of PR 15's vanilla framework at PARTITIONER_PLAN_SIZE
# (NVIDIA H100 80GB HBM3 at 700 W; PERF.md), printed beside this run's
PARTITIONER_PR15_P50_MS = 59.61


def partitioner_phase(card) -> dict:
    """The control loop on the card's machine: a SimCluster whose first
    MIG node is the card itself as NVML names it, pending pods around
    scheduler -> partitioner -> agent -> scheduler -> kubelet until
    idle, held to the loop's invariants; then the planner's cold plans
    at 512 GPUs, cache on and off, which must agree, with the cache
    answering some trials and some pods left unserved."""
    import random

    import torch

    from nos_tpu_torch.cluster import SimCluster
    from nos_tpu_torch.device.nvml import Nvml
    from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB
    from nos_tpu_torch.gpu.node import RESOURCE_GPU, mig_resource, mps_resource
    from nos_tpu_torch.kube.store import Pod, PodPhase
    from nos_tpu_torch.partitioning import bench_planner

    t0 = time.time()
    row = {"phase": "partitioner", "host_cpus": os.cpu_count()}
    checks = {}
    cluster = SimCluster()
    with Nvml() as nv:
        node = cluster.add_mig_node("mig-card", nvml=nv)
        row["nvml"] = {"name": nv.name(0), "power_limit_w": nv.power_limit_w(0),
                       "product": node.labels[GPU_PRODUCT_LABEL],
                       "gpus": node.capacity[RESOURCE_GPU]}
    checks["nvml_identity"] = (row["nvml"]["product"] == H100_80GB
                               and row["nvml"]["gpus"] == torch.cuda.device_count())
    cluster.add_mig_node("mig-1", gpus=8)
    cluster.add_mps_node("mps-0", gpus=8)
    mix = ([mig_resource(p) for p in ("1g.10gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.80gb")]
           + [mps_resource(p) for p in ("10gb", "20gb")])
    rng = random.Random(15)
    for i in range(PARTITIONER_PODS):
        cluster.store.create(Pod(f"job-{i:02d}", "smoke", request={rng.choice(mix): 1}))
    t1 = time.perf_counter()
    idle = cluster.run_until_idle(PARTITIONER_MAX_STEPS)
    wall = time.perf_counter() - t1
    pods = cluster.store.list("Pod")
    checks["idle"] = idle
    checks.update(cluster.check())
    unserved = cluster.unserved()
    row["loop"] = {
        "gpus": {"mig": row["nvml"]["gpus"] + 8, "mps": 8}, "pods": len(pods),
        "placed": sum(p.phase == PodPhase.RUNNING for p in pods),
        "unserved": len(unserved), "plans_applied": {c.kind: c.plans_applied
                                                     for c in cluster.controllers},
        "plans": {c.kind: c.plans_processed for c in cluster.controllers},
        "steps": cluster.steps, "wall_s": wall,
        "admission_rejects": cluster.kubelet.admission_rejects,
        "instances": {n: cluster.pool.geometry(n) for n in ("mig-card", "mig-1")},
        "unserved_reasons": sorted(set(unserved.values()))}
    checks["pods_placed"] = row["loop"]["placed"] > 0
    n_nodes, n_pods = PARTITIONER_PLAN_SIZE
    # the simulation framework SimCluster plans with (the quota PreFilter
    # on every trial), and the vanilla filters alone in the same run
    rows = bench_planner.run([(n_nodes, n_pods)], 8, PARTITIONER_PLAN_REPEATS)
    vanilla = bench_planner.run([(n_nodes, n_pods)], 8, PARTITIONER_PLAN_REPEATS, "vanilla")
    row["plans_at_size"] = rows
    row["plans_at_size_vanilla"] = vanilla
    row["plan_p50_ms"] = {"sim": rows[0]["p50_plan_ms"], "vanilla": vanilla[0]["p50_plan_ms"],
                          "vanilla_pr15": PARTITIONER_PR15_P50_MS}
    # the bench's quota admits every pod: the quota PreFilter changes no plan
    checks["plan_sim_equals_vanilla"] = all(
        (a["pods_placed"], a["pods_unserved"], a["forks_total"])
        == (b["pods_placed"], b["pods_unserved"], b["forks_total"])
        for a, b in zip(rows, vanilla))
    checks["plan_cache_on_equals_off"] = rows[0]["plan_equals_cache_off"]
    # the comparison means something only where the cache decided trials
    checks["plan_cache_hits"] = rows[0]["cache_hits"] > 0
    # demand exceeds the free supply: the carve loop ran to exhaustion
    checks["plan_demand_exceeds_supply"] = rows[0]["pods_unserved"] > 0
    checks["plans_deterministic"] = all(r["deterministic"] for r in rows + vanilla)
    row.update(checks=checks, ok=all(checks.values()), seconds=time.time() - t0, card=card)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"partitioner failed: {checks}")
    return row


KUBE_NODES = 32           # MIG nodes of 8 H100s: 256 GPUs
KUBE_PODS = 400
KUBE_BINDS = 300
KUBE_FINISHED = 50
KUBE_DELETED = 50
KUBE_SEED = 21


def kube_phase(card, nvml=None) -> dict:
    """The kube substrate over HTTP at a real cluster size: the port's
    StubApiServer on 127.0.0.1 and KubeApiStores on it; two replicas,
    each a LeaderElector and, while it leads, a threaded Manager feeding a
    ClusterState through state-node / state-pod. Through the API: 32 MIG
    nodes of 8 H100s (the first with the card's product as NVML names
    it), 400 pods, 300 bound through the binding subresource (an event
    recorded on the node at each), then the first leader releases, 50
    pods finish and 50 are deleted. Checked: each store's cache equals
    the server's objects; the leader's ClusterState equals a whole sync
    of its cache; each store's watch delivered every kind in resource
    version order; never two leaders at once, and the lease changed hands;
    the recorder bumped its duplicates (one event a node, counts summing
    to the binds). Reported: a fresh store's list+watch sync at the end,
    the HTTP writes' p50 / p99, the create-to-ClusterState lag (a node's
    create, a pod's bind) p50 / p99, the handover."""
    import random
    import threading

    if nvml is None:
        from nos_tpu_torch.device.nvml import Nvml

        with Nvml() as nv:
            return kube_phase(card, nvml=nv)
    from nos_tpu_torch.cluster import HOSTNAME_LABEL, NODE_CPU, NODE_MEMORY_GIB, product_label
    from nos_tpu_torch.controllers.partitioner.node_controller import add_state_controllers
    from nos_tpu_torch.gpu.known import GPU_PRODUCT_LABEL, H100_80GB
    from nos_tpu_torch.gpu.node import (
        PARTITIONING_LABEL,
        PARTITIONING_MIG,
        RESOURCE_GPU,
        mig_resource,
    )
    from nos_tpu_torch.kube import serde
    from nos_tpu_torch.kube.apiclient import ClusterCredentials, KubeApiClient
    from nos_tpu_torch.kube.apistore import KubeApiStore
    from nos_tpu_torch.kube.controller import Manager
    from nos_tpu_torch.kube.events import EventRecorder
    from nos_tpu_torch.kube.leaderelection import LeaderElector
    from nos_tpu_torch.kube.store import Node, Pod, PodPhase
    from nos_tpu_torch.partitioning.core import ClusterState
    from nos_tpu_torch.sim.apiserver import StubApiServer
    from nos_tpu_torch.slo.driver import percentiles

    class TimedState(ClusterState):
        """Stamps when each node, and each pod on its node, first enters."""

        def __init__(self):
            super().__init__()
            self.seen = {}

        def update_node(self, node, pods):
            super().update_node(node, pods)
            now = time.perf_counter()
            self.seen.setdefault(("Node", node.name), now)
            for pod in pods:
                self.seen.setdefault(("Pod", pod.namespaced_name, node.name), now)

        def update_pod_usage(self, pod):
            super().update_pod_usage(pod)
            if pod.node and self.bindings().get(pod.namespaced_name) == pod.node:
                self.seen.setdefault(("Pod", pod.namespaced_name, pod.node),
                                     time.perf_counter())

    kinds = ("Node", "Pod", "ConfigMap", "Event")
    t0 = time.time()
    rng = random.Random(KUBE_SEED)
    row = {"phase": "kube", "nvml": {"name": nvml.name(0), "gpus": nvml.device_count()}}
    server = StubApiServer().start()

    def new_store():
        return KubeApiStore(KubeApiClient(ClusterCredentials(server=server.url), timeout=30.0),
                            kinds=kinds)

    replicas = {}
    leaders = []  # (identity, started or stopped, perf_counter)
    stores, electors = [], []
    try:
        for ident in ("a", "b"):
            store = new_store()
            store.start(sync_timeout_s=30.0)
            stores.append(store)
            state = TimedState()
            manager = Manager(store)
            add_state_controllers(manager, state, kind=PARTITIONING_MIG, suffix=f"-{ident}")
            replicas[ident] = {"store": store, "state": state, "manager": manager,
                               "watch": store.watch(["Node", "Pod"], name=f"check-{ident}")}

            def started(ident=ident):
                leaders.append((ident, "up", time.perf_counter()))
                replicas[ident]["manager"].start()

            def stopped(ident=ident):
                leaders.append((ident, "down", time.perf_counter()))
                replicas[ident]["manager"].stop()

            electors.append(LeaderElector(store, "nos-partitioner", ident,
                                          lease_duration_s=2.0, renew_period_s=0.1,
                                          on_started_leading=started,
                                          on_stopped_leading=stopped))
        a, b = electors
        a.start()
        if not a.wait_for_leadership(10.0):
            raise SystemExit("kube: the first elector never led")
        b.start()
        at_once = []
        watching = threading.Event()

        def watch_leaders():
            while not watching.is_set():
                at_once.append(sum(e.is_leader for e in electors))
                time.sleep(0.002)

        monitor = threading.Thread(target=watch_leaders, daemon=True)
        monitor.start()

        writer = stores[0]
        recorder = EventRecorder(writer, "kube-smoke")
        writes = []
        started_at = {}

        def timed(fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            writes.append(time.perf_counter() - t)
            return out, t

        product = product_label(nvml.name(0))
        for i in range(KUBE_NODES):
            name = f"gpu-{i:02d}"
            resources = {RESOURCE_GPU: 8, "cpu": NODE_CPU, "memory": NODE_MEMORY_GIB}
            labels = {GPU_PRODUCT_LABEL: product if i == 0 else H100_80GB,
                      PARTITIONING_LABEL: PARTITIONING_MIG, HOSTNAME_LABEL: name}
            _, started_at[("Node", name)] = timed(writer.create, Node(
                name, labels=labels, capacity=dict(resources), allocatable=dict(resources)))
        profiles = ("1g.10gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.80gb")
        for j in range(KUBE_PODS):
            timed(writer.create, Pod(f"job-{j:03d}", "smoke", scheduler_name="nos-scheduler",
                                     request={mig_resource(rng.choice(profiles)): 1}))
        bound = {}
        for j in rng.sample(range(KUBE_PODS), KUBE_BINDS):
            name, node = f"job-{j:03d}", f"gpu-{rng.randrange(KUBE_NODES):02d}"
            _, started_at[("Pod", f"smoke/{name}", node)] = timed(
                writer.patch_merge, "Pod", name, "smoke",
                lambda p, node=node: setattr(p, "node", node))
            bound[name] = node
            recorder.record(writer.get("Node", node), "Scheduled", "bound a pod")
        # the first leader steps down partway
        t_release = time.perf_counter()
        a.stop()
        if not b.wait_for_leadership(10.0):
            raise SystemExit("kube: the lease never changed hands")
        handover_ms = (time.perf_counter() - t_release) * 1e3
        names = sorted(bound)
        rng.shuffle(names)
        for name in names[:KUBE_FINISHED]:
            timed(writer.patch_merge, "Pod", name, "smoke",
                  lambda p: setattr(p, "phase", PodPhase.SUCCEEDED))
        for name in names[KUBE_FINISHED:KUBE_FINISHED + KUBE_DELETED]:
            timed(writer.delete, "Pod", name, "smoke")

        # the caches catch up with the server; the leader's state with its cache
        def server_objects():
            with server.state.lock:
                docs = [dict(o) for (p, _, _), o in server.state.objects.items()
                        if p in ("nodes", "pods", "configmaps", "events")]
            return {(d["kind"], d["metadata"].get("namespace", ""), d["metadata"]["name"]):
                    serde.from_wire(d) for d in docs}

        def cache(store, of=kinds):
            return {(k, o.namespace, o.name): o for k in of for o in store.list(k)}

        def caught_up(of):
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                want = {k: o for k, o in server_objects().items() if k[0] in of}
                if all(cache(s, of) == want for s in stores):
                    return True
                time.sleep(0.02)
            return False

        objects_caught_up = caught_up(("Node", "Pod", "Event"))
        leader = replicas["b"]
        leader["manager"].wait_idle(timeout=10.0)
        whole = ClusterState()
        by_node = leader["store"].pods_by_node()
        for node in leader["store"].list("Node", copy=False):
            whole.update_node(node, list(by_node.get(node.name, ())))
        state_equal = (leader["state"].read_view() == whole.read_view()
                       and leader["state"].bindings() == whole.bindings())
        watching.set()
        monitor.join(5)
        b.stop()  # releases: the lease's last write
        leases_caught_up = caught_up(kinds)

        def in_order(q):
            last, ok, n = {}, True, 0
            while not q.empty():
                e = q.get_nowait()
                ok &= e.object.resource_version > last.get(e.kind, 0)
                last[e.kind] = e.object.resource_version
                n += 1
            return ok, n

        orders = {ident: in_order(r["watch"]) for ident, r in replicas.items()}
        # the writes ran while a led: the lag is read off a's state (b's
        # came by its replay, after the handover)
        seen = replicas["a"]["state"].seen
        lags = [(seen[key] - t) * 1e3 for key, t in started_at.items()
                if key[0] == "Node" and key in seen]
        pod_lags = [(seen[key] - t) * 1e3 for key, t in started_at.items()
                    if key[0] == "Pod" and key in seen]
        events = writer.list("Event", namespace="default")
        fresh = new_store()
        t_sync = time.perf_counter()
        fresh.start(sync_timeout_s=30.0)
        sync_ms = (time.perf_counter() - t_sync) * 1e3
        fresh_equal = cache(fresh) == server_objects()
        fresh.stop()
        ups = [i for i, what, _ in leaders if what == "up"]
        checks = {
            "nvml_product": product == H100_80GB,
            "caches_equal_server": objects_caught_up and leases_caught_up,
            "fresh_list_watch_equals_server": fresh_equal,
            "state_equals_whole_sync": state_equal,
            "state_holds_the_live_binds": len(whole.bindings()) == KUBE_BINDS - KUBE_FINISHED
            - KUBE_DELETED,
            "every_create_reached_the_state": len(lags) == KUBE_NODES
            and len(pod_lags) == KUBE_BINDS,
            "deliveries_in_version_order": all(ok for ok, _ in orders.values()),
            "never_two_leaders": max(at_once) <= 1,
            "lease_changed_hands": ups[:2] == ["a", "b"],
            "events_deduplicated": len(events) == len(set(bound.values())),
            "event_counts_sum_to_binds": sum(e.count for e in events) == KUBE_BINDS
            and recorder.dropped == 0,
        }
        row.update({
            "nodes": KUBE_NODES, "gpus": 8 * KUBE_NODES, "pods": KUBE_PODS,
            "binds": KUBE_BINDS, "finished": KUBE_FINISHED, "deleted": KUBE_DELETED,
            "http_writes": len(writes),
            "http_write_ms": {k: v * 1e3 for k, v in percentiles(writes).items()},
            "list_watch_sync_ms": sync_ms,
            "create_to_state_ms": percentiles(lags + pod_lags),
            "node_create_to_state_ms": percentiles(lags),
            "pod_bind_to_state_ms": percentiles(pod_lags),
            "handover_ms": handover_ms, "leaders": ups,
            "deliveries": {ident: n for ident, (_, n) in orders.items()},
            "events": len(events), "event_count_max": max((e.count for e in events), default=0),
            "relists": dict(fresh.relists),
        })
    finally:
        for e in electors:
            e.stop()
        for r in replicas.values():
            r["manager"].stop()
        for store in stores:
            store.stop()
        server.stop()
    row.update(checks=checks, ok=all(checks.values()), seconds=time.time() - t0, card=card)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"kube failed: {checks}")
    return row


QUOTA_MIG_NODES = 15      # beside the card's own MIG node, 8 H100s each
QUOTA_MPS_NODES = 4
# namespace: (min, max) as shares of the fleet's GB of GPU memory
QUOTA_SHARES = {"team-a": (0.40, None), "team-b": (0.30, 0.60), "team-c": (0.30, None)}
QUOTA_FIRST_WAVE = 200    # team-a's pods, past its min
QUOTA_SECOND_WAVE = 50    # pods each of team-b and team-c, within their min
QUOTA_MAX_STEPS = 3000
QUOTA_SEED = 16


def quota_traffic(rng, namespace, n, counts, mix):
    """``n`` pods of ``namespace``, each asking for one to a few slices of
    one resource of ``mix``, seeded."""
    from nos_tpu_torch.kube.store import Pod

    return [Pod(f"{namespace}-{i:03d}", namespace, request={rng.choice(mix): rng.choice(counts)})
            for i in range(n)]


def quota_phase(card, nvml=None) -> dict:
    """Elastic quotas and fair-share preemption on a SimCluster of 20
    nodes: the card's own MIG node as NVML names it, 15 more MIG nodes and
    4 MPS nodes of 8 H100s. team-a, team-b and team-c hold ElasticQuotas
    in nos.nebuly.com/gpu-memory of 40 / 30 / 30% of the fleet's GB (max
    unset / 60% / unset). team-a submits QUOTA_FIRST_WAVE pods, past its
    min, and borrows; once the cluster is idle, team-b and team-c submit
    QUOTA_SECOND_WAVE pods each, within their min, and reclaim by
    preemption. Checked at every step: team-b within its max and the
    quotas' use within the sum of their mins; at the end: team-a's pods
    past its min labelled over-quota after the first wave, every victim
    an over-quota pod of a borrowing quota, the second wave Running (the
    row lists any pod of it that is not, with its reason) and within min
    plus its guaranteed share, and SimCluster.check()'s invariants, the
    quotas' three among them."""
    import random
    import statistics

    from nos_tpu_torch.api.v1alpha1 import (
        CAPACITY_LABEL,
        CAPACITY_OVER_QUOTA,
        RESOURCE_GPU_MEMORY,
    )
    from nos_tpu_torch.cluster import SimCluster
    from nos_tpu_torch.controllers.elasticquota import quota_accounting
    from nos_tpu_torch.gpu.node import RESOURCE_GPU, mig_resource, mps_resource
    from nos_tpu_torch.kube.store import PodPhase
    from nos_tpu_torch.scheduler.plugins.capacity import build_quota_infos
    from nos_tpu_torch.util import resources as res

    t0 = time.time()
    gb = RESOURCE_GPU_MEMORY
    cluster = SimCluster()
    if nvml is None:
        from nos_tpu_torch.device.nvml import Nvml

        with Nvml() as nv:
            cluster.add_mig_node("mig-card", nvml=nv)
    else:
        cluster.add_mig_node("mig-card", nvml=nvml)
    for i in range(QUOTA_MIG_NODES):
        cluster.add_mig_node(f"mig-{i:02d}", gpus=8)
    for i in range(QUOTA_MPS_NODES):
        cluster.add_mps_node(f"mps-{i}", gpus=8)
    gpus = sum(n.capacity[RESOURCE_GPU] for n in cluster.store.list("Node"))
    fleet_gb = gpus * res.DEFAULT_GPU_MEMORY_GB
    quotas = {}
    for ns, (min_share, max_share) in QUOTA_SHARES.items():
        quotas[ns] = ({gb: int(min_share * fleet_gb)},
                      {gb: int(max_share * fleet_gb)} if max_share else {})
        cluster.add_quota(ns, *quotas[ns])
    sum_min = sum(q[0][gb] for q in quotas.values())
    mix = ([mig_resource(p) for p in ("1g.10gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.80gb")]
           + [mps_resource(p) for p in ("10gb", "20gb")])
    rng = random.Random(QUOTA_SEED)

    # every scheduler cycle timed, by its decision
    cycle_ms = {"bind": [], "nominate": [], "fail": []}
    schedule_one = cluster.scheduler.schedule_one

    def timed_cycle(pod):
        started = time.perf_counter()
        outcome = schedule_one(pod)
        cycle_ms.setdefault(outcome.decision, []).append((time.perf_counter() - started) * 1e3)
        return outcome

    cluster.scheduler.schedule_one = timed_cycle
    watch = {"team_b_within_max": True, "use_within_sum_of_mins": True}

    def on_step():
        infos = build_quota_infos(cluster.store)
        used = {ns: infos.for_namespace(ns).used.get(gb, 0) for ns in quotas}
        watch["team_b_within_max"] &= used["team-b"] <= quotas["team-b"][1][gb]
        watch["use_within_sum_of_mins"] &= sum(used.values()) <= sum_min

    def namespace_rows():
        pods = cluster.store.list("Pod")
        unserved = cluster.unserved()
        rows = {}
        for ns in quotas:
            mine = [p for p in pods if p.namespace == ns]
            quota = cluster.store.get("ElasticQuota", "quota", ns)
            rows[ns] = {"pods": len(mine),
                        "running": sum(p.phase == PodPhase.RUNNING for p in mine),
                        "unserved": sum(p.namespaced_name in unserved for p in mine),
                        "over_quota": sum(p.labels.get(CAPACITY_LABEL) == CAPACITY_OVER_QUOTA
                                          for p in mine),
                        "used_gb": quota.used.get(gb, 0), "min_gb": quota.min[gb],
                        "max_gb": quota.max.get(gb)}
        return rows

    checks = {}
    for pod in quota_traffic(rng, "team-a", QUOTA_FIRST_WAVE, (1, 2, 4), mix):
        cluster.store.create(pod)
    t1 = time.perf_counter()
    idle_1 = cluster.run_until_idle(QUOTA_MAX_STEPS, on_step)
    wall_1, steps_1 = time.perf_counter() - t1, cluster.steps
    first = namespace_rows()
    team_a = [p for p in cluster.store.list("Pod")
              if p.namespace == "team-a" and p.phase == PodPhase.RUNNING]
    _, want_labels = quota_accounting(team_a, quotas["team-a"][0])
    checks["first_wave_idle"] = idle_1
    checks["team_a_borrows"] = first["team-a"]["used_gb"] > first["team-a"]["min_gb"]
    checks["team_a_past_min_labelled_over_quota"] = (
        first["team-a"]["over_quota"] > 0
        and all(p.labels.get(CAPACITY_LABEL) == want_labels[p.namespaced_name] for p in team_a))
    checks["first_wave_invariants"] = all(cluster.check().values())

    second = (quota_traffic(rng, "team-b", QUOTA_SECOND_WAVE, (1, 2), mix)
              + quota_traffic(rng, "team-c", QUOTA_SECOND_WAVE, (1, 2), mix))
    for pod in second:
        cluster.store.create(pod)
    t2 = time.perf_counter()
    idle_2 = cluster.run_until_idle(QUOTA_MAX_STEPS, on_step)
    wall_2 = time.perf_counter() - t2
    rows = namespace_rows()
    final = cluster.check()
    records = list(cluster.scheduler.preemptions)
    infos = build_quota_infos(cluster.store)
    unserved = cluster.unserved()
    pods = {p.namespaced_name: p for p in cluster.store.list("Pod")}
    checks["second_wave_idle"] = idle_2
    checks.update(watch)
    checks["preemptions_happened"] = bool(records)
    checks["victims_over_quota_of_a_borrower"] = all(
        v["capacity"] == CAPACITY_OVER_QUOTA and v["quota"] == "eq/team-a/quota"
        for r in records for v in r["victims"])
    checks["second_wave_running_or_unserved"] = all(
        p.namespaced_name not in pods or pods[p.namespaced_name].phase == PodPhase.RUNNING
        or bool(unserved.get(p.namespaced_name)) for p in second)
    # each pod not running, with its reason: within their min, none should be
    second_unserved = {p.namespaced_name: unserved.get(p.namespaced_name, "")
                       for p in second if p.namespaced_name in pods
                       and pods[p.namespaced_name].phase != PodPhase.RUNNING}
    checks["second_wave_all_running"] = not second_unserved
    checks["second_wave_within_entitlement"] = all(
        rows[ns]["used_gb"] <= rows[ns]["min_gb"]
        + infos.guaranteed_overquota(infos.for_namespace(ns).name, gb)
        for ns in ("team-b", "team-c"))
    checks.update({f"cluster_{k}": v for k, v in final.items()})
    victims = {}
    for r in records:
        for v in r["victims"]:
            ns = v["pod"].split("/")[0]
            victims[ns] = victims.get(ns, 0) + 1

    def quantiles(values):
        if len(values) < 2:
            return {"n": len(values), "p50_ms": values[0] if values else None,
                    "p95_ms": values[0] if values else None}
        return {"n": len(values), "p50_ms": statistics.median(values),
                "p95_ms": statistics.quantiles(values, n=20)[-1]}

    row = {"phase": "quota", "host_cpus": os.cpu_count(),
           "cluster": {"nodes": len(cluster.store.list("Node")), "gpus": gpus,
                       "fleet_gb": fleet_gb, "pods": QUOTA_FIRST_WAVE + 2 * QUOTA_SECOND_WAVE},
           "after_first_wave": first, "after_second_wave": rows,
           "preemptions": {"cycles": len(records),
                           "victims": sum(victims.values()), "victims_by_namespace": victims,
                           "preemptors_by_namespace": {
                               ns: sum(r["pod"].startswith(ns + "/") for r in records)
                               for ns in quotas}},
           "cycles": {k: quantiles(v) for k, v in cycle_ms.items()},
           "loop": {"steps": cluster.steps, "steps_first_wave": steps_1,
                    "wall_s_first_wave": wall_1, "wall_s_second_wave": wall_2,
                    "admission_rejects": cluster.kubelet.admission_rejects,
                    "plans": {c.kind: c.plans_processed for c in cluster.controllers}},
           "unserved_reasons": sorted({r.split(" (")[0] for r in unserved.values()}),
           "second_wave_unserved": second_unserved}
    row.update(checks=checks, ok=all(checks.values()), seconds=time.time() - t0, card=card)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"quota failed: {checks}")
    return row


GANG_POOLS = 4            # node pools of GANG_POOL_NODES MIG nodes, 8 H100s each
GANG_POOL_NODES = 8
GANG_MPS_NODES = 4
GANG_JOBS = 300           # single-pod slice jobs of the quota mix
GANG_REPLICAS = 16        # the serving Deployment
GANG_ZONE_REPLICAS = 10   # spread over the MPS nodes' zones: more replicas than zones
# (namespace, name, GPUs) of the multi-node jobs that fit a pool, in their
# arrival order: fault F6's (after job-24 and job-32 one free node is left
# in their pool, and job-16 must go elsewhere whole); "lender" borrows
# past its quota
GANG_ORDER = (("train", "job-24", 24), ("train", "job-32", 32), ("train", "job-16", 16),
              ("borrow", "lender", 16))
GANG_TOO_BIG = 80         # GPUs no pool holds
GANG_DRAIN = 8            # 7g.80gb instances of the single-node job needing a drain
GANG_TIMEOUT_S = 2.0      # the Permit wait, on the cluster's virtual clock
GANG_TIMEOUT_ROUNDS = 2   # the 80-GPU job's timeouts watched before it is cancelled
GANG_MAX_STEPS = 2000
GANG_SEED = 17


def gang_phase(card, nvml=None) -> dict:
    """Gangs, multi-node expansion, the drain reservation, the topology
    score and the affinity and spread filters on a SimCluster of 37
    nodes: the card's own MIG node as NVML names it, in a pool of its
    own; 32 MIG nodes of 8 H100s in 4 pools of 8; 4 MPS nodes of 8.
    Seeded traffic, in waves: an F3 input built on purpose (the only free
    20 GB slices on two MPS nodes, one with memory never carved, and a
    pod asking for 2 x gpu-20gb); multi-node jobs of 24, 32 and 16 GPUs
    in that order, fault F6's input (3 members for 24, the H100 rule;
    job-16 must form in another pool than the first two), a namespace
    borrowing past its quota with a 16-GPU gang, and a serving Deployment of 16 replicas
    spread by hostname (maxSkew 1) with required anti-affinity on its own
    label (with 37 hostnames the anti-affinity alone keeps that skew
    within 1), and GANG_ZONE_REPLICAS replicas spread by zone (maxSkew 1)
    over the four MPS nodes, one zone each, where the spread filter is
    what decides; an 80-GPU job no pool holds, watched through its
    timeouts, then cancelled; GANG_JOBS single-pod slice jobs; the quota within its
    min reclaiming the borrowed GPUs; a single-node job of 8 x 7g.80gb
    that waits past min_wait, gets a drain, and binds once the reserved
    node's jobs finish. Checked at every step: SimCluster.check_gangs()
    (gangs whole, in one pool, their ranks and coordinator, at most one
    drain, no stale reservation), no member of the 80-GPU job bound, its
    waiting members in one pool, the replicas' spread and anti-affinity,
    and the zone skew; at the end, the F3 pod Running, the reclaimed gang
    evicted whole, the drain's holder bound and its reservation released,
    and SimCluster.check()."""
    import random
    import statistics

    from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
    from nos_tpu_torch.cluster import HOSTNAME_LABEL, SimCluster
    from nos_tpu_torch.controllers.partitioner.multinode import ROLE_LEADER, MULTINODE_ROLE_LABEL
    from nos_tpu_torch.gpu.node import RESOURCE_GPU, mig_resource, mps_resource
    from nos_tpu_torch.kube.store import (
        Pod,
        PodAffinityTerm,
        PodPhase,
        TopologySpreadConstraint,
    )
    from nos_tpu_torch.scheduler.plugins.gang import GANG_NAME_LABEL
    from nos_tpu_torch.scheduler.plugins.reservation import RESERVED_FOR
    from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL

    ZONE_LABEL = "topology.kubernetes.io/zone"
    t0 = time.time()
    gb = RESOURCE_GPU_MEMORY
    whole = mig_resource("7g.80gb")
    cluster = SimCluster(gang_timeout_seconds=GANG_TIMEOUT_S)
    if nvml is None:
        from nos_tpu_torch.device.nvml import Nvml

        with Nvml() as nv:
            cluster.add_mig_node("mig-card", nvml=nv, pool="pool-card")
    else:
        cluster.add_mig_node("mig-card", nvml=nvml, pool="pool-card")
    for p in range(GANG_POOLS):
        for i in range(GANG_POOL_NODES):
            cluster.add_mig_node(f"mig-{p}-{i}", gpus=8, pool=f"pool-{p}")
    for i in range(GANG_MPS_NODES):
        cluster.add_mps_node(f"mps-{i}", gpus=8)
    nodes = {n.name: n for n in cluster.store.list("Node")}
    gpus = sum(n.capacity[RESOURCE_GPU] for n in nodes.values())
    pool_of = {name: n.labels.get(NODEPOOL_LABEL, "") for name, n in nodes.items()}
    mix = ([mig_resource(p) for p in ("1g.10gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.80gb")]
           + [mps_resource(p) for p in ("10gb", "20gb")])
    rng = random.Random(GANG_SEED)

    cycle_ms = {"bind": [], "wait": [], "nominate": [], "fail": []}
    schedule_one = cluster.scheduler.schedule_one

    def timed_cycle(pod):
        started = time.perf_counter()
        outcome = schedule_one(pod)
        cycle_ms[outcome.decision].append((time.perf_counter() - started) * 1e3)
        return outcome

    cluster.scheduler.schedule_one = timed_cycle

    def members(ns, gang):
        return [p for p in cluster.store.list("Pod", namespace=ns, copy=False)
                if p.labels.get(GANG_NAME_LABEL) == gang]

    watch = {"gang_invariants": True, "too_big_never_binds": True,
             "too_big_waits_in_one_pool": True, "replicas_spread": True,
             "replicas_anti_affine": True, "zoned_spread": True}
    too_big = {"timeouts": 0, "waiting_max": 0, "marked_each_time": True}
    zone_of, zoned_counts = {}, {}
    broken = []

    def on_step():
        gang_checks = cluster.check_gangs()
        if not all(gang_checks.values()):
            watch["gang_invariants"] = False
            broken.append({"step": cluster.steps, **gang_checks})
        big = members("train", "too-big")
        watch["too_big_never_binds"] &= not any(p.node for p in big)
        waiting = {k: n for k, n in cluster.scheduler.assumed().items()
                   if k.startswith("train/too-big")}
        watch["too_big_waits_in_one_pool"] &= len({pool_of[n] for n in waiting.values()}) <= 1
        too_big["waiting_max"] = max(too_big["waiting_max"], len(waiting))
        timeouts = cluster.scheduler.gang_timeouts.get("train/too-big", 0)
        if timeouts > too_big["timeouts"]:
            # a timeout unreserves every member and marks it unschedulable
            # (the members re-wait in the same step, keeping the mark)
            too_big["timeouts"] = timeouts
            too_big["marked_each_time"] &= all(p.unschedulable for p in big)
        replicas = [p for p in cluster.store.list("Pod", namespace="serve", copy=False)
                    if p.node and p.phase in (PodPhase.PENDING, PodPhase.RUNNING)]
        per_node = {}
        for p in replicas:
            per_node[p.node] = per_node.get(p.node, 0) + 1
        counts = [per_node.get(name, 0) for name, n in nodes.items() if HOSTNAME_LABEL in n.labels]
        watch["replicas_spread"] &= max(counts) - min(counts) <= 1
        watch["replicas_anti_affine"] &= max(counts) <= 1
        if zone_of:
            per_zone = dict.fromkeys(zone_of.values(), 0)
            for p in cluster.store.list("Pod", namespace="zoned", copy=False):
                if p.node and p.phase in (PodPhase.PENDING, PodPhase.RUNNING):
                    per_zone[zone_of[p.node]] += 1
            zoned_counts.update(per_zone)
            watch["zoned_spread"] &= max(per_zone.values()) - min(per_zone.values()) <= 1

    def run(label, max_steps=GANG_MAX_STEPS):
        started = cluster.steps
        t = time.perf_counter()
        idle = cluster.run_until_idle(max_steps, on_step)
        steps[label] = {"steps": cluster.steps - started, "idle": idle,
                        "wall_s": time.perf_counter() - t}
        return idle

    def create(pod):
        return cluster.store.create(pod)

    steps, checks = {}, {}

    # --- F3, built on purpose: a free 20 GB slice on mps-0 and on mps-1
    # (one each, the rest of their memory never carved), then a pod asking
    # for two
    for name in ("mps-0", "mps-1"):  # one at a time: one slice carved each
        create(Pod(f"pin-{name}", "f3", request={mps_resource("20gb"): 1},
                   node_selector={HOSTNAME_LABEL: name}))
        run(f"f3_pin_{name}")
    for name in ("mps-0", "mps-1"):
        cluster.store.delete("Pod", f"pin-{name}", "f3")
    run("f3_pins_gone")
    free_20 = {}
    for node in cluster.store.list("Node"):
        if node.name.startswith("mps-"):
            from nos_tpu_torch.gpu import annotations as annot

            _, status = annot.parse_node_annotations(node.annotations)
            free = sum(s.quantity for s in status
                       if s.profile == "20gb" and s.status == annot.STATUS_FREE)
            if free:
                free_20[node.name] = free
    create(Pod("f3-pod", "f3", request={mps_resource("20gb"): 2}))
    run("f3")
    f3 = cluster.store.get("Pod", "f3-pod", "f3")
    checks["f3_input_split"] = free_20 == {"mps-0": 1, "mps-1": 1}
    checks["f3_pod_runs"] = f3.phase == PodPhase.RUNNING

    # --- the serving Deployment and the zone-spread replicas, then the
    # gangs that fit a pool and the borrowing gang, one at a time, in
    # fault F6's order (ROADMAP, closed faults): 24 + 32 GPUs leave one
    # free node in pool-3. A gang's first member takes the best-scored
    # node, ties to the highest name, among the pools that can hold the
    # whole gang now, and pins the rest there, so job-16 goes to pool-2
    # whole (before the repair its first member took pool-3's last node
    # and the gang never formed, as it never does in the reference)
    fleet_gb = gpus * 80
    cluster.add_quota("borrow", {gb: 0})
    cluster.add_quota("claim", {gb: 16 * 80}, max={gb: 16 * 80})
    anti = PodAffinityTerm(topology_key=HOSTNAME_LABEL, match_labels={"app": "serve"})
    spread = TopologySpreadConstraint(topology_key=HOSTNAME_LABEL, max_skew=1,
                                      match_labels={"app": "serve"})
    for i in range(GANG_REPLICAS):
        create(Pod(f"serve-{i:02d}", "serve", request={mig_resource("1g.10gb"): 1},
                   labels={"app": "serve"}, pod_anti_affinity=[anti],
                   topology_spread_constraints=[spread]))
    for i, name in enumerate(n for n in nodes if n.startswith("mps-")):
        zone_of[name] = f"zone-{i}"
        cluster.store.patch_merge("Node", name, "", lambda n: n.labels.update(
            {ZONE_LABEL: zone_of[n.name]}))
    by_zone = TopologySpreadConstraint(topology_key=ZONE_LABEL, max_skew=1,
                                       match_labels={"app": "zoned"})
    for i in range(GANG_ZONE_REPLICAS):
        create(Pod(f"zoned-{i:02d}", "zoned", request={mps_resource("10gb"): 1},
                   labels={"app": "zoned"}, topology_spread_constraints=[by_zone]))
    run("replicas")
    for ns, name, n in GANG_ORDER:
        create(Pod(name, ns, request={RESOURCE_GPU: n}))
        run(f"gang_{name}")
    gang_rows = {}
    for ns, name, _ in GANG_ORDER:
        ms = members(ns, name)
        gang_rows[name] = {"members": len(ms),
                           "bound": sum(p.phase == PodPhase.RUNNING for p in ms),
                           "pools": sorted({pool_of[p.node] for p in ms if p.node}),
                           "nodes": sorted(p.node for p in ms if p.node)}
    checks["gangs_formed"] = all(r["bound"] == r["members"] > 0 for r in gang_rows.values())
    checks["gang_24_has_3_members"] = gang_rows["job-24"]["members"] == 3
    replicas = [p for p in cluster.store.list("Pod", namespace="serve")]
    checks["replicas_running"] = all(p.phase == PodPhase.RUNNING for p in replicas)
    zoned = cluster.store.list("Pod", namespace="zoned")
    checks["zoned_replicas_running"] = (len(zoned) == GANG_ZONE_REPLICAS and all(
        p.phase == PodPhase.RUNNING for p in zoned))

    # --- the 80-GPU job: carved for by the planner's trial across pools,
    # pinned to one pool by its waiting members, timed out as a unit
    def whole_gpus():
        return sum(1 for n in cluster.agents for g in cluster.pool.geometry(n).values()
                   if g == {"7g.80gb": 1})

    # the fleet's GPUs start as whole 7g.80gb instances and the gangs
    # before it leave most of them so: the trial needs no carve, whatever
    # pools it places the members across
    whole_before = whole_gpus()
    create(Pod("too-big", "train", request={RESOURCE_GPU: GANG_TOO_BIG}))
    started = cluster.steps
    while too_big["timeouts"] < GANG_TIMEOUT_ROUNDS and cluster.steps - started < GANG_MAX_STEPS:
        cluster.step()
        on_step()
    steps["too_big"] = {"steps": cluster.steps - started}
    big = members("train", "too-big")
    carved = whole_gpus() - whole_before
    too_big_row = {"members": len(big), "timeouts": too_big["timeouts"],
                   "waiting_max": too_big["waiting_max"], "whole_gpus_before": whole_before,
                   "whole_gpus_carved": carved,
                   "unserved": sorted({cluster.unserved().get(p.namespaced_name, "")
                                       for p in big})}
    checks["too_big_timed_out_as_a_unit"] = (too_big["timeouts"] >= GANG_TIMEOUT_ROUNDS
                                             and too_big["marked_each_time"])
    cluster.store.delete("Pod", "too-big", "train")  # cancelled; its workers follow
    run("too_big_cancelled")
    checks["too_big_workers_collected"] = members("train", "too-big") == []

    # --- the single-pod jobs fill the fleet
    for i in range(GANG_JOBS):
        create(Pod(f"job-{i:03d}", "jobs", request={rng.choice(mix): rng.choice((1, 2, 4))}))
    run("jobs")

    # --- the quota within its min reclaims the borrowed GPUs
    lender = {p.namespaced_name for p in members("borrow", "lender")}
    for i in range(2):
        create(Pod(f"claim-{i}", "claim", request={whole: 8}))
    run("reclaim")
    victims = [v["pod"] for r in cluster.scheduler.preemptions for v in r["victims"]]
    claims = cluster.store.list("Pod", namespace="claim")
    checks["reclaimed_gang_evicted_whole"] = (
        lender <= set(victims) and members("borrow", "lender") == [])
    checks["claims_run"] = all(p.phase == PodPhase.RUNNING for p in claims)

    # --- a whole-node job on a full fleet: it waits past min_wait, gets a
    # drain, and binds once the reserved node's jobs finish
    created = create(Pod("drain", "jobs", request={whole: GANG_DRAIN})).created
    run("drain_waits")
    held = [n.name for n in cluster.store.list("Node")
            if n.annotations.get(RESERVED_FOR) == "jobs/drain"]
    checks["drain_not_before_min_wait"] = held == []
    # the cluster idles through min_wait on its virtual clock
    cluster.now += cluster.scheduler.reservation.min_wait
    reserved, waited = None, None
    for _ in range(10):
        cluster.step()
        on_step()
        held = [n.name for n in cluster.store.list("Node")
                if n.annotations.get(RESERVED_FOR) == "jobs/drain"]
        if held:
            reserved, waited = held[0], cluster.now - created
            break
    checks["drain_reserved"] = reserved is not None
    finished = 0
    if reserved is not None:
        for p in cluster.store.list("Pod"):
            if p.node == reserved and p.phase == PodPhase.RUNNING:
                cluster.store.patch_merge("Pod", p.name, p.namespace,
                                          lambda q: setattr(q, "phase", PodPhase.SUCCEEDED))
                finished += 1
    run("drain")
    holder = cluster.store.get("Pod", "drain", "jobs")
    checks["drain_holder_binds"] = holder.phase == PodPhase.RUNNING and holder.node == reserved
    checks["drain_released"] = not any(n.annotations.get(RESERVED_FOR) == "jobs/drain"
                                       for n in cluster.store.list("Node"))
    checks.update(watch)
    final = cluster.check()
    checks.update({f"cluster_{k}": v for k, v in final.items()})

    def quantiles(values):
        if len(values) < 2:
            return {"n": len(values), "p50_ms": values[0] if values else None,
                    "p95_ms": values[0] if values else None}
        return {"n": len(values), "p50_ms": statistics.median(values),
                "p95_ms": statistics.quantiles(values, n=20)[-1]}

    pods = cluster.store.list("Pod")
    unserved = cluster.unserved()
    row = {"phase": "gang", "host_cpus": os.cpu_count(),
           "cluster": {"nodes": len(nodes), "gpus": gpus, "fleet_gb": fleet_gb,
                       "pools": GANG_POOLS + 1, "pods": len(pods)},
           "f3": {"free_20gb_before": free_20, "node": f3.node, "phase": f3.phase},
           "gangs": gang_rows, "zoned_per_zone": zoned_counts, "too_big": too_big_row,
           "reclaim": {"victims": sorted(victims), "claims_on": sorted(p.node for p in claims)},
           "drain": {"node": reserved, "waited_s": waited, "jobs_finished": finished,
                     "holder_node": holder.node,
                     "reservations_made": cluster.scheduler.reservation.reservations_made,
                     "held_after": {n.name: n.annotations[RESERVED_FOR]
                                    for n in cluster.store.list("Node")
                                    if RESERVED_FOR in n.annotations}},
           "running": sum(p.phase == PodPhase.RUNNING for p in pods),
           "unserved": len(unserved),
           "cycles": {k: quantiles(v) for k, v in cycle_ms.items()},
           "steps": {"total": cluster.steps, **steps},
           "admission_rejects": cluster.kubelet.admission_rejects,
           "plans": {c.kind: c.plans_processed for c in cluster.controllers},
           "broken": broken[:3]}
    row.update(checks=checks, ok=all(checks.values()), seconds=time.time() - t0, card=card)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"gang failed: {checks}")
    return row


def control_bench_phase(card) -> dict:
    """bench.py's control-plane half at ControlPlaneSizes.quick(), every
    step watched by SimCluster.check_gangs(); the run fails unless the
    borrow converges, the fair share is restored, the multi-node gang
    forms, every churn turn converges, the fill fills and every
    invariant holds after each phase."""
    from nos_tpu_torch.bench_control_plane import ControlPlaneSizes, run_control_plane_bench

    t0 = time.time()
    watch = {"gang_invariants_every_step": True}
    broken = []

    def on_step(cluster):
        gang_checks = cluster.check_gangs()
        if not all(gang_checks.values()):
            watch["gang_invariants_every_step"] = False
            broken.append({"step": cluster.steps, **gang_checks})

    result = run_control_plane_bench(ControlPlaneSizes.quick(), on_step=on_step)
    checks = {"borrow_converged": result["borrow_converged"],
              "fair_share_restored": result["fair_share_restored"],
              "multihost_gang_formed": result["multihost_gang_formed"],
              "fill_converged": result["fill_converged"],
              "churn_converged": all(t["converged"] for t in result["churn_turns"]),
              "invariants_after_each_phase": result["invariants_hold"], **watch}
    row = {"phase": "control_bench", "host_cpus": os.cpu_count(), **result,
           "broken": broken[:3]}
    row.update(checks=checks, ok=all(checks.values()),
               seconds=time.time() - t0, card=card)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"control_bench failed: {checks}")
    return row


POOLS_POOLS = 4            # MIG node pools of POOLS_POOL_NODES nodes, 8 H100s each
POOLS_POOL_NODES = 8
POOLS_MPS_NODES = 4        # 8 H100s each, in the fifth pool with the card's own node
POOLS_JOBS = 300           # single-pod jobs of the quota mix, pinned round-robin
POOLS_COUNTS = (1, 2, 4)   # slices a job asks for: more than the fleet holds, so pods wait
POOLS_GANG = 16            # GPUs of the gang inside one pool
POOLS_SHARES = {"team-a": 0.4, "team-b": 0.3, "team-c": 0.3}  # quota min = max, of the fleet
POOLS_MAX_STEPS = 1500
POOLS_SEED = 19
POOLS_KILLED = "pool-1"    # the pool whose worker the process run kills after its first plan


def pools_world(card_nvml, **sharding):
    """The pools phase's SimCluster: 4 pools of 8 MIG nodes, a fifth of
    4 MPS nodes and the card's own MIG node, three quotas with min = max."""
    from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
    from nos_tpu_torch.cluster import SimCluster
    from nos_tpu_torch.gpu.node import RESOURCE_GPU
    from nos_tpu_torch.util import resources as res

    cluster = SimCluster(gang_timeout_seconds=GANG_TIMEOUT_S, **sharding)
    last = f"pool-{POOLS_POOLS}"
    cluster.add_mig_node("mig-card", nvml=card_nvml, pool=last)
    for p in range(POOLS_POOLS):
        for i in range(POOLS_POOL_NODES):
            cluster.add_mig_node(f"mig-{p}-{i}", gpus=8, pool=f"pool-{p}")
    for i in range(POOLS_MPS_NODES):
        cluster.add_mps_node(f"mps-{i}", gpus=8, pool=last)
    gpus = sum(n.capacity[RESOURCE_GPU] for n in cluster.store.list("Node"))
    fleet_gb = gpus * res.DEFAULT_GPU_MEMORY_GB
    for ns, share in POOLS_SHARES.items():
        bound = {RESOURCE_GPU_MEMORY: int(share * fleet_gb)}
        cluster.add_quota(ns, bound, max=dict(bound))
    return cluster, gpus


def pools_wave1(cluster) -> None:
    """POOLS_JOBS jobs of the quota mix, seeded, each pinned by its node
    selector: MIG jobs round-robin over the MIG pools, MPS jobs to the
    fifth pool; and one POOLS_GANG-GPU job pinned to pool-2."""
    import random

    from nos_tpu_torch.gpu.node import RESOURCE_GPU, mig_resource, mps_resource
    from nos_tpu_torch.kube.store import Pod
    from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL

    rng = random.Random(POOLS_SEED)
    mix = ([mig_resource(p) for p in ("1g.10gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.80gb")]
           + [mps_resource(p) for p in ("10gb", "20gb")])
    mig_jobs = 0
    for i in range(POOLS_JOBS):
        resource = rng.choice(mix)
        if resource.startswith("nvidia.com/mig-"):
            pool, mig_jobs = f"pool-{mig_jobs % POOLS_POOLS}", mig_jobs + 1
        else:
            pool = f"pool-{POOLS_POOLS}"
        cluster.store.create(Pod(f"job-{i:03d}", rng.choice(sorted(POOLS_SHARES)),
                                 request={resource: rng.choice(POOLS_COUNTS)},
                                 node_selector={NODEPOOL_LABEL: pool}))
    cluster.store.create(Pod("gang-16", "team-a", request={RESOURCE_GPU: POOLS_GANG},
                             node_selector={NODEPOOL_LABEL: "pool-2"}))


def pools_outcome(cluster) -> tuple:
    """What two runs must agree on: each pod's node and phase, each MIG
    node's spec geometry and the MPS plugin's config maps, and each
    pending pod's reason."""
    from nos_tpu_torch.gpu import annotations as annot

    pods = {p.namespaced_name: (p.node, p.phase) for p in cluster.store.list("Pod", copy=False)}
    geometry = {n.name: sorted((k, v) for k, v in n.annotations.items()
                               if k.startswith(annot.PREFIX + "spec-gpu-"))
                for n in cluster.store.list("Node", copy=False)}
    geometry.update({f"configmap/{c.name}": sorted(c.data.items())
                     for c in cluster.store.list("ConfigMap", copy=False)})
    pending = {k for k, (node, phase) in pods.items() if not node and phase == "Pending"}
    return pods, geometry, {k: v for k, v in cluster.unserved().items() if k in pending}


def pools_run(card_nvml, backend: str, on_plan=None, **sharding) -> dict:
    """Wave 1 on a fresh world: every step held to check_gangs(); every
    sharded plan asked whether the draw decomposes, and held against
    fresh unsharded planners on the same base and ages. ``pool_equal``:
    for each pool whose pods' draw decomposes, whether an unsharded plan
    of the whole cluster for that pool's pending pods alone gives the
    pool's nodes the sharded plan's partitioning and leaves every other
    node as it is, with the nodes the pool's plan carved. ``unsharded_equal``:
    at each plan whose whole draw decomposes, whether the unsharded plan
    of every pending pod equals the merged plan (the reference's claim,
    which F7 breaks: reported, not held). The run's cluster, outcome,
    steps and wall seconds."""
    from nos_tpu_torch.partitioning.core import Planner
    from nos_tpu_torch.partitioning.core import pools as pool_plans
    from nos_tpu_torch.partitioning.core.partition_state import partitioning_state_to_dict
    from nos_tpu_torch.partitioning.core.planner import sort_candidate_pods

    t0 = time.time()
    cluster, gpus = pools_world(card_nvml, pool_sharding=backend != "unsharded",
                                pool_backend=backend if backend != "unsharded" else "",
                                **sharding)
    decomposes, unsharded_equal, pool_equal = [], [], []
    for controller in cluster.controllers:
        plan_sharded = controller._plan_sharded

        def traced(pending, shard, controller=controller, plan_sharded=plan_sharded):
            out = plan_sharded(pending, shard)
            now = cluster.clock()
            ages = dict(controller.last_pending_ages)
            since = {k: now - age for k, age in ages.items()}
            order = sort_candidate_pods(pending, pending_since=since, now=now)
            decomposes.append(pool_plans.draw_decomposes(shard[0], shard[2], order))
            base, partition = shard[0], shard[2]
            current, merged = (partitioning_state_to_dict(state) for state in out[:2])

            def unsharded(pods):
                # a full plan on a fork of the base, which it leaves as it was
                return partitioning_state_to_dict(Planner(
                    controller.planner.framework, clock=cluster.clock).plan(
                        base, pods, pending_ages=ages, dirty=set(base.get_nodes())))

            if decomposes[-1]:
                unsharded_equal.append(unsharded(pending) == merged)
            for pool, pods in sorted(pool_plans.split_pending(pending, partition).items()):
                if not pods or not pool_plans.draw_decomposes(
                        base, partition, sort_candidate_pods(pods, pending_since=since, now=now)):
                    continue
                alone = unsharded(pods)
                mine = {n for n, p in partition.node_pool.items() if p == pool}
                pool_equal.append((
                    all(alone[n] == (merged if n in mine else current)[n] for n in alone),
                    sum(merged[n] != current[n] for n in mine)))
            return out

        controller._plan_sharded = traced
    gang_ok = []

    def on_step():
        gang_ok.append(all(cluster.check_gangs().values()))
        if on_plan is not None:
            on_plan(cluster)

    pools_wave1(cluster)
    idle = cluster.run_until_idle(POOLS_MAX_STEPS, on_step=on_step)
    return {"cluster": cluster, "gpus": gpus, "idle": idle, "outcome": pools_outcome(cluster),
            "decomposes": list(decomposes), "unsharded_equal": list(unsharded_equal),
            "pool_equal": list(pool_equal),
            "gangs_every_step": all(gang_ok),
            "steps": cluster.steps, "seconds": time.time() - t0}


def pools_phase(card, nvml=None) -> dict:
    """Pool-sharded planning on a SimCluster of 289 H100s: 4 pools of 8
    MIG nodes of 8, a fifth pool of 4 MPS nodes of 8 and the card's own
    MIG node, three quotas with min = max (none couples pools). Wave 1
    (POOLS_JOBS jobs of the quota mix pinned round-robin by node selector,
    a 16-GPU gang pinned to one pool) runs three times from one seed:
    unsharded, sharded on the serial backend (with a warm-state file), and
    sharded on the process backend, whose worker of POOLS_KILLED is killed
    after its first plan. Wave 2, on the serial run: one pod with no
    selector merges every pool into one. Wave 3: a fresh controller on
    the same store restarts from the warm-state file, beside a cold one.
    Fails unless the serial and process runs end with the same
    placements, geometries and unserved reasons; at every sharded plan,
    each pool whose pods' draw decomposes plans what an unsharded planner
    plans for that pool's pods alone on the same base (at least one such
    pool plan of each run carved nodes; the whole plan against the
    unsharded plan of every pod is reported, F7);
    check_gangs() holds at every step and check() at the end of each run;
    the process run planned every pool on its workers at every plan but
    the one after the kill (escalated in the parent), and the plan after
    that on a respawned worker; wave 2 merged the pools; the restart
    adopted (adopted or partial) and its first plan equals the cold
    one's."""
    import shutil
    import signal
    import statistics
    import tempfile

    from nos_tpu_torch.controllers.partitioner import PartitionerController
    from nos_tpu_torch.gpu.node import PARTITIONING_MIG
    from nos_tpu_torch.kube.store import Pod
    from nos_tpu_torch.partitioning.core import ClusterState, Planner
    from nos_tpu_torch.partitioning.core.codec import is_mig_resource
    from nos_tpu_torch.partitioning.core.partition_state import partitioning_state_to_dict
    from nos_tpu_torch.partitioning.mig import MigSnapshotTaker
    from nos_tpu_torch.controllers.partitioner import build_sim_framework

    if nvml is None:
        from nos_tpu_torch.device.nvml import Nvml

        with Nvml() as nv:
            return pools_phase(card, nvml=nv)
    from nos_tpu_torch.partitioning.core.procpool import start_fork_server

    t0 = time.time()
    # the fork server imports the package (torch with it, seconds) while
    # the unsharded and serial runs plan
    start_fork_server()
    warm_dir = tempfile.mkdtemp(prefix="nos-warm-")
    runs = {}
    killed = []
    try:
        runs["unsharded"] = pools_run(nvml, "unsharded")
        runs["serial"] = pools_run(nvml, "serial", warm_state_path=warm_dir,
                                   warm_state_save_interval_seconds=0.0)

        def kill_after_first_plan(cluster):
            workers = cluster.mig._worker_pool
            if cluster.mig.plans_processed == 1 and not killed and workers is not None:
                pid = workers.pids()[POOLS_KILLED]
                os.kill(pid, signal.SIGKILL)
                killed.append(pid)

        runs["process"] = pools_run(nvml, "process", on_plan=kill_after_first_plan,
                                    pool_cycle_timeout_seconds=60.0)
        process = runs["process"]["cluster"]
        workers = process.mig._worker_pool
        ready = list(workers.ready) + list(process.mps._worker_pool.ready
                                           if process.mps._worker_pool else [])
        process.close()

        # wave 2: one pod with no selector merges every pool
        serial = runs["serial"]["cluster"]
        serial.store.create(Pod("unpinned", "team-b", request={"nvidia.com/mig-7g.80gb": 1}))
        plans_before = serial.mig.plans_processed
        wave2_idle = serial.run_until_idle(POOLS_MAX_STEPS)
        merged = [r for r in list(serial.mig.plans)[-(serial.mig.plans_processed
                                                      - plans_before):]
                  if len(r.get("pools", ())) == 1] if serial.mig.plans_processed > plans_before \
            else []
        partition = serial.mig.last_partition
        wave2 = {"idle": wave2_idle, "plans": serial.mig.plans_processed - plans_before,
                 "merged_plans": len(merged),
                 "merged_from": dict(partition.merged_from) if merged else {}}

        # wave 3: a restart from the warm-state file, beside a cold start
        class Recording:
            def __init__(self):
                self.plans = []

            def apply(self, current, plan):
                self.plans.append(plan)
                return 0

        def restarted(path):
            actuator = Recording()
            controller = PartitionerController(
                serial.store, ClusterState(), MigSnapshotTaker(),
                Planner(build_sim_framework(serial.store), clock=serial.clock), actuator,
                PARTITIONING_MIG, is_mig_resource, clock=serial.clock, pool_sharding=True,
                warm_state_path=path)
            controller.sync()
            t = time.perf_counter()
            controller.process_pending_pods()
            return controller, actuator.plans, (time.perf_counter() - t) * 1e3

        # cold first: the first restart in a process pays one-time costs
        cold, cold_plans, cold_ms = restarted("")
        warm, warm_plans, warm_ms = restarted(os.path.join(warm_dir, "warm-state-mig.json"))
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)
    same_first_plan = bool(warm_plans) and bool(cold_plans) and (
        partitioning_state_to_dict(warm_plans[0].desired_state)
        == partitioning_state_to_dict(cold_plans[0].desired_state)
        and warm.last_unserved == cold.last_unserved)

    def records(run):
        return [r for c in run["cluster"].controllers for r in c.plans if "pools" in r]

    process_backends = [r["backends"] for r in runs["process"]["cluster"].mig.plans]
    escalated_at = [i for i, b in enumerate(process_backends) if "escalated" in b.values()]
    pool_ms = [ms for run in ("serial", "process") for r in records(runs[run])
               for ms in r["pool_ms"].values()]
    merge_ms = [r["merge_ms"] for run in ("serial", "process") for r in records(runs[run])]
    frames = [r["frame_bytes"] for r in records(runs["process"]) if "frame_bytes" in r]

    def quantiles(values):
        if not values:
            return None
        cut = statistics.quantiles(values, n=20) if len(values) > 1 else values * 2
        return {"p50": statistics.median(values), "p95": cut[-1]}

    every_plan_decomposes = all(all(runs[r]["decomposes"]) for r in ("serial", "process"))
    checks = {
        "serial_equals_process": runs["serial"]["outcome"] == runs["process"]["outcome"],
        # pool by pool at every plan; it cannot pass without comparing
        # a pool's plan that carved
        "pools_equal_unsharded_where_decomposing": all(
            all(equal for equal, _ in runs[r]["pool_equal"])
            and any(carved for _, carved in runs[r]["pool_equal"])
            for r in ("serial", "process")),
        "gang_invariants_every_step": all(runs[r]["gangs_every_step"] for r in runs),
        "runs_idle": all(runs[r]["idle"] for r in runs),
        "check_holds": all(all(runs[r]["cluster"].check().values())
                           for r in ("serial", "process")),
        "process_backend_every_plan_but_the_killed": (
            bool(killed) and escalated_at == [1]
            and process_backends[1][POOLS_KILLED] == "escalated"
            and all(set(b.values()) == {"process"}
                    for i, b in enumerate(process_backends) if i != 1)
            and len(process_backends) > 2),
        "wave2_merged_every_pool": wave2["idle"] and bool(wave2["merged_from"]),
        "restart_adopted": (warm.last_warm_boot or {}).get("outcome") in ("adopted", "partial"),
        "restart_plan_equals_cold": same_first_plan,
    }
    row = {"phase": "pools", "gpus": runs["serial"]["gpus"], "host_cpus": os.cpu_count(),
           "pools_a_plan": sorted({len(r["pools"]) for r in records(runs["serial"])}),
           "pool_plan_ms": quantiles(pool_ms), "merge_ms": quantiles(merge_ms),
           "worker_ready_s": [round(s, 3) for s, _ in ready],
           "torch_in_worker": all(loaded for _, loaded in ready) if ready else None,
           "frame_bytes_a_plan": quantiles(frames),
           "draw_decomposes_every_plan": every_plan_decomposes,
           "decomposing_plans": {r: f"{sum(runs[r]['decomposes'])}/{len(runs[r]['decomposes'])}"
                                 for r in ("serial", "process")},
           "pool_plans_equal_to_unsharded": {
               r: f"{sum(e for e, _ in runs[r]['pool_equal'])}/{len(runs[r]['pool_equal'])}"
               for r in ("serial", "process")},
           "pool_plans_compared_carving": {
               r: sum(1 for _, carved in runs[r]["pool_equal"] if carved)
               for r in ("serial", "process")},
           "plans_equal_to_unsharded_f7": {
               r: f"{sum(runs[r]['unsharded_equal'])}/{len(runs[r]['unsharded_equal'])}"
               for r in ("serial", "process")},
           "unsharded_unserved_without_reason": sum(
               1 for p in runs["unsharded"]["cluster"].store.list("Pod", copy=False)
               if p.phase == "Pending" and not p.node
               and p.namespaced_name not in runs["unsharded"]["outcome"][2]),
           "unserved": {r: len(runs[r]["outcome"][2]) for r in runs},
           "running": {r: sum(ph == "Running" for _, ph in runs[r]["outcome"][0].values())
                       for r in runs},
           "process_backends": process_backends[:4], "killed_pool": POOLS_KILLED,
           "wave2": wave2, "restart": warm.last_warm_boot,
           "restart_plan_ms": {"warm": warm_ms, "cold": cold_ms},
           "runs": {r: {"steps": runs[r]["steps"], "seconds": runs[r]["seconds"]}
                    for r in runs}}
    for run in runs.values():
        run["cluster"].close()
    row.update(checks=checks, ok=all(checks.values()), seconds=time.time() - t0, card=card)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"pools failed: {checks}")
    return row


COMPONENTS_MIG_NODES = 16    # 8 H100s each, in 2 node pools of 8
COMPONENTS_MPS_NODES = 4     # 8 H100s each: 160 GPUs in all
# (namespace, MIG profile or MPS slice, pods): 240 pods, at about 84% of
# the fleet's GB with the gang, the expander's job and the replicas
COMPONENTS_MIX = (("team-a", "mig", "7g.80gb", 30), ("team-a", "mig", "3g.40gb", 40),
                  ("team-a", "mig", "2g.20gb", 15), ("team-a", "mig", "1g.10gb", 15),
                  ("team-b", "mig", "7g.80gb", 25), ("team-b", "mig", "3g.40gb", 15),
                  ("team-b", "mig", "2g.20gb", 15), ("team-b", "mig", "1g.10gb", 15),
                  ("default", "mps", "40gb", 25), ("default", "mps", "20gb", 30),
                  ("default", "mps", "10gb", 15))
COMPONENTS_SEED = 22
COMPONENTS_DEADLINE_S = 60.0    # wall seconds for every pod to run
COMPONENTS_LEASE_S = 2.0        # the schedulers' lease in the process half
COMPONENTS_PROCESS_S = 90.0     # a process's start to healthy, and its exit


def components_suite(card) -> dict:
    """The components' half (a): build_cluster, every component threaded
    on one in-memory store, in wall time: COMPONENTS_MIG_NODES MIG nodes
    of 8 H100s in two node pools and COMPONENTS_MPS_NODES MPS nodes of 8
    (160 GPUs), two quotas in nos.nebuly.com/gpu-memory (team-a's min
    below its demand, so it borrows team-b's unused guarantee), and 240
    pods of COMPONENTS_MIX in a seeded order, with a 2-member 7g.80gb
    gang, one plain nvidia.com/gpu: 12 pod the expander makes a gang of
    two whole nodes, and a ModelServing of 2 replicas. Checked: every pod
    Running within COMPONENTS_DEADLINE_S; the gangs whole in one pool;
    each quota's use within its max, team-a's past its min; then a pod
    made unschedulable on purpose (9 x 7g.80gb, more than a node has)
    gets its diagnosis on /debug/explain, and /healthz, /readyz and
    /metrics answer; SimCluster.check()'s invariants on the store; and
    the same description through the polled SimCluster places every
    pod. Reported: the wall s to all Running, the reconciles by
    controller kind, the plans applied, the polled run's steps and s."""
    import json as _json
    import random
    import urllib.request

    from nos_tpu_torch.api.config import AutoscalerConfig, GpuPartitionerConfig, SchedulerConfig
    from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
    from nos_tpu_torch.cluster import SimCluster
    from nos_tpu_torch.cmd._component import health_server
    from nos_tpu_torch.cmd.cluster import build_cluster
    from nos_tpu_torch.cmd.run import seed_modelserving, seed_node, seed_pod
    from nos_tpu_torch.kube.store import PodPhase
    from nos_tpu_torch.scheduler.plugins.topology import NODEPOOL_LABEL

    t0 = time.time()
    rng = random.Random(COMPONENTS_SEED)
    nodes = ([{"name": f"mig-{i:02d}", "partitioning": "mig",
               "nodepool": "pool-a" if i < COMPONENTS_MIG_NODES // 2 else "pool-b"}
              for i in range(COMPONENTS_MIG_NODES)]
             + [{"name": f"mps-{i}", "partitioning": "mps"} for i in range(COMPONENTS_MPS_NODES)])
    pods = [{"name": f"{kind}-{what.replace('.', '-')}-{i}", "namespace": ns, kind: what}
            for ns, kind, what, n in COMPONENTS_MIX for i in range(n)]
    pods += [{"name": f"pair-{i}", "mig": "7g.80gb", "gang": "pair", "gangSize": 2}
             for i in range(2)]
    pods.append({"name": "wide", "gpus": 12})
    rng.shuffle(pods)
    serving = {"name": "chat", "model": "chat", "sliceProfile": "3g.40gb",
               "minReplicas": 2, "maxReplicas": 2}

    demand = mix_demand(pods)
    gpus = 8 * (COMPONENTS_MIG_NODES + COMPONENTS_MPS_NODES)
    total_gb = sum(demand.values()) + 2 * pod_gb({"mig": serving["sliceProfile"]})
    quotas = mix_quotas(demand)
    mem = RESOURCE_GPU_MEMORY
    row = {"nodes": len(nodes), "gpus": gpus, "pods": len(pods),
           "demand_gb": demand, "fleet_share": total_gb / (80 * gpus)}

    cluster = build_cluster(
        partitioner_config=GpuPartitionerConfig(batch_window_timeout_seconds=1.0,
                                                batch_window_idle_seconds=0.05),
        scheduler_config=SchedulerConfig(retry_seconds=0.2),
        autoscaler_config=AutoscalerConfig())
    health = health_server({}, 0, cluster.scheduler, cluster.store)
    health.host, health.autoscaler_fn = "127.0.0.1", cluster.autoscaler.debug_payload
    port = health.start()

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, ""

    checks = {}
    try:
        for quota in quotas:
            cluster.store.create(quota)
        for spec in nodes:
            cluster.add_node(seed_node(spec))
        cluster.start()
        t1 = time.perf_counter()
        for spec in pods:
            cluster.store.create(seed_pod(spec))
        cluster.store.create(seed_modelserving(serving))
        want = len(pods) + 1 + 2  # the expander's worker, the two replicas
        running_s = None
        while time.perf_counter() - t1 < COMPONENTS_DEADLINE_S:
            live = cluster.pods()
            if len(live) == want and all(p.phase == PodPhase.RUNNING for p in live):
                running_s = time.perf_counter() - t1
                break
            time.sleep(0.02)
        checks["every_pod_running_in_time"] = running_s is not None
        if running_s is None:
            row["not_running"] = {p.namespaced_name: [p.phase, p.node, p.unschedulable_message]
                                  for p in cluster.pods() if p.phase != PodPhase.RUNNING}
        live = cluster.pods()
        node_pool = {n.name: n.labels.get(NODEPOOL_LABEL, "")
                     for n in cluster.store.list("Node", copy=False)}
        gangs = {}
        for p in live:
            if "nos.nebuly.com/gang" in p.labels and p.node:
                gangs.setdefault(p.labels["nos.nebuly.com/gang"], set()).add(node_pool[p.node])
        checks["gangs_in_one_pool"] = all(len(v) == 1 for k, v in gangs.items()
                                          if k in ("pair", "wide"))
        checks["expander_gang_formed"] = sum(p.name.startswith("wide") for p in live) == 2
        used = {q.namespace: q.used.get(mem, 0)
                for q in cluster.store.list("ElasticQuota", copy=False)}
        checks["quota_within_max"] = used["team-a"] <= quotas[0].max[mem]
        checks["team_a_borrows"] = used["team-a"] > quotas[0].min[mem]
        cluster.store.create(seed_pod({"name": "too-big", "mig": "7g.80gb", "count": 9}))
        deadline = time.perf_counter() + 20.0
        while get("/debug/explain?pod=default/too-big")[0] != 200 \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        status, body = get("/debug/explain?pod=default/too-big")
        explained = _json.loads(body) if status == 200 else {}
        checks["debug_explain"] = explained.get("message", "").startswith(
            f"0/{len(nodes)} nodes are available")
        checks["healthz_readyz"] = get("/healthz") == (200, "ok") == get("/readyz")
        status, metrics_text = get("/metrics")
        checks["metrics_families"] = status == 200 and all(
            f'nos_tpu_controller_busy_fraction{{loop="{loop}"}}' in metrics_text
            for loop in ("scheduler", "partitioner-mig", "partitioner-mps", "elasticquota",
                         "autoscaler", "sim-kubelet"))
        cluster.wait_idle(timeout=20.0)
        invariants = cluster.check()
        checks["simcluster_invariants"] = all(invariants.values())
        row["invariants"] = invariants
        kinds = {}
        for name, n in cluster.reconciles().items():
            kind = name.rsplit("-", 1)[0] if name.startswith(("migagent", "mpsagent")) else name
            kinds[kind] = kinds.get(kind, 0) + n
        row.update(running_s=running_s, reconciles=kinds,
                   plans_applied={"mig": cluster.partitioner.plans_applied,
                                  "mps": cluster.partitioner.mps.plans_applied},
                   quota_used_gb=used, explain=explained.get("message"))
    finally:
        cluster.stop()
        health.stop()

    # the same description through the polled loop
    t2 = time.perf_counter()
    polled = SimCluster(autoscaler=AutoscalerConfig())
    try:
        for quota in quotas:
            polled.store.create(quota)
        for spec in nodes:
            if spec["partitioning"] == "mig":
                polled.add_mig_node(spec["name"], pool=spec["nodepool"])
            else:
                polled.add_mps_node(spec["name"])
        for spec in pods:
            polled.store.create(seed_pod(spec))
        polled.store.create(seed_modelserving(serving))
        idle = polled.run_until_idle(2000)
        pods_polled = polled.store.list("Pod", copy=False)
        checks["polled_simcluster_places_every_pod"] = idle and len(pods_polled) == want and all(
            p.phase == PodPhase.RUNNING for p in pods_polled)
        row["polled"] = {"steps": polled.steps, "seconds": time.perf_counter() - t2}
    finally:
        polled.close()
    row.update(checks=checks, seconds=time.time() - t0)
    return row


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def components_processes(card, refusal: str = "MIG mode disabled") -> dict:
    """The components' half (b): one process a component, each
    ``python -m nos_tpu_torch <component>`` against the port's stub API
    server on 127.0.0.1 through a JSON kubeconfig: operator, partitioner,
    autoscaler, two schedulers under leader election (a
    COMPONENTS_LEASE_S lease), a MIG agent and an MPS agent on the sim
    devices, and a MIG agent on NVML, which must exit 1 with ``refusal``
    (the card's MIG mode is off). Checked: each /healthz 200; pods asking
    the profile every MIG GPU starts with bind on the slices their node
    advertises; a pod asking a profile nobody advertises gets a plan
    written for it (the node's spec annotations name it) and binds; an
    MPS pod binds on its node's slice; after SIGTERM to the leading
    scheduler and its exit (0), a new pod binds through the other within
    the lease and 5 s of the signal, the other holding the lease (as the
    API server reads) at the bind and after it; every process exits 0 on
    SIGTERM. Reported: each process's start to healthy s; from the
    signal, the old leader's exit, the lease taken and the bind s; the
    bind from the pod's create s."""
    import json as _json
    import shutil
    import signal
    import tempfile
    import urllib.request

    from nos_tpu_torch.cmd.run import seed_node, seed_pod
    from nos_tpu_torch.gpu.annotations import SPEC_PARTITIONING_PLAN
    from nos_tpu_torch.kube.apiclient import ClusterCredentials, KubeApiClient
    from nos_tpu_torch.kube.apistore import KubeApiStore
    from nos_tpu_torch.kube.leaderelection import HOLDER_ANNOTATION
    from nos_tpu_torch.kube.store import NotFoundError
    from nos_tpu_torch.sim.apiserver import StubApiServer

    t0 = time.time()
    work = tempfile.mkdtemp(prefix="nos-components-")
    server = StubApiServer().start()
    writer = KubeApiStore(KubeApiClient(ClusterCredentials(server=server.url)),
                          kinds=("Node", "Pod", "ConfigMap"))
    procs = {}
    row, checks = {}, {}
    try:
        writer.start()
        kubeconfig = os.path.join(work, "kubeconfig.json")
        with open(kubeconfig, "w") as f:
            _json.dump({"apiVersion": "v1", "kind": "Config", "current-context": "stub",
                        "clusters": [{"name": "stub", "cluster": {"server": server.url}}],
                        "contexts": [{"name": "stub",
                                      "context": {"cluster": "stub", "user": "stub"}}],
                        "users": [{"name": "stub", "user": {}}]}, f)
        for spec in ({"name": "mig-a", "partitioning": "mig"},
                     {"name": "mps-a", "partitioning": "mps"}):
            writer.create(seed_node(spec))
        base = {"store": {"type": "kubeconfig", "kubeconfig": kubeconfig},
                "manager": {"healthProbeHost": "127.0.0.1"},
                "partitioner": {"batchWindowTimeoutSeconds": 1.0, "batchWindowIdleSeconds": 0.1},
                "scheduler": {"retrySeconds": 0.2},
                "agent": {"reportConfigIntervalSeconds": 0.5}}
        election = {"enabled": True, "leaseDurationSeconds": COMPONENTS_LEASE_S,
                    "renewPeriodSeconds": 0.2}
        plan = [("operator", "operator", {}, ""), ("partitioner", "partitioner", {}, ""),
                ("autoscaler", "autoscaler", {}, ""),
                ("scheduler-a", "scheduler", {"leaderElection": {**election,
                                                                 "identity": "scheduler-a"}}, ""),
                ("scheduler-b", "scheduler", {"leaderElection": {**election,
                                                                 "identity": "scheduler-b"}}, ""),
                ("migagent", "migagent", {}, "mig-a"), ("mpsagent", "mpsagent", {}, "mps-a"),
                ("migagent-nvml", "migagent", {"deviceBackend": "nvml"}, "card")]
        for name, command, extra, node in plan:
            path = os.path.join(work, f"{name}.json")
            with open(path, "w") as f:
                _json.dump({**base, **extra}, f)
            env = dict(os.environ, PYTHONPATH=HERE, **({"NODE_NAME": node} if node else {}))
            port = _free_port()
            log = open(os.path.join(work, f"{name}.log"), "w")
            procs[name] = {"port": port, "log": log, "started": time.perf_counter(),
                           "proc": subprocess.Popen(
                               [sys.executable, "-m", "nos_tpu_torch", command, "--config",
                                path, "--health-port", str(port)],
                               cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT)}

        def healthy(p):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{p['port']}/healthz",
                                            timeout=2) as r:
                    return r.status == 200
            except OSError:
                return False

        def log_tail(name, n=2000):
            with open(os.path.join(work, f"{name}.log")) as f:
                return f.read()[-n:]

        def wait(predicate, timeout):
            end = time.perf_counter() + timeout
            while time.perf_counter() < end:
                if predicate():
                    return True
                time.sleep(0.05)
            return False

        start_s = {}
        for name, p in procs.items():
            if name == "migagent-nvml":
                continue
            ok = wait(lambda p=p: healthy(p) or p["proc"].poll() is not None,
                      COMPONENTS_PROCESS_S) and p["proc"].poll() is None
            start_s[name] = time.perf_counter() - p["started"] if ok else None
        checks["every_healthz_200"] = all(s is not None for s in start_s.values())
        nvml = procs["migagent-nvml"]["proc"]
        try:
            nvml_rc = nvml.wait(timeout=COMPONENTS_PROCESS_S)
        except subprocess.TimeoutExpired:
            nvml_rc = None
        nvml_log = log_tail("migagent-nvml")
        checks["nvml_migagent_refused"] = nvml_rc == 1 and refusal in nvml_log
        row.update(start_to_healthy_s=start_s, nvml_migagent={"rc": nvml_rc,
                                                               "refusal": nvml_log.strip()[-300:]})
        if not checks["every_healthz_200"]:
            row["logs"] = {n: log_tail(n) for n, s in start_s.items() if s is None}
            raise RuntimeError("a component never served /healthz")

        def node(name):
            return writer.try_get("Node", name) or seed_node({"name": name})

        whole = "nvidia.com/mig-7g.80gb"
        checks["initial_slices_advertised"] = wait(
            lambda: node("mig-a").allocatable.get(whole, 0) >= 2, 30.0)
        t_bind = time.perf_counter()
        for i in range(2):
            writer.create(seed_pod({"name": f"whole-{i}", "mig": "7g.80gb"}))
        writer.create(seed_pod({"name": "new-profile", "mig": "2g.20gb"}))
        writer.create(seed_pod({"name": "shared", "mps": "20gb"}))

        def bound(name):
            pod = writer.try_get("Pod", name, "default")
            return pod is not None and bool(pod.node)

        checks["pods_bind_on_advertised_slices"] = wait(
            lambda: bound("whole-0") and bound("whole-1"), 30.0)
        checks["plan_written_for_unadvertised_profile"] = wait(
            lambda: any("2g.20gb" in k for k in node("mig-a").annotations)
            and bool(node("mig-a").annotations.get(SPEC_PARTITIONING_PLAN)), 30.0)
        checks["new_profile_pod_bound"] = wait(lambda: bound("new-profile"), 30.0)
        checks["mps_pod_bound"] = wait(lambda: bound("shared"), 30.0)
        row["binds_s"] = time.perf_counter() - t_bind

        def holder():
            # the lease as the API server holds it, not as a cache saw it
            try:
                wire = writer.raw_get("ConfigMap", "nos-tpu-scheduler", "nos-system")
            except NotFoundError:
                return ""
            return ((wire.get("metadata") or {}).get("annotations") or {}).get(
                HOLDER_ANNOTATION, "")

        leader = holder()
        checks["a_scheduler_leads"] = leader in ("scheduler-a", "scheduler-b")
        if checks["a_scheduler_leads"]:
            other = "scheduler-b" if leader == "scheduler-a" else "scheduler-a"
            t_term = time.perf_counter()
            procs[leader]["proc"].send_signal(signal.SIGTERM)
            # the old leader gone first: only the other can bind what follows
            taken_at = []

            def old_gone():
                if not taken_at and holder() == other:
                    taken_at.append(time.perf_counter())
                return procs[leader]["proc"].poll() is not None

            wait(old_gone, COMPONENTS_LEASE_S + 5.0)
            old_rc = procs[leader]["proc"].poll()
            row["old_leader_exit_s"] = time.perf_counter() - t_term
            checks["old_leader_exits_0"] = old_rc == 0
            if not taken_at and wait(lambda: holder() == other, max(
                    0.0, COMPONENTS_LEASE_S + 5.0 - (time.perf_counter() - t_term))):
                taken_at.append(time.perf_counter())
            took = bool(taken_at)
            row["lease_taken_s"] = taken_at[0] - t_term if took else None
            t_pod = time.perf_counter()
            writer.create(seed_pod({"name": "after-handover", "mig": "7g.80gb"}))
            handed = old_rc is not None and wait(
                lambda: bound("after-handover"),
                max(0.0, COMPONENTS_LEASE_S + 5.0 - (t_pod - t_term)))
            at_bind = holder()
            row["handover_bind_s"] = time.perf_counter() - t_term if handed else None
            row["bind_after_create_s"] = time.perf_counter() - t_pod if handed else None
            checks["bind_after_handover_in_time"] = handed and at_bind == other
            time.sleep(COMPONENTS_LEASE_S / 2)  # several renewals on
            at_end = holder()
            row["leaders"] = {"before": leader, "at_bind": at_bind, "at_end": at_end}
            checks["successor_holds_the_lease"] = (took and at_end == other
                                                   and procs[other]["proc"].poll() is None)
        exits = {}
        for name, p in procs.items():
            if p["proc"].poll() is None:
                p["proc"].send_signal(signal.SIGTERM)
        for name, p in procs.items():
            if name == "migagent-nvml":
                continue
            try:
                exits[name] = p["proc"].wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                exits[name] = None
        checks["every_process_exits_0_on_sigterm"] = all(rc == 0 for rc in exits.values())
        row["exit_codes"] = exits
        if not all(checks.values()):
            row["logs"] = {n: log_tail(n, 1500) for n in procs}
    finally:
        for p in procs.values():
            if p["proc"].poll() is None:
                p["proc"].kill()
                p["proc"].wait()
            p["log"].close()
        writer.stop()
        server.stop()
        shutil.rmtree(work, ignore_errors=True)
    row.update(checks=checks, seconds=time.time() - t0)
    return row


def components_phase(card, refusal: str = "MIG mode disabled") -> dict:
    """The components on the Manager (cmd/): components_suite, then
    components_processes; fails unless every check of both holds."""
    t0 = time.time()
    suite = components_suite(card)
    processes = components_processes(card, refusal)
    checks = {**{f"suite_{k}": v for k, v in suite.pop("checks").items()},
              **{f"processes_{k}": v for k, v in processes.pop("checks").items()}}
    row = {"phase": "components", "suite": suite, "processes": processes, "checks": checks,
           "ok": all(checks.values()), "seconds": time.time() - t0, "card": card}
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"components failed: {checks}")
    return row


OBS_SAMPLE_S = 0.2            # the suite's timeline interval in the observability phase
OBS_HEALTHY_SAMPLES = 15      # samples the healthy suite must pass without a finding
OBS_STALL_SAMPLES = 8         # samples from the wedge to its stall finding and event, at most
OBS_WEDGED = "sim-kubelet"    # the controller whose worker the phase wedges
OBS_TOKEN = "observability-smoke"


def observability_phase(card, recording=None) -> dict:
    """The observability plane (item 18b.1) on the card's host:
    bench_observability at reference() size (1,000 nodes x 10,000 pods;
    every *_within_budget true and two governed builds byte-identical),
    bench_store at the same size (each verb's median or mean reported),
    then the threaded suite (build_cluster: COMPONENTS_MIG_NODES MIG and
    COMPONENTS_MPS_NODES MPS nodes of 8 H100s, COMPONENTS_MIX's 240 pods)
    with its health timeline sampling every OBS_SAMPLE_S s, armed on
    OBS_WEDGED's worker loop, and the stack profiler on. Checked: each of
    /debug/, /debug/timeline, /debug/profile, /debug/traces and
    /debug/vars answers 401 without the bearer token and 200 with it; no
    timeline finding over OBS_HEALTHY_SAMPLES samples of the settled
    suite; then with OBS_WEDGED's worker parked in a reconcile on an
    event, a stall finding on loop.<OBS_WEDGED>-work (with the profiler's
    stacks of that thread) and a HealthDegraded event about
    default/nos-health-timeline within OBS_STALL_SAMPLES samples; the
    worker released, it reconciles again. The suite carries the flight
    recorder (RECORD_CAPACITY records, attached before the first node),
    the auditor at rate 1 and COMPONENTS_MIX's two quotas (team-a
    borrowing); once the checks hold, record_capture stops the suite,
    scrapes /debug/record and exports the log into ``recording`` for
    record_phase."""
    import json as _json
    import random
    import shutil
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    from nos_tpu_torch import bench_observability, bench_store
    from nos_tpu_torch.api.config import GpuPartitionerConfig, SchedulerConfig
    from nos_tpu_torch.record import FlightRecorder
    from nos_tpu_torch.api.v1alpha1.constants import EVENT_REASON_HEALTH_DEGRADED
    from nos_tpu_torch.cmd._component import build_timeline, health_server
    from nos_tpu_torch.cmd.cluster import build_cluster
    from nos_tpu_torch.cmd.run import seed_node, seed_pod
    from nos_tpu_torch.kube.store import PodPhase
    from nos_tpu_torch.util.profiling import PROFILER

    t0 = time.time()
    checks = {}
    obs_rows, obs_timing = bench_observability.run_bench(
        bench_observability.ObservabilitySizes.reference())
    obs = obs_rows[0]
    for key, ok in obs["overhead"].items():
        if key.endswith("_within_budget"):
            checks[f"bench_{key}"] = ok
    checks["bench_governed_byte_identical"] = obs["exposition"]["byte_identical"]
    store_rows = bench_store.run_bench(bench_store.StoreSizes.reference())
    store_p50 = {}
    for r in store_rows:
        name = r["bench"] + "".join(f"_{r[k]}" for k in ("copy", "variant") if k in r)
        store_p50[name] = {k: r[k] for k in r if k in bench_store.TIMING_KEYS}
    row = {"bench_observability": obs, "bench_observability_timing": obs_timing[0],
           "bench_store": store_p50}

    tmp = tempfile.mkdtemp(prefix="nos-obs-")
    token_file = os.path.join(tmp, "token")
    with open(token_file, "w") as f:
        f.write(OBS_TOKEN)
    config = {"manager": {"healthProbeHost": "127.0.0.1", "metricsAuthTokenFile": token_file,
                          "timelineSampleSeconds": OBS_SAMPLE_S}}
    rng = random.Random(COMPONENTS_SEED)
    nodes = ([{"name": f"mig-{i:02d}", "partitioning": "mig",
               "nodepool": "pool-a" if i < COMPONENTS_MIG_NODES // 2 else "pool-b"}
              for i in range(COMPONENTS_MIG_NODES)]
             + [{"name": f"mps-{i}", "partitioning": "mps"} for i in range(COMPONENTS_MPS_NODES)])
    pods = [{"name": f"{kind}-{what.replace('.', '-')}-{i}", "namespace": ns, kind: what}
            for ns, kind, what, n in COMPONENTS_MIX for i in range(n)]
    rng.shuffle(pods)
    flight = FlightRecorder(capacity=RECORD_CAPACITY)
    cluster = build_cluster(
        partitioner_config=GpuPartitionerConfig(batch_window_timeout_seconds=1.0,
                                                batch_window_idle_seconds=0.05,
                                                audit_sample_rate=1.0),
        scheduler_config=SchedulerConfig(retry_seconds=0.2), flight_recorder=flight)
    # before the first node: every creation is replay's input
    flight.attach(cluster.store)
    wedged = next(c for c in cluster.manager.controllers if c.name == OBS_WEDGED)
    reconcile, release, parked = wedged.reconciler, threading.Event(), threading.Event()

    def wedging(req):
        if req.name == "wedge-probe":
            parked.set()
            release.wait(30.0)
        return reconcile(req)

    wedged.reconciler = wedging
    timeline = build_timeline(config, cluster.store, "nos-health-timeline", flight=flight)
    # an event-driven loop is stall-checked only where a policy arms it
    timeline.policy.stall_series = (f"loop.{OBS_WEDGED}-work",)
    health = health_server(config, 0, cluster.scheduler, cluster.store, timeline,
                           record_fn=flight.records)
    port = health.start()

    def get(path, token=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, ""

    def degraded():
        return [e for e in cluster.store.list("Event", namespace="default", copy=False)
                if e.reason == EVENT_REASON_HEALTH_DEGRADED
                and e.involved_name == "nos-health-timeline"]

    try:
        for spec in nodes:
            cluster.add_node(seed_node(spec))
        for quota in mix_quotas(mix_demand(pods)):
            cluster.store.create(quota)
        cluster.start()
        t1 = time.perf_counter()
        for spec in pods:
            cluster.store.create(seed_pod(spec))
        running_s = None
        while time.perf_counter() - t1 < COMPONENTS_DEADLINE_S:
            live = cluster.pods()
            if all(p.phase == PodPhase.RUNNING for p in live):
                running_s = time.perf_counter() - t1
                break
            time.sleep(0.02)
        checks["suite_every_pod_running"] = running_s is not None
        checks["suite_settles"] = cluster.wait_idle(timeout=20.0)
        PROFILER.start()
        timeline.start()
        t2 = time.perf_counter()
        while timeline.samples < OBS_HEALTHY_SAMPLES:
            time.sleep(0.05)
        healthy_s = time.perf_counter() - t2
        findings = timeline.findings()
        checks["no_finding_while_healthy"] = not findings
        row["healthy_findings"] = [{k: f[k] for k in ("detector", "series", "verdict")}
                                   for f in findings]

        scrapes = {}
        for path in ("/debug/", "/debug/timeline", "/debug/profile", "/debug/traces",
                     "/debug/vars"):
            closed = get(path)[0]
            status, body = get(path, OBS_TOKEN)
            scrapes[path] = {"without_token": closed, "with_token": status, "bytes": len(body)}
            checks[f"scrape_{path.strip('/').replace('/', '_')}_401_then_200"] = (
                closed == 401 and status == 200)
            if path == "/debug/":
                index = sorted(_json.loads(body)["endpoints"]) if status == 200 else []
                checks["debug_index_lists_the_plane"] = {
                    "/debug/timeline", "/debug/profile", "/debug/traces",
                    "/debug/vars", "/debug/loops"} <= set(index)
            elif path == "/debug/timeline" and status == 200:
                doc = _json.loads(body)
                checks["timeline_samples_the_armed_loop"] = (
                    f"loop.{OBS_WEDGED}-work" in doc["rollups"] and doc["samples"] > 0)
            elif path == "/debug/profile" and status == 200:
                doc = _json.loads(body)
                checks["profiler_samples_the_workers"] = (
                    doc["enabled"] and doc["total_samples"] > 0
                    and f"{OBS_WEDGED}-work" in doc["threads"])
                row["profile"] = {k: doc[k] for k in ("total_samples", "stacks",
                                                      "overhead_fraction", "threads")}
                row["profile"]["threads"] = len(doc["threads"])
        row["scrapes"] = scrapes

        # the wedge: the worker parks in a reconcile until released
        events_before = len(degraded())
        cluster.store.create(seed_pod({"name": "wedge-probe", "mig": "1g.10gb"}))
        parked.wait(10.0)
        checks["worker_parked"] = parked.is_set()
        at_wedge = timeline.samples
        t3 = time.perf_counter()
        stall = event = None
        while timeline.samples - at_wedge <= OBS_STALL_SAMPLES + 2:
            stall = stall or next((f for f in timeline.findings("stall")
                                   if f["series"] == f"loop.{OBS_WEDGED}-work"), None)
            if stall is not None and event is None and len(degraded()) > events_before:
                event = (timeline.samples - at_wedge, degraded()[-1])
            if stall is not None and event is not None:
                break
            time.sleep(0.02)
        checks["stall_finding_on_the_wedged_loop"] = stall is not None
        checks["stall_carries_the_threads_stacks"] = bool(stall and stall.get("stacks"))
        checks["health_degraded_event_in_time"] = (
            event is not None and event[0] <= OBS_STALL_SAMPLES)
        release.set()
        deadline = time.perf_counter() + 30.0
        while time.perf_counter() < deadline:
            probe = cluster.store.try_get("Pod", "wedge-probe", "default", copy=False)
            if probe is not None and probe.phase == PodPhase.RUNNING:
                break
            time.sleep(0.05)
        checks["released_worker_reconciles"] = (probe is not None
                                                and probe.phase == PodPhase.RUNNING)
        row.update(running_s=running_s, healthy_s=healthy_s,
                   healthy_samples=OBS_HEALTHY_SAMPLES,
                   wedge={"samples_to_event": event[0] if event else None,
                          "seconds_to_finding": time.perf_counter() - t3,
                          "finding": stall and {k: stall[k] for k in ("series", "verdict")},
                          "stacks": (stall or {}).get("stacks", [])[:3],
                          "event": event and {"reason": event[1].reason,
                                              "message": event[1].message,
                                              "type": event[1].type}},
                   timeline_samples=timeline.samples)
        if recording is not None:
            recording.update(record_capture(flight, cluster, timeline, get))
    finally:
        release.set()
        timeline.stop()
        cluster.stop()
        flight.detach()
        PROFILER.stop()
        health.stop()
        timeline.close()
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "observability", **row, "checks": checks, "ok": all(checks.values()),
           "seconds": time.time() - t0, "card": card}
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"observability failed: {checks}")
    return row


RECORD_CAPACITY = 200_000    # the flight ring of the observability suite: its whole run
RECORD_SHRUNK_NODE = "mig-00"  # the node whose GPUs the perturbed replay takes away
RECORD_KINDS = ("scheduler.cycle", "planner.plan", "actuation", "quota.reconcile",
                "capacity.observe", "timeline.finding")


def pod_gb(spec) -> int:
    """A ``pods:`` entry's GB: a plain GPU job is two whole nodes; "7g.80gb"
    and "20gb" both end in their GB."""
    if "gpus" in spec:
        return 80 * 16
    return int(spec.get("mig", spec.get("mps", "")).rsplit(".", 1)[-1][:-2])


def mix_demand(pods) -> dict:
    """Namespace → the GB its ``pods:`` entries ask."""
    demand = {}
    for spec in pods:
        ns = spec.get("namespace", "default")
        demand[ns] = demand.get(ns, 0) + pod_gb(spec)
    return demand


def mix_quotas(demand) -> list:
    """COMPONENTS_MIX's two quotas over a ``mix_demand`` (in GB of
    nos.nebuly.com/gpu-memory): team-a's min below its demand (it borrows
    team-b's unused guarantee)."""
    from nos_tpu_torch.api.v1alpha1 import RESOURCE_GPU_MEMORY
    from nos_tpu_torch.api.v1alpha1.elasticquota import ElasticQuota

    mem = RESOURCE_GPU_MEMORY
    return [ElasticQuota("quota", "team-a", {mem: int(demand["team-a"] * 0.8)},
                         {mem: int(demand["team-a"] * 1.2)}),
            ElasticQuota("quota", "team-b", {mem: int(demand["team-b"] * 1.5)})]


def record_capture(flight, cluster, timeline, get) -> dict:
    """The observability suite stopped, the ring final: /debug/record
    without and with the bearer token (JSONL lines against the ring), the
    log exported to a temp file, the live auditor's and the store's
    figures. record_phase checks them."""
    import collections
    import tempfile

    timeline.stop()
    cluster.stop()
    flight.detach()
    ring = flight.records()
    closed = get("/debug/record")[0]
    status, body = get("/debug/record?format=jsonl", OBS_TOKEN)
    out_dir = tempfile.mkdtemp(prefix="nos-record-")
    path = os.path.join(out_dir, "record.jsonl")
    t0 = time.perf_counter()
    exported = flight.export_jsonl(path)
    auditor = cluster.partitioner.auditor
    return {"path": path, "dir": out_dir, "export_s": time.perf_counter() - t0,
            "exported": exported, "ring": len(ring), "capacity": flight.capacity,
            "session_kept": bool(ring) and ring[0]["kind"] == "session.start",
            "kinds": dict(collections.Counter(r["kind"] for r in ring)),
            "debug_record": {"without_token": closed, "with_token": status,
                             "jsonl_lines": len([line for line in body.splitlines() if line])},
            "audits": auditor.audits_run, "checks_skipped": dict(auditor.checks_skipped),
            "live_violations": auditor.violations_total,
            "event_reasons": dict(collections.Counter(
                e.reason for e in cluster.store.list("Event", copy=False))),
            "pods": len(cluster.pods())}


def record_phase(card, recording: dict) -> dict:
    """The flight recorder, the auditor and replay (item 18b.2) on the
    observability suite's log: every record kind the suite makes
    (RECORD_KINDS), the ring within its capacity with its session header
    kept, no live audit violation over plans audited at rate 1, the
    components' Scheduled / FailedScheduling and QuotaBorrowed events in
    the store, /debug/record 401 without the token and 200 with it, as
    many JSONL lines as the ring; then the export replayed in process
    with "0 drift(s), 0 audit violation(s)" (its host seconds and the
    audits' share printed), and a copy with RECORD_SHRUNK_NODE's GPUs
    taken from every delta replayed with drift and a nonzero exit code."""
    import copy as _copy
    import shutil

    from nos_tpu_torch.record import ReplaySession, drift_exit_code, load_jsonl

    t0 = time.time()
    try:
        kinds, reasons = recording["kinds"], recording["event_reasons"]
        checks = {f"records_{kind.replace('.', '_')}": kinds.get(kind, 0) > 0
                  for kind in RECORD_KINDS}
        checks["ring_within_capacity"] = recording["ring"] <= recording["capacity"]
        checks["ring_kept_its_session_header"] = recording["session_kept"]
        checks["export_holds_the_ring"] = recording["exported"] == recording["ring"]
        checks["live_audits_ran"] = recording["audits"] > 0
        # at rate 1 every plan (one planner.plan record each) is audited
        checks["every_plan_audited"] = recording["audits"] == kinds.get("planner.plan", 0)
        checks["no_live_audit_violation"] = (recording["live_violations"] == 0
                                             and kinds.get("audit", 0) == 0)
        checks["scheduler_events"] = bool(reasons.get("Scheduled")
                                          or reasons.get("FailedScheduling"))
        checks["quota_borrowed_events"] = reasons.get("QuotaBorrowed", 0) > 0
        debug = recording["debug_record"]
        checks["debug_record_401_then_200"] = (debug["without_token"] == 401
                                               and debug["with_token"] == 200)
        checks["debug_record_jsonl_lines_equal_the_ring"] = (
            debug["jsonl_lines"] == recording["ring"])
        t1 = time.perf_counter()
        records = load_jsonl(recording["path"])
        load_s = time.perf_counter() - t1
        report = ReplaySession(_copy.deepcopy(records)).run()
        rendered = report.render()
        checks["replay_zero_drift_zero_violations"] = (not report.drifts
                                                       and not report.violations)
        checks["replay_exit_code_0"] = drift_exit_code(report) == 0
        shrunk = 0
        for r in records:
            obj = r.get("object") or {}
            if (r["kind"] == "delta" and obj.get("kind") == "Node"
                    and obj.get("name") == RECORD_SHRUNK_NODE):
                for field in ("capacity", "allocatable"):
                    obj[field] = {"cpu": 8, "memory": 128}
                obj["annotations"] = {}
                shrunk += 1
        perturbed = ReplaySession(records).run()
        checks["shrunk_node_in_the_log"] = shrunk > 0
        checks["shrunk_replay_drifts"] = len(perturbed.drifts) >= 1
        checks["shrunk_replay_exit_code_nonzero"] = drift_exit_code(perturbed) != 0
        print(f"record: {rendered.splitlines()[0]}; replay {report.seconds:.3f} s on the "
              f"host, {report.audit_seconds:.3f} s of it auditing", flush=True)
        row = {"phase": "record", "kinds": kinds, "ring": recording["ring"],
               "capacity": recording["capacity"], "pods": recording["pods"],
               "audits_live": recording["audits"],
               "audit_checks_skipped": recording["checks_skipped"], "event_reasons": reasons,
               "debug_record": debug, "export_s": recording["export_s"], "load_s": load_s,
               "replay": {"line": rendered.splitlines()[0], "cycles": report.cycles,
                          "plans": report.plans, "capacity_observes": report.capacity_observes,
                          "timeline_findings": report.timeline_findings,
                          "skips": len(report.skips), "seconds": report.seconds,
                          "audit_seconds": report.audit_seconds,
                          "drift_examples": [d["detail"][:300] for d in report.drifts[:3]],
                          "violation_examples": report.violations[:3]},
               "shrunk": {"node": RECORD_SHRUNK_NODE, "deltas": shrunk,
                          "drifts": len(perturbed.drifts), "seconds": perturbed.seconds,
                          "exit_code": drift_exit_code(perturbed)},
               "checks": checks, "ok": all(checks.values()), "seconds": time.time() - t0,
               "card": card}
    finally:
        shutil.rmtree(recording.get("dir", ""), ignore_errors=True)
    emit(row)
    if not row["ok"]:
        raise SystemExit(f"record failed: {checks}")
    return row


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(HERE, "nos_tpu_torch", "__init__.py")):
        print("chip_smoke: run from a checkout of the repository "
              "(nos_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.time()
    card = card_line()

    # ------------------------------------------------------------- build
    from nos_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build(_build.KERNELS)
    fwd_ptxas = {f"hd{hd}": figures
                 for entry, figures in _build.ptxas_report("flash_fwd").items()
                 for hd in (64, 128, 256) if f"ILi{hd}E" in entry}
    bwd_figures = bwd_ptxas()
    emit({"phase": "build", "kernels": sorted(libs), "seconds": time.time() - t0,
          "seconds_per_kernel": dict(_build.BUILD_SECONDS),
          "flash_fwd_ptxas": fwd_ptxas, "flash_bwd_ptxas": bwd_figures,
          "card": card})

    # --------------------------------------- sharing comparison, NVML
    sharing_phase(card)
    nvml_phase(card)
    migagent_phase(card)
    partitioner_phase(card)
    kube_phase(card)
    quota_phase(card)
    gang_phase(card)
    control_bench_phase(card)
    pools_phase(card)
    components_phase(card)
    recording: dict = {}
    observability_phase(card, recording)
    record_phase(card, recording)

    # ----------------------------------------------------------- kernels
    import nos_tpu_torch.ops.flash_attention as fa

    main_case = check_attention(card, "generate_prefill_b2_s512", 2, 512, 512)
    check_attention(card, "causal_b2_s2048", 2, 2048, 2048)
    check_attention(card, "causal_ragged_s1000", 1, 1000, 1000)
    check_attention(card, "window512_s2048", 1, 2048, 2048, window=512)
    check_attention(card, "noncausal_s512", 1, 512, 512, causal=False)
    check_attention(card, "block_kv_offset", 1, 512, 512, q_off=1024, kv_off=512)
    check_attention(card, "block_fully_future", 1, 256, 256, q_off=0,
                    kv_off=4096, timed=False)
    # the tile edges of the 128 x 128 kernel, untimed
    for n in (127, 129, 255):
        check_attention(card, f"ragged_s{n}", 1, n, n, timed=False)
    check_attention(card, "window200_offsets_off_tile", 1, 300, 400, q_off=333,
                    kv_off=45, window=200, timed=False)
    check_attention(card, "skv_1", 2, 50, 1, timed=False)
    check_attention(card, "hd64_s1024", 1, 1024, 1024, hq=8, hkv=2, hd=64,
                    timed=False)
    check_attention(card, "q_transposed_view", 2, 200, 200, q_transposed=True,
                    timed=False)
    check_attention(card, "no_gqa_hq_eq_hkv", 1, 256, 256, hq=8, hkv=8, timed=False)
    train_case = check_attention(card, "train_shape_b4_s2048", TRAIN_BATCH,
                                 TRAIN_SEQ, TRAIN_SEQ)

    # the sixteen backward cases of tests/test_torch_cuda.py, then the
    # training shape, timed
    check_backward(card, "causal_b2_s128_hq4", 2, 128, 128, hq=4, hkv=2)
    check_backward(card, "causal_ragged_s100", 1, 100, 100, hq=8, hkv=2)
    check_backward(card, "window37_mqa_hd64_s200", 1, 200, 200, hq=4, hkv=1,
                   hd=64, window=37)
    check_backward(card, "noncausal_ragged_s77", 2, 77, 77, hq=4, hkv=4,
                   causal=False)
    check_backward(card, "block_all_past", 1, 64, 96, hq=4, hkv=2, q_off=96)
    check_backward(card, "block_window_offsets", 1, 64, 96, hq=4, hkv=2,
                   q_off=40, kv_off=20, window=50)
    check_backward(card, "block_fully_future", 1, 64, 64, hq=4, hkv=2,
                   kv_off=1000)
    # the edges of the 64-row query tiles and 128-key blocks
    for n in (63, 65, 127, 129, 255):
        check_backward(card, f"ragged_s{n}", 2 if n == 255 else 1, n, n, hq=4, hkv=2)
    check_backward(card, "window200_offsets_off_tile", 1, 300, 400, hq=4, hkv=2,
                   q_off=333, kv_off=45, window=200)
    check_backward(card, "hd64_s1024", 1, 1024, 1024, hq=8, hkv=2, hd=64)
    check_backward(card, "no_gqa_hq_eq_hkv", 1, 256, 256, hq=4, hkv=4)
    check_backward(card, "skv_1", 2, 50, 1, hq=4, hkv=2)
    bwd_case = check_backward(card, "train_shape_b4_s2048", TRAIN_BATCH,
                              TRAIN_SEQ, TRAIN_SEQ, timed=True)
    hd256 = gemma_kernel_phases(card)

    # ---------------------------------------------------- the model bench
    model_bench = model_bench_phase(card)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ ResNet
    resnet_phase(card)
    torch.cuda.empty_cache()

    # ------------------------------------------------ checkpoint, model
    # Llama-3-8B drawn from a seed, written as a transformers checkpoint
    # and loaded back: the model phases run on the loaded tree
    import shutil
    import tempfile

    ckpt_path = tempfile.mkdtemp(prefix="nos-hf-llama3-8b-")
    try:
        return _from_the_checkpoint(card, t_start, ckpt_path, main_kernels=(
            main_case, train_case, bwd_case, hd256, fwd_ptxas, bwd_figures, _build,
            model_bench))
    finally:
        shutil.rmtree(ckpt_path, ignore_errors=True)


def _from_the_checkpoint(card, t_start, ckpt_path, main_kernels) -> int:
    """Every phase from the checkpoint on (the directory lives as long
    as this runs)."""
    import torch

    import nos_tpu_torch.ops.flash_attention as fa
    from nos_tpu_torch.models import llama

    (main_case, train_case, bwd_case, hd256, fwd_ptxas, bwd_figures, _build,
     model_bench) = main_kernels
    t0 = time.time()
    params, loaded_cfg = hf_checkpoint_phase(card, ckpt_path)
    cfg = dataclasses.replace(loaded_cfg, attention="flash")
    n_params = sum(t.numel() for t in llama.tree_leaves(params))
    emit({"phase": "init", "config": "llama_3_8b", "params": n_params,
          "source": "loaded from the checkpoint directory",
          "seconds": time.time() - t0,
          "gib": torch.cuda.memory_allocated() / 2**30, "card": card})

    tok_gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=tok_gen,
                           device="cuda")
    forward_check(card, "llama_forward", params, cfg, tokens)

    # the main path: generate() with the launch counts zeroed just before
    prompt = torch.randint(1, cfg.vocab_size, (2, 512), generator=tok_gen,
                           device="cuda")
    main_launches, out = generate_check(card, "generate", params, cfg, prompt)
    decode_check(card, "decode_step", "decode_profile", params, cfg, prompt,
                 out[:, 0], n_params)
    tiny_check(card, "tiny_card_vs_cpu", llama.tiny_config(
        d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, attention="flash"), tok_gen)

    # ------------------------------------------------------------ engine
    from nos_tpu_torch.serve import Engine, GenRequest
    from nos_tpu_torch.util import metrics

    rng_tokens = torch.randint(1, cfg.vocab_size, (2000,), generator=tok_gen,
                               device="cuda").tolist()
    shared = rng_tokens[:300]
    prompts = [
        rng_tokens[300:320],                      # 20: padded prefill
        shared + rng_tokens[320:370],             # 350: chunked, stores prefix
        shared + rng_tokens[370:460],             # 390: chunked, prefix hit
        rng_tokens[460:1160],                     # 700: chunked, 3 pieces
        rng_tokens[1160:1260],                    # 100: padded
        rng_tokens[1260:1460],                    # 200: padded (bucket 256)
    ]
    hits0 = metrics.SERVE_PREFIX_HITS.value
    ticks0 = metrics.SERVE_TICKS.value
    eng = Engine(params, cfg, max_slots=4, max_len=1024, prefill_chunk=256,
                 prefix_cache_entries=2)
    with torch.no_grad():
        fa.LAUNCHES = 0
        t0 = time.time()
        ids = [eng.submit(GenRequest(prompt=p, max_new_tokens=32)) for p in prompts]
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    hits = metrics.SERVE_PREFIX_HITS.value - hits0
    lens_ok = all(len(results[i]) == 32 for i in ids)
    eng_ok = lens_ok and hits >= 1 and all(
        0 <= t < cfg.vocab_size for i in ids for t in results[i]
    )
    emit({"phase": "engine", "requests": len(ids),
          "prompt_tokens": [len(p) for p in prompts], "new_tokens": 32,
          "prefix_hits": hits, "seconds": wall,
          "tokens_per_s": 32 * len(ids) / wall,
          "decode_ticks": metrics.SERVE_TICKS.value - ticks0,
          "flash_launches": fa.LAUNCHES, "ok": eng_ok, "card": card})
    if not eng_ok:
        raise SystemExit(f"engine failed: lengths ok {lens_ok}, prefix hits {hits}")
    del eng

    # ---------------------------------------- SLO bench and the examples
    t0 = time.time()
    slo = slo_serve_phase(card, params, cfg)
    autoscale_phase(card, slo["clock"])
    forecast_phase(card)
    examples = examples_phase(card, ckpt_path)
    torch.cuda.empty_cache()
    preempt = preempt_resume_phase(card)
    torch.cuda.empty_cache()
    emit({"phase": "slo_and_examples", "seconds": time.time() - t0, "card": card})

    # ------------------------------------------------ serving extensions
    trees = quantize_phase(card, params, cfg)
    generate_quant_phase(card, trees, cfg, prompt)
    decode_quant_phase(card, trees, cfg, prompt, out[:, 0])
    engine_quant_lora_phase(card, trees, cfg, prompts)
    spec_prompts = [rng_tokens[1460:1480], rng_tokens[1480:1580],
                    rng_tokens[1580:1780], rng_tokens[1780:1990]]
    spec_engine_phase(card, params, cfg, spec_prompts)

    # --------------------------------------------------------------- MoE
    # the Llama trees and caches go first: the int8 Mixtral holds ~47 GB
    del params, prompt, out, trees
    torch.cuda.empty_cache()
    t0 = time.time()
    moe_check_phase(card)
    moe_grads = moe_train_grads_phase(card)
    torch.cuda.empty_cache()
    import tempfile

    ep_ref = tempfile.mkdtemp(prefix="nos-ep-ref-")
    mixtral = mixtral_int8_phase(card, ep_ref)
    torch.cuda.empty_cache()  # the Mixtral tree goes before training (~51 GB)
    emit({"phase": "moe_phases", "seconds": time.time() - t0, "card": card})

    # ---------------------------------------------------------- training
    train_grads_phase(card)
    torch.cuda.empty_cache()
    train = train_phase(card)
    torch.cuda.empty_cache()
    train_adamw_phase(card)
    torch.cuda.empty_cache()
    lora = lora_train_phase(card)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- Gemma
    # Gemma-2B (head_dim 256, one kv head) through the hd-256 kernels
    t0 = time.time()
    gemma = gemma_model_phase(card)
    torch.cuda.empty_cache()
    gemma_grads = train_grads_phase(card, llama.gemma_2b_config(),
                                    phase="gemma_train_grads", seed=23)
    torch.cuda.empty_cache()
    gemma_train = train_phase(card, llama.gemma_2b_config(), config="gemma_2b",
                              phase="gemma_train", seed=25)
    emit({"phase": "gemma_phases", "seconds": time.time() - t0, "card": card})
    torch.cuda.empty_cache()

    # -------------------------------------------------------- sp paths
    sp = sp_phases(card)

    # ------------------------------------------------------ tp and FSDP
    tp = tp_phases(card)

    # ------------------------------------------- expert and pipeline
    import shutil

    try:
        ep_pp = ep_pp_phases(card, ep_ref)
    finally:
        shutil.rmtree(ep_ref, ignore_errors=True)

    # ----------------------------------------------------------- summary
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "nos_tpu/ops/flash_attention.py:175",
        "launches": main_launches,
        "launches_mixtral_generate": mixtral["launches_generate"],
        "launches_moe_train_grads": moe_grads["launches_fwd_dq_dkv"][0],
        "max_abs_err": main_case["o_max_abs_err"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": "q [2,512,32,128], k/v [2,512,8,128] bf16 causal",
        "launches_train": train["launches_total_fwd_dq_dkv"][0],
        "launches_lora_step": lora["launches_per_step_fwd_dq_dkv"][-1][0],
        "launches_train_llama_example_step":
            examples["train_llama"]["launches_per_step_fwd_dq_dkv"][0],
        "launches_preempt_resume_step": preempt["launches_per_step_fwd_dq_dkv"][0],
        "launches_sp_per_rank": sp_launches(sp, 0, False),
        "launches_tp_per_rank": sp_launches(tp, 0, False),
        "launches_ep_pp_per_rank": sp_launches(ep_pp, 0, False),
        "launches_model_bench": bench_launches(model_bench, 0),
        "device_ms": main_case["kernel_device_ms"],
        "library_device_ms": main_case["library_device_ms"],
        "ms_train": train_case["kernel_ms"],
        "tflops_train": train_case["kernel_tflops"],
        "bound_ms_train": train_case["bound_ms"],
        "library_ms_train": train_case["library_ms"],
        "shape_train": "q [4,2048,32,128], k/v [4,2048,8,128] bf16 causal",
        "ptxas": fwd_ptxas,
        "build_seconds": _build.BUILD_SECONDS.get("flash_fwd"),
        "check": "pass",
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": replaces,
        "launches": train["launches_total_fwd_dq_dkv"][index],
        "launches_lora_step": lora["launches_per_step_fwd_dq_dkv"][-1][index],
        "launches_train_llama_example_step":
            examples["train_llama"]["launches_per_step_fwd_dq_dkv"][index],
        "launches_preempt_resume_step": preempt["launches_per_step_fwd_dq_dkv"][index],
        "launches_moe_train_grads": moe_grads["launches_fwd_dq_dkv"][index],
        "launches_sp_per_rank": sp_launches(sp, index, False),
        "launches_tp_per_rank": sp_launches(tp, index, False),
        "launches_ep_pp_per_rank": sp_launches(ep_pp, index, False),
        "launches_model_bench": bench_launches(model_bench, index),
        "max_abs_err": max(bwd_case[f"{g}_max_abs_err"] for g in grads),
        "ms": bwd_case[f"{key}_ms"],
        "plain_ms": bwd_case["plain_ms"],
        "bound_ms": bwd_case[f"{key}_bound_ms"],
        "bound_by": bwd_case[f"{key}_bound_by"],
        "library_ms": bwd_case["library_ms"],
        "shape": "q/dO [4,2048,32,128], k/v [4,2048,8,128] bf16 causal",
        "plain_and_library_cover": "dq, dk and dv together",
        "tflops_train": bwd_case[f"{key}_tflops"],
        "ptxas": {k: v for k, v in bwd_figures.items() if k.startswith(f"{key}_")},
        "build_seconds": _build.BUILD_SECONDS.get("flash_bwd"),
        "check": "pass",
    } for name, replaces, index, key, grads in (
        ("flash_dq", "nos_tpu/ops/flash_attention.py:326", 1, "dq", ("dq",)),
        ("flash_dkv", "nos_tpu/ops/flash_attention.py:368", 2, "dkv", ("dk", "dv")),
    )] + [{
        "name": "flash_fwd_hd256",
        "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "nos_tpu/ops/flash_attention.py:175",
        "launches": gemma["generate_launches"],
        "launches_gemma_train": gemma_train["launches_total_fwd_dq_dkv"][0],
        "launches_gemma_train_grads": gemma_grads["launches_fwd_dq_dkv"][0],
        "launches_sp_per_rank": sp_launches(sp, 0, True),
        "max_abs_err": hd256["fwd_prefill"]["o_max_abs_err"],
        "ms": hd256["fwd_prefill"]["kernel_ms"],
        "plain_ms": hd256["fwd_prefill"]["plain_ms"],
        "bound_ms": hd256["fwd_prefill"]["bound_ms"],
        "bound_by": hd256["fwd_prefill"]["bound_by"],
        "library_ms": hd256["fwd_prefill"]["library_ms"],
        "shape": "q [2,512,8,256], k/v [2,512,1,256] bf16 causal",
        "device_ms": hd256["fwd_prefill"]["kernel_device_ms"],
        "library_device_ms": hd256["fwd_prefill"]["library_device_ms"],
        "ms_train": hd256["fwd_train"]["kernel_ms"],
        "tflops_train": hd256["fwd_train"]["kernel_tflops"],
        "bound_ms_train": hd256["fwd_train"]["bound_ms"],
        "plain_ms_train": hd256["fwd_train"]["plain_ms"],
        "library_ms_train": hd256["fwd_train"]["library_ms"],
        "device_ms_train": hd256["fwd_train"]["kernel_device_ms"],
        "shape_train": "q [4,2048,8,256], k/v [4,2048,1,256] bf16 causal",
        "ptxas": fwd_ptxas.get("hd256"),
        "check": "pass",
    }] + [{
        "name": f"{name}_hd256",
        "route": "cuda",
        "source": "nos_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": replaces,
        "launches": gemma_train["launches_total_fwd_dq_dkv"][index],
        "launches_gemma_train_grads": gemma_grads["launches_fwd_dq_dkv"][index],
        "launches_sp_per_rank": sp_launches(sp, index, True),
        "max_abs_err": max(hd256["bwd_train"][f"{g}_max_abs_err"] for g in grads),
        "ms": hd256["bwd_train"][f"{key}_ms"],
        "device_ms": hd256["bwd_train"][f"{key}_device_ms"],
        "plain_ms": hd256["bwd_train"]["plain_ms"],
        "bound_ms": hd256["bwd_train"][f"{key}_bound_ms"],
        "bound_by": hd256["bwd_train"][f"{key}_bound_by"],
        "library_ms": hd256["bwd_train"]["library_ms"],
        "shape": "q/dO [4,2048,8,256], k/v [4,2048,1,256] bf16 causal",
        "plain_and_library_cover": "dq, dk and dv together",
        "tflops_train": hd256["bwd_train"][f"{key}_tflops"],
        "ptxas": {k: v for k, v in bwd_figures.items()
                  if k.startswith(f"{key}_hd256")},
        "check": "pass",
    } for name, replaces, index, key, grads in (
        ("flash_dq", "nos_tpu/ops/flash_attention.py:326", 1, "dq", ("dq",)),
        ("flash_dkv", "nos_tpu/ops/flash_attention.py:368", 2, "dkv", ("dk", "dv")),
    )], "seconds": time.time() - t_start, "card": card})
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
