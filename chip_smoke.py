#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases — any failure raises, and the script then exits non-zero without
the final ``ok`` line:

(a) print the card's name and power limit; build every CUDA kernel of the
    port from ``fedml_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all
    started together) and print the build time and, for each kernel, its
    registers, dynamic shared memory and spill bytes;
(b) hold the int8 dequant-matmul kernel against its plain PyTorch version
    at every Llama-3-8B projection shape and 1/8/16/32/64/128 rows, row by
    row (each output row within 2^-8 of its own norm), show that two
    planted faults (one split's partial sum missing, the last 16 columns
    missing) fail that check and that two launches give the same bits, and
    time the kernel, the plain version and a one-call PyTorch yardstick
    with CUDA events, beside the card's bound for the same work, with each
    row count's sum over one pass's 225 launches;
(c) serve Llama-3-8B at full width (random bf16 weights from a seed,
    quantized to int8 in place) through the port's ``serve`` entry point:
    8 HTTP requests (4 concurrent) of 20–120 prompt tokens and 32 new tokens
    each, with the kernel's launch count read around exactly that run; then
    time steady decode at 8 slots, and check the served logits are finite
    and agree with the plain int8 lowering on a short prompt;
(d) hold the three flash-attention kernels (forward, dq, dk/dv) against
    their plain PyTorch versions in bf16 at Llama-3-8B's heads (B=1, 32 q
    heads over 8 KV heads, head_dim 128) for T=S=2048 causal (the training
    shape), T=S=1000 causal (ragged), T=S=512 full and T=256/S=512 causal
    (top-left alignment), row by row (``row_rel_err``), show at T=2048
    that two planted faults fail that check and that two launches of the
    backward give bit-identical dq, dk and dv, and time each kernel (with
    its achieved TFLOP/s), its plain version and
    ``scaled_dot_product_attention`` (forward; backward) beside the bound;
(e) after the serve phase's weights are freed, run federated LoRA rounds
    of Llama-3-8B at full width and depth through ``FedLLMAPI`` with the
    on-device round (rank 16, bf16 base, T=2048, batch 1, 4 of 8 clients ×
    2 local steps, 2 rounds, test each round), with the flash launch counts
    read around exactly ``train()`` and required to be 32 per forward and
    backward; print seconds per round, tokens/s, peak memory and the device
    busy share of one round (with its device time by kernel class); hold
    layer 0's attention output and LoRA gradients, every layer's flash
    output on the model's own activations, and the model's loss on one
    batch, kernels against plain versions;
(f) the quantized formats at Llama-3-8B's widths: what ``torch._int_mm``
    takes (16 rows or not; the weight's layout, timed both ways), the w8a8
    product against its plain version on the CPU at every
    projection shape and 1/8/16/17/128/2048 rows (activation codes and
    int32 accumulators bit for bit, outputs row by row); int4 and nf4
    quantized and dequantized on the card to the CPU's bits for layer 0's
    seven kernels and the LM head; one 225-launch pass at 8 and 128 rows
    timed for w8a8, nf4 dequant + matmul and bf16 ``torch.matmul`` beside
    the int8 kernel's (phase b) and each pass's bound; then Llama-3-8B
    served with ``--quantize w8a8`` and ``--quantize nf4`` (4 HTTP requests,
    2 concurrent, 16 new tokens each) with decode ms/step at 8 slots, TTFT
    and the served bytes, finite logits, and one prompt's greedy tokens
    equal to the plain lowering of the same quantized weights;
(g) after phase (e)'s weights are freed, phase (e) again over an nf4 base
    (QLoRA, ``base_quantize: nf4``): the same launch counts and checks, the
    packed base bit-identical before and after ``train()``, the
    ``quant/base_bytes`` gauge equal to the packed bytes, its round time,
    tokens/s, busy share, device time by class and peak memory beside
    phase (e)'s (the peak at least 5 GB lower); then one round over an int8
    base;
(h) the single-process FedAvg simulation through ``create_simulator``:
    ResNet-18 (GroupNorm, 2 groups) at full width on ``load_cifar10``'s
    stand-in at CIFAR-10's size (50,000 + 10,000 images of 32×32×3), 10 of
    10 hetero clients (α 0.5), batch 32, one epoch of SGD at lr 0.1, int8
    uplinks with error feedback, 1 round with a test; it fails unless
    one client's 4 steps from the run's final weights on the card agree
    with the CPU's and with a float64 run, ``fused_weighted_sum`` on the card is
    within 1e-6 of decoding each upload and summing, the int8 and nf4 wire
    bytes of the run's delta are identical on the card and the CPU, the
    test loss falls below the untrained model's and every round's parameters
    are finite and on the card; it prints each round's seconds, test loss
    and accuracy, encode and fused-aggregation ms, the last round's
    training samples/s, the busy share of 20 profiled local steps, the
    peak memory and the uplink bytes against f32;
(i) cross-silo FedAvg on phase h's model and data (no hand kernel lies on
    this path either). (i1) ``run_cross_silo_inproc``'s federation over the
    in-process LOCAL transport on the card: 4 silos on 4 of 16 hetero parts
    (α 0.5),
    int8 uplinks with error feedback, 2 rounds; one client's first upload is
    posted twice. It fails unless the server reports 2 rounds, the test loss
    falls from round 0 to round 1, every upload that reached the server is
    an int8 delta at least 3.9x smaller than the f32 tree, and the duplicate
    was dropped once; it prints each round's seconds, test loss and
    accuracy, the steady round's training samples/s, the peak memory, and
    (CUDA events, the last round's work replayed) the encode, the fused
    aggregation and the layout conversions of a round. (i2) the port's
    ``PubSubBroker`` on an ephemeral localhost port, an object-store
    directory under a temp dir, and the server and 2 silos as three OS
    processes started through ``run_cross_silo_server`` /
    ``run_cross_silo_client`` with a config file the phase writes (a fixed
    ``PYTHONHASHSEED``), 1 round; it fails unless every process exits 0
    within CS_BROKER_TIMEOUT_S, the server reports 1 round and the broadcast
    went through the store, and prints the bytes published on the broker
    and written to the store, the ``safe_dumps`` / ``safe_loads`` ms of the
    broadcast and of one upload, and the round's wall;
(j) the aggregation-side trust stack on phase h's model and data, j1 on a
    quarter of its training images and j2 on an eighth (no hand kernel on
    this path). (j1) the
    sp simulation, 10 of 10 clients, int8,
    2 rounds, ``integrity: true`` with ``agg_robust: trimmed_mean@0.2``;
    in round 0 one upload arrives with a NaN scale and one scaled ×100. It
    fails unless the NaN upload is screened and its sender quarantined out
    of round 1, the ×100 upload is contained by the trimmed mean (its pull
    on the aggregate within 0.1 of the plain weighted mean's) and the test
    loss falls from round 0 to 1; it prints ``screen_stats`` ms an upload,
    ``fused_robust_sum`` against ``fused_weighted_sum`` ms on the same
    uploads (CUDA events), the peak memory and the ``integrity/*``
    counters. (j2) one sp round on the decode fallback, byzantine (random)
    on 2 of 10 with krum: it fails unless krum keeps a benign update; then
    every registered defense's three hooks run on that round's 10 ResNet-18
    updates, each timed with its memory above them. (j3) cross-silo in
    process, 4 silos over LOCAL, each one of 40 parts, 1 round,
    ``integrity: true``,
    norm-difference clipping and local DP: it fails unless the fused path
    serves with clip factors, at least one upload is clipped
    (``health/norm_clips_fused``) and the round ends finite; it prints
    each silo's ε;
(k) secure aggregation on phase h's model and data (no hand kernel on this
    path; the finite-field work is host numpy and the port's C++ LCC
    library). (k1) ``secagg: int8`` (clip 0.1, mod_bits 8) on 4 silos over
    LOCAL, each on one of 20 parts a round, 2 rounds, quorum 0.75 with a
    deadline; one silo stalls in round 1. It fails unless every upload the
    server holds is a v2 masked tree and decoding one raises, each round's
    aggregate is bit-identical to the unmasked sum of the same quantized
    words (the same deltas, keys and residuals encoded on the card with zero
    masks), round 1 closes through
    one recovery with 3 seeds revealed, and the test loss stays finite and
    ends below the untrained model's; it prints the masked encode against
    the plain int8 encode of the same delta and ``unmask_finalize``
    against ``fused_weighted_sum`` (CUDA events), the host ms of the Philox
    masks and of one X25519 agreement, and the masked, int8 and f32 wire
    bytes. (k2) the same recipe with a server and 2 silos as processes over
    the broker, 1 round: every process exits 0. (k3) the Bonawitz FSM
    (``secure_aggregation: true``) on 3 silos with rank 3 dropping after the
    share exchange, and (k4) LightSecAgg on 3 silos, each one of 40 parts,
    1 round each: each
    fails unless the server's unmasked field sum equals the survivors' plain
    field sum and the global model is that sum dequantized and averaged; it
    prints the server's finite-field host ms;
(l) round checkpoints, contribution assessment and the reconstruction
    attacks. (l1) phase e's Llama-3-8B rounds through ``FedLLMAPI``'s host
    loop (``on_device_round: false``; rank 16, T=2048, batch 1, 4 of 8
    clients x 2 local steps, 2 rounds, a test each) with norm-difference
    clipping live around every client's payload and a checkpoint each
    round: it fails unless the flash launches read around exactly
    ``train()`` are 32 per forward and per backward, both test losses are
    finite, each round's checkpoint exists, and the last one, loaded into a
    freshly built engine, gives the saved adapters and that round's test
    loss bit for bit; it prints each round's seconds and tokens/s beside
    phase e's, the host share (exchange, hooks, aggregation), the
    checkpoint's save and load ms and bytes, and the peak memory. (l2)
    ``serve --checkpoint`` of l1's last round (``--lora-rank 16 --quantize
    int8``), 2 HTTP requests of 8 new tokens: it fails unless the dequant
    kernel runs 225 launches a pass (decode step or prefill), the logits are
    finite, agree with the plain int8 lowering of the same weights and
    adapters, and differ from the same endpoint without the checkpoint.
    (l3) the sp simulation of ResNet-18 on the stand-in cut to 50 IID
    clients, 4 a round, FedOpt with server momentum 0.9, GTG-Shapley with
    one client's labels all flipped to class 0, from one global model warmed
    up by 3 rounds of 10 clients: 3 rounds uninterrupted, then 1 round, a
    restart with ``resume: true`` and 2 more; it fails unless the restored
    state is bit-identical to the saved one, the resumed run ends on the
    uninterrupted run's parameters (bit for bit under cuDNN's deterministic
    algorithms, else within RESUME_BOUND, said which) and the flipped client
    is valued lowest; it prints the utility evaluations a round and their
    ms, the checkpoint's ms and bytes. (l4) 4 silos over LOCAL, 1 round with
    a checkpoint and leave-one-out values, then a fresh server with
    ``resume: true``: it fails unless it starts at round 1 from the saved
    parameters and both rounds end finite. (l5) DLG (60 iterations, cosine)
    on ResNet-18 against one stand-in image: it fails unless the match loss
    falls and every tensor is finite, and prints ms an iteration and the
    reconstruction's MSE; ``revealing_labels`` from ResNet-18's classifier
    gradient at init on a batch of 32: it fails unless the counts sum to 32
    and equal the CPU's from the same gradient, and prints their L1 distance
    to the true histogram;
(m) the durable cross-silo server and the asynchronous server on phase h's
    model and data, each silo training one of 20 hetero parts a round (no
    hand kernel on this path). (m1) a server and 2 silos as OS processes
    over the broker through the port's rank entry point
    (``resilience/durability/recover``), ``durability: true``, the identity
    codec, 2 rounds; the server's kill window SIGKILLs it in round 1 after
    one journaled upload and a ``RestartTracker`` supervisor respawns it
    with ``resume: true``. It fails unless the run completes with one
    restart and at least one salvaged upload, no salvaged silo trains the
    resumed round twice, the final digest equals an uninterrupted in-process
    run of the same seed (a child process, the same ``PYTHONHASHSEED``) bit
    for bit, and the test loss ends below the untrained model's; beside it
    (at once) the same with int8 uplinks, 2 rounds: it completes and
    salvages. It prints
    the MTTR, the journal's append ms and bytes for an identity and an int8
    upload, the replay ms at the restart, and the round walls around the
    kill. (m2) the async server in process over LOCAL: 4 silos on IID
    parts, int8,
    FedBuff with a buffer of 4, 8 updates, ``durability: true``; it fails
    unless every update is applied in 2 whole-buffer flushes and the test
    loss ends below the untrained model's; then, over copies of its
    checkpoint directory, a server takes 2 of 4 recorded uploads and is
    abandoned, a restarted one refills its buffer from the journal and takes
    the other 2, and its flush must equal an uninterrupted server's flush of
    the same 4, bit for bit; last, an instant-apply run (no buffer, 4
    updates) checkpoints every version. It prints updates/s, flush ms (CUDA
    events), the staleness histogram and the checkpoint ms a version;
(n) the aggregation tree (``hierarchy.TreeRunner``, no hand kernel on this
    path), int8 at every tier. (n1) ``TreeTopology.build(64, 4)`` (levels
    1, 4, 16, 64) over phase h's ResNet-18 in the reference's layout as
    the template, seed 0, quorum 0.75, chunks of 8, 2 rounds; leaf client 17
    dead in round 0 and an ``EdgeKillWindow`` crashing tier-1 node 0 in
    round 1 after one accepted partial sum, with its journal in a temporary
    directory. It fails unless the run ends ``final_digest``-equal to the
    same run without the crash, with one restart and a salvaged partial sum,
    leaf client 17 evicted and rejoined once, no tier buffering 5% of the
    clients' f32 trees and an upload under 0.35 of an f32 tree; it prints
    seconds a round, leaf uploads/s, per-tier upload and buffer bytes, the
    leaf chunks' device ms (CUDA events), the busy share of one round
    (profiler device time over its unprofiled wall), the edge journal's
    append ms and bytes a partial sum, and the peak memory. (n2) ``python -m
    fedml_tpu_torch.cli tree --clients 100000 --tiers 3 --rounds 2 --params
    128 --codec int8 --quorum 0.5 --kill-tier 1 --kill-node 3 --kill-round
    1 --device cuda`` in a child process, the same run in process beside
    it: both
    complete with equal digests, a quorum close at the root and an evicted
    edge, under the same gates; it prints rounds/s, the command's wall and
    per-tier bytes. (n3) per-edge-cohort SecAgg on ``(1, 4, 16)`` with the
    ResNet-18 template, seed 3, quorum 0.5, chunks of 4, leaf client 5 dead
    in round 1, 2 rounds, twice: equal digests, a recovery, and round 1's
    unmasked sum of client 5's cohort equal word for word to its survivors'
    clipped, shared-scale quantized words summed with zero masks; it prints
    seconds a round and the host ms on masks;
(o) the other transports and cross-cloud (no hand kernel on this path):
    three federations at once, each a server and 2 silos as OS processes
    started through the entry points, on phase i2's cut of phase h's model
    and data (8 hetero parts, a part a silo), int8 uplinks, 1 round, cuDNN's
    deterministic algorithms. (o1) ``comm_backend: TRPC`` on a free
    rendezvous port; (o2) ``training_type: cross_cloud`` over the port's
    C++ epoll broker (``deploy broker --native`` in a child process) with
    ``remote_storage: s3`` at a SigV4-checking stub on 127.0.0.1 and the
    payload offload at 64 KiB, each silo applying its own override file
    (its transport keys and its S3 region); (o3) ``comm_backend: GRPC`` on
    free ports. It fails unless every process exits 0 within
    O_TIMEOUT_S, each server ran 1 round, each test loss ends below the
    untrained model's, the stub verified every signature and served the
    broadcast to both silos, each silo echoes its override file's values,
    and the three final global models are digest-equal. It prints per leg
    the wall, the round ms, the wire bytes out and in by backend, the bytes
    through the native broker and the store, and the SigV4 PUT and GET ms;
(p) federated analytics (``fa``, no hand kernel on this path: the vote
    tables are a ``bincount``, the merge the fused weighted sum). (p1) the
    ``fa`` command (``--seed 0``, 6 clients, the FA message FSM in process)
    for each of the eight tasks, and ``frequency_estimation`` with
    ``--deadline-s 2 --quorum 0.5``, on the card and on the CPU: each line
    must equal the CPU's (``avg`` within FA_AVG_TOL) and TrieHH must find
    ``sun`` and ``moon``. (p2) the reference's 102,400-client heavy-hitter
    acceptance cut to a quarter (see FA_P2): levels (1, 200, 25600),
    ``votevec@1024/3``,
    central DP, three leaf kills, an edge kill and a root crash after 2
    children restarted from its journal, no SecAgg, twice; it fails unless
    both complete, the root weight is the survivors', the heavy hitters are
    the plaintext reference's (recall and precision 1.0), a restart was
    counted, the sketch and DP probes hold, the runs are digest-equal and the
    upload is 4 B a cell plus its scale. (p3) ``fa --federation
    --fed-clients 256 --fed-tiers 3`` (SecAgg, ``votevec@4096/3``, levels 1,
    16, 256) against the same scenario unmasked: equal digests and the
    reference's heavy hitters. It prints the walls, round seconds, leaf
    uploads/s, the leaf chunks' event ms (CUDA events), one chunk's device
    time (profiler) against its wall, the wire bytes a client against the
    plain sketch's, the host mask ms and the counters.
(q) the rest of the LLM trainer and model at Llama-3-8B's widths, random
    weights from a seed, the repo's synthetic LM tokens at T=2048. (q1) full
    fine-tuning (``lora_rank: 0``, f32 weights, remat full) at 10 layers
    through ``LLMTrainer``: 4 steps on one batch and an eval; it fails
    unless the loss falls, every parameter moved (norm scales and the
    embedding included), the flash launches are the predicted count and the
    peak stays under 74 GiB, and prints s a step, tokens/s, model TFLOP/s,
    the grouped AdamW update's ms (CUDA events) against its 28 B-a-parameter
    floor and the peak. (q2) the full-parameter federation through
    FedLLMAPI's host loop at 1 layer: 2 clients x 2 steps, 2 rounds, a
    checkpoint of every parameter after round 0; then that checkpoint
    restored into a fresh FedLLMAPI (AdamW's moments, which no checkpoint
    carries, from a snapshot) and round 1 run again; it fails unless the
    restore and the resumed round's global state and test loss are bit for
    bit the uninterrupted run's, and prints s a round, the exchange and
    aggregation ms, the checkpoint's bytes and save/restore ms and the peak.
    (q3) an 8-expert top-2 MoE at 16 layers over a bf16 base, LoRA rank 16,
    through the on-device round (4 clients x 2 steps, 2 rounds); it fails
    unless the loss of round 0's training batches falls below the untrained
    model's, the routers moved and the experts did not, the aux term is
    counted once, layer 0's routing on the CPU differs in at most 0.1% of
    tokens and the launches are the predicted count, and prints s a round,
    tokens/s, the assignments dropped by capacity, the per-expert load and
    the peak.
(r) the span layer (``telemetry``; no kernel of its own), each leg into a
    fresh temporary ``log_file_dir`` whose run dir ``python -m
    fedml_tpu_torch.cli telemetry report`` must read in a child process
    with exit 0. Each leg's untraced twin (``untraced``) runs the same
    entry points with a memory-only tracer whose spans set no context and
    with ``sys_perf_profiling: false``. (r1) phase h's round on a
    thirty-second of its training images (R1_DATA) untraced (and with ``FEDML_PROFILE=0``:
    phase s2's twin) and then traced, under cuDNN's
    deterministic algorithms: it fails unless ``spans.jsonl`` holds
    ``round/0/{sample,train,aggregate,eval}`` and one
    ``round/0/client/<id>/train`` a client, the report's round wall lies
    within R_WALL_TOL of the host-timed round and the final parameters'
    digests are equal; it prints both rounds' walls, the phase spans
    against the round's wall and the µs of one empty span (R_SPAN_BENCH).
    (r2) phase i2's federation on a quarter of its images (R2_TRAIN) under
    cuDNN's deterministic algorithms, traced (a server and 2 silos as
    processes in one run dir, silo R2_HELD_RANK held after the round and
    sent SIGTERM) while its untraced twin runs beside it on its own broker:
    it fails unless every rank's spans carry its ``service``, every
    silo-side ``comm/dispatch`` span carries the server's round trace id
    with a server span as parent, the report lists the silos' spans as
    stitched, the aggregate's digest equals the twin's and the held
    silo dies of SIGTERM leaving a ``sigterm`` flight-recorder dump whose
    last record names the signal; it prints the header and envelope bytes.
    (r3) FedLLMAPI's host loop at Llama-3-8B widths (R3_ARGS: 2 layers,
    LoRA rank 16, T=2048, 2 clients x 1 step, 1 round): it fails unless
    ``events.jsonl`` holds the round's event, the report's ``event/round``
    lies within R_WALL_TOL of the host-timed bracket and the flash
    launches counted around exactly ``train()`` are the predicted count.
(s) device-side profiling (``telemetry.profiling``, ``device_stats``; no
    kernel of its own). (s1) FedLLMAPI's fused round (S1_ARGS: phase e's
    round cut to 4 layers, 2 rounds) with a ``round/<n>/train`` span
    around each round and round 1 captured through
    ``MLOpsProfilerEvent.start_trace/stop_trace``, then the same 2 rounds
    with ``FEDML_PROFILE=0`` and no capture: it fails unless
    ``programs.jsonl`` holds ``llm/fused_round`` with FLOPs within
    S_FLOPS_TOL of 8 x ``train_step_flops`` and ``llm/train_step`` has no
    calls of its own, the report (read back in a child process) gives the
    round phase's FLOP/s within S_RATE_TOL of the script's FLOPs over its
    host-timed rounds and an MFU, round 1's trace holds the flash kernels as
    often as their launch counters (predicted 36 / 32 / 32) and stays under
    its byte budget, the controller is available and the capture holds
    kernel events, and the adapters and losses are bit-equal to the
    unprofiled rounds; it prints the trace bytes, the stop-and-export
    seconds and the µs of a cataloged call (S_NOOP_CALLS). (s2) phase r1's
    round with ``trace_rounds: "0"``: it fails unless ``sp/local_train``,
    ``compress/ef_encode`` (the int8 uplink's error-feedback encode) and
    ``sp/evaluate`` have their calls, ``health.jsonl`` has ``mem_sample``
    records with card bytes for train, aggregate and eval, the capture
    holds kernel events, the report has its attribution section and the
    digest equals the unprofiled twin's (r1's untraced leg, run with
    ``FEDML_PROFILE=0``, when phase r ran).
(t) run health (``telemetry.health``'s tracker, ``telemetry.doctor``; no
    kernel of its own), each leg into a fresh run dir that ``python -m
    fedml_tpu_torch.cli telemetry doctor --json`` reads in a child process.
    (t1) phase h's ResNet-18 with int8 uplinks on T1_DATA, 5 clients, 5
    rounds, client T_SLOW sleeping T_SLOW_S after its training and client
    T_NOISY uploading T_NOISY_SCALE x its delta: it fails unless
    ``health.jsonl`` holds a ``client_health`` record for each of the 25
    (round, client) pairs with a finite update norm read off the int8
    blocks, the doctor flags exactly [T_SLOW] as a straggler and [T_NOISY]
    as anomalous and its verdict names both, a ``train`` ``mem_sample``
    holds card bytes every round, and the report's client health lists the
    5 clients; it prints the median client wall, both scores, the tracker's
    µs an ``observe`` and a ``finish_round`` and the doctor's seconds. (t2)
    phase k1's masked federation on a quarter of its images (T2_PARTS),
    its deadline multiplier T2_DEADLINE_MULTIPLIER: it
    fails unless the doctor's secagg section holds ``recovery_started`` and
    ``recovery_closed`` of round 1 evicting [SECAGG_STALL_RANK] and its
    verdict names the recovery, the connectivity section holds the eviction,
    the flight recorder's ring holds ``collect``, ``recover`` and
    ``unmask`` markers with ``individual_plaintext: false``, every masked
    upload's ``client_health`` has no update norm and a latency, and no
    ``secagg/phases`` counter exists. (t3) phase n1's tree cut to T3 (64
    clients, 4 tiers, 3 rounds), leaf clients T3_KILLS dead in round 1: it
    fails unless there is one ``client_health`` record a leaf-parent edge a
    round, the tier-tagged ``resilience_event`` records add up to the
    ``tier/<d>/evicted`` and ``rejoined`` counters, and the doctor's tiers
    section lists the kills; it prints the flagged edges (not gated).
    Phase t runs after q and before r, so that its last doctor child runs
    beside phase r.
(u) causal tracing and the live plane (``telemetry.tracing``,
    ``telemetry.live``; no kernel of its own), between m1 and m2. (u1) phase h's ResNet-18 with int8 uplinks on U_TRAIN (T1_DATA
    over U_SILOS silos), a server and the silos as OS processes over the
    TCP broker, U_ROUNDS rounds, the live plane on (``metrics_port: 0``,
    ``trace_streaming``), silo U_SLOW sleeping U_SLOW_S after its training
    in rounds U_SLOW_ROUNDS and silo 1 U_BASE_S in every round; it runs
    alone, as it gates on times. It fails unless a scrape of the server's
    ``/metrics``, taken while the run is in flight and before the last round
    closed, holds the job, ``node="rank0"`` with ``health_rounds_scored``
    and every silo's node; ``telemetry.jsonl`` holds a straggler
    ``doctor_alert`` for client U_SLOW at round 2, written before the run
    ended; the capture that alert armed covers round 3 and holds CUDA
    kernel events; the collector's rank0 totals equal the server's registry
    after the run and a replayed final frame is refused; ``spans_remote.jsonl``
    holds every silo's spans, each silo's clock ``paired`` or ``one_way``
    with an uncertainty; every round's critical path covers 95-100% of its
    wall; and in rounds 1-4 client U_SLOW is on the path exactly in the
    slowed rounds, with a straggler what-if of at least half U_SLOW_S. It
    prints the scrape's ms, the µs of a silo's frame pop and the bytes of a
    frame, each node's clock, each round's path and the capture's bytes
    and start and stop-and-export seconds. u1's twin (the plane off, no
    sleeps) runs beside m2 and must end on u1's digest. (u2) phase t3's
    tree under
    ``TreeRunner(live=LivePlane(..., metrics_port=0))``: it fails unless a
    scrape between rounds holds ``node="tree_root"`` tier metrics, the
    collector's ``tier/*`` instruments equal the registry's at close, the
    root's seq is at least 3, and ``tree U2_CLI_ARGS --metrics-port 0``, in
    a child process beside m2, completes. (u3) ``telemetry trace --json
    --perfetto`` and ``telemetry watch --once`` over u1's run dir, as
    children started after u1 (beside m2): the child's per-round coverage must equal u1's, the Perfetto file
    must load with the critical-path track and the watch must name client
    U_SLOW.
    Each phase prints its seconds. The phases whose work is child processes
    run in a thread beside the in-process phases that follow them, none of
    which gates on a time, reads a counter they move or has its own
    deadline: i2 beside j, k2 beside k3, k4, l1 and l2, m1 beside l3, l4
    and l5, o beside n, r2 beside r3 and s, u1's twin, u2's command and
    u3's readers beside m2; their times and those of the
    phases beside them are taken under that load. The report and doctor
    children of phases r, s and t run beside the legs after theirs, and
    their checks run after the last phase (``children``).

The last lines are the card line, one ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``, after the whole script's seconds.
Without a CUDA device the script exits with code 2 and prints no result;
with one, it runs itself again under ``PYTHONHASHSEED=0`` unless that is
set, so every phase and every process it starts draws the same CIFAR-10
stand-in. The full per-shape results also go to
``results/chip_smoke.json``. ``--phases d`` (any subset of ``bcdefghijklmnopqrstu``) runs
(a) and the phases named, and prints no kernels or ok line (phase g sets
its round beside phase e's only when both run). ``--parent DIR`` builds the dequant and flash-forward kernels of
another checkout (DIR, e.g. the parent commit unpacked by ``git archive``)
and times them beside this tree's in phases b and d.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# (H, F) of every int8 projection of Llama-3-8B and how often one forward
# pass calls it: q/o 4096x4096, k/v 4096x1024, gate/up 4096x14336,
# down 14336x4096 in each of 32 layers, and the LM head 4096x128256
SLICE_SHAPES = {
    (4096, 4096): 2 * 32,
    (4096, 1024): 2 * 32,
    (4096, 14336): 2 * 32,
    (14336, 4096): 32,
    (4096, 128256): 1,
}
ROWS = (1, 8, 16, 32, 64, 128)   # decode slots and the serve path's prefill buckets
DECODE_ROWS = 8                 # the serve phase decodes 8 slots
LAUNCHES_PER_PASS = sum(SLICE_SHAPES.values())  # 225
N_REQUESTS, N_CONCURRENT, NEW_TOKENS = 8, 4, 32
KERNEL_SOURCES = ("dequant_matmul", "flash_attention")

# Flash attention at Llama-3-8B's heads (B=1, H=32 over Hkv=8, head_dim 128):
# (T, S, causal) — the training path's shape, one ragged against the 64-row
# tiles, one non-causal, one with T != S (top-left causal alignment)
FLASH_HEADS = (1, 32, 8, 128)
FLASH_SHAPES = ((2048, 2048, True), (1000, 1000, True), (512, 512, False),
                (256, 512, True))
# bf16 outputs and gradients are held row by row (see row_rel_err): every
# row's error within ROW_TOL of that row's own norm. The kernels round p and
# ds to bf16 before the second product of each pair (the plain versions keep
# f32) and round the result once, each ~2^-9 of relative noise; 2^-6 leaves
# a margin of ~4x, while a fault that drops one 64-key tile of a late row
# (~18% of its terms) misses it by ~10x. Rows below ROW_FLOOR of a typical
# row are held to that floor. lse sees no bf16 rounding (exact products, f32
# sums, fast exp): 1e-3 absolute.
ROW_TOL, ROW_FLOOR, LSE_TOL = 2.0 ** -6, 1e-3, 1e-3
# planted faults the row check must catch at the path's shape, T=S=2048
# causal: dk/dv that skips the last 64-row q tile, and dq that drops keys
# [128, 192) for rows from 512 on; the old limit (2e-2 of the tensor's
# largest magnitude) is printed beside the row check for comparison
FAULT_Q_TILE, FAULT_KEYS, FAULT_ROW0, OLD_REL_TOL = 64, (128, 192), 512, 2e-2
# dequant outputs row by row: both versions add exact products in f32 and
# round once to bf16 (2^-9 relative at most), so each row within 2^-8 of
# its own norm; planted faults at two split-K shapes must fail that check
DEQUANT_ROW_TOL = 2.0 ** -8
DEQUANT_FAULT_SHAPES = ((4096, 1024), (14336, 4096))

# Phase (e): federated LoRA rounds of Llama-3-8B at full width and depth
# (random bf16 base from seed 0, the repo's synthetic Markov token stream)
# through FedLLMAPI's on-device round; remat off, as the JAX bench runs it
TRAIN_ARGS = dict(
    model_size="llama3_8b", lora_rank=16, base_params_bf16=True, remat_policy="none",
    use_flash_attention=True, max_seq_length=2048, per_device_batch_size=1,
    client_num_in_total=8, client_num_per_round=4, local_steps_per_round=2,
    comm_round=2, on_device_round=True, vocab_size=128256, train_size=32,
    test_size=2, random_seed=0, learning_rate=1e-4, frequency_of_the_test=1)
# layer 0's attention (o_proj output per token, each LoRA gradient per rank
# component) through the kernels vs their plain versions, and every layer's
# flash output on the model's own activations, row by row within ROW_TOL;
# the whole model's loss on one batch within 1e-3 relative (17x the 5.9e-5
# measured on an H100)
LOSS_REL_TOL = 1e-3

# Phase (f): the w8a8 product's row counts (decode 1 and 8, both sides of
# torch._int_mm's 16-row limit, a prefill bucket and a long prefill), the
# 4-bit formats, and the serve runs of phase (f)
W8A8_ROWS = (1, 8, 16, 17, 128, 2048)
PASS_ROWS = (8, 128)
QUANT_SERVE_MODES = ("w8a8", "nf4")
# steady decode steps timed a served format (30 until phase t, which this
# cut pays for: f's serve legs gate on their tokens, not on the step time)
F_DECODE_STEPS = 10
QUANT_REQUESTS, QUANT_CONCURRENT, QUANT_NEW_TOKENS = 4, 2, 16
# layer 0's seven kernels and the LM head, by parameter name
LAYER0_KERNELS = {
    "layer_0.attn.q_proj.kernel": (4096, 4096), "layer_0.attn.k_proj.kernel": (4096, 1024),
    "layer_0.attn.v_proj.kernel": (4096, 1024), "layer_0.attn.o_proj.kernel": (4096, 4096),
    "layer_0.mlp.gate_proj.kernel": (4096, 14336), "layer_0.mlp.up_proj.kernel": (4096, 14336),
    "layer_0.mlp.down_proj.kernel": (14336, 4096), "lm_head": (4096, 128256),
}
# Phase (g): the QLoRA round's peak memory must sit at least this far below
# the bf16 round's (linear weights 15.0 GB in bf16, 4.22 GB in nf4)
QLORA_PEAK_MARGIN_GB = 5.0

# Phase (h): the single-process FedAvg simulation (ROADMAP A8 + A9):
# ResNet-18 with GroupNorm (2 groups) at full width on load_cifar10's
# stand-in at CIFAR-10's size (50,000 train and 10,000 test images of
# 32x32x3, 10 classes), 10 of 10 clients (hetero, alpha 0.5), batch 32, one
# local epoch of SGD at lr 0.1 (fedml_tpu/config/cross_silo/fedml_config.yaml),
# int8 uplinks with error feedback, 1 round with a test after it (3 until
# phase l came; the rounds were cut to keep the whole script under its
# 1,200 s, and the test loss is held below the untrained model's, as k1's;
# half the clients a round left it barely below: 2.8268 against 2.8374). The
# simulation runs convolutions and matmuls in full FP32 (TF32 off: the
# port's default for it). From the run's final weights one client's
# SP_CPU_STEPS steps run on the card, on the CPU and in float64 on the card;
# the card's float32 result must lie within SP_PARAM_TOL of each leaf's
# largest magnitude (floored at 1) of both. Four SGD steps at lr 0.1 on this
# unnormalized stand-in amplify rounding ~1e4-fold: on an H100's host CPU
# float32 landed 3.6e-4 to 7.0e-4 from float64 from trained weights, and
# 4.9e-3 from the initial ones, where the first step lifts the loss from
# ~3.4 to ~20; the stand-in differs per process (``hash`` in its seed), so
# the factor does too. TF32 rounds each product's inputs 8192 times coarser
# (2^-11 against 2^-24), which this amplification would carry to the
# weights' own scale: 1e-2 sits well above float32's spread and far below
# TF32's or a wrong kernel's.
SP_CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "cifar10", "train_size": 50_000, "test_size": 10_000,
                  "partition_method": "hetero", "partition_alpha": 0.5},
    "model_args": {"model": "resnet18", "group_norm_channels": 2},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 10,
                   "client_num_per_round": 10, "comm_round": 1, "epochs": 1,
                   "batch_size": 32, "learning_rate": 0.1, "compression": "int8",
                   "frequency_of_the_test": 1},
}
SP_CPU_STEPS = 4
SP_PARAM_TOL = 1e-2
SP_FUSED_REL_TOL = 1e-6
SP_PROFILE_STEPS = 20
SP_CODECS = ("int8", "nf4")

# Phase (i), cross-silo FedAvg: phase h's model, data and training
# (``fedml_tpu/config/cross_silo/fedml_config.yaml``'s recipe at ResNet-18
# scale) over 4 silos, each training one of 16 hetero parts a round (a
# quarter of the data until the script neared its 1,200 s), int8 uplinks
# with error feedback, 2 rounds on the in-process LOCAL transport (i1); then
# one round of 2 silos, each on one of CS_BROKER_PARTS parts, over the TCP
# broker and the object store with the server and each silo in its own OS
# process (i2), started through the entry points with a config the phase
# writes. i2's processes share a fixed PYTHONHASHSEED: the stand-in's seed
# has ``hash("cifar10")`` in it, salted per process, and the three must draw
# the same data. An int8 upload carries 1 byte an element plus one f32 scale
# a leaf: 4.00x smaller than f32 for this model, so 3.9x is the floor.
CS_CONFIG = {
    "common_args": {"training_type": "cross_silo", "random_seed": 0,
                    "run_id": "chip_smoke_cross_silo"},
    "data_args": {"dataset": "cifar10", "train_size": 50_000, "test_size": 10_000,
                  "partition_method": "hetero", "partition_alpha": 0.5},
    "model_args": {"model": "resnet18", "group_norm_channels": 2},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 16,
                   "client_num_per_round": 4, "comm_round": 2, "epochs": 1,
                   "batch_size": 32, "learning_rate": 0.1, "compression": "int8"},
    "comm_args": {"comm_backend": "LOCAL"},
}
CS_WIRE_RATIO = 3.9
CS_BROKER_SILOS = 2
CS_BROKER_PARTS = 8
CS_BROKER_TIMEOUT_S = 480        # i2: every process exits 0 within this
CS_HASHSEED = "0"
CS_TIMED_REPS = 5

# Phase (j), the aggregation-side trust stack (ROADMAP A10.2a) on phase h's
# model and data. j1: the sp simulation, 10 of 10 clients, int8, 2 rounds,
# ``integrity: true`` with ``agg_robust: trimmed_mean@0.2``
# (docs/integrity.md's recipe); round 0's upload of TRUST_NAN_CLIENT
# arrives with a NaN scale and TRUST_SCALED_CLIENT's ×100. The norm and z
# screens are opened, as the reference's acceptance opens them, so the
# ×100 upload reaches the robust statistic (the non-finite rule is
# unconditional): it must be contained, the distance from the honest
# uploads' weighted mean within TRUST_CONTAIN of the plain weighted mean's.
# j2: one sp round on the decode fallback, byzantine (random) on 2 of 10
# with krum, then each registered defense timed on that round's 10 updates.
# j3: cross-silo in process, 4 silos each on one of 40 parts (10 before
# phase s came, which this cut pays for; j3 gates on no test loss), 1 round,
# ``integrity: true`` with
# norm-difference clipping (bound TRUST_NORM_BOUND) and local DP (ε 8,
# δ 1e-5, sensitivity 1e-3: noise of σ 6.1e-4, ~2.0 of L2 over the model).
# j1 and j2 draw a quarter of the stand-in's training images (12,500, the
# test set whole) to keep the script inside its 1,200 s on a slow host:
# their three full-size sp rounds took 53-66 s each on an H100 host that ran
# the host-bound phases ~25% slower than others, and at half the images
# (25,000) the whole script still ran 1,395 s on such a host.
TRUST_DATA = {**SP_CONFIG["data_args"], "train_size": 12_500}
# j2 on an eighth (6,250; a quarter until phase t, which this cut pays for:
# j2 gates on krum keeping a benign update, not on the test loss)
TRUST_DECODE_DATA = {**TRUST_DATA, "train_size": 6_250}
TRUST_SP_CONFIG = {**SP_CONFIG, "data_args": TRUST_DATA, "train_args": {
    **SP_CONFIG["train_args"], "comm_round": 2, "integrity": True,
    "agg_robust": "trimmed_mean@0.2", "integrity_norm_mult": 1e6,
    "integrity_z_threshold": 1e6}}
TRUST_DECODE_CONFIG = {**SP_CONFIG, "data_args": TRUST_DECODE_DATA, "train_args": {
    **SP_CONFIG["train_args"], "comm_round": 1, "enable_attack": True,
    "attack_type": "byzantine", "attack_mode": "random", "byzantine_client_num": 2,
    "enable_defense": True, "defense_type": "krum", "krum_param_k": 1}}
TRUST_NORM_BOUND = 2.0
TRUST_CS_CONFIG = {**CS_CONFIG, "common_args": {
    **CS_CONFIG["common_args"], "run_id": "chip_smoke_trust"}, "train_args": {
    **CS_CONFIG["train_args"], "client_num_in_total": 40, "comm_round": 1,
    "integrity": True, "enable_defense": True, "defense_type": "norm_diff_clipping",
    "norm_bound": TRUST_NORM_BOUND, "enable_dp": True, "dp_solution_type": "LDP",
    "epsilon": 8.0, "delta": 1e-5, "sensitivity": 1e-3}}
TRUST_NAN_CLIENT, TRUST_SCALED_CLIENT, TRUST_SCALE = 3, 7, 100.0
TRUST_CONTAIN = 0.1

# Phase (k), secure aggregation (ROADMAP A10.2b) on phase h's model and data:
# ResNet-18 GroupNorm at full width on the CIFAR-10 stand-in, split into 20
# hetero parts (alpha 0.5; 10, as phase h, until the script neared its
# 1,200 s), each silo training one part a round. k1: docs/privacy.md's
# recipe (secagg: int8, clip 0.1, mod_bits 8) on 4 silos over LOCAL, 2
# rounds, round_quorum 0.75 and a deadline (the static ceiling for round 0,
# twice the median latency after); silo
# SECAGG_STALL_RANK's trainer stalls in round 1 until the server has closed
# it, so round 1 closes at quorum through the seed-reveal recovery. k2: the
# same recipe, a server and 2 silos as processes over the broker, 1 round.
# k3: the Bonawitz FSM (secure_aggregation: true, the example's
# secagg_threshold: 2) on 3 silos, rank 3 dropping after the share exchange,
# 1 round; sa_q_bits 12, because the 31-bit field leaves |x| < 0.33 at the
# reference's 16 bits for CIFAR-10's 50,000 samples (sa_q_bits 12: < 5.2).
# k4: LightSecAgg on 3 silos, 1 round (the reference's defaults). k3 and
# k4 train one of 40 parts a silo (10 before phase s came, which this cut
# pays for; they gate on the field sums, not on the test loss).
SECAGG_TRAIN = dict(client_num_in_total=20, compression="", secagg="int8",
                    secagg_clip=0.1, secagg_mod_bits=8)
SECAGG_CONFIG = {**CS_CONFIG, "common_args": {
    **CS_CONFIG["common_args"], "run_id": "chip_smoke_secagg"}, "train_args": {
    **CS_CONFIG["train_args"], **SECAGG_TRAIN, "comm_round": 2, "round_quorum": 0.75,
    "round_deadline_s": 240.0, "round_deadline_multiplier": 2.0}}
SECAGG_STALL_RANK = 4
SECAGG_BROKER_SILOS = 2
# k2 trains one of 80 parts a silo (20 until phase t, which this cut pays
# for; k2 gates on one round of masked uploads, not on the test loss)
SECAGG_BROKER_PARTS = 80
MPC_TRAIN = dict(client_num_in_total=40, client_num_per_round=3, comm_round=1,
                 compression="")
BONAWITZ_CONFIG = {**CS_CONFIG, "common_args": {
    **CS_CONFIG["common_args"], "run_id": "chip_smoke_bonawitz"}, "train_args": {
    **CS_CONFIG["train_args"], **MPC_TRAIN, "secure_aggregation": True,
    "secagg_threshold": 2, "sa_simulate_dropout_rank": 3, "sa_q_bits": 12}}
LSA_CONFIG = {**CS_CONFIG, "common_args": {
    **CS_CONFIG["common_args"], "run_id": "chip_smoke_lightsecagg"}, "train_args": {
    **CS_CONFIG["train_args"], **MPC_TRAIN}}

# Phase (l), round checkpoints, contribution assessment and the
# reconstruction attacks (ROADMAP A10.2c + A4's checkpoints). l1: phase e's
# Llama-3-8B rounds through FedLLMAPI's host loop (on_device_round: false),
# with norm-difference clipping live around every client's payload (its
# bound above the adapters' norm, so the hook runs and the rounds train as
# e's) and a checkpoint every round; each client holds 2 sequences, so 2
# local steps at batch 1. l2: ``serve --checkpoint`` of l1's last round
# (int8, LoRA rank 16), 2 HTTP requests of 8 new tokens. l3: phase h's
# ResNet-18 on the CIFAR-10 stand-in cut to 50 IID clients of 1,000 images,
# 4 a round, FedOpt (server sgd, momentum 0.9), the utility's test set cut
# to 2,000 images, GTG-Shapley (exact at 4 clients) with one client's
# labels all flipped to class 0; 3 rounds uninterrupted, then 1 round, a restart with
# resume and 2 more, both from one global model warmed up by CONTRIB_WARMUP
# rounds of 10 clients (from scratch the first rounds leave ResNet-18 near
# chance, where a coalition's accuracy moves by chance more than by a
# client: one call valued an honest client below the flipped one). l4: 4 silos over LOCAL on l3's data, 1 round with
# leave-one-out valuation, then a restarted server resumes for round 1.
# l5: DLG (60 iterations, cosine; 300 until phase t, which this cut pays
# for: the gate is a falling match loss) on ResNet-18 against one stand-in
# image, and revealing_labels at init from a batch of 32.
FEDLLM_HOST_ARGS = {**TRAIN_ARGS, "on_device_round": False, "train_size": 16,
                    "epochs": 1, "enable_defense": True,
                    "defense_type": "norm_diff_clipping", "norm_bound": 1e4,
                    "save_every_rounds": 1}

# Phase (q): the rest of the LLM trainer and model at Llama-3-8B's widths.
# (q1) full fine-tuning, f32 weights: 16 B a parameter of weights, gradients
# and AdamW moments, so 32 layers (~128 GB) do not fit one card; 10 layers
# (3.23 B parameters, ~52 GB of state) do, under Q1_PEAK_GIB. The steps
# train on one batch: the synthetic stream's marginal is uniform and its
# bigrams are local to each sequence's token range, so a few steps move the
# loss of other sequences by less than its noise (one H100 run, 700 W:
# 12.575, 12.560, 12.583, 12.628 over four fresh batches at lr 1e-4)
Q1_ARGS = dict(model_size="llama3_8b", num_hidden_layers=10, lora_rank=0,
               remat_policy="full", use_flash_attention=True, max_seq_length=2048,
               per_device_batch_size=1, vocab_size=128256, train_size=1, test_size=1,
               client_num_in_total=1, random_seed=0, learning_rate=5e-5,
               max_grad_norm=1.0)
Q1_STEPS, Q1_PEAK_GIB = 4, 74
# (q2) the full-parameter federation through FedLLMAPI's host loop: the
# clients' payloads, the global state and the aggregate are each a whole f32
# model on the card (5.1 GB at 1 layer), as the reference holds them; 2
# clients x 2 local steps (2 samples each at batch 1), 2 rounds, round 0
# checkpointed (save_every_rounds 2: the resume reads round 0's). Phase t
# paid with two cuts here: the model at 1 layer (2 until then: 5.9 GB), and
# round 1's ~12 s save, which nothing read
Q2_ARGS = dict(model_size="llama3_8b", num_hidden_layers=1, lora_rank=0,
               remat_policy="none", use_flash_attention=True, max_seq_length=2048,
               per_device_batch_size=1, vocab_size=128256, client_num_in_total=2,
               client_num_per_round=2, train_size=4, test_size=1, epochs=1,
               comm_round=2, on_device_round=False, random_seed=0, learning_rate=1e-4,
               frequency_of_the_test=1, save_every_rounds=2)
# (q3) an 8-expert top-2 MoE over a bf16 base (2.90 GB a layer): 16 layers
# (~48.5 GB), since 32 would need ~95 GB; LoRA rank 16 and the routers train
Q3_ARGS = dict(model_size="llama3_8b", num_hidden_layers=16, num_experts=8,
               num_experts_per_tok=2, moe_capacity_factor=1.25, lora_rank=16,
               base_params_bf16=True, remat_policy="full", use_flash_attention=True,
               max_seq_length=2048, per_device_batch_size=1, vocab_size=128256,
               client_num_in_total=8, client_num_per_round=4, local_steps_per_round=2,
               comm_round=2, on_device_round=True, train_size=32, test_size=2,
               random_seed=0, learning_rate=1e-3, frequency_of_the_test=1)
SERVE_CKPT_REQUESTS, SERVE_CKPT_NEW_TOKENS = 2, 8
CONTRIB_CONFIG = {**SP_CONFIG, "data_args": {
    **SP_CONFIG["data_args"], "partition_method": "homo"}, "train_args": {
    **SP_CONFIG["train_args"], "federated_optimizer": "FedOpt", "server_optimizer": "sgd",
    "server_lr": 1.0, "server_momentum": 0.9, "client_num_in_total": 50,
    "client_num_per_round": 4, "comm_round": 3, "compression": "",
    "enable_contribution": True, "contribution_method": "gtg_shapley"}}
CONTRIB_TEST_IMAGES = 2000
CONTRIB_WARMUP = 3
# a resumed ResNet-18 run against the uninterrupted one: bit for bit under
# cuDNN's deterministic algorithms (the phase asks for them); were they not
# deterministic, the phase would say so and hold this bound of each leaf's
# largest magnitude instead
RESUME_BOUND = 1e-5
CS_RESUME_CONFIG = {**CS_CONFIG, "common_args": {
    **CS_CONFIG["common_args"], "run_id": "chip_smoke_resume"}, "data_args": {
    **CONTRIB_CONFIG["data_args"]}, "train_args": {
    **CS_CONFIG["train_args"], "client_num_in_total": 50, "client_num_per_round": 4,
    "comm_round": 1, "enable_contribution": True, "contribution_method": "leave_one_out"}}
DLG_ITERS, REVEAL_BATCH = 60, 32

# Phase (m), the durable cross-silo server and the async server (ROADMAP
# A10.3a/b/d) on phase h's model and data, split into DURABLE_PARTS hetero
# parts (alpha 0.5; each silo trains one part a round, so a round takes
# seconds, not minutes). m1: phase i2's broker federation (a server and 2
# silos as processes, CS_HASHSEED) through the rank entry point of
# ``resilience/durability/recover`` with ``durability: true``, the identity
# codec and 2 rounds; the kill window fires in round 1 after 1 journaled
# upload; and int8 uplinks for 2 rounds; both supervised federations run at
# once, beside the uninterrupted in-process run of the identity federation
# (the three share the card and the host). m2: 4
# silos over LOCAL, int8, FedBuff (a buffer of 4, 8 updates),
# ``durability: true``; then the journal refill after 2 of 4 buffered
# uploads, and an instant-apply run of 4 updates that checkpoints every
# version. m2's parts are IID: the async server hands each silo the same
# part every update, and on a hetero split the fastest silo's (smallest,
# most skewed) part takes most of the updates and the test loss rose above
# the untrained model's (2.86 -> 3.15 in one card run, 9 of 12 updates
# from one silo).
DURABLE_PARTS = 20
DURABLE_CONFIG = {**CS_CONFIG, "common_args": {
    **CS_CONFIG["common_args"], "run_id": "chip_smoke_durable", "device": "cuda"},
    "train_args": {**CS_CONFIG["train_args"], "client_num_in_total": DURABLE_PARTS,
                   "client_num_per_round": 2, "comm_round": 2, "compression": "identity",
                   "durability": True, "resume": True}}
DURABLE_KILL = {"round": 1, "after_uploads": 1}
DURABLE_INT8_ROUNDS = 2
DURABLE_TIMEOUT_S = 300
ASYNC_CONFIG = {**CS_CONFIG, "common_args": {
    **CS_CONFIG["common_args"], "run_id": "chip_smoke_async"}, "data_args": {
    **CS_CONFIG["data_args"], "partition_method": "homo"}, "train_args": {
    **CS_CONFIG["train_args"], "client_num_in_total": DURABLE_PARTS,
    "client_num_per_round": 4, "async_aggregation": True, "async_buffer_size": 4,
    "async_total_updates": 8, "durability": True}}
ASYNC_INSTANT_UPDATES = 4

# what the uninterrupted run of phase (m1) runs in a child process (the same
# PYTHONHASHSEED as the supervised ranks, the same cuDNN setting as the
# rank entry point): the in-process federation over LOCAL, its digest and
# result, and the untrained model's test loss
DURABLE_REF_CHILD = r"""
import json, sys
import torch
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
import fedml_tpu_torch
from fedml_tpu_torch.arguments import load_arguments_from_dict
from fedml_tpu_torch.cross_silo.message_define import MyMessage
from fedml_tpu_torch.cross_silo.run_inproc import (build_cross_silo_inproc,
                                                  run_managers_to_completion)
from fedml_tpu_torch.data.data_loader import load_federated
from fedml_tpu_torch.models.model_hub import create
from fedml_tpu_torch.resilience.durability.recover import digest
with open(sys.argv[1]) as f:
    args = fedml_tpu_torch.init(load_arguments_from_dict(json.load(f)))
ds = load_federated(args)
server, clients = build_cross_silo_inproc(args, ds, create(args, ds.class_num), "cuda")
untrained = server.fedml_aggregator.test_on_server_for_all_clients(-1)["test_loss"]
result = run_managers_to_completion([server.manager] + [c.manager for c in clients],
                                    args.run_id, MyMessage.MSG_TYPE_CONNECTION_IS_READY, 600)
print("REF " + json.dumps({"digest": digest(server.fedml_aggregator.get_global_model_params()),
                           "result": result, "untrained_test_loss": untrained}), flush=True)
"""

# Phase (n), the aggregation tree (ROADMAP A10.3c), int8 at every tier. n1:
# TreeTopology.build(64, 4) (levels 1, 4, 16, 64; 256 clients until phase
# t, 128 until the phases ran beside each other: n1 gates on digests, the
# restart and the eviction, not on a loss) with phase h's ResNet-18
# in the reference's layout as the template (62 leaves, 11,173,962
# parameters, from random_seed alone: the tree draws no stand-in images),
# seed 0, quorum 0.75, chunks of 8 clients, 2 rounds; leaf client 17 dead in
# round 0 (evicted, rejoins in round 1), and tier-1 node 0 crashed in round 1
# after 1 accepted partial sum and restarted from its journal. n2: the
# reference's 100k-client acceptance (tests/test_hierarchy.py) through the
# ``tree`` command in a child process, replayed in process beside it. n3:
# per-edge-cohort SecAgg on (1, 4, 16) with the ResNet-18 template, seed 3,
# quorum 0.5, chunks of 4, leaf client 5 dead in round 1, 2 rounds, twice.
TREE_N1 = dict(clients=64, tiers=4, seed=0, quorum=0.75, chunk=8, rounds=2)
TREE_N1_LEVELS = (1, 4, 16, 64)
TREE_N1_KILL = (3, 17, 0)          # KillWindow(tier, node, round)
TREE_N1_EDGE_KILL = (1, 0, 1, 1)   # EdgeKillWindow(tier, node, round, after_children)
TREE_N2_ARGS = ("--clients", "100000", "--tiers", "3", "--rounds", "2", "--params", "128",
                "--codec", "int8", "--quorum", "0.5", "--kill-tier", "1", "--kill-node", "3",
                "--kill-round", "1")
TREE_N3 = dict(levels=(1, 4, 16), seed=3, quorum=0.5, chunk=4, rounds=2)
TREE_N3_KILL = (2, 5, 1)
TREE_PEAK_FRAC = 0.05   # no tier buffers 5% of the clients' f32 trees (the reference's gate)
TREE_WIRE_FRAC = 0.35   # an int8 upload under 0.35 of the f32 tree (the reference's gate)
TREE_CLI_TIMEOUT_S = 600

# Phase (o), the other transports and cross-cloud (ROADMAP A10.4): phase i2's
# federation (phase h's model and data in CS_BROKER_PARTS hetero parts, a
# part a silo), three legs of a server and O_SILOS silos at once: tRPC, the
# cross-cloud federation over the C++ broker and the S3 stub, and gRPC. The
# legs differ only in transport, so they must end digest-equal. On 2 of 20
# parts one round did not train: the test loss rose above the untrained
# model's on hetero parts (2.80187 -> 3.20508) and barely fell on IID ones
# (-> 2.78345), on the card.
O_PARTS = CS_BROKER_PARTS
O_SILOS = 2
O_TIMEOUT_S = 240
O_S3_KEYS = ("AKIDCHIPSMOKE", "chip/smoke+secret")
O_S3_REGIONS = ("us-east-1", "eu-west-1", "ap-northeast-1")  # the server's, each silo's
O_BROKER_TIMEOUT_S = 60   # deploy broker --native prints its address within this

# Phase (p), federated analytics (ROADMAP A10.5). p1: the ``fa`` command's
# FSM for every task, 6 clients, seed 0, on the card and on the CPU, and the
# frequency task with a 2 s deadline and quorum 0.5. p2: the reference's
# 102,400-client acceptance (tests/test_fa_sketch.py) cut to a quarter of
# its clients, 128 a cohort as there (levels (1, 800, 102400) until the
# phases ran beside each other; the counts, the threshold and the dead
# leaves scale with the clients): levels (1, 200,
# 25600), votevec@1024/3, vocab 512, 12 hot words at p 0.5, 32 words a
# client, threshold 0.02, central DP sigma 2.0, quorum 0.5, leaf clients 3,
# n/2 and n-5 and tier-1 node 1 dead, the root crashed after 2 children and
# journal-restarted; without SecAgg (the host Philox masks would take ~440 s
# at this geometry), twice. p3: ``fa --federation`` at 256 clients over 3
# tiers, SecAgg on (votevec@4096/3), against the same scenario unmasked.
FA_P1_TASKS = ("avg", "heavy_hitter_triehh", "union", "intersection", "cardinality",
               "frequency_estimation", "k_percentile_element", "histogram")
FA_P1_QUORUM = ("--task", "frequency_estimation", "--deadline-s", "2", "--quorum", "0.5")
FA_AVG_TOL = 1e-6   # avg on the card against the CPU (Python floats: exact so far)
FA_P2 = dict(n_clients=25_600, levels=(1, 200, 25_600), codec="votevec@1024/3", seed=0,
             vocab=512, n_hot=12, p_hot=0.5, words_per_client=32, hh_threshold_frac=0.02,
             quorum=0.5, dp_sigma=2.0)
FA_P2_DEAD_EDGE = 1
FA_P2_ROOT_CRASH_AFTER = 2
FA_P2_PROFILED_COHORT = 5   # a live edge's cohort, reduced once more under the profiler
FA_P3_ARGS = ("--federation", "--fed-clients", "256", "--fed-tiers", "3")
FA_P3_LEVELS = (1, 16, 256)
FA_COUNTERS = ("fa/rounds", "fa/quorum_rounds", "fa/deadline_fired", "fa/aborts",
               "fa/stale_submissions", "fa/screened", "resilience/restarts",
               "resilience/journal_salvaged", "resilience/journal_replays", "tier/2/evicted",
               "tier/2/contributions", "tier/1/evicted", "tier/0/quorum_closes",
               "tier/1/quorum_closes", "secagg/hier_recoveries", "secagg/hier_cohort_rounds")

# Phase (r): the span layer (``telemetry``) on three main paths, each leg
# into a fresh temporary ``log_file_dir`` read back by ``telemetry report``
# in a child process. r1: phase h's sp round, untraced then traced, both
# under cuDNN's deterministic algorithms, so the final parameters must be
# bit-equal; cut to a thirty-second of h's training images (R1_DATA; a
# sixteenth until phase t, which this cut pays for with s2's and t1's
# share: none of the three gates on the test loss): with h's
# own round as the untraced twin the whole script ran 1,093 s of its 1,200 s
# on an NVIDIA H100 80GB HBM3 at 700 W, with a quarter 1,121 s, and with an
# eighth 1,113 s on one host and 1,395 s on a slower one. r2: phase i2's
# federation on a quarter of its images (R2_TRAIN), traced with the silo of
# rank R2_HELD_RANK held after the round and sent SIGTERM, and untraced
# beside it at once (two brokers, six processes), both under cuDNN's
# deterministic algorithms, so the aggregates' digests must be equal; r3: FedLLMAPI's host loop at Llama-3-8B widths cut to
# 2 layers, LoRA rank 16, T=2048, 2 clients x 1 step, 1 round. A span's
# wall is host time: the report's round wall must lie within R_WALL_TOL of
# the host-timed round. R_SPAN_BENCH empty spans give the cost of one span
# on the card's host.
R1_DATA = {**SP_CONFIG["data_args"], "train_size": 1_562, "test_size": 2_500}
R_WALL_TOL = 0.05
R_SPAN_BENCH = 10_000
R2_HELD_RANK = 2
R2_TRAIN = 12_500
R3_ARGS = dict(model_size="llama3_8b", num_hidden_layers=2, lora_rank=16,
               base_params_bf16=True, remat_policy="none", use_flash_attention=True,
               max_seq_length=2048, per_device_batch_size=1, vocab_size=128256,
               client_num_in_total=2, client_num_per_round=2, train_size=2, test_size=1,
               epochs=1, comm_round=1, on_device_round=False, random_seed=0,
               learning_rate=1e-4, frequency_of_the_test=1, run_id="chip_smoke_r3")


# Phase (s), device-side profiling (ROADMAP A12b1). s1: phase e's round
# (TRAIN_ARGS) cut to S1_LAYERS layers, 2 rounds, round 1 captured through
# MLOpsProfilerEvent.start_trace/stop_trace, then the same 2 rounds with
# FEDML_PROFILE=0 and no capture. The catalog's FLOPs of llm/fused_round
# within S_FLOPS_TOL of 8 x train_step_flops (that formula also counts
# layer 0's q/k/v input gradients, which autograd skips: 0.87% over at 4
# layers); the report's round phase's FLOP/s within S_RATE_TOL of the
# script's own FLOPs over its host-timed rounds. s2: phase r1's round
# (R1_DATA) with trace_rounds "0", against r1's untraced twin (run with
# FEDML_PROFILE=0) when phase r ran, else against its own.
ALL_PHASES = "bcdefghijklmnopqrstu"
S1_LAYERS = 4
S1_ARGS = dict(TRAIN_ARGS, num_hidden_layers=S1_LAYERS, run_id="chip_smoke_s1")
S_FLOPS_TOL = 0.02
S_RATE_TOL = 0.05
S_NOOP_CALLS = 10_000
S_KERNEL_NAMES = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_kernel"}

# Phase (t), run health (ROADMAP A12b2): each leg into a fresh log_file_dir,
# triaged by ``python -m fedml_tpu_torch.cli telemetry doctor --json`` in a
# child process. t1: phase h's ResNet-18 with int8 uplinks on R1_DATA's
# images split IID over 5 clients (T1_DATA: on hetero parts a client's wall
# follows its data, and the gate is about the injected faults), 5 rounds,
# tested at rounds 0 and 4 (the engine always tests round 0); client T_SLOW
# sleeps T_SLOW_S after its local training and client T_NOISY uploads
# T_NOISY_SCALE x its delta. T_SLOW_S: 2.5x the median honest client wall
# measured at this size is 0.88 s (350.4 ms on an NVIDIA H100 80GB HBM3 at
# 700 W); 1.5 s leaves room for a host twice as slow (on twice the images
# one host measured 354.2 ms and a slower one 760.8 ms, where a 0.9 s sleep
# scored 2.08 against the 2.0 threshold). t2: phase k1's masked federation (SECAGG_CONFIG, 4 silos, 2
# rounds, silo SECAGG_STALL_RANK stalled in round 1) on a quarter of its
# images (T2_PARTS parts, one a silo), its adaptive deadline at
# T2_DEADLINE_MULTIPLIER x the latency EWMA (the honest silos' round 1 takes
# about a third of round 0's first-call latency). t3: phase n1's four tiers cut to
# T3["clients"] clients and 3 rounds, leaf clients T3_KILLS dead in round 1.
T1_DATA = {**R1_DATA, "partition_method": "homo"}
T1_TRAIN = dict(client_num_in_total=5, client_num_per_round=5, comm_round=5,
                frequency_of_the_test=5)
T_SLOW = 1
T_SLOW_S = 1.5
T_NOISY = 3
T_NOISY_SCALE = 10.0
T2_PARTS = SECAGG_BROKER_PARTS   # a quarter of k1's images
T2_DEADLINE_MULTIPLIER = 1.0   # k1's 2.0 would keep round 1 open twice round 0's latency
T3 = dict(clients=64, tiers=4, seed=0, quorum=0.75, chunk=8, rounds=3)
T3_LEVELS = (1, 4, 16, 64)
T3_KILLS = ((3, 17, 1), (3, 40, 1))   # KillWindow(tier, node, round): leaf clients


# Phase (u), causal tracing and the live plane (ROADMAP A12c). u1: phase
# h's ResNet-18 with int8 uplinks on T1_DATA's images split IID over
# U_SILOS silos, a server and the silos as OS processes over the TCP broker
# (every process under cuDNN's deterministic algorithms), U_ROUNDS rounds,
# ``live_telemetry``, ``metrics_port: 0`` and ``trace_streaming`` on, each
# silo's run dir its own. Silo U_SLOW sleeps U_SLOW_S after its training in
# rounds U_SLOW_ROUNDS, silo 1 U_BASE_S in every round, so silo 1 holds the
# round's path when silo U_SLOW is not slowed. A straggler score is a
# latency over the cohort median, which is silo 1's w + U_BASE_S for an
# honest silo wall w: silo U_SLOW scores (w + U_SLOW_S) / (w + U_BASE_S),
# at least 2 (the doctor's threshold) while U_SLOW_S >= w + 2 x U_BASE_S.
# Three silos, not i2's two: over two clients the ratio to their median
# stays below 2. U_SLOW_S is set from the wall measured on the card: an
# honest silo's latency was 0.89-1.03 s a round after round 0 (NVIDIA H100
# 80GB HBM3 at 700 W), and 3.0 s keeps silo U_SLOW's score above 2 on a
# host twice as slow ((2.0 + 3.0) / (2.0 + 0.3) = 2.17), U_BASE_S above the
# 20-50 ms that honest silos' latencies differ by. u1's twin: the same
# federation with the plane off and no sleeps, beside u2; its digest must
# equal u1's. u2: phase t3's tree (T3, T3_KILLS) under
# ``TreeRunner(live=LivePlane(..., metrics_port=0))``, and ``tree
# --metrics-port 0`` at U2_CLI_ARGS in a child process. u3: the readers of
# u1's run dir as children: ``telemetry trace --json --perfetto`` and
# ``telemetry watch --once``. u1 runs after m1's processes have exited and
# before o starts; the twin, u2's command and u3's readers run beside m2,
# which gates on no time (paid for phase u: without that, the children's
# ~30 s ran in the open after u1).
U_SILOS = 3
U_ROUNDS = 5
U_SLOW = 2
U_SLOW_ROUNDS = (1, 2, 3)
U_BASE_S = 0.3
U_SLOW_S = 3.0
U_TRAIN = dict(T1_DATA, client_num_in_total=U_SILOS, comm_round=U_ROUNDS)
U2_CLI_ARGS = ("--clients", "2000", "--tiers", "3", "--rounds", "2", "--params", "128")


def share_stand_in_draws():
    """Draw the synthetic stand-ins' arrays once per (sizes, seed) in this
    process: phases h–m each load the same 60,000 CIFAR-10 stand-in images,
    ~7 s a draw. Each load gets its own copy (a phase may flip labels); the
    processes the phases start draw their own."""
    from fedml_tpu_torch.data import data_loader

    draw = data_loader._make_classification_arrays
    drawn = {}

    def shared(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in drawn:
            drawn[key] = draw(*args, **kwargs)
        return tuple(a.copy() for a in drawn[key])

    data_loader._make_classification_arrays = shared


def card_peaks(name: str):
    """(bytes/s, bf16 FLOP/s) of the card, from the port's roofline table
    (NVIDIA's data sheets); raises for a card the table does not name."""
    from fedml_tpu_torch.telemetry.profiling.roofline import PEAK_FLOPS, PEAK_HBM_BW

    if name not in PEAK_FLOPS:
        raise RuntimeError(f"no peak table entry for {name!r}")
    return PEAK_HBM_BW[name], PEAK_FLOPS[name]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def build_kernels():
    """Build every kernel source in parallel; returns seconds and logs."""
    from fedml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for fut in [pool.submit(_build.build, n) for n in KERNEL_SOURCES]:
            fut.result()
    for n in KERNEL_SOURCES:
        _build.load(n)
    return time.perf_counter() - t0, dict(_build.build_logs)


def ptxas_report(log: str):
    """Per kernel of an ``nvcc -Xptxas -v`` log: {name<D>: registers, spill
    store and load bytes, stack frame bytes}."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            mangled = m.group(1)
            # the kernel's own name: the <length><name> pair that ends in _kernel
            base = next((mangled[m.end():m.end() + int(m.group())]
                         for m in re.finditer(r"\d+", mangled)
                         if mangled[m.end():m.end() + int(m.group())].endswith("_kernel")),
                        mangled)
            args = re.search(r"I((?:Li\d+E)+)E", mangled)
            name = base + (f"<{','.join(re.findall(r'Li(\d+)E', args.group(1)))}>"
                           if args else "")
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def device_ms(calls, reps: int) -> float:
    """Mean device time of one call, from CUDA events around ``reps`` calls
    that rotate through ``calls``. A device-side sleep first backs the
    stream up, so host launch overhead never paces the measured calls."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(reps):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parent_kernels(parent_dir: str):
    """The dequant-matmul and flash-forward kernels of another checkout
    (``parent_dir``), built from its sources with this tree's nvcc flags
    into ``results/parent_build`` and bound with ctypes from the argument
    lists of its ``extern "C"`` declarations: ``(dequant(x, q, scale),
    flash_fwd(q, k, v, causal, scale))`` on the current stream."""
    import ctypes
    import re

    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.ops import quant

    out_dir = os.path.abspath(os.path.join("results", "parent_build"))
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(parent_dir, "fedml_tpu_torch", "ops", "csrc")

    def build(name):
        so = os.path.join(out_dir, f"lib{name}.so")
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(csrc, f"{name}.cu")], check=True, capture_output=True)
        return ctypes.CDLL(so)

    def bind(lib, source, fn_name):
        with open(os.path.join(csrc, f"{source}.cu")) as f:
            decl = re.search(rf"int {fn_name}\(([^)]*)\)", f.read()).group(1)
        params = [p.split()[0] for p in decl.split(",")]
        fn = getattr(lib, fn_name)
        fn.argtypes = [{"int": ctypes.c_int, "float": ctypes.c_float}.get(p, ctypes.c_void_p)
                       for p in params]
        fn.restype = ctypes.c_int
        return fn, len(params)

    with ThreadPoolExecutor(2) as pool:
        dq_lib, fa_lib = pool.map(build, ("dequant_matmul", "flash_attention"))
    for lib in (dq_lib, fa_lib):
        lib.fedml_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fedml_cuda_error_string.restype = ctypes.c_char_p
    deq, n_deq = bind(dq_lib, "dequant_matmul", "fedml_dequant_matmul_bf16")
    fwd, _ = bind(fa_lib, "flash_attention", "fedml_flash_fwd_bf16")

    def dequant(x, q, scale):
        rows, h = x.shape
        f = q.shape[1]
        out = torch.empty((rows, f), dtype=torch.bfloat16, device=x.device)
        # this tree's split count where the entry point takes one (the
        # kernel before split-K has 8 parameters and no split)
        splits = [quant.dequant_splits(h, f)] if n_deq == 9 else []
        code = deq(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, h, f,
                   *splits, torch.cuda.current_stream().cuda_stream)
        _build.check(dq_lib, code, "parent dequant_matmul launch")
        return out

    def flash_fwd(q, k, v, causal, scale):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        b, h, t, d = q.shape
        code = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                   b, h, k.shape[1], t, k.shape[2], d, int(causal), scale,
                   torch.cuda.current_stream().cuda_stream)
        _build.check(fa_lib, code, "parent flash forward launch")
        return out, lse

    return dequant, flash_fwd


def dequant_faults(quant, x, q, scale, want):
    """Two faulty results the row check must reject, made by the kernel on
    altered inputs: one split's partial sum missing (x zeroed over rank 0's
    H-rows: its whole partial sum is then 0) and the last 16 columns
    missing (their scales zeroed). Returns {fault: row measure}."""
    h, f = q.shape
    x_cut = x.clone()
    x_cut[:, :h // quant.dequant_splits(h, f)] = 0
    s_cut = scale.clone()
    s_cut[-16:] = 0
    out = {"missing_one_split": row_rel_err(quant.dequant_matmul_cuda(x_cut, q, scale), want),
           "missing_last_16_columns": row_rel_err(quant.dequant_matmul_cuda(x, q, s_cut), want)}
    print(f"    planted faults at H={h} F={f} ({quant.dequant_splits(h, f)} splits): "
          + ", ".join(f"{n} row measure {v:.4g}" for n, v in out.items())
          + f" (limit {DEQUANT_ROW_TOL:.4g})", flush=True)
    if not all(v > DEQUANT_ROW_TOL for v in out.values()):
        raise RuntimeError(f"the row check passes a planted dequant fault: {out}")
    return out


def kernel_phase(peak_bw: float, peak_flops: float, parent=None):
    """Phase (b): kernel vs plain version at every slice shape and row
    count, and the times of one pass's 225 launches at each row count."""
    from fedml_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = []
    for (h, f) in SLICE_SHAPES:
        w = torch.randn(h, f, device="cuda", generator=gen)
        qt = quant.quantize_int8(w, mode="kernel")
        del w
        # rotate through enough weight copies to exceed the 50 MB L2, as the
        # decode step does (7.5 GB of weights stream through once per step)
        n_copies = max(2, min(32, math.ceil(256e6 / (h * f))))
        qs = [qt.data] + [qt.data.clone() for _ in range(n_copies - 1)]
        ss = [qt.scale] + [qt.scale.clone() for _ in range(n_copies - 1)]
        qts = [q.t().contiguous() for q in qs]      # [F, H] for the yardstick
        s16 = qt.scale.to(torch.bfloat16)
        for rows in ROWS:
            x = torch.randn(rows, h, device="cuda", generator=gen).to(torch.bfloat16)
            got = quant.dequant_matmul_cuda(x, qt.data, qt.scale)
            again = quant.dequant_matmul_cuda(x, qt.data, qt.scale)
            want = quant.dequant_matmul_reference(x, qt.data, qt.scale, torch.bfloat16)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            held = row_rel_err(got, want)
            identical = bool(torch.equal(got, again))
            if not (held <= DEQUANT_ROW_TOL and identical):
                raise RuntimeError(f"kernel disagrees with its plain version at H={h} F={f} "
                                   f"rows={rows}: row measure {held} > {DEQUANT_ROW_TOL}, "
                                   f"or two launches differ ({identical})")
            faults = (dequant_faults(quant, x, qt.data, qt.scale, want)
                      if (h, f) in DEQUANT_FAULT_SHAPES and rows == DECODE_ROWS else None)
            library = "torch._weight_int8pack_mm"
            try:
                torch._weight_int8pack_mm(x, qts[0], s16)
                lib_calls = [lambda i=i: torch._weight_int8pack_mm(x, qts[i], s16)
                             for i in range(n_copies)]
            except (RuntimeError, AttributeError):
                library = "x @ q.to(bf16) * scale"
                lib_calls = [lambda i=i: (x @ qs[i].to(torch.bfloat16)) * s16
                             for i in range(n_copies)]
            reps = 20 if h * f < 1e8 else 10
            kernel_calls = [lambda i=i: quant.dequant_matmul_cuda(x, qs[i], ss[i])
                            for i in range(n_copies)]
            ms = device_ms(kernel_calls, reps)
            parent_ms = None if parent is None else device_ms(
                [lambda i=i: parent(x, qs[i], ss[i]) for i in range(n_copies)], reps)
            plain_ms = device_ms(
                [lambda i=i: quant.dequant_matmul_reference(x, qs[i], ss[i],
                                                            torch.bfloat16)
                 for i in range(n_copies)], reps)
            library_ms = device_ms(lib_calls, reps)
            ms_again = device_ms(kernel_calls, reps)
            nbytes = h * f + 2 * rows * (h + f) + 4 * f
            flops = 2 * rows * h * f
            bytes_ms, flops_ms = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
            rec = dict(H=h, F=f, rows=rows, splits=quant.dequant_splits(h, f),
                       max_abs_err=err, row_measure=held, tol=DEQUANT_ROW_TOL,
                       bit_identical=identical, planted_faults=faults, ms=ms,
                       ms_again=ms_again, parent_ms=parent_ms, plain_ms=plain_ms,
                       library_ms=library_ms, library=library,
                       bound_ms=max(bytes_ms, flops_ms),
                       bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                       weight_gb_per_s=h * f / ms / 1e6)
            results.append(rec)
            print(f"  H={h:5d} F={f:6d} rows={rows:3d}  row measure {held:.3g} (max abs "
                  f"{err:.3g})  kernel {ms:.4f} / {ms_again:.4f} ms  parent "
                  + ("not measured" if parent_ms is None else f"{parent_ms:.4f} ms")
                  + f"  plain {plain_ms:.4f} ms  {library} {library_ms:.4f} ms  bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})  "
                  f"{rec['weight_gb_per_s']:.0f} GB/s", flush=True)
        del qs, ss, qts, qt
        torch.cuda.empty_cache()
    print("  one pass of 225 launches (the sum over the shapes):", flush=True)
    for rows in ROWS:
        sums = {k: step_sum(results, k, rows) for k in
                ("ms", "ms_again", "parent_ms", "library_ms", "plain_ms", "bound_ms")}
        print(f"    rows={rows:3d}  kernel {sums['ms']:.4f} / {sums['ms_again']:.4f} ms  "
              "parent " + ("not measured" if sums["parent_ms"] is None
                           else f"{sums['parent_ms']:.4f} ms")
              + f"  torch._weight_int8pack_mm {sums['library_ms']:.4f} ms  plain "
              f"{sums['plain_ms']:.4f} ms  bound {sums['bound_ms']:.4f} ms", flush=True)
    return results


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over rows (the last dim: one query's or key's head vector,
    one token's hidden vector, one row of a gradient) of ``|got - want| /
    max(|want|, ROW_FLOOR * rms)`` in L2, with rms the root mean square of
    the plain rows' norms. The floor holds a row that cancels to rounding
    noise (causal dq's first row: p = 1 there, so dp - delta is 0 but for
    rounding) to a small share of a typical row instead of to its own noise.
    A non-finite value gives nan, which fails any limit."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    err = torch.linalg.vector_norm(g - w, dim=-1)
    ref = torch.linalg.vector_norm(w, dim=-1)
    ref = ref.clamp_min(ROW_FLOOR * ref.square().mean().sqrt())
    ratio = torch.where(ref > 0, err / ref.clamp_min(torch.finfo(torch.float32).tiny),
                        torch.where(err > 0, torch.inf, 0.0))
    if not torch.isfinite(g).all():
        return math.nan
    return ratio.max().item()


def old_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error over the tensor's largest magnitude."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def attention_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs the masked attention computes: Σ_r min(r + 1, S)
    under the top-left causal mask, T·S without it."""
    if not causal:
        return t * s
    n = min(t, s)
    return n * (n + 1) // 2 + (t - n) * s


def flash_bounds(b, h, hkv, d, t, s, causal, peak_bw, peak_flops):
    """Least time of each kernel: max(FLOPs / peak, bytes / bandwidth), with
    every input read once and every output written once. Products: forward
    q k^T and p v (4 FLOPs per pair and dim), dq adds dO v^T and ds k (6),
    dk/dv q k^T, p^T dO, dO v^T and ds^T q (8)."""
    pairs = attention_pairs(t, s, causal)
    q_bytes, kv_bytes, rows = 2 * b * h * t * d, 2 * b * hkv * s * d, 4 * b * h * t
    work = {
        "flash_fwd": (4, 2 * q_bytes + 2 * kv_bytes + rows),
        "flash_bwd_dq": (6, 3 * q_bytes + 2 * kv_bytes + 2 * rows),
        "flash_bwd_dkv": (8, 2 * q_bytes + 4 * kv_bytes + 2 * rows),
    }
    out = {}
    for name, (per_pair, nbytes) in work.items():
        flops = per_pair * b * h * d * pairs
        flops_ms = flops / peak_flops * 1e3
        bytes_ms = nbytes / peak_bw * 1e3
        out[name] = (max(flops_ms, bytes_ms),
                     "operations" if flops_ms >= bytes_ms else "bytes", flops)
    return out


def planted_faults(fa, q, k, v, do, lse, delta, scale, want):
    """Two faulty backward results the row check must reject, made from the
    kernels' own outputs: dk/dv that skip the last q tile (the kernel run
    with those rows' lse at +inf, so their p and ds are 0), and dq that
    drops one 64-key tile for rows from FAULT_ROW0 on (the kernel's dq less
    that tile's share, which the plain version computes without a mask:
    every such row sees the whole tile). Returns {fault: {tensor: (row
    measure, old measure)}} and raises if the row check passes a fault."""
    lse_cut = lse.clone()
    lse_cut[..., -FAULT_Q_TILE:] = math.inf
    dk_f, dv_f = fa.flash_dkv_cuda(q, k, v, do, lse_cut, delta, True, scale)
    k0, k1 = FAULT_KEYS
    r0 = FAULT_ROW0
    share = fa.flash_dq_reference(q[:, :, r0:], k[:, :, k0:k1], v[:, :, k0:k1],
                                  do[:, :, r0:], lse[:, :, r0:], delta[:, :, r0:],
                                  False, scale)
    dq_f = fa.flash_dq_cuda(q, k, v, do, lse, delta, True, scale).float()
    dq_f[:, :, r0:] -= share.float()
    faults = {
        "dkv_skips_last_q_tile": {"dk": (dk_f, want["dk"]), "dv": (dv_f, want["dv"])},
        "dq_drops_a_kv_tile": {"dq": (dq_f, want["dq"])},
    }
    out = {}
    for fault, tensors in faults.items():
        out[fault] = {n: (row_rel_err(g, w), old_rel_err(g, w))
                      for n, (g, w) in tensors.items()}
        print(f"    planted fault {fault}: "
              + ", ".join(f"{n} row measure {r:.4g} (limit {ROW_TOL:.4g}), old measure "
                          f"{o:.4g} (limit {OLD_REL_TOL})" for n, (r, o) in out[fault].items()),
              flush=True)
        if not all(r > ROW_TOL for r, _ in out[fault].values()):
            raise RuntimeError(f"the row check passes the planted fault {fault}: "
                               f"{out[fault]}")
    return out


def flash_phase(peak_bw: float, peak_flops: float, parent_fwd=None):
    """Phase (d): the three flash-attention kernels against their plain
    versions in bf16, and their times beside the bound and a one-call
    PyTorch yardstick (``scaled_dot_product_attention`` and its backward)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from fedml_tpu_torch.ops import flash_attention as fa

    b, h, hkv, d = FLASH_HEADS
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = []
    for t, s, causal in FLASH_SHAPES:
        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)

        q, k, v, do = randn(b, h, t, d), randn(b, hkv, s, d), randn(b, hkv, s, d), \
            randn(b, h, t, d)
        out, lse = fa.flash_forward_cuda(q, k, v, causal, scale)
        delta = fa.attention_delta(do, out)
        dq = fa.flash_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        # each kernel's plain version on the same inputs (the backward ones
        # take the kernel's own lse and delta, so each kernel is held alone)
        out_p, lse_p = fa.flash_forward_reference(q, k, v, causal, scale)
        dq_p = fa.flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
        dk_p, dv_p = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        # {name: (max abs error, measure held, limit)}: lse absolute, the
        # bf16 tensors row by row
        errs = {}
        for name, got, want in (("out", out, out_p), ("lse", lse, lse_p), ("dq", dq, dq_p),
                                ("dk", dk, dk_p), ("dv", dv, dv_p)):
            err = (got.float() - want.float()).abs().max().item()
            held, tol = (err, LSE_TOL) if name == "lse" else (row_rel_err(got, want), ROW_TOL)
            errs[name] = (err, held if torch.isfinite(got).all() else math.nan, tol)
        print(f"  T={t:4d} S={s:4d} causal={int(causal)}  max abs error / held / limit: "
              + ", ".join(f"{n} {e:.3g} / {h_:.3g} / {tl:.3g}"
                          for n, (e, h_, tl) in errs.items()), flush=True)
        if not all(h_ <= tl for _, h_, tl in errs.values()):
            raise RuntimeError(f"a flash kernel disagrees with its plain version at "
                               f"T={t} S={s} causal={causal}: {errs}")
        faults = identical = None
        if (t, s, causal) == FLASH_SHAPES[0]:
            faults = planted_faults(fa, q, k, v, do, lse, delta, scale,
                                    dict(dq=dq_p, dk=dk_p, dv=dv_p))
            # the backward is deterministic: no atomics, a fixed sum order
            again = (fa.flash_dq_cuda(q, k, v, do, lse, delta, causal, scale),
                     *fa.flash_dkv_cuda(q, k, v, do, lse, delta, causal, scale))
            identical = {n: bool(torch.equal(a, b_)) for n, a, b_ in
                         zip(("dq", "dk", "dv"), (dq, dk, dv), again)}
            print(f"    two launches bit-identical: {identical}", flush=True)
            if not all(identical.values()):
                raise RuntimeError(f"two backward launches differ: {identical}")
            del again

        reps = 20
        ms = {
            "flash_fwd": device_ms([lambda: fa.flash_forward_cuda(q, k, v, causal, scale)],
                                   reps),
            "flash_bwd_dq": device_ms([lambda: fa.flash_dq_cuda(
                q, k, v, do, lse, delta, causal, scale)], reps),
            "flash_bwd_dkv": device_ms([lambda: fa.flash_dkv_cuda(
                q, k, v, do, lse, delta, causal, scale)], reps),
        }
        fwd_again = device_ms([lambda: fa.flash_forward_cuda(q, k, v, causal, scale)], reps)
        parent_fwd_ms = None if parent_fwd is None else device_ms(
            [lambda: parent_fwd(q, k, v, causal, scale)], reps)
        plain_ms = {
            "flash_fwd": device_ms([lambda: fa.flash_forward_reference(
                q, k, v, causal, scale)], 5),
            "flash_bwd_dq": device_ms([lambda: fa.flash_dq_reference(
                q, k, v, do, lse, delta, causal, scale)], 5),
            "flash_bwd_dkv": device_ms([lambda: fa.flash_dkv_reference(
                q, k, v, do, lse, delta, causal, scale)], 5),
        }
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o_lib = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=True)
        lib_fwd = device_ms([lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)],
                            reps)
        lib_bwd = device_ms([lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), do, retain_graph=True)], reps)
        del qg, kg, vg, o_lib
        bounds = flash_bounds(b, h, hkv, d, t, s, causal, peak_bw, peak_flops)
        tflops = {n: v[2] / ms[n] / 1e9 for n, v in bounds.items()}
        rec = dict(T=t, S=s, causal=causal, errors=errs, planted_faults=faults,
                   bit_identical=identical, ms=ms, fwd_again_ms=fwd_again,
                   parent_fwd_ms=parent_fwd_ms, plain_ms=plain_ms,
                   library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
                   bound_ms={n: v[0] for n, v in bounds.items()},
                   bound_by={n: v[1] for n, v in bounds.items()}, tflops_per_s=tflops)
        results.append(rec)
        for n in ms:
            lib = lib_fwd if n == "flash_fwd" else lib_bwd
            print(f"    {n:14s} kernel {ms[n]:.4f} ms ({tflops[n]:.1f} TFLOP/s)  plain "
                  f"{plain_ms[n]:.4f} ms  bound {bounds[n][0]:.4f} ms ({bounds[n][1]})  "
                  f"{'sdpa fwd' if n == 'flash_fwd' else 'sdpa bwd (dq+dk+dv)'} "
                  f"{lib:.4f} ms", flush=True)
        print(f"    flash_fwd again {fwd_again:.4f} ms; parent's forward "
              + ("not measured" if parent_fwd_ms is None else f"{parent_fwd_ms:.4f} ms"),
              flush=True)
        print(f"    backward pair dq + dk/dv {ms['flash_bwd_dq'] + ms['flash_bwd_dkv']:.4f} ms "
              f"against sdpa bwd {lib_bwd:.4f} ms", flush=True)
        del q, k, v, do, out, lse, delta, dq, dk, dv, out_p, lse_p, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()
    return results


def post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def serve_phase():
    """Phase (c): Llama-3-8B int8 served over HTTP through the kernel."""
    from fedml_tpu_torch.cli import build_endpoint, build_parser
    from fedml_tpu_torch.models.llm.llama import rope_tables
    from fedml_tpu_torch.ops import quant
    from fedml_tpu_torch.telemetry import get_registry

    args = build_parser().parse_args(
        ["serve", "--model", "llama3_8b", "--quantize", "int8", "--batch-slots",
         "8", "--max-len", "512", "--host", "127.0.0.1", "--port", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, runner = build_endpoint(args)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    model = engine.params
    cfg = model.cfg
    served_gb = quant.tree_bytes(model) / 1e9
    print(f"  booted llama3_8b int8 in {boot_s:.1f} s: {served_gb:.3f} GB of weights, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated", flush=True)
    runner.start()
    try:
        rng = np.random.default_rng(0)
        lens = rng.integers(20, 121, size=N_REQUESTS)
        prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
        bodies = [{"prompt_tokens": p, "max_new_tokens": NEW_TOKENS} for p in prompts]

        # --- the main path, with the launch count read around exactly it ---
        engine.oplog.clear()
        quant.DEQUANT_MATMUL_LAUNCHES = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CONCURRENT) as pool:
            first = list(pool.map(lambda b: post(runner.port, b), bodies[:N_CONCURRENT]))
        rest = [post(runner.port, b) for b in bodies[N_CONCURRENT:]]
        wall_s = time.perf_counter() - t0
        launches = quant.DEQUANT_MATMUL_LAUNCHES
        ops = list(engine.oplog)

        for r in first + rest:
            toks = r.get("tokens")
            if (not isinstance(toks, list) or len(toks) != NEW_TOKENS
                    or not all(0 <= t < cfg.vocab_size for t in toks)):
                raise RuntimeError(f"bad response: {r}")
        n_decode = sum(1 for op in ops if op[0] in ("decode", "decode_part"))
        n_prefill = sum(1 for op in ops if op[0] == "prefill")
        n_prefill_small = sum(1 for op in ops if op[0] == "prefill" and op[1] <= 128)
        expected = LAUNCHES_PER_PASS * (n_decode + n_prefill_small)
        print(f"  {N_REQUESTS} requests ({N_CONCURRENT} concurrent) in {wall_s:.2f} s: "
              f"{n_prefill} prefills ({n_prefill_small} of <=128 rows), {n_decode} "
              f"decode steps; kernel launches {launches} (expected >= {expected})",
              flush=True)
        if launches < expected or launches == 0:
            raise RuntimeError(f"the serve path launched the kernel {launches} "
                               f"times, expected at least {expected}")
        ttft = get_registry().histogram("serving/ttft_ms").snapshot()
        tpot = get_registry().histogram("serving/tpot_ms").snapshot()
        print(f"  TTFT over {ttft['count']} requests: p50 {ttft['p50']:.2f} ms, "
              f"p95 {ttft['p95']:.2f} ms, max {ttft['max']:.2f} ms; TPOT p50 "
              f"{tpot['p50']:.2f} ms, p95 {tpot['p95']:.2f} ms (engine histograms)",
              flush=True)
    finally:
        runner.stop()
        engine.stop()
    if engine.failure is not None:
        raise RuntimeError("serving engine failed") from engine.failure

    step_s, dev_step_ms, busy = steady_decode(engine, rng)

    # --- served outputs are right: the served model through the kernel
    # against the same int8 codes through the kernel's plain version (same
    # single rounding), on a 48-token prompt. One full-width block must
    # agree within 2e-2 of its largest output. Through all 32 layers of
    # random weights a 1-ulp bf16 difference is amplified (two roundings of
    # the same codes already differ by ~2% of the largest logit), so the
    # logits are held to finite values of the vocab width and a 2e-2
    # relative L2 distance, prefill and one decode step; the plain-PyTorch
    # int8 lowering's distance is printed beside it for scale. ---
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 48))).cuda()
    qts = [v for mod in model.modules() for v in vars(mod).values()
           if isinstance(v, quant.QuantizedTensor)]

    def run(mode):
        for q in qts:
            q.mode = mode
        with torch.inference_mode():
            x = torch.nn.functional.embedding(tokens, model.embed_tokens).to(cfg.dtype)
            cos, sin = rope_tables(torch.arange(48, device="cuda"), cfg.head_dim,
                                   cfg.rope_theta)
            block = model.layer_0(x, cos, sin, model.init_kv_caches(1, 64)[0])[0]
            caches = model.init_kv_caches(1, 64)
            lp, caches = model(tokens, kv_caches=caches)
            ld, _ = model(tokens[:, -1:], positions=torch.tensor([[48]], device="cuda"),
                          kv_caches=caches)
        return block, lp, ld

    kernel = quant.dequant_matmul_cuda
    try:
        k_out = run("kernel")
        quant.dequant_matmul_cuda = (  # route the kernel path to its plain version
            lambda x, q, s: quant.dequant_matmul_reference(x, q, s, torch.bfloat16))
        p_out = run("kernel")
        quant.dequant_matmul_cuda = kernel
        d_out = run("dequant")
    finally:
        quant.dequant_matmul_cuda = kernel
        for q in qts:
            q.mode = "kernel"

    def rel_max(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    for got in k_out[1:]:
        if not torch.isfinite(got).all() or got.shape[-1] != cfg.vocab_size:
            raise RuntimeError("served logits are not finite / of the vocab width")
    block_err = rel_max(k_out[0], p_out[0])
    vs_plain = (rel_l2(k_out[1], p_out[1]), rel_l2(k_out[2], p_out[2]))
    vs_dequant = (rel_l2(k_out[1], d_out[1]), rel_l2(k_out[2], d_out[2]))
    print(f"  layer_0 kernel vs plain version {block_err:.4g} of its max output; "
          f"logits finite, relative L2 to the plain version {vs_plain[0]:.4g} "
          f"(prefill), {vs_plain[1]:.4g} (decode); to the dequant lowering "
          f"{vs_dequant[0]:.4g}, {vs_dequant[1]:.4g}", flush=True)
    if block_err > 2e-2 or max(vs_plain) > 2e-2:
        raise RuntimeError(f"the kernel's model disagrees with its plain version: "
                           f"block {block_err}, logits {vs_plain}")
    mem = dict(allocated_gb=torch.cuda.memory_allocated() / 1e9,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  memory allocated {mem['allocated_gb']:.3f} GB, peak {mem['peak_gb']:.3f} GB",
          flush=True)
    return dict(launches=launches, expected_launches=expected, decode_steps=n_decode,
                prefills=n_prefill, prefills_le128=n_prefill_small,
                http_wall_s=wall_s, ttft_ms=ttft, tpot_ms=tpot,
                decode_ms_per_step=step_s * 1e3, tokens_per_s=engine.n_slots / step_s,
                device_ms_per_step=dev_step_ms, device_busy_share=busy, boot_s=boot_s, served_weights_gb=served_gb,
                layer0_vs_plain=block_err, logits_l2_vs_plain=vs_plain,
                logits_l2_vs_dequant=vs_dequant, **mem)


def steady_decode(engine, rng, n_steps: int = 30, n_prof: int = 5):
    """Steady decode with every slot busy, the engine driven directly:
    ``(seconds a step on the host's clock, device ms a step from the
    profiler or None, busy share or None)``, printed."""
    vocab = engine.cfg.vocab_size
    for _ in range(engine.n_slots):
        engine.submit(rng.integers(0, vocab, size=64).tolist(),
                      max_new_tokens=n_steps + n_prof + 10)
    for _ in range(engine.n_slots):
        engine._admit(engine._requests.get_nowait())
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    step_s = (time.perf_counter() - t0) / n_steps
    # device time per step from the profiler's kernel records; the wall time
    # is the unprofiled one above (the profiler slows the host side)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            engine.step()
        torch.cuda.synchronize()
    dev_ms = sum(ms for _, ms in _device_kernels(prof).values())
    dev_step_ms = dev_ms / n_prof if dev_ms > 0 else None
    busy = dev_step_ms / (step_s * 1e3) if dev_step_ms else None
    print(f"  decode at {engine.n_slots} slots: {step_s * 1e3:.2f} ms/step, "
          f"{engine.n_slots / step_s:.1f} tokens/s; device time "
          + ("not measured" if busy is None else
             f"{dev_step_ms:.2f} ms/step (profiler, {n_prof} steps), busy share {busy:.3f}"),
          flush=True)
    while engine.active_slots:  # finish the streams: every slot free again
        engine.step()
    return step_s, dev_step_ms, busy


def plain_flash_route():
    """Context manager routing the flash wrappers to their plain versions
    (same signatures), so the model runs the same code minus the kernels."""
    import contextlib

    from fedml_tpu_torch.ops import flash_attention as fa

    @contextlib.contextmanager
    def route():
        saved = (fa.flash_forward_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda)
        fa.flash_forward_cuda = fa.flash_forward_reference
        fa.flash_dq_cuda = fa.flash_dq_reference
        fa.flash_dkv_cuda = fa.flash_dkv_reference
        try:
            yield
        finally:
            fa.flash_forward_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda = saved

    return route()


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low or "flash_bwd" in low:
        return "flash attention (port kernels)"
    if "indexselect" in low or "scatter_gather" in low:
        return "gather (4-bit dequant lookups, embedding)"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "matmul", "nvjet")):
        return "matmul (cuBLAS)"
    return "other (elementwise, norms, rope, softmax/CE, optimizer)"


def train_step_flops(cfg, batch: int, t: int) -> float:
    """Model FLOPs of one LoRA training step: every projection and the LM
    head forward and its activation gradient (2 + 2 FLOPs per weight per
    token; the frozen base gets no weight gradient), the adapters' forward
    and both gradients (2 + 4), and the attention kernels' products
    (4 + 6 + 8 per (query, key) pair and head dim, causal)."""
    h, d, kv = cfg.hidden_size, cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    proj = 2 * h * h + 2 * h * kv + 3 * h * cfg.intermediate_size
    lora = cfg.lora_rank * (2 * (h + h) + 2 * (h + kv))
    tokens = batch * t
    per_layer = (4 * proj + 6 * lora) * tokens + 18 * batch * cfg.num_attention_heads \
        * d * attention_pairs(t, t, True)
    return cfg.num_hidden_layers * per_layer + 4 * h * cfg.vocab_size * tokens


def train_phase(light: bool = False, **overrides):
    """Phase (e), and with ``base_quantize`` in ``overrides`` phase (g):
    federated LoRA rounds of Llama-3-8B through FedLLMAPI. A quantized base
    must come out of ``train()`` bit-identical. ``light`` stops after
    ``train()`` (its round times, launches and peak memory)."""
    import types

    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.llama import causal_lm_loss, rope_tables
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops.quant import named_quantized_weights
    from fedml_tpu_torch.telemetry import get_registry
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI
    from fedml_tpu_torch.train.llm.trainer import extract_lora

    args = types.SimpleNamespace(**{**TRAIN_ARGS, **overrides})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = FedLLMAPI(args, "cuda", load_synthetic_lm(args))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    engine, cfg = api.client.engine, api.cfg
    lora_n = sum(p.numel() for p in extract_lora(engine.model).values())
    def quantized_weights(model):
        return [q for _, q in named_quantized_weights(model)]

    base = quantized_weights(engine.model)
    base_bytes = sum(q.data.numel() * q.data.element_size() + 4 * q.scale.numel()
                     for q in base)
    print(f"  booted {args.model_size} (LoRA rank {cfg.lora_rank}, {lora_n} adapter parameters"
          + (f"; {len(base)} base kernels {args.base_quantize}, {base_bytes / 1e9:.3f} GB"
             if base else "")
          + f") in {boot_s:.1f} s: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated",
          flush=True)
    base_gauge = None
    if base and args.base_quantize in ("int4", "nf4"):
        base_gauge = get_registry().gauge("quant/base_bytes").value
        if base_gauge != base_bytes:
            raise RuntimeError(f"quant/base_bytes gauge {base_gauge} != the packed "
                               f"leaves' {base_bytes} bytes")
    # the frozen base, on the host (kept off the card: its peak is measured)
    base0 = [(q.data.cpu(), q.scale.cpu()) for q in base]

    rounds = []
    inner = api.train_one_round

    def recorded(r):
        rep = inner(r)
        rep["lora_b_max"] = max(float(v.abs().max()) for k, v in
                                api.global_exchange.items() if k.endswith("lora_b"))
        rounds.append(rep)
        return rep

    api.train_one_round = recorded
    # --- the main path, with the launch counts read around exactly it ---
    fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
    t0 = time.perf_counter()
    summary = api.train()
    train_wall_s = time.perf_counter() - t0
    launches = {"flash_fwd": fa.FLASH_FWD_LAUNCHES, "flash_bwd_dq": fa.FLASH_DQ_LAUNCHES,
                "flash_bwd_dkv": fa.FLASH_DKV_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frozen = all(torch.equal(q.data.cpu(), d0) and torch.equal(q.scale.cpu(), s0)
                 for q, (d0, s0) in zip(quantized_weights(engine.model), base0))
    if base:
        print(f"  quantized base bit-identical after train(): {frozen} ({len(base0)} "
              f"kernels" + ("" if base_gauge is None else
                            f"; quant/base_bytes gauge {base_gauge:.0f} B = the packed "
                            f"leaves' bytes") + ")", flush=True)
    if not frozen or len(quantized_weights(engine.model)) != len(base0):
        raise RuntimeError("the quantized base changed in train()")

    layers, clients = cfg.num_hidden_layers, args.client_num_per_round
    steps = clients * args.local_steps_per_round * args.comm_round
    evals = len(api.test_history)
    expected = {"flash_fwd": layers * (steps + evals), "flash_bwd_dq": layers * steps,
                "flash_bwd_dkv": layers * steps}
    tokens_per_round = (clients * args.local_steps_per_round * args.per_device_batch_size
                        * args.max_seq_length)
    for rep in rounds:
        print(f"  round {rep['round']}: {rep['round_sec']:.3f} s, train loss "
              f"{rep['train_loss']:.4f}, test loss {rep.get('test_loss', float('nan')):.4f}, "
              f"global lora_b max |.| {rep['lora_b_max']:.3g}", flush=True)
    steady = rounds[-1]["round_sec"]
    step_flops = train_step_flops(cfg, args.per_device_batch_size, args.max_seq_length)
    round_flops = step_flops * clients * args.local_steps_per_round
    print(f"  train(): {args.comm_round} rounds in {train_wall_s:.2f} s (with "
          f"{evals} evals); steady round {steady:.3f} s = "
          f"{tokens_per_round / steady:.1f} tokens/s, {round_flops / steady / 1e12:.1f} "
          f"TFLOP/s of model FLOPs ({step_flops:.4g} a step); peak memory {peak_gb:.3f} GB; "
          f"launches {launches} (expected {expected})", flush=True)
    if launches != expected or min(launches.values()) == 0:
        raise RuntimeError(f"flash launches {launches} != expected {expected}")
    if not all(math.isfinite(r["train_loss"]) and math.isfinite(r["test_loss"])
               for r in rounds):
        raise RuntimeError(f"non-finite losses: {rounds}")
    if not rounds[0]["lora_b_max"] > 0:
        raise RuntimeError("the global lora_b is still zero after round 0")
    result = dict(launches=launches, expected_launches=expected, rounds=rounds,
                  summary={k: v for k, v in summary.items() if isinstance(v, (int, float))},
                  boot_s=boot_s, train_wall_s=train_wall_s,
                  tokens_per_round=tokens_per_round, tokens_per_s=tokens_per_round / steady,
                  steady_round_s=steady, step_flops=step_flops,
                  model_tflops_per_s=round_flops / steady / 1e12, peak_gb=peak_gb,
                  lora_params=lora_n, base_quantize=getattr(args, "base_quantize", ""),
                  base_bytes=base_bytes, base_kernels=len(base))
    if light:
        return result

    # --- device busy share of one round: profiler device time over the
    # unprofiled wall of the same round ---
    xs, ys, ms, w = api.round_batch(args.comm_round)

    def one_round():
        _, _, new_global, loss = api._fed_round(engine.params, engine.opt_state,
                                                api.global_exchange, xs, ys, ms, w)
        return float(loss)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round()
    round_wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_round()
        torch.cuda.synchronize()
    by_class, by_kernel = {}, []
    for key, (count, ms_) in _device_kernels(prof).items():
        if ms_ > 0:
            by_kernel.append((ms_, count, key))
            c = kernel_class(key)
            by_class[c] = by_class.get(c, 0.0) + ms_
    dev_ms = sum(by_class.values())
    busy = dev_ms / (round_wall_s * 1e3) if dev_ms else None
    print(f"  one round: {round_wall_s * 1e3:.1f} ms unprofiled wall; device time "
          + ("not measured" if busy is None else
             f"{dev_ms:.1f} ms (profiler), busy share {busy:.3f}"), flush=True)
    for c, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"    {c}: {v:.1f} ms", flush=True)
    by_kernel.sort(reverse=True)
    for ms_, count, key in by_kernel[:12]:
        print(f"    {ms_:9.2f} ms  x{count:<6d} {key[:90]}", flush=True)

    # --- layer 0's attention (with its LoRA adapters, as trained), forward
    # and backward, kernels vs plain versions: the o_proj output, not the
    # block's, which the residual stream dominates ---
    gen = torch.Generator(device="cuda").manual_seed(99)
    t = args.max_seq_length
    x = torch.randn(1, t, cfg.hidden_size, device="cuda", generator=gen).to(cfg.dtype)
    dout = torch.randn(1, t, cfg.hidden_size, device="cuda", generator=gen).to(cfg.dtype)
    cos, sin = rope_tables(torch.arange(t, device="cuda"), cfg.head_dim, cfg.rope_theta)
    block = engine.model.layer_0
    lora = extract_lora(block.attn)

    def attn_run():
        out, _ = block.attn(block.input_norm(x), cos, sin)
        return [out.detach()] + list(torch.autograd.grad(out, list(lora.values()), dout))

    got = attn_run()
    with plain_flash_route():
        want = attn_run()
    # rows: the output's tokens, and each adapter gradient's rank components
    # (lora_a is [in, rank]: its columns; lora_b is [rank, out]: its rows)
    attn_errs = {name: row_rel_err(g.T, w_.T) if name.endswith("lora_a")
                 else row_rel_err(g, w_)
                 for name, g, w_ in zip(["o_proj output", *lora], got, want)}
    attn_err = max(attn_errs.values())
    # --- the whole model on one test batch: every layer's flash output on
    # the model's own activations against the plain forward on the same
    # q, k, v, and the loss through the kernels vs through the plain versions ---
    xt, yt = (torch.as_tensor(a[:1], device="cuda").long() for a in
              api.dataset.test_data_global)
    m1 = torch.ones(1, device="cuda")
    layer_errs = []

    def checked_flash(q, k, v):
        out = fa.flash_attention(q, k, v, causal=True)
        layer_errs.append(row_rel_err(out, fa.flash_forward_reference(q, k, v, True)[0]))
        return out

    checked_loss = causal_lm_loss(lambda m, x_: m(x_, attention_fn=checked_flash))
    with torch.no_grad():
        loss_k = float(checked_loss(engine.model, xt, yt, m1)[0])
        with plain_flash_route():
            loss_p = float(engine._loss_fn(engine.model, xt, yt, m1)[0])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    layer_err = max(layer_errs)
    print(f"  layer_0 attention fwd+bwd, kernels vs plain versions, row measure: "
          + ", ".join(f"{n.removeprefix('params/')} {e:.4g}" for n, e in attn_errs.items())
          + f" (limit {ROW_TOL:.4g}); flash output of each of {len(layer_errs)} layers on "
          f"the model's activations: worst {layer_err:.4g} (layer "
          f"{layer_errs.index(layer_err)}); model loss {loss_k:.5f} vs {loss_p:.5f} "
          f"plain ({loss_rel:.3g} relative, limit {LOSS_REL_TOL})", flush=True)
    if not (attn_err <= ROW_TOL and len(layer_errs) == cfg.num_hidden_layers
            and layer_err <= ROW_TOL and loss_rel <= LOSS_REL_TOL
            and math.isfinite(loss_k)):
        raise RuntimeError(f"the kernels' model disagrees with the plain versions: "
                           f"attention {attn_errs}, layers {layer_errs}, loss {loss_rel}")
    return dict(result, round_wall_s=round_wall_s, device_ms_per_round=dev_ms,
                device_busy_share=busy, device_ms_by_class=by_class,
                top_kernels=[dict(ms=m_, count=c_, name=k_) for m_, c_, k_ in by_kernel[:20]],
                attention_row_err=attn_errs, layer_flash_row_err=layer_errs,
                loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_rel)


def int_mm_needs():
    """Phase (f), part 0: what ``torch._int_mm`` needs on this card, which
    the w8a8 path is built around: whether it takes 16 rows (the path pads
    fewer than INT_MM_MIN_ROWS to that count), and its time at 32 rows
    with the int8 weight row-major against column-major (the layout
    ``QuantizedTensor`` stores in w8a8 mode)."""
    gen = torch.Generator(device="cuda").manual_seed(97)
    out = {}
    for (h, f) in ((4096, 4096), (4096, 128256)):
        w = torch.randint(-127, 128, (h, f), device="cuda", generator=gen,
                          dtype=torch.int32).to(torch.int8)
        x16 = torch.randint(-127, 128, (16, h), device="cuda", generator=gen,
                            dtype=torch.int32).to(torch.int8)
        try:
            torch._int_mm(x16, w)
            refused = None
        except RuntimeError as e:
            refused = str(e).splitlines()[0]
        x = torch.cat([x16, x16])
        col = w.t().contiguous().t()
        row_ms = device_ms([lambda: torch._int_mm(x, w)], 10)
        col_ms = device_ms([lambda: torch._int_mm(x, col)], 10)
        out[f"{h}x{f}"] = dict(refuses_16_rows=refused, row_major_ms=row_ms,
                               column_major_ms=col_ms)
        print(f"  torch._int_mm at K={h} N={f}: 16 rows "
              + (f"refused ({refused})" if refused else "taken")
              + f"; 32 rows {row_ms:.4f} ms row-major, {col_ms:.4f} ms column-major",
              flush=True)
        del w, col
    torch.cuda.empty_cache()
    return out


def w8a8_check():
    """Phase (f), part 1: the w8a8 product on the card (``torch._int_mm``,
    fewer than 32 rows padded) against its plain version on the CPU (an
    exact float64 product) at every projection shape and W8A8_ROWS rows:
    activation codes, row scales and int32 accumulators bit for bit, the
    bf16 outputs row by row within DEQUANT_ROW_TOL."""
    from fedml_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(5678)
    out = []
    for (h, f) in SLICE_SHAPES:
        qt = quant.quantize_int8(torch.randn(h, f, device="cuda", generator=gen), mode="w8a8")
        xs = [torch.randn(rows, h, device="cuda", generator=gen).to(torch.bfloat16)
              for rows in W8A8_ROWS]
        # the plain version once for all row counts (rows are independent)
        t0 = time.perf_counter()
        xq_c, xs_c = quant.quantize_rows_int8(torch.cat(xs).cpu())
        acc_c = quant.int8_product(xq_c, qt.data.cpu())
        want_c = quant.w8a8_rescale(acc_c, xs_c, qt.scale.cpu(), torch.bfloat16)
        cpu_s = time.perf_counter() - t0
        r0 = 0
        for rows, x in zip(W8A8_ROWS, xs):
            sl = slice(r0, r0 + rows)
            r0 += rows
            xq, xsc = quant.quantize_rows_int8(x)
            acc = quant.int8_product(xq, qt.data)
            got = qt.matmul(x, torch.bfloat16).cpu()
            rec = dict(H=h, F=f, rows=rows,
                       codes_identical=bool(torch.equal(xq.cpu(), xq_c[sl])),
                       row_scales_identical=bool(torch.equal(xsc.cpu(), xs_c[sl])),
                       acc_identical=bool(torch.equal(acc.cpu(), acc_c[sl])),
                       out_identical=bool(torch.equal(got, want_c[sl])),
                       row_measure=row_rel_err(got, want_c[sl]))
            out.append(rec)
            if not (rec["codes_identical"] and rec["row_scales_identical"]
                    and rec["acc_identical"] and rec["row_measure"] <= DEQUANT_ROW_TOL):
                raise RuntimeError(f"w8a8 on the card disagrees with the CPU: {rec}")
        print(f"  w8a8 H={h:5d} F={f:6d}: codes, row scales and int32 accumulators "
              f"bit-identical to the CPU at rows {W8A8_ROWS}; outputs row measure "
              f"<= {max(r['row_measure'] for r in out[-len(W8A8_ROWS):]):.3g} (limit "
              f"{DEQUANT_ROW_TOL:.4g}), bit-identical "
              f"{all(r['out_identical'] for r in out[-len(W8A8_ROWS):])}; CPU plain "
              f"version {cpu_s:.1f} s", flush=True)
        del qt, xs, xq_c, xs_c, acc_c, want_c
        torch.cuda.empty_cache()
    return out


def quant4_check():
    """Phase (f), part 2: int4 and nf4 quantization of layer 0's seven
    kernel shapes and the LM head's on the card and on the CPU from the
    same bf16 weights: packed bytes, scales and the bf16 dequantized weight
    bit for bit."""
    from fedml_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(8765)
    out = {}
    for fmt in ("int4", "nf4"):
        for name, (h, f) in LAYER0_KERNELS.items():
            w = (torch.randn(h, f, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
            q, q_c = quant.quantize_int4(w, fmt=fmt), quant.quantize_int4(w.cpu(), fmt=fmt)
            same = (torch.equal(q.data.cpu(), q_c.data) and torch.equal(q.scale.cpu(), q_c.scale)
                    and torch.equal(q.dequantize(torch.bfloat16).cpu(),
                                    q_c.dequantize(torch.bfloat16)))
            out[f"{fmt} {name}"] = same
            if not same:
                raise RuntimeError(f"{fmt} {name}: the card's bytes or dequantized "
                                   f"weight differ from the CPU's")
            del w, q, q_c
        print(f"  {fmt}: packed bytes, scales and bf16 dequantized weights of layer 0's "
              f"seven kernels and the LM head bit-identical on the card and the CPU",
              flush=True)
    torch.cuda.empty_cache()
    return out


def quant_pass_times(peak_bw: float, peak_flops: float, int8_results=None):
    """Phase (f), part 3: one pass of the 225 projections at PASS_ROWS rows,
    timed with CUDA events for w8a8, nf4 dequant + matmul, nf4 dequant alone
    and bf16 ``torch.matmul``, beside the int8 dequant kernel's pass (phase
    b) and each pass's bound: the larger of its bytes (the weights, x and
    the output, each once) over the bandwidth and its products over the
    type's peak (int8 on the tensor cores at twice the bf16 rate)."""
    from fedml_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(2468)
    per = []
    for (h, f), count in SLICE_SHAPES.items():
        w = torch.randn(h, f, device="cuda", generator=gen) * 0.02
        n_copies = max(2, min(32, math.ceil(256e6 / (h * f))))  # beyond the 50 MB L2
        w8 = quant.quantize_int8(w, mode="w8a8")
        w4 = quant.quantize_int4(w, fmt="nf4")
        wb = w.to(torch.bfloat16)
        del w
        w8s = [w8] + [quant.QuantizedTensor(w8.data.clone(), w8.scale.clone(), mode="w8a8")
                      for _ in range(n_copies - 1)]
        w4s = [w4] + [quant.QuantizedTensor4(w4.data.clone(), w4.scale.clone(), w4.shape,
                                             fmt="nf4", block=w4.block)
                      for _ in range(n_copies - 1)]
        wbs = [wb] + [wb.clone() for _ in range(n_copies - 1)]
        reps = 20 if h * f < 1e8 else 10
        for rows in PASS_ROWS:
            x = torch.randn(rows, h, device="cuda", generator=gen).to(torch.bfloat16)
            with torch.inference_mode():
                ms = {
                    "w8a8": device_ms([lambda i=i: quant.matmul_maybe_quantized(
                        x, w8s[i], torch.bfloat16) for i in range(n_copies)], reps),
                    "nf4": device_ms([lambda i=i: quant.matmul_maybe_quantized(
                        x, w4s[i], torch.bfloat16) for i in range(n_copies)], reps),
                    "nf4_dequant": device_ms([lambda i=i: w4s[i].dequantize(torch.bfloat16)
                                              for i in range(n_copies)], reps),
                    "bf16": device_ms([lambda i=i: x @ wbs[i] for i in range(n_copies)], reps),
                }
            act = 2 * rows * (h + f)
            flops = 2 * rows * h * f
            bounds = {
                "w8a8": max((h * f + 4 * f + act) / peak_bw, flops / (2 * peak_flops)),
                "nf4": max((w4.data.numel() + 4 * w4.scale.numel() + act) / peak_bw,
                           flops / peak_flops),
                "nf4_dequant": (w4.data.numel() + 4 * w4.scale.numel() + 2 * h * f) / peak_bw,
                "bf16": max((2 * h * f + act) / peak_bw, flops / peak_flops),
            }
            per.append(dict(H=h, F=f, rows=rows, count=count, ms=ms,
                            bound_ms={k: v * 1e3 for k, v in bounds.items()}))
        del w8s, w4s, wbs, w8, w4, wb
        torch.cuda.empty_cache()
    passes = {}
    for rows in PASS_ROWS:
        recs = [r for r in per if r["rows"] == rows]
        p = {k: sum(r["count"] * r["ms"][k] for r in recs) for k in recs[0]["ms"]}
        b = {k: sum(r["count"] * r["bound_ms"][k] for r in recs) for k in recs[0]["ms"]}
        int8_ms = None if int8_results is None else step_sum(int8_results, "ms", rows)
        int8_bound = None if int8_results is None else step_sum(int8_results, "bound_ms", rows)
        passes[rows] = dict(ms=p, bound_ms=b, int8_kernel_ms=int8_ms,
                            int8_kernel_bound_ms=int8_bound)
        print(f"  one pass of {LAUNCHES_PER_PASS} projections at {rows} rows (ms, bound ms): "
              + ", ".join(f"{k} {p[k]:.4f} ({b[k]:.4f})" for k in p)
              + "; int8 dequant kernel (phase b) "
              + ("not measured" if int8_ms is None else f"{int8_ms:.4f} ({int8_bound:.4f})"),
              flush=True)
    return dict(per_shape=per, passes=passes)


def quant_serve(mode: str):
    """Phase (f), part 4: Llama-3-8B served with ``--quantize mode``
    through the ``serve`` entry point: QUANT_REQUESTS HTTP requests,
    QUANT_CONCURRENT at a time, then steady decode at 8 slots; finite
    logits of the vocab width; one short prompt's greedy tokens equal to
    the plain lowering of the same quantized weights (w8a8: the exact int8
    product in plain PyTorch; nf4: a bf16 model built from the dequantized
    weights)."""
    from fedml_tpu_torch.cli import build_endpoint, build_parser
    from fedml_tpu_torch.ops import quant
    from fedml_tpu_torch.serving import ContinuousBatchingEngine

    args = build_parser().parse_args(
        ["serve", "--model", "llama3_8b", "--quantize", mode, "--batch-slots", "8",
         "--max-len", "512", "--host", "127.0.0.1", "--port", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, runner = build_endpoint(args)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    model, cfg = engine.params, engine.cfg
    served_bytes = quant.tree_bytes(model)
    print(f"  {mode}: booted {args.model_size} in {boot_s:.1f} s: tree_bytes {served_bytes} "
          f"({served_bytes / 1e9:.3f} GB), {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"allocated", flush=True)
    # every request's TTFT, unbucketed, as the engine hands it to the monitor
    ttfts = []
    record = runner.monitor.record_stream

    def record_stream(ttft_ms, tpot_ms, tps):
        ttfts.append(ttft_ms)
        record(ttft_ms, tpot_ms, tps)

    runner.monitor.record_stream = record_stream
    rng = np.random.default_rng(1)
    runner.start()
    try:
        lens = rng.integers(20, 121, size=QUANT_REQUESTS)
        bodies = [{"prompt_tokens": rng.integers(0, cfg.vocab_size, size=int(n)).tolist(),
                   "max_new_tokens": QUANT_NEW_TOKENS} for n in lens]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(QUANT_CONCURRENT) as pool:
            resps = list(pool.map(lambda b: post(runner.port, b), bodies))
        wall_s = time.perf_counter() - t0
        for r in resps:
            toks = r.get("tokens")
            if (not isinstance(toks, list) or len(toks) != QUANT_NEW_TOKENS
                    or not all(0 <= t < cfg.vocab_size for t in toks)):
                raise RuntimeError(f"bad response: {r}")
        deadline = time.time() + 5
        while len(ttfts) < QUANT_REQUESTS and time.time() < deadline:
            time.sleep(0.01)
        http_ttfts = list(ttfts)
        print(f"  {mode}: {QUANT_REQUESTS} requests ({QUANT_CONCURRENT} concurrent) in "
              f"{wall_s:.2f} s; TTFT ms {[round(t, 2) for t in http_ttfts]}", flush=True)
    finally:
        runner.stop()
        engine.stop()
    if engine.failure is not None:
        raise RuntimeError("serving engine failed") from engine.failure
    step_s, dev_step_ms, busy = steady_decode(engine, rng, n_steps=F_DECODE_STEPS)

    # logits finite and of the vocab width, prefill and one decode step
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 48))).cuda()
    with torch.inference_mode():
        caches = model.init_kv_caches(1, 64)
        lp, caches = model(tokens, kv_caches=caches)
        ld, _ = model(tokens[:, -1:], positions=torch.tensor([[48]], device="cuda"),
                      kv_caches=caches)
    if not all(torch.isfinite(t).all() and t.shape[-1] == cfg.vocab_size for t in (lp, ld)):
        raise RuntimeError(f"{mode}: served logits are not finite / of the vocab width")
    del caches, lp, ld

    # one short prompt's greedy tokens against the plain lowering
    prompt = rng.integers(0, cfg.vocab_size, size=24).tolist()

    def greedy(eng):
        eng.start()
        try:
            return eng.generate(prompt, max_new_tokens=QUANT_NEW_TOKENS)
        finally:
            eng.stop()

    got = greedy(engine)
    if mode == "w8a8":
        product = quant.int8_product_cuda
        quant.int8_product_cuda = quant.int8_product_reference
        try:
            want = greedy(engine)
        finally:
            quant.int8_product_cuda = product
        plain = "the exact int8 product in plain PyTorch (float64)"
    else:
        bf16 = quant._shallow_module_copy(model)
        for m in bf16.modules():
            for k, v in list(vars(m).items()):
                if isinstance(v, quant.QuantizedTensor4):
                    delattr(m, k)
                    m.register_parameter(k, torch.nn.Parameter(
                        v.dequantize(torch.bfloat16), requires_grad=False))
        want = greedy(ContinuousBatchingEngine(bf16, batch_slots=engine.n_slots,
                                               max_len=engine.max_len))
        plain = "a bf16 model of the dequantized weights"
        del bf16
    print(f"  {mode}: greedy tokens of a 24-token prompt {got[:8]}... equal to {plain}: "
          f"{got == want}", flush=True)
    if got != want:
        raise RuntimeError(f"{mode}: greedy tokens {got} != the plain lowering's {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return dict(mode=mode, boot_s=boot_s, tree_bytes=served_bytes, http_wall_s=wall_s,
                ttft_ms=http_ttfts, decode_ms_per_step=step_s * 1e3,
                tokens_per_s=engine.n_slots / step_s, device_ms_per_step=dev_step_ms,
                device_busy_share=busy, greedy_tokens=got, greedy_equal_plain=got == want,
                peak_gb=peak_gb)


def quant_phase(peak_bw: float, peak_flops: float, int8_results=None):
    """Phase (f): the quantized formats at Llama-3-8B's widths."""
    out = dict(int_mm=int_mm_needs(), w8a8=w8a8_check(), quant4=quant4_check(),
               passes=quant_pass_times(peak_bw, peak_flops, int8_results))
    for mode in QUANT_SERVE_MODES:
        out[f"serve_{mode}"] = quant_serve(mode)
        gc.collect()  # this mode's engine and weights are gone
        torch.cuda.empty_cache()
    return out


def qlora_phase(bf16_round):
    """Phase (g): phase (e) over an nf4 base, set beside phase (e)'s round
    (``bf16_round``), then one round over an int8 base."""
    nf4 = train_phase(base_quantize="nf4")
    gc.collect()
    torch.cuda.empty_cache()
    int8 = train_phase(light=True, base_quantize="int8", comm_round=1)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  int8 base, one round: {int8['rounds'][0]['round_sec']:.3f} s (the first round, "
          f"with first-call costs), peak memory {int8['peak_gb']:.3f} GB", flush=True)
    rows = [("steady round s", "steady_round_s", "{:.3f}"),
            ("tokens/s", "tokens_per_s", "{:.1f}"),
            ("busy share", "device_busy_share", "{:.3f}"),
            ("device ms a round", "device_ms_per_round", "{:.1f}"),
            ("peak memory GB", "peak_gb", "{:.3f}")]
    if bf16_round is not None:
        print("  nf4 base beside phase (e)'s bf16 base, this run:", flush=True)
        for label, key, fmt in rows:
            a, b = nf4.get(key), bf16_round.get(key)
            print(f"    {label}: nf4 " + ("not measured" if a is None else fmt.format(a))
                  + " / bf16 " + ("not measured" if b is None else fmt.format(b)), flush=True)
        for c in sorted(set(nf4["device_ms_by_class"]) | set(bf16_round["device_ms_by_class"])):
            print(f"    {c}: nf4 {nf4['device_ms_by_class'].get(c, 0.0):.1f} ms / bf16 "
                  f"{bf16_round['device_ms_by_class'].get(c, 0.0):.1f} ms", flush=True)
        margin = bf16_round["peak_gb"] - nf4["peak_gb"]
        if margin < QLORA_PEAK_MARGIN_GB:
            raise RuntimeError(f"the nf4 round's peak {nf4['peak_gb']:.3f} GB is only "
                               f"{margin:.3f} GB below the bf16 round's (need "
                               f"{QLORA_PEAK_MARGIN_GB})")
    return dict(nf4=nf4, int8=int8)


def sp_kernel_class(name: str) -> str:
    low = name.lower()
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "conv", "cudnn", "implicit")):
        return "convolution (cuDNN)"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "matmul", "nvjet")):
        return "matmul (cuBLAS)"
    return "other (elementwise: GroupNorm, ReLU, CE, optimizer, codecs)"


def _same_wire(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x.cpu(), y.cpu())
               for pa, pb in zip(a.arrays, b.arrays) for x, y in zip(pa, pb))


def sp_phase(card: str):
    """Phase (h): the sp FedAvg simulation of ResNet-18 with int8 uplinks
    through ``create_simulator`` on the card, with its checks (see the
    module doc)."""
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.compression import derive_key, fused_weighted_sum, get_codec
    from fedml_tpu_torch.compression import tree_delta
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.aggregator import agg_operator
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu_torch.models.convert import to_reference_layout
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.simulator import create_simulator

    args = load_arguments_from_dict(SP_CONFIG)
    t0 = time.perf_counter()
    ds = load_federated(args)
    data_s = time.perf_counter() - t0
    model = create(args, ds.class_num)
    torch.cuda.reset_peak_memory_stats()
    sim = create_simulator(args, "cuda", ds, model)
    api = sim.fl_trainer
    params0 = {k: v.clone() for k, v in api.global_params.items()}
    n_params = sum(v.numel() for v in params0.values())
    sizes = [ds.train_data_local_num_dict[c] for c in range(args.client_num_in_total)]
    print(f"  {card}: resnet18 (GroupNorm, 2 groups), {n_params} parameters in "
          f"{len(params0)} leaves; cifar10 stand-in {ds.train_data_num} train / "
          f"{ds.test_data_num} test images of {ds.train_data_global[0].shape[1:]} made "
          f"in {data_s:.1f} s; client sizes {sizes}", flush=True)

    untrained = api.aggregator.test(api.global_params, ds.test_data_global, api.device,
                                    args)["test_loss"]
    # the main path: create_simulator(...).run(), round by round
    rounds, uplinks = [], {}
    inner_round = api.train_one_round
    orig_agg = agg_operator.FedMLAggOperator.agg_compressed

    def capture(args_, raw_list, global_params, **kw):
        uplinks["pairs"], uplinks["global"] = raw_list, global_params
        return orig_agg(args_, raw_list, global_params, **kw)

    def recorded(r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = inner_round(r)
        torch.cuda.synchronize()
        rep["round_sec"] = time.perf_counter() - t0
        rep["on_cuda"] = all(v.is_cuda for v in api.global_params.values())
        rep["finite"] = all(bool(torch.isfinite(v).all()) for v in api.global_params.values())
        rounds.append(rep)
        print(f"  {card}: round {r}: {rep['round_sec']:.3f} s, test loss "
              f"{rep['test_loss']:.5f}, test acc {rep['test_acc']:.4f}, encode "
              f"{rep['encode_ms']:.2f} ms, fused aggregation {rep['aggregate_ms']:.2f} ms, "
              f"params on cuda {rep['on_cuda']}", flush=True)
        return rep

    api.train_one_round = recorded
    agg_operator.FedMLAggOperator.agg_compressed = staticmethod(capture)
    try:
        summary = sim.run()
    finally:
        agg_operator.FedMLAggOperator.agg_compressed = staticmethod(orig_agg)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(r["on_cuda"] and r["finite"] for r in rounds):
        raise RuntimeError("a round's parameters left the card or are not finite")
    losses = [r["test_loss"] for r in rounds]
    print(f"  {card}: test loss untrained {untrained:.5f} -> {losses}", flush=True)
    if not (len(rounds) == args.comm_round and losses[-1] < untrained):
        raise RuntimeError(f"the test loss did not fall below the untrained model's "
                           f"{untrained}: {losses}")

    # card against CPU: the largest client's first SP_CPU_STEPS batches,
    # from the run's final weights; and in float64 on the card
    x, y = ds.train_data_local_dict[int(np.argmax(sizes))]
    final = {k: v.clone() for k, v in api.global_params.items()}
    n = SP_CPU_STEPS * args.batch_size
    trained = {}
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.float32),
                    ("cuda", torch.float64)):
        tr = ClassificationTrainer(model, args)
        tr.set_pad_to_batches(SP_CPU_STEPS)
        t0 = time.perf_counter()
        w, m = tr.train({k: v.to(dev, dt) for k, v in final.items()}, (x[:n], y[:n]),
                        dev, args)
        trained[dev, dt] = ({k: v.cpu().double() for k, v in w.items()}, m,
                            time.perf_counter() - t0)

    def leaf_err(a, b):
        return max(float((a[k] - v).abs().max()) / max(1.0, float(v.abs().max()))
                   for k, v in b.items())

    exact = trained["cuda", torch.float64][0]
    card32, cpu32 = trained["cuda", torch.float32][0], trained["cpu", torch.float32][0]
    card_vs_cpu, card_vs_64, cpu_vs_64 = (leaf_err(card32, cpu32), leaf_err(card32, exact),
                                          leaf_err(cpu32, exact))
    moved = max(float((cpu32[k] - final[k].cpu()).abs().max()) for k in final)
    print(f"  one client from the final weights, {SP_CPU_STEPS} steps of batch "
          f"{args.batch_size} (FP32, TF32 off), "
          f"worst leaf of its magnitude: card vs CPU {card_vs_cpu:.3g} (limit "
          f"{SP_PARAM_TOL}); against float64: card {card_vs_64:.3g} (limit "
          f"{SP_PARAM_TOL}), CPU {cpu_vs_64:.3g}; train loss "
          + ", ".join(f"{d} {t}: {r[1]['train_loss']:.6f} in {r[2]:.2f} s"
                      for (d, t), r in trained.items())
          + f"; the steps moved the weights by up to {moved:.3g}", flush=True)
    if not (card_vs_cpu <= SP_PARAM_TOL and card_vs_64 <= SP_PARAM_TOL and moved > 0):
        raise RuntimeError(f"the card's local steps disagree with the CPU's: "
                           f"{card_vs_cpu}, {card_vs_64} vs {cpu_vs_64}")

    # the fused sum of the last round's uploads against decode-then-sum
    pairs = uplinks["pairs"]
    cts = [ct for _, ct in pairs]
    w = agg_operator.FedMLAggOperator._weights(args, pairs)
    fused = fused_weighted_sum(cts, w)
    codec = get_codec(args.compression)
    decoded = [codec.decode(ct) for ct in cts]
    fused_err = 0.0
    for k, v in fused.items():
        ref = sum(float(wi) * d[k].double() for wi, d in zip(w, decoded))
        scale = float(ref.abs().max())
        err = float((v.double() - ref).abs().max())
        fused_err = max(fused_err, err / scale if scale else err)
    print(f"  fused_weighted_sum of round {args.comm_round - 1}'s {len(cts)} int8 uploads "
          f"on the card vs decode-and-sum in float64: worst leaf {fused_err:.3g} of its "
          f"magnitude (limit {SP_FUSED_REL_TOL})", flush=True)
    if not fused_err <= SP_FUSED_REL_TOL:
        raise RuntimeError(f"fused_weighted_sum disagrees with decode-and-sum: {fused_err}")

    # codec bits: the run's delta under the same key, on the card and the CPU
    delta = to_reference_layout(tree_delta(api.global_params, params0))
    delta_cpu = {k: v.cpu() for k, v in delta.items()}
    key = derive_key(args.random_seed, 0, 0)
    codec_ok = {}
    for spec in SP_CODECS:
        c = get_codec(spec)
        codec_ok[spec] = _same_wire(c.encode(delta, key=key, is_delta=True),
                                    c.encode(delta_cpu, key=key, is_delta=True))
    print(f"  codec bits, the run's {n_params}-element delta under derive_key(0, 0, 0), "
          f"card vs CPU: " + ", ".join(f"{k} {'identical' if v else 'DIFFER'}"
                                       for k, v in codec_ok.items()), flush=True)
    if not all(codec_ok.values()):
        raise RuntimeError(f"codec wire bytes differ between the card and the CPU: {codec_ok}")

    # busy share of local training, the bulk of a round: SP_PROFILE_STEPS
    # steps of the largest client from the final weights, profiled, over the
    # unprofiled wall of the same window (a whole round is ~1.2 M kernels,
    # too many to profile inside the script's time limit)
    tr = ClassificationTrainer(model, args)
    tr.set_pad_to_batches(SP_PROFILE_STEPS)
    window = (x[:SP_PROFILE_STEPS * args.batch_size], y[:SP_PROFILE_STEPS * args.batch_size])
    tr.train(api.global_params, window, "cuda", args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train(api.global_params, window, "cuda", args)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.train(api.global_params, window, "cuda", args)
        torch.cuda.synchronize()
    by_class = {}
    for key, (_, ms_) in _device_kernels(prof).items():
        c = sp_kernel_class(key)
        by_class[c] = by_class.get(c, 0.0) + ms_
    dev_ms = sum(by_class.values())
    busy = dev_ms / (window_s * 1e3) if dev_ms else None
    steady = rounds[-1]["round_sec"]
    samples = ds.train_data_num
    raw_bytes = 4 * n_params
    wire = rounds[-1]["uplink_bytes"]
    print(f"  {card}: last round {steady:.3f} s (with its test; the first round, cold, "
          f"when it is the only one) = "
          f"{samples / steady:.1f} training samples/s; {SP_PROFILE_STEPS} local steps: "
          f"{window_s * 1e3:.1f} ms wall, device time "
          + ("not measured" if busy is None else
             f"{dev_ms:.1f} ms (profiler), busy share {busy:.3f}")
          + f"; peak memory {peak_gb:.3f} GB; encode {rounds[-1]['encode_ms']:.2f} ms and "
          f"fused aggregation {rounds[-1]['aggregate_ms']:.2f} ms a round; uplink "
          f"{sum(wire) / len(wire):.0f} B a client (int8) vs {raw_bytes} B (f32), "
          f"{raw_bytes * len(wire) / sum(wire):.3f}x", flush=True)
    for c, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"    {c}: {v:.1f} ms", flush=True)
    return dict(rounds=[{k: v for k, v in r.items() if k != "clients"} for r in rounds],
                summary={k: v for k, v in summary.items() if isinstance(v, (int, float))},
                n_params=n_params, client_sizes=sizes, card_vs_cpu_err=card_vs_cpu,
                card_vs_float64_err=card_vs_64, cpu_vs_float64_err=cpu_vs_64,
                fused_rel_err=fused_err, codec_bits_identical=codec_ok,
                steady_round_s=steady, samples_per_s=samples / steady,
                profiled_steps=SP_PROFILE_STEPS, profiled_wall_ms=window_s * 1e3,
                profiled_device_ms=dev_ms, device_busy_share=busy,
                device_ms_by_class=by_class, peak_gb=peak_gb,
                uplink_bytes_per_client=sum(wire) / len(wire), f32_bytes=raw_bytes)


def _registry_flat(reg) -> dict:
    """The metrics registry as ``{name{labels}: value or histogram summary}``."""
    out = {}
    for m in reg._items():
        key = m.name + ("{" + ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
                        + "}" if m.labels else "")
        snap = m.snapshot()
        out[key] = (snap["value"] if "value" in snap else
                    {k: snap[k] for k in ("count", "sum", "max")})
    return out


def _events_ms(fn, reps: int = CS_TIMED_REPS) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls, CUDA events, after
    one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int = CS_TIMED_REPS) -> float:
    """Mean host-clock ms of ``fn()`` over ``reps`` calls after a warm one."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def cross_silo_inproc(card: str):
    """Phase (i1): ``run_cross_silo_inproc``'s federation over LOCAL on the
    card, with its checks (see the module doc)."""
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.compression import (
        CompressedTree,
        ErrorFeedback,
        derive_key,
        get_codec,
        tree_delta,
    )
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator
    from fedml_tpu_torch.models.convert import (
        from_reference_layout,
        from_wire_params,
        to_reference_layout,
        to_wire_params,
    )
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.telemetry import get_registry
    from fedml_tpu_torch.utils.serialization import safe_dumps, safe_loads

    args = load_arguments_from_dict(CS_CONFIG)
    t0 = time.perf_counter()
    ds = load_federated(args)
    data_s = time.perf_counter() - t0
    model = create(args, ds.class_num)
    LocalBroker.destroy(args.run_id)
    torch.cuda.reset_peak_memory_stats()
    server, clients = build_cross_silo_inproc(args, ds, model, "cuda")
    agg, smgr = server.fedml_aggregator, server.manager
    n_params = sum(v.numel() for v in agg.get_global_model_params().values())
    f32_bytes = 4 * n_params

    # what the run records: each upload as it reaches the aggregator, each
    # round's test and its end time, and the last round's broadcast and client
    # updates (for the timed replays below)
    uploads, rounds, last = [], [], {"updates": {}, "broadcast": None}
    add, test = agg.add_local_trained_result, agg.test_on_server_for_all_clients
    bcast = smgr._broadcast_payload

    def recorded_add(index, params, n, local_steps=None):
        uploads.append(dict(round=int(smgr.args.round_idx), index=index, n=int(n),
                            compressed=isinstance(params, CompressedTree),
                            codec=getattr(params, "codec", None),
                            delta=getattr(params, "is_delta", None),
                            wire=params.wire_nbytes() if isinstance(params, CompressedTree)
                            else None))
        return add(index, params, n, local_steps)

    def recorded_test(r):
        m = test(r)
        torch.cuda.synchronize()
        rounds.append(dict(round=r, end=time.perf_counter(),
                           test_loss=float(m["test_loss"]), test_acc=float(m["test_acc"])))
        return m

    def recorded_bcast(params):
        last["broadcast"] = bcast(params)
        return last["broadcast"]

    agg.add_local_trained_result, agg.test_on_server_for_all_clients = recorded_add, recorded_test
    smgr._broadcast_payload = recorded_bcast
    for c in clients:
        mgr = c.manager
        encode = mgr._encode_update

        def recorded_encode(weights, mgr=mgr, encode=encode):
            last["updates"][mgr.rank] = (weights, mgr._global_ref, mgr.round_idx)
            return encode(weights)

        mgr._encode_update = recorded_encode
    # the same upload posted twice: a resend keeps its message id, and the
    # server's dedup must drop the copy
    injected = []
    c1 = clients[0].manager
    send = c1.send_message

    def send_twice(msg):
        send(msg)
        if msg.get_type() == MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER and not injected:
            injected.append(msg.get("msg_id"))
            c1.com_manager.broker.post(0, msg)

    c1.send_message = send_twice
    dups0 = get_registry().counter("resilience/duplicates_dropped").value
    t_start = time.perf_counter()
    result = run_managers_to_completion([smgr] + [c.manager for c in clients], args.run_id,
                                        MyMessage.MSG_TYPE_CONNECTION_IS_READY, timeout=900)
    wall = time.perf_counter() - t_start
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dups = get_registry().counter("resilience/duplicates_dropped").value - dups0
    final = agg.get_global_model_params()
    for i, r in enumerate(rounds):
        r["round_s"] = r["end"] - (rounds[i - 1]["end"] if i else t_start)
        r["uploads"] = [u for u in uploads if u["round"] == r["round"]]
        r["samples"] = sum(u["n"] for u in r["uploads"])
        print(f"  {card}: round {r['round']}: {r['round_s']:.3f} s"
              + (" (with the handshake)" if i == 0 else "")
              + f", {len(r['uploads'])} uploads of {r['samples']} samples, test loss "
              f"{r['test_loss']:.5f}, test acc {r['test_acc']:.4f}", flush=True)
    ratios = [f32_bytes / u["wire"] for u in uploads if u["wire"]]
    bad = [u for u in uploads if not (u["compressed"] and u["codec"] == "int8" and u["delta"])]
    if result.get("rounds") != 2 or len(rounds) != 2:
        raise RuntimeError(f"the federation did not run 2 rounds: {result}")
    if not rounds[1]["test_loss"] < rounds[0]["test_loss"]:
        raise RuntimeError(f"the test loss did not fall: {[r['test_loss'] for r in rounds]}")
    if bad or len(ratios) != len(uploads) or min(ratios) < CS_WIRE_RATIO:
        raise RuntimeError(f"an upload was not an int8 delta at least {CS_WIRE_RATIO}x "
                           f"smaller than f32: {bad or min(ratios)}")
    if not (injected and dups == 1 and all(len(r["uploads"]) == 4 for r in rounds)):
        raise RuntimeError(f"the duplicate upload was not dropped once: injected "
                           f"{injected}, dropped {dups}, uploads a round "
                           f"{[len(r['uploads']) for r in rounds]}")
    if not all(v.is_cuda and bool(torch.isfinite(v).all()) for v in final.values()):
        raise RuntimeError("the global model left the card or is not finite")

    # the last round's work replayed alone, timed with CUDA events: the four
    # clients' encodes (delta in the reference's layout + error feedback),
    # the fused aggregation of their uploads, the layout conversions a round
    # makes (the decoded broadcast on the server and each client, and the
    # aggregate: 6 full trees in the port's layout from the reference's), and
    # the uncompressed message form's round trip
    codec = get_codec(args.compression)
    seed, efs = int(args.random_seed), {}
    updates = sorted(last["updates"].items())

    def encode_round():
        cts = []
        for rank, (w, ref, r) in updates:
            ef = efs.setdefault(rank, ErrorFeedback(codec))
            cts.append(ef.encode(to_reference_layout(tree_delta(w, ref)),
                                 key=derive_key(seed, r, rank)))
        return cts

    cts = encode_round()
    pairs = [(ds.train_data_local_num_dict[i], ct) for i, ct in enumerate(cts)]
    base = to_reference_layout(agg.get_upload_base() or final)
    encode_ms = _events_ms(encode_round)
    aggregate_ms = _events_ms(lambda: FedMLAggOperator.agg_compressed(args, pairs, base))
    convert_ms = _events_ms(lambda: from_reference_layout(to_reference_layout(final)))
    wire_form_ms = _events_ms(lambda: from_wire_params(to_wire_params(final), "cuda"))
    # the BROKER transport's (de)serialization of the same payloads, warm, on
    # the host's clock (safe_dumps ends in a device sync, safe_loads is
    # followed by one)
    ser = {}
    for name, obj in (("broadcast", last["broadcast"]), ("upload", cts[0])):
        blob = safe_dumps(obj)
        ser[f"{name}_dumps_ms"] = _host_ms(lambda: safe_dumps(obj))
        ser[f"{name}_loads_ms"] = _host_ms(
            lambda: (safe_loads(blob, "cuda"), torch.cuda.synchronize()))
        ser[f"{name}_bytes"] = len(blob)
    steady = rounds[-1]
    print(f"  {card}: steady round {steady['round_s']:.3f} s (with its 10,000-image test) = "
          f"{steady['samples'] / steady['round_s']:.1f} training samples/s; whole run "
          f"{wall:.3f} s; data made in {data_s:.1f} s; peak memory {peak_gb:.3f} GB",
          flush=True)
    print(f"  {card}: a round's encode (4 uploads) {encode_ms:.2f} ms, fused aggregation "
          f"{aggregate_ms:.2f} ms, layout conversion {convert_ms:.2f} ms a tree x 6 = "
          f"{6 * convert_ms:.2f} ms, message-form round trip {wire_form_ms:.3f} ms "
          f"(CUDA events, mean of {CS_TIMED_REPS}); uploads "
          f"{sum(u['wire'] for u in uploads) / len(uploads):.0f} B vs {f32_bytes} B f32 "
          f"(min {min(ratios):.3f}x); duplicate dropped {int(dups)}", flush=True)
    print(f"  {card}: warm safe_dumps / safe_loads onto the card (host clock, mean of "
          f"{CS_TIMED_REPS}): broadcast ({ser['broadcast_bytes']} B) "
          f"{ser['broadcast_dumps_ms']:.2f} / {ser['broadcast_loads_ms']:.2f} ms, one upload "
          f"({ser['upload_bytes']} B) {ser['upload_dumps_ms']:.2f} / "
          f"{ser['upload_loads_ms']:.2f} ms", flush=True)
    return dict(rounds=[{k: v for k, v in r.items() if k not in ("end", "uploads")}
                        for r in rounds], n_params=n_params, f32_bytes=f32_bytes,
                upload_bytes=[u["wire"] for u in uploads], min_ratio=min(ratios),
                duplicates_dropped=dups, wall_s=wall, data_s=data_s, peak_gb=peak_gb,
                steady_round_s=steady["round_s"],
                samples_per_s=steady["samples"] / steady["round_s"],
                encode_ms=encode_ms, aggregate_ms=aggregate_ms,
                layout_convert_ms_per_tree=convert_ms, wire_form_round_trip_ms=wire_form_ms,
                serialization_ms=ser,
                result={k: v for k, v in result.items() if isinstance(v, (int, float))})


# the code each process of phase (i2) runs: one entry point, as a user starts
# it with ``--cf config --rank r --role ...``, then its result and registry
# (and the server's final digest); phase r2 sets the environment variables
# it reads
CS_CHILD = r"""
import json, os, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if os.environ.get("CHIP_SMOKE_DETERMINISTIC"):  # phase r2's twins
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
import fedml_tpu_torch
from chip_smoke import _registry_flat, untraced
if os.environ.get("CHIP_SMOKE_UNTRACED"):  # phase r2's untraced twin
    untraced()
from fedml_tpu_torch import runner as runner_mod
from fedml_tpu_torch.resilience.durability.recover import digest
from fedml_tpu_torch.telemetry import get_registry
t0 = time.perf_counter()
role = sys.argv[1]
built = {}
build = runner_mod.FedMLRunner.__init__
def recording_build(self, args, *a, **kw):
    build(self, args, *a, **kw)
    built["runner"] = self.runner
runner_mod.FedMLRunner.__init__ = recording_build
fn = {"server": fedml_tpu_torch.run_cross_silo_server,
      "client": fedml_tpu_torch.run_cross_silo_client}[role]
result = fn()
torch.cuda.synchronize()
record = {"role": role, "result": result, "wall_s": time.perf_counter() - t0,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "pid": os.getpid(),
          "metrics": _registry_flat(get_registry())}
if role == "server":
    record["digest"] = digest(built["runner"].fedml_aggregator.get_global_model_params())
print("CHILD " + json.dumps(record), flush=True)
if os.environ.get("CHIP_SMOKE_HOLD") == sys.argv[sys.argv.index("--rank") + 1]:
    print("HOLD", flush=True)  # phase r2 sends this rank SIGTERM now
    time.sleep(300)
"""


class S3Stub:
    """An S3 endpoint on 127.0.0.1 for one key pair: path-style PUT, GET and
    DELETE of ``/{bucket}/{key}``, each request's SigV4 signature recomputed
    from the AWS specification (independently of the port's ``s3_store``)
    with the region its credential scope names, and each PUT's body held
    to its ``x-amz-content-sha256``. A request that fails either check gets
    403 or 400 and lands in ``failures``; ``requests`` counts the rest by
    method, ``log`` lists them (method, path, the region signed), and
    ``bytes_in`` / ``bytes_out`` count their bodies."""

    _AUTH = re.compile(r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d{8})/([^/]+)/s3/aws4_request, "
                       r"SignedHeaders=host;x-amz-content-sha256;x-amz-date, "
                       r"Signature=([0-9a-f]{64})$")

    def __init__(self, access_key: str, secret_key: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.access_key, self.secret_key = access_key, secret_key
        self.blobs: dict = {}
        self.requests: dict = {}
        self.log: list = []
        self.failures: list = []
        self.bytes_in = self.bytes_out = 0
        self._lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_PUT(self):
                stub._serve(self)

            do_GET = do_DELETE = do_PUT

            def log_message(self, *a):
                pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self._srv.server_address[1]}"

    def start(self) -> "S3Stub":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    def signature(self, method, path, host, amz_date, payload_hash, region) -> str:
        import hashlib
        import hmac

        creq = "\n".join([method, path, "", f"host:{host}\nx-amz-content-sha256:"
                          f"{payload_hash}\nx-amz-date:{amz_date}\n",
                          "host;x-amz-content-sha256;x-amz-date", payload_hash])
        scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
        k = ("AWS4" + self.secret_key).encode()
        for part in (amz_date[:8], region, "s3", "aws4_request"):
            k = hmac.new(k, part.encode(), hashlib.sha256).digest()
        return hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()

    def _serve(self, h) -> None:
        import hashlib

        method, path = h.command, h.path
        body = h.rfile.read(int(h.headers.get("Content-Length", 0) or 0))
        amz_date = h.headers.get("x-amz-date", "")
        payload_hash = h.headers.get("x-amz-content-sha256", "")
        m = self._AUTH.match(h.headers.get("Authorization", ""))
        ok = (m is not None and m.group(1) == self.access_key and m.group(2) == amz_date[:8]
              and m.group(4) == self.signature(method, path, h.headers.get("Host", ""),
                                               amz_date, payload_hash, m.group(3)))
        if not ok or hashlib.sha256(body).hexdigest() != payload_hash:
            with self._lock:
                self.failures.append((method, path))
            h.send_error(403 if not ok else 400)
            return
        with self._lock:
            self.requests[method] = self.requests.get(method, 0) + 1
            self.log.append((method, path, m.group(3)))
            self.bytes_in += len(body)
            if method == "PUT":
                self.blobs[path] = body
                blob = b""
            elif method == "GET":
                blob = self.blobs.get(path)
            else:
                self.blobs.pop(path, None)
                blob = b""
            if blob is not None:
                self.bytes_out += len(blob)
        if blob is None:
            h.send_error(404, "NoSuchKey")
            return
        h.send_response(200 if method != "DELETE" else 204)
        h.send_header("Content-Length", str(len(blob)))
        h.end_headers()
        h.wfile.write(blob)


def free_port_base(n: int) -> int:
    """A base port with ``n`` consecutive ports free on 127.0.0.1 (bound and
    released here)."""
    import random
    import socket

    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    while True:
        base = rng.randrange(20000, 60000 - n)
        socks = []
        try:
            for i in range(n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()


def _federation_processes(run_id: str, n_silos: int, comm: dict, train: dict,
                          child: str = CS_CHILD, child_args=(), silo_configs=None,
                          env=None, timeout: float = CS_BROKER_TIMEOUT_S, hold=None):
    """A server and ``n_silos`` silos as OS processes, started through the
    entry points with a config this writes (CS_CONFIG with ``train`` over
    its training arguments and ``comm`` as its transport; ``silo_configs``,
    one dict a silo, become the silos' override files). Returns each
    process's CHILD record and the wall; fails unless every process exits 0
    within ``timeout``. ``hold=(rank, fn)``: that rank (CS_CHILD) stays up
    after its CHILD line, and once every other process has exited,
    ``fn(process)`` ends it; its record gains ``held_rc``, its exit code."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_cs_")
    procs = []
    try:
        cfg = json.loads(json.dumps(CS_CONFIG))
        cfg["common_args"]["run_id"] = run_id
        cfg["train_args"].update(client_num_in_total=n_silos,
                                 client_num_per_round=n_silos, comm_round=1)
        cfg["train_args"].update(train)
        cfg["comm_args"] = {"object_store_dir": os.path.join(work, "store"),
                            "payload_offload_bytes": 65536, **comm}
        if silo_configs:
            paths = []
            for r, silo in enumerate(silo_configs, 1):
                paths.append(os.path.join(work, f"silo{r}.json"))
                with open(paths[-1], "w") as f:
                    json.dump(silo, f)
            cfg["client_specific_args"] = {"data_silo_config": paths}
        path = os.path.join(work, "fedml_config.yaml")
        with open(path, "w") as f:  # YAML in its JSON form: the card has no PyYAML
            json.dump(cfg, f, indent=1)
        env = dict(os.environ, PYTHONHASHSEED=CS_HASHSEED, **(env or {}),
                   PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for k in ("MASTER_ADDR", "MASTER_PORT"):  # the config names the rendezvous
            env.pop(k, None)
        held = None if hold is None else hold[0]
        if held is not None:
            env["CHIP_SMOKE_HOLD"] = str(held)
        t0 = time.perf_counter()
        for rank in range(n_silos + 1):
            role = "server" if rank == 0 else "client"
            # the held rank writes into files: nobody reads its pipes while it waits
            sink = (dict(stdout=open(os.path.join(work, "held.out"), "w"),
                         stderr=open(os.path.join(work, "held.err"), "w"))
                    if rank == held else dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", child, role, *child_args, "--cf", path, "--rank",
                 str(rank), "--role", role], cwd=here, env=env, text=True, **sink))
        outs = []
        for rank, p in enumerate(procs):
            if rank == held:
                outs.append(None)
                continue
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                outs.append(p.communicate(timeout=left))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"a process of federation {run_id} did not exit within "
                                   f"{timeout} s") from None
        wall = time.perf_counter() - t0
        codes = [p.returncode for rank, p in enumerate(procs) if rank != held]
        if held is not None:
            held_out = os.path.join(work, "held.out")
            while "\nHOLD\n" not in "\n" + open(held_out).read():
                if procs[held].poll() is not None:
                    break  # it died before holding: its code shows below
                if time.perf_counter() - t0 > timeout:
                    raise RuntimeError(f"rank {held} of {run_id} never held")
                time.sleep(0.05)
            held_rc = hold[1](procs[held]) if procs[held].poll() is None else None
            outs[held] = (open(held_out).read(), open(os.path.join(work, "held.err")).read())
        if any(codes):
            tails = "\n".join(err[-2000:] for _, err in outs)
            raise RuntimeError(f"federation {run_id}'s processes exited {codes}:\n{tails}")
        kids = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("CHILD "))[6:])
                for out, _ in outs]
        if held is not None:
            kids[held]["held_rc"] = held_rc
            kids[held]["held_stderr"] = outs[held][1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    return kids, wall


def _broker_federation(run_id: str, n_silos: int, hold=None, env=None, child=CS_CHILD,
                       **train):
    """A server and ``n_silos`` silos as OS processes over the port's broker
    and a shared object store (phase h's model and data, ``train`` over
    CS_CONFIG's training arguments; ``hold``, ``env`` and ``child`` as
    ``_federation_processes``'s).
    Returns each process's CHILD record, the wall and the bytes published on
    the broker; fails unless every process exits 0 within
    CS_BROKER_TIMEOUT_S."""
    from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker
    from fedml_tpu_torch.telemetry import get_registry

    published0 = get_registry().counter("broker/bytes_in").value
    broker = PubSubBroker("127.0.0.1", 0).start()
    try:
        host, port = broker.address
        kids, wall = _federation_processes(
            run_id, n_silos, {"comm_backend": "BROKER", "broker_host": host,
                              "broker_port": port}, train, child=child, env=env,
            hold=hold)
    finally:
        broker.stop()
    return kids, wall, get_registry().counter("broker/bytes_in").value - published0


def cross_silo_broker(card: str):
    """Phase (i2): a server and CS_BROKER_SILOS silos as OS processes over
    the port's broker and a shared object store (see the module doc)."""
    kids, wall, published = _broker_federation("chip_smoke_broker", CS_BROKER_SILOS,
                                               client_num_in_total=CS_BROKER_PARTS)
    server = kids[0]
    sm = server["metrics"]
    store_bytes = sum(k["metrics"].get("comm/offload_wire_bytes", 0) for k in kids)
    bcast_offloads = sm.get("comm/serialize_ms{part=offload}", {}).get("count", 0)

    def hist(m, key):
        h = m.get(key, {})
        return h["sum"] / h["count"] if h.get("count") else None

    round_ms = hist(sm, "cross_silo/round_ms")
    ser = dict(broadcast_dumps_ms=hist(sm, "comm/serialize_ms{part=offload}"),
               broadcast_loads_ms=hist(kids[1]["metrics"], "comm/deserialize_ms{part=offload}"),
               upload_dumps_ms=hist(kids[1]["metrics"], "comm/serialize_ms{part=offload}"),
               upload_loads_ms=hist(sm, "comm/deserialize_ms{part=offload}"))
    if server["result"].get("rounds") != 1:
        raise RuntimeError(f"the broker federation's server did not run 1 round: "
                           f"{server['result']}")
    if bcast_offloads != CS_BROKER_SILOS or None in ser.values():
        raise RuntimeError(f"the broadcast did not go through the object store: "
                           f"{bcast_offloads} offloads, {ser}")
    print(f"  {card}: {CS_BROKER_SILOS + 1} processes exited 0 in {wall:.3f} s (limit "
          f"{CS_BROKER_TIMEOUT_S} s); server result {server['result']}", flush=True)
    print(f"  {card}: the round {round_ms:.1f} ms (broadcast to test, the server's "
          f"clock); bytes published on the broker {published:.0f}, written to the store "
          f"{store_bytes:.0f} (the broadcast {CS_BROKER_SILOS}x, each upload once); "
          f"safe_dumps / safe_loads ms (each process's first, cold): broadcast "
          f"{ser['broadcast_dumps_ms']:.2f} / {ser['broadcast_loads_ms']:.2f}, one upload "
          f"{ser['upload_dumps_ms']:.2f} / {ser['upload_loads_ms']:.2f}; process walls "
          + ", ".join(f"{k['role']} {k['wall_s']:.1f} s" for k in kids), flush=True)
    return dict(wall_s=wall, round_ms=round_ms, broker_bytes_published=published,
                store_bytes_written=store_bytes, serialization_ms=ser,
                result=server["result"], process_walls_s=[k["wall_s"] for k in kids],
                peak_gb=[k["peak_gb"] for k in kids])


# what each process of phase (o) runs: its entry point (``run_cross_silo_*``,
# or ``run_cross_cloud_*`` for the cross-cloud leg) under cuDNN's
# deterministic algorithms, then its result and registry; the server adds
# the untrained model's test loss (taken before the round) and the final
# digest, a silo the transport keys it applied
O_CHILD = r"""
import json, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
import fedml_tpu_torch
from chip_smoke import _registry_flat
from fedml_tpu_torch import runner as runner_mod
from fedml_tpu_torch.resilience.durability.recover import digest
from fedml_tpu_torch.telemetry import get_registry
t0 = time.perf_counter()
role, kind = sys.argv[1], sys.argv[2]
built = {}
build = runner_mod.FedMLRunner.__init__
def recording_build(self, args, *a, **kw):
    build(self, args, *a, **kw)
    built["args"], built["runner"] = args, self.runner
    if role == "server":
        agg = self.runner.fedml_aggregator
        built["untrained"] = agg.test_on_server_for_all_clients(-1)["test_loss"]
runner_mod.FedMLRunner.__init__ = recording_build
fn = getattr(fedml_tpu_torch, f"run_{kind}_{role}")
result = fn()
torch.cuda.synchronize()
a = built["args"]
record = {"role": role, "result": result, "wall_s": time.perf_counter() - t0,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "training_type": a.training_type, "runner": type(built["runner"]).__name__,
          "applied": {k: getattr(a, k, None) for k in (
              "comm_backend", "broker_host", "broker_port", "remote_storage", "s3_endpoint",
              "s3_bucket", "s3_region")},
          "metrics": _registry_flat(get_registry())}
if role == "server":
    record["untrained_test_loss"] = built["untrained"]
    record["digest"] = digest(built["runner"].fedml_aggregator.get_global_model_params())
print("CHILD " + json.dumps(record), flush=True)
"""


def _start_native_broker_command():
    """``python -m fedml_tpu_torch.cli deploy broker --native --port 0`` in
    its own session; returns the process and the address it prints."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "fedml_tpu_torch.cli", "deploy", "broker",
                             "--native", "--port", "0"], cwd=here, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    box = []
    reader = threading.Thread(target=lambda: box.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(O_BROKER_TIMEOUT_S)
    line = (box[0] if box else "").strip()
    if not (line.startswith("broker on ") and line.endswith("(native)")):
        _stop_session(proc)
        raise RuntimeError(f"deploy broker --native printed {line!r}: "
                           f"{proc.stderr.read()[-2000:] if proc.poll() is not None else ''}")
    host, port = line.split()[2].rsplit(":", 1)
    return proc, (host, int(port))


def _stop_session(proc) -> None:
    """Interrupt a command started in its own session (its finally stops
    what it started), then kill the whole session if it lingers."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)  # the broker binary, were it orphaned
    except ProcessLookupError:
        pass
    if proc.poll() is None:
        proc.wait()
    for f in (proc.stdout, proc.stderr):
        f.close()


def _leg_numbers(kids) -> dict:
    """A leg's wire bytes by backend, broker and store bytes, and mean S3
    request ms, summed over its processes' registries."""
    def total(key):
        return sum(k["metrics"].get(key, 0) for k in kids)

    def mean_ms(key):
        hs = [k["metrics"][key] for k in kids if key in k["metrics"]]
        n = sum(h["count"] for h in hs)
        return sum(h["sum"] for h in hs) / n if n else None

    wire = {b: {"out": total(f"comm/wire_bytes_out{{backend={b}}}"),
                "in": total(f"comm/wire_bytes_in{{backend={b}}}")} for b in ("grpc", "trpc")}
    wire["broker"] = {"out": total("comm/wire_bytes_out"), "in": total("comm/wire_bytes_in")}
    sm = kids[0]["metrics"].get("cross_silo/round_ms", {})
    return dict(wire_bytes={b: v for b, v in wire.items() if v["out"] or v["in"]},
                broker_client_bytes_out=total("broker/client_bytes_out"),
                broker_client_bytes_in=total("broker/client_bytes_in"),
                store_bytes_written=total("comm/offload_wire_bytes"),
                s3_put_ms=mean_ms("store/s3_ms{method=PUT}"),
                s3_get_ms=mean_ms("store/s3_ms{method=GET}"),
                round_ms=sm["sum"] / sm["count"] if sm.get("count") else None)


def transports_phase(card: str):
    """Phase (o): three federations at once over tRPC, the cross-cloud
    engine on the C++ broker with the S3 stub, and gRPC (see the module
    doc)."""
    train = dict(client_num_in_total=O_PARTS)
    stub = S3Stub(*O_S3_KEYS).start()
    broker_proc, (host, port) = _start_native_broker_command()
    legs = {}
    try:
        s3 = {"remote_storage": "s3", "s3_endpoint": stub.endpoint,
              "s3_bucket": "fedml-cross-cloud"}
        silo_files = [{"comm_args": {"broker_host": host, "broker_port": port, **s3,
                                     "s3_region": O_S3_REGIONS[r]}}
                      for r in range(1, O_SILOS + 1)]
        plans = {
            "o1": (dict(comm_backend="TRPC", trpc_master_addr="127.0.0.1",
                        trpc_master_port=free_port_base(1)), "cross_silo", None, None),
            "o2": (dict(comm_backend="BROKER", broker_host=host, broker_port=port, **s3,
                        s3_region=O_S3_REGIONS[0]), "cross_cloud", silo_files,
                   dict(AWS_ACCESS_KEY_ID=O_S3_KEYS[0], AWS_SECRET_ACCESS_KEY=O_S3_KEYS[1])),
            "o3": (dict(comm_backend="GRPC", grpc_base_port=free_port_base(O_SILOS + 1)),
                   "cross_silo", None, None),
        }
        with ThreadPoolExecutor(len(plans)) as pool:
            futures = {leg: pool.submit(
                _federation_processes, f"chip_smoke_{leg}", O_SILOS, comm, train,
                child=O_CHILD, child_args=(kind,), silo_configs=silos, env=env,
                timeout=O_TIMEOUT_S) for leg, (comm, kind, silos, env) in plans.items()}
            legs = {leg: f.result() for leg, f in futures.items()}
    finally:
        _stop_session(broker_proc)
        stub.stop()
    out, digests, faults = {}, {}, []
    for leg, (kids, wall) in legs.items():
        server = kids[0]
        loss, untrained = server["result"]["test_loss"], server["untrained_test_loss"]
        numbers = _leg_numbers(kids)
        out[leg] = dict(wall_s=wall, result=server["result"], untrained_test_loss=untrained,
                        digest=server["digest"], runners=[k["runner"] for k in kids],
                        process_walls_s=[k["wall_s"] for k in kids],
                        peak_gb=[k["peak_gb"] for k in kids], **numbers)
        digests[leg] = server["digest"]
        print(f"  {card}: {leg} ({plans[leg][0]['comm_backend']}, {plans[leg][1]}): "
              f"{O_SILOS + 1} processes exited 0 in {wall:.3f} s (limit {O_TIMEOUT_S} s), "
              f"the round {numbers['round_ms']} ms (the server's clock); test loss untrained "
              f"{untrained:.5f} -> {loss:.5f}; wire bytes out/in by backend "
              f"{numbers['wire_bytes']}; digest {server['digest']}; process walls "
              + ", ".join(f"{k['role']} {k['wall_s']:.1f} s" for k in kids), flush=True)
        if server["result"].get("rounds") != 1:
            faults.append(f"{leg}: the server did not run 1 round: {server['result']}")
        if not (math.isfinite(loss) and loss < untrained):
            faults.append(f"{leg}: the test loss {loss} is not below the untrained model's "
                          f"{untrained}")
    o2 = out["o2"]
    kids2 = legs["o2"][0]
    gets = [p for (m, p, _) in stub.log if m == "GET" and "/chip_smoke_o2/r0/" in p]
    regions = sorted({r for (_, _, r) in stub.log})
    o2.update(stub_requests=dict(stub.requests), stub_failures=len(stub.failures),
              stub_bytes_in=stub.bytes_in, stub_bytes_out=stub.bytes_out,
              broadcast_gets=len(gets), regions_signed=regions,
              applied=[k["applied"] for k in kids2])
    print(f"  {card}: o2 the native broker carried {o2['broker_client_bytes_out']} B "
          f"published, {o2['broker_client_bytes_in']} B delivered (the clients' counts); "
          f"the S3 stub {o2['stub_requests']} requests, {o2['stub_failures']} failed, "
          f"{o2['stub_bytes_in']} B in and {o2['stub_bytes_out']} B out (the processes "
          f"offloaded {o2['store_bytes_written']} B), SigV4 PUT {o2['s3_put_ms']} ms, GET "
          f"{o2['s3_get_ms']} ms a request (mean, client clock, signing included); "
          f"regions signed {regions}; silos applied "
          f"{[a['s3_region'] for a in o2['applied'][1:]]}", flush=True)
    if stub.failures or o2["broadcast_gets"] != O_SILOS or regions != sorted(O_S3_REGIONS):
        faults.append(f"o2: the S3 stub saw failures {stub.failures[:4]}, "
                      f"{o2['broadcast_gets']} broadcast fetches, regions {regions}")
    for r, (kid, silo) in enumerate(zip(kids2[1:], silo_files), 1):
        want = silo["comm_args"]
        if any(kid["applied"][k] != v for k, v in want.items()) or (
                kid["training_type"], kid["runner"]) != ("cross_cloud", "CloudClient"):
            faults.append(f"o2: silo {r} applied {kid['applied']} ({kid['training_type']}, "
                          f"{kid['runner']}), not {want}")
    if kids2[0]["runner"] != "CloudServer":
        faults.append(f"o2: the server ran as {kids2[0]['runner']}")
    if len(set(digests.values())) != 1:
        faults.append(f"o: the legs' final global models differ: {digests}")
    if faults:
        raise RuntimeError("phase o failed:\n" + "\n".join(faults))
    return out


def _reset_trust():
    from fedml_tpu_torch.core.alg_frame.params import Context
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker
    from fedml_tpu_torch.core.security.defender import FedMLDefender

    for singleton in (FedMLAttacker, FedMLDefender, FedMLDifferentialPrivacy, Context):
        singleton.reset()


class _CorruptOnce:
    """A client's error feedback whose first upload is corrupted after
    encoding (its residual is the honest one), as a faulty wire would."""

    def __init__(self, inner, corrupt):
        self.inner, self.corrupt = inner, corrupt

    def __getattr__(self, k):
        return getattr(self.inner, k)

    def encode(self, tree, key=None):
        ct = self.inner.encode(tree, key=key)
        corrupt, self.corrupt = self.corrupt, None
        return corrupt(ct) if corrupt else ct


def _corrupted(ct, fn):
    from fedml_tpu_torch.compression import CompressedTree

    arrays = [[fn(i, p) for p in parts] for i, parts in enumerate(ct.arrays)]
    return CompressedTree(ct.codec, ct.version, ct.is_delta, ct.raw_nbytes, ct.meta,
                          ct.structure, arrays)


def _tree_dist(a, b) -> float:
    return math.sqrt(sum(float(torch.sum((a[k].double() - b[k].double()) ** 2))
                         for k in a))


def _integrity_counts(reg) -> dict:
    return {k: v for k, v in _registry_flat(reg).items()
            if k.startswith("integrity/") or k.startswith("health/")}


def trust_sp_phase(card: str):
    """Phase (j1, j2): the integrity rings and the decode fallback in the
    sp simulation, with their checks (see the module doc)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.compression import ErrorFeedback, fused_weighted_sum
    from fedml_tpu_torch.core.security.defender import FedMLDefender
    from fedml_tpu_torch.core.security.defense import _REGISTRY, available_defenses
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.integrity import fused_robust_sum, screen_stats
    from fedml_tpu_torch.ml.aggregator import agg_operator
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.simulator import create_simulator
    from fedml_tpu_torch.telemetry import get_registry

    _reset_trust()
    args = fedml_tpu_torch.init(load_arguments_from_dict(TRUST_SP_CONFIG))
    t0 = time.perf_counter()
    ds = load_federated(args)
    data_s = time.perf_counter() - t0
    model = create(args, ds.class_num)
    reg = get_registry()
    before = _integrity_counts(reg)
    torch.cuda.reset_peak_memory_stats()
    sim = create_simulator(args, "cuda", ds, model)
    api = sim.fl_trainer
    nan_scale = lambda i, p: (p.clone().fill_(float("nan"))  # noqa: E731
                              if i == 0 and p.is_floating_point() else p)
    scaled = lambda i, p: p * TRUST_SCALE if p.is_floating_point() else p  # noqa: E731
    for cid, fn in ((TRUST_NAN_CLIENT, nan_scale), (TRUST_SCALED_CLIENT, scaled)):
        api._ef_by_client[cid] = _CorruptOnce(ErrorFeedback(api._codec),
                                              lambda ct, fn=fn: _corrupted(ct, fn))
    rounds, uplinks = [], []
    orig_agg = agg_operator.FedMLAggOperator.agg_compressed

    def capture(args_, raw_list, global_params, **kw):
        uplinks.append((raw_list, global_params, kw))
        return orig_agg(args_, raw_list, global_params, **kw)

    inner_round = api.train_one_round

    def recorded(r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = inner_round(r)
        torch.cuda.synchronize()
        rep["round_sec"] = time.perf_counter() - t0
        rounds.append(rep)
        print(f"  {card}: j1 round {r}: {rep['round_sec']:.3f} s, clients "
              f"{rep['clients']}, test loss {rep['test_loss']:.5f}, test acc "
              f"{rep['test_acc']:.4f}, screen {rep['screen_ms']:.2f} ms, encode "
              f"{rep['encode_ms']:.2f} ms, robust aggregation {rep['aggregate_ms']:.2f} ms",
              flush=True)
        return rep

    api.train_one_round = recorded
    agg_operator.FedMLAggOperator.agg_compressed = staticmethod(capture)
    try:
        sim.run()
    finally:
        agg_operator.FedMLAggOperator.agg_compressed = staticmethod(orig_agg)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {k: v - before.get(k, 0) for k, v in _integrity_counts(reg).items()
              if isinstance(v, (int, float))}
    losses = [r["test_loss"] for r in rounds]
    if not (len(rounds) == 2 and all(math.isfinite(x) for x in losses)
            and losses[1] < losses[0]):
        raise RuntimeError(f"j1: the test loss did not fall from round 0: {losses}")
    if not (counts.get("integrity/nonfinite_uploads") == 1
            and counts.get("integrity/quarantined") == 1
            and api._quarantine.reason(TRUST_NAN_CLIENT) is not None
            and TRUST_NAN_CLIENT not in rounds[1]["clients"]
            and len(rounds[1]["clients"]) == args.client_num_per_round - 1):
        raise RuntimeError(f"j1: the NaN upload was not screened and its sender "
                           f"quarantined: {counts}, round 1 clients {rounds[1]['clients']}")
    # containment: round 0's uploads (the NaN one already dropped)
    pairs, base, kw = uplinks[0]
    if kw.get("agg_robust") != "trimmed_mean@0.2" or len(pairs) != 9:
        raise RuntimeError(f"j1: round 0 did not aggregate 9 uploads robustly: {kw}, "
                           f"{len(pairs)}")
    cts = [ct for _, ct in pairs]
    w = agg_operator.FedMLAggOperator._weights(args, pairs)
    kept = [c for c in rounds[0]["clients"] if c != TRUST_NAN_CLIENT]
    bad = kept.index(TRUST_SCALED_CLIENT)
    honest = [i for i in range(len(cts)) if i != bad]
    hw = w[honest] / w[honest].sum()
    robust = fused_robust_sum(cts, "trimmed_mean", 0.2)
    mean = fused_weighted_sum(cts, w)
    honest_mean = fused_weighted_sum([cts[i] for i in honest], hw)
    d_robust, d_mean = _tree_dist(robust, honest_mean), _tree_dist(mean, honest_mean)
    if not d_robust <= TRUST_CONTAIN * d_mean:
        raise RuntimeError(f"j1: the x{TRUST_SCALE:g} upload was not contained: "
                           f"{d_robust} vs the weighted mean's {d_mean}")
    screen_ms = _events_ms(lambda: screen_stats(cts[0]))
    robust_ms = _events_ms(lambda: fused_robust_sum(cts, "trimmed_mean", 0.2))
    weighted_ms = _events_ms(lambda: fused_weighted_sum(cts, w))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_robust_sum(cts, "trimmed_mean", 0.2)
    torch.cuda.synchronize()
    robust_extra_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
    print(f"  {card}: j1 screen_stats {screen_ms:.3f} ms an upload; fused_robust_sum "
          f"(trimmed_mean@0.2) {robust_ms:.2f} ms vs fused_weighted_sum {weighted_ms:.2f} ms "
          f"on round 0's {len(cts)} uploads (CUDA events, mean of {CS_TIMED_REPS}); "
          f"the robust sum's transient {robust_extra_gb:.3f} GB; peak {peak_gb:.3f} GB; "
          f"x{TRUST_SCALE:g} upload's pull on the aggregate: trimmed mean {d_robust:.4g}, "
          f"weighted mean {d_mean:.4g} (limit {TRUST_CONTAIN} of it); data made in "
          f"{data_s:.1f} s", flush=True)
    print(f"  {card}: j1 counters {json.dumps(counts, sort_keys=True)}", flush=True)
    j1 = dict(rounds=[{k: v for k, v in r.items() if k != "uplink_bytes"} for r in rounds],
              counters=counts, screen_ms=screen_ms, robust_ms=robust_ms,
              weighted_ms=weighted_ms, robust_extra_gb=robust_extra_gb, peak_gb=peak_gb,
              contained=d_robust, weighted_pull=d_mean)
    del sim, api, uplinks, cts, pairs, robust, mean, honest_mean
    gc.collect()
    torch.cuda.empty_cache()

    # j2: the decode fallback (a model attack needs the decoded models)
    _reset_trust()
    args = fedml_tpu_torch.init(load_arguments_from_dict(TRUST_DECODE_CONFIG))
    sim = create_simulator(args, "cuda", ds, model)
    defender = FedMLDefender.get_instance()
    chosen, cohort = [], []
    before_hook = defender.defend_before_aggregation

    def recording(raw_client_grad_list, extra_auxiliary_info=None):
        out = before_hook(raw_client_grad_list, extra_auxiliary_info)
        chosen.append([next(i for i, p in enumerate(raw_client_grad_list) if p is o)
                       for o in out])
        cohort.append(list(raw_client_grad_list))
        return out

    defender.defend_before_aggregation = recording
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = sim.run()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    if not (chosen and len(chosen[0]) == 1 and chosen[0][0] >= args.byzantine_client_num
            and math.isfinite(rep["test_loss"])):
        raise RuntimeError(f"j2: krum did not select a benign update: {chosen}, {rep}")
    print(f"  {card}: j2 round {round_s:.3f} s (decode fallback, byzantine on the first "
          f"{args.byzantine_client_num} of {len(cohort[0])}): krum kept update "
          f"{chosen[0][0]}; test loss {rep['test_loss']:.5f}, acc {rep['test_acc']:.4f}",
          flush=True)
    updates = cohort[0]
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    defenses = {}
    names = {}
    for name in available_defenses():
        names.setdefault(_REGISTRY[name], []).append(name)
    import types

    for cls, aliases in names.items():
        _reset_trust()
        dargs = types.SimpleNamespace(**vars(args))
        dargs.defense_type = aliases[0]
        FedMLDefender.get_instance().init(dargs)
        d = FedMLDefender.get_instance()

        def chain():
            kept = d.defend_before_aggregation(updates, None)
            agg = d.defend_on_aggregation(kept, agg_operator.FedMLAggOperator.agg, None)
            return d.defend_after_aggregation(agg)

        chain()  # warm
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = chain()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        extra = (torch.cuda.max_memory_allocated() - resident) / 1e9
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        defenses["/".join(aliases)] = dict(ms=ms, extra_gb=extra, finite=finite)
        print(f"    {'/'.join(aliases)}: {ms:.2f} ms (before + on + after aggregation, "
              f"host clock after a warm call), {extra:.3f} GB above the 10 updates, "
              f"finite {finite}", flush=True)
        if not finite:
            raise RuntimeError(f"j2: defense {aliases} gave a non-finite aggregate")
    _reset_trust()
    return dict(j1=j1, j2=dict(round_s=round_s, krum_kept=chosen[0],
                               test_loss=rep["test_loss"], defenses=defenses))


def trust_cross_silo_phase(card: str):
    """Phase (j3): norm-difference clipping and local DP on the fused path
    of an in-process cross-silo federation, with its checks (see the module
    doc)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.compression import CompressedTree, get_codec, requires_full_trees
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.aggregator import agg_operator
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.telemetry import get_registry

    _reset_trust()
    args = fedml_tpu_torch.init(load_arguments_from_dict(TRUST_CS_CONFIG))
    ds = load_federated(args)
    model = create(args, ds.class_num)
    LocalBroker.destroy(args.run_id)
    reg = get_registry()
    before = _integrity_counts(reg)
    fused_calls = []
    orig_agg = agg_operator.FedMLAggOperator.agg_compressed

    def capture(args_, raw_list, global_params, **kw):
        fused_calls.append(dict(n=len(raw_list), clip=kw.get("clip_factors"),
                                robust=kw.get("agg_robust"),
                                int8=all(isinstance(ct, CompressedTree) and ct.codec == "int8"
                                         and ct.is_delta for _, ct in raw_list)))
        return orig_agg(args_, raw_list, global_params, **kw)

    full = requires_full_trees(get_codec(args.compression), args)
    server, clients = build_cross_silo_inproc(args, ds, model, "cuda")
    agg_operator.FedMLAggOperator.agg_compressed = staticmethod(capture)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = run_managers_to_completion([server.manager] + [c.manager for c in clients],
                                            args.run_id, MyMessage.MSG_TYPE_CONNECTION_IS_READY,
                                            timeout=900)
    finally:
        agg_operator.FedMLAggOperator.agg_compressed = staticmethod(orig_agg)
    wall = time.perf_counter() - t0
    counts = {k: v - before.get(k, 0) for k, v in _integrity_counts(reg).items()
              if isinstance(v, (int, float))}
    dp = FedMLDifferentialPrivacy.get_instance()
    eps = {rank: dp.epsilon_spent(stream=rank) for rank in range(1, len(clients) + 1)}
    final = server.fedml_aggregator.get_global_model_params()
    print(f"  {card}: j3 {len(clients)} silos, 1 round in {wall:.3f} s; result {result}; "
          f"requires_full_trees {full}; fused calls {fused_calls}", flush=True)
    print(f"  {card}: j3 LDP ε per silo after its release: "
          + ", ".join(f"rank {r} {e:.4f}" for r, e in eps.items())
          + f" (δ {args.delta}, σ {dp.frame.mechanism.sigma:.4g}); counters "
          f"{json.dumps(counts, sort_keys=True)}", flush=True)
    if full or not (fused_calls and fused_calls[0]["clip"] is not None
                    and fused_calls[0]["int8"] and not fused_calls[0]["robust"]):
        raise RuntimeError(f"j3: the fused path with clip factors did not serve: "
                           f"{full}, {fused_calls}")
    if not counts.get("health/norm_clips_fused", 0) > 0:
        raise RuntimeError(f"j3: no update was clipped on the fused path: {counts}")
    if not (result and result.get("rounds") == 1 and all(e > 0 for e in eps.values())
            and all(v.is_cuda and bool(torch.isfinite(v).all()) for v in final.values())):
        raise RuntimeError(f"j3: the federation did not end in a finite round: {result}, "
                           f"{eps}")
    _reset_trust()
    return dict(wall_s=wall, result=result, fused_calls=fused_calls, counters=counts,
                epsilon=eps)


def _leaves_equal(a, b) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def secagg_inproc(card: str):
    """Phase (k1): a ``secagg: int8`` federation of 4 silos over LOCAL on
    the card, round 1 closing through the seed-reveal recovery, with its
    checks and timings (see the module doc)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.compression import (
        CompressedTree,
        derive_key,
        fused_weighted_sum,
        get_codec,
    )
    from fedml_tpu_torch.compression.codecs import _tree_meta
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.privacy import secagg
    from fedml_tpu_torch.privacy.secagg import keys
    from fedml_tpu_torch.telemetry import get_registry
    from fedml_tpu_torch.utils.serialization import safe_dumps
    from fedml_tpu_torch.utils.tree import tree_flatten

    _reset_trust()
    args = fedml_tpu_torch.init(load_arguments_from_dict(SECAGG_CONFIG))
    ds = load_federated(args)
    model = create(args, ds.class_num)
    LocalBroker.destroy(args.run_id)
    torch.cuda.reset_peak_memory_stats()
    server, clients = build_cross_silo_inproc(args, ds, model, "cuda")
    agg, smgr = server.fedml_aggregator, server.manager
    session = smgr._secagg
    n_params = sum(v.numel() for v in agg.get_global_model_params().values())
    untrained = agg.test_on_server_for_all_clients(-1)
    reg = get_registry()
    names = ("secagg/rounds", "secagg/masked_uploads", "secagg/recoveries",
             "secagg/seeds_revealed", "secagg/invalid_uploads", "resilience/quorum_rounds")
    before = {n: reg.counter(n).value for n in names}

    # what the run records: each upload as the server holds it, each client's
    # encode inputs, each unmask's inputs and output, each round's end
    uploads, encodes, unmasks, rounds = [], {}, [], []
    add, test = agg.add_local_trained_result, agg.test_on_server_for_all_clients
    unmask = session.aggregate

    def recorded_add(index, params, n, local_steps=None):
        uploads.append((int(smgr.args.round_idx), params))
        return add(index, params, n, local_steps)

    def recorded_test(r):
        m = test(r)
        torch.cuda.synchronize()
        rounds.append(dict(round=r, end=time.perf_counter(), test_loss=float(m["test_loss"]),
                           test_acc=float(m["test_acc"])))
        return m

    def recorded_unmask(cts, base):
        out = unmask(cts, base)
        unmasks.append(dict(round=int(session.round_idx), cts=list(cts), base=base, out=out,
                            evicted=list(session.evicted)))
        return out

    agg.add_local_trained_result, agg.test_on_server_for_all_clients = recorded_add, recorded_test
    session.aggregate = recorded_unmask
    for c in clients:
        mgr = c.manager
        sess = mgr._secagg

        def recorded_encode(delta, key, mgr=mgr, sess=sess, enc=sess.encode_update):
            encodes[(mgr.round_idx, mgr.rank)] = dict(
                delta=delta, key=key, residual=sess._residual, peers=dict(sess._peer_seeds))
            return enc(delta, key)

        sess.encode_update = recorded_encode
        if mgr.rank == SECAGG_STALL_RANK:
            trainer = mgr.trainer_dist_adapter.trainer
            train = trainer.run_local_training

            def stalled(params, *a, mgr=mgr, train=train, **kw):
                if mgr.round_idx != 1:
                    return train(params, *a, **kw)
                end = time.monotonic() + 900
                while smgr.result is None and smgr.handler_error is None:
                    if time.monotonic() > end:
                        raise TimeoutError("k1: round 1 never closed at quorum")
                    time.sleep(0.05)
                return {k: v.clone() for k, v in params.items()}, {}

            trainer.run_local_training = stalled
    t_start = time.perf_counter()
    result = run_managers_to_completion([smgr] + [c.manager for c in clients], args.run_id,
                                        MyMessage.MSG_TYPE_CONNECTION_IS_READY, timeout=900)
    wall = time.perf_counter() - t_start
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {n: reg.counter(n).value - before[n] for n in names}
    for i, r in enumerate(rounds):
        r["round_s"] = r["end"] - (rounds[i - 1]["end"] if i else t_start)

    # the checks: masked uploads only, and a masked tree never decodes
    bad = [(r, type(u).__name__) for r, u in uploads
           if not (isinstance(u, CompressedTree) and u.codec == "secagg_int8"
                   and u.version == 2 and u.sa and u.sa.get("rank") is not None)]
    if bad or len(uploads) != 7:
        raise RuntimeError(f"k1: the server held {len(uploads)} uploads (want 4 + 3), "
                           f"not all masked: {bad}")
    try:
        get_codec(uploads[0][1].codec).decode(uploads[0][1])
        raise RuntimeError("k1: a masked upload decoded")
    except ValueError:
        pass
    if not (result and result.get("rounds") == 2 and len(unmasks) == 2):
        raise RuntimeError(f"k1: the federation did not run 2 unmasked rounds: {result}")
    # each round's aggregate against the never-masked sum of the same words:
    # the same deltas, keys and residuals encoded on the card with zero masks
    zero_ref = []
    codec = session.codec  # both rounds' roster is the 4 silos
    for u in unmasks:
        ranks = [int(ct.sa["rank"]) for ct in u["cts"]]
        plain = []
        for rank in ranks:
            e = encodes[(u["round"], rank)]
            meta = _tree_meta(tree_flatten(e["delta"])[0])
            zeros = [np.zeros(sh, np.uint8) for _, sh in meta]
            plain.append(secagg.masked_encode(e["delta"], zeros, codec, e["key"],
                                              residual=e["residual"],
                                              sa={"rank": rank})[0])
        want = secagg.unmask_finalize(plain, u["base"], codec)
        zero_ref.append(_leaves_equal(u["out"], want))
    if not all(zero_ref):
        raise RuntimeError(f"k1: an aggregate is not bit-identical to the never-masked sum: "
                           f"{zero_ref}")
    if not (unmasks[0]["evicted"] == [] and unmasks[1]["evicted"] == [SECAGG_STALL_RANK]
            and counts["secagg/recoveries"] == 1 and counts["secagg/seeds_revealed"] == 3
            and counts["resilience/quorum_rounds"] == 1 and counts["secagg/rounds"] == 2):
        raise RuntimeError(f"k1: round 1 did not close through one recovery of 3 seeds: "
                           f"{counts}, evicted {[u['evicted'] for u in unmasks]}")
    losses = [r["test_loss"] for r in rounds]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < untrained["test_loss"]):
        raise RuntimeError(f"k1: the test loss {losses} is not finite and below the "
                           f"untrained model's {untrained['test_loss']}")
    final = agg.get_global_model_params()
    if not all(v.is_cuda and bool(torch.isfinite(v).all()) for v in final.values()):
        raise RuntimeError("k1: the global model left the card or is not finite")

    # timings on the card, the last round's inputs replayed (CUDA events)
    e = encodes[(1, 1)]
    meta = _tree_meta(tree_flatten(e["delta"])[0])
    t0 = time.perf_counter()
    mask = secagg.net_mask_leaves(1, e["peers"], meta, codec.mod_bits)
    mask_ms_once = (time.perf_counter() - t0) * 1e3
    mask_ms = _host_ms(lambda: secagg.net_mask_leaves(1, e["peers"], meta, codec.mod_bits),
                       reps=2)
    sk, pk = keys.kx_keygen()
    _, peer_pk = keys.kx_keygen()
    kx_ms = _host_ms(lambda: keys.kx_agree(sk, peer_pk), reps=20)
    ladder_ms = _host_ms(lambda: keys.kx_agree(sk, peer_pk, ladder=True), reps=20)
    masked_ms = _events_ms(lambda: secagg.masked_encode(e["delta"], mask, codec, e["key"],
                                                        residual=e["residual"]))
    int8 = get_codec("int8")
    int8_ms = _events_ms(lambda: int8.encode(e["delta"], key=e["key"], is_delta=True,
                                             residual=e["residual"]))
    cts0, base0 = unmasks[0]["cts"], unmasks[0]["base"]
    unmask_ms = _events_ms(lambda: secagg.unmask_finalize(cts0, base0, codec))
    plain_cts = [int8.encode(encodes[(0, int(ct.sa["rank"]))]["delta"],
                             key=derive_key(0, 0, int(ct.sa["rank"])), is_delta=True)
                 for ct in cts0]
    fused_ms = _events_ms(lambda: fused_weighted_sum(plain_cts, [0.25] * len(plain_cts)))
    masked_ct = cts0[0]
    wire = dict(masked=len(safe_dumps(masked_ct)), int8=len(safe_dumps(plain_cts[0])),
                f32=len(safe_dumps({k: v.float() for k, v in e["delta"].items()})))
    for r in rounds:
        print(f"  {card}: k1 round {r['round']}: {r['round_s']:.3f} s, test loss "
              f"{r['test_loss']:.5f}, test acc {r['test_acc']:.4f}", flush=True)
    print(f"  {card}: k1 untrained test loss {untrained['test_loss']:.5f}; whole run "
          f"{wall:.3f} s; peak {peak_gb:.3f} GB; counters {json.dumps(counts)}; both "
          f"aggregates bit-identical to the never-masked sum", flush=True)
    print(f"  {card}: k1 masked encode {masked_ms:.2f} ms an upload vs plain int8 "
          f"{int8_ms:.2f} ms (CUDA events, mean of {CS_TIMED_REPS}); unmask_finalize of 4 "
          f"{unmask_ms:.2f} ms vs fused_weighted_sum of 4 int8 {fused_ms:.2f} ms; host: "
          f"Philox net mask (3 peers, {n_params} words) {mask_ms:.1f} ms (first "
          f"{mask_ms_once:.1f}), one X25519 agreement {kx_ms:.3f} ms "
          f"({'cryptography' if keys._have_cryptography() else 'RFC 7748 ladder'}; the "
          f"ladder {ladder_ms:.3f} ms); wire "
          f"bytes masked {wire['masked']} / int8 {wire['int8']} / f32 {wire['f32']}",
          flush=True)
    _reset_trust()
    return dict(rounds=[{k: v for k, v in r.items() if k != "end"} for r in rounds],
                untrained_test_loss=untrained["test_loss"], wall_s=wall, peak_gb=peak_gb,
                counters=counts, masked_encode_ms=masked_ms, int8_encode_ms=int8_ms,
                unmask_ms=unmask_ms, fused_weighted_sum_ms=fused_ms, mask_host_ms=mask_ms,
                mask_host_first_ms=mask_ms_once, kx_agree_ms=kx_ms,
                kx_ladder_ms=ladder_ms,
                kx_path="cryptography" if keys._have_cryptography() else "ladder",
                wire_bytes=wire, n_params=n_params)


def secagg_broker(card: str):
    """Phase (k2): ``secagg: int8`` with a server and SECAGG_BROKER_SILOS
    silos as processes over the broker, 1 round."""
    kids, wall, published = _broker_federation(
        "chip_smoke_secagg_broker", SECAGG_BROKER_SILOS,
        **{**SECAGG_TRAIN, "client_num_in_total": SECAGG_BROKER_PARTS})
    server = kids[0]
    masked = sum(k["metrics"].get("secagg/masked_uploads", 0) for k in kids[1:])
    if server["result"].get("rounds") != 1 or masked != SECAGG_BROKER_SILOS:
        raise RuntimeError(f"k2: the masked broker federation did not run 1 round of "
                           f"masked uploads: {server['result']}, {masked} masked")
    print(f"  {card}: k2 {SECAGG_BROKER_SILOS + 1} processes exited 0 in {wall:.3f} s; "
          f"{masked:.0f} masked uploads; server result {server['result']}; bytes on the "
          f"broker {published:.0f}; process walls "
          + ", ".join(f"{k['role']} {k['wall_s']:.1f} s" for k in kids), flush=True)
    return dict(wall_s=wall, result=server["result"], masked_uploads=masked,
                broker_bytes_published=published,
                process_walls_s=[k["wall_s"] for k in kids])


def finite_field_phase(card: str, which: str):
    """Phase (k3, Bonawitz) or (k4, LightSecAgg): one round of 3 silos over
    LOCAL on the card; fails unless the server's unmasked field sum equals
    the survivors' plain field sum and the new global model is that sum,
    dequantized and averaged."""
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.core.mpc import finite
    from fedml_tpu_torch.core.mpc.secagg import SecAggClient
    from fedml_tpu_torch.cross_silo.lightsecagg import lsa_client_manager
    from fedml_tpu_torch.cross_silo.lightsecagg.run_inproc import build_lightsecagg_inproc
    from fedml_tpu_torch.cross_silo.run_inproc import run_managers_to_completion
    from fedml_tpu_torch.cross_silo.secagg.run_inproc import build_secagg_inproc
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create

    bonawitz = which == "k3"
    args = load_arguments_from_dict(BONAWITZ_CONFIG if bonawitz else LSA_CONFIG)
    ds = load_federated(args)
    model = create(args, ds.class_num)
    LocalBroker.destroy(args.run_id)
    build = build_secagg_inproc if bonawitz else build_lightsecagg_inproc
    server, clients = build(args, ds, model, "cuda")
    # each survivor's field vector as it is masked (the Bonawitz clients
    # pre-scale it by their sample count)
    inputs, sums = [], []
    orig_mask, orig_masking = SecAggClient.mask, lsa_client_manager.model_masking

    def recorded_mask(self, x):
        inputs.append((self.id, np.array(x)))
        return orig_mask(self, x)

    def recorded_masking(x, z, p):
        inputs.append((None, np.array(x)))
        return orig_masking(x, z, p)

    unmask_sum = server.unmask_sum

    def recorded_sum(*a):
        t0 = time.perf_counter()
        out = unmask_sum(*a)
        sums.append((out, (time.perf_counter() - t0) * 1e3))
        return out

    server.unmask_sum = recorded_sum
    SecAggClient.mask = recorded_mask
    lsa_client_manager.model_masking = recorded_masking
    t0 = time.perf_counter()
    try:
        result = run_managers_to_completion([server] + clients, args.run_id,
                                            "MSG_TYPE_CONNECTION_IS_READY", timeout=900)
    finally:
        SecAggClient.mask = orig_mask
        lsa_client_manager.model_masking = orig_masking
    wall = time.perf_counter() - t0
    p, q_bits = server.p, server.q_bits
    survivors = sorted(rank for rank, _ in inputs) if bonawitz else [None] * len(inputs)
    want = np.zeros_like(inputs[0][1])
    for _, x in inputs:
        want = np.mod(want + x, p)
    got, sum_ms = sums[0] if sums else (None, None)
    if got is None or not np.array_equal(got, want):
        raise RuntimeError(f"{which}: the unmasked field sum is not the survivors' plain sum")
    if bonawitz and survivors != [1, 2]:
        raise RuntimeError(f"{which}: rank 3 did not drop out: survivors {survivors}")
    final = server.aggregator.get_global_model_params()
    summed = finite.finite_to_tree(want, final, q_bits, p)
    # Bonawitz: the count-weighted mean (silo r trains part r - 1); LightSecAgg:
    # the plain mean
    n_div = (sum(ds.train_data_local_num_dict[r - 1] for r in survivors) if bonawitz
             else len(survivors))
    expected = {k: (v / torch.tensor(float(n_div))).cuda() for k, v in summed.items()}
    if not (result and result.get("rounds") == 1 and _leaves_equal(final, expected)):
        raise RuntimeError(f"{which}: the global model is not the dequantized field sum: "
                           f"{result}")
    print(f"  {card}: {which} {'Bonawitz' if bonawitz else 'LightSecAgg'} 1 round of "
          f"{len(clients)} silos ({len(survivors)} survivors) in {wall:.3f} s; the server's "
          f"finite-field unmask {sum_ms:.1f} ms host; the model is the survivors' field sum "
          f"dequantized (q_bits {q_bits}); test loss {result['test_loss']:.5f}", flush=True)
    return dict(wall_s=wall, survivors=survivors, field_unmask_host_ms=sum_ms,
                test_loss=float(result["test_loss"]), q_bits=q_bits)


def fedllm_host_phase(card: str, on_device=None):
    """Phase (l1): Llama-3-8B federated LoRA rounds through FedLLMAPI's host
    loop with the hooks live and a checkpoint each round; the flash launch
    counts read around exactly ``train()``; the last checkpoint loaded into
    a freshly built engine. Returns the report and the last checkpoint's
    directory (left for l2; the caller removes ``work``)."""
    import tempfile
    import types

    import fedml_tpu_torch
    from fedml_tpu_torch.core.checkpoint import read_round_dir
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI
    from fedml_tpu_torch.train.llm.trainer import LLMTrainer, extract_lora

    work = tempfile.mkdtemp(prefix="chip_smoke_llm_ckpt_")
    args = types.SimpleNamespace(**FEDLLM_HOST_ARGS, checkpoint_dir=work)
    _reset_trust()
    fedml_tpu_torch.init(args)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = FedLLMAPI(args, "cuda", load_synthetic_lm(args))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    engine, cfg, client, agg = api.client.engine, api.cfg, api.client, api.aggregator

    # the host share of a round: each piece timed between synchronisations
    spans = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    engine.step = timed("steps", engine.step)
    engine.load_exchange_state = timed("exchange", engine.load_exchange_state)
    engine.exchange_state = timed("exchange", engine.exchange_state)
    client.run_local_training = timed("client", client.run_local_training)
    client.train = timed("train", client.train)
    for hook in ("on_before_aggregation", "aggregate", "on_after_aggregation"):
        setattr(agg, hook, timed("aggregation", getattr(agg, hook)))
    rounds = []
    inner = api.train_one_round

    def recorded(r):
        spans.clear()
        rep = inner(r)
        # the round's own pieces (the test and checkpoint come after it)
        rep.update({f"{k}_s": v for k, v in spans.items()})
        rounds.append(rep)
        return rep

    api.train_one_round = recorded
    # --- the main path, with the launch counts read around exactly it ---
    fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
    t0 = time.perf_counter()
    api.train()
    train_wall_s = time.perf_counter() - t0
    launches = {"flash_fwd": fa.FLASH_FWD_LAUNCHES, "flash_bwd_dq": fa.FLASH_DQ_LAUNCHES,
                "flash_bwd_dkv": fa.FLASH_DKV_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers, clients = cfg.num_hidden_layers, args.client_num_per_round
    per_client = args.train_size // args.client_num_in_total  # steps at batch 1
    steps = clients * per_client * args.comm_round
    evals = len(api.test_history)
    expected = {"flash_fwd": layers * (steps + evals), "flash_bwd_dq": layers * steps,
                "flash_bwd_dkv": layers * steps}
    tokens_per_round = clients * per_client * args.per_device_batch_size * args.max_seq_length
    for rep in rounds:
        host = rep["round_sec"] - rep.get("steps_s", 0.0)
        print(f"  round {rep['round']}: {rep['round_sec']:.3f} s ({tokens_per_round / rep['round_sec']:.1f} "
              f"tokens/s), test loss {rep['test_loss']:.5f}; local steps {rep.get('steps_s', 0):.3f} s, "
              f"exchange {rep.get('exchange_s', 0) * 1e3:.1f} ms, client hooks "
              f"{(rep.get('client_s', 0) - rep.get('train_s', 0)) * 1e3:.1f} ms, "
              f"aggregation hooks {rep.get('aggregation_s', 0) * 1e3:.1f} ms; off the steps "
              f"{host:.3f} s = {host / rep['round_sec']:.4f} of the round; checkpoint "
              f"{rep['checkpoint_ms']:.1f} ms, {rep['checkpoint_bytes']} B", flush=True)
    steady = rounds[-1]["round_sec"]
    beside = ("" if on_device is None else
              f" (phase e's on-device round: {on_device['steady_round_s']:.3f} s = "
              f"{on_device['tokens_per_s']:.1f} tokens/s)")
    print(f"  train(): {args.comm_round} host-loop rounds in {train_wall_s:.2f} s; steady "
          f"round {steady:.3f} s = {tokens_per_round / steady:.1f} tokens/s{beside}; "
          f"booted in {boot_s:.1f} s; peak memory {peak_gb:.3f} GB; launches {launches} "
          f"(expected {expected})", flush=True)
    if launches != expected or min(launches.values()) == 0:
        raise RuntimeError(f"flash launches {launches} != expected {expected}")
    if not all(math.isfinite(r["test_loss"]) for r in rounds):
        raise RuntimeError(f"non-finite test losses: {rounds}")
    paths = [r["checkpoint"] for r in rounds]
    if not all(os.path.isfile(os.path.join(p, "state.pt")) for p in paths):
        raise RuntimeError(f"a round's checkpoint is missing: {paths}")
    last, live_loss = rounds[-1]["checkpoint"], rounds[-1]["test_loss"]
    saved = read_round_dir(last)
    live_global = {k: v.detach().cpu() for k, v in api.global_exchange.items()}
    saved_is_global = all(torch.equal(saved[k], live_global[k]) for k in live_global)
    test_x, test_y = api.dataset.test_data_global
    n_test = min(len(test_x), engine.batch_size * 8)
    del api, engine, client, agg
    gc.collect()
    torch.cuda.empty_cache()

    # --- the last checkpoint into a freshly built engine ---
    fresh = LLMTrainer(cfg, args, device="cuda")
    fresh.init(seed=int(args.random_seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.load_checkpoint(last)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    loaded = {k: v.detach().cpu() for k, v in extract_lora(fresh.model).items()}
    same_adapters = set(loaded) == set(saved) and all(
        torch.equal(loaded[k], saved[k]) for k in saved)
    again = fresh.evaluate(np.asarray(test_x[:n_test]), np.asarray(test_y[:n_test]))
    print(f"  last checkpoint {last}: {os.path.getsize(os.path.join(last, 'state.pt'))} B, "
          f"the global adapters bit for bit: {saved_is_global}; loaded into a fresh engine "
          f"in {load_ms:.1f} ms, adapters bit-identical {same_adapters}, test loss "
          f"{again['eval_loss']!r} vs the live test's {live_loss!r}", flush=True)
    if not (saved_is_global and same_adapters and again["eval_loss"] == live_loss):
        raise RuntimeError("the checkpoint did not give back the round's adapters or "
                           "its test loss bit for bit")
    _reset_trust()
    return dict(launches=launches, expected_launches=expected, rounds=[
        {k: v for k, v in r.items() if isinstance(v, (int, float, str))} for r in rounds],
        boot_s=boot_s, train_wall_s=train_wall_s, tokens_per_round=tokens_per_round,
        steady_round_s=steady, tokens_per_s=tokens_per_round / steady, peak_gb=peak_gb,
        load_ms=load_ms, checkpoint=last, work=work)


def serve_checkpoint_phase(ckpt: str):
    """Phase (l2): ``serve --checkpoint`` of l1's last round with LoRA rank
    16 over an int8 base, 2 HTTP requests, the dequant launches counted
    around exactly them; the served logits against the plain int8 lowering
    of the same weights and adapters, and against the same endpoint with the
    adapters it would hold without ``--checkpoint`` (lora_b at zero)."""
    from fedml_tpu_torch.cli import build_endpoint, build_parser
    from fedml_tpu_torch.ops import quant

    args = build_parser().parse_args(
        ["serve", "--model", FEDLLM_HOST_ARGS["model_size"], "--quantize", "int8",
         "--batch-slots", "2", "--max-len", "256", "--host", "127.0.0.1", "--port", "0",
         "--lora-rank", str(FEDLLM_HOST_ARGS["lora_rank"]), "--checkpoint", ckpt,
         "--device", "cuda"])
    t0 = time.perf_counter()
    engine, runner = build_endpoint(args)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    model = engine.params
    cfg = model.cfg
    lora = {n: p for n, p in model.named_parameters() if "lora" in n}
    lora_f32 = all(p.dtype == torch.float32 for p in lora.values())
    print(f"  booted {args.model_size} int8 with {ckpt} in {boot_s:.1f} s: {len(lora)} LoRA "
          f"leaves (f32: {lora_f32}) beside {len(list(quant.named_quantized_weights(model)))} "
          f"int8 weights", flush=True)
    rng = np.random.default_rng(10)
    runner.start()
    try:
        prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (24, 40)]
        engine.oplog.clear()
        quant.DEQUANT_MATMUL_LAUNCHES = 0
        t0 = time.perf_counter()
        replies = [post(runner.port, {"prompt_tokens": p,
                                      "max_new_tokens": SERVE_CKPT_NEW_TOKENS})
                   for p in prompts[:SERVE_CKPT_REQUESTS]]
        wall_s = time.perf_counter() - t0
        launches = quant.DEQUANT_MATMUL_LAUNCHES
        ops = list(engine.oplog)
    finally:
        runner.stop()
        engine.stop()
    if engine.failure is not None:
        raise RuntimeError("serving engine failed") from engine.failure
    for r in replies:
        toks = r.get("tokens")
        if not isinstance(toks, list) or len(toks) != SERVE_CKPT_NEW_TOKENS:
            raise RuntimeError(f"bad response: {r}")
    n_decode = sum(1 for op in ops if op[0] in ("decode", "decode_part"))
    n_prefill = sum(1 for op in ops if op[0] == "prefill" and op[1] <= 128)
    expected = LAUNCHES_PER_PASS * (n_decode + n_prefill)

    # phase c's check on the same prompt length: one full-width block within
    # 2e-2 of its largest output, the logits within a 2e-2 relative L2
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 48))).cuda()
    qts = [v for mod in model.modules() for v in vars(mod).values()
           if isinstance(v, quant.QuantizedTensor)]
    blocks = []

    def logits():
        from fedml_tpu_torch.models.llm.llama import rope_tables

        with torch.inference_mode():
            x = torch.nn.functional.embedding(tokens, model.embed_tokens).to(cfg.dtype)
            cos, sin = rope_tables(torch.arange(48, device="cuda"), cfg.head_dim,
                                   cfg.rope_theta)
            blocks.append(model.layer_0(x, cos, sin, model.init_kv_caches(1, 64)[0])[0]
                          .float())
            return model(tokens, kv_caches=model.init_kv_caches(1, 64))[0].float()

    kernel = quant.dequant_matmul_cuda
    try:
        got = logits()
        quant.dequant_matmul_cuda = (
            lambda x, q, s: quant.dequant_matmul_reference(x, q, s, torch.bfloat16))
        plain = logits()
    finally:
        quant.dequant_matmul_cuda = kernel
    lora_b = {n: p.detach().clone() for n, p in lora.items() if n.endswith("lora_b")}
    with torch.no_grad():
        for n, p in lora.items():
            if n.endswith("lora_b"):
                p.zero_()
        base = logits()
        for n, p in lora.items():
            if n.endswith("lora_b"):
                p.copy_(lora_b[n])

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    vs_plain, vs_base = rel_l2(got, plain), rel_l2(got, base)
    block_err = ((blocks[0] - blocks[1]).abs().max() / blocks[1].abs().max()).item()
    finite = bool(torch.isfinite(got).all()) and got.shape[-1] == cfg.vocab_size
    print(f"  {SERVE_CKPT_REQUESTS} requests in {wall_s:.2f} s: {n_prefill} prefills, "
          f"{n_decode} decode steps; dequant launches {launches} (expected {expected} = "
          f"{LAUNCHES_PER_PASS} a pass); layer_0 with its adapters, kernel vs plain "
          f"{block_err:.4g} of its max output; logits finite {finite}, relative L2 to the "
          f"plain int8 lowering {vs_plain:.4g} (limit 2e-2), to the endpoint without the "
          f"checkpoint {vs_base:.4g}; {len(qts)} int8 weights", flush=True)
    if not (finite and lora_f32 and block_err <= 2e-2 and vs_plain <= 2e-2
            and not torch.equal(got, base)):
        raise RuntimeError(f"served checkpoint logits: finite {finite}, f32 adapters "
                           f"{lora_f32}, block {block_err}, vs plain {vs_plain}, vs base "
                           f"{vs_base}")
    if launches != expected or launches == 0:
        raise RuntimeError(f"the served checkpoint launched the kernel {launches} times, "
                           f"expected {expected}")
    return dict(launches=launches, expected_launches=expected, decode_steps=n_decode,
                prefills=n_prefill, boot_s=boot_s, http_wall_s=wall_s,
                layer0_vs_plain=block_err, logits_l2_vs_plain=vs_plain,
                logits_l2_vs_no_checkpoint=vs_base)


def _packed_equal(a: dict, b: dict) -> bool:
    from fedml_tpu_torch.core.checkpoint import flatten_state

    fa_, fb = flatten_state(a), flatten_state(b)
    return set(fa_) == set(fb) and all(torch.equal(fa_[k].cpu(), fb[k].cpu()) for k in fa_)


def contribution_data():
    """l3's data: the stand-in cut to CONTRIB_CONFIG's 50 IID clients, the
    test set to CONTRIB_TEST_IMAGES, and the labels of one client flipped,
    every class to class 0 (the attack class at ratio 1; the singleton would
    flip every client's). The flipped client is the one sampled in the most
    of the 3 rounds, the latest on a tie. A bijective flip (each class to
    the next) is no fit: that client's features still help, and on one
    call it was valued above two honest clients."""
    import types

    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.security.attack.label_flipping import LabelFlippingAttack
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.simulation.sampling import sample_clients

    args = load_arguments_from_dict(CONTRIB_CONFIG)
    ds = load_federated(args)
    x, y = ds.test_data_global
    ds.test_data_global = (x[:CONTRIB_TEST_IMAGES], y[:CONTRIB_TEST_IMAGES])
    ds.test_data_num = CONTRIB_TEST_IMAGES
    seen = {}
    for r in range(int(args.comm_round)):
        for c in sample_clients(args, r):
            seen[c] = (seen.get(c, (0, 0))[0] + 1, r)
    flipped = max(seen, key=seen.get)
    ds.train_data_local_dict[flipped] = LabelFlippingAttack(types.SimpleNamespace(
        random_seed=0, poisoned_ratio=1.0, original_class_list=list(range(ds.class_num)),
        target_class_list=[0] * ds.class_num)).poison_data(ds.train_data_local_dict[flipped])
    return ds, flipped


def sp_resume_phase(card: str, ds, flipped: int):
    """Phase (l3): sp resume and contribution on ResNet-18 (see the module
    doc); cuDNN held to its deterministic algorithms for the phase."""
    import copy
    import shutil
    import tempfile

    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core import checkpoint as ck
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    work = tempfile.mkdtemp(prefix="chip_smoke_sp_ckpt_")
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    restores = []
    restore_latest = ck.RoundCheckpointer.restore_latest

    def timed_restore(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore_latest(self, *a, **kw)
        torch.cuda.synchronize()
        restores.append((time.perf_counter() - t0) * 1e3)
        return out

    def api_for(rounds, **train):
        cfg = copy.deepcopy(CONTRIB_CONFIG)
        cfg["train_args"].update(comm_round=rounds, **train)
        args = load_arguments_from_dict(cfg)
        _reset_trust()
        return FedAvgAPI(args, "cuda", ds, create(args, ds.class_num))

    def run(api, tag):
        reps = []
        inner = api.train_one_round

        def recorded(r):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = inner(r)
            torch.cuda.synchronize()
            rep["round_sec"] = time.perf_counter() - t0
            reps.append(rep)
            calls = rep["contribution_utility_calls"]
            print(f"  {tag} round {r}: {rep['round_sec']:.3f} s, test loss "
                  f"{rep['test_loss']:.5f}, acc {rep['test_acc']:.4f}; {calls} utility "
                  f"evaluations, {rep['contribution_ms'] / calls:.1f} ms each; values "
                  + ", ".join(f"{c}: {v:+.4f}" for c, v in rep["contributions"].items())
                  + (f"; checkpoint {rep['checkpoint_ms']:.1f} ms, "
                     f"{rep['checkpoint_bytes']} B" if "checkpoint_ms" in rep else ""),
                  flush=True)
            return rep

        api.train_one_round = recorded
        api.train()
        return reps

    ck.RoundCheckpointer.restore_latest = timed_restore
    try:
        # one warm global model for both runs (see CONTRIB_WARMUP)
        warm = api_for(CONTRIB_WARMUP, client_num_per_round=10,
                       enable_contribution=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm.train()
        torch.cuda.synchronize()
        print(f"  warm-up: {CONTRIB_WARMUP} rounds of 10 clients in "
              f"{time.perf_counter() - t0:.1f} s, test loss "
              f"{warm.test_history[-1]['test_loss']:.5f}, acc "
              f"{warm.test_history[-1]['test_acc']:.4f}", flush=True)
        init = {k: v.clone() for k, v in warm.global_params.items()}
        del warm
        straight = api_for(3)
        straight.global_params = {k: v.clone() for k, v in init.items()}
        s_reps = run(straight, "uninterrupted")
        values = dict(straight._contrib.accumulated)
        first = api_for(1, checkpoint_dir=work)
        first.global_params = {k: v.clone() for k, v in init.items()}  # the same start
        run(first, "killed after")
        saved_state = first._ckpt_state()
        resumed = api_for(3, checkpoint_dir=work, resume=True)
        restored_equal = (_packed_equal(resumed._ckpt_state(), saved_state)
                          and resumed._start_round == 1)
        r_reps = run(resumed, "resumed")
    finally:
        ck.RoundCheckpointer.restore_latest = restore_latest
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        shutil.rmtree(work, ignore_errors=True)
        _reset_trust()
    a, b = straight.global_params, resumed.global_params
    bitwise = all(torch.equal(a[k], b[k]) for k in a)
    worst = max(float((a[k] - b[k]).abs().max()) / max(1.0, float(a[k].abs().max()))
                for k in a)
    lowest = min(values, key=values.get)
    print(f"  restored state (params, server momentum, DP counter, next round 1) "
          f"bit-identical to the saved: {restored_equal}; restore {restores[-1]:.1f} ms; "
          f"resumed final parameters vs uninterrupted: bit for bit {bitwise} (cuDNN "
          f"deterministic), worst leaf {worst:.3g} of its magnitude; accumulated values "
          + ", ".join(f"{c}: {v:+.4f}" for c, v in sorted(values.items()))
          + f"; the flipped client {flipped} lowest: {lowest == flipped}", flush=True)
    if not restored_equal:
        raise RuntimeError("the restored round state differs from the saved one")
    if not (bitwise or worst <= RESUME_BOUND):
        raise RuntimeError(f"the resumed run ends {worst} from the uninterrupted one")
    if lowest != flipped or len(r_reps) != 2 or len(s_reps) != 3:
        raise RuntimeError(f"contribution values {values}: client {flipped} not lowest")
    return dict(rounds=[{k: v for k, v in r.items() if isinstance(v, (int, float))}
                        for r in s_reps + r_reps],
                values={str(k): v for k, v in values.items()}, flipped=flipped,
                restore_ms=restores[-1], restored_equal=restored_equal,
                bit_for_bit=bitwise, worst_leaf=worst)


def cross_silo_resume_phase(card: str, ds):
    """Phase (l4): 4 silos over LOCAL, 1 round with a checkpoint and
    leave-one-out valuation; a fresh server resumes at round 1 from the
    saved parameters and runs it."""
    import copy
    import shutil
    import tempfile

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.models.model_hub import create

    work = tempfile.mkdtemp(prefix="chip_smoke_cs_ckpt_")

    def federation(rounds, run_id, resume):
        cfg = copy.deepcopy(CS_RESUME_CONFIG)
        cfg["common_args"]["run_id"] = run_id
        cfg["train_args"].update(comm_round=rounds, checkpoint_dir=work, resume=resume)
        args = load_arguments_from_dict(cfg)
        _reset_trust()
        fedml_tpu_torch.init(args)
        server, clients = build_cross_silo_inproc(args, ds, create(args, ds.class_num),
                                                  "cuda")
        start = (int(args.round_idx), server.manager.resumed_from,
                 {k: v.clone() for k, v in server.fedml_aggregator.global_params.items()})
        losses = []
        test = server.fedml_aggregator.test_on_server_for_all_clients

        def recorded(r):
            m = test(r)
            losses.append(float(m["test_loss"]))
            return m

        server.fedml_aggregator.test_on_server_for_all_clients = recorded
        t0 = time.perf_counter()
        result = run_managers_to_completion([server.manager] + [c.manager for c in clients],
                                            args.run_id,
                                            MyMessage.MSG_TYPE_CONNECTION_IS_READY, 600)
        return dict(start=start, result=result, losses=losses,
                    values=dict(server.fedml_aggregator.last_contributions),
                    wall_s=time.perf_counter() - t0,
                    final={k: v.clone() for k, v in
                           server.fedml_aggregator.global_params.items()})

    try:
        one = federation(1, "chip_smoke_resume_a", False)
        two = federation(2, "chip_smoke_resume_b", True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        _reset_trust()
    round_idx, resumed_from, params = two["start"]
    from_saved = all(torch.equal(params[k], one["final"][k]) for k in params)
    print(f"  round 0: {one['wall_s']:.2f} s, test loss {one['losses']}, leave-one-out "
          f"values {one['values']}; the restarted server starts at round {round_idx} "
          f"(checkpoint round {resumed_from}) from the saved parameters: {from_saved}; "
          f"round 1: {two['wall_s']:.2f} s, test loss {two['losses']}, values "
          f"{two['values']}", flush=True)
    losses = one["losses"] + two["losses"]
    if not (round_idx == 1 and resumed_from == 0 and from_saved and len(losses) == 2
            and all(math.isfinite(v) for v in losses)):
        raise RuntimeError(f"cross-silo resume: round {round_idx}, from {resumed_from}, "
                           f"saved params {from_saved}, losses {losses}")
    return dict(losses=losses, values=[{str(k): v for k, v in f["values"].items()}
                                       for f in (one, two)],
                wall_s=[one["wall_s"], two["wall_s"]])


def reconstruction_phase(card: str, ds):
    """Phase (l5): DLG on ResNet-18 against one stand-in image, then
    revealing_labels at init from a batch of REVEAL_BATCH."""
    import types

    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.security.attack import create_attacker
    from fedml_tpu_torch.models import layers
    from fedml_tpu_torch.models.model_hub import create, init_params

    args = load_arguments_from_dict(CONTRIB_CONFIG)
    model = create(args, ds.class_num)
    x_all, y_all = ds.train_data_global
    params = {k: v.requires_grad_(True) for k, v in
              init_params(model, args, x_all[:2], "cuda").items()}
    keys = list(params)

    def loss_grad_fn(p, x, y_soft):
        logp = torch.log_softmax(layers.apply(model, p, x), -1)
        loss = -torch.mean(torch.sum(y_soft * logp, -1))
        return torch.autograd.grad(loss, [p[k] for k in keys], create_graph=True)

    x = torch.as_tensor(np.asarray(x_all[:1]), dtype=torch.float32, device="cuda")
    y = torch.nn.functional.one_hot(torch.as_tensor(np.asarray(y_all[:1]), device="cuda")
                                    .long(), ds.class_num).float()
    observed = [g.detach() for g in loss_grad_fn(params, x, y)]
    attack = create_attacker("dlg", types.SimpleNamespace(
        random_seed=0, dlg_iters=DLG_ITERS, dlg_lr=0.1, dlg_cosine=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rx, ry = attack.reconstruct_data(observed, {
        "loss_grad_fn": loss_grad_fn, "params": params, "x_shape": tuple(x.shape),
        "num_classes": ds.class_num})
    torch.cuda.synchronize()
    dlg_ms = (time.perf_counter() - t0) * 1e3 / DLG_ITERS
    first, final = float(attack.losses[0]), float(attack.losses[-1])
    mse = float(((rx - x) ** 2).mean())
    finite = bool(torch.isfinite(rx).all() and torch.isfinite(ry).all()
                  and all(torch.isfinite(v).all() for v in attack.losses))
    print(f"  DLG on {args.model}, one image, {DLG_ITERS} iterations (cosine): match loss "
          f"{first:.5f} -> {final:.5f}, {dlg_ms:.2f} ms an iteration, MSE to the true "
          f"image {mse:.5g} (its variance {float(x.var()):.5g}), label "
          f"{int(ry.argmax())} vs {int(y.argmax())}; finite {finite}", flush=True)
    if not (finite and final < first and len(attack.losses) == DLG_ITERS):
        raise RuntimeError(f"DLG: losses {first} -> {final}, finite {finite}")

    # revealing_labels: the mean bias gradient of the classifier at init
    xb = torch.as_tensor(np.asarray(x_all[:REVEAL_BATCH]), dtype=torch.float32,
                         device="cuda")
    yb = torch.as_tensor(np.asarray(y_all[:REVEAL_BATCH]), device="cuda").long()
    bias_key = [k for k in keys if "Dense" in k and k.endswith("bias")][-1]
    loss = torch.nn.functional.cross_entropy(layers.apply(model, params, xb), yb)
    (g_bias,) = torch.autograd.grad(loss, [params[bias_key]])
    reveal = create_attacker("revealing_labels", types.SimpleNamespace(random_seed=0))
    info = {"batch_size": REVEAL_BATCH, "num_classes": ds.class_num}
    on_card = reveal.reconstruct_data(None, {**info, "bias_grad": g_bias})
    on_cpu = reveal.reconstruct_data(None, {**info, "bias_grad": g_bias.cpu()})
    truth = np.bincount(yb.cpu().numpy(), minlength=ds.class_num)
    l1 = int(sum(abs(on_card[c] - int(truth[c])) for c in range(ds.class_num)))
    print(f"  revealing_labels from {bias_key}'s gradient, batch {REVEAL_BATCH}: counts "
          f"{[on_card[c] for c in range(ds.class_num)]} (sum {sum(on_card.values())}), "
          f"the CPU's the same {on_card == on_cpu}; truth {truth.tolist()}, L1 {l1}",
          flush=True)
    if sum(on_card.values()) != REVEAL_BATCH or on_card != on_cpu:
        raise RuntimeError(f"revealing_labels: {on_card} vs the CPU's {on_cpu}")
    return dict(dlg_first=first, dlg_final=final, dlg_ms_per_iter=dlg_ms, dlg_mse=mse,
                reveal_counts=[on_card[c] for c in range(ds.class_num)],
                reveal_truth=truth.tolist(), reveal_l1=l1)


def _hist_mean(metrics, name):
    h = (metrics or {}).get(name) or {}
    return h["sum"] / h["count"] if h.get("count") else None


def durable_cross_silo(card: str):
    """Phase (m1): the supervised kill-and-respawn of a durable cross-silo
    server over the broker, held against an uninterrupted in-process run
    (see the module doc)."""
    import shutil
    import tempfile

    from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker
    from fedml_tpu_torch.resilience.durability.recover import supervise_federation

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    broker = PubSubBroker("127.0.0.1", 0).start()
    host, port = broker.address

    def config(tag, compression, rounds, broker_comm):
        cfg = json.loads(json.dumps(DURABLE_CONFIG))
        cfg["common_args"]["run_id"] = f"chip_smoke_durable_{tag}"
        cfg["train_args"].update(compression=compression, comm_round=rounds,
                                 checkpoint_dir=os.path.join(work, tag, "ckpts"))
        if broker_comm:
            cfg["comm_args"] = {"comm_backend": "BROKER", "broker_host": host,
                                "broker_port": port,
                                "object_store_dir": os.path.join(work, tag, "store"),
                                "payload_offload_bytes": 65536}
        return cfg

    try:
        rounds = DURABLE_CONFIG["train_args"]["comm_round"]
        ref_cfg = os.path.join(work, "ref.json")
        with open(ref_cfg, "w") as f:
            json.dump(config("ref", "identity", rounds, False), f)
        env = dict(os.environ, PYTHONHASHSEED=CS_HASHSEED,
                   PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        with open(os.path.join(work, "ref.out"), "w+") as out, \
                open(os.path.join(work, "ref.err"), "w+") as err, \
                ThreadPoolExecutor(2) as pool:
            # the two supervised federations and the uninterrupted run at once
            child = subprocess.Popen([sys.executable, "-c", DURABLE_REF_CHILD, ref_cfg],
                                     cwd=here, env=env, stdout=out, stderr=err, text=True)
            try:
                futures = {tag: pool.submit(
                    supervise_federation, config(tag, tag, n, True),
                    os.path.join(work, tag), kill=DURABLE_KILL,
                    timeout=DURABLE_TIMEOUT_S, hashseed=CS_HASHSEED)
                    for tag, n in (("identity", rounds), ("int8", DURABLE_INT8_ROUNDS))}
                runs = {tag: f.result() for tag, f in futures.items()}
                child.wait(timeout=DURABLE_TIMEOUT_S)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
            ref_s = time.perf_counter() - t0
            out.seek(0)
            err.seek(0)
            if child.returncode:
                raise RuntimeError(f"the uninterrupted run exited {child.returncode}:\n"
                                   f"{err.read()[-3000:]}")
            ref = json.loads(next(ln for ln in out.read().splitlines()
                                  if ln.startswith("REF "))[4:])
    finally:
        broker.stop()
        shutil.rmtree(work, ignore_errors=True)

    def walls(out):
        """Each round's wall from the silos' TRAINED markers (the first of
        each round to the first of the next; the last round to the end)."""
        starts = {}
        for times, marks in zip(out["trained_at_s"].values(), out["trained"].values()):
            for t, r in zip(times, marks):
                starts[r] = min(starts.get(r, t), t)
        order = sorted(starts)
        ends = [starts[r] for r in order[1:]] + [out["wall_s"]]
        return {r: e - starts[r] for r, e in zip(order, ends)}

    journal = {}
    for tag, out in runs.items():
        m = out["server_metrics"] or {}
        journal[tag] = dict(append_ms=_hist_mean(m, "journal/upload_ms"),
                            append_bytes=_hist_mean(m, "journal/upload_bytes"),
                            appends=(m.get("journal/upload_ms") or {}).get("count"),
                            replay_ms=_hist_mean(m, "journal/replay_ms"))
        print(f"  {card}: m1 {tag}: completed {out['completed']}, {out['restarts']} restart, "
              f"MTTR {out['mttr_s']} s (killed at {out['killed_at_s']} s), salvaged "
              f"{out['salvaged_uploads']} upload(s) of silos {out['salvaged_clients']} in "
              f"round {out['resumed_round']}, trained {out['trained']}; round walls s "
              f"{ {r: round(w, 3) for r, w in walls(out).items()} }; whole run "
              f"{out['wall_s']} s; journal append {journal[tag]['append_ms']} ms for "
              f"{journal[tag]['append_bytes']} B a {tag} upload (respawned server, "
              f"{journal[tag]['appends']} appends), replay {journal[tag]['replay_ms']} ms; "
              f"result {out['result']}", flush=True)
    ident = runs["identity"]
    loss, untrained = ident["result"]["test_loss"], ref["untrained_test_loss"]
    print(f"  {card}: m1 digest {ident['digest']}, the uninterrupted in-process run's "
          f"{ref['digest']} ({ref_s:.1f} s, result {ref['result']}); test loss untrained "
          f"{untrained:.5f} -> {loss:.5f}", flush=True)
    for tag, out in runs.items():
        retrained = {c: out["trained"][str(c)].count(out["resumed_round"])
                     for c in out["salvaged_clients"]}
        if not (out["completed"] and out["restarts"] == 1 and out["salvaged_uploads"] >= 1
                and out["resumed_round"] == DURABLE_KILL["round"]
                and all(n == 1 for n in retrained.values())):
            raise RuntimeError(f"m1 {tag}: the killed federation did not resume as "
                               f"journaled: {out}")
    if ident["digest"] != ref["digest"]:
        raise RuntimeError(f"m1: the killed and resumed run's digest {ident['digest']} is "
                           f"not the uninterrupted run's {ref['digest']}")
    if not (math.isfinite(loss) and loss < untrained):
        raise RuntimeError(f"m1: the test loss {loss} is not below the untrained "
                           f"model's {untrained}")
    return dict(runs={tag: {k: v for k, v in out.items() if k != "server_metrics"}
                      for tag, out in runs.items()},
                journal=journal, walls={tag: walls(out) for tag, out in runs.items()},
                ref=ref, ref_s=ref_s, untrained_test_loss=untrained)


def async_phase(card: str):
    """Phase (m2): the async FedBuff server over LOCAL, its journal refill
    held bit for bit, and an instant-apply run's checkpoint a version (see
    the module doc)."""
    import collections
    import copy
    import shutil
    import tempfile

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.cross_silo.server.server import Server
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create

    work = tempfile.mkdtemp(prefix="chip_smoke_async_")

    def args_for(tag, **train):
        cfg = copy.deepcopy(ASYNC_CONFIG)
        cfg["common_args"]["run_id"] = f"chip_smoke_async_{tag}"
        cfg["train_args"].update(checkpoint_dir=os.path.join(work, tag), **train)
        _reset_trust()
        return fedml_tpu_torch.init(load_arguments_from_dict(cfg))

    try:
        args = args_for("run")
        ds = load_federated(args)
        model = create(args, ds.class_num)
        server, clients = build_cross_silo_inproc(args, ds, model, "cuda")
        mgr = server.manager
        untrained = server.fedml_aggregator.test_on_server_for_all_clients(-1)["test_loss"]
        uploads, flush_ms = [], []
        handle, flush = mgr.handle_client_update, mgr._buffer.flush

        def recorded_update(msg):
            uploads.append(msg)
            return handle(msg)

        def timed_flush(version, global_params):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = flush(version, global_params)
            end.record()
            end.synchronize()
            flush_ms.append(start.elapsed_time(end))
            return out

        mgr.handle_client_update = recorded_update
        mgr._buffer.flush = timed_flush
        t0 = time.perf_counter()
        result = run_managers_to_completion([mgr] + [c.manager for c in clients],
                                            args.run_id, MyMessage.MSG_TYPE_CONNECTION_IS_READY,
                                            600)
        wall = time.perf_counter() - t0
        total = ASYNC_CONFIG["train_args"]["async_total_updates"]
        k = ASYNC_CONFIG["train_args"]["async_buffer_size"]
        if not (result["updates"] == total and result["flushes"] == total // k
                and math.isfinite(result["test_loss"]) and result["test_loss"] < untrained):
            raise RuntimeError(f"m2: the async run did not finish its budget in whole "
                               f"flushes below the untrained loss {untrained}: {result}")
        staleness = dict(sorted(collections.Counter(result["staleness"]).items()))
        print(f"  {card}: m2 {total} updates in {wall:.2f} s = {total / wall:.3f} updates/s, "
              f"{result['flushes']} flushes of {k}, flush ms (CUDA events) "
              f"{[round(x, 3) for x in flush_ms]}, staleness histogram {staleness}, "
              f"senders {result['senders']}; test loss untrained {untrained:.5f} -> "
              f"{result['test_loss']:.5f}", flush=True)

        # the journal refill: copies of the run's checkpoint directory (the
        # last flush's version, an empty journal) for the interrupted and the
        # uninterrupted server; 4 of the run's uploads, in order
        contributions = uploads[-k:]
        for tag in ("killed", "whole"):
            shutil.copytree(os.path.join(work, "run"), os.path.join(work, tag))

        def resumed_server(tag):
            a = args_for(tag, resume=True)
            srv = Server(a, "cuda", ds, model)
            srv.manager.send_message = lambda m: None  # no clients listen
            return srv.manager

        first = resumed_server("killed")
        for msg in contributions[:2]:
            first.handle_client_update(msg)
        journaled = len(first._journal.records())
        del first  # abandoned mid-buffer: the crash
        t0 = time.perf_counter()
        second = resumed_server("killed")
        refill_ms = (time.perf_counter() - t0) * 1e3
        refilled = len(second._buffer)
        for msg in contributions[2:]:
            second.handle_client_update(msg)
        whole = resumed_server("whole")
        for msg in contributions:
            whole.handle_client_update(msg)
        got, want = (m.aggregator.get_global_model_params() for m in (second, whole))
        same = all(torch.equal(got[key], want[key]) for key in want)
        print(f"  {card}: m2 refill: {journaled} journal records after 2 buffered uploads; "
              f"the restarted server refilled {refilled} in {refill_ms:.1f} ms (its "
              f"construction), flushed at version {second.version} "
              f"({second.flushes} flush): bit-identical to the uninterrupted flush: {same}",
              flush=True)
        if not (refilled == 2 and second.flushes == whole.flushes == 1
                and second.version == whole.version and same):
            raise RuntimeError(f"m2: the journal-refilled flush is not the uninterrupted one "
                               f"(refilled {refilled}, flushes {second.flushes}/"
                               f"{whole.flushes}, bit-identical {same})")
        for m in (second, whole):
            m.finish()

        # instant apply: a checkpoint of every applied version
        inst = args_for("instant", async_buffer_size=0,
                        async_total_updates=ASYNC_INSTANT_UPDATES)
        server, clients = build_cross_silo_inproc(inst, ds, model, "cuda")
        saver = server.manager._ckpt
        save, save_ms = saver.save, []

        def timed_save(round_idx, state):
            t = time.perf_counter()
            out = save(round_idx, state)
            save_ms.append((time.perf_counter() - t) * 1e3)
            return out

        saver.save = timed_save
        inst_result = run_managers_to_completion(
            [server.manager] + [c.manager for c in clients], inst.run_id,
            MyMessage.MSG_TYPE_CONNECTION_IS_READY, 600)
        if not (inst_result["versions"] == ASYNC_INSTANT_UPDATES
                and len(save_ms) == ASYNC_INSTANT_UPDATES
                and saver.latest_round() == ASYNC_INSTANT_UPDATES):
            raise RuntimeError(f"m2: instant apply did not checkpoint every version: "
                               f"{inst_result}, {len(save_ms)} saves")
        print(f"  {card}: m2 instant apply: {ASYNC_INSTANT_UPDATES} versions, a checkpoint "
              f"each in {[round(x, 1) for x in save_ms]} ms; test loss "
              f"{inst_result['test_loss']:.5f}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        _reset_trust()
    return dict(updates=total, wall_s=wall, updates_per_s=total / wall, flush_ms=flush_ms,
                staleness=staleness, untrained_test_loss=untrained,
                test_loss=result["test_loss"], refill_ms=refill_ms,
                refill_bit_identical=same, checkpoint_ms=save_ms,
                instant_test_loss=inst_result["test_loss"])


def resnet_wire_template(dev: str = "cuda"):
    """Phase h's ResNet-18 (GroupNorm, 2 groups) from ``random_seed``, as a
    tree in the reference's layout (``models.convert.to_wire_params``)."""
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.models.convert import to_wire_params
    from fedml_tpu_torch.models.model_hub import create, init_params

    args = load_arguments_from_dict(SP_CONFIG)
    params = init_params(create(args, 10), args, torch.zeros(2, 32, 32, 3), dev)
    return to_wire_params(params)


def _tree_counters(tiers: int):
    names = [f"tier/{d}/{k}" for d in range(tiers)
             for k in ("evicted", "rejoined", "quorum_closes", "quorum_failures",
                       "upload_bytes", "contributions", "restarts")]
    return names + ["resilience/restarts", "resilience/journal_salvaged",
                    "secagg/hier_recoveries", "secagg/hier_cohort_rounds"]


class _Counted:
    """Counter deltas of a block, each summed over its label sets: ``with
    _Counted(names) as c: ...; c.delta``."""

    def __init__(self, names):
        from fedml_tpu_torch.telemetry import get_registry

        self.reg, self.names = get_registry(), list(names)

    def __enter__(self):
        self.before = {n: self.reg.total(n) for n in self.names}
        return self

    def __exit__(self, *exc):
        self.delta = {n: self.reg.total(n) - self.before[n] for n in self.names}
        return False


def _tree_gates(out: dict, what: str) -> None:
    """The reference's acceptance gates: no tier buffered 5% of the clients'
    f32 trees, and an upload is under 0.35 of an f32 tree."""
    f32_all = out["f32_tree_nbytes"] * out["clients"]
    for d, row in out["per_tier"].items():
        if not row["peak_buffer_bytes"] < TREE_PEAK_FRAC * f32_all:
            raise RuntimeError(f"{what}: tier {d} buffered {row['peak_buffer_bytes']} B, not "
                               f"under {TREE_PEAK_FRAC} of {f32_all} B")
    if not out["per_client_wire_bytes"] < TREE_WIRE_FRAC * out["f32_tree_nbytes"]:
        raise RuntimeError(f"{what}: {out['per_client_wire_bytes']} B an upload against "
                           f"{out['f32_tree_nbytes']} B of f32")


def _sync(dev: str) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def tree_resnet_phase(card: str, dev: str = "cuda", template=None, n1=TREE_N1,
                      levels=TREE_N1_LEVELS, profile_round: bool = True):
    """Phase (n1): the ResNet-18-wide tree with a leaf client killed and an
    interior aggregator crashed and journal-restored (see the constants)."""
    import tempfile

    from fedml_tpu_torch.hierarchy import edge as edge_mod
    from fedml_tpu_torch.hierarchy import (
        EdgeKillWindow,
        KillWindow,
        TreeRunner,
        TreeTopology,
    )
    from fedml_tpu_torch.models.convert import flatten_paths
    from fedml_tpu_torch.resilience.durability import journal as journal_mod
    from fedml_tpu_torch.telemetry import get_registry

    template = resnet_wire_template(dev) if template is None else template
    leaves = list(flatten_paths(template).values())
    n_leaves, n_params = len(leaves), sum(int(x.numel()) for x in leaves)
    topo = TreeTopology.build(n1["clients"], tiers=n1["tiers"])
    if topo.levels != tuple(levels):
        raise RuntimeError(f"n1: levels {topo.levels}, expected {levels}")
    print(f"  {card}: n1 template resnet18 (reference layout): {n_leaves} leaves, "
          f"{n_params} parameters; levels {topo.levels}", flush=True)
    is_cuda = torch.device(dev).type == "cuda"
    chunk_ms, appends = [], []
    inner_chunk = edge_mod.leaf_chunk
    inner_append = journal_mod.RoundJournal.append

    def timed_chunk(*a, **kw):
        if not is_cuda:
            return inner_chunk(*a, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner_chunk(*a, **kw)
        end.record()
        chunk_ms.append((start, end))
        return out

    def timed_append(self, kind, durable=True, **fields):
        t0 = time.perf_counter()
        nbytes = inner_append(self, kind, durable=durable, **fields)
        if kind == "upload_received":
            appends.append(((time.perf_counter() - t0) * 1e3, nbytes))
        return nbytes

    def run(edge_kill: bool, work=None):
        chaos = [KillWindow(*TREE_N1_KILL)]
        if edge_kill:
            chaos.append(EdgeKillWindow(*TREE_N1_EDGE_KILL[:3],
                                        after_children=TREE_N1_EDGE_KILL[3]))
        walls, marks, uploads = [], [None], []
        leaf_uploads = get_registry().counter(f"tier/{topo.leaf_tier}/contributions")

        def on_round(r, params):
            _sync(dev)
            now = time.perf_counter()
            walls.append(now - marks[0])
            marks[0] = now
            uploads.append(leaf_uploads.value - sum(uploads) - marks[1])

        runner = TreeRunner(topo, template=template, codec="int8", seed=n1["seed"],
                            quorum=n1["quorum"], chunk=n1["chunk"], chaos=chaos,
                            durability_dir=work, on_round=on_round, device=dev)
        with _Counted(_tree_counters(topo.n_tiers)) as counted:
            _sync(dev)
            marks[:] = [time.perf_counter(), leaf_uploads.value]
            out = runner.run(n1["rounds"])
        return runner, out, counted.delta, walls, uploads

    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    edge_mod.leaf_chunk = timed_chunk
    try:
        base_runner, base, base_c, base_walls, uploads = run(False)
        _sync(dev)
        chunk_dev_ms = [a.elapsed_time(b) for a, b in chunk_ms]
        chunk_ms.clear()
        journal_mod.RoundJournal.append = timed_append
        with tempfile.TemporaryDirectory() as work:
            _, killed, killed_c, killed_walls, _ = run(True, work)
    finally:
        edge_mod.leaf_chunk = inner_chunk
        journal_mod.RoundJournal.append = inner_append
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if is_cuda else None
    L = topo.leaf_tier
    checks = {
        "digest equal to the unkilled run": killed["final_digest"] == base["final_digest"],
        "one restart": killed_c["resilience/restarts"] == 1,
        "partial sums salvaged": killed_c["resilience/journal_salvaged"] >= 1,
        f"tier/{L}/evicted 1": killed_c[f"tier/{L}/evicted"] == 1 == base_c[f"tier/{L}/evicted"],
        f"tier/{L}/rejoined 1": (killed_c[f"tier/{L}/rejoined"] == 1
                                 == base_c[f"tier/{L}/rejoined"]),
        "finite globals": all(bool(torch.isfinite(x).all()) for x in base_runner.global_leaves),
    }
    _tree_gates(killed, "n1")
    print(f"  {card}: n1 unkilled run: rounds {[round(w, 3) for w in base_walls]} s, "
          f"leaf uploads/s {[round(u / w, 1) for u, w in zip(uploads, base_walls)]}; killed "
          f"run: rounds {[round(w, 3) for w in killed_walls]} s; digests "
          f"{base['final_digest']} / {killed['final_digest']}", flush=True)
    print(f"  {card}: n1 per tier (nodes, peak round upload B, peak buffer B): "
          f"{[(r['nodes'], r['peak_round_upload_bytes'], r['peak_buffer_bytes']) for r in killed['per_tier'].values()]}; "
          f"an upload {killed['per_client_wire_bytes']} B of {killed['f32_tree_nbytes']} B f32",
          flush=True)
    if chunk_dev_ms:
        print(f"  {card}: n1 leaf chunks (CUDA events, unkilled run): {len(chunk_dev_ms)} "
              f"chunks of {n1['chunk']}, {sum(chunk_dev_ms):.1f} ms in all, "
              f"{np.median(chunk_dev_ms):.2f} ms median a chunk", flush=True)
    append_ms = [a for a, _ in appends]
    append_b = [b for _, b in appends]
    if appends:
        print(f"  {card}: n1 edge journal: {len(appends)} partial-sum appends (fsynced), "
              f"{np.median(append_ms):.1f} ms median ({min(append_ms):.1f}-"
              f"{max(append_ms):.1f}), {int(np.median(append_b))} B each; counters "
              f"{ {k: v for k, v in killed_c.items() if v} }", flush=True)
    busy = None
    if profile_round and is_cuda:
        # busy share: profiler device time of one more round (round 0 again, on
        # the unkilled runner) over the unprofiled wall of round 0; the card's
        # activity alone (a round launches ~10^5 kernels, and host-side op
        # records would cost minutes to collect)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            base_runner.run(1)
            torch.cuda.synchronize()
        kernels = _device_kernels(prof).values()
        n_events, dev_ms = sum(n for n, _ in kernels), sum(ms for _, ms in kernels)
        busy = dev_ms / (base_walls[0] * 1e3) if dev_ms else None
        print(f"  {card}: n1 one round: {base_walls[0] * 1e3:.1f} ms unprofiled wall; device "
              + ("time not measured" if busy is None else
                 f"{dev_ms:.1f} ms (profiler, {n_events} device events), busy share "
                 f"{busy:.3f}") + f"; the profiled round took "
              f"{time.perf_counter() - t0:.1f} s with collection", flush=True)
    print(f"  {card}: n1 peak memory " + ("not measured" if peak_gb is None else
                                         f"{peak_gb:.2f} GB") + f"; checks {checks}", flush=True)
    if not all(checks.values()):
        raise RuntimeError(f"n1 failed: {checks}")
    return dict(levels=list(topo.levels), n_leaves=n_leaves, n_params=n_params,
                round_s=base_walls, killed_round_s=killed_walls,
                leaf_uploads_per_s=[u / w for u, w in zip(uploads, base_walls)],
                per_tier=killed["per_tier"], per_client_wire_bytes=killed["per_client_wire_bytes"],
                f32_tree_nbytes=killed["f32_tree_nbytes"], chunk_device_ms=chunk_dev_ms,
                journal_append_ms=append_ms, journal_append_bytes=append_b,
                busy_share=busy, peak_gb=peak_gb, digest=killed["final_digest"],
                counters=killed_c)


def _device_kernels(prof) -> dict:
    """``{name: [launches, ms]}`` of a profile's device events (kernels,
    copies, sets), read from the raw results: building the profiler's event
    tree costs more than the window it covers."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        events = [(e.name(), e.duration_ns() / 1e6)
                  for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    except AttributeError:  # another torch: the parsed events
        events = [(e.name, e.self_device_time_total / 1e3) for e in prof.events()
                  if e.device_type == cuda]
    out = {}
    for name, ms in events:
        slot = out.setdefault(name, [0, 0.0])
        slot[0] += 1
        slot[1] += ms
    return out


def tree_100k_phase(card: str, dev: str = "cuda", cli_args=TREE_N2_ARGS):
    """Phase (n2): the reference's 100k-client acceptance through the
    ``tree`` command in a child process, replayed in process beside it."""
    import tempfile

    from fedml_tpu_torch.hierarchy import KillWindow, TreeRunner, TreeTopology, default_template

    opts = dict(zip(cli_args[0::2], cli_args[1::2]))
    # its output goes to files: nobody reads a pipe while the replay runs
    out_f, err_f = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "fedml_tpu_torch.cli", "tree", *cli_args,
                             "--device", dev], stdout=out_f, stderr=err_f, text=True)
    try:
        topo = TreeTopology.build(int(opts["--clients"]), tiers=int(opts["--tiers"]))
        with _Counted(_tree_counters(topo.n_tiers)) as counted:
            runner = TreeRunner(topo, template=default_template(int(opts["--params"])),
                                codec=opts["--codec"], seed=0, quorum=float(opts["--quorum"]),
                                chaos=[KillWindow(int(opts["--kill-tier"]),
                                                  int(opts["--kill-node"]),
                                                  int(opts["--kill-round"]))], device=dev)
            out = runner.run(int(opts["--rounds"]))
        c = counted.delta
        proc.wait(timeout=TREE_CLI_TIMEOUT_S)
        cli_wall = time.perf_counter() - t0
        out_f.seek(0)
        err_f.seek(0)
        stdout, stderr = out_f.read(), err_f.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out_f.close()
        err_f.close()
    lines = stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"n2: the tree command exited {proc.returncode}: "
                           f"{stdout[-2000:]} {stderr[-2000:]}")
    cli_out = json.loads(lines[-1])
    checks = {
        "both completed": bool(cli_out.get("completed")) and out["completed"],
        "digests equal": cli_out.get("final_digest") == out["final_digest"],
        "tier/0/quorum_closes >= 1": c["tier/0/quorum_closes"] >= 1,
        "tier/1/evicted >= 1": c["tier/1/evicted"] >= 1,
    }
    _tree_gates(cli_out, "n2 (the command)")
    _tree_gates(out, "n2 (in process)")
    print(f"  {card}: n2 the tree command: {cli_wall:.1f} s wall (process included), "
          f"{cli_out['rounds_per_s']:.3f} rounds/s inside; in process, beside it, "
          f"{out['wall_s']:.2f} s = {out['rounds_per_s']:.3f} rounds/s; levels "
          f"{out['levels']}; per tier (peak round upload B, peak buffer B) "
          f"{[(r['peak_round_upload_bytes'], r['peak_buffer_bytes']) for r in out['per_tier'].values()]}; "
          f"digest {out['final_digest']}; checks {checks}", flush=True)
    if not all(checks.values()):
        raise RuntimeError(f"n2 failed: {checks}; the command said {cli_out}")
    return dict(cli_wall_s=cli_wall, cli_rounds_per_s=cli_out["rounds_per_s"],
                rounds_per_s=out["rounds_per_s"], wall_s=out["wall_s"], levels=out["levels"],
                per_tier=out["per_tier"], digest=out["final_digest"], counters=c)


def tree_secagg_phase(card: str, dev: str = "cuda", template=None, n3=TREE_N3):
    """Phase (n3): per-edge-cohort SecAgg at ResNet-18 width, run twice."""
    from fedml_tpu_torch.hierarchy import KillWindow, TreeRunner, TreeTopology

    template = resnet_wire_template(dev) if template is None else template
    topo = TreeTopology(n3["levels"])
    killed = TREE_N3_KILL[1]
    recovered = {}

    def run(check: bool):
        runner = TreeRunner(topo, template=template, codec="int8", seed=n3["seed"],
                            quorum=n3["quorum"], chunk=n3["chunk"], secagg=True,
                            chaos=[KillWindow(*TREE_N3_KILL)], device=dev)
        if check:
            cohort = runner.cohorts[topo.parent(topo.leaf_tier, killed)]
            reduce = cohort.reduce

            def checked(r, alive):
                out = reduce(r, alive)
                if r == TREE_N3_KILL[2]:
                    live = np.nonzero(np.asarray(alive) & ~cohort.evicted_mask)[0]
                    plain = cohort.chunk_words(r, live, None)
                    recovered["equal"] = all(torch.equal(a, b) for a, b in
                                             zip(cohort.last_words, plain))
                    recovered["survivors"] = len(live)
                return out

            cohort.reduce = checked
        with _Counted(_tree_counters(topo.n_tiers)) as counted:
            t0 = time.perf_counter()
            out = runner.run(n3["rounds"])
            wall = time.perf_counter() - t0
        mask_s = sum(c.host_mask_s for c in runner.cohorts)
        return out, counted.delta, wall, mask_s

    first, c1, wall1, mask1 = run(True)
    second, c2, wall2, mask2 = run(False)
    checks = {
        "digests equal": first["final_digest"] == second["final_digest"],
        "recoveries >= 1": c1["secagg/hier_recoveries"] >= 1,
        "the recovered cohort sum is the survivors' unmasked words":
            bool(recovered.get("equal")),
    }
    per_round = [wall1 / n3["rounds"], wall2 / n3["rounds"]]
    print(f"  {card}: n3 secagg tree {topo.levels}: {[round(x, 3) for x in per_round]} s a "
          f"round (two runs), host masks and recovery {mask1 * 1e3:.0f} / {mask2 * 1e3:.0f} "
          f"ms a run ({mask1 * 1e3 / n3['rounds']:.0f} ms a round); round "
          f"{TREE_N3_KILL[2]}: {recovered.get('survivors')} survivors, counters "
          f"{ {k: v for k, v in c1.items() if v} }; "
          f"checks {checks}", flush=True)
    if not all(checks.values()):
        raise RuntimeError(f"n3 failed: {checks}")
    return dict(round_s=per_round, host_mask_ms=[mask1 * 1e3, mask2 * 1e3],
                digest=first["final_digest"], counters=c1)


def _cli_line(argv) -> tuple:
    """One in-process run of the port's command line: (exit code, its last
    stdout line as JSON)."""
    import contextlib
    import io

    from fedml_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


class _RecordedRunners:
    """Keep the ``TreeRunner``s the FA federation builds while the block runs
    (``with _RecordedRunners() as rec: ...; rec.runners``)."""

    def __enter__(self):
        from fedml_tpu_torch.fa.sketch import federation

        self.mod, self.inner, self.runners = federation, federation.TreeRunner, []
        outer = self

        class Recording(self.inner):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                outer.runners.append(self)

        federation.TreeRunner = Recording
        return self

    def __exit__(self, *exc):
        self.mod.TreeRunner = self.inner
        return False


def fa_fsm_phase(card: str, dev: str = "cuda"):
    """Phase (p1): the ``fa`` command's FA message FSM for every task on the
    card, each line against the same command on the CPU."""
    cases = [["--task", t] for t in FA_P1_TASKS] + [list(FA_P1_QUORUM)]
    rows, checks = [], {}
    with _Counted(FA_COUNTERS) as counted:
        for argv in cases:
            t0 = time.perf_counter()
            rc, got = _cli_line(["fa", *argv, "--seed", "0", "--device", dev])
            wall = time.perf_counter() - t0
            rc_cpu, want = _cli_line(["fa", *argv, "--seed", "0", "--device", "cpu"])
            name = " ".join(argv[1:])
            if argv[1] == "avg":
                same = (abs(got.pop("avg") - want.pop("avg")) <= FA_AVG_TOL and got == want)
            else:
                same = got == want
            checks[f"{name}: completed"] = rc == rc_cpu == 0 and got.get("completed") is True
            checks[f"{name}: equal to the CPU's"] = same
            rows.append((name, wall, got.get("rounds"), got.get("spec")))
            if argv[1] == "heavy_hitter_triehh":
                checks["TrieHH found sun and moon"] = {"sun", "moon"} <= set(got["heavy_hitters"])
    print(f"  {card}: p1 the fa command, 6 clients (task, wall s on the card, rounds, spec): "
          f"{[(n, round(w, 3), r, sp) for n, w, r, sp in rows]}; counters (card and CPU runs) "
          f"{ {k: v for k, v in counted.delta.items() if v} }", flush=True)
    if not all(checks.values()):
        raise RuntimeError(f"p1 failed: {[k for k, v in checks.items() if not v]}")
    return dict(tasks=[dict(zip(("task", "wall_s", "rounds", "spec"), r)) for r in rows],
                counters=counted.delta)


def fa_federation_phase(card: str, dev: str = "cuda"):
    """Phase (p2): the reference's 102,400-client heavy-hitter acceptance, at
    FA_P2's quarter of its clients, on
    the card without SecAgg, twice."""
    import tempfile

    from fedml_tpu_torch.fa.sketch.federation import last_sketch_trace, run_sketch_federation
    from fedml_tpu_torch.hierarchy import EdgeKillWindow, KillWindow, TreeTopology
    from fedml_tpu_torch.hierarchy import edge as edge_mod
    from fedml_tpu_torch.hierarchy.runner import last_dp_trace

    n, levels = FA_P2["n_clients"], FA_P2["levels"]
    topo = TreeTopology(levels)
    L = topo.leaf_tier
    dead_leaves = [3, n // 2, n - 5]
    cohort = topo.children(L - 1, FA_P2_DEAD_EDGE)
    survivors = sorted(set(range(n)) - set(dead_leaves) - {int(c) for c in cohort})
    chunk_ms = []
    inner_chunk = edge_mod.leaf_chunk
    is_cuda = torch.device(dev).type == "cuda"

    def timed_chunk(*a, **kw):
        if not is_cuda:
            return inner_chunk(*a, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner_chunk(*a, **kw)
        end.record()
        chunk_ms.append((start, end))
        return out

    def run(work):
        chaos = [KillWindow(L, c, 0) for c in dead_leaves]
        chaos.append(KillWindow(L - 1, FA_P2_DEAD_EDGE, 0))
        chaos.append(EdgeKillWindow(0, 0, 0, after_children=FA_P2_ROOT_CRASH_AFTER))
        with _Counted(FA_COUNTERS) as counted, _RecordedRunners() as rec:
            _sync(dev)
            t0 = time.perf_counter()
            out = run_sketch_federation(chaos=chaos, durability_dir=work,
                                        reference_client_ids=survivors, device=dev, **FA_P2)
            wall = time.perf_counter() - t0
        probes = (last_sketch_trace()["client_sketch_traced"],
                  last_dp_trace()["noised_in_program"])
        return out, counted.delta, wall, rec.runners[-1], probes

    edge_mod.leaf_chunk = timed_chunk
    try:
        with tempfile.TemporaryDirectory() as work:
            first, c1, wall1, runner, probes1 = run(work)
        _sync(dev)
        chunk_dev_ms = [a.elapsed_time(b) for a, b in chunk_ms]
    finally:
        edge_mod.leaf_chunk = inner_chunk
    with tempfile.TemporaryDirectory() as work:
        second, c2, wall2, _, probes2 = run(work)
    g = runner.global_leaves[0]
    # one cohort's chunk once more: its device time (profiler, the card's
    # activity alone) against its wall, which the host's launches set
    cohort = runner.cohorts[FA_P2_PROFILED_COHORT]
    alive = np.ones(len(cohort.client_ids), bool)
    _sync(dev)
    t0 = time.perf_counter()
    cohort.reduce(0, alive)
    _sync(dev)
    chunk_wall_ms = (time.perf_counter() - t0) * 1e3
    chunk_kernels = None
    if is_cuda:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cohort.reduce(0, alive)
            torch.cuda.synchronize()
        chunk_kernels = _device_kernels(prof).values()
    chunk_launches = sum(k for k, _ in chunk_kernels) if chunk_kernels else None
    chunk_busy_ms = sum(ms for _, ms in chunk_kernels) if chunk_kernels else None
    round_s = [first["stats"]["wall_s"], second["stats"]["wall_s"]]
    uploads = c1[f"tier/{L}/contributions"]
    checks = {
        "completed": bool(first["stats"]["completed"] and second["stats"]["completed"]),
        "root weight = the survivors": first["root_total_weight"] == float(len(survivors)),
        "heavy hitters = the plaintext reference's": (
            first["heavy_hitters"] == first["ref_heavy_hitters"] == second["heavy_hitters"]
            and first["hh_recall"] == first["hh_precision"] == 1.0),
        "resilience/restarts >= 1": c1["resilience/restarts"] >= 1,
        "sketch and DP probes": all(probes1) and all(probes2),
        "digest-equal runs": first["final_digest"] == second["final_digest"],
        "finite global of the template's shape": (
            tuple(g.shape) == (3, 1024) and bool(torch.isfinite(g).all())),
        "wire = 4 B a cell + the scale": first["per_client_wire_bytes"] == 4 * 3 * 1024 + 4,
    }
    print(f"  {card}: p2 {n} clients {list(levels)}, {first['spec']}, DP sigma "
          f"{FA_P2['dp_sigma']} (epsilon {first['dp_epsilon']:.3f}): wall {wall1:.2f} / "
          f"{wall2:.2f} s (reference replay included), round {round_s[0]:.2f} / "
          f"{round_s[1]:.2f} s, {uploads / round_s[0]:.0f} leaf uploads/s; "
          + (f"{len(chunk_dev_ms)} leaf chunks (CUDA events), "
             f"{np.median(chunk_dev_ms):.3f} ms median a chunk, {sum(chunk_dev_ms):.1f} ms in "
             "all (event to event: the host's launch gaps included)" if chunk_dev_ms
             else "leaf chunks' event ms not measured")
          + f"; one cohort's chunk again: {chunk_wall_ms:.2f} ms of wall, "
          + ("device time not measured" if chunk_busy_ms is None else
             f"{chunk_busy_ms:.3f} ms of device time in {chunk_launches} device events "
             f"(profiler), busy share {chunk_busy_ms / chunk_wall_ms:.3f}")
          + f"; wire {first['per_client_wire_bytes']} B a client against "
          f"{first['plain_sketch_bytes']} B of plain sketch; heavy hitters "
          f"{first['heavy_hitters']}; digest {first['final_digest']}; counters "
          f"{ {k: v for k, v in c1.items() if v} }; checks {checks}", flush=True)
    if not all(checks.values()):
        raise RuntimeError(f"p2 failed: {[k for k, v in checks.items() if not v]}")
    return dict(wall_s=[wall1, wall2], round_s=round_s, leaf_uploads_per_s=uploads / round_s[0],
                chunk_event_ms=chunk_dev_ms, chunk_wall_ms=chunk_wall_ms,
                chunk_busy_ms=chunk_busy_ms, chunk_launches=chunk_launches, per_client_wire_bytes=first["per_client_wire_bytes"],
                plain_sketch_bytes=first["plain_sketch_bytes"], dp_epsilon=first["dp_epsilon"],
                heavy_hitters=first["heavy_hitters"], digest=first["final_digest"], counters=c1)


def fa_secagg_phase(card: str, dev: str = "cuda"):
    """Phase (p3): the ``fa --federation`` command (SecAgg on) at 256 clients
    against a plain run of the same scenario."""
    from fedml_tpu_torch.fa.sketch.federation import run_sketch_federation

    with _Counted(FA_COUNTERS) as counted, _RecordedRunners() as rec:
        t0 = time.perf_counter()
        rc, masked = _cli_line(["fa", *FA_P3_ARGS, "--seed", "0", "--device", dev])
        wall = time.perf_counter() - t0
    mask_ms = sum(c.host_mask_s for c in rec.runners[-1].cohorts) * 1e3
    t0 = time.perf_counter()
    plain = run_sketch_federation(n_clients=int(FA_P3_ARGS[2]), tiers=int(FA_P3_ARGS[4]),
                                  seed=0, secagg=False, device=dev)
    plain_wall = time.perf_counter() - t0
    checks = {
        "completed": rc == 0 and plain["stats"]["completed"],
        f"levels {list(FA_P3_LEVELS)}": masked["levels"] == list(FA_P3_LEVELS),
        "masked digest = plain digest": masked["final_digest"] == plain["final_digest"],
        "heavy hitters = the reference's": (
            masked["heavy_hitters"] == masked["ref_heavy_hitters"] == plain["heavy_hitters"]),
        "secagg cohort rounds": counted.delta["secagg/hier_cohort_rounds"]
        == FA_P3_LEVELS[1],
    }
    print(f"  {card}: p3 fa --federation {masked['clients']} clients {masked['levels']}, "
          f"{masked['spec']}, SecAgg: command wall {wall:.2f} s, {masked['rounds_per_s']:.3f} "
          f"rounds/s inside, host masks {mask_ms:.0f} ms; plain run {plain_wall:.2f} s; wire "
          f"{masked['per_client_wire_bytes']} B a client against "
          f"{masked['plain_sketch_bytes']} B of plain sketch; digest "
          f"{masked['final_digest']}; counters "
          f"{ {k: v for k, v in counted.delta.items() if v} }; checks {checks}", flush=True)
    if not all(checks.values()):
        raise RuntimeError(f"p3 failed: {[k for k, v in checks.items() if not v]}")
    return dict(wall_s=wall, rounds_per_s=masked["rounds_per_s"], host_mask_ms=mask_ms,
                plain_wall_s=plain_wall, digest=masked["final_digest"], counters=counted.delta)


def full_step_flops(cfg, batch: int, t: int) -> float:
    """Model FLOPs of one full-parameter training step: every projection and
    the LM head forward (2 FLOPs per weight per token), its activation and
    weight gradients (2 + 2), and the attention kernels' products (4 + 6 + 8
    per (query, key) pair and head dim, causal). The forward that activation
    checkpointing recomputes in the backward is not counted."""
    h, d, kv = cfg.hidden_size, cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    proj = 2 * h * h + 2 * h * kv + 3 * h * cfg.intermediate_size
    tokens = batch * t
    per_layer = 6 * proj * tokens + 18 * batch * cfg.num_attention_heads * d \
        * attention_pairs(t, t, True)
    return cfg.num_hidden_layers * per_layer + 6 * h * cfg.vocab_size * tokens


def _flash_counts(fa) -> dict:
    return {"flash_fwd": fa.FLASH_FWD_LAUNCHES, "flash_bwd_dq": fa.FLASH_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.FLASH_DKV_LAUNCHES}


def _strided_sample(p: torch.Tensor, n: int = 65536) -> torch.Tensor:
    """At most ``n`` evenly strided elements of ``p``, copied."""
    flat = p.detach().reshape(-1)
    return flat[:: max(1, flat.numel() // n)].clone()


def full_ft_phase(card: str, peak_bw: float, peak_flops: float, dev: str = "cuda"):
    """Phase (q1): full fine-tuning of Llama-3-8B widths, Q1_ARGS' depth, f32
    weights, through ``LLMTrainer`` (every parameter trained, AdamW over the
    whole flat dict): Q1_STEPS steps on one batch at T=2048 and an eval, the
    flash launch counts read around exactly them. It fails unless the loss
    falls, every
    parameter moved (a strided sample of each), the launches are the
    predicted count and the peak stays under Q1_PEAK_GIB; it prints s a step,
    tokens/s, model TFLOP/s, the optimizer update's ms (CUDA events) against
    its bytes floor and the peak memory."""
    import types

    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.convert import ref_path
    from fedml_tpu_torch.models.llm.llama import LlamaConfig
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.train.llm.trainer import LLMTrainer

    args = types.SimpleNamespace(**Q1_ARGS)
    ds = load_synthetic_lm(args)
    cfg = LlamaConfig.from_args(args)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = LLMTrainer(cfg, args, device=dev)
    trainer.init(seed=int(args.random_seed))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    params = {ref_path(n): p for n, p in trainer.model.named_parameters()}
    n_params = sum(p.numel() for p in params.values())
    if trainer.lora_only or set(trainer.opt_state.mu) != set(params):
        raise RuntimeError("q1's trainer does not train every parameter")
    before = {k: _strided_sample(p) for k, p in params.items()}
    print(f"  booted {args.model_size} at {cfg.num_hidden_layers} layers, {n_params} "
          f"parameters in f32, every one trained, in {boot_s:.1f} s: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated", flush=True)

    # the optimizer update as it runs in each step, timed with CUDA events
    update_events = []
    inner_update = trainer.tx.update_

    def timed_update(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        inner_update(*a, **kw)
        ev[1].record()
        update_events.append(ev)

    trainer.tx.update_ = timed_update
    xs, ys = ds.train_data_global
    xt, yt = ds.test_data_global
    one = np.ones((1,), np.float32)
    # --- the main path, with the launch counts read around exactly it ---
    fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
    steps = []
    for s in range(Q1_STEPS):
        t0 = time.perf_counter()
        loss = trainer.step(xs[:1], ys[:1], one)  # returns a host float
        steps.append((loss, time.perf_counter() - t0))
    ev = trainer.evaluate(xt[:1], yt[:1])
    launches = _flash_counts(fa)
    trainer.tx.update_ = inner_update
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    layers = cfg.num_hidden_layers
    # remat "full": each step's backward runs every block's forward again
    expected = {"flash_fwd": layers * (2 * Q1_STEPS + 1), "flash_bwd_dq": layers * Q1_STEPS,
                "flash_bwd_dkv": layers * Q1_STEPS}
    moved = {k: not torch.equal(_strided_sample(p), before[k]) for k, p in params.items()}
    emb_moved = float((_strided_sample(params["params/embed_tokens"])
                       != before["params/embed_tokens"]).float().mean())
    update_ms = [a.elapsed_time(b) for a, b in update_events]
    update_floor_ms = 28 * n_params / peak_bw * 1e3
    step_s = float(np.mean([dt for _, dt in steps[1:]]))
    flops = full_step_flops(cfg, 1, args.max_seq_length)
    tokens_per_s = args.max_seq_length / step_s
    for i, (loss, dt) in enumerate(steps):
        print(f"  step {i}: loss {loss:.5f}, {dt:.3f} s, optimizer update "
              f"{update_ms[i]:.2f} ms", flush=True)
    print(f"  steady step {step_s:.3f} s = {tokens_per_s:.1f} tokens/s, "
          f"{flops / step_s / 1e12:.1f} TFLOP/s of model FLOPs ({flops:.4g} a step); the "
          f"update {float(np.mean(update_ms[1:])):.2f} ms against its bytes floor "
          f"{update_floor_ms:.2f} ms (28 B a parameter at {peak_bw / 1e12:.2f} TB/s); eval "
          f"loss {ev['eval_loss']:.5f}; peak memory {peak_gib:.3f} GiB (limit "
          f"{Q1_PEAK_GIB}); {sum(moved.values())} of {len(moved)} parameters moved "
          f"(embedding: {emb_moved:.4f} of its sampled elements, the rows of the tokens "
          f"seen); launches {launches} (expected {expected})", flush=True)
    if launches != expected:
        raise RuntimeError(f"flash launches {launches} != expected {expected}")
    if not (all(math.isfinite(l_) for l_, _ in steps) and steps[-1][0] < steps[0][0]
            and math.isfinite(ev["eval_loss"])):
        raise RuntimeError(f"q1's loss did not fall: {steps}, eval {ev}")
    if not all(moved.values()):
        raise RuntimeError(f"parameters that did not move: "
                           f"{[k for k, v in moved.items() if not v]}")
    if peak_gib > Q1_PEAK_GIB:
        raise RuntimeError(f"q1's peak {peak_gib:.2f} GiB is over {Q1_PEAK_GIB} GiB")
    del trainer, params, before
    return dict(layers=layers, params=n_params, launches=launches, expected_launches=expected,
                losses=[l_ for l_, _ in steps], step_s=[dt for _, dt in steps],
                steady_step_s=step_s, tokens_per_s=tokens_per_s, step_flops=flops,
                model_tflops_per_s=flops / step_s / 1e12, update_ms=update_ms,
                update_floor_ms=update_floor_ms, eval_loss=ev["eval_loss"],
                peak_gib=peak_gib, boot_s=boot_s, embedding_moved_share=emb_moved)


def full_fedllm_phase(card: str, dev: str = "cuda"):
    """Phase (q2): the full-parameter federation, FedLLMAPI's host loop at
    Llama-3-8B widths and Q2_ARGS' depth: 2 clients x 2 local steps, 2
    rounds, round 0 checkpointed (every parameter), the flash launches
    counted around exactly ``train()``. Then the round-0 checkpoint is
    restored into a freshly built FedLLMAPI and round 1 runs again. The
    checkpoint carries no optimizer state (as the reference's does not), so
    the resumed run takes AdamW's moments from a host snapshot of the
    uninterrupted run at the same boundary. It fails unless the restored
    parameters equal the checkpoint bit for bit and the resumed round's
    global state and test loss equal the uninterrupted round's bit for bit;
    it prints s a round, the exchange and aggregation ms, the checkpoint's
    bytes and save/restore ms and the peak memory."""
    import shutil
    import tempfile
    import types

    import fedml_tpu_torch
    from fedml_tpu_torch.core.checkpoint import read_round_dir
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.convert import ref_path
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    work = tempfile.mkdtemp(prefix="chip_smoke_full_ckpt_")
    try:
        args = types.SimpleNamespace(**Q2_ARGS, checkpoint_dir=work)
        _reset_trust()
        fedml_tpu_torch.init(args)
        ds = load_synthetic_lm(args)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        api = FedLLMAPI(args, dev, ds)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        engine, cfg = api.client.engine, api.cfg
        n_params = sum(p.numel() for p in engine.model.parameters())
        print(f"  booted {args.model_size} at {cfg.num_hidden_layers} layers, {n_params} "
              f"parameters in f32, in {boot_s:.1f} s; {shutil.disk_usage(work).free / 1e9:.1f} "
              f"GB free for the checkpoints", flush=True)
        spans = {}

        def timed(name, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                spans[name] = spans.get(name, 0.0) + time.perf_counter() - t
                return out
            return run

        engine.step = timed("steps", engine.step)
        engine.load_exchange_state = timed("exchange", engine.load_exchange_state)
        engine.exchange_state = timed("exchange", engine.exchange_state)
        for hook in ("on_before_aggregation", "aggregate", "on_after_aggregation"):
            setattr(api.aggregator, hook, timed("aggregation", getattr(api.aggregator, hook)))
        rounds, snapshot = [], {}
        inner = api.train_one_round

        def recorded(r):
            spans.clear()
            rep = inner(r)
            rep.update({f"{k}_s": v for k, v in spans.items()})
            rounds.append(rep)
            if r == 0:  # AdamW's moments at the round boundary, kept on the host
                st = engine.opt_state
                snapshot.update(count=st.count,
                                mu={k: v.to("cpu", copy=True) for k, v in st.mu.items()},
                                nu={k: v.to("cpu", copy=True) for k, v in st.nu.items()})
            return rep

        api.train_one_round = recorded
        # --- the main path, with the launch counts read around exactly it ---
        fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
        t0 = time.perf_counter()
        api.train()
        train_wall_s = time.perf_counter() - t0
        launches = _flash_counts(fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        layers = cfg.num_hidden_layers
        per_client = args.train_size // args.client_num_in_total  # steps at batch 1
        steps = args.client_num_per_round * per_client * args.comm_round
        evals = len(api.test_history)
        expected = {"flash_fwd": layers * (steps + evals), "flash_bwd_dq": layers * steps,
                    "flash_bwd_dkv": layers * steps}
        tokens_per_round = args.client_num_per_round * per_client * args.max_seq_length
        for rep in rounds:
            print(f"  round {rep['round']}: {rep['round_sec']:.3f} s "
                  f"({tokens_per_round / rep['round_sec']:.1f} tokens/s), test loss "
                  f"{rep['test_loss']:.5f}; local steps {rep.get('steps_s', 0):.3f} s, "
                  f"exchange {rep.get('exchange_s', 0) * 1e3:.1f} ms, aggregation "
                  f"{rep.get('aggregation_s', 0) * 1e3:.1f} ms"
                  + (f"; checkpoint {rep['checkpoint_bytes']} B in "
                     f"{rep['checkpoint_ms']:.1f} ms" if "checkpoint" in rep else ""),
                  flush=True)
        print(f"  train(): {args.comm_round} rounds in {train_wall_s:.2f} s; peak memory "
              f"{peak_gb:.3f} GB; launches {launches} (expected {expected})", flush=True)
        if launches != expected:
            raise RuntimeError(f"flash launches {launches} != expected {expected}")
        if not all(math.isfinite(r["test_loss"]) for r in rounds):
            raise RuntimeError(f"non-finite test losses: {rounds}")
        want = {k: v.to("cpu", copy=True) for k, v in api.global_exchange.items()}
        want_loss = rounds[1]["test_loss"]
        ckpt0 = rounds[0]["checkpoint"]
        del api, engine
        gc.collect()
        torch.cuda.empty_cache()

        # --- round 1 again, from the round-0 checkpoint in a fresh FedLLMAPI ---
        args2 = types.SimpleNamespace(**{**vars(args), "checkpoint_dir": None})
        api = FedLLMAPI(args2, dev, ds)
        engine = api.client.engine
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.load_checkpoint(ckpt0)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        saved = read_round_dir(ckpt0)
        restored = all(torch.equal(p.detach().cpu(), saved[ref_path(n)])
                       for n, p in engine.model.named_parameters())
        del saved
        with torch.no_grad():
            engine.opt_state.count = snapshot["count"]
            for k in engine.opt_state.mu:
                engine.opt_state.mu[k].copy_(snapshot["mu"][k])
                engine.opt_state.nu[k].copy_(snapshot["nu"][k])
        api.global_exchange = engine.exchange_state()
        rep = api.train_one_round(1)
        got = {k: v.cpu() for k, v in api.global_exchange.items()}
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        max_diff = max((float((got[k].double() - want[k].double()).abs().max())
                        for k in differ), default=0.0)
        print(f"  round-0 checkpoint restored into a fresh FedLLMAPI in {restore_ms:.1f} ms, "
              f"bit for bit: {restored}; round 1 again: test loss {rep['test_loss']!r} vs "
              f"{want_loss!r} uninterrupted; global leaves that differ: {len(differ)} of "
              f"{len(want)} (largest |diff| {max_diff:.3g})", flush=True)
        if not (restored and not differ and rep["test_loss"] == want_loss):
            raise RuntimeError(f"the resumed round is not the uninterrupted one: restored "
                               f"{restored}, differing leaves {differ[:5]}")
        del api, engine
        _reset_trust()
        return dict(layers=layers, params=n_params, launches=launches,
                    expected_launches=expected, rounds=[
                        {k: v for k, v in r.items() if isinstance(v, (int, float, str))}
                        for r in rounds],
                    train_wall_s=train_wall_s, peak_gb=peak_gb, restore_ms=restore_ms,
                    resumed_round_s=rep["round_sec"], boot_s=boot_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def moe_load(top_idx: torch.Tensor, cap: int, n_experts: int, n_real: int):
    """Per-expert assignments of the real tokens (every choice) and the
    assignments dropped by capacity (beyond ``cap`` in a group), from one
    layer's ``[G, g, K]`` routing."""
    g = top_idx.shape[1]
    real = (torch.arange(top_idx.shape[0] * g, device=top_idx.device) < n_real).reshape(-1, g)
    load = torch.zeros(n_experts, dtype=torch.long, device=top_idx.device)
    dropped = 0
    for grp in range(top_idx.shape[0]):
        per = torch.bincount(top_idx[grp].reshape(-1), minlength=n_experts)
        dropped += int((per - cap).clamp_min(0).sum())
        load += torch.bincount(top_idx[grp][real[grp]].reshape(-1), minlength=n_experts)
    return load.cpu().tolist(), dropped


def moe_phase(card: str, dev: str = "cuda"):
    """Phase (q3): federated LoRA rounds of a mixture-of-experts Llama at
    Llama-3-8B widths (Q3_ARGS: 8 experts, top-2, capacity 1.25, groups of
    1024, bf16 base, LoRA rank 16, Q3_ARGS' depth) through FedLLMAPI's
    on-device round, the flash launches counted around exactly ``train()``.
    It fails unless the loss on round 0's training batches falls below the
    untrained model's, every router moved and no expert did, the train loss counts the aux term once
    (the remat path's loss minus the eval loss is the weighted mean aux), at
    most 0.1% of layer 0's tokens route otherwise on the CPU, and the
    launches are the predicted count; it prints s a round, tokens/s, the
    assignments dropped by capacity, the per-expert load and the peak."""
    import types

    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm import llama as tl
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    args = types.SimpleNamespace(**Q3_ARGS)
    ds = load_synthetic_lm(args)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = FedLLMAPI(args, dev, ds)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    engine, cfg = api.client.engine, api.cfg
    model = engine.model
    moes = [layer.moe for layer in model.layers()]
    base_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    print(f"  booted a {cfg.num_hidden_layers}-layer MoE at {args.model_size} widths "
          f"({cfg.num_experts} experts, top-{cfg.num_experts_per_tok}, capacity factor "
          f"{cfg.moe_capacity_factor}, groups of {cfg.moe_group_size}; {base_gb:.2f} GB of "
          f"parameters) in {boot_s:.1f} s", flush=True)
    # the loss of round 0's training batches, before and after: the test
    # sequences cover other tokens, whose bigrams a few LoRA steps cannot move
    probe_x, probe_y, _, _ = api.round_batch(0)
    probe = [(probe_x[c, s], probe_y[c, s]) for c in range(probe_x.shape[0])
             for s in range(probe_x.shape[1])]

    def probe_loss():
        return float(np.mean([engine.evaluate(x_, y_)["eval_loss"] for x_, y_ in probe]))

    untrained = probe_loss()
    routers0 = [m.router.detach().clone() for m in moes]

    def expert_sums():  # each expert tensor's bits, summed
        return [int(getattr(m, n).view(torch.int16).sum(dtype=torch.int64))
                for m in moes for n in ("gate_proj", "up_proj", "down_proj")]

    experts0 = expert_sums()
    rounds = []
    inner = api.train_one_round

    def recorded(r):
        rep = inner(r)
        rounds.append(rep)
        return rep

    api.train_one_round = recorded
    # --- the main path, with the launch counts read around exactly it ---
    fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
    t0 = time.perf_counter()
    api.train()
    train_wall_s = time.perf_counter() - t0
    launches = _flash_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = cfg.num_hidden_layers
    steps = args.client_num_per_round * args.local_steps_per_round * args.comm_round
    evals = len(api.test_history)
    # remat "full": each step's backward runs every block's forward again
    expected = {"flash_fwd": layers * (2 * steps + evals), "flash_bwd_dq": layers * steps,
                "flash_bwd_dkv": layers * steps}
    tokens_per_round = (args.client_num_per_round * args.local_steps_per_round
                        * args.per_device_batch_size * args.max_seq_length)
    for rep in rounds:
        print(f"  round {rep['round']}: {rep['round_sec']:.3f} s "
              f"({tokens_per_round / rep['round_sec']:.1f} tokens/s), train loss "
              f"{rep['train_loss']:.5f}, test loss {rep['test_loss']:.5f}", flush=True)
    routers_moved = [not torch.equal(m.router, r0) for m, r0 in zip(moes, routers0)]
    experts_frozen = expert_sums() == experts0
    trained = probe_loss()  # the global adapters: the last round's test loaded them

    # one train batch: the aux term in the remat path's loss, once
    xs, ys, _, _ = api.round_batch(0)
    x = torch.as_tensor(xs[0, 0], device=dev).long()
    y = torch.as_tensor(ys[0, 0], device=dev).long()
    m1 = torch.ones(x.shape[0], device=dev)
    train_loss = float(engine._loss_fn(model, x, y, m1)[0].detach())  # grad on: remat
    routes = []
    orig_route = tl.LlamaMoE.route
    captured = {}

    def route(mod, xg):
        out = orig_route(mod, xg)
        routes.append(out[2])
        captured.setdefault("xg", xg.detach())
        return out

    tl.LlamaMoE.route = route
    try:
        with torch.no_grad():
            _, auxes = model(x, return_aux=True)
            eval_loss = float(engine._eval_loss_fn(model, x, y, m1)[0])
    finally:
        tl.LlamaMoE.route = orig_route
    aux_term = cfg.moe_aux_weight * float(sum(auxes)) / len(auxes)
    aux_gap = abs((train_loss - eval_loss) - aux_term)
    # layer 0's routing on the CPU, on the same input and router
    xg0 = captured["xg"]
    cpu = types.SimpleNamespace(router=moes[0].router.detach().cpu(), cfg=cfg)
    idx_cpu = orig_route(cpu, xg0.cpu())[2]
    n_tokens = x.numel()
    real = torch.arange(xg0.shape[0] * xg0.shape[1]) < n_tokens
    differ = int(((idx_cpu != routes[0].cpu()).any(-1).reshape(-1) & real).sum())
    cap = moes[0].capacity(xg0.shape[1])
    loads = [moe_load(idx, cap, cfg.num_experts, n_tokens)
             for idx in routes[:layers]]
    dropped = sum(d for _, d in loads)
    print(f"  train(): {args.comm_round} rounds in {train_wall_s:.2f} s; peak memory "
          f"{peak_gb:.3f} GB; launches {launches} (expected {expected}); routers moved "
          f"{sum(routers_moved)} of {layers}, experts bit-frozen {experts_frozen}; round 0's "
          f"{len(probe)} training batches: loss {untrained:.5f} untrained -> {trained:.5f}",
          flush=True)
    print(f"  one batch: train loss {train_loss:.6f} (remat path) - eval loss {eval_loss:.6f} "
          f"= {train_loss - eval_loss:.6f} vs the weighted mean aux {aux_term:.6f} (gap "
          f"{aux_gap:.3g}); layer 0 routing on the CPU: {differ} of {n_tokens} tokens differ; "
          f"capacity {cap} a group; assignments dropped by capacity over {layers} layers: "
          f"{dropped} of {n_tokens * cfg.num_experts_per_tok * layers}; layer 0's per-expert "
          f"load {loads[0][0]}", flush=True)
    if launches != expected:
        raise RuntimeError(f"flash launches {launches} != expected {expected}")
    if not (all(math.isfinite(r["train_loss"]) and math.isfinite(r["test_loss"])
                for r in rounds) and trained < untrained):
        raise RuntimeError(f"q3's loss did not fall: {untrained} -> {trained}, {rounds}")
    if not (all(routers_moved) and experts_frozen):
        raise RuntimeError(f"routers moved {routers_moved}, experts frozen {experts_frozen}")
    if not (math.isfinite(aux_term) and aux_gap <= 1e-5):
        raise RuntimeError(f"the aux term is not counted once: {train_loss} - {eval_loss} "
                           f"vs {aux_term}")
    if differ > 0.001 * n_tokens:
        raise RuntimeError(f"{differ} of {n_tokens} tokens route otherwise on the CPU")
    del api, engine, model, moes
    return dict(layers=layers, launches=launches, expected_launches=expected, rounds=[
        {k: v for k, v in r.items() if isinstance(v, (int, float, str))} for r in rounds],
        probe_loss_untrained=untrained, probe_loss_trained=trained,
        train_wall_s=train_wall_s,
        steady_round_s=rounds[-1]["round_sec"],
        tokens_per_s=tokens_per_round / rounds[-1]["round_sec"], peak_gb=peak_gb,
        base_gb=base_gb, aux_term=aux_term, aux_gap=aux_gap, routing_differ=differ,
        capacity=cap, dropped=dropped, expert_load=[ld for ld, _ in loads], boot_s=boot_s)


def _spans(run_dir: str) -> list:
    with open(os.path.join(run_dir, "spans.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def untraced():
    """Make this process's next run the untraced twin of a traced one: the
    global tracer becomes a memory-only ``Tracer`` whose spans set no
    context, so no message carries a header or an envelope, and
    ``configure`` (so ``configure_from_args``) hands it back instead of
    binding a run dir. Pair it with ``sys_perf_profiling: false`` to turn
    the profiler's events off too. Returns the function that undoes it."""
    import contextlib

    from fedml_tpu_torch.telemetry import spans

    class UntracedTracer(spans.Tracer):
        @contextlib.contextmanager
        def span(self, name, **attrs):
            yield self.begin(name, **attrs)

    tracer, configure = UntracedTracer(), spans.configure
    spans._default_tracer = tracer
    spans.configure = lambda run_dir, service="": tracer

    def undo():
        spans.configure = configure
        spans.reset_tracer()

    return undo


def span_cost_us(n: int = R_SPAN_BENCH) -> float:
    """Host µs of one empty span (begin, end, buffer, the run-dir sink's
    flushes every 256 spans, the flight recorder's copy), over ``n``."""
    import shutil
    import tempfile

    from fedml_tpu_torch.telemetry import Tracer

    work = tempfile.mkdtemp(prefix="chip_smoke_spans_")
    try:
        tracer = Tracer(sink_dir=work, service="bench")
        t0 = time.perf_counter()
        for _ in range(n):
            with tracer.span("round/0/sample"):
                pass
        tracer.flush()
        return (time.perf_counter() - t0) * 1e6 / n
    finally:
        shutil.rmtree(work, ignore_errors=True)


def traced_sp_phase(card: str):
    """Phase (r1): phase h's sp round on R1_DATA, untraced and then traced
    into a fresh run dir (see the module doc)."""
    import shutil
    import tempfile

    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.resilience.durability.recover import digest
    from fedml_tpu_torch.simulation.simulator import create_simulator
    from fedml_tpu_torch.telemetry import build_report, reset_tracer

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_r1_")
    twin_dir = tempfile.mkdtemp(prefix="chip_smoke_r1_untraced_")
    dirs = [log_dir, twin_dir]  # handed to the report child's check once it starts
    cudnn_was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def one_round(traced: bool):
        args = load_arguments_from_dict({**SP_CONFIG, "data_args": R1_DATA})
        args.run_id, args.log_file_dir = "chip_smoke_r1", log_dir
        reset_tracer()
        undo = None
        switch = catalog_switch(traced)
        if not traced:
            args.log_file_dir, args.sys_perf_profiling = twin_dir, False
            undo = untraced()
        switch.__enter__()
        try:
            ds = load_federated(args)
            sim = create_simulator(args, "cuda", ds, create(args, ds.class_num))
            api, walls = sim.fl_trainer, []
            inner = api.train_one_round

            def timed(r):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rep = inner(r)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                return rep

            api.train_one_round = timed
            sim.run()
        finally:
            switch.__exit__(None, None, None)
            if undo is not None:
                undo()
        return walls[0], digest(api.global_params), len(ds.train_data_local_dict)

    try:
        untraced_s, untraced_digest, _ = one_round(False)
        if os.path.exists(os.path.join(twin_dir, "run_chip_smoke_r1", "spans.jsonl")):
            raise RuntimeError("the untraced twin of r1 wrote spans")
        wall, dig, n_clients = one_round(True)
        run_dir = os.path.join(log_dir, "run_chip_smoke_r1")
        _report_later("r1", run_dir, dirs)
        dirs = []
        report = build_report(run_dir)
        names = [s["name"] for s in _spans(run_dir) if "duration_ms" in s]
        want = [f"round/0/{p}" for p in ("sample", "train", "aggregate", "eval")]
        clients = [n for n in names if n.startswith("round/0/client/")]
        (row,) = report["rounds"]
        phases = {p: row["phases"].get(f"round/<n>/{p}", 0.0)
                  for p in ("sample", "train", "aggregate", "eval")}
        phase_sum = sum(phases.values())
        off = abs(row["wall_ms"] - wall * 1e3) / (wall * 1e3)
        cost = span_cost_us()
        print(f"  {card}: {R1_DATA['train_size']} images; the round untraced "
              f"{untraced_s:.3f} s, then traced {wall:.3f} s; the report's round wall "
              f"{row['wall_ms']:.1f} ms, {100 * off:.2f}% off the host-timed round (limit "
              f"{100 * R_WALL_TOL:.0f}%); the phase spans "
              + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
              + f" ms sum to {phase_sum:.1f} ms = {phase_sum / row['wall_ms']:.4f} of the "
              f"wall; {len(clients)} client spans; one empty span {cost:.2f} us "
              f"({R_SPAN_BENCH} spans); digest untraced {untraced_digest}, traced {dig}",
              flush=True)
        if not all(n in names for n in want) or sorted(clients) != sorted(
                f"round/0/client/{c}/train" for c in range(n_clients)):
            raise RuntimeError(f"spans.jsonl lacks the round's spans: {sorted(set(names))}")
        if off > R_WALL_TOL:
            raise RuntimeError(f"the report's round wall is {100 * off:.2f}% off the round")
        if dig != untraced_digest:
            raise RuntimeError(f"tracing changed the round's parameters: {dig} vs "
                               f"{untraced_digest}")
        return dict(traced_round_s=wall, untraced_round_s=untraced_s,
                    report_wall_ms=row["wall_ms"], wall_off=off, phase_ms=phases,
                    phase_sum_ms=phase_sum, span_us=cost, digest=dig,
                    untraced_digest=untraced_digest)
    finally:
        torch.backends.cudnn.deterministic = cudnn_was
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def traced_cross_silo_phase(card: str):
    """Phase (r2): phase i2's federation on R2_TRAIN images with the tracer
    on, one shared run dir, silo R2_HELD_RANK held after the round and sent
    SIGTERM, while its untraced twin runs beside it (see the module doc)."""
    import shutil
    import signal
    import tempfile
    import threading

    from fedml_tpu_torch.core.distributed.message import Message
    from fedml_tpu_torch.telemetry import TraceContext, build_report, wrap_frame_body
    from fedml_tpu_torch.utils.serialization import safe_dumps

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_r2_")
    twin_dir = tempfile.mkdtemp(prefix="chip_smoke_r2_untraced_")
    dirs = [log_dir, twin_dir]  # handed to the report child's check once it starts
    det = {"CHIP_SMOKE_DETERMINISTIC": "1"}
    twin = {}

    def run_twin():
        try:
            twin["kids"], twin["wall"], _ = _broker_federation(
                "chip_smoke_broker", CS_BROKER_SILOS, env={**det, "CHIP_SMOKE_UNTRACED": "1"},
                client_num_in_total=CS_BROKER_PARTS, train_size=R2_TRAIN,
                log_file_dir=twin_dir, sys_perf_profiling=False)
        except Exception as e:  # noqa: BLE001 - raised again in the phase's thread
            twin["error"] = e

    def term(proc):
        proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=60)

    beside = threading.Thread(target=run_twin, name="r2-untraced")
    beside.start()
    try:
        kids, wall, published = _broker_federation(
            "chip_smoke_broker", CS_BROKER_SILOS, hold=(R2_HELD_RANK, term), env=det,
            client_num_in_total=CS_BROKER_PARTS, train_size=R2_TRAIN,
            log_file_dir=log_dir)
        beside.join()
        if "error" in twin:
            raise RuntimeError(f"r2's untraced twin failed: {twin['error']}")
        if os.path.exists(os.path.join(twin_dir, "run_chip_smoke_broker", "spans.jsonl")):
            raise RuntimeError("r2's untraced twin wrote spans")
        twin_server = twin["kids"][0]
        run_dir = os.path.join(log_dir, "run_chip_smoke_broker")

        def stitched_in_text(text):
            if "cross-process stitched spans" not in text:
                raise RuntimeError("r2: the report's text lacks the cross-process stitched "
                                   "spans")

        _report_later("r2", run_dir, dirs, stitched_in_text)
        dirs = []
        report = build_report(run_dir)
        recs = _spans(run_dir)
        spans = [r for r in recs if "duration_ms" in r]
        services = sorted({r.get("service") for r in recs})
        server = {r["span_id"]: r for r in spans if r.get("service") == "rank0"}
        sync = next(r for r in server.values() if r["name"] == "round/0/sync")
        silo = [r for r in spans if r.get("service") != "rank0" and r["name"] == "comm/dispatch"]
        stitched_silo = sorted({s.get("service") for s in report["stitched_spans"]
                                if s.get("service") != "rank0"})
        with open(os.path.join(run_dir, "flight_recorder.jsonl")) as f:
            flight = [json.loads(line) for line in f if line.strip()]
        held = kids[R2_HELD_RANK]
        # the header rides every comm message; the envelope every raw publish
        # under a span (the federation's own broker client leaves it off)
        ctx = TraceContext(sync["trace_id"], sync["span_id"])
        probe = Message("MSG_TYPE_S2C_FINISH", 0, 1).get_params()  # a real header set
        header_b = (len(safe_dumps({**probe, "telemetry_ctx": ctx.to_dict()}))
                    - len(safe_dumps(probe)))
        envelope_b = len(wrap_frame_body(b"", ctx))
        sent = kids[0]["metrics"].get("comm/messages_sent{backend=broker}", 0)
        untraced_sent = twin_server["metrics"].get("comm/messages_sent{backend=broker}", 0)
        wire = kids[0]["metrics"].get("comm/wire_bytes_out", 0)
        untraced_wire = twin_server["metrics"].get("comm/wire_bytes_out", 0)
        print(f"  {card}: {R2_TRAIN} images; {CS_BROKER_SILOS + 1} processes in {wall:.1f} s "
              f"traced, the untraced twin's beside them in {twin['wall']:.1f} s; services "
              f"{services}; {len(silo)} silo-side dispatch spans under the server's trace "
              f"{sync['trace_id'][:8]}, the report's stitched spans "
              f"{len(report['stitched_spans'])} (silo side: {stitched_silo}); "
              f"the header {header_b} B a comm message, the envelope {envelope_b} B a raw "
              f"publish under a span; the server's wire bytes out {wire:.0f} over {sent:.0f} "
              f"messages traced against {untraced_wire:.0f} over {untraced_sent:.0f} "
              f"untraced; digest traced {kids[0]['digest']}, untraced "
              f"{twin_server['digest']}; the held silo exited {held['held_rc']} after "
              f"SIGTERM, the dump's reason {flight[0].get('reason')}, last record "
              f"{flight[-1].get('kind')} {flight[-1].get('signal')}", flush=True)
        if services != ["rank0", "rank1", "rank2"]:
            raise RuntimeError(f"the ranks' service stamps: {services}")
        if not silo or {r["service"] for r in silo} != {"rank1", "rank2"} or any(
                r["trace_id"] != sync["trace_id"] or r["parent_id"] not in server
                for r in silo):
            raise RuntimeError(f"silo-side handler spans off the server's trace: {silo}")
        if stitched_silo != ["rank1", "rank2"]:
            raise RuntimeError(f"the report's stitched spans: {stitched_silo}")
        if kids[0]["digest"] != twin_server["digest"]:
            raise RuntimeError(f"tracing changed the aggregate: {kids[0]['digest']} vs "
                               f"{twin_server['digest']}")
        if not (held["held_rc"] == -signal.SIGTERM and flight[0].get("reason") == "sigterm"
                and flight[0].get("pid") == held["pid"] and flight[-1].get("kind") == "signal"
                and flight[-1].get("signal") == "SIGTERM"):
            raise RuntimeError(f"the SIGTERMed silo's flight recorder: rc {held['held_rc']}, "
                               f"{flight[:1]} ... {flight[-1:]}: {held['held_stderr']}")
        return dict(wall_s=wall, services=services, silo_dispatch_spans=len(silo),
                    stitched=len(report["stitched_spans"]), header_bytes=header_b,
                    envelope_bytes=envelope_b, wire_bytes_out=wire, messages=sent,
                    untraced_wire_bytes_out=untraced_wire, untraced_messages=untraced_sent,
                    digest=kids[0]["digest"], held_rc=held["held_rc"],
                    untraced_wall_s=twin["wall"],
                    round_ms=(kids[0]["metrics"].get("cross_silo/round_ms") or {}).get("sum"))
    finally:
        beside.join()
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def traced_fedllm_phase(card: str, dev: str = "cuda"):
    """Phase (r3): FedLLMAPI's host loop at Llama-3-8B widths, R3_ARGS,
    with its round events into a fresh run dir and the flash launches
    counted around exactly the round (see the module doc)."""
    import shutil
    import tempfile
    import types

    import fedml_tpu_torch
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.telemetry import build_report
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_r3_")
    dirs = [log_dir]  # handed to the report child's check once it starts
    try:
        args = types.SimpleNamespace(**R3_ARGS, log_file_dir=log_dir)
        _reset_trust()
        fedml_tpu_torch.init(args)
        api = FedLLMAPI(args, dev, load_synthetic_lm(args))
        cfg, marks = api.cfg, {}
        test = api._maybe_test_and_checkpoint

        def marked_test(r, report):
            torch.cuda.synchronize()  # the round's bracket has closed by here
            marks["bracket_end"] = time.perf_counter()
            return test(r, report)

        api._maybe_test_and_checkpoint = marked_test
        torch.cuda.synchronize()
        fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
        t0 = time.perf_counter()
        out = api.train()
        launches = _flash_counts(fa)
        host_ms = (marks["bracket_end"] - t0) * 1e3
        layers = cfg.num_hidden_layers
        steps = args.client_num_per_round * (args.train_size // args.client_num_in_total)
        evals = len(api.test_history)
        expected = {"flash_fwd": layers * (steps + evals), "flash_bwd_dq": layers * steps,
                    "flash_bwd_dkv": layers * steps}
        run_dir = os.path.join(log_dir, f"run_{args.run_id}")
        with open(os.path.join(run_dir, "events.jsonl")) as f:
            events = [json.loads(line) for line in f if line.strip()]
        _report_later("r3", run_dir, dirs)
        dirs = []
        report = build_report(run_dir)
        (phase,) = [p for p in report["phases"] if p["phase"] == "event/round"]
        off = abs(phase["total_ms"] - host_ms) / host_ms
        print(f"  {card}: {layers} layers of {args.model_size}, {steps} local steps at "
              f"T={args.max_seq_length}; the round event {phase['total_ms']:.1f} ms against "
              f"{host_ms:.1f} ms host-timed ({100 * off:.2f}% off, limit "
              f"{100 * R_WALL_TOL:.0f}%); events {[e['name'] for e in events]}; test loss "
              f"{out['test_loss']:.5f}; launches {launches} (expected {expected})", flush=True)
        if [e["name"] for e in events] != ["event/round"] or events[0]["attrs"] != {
                "edge_id": 0} or not events[0]["ended"] > events[0]["started"]:
            raise RuntimeError(f"events.jsonl lacks the round's start and end: {events}")
        if off > R_WALL_TOL:
            raise RuntimeError(f"the report's round wall is {100 * off:.2f}% off the round")
        if launches != expected:
            raise RuntimeError(f"flash launches {launches} != expected {expected}")
        if not math.isfinite(out["test_loss"]):
            raise RuntimeError(f"non-finite test loss: {out}")
        del api
        _reset_trust()
        return dict(layers=layers, launches=launches, expected_launches=expected,
                    round_event_ms=phase["total_ms"], host_ms=host_ms, wall_off=off,
                    test_loss=out["test_loss"])
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


class catalog_switch:
    """The program catalog on (the default) or off (``FEDML_PROFILE=0``) for
    a block, with a fresh catalog and trace controller on entry and exit."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        from fedml_tpu_torch.telemetry.profiling import reset_catalog, reset_trace_controller

        self.was = os.environ.get("FEDML_PROFILE")
        if self.on:
            os.environ.pop("FEDML_PROFILE", None)
        else:
            os.environ["FEDML_PROFILE"] = "0"
        reset_catalog()
        reset_trace_controller()
        return self

    def __exit__(self, *exc):
        from fedml_tpu_torch.telemetry.profiling import reset_catalog, reset_trace_controller

        if self.was is None:
            os.environ.pop("FEDML_PROFILE", None)
        else:
            os.environ["FEDML_PROFILE"] = self.was
        reset_trace_controller()
        reset_catalog()
        return False


def _timed_stops(tc) -> list:
    """Seconds of each capture's stop and Chrome-trace export by ``tc``."""
    times, stop = [], tc._stop

    def timed(trace_dir):
        t0 = time.perf_counter()
        ok = stop(trace_dir)
        times.append(time.perf_counter() - t0)
        return ok

    tc._stop = timed
    return times


def trace_kernels(trace_dir: str) -> list:
    """Names of the device kernels in a capture's Chrome trace."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def _read_rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def catalog_call_us(n: int = S_NOOP_CALLS) -> tuple:
    """Host µs of one call of a cataloged no-op on a card tensor after its
    first call, and of the bare function, over ``n`` calls each."""
    from fedml_tpu_torch.telemetry.profiling import wrap_program

    x = torch.zeros(8, device="cuda")

    def noop(t):
        return t

    prog = wrap_program("chip_smoke/noop", noop)
    prog(x)
    out = []
    for fn in (prog, noop):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        out.append((time.perf_counter() - t0) / n * 1e6)
    return tuple(out)


def eval_flops(cfg, batch: int, t: int) -> float:
    """Model FLOPs of one evaluation forward: every projection, the
    adapters and the LM head (2 FLOPs per weight per token), and the
    attention kernel's products (4 per (query, key) pair and head dim)."""
    h, d, kv = cfg.hidden_size, cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    proj = 2 * h * h + 2 * h * kv + 3 * h * cfg.intermediate_size
    lora = cfg.lora_rank * (2 * (h + h) + 2 * (h + kv))
    tokens = batch * t
    per_layer = 2 * (proj + lora) * tokens + 4 * batch * cfg.num_attention_heads * d \
        * attention_pairs(t, t, True)
    return cfg.num_hidden_layers * per_layer + 2 * h * cfg.vocab_size * tokens


def profiled_fedllm_phase(card: str, dev: str = "cuda"):
    """Phase (s1): FedLLMAPI's fused round at S1_ARGS, profiled with round 1
    captured, against the same rounds with the catalog off (see the module
    doc)."""
    import shutil
    import tempfile
    import types

    import fedml_tpu_torch
    from fedml_tpu_torch import telemetry as tel
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.telemetry.profiling import get_trace_controller
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    work = tempfile.mkdtemp(prefix="chip_smoke_s1_")
    dirs = [work]  # handed to the report child's check once it starts

    def run(profiled: bool) -> dict:
        log_dir = os.path.join(work, "profiled" if profiled else "plain")
        args = types.SimpleNamespace(**S1_ARGS, log_file_dir=log_dir)
        if profiled:
            args.jax_trace_dir = os.path.join(log_dir, "round1_trace")
        with catalog_switch(profiled):
            tel.reset_tracer()
            _reset_trust()
            fedml_tpu_torch.init(args)
            api = FedLLMAPI(args, dev, load_synthetic_lm(args))
            tracer = tel.configure_from_args(args, service="s1")
            tc = get_trace_controller()
            stops = _timed_stops(tc)
            walls, marker, launches = [], None, None
            for r in range(int(args.comm_round)):
                if profiled and r == 1 and api.event.start_trace() is not True:
                    raise RuntimeError(f"s1: start_trace refused ({tc.unavailable})")
                torch.cuda.synchronize()
                fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
                t0 = time.perf_counter()
                with tracer.span(f"round/{r}/train"):
                    api.train_one_round(r)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if r == 1:
                    launches = _flash_counts(fa)
                    if profiled:
                        marker = api.event.stop_trace()
            api.event.flush()
            tel.flush_run()
            x_test = api.dataset.test_data_global[0]
            out = dict(walls=walls, marker=marker, launches=launches, stops=stops,
                       unavailable=tc.unavailable, budget=tc.byte_budget, cfg=api.cfg,
                       eval_batch=min(len(x_test), api.client.engine.batch_size * 8),
                       run_dir=os.path.join(log_dir, f"run_{args.run_id}"),
                       lora={k: v.detach().cpu().clone()
                             for k, v in api.global_exchange.items()},
                       losses=[(h.get("test_loss"), h.get("train_loss"))
                               for h in api.test_history])
            del api
            _reset_trust()
        gc.collect()
        torch.cuda.empty_cache()
        return out

    try:
        prof = run(True)
        plain = run(False)
        cfg, t = prof["cfg"], S1_ARGS["max_seq_length"]
        n_clients, steps = S1_ARGS["client_num_per_round"], S1_ARGS["local_steps_per_round"]
        step_flops = train_step_flops(cfg, S1_ARGS["per_device_batch_size"], t)
        rows = {r["name"]: r for r in _read_rows(os.path.join(prof["run_dir"],
                                                              "programs.jsonl"))}
        fused = rows["llm/fused_round"]
        want_fused = n_clients * steps * step_flops
        flops_off = abs(fused["flops"] - want_fused) / want_fused
        _report_later("s1", prof["run_dir"], dirs)
        dirs = []
        report = tel.build_report(prof["run_dir"])
        attr = report["attribution"]
        (phase,) = [p for p in attr["phases"] if p["phase"] == "round/<n>/train"]
        rounds = len(prof["walls"])
        script_flops = rounds * (want_fused + eval_flops(cfg, prof["eval_batch"], t))
        script_rate = script_flops / sum(prof["walls"])
        rate_off = abs(phase["achieved_flops_per_s"] - script_rate) / script_rate
        marker = prof["marker"]
        names = trace_kernels(marker["trace_dir"])
        traced = {k: sum(n in kname for kname in names) for k, n in S_KERNEL_NAMES.items()}
        layers = cfg.num_hidden_layers
        expected = {"flash_fwd": layers * (n_clients * steps + 1),
                    "flash_bwd_dq": layers * n_clients * steps,
                    "flash_bwd_dkv": layers * n_clients * steps}
        same = (prof["losses"] == plain["losses"] and set(prof["lora"]) == set(plain["lora"])
                and all(torch.equal(v, plain["lora"][k]) for k, v in prof["lora"].items()))
        noop_us, bare_us = catalog_call_us()
        print(f"  {card}: {layers} layers of {S1_ARGS['model_size']}, {n_clients} clients x "
              f"{steps} steps at T={t}, {rounds} rounds; rounds profiled "
              f"{', '.join(f'{w:.3f}' for w in prof['walls'])} s (round 1 captured), with "
              f"FEDML_PROFILE=0 {', '.join(f'{w:.3f}' for w in plain['walls'])} s; "
              f"llm/fused_round {fused['flops'] / 1e12:.3f} TFLOP counted against "
              f"{want_fused / 1e12:.3f} TFLOP ({100 * flops_off:.2f}% off, limit "
              f"{100 * S_FLOPS_TOL:.0f}%), first call {fused['compile_wall_ms']:.1f} ms, peak "
              f"{fused['peak_hbm_bytes'] / 1e9:.2f} GB; the report's round phase "
              f"{phase['achieved_flops_per_s'] / 1e12:.2f} TFLOP/s against the script's "
              f"{script_rate / 1e12:.2f} ({100 * rate_off:.2f}% off, limit "
              f"{100 * S_RATE_TOL:.0f}%), MFU {phase.get('mfu')} against "
              f"{attr['peak_flops_per_s']}; round 1's trace {marker['trace_bytes']} bytes "
              f"(budget {prof['budget']}), stop and export {prof['stops'][0]:.2f} s, "
              f"{len(names)} kernel events, flash {traced}, launches {prof['launches']} "
              f"(predicted {expected}); parameters profiled = plain: {same}; one cataloged "
              f"call {noop_us:.2f} us against {bare_us:.2f} us bare ({S_NOOP_CALLS} calls)",
              flush=True)
        faults = []
        if prof["unavailable"] or not marker or not marker["ok"]:
            faults.append(f"the capture failed: {prof['unavailable']} {marker}")
        elif not names:
            faults.append("round 1's CUDA capture holds no kernel events")
        if rows.get("llm/train_step", {}).get("calls"):
            faults.append(f"llm/train_step has calls of its own: {rows['llm/train_step']}")
        if fused["calls"] != rounds or flops_off > S_FLOPS_TOL:
            faults.append(f"llm/fused_round: {fused}")
        if phase.get("mfu") is None or rate_off > S_RATE_TOL:
            faults.append(f"the round phase's rate: {phase}")
        if traced != prof["launches"] or prof["launches"] != expected:
            faults.append(f"flash kernels in the trace {traced}, launches "
                          f"{prof['launches']}, predicted {expected}")
        if not marker or marker["trace_bytes"] >= prof["budget"]:
            faults.append(f"the capture is over its byte budget: {marker}")
        if not same:
            faults.append(f"profiling changed the rounds: {prof['losses']} vs "
                          f"{plain['losses']}")
        if faults:
            raise RuntimeError("s1: " + "; ".join(faults))
        return dict(layers=layers, walls=prof["walls"], plain_walls=plain["walls"],
                    fused_flops=fused["flops"], formula_flops=want_fused, flops_off=flops_off,
                    first_call_ms=fused["compile_wall_ms"], peak_gb=fused["peak_hbm_bytes"] / 1e9,
                    phase_flops_per_s=phase["achieved_flops_per_s"], script_flops_per_s=script_rate,
                    rate_off=rate_off, mfu=phase["mfu"], trace_bytes=marker["trace_bytes"],
                    stop_export_s=prof["stops"][0], kernel_events=len(names), traced=traced,
                    launches=prof["launches"], expected_launches=expected,
                    catalog_call_us=noop_us, bare_call_us=bare_us)
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def profiled_sp_phase(card: str, twin_digest=None, dev: str = "cuda"):
    """Phase (s2): phase r1's sp round with ``trace_rounds: "0"`` into a fresh
    run dir, against its unprofiled twin (see the module doc)."""
    import shutil
    import tempfile

    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.resilience.durability.recover import digest
    from fedml_tpu_torch.simulation.simulator import create_simulator
    from fedml_tpu_torch.telemetry import build_report, reset_tracer
    from fedml_tpu_torch.telemetry.profiling import get_trace_controller

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_s2_")
    dirs = [log_dir]  # handed to the report child's check once it starts
    cudnn_was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def one_round(profiled: bool):
        args = load_arguments_from_dict({**SP_CONFIG, "data_args": R1_DATA})
        args.run_id = "chip_smoke_s2" if profiled else "chip_smoke_s2_plain"
        args.log_file_dir = log_dir
        if profiled:
            args.trace_rounds = "0"
        reset_tracer()
        with catalog_switch(profiled):
            stops = _timed_stops(get_trace_controller())
            ds = load_federated(args)
            sim = create_simulator(args, dev, ds, create(args, ds.class_num))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tc = get_trace_controller()
            return dict(wall=wall, digest=digest(sim.fl_trainer.global_params),
                        captures=list(tc.captures), unavailable=tc.unavailable, stops=stops,
                        n_clients=len(ds.train_data_local_dict),
                        run_dir=os.path.join(log_dir, f"run_{args.run_id}"))

    try:
        prof = one_round(True)
        twin_wall = None
        if twin_digest is None:
            twin = one_round(False)
            twin_digest, twin_wall = twin["digest"], twin["wall"]
        run_dir, n = prof["run_dir"], prof["n_clients"]
        rows = {r["name"]: r for r in _read_rows(os.path.join(run_dir, "programs.jsonl"))}
        calls = {k: rows.get(k, {}).get("calls") for k in
                 ("sp/local_train", "compress/ef_encode", "sp/evaluate")}
        want_calls = {"sp/local_train": n, "compress/ef_encode": n, "sp/evaluate": 1}
        samples = [r for r in _read_rows(os.path.join(run_dir, "health.jsonl"))
                   if r.get("kind") == "mem_sample"]
        by_phase = {r["phase"]: r for r in samples}
        caps = prof["captures"]
        names = trace_kernels(caps[0]["trace_dir"]) if caps and caps[0]["ok"] else []
        _report_later("s2", run_dir, dirs)
        dirs = []
        report = build_report(run_dir)
        attr = report["attribution"]
        print(f"  {card}: {R1_DATA['train_size']} images, {n} clients; the profiled run "
              f"{prof['wall']:.3f} s with round 0 captured"
              + (f" (its FEDML_PROFILE=0 twin {twin_wall:.3f} s)" if twin_wall else
                 " (twin: r1's untraced leg)")
              + f"; programs {calls} (want {want_calls}); mem_sample phases "
              f"{[r['phase'] for r in samples]}, card bytes in use "
              f"{ {k: v['bytes_in_use'] for k, v in by_phase.items()} }; the trace "
              f"{caps[0]['trace_bytes'] if caps else None} bytes, stop and export "
              f"{prof['stops'][0] if prof['stops'] else float('nan'):.2f} s, "
              f"{len(names)} kernel events; the report's programs "
              f"{[p['name'] for p in attr.get('programs', [])]}; digest {prof['digest']}, "
              f"twin {twin_digest}", flush=True)
        faults = []
        if calls != want_calls:
            faults.append(f"programs.jsonl calls {calls} != {want_calls}")
        for ph in ("train", "aggregate", "eval"):
            r = by_phase.get(ph)
            if not r or not r["device_stats_available"] or not r["bytes_in_use"] > 0:
                faults.append(f"no mem_sample with card bytes for {ph}: {r}")
        if prof["unavailable"] or [(c["round"], c["rule"], c["ok"]) for c in caps] != [
                (0, "explicit", True)]:
            faults.append(f"the capture failed: {prof['unavailable']} {caps}")
        elif not names:
            faults.append("round 0's CUDA capture holds no kernel events")
        if not attr.get("programs"):
            faults.append("the report has no attribution section")
        if prof["digest"] != twin_digest:
            faults.append(f"profiling changed the round: {prof['digest']} vs {twin_digest}")
        if faults:
            raise RuntimeError("s2: " + "; ".join(faults))
        return dict(wall_s=prof["wall"], twin_wall_s=twin_wall, calls=calls,
                    trace_bytes=caps[0]["trace_bytes"], stop_export_s=prof["stops"][0],
                    kernel_events=len(names), digest=prof["digest"],
                    mem_bytes_in_use={k: v["bytes_in_use"] for k, v in by_phase.items()})
    finally:
        torch.backends.cudnn.deterministic = cudnn_was
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


class _CliChild:
    """``python -m fedml_tpu_torch.cli ARGV`` in a child process, started at
    once and left to run beside what follows; ``result()`` waits for it (it
    must exit 0) and gives its standard output and the child's own seconds."""

    def __init__(self, argv):
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ,
                   PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.argv, self.out = list(argv), {}
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "fedml_tpu_torch.cli", *self.argv],
                                cwd=here, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

        def wait():
            try:
                self.out["stdout"], self.out["stderr"] = proc.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                proc.kill()
                self.out["stdout"], self.out["stderr"] = proc.communicate()
            self.out["rc"], self.out["s"] = proc.returncode, time.perf_counter() - t0

        self.thread = threading.Thread(target=wait, daemon=True)
        self.thread.start()

    def result(self) -> tuple:
        self.thread.join()
        if self.out["rc"]:
            raise RuntimeError(f"{' '.join(self.argv)} exited {self.out['rc']}:\n"
                               f"{self.out['stdout'][-2000:]}{self.out['stderr'][-2000:]}")
        return self.out["stdout"], self.out["s"]


class _DoctorChild(_CliChild):
    """``telemetry doctor --json RUN_DIR`` in a child process; ``result()``
    gives the triage and the child's seconds."""

    def __init__(self, run_dir: str):
        super().__init__(("telemetry", "doctor", "--json", run_dir))

    def result(self) -> tuple:
        text, s = super().result()
        return json.loads(text), s


# checks that wait for a child process (a leg's ``telemetry report``), each
# run after the last phase, by leg; ``_report_later`` fills it
_LATER: dict = {}


def _report_later(leg: str, run_dir: str, dirs, check=None) -> None:
    """``telemetry report RUN_DIR`` in a child process beside the next legs:
    after the last phase it must have exited 0 and ``check(text)`` holds;
    then ``dirs`` (the leg's, which hold the run dir) go, pass or fail."""
    import shutil

    child = _CliChild(("telemetry", "report", run_dir))

    def finish():
        try:
            text, s = child.result()
            if check is not None:
                check(text)
            return dict(report_lines=len(text.splitlines()), report_child_s=s)
        finally:
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)

    _LATER[leg] = finish


class _Beside:
    """A phase whose work runs in child processes, started in a thread so
    that the next phases run beside it (its lines print as it goes);
    ``result()`` waits for it, prints its seconds and raises what it
    raised."""

    def __init__(self, name: str, fn, phase_s: dict):
        self.name, self.phase_s, self.box = name, phase_s, {}
        t0 = time.perf_counter()

        def run():
            try:
                self.box["out"] = fn()
            except BaseException as e:  # noqa: BLE001 - raised again by result()
                self.box["error"] = e
            self.box["s"] = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, name=f"phase-{name}")
        self.thread.start()

    def result(self, beside: str):
        self.thread.join()
        self.phase_s[self.name] = self.box["s"]
        print(f"    phase {self.name}: {self.box['s']:.1f} s (beside {beside})", flush=True)
        if "error" in self.box:
            raise self.box["error"]
        return self.box["out"]


class _TimedTracker:
    """Host µs of each ``observe`` and ``finish_round`` of a health tracker."""

    def __init__(self, tracker):
        self.observe_us, self.finish_us = [], []
        for name, sink in (("observe", self.observe_us), ("finish_round", self.finish_us)):
            setattr(tracker, name, self._timed(getattr(tracker, name), sink))

    @staticmethod
    def _timed(fn, sink):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sink.append((time.perf_counter() - t0) * 1e6)
            return out

        return timed


def _fresh_telemetry() -> None:
    """A fresh registry, tracer and flight recorder, so a leg's run dir holds
    its own records alone (the catalog is ``catalog_switch``'s)."""
    from fedml_tpu_torch.telemetry import reset_flight_recorder, reset_registry, reset_tracer

    reset_registry()
    reset_tracer()
    reset_flight_recorder()


def _health_records(run_dir: str, kind: str) -> list:
    return [r for r in _read_rows(os.path.join(run_dir, "health.jsonl")) if r.get("kind") == kind]


def _deferred(log_dir: str, gate):
    """The rest of a leg once its doctor child is done: ``gate()`` checks and
    prints, then the leg's log dir goes, pass or fail."""
    import shutil

    def finish():
        try:
            return gate()
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)

    return finish


def _run_gates(gates: dict) -> dict:
    """Every leg's checks (each waits for its child process, so none is left
    running), then the first failure, if any."""
    out, errors = {}, []
    for leg, gate in gates.items():
        try:
            out[leg] = gate()
        except Exception as e:  # noqa: BLE001 - raised below, after the others
            errors.append(e)
    if errors:
        raise errors[0]
    return out


def health_sp_phase(card: str, dev: str = "cuda"):
    """Phase (t1): the sp simulation with a slowed and a noisy client, triaged
    by the doctor (see the module doc). Returns the function that waits for
    the doctor and checks."""
    import shutil
    import tempfile

    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.compression import CompressedTree
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.sp import fedavg_api
    from fedml_tpu_torch.telemetry import build_doctor, build_report

    class FaultyTrainer(ClassificationTrainer):
        """Client T_SLOW sleeps after its training; client T_NOISY uploads
        T_NOISY_SCALE x its delta."""

        def train(self, params, train_data, device, args):
            new, metrics = super().train(params, train_data, device, args)
            if self.id == T_SLOW:
                time.sleep(T_SLOW_S)
            if self.id == T_NOISY:
                new = {k: p + T_NOISY_SCALE * (new[k] - p) if p.is_floating_point() else new[k]
                       for k, p in params.items()}
            return new, metrics

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_t1_")
    norm_inputs = []
    inner_norm = fedavg_api.update_norm

    def recorded_norm(update, base=None):
        norm_inputs.append(type(update).__name__ if not isinstance(update, CompressedTree)
                           else update.codec)
        return inner_norm(update, base)

    try:
        args = load_arguments_from_dict({**SP_CONFIG, "data_args": T1_DATA, "train_args": {
            **SP_CONFIG["train_args"], **T1_TRAIN}})
        args.run_id, args.log_file_dir = "chip_smoke_t1", log_dir
        _fresh_telemetry()
        ds = load_federated(args)
        model = create(args, ds.class_num)
        api = fedavg_api.FedAvgAPI(args, dev, ds, model,
                                   client_trainer=FaultyTrainer(model, args))
        timed = _TimedTracker(api._health)
        fedavg_api.update_norm = recorded_norm
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            fedavg_api.update_norm = inner_norm
        run_dir = os.path.join(log_dir, "run_chip_smoke_t1")
        child = _DoctorChild(run_dir)
        t0 = time.perf_counter()
        build_doctor(run_dir)
        doctor_s = time.perf_counter() - t0
        report = build_report(run_dir)
    except BaseException:
        shutil.rmtree(log_dir, ignore_errors=True)
        raise

    def gate():
        doctor, child_s = child.result()
        ch = _health_records(run_dir, "client_health")
        mem = {r["round"]: r for r in _health_records(run_dir, "mem_sample")
               if r.get("phase") == "train"}
        n = int(T1_TRAIN["client_num_in_total"])
        honest = [r["latency_ms"] for r in ch if r["client"] not in (T_SLOW, T_NOISY)]
        med_ms = float(np.median(honest)) if honest else float("nan")
        later = [r["latency_ms"] for r in ch if r["client"] not in (T_SLOW, T_NOISY)
                 and r["round"] > 0]
        scores = {r["client"]: (r["straggler_score"], r["anomaly_score"])
                  for r in doctor["stragglers"] + doctor["anomalies"]}
        flagged = {k: [r["client"] for r in doctor[k]] for k in ("stragglers", "anomalies")}
        print(f"  {card}: t1 {len(ch)} client_health records in {wall:.3f} s (5 rounds); the "
              f"median honest client wall {med_ms:.1f} ms (rounds 1-4: "
              f"{float(np.median(later)) if later else float('nan'):.1f} ms), client "
              f"{T_SLOW} slowed by {T_SLOW_S * 1e3:.0f} ms; doctor stragglers "
              f"{flagged['stragglers']}, anomalies {flagged['anomalies']}, scores (straggler, "
              f"anomaly) {scores}; update norms off {sorted(set(norm_inputs))}; the tracker "
              f"{np.median(timed.observe_us):.1f} us an observe (median of "
              f"{len(timed.observe_us)}), {np.median(timed.finish_us):.1f} us a finish_round "
              f"(max {max(timed.finish_us):.1f}); the doctor {child_s:.2f} s in a child "
              f"process, {doctor_s * 1e3:.1f} ms in process; train mem_sample bytes "
              f"{ {r: m.get('bytes_in_use') for r, m in sorted(mem.items())} }", flush=True)
        for v in doctor["verdict"]:
            print(f"  {card}: t1 verdict: {v}", flush=True)
        faults = []
        pairs = sorted((r["round"], r["client"]) for r in ch)
        if pairs != [(r, c) for r in range(int(T1_TRAIN["comm_round"])) for c in range(n)]:
            faults.append(f"client_health pairs {pairs}")
        if not all(r["update_norm"] is not None and math.isfinite(r["update_norm"]) for r in ch):
            faults.append(f"a non-finite or missing update norm: "
                          f"{[(r['round'], r['client'], r['update_norm']) for r in ch]}")
        if set(norm_inputs) != {"int8"}:
            faults.append(f"update norms were not read off int8 blocks: {set(norm_inputs)}")
        if flagged != {"stragglers": [str(T_SLOW)], "anomalies": [str(T_NOISY)]}:
            faults.append(f"the doctor flagged {flagged}")
        verdict = "\n".join(doctor["verdict"])
        if (f"client {T_SLOW} is a straggler" not in verdict
                or f"client {T_NOISY} sends anomalous updates" not in verdict):
            faults.append("the verdict does not name both clients")
        if sorted(mem) != list(range(int(T1_TRAIN["comm_round"]))) or not all(
                (m.get("bytes_in_use") or 0) > 0 for m in mem.values()):
            faults.append(f"train mem_sample rounds {sorted(mem)} without card bytes")
        if sorted(report["client_health"]) != [str(c) for c in range(n)]:
            faults.append(f"the report's client health lists {sorted(report['client_health'])}")
        if faults:
            raise RuntimeError("t1: " + "; ".join(faults))
        return dict(wall_s=wall, median_client_ms=med_ms, scores=scores, flagged=flagged,
                    observe_us=float(np.median(timed.observe_us)),
                    finish_round_us=float(np.median(timed.finish_us)),
                    doctor_child_s=child_s, doctor_s=doctor_s, verdict=doctor["verdict"])

    return _deferred(log_dir, gate)


def health_secagg_phase(card: str):
    """Phase (t2): phase k1's masked federation on a quarter of its images,
    triaged by the doctor (see the module doc). Returns the function that
    waits for the doctor and checks."""
    import shutil
    import tempfile

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.telemetry import get_flight_recorder, get_registry

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_t2_")
    _reset_trust()
    try:
        cfg = {**SECAGG_CONFIG,
               "common_args": {**SECAGG_CONFIG["common_args"], "run_id": "chip_smoke_t2",
                               "log_file_dir": log_dir},
               "train_args": {**SECAGG_CONFIG["train_args"], "client_num_in_total": T2_PARTS,
                              "round_deadline_multiplier": T2_DEADLINE_MULTIPLIER}}
        args = fedml_tpu_torch.init(load_arguments_from_dict(cfg))
        ds = load_federated(args)
        model = create(args, ds.class_num)
        LocalBroker.destroy(args.run_id)
        _fresh_telemetry()  # the ring holds this leg's records alone
        server, clients = build_cross_silo_inproc(args, ds, model, "cuda")
        smgr = server.manager
        for c in clients:
            mgr = c.manager
            if mgr.rank != SECAGG_STALL_RANK:
                continue
            trainer = mgr.trainer_dist_adapter.trainer
            train = trainer.run_local_training

            def stalled(params, *a, mgr=mgr, train=train, **kw):
                if mgr.round_idx != 1:
                    return train(params, *a, **kw)
                end = time.monotonic() + 900
                while smgr.result is None and smgr.handler_error is None:
                    if time.monotonic() > end:
                        raise TimeoutError("t2: round 1 never closed at quorum")
                    time.sleep(0.05)
                return {k: v.clone() for k, v in params.items()}, {}

            trainer.run_local_training = stalled
        t0 = time.perf_counter()
        result = run_managers_to_completion([smgr] + [c.manager for c in clients], args.run_id,
                                            MyMessage.MSG_TYPE_CONNECTION_IS_READY, timeout=900)
        wall = time.perf_counter() - t0
        run_dir = os.path.join(log_dir, "run_chip_smoke_t2")
        child = _DoctorChild(run_dir)
        markers = [r for r in get_flight_recorder().snapshot() if r.get("kind") == "secagg_phase"]
        names = {m["name"] for m in get_registry().snapshot()}
    except BaseException:
        shutil.rmtree(log_dir, ignore_errors=True)
        raise
    finally:
        _reset_trust()

    def gate():
        doctor, child_s = child.result()
        ch = _health_records(run_dir, "client_health")
        events = {e["event"]: e for e in doctor["secagg"]["events"]}
        print(f"  {card}: t2 {args.client_num_in_total} parts, {wall:.3f} s, result "
              f"{ {k: result.get(k) for k in ('rounds', 'test_loss')} if result else result}; "
              f"doctor secagg counters {doctor['secagg']['counters']}, events "
              f"{[(e['event'], e.get('round'), e.get('evicted')) for e in doctor['secagg']['events']]}; "
              f"evicted {doctor['connectivity']['evicted_clients']}; markers "
              f"{[(m['phase'], m['round']) for m in markers]}; {len(ch)} client_health "
              f"records, latency ms {[r['latency_ms'] for r in ch]}; the doctor {child_s:.2f} s "
              f"in a child process", flush=True)
        faults = []
        if not (result and result.get("rounds") == 2):
            faults.append(f"the federation did not run 2 rounds: {result}")
        for ev in ("recovery_started", "recovery_closed"):
            e = events.get(ev)
            if not (e and e.get("round") == 1 and e.get("evicted") == [SECAGG_STALL_RANK]):
                faults.append(f"no {ev} of round 1 evicting [{SECAGG_STALL_RANK}]: {e}")
        if not any(v.startswith("secagg round 1 closed via mask recovery")
                   for v in doctor["verdict"]):
            faults.append(f"the verdict names no recovery: {doctor['verdict']}")
        if not any(e.get("event") == "evicted" and e.get("client") == SECAGG_STALL_RANK
                   for e in doctor["connectivity"]["events"]):
            faults.append("the connectivity section holds no eviction")
        if ({"collect", "recover", "unmask"} - {m["phase"] for m in markers}
                or any(m.get("individual_plaintext") is not False for m in markers)):
            faults.append(f"the ring's secagg markers: {markers}")
        if not ch or not all(r["update_norm"] is None and r["latency_ms"] is not None
                             for r in ch):
            faults.append(f"masked uploads' health records: {ch}")
        if "secagg/phases" in names or "phases" in doctor["secagg"]["counters"]:
            faults.append("a secagg/phases counter exists")
        if faults:
            raise RuntimeError("t2: " + "; ".join(faults))
        return dict(wall_s=wall, counters=doctor["secagg"]["counters"],
                    markers=[(m["phase"], m["round"]) for m in markers],
                    latency_ms=[r["latency_ms"] for r in ch], doctor_child_s=child_s)

    return _deferred(log_dir, gate)


def health_tree_phase(card: str, dev: str = "cuda"):
    """Phase (t3): the ResNet-18-wide tree with leaf kills, triaged by the
    doctor (see the module doc). Returns the function that waits for the
    doctor and checks."""
    import shutil
    import tempfile

    from fedml_tpu_torch.hierarchy import KillWindow, TreeRunner, TreeTopology
    from fedml_tpu_torch.telemetry import configure, flush_run, reset_tracer

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_t3_")
    try:
        topo = TreeTopology.build(T3["clients"], tiers=T3["tiers"])
        if topo.levels != T3_LEVELS:
            raise RuntimeError(f"t3: levels {topo.levels}, expected {T3_LEVELS}")
        run_dir = os.path.join(log_dir, "run_chip_smoke_t3")
        _fresh_telemetry()
        configure(run_dir, service="tree")
        runner = TreeRunner(topo, template=resnet_wire_template(dev), codec="int8",
                            seed=T3["seed"], quorum=T3["quorum"], chunk=T3["chunk"],
                            chaos=[KillWindow(*k) for k in T3_KILLS], device=dev)
        with _Counted(_tree_counters(topo.n_tiers)) as counted:
            out = runner.run(T3["rounds"])
        flush_run()
        reset_tracer()
        child = _DoctorChild(run_dir)
    except BaseException:
        shutil.rmtree(log_dir, ignore_errors=True)
        raise

    def gate():
        doctor, child_s = child.result()
        ch = _health_records(run_dir, "client_health")
        ev = [e for e in _health_records(run_dir, "resilience_event")
              if e.get("tier") is not None]
        n_edges = topo.levels[topo.leaf_tier - 1]
        from_records = {}
        for e in ev:
            key = f"tier/{e['tier']}/{e['event']}"
            from_records[key] = from_records.get(key, 0) + len(
                e.get("clients") or e.get("nodes") or [e.get("node")])
        counted_ev = {k: v for k, v in counted.delta.items()
                      if k.split("/")[-1] in ("evicted", "rejoined") and v}
        flagged = {k: [(r["client"], round(r["straggler_score"], 2),
                        round(r["anomaly_score"], 2)) for r in doctor[k]]
                   for k in ("stragglers", "anomalies")}
        lat = [r["latency_ms"] for r in ch]
        print(f"  {card}: t3 levels {topo.levels}, {T3['rounds']} rounds in "
              f"{out['wall_s']:.3f} s; {len(ch)} client_health records (edges x rounds "
              f"{n_edges} x {T3['rounds']}), edge reduce {np.median(lat):.1f} ms median "
              f"({min(lat):.1f}-{max(lat):.1f}); tier events {from_records} against "
              f"counters {counted_ev}; flagged edges {flagged} (not gated); the doctor "
              f"{child_s:.2f} s in a child process", flush=True)
        for v in doctor["verdict"]:
            print(f"  {card}: t3 verdict: {v}", flush=True)
        faults = []
        pairs = sorted((r["round"], r["client"]) for r in ch)
        if pairs != [(r, e) for r in range(T3["rounds"]) for e in range(n_edges)]:
            faults.append(f"client_health pairs {pairs}")
        if {k: v for k, v in from_records.items()
                if k.split("/")[-1] in ("evicted", "rejoined")} != counted_ev:
            faults.append(f"tier events {from_records} against counters {counted_ev}")
        leaf = topo.leaf_tier
        killed = sorted(k[1] for k in T3_KILLS)
        listed = sorted(c for e in doctor["tiers"]["events"]
                        if e.get("event") == "evicted" and e.get("tier") == leaf
                        and e.get("round") == 1 for c in e.get("clients") or [])
        if listed != killed:
            faults.append(f"the tiers section lists evictions {listed}, not {killed}")
        if not counted_ev.get(f"tier/{leaf}/evicted") == len(killed):
            faults.append(f"tier/{leaf}/evicted {counted_ev}")
        if faults:
            raise RuntimeError("t3: " + "; ".join(faults))
        return dict(wall_s=out["wall_s"], edge_reduce_ms=lat, tier_events=from_records,
                    flagged=flagged, doctor_child_s=child_s)

    return _deferred(log_dir, gate)


# what each process of phase (u1) and of its twin runs: CS_CHILD's entry
# points under cuDNN's deterministic algorithms, with a silo's sleeps after
# its local training (CHIP_SMOKE_U_SLEEPS: by rank, the seconds of each
# round), a silo's run dir of its own (under CHIP_SMOKE_U_SILO_LOGS), the
# server plane's URL written to CHIP_SMOKE_U_URL once it serves, every
# MetricStreamer.pop_frame timed, and after the run the server's collector
# against its registry, a replayed final frame, and its captures
U_CHILD = r"""
import json, os, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
import fedml_tpu_torch
from chip_smoke import _registry_flat, _timed_stops, live_totals
from fedml_tpu_torch import runner as runner_mod
from fedml_tpu_torch.ml.trainer import classification_trainer as ct
from fedml_tpu_torch.resilience.durability.recover import digest
from fedml_tpu_torch.telemetry import get_registry, get_trace_controller
from fedml_tpu_torch.telemetry import live as live_mod
t0 = time.perf_counter()
role = sys.argv[1]
rank = int(sys.argv[sys.argv.index("--rank") + 1])
built, planes, pops = {}, [], []
build = runner_mod.FedMLRunner.__init__
def recording_build(self, args, *a, **kw):
    if role == "client" and os.environ.get("CHIP_SMOKE_U_SILO_LOGS"):
        args.log_file_dir = os.path.join(os.environ["CHIP_SMOKE_U_SILO_LOGS"], f"rank{rank}")
    build(self, args, *a, **kw)
    built["runner"] = self.runner
runner_mod.FedMLRunner.__init__ = recording_build
sleeps = json.loads(os.environ.get("CHIP_SMOKE_U_SLEEPS", "{}")).get(str(rank), [])
train = ct.ClassificationTrainer.train
def slowed(self, *a, **kw):
    out = train(self, *a, **kw)
    if self._round_seed < len(sleeps) and sleeps[self._round_seed]:
        torch.cuda.synchronize()
        time.sleep(sleeps[self._round_seed])
    return out
ct.ClassificationTrainer.train = slowed
plane_init = live_mod.LivePlane.__init__
def recording_plane(self, *a, **kw):
    plane_init(self, *a, **kw)
    planes.append(self)
    url_file = os.environ.get("CHIP_SMOKE_U_URL")
    if self.url and url_file:
        with open(url_file + ".tmp", "w") as f:
            f.write(self.url)
        os.replace(url_file + ".tmp", url_file)
live_mod.LivePlane.__init__ = recording_plane
pop = live_mod.MetricStreamer.pop_frame
def timed_pop(self, force=False):
    t = time.perf_counter()
    frame = pop(self, force)
    pops.append([(time.perf_counter() - t) * 1e6, force, frame is not None])
    return frame
live_mod.MetricStreamer.pop_frame = timed_pop
tc = get_trace_controller()
stops, starts, start = _timed_stops(tc), [], tc._start
def timed_start(trace_dir):
    t = time.perf_counter()
    ok = start(trace_dir)
    starts.append(time.perf_counter() - t)
    return ok
tc._start = timed_start
fn = {"server": fedml_tpu_torch.run_cross_silo_server,
      "client": fedml_tpu_torch.run_cross_silo_client}[role]
result = fn()
ended = time.time()
torch.cuda.synchronize()
record = {"role": role, "result": result, "wall_s": time.perf_counter() - t0,
          "ended": ended, "metrics": _registry_flat(get_registry()), "pops": pops}
if role == "server":
    record["digest"] = digest(built["runner"].fedml_aggregator.get_global_model_params())
    record["captures"] = get_trace_controller().captures
    record["stop_s"] = stops
    record["start_s"] = starts
    if planes:
        col = planes[0].collector
        record["collector"] = live_totals(col.registry, node="rank0")
        record["registry"] = live_totals(get_registry())
        record["nodes"] = col.nodes()
        replay = {"v": 1, "node": "rank0", "job": col.job, "seq": record["nodes"]["rank0"]["seq"],
                  "ts": time.time(), "full": True, "metrics": []}
        record["replay_applied"] = col.ingest(replay)
        record["collector_after_replay"] = live_totals(col.registry, node="rank0")
print("CHILD " + json.dumps(record, default=str), flush=True)
"""


def live_totals(registry, node=None, prefix: str = "") -> dict:
    """A registry's instruments as ``{name[labels]: value}`` (a histogram's
    ``[count, sum]``), sums rounded to 6 places as the reference's
    acceptance compares them, without the live plane's own ``live/*``;
    with ``node``, a collector's entries of that node, its node and job
    labels dropped; with ``prefix``, only the names under it."""
    out = {}
    for rec in registry.snapshot():
        labels = dict(rec.get("labels") or {})
        if node is not None:
            if labels.pop("node", None) != node:
                continue
            labels.pop("job", None)
        name = rec["name"]
        if name.startswith("live/") or not name.startswith(prefix):
            continue
        out[name + json.dumps(sorted(labels.items()))] = (
            [rec["count"], round(rec["sum"], 6)] if rec["kind"] == "histogram"
            else round(rec["value"], 6))
    return out


def _prom_value(text: str, metric: str, label: str):
    """The value of ``metric``'s first sample carrying ``label`` in a
    Prometheus text, or None."""
    for line in text.splitlines():
        if line.startswith(metric + "{") and label in line:
            return float(line.rsplit(" ", 1)[1])
    return None


def _u_federation(log_dir: str, live: bool, url_file=None):
    """Phase u1's federation (or, with ``live`` off, its twin: no plane, no
    sleeps) over its own broker; each silo's run dir under ``log_dir``."""
    env = {"CHIP_SMOKE_U_SILO_LOGS": os.path.join(log_dir, "silos")}
    train = dict(U_TRAIN, log_file_dir=log_dir)
    if live:
        env["CHIP_SMOKE_U_SLEEPS"] = json.dumps({
            str(U_SLOW): [U_SLOW_S if r in U_SLOW_ROUNDS else 0.0 for r in range(U_ROUNDS)],
            "1": [U_BASE_S] * U_ROUNDS})
        env["CHIP_SMOKE_U_URL"] = url_file
        train.update(live_telemetry=True, metrics_port=0, trace_streaming=True)
    kids, wall, _ = _broker_federation("chip_smoke_u1", U_SILOS, env=env, child=U_CHILD,
                                       **train)
    if kids[0]["result"].get("rounds") != U_ROUNDS:
        raise RuntimeError(f"u1{'' if live else ' twin'}: the server ran "
                           f"{kids[0]['result']}")
    return kids, wall


def live_broker_phase(card: str):
    """Phase (u1): the live plane and causal tracing over the broker (see the
    module doc). Returns the leg's numbers and the readers' gate (u3)."""
    import shutil
    import tempfile

    from fedml_tpu_torch.telemetry.tracing import assemble_trace, compute_critical_paths

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_u1_")
    try:
        url_file = os.path.join(log_dir, "plane_url")
        box = {}

        def run():
            try:
                box["kids"], box["wall"] = _u_federation(log_dir, True, url_file)
            except Exception as e:  # noqa: BLE001 - raised again below
                box["error"] = e

        fed = threading.Thread(target=run, name="u1")
        fed.start()
        scrape, scrape_ms = None, []
        while fed.is_alive():
            if scrape is None and os.path.exists(url_file):
                with open(url_file) as f:
                    url = f.read()
                try:
                    t0 = time.perf_counter()
                    with urllib.request.urlopen(url + "/metrics", timeout=5) as resp:
                        text = resp.read().decode()
                    scrape_ms.append((time.perf_counter() - t0) * 1e3)
                    scored = _prom_value(text, "health_rounds_scored", 'node="rank0"')
                    if (scored is not None and scored < U_ROUNDS and 'job="chip_smoke_u1"' in text
                            and all(f'node="rank{r}"' in text for r in range(U_SILOS + 1))):
                        scrape = dict(rounds_scored=scored, lines=len(text.splitlines()))
                except OSError:
                    pass
            time.sleep(0.1)
        fed.join()
        if "error" in box:
            raise box["error"]
        kids, wall = box["kids"], box["wall"]
        server = kids[0]
        run_dir = os.path.join(log_dir, "run_chip_smoke_u1")
        alerts = [r for r in _read_rows(os.path.join(run_dir, "telemetry.jsonl"))
                  if r.get("kind") == "doctor_alert"]
        stragglers = [(a.get("client"), a.get("round"), a.get("ts") < server["ended"],
                       a.get("score")) for a in alerts if a.get("rule") == "straggler"]
        caps = server["captures"]
        kernels = trace_kernels(caps[0]["trace_dir"]) if caps and caps[0].get("ok") else []
        remote = _read_rows(os.path.join(run_dir, "spans_remote.jsonl"))
        remote_nodes = sorted({r.get("node") for r in remote})
        trace = assemble_trace(run_dir)
        clocks = {n: trace.clocks[n].to_dict() for n in sorted(trace.clocks)}
        cps = {cp.round: cp.to_dict() for cp in compute_critical_paths(trace)}
        latency = {}  # (client): [ms a round], broadcast to upload on the server's clock
        for rec in sorted(_health_records(run_dir, "client_health"),
                          key=lambda e: (e["round"], str(e["client"]))):
            latency.setdefault(str(rec["client"]), []).append(rec.get("latency_ms"))
        hot = [us for k in kids[1:] for us, force, _ in k["pops"] if not force]
        frame_bytes = [k["metrics"].get("live/frame_bytes", {}) for k in kids[1:]]
        fb_mean = (sum(h.get("sum", 0) for h in frame_bytes)
                   / max(1, sum(h.get("count", 0) for h in frame_bytes)))
        piggy = [k["metrics"].get("live/frames_piggybacked", 0) for k in kids[1:]]
        print(f"  {card}: u1 {U_SILOS + 1} processes in {wall:.1f} s; the scrape before round "
              f"{U_ROUNDS - 1} closed: {scrape}, {len(scrape_ms)} scrape(s), "
              f"{np.median(scrape_ms) if scrape_ms else float('nan'):.2f} ms median "
              f"({min(scrape_ms, default=float('nan')):.2f}-"
              f"{max(scrape_ms, default=float('nan')):.2f})", flush=True)
        print(f"  {card}: u1 a silo's frame pop on the send path "
              f"{np.median(hot) if hot else float('nan'):.1f} us median over {len(hot)} pops "
              f"({np.percentile(hot, 90) if hot else float('nan'):.1f} us p90); "
              f"{fb_mean:.0f} B a frame; frames piggybacked by silo {piggy}; each "
              f"silo's latency a round (ms) {latency}", flush=True)
        print(f"  {card}: u1 straggler alerts (client, round, before the run ended, score) "
              f"{stragglers}; all alerts {[(a['rule'], a.get('round')) for a in alerts]}; "
              f"captures {[(c['round'], c['rule'], c['ok'], c.get('trace_bytes')) for c in caps]}"
              f" with {len(kernels)} kernel events, start "
              f"{[round(x, 3) for x in server['start_s']]} s, stop and export "
              f"{[round(x, 3) for x in server['stop_s']]} s", flush=True)
        print(f"  {card}: u1 collector == registry for rank0: "
              f"{server.get('collector') == server.get('registry')} "
              f"({len(server.get('registry') or {})} instruments); replayed final frame "
              f"applied {server.get('replay_applied')}; nodes {server.get('nodes')}", flush=True)
        print(f"  {card}: u1 spans_remote nodes {remote_nodes} ({len(remote)} records); clocks "
              + "; ".join(f"{n} {c['method']} {c['offset_ms']} ms ±{c['uncertainty_ms']} "
                          f"({c['pairs']} pairs)" for n, c in clocks.items()), flush=True)
        for r, d in sorted(cps.items()):
            st = d.get("straggler") or {}
            print(f"  {card}: u1 round {r}: path {d['path_ms']:.1f} ms of wall "
                  f"{d['wall_ms']:.1f} ms (coverage {d['coverage']}), on path "
                  f"{d['clients_on_path']}, top {d['top_phase']} {d['top_share']:.2f}, "
                  f"straggler {st.get('client')} on path {st.get('on_critical_path')} "
                  f"savings {st.get('savings_ms')} ms", flush=True)
        faults = []
        if scrape is None:
            faults.append(f"no scrape before round {U_ROUNDS - 1} closed held rank0..rank"
                          f"{U_SILOS}, the job and health_rounds_scored")
        if not any(c == str(U_SLOW) and rnd == 2 and before for c, rnd, before, _ in stragglers):
            faults.append(f"no straggler alert for client {U_SLOW} at round 2 before the run "
                          f"ended: {stragglers}")
        if not (caps and caps[0]["round"] == 3 and caps[0]["rule"] == "straggler"
                and caps[0]["ok"] and kernels):
            faults.append(f"the capture: {caps}, {len(kernels)} kernel events")
        if not (server.get("collector") and server["collector"] == server.get("registry")):
            diff = {k: (server.get("collector", {}).get(k), v)
                    for k, v in (server.get("registry") or {}).items()
                    if server.get("collector", {}).get(k) != v}
            faults.append(f"the collector's rank0 totals differ from the registry: {diff}")
        if server.get("replay_applied") is not False or (
                server.get("collector_after_replay") != server.get("collector")):
            faults.append("the replayed final frame was applied")
        want_nodes = [f"rank{r}" for r in range(1, U_SILOS + 1)]
        if not set(want_nodes) <= set(remote_nodes):
            faults.append(f"spans_remote.jsonl holds nodes {remote_nodes}")
        for n in want_nodes:
            c = clocks.get(n) or {}
            if c.get("method") not in ("paired", "one_way") or c.get("uncertainty_ms") is None:
                faults.append(f"{n}'s clock {c}")
        if sorted(cps) != list(range(U_ROUNDS)):
            faults.append(f"critical paths of rounds {sorted(cps)}")
        for r, d in cps.items():
            if not (d["coverage"] is not None and 0.95 <= d["coverage"] <= 1.0 + 1e-6):
                faults.append(f"round {r}'s coverage {d['coverage']}")
            if r == 0:
                continue  # every process's first calls: whichever is slowest holds it
            on = str(U_SLOW) in d["clients_on_path"]
            if on != (r in U_SLOW_ROUNDS):
                faults.append(f"round {r}: clients on the path {d['clients_on_path']}")
            if r in U_SLOW_ROUNDS:
                st = d.get("straggler") or {}
                if not (st.get("client") == str(U_SLOW) and st.get("on_critical_path")
                        and st.get("savings_ms", 0) >= 0.5 * U_SLOW_S * 1e3):
                    faults.append(f"round {r}'s straggler what-if {st}")
        if faults:
            raise RuntimeError("u1: " + "; ".join(faults))
        perfetto = os.path.join(log_dir, "perfetto.json")
        trace_child = _CliChild(("telemetry", "trace", run_dir, "--json", "--perfetto",
                                 perfetto))
        watch_child = _CliChild(("telemetry", "watch", "--once", run_dir))
    except BaseException:
        shutil.rmtree(log_dir, ignore_errors=True)
        raise

    def readers():
        """Phase (u3): the readers of u1's run dir, as children."""
        text, trace_s = trace_child.result()
        summary = json.loads(text)
        child_cov = {r["round"]: r["coverage"] for r in summary["rounds"]}
        with open(perfetto) as f:
            doc = json.load(f)
        tracks = [e for e in doc["traceEvents"] if e.get("ph") == "M"
                  and (e.get("args") or {}).get("name") == "critical path"]
        cp_slices = sum(e.get("cat") == "critical-path" for e in doc["traceEvents"])
        watch_text, watch_s = watch_child.result()
        print(f"  {card}: u3 telemetry trace --json --perfetto in a child {trace_s:.1f} s "
              f"({len(doc['traceEvents'])} trace events, {cp_slices} on the critical-path "
              f"track); telemetry watch --once {watch_s:.1f} s:", flush=True)
        for line in watch_text.splitlines():
            print(f"  {card}: u3 | {line}", flush=True)
        faults = []
        if child_cov != {r: d["coverage"] for r, d in cps.items()}:
            faults.append(f"the trace child's coverage {child_cov}")
        if not (tracks and cp_slices):
            faults.append("the Perfetto file has no critical-path track")
        if f"client {U_SLOW}" not in watch_text:
            faults.append(f"watch does not name client {U_SLOW}")
        if faults:
            raise RuntimeError("u3: " + "; ".join(faults))
        return dict(trace_child_s=trace_s, watch_child_s=watch_s, perfetto_events=len(
            doc["traceEvents"]))

    out = dict(wall_s=wall, scrape=scrape, scrape_ms=scrape_ms, pop_us=hot,
               frame_bytes_mean=fb_mean, frames_piggybacked=piggy, alerts=stragglers,
               captures=caps, capture_kernels=len(kernels), start_s=server["start_s"],
               stop_s=server["stop_s"],
               clocks=clocks, rounds={r: {k: d[k] for k in ("path_ms", "wall_ms", "coverage",
                                                              "clients_on_path", "straggler")}
                                      for r, d in cps.items()},
               digest=server["digest"], process_walls_s=[k["wall_s"] for k in kids],
               latency_ms=latency)
    return out, _deferred(log_dir, readers)


def live_twin_phase(card: str):
    """Phase u1's twin: the same federation, the plane off and no sleeps."""
    import shutil
    import tempfile

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_u1_twin_")
    try:
        kids, wall = _u_federation(log_dir, False)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    print(f"  {card}: u1's twin: {U_SILOS + 1} processes in {wall:.1f} s, digest "
          f"{kids[0]['digest']}", flush=True)
    return dict(wall_s=wall, digest=kids[0]["digest"])


def live_tree_phase(card: str, cli: "_CliChild", dev: str = "cuda"):
    """Phase (u2): phase t3's tree under a live plane, and ``cli``, the tree
    command with ``--metrics-port 0`` started in a child process earlier
    (see the module doc)."""
    from fedml_tpu_torch.hierarchy import KillWindow, TreeRunner, TreeTopology
    from fedml_tpu_torch.telemetry import get_registry, reset_trace_controller
    from fedml_tpu_torch.telemetry.live import LivePlane

    _fresh_telemetry()
    topo = TreeTopology.build(T3["clients"], tiers=T3["tiers"])
    plane = LivePlane(job="chip_smoke_u2", node="tree_root", metrics_port=0)
    scrapes = []

    def scrape_between_rounds(r, _params):
        if r >= 1:  # round r-1's pump is in; round r's comes after this listener
            t0 = time.perf_counter()
            with urllib.request.urlopen(plane.url + "/metrics", timeout=5) as resp:
                text = resp.read().decode()
            scrapes.append(dict(round=r, ms=(time.perf_counter() - t0) * 1e3,
                                tree_root='node="tree_root"' in text,
                                tier=sum(ln.startswith("tier_") for ln in text.splitlines())))

    try:
        runner = TreeRunner(topo, template=resnet_wire_template(dev), codec="int8",
                            seed=T3["seed"], quorum=T3["quorum"], chunk=T3["chunk"],
                            chaos=[KillWindow(*k) for k in T3_KILLS],
                            on_round=scrape_between_rounds, live=plane, device=dev)
        out = runner.run(T3["rounds"])
    finally:
        plane.close()
        reset_trace_controller()  # an edge's straggler alert may have armed one
    col = live_totals(plane.collector.registry, node="tree_root", prefix="tier/")
    reg = live_totals(get_registry(), prefix="tier/")
    seq = plane.collector.nodes()["tree_root"]["seq"]
    text, cli_s = cli.result()
    cli_out = json.loads(text.strip().splitlines()[-1])
    print(f"  {card}: u2 levels {topo.levels}, {T3['rounds']} rounds in {out['wall_s']:.3f} s "
          f"under the plane; scrapes between rounds {scrapes}; the root's seq {seq}; "
          f"{len(col)} tier instruments in the collector, equal to the registry: "
          f"{col == reg}; alerts {[(a['rule'], a.get('round')) for a in plane.doctor.alerts]}; "
          f"tree {' '.join(U2_CLI_ARGS)} --metrics-port 0 in a child: completed "
          f"{cli_out.get('completed')} in {cli_s:.1f} s", flush=True)
    faults = []
    if not scrapes or not all(s["tree_root"] and s["tier"] for s in scrapes):
        faults.append(f"the scrapes between rounds {scrapes}")
    if not col or col != reg:
        faults.append(f"the collector's tier counters {col} against the registry's {reg}")
    if seq < 3:
        faults.append(f"the root's seq {seq}")
    if not cli_out.get("completed"):
        faults.append(f"the tree command: {cli_out}")
    if faults:
        raise RuntimeError("u2: " + "; ".join(faults))
    return dict(wall_s=out["wall_s"], scrapes=scrapes, seq=seq, tier_instruments=len(col),
                cli_s=cli_s, alerts=plane.doctor.alerts)


def step_sum(results, key, rows=DECODE_ROWS):
    """One pass's total over its 225 launches at ``rows`` rows (None where
    a time was not measured)."""
    by = {(r["H"], r["F"]): r[key] for r in results if r["rows"] == rows}
    if any(v is None for v in by.values()):
        return None
    return sum(n * by[s] for s, n in SLICE_SHAPES.items())


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=ALL_PHASES,
                        help="phases to run after (a), e.g. 'd' for the flash kernels "
                             "alone (default: all; only a full run prints the kernels "
                             "and ok lines)")
    parser.add_argument("--parent", default=None, metavar="DIR",
                        help="a checkout whose dequant and flash-forward kernels are "
                             "timed beside this tree's (phases b and d)")
    opts = parser.parse_args(argv)
    t_start = time.perf_counter()
    phases = opts.phases
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    if os.environ.get("PYTHONHASHSEED") != CS_HASHSEED:
        # one draw of the CIFAR-10 stand-in for every phase, in this process
        # and in those the phases start: its seed has hash("cifar10") in it,
        # salted per process unless PYTHONHASHSEED is fixed (on one unpinned
        # draw k1's test loss rose above the untrained model's)
        sys.stdout.flush()
        os.execve(sys.executable,
                  [sys.executable, os.path.abspath(__file__),
                   *(sys.argv[1:] if argv is None else argv)],
                  dict(os.environ, PYTHONHASHSEED=CS_HASHSEED))
    from fedml_tpu_torch.ops import flash_attention as fa  # fails outside the repo

    share_stand_in_draws()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    peak_bw, peak_flops = card_peaks(name)
    print(f"(a) {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"peaks {peak_bw / 1e12:.2f} TB/s, {peak_flops / 1e12:.0f} TFLOP/s bf16",
          flush=True)
    build_s, logs = build_kernels()
    print(f"    built {len(KERNEL_SOURCES)} kernel(s) in {build_s:.2f} s", flush=True)
    ptxas = {}
    for n, log in logs.items():
        ptxas.update(ptxas_report(log))
        for ln in log.splitlines():
            if "warning" in ln.lower():
                print(f"    {n}: {ln.strip()}", flush=True)
    from fedml_tpu_torch.ops import quant

    smem = {**fa.kernel_smem_bytes(), **quant.kernel_smem_bytes()}
    for kname, info in sorted(ptxas.items()):
        print(f"    {kname}: {info.get('registers')} registers, "
              f"{smem.get(kname, 'static')} bytes of dynamic shared memory, spill stores "
              f"{info.get('spill_stores')} / loads {info.get('spill_loads')} bytes, stack "
              f"{info.get('stack')} bytes", flush=True)

    results = serve = flash = train = quantized = qlora = sp = cross_silo = trust = None
    secure = checkpoints = durable = tree = transports = analytics = llm_rest = None
    spans = profiling = health = live_out = None
    phase_s = {}
    parent_dequant = parent_fwd = None
    if opts.parent:
        t0 = time.perf_counter()
        parent_dequant, parent_fwd = parent_kernels(opts.parent)
        print(f"    built the kernels of {opts.parent} in {time.perf_counter() - t0:.2f} s",
              flush=True)
    def timed(name, fn):
        """Run one phase and print its seconds; the card is emptied after."""
        t0 = time.perf_counter()
        out = fn()
        gc.collect()  # the phase's models and engines are gone
        torch.cuda.empty_cache()
        phase_s[name] = time.perf_counter() - t0
        print(f"    phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    def beside(name, fn):
        """Start a phase of child processes beside the next phases: none of
        those gates on a time or reads a counter it moves (see _Beside)."""
        return _Beside(name, fn, phase_s)

    if "b" in phases:
        print("(b) dequant_matmul vs plain version", flush=True)
        results = timed("b", lambda: kernel_phase(peak_bw, peak_flops, parent_dequant))
    if "c" in phases:
        print("(c) serve llama3_8b int8", flush=True)
        serve = timed("c", serve_phase)
    if "d" in phases:
        print("(d) flash attention kernels vs plain versions", flush=True)
        flash = timed("d", lambda: flash_phase(peak_bw, peak_flops, parent_fwd))
    if "e" in phases:
        print("(e) federated LoRA rounds of llama3_8b through FedLLMAPI", flush=True)
        train = timed("e", train_phase)
    if "f" in phases:
        print("(f) quantized formats: w8a8 and 4-bit, then llama3_8b served with "
              "--quantize w8a8 and nf4", flush=True)
        quantized = timed("f", lambda: quant_phase(peak_bw, peak_flops, results))
    if "g" in phases:
        print("(g) QLoRA rounds of llama3_8b through FedLLMAPI: nf4 base, then one "
              "round over an int8 base", flush=True)
        qlora = timed("g", lambda: qlora_phase(train))
    if "h" in phases:
        print("(h) the sp FedAvg simulation: resnet18 on the cifar10 stand-in, int8 "
              "uplinks", flush=True)
        sp = timed("h", lambda: sp_phase(card))
    if "i" in phases:
        print("(i1) cross-silo FedAvg in process (LOCAL): resnet18 on the cifar10 "
              "stand-in, 4 silos, int8 uplinks, 2 rounds", flush=True)
        inproc = timed("i1", lambda: cross_silo_inproc(card))
        print(f"(i2) cross-silo FedAvg over the broker: a server and {CS_BROKER_SILOS} "
              "silos as processes, 1 round, beside phase j", flush=True)
        broker_phase = beside("i2", lambda: cross_silo_broker(card))
    if "j" in phases:
        print("(j1) the trust stack in the sp simulation: integrity + trimmed_mean@0.2, a NaN "
              f"and a x{TRUST_SCALE:g} upload, 2 rounds; (j2) the decode fallback: "
              "byzantine + krum, 1 round, then every defense timed", flush=True)
        trust = timed("j1+j2", lambda: trust_sp_phase(card))
        print("(j3) the trust stack in cross-silo: 4 silos over LOCAL, norm-difference "
              "clipping + local DP on the fused path, 1 round", flush=True)
        trust["j3"] = timed("j3", lambda: trust_cross_silo_phase(card))
    if "i" in phases:
        cross_silo = dict(inproc=inproc, broker=broker_phase.result("phase j"))
    if "k" in phases:
        print("(k1) secure aggregation, secagg: int8: 4 silos over LOCAL, 2 rounds, silo "
              f"{SECAGG_STALL_RANK} stalled in round 1 (recovery)", flush=True)
        secure = dict(k1=timed("k1", lambda: secagg_inproc(card)))
        print(f"(k2) secagg: int8 over the broker: a server and {SECAGG_BROKER_SILOS} silos "
              "as processes, 1 round, beside phases k3, k4, l1 and l2", flush=True)
        masked_broker = beside("k2", lambda: secagg_broker(card))
        print("(k3) the Bonawitz FSM: 3 silos, one dropout after the share exchange, "
              "1 round", flush=True)
        secure["k3"] = timed("k3", lambda: finite_field_phase(card, "k3"))
        print("(k4) LightSecAgg: 3 silos, 1 round", flush=True)
        secure["k4"] = timed("k4", lambda: finite_field_phase(card, "k4"))
    if "l" in phases:
        import shutil

        print("(l1) the host-loop FedLLM round of llama3_8b: norm-difference clipping, "
              "a checkpoint each round, 2 rounds", flush=True)
        checkpoints = dict(l1=timed("l1", lambda: fedllm_host_phase(card, train)))
        try:
            print("(l2) serve --checkpoint of l1's last round: int8, LoRA rank 16",
                  flush=True)
            checkpoints["l2"] = timed("l2", lambda: serve_checkpoint_phase(
                checkpoints["l1"]["checkpoint"]))
        finally:
            shutil.rmtree(checkpoints["l1"]["work"], ignore_errors=True)
    if "k" in phases:
        secure["k2"] = masked_broker.result("phases k3, k4, l1 and l2")
    if "m" in phases:
        print("(m1) the durable cross-silo server over the broker: a server and 2 silos as "
              "processes, the server SIGKILLed in round 1 and respawned with resume; "
              "identity, 2 rounds, then int8, 2 rounds; beside phases l3, l4 and l5",
              flush=True)
        durable_phase = beside("m1", lambda: durable_cross_silo(card))
    if "l" in phases:
        print("(l3) sp resume and contribution: resnet18, 50 clients, 4 a round, FedOpt, "
              "gtg_shapley with one flipped client", flush=True)
        ds, flipped = contribution_data()
        checkpoints["l3"] = timed("l3", lambda: sp_resume_phase(card, ds, flipped))
        print("(l4) cross-silo resume: 4 silos over LOCAL, leave-one-out, 1 round, then a "
              "restarted server for round 1", flush=True)
        checkpoints["l4"] = timed("l4", lambda: cross_silo_resume_phase(card, ds))
        print("(l5) the reconstruction attacks on resnet18: DLG, revealing_labels",
              flush=True)
        checkpoints["l5"] = timed("l5", lambda: reconstruction_phase(card, ds))
        del ds
    if "m" in phases:
        durable = dict(m1=durable_phase.result("phases l3, l4 and l5"))
    if "u" in phases:
        # u1 gates on times: alone, after m1's processes and before o's; its
        # twin, u2's command and u3's readers (started by u1) run beside m2
        print(f"(u1) the live plane and causal tracing over the broker: resnet18, int8, a "
              f"server and {U_SILOS} silos as processes, {U_ROUNDS} rounds, silo {U_SLOW} "
              f"slowed by {U_SLOW_S} s in rounds {list(U_SLOW_ROUNDS)} and silo 1 by "
              f"{U_BASE_S} s in every round; alone", flush=True)
        u1, readers = timed("u1", lambda: live_broker_phase(card))
        print(f"(u1 twin) u1's federation with the plane off and no sleeps; tree "
              f"{' '.join(U2_CLI_ARGS)} --metrics-port 0 in a child; both beside phase m2 "
              "with u3's children", flush=True)
        twin = beside("u1 twin", lambda: live_twin_phase(card))
        u2_cli = _CliChild(("tree", *U2_CLI_ARGS, "--metrics-port", "0"))
    if "m" in phases:
        print("(m2) the async server over LOCAL: 4 silos, int8, FedBuff of 4, 8 updates, "
              "a journal refill, then instant apply", flush=True)
        durable["m2"] = timed("m2", lambda: async_phase(card))
    if "u" in phases:
        live_out = dict(u1=u1, twin=twin.result("phase m2"))
        if live_out["twin"]["digest"] != u1["digest"]:
            raise RuntimeError(f"u1: the live plane changed the aggregate: {u1['digest']} vs "
                               f"the twin's {live_out['twin']['digest']}")
        print(f"(u2) the live plane in the tree: resnet18-wide, {T3['clients']} clients over "
              f"{T3['tiers']} tiers, {T3['rounds']} rounds, leaf kills as t3", flush=True)
        live_out["u2"] = timed("u2", lambda: live_tree_phase(card, u2_cli))
        print("(u3) the readers of u1's run dir, as children: telemetry trace --json "
              "--perfetto, telemetry watch --once", flush=True)
        live_out["u3"] = timed("u3", lambda: _run_gates({"u3": readers})["u3"])
    if "o" in phases:
        print(f"(o) the other transports, at once: a server and {O_SILOS} silos as processes "
              "each over tRPC (o1), cross-cloud over the C++ broker with an S3 store (o2) "
              "and gRPC (o3); resnet18, int8, 1 round; beside phase n", flush=True)
        transports_beside = beside("o", lambda: transports_phase(card))
    if "n" in phases:
        print(f"(n1) the aggregation tree: resnet18-wide, {TREE_N1['clients']} clients over 4 "
              "tiers, int8, a "
              "leaf client killed and an interior aggregator crashed and journal-restored, "
              "2 rounds", flush=True)
        tree = dict(n1=timed("n1", lambda: tree_resnet_phase(card)))
        print("(n2) the 100k-client acceptance: the tree command in a child process, "
              "replayed in process beside it", flush=True)
        tree["n2"] = timed("n2", lambda: tree_100k_phase(card))
        print("(n3) per-edge-cohort secagg at resnet18 width: (1, 4, 16), a leaf client "
              "killed, 2 rounds, twice", flush=True)
        tree["n3"] = timed("n3", lambda: tree_secagg_phase(card))
    if "o" in phases:
        transports = transports_beside.result("phase n")
    if "p" in phases:
        print("(p1) federated analytics: the fa command's FSM for every task, 6 clients, on "
              "the card against the CPU", flush=True)
        analytics = dict(p1=timed("p1", lambda: fa_fsm_phase(card)))
        print(f"(p2) the {FA_P2['n_clients']}-client heavy-hitter federation: "
              f"{FA_P2['codec']}, {list(FA_P2['levels'])}, central DP, leaf and edge kills, "
              "a root crash with a journal restart, no SecAgg, twice", flush=True)
        analytics["p2"] = timed("p2", lambda: fa_federation_phase(card))
        print(f"(p3) fa {' '.join(FA_P3_ARGS)} (SecAgg) against the same scenario unmasked",
              flush=True)
        analytics["p3"] = timed("p3", lambda: fa_secagg_phase(card))
    if "q" in phases:
        print(f"(q1) full fine-tuning of llama3_8b widths at {Q1_ARGS['num_hidden_layers']} "
              f"layers: f32 weights, T=2048, {Q1_STEPS} steps and an eval", flush=True)
        llm_rest = dict(q1=timed("q1", lambda: full_ft_phase(card, peak_bw, peak_flops)))
        print(f"(q2) the full-parameter federation: FedLLMAPI's host loop at "
              f"{Q2_ARGS['num_hidden_layers']} layers, 2 clients x 2 steps, 2 rounds, round 0 "
              "checkpointed; round 1 again from the round-0 checkpoint", flush=True)
        llm_rest["q2"] = timed("q2", lambda: full_fedllm_phase(card))
        print(f"(q3) MoE rounds: {Q3_ARGS['num_experts']} experts, top-2, "
              f"{Q3_ARGS['num_hidden_layers']} layers of llama3_8b widths, bf16 base, LoRA "
              "rank 16, on-device round, 4 clients x 2 steps, 2 rounds", flush=True)
        llm_rest["q3"] = timed("q3", lambda: moe_phase(card))
    gates = {}
    if "t" in phases:
        # before r: each leg's doctor child runs beside the next leg (the last
        # one's beside phases r and s), and its checks run after phase s
        print(f"(t1) run health in the sp simulation: resnet18, int8, 5 clients, 5 rounds, "
              f"client {T_SLOW} slowed by {T_SLOW_S} s and client {T_NOISY} uploading "
              f"{T_NOISY_SCALE:g}x its delta; the doctor in a child process", flush=True)
        gates["t1"] = timed("t1", lambda: health_sp_phase(card))
        print(f"(t2) run health in cross-silo secagg: phase k1's federation on a quarter of "
              f"its images, silo {SECAGG_STALL_RANK} stalled in round 1", flush=True)
        gates["t2"] = timed("t2", lambda: health_secagg_phase(card))
        print(f"(t3) run health in the tree: resnet18-wide, {T3['clients']} clients over "
              f"{T3['tiers']} tiers, leaf clients {[k[1] for k in T3_KILLS]} dead in round 1, "
              f"{T3['rounds']} rounds", flush=True)
        gates["t3"] = timed("t3", lambda: health_tree_phase(card))
    if "r" in phases:
        print(f"(r1) the sp round of phase h on {R1_DATA['train_size']} images, untraced then "
              "traced: spans into a fresh run dir, the report read back, the parameters "
              "bit-equal", flush=True)
        spans = dict(r1=timed("r1", lambda: traced_sp_phase(card)))
        print(f"(r2) phase i2's federation on {R2_TRAIN} images traced: a server and "
              f"{CS_BROKER_SILOS} silos as processes in one run dir, silo {R2_HELD_RANK} sent "
              "SIGTERM after the round, its untraced twin beside it; beside phases r3 and s",
              flush=True)
        traced_broker = beside("r2", lambda: traced_cross_silo_phase(card))
        print(f"(r3) FedLLMAPI's host loop traced: {R3_ARGS['num_hidden_layers']} layers of "
              "llama3_8b widths, LoRA rank 16, T=2048, 2 clients x 1 step, 1 round",
              flush=True)
        spans["r3"] = timed("r3", lambda: traced_fedllm_phase(card))
    if "s" in phases:
        print(f"(s1) FedLLMAPI's fused round profiled: {S1_LAYERS} layers of llama3_8b "
              "widths, LoRA rank 16, T=2048, 4 clients x 2 steps, 2 rounds, round 1 "
              "captured through MLOpsProfilerEvent; then the same rounds with "
              "FEDML_PROFILE=0", flush=True)
        profiling = dict(s1=timed("s1", lambda: profiled_fedllm_phase(card)))
        print(f"(s2) the sp round of phase r1 on {R1_DATA['train_size']} images with "
              "trace_rounds 0: programs.jsonl, mem_sample records, the trace, the digest "
              "against the unprofiled twin", flush=True)
        twin = spans["r1"]["untraced_digest"] if spans else None
        profiling["s2"] = timed("s2", lambda: profiled_sp_phase(card, twin))
    if "r" in phases:
        spans["r2"] = traced_broker.result("phases r3 and s")
    later = {**gates, **_LATER}
    if later:
        print(f"(t, r, s) the children's checks: the doctors of {sorted(gates)}, the "
              f"reports of {sorted(_LATER)}", flush=True)
        children = timed("children", lambda: _run_gates(later))
        health = {leg: children[leg] for leg in gates}
        for leg, out in children.items():
            if leg not in gates:
                (spans if leg.startswith("r") else profiling)[leg].update(out)
    whole_s = time.perf_counter() - t_start
    print(f"    whole script: {whole_s:.1f} s from main's start (the limit is 1200 s)",
          flush=True)
    os.makedirs("results", exist_ok=True)
    record = {"card": card, "torch": torch.__version__, "build_s": build_s, "ptxas": ptxas,
              "shapes": results, "serve": serve, "flash": flash, "train": train,
              "quantized": quantized, "qlora": qlora, "sp": sp, "cross_silo": cross_silo,
              "trust": trust, "secure": secure, "checkpoints": checkpoints,
              "durable": durable, "tree": tree, "transports": transports,
              "analytics": analytics, "llm_rest": llm_rest, "spans": spans,
              "profiling": profiling, "health": health, "live": live_out,
              "phase_s": phase_s,
              "whole_s": whole_s}
    if sorted(phases) != list(ALL_PHASES):
        with open(os.path.join("results", "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
        print(f"phases {phases} passed (a partial run prints no kernels or ok line)")
        return 0

    kernels = [{
        "name": "dequant_matmul",
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/dequant_matmul.cu",
        "replaces": "fedml_tpu/ops/quant.py:374",
        "launches": serve["launches"],
        "launches_by_path": {"c": serve["launches"],
                             "l2": checkpoints["l2"]["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": step_sum(results, "ms"),
        "plain_ms": step_sum(results, "plain_ms"),
        "bound_ms": step_sum(results, "bound_ms"),
        "bound_by": "bytes",
        "library_ms": step_sum(results, "library_ms"),
        "times_are": f"one decode step: the sum over its {LAUNCHES_PER_PASS} "
                     f"launches at {DECODE_ROWS} rows",
        "parent_ms": step_sum(results, "parent_ms"),
        "prefill_128_rows_ms": step_sum(results, "ms", 128),
        "prefill_128_rows_bound_ms": step_sum(results, "bound_ms", 128),
        "pass_ms_by_rows": {rows: step_sum(results, "ms", rows) for rows in ROWS},
        "library": sorted({r["library"] for r in results}),
    }]
    path = flash[0]  # T = S = 2048, causal: the training path's shape
    errs = {n: max(r["errors"][n][0] for r in flash) for n in ("out", "dq", "dk", "dv")}
    for kname, line, err, lib in (
            ("flash_fwd", 63, errs["out"], path["library_fwd_ms"]),
            ("flash_bwd_dq", 168, errs["dq"], path["library_bwd_ms"]),
            ("flash_bwd_dkv", 224, max(errs["dk"], errs["dv"]), path["library_bwd_ms"])):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "fedml_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"fedml_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][kname],
            "launches_by_path": {"e": train["launches"][kname],
                                 "g": qlora["nf4"]["launches"][kname],
                                 "l1": checkpoints["l1"]["launches"][kname],
                                 **{q: llm_rest[q]["launches"][kname]
                                    for q in ("q1", "q2", "q3")},
                                 "r3": spans["r3"]["launches"][kname],
                                 "s1": profiling["s1"]["launches"][kname]},
            "max_abs_err": err,
            "ms": path["ms"][kname],
            "plain_ms": path["plain_ms"][kname],
            "bound_ms": path["bound_ms"][kname],
            "bound_by": path["bound_by"][kname],
            "library_ms": lib,
            **({"parent_ms": path["parent_fwd_ms"]} if kname == "flash_fwd" else {}),
            "times_are": "one launch at B=1, H=32, Hkv=8, T=S=2048, D=128, causal",
            "library": ("torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True, enable_gqa=True)"
                        + ("" if kname == "flash_fwd" else
                           " backward: dq, dk and dv together (compare with "
                           "flash_bwd_dq + flash_bwd_dkv)")),
        })
    with open(os.path.join("results", "chip_smoke.json"), "w") as f:
        json.dump(dict(record, kernels=kernels), f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
